"""Benchmark pipelines of the port."""
