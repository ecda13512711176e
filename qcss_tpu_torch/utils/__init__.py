"""Instrumentation shared by the port's entry points and benchmarks."""
