"""Pauli-frame sampling (`sim.frame`) under seeded Pauli noise
(`sim.noise`)."""

from qcss_tpu_torch.sim import frame, noise

__all__ = ["frame", "noise"]
