"""Fault-tolerant quantum computation: the block-level tableau engines the
FT executor runs on (`engines`). The executor, the rewriter, flags and
magic-state injection are not ported yet (ROADMAP.md, queue 1)."""

from qcss_tpu_torch.ftqc.engines import PackedEngine, UnpackedEngine

__all__ = ["PackedEngine", "UnpackedEngine"]
