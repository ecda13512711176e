"""The fused multi-qubit CHP measurement kernel (`csrc/chp_measure.cu`,
K9) and the function that chooses between it and its plain version: the
counterpart of `qcss_tpu.sim.pallas_measure`.

`measure_many_fused` measures a packed tableau's qubits in order. For a
tableau on the card it launches K9, which keeps each shot's tableau in
shared memory across all the measured qubits: a warp a shot while a row
has at most 4 words (n <= 128), a block a shot while the tableau fits in a
block's 227 KB (n <= 659), and past that a block a shot working in device
memory (`launch_plan` reports which). For a tableau on the CPU it runs
the plain version, the scan `tableau_packed.measure_many`. The collapse
bits are drawn as the scan draws them (`tableau.collapse_bits`, one
[B, M] draw), so given the same bits the two are bit-identical. No path
gives way from the kernel to the scan: what the kernel does not take
raises.

The TPU kernel's ``tile_b`` (B a multiple of the VMEM tile) and its
[B, W, 2n] transpose have no counterpart: the kernel takes any batch in
the [B, 2n, W] layout that `PackedTableau` holds.
"""

from __future__ import annotations

import ctypes

import torch

from qcss_tpu_torch import _cuda
from qcss_tpu_torch.sim import tableau as tb
from qcss_tpu_torch.sim import tableau_packed as tp

#: kernel launches made by `measure_many_cuda` in this process
launches = 0


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device or t.dtype != dtype \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {tuple(shape)} {dtype} tensor on "
            f"{device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


_PLAN_KEYS = ("form", "shots_per_block", "threads", "smem_bytes",
              "resident_blocks", "registers")

#: K9's forms, by the number `launch_plan` reports
FORMS = {1: "a warp a shot", 2: "a block a shot, shared memory",
         3: "a block a shot, device memory"}


def launch_plan(n: int, words: int, form: int = 0) -> dict:
    """How K9 launches for n qubits at ``words`` words a row: its form (1:
    a warp a shot, 2: a block a shot with the tableau in shared memory, 3:
    a block a shot in device memory), shots a block at once, threads a
    block, shared memory a block, the blocks the card holds at once and
    registers a thread (`qcss_chp_measure_config`; needs the card).
    ``form`` asks for one form (0: the one the wrapper launches); a form
    that cannot run these shapes raises."""
    out = (ctypes.c_longlong * len(_PLAN_KEYS))()
    _cuda.check(_cuda.load().qcss_chp_measure_config(n, words, form, out),
                "qcss_chp_measure_config")
    return dict(zip(_PLAN_KEYS, (int(v) for v in out)))


def in_shared_memory(n: int, words: int) -> bool:
    """Whether K9 holds a shot's tableau (n qubits, ``words`` words a row)
    in shared memory; above the card's limit it works in device memory."""
    return launch_plan(n, words)["form"] != 3


def measure_many_cuda(t: tp.PackedTableau, qubits,
                      rand_bits: torch.Tensor):
    """Launch K9 on a tableau on the card: measure ``qubits`` in order with
    collapse bits ``rand_bits`` [B, M] uint8. Same result as
    `tableau_packed.measure_many(t, qubits, rand_bits=rand_bits)`."""
    global launches
    if not t.x.is_cuda:
        raise ValueError("measure_many_cuda takes a tableau on the card")
    dev = t.x.device
    B, two_n, W = t.x.shape
    n = t.n
    if two_n != 2 * n or W < (n + tp.WORD - 1) // tp.WORD:
        raise ValueError(f"tableau words {tuple(t.x.shape)} do not hold "
                         f"n = {n} qubits")
    _check("x", t.x, (B, two_n, W), torch.int32, dev)
    _check("z", t.z, (B, two_n, W), torch.int32, dev)
    _check("r", t.r, (B, two_n), torch.uint8, dev)
    qs = tb.host_qubits(qubits)
    if any(not 0 <= q < n for q in qs):
        raise ValueError(f"measured qubits must lie in [0, {n}), got {qs}")
    M = len(qs)
    _check("rand_bits", rand_bits, (B, M), torch.uint8, dev)
    q_dev = torch.tensor(qs, dtype=torch.int32, device=dev)
    x_out, z_out = torch.empty_like(t.x), torch.empty_like(t.z)
    r_out = torch.empty_like(t.r)
    outs = torch.empty((B, M), dtype=torch.uint8, device=dev)
    err = _cuda.load().qcss_chp_measure(
        t.x.data_ptr(), t.z.data_ptr(), t.r.data_ptr(), q_dev.data_ptr(),
        rand_bits.data_ptr(), B, n, W, M, 0,
        x_out.data_ptr(), z_out.data_ptr(), r_out.data_ptr(),
        outs.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(err, "qcss_chp_measure")
    launches += 1
    return tp.PackedTableau(x_out, z_out, r_out, n), outs


def measure_many_fused(t: tp.PackedTableau, qubits,
                       generator: torch.Generator | None = None,
                       rand_bits: torch.Tensor | None = None):
    """Measure the given qubits in Z, in order: K9 for a tableau on the
    card, the scan for one on the CPU. Collapse bits: ``rand_bits``
    [B, M], or one [B, M] draw from ``generator`` exactly as
    `tableau_packed.measure_many` draws them. Returns
    (state, outcomes [B, M] uint8)."""
    qs = tb.host_qubits(qubits)
    bits = tb.resolve_collapse_bits(generator, rand_bits, t.batch,
                                    len(qs), t.x.device)
    if t.x.is_cuda:
        return measure_many_cuda(t, qs, bits.contiguous())
    return tp.measure_many(t, qs, rand_bits=bits)
