"""The defect-granular growth kernel (`csrc/sparse_growth.cu`, K2) and its
wrapper: the counterpart of the reference's Mosaic growth kernel
(`qcss_tpu.decode.device_sparse.make_growth_kernel`) together with the
defect compaction and distance fetch of its `_sparse_decode`.

`sparse_decode_cuda` returns what the plain version
`device_sparse._sparse_plain` returns on the same detectors:
(obs [B] int32, converged [B] bool). The kernel runs a warp a shot; it
reads the detector rows where they lie (any alignment, any row stride)
and keeps each shot's distances in shared memory, transposed.
"""

from __future__ import annotations

import ctypes

import torch

from qcss_tpu_torch import _cuda

#: kernel launches made by `sparse_decode_cuda` in this process
launches = 0

MAX_D = 64

_PLAN_KEYS = ("shots_per_block", "threads", "smem_bytes", "resident_blocks",
              "registers")


def launch_plan(d_max: int) -> dict:
    """How K2 launches at ``d_max``: shots a block at once (one a warp),
    threads a block, shared memory a block, the blocks the card holds at
    once (the persistent grid's cap) and registers a thread
    (`qcss_sparse_growth_config`; needs the card)."""
    out = (ctypes.c_longlong * len(_PLAN_KEYS))()
    _cuda.check(_cuda.load().qcss_sparse_growth_config(d_max, out),
                "qcss_sparse_growth_config")
    return dict(zip(_PLAN_KEYS, (int(v) for v in out)))


def sparse_decode_cuda(tables_dev, d_max: int, max_events: int,
                       detectors: torch.Tensor):
    """Launch the sparse kernel on detectors [B, V] (any integer dtype,
    bit 0 read) with tables (dist [V, V], phi, bdist, bside [V]) int32 on
    the same device."""
    global launches
    dist, phi, bdist, bside = tables_dev
    if not detectors.is_cuda:
        raise ValueError("sparse_decode_cuda takes CUDA tensors")
    if detectors.dim() != 2:
        raise ValueError("detectors must be [B, V]")
    B, V = detectors.shape
    if dist.shape != (V, V):
        raise ValueError(f"dist must be [{V}, {V}], got {tuple(dist.shape)}")
    for name, t in (("dist", dist), ("phi", phi), ("bdist", bdist),
                    ("bside", bside)):
        if t.device != detectors.device or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous int32 tensor on "
                f"{detectors.device}")
    for name, t in (("phi", phi), ("bdist", bdist), ("bside", bside)):
        if t.shape != (V,):
            raise ValueError(f"{name} must be [{V}]")
    if not 1 <= d_max <= MAX_D:
        raise ValueError(f"d_max must lie in [1, {MAX_D}], got {d_max}")
    # Only bit 0 is read, and a cast to uint8 keeps every integer's parity.
    # Rows are read in place: any start address, any row stride.
    det = detectors.to(torch.uint8)
    if det.stride(1) != 1 or (B > 1 and det.stride(0) < V):
        det = det.contiguous()
    row_stride = det.stride(0) if B > 1 else V
    obs = torch.empty(B, dtype=torch.int32, device=det.device)
    conv = torch.empty(B, dtype=torch.int32, device=det.device)
    counter = torch.empty(1, dtype=torch.int32, device=det.device)
    lib = _cuda.load()
    err = lib.qcss_sparse_growth(
        det.data_ptr(), row_stride, dist.data_ptr(), bdist.data_ptr(),
        phi.data_ptr(), bside.data_ptr(), B, V, d_max, max_events,
        counter.data_ptr(), obs.data_ptr(), conv.data_ptr(),
        torch.cuda.current_stream(det.device).cuda_stream)
    _cuda.check(err, "qcss_sparse_growth")
    launches += 1
    return obs, conv != 0
