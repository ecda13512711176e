"""The defect-granular growth kernel (`csrc/sparse_growth.cu`) and its
wrapper: the counterpart of the reference's Mosaic growth kernel
(`qcss_tpu.decode.device_sparse.make_growth_kernel`) together with the
defect compaction and distance fetch of its `_sparse_decode`.

`sparse_decode_cuda` returns what the plain version
`device_sparse._sparse_plain` returns on the same detectors:
(obs [B] int32, converged [B] bool).
"""

from __future__ import annotations

import torch

from qcss_tpu_torch import _cuda

#: kernel launches made by `sparse_decode_cuda` in this process
launches = 0

MAX_D = 64


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
    det = detectors.to(torch.uint8).contiguous()
    obs = torch.empty(B, dtype=torch.int32, device=det.device)
    conv = torch.empty(B, dtype=torch.int32, device=det.device)
    lib = _cuda.load()
    err = lib.qcss_sparse_growth(
        det.data_ptr(), dist.data_ptr(), bdist.data_ptr(), phi.data_ptr(),
        bside.data_ptr(), B, V, d_max, max_events, obs.data_ptr(),
        conv.data_ptr(), torch.cuda.current_stream(det.device).cuda_stream)
    _cuda.check(err, "qcss_sparse_growth")
    launches += 1
    return obs, conv != 0
