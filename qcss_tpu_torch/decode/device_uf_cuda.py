"""The stencil union-find kernel (`csrc/uf_stencil_full.cu`) and its
wrapper: the counterpart of the reference's Mosaic full-decode kernel
(`qcss_tpu.decode.device_uf_pallas.decode_stencil_pallas_full`).

`stencil_full` launches the kernel: defect [B, V] -> (packed, act), the
same final state as the plain version `device_uf._stencil_plain`.
`decode_stencil_cuda` adds the label-lane extraction, the boundary
cluster's odd-parity term and convergence (`device_uf._stencil_labels`).
One block per shot exits on its own, so the TPU's tile picking and shot
sorting have no counterpart here.
"""

from __future__ import annotations

import torch

from qcss_tpu_torch import _cuda

#: kernel launches made by `stencil_full` in this process
launches = 0


def _tables(st) -> torch.Tensor:
    """[3*O + 3*KB, V] int32: emask, ewt, eobs, bmask, bwt, bobs."""
    return torch.cat([st.emask.to(torch.int32), st.ewt, st.eobs,
                      st.bmask.to(torch.int32), st.bwt, st.bobs]
                     ).to(torch.int32).contiguous()


def stencil_full(dg, defect: torch.Tensor):
    """Launch the stencil kernel: defect [B, V] int32 (hub column zero) ->
    (packed [B, V] int32, act [B, V] int32)."""
    global launches
    st = dg.stencil
    if st is None or dg.pack_shift is None:
        raise ValueError("the stencil kernel needs a stencil-eligible graph")
    if st.chunks:
        raise NotImplementedError(
            "spilled label lanes (ChunkLanes) are not handled by the CUDA "
            "stencil kernel yet (ROADMAP.md, queue 2, item 1)")
    V = dg.num_nodes + 1
    if not defect.is_cuda:
        raise ValueError("stencil_full takes CUDA tensors")
    if defect.dtype != torch.int32 or defect.dim() != 2 \
            or defect.shape[1] != V or not defect.is_contiguous():
        raise ValueError(
            f"defect must be a contiguous [B, {V}] int32 tensor, got "
            f"{tuple(defect.shape)} {defect.dtype}")
    tab = _tables(st)
    if tab.device != defect.device or tab.shape[1] != V:
        raise ValueError("stencil tables must be [*, V] on the defect's device")
    deltas = torch.as_tensor(st.deltas, dtype=torch.int32,
                             device=defect.device)
    B = defect.shape[0]
    packed = torch.empty_like(defect)
    act = torch.empty_like(defect)
    lib = _cuda.load()
    err = lib.qcss_uf_stencil_full(
        defect.data_ptr(), tab.data_ptr(), deltas.data_ptr(), B, V,
        len(st.deltas), st.bmask.shape[0], dg.pack_shift, dg.max_rounds,
        packed.data_ptr(), act.data_ptr(),
        torch.cuda.current_stream(defect.device).cuda_stream)
    _cuda.check(err, "qcss_uf_stencil_full")
    launches += 1
    return packed, act


def decode_stencil_cuda(dg, detectors: torch.Tensor):
    """`device_uf.decode_labels` for a CUDA tensor: (labels, converged)."""
    from qcss_tpu_torch.decode.device_uf import (
        _stencil_labels,
        stencil_defect,
    )

    defect = stencil_defect(dg, detectors)
    packed, act = stencil_full(dg, defect)
    return _stencil_labels(dg, defect, packed, act)
