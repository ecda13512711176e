"""The stencil union-find kernels and their wrappers: the counterparts of
the reference's Mosaic kernels in `qcss_tpu.decode.device_uf_pallas`.

`stencil_full` (`csrc/uf_stencil_full.cu`, for `make_full_kernel`)
launches the whole decode, one warp a shot over lists of live vertices:
defect [B, V] -> (packed, act, chunk_vals), the same final state as the
plain version `device_uf._stencil_plain`. It reads the graph as one word
per edge (`StencilGraph.kernel_words`, narrow or wide by the graph).
`decode_stencil_cuda` adds the label-lane extraction, the boundary
cluster's odd-parity term and convergence (`device_uf._stencil_labels`).

`stencil_prop`, `stencil_act` and `stencil_round`
(`csrc/uf_stencil_staged.cu`, for `make_prop_kernel`, `make_act_kernel`
and `make_round_kernel`) are the staged forms that
`device_uf_staged`'s decodes call once or twice per growth round; their
plain versions are `device_uf._prop_plain`, `_act_plain`, `_round_plain`.
All three run a warp a shot over lists of the vertices with a saturated
(K4: passing) edge, as K1 does; K3 and K5 read the graph's int32 tables
(`StencilGraph.kernel_tables`), K4 only its offsets.
`stencil_staged_config` reports their launch plans.

Each shot stops on its own, so the TPU's tile picking, batch padding and
shot sorting have no counterpart here. Every wrapper takes
CUDA tensors only and counts its launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from qcss_tpu_torch import _cuda

#: kernel launches made by `stencil_full` in this process
launches = 0
#: those of them on a graph with spilled lanes (chunks)
chunk_launches = 0
#: kernel launches made by `stencil_prop`, `stencil_act`, `stencil_round`
staged_launches = {"prop": 0, "act": 0, "round": 0}


def _check_plane(name: str, x: torch.Tensor, shape, dtype=torch.int32):
    if not x.is_cuda:
        raise ValueError(f"{name}: the stencil kernels take CUDA tensors")
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or not x.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {tuple(shape)} {dtype} tensor, got "
            f"{tuple(x.shape)} {x.dtype}")


def _stencil_args(dg, first: torch.Tensor):
    """(st, V, O, KB, tables, deltas) of a stencil graph on ``first``'s
    device; raises on what the kernels do not take."""
    st = dg.stencil
    if st is None or dg.pack_shift is None:
        raise ValueError("the stencil kernels need a stencil-eligible graph")
    if not first.is_cuda:
        raise ValueError("the stencil kernels take CUDA tensors")
    V = dg.num_nodes + 1
    tab = st.kernel_tables
    if tab.device != first.device or tab.shape[1] != V:
        raise ValueError("stencil tables must be [*, V] on the input's device")
    return st, V, len(st.deltas), st.bmask.shape[0], tab, st.kernel_deltas


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


@functools.lru_cache(maxsize=None)
def _plan(V: int, O: int, KB: int, NC: int, wide: bool) -> dict:
    """K1's launch plan at a shape (`qcss_uf_stencil_full_config`)."""
    out = (ctypes.c_longlong * 6)()
    _cuda.check(_cuda.load().qcss_uf_stencil_full_config(
        V, O, KB, NC, int(wide), out), "qcss_uf_stencil_full_config")
    keys = ("shots_per_block", "smem_bytes", "tables_in_smem", "shot_bytes",
            "registers", "blocks_per_sm")
    return dict(zip(keys, (int(x) for x in out)))


def stencil_full_config(dg) -> dict:
    """K1's launch plan at a graph's shape: shots (warps) per block, shared
    memory per block, whether the tables are staged in shared memory,
    bytes of one shot's state, registers per thread, resident blocks per
    SM, and the edge-word form (needs the card: builds the kernels)."""
    st = dg.stencil
    _, wide, presat = st.kernel_words(dg.pack_shift)
    return {**_plan(dg.num_nodes + 1, len(st.deltas), st.bmask.shape[0],
                    len(st.chunks), wide),
            "form": "wide" if wide else "narrow", "presat": presat}


def stencil_full(dg, defect: torch.Tensor):
    """Launch the stencil kernel: defect [B, V] int32 (hub column zero) ->
    (packed [B, V] int32, act [B, V] int32, chunk_vals: one [B, V] int32
    per spilled chunk of the graph)."""
    global launches, chunk_launches
    st, V, O, KB, tab, deltas = _stencil_args(dg, defect)
    B = defect.shape[0]
    _check_plane("defect", defect, (B, V))
    NC = len(st.chunks)
    if 2 * O + KB > 32 or V > 1 << 16:
        raise ValueError(f"the stencil kernel takes 2*O + KB <= 32 and "
                         f"V <= 65536; got O={O}, KB={KB}, V={V}")
    words, wide, presat = st.kernel_words(dg.pack_shift)
    plan = _plan(V, O, KB, NC, wide)
    if plan["shots_per_block"] == 0:
        raise ValueError(
            f"one shot of the stencil kernel needs {plan['shot_bytes']} bytes "
            f"of shared memory at V={V}, O={O}, KB={KB}, NC={NC}; a block "
            f"has {_cuda.MAX_SHARED_BYTES}")
    # edges of weight 0: the plain version's batch-wide round loop runs its
    # first round on every shot as soon as one shot has a defect; the
    # launch finds that out on the card, in ``flag``
    flag = torch.empty(1, dtype=torch.int32, device=defect.device) \
        if presat else None
    ctab = st.kernel_chunk_tables if NC else tab
    packed = torch.empty_like(defect)
    act = torch.empty_like(defect)
    chunks = torch.empty((NC, B, V), dtype=torch.int32, device=defect.device)
    err = _cuda.load().qcss_uf_stencil_full(
        defect.data_ptr(), words.data_ptr(), ctab.data_ptr(),
        deltas.data_ptr(), B, V, O, KB, NC, dg.pack_shift, dg.max_rounds,
        int(wide), int(presat), flag.data_ptr() if presat else None,
        packed.data_ptr(), act.data_ptr(), chunks.data_ptr(),
        _stream(defect))
    _cuda.check(err, "qcss_uf_stencil_full")
    launches += 1
    chunk_launches += NC > 0
    return packed, act, tuple(chunks.unbind(0))


def decode_stencil_cuda(dg, detectors: torch.Tensor):
    """`device_uf.decode_labels` for a CUDA tensor: (labels, converged)."""
    from qcss_tpu_torch.decode.device_uf import (
        _stencil_labels,
        stencil_defect,
    )

    defect = stencil_defect(dg, detectors)
    return _stencil_labels(dg, defect, *stencil_full(dg, defect))


_STAGED_KEYS = ("shots_per_block", "smem_bytes", "form", "shot_bytes",
                "registers", "blocks_per_sm")
#: the forms K3 and K5 read their tables in, and K4's (none;
#: `qcss_stencil_staged_config`)
_STAGED_FORMS = ("int32 tables in device memory",
                 "label bytes in shared memory",
                 "label words in shared memory",
                 "narrow words in shared memory",
                 "no tables")


def _staged_query(kernel: int, V: int, O: int, KB: int, L: int,
                  tables: int | None = None) -> dict:
    out = (ctypes.c_longlong * 6)()
    _cuda.check(_cuda.load().qcss_stencil_staged_config(
        kernel, V, O, KB, L, tables, out), "qcss_stencil_staged_config")
    plan = dict(zip(_STAGED_KEYS, (int(x) for x in out)))
    plan["tables_in_smem"] = plan["form"] in (1, 2, 3)
    plan["form"] = _STAGED_FORMS[plan["form"]]
    return plan


@functools.lru_cache(maxsize=None)
def _staged_plan(kernel: int, V: int, O: int, KB: int, L: int) -> dict:
    """K3's (kernel 3), K4's (4) or K5's (5) launch plan at a shape."""
    return _staged_query(kernel, V, O, KB, L)


def stencil_staged_config(dg, kernel: str) -> dict:
    """The launch plan of K3 (``kernel="prop"``), K4 (``"act"``) or K5
    (``"round"``) on a graph: shots (warps) per block, shared memory per
    block, bytes of one shot's state, registers per thread, resident blocks
    per SM, and the form the kernel reads the graph's tables in
    (`tables_in_smem` when it stages them; K4 reads none); K5's form is the
    one the kernel finds for these tables. Needs the card: builds the
    kernels."""
    st = dg.stencil
    V, O, KB = dg.num_nodes + 1, len(st.deltas), st.bmask.shape[0]
    return _staged_query({"prop": 3, "act": 4, "round": 5}[kernel], V, O,
                         KB, dg.pack_shift, st.kernel_tables.data_ptr())


def _check_fits(kernel: int, V: int, O: int, KB: int, L: int):
    plan = _staged_plan(kernel, V, O, KB, L)
    if plan["shots_per_block"] == 0:
        raise ValueError(
            f"one shot of K{kernel} needs {plan['shot_bytes']} bytes of "
            f"shared memory at V={V}; a block has {_cuda.MAX_SHARED_BYTES}")


def stencil_prop(dg, packed: torch.Tensor, satm: torch.Tensor,
                 satb: torch.Tensor) -> torch.Tensor:
    """Launch the propagation kernel: packed [B, V] int32, satm [B, O, V]
    bool, satb [B, KB, V] bool -> packed [B, V] int32 at the fixpoint."""
    _, V, O, KB, tab, deltas = _stencil_args(dg, packed)
    B = packed.shape[0]
    _check_plane("packed", packed, (B, V))
    _check_plane("satm", satm, (B, O, V), torch.bool)
    _check_plane("satb", satb, (B, KB, V), torch.bool)
    _check_fits(3, V, O, KB, dg.pack_shift)
    out = torch.empty_like(packed)
    err = _cuda.load().qcss_stencil_prop(
        packed.data_ptr(), satm.data_ptr(), satb.data_ptr(), tab.data_ptr(),
        deltas.data_ptr(), B, V, O, KB, dg.pack_shift, out.data_ptr(),
        _stream(packed))
    _cuda.check(err, "qcss_stencil_prop")
    staged_launches["prop"] += 1
    return out


def stencil_act(dg, act: torch.Tensor, passes: torch.Tensor) -> torch.Tensor:
    """Launch the activity kernel: act [B, V] int32 (nonzero: active),
    passes [B, O, V] bool -> act [B, V] int32 0/1 at the fixpoint."""
    _, V, O, KB, _, deltas = _stencil_args(dg, act)
    B = act.shape[0]
    _check_plane("act", act, (B, V))
    _check_plane("passes", passes, (B, O, V), torch.bool)
    _check_fits(4, V, O, KB, dg.pack_shift)
    out = torch.empty_like(act)
    err = _cuda.load().qcss_stencil_act(
        act.data_ptr(), passes.data_ptr(), deltas.data_ptr(), B, V, O,
        out.data_ptr(), _stream(act))
    _cuda.check(err, "qcss_stencil_act")
    staged_launches["act"] += 1
    return out


def stencil_round(dg, packed: torch.Tensor, seed: torch.Tensor,
                  sup: torch.Tensor):
    """Launch the growth-round kernel: packed, seed [B, V] int32 and sup
    [B, O + KB, V] int32 (the O edge support planes, then the KB boundary
    ones) -> (packed, sup, grew [B, V] int32)."""
    _, V, O, KB, tab, deltas = _stencil_args(dg, packed)
    B = packed.shape[0]
    _check_plane("packed", packed, (B, V))
    _check_plane("seed", seed, (B, V))
    _check_plane("sup", sup, (B, O + KB, V))
    _check_fits(5, V, O, KB, dg.pack_shift)
    out_packed = torch.empty_like(packed)
    out_sup = torch.empty_like(sup)
    grew = torch.empty_like(packed)
    err = _cuda.load().qcss_stencil_round(
        packed.data_ptr(), seed.data_ptr(), sup.data_ptr(), tab.data_ptr(),
        deltas.data_ptr(), B, V, O, KB, dg.pack_shift, out_packed.data_ptr(),
        out_sup.data_ptr(), grew.data_ptr(), _stream(packed))
    _cuda.check(err, "qcss_stencil_round")
    staged_launches["round"] += 1
    return out_packed, out_sup, grew
