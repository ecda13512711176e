"""Batched union-find decoding on the device (PyTorch port of `qcss_tpu.decode.device_uf`).

Sampling and decoding run in one device pipeline; only failure counts
cross to the host. The algorithm is the reference's (Delfosse-Nickerson
growth, arXiv:1709.06218): per shot the state is

* ``packed [B, V]`` — cluster label over detectors + one virtual boundary
  node (index V-1): ``comp << L | lanes``, where comp is the min vertex
  id in the cluster after propagation and the low L bits carry the XOR
  of edge labels along a graph path from the node to its cluster
  representative (lane 0 = the logical observable). Minimising the packed
  value minimises comp, and adoption needs a STRICTLY smaller comp, so
  all lanes travel one consistent path;
* per-edge growth support, advanced by the per-shot MINIMUM slack
  (delta-stepped growth: the trajectory of unit steps, in O(#merges)
  rounds on weighted DEM graphs).

A cluster's label flip is the XOR of the packed lanes over its defects,
plus one defect-to-boundary path when its defect count is odd (only
boundary clusters end odd).

What this slice ports: the graph builders (lane packing, spilling and the
shift-stencil form), and the stencil decoder. `decode_labels` sends a
CUDA tensor to the hand-written kernel (`device_uf_cuda`, the counterpart
of the Mosaic `make_full_kernel`) and a CPU tensor to its plain version,
`_decode_stencil`. Graphs that are not stencil-eligible, per-shot weights
and iteration caps need the reference's packed/unpacked kernels, which
are not ported yet and raise `NotImplementedError`.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from qcss_tpu_torch._cuda import resolve_device
from qcss_tpu_torch.decode.uf import MatchingGraph
from qcss_tpu_torch.ops.gf2_torch import xor_reduce


def _t(a) -> torch.Tensor:
    """numpy -> CPU tensor owning a copy (bool stays bool, int32 stays
    int32)."""
    return torch.from_numpy(np.array(a))


def _to(x, device):
    """Move every tensor inside a (nested) tuple/NamedTuple to ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to(v, device) for v in x))
    if isinstance(x, tuple):
        return tuple(_to(v, device) for v in x)
    return x


class DeviceGraph(NamedTuple):
    """Static decoding-graph tensors (CPU after `build_device_graph`;
    `to(device)` moves them). ``eu``/``ev`` [E] endpoint indices with the
    boundary mapped to the virtual node V-1; ``wt`` [E] growth saturation;
    ``obs`` a tuple of [E] int32 label lanes; ``inc_e`` [V, D]
    incident-edge table (E = the zero-weight sentinel slot), ``other_v``
    [V, D] the incident edge's far endpoint; ``lane_inc`` per lane the
    [V, D] edge-label table of ``inc_e``. When the lanes fit beside comp
    in an int32 (``pack_shift`` is not None), ``packed_inc`` [V, D] /
    ``packed_b`` [Eb] hold all lanes pre-packed into their bit fields;
    ``lane_offsets``/``lane_masks`` recover individual lanes.
    ``prop_cap``/``act_cap`` bound the per-growth-round fixpoint
    iterations (None = run to convergence)."""

    eu: torch.Tensor | None
    ev: torch.Tensor | None
    wt: torch.Tensor | None
    obs: tuple
    inc_e: torch.Tensor | None
    other_v: torch.Tensor | None
    lane_inc: tuple
    b_edges: torch.Tensor | None   # [Eb] edges incident to the boundary hub
    b_other: torch.Tensor | None   # [Eb] their far endpoints
    b_mask: torch.Tensor | None    # [Eb] False on the shape-stability slot
    lane_b: tuple                  # per lane, the [Eb] labels of b_edges
    num_nodes: int  # detectors (boundary node NOT included)
    max_rounds: int
    pack_shift: int | None   # comp << pack_shift | lanes; None = unpacked
    lane_offsets: tuple      # per lane, bit offset inside the packed field
    lane_masks: tuple        # per lane, (1 << bits) - 1
    packed_inc: torch.Tensor | None  # [V, D] all lanes packed (0 outside)
    packed_b: torch.Tensor | None    # [Eb] all lanes packed
    prop_cap: int | None
    act_cap: int | None
    stencil: "StencilGraph | None" = None
    #: original lane indices carried in the packed word (all lanes
    #: unless spill_lanes moved some into stencil.chunks)
    packed_lane_ids: tuple = ()

    def to(self, device) -> "DeviceGraph":
        return _to(self, device)


class StencilGraph(NamedTuple):
    """Shift-stencil representation for LATTICE decoding graphs. Eligible
    when every internal edge connects v to v + delta for a SMALL set of
    distinct deltas (surface spacetime graphs have 4, circuit-level DEM
    graphs 7), no two internal edges share an endpoint pair, and boundary
    edges number <= ``KB`` per node. Edge (o, v) is the internal edge
    v -- v+deltas[o] where ``emask[o, v]``; boundary slot (k, v) is the
    k-th boundary edge at v where ``bmask[k, v]``."""

    deltas: tuple               # distinct positive offsets, python ints
    emask: torch.Tensor         # [O, V] bool
    ewt: torch.Tensor           # [O, V] int32
    eobs: torch.Tensor          # [O, V] int32, packed lanes
    bmask: torch.Tensor         # [KB, V] bool
    bwt: torch.Tensor           # [KB, V] int32
    bobs: torch.Tensor          # [KB, V] int32, packed lanes
    chunks: tuple = ()          # ChunkLanes for spilled label lanes

    def to(self, device) -> "StencilGraph":
        return _to(self, device)


class ChunkLanes(NamedTuple):
    """Label lanes that did not fit in the packed word (lane spilling,
    `build_device_graph(spill_lanes=True)`). Up to 30 bits of spilled
    lanes per chunk. The reference resolves them after convergence by
    XOR-spreading each chunk down the adoption forest; that path is not
    ported yet (see `decode_labels`)."""

    eobs: torch.Tensor          # [O, V] int32, this chunk's edge bits
    bobs: torch.Tensor          # [KB, V] int32
    lane_ids: tuple             # original lane indices in this chunk
    offsets: tuple              # bit offset per lane within the chunk
    masks: tuple

    def to(self, device) -> "ChunkLanes":
        return _to(self, device)


_STENCIL_MAX_OFFSETS = 10
_STENCIL_MAX_B = 4


def _build_stencil(eu, ev, wt, bn, V, packed_full, chunk_descs=()):
    """StencilGraph from the edge list, or None when the graph is not
    lattice-shaped (see StencilGraph). ``packed_full`` [E+1] carries the
    packed lanes per edge; ``chunk_descs`` is a sequence of
    (chunk_full [E], lane_ids, offsets, masks) for spilled lanes."""
    E = eu.shape[0]
    internal = [e for e in range(E) if eu[e] != bn and ev[e] != bn]
    boundary = [e for e in range(E) if eu[e] == bn or ev[e] == bn]
    lo = np.minimum(eu, ev)
    hi = np.maximum(eu, ev)
    deltas = sorted({int(hi[e] - lo[e]) for e in internal})
    if (len(deltas) > _STENCIL_MAX_OFFSETS or 0 in deltas
            or len({(int(lo[e]), int(hi[e])) for e in internal})
            != len(internal)):
        return None
    O = max(len(deltas), 1)
    emask = np.zeros((O, V), bool)
    ewt = np.zeros((O, V), np.int32)
    eobs = np.zeros((O, V), np.int32)
    dindex = {d: o for o, d in enumerate(deltas)}
    for e in internal:
        o = dindex[int(hi[e] - lo[e])]
        v = int(lo[e])
        emask[o, v] = True
        ewt[o, v] = wt[e]
        eobs[o, v] = packed_full[e]
    per_node = np.zeros(V, np.int64)
    for e in boundary:
        v = int(lo[e]) if hi[e] == bn else int(hi[e])
        per_node[v] += 1
    KB = int(per_node.max(initial=1))
    if KB > _STENCIL_MAX_B:
        return None
    bmask = np.zeros((KB, V), bool)
    bwt = np.zeros((KB, V), np.int32)
    bobs = np.zeros((KB, V), np.int32)
    fill = np.zeros(V, np.int64)
    for e in boundary:
        v = int(lo[e]) if hi[e] == bn else int(hi[e])
        k = fill[v]
        fill[v] += 1
        bmask[k, v] = True
        bwt[k, v] = wt[e]
        bobs[k, v] = packed_full[e]
    if not deltas:
        deltas = [1]  # shape stability; emask is all-False
    chunks = []
    for chunk_full, lane_ids, offsets, masks in chunk_descs:
        ceobs = np.zeros((O, V), np.int64)
        cbobs = np.zeros((KB, V), np.int64)
        for e in internal:
            ceobs[dindex[int(hi[e] - lo[e])], int(lo[e])] = chunk_full[e]
        fill2 = np.zeros(V, np.int64)
        for e in boundary:
            v = int(lo[e]) if hi[e] == bn else int(hi[e])
            cbobs[fill2[v], v] = chunk_full[e]
            fill2[v] += 1
        chunks.append(ChunkLanes(
            eobs=_t(ceobs.astype(np.int32)),
            bobs=_t(cbobs.astype(np.int32)),
            lane_ids=tuple(lane_ids),
            offsets=tuple(offsets),
            masks=tuple(masks),
        ))
    return StencilGraph(
        deltas=tuple(int(d) for d in deltas),
        emask=_t(emask),
        ewt=_t(ewt),
        eobs=_t(eobs),
        bmask=_t(bmask),
        bwt=_t(bwt),
        bobs=_t(bobs),
        chunks=tuple(chunks),
    )


def build_device_graph(graph: MatchingGraph,
                       max_growth_rounds: int | None = None,
                       extra_lanes: tuple = (),
                       prop_cap: int | None = None,
                       act_cap: int | None = None,
                       stencil: bool | None = None,
                       spill_lanes: bool = False) -> DeviceGraph:
    edges = np.asarray(graph.edges, np.int32)
    bn = graph.num_nodes  # virtual boundary node index
    V = bn + 1
    eu = np.where(edges[:, 0] < 0, bn, edges[:, 0]).astype(np.int32)
    ev = np.where(edges[:, 1] < 0, bn, edges[:, 1]).astype(np.int32)
    wt = np.asarray(graph.edge_weight, np.int32)
    E = edges.shape[0]
    lanes = [np.asarray(graph.edge_obs, np.int64)]
    lanes.extend(np.asarray(x, np.int64) for x in extra_lanes)
    for lane in lanes:
        if lane.shape != (E,):
            raise ValueError("each obs lane must be [num_edges]")
        if int(lane.max(initial=0)) > 2**30:
            raise ValueError("edge labels must fit in 31 signed bits")
    # Padded incidence tables over the REAL detectors; slot edge E is the
    # inert sentinel. The virtual boundary node is excluded — it is a hub
    # touching every boundary edge (degree 264 at surface d=11 R=11,
    # which would balloon the [B, V, D] working set 25x) and gets its own
    # explicit edge-list reduction in the kernel instead.
    deg = np.zeros(V, np.int64)
    for e in range(E):
        if eu[e] != bn:
            deg[eu[e]] += 1
        if ev[e] != bn:
            deg[ev[e]] += 1
    D = int(deg[:bn].max(initial=1))
    inc_e = np.full((V, D), E, np.int32)
    other_v = np.tile(np.arange(V, dtype=np.int32)[:, None], (1, D))
    fill = np.zeros(V, np.int64)
    for e in range(E):
        for a, b in ((eu[e], ev[e]), (ev[e], eu[e])):
            if a == bn:
                continue
            inc_e[a, fill[a]] = e
            other_v[a, fill[a]] = b
            fill[a] += 1
    b_edges = np.nonzero((eu == bn) | (ev == bn))[0].astype(np.int32)
    b_other = np.where(eu[b_edges] == bn, ev[b_edges],
                       eu[b_edges]).astype(np.int32)
    lane_inc = tuple(
        _t(np.concatenate([lane, [0]])[inc_e].astype(np.int32))
        for lane in lanes
    )
    if max_growth_rounds is None:
        # Growth is delta-stepped: each continuing round either saturates
        # at least one edge or merges clusters, so rounds are bounded by
        # E (far above any real trajectory; the loop exits as soon as no
        # cluster is active).
        max_growth_rounds = E + 1
    b_mask = np.ones(b_edges.shape[0], bool)
    if b_edges.size == 0:
        # keep the kernel shape-stable: one inert sentinel boundary slot
        b_edges = np.asarray([0], np.int32)
        b_other = np.asarray([bn], np.int32)
        b_mask = np.zeros(1, bool)

    # -- label packing: comp << L | lanes, when everything fits in 31 bits
    vbits = max(int(V - 1).bit_length(), 1)
    bits = [max(int(np.bitwise_or.reduce(lane, initial=0)).bit_length(), 1)
            for lane in lanes]
    pack_shift = None
    lane_offsets = []
    lane_masks = []
    packed_inc = packed_b = None
    stencil_graph = None
    packed_ids = list(range(len(lanes)))
    chunk_descs = []
    if spill_lanes and vbits + sum(bits) > 30:
        # keep a prefix of lanes in the packed word (lane 0 — the
        # primary observable — first), spill the rest into <=30-bit
        # chunks the full-decode kernel resolves post-convergence
        packed_ids = []
        budget = 30 - vbits
        for i, b_ in enumerate(bits):
            if b_ <= budget:
                packed_ids.append(i)
                budget -= b_
        spilled = [i for i in range(len(lanes)) if i not in packed_ids]
        cur_ids, cur_off, off = [], [], 0
        for i in spilled:
            if off + bits[i] > 30:
                chunk_descs.append((cur_ids, cur_off, off))
                cur_ids, cur_off, off = [], [], 0
            cur_ids.append(i)
            cur_off.append(off)
            off += bits[i]
        if cur_ids:
            chunk_descs.append((cur_ids, cur_off, off))
        chunk_descs = [
            (np.bitwise_or.reduce(
                np.stack([lanes[i] << o for i, o in zip(ids, offs)]),
                axis=0),
             tuple(ids), tuple(offs),
             tuple((1 << bits[i]) - 1 for i in ids))
            for ids, offs, _ in chunk_descs
        ]
    if vbits + sum(bits[i] for i in packed_ids) <= 30:
        pbits = [bits[i] for i in packed_ids]
        off = 0
        for b_ in reversed(pbits):  # lane 0 ends in the highest lane bits
            lane_offsets.append(off)
            lane_masks.append((1 << b_) - 1)
            off += b_
        lane_offsets.reverse()
        lane_masks.reverse()
        pack_shift = off
        packed_full = np.zeros(E + 1, np.int64)
        for i, o in zip(packed_ids, lane_offsets):
            packed_full[:E] |= lanes[i] << o
        packed_inc = _t(packed_full[inc_e].astype(np.int32))
        packed_b = _t(packed_full[b_edges].astype(np.int32))
        if stencil is None or stencil:
            stencil_graph = _build_stencil(
                eu, ev, wt, bn, V, packed_full[:E].astype(np.int32),
                chunk_descs)
            if stencil and stencil_graph is None:
                raise ValueError("graph is not stencil-eligible")
        if chunk_descs and stencil_graph is None:
            # spilled lanes are only decodable through the stencil full
            # kernel; a partial packed word would silently drop lanes in
            # the packed kernel — fall back to the unpacked layout
            pack_shift = None
            lane_offsets, lane_masks = [], []
            packed_inc = packed_b = None
            packed_ids = list(range(len(lanes)))
    elif stencil:
        raise ValueError(
            "stencil kernel requires packable label lanes "
            f"(log2(V)={vbits} + lane bits {sum(bits)} > 30)")
    return DeviceGraph(
        eu=_t(eu),
        ev=_t(ev),
        wt=_t(wt),
        obs=tuple(_t(lane.astype(np.int32)) for lane in lanes),
        inc_e=_t(inc_e),
        other_v=_t(other_v),
        lane_inc=lane_inc,
        b_edges=_t(b_edges),
        b_other=_t(b_other),
        b_mask=_t(b_mask),
        lane_b=tuple(
            _t(lane[b_edges].astype(np.int32)) for lane in lanes),
        num_nodes=bn,
        max_rounds=max_growth_rounds,
        pack_shift=pack_shift,
        lane_offsets=tuple(lane_offsets),
        lane_masks=tuple(lane_masks),
        packed_inc=packed_inc,
        packed_b=packed_b,
        prop_cap=prop_cap,
        act_cap=act_cap,
        stencil=stencil_graph,
        packed_lane_ids=tuple(packed_ids),
    )


def device_graph_from_numpy(*, deltas, emask, ewt, eobs, bmask, bwt, bobs,
                            pack_shift: int, lane_offsets, lane_masks,
                            num_nodes: int, max_rounds: int,
                            packed_lane_ids=()) -> DeviceGraph:
    """A stencil `DeviceGraph` from numpy arrays (e.g. the JAX package's
    `StencilGraph` fields), so that both packages decode with identical
    tables. Only the stencil path reads it: the incidence-table fields are
    None."""
    st = StencilGraph(
        deltas=tuple(int(d) for d in deltas),
        emask=_t(np.asarray(emask, bool)),
        ewt=_t(np.asarray(ewt, np.int32)),
        eobs=_t(np.asarray(eobs, np.int32)),
        bmask=_t(np.asarray(bmask, bool)),
        bwt=_t(np.asarray(bwt, np.int32)),
        bobs=_t(np.asarray(bobs, np.int32)),
    )
    return DeviceGraph(
        eu=None, ev=None, wt=None, obs=(), inc_e=None, other_v=None,
        lane_inc=(), b_edges=None, b_other=None, b_mask=None, lane_b=(),
        num_nodes=int(num_nodes), max_rounds=int(max_rounds),
        pack_shift=int(pack_shift),
        lane_offsets=tuple(int(o) for o in lane_offsets),
        lane_masks=tuple(int(m) for m in lane_masks),
        packed_inc=None, packed_b=None, prop_cap=None, act_cap=None,
        stencil=st, packed_lane_ids=tuple(packed_lane_ids),
    )


def decode_labels(dg: DeviceGraph, detectors, shot_weights=None):
    """Decode a batch of detection-event vectors on the detectors' device.

    detectors: [B, num_nodes] 0/1 (any integer dtype). Returns (labels —
    a tuple of [B] int32 tensors, one per label lane — and converged [B]
    bool). converged is False for a shot only if the growth-round cap was
    hit. ``dg`` must live on the same device as ``detectors``.

    A CUDA tensor goes to the hand-written kernel (`device_uf_cuda`); a
    CPU tensor to its plain version, `_decode_stencil`. There is no other
    route: what the kernel does not take raises.
    """
    if shot_weights is not None:
        raise NotImplementedError(
            "shot_weights run on the packed/unpacked kernels, which are not "
            "ported yet (ROADMAP.md, queue 1, slice 4)")
    if dg.stencil is None:
        raise NotImplementedError(
            "graph is not stencil-eligible; the packed/unpacked kernels it "
            "needs are not ported yet (ROADMAP.md, queue 1, slice 4)")
    if dg.prop_cap is not None or dg.act_cap is not None:
        raise NotImplementedError(
            "iteration caps run on the packed/unpacked kernels, which are "
            "not ported yet (ROADMAP.md, queue 1, slice 4)")
    if not isinstance(detectors, torch.Tensor):
        detectors = torch.as_tensor(np.asarray(detectors))
    if detectors.is_cuda:
        from qcss_tpu_torch.decode.device_uf_cuda import decode_stencil_cuda

        return decode_stencil_cuda(dg, detectors)
    if dg.stencil.chunks:
        raise NotImplementedError(
            "spilled label lanes decode through the unpacked kernel on the "
            "CPU, which is not ported yet (ROADMAP.md, queue 1, slice 4)")
    return _decode_stencil(dg, detectors)


def stencil_defect(dg: DeviceGraph, detectors: torch.Tensor) -> torch.Tensor:
    """[B, num_nodes] detectors -> [B, V] int32 defects, with the boundary
    hub's column (V-1) zero: the input of the stencil decode."""
    B = detectors.shape[0]
    return torch.cat(
        [detectors.to(torch.int32) & 1,
         torch.zeros((B, 1), dtype=torch.int32, device=detectors.device)],
        dim=1).contiguous()


def _shift_dn(x, d, fill):
    """y[:, v] = x[:, v+d] (value of the HIGH endpoint at the low slot)."""
    pad = torch.full((x.shape[0], min(d, x.shape[1])), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x[:, d:], pad], dim=1)


def _shift_up(x, d, fill):
    """y[:, v+d] = x[:, v] (value of the LOW endpoint at the high slot)."""
    pad = torch.full((x.shape[0], min(d, x.shape[1])), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([pad, x[:, :x.shape[1] - d]], dim=1)


def _stencil_plain(dg: DeviceGraph, defect: torch.Tensor):
    """The plain version of the stencil kernel (`device_uf_cuda.stencil_full`):
    defect [B, V] int32 -> (packed [B, V] int32, act [B, V] int32), the
    final labels and activity. A line-for-line port of the reference's
    XLA `_decode_stencil` loop: Jacobi propagation sweeps, the cluster
    parity by a scatter-add, and a batch-wide round loop that ends when no
    shot is active or nothing grew. Each fixpoint test is a host sync."""
    st = dg.stencil
    B, V = defect.shape
    bn = dg.num_nodes
    L = dg.pack_shift
    O = len(st.deltas)
    KB = st.bmask.shape[0]
    dev = defect.device
    vids = torch.arange(V, dtype=torch.int32, device=dev)[None, :]
    BIG = 2**30

    def propagate(packed, satm, satb):
        while True:
            cands = []
            for o, d in enumerate(st.deltas):
                eobs = st.eobs[o][None, :]
                offered = torch.where(satm[o], packed ^ eobs, BIG)
                cands.append(torch.where(
                    satm[o], _shift_dn(packed, d, BIG) ^ eobs, BIG))
                cands.append(_shift_up(offered, d, BIG))
            hub = packed[:, bn][:, None]
            for k in range(KB):
                cands.append(torch.where(satb[k], hub ^ st.bobs[k][None, :],
                                         BIG))
            cand = cands[0]
            for c in cands[1:]:
                cand = torch.minimum(cand, c)
            adopted = (cand >> L) < (packed >> L)
            new = torch.where(adopted, cand, packed)
            # hub adoption: min over every saturated boundary slot
            hub_cand = torch.stack([
                torch.where(satb[k], packed ^ st.bobs[k][None, :], BIG)
                .amin(dim=1) for k in range(KB)]).amin(dim=0)
            adopted_b = (hub_cand >> L) < (new[:, bn] >> L)
            new[:, bn] = torch.where(adopted_b, hub_cand, new[:, bn])
            packed = new
            if not bool((adopted.any(dim=1) | adopted_b).any()):
                return packed

    def activity(packed, satm):
        comp = packed >> L
        cnt = torch.zeros((B, V), dtype=torch.int32, device=dev)
        cnt.scatter_add_(1, comp.long(), defect)
        broot = comp[:, bn]
        act_root = ((cnt & 1) == 1) & (vids != broot[:, None])
        act = act_root & (comp == vids)  # defined at representatives
        passes = [satm[o] & (comp == _shift_dn(comp, d, -1))
                  for o, d in enumerate(st.deltas)]
        while True:
            new = act
            for o, d in enumerate(st.deltas):
                new = (new | (_shift_dn(act, d, False) & passes[o])
                       | _shift_up(act & passes[o], d, False))
            grew_act = bool((new & ~act).any())
            act = new
            if not grew_act:
                return act

    packed = (torch.arange(V, dtype=torch.int32, device=dev) << L)[None, :] \
        .expand(B, V).clone()
    sup = torch.zeros((B, O, V), dtype=torch.int32, device=dev)
    supb = torch.zeros((B, KB, V), dtype=torch.int32, device=dev)
    act = defect != 0
    active = bool(act.any())
    i = 0
    while active and i < dg.max_rounds:
        comp = packed >> L
        act_i = act.to(torch.int32)
        incs = []
        for o, d in enumerate(st.deltas):
            growable = (st.emask[o][None, :] & (sup[:, o] < st.ewt[o])
                        & (comp != _shift_dn(comp, d, -1)))
            incs.append(torch.where(
                growable, act_i + _shift_dn(act_i, d, 0), 0))
        inc = torch.stack(incs, dim=1)  # [B, O, V]
        comp_bn = comp[:, bn][:, None]
        incb = torch.stack([
            torch.where(st.bmask[k][None, :] & (supb[:, k] < st.bwt[k])
                        & (comp != comp_bn), act_i, 0)
            for k in range(KB)
        ], dim=1)  # [B, KB, V]

        def ceil_steps(wt, s, n):
            # ceil((wt - s) / n) where n > 0 (wt > s there), BIG elsewhere
            q = -torch.div(-(wt - s), torch.clamp(n, min=1),
                           rounding_mode="floor")
            return torch.where(n > 0, q, BIG).amin(dim=(1, 2))

        slack = torch.minimum(ceil_steps(st.ewt[None], sup, inc),
                              ceil_steps(st.bwt[None], supb, incb))
        delta = torch.clamp(slack, min=1)
        delta = torch.where(delta >= BIG, 1, delta)[:, None, None]
        sup = sup + inc * delta
        supb = supb + incb * delta
        grew = bool((inc > 0).any() | (incb > 0).any())
        satm = [(sup[:, o] >= st.ewt[o]) & st.emask[o][None, :]
                for o in range(O)]
        satb = [(supb[:, k] >= st.bwt[k]) & st.bmask[k][None, :]
                for k in range(KB)]
        packed = propagate(packed, satm, satb)
        act = activity(packed, satm)
        active = bool(act.any()) and grew
        i += 1
    return packed, act.to(torch.int32)


def _stencil_labels(dg: DeviceGraph, defect, packed, act):
    """Label lanes and convergence from the stencil decode's final state,
    shared by the kernel and its plain version: the XOR of the packed
    lanes over defects, plus the hub's lanes when the boundary cluster
    holds an odd number of defects."""
    bn = dg.num_nodes
    L = dg.pack_shift
    lane_bits = (1 << L) - 1
    broot = packed[:, bn] >> L
    in_bc = (packed >> L) == broot[:, None]
    bc_odd = torch.where(in_bc, defect, 0).sum(dim=1) & 1
    masked = torch.where(defect != 0, packed & lane_bits, 0)
    tot = xor_reduce(masked)
    tot = tot ^ torch.where(bc_odd == 1, packed[:, bn] & lane_bits, 0)
    labels = tuple(((tot >> off) & mask).to(torch.int32)
                   for off, mask in zip(dg.lane_offsets, dg.lane_masks))
    converged = ~(act != 0).any(dim=1)
    return labels, converged


def _decode_stencil(dg: DeviceGraph, detectors):
    """Plain stencil decode: `decode_labels` for a CPU tensor."""
    defect = stencil_defect(dg, detectors)
    packed, act = _stencil_plain(dg, defect)
    return _stencil_labels(dg, defect, packed, act)


def decode_obs(dg: DeviceGraph, detectors, shot_weights=None):
    """Single-lane convenience wrapper over `decode_labels`: returns
    (obs [B] int32 observable-flip bitmasks, converged [B] bool)."""
    labels, converged = decode_labels(dg, detectors, shot_weights)
    return labels[0], converged


def make_obs_decoder(graph: MatchingGraph,
                     max_growth_rounds: int | None = None,
                     prop_cap: int | None = None,
                     act_cap: int | None = None,
                     device="cuda"):
    """A ``decode(detectors) -> (obs, converged)`` closure over the given
    graph, its tensors placed on ``device`` (the card by default)."""
    device = resolve_device(device)
    dg = build_device_graph(graph, max_growth_rounds,
                            prop_cap=prop_cap, act_cap=act_cap)
    return partial(decode_obs, dg.to(device))
