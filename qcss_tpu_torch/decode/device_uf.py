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

Three decoders share that state. The stencil decoder serves lattice
graphs: `decode_labels` sends a CUDA tensor to the hand-written kernel
(`device_uf_cuda`, the counterpart of the Mosaic `make_full_kernel`) and a
CPU tensor to its plain version, `_stencil_plain`, spilled label lanes
included. `_decode_packed` and `_decode_unpacked` are the generic
incidence-table decoders (plain torch on either device, as they are plain
XLA in the reference): they take graphs that are not stencil-eligible,
per-shot weights and, with `_decode_stencil`, per-round iteration caps.
The plain pieces `_prop_plain`, `_act_plain` and `_round_plain` have the
contracts of the staged kernels (`device_uf_staged`); `_stencil_plain` is
built from the same sweeps.
"""

from __future__ import annotations

from functools import cached_property, partial
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


class _StencilFields(NamedTuple):
    deltas: tuple               # distinct positive offsets, python ints
    emask: torch.Tensor         # [O, V] bool
    ewt: torch.Tensor           # [O, V] int32
    eobs: torch.Tensor          # [O, V] int32, packed lanes
    bmask: torch.Tensor         # [KB, V] bool
    bwt: torch.Tensor           # [KB, V] int32
    bobs: torch.Tensor          # [KB, V] int32, packed lanes
    chunks: tuple = ()          # ChunkLanes for spilled label lanes


class StencilGraph(_StencilFields):
    """Shift-stencil representation for LATTICE decoding graphs. Eligible
    when every internal edge connects v to v + delta for a SMALL set of
    distinct deltas (surface spacetime graphs have 4, circuit-level DEM
    graphs 7), no two internal edges share an endpoint pair, and boundary
    edges number <= ``KB`` per node. Edge (o, v) is the internal edge
    v -- v+deltas[o] where ``emask[o, v]``; boundary slot (k, v) is the
    k-th boundary edge at v where ``bmask[k, v]``.

    The ``kernel_*`` properties are the same tables in the layout the
    stencil kernels read, built once per placed graph (`to` makes a new
    graph, whose tables are built on its device at first use)."""

    def to(self, device) -> "StencilGraph":
        return _to(self, device)

    @cached_property
    def kernel_tables(self) -> torch.Tensor:
        """[3*O + 3*KB, V] int32: emask, ewt, eobs, bmask, bwt, bobs."""
        return torch.cat([self.emask.to(torch.int32), self.ewt, self.eobs,
                          self.bmask.to(torch.int32), self.bwt, self.bobs]
                         ).to(torch.int32).contiguous()

    @cached_property
    def kernel_chunk_tables(self) -> torch.Tensor:
        """[NC, O + KB, V] int32: per chunk its edge bits, then its
        boundary bits."""
        O, V = self.emask.shape
        if not self.chunks:
            return torch.zeros((0, O + self.bmask.shape[0], V),
                               dtype=torch.int32, device=self.emask.device)
        return torch.stack([torch.cat([c.eobs, c.bobs]) for c in self.chunks]
                           ).to(torch.int32).contiguous()

    @cached_property
    def kernel_deltas(self) -> torch.Tensor:
        """[O] int32, on the tables' device."""
        return torch.as_tensor(self.deltas, dtype=torch.int32,
                               device=self.emask.device)

    def kernel_words(self, L: int):
        """The edge and boundary-slot words of the whole-decode kernel at
        pack shift ``L``, built once per (graph, L): (words, wide, presat).

        One word per edge (O rows) and slot (KB rows) holds its presence,
        weight and label bits. Narrow, when every present weight is at
        most 255, L <= 23 and the label bits fit below bit L: [O + KB, V]
        int32 ``(max(wt, 0) + 1) << L | obs``, 0 where there is no edge.
        Wide otherwise: [O + KB, V, 2] int32 {obs, max(wt, 0) or -1}.
        Weights at or below 0 all act alike (saturated from the first
        growth step, never grown), so they become 0. ``presat`` says
        whether any present edge or slot has such a weight."""
        cache = self.__dict__.setdefault("_kernel_words", {})
        if L not in cache:
            mask = torch.cat([self.emask, self.bmask])
            wt = torch.cat([self.ewt, self.bwt]).to(torch.int64).clamp(min=0)
            obs = torch.cat([self.eobs, self.bobs]).to(torch.int64)
            presat = bool((mask & (wt == 0)).any())
            narrow = L <= 23 and bool(
                ((wt <= 255) & (obs >= 0) & (obs < (1 << L)) | ~mask).all())
            if narrow:
                w = torch.where(mask, ((wt + 1) << L) | obs, 0)
                words = torch.where(w >= 1 << 31, w - (1 << 32), w)
            else:
                words = torch.stack([obs, torch.where(mask, wt, -1)], dim=-1)
            cache[L] = (words.to(torch.int32).contiguous(), not narrow,
                        presat)
        return cache[L]


class ChunkLanes(NamedTuple):
    """Label lanes that did not fit in the packed word (lane spilling,
    `build_device_graph(spill_lanes=True)`). Up to 30 bits of spilled
    lanes per chunk. The stencil decode carries one word per vertex and
    chunk along with the labels: the XOR of the chunk's edge bits down the
    adoption forest, which the reference spreads after convergence."""

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
    hit or a per-round iteration cap (``prop_cap`` / ``act_cap`` in
    `build_device_graph`) cut its fixpoint short. ``dg`` must live on the
    same device as ``detectors``.

    ``shot_weights`` ([B, E] int32, values >= 1) overrides the static
    growth saturations per shot (heralded erasure, soft readout); it runs
    on the packed or unpacked decoder, since the stencil tables bake the
    weights in.

    The routes are the reference's. A stencil graph without caps goes to
    the hand-written kernel (`device_uf_cuda`) for a CUDA tensor and to its
    plain version, `_stencil_plain`, for a CPU tensor. That holds for a
    graph with spilled lanes too: off the TPU the reference decodes those
    with `_decode_unpacked`, but a kernel's plain version is the same
    function as the kernel, so here the CPU resolves the chunks as the
    card does. With caps, a stencil graph runs `_decode_stencil` (or
    `_decode_unpacked` when lanes are spilled); any other graph runs
    `_decode_packed` when its lanes fit one word, else `_decode_unpacked`.
    """
    if not isinstance(detectors, torch.Tensor):
        detectors = torch.as_tensor(np.asarray(detectors))
    st = dg.stencil
    if shot_weights is not None:
        if dg.pack_shift is not None and not (st is not None and st.chunks):
            return _decode_packed(dg, detectors, shot_weights)
        return _decode_unpacked(dg, detectors, shot_weights)
    if st is not None:
        if dg.prop_cap is None and dg.act_cap is None:
            if detectors.is_cuda:
                from qcss_tpu_torch.decode.device_uf_cuda import (
                    decode_stencil_cuda,
                )

                return decode_stencil_cuda(dg, detectors)
            defect = stencil_defect(dg, detectors)
            return _stencil_labels(dg, defect, *_stencil_plain(dg, defect))
        if st.chunks:
            return _decode_unpacked(dg, detectors)
        return _decode_stencil(dg, detectors)
    if dg.pack_shift is not None:
        return _decode_packed(dg, detectors)
    return _decode_unpacked(dg, detectors)


def stencil_defect(dg: DeviceGraph, detectors: torch.Tensor) -> torch.Tensor:
    """[B, num_nodes] detectors -> [B, V] int32 defects, with the boundary
    hub's column (V-1) zero: the input of the stencil decode."""
    B = detectors.shape[0]
    return torch.cat(
        [detectors.to(torch.int32) & 1,
         torch.zeros((B, 1), dtype=torch.int32, device=detectors.device)],
        dim=1).contiguous()


_BIG = 2**30


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


def _capped_while(body, state, cap):
    """Run ``body`` (state -> (state, changed_shot [B] bool)) until no shot
    changed, or for ``cap`` iterations. Returns (state, suspect [B]) where
    suspect marks the shots still changing when the cap cut the loop
    (all False when cap is None). Each test of the loop is a host read."""
    B = state[0].shape[0]
    if cap is None:
        while True:
            state, changed = body(state)
            if not bool(changed.any()):
                return state, torch.zeros(B, dtype=torch.bool,
                                          device=state[0].device)
    changed = torch.ones(B, dtype=torch.bool, device=state[0].device)
    k = 0
    while k < cap and bool(changed.any()):
        state, changed = body(state)
        k += 1
    return state, changed


def _propagate(dg: DeviceGraph, packed, satm, satb, chunk_vals=(), cap=None):
    """Label propagation to the fixpoint over the saturated edges, by
    Jacobi sweeps. packed [B, V] int32, satm [B, O, V] and satb [B, KB, V]
    bool. ``chunk_vals`` (one [B, V] int32 per spilled chunk) travel with
    the labels: on adoption a vertex copies its parent's word XOR the
    adopted edge's chunk bits, and among equal candidates the first wins
    in the reference's order (per offset v+d then v-d, then the hub's
    slots); the hub takes its word from the first slot that offers its
    minimum and, within it, the smallest vertex. Returns (packed,
    chunk_vals, still [B]): still marks the shots ``cap`` cut short."""
    st = dg.stencil
    bn = dg.num_nodes
    L = dg.pack_shift
    KB = st.bmask.shape[0]
    V = packed.shape[1]
    vids = torch.arange(V, dtype=torch.int32, device=packed.device)[None, :]

    def body(state):
        packed, vals = state
        cands = []
        for o, d in enumerate(st.deltas):
            eobs = st.eobs[o][None, :]
            m = satm[:, o]
            offered = torch.where(m, packed ^ eobs, _BIG)
            cands.append(torch.where(
                m, _shift_dn(packed, d, _BIG) ^ eobs, _BIG))
            cands.append(_shift_up(offered, d, _BIG))
        hub = packed[:, bn][:, None]
        for k in range(KB):
            cands.append(torch.where(satb[:, k], hub ^ st.bobs[k][None, :],
                                     _BIG))
        cand = cands[0]
        for c in cands[1:]:
            cand = torch.minimum(cand, c)
        adopted = (cand >> L) < (packed >> L)
        new = torch.where(adopted, cand, packed)
        # hub adoption: min over every saturated boundary slot
        hub_cands = [torch.where(satb[:, k], packed ^ st.bobs[k][None, :],
                                 _BIG) for k in range(KB)]
        hub_cand = torch.stack([h.amin(dim=1) for h in hub_cands]).amin(dim=0)
        adopted_b = (hub_cand >> L) < (packed[:, bn] >> L)
        new[:, bn] = torch.where(adopted_b, hub_cand, new[:, bn])
        if vals:
            best_v = torch.zeros_like(hub_cand)
            best_k = torch.zeros_like(hub_cand)
            found = torch.zeros_like(adopted_b)
            for k in range(KB):
                match = satb[:, k] & (hub_cands[k] == hub_cand[:, None])
                mv = torch.where(match, vids, _BIG).amin(dim=1)
                hit = ~found & (mv < _BIG)
                best_v = torch.where(hit, mv, best_v)
                best_k = torch.where(hit, k, best_k)
                found = found | hit
            best_v, best_k = best_v.long(), best_k.long()
            new_vals = []
            for chunk, val in zip(st.chunks, vals):
                offers = []
                for o, d in enumerate(st.deltas):
                    bits = chunk.eobs[o][None, :]
                    offers.append(_shift_dn(val, d, 0) ^ bits)
                    offers.append(_shift_up(val ^ bits, d, 0))
                hub_word = val[:, bn][:, None]
                for k in range(KB):
                    offers.append(hub_word ^ chunk.bobs[k][None, :])
                won = torch.zeros_like(val)
                for c, offer in zip(reversed(cands), reversed(offers)):
                    won = torch.where(c == cand, offer, won)
                new_val = torch.where(adopted, won, val)
                provider = (val.gather(1, best_v[:, None])[:, 0]
                            ^ chunk.bobs[best_k, best_v])
                new_val[:, bn] = torch.where(adopted_b, provider, val[:, bn])
                new_vals.append(new_val)
            vals = tuple(new_vals)
        return (new, vals), adopted.any(dim=1) | adopted_b

    (packed, vals), still = _capped_while(body, (packed, tuple(chunk_vals)),
                                          cap)
    return packed, vals, still


def _prop_plain(dg: DeviceGraph, packed, satm, satb):
    """The plain version of the propagation kernel
    (`device_uf_cuda.stencil_prop`; the reference's `make_prop_kernel`):
    packed [B, V] int32, satm [B, O, V] bool, satb [B, KB, V] bool ->
    packed [B, V] int32 at the fixpoint."""
    return _propagate(dg, packed, satm.bool(), satb.bool())[0]


def _spread(dg: DeviceGraph, act, passes, cap=None):
    """Activity OR-fixpoint: act [B, V] int32 0/1 spreads both ways over
    the edges whose passes [B, O, V] bool is set. Returns (act, still)."""
    st = dg.stencil

    def body(state):
        (act,) = state
        new = act
        for o, d in enumerate(st.deltas):
            po = passes[:, o]
            new = new | (_shift_dn(act, d, 0) & po) | _shift_up(act & po, d, 0)
        return (new,), (new != act).any(dim=1)

    (act,), still = _capped_while(body, (act,), cap)
    return act, still


def _act_plain(dg: DeviceGraph, act, passes):
    """The plain version of the activity kernel
    (`device_uf_cuda.stencil_act`; the reference's `make_act_kernel`):
    act [B, V] int32 0/1, passes [B, O, V] bool (any dtype is read as
    != 0) -> act [B, V] int32 at the fixpoint."""
    return _spread(dg, (act != 0).to(torch.int32), passes != 0)[0]


def _grow_step(dg: DeviceGraph, packed, act, sup, supb):
    """One delta-stepped growth step: every growable edge of an active
    cluster advances by the shot's minimum slack, so that some edge
    saturates. act [B, V] int32 0/1; sup [B, O, V], supb [B, KB, V] int32.
    Returns (sup, supb, grew [B, V] int32: 1 where an edge or boundary slot
    at v grew)."""
    st = dg.stencil
    bn = dg.num_nodes
    comp = packed >> dg.pack_shift
    KB = st.bmask.shape[0]
    incs = []
    for o, d in enumerate(st.deltas):
        growable = (st.emask[o][None, :] & (sup[:, o] < st.ewt[o])
                    & (comp != _shift_dn(comp, d, -1)))
        incs.append(torch.where(growable, act + _shift_dn(act, d, 0), 0))
    inc = torch.stack(incs, dim=1)  # [B, O, V]
    comp_bn = comp[:, bn][:, None]
    incb = torch.stack([
        torch.where(st.bmask[k][None, :] & (supb[:, k] < st.bwt[k])
                    & (comp != comp_bn), act, 0)
        for k in range(KB)
    ], dim=1)  # [B, KB, V]

    def ceil_steps(wt, s, n):
        # ceil((wt - s) / n) where n > 0 (wt > s there), BIG elsewhere
        q = -torch.div(-(wt - s), torch.clamp(n, min=1),
                       rounding_mode="floor")
        return torch.where(n > 0, q, _BIG).amin(dim=(1, 2))

    slack = torch.minimum(ceil_steps(st.ewt[None], sup, inc),
                          ceil_steps(st.bwt[None], supb, incb))
    delta = torch.clamp(slack, min=1)
    delta = torch.where(delta >= _BIG, 1, delta)[:, None, None]
    grew = ((inc > 0).any(dim=1) | (incb > 0).any(dim=1)).to(torch.int32)
    return sup + inc * delta, supb + incb * delta, grew


def _saturated(dg: DeviceGraph, sup, supb):
    """(satm [B, O, V], satb [B, KB, V]) bool: the edges and boundary slots
    whose support reached their weight."""
    st = dg.stencil
    return ((sup >= st.ewt[None]) & st.emask[None],
            (supb >= st.bwt[None]) & st.bmask[None])


def _cluster_passes(dg: DeviceGraph, packed, satm):
    """passes [B, O, V] bool: the saturated edges inside one cluster,
    over which activity spreads."""
    comp = packed >> dg.pack_shift
    return torch.stack(
        [satm[:, o] & (comp == _shift_dn(comp, d, -1))
         for o, d in enumerate(dg.stencil.deltas)], dim=1)


def _scatter_parity(comp, defect, bn):
    """[B, V] bool, True at the representative of every cluster that holds
    an odd number of defects and not the boundary hub (one scatter-add of
    the defects onto their representatives)."""
    V = comp.shape[1]
    vids = torch.arange(V, dtype=torch.int32, device=comp.device)[None, :]
    cnt = torch.zeros_like(defect)
    cnt.scatter_add_(1, comp.long(), defect)
    act_root = ((cnt & 1) == 1) & (vids != comp[:, bn][:, None])
    return act_root & (comp == vids)


def parity_seeds(dg: DeviceGraph, packed, defect):
    """seed [B, V] int32 0/1: the activity seeds of the packed labels, 1 at
    the representative of every odd cluster away from the hub."""
    return _scatter_parity(packed >> dg.pack_shift, defect,
                           dg.num_nodes).to(torch.int32)


def _round_plain(dg: DeviceGraph, packed, seed, sups, supbs):
    """The plain version of the growth-round kernel
    (`device_uf_cuda.stencil_round`; the reference's `make_round_kernel`):
    the activity spread from the parity seeds, one delta-stepped growth
    step, and label propagation to the fixpoint. packed, seed [B, V] int32;
    sups [B, O, V], supbs [B, KB, V] int32. Returns (packed, sups, supbs,
    grew [B, V] int32)."""
    satm, _ = _saturated(dg, sups, supbs)
    act = _act_plain(dg, seed, _cluster_passes(dg, packed, satm))
    sups, supbs, grew = _grow_step(dg, packed, act, sups, supbs)
    packed = _prop_plain(dg, packed, *_saturated(dg, sups, supbs))
    return packed, sups, supbs, grew


def initial_labels(dg: DeviceGraph, B: int, device) -> torch.Tensor:
    """packed [B, V] int32 with every vertex its own cluster."""
    V = dg.num_nodes + 1
    return (torch.arange(V, dtype=torch.int32, device=device)
            << dg.pack_shift)[None, :].expand(B, V).clone()


def _stencil_rounds(dg: DeviceGraph, defect, prop_cap=None, act_cap=None):
    """The stencil decode's round loop: growth, propagation, cluster
    parity by a scatter-add, activity. Batch-wide: it ends when no shot is
    active or nothing grew (a quiet shot does not change meanwhile).
    Returns (packed, act, chunk_vals, suspect [B])."""
    st = dg.stencil
    B, V = defect.shape
    O = len(st.deltas)
    KB = st.bmask.shape[0]
    dev = defect.device
    packed = initial_labels(dg, B, dev)
    sup = torch.zeros((B, O, V), dtype=torch.int32, device=dev)
    supb = torch.zeros((B, KB, V), dtype=torch.int32, device=dev)
    vals = tuple(torch.zeros_like(defect) for _ in st.chunks)
    suspect = torch.zeros(B, dtype=torch.bool, device=dev)
    act = defect
    active = bool(act.any())
    i = 0
    while active and i < dg.max_rounds:
        sup, supb, grew = _grow_step(dg, packed, act, sup, supb)
        satm, satb = _saturated(dg, sup, supb)
        packed, vals, still_p = _propagate(dg, packed, satm, satb, vals,
                                           prop_cap)
        act, still_a = _spread(dg, parity_seeds(dg, packed, defect),
                               _cluster_passes(dg, packed, satm), act_cap)
        suspect = suspect | still_p | still_a
        # shots a cap cut short are frozen: their labels are not to be
        # trusted, and they must not gate the batch
        act = torch.where(suspect[:, None], 0, act)
        active = bool(act.any() & grew.any())
        i += 1
    return packed, act, vals, suspect


def _stencil_plain(dg: DeviceGraph, defect: torch.Tensor):
    """The plain version of the stencil kernel (`device_uf_cuda.stencil_full`):
    defect [B, V] int32 -> (packed [B, V] int32, act [B, V] int32,
    chunk_vals: one [B, V] int32 per spilled chunk), the final labels,
    activity and forest-path chunk words. The reference's XLA
    `_decode_stencil` loop, built from the same sweeps as `_prop_plain`,
    `_act_plain` and `_round_plain`; each fixpoint test is a host sync."""
    return _stencil_rounds(dg, defect)[:3]


def _stencil_labels(dg: DeviceGraph, defect, packed, act, chunk_vals=()):
    """Label lanes and convergence from the stencil decode's final state,
    shared by the kernel and its plain version: per lane the XOR of its
    bits over the defects, plus the hub's when the boundary cluster holds
    an odd number of defects. Packed lanes are read from the packed word,
    spilled lanes from their chunk's word; the labels come back in the
    order of the lanes' ids."""
    bn = dg.num_nodes
    L = dg.pack_shift
    lane_bits = (1 << L) - 1
    is_defect = defect != 0
    broot = packed[:, bn] >> L
    in_bc = (packed >> L) == broot[:, None]
    bc_odd = (torch.where(in_bc, defect, 0).sum(dim=1) & 1) == 1

    def total(words):
        tot = xor_reduce(torch.where(is_defect, words, 0))
        return tot ^ torch.where(bc_odd, words[:, bn], 0)

    chunks = dg.stencil.chunks if dg.stencil is not None else ()
    packed_ids = dg.packed_lane_ids or tuple(range(len(dg.lane_offsets)))
    by_id = [None] * (len(packed_ids) + sum(len(c.lane_ids) for c in chunks))
    tot = total(packed & lane_bits)
    for lane_id, off, mask in zip(packed_ids, dg.lane_offsets,
                                  dg.lane_masks):
        by_id[lane_id] = ((tot >> off) & mask).to(torch.int32)
    for chunk, val in zip(chunks, chunk_vals):
        ctot = total(val)
        for lane_id, off, mask in zip(chunk.lane_ids, chunk.offsets,
                                      chunk.masks):
            by_id[lane_id] = ((ctot >> off) & mask).to(torch.int32)
    converged = ~(act != 0).any(dim=1)
    return tuple(by_id), converged


def _decode_stencil(dg: DeviceGraph, detectors):
    """Stencil decode in plain torch on the detectors' device, honouring
    ``prop_cap`` / ``act_cap`` (the reference's XLA `_decode_stencil`):
    shots a cap cut short report converged False. Chunk graphs do not come
    here with caps (`decode_labels`)."""
    defect = stencil_defect(dg, detectors)
    packed, act, vals, suspect = _stencil_rounds(dg, defect, dg.prop_cap,
                                                 dg.act_cap)
    labels, converged = _stencil_labels(dg, defect, packed, act, vals)
    return labels, converged & ~suspect


def _grow_edges(support, wtB, comp_eu, comp_ev, au, av):
    """Delta-stepped growth over an explicit edge list: support [B, E]
    advanced by the per-shot minimum slack. Returns (support, grew: a
    0-dim bool tensor, whether any edge of the batch grew)."""
    grow = (support < wtB) & (comp_eu != comp_ev)
    inc = torch.where(grow, au + av, 0)
    q = -torch.div(-(wtB - support), torch.clamp(inc, min=1),
                   rounding_mode="floor")
    slack = torch.where(inc > 0, q, _BIG)
    delta = torch.clamp(slack.amin(dim=1, keepdim=True), min=1)
    delta = torch.where(delta >= _BIG, 1, delta)
    return support + inc * delta, (inc > 0).any()


def _decode_packed(dg: DeviceGraph, detectors, shot_weights=None):
    """Packed-label decoder over the incidence tables, for any graph whose
    lanes fit beside comp in an int32: per-slot gathers reduced with a
    minimum (an adoption is XOR + min). Plain torch on the detectors'
    device, as the reference's is plain XLA. ``shot_weights`` ([B, E] int,
    values >= 1) overrides the static growth saturations per shot."""
    dets = detectors
    dev = dets.device
    B = dets.shape[0]
    E = dg.eu.shape[0]
    D = dg.inc_e.shape[1]
    bn = dg.num_nodes
    L = dg.pack_shift
    eu, ev = dg.eu.long(), dg.ev.long()
    wtB = (dg.wt[None, :] if shot_weights is None
           else torch.as_tensor(shot_weights, device=dev).to(torch.int32))
    inc_cols = [dg.inc_e[:, j].long() for j in range(D)]
    other_cols = [dg.other_v[:, j].long() for j in range(D)]
    plab_cols = [dg.packed_inc[:, j][None, :] for j in range(D)]
    b_other, b_edges = dg.b_other.long(), dg.b_edges.long()
    defect = stencil_defect(dg, dets)
    false_col = torch.zeros((B, 1), dtype=torch.bool, device=dev)

    def propagate(packed, satE, satB):
        def body(state):
            (packed,) = state
            cand = None
            for j in range(D):
                c = torch.where(satE[:, inc_cols[j]],
                                packed[:, other_cols[j]] ^ plab_cols[j], _BIG)
                cand = c if cand is None else torch.minimum(cand, c)
            # adopt only on a STRICT comp improvement: an equal-comp
            # candidate with smaller lane bits must not win, or paths keep
            # churning toward the min-parity path
            adopted = (cand >> L) < (packed >> L)
            new = torch.where(adopted, cand, packed)
            cand_b = torch.where(satB, packed[:, b_other] ^ dg.packed_b[None],
                                 _BIG).amin(dim=1)
            adopted_b = (cand_b >> L) < (new[:, bn] >> L)
            new[:, bn] = torch.where(adopted_b, cand_b, new[:, bn])
            return (new,), adopted.any(dim=1) | adopted_b

        (packed,), still = _capped_while(body, (packed,), dg.prop_cap)
        return packed, still

    def activity(packed, sat):
        comp = packed >> L
        act = _scatter_parity(comp, defect, bn)
        same_e = comp[:, eu] == comp[:, ev]
        passE = torch.cat([sat & same_e, false_col], dim=1)
        pass_cols = [passE[:, inc_cols[j]] for j in range(D)]

        def body(state):
            (act,) = state
            new = act
            for j in range(D):
                new = new | (act[:, other_cols[j]] & pass_cols[j])
            return (new,), (new & ~act).any(dim=1)

        (act,), still = _capped_while(body, (act,), dg.act_cap)
        return act, still

    packed = initial_labels(dg, B, dev)
    support = torch.zeros((B, E), dtype=torch.int32, device=dev)
    act = defect != 0  # initial clusters are singletons
    suspect = torch.zeros(B, dtype=torch.bool, device=dev)
    active = bool(act.any())
    i = 0
    while active and i < dg.max_rounds:
        support, grew = _grow_edges(
            support, wtB, packed[:, eu] >> L, packed[:, ev] >> L,
            act[:, eu].to(torch.int32), act[:, ev].to(torch.int32))
        sat = support >= wtB
        satE = torch.cat([sat, false_col], dim=1)
        satB = sat[:, b_edges] & dg.b_mask[None, :]
        packed, still_p = propagate(packed, satE, satB)
        act, still_a = activity(packed, sat)
        suspect = suspect | still_p | still_a
        # freeze the shots a cap cut short: their labels are not to be
        # trusted, and they must not gate the batch
        act = act & ~suspect[:, None]
        active = bool(act.any() & grew)
        i += 1
    labels, converged = _stencil_labels(
        dg._replace(stencil=None), defect, packed, act.to(torch.int32))
    return labels, converged & ~suspect


def _decode_unpacked(dg: DeviceGraph, detectors, shot_weights=None):
    """Generic decoder for wide label lanes (e.g. the streaming decoder's
    carry lanes): one [B, V] parity tensor per lane, and adoptions pick
    their delivering edge by argmin + one-hot, so all lanes travel one
    consistent path (`torch.argmin` returns the first minimum, as
    `jnp.argmin` does). Plain torch on the detectors' device.
    ``shot_weights`` ([B, E] int, values >= 1) overrides the static growth
    saturations per shot."""
    dets = detectors
    dev = dets.device
    B = dets.shape[0]
    V = dg.num_nodes + 1
    E = dg.eu.shape[0]
    D = dg.inc_e.shape[1]
    bn = dg.num_nodes
    eu, ev = dg.eu.long(), dg.ev.long()
    wtB = (dg.wt[None, :] if shot_weights is None
           else torch.as_tensor(shot_weights, device=dev).to(torch.int32))
    inc_flat = dg.inc_e.reshape(-1).long()
    other_flat = dg.other_v.reshape(-1).long()
    b_other, b_edges = dg.b_other.long(), dg.b_edges.long()
    defect = stencil_defect(dg, dets)
    iota_d = torch.arange(D, device=dev)[None, None, :]
    iota_b = torch.arange(b_edges.shape[0], device=dev)[None, :]

    def gatherD(x):
        """[B, V] -> [B, V, D] via the static incidence table."""
        return x[:, other_flat].reshape(B, V, D)

    def propagate(comp, cpar, sat, satD):
        satB = sat[:, b_edges] & dg.b_mask[None, :]  # [B, Eb]

        def body(state):
            comp, cpar = state
            cand = torch.where(satD, gatherD(comp), _BIG)
            new = torch.minimum(comp, cand.amin(dim=2))
            adopted = new < comp
            oh = cand.argmin(dim=2)[:, :, None] == iota_d
            new_par = []
            for qlane, lab in zip(cpar, dg.lane_inc):
                val = torch.where(oh, gatherD(qlane) ^ lab[None], 0).sum(
                    dim=2, dtype=torch.int32)
                new_par.append(torch.where(adopted, val, qlane))
            # boundary hub: same adoption over its explicit edge list
            cand_b = torch.where(satB, comp[:, b_other], _BIG)  # [B, Eb]
            best_b = cand_b.amin(dim=1)
            cur_b = new[:, bn]
            adopted_b = best_b < cur_b
            oh_b = cand_b.argmin(dim=1)[:, None] == iota_b
            new[:, bn] = torch.minimum(cur_b, best_b)
            out_par = []
            for qlane, lab_b in zip(new_par, dg.lane_b):
                val_b = torch.where(oh_b, qlane[:, b_other] ^ lab_b[None, :],
                                    0).sum(dim=1, dtype=torch.int32)
                qlane[:, bn] = torch.where(adopted_b, val_b, qlane[:, bn])
                out_par.append(qlane)
            return (new, tuple(out_par)), adopted.any(dim=1) | adopted_b

        (comp, cpar), still = _capped_while(body, (comp, cpar), dg.prop_cap)
        return comp, cpar, still

    def activity(comp, satD):
        act = _scatter_parity(comp, defect, bn)
        passD = satD & (gatherD(comp) == comp[:, :, None])

        def body(state):
            (act,) = state
            new = act | (gatherD(act) & passD).any(dim=2)
            return (new,), (new & ~act).any(dim=1)

        (act,), still = _capped_while(body, (act,), dg.act_cap)
        return act, still

    comp = torch.arange(V, dtype=torch.int32, device=dev)[None, :] \
        .expand(B, V).clone()
    cpar = tuple(torch.zeros((B, V), dtype=torch.int32, device=dev)
                 for _ in dg.obs)
    support = torch.zeros((B, E), dtype=torch.int32, device=dev)
    act = defect != 0  # initial clusters are singletons
    suspect = torch.zeros(B, dtype=torch.bool, device=dev)
    false_col = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    active = bool(act.any())
    i = 0
    while active and i < dg.max_rounds:
        support, grew = _grow_edges(
            support, wtB, comp[:, eu], comp[:, ev],
            act[:, eu].to(torch.int32), act[:, ev].to(torch.int32))
        sat = support >= wtB
        satD = torch.cat([sat, false_col], dim=1)[:, inc_flat] \
            .reshape(B, V, D)
        comp, cpar, still_p = propagate(comp, cpar, sat, satD)
        act, still_a = activity(comp, satD)
        suspect = suspect | still_p | still_a
        act = act & ~suspect[:, None]
        active = bool(act.any() & grew)
        i += 1

    is_defect = defect != 0
    bc_odd = (torch.where(comp == comp[:, bn][:, None], defect, 0)
              .sum(dim=1) & 1) == 1
    labels = tuple(
        xor_reduce(torch.where(is_defect, qlane, 0))
        ^ torch.where(bc_odd, qlane[:, bn], 0) for qlane in cpar)
    converged = ~act.any(dim=1) & ~suspect
    return labels, converged


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
    graph, its tensors placed on ``device`` (the card by default). With
    caps, shots whose fixpoints were cut short report converged False."""
    device = resolve_device(device)
    dg = build_device_graph(graph, max_growth_rounds,
                            prop_cap=prop_cap, act_cap=act_cap)
    return partial(decode_obs, dg.to(device))


class DeviceUFDecoder:
    """Drop-in observable-only counterpart of `uf.UFDecoder` running on
    ``device`` (the card by default). `decode_batch` keeps the
    (corrections, obs) return contract with corrections=None — the device
    decoder computes logical flips without materializing corrections; use
    the host decoder when per-qubit corrections are required.

    Optional per-round fixpoint caps (`prop_cap`/`act_cap`) bound the
    batch to typical-case propagation depth; truncated shots are
    re-decoded by the host union-find (`host_fallback=True`), and only
    their detectors cross to the host. `fallback_shots` counts them over
    the instance's life. The caps default OFF, and then a stencil graph
    decodes in the stencil kernel on the card; the fallback still
    protects the `max_growth_rounds` edge uncapped."""

    def __init__(self, graph: MatchingGraph,
                 max_growth_rounds: int | None = None,
                 prop_cap: int | None = None,
                 act_cap: int | None = None,
                 host_fallback: bool = True,
                 device="cuda"):
        self.graph = graph
        self.host_fallback = host_fallback
        self.device = resolve_device(device)
        self.fallback_shots = 0
        self._host = None
        self._dg = build_device_graph(
            graph, max_growth_rounds, prop_cap=prop_cap,
            act_cap=act_cap).to(self.device)

    def decode_batch(self, syndromes, want_corrections: bool = False,
                     shot_weights=None):
        """``syndromes`` [B, num_nodes] 0/1 (numpy, or a tensor on any
        device). ``shot_weights`` ([B, E] int, values in [1, 250])
        overrides the static growth saturations per shot — same contract
        as `uf.UFDecoder.decode_batch`; the host fallback re-decodes
        truncated shots with the same weights. Returns (None, obs [B]
        uint32)."""
        if want_corrections:
            raise ValueError(
                "DeviceUFDecoder computes observable flips only; use the "
                "host UFDecoder for per-qubit corrections")
        dets = (syndromes if isinstance(syndromes, torch.Tensor)
                else torch.as_tensor(np.asarray(syndromes)))
        if dets.ndim != 2 or dets.shape[1] != self.graph.num_nodes:
            raise ValueError(
                f"syndromes must be [B, {self.graph.num_nodes}], "
                f"got {tuple(dets.shape)}")
        dets = dets.to(self.device)
        weights = None
        if shot_weights is not None:
            shot_weights = np.asarray(shot_weights)
            if shot_weights.shape != (dets.shape[0], self.graph.num_edges):
                raise ValueError("shot_weights must be [B, num_edges]")
            weights = torch.as_tensor(shot_weights.astype(np.int32),
                                      device=self.device)
        obs, converged = decode_obs(self._dg, dets, weights)
        obs = obs.cpu().numpy().astype(np.uint32)
        bad = np.nonzero(~converged.cpu().numpy())[0]
        if bad.size:
            if not self.host_fallback:
                raise RuntimeError(
                    "iteration cap hit before convergence "
                    "(host_fallback disabled)")
            from qcss_tpu_torch.decode.uf import UFDecoder

            if self._host is None:
                self._host = UFDecoder(self.graph)
            idx = torch.as_tensor(bad, device=self.device)
            _, obs_h = self._host.decode_batch(
                dets[idx].cpu().numpy(), want_corrections=False,
                shot_weights=None if shot_weights is None else
                np.clip(shot_weights[bad], 1, 250).astype(np.uint8))
            obs[bad] = obs_h
            self.fallback_shots += int(bad.size)
        return None, obs
