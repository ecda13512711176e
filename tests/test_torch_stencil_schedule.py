"""The schedule of the whole-decode stencil kernel (K1,
qcss_tpu_torch/csrc/uf_stencil_full.cu), modelled in plain Python on the
CPU and held against the plain version it must equal bit for bit.

The kernel decodes a shot over lists of live vertices instead of sweeping
the whole graph: growth visits only the edges with an active endpoint,
and a propagation sweep recomputes only the vertices joined by a
saturated edge or slot to one that changed in the previous sweep (every
slot holder when the hub changed, the hub when a slot holder changed).
`_model_shot` below follows the kernel step by step (sat words with bit
2o for the edge to v + d_o, 2o+1 for the edge to v - d_o, 2O+k for slot
k; supports clamped at the weight; members and frontier as sets). The
tests hold its labels, activity and chunk words against
`device_uf._stencil_plain` (whose sweeps are `device_uf._propagate`), and
its growth step against `device_uf._grow_step`. Exact comparisons.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

from qcss_tpu_torch.codes.families import rotated_surface
from qcss_tpu_torch.decode import device_uf as tdu
from qcss_tpu_torch.decode.dem import circuit_level_graph, extraction_gate_list
from qcss_tpu_torch.decode.device_streaming import DeviceStreamingDecoder

BIG = 1 << 30


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # several worker processes run at once; see test_torch_device_uf.py
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Graph:
    """The stencil tables as Python lists, as the kernel reads them."""

    def __init__(self, dg):
        st = dg.stencil
        self.L = dg.pack_shift
        self.V = dg.num_nodes + 1
        self.deltas = list(st.deltas)
        self.O = len(self.deltas)
        self.KB = st.bmask.shape[0]
        self.emask = st.emask.tolist()
        self.ewt = [[max(w, 0) for w in row] for row in st.ewt.tolist()]
        self.eobs = st.eobs.tolist()
        self.bmask = st.bmask.tolist()
        self.bwt = [[max(w, 0) for w in row] for row in st.bwt.tolist()]
        self.bobs = st.bobs.tolist()
        # chunk bits [NC][O + KB][V]
        self.ctab = [c.eobs.tolist() + c.bobs.tolist() for c in st.chunks]
        self.max_rounds = dg.max_rounds


def _growth(g, cur, act, sat, sup, members, marks):
    """One delta-stepped growth step over the active members only; an edge
    with both ends active is grown from its low end. Updates sup (clamped
    at the weight) and sat, adds the ends of newly saturated edges to
    ``marks``; returns (grew, a new slot saturated)."""
    O, V, L = g.O, g.V, g.L
    hub_comp = cur[V - 1] >> L

    def edges(u):
        """(sup row, index, weight, inc, low end, high end) of the
        growable edges this active vertex grows, then its slots."""
        cu = cur[u] >> L
        for o, d in enumerate(g.deltas):
            if (u + d < V and g.emask[o][u] and not (sat[u] >> (2 * o)) & 1
                    and cu != cur[u + d] >> L):
                yield o, u, g.ewt[o][u], 1 + act[u + d], u, u + d
            if (u >= d and not act[u - d] and g.emask[o][u - d]
                    and not (sat[u] >> (2 * o + 1)) & 1
                    and cu != cur[u - d] >> L):
                yield o, u - d, g.ewt[o][u - d], 1, u - d, u
        for k in range(g.KB):
            if (g.bmask[k][u] and not (sat[u] >> (2 * O + k)) & 1
                    and cu != hub_comp):
                yield O + k, u, g.bwt[k][u], 1, u, None

    active = [u for u in members if act[u]]
    slack = min((-(-(w - sup[r][i]) // inc) for u in active
                 for r, i, w, inc, _, _ in edges(u)), default=BIG)
    if slack >= BIG:
        return False, False
    delta = max(slack, 1)
    hub_new = False
    for u in active:
        for r, i, w, inc, lo, hi in list(edges(u)):
            sup[r][i] = min(sup[r][i] + inc * delta, w)
            if sup[r][i] < w:
                continue
            if hi is None:
                sat[lo] |= 1 << (2 * O + r - O)
                marks.add(lo)
                hub_new = True
            else:
                sat[lo] |= 1 << (2 * r)
                sat[hi] |= 1 << (2 * r + 1)
                marks.update((lo, hi))
    return True, hub_new


def _propagate(g, cur, cc, sat, members, frontier, hub_in):
    """Jacobi sweeps over the frontier until nothing changes; returns the
    number of sweeps."""
    O, V, L, bn = g.O, g.V, g.L, g.V - 1
    NC = len(g.ctab)
    sweeps = 0
    while frontier or hub_in:
        sweeps += 1
        hv = cur[bn]
        new, new_c, marks, hub_next = {}, {}, set(), False
        for v in sorted(frontier):
            cand, slot = BIG, -1
            for b in range(2 * O + g.KB):
                if not (sat[v] >> b) & 1:
                    continue
                if b < 2 * O:
                    o, d = b >> 1, g.deltas[b >> 1]
                    c = (cur[v - d] ^ g.eobs[o][v - d] if b & 1
                         else cur[v + d] ^ g.eobs[o][v])
                else:
                    c = hv ^ g.bobs[b - 2 * O][v]
                if c < cand:
                    cand, slot = c, b
            if (cand >> L) >= (cur[v] >> L):
                continue
            new[v] = cand
            words = []
            for c in range(NC):
                bits = g.ctab[c]
                if slot >= 2 * O:
                    words.append(cc[c][bn] ^ bits[O + slot - 2 * O][v])
                else:
                    o, d = slot >> 1, g.deltas[slot >> 1]
                    words.append(cc[c][v - d] ^ bits[o][v - d] if slot & 1
                                 else cc[c][v + d] ^ bits[o][v])
            new_c[v] = words
            for b in range(2 * O + g.KB):
                if (sat[v] >> b) & 1:
                    if b < 2 * O:
                        d = g.deltas[b >> 1]
                        marks.add(v - d if b & 1 else v + d)
                    else:
                        hub_next = True
        hub = None
        if hub_in:
            offers = [(cur[v] ^ g.bobs[k][v], k * V + v) for v in members
                      for k in range(g.KB) if (sat[v] >> (2 * O + k)) & 1]
            best = min(offers, default=(BIG, 0))[0]
            if (best >> L) < (hv >> L):
                key = min(key for val, key in offers if val == best)
                k, v = divmod(key, V)
                hub = (best, [cc[c][v] ^ g.ctab[c][O + k][v]
                              for c in range(NC)])
                marks.update(v for v in members if sat[v] >> (2 * O))
        for v, lab in new.items():
            cur[v] = lab
            for c in range(NC):
                cc[c][v] = new_c[v][c]
        if hub is not None:
            cur[bn] = hub[0]
            for c in range(NC):
                cc[c][bn] = hub[1][c]
        frontier, hub_in = marks, hub_next
    return sweeps


def _model_shot(g, defect, batch_active=False):
    """K1's schedule on one shot: (packed, act, chunk words, stats).
    ``batch_active``: some shot of the batch has a defect. The plain
    version's round loop is batch-wide, so on a graph with edges of weight
    0 a shot without defects still runs the first round, whose growth step
    saturates them."""
    O, V, L, bn = g.O, g.V, g.L, g.V - 1
    cur = [v << L for v in range(V)]
    act = [0] * V
    sat = [0] * V
    sup = [[0] * V for _ in range(O + g.KB)]
    cc = [[0] * V for _ in g.ctab]
    members = [v for v in range(bn) if defect[v]]
    defects = list(members)
    for v in defects:
        act[v] = 1
    stats = {"live": [], "sweeps": []}
    presat = any(w == 0 and m for ws, ms in ((g.ewt, g.emask),
                                             (g.bwt, g.bmask))
                 for wr, mr in zip(ws, ms) for w, m in zip(wr, mr))
    active = bool(defects) or (presat and batch_active)
    hub_in, rnd = False, 0
    while active and rnd < g.max_rounds:
        marks = set()
        if rnd == 0:  # edges of weight <= 0: saturated from the start
            for o, d in enumerate(g.deltas):
                for v in range(V):
                    if g.emask[o][v] and g.ewt[o][v] == 0:
                        sat[v] |= 1 << (2 * o)
                        sat[v + d] |= 1 << (2 * o + 1)
                        marks.update((v, v + d))
            for k in range(g.KB):
                for v in range(V):
                    if g.bmask[k][v] and g.bwt[k][v] == 0:
                        sat[v] |= 1 << (2 * O + k)
                        marks.add(v)
                        hub_in = True
        grew, hub_new = _growth(g, cur, act, sat, sup, members, marks)
        hub_in = hub_in or hub_new
        known = set(members)
        members += sorted(marks - known)
        stats["sweeps"].append(_propagate(g, cur, cc, sat, members, marks,
                                          hub_in))
        hub_in = False
        cnt = set()
        for v in defects:
            cnt ^= {cur[v] >> L}
        broot = cur[bn] >> L
        any_act = False
        for v in members:
            r = cur[v] >> L
            act[v] = int(r in cnt and r != broot)
            any_act |= bool(act[v])
        stats["live"].append(len(members))
        active = any_act and grew
        rnd += 1
    return cur, act, cc, stats


@lru_cache(maxsize=None)
def _fused_d5(p):
    code = rotated_surface(5)
    raw = code.raw_parity_check_c2
    g = circuit_level_graph(raw, extraction_gate_list(code, raw), 5,
                            p_gate2=p, p_meas=p,
                            logicals=code.z_operator_matrix())
    return g, tdu.build_device_graph(g)


@lru_cache(maxsize=None)
def _window_d11():
    code = rotated_surface(11)
    dec = DeviceStreamingDecoder(code.raw_parity_check_c2,
                                 code.z_operator_matrix(), window=8,
                                 commit=4, p_space=0.004, p_time=0.004,
                                 device="cpu")
    return dec._mid


def _defects(dg, B, p, seed):
    rng = np.random.default_rng(seed)
    dets = torch.as_tensor(
        (rng.random((B, dg.num_nodes)) < p).astype(np.uint8))
    return tdu.stencil_defect(dg, dets)


def _hold(dg, defect):
    """The model against `_stencil_plain` on every shot; returns the stats."""
    g = _Graph(dg)
    packed, act, chunks = tdu._stencil_plain(dg, defect)
    live, sweeps = [], []
    batch_active = bool(defect.any())
    for b, row in enumerate(defect.tolist()):
        cur, a, cc, stats = _model_shot(g, row, batch_active)
        assert cur == packed[b].tolist(), f"labels differ on shot {b}"
        assert a == act[b].tolist(), f"activity differs on shot {b}"
        for c, plane in enumerate(chunks):
            assert cc[c] == plane[b].tolist(), f"chunk {c} differs, shot {b}"
        live += stats["live"]
        sweeps += stats["sweeps"]
    return live, sweeps


@pytest.mark.parametrize("p_graph,p_dets,seed", [(1e-2, 0.03, 0),
                                                 (1e-2, 0.12, 1)])
def test_list_schedule_equals_plain_on_the_fused_graph(p_graph, p_dets,
                                                       seed):
    _, dg = _fused_d5(p_graph)
    defect = _defects(dg, 300, p_dets, seed)
    defect[0] = 0  # a shot without defects
    defect[1] = 0
    defect[1, 7] = 1  # a single defect
    live, sweeps = _hold(dg, defect)
    V = dg.num_nodes + 1
    assert max(live) < V and max(sweeps) >= 2


def test_list_schedule_equals_plain_on_the_d11_window_graph():
    mid = _window_d11()
    assert len(mid.stencil.chunks) == 2
    defect = _defects(mid, 200, 0.02, 2)
    live, _ = _hold(mid, defect)
    # the lists stay a small share of the graph at this noise
    assert np.mean(live) < 0.25 * (mid.num_nodes + 1)


def test_list_schedule_with_zero_weights():
    # edges of weight 0 (here every fourth) saturate without growing
    _, dg = _fused_d5(1e-2)
    st = dg.stencil
    ewt = st.ewt.clone()
    ewt[:, ::4] = 0
    bwt = st.bwt.clone()
    bwt[:, 1::5] = 0
    dg0 = dg._replace(stencil=st._replace(ewt=ewt, bwt=bwt))
    assert dg0.stencil.kernel_words(dg0.pack_shift)[2]  # presat
    _hold(dg0, _defects(dg0, 100, 0.03, 3))


def _round_states(dg, defect, rounds):
    """(packed, act, sup, supb) entering the first growth rounds of
    `device_uf._stencil_rounds`."""
    st = dg.stencil
    B, V = defect.shape
    packed = tdu.initial_labels(dg, B, "cpu")
    sup = torch.zeros((B, len(st.deltas), V), dtype=torch.int32)
    supb = torch.zeros((B, st.bmask.shape[0], V), dtype=torch.int32)
    vals = tuple(torch.zeros_like(defect) for _ in st.chunks)
    act = defect
    for _ in range(rounds):
        yield packed, act, sup, supb
        sup, supb, _ = tdu._grow_step(dg, packed, act, sup, supb)
        satm, satb = tdu._saturated(dg, sup, supb)
        packed, vals, _ = tdu._propagate(dg, packed, satm, satb, vals)
        act, _ = tdu._spread(dg, tdu.parity_seeds(dg, packed, defect),
                             tdu._cluster_passes(dg, packed, satm))


def _sat_words(g, satm, satb, b):
    """Shot b's saturation masks as the kernel's sat words."""
    sat = [0] * g.V
    for o, d in enumerate(g.deltas):
        for v in satm[b, o].nonzero().flatten().tolist():
            sat[v] |= 1 << (2 * o)
            sat[v + d] |= 1 << (2 * o + 1)
    for k in range(g.KB):
        for v in satb[b, k].nonzero().flatten().tolist():
            sat[v] |= 1 << (2 * g.O + k)
    return sat


@pytest.mark.parametrize("which", ["fused", "window"])
def test_growth_over_active_edges_equals_grow_step(which):
    dg = _fused_d5(1e-2)[1] if which == "fused" else _window_d11()
    g = _Graph(dg)
    wt = torch.cat([dg.stencil.ewt, dg.stencil.bwt])
    defect = _defects(dg, 64, 0.04, 4)
    for packed, act, sup, supb in _round_states(dg, defect, 3):
        sup1, supb1, grew = tdu._grow_step(dg, packed, act, sup, supb)
        before = tdu._saturated(dg, sup, supb)
        after = tdu._saturated(dg, sup1, supb1)
        want_sup = torch.minimum(torch.cat([sup1, supb1], dim=1), wt)
        for b in range(defect.shape[0]):
            sat = _sat_words(g, *before, b)
            sat0 = list(sat)
            sup_m = torch.minimum(torch.cat([sup[b], supb[b]]), wt).tolist()
            members = [v for v in range(g.V) if sat[v] or act[b, v]]
            marks = set()
            grew_m, _ = _growth(g, packed[b].tolist(), act[b].tolist(), sat,
                                sup_m, members, marks)
            assert sup_m == want_sup[b].tolist()
            assert grew_m == bool(grew[b].any())
            assert sat == _sat_words(g, *after, b)
            # the first frontier: the ends of the newly saturated edges
            assert marks == {v for v in range(g.V) if sat[v] != sat0[v]}
