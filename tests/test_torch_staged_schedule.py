"""The schedules of the staged stencil kernels K3 (label propagation), K4
(the activity spread) and K5 (one growth round) in
qcss_tpu_torch/csrc/uf_stencil_staged.cu, modelled in plain Python on the
CPU and held against the plain versions they must equal bit for bit
(`device_uf._prop_plain`, `_act_plain`, `_round_plain`).

Both kernels run a warp a shot over lists, as K1 does
(tests/test_torch_stencil_schedule.py), but take whole states: the input
masks or supports are folded into sat words (bit 2o the edge to v + d_o,
2o+1 the edge to v - d_o, 2O+k slot k; a saturated edge with no vertex at
v + d_o is dropped), the members are every vertex with a sat bit (and
K5's seeds), and because nothing says the input labels are a fixpoint of
the input saturation, the first Jacobi sweep visits every member; later
sweeps the frontier. K5 spreads activity over the members in place, grows
the active members' edges (an edge with both ends active from its low
end) by the shot's slack, unclamped, and records `grew` at each grown
edge's low end. K4 folds its pass bytes into pass words the same way
(bits 2o and 2o+1; a pass with no vertex at v + d_o dropped), takes every
nonzero act word as a seed and spreads breadth first from the seeds, a
frontier list a step. The models follow the kernels step by step; change
the kernel and its model together.

The states are those entering growth rounds 1-4 of the d=5 DEM decode,
and states drawn with numpy under fixed seeds that hit the traps: labels
not at a fixpoint (and a Gauss-Seidel sweep, which would differ), supports
at weight + 1 and past it, zero and negative weights, weights past the
narrow word, and a saturated slot that gives the hub the lowest comp;
K4's traps are passes past the last vertex, act values 2 and -1, all or
no vertex active, no passes, and every edge passing.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

from qcss_tpu_torch.codes.families import rotated_surface
from qcss_tpu_torch.decode import device_uf as tdu
from qcss_tpu_torch.decode.dem import circuit_level_graph, extraction_gate_list
from qcss_tpu_torch.decode.device_uf_staged import round_inputs

BIG = 1 << 30


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # several worker processes run at once; see test_torch_device_uf.py
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Graph:
    """The stencil tables as Python lists, exact as K3 and K5 read them."""

    def __init__(self, dg):
        st = dg.stencil
        self.L = dg.pack_shift
        self.V = dg.num_nodes + 1
        self.deltas = list(st.deltas)
        self.O = len(self.deltas)
        self.KB = st.bmask.shape[0]
        # rows 0..O-1 the edges, O..O+KB-1 the slots
        self.mask = st.emask.tolist() + st.bmask.tolist()
        self.wt = st.ewt.tolist() + st.bwt.tolist()
        self.obs = st.eobs.tolist() + st.bobs.tolist()


def _propagate(g, cur, sat, members, gauss_seidel=False):
    """Jacobi sweeps, the first over every member, then over the frontier
    the sweep before marked, until nothing changes. Returns the sweeps.
    ``gauss_seidel`` reads labels written in the same sweep (the wrong
    schedule, kept to show that it differs)."""
    O, V, L, bn = g.O, g.V, g.L, g.V - 1
    frontier, hub_in, sweeps = list(members), True, 0
    while frontier or hub_in:
        sweeps += 1
        hv = cur[bn]
        prev = list(cur)
        src = cur if gauss_seidel else prev
        new = {}
        for v in frontier:
            cand = BIG
            for b in range(2 * O + g.KB):
                if not (sat[v] >> b) & 1:
                    continue
                if b < 2 * O:
                    o, d = b >> 1, g.deltas[b >> 1]
                    c = (src[v - d] ^ g.obs[o][v - d] if b & 1
                         else src[v + d] ^ g.obs[o][v])
                else:
                    c = hv ^ g.obs[O + b - 2 * O][v]
                cand = min(cand, c)
            new[v] = cand if (cand >> L) < (src[v] >> L) else src[v]
            if gauss_seidel:
                cur[v] = new[v]
        if hub_in:
            offers = [src[v] ^ g.obs[O + k][v] for v in members
                      for k in range(g.KB) if (sat[v] >> (2 * O + k)) & 1]
            best = min(offers, default=BIG)
            if (best >> L) < (hv >> L):
                new[bn] = best  # wins over the hub's own candidates
        marks, hub_next, bn_changed = set(), False, False
        for v, lab in new.items():
            if lab == prev[v]:
                continue
            cur[v] = lab
            for b in range(2 * O):
                if (sat[v] >> b) & 1:
                    d = g.deltas[b >> 1]
                    marks.add(v - d if b & 1 else v + d)
            hub_next |= bool(sat[v] >> (2 * O))
            bn_changed |= v == bn
        if bn_changed:  # the hub's label reaches every slot holder
            marks.update(v for v in members if sat[v] >> (2 * O))
            if sat[bn]:  # its slots' minimum may have beaten its own
                marks.add(bn)
        frontier, hub_in = sorted(marks), hub_next or bn_changed
    return sweeps


def _sat_from_masks(g, satm_rows, satb_rows):
    """K3's fold: the mask bytes as sat words; members ascending."""
    O, V = g.O, g.V
    sat = [0] * V
    for o, d in enumerate(g.deltas):
        for v in range(V):
            if satm_rows[o][v] and v + d < V:
                sat[v] |= 1 << (2 * o)
                sat[v + d] |= 1 << (2 * o + 1)
    for k in range(g.KB):
        for v in range(V):
            if satb_rows[k][v]:
                sat[v] |= 1 << (2 * O + k)
    return sat


def _model_prop(g, packed_row, satm_rows, satb_rows, gauss_seidel=False):
    """K3 on one shot: the labels at the fixpoint, and the sweeps."""
    cur = list(packed_row)
    sat = _sat_from_masks(g, satm_rows, satb_rows)
    members = [v for v in range(g.V) if sat[v]]
    sweeps = _propagate(g, cur, sat, members, gauss_seidel)
    return cur, sweeps


def _model_round(g, packed_row, seed_row, sup_rows):
    """K5 on one shot: (labels, supports out, grew row, stats)."""
    O, V, L, bn = g.O, g.V, g.L, g.V - 1
    cur = list(packed_row)
    sup_out = [list(r) for r in sup_rows]
    act = [int(x != 0) for x in seed_row]
    # -- the supports stream through; their saturation folds into sat
    sat = [0] * V
    for r in range(O + g.KB):
        for v in range(V):
            if not g.mask[r][v] or sup_rows[r][v] < g.wt[r][v]:
                continue
            if r >= O:
                sat[v] |= 1 << (2 * O + r - O)
            elif v + g.deltas[r] < V:
                sat[v] |= 1 << (2 * r)
                sat[v + g.deltas[r]] |= 1 << (2 * r + 1)
    members = [v for v in range(V) if sat[v] or act[v]]
    # -- activity over the members, in place, until a sweep changes nothing
    changed = True
    while changed:
        changed = False
        for u in members:
            if act[u]:
                continue
            for b in range(2 * O):
                if (sat[u] >> b) & 1:
                    d = g.deltas[b >> 1]
                    w = u - d if b & 1 else u + d
                    if act[w] and cur[w] >> L == cur[u] >> L:
                        act[u], changed = 1, True
                        break
    # -- growth over the active members (pass 1: the edges and the slack)
    hub_comp = cur[bn] >> L
    grow = []  # (row, low end, inc)
    for u in members:
        if not act[u]:
            continue
        cu = cur[u] >> L
        for o, d in enumerate(g.deltas):
            up_in = u + d < V
            cp = cur[u + d] >> L if up_in else -1
            if (g.mask[o][u] and not (sat[u] >> (2 * o)) & 1
                    and sup_rows[o][u] < g.wt[o][u] and cu != cp):
                grow.append((o, u, 1 + (act[u + d] if up_in else 0)))
            q = u - d
            if (q >= 0 and not act[q] and g.mask[o][q]
                    and not (sat[u] >> (2 * o + 1)) & 1
                    and sup_rows[o][q] < g.wt[o][q] and cu != cur[q] >> L):
                grow.append((o, q, 1))
        for k in range(g.KB):
            r = O + k
            if (g.mask[r][u] and not (sat[u] >> (2 * O + k)) & 1
                    and sup_rows[r][u] < g.wt[r][u] and cu != hub_comp):
                grow.append((r, u, 1))
    slack = min((-(-(g.wt[r][v] - sup_rows[r][v]) // inc)
                 for r, v, inc in grow), default=BIG)
    delta = max(slack, 1)
    if delta >= BIG:
        delta = 1
    # -- pass 2: grow, unclamped; newly saturated ends join the members
    grew = [0] * V
    fresh = set()
    for r, v, inc in grow:
        s = sup_rows[r][v] + inc * delta
        sup_out[r][v] = s
        grew[v] = 1
        if s < g.wt[r][v]:
            continue
        if r >= O:
            sat[v] |= 1 << (2 * O + r - O)
            fresh.add(v)
        elif v + g.deltas[r] < V:
            d = g.deltas[r]
            sat[v] |= 1 << (2 * r)
            sat[v + d] |= 1 << (2 * r + 1)
            fresh.update((v, v + d))
    members += sorted(fresh - set(members))
    sweeps = _propagate(g, cur, sat, members)
    return cur, sup_out, grew, {"members": len(members),
                                "active": sum(act), "sweeps": sweeps}


def _model_act(g, act_row, pass_rows):
    """K4 on one shot: (act row out, 0/1; stats)."""
    O, V = g.O, g.V
    act = [int(x != 0) for x in act_row]  # every nonzero word a seed
    # -- the pass bytes fold into pass words
    pw = [0] * V
    for o, d in enumerate(g.deltas):
        for v in range(V):
            if pass_rows[o][v] and v + d < V:
                pw[v] |= 1 << (2 * o)
                pw[v + d] |= 1 << (2 * o + 1)
    # -- the spread, a frontier a step from the seeds: each inactive end
    #    of a frontier vertex's passing edge is claimed once
    frontier = [v for v in range(V) if act[v]]
    steps = 0
    while frontier:
        steps += 1
        fresh = set()
        for u in frontier:
            for b in range(2 * O):
                if (pw[u] >> b) & 1:
                    d = g.deltas[b >> 1]
                    w = u - d if b & 1 else u + d
                    if not act[w]:
                        act[w] = 1
                        fresh.add(w)
        frontier = sorted(fresh)
    return act, {"steps": steps}


@lru_cache(maxsize=None)
def _dem_d5():
    code = rotated_surface(5)
    raw = code.raw_parity_check_c2
    g = circuit_level_graph(raw, extraction_gate_list(code, raw), 5,
                            p_gate2=1e-2, p_meas=1e-2,
                            logicals=code.z_operator_matrix())
    return tdu.build_device_graph(g)


def _hold_round(dg, packed, seed, sup):
    """The K5 model against `_round_plain` on every shot; the stats."""
    g = _Graph(dg)
    O = g.O
    ref = tdu._round_plain(dg, packed, seed, sup[:, :O], sup[:, O:])
    ref_sup = torch.cat([ref[1], ref[2]], dim=1)
    stats = []
    for b in range(packed.shape[0]):
        cur, sup_out, grew, st = _model_round(
            g, packed[b].tolist(), seed[b].tolist(), sup[b].tolist())
        assert cur == ref[0][b].tolist(), f"K5 labels differ on shot {b}"
        assert sup_out == ref_sup[b].tolist(), f"K5 supports, shot {b}"
        assert grew == ref[3][b].tolist(), f"K5 grew differs on shot {b}"
        stats.append(st)
    return ref, stats


def _hold_act(dg, act, passes):
    """The K4 model against `_act_plain` on every shot; the stats."""
    g = _Graph(dg)
    ref = tdu._act_plain(dg, act, passes)
    stats = []
    for b in range(act.shape[0]):
        out, st = _model_act(g, act[b].tolist(), passes[b].tolist())
        assert out == ref[b].tolist(), f"K4 act differs on shot {b}"
        stats.append(st)
    return ref, stats


def _hold_prop(dg, packed, satm, satb):
    """The K3 model against `_prop_plain` on every shot; the sweeps."""
    g = _Graph(dg)
    ref = tdu._prop_plain(dg, packed, satm, satb)
    sweeps = []
    for b in range(packed.shape[0]):
        cur, n = _model_prop(g, packed[b].tolist(), satm[b].tolist(),
                             satb[b].tolist())
        assert cur == ref[b].tolist(), f"K3 labels differ on shot {b}"
        sweeps.append(n)
    return ref, sweeps


def test_schedules_equal_plain_on_the_dem_rounds():
    # the states entering rounds 1-4 of the d=5 DEM decode; K3 on each
    # round's saturation after its growth step (as the staged decode
    # calls it), on the labels that entered the round
    dg = _dem_d5()
    rng = np.random.default_rng(3)
    dets = torch.as_tensor((rng.random((24, dg.num_nodes)) < 0.05)
                           .astype(np.uint8))
    defect = tdu.stencil_defect(dg, dets)
    defect[0] = 0  # a shot without defects
    O = len(dg.stencil.deltas)
    adopted = grew_any = spread = False
    for s in round_inputs(dg, defect, 4):
        packed, seed, sup = s["packed"], s["seed"], s["sup"]
        ref, stats = _hold_round(dg, packed, seed, sup)
        grew_any |= bool(ref[3].any())
        act, _ = _hold_act(dg, seed, s["passes"])
        spread |= bool((act != (seed != 0)).any())
        satm, satb = tdu._saturated(dg, ref[1], ref[2])
        out, _ = _hold_prop(dg, packed, satm, satb)
        adopted |= not torch.equal(out, packed)
        assert max(s["members"] for s in stats) < dg.num_nodes + 1
    assert adopted and grew_any and spread


def _trap_graph(change):
    dg = _dem_d5()
    st = dg.stencil
    ewt, bwt = st.ewt.clone(), st.bwt.clone()
    if change == "zero and negative weights":
        ewt[:, ::4] = 0
        ewt[:, 2::9] = -3
        bwt[:, 1::5] = 0
    elif change == "weights past the narrow word":
        ewt[:, ::5] = 300
        bwt = bwt * 2 + 255
    return dg._replace(stencil=st._replace(ewt=ewt, bwt=bwt))


def _trap_state(dg, B, seed):
    """A whole state drawn with numpy: labels not at a fixpoint (comps
    and lanes at random), supports spread over [-1, weight + 2], seeds at
    1 or other nonzero values, the K3 masks at random (slots and edges,
    edges into the hub among them), in every fourth shot a slot holder
    with comp 0 (the hub's lowest offer), and in shot 1 a hub whose slot
    beats its current label but not its own edge."""
    rng = np.random.default_rng(seed)
    st = dg.stencil
    V = dg.num_nodes + 1
    L = dg.pack_shift
    O, KB = len(st.deltas), st.bmask.shape[0]
    comp = rng.integers(0, V, (B, V))
    lanes = rng.integers(0, 1 << L, (B, V))
    packed = (comp << L) | lanes
    packed[:, V - 1] = (V - 1) << L  # the hub's own label
    wt = torch.cat([st.ewt, st.bwt]).numpy()
    sup = (rng.random((B, O + KB, V)) * (np.maximum(wt, 0) + 4)).astype(
        np.int64) - 1
    seed_p = np.where(rng.random((B, V)) < 0.08,
                      rng.integers(1, 4, (B, V)), 0)
    satm = rng.random((B, O, V)) < 0.2
    satb = rng.random((B, KB, V)) < 0.1
    for o, d in enumerate(st.deltas):  # K3's hub with saturated edges
        satm[:, o, V - 1 - d] |= rng.random(B) < 0.5
    bmask = st.bmask.numpy()
    for b in range(0, B, 4):
        holders = np.flatnonzero(bmask.any(axis=0))
        v = int(rng.choice(holders))
        k = int(np.flatnonzero(bmask[:, v])[0])
        packed[b, v] = lanes[b, v]  # comp 0
        sup[b, O + k, v] = wt[O + k, v]  # the slot saturated
        satb[b, k, v] = True
    # shot 1: the hub's own edge offers comp 0 while its one slot offers
    # comp 1; the slot's minimum wins the first sweep (it overrides the
    # hub's own candidates), so the hub must weigh its edge again
    u, w = V - 1 - st.deltas[0], int(np.flatnonzero(bmask[0])[0])
    satm[1], satb[1] = False, False
    satm[1, 0, u] = satb[1, 0, w] = True
    packed[1, u], packed[1, w] = lanes[1, u], (1 << L) | lanes[1, w]
    as_t = lambda a: torch.as_tensor(a.astype(np.int32))  # noqa: E731
    return (as_t(packed), as_t(seed_p), as_t(sup), torch.as_tensor(satm),
            torch.as_tensor(satb))


@pytest.mark.parametrize("change", ["none", "zero and negative weights",
                                    "weights past the narrow word"])
def test_schedules_equal_plain_on_trap_states(change):
    dg = _trap_graph(change)
    g = _Graph(dg)
    packed, seed, sup, satm, satb = _trap_state(dg, 12, seed=17)
    ref, stats = _hold_round(dg, packed, seed, sup)
    _, sweeps = _hold_prop(dg, packed, satm, satb)
    # the traps were hit: supports past the weight came out, the hub
    # adopted, and labels moved in the first sweep (not a fixpoint)
    wt = torch.cat([dg.stencil.ewt, dg.stencil.bwt])
    mask = torch.cat([dg.stencil.emask, dg.stencil.bmask])
    assert bool(((ref[1] > dg.stencil.ewt) & dg.stencil.emask).any()
                | ((ref[2] > dg.stencil.bwt) & dg.stencil.bmask).any())
    bn = dg.num_nodes
    hub_k3 = tdu._prop_plain(dg, packed, satm, satb)[::4, bn] >> g.L
    assert bool((ref[0][::4, bn] >> g.L == 0).all() & (hub_k3 == 0).all())
    assert max(sweeps) >= 2
    if change == "weights past the narrow word":
        assert int(wt[mask].max()) > 255
    if change == "zero and negative weights":
        assert int(wt[mask].min()) < 0


def test_gauss_seidel_sweeps_would_differ():
    # a label read in the sweep that wrote it changes which path delivers
    # the minimum comp, and with it the lane bits: the Jacobi model equals
    # the plain version, the Gauss-Seidel one does not
    dg = _dem_d5()
    g = _Graph(dg)
    packed, _, _, satm, satb = _trap_state(dg, 24, seed=5)
    ref = tdu._prop_plain(dg, packed, satm, satb)
    differs = 0
    for b in range(packed.shape[0]):
        args = (g, packed[b].tolist(), satm[b].tolist(), satb[b].tolist())
        assert _model_prop(*args)[0] == ref[b].tolist()
        differs += _model_prop(*args, gauss_seidel=True)[0] \
            != ref[b].tolist()
    assert differs > 0


def _act_trap(dg, trap, B, seed):
    """K4's input drawn with numpy for one trap: act [B, V] int32, passes
    [B, O, V] bool."""
    rng = np.random.default_rng(seed)
    V = dg.num_nodes + 1
    deltas = dg.stencil.deltas
    O = len(deltas)
    act = np.where(rng.random((B, V)) < 0.05, 1, 0)
    passes = rng.random((B, O, V)) < 0.12
    if trap == "passes past the last vertex":
        for o, d in enumerate(deltas):
            passes[:, o, V - d:] = True
    elif trap == "act values 2 and -1":
        act = np.where(rng.random((B, V)) < 0.06,
                       rng.choice([2, -1, 7], (B, V)), 0)
    elif trap == "all active":
        act = rng.choice([1, 2, -1], (B, V))
    elif trap == "none active":
        act[:] = 0
    elif trap == "no passes":
        passes[:] = False
    elif trap == "every edge passing":
        passes[:] = True
        act[:] = 0
        act[::2, 0] = 1  # one seed a shot, at an end of the row
        act[1::2, V - 1] = 1
    return (torch.as_tensor(act.astype(np.int32)),
            torch.as_tensor(passes))


@pytest.mark.parametrize("trap", [
    "passes past the last vertex", "act values 2 and -1", "all active",
    "none active", "no passes", "every edge passing"])
def test_act_schedule_equals_plain_on_trap_states(trap):
    dg = _dem_d5()
    V = dg.num_nodes + 1
    act, passes = _act_trap(dg, trap, 16, seed=31)
    ref, stats = _hold_act(dg, act, passes)
    assert set(ref.unique().tolist()) <= {0, 1}
    steps = [s["steps"] for s in stats]
    if trap == "act values 2 and -1":
        assert bool(((act != 0) & (act != 1)).any())
    if trap in ("all active", "none active", "no passes"):
        # nothing to spread: the output is act != 0
        assert torch.equal(ref, (act != 0).to(torch.int32))
    if trap == "every edge passing":
        # one seed at an end reaches every vertex, at most max(d)
        # vertices further a frontier step
        assert bool((ref == 1).all())
        assert min(steps) >= (V - 1) // max(dg.stencil.deltas)
    if trap == "passes past the last vertex":
        # the edges past the last vertex are dropped, not wrapped
        assert bool(passes[:, :, V - 1].all())
