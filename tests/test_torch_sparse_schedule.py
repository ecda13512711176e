"""The schedule of the sparse growth kernel (K2,
qcss_tpu_torch/csrc/sparse_growth.cu), modelled in numpy on the CPU and
held against its plain version, `device_sparse._sparse_plain`, bit for
bit (obs and converged).

The kernel runs a warp a shot. Lane L owns slots L and L + 32; a value of
slot j reaches every lane by __shfl_sync from lane j & 31, register j >> 5.
The model keeps each per-slot register as a [32] array a register and
reads other slots only that way:

* compaction: a ragged head of bytes (one a lane), 16-byte loads of 16
  detectors a lane (each at a 16-byte aligned address), a ragged tail;
  fired bits ranked by a shuffle scan of the lanes' popcounts, the first D
  listed; every byte of the row is read once, whatever the row's address;
* distances gathered into shared memory transposed at stride D, 32-bit,
  and read a column at a time: the 32 lanes' reads of a column fall in
  distinct banks;
* saturation masks: one pass over the distances, then after each growth
  the event search's mask of the pairs at its minimum step, ORed in when
  that minimum is the delta (the model asserts the masks equal a fresh
  pass every time); component sweeps: Jacobi, each label the minimum over
  the mask's set bits read by shuffle, pointer jump by a shuffle from lane
  new & 31 of register new >> 5;
* cluster statistics: __match_any_sync(root) with popcounts (n <= 32),
  and with two slots a lane the masks from the six ballots of each label
  register's bits; the event delta and each odd boundary cluster's
  (bdist, slot)-minimal member by __reduce_min_sync;
* the dynamic shot queue: a warp takes a shot from a counter at the
  start and the next one each time it starts a shot (fetched while the
  shot runs); every shot is decoded once, by whichever warp, with the
  same result.

`_plan` mirrors `plan_k2` (and `warp_bytes`); the card tests
(tests/test_torch_cuda.py) hold it against `device_sparse_cuda.launch_plan`.
"""

import heapq

import numpy as np
import pytest
import torch

from qcss_tpu_torch.codes.families import rotated_surface
from qcss_tpu_torch.decode import device_sparse as tds
from qcss_tpu_torch.decode.dem import circuit_level_graph, extraction_gate_list

UNREACH = 1 << 21
MAX_D = 64
WARPS = 4
GATHER = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # several worker processes run at once; see test_torch_device_uf.py
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _warp_bytes(D):
    return 4 * MAX_D + (D * D * 4 + 15) // 16 * 16


def _plan(D):
    """(shots a block, threads, shared bytes) as `plan_k2` lays out a
    launch."""
    return WARPS, 32 * WARPS, WARPS * _warp_bytes(D)


LANES = np.arange(32)


def _slot(reg0, reg1, j):
    """slot_val: the value of slot j, by shuffle from lane j & 31 of
    register j >> 5."""
    return (reg0 if j < 32 else reg1)[j & 31]


def _incl_add(v):
    v = v.copy()
    for o in (1, 2, 4, 8, 16):
        old = v.copy()
        v[o:] = old[o:] + old[:-o]
    return v


def _emit(bits, base, carry, D, sv):
    """emit(): rank the lanes' bits after ``carry`` earlier ones."""
    c = np.array([bin(int(b)).count("1") for b in bits])
    incl = _incl_add(c)
    for lane in range(32):
        rank = carry + incl[lane] - c[lane]
        b = int(bits[lane])
        while b:
            k = (b & -b).bit_length() - 1
            b &= b - 1
            if rank < D:
                sv[rank] = base[lane] + k
            rank += 1
    return int(incl[31])


def _compact(mem, start, V, D):
    """The fired detectors of the row at mem[start:start + V] (mem's index
    0 is 16-byte aligned): (count, slot list)."""
    reads = np.zeros(V, np.int64)
    sv = [0] * D
    mis = start & 15
    head = min(V, (16 - mis) & 15)
    body = (V - head) >> 4
    tail0 = head + 16 * body

    def byte(k):
        reads[k] += 1
        return int(mem[start + k]) & 1

    bits = [byte(lane) if lane < head else 0 for lane in range(32)]
    count = _emit(bits, LANES, 0, D, sv)
    for c0 in range(0, body, 32):
        bits = [0] * 32
        for lane in range(32):
            c = c0 + lane
            if c < body:
                assert (start + head + 16 * c) % 16 == 0
                bits[lane] = sum(byte(head + 16 * c + k) << k
                                 for k in range(16))
        count += _emit(bits, head + 16 * (c0 + LANES), count, D, sv)
    bits = [byte(tail0 + lane) if tail0 + lane < V else 0
            for lane in range(32)]
    count += _emit(bits, tail0 + LANES, count, D, sv)
    assert (reads == 1).all()
    return count, sv


class _Dm:
    """The shot's distances in shared memory, transposed: entry (i, j) at
    word [j * D + i]."""

    def __init__(self, D):
        self.D = D
        self.mem = np.zeros(D * D, np.int64)

    def put(self, i, j, v):
        assert -2**31 <= v < 2**31
        self.mem[j * self.D + i] = v

    def column(self, j, slots, valid):
        """The reads of column j by the lanes whose slot (one register) is
        filled; UNREACH elsewhere. No two lanes in one bank."""
        addr = j * self.D + slots[valid]
        assert len(set(addr % 32)) == len(addr)
        v = np.full(32, UNREACH, np.int64)
        v[valid] = self.mem[addr]
        return v


def _ballot(pred):
    return int(sum(1 << int(lane) for lane in np.nonzero(pred)[0]))


def _popc(v):
    return bin(int(v)).count("1")


def _shot(mem, start, V, tables, D, max_events):
    """One warp's decode of one shot: (obs, converged, work), work the
    pair tests of its distance passes (mask builds and event searches)."""
    dist, phi, bdist, bside = tables
    count, sv = _compact(mem, start, V, D)
    n = min(count, D)
    if n == 0:
        return 0, 1, 0
    s = [LANES, LANES + 32]
    v = [s[0] < n, s[1] < n]
    vi = [np.where(v[k], [sv[i] if i < n else 0 for i in s[k]], 0)
          for k in range(2)]
    bdm = [np.where(v[k], bdist[vi[k]], UNREACH) for k in range(2)]
    ph = [np.where(v[k], phi[vi[k]], 0) for k in range(2)]
    bs = [np.where(v[k], bside[vi[k]], 0) for k in range(2)]
    dm = _Dm(D)
    for j0 in range(0, n, GATHER):  # kGather loads in flight a lane
        for j in range(j0, min(n, j0 + GATHER)):
            for k in range(2):
                for lane in np.nonzero(v[k])[0]:
                    i = s[k][lane]
                    dm.put(i, j, UNREACH if i == j
                           else int(dist[vi[k][lane], sv[j]]))
    r = [np.zeros(32, np.int64), np.zeros(32, np.int64)]
    root = [s[0].copy(), s[1].copy()]
    work = [0]
    nk = 2 if n > 32 else 1  # slot registers in use

    def saturation():
        """One pass of the distances: bit j of sat[k][lane] is
        r_i + r_j >= dm_ij for slot i = lane + 32 k."""
        sat = [[0] * 32, [0] * 32]
        for j in range(n):
            rj = _slot(*r, j)
            for k in range(nk):
                on = v[k] & (r[k] + rj >= dm.column(j, s[k], v[k]))
                for lane in np.nonzero(on)[0]:
                    sat[k][lane] |= 1 << j
        work[0] += n * n
        return sat

    sat = saturation()

    def components():
        while True:
            via = [np.full(32, D), np.full(32, D)]
            for k in range(nk):
                for lane in range(32):
                    m = sat[k][lane]  # next_label: its set bits, by shuffle
                    while m:
                        j = (m & -m).bit_length() - 1
                        m &= m - 1
                        via[k][lane] = min(via[k][lane], _slot(*root, j))
            new = [np.minimum(root[k], via[k]) for k in range(2)]
            nr = []
            for k in range(2):  # shuffle from lane new & 31, reg new >> 5
                src = new[k] & 31
                nr.append(np.where(new[k] < 32, new[0][src], new[1][src]))
            changed = (v[0] & (nr[0] != root[0])).any() \
                | (v[1] & (nr[1] != root[1])).any()
            for k in range(2):
                root[k] = np.where(v[k], nr[k], root[k])
            if not changed:
                return

    def stats():
        sat_b = [_ballot(v[k] & (r[k] >= bdm[k])) for k in range(2)]
        if n <= 32:
            key = np.where(v[0], root[0], MAX_D + LANES)
            m = [_ballot(key == key[lane]) for lane in range(32)]
            cnt0 = np.array([_popc(x) for x in m])
            bt0 = np.array([(x & sat_b[0]) != 0 for x in m])
            return [cnt0, np.zeros(32, np.int64)], [bt0, np.zeros(32, bool)]
        val = [_ballot(v[k]) for k in range(2)]
        bits = [[_ballot((root[k] >> b) & 1) for b in range(6)]
                for k in range(2)]

        def label_mask(k, a):
            m = val[k]
            for b in range(6):
                m &= bits[k][b] if (a >> b) & 1 else ~bits[k][b]
            return m

        cnt, bt = [], []
        for k in range(2):
            m0 = [label_mask(0, int(a)) for a in root[k]]
            m1 = [label_mask(1, int(a)) for a in root[k]]
            cnt.append(np.array([_popc(a) + _popc(b) for a, b in zip(m0, m1)]))
            bt.append(np.array([((a & sat_b[0]) | (b & sat_b[1])) != 0
                                for a, b in zip(m0, m1)]))
        return cnt, bt

    ev = 0
    while True:
        components()
        cnt, bt = stats()
        ai = [v[k] & (cnt[k] & 1 == 1) & ~bt[k] for k in range(2)]
        loc = [np.full(32, UNREACH), np.full(32, UNREACH)]
        tie = [[0] * 32, [0] * 32]
        for j in range(n):
            rj, aj = _slot(*r, j), _slot(*ai, j)
            for k in range(nk):
                d = dm.column(j, s[k], v[k])
                rate = ai[k].astype(np.int64) + int(aj)
                need = d - r[k] - rj
                ok = v[k] & (need > 0) & (rate > 0) & (d < UNREACH)
                step = np.where(rate == 2, (need + 1) >> 1, need)
                for lane in np.nonzero(ok)[0]:
                    if step[lane] < loc[k][lane]:
                        loc[k][lane] = step[lane]
                        tie[k][lane] = 0
                    if step[lane] == loc[k][lane]:
                        tie[k][lane] |= 1 << j
        work[0] += n * n
        local = np.minimum(loc[0], loc[1])
        for k in range(2):
            ok = ai[k] & (bdm[k] - r[k] > 0) & (bdm[k] < UNREACH)
            local = np.where(ok, np.minimum(local, bdm[k] - r[k]), local)
        delta = int(local.min())  # __reduce_min_sync
        grow = bool((ai[0] | ai[1]).any()) and delta < UNREACH
        if grow:
            for k in range(2):
                r[k] = np.where(ai[k], r[k] + delta, r[k])
            if any((v[k] & (r[k] >= UNREACH // 2)).any() for k in range(2)):
                sat = saturation()
            else:  # the pairs whose step is delta saturate, and only they
                for k in range(2):
                    for lane in range(32):
                        if loc[k][lane] == delta:
                            sat[k][lane] |= tie[k][lane]
            # the masks equal a pass over the distances
            full = [list(m) for m in sat]
            assert saturation() == full
            work[0] -= n * n
        if not (grow and ev + 1 < max_events):
            break
        ev += 1
    components()
    cnt, bt = stats()
    obs = int(np.bitwise_xor.reduce(np.concatenate(ph)))
    todo = [_ballot(v[k] & (root[k] == s[k]) & (cnt[k] & 1 == 1) & bt[k])
            for k in range(2)]
    key = [np.where(v[k] & (r[k] >= bdm[k]), bdm[k], UNREACH) * D + s[k]
           for k in range(2)]
    while todo[0] | todo[1]:
        k = 0 if todo[0] else 1
        rt = 32 * k + (todo[k] & -todo[k]).bit_length() - 1
        todo[k] &= todo[k] - 1
        big = np.iinfo(np.int64).max
        mmin = int(min(np.where(v[0] & (root[0] == rt), key[0], big).min(),
                       np.where(v[1] & (root[1] == rt), key[1], big).min()))
        obs ^= int(_slot(*bs, mmin % D))
    unfinished = any((v[k] & (cnt[k] & 1 == 1) & ~bt[k]).any()
                     for k in range(2))
    return obs, int(count <= D and not unfinished), work[0]


def _launch(dets, offset, tables, D, max_events, warps=5):
    """The persistent warps over a batch whose rows start ``offset`` bytes
    past a 16-byte boundary, shots taken from a counter: (obs, converged).
    Simulated time: a shot costs its pair tests; a warp fetches its next
    index when it starts a shot."""
    B, V = dets.shape
    mem = np.zeros(offset + B * V, np.uint8)
    mem[offset:] = dets.reshape(-1)
    obs = np.full(B, -1, np.int64)
    conv = np.full(B, -1, np.int64)
    counter = 0
    heap = []
    for w in range(warps):  # each warp's first shot
        heapq.heappush(heap, (0, w, counter))
        counter += 1
    decoded = []
    while heap:
        t, w, shot = heapq.heappop(heap)
        if shot >= B:
            continue
        nxt, counter = counter, counter + 1  # in flight during the shot
        o, c, cost = _shot(mem, offset + shot * V, V, tables, D, max_events)
        assert obs[shot] == -1
        obs[shot], conv[shot] = o, c
        decoded.append(shot)
        heapq.heappush(heap, (t + 1 + cost, w, nxt))
    assert sorted(decoded) == list(range(B))
    return obs, conv.astype(bool)


def _graph(d):
    code = rotated_surface(d)
    raw = code.raw_parity_check_c2
    return circuit_level_graph(raw, extraction_gate_list(code, raw), d,
                               p_gate2=1e-2, p_meas=1e-2,
                               logicals=code.z_operator_matrix())


_G = {}


def _tables(d):
    if d not in _G:
        t = tds.build_sparse_tables(_graph(d))
        _G[d] = (tds._tables_to(t, "cpu"),
                 (t.dist.astype(np.int64), t.phi.astype(np.int64),
                  t.bdist.astype(np.int64), t.bside.astype(np.int64)))
    return _G[d]


@pytest.mark.parametrize("p,d_max,offset", [
    (0.05, 48, 0), (0.05, 8, 3), (0.2, 31, 7), (0.2, 32, 1),
    (0.5, 33, 15), (0.5, 64, 5), (0.02, 1, 9)])
def test_warp_schedule_equals_plain(p, d_max, offset):
    tables_t, tables_np = _tables(5)
    V = tables_np[0].shape[0]
    rng = np.random.default_rng(int(1000 * p) + d_max)
    dets = (rng.random((24, V)) < p).astype(np.uint8)
    dets[0] = 0  # an all-zero row
    ev = d_max * (d_max + 1) // 2 + 4
    obs, conv = _launch(dets, offset, tables_np, d_max, ev)
    want_obs, want_conv = tds._sparse_plain(tables_t, d_max, ev,
                                            torch.as_tensor(dets))
    np.testing.assert_array_equal(obs, want_obs.numpy())
    np.testing.assert_array_equal(conv, want_conv.numpy())
    if p >= 0.5:
        assert (dets.sum(1) > 32).any()  # two slots a lane taken


@pytest.mark.parametrize("max_events", [1, 2])
def test_event_cap(max_events):
    tables_t, tables_np = _tables(5)
    V = tables_np[0].shape[0]
    dets = (np.random.default_rng(max_events).random((16, V)) < 0.1
            ).astype(np.uint8)
    obs, conv = _launch(dets, 2, tables_np, 16, max_events)
    want_obs, want_conv = tds._sparse_plain(tables_t, 16, max_events,
                                            torch.as_tensor(dets))
    np.testing.assert_array_equal(obs, want_obs.numpy())
    np.testing.assert_array_equal(conv, want_conv.numpy())
    assert not want_conv.all()  # the cap leaves shots unfinished


def test_exactly_d_and_d_plus_one_defects():
    tables_t, tables_np = _tables(5)
    V = tables_np[0].shape[0]
    D = 12
    rng = np.random.default_rng(3)
    dets = np.zeros((4, V), np.uint8)
    for b, k in enumerate((D, D + 1, D, D + 1)):
        dets[b, rng.choice(V, k, replace=False)] = 1
    obs, conv = _launch(dets, 0, tables_np, D, D * (D + 1) // 2 + 4)
    want_obs, want_conv = tds._sparse_plain(
        tables_t, D, D * (D + 1) // 2 + 4, torch.as_tensor(dets))
    np.testing.assert_array_equal(obs, want_obs.numpy())
    np.testing.assert_array_equal(conv, want_conv.numpy())
    assert not conv[1] and not conv[3]  # overflow: converged = 0


@pytest.mark.parametrize("D,smem", [
    (48, 4 * (256 + 9216)), (1, 4 * (256 + 16)), (31, 4 * (256 + 3856)),
    (33, 4 * (256 + 4368)), (64, 4 * (256 + 16384))])
def test_plan(D, smem):
    assert _plan(D) == (WARPS, 128, smem)


def test_wide_distances_equal_plain():
    """The d=5 graph's distances scaled by 2^12 (finite ones past 2^15,
    UNREACH kept): the same one 32-bit layout, equal to the plain version
    on the same tables."""
    t = tds.build_sparse_tables(_graph(5))
    scale = 1 << 12
    dist = np.where(t.dist < UNREACH, t.dist.astype(np.int64) * scale,
                    UNREACH)
    bdist = np.where(t.bdist < UNREACH, t.bdist.astype(np.int64) * scale,
                     UNREACH)
    wide = tds.sparse_tables_from_numpy(dist, t.phi, bdist, t.bside,
                                        t.num_nodes)
    assert (dist[dist < UNREACH] >= 1 << 15).any()
    tables_np = (wide.dist.astype(np.int64), wide.phi.astype(np.int64),
                 wide.bdist.astype(np.int64), wide.bside.astype(np.int64))
    V = tables_np[0].shape[0]
    dets = (np.random.default_rng(12).random((16, V)) < 0.1).astype(np.uint8)
    obs, conv = _launch(dets, 5, tables_np, 48, 1180)
    want_obs, want_conv = tds._sparse_plain(tds._tables_to(wide, "cpu"), 48,
                                            1180, torch.as_tensor(dets))
    np.testing.assert_array_equal(obs, want_obs.numpy())
    np.testing.assert_array_equal(conv, want_conv.numpy())
