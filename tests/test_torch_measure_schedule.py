"""The schedule of the fused CHP measurement kernel (K9,
qcss_tpu_torch/csrc/chp_measure.cu), modelled in plain Python and numpy on
the CPU and held against its plain version, `tableau_packed.measure_many`,
bit for bit (outcomes, x, z, r).

Form 1 (W <= 4) is a warp a shot: lane L owns the row pairs (l, n + l),
l = L, L + 32, ...; the measured bit of every 32-row chunk is a ballot,
the pivot the first set bit of the first non-zero stabilizer ballot; the
rows to update are ranked across the ballots by their owner lanes into a
byte list and lane j takes ranks j, j + 32, ...; lanes w < W write word w
of rows p - n and p; the deterministic product is
a __shfl_up_sync XOR scan per chunk and word, carried chunk to chunk.
Form 2 (W >= 5) is a block of 256 threads a shot with two barriers a
measurement. Each measurement notes, for every row, its bit at the NEXT
measured qubit (a flag) and lists the rows that have it, so the next one
starts with its targets listed: in phase A one thread a (target, word)
item XORs the pivot's word in and adds its phase term mod 4 to the
target's byte, while the pair owners (a warp owns 32 row pairs a round)
note the rows left as they are; in phase B a thread a target sets its
sign and W threads move the pivot row to p - n and Z_q into p. The
deterministic product runs thread (w, c) over word w of a contiguous
chunk of rows (its exclusive XOR prefix, the pair parity within the
chunk, the chunk's XOR of x and z), then W threads combine the chunks:
parity is linear, so chunk c adds popc(its x & the chunks' z before it).

The model records, between barriers (form 2: warps as the actors) and
between __syncwarp()s (form 1: lanes), who reads and writes which row,
and asserts that a row written in such a phase is touched by no other
actor in it (lanes of one warp split a row by words); that the
lanes' reads of the measured bit fall in distinct shared-memory banks
(the word-major layout); and that the copies in and out touch every word
once, in 16-byte pieces where the plan says so. `_plan` mirrors
`plan_k9` (and `shot_words`, `header2_words`); the card tests
(tests/test_torch_cuda.py) hold it against `cuda_measure.launch_plan`.
"""

import numpy as np
import pytest
import torch

from qcss_tpu_torch.circuits.ir import Circuit
from qcss_tpu_torch.sim import tableau as tb
from qcss_tpu_torch.sim import tableau_packed as tp

MAX_SMEM = 232448
WARPS1 = 4
THREADS2 = 256
WARPS2 = THREADS2 // 32
THREADS3 = 256
HEADER3_WORDS = 72
GATES = ["I", "X", "Y", "Z", "H", "S", "CNOT", "CZ"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # several worker processes run at once; see test_torch_device_uf.py
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _round4(v):
    return (v + 3) // 4 * 4


def _shot_words(n, W):
    return _round4(2 * W * 2 * n + (2 * n + 3) // 4)


def _warp1_words(n, W):
    return _shot_words(n, W) + _round4((2 * n + 3) // 4)


def _block2_words(n, W):
    """The header (minima, sums, counters), the shot, the flags, the
    target lists and the rowsums' phase bytes."""
    return 4 * WARPS2 + 4 + _shot_words(n, W) + _round4((4 * n + 3) // 4) \
        + _round4((8 * n + 3) // 4) + _round4((2 * n + 3) // 4)


def _plan(n, W, form=0):
    """(form, shots a block, threads, shared bytes) as `plan_k9` lays out
    a launch; form 0 where the asked-for form is not taken. Form 2 needs
    n >= 2W: its deterministic product's 2 C W words sit in a target list
    of n words."""
    smem2 = 4 * _block2_words(n, W)
    fits2 = smem2 <= MAX_SMEM and n >= 2 * W
    if form == 0:
        form = 1 if W <= 4 else 2 if fits2 else 3
    if form == 1 and W <= 4:
        return 1, WARPS1, 32 * WARPS1, 4 * WARPS1 * _warp1_words(n, W)
    if form == 2 and fits2:
        return 2, 1, THREADS2, smem2
    if form == 3:
        threads = min(THREADS3, max(32, (2 * n + 31) // 32 * 32))
        return 3, 1, threads, 4 * (HEADER3_WORDS + 2 * W)
    return 0, 0, 0, 0


def _popc(v):
    return bin(int(v)).count("1")


def _g_word(x1, z1, x2, z2):
    m = 0xFFFFFFFF
    nx1, nz1, nx2, nz2 = x1 ^ m, z1 ^ m, x2 ^ m, z2 ^ m
    plus = (x1 & z1 & z2 & nx2) | (x1 & nz1 & x2 & z2) | (nx1 & z1 & x2 & nz2)
    minus = (x1 & z1 & x2 & nz2) | (x1 & nz1 & nx2 & z2) | (nx1 & z1 & x2 & z2)
    return _popc(plus) - _popc(minus)


def _incl_xor(v):
    """A warp's inclusive XOR scan by __shfl_up_sync (offsets 1..16)."""
    v = [int(a) for a in v]
    for o in (1, 2, 4, 8, 16):
        old = list(v)
        for lane in range(o, 32):
            v[lane] = old[lane] ^ old[lane - o]
    return v


class _Shot:
    """One shot's tableau in shared memory, word-major (word w of row i at
    w * S + i), with the phase's accesses by thread."""

    def __init__(self, x, z, r, n, vec):
        self.n, self.W = n, x.shape[1]
        self.S = 2 * n
        self.X = np.zeros(self.W * self.S, np.int64)
        self.Z = np.zeros(self.W * self.S, np.int64)
        self.R = [int(v) for v in r]
        self.copy(x.reshape(-1), z.reshape(-1), vec, inward=True)
        self.acc = {}

    def copy(self, xg, zg, vec, inward):
        """Global words e = 4c..4c+3 (16-byte pieces, c = 0, 1, ...) or one
        by one, to and from [w * S + e // W] (put_words / get_words)."""
        W, S = self.W, self.S
        tw = 2 * self.n * W
        piece = 4 if vec else 1
        if vec:
            assert tw % 4 == 0
        touched = np.zeros(tw, np.int64)
        for e0 in range(0, tw, piece):
            for e in range(e0, e0 + piece):
                row, w = divmod(e, W)
                touched[w * S + row] += 1
                if inward:
                    self.X[w * S + row] = xg[e]
                    self.Z[w * S + row] = zg[e]
                else:
                    xg[e] = self.X[w * S + row]
                    zg[e] = self.Z[w * S + row]
        assert (touched == 1).all()

    def touch(self, t, row, write=False):
        self.acc.setdefault(row, set()).add((t, write))

    def barrier(self):
        """End of a phase: a row written in it was touched by its writer
        only."""
        for row, acc in self.acc.items():
            if any(w for _, w in acc):
                assert len({t for t, _ in acc}) == 1, (row, acc)
        self.acc = {}

    def rowsum(self, t, i, px, pz, pr):
        g = 0
        for w in range(self.W):
            a = w * self.S + i
            g += _g_word(px[w], pz[w], int(self.X[a]), int(self.Z[a]))
            self.X[a] ^= px[w]
            self.Z[a] ^= pz[w]
        self.R[i] = ((2 * self.R[i] + 2 * pr + g) & 3) >> 1
        self.touch(t, i, write=True)

    def set_row(self, t, i, xs, zs, rv):
        for w in range(self.W):
            self.X[w * self.S + i] = xs[w]
            self.Z[w * self.S + i] = zs[w]
        self.R[i] = rv
        self.touch(t, i, write=True)

    def row(self, i):
        return ([int(self.X[w * self.S + i]) for w in range(self.W)],
                [int(self.Z[w * self.S + i]) for w in range(self.W)])


def _banks_distinct(addrs):
    banks = [a % 32 for a in addrs]
    assert len(set(banks)) == len(banks)


def _form1(sh, qs, bits):
    """A warp a shot (chp_measure_warp_kernel): the outcomes and each
    measurement's branch ("r" or "d")."""
    n, W, S = sh.n, sh.W, sh.S
    K = W
    nk = -(-n // 32)
    outs, kinds = [], []
    for m, q in enumerate(qs):
        wq, bq = q >> 5, 1 << (q & 31)
        dmask, smask = [0] * K, [0] * K
        for k in range(nk):
            lanes = [lane for lane in range(32) if 32 * k + lane < n]
            _banks_distinct([wq * S + 32 * k + lane for lane in lanes])
            _banks_distinct([wq * S + n + 32 * k + lane for lane in lanes])
            for lane in lanes:
                l = 32 * k + lane
                sh.touch(lane, l)
                sh.touch(lane, n + l)
                dmask[k] |= bool(sh.X[wq * S + l] & bq) << lane
                smask[k] |= bool(sh.X[wq * S + n + l] & bq) << lane
        p = -1
        for k in reversed(range(K)):
            if smask[k]:
                p = n + 32 * k + (smask[k] & -smask[k]).bit_length() - 1
        if p >= 0:
            bit = int(bits[m])
            px, pz = sh.row(p)  # every lane, then __syncwarp
            pr = sh.R[p]
            for lane in range(32):
                sh.touch(lane, p)
            sh.barrier()
            # owner lanes rank the rows to update into the warp's list
            kp, bp = (p - n) >> 5, 1 << ((p - n) & 31)
            dmask[kp] &= ~bp
            smask[kp] &= ~bp
            lst, cnt = {}, 0
            for h, mk in enumerate(dmask + smask):
                for lane in range(32):
                    if mk >> lane & 1:
                        rank = cnt + _popc(mk & ((1 << lane) - 1))
                        assert rank not in lst
                        lst[rank] = (h // K * n) + 32 * (h % K) + lane
                cnt += _popc(mk)
            assert sorted(lst) == list(range(cnt))
            assert all(v < 256 for v in lst.values())  # a byte a row
            for j in range(cnt):  # lane j % 32 takes rank j
                sh.rowsum(j % 32, lst[j], px, pz, pr)
            # lanes w < W write word w of rows p - n and p (one actor here)
            zq = [bq if w == wq else 0 for w in range(W)]
            sh.set_row(0, p - n, px, pz, pr)
            sh.set_row(0, p, [0] * W, zq, bit)
            outs.append(bit)
            kinds.append("r")
        else:
            base, pair = [0] * 32, [0] * 32
            carry = [0] * W
            for k in range(K):
                if not dmask[k]:
                    continue
                sel = [dmask[k] >> lane & 1 for lane in range(32)]
                ls = [32 * k + lane for lane in range(32)]
                y = [0] * 32
                for w in range(W):
                    zv = [int(sh.Z[w * S + n + l]) if s else 0
                          for l, s in zip(ls, sel)]
                    xv = [int(sh.X[w * S + n + l]) if s else 0
                          for l, s in zip(ls, sel)]
                    incl = _incl_xor(zv)
                    for lane in range(32):
                        pre = incl[lane] ^ zv[lane] ^ carry[w]
                        pair[lane] ^= _popc(xv[lane] & pre) & 1
                        y[lane] += _popc(xv[lane] & zv[lane])
                    carry[w] ^= incl[31]
                for lane in range(32):
                    if sel[lane]:
                        sh.touch(lane, n + ls[lane])
                        base[lane] += 2 * sh.R[n + ls[lane]] + y[lane]
            total = sum(b + 2 * p_ for b, p_ in zip(base, pair))
            outs.append((total & 3) >> 1)
            kinds.append("d")
        sh.barrier()  # __syncwarp at the end of the measurement
    return outs, kinds


def _form2(sh, qs, bits):
    """A block a shot (chp_measure_block_kernel): the outcomes and each
    measurement's branch; each crosses two block barriers. Actors: the
    warp that owns a row pair (32 w + lane + 256 k) when it notes the pair,
    ("items", row) for the threads that rowsum a row's words, ("pivot",)
    for the threads that move the pivot row, ("sign", row) for the thread
    that sets a target's sign."""
    n, W, S = sh.n, sh.W, sh.S
    T = THREADS2
    KP = -(-n // T)
    C = min(T // W, max(1, n // (2 * W)))
    CL = -(-n // C)
    assert 2 * C * W <= n  # the chunks' words fit in a target list
    flag = [[None] * S, [None] * S]  # a row's bit at the measured qubit
    lists = [[], []]  # the rows with it, appended in any order

    def note(buf, actor, r, b):
        assert flag[buf][r] is None  # one writer a row a phase
        flag[buf][r] = b
        sh.touch(actor, r)
        if b:
            lists[buf].append(r)

    def owners(buf, w1, b1, skip=lambda r: False, value=None):
        """The pair owners note the bit (w1, b1) of their rows; the
        stabilizers' lowest set bit is a pivot candidate."""
        cand = None
        for l in range(n):
            for r in (l, n + l):
                if skip(r):
                    continue
                b = bool((value(r) if value else sh.X[w1 * S + r]) & b1)
                note(buf, l % T // 32, r, b)
                if b and r >= n:
                    cand = r if cand is None else min(cand, r)
        return cand

    flag[0] = [None] * S
    p = owners(0, qs[0] >> 5, 1 << (qs[0] & 31)) if qs else None
    sh.barrier()
    outs, kinds = [], []
    for m, q in enumerate(qs):
        wq, bq = q >> 5, 1 << (q & 31)
        nxt = m + 1 < len(qs)
        wq1, bq1 = (qs[m + 1] >> 5, 1 << (qs[m + 1] & 31)) if nxt else (0, 0)
        cur, new = m & 1, (m & 1) ^ 1
        flag[new], lists[new] = [None] * S, []
        if p is not None:
            bit = int(bits[m])
            pr = sh.R[p]
            pl = p - n
            # phase A: the owners note the rows left as they are (p - n
            # takes the pivot's bits, p has none left) ...
            cand = owners(
                new, wq1, bq1,
                skip=lambda r: r != pl and r != p and flag[cur][r],
                value=lambda r: (sh.X[wq1 * S + p] if r == pl
                                 else 0 if r == p else sh.X[wq1 * S + r]))
            sh.touch(pl % T // 32, p)
            # ... the items rowsum the targets a word each, the phase sums
            # mod 4 gathered a byte a target (the bytes never carry: at
            # most W terms of 3 each)
            targets = lists[cur]
            assert sorted(targets) == sorted(
                r for r in range(S) if flag[cur][r])
            gsum = [0] * len(targets)
            px, pz = sh.row(p)
            for j, row in enumerate(targets):
                if row in (p, pl):
                    continue
                for w in range(W):
                    a = w * S + row
                    gsum[j] += _g_word(px[w], pz[w], int(sh.X[a]),
                                       int(sh.Z[a])) & 3
                    assert gsum[j] < 256
                    sh.X[a] ^= px[w]
                    sh.Z[a] ^= pz[w]
                sh.touch(("items", row), p)
                b = bool(sh.X[wq1 * S + row] & bq1)  # the item of word wq1
                note(new, ("items", row), row, b)
                if b and row >= n:
                    cand = row if cand is None else min(cand, row)
            sh.barrier()
            # phase B: the signs, the pivot row to p - n and Z_q to p
            for j, row in enumerate(targets):
                if row not in (p, pl):
                    sh.R[row] = ((2 * sh.R[row] + 2 * pr + gsum[j]) & 3) >> 1
                    sh.touch(("sign", row), row, write=True)
            zq = [bq if w == wq else 0 for w in range(W)]
            sh.set_row(("pivot",), pl, px, pz, pr)
            sh.set_row(("pivot",), p, [0] * W, zq, bit)
            outs.append(bit)
            kinds.append("r")
        else:
            # phase A: thread (w, c) runs word w over the rows of chunk c
            # (destabilizer flag set: the stabilizer is in the product)
            part = 0
            cz, cx = {}, {}
            for c in range(C):
                for w in range(W):
                    pre = xacc = par = 0
                    for l in range(c * CL, min(n, (c + 1) * CL)):
                        if not flag[cur][l]:
                            continue
                        xv = int(sh.X[w * S + n + l])
                        zv = int(sh.Z[w * S + n + l])
                        par ^= _popc(xv & pre) & 1
                        pre ^= zv
                        xacc ^= xv
                        part += _popc(xv & zv) + (2 * sh.R[n + l] if w == 0
                                                  else 0)
                    part += 2 * par
                    cz[c, w], cx[c, w] = pre, xacc
            cand = owners(new, wq1, bq1)
            sh.barrier()
            # phase B: thread w combines word w's chunks (parity is linear)
            for w in range(W):
                pz = par = 0
                for c in range(C):
                    par ^= _popc(cx[c, w] & pz) & 1
                    pz ^= cz[c, w]
                part += 2 * par
            outs.append((part & 3) >> 1)
            kinds.append("d")
        assert all(f is not None for f in flag[new])
        sh.barrier()
        p = cand if nxt else None
    sh.barrier()
    return outs, kinds


def _random_state(n, B, seed):
    rng = np.random.default_rng(seed)
    circ = Circuit()
    for _ in range(4 * n):
        k = int(rng.integers(0, len(GATES)))
        a, b = (int(v) for v in rng.choice(n, 2, replace=False))
        circ.gate(GATES[k], *((a,) if k < 6 else (a, b)))
    return tp.run_circuit(tp.zero_state(B, n, "cpu"), circ), rng


def _model(t, qs, bits):
    """The kernel's form (by `_plan`) on every shot: (x, z, r, outcomes)
    as uint32 / uint8 arrays, and each shot's branches."""
    B, two_n, W = t.x.shape
    n = t.n
    form = _plan(n, W)[0]
    assert form in (1, 2)
    vec = (two_n * W) % 4 == 0
    xs = t.x.numpy().view(np.uint32).astype(np.int64)
    zs = t.z.numpy().view(np.uint32).astype(np.int64)
    x_out, z_out = np.zeros_like(xs), np.zeros_like(zs)
    r_out = np.zeros((B, two_n), np.uint8)
    outs, kinds = [], []
    for s in range(B):
        sh = _Shot(xs[s], zs[s], t.r[s].numpy(), n, vec)
        o, k = (_form1 if form == 1 else _form2)(sh, qs, bits[s])
        kinds.append(k)
        sh.copy(x_out[s].reshape(-1), z_out[s].reshape(-1), vec,
                inward=False)
        r_out[s] = sh.R
        outs.append(o)
    return x_out, z_out, r_out, np.asarray(outs, np.uint8), kinds


def _assert_equal_plain(t, qs, bits):
    """The model against the plain version; returns the branches taken."""
    x, z, r, o, kinds = _model(t, qs, bits)
    tpl, op = tp.measure_many(t, qs, rand_bits=bits)
    np.testing.assert_array_equal(o, op.numpy())
    np.testing.assert_array_equal(x, tpl.x.numpy().view(np.uint32))
    np.testing.assert_array_equal(z, tpl.z.numpy().view(np.uint32))
    np.testing.assert_array_equal(r, tpl.r.numpy())
    return {k for shot in kinds for k in shot}


@pytest.mark.parametrize("n,B", [(7, 3), (33, 2), (40, 2), (128, 1)])
def test_warp_form_equals_plain(n, B):
    assert _plan(n, (n + 31) // 32)[0] == 1
    t, rng = _random_state(n, B, n)
    first = [int(v) for v in rng.choice(n, min(n, 12), replace=False)]
    qs = first + first[:6]  # the repeats are deterministic
    if n > 32:
        qs[0] = 31  # bit 31 of a word
    bits = tb.collapse_bits(torch.Generator().manual_seed(n), B, len(qs))
    assert _assert_equal_plain(t, qs, bits) == {"r", "d"}


@pytest.mark.parametrize("n", [129, 300])
def test_block_form_equals_plain(n):
    """n = 129: one row pair a thread; n = 300: two (KP = 2), so the
    deterministic scan carries across rounds."""
    W = (n + 31) // 32
    assert _plan(n, W)[0] == 2
    t, rng = _random_state(n, 1, n)
    first = [int(v) for v in rng.choice(n, 8, replace=False)]
    qs = [31] + first + first[:5]
    bits = tb.collapse_bits(torch.Generator().manual_seed(n), 1, len(qs))
    assert _assert_equal_plain(t, qs, bits) == {"r", "d"}


def test_ladder_state_is_all_random():
    """The bench's ladder state (every outcome random) through the warp
    form at n = 49, measuring its 32 evenly spaced qubits."""
    from qcss_tpu_torch.benchmarks.tableau_bench import (
        ladder_circuit,
        measured_qubits,
    )

    n = 49
    t = tp.run_circuit(tp.zero_state(2, n, "cpu"), ladder_circuit(n))
    qs = [int(v) for v in measured_qubits(n)]
    bits = tb.collapse_bits(torch.Generator().manual_seed(5), 2, len(qs))
    assert _assert_equal_plain(t, qs, bits) == {"r"}


@pytest.mark.parametrize("n,W,form,want", [
    (49, 2, 0, 1), (121, 4, 0, 1), (128, 4, 0, 1), (129, 5, 0, 2),
    (363, 12, 0, 2), (659, 21, 0, 2), (660, 21, 0, 3), (720, 23, 0, 3),
    (121, 4, 2, 2), (121, 4, 3, 3), (363, 12, 1, 0), (720, 23, 2, 0),
    (1, 1, 2, 0), (9, 5, 0, 3), (10, 5, 0, 2)])
def test_plan_forms(n, W, form, want):
    """The forms the thresholds give: a warp a shot up to W = 4, a block
    in shared memory up to n = 659 (where n >= 2W), device memory past
    it; a form asked for where it cannot run is refused."""
    p = _plan(n, W, form)
    assert p[0] == want
    if want in (1, 2):
        assert p[3] <= MAX_SMEM
