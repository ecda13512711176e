"""The partition of the batch in the packed kernels K6 (syndromes) and K8
(syndrome -> LUT -> residual) of qcss_tpu_torch/csrc/gf2_packed.cu,
modelled in numpy on the CPU and held against the plain versions they
must equal bit for bit.

The kernels launch persistent blocks (at most the blocks the card holds
at once); block k walks the tiles k, k + grid, ... of T shots each. In the
instances for W = 1..4 (16-byte aligned inputs), thread i of a block owns
the groups i, i + lanes, ... of a tile, G shots a group (the fewest whose
words fill whole 16-byte vectors), loaded with 16-byte loads when the
group lies inside the batch and with 4-byte loads at its ragged end. K6
writes a tile's [T, R] output bytes into shared memory and copies them
out with 16-byte stores and a byte tail; at R = 1 a thread stores a
group's flags at once. Wider checks and misaligned inputs take the
generic instance: one shot a thread, 4-byte loads in chunks of 4 words.
`_plan` mirrors the C host's `plan_k6` / `plan_k8`; the card tests
(tests/test_torch_cuda.py) hold it against `cuda_gf2.launch_plan`.

The model counts every read of an input word and every write of an
output byte or word and asserts: each input word is read once (K8's
generic instance reads a shot wider than one chunk a second time for its
residual), each output element is written once, every 16-byte access is
16-byte aligned, and the outputs equal `syndromes_packed_plain` and
`decode_residual_packed_plain`.
"""

import numpy as np
import pytest
import torch

from qcss_tpu_torch import _cuda
from qcss_tpu_torch.ops import cuda_gf2

THREADS = 256
MAX_SMEM = _cuda.MAX_SHARED_BYTES
CHUNK = 4
RESIDENT = 5  # blocks the card holds at once, small so blocks loop


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # several worker processes run at once; see test_torch_device_uf.py
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _group_shots(w):
    return 1 if w == 0 or w % 4 == 0 else 2 if w % 2 == 0 else 4


def _groups_per_thread(w):
    return 1 if w in (0, 3) else 2


def _plan(kernel, W, R, offset):
    """(instance, shots a thread, lanes, shared bytes), as the C host plans
    a launch whose errors start ``offset`` words past a 16-byte boundary
    (the output is aligned)."""
    inst = W if W <= 4 and offset % 4 == 0 else 0
    shots = _group_shots(inst) * _groups_per_thread(inst)
    hb = 4 * ((R * W + 3) // 4 * 4)
    h_in = hb <= MAX_SMEM // 2
    if kernel == "K8":
        lb = 4 * W << R
        lut_in = h_in and hb + lb <= MAX_SMEM
        return inst, shots, THREADS, hb * h_in + lb * lut_in
    lanes = min(THREADS, (MAX_SMEM - hb * h_in) // (shots * R))
    if lanes >= 32:
        lanes -= lanes % 32
    return inst, shots, lanes, hb * h_in + lanes * shots * R


def _tiles(B, T):
    """Tiles in the order the persistent blocks take them: each once."""
    ntiles = -(-B // T)
    grid = min(ntiles, RESIDENT)
    order = [t for k in range(grid) for t in range(k, ntiles, grid)]
    assert sorted(order) == list(range(ntiles))
    return np.asarray(order, dtype=np.int64)


def _row_bits(words, h):
    """Parity of words [..., W] against every check row h [R, W]: [..., R]
    (rows in blocks, to bound the [..., rows, W] product)."""
    R, W = h.shape
    step = max(1, (1 << 22) * W // max(words.size, 1))
    out = []
    for r0 in range(0, R, step):
        rows = h[r0:r0 + step]
        x = words[..., 0, None] & rows[:, 0]
        for w in range(1, W):
            x ^= words[..., w, None] & rows[:, w]
        for s in (16, 8, 4, 2, 1):
            x ^= x >> np.uint32(s)
        out.append((x & np.uint32(1)).astype(np.uint8))
    return np.concatenate(out, axis=-1)


def _index(bits):
    """Big-endian index of bits [..., R] by shift-or, row 0 first."""
    idx = np.zeros(bits.shape[:-1], dtype=np.int64)
    for r in range(bits.shape[-1]):
        idx = (idx << 1) | bits[..., r]
    return idx


class _Launch:
    """Read and write counts of one modelled launch."""

    def __init__(self, e, offset, n_out):
        self.e = e.reshape(-1)
        self.offset = offset
        self.reads = np.zeros(self.e.size, dtype=np.int64)
        self.writes = np.zeros(n_out, dtype=np.int64)

    def load_groups(self, shot0, W, G):
        """Words [len(shot0), G, W] of the groups starting at shot0: 16-byte
        loads for a whole group, 4-byte loads at the ragged end; words of
        shots at or past B read as zero."""
        B = self.e.size // W
        idx = shot0[:, None] * W + np.arange(G * W)
        ok = idx < B * W
        whole = shot0 + G <= B
        assert np.all((self.offset + shot0[whole] * W) % 4 == 0), \
            "a 16-byte load is misaligned"
        np.add.at(self.reads, idx[ok], 1)
        words = np.where(ok, self.e[np.minimum(idx, self.e.size - 1)], 0)
        return words.reshape(-1, G, W).astype(np.uint32)

    def load_shots(self, b, W, w0):
        """The chunk of words [w0, w0 + CHUNK) of shots b, 4-byte loads."""
        cols = np.arange(w0, min(w0 + CHUNK, W))
        pos = b[:, None] * W + cols
        np.add.at(self.reads, pos.reshape(-1), 1)
        return self.e[pos], cols


def _thread_groups(tiles, T, lanes, NG, G):
    """shot0 [tiles, NG, lanes] of every thread's groups."""
    g = np.arange(NG)[None, :, None]
    i = np.arange(lanes)[None, None, :]
    return tiles[:, None, None] * T + (g * lanes + i) * G


def _k8_model(e, offset, h, lut):
    B, W = e.shape
    R = h.shape[0]
    inst, shots, lanes, _ = _plan("K8", W, R, offset)
    run = _Launch(e, offset, B * W)
    out = np.zeros(B * W, dtype=np.uint32)
    if B == 0:
        return out.reshape(B, W), run
    if inst:
        G = _group_shots(W)
        T = lanes * shots
        shot0 = _thread_groups(_tiles(B, T), T, lanes, shots // G,
                               G).reshape(-1)
        words = run.load_groups(shot0, W, G)  # [groups, G, W]
        res = words ^ lut[_index(_row_bits(words, h))]
        pos = (shot0[:, None, None] + np.arange(G)[:, None]) * W \
            + np.arange(W)
        ok = pos < B * W
        assert np.all(pos[shot0 + G <= B][:, 0, 0] % 4 == 0)  # 16-byte
        np.add.at(run.writes, pos[ok], 1)
        out[pos[ok]] = res[ok]
    else:
        T = THREADS
        b = (_tiles(B, T)[:, None] * T + np.arange(T)).reshape(-1)
        b = b[b < B]
        idx = np.zeros(b.size, dtype=np.int64)
        for w0 in range(0, W, CHUNK):
            ew, cols = run.load_shots(b, W, w0)
            # parity is linear: each chunk's index bits XOR in
            idx ^= _index(_row_bits(ew, h[:, cols]))
        if W > CHUNK:  # the residual pass reads a wide shot again
            np.add.at(run.reads, (b[:, None] * W + np.arange(W)).reshape(-1),
                      1)
        pos = b[:, None] * W + np.arange(W)
        np.add.at(run.writes, pos.reshape(-1), 1)
        out[pos] = run.e[pos] ^ lut[idx]
    return out.reshape(B, W), run


def _copy_out(run, tile_bytes, tiles, T, R, B):
    """K6's copy of each tile's output bytes [tiles, T*R] to the tile's
    run of the [B, R] output (16-byte stores while the destination is
    aligned, then single bytes)."""
    out = np.zeros(B * R, dtype=np.uint8)
    n = np.minimum(T, B - tiles * T) * R  # bytes each tile owns
    j = np.arange(T * R)
    keep = j[None, :] < n[:, None]
    pos = (tiles[:, None] * T * R + j)[keep]
    np.add.at(run.writes, pos, 1)
    out[pos] = tile_bytes[keep]
    return out


def _k6_model(e, offset, h):
    B, W = e.shape
    R = h.shape[0]
    inst, shots, lanes, _ = _plan("K6", W, R, offset)
    run = _Launch(e, offset, B * R)
    if B == 0:
        return np.zeros((B, R), dtype=np.uint8), run
    G = _group_shots(inst)
    T = lanes * shots
    tiles = _tiles(B, T)
    if inst:
        shot0 = _thread_groups(tiles, T, lanes, shots // G, G)
        words = run.load_groups(shot0.reshape(-1), W, G)
        bits = _row_bits(words, h)  # [groups, G, R]
        if R == 1:
            # a group's G flags go out in one store at out + shot0
            assert np.all(shot0 % G == 0)
            out = np.zeros(B, dtype=np.uint8)
            pos = shot0.reshape(-1)[:, None] + np.arange(G)
            ok = pos < B
            np.add.at(run.writes, pos[ok], 1)
            out[pos[ok]] = bits[..., 0][ok]
            return out.reshape(B, 1), run
        # thread i's shot s of its group g lands at byte (local shot)*R + r
        local = ((np.arange(shots // G)[:, None, None] * lanes
                  + np.arange(lanes)[None, :, None]) * G
                 + np.arange(G)[None, None, :]).reshape(-1)
        slot = (local[:, None] * R + np.arange(R)).reshape(-1)
        assert np.array_equal(np.sort(slot), np.arange(T * R))  # each once
        tile_bytes = np.zeros((len(tiles), T * R), dtype=np.uint8)
        tile_bytes[:, slot] = bits.reshape(len(tiles), -1)
    else:
        b = (tiles[:, None] * T + np.arange(lanes)).reshape(-1)
        live = b < B
        acc = np.zeros((b.size, R), dtype=np.uint8)
        for w0 in range(0, W, CHUNK):
            ew, cols = run.load_shots(b[live], W, w0)
            acc[live] ^= _row_bits(ew, h[:, cols])
        tile_bytes = acc.reshape(len(tiles), T * R)
    return _copy_out(run, tile_bytes, tiles, T, R, B).reshape(B, R), run


def _words(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint32)


def _check(run, reads_per_word=1):
    assert np.all(run.reads == reads_per_word), "a word read not once"
    assert np.all(run.writes == 1), "an output not written exactly once"


_BATCHES = (0, 1, 3, 1000, 4099)
_WIDTHS = list(range(1, 10)) + [13]


@pytest.mark.parametrize("W", _WIDTHS)
def test_k6_schedule_matches_plain(W):
    rng = np.random.default_rng(W)
    for R in (1, 3, 11, 60, 61, 200):
        h = _words(rng, (R, W))
        for B in _BATCHES:
            for offset in (0, 1):
                e = _words(rng, (B, W))
                got, run = _k6_model(e, offset, h)
                _check(run)
                want = cuda_gf2.syndromes_packed_plain(
                    torch.from_numpy(e.view(np.int32)),
                    torch.from_numpy(h.view(np.int32)))
                assert np.array_equal(got, want.numpy()), (R, B, offset)


@pytest.mark.parametrize("W", _WIDTHS)
def test_k8_schedule_matches_plain(W):
    rng = np.random.default_rng(50 + W)
    for R in (1, 3, 11, 14, 16):
        h = _words(rng, (R, W))
        lut = _words(rng, (1 << R, W))
        for B in _BATCHES:
            for offset in (0, 1):
                e = _words(rng, (B, W))
                got, run = _k8_model(e, offset, h, lut)
                inst = _plan("K8", W, R, offset)[0]
                _check(run, 2 if not inst and W > CHUNK else 1)
                want = cuda_gf2.decode_residual_packed_plain(
                    torch.from_numpy(e.view(np.int32)),
                    torch.from_numpy(h.view(np.int32)),
                    torch.from_numpy(lut.view(np.int32)))
                assert np.array_equal(got.view(np.int32), want.numpy()), \
                    (R, B, offset)


@pytest.mark.parametrize("kernel,W,R", [("K6", 1, 1), ("K6", 4, 3),
                                        ("K8", 1, 3), ("K8", 3, 11)])
def test_schedules_at_the_largest_batch(kernel, W, R):
    """B = 2^20 + 3: many tiles a block and a ragged last tile."""
    rng = np.random.default_rng(R)
    B = (1 << 20) + 3
    e = _words(rng, (B, W))
    h = _words(rng, (R, W))
    te, th = torch.from_numpy(e.view(np.int32)), torch.from_numpy(
        h.view(np.int32))
    if kernel == "K6":
        got, run = _k6_model(e, 0, h)
        want = cuda_gf2.syndromes_packed_plain(te, th).numpy()
    else:
        lut = _words(rng, (1 << R, W))
        got, run = _k8_model(e, 0, h, lut)
        got = got.view(np.int32)
        want = cuda_gf2.decode_residual_packed_plain(
            te, th, torch.from_numpy(lut.view(np.int32))).numpy()
    _check(run)
    assert np.array_equal(got, want)


def test_plans():
    # the headline's shapes take the W = 1 instances, 8 shots a thread
    assert _plan("K8", 1, 3, 0)[:3] == (1, 8, THREADS)
    assert _plan("K6", 1, 1, 0)[:3] == (1, 8, THREADS)
    # d=11: W = 4, two shots a thread, a 512-shot tile of 60-byte rows
    assert _plan("K6", 4, 60, 0) == (4, 2, THREADS, 960 + 512 * 60)
    # W = 3: one group of four shots (three vectors) a thread
    assert _plan("K8", 3, 11, 0)[:2] == (3, 4)
    # a misaligned view or a wide check takes the generic instance
    assert _plan("K6", 2, 3, 1)[:2] == (0, 1)
    assert _plan("K8", 5, 3, 0)[:2] == (0, 1)
    # Golay's 8 KB LUT and a 64 KB one are staged, a 256 KB one is not
    assert _plan("K8", 1, 11, 0)[3] == 48 + 4 * 2048
    assert _plan("K8", 1, 14, 0)[3] == 64 + 4 * (1 << 14)
    assert _plan("K8", 1, 16, 0)[3] == 64
    # many rows shrink K6's tile to fewer lanes: whole warps while there
    # are more than 32, else as many as shared memory holds
    assert _plan("K6", 1, 500, 0) == (1, 8, 32, 2000 + 32 * 8 * 500)
    assert _plan("K6", 1, 1000, 0) == (1, 8, 28, 4000 + 28 * 8 * 1000)
