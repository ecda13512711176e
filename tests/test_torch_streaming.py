"""The port's sliding-window streaming decoder against the JAX package's,
on the CPU.

Graphs, tables and decoded streams are compared exactly (bit for bit):
both packages decode the same numpy-drawn detector streams, the JAX
decoder through its Mosaic full kernel in interpret mode (its instance
attribute `_mid_fn` is set by the test; nothing in the package changes).
The two samplers cannot share random bits, so the sampled memories'
failure rates are held together by a two-sample 99.9% test.
"""

import math
from functools import partial

import numpy as np
import pytest
import torch

from qcss_tpu.codes.families import rotated_surface
from qcss_tpu.decode import device_streaming as jds
from qcss_tpu.decode import streaming as jst
from qcss_tpu.decode.dem import circuit_level_graph, extraction_gate_list
from qcss_tpu.decode.device_uf_pallas import decode_stencil_pallas_full
from qcss_tpu.sim.noise import NoiseModel as JNoiseModel
from qcss_tpu_torch.codes.families import rotated_surface as t_rotated_surface
from qcss_tpu_torch.decode import device_streaming as tds
from qcss_tpu_torch.decode import streaming as tst
from qcss_tpu_torch.sim.noise import NoiseModel as TNoiseModel

Z999 = 3.2905


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # several worker processes run at once; see test_torch_device_uf.py
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _code(d):
    code = rotated_surface(d)
    return (np.asarray(code.raw_parity_check_c2, np.uint8),
            np.asarray(code.z_operator_matrix(), np.uint8))


def _np_stream(h, seed, batch, rounds, p, q):
    """A phenomenological detector stream [B, rounds + 1, r] drawn with
    numpy: IID data flips per round, measurement flips, perfect readout."""
    rng = np.random.default_rng(seed)
    r, n = h.shape
    cum = np.zeros((batch, n), np.uint8)
    prev = np.zeros((batch, r), np.uint8)
    dets = []
    for t in range(rounds + 1):
        cum ^= (rng.random((batch, n)) < p).astype(np.uint8)
        syn = ((cum @ h.T) & 1).astype(np.uint8)
        if t < rounds:
            syn ^= (rng.random((batch, r)) < q).astype(np.uint8)
        dets.append(syn ^ prev)
        prev = syn
    return np.stack(dets, axis=1)


def _assert_tree_equal(t, j):
    if isinstance(j, tuple) and hasattr(j, "_fields"):
        for name in j._fields:
            _assert_tree_equal(getattr(t, name), getattr(j, name))
    elif isinstance(j, tuple):
        assert len(t) == len(j)
        for a, b in zip(t, j):
            _assert_tree_equal(a, b)
    elif j is None or isinstance(j, (int, np.integer)):
        assert t == j
    else:
        np.testing.assert_array_equal(
            t.numpy() if isinstance(t, torch.Tensor) else t, np.asarray(j))


@pytest.mark.parametrize("open_future,weighted", [(True, False),
                                                  (True, True),
                                                  (False, True)])
def test_window_graph_equal(open_future, weighted):
    h, lz = _code(5)
    probs = (0.004, 0.01) if weighted else (None, None)
    gj, mj = jst._window_graph(h, lz, 6, open_future, *probs)
    gt, mt = tst._window_graph(h, lz, 6, open_future, *probs)
    np.testing.assert_array_equal(mt, mj)
    assert gt.num_nodes == gj.num_nodes and gt.n_qubits == gj.n_qubits
    for name in ("edges", "edge_qubit", "edge_obs", "edge_weight"):
        np.testing.assert_array_equal(getattr(gt, name), getattr(gj, name))


def test_window_graph_wants_both_probabilities():
    h, lz = _code(3)
    with pytest.raises(ValueError, match="both"):
        tst._window_graph(h, lz, 4, True, 0.01, None)


@pytest.mark.parametrize("d,kind", [(5, "phenomenological"), (9, "wide"),
                                    (3, "dem")])
def test_mid_window_tables_equal(d, kind):
    h, lz = _code(d)
    if kind == "dem":
        kw = dict(window=8, commit=4, p_gate2=3e-3, p_meas=1.5e-2)
        gates = extraction_gate_list(rotated_surface(d), h)
        dj = jds.DeviceStreamingDecoder.from_dem(h, lz, gates, **kw)
        dt = tds.DeviceStreamingDecoder.from_dem(h, lz, gates, device="cpu",
                                                 **kw)
    else:
        kw = dict(window=8, commit=4, p_space=0.004, p_time=0.004)
        dj = jds.DeviceStreamingDecoder(h, lz, **kw)
        dt = tds.DeviceStreamingDecoder(h, lz, device="cpu", **kw)
    assert dt._n_carry == dj._n_carry == (2 if kind == "wide" else 1)
    assert bool(dt._mid.stencil.chunks) == (kind == "wide")
    _assert_tree_equal(dt._mid, dj._mid)
    if kind == "dem":
        final = circuit_level_graph(h, gates, rounds=4, p_gate2=3e-3,
                                    p_meas=1.5e-2, logicals=lz)
    else:
        final = jst._window_graph(h, lz, 5, False, 0.004, 0.004)[0]
    _assert_tree_equal(dt._final_graph(5), jds.build_device_graph(final))


def _jax_decoder(h, lz, **kw):
    """The JAX decoder with its mid-window decode on the Mosaic full
    kernel, run in interpret mode."""
    dec = jds.DeviceStreamingDecoder(h, lz, **kw)
    dec._mid_fn = partial(decode_stencil_pallas_full, dec._mid,
                          interpret=True)
    return dec


def test_decode_stream_bit_identical():
    h, lz = _code(5)
    dets = _np_stream(h, 31, 128, 23, 0.008, 0.008)  # 24 slices
    kw = dict(window=8, commit=4, p_space=0.008, p_time=0.008)
    obs_j = _jax_decoder(h, lz, **kw).decode_stream(dets)
    dec = tds.DeviceStreamingDecoder(h, lz, device="cpu", **kw)
    obs_t = dec.decode_stream(torch.as_tensor(dets))
    np.testing.assert_array_equal(obs_t, obs_j)
    assert obs_t.dtype == np.uint32 and obs_t.any()
    with pytest.raises(ValueError, match="detectors/slice"):
        dec.decode_stream(torch.as_tensor(dets[:, :, :-1]))


def test_wide_code_two_lane_carry_bit_identical():
    # d=9 has r = 40 > 30 checks: the carry splits across two label lanes,
    # the first of them spilled into a chunk of the mid-window graph.
    h, lz = _code(9)
    dets = _np_stream(h, 32, 32, 12, 0.006, 0.006)  # one mid window + final
    jdec = _jax_decoder(h, lz, window=8, commit=4)
    obs_j = jdec.decode_stream(dets)
    dec = tds.DeviceStreamingDecoder(h, lz, window=8, commit=4, device="cpu")
    assert dec._n_carry == 2 and len(dec._mid.stencil.chunks) == 1
    obs_t = dec.decode_stream(torch.as_tensor(dets))
    np.testing.assert_array_equal(obs_t, obs_j)
    # both carry lanes are in use (the stream's equality above rests on them)
    _, carry, conv = dec.window_step(
        torch.as_tensor(dets[:, :8]), torch.zeros((32, 40), dtype=torch.uint8),
        torch.zeros(32, dtype=torch.int32))
    assert conv.all() and carry[:, :30].any() and carry[:, 30:].any()


def test_window_step_does_not_write_its_window():
    h, lz = _code(3)
    dec = tds.DeviceStreamingDecoder(h, lz, window=4, commit=2, device="cpu")
    buf = torch.as_tensor(_np_stream(h, 33, 16, 7, 0.05, 0.05))
    before = buf.clone()
    carry = torch.ones((16, h.shape[0]), dtype=torch.uint8)
    dec.window_step(buf[:, 2:6], carry, torch.zeros(16, dtype=torch.int32))
    dec.final_step(buf[:, 4:], carry, torch.zeros(16, dtype=torch.int32), 4)
    assert torch.equal(buf, before)


def test_decoder_argument_checks():
    h, lz = _code(3)
    with pytest.raises(ValueError, match="window > commit"):
        tds.DeviceStreamingDecoder(h, lz, window=3, commit=3, device="cpu")
    with pytest.raises(ValueError, match="one observable"):
        tds.DeviceStreamingDecoder(h, np.vstack([lz, lz]), device="cpu")
    with pytest.raises(ValueError, match="rounds >= window"):
        tds.stream_memory_rate(h, lz, 0.01, 0.01, rounds=4, batch=8,
                               device="cpu")
    with pytest.raises(ValueError, match="window > commit"):
        tst.StreamingDecoder(h, lz, window=3, commit=3)
    with pytest.raises(ValueError, match="detectors/slice"):
        tst.StreamingDecoder(h, lz).decode_stream(
            np.zeros((2, 8, h.shape[0] - 1), np.uint8))


@pytest.mark.parametrize("d,weighted,use_native", [(5, False, True),
                                                   (5, True, True),
                                                   (3, True, False)])
def test_host_streaming_decoder_bit_identical(d, weighted, use_native):
    # the host decoder (windows on the host union-find) against the
    # reference's, on shared detectors; the last window is shorter
    h, lz = _code(d)
    dets = _np_stream(h, 40 + d, 96, 21, 0.008, 0.008)  # 22 slices
    kw = dict(window=8, commit=4)
    if weighted:
        kw.update(p_space=0.008, p_time=0.004)
    want = jst.StreamingDecoder(h, lz, use_native=True, **kw).decode_stream(
        dets)
    got = tst.StreamingDecoder(h, lz, use_native=use_native,
                               **kw).decode_stream(dets)
    assert got.dtype == np.uint32 and want.any()
    np.testing.assert_array_equal(got, want)


def _two_sample_ok(f1, n1, f2, n2):
    pooled = (f1 * n1 + f2 * n2) / (n1 + n2)
    spread = Z999 * math.sqrt(pooled * (1 - pooled) * (1 / n1 + 1 / n2))
    return abs(f1 - f2) <= spread


def test_sampled_stream_matches_jax_statistically():
    # Same physics, different generators: the mean defect density and the
    # logical parity rate agree within 99.9%.
    import jax

    h, lz = _code(3)
    B, R = 4096, 10
    dj, pj = jst.sample_phenomenological_stream(jax.random.key(1), 0.03,
                                                0.03, B, R, h, lz)
    gen = torch.Generator().manual_seed(1)
    dt, pt = tst.sample_phenomenological_stream(gen, 0.03, 0.03, B, R, h, lz)
    assert dt.shape == tuple(dj.shape) and dt.dtype == torch.uint8
    assert pt.shape == tuple(pj.shape)
    n = dt.numel()
    assert _two_sample_ok(float(dt.float().mean()), n,
                          float(np.asarray(dj).mean()), n)
    assert _two_sample_ok(float(pt.float().mean()), B,
                          float(np.asarray(pj).mean()), B)


def test_stream_memory_rate_matches_jax_rate():
    h, lz = _code(3)
    kw = dict(rounds=30, batch=2048, window=8, commit=4)
    rj = jds.stream_memory_rate(h, lz, 0.01, 0.01, seed=2, **kw)
    rt = tds.stream_memory_rate(h, lz, 0.01, 0.01, seed=2, device="cpu",
                                **kw)
    assert {k: rt[k] for k in ("rounds", "samples", "window", "commit")} == \
        {k: rj[k] for k in ("rounds", "samples", "window", "commit")}
    assert rt["logical_fail"] > 0
    assert _two_sample_ok(rt["logical_fail"], 2048, rj["logical_fail"], 2048)


def test_stream_memory_rate_dem_matches_jax_rate():
    kw = dict(rounds=14, batch=2048, window=8, commit=4)
    rj = jds.stream_memory_rate_dem(
        rotated_surface(3), JNoiseModel(p_gate2=6e-3, p_meas=2e-2), seed=3,
        **kw)
    rt = tds.stream_memory_rate_dem(
        t_rotated_surface(3), TNoiseModel(p_gate2=6e-3, p_meas=2e-2), seed=3,
        device="cpu", **kw)
    assert rt["logical_fail"] > 0
    assert _two_sample_ok(rt["logical_fail"], 2048, rj["logical_fail"], 2048)
    with pytest.raises(ValueError, match="idle"):
        tds.stream_memory_rate_dem(
            t_rotated_surface(3), TNoiseModel(p_gate2=1e-3, p_idle=1e-3),
            rounds=8, batch=8, device="cpu")


def test_stream_memory_rate_tail_rounds():
    # rounds that leave a tail shorter than the commit: the final window
    # takes them; and a distance-5 memory fails less than a distance-3 one
    res = {}
    for d in (3, 5):
        h, lz = _code(d)
        res[d] = tds.stream_memory_rate(h, lz, 0.006, 0.006, rounds=27,
                                        batch=1024, seed=4, device="cpu")
    assert res[3]["rounds"] == 27
    assert res[5]["logical_fail"] < res[3]["logical_fail"] < 0.5
