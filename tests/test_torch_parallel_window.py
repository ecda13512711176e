"""The port's parallel-window decoder against the JAX package's.

* `_pw_graph` and every window shape's device graph (first, interior,
  last, seam, and the one-window fallback) must be array-equal to the
  reference's;
* `decode_stream` must be bit-identical to the reference's on shared
  detectors. Off the TPU the reference decodes graphs with spilled lanes
  in `_decode_unpacked`, whose forests differ from the stencil kernel's
  inside a cluster, so here its windows run through its own stencil
  kernel, `decode_stencil_pallas_full`, in interpret mode (patched into
  the test's view of the reference module, at d=3 to keep that cheap);
  the port decodes on the CPU in the stencil kernel's plain version;
* `parallel_window_memory_rate` draws from a torch.Generator, so its rate
  must fall inside the 99.9% Wilson interval of the reference's.
"""

import jax
import numpy as np
import pytest
import torch

from qcss_tpu.codes.families import rotated_surface
from qcss_tpu.decode import parallel_window as jpw
from qcss_tpu.decode.device_uf_pallas import decode_stencil_pallas_full
from qcss_tpu_torch.decode import parallel_window as tpw
from test_torch_memory import _wilson
from test_torch_streaming import _assert_tree_equal, _np_stream


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # several worker processes run at once; see test_torch_device_uf.py
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _quick_reference_compiles():
    # integer reference programs: see test_torch_device_uf.py
    saved = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", saved)


def _code(d):
    code = rotated_surface(d)
    return (np.asarray(code.raw_parity_check_c2, np.uint8),
            np.asarray(code.z_operator_matrix(), np.uint8))


@pytest.mark.parametrize("kw", [
    dict(open_past=False, open_future=True, commit_lo=0, commit_hi=3),
    dict(open_past=True, open_future=True, commit_lo=4, commit_hi=7),
    dict(open_past=True, open_future=False, commit_lo=4, commit_hi=9),
    dict(open_past=False, open_future=False, commit_lo=0, commit_hi=6)],
    ids=["first", "interior", "last", "seam"])
@pytest.mark.parametrize("probs", [(None, None), (0.004, 0.01)],
                         ids=["unweighted", "weighted"])
def test_pw_graph_equal(kw, probs):
    h, lz = _code(5)
    slices = kw["commit_hi"] + (4 if kw["open_future"] else 0)
    gt, lt, rt = tpw._pw_graph(h, lz, slices, p_space=probs[0],
                               p_time=probs[1], **kw)
    gj, lj, rj = jpw._pw_graph(h, lz, slices, p_space=probs[0],
                               p_time=probs[1], **kw)
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_array_equal(rt, rj)
    assert gt.num_nodes == gj.num_nodes and gt.n_qubits == gj.n_qubits
    for name in ("edges", "edge_qubit", "edge_obs", "edge_weight"):
        np.testing.assert_array_equal(getattr(gt, name), getattr(gj, name))


def _jax_graph(fn):
    """The device graph inside one of the reference's jitted windows."""
    return fn.__wrapped__.args[0]


@pytest.mark.parametrize("d,core,buf", [(3, 3, 3), (9, 3, 2)])
def test_window_graphs_equal(d, core, buf):
    # d=9 has r = 40 > 30 checks: two carry lanes a side, all spilled
    h, lz = _code(d)
    kw = dict(core=core, buf=buf, p_space=0.004, p_time=0.008)
    jdec = jpw.ParallelWindowDecoder(h, lz, **kw)
    tdec = tpw.ParallelWindowDecoder(h, lz, device="cpu", **kw)
    assert tdec._ext == jdec._ext and tdec._n_carry == jdec._n_carry
    for name in ("_first", "_mid", "_seam"):
        _assert_tree_equal(getattr(tdec, name),
                           _jax_graph(getattr(jdec, name)))
    _assert_tree_equal(tdec._last_graph(core + 2),
                       _jax_graph(jdec._last_fn(core + 2)))
    _assert_tree_equal(tdec._whole_graph(5), _jax_graph(jdec._whole_fn(5)))
    # d=3: eight-bit carries fit in the packed word; d=9: they spill
    assert bool(tdec._mid.stencil.chunks) == (d == 9)
    assert not tdec._seam.stencil.chunks


@pytest.fixture
def jax_interpret(monkeypatch):
    """Route the reference's window decodes through its stencil kernel in
    interpret mode (the route it takes on a TPU)."""
    monkeypatch.setattr(
        jpw, "decode_labels",
        lambda dg, dets: decode_stencil_pallas_full(dg, dets,
                                                    interpret=True))


@pytest.mark.parametrize("d,slices,weighted", [(3, 22, False),
                                               (3, 17, True),
                                               (5, 17, False)])
def test_decode_stream_bit_identical(jax_interpret, d, slices, weighted):
    # core 3, buf 3: 22 slices are K = 4 windows (two interior, and a
    # wider last core), 17 are K = 3 with a last core of 5; at d=5 the
    # 24-bit carries of the first, interior and last windows spill
    h, lz = _code(d)
    kw = dict(core=3, buf=3)
    if weighted:
        kw.update(p_space=0.01, p_time=0.02)
    dets = _np_stream(h, 50 + slices, 48, slices - 1, 0.02, 0.02)
    want = jpw.ParallelWindowDecoder(h, lz, **kw).decode_stream(dets)
    dec = tpw.ParallelWindowDecoder(h, lz, device="cpu", **kw)
    assert bool(dec._mid.stencil.chunks) == (d == 5)
    got = dec.decode_stream(dets)
    assert got.dtype == np.uint32 and want.any()
    np.testing.assert_array_equal(got, want)
    obs, conv = dec.decode_tensors(torch.as_tensor(dets))
    assert bool(conv) and obs.dtype == torch.int32
    np.testing.assert_array_equal(obs.numpy().astype(np.uint32), want)


def test_short_stream_decodes_as_one_window(jax_interpret):
    h, lz = _code(3)
    dets = _np_stream(h, 7, 32, 4, 0.03, 0.03)  # 5 slices: K < 2
    want = jpw.ParallelWindowDecoder(h, lz, core=8, buf=4).decode_stream(dets)
    got = tpw.ParallelWindowDecoder(h, lz, core=8, buf=4,
                                    device="cpu").decode_stream(dets)
    np.testing.assert_array_equal(got, want)


def test_single_faults_decoded():
    # wherever a data or measurement fault lands relative to the cores,
    # seams and the widened last core (the reference's golds)
    h, lz = _code(3)
    r = h.shape[0]
    pw = tpw.ParallelWindowDecoder(h, lz, core=3, buf=3, device="cpu")
    assert (pw.decode_stream(np.zeros((4, 41, r), np.uint8)) == 0).all()
    data, meas = [], []
    for t in (0, 2, 3, 5, 6, 9, 14, 19, 21, 22):
        for q in (0, 3, 4, 8):
            x = np.zeros((23, r), np.uint8)
            x[t] = h[:, q]
            data.append((x, lz[0, q]))
    for t in range(1, 21):
        for c in (0, 2, 3):
            x = np.zeros((23, r), np.uint8)
            x[t, c] = x[t + 1, c] = 1
            meas.append((x, 0))
    dets = np.stack([x for x, _ in data + meas])
    want = np.array([w for _, w in data + meas], np.uint32)
    np.testing.assert_array_equal(pw.decode_stream(dets) & 1, want)


def test_bad_params_raise():
    h, lz = _code(3)
    with pytest.raises(ValueError):
        tpw.ParallelWindowDecoder(h, lz, core=0, buf=3, device="cpu")
    with pytest.raises(ValueError, match="one observable"):
        tpw.ParallelWindowDecoder(h, np.vstack([lz, lz]), device="cpu")
    h_ring = np.array([[1, 1, 0], [0, 1, 1], [1, 0, 1]], np.uint8)
    with pytest.raises(ValueError, match="boundary"):
        tpw.ParallelWindowDecoder(h_ring, np.array([[1, 1, 1]], np.uint8),
                                  device="cpu")
    pw = tpw.ParallelWindowDecoder(h, lz, device="cpu")
    with pytest.raises(ValueError, match="detectors/slice"):
        pw.decode_stream(np.zeros((2, 20, h.shape[0] - 1), np.uint8))


def test_memory_rate_within_wilson_of_jax():
    h, lz = _code(3)
    kw = dict(rounds=24, core=3, buf=5, seed=11)
    Bj, Bt = 2048, 8192
    rj = jpw.parallel_window_memory_rate(h, lz, 0.008, 0.008, batch=Bj, **kw)
    rt = tpw.parallel_window_memory_rate(h, lz, 0.008, 0.008, batch=Bt,
                                         device="cpu", **kw)
    assert rt["samples"] == Bt and rt["rounds"] == 24
    lo, hi = _wilson(round(rj["logical_fail"] * Bj), Bj)
    assert 0 < rt["logical_fail"] and lo <= rt["logical_fail"] <= hi, (
        rj["logical_fail"], rt["logical_fail"], lo, hi)
