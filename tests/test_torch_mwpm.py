"""The port's exact matching decoder and calibration against the JAX
package's, exactly on shared numpy inputs: the golds of tests/test_mwpm.py
(every error of weight <= 2 at d=5 through `MWPMOracle`; random shots on
the weighted d=5 spacetime graph through the native decoder and the
Python solvers, DP and blossom; the lazy, APSP-free mode) and of
tests/test_calibrate.py (`estimate_edge_probs`, `calibrated_graph`)."""

from itertools import combinations

import numpy as np
import pytest
import torch

from qcss_tpu.decode import calibrate as jcal
from qcss_tpu.decode import mwpm as jmw
from qcss_tpu_torch.codes.families import rotated_surface
from qcss_tpu_torch.decode import calibrate as tcal
from qcss_tpu_torch.decode import mwpm as tmw
from qcss_tpu_torch.decode import uf as tuf
from test_torch_uf import _pair


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # several worker processes run at once; see test_torch_device_uf.py
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _surface(d):
    code = rotated_surface(d)
    return code, code.raw_parity_check_c2, code.z_operator_matrix()


def test_oracle_identical_on_all_weight_two_errors():
    code, h, lz = _surface(5)
    errs = []
    for w in (1, 2):
        for sup in combinations(range(code.n), w):
            e = np.zeros(code.n, np.uint8)
            e[list(sup)] = 1
            errs.append(e)
    errs = np.asarray(errs)
    syn = ((errs @ h.T) & 1).astype(np.uint8)
    gj, gt = _pair(tuf.graph_from_checks(h, lz))
    obs_j, ok_j = jmw.MWPMOracle(gj).decode_batch(syn)
    obs_t, ok_t = tmw.MWPMOracle(gt).decode_batch(syn)
    np.testing.assert_array_equal(obs_t, obs_j)
    np.testing.assert_array_equal(ok_t, ok_j)
    assert ok_t.all() and ((obs_t & 1) == (errs @ lz[0]) % 2).all()
    two = syn[syn.sum(1) >= 2][:4]
    _, ok = tmw.MWPMOracle(gt, max_defects=1).decode_batch(two)
    assert len(two) == 4 and not ok.any()


def _weighted_shots(B, kmax, seed):
    code, h, lz = _surface(5)
    g = tuf.spacetime_graph(h, lz, 5, p_space=2e-3, p_time=1e-2)
    rng = np.random.default_rng(seed)
    syn = np.zeros((B, g.num_nodes), np.uint8)
    for b in range(B):
        k = int(rng.integers(0, kmax))
        syn[b, rng.choice(g.num_nodes, size=k, replace=False)] = 1
    return g, syn


@pytest.mark.parametrize("method,kmax", [("auto", 24), ("dp", 10),
                                         ("blossom", 16)])
def test_decoder_identical(method, kmax):
    # 'auto' spans the DP and blossom regimes, native and in Python
    g, syn = _weighted_shots(48, kmax, seed=len(method))
    gj, gt = _pair(g)
    natives = (True, False) if method == "auto" else (False,)
    for use_native in natives:
        want = jmw.MWPMDecoder(gj, method=method,
                               use_native=use_native).decode_batch(syn)
        dec = tmw.MWPMDecoder(gt, method=method, use_native=use_native)
        assert (dec._native is not None) == use_native
        got = dec.decode_batch(syn)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_solvers_and_decomposition_identical():
    g, syn = _weighted_shots(24, 12, seed=0)
    gj, gt = _pair(g)
    dj, dt = jmw.MWPMDecoder(gj, method="dp"), tmw.MWPMDecoder(gt, method="dp")
    for s in syn:
        defects = np.nonzero(s)[0]
        if not len(defects):
            continue
        graph_t, graph_j = dt._defect_graph(defects), dj._defect_graph(defects)
        for a, b in zip(graph_t, graph_j):
            np.testing.assert_array_equal(a, b)
        assert dt._solve_dp(*graph_t) == dj._solve_dp(*graph_j)
        bt, bj = dt._solve_blossom(*graph_t), dj._solve_blossom(*graph_j)
        assert bt[0] == bj[0] == dt._solve_dp(*graph_t)[0]
        assert dt._decompose(graph_t[0], graph_t[2]) == dj._decompose(
            graph_j[0], graph_j[2])


def test_lazy_mode_identical(monkeypatch):
    _, h, lz = _surface(5)
    g = tuf.spacetime_graph(h, lz, 5)
    rng = np.random.default_rng(3)
    dets = (rng.random((64, g.num_nodes)) < 0.03).astype(np.uint8)
    gj, gt = _pair(g)
    apsp = tmw.MWPMDecoder(gt).decode_batch(dets)
    monkeypatch.setenv("QCSS_MWPM_FORCE_LAZY", "1")
    want = jmw.MWPMDecoder(gj).decode_batch(dets)
    got = tmw.MWPMDecoder(gt).decode_batch(dets)
    for a, b, c in zip(got, want, apsp):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_forced_solver_rejects_native():
    _, h, lz = _surface(3)
    with pytest.raises(ValueError, match="auto"):
        tmw.MWPMDecoder(tuf.graph_from_checks(h, lz), method="dp",
                        use_native=True)


def test_calibration_identical():
    code, h, lz = _surface(3)
    rounds, B = 4, 4096
    rng = np.random.default_rng(8)
    r, n = h.shape
    cum = np.zeros((B, n), np.uint8)
    prev = np.zeros((B, r), np.uint8)
    dets = []
    for t in range(rounds + 1):
        cum ^= (rng.random((B, n)) < 0.03).astype(np.uint8)
        syn = ((cum @ h.T) & 1).astype(np.uint8)
        if t < rounds:
            syn ^= (rng.random((B, r)) < 0.01).astype(np.uint8)
        dets.append(syn ^ prev)
        prev = syn
    dets = np.concatenate(dets, axis=1)
    gj, gt = _pair(tuf.spacetime_graph(h, lz, rounds))
    np.testing.assert_array_equal(tcal.estimate_edge_probs(dets, gt),
                                  jcal.estimate_edge_probs(dets, gj))
    cj, ct = jcal.calibrated_graph(gj, dets), tcal.calibrated_graph(gt, dets)
    assert len(set(ct.edge_weight.tolist())) > 1
    for attr in ("edges", "edge_qubit", "edge_obs", "edge_weight"):
        np.testing.assert_array_equal(getattr(ct, attr), getattr(cj, attr))
    with pytest.raises(ValueError):
        tcal.estimate_edge_probs(np.zeros((8, 3), np.uint8), gt)
