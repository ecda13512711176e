"""The port's host union-find (`qcss_tpu_torch.decode.uf`) against the JAX
package's.

* `UFDecoder`, native and pure Python, must return the reference's
  corrections and observables exactly on shared numpy syndromes:
  code capacity (surface d=3, d=5, every error of weight <= t and random
  ones), the phenomenological spacetime graph at d=3, R=3, the weighted
  circuit-level DEM graph at d=3, per-shot weights, and any thread count;
* the samplers draw from a torch.Generator, not JAX's keys, so their
  rates must fall inside the 99.9% Wilson interval (z = 3.2905) of the
  reference's at the same settings.
"""

from itertools import combinations

import numpy as np
import pytest
import torch

from qcss_tpu.codes.families import rotated_surface as jax_surface
from qcss_tpu.decode import uf as juf
from qcss_tpu.decode.dem import circuit_level_graph, extraction_gate_list
from qcss_tpu_torch.codes.families import rotated_surface
from qcss_tpu_torch.decode import uf as tuf
from test_torch_memory import _wilson


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # several worker processes run at once; see test_torch_device_uf.py
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(g):
    """The JAX package's graph and the port's, from the same arrays."""
    kw = dict(num_nodes=g.num_nodes, edges=g.edges, edge_qubit=g.edge_qubit,
              edge_obs=g.edge_obs, n_qubits=g.n_qubits,
              edge_weight=g.edge_weight)
    return juf.MatchingGraph(**kw), tuf.MatchingGraph(**kw)


def _assert_same_decode(g, syn, shot_weights=None, threads=(None,)):
    """The reference's native decode against the port's, native (at each
    thread count) and pure Python: corrections and observables equal."""
    gj, gt = _pair(g)
    want_c, want_o = juf.UFDecoder(gj, use_native=True).decode_batch(
        syn, shot_weights=shot_weights)
    for use_native in (True, False):
        for n_threads in (threads if use_native else (None,)):
            got_c, got_o = tuf.UFDecoder(gt, use_native=use_native
                                         ).decode_batch(
                syn, n_threads=n_threads, shot_weights=shot_weights)
            np.testing.assert_array_equal(got_c, want_c)
            np.testing.assert_array_equal(got_o, want_o)
    return want_o


def _code_capacity(d):
    code = rotated_surface(d)
    h = code.raw_parity_check_c2
    lz = code.z_operator_matrix()
    return code, h, lz, tuf.graph_from_checks(h, lz)


@pytest.mark.parametrize("d", [3, 5])
def test_code_capacity_identical(d):
    code, h, lz, g = _code_capacity(d)
    errs = [np.zeros(code.n, np.uint8)]
    for w in range(1, (d - 1) // 2 + 1):
        for sup in combinations(range(code.n), w):
            e = np.zeros(code.n, np.uint8)
            e[list(sup)] = 1
            errs.append(e)
    rng = np.random.default_rng(d)
    errs = np.concatenate(
        [np.asarray(errs), (rng.random((128, code.n)) < 0.1).astype(np.uint8)])
    syn = ((errs.astype(np.int64) @ h.T) & 1).astype(np.uint8)
    obs = _assert_same_decode(g, syn)
    n_low = len(errs) - 128
    np.testing.assert_array_equal(obs[:n_low], (errs[:n_low] @ lz[0]) % 2)


def test_spacetime_identical():
    code = rotated_surface(3)
    g = tuf.spacetime_graph(code.raw_parity_check_c2,
                            code.z_operator_matrix(), 3)
    rng = np.random.default_rng(9)
    syn = (rng.random((256, g.num_nodes)) < 0.05).astype(np.uint8)
    _assert_same_decode(g, syn)


def _dem_graph_and_detectors(batch, seed):
    """The weighted circuit-level DEM graph at d=3, R=3, and detectors made
    by XORing a few random fault edges' endpoints per shot."""
    code = jax_surface(3)
    raw = code.raw_parity_check_c2
    g = circuit_level_graph(raw, extraction_gate_list(code, raw), 3,
                            p_gate2=2e-3, p_meas=1e-2,
                            logicals=code.z_operator_matrix())
    rng = np.random.default_rng(seed)
    syn = np.zeros((batch, g.num_nodes), np.uint8)
    for b in range(batch):
        for e in rng.integers(0, g.num_edges, rng.integers(0, 5)):
            for v in g.edges[e]:
                if v >= 0:
                    syn[b, v] ^= 1
    return g, syn


def test_dem_graph_identical_at_any_thread_count():
    g, syn = _dem_graph_and_detectors(256, 3)
    assert len(set(g.edge_weight.tolist())) > 1  # weighted
    _assert_same_decode(g, syn, threads=(None, 1, 3))


def test_shot_weights_identical():
    g, syn = _dem_graph_and_detectors(96, 5)
    rng = np.random.default_rng(6)
    w = rng.integers(1, 12, (96, g.num_edges)).astype(np.uint8)
    _assert_same_decode(g, syn, shot_weights=w)
    with pytest.raises(ValueError, match="shot_weights"):
        tuf.UFDecoder(_pair(g)[1]).decode_batch(syn, shot_weights=w[:, 1:])


def test_pack_parity_identical():
    rng = np.random.default_rng(0)
    par = (rng.random((64, 5)) < 0.5).astype(np.uint8)
    np.testing.assert_array_equal(tuf._pack_parity(par),
                                  juf._pack_parity(par))


def test_code_capacity_rate_within_wilson_of_jax():
    p, Bj, Bt = 0.08, 8192, 32768
    rj = juf.uf_logical_error_rate(jax_surface(5), p, samples=Bj, batch=Bj,
                                   seed=3)
    rt = tuf.uf_logical_error_rate(rotated_surface(5), p, samples=Bt,
                                   batch=Bt // 2, seed=3, device="cpu")
    assert rt["samples"] == Bt
    for k in ("x_fail", "z_fail", "word_fail"):
        lo, hi = _wilson(round(rj[k] * Bj), Bj)
        assert 0 < rt[k] and lo <= rt[k] <= hi, (k, rj[k], rt[k], lo, hi)


def test_phenomenological_rate_within_wilson_of_jax():
    p, Bj, Bt = 0.025, 4096, 16384
    rj = juf.uf_phenomenological_error_rate(jax_surface(3), p, samples=Bj,
                                            batch=Bj, seed=4)
    rt = tuf.uf_phenomenological_error_rate(rotated_surface(3), p,
                                            samples=Bt, batch=Bt // 2,
                                            seed=4, device="cpu")
    assert rt["samples"] == Bt and rt["rounds"] == rj["rounds"] == 3
    lo, hi = _wilson(round(rj["logical_fail"] * Bj), Bj)
    assert 0 < rt["logical_fail"] and lo <= rt["logical_fail"] <= hi, (
        rj["logical_fail"], rt["logical_fail"], lo, hi)


def test_zero_noise_zero_failures():
    r = tuf.uf_logical_error_rate(rotated_surface(3), 0.0, samples=512,
                                  batch=256, device="cpu")
    assert r["word_fail"] == 0.0 and r["samples"] == 512
