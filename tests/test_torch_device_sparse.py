"""The port's defect-granular (sparse) and hybrid decoders against the JAX
package's.

Exact comparisons throughout: the tables are integer code (scipy's
Dijkstra on integer weights is exact), and the plain decode is a
line-for-line port of the reference's `_growth_core`, which the JAX
package runs on the CPU with ``backend='xla'`` — the same trace its Mosaic
kernel runs (tests/test_device_sparse.py holds the two bit-identical).
"""

import numpy as np
import pytest
import torch

from qcss_tpu.codes.families import rotated_surface
from qcss_tpu.decode import device_sparse as jds
from qcss_tpu.decode.dem import circuit_level_graph, extraction_gate_list
from qcss_tpu.decode.uf import spacetime_graph
from qcss_tpu_torch.decode import device_sparse as tds
from qcss_tpu_torch.decode import uf as tuf


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The suite runs in several worker processes at once; torch's intra-op
    # threads would oversubscribe the cores and spin, and these tensors are
    # small enough that one thread is fastest anyway.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph(kind, d):
    code = rotated_surface(d)
    raw = code.raw_parity_check_c2
    lz = code.z_operator_matrix()
    if kind == "dem":
        g = circuit_level_graph(raw, extraction_gate_list(code, raw), d,
                                p_gate2=1e-2, p_meas=1e-2, logicals=lz)
    else:
        g = spacetime_graph(raw, lz, d)
    return g, tuf.MatchingGraph(
        num_nodes=g.num_nodes, edges=g.edges, edge_qubit=g.edge_qubit,
        edge_obs=g.edge_obs, n_qubits=g.n_qubits, edge_weight=g.edge_weight)


def _dets(g, B, p, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((B, g.num_nodes)) < p).astype(np.uint8)


@pytest.mark.parametrize("kind,d", [("dem", 3), ("dem", 5),
                                    ("spacetime", 5)])
def test_build_sparse_tables_equal(kind, d):
    gj, gt = _graph(kind, d)
    tj, tt = jds.build_sparse_tables(gj), tds.build_sparse_tables(gt)
    for name in ("dist", "phi", "bdist", "bside"):
        a, b = getattr(tt, name), getattr(tj, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert tt.num_nodes == tj.num_nodes


@pytest.mark.parametrize("d_max", [2, 8, 16])
def test_plain_sparse_decode_bit_identical(d_max):
    # d_max 2 and 8 overflow most shots at this density; overflow shots
    # must still agree on obs (decoded from their first d_max defects).
    gj, gt = _graph("dem", 5)
    dets = _dets(gj, 2048, 0.05, seed=d_max)
    obs_j, conv_j = jds.make_sparse_obs_decoder(
        gj, d_max=d_max, backend="xla")(dets)
    obs_t, conv_t = tds.make_sparse_obs_decoder(gt, d_max=d_max,
                                                device="cpu")(
        torch.as_tensor(dets))
    np.testing.assert_array_equal(obs_t.numpy(), np.asarray(obs_j))
    np.testing.assert_array_equal(conv_t.numpy(), np.asarray(conv_j))
    if d_max < 16:
        assert not conv_t.all()  # overflow exercised


def test_sparse_spacetime_graph_bit_identical():
    gj, gt = _graph("spacetime", 5)
    dets = _dets(gj, 1024, 0.04, seed=4)
    obs_j, conv_j = jds.make_sparse_obs_decoder(
        gj, d_max=16, backend="xla")(dets)
    obs_t, conv_t = tds.make_sparse_obs_decoder(gt, d_max=16, device="cpu")(
        torch.as_tensor(dets))
    np.testing.assert_array_equal(obs_t.numpy(), np.asarray(obs_j))
    np.testing.assert_array_equal(conv_t.numpy(), np.asarray(conv_j))


def test_tables_from_numpy_decode_like_jax():
    gj, _ = _graph("dem", 3)
    tj = jds.build_sparse_tables(gj)
    tt = tds.sparse_tables_from_numpy(tj.dist, tj.phi, tj.bdist, tj.bside,
                                      tj.num_nodes)
    dets = _dets(gj, 1024, 0.1, seed=9)
    obs_j, conv_j = jds.make_sparse_obs_decoder(
        gj, d_max=8, backend="xla")(dets)
    obs_t, conv_t = tds.sparse_decoder_from_tables(tt, d_max=8, device="cpu")(
        torch.as_tensor(dets))
    np.testing.assert_array_equal(obs_t.numpy(), np.asarray(obs_j))
    np.testing.assert_array_equal(conv_t.numpy(), np.asarray(conv_j))


@pytest.mark.parametrize("d_max,p", [(4, 0.05), (16, 0.02)],
                         ids=["dense-rescue", "quiet"])
def test_hybrid_bit_identical(d_max, p):
    gj, gt = _graph("dem", 5)
    dets = _dets(gj, 1024, p, seed=31)
    obs_j, conv_j = jds.make_hybrid_obs_decoder(gj, d_max=d_max)(dets)
    obs_t, conv_t = tds.make_hybrid_obs_decoder(gt, d_max=d_max,
                                                device="cpu")(
        torch.as_tensor(dets))
    np.testing.assert_array_equal(obs_t.numpy(), np.asarray(obs_j))
    np.testing.assert_array_equal(conv_t.numpy(), np.asarray(conv_j))
    assert conv_t.all()



@pytest.mark.cuda
@pytest.mark.parametrize("d_max", [8, 16])
def test_cuda_sparse_kernel_matches_jax(d_max):
    # K2 on the card against the JAX package's XLA decode on the CPU,
    # overflow shots included.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from qcss_tpu_torch.decode import device_sparse_cuda

    gj, gt = _graph("dem", 5)
    dets = _dets(gj, 2048, 0.05, seed=50 + d_max)
    obs_j, conv_j = jds.make_sparse_obs_decoder(
        gj, d_max=d_max, backend="xla")(dets)
    before = device_sparse_cuda.launches
    obs_t, conv_t = tds.make_sparse_obs_decoder(
        gt, d_max=d_max, device="cuda")(torch.as_tensor(dets, device="cuda"))
    assert device_sparse_cuda.launches == before + 1
    np.testing.assert_array_equal(obs_t.cpu().numpy(), np.asarray(obs_j))
    np.testing.assert_array_equal(conv_t.cpu().numpy(), np.asarray(conv_j))
