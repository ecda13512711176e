"""The port's exact per-observable fault distance
(`qcss_tpu_torch.decode.fault_distance`) against the JAX package's, on
the CPU.

Distances and their multiplicities must equal the reference's on the
graphs tests/test_fault_distance.py pins (the repetition line, the
surface spacetime graph, the bespoke T gadget's sectors), here at d=3
only: the builders are bit-identical to the reference's
(tests/test_torch_surgery.py), so larger instances add nothing the
reference's own tests do not show. The witness differs by design: the
reference keys each double-cover hop by its endpoints alone
(qcss_tpu/decode/fault_distance.py:118-123; ADVICE.md, round 5), so
between two detectors joined by parallel edges of different labels its
witness can miss the odd cycle; the port keys hops on (u, v, label).
"""

import numpy as np
import pytest
import torch

from qcss_tpu.decode import fault_distance as jfd
from qcss_tpu.decode.uf import MatchingGraph as JGraph
from qcss_tpu.experiments import patches as jpatches
from qcss_tpu.experiments import surgery_t as jst
from qcss_tpu_torch.codes import families as tfam
from qcss_tpu_torch.decode import fault_distance as tfd
from qcss_tpu_torch.decode.uf import MatchingGraph as TGraph
from qcss_tpu_torch.decode.uf import spacetime_graph
from qcss_tpu_torch.experiments import patches as tpatches
from qcss_tpu_torch.experiments import surgery_t as tst


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # several worker processes run at once; see test_torch_device_uf.py
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph(cls, num_nodes, edges, obs, weight=None):
    return cls(num_nodes=num_nodes, edges=np.asarray(edges, np.int32),
               edge_qubit=np.arange(len(edges), dtype=np.int32),
               edge_obs=np.asarray(obs, np.uint32), n_qubits=len(edges),
               edge_weight=weight)


def _is_odd_cycle(g, wit, bit=0):
    """Every real detector touched an even number of times, and the
    observable label summed to 1."""
    deg = np.zeros(g.num_nodes, np.int64)
    par = 0
    for e in wit:
        for x in g.edges[e]:
            if x >= 0:
                deg[x] += 1
        par ^= (int(g.edge_obs[e]) >> bit) & 1
    return bool((deg % 2 == 0).all()) and par == 1


@pytest.mark.parametrize("L", [3, 5, 9])
def test_repetition_line(L):
    # stands in for test_fault_distance.py::TestKnownGraphs::
    # test_repetition_line: the full-line crossing, distance L
    edges = [(-1, 0)] + [(i, i + 1) for i in range(L - 2)] + [(L - 2, -1)]
    obs = np.ones(len(edges), np.uint32)
    tj = jfd.observable_fault_distance(_graph(JGraph, L - 1, edges, obs), 0)
    tt = tfd.observable_fault_distance(_graph(TGraph, L - 1, edges, obs), 0)
    assert tt == tj and tt[0] == L


@pytest.mark.parametrize("weighted", [False, True])
def test_surface_spacetime(weighted):
    # stands in for test_surface_spacetime_distance and
    # test_weighted_distance at d=3 (the port's graph equals the
    # reference's: tests/test_torch_uf.py)
    code = tfam.rotated_surface(3, max_table_weight=0, t=1)
    g = spacetime_graph(code.raw_parity_check_c2, code.z_operator_matrix(),
                        3)
    gj = JGraph(num_nodes=g.num_nodes, edges=g.edges,
                edge_qubit=g.edge_qubit, edge_obs=g.edge_obs,
                n_qubits=g.n_qubits, edge_weight=g.edge_weight)
    want = jfd.observable_fault_distance(gj, 0, weighted=weighted)
    got = tfd.observable_fault_distance(g, 0, weighted=weighted)
    assert got == want
    if not weighted:
        assert got[0] == 3
    fd, n_min, wit = tfd.observable_fault_distance(
        g, 0, weighted=weighted, with_witness=True)
    assert (fd, n_min) == got
    assert _is_odd_cycle(g, wit)
    w = np.ones(g.num_edges) if not weighted else g.edge_weight
    assert int(np.asarray(w, np.int64)[wit].sum()) == fd


def test_t_gadget_sectors():
    # stands in for test_fault_distance.py::TestBespokeGadget at d=3:
    # every channel of both sectors at fault distance d, with a witness
    for jb, tb in ((jst.build_zz_merge_split, tst.build_zz_merge_split),
                   (jst.build_merge_readout_sector,
                    tst.build_merge_readout_sector)):
        mj, mt = jb(3, 3, 3, 3), tb(3, 3, 3, 3)
        for bit in range(mt.obs.shape[0]):
            want = jfd.observable_fault_distance(mj.graph, bit)
            got = tfd.observable_fault_distance(mt.graph, bit,
                                                with_witness=True)
            assert got[:2] == want and got[0] == 3
            assert _is_odd_cycle(mt.graph, got[2], bit)


def test_model_fault_distances_parity_chain():
    assert (tfd.model_fault_distances(tpatches.parity_chain_model(3))
            == jfd.model_fault_distances(jpatches.parity_chain_model(3)))


def test_witness_on_parallel_edges_of_different_labels():
    """A detector with two boundary edges, one crossing the logical cut
    and one not: the only undetectable logical is the pair (distance 2).
    The reference's witness takes the first edge for both hops — an even
    cycle (qcss_tpu/decode/fault_distance.py:123, ADVICE.md round 5); the
    port's takes one edge of each label."""
    edges, obs = [(0, -1), (0, -1)], [0, 1]
    dj, nj, wj = jfd.observable_fault_distance(
        _graph(JGraph, 1, edges, obs), 0, with_witness=True)
    g = _graph(TGraph, 1, edges, obs)
    dt, nt, wt = tfd.observable_fault_distance(g, 0, with_witness=True)
    assert (dt, nt) == (dj, nj) and dt == 2
    assert not _is_odd_cycle(g, wj)
    assert _is_odd_cycle(g, wt) and sorted(wt.tolist()) == [0, 1]
    # weighted: of two parallel edges of one label the lightest is kept
    edges, obs = [(0, -1), (0, -1), (0, -1)], [0, 0, 1]
    g = _graph(TGraph, 1, edges, obs, np.array([9, 2, 3], np.uint8))
    dt, _, wt = tfd.observable_fault_distance(g, 0, weighted=True,
                                              with_witness=True)
    assert dt == 5 and sorted(wt.tolist()) == [1, 2]
