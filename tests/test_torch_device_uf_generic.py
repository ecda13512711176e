"""The port's generic union-find decoders (`_decode_packed`,
`_decode_unpacked`) and its capped stencil decode against the JAX
package's, on the CPU.

Every comparison is exact (bit for bit): the decoders are integer code and
the port keeps the reference's sweeps, its adoption rule and its argmin
tie-break. Detectors and per-shot weights are drawn with numpy under fixed
seeds and handed to both packages.
"""

import numpy as np
import pytest
import torch

from qcss_tpu.codes.families import rotated_surface
from qcss_tpu.decode import device_uf as jdu
from qcss_tpu.decode.dem import circuit_level_graph, extraction_gate_list
from qcss_tpu.decode.uf import graph_from_checks, spacetime_graph
from qcss_tpu_torch.decode import device_uf as tdu
from qcss_tpu_torch.decode import uf as tuf

B = 96


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # several worker processes run at once; see test_torch_device_uf.py
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_graph(g):
    return tuf.MatchingGraph(
        num_nodes=g.num_nodes, edges=g.edges, edge_qubit=g.edge_qubit,
        edge_obs=g.edge_obs, n_qubits=g.n_qubits,
        edge_weight=g.edge_weight)


def _scrambled(g, seed):
    """The same matching graph with its detectors renumbered at random, so
    that its edges span many distinct offsets: not stencil-eligible."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(g.num_nodes)
    edges = np.where(g.edges < 0, -1, perm[np.maximum(g.edges, 0)])
    return g.__class__(
        num_nodes=g.num_nodes, edges=edges.astype(np.int32),
        edge_qubit=g.edge_qubit, edge_obs=g.edge_obs, n_qubits=g.n_qubits,
        edge_weight=g.edge_weight)


def _graph(kind):
    code = rotated_surface(3)
    raw = code.raw_parity_check_c2
    lz = code.z_operator_matrix()
    if kind == "dem":
        return circuit_level_graph(raw, extraction_gate_list(code, raw), 3,
                                   p_gate2=1e-2, p_meas=1e-2, logicals=lz)
    if kind == "scrambled":
        return _scrambled(spacetime_graph(raw, lz, 4), seed=2)
    return spacetime_graph(raw, lz, 3)


def _both(g, **kw):
    return (jdu.build_device_graph(g, **kw),
            tdu.build_device_graph(_port_graph(g), **kw))


def _dets(g, seed, p=0.08):
    rng = np.random.default_rng(seed)
    return (rng.random((B, g.num_nodes)) < p).astype(np.uint8)


def _weights(g, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 9, (B, g.num_edges)).astype(np.int32)


def _assert_same(got, ref):
    (lab_t, conv_t), (lab_j, conv_j) = got, ref
    assert len(lab_t) == len(lab_j)
    for a, b in zip(lab_t, lab_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(conv_t.numpy(), np.asarray(conv_j))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind", ["scrambled", "dem"])
def test_decode_packed_matches_jax(kind, weighted):
    g = _graph(kind)
    jdg, tdg = _both(g, stencil=False)
    assert tdg.stencil is None and tdg.pack_shift is not None
    dets = _dets(g, 3)
    w = _weights(g, 4) if weighted else None
    got = tdu._decode_packed(tdg, torch.as_tensor(dets),
                             None if w is None else torch.as_tensor(w))
    _assert_same(got, jdu._decode_packed(jdg, dets, w))
    assert got[1].all() and got[0][0].any()


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind", ["scrambled", "dem"])
def test_decode_unpacked_matches_jax(kind, weighted):
    g = _graph(kind)
    rng = np.random.default_rng(5)
    lanes = (rng.integers(0, 1 << 29, g.num_edges),
             rng.integers(0, 1 << 30, g.num_edges))
    jdg, tdg = _both(g, extra_lanes=lanes)
    assert tdg.pack_shift is None and tdg.stencil is None
    dets = _dets(g, 6)
    w = _weights(g, 7) if weighted else None
    got = tdu._decode_unpacked(tdg, torch.as_tensor(dets),
                               None if w is None else torch.as_tensor(w))
    _assert_same(got, jdu._decode_unpacked(jdg, dets, w))
    assert len(got[0]) == 3 and all(lab.any() for lab in got[0])


def test_decode_labels_routes_like_jax():
    # Not stencil-eligible: the packed decoder; with wide lanes: the
    # unpacked one; shot_weights on a stencil graph: the packed decoder.
    g = _graph("scrambled")
    dets = _dets(g, 8)
    jdg, tdg = _both(g)
    assert jdg.stencil is None and tdg.stencil is None
    _assert_same(tdu.decode_labels(tdg, torch.as_tensor(dets)),
                 jdu.decode_labels(jdg, dets))
    wide = (np.random.default_rng(9).integers(0, 1 << 30, g.num_edges),)
    jdg, tdg = _both(g, extra_lanes=wide)
    assert tdg.pack_shift is None
    _assert_same(tdu.decode_labels(tdg, torch.as_tensor(dets)),
                 jdu.decode_labels(jdg, dets))
    g = _graph("dem")
    dets, w = _dets(g, 10), _weights(g, 11)
    jdg, tdg = _both(g)
    assert tdg.stencil is not None
    _assert_same(
        tdu.decode_labels(tdg, torch.as_tensor(dets), torch.as_tensor(w)),
        jdu.decode_labels(jdg, dets, w))


def test_shot_weights_on_spilled_lanes_decode_unpacked():
    g = _graph("spacetime")
    lanes = (np.random.default_rng(12).integers(0, 1 << 28, g.num_edges),)
    jdg, tdg = _both(g, extra_lanes=lanes, spill_lanes=True)
    assert tdg.stencil.chunks
    dets, w = _dets(g, 13), _weights(g, 14)
    _assert_same(
        tdu.decode_labels(tdg, torch.as_tensor(dets), torch.as_tensor(w)),
        jdu.decode_labels(jdg, dets, w))
    # (without weights the two packages part ways by design off the TPU:
    # the reference decodes spilled lanes unpacked there, the port in the
    # kernel's plain version, whose forest may differ inside a cluster;
    # test_torch_device_uf_staged.py holds that route to the Mosaic kernel)


@pytest.mark.parametrize("route", ["stencil", "packed", "unpacked",
                                   "chunks"])
def test_iteration_caps_give_the_same_suspects(route):
    # A cap of one sweep per fixpoint cuts deep shots short: both packages
    # must freeze and report the same shots.
    g = _graph("spacetime" if route in ("stencil", "chunks")
               else "scrambled")
    kw = dict(prop_cap=1, act_cap=1)
    if route == "unpacked":
        kw["extra_lanes"] = (np.random.default_rng(15).integers(
            0, 1 << 30, g.num_edges),)
    if route == "chunks":
        kw.update(extra_lanes=(np.random.default_rng(16).integers(
            0, 1 << 28, g.num_edges),), spill_lanes=True)
    jdg, tdg = _both(g, **kw)
    dets = _dets(g, 17, p=0.15)
    got = tdu.decode_labels(tdg, torch.as_tensor(dets))
    _assert_same(got, jdu.decode_labels(jdg, dets))
    assert not got[1].all() and got[1].any()


def test_code_capacity_graph_decodes_packed():
    # One slice, no time edges, the stencil refused: the packed decoder.
    code = rotated_surface(5)
    g = graph_from_checks(code.raw_parity_check_c2, code.z_operator_matrix())
    jdg, tdg = _both(g, stencil=False)
    dets = _dets(g, 18, p=0.2)
    got = tdu.decode_labels(tdg, torch.as_tensor(dets))
    _assert_same(got, jdu.decode_labels(jdg, dets))
    assert got[0][0].any()


def test_make_obs_decoder_with_caps_runs_on_the_cpu():
    g = _graph("dem")
    dets = _dets(g, 19)
    obs_j, conv_j = jdu.make_obs_decoder(g, prop_cap=2, act_cap=2)(dets)
    obs_t, conv_t = tdu.make_obs_decoder(_port_graph(g), prop_cap=2,
                                         act_cap=2, device="cpu")(
        torch.as_tensor(dets))
    np.testing.assert_array_equal(obs_t.numpy(), np.asarray(obs_j))
    np.testing.assert_array_equal(conv_t.numpy(), np.asarray(conv_j))
