"""The port's stencil union-find decoder against the JAX package's.

Every comparison here is exact (bit for bit): the graph builders are
integer code, and the plain stencil decode is a line-for-line port of the
reference's XLA `_decode_stencil` (which tests/test_device_uf.py holds
bit-identical to the Mosaic kernel the CUDA kernel replaces). Inputs are
drawn with numpy under fixed seeds and handed to both packages.
"""

from itertools import combinations

import numpy as np
import pytest
import torch

from qcss_tpu.codes.families import rotated_surface
from qcss_tpu.decode import device_uf as jdu
from qcss_tpu.decode.dem import circuit_level_graph, extraction_gate_list
from qcss_tpu.decode.uf import graph_from_checks, spacetime_graph
from qcss_tpu_torch.decode import device_uf as tdu
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
        return circuit_level_graph(raw, extraction_gate_list(code, raw), d,
                                   p_gate2=1e-2, p_meas=1e-2, logicals=lz)
    if kind == "spacetime":
        return spacetime_graph(raw, lz, d)
    return graph_from_checks(raw, lz)


def _port_graph(g):
    """The same graph as the port's MatchingGraph (same arrays)."""
    return tuf.MatchingGraph(
        num_nodes=g.num_nodes, edges=g.edges, edge_qubit=g.edge_qubit,
        edge_obs=g.edge_obs, n_qubits=g.n_qubits,
        edge_weight=g.edge_weight)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_tree_equal(t, j):
    if j is None or t is None:
        assert t is None and j is None
    elif isinstance(j, tuple) and not hasattr(j, "_fields"):
        assert isinstance(t, tuple) and len(t) == len(j)
        for a, b in zip(t, j):
            _assert_tree_equal(a, b)
    elif isinstance(j, tuple):
        assert t._fields == j._fields
        for name in j._fields:
            _assert_tree_equal(getattr(t, name), getattr(j, name))
    elif isinstance(j, (int, np.integer)):
        assert t == j
    else:
        np.testing.assert_array_equal(_np(t), np.asarray(j))


GRAPHS = [("dem", 3), ("dem", 5), ("spacetime", 3), ("spacetime", 5)]


@pytest.mark.parametrize("kind,d", GRAPHS)
def test_build_device_graph_equal(kind, d):
    g = _graph(kind, d)
    _assert_tree_equal(tdu.build_device_graph(_port_graph(g)),
                       jdu.build_device_graph(g))


def test_build_device_graph_spilled_lanes_equal():
    # Wide extra lanes overflow the packed word and spill into chunks.
    g = _graph("spacetime", 5)
    rng = np.random.default_rng(3)
    extra = (rng.integers(0, 1 << 25, g.num_edges),
             rng.integers(0, 1 << 9, g.num_edges))
    jdg = jdu.build_device_graph(g, extra_lanes=extra, spill_lanes=True)
    tdg = tdu.build_device_graph(_port_graph(g), extra_lanes=extra,
                                 spill_lanes=True)
    assert jdg.stencil.chunks
    _assert_tree_equal(tdg, jdg)


@pytest.mark.parametrize("kind,d", GRAPHS)
def test_plain_stencil_decode_bit_identical(kind, d):
    g = _graph(kind, d)
    rng = np.random.default_rng(10 + d)
    dets = (rng.random((1024, g.num_nodes)) < 0.06).astype(np.uint8)
    lab_j, conv_j = jdu.decode_labels(jdu.build_device_graph(g), dets)
    lab_t, conv_t = tdu.decode_labels(
        tdu.build_device_graph(_port_graph(g)), torch.as_tensor(dets))
    assert len(lab_t) == len(lab_j)
    for a, b in zip(lab_t, lab_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(conv_t.numpy(), np.asarray(conv_j))
    assert conv_t.all()


def test_device_graph_from_numpy_decodes_like_jax():
    # The JAX package's stencil tables, loaded into the port.
    g = _graph("dem", 5)
    jdg = jdu.build_device_graph(g)
    st = jdg.stencil
    tdg = tdu.device_graph_from_numpy(
        deltas=st.deltas, emask=np.asarray(st.emask), ewt=np.asarray(st.ewt),
        eobs=np.asarray(st.eobs), bmask=np.asarray(st.bmask),
        bwt=np.asarray(st.bwt), bobs=np.asarray(st.bobs),
        pack_shift=jdg.pack_shift, lane_offsets=jdg.lane_offsets,
        lane_masks=jdg.lane_masks, num_nodes=jdg.num_nodes,
        max_rounds=jdg.max_rounds)
    rng = np.random.default_rng(5)
    dets = (rng.random((512, g.num_nodes)) < 0.08).astype(np.int32)
    obs_j, conv_j = jdu.decode_obs(jdg, dets)
    obs_t, conv_t = tdu.decode_obs(tdg, torch.as_tensor(dets))
    np.testing.assert_array_equal(obs_t.numpy(), np.asarray(obs_j))
    np.testing.assert_array_equal(conv_t.numpy(), np.asarray(conv_j))


@pytest.mark.parametrize("d", [3, 5])
def test_every_low_weight_error_decodes_exactly(d):
    # Every error of weight <= t = (d-1)/2 must decode to its own
    # observable flip, and identically in both packages.
    code = rotated_surface(d)
    h = np.asarray(code.raw_parity_check_c2, np.uint8)
    lz = np.asarray(code.z_operator_matrix(), np.uint8)
    g = graph_from_checks(h, lz)
    n = h.shape[1]
    errs = []
    for w in range((d - 1) // 2 + 1):
        for qs in combinations(range(n), w):
            e = np.zeros(n, np.uint8)
            e[list(qs)] = 1
            errs.append(e)
    errs = np.stack(errs)
    syn = (errs @ h.T) & 1
    par = ((errs @ lz.T) & 1)[:, 0]
    obs_j, _ = jdu.decode_obs(jdu.build_device_graph(g), syn)
    obs_t, conv_t = tdu.decode_obs(tdu.build_device_graph(_port_graph(g)),
                                   torch.as_tensor(syn))
    np.testing.assert_array_equal(obs_t.numpy() & 1, par)
    np.testing.assert_array_equal(obs_t.numpy(), np.asarray(obs_j))
    assert conv_t.all()


def test_unported_routes_raise():
    # Every route of `decode_labels` is ported: what used to raise
    # NotImplementedError (per-shot weights, iteration caps, graphs that
    # are not stencil-eligible, spilled lanes on the CPU) now decodes, and
    # so does the host side of streaming (`StreamingDecoder` over the host
    # union-find); it still raises on a malformed window.
    g = _port_graph(_graph("dem", 3))
    dg = tdu.build_device_graph(g)
    rng = np.random.default_rng(0)
    dets = torch.as_tensor(
        (rng.random((8, g.num_nodes)) < 0.1).astype(np.uint8))
    ref, conv = tdu.decode_labels(dg, dets)
    assert conv.all()
    wide = tdu.build_device_graph(
        g, extra_lanes=(rng.integers(0, 1 << 28, g.num_edges),),
        spill_lanes=True)
    assert wide.stencil.chunks
    for labels, conv in (
            tdu.decode_labels(dg, dets, shot_weights=dg.wt[None].repeat(8, 1)),
            tdu.decode_labels(dg._replace(prop_cap=64, act_cap=64), dets),
            tdu.decode_labels(dg._replace(stencil=None), dets),
            tdu.decode_labels(wide, dets)):
        assert conv.all()
        assert torch.equal(labels[0] & 1, ref[0] & 1)
    from qcss_tpu_torch.decode.streaming import StreamingDecoder

    code = rotated_surface(3)
    h, lz = code.raw_parity_check_c2, code.z_operator_matrix()
    with pytest.raises(ValueError, match="window > commit"):
        StreamingDecoder(h, lz, window=2, commit=2)
    quiet = np.zeros((4, 13, h.shape[0]), np.uint8)
    assert not StreamingDecoder(h, lz).decode_stream(quiet).any()


@pytest.mark.cuda
@pytest.mark.parametrize("kind,d", [("dem", 5), ("spacetime", 5)])
def test_cuda_stencil_kernel_matches_jax(kind, d):
    # K1 on the card against the JAX package's stencil decode on the CPU.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from qcss_tpu_torch.decode import device_uf_cuda

    g = _graph(kind, d)
    rng = np.random.default_rng(40 + d)
    dets = (rng.random((2048, g.num_nodes)) < 0.06).astype(np.uint8)
    lab_j, conv_j = jdu.decode_labels(jdu.build_device_graph(g), dets)
    before = device_uf_cuda.launches
    lab_t, conv_t = tdu.decode_labels(
        tdu.build_device_graph(_port_graph(g)).to("cuda"),
        torch.as_tensor(dets, device="cuda"))
    assert device_uf_cuda.launches == before + 1
    np.testing.assert_array_equal(lab_t[0].cpu().numpy(),
                                  np.asarray(lab_j[0]))
    np.testing.assert_array_equal(conv_t.cpu().numpy(), np.asarray(conv_j))
