"""The port's staged stencil pieces and spilled-lane decode against the JAX
package's Mosaic kernels, run in interpret mode on the CPU.

Every comparison is exact (bit for bit): the kernels are integer code.
Detectors are drawn with numpy under fixed seeds and handed to both
packages; the state entering each growth round is walked with the port's
plain pieces and the same state is given to the JAX kernel.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcss_tpu.codes.families import rotated_surface
from qcss_tpu.decode import device_uf as jdu
from qcss_tpu.decode import device_uf_pallas as jpl
from qcss_tpu.decode.dem import circuit_level_graph, extraction_gate_list
from qcss_tpu.decode.streaming import _window_graph
from qcss_tpu.decode.uf import spacetime_graph
from qcss_tpu_torch.decode import device_uf as tdu
from qcss_tpu_torch.decode import device_uf_staged as tds
from qcss_tpu_torch.decode import uf as tuf

B = 64
ROUNDS_WALKED = 3
KINDS = ["spacetime", "dem"]


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


def _port_graph(g):
    return tuf.MatchingGraph(
        num_nodes=g.num_nodes, edges=g.edges, edge_qubit=g.edge_qubit,
        edge_obs=g.edge_obs, n_qubits=g.n_qubits,
        edge_weight=g.edge_weight)


@lru_cache(maxsize=None)
def _case(kind):
    """(JAX device graph, port device graph, detectors) on the d=3, 3-round
    graph: phenomenological spacetime (3 offsets) or circuit-level DEM (4,
    with the diagonal hook edges)."""
    code = rotated_surface(3)
    raw = code.raw_parity_check_c2
    lz = code.z_operator_matrix()
    if kind == "dem":
        g = circuit_level_graph(raw, extraction_gate_list(code, raw), 3,
                                p_gate2=1e-2, p_meas=1e-2, logicals=lz)
    else:
        g = spacetime_graph(raw, lz, 3)
    rng = np.random.default_rng(7 if kind == "dem" else 8)
    dets = (rng.random((B, g.num_nodes)) < 0.08).astype(np.uint8)
    jdg = jdu.build_device_graph(g)
    tdg = tdu.build_device_graph(_port_graph(g))
    return jdg, tdg, dets


def _kernel_args(jdg):
    return jdg.stencil, jdg.pack_shift, jdg.num_nodes, jdg.num_nodes + 1, B


@lru_cache(maxsize=None)
def _staged_walk(kind):
    """The inputs and the plain versions' outputs of the propagation and
    activity pieces over the first growth rounds of the staged decode."""
    _, tdg, dets = _case(kind)
    defect = tdu.stencil_defect(tdg, torch.as_tensor(dets))
    O = len(tdg.stencil.deltas)
    KB = tdg.stencil.bmask.shape[0]
    V = defect.shape[1]
    packed = tdu.initial_labels(tdg, B, "cpu")
    sup = torch.zeros((B, O, V), dtype=torch.int32)
    supb = torch.zeros((B, KB, V), dtype=torch.int32)
    act = defect
    props, acts = [], []
    for _ in range(ROUNDS_WALKED):
        sup, supb, _ = tdu._grow_step(tdg, packed, act, sup, supb)
        satm, satb = tdu._saturated(tdg, sup, supb)
        out = tdu._prop_plain(tdg, packed, satm, satb)
        props.append((packed, satm, satb, out))
        packed = out
        seed = tdu.parity_seeds(tdg, packed, defect)
        passes = tdu._cluster_passes(tdg, packed, satm)
        out = tdu._act_plain(tdg, seed, passes)
        acts.append((seed, passes, out))
        act = out
    return props, acts


@pytest.mark.parametrize("kind", KINDS)
def test_prop_plain_matches_pallas_kernel(kind):
    jdg = _case(kind)[0]
    # jitted once, so the walk's calls share one trace
    prop = jax.jit(jpl.make_prop_kernel(*_kernel_args(jdg), interpret=True))
    props, _ = _staged_walk(kind)
    adopted_somewhere = False
    for packed, satm, satb, out in props:
        ref = prop(jnp.asarray(packed.numpy()), jnp.asarray(satm.numpy()),
                   jnp.asarray(satb.numpy()))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        adopted_somewhere |= not torch.equal(out, packed)
    assert adopted_somewhere


@pytest.mark.parametrize("kind", KINDS)
def test_act_plain_matches_pallas_kernel(kind):
    jdg = _case(kind)[0]
    st, _, _, V, T = _kernel_args(jdg)
    actk = jax.jit(jpl.make_act_kernel(st, V, T, interpret=True))
    _, acts = _staged_walk(kind)
    spread_somewhere = False
    for seed, passes, out in acts:
        # the Mosaic kernel takes its masks as int32 0/1
        ref = actk(jnp.asarray(seed.numpy()),
                   jnp.asarray(passes.numpy().astype(np.int32)))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        spread_somewhere |= not torch.equal(out, seed)
    assert spread_somewhere


@pytest.mark.parametrize("kind", KINDS)
def test_round_plain_matches_pallas_kernel(kind):
    jdg, tdg, dets = _case(kind)
    step = jax.jit(jpl.make_round_kernel(*_kernel_args(jdg), interpret=True))
    defect = tdu.stencil_defect(tdg, torch.as_tensor(dets))
    O = len(tdg.stencil.deltas)
    KB = tdg.stencil.bmask.shape[0]
    V = defect.shape[1]
    packed = tdu.initial_labels(tdg, B, "cpu")
    sups = torch.zeros((B, O, V), dtype=torch.int32)
    supbs = torch.zeros((B, KB, V), dtype=torch.int32)
    seed = defect
    grew_somewhere = False
    for _ in range(ROUNDS_WALKED):
        ref = step(jnp.asarray(packed.numpy()), jnp.asarray(seed.numpy()),
                   tuple(jnp.asarray(sups[:, o].numpy()) for o in range(O)),
                   tuple(jnp.asarray(supbs[:, k].numpy()) for k in range(KB)))
        packed, sups, supbs, grew = tdu._round_plain(tdg, packed, seed, sups,
                                                     supbs)
        np.testing.assert_array_equal(packed.numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(sups.numpy(),
                                      np.stack(ref[1], axis=1))
        np.testing.assert_array_equal(supbs.numpy(),
                                      np.stack(ref[2], axis=1))
        np.testing.assert_array_equal(grew.numpy(), np.asarray(ref[3]))
        grew_somewhere |= bool(grew.any())
        seed = tdu.parity_seeds(tdg, packed, defect)
    assert grew_somewhere


@pytest.mark.parametrize("route", ["staged", "fused"])
@pytest.mark.parametrize("kind", KINDS)
def test_staged_decodes_match_jax(kind, route):
    jdg, tdg, dets = _case(kind)
    jfn, tfn = {"staged": (jpl.decode_stencil_pallas,
                           tds.decode_stencil_staged),
                "fused": (jpl.decode_stencil_pallas_fused,
                          tds.decode_stencil_fused)}[route]
    lab_j, conv_j = jfn(jdg, dets, interpret=True)
    lab_x, conv_x = jdu._decode_stencil(jdg, dets)
    lab_t, conv_t = tfn(tdg, torch.as_tensor(dets))
    lab_k, conv_k = tdu.decode_labels(tdg, torch.as_tensor(dets))
    assert len(lab_t) == len(lab_j) == 1
    np.testing.assert_array_equal(lab_t[0].numpy(), np.asarray(lab_j[0]))
    np.testing.assert_array_equal(lab_t[0].numpy(), np.asarray(lab_x[0]))
    np.testing.assert_array_equal(conv_t.numpy(), np.asarray(conv_j))
    np.testing.assert_array_equal(conv_t.numpy(), np.asarray(conv_x))
    assert torch.equal(lab_t[0], lab_k[0]) and torch.equal(conv_t, conv_k)
    assert conv_t.all() and lab_t[0].any()


def _window_case(seed, lanes_of):
    """The d=5 mid-window graph (8 slices, open future) with extra label
    lanes, spilled: (JAX device graph, port device graph, detectors)."""
    code = rotated_surface(5)
    h = np.asarray(code.raw_parity_check_c2, np.uint8)
    lz = np.asarray(code.z_operator_matrix(), np.uint8) & 1
    g, meta = _window_graph(h, lz, 8, True, None, None)
    lanes = lanes_of(g, meta)
    jdg = jdu.build_device_graph(g, extra_lanes=lanes, spill_lanes=True)
    tdg = tdu.build_device_graph(_port_graph(g), extra_lanes=lanes,
                                 spill_lanes=True)
    rng = np.random.default_rng(seed)
    dets = (rng.random((128, g.num_nodes)) < 0.02).astype(np.uint8)
    return jdg, tdg, dets


def _assert_all_lanes_equal(jdg, tdg, dets):
    lab_j, conv_j = jpl.decode_stencil_pallas_full(jdg, dets, interpret=True)
    lab_t, conv_t = tdu.decode_labels(tdg, torch.as_tensor(dets))
    assert len(lab_t) == len(lab_j)
    for a, b in zip(lab_t, lab_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(conv_t.numpy(), np.asarray(conv_j))
    assert conv_t.all()
    return lab_t


def test_spilled_chunk_lanes_match_pallas_full_kernel():
    # The carry lane twice: once in the packed word, once spilled. The
    # chunk words must rebuild exactly the forest-path XORs the packed
    # word carries, and every lane must equal the Mosaic kernel's.
    def carry_twice(g, meta):
        kind, sl = meta[:, 0], meta[:, 1]
        carry = np.where((kind == 1) & (sl == 3),
                         np.int64(1) << meta[:, 2], 0)
        return (carry, carry)

    jdg, tdg, dets = _window_case(9, carry_twice)
    assert tdg.packed_lane_ids == (0, 1)
    assert tdg.stencil.chunks[0].lane_ids == (2,)
    labels = _assert_all_lanes_equal(jdg, tdg, dets)
    assert torch.equal(labels[1], labels[2]) and labels[1].any()


def test_random_spilled_lanes_match_pallas_full_kernel():
    # Random wide lanes in two chunks: their values depend on which of
    # several equal candidates each adoption took, so this holds the
    # tie-break to the Mosaic kernel's.
    def random_lanes(g, meta):
        rng = np.random.default_rng(21)
        return (rng.integers(0, 1 << 28, g.num_edges),
                rng.integers(0, 1 << 30, g.num_edges),
                rng.integers(0, 1 << 5, g.num_edges))

    jdg, tdg, dets = _window_case(22, random_lanes)
    assert len(tdg.stencil.chunks) == 2
    labels = _assert_all_lanes_equal(jdg, tdg, dets)
    assert all(lab.any() for lab in labels)


def test_staged_decodes_refuse_spilled_lanes():
    _, tdg, dets = _window_case(
        1, lambda g, meta: (np.full(g.num_edges, 1 << 27),))
    assert tdg.stencil.chunks
    for fn in (tds.decode_stencil_staged, tds.decode_stencil_fused):
        with pytest.raises(ValueError, match="spilled"):
            fn(tdg, torch.as_tensor(dets))
    flat = tdg._replace(stencil=None)
    with pytest.raises(ValueError, match="stencil-eligible"):
        tds.decode_stencil_staged(flat, torch.as_tensor(dets))
