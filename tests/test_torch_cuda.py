"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and nvcc (the kernels are built from
qcss_tpu_torch/csrc at first use and have no CPU mode), so each skips
without one. This file imports torch and the port only, so that it runs
on a machine without JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Comparisons are exact: each kernel reproduces its plain version bit for
bit (packed labels, activity, chunk words, obs, convergence).
"""

from functools import lru_cache

import numpy as np
import pytest
import torch
from test_torch_gf2_schedule import _plan

from qcss_tpu_torch import _cuda
from qcss_tpu_torch.codes.families import rotated_surface
from qcss_tpu_torch.decode import device_sparse as tds
from qcss_tpu_torch.decode import device_uf as tdu
from qcss_tpu_torch.decode.dem import circuit_level_graph, extraction_gate_list
from qcss_tpu_torch.decode.device_uf_staged import round_inputs
from qcss_tpu_torch.decode.uf import spacetime_graph

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _graph(kind, d):
    code = rotated_surface(d)
    raw = code.raw_parity_check_c2
    lz = code.z_operator_matrix()
    if kind == "dem":
        return circuit_level_graph(raw, extraction_gate_list(code, raw), d,
                                   p_gate2=1e-2, p_meas=1e-2, logicals=lz)
    return spacetime_graph(raw, lz, d)


def _dets(g, B, p, seed, device):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(
        (rng.random((B, g.num_nodes)) < p).astype(np.uint8), device=device)


@pytest.mark.parametrize("kind,d", [("dem", 3), ("dem", 5), ("dem", 7),
                                    ("spacetime", 5)])
def test_stencil_kernel_matches_plain(cuda, kind, d):
    from qcss_tpu_torch.decode import device_uf_cuda

    g = _graph(kind, d)
    dg = tdu.build_device_graph(g).to(cuda)
    dets = _dets(g, 2048, 0.06, seed=d, device=cuda)
    defect = tdu.stencil_defect(dg, dets)
    before = device_uf_cuda.launches
    packed_k, act_k, chunks_k = device_uf_cuda.stencil_full(dg, defect)
    assert device_uf_cuda.launches == before + 1
    packed_p, act_p, chunks_p = tdu._stencil_plain(dg, defect)
    torch.cuda.synchronize()
    assert torch.equal(packed_k, packed_p)
    assert torch.equal(act_k, act_p)
    assert chunks_k == chunks_p == ()


def _window_graph_with_lanes(d, seed):
    """The mid-window graph of a sliding-window decoder (8 slices, open
    future) with random wide label lanes, spilled into chunks."""
    from qcss_tpu_torch.decode.streaming import _window_graph

    code = rotated_surface(d)
    g, _ = _window_graph(code.raw_parity_check_c2, code.z_operator_matrix(),
                         8, True, 0.004, 0.01)
    rng = np.random.default_rng(seed)
    lanes = (rng.integers(0, 1 << 28, g.num_edges),
             rng.integers(0, 1 << 30, g.num_edges),
             rng.integers(0, 1 << 5, g.num_edges))
    return g, tdu.build_device_graph(g, extra_lanes=lanes, spill_lanes=True)


@pytest.mark.parametrize("d,B", [(3, 1), (5, 1000), (7, 2049)])
def test_stencil_kernel_chunk_lanes_match_plain(cuda, d, B):
    # Spilled lanes: chunk words, every lane and convergence, bit for bit,
    # at batch sizes that are no multiple of anything.
    from qcss_tpu_torch.decode import device_uf_cuda

    g, dg = _window_graph_with_lanes(d, seed=d)
    assert len(dg.stencil.chunks) == 2
    dg = dg.to(cuda)
    dets = _dets(g, B, 0.03, seed=B, device=cuda)
    defect = tdu.stencil_defect(dg, dets)
    before = device_uf_cuda.chunk_launches
    out_k = device_uf_cuda.stencil_full(dg, defect)
    assert device_uf_cuda.chunk_launches == before + 1
    out_p = tdu._stencil_plain(dg, defect)
    torch.cuda.synchronize()
    assert torch.equal(out_k[0], out_p[0]) and torch.equal(out_k[1], out_p[1])
    assert len(out_k[2]) == 2
    for a, b in zip(out_k[2], out_p[2]):
        assert torch.equal(a, b)
    lab_k, conv_k = tdu.decode_labels(dg, dets)
    lab_c, conv_c = tdu.decode_labels(dg.to("cpu"), dets.cpu())
    assert len(lab_k) == 4
    for a, b in zip(lab_k, lab_c):
        assert torch.equal(a.cpu(), b)
    assert torch.equal(conv_k.cpu(), conv_c)


@pytest.mark.parametrize("kind,d,B", [("dem", 3, 1), ("dem", 5, 1000),
                                      ("spacetime", 5, 513)])
def test_staged_kernels_match_plain(cuda, kind, d, B):
    from qcss_tpu_torch.decode import device_uf_cuda

    g = _graph(kind, d)
    dg = tdu.build_device_graph(g).to(cuda)
    O = len(dg.stencil.deltas)
    dets = _dets(g, B, 0.06, seed=d + B, device=cuda)
    before = dict(device_uf_cuda.staged_launches)
    n = 0
    for s in round_inputs(dg, tdu.stencil_defect(dg, dets), 3):
        packed, seed, sup = s["packed"], s["seed"], s["sup"]
        n += 1
        # K5: one whole round
        got = device_uf_cuda.stencil_round(dg, packed, seed, sup)
        ref = tdu._round_plain(dg, packed, seed, sup[:, :O], sup[:, O:])
        assert torch.equal(got[0], ref[0])
        assert torch.equal(got[1], torch.cat([ref[1], ref[2]], dim=1))
        assert torch.equal(got[2], ref[3])
        # K4 and K3 on the pieces of the same round
        satm, satb = tdu._saturated(dg, sup[:, :O], sup[:, O:])
        passes = tdu._cluster_passes(dg, packed, satm)
        act = device_uf_cuda.stencil_act(dg, seed, passes)
        assert torch.equal(act, tdu._act_plain(dg, seed, passes))
        satm, satb = tdu._saturated(dg, got[1][:, :O], got[1][:, O:])
        satm, satb = satm.contiguous(), satb.contiguous()
        assert torch.equal(device_uf_cuda.stencil_prop(dg, packed, satm, satb),
                           tdu._prop_plain(dg, packed, satm, satb))
    torch.cuda.synchronize()
    for name in ("prop", "act", "round"):
        assert device_uf_cuda.staged_launches[name] == before[name] + n


@pytest.mark.parametrize("B", [1, 777])
def test_staged_decodes_on_cuda_match_the_full_kernel(cuda, B):
    from qcss_tpu_torch.decode import device_uf_cuda
    from qcss_tpu_torch.decode.device_uf_staged import (
        decode_stencil_fused,
        decode_stencil_staged,
    )

    g = _graph("dem", 5)
    dg = tdu.build_device_graph(g).to(cuda)
    dets = _dets(g, B, 0.05, seed=B, device=cuda)
    ref, conv = tdu.decode_labels(dg, dets)
    before = dict(device_uf_cuda.staged_launches)
    for fn in (decode_stencil_staged, decode_stencil_fused):
        labels, c = fn(dg, dets)
        assert torch.equal(labels[0], ref[0]) and torch.equal(c, conv)
        lab_cpu, c_cpu = fn(dg.to("cpu"), dets.cpu())
        assert torch.equal(labels[0].cpu(), lab_cpu[0])
        assert torch.equal(c.cpu(), c_cpu)
    after = device_uf_cuda.staged_launches
    assert after["prop"] > before["prop"] and after["act"] > before["act"]
    assert after["round"] > before["round"]


def test_generic_decoders_on_cuda_match_cpu(cuda):
    # argmin's first-minimum tie-break and the gathers, card against CPU
    g = _graph("spacetime", 5)
    rng = np.random.default_rng(5)
    lanes = (rng.integers(0, 1 << 30, g.num_edges),)
    dets = _dets(g, 256, 0.06, seed=9, device=cuda)
    w = torch.as_tensor(rng.integers(1, 9, (256, g.num_edges)),
                        dtype=torch.int32)
    for dg, fn in ((tdu.build_device_graph(g, stencil=False),
                    tdu._decode_packed),
                   (tdu.build_device_graph(g, extra_lanes=lanes),
                    tdu._decode_unpacked)):
        for weights in (None, w):
            lab_k, conv_k = fn(dg.to(cuda), dets,
                               None if weights is None else weights.to(cuda))
            lab_c, conv_c = fn(dg, dets.cpu(), weights)
            for a, b in zip(lab_k, lab_c):
                assert torch.equal(a.cpu(), b)
            assert torch.equal(conv_k.cpu(), conv_c)


def test_stream_memory_rate_on_cuda(cuda):
    from qcss_tpu_torch.decode import device_uf_cuda
    from qcss_tpu_torch.decode.device_streaming import stream_memory_rate

    code = rotated_surface(9)  # r = 40: two carry lanes, one spilled
    before = device_uf_cuda.chunk_launches
    res = stream_memory_rate(code.raw_parity_check_c2,
                             code.z_operator_matrix(), 0.004, 0.004,
                             rounds=40, batch=2048, device=cuda)
    assert device_uf_cuda.chunk_launches == before + 8
    assert 0.0 <= res["logical_fail"] < 0.05


def test_decode_labels_routes_cuda_to_kernel(cuda):
    from qcss_tpu_torch.decode import device_uf_cuda

    g = _graph("dem", 5)
    dg = tdu.build_device_graph(g)
    dets = _dets(g, 1024, 0.05, seed=1, device=cuda)
    before = device_uf_cuda.launches
    obs_k, conv_k = tdu.decode_obs(dg.to(cuda), dets)
    assert device_uf_cuda.launches == before + 1
    obs_c, conv_c = tdu.decode_obs(dg, dets.cpu())
    assert torch.equal(obs_k.cpu(), obs_c)
    assert torch.equal(conv_k.cpu(), conv_c)


def test_stencil_wrapper_checks_inputs(cuda):
    from qcss_tpu_torch.decode import device_uf_cuda

    g = _graph("dem", 3)
    dg = tdu.build_device_graph(g).to(cuda)
    bad = torch.zeros((4, g.num_nodes + 1), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        device_uf_cuda.stencil_full(dg, bad)
    with pytest.raises(ValueError):
        device_uf_cuda.stencil_full(dg, bad.to(torch.int32)[:, :-1])
    with pytest.raises(ValueError, match="CUDA"):
        device_uf_cuda.stencil_full(dg, bad.to(torch.int32).cpu())
    packed = tdu.initial_labels(dg, 4, cuda)
    sup = torch.zeros((4, len(dg.stencil.deltas) + dg.stencil.bmask.shape[0],
                       g.num_nodes + 1), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        device_uf_cuda.stencil_round(dg, packed, packed, sup[:, :-1])
    with pytest.raises(ValueError):
        device_uf_cuda.stencil_act(dg, packed, sup.to(torch.int64))
    with pytest.raises(ValueError):  # masks are bool planes, not int32
        device_uf_cuda.stencil_prop(dg, packed, sup, sup)
    with pytest.raises(ValueError):
        device_uf_cuda.stencil_act(dg, packed, sup[:, :-1].contiguous())


@pytest.mark.parametrize("d_max", [8, 16, 48])
def test_sparse_kernel_matches_plain(cuda, d_max):
    from qcss_tpu_torch.decode import device_sparse_cuda

    g = _graph("dem", 5)
    tables = tds._tables_to(tds.build_sparse_tables(g), cuda)
    dets = _dets(g, 4096, 0.05, seed=d_max, device=cuda)
    ev = d_max * (d_max + 1) // 2 + 4
    before = device_sparse_cuda.launches
    obs_k, conv_k = device_sparse_cuda.sparse_decode_cuda(tables, d_max, ev,
                                                          dets)
    assert device_sparse_cuda.launches == before + 1
    obs_p, conv_p = tds._sparse_plain(tables, d_max, ev, dets)
    torch.cuda.synchronize()
    assert torch.equal(obs_k, obs_p)
    assert torch.equal(conv_k, conv_p)
    if d_max == 8:
        assert not conv_k.all()  # overflow shots exercised


def test_hybrid_on_cuda_matches_cpu(cuda):
    g = _graph("dem", 5)
    dets = _dets(g, 2048, 0.05, seed=3, device=cuda)
    obs_k, conv_k = tds.make_hybrid_obs_decoder(g, d_max=8,
                                                device=cuda)(dets)
    obs_c, conv_c = tds.make_hybrid_obs_decoder(g, d_max=8,
                                                device="cpu")(dets.cpu())
    assert torch.equal(obs_k.cpu(), obs_c)
    assert torch.equal(conv_k.cpu(), conv_c)
    assert conv_k.all()


def test_memory_experiment_on_cuda(cuda):
    from qcss_tpu_torch.decode import device_uf_cuda
    from qcss_tpu_torch.experiments.memory import memory_experiment
    from qcss_tpu_torch.sim.noise import NoiseModel

    before = device_uf_cuda.launches
    res = memory_experiment(rotated_surface(3), rounds=3,
                            noise=NoiseModel(p_gate2=1e-2, p_meas=1e-2),
                            decoder="device-dem", engine="frames",
                            batch=8192, device=cuda)
    assert device_uf_cuda.launches > before
    assert 0.0 < res["logical_fail"] < 0.05


def _words(rng, shape):
    """Random 32-bit words in int32 storage: about half have bit 31 set."""
    return torch.from_numpy(rng.integers(0, 1 << 32, shape, dtype=np.uint32)
                            .view(np.int32))


def _packed_checks(h, device):
    from qcss_tpu_torch.ops import gf2_torch

    return gf2_torch.words32(gf2_torch.pack_bits(h)).to(device)


@pytest.mark.parametrize("B", [1000, (1 << 20) + 3])
@pytest.mark.parametrize("d", [3, 11])
def test_packed_syndrome_kernels_match_plain(cuda, B, d):
    from qcss_tpu_torch.ops import cuda_gf2

    h = rotated_surface(d).parity_check_c2
    hp = _packed_checks(h, cuda)
    W = hp.shape[1]
    e = _words(np.random.default_rng(B + d), (B, W)).to(cuda)
    before = dict(cuda_gf2.launches)
    got = cuda_gf2.syndromes_packed(e, hp)
    got_t = cuda_gf2.syndromes_packed_t(e.T.contiguous(), hp)
    assert cuda_gf2.launches["syndromes_packed"] == \
        before["syndromes_packed"] + 1
    assert cuda_gf2.launches["syndromes_packed_t"] == \
        before["syndromes_packed_t"] + 1
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_gf2.syndromes_packed_plain(e, hp))
    assert torch.equal(got_t, cuda_gf2.syndromes_packed_t_plain(
        e.T.contiguous(), hp))
    assert torch.equal(got.cpu(), cuda_gf2.syndromes_packed(e.cpu(),
                                                            hp.cpu()))


@pytest.mark.parametrize("B", [1000, (1 << 20) + 3])
@pytest.mark.parametrize("name", ["steane", "golay"])
def test_residual_decode_kernel_matches_plain(cuda, B, name):
    from qcss_tpu_torch.codes import families
    from qcss_tpu_torch.ops import cuda_gf2, gf2

    code = getattr(families, name)()
    h = code.parity_check_c2
    hp = _packed_checks(h, cuda)
    lp = _packed_checks(gf2.correction_lut(h, code.c2_syndromes), cuda)
    e = _words(np.random.default_rng(B), (B, hp.shape[1])).to(cuda)
    before = cuda_gf2.launches["decode_residual_packed"]
    got = cuda_gf2.decode_residual_packed(e, hp, lp)
    assert cuda_gf2.launches["decode_residual_packed"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_gf2.decode_residual_packed_plain(e, hp, lp))


def test_packed_wrappers_check_inputs(cuda):
    from qcss_tpu_torch.ops import cuda_gf2

    e = torch.zeros((8, 1), dtype=torch.int32)
    h = torch.zeros((3, 1), dtype=torch.int32)
    lut = torch.zeros((8, 1), dtype=torch.int32)
    for fn, args in ((cuda_gf2.syndromes_packed_cuda, (e, h)),
                     (cuda_gf2.syndromes_packed_t_cuda, (e.T.contiguous(),
                                                          h)),
                     (cuda_gf2.decode_residual_packed_cuda, (e, h, lut))):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)  # a CPU tensor is refused
        dev_args = [a.to(cuda) for a in args]
        with pytest.raises(ValueError):
            fn(dev_args[0].to(torch.int64), *dev_args[1:])
    with pytest.raises(ValueError):
        cuda_gf2.decode_residual_packed_cuda(
            e.to(cuda), h.to(cuda), lut[:4].to(cuda))


def test_mc_decode_rounds_on_cuda_uses_the_packed_kernels(cuda):
    from qcss_tpu_torch.codes import families
    from qcss_tpu_torch.decode import montecarlo
    from qcss_tpu_torch.ops import cuda_gf2

    before = dict(cuda_gf2.launches)
    code = families.steane()
    gen = torch.Generator(device=cuda).manual_seed(1)
    out = montecarlo.mc_decode_rounds(code, gen, 1 << 16, 4, 0.05)
    assert cuda_gf2.launches["decode_residual_packed"] == \
        before["decode_residual_packed"] + 8
    assert cuda_gf2.launches["syndromes_packed"] == \
        before["syndromes_packed"] + 8
    rate = int(out["word_fail"]) / (4 << 16)
    assert 0.02 < rate < 0.05  # Steane at p=0.05: about 0.034


def _random_packed_state(n, B, seed, device):
    """A packed tableau after a random Clifford circuit of depth 4n, and
    the circuit's rng."""
    from qcss_tpu_torch.circuits.ir import Circuit
    from qcss_tpu_torch.sim import tableau_packed as tp

    names = ["I", "X", "Y", "Z", "H", "S", "CNOT", "CZ"]
    rng = np.random.default_rng(seed)
    circ = Circuit()
    for _ in range(4 * n):
        k = int(rng.integers(0, 8))
        a, b = (int(v) for v in rng.choice(n, 2, replace=False))
        circ.gate(names[k], *((a,) if k < 6 else (a, b)))
    return tp.run_circuit(tp.zero_state(B, n, device), circ), rng


@pytest.mark.parametrize("n,B", [(7, 1024), (40, 1001), (121, 1024),
                                 (363, 1000), (720, 33)])
def test_measure_kernel_matches_plain(cuda, n, B):
    from qcss_tpu_torch.sim import cuda_measure
    from qcss_tpu_torch.sim import tableau as tb
    from qcss_tpu_torch.sim import tableau_packed as tp

    t, rng = _random_packed_state(n, B, n, cuda)
    # a second pass over some qubits: deterministic outcomes for sure
    first = rng.choice(n, min(n, 24), replace=False)
    qs = np.concatenate([first, first[:8]])
    if n > 32:
        qs[0] = 31
    bits = tb.collapse_bits(torch.Generator(device=cuda).manual_seed(n), B,
                            len(qs))
    assert cuda_measure.in_shared_memory(n, t.words) == (n < 670)
    before = cuda_measure.launches
    tk, ok = cuda_measure.measure_many_cuda(t, qs, bits)
    assert cuda_measure.launches == before + 1
    tpl, op = tp.measure_many(t, qs, rand_bits=bits)
    torch.cuda.synchronize()
    assert torch.equal(ok, op)
    assert torch.equal(tk.x, tpl.x) and torch.equal(tk.z, tpl.z)
    assert torch.equal(tk.r, tpl.r)


def test_packed_engine_measures_blocks_with_the_kernel(cuda):
    from qcss_tpu_torch.ftqc.engines import PackedEngine
    from qcss_tpu_torch.sim import cuda_measure
    from qcss_tpu_torch.sim import tableau as tb
    from qcss_tpu_torch.sim.noise import NoiseModel
    from qcss_tpu_torch.benchmarks.tableau_bench import ladder_circuit

    eng = PackedEngine(121, 2, NoiseModel())
    arrays = ladder_circuit(121).to_arrays()
    states = {}
    for where in ("cpu", cuda):
        t = eng.zero_state(99, where)
        for b in range(2):
            t = eng.run_block_circuit(t, arrays, b)
        states[where] = t
    bits = tb.collapse_bits(torch.Generator().manual_seed(3), 99, 121)
    before = cuda_measure.launches
    tk, ok = eng.measure_block(states[cuda], 1, rand_bits=bits.to(cuda))
    assert cuda_measure.launches == before + 1
    tc, oc = eng.measure_block(states["cpu"], 1, rand_bits=bits)
    assert cuda_measure.launches == before + 1
    assert torch.equal(ok.cpu(), oc)
    for a, b in ((tk.x, tc.x), (tk.z, tc.z), (tk.r, tc.r)):
        assert torch.equal(a.cpu(), b)


def test_measure_wrapper_checks_inputs(cuda):
    from qcss_tpu_torch.sim import cuda_measure
    from qcss_tpu_torch.sim import tableau_packed as tp

    t = tp.zero_state(4, 9, cuda)
    bits = torch.zeros((4, 2), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="card"):
        cuda_measure.measure_many_cuda(tp.zero_state(4, 9, "cpu"), [0, 1],
                                       bits.cpu())
    with pytest.raises(ValueError, match="qubits"):
        cuda_measure.measure_many_cuda(t, [0, 9], bits)
    with pytest.raises(ValueError, match="rand_bits"):
        cuda_measure.measure_many_cuda(t, [0, 1], bits[:, :1])
    with pytest.raises(ValueError, match="x"):
        cuda_measure.measure_many_cuda(t.replace(x=t.x.to(torch.int64)),
                                       [0, 1], bits)


# -- K1 on inputs that stress its live-vertex lists ------------------------

def _k1_equal(dg, defect):
    """K1 against its plain version on the card: packed, act, every chunk
    plane, every lane and convergence, bit for bit; returns K1's output."""
    from qcss_tpu_torch.decode import device_uf_cuda

    before = device_uf_cuda.launches
    out_k = device_uf_cuda.stencil_full(dg, defect)
    assert device_uf_cuda.launches == before + 1
    out_p = tdu._stencil_plain(dg, defect)
    torch.cuda.synchronize()
    assert torch.equal(out_k[0], out_p[0]) and torch.equal(out_k[1], out_p[1])
    assert len(out_k[2]) == len(out_p[2]) == len(dg.stencil.chunks)
    for a, b in zip(out_k[2], out_p[2]):
        assert torch.equal(a, b)
    lab_k, conv_k = tdu._stencil_labels(dg, defect, *out_k)
    lab_p, conv_p = tdu._stencil_labels(dg, defect, *out_p)
    for a, b in zip(lab_k, lab_p):
        assert torch.equal(a, b)
    assert torch.equal(conv_k, conv_p)
    return out_k


@lru_cache(maxsize=None)
def _d11_fused(p):
    code = rotated_surface(11)
    raw = code.raw_parity_check_c2
    g = circuit_level_graph(raw, extraction_gate_list(code, raw), 11,
                            p_gate2=p, p_meas=1e-2,
                            logicals=code.z_operator_matrix())
    return g, tdu.build_device_graph(g)


@pytest.mark.parametrize("p_dets", [0.01, 0.04])
def test_stencil_kernel_lists_on_the_noisy_d11_graph(cuda, p_dets):
    # p_gate2 = 1e-2 and dense defects: long member lists and frontiers;
    # all-zero, single-defect and hub-adopting shots among them, and a
    # batch that is no multiple of the shots per block
    from qcss_tpu_torch.decode import device_uf_cuda

    g, dg = _d11_fused(1e-2)
    dg = dg.to(cuda)
    plan = device_uf_cuda.stencil_full_config(dg)
    assert plan["form"] == "narrow" and plan["shots_per_block"] > 1
    B = 1000 if 1000 % plan["shots_per_block"] else 1001
    defect = tdu.stencil_defect(dg, _dets(g, B, p_dets, seed=11, device=cuda))
    defect[:6] = 0
    defect[3, 100] = 1
    defect[4, 700] = 1
    defect[5, 0] = 1
    packed, act, _ = _k1_equal(dg, defect)
    bn = dg.num_nodes
    hub_adopted = (packed[:, bn] >> dg.pack_shift) != bn
    assert bool(hub_adopted.any())
    assert not bool(act[:3].any())


@pytest.mark.parametrize("B", [1, 1000])
def test_stencil_kernel_lists_small_batches(cuda, B):
    g, dg = _d11_fused(2e-3)
    dg = dg.to(cuda)
    _k1_equal(dg, tdu.stencil_defect(dg, _dets(g, B, 0.02, seed=B,
                                               device=cuda)))


@pytest.mark.parametrize("kind", ["phenomenological", "circuit-level"])
def test_stencil_kernel_lists_on_the_d11_window_graphs(cuda, kind):
    from qcss_tpu_torch.decode.device_streaming import DeviceStreamingDecoder

    code = rotated_surface(11)
    raw, lz = code.raw_parity_check_c2, code.z_operator_matrix()
    if kind == "phenomenological":
        dec = DeviceStreamingDecoder(raw, lz, window=8, commit=4,
                                     p_space=0.004, p_time=0.004,
                                     device=cuda)
    else:
        dec = DeviceStreamingDecoder.from_dem(
            raw, lz, extraction_gate_list(code, raw), window=8, commit=4,
            p_gate2=2e-3, p_meas=1e-2, device=cuda)
    mid = dec._mid
    assert len(mid.stencil.chunks) == 2
    rng = np.random.default_rng(7)
    dets = torch.as_tensor((rng.random((777, mid.num_nodes)) < 0.02)
                           .astype(np.uint8), device=cuda)
    _k1_equal(mid, tdu.stencil_defect(mid, dets))


@pytest.mark.parametrize("change", ["zero weights", "wide weights"])
def test_stencil_kernel_edge_word_forms(cuda, change):
    # weight 0 (saturated from the first round, also in shots without
    # defects while another shot has some) and weights above 255 (the
    # wide word form)
    from qcss_tpu_torch.decode import device_uf_cuda

    g, dg = _d11_fused(1e-2)
    st = dg.stencil
    ewt, bwt = st.ewt.clone(), st.bwt.clone()
    if change == "zero weights":
        ewt[:, ::9] = 0
        bwt[:, 1::7] = 0
    else:
        ewt[:, ::5] = 300
        bwt = bwt * 2 + 255
    dg = dg._replace(stencil=st._replace(ewt=ewt, bwt=bwt)).to(cuda)
    plan = device_uf_cuda.stencil_full_config(dg)
    assert plan["presat"] == (change == "zero weights")
    assert plan["form"] == ("wide" if change == "wide weights" else "narrow")
    defect = tdu.stencil_defect(dg, _dets(g, 513, 0.01, seed=5, device=cuda))
    defect[:2] = 0
    _k1_equal(dg, defect)
    # a batch whose only defect is in its last shot, and one with none
    defect[:-1] = 0
    _k1_equal(dg, defect)
    _k1_equal(dg, torch.zeros_like(defect))


# -- K7 at every register width, ragged shapes -----------------------------

@pytest.mark.parametrize("W", list(range(1, 9)) + [9, 13])
def test_transposed_syndrome_kernel_widths(cuda, W):
    from qcss_tpu_torch.ops import cuda_gf2

    rng = np.random.default_rng(W)
    for R in (1, 31, 32, 33, 60, 97):
        for B in (1, 1000, 4099):
            h = _words(rng, (R, W)).to(cuda)
            e_t = _words(rng, (W, B)).to(cuda)
            assert bool((e_t < 0).any()) or B == 1  # bit 31 set
            got = cuda_gf2.syndromes_packed_t_cuda(e_t, h)
            want = cuda_gf2.syndromes_packed_t_plain(e_t, h)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (W, R, B)


# -- K6 and K8: every instance, ragged batches, misaligned views ----------

_PACKED_WIDTHS = list(range(1, 10)) + [13]
_PACKED_BATCHES = [1, 3, 1000, (1 << 20) + 3]


def _plan_of(plan):
    """A launch plan as the CPU model of the partition states it."""
    return (plan["instance"], plan["shots_per_thread"], plan["lanes"],
            plan["smem_bytes"])


def _words_view(rng, B, W, offset, device):
    """[B, W] random words whose storage starts ``offset`` words into its
    buffer (offset 1: a contiguous view that is not 16-byte aligned)."""
    flat = _words(rng, (B * W + offset,)).to(device)
    return flat[offset:].view(B, W)


@pytest.mark.parametrize("B", _PACKED_BATCHES)
@pytest.mark.parametrize("W", _PACKED_WIDTHS)
def test_syndrome_kernel_shapes(cuda, W, B):
    from qcss_tpu_torch.ops import cuda_gf2

    rng = np.random.default_rng(100 * W + B % 97)
    for R in (1, 3, 11, 60, 61, 200):
        h = _words(rng, (R, W)).to(cuda)
        for offset in (0, 1):
            e = _words_view(rng, B, W, offset, cuda)
            assert bool((e < 0).any()) or B * W < 8  # bit 31 set
            plan = cuda_gf2.launch_plan("syndromes_packed", e, h)
            assert plan["instance"] == (W if W <= 4 and not offset else 0)
            assert _plan_of(plan) == _plan("K6", W, R, offset)
            got = cuda_gf2.syndromes_packed_cuda(e, h)
            want = cuda_gf2.syndromes_packed_plain(e, h)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (W, B, R, offset)


@pytest.mark.parametrize("B", _PACKED_BATCHES)
@pytest.mark.parametrize("W", _PACKED_WIDTHS)
def test_residual_decode_kernel_shapes(cuda, W, B):
    from qcss_tpu_torch.ops import cuda_gf2

    rng = np.random.default_rng(200 * W + B % 97)
    # 2^14 and 2^16 LUT rows at W = 1 are 64 KB (staged in shared memory)
    # and 256 KB (gathered from device memory)
    for R in (1, 3, 11, 14, 16):
        h = _words(rng, (R, W)).to(cuda)
        lut = _words(rng, (1 << R, W)).to(cuda)
        for offset in (0, 1):
            e = _words_view(rng, B, W, offset, cuda)
            plan = cuda_gf2.launch_plan("decode_residual_packed", e, h)
            assert plan["instance"] == (W if W <= 4 and not offset else 0)
            assert _plan_of(plan) == _plan("K8", W, R, offset)
            assert plan["lut_in_smem"] == (4 * W << R <= _cuda.MAX_SHARED_BYTES
                                           - 4 * ((R * W + 3) // 4 * 4))
            got = cuda_gf2.decode_residual_packed_cuda(e, h, lut)
            want = cuda_gf2.decode_residual_packed_plain(e, h, lut)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (W, B, R, offset)


def test_packed_kernels_take_an_empty_batch(cuda):
    from qcss_tpu_torch.ops import cuda_gf2

    e = torch.zeros((0, 2), dtype=torch.int32, device=cuda)
    h = torch.ones((3, 2), dtype=torch.int32, device=cuda)
    lut = torch.ones((8, 2), dtype=torch.int32, device=cuda)
    assert cuda_gf2.syndromes_packed_cuda(e, h).shape == (0, 3)
    assert cuda_gf2.decode_residual_packed_cuda(e, h, lut).shape == (0, 2)


# -- K9's forms: thresholds, batches, branches, views ----------------------

def _measure_equal(t, qs, bits, form=0):
    """K9 (the wrapper, or a form asked for through the C entry point)
    against its plain version, bit for bit."""
    from qcss_tpu_torch.sim import cuda_measure
    from qcss_tpu_torch.sim import tableau_packed as tp

    if form:
        q = torch.tensor(qs, dtype=torch.int32, device=t.x.device)
        B, _, W = t.x.shape
        xo, zo, ro = torch.empty_like(t.x), torch.empty_like(t.z), \
            torch.empty_like(t.r)
        ok = torch.empty((B, len(qs)), dtype=torch.uint8, device=t.x.device)
        _cuda.check(_cuda.load().qcss_chp_measure(
            t.x.data_ptr(), t.z.data_ptr(), t.r.data_ptr(), q.data_ptr(),
            bits.data_ptr(), B, t.n, W, len(qs), form, xo.data_ptr(),
            zo.data_ptr(), ro.data_ptr(), ok.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "qcss_chp_measure")
        tk = tp.PackedTableau(xo, zo, ro, t.n)
    else:
        before = cuda_measure.launches
        tk, ok = cuda_measure.measure_many_cuda(t, qs, bits)
        assert cuda_measure.launches == before + 1
    tpl, op = tp.measure_many(t, qs, rand_bits=bits)
    torch.cuda.synchronize()
    assert torch.equal(ok, op)
    assert torch.equal(tk.x, tpl.x) and torch.equal(tk.z, tpl.z)
    assert torch.equal(tk.r, tpl.r)


@pytest.mark.parametrize("n,B", [(128, 1), (129, 5), (659, 3), (660, 2),
                                 (49, 4097), (121, 4099)])
def test_measure_kernel_forms(cuda, n, B):
    """One below and one above each form's threshold (a warp a shot to
    W = 4, a block in shared memory to n = 659), B = 1 and batches that
    are not a multiple of the shots a block; qubit 31 first, a second pass
    over the qubits for the deterministic branch; the plan against the CPU
    model's."""
    from test_torch_measure_schedule import _plan

    from qcss_tpu_torch.sim import cuda_measure
    from qcss_tpu_torch.sim import tableau as tb

    t, rng = _random_packed_state(n, B, n + 1, cuda)
    first = [int(v) for v in rng.choice(n, min(n, 12), replace=False)]
    qs = [31] + first + [31] + first
    bits = tb.collapse_bits(torch.Generator(device=cuda).manual_seed(n), B,
                            len(qs))
    plan = cuda_measure.launch_plan(n, t.words)
    assert (plan["form"], plan["shots_per_block"], plan["threads"],
            plan["smem_bytes"]) == _plan(n, t.words)
    assert plan["form"] == (1 if n <= 128 else 2 if n <= 659 else 3)
    _measure_equal(t, qs, bits)


@pytest.mark.parametrize("n", [49, 121, 363])
def test_measure_kernel_all_random_and_all_deterministic(cuda, n):
    """The ladder state (every outcome random), then the same qubits again
    (every outcome deterministic), through the wrapper and through each
    form that takes the shape."""
    from qcss_tpu_torch.benchmarks.measure_sparse_bench import k9_walk
    from qcss_tpu_torch.benchmarks.tableau_bench import (
        ladder_circuit,
        measured_qubits,
    )
    from qcss_tpu_torch.sim import cuda_measure
    from qcss_tpu_torch.sim import tableau as tb
    from qcss_tpu_torch.sim import tableau_packed as tp

    B = 1000
    t = tp.run_circuit(tp.zero_state(B, n, cuda), ladder_circuit(n))
    qs = [int(v) for v in measured_qubits(n)]
    bits = tb.collapse_bits(torch.Generator(device=cuda).manual_seed(n), B,
                            len(qs))
    t2, _, rand, _ = k9_walk(t, qs, bits)
    assert bool(rand.all())
    assert not bool(k9_walk(t2, qs, bits)[2].any())
    _measure_equal(t, qs, bits)
    _measure_equal(t2, qs, bits)
    for form in (1, 2, 3):
        try:
            cuda_measure.launch_plan(n, t.words, form)
        except RuntimeError:
            assert form == 1 and n > 128
            continue
        _measure_equal(t, qs, bits, form)
        _measure_equal(t2, qs, bits, form)


@pytest.mark.parametrize("n", [7, 49, 121, 363])
def test_measure_kernel_misaligned_tableau(cuda, n):
    """A tableau whose words start 4 bytes past a 16-byte boundary: the
    copies take 4-byte pieces."""
    from qcss_tpu_torch.sim import tableau as tb
    from qcss_tpu_torch.sim import tableau_packed as tp

    t, rng = _random_packed_state(n, 33, n + 2, cuda)

    def shifted(a):
        buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
        v = buf[1:].view(a.shape)
        v.copy_(a)
        return v

    tv = tp.PackedTableau(shifted(t.x), shifted(t.z), t.r, n)
    assert tv.x.data_ptr() % 16 != 0 and tv.x.is_contiguous()
    qs = [int(v) for v in rng.choice(n, min(n, 10), replace=False)]
    qs = qs + qs
    bits = tb.collapse_bits(torch.Generator(device=cuda).manual_seed(2), 33,
                            len(qs))
    _measure_equal(tv, qs, bits)


def test_measure_kernel_refuses_forms_it_cannot_run(cuda):
    from qcss_tpu_torch.sim import cuda_measure

    with pytest.raises(RuntimeError):
        cuda_measure.launch_plan(363, 12, 1)  # a warp holds W <= 4
    with pytest.raises(RuntimeError):
        cuda_measure.launch_plan(720, 23, 2)  # past 227 KB
    with pytest.raises(RuntimeError):
        cuda_measure.launch_plan(1, 1, 2)  # n < 2W
    assert cuda_measure.launch_plan(9, 5)["form"] == 3


# -- K2: d_max, overflow, empty rows, the event cap, views, wide distances --

def _sparse_equal(tables, d_max, ev, dets):
    from qcss_tpu_torch.decode import device_sparse_cuda

    before = device_sparse_cuda.launches
    obs_k, conv_k = device_sparse_cuda.sparse_decode_cuda(tables, d_max, ev,
                                                          dets)
    assert device_sparse_cuda.launches == before + 1
    obs_p, conv_p = tds._sparse_plain(tables, d_max, ev, dets.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(obs_k, obs_p)
    assert torch.equal(conv_k, conv_p)
    return conv_p


@pytest.mark.parametrize("d_max", [1, 31, 32, 33, 48, 64])
def test_sparse_kernel_d_max(cuda, d_max):
    """Shots from 0 to ~45 defects (two slots a lane past 32), all-zero
    rows, rows with exactly d_max and d_max + 1 defects."""
    g = _graph("dem", 5)
    tables = tds._tables_to(tds.build_sparse_tables(g), cuda)
    V = g.num_nodes
    rng = np.random.default_rng(d_max)
    p = rng.choice([0.0, 0.02, 0.1, 0.3, 0.6], size=(3000, 1))
    dets = (rng.random((3000, V)) < p).astype(np.uint8)
    dets[:50] = 0
    for b, k in enumerate([d_max, d_max + 1] * 20):
        dets[50 + b] = 0
        dets[50 + b, rng.choice(V, min(k, V), replace=False)] = 1
    dets = torch.as_tensor(dets, device=cuda)
    conv = _sparse_equal(tables, d_max, d_max * (d_max + 1) // 2 + 4, dets)
    assert conv[:50].all()
    assert not conv[51:90:2].any()  # d_max + 1 defects: overflow
    if d_max >= 33:
        assert int(dets.sum(1).max()) > 32


@pytest.mark.parametrize("max_events", [1, 2])
def test_sparse_kernel_event_cap(cuda, max_events):
    g = _graph("dem", 5)
    tables = tds._tables_to(tds.build_sparse_tables(g), cuda)
    dets = _dets(g, 2000, 0.08, seed=max_events, device=cuda)
    conv = _sparse_equal(tables, 48, max_events, dets)
    assert not conv.all()


@pytest.mark.parametrize("offset", [1, 3, 8, 15])
def test_sparse_kernel_detector_views(cuda, offset):
    """Rows starting at any byte (a contiguous view off a 16-byte
    boundary) and rows at a stride wider than V: read in place."""
    g = _graph("dem", 5)
    tables = tds._tables_to(tds.build_sparse_tables(g), cuda)
    V = g.num_nodes
    rng = np.random.default_rng(offset)
    buf = torch.as_tensor((rng.random(1001 * (V + offset)) < 0.06).astype(
        np.uint8), device=cuda)
    dets = buf[offset:offset + 1000 * V].view(1000, V)
    assert dets.data_ptr() % 16 != 0
    _sparse_equal(tables, 48, 1180, dets)
    wide = buf[:999 * (V + offset)].view(999, V + offset)[:, offset:]
    assert wide.stride(0) == V + offset
    _sparse_equal(tables, 48, 1180, wide)


@pytest.mark.parametrize("scale", [1, 1 << 12])
def test_sparse_kernel_distance_scales(cuda, scale):
    """The graph's distances as they are and scaled past 2^15, each
    against the plain version on the same tables; the plan against the
    CPU model's."""
    from test_torch_sparse_schedule import _plan

    from qcss_tpu_torch.decode import device_sparse_cuda

    g = _graph("dem", 5)
    t = tds.build_sparse_tables(g)
    fin = t.dist < tds.UNREACH
    dist = np.where(fin, t.dist.astype(np.int64) * scale, tds.UNREACH)
    bdist = np.where(t.bdist < tds.UNREACH,
                     t.bdist.astype(np.int64) * scale, tds.UNREACH)
    tables = tds._tables_to(tds.sparse_tables_from_numpy(
        dist, t.phi, bdist, t.bside, t.num_nodes), cuda)
    plan = device_sparse_cuda.launch_plan(48)
    assert (plan["shots_per_block"], plan["threads"],
            plan["smem_bytes"]) == _plan(48)
    dets = _dets(g, 3000, 0.1, seed=scale % 97, device=cuda)
    _sparse_equal(tables, 48, 1180, dets)


@pytest.mark.parametrize("d,core,buf", [(3, 3, 3), (5, 5, 7), (11, 11, 16)])
def test_parallel_window_on_cuda_matches_cpu(cuda, d, core, buf):
    # every window shape through K1 (chunk lanes from d=5 on) against the
    # plain version on the CPU, bit for bit
    from qcss_tpu_torch.decode import device_uf_cuda
    from qcss_tpu_torch.decode.parallel_window import ParallelWindowDecoder
    from qcss_tpu_torch.decode.streaming import sample_phenomenological_stream

    code = rotated_surface(d)
    h, lz = code.raw_parity_check_c2, code.z_operator_matrix()
    gen = torch.Generator(device=cuda).manual_seed(d)
    dets, _ = sample_phenomenological_stream(gen, 0.01, 0.01, 96, 96, h, lz)
    before = (device_uf_cuda.launches, device_uf_cuda.chunk_launches)
    dec = ParallelWindowDecoder(h, lz, core=core, buf=buf, device=cuda)
    got = dec.decode_stream(dets)
    want = ParallelWindowDecoder(h, lz, core=core, buf=buf,
                                 device="cpu").decode_stream(dets.cpu())
    np.testing.assert_array_equal(got, want)
    # first, interior, last and seam windows: one launch each
    shapes = (dec._first, dec._mid, dec._seam, *dec._last.values())
    assert device_uf_cuda.launches - before[0] == len(shapes) == 4
    assert device_uf_cuda.chunk_launches - before[1] == sum(
        bool(g.stencil.chunks) for g in shapes) == (0 if d == 3 else
                                                   1 if d == 5 else 3)


def test_device_uf_decoder_on_cuda(cuda):
    # no caps: the stencil kernel, every shot converged, equal to the CPU
    from qcss_tpu_torch.decode import device_uf_cuda
    from qcss_tpu_torch.decode.uf import UFDecoder

    g = _graph("dem", 5)
    dets = _dets(g, 2048, 0.01, 8, cuda)
    before = device_uf_cuda.launches
    dec = tdu.DeviceUFDecoder(g, device=cuda)
    _, obs = dec.decode_batch(dets)
    assert device_uf_cuda.launches == before + 1 and dec.fallback_shots == 0
    _, obs_cpu = tdu.DeviceUFDecoder(g, device="cpu").decode_batch(
        dets.cpu())
    np.testing.assert_array_equal(obs, obs_cpu)
    _, host = UFDecoder(g).decode_batch(dets.cpu().numpy(),
                                        want_corrections=False)
    assert np.mean((host & 1) == (obs & 1)) > 0.93
    capped = tdu.DeviceUFDecoder(g, prop_cap=1, device=cuda)
    _, obs_c = capped.decode_batch(dets)
    assert capped.fallback_shots > 0


@pytest.mark.parametrize("decoder", ["uf", "dem", "mwpm", "dem-mwpm"])
def test_host_decoders_on_cuda_samples(cuda, decoder):
    # sampled on the card, decoded on the host: the tableau engine equals
    # the frames engine there too
    from qcss_tpu_torch.experiments.memory import memory_experiment
    from qcss_tpu_torch.sim.noise import NoiseModel

    kw = dict(rounds=3, noise=NoiseModel(p_gate2=1e-2, p_meas=1e-2),
              batch=1024, seed=4, decoder=decoder, device="cuda")
    a = memory_experiment(rotated_surface(3), engine="frames", **kw)
    b = memory_experiment(rotated_surface(3), engine="tableau", **kw)
    assert a["logical_fail"] > 0
    assert a["logical_fail"] == b["logical_fail"]
    assert a["residual_syndrome"] == b["residual_syndrome"]


def test_native_library_builds(cuda):
    from qcss_tpu_torch import native

    assert native.available(), native.load_error


# -- K3, K4 and K5: a warp a shot over member and frontier lists ----------

def _act_equal(dg, act, passes):
    """K4 on (act, passes) against its plain version, bit for bit; counted
    once."""
    from qcss_tpu_torch.decode import device_uf_cuda

    before = device_uf_cuda.staged_launches["act"]
    out = device_uf_cuda.stencil_act(dg, act, passes)
    assert torch.equal(out, tdu._act_plain(dg, act, passes))
    assert device_uf_cuda.staged_launches["act"] == before + 1
    return out


def _staged_equal(dg, packed, seed, sup, satm=None, satb=None):
    """K5 on (packed, seed, sup) and K3 on (packed, satm, satb) against
    their plain versions, bit for bit; K3's masks default to the
    saturation after K5's growth (as the staged decode hands them on)."""
    from qcss_tpu_torch.decode import device_uf_cuda

    O = len(dg.stencil.deltas)
    before = dict(device_uf_cuda.staged_launches)
    got = device_uf_cuda.stencil_round(dg, packed, seed, sup)
    ref = tdu._round_plain(dg, packed, seed, sup[:, :O], sup[:, O:])
    assert torch.equal(got[0], ref[0])
    assert torch.equal(got[1], torch.cat([ref[1], ref[2]], dim=1))
    assert torch.equal(got[2], ref[3])
    if satm is None:
        satm, satb = tdu._saturated(dg, ref[1], ref[2])
        satm, satb = satm.contiguous(), satb.contiguous()
    out = device_uf_cuda.stencil_prop(dg, packed, satm, satb)
    assert torch.equal(out, tdu._prop_plain(dg, packed, satm, satb))
    after = device_uf_cuda.staged_launches
    assert after["round"] == before["round"] + 1
    assert after["prop"] == before["prop"] + 1
    return ref, out


@pytest.mark.parametrize("B", [1, 33, 777, 16384])
def test_staged_kernels_on_the_d11_rounds(cuda, B):
    # the states entering growth rounds 1-6 of the d=11 fused staged
    # decode; the batch is no multiple of the shots a block but at 16384
    from qcss_tpu_torch.decode import device_uf_cuda

    g, dg = _d11_fused(2e-3)
    dg = dg.to(cuda)
    for kernel in ("prop", "round"):
        plan = device_uf_cuda.stencil_staged_config(dg, kernel)
        assert plan["shots_per_block"] > 1 and plan["tables_in_smem"]
        assert "shared memory" in plan["form"]
    plan = device_uf_cuda.stencil_staged_config(dg, "act")
    assert plan["shots_per_block"] > 1 and not plan["tables_in_smem"]
    assert plan["form"] == "no tables"
    dets = _dets(g, B, 0.02, seed=B, device=cuda)
    grew = spread = 0
    for s in round_inputs(dg, tdu.stencil_defect(dg, dets), 6):
        packed, seed, sup = s["packed"], s["seed"], s["sup"]
        ref, _ = _staged_equal(dg, packed, seed, sup)
        grew += int(ref[3].sum())
        act = _act_equal(dg, seed, s["passes"])
        spread += int((act != seed).sum())
    torch.cuda.synchronize()
    assert (grew > 0 and spread > 0) or B == 1


@pytest.mark.parametrize("change", ["none", "zero and negative weights",
                                    "weights past the narrow word"])
def test_staged_kernels_on_trap_states(cuda, change):
    # whole states that no decode reaches: labels not at a fixpoint,
    # supports past the weight, nonzero seeds other than 1, random masks,
    # a slot holder at comp 0 (the hub's lowest offer); weights of 0 and
    # below, and weights past 255, which the narrow word cannot hold (K5
    # then reads the int32 tables in device memory)
    from test_torch_staged_schedule import _trap_state

    from qcss_tpu_torch.decode import device_uf_cuda

    _, dg = _d11_fused(2e-3)
    st = dg.stencil
    ewt, bwt = st.ewt.clone(), st.bwt.clone()
    if change == "zero and negative weights":
        ewt[:, ::4] = 0
        ewt[:, 2::9] = -3
        bwt[:, 1::5] = 0
    elif change == "weights past the narrow word":
        ewt[:, ::5] = 300
        bwt = bwt * 2 + 255
    dg = dg._replace(stencil=st._replace(ewt=ewt, bwt=bwt))
    state = [x.to(cuda) for x in _trap_state(dg, 1001, seed=23)]
    dg = dg.to(cuda)
    form = device_uf_cuda.stencil_staged_config(dg, "round")["form"]
    assert ("device memory" in form) == (change != "none")
    packed, seed, sup, satm, satb = state
    _staged_equal(dg, packed, seed, sup, satm, satb)
    # K4 with K3's random masks as its passes (edges past the last vertex
    # among them) and seeds of 1-3 and -1
    act = seed.clone()
    act[::5, 2::13] = -1
    _act_equal(dg, act, satm)
    # and the views one element past a 16-byte boundary (K5's supports
    # then stream a word at a time)
    views = []
    for x in (packed, seed, sup, satm, satb, act):
        flat = torch.zeros(x.numel() + 1, dtype=x.dtype, device=cuda)
        views.append(flat[1:].view(x.shape))
        views[-1].copy_(x)
    _staged_equal(dg, *views[:5])
    _act_equal(dg, views[5], views[3])


def test_staged_kernels_on_the_parallel_window_interior(cuda):
    # the largest graph K1's plan takes (V=2581, O=4, KB=3; the wrappers
    # and the plain versions ignore its chunk lanes): labels only
    from qcss_tpu_torch.decode import device_uf_cuda
    from qcss_tpu_torch.decode.parallel_window import ParallelWindowDecoder

    code = rotated_surface(11)
    dec = ParallelWindowDecoder(code.raw_parity_check_c2,
                                code.z_operator_matrix(), core=11, buf=16,
                                device=cuda)
    mid = dec._mid
    assert mid.num_nodes + 1 == 2581
    for kernel in ("prop", "act", "round"):
        assert device_uf_cuda.stencil_staged_config(
            mid, kernel)["shots_per_block"] >= 1
    rng = np.random.default_rng(4)
    dets = torch.as_tensor((rng.random((513, mid.num_nodes)) < 0.01)
                           .astype(np.uint8), device=cuda)
    for s in round_inputs(mid, tdu.stencil_defect(mid, dets), 3):
        packed, seed, sup = s["packed"], s["seed"], s["sup"]
        _staged_equal(mid, packed, seed, sup)
        _act_equal(mid, seed, s["passes"])


def _synthetic_graph(V, O, KB, seed, L=2):
    """A stencil graph at the staged kernels' limits of O and KB, with
    random weights and L label bits."""
    rng = np.random.default_rng(seed)
    deltas = sorted(rng.choice(np.arange(1, 200), O, replace=False))
    emask = rng.random((O, V)) < 0.6
    for o, d in enumerate(deltas):
        emask[o, V - 1 - d:] = False  # no edge past the last vertex
    emask[:, V - 1] = False
    bmask = rng.random((KB, V)) < 0.3
    bmask[:, V - 1] = False
    return tdu.device_graph_from_numpy(
        deltas=deltas, emask=emask,
        ewt=rng.integers(1, 12, (O, V)), eobs=rng.integers(0, 1 << L, (O, V)),
        bmask=bmask, bwt=rng.integers(1, 12, (KB, V)),
        bobs=rng.integers(0, 1 << L, (KB, V)), pack_shift=L,
        lane_offsets=(0,), lane_masks=((1 << L) - 1,), num_nodes=V - 1,
        max_rounds=V)


@pytest.mark.parametrize("V,L,form", [
    (8000, 2, "int32 tables in device memory"),
    (4000, 2, "label bytes in shared memory"),
    (500, 12, "label words in shared memory")])
def test_staged_kernels_at_the_shape_limits(cuda, V, L, form):
    # O=10 and KB=4, at Vs whose tables do not fit beside a shot (both
    # kernels read them in device memory at V=8000, K5 at 4000), and at
    # L > 8 (K3 stages its label bits as int32); then at a V where one shot
    # of each does not fit a block: the wrappers raise, nothing falls back
    from qcss_tpu_torch.decode import device_uf_cuda

    dg = _synthetic_graph(V, 10, 4, seed=1, L=L).to(cuda)
    assert device_uf_cuda.stencil_staged_config(dg, "prop")["form"] == form
    assert device_uf_cuda.stencil_staged_config(
        dg, "round")["tables_in_smem"] == (V == 500)
    rng = np.random.default_rng(2)
    dets = torch.as_tensor((rng.random((65, V - 1)) < 0.02).astype(np.uint8),
                           device=cuda)
    for s in round_inputs(dg, tdu.stencil_defect(dg, dets), 3):
        packed, seed, sup = s["packed"], s["seed"], s["sup"]
        _staged_equal(dg, packed, seed, sup)
        _act_equal(dg, seed, s["passes"])
    big = _synthetic_graph(20000, 2, 1, seed=3).to(cuda)
    packed = tdu.initial_labels(big, 2, cuda)
    sup = torch.zeros((2, 3, 20000), dtype=torch.int32, device=cuda)
    masks = torch.zeros((2, 3, 20000), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        device_uf_cuda.stencil_round(big, packed, packed, sup)
    with pytest.raises(ValueError, match="shared memory"):
        device_uf_cuda.stencil_prop(big, packed, masks[:, :2].contiguous(),
                                    masks[:, 2:].contiguous())


def _act_state(rng, B, V, O, device, offset=0):
    """K4's input at random: act [B, V] int32 with values 0, 1, 2 and -1,
    passes [B, O, V] bool (30% set, edges past the last vertex among
    them); both views ``offset`` elements into a larger buffer."""
    act = rng.choice([0, 0, 0, 0, 0, 0, 1, 2, -1], (B, V)).astype(np.int32)
    passes = rng.random((B, O, V)) < 0.3
    out = []
    for x in (torch.as_tensor(act), torch.as_tensor(passes)):
        flat = torch.zeros(x.numel() + offset, dtype=x.dtype, device=device)
        out.append(flat[offset:].view(x.shape))
        out[-1].copy_(x)
    return out


@pytest.mark.parametrize("O", [1, 10])
def test_act_kernel_at_the_shape_limits(cuda, O):
    # K4 at O = 1 and 10 on an odd V (rows start off 16 bytes), on views
    # whose data pointers are off 16 bytes, at B = 0 and at four shots a
    # resident warp; then at the largest V whose shot fits a block (found
    # from the plan), and one vertex more, where the wrapper raises and
    # nothing falls back
    from qcss_tpu_torch.decode import device_uf_cuda

    rng = np.random.default_rng(O)
    dg = _synthetic_graph(4001, O, 1, seed=O).to(cuda)
    for B, offset in ((0, 0), (1, 0), (97, 0), (97, 1), (130, 3)):
        act, passes = _act_state(rng, B, 4001, O, cuda, offset)
        if offset:
            assert passes.data_ptr() % 16 and act.data_ptr() % 16
        out = _act_equal(dg, act, passes)
        assert out.shape == (B, 4001)
        if B:
            assert bool((out == 1).any() & (out == 0).any())
    # four shots a resident warp, on views off 16 bytes: every warp takes
    # several shots, so the next shot's loads issued during a shot's
    # spread, and each shot's own run offsets, are checked at this O
    plan = device_uf_cuda.stencil_staged_config(dg, "act")
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    B = 4 * plan["shots_per_block"] * plan["blocks_per_sm"] * sms
    act, passes = _act_state(rng, B, 4001, O, cuda, offset=5)
    assert passes.data_ptr() % 16 and act.data_ptr() % 16
    _act_equal(dg, act, passes)
    lo, hi = 4001, 65537  # the plan fits lo and not hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        plan = device_uf_cuda._staged_query(4, mid, O, 1, 2)
        lo, hi = (mid, hi) if plan["shots_per_block"] else (lo, mid)
    assert device_uf_cuda._staged_query(4, lo, O, 1, 2)[
        "shots_per_block"] == 1
    big = _synthetic_graph(lo, O, 1, seed=5).to(cuda)
    act, passes = _act_state(rng, 3, lo, O, cuda)
    _act_equal(big, act, passes)
    over = _synthetic_graph(lo + 1, O, 1, seed=6).to(cuda)
    act, passes = _act_state(rng, 1, lo + 1, O, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        device_uf_cuda.stencil_act(over, act, passes)
