"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and nvcc (the kernels are built from
qcss_tpu_torch/csrc at first use and have no CPU mode), so each skips
without one. This file imports torch and the port only, so that it runs
on a machine without JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Comparisons are exact: each kernel reproduces its plain version bit for
bit (packed labels, activity, obs, convergence).
"""

import numpy as np
import pytest
import torch

from qcss_tpu_torch.codes.families import rotated_surface
from qcss_tpu_torch.decode import device_sparse as tds
from qcss_tpu_torch.decode import device_uf as tdu
from qcss_tpu_torch.decode.dem import circuit_level_graph, extraction_gate_list
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
    packed_k, act_k = device_uf_cuda.stencil_full(dg, defect)
    assert device_uf_cuda.launches == before + 1
    packed_p, act_p = tdu._stencil_plain(dg, defect)
    torch.cuda.synchronize()
    assert torch.equal(packed_k, packed_p)
    assert torch.equal(act_k, act_p)


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
    rng = np.random.default_rng(0)
    wide = tdu.build_device_graph(
        g, extra_lanes=(rng.integers(0, 1 << 28, g.num_edges),),
        spill_lanes=True).to(cuda)
    assert wide.stencil.chunks
    with pytest.raises(NotImplementedError):
        tdu.decode_obs(wide, _dets(g, 4, 0.1, seed=0, device=cuda))


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
