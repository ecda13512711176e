"""The port's BP+OSD decoder (`qcss_tpu_torch.decode.bp`) against the JAX
package's, on the CPU.

Inputs are drawn with numpy from a seed and fed to both packages. BP's
hard decisions and convergence must be equal on every shot, and its soft
LLR totals agree within rtol 1e-4 / atol 1e-4 (float32 sums are taken in
another order). OSD-0 is fed the reference's own soft values and must be
bit-identical on the host and on the port's device path; OSD-E must find
the same soft weight, with solutions equal wherever the best two
candidates differ by more than 1e-4. Each test uses the smallest instance
that reaches its code path and names the reference test it stands in
for (tests/test_bp.py).
"""

import numpy as np
import pytest
import torch

from qcss_tpu.decode import bp as jbp
from qcss_tpu_torch.codes import families as tfam
from qcss_tpu_torch.decode import bp as tbp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # several worker processes run at once; see test_torch_device_uf.py
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bb72(p=0.03, batch=128, seed=3):
    code = tfam.bb72()
    h2 = np.asarray(code.redundant_parity_check_c2, np.uint8) & 1
    lz = np.asarray(code.z_operator_matrix(), np.uint8) & 1
    rng = np.random.default_rng(seed)
    errs = (rng.random((batch, code.n)) < p).astype(np.uint8)
    return h2, lz, ((errs @ h2.T) & 1).astype(np.uint8), 2.0 * p / 3.0


def _surface_spacetime(batch=128, seed=5):
    """spacetime_tanner(rotated_surface(3), 2) with numpy-drawn faults."""
    code = tfam.rotated_surface(3)
    tan, priors, obs, _ = tbp.spacetime_tanner(
        code.raw_parity_check_c2, 2, 0.03, 0.03,
        logicals=code.z_operator_matrix())
    rng = np.random.default_rng(seed)
    ev = (rng.random((batch, tan.shape[1])) < priors[None]).astype(np.uint8)
    return tan, obs, ((ev @ tan.T) & 1).astype(np.uint8), priors


INSTANCES = {"bb72": _bb72, "surface3_spacetime": _surface_spacetime}


def _both(h, priors, **kw):
    return (jbp.BPDecoder(h, priors, **kw),
            tbp.BPDecoder(h, priors, device="cpu", **kw))


def _assert_bp_equal(ref, port):
    e_j, c_j, s_j = (np.asarray(x) for x in ref)
    e_t, c_t, s_t = (x.numpy() for x in port)
    np.testing.assert_array_equal(c_t, c_j)
    # a shot whose hard decisions differ must sit on a total within
    # float error of 0 (none does on these instances)
    differ = (e_t != e_j).any(axis=1)
    assert (np.abs(s_j[differ]).min(axis=1) < 1e-3).all()
    np.testing.assert_array_equal(e_t, e_j)
    np.testing.assert_allclose(s_t, s_j, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("inst", sorted(INSTANCES))
@pytest.mark.parametrize("layout,gamma", [("dense", 0.0), ("gather", 0.0),
                                          ("dense", 0.3), ("gather", 0.3)])
def test_bp_matches_reference(inst, layout, gamma):
    """Stands in for test_dense_and_gather_layouts_agree_on_convergence
    (there: bb72, B=256, each layout alone): both layouts and damping,
    shot for shot against the reference, some shots unconverged."""
    h, _, syn, priors = INSTANCES[inst]()
    jd, td = _both(h, priors, iters=12, layout=layout, gamma=gamma,
                   osd=False)
    ref, port = jd._run(syn), td._run(syn)
    assert not np.asarray(ref[1]).all()  # the final-totals path runs
    _assert_bp_equal(ref, port)


def test_layout_auto_threshold():
    """'auto' takes the gather layout past r * Dc * n = 2^26 incidence
    entries in both packages (the layouts differ in summation order, so
    the threshold is semantics)."""
    r, dc = 64, 32
    for n, gather in ((1 << 15, False), ((1 << 15) + 1, True)):
        h = np.zeros((r, n), np.uint8)
        for c in range(r):
            h[c, c * dc:(c + 1) * dc] = 1
        assert r * dc * n > (1 << 26) or not gather
        jd, td = _both(h, 0.01, iters=1)
        assert jd._use_gather == td._use_gather == gather


def test_early_exit_cadence_and_chunks_change_nothing(monkeypatch):
    """The all-converged read every `_CHECK_EVERY` iterations, and BP
    chunks, leave every output unchanged: converged shots are frozen and
    unconverged ones run exactly `iters` iterations."""
    h, _, syn, priors = _bb72(p=0.02)
    dec = tbp.BPDecoder(h, priors, iters=10, osd=False, device="cpu")
    base = dec._run(syn)
    assert 0 < base[1].sum() < len(syn)
    for every, chunk_bytes in ((1, 1 << 31), (3, 1 << 31), (25, 1 << 31),
                               (4, 4 * 3 * dec.r * dec.dc)):
        monkeypatch.setattr(tbp, "_CHECK_EVERY", every)
        monkeypatch.setattr(tbp, "_BP_CHUNK_BYTES", chunk_bytes)
        for a, b in zip(dec._run(syn), base):
            assert torch.equal(a, b)


def test_device_osd_bit_identical_to_host():
    """Stands in for test_device_osd_bit_identical_to_host: OSD-0 on the
    reference's own soft values (crippled BP, bb72 and the surface
    spacetime graph) on the reference's host path, the port's host path
    and the port's device path; then soft values with exact ties (stable
    column order) and random small graphs."""
    for inst in sorted(INSTANCES):
        h, _, syn, priors = INSTANCES[inst]()
        jd = jbp.BPDecoder(h, priors, iters=2)
        soft = np.asarray(jd._run(syn)[2])
        e_ref = jd._osd0(syn, soft)
        td = tbp.BPDecoder(h, priors, iters=2, osd_backend="device",
                           device="cpu")
        np.testing.assert_array_equal(td._osd0(syn, soft), e_ref)
        np.testing.assert_array_equal(td._osd0_any(syn, soft), e_ref)
        # ties: LLRs on a coarse grid, most columns tied with others
        tied = np.round(soft * 2.0) / 2.0
        np.testing.assert_array_equal(td._osd0_any(syn, tied),
                                      jd._osd0(syn, tied))
    rng = np.random.default_rng(7)
    for trial in range(6):
        r, n = int(rng.integers(3, 12)), int(rng.integers(10, 50))
        h = (rng.random((r, n)) < 0.4).astype(np.uint8)
        e = (rng.random((8, n)) < 0.2).astype(np.uint8)
        s = ((e @ h.T) & 1).astype(np.uint8)
        sf = rng.integers(-3, 4, size=(8, n)).astype(np.float32)
        td = tbp.BPDecoder(h, 0.05, osd_backend="device", device="cpu")
        np.testing.assert_array_equal(td._osd0_any(s, sf),
                                      jbp._osde_py(h, s, sf, 0, 0, 0),
                                      err_msg=f"trial {trial}")


@pytest.mark.parametrize("order,lam", [(1, (16, 10)), (2, (16, 10)),
                                       (2, (4, 6))])
def test_device_osde_matches_host_sweep(order, lam):
    """The port's device order-E sweep against the reference's native
    sweep on the reference's soft values: the same soft weight, and the
    same solution wherever the best two candidates are more than 1e-4
    apart (a differing solution is a near-tie)."""
    h, _, syn, priors = _bb72(p=0.04)
    jd = jbp.BPDecoder(h, priors, iters=2, osd_order=order, osd_lambda=lam)
    soft = np.asarray(jd._run(syn)[2])
    e_ref = jd._osde_any(syn, soft)
    td = tbp.BPDecoder(h, priors, iters=2, osd_order=order, osd_lambda=lam,
                       osd_backend="device", device="cpu")
    e_dev = td._osd0_any(syn, soft)
    np.testing.assert_array_equal((e_dev @ h.T) & 1, syn)
    w = np.abs(soft).astype(np.float64)
    w_ref, w_dev = (e_ref * w).sum(axis=1), (e_dev * w).sum(axis=1)
    np.testing.assert_allclose(w_dev, w_ref, rtol=1e-5, atol=1e-4)
    differ = (e_dev != e_ref).any(axis=1)
    assert (np.abs(w_dev - w_ref)[differ] <= 1e-4).all()
    # the sweep improved on OSD-0 somewhere, so it was exercised
    assert (w_ref < (jd._osd0(syn, soft) * w).sum(axis=1) - 1e-3).any()


@pytest.mark.parametrize("backend", ["host", "device"])
def test_osde_without_candidates_is_osd0(backend):
    """A named divergence (ROADMAP §3): with osd_order=1 and lam1=0 there
    is no candidate. The reference's device sweep stacks an empty list
    and raises (bp.py, `_osde_device_kernel`); its host sweep returns
    OSD-0. The port returns OSD-0 on both backends."""
    h, _, syn, priors = _bb72(p=0.04)
    jd = jbp.BPDecoder(h, priors, iters=2)
    soft = np.asarray(jd._run(syn)[2])
    td = tbp.BPDecoder(h, priors, iters=2, osd_order=1, osd_lambda=(0, 10),
                       osd_backend=backend, device="cpu")
    np.testing.assert_array_equal(td._osd0_any(syn, soft),
                                  jd._osd0(syn, soft))


def test_decode_obs_paths_match_reference():
    """Stands in for test_osd_fallback_satisfies_syndrome and the
    end-to-end half of test_device_osd_bit_identical_to_host: crippled BP
    with an OSD tail; `decode_obs` and `decode_obs_device` of the port
    equal the reference's `decode_obs` shot for shot."""
    h, lz, syn, priors = _bb72(p=0.04)
    jd, td = _both(h, priors, logicals=lz, iters=3)
    flips_j, conv_j = jd.decode_obs(syn)
    flips_t, conv_t = td.decode_obs(syn)
    assert not conv_t.all()
    np.testing.assert_array_equal(conv_t, np.asarray(conv_j))
    np.testing.assert_array_equal(flips_t, np.asarray(flips_j))
    e_t, _ = td.decode_batch(syn)
    np.testing.assert_array_equal((e_t @ h.T) & 1, syn)
    stats = {}
    flips_d, conv_d = td.decode_obs_device(torch.as_tensor(syn),
                                           stats=stats)
    np.testing.assert_array_equal(flips_d.numpy(), flips_t)
    np.testing.assert_array_equal(conv_d, conv_t)
    assert stats["tail"] == (~conv_t).sum() and stats["iters"] == 3
    assert stats["tail_backend"] == "device" and stats["host_fallback"] == 0


def test_decode_obs_gap_matches_reference():
    """Stands in for test_gap_postselection's gap and flips (bb72 code
    capacity): flips and the complementary gap equal the reference's."""
    h, lz, syn, priors = _bb72(p=0.03, batch=32)
    jd, td = _both(h, priors, logicals=lz, iters=8)
    fj, cj, gj = jd.decode_obs_gap(syn)
    ft, ct, gt = td.decode_obs_gap(syn)
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_allclose(gt, gj, rtol=1e-6)


def test_restarts_and_priors():
    """restarts=0 is exactly BP; restarted shots that converge satisfy
    their syndromes (the jitter's stream is torch's, so only the rule is
    held); per-shot priors equal to the static ones change nothing; and
    priors outside (0, 0.5) are refused."""
    h, _, syn, priors = _bb72(p=0.04)
    base = tbp.BPDecoder(h, priors, iters=4, osd=False, device="cpu")
    e0, c0 = base.decode_batch(syn)
    rs = tbp.BPDecoder(h, priors, iters=4, osd=False, restarts=3,
                       device="cpu")
    e1, c1 = rs.decode_batch(syn)
    assert (c1 >= c0).all() and c1.sum() > c0.sum()
    np.testing.assert_array_equal(e1[c0], e0[c0])
    np.testing.assert_array_equal(((e1 @ h.T) & 1)[c1], syn[c1])
    e2, c2 = base.decode_batch(syn, priors=np.full((len(syn), h.shape[1]),
                                                   priors))
    np.testing.assert_array_equal(e2, e0)
    np.testing.assert_array_equal(c2, c0)
    with pytest.raises(ValueError):
        tbp.BPDecoder(h, 0.5, device="cpu")


def test_memory_rates_meet_reference_golds():
    """The golds of test_bb72_code_capacity_suppression (bb72, p=1e-2:
    word failure under 2%, BP convergence over 98%) and
    test_spacetime_tanner_decode (Steane-sized failure well under the raw
    exposure) on the port's samplers, at a smaller batch."""
    res = tbp.bp_logical_error_rate(tfam.bb72(), 0.01, batch=512, seed=0,
                                    iters=32, device="cpu")
    assert res["word_fail"] < 0.02 and res["bp_converged"] > 0.98
    res = tbp.bp_phenomenological_error_rate(
        tfam.rotated_surface(3), 3, 0.003, 0.003, batch=512, seed=0,
        iters=32, device="cpu")
    assert res["x_fail"] < 0.04 and res["bp_converged"] > 0.9
