"""The port's two-sector sampler and circuit-level qLDPC memory
(`qcss_tpu_torch.experiments.memory_xz`, `.memory_qldpc`) against the
JAX package's, on the CPU.

The decode is held shot for shot: the port's `qldpc_memory_experiment`
and `xz_memory_experiment` run on the reference sampler's own shots
(their `_sample_two_sector` is replaced, in the test only, by one that
returns them), and must report the reference's rates exactly, on the
device path, with the joint and correlated decoders and with the
union-find correlated re-weighting. The streaming memory draws the same
numbers as the whole-history sampler, and its window loop must give the
reference streaming decoder's failures on those shots exactly. The
samplers cannot share random bits, so they are held by rates:
per-sector detector firing and the failure rates of one deterministic
decoder applied to each sampler's shots, inside 99.9% Wilson intervals.
"""

import math
from functools import partial

import jax
import numpy as np
import pytest
import torch

from qcss_tpu.codes import families as jfam
from qcss_tpu.decode import bp_dem as jbp_dem
from qcss_tpu.decode import bp_streaming as jbs
from qcss_tpu.experiments import memory_qldpc as jmq
from qcss_tpu.experiments import memory_xz as jxz
from qcss_tpu.sim import frame as jfr
from qcss_tpu.sim.noise import NoiseModel as JNoise
from qcss_tpu_torch.codes import families as tfam
from qcss_tpu_torch.decode import bp_dem as tbp_dem
from qcss_tpu_torch.decode.bp import use_device
from qcss_tpu_torch.decode.bp_streaming import CircuitBPStreamingDecoder
from qcss_tpu_torch.decode.dem2 import build_two_sector_dem
from qcss_tpu_torch.decode.spacetime import detector_history
from qcss_tpu_torch.decode.uf import UFDecoder
from qcss_tpu_torch.experiments import memory_qldpc as tmq
from qcss_tpu_torch.experiments import memory_xz as txz
from qcss_tpu_torch.sim import noise as tnoise
from qcss_tpu_torch.sim.noise import NoiseModel as TNoise

Z999 = 3.2905
P = dict(p_gate2=5e-3, p_gate1=5e-3, p_meas=5e-3, p_reset=5e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # several worker processes run at once; see test_torch_device_uf.py
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_samples(code, rounds, noise, batch, seed, hz, hx):
    """The reference sampler's shots, drawn as its experiments draw them."""
    n, rz = code.n, hz.shape[0]
    z_arrays = tuple(map(jax.numpy.asarray, jxz.z_extraction_circuit(
        code, checks=hz).to_arrays()))
    x_arrays = tuple(map(jax.numpy.asarray, jxz.x_extraction_circuit(
        code, anc_offset=n + rz, checks=hx).to_arrays()))
    nq = n + rz + hx.shape[0]
    fn = jax.jit(partial(jxz._sample_two_sector, code=code, noise=noise,
                         z_arrays=z_arrays, x_arrays=x_arrays,
                         z_comp=jfr.maybe_compile(z_arrays, nq),
                         x_comp=jfr.maybe_compile(x_arrays, nq),
                         rz=rz, rx=hx.shape[0]),
                 static_argnames=("batch", "rounds"))
    return tuple(np.asarray(a) for a in fn(jax.random.key(seed), batch,
                                           rounds))


def _wilson(k, n, z=Z999):
    p = k / n
    den = 1 + z * z / n
    mid = (p + z * z / (2 * n)) / den
    half = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / den
    return mid - half, mid + half


def test_tanner_graphs_equal():
    """The copied Tanner builders on both packages' codes, array for
    array (Steane R=2, both sectors and the window graph)."""
    kw = dict(p_gate2=2e-3, p_meas=5e-3, p_reset=2e-3)
    for sector in ("z", "x"):
        tj = jbp_dem.build_circuit_tanner(jfam.steane(), 2, JNoise(**kw),
                                          sector=sector)
        tt = tbp_dem.build_circuit_tanner(tfam.steane(), 2, TNoise(**kw),
                                          sector=sector)
        for attr in ("checks", "priors", "obs"):
            np.testing.assert_array_equal(getattr(tt, attr),
                                          getattr(tj, attr))
    wj = jbp_dem.open_window_circuit_tanner(jfam.steane(), 8, 4, JNoise(**kw))
    wt = tbp_dem.open_window_circuit_tanner(tfam.steane(), 8, 4, TNoise(**kw))
    for attr in ("checks", "priors", "obs", "carry", "committed"):
        np.testing.assert_array_equal(getattr(wt, attr), getattr(wj, attr))


STEANE_SHOTS = dict(rounds=2, batch=256, seed=11)


@pytest.fixture(scope="module")
def steane_replay():
    """The reference sampler's shots at Steane, STEANE_SHOTS, and
    stand-ins for the port's and the reference's `_sample_two_sector` that
    return them (the reference's experiments would draw the same shots
    from the same seed; the stand-in saves their sampler's compile). The
    Steane code has no redundant checks, so the raw checks that
    `xz_memory_experiment` samples with are `memory_qldpc`'s too."""
    hz, hx = tmq._checks(tfam.steane())
    assert np.array_equal(hz, tfam.steane().raw_parity_check_c2)
    shots = _ref_samples(jfam.steane(), STEANE_SHOTS["rounds"], JNoise(**P),
                         STEANE_SHOTS["batch"], STEANE_SHOTS["seed"], hz, hx)

    def replay(generator, batch_, rounds_, *args, **kw):
        assert (batch_, rounds_) == (STEANE_SHOTS["batch"],
                                     STEANE_SHOTS["rounds"])
        return tuple(torch.tensor(a, device=generator.device)
                     for a in shots)

    def ref_replay(key, batch, rounds, **kw):
        # under the reference's jit, whose static arguments these are
        assert (batch, rounds) == (STEANE_SHOTS["batch"],
                                   STEANE_SHOTS["rounds"])
        return tuple(jax.numpy.asarray(a) for a in shots)

    return replay, ref_replay


def test_memory_decodes_reference_shots_identically(monkeypatch,
                                                    steane_replay):
    """Stands in for test_bp.py's circuit-level and joint / two-pass
    tests: Steane R=2, B=256, the reference's own shots. The reference's
    host path (joint and correlated on) against the port's device path
    and its host path, every rate equal."""
    code_j, code_t = jfam.steane(), tfam.steane()
    monkeypatch.setattr(tmq, "_sample_two_sector", steane_replay[0])
    monkeypatch.setattr(jmq, "_sample_two_sector", steane_replay[1])
    kw = dict(STEANE_SHOTS, iters=16)
    ref = jmq.qldpc_memory_experiment(code_j, noise=JNoise(**P), joint=True,
                                      correlated=True, **kw)
    host = tmq.qldpc_memory_experiment(code_t, noise=TNoise(**P), joint=True,
                                       correlated=True, device="cpu", **kw)
    dev = tmq.qldpc_memory_experiment(code_t, noise=TNoise(**P),
                                      device="cpu", **kw)
    assert ref["x_fail"] > 0 and ref["bp_converged_z"] < 1
    for key, val in ref.items():
        assert host[key] == val, key
        if key in dev:
            assert dev[key] == val, key
    gap = tmq.qldpc_memory_experiment(code_t, noise=TNoise(**P),
                                      device="cpu", gap_tau=2.0, **kw)
    assert gap["x_fail"] == ref["x_fail"] and 0 < gap["gap_keep"] <= 1


def _decoded_rates(code, rounds, noise, syns_z, syns_x, x_err, z_err):
    """One deterministic decoder (union-find on the two-sector DEM) on a
    sampler's shots: per-sector fraction of shots with a detector fired,
    and x_fail / z_fail counts."""
    hz = np.asarray(code.raw_parity_check_c2, np.uint8)
    hx = np.asarray(code.raw_parity_check_c1, np.uint8)
    dets_z = detector_history(syns_z, ((x_err @ hz.T) & 1).astype(np.uint8))
    dets_x = detector_history(syns_x, ((z_err @ hx.T) & 1).astype(np.uint8))
    dem = build_two_sector_dem(code, rounds, noise)
    _, obs_z = UFDecoder(dem.graph_x_errors).decode_batch(
        dets_z, want_corrections=False)
    _, obs_x = UFDecoder(dem.graph_z_errors).decode_batch(
        dets_x, want_corrections=False)
    lz, lx = code.z_operator_matrix()[0], code.x_operator_matrix()[0]
    return {"fired_z": int(dets_z.any(axis=1).sum()),
            "fired_x": int(dets_x.any(axis=1).sum()),
            "x_fail": int(((obs_z & 1) != (x_err @ lz) & 1).sum()),
            "z_fail": int(((obs_x & 1) != (z_err @ lx) & 1).sum())}


def test_sampler_rates_match_reference():
    """The two-sector sampler with the idle channel on (p_idle): Steane,
    R=3, B=4096. The port's shots (its generator order, module
    docstring) and the reference's are decoded by the same union-find;
    each count falls in the 99.9% Wilson interval of the other's."""
    rounds, batch = 3, 4096
    kw = dict(P, p_idle=4e-3)
    code = tfam.steane()
    hz = np.asarray(code.raw_parity_check_c2, np.uint8)
    hx = np.asarray(code.raw_parity_check_c1, np.uint8)
    ref = _decoded_rates(code, rounds, TNoise(**kw), *_ref_samples(
        jfam.steane(), rounds, JNoise(**kw), batch, 3, hz, hx))
    gen = torch.Generator().manual_seed(3)
    shots = txz._sample_two_sector(
        gen, batch, rounds, code, TNoise(**kw),
        *txz.two_sector_circuits(code, hz, hx, torch.device("cpu")),
        rz=hz.shape[0], rx=hx.shape[0])
    port = _decoded_rates(code, rounds, TNoise(**kw),
                          *(a.numpy() for a in shots))
    for key in ref:
        lo, hi = _wilson(ref[key], batch)
        assert lo <= port[key] / batch <= hi, (key, ref, port)
        lo, hi = _wilson(port[key], batch)
        assert lo <= ref[key] / batch <= hi, (key, ref, port)
    assert min(ref.values()) > 0


def test_sampler_generator_order():
    """The order written in `memory_xz`'s docstring, replayed draw for
    draw from the same seed with the port's channels: idle, then per
    sector the circuit's faults, measurement flips, reset flips."""
    code = tfam.steane()
    hz = np.asarray(code.raw_parity_check_c2, np.uint8)
    hx = np.asarray(code.raw_parity_check_c1, np.uint8)
    rz, n = hz.shape[0], code.n
    noise = TNoise(**P, p_idle=4e-3)
    cpu = torch.device("cpu")
    circ = txz.two_sector_circuits(code, hz, hx, cpu)
    out = txz._sample_two_sector(torch.Generator().manual_seed(9), 64, 2,
                                 code, noise, *circ, rz=rz, rx=hx.shape[0])
    g = torch.Generator().manual_seed(9)
    nq = n + rz + hx.shape[0]
    x = torch.zeros((64, nq), dtype=torch.uint8)
    z = torch.zeros_like(x)
    syns = []
    x_hi, z_lo, z_hi = tnoise._thresholds_1q(noise.rate_idle)
    for _ in range(2):
        u = torch.rand((64, n), generator=g)
        x[:, :n] ^= (u < x_hi).to(torch.uint8)
        z[:, :n] ^= ((u >= z_lo) & (u < z_hi)).to(torch.uint8)
        for arrays, anc in ((circ[0], range(n, n + rz)),
                            (circ[1], range(n + rz, nq))):
            f = tnoise.sampled_fault_bits(arrays[0], noise, g, 64)
            f = txz.fr.run_arrays_noisy(txz.fr.Frames(x, z), *arrays, noise,
                                        fault_bits=f)
            x, z = f.x.clone(), f.z.clone()
            anc = list(anc)
            syn = x[:, anc] ^ (torch.rand((64, len(anc)), generator=g)
                               < noise.p_meas).to(torch.uint8)
            x[:, anc] = (torch.rand((64, len(anc)), generator=g)
                         < noise.p_reset).to(torch.uint8)
            z[:, anc] = 0
            syns.append(syn)
    assert torch.equal(out[0], torch.stack(syns[0::2]))
    assert torch.equal(out[1], torch.stack(syns[1::2]))
    assert torch.equal(out[2], x[:, :n]) and torch.equal(out[3], z[:, :n])


def test_analog_readout_branch():
    """sigma: with no other noise, every syndrome bit is an analog readout
    flip (u ~ N(1, sigma), flip iff u < 0) at rate Phi(-1/sigma), and the
    amplitudes |u| come back [B, R, r]."""
    code = tfam.steane()
    hz = np.asarray(code.raw_parity_check_c2, np.uint8)
    hx = np.asarray(code.raw_parity_check_c1, np.uint8)
    sigma, batch = 0.5, 2048
    out = txz._sample_two_sector(
        torch.Generator().manual_seed(1), batch, 2, code, TNoise(),
        *txz.two_sector_circuits(code, hz, hx, torch.device("cpu")),
        rz=hz.shape[0], rx=hx.shape[0], sigma=sigma)
    syns_z, amps_z = out[0], out[4]
    assert amps_z.shape == (batch, 2, hz.shape[0]) and (amps_z >= 0).all()
    k, m = int(syns_z.sum()), syns_z.numel()
    lo, hi = _wilson(k, m)
    assert lo <= 0.5 * math.erfc(1 / sigma / math.sqrt(2)) <= hi


def test_xz_memory_decodes_reference_shots_identically(monkeypatch,
                                                       steane_replay):
    """Stands in for test_memory_xz.py's correlated-decoding tests:
    `xz_memory_experiment` at Steane R=2, B=256 on the reference's own
    shots. Every rate (x_fail, z_fail, z_fail_corr, word_fail,
    word_fail_corr) and the pair count equal the reference's."""
    monkeypatch.setattr(txz, "_sample_two_sector", steane_replay[0])
    monkeypatch.setattr(jxz, "_sample_two_sector", steane_replay[1])
    ref = jxz.xz_memory_experiment(jfam.steane(), noise=JNoise(**P),
                                   **STEANE_SHOTS)
    port = txz.xz_memory_experiment(tfam.steane(), noise=TNoise(**P),
                                    device="cpu", **STEANE_SHOTS)
    assert ref["x_fail"] > 0 and ref["z_fail"] > 0 and ref["pairs"] > 0
    assert port == ref


def test_xz_memory_experiment():
    """The UF two-sector memory runs on the port (its rates are the
    decoded counts of test_sampler_rates_match_reference); belief-matching
    is not ported and says where it is queued."""
    out = txz.xz_memory_experiment(tfam.steane(), rounds=2,
                                   noise=TNoise(**P), batch=512,
                                   device="cpu")
    assert 0 < out["word_fail"] < 0.5 and out["pairs"] > 0
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        txz.xz_memory_experiment(tfam.steane(), rounds=2, noise=TNoise(**P),
                                 batch=8, belief=True, device="cpu")


def test_circuit_stream_matches_whole_history():
    """Stands in for TestCircuitStreamingBP (Steane R=12 there, 100%
    agreement): the copied sliding-window decoder on the port's BP
    against the whole-history circuit decoder, Steane R=9, on the port's
    shots."""
    code = tfam.steane()
    hz, hx = tmq._checks(code)
    rounds, batch = 9, 128
    noise = TNoise(**P)
    syns_z, _, x_err, _ = txz._sample_two_sector(
        torch.Generator().manual_seed(4), batch, rounds, code, noise,
        *txz.two_sector_circuits(code, hz, hx, torch.device("cpu")),
        rz=hz.shape[0], rx=hx.shape[0])
    x_err = x_err.numpy()
    dets = detector_history(syns_z.numpy(),
                            ((x_err @ hz.T) & 1).astype(np.uint8))
    with use_device("cpu"):
        whole, _ = tbp_dem.circuit_bp_decoder(
            code, rounds, noise, iters=32).decode_obs(dets)
        stream, _ = CircuitBPStreamingDecoder(
            code, noise, window=8, commit=4, iters=32).decode_stream(
                dets.reshape(batch, rounds + 1, -1))
    assert np.mean((whole == stream).all(axis=1)) >= 0.98


def test_stream_memory_rate_equals_reference_decode():
    """`qldpc_stream_memory_rate` at Steane, R=13, B=64, window 8, commit
    4, both sectors, idle on: two window steps, a short last chunk, the
    final step. Its chunked sampler draws the same numbers as the
    whole-history `_sample_two_sector` from the same seed (itself held to
    the reference by rates), so on those shots its rates and window
    convergence must equal the reference's `CircuitBPStreamingDecoder`'s
    exactly; the port's streaming decoder gives the reference's flips
    and convergence shot for shot."""
    code = tfam.steane()
    hz, hx = tmq._checks(code)
    rounds, batch, seed = 13, 64, 6
    kw = dict(P, p_idle=4e-3)
    out = tmq.qldpc_stream_memory_rate(code, TNoise(**kw), rounds=rounds,
                                       batch=batch, sectors="both",
                                       seed=seed, device="cpu")
    syns_z, syns_x, x_err, z_err = (a.numpy() for a in txz._sample_two_sector(
        torch.Generator().manual_seed(seed), batch, rounds, code,
        TNoise(**kw), *txz.two_sector_circuits(code, hz, hx,
                                                torch.device("cpu")),
        rz=hz.shape[0], rx=hx.shape[0]))
    fails, conv = [], np.ones(batch, bool)
    for sector, syns, err, h, lg in (
            ("z", syns_z, x_err, hz, code.z_operator_matrix()),
            ("x", syns_x, z_err, hx, code.x_operator_matrix())):
        dets = detector_history(syns, ((err @ h.T) & 1).astype(np.uint8))
        dets = dets.reshape(batch, rounds + 1, -1)
        args = dict(sector=sector, window=8, commit=4, iters=48, alpha=0.8,
                    osd=True, hz=hz, hx=hx)
        flips, c = jbs.CircuitBPStreamingDecoder(
            jfam.steane(), JNoise(**kw), **args).decode_stream(dets)
        if sector == "z":
            with use_device("cpu"):
                tflips, tc = CircuitBPStreamingDecoder(
                    code, TNoise(**kw), **args).decode_stream(dets)
            np.testing.assert_array_equal(tflips, flips)
            np.testing.assert_array_equal(tc, c)
        conv &= c
        par = (err.astype(np.int64) @ np.asarray(lg, np.int64).T) & 1
        fails.append((flips ^ par).any(axis=1))
    assert fails[0].any() and not conv.all()
    assert out["x_fail"] == fails[0].mean()
    assert out["z_fail"] == fails[1].mean()
    assert out["word_fail"] == (fails[0] | fails[1]).mean()
    assert out["bp_all_windows_converged"] == conv.mean()
    assert out["round_shots_per_sec"] > 0
