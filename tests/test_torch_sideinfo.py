"""The port's per-shot side-information experiments — soft readout,
heralded erasure, leakage (`qcss_tpu_torch.experiments.soft`, `.erasure`,
`.leakage`) — against the JAX package's, on the CPU.

Decodes are held bit for bit on the reference sampler's own shots: the
reference's samplers run as its experiments call them (wrapped, in the
test only, to record what they return), and the port's samplers are
replaced by ones that return those draws; every failure count must equal
the reference's. The port's samplers draw from torch generators, so they
are held by rates: each count falls inside the 99.9% Wilson interval of
the rate the model fixes, or of the reference's count. Each test names
the reference test it stands in for and stays far below its size.
"""

import math
from functools import partial
from itertools import combinations

import jax
import numpy as np
import pytest
import torch

from qcss_tpu.codes import families as jfam
from qcss_tpu.decode import device_uf as jduf
from qcss_tpu.decode import uf as juf
from qcss_tpu.experiments import erasure as jer
from qcss_tpu.experiments import leakage as jlk
from qcss_tpu.experiments import memory_xz as jxz
from qcss_tpu.experiments import soft as jsoft
from qcss_tpu.sim import frame as jfr
from qcss_tpu.sim.noise import NoiseModel as JNoise
from qcss_tpu_torch.codes import families as tfam
from qcss_tpu_torch.decode import device_uf as tduf
from qcss_tpu_torch.decode import uf as tuf
from qcss_tpu_torch.experiments import erasure as ter
from qcss_tpu_torch.experiments import leakage as tlk
from qcss_tpu_torch.experiments import memory_xz as txz
from qcss_tpu_torch.experiments import soft as tsoft
from qcss_tpu_torch.sim.noise import NoiseModel as TNoise

Z999 = 3.2905
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # several worker processes run at once; see test_torch_device_uf.py
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _quick_reference_compiles():
    # the reference programs compared here: see test_torch_device_uf.py
    saved = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", saved)


def _wilson(k, n, z=Z999):
    p = k / n
    den = 1 + z * z / n
    mid = (p + z * z / (2 * n)) / den
    half = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / den
    return mid - half, mid + half


def _in_interval(k, n, p):
    """A count k of n Bernoulli(p) trials inside p's 99.9% band: p lies in
    the Wilson interval of k / n."""
    lo, hi = _wilson(k, n)
    return lo <= p <= hi


def _recorder(monkeypatch, module, name):
    """Wrap the reference's ``module.name`` so that every call's result
    is kept (as numpy) in the returned list, in call order."""
    calls = []
    orig = getattr(module, name)

    def wrapped(*args, **kw):
        out = orig(*args, **kw)
        calls.append(tuple(np.asarray(a) for a in out))
        return out

    monkeypatch.setattr(module, name, wrapped)
    return calls


def _replayer(monkeypatch, module, name, calls, cycle=1):
    """Replace the port's ``module.name`` by one that returns the recorded
    calls in order (``cycle`` times over) as CPU tensors."""
    it = iter(calls * cycle)
    monkeypatch.setattr(module, name, lambda *a, **kw: tuple(
        torch.tensor(x) for x in next(it)))


def _u8(a):
    return jax.numpy.asarray(np.asarray(a, np.uint8))


# -- soft readout ----------------------------------------------------------


def test_readout_model_equal():
    """Stands in for test_soft.py::TestReadoutModel: `flip_prob`,
    `sigma_for_flip_prob` and `posterior_flip_prob` equal the reference's
    to rtol 1e-6 on a grid, and `_llr_weights` is equal on random edge
    probabilities at resolutions 2 and 8."""
    for sigma in (0.3, 0.5, 0.62, 0.7, 1.0, 2.0):
        np.testing.assert_allclose(tsoft.flip_prob(sigma),
                                   jsoft.flip_prob(sigma), rtol=1e-6)
    for q in (0.3, 0.1, 0.02, 1e-3):
        np.testing.assert_allclose(tsoft.sigma_for_flip_prob(q),
                                   jsoft.sigma_for_flip_prob(q), rtol=1e-6)
    amp = np.linspace(0.0, 3.0, 301)
    np.testing.assert_allclose(tsoft.posterior_flip_prob(amp, 0.7),
                               jsoft.posterior_flip_prob(amp, 0.7),
                               rtol=1e-6)
    p = np.random.default_rng(1).uniform(1e-6, 0.5, 4096)
    for res in (2, 8):
        np.testing.assert_array_equal(
            tsoft._llr_weights(p, np.log(0.08), resolution=res),
            jsoft._llr_weights(p, np.log(0.08), resolution=res))


def test_soft_phenomenological_equals_reference(monkeypatch):
    """Stands in for test_soft.py::TestSoftBeatsHard::test_uf_tier (d=5,
    2^15 shots there): d=3, R=3, p=3e-3, sigma=0.7, two chunks of 512;
    the soft and the hard arms on the reference's `_sample_soft_stream`
    shots give the reference's failure counts."""
    kw = dict(rounds=3, samples=1024, batch=512, seed=1)
    calls = _recorder(monkeypatch, jsoft, "_sample_soft_stream")
    ref = {s: jsoft.soft_phenomenological_error_rate(
        jfam.rotated_surface(3), 3e-3, 0.7, soft=s, **kw)
        for s in (True, False)}
    assert len(calls) == 4
    _replayer(monkeypatch, tsoft, "_sample_soft_stream", calls)
    port = {s: tsoft.soft_phenomenological_error_rate(
        tfam.rotated_surface(3), 3e-3, 0.7, soft=s, device="cpu", **kw)
        for s in (True, False)}
    assert ref[False]["logical_fail"] > 0
    assert port == ref


def _weighted_setup(batch=512):
    """test_soft.py::TestDeviceSoftWeights's setup at d=3, R=3: the
    reference's `_sample_soft_stream` shots, the spacetime graph with
    resolution-8 static weights, and per-shot soft weights."""
    import dataclasses

    code = jfam.rotated_surface(3)
    h, lz = code.raw_parity_check_c2, code.z_operator_matrix()
    sigma, p, rounds = 0.7, 5e-3, 3
    q_eff = jsoft.flip_prob(sigma)
    g = juf.spacetime_graph(h, lz, rounds, p_space=p, p_time=q_eff)
    n_space = juf.graph_from_checks(h, lz).num_edges * (rounds + 1)
    base_ln = np.log(max(p, q_eff))
    probs = np.concatenate([np.full(n_space, p),
                            np.full(g.num_edges - n_space, q_eff)])
    w_static = jsoft._llr_weights(probs, base_ln, resolution=8)
    g = dataclasses.replace(g, edge_weight=w_static)
    dets, par, amp = map(np.asarray, jsoft._sample_soft_stream(
        jax.random.key(2), jax.numpy.float32(p), jax.numpy.float32(sigma),
        batch, rounds, code.n, _u8(h), _u8(lz)))
    pf = jsoft.posterior_flip_prob(amp.reshape(batch, -1), sigma)
    sw = np.tile(w_static, (batch, 1))
    sw[:, n_space:] = jsoft._llr_weights(np.clip(pf, 1e-9, 0.499), base_ln,
                                         resolution=8)
    return g, dets, par, sw


def test_weighted_device_decode_equals_reference():
    """Stands in for test_soft.py::test_static_shot_weights_bit_identical
    and test_weighted_device_matches_host: the generic device decoder
    with per-shot weights (`decode_labels(shot_weights=)`, the packed
    decoder on the CPU, as soft_device_memory_rate runs it) gives the
    reference's labels and convergence on the same detectors and weights,
    and the host union-find with those weights gives the reference's."""
    g, dets, _, sw = _weighted_setup()
    ref_l, ref_c = jduf.decode_labels(
        jduf.build_device_graph(g, stencil=False), jax.numpy.asarray(dets),
        shot_weights=jax.numpy.asarray(sw, jax.numpy.int32))
    gt = tuf.MatchingGraph(num_nodes=g.num_nodes, edges=g.edges,
                           edge_qubit=g.edge_qubit, edge_obs=g.edge_obs,
                           n_qubits=g.n_qubits, edge_weight=g.edge_weight)
    dg = tduf.build_device_graph(gt, stencil=False)
    assert dg.pack_shift is not None
    labels, conv = tduf.decode_labels(dg, torch.tensor(dets),
                                      shot_weights=torch.tensor(
                                          sw.astype(np.int32)))
    np.testing.assert_array_equal(labels[0].numpy(), np.asarray(ref_l[0]))
    np.testing.assert_array_equal(conv.numpy(), np.asarray(ref_c))
    _, obs_h = tuf.UFDecoder(gt).decode_batch(dets, want_corrections=False,
                                              shot_weights=sw)
    _, obs_r = juf.UFDecoder(g).decode_batch(dets, want_corrections=False,
                                             shot_weights=sw)
    np.testing.assert_array_equal(obs_h, obs_r)


def test_soft_device_memory_rate_equals_reference(monkeypatch):
    """Stands in for test_soft.py::test_fused_device_rate: the fused
    pipeline (weights from the amplitudes, the generic device decode, the
    count) at d=3, R=3, B=512, 2 reps after the two warm-ups, every rep
    drawing the same batch of the reference's `_sample_soft_stream`
    shots, counts the failures the reference's fused pipeline counts on
    that batch."""
    code_j = jfam.rotated_surface(3)
    h, lz = code_j.raw_parity_check_c2, code_j.z_operator_matrix()
    shots = tuple(map(np.asarray, jsoft._sample_soft_stream(
        jax.random.key(11), jax.numpy.float32(5e-3),
        jax.numpy.float32(0.7), 512, 3, code_j.n, _u8(h), _u8(lz))))
    monkeypatch.setattr(jsoft, "_sample_soft_stream", lambda *a, **kw: tuple(
        jax.numpy.asarray(x) for x in shots))
    monkeypatch.setattr(tsoft, "_sample_soft_stream", lambda *a, **kw: tuple(
        torch.tensor(x) for x in shots))
    kw = dict(rounds=3, batch=512, reps=2, seed=1)
    ref = jsoft.soft_device_memory_rate(code_j, 5e-3, 0.7, **kw)
    port = tsoft.soft_device_memory_rate(tfam.rotated_surface(3), 5e-3, 0.7,
                                         device="cpu", **kw)
    assert ref["logical_fail"] > 0
    assert port["logical_fail"] == ref["logical_fail"]
    assert port["samples"] == ref["samples"] == 1024


CIRC = dict(rounds=2, batch=256, seed=6)
CIRC_NOISE = dict(p_gate2=6e-3, p_gate1=2e-3, p_reset=2e-3)
SIGMA = 0.55


@pytest.fixture(scope="module")
def steane_analog():
    """The reference two-sector sampler's analog-readout shots at
    Steane, CIRC, CIRC_NOISE with p_meas = flip_prob(SIGMA) (as its soft
    circuit experiments draw them), and stand-ins for both packages'
    `_sample_two_sector` that return them."""
    import dataclasses

    code = jfam.steane()
    noise = dataclasses.replace(JNoise(**CIRC_NOISE),
                                p_meas=jsoft.flip_prob(SIGMA))
    hz = np.asarray(code.raw_parity_check_c2, np.uint8) & 1
    hx = np.asarray(code.raw_parity_check_c1, np.uint8) & 1
    n, rz, rx = code.n, hz.shape[0], hx.shape[0]
    z_arrays = tuple(map(jax.numpy.asarray, jxz.z_extraction_circuit(
        code, checks=hz).to_arrays()))
    x_arrays = tuple(map(jax.numpy.asarray, jxz.x_extraction_circuit(
        code, anc_offset=n + rz, checks=hx).to_arrays()))
    fn = jax.jit(partial(jxz._sample_two_sector, code=code, noise=noise,
                         z_arrays=z_arrays, x_arrays=x_arrays,
                         z_comp=jfr.maybe_compile(z_arrays, n + rz + rx),
                         x_comp=jfr.maybe_compile(x_arrays, n + rz + rx),
                         rz=rz, rx=rx, sigma=SIGMA),
                 static_argnames=("batch", "rounds"))
    shots = tuple(np.asarray(a) for a in fn(
        jax.random.key(CIRC["seed"]), CIRC["batch"], CIRC["rounds"]))

    def replay(generator, batch, rounds, *args, sigma=None, **kw):
        assert (batch, rounds, sigma) == (CIRC["batch"], CIRC["rounds"],
                                          SIGMA)
        return tuple(torch.tensor(a) for a in shots)

    def ref_replay(key, batch, rounds, **kw):
        assert (batch, rounds) == (CIRC["batch"], CIRC["rounds"])
        return tuple(jax.numpy.asarray(a) for a in shots)

    return replay, ref_replay


@pytest.mark.parametrize("soft", [True, False])
def test_soft_circuit_memories_equal_reference(monkeypatch, steane_analog,
                                               soft):
    """Stands in for test_soft.py::test_dem_tier_soft_not_worse and
    test_bp_tier_soft_helps (d=3 and d=5, thousands of shots there):
    Steane, R=2, B=256, the reference's analog shots; every rate of
    `soft_xz_memory_experiment` and `soft_qldpc_circuit_memory` (both
    sectors, BP convergence included) equal to the reference's."""
    monkeypatch.setattr(txz, "_sample_two_sector", steane_analog[0])
    monkeypatch.setattr(jxz, "_sample_two_sector", steane_analog[1])
    kw = dict(CIRC, sigma=SIGMA, soft=soft)
    ref = jsoft.soft_xz_memory_experiment(
        jfam.steane(), noise=JNoise(**CIRC_NOISE), **kw)
    port = tsoft.soft_xz_memory_experiment(
        tfam.steane(), noise=TNoise(**CIRC_NOISE), device="cpu", **kw)
    assert ref["word_fail"] > 0
    assert port == ref
    ref = jsoft.soft_qldpc_circuit_memory(
        jfam.steane(), noise=JNoise(**CIRC_NOISE), iters=16, **kw)
    port = tsoft.soft_qldpc_circuit_memory(
        tfam.steane(), noise=TNoise(**CIRC_NOISE), iters=16, device="cpu",
        **kw)
    assert ref["word_fail"] > 0 and ref["bp_converged_z"] < 1
    assert port == ref


def test_soft_bp_phenomenological_equals_reference(monkeypatch):
    """Stands in for test_soft.py::test_bp_tier (d=5, 4k shots there): d=3,
    R=3, p=3e-3, sigma=0.7, B=256, 16 BP iterations with OSD; soft and
    hard on the reference's `_sample_soft_stream` shots give the
    reference's failures and convergence."""
    kw = dict(rounds=3, samples=256, seed=2, iters=16)
    calls = _recorder(monkeypatch, jsoft, "_sample_soft_stream")
    ref = {s: jsoft.soft_bp_phenomenological_error_rate(
        jfam.rotated_surface(3), 3e-3, 0.7, soft=s, **kw)
        for s in (True, False)}
    _replayer(monkeypatch, tsoft, "_sample_soft_stream", calls)
    port = {s: tsoft.soft_bp_phenomenological_error_rate(
        tfam.rotated_surface(3), 3e-3, 0.7, soft=s, device="cpu", **kw)
        for s in (True, False)}
    assert ref[True]["bp_converged"] < 1
    assert port == ref


def test_analog_samplers_flip_at_flip_prob():
    """Stands in for test_soft.py::test_analog_sampler_flip_rate: with only
    the analog readout (d=3, R=4, B=4096), the port's two-sector sampler
    and its phenomenological stream (p=0) flip each syndrome bit at
    `flip_prob(sigma)` — each count inside the rate's 99.9% interval —
    and no data error appears."""
    sigma = 0.7
    q_eff = tsoft.flip_prob(sigma)
    code = tfam.rotated_surface(3)
    hz = np.asarray(code.raw_parity_check_c2, np.uint8) & 1
    hx = np.asarray(code.raw_parity_check_c1, np.uint8) & 1
    gen = torch.Generator().manual_seed(5)
    syns_z, syns_x, x_err, z_err, amps_z, _ = txz._sample_two_sector(
        gen, 4096, 4, code, TNoise(), *txz.two_sector_circuits(
            code, hz, hx, CPU), rz=hz.shape[0], rx=hx.shape[0], sigma=sigma)
    assert not x_err.any() and not z_err.any()
    assert amps_z.shape == (4096, 4, hz.shape[0])
    for syns in (syns_z, syns_x):
        assert _in_interval(int(syns.sum()), syns.numel(), q_eff)
    h_t = torch.tensor(hz)
    lz_t = torch.tensor(np.asarray(code.z_operator_matrix(), np.uint8))
    dets, par, amp = tsoft._sample_soft_stream(
        torch.Generator().manual_seed(6), 0.0, sigma, 4096, 4, code.n, h_t,
        lz_t)
    assert not par.any() and amp.shape == (4096, 4, hz.shape[0])
    first = dets[:, :hz.shape[0]]  # round 0's detectors are its flips
    assert _in_interval(int(first.sum()), first.numel(), q_eff)


# -- heralded erasure ------------------------------------------------------


def test_erasure_below_d_exhaustive_equals_reference():
    """Stands in for test_erasure.py::TestExactness::test_weight_below_d_
    exhaustive_d3: every erasure set of weight <= 2 at d=3 with every flip
    pattern, decoded with the heralded weights (`_shot_weights`): the
    port's observables equal the reference's, and none fails."""
    code = tfam.rotated_surface(3)
    h2 = code.raw_parity_check_c2
    lz = code.z_operator_matrix()
    sets = [(qs, m) for w in (1, 2)
            for qs in combinations(range(code.n), w) for m in range(1 << w)]
    x_err = np.zeros((len(sets), code.n), np.uint8)
    er_mask = np.zeros_like(x_err)
    for b, (qs, m) in enumerate(sets):
        for i, q in enumerate(qs):
            er_mask[b, q] = 1
            x_err[b, q] = (m >> i) & 1
    syn = ((x_err @ h2.T) % 2).astype(np.uint8)
    par = juf._pack_parity(((x_err @ lz.T) % 2).astype(np.uint8))
    gt, gj = tuf.graph_from_checks(h2, lz), juf.graph_from_checks(h2, lz)
    assert ter._pauli_weight(0.0) == jer._pauli_weight(0.0) == 250
    sw_t = ter._shot_weights(er_mask[:, gt.edge_qubit] == 1, 250)
    sw_j = jer._shot_weights(er_mask[:, gj.edge_qubit] == 1, 250)
    np.testing.assert_array_equal(sw_t, sw_j)
    _, obs_t = tuf.UFDecoder(gt).decode_batch(syn, want_corrections=False,
                                              shot_weights=sw_t)
    _, obs_j = juf.UFDecoder(gj).decode_batch(syn, want_corrections=False,
                                              shot_weights=sw_j)
    np.testing.assert_array_equal(obs_t, obs_j)
    assert (obs_t == par).all()


def test_erasure_code_capacity_equals_reference(monkeypatch):
    """Stands in for test_erasure.py::test_herald_strictly_helps (d=5,
    2^12 shots there): d=3, one layer of 512 shots drawn with numpy
    (erasures at 0.1, depolarizing 0.02 on intact qubits, 1/2 components
    on erased ones) handed to both packages' `erasure_error_rate` in
    place of their `_sample_erasure_layer`; the heralded and the blind
    arms give the reference's counts."""
    n, batch = jfam.rotated_surface(3).n, 512
    rng = np.random.default_rng(3)
    erased = (rng.random((batch, n)) < 0.1).astype(np.uint8)
    u = rng.random((batch, n))
    x_err = np.where(erased == 1, rng.random((batch, n)) < 0.5,
                     u < 2 * 0.02 / 3).astype(np.uint8)
    z_err = np.where(erased == 1, rng.random((batch, n)) < 0.5,
                     (u >= 0.02 / 3) & (u < 0.02)).astype(np.uint8)
    layer = (erased, x_err, z_err)
    monkeypatch.setattr(jer, "_sample_erasure_layer", lambda *a, **kw: tuple(
        jax.numpy.asarray(x) for x in layer))
    monkeypatch.setattr(ter, "_sample_erasure_layer", lambda *a, **kw: tuple(
        torch.tensor(x) for x in layer))
    for heralded in (True, False):
        ref = jer.erasure_error_rate(jfam.rotated_surface(3), 0.02, 0.1,
                                     samples=batch, heralded=heralded)
        port = ter.erasure_error_rate(tfam.rotated_surface(3), 0.02, 0.1,
                                      samples=batch, heralded=heralded,
                                      device="cpu")
        assert ref["word_fail"] > 0
        assert port == ref


@pytest.mark.parametrize("decoder", ["host", "device"])
def test_erasure_phenomenological_equals_reference(monkeypatch, decoder):
    """Stands in for test_erasure.py::test_phenomenological_herald_gain
    (d=5, 2^11 shots there): d=3, R=3, p=0.005, p_erase=0.05, B=512, the
    reference's `_sample_phenom_erasure` shots; heralded and blind counts
    equal the reference's, with the host union-find and with the device
    decoders on both sides (on the CPU: the generic decoder with the
    herald weights, the stencil decoder blind; the device union-find may
    choose another valid matching than the host's, so each decoder is
    held to its own counterpart)."""
    kw = dict(samples=512, seed=4, decoder=decoder)
    calls = _recorder(monkeypatch, jer, "_sample_phenom_erasure")
    ref = {h: jer.erasure_phenomenological_error_rate(
        jfam.rotated_surface(3), 0.005, 0.05, heralded=h, **kw)
        for h in (True, False)}
    _replayer(monkeypatch, ter, "_sample_phenom_erasure", calls)
    port = {h: ter.erasure_phenomenological_error_rate(
        tfam.rotated_surface(3), 0.005, 0.05, heralded=h, device="cpu",
        **kw) for h in (True, False)}
    assert ref[False]["logical_fail"] > ref[True]["logical_fail"]
    assert port == ref


def test_erasure_samplers_herald_at_p_erase():
    """The port's erasure samplers draw heralds at `p_erase`: the
    phenomenological stream's rounds 0..R-1 (the final layer all zero)
    and the code-capacity layer, each count inside the rate's 99.9%
    interval, and erased qubits flip at 1/2 (d=3, B=4096)."""
    code = tfam.rotated_surface(3)
    h = torch.tensor(np.asarray(code.raw_parity_check_c2, np.uint8))
    lz = torch.tensor(np.asarray(code.z_operator_matrix(), np.uint8))
    _, _, erased = ter._sample_phenom_erasure(
        torch.Generator().manual_seed(7), 0.0, 0.0, 0.05, 4096, 3, code.n,
        h, lz)
    assert not erased[:, 3].any()
    assert _in_interval(int(erased[:, :3].sum()), erased[:, :3].numel(),
                        0.05)
    erased, x_err, z_err = ter._sample_erasure_layer(
        torch.Generator().manual_seed(8), 4096, code.n, 0.0, 0.05)
    assert _in_interval(int(erased.sum()), erased.numel(), 0.05)
    assert not (x_err | z_err)[erased == 0].any()
    assert _in_interval(int(x_err.sum()), int(erased.sum()), 0.5)


# -- leakage ---------------------------------------------------------------


def test_expected_leak_profile_equal():
    for args in ((5e-3, 0.2, 10), (0.05, 0.5, 7), (0.1, 1.0, 3)):
        np.testing.assert_array_equal(tlk.expected_leak_profile(*args),
                                      jlk.expected_leak_profile(*args))


def test_leakage_memory_equals_reference(monkeypatch):
    """Stands in for test_leakage.py::test_heralded_beats_blind,
    test_calibrated_blind_between and test_device_decoder_matches_host:
    d=3, R=6, p=2e-3, p_leak=0.03, B=512, the reference's
    `_sample_leakage_stream` shots; the heralded, calibrated-blind and
    blind counts and the leak fraction equal the reference's, with the
    host union-find and (heralded and blind) with the device decoders."""
    kw = dict(rounds=6, samples=512, seed=5)
    arms = ({"heralded": True}, {"heralded": False, "calibrated": True},
            {"heralded": False})
    calls = _recorder(monkeypatch, jlk, "_sample_leakage_stream")
    ref = [jlk.leakage_memory_experiment(jfam.rotated_surface(3), 2e-3,
                                         0.03, **kw, **a) for a in arms]
    _replayer(monkeypatch, tlk, "_sample_leakage_stream", calls, cycle=2)
    port = [tlk.leakage_memory_experiment(tfam.rotated_surface(3), 2e-3,
                                          0.03, device="cpu", **kw, **a)
            for a in arms]
    assert ref[2]["logical_fail"] > ref[0]["logical_fail"]
    assert port == ref
    # the device decoders, each held to its counterpart (the device
    # union-find may choose another valid matching than the host's)
    kw["decoder"] = "device"
    ref = [jlk.leakage_memory_experiment(jfam.rotated_surface(3), 2e-3,
                                         0.03, **kw, **a) for a in arms[::2]]
    dev = [tlk.leakage_memory_experiment(tfam.rotated_surface(3), 2e-3,
                                         0.03, device="cpu", **kw, **a)
           for a in arms[::2]]
    assert dev == ref


def test_no_leak_heralded_equals_blind(monkeypatch):
    """Stands in for test_leakage.py::test_no_leak_heralded_equals_blind:
    with p_leak=0 the heralds are empty, and the heralded and blind arms
    on the reference's shots both give the reference's blind count."""
    kw = dict(rounds=6, samples=512, seed=6)
    calls = _recorder(monkeypatch, jlk, "_sample_leakage_stream")
    ref = jlk.leakage_memory_experiment(jfam.rotated_surface(3), 0.01, 0.0,
                                        heralded=False, **kw)
    _replayer(monkeypatch, tlk, "_sample_leakage_stream", calls, cycle=2)
    port = [tlk.leakage_memory_experiment(tfam.rotated_surface(3), 0.01,
                                          0.0, heralded=h, device="cpu",
                                          **kw) for h in (True, False)]
    assert ref["logical_fail"] > 0 and ref["leak_fraction"] == 0
    assert port[0]["logical_fail"] == port[1]["logical_fail"]
    assert port[1] == ref


def test_leakage_sampler_leak_fraction_matches_reference():
    """Stands in for test_leakage.py::test_seep_one_herald_rate and
    test_leak_fraction_monotone_in_dwell: the port's state machine
    leaks as the reference's does. Per round, the leaked (shot, qubit)
    count is binomial over B*n, so each round's counts of the two are
    held by a two-sample 99.9% test (d=3, R=6, p_leak=0.05, p_seep=0.3,
    B=512: the reference's sampler as compiled for the memory tests)."""
    args = (0.0, 0.0, 0.05, 0.3)
    code = tfam.rotated_surface(3)
    h = np.asarray(code.raw_parity_check_c2, np.uint8)
    lz = np.asarray(code.z_operator_matrix(), np.uint8)
    _, _, ref = jlk._sample_leakage_stream(
        jax.random.key(9), *map(jax.numpy.float32, args), 512, 6, code.n,
        _u8(h), _u8(lz))
    _, _, port = tlk._sample_leakage_stream(
        torch.Generator().manual_seed(9), *args, 512, 6, code.n,
        torch.tensor(h), torch.tensor(lz))
    ref = np.asarray(ref)
    assert port.shape == ref.shape == (512, 7, code.n)
    for t in range(7):
        n = ref[:, t].size
        k_ref, k_port = int(ref[:, t].sum()), int(port[:, t].sum())
        pooled = (k_ref + k_port) / (2 * n)
        spread = Z999 * math.sqrt(2 * pooled * (1 - pooled) / n)
        assert abs(k_ref - k_port) / n <= spread, (t, k_ref, k_port)


LEAK = dict(rounds=3, batch=256, seed=8)
LEAK_NOISE = dict(p_gate2=3e-3, p_meas=4e-3, p_reset=2e-3)
LEAK_ARGS = dict(p_leak=0.02, p_seep=0.2, p_leak_anc=0.02)


def test_leakage_circuit_memory_equals_reference(monkeypatch):
    """Stands in for test_leakage.py::test_heralded_helps_and_sampler_
    locksteps (d=3, 4k shots there): Steane, R=3, B=256, the reference's
    `_sample_two_sector_leak` shots; heralded and blind rates and the
    leak fraction equal the reference's."""
    code = jfam.steane()
    hz = np.asarray(code.raw_parity_check_c2, np.uint8) & 1
    hx = np.asarray(code.raw_parity_check_c1, np.uint8) & 1
    n, rz, rx = code.n, hz.shape[0], hx.shape[0]
    z_arrays = tuple(map(jax.numpy.asarray, jxz.z_extraction_circuit(
        code, checks=hz).to_arrays()))
    x_arrays = tuple(map(jax.numpy.asarray, jxz.x_extraction_circuit(
        code, anc_offset=n + rz, checks=hx).to_arrays()))
    fn = jax.jit(partial(jlk._sample_two_sector_leak, code=code,
                         noise=JNoise(**LEAK_NOISE), z_arrays=z_arrays,
                         x_arrays=x_arrays,
                         z_comp=jfr.maybe_compile(z_arrays, n + rz + rx),
                         x_comp=jfr.maybe_compile(x_arrays, n + rz + rx),
                         rz=rz, rx=rx, **LEAK_ARGS),
                 static_argnames=("batch", "rounds"))
    shots = tuple(np.asarray(a) for a in fn(
        jax.random.key(LEAK["seed"]), LEAK["batch"], LEAK["rounds"]))
    monkeypatch.setattr(jlk, "_sample_two_sector_leak",
                        lambda key, batch, rounds, **kw: tuple(
                            jax.numpy.asarray(a) for a in shots))
    monkeypatch.setattr(tlk, "_sample_two_sector_leak",
                        lambda *a, **kw: tuple(torch.tensor(x)
                                               for x in shots))
    for heralded in (True, False):
        ref = jlk.leakage_circuit_memory(code, noise=JNoise(**LEAK_NOISE),
                                         heralded=heralded, **LEAK,
                                         **LEAK_ARGS)
        port = tlk.leakage_circuit_memory(
            tfam.steane(), noise=TNoise(**LEAK_NOISE), heralded=heralded,
            device="cpu", **LEAK, **LEAK_ARGS)
        assert ref["word_fail"] > 0 and ref["leak_fraction"] > 0
        assert port == ref


def test_two_sector_leak_sampler_rates():
    """The port's circuit-level leakage sampler against the reference's by
    rates (Steane, R=3, B=4096): the data heralds per round and the
    ancilla heralds, each count inside the 99.9% interval of the
    reference's, and with every rate zero but leakage, leaked qubits
    alone carry errors."""
    code = tfam.steane()
    hz = np.asarray(code.raw_parity_check_c2, np.uint8) & 1
    hx = np.asarray(code.raw_parity_check_c1, np.uint8) & 1
    n, rz, rx = code.n, hz.shape[0], hx.shape[0]
    out = tlk._sample_two_sector_leak(
        torch.Generator().manual_seed(3), 4096, 3, code, TNoise(),
        *txz.two_sector_circuits(code, hz, hx, CPU), rz=rz, rx=rx,
        **LEAK_ARGS)
    hd, ha_z = out[4].numpy(), out[5].numpy()
    assert out[4].shape == (4096, 3, n) and out[5].shape == (4096, 3, rz)
    prof = tlk.expected_leak_profile(0.02, 0.2, 3)
    for t in range(3):
        # first-round heralds are Bernoulli(p_leak); later rounds follow
        # the profile of the state machine, binomial over B*n each
        assert _in_interval(int(hd[:, t].sum()), hd[:, t].size, prof[t]), t
    assert _in_interval(int(ha_z.sum()), ha_z.size, 0.02)
    ever = hd.any(axis=1)
    assert not (out[2].numpy() & ~ever).any()
    assert not (out[3].numpy() & ~ever).any()
