"""The port's fused memory experiment against the JAX package's.

* Sampled failure rates: the two packages draw from different generators,
  so the port's rate (at 16x the JAX batch, so its own spread adds
  little) must fall inside the 99.9% Wilson interval (z = 3.2905) of the
  JAX run's rate at the same settings.
* Identical detectors (sampled once by the JAX package) must give
  identical failure counts through both packages' device decoders: exact.
* The LUT decoders ('vote', 'difference', 'stlut'), given the syndromes
  and readout the JAX sampler drew, must give identical logical-failure
  and residual-syndrome counts: exact.
* The tableau engine must give counts bit-identical to the frames
  engine's at the same seed, in both bases, as the reference's engines
  do (tests/test_memory_experiment.py); noiseless runs are silent.
* The host decoders ('uf', 'dem', 'mwpm', 'dem-mwpm'), given the
  syndromes and readout the JAX sampler drew, must give the reference's
  logical-failure and residual-syndrome counts exactly; the port's whole
  runs must fall inside the 99.9% Wilson interval of those counts, and
  'dem' must stay within the reference's bound of 'device-dem' at one
  seed (tests/test_device_uf.py).
* `DeviceUFDecoder` against the host `UFDecoder` by agreement, as the
  reference holds its own (tests/test_device_uf.py); the shots it sends
  to the host must decode exactly as the host decoder does.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcss_tpu.codes.families import rotated_surface, steane
from qcss_tpu.decode import device_uf as jdu
from qcss_tpu.decode import mwpm as jmw
from qcss_tpu.decode import uf as juf
from qcss_tpu.decode.dem import circuit_level_graph, extraction_gate_list
from qcss_tpu.decode.spacetime import detector_history, spacetime_correction_lut
from qcss_tpu.experiments import memory as jmem
from qcss_tpu.ops import gf2_jax
from qcss_tpu.sim.noise import NoiseModel as JNoise
from qcss_tpu_torch.decode import device_uf as tdu
from qcss_tpu_torch.codes import families as tfam
from qcss_tpu_torch.decode import uf as tuf
from qcss_tpu_torch.experiments import memory as tmem
from qcss_tpu_torch.sim.noise import NoiseModel as TNoise

Z999 = 3.2905
NOISE = dict(p_gate2=1e-2, p_meas=1e-2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The suite runs in several worker processes at once; torch's intra-op
    # threads would oversubscribe the cores and spin, and these tensors are
    # small enough that one thread is fastest anyway.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wilson(k, n, z=Z999):
    p = k / n
    den = 1 + z * z / n
    mid = (p + z * z / (2 * n)) / den
    half = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / den
    return mid - half, mid + half


@pytest.mark.parametrize("decoder,basis", [("device-dem", "z"),
                                           ("device-dem", "x"),
                                           ("device-uf", "z")])
def test_failure_rate_within_wilson_of_jax(decoder, basis):
    Bj, Bt = 4096, 4096 * 16
    kw = dict(rounds=3, basis=basis, decoder=decoder, engine="frames")
    rj = jmem.memory_experiment(rotated_surface(3), noise=JNoise(**NOISE),
                                batch=Bj, seed=1, **kw)
    rt = tmem.memory_experiment(rotated_surface(3), noise=TNoise(**NOISE),
                                batch=Bt, seed=1, device="cpu", **kw)
    assert rt["samples"] == Bt and rt["decoder"] == decoder
    lo, hi = _wilson(round(rj["logical_fail"] * Bj), Bj)
    assert 0 < rt["logical_fail"] and lo <= rt["logical_fail"] <= hi, (
        rj["logical_fail"], rt["logical_fail"], lo, hi)


def test_identical_detectors_identical_failures():
    d = R = 3
    code = rotated_surface(d)
    raw = code.raw_parity_check_c2
    lz = code.z_operator_matrix()
    arrays = jmem.z_extraction_circuit(code, checks=raw).to_arrays()
    syns, word = jmem._memory_circuit_frames(
        jax.random.key(5), 8192, R, code, JNoise(**NOISE),
        tuple(map(jnp.asarray, arrays)), n_anc=raw.shape[0])
    syns, word = np.asarray(syns), np.asarray(word)
    dets = detector_history(syns, (word.astype(np.int64) @ raw.T) & 1)
    outcome = (word.astype(np.int64) @ lz[0].astype(np.int64)) & 1
    g = circuit_level_graph(raw, extraction_gate_list(code, raw), R,
                            logicals=lz, **NOISE)
    obs_j, conv_j = jdu.make_obs_decoder(g)(dets)
    tg = tuf.MatchingGraph(
        num_nodes=g.num_nodes, edges=g.edges, edge_qubit=g.edge_qubit,
        edge_obs=g.edge_obs, n_qubits=g.n_qubits, edge_weight=g.edge_weight)
    obs_t, conv_t = tdu.make_obs_decoder(tg, device="cpu")(
        torch.as_tensor(dets))
    fails_j = int(np.sum(outcome ^ (np.asarray(obs_j) & 1)))
    fails_t = int(np.sum(outcome ^ (obs_t.numpy() & 1)))
    assert fails_j > 0
    assert fails_t == fails_j
    assert bool(np.all(conv_j)) and bool(conv_t.all())


def test_unported_engines_and_decoders_raise():
    code = rotated_surface(3)
    noise = TNoise(**NOISE)
    with pytest.raises(ValueError, match="engine"):
        tmem.memory_experiment(code, rounds=3, noise=noise,
                               decoder="device-dem", engine="statevector",
                               device="cpu")
    with pytest.raises(ValueError):
        tmem.memory_experiment(code, rounds=3, noise=noise,
                               decoder="nope", engine="frames", device="cpu")
    # Steane is not matchable: the matching decoders raise the reference's
    # errors (a qubit in three checks; a fault flipping three detectors)
    raw = steane().raw_parity_check_c2
    with pytest.raises(ValueError) as e_uf:
        juf.graph_from_checks(raw, steane().z_operator_matrix())
    with pytest.raises(ValueError) as e_dem:
        circuit_level_graph(raw, extraction_gate_list(steane(), raw), 3,
                            logicals=steane().z_operator_matrix(), **NOISE)
    for decoder, want in (("uf", e_uf), ("mwpm", e_uf), ("dem", e_dem),
                          ("dem-mwpm", e_dem)):
        with pytest.raises(ValueError) as got:
            tmem.memory_experiment(tfam.steane(), rounds=3, noise=noise,
                                   decoder=decoder, engine="frames",
                                   batch=64, device="cpu")
        assert str(got.value) == str(want.value)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmem.memory_experiment(rotated_surface(3), rounds=3,
                               noise=TNoise(**NOISE), decoder="device-dem",
                               engine="frames")


LUT_NOISE = dict(p_gate2=2e-2, p_meas=2e-2)
LUT_ROUNDS, LUT_BATCH = 3, 4096


@pytest.fixture(scope="module")
def jax_lut_samples():
    """A Steane Z-memory draw of the JAX sampler over the standard-form
    checks (the LUTs key on them): (code, (syns, word)). The decodes are
    functions of these arrays alone, and Steane's X and Z checks have the
    same shape, so the X-basis decodes run on the same draw."""
    code = steane()
    draw = jmem._memory_circuit_frames(
        jax.random.key(11), LUT_BATCH, LUT_ROUNDS, code, JNoise(**LUT_NOISE),
        tuple(map(jnp.asarray, jmem.z_extraction_circuit(code).to_arrays())),
        n_anc=code.parity_check_c2.shape[0])
    return code, draw


def _jax_lut_counts(code, syns, word, decoder, basis, stlut):
    """The decode half of the reference's `_memory_body`."""
    dev = code.device
    h_std = dev.h2 if basis == "z" else dev.h1
    if decoder == "stlut":
        dets = detector_history(syns, gf2_jax.syndromes_dense(word, h_std))
        corr = jnp.take(jnp.asarray(stlut), gf2_jax.bits_to_index(dets),
                        axis=0)
    else:
        lut = dev.lut_c2 if basis == "z" else dev.lut_c1
        decode = {"vote": jmem._decode_vote,
                  "difference": jmem._decode_difference}[decoder]
        corr = decode(syns, word, lut, h_std)
    return jmem._count_failures(word, corr, code, basis)


def _stlut(code, basis):
    std = code.parity_check_c2 if basis == "z" else code.parity_check_c1
    return spacetime_correction_lut(std, LUT_ROUNDS, 4)


@pytest.mark.parametrize("decoder,basis", [("vote", "z"),
                                           ("difference", "x"),
                                           ("stlut", "z")])
def test_lut_decoders_identical_given_jax_samples(jax_lut_samples, decoder,
                                                  basis):
    code, (syns, word) = jax_lut_samples
    stlut = _stlut(code, basis) if decoder == "stlut" else None
    want = _jax_lut_counts(code, syns, word, decoder, basis, stlut)
    got = tmem._decode_counts(
        torch.from_numpy(np.array(syns)), torch.from_numpy(np.array(word)),
        tfam.steane().device, decoder,
        None if stlut is None else torch.from_numpy(stlut), basis)
    assert int(want["logical_fail"]) > 0
    for k in ("logical_fail", "residual_syndrome"):
        assert int(got[k]) == int(want[k]), k


def test_lut_decoder_rate_within_wilson_of_jax(jax_lut_samples):
    # the reference's rate on its own draws, against the port's whole
    # memory_experiment (its sampler, extraction circuit and decode)
    code, (syns, word) = jax_lut_samples
    kj = int(_jax_lut_counts(code, syns, word, "stlut", "z",
                             _stlut(code, "z"))["logical_fail"])
    Bt = LUT_BATCH * 2
    rt = tmem.memory_experiment(tfam.steane(), noise=TNoise(**LUT_NOISE),
                                rounds=LUT_ROUNDS, decoder="stlut",
                                engine="frames", batch=Bt, seed=2,
                                device="cpu")
    assert rt["samples"] == Bt and 0.0 <= rt["residual_syndrome"] <= 1.0
    lo, hi = _wilson(kj, LUT_BATCH)
    assert 0 < rt["logical_fail"] and lo <= rt["logical_fail"] <= hi, (
        kj / LUT_BATCH, rt["logical_fail"], lo, hi)


@pytest.mark.parametrize("code_name,decoder,basis", [
    ("steane", "vote", "z"), ("steane", "vote", "x"),
    ("steane", "difference", "z"), ("steane", "stlut", "x"),
    ("surface3", "device-dem", "z"), ("surface3", "device-uf", "x"),
    ("surface3", "uf", "z"), ("surface3", "dem", "x"),
    ("surface3", "mwpm", "x"), ("surface3", "dem-mwpm", "z")])
def test_tableau_engine_bit_identical_to_frames(code_name, decoder, basis):
    # the reference test's setting (Steane, R=3, B=1024, seed 7); the
    # surface code adds reset noise, which both engines draw alike
    if code_name == "steane":
        code, noise = tfam.steane(), TNoise(p_gate2=2e-3, p_meas=1e-2)
    else:
        code = tfam.rotated_surface(3)
        noise = TNoise(p_gate2=1e-2, p_meas=1e-2, p_reset=1e-2)
    kw = dict(rounds=3, noise=noise, basis=basis, batch=1024, seed=7,
              decoder=decoder, device="cpu")
    a = tmem.memory_experiment(code, engine="tableau", **kw)
    b = tmem.memory_experiment(code, engine="frames", **kw)
    assert a["logical_fail"] > 0
    assert a["logical_fail"] == b["logical_fail"]
    np.testing.assert_equal(a["residual_syndrome"], b["residual_syndrome"])


@pytest.mark.parametrize("basis", ["z", "x"])
def test_tableau_engine_noiseless_is_silent(basis):
    out = tmem.memory_experiment(tfam.steane(), rounds=3, noise=TNoise(),
                                 basis=basis, batch=64, decoder="vote",
                                 engine="tableau", device="cpu")
    assert out["logical_fail"] == 0.0 and out["residual_syndrome"] == 0.0



HOST_DECODERS = ("uf", "dem", "mwpm", "dem-mwpm")
HOST_BATCH = 4096


@pytest.fixture(scope="module")
def jax_surface_draw():
    """A surface d=3, R=3 Z-memory draw of the JAX sampler over the raw
    checks, with the reference's host decodes of it: (syns, word, {decoder:
    (failures, residual shots)})."""
    code = rotated_surface(3)
    raw = code.raw_parity_check_c2
    syns, word = jmem._memory_circuit_frames(
        jax.random.key(21), HOST_BATCH, 3, code, JNoise(**NOISE),
        tuple(map(jnp.asarray, jmem.z_extraction_circuit(
            code, checks=raw).to_arrays())), n_anc=raw.shape[0])
    syns, word = np.asarray(syns), np.asarray(word)
    dets = detector_history(syns, ((word.astype(np.int64) @ raw.T) & 1
                                   ).astype(np.uint8))
    lz = code.z_operator_matrix()
    graphs = {"uf": juf.spacetime_graph(raw, lz, 3),
              "dem": circuit_level_graph(
                  raw, extraction_gate_list(code, raw), 3, logicals=lz,
                  **NOISE)}
    want = {}
    for decoder in HOST_DECODERS:
        g = graphs[decoder.split("-")[0] if decoder != "mwpm" else "uf"]
        if decoder.endswith("mwpm"):
            corr, _ = jmw.MWPMDecoder(g).decode_batch(dets)
        else:
            corr, _ = juf.UFDecoder(g).decode_batch(dets)
        c = jmem._count_failures(word, corr, code, "z")
        want[decoder] = (c["logical_fail"], c["residual_syndrome"])
    return syns, word, want


@pytest.mark.parametrize("decoder", HOST_DECODERS)
def test_host_decoders_identical_given_jax_samples(jax_surface_draw,
                                                   decoder):
    syns, word, want = jax_surface_draw
    got = tmem._memory_host(
        tfam.rotated_surface(3), 3, TNoise(**NOISE), "z", decoder, None,
        tmem.z_extraction_circuit, None, torch.device("cpu"),
        lambda *a, **k: (torch.from_numpy(np.array(syns)),
                         torch.from_numpy(np.array(word))))
    assert want[decoder][0] > 0
    assert got == want[decoder]


@pytest.mark.parametrize("decoder", HOST_DECODERS)
def test_host_decoder_rate_within_wilson_of_jax(jax_surface_draw, decoder):
    k = jax_surface_draw[2][decoder][0]
    Bt = HOST_BATCH * 4
    rt = tmem.memory_experiment(tfam.rotated_surface(3), rounds=3,
                                noise=TNoise(**NOISE), decoder=decoder,
                                engine="frames", batch=Bt, seed=3,
                                device="cpu")
    assert rt["samples"] == Bt and rt["decoder"] == decoder
    assert 0.0 <= rt["residual_syndrome"] <= 1.0
    lo, hi = _wilson(k, HOST_BATCH)
    assert 0 < rt["logical_fail"] and lo <= rt["logical_fail"] <= hi, (
        k / HOST_BATCH, rt["logical_fail"], lo, hi)


def test_dem_within_reference_bound_of_device_dem():
    # the reference's test_fused_memory_experiment_matches_host_dem:
    # identical samples, near-identical decoders
    kw = dict(rounds=3, noise=TNoise(p_gate2=2e-3, p_meas=1e-2),
              batch=8192, seed=5, engine="frames", device="cpu")
    host = tmem.memory_experiment(tfam.rotated_surface(3), decoder="dem",
                                  **kw)
    dev = tmem.memory_experiment(tfam.rotated_surface(3),
                                 decoder="device-dem", **kw)
    assert host["logical_fail"] > 0
    assert abs(host["logical_fail"] - dev["logical_fail"]) * 8192 < 8, (
        host["logical_fail"], dev["logical_fail"])
    assert np.isnan(dev["residual_syndrome"])
    assert not np.isnan(host["residual_syndrome"])


def _cc_shots(d, p, batch, seed):
    code = tfam.rotated_surface(d)
    h = np.asarray(code.raw_parity_check_c2, np.uint8)
    lz = np.asarray(code.z_operator_matrix(), np.uint8)
    rng = np.random.default_rng(seed)
    errs = (rng.random((batch, h.shape[1])) < p).astype(np.uint8)
    return (tuf.graph_from_checks(h, lz), ((errs @ h.T) & 1).astype(np.uint8),
            ((errs @ lz.T) & 1)[:, 0])


@pytest.mark.parametrize("d", [3, 5])
def test_device_uf_exact_on_low_weight_errors(d):
    code = tfam.rotated_surface(d)
    h = np.asarray(code.raw_parity_check_c2, np.uint8)
    lz = np.asarray(code.z_operator_matrix(), np.uint8)
    from itertools import combinations

    errs = [np.zeros(code.n, np.uint8)]
    for w in range(1, (d - 1) // 2 + 1):
        for qs in combinations(range(code.n), w):
            e = np.zeros(code.n, np.uint8)
            e[list(qs)] = 1
            errs.append(e)
    errs = np.stack(errs)
    g = tuf.graph_from_checks(h, lz)
    dec = tdu.DeviceUFDecoder(g, device="cpu")
    _, obs = dec.decode_batch((errs @ h.T) & 1)
    assert obs.dtype == np.uint32 and dec.fallback_shots == 0
    np.testing.assert_array_equal(obs & 1, ((errs @ lz.T) & 1)[:, 0])


def test_device_uf_agrees_with_host():
    # the reference's bounds: > 0.97 at code capacity (d=7, p=0.05),
    # > 0.95 on the spacetime graph, > 0.93 on the DEM graph
    g, syn, par = _cc_shots(7, 0.05, 4096, 7)
    _, host = tuf.UFDecoder(g).decode_batch(syn, want_corrections=False)
    _, dev = tdu.DeviceUFDecoder(g, device="cpu").decode_batch(syn)
    assert np.mean((host & 1) == (dev & 1)) > 0.97
    assert abs(np.mean((host & 1) != par) - np.mean((dev & 1) != par)) < 0.01
    code = tfam.rotated_surface(3)
    raw = code.raw_parity_check_c2
    rng = np.random.default_rng(11)
    for g, rate, bound in (
            (tuf.spacetime_graph(raw, code.z_operator_matrix(), 3), 0.04,
             0.95),
            (circuit_level_graph(raw, extraction_gate_list(code, raw), 3,
                                 p_gate2=2e-3, p_meas=1e-2,
                                 logicals=code.z_operator_matrix()),
             0.03, 0.93)):
        dets = (rng.random((1024, g.num_nodes)) < rate).astype(np.uint8)
        _, host = tuf.UFDecoder(g).decode_batch(dets, want_corrections=False)
        dec = tdu.DeviceUFDecoder(g, device="cpu")
        _, dev = dec.decode_batch(torch.as_tensor(dets))
        assert np.mean((host & 1) == (dev & 1)) > bound
        assert dec.fallback_shots == 0


def test_device_uf_fallback_shots_decode_on_the_host():
    g, syn, _ = _cc_shots(5, 0.1, 512, 3)
    dec = tdu.DeviceUFDecoder(g, prop_cap=1, device="cpu")
    _, obs = dec.decode_batch(syn)
    dg = tdu.build_device_graph(g, prop_cap=1)
    _, conv = tdu.decode_obs(dg, torch.as_tensor(syn))
    bad = np.nonzero(~conv.numpy())[0]
    assert 0 < bad.size == dec.fallback_shots < len(syn)
    _, host = tuf.UFDecoder(g).decode_batch(syn[bad], want_corrections=False)
    np.testing.assert_array_equal(obs[bad], host)
    # per-shot weights: the device decode and the host fallback both use
    # them
    w = np.random.default_rng(4).integers(1, 6, (len(syn), g.num_edges))
    _, conv_w = tdu.decode_obs(dg, torch.as_tensor(syn),
                               torch.as_tensor(w.astype(np.int32)))
    bad_w = np.nonzero(~conv_w.numpy())[0]
    _, obs_w = dec.decode_batch(syn, shot_weights=w)
    assert dec.fallback_shots == bad.size + bad_w.size and bad_w.size
    _, host_w = tuf.UFDecoder(g).decode_batch(
        syn[bad_w], want_corrections=False,
        shot_weights=w[bad_w].astype(np.uint8))
    np.testing.assert_array_equal(obs_w[bad_w], host_w)
    with pytest.raises(ValueError, match="observable flips only"):
        dec.decode_batch(syn, want_corrections=True)
    strict = tdu.DeviceUFDecoder(g, prop_cap=1, host_fallback=False,
                                 device="cpu")
    with pytest.raises(RuntimeError, match="host_fallback"):
        strict.decode_batch(syn)
