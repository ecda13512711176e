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
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcss_tpu.codes.families import rotated_surface, steane
from qcss_tpu.decode import device_uf as jdu
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
    for decoder in ("uf", "dem-mwpm"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tmem.memory_experiment(code, rounds=3, noise=noise,
                                   decoder=decoder, engine="frames",
                                   device="cpu")
    with pytest.raises(ValueError):
        tmem.memory_experiment(code, rounds=3, noise=noise,
                               decoder="nope", engine="frames", device="cpu")


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
    ("surface3", "device-dem", "z"), ("surface3", "device-uf", "x")])
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

