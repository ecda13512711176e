"""The port's fused memory experiment against the JAX package's.

* Sampled failure rates: the two packages draw from different generators,
  so the port's rate (at 16x the JAX batch, so its own spread adds
  little) must fall inside the 99.9% Wilson interval (z = 3.2905) of the
  JAX run's rate at the same settings.
* Identical detectors (sampled once by the JAX package) must give
  identical failure counts through both packages' device decoders: exact.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcss_tpu.codes.families import rotated_surface
from qcss_tpu.decode import device_uf as jdu
from qcss_tpu.decode.dem import circuit_level_graph, extraction_gate_list
from qcss_tpu.decode.spacetime import detector_history
from qcss_tpu.experiments import memory as jmem
from qcss_tpu.sim.noise import NoiseModel as JNoise
from qcss_tpu_torch.decode import device_uf as tdu
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
                                batch=Bt, seed=1, **kw)
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
    obs_t, conv_t = tdu.make_obs_decoder(tg)(torch.as_tensor(dets))
    fails_j = int(np.sum(outcome ^ (np.asarray(obs_j) & 1)))
    fails_t = int(np.sum(outcome ^ (obs_t.numpy() & 1)))
    assert fails_j > 0
    assert fails_t == fails_j
    assert bool(np.all(conv_j)) and bool(conv_t.all())


def test_unported_engines_and_decoders_raise():
    code = rotated_surface(3)
    noise = TNoise(**NOISE)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmem.memory_experiment(code, rounds=3, noise=noise,
                               decoder="device-dem", engine="tableau")
    for decoder in ("vote", "stlut", "uf", "dem-mwpm"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tmem.memory_experiment(code, rounds=3, noise=noise,
                                   decoder=decoder, engine="frames")
    with pytest.raises(ValueError):
        tmem.memory_experiment(code, rounds=3, noise=noise,
                               decoder="nope", engine="frames")
