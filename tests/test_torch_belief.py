"""The port's correlated two-pass decoding and belief-matching
(`qcss_tpu_torch.decode.correlated`, `.belief`, and the belief branch of
`experiments.memory_xz`) against the JAX package's, on the CPU.

The decodes are held on the reference sampler's own shots: the port's
samplers (`uf._sample_and_extract` as `correlated` imports it, and
`memory_xz._sample_two_sector`) are replaced, in the test only, by ones
that return the reference's draws, and every failure count must equal
the reference's. The belief weights come from BP posteriors, which the
port sums in another float32 order (tests/test_torch_bp.py holds the soft
totals to rtol 1e-4), so a uint8 weight could land on the other side of a
rint tie; on these shots none does, and the weights are held equal entry
for entry. At rotated surface d=5, R=5 it happens, a known divergence:
with 32 iterations on 2,048 of the reference sampler's shots, 11 of
1,140,736 weights differed by one unit, and the decoded observables were
equal on every shot. So belief-matching at d >= 5 is held by its decoded
flips and rates, not by its weights; no d=5 case runs here (the
reference's weights alone take about 50 s on the CPU). Each test names
the reference test it stands in for and stays far below its size.
"""

from functools import partial

import jax
import numpy as np
import pytest
import torch

from qcss_tpu.codes import families as jfam
from qcss_tpu.decode import belief as jbelief
from qcss_tpu.decode import correlated as jcorr
from qcss_tpu.decode import uf as juf
from qcss_tpu.experiments import memory_xz as jxz
from qcss_tpu.sim import frame as jfr
from qcss_tpu.sim.noise import NoiseModel as JNoise
from qcss_tpu_torch.codes import families as tfam
from qcss_tpu_torch.decode import belief as tbelief
from qcss_tpu_torch.decode import correlated as tcorr
from qcss_tpu_torch.decode.spacetime import detector_history
from qcss_tpu_torch.experiments import memory_xz as txz
from qcss_tpu_torch.sim.noise import NoiseModel as TNoise


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # several worker processes run at once; see test_torch_device_uf.py
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("d", [3, 5])
def test_correlated_decodes_reference_shots_identically(monkeypatch, d):
    """Stands in for test_correlated.py::test_correlated_beats_independent
    (d=7, 2^14 shots there): rotated surface d, p=0.08, B=2048, the
    reference's `_sample_and_extract` shots; every failure count of the
    independent and the correlated passes equal."""
    p, batch, seed = 0.08, 2048, d
    code_j = jfam.rotated_surface(d)
    key = jax.random.split(jax.random.key(seed), 1)[0]
    u8 = partial(jax.numpy.asarray, dtype=jax.numpy.uint8)
    shots = [np.asarray(a) for a in juf._sample_and_extract(
        key, jax.numpy.float32(p), batch, u8(code_j.raw_parity_check_c2),
        u8(code_j.raw_parity_check_c1), u8(code_j.z_operator_matrix()),
        u8(code_j.x_operator_matrix()))]

    def replay(generator, p_, batch_, *args):
        assert (p_, batch_) == (p, batch)
        return tuple(torch.tensor(a) for a in shots)

    monkeypatch.setattr(tcorr, "_sample_and_extract", replay)
    ref = jcorr.correlated_logical_error_rate(code_j, p, samples=batch,
                                              batch=batch, seed=seed)
    port = tcorr.correlated_logical_error_rate(
        tfam.rotated_surface(d), p, samples=batch, batch=batch, seed=seed,
        device="cpu")
    assert ref["z_fail"] > 0 and ref["z_fail_corr"] != ref["z_fail"]
    assert port == ref
    assert tcorr.conditional_weights(p) == jcorr.conditional_weights(p)


NOISE = dict(p_gate2=2e-3, p_meas=5e-3)
SHOTS = dict(rounds=3, batch=512, seed=4)


@pytest.fixture(scope="module")
def d3_shots():
    """The reference two-sector sampler's shots at rotated surface d=3,
    NOISE, SHOTS (as the reference's `xz_memory_experiment` draws them),
    their detector histories, and stand-ins for both packages'
    `_sample_two_sector` that return them."""
    code = jfam.rotated_surface(3)
    hz = np.asarray(code.raw_parity_check_c2, np.uint8) & 1
    hx = np.asarray(code.raw_parity_check_c1, np.uint8) & 1
    n, rz = code.n, hz.shape[0]
    z_arrays = tuple(map(jax.numpy.asarray, jxz.z_extraction_circuit(
        code, checks=hz).to_arrays()))
    x_arrays = tuple(map(jax.numpy.asarray, jxz.x_extraction_circuit(
        code, anc_offset=n + rz, checks=hx).to_arrays()))
    nq = n + rz + hx.shape[0]
    fn = jax.jit(partial(jxz._sample_two_sector, code=code,
                         noise=JNoise(**NOISE), z_arrays=z_arrays,
                         x_arrays=x_arrays,
                         z_comp=jfr.maybe_compile(z_arrays, nq),
                         x_comp=jfr.maybe_compile(x_arrays, nq),
                         rz=rz, rx=hx.shape[0]),
                 static_argnames=("batch", "rounds"))
    shots = tuple(np.asarray(a) for a in fn(
        jax.random.key(SHOTS["seed"]), SHOTS["batch"], SHOTS["rounds"]))
    syns_z, syns_x, x_err, z_err = shots
    dets_z = detector_history(syns_z, ((x_err @ hz.T) & 1).astype(np.uint8))
    dets_x = detector_history(syns_x, ((z_err @ hx.T) & 1).astype(np.uint8))

    def replay(generator, batch, rounds, *args, **kw):
        assert (batch, rounds) == (SHOTS["batch"], SHOTS["rounds"])
        return tuple(torch.tensor(a, device=generator.device)
                     for a in shots)

    def ref_replay(key, batch, rounds, **kw):
        assert (batch, rounds) == (SHOTS["batch"], SHOTS["rounds"])
        return tuple(jax.numpy.asarray(a) for a in shots)

    return {"dets": (dets_z, dets_x), "replay": replay,
            "ref_replay": ref_replay}


@pytest.fixture(scope="module")
def bm_pair():
    """Both packages' BeliefMatchingDecoder at rotated surface d=3, R=3,
    8 BP iterations (the reference's construction runs its structural
    decomposition asserts; so does the port's)."""
    kw = dict(iters=8)
    return (jbelief.BeliefMatchingDecoder(jfam.rotated_surface(3),
                                          SHOTS["rounds"], JNoise(**NOISE),
                                          **kw),
            tbelief.BeliefMatchingDecoder(tfam.rotated_surface(3),
                                          SHOTS["rounds"], TNoise(**NOISE),
                                          device="cpu", **kw))


def test_belief_tables_and_scales_equal(bm_pair):
    """Stands in for test_belief.py's construction fixture and
    test_zero_iteration_weights_are_prior_weights: the edge-to-variable
    tables and the weight scales of both sectors are equal."""
    ref, port = bm_pair
    for sector in ("z", "x"):
        np.testing.assert_array_equal(
            port._edge_vars[sector].numpy(),
            np.asarray(ref._edge_vars[sector]).astype(np.int64))
        assert port._scales[sector] == ref._scales[sector]
    assert port._off == ref._off


def test_belief_shot_weights_match_reference(bm_pair, d3_shots):
    """Stands in for test_belief.py::test_single_variable_signatures_
    decode_to_their_obs: on the reference sampler's d=3 shots (B=512),
    the per-shot uint8 weights of both sectors ([512, 52] and [512, 55])
    equal the reference's entry for entry, and the BP convergence flags
    equal."""
    ref, port = bm_pair
    w_ref, c_ref = ref.shot_weights(*d3_shots["dets"])
    w_port, c_port = port.shot_weights(*d3_shots["dets"])
    np.testing.assert_array_equal(c_port, c_ref)
    assert 0 < c_ref.sum() < len(c_ref)
    for sector in ("z", "x"):
        assert w_port[sector].dtype == np.uint8
        np.testing.assert_array_equal(w_port[sector],
                                      np.asarray(w_ref[sector]))


def test_xz_memory_belief_rates_equal_reference(monkeypatch, d3_shots):
    """Stands in for test_belief.py::test_belief_beats_independent_
    matching_same_shots (8k shots there): `xz_memory_experiment(belief=8)`
    at d=3, R=3 on the reference sampler's 512 shots; every rate,
    x/z/word_fail_belief included, equal to the reference's."""
    monkeypatch.setattr(txz, "_sample_two_sector", d3_shots["replay"])
    monkeypatch.setattr(jxz, "_sample_two_sector", d3_shots["ref_replay"])
    ref = jxz.xz_memory_experiment(jfam.rotated_surface(3),
                                   noise=JNoise(**NOISE), belief=8, **SHOTS)
    prof = {}
    port = txz.xz_memory_experiment(tfam.rotated_surface(3),
                                    noise=TNoise(**NOISE), belief=8,
                                    device="cpu", profile=prof, **SHOTS)
    assert ref["word_fail"] > 0
    assert port == ref
    assert set(prof) == {"sampler", "dem_build", "uf", "belief_build", "bp",
                         "weights", "belief_uf"}
