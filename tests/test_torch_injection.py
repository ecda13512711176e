"""The port's magic-state injection (`qcss_tpu_torch.experiments.injection`)
against the JAX package's, on the CPU.

* the final perfect decode (the packed sector decode: K8's plain version,
  then K6's against the sector's first logical row) on given frames is
  bit-identical to the reference's dense decode (`syndromes_dense`, the
  LUT gather, the residual against the other sector's logical), written
  here with the JAX package's own ops;
* the exact cases of the reference's tests: a quiet run is exactly zero,
  and a certain T fault is Z̄ on every shot with a trivial syndrome;
* the refusals (idle noise, missing LUTs) keep the reference's messages;
* the samplers differ, so the noisy Steane rates are held to the
  reference's counts by two-sample 99.9% tests;
* `factory_report` composes the injection into the reference's cascade:
  given the port's injection dict, the reference's cascade and cost are
  the port's, and so is `logical_resource_report(factory=...)`.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcss_tpu.codes import families as jfam
from qcss_tpu.experiments import injection as jinj
from qcss_tpu.experiments import logical as jl
from qcss_tpu.experiments import resources as jres
from qcss_tpu.ftqc import magic as jmagic
from qcss_tpu.ops import gf2_jax
from qcss_tpu.sim.noise import NoiseModel as JNoise
from qcss_tpu_torch.codes import families as tfam
from qcss_tpu_torch.experiments import injection as tinj
from qcss_tpu_torch.experiments import logical as tl
from qcss_tpu_torch.experiments import resources as tres
from qcss_tpu_torch.sim.noise import NoiseModel as TNoise

Z999 = 3.2905
NOISY = dict(p_gate1=2e-3, p_gate2=2e-3, p_meas=2e-3, p_reset=2e-3)
B = 8192


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # several worker processes run at once; see test_torch_device_uf.py
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _two_sample_ok(k1, n1, k2, n2):
    pooled = (k1 + k2) / (n1 + n2)
    spread = Z999 * math.sqrt(pooled * (1 - pooled) * (1 / n1 + 1 / n2))
    return abs(k1 / n1 - k2 / n2) <= spread


def _dense_decode(code, fx, fz):
    """The reference's final decode (injection.py:89-97), on given
    frames."""
    dev = code.device
    h1 = jnp.asarray(code.parity_check_c1, jnp.uint8)
    h2 = jnp.asarray(code.parity_check_c2, jnp.uint8)
    xbar = jnp.asarray(code.x_operator_matrix()[0], jnp.int32)
    zbar = jnp.asarray(code.z_operator_matrix()[0], jnp.int32)
    fz, fx = jnp.asarray(fz), jnp.asarray(fx)
    syn_z = gf2_jax.syndromes_dense(fz, h1)
    fz = fz ^ jnp.take(dev.lut_c1, gf2_jax.bits_to_index(syn_z), axis=0)
    syn_x = gf2_jax.syndromes_dense(fx, h2)
    fx = fx ^ jnp.take(dev.lut_c2, gf2_jax.bits_to_index(syn_x), axis=0)
    log_z = (fz.astype(jnp.int32) @ xbar) & 1
    log_x = (fx.astype(jnp.int32) @ zbar) & 1
    return np.asarray(log_x), np.asarray(log_z)


@pytest.mark.parametrize("name,rate", [("steane", 0.15), ("steane", 0.5),
                                       ("golay", 0.1), ("toric2", 0.2)])
def test_final_decode_bit_identical(name, rate):
    if name == "toric2":  # k = 2: the first logical row is the one read
        cj = jfam.toric(2, max_table_weight=None)
        ct = tfam.toric(2, max_table_weight=None)
    else:
        cj, ct = getattr(jfam, name)(), getattr(tfam, name)()
    rng = np.random.default_rng(int(rate * 1000) + len(name))
    fx = (rng.random((2048, ct.n)) < rate).astype(np.uint8)
    fz = (rng.random((2048, ct.n)) < rate).astype(np.uint8)
    lx, lz = tinj.final_decode(torch.as_tensor(fx), torch.as_tensor(fz),
                               tinj.final_sectors(ct, "cpu"))
    want_x, want_z = _dense_decode(cj, fx, fz)
    np.testing.assert_array_equal(lx.numpy(), want_x)
    np.testing.assert_array_equal(lz.numpy(), want_z)
    assert 0 < want_x.sum() < 2048 and 0 < want_z.sum() < 2048


def test_quiet_is_exact_zero():
    r = tinj.magic_injection_experiment(tfam.steane(), TNoise(), 0.0, 1 << 12,
                                        seed=0, device="cpu")
    assert r["p_accept"] == 1.0 and r["eps"] == 0.0


@pytest.mark.parametrize("name", ["steane", "surface3"])
def test_t_fault_is_logical_z_with_trivial_syndrome(name):
    code = (tfam.steane() if name == "steane"
            else tfam.rotated_surface(3, max_table_weight=2))
    r = tinj.magic_injection_experiment(code, TNoise(), 1.0, 256, seed=1,
                                        extractions=2, return_samples=True,
                                        device="cpu")
    assert r["p_accept"] == 1.0
    assert r["p_z"] == 1.0 and r["p_x"] == 0.0 and r["p_y"] == 0.0
    assert r["eps"] == 1.0
    assert r["accept"].all() and r["log_z"].all() and not r["log_x"].any()


def test_refusals_keep_the_reference_messages():
    def message(fn):
        with pytest.raises(ValueError) as exc:
            fn()
        return str(exc.value)

    assert message(lambda: tinj.magic_injection_experiment(
        tfam.steane(), TNoise(p_idle=1e-4), 0.0, 64, device="cpu")) == \
        message(lambda: jinj.magic_injection_experiment(
            jfam.steane(), JNoise(p_idle=1e-4), 0.0, 64))
    assert message(lambda: tinj.magic_injection_experiment(
        tfam.rotated_surface(5), TNoise(), 0.0, 64, device="cpu")) == \
        message(lambda: jinj.magic_injection_experiment(
            jfam.rotated_surface(5), JNoise(), 0.0, 64))


def test_steane_noisy_rates_agree():
    got = tinj.magic_injection_experiment(tfam.steane(), TNoise(**NOISY),
                                          0.01, B, seed=4, device="cpu")
    want = jinj.magic_injection_experiment(jfam.steane(), JNoise(**NOISY),
                                           0.01, B, seed=4)
    assert got["p_accept"] < 1.0
    assert _two_sample_ok(got["accepted"], B, want["accepted"], B)
    for k in ("p_x", "p_y", "p_z"):
        assert _two_sample_ok(round(got[k] * got["accepted"]),
                              got["accepted"],
                              round(want[k] * want["accepted"]),
                              want["accepted"]), k
    assert got["p_z"] > 0.5 * 0.01


def test_factory_report_composes_the_reference_cascade():
    noise = TNoise(p_gate1=1e-4, p_gate2=1e-4, p_meas=1e-4, p_reset=1e-4)
    rep = tinj.factory_report(tfam.steane(), noise, 1e-3, levels=2,
                              batch=1 << 14, seed=5, device="cpu")
    inj = rep["injection"]
    assert 0 < inj["eps"] < 0.01
    cascade = jmagic.distill_cascade(inj["eps"], 2)
    assert rep["cascade"] == cascade
    assert rep["p_out"] == cascade[-1]["p_out"]
    assert rep["injections_per_state"] == \
        cascade[-1]["raw_cost"] / max(inj["p_accept"], 1e-30)
    kw = dict(target=2e-2, fails={3: 0.02, 5: 0.004}, factory=rep)
    got = tres.logical_resource_report(
        lambda d: tl.LogicalProgram(d, 2).cnot(0, 1).t(1), 2e-3, **kw)
    ref = jres.logical_resource_report(
        lambda d: jl.LogicalProgram(d, 2).cnot(0, 1).t(1), 2e-3, **kw)
    assert got == ref and got["magic"]["t_count"] == 1
