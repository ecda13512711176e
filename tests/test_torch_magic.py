"""The port's magic-state distillation (`qcss_tpu_torch.ftqc.magic`)
against the JAX package's, on the CPU.

* the enumerators, the exact map and the cascade are copied numpy
  (tests/test_torch_import.py holds their text): equal to the reference's
  on RM15 over a grid of p;
* the circuit tier under trivial Clifford noise with explicit injections
  is deterministic: every one of the 2^15 Z-injection patterns in one
  batch gives the reference's ``accept`` / ``error`` bits exactly, which
  are also the coset membership computed here on the host;
* the samplers differ (torch generators against threefry keys), so the
  Monte-Carlo and noisy circuit tiers are held to the reference's counts
  by two-sample 99.9% tests at B = 4096.
"""

import math

import numpy as np
import pytest
import torch

from qcss_tpu.codes import families as jfam
from qcss_tpu.ftqc import magic as jmagic
from qcss_tpu.sim.noise import NoiseModel as JNoise
from qcss_tpu_torch.codes import families as tfam
from qcss_tpu_torch.errors import UnsupportedGateError
from qcss_tpu_torch.ftqc import magic as tmagic
from qcss_tpu_torch.sim.noise import NoiseModel as TNoise

Z999 = 3.2905
P_GRID = [1e-4, 1e-3, 1e-2, 0.1, 0.5]
NOISY = dict(p_gate1=1e-3, p_gate2=1e-3, p_meas=1e-3, p_reset=1e-3)
B = 4096


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


@pytest.fixture(scope="module")
def codes():
    return jfam.reed_muller_15(), tfam.reed_muller_15()


@pytest.fixture(scope="module")
def all_patterns():
    n = 15
    idx = np.arange(1 << n)
    return ((idx[:, None] >> np.arange(n)) & 1).astype(np.uint8)


def test_enumerators_equal(codes):
    cj, ct = codes
    for a, b in zip(jmagic.distillation_enumerators(cj),
                    tmagic.distillation_enumerators(ct)):
        np.testing.assert_array_equal(a, b)
    w0, w1 = tmagic.distillation_enumerators(ct)
    assert w1[3] == 35 and not np.any(w1[:3])


@pytest.mark.parametrize("p", P_GRID)
def test_distill_exact_equal(codes, p):
    assert tmagic.distill_exact(p, codes[1]) == jmagic.distill_exact(
        p, codes[0])
    assert tmagic.distill_exact(p) == jmagic.distill_exact(p)


@pytest.mark.parametrize("levels", [1, 3])
def test_distill_cascade_equal(levels):
    assert tmagic.distill_cascade(1e-2, levels) == \
        jmagic.distill_cascade(1e-2, levels)
    out = tmagic.distill_cascade(1e-2, 3)[0]["p_out"]
    assert abs(out / (35 * 1e-6) - 1) < 0.05


@pytest.mark.parametrize("name", ["steane", "golay"])
def test_non_distillable_refused(name):
    ct, cj = getattr(tfam, name)(), getattr(jfam, name)()
    with pytest.raises(UnsupportedGateError) as got:
        tmagic.distill_exact(1e-3, code=ct)
    with pytest.raises(Exception) as want:
        jmagic.distill_exact(1e-3, code=cj)
    assert str(got.value) == str(want.value)
    for call in (lambda: tmagic.distill_mc(1e-3, 64, code=ct, device="cpu"),
                 lambda: tmagic.distill_circuit(TNoise(), 1e-3, 64, code=ct,
                                                device="cpu")):
        with pytest.raises(UnsupportedGateError):
            call()


@pytest.mark.parametrize("extractions", [1, 2])
def test_exhaustive_injections_bit_identical(codes, all_patterns,
                                             extractions):
    cj, ct = codes
    got = tmagic.distill_circuit(TNoise(), 0.0, all_patterns.shape[0],
                                 code=ct, extractions=extractions,
                                 inject=all_patterns, return_samples=True,
                                 device="cpu")
    want = jmagic.distill_circuit(JNoise(), 0.0, all_patterns.shape[0],
                                  code=cj, extractions=extractions,
                                  inject=all_patterns, return_samples=True)
    np.testing.assert_array_equal(got["accept"], want["accept"])
    np.testing.assert_array_equal(got["error"], want["error"])
    # the coset membership, on the host: accept iff H_1 e = 0, error iff
    # additionally <x̄, e> = 1
    h1 = np.asarray(ct.parity_check_c1, np.int64)
    xbar = np.asarray(ct.x_operator_matrix()[0], np.int64)
    e = all_patterns.astype(np.int64)
    accept = ~((e @ h1.T) & 1).any(axis=1)
    np.testing.assert_array_equal(got["accept"], accept)
    np.testing.assert_array_equal(got["error"], ((e @ xbar) & 1) == 1)
    assert got["accepted"] == 1 << (ct.n - ct.r_1)


def test_distill_mc_rates_agree():
    p = 0.05
    got = tmagic.distill_mc(p, B, seed=3, device="cpu")
    want = jmagic.distill_mc(p, B, seed=3)
    assert _two_sample_ok(got["accepted"], B, want["accepted"], B)
    bad_g = round(got["p_out"] * got["accepted"])
    bad_w = round(want["p_out"] * want["accepted"])
    assert _two_sample_ok(bad_g, got["accepted"], bad_w, want["accepted"])
    assert bad_g > 0
    exact = tmagic.distill_exact(p)["p_accept"]
    assert abs(got["p_accept"] - exact) < Z999 * math.sqrt(
        exact * (1 - exact) / B)


def test_distill_circuit_noisy_rates_agree(codes):
    got = tmagic.distill_circuit(TNoise(**NOISY), 0.03, B, code=codes[1],
                                 seed=2, device="cpu")
    want = jmagic.distill_circuit(JNoise(**NOISY), 0.03, B, code=codes[0],
                                  seed=2)
    assert _two_sample_ok(got["accepted"], B, want["accepted"], B)
    bad_g = round(got["p_out"] * got["accepted"])
    bad_w = round(want["p_out"] * want["accepted"])
    assert _two_sample_ok(bad_g, got["accepted"], bad_w, want["accepted"])
    quiet = tmagic.distill_circuit(TNoise(), 0.03, B, code=codes[1], seed=2,
                                   device="cpu")
    assert quiet["p_accept"] > got["p_accept"]
