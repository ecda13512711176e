"""The port's Pauli-frame sampler against the JAX package's.

* Deterministic parts are exact: compiled matrices, and frames propagated
  through a noisy circuit given the same fault bits (the JAX package's
  own bits, `_sampled_fault_bits`, which its per-gate engine consumes
  identically) and the same initial flips.
* The samplers draw from different generators (threefry vs torch), so
  sampled detector rates are compared statistically: each of the port's
  per-detector rates must fall inside the 99.9% Wilson interval
  (z = 3.2905) of the JAX sampler's rate for that detector. The port
  samples 16x the JAX batch, so its own spread adds little: the chance
  that a detector falls outside by noise alone is about 0.14%.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcss_tpu.codes.families import rotated_surface
from qcss_tpu.decode.spacetime import detector_history
from qcss_tpu.experiments import memory as jmem
from qcss_tpu.sim import frame as jfr
from qcss_tpu.sim.noise import NoiseModel as JNoise
from qcss_tpu_torch.experiments import memory as tmem
from qcss_tpu_torch.sim import frame as tfr
from qcss_tpu_torch.sim.noise import NoiseModel as TNoise

Z999 = 3.2905


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The suite runs in several worker processes at once; torch's intra-op
    # threads would oversubscribe the cores and spin, and these tensors are
    # small enough that one thread is fastest anyway.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _circuit(basis, d):
    code = rotated_surface(d)
    if basis == "z":
        raw = code.raw_parity_check_c2
        circ = jmem.z_extraction_circuit(code, checks=raw)
    else:
        raw = code.raw_parity_check_c1
        circ = jmem.x_extraction_circuit(code, checks=raw)
    return code, raw, circ.to_arrays(), code.n + raw.shape[0]


@pytest.mark.parametrize("basis,d", [("z", 3), ("x", 3), ("z", 5),
                                     ("x", 5)])
def test_compile_circuit_equal(basis, d):
    _, _, (ops, q0, q1), n = _circuit(basis, d)
    cj = jfr.compile_circuit(ops, q0, q1, n)
    ct = tfr.compile_circuit(ops, q0, q1, n)
    np.testing.assert_array_equal(ct.m.numpy(), np.asarray(cj.m))
    np.testing.assert_array_equal(ct.s.numpy(), np.asarray(cj.s))
    assert ct.ops == cj.ops and ct.n == cj.n
    cl = tfr.compiled_from_numpy(np.asarray(cj.m), np.asarray(cj.s),
                                 cj.ops, cj.n)
    assert torch.equal(cl.m, ct.m) and torch.equal(cl.s, ct.s)


NOISE = {
    "depolarizing": dict(p_gate1=0.02, p_gate2=0.03),
    "biased": dict(p_gate1=0.03, p_gate2=0.06, pauli1=(0.01, 0.005, 0.015),
                   pauli2=(0.02, 0.01, 0.03)),
}


@pytest.mark.parametrize("noise", sorted(NOISE))
@pytest.mark.parametrize("basis", ["z", "x"])
def test_noisy_frames_bit_identical_given_fault_bits(basis, noise):
    _, _, (ops, q0, q1), n = _circuit(basis, 3)
    mj, mt = JNoise(**NOISE[noise]), TNoise(**NOISE[noise])
    B = 512
    rng = np.random.default_rng(7)
    x0 = rng.integers(0, 2, (B, n), dtype=np.uint8)
    z0 = rng.integers(0, 2, (B, n), dtype=np.uint8)
    fj = jfr.inject_flips(jfr.zero_frames(B, n), jnp.arange(n), x0, z0)
    ft = tfr.inject_flips(tfr.zero_frames(B, n, "cpu"), np.arange(n),
                          torch.as_tensor(x0), torch.as_tensor(z0))
    key = jax.random.key(3)
    cj = jfr.compile_circuit(ops, q0, q1, n)
    bits = torch.from_numpy(
        np.array(jfr._sampled_fault_bits(cj, mj, key, B)))
    assert bits.any()
    ref = jfr.run_arrays_noisy(fj, ops, q0, q1, mj, key)
    ref_c = jfr.run_compiled_noisy(fj, cj, mj, key)
    ct = tfr.compile_circuit(ops, q0, q1, n)
    for out in (tfr.run_arrays_noisy(ft, ops, q0, q1, mt, fault_bits=bits),
                tfr.run_compiled_noisy(ft, ct, mt, fault_bits=bits)):
        for a, b, c in zip(out, ref, ref_c):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            np.testing.assert_array_equal(a.numpy(), np.asarray(c))


def test_measure_and_reset_match():
    B, n = 64, _circuit("x", 3)[3]
    rng = np.random.default_rng(1)
    x0 = rng.integers(0, 2, (B, n), dtype=np.uint8)
    z0 = rng.integers(0, 2, (B, n), dtype=np.uint8)
    q = np.array([2, 5, 7])
    fj = jfr.inject_flips(jfr.zero_frames(B, n), jnp.arange(n), x0, z0)
    ft = tfr.inject_flips(tfr.zero_frames(B, n, "cpu"), np.arange(n),
                          torch.as_tensor(x0), torch.as_tensor(z0))
    _, oj = jfr.measure_deviations(fj, q)
    _, ot = tfr.measure_deviations(ft, q)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    rj, rt = jfr.reset_qubits(fj, q), tfr.reset_qubits(ft, q)
    for a, b in zip(rt, rj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    pj = jfr.propagate_arrays(fj, *_circuit("x", 3)[2][:3])
    pt = tfr.propagate_arrays(ft, *_circuit("x", 3)[2][:3])
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_port_engines_bit_identical_on_one_seed():
    # The per-gate and the compiled engine draw the generator identically.
    code, raw, arrays, n = _circuit("z", 3)
    noise = TNoise(p_gate2=0.02, p_meas=0.02, p_reset=0.01)
    comp = tfr.compile_circuit(*arrays, n)
    outs = []
    for c in (None, comp):
        gen = torch.Generator().manual_seed(11)
        outs.append(tmem._memory_circuit_frames(
            gen, 1024, 3, code, noise, arrays, raw.shape[0],
            extract_comp=c))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def _wilson(k, n, z=Z999):
    p = k / n
    den = 1 + z * z / n
    mid = (p + z * z / (2 * n)) / den
    half = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / den
    return mid - half, mid + half


@pytest.mark.parametrize("engine", ["scan", "compiled"])
def test_detector_rates_within_wilson_of_jax(engine):
    d, R = 3, 3
    code, raw, arrays, n = _circuit("z", d)
    kw = dict(p_gate2=1e-2, p_meas=1e-2, p_reset=5e-3)
    Bj, Bt = 8192, 8192 * 16
    comp_j = jfr.compile_circuit(*arrays, n) if engine == "compiled" else None
    syn_j, word_j = jmem._memory_circuit_frames(
        jax.random.key(0), Bj, R, code, JNoise(**kw),
        tuple(map(jnp.asarray, arrays)), n_anc=raw.shape[0],
        extract_comp=comp_j)
    syn_j, word_j = np.asarray(syn_j), np.asarray(word_j)
    dets_j = detector_history(syn_j, (word_j.astype(np.int64) @ raw.T) & 1)
    comp_t = tfr.compile_circuit(*arrays, n) if engine == "compiled" else None
    syn_t, word_t = tmem._memory_circuit_frames(
        torch.Generator().manual_seed(0), Bt, R, code, TNoise(**kw), arrays,
        raw.shape[0], extract_comp=comp_t)
    dets_t = detector_history(
        syn_t.numpy(), (word_t.numpy().astype(np.int64) @ raw.T) & 1)
    assert dets_t.shape == (Bt, (R + 1) * raw.shape[0])
    kj = dets_j.sum(axis=0)
    rate_t = dets_t.mean(axis=0)
    for k, r in zip(kj, rate_t):
        lo, hi = _wilson(int(k), Bj)
        assert lo <= r <= hi, (k / Bj, r, lo, hi)
