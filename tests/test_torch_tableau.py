"""The port's unpacked stabilizer tableau (`qcss_tpu_torch.sim.tableau`)
and its noise channels against the JAX package's.

* Random Clifford circuits interleaved with measurements and resets give
  equal tableaus and outcomes, given the collapse bits the JAX functions
  draw from their keys: exact (integer/GF(2) math).
* Measurements agree with the dense statevector oracle (the port's copy
  of `sim/statevec.py`): outcomes possible, deterministic ones exact.
* Noise given fault bits equals the JAX gates followed by
  `apply_pauli_frame` of the same flips: exact. Channels with certain
  outcomes (rates 0 or 1) equal the JAX channels: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcss_tpu.circuits.ir import Circuit
from qcss_tpu.sim import noise as jnoise
from qcss_tpu.sim import tableau as jtb
from qcss_tpu_torch.sim import noise as tnoise
from qcss_tpu_torch.sim import tableau as ttb
from qcss_tpu_torch.sim.statevec import StateVector

GATES = ["I", "X", "Y", "Z", "H", "S", "CNOT", "CZ"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_circuit(rng, n, depth):
    circ = Circuit()
    for _ in range(depth):
        k = int(rng.integers(0, len(GATES)))
        a, b = (int(v) for v in rng.choice(n, 2, replace=False))
        circ.gate(GATES[k], *((a,) if k < 6 else (a, b)))
    return circ


def key_bits(key, batch, m):
    """The [B, M] collapse bits a JAX measure_many/reset_many draws from
    ``key`` (column m from split(key, M)[m], as
    `qcss_tpu.sim.pallas_measure.measure_many_fused` derives them)."""
    keys = jax.random.split(key, m)
    return torch.from_numpy(np.array(jax.vmap(
        lambda k: jax.random.bernoulli(k, 0.5, (batch,)).astype(jnp.uint8)
    )(keys)).T.copy())


def assert_equal(tt, jt):
    for a, b in zip(tt, jt):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("n", [5, 40])
def test_circuits_with_measurements_and_resets_equal_jax(n):
    # measure, reset, measure: random and deterministic outcomes both occur
    rng = np.random.default_rng(n)
    B = 8
    jt, tt = jtb.zero_state(B, n), ttb.zero_state(B, n, "cpu")
    key = jax.random.key(n)
    random_outcomes = 0
    for layer in range(3):
        circ = random_circuit(rng, n, 3 * n)
        jt, tt = jtb.run_circuit(jt, circ), ttb.run_circuit(tt, circ)
        assert_equal(tt, jt)
        qs = rng.choice(n, 4, replace=False).astype(np.int32)
        key, sub = jax.random.split(key)
        bits = key_bits(sub, B, len(qs))
        if layer % 2 == 0:
            jt, jo = jtb.measure_many(jt, jnp.asarray(qs), sub)
            tt, to = ttb.measure_many(tt, qs, rand_bits=bits)
            np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
            random_outcomes += int((to != to[:1]).any(0).sum())
        else:
            jt = jtb.reset_many(jt, jnp.asarray(qs), sub)
            tt = ttb.reset_many(tt, qs, rand_bits=bits)
        assert_equal(tt, jt)
    assert random_outcomes > 0  # both branches ran


def test_transversal_layers_equal_jax():
    n = 12
    rng = np.random.default_rng(3)
    circ = random_circuit(rng, n, 40)
    jt = jtb.run_circuit(jtb.zero_state(4, n), circ)
    tt = ttb.run_circuit(ttb.zero_state(4, n, "cpu"), circ)
    a, b = np.arange(6), np.arange(6, 12)
    for jf, tf, args in ((jtb.apply_cnot_many, ttb.apply_cnot_many, (a, b)),
                         (jtb.apply_cz_many, ttb.apply_cz_many, (b, a)),
                         (jtb.apply_h_many, ttb.apply_h_many, (a,)),
                         (jtb.apply_s_many, ttb.apply_s_many, (b,)),
                         (jtb.apply_x_many, ttb.apply_x_many, (a,)),
                         (jtb.apply_z_many, ttb.apply_z_many, (b,))):
        jt, tt = jf(jt, *args), tf(tt, *args)
        assert_equal(tt, jt)
    mask = np.array([1, 0, 0, 1], np.uint8)
    other = random_circuit(rng, n, 20)
    assert_equal(ttb.run_circuit_masked(tt, other, torch.from_numpy(mask)),
                 jtb.run_circuit_masked(jt, other, jnp.asarray(mask)))
    np.testing.assert_array_equal(tt.stabilizer_check_matrix().numpy(),
                                  np.asarray(jt.stabilizer_check_matrix()))


@pytest.mark.parametrize("seed", range(4))
def test_measurements_match_statevector(seed):
    rng = np.random.default_rng(seed)
    n = 4
    t = ttb.zero_state(1, n, "cpu")
    sv = StateVector(n)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(5):
        circ = random_circuit(rng, n, 8)
        t = ttb.run_circuit(t, circ)
        sv.run_circuit(circ)
        q = int(rng.integers(n))
        p1 = sv.prob_one(q)
        t, out = ttb.measure_z(t, q, gen)
        o = int(out[0])
        if p1 < 1e-9 or p1 > 1 - 1e-9:
            assert o == round(p1)
        else:
            assert abs(p1 - 0.5) < 1e-9
        sv.collapse(q, o)


def test_noise_given_fault_bits_equals_jax_gates_and_frames():
    n, B = 9, 16
    rng = np.random.default_rng(7)
    circ = random_circuit(rng, n, 30)
    ops, q0, q1 = circ.to_arrays()
    bits = rng.integers(0, 2, (B, 4 * len(ops))).astype(np.uint8)
    jt = jtb.run_circuit(jtb.zero_state(B, n), random_circuit(rng, n, 20))
    tt = ttb.Tableau(*(torch.from_numpy(np.array(a)) for a in jt))
    for g, (op, a, b) in enumerate(zip(ops, q0, q1)):
        if op < 6:
            bits[:, 4 * g + 2:4 * g + 4] = 0
        jt = jtb.apply_gate(jt, GATES[op], *((a,) if op < 6 else (a, b)))
        xf = np.zeros((B, n), np.uint8)
        zf = np.zeros((B, n), np.uint8)
        xf[:, a], zf[:, a] = bits[:, 4 * g], bits[:, 4 * g + 1]
        xf[:, b] ^= bits[:, 4 * g + 2]
        zf[:, b] ^= bits[:, 4 * g + 3]
        jt = jtb.apply_pauli_frame(jt, jnp.asarray(xf), jnp.asarray(zf))
    got = tnoise.run_arrays_noisy(
        tt, ops, q0, q1, tnoise.NoiseModel(p_gate1=0.1, p_gate2=0.1),
        fault_bits=torch.from_numpy(bits))
    assert_equal(got, jt)


def test_certain_channels_equal_jax():
    # rates 0 and 1 make every draw certain: a Y (both components) on the
    # channels, and X / Z after the gates of the noisy circuit
    rate = (0.0, 1.0, 0.0)
    n = 6
    rng = np.random.default_rng(11)
    circ = random_circuit(rng, n, 16)
    jt = jtb.run_circuit(jtb.zero_state(4, n), circ)
    tt = ttb.run_circuit(ttb.zero_state(4, n, "cpu"), circ)
    key, gen = jax.random.key(0), torch.Generator().manual_seed(0)
    pairs = [
        (jnoise.depolarize1(jt, 2, rate, key),
         tnoise.depolarize1(tt, 2, rate, gen)),
        (jnoise.depolarize1_many(jt, jnp.arange(3), rate, key),
         tnoise.depolarize1_many(tt, range(3), rate, gen)),
        (jnoise.depolarize2_many(jt, jnp.arange(3), jnp.arange(3, 6), rate,
                                 key),
         tnoise.depolarize2_many(tt, range(3), range(3, 6), rate, gen)),
    ]
    for j, t in pairs:
        assert_equal(t, j)
    # a biased two-qubit location is the 1q channel on both qubits
    for a, b in zip(tnoise.depolarize2(tt, 1, 4, rate, gen),
                    tnoise.depolarize1_many(tt, [1, 4], rate, gen)):
        assert torch.equal(a, b)
    model = dict(p_gate1=1.0, p_gate2=1.0, pauli1=(1.0, 0.0, 0.0),
                 pauli2=(0.0, 0.0, 1.0))
    assert_equal(
        tnoise.run_circuit_noisy(tt, circ, tnoise.NoiseModel(**model), gen),
        jnoise.run_circuit_noisy(jt, circ, jnoise.NoiseModel(**model), key))
    assert_equal(
        tnoise.noisy_gate(tt, "CNOT", (0, 5), tnoise.NoiseModel(**model), gen),
        jnoise.noisy_gate(jt, "CNOT", (0, 5), jnoise.NoiseModel(**model),
                          key))


def test_uniform_channels_hit_at_their_rates():
    # scalar rates draw: each 1q location hits X or Y (an X component)
    # with probability 2p/3; a 2q location hits something with p
    B, n, p = 4096, 4, 0.3
    t = ttb.zero_state(B, n, "cpu")
    gen = torch.Generator().manual_seed(5)
    x_comp = tnoise.depolarize1_many(t, range(n), p, gen).r[:, n:]
    assert abs(float(x_comp.float().mean()) - 2 * p / 3) < 0.02
    two = tnoise.depolarize2_many(t, [0, 1], [2, 3], p, gen).r[:, n:]
    # pair (0, 2) flips stabilizer Z_0 or Z_2 unless its pattern has no X
    # component (3 of the 15), likewise pair (1, 3)
    hit = torch.cat([two[:, 0] | two[:, 2], two[:, 1] | two[:, 3]])
    assert abs(float(hit.float().mean()) - p * 12 / 15) < 0.02
