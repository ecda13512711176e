"""The port's packed tableau (`qcss_tpu_torch.sim.tableau_packed`) and
K9's plain version against the JAX package's.

* Random Clifford circuits interleaved with measurements and resets give
  equal words, signs and outcomes at n = 40 (two words; bit 31 of the
  first word set in many rows), given the collapse bits the JAX functions
  draw from their keys: exact.
* `cuda_measure.measure_many_fused` on a CPU tableau (the plain version
  of K9, the scan) equals the JAX package's fused kernel
  `_measure_many_fused_t`, run in interpret mode as
  tests/test_pallas_measure.py runs it: exact.
* Packing, Pauli frames and the generator's draws agree with the
  unpacked tableau and the scan: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcss_tpu.circuits.ir import Circuit
from qcss_tpu.sim import tableau_packed as jtp
from qcss_tpu.sim.pallas_measure import measure_many_fused as jfused
from qcss_tpu_torch.sim import cuda_measure
from qcss_tpu_torch.sim import tableau as ttb
from qcss_tpu_torch.sim import tableau_packed as ttp

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
    """The [B, M] collapse bits JAX draws from ``key`` for M measured
    qubits, as `qcss_tpu.sim.pallas_measure.measure_many_fused` does."""
    keys = jax.random.split(key, m)
    return torch.from_numpy(np.array(jax.vmap(
        lambda k: jax.random.bernoulli(k, 0.5, (batch,)).astype(jnp.uint8)
    )(keys)).T.copy())


def assert_equal(tt, jt):
    np.testing.assert_array_equal(tt.x.numpy(),
                                  np.asarray(jt.x).view(np.int32))
    np.testing.assert_array_equal(tt.z.numpy(),
                                  np.asarray(jt.z).view(np.int32))
    np.testing.assert_array_equal(tt.r.numpy(), np.asarray(jt.r))


def test_circuits_with_measurements_and_resets_equal_jax():
    n, B = 40, 8
    rng = np.random.default_rng(40)
    jt, tt = jtp.zero_state(B, n), ttp.zero_state(B, n, "cpu")
    key = jax.random.key(4)
    bit31_rows = 0
    for layer in range(2):  # measure, then reset
        circ = random_circuit(rng, n, 3 * n).h(31).cnot(31, 35)
        jt, tt = jtp.run_circuit(jt, circ), ttp.run_circuit(tt, circ)
        assert_equal(tt, jt)
        bit31_rows += int((tt.x[:, :, 0] < 0).sum())
        qs = np.concatenate([[31], rng.choice(np.r_[0:31, 32:n], 5,
                                              replace=False)]).astype(np.int32)
        key, sub = jax.random.split(key)
        bits = key_bits(sub, B, len(qs))
        if layer % 2 == 0:
            jt, jo = jtp.measure_many(jt, jnp.asarray(qs), sub)
            tt, to = ttp.measure_many(tt, qs, rand_bits=bits)
            np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        else:
            jt = jtp.reset_many(jt, jnp.asarray(qs), sub)
            tt = ttp.reset_many(tt, qs, rand_bits=bits)
        assert_equal(tt, jt)
    assert bit31_rows > 0


@pytest.mark.parametrize("n", [7, 40])
def test_plain_k9_equals_jax_fused_kernel(n):
    B = 16
    rng = np.random.default_rng(n)
    circ = random_circuit(rng, n, 80)
    jt = jtp.run_circuit(jtp.zero_state(B, n), circ)
    tt = ttp.run_circuit(ttp.zero_state(B, n, "cpu"), circ)
    qs = rng.choice(n, min(n, 9), replace=False).astype(np.int32)
    if n > 32:
        qs[0] = 31
    key = jax.random.key(100 + n)
    jt2, jo = jfused(jt, jnp.asarray(qs), key)
    before = cuda_measure.launches
    tt2, to = cuda_measure.measure_many_fused(
        tt, qs, rand_bits=key_bits(key, B, len(qs)))
    assert cuda_measure.launches == before  # a CPU tableau never reaches K9
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert_equal(tt2, jt2)


def test_fused_draws_as_the_scan_and_packing_agrees():
    n, B = 37, 32
    rng = np.random.default_rng(1)
    circ = random_circuit(rng, n, 120)
    tt = ttp.run_circuit(ttp.zero_state(B, n, "cpu"), circ)
    ut = ttb.run_circuit(ttb.zero_state(B, n, "cpu"), circ)
    for a, b in zip(ttp.to_unpacked(tt), ut):
        assert torch.equal(a, b)
    repacked = ttp.from_unpacked(ut)
    assert torch.equal(repacked.x, tt.x) and torch.equal(repacked.z, tt.z)
    qs = [0, 31, 32, 36, 5]
    def gen():
        return torch.Generator().manual_seed(9)

    a = cuda_measure.measure_many_fused(tt, qs, gen())
    b = ttp.measure_many(tt, qs, gen())
    c = ttb.measure_many(ut, qs, gen())
    assert torch.equal(a[1], b[1]) and torch.equal(a[1], c[1])
    assert torch.equal(a[0].x, b[0].x) and torch.equal(a[0].r, c[0].r)
    assert 0 < float(a[1].float().mean()) < 1
    # Pauli frames: packed flips equal unpacked flips
    xf = torch.from_numpy(rng.integers(0, 2, (B, n)).astype(np.uint8))
    zf = torch.from_numpy(rng.integers(0, 2, (B, n)).astype(np.uint8))
    got = ttp.apply_pauli_frame(tt, ttp._pack(xf), ttp._pack(zf))
    assert torch.equal(got.r, ttb.apply_pauli_frame(ut, xf, zf).r)
    jt = jtp.from_unpacked(type("T", (), {
        "x": jnp.asarray(ut.x.numpy()), "z": jnp.asarray(ut.z.numpy()),
        "r": jnp.asarray(ut.r.numpy()), "n": n})())
    assert_equal(got, jtp.apply_pauli_frame(
        jt, jnp.asarray(ttp._pack(xf).numpy().view(np.uint32)),
        jnp.asarray(ttp._pack(zf).numpy().view(np.uint32))))


def test_tableau_bench_rows_on_cpu():
    from qcss_tpu_torch.benchmarks import tableau_bench

    rows = tableau_bench.run(batch=8, qubits=(33,), reps=1, device="cpu")
    assert [r["engine"] for r in rows] == list(tableau_bench.ENGINES)
    assert all(r["device"] == "cpu" and r["value"] > 0 and r["measured"] == 32
               for r in rows)
