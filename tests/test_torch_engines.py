"""The port's block engines (`qcss_tpu_torch.ftqc.engines`) against the JAX
package's, and against each other.

* Noiseless block operations (block circuits, transversal layers, logical
  Pauli injection) give states equal to the JAX engines': exact.
* Block measurement and reset, given the collapse bits that the JAX
  engine draws from its key, give equal outcomes and states: exact.
* The port's unpacked and packed engines give identical states on every
  block operation (after mapping the packed engine's word-aligned blocks
  to contiguous ones), as tests/test_engines.py holds the reference's:
  exact. Under noise the two draw a block circuit's faults identically
  (the frame sampler's), so there too: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcss_tpu.circuits.ir import Circuit
from qcss_tpu.ftqc import engines as jeng
from qcss_tpu.sim.noise import NoiseModel as JNoise
from qcss_tpu_torch.ftqc import engines as teng
from qcss_tpu_torch.sim import tableau_packed as ttp
from qcss_tpu_torch.sim.noise import NoiseModel as TNoise

N = 7          # Steane-sized blocks
N_BLOCKS = 2
BATCH = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
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


def key_bits(key, batch, m):
    """The [B, M] collapse bits a JAX measure_many/reset_many draws from
    ``key``, as `qcss_tpu.sim.pallas_measure.measure_many_fused` derives
    them."""
    keys = jax.random.split(key, m)
    return torch.from_numpy(np.array(jax.vmap(
        lambda k: jax.random.bernoulli(k, 0.5, (batch,)).astype(jnp.uint8)
    )(keys)).T.copy())


def state_arrays(t):
    """(x, z, r) numpy arrays of a JAX or port tableau, packed words read
    as int32."""
    if isinstance(t, ttp.PackedTableau):
        return t.x.numpy(), t.z.numpy(), t.r.numpy()
    if hasattr(t, "n") and not isinstance(t, tuple):  # JAX PackedTableau
        return (np.asarray(t.x).view(np.int32), np.asarray(t.z).view(np.int32),
                np.asarray(t.r))
    return tuple(np.asarray(a) for a in t)


def assert_same(port, ref):
    for a, b in zip(state_arrays(port), state_arrays(ref)):
        np.testing.assert_array_equal(a, b)


def contiguous(pe, pt):
    """The packed engine's state on its real qubits, mapped to the
    contiguous layout of the unpacked engine: (x, z, r) restricted to
    the rows and columns of real qubits."""
    up = ttp.to_unpacked(pt)
    cols = np.concatenate([np.arange(N) + b * pe.stride
                           for b in range(N_BLOCKS)])
    n_tot = pe.stride * N_BLOCKS
    rows = np.concatenate([cols, n_tot + cols])
    x, z = (a.numpy()[:, rows][:, :, cols] for a in (up.x, up.z))
    return x, z, up.r.numpy()[:, rows]


def assert_engines_agree(pe, ut, pt):
    for a, b in zip(contiguous(pe, pt), (ut.x.numpy(), ut.z.numpy(),
                                         ut.r.numpy())):
        np.testing.assert_array_equal(a, b)


def entangle_arrays():
    circ = Circuit()
    for q in range(N):
        circ.h(q)
    for q in range(N - 1):
        circ.cnot(q, q + 1)
    circ.s(0).cz(0, N - 1).y(3)
    return circ.to_arrays()


@pytest.fixture(scope="module")
def states():
    """Both packages' engines of both kinds, driven into the same
    entangled state on every block."""
    arrays = entangle_arrays()
    out = {}
    for kind in ("unpacked", "packed"):
        je = jeng.make_engine(kind, N, N_BLOCKS, JNoise())
        te = teng.make_engine(kind, N, N_BLOCKS, TNoise())
        jt, tt = je.zero_state(BATCH), te.zero_state(BATCH, device="cpu")
        for b in range(N_BLOCKS):
            jt = je.run_block_circuit(jt, arrays, b, jax.random.key(3))
            tt = te.run_block_circuit(tt, arrays, b)
        assert_same(tt, jt)
        out[kind] = (je, te, jt, tt)
    assert_engines_agree(out["packed"][1], out["unpacked"][3],
                         out["packed"][3])
    return out


OPS = ["cnot", "cz", "h", "s", "x", "z", "pauli", "measure", "reset"]


def apply(kind, eng, tab, op, key):
    """One block operation; JAX engines get ``key``, port engines the
    collapse bits derived from it."""
    port = isinstance(eng, (teng.UnpackedEngine, teng.PackedEngine))
    k = None if port else key
    if op == "cnot":
        return eng.transversal_cnot(tab, 0, 1, k), None
    if op == "cz":
        return eng.transversal_cz(tab, 1, 0, k), None
    if op in ("h", "s", "x", "z"):
        return eng.transversal_1q(tab, op.upper(), 1, k), None
    if op == "pauli":
        rng = np.random.default_rng(0)
        x_row = rng.integers(0, 2, N).astype(np.uint8)
        z_row = rng.integers(0, 2, N).astype(np.uint8)
        mask = np.array([1, 0, 1, 1], np.uint8)
        if port:
            return eng.pauli_inject(tab, 1, x_row, z_row,
                                    torch.from_numpy(mask)), None
        return eng.pauli_inject(tab, 1, jnp.asarray(x_row), jnp.asarray(z_row),
                                jnp.asarray(mask)), None
    bits = key_bits(key, BATCH, N) if port else None
    if op == "measure":
        if port:
            return eng.measure_block(tab, 1, rand_bits=bits)
        return eng.measure_block(tab, 1, key)
    if port:
        return eng.reset_block(tab, 0, rand_bits=bits), None
    return eng.reset_block(tab, 0, key), None


@pytest.mark.parametrize("op", OPS)
def test_block_op_equals_jax_and_engines_agree(states, op):
    key = jax.random.key(13)
    got = {}
    for kind in ("unpacked", "packed"):
        je, te, jt, tt = states[kind]
        jt2, jo = apply(kind, je, jt, op, key)
        tt2, to = apply(kind, te, tt, op, key)
        assert_same(tt2, jt2)
        if op == "measure":
            np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        got[kind] = (tt2, to)
    assert_engines_agree(states["packed"][1], got["unpacked"][0],
                         got["packed"][0])
    if op == "measure":
        assert torch.equal(got["unpacked"][1], got["packed"][1])
        outs = got["packed"][1].float().mean()
        assert 0 < outs < 1  # the entangled blocks measure at random


def test_noisy_block_circuit_engines_agree():
    noise = TNoise(p_gate1=0.2, p_gate2=0.3)
    ue = teng.UnpackedEngine(N, N_BLOCKS, noise)
    pe = teng.PackedEngine(N, N_BLOCKS, noise)
    arrays = entangle_arrays()
    ut, pt = ue.zero_state(64, "cpu"), pe.zero_state(64, "cpu")
    for b in range(N_BLOCKS):
        ut = ue.run_block_circuit(ut, arrays, b,
                                  torch.Generator().manual_seed(b))
        pt = pe.run_block_circuit(pt, arrays, b,
                                  torch.Generator().manual_seed(b))
    assert_engines_agree(pe, ut, pt)
    # noise struck: the signs differ from the noiseless run's
    quiet = teng.UnpackedEngine(N, N_BLOCKS, TNoise())
    clean = quiet.zero_state(64, "cpu")
    for b in range(N_BLOCKS):
        clean = quiet.run_block_circuit(clean, arrays, b)
    assert not torch.equal(clean.r, ut.r)


def test_noisy_transversal_channels_are_sound():
    # the transversal channels draw differently in the two engines, as in
    # the reference; each must leave x and z as the noiseless layers do,
    # flip signs only, and flip some
    for cls in (teng.UnpackedEngine, teng.PackedEngine):
        outs = []
        for noise in (TNoise(p_gate1=0.3, p_gate2=0.3), TNoise()):
            eng = cls(N, N_BLOCKS, noise)
            t = eng.zero_state(512, "cpu")
            g = torch.Generator().manual_seed(1)
            t = eng.transversal_1q(t, "H", 0, g)
            t = eng.transversal_cnot(t, 0, 1, g)
            t = eng.transversal_cz(t, 1, 0, g)
            if noise.p_gate1:
                t = eng.depolarize_block(t, 1, (0.1, 0.0, 0.0), g)
            outs.append(t)
        noisy, clean = outs
        assert torch.equal(noisy.x, clean.x) and torch.equal(noisy.z, clean.z)
        assert 0.05 < float((noisy.r != clean.r).float().mean()) < 0.5


def test_frame_engine_not_ported():
    # The frame engine is ported (tests/test_torch_ftqc_frames.py holds it
    # against the reference's); `make_engine` builds it as the reference's
    # does, and still refuses an unknown kind.
    eng = teng.make_engine("frames", N, N_BLOCKS, TNoise())
    assert isinstance(eng, teng.FrameEngine)
    assert (eng.n, eng.n_blocks, eng.stride) == (N, N_BLOCKS, N)
    with pytest.raises(ValueError):
        teng.make_engine("nope", N, N_BLOCKS, TNoise())
