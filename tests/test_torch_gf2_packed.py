"""The port's packed GF(2) tier against the JAX package's.

* The bit helpers of `gf2_torch` (`pack_bits`, `unpack_bits`,
  `popcount32`, `parity32`, `bits_to_index`, `syndromes_packed`) equal
  `gf2_jax`'s on the same inputs: exact.
* The plain versions of the three packed kernels (`cuda_gf2.*_plain`,
  what a CPU tensor runs and what the card's kernels are held to) equal
  the JAX Pallas kernels run in interpret mode, as tests/test_pallas.py
  runs them: exact, on words with bit 31 set.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcss_tpu.codes import families as jfam
from qcss_tpu.ops import gf2, gf2_jax, pallas_gf2
from qcss_tpu_torch.ops import cuda_gf2, gf2_torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The suite runs in several worker processes at once; torch's intra-op
    # threads would oversubscribe the cores and spin, and these tensors are
    # small enough that one thread is fastest anyway.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t32(words: np.ndarray) -> torch.Tensor:
    """uint32 words -> int32 tensor of the same bit patterns."""
    return torch.from_numpy(np.array(words, np.uint32, order="C").view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.int64).astype(np.uint32)


@jax.jit
def _jax_helpers(bits, words, idx_bits):
    packed = gf2_jax.pack_bits(bits)
    return (packed, gf2_jax.unpack_bits(packed, bits.shape[-1]),
            gf2_jax.popcount32(words), gf2_jax.parity32(words),
            gf2_jax.bits_to_index(idx_bits))


def test_bit_helpers_match_gf2_jax():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (64, 70), dtype=np.uint8)
    bits[:, 31] = 1  # bit 31 of word 0 set in every row
    words = rng.integers(0, 1 << 32, (256,), dtype=np.uint32)
    words[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    idx_bits = rng.integers(0, 2, (128, 11), dtype=np.uint8)
    want, unpacked, pop, par, idx = map(np.asarray, _jax_helpers(
        bits, words, idx_bits))
    packed = gf2_torch.pack_bits(bits)
    np.testing.assert_array_equal(packed.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(
        gf2_torch.unpack_bits(packed, 70).numpy(), unpacked)
    np.testing.assert_array_equal(_u32(gf2_torch.words32(packed)), want)
    for t in (torch.from_numpy(words.astype(np.int64)), _t32(words)):
        np.testing.assert_array_equal(gf2_torch.popcount32(t).numpy(), pop)
        np.testing.assert_array_equal(gf2_torch.parity32(t).numpy(), par)
    got = gf2_torch.bits_to_index(torch.from_numpy(idx_bits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), idx)


def _inputs(n, r, B=1024):
    """Random [B, W] error words (all 32 bits random, so bit 31 is set in
    about half) and a packed [r, W] check matrix with column 31 set."""
    rng = np.random.default_rng(n * 100 + r)
    h = rng.integers(0, 2, size=(r, n), dtype=np.uint8)
    if n > 31:
        h[:, 31] = 1
    w = gf2_jax.packed_width(n)
    e = rng.integers(0, 1 << 32, size=(B, w), dtype=np.uint32)
    return e, np.asarray(gf2_jax.pack_bits(h))


@pytest.mark.parametrize("n,r", [(7, 3), (33, 10), (121, 60)])
def test_plain_kernels_match_pallas_interpret(n, r):
    e, hp = _inputs(n, r)
    ej, hj = jnp.asarray(e), jnp.asarray(hp)
    want = np.asarray(pallas_gf2.syndromes_packed_pallas(ej, hj))
    np.testing.assert_array_equal(
        want, np.asarray(gf2_jax.syndromes_packed(ej, hj)))
    got = cuda_gf2.syndromes_packed_plain(_t32(e), _t32(hp))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    # the dispatching function sends a CPU tensor to the plain version
    assert torch.equal(cuda_gf2.syndromes_packed(_t32(e), _t32(hp)), got)
    if r <= 32:
        want_t = np.asarray(pallas_gf2.syndromes_packed_pallas_t(
            jnp.asarray(np.ascontiguousarray(e.T)), hj, tile_b=e.shape[0]))
    else:
        # K7's interpret run unrolls its R x W word loop at trace time
        # (several seconds at R=60), so here its reference is the K6
        # interpret output above, packed as K7 packs it (bit r % 32 of
        # word r // 32)
        want_t = np.asarray(gf2_jax.pack_bits(want)).T
    got_t = cuda_gf2.syndromes_packed_t(_t32(e.T), _t32(hp))
    assert got_t.dtype == torch.int32
    assert got_t.shape == ((r + 31) // 32, e.shape[0])
    np.testing.assert_array_equal(_u32(got_t), want_t)


@pytest.fixture(scope="module")
def lut_codes():
    return {"steane": jfam.steane(), "golay": jfam.golay()}


@pytest.mark.parametrize("name", ["steane", "golay"])
def test_plain_residual_decode_matches_pallas_interpret(lut_codes, name):
    code = lut_codes[name]
    h = code.parity_check_c2
    lut = gf2.correction_lut(h, code.c2_syndromes)
    rng = np.random.default_rng(len(name))
    e = rng.integers(0, 1 << 32, size=(1024, 1), dtype=np.uint32)
    hp = np.asarray(gf2_jax.pack_bits(h))
    lp = np.asarray(gf2_jax.pack_bits(lut))
    assert lp.shape == (1 << h.shape[0], 1)
    want = np.asarray(pallas_gf2.decode_residual_packed_pallas(
        jnp.asarray(e), jnp.asarray(hp), jnp.asarray(lp)))
    got = cuda_gf2.decode_residual_packed(_t32(e), _t32(hp), _t32(lp))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_u32(got), want)


def test_kernel_wrappers_refuse_cpu_tensors():
    e, hp = _inputs(7, 3, B=8)
    lp = np.zeros((8, 1), np.uint32)
    before = dict(cuda_gf2.launches)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_gf2.syndromes_packed_cuda(_t32(e), _t32(hp))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_gf2.syndromes_packed_t_cuda(_t32(e.T), _t32(hp))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_gf2.decode_residual_packed_cuda(_t32(e), _t32(hp), _t32(lp))
    assert cuda_gf2.launches == before
