"""The port's code-capacity Monte Carlo against the JAX package's.

* Deterministic stages are exact: the depolarizing thresholds (the
  reference's float32 arithmetic and saturating cap), the errors given
  the same raw 32-bit words, the failure flags given the same errors (the
  dense decode with and without flip tables, and the packed decode the
  Monte-Carlo steps run), and the majority vote.
* Sampled rates: the two packages draw from different generators, so the
  port's rate (at 4x the JAX sample count) must fall inside the 99.9%
  Wilson interval (z = 3.2905) of the JAX rate at the same settings.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcss_tpu.codes import families as jfam
from qcss_tpu.decode import montecarlo as jmc
from qcss_tpu.decode import multiround as jmr
from qcss_tpu_torch.codes import families as tfam
from qcss_tpu_torch.decode import montecarlo as tmc
from qcss_tpu_torch.decode import multiround as tmr
from qcss_tpu_torch.decode import sweep as tsw

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


@pytest.fixture(scope="module")
def steane():
    return jfam.steane(), tfam.steane()


def _wilson(k, n, z=Z999):
    p = k / n
    den = 1 + z * z / n
    mid = (p + z * z / (2 * n)) / den
    half = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / den
    return mid - half, mid + half


@pytest.mark.parametrize("p", [0.0, 0.01, 0.75, 1.0])
def test_depolarizing_thresholds_identical(p, monkeypatch):
    # Words on both sides of each of the port's thresholds, fed to the
    # reference's sampler in place of its random bits: the errors agree
    # only if the thresholds do. At p=1 the reference caps t3 at 2^32-1,
    # so u = 2^32-1 must not fire.
    ts = tmc.depolarizing_thresholds(p)
    cand = {0, 1, (1 << 32) - 1, (1 << 31) - 1, 1 << 31}
    for t in ts:
        cand |= {t - 1, t, t + 1}
    words = np.array(sorted(c for c in cand if 0 <= c < 1 << 32),
                     np.uint32)[None, :]
    monkeypatch.setattr(jmc.jax.random, "bits",
                        lambda key, shape, dtype: jnp.asarray(words))
    xj, zj = jmc.sample_depolarizing(jax.random.key(0), 1, words.shape[1], p)
    xt, zt = tmc.depolarizing_from_words(
        torch.from_numpy(words.astype(np.int64)), p)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
    if p == 1.0:
        assert ts[2] == (1 << 32) - 1


def test_errors_and_decode_failures_identical(steane):
    # the same raw words give the same errors; the same errors give the
    # same flags through the dense decode (with and without flip tables)
    # and through the packed decode the Monte-Carlo steps run
    cj, ct = steane
    dj, dt = cj.device, ct.device
    key = jax.random.key(1)
    xj, zj = jmc.sample_depolarizing(key, 4096, 7, 0.1)
    words = np.asarray(jax.random.bits(key, (4096, 7), dtype=jnp.uint32))
    x, z = tmc.depolarizing_from_words(
        torch.from_numpy(words.astype(np.int64)), 0.1)
    np.testing.assert_array_equal(x.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(z.numpy(), np.asarray(zj))
    want = jax.jit(jmc.decode_failures)(
        xj, zj, dj.h1, dj.h2, dj.lut_c1, dj.lut_c2, dj.logical_x,
        dj.logical_z, dj.flip_z_of_lut_c2, dj.flip_x_of_lut_c1)
    args = (dt.h1, dt.h2, dt.lut_c1, dt.lut_c2, dt.logical_x, dt.logical_z)
    got = {
        "flip tables": tmc.decode_failures(
            x, z, *args, dt.flip_z_of_lut_c2, dt.flip_x_of_lut_c1),
        "correction gather": tmc.decode_failures(x, z, *args),
        "packed": tmc.decode_failures_packed(
            x, z, *tmc.packed_sectors(ct, "cpu")),
    }
    assert int(np.asarray(want["word_fail"]).sum()) > 0
    for route, flags in got.items():
        for k in ("x_fail", "z_fail", "word_fail"):
            np.testing.assert_array_equal(flags[k].numpy(),
                                          np.asarray(want[k]), err_msg=route)


def test_mc_step_counts_its_own_errors(steane):
    # mc_decode_step draws with the generator, then decodes packed: its
    # counts equal the dense decode (identical to the reference's, above)
    # of the same errors.
    ct = steane[1]
    dt = ct.device
    counts = tmc.mc_decode_step(ct, torch.Generator().manual_seed(9), 2048,
                                0.08)
    x, z = tmc.sample_depolarizing(torch.Generator().manual_seed(9), 2048, 7,
                                   0.08)
    want = tmc.decode_failures(x, z, dt.h1, dt.h2, dt.lut_c1, dt.lut_c2,
                               dt.logical_x, dt.logical_z)
    for k in ("x_fail", "z_fail", "word_fail"):
        assert int(counts[k]) == int(want[k].sum()) > 0


def test_logical_error_rate_zero_and_within_wilson(steane):
    cj, ct = steane
    zero = tmc.logical_error_rate(ct, 0.0, samples=1 << 12, batch=1 << 12,
                                  device="cpu")
    assert zero["word_fail"] == 0.0 and zero["samples"] == 1 << 12
    nj, nt = 1 << 14, 1 << 16
    rj = jmc.logical_error_rate(cj, 0.05, samples=nj, batch=nj, seed=2)
    rt = tmc.logical_error_rate(ct, 0.05, samples=nt, batch=nt // 2, seed=2,
                                device="cpu")
    assert rt["samples"] == nt
    for k in ("x_fail", "z_fail", "word_fail"):
        lo, hi = _wilson(round(rj[k] * nj), nj)
        assert lo <= rt[k] <= hi, (k, rj[k], rt[k], lo, hi)


def test_vote_syndromes_identical():
    rng = np.random.default_rng(4)
    syns = rng.integers(0, 2, (5, 512, 6), dtype=np.uint8)
    np.testing.assert_array_equal(
        tmr.vote_syndromes(torch.from_numpy(syns)).numpy(),
        np.asarray(jmr.vote_syndromes(jnp.asarray(syns))))
    with pytest.raises(ValueError):
        tmr.vote_syndromes(torch.from_numpy(syns[:4]))


def test_multiround_error_rate_within_wilson(steane):
    cj, ct = steane
    nj, nt = 1 << 13, 1 << 15
    rj = jmr.multiround_error_rate(cj, 0.03, 0.03, samples=nj, batch=nj,
                                   seed=5)
    rt = tmr.multiround_error_rate(ct, 0.03, 0.03, samples=nt, batch=nt,
                                   seed=5, device="cpu")
    lo, hi = _wilson(round(rj["word_fail"] * nj), nj)
    assert 0 < rt["word_fail"] and lo <= rt["word_fail"] <= hi, (
        rj["word_fail"], rt["word_fail"], lo, hi)


def test_error_rate_curve_resumes_from_checkpoint(steane, tmp_path,
                                                  monkeypatch):
    ct = steane[1]
    path = str(tmp_path / "curve.jsonl")
    kw = dict(samples_per_point=1 << 10, batch=1 << 10, device="cpu",
              checkpoint_path=path)
    first = tsw.error_rate_curve(ct, [0.02, 0.05], **kw)
    with open(path) as f:
        assert [json.loads(line) for line in f] == first

    def recompute(*args, **kwargs):
        raise AssertionError("a checkpointed point was recomputed")

    monkeypatch.setattr(tsw, "logical_error_rate", recompute)
    assert tsw.error_rate_curve(ct, [0.02, 0.05], **kw) == first
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsw.error_rate_curve(ct, [0.02], mesh=object(), device="cpu")


def test_entry_points_default_to_the_card(steane):
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmc.logical_error_rate(steane[1], 0.01, samples=64, batch=64)
