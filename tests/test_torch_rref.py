"""The port's batched GF(2) RREF and profiling utilities.

* `gf2_torch.rref_batched` must be bit-identical to the JAX package's
  `gf2_jax.rref_batched` and, matrix by matrix, to the host `ops.gf2.rref`
  (wide, tall and rank-deficient batches drawn with numpy);
* `rref_bench.run` reports the reference bench's keys;
* `utils.profiling.trace` is a no-op without a directory and writes a
  Chrome trace into one (`Throughput` is the reference's text:
  tests/test_torch_import.py).
"""

import json

import numpy as np
import pytest
import torch

from qcss_tpu.ops import gf2_jax
from qcss_tpu_torch.benchmarks import rref_bench
from qcss_tpu_torch.ops import gf2, gf2_torch
from qcss_tpu_torch.utils.profiling import Throughput, trace


def _batch(shape, seed, rank_deficient=False):
    rng = np.random.default_rng(seed)
    mats = rng.integers(0, 2, size=shape, dtype=np.uint8)
    if rank_deficient:
        # the last rows are sums of the first ones, and a column is zero
        m = shape[1]
        mats[:, m // 2:] = mats[:, : m - m // 2] ^ mats[:, 1: m - m // 2 + 1]
        mats[:, :, 2] = 0
    return mats


@pytest.mark.parametrize("shape,deficient", [((24, 5, 11), False),
                                             ((24, 11, 5), False),
                                             ((24, 8, 8), True)],
                         ids=["wide", "tall", "rank-deficient"])
def test_rref_batched_equals_jax_and_host(shape, deficient):
    mats = _batch(shape, seed=shape[1], rank_deficient=deficient)
    got = gf2_torch.rref_batched(torch.as_tensor(mats))
    assert got.dtype == torch.uint8 and tuple(got.shape) == shape
    got = got.numpy()
    np.testing.assert_array_equal(got, np.asarray(gf2_jax.rref_batched(mats)))
    np.testing.assert_array_equal(got, np.stack([gf2.rref(x) for x in mats]))
    if deficient:
        assert (got.any(axis=2).sum(axis=1) < shape[1]).all()


def test_rref_bench_row():
    row = rref_bench.run(batch=8, shape=(4, 8), device="cpu", reps=1)
    assert row["metric"] == "gf2_rref_batched" and row["shape"] == [4, 8]
    assert row["value"] > 0 and row["reductions_per_sec"] > 0
    json.dumps(row)


def test_trace_none_is_a_no_op(tmp_path):
    with trace(None):
        x = torch.ones(3) + 1
    assert float(x.sum()) == 6.0
    assert list(tmp_path.iterdir()) == []


def test_trace_writes_a_chrome_trace(tmp_path):
    meter = Throughput()
    with trace(str(tmp_path / "tr")), meter.measure(n_samples=4):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "tr").iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    assert "traceEvents" in json.loads(files[0].read_text())
    assert meter.total_samples == 4 and meter.samples_per_sec > 0
