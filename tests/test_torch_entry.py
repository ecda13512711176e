"""The port's entry points and demo.

* `entry()`'s forward equals the JAX package's `__graft_entry__.entry()`
  forward on the same args (the Steane decode's failure counts);
* `dryrun_multichip(2)` runs every sharded pipeline on two CPU devices,
  and never shrinks a mesh it cannot fill;
* the demo tour runs to its end on the CPU at a small batch.
"""

import importlib.util
from pathlib import Path

import jax
import pytest
import torch

from qcss_tpu_torch.entry import dryrun_multichip, entry
from qcss_tpu_torch.examples import demo

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # several worker processes run at once; see test_torch_device_uf.py
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_entry():
    spec = importlib.util.spec_from_file_location(
        "graft_entry", ROOT / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.entry


def test_entry_forward_equals_jax():
    fn_j, args_j = _jax_entry()()
    fn_t, args_t = entry(device="cpu")
    for a, b in zip(args_t, args_j):
        assert (a == b).all() and a.shape == (256, 7)
    want = {k: int(v) for k, v in jax.jit(fn_j)(*args_j).items()}
    got = fn_t(*args_t)
    assert all(v.dtype == torch.int32 and v.ndim == 0 for v in got.values())
    assert {k: int(v) for k, v in got.items()} == want
    assert want["word_fail"] > 0


def test_dryrun_multichip_on_two_cpu_devices():
    out = dryrun_multichip(2, devices=["cpu", "cpu"])
    assert out["sharded_ftqc_run"] == [1, 1]
    assert len(out) == 13
    with pytest.raises(ValueError, match="only 1 device"):
        dryrun_multichip(2, devices=["cpu"])


def test_demo_runs_to_its_end(capsys):
    demo.main(["--cpu", "--samples", "128", "--target", "2e-3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("code: CSSCode(n=7, k=1")
    assert lines[-1].startswith("resource report: Lambda 12.1, d* = 5 ->")
