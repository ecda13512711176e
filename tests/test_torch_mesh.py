"""The port's device mesh and sharded pipelines (`qcss_tpu_torch.parallel`)
on a mesh of two CPU devices.

Shard i of a pipeline at ``seed`` runs the port's unsharded body with the
local batch at `shard_seed(seed, i)`. So each pipeline is held, bit for
bit, against its shards' runs through the port's public entry points
(`logical_error_rate`, `EncodedProgram.run`, `memory_experiment`,
`bp_phenomenological_error_rate`, `qldpc_memory_experiment`,
`soft_device_memory_rate`, `distill_circuit`,
`schedule_memory_device`, `_device_two_level`, `mld_logical_error_rate`,
`parallel_window_memory_rate`), which their own tests hold against the
JAX package. The sparse and hybrid fused decoders have no unsharded
entry point: they are held against their shards' bodies bit for bit and
against `memory_experiment(decoder='device-dem')` on the same shots
(two-sample 99.9%). Besides:

* `make_mesh` refuses too many devices and, without `devices=`, a
  machine without a card;
* `sharded_ftqc_run` on a mesh of two distinct devices ("cpu" and
  "cpu:0") builds the program again on the second, from
  `EncodedProgram.SETTINGS`, and leaves the caller's program untouched;
* the quiet magic factory's acceptance lies in the exact map's 99.9%
  interval;
* `sharded_mc_step`'s rate agrees with the JAX package's
  `sharded_mc_step` on its eight virtual CPU devices (two-sample 99.9%),
  and `sharded_qldpc_circuit_memory`'s with the JAX package's.
"""

import inspect
import math

import jax
import numpy as np
import pytest
import torch

from qcss_tpu.codes import families as jfam
from qcss_tpu.parallel import make_mesh as jmake_mesh
from qcss_tpu.parallel import sharded_mc_step as jsharded_mc_step
from qcss_tpu.parallel import (
    sharded_qldpc_circuit_memory as jsharded_qldpc_circuit_memory,
)
from qcss_tpu.sim.noise import NoiseModel as JNoiseModel
from qcss_tpu_torch import parallel as par
from qcss_tpu_torch.circuits import Program
from qcss_tpu_torch.codes import families as tfam
from qcss_tpu_torch.decode.bp import bp_phenomenological_error_rate
from qcss_tpu_torch.decode.mld import mld_logical_error_rate
from qcss_tpu_torch.decode.montecarlo import logical_error_rate
from qcss_tpu_torch.decode.parallel_window import (
    parallel_window_memory_rate,
)
from qcss_tpu_torch.experiments import concatenated
from qcss_tpu_torch.experiments.logical import LogicalProgram
from qcss_tpu_torch.experiments.memory import memory_experiment
from qcss_tpu_torch.experiments.memory_qldpc import qldpc_memory_experiment
from qcss_tpu_torch.experiments.patches import schedule_memory_device
from qcss_tpu_torch.experiments.soft import soft_device_memory_rate
from qcss_tpu_torch.ftqc import magic, rewrite_program
from qcss_tpu_torch.ftqc.rewrite import EncodedProgram
from qcss_tpu_torch.parallel import mesh as pm
from qcss_tpu_torch.sim.noise import NoiseModel

Z999 = 3.2905
SEED = 5
SEEDS = (pm.shard_seed(SEED, 0), pm.shard_seed(SEED, 1))
CPU = torch.device("cpu")
NOISE = NoiseModel(p_gate2=3e-3, p_meas=1e-2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # several worker processes run at once; see test_torch_device_uf.py
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    return par.make_mesh(devices=["cpu", "cpu"])


@pytest.fixture(scope="module")
def steane():
    return tfam.steane()


@pytest.fixture(scope="module")
def surface3():
    return tfam.rotated_surface(3)


def _two_sample_ok(k1, n1, k2, n2):
    pooled = (k1 + k2) / (n1 + n2)
    spread = Z999 * math.sqrt(pooled * (1 - pooled) * (1 / n1 + 1 / n2))
    return abs(k1 / n1 - k2 / n2) <= spread


def _count(rate, n):
    return round(rate * n)


# -- make_mesh ----------------------------------------------------------------


def test_make_mesh_shape_and_refusals():
    mesh = par.make_mesh(devices=["cpu", "cpu", "cpu"])
    assert mesh.size == 3 and mesh.shape == {"data": 3}
    assert par.make_mesh(2, devices=["cpu"] * 3).size == 2
    with pytest.raises(ValueError, match="requested a 4-device mesh but "
                       "only 3 device"):
        par.make_mesh(4, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="not divisible by mesh size 3"):
        par.sharded_mc_step(tfam.steane(), mesh, 0, 1024, 0.01)


def test_make_mesh_needs_a_card_unless_devices_are_named():
    if torch.cuda.is_available():
        pytest.skip("a card is present, so make_mesh() takes it")
    with pytest.raises(RuntimeError, match="CUDA"):
        par.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        par.make_mesh(devices=["cuda:0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        par.sharded_logical_error_rate(tfam.steane(), 0.01, samples=64,
                                       batch=64)


# -- every pipeline against its shards' unsharded runs ---------------------------


def test_mc_step_equals_shards(mesh, steane):
    counts = par.sharded_mc_step(steane, mesh, SEED, 2048, 0.05)
    want = [logical_error_rate(steane, 0.05, samples=1024, batch=1024,
                               seed=s, device="cpu") for s in SEEDS]
    for k in ("x_fail", "z_fail", "word_fail"):
        assert counts[k].shape == () and counts[k].device == CPU
        assert int(counts[k]) == sum(_count(w[k], 1024) for w in want), k
    assert int(counts["word_fail"]) > 0


def test_logical_error_rate_equals_rounds_of_shards(mesh, steane):
    got = par.sharded_logical_error_rate(steane, 0.05, mesh=mesh,
                                         samples=3000, batch=1025, seed=2)
    assert got["samples"] == 3 * 1024
    want = {"x_fail": 0, "z_fail": 0, "word_fail": 0}
    for r in range(3):
        counts = par.sharded_mc_step(steane, mesh, pm.shard_seed(2, r),
                                     1024, 0.05)
        for k in want:
            want[k] += int(counts[k])
    assert got == {**{k: v / 3072 for k, v in want.items()},
                   "samples": 3072}


FTQC_CASES = pytest.mark.parametrize("engine,tableau,noise", [
    ("scheduled", "packed", NoiseModel()),
    ("scheduled", "frames", NoiseModel(p_gate1=0.02, p_gate2=0.02)),
    ("unrolled", "unpacked", NoiseModel(p_meas=0.02, p_reset=0.02))],
    ids=["packed", "frames", "unrolled"])


def _x_program(steane, engine, tableau, noise):
    prog = Program()
    ro = prog.declare("ro", 1)
    prog.x(0).measure(0, ro[0])
    return rewrite_program(prog, steane, engine=engine, tableau=tableau,
                           noise=noise, device="cpu")


def _equal_to_runs(out, enc):
    want = [enc.run(8, s) for s in SEEDS]
    assert set(out) == set(want[0]) == {"ro", "__prep_fail__"}
    for k in out:
        assert out[k].shape[0] == 16
        np.testing.assert_array_equal(
            out[k].numpy(), np.concatenate([w[k] for w in want]))
    assert out["ro"].sum() > 8


@FTQC_CASES
def test_ftqc_run_equals_shards(mesh, steane, engine, tableau, noise):
    enc = _x_program(steane, engine, tableau, noise)
    _equal_to_runs(par.sharded_ftqc_run(enc, mesh, 16, SEED), enc)


@FTQC_CASES
def test_ftqc_run_builds_the_program_on_another_device(steane, engine,
                                                       tableau, noise):
    """Shard 1 runs on "cpu:0", a device other than the program's "cpu":
    `sharded_ftqc_run` builds `enc.on("cpu:0")` for it, for this call,
    and the caller's program keeps its attributes."""
    init = inspect.signature(EncodedProgram.__init__).parameters
    assert tuple(init)[3:-1] == EncodedProgram.SETTINGS
    enc = _x_program(steane, engine, tableau, noise)
    before = set(vars(enc))
    other = enc.on("cpu:0")
    assert other is not enc and str(other.device) == "cpu:0"
    for k in EncodedProgram.SETTINGS:
        assert getattr(other, k) == getattr(enc, k), k
    two = par.make_mesh(devices=["cpu", "cpu:0"])
    _equal_to_runs(par.sharded_ftqc_run(enc, two, 16, SEED), enc)
    assert set(vars(enc)) == before


def test_frame_memory_sample_and_host_decode_equal_shards(mesh, surface3):
    sfm = par.ShardedFrameMemory(surface3, NOISE, mesh)
    syns, word = sfm.sample(SEED, 1024, 3)
    assert syns.shape == (3, 1024, 4) and word.shape == (1024, 9)
    for i, s in enumerate(SEEDS):
        ws, ww = sfm._sampler(CPU, s, 512, 3)(sfm._extract, 4)
        assert torch.equal(syns[:, 512 * i:512 * (i + 1)], ws)
        assert torch.equal(word[512 * i:512 * (i + 1)], ww)
    for decoder in ("uf", "dem"):
        got = sfm.error_rate(rounds=3, batch=1024, seed=SEED,
                             decoder=decoder)
        want = [memory_experiment(surface3, rounds=3, noise=NOISE,
                                  batch=512, seed=s, decoder=decoder,
                                  engine="frames", device="cpu")
                for s in SEEDS]
        for k in ("logical_fail", "residual_syndrome"):
            assert _count(got[k], 1024) == sum(_count(w[k], 512)
                                               for w in want), (decoder, k)


@pytest.mark.parametrize("decoder", ["dense", "sparse", "hybrid"])
def test_frame_memory_fused_equals_shards(mesh, surface3, decoder):
    noise = NoiseModel(p_gate2=1e-2, p_meas=2e-2)
    sfm = par.ShardedFrameMemory(surface3, noise, mesh)
    got = sfm.fused_error_rate(rounds=3, batch=1024, seed=SEED,
                               decoder=decoder)
    assert got["decoder"] == "device-dem"
    shards = [sfm.fused_shard(CPU, s, 512, 3, "dem", decoder) for s in SEEDS]
    assert all(bool(c) for _, c in shards)
    fails = sum(int(f) for f, _ in shards)
    assert _count(got["logical_fail"], 1024) == fails
    # the dense decoder's entry point on the same shots: equal for
    # 'dense', within two-sample 99.9% for the sparse kernel's decoders
    want = sum(_count(memory_experiment(
        surface3, rounds=3, noise=noise, batch=512, seed=s,
        decoder="device-dem", engine="frames",
        device="cpu")["logical_fail"], 512) for s in SEEDS)
    if decoder == "dense":
        assert fails == want
    assert _two_sample_ok(fails, 1024, want, 1024), (fails, want)
    assert fails > 0


def test_bp_memory_equals_shards(mesh, surface3):
    got = par.sharded_bp_memory(surface3, mesh, rounds=3, p=1e-2, q=1e-2,
                                batch=512, seed=SEED, iters=16)
    assert got["decoder"] == "device-bp"
    want = [bp_phenomenological_error_rate(
        surface3, 3, 1e-2, 1e-2, batch=256, seed=s, iters=16, osd=False,
        device="cpu") for s in SEEDS]
    assert _count(got["x_fail"], 512) == sum(_count(w["x_fail"], 256)
                                             for w in want) > 0
    assert _count(got["bp_unconverged"], 512) == sum(
        _count(1 - w["bp_converged"], 256) for w in want)


def test_soft_memory_equals_shards(mesh, surface3):
    got = par.sharded_soft_memory(surface3, mesh, rounds=3, p=2e-2,
                                  sigma=0.7, batch=512, seed=SEED)
    assert got["decoder"] == "device-uf-soft"
    # soft_device_memory_rate's rep i draws from chunk i of the seed: the
    # same generators as shard i
    want = soft_device_memory_rate(surface3, 2e-2, 0.7, rounds=3, batch=256,
                                   reps=2, seed=SEED, device="cpu")
    assert got["logical_fail"] == want["logical_fail"] > 0
    assert got["samples"] == want["samples"] == 512


def test_qldpc_circuit_memory_equals_shards(mesh, surface3):
    noise = NoiseModel(p_gate2=1e-2, p_meas=1e-2)
    got = par.sharded_qldpc_circuit_memory(surface3, mesh, rounds=2,
                                           noise=noise, batch=256, seed=SEED,
                                           iters=16)
    assert got["decoder"] == "device-circuit-bp"
    want = [qldpc_memory_experiment(surface3, rounds=2, noise=noise,
                                    batch=128, seed=s, iters=16, osd=False,
                                    sectors="z", device="cpu")
            for s in SEEDS]
    assert _count(got["x_fail"], 256) == sum(
        _count(w["x_fail"], 128) for w in want) > 0
    assert _count(got["bp_unconverged"], 256) == sum(
        _count(1 - w["bp_converged_z"], 128) for w in want)


def test_magic_factory_equals_shards(mesh):
    noisy = NoiseModel(p_gate1=1e-3, p_gate2=1e-3, p_meas=1e-3,
                       p_reset=1e-3)
    got = par.sharded_magic_factory(mesh, noisy, 0.03, 2048, seed=SEED)
    want = [magic.distill_circuit(noisy, 0.03, 1024, seed=s, device="cpu")
            for s in SEEDS]
    assert got["accepted"] == sum(w["accepted"] for w in want)
    assert _count(got["p_out"], got["accepted"]) == sum(
        _count(w["p_out"], w["accepted"]) for w in want) > 0


def test_magic_factory_quiet_against_the_exact_map(mesh):
    b = 1 << 13
    got = par.sharded_magic_factory(mesh, NoiseModel(), 0.03, b, seed=1)
    exact = magic.distill_exact(0.03)["p_accept"]
    assert abs(got["p_accept"] - exact) <= Z999 * math.sqrt(
        exact * (1 - exact) / b)
    assert got["p_out"] < 0.01


def test_logical_program_equals_shards(mesh):
    model = LogicalProgram(3, 2).cnot(0, 1).build()
    got = par.sharded_logical_program(model, mesh, p=3e-3, batch=512,
                                      seed=SEED)
    # schedule_memory_device's rep i draws from chunk i of the seed: the
    # same generators as shard i
    want = schedule_memory_device(model, 3e-3, batch=256, reps=2, seed=SEED,
                                  device="cpu")
    assert got["word_fail"] == want["word_fail"] > 0
    for i, name in enumerate(model.meta["obs_names"]):
        assert got[f"{name}_fail"] == want[f"obs{i}_fail"], name
    assert got["devices"] == 2 and got["samples"] == want["samples"]
    quiet = par.sharded_logical_program(model, mesh, p=1e-9, batch=128,
                                        seed=1)
    assert quiet["word_fail"] == 0.0


def test_two_level_memory_equals_shards(mesh):
    got = par.sharded_two_level_memory(3, 2, 1, mesh, p=4e-3, batch=512,
                                       seed=SEED)
    # `_device_two_level`'s rep i draws from chunk i of the seed: the same
    # generators as shard i
    want = concatenated._device_two_level(3, 2, 1, 4e-3, None, batch=256,
                                          seed=SEED, reps=2, device="cpu")
    for k in ("word_fail_l1", "word_fail_l2", "grid_qubits", "samples"):
        assert got[k] == want[k], k
    assert got["word_fail_l1"] > 0


def test_mld_memory_equals_shards(mesh, steane):
    got = par.sharded_mld_memory(steane, mesh, p=0.05, batch=2048,
                                 seed=SEED)
    want = sum(_count(mld_logical_error_rate(
        steane, 0.05, batch=1024, seed=s, device="cpu")["word_fail_ml"],
        1024) for s in SEEDS)
    assert _count(got["word_fail"], 2048) == want > 0


def test_parallel_window_memory_equals_shards(mesh, surface3):
    kw = dict(rounds=12, core=3, buf=3)
    got = par.sharded_parallel_window_memory(surface3, mesh, p=1e-2, q=1e-2,
                                             batch=256, seed=SEED, **kw)
    want = sum(_count(parallel_window_memory_rate(
        surface3.raw_parity_check_c2, surface3.z_operator_matrix(), 1e-2,
        1e-2, batch=128, seed=s, device="cpu", **kw)["logical_fail"], 128)
        for s in SEEDS)
    assert _count(got["logical_fail"], 256) == want > 0
    with pytest.raises(ValueError, match="k=1 codes only"):
        par.sharded_parallel_window_memory(tfam.toric(3), mesh, p=1e-2,
                                           q=1e-2, batch=256, **kw)


# -- against the JAX package ------------------------------------------------------


def test_mc_step_rate_against_the_reference_mesh():
    jmesh = jmake_mesh()
    assert jmesh.devices.size == 8  # tests/conftest.py's virtual devices
    b = 8 * 1024
    want = jsharded_mc_step(jfam.steane(), jmesh, jax.random.key(0),
                            batch=b, p=0.05)
    got = par.sharded_mc_step(tfam.steane(), par.make_mesh(
        devices=["cpu"] * 8), 0, b, 0.05)
    for k in ("x_fail", "z_fail", "word_fail"):
        assert _two_sample_ok(int(got[k]), b, int(want[k]), b), k


def test_qldpc_circuit_memory_rate_against_the_reference_mesh():
    jmesh = jmake_mesh()
    b = 8 * 64
    kw = dict(rounds=2, batch=b, seed=3, iters=16)
    want = jsharded_qldpc_circuit_memory(
        jfam.rotated_surface(3), jmesh,
        noise=JNoiseModel(p_gate2=1e-2, p_meas=1e-2), **kw)
    got = par.sharded_qldpc_circuit_memory(
        tfam.rotated_surface(3), par.make_mesh(devices=["cpu"] * 8),
        noise=NoiseModel(p_gate2=1e-2, p_meas=1e-2), **kw)
    assert got["decoder"] == want["decoder"] == "device-circuit-bp"
    for k in ("x_fail", "bp_unconverged"):
        assert _two_sample_ok(_count(got[k], b), b, _count(want[k], b), b), k
    assert got["x_fail"] > 0
