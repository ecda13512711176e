"""The port's logical-program compiler (`qcss_tpu_torch.experiments.
logical`), its resource report and its protocol runner, against the JAX
package's, on the CPU.

The compiler is a copy (tests/test_torch_import.py), so its schedules
must equal the reference's array for array at d=3, weighted and
unweighted, `meta` and the outcome-space recipe included: that equality
is what lets the port inherit test_logical.py's tableau golds, which
are not re-run here at their size. The port's own tableau runs the
compiled CNOT's truth table and the feedback program's X sector with
every detector zero. The runners are held on the reference's own draws:
the fused decoders' counts (`run(decoder='device-uf' |
'device-uf-sparse')`) and both sectors of `run_full` equal the
reference's, draw for draw.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcss_tpu.experiments import logical as jl
from qcss_tpu.experiments import patches as jpatches
from qcss_tpu.experiments import resources as jres
from qcss_tpu_torch.experiments import logical as tl
from qcss_tpu_torch.experiments import patches as tpatches
from qcss_tpu_torch.experiments import resources as tres
from qcss_tpu_torch.experiments import surgery as tsg
from qcss_tpu_torch.experiments.protocol import run_compiled_protocol

CPU = torch.device("cpu")

# (patches, ops) of each program test_logical.py builds
PROGRAMS = {
    "cnot": (2, lambda p: p.cnot(0, 1)),
    "cnot02": (3, lambda p: p.cnot(0, 2)),
    "t": (1, lambda p: p.t(0)),
    "s": (1, lambda p: p.s(0)),
    "mzz": (2, lambda p: p.mzz(0, 1)),
    "mzz_layer": (4, lambda p: p.mzz_layer([(0, 1), (2, 3)])),
    "x_cnot": (2, lambda p: p.x(0).cnot(0, 1)),
    "hzh": (1, lambda p: p.h(0).z(0).h(0)),
    "feedback": (1, lambda p: p.mx(0).h(0).x_if(0, "mx0_0")),
    "three_ops": (3, lambda p: p.cnot(0, 1).t(1).cnot(1, 2)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # several worker processes run at once; see test_torch_device_uf.py
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


def _prog(mod, name, d=3):
    k, ops = PROGRAMS[name]
    return ops(mod.LogicalProgram(d, k))


def _same(a, b, where="model"):
    """Deep equality of the two packages' values: arrays exactly, the
    dataclasses (`Phase`, `Readout`) field by field."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for key in a:
            _same(a[key], b[key], f"{where}[{key!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name),
                  f"{where}.{f.name}")
    else:
        assert a == b, (where, a, b)


def _same_schedule(mt, mj):
    for attr in ("n", "n_phases", "F", "obs", "fault_probs_class"):
        _same(getattr(mt, attr), getattr(mj, attr), attr)
    for attr in ("num_nodes", "n_qubits", "edges", "edge_qubit",
                 "edge_obs", "edge_weight"):
        _same(getattr(mt.graph, attr), getattr(mj.graph, attr), attr)
    public = lambda meta: {k: v for k, v in meta.items()
                           if not k.startswith("_")}
    _same(public(mt.meta), public(mj.meta), "meta")


# weighting changes only the graph's edge weights: weighted on the
# programs of each kind of op, unweighted on every program
BUILDS = ([(name, False) for name in PROGRAMS]
          + [(name, True) for name in ("cnot", "t", "mzz", "feedback")])


@pytest.mark.parametrize("name,weighted", BUILDS)
def test_builds_bit_identical(name, weighted):
    """Both sectors' schedules with their recipes (F, obs, classes, the
    matching graph, every `meta` entry: obs_names, obs_expected,
    unscored, x_ops, frame_ops, op_log, the recipe's maps and orders)."""
    kw = dict(p=2e-3, q=3e-3) if weighted else {}
    pt, pj = _prog(tl, name), _prog(jl, name)
    _same_schedule(pt.build(with_recipe=True, **kw),
                   pj.build(with_recipe=True, **kw))
    _same_schedule(pt.build_x(with_recipe=True, **kw),
                   pj.build_x(with_recipe=True, **kw))


GUARDS = [
    ("frame terms", lambda L: L(3, 2).cnot(0, 1).h(1)),
    ("odd-H-parity", lambda L: L(3, 2).h(0).cnot(0, 1)),
    ("Z-basis", lambda L: L(3, 1).h(0).t(0)),
    ("no measured outcome", lambda L: L(3, 1).x_if(0, "nope")),
    ("sector", lambda L: L(3, 2).mx(1).x_if(0, "mx1_0").measure()),
    ("odd-H-parity", lambda L: L(3, 1).h(0).mz(0)),
    ("overlap", lambda L: L(3, 3).mzz_layer([(0, 1), (1, 2)])),
    ("use run_full", lambda L: L(3, 1).mx(0).h(0).run(1e-3)),
]


@pytest.mark.parametrize("match,make", GUARDS,
                         ids=[f"{i}-{m}" for i, (m, _) in enumerate(GUARDS)])
def test_guards_raise_the_same_errors(match, make):
    with pytest.raises(ValueError, match=match) as ej:
        make(jl.LogicalProgram)
    with pytest.raises(ValueError, match=match) as et:
        make(tl.LogicalProgram)
    assert str(et.value) == str(ej.value)


def _reference_draws(monkeypatch, seeds):
    """Replace the port's single-fault sampler by the reference's
    `patches._sample` on the same model tensors and rates, keyed by
    ``seeds`` in call order (the reference's key for each call)."""
    order = list(seeds)
    sample = jax.jit(jpatches._sample, static_argnames=("batch",))

    def replay(generator, p, q, batch, cls, f_t, obs_t, faults=None):
        dets, ob = sample(order.pop(0), jnp.float32(p), jnp.float32(q),
                          batch, jnp.asarray(cls.numpy()),
                          jnp.asarray(f_t.numpy().astype(np.int32)),
                          jnp.asarray(obs_t.numpy().astype(np.int32)))
        return (torch.from_numpy(np.array(dets, np.uint8)),
                torch.from_numpy(np.array(ob, np.uint8)))

    monkeypatch.setattr(tsg, "_sample", replay)
    monkeypatch.setattr(tpatches, "_sample", replay)
    return order


@pytest.mark.parametrize("decoder", ["device-uf", "device-uf-sparse"])
def test_fused_run_equals_reference_on_its_draws(monkeypatch, decoder):
    """The fused pipeline (`patches.schedule_memory_device`, the dense
    decoder or the hybrid with its sizing rule) on the reference
    runner's own draws — rep r from fold_in(key(seed), r) — counts what
    the reference's fused runner counts. At p=1e-2 the hybrid's rule
    sizes the sparse decoder at d_max 48 on this graph (V=384, 18.6 mean
    defects a shot); test_torch_patches.py holds its dense escape."""
    p, batch, reps, seed = 1e-2, 512, 2, 9
    key = jax.random.key(seed)
    order = _reference_draws(
        monkeypatch, [jax.random.fold_in(key, r) for r in range(reps)])
    ref = _prog(jl, "cnot").run(p, batch=batch, seed=seed, reps=reps,
                                decoder=decoder)
    got = _prog(tl, "cnot").run(p, batch=batch, seed=seed, reps=reps,
                                decoder=decoder, device=CPU)
    assert not order
    assert got == ref and ref["word_fail"] > 0


def test_fused_run_quiet_is_exact():
    prog = _prog(tl, "cnot")
    for decoder in ("device-uf", "device-uf-sparse"):
        out = prog.run(0.0, 0.0, batch=64, reps=2, decoder=decoder,
                       device=CPU)
        assert out["word_fail"] == 0.0 and out["samples"] == 128


def test_run_full_and_host_run_equal_reference_on_its_draws(monkeypatch):
    """`run_full` samples the Z sector from key(seed) and the X sector
    from key(seed + 7919) and composes them per shot; on the reference's
    draws the port's dict is the reference's, and so is the host
    `run`'s (the host union-find is one native code for both). The T
    gadget books channels in both sectors (m1, z0; OUT)."""
    name, p, batch, seed = "t", 6e-3, 1024, 4
    keys = [jax.random.key(seed), jax.random.key(seed + 7919),
            jax.random.key(seed)]
    order = _reference_draws(monkeypatch, keys)
    profile = {}
    got = _prog(tl, name).run_full(p, batch=batch, seed=seed, device=CPU,
                                   profile=profile)
    ref = _prog(jl, name).run_full(p, batch=batch, seed=seed)
    assert got == ref and ref["word_fail"] > 0
    assert set(profile) == {"build", "sample", "readback", "decode"}
    got = _prog(tl, name).run(p, batch=batch, seed=seed, device=CPU)
    ref = _prog(jl, name).run(p, batch=batch, seed=seed)
    assert got == ref and not order


def _xflip_qubits(prog, i):
    """X̄ support of data patch i (its block's first column)."""
    r0, c0 = prog._origin((0, 2 * i))
    return [(r0 + r) * prog.cols_q + c0 for r in range(prog.d)]


@pytest.mark.parametrize("zc,zt", [(1, 0), (1, 1)])
def test_protocol_cnot_truth_table(zc, zt):
    """test_logical.py::TestTableauGoldCnot on the port's tableau: every
    detector zero on a random measurement branch, z0 = zc and
    z1 = zt ⊕ zc."""
    prog = tl.LogicalProgram(3, 2).cnot(0, 1)
    model = prog.build(with_recipe=True)
    recipe = model.meta["recipe"]
    flips = ((_xflip_qubits(prog, 0) if zc else [])
             + (_xflip_qubits(prog, 1) if zt else []))
    gen = torch.Generator().manual_seed(131 + 2 * zc + zt)
    o = run_compiled_protocol(prog, model, gen, prep_x_flips=flips,
                              device=CPU).astype(np.int64)
    assert not ((recipe["D"].astype(np.int64) @ o) & 1).any()
    vals = (recipe["obs"].astype(np.int64) @ o) & 1
    got = dict(zip(model.meta["obs_names"], vals))
    assert got["z0"] == zc and got["z1"] == zt ^ zc


def test_protocol_feedback_program():
    """test_logical.py::TestTableauGoldFrameOps::test_feedback_gold on
    the port's tableau: the X-sector recipe's detectors are zero and z0
    is exactly 0 on every branch (the x_if cancels the mx coin)."""
    prog = tl.LogicalProgram(3, 1).mx(0).h(0).x_if(0, "mx0_0")
    model = prog.build(with_recipe=True)
    mx = prog.build_x(with_recipe=True)
    recipe_x = mx.meta["recipe"]
    for seed in (61, 62, 63):
        _, ox, pre = run_compiled_protocol(
            prog, model, torch.Generator().manual_seed(seed), x_model=mx,
            final_basis="x", device=CPU)
        ox = ox.astype(np.int64)
        assert not ((recipe_x["D"].astype(np.int64) @ ox) & 1).any()
        got = dict(zip(mx.meta["obs_names"],
                       (recipe_x["obs"].astype(np.int64) @ ox) & 1))
        assert got["z0"] == 0 and pre == []


def test_resources_equal():
    """`program_stats`, `fit_suppression`, `required_distance` and a
    report priced from given failure points (its program rebuilt at d*,
    3 for this target) equal the reference's."""
    assert (tres.program_stats(_prog(tl, "mzz"))
            == jres.program_stats(_prog(jl, "mzz")))
    fails = {3: 0.02, 5: 0.004}
    fit = tres.fit_suppression(fails)
    assert fit == jres.fit_suppression(fails)
    assert tres.required_distance(4e-3, fit) == \
        jres.required_distance(4e-3, fit) == 5
    factory = {"p_out": 1e-6, "injections_per_state": 15.0}
    kw = dict(target=2e-2, fails=fails, factory=factory)
    got = tres.logical_resource_report(
        lambda d: tl.LogicalProgram(d, 2).cnot(0, 1).t(1), 2e-3, **kw)
    ref = jres.logical_resource_report(
        lambda d: jl.LogicalProgram(d, 2).cnot(0, 1).t(1), 2e-3, **kw)
    assert got == ref and got["magic"]["t_count"] == 1
