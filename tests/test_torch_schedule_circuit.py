"""The port's circuit-level schedule tier (`qcss_tpu_torch.experiments.
schedule_circuit`) against the JAX package's, on the CPU.

The enumerator is a copy (tests/test_torch_import.py): the circuit
models of the compiled programs must equal the reference's (F, priors,
obs, every booked fault signature, the sampling plan). The sampler is
the port's own, over the frame engine's matrix form: given the bits of
one fault, every enumerated fault of every class must come out as
exactly its variable's F and obs columns (test_schedule_circuit.py's
differential, with the port's sampler as the injector), and a quiet run
as zero. Rates are held against the reference's sampler by two-sample
99.9% tests on a model the init repair does not touch.
"""

import math

import jax
import numpy as np
import pytest
import torch

from qcss_tpu.experiments import logical as jl
from qcss_tpu.experiments import schedule_circuit as jsc
from qcss_tpu.sim.noise import NoiseModel as JNoise
from qcss_tpu_torch.decode.bp import BPDecoder
from qcss_tpu_torch.experiments import logical as tl
from qcss_tpu_torch.experiments import schedule_circuit as tsc
from qcss_tpu_torch.sim.noise import NoiseModel

Z999 = 3.2905
CPU = torch.device("cpu")
RATES = dict(p_gate1=1e-3, p_gate2=1e-3, p_meas=1e-3, p_reset=1e-3)

MODELS = {
    "cnot": lambda L, N: L(3, 2).cnot(0, 1).build_circuit(N),
    "mzz": lambda L, N: L(3, 2).mzz(0, 1).build_circuit(N),
    # h(0); idle; h(0): a rotated middle phase
    "hih": lambda L, N: L(3, 1).h(0).idle().h(0).build_circuit(N),
    "t_z": lambda L, N: L(3, 1).t(0).build_circuit(N),
    "t_x": lambda L, N: L(3, 1).t(0).build_circuit_x(N),
    "feedback_x": lambda L, N: L(3, 1).mx(0).h(0).x_if(
        0, "mx0_0").build_circuit_x(N),
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


@pytest.fixture(scope="module")
def models():
    """The port's circuit models, built once for the module."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = MODELS[name](tl.LogicalProgram,
                                       NoiseModel(**RATES))
        return cache[name]

    return get


def _same(a, b, where):
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
    else:
        assert a == b, (where, a, b)


@pytest.mark.parametrize("name", list(MODELS))
def test_circuit_models_bit_identical(models, name):
    mt = models(name)
    mj = MODELS[name](jl.LogicalProgram, JNoise(**RATES))
    for attr in ("n", "n_phases", "F", "priors", "obs", "fault_sigs"):
        _same(getattr(mt, attr), getattr(mj, attr), attr)
    for f in ("n", "nq", "n_ph", "rz", "rz_max", "rx_max", "rounds",
              "starts", "ops", "arrays", "flags", "ro_at", "gone_at",
              "init_scored_at", "init_conj_at", "n_meas", "n_read", "D",
              "obs_D", "rot", "h_at", "final_from_z"):
        _same(getattr(mt.plan, f), getattr(mj.plan, f), f"plan.{f}")
    public = lambda meta: {k: v for k, v in meta.items()
                           if not k.startswith("_")}
    _same(public(mt.meta), public(mj.meta), "meta")
    assert mt.meta["ambiguous_sigs"] == 0


def _one_fault_each(plan, metas):
    """`_sample_plan`'s ``faults`` with shot b carrying fault metas[b]
    alone (the enumerator's meta: kind, phase, ..., global round)."""
    batch, faults = len(metas), {}

    def put(key, width, b, col):
        a = faults.setdefault(key, np.zeros((batch, width), np.uint8))
        a[b, col] ^= 1

    for b, meta in enumerate(metas):
        kind, ph = meta[0], meta[1]
        four_g = 4 * len(plan.ops[ph])
        if kind in ("2q", "2qz"):
            _, _, g, which, t = meta
            z = kind == "2qz"
            for c in {"c": (0,), "t": (2,), "ct": (0, 2)}[which]:
                put(("gates", ph, t), four_g, b, 4 * g + c + z)
        elif kind in ("2qf", "2qzf"):
            _, _, g, t = meta
            put(("gates", ph, t), four_g, b, 4 * g + (3 if kind == "2qzf"
                                                      else 2))
        elif kind in ("meas", "reset"):
            _, _, c, t = meta
            put((kind, ph, t), plan.rz[ph], b, c)
        elif kind in ("init", "initz"):
            init = plan.init_scored_at[ph]
            put(("init", ph), len(init), b, init.index(meta[2]))
        elif kind == "read":
            qs = [qb for qb, _, _ in plan.ro_at[ph]]
            put(("read", ph), len(qs), b, qs.index(meta[2]))
        else:
            raise KeyError(kind)
    return faults


@pytest.mark.parametrize("name", list(MODELS))
def test_every_single_fault_gives_its_column(models, name):
    """Every booked fault of every class, injected alone through
    ``faults=``, gives exactly its merged variable's F and obs columns;
    a quiet run gives zero. All of them on the one-patch programs; on
    the two-patch ones (7,088 and 7,748 booked faults) 256 of each gate
    class, drawn with a fixed seed, and every other fault.

    On `feedback_x` and `t_x` (`build_circuit_x`) every phase-0 data
    init is a scored init on a rotated wire, booked as 'initz' (a Z
    flip). The reference's sampler strikes those inits through
    `frame.reset_qubits` (qcss_tpu/experiments/schedule_circuit.py:
    789-794), which puts an X flip there, and an X on a rotated wire
    leaves every detector and observable at zero: its X-sector rates
    come from a smaller model than the one it decodes. The port strikes
    Z, so these columns come out here too."""
    m = models(name)
    keys = sorted({(dets, ob) for dets, ob, _ in m.fault_sigs if dets})
    col = {key: v for v, key in enumerate(keys)}
    assert len(keys) == m.F.shape[1]
    sigs = list(m.fault_sigs)
    if len(sigs) > 4096:
        rng = np.random.default_rng(5)
        by_kind = {}
        for sig in sigs:
            by_kind.setdefault(sig[2][0], []).append(sig)
        sigs = []
        for kind, group in sorted(by_kind.items()):
            if kind.startswith("2q") and len(group) > 256:
                pick = rng.choice(len(group), size=256, replace=False)
                group = [group[i] for i in sorted(pick)]
            sigs.extend(group)
    metas = [meta for _, _, meta in sigs]
    kinds = {meta[0] for meta in metas}
    assert {"meas", "reset"} <= kinds
    if name in ("feedback_x", "t_x"):
        assert "initz" in kinds and "init" not in kinds
    noise = NoiseModel(**RATES)
    dets, obs = tsc.sample_circuit_schedule(
        m, noise, batch=len(metas), device=CPU,
        faults=_one_fault_each(m.plan, metas))
    dets, obs = dets.numpy(), obs.numpy()
    for b, (want, ob, meta) in enumerate(sigs):
        if not want:   # a silent fault books no variable
            assert not dets[b].any() and not obs[b].any(), meta
            continue
        v = col[(want, ob)]
        np.testing.assert_array_equal(dets[b], m.F[:, v], err_msg=str(meta))
        np.testing.assert_array_equal(obs[b], m.obs[:, v],
                                      err_msg=str(meta))
    d0, o0 = tsc.sample_circuit_schedule(m, NoiseModel(), batch=16,
                                         device=CPU)
    assert not d0.any() and not o0.any()


def test_rates_match_reference():
    """The port's sampler against the reference's, at p=5e-3 on every
    location of the h(0); idle; h(0) program (Z sector: unrotated and
    rotated phases, every gate class, no rotated init, so the repair
    does not apply): the detector count a shot, the share of shots with
    a detector, and each raw observable deviation, each by a two-sample
    99.9% test."""
    batch, p = 8192, 5e-3
    rates = dict(p_gate1=p, p_gate2=p, p_meas=p, p_reset=p)
    mj = MODELS["hih"](jl.LogicalProgram, JNoise(**rates))
    mt = MODELS["hih"](tl.LogicalProgram, NoiseModel(**rates))
    dj, oj = jsc.sample_circuit_schedule(mj, JNoise(**rates), batch=batch,
                                         seed=3)
    dt, ot = tsc.sample_circuit_schedule(mt, NoiseModel(**rates),
                                         batch=batch, seed=3, device=CPU)
    dt, ot = dt.numpy(), ot.numpy()
    cj, ct = dj.sum(1).astype(np.float64), dt.sum(1).astype(np.float64)
    se = math.sqrt((cj.var() + ct.var()) / batch)
    assert cj.mean() > 0.5
    assert abs(cj.mean() - ct.mean()) <= Z999 * se, (cj.mean(), ct.mean())
    pairs = [(dj.any(1), dt.any(1))] + [(oj[:, i], ot[:, i])
                                        for i in range(oj.shape[1])]
    for a, b in pairs:
        ka, kb = int(a.sum()), int(b.sum())
        pooled = (ka + kb) / (2 * batch)
        assert ka > 20
        assert abs(ka - kb) / batch <= Z999 * math.sqrt(
            pooled * (1 - pooled) * 2 / batch), (ka, kb)


def test_single_fault_syndromes_decode_exactly(models):
    """test_schedule_circuit.py's weight-1 check with the port's decoder
    (BP, then the device OSD on the CPU): 96 variables' own syndromes
    decode to their own observable effects."""
    m = models("cnot")
    idx = np.random.default_rng(2).choice(m.F.shape[1], size=96,
                                          replace=False)
    dec = BPDecoder(m.F, np.clip(m.priors, 1e-12, 0.499), logicals=m.obs,
                    iters=48, alpha=0.8, osd=True, device=CPU)
    flips, _ = dec.decode_obs_device(torch.as_tensor(m.F[:, idx].T))
    np.testing.assert_array_equal(flips.numpy(), m.obs[:, idx].T)


def test_run_circuit_composes_both_sectors():
    """test_schedule_circuit.py::test_run_circuit_composes_both_sectors
    at B=128: the T gadget's m1 and z0 (Z sector) and OUT (X sector),
    composed per shot."""
    profile = {}
    out = tl.LogicalProgram(3, 1).t(0).run_circuit(
        NoiseModel(**RATES), batch=128, seed=9, device=CPU,
        profile=profile)
    assert {"t0_m1_0_fail", "t0_out_0_fail", "z0_fail", "word_fail_z",
            "word_fail_x", "word_fail"} <= set(out)
    assert 0.0 <= out["word_fail"] <= 0.1
    assert set(profile) == {"build", "sample", "decode", "readback"}
