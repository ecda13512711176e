"""The port's FT transpiler (`qcss_tpu_torch.ftqc.schedule`, `rewrite`)
against the JAX package's, on the CPU.

The reference's executor is never run here: each of its compiles costs
14-77 s on this CPU. The port is held instead against

* the reference's host-side lowering, bit for bit: `lower` and
  `macro_rows` (a copy, tests/test_torch_import.py) on every program of
  the deterministic set, a guarded instruction inside a repeat_until
  included;
* the reference's exact outcome golds (tests/test_ftqc.py,
  tests/test_quil.py), each case naming the test it stands in for;
* the reference's validation: the same outcome for every combination of
  arguments, the same exception types and messages where it refuses and
  none where it accepts (the frame engine and parallel EC are held in
  tests/test_torch_ftqc_frames.py, the unrolled engine in
  tests/test_torch_ftqc_unrolled.py, flag EC in
  tests/test_torch_ftqc_flag.py);
* the reference's failure and preparation-failure counts of the noisy
  Steane X program (two-sample 99.9% tests; the samplers differ).

And against itself: the 'unpacked' and 'packed' engines give identical
registers, frames and prep_fail under the channels the executor draws
(``p_meas``, ``p_reset``, ``p_idle``), a seed repeats its run exactly, and
the drift modes ROADMAP.md names: the generator's use, `_encode_ft`'s
detection order and `reference_outcomes`' determinism check.
"""

import math
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import qcss_tpu.circuits as jcirc
from qcss_tpu.circuits.quil import parse_quil as jparse_quil
from qcss_tpu.codes import families as jfam
from qcss_tpu.ftqc import schedule as jsched
from qcss_tpu.ftqc.rewrite import EncodedProgram as JEncodedProgram
from qcss_tpu.sim import noise as jnoise
from qcss_tpu_torch.benchmarks import ftqc_programs as fp
from qcss_tpu_torch.circuits import Program
from qcss_tpu_torch.circuits.ir import GuardedInst, RepeatUntilInst
from qcss_tpu_torch.codes import families as tfam
from qcss_tpu_torch.errors import UnsupportedProgramError
from qcss_tpu_torch.ftqc import rewrite_program
from qcss_tpu_torch.ftqc import schedule as tsched
from qcss_tpu_torch.ftqc.rewrite import EncodedProgram
from qcss_tpu_torch.sim import noise as tnoise

Z999 = 3.2905
JIR = SimpleNamespace(Program=jcirc.Program, Circuit=jcirc.Circuit,
                      Block=jcirc.Block, parse_quil=jparse_quil,
                      families=jfam)

# The reference's noisy Steane X program, NoiseModel(p_gate1=0.01,
# p_gate2=0.01, p_meas=0.01) on the unpacked engine, B=512: 30 failures
# (ro != 1) and 8 prep_fail shots, from
#   rewrite_program(x, steane(), noise=noise).run(512, key=jax.random.key(1))
# (JAX 0.9.0 on the CPU).
REF_NOISY_512 = (30, 8)


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


def _two_sample_ok(k1, n1, k2, n2):
    pooled = (k1 + k2) / (n1 + n2)
    spread = Z999 * math.sqrt(pooled * (1 - pooled) * (1 / n1 + 1 / n2))
    return abs(k1 / n1 - k2 / n2) <= spread


def _run(name, batch, seed=0, tableau="unpacked"):
    prog, code = fp.build(name)
    return rewrite_program(prog, code, tableau=tableau, device="cpu",
                           **fp.PROGRAMS[name].options).run(batch, seed)


# -- compose_pauli ---------------------------------------------------------------

@pytest.mark.parametrize("rate", [0.01, 0.3, (0.01, 0.002, 0.03),
                                  (0.2, 0.1, 0.3)], ids=str)
def test_compose_pauli_equals_reference(rate):
    for steps in range(1, 7):
        assert tnoise.compose_pauli(rate, steps) == \
            jnoise.compose_pauli(rate, steps)


# -- the lowering, bit for bit ---------------------------------------------------

@pytest.mark.parametrize("name", list(fp.PROGRAMS))
def test_lowering_identical(name):
    jprog, jcode = fp.build(name, JIR)
    tprog, tcode = fp.build(name)
    jm, tm = jsched.lower(jprog, jcode), tsched.lower(tprog, tcode)
    np.testing.assert_array_equal(tm.ops, jm.ops)
    assert (tm.n_logical, tm.memory_layout, tm.memory_size) == \
        (jm.n_logical, jm.memory_layout, jm.memory_size)
    T = jm.ops.shape[0]
    refs = (np.arange(T) % 3 == 1).astype(np.int32)
    for ref_outs in (None, refs):
        for pad_to in (None, T, 2 * T + 3):
            np.testing.assert_array_equal(
                tsched.macro_rows(tm, ref_outs, pad_to=pad_to),
                jsched.macro_rows(jm, ref_outs, pad_to=pad_to))
    if name == "quil_two_entry_loop":
        # the dispatch tier: guarded instructions inside a repeat_until
        assert any(isinstance(inst, RepeatUntilInst)
                   and any(isinstance(b, GuardedInst) for b in inst.body)
                   for inst in tprog.instructions)


# -- exact outcomes (the reference's golds) ---------------------------------------

# test_ftqc.py parametrizes superdense coding over (0, 0) and (1, 1)
UNPACKED_GOLDS = [n for n in fp.PROGRAMS
                  if n not in ("superdense01", "superdense10")]


@pytest.mark.parametrize("name", UNPACKED_GOLDS,
                         ids=[f"{n}-{fp.PROGRAMS[n].source}"
                              for n in UNPACKED_GOLDS])
def test_golds_unpacked(name):
    batch = 8 if name == "ghz4" else 4
    res = _run(name, batch)
    assert fp.PROGRAMS[name].gold(res), res["ro"]
    assert not res["__prep_fail__"].any()
    if name == "ghz4":  # test_ftqc.py:155: both branches occur
        assert 0 < res["ro"][:, 0].mean() < 1


PACKED_GOLDS = ["x", "feedback", "superdense10", "ec2"]


@pytest.mark.parametrize("name", PACKED_GOLDS,
                         ids=[f"{n}-{fp.PROGRAMS[n].source}"
                              for n in PACKED_GOLDS])
def test_golds_packed(name):
    # test_ftqc.py:322, :329 and :340 run the packed engine; ec2 is :505
    res = _run(name, 4, tableau="packed")
    assert fp.PROGRAMS[name].gold(res), res["ro"]
    assert not res["__prep_fail__"].any()


def test_ec_corrects_injected_error():
    """Stands in for test_ftqc.py:158: X on data qubit 2 (samples 0, 1)
    and Z on qubit 5 (samples 1, 2) injected after the FT |0̄⟩
    preparation; Steane EC must put exactly those errors in the frames,
    and the logical measurement must still read 0."""
    ex = tsched.MacroExecutor(tfam.steane(), 1, device="cpu")
    st = ex.initial_state(4, 1, seed=3)
    st = ex._encode_ft(st, 0, 1, plus=False)
    xf = torch.zeros((4, 7), dtype=torch.uint8)
    zf = torch.zeros_like(xf)
    xf[0, 2] = xf[1, 2] = 1
    zf[1, 5] = zf[2, 5] = 1
    st = st._replace(tab=ex.engine.inject_block_flips(st.tab, 0, xf, zf))
    st = ex._ec_one(st, 0)
    np.testing.assert_array_equal(st.x_frames[:, 0].numpy(), xf.numpy())
    np.testing.assert_array_equal(st.z_frames[:, 0].numpy(), zf.numpy())
    st, outcome = ex._noisy_measure(st, 0)
    assert not outcome.any()


# -- validation ----------------------------------------------------------------------

def _outcome(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 - the type is what is compared
        return type(exc).__name__, str(exc)
    return None


ENCODE_GRID = [
    dict(engine=e, tableau=t, ancillas=a, ec_extractions=x, ec_schedule=s,
         ec_mode=m)
    for e in ("scheduled", "unrolled") for t in ("unpacked", "packed", "frames")
    for a in ("shared", "dedicated") for x in (1, 2)
    for s in ("serial", "parallel") for m in ("steane", "flag")
] + [dict(engine="bogus"), dict(tableau="bogus"), dict(ancillas="bogus"),
     dict(ec_extractions=3), dict(ec_schedule="bogus"), dict(ec_mode="bogus")]


def test_encoded_program_validation():
    jprog, jcode = fp.build("x", JIR)
    tprog, tcode = fp.build("x")
    for kw in ENCODE_GRID:
        want = _outcome(lambda: JEncodedProgram(jprog, jcode, **kw))
        got = _outcome(lambda: EncodedProgram(tprog, tcode, device="cpu",
                                              **kw))
        assert got == want, kw


def test_encoded_program_refuses_programs():
    """k != 1, gates the code cannot do transversally (test_ftqc.py:208,
    :218), and repeat_until with the unrolled engine (test_ftqc.py:379)."""
    def case(build, code, **kw):
        want = _outcome(lambda: JEncodedProgram(build(JIR), code(jfam), **kw))
        got = _outcome(lambda: EncodedProgram(build(fp._ir()), code(tfam),
                                              device="cpu", **kw))
        assert want is not None and got == want, (want, got)

    def gate(name):
        def build(ir):
            prog = ir.Program()
            getattr(prog, name)(0)
            return prog
        return build

    def loop(ir):
        prog = ir.Program()
        ro = prog.declare("ro", 1)
        prog.repeat_until(ro[0], ir.Block().measure(0, ro[0]), max_iters=2)
        return prog

    case(gate("x"), lambda fam: fam.toric(3))
    case(gate("s"), lambda fam: fam.shor())
    case(gate("h"), lambda fam: fam.shor())
    case(loop, lambda fam: fam.steane(), engine="unrolled")


EXECUTOR_GRID = [
    dict(tableau_engine=t, ancillas=a, ec_extractions=x, ec_schedule=s,
         ec_mode=m, reference_mode=r)
    for t in ("unpacked", "packed", "frames") for a in ("shared", "dedicated")
    for x in (1, 2) for s in ("serial", "parallel") for m in ("steane", "flag")
    for r in (False, True)
] + [dict(tableau_engine="bogus"), dict(ancillas="bogus"),
     dict(ec_extractions=3), dict(ec_schedule="bogus"), dict(ec_mode="bogus")]


def test_macro_executor_validation():
    jcode, tcode = jfam.steane(), tfam.steane()
    for kw in EXECUTOR_GRID:
        want = _outcome(lambda: jsched.MacroExecutor(jcode, 1, **kw))
        got = _outcome(lambda: tsched.MacroExecutor(tcode, 1, device="cpu",
                                                    **kw))
        assert got == want, kw


# -- the engines against each other, and the generator ------------------------------

EXEC_NOISE = tnoise.NoiseModel(p_meas=0.003, p_reset=0.003, p_idle=0.003)


def _execute(name, batch, seed, tableau="unpacked", generator=None):
    """The final state of a run under the executor's channels."""
    prog, code = fp.build(name)
    macro = tsched.lower(prog, code)
    ex = tsched.MacroExecutor(code, macro.n_logical, EXEC_NOISE,
                              tableau_engine=tableau, device="cpu")
    return ex.execute(macro, batch, seed=seed, generator=generator)


def test_engines_agree_under_executor_noise():
    """The Steane X program at B=64 (chip_smoke.py holds the two-block
    and the dedicated, repeated-extraction programs on the card; the
    packed engine's plain path runs 32-qubit blocks on the CPU, four
    times Steane's)."""
    a = _execute("x", 64, 5, "unpacked")
    b = _execute("x", 64, 5, "packed")
    for field in ("memory", "prep_fail", "x_frames", "z_frames", "votes"):
        assert torch.equal(getattr(a, field), getattr(b, field)), field
    # the channels did act: frames were corrected somewhere
    assert bool(a.x_frames.any() or a.z_frames.any())
    again = _execute("x", 64, 5, "unpacked")  # the same seed: the same run
    for field in a._fields[1:]:
        assert torch.equal(getattr(a, field), getattr(again, field)), field


def test_generator_seeds_the_run():
    a = _execute("x", 4, 0, generator=torch.Generator().manual_seed(4))
    b = _execute("x", 4, 0, generator=torch.Generator().manual_seed(4))
    c = _execute("x", 4, 0, generator=torch.Generator().manual_seed(5))
    assert all(torch.equal(getattr(a, f), getattr(b, f))
               for f in a._fields[1:]) and torch.equal(a.tab.r, b.tab.r)
    # another seed draws other collapse bits: other signs
    assert not torch.equal(a.tab.r, c.tab.r)


def test_noisy_x_rates_against_reference():
    """The noisy Steane X program at the reference's batch and noise: its
    failures and prep_fail shots against the reference's counts."""
    prog, code = fp.build("x")
    noise = tnoise.NoiseModel(p_gate1=0.01, p_gate2=0.01, p_meas=0.01)
    res = rewrite_program(prog, code, noise=noise, device="cpu").run(512, 1)
    fails = int((res["ro"][:, 0] != 1).sum())
    prep_fail = int(res["__prep_fail__"].sum())
    for got, ref in zip((fails, prep_fail), REF_NOISY_512):
        assert _two_sample_ok(got, 512, ref, 512), (got, ref)
    assert fails > 0


# -- drift modes -----------------------------------------------------------------------

def test_encode_ft_detection_order():
    """schedule.py:573-596: the last detection round is the one whose
    back-propagated deposit is benign for the prepared eigenstate."""
    ex = tsched.MacroExecutor(tfam.steane(), 1, device="cpu")
    calls = []
    detect = ex._error_detect

    def spy(st, b, anc, x_sector, include_operators):
        calls.append((x_sector, include_operators))
        return detect(st, b, anc, x_sector, include_operators)

    ex._error_detect = spy
    st = ex.initial_state(2, 1)
    for plus, want in ((False, [(False, False), (True, True)]),
                       (True, [(True, False), (False, True)])):
        calls.clear()
        ex._encode_ft(st, 0, 1, plus=plus)
        assert calls == want


def test_reference_outcomes():
    """The reference run skips Paulis (they ride the frame): the X
    program records 0 at every row, HSSH (= X up to phase, by non-Pauli
    gates) 1 at every MEASURE_TRIAL row and 0 elsewhere; a measurement
    of |+̄⟩ is refused."""
    for name, want in (("x", 0), ("s", 1)):
        prog, code = fp.build(name)
        macro = tsched.lower(prog, code)
        refs = tsched.reference_outcomes(macro, code, device="cpu")
        trial = macro.ops[:, 0] == tsched.OP_MEASURE_TRIAL
        assert trial.sum() == 2 * code.t + 1
        np.testing.assert_array_equal(refs, want * trial.astype(np.int32))
    h = Program()
    ro = h.declare("ro", 1)
    h.h(0).measure(0, ro[0])
    with pytest.raises(UnsupportedProgramError, match="non-deterministic"):
        tsched.reference_outcomes(tsched.lower(h, code), code, device="cpu")
