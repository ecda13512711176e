"""The port's unrolled engine (`ftqc/executor.py`'s `FTProtocols`,
``rewrite_program(..., engine='unrolled')``) and its fidelity bench
(`benchmarks/fidelity.py`) against the JAX package's, on the CPU.

The reference's executor is never run here (each of its compiles costs
14-77 s on this CPU). The port is held instead against

* the reference's protocol test on `FTProtocols` (test_ftqc.py:158: the
  injected errors land in the frames, the logical outcome stays 0);
* the reference tests' exact golds (`ftqc_programs.PROGRAMS`) on the
  unrolled engine, and the set of programs the reference's unrolled
  engine refuses, with the reference's exception and message (the
  reference's `EncodedProgram` is built, which compiles nothing);
* its own scheduled engine, bit for bit (registers, prep_fail, frames):
  both engines call the same executor bodies, so under the executor's
  channels without idle noise they split alike; on an `if_then` program
  the unrolled engine runs the conditional gate's EC round on every shot
  (the reference's unrolled engine does, rewrite.py:213-218), so the two
  agree on the shots whose condition is 1;
* test_fidelity.py's three cases on the port's `fidelity.py`.
"""

from types import SimpleNamespace

import pytest
import torch

import qcss_tpu.circuits as jcirc
from qcss_tpu.circuits.quil import parse_quil as jparse_quil
from qcss_tpu.codes import families as jfam
from qcss_tpu.ftqc.rewrite import EncodedProgram as JEncodedProgram
from qcss_tpu_torch.benchmarks import fidelity
from qcss_tpu_torch.benchmarks import ftqc_programs as fp
from qcss_tpu_torch.circuits import Program
from qcss_tpu_torch.codes import families as tfam
from qcss_tpu_torch.ftqc import FTProtocols, rewrite_program
from qcss_tpu_torch.ftqc import schedule as tsched
from qcss_tpu_torch.sim.noise import NoiseModel

JIR = SimpleNamespace(Program=jcirc.Program, Circuit=jcirc.Circuit,
                      Block=jcirc.Block, parse_quil=jparse_quil,
                      families=jfam)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # several worker processes run at once; see test_torch_device_uf.py
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _outcome(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 - the type is what is compared
        return type(exc).__name__, str(exc)
    return None


# -- the protocols -------------------------------------------------------------------

def test_ec_corrects_injected_error():
    """Stands in for test_ftqc.py:158 on `FTProtocols`: X on data qubit 2
    (samples 0, 1) and Z on qubit 5 (samples 1, 2) after the FT |0̄⟩
    preparation; `error_correct` must put exactly those errors in the
    frames, and `measure` must read 0."""
    p = FTProtocols(tfam.steane(), 3, device="cpu")
    data, anc1, anc2 = p.block(0), p.block(1), p.block(2)
    st = p.init_state(4, 3)
    st = p.encode_zero(st, data, anc1)
    xf = torch.zeros((4, 7), dtype=torch.uint8)
    zf = torch.zeros_like(xf)
    xf[0, 2] = xf[1, 2] = 1
    zf[1, 5] = zf[2, 5] = 1
    st = st._replace(tab=p.engine.inject_block_flips(st.tab, 0, xf, zf))
    st = p.error_correct(st, data, anc1, anc2)
    assert torch.equal(st.x_frames[:, 0], xf)
    assert torch.equal(st.z_frames[:, 0], zf)
    st, outcome = p.measure(st, data, anc1, anc2)
    assert not outcome.any()


def test_protocol_errors():
    """The reference's refusals: k != 1, another ancilla pair, and a gate
    the code cannot do transversally."""
    from qcss_tpu.ftqc.executor import FTProtocols as JFTProtocols

    def case(ftp, fam, call):
        return _outcome(lambda: call(ftp(fam.steane(), 3)))

    calls = [
        lambda p: p.error_correct(None, p.block(0), p.block(2), p.block(1)),
        lambda p: p.noisy_measure(None, p.block(0), p.block(1), p.block(0)),
        lambda p: p.apply_logical_gate(None, "T", [p.block(0)]),
    ]
    for call in calls:
        want = case(JFTProtocols, jfam, call)
        got = case(lambda c, n: FTProtocols(c, n, device="cpu"), tfam, call)
        assert want is not None and got == want, (want, got)
    want = _outcome(lambda: JFTProtocols(jfam.toric(3), 4))
    got = _outcome(lambda: FTProtocols(tfam.toric(3), 4, device="cpu"))
    assert want is not None and got == want


# -- exact outcomes and refusals ----------------------------------------------------

def _refusal(name):
    """The JAX package's outcome of building ``name`` on the unrolled
    engine (None: accepted)."""
    prog, code = fp.build(name, JIR)
    return _outcome(lambda: JEncodedProgram(
        prog, code, engine="unrolled", **fp.PROGRAMS[name].options))


@pytest.mark.parametrize("name", list(fp.PROGRAMS),
                         ids=[f"{n}-{fp.PROGRAMS[n].source}"
                              for n in fp.PROGRAMS])
def test_golds_unrolled(name):
    spec = fp.PROGRAMS[name]
    prog, code = fp.build(name)
    want = _refusal(name)
    assert (want is not None) == (name in fp.UNROLLED_REFUSED)
    if want is not None:
        got = _outcome(lambda: rewrite_program(
            prog, code, engine="unrolled", device="cpu", **spec.options))
        assert got == want
        assert fp.UNROLLED_REFUSED[name] in want[1]
        return
    batch = 8 if name == "feedback" else 4
    res = rewrite_program(prog, code, engine="unrolled", device="cpu",
                          **spec.options).run(batch, 0)
    assert spec.gold(res), res["ro"]
    assert not res["__prep_fail__"].any()


def test_classical_ops_unrolled():
    """Stands in for test_ftqc.py:454 (B=2, as there)."""
    prog = Program()
    ro = prog.declare("ro", 2)
    prog.x(0).measure(0, ro[0])
    prog.move(ro[1], ro[0])
    prog.not_(ro[1])
    res = rewrite_program(prog, tfam.steane(), engine="unrolled",
                          device="cpu").run(2)
    assert (res["ro"][:, 0] == 1).all() and (res["ro"][:, 1] == 0).all()


# -- unrolled against scheduled -----------------------------------------------------

def _both(name, noise, batch, seed):
    """(unrolled registers, unrolled state, scheduled registers, scheduled
    state, (unrolled splits, scheduled splits)) of one run each on one
    seed."""
    prog, code = fp.build(name)
    enc = rewrite_program(prog, code, noise=noise, engine="unrolled",
                          device="cpu")
    mem, su = enc._execute(batch, seed, None)
    macro = tsched.lower(prog, code)
    ex = tsched.MacroExecutor(code, macro.n_logical, noise, device="cpu")
    ss = ex.execute(macro, batch, seed=seed)
    regs = {k: ss.memory[:, off:off + size]
            for k, (off, size) in macro.memory_layout.items()}
    return mem, su, regs, ss, (enc.protocols._splits, ex._splits)


def test_unrolled_equals_scheduled():
    """The X program under p_meas = p_reset = 0.01, B=64: registers,
    prep_fail, frames and the split count equal, and some shot carries a
    frame."""
    mem, su, regs, ss, splits = _both(
        "x", NoiseModel(p_meas=0.01, p_reset=0.01), 64, 3)
    assert splits[0] == splits[1]
    assert torch.equal(mem["ro"], regs["ro"])
    for field in ("prep_fail", "x_frames", "z_frames"):
        assert torch.equal(getattr(su, field), getattr(ss, field)), field
    assert bool(su.x_frames.any() or su.z_frames.any())


def test_if_then_agrees_where_the_condition_holds():
    """The feedback program (H, measure, if_then X, measure) under
    p_meas = p_reset = 0.01, B=32: the engines take the same splits, and
    on the shots whose condition is 1 they agree bit for bit."""
    mem, su, regs, ss, splits = _both(
        "feedback", NoiseModel(p_meas=0.01, p_reset=0.01), 32, 3)
    assert splits[0] == splits[1]
    c = mem["ro"][:, 0] == 1
    assert 0 < int(c.sum()) < 32
    assert torch.equal(mem["ro"][c], regs["ro"][c])
    for field in ("prep_fail", "x_frames", "z_frames"):
        assert torch.equal(getattr(su, field)[c], getattr(ss, field)[c])


# -- the fidelity bench (test_fidelity.py's three cases) ----------------------------

def test_noiseless_raw_is_exact():
    assert fidelity.raw_x_program_error_rate(256, NoiseModel(), 0,
                                             "cpu") == 0.0


def test_noisy_raw_rate_matches_model():
    p = 0.05
    rate = fidelity.raw_x_program_error_rate(
        1 << 14, NoiseModel(p_gate1=p), 1, "cpu")
    assert abs(rate - 2 * p / 3) < 0.01


def test_noiseless_encoded_is_exact():
    rate, elapsed = fidelity.encoded_x_program_error_rate(
        16, NoiseModel(), 2, device="cpu")
    assert rate == 0.0
    assert elapsed > 0
