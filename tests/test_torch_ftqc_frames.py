"""The port's Pauli-frame FT engine (`ftqc.engines.FrameEngine`,
``tableau='frames'``) and parallel EC (``ec_schedule='parallel'``) against
the JAX package's, on the CPU.

The reference's executor is never run here (each of its compiles costs
14-77 s on this CPU). The port is held instead against

* the reference's frame primitives on the same fault bits, bit for bit:
  `run_compiled_noisy`'s ``qubits=`` window and `run_compiled_noisy_multi`
  handed the reference's `_sampled_fault_bits`;
* the reference's `FrameEngine`, noiselessly, method by method on random
  frames (eager JAX ops, no executor compile);
* the reference tests' exact golds (tests/test_ftqc_frames.py), each case
  naming the test it stands in for, and its soundness guards' types and
  messages; the set of programs the reference refuses on 'frames' is
  `ftqc_programs.FRAMES_REFUSED`, recorded with the reference's own
  `EncodedProgram` and `reference_outcomes`;
* the reference's recorded failure counts of parallel and serial EC
  under idle noise (two-sample 99.9% tests; the samplers differ).

And against itself, the drift modes: frames equal unpacked bit for bit
under gate, measurement, reset and idle noise and with repeated
extraction on dedicated ancillas; `inject1_many` / `inject2_many` draw as
`depolarize1_many` / `depolarize2_many`; the compiled prep equals the
per-gate prep on one generator; parallel EC charges the data blocks'
idle after its commit.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcss_tpu.codes import families as jfam
from qcss_tpu.ftqc import engines as jeng
from qcss_tpu.ftqc.rewrite import EncodedProgram as JEncodedProgram
from qcss_tpu.sim import frame as jfr
from qcss_tpu.sim import noise as jnoise
from qcss_tpu_torch.benchmarks import ftqc_programs as fp
from qcss_tpu_torch.circuits import Program
from qcss_tpu_torch.circuits.encoding import depth_optimize
from qcss_tpu_torch.codes import families as tfam
from qcss_tpu_torch.errors import UnsupportedProgramError
from qcss_tpu_torch.ftqc import engines as teng
from qcss_tpu_torch.ftqc import rewrite_program
from qcss_tpu_torch.ftqc import schedule as tsched
from qcss_tpu_torch.sim import frame as tfr
from qcss_tpu_torch.sim import noise as tnoise
from qcss_tpu_torch.sim import tableau as tb

Z999 = 3.2905

# The reference's two-block X program (tests/test_idle.py:103-133) under
# NoiseModel(p_gate2=3e-4, p_idle=3e-4), dedicated ancillas, 'frames':
# 143 failures (any ro != 1) of 4096 with ec_schedule='parallel' and 334
# with 'serial', from
#   rewrite_program(p, steane(), noise=noise, tableau="frames",
#                   ancillas="dedicated", ec_schedule=s
#                   ).run(4096, key=jax.random.key(2))
# (JAX 0.9.0 on the CPU; the test's comment records 187 and 473 from an
# earlier JAX).
REF_PARALLEL_4096 = (143, 334, 4096)
PAR_BATCH = 512


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # several worker processes run at once; see test_torch_device_uf.py
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _two_sample_ok(k1, n1, k2, n2):
    pooled = (k1 + k2) / (n1 + n2)
    spread = Z999 * math.sqrt(pooled * (1 - pooled) * (1 / n1 + 1 / n2))
    return abs(k1 / n1 - k2 / n2) <= spread


def _prep_arrays(code):
    return depth_optimize(code.noisy_encode_zero(range(code.n))).to_arrays()


def _random_frames(rng, B, nq):
    x = rng.integers(0, 2, (B, nq), dtype=np.uint8)
    z = rng.integers(0, 2, (B, nq), dtype=np.uint8)
    return (jfr.Frames(jnp.asarray(x), jnp.asarray(z)),
            tfr.Frames(torch.from_numpy(x), torch.from_numpy(z)))


def _equal(port, ref):
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -- frame primitives against the reference's, on its fault bits ----------------

NOISE = {
    "depolarizing": dict(p_gate1=0.05, p_gate2=0.08),
    "biased": dict(p_gate1=0.06, p_gate2=0.12, pauli1=(0.02, 0.01, 0.03),
                   pauli2=(0.04, 0.02, 0.06)),
}


@pytest.mark.parametrize("noise", sorted(NOISE))
def test_compiled_window_and_multi_equal_reference(noise):
    """frame.py:405-453: the window form and the multi-window form on the
    reference's fault bits; the multi form equals m window-form calls
    handed its rows. The window form runs B*m shots and the multi form B
    shots in m windows, so both draw one [B*m, 4G] sample from one key
    (one shape of JAX ops to compile)."""
    ops, q0, q1 = _prep_arrays(tfam.steane())
    n, B, m = 7, 16, 3
    mj, mt = jnoise.NoiseModel(**NOISE[noise]), tnoise.NoiseModel(**NOISE[noise])
    rng = np.random.default_rng(1)
    fj, ft = _random_frames(rng, B * m, 4 * n)
    cj = jfr.compile_circuit(ops, q0, q1, n)
    ct = tfr.compile_circuit(ops, q0, q1, n)
    qw = np.arange(n) + 2 * n
    windows = np.asarray([[0, 1, 2, 3, 4, 5, 6], [21, 22, 23, 24, 25, 26, 27],
                          [7, 9, 11, 13, 15, 17, 19]])
    fj_m, ft_m = _random_frames(rng, B, 4 * n)

    def reference(key, fj, fj_m):  # one jit: cheaper than eager op by op
        return (jfr._sampled_fault_bits(cj, mj, key, B * m),
                jfr.run_compiled_noisy(fj, cj, mj, key, qubits=qw),
                jfr.run_compiled_noisy_multi(fj_m, cj, mj, key, windows))

    bits, ref, ref_m = jax.jit(reference)(jax.random.key(5), fj, fj_m)
    bits = torch.from_numpy(np.array(bits))
    assert bits.any()
    _equal(tfr.run_compiled_noisy(ft, ct, mt, fault_bits=bits, qubits=qw), ref)
    _equal(tfr.run_compiled_noisy(ft, ct, mt, fault_bits=bits,
                                  qubits=slice(2 * n, 3 * n)), ref)
    ft = ft_m
    got_m = tfr.run_compiled_noisy_multi(ft, ct, mt, None, windows,
                                         fault_bits=bits)
    _equal(got_m, ref_m)
    seq = ft
    rows = bits.reshape(B, m, -1)
    for j in range(m):
        seq = tfr.run_compiled_noisy(seq, ct, mt, fault_bits=rows[:, j],
                                     qubits=windows[j])
    for a, b in zip(seq, got_m):
        assert torch.equal(a, b)


@pytest.mark.parametrize("p", [0.3, (0.1, 0.05, 0.2)], ids=["scalar", "tuple"])
def test_inject_draws_as_tableau_channels(p):
    """Drift mode (2): `inject1_many` / `inject2_many` XOR exactly the
    Pauli that `depolarize1_many` / `depolarize2_many` apply to a tableau
    on one generator state, and leave the generator in the same state.
    On |0>^n the destabilizer X_i's sign reads the Z flip on qubit i and
    the stabilizer Z_i's sign the X flip."""
    B, n = 256, 9
    c, t = [0, 2, 4, 6], [1, 3, 5, 8]

    def gens():
        return (torch.Generator().manual_seed(17),
                torch.Generator().manual_seed(17))

    def paulis(tab):
        return tab.r[:, n:], tab.r[:, :n]   # (x flips, z flips)

    g_f, g_t = gens()
    f = tfr.inject1_many(tfr.zero_frames(B, n, "cpu"), c + [7], p, g_f)
    tab = tnoise.depolarize1_many(tb.zero_state(B, n, "cpu"), c + [7], p, g_t)
    for a, b in zip(f, paulis(tab)):
        assert torch.equal(a, b)
    assert torch.equal(g_f.get_state(), g_t.get_state())
    g_f, g_t = gens()
    f = tfr.inject2_many(tfr.zero_frames(B, n, "cpu"), c, t, p, g_f)
    tab = tnoise.depolarize2_many(tb.zero_state(B, n, "cpu"), c, t, p, g_t)
    for a, b in zip(f, paulis(tab)):
        assert torch.equal(a, b)
    assert torch.equal(g_f.get_state(), g_t.get_state())
    assert f.x.any() and f.z.any()


# -- FrameEngine against the reference's, noiselessly ------------------------------

def test_frame_engine_equals_reference_noiseless():
    """engines.py:387-577, every method of the block and multi-block
    interface on random frames (no noise: the channels are held by the
    draw contract above and by the reference's fault bits)."""
    n, nb, B = 7, 6, 16
    rng = np.random.default_rng(3)
    je = jeng.FrameEngine(n, nb, jnoise.NoiseModel())
    te = teng.FrameEngine(n, nb, tnoise.NoiseModel())
    fj, ft = _random_frames(rng, B, n * nb)
    gj, gt = _random_frames(rng, B, n * nb)
    key = jax.random.key(0)
    arrays = _prep_arrays(tfam.steane())
    mask = rng.integers(0, 2, (B,), dtype=np.uint8)
    flips = rng.integers(0, 2, (2, B, n), dtype=np.uint8)
    data_flips = rng.integers(0, 2, (2, B, 2, n), dtype=np.uint8)
    row_x, row_z = (rng.integers(0, 2, (n,), dtype=np.uint8)
                    for _ in range(2))
    a1, a2 = je.blocks_qubits([2, 4]), je.blocks_qubits([3, 5])
    np.testing.assert_array_equal(te.blocks_qubits([2, 4]), a1)
    cols = np.concatenate([a1, a2], axis=1).reshape(-1)
    colmask = rng.integers(0, 2, (B, cols.size), dtype=np.uint8)
    cj, ct = je.compile_block_circuit(arrays), te.compile_block_circuit(arrays)
    cases = [  # (the reference's, the port's)
        (lambda f, g: je.select(jnp.asarray(mask), f, g),
         lambda: te.select(torch.from_numpy(mask), ft, gt)),
        (lambda f, g: je.reset_block(f, 2, key), lambda: te.reset_block(ft, 2)),
        (lambda f, g: je.run_block_circuit(f, arrays, 3, key),
         lambda: te.run_block_circuit(ft, arrays, 3)),
        (lambda f, g: je.run_compiled(f, cj, 3, key),
         lambda: te.run_compiled(ft, ct, 3)),
        (lambda f, g: (je.measure_block(f, 4, key)[1],),
         lambda: (te.measure_block(ft, 4)[1],)),
        (lambda f, g: je.transversal_cnot(f, 1, 4, key),
         lambda: te.transversal_cnot(ft, 1, 4)),
        *[(lambda f, g, gate=gate: je.transversal_1q(f, gate, 2, key),
           lambda gate=gate: te.transversal_1q(ft, gate, 2))
          for gate in "HSXZ"],
        (lambda f, g: je.transversal_cz(f, 0, 5, key),
         lambda: te.transversal_cz(ft, 0, 5)),
        (lambda f, g: je.pauli_inject(f, 1, jnp.asarray(row_x),
                                      jnp.asarray(row_z), jnp.asarray(mask)),
         lambda: te.pauli_inject(ft, 1, row_x, row_z, torch.from_numpy(mask))),
        (lambda f, g: je.inject_block_flips(f, 5, *flips),
         lambda: te.inject_block_flips(ft, 5, *map(torch.from_numpy, flips))),
        (lambda f, g: je.inject_data_flips(f, *map(jnp.asarray, data_flips)),
         lambda: te.inject_data_flips(ft, *map(torch.from_numpy,
                                               data_flips))),
        (lambda f, g: je.reset_blocks(f, a1), lambda: te.reset_blocks(ft, a1)),
        (lambda f, g: je.run_compiled_multi(f, cj, a2, key),
         lambda: te.run_compiled_multi(ft, ct, a2)),
        (lambda f, g: je.cnot_qubits(f, a1, a2, key),
         lambda: te.cnot_qubits(ft, a1, a2)),
        (lambda f, g: je.h_qubits(f, a2, key), lambda: te.h_qubits(ft, a2)),
        (lambda f, g: (je.measure_qubits(f, a1)[1],),
         lambda: (te.measure_qubits(ft, a1)[1],)),
        (lambda f, g: je.select_qubits(f, cols, jnp.asarray(colmask), g, f),
         lambda: te.select_qubits(ft, cols, torch.from_numpy(colmask), gt,
                                  ft)),
    ]
    # the reference's side in one jit (cheaper than eager op by op)
    wants = jax.jit(lambda f, g: [tuple(ref(f, g)) for ref, _ in cases])(
        fj, gj)
    for i, ((_, port), want) in enumerate(zip(cases, wants)):
        got = port()
        assert len(got) == len(want), i
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"case {i}")
    zero = te.zero_state(B, "cpu")
    assert zero.x.shape == (B, n * nb) and not (zero.x.any() or zero.z.any())


def test_compiled_prep_equals_per_gate_prep():
    """Drift mode (3): the executor's compiled prep (`run_compiled`) and
    the per-gate prep (`run_block_circuit`) on one generator state."""
    te = teng.FrameEngine(7, 3, tnoise.NoiseModel(p_gate1=0.05,
                                                  p_gate2=0.1))
    _, ft = _random_frames(np.random.default_rng(9), 64, 21)
    for arrays in (_prep_arrays(tfam.steane()),
                   depth_optimize(tfam.steane().noisy_encode_plus(
                       range(7))).to_arrays()):
        a = te.run_block_circuit(ft, arrays, 1, torch.Generator().manual_seed(2))
        b = te.run_compiled(ft, te.compile_block_circuit(arrays), 1,
                            torch.Generator().manual_seed(2))
        assert torch.equal(a.x, b.x) and torch.equal(a.z, b.z)
        assert not torch.equal(a.x, ft.x)


# -- the reference tests' golds and soundness guards --------------------------------

FRAMES_GOLDS = ["x", "y", "z", "xxx", "yz", "hzh", "ssx", "x_cnot",
                "pauli_feedback", "repeat_until_pauli"]
SPECS = {**fp.PROGRAMS, **fp.FRAMES_PROGRAMS}


@pytest.mark.parametrize("name", FRAMES_GOLDS,
                         ids=[f"{n}-{SPECS[n].source}" for n in FRAMES_GOLDS])
def test_golds_frames(name):
    """test_ftqc_frames.py:39-86 (the X, Y, Z, XXX, YZ and HZH sequences
    are test_ftqc.py's own programs)."""
    prog, code = fp.build(name)
    res = rewrite_program(prog, code, tableau="frames", device="cpu",
                          **SPECS[name].options).run(8, 0)
    assert SPECS[name].gold(res), res["ro"]
    assert not res["__prep_fail__"].any()


@pytest.mark.parametrize("name", sorted(fp.FRAMES_REFUSED))
def test_refused_where_the_reference_refuses(name):
    """The programs of both sets that the reference refuses on 'frames'
    (ftqc_programs.FRAMES_REFUSED): at `rewrite_program` for a
    conditional or looped non-Pauli gate (test_ftqc_frames.py:99,
    matching "frames"; the reference's `_validate` is run here too), at
    `run` for a random reference outcome (test_ftqc_frames.py:90,
    matching "deterministic")."""
    from qcss_tpu.errors import UnsupportedProgramError as JUnsupported

    match = fp.FRAMES_REFUSED[name]
    prog, code = fp.build(name)
    opts = SPECS[name].options
    if match == "frames":
        with pytest.raises(UnsupportedProgramError, match="frames"):
            rewrite_program(prog, code, tableau="frames", device="cpu",
                            **opts)
        jprog, jcode = fp.build(name, _jax_ir())
        with pytest.raises(JUnsupported, match="frames"):
            JEncodedProgram(jprog, jcode, tableau="frames", **opts)
        return
    enc = rewrite_program(prog, code, tableau="frames", device="cpu", **opts)
    with pytest.raises(UnsupportedProgramError, match="deterministic"):
        enc.run(8)


def _jax_ir():
    from types import SimpleNamespace

    import qcss_tpu.circuits as jcirc
    from qcss_tpu.circuits.quil import parse_quil

    return SimpleNamespace(Program=jcirc.Program, Circuit=jcirc.Circuit,
                           Block=jcirc.Block, parse_quil=parse_quil,
                           families=jfam)


def test_frames_requires_scheduled():
    """test_ftqc_frames.py:107: the reference's ValueError, message for
    message."""
    tprog, tcode = fp.build("x")
    jprog, jcode = fp.build("x", _jax_ir())
    with pytest.raises(ValueError, match="scheduled") as got:
        rewrite_program(tprog, tcode, engine="unrolled", tableau="frames",
                        device="cpu")
    with pytest.raises(ValueError) as want:
        JEncodedProgram(jprog, jcode, engine="unrolled", tableau="frames")
    assert str(got.value) == str(want.value)


# -- frames against unpacked, bit for bit ---------------------------------------------

# path 13 (b)'s three cases, the rates raised so that faults occur at B=64
EQ_CASES = {
    "gate_meas_reset": (dict(p_gate1=1e-3, p_gate2=2e-3, p_meas=3e-3,
                             p_reset=3e-3), {}),
    "idle": (dict(p_gate2=2e-3, p_meas=2e-3, p_idle=2e-3), {}),
    "ec2_dedicated": (dict(p_gate2=2e-3, p_meas=5e-3),
                      dict(ec_extractions=2, ancillas="dedicated")),
}


@pytest.fixture(scope="module")
def steane():
    # one code object, so `reference_outcomes` keeps each program's
    # outcomes across the tests that encode it
    return tfam.steane()


@pytest.fixture(scope="module")
def x_macro(steane):
    macro = tsched.lower(fp.x_program(), steane)
    return steane, macro, tsched.reference_outcomes(macro, steane,
                                                    device="cpu")


@pytest.mark.parametrize("case", list(EQ_CASES))
def test_frames_equal_unpacked(case, x_macro):
    """Drift mode (1), test_ftqc_frames.py:128 and :144, test_idle.py:80:
    one seed, the same registers, prep_fail, frames and votes."""
    rates, options = EQ_CASES[case]
    code, macro, refs = x_macro
    noise = tnoise.NoiseModel(**rates)
    states = {}
    for tableau in ("frames", "unpacked"):
        ex = tsched.MacroExecutor(code, 1, noise, tableau_engine=tableau,
                                  device="cpu", **options)
        states[tableau] = ex.execute(macro, 64, seed=11,
                                     ref_outs=refs if tableau == "frames"
                                     else None)
    f, u = states["frames"], states["unpacked"]
    for field in ("memory", "prep_fail", "x_frames", "z_frames", "votes"):
        assert torch.equal(getattr(f, field), getattr(u, field)), field
    assert bool(f.tab.x.any() or f.tab.z.any())       # faults struck
    assert bool(f.x_frames.any() or f.z_frames.any())


# -- parallel EC --------------------------------------------------------------------------

def _two_block():
    p = Program()
    ro = p.declare("ro", 2)
    p.x(0).x(1).measure(0, ro[0]).measure(1, ro[1])
    return p


def test_parallel_ec_validation():
    """test_idle.py:135: both refusals, the reference's types and
    messages."""
    tprog, tcode = fp.build("x")
    jprog, jcode = fp.build("x", _jax_ir())
    for kw in (dict(tableau="frames", ec_schedule="parallel"),
               dict(tableau="unpacked", ancillas="dedicated",
                    ec_schedule="parallel")):
        with pytest.raises(ValueError) as got:
            rewrite_program(tprog, tcode, device="cpu", **kw)
        with pytest.raises(ValueError) as want:
            JEncodedProgram(jprog, jcode, **kw)
        assert str(got.value) == str(want.value)


def test_parallel_ec_exact_noiseless(steane):
    """test_idle.py:129-133 at B=8: the parallel machinery keeps the
    deterministic outcomes."""
    out = rewrite_program(_two_block(), steane, tableau="frames",
                          ancillas="dedicated", ec_schedule="parallel",
                          device="cpu").run(8)
    assert (out["ro"] == [1, 1]).all() and not out["__prep_fail__"].any()


def test_parallel_ec_wins_under_idle(steane):
    """test_idle.py:103-128 at B=512: parallel fails less than half as
    often as serial, and each count agrees with the reference's recorded
    one (two-sample 99.9%)."""
    noise = tnoise.NoiseModel(p_gate2=3e-4, p_idle=3e-4)
    fails = {}
    for sched in ("parallel", "serial"):
        out = rewrite_program(_two_block(), steane, noise=noise,
                              tableau="frames", ancillas="dedicated",
                              ec_schedule=sched, device="cpu"
                              ).run(PAR_BATCH, 2)
        fails[sched] = int((out["ro"] != [1, 1]).any(axis=1).sum())
    ref_p, ref_s, ref_n = REF_PARALLEL_4096
    assert fails["parallel"] * 2 < fails["serial"], fails
    assert _two_sample_ok(fails["parallel"], PAR_BATCH, ref_p, ref_n), fails
    assert _two_sample_ok(fails["serial"], PAR_BATCH, ref_s, ref_n), fails


def test_parallel_ec_charges_idle_after_commit(steane):
    """Drift mode (4), schedule.py:985-993: with idle noise alone, a
    one-block program charges parallel and serial EC the same idle, so
    their failure counts agree (the bug the ordering fixes made parallel
    'beat' serial 6.7x here)."""
    noise = tnoise.NoiseModel(p_idle=4e-3)
    fails = {}
    for sched in ("parallel", "serial"):
        out = rewrite_program(fp.x_program(), steane, noise=noise,
                              tableau="frames", ancillas="dedicated",
                              ec_schedule=sched, device="cpu").run(512, 4)
        fails[sched] = int((out["ro"][:, 0] != 1).sum())
    assert fails["serial"] > 20, fails
    assert _two_sample_ok(fails["parallel"], 512, fails["serial"], 512), fails
