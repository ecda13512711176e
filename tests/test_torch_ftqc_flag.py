"""The port's flag EC (`ftqc/flags.py`, ``ec_mode='flag'`` on the
'frames' engine) against the JAX package's, on the CPU.

`ftqc/flags.py` is a copy (tests/test_torch_import.py), so its CNOT orders
and hook tables are the reference's; they are held equal array for array
here all the same, on the three codes of the reference's
tests/test_flags.py. The reference's flag executor is never run here (its
compile takes tens of seconds on this CPU). The port is held instead
against

* the reference test's exact outcomes (test_flags.py:78: the noiseless
  two-block program, on Steane at the reference's batch);
* the protocol's single-fault property: a weight-1 X or Z error on any
  Steane data qubit before one `_ec_one_flag` lands in the frame exactly;
* the reference test's fault-tolerance bounds at its sizes and noise
  (test_flags.py:92: 1e-3 at B=16384, 3e-3 at B=8192), and the JAX
  package's recorded failure counts at those points (two-sample 99.9%
  tests; the samplers differ);
* the reference's split order, one for one: the splits a flag round
  takes under every channel, counted from the protocol's structure.
"""

import math

import numpy as np
import pytest
import torch

from qcss_tpu.codes import families as jfam
from qcss_tpu.ftqc import flags as jflags
from qcss_tpu_torch.benchmarks import ftqc_programs as fp
from qcss_tpu_torch.circuits import Program
from qcss_tpu_torch.codes import families as tfam
from qcss_tpu_torch.ftqc import flags as tflags
from qcss_tpu_torch.ftqc import rewrite_program
from qcss_tpu_torch.ftqc import schedule as tsched
from qcss_tpu_torch.sim.noise import NoiseModel

Z999 = 3.2905

# The JAX package's flag-EC Steane X program under NoiseModel(p_gate1=p,
# p_gate2=p, p_meas=p, p_reset=p), 'frames': failures (ro != 1) of the
# batch, from
#   rewrite_program(x, steane(), noise=noise, tableau="frames",
#                   ec_mode="flag").run(B, key=jax.random.key(2))
# (JAX 0.9.0 on the CPU; the reference test's own points and key)
REF_FLAG = {1e-3: (16, 1 << 14), 3e-3: (130, 1 << 13)}

CODES = {
    "steane": lambda fam: fam.steane(),
    "surface3": lambda fam: fam.rotated_surface(3, max_table_weight=1),
    "color3": lambda fam: fam.triangular_color(3),
}


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


def _noise(p):
    return NoiseModel(p_gate1=p, p_gate2=p, p_meas=p, p_reset=p)


@pytest.mark.parametrize("name", list(CODES))
def test_flag_data_equal(name):
    """The CNOT orders, hook tables and idle step counts, array for array
    (test_flags.py:42's codes)."""
    jd = jflags.build_flag_data(CODES[name](jfam))
    td = tflags.build_flag_data(CODES[name](tfam))
    for sector in ("z_sector", "x_sector"):
        js, ts = getattr(jd, sector), getattr(td, sector)
        assert len(js.supports) == len(ts.supports)
        for a, b in zip(js.supports, ts.supports):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(js.cond_lut, ts.cond_lut)
    for field in ("steps_flagged", "steps_unflagged", "idle_steps_flagged",
                  "idle_steps_unflagged"):
        np.testing.assert_array_equal(getattr(jd, field), getattr(td, field))


def test_noiseless_exact():
    """Stands in for test_flags.py:78 (B=32, as there)."""
    p = Program()
    ro = p.declare("ro", 2)
    p.x(0).h(1).cnot(1, 0).cnot(1, 0).h(1)
    p.measure(0, ro[0]).measure(1, ro[1])
    out = rewrite_program(p, tfam.steane(), tableau="frames", ec_mode="flag",
                          device="cpu").run(32, 0)
    assert (out["ro"][:, 0] == 1).all() and (out["ro"][:, 1] == 0).all()
    assert not out["__prep_fail__"].any()


def test_weight1_errors_land_in_the_frame():
    """Shot q carries X on data qubit q, shot 7 + q Z on it; one noiseless
    flag round must put exactly that error in the frame."""
    code = tfam.steane()
    ex = tsched.MacroExecutor(code, 1, tableau_engine="frames",
                              ec_mode="flag", device="cpu")
    n = code.n
    st = ex.initial_state(2 * n, 1, seed=1)
    xf = torch.zeros((2 * n, n), dtype=torch.uint8)
    zf = torch.zeros_like(xf)
    xf[torch.arange(n), torch.arange(n)] = 1
    zf[n + torch.arange(n), torch.arange(n)] = 1
    st = st._replace(tab=ex.engine.inject_block_flips(st.tab, 0, xf, zf))
    st = ex._ec_one_flag(st, 0)
    assert torch.equal(st.x_frames[:, 0], xf)
    assert torch.equal(st.z_frames[:, 0], zf)


def test_first_set_is_argmax():
    """The flag index is the first set bit, as `jnp.argmax` picks it."""
    rng = np.random.default_rng(5)
    bits = (rng.random((512, 6)) < 0.3).astype(np.uint8)
    got = tsched.MacroExecutor._first_set(torch.from_numpy(bits)).numpy()
    want = np.argmax(bits, axis=1)
    has = bits.any(axis=1)
    np.testing.assert_array_equal(got[has], want[has])


@pytest.fixture(scope="module")
def flag_failures():
    """Failures of the flag-EC Steane X program at the reference test's
    points (test_flags.py:92), one run each."""
    out = {}
    for p, (_, batch) in REF_FLAG.items():
        enc = rewrite_program(fp.x_program(), tfam.steane(), noise=_noise(p),
                              tableau="frames", ec_mode="flag", device="cpu")
        res = enc.run(batch, 2)
        out[p] = (int((res["ro"][:, 0] != 1).sum()), batch)
    return out


def test_noisy_ft_scaling(flag_failures):
    """Quadratic suppression, with the reference test's bounds."""
    rate = {p: k / b for p, (k, b) in flag_failures.items()}
    assert 0 < rate[1e-3] < 0.05
    assert rate[3e-3] > 4.5 * rate[1e-3]


@pytest.mark.parametrize("p", list(REF_FLAG))
def test_rate_against_reference(flag_failures, p):
    k, n = flag_failures[p]
    rk, rn = REF_FLAG[p]
    assert _two_sample_ok(k, n, rk, rn), (k, n, rk, rn)


def _round_splits(ex):
    """The splits one flag round takes: per stabilizer a reset (one when
    p_reset), the basis H, every data and flag CNOT and the flag H, one
    each, and the readouts (one each when p_meas); then the idle of the
    other blocks and of the block's own qubits, one each when p_idle."""
    noise, fd = ex.noise, ex._flag
    total = 0
    for flagged in (True, False):
        for sector, x_type in ((fd.z_sector, False), (fd.x_sector, True)):
            for sup in sector.supports:
                w = len(sup)
                splits = w                          # data CNOTs
                splits += 2 if flagged else 0       # flag CNOTs
                if x_type:
                    splits += 2                     # H before and after
                elif flagged:
                    splits += 2                     # flag H in and out
                if noise.p_reset:
                    splits += 1
                if noise.p_meas:
                    splits += 2 if flagged else 1
                total += splits
        if ex._idle_on:
            total += 2
    return total


@pytest.mark.parametrize("rates", [
    {}, {"p_reset": 0.01}, {"p_meas": 0.01}, {"p_idle": 0.01},
    {"p_gate1": 0.01, "p_gate2": 0.01, "p_meas": 0.01, "p_reset": 0.01,
     "p_idle": 0.01}], ids=str)
def test_round_split_order(rates):
    """One round of `_ec_one_flag` on a two-block executor takes exactly
    the reference's splits (schedule.py:677-871), whatever the shots
    need: the second extraction runs over the whole batch."""
    ex = tsched.MacroExecutor(tfam.steane(), 2, NoiseModel(**rates),
                              tableau_engine="frames", ec_mode="flag",
                              device="cpu")
    st = ex.initial_state(16, 1, seed=4)
    ex._ec_one_flag(st, 0)
    assert ex._splits == _round_splits(ex)
