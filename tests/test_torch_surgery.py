"""The port's lattice surgery — the bespoke merges, the surgery CNOT, the
T gadget's two sectors and the circuit-level merge
(`qcss_tpu_torch.experiments.surgery`, `.surgery_t`, `.surgery_circuit`)
— against the JAX package's, on the CPU.

The builders are copies, so their models must equal the reference's
array for array at d=3 (F, obs, fault classes or priors, every graph
array, weighted and unweighted): that equality is what lets them inherit
the reference's statevector and tableau golds (tests/test_surgery.py,
test_surgery_t.py; 2^21 amplitudes), which these tests do not re-run.
Decodes of given detectors are deterministic and held exactly. The
samplers draw from torch generators, so they are held by rates: each
port count against the reference's by a two-sample 99.9% test. Each test
names the reference test it stands in for and stays far below its size.
"""

import math

import numpy as np
import pytest
import torch

from qcss_tpu.experiments import surgery as jsg
from qcss_tpu.experiments import surgery_circuit as jsc
from qcss_tpu.experiments import surgery_t as jst
from qcss_tpu.sim.noise import NoiseModel as JNoise
from qcss_tpu_torch.decode.uf import UFDecoder
from qcss_tpu_torch.experiments import surgery as tsg
from qcss_tpu_torch.experiments import surgery_circuit as tsc
from qcss_tpu_torch.experiments import surgery_t as tst
from qcss_tpu_torch.sim.noise import NoiseModel as TNoise

Z999 = 3.2905
CPU = torch.device("cpu")

# (name, args at d=3): the bespoke builders, as the reference's tests
# build them
BUILDERS = [
    ("build_xx_merge", jsg, tsg, (3, 3, 3)),
    ("build_xx_merge_split", jsg, tsg, (3, 3, 3, 3)),
    ("build_surgery_cnot", jsg, tsg, (3, 3)),
    ("build_zz_merge_split", jst, tst, (3, 3, 3, 3)),
    ("build_merge_readout_sector", jst, tst, (3, 3, 3, 3)),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # several worker processes run at once; see test_torch_device_uf.py
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _two_sample_ok(k1, k2, n):
    pooled = (k1 + k2) / (2 * n)
    spread = Z999 * math.sqrt(pooled * (1 - pooled) * 2 / n)
    return abs(k1 - k2) / n <= spread


def _assert_graph_equal(gt, gj):
    assert gt.num_nodes == gj.num_nodes and gt.n_qubits == gj.n_qubits
    for attr in ("edges", "edge_qubit", "edge_obs", "edge_weight"):
        a, b = getattr(gt, attr), getattr(gj, attr)
        assert (a is None) == (b is None), attr
        if a is not None:
            np.testing.assert_array_equal(a, b)


def _assert_model_equal(mt, mj):
    for attr in ("F", "obs", "fault_probs_class"):
        np.testing.assert_array_equal(getattr(mt, attr), getattr(mj, attr))
    _assert_graph_equal(mt.graph, mj.graph)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name,jmod,tmod,args", BUILDERS,
                         ids=[b[0] for b in BUILDERS])
def test_builders_bit_identical(name, jmod, tmod, args, weighted):
    # stands in for test_surgery.py::TestModel::test_build_d3 and
    # test_weighted_graph_runs, and inherits every statevector and
    # tableau gold of test_surgery.py and test_surgery_t.py
    kw = dict(p=4e-3, q=8e-3) if weighted else {}
    _assert_model_equal(getattr(tmod, name)(*args, **kw),
                        getattr(jmod, name)(*args, **kw))


def test_two_merged_rounds_refused():
    # test_surgery.py::TestMergeSplitCycle::test_two_merged_rounds_refused
    for build in (jsg.build_xx_merge_split, tsg.build_xx_merge_split):
        with pytest.raises(ValueError, match="rounds_merged >= 3"):
            build(3, 2, 2, 2)


@pytest.mark.parametrize("name,args", [("build_xx_merge", (3, 3, 3)),
                                       ("build_surgery_cnot", (3, 3))])
def test_sampler_on_given_faults_is_the_matmul(name, args):
    model = getattr(tsg, name)(*args)
    rng = np.random.default_rng(5)
    faults = (rng.random((64, model.F.shape[1])) < 0.05).astype(np.uint8)
    dets, ob = tsg._sample(None, 0.0, 0.0, 64,
                           *tsg._model_tensors(model, CPU),
                           faults=torch.as_tensor(faults))
    np.testing.assert_array_equal(
        dets.numpy(), (faults.astype(np.int64) @ model.F.T) & 1)
    np.testing.assert_array_equal(
        ob.numpy(), (faults.astype(np.int64) @ model.obs.T) & 1)


def test_quiet_runs_are_exact():
    # test_surgery.py::TestModel::test_quiet_run_is_exact and the quiet
    # halves of TestMergeSplitCycle, TestSurgeryCnot and
    # test_surgery_t.py::TestModels::test_quiet_and_single_faults
    kw = dict(batch=128, seed=0, device=CPU)
    for out in (tsg.xx_merge_memory(3, 0.0, 0.0, **kw),
                tsg.xx_merge_split_memory(3, 0.0, 0.0, **kw),
                tsg.surgery_cnot_memory(3, 0.0, 0.0, **kw),
                tst.t_gadget_memory(3, 0.0, 0.0, **kw)):
        fails = [v for k, v in out.items() if k.endswith("_fail")]
        assert len(fails) >= 3 and not any(fails), out


@pytest.mark.parametrize("name,jmod,tmod,args", BUILDERS,
                         ids=[b[0] for b in BUILDERS])
def test_every_single_fault_decodes_exactly(name, jmod, tmod, args):
    # the single-fault halves of the same reference tests: each fault's
    # own signature decodes to its own observable effect
    model = getattr(tmod, name)(*args)
    _, corr = UFDecoder(model.graph).decode_batch(
        model.F.T.astype(np.uint8), want_corrections=False)
    for i in range(model.obs.shape[0]):
        bad = np.nonzero(model.obs[i] ^ ((corr >> i) & 1))[0]
        assert bad.size == 0, (i, bad[:10])


RATES = [
    ("xx_merge_memory", jsg, tsg, ("m_fail", "logical_fail", "word_fail")),
    ("xx_merge_split_memory", jsg, tsg,
     ("m_fail", "xa_fail", "xb_fail", "word_fail")),
    ("surgery_cnot_memory", jsg, tsg, ("zc_fail", "zt_fail", "word_fail")),
    ("t_gadget_memory", jst, tst, ("m1_fail", "zd_fail", "out_fail")),
]


@pytest.mark.parametrize("name,jmod,tmod,keys", RATES,
                         ids=[r[0] for r in RATES])
def test_sampled_rates_match_reference(name, jmod, tmod, keys):
    # stands in for the suppression tests (test_surgery.py::
    # TestSuppression, test_surgery_t.py::test_suppression_with_distance):
    # at d=3, p=1e-2, B=8192 every channel's count against the reference's
    B, p = 8192, 1e-2
    ref = getattr(jmod, name)(3, p, batch=B, seed=3)
    got = getattr(tmod, name)(3, p, batch=B, seed=3, device=CPU)
    for k in keys:
        kr, kp = round(ref[k] * B), round(got[k] * B)
        assert kr > 20, (k, kr)
        assert _two_sample_ok(kp, kr, B), (k, kp, kr)


def test_merge_split_d5_rate_matches_reference():
    """The merge-split cycle at BASELINE.md's configuration (d=5,
    p=q=4e-3, 32,768 shots), where the card's counts sit above
    BASELINE.md's published rates: the port's counts against the
    reference's own code's, channel by channel."""
    B = 32768
    ref = jsg.xx_merge_split_memory(5, 4e-3, batch=B, seed=1)
    got = tsg.xx_merge_split_memory(5, 4e-3, batch=B, seed=1, device=CPU)
    for k in ("m_fail", "xa_fail", "xb_fail", "word_fail"):
        kr, kp = round(ref[k] * B), round(got[k] * B)
        assert _two_sample_ok(kp, kr, B), (k, kp, kr)


# -- circuit level ------------------------------------------------------------

NOISE = dict(p_gate1=1e-3, p_gate2=1e-3, p_meas=1e-3, p_reset=1e-3)


def test_circuit_builder_bit_identical():
    # stands in for the model half of test_surgery_circuit.py
    mj = jsc.build_xx_merge_circuit(3, 3, 3, JNoise(**NOISE))
    mt = tsc.build_xx_merge_circuit(3, 3, 3, TNoise(**NOISE))
    for attr in ("F", "priors", "obs"):
        np.testing.assert_array_equal(getattr(mt, attr), getattr(mj, attr))
    assert mt.fault_sigs == mj.fault_sigs


def _fault_bits(meta, geo):
    """The `_sample_circuit` ``faults`` dict that injects the one fault
    component an enumerator placement names."""
    n = geo["n"]
    kind = meta[0]
    if kind == "seam":
        bits = np.zeros((1, len(geo["seam"])), np.uint8)
        bits[0, geo["seam"].index(meta[1])] = 1
        return {"seam": bits}
    phase, t = meta[1], meta[-1]
    h = geo["hx_split"] if phase == 0 else geo["hx_M"]
    if kind in ("meas", "reset"):
        bits = np.zeros((1, h.shape[0]), np.uint8)
        bits[0, meta[2]] = 1
        return {(kind, phase, t): bits}
    ops, _ = tsc._x_extraction_ops(h, n)
    k, q = meta[2], meta[3]
    col = 4 * k + (2 if ops[k][0] == "cnot" and q == ops[k][2] else 0)
    col += 1 if kind.endswith("z") else 0
    bits = np.zeros((1, 4 * len(ops)), np.uint8)
    bits[0, col] = 1
    return {("gates", phase, t): bits}


def _fault_class(meta, geo, R1):
    """(class, phase) of an enumerated fault component."""
    kind = meta[0]
    if kind == "seam":
        return kind, 1
    phase = meta[1]
    if kind in ("2qx", "2qz"):
        h = geo["hx_split"] if phase == 0 else geo["hx_M"]
        ops, _ = tsc._x_extraction_ops(h, geo["n"])
        kind += "_data" if meta[3] == ops[meta[2]][2] else "_anc"
    if kind == "reset" and phase == 0 and meta[-1] == R1 - 1:
        kind = "reset_carry"
    return kind, phase


def test_circuit_sampler_reproduces_enumerated_faults():
    """test_surgery_circuit.py::test_enumerator_matches_frame_injection:
    one component of every fault class in each phase (both sides of a
    CNOT, both components of an H, measurement and reset flips, a split
    reset that carries into the merge, a seam init error), injected into
    the port's sampler (`run_arrays_noisy(fault_bits=)` and friends),
    gives the enumerator's detector signature and observable effect."""
    R1 = R2 = 3
    noise = TNoise(**NOISE)
    model = tsc.build_xx_merge_circuit(3, R1, R2, noise)
    geo = tsc._merge_geometry(3)
    tested = set()
    for dets_want, ob_want, meta in model.fault_sigs:
        cls = _fault_class(meta, geo, R1)
        if cls in tested:
            continue
        tested.add(cls)
        dets, m, xm = tsc._sampled_detectors(
            None, 1, R1, R2, geo, noise, device=CPU,
            faults=_fault_bits(meta, geo))
        assert tuple(np.nonzero(dets[0].numpy())[0]) == dets_want, meta
        assert int(m[0]) | (int(xm[0]) << 1) == ob_want, meta
    assert {c for c, _ in tested} == {
        "2qx_data", "2qx_anc", "2qz_data", "2qz_anc", "1qx", "1qz", "meas",
        "reset", "reset_carry", "seam"}


def test_circuit_merge_near_quiet_is_exact():
    # test_surgery_circuit.py::test_circuit_merge_near_quiet_is_exact
    noise = TNoise(p_gate2=1e-9, p_gate1=1e-9, p_meas=1e-9, p_reset=1e-9)
    out = tsc.xx_merge_circuit_memory(3, noise, batch=256, seed=3,
                                      device=CPU)
    assert out["m_fail"] == 0.0 and out["logical_fail"] == 0.0
    assert out["bp_converged"] == 1.0
