"""The PyTorch port's package boundary and its copies of the host layer.

* `import qcss_tpu_torch` (and every module of it) must leave jax and the
  JAX package out of the process;
* the host-only modules copied from the JAX package must equal their
  originals once the `qcss_tpu.` imports are rewritten (exact text), and
  so must the copied definitions of the modules that are partly ported;
* codes and circuit-level graphs built by both packages must be equal
  array for array (exact: the construction is integer/GF(2) math).
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qcss_tpu.codes.families import rotated_surface as jax_surface
from qcss_tpu.decode import dem as jax_dem
from qcss_tpu_torch.codes.families import rotated_surface as torch_surface
from qcss_tpu_torch.decode import dem as torch_dem

ROOT = Path(__file__).resolve().parent.parent

PORT_MODULES = [
    "qcss_tpu_torch",
    "qcss_tpu_torch._cuda",
    "qcss_tpu_torch.benchmarks.belief_bench",
    "qcss_tpu_torch.benchmarks.bp_bench",
    "qcss_tpu_torch.benchmarks.breakeven",
    "qcss_tpu_torch.benchmarks.breakeven_probe",
    "qcss_tpu_torch.benchmarks.device_uf_bench",
    "qcss_tpu_torch.benchmarks.error_curve",
    "qcss_tpu_torch.benchmarks.fidelity",
    "qcss_tpu_torch.benchmarks.flag_bench",
    "qcss_tpu_torch.benchmarks.ftqc_bench",
    "qcss_tpu_torch.benchmarks.ftqc_programs",
    "qcss_tpu_torch.benchmarks.headline",
    "qcss_tpu_torch.benchmarks.idle_bench",
    "qcss_tpu_torch.benchmarks.magic_bench",
    "qcss_tpu_torch.benchmarks.memory_bench",
    "qcss_tpu_torch.benchmarks.profiling",
    "qcss_tpu_torch.benchmarks.roofline",
    "qcss_tpu_torch.benchmarks.rref_bench",
    "qcss_tpu_torch.benchmarks.sideinfo_bench",
    "qcss_tpu_torch.benchmarks.surgery_bench",
    "qcss_tpu_torch.benchmarks.pw_bench",
    "qcss_tpu_torch.benchmarks.staged_bench",
    "qcss_tpu_torch.benchmarks.steane_mc",
    "qcss_tpu_torch.benchmarks.stream_bench",
    "qcss_tpu_torch.benchmarks.syndrome_sweep",
    "qcss_tpu_torch.benchmarks.tableau_bench",
    "qcss_tpu_torch.benchmarks.threshold",
    "qcss_tpu_torch.benchmarks.uf_bench",
    "qcss_tpu_torch.circuits",
    "qcss_tpu_torch.codes",
    "qcss_tpu_torch.codes.distance",
    "qcss_tpu_torch.codes.symplectic",
    "qcss_tpu_torch.decode",
    "qcss_tpu_torch.decode.belief",
    "qcss_tpu_torch.decode.blossom",
    "qcss_tpu_torch.decode.bp",
    "qcss_tpu_torch.decode.bp_dem",
    "qcss_tpu_torch.decode.bp_streaming",
    "qcss_tpu_torch.decode.calibrate",
    "qcss_tpu_torch.decode.classical",
    "qcss_tpu_torch.decode.correlated",
    "qcss_tpu_torch.decode.dem2",
    "qcss_tpu_torch.decode.device_sparse",
    "qcss_tpu_torch.decode.device_sparse_cuda",
    "qcss_tpu_torch.decode.device_uf",
    "qcss_tpu_torch.decode.device_streaming",
    "qcss_tpu_torch.decode.device_uf_cuda",
    "qcss_tpu_torch.decode.device_uf_staged",
    "qcss_tpu_torch.decode.fault_distance",
    "qcss_tpu_torch.decode.lut",
    "qcss_tpu_torch.decode.mld",
    "qcss_tpu_torch.decode.montecarlo",
    "qcss_tpu_torch.decode.multiround",
    "qcss_tpu_torch.decode.mwpm",
    "qcss_tpu_torch.decode.parallel_window",
    "qcss_tpu_torch.decode.spacetime",
    "qcss_tpu_torch.decode.streaming",
    "qcss_tpu_torch.decode.sweep",
    "qcss_tpu_torch.decode.uf",
    "qcss_tpu_torch.entry",
    "qcss_tpu_torch.examples.demo",
    "qcss_tpu_torch.experiments.concatenated",
    "qcss_tpu_torch.experiments.erasure",
    "qcss_tpu_torch.experiments.injection",
    "qcss_tpu_torch.experiments.leakage",
    "qcss_tpu_torch.experiments.logical",
    "qcss_tpu_torch.experiments.memory",
    "qcss_tpu_torch.experiments.memory_qldpc",
    "qcss_tpu_torch.experiments.memory_xz",
    "qcss_tpu_torch.experiments.patches",
    "qcss_tpu_torch.experiments.protocol",
    "qcss_tpu_torch.experiments.resources",
    "qcss_tpu_torch.experiments.schedule_circuit",
    "qcss_tpu_torch.experiments.soft",
    "qcss_tpu_torch.experiments.surgery",
    "qcss_tpu_torch.experiments.surgery_circuit",
    "qcss_tpu_torch.experiments.surgery_t",
    "qcss_tpu_torch.ftqc",
    "qcss_tpu_torch.ftqc.engines",
    "qcss_tpu_torch.ftqc.executor",
    "qcss_tpu_torch.ftqc.flags",
    "qcss_tpu_torch.ftqc.magic",
    "qcss_tpu_torch.ftqc.rewrite",
    "qcss_tpu_torch.ftqc.schedule",
    "qcss_tpu_torch.native",
    "qcss_tpu_torch.ops.cuda_gf2",
    "qcss_tpu_torch.parallel",
    "qcss_tpu_torch.parallel.mesh",
    "qcss_tpu_torch.ops.gf2",
    "qcss_tpu_torch.ops.gf2_torch",
    "qcss_tpu_torch.sim.cuda_measure",
    "qcss_tpu_torch.sim.frame",
    "qcss_tpu_torch.sim.noise",
    "qcss_tpu_torch.sim.statevec",
    "qcss_tpu_torch.sim.tableau",
    "qcss_tpu_torch.sim.tableau_packed",
    "qcss_tpu_torch.utils.profiling",
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The suite runs in several worker processes at once; torch's intra-op
    # threads would oversubscribe the cores and spin, and these tensors are
    # small enough that one thread is fastest anyway.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_import_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'qcss_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _rewired(rel: str) -> str:
    # the JAX package's benchmarks live beside it, at the repo's root
    base = ROOT if rel.startswith("benchmarks/") else ROOT / "qcss_tpu"
    return (base / rel).read_text().replace(
        "qcss_tpu.", "qcss_tpu_torch.").replace(
        "from qcss_tpu import", "from qcss_tpu_torch import")


def _port(rel: str) -> str:
    return (ROOT / "qcss_tpu_torch" / rel).read_text()


def _segments(text: str, names) -> dict:
    """Exact source text of the named top-level definitions."""
    tree = ast.parse(text)
    out = {}
    for node in tree.body:
        name = getattr(node, "name", None)
        if name is None and isinstance(node, ast.Assign):
            name = getattr(node.targets[0], "id", None)
        if name in names:
            out[name] = ast.get_source_segment(text, node)
    assert set(out) == set(names), set(names) - set(out)
    return out


VERBATIM = ["errors.py", "circuits/ir.py", "circuits/encoding.py",
            "circuits/quil.py", "circuits/__init__.py", "codes/pauli.py",
            "codes/qecc.py", "codes/families.py", "codes/__init__.py",
            "codes/symplectic.py", "codes/distance.py", "decode/dem.py",
            "decode/blossom.py", "decode/calibrate.py", "decode/mwpm.py",
            "sim/statevec.py", "decode/dem2.py", "decode/bp_dem.py",
            "decode/bp_streaming.py", "experiments/resources.py",
            "ftqc/flags.py"]


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy(rel):
    assert _port(rel) == _rewired(rel)


def test_gf2_copy_except_native_loader():
    # The native enumerator's loader is ported (`qcss_tpu_torch.native`),
    # so `_native_table` is the reference's text too: the whole module is.
    assert _port("ops/gf2.py") == _rewired("ops/gf2.py")


def test_css_copy_up_to_device_arrays():
    # CSSCodeDeviceArrays builds torch tensors; everything above it is
    # the reference's text.
    orig, port = _rewired("codes/css.py"), _port("codes/css.py")
    cut = "class CSSCodeDeviceArrays:"
    assert port.split(cut)[0] == orig.split(cut)[0]


COPIED_DEFS = [
    ("decode/uf.py", ["MatchingGraph", "weights_from_probs",
                      "_column_obs_masks", "graph_from_checks",
                      "spacetime_graph", "_decode_one_py",
                      "_decode_batch_py", "UFDecoder", "_pack_parity"]),
    ("native/__init__.py", ["_bind", "available", "syndrome_table_native",
                            "uf_decode_batch_native", "MwpmNativeHandle",
                            "mwpm_create_native", "osd0_batch_native",
                            "osde_batch_native", "rref_native"]),
    ("decode/parallel_window.py", ["_pw_graph"]),
    ("decode/device_sparse.py", ["UNREACH", "SparseTables",
                                 "build_sparse_tables"]),
    ("experiments/memory.py", ["z_extraction_circuit",
                               "x_extraction_circuit"]),
    ("decode/spacetime.py", ["spacetime_check_matrix",
                             "spacetime_correction_lut"]),
    ("decode/streaming.py", ["_window_graph", "StreamingDecoder"]),
    ("decode/bp.py", ["_osde_py", "_check_major_layout",
                      "open_window_tanner", "spacetime_tanner"]),
    ("decode/correlated.py", ["conditional_weights"]),
    ("decode/belief.py", ["_edge_var_table"]),
    ("decode/mld.py", ["__all__", "_CHUNK", "_span_table"]),
    ("experiments/soft.py", ["flip_prob", "sigma_for_flip_prob",
                             "posterior_flip_prob", "_llr_weights",
                             "_combine", "_meas_edge_ids"]),
    ("experiments/erasure.py", ["ERASED_WEIGHT", "_pauli_weight",
                                "_shot_weights", "_space_edge_index"]),
    ("experiments/leakage.py", ["_space_edge_index",
                                "expected_leak_profile"]),
    ("decode/fault_distance.py", ["model_fault_distances"]),
    ("experiments/surgery.py", ["_solve_gf2", "XXMergeModel",
                                "build_xx_merge", "build_xx_merge_split",
                                "_graph_from_signatures",
                                "build_surgery_cnot"]),
    ("experiments/surgery_t.py", ["_vertical_geometry", "_match_partners",
                                  "build_zz_merge_split",
                                  "build_merge_readout_sector"]),
    ("experiments/patches.py", ["Phase", "Readout", "ScheduleModel",
                                "logical", "joint", "readout_bit",
                                "readout_logical", "logical_at",
                                "build_schedule", "parity_chain_model"]),
    ("experiments/surgery_circuit.py", ["_x_extraction_ops", "_walk",
                                        "CircuitMergeModel",
                                        "build_xx_merge_circuit"]),
    ("experiments/logical.py", ["_term_key", "_xor_terms",
                                "t_circuit_report"]),
    ("experiments/schedule_circuit.py", ["round_ops", "_walk",
                                         "CircuitScheduleModel", "_Plan",
                                         "build_circuit_schedule"]),
    ("experiments/concatenated.py", ["repetition_spacetime_graph",
                                     "_build_program"]),
    ("ftqc/schedule.py", ["OP_PREP_ZERO", "OP_GATE", "OP_EC_ALL",
                          "OP_MEASURE_TRIAL", "OP_VOTE_STORE", "OP_CLASSICAL",
                          "OP_NOP", "GATE_IDS", "circuit_depth",
                          "MacroProgram", "lower", "macro_rows"]),
    ("benchmarks/breakeven.py", ["wilson"]),
    ("benchmarks/threshold.py", ["wilson", "make_noise", "crossings"]),
    ("utils/profiling.py", ["Throughput"]),
    ("ftqc/magic.py", ["_default_code", "_check_distillable",
                       "distillation_enumerators", "distill_exact",
                       "distill_cascade"]),
]


@pytest.mark.parametrize("rel,names", COPIED_DEFS,
                         ids=[r for r, _ in COPIED_DEFS])
def test_copied_definitions(rel, names):
    assert _segments(_port(rel), names) == _segments(_rewired(rel), names)


def test_encoded_program_validation_copied():
    # `_validate` is the reference's text; `__init__` keeps its checks and
    # messages (tests/test_torch_ftqc.py holds them over a grid)
    def method(text, name):
        cls = next(node for node in ast.parse(text).body
                   if getattr(node, "name", None) == "EncodedProgram")
        node = next(node for node in cls.body
                    if getattr(node, "name", None) == name)
        return ast.get_source_segment(text, node)

    assert method(_port("ftqc/rewrite.py"), "_validate") == \
        method(_rewired("ftqc/rewrite.py"), "_validate")


def test_fault_distance_copied_up_to_the_witness():
    # The witness is rebuilt by design (tests/test_torch_fault_distance.py:
    # the reference keys hops by endpoints alone); the distance is the
    # reference's text.
    name = ["observable_fault_distance"]
    cut = "    # witness:"
    orig = _segments(_rewired("decode/fault_distance.py"), name)[name[0]]
    port = _segments(_port("decode/fault_distance.py"), name)[name[0]]
    assert port.split(cut)[0] == orig.split(cut)[0]


def test_logical_program_copied_but_its_runners():
    # `run`, `run_full` and `run_circuit` gain `device` and `profile`;
    # every other method of the compiler is the reference's text.
    def methods(text):
        cls = next(node for node in ast.parse(text).body
                   if getattr(node, "name", None) == "LogicalProgram")
        return {node.name: ast.get_source_segment(text, node)
                for node in cls.body if isinstance(node, ast.FunctionDef)}

    orig = methods(_rewired("experiments/logical.py"))
    port = methods(_port("experiments/logical.py"))
    assert set(port) == set(orig)
    runners = {"run", "run_full", "run_circuit"}
    for name in set(orig) - runners:
        assert port[name] == orig[name], name


def test_level2_detectors_copied_up_to_the_concatenation():
    # the one array call that differs: jnp.concatenate(axis=) is
    # torch.cat(dim=) on the port's tensors
    name = ["_level2_detectors"]
    orig = _segments(_rewired("experiments/concatenated.py"), name)[name[0]]
    port = _segments(_port("experiments/concatenated.py"), name)[name[0]]
    assert port == orig.replace("jnp.concatenate(", "torch.cat(").replace(
        "axis=1)", "dim=1)")


def test_device_graph_builders_copied():
    # The builders differ only in how numpy arrays become tensors.
    names = ["_build_stencil", "build_device_graph"]
    orig = _segments(_rewired("decode/device_uf.py"), names)
    port = _segments(_port("decode/device_uf.py"), names)
    for name in names:
        assert port[name] == orig[name].replace("jnp.asarray(", "_t(")


@pytest.mark.parametrize("d", [3, 5])
def test_rotated_surface_equal(d):
    cj, ct = jax_surface(d), torch_surface(d)
    for attr in ("parity_check_c1", "parity_check_c2",
                 "raw_parity_check_c1", "raw_parity_check_c2"):
        np.testing.assert_array_equal(getattr(ct, attr), getattr(cj, attr))
    np.testing.assert_array_equal(ct.z_operator_matrix(),
                                  cj.z_operator_matrix())
    np.testing.assert_array_equal(ct.x_operator_matrix(),
                                  cj.x_operator_matrix())
    dj, dt = cj.device, ct.device
    for attr in ("h1", "h2", "logical_x", "logical_z"):
        np.testing.assert_array_equal(getattr(dt, attr).numpy(),
                                      np.asarray(getattr(dj, attr)))
    for attr in ("h1_packed", "h2_packed"):
        np.testing.assert_array_equal(
            getattr(dt, attr).numpy(),
            np.asarray(getattr(dj, attr)).astype(np.int64))
    assert (dt.lut_c2 is None) == (dj.lut_c2 is None)


@pytest.mark.parametrize("d,rounds", [(3, 3), (5, 5)])
def test_circuit_level_graph_equal(d, rounds):
    code = torch_surface(d)
    raw = code.raw_parity_check_c2
    kw = dict(p_gate2=2e-3, p_meas=1e-2, logicals=code.z_operator_matrix())
    gj = jax_dem.circuit_level_graph(
        raw, jax_dem.extraction_gate_list(code, raw), rounds, **kw)
    gt = torch_dem.circuit_level_graph(
        raw, torch_dem.extraction_gate_list(code, raw), rounds, **kw)
    assert gt.num_nodes == gj.num_nodes and gt.n_qubits == gj.n_qubits
    for attr in ("edges", "edge_qubit", "edge_obs", "edge_weight"):
        np.testing.assert_array_equal(getattr(gt, attr), getattr(gj, attr))
