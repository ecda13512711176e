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
    "qcss_tpu_torch.benchmarks.bp_bench",
    "qcss_tpu_torch.benchmarks.device_uf_bench",
    "qcss_tpu_torch.benchmarks.profiling",
    "qcss_tpu_torch.benchmarks.pw_bench",
    "qcss_tpu_torch.benchmarks.staged_bench",
    "qcss_tpu_torch.benchmarks.steane_mc",
    "qcss_tpu_torch.benchmarks.stream_bench",
    "qcss_tpu_torch.benchmarks.syndrome_sweep",
    "qcss_tpu_torch.benchmarks.tableau_bench",
    "qcss_tpu_torch.benchmarks.uf_bench",
    "qcss_tpu_torch.circuits",
    "qcss_tpu_torch.codes",
    "qcss_tpu_torch.codes.distance",
    "qcss_tpu_torch.codes.symplectic",
    "qcss_tpu_torch.decode",
    "qcss_tpu_torch.decode.blossom",
    "qcss_tpu_torch.decode.bp",
    "qcss_tpu_torch.decode.bp_dem",
    "qcss_tpu_torch.decode.bp_streaming",
    "qcss_tpu_torch.decode.calibrate",
    "qcss_tpu_torch.decode.classical",
    "qcss_tpu_torch.decode.dem2",
    "qcss_tpu_torch.decode.device_sparse",
    "qcss_tpu_torch.decode.device_sparse_cuda",
    "qcss_tpu_torch.decode.device_uf",
    "qcss_tpu_torch.decode.device_streaming",
    "qcss_tpu_torch.decode.device_uf_cuda",
    "qcss_tpu_torch.decode.device_uf_staged",
    "qcss_tpu_torch.decode.lut",
    "qcss_tpu_torch.decode.montecarlo",
    "qcss_tpu_torch.decode.multiround",
    "qcss_tpu_torch.decode.mwpm",
    "qcss_tpu_torch.decode.parallel_window",
    "qcss_tpu_torch.decode.spacetime",
    "qcss_tpu_torch.decode.streaming",
    "qcss_tpu_torch.decode.sweep",
    "qcss_tpu_torch.decode.uf",
    "qcss_tpu_torch.experiments.memory",
    "qcss_tpu_torch.experiments.memory_qldpc",
    "qcss_tpu_torch.experiments.memory_xz",
    "qcss_tpu_torch.ftqc",
    "qcss_tpu_torch.ftqc.engines",
    "qcss_tpu_torch.native",
    "qcss_tpu_torch.ops.cuda_gf2",
    "qcss_tpu_torch.ops.gf2",
    "qcss_tpu_torch.ops.gf2_torch",
    "qcss_tpu_torch.sim.cuda_measure",
    "qcss_tpu_torch.sim.frame",
    "qcss_tpu_torch.sim.noise",
    "qcss_tpu_torch.sim.statevec",
    "qcss_tpu_torch.sim.tableau",
    "qcss_tpu_torch.sim.tableau_packed",
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
    return (ROOT / "qcss_tpu" / rel).read_text().replace(
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
            "decode/bp_streaming.py"]


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
]


@pytest.mark.parametrize("rel,names", COPIED_DEFS,
                         ids=[r for r, _ in COPIED_DEFS])
def test_copied_definitions(rel, names):
    assert _segments(_port(rel), names) == _segments(_rewired(rel), names)


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
