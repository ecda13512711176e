"""Entry points (PyTorch port of the JAX package's
__graft_entry__.py).

`entry()` — a forward step on the flagship pipeline (the Steane Monte-Carlo
decode: syndrome extraction, LUT decode and the logical-failure check,
through the packed kernels K8 then K6 on the card) with example args.

`dryrun_multichip(n)` — builds an n-device mesh (`parallel.make_mesh`) and
runs, at tiny shapes, every sharded pipeline the reference's dry run
names, checking each result's range and the FT program's exact outcome.

    from qcss_tpu_torch.entry import dryrun_multichip, entry
    forward, args = entry()            # entry("cpu") on the CPU
    print(forward(*args))
    dryrun_multichip(2, devices=["cuda:0"] * 2)   # ["cpu"] * 2 on the CPU
"""

from __future__ import annotations

import numpy as np
import torch

from qcss_tpu_torch._cuda import resolve_device


def entry(device="cuda"):
    """(forward, args): ``forward(x_err, z_err)`` decodes a batch of Steane
    X and Z errors on ``device`` (the card by default) and returns the
    per-key failure counts (``x_fail``, ``z_fail``, ``word_fail``) as 0-d
    int32 tensors; ``args`` are 256 random error pairs from
    ``np.random.default_rng(0)``, as the reference's."""
    from qcss_tpu_torch.codes import families
    from qcss_tpu_torch.decode import montecarlo

    device = resolve_device(device)
    code = families.steane()
    sectors = montecarlo.packed_sectors(code, device)

    def forward(x_err, z_err):
        x = torch.as_tensor(np.asarray(x_err, np.uint8), device=device)
        z = torch.as_tensor(np.asarray(z_err, np.uint8), device=device)
        fails = montecarlo.decode_failures_packed(x, z, *sectors)
        return {k: v.sum(dtype=torch.int32) for k, v in fails.items()}

    rng = np.random.default_rng(0)
    batch = 256
    x_err = rng.integers(0, 2, size=(batch, code.n)).astype(np.uint8)
    z_err = rng.integers(0, 2, size=(batch, code.n)).astype(np.uint8)
    return forward, (x_err, z_err)


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """The reference's sharded paths over an ``n_devices`` mesh, tiny
    shapes: the Monte-Carlo decode; the FT-encoded X program (every shot
    must measure 1); the frame-sampled memory decoded on the host; the
    fused memory with the dense and the hybrid sparse decoder; the qLDPC
    phenomenological and circuit-level BP memories; the magic-state
    factory; the compiled lattice-surgery CNOT; the two-level memory; the
    soft-readout memory; the exact-ML memory; and the parallel-window
    memory.

    The mesh is `make_mesh(n_devices)` over every card, or over
    ``devices`` when given (the card named n times where the machine has
    fewer, or CPU devices in the tests). It never shrinks n: fewer than n
    devices raise. Returns each pipeline's result by name."""
    from qcss_tpu_torch import parallel as par
    from qcss_tpu_torch.circuits import Program
    from qcss_tpu_torch.codes import families
    from qcss_tpu_torch.experiments import LogicalProgram
    from qcss_tpu_torch.ftqc import rewrite_program
    from qcss_tpu_torch.sim.noise import NoiseModel

    mesh = par.make_mesh(n_devices, devices=devices)
    assert mesh.size == n_devices
    home = mesh.devices[0]
    out = {}

    code = families.steane()
    counts = par.sharded_mc_step(code, mesh, 0, batch=8 * n_devices, p=0.1)
    assert int(counts["word_fail"]) >= 0
    out["sharded_mc_step"] = {k: int(v) for k, v in counts.items()}

    prog = Program()
    ro = prog.declare("ro", 1)
    prog.x(0).measure(0, ro[0])
    enc = rewrite_program(prog, code, device=home)
    res = par.sharded_ftqc_run(enc, mesh, batch=n_devices, seed=1)
    ro_bits = res["ro"].cpu().numpy()
    assert ro_bits.shape == (n_devices, 1)
    assert (ro_bits[:, 0] == 1).all(), "FT-encoded X program must measure 1"
    out["sharded_ftqc_run"] = ro_bits[:, 0].tolist()

    surf = families.rotated_surface(3, max_table_weight=0, t=1)
    sfm = par.ShardedFrameMemory(
        surf, NoiseModel(p_gate2=1e-3, p_meas=5e-3), mesh)
    # graph_kind 'uf' is the phenomenological spacetime graph (the
    # reference's dry run names it 'spacetime')
    runs = {
        "ShardedFrameMemory.error_rate": lambda: sfm.error_rate(
            rounds=2, batch=4 * n_devices, seed=2, decoder="uf"),
        "ShardedFrameMemory.fused_error_rate": lambda: sfm.fused_error_rate(
            rounds=2, batch=4 * n_devices, seed=3, graph_kind="uf"),
        # the sparse union-find (hybrid: the dense kernel rescues the shots
        # past d_max) inside the same pipeline
        "ShardedFrameMemory.fused_error_rate(hybrid)":
            lambda: sfm.fused_error_rate(
                rounds=2, batch=4 * n_devices, seed=12,
                graph_kind="uf", decoder="hybrid", d_max=16),
        "sharded_bp_memory": lambda: par.sharded_bp_memory(
            families.bb72(), mesh, rounds=2, p=2e-3, q=2e-3,
            batch=4 * n_devices, seed=4, iters=12),
        "sharded_qldpc_circuit_memory":
            lambda: par.sharded_qldpc_circuit_memory(
                code, mesh, rounds=2,
                noise=NoiseModel(p_gate2=1e-3, p_meas=2e-3),
                batch=4 * n_devices, seed=5, iters=12),
        "sharded_magic_factory": lambda: par.sharded_magic_factory(
            mesh, NoiseModel(p_gate2=1e-3, p_meas=1e-3), 0.01,
            4 * n_devices, seed=6),
        "sharded_logical_program": lambda: par.sharded_logical_program(
            LogicalProgram(3, 2).cnot(0, 1).build(), mesh, p=2e-3,
            batch=4 * n_devices, seed=7),
        "sharded_two_level_memory": lambda: par.sharded_two_level_memory(
            3, 2, 1, mesh, p=2e-3, batch=4 * n_devices, seed=8),
        "sharded_soft_memory": lambda: par.sharded_soft_memory(
            surf, mesh, rounds=2, p=3e-3, sigma=0.7, batch=4 * n_devices,
            seed=9),
        "sharded_mld_memory": lambda: par.sharded_mld_memory(
            surf, mesh, p=0.05, batch=4 * n_devices, seed=10),
        "sharded_parallel_window_memory":
            lambda: par.sharded_parallel_window_memory(
                surf, mesh, rounds=16, p=4e-3, q=4e-3,
                batch=4 * n_devices, core=3, buf=3, seed=11),
    }
    rate_keys = {"sharded_bp_memory": ("x_fail",),
                 "sharded_qldpc_circuit_memory": ("x_fail",),
                 "sharded_magic_factory": ("p_out", "p_accept"),
                 "sharded_logical_program": ("word_fail", "z1_fail"),
                 "sharded_two_level_memory": ("word_fail_l1",
                                              "word_fail_l2"),
                 "sharded_mld_memory": ("word_fail",)}
    for name, run in runs.items():
        res = run()
        for key in rate_keys.get(name, ("logical_fail",)):
            assert 0.0 <= res[key] <= 1.0, (name, key, res[key])
        if name == "sharded_magic_factory":
            assert res["p_accept"] > 0.0
        out[name] = res
    return out
