"""Times of the fused CHP measurement kernel K9 (`chp_measure`) and the
sparse growth kernel K2 (`sparse_growth`) on the card, at the shapes their
main paths give them, beside their bounds.

K9 runs on the tableau bench's ladder state (n = 49, 121, 363, B = 4096,
its 32 evenly spaced qubits: every outcome random) and, for its
deterministic branch, on random Clifford states at n = 121 and 363 whose
32 qubits were measured once before (every outcome deterministic). K2
runs on the d=11 R=11 circuit-level detectors of `chip_smoke.py` step 4
(B = 16384, d_max = 48). For each case, by CUDA events:

* ``ms``: the wrapper (`cuda_measure.measure_many_cuda`,
  `device_sparse_cuda.sparse_decode_cuda`) back to back, its checks,
  allocations and ctypes call included; ``host_ms``, the host's time a
  wrapper call;
* ``hot_ms``: device time a launch of the bare C entry point on
  preallocated outputs, from a CUDA graph of launches on one buffer;
* ``cold_ms``: the same, its launches taken in turn over copies of the
  inputs and outputs that together exceed three times the 50 MB L2, so
  that each launch finds its data in device memory. The kernel is judged
  against its bound on this one;
* ``plain_ms``: the plain version (`tableau_packed.measure_many`,
  `device_sparse._sparse_plain`); no single PyTorch call computes either
  function (``library_ms`` null);

beside the bound (`profiling.bound`): each input byte read once and each
output byte written once at 3.35 TB/s, or the integer operations the data
need at 64 lanes an SM and clock, whichever is longer. K9's operations
come from a walk of its plain version that records each measurement's
branch and rows (K9_OPS_*); K2's from a walk of its plain version that
counts, per shot, the passes of n^2 pair tests over the shot's n
defects that the function needs: one event search an event, and one
saturation mask build a shot (again after a growth that takes a radius
to 2^20); the component sweeps read only the saturated pairs those masks
hold and are not counted (K2_OPS_*). Each kernel's output is held
against its plain version first.

The script needs only the C entry points and the wrappers, so it also
times an older checkout: copy it and `profiling.py` into that checkout's
`qcss_tpu_torch/benchmarks/` and run it there.

    python -m qcss_tpu_torch.benchmarks.measure_sparse_bench [--reps N]

prints one JSON line per case, the card's name and power limit last.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from qcss_tpu_torch import _cuda
from qcss_tpu_torch.benchmarks import tableau_bench
from qcss_tpu_torch.benchmarks.profiling import (
    bound,
    cuda_ms,
    graph_ms,
    host_ms,
    int_ops_per_s,
)
from qcss_tpu_torch.circuits.ir import Circuit
from qcss_tpu_torch.decode import device_sparse as dsp
from qcss_tpu_torch.decode import device_sparse_cuda
from qcss_tpu_torch.sim import cuda_measure
from qcss_tpu_torch.sim import tableau as tb
from qcss_tpu_torch.sim import tableau_packed as tp

TAB_BATCH = 4096
TAB_QUBITS = (49, 121, 363)
DET_QUBITS = (121, 363)
K2_D, K2_ROUNDS, K2_BATCH, K2_DMAX = 11, 11, 16384, 48
L2_BYTES = 50 << 20
# K9's integer instructions, counted per word of each row a branch
# touches: a random-branch rowsum builds the plus and minus masks (12
# three-input logic ops), takes two popcounts, adds both into g and XORs
# the pivot's two words in (18); the deterministic product takes
# popc(x & z) and its sum, folds z into the local XOR, and does
# popc(x & prefix), its sum and the running XOR for the scan (8). Every
# measurement also tests the measured bit of every row (1 a row).
K9_OPS_ROWSUM_WORD = 18
K9_OPS_PRODUCT_WORD = 8
# K2's integer operations per test of a defect pair: in a saturation
# mask build r_i + r_j, the compare with d_ij and the mask bit (3); in an
# event search need = d_ij - r_i - r_j, the rate, the three conditions,
# the halving and the minimum (8).
K2_OPS_MASK_TEST = 3
K2_OPS_EVENT_TEST = 8
# Radii at or past this make the kernel build a shot's masks anew
# (`kRadiusGuard` in csrc/sparse_growth.cu).
K2_RADIUS_GUARD = dsp.UNREACH // 2


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


# -- K9 ---------------------------------------------------------------------

def k9_walk(t, qubits, bits):
    """K9's plain version one measurement at a time (`_measure_z`, which
    `tableau_packed.measure_many` loops over), with what each (shot,
    measured qubit) took: (state, outcomes, random [B, M] bool, rows
    [B, M]) where rows counts, for a random outcome, the anticommuting rows
    other than the pivot (the rowsums) and, for a deterministic one, the
    selected stabilizer rows."""
    n = t.n
    outs, rand, rows = [], [], []
    for m, q in enumerate(int(v) for v in qubits):
        xq = tp._col_bit(t.x, q)
        is_rand = (xq[:, n:] == 1).any(dim=1)
        rows.append(torch.where(is_rand, xq.sum(1, dtype=torch.int64) - 1,
                                xq[:, :n].sum(1, dtype=torch.int64)))
        rand.append(is_rand)
        t, out = tp._measure_z(t, q, bits[:, m])
        outs.append(out)
    return (t, torch.stack(outs, 1), torch.stack(rand, 1),
            torch.stack(rows, 1))


def k9_ops(t, rand, rows) -> int:
    """K9's integer operations on a tableau for the branches the walk
    recorded (K9_OPS_* above)."""
    W = t.x.shape[2]
    per_word = torch.where(rand, K9_OPS_ROWSUM_WORD, K9_OPS_PRODUCT_WORD)
    return int((rows * per_word).sum()) * W + rand.numel() * 2 * t.n


def k9_bytes(t, m: int) -> int:
    """Bytes K9 must move: x, z and r in and out, the collapse bits, the
    measured qubits and the outcomes."""
    B, two_n, W = t.x.shape
    return 2 * (2 * 4 * B * two_n * W + B * two_n) + 2 * B * m + 4 * m


def random_clifford(n: int, B: int, seed: int, device):
    """A packed tableau after a random Clifford circuit of depth 4n (the
    gate mix of tests/test_pallas_measure.py), and the circuit's rng."""
    names = ["I", "X", "Y", "Z", "H", "S", "CNOT", "CZ"]
    rng = np.random.default_rng(seed)
    circ = Circuit()
    for _ in range(4 * n):
        k = int(rng.integers(0, 8))
        a, b = (int(v) for v in rng.choice(n, 2, replace=False))
        circ.gate(names[k], *((a,) if k < 6 else (a, b)))
    return tp.run_circuit(tp.zero_state(B, n, device), circ), rng


def k9_cases(dev) -> list[dict]:
    """The ladder states (random branch) and the measured-once random
    Clifford states (deterministic branch), each with its qubits and
    collapse bits."""
    out = []
    for n in TAB_QUBITS:
        t = tp.run_circuit(tp.zero_state(TAB_BATCH, n, dev),
                           tableau_bench.ladder_circuit(n))
        out.append({"branch": "random (ladder state)", "n": n, "t": t})
    for n in DET_QUBITS:
        t, _ = random_clifford(n, TAB_BATCH, n, dev)
        qs = [int(v) for v in tableau_bench.measured_qubits(n)]
        bits = tb.collapse_bits(torch.Generator(device=dev).manual_seed(n),
                                TAB_BATCH, len(qs))
        t, _ = tp.measure_many(t, qs, rand_bits=bits)
        out.append({"branch": "deterministic (random Clifford state, "
                              "measured once)", "n": n, "t": t})
    for case in out:
        n = case["n"]
        case["qubits"] = [int(v) for v in tableau_bench.measured_qubits(n)]
        case["bits"] = tb.collapse_bits(
            torch.Generator(device=dev).manual_seed(1000 + n), TAB_BATCH,
            len(case["qubits"]))
    return out


def k9_bare(t, q_dev, bits):
    """A launch of K9's C entry point on preallocated outputs: (launch,
    outputs). Takes either interface: the form argument of this tree, or
    the in_smem flag of checkouts before it."""
    lib = _cuda.load()
    B, two_n, W = t.x.shape
    n, M = t.n, q_dev.numel()
    x_out, z_out = torch.empty_like(t.x), torch.empty_like(t.z)
    r_out = torch.empty_like(t.r)
    outs = torch.empty((B, M), dtype=torch.uint8, device=t.x.device)
    mode = 0 if hasattr(cuda_measure, "launch_plan") \
        else int(cuda_measure.in_shared_memory(n, W))

    def launch():
        _cuda.check(lib.qcss_chp_measure(
            t.x.data_ptr(), t.z.data_ptr(), t.r.data_ptr(), q_dev.data_ptr(),
            bits.data_ptr(), B, n, W, M, mode, x_out.data_ptr(),
            z_out.data_ptr(), r_out.data_ptr(), outs.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "qcss_chp_measure")

    return launch, (x_out, z_out, r_out, outs)


def k9_row(case: dict, reps: int, ops_per_s: float) -> dict:
    t, qs, bits = case["t"], case["qubits"], case["bits"]
    dev = t.x.device
    q_dev = torch.tensor(qs, dtype=torch.int32, device=dev)
    tpl, op, rand, rows = k9_walk(t, qs, bits)
    launch, (x_out, z_out, r_out, outs) = k9_bare(t, q_dev, bits)
    launch()
    tk, ok = cuda_measure.measure_many_cuda(t, qs, bits)
    torch.cuda.synchronize()
    for a, b in ((outs, op), (ok, op), (x_out, tpl.x), (tk.x, tpl.x),
                 (z_out, tpl.z), (r_out, tpl.r), (tk.r, tpl.r)):
        if not torch.equal(a, b):
            raise RuntimeError(f"K9 disagrees with its plain version at "
                               f"n={t.n} ({case['branch']})")
    wrap = lambda: cuda_measure.measure_many_cuda(t, qs, bits)  # noqa: E731
    nbytes = k9_bytes(t, len(qs))
    row = {"kernel": "K9", "branch": case["branch"], "n": t.n,
           "B": t.batch, "W": t.words, "M": len(qs),
           "random_share": float(rand.to(torch.float32).mean()),
           "ms": cuda_ms(wrap, reps), "host_ms": host_ms(wrap, reps),
           "hot_ms": graph_ms([launch], reps),
           "plain_ms": cuda_ms(
               lambda: tp.measure_many(t, qs, rand_bits=bits), 2),
           "library_ms": None}
    copies = [k9_bare(tp.PackedTableau(t.x.clone(), t.z.clone(),
                                       t.r.clone(), t.n), q_dev,
                      bits.clone())[0]
              for _ in range(-(-3 * L2_BYTES // nbytes))]
    for c in copies:
        c()
    row["cold_ms"] = graph_ms(copies, reps)
    del copies
    ops = k9_ops(t, rand, rows)
    row["bound_ms"], row["bound_by"] = bound(nbytes, ops, ops_per_s)
    row["int_ops"] = ops
    if hasattr(cuda_measure, "launch_plan"):
        row["plan"] = cuda_measure.launch_plan(t.n, t.words)
    return row


# -- K2 ---------------------------------------------------------------------

def k2_bytes(dets, d_max: int) -> int:
    """Bytes K2 must move on these detectors: the detector rows, the
    distance entries between the defects each shot decodes (its first
    d_max, each distinct entry once), the per-detector tables of the
    fired detectors, and obs and converged out."""
    B, V = dets.shape
    defect = dets.to(torch.int64) & 1
    rank = torch.cumsum(defect, dim=1) - defect
    keep = (defect > 0) & (rank < d_max)
    b_idx, v_idx = keep.nonzero(as_tuple=True)
    pairs = torch.zeros(V * V, dtype=torch.bool, device=dets.device)
    slot = rank[b_idx, v_idx]
    ids = torch.full((B, d_max), -1, dtype=torch.int64, device=dets.device)
    ids[b_idx, slot] = v_idx
    a, c = ids[:, :, None], ids[:, None, :]
    ok = (a >= 0) & (c >= 0) & (a != c)
    pairs[(a * V + c)[ok]] = True
    fired = torch.zeros(V, dtype=torch.bool, device=dets.device)
    fired[v_idx] = True
    return (B * V + 4 * int(pairs.sum()) + 3 * 4 * int(fired.sum())
            + 2 * 4 * B)


def k2_work(tables_dev, d_max: int, max_events: int, dets) -> dict:
    """K2's work per shot on these detectors, from a walk of its plain
    version (`device_sparse._fetch` and the steps of `_growth_core`) that
    follows each shot as the kernel does: its defects n, its events (the
    growth loop's passes until the shot grows nothing or reaches
    max_events), its saturation mask builds (one, and one more after each
    growth that leaves a radius at K2_RADIUS_GUARD or past it) and its
    component sweeps (every Jacobi pass of every components call, the
    final one included, up to the pass that changes nothing). Each event
    search and each mask build tests the n^2 pairs of the shot's defects;
    a sweep reads only the pairs its masks hold. Returns per-shot int64
    tensors and the operations."""
    dm, bdm, _, _, valid, _ = dsp._fetch(tables_dev, d_max, dets)
    N, D = bdm.shape
    BIG = dsp.UNREACH
    dev = dm.device
    n = valid.sum(1)
    vi = valid.to(torch.int32)
    r = torch.zeros((N, D), dtype=torch.int32, device=dev)
    root = torch.arange(D, dtype=torch.int32, device=dev)[None].repeat(N, 1)
    events = torch.zeros(N, dtype=torch.int64, device=dev)
    sweeps = torch.zeros(N, dtype=torch.int64, device=dev)
    masks = (n > 0).to(torch.int64)

    def components(root, alive):
        sat = (r[:, :, None] + r[:, None, :]) >= dm
        while bool(alive.any()):
            via = torch.where(sat, root[:, None, :], D).amin(dim=2)
            new = torch.minimum(root, via)
            new = torch.gather(new, 1, new.long())
            sweeps.add_(alive.to(torch.int64))
            changed = (new != root).any(dim=1)
            root = torch.where(alive[:, None], new, root)
            alive = alive & changed
        return root

    live = n > 0
    ev = 0
    while bool(live.any()):
        root = components(root, live)
        eq = root[:, :, None] == root[:, None, :]
        cnt = torch.where(eq, vi[:, None, :], 0).sum(dim=2)
        bsat = ((r >= bdm) & valid).to(torch.int32)
        bt = torch.where(eq, bsat[:, None, :], 0).sum(dim=2) > 0
        ai = (valid & ((cnt & 1) == 1) & ~bt).to(torch.int32)
        rate = ai[:, :, None] + ai[:, None, :]
        need = dm - r[:, :, None] - r[:, None, :]
        ok = (need > 0) & (rate > 0) & (dm < BIG)
        step = torch.where(ok, torch.where(rate == 2, (need + 1) >> 1, need),
                           BIG)
        bneed = bdm - r
        bok = (ai > 0) & (bneed > 0) & (bdm < BIG)
        delta = torch.minimum(step.amin(dim=(1, 2)),
                              torch.where(bok, bneed, BIG).amin(dim=1))
        grow = live & (ai.amax(dim=1) > 0) & (delta < BIG)
        events.add_(live.to(torch.int64))
        r = r + grow[:, None].to(torch.int32) * ai \
            * torch.where(delta < BIG, delta, 0)[:, None]
        far = (valid & (r >= K2_RADIUS_GUARD)).any(dim=1)
        masks.add_((grow & far).to(torch.int64))
        live = grow & (ev + 1 < max_events)
        ev += 1
    components(root, n > 0)
    tests_mask = (masks * n * n).sum()
    tests_event = (events * n * n).sum()
    ops = int(tests_mask) * K2_OPS_MASK_TEST \
        + int(tests_event) * K2_OPS_EVENT_TEST
    return {"defects": n.to(torch.int64), "events": events,
            "mask_builds": masks, "sweeps": sweeps, "int_ops": ops}


def k2_case(dev, seed: int = 1234):
    """The d=11 R=11 circuit-level detectors of `chip_smoke.py` step 4 and
    the sparse tables on the card."""
    from qcss_tpu_torch.benchmarks.device_uf_bench import build_pipeline
    from qcss_tpu_torch.codes.families import rotated_surface
    from qcss_tpu_torch.sim.noise import NoiseModel

    noise = NoiseModel(p_gate2=2e-3, p_meas=1e-2)
    graph, _, _, sample_dets = build_pipeline(
        rotated_surface(K2_D), K2_ROUNDS, noise, "dem", device=dev)
    tables = dsp._tables_to(dsp.build_sparse_tables(graph), dev)
    dets, _ = sample_dets(torch.Generator(device=dev).manual_seed(seed),
                          K2_BATCH, K2_ROUNDS)
    return tables, dets.contiguous()


def k2_bare(tables, d_max: int, max_events: int, dets):
    """A launch of K2's C entry point on preallocated outputs. Takes either
    interface: this tree's (row stride, shot counter) or that of checkouts
    before it."""
    lib = _cuda.load()
    dist, phi, bdist, bside = tables
    B, V = dets.shape
    obs = torch.empty(B, dtype=torch.int32, device=dets.device)
    conv = torch.empty(B, dtype=torch.int32, device=dets.device)
    if hasattr(device_sparse_cuda, "launch_plan"):
        counter = torch.empty(1, dtype=torch.int32, device=dets.device)

        def launch():
            _cuda.check(lib.qcss_sparse_growth(
                dets.data_ptr(), V, dist.data_ptr(), bdist.data_ptr(),
                phi.data_ptr(), bside.data_ptr(), B, V, d_max, max_events,
                counter.data_ptr(), obs.data_ptr(), conv.data_ptr(),
                torch.cuda.current_stream().cuda_stream),
                "qcss_sparse_growth")
    else:
        def launch():
            _cuda.check(lib.qcss_sparse_growth(
                dets.data_ptr(), dist.data_ptr(), bdist.data_ptr(),
                phi.data_ptr(), bside.data_ptr(), B, V, d_max, max_events,
                obs.data_ptr(), conv.data_ptr(),
                torch.cuda.current_stream().cuda_stream),
                "qcss_sparse_growth")

    return launch, (obs, conv)


def k2_row(tables, dets, reps: int, ops_per_s: float) -> dict:
    d_max = K2_DMAX
    ev = d_max * (d_max + 1) // 2 + 4
    launch, (obs, conv) = k2_bare(tables, d_max, ev, dets)
    launch()
    ok, ck = device_sparse_cuda.sparse_decode_cuda(tables, d_max, ev, dets)
    op, cp = dsp._sparse_plain(tables, d_max, ev, dets)
    torch.cuda.synchronize()
    if not (torch.equal(obs, op) and torch.equal(conv != 0, cp)
            and torch.equal(ok, op) and torch.equal(ck, cp)):
        raise RuntimeError("K2 disagrees with its plain version")
    wrap = lambda: device_sparse_cuda.sparse_decode_cuda(  # noqa: E731
        tables, d_max, ev, dets)
    work = k2_work(tables, d_max, ev, dets)
    nbytes = k2_bytes(dets, d_max)
    B, V = dets.shape
    row = {"kernel": "K2", "d": K2_D, "rounds": K2_ROUNDS, "B": B, "V": V,
           "d_max": d_max, "ms": cuda_ms(wrap, reps),
           "host_ms": host_ms(wrap, reps), "hot_ms": graph_ms([launch], reps),
           "plain_ms": cuda_ms(
               lambda: dsp._sparse_plain(tables, d_max, ev, dets), 2),
           "library_ms": None}
    copies = [k2_bare(tables, d_max, ev, dets.clone())[0]
              for _ in range(-(-3 * L2_BYTES // (B * V)))]
    for c in copies:
        c()
    row["cold_ms"] = graph_ms(copies, reps)
    del copies
    row["bound_ms"], row["bound_by"] = bound(nbytes, work["int_ops"],
                                             ops_per_s)
    row["bytes"] = nbytes
    row["int_ops"] = work["int_ops"]
    for key in ("defects", "events", "mask_builds", "sweeps"):
        v = work[key].to(torch.float64)
        row[f"{key}_per_shot"] = {"mean": float(v.mean()),
                                  "max": int(v.max())}
    if hasattr(device_sparse_cuda, "launch_plan"):
        row["plan"] = device_sparse_cuda.launch_plan(d_max)
    return row


def run(reps: int = 50, ops_per_s: float | None = None) -> list[dict]:
    if not torch.cuda.is_available():
        raise RuntimeError("measure_sparse_bench times the card's kernels: "
                           "no CUDA device")
    dev = torch.device("cuda")
    ops_per_s = ops_per_s or int_ops_per_s()
    rows = [k9_row(case, reps, ops_per_s) for case in k9_cases(dev)]
    tables, dets = k2_case(dev)
    rows.append(k2_row(tables, dets, reps, ops_per_s))
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    for row in run(args.reps):
        print(json.dumps(row), flush=True)
    print(card(), flush=True)
