"""Circuit-level lattice surgery: the XX merge with real extraction circuits.

The phenomenological tier (`experiments.surgery`) charges one fault per
qubit per round. This tier runs the ACTUAL ancilla-based X-check
extraction circuits — H-sandwiched CNOT fan-outs, noisy measurements and
resets — so CNOT hook faults (an ancilla Z spreading into several data
qubits mid-fan-out) and all other circuit locations appear with their
exact multi-detector signatures. Those signatures exceed weight 2, so
the decoder is BP(+device OSD) over a detector-fault Tanner graph
(`decode.bp`), not matching — the same architecture as the qLDPC
circuit-level memories (`decode.bp_dem`), here generalized to surgery's
TIME-VARYING check sets.

Construction (all mechanized, one linear map):
  * each phase's one-round op list is walked once per fault component
    (per-side CNOT depolarizing marginals, H depolarizing, measurement
    and reset flips — the same channel decomposition as
    `decode.dem2._fault_species`, in lockstep with the frame sampler's
    noise injection), yielding its own-round outcome flips plus the
    persistent data residual;
  * outcome deviations across ALL later rounds and phases follow from
    the residual (extraction circuits leave data frames unchanged), and
    the detector assembly — consecutive XORs, partner comparisons across
    the merge transition, no first-round detectors for the new seam
    checks, perfect final X readout — is shared verbatim with the
    phenomenological builder;
  * the sampler runs the SAME circuits under the frame engine
    (`sim.frame.run_arrays_noisy`), so sampled physics and decoded model
    agree except for the standard DEM independence approximation.

Exactness is pinned by tests: every enumerated fault component's
signature is reproduced by injecting that exact fault into the frame
sampler's circuits (prefix-propagate, inject, suffix-propagate) — the
signature-vs-sampler differential that guards all circuit-level tiers
here. No reference analogue at any tier (single code block only).

Port of `qcss_tpu.experiments.surgery_circuit`: the enumerator and model
builder are the JAX package's numpy, copied. The sampler drives the
port's frame engine (`sim.frame`) on the device from one
`torch.Generator` (its draws, in order, are listed in `_sample_circuit`),
the detectors are assembled there too, and the decode is the port's
`BPDecoder` on the same device (OSD-0 on the card's elimination).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from qcss_tpu_torch._cuda import resolve_device
from qcss_tpu_torch.codes import families
from qcss_tpu_torch.experiments import surgery as ph
from qcss_tpu_torch.ops.gf2_torch import mod2_matmul
from qcss_tpu_torch.sim import frame as fr
from qcss_tpu_torch.sim import noise as noise_mod


def _x_extraction_ops(h: np.ndarray, anc0: int):
    """One round of X-check extraction as ("h"/"cnot"/...) op tuples plus
    the matching (ops, q0, q1) gate arrays for the frame engine — ONE
    source of truth for gate order, so enumerator and sampler agree on
    hook timing. Measures/resets are simultaneous at round end (the
    sampler uses `measure_deviations` + `reset_qubits` on all ancillas)."""
    from qcss_tpu_torch.circuits.ir import Circuit

    r = h.shape[0]
    ops = []
    circ = Circuit()
    for c in range(r):
        ops.append(("h", anc0 + c))
        circ.h(anc0 + c)
    for c in range(r):
        for j in np.nonzero(h[c])[0]:
            ops.append(("cnot", anc0 + c, int(j)))
            circ.cnot(anc0 + c, int(j))
    for c in range(r):
        ops.append(("h", anc0 + c))
        circ.h(anc0 + c)
    return ops, circ.to_arrays()


def _walk(ops, nq: int, start: int, x0, z0, anc0: int, r: int):
    """Propagate a Pauli injected AFTER op index `start` (-1 = round
    start) to the end of the round. Returns (outcome flip mask over the
    r ancillas, residual x, residual z on all nq wires)."""
    x, z = x0.copy(), z0.copy()
    for op in ops[start + 1:]:
        if op[0] == "cnot":
            _, c, t = op
            x[t] ^= x[c]
            z[c] ^= z[t]
        else:
            q = op[1]
            x[q], z[q] = z[q], x[q]
    flips = x[anc0: anc0 + r].copy()
    x[anc0: anc0 + r] = 0
    z[anc0: anc0 + r] = 0
    return flips, x, z


@dataclass(frozen=True)
class CircuitMergeModel:
    d: int
    rounds_split: int
    rounds_merged: int
    n: int
    F: np.ndarray          # [n_dets, n_vars]
    priors: np.ndarray     # [n_vars]
    obs: np.ndarray        # [2, n_vars]  (m, X̄_M)
    fault_sigs: list       # per raw component: (dets tuple, obs int, meta)


def build_xx_merge_circuit(d: int, rounds_split: int, rounds_merged: int,
                           noise: noise_mod.NoiseModel) -> CircuitMergeModel:
    """Assemble the circuit-level fault Tanner graph of the XX merge."""
    if noise.p_idle:
        raise ValueError("circuit-level surgery charges no idle locations")
    if min(rounds_split, rounds_merged) < 1:
        raise ValueError("need at least one round per phase")
    rows, cols = d, 2 * d + 1
    n = rows * cols

    def embed(small, col_off):
        big = np.zeros(small.shape[:-1] + (n,), dtype=np.uint8)
        sm = small.reshape(small.shape[:-1] + (d, d))
        for r in range(d):
            big[..., r * cols + col_off: r * cols + col_off + d] = sm[..., r, :]
        return big

    hx_p, _ = families.surface_rect_checks(d, d)
    hx_split = np.concatenate([embed(hx_p, 0), embed(hx_p, d + 1)], axis=0)
    hx_M, _ = families.surface_rect_checks(rows, cols)
    r_s, r_m = hx_split.shape[0], hx_M.shape[0]

    ab_mask = np.ones(n, dtype=np.uint8)
    seam = [r * cols + d for r in range(rows)]
    ab_mask[seam] = 0
    partner = np.full(r_m, -1, dtype=np.int64)
    for i in range(r_m):
        restr = hx_M[i] & ab_mask
        hits = np.nonzero((hx_split == restr[None, :]).all(axis=1))[0]
        if hits.size == 1 and restr.any():
            partner[i] = hits[0]
    keep = partner >= 0

    def col_op(c):
        v = np.zeros(n, dtype=np.uint8)
        v[[r * cols + c for r in range(rows)]] = 1
        return v

    target = ((col_op(d - 1) ^ col_op(d + 1)) & ab_mask).astype(np.uint8)
    system = np.concatenate([hx_M * ab_mask[None, :], hx_split], axis=0)
    u = ph._solve_gf2(system, target)
    if u is None:
        raise AssertionError("X̄_A X̄_B is not measured by the merge")
    u_m, u_s = u[:r_m], u[r_m:]
    xbar_M = col_op(0)

    R1, R2 = rounds_split, rounds_merged
    anc0 = n
    nq = n + max(r_s, r_m)
    ops_s, _ = _x_extraction_ops(hx_split, anc0)
    ops_m, _ = _x_extraction_ops(hx_M, anc0)

    # -- enumerate fault components per (phase, round) ----------------------
    # each component: (phase, t, own outcome-flip set, residual z on data,
    # prob, meta). Only Z residuals matter (X-check outcomes and X-basis
    # readout see Z errors); X residuals are the other sector.
    comps = []

    def phase_components(ops, r_c, phase, h_this):
        out = []

        def add(start, xpat, zpat, prob, meta):
            x0 = np.zeros(nq, np.uint8)
            z0 = np.zeros(nq, np.uint8)
            x0[list(xpat)] = 1
            z0[list(zpat)] = 1
            flips, _, zr = _walk(ops, nq, start, x0, z0, anc0, r_c)
            out.append((np.nonzero(flips)[0], zr[:n].copy(), prob, meta))

        p2, p1 = noise.p_gate2, noise.p_gate1
        for k, op in enumerate(ops):
            if op[0] == "cnot" and p2:
                for q in (op[1], op[2]):
                    add(k, [q], [], 8 * p2 / 15, ("2qx", phase, k, q))
                    add(k, [], [q], 8 * p2 / 15, ("2qz", phase, k, q))
            elif op[0] == "h" and p1:
                q = op[1]
                add(k, [q], [], 2 * p1 / 3, ("1qx", phase, k, q))
                add(k, [], [q], 2 * p1 / 3, ("1qz", phase, k, q))
        if noise.p_meas:
            for c in range(r_c):
                out.append((np.asarray([c]), np.zeros(n, np.uint8),
                            noise.p_meas, ("meas", phase, c)))
        if noise.p_reset:
            # ancilla reset X error: next-round outcome flip of the same
            # check (H-conjugated to Z on the ancilla, never hooks)
            for c in range(r_c):
                out.append((np.asarray([c]), np.zeros(n, np.uint8),
                            noise.p_reset, ("reset", phase, c)))
        return out

    comps_s = phase_components(ops_s, r_s, 0, hx_split)
    comps_m = phase_components(ops_m, r_m, 1, hx_M)
    # seam |+⟩ init error: Z flip on a seam qubit at merge start
    comps_seam = []
    if noise.p_reset:
        for s in seam:
            x0 = np.zeros(nq, np.uint8)
            z0 = np.zeros(nq, np.uint8)
            z0[s] = 1
            # injected BEFORE the first merged round: own-round flips
            # come from walking the whole round (start=-1)
            fl, _, zr = _walk(ops_m, nq, -1, x0, z0, anc0, r_m)
            comps_seam.append((np.nonzero(fl)[0], zr[:n].copy(),
                               noise.p_reset, ("seam", s)))

    # -- outcome linear maps ------------------------------------------------
    placements = []
    for t in range(R1):
        for fl, zr, prob, meta in comps_s:
            if meta[0] == "reset" and t == R1 - 1:
                # last split reset: the ancilla SLOT carries its X init
                # error into the first merged round (slot c measures
                # merged check c there — no hook, H-conjugated)
                placements.append((1, 0, fl, zr, prob, meta + (t,)))
                continue
            tt = t + 1 if meta[0] == "reset" else t
            placements.append((0, tt, fl, zr, prob, meta + (t,)))
    for t in range(R2):
        for fl, zr, prob, meta in comps_m:
            if meta[0] == "reset" and t == R2 - 1:
                continue  # after the final data readout: no effect
            tt = t + 1 if meta[0] == "reset" else t
            placements.append((1, tt, fl, zr, prob, meta + (t,)))
    for fl, zr, prob, meta in comps_seam:
        placements.append((1, 0, fl, zr, prob, meta))
    nf = len(placements)

    o_s = np.zeros((R1, r_s, nf), dtype=np.uint8)
    o_m = np.zeros((R2, r_m, nf), dtype=np.uint8)
    w_final = np.zeros((n, nf), dtype=np.uint8)
    hs64 = hx_split.astype(np.int64)
    hm64 = hx_M.astype(np.int64)
    for f, (phase, t0, fl, zr, prob, meta) in enumerate(placements):
        w_final[:, f] = zr
        syn_s = (hs64 @ zr.astype(np.int64)) & 1
        syn_m = (hm64 @ zr.astype(np.int64)) & 1
        if phase == 0:
            o_s[t0, fl, f] ^= 1
            for t in range(t0 + 1, R1):
                o_s[t, :, f] ^= syn_s.astype(np.uint8)
            for t in range(R2):
                o_m[t, :, f] ^= syn_m.astype(np.uint8)
        else:
            o_m[t0, fl, f] ^= 1
            for t in range(t0 + 1, R2):
                o_m[t, :, f] ^= syn_m.astype(np.uint8)

    # -- detector assembly (same rules as the phenomenological tier) --------
    det_rows = []
    for t in range(R1):
        det_rows.append(o_s[t] ^ (o_s[t - 1] if t else 0))
    trans = o_m[0].copy()
    trans[keep] ^= o_s[R1 - 1, partner[keep]]
    det_rows.append(trans[keep])
    for t in range(1, R2):
        det_rows.append(o_m[t] ^ o_m[t - 1])
    final = (hm64 @ w_final.astype(np.int64)) & 1
    det_rows.append((final ^ o_m[R2 - 1]).astype(np.uint8))
    F_raw = np.concatenate(det_rows, axis=0) & 1

    m_row = ((u_m.astype(np.int64) @ o_m[0].astype(np.int64))
             ^ (u_s.astype(np.int64) @ o_s[R1 - 1].astype(np.int64))) & 1
    xm_row = (xbar_M.astype(np.int64) @ w_final.astype(np.int64)) & 1

    # merge identical (signature, observable) columns
    merged: dict[tuple, float] = {}
    fault_sigs = []
    for f, (phase, t0, fl, zr, prob, meta) in enumerate(placements):
        dets = tuple(np.nonzero(F_raw[:, f])[0])
        ob = int(m_row[f]) | (int(xm_row[f]) << 1)
        fault_sigs.append((dets, ob, meta))
        if not dets:
            if ob:
                raise AssertionError(
                    f"undetectable logical circuit fault {meta}")
            continue
        key = (dets, ob)
        old = merged.get(key, 0.0)
        merged[key] = old * (1 - prob) + prob * (1 - old)
    n_det = F_raw.shape[0]
    nv = len(merged)
    F = np.zeros((n_det, nv), dtype=np.uint8)
    priors = np.empty(nv, dtype=np.float64)
    obs = np.zeros((2, nv), dtype=np.uint8)
    for v, ((dets, ob), prob) in enumerate(sorted(merged.items())):
        F[list(dets), v] = 1
        priors[v] = prob
        obs[0, v] = ob & 1
        obs[1, v] = (ob >> 1) & 1
    return CircuitMergeModel(d=d, rounds_split=R1, rounds_merged=R2, n=n,
                             F=F, priors=priors, obs=obs,
                             fault_sigs=fault_sigs)


def _sample_circuit(generator, batch: int, R1: int, R2: int,
                    n: int, r_s: int, r_m: int, nq: int, seam,
                    split_arrays, merged_arrays, noise, hm_t, xbar_m, *,
                    device=None, faults: dict | None = None):
    """Frame-sample the merge's extraction circuits on ``device`` (the
    generator's): R1 split rounds, the seam's |+⟩ init, R2 merged rounds,
    then the perfect X readout. Returns the raw outcome deviations o_s
    [R1, B, r_s], o_m [R2, B, r_m], the final check slice [B, r_m] and
    the X̄_M readout [B], all uint8.

    Draws, in order, from ``generator``: for each split round the gates'
    fault bits (`noise.sampled_fault_bits` inside
    `frame.run_arrays_noisy`), the ancillas' measurement flips
    (`frame.measure_deviations`) and their reset uniforms
    (`frame.reset_qubits`); then the seam's [B, d] Z-init uniforms at
    p_reset; then the same three per merged round.

    ``faults`` replaces every draw by given bits (zero where a key is
    absent): ``("gates", phase, t)`` [B, 4G] fault bits of round t of
    phase 0 (split) or 1 (merged), ``("meas", phase, t)`` and
    ``("reset", phase, t)`` [B, r] outcome flips and reset X errors, and
    ``"seam"`` [B, d] Z errors at the seam's init."""
    device = generator.device if device is None else torch.device(device)
    anc = (np.arange(n, n + r_s), np.arange(n, n + r_m))

    def given(key, width):
        bits = faults.get(key)
        if bits is None:
            return torch.zeros((batch, width), dtype=torch.uint8,
                               device=device)
        return torch.as_tensor(bits, dtype=torch.uint8, device=device)

    def extraction_round(f, phase, t, arrays):
        a = anc[phase]
        if faults is None:
            f = fr.run_arrays_noisy(f, *arrays, noise, generator)
            f, outs = fr.measure_deviations(f, a, generator, noise.p_meas)
            return fr.reset_qubits(f, a, generator, noise.p_reset), outs
        f = fr.run_arrays_noisy(
            f, *arrays, noise,
            fault_bits=given(("gates", phase, t), 4 * len(arrays[0])))
        f, outs = fr.measure_deviations(f, a)
        outs = outs ^ given(("meas", phase, t), a.size)
        f = fr.reset_qubits(f, a)
        zeros = torch.zeros((batch, a.size), dtype=torch.uint8,
                            device=device)
        return fr.inject_flips(f, a, given(("reset", phase, t), a.size),
                               zeros), outs

    f = fr.zero_frames(batch, nq, device=device)
    o_s = []
    for t in range(R1):
        f, outs = extraction_round(f, 0, t, split_arrays)
        o_s.append(outs)

    # seam |+⟩ init: fresh frames; p_reset-rate Z errors
    sq = torch.as_tensor(seam, dtype=torch.long, device=device)
    if faults is None:
        zf = (torch.rand((batch, sq.shape[0]), generator=generator,
                         device=device) < noise.p_reset).to(torch.uint8)
    else:
        zf = given("seam", sq.shape[0])
    x, z = f.x.clone(), f.z.clone()
    x[:, sq] = 0
    z[:, sq] = zf
    f = fr.Frames(x, z)

    o_m = []
    for t in range(R2):
        f, outs = extraction_round(f, 1, t, merged_arrays)
        o_m.append(outs)

    w = f.z[:, :n]
    final = mod2_matmul(w, hm_t)
    # raw outcome deviations; the caller assembles the detectors
    return (torch.stack(o_s), torch.stack(o_m), final,
            mod2_matmul(w, xbar_m[:, None])[:, 0])


def _merge_geometry(d: int) -> dict:
    """The merge's layout as the sampler and the detector assembly read
    it (the enumerator's, `build_xx_merge_circuit`): ``n`` data qubits,
    the split and merged X checks, the seam, each merged check's split
    partner (-1 for a new seam check), the m combination (``u_m``,
    ``u_s``) and X̄_M's support."""
    rows, cols = d, 2 * d + 1
    n = rows * cols

    def embed(small, col_off):
        big = np.zeros(small.shape[:-1] + (n,), dtype=np.uint8)
        sm = small.reshape(small.shape[:-1] + (d, d))
        for r in range(d):
            big[..., r * cols + col_off: r * cols + col_off + d] = sm[..., r, :]
        return big

    hx_p, _ = families.surface_rect_checks(d, d)
    hx_split = np.concatenate([embed(hx_p, 0), embed(hx_p, d + 1)], axis=0)
    hx_M, _ = families.surface_rect_checks(rows, cols)
    r_m = hx_M.shape[0]
    seam = [r * cols + d for r in range(rows)]
    ab_mask = np.ones(n, np.uint8)
    ab_mask[seam] = 0
    partner = np.full(r_m, -1, np.int64)
    for i in range(r_m):
        restr = hx_M[i] & ab_mask
        hits = np.nonzero((hx_split == restr[None, :]).all(axis=1))[0]
        if hits.size == 1 and restr.any():
            partner[i] = hits[0]

    def col_op(c):
        v = np.zeros(n, np.uint8)
        v[[r * cols + c for r in range(rows)]] = 1
        return v

    system = np.concatenate([hx_M * ab_mask[None, :], hx_split], axis=0)
    target = ((col_op(d - 1) ^ col_op(d + 1)) & ab_mask).astype(np.uint8)
    u = ph._solve_gf2(system, target)
    return {"n": n, "hx_split": hx_split, "hx_M": hx_M, "seam": seam,
            "partner": partner, "u_m": u[:r_m], "u_s": u[r_m:],
            "xbar_m": col_op(0)}


def _sampled_detectors(generator, batch: int, R1: int, R2: int, geo: dict,
                       noise, *, device=None, faults: dict | None = None):
    """Sample the merge (`_sample_circuit`, ``faults`` as there) and
    assemble its detectors by the enumerator's rules: consecutive XORs,
    partner comparisons across the merge (none for the new seam checks),
    the final slice against the last merged round. Returns (dets
    [B, n_dets], the m estimate [B], the X̄_M readout [B]), uint8 on the
    device."""
    device = generator.device if device is None else torch.device(device)
    n, hx_split, hx_M = geo["n"], geo["hx_split"], geo["hx_M"]
    r_s, r_m = hx_split.shape[0], hx_M.shape[0]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.uint8), device=device)

    _, split_arrays = _x_extraction_ops(hx_split, n)
    _, merged_arrays = _x_extraction_ops(hx_M, n)
    o_s, o_m, final, xm = _sample_circuit(
        generator, batch, R1, R2, n, r_s, r_m, n + max(r_s, r_m),
        tuple(geo["seam"]), split_arrays, merged_arrays, noise, t(hx_M.T),
        t(geo["xbar_m"]), device=device, faults=faults)
    partner = geo["partner"]
    keep = torch.as_tensor(np.nonzero(partner >= 0)[0], device=device)
    part = torch.as_tensor(partner[partner >= 0], device=device)
    dets = [o_s[0]]
    for r in range(1, R1):
        dets.append(o_s[r] ^ o_s[r - 1])
    dets.append(o_m[0][:, keep] ^ o_s[R1 - 1][:, part])
    for r in range(1, R2):
        dets.append(o_m[r] ^ o_m[r - 1])
    dets.append(final ^ o_m[R2 - 1])
    m_est = (mod2_matmul(o_m[0], t(geo["u_m"])[:, None])
             ^ mod2_matmul(o_s[R1 - 1], t(geo["u_s"])[:, None]))[:, 0]
    return torch.cat(dets, dim=1), m_est, xm


def xx_merge_circuit_memory(d: int, noise: noise_mod.NoiseModel, *,
                            rounds_split: int | None = None,
                            rounds_merged: int | None = None,
                            batch: int = 1 << 12, seed: int = 0,
                            iters: int = 48, alpha: float = 0.8,
                            osd: bool = True, device="cuda",
                            profile: dict | None = None) -> dict[str, float]:
    """Run the circuit-level XX merge end-to-end: frame-sampled extraction
    circuits, detector assembly, BP(+OSD) decode on the fault Tanner
    graph, m and X̄_M failure rates.

    Sampled (`_sample_circuit`, one generator seeded with ``seed``) and
    decoded on ``device``, the card unless the caller asks for the CPU;
    ``profile``, a dict, receives the seconds of 'build' (the model and
    the decoder), 'sample' (frames and detectors), 'decode' (BP and the
    OSD tail) and 'readback' (`surgery._marker`)."""
    from qcss_tpu_torch.decode.bp import BPDecoder

    device = resolve_device(device)
    mark = ph._marker(device, profile)
    R1 = d if rounds_split is None else rounds_split
    R2 = d if rounds_merged is None else rounds_merged
    model = build_xx_merge_circuit(d, R1, R2, noise)
    geo = _merge_geometry(d)
    dec = BPDecoder(model.F, np.clip(model.priors, 1e-12, 0.499),
                    logicals=model.obs, iters=iters, alpha=alpha, osd=osd,
                    device=device)
    mark("build")
    gen = torch.Generator(device=device).manual_seed(seed)
    dets, m_est, xm = _sampled_detectors(gen, batch, R1, R2, geo, noise)
    mark("sample")
    flips, conv = dec.decode_obs_device(dets)
    mark("decode")
    m_fail = (m_est ^ flips[:, 0]).cpu().numpy() == 1
    l_fail = (xm ^ flips[:, 1]).cpu().numpy() == 1
    mark("readback")
    return {
        "d": d, "rounds_split": R1, "rounds_merged": R2,
        "m_fail": float(m_fail.mean()),
        "logical_fail": float(l_fail.mean()),
        "word_fail": float((m_fail | l_fail).mean()),
        "bp_converged": float(np.asarray(conv).mean()),
        "samples": batch,
        "detectors": int(model.F.shape[0]),
        "fault_vars": int(model.F.shape[1]),
    }
