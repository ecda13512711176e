"""Lattice surgery: an XX merge of two rotated-surface patches, measured.

Lattice surgery (Horsman et al. 2012) is how real surface-code
architectures enact logical joint measurements — two patches are merged
by measuring the stabilizers of one larger patch for ~d rounds, which
projectively measures the product of the logicals terminating on the
shared boundary. The reference has nothing remotely comparable (its
scope is one code block and Steane EC, reference: ftqc.py:42-120); this
module is beyond-reference capability built from the framework's own
pieces: the rectangular surface lattice (`families.surface_rect_checks`),
mechanized single-fault enumeration (the `decode.dem` philosophy), and
union-find matching over an explicitly time-varying detector graph.

The protocol (phenomenological noise tier)
------------------------------------------
Two distance-d patches A (grid columns 0..d-1) and B (columns d+1..2d)
sit in a d x (2d+1) grid with a seam column d between them.

  1. Prepare |+̄⟩_A |+̄⟩_B; measure each patch's own checks for
     `rounds_split` rounds.
  2. MERGE: initialize the seam qubits in |+⟩ and measure the checks of
     the full d x (2d+1) rectangle for `rounds_merged` rounds. In this
     lattice the merge EXTENDS each patch's boundary Z half-checks across
     the seam (a bijection — no new Z checks) and CREATES new X checks in
     the seam region whose product equals X̄_A · X̄_B · (X on the seam
     column) — with the seam in |+⟩, the first merged round therefore
     measures m = X̄_A X̄_B (deterministically +1 here), while each new
     X check individually is 50/50 random (projection randomness).
  3. Perfect transversal X-basis readout of the merged patch: final
     X-check syndrome slice + the surviving joint logical X̄_M.

Detectors and observables are derived MECHANICALLY: every single fault
(a Z error on an active qubit before round t; an X-check measurement
flip) is propagated through the linear outcome model, giving the exact
detector incidence F, so the matching graph and the device sampler are
the same object by construction (dets = faults @ F^T — one matmul).
Detector rules across the time-varying check set: split checks compare
consecutively (first round against the deterministic |+̄⟩ reference);
a merged check that extends/matches a split check compares against its
partner across the transition; genuinely NEW seam X checks get no
first-round detector (random reference — their information enters
through the m observable and their own later consecutive detectors).

Failure metrics: `m_fail` — the decoded joint-measurement outcome is
wrong (the surgery's purpose defeated); `logical_fail` — the preserved
X̄_M flips. Exactness is pinned by tests: zero noise -> zero detectors
and both estimators 0; EVERY single fault has a weight-<=2 detector
signature and decodes with no failure; d=3 vs d=5 suppression.

Port of `qcss_tpu.experiments.surgery`. The model builders are the JAX
package's numpy, copied. The sampler (`_sample`) runs in torch on the
model's device, the card unless the caller asks for the CPU: one uniform
draw per fault column from a `torch.Generator` seeded with ``seed``
(Philox, where the reference draws threefry, so the two packages agree
by rates, not shot for shot), and the detector and observable products
as exact float32 matmuls. The memories read detectors back once and
decode them with the host union-find (`decode.uf.UFDecoder`, the native
library), as the reference does.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from qcss_tpu_torch._cuda import resolve_device, synchronize
from qcss_tpu_torch.codes import families
from qcss_tpu_torch.decode.uf import (
    MatchingGraph,
    UFDecoder,
    weights_from_probs,
)
from qcss_tpu_torch.ops import gf2
from qcss_tpu_torch.ops.gf2_torch import mod2_matmul


def _solve_gf2(a: np.ndarray, b: np.ndarray) -> np.ndarray | None:
    """One solution u of u @ a = b over GF(2), or None. a: [m, n], b: [n]."""
    m = a.shape[0]
    aug = np.concatenate([a & 1, np.eye(m, dtype=np.uint8)], axis=1)
    red = gf2.rref(aug)
    lead = red[:, : a.shape[1]]
    coef = red[:, a.shape[1]:]
    target = (b & 1).astype(np.uint8)
    u = np.zeros(m, dtype=np.uint8)
    for i in range(m):
        row = lead[i]
        piv = np.nonzero(row)[0]
        if piv.size == 0:
            continue
        if target[piv[0]]:
            target = target ^ row
            u = u ^ coef[i]
    if target.any():
        return None
    return u


@dataclass(frozen=True)
class XXMergeModel:
    """The assembled surgery experiment: fault -> detector/observable
    linear maps plus the matching graph they induce."""

    d: int
    rounds_split: int
    rounds_merged: int
    n: int                      # grid qubits
    fault_probs_class: np.ndarray  # [n_faults] 0 = data (rate p), 1 = meas (q)
    F: np.ndarray               # [n_dets, n_faults] detector incidence
    obs: np.ndarray             # [2, n_faults]: row 0 = m, row 1 = X̄_M
    graph: MatchingGraph


def build_xx_merge(d: int, rounds_split: int, rounds_merged: int,
                   p: float | None = None,
                   q: float | None = None) -> XXMergeModel:
    """Assemble the fault model, detector map, and matching graph.

    With `p`/`q` the graph edges carry -log-likelihood weights; both None
    gives the unweighted graph.
    """
    if rounds_split < 1 or rounds_merged < 1:
        raise ValueError("need at least one round per phase")
    rows, cols = d, 2 * d + 1
    n = rows * cols

    def embed(small: np.ndarray, col_off: int) -> np.ndarray:
        big = np.zeros(small.shape[:-1] + (n,), dtype=np.uint8)
        sm = small.reshape(small.shape[:-1] + (d, d))
        for r in range(d):
            big[..., r * cols + col_off: r * cols + col_off + d] = sm[..., r, :]
        return big

    hx_p, _ = families.surface_rect_checks(d, d)
    hx_A, hx_B = embed(hx_p, 0), embed(hx_p, d + 1)
    hx_split = np.concatenate([hx_A, hx_B], axis=0)
    hx_M, _ = families.surface_rect_checks(rows, cols)
    r_split, r_merged = hx_split.shape[0], hx_M.shape[0]

    ab_mask = np.ones(n, dtype=np.uint8)
    seam = [r * cols + d for r in range(rows)]
    ab_mask[seam] = 0

    # merged-check continuity: partner[i] = split row with identical
    # AB-restriction, or -1 for a genuinely new seam check
    partner = np.full(r_merged, -1, dtype=np.int64)
    for i in range(r_merged):
        restr = hx_M[i] & ab_mask
        hits = np.nonzero((hx_split == restr[None, :]).all(axis=1))[0]
        if hits.size > 1:
            raise AssertionError("ambiguous check continuity")
        if hits.size == 1 and restr.any():
            partner[i] = hits[0]
    new_checks = np.nonzero(partner < 0)[0]
    if not new_checks.size:
        raise AssertionError("no new seam checks — wrong merge orientation")

    # X̄ reps on the merge-facing boundary columns; the joint observable
    # m = X̄_A X̄_B is a combination of merged (first merged round) and
    # split (last split round) check outcomes
    def col_op(c: int) -> np.ndarray:
        v = np.zeros(n, dtype=np.uint8)
        v[[r * cols + c for r in range(rows)]] = 1
        return v

    xbar_A, xbar_B = col_op(d - 1), col_op(d + 1)
    target = ((xbar_A ^ xbar_B) & ab_mask).astype(np.uint8)
    system = np.concatenate([hx_M * ab_mask[None, :], hx_split], axis=0)
    u = _solve_gf2(system, target)
    if u is None:
        raise AssertionError("X̄_A X̄_B is not measured by the merge")
    u_merged, u_split = u[:r_merged], u[r_merged:]
    xbar_M = col_op(0)

    R1, R2 = rounds_split, rounds_merged
    total = R1 + R2

    # fault inventory ------------------------------------------------------
    # data fault (t, q): Z error arising before round t's measurements
    # (t = total: before the perfect readout); seam qubits become active
    # at the merge (a seam fault at t = R1 is the |+⟩ init error)
    data_faults = [(t, qb) for t in range(total + 1) for qb in range(n)
                   if ab_mask[qb] or t >= R1]
    meas_faults = ([("s", t, c) for t in range(R1) for c in range(r_split)]
                   + [("m", t, c) for t in range(R1, total)
                      for c in range(r_merged)])
    n_data, n_meas = len(data_faults), len(meas_faults)
    nf = n_data + n_meas

    # outcome deviations as linear maps over faults -------------------------
    # o_split [R1, r_split, nf], o_merged [R2, r_merged, nf], w [n, nf]
    o_split = np.zeros((R1, r_split, nf), dtype=np.uint8)
    o_merged = np.zeros((R2, r_merged, nf), dtype=np.uint8)
    w_final = np.zeros((n, nf), dtype=np.uint8)
    for f, (t0, qb) in enumerate(data_faults):
        w_final[qb, f] = 1
        for t in range(t0, R1):
            o_split[t, :, f] ^= hx_split[:, qb]
        for t in range(max(t0, R1), total):
            o_merged[t - R1, :, f] ^= hx_M[:, qb]
    for j, (kind, t, c) in enumerate(meas_faults):
        f = n_data + j
        if kind == "s":
            o_split[t, c, f] ^= 1
        else:
            o_merged[t - R1, c, f] ^= 1

    # detectors -------------------------------------------------------------
    det_rows = []
    for t in range(R1):
        prev = o_split[t - 1] if t else 0
        det_rows.append(o_split[t] ^ prev)
    trans = o_merged[0].copy()
    keep = partner >= 0
    trans[keep] ^= o_split[R1 - 1, partner[keep]]
    det_rows.append(trans[keep])          # new checks: no first detector
    for t in range(1, R2):
        det_rows.append(o_merged[t] ^ o_merged[t - 1])
    final = (hx_M.astype(np.int64) @ w_final.astype(np.int64)) & 1
    det_rows.append((final ^ o_merged[R2 - 1]).astype(np.uint8))
    F = np.concatenate(det_rows, axis=0) & 1

    # observables ------------------------------------------------------------
    m_row = ((u_merged.astype(np.int64) @ o_merged[0].astype(np.int64))
             ^ (u_split.astype(np.int64) @ o_split[R1 - 1].astype(np.int64))
             ) & 1
    xm_row = (xbar_M.astype(np.int64) @ w_final.astype(np.int64)) & 1
    obs = np.stack([m_row, xm_row]) & 1

    # matching graph from fault signatures -----------------------------------
    wts = F.sum(axis=0)
    if np.any((wts == 0) & obs.any(axis=0)):
        raise AssertionError("undetectable logical fault — model broken")
    live = np.nonzero(wts > 0)[0]
    sig_map: dict[tuple, int] = {}
    edges, eobs, eprob = [], [], []
    p_eff = 0.0 if p is None else p
    q_eff = 0.0 if q is None else q
    for f in live:
        dets = tuple(np.nonzero(F[:, f])[0])
        if len(dets) > 2:
            raise AssertionError(
                f"fault {f} flips {len(dets)} detectors — not matchable")
        ob = int(obs[0, f]) | (int(obs[1, f]) << 1)
        key = dets
        fp = q_eff if f >= n_data else p_eff
        if key in sig_map:
            idx = sig_map[key]
            if eobs[idx] != ob:
                raise AssertionError(
                    "same signature, different observables — model broken")
            eprob[idx] = eprob[idx] + fp - eprob[idx] * fp
            continue
        sig_map[key] = len(edges)
        a = dets[0]
        b = dets[1] if len(dets) == 2 else -1
        edges.append((a, b))
        eobs.append(ob)
        eprob.append(fp)
    weight = None
    if p is not None or q is not None:
        if p is None or q is None:
            raise ValueError("pass both p and q, or neither")
        weight = weights_from_probs(np.clip(eprob, 1e-12, 1 - 1e-12))
    graph = MatchingGraph(
        num_nodes=F.shape[0],
        edges=np.asarray(edges, dtype=np.int32).reshape(-1, 2),
        edge_qubit=np.arange(len(edges), dtype=np.int32),
        edge_obs=np.asarray(eobs, dtype=np.uint32),
        n_qubits=len(edges),
        edge_weight=weight,
    )
    probs_class = np.concatenate([
        np.zeros(n_data, dtype=np.uint8), np.ones(n_meas, dtype=np.uint8)])
    return XXMergeModel(d=d, rounds_split=R1, rounds_merged=R2, n=n,
                        fault_probs_class=probs_class, F=F, obs=obs,
                        graph=graph)


def build_xx_merge_split(d: int, rounds_split: int, rounds_merged: int,
                         rounds_after: int,
                         p: float | None = None,
                         q: float | None = None) -> XXMergeModel:
    """The full surgery CYCLE: split -> merged -> split again.

    After `rounds_merged` merged rounds the seam qubits are measured out
    in the Z basis (the standard split), the patches run `rounds_after`
    separate rounds, and both are read out transversally in X. In the
    X-check sector the bookkeeping is clean: patch-local X checks are
    UNCHANGED by both transitions (they never touch the seam), so they
    compare plainly across them; the new seam X checks live only during
    the merge and leave their information in m; the seam's Z readout
    feeds only the Z sector, which this X-error experiment does not
    decode. Observables: m = X̄_A X̄_B (first merged round) and the
    individual X̄_A, X̄_B finals — both remain stabilizers of the
    evolving state throughout the cycle, so all three are
    deterministic-reference (statevector-verified in tests).
    """
    if min(rounds_split, rounds_after) < 1:
        raise ValueError("need at least one round per phase")
    if rounds_merged < 3:
        # with 2 merged rounds a new seam check's first-round flip (which
        # corrupts m) and last-round flip (which doesn't) share the single
        # consecutive detector between them — the graph cannot tell them
        # apart because the seam has no post-split readout in this sector.
        # >= 3 rounds (real surgery uses d) separates every such pair.
        raise ValueError("the merge-split cycle needs rounds_merged >= 3")
    rows, cols = d, 2 * d + 1
    n = rows * cols

    def embed(small: np.ndarray, col_off: int) -> np.ndarray:
        big = np.zeros(small.shape[:-1] + (n,), dtype=np.uint8)
        sm = small.reshape(small.shape[:-1] + (d, d))
        for r in range(d):
            big[..., r * cols + col_off: r * cols + col_off + d] = sm[..., r, :]
        return big

    hx_p, _ = families.surface_rect_checks(d, d)
    hx_A, hx_B = embed(hx_p, 0), embed(hx_p, d + 1)
    hx_split = np.concatenate([hx_A, hx_B], axis=0)
    hx_M, _ = families.surface_rect_checks(rows, cols)
    r_split, r_merged = hx_split.shape[0], hx_M.shape[0]

    ab_mask = np.ones(n, dtype=np.uint8)
    seam = [r * cols + d for r in range(rows)]
    ab_mask[seam] = 0

    partner = np.full(r_merged, -1, dtype=np.int64)
    for i in range(r_merged):
        restr = hx_M[i] & ab_mask
        hits = np.nonzero((hx_split == restr[None, :]).all(axis=1))[0]
        if hits.size == 1 and restr.any():
            partner[i] = hits[0]

    def col_op(c: int) -> np.ndarray:
        v = np.zeros(n, dtype=np.uint8)
        v[[r * cols + c for r in range(rows)]] = 1
        return v

    target = ((col_op(d - 1) ^ col_op(d + 1)) & ab_mask).astype(np.uint8)
    system = np.concatenate([hx_M * ab_mask[None, :], hx_split], axis=0)
    u = _solve_gf2(system, target)
    if u is None:
        raise AssertionError("X̄_A X̄_B is not measured by the merge")
    u_merged, u_split = u[:r_merged], u[r_merged:]
    xbar_A, xbar_B = col_op(0), col_op(d + 1)

    R1, R2, R3 = rounds_split, rounds_merged, rounds_after
    total = R1 + R2 + R3

    # active windows: seam data faults only while the seam is in play
    data_faults = [(t, qb) for t in range(total + 1) for qb in range(n)
                   if ab_mask[qb] or (R1 <= t < R1 + R2)]
    meas_faults = (
        [("s", t, c) for t in range(R1) for c in range(r_split)]
        + [("m", t, c) for t in range(R1, R1 + R2) for c in range(r_merged)]
        + [("s2", t, c) for t in range(R1 + R2, total)
           for c in range(r_split)])
    n_data = len(data_faults)
    nf = n_data + len(meas_faults)

    o_s1 = np.zeros((R1, r_split, nf), dtype=np.uint8)
    o_m = np.zeros((R2, r_merged, nf), dtype=np.uint8)
    o_s2 = np.zeros((R3, r_split, nf), dtype=np.uint8)
    w_final = np.zeros((n, nf), dtype=np.uint8)
    for f, (t0, qb) in enumerate(data_faults):
        if ab_mask[qb]:
            w_final[qb, f] = 1
        for t in range(t0, R1):
            o_s1[t, :, f] ^= hx_split[:, qb]
        for t in range(max(t0, R1), R1 + R2):
            o_m[t - R1, :, f] ^= hx_M[:, qb]
        if ab_mask[qb]:
            for t in range(max(t0, R1 + R2), total):
                o_s2[t - R1 - R2, :, f] ^= hx_split[:, qb]
    for j, (kind, t, c) in enumerate(meas_faults):
        f = n_data + j
        if kind == "s":
            o_s1[t, c, f] ^= 1
        elif kind == "m":
            o_m[t - R1, c, f] ^= 1
        else:
            o_s2[t - R1 - R2, c, f] ^= 1

    det_rows = []
    for t in range(R1):
        det_rows.append(o_s1[t] ^ (o_s1[t - 1] if t else 0))
    trans1 = o_m[0].copy()
    keep = partner >= 0
    trans1[keep] ^= o_s1[R1 - 1, partner[keep]]
    det_rows.append(trans1[keep])
    for t in range(1, R2):
        det_rows.append(o_m[t] ^ o_m[t - 1])
    # split transition: patch checks compare against their merged selves
    back = np.full(r_split, -1, dtype=np.int64)
    back[partner[keep]] = np.nonzero(keep)[0]
    if (back < 0).any():
        raise AssertionError("a patch check has no merged counterpart")
    det_rows.append(o_s2[0] ^ o_m[R2 - 1, back])
    for t in range(1, R3):
        det_rows.append(o_s2[t] ^ o_s2[t - 1])
    final = (hx_split.astype(np.int64) @ w_final.astype(np.int64)) & 1
    det_rows.append((final ^ o_s2[R3 - 1]).astype(np.uint8))
    F = np.concatenate(det_rows, axis=0) & 1

    m_row = ((u_merged.astype(np.int64) @ o_m[0].astype(np.int64))
             ^ (u_split.astype(np.int64) @ o_s1[R1 - 1].astype(np.int64))
             ) & 1
    xa_row = (xbar_A.astype(np.int64) @ w_final.astype(np.int64)) & 1
    xb_row = (xbar_B.astype(np.int64) @ w_final.astype(np.int64)) & 1
    obs = np.stack([m_row, xa_row, xb_row]).astype(np.uint8) & 1

    graph = _graph_from_signatures(F, obs, n_data, p, q)
    probs_class = np.concatenate([
        np.zeros(n_data, dtype=np.uint8),
        np.ones(nf - n_data, dtype=np.uint8)])
    return XXMergeModel(d=d, rounds_split=R1, rounds_merged=R2, n=n,
                        fault_probs_class=probs_class, F=F, obs=obs,
                        graph=graph)


def _graph_from_signatures(F: np.ndarray, obs: np.ndarray, n_data: int,
                           p: float | None, q: float | None) -> MatchingGraph:
    """Matching graph from single-fault detector signatures (weight <= 2
    asserted; duplicate signatures merge probabilities, observables must
    agree)."""
    wts = F.sum(axis=0)
    if np.any((wts == 0) & obs.any(axis=0)):
        raise AssertionError("undetectable logical fault — model broken")
    live = np.nonzero(wts > 0)[0]
    sig_map: dict[tuple, int] = {}
    edges, eobs, eprob = [], [], []
    p_eff = 0.0 if p is None else p
    q_eff = 0.0 if q is None else q
    for f in live:
        dets = tuple(np.nonzero(F[:, f])[0])
        if len(dets) > 2:
            raise AssertionError(
                f"fault {f} flips {len(dets)} detectors — not matchable")
        ob = 0
        for i in range(obs.shape[0]):
            ob |= int(obs[i, f]) << i
        fp = q_eff if f >= n_data else p_eff
        if dets in sig_map:
            idx = sig_map[dets]
            if eobs[idx] != ob:
                raise AssertionError(
                    "same signature, different observables — model broken")
            eprob[idx] = eprob[idx] + fp - eprob[idx] * fp
            continue
        sig_map[dets] = len(edges)
        edges.append((dets[0], dets[1] if len(dets) == 2 else -1))
        eobs.append(ob)
        eprob.append(fp)
    weight = None
    if p is not None or q is not None:
        if p is None or q is None:
            raise ValueError("pass both p and q, or neither")
        weight = weights_from_probs(np.clip(eprob, 1e-12, 1 - 1e-12))
    return MatchingGraph(
        num_nodes=F.shape[0],
        edges=np.asarray(edges, dtype=np.int32).reshape(-1, 2),
        edge_qubit=np.arange(len(edges), dtype=np.int32),
        edge_obs=np.asarray(eobs, dtype=np.uint32),
        n_qubits=len(edges),
        edge_weight=weight,
    )


def xx_merge_split_memory(d: int, p: float, q: float | None = None, *,
                          rounds: int | None = None,
                          batch: int = 1 << 13, seed: int = 0,
                          weighted: bool = False,
                          use_native: bool | None = None,
                          device="cuda",
                          profile: dict | None = None) -> dict[str, float]:
    """Full surgery cycle (split -> merge -> split, d rounds per phase by
    default): failure rates of the joint measurement AND both preserved
    patch logicals after the patches separate again.

    Sampled on ``device`` (the card unless the caller asks for the CPU)
    and decoded on the host; ``profile``, a dict, receives the seconds of
    each stage (`_marker`)."""
    device = resolve_device(device)
    mark = _marker(device, profile)
    q = p if q is None else q
    r = d if rounds is None else rounds
    model = build_xx_merge_split(d, r, r, r,
                                 p=p if weighted else None,
                                 q=q if weighted else None)
    mark("build")
    ob, corr = _decoded_shots(model, p, q, batch, seed, use_native, device,
                              mark)
    m_fail = (ob[:, 0] ^ (corr & 1)) == 1
    a_fail = (ob[:, 1] ^ ((corr >> 1) & 1)) == 1
    b_fail = (ob[:, 2] ^ ((corr >> 2) & 1)) == 1
    return {
        "d": d, "p": float(p), "q": float(q), "rounds": r,
        "m_fail": float(m_fail.mean()),
        "xa_fail": float(a_fail.mean()),
        "xb_fail": float(b_fail.mean()),
        "word_fail": float((m_fail | a_fail | b_fail).mean()),
        "samples": batch,
        "detectors": int(model.F.shape[0]),
        "edges": int(model.graph.num_edges),
    }


def build_surgery_cnot(d: int, rounds: int,
                       p: float | None = None,
                       q: float | None = None) -> XXMergeModel:
    """Logical CNOT via lattice surgery — the Z-sector fault model.

    Layout on a (2d+1) x (2d+1) grid: control C (rows 0..d-1, cols
    0..d-1), ancilla A below it (rows d+1..2d, same cols), target T to
    A's right (rows d+1..2d, cols d+1..2d). The canonical sequence
    (Horsman et al. 2012):

        prep A in |+̄⟩ ->  ZZ merge C-A (seam ROW d: new Z seam checks,
        m1 = Z̄_C Z̄_A) -> split -> XX merge A-T (seam COLUMN d: extends
        the Z half-checks, measures X̄_A X̄_T in the other sector) ->
        split (seam measured in Z) -> transversal Z readout of all three
        patches (M_A = Z̄_A plus the output logicals).

    CNOT output identities: Z̄_C^out = Z̄_C^in and
    Z̄_T^out = Z̄_T^in ⊕ Z̄_C^in, with the X̄_T correction conditioned on
    m1 ⊕ M_A folding into the readout — so the two scored observables are
    OUT_ZC = Z̄_C(final) and OUT_ZT = Z̄_T(final) ⊕ m1 ⊕ M_A, both
    reference-deterministic by the CNOT algebra (verified on the tableau
    engine across random measurement branches for all four logical
    inputs, tests/test_surgery.py). Z̄ outputs are corrupted by X errors
    only, so this model decodes the Z-check sector; the X sector (X̄
    outputs, m2) is the mirror image.

    Detector subtleties handled (and validated by the tableau gold):
      * the CA merge creates new seam Z checks — no first-round
        detectors (projection randomness), their info enters m1;
      * the AT seam column initializes in |0⟩: every merged Z check
        (including the seam-extended ones) then compares
        deterministically against its split partner. A |+⟩ seam — which
        the X sector would need to extract m2 — leaves the merge start
        an open temporal boundary where a single X on a boundary qubit
        covered only by an extended check flips Z̄_A·Z̄_T undetectably;
        m2 only feeds the Z̄_C^(m2) correction, which Z̄ readouts never
        see, so this experiment is free to choose the Z-sector-safe
        init (the build-time no-undetectable-logicals assert enforces
        it);
      * at the AT split the seam column is measured in Z, and those
        readout bits complete the extended-to-half continuity detectors
        (readout flips are their own fault class).
    """
    if rounds < 3:
        raise ValueError("surgery CNOT needs >= 3 rounds per phase "
                         "(merged-phase flip ambiguity, see "
                         "build_xx_merge_split)")
    G = 2 * d + 1
    n = G * G

    def embed(small: np.ndarray, r0: int, c0: int,
              sr: int, sc: int) -> np.ndarray:
        """Embed [*, sr*sc] rows of an sr x sc lattice at (r0, c0)."""
        big = np.zeros(small.shape[:-1] + (n,), dtype=np.uint8)
        sm = small.reshape(small.shape[:-1] + (sr, sc))
        for r in range(sr):
            big[..., (r + r0) * G + c0: (r + r0) * G + c0 + sc] = sm[..., r, :]
        return big

    _, hz_p = families.surface_rect_checks(d, d)
    hz_C = embed(hz_p, 0, 0, d, d)
    hz_A = embed(hz_p, d + 1, 0, d, d)
    hz_T = embed(hz_p, d + 1, d + 1, d, d)
    hz_sep = np.concatenate([hz_C, hz_A, hz_T], axis=0)
    _, hz_ca_small = families.surface_rect_checks(2 * d + 1, d)
    hz_CA = np.concatenate(
        [embed(hz_ca_small, 0, 0, 2 * d + 1, d), hz_T], axis=0)
    _, hz_at_small = families.surface_rect_checks(d, 2 * d + 1)
    hz_AT = np.concatenate(
        [hz_C, embed(hz_at_small, d + 1, 0, d, 2 * d + 1)], axis=0)

    seam_row = [d * G + c for c in range(d)]
    seam_col = [(r + d + 1) * G + d for r in range(d)]
    srow_set, scol_set = set(seam_row), set(seam_col)
    patch_mask = np.zeros(n, dtype=np.uint8)
    for r0, c0 in ((0, 0), (d + 1, 0), (d + 1, d + 1)):
        for r in range(d):
            patch_mask[(r + r0) * G + c0: (r + r0) * G + c0 + d] = 1

    def match(h_new: np.ndarray, h_old: np.ndarray,
              mask: np.ndarray) -> np.ndarray:
        out = np.full(h_new.shape[0], -1, dtype=np.int64)
        for i in range(h_new.shape[0]):
            restr = h_new[i] & mask
            hits = np.nonzero((h_old == restr[None, :]).all(axis=1))[0]
            if hits.size == 1 and restr.any():
                out[i] = hits[0]
        return out

    mask_no_srow = np.ones(n, np.uint8)
    mask_no_srow[seam_row] = 0
    mask_no_scol = np.ones(n, np.uint8)
    mask_no_scol[seam_col] = 0
    ca_partner = match(hz_CA, hz_sep, mask_no_srow)   # new seam-row Z: -1
    at_partner = match(hz_AT, hz_sep, mask_no_scol)   # extended keep idx
    at_extended = np.array([
        i for i in range(hz_AT.shape[0])
        if at_partner[i] >= 0 and (hz_AT[i][seam_col]).any()])
    if (at_partner < 0).any():
        raise AssertionError("AT merge produced an unmatched Z check")
    if not (ca_partner < 0).any():
        raise AssertionError("CA merge produced no new seam Z checks")

    def row_op(r: int, c0: int, c1: int) -> np.ndarray:
        v = np.zeros(n, dtype=np.uint8)
        v[[r * G + c for c in range(c0, c1)]] = 1
        return v

    zbar_C, zbar_A, zbar_T = (row_op(0, 0, d), row_op(d + 1, 0, d),
                              row_op(d + 1, d + 1, 2 * d + 1))
    target = ((row_op(d - 1, 0, d) ^ row_op(d + 1, 0, d))
              & mask_no_srow).astype(np.uint8)
    system = np.concatenate([hz_CA * mask_no_srow[None, :], hz_sep], axis=0)
    u = _solve_gf2(system, target)
    if u is None:
        raise AssertionError("Z̄_C Z̄_A is not measured by the CA merge")
    u_m, u_s = u[: hz_CA.shape[0]], u[hz_CA.shape[0]:]

    R = rounds
    # phase check sets and activation windows
    phases = [hz_sep, hz_CA, hz_sep, hz_AT, hz_sep]
    starts = np.cumsum([0] + [R] * 5)
    total = 5 * R

    def fault_ok(t: int, qb: int) -> bool:
        if patch_mask[qb]:
            return True
        if qb in srow_set:
            return starts[1] <= t < starts[2]
        if qb in scol_set:
            # the t == starts[4] slot is the X error between the last
            # merged round and the seam's Z readout — it flips only the
            # readout bit
            return starts[3] <= t <= starts[4]
        return False

    data_faults = [(t, qb) for t in range(total + 1) for qb in range(n)
                   if fault_ok(t, qb)]
    meas_faults = [(ph, t, c) for ph in range(5)
                   for t in range(starts[ph], starts[ph + 1])
                   for c in range(phases[ph].shape[0])]
    read_faults = list(range(len(seam_col)))   # AT-split seam Z readout
    n_data, n_meas = len(data_faults), len(meas_faults)
    nf = n_data + n_meas + len(read_faults)

    o_ph = [np.zeros((R, phases[ph].shape[0], nf), dtype=np.uint8)
            for ph in range(5)]
    w_final = np.zeros((n, nf), dtype=np.uint8)
    sread = np.zeros((len(seam_col), nf), dtype=np.uint8)
    for f, (t0, qb) in enumerate(data_faults):
        if patch_mask[qb]:
            w_final[qb, f] = 1
        for ph in range(5):
            for t in range(max(t0, starts[ph]), starts[ph + 1]):
                o_ph[ph][t - starts[ph], :, f] ^= phases[ph][:, qb]
        if qb in scol_set and t0 <= starts[4]:
            sread[seam_col.index(qb), f] = 1   # X error flips Z readout
    for j, (ph, t, c) in enumerate(meas_faults):
        o_ph[ph][t - starts[ph], c, n_data + j] ^= 1
    for j in range(len(read_faults)):
        sread[j, n_data + n_meas + j] ^= 1

    det_rows = []
    for t in range(R):                              # phase 1
        det_rows.append(o_ph[0][t] ^ (o_ph[0][t - 1] if t else 0))
    keep1 = ca_partner >= 0                          # CA merge transition
    tr = o_ph[1][0].copy()
    tr[keep1] ^= o_ph[0][R - 1, ca_partner[keep1]]
    det_rows.append(tr[keep1])
    for t in range(1, R):
        det_rows.append(o_ph[1][t] ^ o_ph[1][t - 1])
    back1 = np.full(hz_sep.shape[0], -1, dtype=np.int64)
    back1[ca_partner[keep1]] = np.nonzero(keep1)[0]
    if (back1 < 0).any():                            # CA split transition
        raise AssertionError("a patch check vanished during the CA merge")
    tr = o_ph[2][0] ^ o_ph[1][R - 1, back1]
    det_rows.append(tr)
    for t in range(1, R):
        det_rows.append(o_ph[2][t] ^ o_ph[2][t - 1])
    # AT merge transition: the seam column initializes in |0⟩ (this
    # experiment scores the Z sector only, so the X-sector outcome m2 —
    # which a |+⟩ seam would make extractable — is irrelevant), making
    # EVERY merged Z check deterministic against its split partner,
    # including the extended ones (seam Z's are +1). Without this the
    # merge start is an open temporal boundary and a single X on a
    # boundary qubit covered only by an extended check flips Z̄_A·Z̄_T
    # undetectably (caught by the build-time no-undetectable-logicals
    # assert when seam init is modeled as |+⟩).
    det_rows.append(o_ph[3][0] ^ o_ph[2][R - 1, at_partner])
    for t in range(1, R):
        det_rows.append(o_ph[3][t] ^ o_ph[3][t - 1])
    back3 = np.full(hz_sep.shape[0], -1, dtype=np.int64)
    back3[at_partner] = np.arange(hz_AT.shape[0])
    tr = o_ph[4][0] ^ o_ph[3][R - 1, back3]          # AT split transition:
    for i in at_extended:                            # seam readouts close
        pair = np.nonzero(hz_AT[i][seam_col])[0]     # the extended checks
        j = at_partner[i]
        for s in pair:
            tr[j] ^= sread[s]
    det_rows.append(tr)
    for t in range(1, R):
        det_rows.append(o_ph[4][t] ^ o_ph[4][t - 1])
    final = (hz_sep.astype(np.int64) @ w_final.astype(np.int64)) & 1
    det_rows.append((final ^ o_ph[4][R - 1]).astype(np.uint8))
    F = np.concatenate(det_rows, axis=0) & 1

    m1 = ((u_m.astype(np.int64) @ o_ph[1][0].astype(np.int64))
          ^ (u_s.astype(np.int64) @ o_ph[0][R - 1].astype(np.int64))) & 1
    out_zc = (zbar_C.astype(np.int64) @ w_final.astype(np.int64)) & 1
    ma = (zbar_A.astype(np.int64) @ w_final.astype(np.int64)) & 1
    zt = (zbar_T.astype(np.int64) @ w_final.astype(np.int64)) & 1
    # Z̄_A Z̄_T rides the merged patch as its logical row; at the split
    # that row's seam qubit is measured out, so its Z readout (row d+1 =
    # seam_col[0], matching the z̄_A/z̄_T representatives) is part of the
    # deterministic combination — omitting it leaves two physically
    # degenerate merge-boundary faults with different apparent logical
    # effects (caught by the build-time signature-consistency assert).
    out_zt = (zt ^ m1 ^ ma ^ sread[0]) & 1
    obs = np.stack([out_zc, out_zt]).astype(np.uint8)

    graph = _graph_from_signatures(F, obs, n_data, p, q)
    probs_class = np.concatenate([
        np.zeros(n_data, dtype=np.uint8),
        np.ones(nf - n_data, dtype=np.uint8)])
    return XXMergeModel(d=d, rounds_split=R, rounds_merged=R, n=n,
                        fault_probs_class=probs_class, F=F, obs=obs,
                        graph=graph)


def surgery_cnot_memory(d: int, p: float, q: float | None = None, *,
                        rounds: int | None = None, batch: int = 1 << 13,
                        seed: int = 0, weighted: bool = False,
                        use_native: bool | None = None,
                        device="cuda",
                        profile: dict | None = None) -> dict[str, float]:
    """Monte-Carlo the surgery CNOT: failure rates of the two output
    logicals (OUT_ZC = Z̄_C preserved; OUT_ZT = Z̄_T ⊕ Z̄_C implemented,
    corrections folded in). Fault deviations are input-state-independent,
    so one run covers the whole truth table.

    Sampled on ``device`` (the card unless the caller asks for the CPU)
    and decoded on the host; ``profile``, a dict, receives the seconds of
    each stage (`_marker`)."""
    device = resolve_device(device)
    mark = _marker(device, profile)
    q = p if q is None else q
    r = max(3, d) if rounds is None else rounds
    model = build_surgery_cnot(d, r,
                               p=p if weighted else None,
                               q=q if weighted else None)
    mark("build")
    ob, corr = _decoded_shots(model, p, q, batch, seed, use_native, device,
                              mark)
    c_fail = (ob[:, 0] ^ (corr & 1)) == 1
    t_fail = (ob[:, 1] ^ ((corr >> 1) & 1)) == 1
    return {
        "d": d, "p": float(p), "q": float(q), "rounds": r,
        "zc_fail": float(c_fail.mean()),
        "zt_fail": float(t_fail.mean()),
        "word_fail": float((c_fail | t_fail).mean()),
        "samples": batch,
        "detectors": int(model.F.shape[0]),
        "edges": int(model.graph.num_edges),
    }


def _sample(generator, p, q, batch, cls, f_t, obs_t, faults=None):
    """``batch`` shots of a single-fault model on the device of ``cls``:
    fault column f fires at rate q where ``cls[f]`` is 1 and at p where it
    is 0, independently, and a shot's detectors and observables are
    ``faults @ F^T`` and ``faults @ obs^T`` mod 2.

    Draws one [batch, nf] float32 uniform from ``generator`` and compares
    it with the rates in float32, as the reference compares with
    ``jnp.float32(p)``. ``faults`` ([batch, nf] 0/1) replaces the draw by
    given fault bits. ``f_t`` [nf, n_dets] and ``obs_t`` [nf, n_obs] are
    0/1 (float32 saves a cast a call); the products are float32 matmuls
    (`gf2_torch.mod2_matmul`), exact since every sum counts at most nf
    faults, far below 2^24. Returns (dets, obs) uint8."""
    if faults is None:
        rates = torch.tensor([p, q], dtype=torch.float32,
                             device=cls.device)[cls.long()]
        u = torch.rand((batch, cls.shape[0]), generator=generator,
                       device=cls.device)
        faults = (u < rates[None, :]).to(torch.uint8)
    return mod2_matmul(faults, f_t), mod2_matmul(faults, obs_t)


def _model_tensors(model, device):
    """The sampler's inputs for ``model`` on ``device``: the fault
    classes, and F^T and obs^T as float32."""
    cls = torch.as_tensor(model.fault_probs_class, device=device)
    f_t = torch.as_tensor(model.F.T, dtype=torch.float32, device=device)
    obs_t = torch.as_tensor(model.obs.T, dtype=torch.float32, device=device)
    return cls, f_t, obs_t


def _marker(device, profile: dict | None):
    """A ``mark(stage)`` that, the device synchronized, adds the seconds
    since the previous mark (or since this call) to ``profile[stage]``
    when ``profile`` is a dict. The memories mark 'build' (the model),
    'sample' (shots, detectors and observables on the device),
    'readback' (to the host) and 'decode' (the host union-find)."""
    last = [time.perf_counter()]

    def mark(stage: str) -> None:
        synchronize(device)
        now = time.perf_counter()
        if profile is not None:
            profile[stage] = profile.get(stage, 0.0) + now - last[0]
        last[0] = now

    return mark


def _decoded_shots(model, p, q, batch, seed, use_native, device, mark):
    """Sample ``batch`` shots of ``model`` on ``device`` from a generator
    seeded with ``seed``, read detectors and observables back once, and
    decode them with the host union-find. Returns (obs [B, n_obs] uint8,
    the decoder's observable-flip masks [B])."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dets, ob = _sample(gen, p, q, batch, *_model_tensors(model, device))
    mark("sample")
    dets, ob = dets.cpu().numpy(), ob.cpu().numpy()
    mark("readback")
    dec = UFDecoder(model.graph, use_native=use_native)
    _, corr = dec.decode_batch(dets, want_corrections=False)
    mark("decode")
    return ob, corr


def xx_merge_memory(d: int, p: float, q: float | None = None, *,
                    rounds_split: int | None = None,
                    rounds_merged: int | None = None,
                    batch: int = 1 << 13, seed: int = 0,
                    weighted: bool = False,
                    use_native: bool | None = None,
                    device="cuda",
                    profile: dict | None = None) -> dict[str, float]:
    """Run the XX-merge surgery experiment; see the module docstring.

    Returns the joint-measurement failure rate (`m_fail` — the decoded
    X̄_A X̄_B outcome is wrong), the merged-logical failure (`logical_fail`
    — X̄_M flips through prep + merge + readout), and `word_fail`.

    Sampled on ``device`` (the card unless the caller asks for the CPU)
    and decoded on the host; ``profile``, a dict, receives the seconds of
    each stage (`_marker`)."""
    device = resolve_device(device)
    mark = _marker(device, profile)
    q = p if q is None else q
    rounds_split = d if rounds_split is None else rounds_split
    rounds_merged = d if rounds_merged is None else rounds_merged
    model = build_xx_merge(d, rounds_split, rounds_merged,
                           p=p if weighted else None,
                           q=q if weighted else None)
    mark("build")
    ob, corr = _decoded_shots(model, p, q, batch, seed, use_native, device,
                              mark)
    m_fail = (ob[:, 0] ^ (corr & 1)) == 1
    l_fail = (ob[:, 1] ^ ((corr >> 1) & 1)) == 1
    return {
        "d": d,
        "p": float(p), "q": float(q),
        "rounds_split": rounds_split, "rounds_merged": rounds_merged,
        "m_fail": float(m_fail.mean()),
        "logical_fail": float(l_fail.mean()),
        "word_fail": float((m_fail | l_fail).mean()),
        "samples": batch,
        "detectors": int(model.F.shape[0]),
        "edges": int(model.graph.num_edges),
    }
