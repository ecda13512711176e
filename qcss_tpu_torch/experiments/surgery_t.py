"""The logical T gadget on surface patches: magic-state teleportation
via lattice surgery, BOTH fault sectors decoded.

The gadget (Litinski, "A Game of Surface Codes", Quantum 3, 128 (2019) —
re-derived for this framework's surgery machinery): data patch D holds
|ψ̄⟩, magic patch M below it holds |m̄⟩ = T|+̄⟩ (from
`experiments.injection` + `ftqc.magic`). Measure m1 = Z̄_D Z̄_M by
lattice surgery (ZZ merge over the seam row, d rounds, split), then
measure M transversally in X (M_X); software applies S̄^{m1} and the
Z̄^{M_X ⊕ gauge} frame to D, leaving T|ψ̄⟩. The reference stubs its
universal-gate path entirely (reference: css_code.py:433-434) and has no
multi-patch machinery of any kind.

The gadget's fault channels factor into the two error sectors of the
merge-split cycle, each a mechanized single-fault model in the gadget's
natural vertical layout (patches at rows 0 and d+1 of a (2d+1) x d
strip, seam row d):

* **Z-check sector** (`build_zz_merge_split`; X-error faults): the
  merge creates NEW seam Z checks (first rounds random — projection)
  and, in this orientation, extends NO patch Z check (asserted), so
  every patch check compares cleanly across both transitions. m1 is a
  GF(2) combination of first-merged-round and last-split-round outcomes
  solved WITHOUT masking the seam columns — the combination must have
  even support on every seam qubit, which makes it deterministic for
  ANY seam initialization and immune to seam-initialization X errors
  (an odd-support combination, like the off-seam solve
  `surgery.build_xx_merge_split` uses, is only deterministic for the
  seam init whose X values are known — the same temporal-boundary
  subtlety `surgery.build_surgery_cnot` documents). Channels: m1
  (wrong -> S̄ vs S̄†, a non-Pauli logical error) and Z̄_D (an
  undetected logical flip on the output patch).
* **X-check sector** (`build_merge_readout_sector`; Z-error faults):
  the seam initializes in |+⟩ (what makes the new Z checks' projection
  carry m1), so the X checks EXTENDED across the seam absorb known
  X values and compare deterministically at the merge transition; the
  split measures the seam in X, and those readout bits close the
  extended checks' split transition. The preserved observable is
  OUT = X̄_D X̄_M — it rides the merged patch's logical column THROUGH
  the seam qubit, so the seam readout bit of that column is part of the
  deterministic combination. OUT failing means the M_X-conditioned
  Z̄ correction lands wrong: a logical error on the output.

Both models carry build-time asserts (every fault <= 2 detectors,
signature-sharing faults agree on observables, no undetectable logical
fault — the assert that caught the odd-seam-support m1 combination
during development) and a statevector gold in tests/test_surgery_t.py.

Port of `qcss_tpu.experiments.surgery_t`: the builders are the JAX
package's numpy, copied; each sector is sampled on the device by
`surgery._sample` and decoded on the host, as in `experiments.surgery`.
"""

from __future__ import annotations

import numpy as np

from qcss_tpu_torch._cuda import resolve_device
from qcss_tpu_torch.codes import families
from qcss_tpu_torch.experiments.surgery import (
    XXMergeModel,
    _decoded_shots,
    _graph_from_signatures,
    _marker,
    _solve_gf2,
)

# -- shared vertical-layout geometry ---------------------------------------


def _vertical_geometry(d: int):
    rows, cols = 2 * d + 1, d
    n = rows * cols
    seam = [d * cols + c for c in range(cols)]
    ab_mask = np.ones(n, dtype=np.uint8)
    ab_mask[seam] = 0

    def embed(small: np.ndarray, row_off: int) -> np.ndarray:
        big = np.zeros(small.shape[:-1] + (n,), dtype=np.uint8)
        sm = small.reshape(small.shape[:-1] + (d, d))
        for r in range(d):
            big[..., (r + row_off) * cols: (r + row_off) * cols + d] = (
                sm[..., r, :])
        return big

    return rows, cols, n, seam, ab_mask, embed


def _match_partners(h_m: np.ndarray, h_split: np.ndarray,
                    ab_mask: np.ndarray) -> np.ndarray:
    partner = np.full(h_m.shape[0], -1, dtype=np.int64)
    for i in range(h_m.shape[0]):
        restr = h_m[i] & ab_mask
        hits = np.nonzero((h_split == restr[None, :]).all(axis=1))[0]
        if hits.size > 1:
            raise AssertionError("ambiguous check continuity")
        if hits.size == 1 and restr.any():
            partner[i] = hits[0]
    return partner


def build_zz_merge_split(d: int, rounds_split: int, rounds_merged: int,
                         rounds_after: int,
                         p: float | None = None,
                         q: float | None = None) -> XXMergeModel:
    """Z-check sector of the ZZ merge-split cycle (X-error faults).

    obs rows: 0 = m1 (the Z̄_D Z̄_M joint measurement, solved as a
    seam-support-even combination), 1 = Z̄_D final, 2 = Z̄_M final."""
    if min(rounds_split, rounds_after) < 1:
        raise ValueError("need at least one round per phase")
    if rounds_merged < 3:
        raise ValueError("the merge-split cycle needs rounds_merged >= 3 "
                         "(see surgery.build_xx_merge_split)")
    rows, cols, n, seam, ab_mask, embed = _vertical_geometry(d)
    _, hz_p = families.surface_rect_checks(d, d)
    hz_D, hz_Mp = embed(hz_p, 0), embed(hz_p, d + 1)
    hz_split = np.concatenate([hz_D, hz_Mp], axis=0)
    _, hz_MRG = families.surface_rect_checks(rows, cols)
    r_split, r_merged = hz_split.shape[0], hz_MRG.shape[0]

    partner = _match_partners(hz_MRG, hz_split, ab_mask)
    new = np.nonzero(partner < 0)[0]
    if not new.size:
        raise AssertionError("ZZ merge produced no new seam Z checks")
    if any(hz_MRG[i][seam].any() for i in np.nonzero(partner >= 0)[0]):
        raise AssertionError(
            "a matched Z check extends over the seam — this orientation "
            "should create only NEW seam Z checks")

    def row_op(r: int) -> np.ndarray:
        v = np.zeros(n, dtype=np.uint8)
        v[[r * cols + c for c in range(cols)]] = 1
        return v

    zbar_D, zbar_M = row_op(0), row_op(d + 1)
    # m1 combination solved over the UNMASKED system: even seam support,
    # hence deterministic for any seam init and immune to seam-init errors
    system = np.concatenate([hz_MRG, hz_split], axis=0)
    u = _solve_gf2(system, (zbar_D ^ zbar_M).astype(np.uint8))
    if u is None:
        raise AssertionError(
            "Z̄_D Z̄_M has no seam-support-even measurement combination")
    u_m, u_s = u[:r_merged], u[r_merged:]

    R1, R2, R3 = rounds_split, rounds_merged, rounds_after
    total = R1 + R2 + R3
    # seam X faults matter only while the seam's Z checks run
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
            o_s1[t, :, f] ^= hz_split[:, qb]
        for t in range(max(t0, R1), R1 + R2):
            o_m[t - R1, :, f] ^= hz_MRG[:, qb]
        if ab_mask[qb]:
            for t in range(max(t0, R1 + R2), total):
                o_s2[t - R1 - R2, :, f] ^= hz_split[:, qb]
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
    keep = partner >= 0
    tr = o_m[0].copy()
    tr[keep] ^= o_s1[R1 - 1, partner[keep]]
    det_rows.append(tr[keep])                 # new checks: projection
    for t in range(1, R2):
        det_rows.append(o_m[t] ^ o_m[t - 1])
    back = np.full(r_split, -1, dtype=np.int64)
    back[partner[keep]] = np.nonzero(keep)[0]
    if (back < 0).any():
        raise AssertionError("a patch Z check vanished during the merge")
    det_rows.append(o_s2[0] ^ o_m[R2 - 1, back])
    for t in range(1, R3):
        det_rows.append(o_s2[t] ^ o_s2[t - 1])
    final = (hz_split.astype(np.int64) @ w_final.astype(np.int64)) & 1
    det_rows.append((final ^ o_s2[R3 - 1]).astype(np.uint8))
    F = np.concatenate(det_rows, axis=0) & 1

    m1 = ((u_m.astype(np.int64) @ o_m[0].astype(np.int64))
          ^ (u_s.astype(np.int64) @ o_s1[R1 - 1].astype(np.int64))) & 1
    zd = (zbar_D.astype(np.int64) @ w_final.astype(np.int64)) & 1
    zm = (zbar_M.astype(np.int64) @ w_final.astype(np.int64)) & 1
    obs = np.stack([m1, zd, zm]).astype(np.uint8) & 1

    graph = _graph_from_signatures(F, obs, n_data, p, q)
    probs_class = np.concatenate([
        np.zeros(n_data, dtype=np.uint8),
        np.ones(nf - n_data, dtype=np.uint8)])
    return XXMergeModel(d=d, rounds_split=R1, rounds_merged=R2, n=n,
                        fault_probs_class=probs_class, F=F, obs=obs,
                        graph=graph)


def build_merge_readout_sector(d: int, rounds_split: int,
                               rounds_merged: int, rounds_after: int,
                               p: float | None = None,
                               q: float | None = None) -> XXMergeModel:
    """X-check sector of the ZZ merge-split cycle (Z-error faults).

    Every merged X check continues a split check (asserted — the ZZ
    merge creates new checks only of Z type); the seam-straddling ones
    are EXTENDED. The |+⟩ seam makes extended checks deterministic at
    the merge transition, and the split-time seam X readout closes their
    split transition. obs row 0: OUT = X̄_D(final) ⊕ X̄_M(final) ⊕ the
    seam readout bit of the logical column — the preserved cross-patch
    product whose failure corrupts the M_X-conditioned correction."""
    if min(rounds_split, rounds_after) < 1:
        raise ValueError("need at least one round per phase")
    if rounds_merged < 2:
        raise ValueError("need >= 2 merged rounds")
    rows, cols, n, seam, ab_mask, embed = _vertical_geometry(d)
    hx_p, _ = families.surface_rect_checks(d, d)
    hx_D, hx_Mp = embed(hx_p, 0), embed(hx_p, d + 1)
    hx_split = np.concatenate([hx_D, hx_Mp], axis=0)
    hx_MRG, _ = families.surface_rect_checks(rows, cols)
    r_split, r_merged = hx_split.shape[0], hx_MRG.shape[0]

    partner = _match_partners(hx_MRG, hx_split, ab_mask)
    if (partner < 0).any():
        raise AssertionError(
            "X-check sector grew a new check — wrong merge orientation")
    extended = np.array([i for i in range(r_merged)
                         if hx_MRG[i][seam].any()], dtype=np.int64)
    if not extended.size:
        raise AssertionError("no extended X checks — seam not straddled")

    def col_op(c: int) -> tuple[np.ndarray, np.ndarray]:
        top = np.zeros(n, dtype=np.uint8)
        bot = np.zeros(n, dtype=np.uint8)
        top[[r * cols + c for r in range(d)]] = 1
        bot[[(r + d + 1) * cols + c for r in range(d)]] = 1
        return top, bot

    xbar_D, xbar_M = col_op(0)
    seam_read_idx = 0             # seam qubit (d, 0) joins the column

    R1, R2, R3 = rounds_split, rounds_merged, rounds_after
    total = R1 + R2 + R3
    # seam Z faults: physical from merge start; the t == R1+R2 slot flips
    # only the seam's X readout
    data_faults = [(t, qb) for t in range(total + 1) for qb in range(n)
                   if ab_mask[qb] or (R1 <= t <= R1 + R2)]
    meas_faults = (
        [("s", t, c) for t in range(R1) for c in range(r_split)]
        + [("m", t, c) for t in range(R1, R1 + R2) for c in range(r_merged)]
        + [("s2", t, c) for t in range(R1 + R2, total)
           for c in range(r_split)])
    read_faults = list(range(len(seam)))
    n_data, n_meas = len(data_faults), len(meas_faults)
    nf = n_data + n_meas + len(read_faults)

    o_s1 = np.zeros((R1, r_split, nf), dtype=np.uint8)
    o_m = np.zeros((R2, r_merged, nf), dtype=np.uint8)
    o_s2 = np.zeros((R3, r_split, nf), dtype=np.uint8)
    w_final = np.zeros((n, nf), dtype=np.uint8)
    sread = np.zeros((len(seam), nf), dtype=np.uint8)
    for f, (t0, qb) in enumerate(data_faults):
        if ab_mask[qb]:
            w_final[qb, f] = 1
        for t in range(t0, R1):
            o_s1[t, :, f] ^= hx_split[:, qb]
        for t in range(max(t0, R1), R1 + R2):
            o_m[t - R1, :, f] ^= hx_MRG[:, qb]
        if ab_mask[qb]:
            for t in range(max(t0, R1 + R2), total):
                o_s2[t - R1 - R2, :, f] ^= hx_split[:, qb]
        if qb in seam and t0 <= R1 + R2:
            sread[seam.index(qb), f] ^= 1
    for j, (kind, t, c) in enumerate(meas_faults):
        f = n_data + j
        if kind == "s":
            o_s1[t, c, f] ^= 1
        elif kind == "m":
            o_m[t - R1, c, f] ^= 1
        else:
            o_s2[t - R1 - R2, c, f] ^= 1
    for j in range(len(read_faults)):
        sread[j, n_data + n_meas + j] ^= 1

    det_rows = []
    for t in range(R1):
        det_rows.append(o_s1[t] ^ (o_s1[t - 1] if t else 0))
    det_rows.append(o_m[0] ^ o_s1[R1 - 1, partner])  # ALL checks continue
    for t in range(1, R2):
        det_rows.append(o_m[t] ^ o_m[t - 1])
    back = np.full(r_split, -1, dtype=np.int64)
    back[partner] = np.arange(r_merged)
    if (back < 0).any():
        raise AssertionError("a split X check has no merged counterpart")
    tr = o_s2[0] ^ o_m[R2 - 1, back]
    for i in extended:                       # seam X readouts close the
        pair = np.nonzero(hx_MRG[i][seam])[0]  # extended checks
        j = partner[i]
        for s in pair:
            tr[j] ^= sread[s]
    det_rows.append(tr)
    for t in range(1, R3):
        det_rows.append(o_s2[t] ^ o_s2[t - 1])
    final = (hx_split.astype(np.int64) @ w_final.astype(np.int64)) & 1
    det_rows.append((final ^ o_s2[R3 - 1]).astype(np.uint8))
    F = np.concatenate(det_rows, axis=0) & 1

    xd = (xbar_D.astype(np.int64) @ w_final.astype(np.int64)) & 1
    xm = (xbar_M.astype(np.int64) @ w_final.astype(np.int64)) & 1
    out = (xd ^ xm ^ sread[seam_read_idx]) & 1
    obs = out[None, :].astype(np.uint8)

    graph = _graph_from_signatures(F, obs, n_data, p, q)
    probs_class = np.concatenate([
        np.zeros(n_data, dtype=np.uint8),
        np.ones(nf - n_data, dtype=np.uint8)])
    return XXMergeModel(d=d, rounds_split=R1, rounds_merged=R2, n=n,
                        fault_probs_class=probs_class, F=F, obs=obs,
                        graph=graph)


def t_gadget_memory(d: int, p: float, q: float | None = None, *,
                    rounds: int | None = None, batch: int = 1 << 13,
                    seed: int = 0, weighted: bool = False,
                    use_native: bool | None = None,
                    device="cuda",
                    profile: dict | None = None) -> dict[str, float]:
    """Decode both fault sectors of the T gadget's merge-split cycle.

    Channels: ``m1_fail`` (wrong joint measurement -> S̄ vs S̄†, a
    non-Pauli logical error), ``zd_fail`` (Z̄_D logical flip on the
    output patch), ``out_fail`` (X-sector cross-patch product flip ->
    wrong M_X-conditioned correction frame). ``gadget_fail`` combines
    the independently sampled sectors:
    1 - (1 - P[m1 or zd]) * (1 - P[out]).

    Each sector is sampled on ``device`` (the card unless the caller asks
    for the CPU) from its own generator, sector m seeded with ``seed`` and
    sector r with ``seed + 1`` (the reference's key offsets), and decoded
    on the host; ``profile``, a dict, receives the seconds of each stage
    summed over both sectors (`surgery._marker`)."""
    device = resolve_device(device)
    mark = _marker(device, profile)
    q = p if q is None else q
    r = d if rounds is None else rounds
    kw = dict(p=p, q=q) if weighted else dict(p=None, q=None)
    model_m = build_zz_merge_split(d, r, max(r, 3), r, **kw)
    model_r = build_merge_readout_sector(d, r, max(r, 3), r, **kw)
    mark("build")

    fails = {}
    for tag, model, seed_off in (("m", model_m, 0), ("r", model_r, 1)):
        ob, corr = _decoded_shots(model, p, q, batch, seed + seed_off,
                                  use_native, device, mark)
        for i in range(model.obs.shape[0]):
            fails[(tag, i)] = (ob[:, i] ^ ((corr >> i) & 1)) == 1

    m1 = fails[("m", 0)]
    zd = fails[("m", 1)]
    out = fails[("r", 0)]
    sector_m = float((m1 | zd).mean())
    sector_r = float(out.mean())
    return {
        "d": d, "p": float(p), "q": float(q), "rounds": r,
        "m1_fail": float(m1.mean()),
        "zd_fail": float(zd.mean()),
        "out_fail": sector_r,
        "gadget_fail": 1.0 - (1.0 - sector_m) * (1.0 - sector_r),
        "samples": batch,
        "detectors_m": int(model_m.F.shape[0]),
        "detectors_r": int(model_r.F.shape[0]),
    }


def t_gadget_report(d: int, p: float, q: float | None = None, *,
                    eps_magic: float, batch: int = 1 << 13,
                    seed: int = 0, device="cuda") -> dict[str, float]:
    """End-to-end logical-T error budget: the surgery gadget's decoded
    failure (both sectors) composed with the injected/distilled magic
    state's residual error ``eps_magic`` (from
    `experiments.injection.factory_report` — measured injection epsilon
    through the distillation cascade). The magic-state error enters the
    output directly (the gadget teleports it), so the budget is
    1 - (1 - gadget_fail) * (1 - eps_magic). The gadget is sampled on
    ``device``."""
    out = t_gadget_memory(d, p, q, batch=batch, seed=seed, device=device)
    out["eps_magic"] = float(eps_magic)
    out["t_error"] = 1.0 - (1.0 - out["gadget_fail"]) * (1.0 - eps_magic)
    return out
