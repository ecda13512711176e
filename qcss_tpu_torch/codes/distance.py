"""Randomized minimum-distance estimation for CSS codes.

The X distance of a CSS code is the minimum weight of a vector in
ker(H_Z) \\ rowspace(H_X) — exactly computable only for tiny codes
(exhaustive certificates live in the test suite for d <= 7). For the
qLDPC constructors (`bivariate_bicycle`, `hypergraph_product`,
`lifted_product`) distances of new instances are unknown; this module
provides the standard randomized INFORMATION-SET upper bound, which is
empirically tight at these block lengths (verified against every
known-distance family in tests/test_distance.py):

repeat: permute columns randomly; RREF the full ker(H_Z) generator (its
systematic rows are weight-biased-low codewords); keep the lightest row
that is NOT a stabilizer (rank test vs rowspace(H_X)); also sweep pair
sums of the lightest rows. The result is always a TRUE upper bound —
every candidate is verified to be a codeword and a non-stabilizer — and
`min_distance_upper_bound` reports the best over `iters` rounds.

No reference analogue (the reference takes distances as constructor
inputs and never verifies them — reference: css_code.py:60-66).
"""

from __future__ import annotations

import numpy as np

from qcss_tpu_torch.ops import gf2


def _logical_candidates(h_dual: np.ndarray, h_stab: np.ndarray,
                        iters: int, seed: int, pair_sweep: int):
    """Yield (weight, vector) non-stabilizer codewords: v in ker(h_dual)
    with v not in rowspace(h_stab)."""
    n = h_dual.shape[1]
    gen = gf2.nullspace(h_dual)  # [g, n] basis of the codeword space
    if gen.size == 0:
        return
    stab_r = gf2.rref(h_stab)
    stab_r = stab_r[stab_r.any(axis=1)]
    pivots = np.asarray([int(np.argmax(row)) for row in stab_r])
    rng = np.random.default_rng(seed)

    def is_logical(v):
        # reduce by the stabilizer RREF: nonzero residual = logical
        v = v.copy()
        for row, p in zip(stab_r, pivots):
            if v[p]:
                v ^= row
        return bool(v.any())

    for _ in range(iters):
        perm = rng.permutation(n)
        g = gf2.rref(gen[:, perm])
        g = g[g.any(axis=1)]
        # undo the permutation so candidates are in code coordinates
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)
        rows = g[:, inv]
        w = rows.sum(axis=1)
        order = np.argsort(w)
        light = []
        for i in order:
            v = rows[i]
            if is_logical(v):
                yield int(v.sum()), v
                light.append(v)
                break  # rows are weight-sorted: first logical = lightest
            if len(light) < pair_sweep:
                light.append(v)
        # pair sums of the lightest rows often dip below single rows
        for i in range(len(light)):
            for j in range(i + 1, len(light)):
                v = light[i] ^ light[j]
                if is_logical(v):
                    yield int(v.sum()), v


def min_distance_upper_bound(code, sector: str = "both", *,
                             iters: int = 60, seed: int = 0,
                             pair_sweep: int = 8):
    """Randomized information-set upper bound on the code distance.

    sector='x' bounds the X distance (min weight X-type logical),
    'z' the Z distance, 'both' returns min(d_x, d_z) — the code
    distance. Every reported value is certified by an explicit
    codeword; more `iters` can only tighten it."""
    hx = np.asarray(getattr(code, "redundant_parity_check_c1",
                            code.raw_parity_check_c1), np.uint8) & 1
    hz = np.asarray(getattr(code, "redundant_parity_check_c2",
                            code.raw_parity_check_c2), np.uint8) & 1
    best = {}
    if sector in ("x", "both"):
        # X-type logicals: in ker(H_Z), not a row combo of H_X
        ws = [w for w, _ in _logical_candidates(
            hz, hx, iters, seed, pair_sweep)]
        best["x"] = min(ws) if ws else None
    if sector in ("z", "both"):
        ws = [w for w, _ in _logical_candidates(
            hx, hz, iters, seed + 1, pair_sweep)]
        best["z"] = min(ws) if ws else None
    if sector == "both":
        vals = [v for v in best.values() if v is not None]
        return min(vals) if vals else None
    return best[sector]
