"""Flag-qubit error correction: host-side construction.

Steane EC verifies a whole encoded ancilla block (n qubits + an n-qubit
verifier) per extraction; flag EC (Chao & Reichardt, arXiv:1705.02329;
Chamberland & Beverland, arXiv:1708.02246) measures each stabilizer with
TWO bare qubits — a syndrome ancilla and a flag. The ancilla couples to
the stabilizer's support sequentially, so a single mid-extraction ancilla
fault can spread onto several data qubits (a "hook"); the flag, coupled
before and after the dangerous window, fires on exactly those faults, and
a flag-conditioned lookup table corrects the hook exactly.

This module builds everything the executor needs, per check sector:

* an ordered CNOT schedule per stabilizer row, searched so that the
  possible hooks are DISTINGUISHABLE: any two flagged-window faults with
  the same re-measured syndrome must differ by a stabilizer (otherwise a
  single fault could be mis-corrected into a logical error — the
  CNOT-ordering condition of the flag papers);
* the flag-conditioned correction tables [r, 2^r_opp, n] (hook entries
  take precedence; remaining syndromes fall back to the standard LUT);
* static step counts for idle-noise accounting.

Hook direction bookkeeping: measuring a Z-type stabilizer (a row of H2,
which detects X errors) hooks deposit Z errors on data — so the flags of
the H2 extraction condition the Z-error decode (H1 syndromes), and vice
versa.

The reference has no flag machinery (its only EC is Steane-style with
encoded ancillas — reference: css_code.py:436-470); restricted to t = 1
codes, where the single-flag protocol is fault-tolerant.
"""

from __future__ import annotations

from itertools import islice, permutations
from typing import NamedTuple

import numpy as np

from qcss_tpu_torch.errors import InvalidCodeError
from qcss_tpu_torch.ops import gf2

#: permutations tried per stabilizer before giving up (exhaustive for
#: weight <= 6 supports)
_MAX_ORDERINGS = 720


class FlagSector(NamedTuple):
    """One check sector's flag-extraction data.

    ``supports``: list of int32 arrays — the ordered CNOT schedule per
    stabilizer row of this sector's check matrix.
    ``cond_lut``: [r, 2^r_opp, n] uint8 — for a flag on row i, the
    correction (in the OPPOSITE error sector) keyed by the re-measured
    opposite-sector syndrome.
    """

    supports: tuple[np.ndarray, ...]
    cond_lut: np.ndarray


class FlagData(NamedTuple):
    z_sector: FlagSector     # H2 rows (X-error syndromes; hooks are Z errors)
    x_sector: FlagSector     # H1 rows (Z-error syndromes; hooks are X errors)
    steps_flagged: int       # total elementary steps, flagged extraction
    steps_unflagged: int
    idle_steps_flagged: np.ndarray    # [n] per-data-qubit idle steps during
    idle_steps_unflagged: np.ndarray  # one full (both-sector) extraction


def _in_rowspace(vec: np.ndarray, rows: np.ndarray) -> bool:
    """vec ∈ GF(2)-rowspace(rows)?"""
    if not vec.any():
        return True
    stacked = np.concatenate([rows, vec[None, :]], axis=0)
    return gf2.rank(stacked) == gf2.rank(rows)


def _hooks(order: np.ndarray, n: int) -> list[np.ndarray]:
    """Candidate hook errors of one flagged stabilizer extraction with CNOT
    schedule `order`: a fault in the flag window after the s-th data CNOT
    spreads onto the remaining supports (s = 1..w-1), plus the empty set
    (pre-window faults reduce to the full row ≡ identity)."""
    out = [np.zeros(n, np.uint8)]
    for s in range(1, len(order)):
        e = np.zeros(n, np.uint8)
        e[order[s:]] = 1
        out.append(e)
    return out


def _ordering_valid(order: np.ndarray, h_opp: np.ndarray,
                    stab_rows: np.ndarray, n: int) -> bool:
    """All hook pairs with equal opposite-sector syndrome must differ by a
    stabilizer of the hooks' type."""
    hooks = _hooks(order, n)
    syns = [tuple((h_opp @ e) % 2) for e in hooks]
    for i in range(len(hooks)):
        for j in range(i + 1, len(hooks)):
            if syns[i] == syns[j] and not _in_rowspace(
                    hooks[i] ^ hooks[j], stab_rows):
                return False
    return True


def _find_order(row: np.ndarray, h_opp: np.ndarray,
                stab_rows: np.ndarray) -> np.ndarray:
    """Search CNOT schedules for one stabilizer row: natural, reversed,
    then lexicographic permutations (exhaustive for w <= 6)."""
    n = row.shape[0]
    sup = np.nonzero(row)[0].astype(np.int32)
    candidates = [sup, sup[::-1]]
    if len(sup) <= 6:
        candidates += [np.asarray(p, np.int32)
                       for p in islice(permutations(sup), _MAX_ORDERINGS)]
    for order in candidates:
        if _ordering_valid(order, h_opp, stab_rows, n):
            return np.ascontiguousarray(order)
    raise InvalidCodeError(
        "no flag-distinguishable CNOT ordering found for stabilizer "
        f"{row.tolist()}"
    )


def _sector(h: np.ndarray, h_opp: np.ndarray, stab_rows: np.ndarray,
            lut_opp: np.ndarray) -> FlagSector:
    """Build one sector: CNOT schedules for every row of `h`, and the
    flag-conditioned tables keyed by `h_opp` syndromes. `stab_rows` spans
    the stabilizers of the HOOK error type (= rows of this sector's own
    matrix: Z-stabilizer hooks are Z errors, equivalent modulo Z-type
    stabilizer rows). `lut_opp` is the standard table for unmatched
    syndromes."""
    r, n = h.shape
    r_opp = h_opp.shape[0]
    supports = tuple(_find_order(h[i], h_opp, stab_rows) for i in range(r))
    cond = np.tile(np.asarray(lut_opp, np.uint8)[None], (r, 1, 1))
    weights = 1 << np.arange(r_opp - 1, -1, -1)  # big-endian, gf2_jax order
    for i, order in enumerate(supports):
        for e in _hooks(order, n):
            s = int(((h_opp @ e) % 2) @ weights)
            # hooks take precedence over the LUT fallback; syndrome-0 hooks
            # are stabilizer elements (the ordering check guarantees it) —
            # keep the identity there instead of polluting frames
            if s != 0:
                cond[i, s] = e
    return FlagSector(supports=supports, cond_lut=cond)


def build_flag_data(code) -> FlagData:
    """Flag-EC data for a t = 1 CSS code (standard-form check rows, so the
    syndrome bit order matches the code's device LUTs)."""
    if code.t != 1:
        raise InvalidCodeError(
            "flag EC implements the single-flag distance-3 protocol; "
            f"code has t = {code.t}"
        )
    h1 = np.asarray(code.parity_check_c1, np.uint8) & 1
    h2 = np.asarray(code.parity_check_c2, np.uint8) & 1
    dev = code.device
    if dev.lut_c1 is None or dev.lut_c2 is None:
        raise InvalidCodeError(
            "flag EC needs syndrome LUTs; construct the code with "
            "max_table_weight >= t (surface codes skip tables by default)"
        )
    lut1 = np.asarray(dev.lut_c1, np.uint8)
    lut2 = np.asarray(dev.lut_c2, np.uint8)
    # H2 rows (Z-type stabilizers): hooks are Z errors — syndromes under
    # h1, equivalence modulo h2 rows, fallback lut1. Mirrored for H1.
    z_sector = _sector(h2, h1, h2, lut1)
    x_sector = _sector(h1, h2, h1, lut2)

    n = code.n
    # Step counts: reset(1) + basis prep + w data CNOTs + 2 flag CNOTs +
    # basis unprep + measure(1). Z-type rows: flag is |+>-prepped/H-measured
    # (2 extra 1q layers); X-type rows: the ancilla is (2 extra layers).
    def steps(sector_supports, flagged):
        total = 0
        for sup in sector_supports:
            w = len(sup)
            total += (w + 6) if flagged else (w + 2 + 2)
        return total

    # per-qubit busy steps: one CNOT layer per stabilizer containing it
    busy = (h1.sum(axis=0) + h2.sum(axis=0)).astype(np.int64)
    sf = steps(z_sector.supports, True) + steps(x_sector.supports, True)
    su = steps(z_sector.supports, False) + steps(x_sector.supports, False)
    return FlagData(
        z_sector=z_sector,
        x_sector=x_sector,
        steps_flagged=sf,
        steps_unflagged=su,
        idle_steps_flagged=np.maximum(sf - busy, 0).astype(np.int64),
        idle_steps_unflagged=np.maximum(su - busy, 0).astype(np.int64),
    )
