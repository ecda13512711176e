"""Exact host-side GF(2) linear algebra (numpy, uint8 0/1 matrices).

These kernels run once at code-construction time on the host; they are
required to be *bit-exact* against the reference implementation
(reference: bin_matrix.py:8-72, css_code.py:715-735,783-850), including the
exact column-swap (qubit-relabeling) sequence produced by standard-form
reduction and the exact contents of syndrome lookup tables.

All matrices are numpy arrays over {0,1}; arithmetic is XOR.
"""

from itertools import combinations, islice

import numpy as np

from qcss_tpu_torch.errors import InvalidCodeError


def _as_gf2(mat) -> np.ndarray:
    """Coerce to a uint8 0/1 array (values are reduced mod 2)."""
    return np.asarray(mat, dtype=np.int64).astype(np.uint8) & 1


def rref(mat) -> np.ndarray:
    """Reduced row echelon form over GF(2).

    Column-major sweep with first-available pivot row, matching the pivot
    order of the reference (reference: bin_matrix.py:8-34) so the canonical
    form — and therefore `codes_equal` — agrees bit-for-bit.
    """
    m = _as_gf2(mat).copy()
    rows, cols = m.shape
    r = 0
    for c in range(cols):
        pivots = np.nonzero(m[r:, c])[0]
        if pivots.size == 0:
            continue
        if m[r, c] == 0:
            m[r, :] ^= m[r + pivots[0], :]
        # Clear every other 1 in this column with row r.
        elim = m[:, c].copy()
        elim[r] = 0
        m ^= np.outer(elim, m[r, :])
        r += 1
        if r == rows:
            break
    return m


def rank(mat) -> int:
    """Rank of a binary matrix over GF(2)."""
    reduced = rref(mat)
    return int(np.count_nonzero(reduced.any(axis=1)))


def row_basis(mat) -> np.ndarray:
    """Indices of a maximal linearly independent subset of rows over GF(2).

    Greedy in row order (the first row of every dependent group is kept),
    so for a redundant check matrix the selected subset preserves the
    original row semantics. Used by qLDPC constructors whose natural check
    sets are rank-deficient (e.g. bivariate-bicycle codes, where each
    sector's lm checks have rank lm - k/2)."""
    m = _as_gf2(mat)
    rows, cols = m.shape
    work = np.zeros((0, cols), dtype=np.uint8)
    kept: list[int] = []
    for i in range(rows):
        v = m[i].copy()
        for w in work:
            piv = int(np.argmax(w))
            if w[piv] and v[piv]:
                v ^= w
        if v.any():
            kept.append(i)
            work = np.vstack([work, v])
    return np.asarray(kept, dtype=np.int64)


def nullspace(mat) -> np.ndarray:
    """Basis for the right nullspace over GF(2), one vector per row.

    Returned rows satisfy ``mat @ v == 0 (mod 2)``.
    """
    m = rref(mat)
    rows, cols = m.shape
    # Pivot column of each nonzero row.
    pivot_cols = []
    for i in range(rows):
        nz = np.nonzero(m[i])[0]
        if nz.size:
            pivot_cols.append(int(nz[0]))
    free_cols = [c for c in range(cols) if c not in pivot_cols]
    basis = np.zeros((len(free_cols), cols), dtype=np.uint8)
    for bi, fc in enumerate(free_cols):
        basis[bi, fc] = 1
        for ri, pc in enumerate(pivot_cols):
            basis[bi, pc] = m[ri, fc]
    return basis


def vec_to_int(vec) -> int:
    """Big-endian bit vector -> int (reference: bin_matrix.py:36-43)."""
    out = 0
    for b in np.asarray(vec).reshape(-1):
        out = (out << 1) | int(b) & 1
    return out


def int_to_vec(value: int, n: int) -> np.ndarray:
    """Int -> big-endian bit vector of length n; raises ValueError if n is
    too small (reference: bin_matrix.py:45-55)."""
    vec = np.zeros(n, dtype=np.uint8)
    v = int(value)
    for i in reversed(range(n)):
        vec[i] = v & 1
        v >>= 1
    if v != 0:
        raise ValueError("n is too small")
    return vec


def weight_w_vectors(n: int, w: int):
    """Yield all length-n binary vectors of Hamming weight w, in the same
    (lexicographic-support) order as the reference's recursive enumeration
    (reference: bin_matrix.py:57-72) — i.e. `itertools.combinations` order.
    """
    for support in combinations(range(n), w):
        vec = np.zeros(n, dtype=np.uint8)
        vec[list(support)] = 1
        yield vec


def swap_columns(mat: np.ndarray, i: int, j: int) -> None:
    """In-place column swap (reference: css_code.py:783-785)."""
    mat[:, [i, j]] = mat[:, [j, i]]


def normalize_parity_check(h, offset: int):
    """Gaussian elimination placing an identity block at columns
    [offset, offset+r); returns ``(matrix, qubit_swaps)``.

    When a pivot cannot be found among the remaining rows, columns (qubits)
    are swapped instead and the swap is recorded so the caller can mirror the
    relabeling into the partner matrix. Raises InvalidCodeError if the rows
    are linearly dependent. Semantics — including the exact swap sequence —
    match the reference (reference: css_code.py:809-836).
    """
    h = _as_gf2(h).copy()
    r, n = h.shape
    if n < offset + r:
        raise ValueError("not enough columns")

    qubit_swaps = []
    for i in range(r):
        col = i + offset
        below = np.nonzero(h[i:, col])[0]
        if below.size:
            if h[i, col] == 0:
                h[i, :] ^= h[i + below[0], :]
        else:
            # No remaining row has a 1 here: relabel qubits by swapping in a
            # column where row i has a 1.
            candidates = np.nonzero(h[i, col:])[0]
            if candidates.size == 0:
                raise InvalidCodeError("rows are not independent")
            swap = (col, col + int(candidates[0]))
            qubit_swaps.append(swap)
            swap_columns(h, *swap)
        # Clear the pivot column in every other row.
        elim = h[:, col].copy()
        elim[i] = 0
        h ^= np.outer(elim, h[i, :])
    return h, qubit_swaps


def codes_equal(h1, h2) -> bool:
    """Whether two parity checks generate the same code (RREF equality,
    reference: css_code.py:838-844)."""
    h1, h2 = _as_gf2(h1), _as_gf2(h2)
    if h1.shape != h2.shape:
        return False
    return np.array_equal(rref(h1), rref(h2))


def is_doubly_even(mat) -> bool:
    """All row weights divisible by 4 (reference: css_code.py:846-850)."""
    return not np.any(np.sum(_as_gf2(mat), axis=1) % 4)


def transversal_t_power(stab_rows, logical_row) -> int | None:
    """The c such that physical ``T^⊗n`` implements logical ``T^c`` on the
    k=1 CSS code with X-stabilizer generators `stab_rows` and logical-X
    representative `logical_row`, or None if ``T^⊗n`` does not preserve the
    codespace.

    ``T^⊗n`` multiplies each computational basis state |v⟩ by
    ``exp(iπ|v|/4)``; it preserves the code basis states (superpositions
    over X-stabilizer cosets) iff |v| mod 8 is constant on each coset. Via
    the inclusion-exclusion identity ``|a⊕b| = |a| + |b| - 2|a∧b|``
    (coefficients 2^{|T|-1}, so AND-depths ≥ 4 vanish mod 8), constancy is
    equivalent to generator-level triorthogonality conditions
    (Bravyi & Haah, "Magic state distillation with low overhead", PRA 86,
    052329 (2012)):

      * every stabilizer generator weight ≡ 0 (mod 8)
      * every pairwise AND of generators has weight ≡ 0 (mod 4)
      * every triple AND of generators has weight ≡ 0 (mod 2)
      * logical ∧ generator weights ≡ 0 (mod 4)
      * logical ∧ generator-pair weights ≡ 0 (mod 2)

    All five are checked directly (O(r³) popcounts — no coset
    enumeration), so the test runs at any code size. When they hold, the
    coset weights are |x̄| mod 8, i.e. ``T^⊗n = diag(1, e^{iπ|x̄|/4})`` on
    the logical qubit: c = |x̄| mod 8. The [[15,1,3]] quantum Reed-Muller
    code returns c = 7 (transversal T = logical T†, so transversal T†
    implements logical T). The reference classifies Clifford transversal
    gates only; its non-Clifford path is an explicit stub
    (reference: css_code.py:433-434).
    """
    g = _as_gf2(stab_rows)
    x = _as_gf2(logical_row).reshape(-1)
    r = g.shape[0]
    if np.any(np.sum(g, axis=1, dtype=np.int64) % 8):
        return None
    for i in range(r):
        gi = g[i]
        if np.sum(x & gi, dtype=np.int64) % 4:
            return None
        pair = g[i + 1:] & gi
        if np.any(np.sum(pair, axis=1, dtype=np.int64) % 4):
            return None
        if np.any(np.sum(pair & x, axis=1, dtype=np.int64) % 2):
            return None
        for j in range(i + 1, r):
            if np.any(np.sum(g[j + 1:] & (gi & g[j]), axis=1,
                             dtype=np.int64) % 2):
                return None
    return int(np.sum(x, dtype=np.int64) % 8)


def _native_table(parity_check: np.ndarray, limit: int, stop_on_collision: bool):
    """Try the C++ enumerator (qcss_tpu_torch.native); None on unavailability.
    Semantics are identical to the Python paths below — covered by
    equivalence tests."""
    try:
        from qcss_tpu_torch import native
    except ImportError:  # pragma: no cover
        return None
    result = native.syndrome_table_native(parity_check, limit, stop_on_collision)
    if result is None:
        return None
    t, keys, errors = result
    return t, {k: errors[i] for i, k in enumerate(keys)}


def syndrome_table(parity_check, max_weight: int | None = None):
    """Unique-decoding threshold t and syndrome -> minimum-weight-error table.

    Enumerates errors by increasing weight; stops at the first weight where
    two errors share a syndrome (with one another or with a lighter error)
    and returns ``(t, table)`` where t is the last completed weight.
    Table keys are big-endian syndrome ints; values are length-n error
    vectors. Contents are bit-exact vs the reference (reference:
    css_code.py:715-735).

    ``max_weight`` bounds the enumeration for large codes (LUT decoding is
    exponential in the number of checks); when hit without a collision the
    returned t is ``max_weight`` and the table covers all errors of weight
    <= max_weight.
    """
    parity_check = _as_gf2(parity_check)
    _, n = parity_check.shape
    limit = n if max_weight is None else min(max_weight, n)

    native = _native_table(parity_check, limit, stop_on_collision=True)
    if native is not None:
        return native

    table: dict[int, np.ndarray] = {}
    for w in range(limit + 1):
        # Enumerate weight-w errors in bounded chunks and compute each
        # chunk's syndromes in one mod-2 matmul (the reference does a Python
        # loop with one matmul per error — reference: css_code.py:724-732).
        # Chunking keeps peak memory bounded for large C(n, w) while
        # preserving the reference's enumeration (and collision-stop) order.
        w_table: dict[int, np.ndarray] = {}
        for errs in _weight_w_chunks(n, w):
            syndromes = (errs.astype(np.int64) @ parity_check.T.astype(np.int64)) & 1
            for row in range(errs.shape[0]):
                key = vec_to_int(syndromes[row])
                if key in table or key in w_table:
                    return w - 1, table
                w_table[key] = errs[row]
        table.update(w_table)
    return limit, table


def _weight_w_chunks(n: int, w: int, chunk: int = 1 << 20):
    """Yield all weight-w error vectors on n bits as [<=chunk, n] uint8
    blocks, in `itertools.combinations` order."""
    it = combinations(range(n), w)
    while True:
        supports = list(islice(it, chunk))
        if not supports:
            return
        errs = np.zeros((len(supports), n), dtype=np.uint8)
        for row, support in enumerate(supports):
            errs[row, list(support)] = 1
        yield errs


def min_weight_table(parity_check, max_weight: int) -> dict[int, np.ndarray]:
    """Syndrome -> *a* minimum-weight error, without collision-stop.

    Unlike `syndrome_table` (which halts at the first collision, faithfully
    reproducing the reference's unique-decoding threshold — reference:
    css_code.py:715-735), this keeps the first (hence minimum-weight) error
    seen per syndrome. For degenerate codes such as the surface code this is
    the standard minimum-weight lookup decoder: a collision between two
    equal-weight errors with the same syndrome is harmless when they differ
    by a stabilizer.
    """
    parity_check = _as_gf2(parity_check)
    _, n = parity_check.shape

    native = _native_table(parity_check, min(max_weight, n), stop_on_collision=False)
    if native is not None:
        return native[1]

    table: dict[int, np.ndarray] = {}
    for w in range(min(max_weight, n) + 1):
        for errs in _weight_w_chunks(n, w):
            syndromes = (errs.astype(np.int64) @ parity_check.T.astype(np.int64)) & 1
            for row in range(errs.shape[0]):
                key = vec_to_int(syndromes[row])
                if key not in table:
                    table[key] = errs[row]
    return table


def correction_lut(parity_check, table: dict[int, np.ndarray]) -> np.ndarray:
    """Densify a syndrome table into a ``[2^r, n]`` uint8 gather array for
    device-side decoding. Unknown syndromes (beyond the unique-decoding
    threshold) map to the zero correction, matching the reference semantics
    of leaving the error vector unchanged (reference: css_code.py:649-685).
    """
    parity_check = _as_gf2(parity_check)
    r, n = parity_check.shape
    lut = np.zeros((1 << r, n), dtype=np.uint8)
    for key, err in table.items():
        lut[key] = err
    return lut
