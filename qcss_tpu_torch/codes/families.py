"""Standard CSS code family constructors.

The reference constructs codes only by passing raw parity-check matrices in
tests (reference: test/test_css_code.py:12-18); this module provides the
named families used across the framework's tests and benchmarks:
Steane [[7,1,3]], Shor [[9,1,3]], quantum Reed-Muller [[15,1,3]], rotated
surface codes d=3..11, triangular 6.6.6 color codes (self-dual, d=3,5,7...),
and toric codes (k=2, decode/extraction use only).
"""

from __future__ import annotations

import numpy as np

from qcss_tpu_torch.codes.css import CSSCode


def hamming_parity_check(r: int = 3) -> np.ndarray:
    """Parity check of the [2^r - 1, 2^r - 1 - r] Hamming code; column j
    (1-indexed) is the big-endian binary representation of j. For r=3 this
    is exactly the matrix used by the reference's tests
    (reference: test/test_css_code.py:13-18)."""
    n = (1 << r) - 1
    h = np.zeros((r, n), dtype=np.uint8)
    for j in range(1, n + 1):
        for bit in range(r):
            h[r - 1 - bit, j - 1] = (j >> bit) & 1
    return h


def steane(**kwargs) -> CSSCode:
    """The Steane [[7,1,3]] code: CSS(Hamming(7,4), Hamming(7,4))."""
    h = hamming_parity_check(3)
    return CSSCode(h, h, **kwargs)


def shor(**kwargs) -> CSSCode:
    """The Shor [[9,1,3]] code.

    X checks: X^6 over blocks (1,2) and (2,3); Z checks: Z_i Z_{i+1} within
    each 3-qubit block. Note the reference's unique-decoding-threshold logic
    reports t=0 for this code (degenerate weight-1 Z errors share a
    syndrome), which this constructor reproduces faithfully.
    """
    h_x = np.array(
        [
            [1, 1, 1, 1, 1, 1, 0, 0, 0],
            [0, 0, 0, 1, 1, 1, 1, 1, 1],
        ],
        dtype=np.uint8,
    )
    h_z = np.zeros((6, 9), dtype=np.uint8)
    for block in range(3):
        for i in range(2):
            h_z[2 * block + i, 3 * block + i] = 1
            h_z[2 * block + i, 3 * block + i + 1] = 1
    return CSSCode(h_x, h_z, **kwargs)


def reed_muller(m: int, **kwargs) -> CSSCode:
    """The quantum Reed-Muller [[2^m - 1, 1, 3]] code, m >= 4.

    H_X is the Hamming(2^m - 1) check (m rows); H_Z stacks all bitwise
    products of 1..(m-2) distinct H_X rows (the punctured RM(m-2, m)
    structure), so r_2 = sum_{j=1..m-2} C(m, j) and k = 1. Duality holds
    because any <= m-1 coordinate hyperplanes of the punctured cube
    intersect in an even number of points. The m=4 member is famous for a
    transversal T gate (outside the reference's Clifford-only
    classification).

    For m >= 5 the C_2 syndrome table is 2^{r_2} entries — far past LUT
    range — so tables are skipped by default (t=1 from the Hamming side);
    pass max_table_weight explicitly to build bounded tables.
    """
    from itertools import combinations

    if m < 4:
        raise ValueError("quantum Reed-Muller codes need m >= 4")
    h_x = hamming_parity_check(m)
    rows = []
    for deg in range(1, m - 1):
        for combo in combinations(range(m), deg):
            row = np.ones(h_x.shape[1], dtype=np.uint8)
            for i in combo:
                row &= h_x[i]
            rows.append(row)
    h_z = np.array(rows, dtype=np.uint8)
    if m >= 5:
        kwargs.setdefault("t", 1)
        kwargs.setdefault("max_table_weight", 0)
    return CSSCode(h_x, h_z, **kwargs)


def reed_muller_15(**kwargs) -> CSSCode:
    """The quantum Reed-Muller [[15,1,3]] code (= `reed_muller(4)`)."""
    return reed_muller(4, **kwargs)


def rotated_surface(d: int, **kwargs) -> CSSCode:
    """Rotated surface code of odd distance d: n = d^2 qubits, k = 1,
    (d^2-1)/2 checks of each type.

    Qubit (row, col) -> index row*d + col. Faces between rows (r, r+1) and
    cols (c, c+1) for r, c in [-1, d-1]; interior faces alternate X/Z by
    checkerboard parity, boundary half-faces survive only on the matching
    boundary type (X on top/bottom, Z on left/right).

    Syndrome-table construction is exponential in the check count, so by
    default tables are skipped and t = (d-1)//2 is set directly; pass
    ``max_table_weight`` to build bounded LUTs for small d.
    """
    if d % 2 == 0 or d < 3:
        raise ValueError("distance must be odd and >= 3")
    n = d * d

    def face_qubits(r: int, c: int) -> list[int]:
        out = []
        for dr in (0, 1):
            for dc in (0, 1):
                rr, cc = r + dr, c + dc
                if 0 <= rr < d and 0 <= cc < d:
                    out.append(rr * d + cc)
        return out

    x_rows, z_rows = [], []
    for r in range(-1, d):
        for c in range(-1, d):
            qubits = face_qubits(r, c)
            if len(qubits) < 2:
                continue
            is_x = (r + c) % 2 != 0
            if len(qubits) == 2:
                on_horizontal_boundary = r == -1 or r == d - 1
                # Weight-2 checks: X faces live on top/bottom, Z on sides.
                if on_horizontal_boundary != is_x:
                    continue
            row = np.zeros(n, dtype=np.uint8)
            row[qubits] = 1
            (x_rows if is_x else z_rows).append(row)

    h_x = np.array(x_rows, dtype=np.uint8)
    h_z = np.array(z_rows, dtype=np.uint8)
    kwargs.setdefault("t", (d - 1) // 2)
    kwargs.setdefault("max_table_weight", 0)
    return CSSCode(h_x, h_z, **kwargs)


def rotated_surface_rect(rows: int, cols: int, **kwargs) -> CSSCode:
    """Rectangular rotated surface code on a rows x cols qubit grid
    (both odd): n = rows*cols, k = 1, X distance = rows, Z distance =
    cols. `rotated_surface(d)` is the square case; the rectangle is the
    building block for lattice surgery (`experiments.surgery`), where a
    d x (2d+1) patch is two d x d patches merged through a seam column.

    Same conventions as `rotated_surface`: qubit (r, c) -> r*cols + c,
    interior faces alternate X/Z by checkerboard parity, X half-faces on
    top/bottom, Z half-faces on left/right (so Z̄ runs horizontally and
    terminates on the left/right boundaries — the merge boundaries)."""
    h_x, h_z = surface_rect_checks(rows, cols)
    kwargs.setdefault("t", (min(rows, cols) - 1) // 2)
    kwargs.setdefault("max_table_weight", 0)
    return CSSCode(h_x, h_z, **kwargs)


def surface_rect_checks(rows: int, cols: int) -> tuple[np.ndarray, np.ndarray]:
    """(h_x, h_z) check rows of the rows x cols rotated surface lattice
    in GEOMETRIC qubit order (qubit (r, c) -> r*cols + c, no standard-form
    column permutation) — the form lattice surgery needs to embed patches
    into a larger grid (`experiments.surgery`)."""
    if rows % 2 == 0 or cols % 2 == 0 or rows < 3 or cols < 3:
        raise ValueError("rows and cols must be odd and >= 3")
    n = rows * cols

    def face_qubits(r: int, c: int) -> list[int]:
        out = []
        for dr in (0, 1):
            for dc in (0, 1):
                rr, cc = r + dr, c + dc
                if 0 <= rr < rows and 0 <= cc < cols:
                    out.append(rr * cols + cc)
        return out

    x_rows, z_rows = [], []
    for r in range(-1, rows):
        for c in range(-1, cols):
            qubits = face_qubits(r, c)
            if len(qubits) < 2:
                continue
            is_x = (r + c) % 2 != 0
            if len(qubits) == 2:
                on_horizontal_boundary = r == -1 or r == rows - 1
                if on_horizontal_boundary != is_x:
                    continue
            row = np.zeros(n, dtype=np.uint8)
            row[qubits] = 1
            (x_rows if is_x else z_rows).append(row)
    return np.array(x_rows, dtype=np.uint8), np.array(z_rows, dtype=np.uint8)


def golay(**kwargs) -> CSSCode:
    """The quantum Golay code [[23,1,7]]: the self-dual CSS code built
    from the binary [23,12,7] Golay code (C⊥ ⊂ C, C⊥ doubly even with
    weights {0,8,12,16}), so the full transversal set {I, CNOT, H, CZ, S}
    holds at distance 7 — the classic high-distance code for
    transversal-Clifford fault tolerance (Steane 1999; no reference
    analogue — the reference ships no code constructors, SURVEY.md §2.5).

    Construction: the cyclic [23,12] Golay code is generated by
    g(x) = x^11 + x^10 + x^6 + x^5 + x^4 + x^2 + 1; the CSS parity check
    (both sectors) is a basis of its dual. Distance is certified in
    tests/test_golay.py by exhaustive minimum-weight-logical search.
    """
    from qcss_tpu_torch.ops import gf2

    g = np.zeros(23, dtype=np.uint8)
    g[[0, 2, 4, 5, 6, 10, 11]] = 1
    gen = np.array([np.roll(g, i) for i in range(12)], dtype=np.uint8)
    h = gf2.nullspace(gen)  # [11, 23] basis of the (doubly even) dual
    assert h.shape == (11, 23)
    assert not ((h.astype(np.int64) @ h.T.astype(np.int64)) & 1).any()
    kwargs.setdefault("t", 3)
    return CSSCode(h, h.copy(), **kwargs)


def triangular_color(d: int, **kwargs) -> CSSCode:
    """6.6.6 (hexagonal) triangular color code of odd distance d:
    n = (3d^2 + 1)/4 qubits, k = 1, self-dual (H_X = H_Z), so H and CZ are
    transversal at every distance — the family that extends the Steane
    code (its d=3 member) upward.

    Construction: triangular-lattice sites (a, b) with a, b >= 0 and
    a + b <= L, L = 3(d-1)/2. Sites with (a - b) ≡ 1 (mod 3) are face
    centers; the rest are qubits. Each face acts on the center's in-range
    lattice neighbours — weight 6 in the bulk, truncated to weight 4 on
    the boundary. Distance is verified computationally in
    tests/test_color.py (no reference counterpart: the reference ships no
    code constructors at all, SURVEY.md §2.5).

    Color codes are NOT matchable (bulk qubits sit in 3 same-sector
    checks), so decoding uses the LUT path; tables stay tractable through
    d=7 (2^18 syndromes).
    """
    if d % 2 == 0 or d < 3:
        raise ValueError("distance must be odd and >= 3")
    L = 3 * (d - 1) // 2
    pts = [(a, b) for a in range(L + 1) for b in range(L + 1 - a)]
    qubits = [p for p in pts if (p[0] - p[1]) % 3 != 1]
    centers = [p for p in pts if (p[0] - p[1]) % 3 == 1]
    idx = {p: i for i, p in enumerate(qubits)}
    n = len(qubits)
    rows = []
    for (a, b) in centers:
        nbrs = [(a + 1, b), (a - 1, b), (a, b + 1),
                (a, b - 1), (a + 1, b - 1), (a - 1, b + 1)]
        sup = [idx[p] for p in nbrs if p in idx]
        row = np.zeros(n, dtype=np.uint8)
        row[sup] = 1
        rows.append(row)
    h = np.array(rows, dtype=np.uint8)
    kwargs.setdefault("t", (d - 1) // 2)
    return CSSCode(h, h.copy(), **kwargs)


def toric(d: int, **kwargs) -> CSSCode:
    """Toric code on a d x d torus: n = 2d^2 edge qubits, k = 2.

    One dependent row of each check type is dropped so the parity checks are
    full rank (the constructor requires independent rows). k=2, so this is
    usable for syndrome extraction / decoding benchmarks only
    (``require_k1=False`` is forced).
    """
    n = 2 * d * d

    def h_edge(r, c):  # horizontal edge to the right of vertex (r, c)
        return (r % d) * d + (c % d)

    def v_edge(r, c):  # vertical edge below vertex (r, c)
        return d * d + (r % d) * d + (c % d)

    x_rows, z_rows = [], []
    for r in range(d):
        for c in range(d):
            # Vertex (star) operator: 4 incident edges -> X check.
            star = np.zeros(n, dtype=np.uint8)
            star[[h_edge(r, c), h_edge(r, c - 1), v_edge(r, c), v_edge(r - 1, c)]] = 1
            x_rows.append(star)
            # Plaquette operator: 4 boundary edges -> Z check.
            plaq = np.zeros(n, dtype=np.uint8)
            plaq[[h_edge(r, c), h_edge(r + 1, c), v_edge(r, c), v_edge(r, c + 1)]] = 1
            z_rows.append(plaq)

    h_x = np.array(x_rows[:-1], dtype=np.uint8)  # drop one dependent row
    h_z = np.array(z_rows[:-1], dtype=np.uint8)
    kwargs.setdefault("t", (d - 1) // 2)
    kwargs.setdefault("max_table_weight", 0)
    kwargs["require_k1"] = False
    return CSSCode(h_x, h_z, **kwargs)


def _attach_redundant_checks(code: CSSCode, h_x_full, h_z_full) -> CSSCode:
    """Attach the FULL (rank-deficient) check sets in the code's internal
    qubit order. BP decoding wants every check — redundant rows add free
    information — while the CSSCode constructor requires independent rows
    for standard-form reduction."""
    perm = code.column_perm
    code.redundant_parity_check_c1 = np.ascontiguousarray(h_x_full[:, perm])
    code.redundant_parity_check_c2 = np.ascontiguousarray(h_z_full[:, perm])
    return code


def _from_redundant_checks(h_x, h_z, d: int | None, **kwargs) -> CSSCode:
    """Build a CSSCode from possibly rank-deficient check sets, keeping the
    full redundant sets on the instance (see `_attach_redundant_checks`)."""
    from qcss_tpu_torch.ops import gf2

    h_x_ind = h_x[gf2.row_basis(h_x)]
    h_z_ind = h_z[gf2.row_basis(h_z)]
    kwargs.setdefault("t", (d - 1) // 2 if d is not None else 0)
    kwargs.setdefault("max_table_weight", 0)
    kwargs["require_k1"] = False
    code = CSSCode(h_x_ind, h_z_ind, **kwargs)
    return _attach_redundant_checks(code, h_x, h_z)


def bivariate_bicycle(l: int, m: int, a_terms, b_terms, *,
                      distance: int | None = None, **kwargs) -> CSSCode:
    """Bivariate bicycle (BB) qLDPC code over Z_l x Z_m (Bravyi et al.,
    Nature 627, 778 (2024)): data qubits are two lm-blocks, checks are

        H_X = [A | B],   H_Z = [B^T | A^T],

    with A, B sums of monomials x^i y^j (x = S_l ⊗ I_m, y = I_l ⊗ S_m
    cyclic shifts). A and B commute, so H_X · H_Z^T = AB + BA = 0 and the
    CSS duality holds for ANY term choice. Terms are (i, j) exponent
    pairs. No reference analogue — the reference ships no code
    constructors at all (SURVEY.md §2.5) and is limited to k=1; BB codes
    are k>1 memory/decoding codes for the BP(+OSD) path (`decode.bp`):
    weight-6 checks are not matchable, so UF/MWPM do not apply.

    Each check sector has lm rows of rank lm - k/2; the full redundant
    sets are kept as `redundant_parity_check_c1/c2` (internal qubit
    order) for BP decoding and syndrome extraction."""

    def shift_mat(size: int, s: int) -> np.ndarray:
        return np.eye(size, dtype=np.uint8)[:, (np.arange(size) + s) % size]

    def poly(terms) -> np.ndarray:
        out = np.zeros((l * m, l * m), dtype=np.uint8)
        for (i, j) in terms:
            out ^= np.kron(shift_mat(l, i), shift_mat(m, j))
        return out

    a = poly(a_terms)
    b = poly(b_terms)
    h_x = np.concatenate([a, b], axis=1)
    h_z = np.concatenate([b.T, a.T], axis=1)
    return _from_redundant_checks(h_x, h_z, distance, **kwargs)


def bb72(**kwargs) -> CSSCode:
    """[[72, 12, 6]] bivariate bicycle code (Bravyi et al. 2024, Table 3):
    l=6, m=6, A = x^3 + y + y^2, B = y^3 + x + x^2."""
    return bivariate_bicycle(6, 6, [(3, 0), (0, 1), (0, 2)],
                             [(0, 3), (1, 0), (2, 0)], distance=6, **kwargs)


def bb90(**kwargs) -> CSSCode:
    """[[90, 8, 10]] bivariate bicycle code: l=15, m=3,
    A = x^9 + y + y^2, B = 1 + x^2 + x^7."""
    return bivariate_bicycle(15, 3, [(9, 0), (0, 1), (0, 2)],
                             [(0, 0), (2, 0), (7, 0)], distance=10, **kwargs)


def bb144(**kwargs) -> CSSCode:
    """[[144, 12, 12]] bivariate bicycle code ("gross code"): l=12, m=6,
    A = x^3 + y + y^2, B = y^3 + x + x^2."""
    return bivariate_bicycle(12, 6, [(3, 0), (0, 1), (0, 2)],
                             [(0, 3), (1, 0), (2, 0)], distance=12, **kwargs)


def bb288(**kwargs) -> CSSCode:
    """[[288, 12, 18]] bivariate bicycle code: l=12, m=12,
    A = x^3 + y^2 + y^7, B = y^3 + x + x^2."""
    return bivariate_bicycle(12, 12, [(3, 0), (0, 2), (0, 7)],
                             [(0, 3), (1, 0), (2, 0)], distance=18, **kwargs)


def lifted_product(a, b, sizes, *, distance: int | None = None,
                   **kwargs) -> CSSCode:
    """Lifted-product code (Panteleev & Kalachev 2021) over the abelian
    group algebra F2[Z_{l1} x ... x Z_{lk}] — the family that contains
    BOTH of this module's qLDPC constructions as special cases:

    * trivial group ``sizes=(1,)``: exactly `hypergraph_product`
      (asserted in tests);
    * 1x1 base matrices over Z_l x Z_m: two-block (generalized-bicycle /
      bivariate-bicycle) codes — `bivariate_bicycle(l, m, A, B)` is
      `lifted_product([[A]], [[B*]], (l, m))` with B* the exponent-
      negated terms (asserted bit-identically in tests).

    ``a`` / ``b`` are ring matrices: nested lists [r][n] whose entries
    are term lists of exponent tuples (one int per group factor; [] is
    the ring zero). With A [r_a, n_a] and B [r_b, n_b],

        H_X = [A ⊗ I_{n_b} | I_{r_a} ⊗ B*]
        H_Z = [I_{n_a} ⊗ B  | A* ⊗ I_{r_b}]

    at the ring level (* = transpose with exponent negation, the group-
    algebra adjoint), then every entry lifts to its |G| x |G| regular-
    representation matrix. CSS duality holds structurally:
    H_X H_Z^T = A ⊗ B* + A ⊗ B* = 0 because the lift is a ring
    homomorphism with L(m)^T = L(m*). n = (n_a n_b + r_a r_b)·|G|.
    Full redundant check sets are kept for BP, like the other qLDPC
    constructors."""
    sizes = tuple(int(s) for s in sizes)
    D = int(np.prod(sizes))

    def norm(mat):
        return [[[tuple([t] if np.isscalar(t) else t) for t in cell]
                 for cell in row] for row in mat]

    a, b = norm(a), norm(b)

    def conj_t(m):
        return [[[tuple(-x % s for x, s in zip(t, sizes)) for t in m[i][j]]
                 for i in range(len(m))]
                for j in range(len(m[0]))]

    def ring_eye(n):
        zero_t = tuple(0 for _ in sizes)
        return [[[zero_t] if i == j else [] for j in range(n)]
                for i in range(n)]

    def ring_kron(x, y):
        rx, cx, ry, cy = len(x), len(x[0]), len(y), len(y[0])
        out = []
        for i in range(rx):
            for k in range(ry):
                row = []
                for j in range(cx):
                    for l_ in range(cy):
                        # product of monomial sets (one side is always a
                        # single monomial or empty here: kron with eye)
                        cell = []
                        for t1 in x[i][j]:
                            for t2 in y[k][l_]:
                                cell.append(tuple(
                                    (u + v) % s for u, v, s in
                                    zip(t1, t2, sizes)))
                        row.append(cell)
                out.append(row)
        return out

    def hstack(x, y):
        return [rx + ry for rx, ry in zip(x, y)]

    def shift_mat(size: int, s: int) -> np.ndarray:
        return np.eye(size, dtype=np.uint8)[:, (np.arange(size) + s)
                                            % size]

    def lift_entry(terms) -> np.ndarray:
        out = np.zeros((D, D), dtype=np.uint8)
        for t in terms:
            m = np.ones((1, 1), np.uint8)
            for x, s in zip(t, sizes):
                m = np.kron(m, shift_mat(s, x))
            out ^= m
        return out

    def lift(mat) -> np.ndarray:
        rows = []
        for row in mat:
            rows.append(np.concatenate([lift_entry(c) for c in row],
                                       axis=1))
        return np.concatenate(rows, axis=0)

    r_a, n_a = len(a), len(a[0])
    r_b, n_b = len(b), len(b[0])
    h_x = np.concatenate([lift(ring_kron(a, ring_eye(n_b))),
                          lift(ring_kron(ring_eye(r_a), conj_t(b)))],
                         axis=1)
    h_z = np.concatenate([lift(ring_kron(ring_eye(n_a), b)),
                          lift(ring_kron(conj_t(a), ring_eye(r_b)))],
                         axis=1)
    assert not ((h_x.astype(np.int64) @ h_z.T.astype(np.int64)) & 1).any()
    return _from_redundant_checks(h_x, h_z, distance, **kwargs)


def hypergraph_product(h_a, h_b, *, distance: int | None = None,
                       **kwargs) -> CSSCode:
    """Hypergraph-product code of two classical parity checks
    (Tillich & Zémor 2009): for H_a [r_a, n_a], H_b [r_b, n_b],

        H_X = [H_a ⊗ I_{n_b} | I_{r_a} ⊗ H_b^T]
        H_Z = [I_{n_a} ⊗ H_b | H_a^T ⊗ I_{r_b}]

    on n = n_a n_b + r_a r_b qubits with k = k_a k_b + k_a^T k_b^T.
    Duality holds structurally: H_X H_Z^T = H_a ⊗ H_b^T + H_a ⊗ H_b^T = 0.
    The toric code is the hypergraph product of two cyclic repetition
    codes; products of good classical LDPC codes give constant-rate qLDPC
    memories for the BP(+OSD) decoder."""
    h_a = np.asarray(h_a, dtype=np.uint8) & 1
    h_b = np.asarray(h_b, dtype=np.uint8) & 1
    r_a, n_a = h_a.shape
    r_b, n_b = h_b.shape
    h_x = np.concatenate([
        np.kron(h_a, np.eye(n_b, dtype=np.uint8)),
        np.kron(np.eye(r_a, dtype=np.uint8), h_b.T)], axis=1)
    h_z = np.concatenate([
        np.kron(np.eye(n_a, dtype=np.uint8), h_b),
        np.kron(h_a.T, np.eye(r_b, dtype=np.uint8))], axis=1)
    return _from_redundant_checks(h_x, h_z, distance, **kwargs)
