"""Encoding-network synthesis for CSS codes.

Produces the non-fault-tolerant |0̄⟩ / |+̄⟩ preparation circuits from the
standard-form parity checks, by the stabilizer-transformation derivation of
the reference (reference: css_code.py:203-312): starting from the all-|0⟩
stabilizer group ⟨Z_1..Z_n⟩, Hadamards move identity blocks to the X side
and CNOTs copy them across the A/E regions until the target check matrix
[I A1 A2 | 0; 0 0 0 | D I2 E; ...] is reached.

Gate order is identical to the reference's loops so that symplectic
verification tests agree exactly.
"""

from qcss_tpu_torch.circuits.ir import Circuit


def _commutes(a, b) -> bool:
    """Conservative gate commutation: True only when swapping a and b
    provably preserves the circuit unitary.

    Disjoint supports always commute. CNOT pairs commute when they share
    only controls or only targets (X-type on controls, Z-type... i.e. the
    standard CNOT commutation rules); Z-diagonal gates (Z, S, CZ) commute
    among themselves. Everything else sharing a qubit is treated as
    dependent."""
    qa, qb = set(a.qubits), set(b.qubits)
    if not (qa & qb):
        return True
    if a.name == "CNOT" and b.name == "CNOT":
        (c1, t1), (c2, t2) = a.qubits, b.qubits
        return c1 != t2 and c2 != t1
    _ZDIAG = ("Z", "S", "CZ", "PHASE")
    if a.name in _ZDIAG and b.name in _ZDIAG:
        return True
    return False


def depth_optimize(circ: Circuit) -> Circuit:
    """Reorder commuting gates to reduce circuit depth; unitary-identical.

    The reference emits prep networks row-by-row (css_code.py:203-312),
    which serializes every CNOT sharing a control: ASAP depth ~ the row
    weight times the overlap pattern. But CNOTs that share only controls
    or only targets commute, so the same GATE SET admits much shallower
    schedules — for the |0̄⟩ network the CNOT block is bipartite
    (controls in the first r1 qubits, targets beyond), where the optimal
    depth is the max qubit degree (König edge coloring). Shallow prep
    matters because idle noise is charged per layer: every data block
    idles through the full ancilla-prep depth each EC round
    (`ftqc.schedule._attempt_steps`).

    Greedy list scheduling over the commutation-relaxed dependency DAG:
    gates keep their relative order whenever they do not provably
    commute, so the product unitary is unchanged; each gate is placed in
    the earliest layer that respects its dependencies and one-gate-per-
    qubit-per-layer. O(T^2) pair analysis — prep networks are small."""
    gates = list(circ.gates)
    T = len(gates)
    layer = [0] * T
    # earliest layer a qubit is free at, tracked per occupied layer set:
    # a gate may fill an earlier gap only if no non-commuting earlier
    # gate sits at or after that slot, so per-qubit "occupied layers"
    # plus dependency lower bounds are both needed.
    occupied: dict[int, set] = {}
    dep_floor = [0] * T  # min allowed layer (1-based below)
    for i, g in enumerate(gates):
        lo = dep_floor[i] + 1
        qs = g.qubits
        t = lo
        while any(t in occupied.get(q, ()) for q in qs):
            t += 1
        layer[i] = t
        for q in qs:
            occupied.setdefault(q, set()).add(t)
        # propagate dependency floors to later non-commuting gates
        for j in range(i + 1, T):
            if dep_floor[j] < t and not _commutes(g, gates[j]):
                dep_floor[j] = t
    order = sorted(range(T), key=lambda i: (layer[i], i))
    return Circuit(gates[i] for i in order)


def encode_zero_network(code, qubits=None) -> Circuit:
    """|0̄⟩ preparation network (reference: css_code.py:203-260).

    H on the first r_1 qubits, then CNOT(i -> j) for every 1 in the
    A1/A2 region of the standard-form H_1. Qubits must start in |0⟩^n.
    """
    n, r1 = code.n, code.r_1
    qubits = list(range(n)) if qubits is None else list(qubits)
    h1 = code.parity_check_c1
    circ = Circuit()
    for i in range(r1):
        circ.h(qubits[i])
    for i in range(r1):
        for j in range(r1, n):
            if h1[i, j]:
                circ.cnot(qubits[i], qubits[j])
    return circ


def encode_state_network(code, qubits=None) -> tuple[Circuit, list[int]]:
    """Arbitrary-state encoding network: (circuit, input_qubits).

    Maps a k-qubit input state placed on the returned ``input_qubits``
    (the last k standard-form coordinates, all other qubits in |0⟩) onto
    the corresponding logical state of the code block — the general
    stabilizer encoder of Nielsen & Chuang §10.5.8, which the reference
    never builds (its preps are the fixed |0̄⟩/|+̄⟩ states only,
    reference: css_code.py:203-312).

    Construction: the |0̄⟩ network already maps Z on input qubit j to
    Z̄_j; what it lacks is the X̄ fan-out. Standard-form X̄_j =
    [0 E^T I3 | ...] has X support only on coordinates ≥ r_1 and
    includes its own input coordinate, so CNOTs from the input qubit to
    the rest of supp(X̄_j) put the |1⟩ branch on the coset
    representative, and the zero network's H/CNOT block (all controls
    < r_1) then symmetrizes both branches over the X-stabilizer span:
    α|0..0⟩ + β|x̄_j⟩ → α|0̄⟩ + β|1̄⟩ exactly (amplitudes stay real
    positive — no sign corrections needed). Statevector-verified in
    tests/test_encoding.py.
    """
    n, k, r1, r2 = code.n, code.k, code.r_1, code.r_2
    qubits = list(range(n)) if qubits is None else list(qubits)
    xbar = code.x_operator_matrix()
    circ = Circuit()
    inputs = []
    for j in range(k):
        q = r1 + r2 + j
        row = xbar[j]
        if not row[q] or row[:r1].any():
            raise ValueError("x_operator_matrix is not in standard form")
        inputs.append(qubits[q])
        for i in range(n):
            if row[i] and i != q:
                circ.cnot(qubits[q], qubits[i])
    circ.gates.extend(encode_zero_network(code, qubits).gates)
    return circ, inputs


def encode_plus_network(code, qubits=None) -> Circuit:
    """|+̄⟩ preparation network (reference: css_code.py:262-312).

    H on the first r_1 and the last k qubits; CNOT(j -> i) for the E region
    of the standard-form H_2; then the H_1 CNOTs as in `encode_zero_network`.
    """
    n, r1, r2 = code.n, code.r_1, code.r_2
    qubits = list(range(n)) if qubits is None else list(qubits)
    h1, h2 = code.parity_check_c1, code.parity_check_c2
    circ = Circuit()
    for i in range(r1):
        circ.h(qubits[i])
    for i in range(r1 + r2, n):
        circ.h(qubits[i])
    for i in range(r1, r1 + r2):
        for j in range(r1 + r2, n):
            if h2[i - r1, j]:
                circ.cnot(qubits[j], qubits[i])
    for i in range(r1):
        for j in range(r1, n):
            if h1[i, j]:
                circ.cnot(qubits[i], qubits[j])
    return circ
