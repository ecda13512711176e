"""Physical-protocol execution of compiled logical programs on the
batched stabilizer-tableau engine.

This is the PROTOCOL, not the fault model: every phase's stabilizer
extraction rounds run as real projective measurements (data-collection
CNOTs onto dedicated Z-check ancillas; H-sandwiched fan-outs for the
X checks), transitions perform the declared scored readouts / silent
conjugate measurements / conjugate-basis initializations, and the
final word is read transversally — producing the raw outcome vector(s)
the builder's outcome-space recipes (`build(with_recipe=True)` /
`build_x(with_recipe=True)`) consume. The tableau golds in
tests/test_logical.py assert every detector combination is zero and
every observable combination matches the truth table on random
measurement branches; users can run it to sanity-check a compiled
schedule against the actual stabilizer protocol.

Port of `qcss_tpu.experiments.protocol` onto the port's unpacked
tableau (`sim.tableau`), on ``device`` (the card unless the caller asks
for the CPU). Each round runs its checks' gates in one
`run_circuit_scanned` pass and measures their ancillas in one
`measure_many`, then X-resets the ancillas that read 1; the collapse
bits come from an explicit `torch.Generator` (one draw a
`measure_many`), where the JAX package splits a key. The JAX package's
NOP padding to shared shapes and its executable-cache clearing serve
its compiler only and are dropped.

The reference has no multi-patch machinery and its only protocol
runner is the external QVM process (reference: ftqc.py:42-120).
"""

from __future__ import annotations

import numpy as np
import torch

from qcss_tpu_torch._cuda import resolve_device


def run_compiled_protocol(prog, model, generator, *, prep_x_flips=(),
                          skip_h_phases=(), x_model=None,
                          final_basis="z", premeasure_x=None,
                          device="cuda"):
    """Run a `LogicalProgram`'s compiled schedule projectively.

    Returns the raw outcome vector in `model`'s recipe order. With
    `x_model` (a `build_x(with_recipe=True)` model) the SAME run also
    measures every phase's X checks and the X-basis measure-outs,
    returning `(outcomes, outcomes_x, pre)`; `final_basis='x'` reads
    the final word transversally in X (the X recipe's boundary
    convention — the Z recipe's final slots are then meaningless).
    `premeasure_x` is an optional `(phase, support)`: measure that
    X-type operator projectively at the start of the phase (after its
    conjugate inits) and return the outcome in `pre` — the reference
    value for preserved X products like the T gadget's X̄_D X̄_M.

    One sample's tableau lives on ``device``; ``generator`` (a
    `torch.Generator` on the same kind of device) draws the collapse
    bits of every measurement, in program order.
    """
    from qcss_tpu_torch.experiments import surgery
    from qcss_tpu_torch.sim import tableau as tb

    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, tableau on "
                         f"{device}: draw collapse bits where they are used")

    n = prog.n
    rz_max = max(ph.checks.shape[0] for ph in prog._phases)
    rx_max = max(h.shape[0] for h in prog._conj_checks)
    anc_z, anc_x = n, n + rz_max
    measure_x_checks = x_model is not None

    recipe = model.meta["recipe"]
    n_meas, n_read = recipe["n_meas"], recipe["n_read"]
    outcomes = np.zeros(n_meas + n_read + n, np.uint8)
    meas_pos = {k: i for i, k in enumerate(recipe["meas_order"])}
    read_pos = {k: i for i, k in enumerate(recipe["read_order"])}

    outcomes_x = None
    meas_pos_x = read_pos_x = None
    pre: list[int] = []
    if x_model is not None:
        recipe_x = x_model.meta["recipe"]
        outcomes_x = np.zeros(recipe_x["n_meas"] + recipe_x["n_read"] + n,
                              np.uint8)
        meas_pos_x = {k: i for i, k in enumerate(recipe_x["meas_order"])}
        read_pos_x = {k: i for i, k in enumerate(recipe_x["read_order"])}

    t = tb.zero_state(1, n + rz_max + rx_max, device=device)

    # transversal-H frame ops rotate patches mid-program: from the
    # recorded boundary on, the Z-sector model's rows on those qubits
    # are PHYSICALLY X-type operators (and the X-sector's rows Z-type)
    # — see LogicalProgram.h. rot_phase[ph, q] = 1 when qubit q is
    # rotated during phase ph; rot_phase[n_ph] is the end state.
    frame_ops = model.meta.get("frame_ops")
    n_ph_total = len(prog._phases)
    rot_phase = np.zeros((n_ph_total + 1, n), np.uint8)
    if frame_ops:
        for kind, b, qubits in frame_ops:
            if kind == "h":
                rot_phase[b:, list(qubits)] ^= 1

    # -- per-phase round programs -----------------------------------------
    # X and Z extraction run as SEPARATE segments (gates + measure +
    # reset each): within a segment the parallel per-check circuits
    # measure exactly their check operators (distinct ancillas;
    # same-segment CNOTs on a shared data qubit commute through each
    # other's measured chains), but a Z-collect and an X-fan-out on the
    # same data qubit do not — interleaving them in one pre-measurement
    # pass would contaminate the measured operators.
    def segment_arrays(ph, sector):
        ops, q0, q1 = [], [], []
        h = prog._phases[ph].checks if sector == "z" \
            else prog._conj_checks[ph]
        base = anc_z if sector == "z" else anc_x
        rot = rot_phase[ph]
        for c in range(h.shape[0]):
            sup = np.nonzero(h[c])[0]
            r = bool(rot[sup].any())
            if r:
                assert rot[sup].all(), \
                    "check row straddles a rotation boundary"
            # a rotated patch's Z-sector rows are X-type measurements
            # (and vice versa); unrotated rows keep their sector type
            as_x = (sector == "z") == r
            a = base + c
            if as_x:
                ops.append(4)                  # H sandwich
                q0.append(a)
                q1.append(0)
                for j in sup:
                    ops.append(6)              # CNOT X ancilla -> data
                    q0.append(a)
                    q1.append(int(j))
                ops.append(4)
                q0.append(a)
                q1.append(0)
            else:
                for j in sup:
                    ops.append(6)              # CNOT data -> Z ancilla
                    q0.append(int(j))
                    q1.append(a)
        ancs = [base + c for c in range(h.shape[0])]
        return ops, q0, q1, ancs

    sectors = ("x", "z") if measure_x_checks else ("z",)
    segments = {s: [segment_arrays(ph, s)
                    for ph in range(len(prog._phases))] for s in sectors}

    def measured(qubits):
        """Z-measure ``qubits`` in order; the outcomes on the host."""
        nonlocal t
        t, outs = tb.measure_many(t, qubits, generator)
        return outs[0].cpu().numpy()

    def x_where_one(qubits, outs):
        """Conditional reset: X on the qubits that read 1."""
        nonlocal t
        ones = [int(qb) for qb, b in zip(qubits, outs) if b]
        if ones:
            t = tb.apply_x_many(t, ones)

    def run_segment(ph, sector):
        nonlocal t
        ops, q0, q1, ancs = segments[sector][ph]
        t = tb.run_circuit_scanned(t, ops, q0, q1)
        outs = measured(ancs)
        x_where_one(ancs, outs)
        return outs

    def measure_in_z(qubits, reset_to_zero=True):
        """Batched scored-basis readout: measure, conditionally X back."""
        outs = measured(qubits)
        if reset_to_zero:
            x_where_one(qubits, outs)
        return outs

    def measure_in_x(qubits):
        """Batched conjugate-basis measure-out: H, measure, X-reset."""
        nonlocal t
        t = tb.apply_h_many(t, qubits)
        outs = measured(qubits)
        x_where_one(qubits, outs)
        return outs

    def measure_x_op(support):
        """One X-type operator projectively via the first Z ancilla."""
        nonlocal t
        sup = [int(qb) for qb in np.nonzero(support)[0]]
        ops = [4] + [6] * len(sup) + [4]
        q0 = [anc_z] + [anc_z] * len(sup) + [anc_z]
        q1 = [0] + sup + [0]
        t = tb.run_circuit_scanned(t, ops, q0, q1)
        out = measure_in_z([anc_z])
        return int(out[0])

    def measure_z_op(support):
        """One Z-type operator projectively via the first Z ancilla."""
        nonlocal t
        sup = [int(qb) for qb in np.nonzero(support)[0]]
        t = tb.run_circuit_scanned(t, [6] * len(sup), sup,
                                   [anc_z] * len(sup))
        out = measure_in_z([anc_z])
        return int(out[0])

    def prep_encoded_plus(ph, qubits, with_h=True):
        """Encoded-arrival prep of a fresh block (LogicalProgram._prep
        encoded=True): transversal H to |+⟩^⊗n (X checks +1), then
        project the phase's Z checks on the block and apply the GF(2)
        X-type fixup so they all read +1 — an encoded |+̄⟩ with EVERY
        stabilizer deterministic, the state an injection factory hands
        over. with_h=False skips the H (the Z-definite |0̄⟩ stand-in:
        Z checks already +1, then the X-check projection + Z fixup
        makes it encoded |0̄⟩)."""
        nonlocal t
        qset = set(int(qb) for qb in qubits)
        if with_h:
            t = tb.apply_h_many(t, sorted(qset))
            h = prog._phases[ph].checks
            rows = [c for c in range(h.shape[0])
                    if h[c].any() and set(np.nonzero(h[c])[0]) <= qset]
            outs = [measure_z_op(h[c]) for c in rows]
            fix = surgery._solve_gf2(h[rows].T,
                                     np.asarray(outs, np.uint8))
            assert fix is not None
            if fix.any():
                t = tb.apply_x_many(t, np.nonzero(fix)[0])
        else:
            h = prog._conj_checks[ph]
            rows = [c for c in range(h.shape[0])
                    if h[c].any() and set(np.nonzero(h[c])[0]) <= qset]
            outs = [measure_x_op(h[c]) for c in rows]
            fix = surgery._solve_gf2(h[rows].T,
                                     np.asarray(outs, np.uint8))
            assert fix is not None
            if fix.any():
                t = tb.apply_z_many(t, np.nonzero(fix)[0])

    # -- data preparation: |0...0⟩, X checks projected with Z fixups ------
    # phase 0's conjugate check set IS the per-patch X checks; one round
    # of it yields every patch's projection outcomes at once
    hx0 = prog._conj_checks[0]
    outs0 = []
    for c in range(hx0.shape[0]):
        outs0.append(measure_x_op(hx0[c]))
    # per-patch GF(2) fixup so every X check starts +1
    fix = surgery._solve_gf2(hx0.T, np.asarray(outs0, np.uint8))
    assert fix is not None
    if fix.any():
        t = tb.apply_z_many(t, np.nonzero(fix)[0])
    if prep_x_flips:
        t = tb.apply_x_many(t, list(prep_x_flips))

    # frame ops (x/z/h chains) by boundary, in program order; legacy
    # models without frame_ops meta fall back to x_ops
    fops_at: dict[int, list] = {}
    if frame_ops is not None:
        for kind, b, qubits in frame_ops:
            fops_at.setdefault(b, []).append((kind, qubits))
    else:
        for phx, chain in model.meta.get("x_ops", []):
            fops_at.setdefault(phx, []).append(("x", chain))

    def apply_frame_ops(ph):
        nonlocal t
        for kind, qubits in fops_at.get(ph, ()):
            qa = sorted(qubits)
            if kind == "x":
                t = tb.apply_x_many(t, qa)
            elif kind == "z":
                t = tb.apply_z_many(t, qa)
            elif kind == "h":
                t = tb.apply_h_many(t, qa)
            else:
                raise ValueError(f"unknown frame op {kind!r}")
    conj_at: dict[int, list] = {}
    for ci in prog._conj:
        conj_at.setdefault(ci.phase, []).extend(ci.qubits)
    enc_at: dict[int, list] = {}
    for ei in getattr(prog, "_enc_init", ()):
        enc_at.setdefault(ei.phase, []).extend(ei.qubits)
    reads_at: dict[int, list] = {}
    for ro in prog._readouts:
        reads_at.setdefault(ro.phase, []).extend(ro.qubits)

    active = np.stack(prog._active)
    starts = np.concatenate(
        [[0], np.cumsum([ph.rounds for ph in prog._phases])])
    n_ph = len(prog._phases)
    for ph in range(n_ph):
        if ph > 0:
            gone = np.nonzero(active[ph - 1] & (1 - active[ph]))[0]
            # mid-program measure-outs of rotated patches are not
            # modeled (gadgets require even H parity)
            assert not rot_phase[ph - 1][gone].any(), \
                "transition readout touches a rotated patch"
            scored = sorted(set(reads_at.get(ph, [])))
            if scored:
                outs = measure_in_z(scored)
                for qb, b in zip(scored, outs):
                    outcomes[n_meas + read_pos[(ph, int(qb))]] = b
            silent = [int(qb) for qb in gone if int(qb) not in set(scored)]
            if silent:
                outs = measure_in_x(silent)
                for qb, b in zip(silent, outs):
                    if read_pos_x is not None and (ph, qb) in read_pos_x:
                        outcomes_x[recipe_x["n_meas"]
                                   + read_pos_x[(ph, qb)]] = b
        # conjugate-basis initializations of this phase (fresh |+⟩)
        if ph in conj_at and ph not in skip_h_phases:
            t = tb.apply_h_many(t, sorted(conj_at[ph]))
        # encoded-arrival blocks: |+̄⟩ with every stabilizer projected
        # deterministic (skip_h_phases selects the |0̄⟩ stand-in)
        if ph in enc_at:
            prep_encoded_plus(ph, enc_at[ph],
                              with_h=ph not in skip_h_phases)
        # program-order frame ops (x/z chains, transversal h) landing
        # at this boundary
        apply_frame_ops(ph)
        if premeasure_x is not None and premeasure_x[0] == ph:
            pre.append(measure_x_op(premeasure_x[1]))
        rz = prog._phases[ph].checks.shape[0]
        for tt in range(prog._phases[ph].rounds):
            t_global = int(starts[ph]) + tt
            if measure_x_checks:
                outs_x = run_segment(ph, "x")
                for c in range(prog._conj_checks[ph].shape[0]):
                    outcomes_x[meas_pos_x[(ph, t_global, c)]] = outs_x[c]
            outs = run_segment(ph, "z")
            for c in range(rz):
                outcomes[meas_pos[(ph, t_global, c)]] = outs[c]
    apply_frame_ops(n_ph)   # frame ops trailing the last emitted phase
    fin_qubits = [int(qb) for qb in np.nonzero(active[-1])[0]]
    # final transversal readout basis PER QUBIT: H-then-Z-measure when
    # (rotated at the end) XOR (the evaluated recipe closes in X) — a
    # rotated patch's REAL Z word closes the X-sector recipe, while the
    # Z-sector recipe's (fictitious) closure for it needs the X basis,
    # exactly mirroring the unrotated convention.
    rot_end = rot_phase[n_ph_total]
    hq = [qb for qb in fin_qubits
          if bool(rot_end[qb]) != (final_basis == "x")]
    if hq:
        t = tb.apply_h_many(t, hq)
    word = measured(fin_qubits)
    for qb, b in zip(fin_qubits, word):
        outcomes[n_meas + n_read + qb] = b
        if outcomes_x is not None and final_basis == "x":
            outcomes_x[recipe_x["n_meas"] + recipe_x["n_read"] + qb] = b
    if x_model is not None:
        return outcomes, outcomes_x, pre
    return outcomes
