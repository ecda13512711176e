"""Circuit-level tier for declarative patch schedules: the compiled
logical programs (and any `patches.build_schedule` input) with REAL
extraction circuits instead of phenomenological per-round faults.

The phenomenological tier charges one scored-sector error per active
qubit per round plus measurement flips. This tier runs the actual
ancilla-based extraction circuits of BOTH stabilizer sectors every
round — conjugate-sector (X-check) fan-outs whose mid-fan-out ancilla
X errors HOOK into several data qubits, scored-sector (Z-check)
collection CNOTs, noisy measurement/reset, init errors at activation —
so every circuit fault location appears with its exact multi-detector
signature. Signatures exceed weight 2, so decoding is BP(+device OSD)
over a detector-fault Tanner graph, the same architecture as the
circuit-level qLDPC memories (`decode.bp_dem`) and the circuit-level
XX merge (`experiments.surgery_circuit`), here generalized to ANY
declarative schedule: time-varying check sets, patch activation /
deactivation, mid-program scored readouts, conjugate-basis inits,
moves, joint measurements.

Tier consistency is BY CONSTRUCTION, not by re-derivation: the
phenomenological builder's outcome-space recipe
(`build_schedule(with_recipe=True)`) exposes the detector and
observable assembly as linear maps D / obs_D over RAW outcomes
(scored-check outcomes, readout bits, final data word). Circuit faults
are linear in raw outcomes too, so the circuit fault Tanner graph is
one matmul, F = D @ O (O = per-fault raw-outcome deviations), and the
sampler's detectors ride the SAME D — both tiers share one detector
semantics (transition partners, init/closure rows, conjugate-init
drops, joint solves) with zero duplicated assembly logic.

Scored-sector conventions (Z-scored, matching `experiments.logical`):
X errors are the fault sector on UNROTATED wires; Z-check outcomes and
Z-basis readouts see them; Z errors there are the mirror-image sector
and are never booked (they cannot flip any scored outcome — boundary
H's convert residual type and check type in lockstep, so the rule
holds across mid-program rotations too). On ROTATED wires (round 5:
`rotated` — transversal-H patch rotations, and the entire X-CHECK
sector model via rotated = NOT rot) the roles swap exactly: scored
rows are physically X-type, Z components are the booked sector. The
noise channel decomposition uses EXCLUSIVE X-support classes
(ctrl-only / tgt-only / both at 4p/15 per CNOT) on x-relevant gates
and the mirror Z-support classes on z-relevant ones — the same
partition `decode.dem2._fault_species` uses, avoiding the X⊗X
double-booking bug calibration caught there. The unrotated X-ancilla
H sandwich carries no scored-relevant noise (every component is
either the identity on the fresh |+⟩ or a flip of the discarded
conjugate outcome — see `round_ops`), so `p_gate1` is not charged in
this tier; these circuits contain two-qubit gates, H sandwiches on
rotated scored ancillas (noiseless), measurements and resets only.
Per-check gate order puts the observables' support qubits first
(`hook_first`) so every ancilla-hook suffix is observable-free;
`meta["ambiguous_sigs"]` counts any remaining same-signature
different-observable variable pairs (0 for every compiled program —
asserted in tests).

What stays idealized (documented, matching the bespoke circuit tier
`surgery_circuit.py`): the FINAL transversal readout is perfect (the
phenomenological boundary-slot convention), conjugate-sector
measurement outcomes are discarded (their flips cannot enter any
scored detector), and `p_idle` is refused.

No reference analogue at any tier: the reference has one code block,
one extraction protocol and no multi-patch machinery (reference:

Port of `qcss_tpu.experiments.schedule_circuit`: the enumerator
(`round_ops`, `_walk`, `build_circuit_schedule`) is the JAX package's
numpy, copied. The sampler (`_sample_plan`) runs each phase's round
circuit through the port's frame engine in its matrix form
(`sim.frame.run_compiled_noisy`: one product for the gates of a round,
a second for their fault bits), drawing from one `torch.Generator` in
the order its docstring lists, on the generator's device; the
detectors are assembled there (`sample_circuit_schedule`) and decoded
there by `BPDecoder.decode_obs_device`. One divergence from the JAX
package, by design: a scored init on a wire the model marks as rotated
takes a Z flip at ``p_reset``, the component the enumerator books
('initz'), where the JAX sampler's `reset_qubits` puts an X flip, which
no scored outcome sees.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from qcss_tpu_torch._cuda import resolve_device
from qcss_tpu_torch.experiments import patches as P
from qcss_tpu_torch.experiments.surgery import _marker
from qcss_tpu_torch.ops.gf2_torch import mod2_matmul
from qcss_tpu_torch.sim import frame as fr
from qcss_tpu_torch.sim import noise as noise_mod



# -- per-phase round circuits -------------------------------------------------


def round_ops(hz: np.ndarray, hx: np.ndarray, n: int, rz_max: int,
              rot: np.ndarray | None = None,
              hook_first: np.ndarray | None = None):
    """One extraction round as op tuples + frame-engine gate arrays —
    ONE source of truth for gate order (enumerator and sampler agree on
    hook timing). Conjugate checks first, then scored checks; all
    scored ancillas measure/reset simultaneously at round end (handled
    outside these ops).

    `rot` is the model's per-qubit ROTATION row for this phase: a check
    whose support is rotated is PHYSICALLY the opposite type (the
    transversal-H patch rotation swaps X and Z stabilizers on constant
    supports — LogicalProgram.h), so it extracts in the opposite
    circuit shape: scored rows on rotated qubits as H-sandwich
    fan-outs (ancilla→data), conjugate rows on rotated qubits as plain
    collections (data→ancilla). The same generalization gives the
    X-CHECK sector's circuit model for free: pass rotated = NOT rot
    (an unrotated patch's X rows are physically X-type). Checks must
    not straddle a rotation boundary (asserted).

    Unrotated conjugate (X-type) fan-outs emit NO H sandwich — every
    component of both H noise locations is provably scored-gauge: on
    the opening H the ancilla is a fresh product |+⟩, so the X
    component is the IDENTITY (booking it over-counts a branch relabel
    of projection-random joints as a logical deviation — the
    circuit-level form of the conjugate-init fault exemption; it fired
    the undetectable-logical guard on the compiled T gadget's m1 as a
    detector-silent full-check frame) and Y/Z flip only the X-check
    outcome, which is DISCARDED; on the closing H every component
    flips at most that same discarded outcome. Likewise an X-ancilla
    |+⟩-reset error is gauge, so the sampler clears those wires
    noiselessly. ROTATED scored fan-outs DO emit their H sandwich as
    real (noiseless — p_gate1 is not charged in this tier) ops: their
    outcome is scored, so the walk must convert through the ancilla H
    exactly.

    The mid-fan-out hook channel (2q depolarizing) is untouched and
    complete — a ctrl Pauli after the j-th CNOT hooks into the
    remaining targets — EXCEPT on the FIRST 2q gate of each check
    circuit, where the post-gate state is stabilized at birth:
      * X-type fan-out first CNOT: CNOT|+⟩|ψ⟩ is the entangled pair,
        stabilized by X_anc·X_tgt AND Z_anc·Z_tgt — the 15 atoms
        reduce to three orbits {X_t, Z_t, Y_t} at 4p/15; the
        scored-relevant marginal is X on the target at 8p/15 for an
        x-relevant walk (flag 1) or Z on the target at 8p/15 for a
        z-relevant walk (flag 2);
      * Z-type collection first CNOT: the post-gate state is
        stabilized by Z_data·Z_anc — the z-support classes reduce
        (both ≡ identity, data ≡ ancilla) to Z on the ancilla at
        8p/15 (flag 2 again; the two walks differ by the evolved
        stabilizer = the check operator itself, which commutes with
        every scored-relevant future readout); the x-support classes
        are unreduced, but a Z-relevant circuit never books them.
    Booking the generic classes at flagged gates re-creates
    detector-silent gauge frames through the stabilizer components.

    `hook_first` (per-qubit 0/1) orders each check's data wires so the
    marked qubits come FIRST: an ancilla hook after the j-th gate lands
    only on the REMAINING wires, so putting the observables' support
    qubits first makes every hook suffix observable-free — the
    hook-benign extraction schedule (the surface-code literature's
    gate-ordering rule, applied per check). Without it, a rotated
    phase's last-round hooks are FIRST-ORDER ambiguous against
    boundary-slot data faults on weight-2 boundary checks (same single
    closure detector, different observable — found building
    circuit-level h; the differential guard verified both bookings,
    the ambiguity is physical and the ordering removes it).

    Returns (ops, gate arrays, flags [n_ops], sector [n_ops]) with
    flags 0 = generic, 1 = x-reduced first gate, 2 = z-reduced first
    gate; sector 0 = x-relevant walk, 1 = z-relevant walk."""
    from qcss_tpu_torch.circuits.ir import Circuit

    rz, rx = hz.shape[0], hx.shape[0]
    if rot is None:
        rot = np.zeros(n, np.uint8)
    ax0 = n + rz_max
    ops = []
    flags = []
    sector = []
    circ = Circuit()

    def ordered(sup):
        if hook_first is None:
            return sup
        # stable: marked qubits first, raster order within each group
        return np.concatenate([sup[hook_first[sup] > 0],
                               sup[hook_first[sup] == 0]])

    def rot_of(sup, what):
        r = bool(rot[sup].any())
        if r and not rot[sup].all():
            raise AssertionError(
                f"{what} straddles a rotation boundary")
        return r

    for c in range(rx):
        sup = ordered(np.nonzero(hx[c])[0])
        a = ax0 + c
        if not rot_of(sup, f"conjugate check {c}"):
            # physically X-type: fan-out (no H sandwich — see above)
            for i, j in enumerate(sup):
                ops.append(("cnot", a, int(j)))
                flags.append(1 if i == 0 else 0)
                sector.append(0)
                circ.cnot(a, int(j))
        else:
            # physically Z-type: collection; outcome discarded, hooks
            # ride the z components
            for i, j in enumerate(sup):
                ops.append(("cnot", int(j), a))
                flags.append(2 if i == 0 else 0)
                sector.append(1)
                circ.cnot(int(j), a)
    for c in range(rz):
        sup = ordered(np.nonzero(hz[c])[0])
        a = n + c
        if not rot_of(sup, f"scored check {c}"):
            # physically Z-type: collection
            for j in sup:
                ops.append(("cnot", int(j), a))
                flags.append(0)
                sector.append(0)
                circ.cnot(int(j), a)
        else:
            # physically X-type, outcome SCORED: real H sandwich
            ops.append(("h", a))
            flags.append(0)
            sector.append(1)
            circ.h(a)
            for i, j in enumerate(sup):
                ops.append(("cnot", a, int(j)))
                flags.append(2 if i == 0 else 0)
                sector.append(1)
                circ.cnot(a, int(j))
            ops.append(("h", a))
            flags.append(0)
            sector.append(1)
            circ.h(a)
    return (ops, circ.to_arrays(), np.asarray(flags, np.int32),
            np.asarray(sector, np.int32))


def _walk(ops, nq: int, start: int, x0: np.ndarray,
          z0: np.ndarray | None = None):
    """Propagate a Pauli injected AFTER op index `start` (-1 = round
    start) to the end of the round; H converts between the components.
    Returns the final (x, z) frame."""
    x = x0.copy()
    z = np.zeros(nq, np.uint8) if z0 is None else z0.copy()
    for op in ops[start + 1:]:
        if op[0] == "cnot":
            _, c, t = op
            x[t] ^= x[c]
            z[c] ^= z[t]
        else:
            q = op[1]
            x[q], z[q] = z[q], x[q]
    return x, z


# -- the assembled model ------------------------------------------------------


@dataclass(frozen=True)
class CircuitScheduleModel:
    """Circuit-level fault model of a declarative schedule."""

    n: int
    n_phases: int
    F: np.ndarray           # [n_dets, nv] merged fault Tanner graph
    priors: np.ndarray      # [nv]
    obs: np.ndarray         # [n_obs, nv]
    fault_sigs: list        # per raw component: (dets tuple, obs int, meta)
    plan: "_Plan"
    meta: dict = field(default_factory=dict)


@dataclass(frozen=True)
class _Plan:
    """Static sampling/enumeration plan shared by model and sampler."""

    n: int
    nq: int
    n_ph: int
    rz: tuple[int, ...]
    rz_max: int
    rx_max: int
    rounds: tuple[int, ...]
    starts: tuple[int, ...]
    ops: tuple            # per phase: op tuple list
    arrays: tuple         # per phase: (ops, q0, q1) numpy gate arrays
    flags: tuple          # per phase: reduced-first-gate marks [n_ops]
    #                       (0 generic, 1 x-reduced, 2 z-reduced)
    # transitions INTO phase ph (ph >= 1):
    ro_at: tuple          # per phase: tuple of (qubit, ridx, from_z)
    gone_at: tuple        # per phase: tuple of qubits cleared
    init_scored_at: tuple  # per phase (incl. 0): scored-basis inits
    init_conj_at: tuple    # per phase (incl. 0): conjugate inits
    n_meas: int
    n_read: int
    D: np.ndarray          # [n_dets, n_out] recipe detector map
    obs_D: np.ndarray      # [n_obs, n_out] recipe observable map
    # model rotation matrix [n_ph, n]: 1 where the scored rows are
    # physically X-type (see round_ops); all-zero for unrotated models
    rot: np.ndarray = None
    # physical transversal-H events: per phase, qubits conjugated at
    # the transition INTO that phase (the h frame ops)
    h_at: tuple = ()
    # final-word deviation source per data qubit: 1 = z frame (the
    # final closure is a physically X-type readout there)
    final_from_z: np.ndarray = None


def build_circuit_schedule(n: int, phases: list[P.Phase],
                           active: np.ndarray,
                           observables: list[list[tuple]],
                           conj_checks: list[np.ndarray],
                           readouts: tuple[P.Readout, ...] = (),
                           conjugate_init: tuple[P.Readout, ...] = (),
                           *, noise: noise_mod.NoiseModel,
                           drop_obs: tuple[int, ...] = (),
                           rotated: np.ndarray | None = None,
                           h_bounds: tuple = (),
                           hook_first: np.ndarray | None = None
                           ) -> CircuitScheduleModel:
    """Assemble the circuit-level fault Tanner graph of a declarative
    schedule. Inputs are `patches.build_schedule`'s, plus `conj_checks`:
    the conjugate sector's check matrices per phase (the real patches'
    X stabilizers — the hook-fault source a scored-sector-only circuit
    cannot model).

    `rotated` [n_ph, n] marks qubits whose SCORED rows are physically
    X-type during a phase (see `round_ops`): mid-program transversal-H
    rotations (LogicalProgram.h) in the Z-scored model, and — with
    rotated = active & NOT rot — the X-CHECK sector's circuit model,
    where an unrotated patch's scored (X) rows are physically X-type.
    Faults on rotated wires book their Z components (the scored-
    relevant sector there); residuals book by their BIRTH sector
    (scored-relevant at birth stays scored-relevant forever: the
    boundary H conversions swap residual type and check type in
    lockstep). `h_bounds` lists the PHYSICAL transversal-H events
    ((phase, qubits) — the h frame ops) so the sampler conjugates the
    frames at the right boundaries. A scored mid-program readout's
    physical basis follows `rotated` at the previous phase (X-type
    rows read in the X basis → deviations ride the z frame), and the
    final word's per-qubit deviation source follows `rotated`'s LAST
    row — TRAILING h frame ops (after the last emitted phase) need no
    representation at all: the physical chain [trailing H; readout in
    the end-state basis] reads exactly the pre-H conjugate component,
    which is the last phase's scored-relevant frame.

    `drop_obs` excludes observable rows from circuit-level scoring.
    Needed for PROJECTION-RANDOM standalone joints (the compiled T
    gadget's m1, `obs_expected is None`): their raw deviation is
    GAUGE-DEPENDENT — an X-frame that stabilizes a fresh |+̄⟩ patch at
    birth (e.g. a hook landing pre-collect in the projection round) is
    physically the identity yet relabels the m1 coin, so no
    outcome-space row can score that channel at circuit level in a
    single-sector model (the undetectable-logical guard rejects the
    attempt). Gauge-INVARIANT rows — final logicals, mzz combinations
    (both joints relabel consistently), cnot m1 composed with its
    readout terms — score fine. The m1 channel's circuit-level physics
    lives in the two-sector bespoke tier (`experiments.surgery_t`)."""
    if noise.p_idle:
        raise ValueError("circuit-level schedules charge no idle "
                         "locations (see NoiseModel.p_idle docs)")
    n_ph = len(phases)
    active = np.asarray(active, dtype=np.uint8)
    if rotated is None:
        rotated = np.zeros((n_ph, n), np.uint8)
    rotated = np.asarray(rotated, np.uint8) & active
    if len(conj_checks) != n_ph:
        raise ValueError("need one conjugate check matrix per phase")
    for ph in range(n_ph):
        if (conj_checks[ph] & (1 - active[ph])[None, :]).any():
            raise AssertionError(
                f"phase {ph} conjugate checks touch inactive qubits")

    base = P.build_schedule(n, phases, active, observables,
                            readouts=readouts,
                            conjugate_init=conjugate_init,
                            with_recipe=True)
    rec = base.meta["recipe"]
    D, obs_D = rec["D"], rec["obs"]
    if drop_obs:
        keep_obs = [i for i in range(obs_D.shape[0]) if i not in drop_obs]
        obs_D = obs_D[keep_obs]
    else:
        keep_obs = list(range(obs_D.shape[0]))
    if rec.get("has_anchored"):
        # anchored rows fall back to the final readout in outcome
        # space, which mis-places circuit faults after the anchor —
        # refuse only when such a row is actually KEPT (dropped rows
        # are excluded from scoring anyway)
        kept = set(keep_obs)
        if any(i_o in kept for i_o, *_ in rec.get("anchored", ())):
            raise ValueError(
                "circuit-level schedules cannot consume logical_at "
                "terms: the recipe's anchored rows fall back to the "
                "final readout, which mis-places circuit faults that "
                "occur after the anchor (drop those rows)")
    meas_order, read_order = rec["meas_order"], rec["read_order"]
    n_meas, n_read = rec["n_meas"], rec["n_read"]
    n_out = n_meas + n_read + n
    out_idx = {mtc: i for i, mtc in enumerate(meas_order)}
    read_idx = {pq: i for i, pq in enumerate(read_order)}

    rz = [Ph.checks.shape[0] for Ph in phases]
    rx = [h.shape[0] for h in conj_checks]
    rz_max, rx_max = max(rz), max(rx)
    nq = n + rz_max + rx_max
    starts = np.concatenate([[0], np.cumsum([Ph.rounds for Ph in phases])])

    conj_init_at: dict[int, set[int]] = {}
    for ci in conjugate_init:
        conj_init_at.setdefault(ci.phase, set()).update(ci.qubits)

    # per-qubit activity intervals — same derivation as build_schedule
    # (recomputed rather than refactored: the phenomenological builder
    # is bit-identity-pinned against the bespoke models, see CLAUDE.md)
    intervals: list[list[tuple]] = [[] for _ in range(n)]
    for qb in range(n):
        ph = 0
        while ph < n_ph:
            if not active[ph, qb]:
                ph += 1
                continue
            ph_a = ph
            while ph + 1 < n_ph and active[ph + 1, qb]:
                ph += 1
            ph_b = ph
            ridx = read_idx.get((ph_b + 1, qb))
            intervals[qb].append((ph_a, ph_b, ridx, ph_b == n_ph - 1))
            ph += 1

    def interval_of(qb: int, ph: int):
        for iv in intervals[qb]:
            if iv[0] <= ph <= iv[1]:
                return iv
        raise AssertionError(f"fault on inactive qubit {qb} at phase {ph}")

    # residual future map: X residual on data qubit qb at the END of
    # round (ph0, t0) -> raw-outcome deviation vector (later same-phase
    # rounds, later phases while active, readout bit, final word bit)
    fut_cache: dict[tuple[int, int, int], np.ndarray] = {}

    def future_vec(qb: int, ph0: int, t0: int) -> np.ndarray:
        key = (qb, ph0, t0)
        v = fut_cache.get(key)
        if v is not None:
            return v
        v = np.zeros(n_out, np.uint8)
        _, ph_b, ridx, fin = interval_of(qb, ph0)
        col = np.nonzero(phases[ph0].checks[:, qb])[0]
        for t in range(int(starts[ph0]) + t0 + 1, int(starts[ph0 + 1])):
            for c in col:
                v[out_idx[(ph0, t, int(c))]] ^= 1
        for ph in range(ph0 + 1, ph_b + 1):
            col = np.nonzero(phases[ph].checks[:, qb])[0]
            for t in range(int(starts[ph]), int(starts[ph + 1])):
                for c in col:
                    v[out_idx[(ph, t, int(c))]] ^= 1
        if ridx is not None:
            v[n_meas + ridx] ^= 1
        if fin:
            v[n_meas + n_read + qb] ^= 1
        fut_cache[key] = v
        return v

    # -- enumerate per-phase circuit components ------------------------------
    all_ops, all_arrays, all_flags, all_sector = [], [], [], []
    for ph in range(n_ph):
        ops, arrays, flags, sec = round_ops(
            phases[ph].checks, conj_checks[ph], n, rz_max,
            rot=rotated[ph], hook_first=hook_first)
        all_ops.append(tuple(ops))
        all_arrays.append(arrays)
        all_flags.append(flags)
        all_sector.append(sec)

    if noise.pauli2 is not None:
        raise ValueError("circuit-level schedules assume uniform 2q "
                         "depolarizing (the exclusive-class and "
                         "first-fan-out reductions are depolarizing "
                         "identities)")
    p2 = noise.p_gate2

    def phase_components(ph: int):
        """(own flips over scored checks, scored-relevant residual over
        data, prob, meta) per component of one round of phase ph.
        Components on x-relevant gates are the exclusive X-support
        classes; on z-relevant (rotated-check) gates the mirror
        Z-support classes — each walked with both frame components
        through the real ops (H conversions included), booking the
        scored-ancilla x flips and the per-qubit BIRTH-sector residual
        (x on unrotated wires, z on rotated — the other component can
        never reach a scored outcome: boundary H's swap residual type
        and check type in lockstep)."""
        ops = all_ops[ph]
        rotv = rotated[ph]
        out = []

        def add(start, xw, zw, prob, meta):
            x0 = np.zeros(nq, np.uint8)
            z0 = np.zeros(nq, np.uint8)
            x0[list(xw)] = 1
            z0[list(zw)] = 1
            x, z = _walk(ops, nq, start, x0, z0)
            resid = ((x[:n] & (1 - rotv)) | (z[:n] & rotv)).astype(
                np.uint8)
            out.append((np.nonzero(x[n: n + rz[ph]])[0],
                        resid, prob, meta))

        flags = all_flags[ph]
        sec = all_sector[ph]
        for k, op in enumerate(ops):
            if op[0] == "cnot" and p2:
                a, b = op[1], op[2]
                if flags[k] == 1:
                    # first fan-out CNOT: channel reduced modulo the
                    # birth stabilizers (see round_ops)
                    add(k, [b], [], 8 * p2 / 15, ("2qf", ph, k))
                    continue
                if flags[k] == 2:
                    add(k, [], [b], 8 * p2 / 15, ("2qzf", ph, k))
                    continue
                if sec[k] == 0:
                    # exclusive X-support classes of 2q depolarizing
                    add(k, [a], [], 4 * p2 / 15, ("2q", ph, k, "c"))
                    add(k, [b], [], 4 * p2 / 15, ("2q", ph, k, "t"))
                    add(k, [a, b], [], 4 * p2 / 15, ("2q", ph, k, "ct"))
                else:
                    # mirror: exclusive Z-support classes (the only
                    # scored-relevant components on rotated wires)
                    add(k, [], [a], 4 * p2 / 15, ("2qz", ph, k, "c"))
                    add(k, [], [b], 4 * p2 / 15, ("2qz", ph, k, "t"))
                    add(k, [], [a, b], 4 * p2 / 15,
                        ("2qz", ph, k, "ct"))
        if noise.p_meas:
            for c in range(rz[ph]):
                out.append((np.asarray([c]), np.zeros(n, np.uint8),
                            noise.p_meas, ("meas", ph, c)))
        return out

    comps = [phase_components(ph) for ph in range(n_ph)]

    # -- place components into raw-outcome space -----------------------------
    # chunked: the raw placement count scales as (phases x rounds x
    # circuit locations) — d=5 compiled programs reach ~10^5 columns,
    # so F_raw is computed per chunk and merged incrementally instead
    # of materializing the full [n_out, nf] incidence
    cols: list[np.ndarray] = []
    metas: list[tuple] = []
    probs: list[float] = []
    merged: dict[tuple, float] = {}
    fault_sigs: list[tuple] = []
    _CHUNK = 16384

    def flush():
        if not cols:
            return
        O = np.stack(cols, axis=1)
        # GF(2) matmuls in float32 (exact: row sums << 2^24)
        f_raw = (D.astype(np.float32)
                 @ O.astype(np.float32)).astype(np.int64) & 1
        o_raw = (obs_D.astype(np.float32)
                 @ O.astype(np.float32)).astype(np.int64) & 1
        for f in range(O.shape[1]):
            dets = tuple(np.nonzero(f_raw[:, f])[0])
            ob = 0
            for i in range(o_raw.shape[0]):
                ob |= int(o_raw[i, f]) << i
            fault_sigs.append((dets, ob, metas[f]))
            if not dets:
                if ob:
                    raise AssertionError(
                        f"undetectable logical circuit fault {metas[f]}")
                continue
            key = (dets, ob)
            old = merged.get(key, 0.0)
            merged[key] = old * (1 - probs[f]) + probs[f] * (1 - old)
        cols.clear()
        metas.clear()
        probs.clear()

    def place(vec, prob, meta):
        cols.append(vec)
        probs.append(prob)
        metas.append(meta)
        if len(cols) >= _CHUNK:
            flush()

    for ph in range(n_ph):
        t_lo, t_hi = int(starts[ph]), int(starts[ph + 1])
        for t in range(t_lo, t_hi):
            for flips, resid, prob, meta in comps[ph]:
                vec = np.zeros(n_out, np.uint8)
                for c in flips:
                    vec[out_idx[(ph, t, int(c))]] ^= 1
                for qb in np.nonzero(resid)[0]:
                    vec ^= future_vec(int(qb), ph, t - t_lo)
                place(vec, prob, meta + (t,))
            if noise.p_reset:
                # scored-ancilla reset X: flips whatever check the SAME
                # slot measures next round (possibly next phase); slots
                # past the next phase's check count are noiselessly
                # cleared before they are ever measured (see sampler)
                for c in range(rz[ph]):
                    if t + 1 < t_hi:
                        tgt = (ph, t + 1, c)
                    elif ph + 1 < n_ph and c < rz[ph + 1]:
                        tgt = (ph + 1, t + 1, c)
                    else:
                        continue
                    vec = np.zeros(n_out, np.uint8)
                    vec[out_idx[tgt]] ^= 1
                    place(vec, noise.p_reset, ("reset", ph, c, t))

    if noise.p_reset:
        # data init errors at scored-basis activation, walked through
        # the activation round: the scored-relevant component — X on
        # unrotated wires (|0⟩-prep bit flip), Z on model-rotated wires
        # (the mirror sector's init error on its physically-X-type
        # prep). Conjugate inits are exempt — the scored-relevant
        # component on a fresh conjugate eigenstate is the identity
        # (the projection coin is untossed; see patches.build_schedule).
        for ph in range(n_ph):
            prev = active[ph - 1] if ph else np.zeros(n, np.uint8)
            newly = np.nonzero(active[ph] & (1 - prev))[0]
            cset = conj_init_at.get(ph, set())
            rotv = rotated[ph]
            for qb in newly:
                if int(qb) in cset:
                    continue
                x0 = np.zeros(nq, np.uint8)
                z0 = np.zeros(nq, np.uint8)
                if rotv[int(qb)]:
                    z0[int(qb)] = 1
                    kind = "initz"
                else:
                    x0[int(qb)] = 1
                    kind = "init"
                x, z = _walk(all_ops[ph], nq, -1, x0, z0)
                resid = ((x[:n] & (1 - rotv)) | (z[:n] & rotv))
                vec = np.zeros(n_out, np.uint8)
                t0 = int(starts[ph])
                for c in np.nonzero(x[n: n + rz[ph]])[0]:
                    vec[out_idx[(ph, t0, int(c))]] ^= 1
                for q2 in np.nonzero(resid)[0]:
                    vec ^= future_vec(int(q2), ph, 0)
                place(vec, noise.p_reset, (kind, ph, int(qb)))

    if noise.p_meas:
        for (ph, qb), ridx in read_idx.items():
            vec = np.zeros(n_out, np.uint8)
            vec[n_meas + ridx] ^= 1
            place(vec, noise.p_meas, ("read", ph, qb))

    flush()
    if not merged:
        raise ValueError("noise model books no circuit fault locations "
                         "(all rates zero?) — nothing to decode")

    n_det = D.shape[0]
    nv = len(merged)
    F = np.zeros((n_det, nv), np.uint8)
    priors = np.empty(nv, np.float64)
    n_obs = obs_D.shape[0]
    obs = np.zeros((n_obs, nv), np.uint8)
    for v, ((dets, ob), prob) in enumerate(sorted(merged.items())):
        F[list(dets), v] = 1
        priors[v] = prob
        for i in range(n_obs):
            obs[i, v] = (ob >> i) & 1

    ro_at, gone_at, init_s_at, init_c_at = [], [], [], []
    for ph in range(n_ph):
        prev = active[ph - 1] if ph else np.zeros(n, np.uint8)
        prev_rot = rotated[ph - 1] if ph else np.zeros(n, np.uint8)
        # a scored readout's physical basis follows the previous
        # phase's rotation: X-type scored rows read in the X basis
        # (deviations ride the z frame)
        ro = tuple((int(qb), read_idx[(ph, int(qb))],
                    int(prev_rot[int(qb)]))
                   for qb in range(n) if (ph, qb) in read_idx)
        gone = tuple(int(qb)
                     for qb in np.nonzero(prev & (1 - active[ph]))[0])
        newly = np.nonzero(active[ph] & (1 - prev))[0]
        cset = conj_init_at.get(ph, set())
        init_s_at.append(tuple(int(qb) for qb in newly
                               if int(qb) not in cset))
        init_c_at.append(tuple(int(qb) for qb in newly
                               if int(qb) in cset))
        ro_at.append(ro)
        gone_at.append(gone)

    h_at = [()] * n_ph
    for ph_h, qubits in h_bounds:
        if not 0 <= ph_h < n_ph:
            raise ValueError("h boundary phase out of range")
        h_at[ph_h] = tuple(sorted(set(h_at[ph_h]) | set(int(q)
                                                        for q in qubits)))

    plan = _Plan(
        n=n, nq=nq, n_ph=n_ph, rz=tuple(rz), rz_max=rz_max, rx_max=rx_max,
        rounds=tuple(Ph.rounds for Ph in phases),
        starts=tuple(int(s) for s in starts),
        ops=tuple(all_ops), arrays=tuple(all_arrays),
        flags=tuple(all_flags),
        ro_at=tuple(ro_at), gone_at=tuple(gone_at),
        init_scored_at=tuple(init_s_at), init_conj_at=tuple(init_c_at),
        n_meas=n_meas, n_read=n_read, D=D, obs_D=obs_D,
        rot=rotated, h_at=tuple(h_at),
        final_from_z=rotated[-1].copy())
    meta = dict(base.meta)
    meta.pop("recipe", None)
    meta["n_fault_vars"] = nv
    meta["kept_obs"] = keep_obs
    # same-signature different-observable variable pairs are a hard
    # first-order ambiguity (no decoder can separate them); the
    # hook-benign gate ordering (`hook_first`) exists to keep this 0 —
    # recorded so tests/consumers can assert it
    sig_groups: dict[tuple, set] = {}
    for (dets, ob) in merged:
        sig_groups.setdefault(dets, set()).add(ob)
    meta["ambiguous_sigs"] = sum(
        1 for v in sig_groups.values() if len(v) > 1)
    return CircuitScheduleModel(
        n=n, n_phases=n_ph, F=F, priors=priors, obs=obs,
        fault_sigs=fault_sigs, plan=plan, meta=meta)




# -- the frame sampler --------------------------------------------------------

_QUIET = noise_mod.NoiseModel()


@dataclass(frozen=True)
class _PhaseTensors:
    """One phase's sampler inputs on a device: its round circuit in the
    frame engine's matrix form, the gate index, `round_ops` flag and
    fault threshold of each of its 2q gates, and its ancilla slots."""

    comp: fr.CompiledFrameCircuit
    gate2: torch.Tensor    # [G2] int64 gate positions of the CNOTs
    flag: torch.Tensor     # [G2] int64: 0 generic, 1 x-reduced, 2 z-reduced
    thresh: torch.Tensor   # [G2] float32: p_gate2, or 8 p_gate2 / 15 flagged
    anc_z: torch.Tensor    # scored ancilla slots of the phase
    anc_rest: torch.Tensor  # every other ancilla slot (cleared each round)


def _phase_tensors(plan: _Plan, noise: noise_mod.NoiseModel,
                   device) -> list[_PhaseTensors]:
    """`_PhaseTensors` of every phase of ``plan`` on ``device``."""
    out = []
    p2 = float(noise.p_gate2)
    for ph in range(plan.n_ph):
        ops_a, q0_a, q1_a = plan.arrays[ph]
        comp = fr.compile_circuit(ops_a, q0_a, q1_a, plan.nq).to(device)
        g2 = np.nonzero(np.asarray(ops_a) == fr._TWO_Q_START)[0]
        flag = np.asarray(plan.flags[ph], np.int64)[g2]
        thresh = np.where(flag == 0, p2, 8 * p2 / 15).astype(np.float32)
        out.append(_PhaseTensors(
            comp=comp,
            gate2=torch.as_tensor(g2, dtype=torch.int64, device=device),
            flag=torch.as_tensor(flag, device=device),
            thresh=torch.as_tensor(thresh, device=device),
            anc_z=torch.arange(plan.n, plan.n + plan.rz[ph], device=device),
            anc_rest=torch.arange(plan.n + plan.rz[ph], plan.nq,
                                  device=device)))
    return out


def _round_fault_bits(generator, batch: int, pt: _PhaseTensors):
    """[B, 4G] fault bits (x_a, z_a, x_b, z_b per gate, the frame engine's
    layout) of one round's gates: 2q depolarizing on every CNOT — a hit
    at p_gate2 and a pattern in [1, 16) whose bits 0..3 are the four
    components, as `noise.sampled_fault_bits` draws them — except on a
    check circuit's first CNOT (`round_ops` flag 1 or 2), whose
    stabilizer-reduced channel is X (flag 1) or Z (flag 2) on the target
    at 8 p_gate2 / 15. H ops carry no noise. Draws one [B, G2] uniform,
    then one [B, G2] pattern."""
    device = pt.gate2.device
    g2 = pt.gate2.shape[0]
    bits = torch.zeros((batch, 4 * pt.comp.num_gates), dtype=torch.uint8,
                       device=device)
    u = torch.rand((batch, g2), generator=generator, device=device)
    pat = torch.randint(1, 16, (batch, g2), generator=generator,
                        device=device)
    hit = u < pt.thresh[None, :]
    generic = (hit & (pt.flag == 0)[None, :]).to(torch.uint8)
    base = 4 * pt.gate2
    for bit in range(4):
        bits[:, base + bit] = ((pat >> bit) & 1).to(torch.uint8) * generic
    bits[:, base + 2] |= (hit & (pt.flag == 1)[None, :]).to(torch.uint8)
    bits[:, base + 3] |= (hit & (pt.flag == 2)[None, :]).to(torch.uint8)
    return bits


def _sample_plan(generator, batch: int, plan: _Plan,
                 noise: noise_mod.NoiseModel, *,
                 faults: dict | None = None) -> torch.Tensor:
    """Frame-sample `batch` runs of the schedule's circuits on the
    generator's device; returns the raw outcome deviations [B, n_out]
    uint8 in recipe order (every round's scored checks, phase by phase,
    then the readout bits, then the final word).

    Draws from ``generator``, in order, phase by phase: the transition's
    readout flips ([B, n_read of the phase] uniforms, if p_meas), its
    scored inits' flips ([B, n_init] uniforms, if p_reset); then for
    each round the gates' fault bits (`_round_fault_bits`, if p_gate2),
    the scored ancillas' measurement flips and their reset flips
    ([B, rz] uniforms each, if p_meas / p_reset).

    A transition reads the scored readouts (X-type rows from the z
    frame), clears the vacated and the newly initialized wires, conjugates
    the h-rotated wires' frames and then strikes each scored init in its
    scored-relevant component: X on a wire the model leaves unrotated in
    the new phase, Z on a rotated one (the enumerator's 'init' / 'initz').
    The JAX sampler strikes X on both (`frame.reset_qubits`), so its
    rotated inits are silent; this is the port's one divergence from it.

    ``faults`` replaces every draw by given bits (zero where a key is
    absent; t is the global round index, the enumerator's): ``("gates",
    ph, t)`` [B, 4G] gate fault bits (used where p_gate2 > 0, the only
    case the enumerator books gate faults), ``("meas", ph, t)`` and ``("reset",
    ph, t)`` [B, rz] outcome flips and ancilla reset X flips, ``("read",
    ph)`` [B, n_read] readout flips and ``("init", ph)`` [B, n_init]
    init flips, in the plan's order (`ro_at`, `init_scored_at`)."""
    device = generator.device
    tensors = _phase_tensors(plan, noise, device)
    n = plan.n

    def given(key, width):
        bits = faults.get(key)
        if bits is None:
            return torch.zeros((batch, width), dtype=torch.uint8,
                               device=device)
        return torch.as_tensor(np.asarray(bits), dtype=torch.uint8,
                               device=device)

    def flips(width, p, key):
        if faults is not None:
            return given(key, width)
        if not p:
            return None
        return (torch.rand((batch, width), generator=generator,
                           device=device) < p).to(torch.uint8)

    f = fr.zero_frames(batch, plan.nq, device=device)
    outs_all = []
    read_bits: list = [None] * plan.n_read
    for ph in range(plan.n_ph):
        pt = tensors[ph]
        if ph > 0 and plan.ro_at[ph]:
            # per-read basis: X-type scored rows read in the X basis —
            # their outcome deviations ride the z frame
            q_ro = torch.as_tensor([qb for qb, _, _ in plan.ro_at[ph]],
                                   device=device)
            from_z = torch.as_tensor(
                [fz for _, _, fz in plan.ro_at[ph]], device=device) > 0
            outs = torch.where(from_z[None, :], f.z[:, q_ro], f.x[:, q_ro])
            fl = flips(len(plan.ro_at[ph]), noise.p_meas, ("read", ph))
            if fl is not None:
                outs = outs ^ fl
            for i, (_, ridx, _) in enumerate(plan.ro_at[ph]):
                read_bits[ridx] = outs[:, i]
        if ph > 0 and plan.gone_at[ph]:
            f = fr.reset_qubits(f, plan.gone_at[ph])
        init = plan.init_scored_at[ph]
        init_fl = None
        if init:
            f = fr.reset_qubits(f, init)
            init_fl = flips(len(init), noise.p_reset, ("init", ph))
        if plan.init_conj_at[ph]:
            f = fr.reset_qubits(f, plan.init_conj_at[ph])
        if plan.h_at[ph]:
            # physical transversal-H rotation: conjugate the frames
            hq = torch.as_tensor(plan.h_at[ph], device=device)
            x, z = f.x.clone(), f.z.clone()
            x[:, hq], z[:, hq] = f.z[:, hq], f.x[:, hq]
            f = fr.Frames(x, z)
        if init_fl is not None:
            rot = torch.as_tensor(plan.rot[ph][list(init)], device=device)
            f = fr.inject_flips(f, init, init_fl * (1 - rot)[None, :],
                                init_fl * rot[None, :])

        for t in range(plan.starts[ph], plan.starts[ph + 1]):
            if not noise.p_gate2:
                f = fr.run_compiled_noisy(f, pt.comp, _QUIET)
            else:
                if faults is not None:
                    bits = given(("gates", ph, t), 4 * pt.comp.num_gates)
                else:
                    bits = _round_fault_bits(generator, batch, pt)
                f = fr.run_compiled_noisy(f, pt.comp, noise,
                                          fault_bits=bits)
            meas_fl = flips(plan.rz[ph], noise.p_meas, ("meas", ph, t))
            reset_fl = flips(plan.rz[ph], noise.p_reset, ("reset", ph, t))
            f, outs = fr.measure_deviations(f, pt.anc_z)
            if meas_fl is not None:
                outs = outs ^ meas_fl
            f = fr.reset_qubits(f, pt.anc_z)
            if reset_fl is not None:
                f = fr.inject_flips(f, pt.anc_z, reset_fl,
                                    torch.zeros_like(reset_fl))
            # conjugate + unused scored slots clear noiselessly: a reset
            # X on a conjugate ancilla provably cannot touch any scored
            # outcome, and unused slots must not carry stale frames
            f = fr.reset_qubits(f, pt.anc_rest)
            outs_all.append(outs)

    # final word: qubits whose scored rows end physically X-type read
    # in the X basis — deviations ride the z frame
    fz = torch.as_tensor(plan.final_from_z, device=device) > 0
    final = torch.where(fz[None, :], f.z[:, :n], f.x[:, :n])
    parts = outs_all
    if plan.n_read:
        parts.append(torch.stack(read_bits, dim=1))
    parts.append(final)
    return torch.cat(parts, dim=1)


def sample_circuit_schedule(model: CircuitScheduleModel,
                            noise: noise_mod.NoiseModel, *,
                            batch: int, seed: int = 0, device="cuda",
                            faults: dict | None = None):
    """Sample the schedule's circuits on ``device`` (the card unless the
    caller asks for the CPU) from a generator seeded with ``seed``
    (`_sample_plan`; ``faults`` as there) and assemble the detectors and
    observable deviations there through the recipe's maps, as exact
    float32 products (`gf2_torch.mod2_matmul`). Returns (detectors
    [B, n_dets], observable deviations [B, n_obs]), uint8 tensors on
    ``device``."""
    device = resolve_device(device)
    plan = model.plan
    gen = torch.Generator(device=device).manual_seed(seed)
    raw = _sample_plan(gen, batch, plan, noise, faults=faults)
    d_t = torch.as_tensor(plan.D.T, dtype=torch.float32, device=device)
    o_t = torch.as_tensor(plan.obs_D.T, dtype=torch.float32, device=device)
    return mod2_matmul(raw, d_t), mod2_matmul(raw, o_t)


def _decoded(model, noise, batch, seed, iters, alpha, osd, device,
             profile):
    """Sample and decode on ``device``: (decoded deviations [B, n_obs]
    uint8 on the host, BP convergence [B])."""
    from qcss_tpu_torch.decode.bp import BPDecoder

    device = resolve_device(device)
    mark = _marker(device, profile)
    dec = BPDecoder(model.F, np.clip(model.priors, 1e-12, 0.499),
                    logicals=model.obs, iters=iters, alpha=alpha, osd=osd,
                    device=device)
    mark("build")
    dets, obs_dev = sample_circuit_schedule(model, noise, batch=batch,
                                            seed=seed, device=device)
    mark("sample")
    flips, conv = dec.decode_obs_device(dets)
    vals = obs_dev ^ flips
    mark("decode")
    vals = vals.cpu().numpy()
    mark("readback")
    return vals, np.asarray(conv)


def circuit_decoded_obs(model: CircuitScheduleModel,
                        noise: noise_mod.NoiseModel, *,
                        batch: int = 1 << 12, seed: int = 0,
                        iters: int = 48, alpha: float = 0.8,
                        osd: bool = True, device="cuda",
                        profile: dict | None = None) -> np.ndarray:
    """Sample + decode; return the per-shot DECODED observable
    deviations [B, n_obs] uint8 (sampled deviation XOR decoder flip) —
    the circuit-tier mirror of `patches.schedule_decoded_obs`, feeding
    higher-level consumers (the two-level concatenated memory).

    Sampled and decoded (BP, then the OSD tail on the device:
    `BPDecoder.decode_obs_device`) on ``device``; the result is read back
    once. ``profile`` receives the seconds of 'build', 'sample',
    'decode' and 'readback'."""
    return _decoded(model, noise, batch, seed, iters, alpha, osd, device,
                    profile)[0]


def circuit_schedule_memory(model: CircuitScheduleModel,
                            noise: noise_mod.NoiseModel, *,
                            batch: int = 1 << 12, seed: int = 0,
                            iters: int = 48, alpha: float = 0.8,
                            osd: bool = True, device="cuda",
                            profile: dict | None = None) -> dict:
    """Run the circuit-level schedule end to end: frame-sampled
    extraction circuits, recipe detector assembly, BP(+OSD) decode on
    the circuit fault Tanner graph; per-observable failure rates.
    ``device`` and ``profile`` as in `circuit_decoded_obs`."""
    vals, conv = _decoded(model, noise, batch, seed, iters, alpha, osd,
                          device, profile)
    fail = vals == 1
    out = {
        "word_fail": float(fail.any(axis=1).mean()),
        "bp_converged": float(conv.mean()),
        "samples": batch,
        "detectors": int(model.F.shape[0]),
        "fault_vars": int(model.F.shape[1]),
    }
    for i in range(model.obs.shape[0]):
        out[f"obs{i}_fail"] = float(fail[:, i].mean())
    return out
