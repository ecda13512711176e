"""Logical programs on a surface-code patch grid — CNOTs between ANY
pair of logical qubits (ancilla routing via patch moves) and T gadgets,
compiled to one declarative schedule (`experiments.patches`) and decoded
end to end.

The compiler targets Z-BASIS programs: data qubits prepared in the Z
basis, Clifford+T circuit, transversal Z readout. That scoping is what
makes the single-sector fault model COMPLETE: every seam and every
grown region initializes in the scored (Z) basis except move growth
(declared `conjugate_init`), every mid-program patch measurement is
either scored (Z: readout bits with closure detectors) or silent
(X: provably information-free for the Z sector), and the X-sector
corrections that a general program would track (Z̄^{m2}-type frames)
never touch a Z readout. The X sector is the mirror image, exactly as
`surgery.build_surgery_cnot` documents for its bespoke model.

Layout: data patch i at slot (0, 2i) of a 2 x (2k-1) slot grid (odd
columns vacant), routing row 1 below. Slot (I, J) occupies the d x d
qubit block at rows I*(d+1).., cols J*(d+1)..; the (d+1)-th row/col
between adjacent slots is the seam. One op runs at a time (the routing
row is a bus), each phase `rounds` extraction rounds.

Op algebra (Z̄ trackers; every rule tableau-gold-tested in
tests/test_logical.py):

  * `cnot(c, t)` (Horsman et al. 2012, re-derived on this machinery):
    ancilla A = |+̄⟩ at (1, 2c); m1 = ZZ(C, A) via the seam-even joint
    combination; A routes along row 1 (horizontal moves: vacated block
    measured in Z — frame = readout parity of the Z̄-row qubits) and up
    (vertical move: growth region |+⟩-init/conjugate-declared, vacated
    block measured in X/silent — frame = the seam-even Z̄-transfer
    combination); XX(A, T) with a |0⟩ seam (Z-sector fully protected;
    m2 unextractable and unneeded for Z outputs); A measured out in Z
    at the split (M_A from readout bits, closure detectors keep its
    last EC round protected). Tracker: frame(T) ⊕= m1 ⊕ frame(A) ⊕
    M_A ⊕ z_seam, where z_seam is the split readout of the seam qubit
    on the Z̄ row — Z̄_A·Z̄_T rides the merged row THROUGH that qubit
    (the same subtlety `build_surgery_cnot` documents).
  * `t(q)`: magic patch M below D_q, m1 = ZZ(D_q, M), M measured out
    in X (silent). m1 selects S̄ vs S̄† — a non-Pauli channel invisible
    to Z readouts, so it is scored as its own observable row (`t{q}_m1`
    failing = wrong S correction = logical error). The magic-state
    physics itself (injection ε, distillation, the X-sector OUT
    channel) is `experiments.surgery_t` / `ftqc.magic`'s domain; here
    M is a stabilizer stand-in with the identical fault model.
  * `mzz(a, b)`: NON-destructive joint measurement Z̄_a·Z̄_b between any
    data pair — the logical-level syndrome extraction primitive
    (`patches.parity_chain_model` is its hand-rolled special case). A
    |+̄⟩ ancilla below `a` takes m1 = ZZ(A, D_a), routes along row 1 to
    below `b`, takes m2 = ZZ(A, D_b), and is measured out in X
    (silent). m1 ⊕ m2 ⊕ frame(A) = Z̄_a·Z̄_b exactly because Z̄_A is
    projection-random but CONSISTENT between the two joints (the move
    frames transport its representative); the combination is scored as
    its own observable row `mzz{a}{b}`.
  * `x(q)`: logical X̄ — a deterministic Pauli frame op. It emits no
    phases and no fault locations (a noiseless software frame commutes
    with every Z check, so detectors are untouched); it flips the
    classical Z-basis bit the program is tracking, so expected
    outcomes (`meta["obs_expected"]`) and the tableau golds see it at
    the right program position (`meta["x_ops"]`: physical X̄ chains
    applied at phase boundaries — mid-program ordering matters:
    x(c) BEFORE cnot(c, t) flips both outputs, AFTER flips only z_c).
  * `z(q)` / `y(q)`: the dual/combined Pauli frame ops (round 4) —
    bit-tracking plus recorded physical chains for the golds.
  * `h(q)` (round 4): logical H as a TRANSVERSAL physical H = the
    90-degree patch rotation. Needs NO new fault-model machinery: the
    scored history's supports are constant per patch (H exchanges each
    check with its rotated partner ON THE SAME SUPPORT), so `h` only
    toggles which sector scores the final readout and how the protocol
    runner interprets each row physically — see the method docstring.
  * `s(q)` (round 4): standalone logical S by S-state injection on the
    T-gadget machinery (same schedule/fault surface; the wrong-m1
    branch is the PAULI Z̄, not S̄† — Clifford gadget).
  * `mx(q)` (round 4): non-destructive X̄ measurement via a horizontal
    XX merge with a |+̄⟩ ancilla (|+⟩ seam); scored in the X-sector
    schedule. Collapses the tracked state to a SYMBOLIC X bit.
  * `x_if(q, name)` (round 4): classical feedback — the conditional
    X̄^m compiled as observable algebra (frames are software; no
    physical op). The reference's measure-and-correct program
    (test/test_ftqc.py:104-113) is exactly mx + h + x_if via
    MZ∘H = H∘MX.
  * `measure()` finalizes: obs row per data qubit = final transversal
    Z̄ readout ⊕ its accumulated frame terms; odd-H-parity patches
    score in the `build_x` schedule (rotated Z̄' = interior column).
    Channels whose logical history lost its anchor (e.g. Z̄ after an
    un-h'd mx — re-projected gauge) are DROPPED and listed in
    `meta["unscored"]`; declaring them trips the same-signature guard.

Deterministic semantics: Pauli-eigenstate inputs under the op set stay
a tracked (basis, bit, symbolic-measurement-set) machine, so the
compiler tracks the expected value of every scored observable
(`meta["obs_expected"]`; None for projection-random or symbolic
channels — the declared-|+̄⟩ T-gadget m1, a post-h readout). Decode
failure rates are frame-relative and do not depend on the expected
table; golds and users interpreting raw outcomes do.

With h/s/mx/x_if the compiler now runs every deterministic test
program of the reference (X/Y/Z/XXX/YZ/HZH and the measure-and-correct
feedback program, test/test_ftqc.py:22-113) at the surgery tier, each
tableau-gold-tested. Gadget/merge ops require even H parity (rotated-
patch merges are not modeled); `h` requires an empty frame. Since
round 5 the CIRCUIT tier models `h` too (rotated patches extract
through the opposite circuit shapes; `build_circuit_x` is the mirror
circuit model that scores the feedback program's z0 — see
`schedule_circuit.round_ops`).

The reference has no multi-patch machinery, no logical two-qubit gate,
and no non-Clifford path at all (reference: ftqc.py:42-120,
css_code.py:433-434).

Port of `qcss_tpu.experiments.logical`: the compiler is the JAX
package's numpy, copied. The three runners (`run`, `run_full`,
`run_circuit`) take ``device`` (the card unless the caller asks for the
CPU) and ``profile`` (a dict of stage seconds) and pass them to the
port's memories: `patches.schedule_memory(_device)` /
`schedule_decoded_obs` and `schedule_circuit.circuit_schedule_memory`.
"""

from __future__ import annotations

import numpy as np

from qcss_tpu_torch._cuda import resolve_device
from qcss_tpu_torch.codes import families
from qcss_tpu_torch.experiments import patches as P
from qcss_tpu_torch.experiments.surgery import _marker


def _term_key(term):
    kind = term[0]
    if kind == "logical":
        return (kind, term[1].tobytes())
    if kind == "joint":
        return (kind, term[1], term[2].tobytes(), term[3], term[4],
                term[5])
    if kind == "readout":
        return (kind, term[1], term[2])
    if kind == "readout_logical":
        return (kind, term[1], term[2].tobytes())
    if kind == "logical_at":
        return (kind, term[1], term[2].tobytes())
    raise ValueError(kind)


def _xor_terms(a: list, b: list) -> list:
    """Symmetric difference of term lists (XOR algebra: pairs cancel)."""
    out = list(a)
    keys = [_term_key(t) for t in out]
    for t in b:
        k = _term_key(t)
        if k in keys:
            i = keys.index(k)
            out.pop(i)
            keys.pop(i)
        else:
            out.append(t)
            keys.append(k)
    return out


class LogicalProgram:
    """A Z-basis logical program over `n_data` surface patches."""

    def __init__(self, d: int, n_data: int, rounds: int | None = None,
                 data_init: str = "encoded"):
        """data_init: 'encoded' (default) models the data patches as
        VERIFIED encoded |0̄⟩ arrivals — the reference's own
        fault-tolerant RUS preparation (encode_zero, reference:
        css_code.py:314-342; `ftqc.schedule._encode_ft` is this
        framework's batched form) — so BOTH sectors' first extraction
        rounds are deterministic (raw detectors close the birth time
        boundary; the tableau gold runner has always prepared exactly
        this state: X checks projected with Z fixups). 'product' models
        bare |0⟩^⊗n init: the X-check sector's first round is then
        projection-random, an OPEN time boundary that pins every
        X̄-sensitive channel (the t/s gadgets' OUT, standalone mx) at
        fault distance 3 regardless of d — measured as a constant
        ~3e-4 word-fail floor at p=2e-3 (round-4's flattening; see
        decode.fault_distance). The Z-sector model is IDENTICAL either
        way (|0⟩^⊗n already has deterministic Z checks)."""
        if n_data < 1:
            raise ValueError("need >= 1 data qubit")
        self.d = d
        self.R = d if rounds is None else rounds
        if self.R < 3:
            raise ValueError("phases need >= 3 rounds (merged-phase flip "
                             "ambiguity; see surgery.build_xx_merge_split)")
        # merged-phase read round for every compiled joint combination:
        # 'mid' anchors deep in the decoded window (see patches.joint —
        # 'first' pins the m channels' fault distance at 3; the round-4
        # d=5->7 flattening), 'first' recovers the round-4 models.
        self.joint_mref = "mid"
        self.slot_cols = max(2 * n_data - 1, 2)
        self.n_data = n_data
        self.rows_q = 2 * (d + 1) - 1
        self.cols_q = self.slot_cols * (d + 1) - 1
        self.n = self.rows_q * self.cols_q
        hx, hz = families.surface_rect_checks(d, d)
        self._hx_p, self._hz_p = hx, hz
        self._hx_v, self._hz_v = families.surface_rect_checks(2 * d + 1, d)
        self._hx_h, self._hz_h = families.surface_rect_checks(d, 2 * d + 1)

        self._phases: list[P.Phase] = []
        self._conj_checks: list[np.ndarray] = []
        self._active: list[np.ndarray] = []
        self._readouts: list[P.Readout] = []
        self._conj: list[P.Readout] = []
        self._enc_init: list[P.Readout] = []   # encoded-arrival patches
        self._occ: dict[tuple[int, int], str] = {}
        self._slot_of: dict[str, tuple[int, int]] = {}
        self._frames: dict[str, list] = {}
        self._aux_obs: list[tuple[str, list]] = []
        self._aux_expected: list[int | None] = []
        # channels that score at the CIRCUIT tier despite a None
        # expected value (coin channels whose reference structure is
        # gauge-free: the s/t gadget m1 and OUT once both patches are
        # encoded arrivals — see build_circuit)
        self._circ_scoreable: set[str] = set()
        # gadget OUT channels awaiting their boundary-form decision
        # (finalized in measure(); see _magic_gadget)
        self._pending_out: list[tuple] = []
        self._anc_count = 0
        self._built = None
        self._bits = [0] * n_data
        # tracked single-qubit Pauli-eigenstate machine: basis 'z'/'x'/'y'
        # with a classical bit, plus symbolic measurement references
        # (set of aux-obs names whose XOR the bit depends on) — see
        # `_expected`. H parity per patch decides which SECTOR scores
        # the final readout (see `h`).
        self._basis = ["z"] * n_data
        self._bsyms: list[set] = [set() for _ in range(n_data)]
        self._hpar = [0] * n_data
        # which sector a data patch's accumulated frame terms live in
        # ('z' | 'x'); must match the sector its final readout scores in
        self._frame_sec: dict[str, str] = {}
        # per-patch channel anchoring: a final readout is SCOREABLE only
        # while the model holds a reference for it — a joint measurement
        # that randomizes the conjugate logical without recording a
        # recoverable anchor makes that side pure gauge (the build-time
        # same-signature guard fires if it is declared anyway; mx
        # surfaced this). |0>-init anchors BOTH: Z̄ by value, X̄ by the
        # phase-0 conjugate projection. h swaps the two flags.
        self._z_ok = [True] * n_data
        self._x_ok = [True] * n_data
        self._xops: list[tuple[int, tuple[int, ...]]] = []
        self._frame_ops: list[tuple] = []
        self._op_log: list[tuple] = []
        # X-CHECK-sector bookkeeping (Z-error faults; see build_x):
        # X-basis measure-outs are SCORED readouts there, Z-basis inits
        # are conjugate inits there, and each t() books its OUT channel
        self._x_reads: list[P.Readout] = []
        self._x_conj: list[P.Readout] = []
        self._x_obs: list[tuple[str, list]] = []
        self._x_expected: list[int | None] = []

        for i in range(n_data):
            pid = f"d{i}"
            self._occ[(0, 2 * i)] = pid
            self._slot_of[pid] = (0, 2 * i)
            self._frames[pid] = []
        self._push_sep()
        if data_init == "product":
            # |0⟩^⊗n product init: the X sector's first round is
            # projection randomness (open time boundary)
            data_qubits = []
            for i in range(n_data):
                data_qubits += self._block_qubits((0, 2 * i))
            self._x_conj.append(P.Readout(0, tuple(data_qubits)))
        elif data_init != "encoded":
            raise ValueError("data_init must be 'encoded' or 'product'")

    # -- geometry ------------------------------------------------------------

    def _origin(self, slot):
        I, J = slot
        return I * (self.d + 1), J * (self.d + 1)

    def _embed(self, h, r0, c0, sr, sc):
        big = np.zeros((h.shape[0], self.n), np.uint8)
        sm = h.reshape(-1, sr, sc)
        for r in range(sr):
            base = (r + r0) * self.cols_q + c0
            big[:, base: base + sc] = sm[:, r, :]
        return big

    def _block_mask(self, slot):
        r0, c0 = self._origin(slot)
        m = np.zeros(self.n, np.uint8)
        for r in range(self.d):
            m[(r + r0) * self.cols_q + c0:
              (r + r0) * self.cols_q + c0 + self.d] = 1
        return m

    def _block_qubits(self, slot):
        return [int(qb) for qb in np.nonzero(self._block_mask(slot))[0]]

    def _zrep(self, slot):
        """Z̄ representative: an INTERIOR row of the block (row 1).

        Interior rows have Z-check coverage 2 everywhere; a boundary-row
        rep makes the fresh-ancilla T gadget unbuildable — a mid-prep
        data error on a coverage-1 rep qubit and a first-round
        measurement flip of its only check share one detector but differ
        on m1 (target[q]=1 forces the disagreement for EVERY solution
        representative), which the signature-consistency guard rejects."""
        r0, c0 = self._origin(slot)
        v = np.zeros(self.n, np.uint8)
        base = (r0 + 1) * self.cols_q + c0
        v[base: base + self.d] = 1
        return v

    def _zrep_row(self, slot) -> int:
        return self._origin(slot)[0] + 1

    def _xrep(self, slot, col: int = 1):
        """X̄ representative: an INTERIOR column of the block (column 1
        — the mirror of `_zrep`'s interior-row rule). The bespoke
        `surgery_t.build_merge_readout_sector` uses column 0, but it
        models an ongoing memory whose first X-check round is already
        deterministic; the compiled program models the real |0...0⟩
        init, whose phase-0 X rounds are projection-random — there a
        boundary-column rep's coverage-1 corner collides with a
        first-round measurement flip (same single detector, different
        OUT) and the signature-consistency guard rejects it."""
        r0, c0 = self._origin(slot)
        v = np.zeros(self.n, np.uint8)
        for r in range(self.d):
            v[(r0 + r) * self.cols_q + c0 + col] = 1
        return v

    def _seam_qubits(self, a, b):
        (Ia, Ja), (Ib, Jb) = a, b
        if Ja == Jb and abs(Ia - Ib) == 1:        # vertical pair
            I = min(Ia, Ib)
            r = I * (self.d + 1) + self.d
            c0 = Ja * (self.d + 1)
            return [r * self.cols_q + c0 + c for c in range(self.d)], "v"
        if Ia == Ib and abs(Ja - Jb) == 1:        # horizontal pair
            J = min(Ja, Jb)
            c = J * (self.d + 1) + self.d
            r0 = Ia * (self.d + 1)
            return [(r0 + r) * self.cols_q + c for r in range(self.d)], "h"
        raise ValueError(f"slots {a}, {b} are not adjacent")

    def _patch_checks(self, slot, sector="z"):
        r0, c0 = self._origin(slot)
        h = self._hz_p if sector == "z" else self._hx_p
        return self._embed(h, r0, c0, self.d, self.d)

    def _merged_checks(self, a, b, orient, sector="z"):
        (Ia, Ja), (Ib, Jb) = a, b
        r0 = min(Ia, Ib) * (self.d + 1)
        c0 = min(Ja, Jb) * (self.d + 1)
        if orient == "v":
            h = self._hz_v if sector == "z" else self._hx_v
            return self._embed(h, r0, c0, 2 * self.d + 1, self.d)
        h = self._hz_h if sector == "z" else self._hx_h
        return self._embed(h, r0, c0, self.d, 2 * self.d + 1)

    # -- phase emission --------------------------------------------------------

    def _sep_checks_active(self, exclude=()):
        checks, conj, act = [], [], np.zeros(self.n, np.uint8)
        for slot, pid in sorted(self._occ.items()):
            if pid in exclude:
                continue
            checks.append(self._patch_checks(slot))
            conj.append(self._patch_checks(slot, "x"))
            act |= self._block_mask(slot)
        return (np.concatenate(checks, axis=0),
                np.concatenate(conj, axis=0), act)

    def _push_sep(self):
        checks, conj, act = self._sep_checks_active()
        self._phases.append(P.Phase(checks, self.R))
        self._conj_checks.append(conj)
        self._active.append(act)

    def _push_merged(self, a, b, orient):
        seam, _ = self._seam_qubits(a, b)
        merged = [self._merged_checks(a, b, orient)]
        conj = [self._merged_checks(a, b, orient, "x")]
        act = self._block_mask(a) | self._block_mask(b)
        act[seam] = 1
        for slot, pid in sorted(self._occ.items()):
            if slot in (a, b):
                continue
            merged.append(self._patch_checks(slot))
            conj.append(self._patch_checks(slot, "x"))
            act |= self._block_mask(slot)
        self._phases.append(P.Phase(np.concatenate(merged, axis=0), self.R))
        self._conj_checks.append(np.concatenate(conj, axis=0))
        self._active.append(act)
        return len(self._phases) - 1

    # -- ops --------------------------------------------------------------------

    def _expected(self, q: int) -> int | None:
        """Deterministic Z-readout expectation of data qubit q, or None
        when the tracked state is projection-random (non-Z basis) or
        depends on an unresolved symbolic measurement."""
        if self._basis[q] != "z" or self._bsyms[q]:
            return None
        return self._bits[q]

    def _pair_expected(self, a: int, b: int) -> int | None:
        """Deterministic Z̄_a·Z̄_b expectation, or None (non-Z basis or
        unresolved symbols that do not cancel)."""
        if self._basis[a] != "z" or self._basis[b] != "z":
            return None
        if self._bsyms[a] ^ self._bsyms[b]:
            return None
        return self._bits[a] ^ self._bits[b]

    def _require_even(self, op: str, *qs: int):
        for q in qs:
            if self._hpar[q] & 1:
                raise ValueError(f"{op}() on a rotated (odd-H-parity) "
                                 "patch is not modeled; apply h after "
                                 "entangling ops")

    def _check_free(self, slot):
        I, J = slot
        if not (0 <= I < 2 and 0 <= J < self.slot_cols):
            raise ValueError(f"slot {slot} outside the grid")
        if slot in self._occ:
            raise ValueError(f"slot {slot} is occupied")

    def _prep(self, slot, encoded: bool = False) -> str:
        """Activate a fresh ancilla patch.

        Default: |+̄⟩ as the transversal product |+⟩^⊗n (declared
        conjugate init: its first Z-check round is projection
        randomness, so the builder must emit no init detectors for it).

        encoded=True: the patch ARRIVES as an encoded codespace state
        (every stabilizer deterministic +1 → raw first-round detectors
        in BOTH sectors — no conjugate declaration anywhere). This is
        the physically faithful model for the magic/S-state gadget
        ancillas, which come from the injection factory already encoded
        (`experiments.injection`; the injection ε composes separately
        via `factory_report`) — and it is load-bearing for fault
        tolerance: a product-prepped conjugate patch's projection round
        is an OPEN time boundary one phase from the merge, which pins
        the m1 channel's fault distance at 3 for every d (the round-4
        op-set flattening; the bespoke `surgery_t` models M encoded and
        measures fd=d — see decode.fault_distance)."""
        self._check_free(slot)
        pid = f"a{self._anc_count}"
        self._anc_count += 1
        self._occ[slot] = pid
        self._slot_of[pid] = slot
        self._frames[pid] = []
        self._push_sep()
        if encoded:
            # record for the protocol runner: prepare the block as an
            # encoded |+̄⟩ (H + Z-check projection with X fixups) so
            # both sectors' raw first-round detectors are deterministic
            self._enc_init.append(P.Readout(len(self._phases) - 1,
                                            tuple(self._block_qubits(slot))))
        else:
            self._conj.append(P.Readout(len(self._phases) - 1,
                                        tuple(self._block_qubits(slot))))
        return pid

    def _zz(self, pa: str, pb: str, ref: str = "last",
            seam_basis: str = "z") -> list:
        """ZZ joint measurement of two vertically adjacent patches.
        Returns the m term list. `ref` anchors the previous-phase read
        (see patches.joint): 'last' when m pairs with a later readout of
        the same patch (cnot), 'first' when m is consumed standalone off
        a freshly prepared conjugate patch (the T gadget).

        `seam_basis` picks the seam initialization — the m combination
        is solved seam-EVEN, so the Z sector is init-agnostic, but the
        X sector is not: with a |0⟩ seam ('z', default) the extended X
        checks enter the merge projection-randomized, and a Z fault in
        the FIRST merged round on a coverage-1 qubit of an extended
        check is provably undetectable (the no-undetectable-logical
        guard caught exactly this building the compiled T gadget's OUT
        channel). Ops that score an X-sector observable through the
        merge (the T gadget) must use a |+⟩ seam ('x' — the bespoke
        `surgery_t` choice); ops whose X sector carries no observable
        (cnot, mzz) keep 'z'. Either way the seam is measured out in X
        at the split (silent for the Z sector, a scored readout for the
        X sector)."""
        a, b = self._slot_of[pa], self._slot_of[pb]
        seam, orient = self._seam_qubits(a, b)
        if orient != "v":
            raise ValueError("ZZ needs vertically adjacent patches")
        ph = self._push_merged(a, b, "v")
        self._push_sep()
        if seam_basis == "x":
            # |+⟩ seam: conjugate init for the Z sector (seam X faults
            # at activation are gauge), SCORED init for the X sector
            # (extended X checks keep their merge-entry detectors)
            self._conj.append(P.Readout(ph, tuple(seam)))
        else:
            # |0⟩ seam: scored init for the Z sector, conjugate for the
            # X sector (extended X checks lose their entry comparison)
            self._x_conj.append(P.Readout(ph, tuple(seam)))
        self._x_reads.append(P.Readout(ph + 1, tuple(seam)))
        target = (self._zrep(a) ^ self._zrep(b)).astype(np.uint8)
        return [P.joint(ph, target, mode="even", ref=ref,
                        mref=self.joint_mref)]

    def _move(self, pid: str, to_slot):
        """Move a patch to an adjacent vacant slot (grow + contract)."""
        self._check_free(to_slot)
        frm = self._slot_of[pid]
        seam, orient = self._seam_qubits(frm, to_slot)
        ph = self._push_merged(frm, to_slot, orient)
        zrep_old = self._zrep(frm)
        # relocate, then emit the contracted phase
        del self._occ[frm]
        self._occ[to_slot] = pid
        self._slot_of[pid] = to_slot
        self._push_sep()
        split_ph = len(self._phases) - 1
        zrep_new = self._zrep(to_slot)
        if orient == "v":
            # growth region was |+⟩-init (conjugate for the Z sector);
            # vacated block + seam measured in X: silent. The Z̄ moves
            # by the seam-even check-combination transfer.
            grown = self._block_qubits(to_slot) + seam
            self._conj.append(P.Readout(ph, tuple(grown)))
            # X sector mirror: |+⟩ growth is a SCORED init there, and
            # the X measure-out of the vacated block + seam is a scored
            # readout there
            self._x_reads.append(P.Readout(
                split_ph, tuple(self._block_qubits(frm) + seam)))
            self._frames[pid] = _xor_terms(
                self._frames[pid],
                [P.joint(ph, (zrep_old ^ zrep_new).astype(np.uint8),
                         mode="even", mref=self.joint_mref)])
        else:
            # growth region |0⟩-init (scored); vacated block + seam
            # measured in Z (scored readout): Z̄ = new row ⊕ readout
            # parity of the old row + the seam qubit on it.
            vacated = self._block_qubits(frm) + seam
            self._readouts.append(P.Readout(split_ph, tuple(vacated)))
            # X sector mirror: |0⟩ growth is a conjugate init there; the
            # Z measure-out is silent there
            self._x_conj.append(P.Readout(
                ph, tuple(self._block_qubits(to_slot) + seam)))
            row_z = self._zrep_row(frm)
            seam_on_row = [qb for qb in seam
                           if qb // self.cols_q == row_z]
            assert len(seam_on_row) == 1
            sup = zrep_old.copy()
            sup[seam_on_row[0]] = 1
            self._frames[pid] = _xor_terms(
                self._frames[pid],
                [P.readout_logical(split_ph, sup)])

    # -- parallel op layers ----------------------------------------------------
    #
    # The single-op emitters above serialize on the routing row (one op
    # at a time). The *_many forms emit SEVERAL disjoint ops into the
    # same phases — the brickwork layers a real surgery architecture
    # runs. For one entry they produce bit-identical schedules to the
    # single-op forms (asserted in tests/test_logical.py), so the
    # single-op paths stay untouched (their bespoke bit-identity is
    # pinned; see CLAUDE.md).

    def _prep_many(self, slots) -> list[str]:
        pids = []
        for slot in slots:
            self._check_free(slot)
            pid = f"a{self._anc_count}"
            self._anc_count += 1
            self._occ[slot] = pid
            self._slot_of[pid] = slot
            self._frames[pid] = []
            pids.append(pid)
        self._push_sep()
        ph = len(self._phases) - 1
        for slot in slots:
            self._conj.append(P.Readout(ph, tuple(self._block_qubits(slot))))
        return pids

    def _push_merged_many(self, merges):
        """One phase merging several DISJOINT slot pairs at once.
        `merges` is [(slot_a, slot_b, orient)]; all other patches keep
        their separate checks."""
        in_merge = set()
        for a, b, _ in merges:
            in_merge.update((a, b))
        checks, conj, act = [], [], np.zeros(self.n, np.uint8)
        for a, b, orient in merges:
            seam, _ = self._seam_qubits(a, b)
            checks.append(self._merged_checks(a, b, orient))
            conj.append(self._merged_checks(a, b, orient, "x"))
            act |= self._block_mask(a) | self._block_mask(b)
            act[seam] = 1
        for slot, pid in sorted(self._occ.items()):
            if slot in in_merge:
                continue
            checks.append(self._patch_checks(slot))
            conj.append(self._patch_checks(slot, "x"))
            act |= self._block_mask(slot)
        self._phases.append(P.Phase(np.concatenate(checks, axis=0), self.R))
        self._conj_checks.append(np.concatenate(conj, axis=0))
        self._active.append(act)
        return len(self._phases) - 1

    def _zz_many(self, pairs, ref: str = "last") -> list[list]:
        """Simultaneous ZZ joint measurements of disjoint vertically
        adjacent patch pairs; returns one m-term list per pair."""
        merges = []
        for pa, pb in pairs:
            a, b = self._slot_of[pa], self._slot_of[pb]
            _, orient = self._seam_qubits(a, b)
            if orient != "v":
                raise ValueError("ZZ needs vertically adjacent patches")
            merges.append((a, b, "v"))
        ph = self._push_merged_many(merges)
        self._push_sep()
        for a, b, _ in merges:
            seam, _ = self._seam_qubits(a, b)
            self._x_conj.append(P.Readout(ph, tuple(seam)))
            self._x_reads.append(P.Readout(ph + 1, tuple(seam)))
        return [[P.joint(ph, (self._zrep(a) ^ self._zrep(b)
                              ).astype(np.uint8), mode="even", ref=ref,
                              mref=self.joint_mref)]
                for a, b, _ in merges]

    def _move_many(self, moves):
        """Simultaneously move several patches to disjoint adjacent
        vacant slots (grow + contract in one phase pair)."""
        plan = []
        for pid, to_slot in moves:
            self._check_free(to_slot)
            frm = self._slot_of[pid]
            seam, orient = self._seam_qubits(frm, to_slot)
            plan.append((pid, frm, to_slot, seam, orient))
        ph = self._push_merged_many(
            [(frm, to, orient) for _, frm, to, _, orient in plan])
        for pid, frm, to_slot, _, _ in plan:
            del self._occ[frm]
            self._occ[to_slot] = pid
            self._slot_of[pid] = to_slot
        self._push_sep()
        split_ph = len(self._phases) - 1
        for pid, frm, to_slot, seam, orient in plan:
            zrep_old, zrep_new = self._zrep(frm), self._zrep(to_slot)
            if orient == "v":
                grown = self._block_qubits(to_slot) + seam
                self._conj.append(P.Readout(ph, tuple(grown)))
                self._x_reads.append(P.Readout(
                    split_ph, tuple(self._block_qubits(frm) + seam)))
                self._frames[pid] = _xor_terms(
                    self._frames[pid],
                    [P.joint(ph, (zrep_old ^ zrep_new).astype(np.uint8),
                             mode="even", mref=self.joint_mref)])
            else:
                vacated = self._block_qubits(frm) + seam
                self._readouts.append(P.Readout(split_ph, tuple(vacated)))
                self._x_conj.append(P.Readout(
                    ph, tuple(self._block_qubits(to_slot) + seam)))
                row_z = self._zrep_row(frm)
                seam_on_row = [qb for qb in seam
                               if qb // self.cols_q == row_z]
                assert len(seam_on_row) == 1
                sup = zrep_old.copy()
                sup[seam_on_row[0]] = 1
                self._frames[pid] = _xor_terms(
                    self._frames[pid],
                    [P.readout_logical(split_ph, sup)])

    def mzz_layer(self, pairs) -> "LogicalProgram":
        """One BRICKWORK LAYER of non-destructive joint measurements:
        Z̄_a·Z̄_b for several DISJOINT data pairs SIMULTANEOUSLY, each
        via its own routed ancilla — the parallel form of `mzz` (a real
        architecture runs all its logical-level checks at once; the
        serialized bus costs idle exposure and rounds). Phase count is
        O(max route length), independent of the number of pairs.

        Pairs must have disjoint routing footprints: the ancilla for
        (a, b) occupies routing-row columns between 2a and 2b."""
        pairs = [(int(a), int(b)) for a, b in pairs]
        if not pairs:
            raise ValueError("need at least one pair")
        spans = []
        for a, b in pairs:
            if not (0 <= a < self.n_data and 0 <= b < self.n_data) \
                    or a == b:
                raise ValueError(f"bad mzz pair {(a, b)}")
            spans.append((min(2 * a, 2 * b), max(2 * a, 2 * b)))
        order = sorted(range(len(pairs)), key=lambda i: spans[i][0])
        for i, j in zip(order, order[1:]):
            if spans[i][1] >= spans[j][0]:
                raise ValueError("mzz_layer pairs overlap on the "
                                 "routing row")
        ancs = self._prep_many([(1, 2 * a) for a, _ in pairs])
        m1s = self._zz_many([(f"d{a}", anc)
                             for (a, _), anc in zip(pairs, ancs)])
        cols = [2 * a for a, _ in pairs]
        tgts = [2 * b for _, b in pairs]
        while any(c != t for c, t in zip(cols, tgts)):
            moves = []
            for i, (c, t) in enumerate(zip(cols, tgts)):
                if c != t:
                    step = 1 if t > c else -1
                    moves.append((ancs[i], (1, c + step)))
                    cols[i] = c + step
            self._move_many(moves)
        m2s = self._zz_many([(f"d{b}", anc)
                             for (_, b), anc in zip(pairs, ancs)])
        anc_slots = []
        for anc in ancs:     # measure out in X: silent deactivation
            slot = self._slot_of.pop(anc)
            del self._occ[slot]
            anc_slots.append(slot)
        frames_a = [self._frames.pop(anc) for anc in ancs]
        self._push_sep()
        for slot in anc_slots:   # scored readouts in the X sector
            self._x_reads.append(P.Readout(
                len(self._phases) - 1, tuple(self._block_qubits(slot))))
        for (a, b), m1, m2, fa in zip(pairs, m1s, m2s, frames_a):
            self._x_ok[a] = self._x_ok[b] = False
            terms = _xor_terms(_xor_terms(m1, m2), fa)
            self._aux_obs.append((f"mzz{a}{b}_{len(self._aux_obs)}",
                                  terms))
            self._aux_expected.append(self._pair_expected(a, b))
        self._op_log.append(("mzz_layer", tuple(pairs)))
        return self

    def cnot(self, c: int, t: int) -> "LogicalProgram":
        """Logical CNOT(control=c, target=t), any pair, via an ancilla
        routed along the routing row."""
        if not (0 <= c < self.n_data and 0 <= t < self.n_data) or c == t:
            raise ValueError("bad control/target")
        self._require_even("cnot", c, t)
        a = self._prep((1, 2 * c))
        m1 = self._zz(f"d{c}", a)
        step = 1 if t > c else -1
        col = 2 * c
        while col != 2 * t - step:
            self._move(a, (1, col + step))
            col += step
        self._move(a, (0, col))           # up, beside the target
        a_slot, t_slot = (0, col), (0, 2 * t)
        seam, orient = self._seam_qubits(a_slot, t_slot)
        assert orient == "h"
        ph = self._push_merged(a_slot, t_slot, "h")
        # X sector: the XX merge's |0⟩ seam is a conjugate init there;
        # the split's Z measure-out of A + seam is silent there
        self._x_conj.append(P.Readout(ph, tuple(seam)))
        zrep_a = self._zrep(a_slot)
        # split: A measured out in Z together with the seam
        del self._occ[a_slot]
        del self._slot_of[a]
        self._push_sep()
        split_ph = len(self._phases) - 1
        vacated = self._block_qubits(a_slot) + seam
        self._readouts.append(P.Readout(split_ph, tuple(vacated)))
        row_z = self._zrep_row(a_slot)
        seam_on_row = [qb for qb in seam if qb // self.cols_q == row_z]
        assert len(seam_on_row) == 1
        m_a = [P.readout_logical(split_ph, zrep_a)]
        pi = [P.readout_bit(split_ph, seam_on_row[0])]
        upd = _xor_terms(_xor_terms(m1, self._frames.pop(a)),
                         _xor_terms(m_a, pi))
        if self._frames[f"d{t}"] and \
                self._frame_sec.get(f"d{t}", "z") != "z":
            raise ValueError("cnot target carries X-sector frame terms")
        self._frame_sec[f"d{t}"] = "z"
        self._frames[f"d{t}"] = _xor_terms(self._frames[f"d{t}"], upd)
        self._x_ok[c] = self._x_ok[t] = False
        if self._basis[c] == "z" and self._basis[t] == "z":
            self._bits[t] ^= self._bits[c]
            self._bsyms[t] ^= self._bsyms[c]
        else:                      # untrackable (entangling) input
            self._basis[c] = self._basis[t] = "e"
        self._op_log.append(("cnot", c, t))
        return self

    def t(self, q: int) -> "LogicalProgram":
        """T gadget on data qubit q: ZZ with a magic patch below it,
        magic patch measured out in X. The m1 outcome selects S̄ vs S̄†
        — scored as its own observable row (`t{q}_m1`); Z̄_q itself is
        unchanged by T. The magic patch is a stabilizer stand-in with
        the identical fault model (physics: experiments/surgery_t.py)."""
        if self._basis[q] != "z":
            raise ValueError("t() needs a Z-basis qubit (non-stabilizer "
                             "state otherwise); apply it before h/s")
        return self._magic_gadget(q, "t")

    def s(self, q: int) -> "LogicalProgram":
        """Standalone logical S on data qubit q — twist-free S-state
        injection: the SAME merge-split-readout gadget as `t` (the
        physical ancilla is |Ȳ⟩ = S̄|+̄⟩ instead of a T magic state),
        measured-m1 selecting S̄ vs S̄† = S̄·Z̄. Unlike T, the wrong-m1
        branch differs only by a PAULI (Z̄) — the gadget is Clifford —
        so `s{q}_m1` failing corrupts the Z̄ frame rather than applying
        a non-Clifford error. Fault model and schedule are IDENTICAL to
        `t` (the stand-in patch carries the same merge/readout fault
        surface); only the tracked state and the channel interpretation
        differ. Reference anchor: the reference registers transversal S
        only for doubly-even self-dual codes (css_code.py:199,429-431)
        and has no path at all for codes without it — this gadget is
        the surface-code route."""
        # S: |z_b⟩ -> |z_b⟩ (phase only); |x_b⟩ -> |y_b⟩; |y_b⟩ -> |x_{1-b}⟩
        if self._basis[q] == "x":
            self._basis[q] = "y"
        elif self._basis[q] == "y":
            self._basis[q] = "x"
            self._bits[q] ^= 1
        return self._magic_gadget(q, "s")

    def _magic_gadget(self, q: int, kind: str) -> "LogicalProgram":
        if not 0 <= q < self.n_data:
            raise ValueError("bad qubit")
        if self._hpar[q] & 1:
            raise ValueError("magic gadgets need an even-H-parity patch "
                             "(rotated-patch merges are not modeled)")
        self._x_ok[q] = False   # the ZZ joint randomizes X̄_q; only
        #                           the OUT channel's anchored product
        #                           is recorded (no X̄ frame on q)
        m = self._prep((1, 2 * q), encoded=True)
        m1 = self._zz(f"d{q}", m, ref="mid", seam_basis="x")
        seam_ro = self._x_reads[-1]       # the ZZ seam's X readout
        # measure M out in X: silent deactivation at the next phase
        slot = self._slot_of.pop(m)
        del self._occ[slot]
        self._frames.pop(m)
        self._push_sep()
        ph_last = len(self._phases) - 1
        self._x_reads.append(P.Readout(ph_last,
                                       tuple(self._block_qubits(slot))))
        # X-sector OUT channel: the preserved product X̄_D X̄_M rides the
        # merged column THROUGH the seam qubit (surgery_t's X sector,
        # re-derived on the compiled layout). M_X = transversal X
        # readout of M; the seam qubit on the X̄ column was read in X at
        # the ZZ split; X̄_D closes at the FINAL boundary — the bespoke
        # surgery_t convention (round 5: the round-4 anchored form cut
        # the X̄ worldline mid-chain, which combined with the then-open
        # birth boundary pinned OUT's fault distance at 3; with
        # encoded data init + final-boundary scoring it is d, measured
        # by decode.fault_distance). Post-consumption Z faults on D
        # book only when they also evade every later detector
        # (suppressed ~p^(d/2)); OUT failing = wrong M_X-conditioned
        # Z̄ frame on D = a logical error the Z sector cannot see.
        c_rep = self._origin((0, 2 * q))[1] + 1   # the interior X̄ column
        s0 = [qb for qb in seam_ro.qubits if qb % self.cols_q == c_rep]
        assert len(s0) == 1
        # X̄_D's boundary form is finalized in measure(): the FINAL
        # boundary (fd = d, the bespoke convention) when no later op
        # disturbs q's X̄ — scoring X̄_D at the final is inconsistent
        # once a later merge randomizes it (the signature guard fires,
        # e.g. t(1); cnot(1,2) at d=5) — else ANCHORED at M's readout
        # (guard-consistent; carries the weight-4 anchor-cut classes,
        # see patches.logical_at)
        terms = [P.logical(self._xrep((0, 2 * q))),
                 P.readout_logical(ph_last, self._xrep(slot)),
                 P.readout_bit(seam_ro.phase, s0[0])]
        # +1: the gadget's own op_log entry is appended after this
        self._pending_out.append((len(self._x_obs), q,
                                  len(self._op_log) + 1, ph_last))
        out_name = f"{kind}{q}_out_{len(self._x_obs)}"
        m1_name = f"{kind}{q}_m1_{len(self._aux_obs)}"
        self._x_obs.append((out_name, terms))
        self._x_expected.append(None)
        self._aux_obs.append((m1_name, m1))
        self._aux_expected.append(None)   # projection-random on |+̄⟩
        # both gadget channels are coin-valued yet GAUGE-FREE at the
        # circuit tier (round 5): M arrives encoded (no projection-
        # round birth gauge — the round-4 drop reason) and D's data
        # init is encoded by default; the mid-phase joint read and the
        # final-boundary OUT are then well-defined circuit observables
        # (the build guard + differential tests verify)
        self._circ_scoreable.add(m1_name)
        self._circ_scoreable.add(out_name)
        self._op_log.append((kind, q))
        return self

    def mzz(self, a: int, b: int) -> "LogicalProgram":
        """Non-destructive joint measurement of Z̄_a·Z̄_b, any data pair:
        |+̄⟩ ancilla below `a`, ZZ(A, D_a), routed along the routing row
        to below `b`, ZZ(A, D_b), measured out in X (silent). The scored
        combination m1 ⊕ m2 ⊕ frame(A) equals Z̄_a·Z̄_b because Z̄_A is
        random-but-consistent across the two joints (its representative
        is transported by the move frames). Both patches survive — this
        is the syndrome-extraction primitive of logical-level codes
        (`patches.parity_chain_model` hand-rolls the column version)."""
        if not (0 <= a < self.n_data and 0 <= b < self.n_data) or a == b:
            raise ValueError("bad mzz pair")
        self._require_even("mzz", a, b)
        anc = self._prep((1, 2 * a))
        m1 = self._zz(f"d{a}", anc)
        step = 1 if b > a else -1
        col = 2 * a
        while col != 2 * b:
            self._move(anc, (1, col + step))
            col += step
        m2 = self._zz(f"d{b}", anc)
        # measure A out in X: silent deactivation (same as t's magic
        # patch) — no observable reads A after m2, so its trailing EC
        # rounds are gauge
        slot = self._slot_of.pop(anc)
        del self._occ[slot]
        frame_a = self._frames.pop(anc)
        self._push_sep()
        self._x_reads.append(P.Readout(len(self._phases) - 1,
                                       tuple(self._block_qubits(slot))))
        terms = _xor_terms(_xor_terms(m1, m2), frame_a)
        self._x_ok[a] = self._x_ok[b] = False
        self._aux_obs.append((f"mzz{a}{b}_{len(self._aux_obs)}", terms))
        self._aux_expected.append(self._pair_expected(a, b))
        self._op_log.append(("mzz", a, b))
        return self

    def x(self, q: int) -> "LogicalProgram":
        """Logical X̄ on data qubit q — a deterministic Pauli frame op.

        Emits no phases and no fault locations: a noiseless X̄ chain
        commutes with every Z stabilizer (detectors untouched) and
        anticommutes with Z̄_q (later Z readouts flip). The compiler
        applies it to the tracked classical bits — program ORDER
        matters through cnot — and records the physical chain + phase
        boundary in `meta["x_ops"]` so the tableau golds can enact it.
        (The dual z(q) is the identity on every observable a Z-basis
        program can score, so there is nothing to compile for it.)"""
        if not 0 <= q < self.n_data:
            raise ValueError("bad qubit")
        if self._basis[q] in ("z", "y"):
            self._bits[q] ^= 1
        chain = self._xbar_chain(q)
        self._xops.append((len(self._phases), chain))
        self._frame_ops.append(("x", len(self._phases), chain))
        self._op_log.append(("x", q))
        return self

    def _xbar_chain(self, q: int) -> tuple[int, ...]:
        """Physical X̄ chain of data patch q's CURRENT code: a column of
        X's at even H parity; after an odd number of h's the patch is
        the rotated code, whose X̄' = H X̄ H-conjugate is an X ROW."""
        r0, c0 = self._origin((0, 2 * q))
        if self._hpar[q] & 1:
            return tuple(r0 * self.cols_q + c0 + c for c in range(self.d))
        return tuple((r0 + r) * self.cols_q + c0 for r in range(self.d))

    def _zbar_chain(self, q: int) -> tuple[int, ...]:
        """Physical Z̄ chain of the current code: a row of Z's at even
        parity, a COLUMN (the rotated code's Z̄') at odd parity."""
        r0, c0 = self._origin((0, 2 * q))
        if self._hpar[q] & 1:
            return tuple((r0 + r) * self.cols_q + c0 for r in range(self.d))
        return tuple(r0 * self.cols_q + c0 + c for c in range(self.d))

    def z(self, q: int) -> "LogicalProgram":
        """Logical Z̄ on data qubit q — the dual frame op of `x`. For a
        Z-basis qubit it is the identity on every observable this
        compiler scores; on an X/Y-basis qubit (after `h`/`s`) it flips
        the tracked bit. Emits no phases and no fault locations; the
        physical chain is recorded for the tableau golds (it flips
        X-sector readouts and premeasured X̄ references). Reference
        anchor: _apply_pauli, css_code.py:386-407."""
        if not 0 <= q < self.n_data:
            raise ValueError("bad qubit")
        if self._basis[q] in ("x", "y"):
            self._bits[q] ^= 1
        self._frame_ops.append(("z", len(self._phases),
                                self._zbar_chain(q)))
        self._op_log.append(("z", q))
        return self

    def y(self, q: int) -> "LogicalProgram":
        """Logical Ȳ = iX̄Z̄ — flips the tracked bit in the Z and X bases
        (leaves a Y-basis state alone); physically the Z̄ then X̄ chains
        (global phase untracked). Reference anchor: y_operators,
        css_code.py:163-172."""
        if not 0 <= q < self.n_data:
            raise ValueError("bad qubit")
        if self._basis[q] in ("z", "x"):
            self._bits[q] ^= 1
        self._frame_ops.append(("z", len(self._phases),
                                self._zbar_chain(q)))
        self._frame_ops.append(("x", len(self._phases),
                                self._xbar_chain(q)))
        self._op_log.append(("y", q))
        return self

    def h(self, q: int) -> "LogicalProgram":
        """Logical H on data qubit q — a TRANSVERSAL physical H on the
        patch, which maps it to the 90-degree-rotated surface code
        (Z-type stabilizers on the X-plaquette layout and vice versa).

        The fault model needs NO new machinery: tracing the final
        observable backward from the readout, each H boundary maps the
        scored check history onto the SAME supports (H exchanges the
        Z-check and the rotated code's X-check on one plaquette, so the
        cross-boundary time-pair detectors stay deterministic on
        unchanged rows), so each patch's scored-sector supports are
        CONSTANT across all phases and equal to `build`'s hz embedding
        when the patch's TOTAL H count is even, and to `build_x`'s hx
        embedding when it is odd. Under the uniform (species-symmetric)
        phenomenological noise both sectors' fault processes are iid,
        so the assembled F/obs/graph arrays are literally unchanged —
        `h` only (1) toggles which sector scores the patch's final
        readout (`measure` routes odd-parity patches to the X-sector
        schedule with the interior-COLUMN representative: the rotated
        code's Z̄'), and (2) reinterprets which PHYSICAL measurement
        each model row is, which only the tableau protocol runner
        (`experiments.protocol`) must honor: post-H it measures the hz
        rows as X-type operators and the hx rows as Z-type, applies the
        recorded transversal H at the boundary, and reads the patch's
        final word in the basis the evaluated recipe needs.

        Restrictions (documented, guard-enforced): the patch must carry
        no accumulated frame terms (they would straddle sectors — H
        after entangling ops needs the joint two-sector machinery), and
        merges of rotated patches (gadgets/cnot/mzz on odd parity) are
        not modeled. Reference anchor: transversal H,
        css_code.py:188-201,409-431 — valid there only when C1=C2; the
        surface patch needs the rotation argument above instead."""
        if not 0 <= q < self.n_data:
            raise ValueError("bad qubit")
        if self._frames[f"d{q}"]:
            raise ValueError(
                "h() on a patch with accumulated frame terms would mix "
                "sectors; apply h before entangling ops or conditionals")
        if self._basis[q] == "z":
            self._basis[q] = "x"
        elif self._basis[q] == "x":
            self._basis[q] = "z"
        elif self._basis[q] == "y":   # H on a Y eigenstate: |+i> <-> |-i>
            self._bits[q] ^= 1
        self._hpar[q] ^= 1
        self._frame_ops.append(("h", len(self._phases),
                                tuple(self._block_qubits((0, 2 * q)))))
        self._op_log.append(("h", q))
        return self

    def idle(self) -> "LogicalProgram":
        """One separate-patches phase (R extraction rounds) with no op —
        exposes every patch to memory noise; also gives frame ops (h
        in particular) EC rounds between them, which is what makes the
        rotated-interval fault model non-trivial."""
        self._push_sep()
        self._op_log.append(("idle",))
        return self

    def _prep0(self, slot) -> str:
        """Activate a fresh ancilla patch in |0̄⟩: SCORED init for the Z
        sector (raw init detectors; Z̄ deterministic 0) and conjugate
        init for the X sector — the exact mirror of `_prep`'s |+̄⟩."""
        self._check_free(slot)
        pid = f"a{self._anc_count}"
        self._anc_count += 1
        self._occ[slot] = pid
        self._slot_of[pid] = slot
        self._frames[pid] = []
        self._push_sep()
        self._x_conj.append(P.Readout(len(self._phases) - 1,
                                      tuple(self._block_qubits(slot))))
        return pid

    def mz(self, q: int) -> "LogicalProgram":
        """NON-destructive logical Z̄ measurement of data qubit q — the
        reference's mid-program MEASURE on a code block
        (css_code.py:542-589), realized as surgery: a |0̄⟩ ancilla A
        below the patch (`_prep0`), one vertical ZZ merge (m1 = Z̄_q·Z̄_A
        seam-even), split, A measured out transversally in Z (scored
        readouts + closure detectors). m = m1 ⊕ M_A reads Z̄_q exactly
        (Z̄_A is deterministically 0 on the fresh |0̄⟩ and M_A accounts
        its fault history). A Z-basis patch is measured WITHOUT
        collapse (bit preserved); X/Y-basis states collapse to a
        symbolic Z bit that `x_if` can consume. X̄_q is genuinely
        randomized (only Z̄_qZ̄_A's conjugate product survives the
        joint), so a later h() readout of this patch is unanchored —
        the scoreability flags track it."""
        if not 0 <= q < self.n_data:
            raise ValueError("bad qubit")
        self._require_even("mz", q)
        anc = self._prep0((1, 2 * q))
        m1 = self._zz(f"d{q}", anc, ref="last")
        a_slot = self._slot_of.pop(anc)
        del self._occ[a_slot]
        self._frames.pop(anc)
        self._push_sep()
        split_ph = len(self._phases) - 1
        self._readouts.append(P.Readout(split_ph,
                                        tuple(self._block_qubits(a_slot))))
        m_terms = _xor_terms(
            m1, [P.readout_logical(split_ph, self._zrep(a_slot))])
        name = f"mz{q}_{len(self._aux_obs)}"
        if self._basis[q] == "z":
            exp = None if self._bsyms[q] else self._bits[q]
        else:
            exp = None
            self._basis[q] = "z"
            self._bits[q] = 0
            self._bsyms[q] = {name}
        self._aux_obs.append((name, m_terms))
        self._aux_expected.append(exp)
        self._x_ok[q] = False   # X̄_q randomized by the ZZ joint
        self._op_log.append(("mz", q))
        return self

    def mx(self, q: int) -> "LogicalProgram":
        """NON-destructive logical X̄ measurement of data qubit q — the
        X-basis mirror of `mzz`'s machinery: a |+̄⟩ ancilla A beside the
        patch on the data row, one HORIZONTAL XX merge (|+⟩ seam: the
        X sector keeps its merge-entry detectors — scored init there,
        conjugate for the Z sector), split with A + seam measured out
        in X (X-sector scored readouts with closure detectors). The
        measured combination m = X̄_q·X̄_A with X̄_A deterministic (+1)
        on the fresh |+̄⟩, so `mx{q}_*` = X̄_q — scored in the build_x
        schedule (X-type outcomes live in the X-check sector). The
        patch survives; its Z̄ is genuinely randomized (X̄ measurement),
        which the tracked state records by collapsing to the X basis
        with a SYMBOLIC bit naming this outcome — `x_if` can cancel it
        (the reference's measure-and-correct feedback,
        test/test_ftqc.py:104-113, compiles to exactly mx + h + x_if
        via MZ∘H = H∘MX)."""
        if not 0 <= q < self.n_data:
            raise ValueError("bad qubit")
        self._require_even("mx", q)
        j = 2 * q + 1 if 2 * q + 1 < self.slot_cols else 2 * q - 1
        a = self._prep((0, j))
        a_slot, q_slot = (0, j), (0, 2 * q)
        seam, orient = self._seam_qubits(a_slot, q_slot)
        assert orient == "h"
        ph = self._push_merged(a_slot, q_slot, "h")
        # |+> seam: conjugate init for the Z sector, scored for X
        self._conj.append(P.Readout(ph, tuple(seam)))
        target = (self._xrep(a_slot) ^ self._xrep(q_slot)).astype(np.uint8)
        # split: A + seam measured out in X — scored X-sector readouts
        del self._occ[a_slot]
        del self._slot_of[a]
        self._frames.pop(a)
        self._push_sep()
        split_ph = len(self._phases) - 1
        vacated = self._block_qubits(a_slot) + seam
        self._x_reads.append(P.Readout(split_ph, tuple(vacated)))
        m_terms = [P.joint(ph, target, mode="even", ref="last",
                           mref=self.joint_mref)]
        name = f"mx{q}_{len(self._x_obs)}"
        if self._basis[q] == "x" and not self._bsyms[q]:
            exp = self._bits[q]
        else:
            exp = None
        self._x_obs.append((name, m_terms))
        self._x_expected.append(exp)
        self._z_ok[q] = False      # Z̄ re-projected, anchor unrecorded
        self._x_ok[q] = True       # the outcome itself anchors X̄
        if self._basis[q] != "x":     # collapse onto the measured axis
            self._basis[q] = "x"
            self._bits[q] = 0
            self._bsyms[q] = {name}
        self._op_log.append(("mx", q))
        return self

    def x_if(self, q: int, outcome: str) -> "LogicalProgram":
        """Conditional logical X̄ on q keyed on a measured program
        outcome (`outcome` = an aux-observable name: an mx/mzz/m1 row)
        — classical feedback compiled as OBSERVABLE ALGEBRA: frames are
        software in this framework (the reference's known-errors-as-
        classical-memory design, qecc.py:14-31), so the conditional
        X̄^m XORs m's term combination into q's frame; no physical op
        is emitted and the final readout combination self-corrects.
        The referenced terms carry their sector with them; a patch's
        frame must stay single-sector (cross-sector feedback would
        need jointly-decoded sectors — refused)."""
        if not 0 <= q < self.n_data:
            raise ValueError("bad qubit")
        sec = terms = None
        m_exp: int | None = None
        for i, (nm, tl) in enumerate(self._aux_obs):
            if nm == outcome:
                sec, terms, m_exp = "z", tl, self._aux_expected[i]
        for i, (nm, tl) in enumerate(self._x_obs):
            if nm == outcome:
                sec, terms, m_exp = "x", tl, self._x_expected[i]
        if terms is None:
            raise ValueError(f"no measured outcome named {outcome!r}")
        pid = f"d{q}"
        if self._frames[pid] and self._frame_sec.get(pid, sec) != sec:
            raise ValueError("cross-sector feedback on one patch is "
                             "not decodable by the independent-sector "
                             "model")
        self._frame_sec[pid] = sec
        self._frames[pid] = _xor_terms(self._frames[pid], terms)
        if self._basis[q] in ("z", "y"):
            if m_exp is not None:       # deterministic outcome: fold in
                self._bits[q] ^= m_exp
            else:
                self._bsyms[q] ^= {outcome}
        self._op_log.append(("x_if", q, outcome))
        return self

    def measure(self) -> "LogicalProgram":
        """Finalize: transversal Z readout of every data patch.

        A patch with EVEN H parity scores in the Z-sector schedule as
        always (interior-ROW representative ⊕ accumulated frames). A
        patch with ODD parity is the ROTATED code at readout time: its
        Z̄' is the interior-COLUMN support and its whole scored check
        history rides the hx embedding, i.e. the `build_x` schedule —
        the observable is declared there (`run_full` scores it; `run`
        refuses). Expected values come from the tracked state machine
        (None when the state is projection-random or symbolic)."""
        if hasattr(self, "_obs"):
            return self
        # finalize pending gadget OUT channels: keep the final-boundary
        # X̄_D form only when no later PHYSICAL op touches q (Pauli
        # frame ops and x_if are software and harmless); otherwise
        # anchor at M's readout phase (see _magic_gadget)
        def _op_qubits(op):
            if op[0] == "mzz_layer":
                return {x for pr in op[1] for x in pr}
            return {x for x in op[1:] if isinstance(x, int)}

        for i_x, q, op_pos, ph_last in self._pending_out:
            later = self._op_log[op_pos:]
            disturbed = any(
                q in _op_qubits(op)
                and op[0] not in ("x", "z", "y", "x_if")
                for op in later)
            if disturbed:
                name, terms = self._x_obs[i_x]
                terms = [P.logical_at(ph_last, t[1])
                         if t[0] == "logical" else t for t in terms]
                self._x_obs[i_x] = (name, terms)
                # anchored terms cannot ride the circuit tier's recipe
                self._circ_scoreable.discard(name)
        self._obs_names = [name for name, _ in self._aux_obs]
        self._obs = [terms for _, terms in self._aux_obs]
        self._obs_expected = list(self._aux_expected)
        self._unscored: list[str] = []
        for i in range(self.n_data):
            pid = f"d{i}"
            exp = self._expected(i)
            need = "x" if self._hpar[i] & 1 else "z"
            # anchor check: the readout is a decodable channel only if
            # the measured logical's history has a recorded reference
            # (flags live in the unrotated frame; odd parity reads the
            # X̄ history). mx-without-h is the canonical drop: its Z̄ is
            # re-projected gauge and declaring it trips the build-time
            # same-signature guard.
            ok = self._x_ok[i] if self._hpar[i] & 1 else self._z_ok[i]
            if not ok:
                self._unscored.append(f"z{i}")
                continue
            if self._frames[pid] and \
                    self._frame_sec.get(pid, need) != need:
                raise ValueError(
                    f"patch {pid}: frame terms live in the "
                    f"{self._frame_sec[pid]!r} sector but the final "
                    f"readout scores in {need!r} (apply h before the "
                    "conditional, as mx+h+x_if does)")
            if self._hpar[i] & 1:
                terms = _xor_terms(
                    [P.logical(self._xrep(self._slot_of[pid]))],
                    self._frames[pid])
                self._x_obs.append((f"z{i}", terms))
                self._x_expected.append(exp)
            else:
                terms = _xor_terms(
                    [P.logical(self._zrep(self._slot_of[pid]))],
                    self._frames[pid])
                self._obs_names.append(f"z{i}")
                self._obs.append(terms)
                self._obs_expected.append(exp)
        return self

    def build(self, p: float | None = None,
              q: float | None = None,
              with_recipe: bool = False) -> P.ScheduleModel:
        if not hasattr(self, "_obs"):
            self.measure()
        # memoize per (p, q, recipe): repeat run() calls must reuse the
        # SAME model object so schedule_memory_device's per-model runner
        # cache hits (rebuilding cost ~1.5 s of retrace + compile-cache
        # fetch per call and dominated the fused pipeline)
        ck = (p, q, with_recipe, len(self._phases), len(self._op_log))
        cache = getattr(self, "_model_cache", None)
        if cache is None:
            cache = self._model_cache = {}
        if ck in cache:
            return cache[ck]
        model = P.build_schedule(
            self.n, self._phases, np.stack(self._active), self._obs,
            readouts=tuple(self._readouts),
            conjugate_init=tuple(self._conj), p=p, q=q,
            with_recipe=with_recipe)
        model.meta["obs_names"] = list(self._obs_names)
        model.meta["obs_expected"] = list(self._obs_expected)
        model.meta["unscored"] = list(getattr(self, "_unscored", []))
        model.meta["x_ops"] = list(self._xops)
        model.meta["frame_ops"] = list(self._frame_ops)
        model.meta["op_log"] = list(self._op_log)
        cache[ck] = model
        return model

    def build_x(self, p: float | None = None,
                q: float | None = None,
                with_recipe: bool = False) -> P.ScheduleModel:
        """The X-CHECK sector of the compiled program (Z-error faults) —
        the mirror schedule over the SAME phases: scored checks are the
        patches' X stabilizers (`self._conj_checks`), X-basis events
        swap roles (|+̄⟩ preps and |+⟩ move-growth regions become scored
        inits; X measure-outs of mzz/t ancillas, ZZ seams and vertical-
        move vacated blocks become scored readouts with closure
        detectors) and Z-basis events become conjugate inits (initial
        data patches, |0⟩ seams, horizontal-move growth) or silent
        deactivations (cnot's ancilla split, horizontal-move vacated
        blocks).

        Observables: one OUT channel per t() gadget — the preserved
        X̄_D·X̄_M product read through M's transversal X readout and the
        seam's split-time X bit, with X̄_D closed at the final
        boundary (`patches.logical`, the bespoke surgery_t
        convention — see _magic_gadget). OUT failing corrupts the
        M_X-conditioned Z̄ frame: the gadget failure channel the
        Z-sector model documents as out-of-scope
        (`experiments.surgery_t.build_merge_readout_sector` is the
        bespoke original; cnot/mzz book no X-sector channel — their
        X readouts are gauge for Z-basis programs).

        The final time boundary keeps the bespoke convention: a perfect
        transversal X readout closes the spacetime graph (reference
        anchor for the convention: surgery_t.py X sector). Z-basis
        programs never physically read X̄ finals; every OUT anchor
        precedes the boundary, and post-anchor Z faults are harmless,
        so the fictitious closure only sharpens decoding of faults that
        cannot score."""
        if not hasattr(self, "_obs"):
            self.measure()
        model = P.build_schedule(
            self.n, [P.Phase(h, self.R) for h in self._conj_checks],
            np.stack(self._active),
            [terms for _, terms in self._x_obs],
            readouts=tuple(self._x_reads),
            conjugate_init=tuple(self._x_conj), p=p, q=q,
            with_recipe=with_recipe)
        model.meta["obs_names"] = [name for name, _ in self._x_obs]
        model.meta["obs_expected"] = list(self._x_expected)
        model.meta["unscored"] = list(getattr(self, "_unscored", []))
        model.meta["frame_ops"] = list(self._frame_ops)
        model.meta["op_log"] = list(self._op_log)
        return model

    def run_full(self, p: float, q: float | None = None, *,
                 batch: int = 1 << 13, seed: int = 0,
                 weighted: bool = False,
                 use_native: bool | None = None,
                 device="cuda", profile: dict | None = None) -> dict:
        """Monte-Carlo BOTH fault sectors of the compiled program: the
        Z-sector schedule (X-error faults -> Z outputs, m1 channels) and
        the X-sector schedule (Z-error faults -> the t gadgets' OUT
        frame channels), independently sampled — the X and Z error
        processes are independent under this noise model — and composed
        per shot (`word_fail` = any channel of either sector wrong),
        exactly `surgery_t.t_gadget_memory`'s accounting generalized to
        whole compiled programs.

        Both sectors are sampled on ``device`` and decoded by the host
        union-find; ``profile`` receives the build / sample / readback /
        decode seconds of both (`patches.schedule_decoded_obs`)."""
        device = resolve_device(device)
        q_ = p if q is None else q
        kw = dict(p=p, q=q_) if weighted else dict(p=None, q=None)
        mark = _marker(device, profile)
        model_z = self.build(**kw)
        mark("build")
        vals = P.schedule_decoded_obs(model_z, p, q_, batch=batch,
                                      seed=seed, use_native=use_native,
                                      device=device, profile=profile)
        out = {"p": float(p), "q": float(q_), "samples": batch,
               "detectors_z": int(model_z.F.shape[0])}
        for i, name in enumerate(model_z.meta["obs_names"]):
            out[f"{name}_fail"] = float(vals[:, i].mean())
        fail_any = vals.any(axis=1)
        if self._x_obs:
            mark = _marker(device, profile)
            model_x = self.build_x(**kw)
            mark("build")
            vals_x = P.schedule_decoded_obs(model_x, p, q_, batch=batch,
                                            seed=seed + 7919,
                                            use_native=use_native,
                                            device=device, profile=profile)
            out["detectors_x"] = int(model_x.F.shape[0])
            for i, name in enumerate(model_x.meta["obs_names"]):
                out[f"{name}_fail"] = float(vals_x[:, i].mean())
            fail_any = fail_any | vals_x.any(axis=1)
        out["word_fail"] = float(fail_any.mean())
        out.update({"d": self.d, "rounds": self.R,
                    "n_phases": len(self._phases),
                    "grid_qubits": self.n})
        return out

    def run(self, p: float, q: float | None = None, *,
            batch: int = 1 << 13, seed: int = 0, weighted: bool = False,
            decoder: str = "host", reps: int = 1,
            use_native: bool | None = None,
            device="cuda", profile: dict | None = None) -> dict:
        """Monte-Carlo the compiled program; per-observable and word
        failure rates keyed by observable name.

        decoder='host' decodes with the C++ union-find;
        decoder='device-uf' runs the FULLY FUSED pipeline — sampling,
        detector assembly, union-find decode and failure counting in one
        compiled device program, only counts crossing the host boundary
        (`patches.schedule_memory_device`); decoder='device-uf-sparse'
        is the same pipeline on the defect-granular sparse kernel
        (`decode.device_sparse`, dense escape hatch) — the fast path at
        operating noise, where compiled-program shots carry a handful of
        defects in thousands of detectors.

        Everything but the host decode runs on ``device`` (the card
        unless the caller asks for the CPU). ``profile``, a dict,
        receives the seconds of 'build' (the model; memoized, so a repeat
        call adds ~0), then the host path's 'sample' / 'readback' /
        'decode' (`patches.schedule_memory`) or the fused path's 'fused'
        (the runner's build on its first call, the reps and the one read
        of the counts)."""
        q_ = p if q is None else q
        if any(hp & 1 for hp in self._hpar):
            raise ValueError(
                "program has odd-H-parity patches whose final readout "
                "scores in the X-sector schedule; use run_full")
        kw = dict(p=p, q=q_) if weighted else dict(p=None, q=None)
        device = resolve_device(device)
        mark = _marker(device, profile)
        model = self.build(**kw)
        mark("build")
        if decoder in ("device-uf", "device-uf-sparse"):
            out = P.schedule_memory_device(
                model, p, q_, batch=batch, seed=seed, reps=reps,
                device_decoder=("hybrid" if decoder == "device-uf-sparse"
                                else "dense"), device=device)
            mark("fused")
        elif decoder == "host":
            out = P.schedule_memory(model, p, q_, batch=batch, seed=seed,
                                    use_native=use_native, device=device,
                                    profile=profile)
        else:
            raise ValueError("decoder must be 'host', 'device-uf' or "
                             "'device-uf-sparse'")
        for i, name in enumerate(model.meta["obs_names"]):
            out[f"{name}_fail"] = out.pop(f"obs{i}_fail")
        out.update({"d": self.d, "rounds": self.R,
                    "n_phases": len(self._phases),
                    "grid_qubits": self.n})
        return out

    def _rot_info(self):
        """(rot [n_ph, n], h_bounds, rot_end [n]) from the h frame ops.
        Trailing h's (boundary == n_phases) affect only the final
        readout basis — they enter rot_end, not the per-phase matrix."""
        n_ph = len(self._phases)
        rot = np.zeros((n_ph, self.n), np.uint8)
        rot_end = np.zeros(self.n, np.uint8)
        h_bounds = []
        for kind, b, qubits in self._frame_ops:
            if kind != "h":
                continue
            rot_end[list(qubits)] ^= 1
            if b < n_ph:
                rot[b:, list(qubits)] ^= 1
                h_bounds.append((b, tuple(qubits)))
        return rot, tuple(h_bounds), rot_end

    def _obs_union(self, obs_lists) -> np.ndarray:
        """Union of the final-logical supports across observable term
        lists — the qubits every extraction circuit fans out FIRST so
        hook suffixes are observable-free (schedule_circuit.round_ops
        hook_first)."""
        u = np.zeros(self.n, np.uint8)
        for terms in obs_lists:
            for term in terms:
                if term[0] in ("logical", "logical_at"):
                    u |= np.asarray(term[1] if term[0] == "logical"
                                    else term[2], np.uint8)
                elif term[0] == "joint":
                    # the joint's target support: hooks crossing it
                    # shift which rounds the m-read sees per check
                    u |= np.asarray(term[2], np.uint8)
                elif term[0] == "readout_logical":
                    u |= np.asarray(term[2], np.uint8)
                elif term[0] == "readout":
                    u[int(term[2])] = 1
        return u

    def build_circuit(self, noise):
        """Circuit-level fault model: the same compiled schedule with
        REAL two-sector extraction circuits (hook faults, measurement /
        reset / init errors — see experiments.schedule_circuit).
        Mid-program transversal-H rotations (`h`) are modeled since
        round 5: rotated patches' scored rows extract as H-sandwich
        fan-outs, conjugate rows as collections, fault components book
        their scored-relevant (Z) parts on rotated wires, and the
        sampler conjugates the frames at each h boundary — see
        `schedule_circuit.round_ops`.

        Projection-random observables (`obs_expected is None` — the
        standalone T-gadget m1 rows) are EXCLUDED from circuit-level
        scoring: their raw deviation is gauge-dependent (a stabilizer-
        at-birth X frame relabels the coin without being an error), so
        the Z-scored single-sector tier cannot measure that channel —
        `experiments.surgery_t` (both sectors) is its circuit-level
        home. Dropped names are recorded in `meta["dropped_obs"]`."""
        from qcss_tpu_torch.experiments import schedule_circuit as SC

        if not hasattr(self, "_obs"):
            self.measure()
        rot, h_bounds, rot_end = self._rot_info()
        drop = tuple(i for i, e in enumerate(self._obs_expected)
                     if e is None
                     and self._obs_names[i] not in self._circ_scoreable)
        model = SC.build_circuit_schedule(
            self.n, self._phases, np.stack(self._active), self._obs,
            self._conj_checks, readouts=tuple(self._readouts),
            conjugate_init=tuple(self._conj), noise=noise,
            drop_obs=drop, rotated=rot, h_bounds=h_bounds,
            hook_first=self._obs_union(self._obs))
        keep = model.meta["kept_obs"]
        model.meta["obs_names"] = [self._obs_names[i] for i in keep]
        model.meta["obs_expected"] = [self._obs_expected[i] for i in keep]
        model.meta["dropped_obs"] = [self._obs_names[i] for i in drop]
        model.meta["op_log"] = list(self._op_log)
        return model

    def build_circuit_x(self, noise):
        """Circuit-level fault model of the X-CHECK sector schedule
        (`build_x`'s circuit tier, round 5): Z-error faults, scored
        outcomes = the patches' X-stabilizer extractions. Rides the
        SAME generalized builder with rotated = active & NOT rot — an
        unrotated patch's X rows are physically X-type (fan-out
        extraction), a rotated patch's are Z-type — which is what makes
        the feedback program (mx + h + x_if, the reference's
        measure-and-correct, test/test_ftqc.py:104-113) decodable at
        circuit level: its z0 channel lives in this sector. Dropped
        (expected-None / gauge) channels recorded as in
        `build_circuit`."""
        from qcss_tpu_torch.experiments import schedule_circuit as SC

        if not hasattr(self, "_obs"):
            self.measure()
        rot, h_bounds, rot_end = self._rot_info()
        active = np.stack(self._active)
        x_names = [name for name, _ in self._x_obs]
        drop = tuple(
            i for i, (e, (_, terms)) in enumerate(
                zip(self._x_expected, self._x_obs))
            if (e is None and x_names[i] not in self._circ_scoreable)
            or any(t[0] == "logical_at" for t in terms))
        model = SC.build_circuit_schedule(
            self.n, [P.Phase(h, self.R) for h in self._conj_checks],
            active, [terms for _, terms in self._x_obs],
            [ph.checks for ph in self._phases],
            readouts=tuple(self._x_reads),
            conjugate_init=tuple(self._x_conj), noise=noise,
            drop_obs=drop, rotated=(active & (1 - rot)),
            h_bounds=h_bounds,
            hook_first=self._obs_union(
                [terms for _, terms in self._x_obs]))
        keep = model.meta["kept_obs"]
        names = [name for name, _ in self._x_obs]
        model.meta["obs_names"] = [names[i] for i in keep]
        model.meta["obs_expected"] = [self._x_expected[i] for i in keep]
        model.meta["dropped_obs"] = [names[i] for i in drop]
        model.meta["op_log"] = list(self._op_log)
        return model

    def run_circuit(self, noise, *, batch: int = 1 << 12, seed: int = 0,
                    iters: int = 48, alpha: float = 0.8,
                    osd: bool = True, device="cuda",
                    profile: dict | None = None) -> dict:
        """Monte-Carlo the compiled program at CIRCUIT-LEVEL noise:
        frame-sampled extraction circuits, recipe detector assembly,
        BP(+device OSD) decode on the circuit fault Tanner graph.

        Programs whose scoreable channels live in the X-CHECK sector
        (odd-H-parity final readouts — HZH ends even, the feedback
        program ends odd) additionally run the mirror circuit model
        (`build_circuit_x`); `word_fail` composes both sectors per
        shot, `run_full`'s convention.

        Sampled, assembled and BP(+OSD)-decoded on ``device`` (the card
        unless the caller asks for the CPU); ``profile`` receives the
        seconds of 'build' (the circuit models and decoders), 'sample',
        'decode' and 'readback' of both sectors."""
        from qcss_tpu_torch.experiments import schedule_circuit as SC

        device = resolve_device(device)
        mark = _marker(device, profile)
        model = self.build_circuit(noise)
        mark("build")
        out = {"d": self.d, "rounds": self.R,
               "n_phases": len(self._phases), "grid_qubits": self.n}
        if model.obs.shape[0]:
            res = SC.circuit_schedule_memory(model, noise, batch=batch,
                                             seed=seed, iters=iters,
                                             alpha=alpha, osd=osd,
                                             device=device, profile=profile)
            for i, name in enumerate(model.meta["obs_names"]):
                res[f"{name}_fail"] = res.pop(f"obs{i}_fail")
            out.update(res)
        # X-sector channels (scoreable only): compose like run_full
        x_names = [name for name, _ in self._x_obs]
        x_scoreable = [
            e is not None or nm in self._circ_scoreable
            for e, nm in zip(self._x_expected, x_names)]
        if self._x_obs and any(x_scoreable):
            mark = _marker(device, profile)
            model_x = self.build_circuit_x(noise)
            mark("build")
            if model_x.obs.shape[0]:
                res_x = SC.circuit_schedule_memory(
                    model_x, noise, batch=batch, seed=seed + 7919,
                    iters=iters, alpha=alpha, osd=osd, device=device,
                    profile=profile)
                for i, name in enumerate(model_x.meta["obs_names"]):
                    res_x[f"{name}_fail"] = res_x.pop(f"obs{i}_fail")
                out["detectors_x"] = res_x.pop("detectors")
                out["fault_vars_x"] = res_x.pop("fault_vars")
                out["bp_converged_x"] = res_x.pop("bp_converged")
                wf_x = res_x.pop("word_fail")
                res_x.pop("samples", None)
                out.update(res_x)
                if "word_fail" in out:
                    # independent sectors: compose the word failure
                    wf_z = out["word_fail"]
                    out["word_fail"] = 1 - (1 - wf_z) * (1 - wf_x)
                    out["word_fail_z"] = wf_z
                    out["word_fail_x"] = wf_x
                else:
                    out["word_fail"] = wf_x
                out.setdefault("samples", batch)
        return out


def t_circuit_report(d: int, noise, *, eps_magic: float,
                     batch: int = 1 << 13, seed: int = 0) -> dict:
    """END-TO-END CIRCUIT-LEVEL logical-T error budget (round 5 — the
    capstone of the universality story the reference stubs,
    css_code.py:433-434): the compiled T gadget Monte-Carlo'd at
    circuit-level noise with BOTH fault sectors decoded (m1 on the
    Z-sector circuit Tanner graph, OUT on the X-sector's — enabled by
    the encoded-arrival magic patch and the final-boundary OUT, which
    remove the stabilizer-at-birth gauge that previously made m1
    circuit-unscoreable), composed with the injected/distilled magic
    state's residual ``eps_magic`` (`injection.factory_report`):

        t_error = 1 - (1 - word_fail) * (1 - eps_magic)

    where word_fail composes the independently-decoded sectors
    (m1 wrong → S̄ vs S̄† non-Pauli error; OUT wrong → a bad
    M_X-conditioned Z̄ frame; z0 wrong → output Z̄ flip)."""
    out = LogicalProgram(d, 1).t(0).run_circuit(noise, batch=batch,
                                                seed=seed)
    out["eps_magic"] = float(eps_magic)
    out["t_error"] = 1.0 - (1.0 - out["word_fail"]) * (1.0 - eps_magic)
    return out
