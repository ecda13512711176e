"""Circuit-level detector-fault Tanner graphs for BP decoding.

`decode.dem` / `decode.dem2` turn the extraction circuit's single-fault
enumeration into MATCHING graphs, which forces every compound fault
(an ancilla hook fanning into several data qubits — 3+ detectors) to be
decomposed into elementary two-detector edges, losing the correlation
between the pieces. Matchable codes tolerate that; qLDPC codes are not
matchable at all. This module keeps each fault mechanism as ONE Tanner
variable with its exact detector signature and its exact multi-logical
observable effect, and hands the graph to `decode.bp.BPDecoder` — the
standard circuit-level BP(+OSD) formulation for bivariate-bicycle /
hypergraph-product memories.

Fault enumeration, propagation, and round-boundary bookkeeping are shared
with `decode.dem2` (`_RoundCircuit`, `_fault_species`, `_events`): one
mechanized single-fault pass per species, detector events synthesized per
occurrence round with the experiment length in hand. Distinct mechanisms
with identical (detectors, observables) signature merge into one variable
with XOR-combined probability.

The reference has no circuit-level decoding of any kind — its decoder
trusts one noisy extraction round (reference: css_code.py:649-685)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from qcss_tpu_torch.decode.dem2 import (
    _HORIZON,
    _RoundCircuit,
    _analyze,
    _events,
    _fault_species,
)


@dataclass(frozen=True)
class CircuitTanner:
    """Detector-fault incidence of one sector of the memory experiment.

    checks : [D, F] uint8 — detector d fires when fault f occurs.
    priors : [F] float64 fault probabilities (merged).
    obs : [k, F] uint8 — logical j flips when fault f occurs.
    """

    checks: np.ndarray
    priors: np.ndarray
    obs: np.ndarray

    @property
    def n_detectors(self) -> int:
        return self.checks.shape[0]

    @property
    def n_faults(self) -> int:
        return self.checks.shape[1]


def build_circuit_tanner(code, rounds: int, noise, *, sector: str = "z",
                         hz=None, hx=None, with_map: bool = False):
    """Exact circuit-level Tanner graph of the two-sector memory schedule
    (`experiments.memory_xz`'s circuits: Z-check CNOT fan-in then
    H-sandwiched X checks, every round, perfect final readout).

    sector='z' decodes X data errors from the Z-check detector stream
    (the Z-basis memory observable); sector='x' the mirror. For qLDPC
    codes pass the FULL redundant check sets via hz/hx (defaults:
    `redundant_parity_check_c*` when the code has them, else the raw
    pre-reduction rows).

    `with_map=True` additionally returns {(component_key, round): var}
    mapping each fault mechanism to its (merged) Tanner variable — the
    hook correlated two-pass decoding uses to couple the two sectors'
    graphs."""
    if sector not in ("z", "x"):
        raise ValueError("sector must be 'z' or 'x'")
    if hz is None:
        hz = getattr(code, "redundant_parity_check_c2",
                     code.raw_parity_check_c2)
    if hx is None:
        hx = getattr(code, "redundant_parity_check_c1",
                     code.raw_parity_check_c1)
    circ = _RoundCircuit(code, hz=hz, hx=hx)
    comps, _ = _fault_species(circ, noise)
    r_c = circ.rz if sector == "z" else circ.rx
    k = (circ.lz if sector == "z" else circ.lx).shape[0]

    # merge identical (detectors, observable) signatures: the variable
    # fires if an ODD number of its mechanisms fired
    merged: dict[tuple, float] = {}
    mech_mk: dict[tuple, tuple] = {}
    for t in range(rounds):
        for key, info, oz, ox, prob in comps:
            obs = oz if sector == "z" else ox
            dets = _events(info[sector], t, rounds, r_c)
            if not dets:
                # detector-free faults carry no syndrome information; an
                # obs-carrying one would be an undetectable logical error,
                # impossible for single faults below distance
                continue
            mk = (dets, obs)
            old = merged.get(mk, 0.0)
            merged[mk] = old * (1.0 - prob) + prob * (1.0 - old)
            if with_map:
                mech_mk[(key, t)] = mk

    n_det = (rounds + 1) * r_c
    n_f = len(merged)
    checks = np.zeros((n_det, n_f), dtype=np.uint8)
    priors = np.empty(n_f, dtype=np.float64)
    obs = np.zeros((k, n_f), dtype=np.uint8)
    var_of: dict[tuple, int] = {}
    for f, ((dets, ob), prob) in enumerate(sorted(merged.items())):
        checks[list(dets), f] = 1
        priors[f] = prob
        var_of[(dets, ob)] = f
        for j in range(k):
            obs[j, f] = (ob >> j) & 1
    tan = CircuitTanner(checks=checks, priors=priors, obs=obs)
    if with_map:
        return tan, {mt: var_of[mk] for mt, mk in mech_mk.items()}
    return tan


def _joint_fault_atoms(circ: _RoundCircuit, noise):
    """FULL Pauli fault atoms of one round — the un-decomposed channel.

    `_fault_species` classifies every noisy location's patterns into
    exclusive per-sector X-component (and Z-component) SUPPORTS (what
    per-sector graphs need, Y-ness surviving only as correlation-pair
    annotations). For JOINT two-sector decoding each
    atom instead keeps its complete Pauli pattern: a CNOT's two-qubit
    depolarizing contributes all 15 patterns at p2/15 each (Y sides
    excite BOTH sectors' detectors as one variable), an H's depolarizing
    its 3 Paulis at p1/3. Returns a list of (info, obs_z, obs_x, prob)."""
    atoms = []
    nq = circ.n_qubits

    def inject(k, xq, zq, prob):
        x0 = np.zeros(nq, np.uint8)
        z0 = np.zeros(nq, np.uint8)
        for q in xq:
            x0[q] = 1
        for q in zq:
            z0[q] = 1
        info, oz, ox = _analyze(circ, k, x0, z0)
        atoms.append((info, oz, ox, prob))

    _P1 = (((0,), ()), ((), (0,)), ((0,), (0,)))  # X, Z, Y on one qubit
    p2 = noise.p_gate2
    if p2:
        r2 = noise.rate2
        if isinstance(r2, tuple):
            # biased 2q = independent per-side biased channels: pattern
            # (P_c, P_t) occurs with q(P_c)·q(P_t) (see dem2 booking)
            px, py, pz = r2
            q_ = (1 - px - py - pz, px, pz, py)  # I X Z Y

            def atom_p(a, b):
                return q_[a] * q_[b]
        else:
            def atom_p(a, b):
                return p2 / 15.0

        for k, op in enumerate(circ.ops):
            if op[0] != "cnot":
                continue
            qs = (op[1], op[2])
            for a in range(4):          # I X Z Y on control
                for b in range(4):      # I X Z Y on target
                    if a == 0 and b == 0:
                        continue
                    if not atom_p(a, b):
                        continue
                    xq = [qs[i] for i, s in ((0, a), (1, b)) if s in (1, 3)]
                    zq = [qs[i] for i, s in ((0, a), (1, b)) if s in (2, 3)]
                    inject(k, xq, zq, atom_p(a, b))
    p1 = noise.p_gate1
    if p1:
        r1 = noise.rate1
        p1_probs = (r1 if isinstance(r1, tuple)
                    else (p1 / 3.0,) * 3)  # X, Z, Y order below
        if isinstance(r1, tuple):
            p1_probs = (r1[0], r1[2], r1[1])  # (px, pz, py) to match _P1
        for k, op in enumerate(circ.ops):
            if op[0] != "h":
                continue
            q = op[1]
            for (xs, zs), pp in zip(_P1, p1_probs):
                if pp:
                    inject(k, [q] * len(xs), [q] * len(zs), pp)
    pm = noise.p_meas
    if pm:
        for k, op in enumerate(circ.ops):
            if op[0] != "measure":
                continue
            sector, check = op[2], op[3]
            info = {"z": {}, "x": {}}
            info[sector][check] = ((0,), False)
            atoms.append((info, 0, 0, pm))
    pr = noise.p_reset
    if pr:
        for k, op in enumerate(circ.ops):
            if op[0] != "reset":
                continue
            inject(k, [op[1]], [], pr)
    if noise.p_idle:
        # per-round data-qubit idle, exact X/Y/Z atoms at the round
        # boundary (same per-round semantics as dem2._fault_species)
        rate = noise.rate_idle
        px, py, pz = (rate if isinstance(rate, tuple)
                      else (rate / 3.0,) * 3)
        for q in range(circ.n):
            inject(-1, [q], [], px)
            inject(-1, [], [q], pz)
            inject(-1, [q], [q], py)
    return atoms


def build_joint_circuit_tanner(code, rounds: int, noise, *, hz=None,
                               hx=None) -> CircuitTanner:
    """JOINT two-sector circuit-level Tanner graph: detectors are the
    z-sector stream then the x-sector stream ([(rounds+1)*(rz+rx)] rows),
    observables the k z-sector rows (X-error flips of the Z logicals)
    then the k x-sector rows. Y-type faults stay single variables firing
    BOTH sectors — the exact correlation that per-sector decoding (one
    `build_circuit_tanner` per sector, Y split into component marginals)
    throws away and `decode.dem2`'s matching pipeline can only recover
    with a two-pass reweighting heuristic."""
    if hz is None:
        hz = getattr(code, "redundant_parity_check_c2",
                     code.raw_parity_check_c2)
    if hx is None:
        hx = getattr(code, "redundant_parity_check_c1",
                     code.raw_parity_check_c1)
    circ = _RoundCircuit(code, hz=hz, hx=hx)
    atoms = _joint_fault_atoms(circ, noise)
    rz, rx = circ.rz, circ.rx
    kz, kx = circ.lz.shape[0], circ.lx.shape[0]
    off = (rounds + 1) * rz

    merged: dict[tuple, float] = {}
    for t in range(rounds):
        for info, oz, ox, prob in atoms:
            dz = _events(info["z"], t, rounds, rz)
            dx = _events(info["x"], t, rounds, rx)
            dets = dz + tuple(off + d for d in dx)
            if not dets:
                continue
            mk = (dets, oz | (ox << kz))
            old = merged.get(mk, 0.0)
            merged[mk] = old * (1.0 - prob) + prob * (1.0 - old)

    n_det = (rounds + 1) * (rz + rx)
    n_f = len(merged)
    checks = np.zeros((n_det, n_f), dtype=np.uint8)
    priors = np.empty(n_f, dtype=np.float64)
    obs = np.zeros((kz + kx, n_f), dtype=np.uint8)
    for f, ((dets, ob), prob) in enumerate(sorted(merged.items())):
        checks[list(dets), f] = 1
        priors[f] = prob
        for j in range(kz + kx):
            obs[j, f] = (ob >> j) & 1
    return CircuitTanner(checks=checks, priors=priors, obs=obs)


def joint_circuit_bp_decoder(code, rounds: int, noise, *, iters: int = 64,
                             alpha: float = 0.6, osd: bool = True,
                             hz=None, hx=None):
    """BPDecoder over the joint two-sector graph; `decode_obs` maps
    `[B, (rounds+1)*(rz+rx)]` stacked detector histories (z-sector block
    first) to `[B, kz+kx]` observable flips (z-sector rows first).

    The default min-sum normalization is STRONGER than the per-sector
    decoders' (0.6 vs 0.8): the joint graph's Y-atoms add short cycles
    between the sectors, and measured word failure at alpha=0.8 was
    WORSE than independent decoding (0.81% vs 0.54%, d=3 surface,
    p_gate2=2e-3/p_meas=5e-3) while alpha=0.6 beats it (0.44%).

    REGIME GUIDANCE (measured): joint decoding wins on surface-code-like
    graphs — d=3, 8k shots: word-fail 0.49% vs 0.68% independent,
    z-sector 2.1x — but LOSES badly at qLDPC scale: bb72 R=6 uniform
    p=1e-3 explodes to 17,928 exclusive-pattern variables (vs 2x2,160
    component variables), min-sum convergence collapses to 53%, and
    failure is ~20x worse than per-sector decoding. Default to
    per-sector `circuit_bp_decoder` for qLDPC memories."""
    from qcss_tpu_torch.decode.bp import BPDecoder

    tan = build_joint_circuit_tanner(code, rounds, noise, hz=hz, hx=hx)
    return BPDecoder(tan.checks, np.clip(tan.priors, 1e-12, 0.499),
                     logicals=tan.obs, iters=iters, alpha=alpha, osd=osd)


def two_pass_pair_indices(code, rounds: int, noise, *, hz=None, hx=None):
    """Everything correlated two-pass BP needs, in one enumeration:
    (tanner_z, tanner_x, vx [P] int32, vz [P] int32, cond [P] float64).

    Row i couples variable vx[i] of the z-sector graph (an X-component
    mechanism) with variable vz[i] of the x-sector graph (its same-
    location Z-component): if the first pass decides vx fired, the
    second pass's prior for vz is raised to ``cond[i]`` — the channel's
    exact P(Z-support | X-support) (1/4 per specific support pair of the
    two-qubit depolarizing's exclusive classification; 1/2 for the
    single-qubit channels), the BP analogue of `decode.dem2`'s
    cheap-edge reweighting (dem2.py cheap_weight)."""
    if hz is None:
        hz = getattr(code, "redundant_parity_check_c2",
                     code.raw_parity_check_c2)
    if hx is None:
        hx = getattr(code, "redundant_parity_check_c1",
                     code.raw_parity_check_c1)
    circ = _RoundCircuit(code, hz=hz, hx=hx)
    comps, pairs = _fault_species(circ, noise)
    tz, map_z = build_circuit_tanner(code, rounds, noise, sector="z",
                                     hz=hz, hx=hx, with_map=True)
    tx, map_x = build_circuit_tanner(code, rounds, noise, sector="x",
                                     hz=hz, hx=hx, with_map=True)
    marg = {key: prob for key, _, _, _, prob in comps}
    vx, vz, cond = [], [], []
    for (kx_key, kz_key), pj in pairs.items():
        for t in range(rounds):
            a = map_z.get((kx_key, t))
            b = map_x.get((kz_key, t))
            if a is None or b is None:
                continue
            vx.append(a)
            vz.append(b)
            cond.append(pj / marg[kx_key])
    return (tz, tx, np.asarray(vx, np.int32), np.asarray(vz, np.int32),
            np.asarray(cond, np.float64))


@dataclass(frozen=True)
class WindowCircuitTanner:
    """Open-future sliding-window slice of the circuit-level Tanner graph.

    The mid-stream building block for `bp_streaming.CircuitBPStreamingDecoder`
    — `window` detector layers with NO terminal perfect-readout slice, every
    fault of rounds [0, window) as a variable with its open-stream detector
    signature (persistent residual errors telescope: their measurement-flip
    train produces one boundary event and nothing further until a perfect
    readout, which mid-stream never comes).

    checks : [window*r_c, F] uint8 in-window incidence.
    priors : [F] merged fault probabilities.
    obs : [k, F] uint8 observable flips — populated ONLY for committed
        faults (rounds < commit); lookahead faults are re-decoded by the
        next window and contribute 0 here.
    carry : [(window-commit)*r_c, F] uint8 — committed faults' detector
        toggles at layers >= commit, which the streaming loop XORs out of
        the already-observed lookahead region of the NEXT window.
    committed : [F] bool fault-round < commit.
    """

    checks: np.ndarray
    priors: np.ndarray
    obs: np.ndarray
    carry: np.ndarray
    committed: np.ndarray


def _open_stream_toggles(info_sector: dict, t: int) -> tuple:
    """Detector toggles of a fault at round t in an UNBOUNDED stream.

    Mirrors `dem2._events` in the rounds->infinity limit: every recorded
    measurement-flip round rh toggles detector layers (t+rh, t+rh+1); a
    persistent residual error's flip train continues forever, telescoping
    to a single extra toggle at t+_HORIZON (which cancels the trailing end
    of the rh = _HORIZON-1 pair) and NO final-slice event — consecutive
    flips cancel and the perfect readout never arrives mid-stream."""
    par: dict[tuple[int, int], int] = {}

    def toggle(layer, c):
        k = (layer, c)
        par[k] = par.get(k, 0) ^ 1

    for c, (fl, persistent) in info_sector.items():
        for rh in fl:
            toggle(t + rh, c)
            toggle(t + rh + 1, c)
        if persistent:
            toggle(t + _HORIZON, c)
    return tuple(sorted(k for k, v in par.items() if v))


def open_window_circuit_tanner(code, window: int, commit: int, noise, *,
                               sector: str = "z", hz=None,
                               hx=None) -> WindowCircuitTanner:
    """Window Tanner graph over `window` mid-stream detector layers of the
    two-sector extraction schedule, with commit bookkeeping.

    Requires ``window >= commit + _HORIZON`` so every committed fault's
    signature is fully observed by the window that commits it (commit
    quality equals whole-history locally) and its carry lands inside the
    next window. Round 0 of the true experiment has bulk signatures
    (detectors never reach negative layers), so the same graph serves the
    first window with a zero carry."""
    if sector not in ("z", "x"):
        raise ValueError("sector must be 'z' or 'x'")
    if window < commit + _HORIZON:
        raise ValueError(
            f"need window >= commit + {_HORIZON} (fault-signature horizon); "
            f"got window={window}, commit={commit}")
    if hz is None:
        hz = getattr(code, "redundant_parity_check_c2",
                     code.raw_parity_check_c2)
    if hx is None:
        hx = getattr(code, "redundant_parity_check_c1",
                     code.raw_parity_check_c1)
    circ = _RoundCircuit(code, hz=hz, hx=hx)
    comps, _ = _fault_species(circ, noise)
    r_c = circ.rz if sector == "z" else circ.rx
    k = (circ.lz if sector == "z" else circ.lx).shape[0]

    # merge identical decode-relevant signatures: committed faults must
    # also agree on (carry, obs) — those drive the streaming outputs;
    # lookahead faults only constrain this window's syndrome
    merged: dict[tuple, float] = {}
    for t in range(window):
        for key, info, oz, ox, prob in comps:
            togg = _open_stream_toggles(info[sector], t)
            in_dets = tuple(l * r_c + c for l, c in togg if l < window)
            if not in_dets:
                continue
            com = t < commit
            if com:
                ob = oz if sector == "z" else ox
                car = tuple((l - commit) * r_c + c for l, c in togg
                            if l >= commit)
            else:
                ob, car = 0, ()
            mk = (com, in_dets, car, ob)
            old = merged.get(mk, 0.0)
            merged[mk] = old * (1.0 - prob) + prob * (1.0 - old)

    n_f = len(merged)
    checks = np.zeros((window * r_c, n_f), dtype=np.uint8)
    priors = np.empty(n_f, dtype=np.float64)
    obs = np.zeros((k, n_f), dtype=np.uint8)
    carry = np.zeros(((window - commit) * r_c, n_f), dtype=np.uint8)
    committed = np.zeros(n_f, dtype=bool)
    for f, ((com, dets, car, ob), prob) in enumerate(sorted(merged.items())):
        checks[list(dets), f] = 1
        priors[f] = prob
        committed[f] = com
        if car:
            carry[list(car), f] = 1
        for j in range(k):
            obs[j, f] = (ob >> j) & 1
    return WindowCircuitTanner(checks=checks, priors=priors, obs=obs,
                               carry=carry, committed=committed)


def circuit_bp_decoder(code, rounds: int, noise, *, sector: str = "z",
                       iters: int = 64, alpha: float = 0.8,
                       osd: bool = True, hz=None, hx=None, **bp_kwargs):
    """BPDecoder over the circuit-level Tanner graph; `decode_obs` maps
    `[B, (rounds+1)*r_c]` flattened detector histories to `[B, k]`
    observable flips. Extra keyword arguments (gamma, restarts,
    osd_order, ...) pass through to `BPDecoder` — the depth knobs."""
    from qcss_tpu_torch.decode.bp import BPDecoder

    tan = build_circuit_tanner(code, rounds, noise, sector=sector,
                               hz=hz, hx=hx)
    return BPDecoder(tan.checks, np.clip(tan.priors, 1e-12, 0.499),
                     logicals=tan.obs, iters=iters, alpha=alpha, osd=osd,
                     **bp_kwargs)
