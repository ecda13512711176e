"""Logical resource estimation — what does running this program COST?

Composes the three quantities the rest of the round-3 stack measures
into one deployment report:

  * the compiled program's static footprint (`program_stats`): grid
    qubits, phases, extraction rounds, fault locations, spacetime
    volume, op census — all read off the `LogicalProgram` /
    `ScheduleModel` pair, so the numbers ARE the model that gets
    decoded, not an independent formula;
  * the measured failure-vs-distance law (`fit_suppression`): word
    failure at two or more distances fits the standard exponential
    ansatz fail(d) ~ A / Lambda^((d+1)/2), giving the suppression
    factor per distance step the surface-code literature calls Λ;
  * the magic-state factory economics (`experiments.injection.
    factory_report`): measured injection ε → distillation cascade →
    injections consumed per delivered T state.

`logical_resource_report` ties them together: Monte-Carlo (or accept
pre-measured) word-failure points, fit Λ, solve for the distance d*
meeting a target per-run failure budget, and price the program at d* —
physical qubits, rounds, spacetime volume, T states, raw injections.

The scaling ansatz is an EXTRAPOLATION and is labeled as such in the
output (`fit`): production sizing should re-measure at d* when
feasible (the device-UF pipeline makes that cheap for moderate d).

The reference has no resource machinery at all — no multi-qubit
logical layer exists there to estimate (reference: ftqc.py:42-120
runs one code block; css_code.py:433-434 stubs universality).
"""

from __future__ import annotations

import math
from collections import Counter

from qcss_tpu_torch.experiments.logical import LogicalProgram


def program_stats(prog: LogicalProgram) -> dict:
    """Static accounting of a (finalized or not) logical program.

    Everything is read from the compiled schedule, so `fault_locations`
    counts exactly the fault variables the decoder models and
    `spacetime_volume` is grid-qubits x extraction-rounds of the real
    emitted phases (the final transversal readout is not an extraction
    round; its faults are in the fault count already).
    """
    model = prog.build()
    total_rounds = sum(ph.rounds for ph in prog._phases)
    ops = Counter(op[0] for op in prog._op_log)
    return {
        "d": prog.d,
        "n_data": prog.n_data,
        "grid_qubits": prog.n,
        "n_phases": len(prog._phases),
        "rounds_per_phase": prog.R,
        "total_rounds": total_rounds,
        "spacetime_volume": prog.n * total_rounds,
        "fault_locations": int(model.F.shape[1]),
        "detectors": int(model.F.shape[0]),
        "observables": int(model.obs.shape[0]),
        "op_counts": dict(ops),
        "t_count": ops.get("t", 0),
    }


def fit_suppression(fails: dict[int, float]) -> dict:
    """Fit fail(d) = A / Lambda^((d+1)/2) to measured word-failure
    points keyed by distance (>= 2 points, all > 0).

    Least-squares in log space over the half-distance axis
    x = (d+1)/2, so `Lambda` is the conventional suppression factor
    per d -> d+2 step. Returns {Lambda, A, points}.
    """
    pts = {int(d): float(f) for d, f in fails.items()}
    if len(pts) < 2:
        raise ValueError("need >= 2 distances to fit Lambda")
    bad = [d for d, f in pts.items() if not 0.0 < f < 1.0]
    if bad:
        raise ValueError(
            f"failure rates at d={bad} are not in (0, 1) — raise the "
            "shot budget (a zero count cannot anchor a log fit)")
    xs = [(d + 1) / 2 for d in pts]
    ys = [math.log(f) for f in pts.values()]
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    sxy = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
    slope = sxy / sxx
    lam = math.exp(-slope)
    log_a = my - slope * mx
    return {"Lambda": lam, "A": math.exp(log_a), "points": pts}


def required_distance(target: float, fit: dict) -> int:
    """Smallest odd d with fitted fail(d) <= target (capped at 101)."""
    if not 0.0 < target < 1.0:
        raise ValueError("target must be in (0, 1)")
    lam, a = fit["Lambda"], fit["A"]
    if lam <= 1.0:
        raise ValueError(
            f"fitted Lambda={lam:.3f} <= 1: below threshold at this "
            "physical rate — no distance reaches the target")
    for d in range(3, 103, 2):
        # relative slack: a fitted point sitting exactly ON the target
        # must count as met despite float round-trip error in exp/log
        if a * lam ** (-(d + 1) / 2) <= target * (1 + 1e-9):
            return d
    raise ValueError("target needs d > 101; check the budget")


def logical_resource_report(
    make_prog,
    p: float,
    q: float | None = None,
    *,
    target: float,
    distances: tuple[int, ...] = (3, 5),
    fails: dict[int, float] | None = None,
    batch: int = 1 << 13,
    seed: int = 0,
    decoder: str = "host",
    factory: dict | None = None,
) -> dict:
    """Price a logical program at the distance meeting a failure budget.

    make_prog: callable d -> finalized-or-not LogicalProgram (the
        program is rebuilt at each measured distance and at d*).
    p, q: physical data / measurement fault rates for the MC points.
    target: per-run word-failure budget to size d* for.
    fails: pre-measured {d: word_fail} — skips the Monte-Carlo.
    factory: an `injection.factory_report` dict; when given, the
        report prices the program's T count in raw injection attempts
        and checks the factory's delivered p_out against the per-T
        share of the budget.

    Returns {fit, d_star, at_d_star: program_stats(d*), mc: the
    measured points (rate, fail count, shots), magic: factory math}.
    """
    mc = {}
    if fails is None:
        fails = {}
        for d in distances:
            out = make_prog(d).run(p, q, batch=batch, seed=seed,
                                   decoder=decoder)
            fails[d] = out["word_fail"]
            mc[d] = {"word_fail": out["word_fail"], "shots": batch}
    fit = fit_suppression(fails)
    d_star = required_distance(target, fit)
    prog_star = make_prog(d_star)
    stats = program_stats(prog_star)
    report = {
        "p": p, "q": p if q is None else q, "target": target,
        "fit": fit, "mc": mc,
        "d_star": d_star,
        "at_d_star": stats,
        "predicted_word_fail":
            fit["A"] * fit["Lambda"] ** (-(d_star + 1) / 2),
    }
    t_count = stats["t_count"]
    if factory is not None and t_count:
        per_t_budget = target / max(len(prog_star._op_log), 1)
        report["magic"] = {
            "t_count": t_count,
            "p_out": factory["p_out"],
            "injections_per_state": factory["injections_per_state"],
            "total_injections":
                t_count * factory["injections_per_state"],
            "per_t_budget": per_t_budget,
            "factory_meets_budget": factory["p_out"] <= per_t_budget,
        }
    return report
