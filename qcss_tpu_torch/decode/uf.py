"""Union-find matching graphs: the host graph layer of `qcss_tpu.decode.uf`.

Graph model: each detector is a node; each elementary fault is an edge
between the (at most two) detectors it flips, with the boundary as a
virtual node for single-detector faults. `edge_qubit` maps an edge back to
the data qubit it corrects (-1 for measurement-error edges), `edge_obs` is
a bitmask of logical observables the fault flips.

The definitions below are copied verbatim from the JAX package. Its host
decoders (`UFDecoder` over the C++ kernel, the pure-Python oracle) and
samplers are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class MatchingGraph:
    """A decoding graph. ``edges`` is [E, 2] int32 (-1 = boundary),
    ``edge_qubit`` [E] int32 (-1 = no data qubit), ``edge_obs`` [E] uint32
    observable bitmasks, ``edge_weight`` [E] uint8 growth halves to
    saturation (2 everywhere = unweighted; ~ -log fault probability when
    weighted, see `weights_from_probs`)."""

    num_nodes: int
    edges: np.ndarray
    edge_qubit: np.ndarray
    edge_obs: np.ndarray
    n_qubits: int
    edge_weight: np.ndarray | None = None

    def __post_init__(self):
        object.__setattr__(self, "edges", np.ascontiguousarray(self.edges, np.int32))
        object.__setattr__(
            self, "edge_qubit", np.ascontiguousarray(self.edge_qubit, np.int32)
        )
        object.__setattr__(
            self, "edge_obs", np.ascontiguousarray(self.edge_obs, np.uint32)
        )
        w = self.edge_weight
        if w is None:
            w = np.full(self.edges.shape[0], 2, dtype=np.uint8)
        object.__setattr__(
            self, "edge_weight", np.ascontiguousarray(w, np.uint8)
        )

    @property
    def num_edges(self) -> int:
        return self.edges.shape[0]


def weights_from_probs(probs) -> np.ndarray:
    """Integer growth weights from per-edge fault probabilities:
    w_e = max(2, round(2 * ln(p_e) / ln(p_max))) — the most likely edge
    gets weight 2 (one half per endpoint per round, the unweighted pace),
    less likely edges proportionally more; clamped to 250 (uint8
    support counters)."""
    probs = np.asarray(probs, dtype=np.float64)
    if np.any(probs <= 0) or np.any(probs >= 1):
        raise ValueError("edge probabilities must lie in (0, 1)")
    base = np.log(probs.max())
    w = np.rint(2.0 * np.log(probs) / base)
    return np.clip(w, 2, 250).astype(np.uint8)


def _column_obs_masks(logicals: np.ndarray) -> np.ndarray:
    """obs[j] = bitmask over logical rows containing qubit j."""
    k, n = logicals.shape
    if k > 32:
        raise ValueError("at most 32 logical observables supported")
    masks = np.zeros(n, dtype=np.uint32)
    for i in range(k):
        masks |= (logicals[i].astype(np.uint32)) << i
    return masks


def graph_from_checks(h: np.ndarray, logicals: np.ndarray) -> MatchingGraph:
    """Code-capacity matching graph: one edge per data qubit, connecting the
    (at most two) checks it participates in. Raises for non-matchable codes
    (some qubit in more than two checks, e.g. Steane — use the LUT path for
    those)."""
    h = np.asarray(h, dtype=np.uint8) & 1
    r, n = h.shape
    obs = _column_obs_masks(np.asarray(logicals, dtype=np.uint8) & 1)
    edges, equbit, eobs = [], [], []
    for j in range(n):
        checks = np.nonzero(h[:, j])[0]
        if checks.size > 2:
            raise ValueError(
                f"qubit {j} participates in {checks.size} checks; "
                "not a matchable code"
            )
        if checks.size == 0:
            continue  # undetectable fault: no edge can decode it
        a = int(checks[0])
        b = int(checks[1]) if checks.size == 2 else -1
        edges.append((a, b))
        equbit.append(j)
        eobs.append(int(obs[j]))
    return MatchingGraph(
        num_nodes=r,
        edges=np.asarray(edges, dtype=np.int32).reshape(-1, 2),
        edge_qubit=np.asarray(equbit, dtype=np.int32),
        edge_obs=np.asarray(eobs, dtype=np.uint32),
        n_qubits=n,
    )


def spacetime_graph(h: np.ndarray, logicals: np.ndarray, rounds: int,
                    p_space: float | None = None,
                    p_time: float | None = None) -> MatchingGraph:
    """Phenomenological spacetime graph for an R-round memory experiment
    with a final perfect readout: R+1 detector slices (slice t holds the
    detection events syn[t] ^ syn[t-1]; slice R comes from the perfect
    final-word syndrome), space edges per slice (data errors arising in
    that round), and time edges between consecutive slices t, t+1 for
    t < R (measurement errors in round t).

    With ``p_space``/``p_time`` (per-round data-error and measurement-flip
    probabilities), edges carry -log-likelihood growth weights
    (`weights_from_probs`), so e.g. accurate measurements make the decoder
    reluctant to blame time edges. Both default to None = unweighted."""
    base = graph_from_checks(h, logicals)
    r = base.num_nodes
    slices = rounds + 1
    edges, equbit, eobs = [], [], []
    for t in range(slices):
        off = t * r
        for (a, b), q, o in zip(base.edges, base.edge_qubit, base.edge_obs):
            edges.append((off + a, -1 if b < 0 else off + b))
            equbit.append(int(q))
            eobs.append(int(o))
    n_space = len(edges)
    for t in range(rounds):
        for c in range(r):
            edges.append((t * r + c, (t + 1) * r + c))
            equbit.append(-1)
            eobs.append(0)
    weight = None
    if p_space is not None or p_time is not None:
        if p_space is None or p_time is None:
            raise ValueError("pass both p_space and p_time, or neither")
        probs = np.concatenate([
            np.full(n_space, p_space),
            np.full(len(edges) - n_space, p_time),
        ])
        weight = weights_from_probs(probs)
    return MatchingGraph(
        num_nodes=slices * r,
        edges=np.asarray(edges, dtype=np.int32).reshape(-1, 2),
        edge_qubit=np.asarray(equbit, dtype=np.int32),
        edge_obs=np.asarray(eobs, dtype=np.uint32),
        n_qubits=base.n_qubits,
        edge_weight=weight,
    )
