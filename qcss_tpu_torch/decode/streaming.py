"""Sliding-window (streaming) decoding for unbounded-round memory (PyTorch
port of `qcss_tpu.decode.streaming`).

Whole-history decoding needs the full (R+1)·r detector record and a
matching graph that grows with R. The forward sliding window (Dennis et
al. 2002 §IV-C; arXiv:2209.08552) bounds both: decode W consecutive
detector slices, COMMIT only the first C slices' correction edges, cut
each matched chain at the commit boundary by toggling an artificial defect
at the crossing point, then slide forward by C rounds and repeat. Memory
and per-round work are O(W·r) regardless of R.

The window graphs set ``edge_qubit = arange(E)`` and ``n_qubits = E`` (a
host decoder's per-"qubit" correction output is then the selected-edge
indicator vector); the device decoder reads only edges, weights and labels.

Here: the window matching graph (`_window_graph`, numpy), the
long-horizon phenomenological sampler, and `StreamingDecoder`, which
decodes each window on the host with the union-find decoder (`UFDecoder`,
the JAX package's text). The device decoder over the same windows is
`device_streaming.DeviceStreamingDecoder`.
"""

from __future__ import annotations

import numpy as np
import torch

from qcss_tpu_torch.decode.uf import (
    MatchingGraph,
    UFDecoder,
    graph_from_checks,
    weights_from_probs,
)
from qcss_tpu_torch.ops import gf2_torch


def _window_graph(h, logicals, slices: int, open_future: bool,
                  p_space: float | None, p_time: float | None):
    """Matching graph over `slices` detector slices with edge_qubit
    re-purposed as the edge's own index (see module docstring). Returns
    (graph, edge_meta) with edge_meta rows (kind, slice, check) where
    kind 0 = space edge (slice = its detector slice), 1 = time edge
    (slice t joins slices t and t+1, check = detector column),
    2 = open-future boundary edge (slice = slices-1)."""
    base = graph_from_checks(h, logicals)
    r = base.num_nodes
    edges, eobs, meta, probs = [], [], [], []
    for t in range(slices):
        off = t * r
        for (a, b), o in zip(base.edges, base.edge_obs):
            edges.append((off + a, -1 if b < 0 else off + b))
            eobs.append(int(o))
            meta.append((0, t, -1))
            probs.append(p_space)
    for t in range(slices - 1):
        for c in range(r):
            edges.append((t * r + c, (t + 1) * r + c))
            eobs.append(0)
            meta.append((1, t, c))
            probs.append(p_time)
    if open_future:
        for c in range(r):
            # a chain may exit into the unseen future at measurement-error
            # pace; it will be re-decoded with full context next window
            edges.append(((slices - 1) * r + c, -1))
            eobs.append(0)
            meta.append((2, slices - 1, c))
            probs.append(p_time)
    n_e = len(edges)
    weight = None
    if p_space is not None or p_time is not None:
        if p_space is None or p_time is None:
            raise ValueError("pass both p_space and p_time, or neither")
        weight = weights_from_probs(probs)
    graph = MatchingGraph(
        num_nodes=slices * r,
        edges=np.asarray(edges, dtype=np.int32).reshape(-1, 2),
        edge_qubit=np.arange(n_e, dtype=np.int32),  # edge-indicator trick
        edge_obs=np.asarray(eobs, dtype=np.uint32),
        n_qubits=n_e,
        edge_weight=weight,
    )
    return graph, np.asarray(meta, dtype=np.int32)


def phenomenological_rounds(generator, cum, prev_syn, m: int, p, q, h):
    """``m`` rounds of phenomenological noise on the generator's device:
    per round an IID data-X layer at rate p XORed into ``cum`` [B, n], then
    the syndrome with measurement flips at rate q. Per round the generator
    is drawn in the order data layer [B, n], measurement flips [B, r].
    Returns (cum, last syndrome [B, r], detectors [B, m, r] uint8)."""
    B, n = cum.shape
    r = h.shape[0]
    dets = []
    for _ in range(m):
        cum = cum ^ (torch.rand((B, n), generator=generator,
                                device=cum.device) < p).to(torch.uint8)
        syn = gf2_torch.syndromes_dense(cum, h) ^ (
            torch.rand((B, r), generator=generator, device=cum.device) < q
        ).to(torch.uint8)
        dets.append(syn ^ prev_syn)
        prev_syn = syn
    return cum, prev_syn, torch.stack(dets, dim=1)


def sample_phenomenological_stream(generator: torch.Generator, p, q,
                                   batch: int, rounds: int, h, lz):
    """Long-horizon phenomenological sampler on the generator's device:
    IID data-X layers, measurement flips, perfect final readout. Returns
    (detectors [B, R+1, r] uint8, logical parities [B, k] uint8)."""
    device = generator.device
    h = torch.as_tensor(np.asarray(h, np.uint8) & 1, device=device)
    lz = torch.as_tensor(np.asarray(lz, np.uint8) & 1, device=device)
    r, n = h.shape
    cum = torch.zeros((batch, n), dtype=torch.uint8, device=device)
    syn0 = torch.zeros((batch, r), dtype=torch.uint8, device=device)
    cum, last_syn, dets = phenomenological_rounds(generator, cum, syn0,
                                                  rounds, p, q, h)
    cum = cum ^ (torch.rand((batch, n), generator=generator, device=device)
                 < p).to(torch.uint8)
    final = gf2_torch.syndromes_dense(cum, h) ^ last_syn
    detectors = torch.cat([dets, final[:, None, :]], dim=1)
    return detectors, gf2_torch.mod2_matmul(cum, lz.T)


class StreamingDecoder:
    """Forward sliding-window decoder over an r-detector stream.

    `decode_stream(dets)` takes `[B, S, r]` detection events (S slices,
    the last produced by perfect readout, exactly as
    `uf.spacetime_graph` consumes them) and returns `[B]` uint32
    observable-flip bitmasks. Equivalent in contract to whole-history
    `UFDecoder(spacetime_graph(...)).decode_batch`, but with O(window·r)
    state — S can be arbitrarily large.

    window: slices decoded per step (>= 2*commit recommended);
    commit: slices committed (and advanced) per step.
    """

    def __init__(self, h, logicals, *, window: int = 6, commit: int = 3,
                 p_space: float | None = None, p_time: float | None = None,
                 use_native: bool | None = None, n_threads: int | None = None):
        if commit < 1 or window <= commit:
            raise ValueError("need window > commit >= 1")
        self.h = np.asarray(h, dtype=np.uint8) & 1
        self.r = self.h.shape[0]
        self.window = window
        self.commit = commit
        self.n_threads = n_threads
        self._probs = (p_space, p_time)
        self._logicals = np.asarray(logicals, dtype=np.uint8) & 1
        g, meta = _window_graph(self.h, self._logicals, window, True,
                                p_space, p_time)
        self._mid = (UFDecoder(g, use_native=use_native), meta, g)
        self._use_native = use_native
        self._final: dict[int, tuple] = {}

    def _final_decoder(self, slices: int):
        cached = self._final.get(slices)
        if cached is None:
            g, meta = _window_graph(self.h, self._logicals, slices, False,
                                    *self._probs)
            cached = (UFDecoder(g, use_native=self._use_native), meta, g)
            self._final[slices] = cached
        return cached

    def decode_stream(self, dets: np.ndarray) -> np.ndarray:
        dets = np.ascontiguousarray(np.asarray(dets), dtype=np.uint8)
        B, S, r = dets.shape
        if r != self.r:
            raise ValueError(f"stream has {r} detectors/slice, graph has {self.r}")
        W, C = self.window, self.commit
        obs = np.zeros(B, dtype=np.uint32)
        carry = np.zeros((B, r), dtype=np.uint8)
        s0 = 0
        while True:
            remaining = S - s0
            final = remaining <= W
            slices = remaining if final else W
            dec, meta, g = (
                self._final_decoder(slices) if final else self._mid
            )
            win = dets[:, s0:s0 + slices, :].copy()
            win[:, 0, :] ^= carry
            sel, o = dec.decode_batch(
                win.reshape(B, slices * r), n_threads=self.n_threads)
            if final:
                obs ^= o
                break
            # commit rule over selected edges (sel is [B, E] indicators)
            kind, sl, chk = meta[:, 0], meta[:, 1], meta[:, 2]
            committed = (
                ((kind == 0) & (sl < C))        # space edges in commit region
                | ((kind == 1) & (sl + 1 < C))  # time edges fully inside
            )
            crossing = (kind == 1) & (sl == C - 1)  # cut points
            obs_masks = np.asarray(g.edge_obs, dtype=np.uint32)
            # obs parity of committed edges (time edges carry obs 0 anyway)
            contrib = sel[:, committed].astype(np.uint32) * obs_masks[committed]
            obs ^= np.bitwise_xor.reduce(contrib, axis=1)
            carry = np.zeros((B, r), dtype=np.uint8)
            cross_idx = np.nonzero(crossing)[0]
            carry[:, chk[cross_idx]] ^= sel[:, cross_idx]
            s0 += C
        return obs
