"""Parallel-window decoding — every window of a long memory in O(1)
launches (PyTorch port of `qcss_tpu.decode.parallel_window`).

The forward sliding window (`decode.streaming`, `decode.device_streaming`)
is inherently SEQUENTIAL: window k+1's defects depend on window k's
committed corrections (the carry toggles), so an R-round memory costs
R/C dependent device round-trips — the decoder's latency grows linearly
in R even though each window is embarrassingly batch-parallel.

Parallel-window decoding (Skoric et al., Nat. Commun. 14, 7040 (2023),
arXiv:2209.08552; also Tan et al., arXiv:2209.09219) removes the
sequential chain with a two-layer commit schedule:

* **Layer A** — K non-overlapping "core" regions of `core` slices,
  separated by `buf`-slice seams. Window k decodes its core plus the
  adjacent seams (open time boundaries on both sides — a chain may exit
  toward a neighbour's core and be re-decoded there) and commits ONLY
  the core. All K windows are INDEPENDENT: the interior ones fold into
  the batch axis and decode in ONE device union-find call.
* **Layer B** — the K-1 seams. A committed chain that crossed a core
  boundary toggles an artificial defect on the seam side (the same
  commit rule the forward decoder applies at its single boundary, here
  applied at both core boundaries). Every seam's defect record is then
  fully determined, its time boundaries are CLOSED (both neighbours
  committed right up to its edges), and all K-1 seams decode in one
  more batched call.

Total: at most four window shapes (first, interior, last, seam), each one
`decode_labels` call over its whole batch, for ANY number of rounds —
decode latency is O(1) in R instead of O(R). On the card each call is one
launch of the stencil kernel (`device_uf_cuda.stencil_full`), with no
host read between them: the convergence flags are folded on the device
and read once. Commit-rule outputs ride the union-find's label lanes as
in `device_streaming`: lane 0 is the committed-region observable, and
each core-boundary crossing carries ``1 << check`` on ceil(r/30) carry
lanes per side, spilled into chunk planes beside the packed word.

Accuracy (the JAX package's measurement, d=5 surface, identical shots):
at p=q=0.004, R=40, buf=8 (~1.5d) reaches 99.5% whole-history agreement
and failure-rate parity; near threshold a small excess remains, since
layer-A windows decide with OPEN boundaries on both sides — the price of
the O(1) latency, inherent to the published scheme.

`_pw_graph` is the JAX package's text.
"""

from __future__ import annotations

import numpy as np
import torch

from qcss_tpu_torch._cuda import resolve_device
from qcss_tpu_torch.decode.device_uf import build_device_graph, decode_labels
from qcss_tpu_torch.decode.uf import (
    MatchingGraph,
    graph_from_checks,
    weights_from_probs,
)
from qcss_tpu_torch.ops.gf2_torch import xor_reduce


def _pw_graph(h, logicals, slices: int, *, open_past: bool,
              open_future: bool, commit_lo: int, commit_hi: int,
              p_space, p_time):
    """Spacetime window graph with a two-sided commit rule.

    Returns (graph, left_check, right_check): the graph's `edge_obs`
    holds the observable bit of space edges inside the commit region
    [commit_lo, commit_hi) only; `left_check[e]` is the detector column
    of a time edge crossing the LEFT commit boundary (slice
    commit_lo-1 -> commit_lo; toggle lands on slice commit_lo-1, the
    uncommitted side), -1 elsewhere; `right_check` likewise for the
    right boundary (toggle lands on slice commit_hi)."""
    base = graph_from_checks(h, logicals)
    r = base.num_nodes
    edges, eobs, lchk, rchk, probs = [], [], [], [], []
    for t in range(slices):
        off = t * r
        committed = commit_lo <= t < commit_hi
        for (a, b), o in zip(base.edges, base.edge_obs):
            edges.append((off + a, -1 if b < 0 else off + b))
            eobs.append(int(o) if committed else 0)
            lchk.append(-1)
            rchk.append(-1)
            probs.append(p_space)
    for t in range(slices - 1):
        for c in range(r):
            edges.append((t * r + c, (t + 1) * r + c))
            eobs.append(0)
            lchk.append(c if (commit_lo > 0 and t == commit_lo - 1) else -1)
            rchk.append(c if (commit_hi < slices and t == commit_hi - 1)
                        else -1)
            probs.append(p_time)
    if open_past:
        for c in range(r):
            edges.append((c, -1))
            eobs.append(0)
            lchk.append(-1)
            rchk.append(-1)
            probs.append(p_time)
    if open_future:
        for c in range(r):
            edges.append(((slices - 1) * r + c, -1))
            eobs.append(0)
            lchk.append(-1)
            rchk.append(-1)
            probs.append(p_time)
    weight = None
    if p_space is not None or p_time is not None:
        if p_space is None or p_time is None:
            raise ValueError("pass both p_space and p_time, or neither")
        weight = weights_from_probs(probs)
    n_e = len(edges)
    graph = MatchingGraph(
        num_nodes=slices * r,
        edges=np.asarray(edges, dtype=np.int32).reshape(-1, 2),
        edge_qubit=np.arange(n_e, dtype=np.int32),
        edge_obs=np.asarray(eobs, dtype=np.uint32),
        n_qubits=n_e,
        edge_weight=weight,
    )
    return (graph, np.asarray(lchk, dtype=np.int32),
            np.asarray(rchk, dtype=np.int32))


class ParallelWindowDecoder:
    """Two-layer parallel-window decoder over an r-detector stream.

    Same contract as `StreamingDecoder.decode_stream`: `decode_stream`
    takes `[B, S, r]` detection events (last slice from perfect
    readout) and returns `[B]` uint32 observable-flip masks —
    restricted to single-observable matchable codes whose matching
    graph has at least one space boundary edge (a closed code's seam
    could strand odd defect parity in a closed seam graph). The window
    graphs' tensors live on ``device`` (the card by default).

    core: slices committed by each layer-A window;
    buf:  seam width between cores (also each A window's one-sided
          lookahead) — buf >= d recovers whole-history accuracy.
    """

    def __init__(self, h, logicals, *, core: int = 3, buf: int = 3,
                 p_space: float | None = None, p_time: float | None = None,
                 device="cuda"):
        if core < 1 or buf < 1:
            raise ValueError("need core >= 1 and buf >= 1")
        self.device = resolve_device(device)
        self.h = np.asarray(h, dtype=np.uint8) & 1
        self.r = self.h.shape[0]
        self.core, self.buf = core, buf
        self._probs = (p_space, p_time)
        self._logicals = np.asarray(logicals, dtype=np.uint8) & 1
        if self._logicals.shape[0] != 1:
            raise ValueError("parallel windows support one observable")
        base = graph_from_checks(self.h, self._logicals)
        if not np.any(base.edges < 0):
            raise ValueError(
                "matching graph has no space boundary edges; closed-code "
                "seams can strand odd defect parity — use the forward "
                "StreamingDecoder instead")
        self._n_carry = -(-self.r // 30)
        c, b = core, buf
        # Layer-B windows extend `ext` slices into each neighbouring
        # committed core: the extension region's residual defects are
        # zero, but seam chains may ROUTE through it (to the space
        # boundary, or around a toggle) — without it, a chain crossing
        # the whole seam is forced into a short closed box and the
        # decode degrades. Extensions of adjacent seams stay disjoint
        # (ext <= core // 2) so every edge is committed by EXACTLY one
        # window and the global correction is a plain XOR of window
        # corrections.
        self._ext = ext = min(b, c // 2)
        self._first = self._build(c + b, open_past=False, open_future=True,
                                  commit_lo=0, commit_hi=c)
        self._mid = self._build(c + 2 * b, open_past=True, open_future=True,
                                commit_lo=b, commit_hi=b + c)
        sb = b + 2 * ext
        self._seam = self._build(sb, open_past=False, open_future=False,
                                 commit_lo=0, commit_hi=sb)
        self._last: dict[int, object] = {}   # keyed by last-core width
        self._whole: dict[int, object] = {}  # K < 2 fallback, keyed by S

    # -- graph construction ------------------------------------------------

    def _carry_lanes(self, check):
        lanes = []
        for li in range(self._n_carry):
            lo, hi = 30 * li, min(30 * (li + 1), self.r)
            in_lane = (check >= lo) & (check < hi)
            lanes.append(np.where(
                in_lane, np.int64(1) << np.maximum(check - lo, 0), 0))
        return lanes

    def _build(self, slices, **kw):
        """The device graph of one window shape, on the decoder's device."""
        g, lchk, rchk = _pw_graph(self.h, self._logicals, slices,
                                  p_space=self._probs[0],
                                  p_time=self._probs[1], **kw)
        lanes = []
        if kw["commit_lo"] > 0:
            lanes.extend(self._carry_lanes(lchk))
        if kw["commit_hi"] < slices:
            lanes.extend(self._carry_lanes(rchk))
        dg = build_device_graph(g, extra_lanes=tuple(lanes),
                                spill_lanes=True)
        return dg.to(self.device)

    def _last_graph(self, core_last: int):
        dg = self._last.get(core_last)
        if dg is None:
            dg = self._build(self.buf + core_last, open_past=True,
                             open_future=False, commit_lo=self.buf,
                             commit_hi=self.buf + core_last)
            self._last[core_last] = dg
        return dg

    def _whole_graph(self, slices: int):
        dg = self._whole.get(slices)
        if dg is None:
            dg = self._build(slices, open_past=False, open_future=False,
                             commit_lo=0, commit_hi=slices)
            self._whole[slices] = dg
        return dg

    def _unpack(self, lanes):
        """ceil(r/30) packed [N] int32 lanes -> [N, r] uint8 toggles."""
        chunks = []
        for li, lab in enumerate(lanes):
            width = min(30 * (li + 1), self.r) - 30 * li
            shifts = torch.arange(width, dtype=torch.int32,
                                  device=lab.device)[None, :]
            chunks.append(((lab[:, None] >> shifts) & 1).to(torch.uint8))
        return torch.cat(chunks, dim=1)

    # -- decoding ----------------------------------------------------------

    def decode_stream(self, dets) -> np.ndarray:
        """[B, S, r] detectors (numpy, or a tensor) -> [B] uint32
        observable-flip masks; raises if a window hit its growth cap."""
        if not isinstance(dets, torch.Tensor):
            dets = torch.as_tensor(np.asarray(dets))
        obs, conv_all = self.decode_tensors(dets.to(self.device))
        if not bool(conv_all):
            raise RuntimeError("growth cap hit")
        return obs.cpu().numpy().astype(np.uint32)

    def decode_tensors(self, dets):
        """The decode on tensors (the JAX package's ``decode_traced``):
        [B, S, r] on the decoder's device -> (obs [B] int32, converged
        bool scalar), both on the device, with no host read — so a caller
        can put it behind a sampler and read the result once
        (`parallel_window_memory_rate`)."""
        dets = dets.to(torch.uint8)
        B, S, r = dets.shape
        if r != self.r:
            raise ValueError(f"stream has {r} detectors/slice, graph {self.r}")
        c, b, nc = self.core, self.buf, self._n_carry
        stride = c + b
        K = (S + b) // stride
        if K < 2:
            (obs,), conv = decode_labels(self._whole_graph(S),
                                         dets.reshape(B, S * r))
            return obs, conv.all()
        core_last = S - (K * c + (K - 1) * b) + c

        # layer A, first window: commits core 0, right carry into seam 0
        lab, cv = decode_labels(self._first, dets[:, :c + b].reshape(B, -1))
        conv_all = cv.all()
        obs = lab[0]
        right = [self._unpack(lab[1:1 + nc])]          # per core k: [B, r]
        left = [None]                                   # core 0 has no left
        # layer A, interior windows: ONE batched call for all K-2
        if K > 2:
            starts = np.arange(1, K - 1) * stride - b
            idx = starts[:, None] + np.arange(c + 2 * b)[None, :]
            win = dets[:, torch.as_tensor(idx, device=dets.device)]
            lab, cv = decode_labels(self._mid, win.reshape(B * (K - 2), -1))
            conv_all = conv_all & cv.all()
            obs = obs ^ xor_reduce(lab[0].reshape(B, K - 2))
            lmid = self._unpack(lab[1:1 + nc]).reshape(B, K - 2, r)
            rmid = self._unpack(lab[1 + nc:1 + 2 * nc]).reshape(B, K - 2, r)
            left.extend(lmid.unbind(1))
            right.extend(rmid.unbind(1))
        # layer A, last window: commits the (possibly wider) last core
        lab, cv = decode_labels(self._last_graph(core_last),
                                dets[:, S - (b + core_last):].reshape(B, -1))
        conv_all = conv_all & cv.all()
        obs = obs ^ lab[0]
        left.append(self._unpack(lab[1:1 + nc]))
        # layer B: all K-1 seams in one batched call, boundaries closed.
        # Window = seam + `ext` slices into each committed neighbour
        # core; the extension's residual defects are zero by commit
        # (A explained them), so only the seam slices carry data and
        # the two boundary toggles.
        ext = self._ext
        sstarts = np.arange(K - 1) * stride + c - ext
        sidx = sstarts[:, None] + np.arange(b + 2 * ext)[None, :]
        seams = dets[:, torch.as_tensor(sidx, device=dets.device)]
        mask = torch.zeros((1, 1, b + 2 * ext, 1), dtype=torch.uint8,
                           device=dets.device)
        mask[:, :, ext:ext + b, :] = 1
        seams = seams * mask                            # [B, K-1, b+2e, r]
        seams[:, :, ext, :] ^= torch.stack(right, dim=1)
        seams[:, :, ext + b - 1, :] ^= torch.stack(left[1:], dim=1)
        lab, cv = decode_labels(self._seam, seams.reshape(B * (K - 1), -1))
        conv_all = conv_all & cv.all()
        obs = obs ^ xor_reduce(lab[0].reshape(B, K - 1))
        return obs, conv_all


def _parallel_window_step(h, logicals, p, q, *, rounds: int, batch: int,
                          core: int, buf: int, weighted: bool, device):
    """`parallel_window_memory_rate`'s pipeline on ``device``:
    ``step(generator)`` samples ``batch`` streams
    (`streaming.sample_phenomenological_stream`), decodes them with
    `ParallelWindowDecoder.decode_tensors` and returns (failures, all
    converged) as device scalars; nothing is read back."""
    from qcss_tpu_torch.decode.streaming import sample_phenomenological_stream

    h = np.asarray(h, np.uint8) & 1
    logicals = np.atleast_2d(np.asarray(logicals, np.uint8) & 1)[:1]
    pw = ParallelWindowDecoder(
        h, logicals, core=core, buf=buf,
        p_space=p if weighted else None, p_time=q if weighted else None,
        device=device)

    def step(gen):
        dets, par = sample_phenomenological_stream(gen, p, q, batch, rounds,
                                                   h, logicals)
        obs, conv = pw.decode_tensors(dets)
        return ((obs & 1).to(torch.uint8) != par[:, 0]).sum(), conv

    return step


def parallel_window_memory_rate(h, logicals, p, q, *, rounds: int,
                                batch: int, core: int, buf: int,
                                seed: int = 0, weighted: bool = True,
                                device="cuda"):
    """Phenomenological memory experiment with the WHOLE pipeline on
    ``device`` (the card by default): the stream sampler
    (`streaming.sample_phenomenological_stream`, a generator seeded with
    ``seed``), every layer-A window, every seam and the failure count,
    with one host read at the end. The parallel-window counterpart of
    `device_streaming.stream_memory_rate`: that one bounds MEMORY
    (O(window) state, sequential windows); this one bounds LATENCY (the
    recorded stream decodes in O(1) launches). Returns
    dict(logical_fail, samples, rounds)."""
    device = resolve_device(device)
    step = _parallel_window_step(h, logicals, p, q, rounds=rounds,
                                 batch=batch, core=core, buf=buf,
                                 weighted=weighted, device=device)
    fail, conv = step(torch.Generator(device=device).manual_seed(seed))
    fails, conv = torch.stack([fail, conv.to(fail.dtype)]).tolist()
    if not conv:
        raise RuntimeError("growth cap hit")
    return {"logical_fail": fails / batch, "samples": batch,
            "rounds": rounds}
