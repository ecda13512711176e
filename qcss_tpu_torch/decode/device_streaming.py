"""Sliding-window decoding on the device — unbounded-round memories, fused
(PyTorch port of `qcss_tpu.decode.device_streaming`).

The window algebra of `decode.streaming` with the decode moved into the
device union-find (`decode.device_uf`), whose label LANES read off exactly
what the commit rule needs without materializing per-edge corrections:

* lane 0 carries each space edge's observable bit ONLY in the commit
  region (slices < C) — its decoded value IS the committed correction's
  observable contribution;
* the carry lanes hold, on each edge crossing the commit boundary (slice
  C-1 -> C, check c), the bit ``1 << c`` — their decoded value IS the
  carry-defect toggle mask for the next window. A code with r checks
  needs ceil(r / 30) carry lanes of up to 30 bits; those that do not fit
  beside the cluster id in the packed word are spilled into chunks, which
  the stencil kernel resolves (`device_uf_cuda.stencil_full`).

The final (closed-future) window decodes the plain observable lane.

`stream_memory_rate` interleaves phenomenological SAMPLING with windowed
decoding — an unbounded-round memory experiment with O(window) state end
to end; `stream_memory_rate_dem` does the same at circuit level (Pauli
frames through the extraction circuit, windows over the exact DEM). Both
run on the card unless asked for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from qcss_tpu_torch._cuda import resolve_device
from qcss_tpu_torch.decode.device_uf import build_device_graph, decode_labels
from qcss_tpu_torch.decode.streaming import (
    _window_graph,
    phenomenological_rounds,
)
from qcss_tpu_torch.ops import gf2_torch


class DeviceStreamingDecoder:
    """Forward sliding-window decoder with device-side window decodes.

    `decode_stream` takes detectors [B, S, r] (the last slice from perfect
    readout) and returns [B] observable-flip masks; single-observable
    codes only. The graphs' tensors live on ``device`` (the card by
    default) and the detectors must too."""

    def __init__(self, h, logicals, *, window: int = 6, commit: int = 3,
                 p_space: float | None = None, p_time: float | None = None,
                 device="cuda"):
        if commit < 1 or window <= commit:
            raise ValueError("need window > commit >= 1")
        self._init_code(h, logicals, window, commit, device)
        probs = (p_space, p_time)
        g, meta = _window_graph(self.h, self._logicals, window, True, *probs)
        kind, sl = meta[:, 0], meta[:, 1]
        committed_obs = np.where(
            (kind == 0) & (sl < commit), g.edge_obs & 1, 0).astype(np.int64)
        carry_check = np.where((kind == 1) & (sl == commit - 1),
                               meta[:, 2], -1).astype(np.int32)
        self._setup(g, committed_obs, carry_check)
        self._final_graph_of = lambda slices: _window_graph(
            self.h, self._logicals, slices, False, *probs)[0]

    @classmethod
    def from_dem(cls, h, logicals, extraction_gates=None, *,
                 window: int = 8, commit: int = 4,
                 p_gate2: float = 0.0, p_meas: float = 0.0,
                 p_reset: float = 0.0, rate2=None, device="cuda"):
        """Circuit-level streaming: sliding windows over the exact
        single-fault DEM of the extraction circuit (diagonal hook edges
        and all — `dem.circuit_level_window_graph`). The commit rule is
        unchanged: crossing edges all land on next-window slice 0, so
        the same carry lanes drive the window stepping."""
        from qcss_tpu_torch.decode.dem import (
            circuit_level_graph,
            circuit_level_window_graph,
        )

        self = object.__new__(cls)
        self._init_code(h, logicals, window, commit, device)
        if extraction_gates is None:
            extraction_gates = [
                (int(j), int(i)) for i in range(self.r)
                for j in np.nonzero(self.h[i])[0]]
        g, committed_obs, carry_check = circuit_level_window_graph(
            self.h, extraction_gates, window, commit,
            p_gate2=p_gate2, p_meas=p_meas, p_reset=p_reset,
            logicals=self._logicals, rate2=rate2)
        self._setup(g, committed_obs.astype(np.int64), carry_check)
        self._final_graph_of = lambda slices: circuit_level_graph(
            self.h, extraction_gates, rounds=slices - 1,
            p_gate2=p_gate2, p_meas=p_meas, p_reset=p_reset,
            logicals=self._logicals, rate2=rate2)
        return self

    def _init_code(self, h, logicals, window, commit, device):
        self.device = resolve_device(device)
        self.h = np.asarray(h, dtype=np.uint8) & 1
        self.r = self.h.shape[0]
        self.window = window
        self.commit = commit
        self._logicals = np.asarray(logicals, dtype=np.uint8) & 1
        if self._logicals.shape[0] != 1:
            raise ValueError("device streaming supports one observable")
        self._final: dict[int, object] = {}

    def _setup(self, g, committed_obs, carry_check):
        """Build the mid-window device graph: lane 0 = committed-region
        obs; carry bits (crossing edges' next-window checks) split across
        ceil(r/30) lanes of <= 30 bits each, spilled to chunk tables when
        they exceed the packed word."""
        self._n_carry = -(-self.r // 30)
        lanes = []
        for li in range(self._n_carry):
            lo, hi = 30 * li, min(30 * (li + 1), self.r)
            in_lane = (carry_check >= lo) & (carry_check < hi)
            lanes.append(np.where(
                in_lane,
                np.int64(1) << np.maximum(carry_check - lo, 0), 0))
        g_committed = g.__class__(
            num_nodes=g.num_nodes, edges=g.edges, edge_qubit=g.edge_qubit,
            edge_obs=committed_obs.astype(np.uint32), n_qubits=g.n_qubits,
            edge_weight=g.edge_weight)
        self._mid = build_device_graph(g_committed, extra_lanes=tuple(lanes),
                                       spill_lanes=True).to(self.device)

    def _final_graph(self, slices: int):
        dg = self._final.get(slices)
        if dg is None:
            dg = build_device_graph(self._final_graph_of(slices)
                                    ).to(self.device)
            self._final[slices] = dg
        return dg

    def _with_carry(self, win, carry):
        """The window's detectors [B, slices * r] with the carry defects
        XORed into slice 0. ``win`` may be a view of a rolling buffer, so
        it is copied, never written."""
        win = win.to(torch.uint8).clone()
        win[:, 0, :] ^= carry
        return win.reshape(win.shape[0], -1)

    def window_step(self, win, carry, obs):
        """One mid-stream window on the device: win [B, W, r], carry
        [B, r] uint8, obs [B] int32 -> (new obs, new carry, converged
        [B])."""
        r = self.r
        labels, conv = decode_labels(self._mid, self._with_carry(win, carry))
        obs = obs ^ labels[0]
        parts = []
        for li in range(self._n_carry):
            width = min(30 * (li + 1), r) - 30 * li
            shifts = torch.arange(width, dtype=torch.int32,
                                  device=obs.device)[None, :]
            parts.append(((labels[1 + li][:, None] >> shifts) & 1
                          ).to(torch.uint8))
        return obs, torch.cat(parts, dim=1), conv

    def final_step(self, win, carry, obs, slices: int):
        """The closing window (``slices`` <= W slices, the last from
        perfect readout): (new obs, converged [B])."""
        (full_obs,), conv = decode_labels(self._final_graph(slices),
                                          self._with_carry(win, carry))
        return obs ^ full_obs, conv

    def decode_stream(self, dets) -> np.ndarray:
        dets = torch.as_tensor(dets).to(self.device)
        B, S, r = dets.shape
        if r != self.r:
            raise ValueError(f"stream has {r} detectors/slice, graph {self.r}")
        W, C = self.window, self.commit
        obs = torch.zeros(B, dtype=torch.int32, device=self.device)
        carry = torch.zeros((B, r), dtype=torch.uint8, device=self.device)
        # convergence is accumulated on the device and read once at the end
        conv_all = torch.ones((), dtype=torch.bool, device=self.device)
        s0 = 0
        while True:
            remaining = S - s0
            if remaining <= W:
                obs, conv = self.final_step(
                    dets[:, s0:s0 + remaining], carry, obs, remaining)
                conv_all = conv_all & conv.all()
                break
            obs, carry, conv = self.window_step(
                dets[:, s0:s0 + W], carry, obs)
            conv_all = conv_all & conv.all()
            s0 += C
        if not bool(conv_all):
            raise RuntimeError("growth cap hit")
        return obs.cpu().numpy().astype(np.uint32)


def _stream_loop(dec, sample_chunk, final_slice, rounds: int, batch: int):
    """The interleaved sample-and-decode loop shared by the two memories.
    ``sample_chunk(m)`` returns the next m rounds' detectors [B, m, r];
    ``final_slice()`` the perfect-readout slice [B, r] (both advance the
    sampler's own state). Returns obs [B] int32; raises if a window did
    not converge (one host read, at the end)."""
    W, C = dec.window, dec.commit
    if rounds < W:
        raise ValueError("need rounds >= window")
    dev = dec.device
    obs = torch.zeros(batch, dtype=torch.int32, device=dev)
    carry = torch.zeros((batch, dec.r), dtype=torch.uint8, device=dev)
    conv_all = torch.ones((), dtype=torch.bool, device=dev)
    buf = sample_chunk(W)  # [B, W, r]
    sampled = W
    while rounds - sampled >= C:
        obs, carry, conv = dec.window_step(buf, carry, obs)
        conv_all = conv_all & conv.all()
        buf = torch.cat([buf[:, C:], sample_chunk(C)], dim=1)
        sampled += C
    # remaining rounds (fewer than C): sample them, then close with the
    # perfect final readout slice
    tail = rounds - sampled
    if tail:
        buf = torch.cat([buf, sample_chunk(tail)], dim=1)
    buf = torch.cat([buf, final_slice()[:, None, :]], dim=1)
    obs, conv = dec.final_step(buf, carry, obs, int(buf.shape[1]))
    if not bool(conv_all & conv.all()):
        raise RuntimeError("growth cap hit")
    return obs


def _result(obs, par, rounds, batch, window, commit):
    fails = int(((obs & 1) ^ par.to(torch.int32)).sum())
    return {
        "logical_fail": fails / batch,
        "rounds": rounds,
        "samples": batch,
        "window": window,
        "commit": commit,
    }


def stream_memory_rate(h, logicals, p, q, *, rounds: int, batch: int,
                       window: int = 8, commit: int = 4, seed: int = 0,
                       weighted: bool = True,
                       device="cuda") -> dict[str, float]:
    """Unbounded-round phenomenological X-memory, sampled AND decoded on
    ``device`` with O(window) state: interleaves `commit`-round sampling
    chunks with sliding-window union-find decodes, so a memory of any
    length never holds more than one window of detectors.

    Physics identical to `streaming.sample_phenomenological_stream` (IID
    data-X layers at rate p per round, measurement flips at rate q,
    perfect final readout). The randomness is a `torch.Generator` on
    ``device`` seeded with ``seed``."""
    device = resolve_device(device)
    dec = DeviceStreamingDecoder(
        h, logicals, window=window, commit=commit,
        p_space=p if weighted else None, p_time=q if weighted else None,
        device=device)
    h_t = torch.as_tensor(dec.h, device=device)
    lz = torch.as_tensor(dec._logicals, device=device)
    r, n = h_t.shape
    gen = torch.Generator(device=device).manual_seed(seed)
    state = {"cum": torch.zeros((batch, n), dtype=torch.uint8, device=device),
             "prev": torch.zeros((batch, r), dtype=torch.uint8,
                                 device=device)}

    def sample_chunk(m):
        state["cum"], state["prev"], dets = phenomenological_rounds(
            gen, state["cum"], state["prev"], m, p, q, h_t)
        return dets

    def final_slice():
        state["cum"] = state["cum"] ^ (
            torch.rand((batch, n), generator=gen, device=device) < p
        ).to(torch.uint8)
        return gf2_torch.syndromes_dense(state["cum"], h_t) ^ state["prev"]

    obs = _stream_loop(dec, sample_chunk, final_slice, rounds, batch)
    par = gf2_torch.mod2_matmul(state["cum"], lz.T)[:, 0]
    return _result(obs, par, rounds, batch, window, commit)


def stream_memory_rate_dem(code, noise, *, rounds: int, batch: int,
                           window: int = 8, commit: int = 4, seed: int = 0,
                           device="cuda") -> dict[str, float]:
    """Unbounded-round CIRCUIT-LEVEL Z-memory, sampled AND decoded on
    ``device`` with O(window) state: Pauli-frame sampling of the real
    extraction circuit (the physics and per-round draw order of
    `experiments.memory._memory_circuit_frames`) interleaved with
    sliding-window decodes on the exact single-fault DEM
    (`DeviceStreamingDecoder.from_dem`). The DEM covers the
    p_gate2/p_meas/p_reset species; idle noise is not modelled by this
    single-sector sampler and raises."""
    from qcss_tpu_torch.decode.dem import extraction_gate_list
    from qcss_tpu_torch.experiments import memory as M
    from qcss_tpu_torch.sim import frame as fr

    if noise.p_idle:
        raise ValueError("stream_memory_rate_dem's single-sector sampler "
                         "does not model idle noise")
    device = resolve_device(device)
    raw = np.asarray(code.raw_parity_check_c2, np.uint8) & 1
    lz = torch.as_tensor(np.asarray(code.z_operator_matrix(), np.uint8) & 1,
                         device=device)
    r = raw.shape[0]
    n = code.n
    dec = DeviceStreamingDecoder.from_dem(
        raw, code.z_operator_matrix(), extraction_gate_list(code, raw),
        window=window, commit=commit, p_gate2=noise.p_gate2,
        p_meas=noise.p_meas, p_reset=noise.p_reset, rate2=noise.pauli2,
        device=device)
    ext = M.z_extraction_circuit(code, checks=raw).to_arrays()
    comp = fr.maybe_compile(ext, n + r)
    if comp is not None:
        comp = comp.to(device)
    anc = torch.arange(n, n + r, device=device)
    data = torch.arange(n, device=device)
    raw_t = torch.as_tensor(raw, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = {"f": fr.zero_frames(batch, n + r, device),
             "prev": torch.zeros((batch, r), dtype=torch.uint8,
                                 device=device)}

    def sample_chunk(m):
        f, prev = state["f"], state["prev"]
        dets = []
        for _ in range(m):
            if comp is not None:
                f = fr.run_compiled_noisy(f, comp, noise, gen)
            else:
                f = fr.run_arrays_noisy(f, *ext, noise, gen)
            f, syn = fr.measure_deviations(f, anc, gen, noise.p_meas)
            f = fr.reset_qubits(f, anc, gen, noise.p_reset)
            dets.append(syn ^ prev)
            prev = syn
        state["f"], state["prev"] = f, prev
        return torch.stack(dets, dim=1)  # [B, m, r]

    def final_slice():
        # perfect final readout of the data deviations
        _, state["word"] = fr.measure_deviations(state["f"], data)
        return gf2_torch.syndromes_dense(state["word"], raw_t) ^ state["prev"]

    obs = _stream_loop(dec, sample_chunk, final_slice, rounds, batch)
    par = gf2_torch.mod2_matmul(state["word"], lz.T)[:, 0]
    return _result(obs, par, rounds, batch, window, commit)
