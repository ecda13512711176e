"""Sliding-window BP streaming — unbounded-round qLDPC memories with
O(window) decoder state.

`decode.streaming` / `decode.device_streaming` give the surface code
O(window) forward decoding; this is the qLDPC counterpart on Tanner
graphs. It is structurally SIMPLER than the matching version: detectors
are local in error INCREMENTS (D[t] = H·e_t ^ m_t ^ m_{t-1}), so the only
state crossing a window boundary is the committed measurement-flip layer
m_{C-1} (XORed out of the next window's first slice) and the running
observable parity of committed data layers — no carry defects, no border
components.

Each step decodes `window` slices with BP(+OSD), commits the first
`commit` data+measurement layers (the rest is lookahead, re-decoded with
the next window), and slides. The tail decodes on the closed spacetime
Tanner graph (perfect final readout). Window decodes reuse ONE compiled
BP kernel for every mid-stream position.

The reference decodes one noisy extraction at a time with no temporal
model at all (reference: css_code.py:649-685)."""

from __future__ import annotations

import numpy as np

from qcss_tpu_torch.decode.bp import BPDecoder, open_window_tanner, spacetime_tanner
from qcss_tpu_torch.decode.bp_dem import (
    circuit_bp_decoder,
    open_window_circuit_tanner,
)


class BPStreamingDecoder:
    """Forward sliding-window BP decoder over an r-check detector stream.

    `decode_stream(dets)` takes [B, S, r] detection events (the last
    slice from perfect readout, exactly as `streaming.StreamingDecoder`
    consumes them) and returns ([B, k] observable flips, [B] bool
    all-windows-BP-converged). Equivalent in contract to whole-history
    `BPDecoder(spacetime_tanner(...))`, with O(window·r) state — S can be
    arbitrarily large.
    """

    def __init__(self, h, logicals, p: float, q: float, *,
                 window: int = 8, commit: int = 4, iters: int = 48,
                 alpha: float = 0.8, osd: bool = True):
        if commit < 1 or window <= commit:
            raise ValueError("need window > commit >= 1")
        self.h = np.asarray(h, dtype=np.uint8) & 1
        self.logicals = np.asarray(logicals, dtype=np.uint8) & 1
        self.r, self.n = self.h.shape
        self.k = self.logicals.shape[0]
        self.window, self.commit = window, commit
        self.p, self.q = float(p), float(q)
        self.iters, self.alpha, self.osd = iters, alpha, osd
        tan, priors = open_window_tanner(self.h, window, p, q)
        self._mid = BPDecoder(tan, priors, iters=iters, alpha=alpha, osd=osd)
        self._final: dict[int, BPDecoder] = {}

    def _final_decoder(self, slices: int) -> BPDecoder:
        dec = self._final.get(slices)
        if dec is None:
            tan, priors, obs, _ = spacetime_tanner(
                self.h, slices - 1, self.p, self.q, logicals=self.logicals)
            dec = BPDecoder(tan, priors, logicals=obs, iters=self.iters,
                            alpha=self.alpha, osd=self.osd)
            self._final[slices] = dec
        return dec

    def _commit_flips(self, e_hat: np.ndarray, layers: int) -> np.ndarray:
        """Observable parity of the first `layers` decoded data layers."""
        b = e_hat.shape[0]
        cum = e_hat[:, : layers * self.n].reshape(b, layers, self.n)
        cum = np.bitwise_xor.reduce(cum, axis=1)
        return (((cum.astype(np.int64) @ self.logicals.T.astype(np.int64))
                 & 1).astype(np.uint8))

    def decode_stream(self, dets) -> tuple[np.ndarray, np.ndarray]:
        dets = np.asarray(dets, np.uint8)
        b, s, r = dets.shape
        if r != self.r:
            raise ValueError(f"stream has {r} checks, decoder built for "
                             f"{self.r}")
        W, C, n = self.window, self.commit, self.n
        flips = np.zeros((b, self.k), np.uint8)
        carry = np.zeros((b, r), np.uint8)  # committed m_{C-1}
        conv_all = np.ones(b, bool)
        s0 = 0
        while s - s0 > W:
            syn = dets[:, s0:s0 + W].reshape(b, W * r).copy()
            syn[:, :r] ^= carry
            e_hat, conv = self._mid.decode_batch(syn)
            conv_all &= conv
            flips ^= self._commit_flips(e_hat, C)
            carry = e_hat[:, W * n + (C - 1) * r: W * n + C * r]
            s0 += C
        rem = s - s0
        syn = dets[:, s0:].reshape(b, rem * r).copy()
        syn[:, :r] ^= carry
        dec = self._final_decoder(rem)
        fl, conv = dec.decode_obs(syn)
        conv_all &= conv
        return flips ^ fl, conv_all


class CircuitBPStreamingDecoder:
    """Sliding-window BP over CIRCUIT-LEVEL detector streams — unbounded
    qLDPC memories under full extraction-circuit noise with O(window)
    decoder state.

    The phenomenological streamer above needs only the committed
    measurement-flip layer as carry; circuit-level faults have multi-layer
    propagated signatures (hooks, resets — up to `dem2._HORIZON` layers),
    so the carry is each committed fault's detector toggles BEYOND the
    commit boundary, XORed out of the next window's already-observed
    region (`bp_dem.open_window_circuit_tanner` tabulates them per fault
    variable). Persistent residual errors need no extra state: their
    measurement-flip train telescopes mid-stream, and the tail window —
    decoded on the TRUE closed graph (`bp_dem.circuit_bp_decoder`) — owns
    every final-perfect-readout event of its own uncommitted rounds.

    `decode_stream(dets)` takes [B, S, r_c] detection events (S = rounds+1
    layers, the last from the perfect final readout — exactly
    `spacetime.detector_history`'s output for one sector) and returns
    ([B, k] observable flips, [B] all-windows-BP-converged). Contract
    equals whole-history `circuit_bp_decoder` with O(window·r_c) state.

    The reference decodes one noisy extraction at a time with no temporal
    or circuit-level model (reference: css_code.py:649-685)."""

    def __init__(self, code, noise, *, sector: str = "z", window: int = 8,
                 commit: int = 4, iters: int = 64, alpha: float = 0.8,
                 osd: bool = True, hz=None, hx=None):
        if commit < 1 or window <= commit:
            raise ValueError("need window > commit >= 1")
        self._args = dict(code=code, noise=noise, sector=sector,
                          hz=hz, hx=hx)
        self.window, self.commit = window, commit
        self.iters, self.alpha, self.osd = iters, alpha, osd
        wt = open_window_circuit_tanner(code, window, commit, noise,
                                        sector=sector, hz=hz, hx=hx)
        self.r = wt.checks.shape[0] // window
        self.k = wt.obs.shape[0]
        self._mid = BPDecoder(wt.checks, np.clip(wt.priors, 1e-12, 0.499),
                              iters=iters, alpha=alpha, osd=osd)
        self._obs_t = (wt.obs & wt.committed[None, :].astype(np.uint8)).T
        self._carry_t = wt.carry.T  # committed-only by construction
        self._final: dict[int, BPDecoder] = {}

    def _final_decoder(self, slices: int) -> BPDecoder:
        dec = self._final.get(slices)
        if dec is None:
            a = self._args
            dec = circuit_bp_decoder(
                a["code"], slices - 1, a["noise"], sector=a["sector"],
                iters=self.iters, alpha=self.alpha, osd=self.osd,
                hz=a["hz"], hx=a["hx"])
            self._final[slices] = dec
        return dec

    def window_step(self, dets_win: np.ndarray,
                    carry: np.ndarray) -> tuple[np.ndarray, np.ndarray,
                                                np.ndarray]:
        """One mid-stream decode: [B, window, r] detector layers + the
        running carry ([B, window*r], aligned to this window's start) ->
        ([B, k] committed flip delta, next carry aligned to start+commit,
        [B] BP-converged)."""
        b = dets_win.shape[0]
        W, C, r = self.window, self.commit, self.r
        syn = dets_win.reshape(b, W * r) ^ carry
        e_hat, conv = self._mid.decode_batch(syn)
        e64 = e_hat.astype(np.int64)
        delta = ((e64 @ self._obs_t) & 1).astype(np.uint8)
        added = ((e64 @ self._carry_t) & 1).astype(np.uint8)
        nxt = np.zeros_like(carry)
        nxt[:, : (W - C) * r] = carry[:, C * r:] ^ added
        return delta, nxt, conv

    def final_step(self, dets_rem: np.ndarray,
                   carry: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Tail decode on the TRUE closed graph: [B, rem, r] remaining
        layers (the last from the perfect final readout) -> ([B, k] flip
        delta, [B] converged)."""
        b, rem, r = dets_rem.shape
        syn = dets_rem.reshape(b, rem * r) ^ carry[:, : rem * r]
        return self._final_decoder(rem).decode_obs(syn)

    def decode_stream(self, dets) -> tuple[np.ndarray, np.ndarray]:
        dets = np.asarray(dets, np.uint8)
        b, s, r = dets.shape
        if r != self.r:
            raise ValueError(f"stream has {r} checks, decoder built for "
                             f"{self.r}")
        W, C = self.window, self.commit
        flips = np.zeros((b, self.k), np.uint8)
        # committed faults' toggles in the not-yet-committed region,
        # aligned to the CURRENT window start
        carry = np.zeros((b, W * r), np.uint8)
        conv_all = np.ones(b, bool)
        s0 = 0
        while s - s0 > W:
            delta, carry, conv = self.window_step(dets[:, s0:s0 + W], carry)
            conv_all &= conv
            flips ^= delta
            s0 += C
        fl, conv = self.final_step(dets[:, s0:], carry)
        conv_all &= conv
        return flips ^ fl, conv_all
