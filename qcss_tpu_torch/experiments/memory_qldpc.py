"""Circuit-level qLDPC memory experiment: BB / hypergraph-product codes
under full extraction-circuit noise, decoded with circuit-level BP(+OSD)
(PyTorch port of `qcss_tpu.experiments.memory_qldpc`).

The schedule and frame sampling are `experiments.memory_xz`'s (both check
sectors extracted every round, one generator drawn in that module's
order), run over the code's FULL redundant check sets. The decoder is
`decode.bp_dem.circuit_bp_decoder`: every fault mechanism of the
extraction circuit is an exact Tanner variable with its propagated
detector signature.

All k logical qubits are scored (word failure = any of the 2k observables
wrong)."""

from __future__ import annotations

import time

import numpy as np
import torch

from qcss_tpu_torch._cuda import resolve_device, synchronize
from qcss_tpu_torch.decode.bp import BPDecoder, use_device
from qcss_tpu_torch.decode.bp_dem import circuit_bp_decoder
from qcss_tpu_torch.decode.spacetime import detector_history
from qcss_tpu_torch.experiments.memory_xz import (
    _extract,
    _idle_data,
    _sample_two_sector,
    two_sector_circuits,
)
from qcss_tpu_torch.ops import gf2_torch
from qcss_tpu_torch.sim import frame as fr
from qcss_tpu_torch.sim import noise as noise_mod


def _checks(code):
    hz = np.asarray(getattr(code, "redundant_parity_check_c2",
                            code.raw_parity_check_c2), np.uint8) & 1
    hx = np.asarray(getattr(code, "redundant_parity_check_c1",
                            code.raw_parity_check_c1), np.uint8) & 1
    return hz, hx


def _fails(flips, par) -> np.ndarray:
    """[B] bool: any observable decoded wrong (tensors or numpy)."""
    wrong = (flips ^ par).any(1)
    if isinstance(wrong, torch.Tensor):
        return wrong.cpu().numpy()
    return np.asarray(wrong)


class _Laps:
    """Wall seconds between marks into ``profile`` (the device
    synchronized at each mark); does nothing without a profile."""

    def __init__(self, profile, device):
        self.profile, self.device = profile, device
        self.t = self._now()

    def _now(self):
        if self.profile is None:
            return 0.0
        synchronize(self.device)
        return time.perf_counter()

    def mark(self, name: str) -> None:
        if self.profile is not None:
            t = self._now()
            self.profile[name] = self.profile.get(name, 0.0) + t - self.t
            self.t = t


def qldpc_memory_experiment(code, *, rounds: int,
                            noise: noise_mod.NoiseModel,
                            batch: int = 1 << 12, seed: int = 0,
                            iters: int = 64, alpha: float = 0.8,
                            osd: bool = True, sectors: str = "both",
                            joint: bool = False, alpha_joint: float = 0.6,
                            correlated: bool = False,
                            gap_tau: float | None = None,
                            bp_kwargs: dict | None = None,
                            device="cuda",
                            profile: dict | None = None) -> dict[str, float]:
    """Run the two-sector circuit-level memory on ``device`` (the card
    unless the caller asks for the CPU), sampled from a generator seeded
    with ``seed``, and decode each sector with circuit-level BP.
    `sectors='z'` decodes X errors only (the Z-basis memory), `'both'`
    adds Z errors and word failure.

    The default path keeps detector assembly, BP, the observable
    reduction and the OSD-0 tail on the device. `joint=True` also decodes
    the stacked two-sector history with one BP over the joint Tanner graph
    (Y-type faults single variables exciting both sectors) and reports
    `*_joint`; `correlated=True` also runs the two-pass version (the
    x-sector decode's priors conditioned on the z-sector pass,
    `bp_dem.two_pass_pair_indices`) and reports `z_fail_corr` /
    `word_fail_corr`; `gap_tau` post-selects the z-sector decode on its
    complementary gap. These, and ``osd='always'``, decode on host arrays.

    ``profile``, a dict, receives the wall seconds of the sampler
    (``sample_s``), the Tanner graphs' build (``build_s``), detector
    assembly (``detectors_s``) and decoding (``decode_s``), and for the
    device path each sector's `BPDecoder.decode_obs_device` stats under
    ``z`` and ``x`` (BP and OSD seconds, iterations, the OSD tail and its
    inputs). The device is synchronized at each mark; no output depends
    on it."""
    device = resolve_device(device)
    hz, hx = _checks(code)
    rz, rx = hz.shape[0], hx.shape[0]
    lz = np.asarray(code.z_operator_matrix(), np.uint8) & 1
    lx = np.asarray(code.x_operator_matrix(), np.uint8) & 1
    laps = _Laps(profile, device)

    generator = torch.Generator(device=device).manual_seed(seed)
    syns_z, syns_x, x_err, z_err = _sample_two_sector(
        generator, batch, rounds, code, noise,
        *two_sector_circuits(code, hz, hx, device), rz=rz, rx=rx)
    laps.mark("sample_s")

    device_path = not (joint or correlated or gap_tau is not None
                       or osd == "always")

    def assemble(syns, err, h, lg):
        """(detectors [B, (R+1)*r], true observable parities [B, k]), on
        the device for the device path, else numpy."""
        h_t = torch.as_tensor(h, device=device)
        dets = detector_history(syns, gf2_torch.syndromes_dense(err, h_t))
        par = gf2_torch.mod2_matmul(err, torch.as_tensor(lg.T.copy(),
                                                         device=device))
        if device_path:
            return dets, par
        return dets.cpu().numpy(), par.cpu().numpy()

    dets_z, par_x = assemble(syns_z, x_err, hz, lz)
    laps.mark("detectors_s")

    bp_kwargs = bp_kwargs or {}
    with use_device(device):
        dec_z = circuit_bp_decoder(code, rounds, noise, sector="z",
                                   iters=iters, alpha=alpha, osd=osd,
                                   hz=hz, hx=hx, **bp_kwargs)
        laps.mark("build_s")
        stats_z = {} if profile is not None and device_path else None
        if gap_tau is not None:
            flips_x, conv_z, gap = dec_z.decode_obs_gap(dets_z)
        elif device_path:
            flips_x, conv_z = dec_z.decode_obs_device(dets_z, stats=stats_z)
        else:
            flips_x, conv_z = dec_z.decode_obs(dets_z)
        xf = _fails(flips_x, par_x)
        laps.mark("decode_s")
        out = {
            "x_fail": float(xf.mean()),
            "bp_converged_z": float(np.asarray(conv_z).mean()),
            "samples": batch,
            "rounds": rounds,
            "faults_z": dec_z.n,
        }
        if stats_z is not None:
            profile["z"] = stats_z
        if gap_tau is not None:
            # soft-output post-selection on the z-sector decode: abort
            # shots whose complementary gap falls below tau
            keep = gap >= gap_tau
            out.update({
                "gap_tau": float(gap_tau),
                "gap_keep": float(keep.mean()),
                "x_fail_postselected": float(xf[keep].mean())
                if keep.any() else None,
            })
        if sectors == "both":
            dets_x, par_z = assemble(syns_x, z_err, hx, lx)
            laps.mark("detectors_s")
            dec_x = circuit_bp_decoder(code, rounds, noise, sector="x",
                                       iters=iters, alpha=alpha, osd=osd,
                                       hz=hz, hx=hx, **bp_kwargs)
            laps.mark("build_s")
            if device_path:
                stats_x = {} if profile is not None else None
                flips_z, conv_x = dec_x.decode_obs_device(dets_x,
                                                          stats=stats_x)
                if stats_x is not None:
                    profile["x"] = stats_x
            else:
                flips_z, conv_x = dec_x.decode_obs(dets_x)
            zf = _fails(flips_z, par_z)
            laps.mark("decode_s")
            out.update({
                "z_fail": float(zf.mean()),
                "word_fail": float((xf | zf).mean()),
                "bp_converged_x": float(np.asarray(conv_x).mean()),
                "faults_x": dec_x.n,
            })
        if joint:
            from qcss_tpu_torch.decode.bp_dem import joint_circuit_bp_decoder

            if sectors != "both":
                raise ValueError("joint decoding needs sectors='both'")
            dec_j = joint_circuit_bp_decoder(code, rounds, noise,
                                             iters=iters, alpha=alpha_joint,
                                             osd=osd, hz=hz, hx=hx)
            flips_j, conv_j = dec_j.decode_obs(
                np.concatenate([dets_z, dets_x], axis=1))
            kz = lz.shape[0]
            xf_j = (flips_j[:, :kz] ^ par_x).any(axis=1)
            zf_j = (flips_j[:, kz:] ^ par_z).any(axis=1)
            out.update({
                "x_fail_joint": float(xf_j.mean()),
                "z_fail_joint": float(zf_j.mean()),
                "word_fail_joint": float((xf_j | zf_j).mean()),
                "bp_converged_joint": float(np.asarray(conv_j).mean()),
                "faults_joint": dec_j.n,
            })
        if correlated:
            from qcss_tpu_torch.decode.bp_dem import two_pass_pair_indices

            if sectors != "both":
                raise ValueError("correlated decoding needs sectors='both'")
            tz, tx, vx, vz, cond = two_pass_pair_indices(code, rounds, noise,
                                                         hz=hz, hx=hx)
            dz = BPDecoder(tz.checks, np.clip(tz.priors, 1e-12, 0.499),
                           logicals=tz.obs, iters=iters, alpha=alpha,
                           osd=osd)
            e_x, _ = dz.decode_batch(dets_z)
            # condition each Z-component's prior on its same-location
            # X-component having fired in the first pass
            pb = np.tile(np.clip(tx.priors, 1e-12, 0.499), (batch, 1))
            if vx.size:
                sel = e_x[:, vx].astype(bool)                     # [B, P]
                upd = np.zeros((tx.priors.size, batch))
                np.maximum.at(upd, vz,
                              np.where(sel, cond[None, :], 0.0).T)
                pb = np.maximum(pb, np.clip(upd.T, 0.0, 0.499))
            dxc = BPDecoder(tx.checks, np.clip(tx.priors, 1e-12, 0.499),
                            logicals=tx.obs, iters=iters, alpha=alpha,
                            osd=osd, **bp_kwargs)
            flips_zc, conv_c = dxc.decode_obs(dets_x, priors=pb)
            zf_c = (flips_zc ^ par_z).any(axis=1)
            out.update({
                "z_fail_corr": float(zf_c.mean()),
                "word_fail_corr": float((xf | zf_c).mean()),
                "bp_converged_corr": float(np.asarray(conv_c).mean()),
                "pairs": int(vx.size),
            })
    return out


def qldpc_stream_memory_rate(code, noise: noise_mod.NoiseModel, *,
                             rounds: int, batch: int, window: int = 8,
                             commit: int = 4, iters: int = 48,
                             alpha: float = 0.8, osd: bool = True,
                             seed: int = 0, sectors: str = "z",
                             device="cuda") -> dict[str, float]:
    """Unbounded-round circuit-level qLDPC Z-memory with O(window) state:
    chunked frame sampling of the two-sector extraction schedule on
    ``device`` (the card unless the caller asks for the CPU) interleaved
    with sliding-window circuit-level BP decodes
    (`decode.bp_streaming.CircuitBPStreamingDecoder`, BP on ``device``).

    Each chunk samples `commit` rounds with the physics and generator
    order of `qldpc_memory_experiment`'s sampler; the decoder window
    slides behind the sampler. Returns the X-logical failure rate over all
    k logicals and the end-to-end round-shots/s; `sectors='both'` also
    streams the x-sector history through a second window decoder and
    reports `z_fail` / `word_fail`."""
    from qcss_tpu_torch.decode.bp_streaming import CircuitBPStreamingDecoder

    device = resolve_device(device)
    hz, hx = _checks(code)
    rz, rx = hz.shape[0], hx.shape[0]
    lz = np.asarray(code.z_operator_matrix(), np.uint8) & 1
    lx = np.asarray(code.x_operator_matrix(), np.uint8) & 1
    n = code.n
    W, C = window, commit
    if rounds < W:
        raise ValueError("need rounds >= window")

    z_arrays, x_arrays, z_comp, x_comp = two_sector_circuits(code, hz, hx,
                                                             device)
    zanc = torch.arange(n, n + rz, device=device)
    xanc = torch.arange(n + rz, n + rz + rx, device=device)
    generator = torch.Generator(device=device).manual_seed(seed)

    def sample_chunk(f, prev, m):
        """m two-sector rounds; returns (frames, last syndromes, both
        sectors' detector increments [B, m, rz], [B, m, rx] numpy)."""
        pz, px = prev
        dz, dx = [], []
        for _ in range(m):
            if noise.p_idle:
                f = _idle_data(f, generator, noise, n)
            f, syn_z, _ = _extract(f, generator, noise, z_arrays, z_comp,
                                   zanc, None)
            f, syn_x, _ = _extract(f, generator, noise, x_arrays, x_comp,
                                   xanc, None)
            dz.append(syn_z ^ pz)
            dx.append(syn_x ^ px)
            pz, px = syn_z, syn_x
        return (f, (pz, px), torch.stack(dz, 1).cpu().numpy(),
                torch.stack(dx, 1).cpu().numpy())

    with use_device(device):
        dec = CircuitBPStreamingDecoder(code, noise, sector="z", window=W,
                                        commit=C, iters=iters, alpha=alpha,
                                        osd=osd, hz=hz, hx=hx)
        dec_x = None
        if sectors == "both":
            dec_x = CircuitBPStreamingDecoder(code, noise, sector="x",
                                              window=W, commit=C,
                                              iters=iters, alpha=alpha,
                                              osd=osd, hz=hz, hx=hx)

        f = fr.zero_frames(batch, n + rz + rx, device)
        prev = (torch.zeros((batch, rz), dtype=torch.uint8, device=device),
                torch.zeros((batch, rx), dtype=torch.uint8, device=device))
        flips = np.zeros((batch, lz.shape[0]), np.uint8)
        carry = np.zeros((batch, W * rz), np.uint8)
        flips_x = np.zeros((batch, lx.shape[0]), np.uint8)
        carry_x = np.zeros((batch, W * rx), np.uint8)
        conv_all = np.ones(batch, bool)

        synchronize(device)
        t0 = time.perf_counter()
        f, prev, buf, buf_x = sample_chunk(f, prev, W)
        # rounds sampled / layers committed; buf = [s0, sampled)
        sampled, s0 = W, 0
        while rounds + 1 - s0 > W:
            delta, carry, conv = dec.window_step(buf[:, :W], carry)
            flips ^= delta
            conv_all &= conv
            if dec_x is not None:
                delta, carry_x, conv = dec_x.window_step(buf_x[:, :W],
                                                         carry_x)
                flips_x ^= delta
                conv_all &= conv
            s0 += C
            m = min(C, rounds - sampled)
            if m:
                f, prev, fresh, fresh_x = sample_chunk(f, prev, m)
                buf = np.concatenate([buf[:, C:], fresh], axis=1)
                buf_x = np.concatenate([buf_x[:, C:], fresh_x], axis=1)
                sampled += m
            else:
                buf = buf[:, C:]
                buf_x = buf_x[:, C:]
        # perfect final readout of the data deviations
        x_err = f.x[:, :n].cpu().numpy()
        final_slice = ((x_err.astype(np.int64) @ hz.T) & 1).astype(np.uint8)
        final_slice ^= prev[0].cpu().numpy()
        buf = np.concatenate([buf, final_slice[:, None, :]], axis=1)
        fl, conv = dec.final_step(buf, carry)
        flips = (flips ^ fl).astype(np.uint8)
        conv_all &= conv
        if dec_x is not None:
            z_err = f.z[:, :n].cpu().numpy()
            final_x = ((z_err.astype(np.int64) @ hx.T) & 1).astype(np.uint8)
            final_x ^= prev[1].cpu().numpy()
            buf_x = np.concatenate([buf_x, final_x[:, None, :]], axis=1)
            fl, conv = dec_x.final_step(buf_x, carry_x)
            flips_x = (flips_x ^ fl).astype(np.uint8)
            conv_all &= conv
        elapsed = time.perf_counter() - t0

    par = (x_err.astype(np.int64) @ lz.T) & 1
    xf = (flips ^ par).any(axis=1)
    out = {
        "x_fail": float(xf.mean()),
        "bp_all_windows_converged": float(conv_all.mean()),
        "round_shots_per_sec": batch * rounds / elapsed,
        "rounds": rounds,
        "samples": batch,
        "window": W,
        "commit": C,
    }
    if dec_x is not None:
        par_z = (z_err.astype(np.int64) @ lx.T) & 1
        zf = (flips_x ^ par_z).any(axis=1)
        out["z_fail"] = float(zf.mean())
        out["word_fail"] = float((xf | zf).mean())
    return out
