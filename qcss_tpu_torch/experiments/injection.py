"""Magic-state injection: noisy logical |A⟩ preparation, measured exactly
(PyTorch port of `qcss_tpu.experiments.injection`).

A factory needs two numbers the distillation analysis (`ftqc/magic.py`)
takes as given: the error rate ε of the RAW encoded magic states feeding
level 0, and their acceptance cost. This experiment measures both for any
CSS code, on the Pauli-frame engine (`sim.frame`), with every Clifford
location noisy. The reference has no analogue — it supports no
non-Clifford gate at all (reference: css_code.py:433-434).

Protocol (encode-then-grow injection, the standard scheme):
    1. all qubits noisily reset to |0⟩,
    2. noisy H on the input qubit q₀ (the code's standard-form logical
       input coordinate, `encoding.encode_state_network`),
    3. physical T on q₀ — ideal gate plus a twirled Z channel of rate
       `p_t` (the noisy-T model),
    4. the noisy encode_state_network grows q₀'s state onto the block,
    5. `extractions` rounds of real noisy syndrome extraction (both
       sectors); POST-SELECT on all syndromes trivial,
    6. perfect final decode (LUT corrections on both sectors); read the
       residual logical Pauli (pX, pY, pZ) on the injected qubit.

Exactness. Every operation except T is Clifford and every fault is
Pauli, so frame propagation is exact — with two observations making the
single T location exact too:
  * Any X deviation on q₀ entering the T gate acts on |+⟩, which X
    stabilizes: the deviation is deleted (identity up to global phase)
    rather than conjugated through T. The surviving Z component commutes
    with T exactly.
  * The noisy T itself is modeled as ideal T followed by a Pauli
    channel; dephasing-dominated hardware is Z-biased, and a full
    channel (px', py', pz') twirled about the |A⟩ axis folds to an
    effective Z rate anyway — pass that as `p_t`.
Reference outcomes are deterministic throughout (stabilizer measurements
on a codespace state), satisfying the frame-soundness rules.

The headline figure is the twirled single-state error rate
    ε = (pX + pY)/2 + pZ
(error probability of Pauli P on |A⟩ is 1 − |⟨A|P|A⟩|²: ½ for X and Y,
1 for Z), which is exactly the `p_in` of `magic.distill_exact`;
`factory_report` composes the two into an end-to-end physical-T-to-
target-fidelity resource estimate.

Port: runs on the device (the card unless the caller passes
``device="cpu"``). The five stages (reset, H, T, growth, extraction
rounds) draw from `sim.noise.chunk_generators(seed, 5, device)` where the
reference splits its key five ways, so rates agree with the reference's
in distribution. The final perfect decode is per sector the port's packed
sector decode (`decode.montecarlo`): K8 (`cuda_gf2.decode_residual_packed`)
applies the LUT correction, then K6 (`cuda_gf2.syndromes_packed`) takes
the residual's parity against the sector's first logical row — the
kernels for the card's tensors, their plain versions for the CPU's. On
given frames it equals the reference's dense `syndromes_dense` + LUT
gather decode bit for bit.
"""

from __future__ import annotations

import torch

from qcss_tpu_torch._cuda import resolve_device
from qcss_tpu_torch.circuits import encoding
from qcss_tpu_torch.decode.montecarlo import (
    PackedSector,
    _sector_fail_packed,
    packed_sectors,
)
from qcss_tpu_torch.experiments.memory import (
    x_extraction_circuit,
    z_extraction_circuit,
)
from qcss_tpu_torch.ftqc import magic
from qcss_tpu_torch.sim import frame as fr
from qcss_tpu_torch.sim import noise as noise_mod


def final_sectors(code, device) -> tuple[PackedSector, PackedSector]:
    """The final decode's tables on ``device``: (X frame: Z checks, C2
    LUT, Z̄; Z frame: X checks, C1 LUT, X̄), packed, each judged by the
    code's first logical row as the reference reads it."""
    return tuple(sec._replace(logicals=sec.logicals[:1].contiguous())
                 for sec in packed_sectors(code, device))


def final_decode(fx, fz, sectors):
    """Perfect final decode of data frames fx, fz [B, n] uint8: each
    sector corrected with its LUT (K8), then the residual's parity against
    the other sector's logical (K6). Returns (log_x, log_z) [B] uint8: a
    residual X anticommuting with Z̄, a residual Z anticommuting with X̄."""
    x_sec, z_sec = sectors
    return _sector_fail_packed(fx, x_sec), _sector_fail_packed(fz, z_sec)


def _injection_kernel(gens, p_t, code, noise, h_arrays, grow_arrays,
                      ext_arrays, q0: int, batch: int, extractions: int,
                      n: int, n_anc: int, sectors):
    """The protocol on the generators' device: ``gens`` are the (reset,
    H, T, growth, rounds) generators. Returns (accept, log_x, log_z), [B]
    bool each, there; nothing is read back."""
    g_reset, g_h, g_t, g_grow, g_rounds = gens
    device = g_reset.device
    data = slice(0, n)
    anc = slice(n, n + n_anc)

    f = fr.zero_frames(batch, n + n_anc, device)
    f = fr.reset_qubits(f, data, g_reset, noise.p_reset)
    f = fr.run_arrays_noisy(f, *h_arrays, noise, g_h)
    # T location: X deviations act on |+⟩ (its stabilizer) — delete them;
    # then the twirled noisy T injects Z with probability p_t.
    zt = (torch.rand((batch, 1), generator=g_t, device=device)
          < p_t).to(torch.uint8)
    x = f.x.clone()
    x[:, q0] = 0
    f = fr.Frames(x, f.z)
    f = fr.inject_flips(f, [q0], torch.zeros_like(zt), zt)
    f = fr.run_arrays_noisy(f, *grow_arrays, noise, g_grow)

    accept = torch.ones(batch, dtype=torch.bool, device=device)
    for _ in range(extractions):  # the reference's lax.scan over rounds
        f = fr.run_arrays_noisy(f, *ext_arrays, noise, g_rounds)
        f, syn = fr.measure_deviations(f, anc, g_rounds, noise.p_meas)
        f = fr.reset_qubits(f, anc, g_rounds, noise.p_reset)
        accept &= (syn == 0).all(dim=1)

    log_x, log_z = final_decode(f.x[:, :n], f.z[:, :n], sectors)
    return accept, log_x == 1, log_z == 1


def magic_injection_experiment(code, noise: noise_mod.NoiseModel,
                               p_t: float, batch: int, *,
                               extractions: int = 1, seed: int = 0,
                               return_samples: bool = False,
                               device="cuda") -> dict:
    """Run the injection protocol; see module docstring.

    Returns acceptance rate and the POST-SELECTED logical Pauli rates
    (p_x, p_y, p_z) plus the twirled single-state error rate ``eps``.
    With trivial Clifford noise, eps == p_t exactly (a Z at the T
    location propagates to Z̄ with a trivial syndrome). Runs on
    ``device``, with one host read of the counts.
    """
    if noise.p_idle:
        raise ValueError("injection experiment charges no idle locations; "
                         "p_idle must be 0")
    n = code.n
    net, inputs = encoding.encode_state_network(code)
    q0 = inputs[0]
    h_prep = encoding.Circuit().h(q0)
    ext = x_extraction_circuit(code)
    r1 = code.parity_check_c1.shape[0]
    for g in z_extraction_circuit(code, anc_offset=n + r1).gates:
        ext.gates.append(g)
    n_anc = r1 + code.parity_check_c2.shape[0]
    dev = code.device
    if dev.lut_c1 is None or dev.lut_c2 is None:
        raise ValueError("injection needs full syndrome LUTs "
                         "(construct the code with max_table_weight=None)")
    device = resolve_device(device)
    accept, lx, lz = _injection_kernel(
        noise_mod.chunk_generators(seed, 5, device), p_t, code, noise,
        h_prep.to_arrays(), net.to_arrays(), ext.to_arrays(), q0=q0,
        batch=batch, extractions=extractions, n=n, n_anc=n_anc,
        sectors=final_sectors(code, device))
    acc, nx, nz, ny = torch.stack([
        accept.sum(), (accept & lx & ~lz).sum(), (accept & lz & ~lx).sum(),
        (accept & lx & lz).sum()]).tolist()
    d = max(acc, 1)
    px, py, pz = nx / d, ny / d, nz / d
    out = {
        "p_t": float(p_t),
        "p_accept": acc / batch,
        "p_x": px, "p_y": py, "p_z": pz,
        "eps": (px + py) / 2.0 + pz,
        "accepted": acc,
        "samples": batch,
        "extractions": extractions,
    }
    if return_samples:
        out["accept"] = accept.cpu().numpy()
        out["log_x"] = lx.cpu().numpy()
        out["log_z"] = lz.cpu().numpy()
    return out


def factory_report(code, noise: noise_mod.NoiseModel, p_t: float, *,
                   levels: int = 2, batch: int = 1 << 20,
                   extractions: int = 1, distill_code=None,
                   seed: int = 0, device="cuda") -> dict:
    """End-to-end magic-state factory estimate: measured injection ε on
    `code` feeds the exact distillation cascade (`magic.distill_cascade`,
    on `distill_code`, default [[15,1,3]]). ``injections_per_state`` is
    the expected number of injection ATTEMPTS consumed per final output,
    folding the cascade's raw-state cost with the injection acceptance."""
    inj = magic_injection_experiment(code, noise, p_t, batch,
                                     extractions=extractions, seed=seed,
                                     device=device)
    cascade = magic.distill_cascade(inj["eps"], levels, code=distill_code)
    return {
        "injection": inj,
        "cascade": cascade,
        "p_out": cascade[-1]["p_out"],
        "injections_per_state":
            cascade[-1]["raw_cost"] / max(inj["p_accept"], 1e-30),
    }
