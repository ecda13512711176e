"""Correlated X↔Z decoding for depolarizing noise (two-pass matching;
PyTorch port of `qcss_tpu.decode.correlated`).

Independent X/Z decoding throws away the defining correlation of the
depolarizing channel: a Y error flips BOTH sectors, so knowing where the
X-sector decoder placed corrections changes the posterior for Z errors at
the same qubits. Under uniform depolarizing p,

    P(Z-component | X-component found)  = p_Y / (p_X + p_Y) = 1/2
    P(Z-component | no X-component)     = (p/3) / (1 - 2p/3) ≈ p/3

a likelihood gap of ~1/p. The two-pass scheme: decode the X sector
normally, then decode the Z sector on the SAME matching graph but with
per-shot edge weights — edges whose qubit received an X correction grow
at the cheap -log(1/2) pace, the rest at -log(p/3). The per-shot weight
machinery is `UFDecoder.decode_batch(..., shot_weights=)` backed by
`native/uf_decoder.cc`.

Random stream: the reference splits one JAX key per batch; here batch i
draws from its own generator (`sim.noise.chunk_generators`), so the
sampled shots are held by rates and the decode, given the shots, bit for
bit.
"""

from __future__ import annotations

import numpy as np
import torch

from qcss_tpu_torch._cuda import resolve_device
from qcss_tpu_torch.decode.uf import (
    UFDecoder,
    _pack_parity,
    _sample_and_extract,
    graph_from_checks,
    weights_from_probs,
)
from qcss_tpu_torch.sim.noise import chunk_generators


def conditional_weights(p: float) -> tuple[int, int]:
    """(base, cheap) integer growth weights for the second-pass graph:
    cheap = 2 (the most likely edge class, P = 1/2), base from the
    no-X-component posterior P = (p/3)/(1 - 2p/3)."""
    p_cond_no = (p / 3.0) / (1.0 - 2.0 * p / 3.0)
    w = weights_from_probs([p_cond_no, 0.5])
    return int(w[0]), int(w[1])


def correlated_logical_error_rate(
    code,
    p,
    *,
    samples: int = 1 << 16,
    batch: int = 1 << 16,
    seed: int = 0,
    n_threads: int | None = None,
    use_native: bool | None = None,
    device="cuda",
) -> dict[str, float]:
    """Code-capacity depolarizing logical error rate, decoded with
    two-pass correlated union-find; reports the independent-decoding
    failure rates on the same shots for comparison. Sampling runs on
    ``device`` (the card unless the caller asks for the CPU).

    Returns x_fail (first pass, identical in both schemes), z_fail /
    word_fail (independent) and z_fail_corr / word_fail_corr (correlated
    second pass)."""
    device = resolve_device(device)
    h2_raw = code.raw_parity_check_c2
    h1_raw = code.raw_parity_check_c1
    gx = graph_from_checks(h2_raw, code.z_operator_matrix())
    gz = graph_from_checks(h1_raw, code.x_operator_matrix())
    dec_x = UFDecoder(gx, use_native=use_native)
    dec_z = UFDecoder(gz, use_native=use_native)

    w_base, w_cheap = conditional_weights(p)
    # per-edge qubit of the Z-sector graph (every code-capacity edge has one)
    zq = gz.edge_qubit
    assert (zq >= 0).all()

    def t(a):
        return torch.as_tensor(np.asarray(a, np.uint8), device=device)

    h2_t, h1_t = t(h2_raw), t(h1_raw)
    lz_t, lx_t = t(code.z_operator_matrix()), t(code.x_operator_matrix())
    rounds = -(-samples // batch)
    fails = {"x_fail": 0, "z_fail": 0, "word_fail": 0,
             "z_fail_corr": 0, "word_fail_corr": 0}
    for gen in chunk_generators(seed, rounds, device):
        syn_x, syn_z, par_x, par_z = (
            a.cpu().numpy() for a in _sample_and_extract(
                gen, p, batch, h2_t, h1_t, lz_t, lx_t))
        corr_x, obs_x = dec_x.decode_batch(syn_x, n_threads=n_threads)
        _, obs_z = dec_z.decode_batch(syn_z, want_corrections=False,
                                      n_threads=n_threads)
        # pass 2: Z edges at X-corrected qubits become cheap
        wts = np.where(corr_x[:, zq] == 1, np.uint8(w_cheap),
                       np.uint8(w_base))
        _, obs_zc = dec_z.decode_batch(syn_z, want_corrections=False,
                                       n_threads=n_threads, shot_weights=wts)
        xf = obs_x != _pack_parity(par_x)
        zf = obs_z != _pack_parity(par_z)
        zfc = obs_zc != _pack_parity(par_z)
        fails["x_fail"] += int(np.sum(xf))
        fails["z_fail"] += int(np.sum(zf))
        fails["word_fail"] += int(np.sum(xf | zf))
        fails["z_fail_corr"] += int(np.sum(zfc))
        fails["word_fail_corr"] += int(np.sum(xf | zfc))
    n_samples = rounds * batch
    out = {k: v / n_samples for k, v in fails.items()}
    out["samples"] = n_samples
    out["p"] = p
    return out

