"""Magic-state distillation — the universality layer (PyTorch port of
`qcss_tpu.ftqc.magic`).

The reference's non-Clifford path is an explicit stub: `_apply_universal`
returns None and no T gate, magic state, or distillation machinery exists
anywhere (reference: css_code.py:433-434). This module supplies the
standard route to universality for CSS frameworks: Bravyi-Kitaev 15-to-1
magic-state distillation on the [[15,1,3]] quantum Reed-Muller code
(quant-ph/0403025), generalized to any k=1 triorthogonal CSS code the
classifier accepts (`CSSCode.transversal_t_power`).

Protocol model (the standard twirled-input analysis)
----------------------------------------------------
Inputs are noisy T states that have been Clifford-twirled to Z-diagonal
form: rho = (1-p)|A><A| + p Z|A><A|Z with |A> = T|+>. The distillation
circuit teleport-injects one input onto each physical qubit of an encoded
|+̄>, realizing transversal T (= logical T^c, c odd) — a faulty input
contributes exactly a Z error at its injection site. Because transversal
T preserves the codespace (triorthogonality), the code's X stabilizers
remain deterministic +1: measuring them detects the injected Z errors.
Postselect on the trivial syndrome and read out the logical qubit:

    accept(e)  =  [H_1 · e = 0]          (e in the X-stabilizer dual)
    error(e)   =  [e in z̄ + rowspace(H_2)]  =  accept(e) AND <x̄, e> = 1

For the [[15,1,3]] code the error coset has weight enumerator starting
35·w^3, giving the famous p_out ≈ 35 p^3 with acceptance ≈ 1 - 15 p.
Both are computed EXACTLY here by coset weight enumeration (2^{r_2}
elements), alongside a batched device Monte-Carlo and an iterated-cascade
resource model.

Circuit-level tier (`distill_circuit`)
--------------------------------------
The same protocol with every Clifford operation noisy, on the Pauli-frame
engine (`sim.frame`): noisy |+̄> preparation network, Z-channel injections
(the twirled noisy inputs — exact, since T is diagonal and every
downstream check is X-type), `extractions` rounds of the real X-syndrome
extraction circuit under circuit noise, and a final transversal X-basis
readout whose H_1-syndrome must also vanish. Output error floors at the
Clifford-noise level instead of following 35 p^3 — the quantity a factory
designer actually needs.

Port: the enumerators, the exact map and the cascade are the JAX
package's numpy, copied. The Monte-Carlo and circuit tiers run on the
device (the card unless the caller passes ``device="cpu"``): errors are
``torch.rand(...) < p`` from a `torch.Generator` seeded with ``seed``, and
the circuit's three stages (preparation, injection, extraction rounds)
draw from `sim.noise.chunk_generators(seed, 3, device)` where the
reference splits its key three ways; the rounds draw from one generator
in turn (circuit noise, measurement flips, reset flips), a Python loop
where the reference scans. The streams differ from JAX's threefry, so the
rates agree with the reference's in distribution; given explicit
injections (``inject=``) under trivial Clifford noise the outcome bits
are the reference's exactly. The GF(2) products are exact float32
matmuls (`gf2_torch.mod2_matmul`), and the postselection is a running AND
over the rounds, so no syndrome history is kept.
"""

from __future__ import annotations

import numpy as np
import torch

from qcss_tpu_torch._cuda import resolve_device
from qcss_tpu_torch.circuits import encoding
from qcss_tpu_torch.errors import UnsupportedGateError
from qcss_tpu_torch.experiments.memory import x_extraction_circuit
from qcss_tpu_torch.ops.gf2_torch import mod2_matmul
from qcss_tpu_torch.sim import frame as fr
from qcss_tpu_torch.sim import noise as noise_mod


def _default_code():
    from qcss_tpu_torch.codes import families

    return families.reed_muller_15()


def _check_distillable(code) -> None:
    power = code.transversal_t_power
    if power is None or power % 2 == 0:
        raise UnsupportedGateError(
            "distillation needs a k=1 CSS code with transversal T "
            "(odd transversal_t_power); got "
            f"{power!r} — the reference supports no non-Clifford gate at "
            "all (reference: css_code.py:433-434)"
        )


def distillation_enumerators(code) -> tuple[np.ndarray, np.ndarray]:
    """Weight enumerators (W0, W1) of the Z-stabilizer rowspace and of the
    logical-Z coset z̄ + rowspace(H_2): W0[w] = #codewords of weight w.
    Together they define the accept set null(H_1) = rowspace(H_2) ∪ coset
    (k=1), hence the exact distillation map."""
    h2 = np.asarray(code.parity_check_c2, np.uint8) & 1
    zbar = np.asarray(code.z_operator_matrix()[0], np.uint8) & 1
    basis = h2[np.any(h2, axis=1)]
    r = basis.shape[0]
    if r > 22:
        raise ValueError(f"coset enumeration over 2^{r} elements refused")
    span = np.zeros((1, code.n), np.uint8)
    for row in basis:
        span = np.concatenate([span, span ^ row])
    n = code.n
    w0 = np.bincount(span.sum(axis=1, dtype=np.int64), minlength=n + 1)
    w1 = np.bincount((span ^ zbar).sum(axis=1, dtype=np.int64), minlength=n + 1)
    return w0, w1


def distill_exact(p: float, code=None) -> dict[str, float]:
    """Exact one-level distillation map at input Z-error rate p:
    acceptance probability, output error rate, and expected raw inputs
    consumed per accepted output (n / p_accept)."""
    code = _default_code() if code is None else code
    _check_distillable(code)
    w0, w1 = distillation_enumerators(code)
    n = code.n
    w = np.arange(n + 1, dtype=np.float64)
    mass = np.power(p, w) * np.power(1.0 - p, n - w)
    ok = float((w0 * mass).sum())
    bad = float((w1 * mass).sum())
    return {
        "p_in": float(p),
        "p_accept": ok + bad,
        "p_out": bad / (ok + bad),
        "cost": n / (ok + bad),
    }


def _mc_counts(generator, p, h1t, xbar, batch: int, n: int):
    """(accepted, accepted-and-erroneous) of ``batch`` protocol-level
    samples, as 0-d int64 tensors on the generator's device."""
    e = (torch.rand((batch, n), generator=generator, device=generator.device)
         < p).to(torch.uint8)
    accept = (mod2_matmul(e, h1t) == 0).all(dim=1)
    err = mod2_matmul(e, xbar[:, None])[:, 0] == 1
    return accept.sum(), (accept & err).sum()


def _code_rows(code, device):
    """(H_1^T [n, r_1], x̄ [n]) of ``code`` as uint8 tensors on ``device``."""
    h1t = torch.as_tensor(np.asarray(code.parity_check_c1, np.uint8).T.copy(),
                          device=device)
    xbar = torch.as_tensor(np.asarray(code.x_operator_matrix()[0], np.uint8),
                           device=device)
    return h1t, xbar


def distill_mc(p: float, batch: int, code=None, seed: int = 0,
               device="cuda") -> dict[str, float]:
    """Batched device Monte-Carlo of the protocol-level map (noiseless
    Cliffords): sample e ~ Bern(p)^n, accept on trivial X-syndrome, error
    = <x̄, e>. Cross-checks `distill_exact`. The errors are drawn on
    ``device`` from a generator seeded with ``seed``; one host read."""
    code = _default_code() if code is None else code
    _check_distillable(code)
    device = resolve_device(device)
    h1t, xbar = _code_rows(code, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    acc, bad = torch.stack(_mc_counts(gen, p, h1t, xbar, batch,
                                      code.n)).tolist()
    return {
        "p_in": float(p),
        "p_accept": acc / batch,
        "p_out": bad / max(acc, 1),
        "accepted": acc,
        "samples": batch,
    }


def distill_cascade(p0: float, levels: int, code=None) -> list[dict[str, float]]:
    """Iterate the exact map: level i distills level i-1 outputs. Each
    entry adds `raw_cost` — expected RAW (level-0) input states per
    accepted output at that level, Π_j n / p_accept_j."""
    code = _default_code() if code is None else code
    out = []
    p, raw = p0, 1.0
    for _ in range(levels):
        step = distill_exact(p, code)
        raw *= step["cost"]
        step["raw_cost"] = raw
        out.append(step)
        p = step["p_out"]
    return out


def _circuit_kernel(gens, p_in, inject, code, noise, prep_arrays,
                    ext_arrays, h1t, xbar, batch: int, extractions: int,
                    n: int, r1: int):
    """The circuit tier on the generators' device: ``gens`` are the
    (preparation, injection, rounds) generators. Returns (accept [B] bool,
    error [B] bool) there; nothing is read back."""
    g_prep, g_inj, g_rounds = gens
    device = g_prep.device
    data = slice(0, n)
    anc = slice(n, n + r1)

    f = fr.zero_frames(batch, n + r1, device)
    f = fr.run_arrays_noisy(f, *prep_arrays, noise, g_prep)
    if inject is None:
        zf = (torch.rand((batch, n), generator=g_inj, device=device)
              < p_in).to(torch.uint8)
    else:
        zf = torch.as_tensor(np.asarray(inject, np.uint8)).to(device)
    f = fr.inject_flips(f, data, torch.zeros_like(zf), zf)

    accept = torch.ones(batch, dtype=torch.bool, device=device)
    for _ in range(extractions):  # the reference's lax.scan over rounds
        f = fr.run_arrays_noisy(f, *ext_arrays, noise, g_rounds)
        f, syn = fr.measure_deviations(f, anc, g_rounds, noise.p_meas)
        f = fr.reset_qubits(f, anc, g_rounds, noise.p_reset)
        accept &= (syn == 0).all(dim=1)
    # Perfect transversal X-basis readout: Z errors flip X outcomes, so
    # the per-qubit deviations are the data Z frame.
    w = f.z[:, :n]
    accept &= (mod2_matmul(w, h1t) == 0).all(dim=1)
    obs = mod2_matmul(w, xbar[:, None])[:, 0]
    return accept, obs == 1


def _circuit_setup(code, device):
    """The circuit tier's fixed inputs for ``code``: the |+̄> preparation
    network and the X-extraction round (host arrays), H_1^T and x̄."""
    prep = encoding.encode_plus_network(code).to_arrays()
    ext = x_extraction_circuit(code).to_arrays()
    return (prep, ext) + _code_rows(code, device)


def distill_circuit(noise: noise_mod.NoiseModel, p_in: float, batch: int,
                    code=None, extractions: int = 1, seed: int = 0,
                    inject=None, return_samples: bool = False,
                    device="cuda"):
    """Circuit-level distillation on the frame engine (see module
    docstring): noisy |+̄> prep + twirled-input Z injections + noisy
    X-extraction rounds + perfect final X readout, postselecting on every
    syndrome. `inject` replaces the Bernoulli(p_in) injection with an
    explicit [batch, n] Z-flip array (exhaustive tests).

    Returns acceptance rate and the conditional output Z-error rate —
    with `noise` trivial this reproduces `distill_exact(p_in)`; with
    circuit noise it exhibits the Clifford-noise floor. Runs on
    ``device``; the three stages draw from
    `noise.chunk_generators(seed, 3, device)`."""
    code = _default_code() if code is None else code
    _check_distillable(code)
    device = resolve_device(device)
    prep, ext, h1t, xbar = _circuit_setup(code, device)
    accept, err = _circuit_kernel(
        noise_mod.chunk_generators(seed, 3, device), p_in, inject, code,
        noise, prep, ext, h1t, xbar, batch=batch, extractions=extractions,
        n=code.n, r1=code.r_1)
    acc, bad = torch.stack([accept.sum(), (accept & err).sum()]).tolist()
    out = {
        "p_in": float(p_in),
        "p_accept": acc / batch,
        "p_out": bad / max(acc, 1),
        "accepted": acc,
        "samples": batch,
        "extractions": extractions,
    }
    if return_samples:
        out["accept"] = accept.cpu().numpy()
        out["error"] = err.cpu().numpy()
    return out
