"""Exact maximum-likelihood decoding by batched coset enumeration (PyTorch
port of `qcss_tpu.decode.mld`).

Every practical decoder in this package approximates: LUT and MWPM pick
a MINIMUM-WEIGHT representative, union-find approximates that, BP
approximates marginals on a loopy graph. The maximum-likelihood (ML)
decision sums the probability of EVERY error consistent with the
syndrome, per logical class, and picks the heaviest class:

    score(c) = sum_{g in stabilizer group} Pr[e0 + L_c + g]

(e0 any error with syndrome s; for X-error decoding the degeneracy
group is the X-STABILIZERS — the rowspace of h_x — and L_c ranges over
the 2^k X-logical combinations). Min-weight decoding ignores
degeneracy: a class with many medium-weight representatives can
outweigh the class holding the single lightest one, so ML is strictly
better on degenerate codes.

For independent priors, log Pr[e] = const + e . llr with
llr_j = log(p_j / (1 - p_j)), and

    (eL xor g) . llr  =  eL . llr  +  g . llr  -  2 * (eL * llr) . g

so ONE [B, n] @ [n, G] matmul per logical class hands every coset
log-probability to the whole batch at once, followed by a logsumexp
over the coset axis. The coset axis is chunked (2^16 per step) so r ~ 20
stabilizer generators stay in memory; per-qubit or per-shot priors ride
the same matmul, so soft-input EXACT decoding comes out of the same
scorer. The matmuls are plain float32 `torch.matmul` on the decoder's
device, with TF32 off (its 10-bit mantissa would blur the coset scores).
"""

from __future__ import annotations

import numpy as np
import torch

from qcss_tpu_torch._cuda import resolve_device
from qcss_tpu_torch.decode.bp import _tf32_off
from qcss_tpu_torch.ops import gf2, gf2_torch

__all__ = ["MLDecoder", "mld_logical_error_rate"]

_CHUNK = 1 << 16


def _span_table(rows: np.ndarray) -> np.ndarray:
    """[2^r, n] uint8 table of every GF(2) combination of `rows`."""
    rows = np.asarray(rows, np.uint8) & 1
    r, n = rows.shape
    if r > 22:
        raise ValueError(
            f"{r} stabilizer generators -> 2^{r} cosets; ML enumeration "
            "is exponential — use BP/UF/MWPM at this scale")
    idx = np.arange(1 << r, dtype=np.uint32)
    bits = ((idx[:, None] >> np.arange(r)[None, :]) & 1).astype(np.uint8)
    return (bits @ rows) & 1


class MLDecoder:
    """Exact ML decoder for one CSS error sector, scoring on ``device``
    (the card unless the caller asks for the CPU).

    h:        [r_h, n] checks measuring the decoded errors (X errors:
              the Z-type checks, ``code.parity_check_c2``).
    stab:     [r_s, n] stabilizer generators of the SAME type as the
              decoded errors (X errors: ``code.parity_check_c1``) —
              the degeneracy group the class sums enumerate.
    logicals_err: [k, n] logical representatives of the decoded error
              type (X errors: ``code.x_operator_matrix()``).
    logicals_obs: [k, n] dual logicals defining the scored observables
              (X errors: ``code.z_operator_matrix()``).

    ``decode_flips(syndromes, llr=None)`` returns the ML estimate of
    each observable's flip, [B, k] uint8 — the same contract as the
    LUT/UF/BP observable outputs. ``llr`` overrides the uniform prior
    with per-qubit ``[n]`` or per-shot ``[B, n]`` log-odds.
    """

    def __init__(self, h, stab, logicals_err, logicals_obs, *,
                 p: float = 1e-2, device="cuda"):
        self.device = resolve_device(device)
        self.h = np.asarray(h, np.uint8) & 1
        self.n = self.h.shape[1]
        self.lerr = np.atleast_2d(np.asarray(logicals_err, np.uint8) & 1)
        self.lobs = np.atleast_2d(np.asarray(logicals_obs, np.uint8) & 1)
        self.k = self.lerr.shape[0]
        if self.k > 6:
            raise ValueError("2^k class enumeration; k <= 6 supported")
        self.p = float(p)
        stab = np.atleast_2d(np.asarray(stab, np.uint8) & 1)
        self._coset = _span_table(stab[gf2.row_basis(stab)])
        # syndrome -> representative: reduce [h | I]; rows whose pivot
        # stays in the h block give rref_h = T @ h, so a consistent
        # syndrome maps to s_rref = T s and e0 = sum_i s_rref_i * unit
        # vector on rref pivot column i satisfies h e0 = s.
        aug = np.concatenate(
            [self.h, np.eye(self.h.shape[0], dtype=np.uint8)], axis=1)
        rref_aug = gf2.rref(aug)
        piv, t_rows = [], []
        for row in rref_aug:
            nz = np.nonzero(row[: self.n])[0]
            if nz.size:
                piv.append(int(nz[0]))
                t_rows.append(row[self.n:])
        self._piv = np.asarray(piv, np.int32)
        self._t = np.asarray(t_rows, np.uint8)
        cls_idx = np.arange(1 << self.k, dtype=np.uint32)
        cls_bits = ((cls_idx[:, None] >> np.arange(self.k)[None, :]) & 1
                    ).astype(np.uint8)                       # [C, k]
        self._cls_vecs = (cls_bits @ self.lerr) & 1          # [C, n]
        self._chunk_list = None

    @classmethod
    def for_code(cls, code, *, sector: str = "x_errors", p: float = 1e-2,
                 device="cuda"):
        """X errors (`sector='x_errors'`, checked by the Z-type checks,
        scored against Z̄) or Z errors (`'z_errors'`)."""
        if sector == "x_errors":
            return cls(code.parity_check_c2, code.parity_check_c1,
                       code.x_operator_matrix(), code.z_operator_matrix(),
                       p=p, device=device)
        if sector == "z_errors":
            return cls(code.parity_check_c1, code.parity_check_c2,
                       code.z_operator_matrix(), code.x_operator_matrix(),
                       p=p, device=device)
        raise ValueError(sector)

    def _representatives(self, syndromes: np.ndarray) -> np.ndarray:
        s = np.asarray(syndromes, np.uint8) & 1
        s_r = (s @ self._t.T) & 1
        e0 = np.zeros((s.shape[0], self.n), np.uint8)
        e0[:, self._piv] = s_r
        return e0

    def _chunks(self) -> list[torch.Tensor]:
        """The coset table as [n, <= 2^16] float32 chunks on the device,
        built once."""
        if self._chunk_list is None:
            coset_np = self._coset
            self._chunk_list = [
                torch.as_tensor(coset_np[i:i + _CHUNK].T.astype(np.float32),
                                device=self.device)
                for i in range(0, coset_np.shape[0], _CHUNK)]
        return self._chunk_list

    @staticmethod
    def _class_lse(eL, llr, chunks):
        """eL [B, n] uint8, llr [B, n] f32 -> [B] coset log score."""
        eLf = eL.to(torch.float32)
        base = torch.sum(eLf * llr, dim=1)
        cross_in = eLf * llr
        out = torch.full(base.shape, -torch.inf, dtype=torch.float32,
                         device=base.device)
        with _tf32_off():
            for ch in chunks:
                tot = base[:, None] + llr @ ch - 2.0 * (cross_in @ ch)
                out = torch.logaddexp(out, torch.logsumexp(tot, dim=1))
        return out

    def _scores(self, e0, llr) -> torch.Tensor:
        """[C, B] class log scores of e0 ^ L_c, on the device."""
        chunks = self._chunks()
        cls_vecs = torch.as_tensor(self._cls_vecs, device=e0.device)
        return torch.stack([self._class_lse(e0 ^ cls_vecs[c], llr, chunks)
                            for c in range(cls_vecs.shape[0])])

    def device_decode_fn(self):
        """Pure-device decode: (syndromes [B, r_h] uint8 tensor, llr
        [B, n] float32 tensor, both on the decoder's device) -> ML
        observable flips [B, k] uint8 there. The representative solve,
        coset scoring and class selection all run on the device; equal to
        `decode_flips` bit for bit."""
        dev = self.device
        t_t = torch.as_tensor(self._t, device=dev)
        piv = torch.as_tensor(self._piv.astype(np.int64), device=dev)
        n = self.n
        par_cls = torch.as_tensor((self._cls_vecs @ self.lobs.T) & 1,
                                  device=dev)
        lobs_t = torch.as_tensor(self.lobs.T.copy(), device=dev)

        def decode(syn, llr):
            s_r = gf2_torch.mod2_matmul(syn.to(torch.uint8), t_t.T)
            e0 = torch.zeros((syn.shape[0], n), dtype=torch.uint8,
                             device=dev)
            e0[:, piv] = s_r
            best = torch.argmax(self._scores(e0, llr), dim=0)
            par0 = gf2_torch.mod2_matmul(e0, lobs_t)
            return (par0 ^ par_cls[best]) & 1

        return decode

    def decode_flips(self, syndromes, llr=None, *,
                     return_scores: bool = False):
        e0 = self._representatives(syndromes)
        B = e0.shape[0]
        if llr is None:
            llr = np.full(self.n, np.log(self.p / (1 - self.p)), np.float32)
        llr = np.broadcast_to(np.asarray(llr, np.float32), (B, self.n))
        scores = self._scores(
            torch.as_tensor(e0, device=self.device),
            torch.tensor(llr, device=self.device))
        best = torch.argmax(scores, dim=0).cpu().numpy()     # [B]
        # observable estimate of the chosen correction e0 + L_best
        par0 = (e0 @ self.lobs.T) & 1                        # [B, k]
        par_cls = (self._cls_vecs @ self.lobs.T) & 1         # [C, k]
        flips = (par0 ^ par_cls[best]) & 1
        if return_scores:
            return flips.astype(np.uint8), scores.cpu().numpy()
        return flips.astype(np.uint8)


def _ml_device_step(code, p: float, batch: int, device):
    """The ML half of `mld_logical_error_rate` on ``device``:
    ``step(generator)`` draws ``batch`` iid X-error words at ``p``, decodes
    their syndromes with `MLDecoder.device_decode_fn` and returns (the
    errors [batch, n] uint8, the word failures, a device scalar); nothing
    is read back."""
    dec = MLDecoder.for_code(code, p=p, device=device).device_decode_fn()
    h_t = torch.as_tensor(np.asarray(code.parity_check_c2, np.uint8).T
                          & 1, device=device)
    lz_t = torch.as_tensor(np.asarray(code.z_operator_matrix(), np.uint8).T
                           & 1, device=device)
    n = code.n
    llr = torch.full((batch, n), float(np.log(p / (1 - p))),
                     dtype=torch.float32, device=device)

    def step(gen):
        errs = (torch.rand((batch, n), generator=gen, device=device) < p
                ).to(torch.uint8)
        flips = dec(gf2_torch.mod2_matmul(errs, h_t), llr)
        true_par = gf2_torch.mod2_matmul(errs, lz_t)
        return errs, (flips != true_par).any(dim=1).sum()

    return step


def mld_logical_error_rate(code, p: float, *, batch: int = 1 << 12,
                           seed: int = 0, device="cuda"):
    """Code-capacity X-sector word failure under exact ML decoding,
    plus the min-weight LUT failure on the SAME shots — the measured
    optimality gap of the reference-style decoder (which, like the
    reference, leaves unknown syndromes uncorrected). The errors are
    drawn on ``device`` from a generator seeded with ``seed``. Returns
    dict(word_fail_ml, word_fail_lut, n_shots)."""
    from qcss_tpu_torch.decode.lut import decode_corrections

    device = resolve_device(device)
    h = np.asarray(code.parity_check_c2, np.uint8)
    lz = np.asarray(code.z_operator_matrix(), np.uint8)
    step = _ml_device_step(code, p, batch, device)
    errs_t, fails = step(torch.Generator(device=device).manual_seed(seed))
    errs = errs_t.cpu().numpy()
    syn = (errs @ h.T) & 1
    fail_ml = int(fails) / batch

    lut = code.device.lut_c2
    if lut is None:
        lut = torch.as_tensor(gf2.correction_lut(
            h, gf2.syndrome_table(h)[1]).astype(np.uint8))
    corr = decode_corrections(torch.as_tensor(syn), lut).numpy()
    res_par = ((errs ^ corr) @ lz.T) & 1
    fail_lut = float(np.mean(np.any(res_par, axis=1)))
    return {"word_fail_ml": fail_ml, "word_fail_lut": fail_lut,
            "n_shots": batch}
