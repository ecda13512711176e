"""Batched belief propagation (+ ordered statistics) on the device — the
qLDPC decoder (PyTorch port of `qcss_tpu.decode.bp`).

The matching decoders (`decode.uf`, `decode.mwpm`) require every error
mechanism to flip at most two checks; LUT decoding (`decode.lut`) is
exponential in the check count. Neither covers qLDPC memories —
bivariate-bicycle and hypergraph-product codes (`codes.families.bb72`
etc.) — where the standard decoder is BP+OSD.

Formulation (the reference's, in torch)
---------------------------------------

* messages live in a check-major padded layout ``[B, r, Dc]`` (Dc = max
  check degree, masked padding), so the check update (min / argmin /
  sign parity) is a last-axis reduction;
* variable totals are either one dense float32 matmul against the 0/1
  slot-to-variable incidence (``layout='dense'``) or a static gather of
  each variable's slots (``layout='gather'``); ``'auto'`` takes the
  gather past ``r * Dc * n > 2^26`` incidence entries, the reference's
  threshold. The two differ in float32 summation order, so the threshold
  is part of the semantics. The dense matmul runs with TF32 off;
* the check update is normalized min-sum (factor ``alpha``) with the
  min1/min2/argmin exclusion (argmin takes the first minimum), optional
  ``gamma`` damping, per-shot estimates frozen at their first
  syndrome-satisfying iteration;
* the loop stops once every shot has converged. Whether all have is read
  every `_CHECK_EVERY` iterations (each read is a host sync): converged
  shots are frozen and unconverged ones always run ``iters`` iterations,
  so no output depends on the cadence. The batch is decoded in chunks
  sized to a memory budget; BP is per shot, so chunks change nothing.

Shots BP leaves unconverged go to OSD-0 (ordered statistics over the
final LLRs, most suspect columns first — Panteleev & Kalachev 2021) or its
order-E combination sweep, all through one tail solver (`_osd_tail`):
on the host through the native library (`qcss_tpu_torch.native`), or on
the device (`_osd_eliminate`, `_osd0_solve`, `_osde_solve`), which is
bit-identical to the host for OSD-0. The reference's TPU forms of the
device elimination (rows kept in place with one-hot pivot selection,
16-bit-half einsums for candidate columns, a 16 GB chunk budget) are not
kept; the semantics are: the pivot columns are the greedy independent
set in stable-sorted order, OSD-E accepts a candidate on strict < and
takes the first minimum.

Divergence from the reference, by design: with ``osd_order=1`` and
``lam1=0`` (no candidate) the reference's device OSD-E raises on an empty
stack while its host sweep returns OSD-0; the port returns OSD-0 on both
backends.
"""

from __future__ import annotations

import contextlib
import contextvars
import time

import numpy as np
import torch

from qcss_tpu_torch._cuda import resolve_device, synchronize
from qcss_tpu_torch.ops import gf2_torch

_BIG = float(np.float32(1e30))
#: iterations between reads of "has every shot converged?"
_CHECK_EVERY = 4
#: bytes of one [chunk, r, Dc] float32 message tensor a BP chunk may take
#: (the iteration keeps about ten such tensors live)
_BP_CHUNK_BYTES = 1 << 31
#: bits of the [r, C] elimination systems of one OSD chunk (the working
#: set is about six times the packed systems)
_OSD_CHUNK_BITS = 1 << 34
_DEVICE = contextvars.ContextVar("qcss_bp_device", default="cuda")


@contextlib.contextmanager
def use_device(device):
    """Decoders built inside the block without a ``device`` run on
    ``device`` — for the copied modules (`bp_dem`, `bp_streaming`), which
    build `BPDecoder`s without naming one. Outside any block the default
    is the card."""
    token = _DEVICE.set(device)
    try:
        yield
    finally:
        _DEVICE.reset(token)


def _osde_py(h: np.ndarray, synd: np.ndarray, soft: np.ndarray,
             osd_order: int, lam1: int, lam2: int) -> np.ndarray:
    """Order-E ordered-statistics decode, pure-numpy reference semantics
    (mirrors `native/osd_decoder.cc::qcss_osde_batch`: same stable
    column order, same pivot scan, same candidate enumeration order —
    singles over the first lam1 free columns then pairs over the first
    lam2 — and strict-< acceptance on the soft-weight score, so OSD-0
    wins ties. Soft-weight scores are accumulated in different float
    orders here (numpy dot) vs the C++ (sequential adds), so candidates
    whose scores tie to within float error can legitimately diverge;
    the contract is same enumeration/tie-break RULE and soft-weight
    agreement, not bitwise solution identity — only OSD-0 carries the
    bit-identity guarantee, per CLAUDE.md)."""
    r, n = h.shape
    out = np.zeros((synd.shape[0], n), dtype=np.uint8)
    for bi in range(synd.shape[0]):
        order = np.argsort(soft[bi], kind="stable")
        hp = h[:, order].astype(np.int8)
        aug = np.concatenate([hp, synd[bi][:, None].astype(np.int8)], axis=1)
        piv_cols: list[int] = []
        row = 0
        for c in range(n):
            nz = np.nonzero(aug[row:, c])[0]
            if nz.size == 0:
                continue
            pr = row + int(nz[0])
            if pr != row:
                aug[[row, pr]] = aug[[pr, row]]
            sel = aug[:, c].astype(bool).copy()
            sel[row] = False
            aug[sel] ^= aug[row]
            piv_cols.append(c)
            row += 1
            if row == r:
                break
        rank = len(piv_cols)
        sv = aug[:rank, n].astype(np.uint8)
        if osd_order <= 0 or rank == 0:
            e_ord = np.zeros(n, np.uint8)
            e_ord[piv_cols] = sv
            out[bi, order] = e_ord
            continue
        w_soft = np.abs(soft[bi][order])
        w_piv = w_soft[piv_cols]
        is_piv = np.zeros(n, bool)
        is_piv[piv_cols] = True
        lam_max = max(lam1, lam2)
        free_cols = np.nonzero(~is_piv)[0][:lam_max]
        col_bits = aug[:rank, free_cols].astype(np.uint8)  # [rank, F]
        best = float(w_piv @ sv)
        best_f = (-1, -1)
        cands = [(f, -1) for f in range(min(lam1, free_cols.size))]
        if osd_order >= 2:
            m2 = min(lam2, free_cols.size)
            cands += [(f1, f2) for f1 in range(m2)
                      for f2 in range(f1 + 1, m2)]
        for f1, f2 in cands:
            v = sv ^ col_bits[:, f1]
            w = float(w_soft[free_cols[f1]])
            if f2 >= 0:
                v = v ^ col_bits[:, f2]
                w += float(w_soft[free_cols[f2]])
            w += float(w_piv @ v)
            if w < best:
                best, best_f = w, (f1, f2)
        v = sv.copy()
        e_ord = np.zeros(n, np.uint8)
        for f in best_f:
            if f >= 0:
                v ^= col_bits[:, f]
                e_ord[free_cols[f]] = 1
        e_ord[piv_cols] = v
        out[bi, order] = e_ord
    return out


def _check_major_layout(h: np.ndarray):
    """[r, n] 0/1 matrix -> (chk_var [r, Dc] int32, mask [r, Dc] bool)."""
    r, n = h.shape
    deg = h.sum(axis=1).astype(np.int64)
    dc = int(deg.max())
    chk_var = np.zeros((r, dc), dtype=np.int32)
    mask = np.zeros((r, dc), dtype=bool)
    for c in range(r):
        sup = np.nonzero(h[c])[0]
        chk_var[c, : sup.size] = sup
        mask[c, : sup.size] = True
    return chk_var, mask


# -- device OSD ---------------------------------------------------------


def _osd_eliminate(h_t: torch.Tensor, synd: torch.Tensor, soft: torch.Tensor,
                   C: int):
    """Batched GF(2) elimination of OSD over the first ``C`` columns of
    each shot's stable ascending order of ``soft``, on the tensors'
    device.

    h_t [n, r] uint8, synd [B, r], soft [B, n] float32. Each shot's
    system is packed into int64 words along its sorted columns, with the
    syndrome as bit C. Column c takes as pivot the first row not yet a
    pivot that holds it, and is cleared from every other row
    (Gauss-Jordan). The pivot columns are the greedy independent set in
    sorted order whatever rows are chosen, and the solution on them is
    unique, so it equals the host loop's, which swaps rows. Only the first
    C columns are eliminated: a shot whose rank is not reached within them
    can fail its syndrome check, and the callers re-solve it on the host.

    Returns (order [B, C] int64, aug [B, r, W] int64 reduced systems,
    prs [B, C] pivot row of each sorted column, hass [B, C] bool whether
    it is a pivot, e_sorted [B, C] uint8 the OSD-0 solution in sorted
    coordinates)."""
    n, r = h_t.shape
    B = synd.shape[0]
    device = synd.device
    W = (C + 1 + 63) // 64
    order = torch.sort(soft, dim=1, stable=True).indices[:, :C]
    shifts = torch.arange(64, device=device, dtype=torch.int64)
    words = []
    for w in range(W):
        idx = order[:, w * 64:(w + 1) * 64]                   # [B, <=64]
        bits = h_t[idx].to(torch.int64)                       # [B, <=64, r]
        word = (bits << shifts[: idx.shape[1], None]).sum(1)  # [B, r]
        if w == C // 64:   # the syndrome rides as bit C
            word = word | (synd.to(torch.int64) << (C % 64))
        words.append(word)
    aug = torch.stack(words, dim=2)                           # [B, r, W]
    rows = torch.arange(r, device=device)
    ar = torch.arange(B, device=device)
    marked = torch.zeros((B, r), dtype=torch.bool, device=device)
    prs = torch.zeros((B, C), dtype=torch.int64, device=device)
    hass = torch.zeros((B, C), dtype=torch.bool, device=device)
    for c in range(C):
        w, b = divmod(c, 64)
        colbit = ((aug[:, :, w] >> b) & 1).to(torch.bool)
        active = colbit & ~marked
        has = active.any(dim=1)
        pr = active.to(torch.uint8).argmax(dim=1)             # first True
        is_pr = rows[None, :] == pr[:, None]
        elim = colbit & ~is_pr & has[:, None]
        prow = aug[ar, pr, w:]                                # [B, W - w]
        aug[:, :, w:] ^= (-elim.to(torch.int64))[:, :, None] & prow[:, None]
        marked |= is_pr & has[:, None]
        prs[:, c] = pr
        hass[:, c] = has
    sw, sb = divmod(C, 64)
    sbit = (aug[:, :, sw] >> sb) & 1                          # [B, r]
    e_sorted = torch.where(hass, sbit.gather(1, prs), 0).to(torch.uint8)
    return order, aug, prs, hass, e_sorted


def _scatter_check(h_t, synd, order, e_sorted):
    """Sorted-coordinate solutions back to variable order, and whether
    each satisfies its syndrome."""
    e = torch.zeros((synd.shape[0], h_t.shape[0]), dtype=torch.uint8,
                    device=synd.device)
    e.scatter_(1, order, e_sorted)
    ok = (gf2_torch.mod2_matmul(e, h_t) == synd.to(torch.uint8)).all(dim=1)
    return e, ok


def _osd0_solve(h_t, synd, soft, C: int):
    """Batched OSD-0 on the device: ([B, n] uint8 estimates, [B] bool
    syndrome satisfied). Bit-identical to the host loop where ``ok``."""
    order, _, _, _, e_sorted = _osd_eliminate(h_t, synd, soft, C)
    return _scatter_check(h_t, synd, order, e_sorted)


def _osde_solve(h_t, synd, soft, C: int, osd_order: int, lam1: int,
                lam2: int):
    """Batched order-E OSD on the device: `_osd_eliminate`, then
    `_osde_py`'s sweep — singles over the first lam1 free columns, pairs
    over the first lam2 (osd_order >= 2), least soft weight wins with
    strict-< acceptance (OSD-0 keeps ties) and the first minimum among
    candidates. Flipping free column f changes the pivot solution by f's
    reduced bits at the pivot rows, read from the reduced systems, so no
    second elimination runs. All candidates lie in the first C sorted
    columns whenever max(lam1, lam2) <= C - rank. Float summation order
    differs from the host's, so near-tie candidates may differ; with no
    candidate at all this is OSD-0 (the reference's device sweep raises
    there)."""
    order, aug, prs, hass, e_sorted = _osd_eliminate(h_t, synd, soft, C)
    lam2 = lam2 if osd_order >= 2 else 0
    L = max(lam1, lam2)
    n_cand = lam1 + lam2 * (lam2 - 1) // 2
    if n_cand == 0:
        return _scatter_check(h_t, synd, order, e_sorted)
    B, r, W = aug.shape
    cols = torch.arange(C, device=aug.device)
    w_sorted = soft.gather(1, order).abs().to(torch.float32)   # [B, C]
    w_piv = torch.where(hass, w_sorted, 0.0)
    base = (w_piv * e_sorted).sum(dim=1)
    # the first L free columns in sorted order, and their weights
    key = torch.where(hass, C + cols, cols)
    fc = torch.sort(key, dim=1).values[:, :L]                   # [B, L]
    exists = fc < C
    fc = torch.where(exists, fc, 0)
    wf = w_sorted.gather(1, fc)
    # each candidate column's reduced bits at the pivot rows: [B, C, L]
    piv_rows = aug.gather(1, prs[:, :, None].expand(B, C, W))
    cw = piv_rows.gather(2, (fc // 64)[:, None, :].expand(B, C, L))
    v = ((cw >> (fc % 64)[:, None, :]) & 1).to(torch.uint8)
    v = v & hass[:, :, None].to(torch.uint8)
    e3 = e_sorted[:, :, None]
    scores, f1s, f2s = [], [], []
    if lam1:
        s = (w_piv[:, :, None] * (e3 ^ v[:, :, :lam1])).sum(dim=1)
        scores.append(torch.where(exists[:, :lam1], wf[:, :lam1] + s, 3e38))
        f1s += range(lam1)
        f2s += [-1] * lam1
    for j in range(lam2 - 1):
        vk = v[:, :, j + 1:lam2]
        s = (w_piv[:, :, None] * (e3 ^ v[:, :, j:j + 1] ^ vk)).sum(dim=1)
        s = wf[:, j:j + 1] + wf[:, j + 1:lam2] + s
        ok_jk = exists[:, j:j + 1] & exists[:, j + 1:lam2]
        scores.append(torch.where(ok_jk, s, 3e38))
        f1s += [j] * (lam2 - 1 - j)
        f2s += range(j + 1, lam2)
    scores = torch.cat(scores, dim=1)                           # [B, n_cand]
    best = scores.argmin(dim=1)                                 # first min
    improve = scores.gather(1, best[:, None])[:, 0] < base
    f1 = torch.as_tensor(f1s, device=aug.device)[best]
    f2 = torch.as_tensor(f2s, device=aug.device)[best]
    has2 = f2 >= 0
    f2c = torch.where(has2, f2, 0)
    vsel = v.gather(2, f1[:, None, None].expand(B, C, 1))[:, :, 0]
    v2 = v.gather(2, f2c[:, None, None].expand(B, C, 1))[:, :, 0]
    vsel = vsel ^ torch.where(has2[:, None], v2, 0).to(torch.uint8)
    e_new = e_sorted ^ vsel
    c1 = fc.gather(1, f1[:, None])[:, 0]
    c2 = fc.gather(1, f2c[:, None])[:, 0]
    e_new = e_new | (cols[None, :] == c1[:, None]).to(torch.uint8)
    e_new = e_new | ((cols[None, :] == c2[:, None])
                     & has2[:, None]).to(torch.uint8)
    e_final = torch.where(improve[:, None], e_new, e_sorted)
    return _scatter_check(h_t, synd, order, e_final)


def _osd0_py(h: np.ndarray, synd: np.ndarray, soft: np.ndarray) -> np.ndarray:
    """Order-0 ordered-statistics decode, the Python loop and the
    reference semantics: sort columns most suspect first (ascending LLR,
    stable), GF(2)-eliminate to the first independent column set, solve
    with all other variables at 0."""
    r, n = h.shape
    out = np.zeros((synd.shape[0], n), dtype=np.uint8)
    words = (n + 1 + 63) // 64
    for bi in range(synd.shape[0]):
        order = np.argsort(soft[bi], kind="stable")
        bits = np.concatenate(
            [h[:, order], synd[bi][:, None]], axis=1)
        bits = np.pad(bits, ((0, 0), (0, words * 64 - bits.shape[1])))
        aug = np.ascontiguousarray(
            np.packbits(bits, axis=1, bitorder="little")).view(np.uint64)
        piv_rows: list[int] = []
        piv_cols: list[int] = []
        row = 0
        for c in range(n):
            w, b = divmod(c, 64)
            colbit = (aug[row:, w] >> np.uint64(b)) & np.uint64(1)
            nz = np.nonzero(colbit)[0]
            if nz.size == 0:
                continue
            pr = row + int(nz[0])
            if pr != row:
                aug[[row, pr]] = aug[[pr, row]]
            sel = ((aug[:, w] >> np.uint64(b)) & np.uint64(1)).astype(bool)
            sel[row] = False
            aug[sel] ^= aug[row]
            piv_rows.append(row)
            piv_cols.append(c)
            row += 1
            if row == r:
                break
        sw, sb = divmod(n, 64)
        e_ord = np.zeros(n, dtype=np.uint8)
        for pr, pc in zip(piv_rows, piv_cols):
            e_ord[pc] = (aug[pr, sw] >> np.uint64(sb)) & np.uint64(1)
        out[bi, order] = e_ord
    return out


def _osd0_host(h, synd, soft) -> np.ndarray:
    """OSD-0 on the host: the native kernel (`native/osd_decoder.cc`,
    bit-identical) when it builds, else `_osd0_py`."""
    from qcss_tpu_torch import native

    synd = np.ascontiguousarray(synd, np.uint8)
    soft = np.ascontiguousarray(soft, np.float32)
    res = native.osd0_batch_native(h, synd, soft)
    return _osd0_py(h, synd, soft) if res is None else res


def _osde_host(h, synd, soft, osd_order: int, lam1: int,
               lam2: int) -> np.ndarray:
    """Order-E sweep on the host (`_osde_py`'s semantics): the native
    kernel when it builds."""
    from qcss_tpu_torch import native

    synd = np.ascontiguousarray(synd, np.uint8)
    soft = np.ascontiguousarray(soft, np.float32)
    res = native.osde_batch_native(h, synd, soft, osd_order, lam1, lam2)
    if res is None:
        res = _osde_py(h, synd, soft, osd_order, lam1, lam2)
    return res


def _osd_tail(h: np.ndarray, synd: torch.Tensor, soft: torch.Tensor, *,
              backend: str = "device", sweep: tuple | None = None,
              h_t: torch.Tensor | None = None):
    """OSD of a batch of shots: [b, r] uint8 syndromes and [b, n] float32
    LLRs on one device -> ([b, n] uint8 estimates on that device, the
    backend that ran, the shots solved on the host).

    ``sweep`` = (osd_order, lam1, lam2) runs the order-E sweep, None
    OSD-0. ``backend`` 'device' eliminates on the tensors' device over the
    first C = min(n, r + 256) sorted columns, in chunks of a memory budget
    (chunks change no output), and re-solves on the host the shots whose
    rank is not reached within them; 'host' solves every shot on the host
    (native kernels); 'auto' takes the device once the elimination work
    b * r * C exceeds 2^31 bit operations. A sweep with a lambda above 256
    runs on the host: its candidates need not lie within the first C
    columns. ``h_t``, h transposed on the device, saves its upload."""
    r, n = h.shape
    b = synd.shape[0]
    dev = synd.device
    C = min(n, r + 256)
    if backend == "auto":
        backend = "device" if b * r * C > (1 << 31) else "host"
    if sweep is not None and max(sweep[1:]) > 256:
        backend = "host"

    def host(s, f):
        s, f = s.cpu().numpy(), f.cpu().numpy()
        e = _osd0_host(h, s, f) if sweep is None else _osde_host(h, s, f,
                                                                 *sweep)
        return torch.as_tensor(e, device=dev)

    if backend == "host" or b == 0:
        return host(synd, soft), "host", b
    if h_t is None:
        h_t = torch.as_tensor(h.T.copy(), device=dev)
    chunk = min(8192, max(64, _OSD_CHUNK_BITS // (r * C)))
    es, oks = [], []
    for lo in range(0, b, chunk):
        s, f = synd[lo:lo + chunk], soft[lo:lo + chunk]
        e, ok = (_osd0_solve(h_t, s, f, C) if sweep is None
                 else _osde_solve(h_t, s, f, C, *sweep))
        es.append(e)
        oks.append(ok)
    e, ok = torch.cat(es), torch.cat(oks)
    bad = torch.nonzero(~ok).flatten()
    if bad.numel():
        e[bad] = host(synd[bad], soft[bad])
    return e, "device", int(bad.numel())


@contextlib.contextmanager
def _tf32_off():
    """Dense totals are real-valued sums: keep TF32 off so the card's
    messages do not drift from the CPU's."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


class BPDecoder:
    """Batched normalized-min-sum BP with optional OSD fallback.

    Parameters
    ----------
    h : [r, n] binary check matrix (redundant rows welcome — they help).
    priors : scalar or [n] prior error probability per variable, in (0, .5).
    logicals : optional [k, n] binary observable rows; enables
        `decode_obs`.
    iters : max BP iterations (the loop exits early when every shot in
        the batch has satisfied its syndrome).
    alpha : min-sum normalization factor.
    osd : apply OSD-0 to non-converged shots in `decode_batch` /
        `decode_obs`. ``osd='always'`` runs OSD-0 on every shot and keeps
        the lower-prior-weight solution — guards against min-sum
        converging to a wrong-class higher-weight estimate on 4-cycle-rich
        graphs (e.g. hypergraph products).
    layout : 'auto' (default), 'dense', or 'gather' — how variable totals
        are computed ('dense': one float32 matmul against the 0/1 slot
        incidence; 'gather': per-variable static gathers, for
        circuit-level Tanner graphs whose dense incidence would not fit).
        'auto' switches to 'gather' past 2^26 incidence entries. The two
        layouts differ only in float32 summation order.
    osd_backend : 'auto' (default), 'host', or 'device' — where OSD-0
        elimination runs. 'device' is the batched elimination on the
        decoder's device, bit-identical to the host loop; 'auto' picks it
        once the tail's elimination work exceeds 2^31 bit operations.
    gamma : min-sum message damping in [0, 1) (memory-BP).
    restarts, restart_jitter : perturbed re-decodes of the unconverged
        tail, the prior LLRs scaled by uniform jitter in [1 - j, 1 + j]
        drawn from a generator seeded 0xB9C0 + k on the device.
    osd_order, osd_lambda : order-E combination sweep (0 = OSD-0) over the
        first lam1 (singles) and lam2 (pairs) free columns.
    device : where BP runs: the card by default (or the device of an
        enclosing `use_device` block); pass 'cpu' for the plain CPU run.
    """

    def __init__(self, h, priors, *, logicals=None, iters: int = 64,
                 alpha: float = 0.8, osd: bool = True,
                 layout: str = "auto", osd_backend: str = "auto",
                 gamma: float = 0.0, restarts: int = 0,
                 restart_jitter: float = 0.12,
                 osd_order: int = 0, osd_lambda: tuple = (16, 10),
                 device=None):
        self.h = np.ascontiguousarray(np.asarray(h, dtype=np.uint8) & 1)
        self.r, self.n = self.h.shape
        priors = np.broadcast_to(np.asarray(priors, np.float64), (self.n,))
        if np.any(priors <= 0.0) or np.any(priors >= 0.5):
            raise ValueError("priors must lie in (0, 0.5)")
        self.priors = priors.copy()
        self.iters = int(iters)
        self.alpha = float(alpha)
        if not 0.0 <= gamma < 1.0:
            raise ValueError("gamma must lie in [0, 1)")
        self.gamma = float(gamma)
        self.restarts = int(restarts)
        self.restart_jitter = float(restart_jitter)
        self.osd_order = int(osd_order)
        self.osd_lambda = (int(osd_lambda[0]), int(osd_lambda[1]))
        if osd not in (True, False, "always"):
            raise ValueError(f"osd must be True/False/'always', got {osd!r}")
        self.osd = osd
        if osd_backend not in ("auto", "host", "device"):
            raise ValueError(f"unknown osd_backend {osd_backend!r}")
        self.osd_backend = osd_backend
        self.logicals = (None if logicals is None else
                         np.asarray(logicals, dtype=np.uint8) & 1)
        self.device = resolve_device(_DEVICE.get() if device is None
                                     else device)
        dev = self.device

        chk_var, mask = _check_major_layout(self.h)
        self.dc = dc = chk_var.shape[1]
        self._chk_flat = torch.as_tensor(chk_var.reshape(-1),
                                         dtype=torch.int64, device=dev)
        self._mask = torch.as_tensor(mask, device=dev)
        if layout not in ("auto", "dense", "gather"):
            raise ValueError(f"unknown layout {layout!r}")
        self._use_gather = (layout == "gather" or (
            layout == "auto" and self.r * dc * self.n > (1 << 26)))
        if self._use_gather:
            var_slots: list[list[int]] = [[] for _ in range(self.n)]
            flat_vars = chk_var.reshape(-1)
            flat_mask = mask.reshape(-1)
            for sl in np.nonzero(flat_mask)[0]:
                var_slots[int(flat_vars[sl])].append(int(sl))
            dv = max(1, max(len(s) for s in var_slots))
            vs = np.zeros((self.n, dv), dtype=np.int64)
            vm = np.zeros((self.n, dv), dtype=bool)
            for v, slots in enumerate(var_slots):
                vs[v, : len(slots)] = slots
                vm[v, : len(slots)] = True
            self._var_slot = torch.as_tensor(vs.reshape(-1), device=dev)
            self._var_mask = torch.as_tensor(vm, device=dev)
            self._dv = dv
        else:
            scat = np.zeros((self.r * dc, self.n), dtype=np.float32)
            scat[np.arange(self.r * dc), chk_var.reshape(-1)] = mask.reshape(
                -1).astype(np.float32)
            self._scat = torch.as_tensor(scat, device=dev)
        self._lam = torch.as_tensor(
            np.log((1.0 - priors) / priors), dtype=torch.float32, device=dev)
        self._h_t = torch.as_tensor(self.h.T.copy(), device=dev)

    # -- BP --------------------------------------------------------------

    def _bp_chunk(self, synd, lam, stats):
        """synd [b, r] uint8 -> (e_hat [b, n] uint8, conv [b] bool,
        soft [b, n] float32 final LLR totals). ``lam`` [1 or b, n]."""
        b = synd.shape[0]
        r, n, dc = self.r, self.n, self.dc
        dev = self.device
        synd_i = synd.to(torch.int64)
        mask = self._mask[None]
        chk = self._chk_flat
        slot = torch.arange(dc, device=dev)
        alpha = float(np.float32(self.alpha))
        g = float(np.float32(self.gamma))
        omg = float(np.float32(1.0) - np.float32(self.gamma))

        if self._use_gather:
            def totals(m):
                gth = m.reshape(b, r * dc)[:, self._var_slot].reshape(
                    b, n, self._dv)
                return lam + torch.where(self._var_mask, gth, 0.0).sum(dim=2)
        else:
            def totals(m):
                with _tf32_off():
                    return lam + m.reshape(b, r * dc) @ self._scat

        def satisfied(e):
            inc = e[:, chk].reshape(b, r, dc) & mask
            return ((inc.sum(dim=2) & 1) == synd_i).all(dim=1)

        m = torch.zeros((b, r, dc), dtype=torch.float32, device=dev)
        e_fr = torch.zeros((b, n), dtype=torch.bool, device=dev)
        conv = torch.zeros(b, dtype=torch.bool, device=dev)
        soft = lam.expand(b, n).clone()
        i = 0
        while i < self.iters:
            for _ in range(min(_CHECK_EVERY, self.iters - i)):
                nmsg = totals(m)[:, chk].reshape(b, r, dc) - m
                mag = torch.where(mask, nmsg.abs(), _BIG)
                neg = (nmsg < 0) & mask
                par = (neg.sum(dim=2) + synd_i) & 1
                sgn = par.to(torch.bool)[:, :, None] ^ neg
                min1, am = mag.min(dim=2)                      # first min
                hit = slot == am[:, :, None]
                min2 = torch.where(hit, _BIG, mag).amin(dim=2)
                val = torch.where(hit, min2[:, :, None], min1[:, :, None])
                m_new = torch.where(mask, alpha * torch.where(sgn, -val, val),
                                    0.0)
                if self.gamma:
                    m_new = g * m + omg * m_new
                m = m_new
                t_new = totals(m)
                e = t_new < 0
                ok = satisfied(e)
                newly = ok & ~conv
                e_fr = torch.where(newly[:, None], e, e_fr)
                soft = torch.where(newly[:, None], t_new, soft)
                conv = conv | ok
                i += 1
            if bool(conv.all()):
                break
        if stats is not None:
            stats["iters"] = max(stats.get("iters", 0), i)
        # non-converged shots report their final hard decision and LLRs
        t = totals(m)
        e_fr = torch.where(conv[:, None], e_fr, t < 0)
        soft = torch.where(conv[:, None], soft, t)
        return e_fr.to(torch.uint8), conv, soft

    def _synd(self, synd) -> torch.Tensor:
        """Syndromes (numpy or a tensor anywhere) as uint8 on the device."""
        if isinstance(synd, torch.Tensor):
            return synd.to(self.device, torch.uint8)
        return torch.as_tensor(np.asarray(synd, np.uint8), device=self.device)

    def _run(self, synd, lam=None, stats=None):
        """[B, r] syndromes -> (e_hat [B, n] uint8, conv [B] bool, soft
        [B, n] float32), on the device. ``lam`` optionally overrides the
        prior LLRs per shot ([B, n] float32) — the hook for correlated
        two-pass decoding. Decoded in chunks of at most `_BP_CHUNK_BYTES`
        of messages; BP is per shot, so the chunks change nothing.
        ``stats`` (a dict) receives the iterations run, ``iters``."""
        synd = self._synd(synd)
        B = synd.shape[0]
        if lam is not None:
            lam = lam.expand(B, self.n)
        chunk = max(1, _BP_CHUNK_BYTES // (4 * self.r * self.dc))
        outs = []
        for lo in range(0, B, chunk):
            hi = min(B, lo + chunk)
            lam_c = self._lam[None] if lam is None else lam[lo:hi]
            outs.append(self._bp_chunk(synd[lo:hi], lam_c, stats))
        if len(outs) == 1:
            return outs[0]
        return tuple(torch.cat(x) for x in zip(*outs))

    def _run_restarts(self, synd, lam=None, stats=None):
        """`_run` plus up to ``self.restarts`` perturbed re-decodes of the
        unconverged tail, prior LLRs multiplied by uniform jitter in
        [1-restart_jitter, 1+restart_jitter] from a generator seeded
        0xB9C0 + k on the device (the reference seeds JAX keys alike; the
        streams differ, so restarts are compared by rates). Converged
        restarts replace the estimate; restarts=0 is exactly `_run`."""
        synd = self._synd(synd)
        e, conv, soft = self._run(synd, lam, stats)
        if not self.restarts or bool(conv.all()):
            return e, conv, soft
        for k in range(self.restarts):
            idx = torch.nonzero(~conv).flatten()
            if idx.numel() == 0:
                break
            lam_t = (self._lam[None].expand(idx.numel(), self.n)
                     if lam is None
                     else lam.expand(synd.shape[0], self.n)[idx])
            gen = torch.Generator(device=self.device).manual_seed(0xB9C0 + k)
            fac = torch.rand((idx.numel(), self.n), generator=gen,
                             device=self.device)
            j = self.restart_jitter
            fac = (1.0 - j) + (2.0 * j) * fac
            e2, c2, s2 = self._run(synd[idx], lam_t * fac, stats)
            acc = idx[c2]
            e[acc] = e2[c2]
            soft[acc] = s2[c2]
            conv[acc] = True
        return e, conv, soft

    # -- OSD -------------------------------------------------------------

    def _osd0(self, synd: np.ndarray, soft: np.ndarray) -> np.ndarray:
        """Order-0 ordered-statistics decode on the host (`_osd0_host`)."""
        return _osd0_host(self.h, synd, soft)

    def _osd0_on(self, h_aug: np.ndarray, synd: np.ndarray,
                 soft: np.ndarray) -> np.ndarray:
        """OSD-0 on the host against an augmented check matrix (same
        columns, extra constraint rows)."""
        return _osd0_host(h_aug, synd, soft)

    @property
    def _sweep(self):
        """The order-E sweep's (osd_order, lam1, lam2), None for OSD-0."""
        return (self.osd_order, *self.osd_lambda) if self.osd_order else None

    def _osd0_any(self, synd: np.ndarray, soft: np.ndarray,
                  h: np.ndarray | None = None) -> np.ndarray:
        """OSD of numpy shots under the ``osd_backend`` policy
        (`_osd_tail`), OSD-0 or, with ``osd_order``, the order-E sweep.
        `h` optionally overrides the check matrix (gap decoding's
        augmented [h; L_j] systems: same columns, extra rows); those keep
        OSD-0, as in the reference."""
        dev = self.device
        e, _, _ = _osd_tail(
            self.h if h is None else h,
            torch.tensor(np.asarray(synd, np.uint8), device=dev),
            torch.tensor(np.asarray(soft, np.float32), device=dev),
            backend=self.osd_backend,
            sweep=self._sweep if h is None else None,
            h_t=self._h_t if h is None else None)
        return e.cpu().numpy()

    # -- public API --------------------------------------------------------

    def _lam_of(self, priors):
        pb = np.clip(np.asarray(priors, np.float64), 1e-12, 0.499)
        return torch.as_tensor(np.log((1.0 - pb) / pb), dtype=torch.float32,
                               device=self.device)

    def decode_batch(self, synd, priors=None):
        """[B, r] syndromes -> ([B, n] uint8 error estimates,
        [B] bool BP-converged mask), numpy. With `osd=True` non-converged
        shots are replaced by their OSD-0 solution (which always satisfies
        the syndrome), and the converged mask still reports BP's own
        reach. `priors` optionally overrides the per-variable error
        priors per shot ([B, n], in (0, 0.5)) — correlated second passes
        condition them on a first pass's estimates."""
        lam = None if priors is None else self._lam_of(priors)
        synd = self._synd(synd)
        e_hat, conv, soft = self._run_restarts(synd, lam)
        conv_np = conv.cpu().numpy()
        e_np = e_hat.cpu().numpy()
        if not self.osd:
            return e_np, conv_np
        synd_np = synd.cpu().numpy()
        if self.osd == "always":
            # OSD the whole batch and keep the lower-prior-LLR-weight
            # syndrome-satisfying solution (min-sum can converge to a
            # wrong-class higher-weight solution on 4-cycle-rich graphs)
            e_osd = self._osd0_any(synd_np, soft.cpu().numpy())
            lam_p = np.log((1.0 - self.priors) / self.priors)
            take = ~conv_np | (e_osd.astype(np.float64) @ lam_p
                               < e_np.astype(np.float64) @ lam_p)
            e_np[take] = e_osd[take]
        elif not conv_np.all():
            idx = np.nonzero(~conv_np)[0]
            idx_t = torch.as_tensor(idx, device=self.device)
            e_np[idx] = self._osd0_any(synd_np[idx],
                                       soft[idx_t].cpu().numpy())
        return e_np, conv_np

    def posteriors(self, synd, priors=None):
        """[B, r] syndromes -> ([B, n] float32 posterior LLR totals,
        [B] bool BP-converged), numpy. Converged shots report totals
        frozen at first syndrome satisfaction (the values OSD sorts by);
        non-converged shots their final-iteration totals. No OSD."""
        lam = None if priors is None else self._lam_of(priors)
        _, conv, soft = self._run(synd, lam)
        return soft.cpu().numpy(), conv.cpu().numpy()

    def decode_obs(self, synd, priors=None):
        """[B, r] syndromes -> ([B, k] uint8 observable flips, conv)."""
        if self.logicals is None:
            raise ValueError("decoder built without logicals")
        e_hat, conv = self.decode_batch(synd, priors)
        return (e_hat.astype(np.int64)
                @ self.logicals.T.astype(np.int64)) & 1, conv

    def decode_obs_device(self, synd, stats: dict | None = None):
        """Device-resident `decode_obs`: [B, r] syndromes (a device tensor
        welcome) -> ([B, k] uint8 observable flips on the device, [B] conv
        numpy). BP, the observable reduction and the OSD tail stay on the
        device whatever ``osd_backend`` says (`_osd_tail` with the device
        backend, the order-E sweep too): only the conv mask and the rows
        whose rank is not reached within the column cap (re-solved on the
        host) cross to the host. With OSD-0 the results equal
        `decode_obs`'s (the device elimination is bit-identical); the
        order-E sweep may pick another solution of the same soft weight
        where candidates tie within float rounding (`_osde_solve`).

        ``stats``, a dict, receives the wall seconds of BP (``bp_s``) and
        of the OSD tail (``osd_s``, device synchronized around each), the
        BP iterations run (``iters``), the tail's size (``tail``), its
        backend (``tail_backend``), the shots re-solved on the host
        (``host_fallback``), and the tail's system (``tail_inputs``: h and
        the tail's syndromes and LLRs on the device), so that a caller can
        hold the device OSD against the host's on the same shots."""
        if self.logicals is None:
            raise ValueError("decoder built without logicals")
        if self.osd == "always":
            raise ValueError("decode_obs_device supports osd=True/False; "
                             "use decode_obs for the whole-batch "
                             "osd='always' tie-break")
        timed = stats is not None
        dev = self.device
        if timed:
            synchronize(dev)
            t0 = time.perf_counter()
        synd_t = self._synd(synd)
        e, conv, soft = self._run_restarts(synd_t, stats=stats)
        obs_t = torch.as_tensor(self.logicals.T.copy(), device=dev)
        flips = gf2_torch.mod2_matmul(e, obs_t)
        conv_np = conv.cpu().numpy()
        if timed:
            synchronize(dev)
            t1 = time.perf_counter()
            stats.update(bp_s=t1 - t0, osd_s=0.0, tail=0, host_fallback=0,
                         tail_backend=None)
        if not self.osd or conv_np.all():
            return flips, conv_np
        idx = torch.as_tensor(np.nonzero(~conv_np)[0], device=dev)
        synd_tail, soft_tail = synd_t[idx], soft[idx]
        e_tail, backend, n_host = _osd_tail(self.h, synd_tail, soft_tail,
                                            sweep=self._sweep, h_t=self._h_t)
        flips[idx] = gf2_torch.mod2_matmul(e_tail, obs_t)
        if timed:
            synchronize(dev)
            stats.update(osd_s=time.perf_counter() - t1,
                         tail=int(idx.numel()), host_fallback=n_host,
                         tail_backend=backend,
                         tail_inputs={"h": self.h, "synd": synd_tail,
                                      "soft": soft_tail})
        return flips, conv_np

    def decode_obs_gap(self, synd):
        """Soft-output decoding: [B, r] syndromes ->
        ([B, k] observable flips, [B] conv, [B] gap).

        Flips are the standard decode (BP hard decision, OSD-0 tail —
        identical to `decode_obs`). For every logical j the syndrome is
        re-decoded twice under the augmented system [h; L_j] with the
        logical class forced to 0 and to 1 (OSD-0 over BP's soft
        ordering), and ``gap`` is the prior-LLR weight margin of the
        least-confident logical, min_j |w_j(0) - w_j(1)|. Post-selecting
        on ``gap >= tau`` trades abort rate for conditional accuracy."""
        if self.logicals is None:
            raise ValueError("decoder built without logicals")
        synd = self._synd(synd).cpu().numpy()
        e_hat, conv, soft = self._run_restarts(synd)
        soft = soft.cpu().numpy()
        conv = conv.cpu().numpy()
        e_np = e_hat.cpu().numpy()
        if self.osd and not conv.all():
            idx = np.nonzero(~conv)[0]
            e_np[idx] = self._osd0_any(synd[idx], soft[idx])
        flips = ((e_np.astype(np.int64) @ self.logicals.T.astype(np.int64))
                 & 1).astype(np.uint8)
        b = synd.shape[0]
        k = self.logicals.shape[0]
        lam = np.log((1.0 - self.priors) / self.priors)
        gap = np.full(b, np.inf, np.float64)
        for j in range(k):
            h_aug = np.concatenate([self.h, self.logicals[j:j + 1]], axis=0)
            w = np.empty((2, b))
            for cls in (0, 1):
                s_aug = np.concatenate(
                    [synd, np.full((b, 1), cls, np.uint8)], axis=1)
                e = self._osd0_any(s_aug, soft, h=h_aug)
                w[cls] = e.astype(np.float64) @ lam
            gap = np.minimum(gap, np.abs(w[0] - w[1]))
        return flips, conv, gap.astype(np.float32)


def open_window_tanner(h, window: int, p_data: float, p_meas: float):
    """Tanner graph of `window` NOISY detector slices with no terminal
    readout — the mid-stream building block for `bp_streaming`. Variables
    are e_t (fresh data errors before slice t) then m_t (measurement
    flips), t = 0..window-1, with D[t] = H·e_t ^ m_t ^ m_{t-1} and the
    boundary m_{-1} handled by the caller (XORed out of slice 0 as the
    committed carry). Returns (tanner [window*r, window*(n+r)] uint8,
    priors)."""
    h = np.asarray(h, dtype=np.uint8) & 1
    r, n = h.shape
    n_data = window * n
    n_vars = n_data + window * r
    tan = np.zeros((window * r, n_vars), dtype=np.uint8)
    priors = np.empty(n_vars, dtype=np.float64)
    priors[:n_data] = p_data
    priors[n_data:] = p_meas
    eye = np.eye(r, dtype=np.uint8)
    for t in range(window):
        tan[t * r:(t + 1) * r, t * n:(t + 1) * n] = h
        tan[t * r:(t + 1) * r, n_data + t * r:n_data + (t + 1) * r] = eye
        if t > 0:
            tan[t * r:(t + 1) * r, n_data + (t - 1) * r:n_data + t * r] = eye
    return tan, priors


def spacetime_tanner(h, rounds: int, p_data: float, p_meas: float,
                     logicals=None):
    """Phenomenological spacetime Tanner graph for BP decoding.

    Matches the physics of `streaming.sample_phenomenological_stream` /
    `uf.spacetime_graph`: `rounds` noisy extraction rounds (fresh IID
    data errors at rate ``p_data`` before each, measurement flips at rate
    ``p_meas``), one final data layer, then a perfect readout slice.
    Detector (t, c) = syndrome-slice difference; in Tanner form

        D[t] = H · e_t  ^  m_t  ^  m_{t-1}

    with variables e_t (t = 0..rounds, the last the pre-readout layer)
    and m_t (t = 0..rounds-1). Returns (tanner [R', N'] uint8,
    priors [N'], obs [k, N'] or None, n_data_vars) with the observable
    rows acting on every data layer (the decoded flip of L · cumulative
    error)."""
    h = np.asarray(h, dtype=np.uint8) & 1
    r, n = h.shape
    t_layers = rounds + 1
    n_data = t_layers * n
    n_vars = n_data + rounds * r
    rows = t_layers * r
    tan = np.zeros((rows, n_vars), dtype=np.uint8)
    priors = np.empty(n_vars, dtype=np.float64)
    priors[:n_data] = p_data
    priors[n_data:] = p_meas
    for t in range(t_layers):
        tan[t * r:(t + 1) * r, t * n:(t + 1) * n] = h
        if t < rounds:  # m_t in D[t]
            tan[t * r:(t + 1) * r, n_data + t * r:n_data + (t + 1) * r] = (
                np.eye(r, dtype=np.uint8))
        if t > 0:       # m_{t-1} in D[t]
            tan[t * r:(t + 1) * r,
                n_data + (t - 1) * r:n_data + t * r] = np.eye(
                    r, dtype=np.uint8)
    obs = None
    if logicals is not None:
        lg = np.asarray(logicals, dtype=np.uint8) & 1
        obs = np.zeros((lg.shape[0], n_vars), dtype=np.uint8)
        for t in range(t_layers):
            obs[:, t * n:(t + 1) * n] = lg
    return tan, priors, obs, n_data


def bp_phenomenological_error_rate(code, rounds: int, p: float, q: float, *,
                                   batch: int, seed: int = 0,
                                   iters: int = 64, alpha: float = 0.8,
                                   osd: bool = True,
                                   device="cuda") -> dict[str, float]:
    """X-sector phenomenological memory with spacetime BP(+OSD) decoding.

    Samples detector histories with `streaming.sample_phenomenological_stream`
    (IID data-X layers at ``p``, measurement flips at ``q``, perfect final
    readout) against the code's Z checks from a generator on ``device``
    seeded with ``seed``, decodes the full history on the spacetime Tanner
    graph, and scores against the true logical parities."""
    from qcss_tpu_torch.decode.streaming import sample_phenomenological_stream

    device = resolve_device(device)
    # prefer the full redundant set (qLDPC constructors), else the raw
    # pre-reduction rows — the standard-form RREF rows are high-weight
    # and ruin the Tanner graph's sparsity
    h2 = getattr(code, "redundant_parity_check_c2", None)
    if h2 is None:
        h2 = code.raw_parity_check_c2
    lz = code.z_operator_matrix()
    tan, priors, obs, _ = spacetime_tanner(h2, rounds, p, q, logicals=lz)
    dec = BPDecoder(tan, priors, logicals=obs, iters=iters, alpha=alpha,
                    osd=osd, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dets, par = sample_phenomenological_stream(gen, p, q, batch, rounds, h2,
                                               lz)
    flips, conv = dec.decode_obs(dets.reshape(batch, -1).cpu().numpy())
    fail = (flips ^ par.cpu().numpy()).any(axis=1)
    return {
        "x_fail": float(fail.mean()),
        "bp_converged": float(np.asarray(conv).mean()),
        "samples": batch,
        "rounds": rounds,
    }


def bp_logical_error_rate(code, p, *, batch: int, seed: int = 0,
                          iters: int = 64, alpha: float = 0.8,
                          osd: bool = True,
                          device="cuda") -> dict[str, float]:
    """Code-capacity Monte-Carlo with BP(+OSD) decoding of both Pauli
    sectors — `montecarlo.logical_error_rate`'s conventions (X errors
    checked by C2/Z-type rows against logical Z̄; Z errors by C1/X-type
    rows against X̄) for codes the LUT cannot reach, sampled from a
    generator on ``device`` seeded with ``seed``. Uses the redundant
    check sets when the code carries them (qLDPC constructors)."""
    from qcss_tpu_torch.decode.montecarlo import sample_depolarizing

    device = resolve_device(device)
    h1 = getattr(code, "redundant_parity_check_c1", code.parity_check_c1)
    h2 = getattr(code, "redundant_parity_check_c2", code.parity_check_c2)
    prior = 2.0 * p / 3.0  # depolarizing: P(X or Y) per qubit
    dec_x = BPDecoder(h2, prior, logicals=code.z_operator_matrix(),
                      iters=iters, alpha=alpha, osd=osd, device=device)
    dec_z = BPDecoder(h1, prior, logicals=code.x_operator_matrix(),
                      iters=iters, alpha=alpha, osd=osd, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    x_err, z_err = sample_depolarizing(gen, batch, code.n, p)
    syn_x = gf2_torch.syndromes_dense(
        x_err, torch.as_tensor(np.asarray(h2, np.uint8), device=device))
    syn_z = gf2_torch.syndromes_dense(
        z_err, torch.as_tensor(np.asarray(h1, np.uint8), device=device))
    flips_x, conv_x = dec_x.decode_obs(syn_x)
    flips_z, conv_z = dec_z.decode_obs(syn_z)
    x_err, z_err = x_err.cpu().numpy(), z_err.cpu().numpy()
    err_flip_x = (x_err.astype(np.int64)
                  @ code.z_operator_matrix().T.astype(np.int64)) & 1
    err_flip_z = (z_err.astype(np.int64)
                  @ code.x_operator_matrix().T.astype(np.int64)) & 1
    x_fail = (flips_x ^ err_flip_x).any(axis=1)
    z_fail = (flips_z ^ err_flip_z).any(axis=1)
    return {
        "x_fail": float(x_fail.mean()),
        "z_fail": float(z_fail.mean()),
        "word_fail": float((x_fail | z_fail).mean()),
        "bp_converged": float((np.asarray(conv_x)
                               & np.asarray(conv_z)).mean()),
        "samples": batch,
    }
