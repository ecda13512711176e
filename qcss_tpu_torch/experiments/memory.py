"""Circuit-level quantum-memory experiment (PyTorch port of `qcss_tpu.experiments.memory`).

Hold a logical |0̄⟩ (or |+̄⟩) for R rounds, each round running the actual
syndrome-extraction circuit (one ancilla per check, CNOT fan-in, ancilla
measurement + reset) under circuit-level Pauli noise, then read the data
out and decode.

Ported: both engines, Pauli-frame sampling (``engine='frames'``) and the
batched stabilizer tableau (``engine='tableau'``), with

* the fused device decoders: detector assembly, union-find on the device
  (``decoder='device-dem'`` on the circuit-level DEM graph,
  ``'device-uf'`` on the phenomenological spacetime graph) and failure
  counting, with only two scalars read back by the host;
* the LUT decoders on the device: ``'vote'`` (temporal majority per
  syndrome bit, one LUT decode), ``'difference'`` (each round's new
  detection events decoded independently, corrections XORed) and
  ``'stlut'`` (minimum-weight decode over the full spacetime fault set,
  one gather), which also count the residual syndromes;
* the host decoders: the detectors are assembled on the device and read
  back once with the readout word, then decoded on the host with
  corrections — union-find (``'uf'`` on the phenomenological spacetime
  graph, ``'dem'`` on the circuit-level DEM graph) or exact matching
  (``'mwpm'``, ``'dem-mwpm'``) — which also count the residual syndromes.

The two engines consume the noise generator identically (per round: the
circuit's fault bits, then the measurement flips, then the reset flips),
and the tableau draws its measurement collapse bits from a second
generator that the frames path never reads. So at the same seed they
sample the same faults and give bit-identical counts, as the reference's
engines do.
"""

from __future__ import annotations

import numpy as np
import torch

from qcss_tpu_torch._cuda import resolve_device
from qcss_tpu_torch.circuits.ir import Circuit
from qcss_tpu_torch.decode.lut import decode_corrections
from qcss_tpu_torch.decode.multiround import vote_syndromes
from qcss_tpu_torch.decode.spacetime import (
    detector_history,
    spacetime_correction_lut,
)
from qcss_tpu_torch.ops import gf2_torch
from qcss_tpu_torch.sim import frame as fr
from qcss_tpu_torch.sim import noise as noise_mod
from qcss_tpu_torch.sim import tableau as tb


def z_extraction_circuit(code, data_offset: int = 0, anc_offset: int | None = None,
                         checks: np.ndarray | None = None) -> Circuit:
    """One round of Z-check syndrome extraction: CNOT(data_j -> anc_i) for
    every 1 in row i of the Z-check matrix (ancilla i measures stabilizer
    Z-row i when read in the Z basis after the CNOT fan-in).

    ``checks`` defaults to the standard-form matrix (LUT decoders key on
    it); the union-find path passes ``code.raw_parity_check_c2`` because
    matching needs the local, pre-row-reduction stabilizers."""
    checks = code.parity_check_c2 if checks is None else np.asarray(checks)
    n = code.n
    anc_offset = n if anc_offset is None else anc_offset
    circ = Circuit()
    for i in range(checks.shape[0]):
        for j in np.nonzero(checks[i])[0]:
            circ.cnot(data_offset + int(j), anc_offset + i)
    return circ


def x_extraction_circuit(code, data_offset: int = 0, anc_offset: int | None = None,
                         checks: np.ndarray | None = None) -> Circuit:
    """One round of X-check syndrome extraction, the mirror of
    `z_extraction_circuit`: H(anc_i); CNOT(anc_i -> data_j) fan-out;
    H(anc_i) — ancilla i then Z-measures stabilizer X-row i. The CNOT
    order matches `decode.dem.extraction_gate_list` (Z errors on data
    propagate target→control into the ancilla with the same incidence and
    timing structure as X errors do in the Z-sector circuit, so the DEM
    enumeration applies unchanged)."""
    checks = code.parity_check_c1 if checks is None else np.asarray(checks)
    n = code.n
    anc_offset = n if anc_offset is None else anc_offset
    circ = Circuit()
    for i in range(checks.shape[0]):
        circ.h(anc_offset + i)
    for i in range(checks.shape[0]):
        for j in np.nonzero(checks[i])[0]:
            circ.cnot(anc_offset + i, data_offset + int(j))
    for i in range(checks.shape[0]):
        circ.h(anc_offset + i)
    return circ


def _memory_circuit_frames(generator, batch, rounds, code, noise,
                           extract_arrays, n_anc, final_arrays=None,
                           extract_comp=None):
    """Pauli-frame sampling of R noisy extraction rounds and a perfect
    final readout, on the generator's device. The noiseless reference is
    deterministic (every ancilla measures a stabilizer of the prepared
    eigenstate), so only fault frames propagate. Per round the generator
    is drawn in the order circuit noise, measurement flips, reset flips.
    ``extract_comp`` (the matrix form) and the per-gate engine consume it
    identically. Returns (syns [R, B, n_anc], word [B, n]) uint8."""
    n = code.n
    device = generator.device
    anc = torch.arange(n, n + n_anc, device=device)
    data = torch.arange(n, device=device)
    f = fr.zero_frames(batch, n + n_anc, device)
    syns = []
    for _ in range(rounds):  # the reference's lax.scan over rounds
        if extract_comp is not None:
            f = fr.run_compiled_noisy(f, extract_comp, noise, generator)
        else:
            f = fr.run_arrays_noisy(f, *extract_arrays, noise, generator)
        f, syn = fr.measure_deviations(f, anc, generator, noise.p_meas)
        f = fr.reset_qubits(f, anc, generator, noise.p_reset)
        syns.append(syn)
    if final_arrays is not None:
        # noiseless basis rotation before the perfect readout
        # (transversal H for an X-basis memory)
        f = fr.propagate_arrays(f, *final_arrays)
    _, word = fr.measure_deviations(f, data)
    return torch.stack(syns), word


def _memory_circuit(generator, collapse, batch, rounds, code, noise,
                    prep_arrays, extract_arrays, n_anc, final_arrays=None):
    """The physics on the batched tableau: noiseless eigenstate prep, R
    noisy extraction rounds, perfect final readout (preceded by a
    noiseless basis rotation when ``final_arrays`` is given), on the
    generator's device. Noise is drawn from ``generator`` in the frames
    path's order; measurement collapse bits from ``collapse``. Returns
    (syns [R, B, n_anc], word [B, n]) uint8."""
    n = code.n
    n_qubits = n + n_anc
    device = generator.device
    anc = list(range(n, n + n_anc))
    t = tb.zero_state(batch, n_qubits, device)
    t = tb.run_circuit_scanned(t, *prep_arrays)
    syns = []
    for _ in range(rounds):  # the reference's lax.scan over rounds
        t = noise_mod.run_arrays_noisy(t, *extract_arrays, noise, generator)
        t, syn = tb.measure_many(t, anc, collapse)
        if noise.p_meas:
            syn = noise_mod.flip_bits(syn, noise.p_meas, generator)
        t = tb.reset_many(t, anc, collapse)
        if noise.p_reset:
            # the frame path's reset draw (`frame.reset_qubits`)
            xf = torch.zeros((batch, n_qubits), dtype=torch.uint8,
                             device=device)
            xf[:, n:] = (torch.rand((batch, n_anc), generator=generator,
                                    device=device) < noise.p_reset
                         ).to(torch.uint8)
            t = tb.apply_pauli_frame(t, xf, torch.zeros_like(xf))
        syns.append(syn)
    if final_arrays is not None:
        t = tb.run_circuit_scanned(t, *final_arrays)
    _, word = tb.measure_many(t, range(n), collapse)
    return torch.stack(syns), word


def _collapse_generator(seed: int, device) -> torch.Generator:
    """The tableau engine's generator of collapse bits: seeded from
    ``seed`` but independent of the noise generator's stream."""
    state = np.random.SeedSequence([seed, 1]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def _memory_fused_device(sample, extract_arrays, n_anc, decode_fn, log_row,
                         raw_t, final_arrays=None):
    """Sample AND decode on the device: circuit sampling (``sample``, one
    engine's sampler bound to its generators and settings), detector
    assembly, batched union-find and failure counting. Returns two device
    scalars (failures, all-converged)."""
    syns, word = sample(extract_arrays, n_anc=n_anc,
                        final_arrays=final_arrays)
    final_syn = gf2_torch.syndromes_dense(word, raw_t)
    dets = detector_history(syns, final_syn)
    obs, conv = decode_fn(dets)
    outcome = (word.to(torch.int32) * log_row.to(torch.int32)).sum(dim=-1) & 1
    fails = (outcome ^ (obs & 1)).to(torch.int32)
    return fails.sum(), conv.all()


def _decode_vote(syns, word, lut, h_std):
    """Temporal-majority decoding: vote each syndrome bit across rounds,
    one LUT decode. Sound for at most one data error over the experiment."""
    return decode_corrections(vote_syndromes(syns), lut)


def _decode_difference(syns, word, lut, h_std):
    """Difference-syndrome decoding: decode each round's NEW detection
    events (syn[r] ^ syn[r-1]) independently and XOR the corrections.

    A data error arising in round r appears in exactly one difference and
    is corrected once; a measurement error at round r flips differences r
    and r+1, so its two (identical, deterministic-LUT) corrections cancel
    under XOR. The final readout supplies the exact end syndrome, closing
    the last difference window."""
    prev = torch.zeros_like(syns[0])
    corr = torch.zeros_like(word)
    for r in range(syns.shape[0]):
        corr = corr ^ decode_corrections(syns[r] ^ prev, lut)
        prev = syns[r]
    final_syn = gf2_torch.syndromes_dense(word, h_std)
    return corr ^ decode_corrections(final_syn ^ prev, lut)


def _count_failures(word, corr, dev, basis: str = "z"):
    """Logical failures and shots with a residual syndrome, as device
    scalars. ``dev`` holds the code's tensors on the word's device. For
    basis='x' the readout word is the post-H (X-basis) data word, so the
    observable is X̄ and the residual check matrix is the C1 sector."""
    corrected = word ^ corr
    log_row = dev.logical_z[0] if basis == "z" else dev.logical_x[0]
    h_std = dev.h2 if basis == "z" else dev.h1
    outcome = (corrected.to(torch.int32) * log_row.to(torch.int32)
               ).sum(dim=-1) & 1
    resid = gf2_torch.syndromes_dense(corrected, h_std)
    return {"logical_fail": outcome.sum(dtype=torch.int64),
            "residual_syndrome": (resid == 1).any(dim=-1)
            .sum(dtype=torch.int64)}


def _decode_counts(syns, word, dev, decoder, stlut=None, basis="z"):
    """The LUT decoders on sampled (syns [R, B, r], word [B, n]): the
    decode half of the reference's `_memory_body`."""
    h_std = dev.h2 if basis == "z" else dev.h1
    if decoder == "stlut":
        dets = detector_history(syns, gf2_torch.syndromes_dense(word, h_std))
        corr = stlut[gf2_torch.bits_to_index(dets).to(torch.int64)]
    else:
        lut = dev.lut_c2 if basis == "z" else dev.lut_c1
        corr = {"vote": _decode_vote, "difference": _decode_difference}[
            decoder](syns, word, lut, h_std)
    return _count_failures(word, corr, dev, basis)


_LUT_DECODERS = ("vote", "difference", "stlut")
_FUSED_DECODERS = ("device-uf", "device-dem")
_HOST_DECODERS = ("uf", "dem", "mwpm", "dem-mwpm")


def memory_experiment(code, *, rounds: int, noise: noise_mod.NoiseModel,
                      basis: str = "z",
                      batch: int = 1 << 12, seed: int = 0,
                      decoder: str = "vote",
                      stlut_max_weight: int = 4,
                      n_threads: int | None = None,
                      engine: str = "tableau",
                      device="cuda") -> dict[str, float]:
    """Run the logical memory experiment in the given basis, sampling and
    decoding on ``device`` (the card unless the caller asks for the CPU).

    basis='z': hold |0̄⟩, extract Z checks, decode X data errors.
    basis='x': the mirror — hold |+̄⟩, extract X checks via H-sandwich
    ancillas (`x_extraction_circuit`), decode Z data errors, read out X̄
    after a noiseless transversal H.

    ``engine='frames'`` (Pauli-frame propagation) or
    ``engine='tableau'`` (the batched stabilizer tableau), each with
    ``decoder='device-dem'``, ``'device-uf'``, ``'vote'``,
    ``'difference'``, ``'stlut'``, or a host decoder: ``'uf'``,
    ``'dem'``, ``'mwpm'`` or ``'dem-mwpm'`` (``n_threads`` sets the host
    union-find's threads). The noise is drawn from a
    `torch.Generator` on ``device`` seeded with ``seed``, identically in
    both engines, so at one seed they give bit-identical counts; the
    tableau's collapse bits come from a second generator derived from
    ``seed``. Raises RuntimeError if a union-find shot did not converge.
    """
    if noise.p_idle:
        raise ValueError(
            "memory_experiment does not model idle noise (p_idle would be "
            "silently ignored)")
    if decoder not in _FUSED_DECODERS + _LUT_DECODERS + _HOST_DECODERS:
        raise ValueError(f"unknown decoder {decoder!r}")
    if engine not in ("tableau", "frames"):
        raise ValueError(f"unknown engine {engine!r}")
    if basis not in ("z", "x"):
        raise ValueError(f"unknown basis {basis!r}")
    if decoder == "vote" and rounds % 2 == 0:
        raise ValueError("rounds must be odd for the temporal vote")
    device = resolve_device(device)
    ext_fn = z_extraction_circuit if basis == "z" else x_extraction_circuit
    final_arrays = None
    if basis == "x":
        fin = Circuit()
        for q in range(code.n):
            fin.h(q)
        final_arrays = fin.to_arrays()
    generator = torch.Generator(device=device).manual_seed(seed)
    if engine == "frames":
        def sample(extract_arrays, n_anc, final_arrays):
            comp = fr.maybe_compile(extract_arrays, code.n + n_anc)
            return _memory_circuit_frames(
                generator, batch, rounds, code, noise, extract_arrays,
                n_anc=n_anc, final_arrays=final_arrays,
                extract_comp=None if comp is None else comp.to(device))
    else:
        prep_arrays = (code.noisy_encode_zero() if basis == "z"
                       else code.noisy_encode_plus()).to_arrays()
        collapse = _collapse_generator(seed, device)

        def sample(extract_arrays, n_anc, final_arrays):
            return _memory_circuit(
                generator, collapse, batch, rounds, code, noise, prep_arrays,
                extract_arrays, n_anc=n_anc, final_arrays=final_arrays)
    if decoder in _HOST_DECODERS:
        fails, resid = _memory_host(code, rounds, noise, basis, decoder,
                                    n_threads, ext_fn, final_arrays, device,
                                    sample)
    else:
        run = _memory_lut if decoder in _LUT_DECODERS else _memory_union_find
        fails, resid = run(code, rounds, noise, basis, decoder,
                           stlut_max_weight, ext_fn, final_arrays, device,
                           sample)
    return {
        "logical_fail": fails / batch,
        "residual_syndrome": resid / batch,
        "rounds": rounds,
        "samples": batch,
        "decoder": decoder,
        "basis": basis,
    }


def _circuit_graph(code, rounds, noise, raw, logicals, dem: bool):
    """The matching graph of the union-find and matching decoders: the
    circuit-level DEM graph (``dem``) or the phenomenological spacetime
    graph, over the raw checks ``raw``."""
    if dem:
        from qcss_tpu_torch.decode.dem import (
            circuit_level_graph,
            extraction_gate_list,
        )

        return circuit_level_graph(
            raw, extraction_gate_list(code, raw), rounds,
            p_gate2=noise.p_gate2, p_meas=noise.p_meas,
            p_reset=noise.p_reset, logicals=logicals,
            rate2=noise.pauli2,
        )
    from qcss_tpu_torch.decode.uf import spacetime_graph

    return spacetime_graph(raw, logicals, rounds)


def _count_failures_host(word, corr, code, basis: str = "z"):
    """The reference's logical/residual accounting on numpy arrays (its
    `_count_failures` given numpy): the residual syndrome is read with the
    raw checks the host decoders match on."""
    corrected = word ^ corr
    log_row = (code.z_operator_matrix() if basis == "z"
               else code.x_operator_matrix())[0]
    raw = (code.raw_parity_check_c2 if basis == "z"
           else code.raw_parity_check_c1)
    outcome = (corrected.astype("int32") * log_row.astype("int32")
               ).sum(axis=-1) & 1
    resid = (corrected.astype(np.int64) @ np.asarray(raw).T.astype(np.int64)
             ) & 1
    return (int(outcome.sum()), int((resid == 1).any(axis=-1).sum()))


def _memory_host(code, rounds, noise, basis, decoder, n_threads, ext_fn,
                 final_arrays, device, sample):
    """The host decoders over the samples of ``sample``: the detectors are
    assembled on ``device`` and read back once with the readout word, then
    decoded with corrections on the host — union-find (``'uf'``, ``'dem'``)
    or exact matching (``'mwpm'``, ``'dem-mwpm'``). Returns (failures,
    shots with a residual syndrome)."""
    from qcss_tpu_torch.decode.mwpm import MWPMDecoder
    from qcss_tpu_torch.decode.uf import UFDecoder

    raw = (code.raw_parity_check_c2 if basis == "z"
           else code.raw_parity_check_c1)
    logicals = (code.z_operator_matrix() if basis == "z"
                else code.x_operator_matrix())
    syns, word = sample(ext_fn(code, checks=raw).to_arrays(),
                        n_anc=raw.shape[0], final_arrays=final_arrays)
    raw_t = torch.as_tensor(np.asarray(raw, np.uint8), device=device)
    dets = detector_history(syns, gf2_torch.syndromes_dense(word, raw_t))
    dets, word = dets.cpu().numpy(), word.cpu().numpy()
    graph = _circuit_graph(code, rounds, noise, raw, logicals,
                           decoder.startswith("dem"))
    if decoder.endswith("mwpm"):
        corr, _ = MWPMDecoder(graph).decode_batch(dets)
    else:
        corr, _ = UFDecoder(graph).decode_batch(dets, n_threads=n_threads)
    return _count_failures_host(word, corr, code, basis)


def _memory_union_find(code, rounds, noise, basis, decoder,
                       stlut_max_weight, ext_fn, final_arrays, device,
                       sample):
    """The fused device decoders on ``device`` over the samples of
    ``sample``: (failures, NaN). Observable-only decoders never
    materialize corrections, so no residual-syndrome accounting exists
    for them."""
    from qcss_tpu_torch.decode.device_uf import make_obs_decoder

    raw = (code.raw_parity_check_c2 if basis == "z"
           else code.raw_parity_check_c1)
    logicals = (code.z_operator_matrix() if basis == "z"
                else code.x_operator_matrix())
    extract_arrays = ext_fn(code, checks=raw).to_arrays()
    graph = _circuit_graph(code, rounds, noise, raw, logicals,
                           decoder == "device-dem")
    decode_fn = make_obs_decoder(graph, device=device)
    fails, conv = _memory_fused_device(
        sample, extract_arrays, n_anc=raw.shape[0], decode_fn=decode_fn,
        log_row=torch.as_tensor(np.asarray(logicals[0]), device=device),
        raw_t=torch.as_tensor(np.asarray(raw, np.uint8), device=device),
        final_arrays=final_arrays)
    if not bool(conv):
        raise RuntimeError("device union-find hit its growth cap")
    return int(fails), float("nan")


def _memory_lut(code, rounds, noise, basis, decoder, stlut_max_weight,
                ext_fn, final_arrays, device, sample):
    """The LUT decoders on ``device`` over the samples of ``sample``, with
    the standard-form checks (the LUTs key on them): (failures, shots
    with a residual syndrome), read back together."""
    dev = code.device.to(device)
    std_checks = code.parity_check_c2 if basis == "z" else code.parity_check_c1
    lut = dev.lut_c2 if basis == "z" else dev.lut_c1
    if decoder in ("vote", "difference") and lut is None:
        raise ValueError("code has no LUT for this sector; pass "
                         "max_table_weight")
    stlut = None
    if decoder == "stlut":
        stlut = torch.as_tensor(spacetime_correction_lut(
            std_checks, rounds, stlut_max_weight), device=device)
    syns, word = sample(ext_fn(code).to_arrays(), n_anc=std_checks.shape[0],
                        final_arrays=final_arrays)
    counts = _decode_counts(syns, word, dev, decoder, stlut, basis)
    fails, resid = torch.stack(
        [counts["logical_fail"], counts["residual_syndrome"]]).tolist()
    return fails, resid


def z_memory_experiment(code, **kwargs) -> dict[str, float]:
    """Back-compat alias: `memory_experiment(basis='z')`."""
    return memory_experiment(code, basis="z", **kwargs)


def x_memory_experiment(code, **kwargs) -> dict[str, float]:
    """The |+̄⟩ (X-basis) memory: `memory_experiment(basis='x')`."""
    return memory_experiment(code, basis="x", **kwargs)
