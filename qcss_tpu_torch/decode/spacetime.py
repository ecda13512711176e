"""Spacetime (detector-graph) decoding for multi-round memory experiments
(PyTorch port of `qcss_tpu.decode.spacetime`).

A memory experiment measures the same checks for R noisy rounds plus one
perfect final readout; *detectors* are the XOR of consecutive syndrome
rounds, so an isolated data error fires one detector slice and an isolated
measurement error fires two adjacent slices.

`spacetime_correction_lut` is the exact minimum-weight lookup over the
phenomenological spacetime fault space (space faults: a data error arising
in round t; time faults: a measurement error in round t), built on the
host with numpy and evaluated on the device as one gather
(`experiments.memory`, ``decoder='stlut'``).
"""

from __future__ import annotations

import numpy as np

from qcss_tpu_torch.ops import gf2


def spacetime_check_matrix(h, rounds: int) -> tuple[np.ndarray, np.ndarray]:
    """Detector/fault incidence for an R-round experiment with perfect
    final readout.

    Returns ``(h_st, fault_qubit)``: ``h_st`` is [(R+1)·r, F] uint8 where
    column f lists the detectors fault f fires; ``fault_qubit[f]`` is the
    data qubit a space fault flips at readout (-1 for time faults).

    Fault order: space faults slice-major (slice 0 qubit 0, ..., slice R
    qubit n-1), then time faults round-major.
    """
    h = np.asarray(h, dtype=np.uint8) & 1
    r, n = h.shape
    slices = rounds + 1
    n_dets = slices * r
    cols: list[np.ndarray] = []
    fault_qubit: list[int] = []
    for t in range(slices):
        for j in range(n):
            col = np.zeros(n_dets, dtype=np.uint8)
            col[t * r + np.nonzero(h[:, j])[0]] = 1
            cols.append(col)
            fault_qubit.append(j)
    for t in range(rounds):
        for c in range(r):
            col = np.zeros(n_dets, dtype=np.uint8)
            col[t * r + c] = 1
            col[(t + 1) * r + c] = 1
            cols.append(col)
            fault_qubit.append(-1)
    h_st = np.stack(cols, axis=1)
    return h_st, np.asarray(fault_qubit, dtype=np.int32)


def spacetime_correction_lut(h, rounds: int, max_weight: int) -> np.ndarray:
    """Dense ``[2^D, n]`` minimum-weight spacetime decode table, D =
    (R+1)·r detector bits: entry s is the final-readout data correction for
    detector history s (XOR of the space-fault qubits of the minimum-weight
    fault set with that detector signature). Unknown histories map to the
    zero correction — the same leave-unchanged semantics as the per-round
    LUT (reference: css_code.py:649-685)."""
    h = np.asarray(h, dtype=np.uint8) & 1
    r, n = h.shape
    n_dets = (rounds + 1) * r
    if n_dets > 20:
        raise ValueError(
            f"{n_dets} detector bits is past LUT range; use the union-find "
            "spacetime decoder (decode.uf.spacetime_graph)"
        )
    h_st, fault_qubit = spacetime_check_matrix(h, rounds)
    table = gf2.min_weight_table(h_st, max_weight)
    # Map fault vectors to data corrections: Q[f, fault_qubit[f]] = 1.
    n_faults = h_st.shape[1]
    q = np.zeros((n_faults, n), dtype=np.uint8)
    space = fault_qubit >= 0
    q[np.nonzero(space)[0], fault_qubit[space]] = 1
    lut = np.zeros((1 << n_dets, n), dtype=np.uint8)
    for key, fault_vec in table.items():
        lut[key] = (fault_vec.astype(np.int64) @ q.astype(np.int64)) & 1
    return lut


def detector_history(syns, final_syn):
    """XOR consecutive syndrome rounds into the detector layout the
    spacetime decoders expect: slices [syn[0], syn[1]^syn[0], ...,
    final ^ syn[R-1]] concatenated slice-major.

    Works on torch tensors or numpy arrays. syns: [R, B, r]; final_syn:
    [B, r] from the perfect final readout. Returns [B, (R+1)*r].
    """
    rounds = syns.shape[0]
    slices = [syns[0]]
    for t in range(1, rounds):
        slices.append(syns[t] ^ syns[t - 1])
    slices.append(final_syn ^ syns[rounds - 1])
    if isinstance(syns, np.ndarray):
        return np.concatenate(slices, axis=-1)
    import torch

    return torch.cat(slices, dim=-1)
