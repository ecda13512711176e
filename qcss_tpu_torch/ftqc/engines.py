"""Block-level tableau engines for the macro-op FTQC executor (PyTorch
port of `qcss_tpu.ftqc.engines`).

The macro executor manipulates whole code blocks (prep networks,
transversal layers, block measurements, Pauli-frame injections). This
module provides that block-level interface over two state
representations:

* `UnpackedEngine` — byte-per-bit tableaus (`sim.tableau`); blocks are
  contiguous qubit ranges of length n. Right for small codes
  (Steane-scale), where packing overhead outweighs its wins.
* `PackedEngine` — 32-bit-word tableaus (`sim.tableau_packed`) with
  word-aligned blocks: block b occupies words [b*Wb, (b+1)*Wb), so
  transversal layers between blocks are pure word-wide XOR/AND ops. Its
  block measurement is K9 (`sim.cuda_measure`) for a tableau on the card
  and the scan for one on the CPU.

Both expose the same method set. Block indices are host ints; randomness
comes from a `torch.Generator` where the reference takes a key, and the
measurement and reset methods also take explicit collapse bits
(``rand_bits`` [B, n]). Noiseless, with the same collapse bits, the two
engines give identical states on every block operation. Under noise a
block circuit draws the frame sampler's fault bits in both engines
(`noise.sampled_fault_bits`); the transversal channels draw as the
reference's engines do (uniforms in the unpacked engine, 32-bit words
against float32 thresholds in the packed one).

`FrameEngine` (the Pauli-frame engine) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from qcss_tpu_torch.decode.montecarlo import _threshold
from qcss_tpu_torch.ops import gf2_torch
from qcss_tpu_torch.sim import cuda_measure
from qcss_tpu_torch.sim import noise as noise_mod
from qcss_tpu_torch.sim import tableau as tb
from qcss_tpu_torch.sim import tableau_packed as tp

WORD = 32
_NOT_PORTED = ("the frame engine is not ported yet (ROADMAP.md, queue 1, "
               "slice 6: FrameEngine needs frame.run_compiled_noisy_multi, "
               "the qubits= window and inject1_many/inject2_many)")


class UnpackedEngine:
    """Blocks are contiguous [b*n, (b+1)*n) qubit ranges, byte-per-bit."""

    def __init__(self, n: int, n_blocks: int, noise: noise_mod.NoiseModel):
        self.n = n
        self.n_blocks = n_blocks
        self.noise = noise
        self.stride = n

    def block_qubits(self, b: int) -> list[int]:
        return [int(b) * self.stride + i for i in range(self.n)]

    def zero_state(self, batch: int, device="cuda") -> tb.Tableau:
        return tb.zero_state(batch, self.n_blocks * self.stride, device)

    def select(self, mask, new, old):
        return tb.select(mask, new, old)

    def reset_block(self, tab, b, generator=None, *, rand_bits=None):
        return tb.reset_many(tab, self.block_qubits(b), generator,
                             rand_bits=rand_bits)

    def run_block_circuit(self, tab, arrays, b, generator=None):
        """Run a block-local circuit (qubit indices in [0, n)) on block b,
        with per-gate depolarizing noise."""
        ops, q0, q1 = arrays
        off = int(b) * self.stride
        return noise_mod.run_arrays_noisy(
            tab, ops, np.asarray(q0) + off, np.asarray(q1) + off,
            self.noise, generator)

    def measure_block(self, tab, b, generator=None, *, rand_bits=None):
        return tb.measure_many(tab, self.block_qubits(b), generator,
                               rand_bits=rand_bits)

    def transversal_cnot(self, tab, b_ctrl, b_tgt, generator=None):
        qc, qt = self.block_qubits(b_ctrl), self.block_qubits(b_tgt)
        tab = tb.apply_cnot_many(tab, qc, qt)
        if self.noise.p_gate2:
            tab = noise_mod.depolarize2_many(tab, qc, qt, self.noise.rate2,
                                             generator)
        return tab

    def transversal_1q(self, tab, gate: str, b, generator=None):
        fn = {"H": tb.apply_h_many, "S": tb.apply_s_many,
              "X": tb.apply_x_many, "Z": tb.apply_z_many}[gate]
        q = self.block_qubits(b)
        tab = fn(tab, q)
        if self.noise.p_gate1:
            tab = noise_mod.depolarize1_many(tab, q, self.noise.rate1,
                                             generator)
        return tab

    def transversal_cz(self, tab, b0, b1, generator=None):
        qa, qb = self.block_qubits(b0), self.block_qubits(b1)
        tab = tb.apply_cz_many(tab, qa, qb)
        if self.noise.p_gate2:
            tab = noise_mod.depolarize2_many(tab, qa, qb, self.noise.rate2,
                                             generator)
        return tab

    def pauli_inject(self, tab, b, x_row, z_row, mask):
        """Masked logical-Pauli application: flips along the operator's
        support at block b (signs only)."""
        m = mask.to(torch.uint8)[:, None]
        x_row = torch.as_tensor(x_row, device=tab.x.device).to(torch.uint8)
        z_row = torch.as_tensor(z_row, device=tab.x.device).to(torch.uint8)
        return tb.inject_flips(tab, self.block_qubits(b), m * x_row[None, :],
                               m * z_row[None, :])

    def depolarize_block(self, tab, b, p, generator):
        return noise_mod.depolarize1_many(tab, self.block_qubits(b), p,
                                          generator)

    def inject_block_flips(self, tab, b, x_flips, z_flips):
        """Per-sample [B, n] Pauli flips on block b (noise injection)."""
        return tb.inject_flips(tab, self.block_qubits(b), x_flips, z_flips)

    def inject_data_flips(self, tab, x_flips, z_flips):
        """[B, m, n] Pauli flips on the first m blocks at once (the idle
        channel's injection point; data blocks are the block prefix)."""
        B, m, n = x_flips.shape
        pad = tab.n - m * self.stride
        xf = torch.nn.functional.pad(x_flips.reshape(B, m * n), (0, pad))
        zf = torch.nn.functional.pad(z_flips.reshape(B, m * n), (0, pad))
        return tb.apply_pauli_frame(tab, xf, zf)


class PackedEngine:
    """Word-aligned packed blocks: block b owns words [b*Wb, (b+1)*Wb)."""

    def __init__(self, n: int, n_blocks: int, noise: noise_mod.NoiseModel):
        self.n = n
        self.n_blocks = n_blocks
        self.noise = noise
        self.wb = (n + WORD - 1) // WORD  # words per block
        self.stride = self.wb * WORD      # qubits per block slot (padded)

    def block_qubits(self, b: int) -> list[int]:
        return [int(b) * self.stride + i for i in range(self.n)]

    def zero_state(self, batch: int, device="cuda") -> tp.PackedTableau:
        return tp.zero_state(batch, self.n_blocks * self.stride, device)

    def select(self, mask, new, old):
        return tp.select(mask, new, old)

    def reset_block(self, tab, b, generator=None, *, rand_bits=None):
        return tp.reset_many(tab, self.block_qubits(b), generator,
                             rand_bits=rand_bits)

    # -- packed noise helpers -------------------------------------------------

    def _words(self, b: int) -> slice:
        off = int(b) * self.wb
        return slice(off, off + self.wb)

    def _inject_packed(self, tab, b, xw, zw):
        """xw/zw: [B, Wb] packed flips for block b."""
        xf = torch.zeros((tab.batch, tab.words), dtype=torch.int32,
                         device=tab.x.device)
        zf = torch.zeros_like(xf)
        xf[:, self._words(b)] = gf2_torch.words32(xw)
        zf[:, self._words(b)] = gf2_torch.words32(zw)
        return tp.apply_pauli_frame(tab, xf, zf)

    def inject_block_flips(self, tab, b, x_flips, z_flips):
        return self._inject_packed(tab, b, gf2_torch.pack_bits(x_flips),
                                   gf2_torch.pack_bits(z_flips))

    def inject_data_flips(self, tab, x_flips, z_flips):
        """[B, m, n] flips on the first m blocks (idle injection): pack
        per block (blocks are word-aligned), place at word offset 0."""
        B, m, n = x_flips.shape
        pad = tab.words - m * self.wb
        xw = gf2_torch.words32(gf2_torch.pack_bits(x_flips)).reshape(B, -1)
        zw = gf2_torch.words32(gf2_torch.pack_bits(z_flips)).reshape(B, -1)
        return tp.apply_pauli_frame(
            tab, torch.nn.functional.pad(xw, (0, pad)),
            torch.nn.functional.pad(zw, (0, pad)))

    def _depolarize_block(self, tab, b, p, generator):
        """The 1q channel on every qubit of block b: 32-bit words against
        the float32 thresholds, as the reference's packed engine draws."""
        u = torch.randint(0, 1 << 32, (tab.batch, self.n),
                          generator=generator, device=generator.device,
                          dtype=torch.int64)
        x_hi, z_lo, z_hi = noise_mod._thresholds_1q(p)
        t1, t2, t3 = _threshold(z_lo), _threshold(x_hi), _threshold(z_hi)
        return self.inject_block_flips(tab, b, u < t2, (u >= t1) & (u < t3))

    def _depolarize_pair_blocks(self, tab, b0, b1, p, generator):
        if isinstance(p, tuple):
            # biased (twirled-decoherence) rates act independently per qubit
            tab = self._depolarize_block(tab, b0, p, generator)
            return self._depolarize_block(tab, b1, p, generator)
        x1, z1, x2, z2 = noise_mod._hits_2q(generator, (tab.batch, self.n), p)
        tab = self.inject_block_flips(tab, b0, x1, z1)
        return self.inject_block_flips(tab, b1, x2, z2)

    # -- circuits and measurement ---------------------------------------------

    def run_block_circuit(self, tab, arrays, b, generator=None):
        """A block-local circuit on block b with per-gate depolarizing
        noise: the frame sampler's fault bits, each gate's flipping the
        signs of the rows that anticommute with them."""
        ops, q0, q1 = arrays
        off = int(b) * self.stride
        q0 = np.asarray(q0) + off
        q1 = np.asarray(q1) + off
        nv = self.noise
        if nv.is_trivial or not (nv.p_gate1 or nv.p_gate2):
            return tp.run_circuit_scanned(tab, ops, q0, q1)
        ops, q0, q1 = tb.host_qubits(ops), tb.host_qubits(q0), \
            tb.host_qubits(q1)
        bits = noise_mod.sampled_fault_bits(ops, nv, generator, tab.batch)
        t = tab.clone()
        x, z, r = t.x, t.z, t.r
        for g, (op, a, b_q) in enumerate(zip(ops, q0, q1)):
            tp._apply_op(x, z, r, op, a, b_q)
            touched = [a, b_q] if op >= noise_mod._TWO_Q_START else [a]
            for k, q in enumerate(touched):
                w, bit = divmod(q, WORD)
                xf = bits[:, 4 * g + 2 * k, None]
                zf = bits[:, 4 * g + 2 * k + 1, None]
                r ^= (xf & tp._bit(z[:, :, w], bit).to(torch.uint8)) \
                    ^ (zf & tp._bit(x[:, :, w], bit).to(torch.uint8))
        return t

    def measure_block(self, tab, b, generator=None, *, rand_bits=None):
        """Measure block b's qubits in order: K9 for a tableau on the card,
        the scan for one on the CPU (`cuda_measure.measure_many_fused`)."""
        return cuda_measure.measure_many_fused(
            tab, self.block_qubits(b), generator, rand_bits)

    # -- transversal word-ops: the packing payoff -----------------------------

    @staticmethod
    def _parity_words(words) -> torch.Tensor:
        return (gf2_torch.popcount32(words).sum(-1) & 1).to(torch.uint8)

    def transversal_cnot(self, tab, b_ctrl, b_tgt, generator=None):
        sc, st = self._words(b_ctrl), self._words(b_tgt)
        xc, zc = tab.x[:, :, sc], tab.z[:, :, sc]
        xt, zt = tab.x[:, :, st], tab.z[:, :, st]
        # per-position sign rule xc & zt & ~(xt ^ zc); block padding bits
        # are zero in xc/zt, so the complement's padding ones are masked
        r = tab.r ^ self._parity_words(xc & zt & ~(xt ^ zc))
        x, z = tab.x.clone(), tab.z.clone()
        x[:, :, st] = xt ^ xc
        z[:, :, sc] = zc ^ zt
        tab = tab.replace(x=x, z=z, r=r)
        if self.noise.p_gate2:
            tab = self._depolarize_pair_blocks(tab, b_ctrl, b_tgt,
                                               self.noise.rate2, generator)
        return tab

    def transversal_1q(self, tab, gate: str, b, generator=None):
        s = self._words(b)
        xw, zw = tab.x[:, :, s], tab.z[:, :, s]
        if gate == "H":
            x, z = tab.x.clone(), tab.z.clone()
            x[:, :, s], z[:, :, s] = zw, xw
            tab = tab.replace(x=x, z=z,
                              r=tab.r ^ self._parity_words(xw & zw))
        elif gate == "S":
            z = tab.z.clone()
            z[:, :, s] = zw ^ xw
            tab = tab.replace(z=z, r=tab.r ^ self._parity_words(xw & zw))
        elif gate == "X":
            tab = tab.replace(r=tab.r ^ self._parity_words(zw))
        elif gate == "Z":
            tab = tab.replace(r=tab.r ^ self._parity_words(xw))
        else:
            raise ValueError(gate)
        if self.noise.p_gate1:
            tab = self._depolarize_block(tab, b, self.noise.rate1, generator)
        return tab

    def transversal_cz(self, tab, b0, b1, generator=None):
        s0, s1 = self._words(b0), self._words(b1)
        xa, za = tab.x[:, :, s0], tab.z[:, :, s0]
        xb, zb = tab.x[:, :, s1], tab.z[:, :, s1]
        r = tab.r ^ self._parity_words(xa & xb & (za ^ zb))
        z = tab.z.clone()
        z[:, :, s0] = za ^ xb
        z[:, :, s1] = z[:, :, s1] ^ xa
        tab = tab.replace(z=z, r=r)
        if self.noise.p_gate2:
            tab = self._depolarize_pair_blocks(tab, b0, b1, self.noise.rate2,
                                               generator)
        return tab

    def pauli_inject(self, tab, b, x_row, z_row, mask):
        m = mask.to(torch.int32)[:, None]
        xw = gf2_torch.words32(gf2_torch.pack_bits(
            torch.as_tensor(x_row, device=tab.x.device)))
        zw = gf2_torch.words32(gf2_torch.pack_bits(
            torch.as_tensor(z_row, device=tab.x.device)))
        return self._inject_packed(tab, b, xw[None, :] * m, zw[None, :] * m)

    def depolarize_block(self, tab, b, p, generator):
        return self._depolarize_block(tab, b, p, generator)


class FrameEngine:
    """The Pauli-frame engine of the reference (`sim.frame` state behind
    the block interface). Not ported yet: constructing one raises."""

    def __init__(self, n: int, n_blocks: int, noise: noise_mod.NoiseModel):
        raise NotImplementedError(_NOT_PORTED)


def make_engine(kind: str, n: int, n_blocks: int,
                noise) -> UnpackedEngine | PackedEngine:
    if kind == "unpacked":
        return UnpackedEngine(n, n_blocks, noise)
    if kind == "packed":
        return PackedEngine(n, n_blocks, noise)
    if kind == "frames":
        return FrameEngine(n, n_blocks, noise)
    raise ValueError(f"unknown tableau engine {kind!r}")
