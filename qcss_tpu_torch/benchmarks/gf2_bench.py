"""Times of the packed kernels K6 (`syndromes_packed`) and K8
(`decode_residual_packed`) on the card, at the shapes the main paths give
them and at a small batch (their fixed cost).

For each shape it measures, by CUDA events:

* ``ms``: the `cuda_gf2.*_cuda` wrapper back to back (checks, `torch.empty`
  and the ctypes call included), as `chip_smoke.py` times every kernel;
  ``host_ms``, the host's time per wrapper call;
* ``hot_ms``: device time a launch of the bare C entry point on
  preallocated outputs, from a CUDA graph of launches on one buffer (the
  inputs stay in the 50 MB L2 where they fit);
* ``cold_ms`` (at the main paths' batches): the same graph, its launches
  taken in turn over copies of the inputs and outputs that together exceed
  three times the L2, so that each launch finds its data in device memory.
  The kernel is judged against its bound on this one;
* ``plain_ms``, the plain version, and ``library_ms``: for K6 the dense
  matmul form on the unpacked bits (`gf2_torch.syndromes_dense`), none for
  K8;

beside the kernel's bound: each input byte read once and each output
byte written once at 3.35 TB/s, or the integer instructions (one LOP3 per
word, a popcount and one or two to place the bit per shot and row; K8
one XOR per word more) at 64 lanes an SM and clock, whichever is longer.
The kernel's output is held against its plain version (and K6's against
the dense form) first.

    python -m qcss_tpu_torch.benchmarks.gf2_bench [--reps N]

prints one JSON line per shape, the card's name and power limit last.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from qcss_tpu_torch import _cuda
from qcss_tpu_torch.benchmarks.profiling import (
    bound,
    cuda_ms,
    graph_ms,
    host_ms,
    int_ops_per_s,
)
from qcss_tpu_torch.codes import families
from qcss_tpu_torch.ops import cuda_gf2, gf2, gf2_torch

HEADLINE_BATCH = 1 << 22
D11_BATCH = 1 << 20
SMALL_BATCH = 1 << 10
L2_BYTES = 50 << 20


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def _words(bits: torch.Tensor) -> torch.Tensor:
    return gf2_torch.words32(gf2_torch.pack_bits(bits))


def _bits(gen, B: int, n: int, p: float) -> torch.Tensor:
    return (torch.rand((B, n), generator=gen, device=gen.device) < p
            ).to(torch.uint8)


def shapes(dev, seed: int = 11) -> list[dict]:
    """The four shapes, each at its main path's batch and at SMALL_BATCH:
    K8 on Steane and on Golay, K6 on the headline's residual check (one
    logical row), K6 at d=11. Inputs: Steane and Golay errors at 2% bits,
    as a round's errors look; random bits at d=11 (and for Golay's uniform
    gather). K6's cases carry their unpacked bits for the dense form."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    steane, golay = families.steane(), families.golay()
    d11 = families.rotated_surface(11).parity_check_c2

    def table(a):
        return torch.as_tensor(a, dtype=torch.uint8, device=dev)

    hs = table(steane.parity_check_c2)
    ls = _words(table(gf2.correction_lut(steane.parity_check_c2,
                                         steane.c2_syndromes)))
    hg = table(golay.parity_check_c2)
    lg = _words(table(gf2.correction_lut(golay.parity_check_c2,
                                         golay.c2_syndromes)))
    lz, h11 = table(steane.z_operator_matrix()), table(d11)
    out = []
    for B in (HEADLINE_BATCH, SMALL_BATCH):
        out.append({"name": "K8 Steane", "kernel": "K8", "B": B,
                    "args": (_words(_bits(gen, B, steane.n, 0.02)),
                             _words(hs), ls)})
        out.append({"name": "K8 Golay", "kernel": "K8", "B": B,
                    "args": (_words(_bits(gen, B, golay.n, 0.02)),
                             _words(hg), lg)})
        bits = _bits(gen, B, steane.n, 0.02)
        out.append({"name": "K6 headline residual check", "kernel": "K6",
                    "B": B, "args": (_words(bits), _words(lz)),
                    "dense": (bits, lz)})
        if B == HEADLINE_BATCH:
            # random words index Golay's 2048 LUT rows uniformly: the
            # gather's shared-memory bank conflicts, against the 2% words
            # above whose index is mostly 0 (a broadcast)
            out.append({"name": "K8 Golay, uniform LUT rows", "kernel": "K8",
                        "B": B, "args": (_words(_bits(gen, B, 32, 0.5)),
                                         _words(hg), lg)})
        Bd = D11_BATCH if B == HEADLINE_BATCH else B
        bits = _bits(gen, Bd, h11.shape[1], 0.5)
        out.append({"name": "K6 d=11", "kernel": "K6", "B": Bd,
                    "args": (_words(bits), _words(h11)),
                    "dense": (bits, h11)})
    return out


def measure(case: dict, reps: int, ops_per_s: float) -> dict:
    lib = _cuda.load()
    e, h = case["args"][:2]
    B, W = e.shape
    R = h.shape[0]
    if case["kernel"] == "K8":
        lut = case["args"][2]

        def bare_on(e, out):
            return lambda: _cuda.check(lib.qcss_decode_residual_packed(
                e.data_ptr(), h.data_ptr(), lut.data_ptr(), B, W, R,
                out.data_ptr(), torch.cuda.current_stream().cuda_stream),
                "qcss_decode_residual_packed")

        new_out = lambda: torch.empty_like(e)
        wrap = lambda: cuda_gf2.decode_residual_packed_cuda(e, h, lut)
        plain = lambda: cuda_gf2.decode_residual_packed_plain(e, h, lut)
        library = None
        nbytes = 4 * (2 * B * W + R * W + lut.numel())
        ops = B * (R * (W + 3) + W)
    else:
        def bare_on(e, out):
            return lambda: _cuda.check(lib.qcss_syndromes_packed(
                e.data_ptr(), h.data_ptr(), B, W, R, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream),
                "qcss_syndromes_packed")

        new_out = lambda: torch.empty((B, R), dtype=torch.uint8,
                                      device=e.device)
        wrap = lambda: cuda_gf2.syndromes_packed_cuda(e, h)
        plain = lambda: cuda_gf2.syndromes_packed_plain(e, h)
        library = lambda: gf2_torch.syndromes_dense(*case["dense"])
        nbytes = 4 * B * W + 4 * R * W + B * R
        ops = B * R * (W + 2)
    out = new_out()
    bare = bare_on(e, out)
    bare()
    want = plain()
    if not torch.equal(out, want) or (
            library is not None and not torch.equal(library(), want)):
        raise RuntimeError(f"{case['name']} B={B}: the kernel, its plain "
                           f"version and the dense form disagree")
    row = {"name": case["name"], "B": B, "R": R, "W": W,
           "ms": cuda_ms(wrap, reps), "host_ms": host_ms(wrap, reps),
           "hot_ms": graph_ms([bare], reps), "cold_ms": None,
           "plain_ms": cuda_ms(plain, 3),
           "library_ms": cuda_ms(library, 10) if library else None}
    if B >= D11_BATCH:
        copies = [bare_on(e.clone(), new_out())
                  for _ in range(-(-3 * L2_BYTES // nbytes))]
        for launch in copies:
            launch()
        row["cold_ms"] = graph_ms(copies, reps)
        del copies
    row["bound_ms"], row["bound_by"] = bound(nbytes, ops, ops_per_s)
    return row


def run(reps: int = 200, seed: int = 11,
        ops_per_s: float | None = None) -> list[dict]:
    if not torch.cuda.is_available():
        raise RuntimeError("gf2_bench times the card's kernels: no CUDA "
                           "device")
    ops_per_s = ops_per_s or int_ops_per_s()
    return [measure(c, reps, ops_per_s)
            for c in shapes(torch.device("cuda"), seed)]


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args()
    for row in run(args.reps, args.seed):
        print(json.dumps(row), flush=True)
    print(card(), flush=True)
