"""The staged routes of the stencil union-find decode (PyTorch port of
`decode_stencil_pallas` and `decode_stencil_pallas_fused` in
`qcss_tpu.decode.device_uf_pallas`).

Both decode what `device_uf.decode_labels` decodes, with the same labels,
but keep the round loop on the host and cross device memory every round:

* `decode_stencil_staged` runs the growth step, the cluster-parity
  scatter and the activity seeds in torch, and per round one propagation
  kernel (`device_uf_cuda.stencil_prop`) and one activity kernel
  (`stencil_act`);
* `decode_stencil_fused` runs one kernel per growth round
  (`stencil_round`: activity spread, growth, propagation) and only the
  parity seeds in torch.

A CUDA tensor goes to the kernels, a CPU tensor to their plain versions
(`device_uf._prop_plain`, `_act_plain`, `_round_plain`). The round loop is
batch-wide and each round ends in one host read, where the whole-decode
kernel stops per shot and reads nothing: `decode_labels` never comes here,
as the reference's never does. Neither takes a graph with spilled lanes.
"""

from __future__ import annotations

import torch

from qcss_tpu_torch.decode import device_uf as duf


def _setup(dg, detectors):
    st = dg.stencil
    if st is None or dg.pack_shift is None:
        raise ValueError("the staged decode requires a stencil-eligible graph")
    if st.chunks:
        raise ValueError("spilled lanes need the whole-decode kernel "
                         "(device_uf.decode_labels)")
    if not isinstance(detectors, torch.Tensor):
        detectors = torch.as_tensor(detectors)
    defect = duf.stencil_defect(dg, detectors)
    B, V = defect.shape
    sup = torch.zeros((B, len(st.deltas) + st.bmask.shape[0], V),
                      dtype=torch.int32, device=defect.device)
    return defect, duf.initial_labels(dg, B, defect.device), sup


def decode_stencil_staged(dg, detectors):
    """Stencil union-find decode with the propagation and activity
    fixpoints as kernels and the rest of a round in torch. Same contract
    as `device_uf.decode_labels`: (labels, converged [B] bool)."""
    defect, packed, sup = _setup(dg, detectors)
    O = len(dg.stencil.deltas)
    if defect.is_cuda:
        from qcss_tpu_torch.decode.device_uf_cuda import (
            stencil_act,
            stencil_prop,
        )

        prop, spread = stencil_prop, stencil_act
    else:
        prop, spread = duf._prop_plain, duf._act_plain
    sups, supbs = sup[:, :O], sup[:, O:]
    act = defect  # round 1: every defect is an odd singleton
    active = bool(act.any())
    i = 0
    while active and i < dg.max_rounds:
        sups, supbs, grew = duf._grow_step(dg, packed, act, sups, supbs)
        satm, satb = duf._saturated(dg, sups, supbs)
        packed = prop(dg, packed, satm.contiguous(), satb.contiguous())
        act = spread(dg, duf.parity_seeds(dg, packed, defect),
                     duf._cluster_passes(dg, packed, satm))
        active = bool(act.any() & grew.any())  # the round's one host read
        i += 1
    return duf._stencil_labels(dg, defect, packed, act)


def decode_stencil_fused(dg, detectors):
    """Stencil union-find decode with one kernel per growth round; only
    the cluster-parity seeds and the loop stay in torch. Same contract as
    `device_uf.decode_labels`: (labels, converged [B] bool)."""
    defect, packed, sup = _setup(dg, detectors)
    O = len(dg.stencil.deltas)
    if defect.is_cuda:
        from qcss_tpu_torch.decode.device_uf_cuda import stencil_round

        step = stencil_round
    else:
        def step(dg, packed, seed, sup):
            packed, sups, supbs, grew = duf._round_plain(
                dg, packed, seed, sup[:, :O], sup[:, O:])
            return packed, torch.cat([sups, supbs], dim=1), grew
    seed = defect  # round 1: every defect is an odd singleton root
    active = bool(seed.any())
    i = 0
    while active and i < dg.max_rounds:
        packed, sup, grew = step(dg, packed, seed, sup)
        seed = duf.parity_seeds(dg, packed, defect)
        active = bool(seed.any() & grew.any())  # the round's one host read
        i += 1
    return duf._stencil_labels(dg, defect, packed, seed)


def round_inputs(dg, defect: torch.Tensor, rounds: int) -> list[dict]:
    """The inputs of the staged kernels in each of the first ``rounds``
    growth rounds of `decode_stencil_fused`, walked with the plain pieces
    from stencil defects [B, V]: the state entering the round (``packed``,
    ``seed``, ``sup`` [B, O+KB, V]: K5's input), K4's ``passes``, and K3's
    masks ``satm``, ``satb`` after the round's growth step. For the kernels'
    tests and benchmarks."""
    B, V = defect.shape
    O = len(dg.stencil.deltas)
    KB = dg.stencil.bmask.shape[0]
    packed = duf.initial_labels(dg, B, defect.device)
    sup = torch.zeros((B, O + KB, V), dtype=torch.int32,
                      device=defect.device)
    seed = defect
    out = []
    for _ in range(rounds):
        satm, _ = duf._saturated(dg, sup[:, :O], sup[:, O:])
        passes = duf._cluster_passes(dg, packed, satm).contiguous()
        act = duf._act_plain(dg, seed, passes)
        sups, supbs, _ = duf._grow_step(dg, packed, act, sup[:, :O],
                                        sup[:, O:])
        satm, satb = duf._saturated(dg, sups, supbs)
        out.append({"packed": packed, "seed": seed, "sup": sup,
                    "passes": passes, "satm": satm.contiguous(),
                    "satb": satb.contiguous()})
        packed, sups, supbs, _ = duf._round_plain(dg, packed, seed,
                                                  sup[:, :O], sup[:, O:])
        sup = torch.cat([sups, supbs], dim=1).contiguous()
        seed = duf.parity_seeds(dg, packed, defect)
    return out
