"""Belief-matching: joint-graph BP posteriors reweight the matching pass
(PyTorch port of `qcss_tpu.decode.belief`).

The two-sector matching pipeline (`decode.dem2` + `experiments.memory_xz`)
decomposes every compound fault into independent elementary edges and
recovers X<->Z correlations only through the two-pass cheap-edge
heuristic. The joint BP decoder (`bp_dem.build_joint_circuit_tanner`)
keeps the exact channel — every CNOT's 15 exclusive Pauli patterns, Y
atoms exciting both sectors as single variables — but hands back BP's
hard decisions, which inherit min-sum's fragility on trapping sets.

Belief-matching composes the two stages (Higgott, Bohdanowicz, Kubica,
Flammia, Campbell — "belief-matching", arXiv:2203.04948):

1. run normalized min-sum BP on the exact JOINT fault Tanner graph
   (posterior marginals, convergence NOT required), on the device;
2. project each fault variable's posterior onto the matching edges of
   its per-sector decomposition:  q_e = 1 - prod_{v: e in dec(v)} (1 - p_v),
   on the device (`_shot_weights_kernel`);
3. decode each sector's matching graph on the host with per-shot integer
   weights w_e = round(scale * -log q_e) via the union-find kernel's
   ``shot_weights`` override.

Matching guarantees a syndrome-consistent correction on every shot (BP
alone does not), while the weights carry the joint-channel information
matching alone cannot represent: hook correlations, Y-type X<->Z
coupling, and neighbouring-defect context. Decomposition exactness is
asserted structurally at build time: every variable's edge set XORs back
to its own detector signature and observable effect, per sector.

Only the [B, E] uint8 weights cross from the device to the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from qcss_tpu_torch._cuda import resolve_device, synchronize
from qcss_tpu_torch.decode.bp import BPDecoder
from qcss_tpu_torch.decode.bp_dem import build_joint_circuit_tanner
from qcss_tpu_torch.decode.dem2 import _decompose_into_edges, build_two_sector_dem
from qcss_tpu_torch.decode.uf import UFDecoder


def _edge_var_table(var_lists, n_edges, sentinel):
    """[E, Dv] int32 padded table: edge e's slots hold the variables whose
    decomposition contains e (with multiplicity); padding points at the
    sentinel variable (posterior 0)."""
    per_edge: list[list[int]] = [[] for _ in range(n_edges)]
    for v, edges in enumerate(var_lists):
        for e in edges:
            per_edge[e].append(v)
    dv = max(1, max(len(s) for s in per_edge))
    tab = np.full((n_edges, dv), sentinel, dtype=np.int32)
    for e, vs in enumerate(per_edge):
        tab[e, : len(vs)] = vs
    return tab


def _shot_weights_kernel(log1mp: torch.Tensor, edge_vars: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """log1mp [B, F+1] float32 (column F = sentinel 0) -> [B, E] uint8
    weights, on log1mp's device.

    log(1 - q_e) = sum over the edge's variable slots of log(1 - p_v) —
    one column gather a slot, accumulated slot by slot in slot order, so
    the [B, E, Dv] tensor is never built. q -> 1 clamps to the cheapest
    weight; rounding is half to even, as the reference's rint."""
    B = log1mp.shape[0]
    E, Dv = edge_vars.shape
    acc = torch.zeros((B, E), dtype=torch.float32, device=log1mp.device)
    for s in range(Dv):
        acc = acc + log1mp.index_select(1, edge_vars[:, s])
    neg_log_q = -torch.log(torch.clamp(-torch.expm1(acc), 1e-12, 1.0))
    w = torch.round(torch.tensor(scale, dtype=torch.float32,
                                 device=log1mp.device) * neg_log_q)
    return torch.clamp(w, 1.0, 250.0).to(torch.uint8)


class BeliefMatchingDecoder:
    """Two-sector circuit-level belief-matching decoder.

    Parameters mirror `bp_dem.joint_circuit_bp_decoder` (alpha defaults
    to the joint graph's 0.6 — its Y atoms add cross-sector short
    cycles) plus `weight_scale`: integer growth weights are
    round(weight_scale * -log q / -log q_ref) with q_ref the largest
    zero-iteration edge probability, so the most likely edge costs
    ~weight_scale units and the uint8 range resolves ~15 octaves.
    BP and the weight projection run on ``device`` (the card unless the
    caller asks for the CPU); the matching runs on the host.

    ``timings`` holds the wall seconds of the last build ('build': the
    joint Tanner graph, the two-sector DEM, the decompositions) and of
    the last `decode_obs` ('bp': posteriors, 'weights': the projection and
    its read-back, 'uf': the two host decodes), the device synchronized at
    each mark.
    """

    def __init__(self, code, rounds: int, noise, *, iters: int = 32,
                 alpha: float = 0.6, weight_scale: int = 16,
                 device="cuda"):
        self.device = resolve_device(device)
        t0 = time.perf_counter()
        tan = build_joint_circuit_tanner(code, rounds, noise)
        if tan.obs.shape[0] != 2:
            raise ValueError(
                "belief-matching needs one logical per sector (matchable "
                f"codes); joint graph has {tan.obs.shape[0]} observable rows")
        dem, index = build_two_sector_dem(code, rounds, noise,
                                          return_index=True)
        self.dem = dem
        self.rounds = rounds
        rz = np.asarray(code.raw_parity_check_c2).shape[0]
        self._off = (rounds + 1) * rz

        # decompose every joint variable into per-sector matching edges
        have = {"z": index["z"], "x": index["x"]}
        cache = {"z": {}, "x": {}}
        F = tan.n_faults
        lists = {"z": [], "x": []}
        for f in range(F):
            dets = np.nonzero(tan.checks[:, f])[0]
            per = {
                "z": tuple(int(d) for d in dets if d < self._off),
                "x": tuple(int(d) - self._off for d in dets
                           if d >= self._off),
            }
            ob = {"z": int(tan.obs[0, f]), "x": int(tan.obs[1, f])}
            for sector in ("z", "x"):
                parts = _decompose_into_edges(
                    have[sector], per[sector], ob[sector], cache[sector])
                if parts is None:
                    raise ValueError(
                        f"joint variable {f} ({per[sector]}, obs "
                        f"{ob[sector]}) has no {sector}-sector edge "
                        "decomposition")
                edge_ids = [index[sector][k] for k in parts]
                lists[sector].append(edge_ids)
                # structural exactness: the chosen edges reproduce the
                # variable's own signature and observable, XOR-exactly
                g = (dem.graph_x_errors if sector == "z"
                     else dem.graph_z_errors)
                acc: set[int] = set()
                o = 0
                for e in edge_ids:
                    a, b = g.edges[e]
                    acc ^= {int(a)} | ({int(b)} if b >= 0 else set())
                    o ^= int(g.edge_obs[e]) & 1
                assert acc == set(per[sector]) and o == ob[sector], (
                    f, sector, parts)

        self._edge_vars = {
            sector: torch.as_tensor(_edge_var_table(
                lists[sector], g.num_edges, F).astype(np.int64),
                device=self.device)
            for sector, g in (("z", dem.graph_x_errors),
                              ("x", dem.graph_z_errors))}
        self.bp = BPDecoder(tan.checks,
                            np.clip(tan.priors, 1e-12, 0.499),
                            logicals=tan.obs, iters=iters, alpha=alpha,
                            osd=False, device=self.device)
        # weight scale: the zero-iteration (prior) probability of the
        # most likely edge anchors `weight_scale` growth units
        log1mp0 = np.log1p(-np.clip(tan.priors, 1e-12, 0.499))
        self._scales = {}
        for sector, g in (("z", dem.graph_x_errors),
                          ("x", dem.graph_z_errors)):
            log1mq0 = np.zeros(g.num_edges)
            for v, edges in enumerate(lists[sector]):
                for e in edges:
                    log1mq0[e] += log1mp0[v]
            base = (-np.log(np.clip(-np.expm1(log1mq0), 1e-12, 1.0))).min()
            self._scales[sector] = float(weight_scale) / max(float(base),
                                                             1e-3)
        self._dec = {
            "z": UFDecoder(dem.graph_x_errors),
            "x": UFDecoder(dem.graph_z_errors),
        }
        self.timings = {"build": time.perf_counter() - t0}

    def shot_weights(self, dets_z, dets_x):
        """Per-shot integer matching weights from the joint posterior,
        computed on the device; only the weights come back.

        dets_z [B, (rounds+1)*rz], dets_x [B, (rounds+1)*rx] detector
        histories -> ({'z': [B, Ez] uint8, 'x': [B, Ex] uint8}, conv),
        numpy."""
        dev = self.device
        stacked = np.concatenate(
            [np.asarray(dets_z, np.uint8).reshape(len(dets_z), -1),
             np.asarray(dets_x, np.uint8).reshape(len(dets_x), -1)], axis=1)
        synchronize(dev)
        t0 = time.perf_counter()
        _, conv, soft = self.bp._run(self.bp._synd(stacked))
        synchronize(dev)
        t1 = time.perf_counter()
        # posterior p_v = sigmoid(-LLR); keep away from exactly 1
        s64 = soft.to(torch.float64)
        log1mp = -torch.logaddexp(torch.zeros_like(s64), -s64)
        log1mp = torch.clamp(log1mp, float(np.log(1e-12)),
                             float(np.log1p(-1e-9)))
        log1mp = torch.cat(
            [log1mp, torch.zeros((log1mp.shape[0], 1), dtype=torch.float64,
                                 device=dev)], dim=1).to(torch.float32)
        out = {sector: _shot_weights_kernel(
            log1mp, self._edge_vars[sector], self._scales[sector]
        ).cpu().numpy() for sector in ("z", "x")}
        self.timings["bp"] = t1 - t0
        self.timings["weights"] = time.perf_counter() - t1
        return out, conv.cpu().numpy()

    def decode_obs(self, dets_z, dets_x, *, n_threads=None):
        """-> (obs_z flips [B] uint32 — X-error decode of the Z-check
        stream, obs_x flips [B] uint32) under belief-matching weights."""
        wts, _ = self.shot_weights(dets_z, dets_x)
        t0 = time.perf_counter()
        _, obs_z = self._dec["z"].decode_batch(
            np.asarray(dets_z, np.uint8), want_corrections=False,
            n_threads=n_threads, shot_weights=wts["z"])
        _, obs_x = self._dec["x"].decode_batch(
            np.asarray(dets_x, np.uint8), want_corrections=False,
            n_threads=n_threads, shot_weights=wts["x"])
        self.timings["uf"] = time.perf_counter() - t0
        return obs_z, obs_x
