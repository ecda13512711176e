"""Device meshes and the sharded Monte-Carlo pipelines (PyTorch port of
`qcss_tpu.parallel.mesh`).

Design: the Monte-Carlo sample axis is embarrassingly parallel, so the
mesh has a single ``data`` axis. The reference is single-controller (one
Python process, `shard_map` over the axis, a `psum` of counts as the only
collective); so is the port. A `Mesh` is a tuple of `torch.device`s, and
a sharded pipeline runs, for each shard i in turn, the port's unsharded
body on ``mesh.devices[i]`` with the local batch and a generator seeded
with `shard_seed(seed, i)` = (seed * 1000003 + i) mod 2^63 — the rule of
`sim.noise.chunk_generators`, where the reference folds the axis index
into its key. Every shard's work is queued before any count is read;
the counts are then summed on the first device (the reference's `psum`)
and read back once, and sample outputs are concatenated along the batch
axis there. A card's shard runs with that card current, so the kernels'
C entry points launch on it.

The cards overlap only where a body queues its work without reading
anything back. These bodies read back part-way, so their shards run one
after another: the FT executor (`sharded_ftqc_run`: repeat-until-success
preparation, the scheduled engine's host loop), BP (`sharded_bp_memory`,
`sharded_qldpc_circuit_memory`: a convergence read every few
iterations, and their entry points read the shard's counts back), the
generic union-find decoders' fixpoint loops (the
compiled programs of `sharded_logical_program` and level 1 of
`sharded_two_level_memory`, the per-shot weights of
`sharded_soft_memory`), the hybrid decoder's overflow test
(`ShardedFrameMemory.fused_error_rate(decoder='hybrid')`) and
`ShardedFrameMemory.error_rate`, which decodes on the host.

A pipeline calls the body that its unsharded entry point runs (a rep's
``step`` lifted out of that entry point, or the entry point itself) and
adds nothing to it but the split, the seeds and the sum. There are no
compile caches: a pipeline builds its body once for each distinct device
of the mesh, for that call, and the bodies' owners keep what they keep
(a schedule model's `meta`, a `ShardedFrameMemory` instance), never on
``id(code)``, which can alias once a code is freed.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from qcss_tpu_torch._cuda import resolve_device

_KEYS = ("x_fail", "z_fail", "word_fail")


class Mesh:
    """A 1-D mesh: ``devices`` (a tuple of `torch.device`, one a shard; a
    device may appear more than once) along the axis ``axis_names[0]``.
    ``size`` is the number of shards (the reference's
    ``mesh.devices.size``), ``shape`` maps the axis to it."""

    def __init__(self, devices, axis_names=("data",)):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis_names[0]: self.size}


def make_mesh(n_devices: int | None = None, axis: str = "data",
              devices=None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` CUDA devices, or over
    ``devices`` when given (CPU devices, as the tests name them, or a card
    named more than once). Raises without a card unless ``devices`` names
    only CPU devices, and raises if fewer than ``n_devices`` devices exist:
    it never falls back to the CPU or to fewer devices.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: make_mesh() takes the cards; pass "
                "devices=[...] to name CPU devices")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [resolve_device(d) for d in devices]
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devices)} device(s) exist; name more devices "
                "(devices=[...]) or request fewer"
            )
        devices = devices[:n_devices]
    return Mesh(devices, (axis,))


def shard_seed(seed: int, i: int) -> int:
    """Shard i's seed: (seed * 1000003 + i) mod 2^63, as
    `sim.noise.chunk_generators` seeds chunk i."""
    return (int(seed) * 1000003 + i) % (1 << 63)


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _local_batch(mesh: Mesh, batch: int, message: str | None = None) -> int:
    n_dev = mesh.size
    if batch % n_dev:
        raise ValueError(message or
                         f"batch {batch} not divisible by mesh size {n_dev}")
    return batch // n_dev


def _current(device: torch.device):
    """The context a shard runs in: its card current, nothing on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _shards(mesh: Mesh, seed: int, body) -> list:
    """``body(device, shard seed)`` for every shard, all queued before the
    caller reads anything."""
    outs = []
    for i, dev in enumerate(mesh.devices):
        with _current(dev):
            outs.append(body(dev, shard_seed(seed, i)))
    return outs


def _psum(values, device) -> torch.Tensor:
    """The sum of the shards' device tensors, on ``device``."""
    total = values[0].to(device)
    for v in values[1:]:
        total = total + v.to(device)
    return total


def _gather(values, device, dim: int = 0) -> torch.Tensor:
    """The shards' outputs concatenated along ``dim`` on ``device``."""
    return torch.cat([v.to(device) for v in values], dim=dim)


def _dev_key(device: torch.device) -> str:
    if device.type == "cuda" and device.index is None:
        return f"cuda:{torch.cuda.current_device()}"
    return str(device)


def _per_device(mesh: Mesh, make):
    """``built(device)``: ``make(device)``, made once for each distinct
    device of the mesh, for this call only."""
    made = {}
    for dev in mesh.devices:
        key = _dev_key(dev)
        if key not in made:
            with _current(dev):
                made[key] = make(dev)
    return lambda dev: made[_dev_key(dev)]


def _read_counts(outs, device, *, invert_last: bool = False) -> list[int]:
    """The shards' device counts, summed field by field on ``device`` and
    read back at once. With ``invert_last`` the last field is each
    shard's all-converged flag, counted as the shards that did not
    converge."""
    fields = []
    for j in range(len(outs[0])):
        vals = [o[j] for o in outs]
        if invert_last and j == len(outs[0]) - 1:
            vals = [(~v).to(torch.int64) for v in vals]
        fields.append(_psum([v.to(torch.int64) for v in vals], device))
    return torch.stack(fields).tolist()


# -- 1. the code-capacity Monte Carlo (K8, K6) ----------------------------


def sharded_mc_step(code, mesh: Mesh, seed: int, batch: int, p) -> dict:
    """One Monte-Carlo round sharded over the mesh's ``data`` axis: shard
    i runs `montecarlo.mc_decode_step` on its device with the local batch
    and `shard_seed(seed, i)` (the seed takes the place of the reference's
    key).

    ``batch`` is the *global* sample count; it must divide evenly by the
    mesh size. Returns global failure counts, 0-d int64 tensors summed on
    the first device (nothing is read back).
    """
    from qcss_tpu_torch.decode.montecarlo import mc_decode_step

    local = _local_batch(mesh, batch)
    outs = _shards(mesh, seed, lambda dev, s: mc_decode_step(
        code, _generator(dev, s), local, p))
    return {k: _psum([o[k] for o in outs], mesh.devices[0]) for k in _KEYS}


def sharded_logical_error_rate(
    code,
    p,
    *,
    mesh: Mesh | None = None,
    samples: int = 1 << 20,
    batch: int = 1 << 18,
    seed: int = 0,
) -> dict[str, float]:
    """Mesh-parallel version of `decode.montecarlo.logical_error_rate`:
    ceil(samples / batch) sharded rounds, round i seeded
    `shard_seed(seed, i)` (the reference splits its key a round), the
    counts summed on the device and read back once."""
    from qcss_tpu_torch.decode.montecarlo import _rates

    mesh = make_mesh() if mesh is None else mesh
    n_dev = mesh.size
    batch = max(n_dev, batch - batch % n_dev)
    rounds = -(-samples // batch)
    total = None
    for i in range(rounds):
        counts = sharded_mc_step(code, mesh, shard_seed(seed, i), batch, p)
        total = counts if total is None else {
            k: total[k] + counts[k] for k in _KEYS}
    return _rates(total, rounds * batch)


# -- 2. the FT executor (K9 on 'packed') -----------------------------------


def _run_tensors(encoded, batch: int, seed: int) -> dict[str, torch.Tensor]:
    """`EncodedProgram.run(batch, seed)`'s registers as device tensors
    (``"__prep_fail__"`` [batch, 1] included)."""
    if encoded.engine == "unrolled":
        out, _ = encoded._execute(batch, seed, None)
        return out
    macro, executor, ref_outs = encoded._prepare_scheduled()
    st = executor.execute(macro, batch, seed=seed, ref_outs=ref_outs)
    out = {name: st.memory[:, off:off + size]
           for name, (off, size) in macro.memory_layout.items()}
    out["__prep_fail__"] = st.prep_fail[:, None]
    return out


def sharded_ftqc_run(encoded, mesh: Mesh, batch: int,
                     seed: int = 0) -> dict[str, torch.Tensor]:
    """Run an FT-encoded program with the shot axis sharded over the mesh.

    Shard i executes its local shots end-to-end (tableau evolution, EC,
    majority votes) as `encoded.run(local, shard_seed(seed, i))` does, on
    its device; the registers are concatenated along the batch axis on the
    first device, as tensors. A device other than the program's runs
    `encoded.on(device)`, built for this call. The repeat-until-success
    preparation loops read back per shard, so the shards run one after
    another.
    """
    local = _local_batch(mesh, batch)
    home = _dev_key(encoded.device)
    program = _per_device(mesh, lambda dev: (
        encoded if _dev_key(dev) == home else encoded.on(dev)))
    outs = _shards(mesh, seed, lambda dev, s: _run_tensors(
        program(dev), local, s))
    return {name: _gather([o[name] for o in outs], mesh.devices[0])
            for name in outs[0]}


# -- 3. the circuit-level memory on the frame sampler (K1, K2) -------------


class ShardedFrameMemory:
    """Mesh-parallel memory-experiment sampling on the Pauli-frame fast
    path (`sim.frame` via `experiments.memory._memory_circuit_frames`).

    Each shard samples its local shots on its device (its own generator)
    and keeps the detector histories there until the host decode gathers
    them; the sample axis is embarrassingly parallel, exactly like
    `sharded_mc_step`. Matching graphs and decoders are kept on the
    instance, by rounds, graph, decoder and device.
    """

    def __init__(self, code, noise, mesh: Mesh):
        from qcss_tpu_torch.experiments.memory import z_extraction_circuit
        from qcss_tpu_torch.sim import frame as fr

        self.code = code
        self.noise = noise
        self.mesh = mesh
        self.h2_raw = np.asarray(code.raw_parity_check_c2)
        self._extract = z_extraction_circuit(
            code, checks=self.h2_raw).to_arrays()
        self._extract_comp = fr.maybe_compile(
            self._extract, code.n + self.h2_raw.shape[0])
        self._cache: dict = {}

    def _kept(self, key, make):
        if key not in self._cache:
            self._cache[key] = make()
        return self._cache[key]

    def _sampler(self, device, seed: int, local: int, rounds: int):
        """``sample(extract_arrays, n_anc, final_arrays)`` of the frames
        engine on ``device``, drawing from a generator seeded ``seed`` —
        the sampler `memory_experiment(engine='frames')` binds."""
        from qcss_tpu_torch.experiments.memory import _memory_circuit_frames

        comp = self._extract_comp
        if comp is not None:
            comp = self._kept(("comp", _dev_key(device)),
                              lambda: comp.to(device))
        gen = _generator(device, seed)

        def sample(extract_arrays, n_anc, final_arrays=None):
            return _memory_circuit_frames(
                gen, local, rounds, self.code, self.noise, extract_arrays,
                n_anc=n_anc, final_arrays=final_arrays, extract_comp=comp)

        return sample

    def sample(self, seed: int, batch: int, rounds: int):
        """Global-batch sample: returns (syns [R, batch, r], word
        [batch, n]) uint8 on the first device, shard i's shots at
        [i * local, (i + 1) * local)."""
        local = _local_batch(self.mesh, batch)
        n_anc = self.h2_raw.shape[0]
        outs = _shards(self.mesh, seed, lambda dev, s: self._sampler(
            dev, s, local, rounds)(self._extract, n_anc))
        first = self.mesh.devices[0]
        return (_gather([o[0] for o in outs], first, dim=1),
                _gather([o[1] for o in outs], first))

    def _graph(self, rounds: int, dem: bool):
        from qcss_tpu_torch.experiments.memory import _circuit_graph

        return self._kept(("graph", rounds, dem), lambda: _circuit_graph(
            self.code, rounds, self.noise, self.h2_raw,
            self.code.z_operator_matrix(), dem))

    def error_rate(self, *, rounds: int, batch: int, seed: int = 0,
                   decoder: str = "uf",
                   n_threads: int | None = None) -> dict[str, float]:
        """Sample over the mesh, decode on the host (union-find on the
        phenomenological spacetime graph, or the circuit-level DEM)."""
        from qcss_tpu_torch.decode.spacetime import detector_history
        from qcss_tpu_torch.decode.uf import UFDecoder
        from qcss_tpu_torch.experiments.memory import _count_failures_host

        syns, word = self.sample(seed, batch, rounds)
        syns, word = syns.cpu().numpy(), word.cpu().numpy()
        final_syn = (
            (word.astype(np.int64) @ self.h2_raw.T.astype(np.int64)) & 1
        ).astype(np.uint8)
        dets = detector_history(syns, final_syn)
        graph = self._graph(rounds, decoder == "dem")
        corr, _ = UFDecoder(graph).decode_batch(dets, n_threads=n_threads)
        fails, resid = _count_failures_host(word, corr, self.code)
        return {
            "logical_fail": fails / batch,
            "residual_syndrome": resid / batch,
            "rounds": rounds,
            "samples": batch,
            "decoder": decoder,
        }

    def _decoder(self, rounds, graph_kind, decoder, d_max, device):
        if graph_kind not in ("dem", "uf"):
            raise ValueError("graph_kind must be 'dem' or 'uf'")
        graph = self._graph(rounds, graph_kind == "dem")

        def make():
            if decoder == "dense":
                from qcss_tpu_torch.decode.device_uf import make_obs_decoder

                return make_obs_decoder(graph, device=device)
            if decoder == "sparse":
                from qcss_tpu_torch.decode.device_sparse import (
                    make_sparse_obs_decoder,
                )

                fn = make_sparse_obs_decoder(graph, d_max=d_max,
                                             device=device)
                if fn is None:
                    raise ValueError("graph refuses the sparse path")
                return fn
            if decoder == "hybrid":
                from qcss_tpu_torch.decode.device_sparse import (
                    make_hybrid_obs_decoder,
                )

                return make_hybrid_obs_decoder(graph, d_max=d_max,
                                               device=device)
            raise ValueError("decoder must be 'dense', 'sparse' or 'hybrid'")

        return self._kept(("decoder", rounds, graph_kind, decoder, d_max,
                           _dev_key(device)), make)

    def fused_shard(self, device, seed: int, local: int, rounds: int,
                    graph_kind: str = "dem", decoder: str = "dense",
                    d_max: int = 48):
        """One shard of `fused_error_rate` on ``device`` at ``seed``: the
        unsharded fused pipeline (`memory._memory_fused_device` over the
        frames sampler). Returns (failures, all converged), device
        scalars."""
        from qcss_tpu_torch.experiments.memory import _memory_fused_device

        decode_fn = self._decoder(rounds, graph_kind, decoder, d_max, device)
        log_row, raw_t = self._kept(("rows", _dev_key(device)), lambda: (
            torch.as_tensor(np.asarray(self.code.z_operator_matrix()[0]),
                            device=device),
            torch.as_tensor(np.asarray(self.h2_raw, np.uint8),
                            device=device)))
        return _memory_fused_device(
            self._sampler(device, seed, local, rounds), self._extract,
            n_anc=self.h2_raw.shape[0], decode_fn=decode_fn,
            log_row=log_row, raw_t=raw_t)

    def fused_error_rate(self, *, rounds: int, batch: int, seed: int = 0,
                         graph_kind: str = "dem",
                         decoder: str = "dense",
                         d_max: int = 48) -> dict[str, float]:
        """Sample AND union-find-decode on every device (`fused_shard`),
        with one sum of the failure counts as the only collective — no
        detector history ever leaves the devices. decoder='dense' is the
        stencil kernel (K1) where the graph takes it; 'sparse' the
        defect-granular kernel (K2); 'hybrid' K2 with the dense decoder
        for the shots past ``d_max`` defects."""
        local = _local_batch(self.mesh, batch)
        outs = _shards(self.mesh, seed, lambda dev, s: self.fused_shard(
            dev, s, local, rounds, graph_kind, decoder, d_max))
        fails, bad = _read_counts(outs, self.mesh.devices[0],
                                  invert_last=True)
        if bad:
            raise RuntimeError("device union-find hit its growth cap")
        return {
            "logical_fail": fails / batch,
            "rounds": rounds,
            "samples": batch,
            "decoder": f"device-{graph_kind}",
        }


# -- 4. qLDPC memories on BP (no kernel) -----------------------------------


def sharded_bp_memory(code, mesh: Mesh, *, rounds: int, p: float, q: float,
                      batch: int, seed: int = 0, iters: int = 32,
                      alpha: float = 0.8) -> dict[str, float]:
    """Mesh-parallel phenomenological qLDPC memory, fully fused on device.

    The qLDPC counterpart of `ShardedFrameMemory.fused_error_rate`: each
    shard samples its part of the detector stream
    (`streaming.sample_phenomenological_stream`) and decodes the whole
    history with spacetime belief propagation (`decode.bp.BPDecoder`) on
    its device: shard i is `bp.bp_phenomenological_error_rate(...,
    osd=False, seed=shard_seed(seed, i))`, and only the summed failure /
    non-converged counts are kept. BP here has no OSD tail (non-converged
    shots score their final hard decision); the reported
    ``bp_unconverged`` fraction bounds how much an OSD pass could still
    recover. The entry point reads its shard's counts back, so the
    shards run one after another.
    """
    from qcss_tpu_torch.decode.bp import bp_phenomenological_error_rate

    local = _local_batch(mesh, batch)
    outs = _shards(mesh, seed, lambda dev, s: bp_phenomenological_error_rate(
        code, rounds, p, q, batch=local, seed=s, iters=iters, alpha=alpha,
        osd=False, device=dev))
    fails = sum(round(o["x_fail"] * local) for o in outs)
    unconv = sum(round((1 - o["bp_converged"]) * local) for o in outs)
    return {
        "x_fail": fails / batch,
        "bp_unconverged": unconv / batch,
        "rounds": rounds,
        "samples": batch,
        "decoder": "device-bp",
    }


def sharded_qldpc_circuit_memory(code, mesh: Mesh, *, rounds: int, noise,
                                 batch: int, seed: int = 0, iters: int = 48,
                                 alpha: float = 0.8) -> dict[str, float]:
    """Mesh-parallel CIRCUIT-LEVEL qLDPC memory, fully fused on device.

    The circuit-noise counterpart of `sharded_bp_memory`: every shard
    frame-samples its part of the two-sector extraction schedule (the
    real circuits, real per-location noise), assembles the z-sector
    detector history, and decodes it with BP over the exact
    detector-fault Tanner graph on its device: shard i is
    `memory_qldpc.qldpc_memory_experiment(..., sectors='z', osd=False,
    seed=shard_seed(seed, i))`, and the failure / non-converged counts
    are summed. Device-only BP (no OSD tail): ``bp_unconverged`` bounds
    what a host OSD pass could still recover. The entry point reads its
    shard's counts back, so the shards run one after another."""
    from qcss_tpu_torch.experiments.memory_qldpc import (
        qldpc_memory_experiment,
    )

    local = _local_batch(mesh, batch)
    outs = _shards(mesh, seed, lambda dev, s: qldpc_memory_experiment(
        code, rounds=rounds, noise=noise, batch=local, seed=s, iters=iters,
        alpha=alpha, osd=False, sectors="z", device=dev))
    fails = sum(round(o["x_fail"] * local) for o in outs)
    unconv = sum(round((1 - o["bp_converged_z"]) * local) for o in outs)
    return {
        "x_fail": fails / batch,
        "bp_unconverged": unconv / batch,
        "rounds": rounds,
        "samples": batch,
        "decoder": "device-circuit-bp",
    }


# -- 5. the analog-readout memory (the generic decoder, per-shot weights) --


def sharded_soft_memory(code, mesh: Mesh, *, rounds: int, p: float,
                        sigma: float, batch: int, seed: int = 0,
                        resolution: int = 8) -> dict[str, float]:
    """Mesh-parallel ANALOG-READOUT memory, fully fused on device: every
    shard samples its part of the phenomenological stream with Gaussian
    readout amplitudes, converts amplitudes to per-shot posterior-LLR
    time-edge weights, union-find-decodes with the device decoder's
    ``shot_weights`` input, and scores failures — one sum of counts is
    the only collective; the amplitudes (the large per-shot
    side-information array) never leave any device. Shard i is
    `soft_device_memory_rate`'s rep i at ``seed`` (its step,
    `soft._soft_device_step`, on `shard_seed(seed, i)`)."""
    from qcss_tpu_torch.experiments.soft import _soft_device_step

    local = _local_batch(mesh, batch)
    step = _per_device(mesh, lambda dev: _soft_device_step(
        code, p, sigma, rounds, resolution, local, dev))
    outs = _shards(mesh, seed, lambda dev, s: step(dev)(
        _generator(dev, s)))
    fails, unconv = _read_counts(outs, mesh.devices[0], invert_last=True)
    if unconv:
        raise RuntimeError(f"device UF growth cap hit on {unconv} decodes")
    return {
        "logical_fail": fails / batch,
        "rounds": rounds,
        "samples": batch,
        "p": p,
        "sigma": sigma,
        "decoder": "device-uf-soft",
    }


# -- 6. the magic-state factory (no kernel) --------------------------------


def sharded_magic_factory(mesh: Mesh, noise, p_in, batch: int, *,
                          code=None, extractions: int = 1,
                          seed: int = 0) -> dict[str, float]:
    """Mesh-parallel circuit-level magic-state distillation: every shard
    runs its part of `ftqc.magic.distill_circuit`'s frame kernel — noisy
    encoded-|+̄⟩ preparation, Bernoulli(p_in) twirled-input Z injections,
    noisy X-syndrome extraction rounds, perfect transversal readout — and
    only the summed (accepted, erroneous) counts cross to the host. Shard
    i's counts are `distill_circuit(..., local, seed=shard_seed(seed, i))`'s.
    A factory is embarrassingly shot-parallel, so this is the deployment
    shape for calibrating distillation units at scale; the reference has
    no non-Clifford machinery at all (reference: css_code.py:433-434)."""
    from qcss_tpu_torch.ftqc import magic
    from qcss_tpu_torch.sim.noise import chunk_generators

    code = magic._default_code() if code is None else code
    magic._check_distillable(code)
    local = _local_batch(mesh, batch)
    setup = _per_device(mesh, lambda dev: magic._circuit_setup(code, dev))

    def shard(dev, s):
        accept, err = magic._circuit_kernel(
            chunk_generators(s, 3, dev), p_in, None, code, noise,
            *setup(dev), batch=local, extractions=extractions, n=code.n,
            r1=code.r_1)
        return accept.sum(), (accept & err).sum()

    acc, bad = _read_counts(_shards(mesh, seed, shard), mesh.devices[0])
    return {
        "p_in": float(p_in),
        "p_accept": acc / batch,
        "p_out": bad / max(acc, 1),
        "accepted": acc,
        "samples": batch,
        "extractions": extractions,
    }


# -- 7. compiled logical programs (the generic decoder; K1 on level 2) ------


def sharded_logical_program(model, mesh: Mesh, *, p: float,
                            q: float | None = None, batch: int,
                            seed: int = 0) -> dict[str, float]:
    """Mesh-parallel compiled logical program: every shard samples its
    part of the program's fault model AND union-find-decodes it on its
    device; one sum of per-observable failure counts is the only
    collective — logical circuits with nothing but counts leaving the
    devices. Shard i is `patches.schedule_memory_device`'s rep i at
    ``seed`` (its step, `patches._device_step`, on `shard_seed(seed, i)`).

    `model` is a built `experiments.patches.ScheduleModel` (e.g.
    `LogicalProgram(...).cnot(0, 1).build()`)."""
    from qcss_tpu_torch.experiments.patches import _device_step

    q = p if q is None else q
    n_dev = mesh.size
    local = _local_batch(mesh, batch,
                         f"batch {batch} not divisible by {n_dev}")
    n_obs = model.obs.shape[0]
    outs = _shards(mesh, seed, lambda dev, s: _device_step(
        model, local, float(p), float(q), "dense", dev)(_generator(dev, s)))
    first = mesh.devices[0]
    counts = torch.cat([_psum([o[0] for o in outs], first),
                        torch.stack([_psum([o[1] for o in outs], first),
                                     _psum([o[2] for o in outs], first)])
                        ]).tolist()
    per_obs, (word, bad) = counts[:n_obs], counts[n_obs:]
    if bad:
        raise RuntimeError("device union-find hit its growth cap")
    out = {"word_fail": word / batch, "samples": batch,
           "devices": n_dev, "p": float(p), "q": float(q)}
    names = model.meta.get("obs_names",
                           [f"obs{i}" for i in range(n_obs)])
    for i, name in enumerate(names):
        out[f"{name}_fail"] = per_obs[i] / batch
    return out


def sharded_two_level_memory(d: int, k: int, rounds_l: int, mesh: Mesh,
                             *, p: float, q: float | None = None,
                             batch: int, seed: int = 0) -> dict:
    """Mesh-parallel hierarchical (two-level concatenated) memory. Every
    shard runs the FUSED two-level step of `experiments.concatenated`:
    sample the compiled mzz-sweep logical program's fault model,
    union-find-decode level 1, assemble the level-2 repetition-code
    spacetime detectors from the decoded deviation record,
    union-find-decode level 2 (the stencil kernel, K1, on the card) — and
    one sum of the level-1/level-2 failure counts is the only collective.
    Shard i is `_device_two_level`'s rep i at the same seed (its step,
    `concatenated._two_level_pipeline`, on `shard_seed(seed, i)`)."""
    from qcss_tpu_torch.experiments.concatenated import _two_level_pipeline

    q = p if q is None else q
    n_dev = mesh.size
    local = _local_batch(mesh, batch,
                         f"batch {batch} not divisible by {n_dev}")
    built = _per_device(mesh, lambda dev: _two_level_pipeline(
        d, k, rounds_l, p, q, batch=local, layout="chain", device=dev))
    outs = _shards(mesh, seed, lambda dev, s: built(dev)[2](
        _generator(dev, s)))
    l1, l2, bad = _psum(outs, mesh.devices[0]).tolist()
    if bad:
        raise RuntimeError("device union-find hit its growth cap")
    return {
        "d": d, "k": k, "rounds_l": rounds_l,
        "p": float(p), "q": float(q), "samples": batch,
        "devices": n_dev, "grid_qubits": built(mesh.devices[0])[0].n,
        "word_fail_l1": l1 / batch,
        "word_fail_l2": l2 / batch,
    }


# -- 8. exact ML and the parallel window (K1) ------------------------------


def sharded_mld_memory(code, mesh: Mesh, *, p: float, batch: int,
                       seed: int = 0) -> dict[str, float]:
    """Mesh-parallel EXACT maximum-likelihood memory: every shard samples
    its iid X errors, computes syndromes, scores every degenerate coset of
    every logical class (`decode.mld.MLDecoder.device_decode_fn`) and
    picks the ML class on its device; one sum of word-failure counts is
    the only collective. Shard i is the ML half of
    `mld_logical_error_rate(..., seed=shard_seed(seed, i))` (its step,
    `mld._ml_device_step`)."""
    from qcss_tpu_torch.decode.mld import _ml_device_step

    local = _local_batch(mesh, batch)
    step = _per_device(mesh, lambda dev: _ml_device_step(code, p, local,
                                                         dev))
    outs = _shards(mesh, seed, lambda dev, s: step(dev)(
        _generator(dev, s))[1])
    fails = int(_psum(outs, mesh.devices[0]))
    return {
        "word_fail": fails / batch,
        "samples": batch,
        "p": p,
        "decoder": "device-mld",
    }


def sharded_parallel_window_memory(code, mesh: Mesh, *, rounds: int,
                                   p: float, q: float, batch: int,
                                   core: int, buf: int,
                                   seed: int = 0) -> dict[str, float]:
    """Mesh-parallel PARALLEL-WINDOW memory: every shard samples its part
    of the phenomenological stream and decodes the whole recorded stream
    with `ParallelWindowDecoder.decode_tensors` — all layer-A windows and
    all layer-B seams fold into the local batch axis; one sum of failure
    counts is the only collective. Shard i is
    `parallel_window_memory_rate(..., seed=shard_seed(seed, i))` (its
    step, `parallel_window._parallel_window_step`)."""
    from qcss_tpu_torch.decode.parallel_window import _parallel_window_step

    h = np.asarray(code.raw_parity_check_c2, np.uint8) & 1
    lz = np.atleast_2d(np.asarray(code.z_operator_matrix(), np.uint8) & 1)
    if lz.shape[0] != 1:
        # ParallelWindowDecoder itself rejects multi-observable inputs;
        # truncating silently would report fail rates for observable 0
        # only on a k>1 code (e.g. toric) — refuse instead.
        raise ValueError(
            f"sharded_parallel_window_memory supports k=1 codes only"
            f" (code has {lz.shape[0]} Z observables)")
    local = _local_batch(mesh, batch)
    step = _per_device(mesh, lambda dev: _parallel_window_step(
        h, lz, p, q, rounds=rounds, batch=local, core=core, buf=buf,
        weighted=True, device=dev))
    outs = _shards(mesh, seed, lambda dev, s: step(dev)(
        _generator(dev, s)))
    fails, unconv = _read_counts(outs, mesh.devices[0], invert_last=True)
    if unconv:
        raise RuntimeError(
            f"parallel-window growth cap hit on {unconv} window decodes"
            " — matches ParallelWindowDecoder.decode_stream /"
            " parallel_window_memory_rate semantics")
    return {
        "logical_fail": fails / batch,
        "rounds": rounds,
        "samples": batch,
        "decoder": "device-parallel-window",
    }
