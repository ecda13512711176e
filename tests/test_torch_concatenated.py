"""The port's two-level concatenated memory (`qcss_tpu_torch.experiments.
concatenated`) against the JAX package's, on the CPU.

The level-2 graph and `_build_program` are copies
(tests/test_torch_import.py) and must equal the reference's; so must the
level-2 detectors assembled from one deviation record. The host tier,
given one level-1 record (a replay in both packages), returns the
reference's dict. `_device_two_level` runs on the reference's own
draws (the port's `surgery._sample` replaced by the reference's
`patches._sample` on the reference's keys) and counts what the
reference's `_device_two_level` counts; it is also held against the host
tier on the same shots: the host tier is handed the level-1 record that
the device step decodes, and decodes level 2 with the device step's
decoder, so that the two differ only in how they assemble and count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcss_tpu.experiments import concatenated as jconc
from qcss_tpu.experiments import patches as jpatches
from qcss_tpu_torch.decode.device_uf import (
    build_device_graph,
    make_obs_decoder,
    stencil_refusal,
)
from qcss_tpu_torch.decode.uf import MatchingGraph
from qcss_tpu_torch.experiments import concatenated as tconc
from qcss_tpu_torch.experiments import surgery as tsg
from qcss_tpu_torch.sim.noise import chunk_generators

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # several worker processes run at once; see test_torch_device_uf.py
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _quick_reference_compiles():
    # the reference programs compared here: see test_torch_device_uf.py
    saved = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", saved)


@pytest.mark.parametrize("k,layers,layout", [(3, 4, "chain"),
                                             (4, 3, "chain"),
                                             (5, 3, "brickwork")])
def test_level2_graph_bit_identical(k, layers, layout):
    gt = tconc.repetition_spacetime_graph(k, layers, layout)
    gj = jconc.repetition_spacetime_graph(k, layers, layout)
    assert gt.num_nodes == gj.num_nodes and gt.n_qubits == gj.n_qubits
    for attr in ("edges", "edge_qubit", "edge_obs", "edge_weight"):
        np.testing.assert_array_equal(getattr(gt, attr), getattr(gj, attr))


def test_level2_detectors_equal():
    rng = np.random.default_rng(0)
    mzz = (rng.random((256, 3, 4)) < 0.2).astype(np.uint8)
    z = (rng.random((256, 5)) < 0.2).astype(np.uint8)
    got = tconc._level2_detectors(torch.as_tensor(mzz), torch.as_tensor(z))
    ref = jconc._level2_detectors(jnp.asarray(mzz), jnp.asarray(z))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("k,rounds_l,layout", [(3, 1, "chain"),
                                               (4, 1, "brickwork")])
def test_build_program_equal(k, rounds_l, layout):
    _, mt, perm_t = tconc._build_program(3, k, rounds_l, layout)
    _, mj, perm_j = jconc._build_program(3, k, rounds_l, layout)
    np.testing.assert_array_equal(perm_t, perm_j)
    for attr in ("F", "obs", "fault_probs_class"):
        np.testing.assert_array_equal(getattr(mt, attr), getattr(mj, attr))
    for attr in ("edges", "edge_obs", "edge_weight"):
        np.testing.assert_array_equal(getattr(mt.graph, attr),
                                      getattr(mj.graph, attr))


def test_host_tier_on_a_replayed_record(monkeypatch):
    """One numpy level-1 record (deviations at ~12%, so that level 2 has
    work) through both packages' host tiers: the same dict."""
    d, k, rounds_l, batch = 3, 3, 1, 2048
    n_obs = rounds_l * (k - 1) + k
    vals = (np.random.default_rng(1).random((batch, n_obs))
            < 0.12).astype(np.uint8)

    def replay(model, p, q=None, **kw):
        assert model.obs.shape[0] == n_obs
        return vals.copy()

    monkeypatch.setattr(tconc, "schedule_decoded_obs", replay)
    monkeypatch.setattr(jconc, "schedule_decoded_obs", replay)
    got = tconc.logical_repetition_memory(d, k, rounds_l, 4e-3,
                                          batch=batch, device=CPU)
    ref = jconc.logical_repetition_memory(d, k, rounds_l, 4e-3,
                                          batch=batch)
    assert got == ref
    assert got["word_fail_l2"] < got["word_fail_l1"]


def test_device_two_level_equals_reference_on_its_draws(monkeypatch):
    """The port's `_device_two_level` and the reference's, unpatched, on
    the reference's draws: rep r of the port replays the reference's
    `patches._sample` on fold_in(key(seed), r), the key the reference's
    step r draws from. Both levels' word failures are equal; level 2
    corrects."""
    d, k, rounds_l, p, batch, reps, seed = 3, 3, 1, 6e-3, 128, 2, 11
    keys = [jax.random.fold_in(jax.random.key(seed), r)
            for r in range(reps)]
    sample = jax.jit(jpatches._sample, static_argnames=("batch",))

    def replay(generator, p_, q_, batch_, cls, f_t, obs_t):
        dets, ob = sample(keys.pop(0), jnp.float32(p_), jnp.float32(q_),
                          batch_, jnp.asarray(cls.numpy()),
                          jnp.asarray(f_t.numpy().astype(np.int32)),
                          jnp.asarray(obs_t.numpy().astype(np.int32)))
        return (torch.from_numpy(np.array(dets, np.uint8)),
                torch.from_numpy(np.array(ob, np.uint8)))

    monkeypatch.setattr(tsg, "_sample", replay)
    got = tconc._device_two_level(d, k, rounds_l, p, None, batch=batch,
                                  seed=seed, reps=reps, device=CPU)
    ref = jconc._device_two_level(d, k, rounds_l, p, None, batch=batch,
                                  seed=seed, reps=reps)
    assert not keys
    assert got == ref
    assert got["word_fail_l2"] < got["word_fail_l1"] / 2


def test_device_two_level_equals_host_tier_on_its_shots(monkeypatch):
    """`_device_two_level` (two reps) against the host tier fed the same
    shots: rep r's from generator r of `chunk_generators(seed, reps)`
    through `surgery._sample`, decoded at level 1 by the device decoder
    (`make_obs_decoder(model.graph)`), and level 2 decoded by
    `make_obs_decoder` of the level-2 graph. Level 1 and level 2 word
    failures are equal, shot for shot summed; level 2 corrects."""
    d, k, rounds_l, p, batch, reps, seed = 3, 3, 1, 6e-3, 128, 2, 11
    out = tconc._device_two_level(d, k, rounds_l, p, None, batch=batch,
                                  seed=seed, reps=reps, device=CPU)

    def record(model, p_, q_=None, *, batch, seed, use_native, device):
        decode = make_obs_decoder(model.graph, device=CPU)
        tensors = tsg._model_tensors(model, CPU)
        n_obs = model.obs.shape[0]
        parts = []
        for gen in chunk_generators(seed, reps, CPU):
            dets, ob = tsg._sample(gen, p_, p_, batch, *tensors)
            flips = decode(dets)[0].numpy().astype(np.int64)
            bits = (flips[:, None] >> np.arange(n_obs)[None, :]) & 1
            parts.append(ob.numpy() ^ bits.astype(np.uint8))
        return np.concatenate(parts)

    class DeviceDecoder:
        def __init__(self, graph, use_native=None):
            self.decode = make_obs_decoder(graph, device=CPU)

        def decode_batch(self, dets, want_corrections=False):
            flips = self.decode(torch.as_tensor(dets))[0].numpy()
            return None, flips.astype(np.int64)

    monkeypatch.setattr(tconc, "schedule_decoded_obs", record)
    monkeypatch.setattr(tconc, "UFDecoder", DeviceDecoder)
    host = tconc.logical_repetition_memory(d, k, rounds_l, p, batch=batch,
                                           seed=seed, device=CPU)
    assert host["samples"] == out["samples"] == batch * reps
    assert out["word_fail_l1"] == host["word_fail_l1"] > 0.05
    assert out["word_fail_l2"] == host["word_fail_l2"]
    assert out["word_fail_l2"] < out["word_fail_l1"] / 2


def _toy_graph(edges):
    e = np.asarray(edges, np.int32)
    return MatchingGraph(num_nodes=int(e.max()) + 1, edges=e,
                         edge_qubit=np.arange(len(e)),
                         edge_obs=np.ones(len(e), np.uint32),
                         n_qubits=len(e))


@pytest.mark.parametrize("name,reason", [
    ("level 2", None),
    ("level 1", "edge offsets"),
    ("boundary", "boundary edges"),
    ("parallel", "parallel edges"),
    ("self-loop", "self-loop"),
])
def test_stencil_refusal_says_why_the_stencil_is_refused(name, reason):
    """`device_uf.stencil_refusal` is None exactly when
    `build_device_graph` builds a stencil graph (the two-level memory's
    level-2 graph), and otherwise names the test that refused it: the
    level-1 graph's 17 edge offsets, five boundary edges on one detector,
    two edges between one pair, a self-loop."""
    graph = {
        "level 2": lambda: tconc.repetition_spacetime_graph(3, 4),
        "level 1": lambda: tconc._build_program(3, 3, 1)[1].graph,
        "boundary": lambda: _toy_graph([(0, 1)] + [(0, -1)] * 5),
        "parallel": lambda: _toy_graph([(0, 1), (1, 0), (1, -1)]),
        "self-loop": lambda: _toy_graph([(0, 1), (1, 1), (1, -1)]),
    }[name]()
    why = stencil_refusal(graph)
    assert (why is None) == (build_device_graph(graph).stencil is not None)
    assert why is None if reason is None else reason in why


def test_quiet_and_guards():
    for decoder in ("host", "device-uf"):
        out = tconc.logical_repetition_memory(3, 3, 1, 0.0, 0.0, batch=64,
                                              decoder=decoder, device=CPU)
        assert out["word_fail_l1"] == out["word_fail_l2"] == 0.0
    with pytest.raises(ValueError, match="decoder"):
        tconc.logical_repetition_memory(3, 3, 2, 1e-3, decoder="bogus",
                                        device=CPU)
    with pytest.raises(ValueError, match="host BP"):
        tconc.logical_repetition_memory(3, 3, 2, 1e-3, decoder="device-uf",
                                        noise=object(), device=CPU)
    with pytest.raises(ValueError):
        tconc.repetition_spacetime_graph(1, 3)
