"""The port's declarative patch schedules (`qcss_tpu_torch.experiments.
patches`) against the JAX package's, on the CPU.

`build_schedule` is a copy (tests/test_torch_import.py), and the
parity chain it builds must equal the reference's array for array at
d=3, weighted and unweighted: that equality is what lets the port
inherit test_patches.py's bit-identity with the bespoke builders and
its tableau gold (TestTableauGoldParityChain), which are not re-run
here. The fused pipeline's decoders (`_device_decoder`: the dense
stencil decoder, and the sparse one with the dense behind it, sized by
the reference's rule) must give the reference's `make_obs_decoder` /
`make_hybrid_obs_decoder` flips on the same numpy-drawn detectors. The
samplers are held by rates (two-sample 99.9%).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcss_tpu.decode import device_sparse as jds
from qcss_tpu.decode import device_uf as jduf
from qcss_tpu.experiments import patches as jpatches
from qcss_tpu_torch.decode.uf import UFDecoder
from qcss_tpu_torch.experiments import patches as tpatches
from qcss_tpu_torch.experiments import surgery as tsg
from qcss_tpu_torch.sim.noise import chunk_generators

Z999 = 3.2905
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


@pytest.fixture(scope="module")
def chain():
    return tpatches.parity_chain_model(3)


@pytest.mark.parametrize("weighted", [False, True])
def test_parity_chain_model_bit_identical(weighted):
    # stands in for test_patches.py::TestBitIdentity (inherited through
    # the copied builder) and TestParityChain's model
    kw = dict(p=3e-3, q=6e-3) if weighted else {}
    mt = tpatches.parity_chain_model(3, **kw)
    mj = jpatches.parity_chain_model(3, **kw)
    assert (mt.n, mt.n_phases) == (mj.n, mj.n_phases)
    for attr in ("F", "obs", "fault_probs_class"):
        np.testing.assert_array_equal(getattr(mt, attr), getattr(mj, attr))
    gt, gj = mt.graph, mj.graph
    assert gt.num_nodes == gj.num_nodes and gt.n_qubits == gj.n_qubits
    for attr in ("edges", "edge_qubit", "edge_obs", "edge_weight"):
        a, b = getattr(gt, attr), getattr(gj, attr)
        assert (a is None) == (b is None), attr
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert mt.meta["data_faults"] == mj.meta["data_faults"]
    assert mt.meta["meas_faults"] == mj.meta["meas_faults"]
    np.testing.assert_array_equal(mt.meta["phase_starts"],
                                  mj.meta["phase_starts"])


def test_parity_chain_singles_and_quiet(chain):
    # test_patches.py::TestParityChain::test_singles_and_quiet: every
    # single fault decodes exactly; quiet runs, host and fused, are 0
    _, corr = UFDecoder(chain.graph).decode_batch(
        chain.F.T.astype(np.uint8), want_corrections=False)
    for i in range(chain.obs.shape[0]):
        assert not (chain.obs[i] ^ ((corr >> i) & 1)).any(), i
    out = tpatches.schedule_memory(chain, 0.0, batch=128, device=CPU)
    assert out["word_fail"] == 0.0
    for kind in ("dense", "hybrid"):
        out = tpatches.schedule_memory_device(
            chain, 0.0, batch=128, reps=2, device_decoder=kind, device=CPU)
        assert out["word_fail"] == 0.0 and out["samples"] == 256


def _reference_hybrid_d_max(model, p, q):
    # the reference's sizing rule (qcss_tpu/experiments/patches.py:697-706)
    rates = np.where(model.fault_probs_class == 1, q, p)
    lam = model.F.astype(np.float64) @ rates
    mean_d = float((0.5 * (1.0 - np.exp(-2.0 * lam))).sum())
    return int(np.clip(
        16 * np.ceil((mean_d + 6 * np.sqrt(mean_d + 1)) / 16), 32, 96))


@pytest.mark.parametrize("kind", ["dense", "hybrid"])
def test_device_decode_matches_reference(chain, kind):
    """The fused pipeline's decode on numpy-drawn detectors: 512 shots at
    p=1e-2 and 8 at 0.15, past the hybrid's d_max (its dense escape)."""
    p = 1e-2
    rng = np.random.default_rng(7)
    nf = chain.F.shape[1]
    faults = np.concatenate([rng.random((512, nf)) < p,
                             rng.random((8, nf)) < 0.15]).astype(np.int64)
    dets = ((faults @ chain.F.T) & 1).astype(np.uint8)
    mj = jpatches.parity_chain_model(3)
    if kind == "dense":
        jdec = jduf.make_obs_decoder(mj.graph)
    else:
        d_max = _reference_hybrid_d_max(mj, p, p)
        assert d_max == 32 and dets.sum(1).max() > d_max
        jdec = jds.make_hybrid_obs_decoder(mj.graph, d_max=d_max)
    jo, jc = jax.jit(jdec)(jnp.asarray(dets))
    to, tc = tpatches._device_decoder(chain, p, p, kind, CPU)(
        torch.as_tensor(dets))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_fused_counts_are_the_decodes(chain):
    """`schedule_memory_device` counts what its decoder makes of its own
    draws (rep r from `chunk_generators(seed, reps)`'s generator r)."""
    p, batch, reps, seed = 1e-2, 256, 2, 5
    out = tpatches.schedule_memory_device(chain, p, batch=batch, reps=reps,
                                          seed=seed, device=CPU)
    decode = tpatches._device_decoder(chain, p, p, "dense", CPU)
    tensors = tsg._model_tensors(chain, CPU)
    fails = []
    for gen in chunk_generators(seed, reps, CPU):
        dets, ob = tsg._sample(gen, p, p, batch, *tensors)
        flips = decode(dets)[0].numpy()
        bits = (flips[:, None] >> np.arange(ob.shape[1])[None, :]) & 1
        fails.append(bits ^ ob.numpy())
    fails = np.concatenate(fails)
    assert out["word_fail"] == fails.any(axis=1).mean() > 0
    for i in range(fails.shape[1]):
        assert out[f"obs{i}_fail"] == fails[:, i].mean()


def test_parity_chain_rate_matches_reference():
    # stands in for test_patches.py::TestParityChain::
    # test_suppression_with_distance at d=3 only: every channel's count
    B, p = 8192, 1e-2
    ref = jpatches.parity_chain_memory(3, p, batch=B, seed=4)
    got = tpatches.parity_chain_memory(3, p, batch=B, seed=4, device=CPU)
    for k in ("m0_fail", "m1_fail", "z0_fail", "z1_fail", "z2_fail",
              "word_fail"):
        kr, kp = round(ref[k] * B), round(got[k] * B)
        pooled = (kr + kp) / (2 * B)
        assert kr > 20, (k, kr)
        assert abs(kr - kp) / B <= Z999 * math.sqrt(
            pooled * (1 - pooled) * 2 / B), (k, kp, kr)


def test_fused_guards(chain):
    # the reference's guards (patches.py:759-766)
    wide = dataclasses.replace(chain, obs=np.zeros((25, chain.F.shape[1]),
                                                   np.uint8))
    with pytest.raises(ValueError, match="int32"):
        tpatches.schedule_memory_device(wide, 1e-3, device=CPU)
    with pytest.raises(ValueError, match="overflow"):
        tpatches.schedule_memory_device(chain, 1e-3, batch=1 << 20,
                                        reps=1 << 11, device=CPU)
