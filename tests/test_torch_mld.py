"""The port's exact maximum-likelihood decoder (`qcss_tpu_torch.decode.mld`)
against the JAX package's, on the CPU.

The coset scores are float32 matmuls and logsumexps, which the two
packages evaluate in their own order, so class scores are held to rtol
2e-3 in probability (the reference's own tolerance against brute force,
tests/test_mld.py) and the chosen flips exactly wherever the best two
classes are apart by more than that. Each test names the reference test
it stands in for and stays far below its size.
"""

import math

import numpy as np
import pytest
import torch

from qcss_tpu.codes import families as jfam
from qcss_tpu.decode import mld as jmld
from qcss_tpu_torch.codes import families as tfam
from qcss_tpu_torch.decode import mld as tmld

Z999 = 3.2905


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # several worker processes run at once; see test_torch_device_uf.py
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _all_syndromes(r):
    idx = np.arange(1 << r)
    return ((idx[:, None] >> np.arange(r)[None, :]) & 1).astype(np.uint8)


def _clear(scores, rtol=2e-3):
    """Shots whose best class beats the second by more than rtol."""
    if scores.shape[0] == 1:
        return np.ones(scores.shape[1], bool)
    top = np.sort(scores, axis=0)
    return top[-1] - top[-2] > math.log1p(rtol)


@pytest.mark.parametrize("name", ["steane", "surface3"])
def test_every_syndrome_equals_reference(name):
    """Stands in for test_mld.py::test_matches_brute_force: every syndrome
    of Steane and rotated surface d=3 at p=0.08; class probabilities
    within rtol 2e-3 of the reference's, flips equal (every syndrome here
    has a clear best class), and `device_decode_fn` equal to
    `decode_flips` and to the reference's."""
    make = {"steane": "steane", "surface3": "rotated_surface"}[name]
    args = () if name == "steane" else (3,)
    code_j, code_t = getattr(jfam, make)(*args), getattr(tfam, make)(*args)
    p = 0.08
    ref = jmld.MLDecoder.for_code(code_j, p=p)
    port = tmld.MLDecoder.for_code(code_t, p=p, device="cpu")
    np.testing.assert_array_equal(port._coset, ref._coset)
    np.testing.assert_array_equal(port._piv, ref._piv)
    np.testing.assert_array_equal(port._t, ref._t)
    syn = _all_syndromes(np.asarray(code_j.parity_check_c2).shape[0])
    f_ref, s_ref = ref.decode_flips(syn, return_scores=True)
    f_port, s_port = port.decode_flips(syn, return_scores=True)
    np.testing.assert_allclose(np.exp(s_port), np.exp(s_ref), rtol=2e-3)
    assert _clear(s_ref).all()
    np.testing.assert_array_equal(f_port, f_ref)
    llr = torch.full((len(syn), code_t.n), math.log(p / (1 - p)))
    dev = port.device_decode_fn()(torch.tensor(syn), llr)
    assert dev.dtype == torch.uint8
    np.testing.assert_array_equal(dev.numpy(), f_port)


def test_per_shot_llr_and_k2_equal_reference():
    """Stands in for test_mld.py::test_soft_priors_run_and_default_matches
    and test_k2_code_shapes: random per-shot LLRs on toric d=3 (k=2, four
    classes), 256 shots; flips equal to the reference's wherever the best
    two classes are clear (all but the counted near-ties), and
    `device_decode_fn` equal to `decode_flips` on every shot."""
    code_j, code_t = jfam.toric(3), tfam.toric(3)
    rng = np.random.default_rng(3)
    errs = (rng.random((256, code_t.n)) < 0.05).astype(np.uint8)
    syn = (errs @ np.asarray(code_t.parity_check_c2, np.uint8).T) & 1
    llr = np.log(rng.uniform(0.01, 0.2, (256, code_t.n))
                 / 0.9).astype(np.float32)
    ref = jmld.MLDecoder.for_code(code_j, p=0.05)
    port = tmld.MLDecoder.for_code(code_t, p=0.05, device="cpu")
    f_ref, s_ref = ref.decode_flips(syn, llr=llr, return_scores=True)
    f_port, s_port = port.decode_flips(syn, llr=llr, return_scores=True)
    assert f_port.shape == (256, 2)
    np.testing.assert_allclose(np.exp(s_port), np.exp(s_ref), rtol=2e-3)
    clear = _clear(s_ref)
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(f_port[clear], f_ref[clear])
    dev = port.device_decode_fn()(torch.tensor(syn), torch.tensor(llr))
    np.testing.assert_array_equal(dev.numpy(), f_port)


def test_erasure_llr_below_d_equals_reference():
    """Stands in for test_mld.py::TestErasure::test_pure_erasure_below_d_
    exact: rotated surface d=5, 200 shots, four erased qubits each
    (llr 0) with random flips there; the port's flips equal the
    reference's and the truth."""
    code_j, code_t = jfam.rotated_surface(5), tfam.rotated_surface(5)
    h = np.asarray(code_t.parity_check_c2, np.uint8)
    lz = code_t.z_operator_matrix()
    rng = np.random.default_rng(0)
    n = code_t.n
    base = np.log(1e-3 / (1 - 1e-3))
    errs = np.zeros((200, n), np.uint8)
    llrs = np.full((200, n), base, np.float32)
    for b in range(200):
        er = rng.choice(n, size=4, replace=False)
        errs[b, er] = rng.integers(0, 2, 4)
        llrs[b, er] = 0.0
    syn = (errs @ h.T) & 1
    f_ref = jmld.MLDecoder.for_code(code_j, p=1e-3).decode_flips(syn,
                                                                llr=llrs)
    f_port = tmld.MLDecoder.for_code(code_t, p=1e-3,
                                     device="cpu").decode_flips(syn,
                                                                llr=llrs)
    np.testing.assert_array_equal(f_port, f_ref)
    assert (f_port == ((errs @ lz.T) & 1)).all()


def test_too_large_refused():
    """Stands in for test_mld.py::test_too_large_refused."""
    bb = tfam.bb72()
    with pytest.raises(ValueError, match="class"):
        tmld.MLDecoder.for_code(bb, p=0.01, device="cpu")
    with pytest.raises(ValueError, match="exponential"):
        tmld.MLDecoder(bb.parity_check_c2, bb.parity_check_c1,
                       bb.x_operator_matrix()[:1],
                       bb.z_operator_matrix()[:1], p=0.01, device="cpu")


def test_mld_rate_matches_reference():
    """Stands in for test_mld.py::test_ml_not_worse_than_lut: rotated
    surface d=3, p=0.12, 4096 shots each. The port draws its own errors,
    so its ML and LUT failure counts are held to the reference's by a
    two-sample 99.9% test; on the port's shots ML is no worse than the
    LUT."""
    n = 4096
    ref = jmld.mld_logical_error_rate(jfam.rotated_surface(3), 0.12,
                                      batch=n, seed=1)
    port = tmld.mld_logical_error_rate(tfam.rotated_surface(3), 0.12,
                                       batch=n, seed=1, device="cpu")
    assert port["n_shots"] == ref["n_shots"] == n
    for key in ("word_fail_ml", "word_fail_lut"):
        pooled = (ref[key] + port[key]) / 2
        spread = Z999 * math.sqrt(2 * pooled * (1 - pooled) / n)
        assert abs(ref[key] - port[key]) <= spread, (key, ref, port)
    assert port["word_fail_ml"] < port["word_fail_lut"]
