"""The port's benchmark scripts against the JAX package's.

* `threshold.crossings` equals the reference's on fixed rows (`wilson`,
  `make_noise` and `crossings` are the reference's text:
  tests/test_torch_import.py), and `threshold.run_point` sums the port's
  own `memory_experiment` calls at its seeds (the rates themselves are
  held against the JAX package's in tests/test_torch_memory.py);
* `error_curve` resumes from its checkpoint, and its rows are
  `error_rate_curve`'s at the same seed;
* `bp_bench`'s spacetime row decodes the same syndromes to the same flips
  as the JAX package's `BPDecoder`, and its stream and gap rows run;
* the roofline's work counts are functions of shape equal to their sums
  worked by hand.
"""

import json

import numpy as np
import pytest
import torch

from benchmarks import threshold as jthreshold
from qcss_tpu.decode.bp import BPDecoder as JBPDecoder
from qcss_tpu_torch.benchmarks import bp_bench, error_curve, roofline
from qcss_tpu_torch.benchmarks import threshold
from qcss_tpu_torch.codes.families import rotated_surface
from qcss_tpu_torch.decode.bp import BPDecoder
from qcss_tpu_torch.decode.sweep import error_rate_curve
from qcss_tpu_torch.experiments.memory import memory_experiment

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # several worker processes run at once; see test_torch_device_uf.py
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows():
    # three distances over five rates: d=3/5 cross between the 2nd and 3rd
    # rate, d=5/7 between the 3rd and 4th; d=7/9 never cross
    fails = {3: [2e-3, 4e-3, 8e-3, 1.6e-2, 3.2e-2],
             5: [1e-3, 3e-3, 9e-3, 2.7e-2, 8.1e-2],
             7: [5e-4, 2e-3, 8.5e-3, 3e-2, 1e-1],
             9: [1e-4, 5e-4, 2e-3, 8e-3, 2e-2]}
    ps = [3e-3, 4e-3, 5e-3, 6e-3, 7e-3]
    return [{"d": d, "p": p, "logical_fail": f}
            for d, fs in fails.items() for p, f in zip(ps, fs)]


def test_crossings_equal_reference():
    rows = _rows()
    got = threshold.crossings([dict(r) for r in rows])
    assert got == jthreshold.crossings([dict(r) for r in rows])
    assert len(got) == 2 and 4e-3 < got[0] < got[1] < 6e-3


def test_run_point_sums_its_memory_experiments():
    row = threshold.run_point(3, 6e-3, 1 << 12, 5, "device-dem", 1 << 11,
                              device="cpu")
    noise = threshold.make_noise(6e-3, "uniform")
    fails = sum(round(memory_experiment(
        rotated_surface(3), rounds=3, noise=noise, batch=1 << 11,
        seed=5 * 1000 + rep, decoder="device-dem", engine="frames",
        device="cpu")["logical_fail"] * (1 << 11)) for rep in range(2))
    assert row["shots"] == 1 << 12 and row["fails"] == fails > 0
    assert (row["ci_lo"], row["ci_hi"]) == threshold.wilson(fails, 1 << 12)


def test_error_curve_resumes_from_its_checkpoint(tmp_path, capsys):
    path = tmp_path / "curve.jsonl"
    args = ["--code", "steane", "--samples", "2048", "--batch", "2048",
            "--device", "cpu", "--checkpoint", str(path)]
    first = error_curve.main(args + ["--ps", "0.01", "0.05"])
    want = error_rate_curve(error_curve.CODES["steane"](), [0.01, 0.05],
                            samples_per_point=2048, batch=2048, device="cpu")
    assert [{k: r[k] for k in w} for r, w in zip(first, want)] == want
    # a point already in the file is read back, not sampled again
    lines = path.read_text().splitlines()
    marked = dict(json.loads(lines[0]), word_fail=0.5)
    path.write_text("\n".join([json.dumps(marked)] + lines[1:]) + "\n")
    again = error_curve.main(args + ["--ps", "0.01", "0.05", "0.1"])
    assert again[0]["word_fail"] == 0.5 and again[1] == first[1]
    assert again[2]["p"] == 0.1 and len(path.read_text().splitlines()) == 3
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert printed[-3:] == again


def test_spacetime_row_decodes_like_jax():
    args = ("bb72", 6, 2e-2, 2e-2, 64)  # some shots reach the OSD tail
    tan, priors, obs, ev, syn = bp_bench.spacetime_case(*args, seed=0)
    flips_j, conv_j = JBPDecoder(tan, priors, logicals=obs,
                                 iters=16).decode_obs(syn)
    flips_t, conv_t = BPDecoder(tan, priors, logicals=obs, iters=16,
                                device="cpu").decode_obs(syn)
    np.testing.assert_array_equal(flips_t, np.asarray(flips_j))
    np.testing.assert_array_equal(np.asarray(conv_t), np.asarray(conv_j))
    row = bp_bench.bench_spacetime(*args, iters=16, reps=1, seed=0,
                                   device=CPU)
    true = (ev.astype(np.int64) @ obs.T.astype(np.int64)) & 1
    assert row["word_fail"] == float((flips_t ^ true).any(axis=1).mean())
    assert row["bp_converged"] == float(np.asarray(conv_t).mean()) < 1.0
    assert row["detectors"] == tan.shape[0] and row["variables"] == \
        tan.shape[1]


def test_stream_and_gap_rows_run():
    rows = bp_bench.main(["--cpu", "--codes", "bb72", "--batch", "32",
                          "--iters", "8", "--reps", "1", "--stream", "9",
                          "--gap"])
    assert [r["bench"] for r in rows] == [
        "bp_code_capacity", "bp_stream", "bp_gap_postselect"]
    assert rows[1]["round_shots_per_sec"] > 0
    assert [c["tau"] for c in rows[2]["curve"]] == [0.0, 5.0, 10.0, 20.0]


def test_roofline_work_counts_are_the_hand_sums():
    # [B, r*dc] x [r*dc, n] at B=2, r=3, dc=4, n=5: 2*2*12*5 multiply-adds
    # and 2*5 adds of lam; 4 bytes each of m (24), scat (60), lam (5) and
    # the totals (10)
    assert roofline.bp_totals_work(2, 3, 4, 5) == (250.0, 4 * 99)
    # B=2 r=3 n=5 C=4: W=1; h_t 15, synd 6, soft 40, order 64, prs 64,
    # hass 8, e 8, aug 48 bytes; 4 columns x 6 rows x (2 + 1) ops
    assert roofline.osd_work(2, 3, 5, 4) == (253, 72)
    # C=70 spans two words (W=2) for columns 0-63 and one for 64-69
    _, ops = roofline.osd_work(1, 1, 70, 70)
    assert ops == 64 * 5 + 6 * 3
    assert roofline.uf_floor_bytes(4096, 1452) == 4096 * 1452 + 4 * 4096
    assert roofline.k1_bytes(2, 5, 1, 7, 3, 4) == 4 * (4 * 10 + 14)
