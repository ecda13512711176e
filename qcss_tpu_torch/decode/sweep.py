"""Logical-error-rate curves vs physical error rate, with checkpoint/resume
(PyTorch port of `qcss_tpu.decode.sweep`).

Completed points checkpoint to a JSON-lines file and a restarted sweep
resumes after the last finished point; with a mesh, each point's sampling
shards over its devices (`parallel.sharded_logical_error_rate`).
"""

from __future__ import annotations

import json
import os

from qcss_tpu_torch.decode.montecarlo import logical_error_rate


def error_rate_curve(code, ps, *, samples_per_point: int = 1 << 20,
                     batch: int = 1 << 18, seed: int = 0,
                     checkpoint_path: str | None = None, mesh=None,
                     device="cuda") -> list[dict]:
    """Estimate logical error rates at each physical rate in ``ps``.

    Returns a list of point dicts ``{"p": ..., "x_fail": ..., "z_fail":
    ..., "word_fail": ..., "samples": ...}``. With ``checkpoint_path``,
    each completed point is appended to the file and already-present
    points are not recomputed. With ``mesh`` (`parallel.make_mesh`),
    sampling shards over the mesh's devices and ``device`` is unused.
    """
    done: dict[float, dict] = {}
    if checkpoint_path and os.path.exists(checkpoint_path):
        with open(checkpoint_path) as f:
            for line in f:
                line = line.strip()
                if line:
                    point = json.loads(line)
                    done[point["p"]] = point

    results = []
    for i, p in enumerate(ps):
        p = float(p)
        if p in done:
            results.append(done[p])
            continue
        if mesh is not None:
            from qcss_tpu_torch.parallel import sharded_logical_error_rate

            rates = sharded_logical_error_rate(
                code, p, mesh=mesh, samples=samples_per_point, batch=batch,
                seed=seed + i)
        else:
            rates = logical_error_rate(code, p, samples=samples_per_point,
                                       batch=batch, seed=seed + i,
                                       device=device)
        point = {"p": p, **rates}
        results.append(point)
        if checkpoint_path:
            with open(checkpoint_path, "a") as f:
                f.write(json.dumps(point) + "\n")
    return results
