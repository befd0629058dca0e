"""Scaling-efficiency measurement (BASELINE: >=85% rays/s 1 -> N).

Renders the prepared scene on meshes of growing device counts and
reports throughput and efficiency vs the single-device baseline, plus a
work-balance diagnostic (max/mean DDA steps per shard) that predicts
scaling before several devices are available: lock-step waves scale at
mean/max balance, which is what the round-robin tile striding in
parallel/shard.py is there to fix.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import jax
import numpy as np

from ray_tracer_tpu.parallel.mesh import make_mesh
from ray_tracer_tpu.parallel.shard import render_sharded, stride_permutation


def scaling_report(
    prep,
    device_counts: Optional[List[int]] = None,
    repeats: int = 3,
) -> Dict[str, object]:
    """Throughput vs device count on the current platform.

    On real devices this is the BASELINE scaling metric; on the CPU
    simulation it validates the machinery and the balance diagnostic
    (virtual-device times share one host, so efficiency there is not
    meaningful hardware data).
    """
    n_avail = len(jax.devices())
    if device_counts is None:
        device_counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= n_avail]

    cam = prep.cfg.camera
    rays = cam.width * cam.height * 2  # primary + shadow
    rows = []
    base_per_device = None
    for n in device_counts:
        mesh = make_mesh(n, ("rays",))
        jax.block_until_ready(render_sharded(prep, mesh=mesh))  # compile
        t0 = time.perf_counter()
        img = None
        for _ in range(repeats):
            img = render_sharded(prep, mesh=mesh)
        jax.block_until_ready(img)
        sec = (time.perf_counter() - t0) / repeats
        mrays = rays / sec / 1e6
        if base_per_device is None:
            # normalize per device so the report is correct even when
            # device_counts does not start at 1
            base_per_device = mrays / n
        rows.append({
            "devices": n,
            "mrays_per_s": round(mrays, 4),
            "efficiency": round((mrays / n) / base_per_device, 4),
        })
    out = {"rays_per_frame": rays, "rows": rows}
    if jax.devices()[0].platform == "cpu":
        # make the record self-describing: a CPU-simulation efficiency
        # column is NOT hardware evidence and must say so in the JSON
        # itself, not just in this docstring
        out["note"] = ("virtual CPU devices share host cores; validates "
                       "machinery+balance, not hardware")
    return out


def balance_report(prep, n_shards: int) -> Dict[str, float]:
    """Predicted lock-step scaling limit from per-shard work balance.

    Splits the primary rays into n_shards with (a) contiguous and
    (b) round-robin assignment and reports mean/max traversal steps —
    efficiency of a lock-step fleet is bounded by mean/max.
    """
    from ray_tracer_tpu.ops.camera import camera_rays
    from ray_tracer_tpu.ops.traverse import traverse_grid
    from ray_tracer_tpu.ops.traverse_packed import traverse_packed

    rays = camera_rays(prep.cfg.camera)
    if prep.cfg.render.traversal == "packed":
        res = traverse_packed(
            rays, prep.packed.arrays, prep.packed.meta, t_gate=1e-4
        )
    else:
        v0, v1, v2 = prep.scene.triangle_soa()
        res = traverse_grid(
            rays, prep.grid.arrays, prep.grid.meta, v0, v1, v2,
            t_gate=1e-4, early_exit=True,
        )
    steps = np.asarray(jax.device_get(res.steps)).astype(np.float64)
    r = steps.shape[0]
    pad = (-r) % n_shards
    steps = np.concatenate([steps, np.zeros(pad)])

    def eff(assignment):
        shard_work = assignment.reshape(n_shards, -1).sum(axis=1)
        return float(shard_work.mean() / shard_work.max())

    contiguous = eff(steps.reshape(-1))
    perm = stride_permutation(steps.shape[0], n_shards)
    strided = eff(steps[perm])  # shard s gets items s, s+n, s+2n, ...
    return {
        "n_shards": n_shards,
        "balance_contiguous": round(contiguous, 4),
        "balance_round_robin": round(strided, 4),
    }
