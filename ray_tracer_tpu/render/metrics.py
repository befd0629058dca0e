"""Structured render observability (SURVEY §5).

The reference's only diagnostics are printf'd queue counters and two
cudaEvent spans (Parallel/raytracer.cu:678-706).  Here: per-stage
structured metrics — rays traced, hit rates, DDA step statistics,
grid occupancy — collected in one device round-trip.
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from ray_tracer_tpu.ops.camera import camera_rays
from ray_tracer_tpu.ops.traverse import traverse_grid
from ray_tracer_tpu.ops.traverse_packed import traverse_packed
from ray_tracer_tpu.render.renderer import _pad_to, pad_rays, shadow_rays_for


def _summary(res, prefix: str, out: Dict[str, float]) -> None:
    steps = np.asarray(res["steps"])
    hit = np.asarray(res["hit"])
    out[f"{prefix}_rays"] = int(steps.size)
    out[f"{prefix}_hits"] = int(hit.sum())
    out[f"{prefix}_hit_rate"] = float(hit.mean())
    out[f"{prefix}_steps_mean"] = float(steps.mean())
    out[f"{prefix}_steps_p99"] = float(np.percentile(steps, 99))
    out[f"{prefix}_steps_max"] = int(steps.max())


def collect_render_metrics(prep) -> Dict[str, float]:
    """Trace the prepared scene's primary + shadow rays and report
    per-stage statistics plus grid occupancy.  One host round-trip."""
    cfg = prep.cfg
    rcfg = cfg.render
    # smooth normals are shading-only (every metric here is traversal
    # statistics, unaffected), but area-light sampling and spp change
    # the actual ray fan — refuse rather than report the wrong one
    if rcfg.shadow_samples > 1 and rcfg.light_radius > 0:
        raise NotImplementedError(
            "collect_render_metrics reports a single point-light "
            "shadow ray only"
        )
    if rcfg.spp != 1:
        raise NotImplementedError(
            "collect_render_metrics reports the pixel-center fan only"
        )
    packed = rcfg.traversal == "packed"
    rays = camera_rays(cfg.camera)

    if packed:
        arrays, meta = prep.packed.arrays, prep.packed.meta

        def trace(rb, gate, stop):
            return traverse_packed(
                rb, arrays, meta,
                t_gate=0.0 if gate is None else gate,
                stop_on_first_hit=stop,
            )
    else:
        v0, v1, v2 = prep.scene.triangle_soa()

        def trace(rb, gate, stop):
            # gate=None IS the faithful-serial policy (unrestricted t,
            # Serial/geometry.h:164-171) — traverse_grid takes it as-is
            return traverse_grid(
                rays=rb, grid=prep.grid.arrays, meta=prep.grid.meta,
                v0=v0, v1=v1, v2=v2, t_gate=gate,
                early_exit=not rcfg.faithful, stop_on_first_hit=stop,
                det_dtype=rcfg.det_dtype,
            )

    def trace_tiled(rb, gate, stop):
        # the same ray_tile chunking render_rays_tiled uses — one
        # untiled trace would materialize (R, max_per_voxel) buffers
        # for the whole frame and OOM on configs render() handles fine
        tile = min(rcfg.ray_tile, rb.count)
        padded = _pad_to(rb.count, tile)
        rbp = pad_rays(rb, padded)
        tiled = jax.tree.map(
            lambda x: x.reshape((padded // tile, tile) + x.shape[1:]), rbp
        )
        res = jax.lax.map(lambda t: trace(t, gate, stop), tiled)
        return jax.tree.map(
            lambda x: x.reshape((padded,) + x.shape[2:])[:rb.count], res
        )

    # Gates, acceptance and the shadow stop flag follow the SAME shared
    # policy the renderer consumes (RenderConfig methods +
    # shadow_rays_for) so these statistics describe the trace render()
    # actually performs — including the faithful-serial any_pass
    # acceptance and its non-early-exit shadow march.
    prim = trace_tiled(rays, rcfg.primary_gate(), False)
    p_acc = rcfg.accepted_hit(prim)

    # Miss lanes are sanitized at the INPUT (t = 0, not +inf) so their
    # direction math stays finite; shadow_rays_for then retires them
    # with +inf origins, same as render_rays.
    poi = rays.at(jnp.where(prim.hit, prim.t, 0.0))
    srays = shadow_rays_for(rcfg, prep.scene.light_pos, poi, p_acc)
    shad = trace_tiled(srays, rcfg.shadow_eps, not rcfg.faithful)
    s_acc = rcfg.accepted_hit(shad) & p_acc

    # single device pull
    dev = {
        "p_steps": prim.steps, "p_hit": p_acc,
        "s_steps": shad.steps, "s_hit": s_acc,
    }
    host = jax.device_get(dev)

    out: Dict[str, float] = {}
    _summary({"steps": host["p_steps"], "hit": host["p_hit"]}, "primary", out)
    _summary({"steps": host["s_steps"], "hit": host["s_hit"]}, "shadow", out)
    out["shadowed_fraction_of_hits"] = float(
        host["s_hit"].sum() / max(host["p_hit"].sum(), 1)
    )

    gm = prep.grid.meta
    out["grid_cells"] = int(gm.total_voxels)
    out["grid_nnz"] = int(gm.nnz)
    out["grid_max_per_voxel"] = int(gm.max_per_voxel)
    if prep.packed is not None:
        out["packed_blocks"] = int(prep.packed.meta.n_blocks)
    return out


def choose_camera_refill(prep, threshold: float = 0.45,
                         stride: int = 8) -> bool:
    """Policy for RenderConfig.camera_refill.

    The persistent wave's zero-gather camera refill (regenerate popped
    rays from their pixel index) won on the previous chip when a large
    fraction of camera rays never enter the grid AABB: failed pops
    re-run as arithmetic retries instead of charging rounds (spot: 61%
    dead).  At lower dead fractions the per-refill camera math cost
    more than the (W,8) table gather it replaces (nefertiti 1024^2: 33%
    dead; the parallel scene sits at 35%).  Rule: regen iff the strided
    slab probe finds >= threshold of camera rays never entering (0.45
    separates those scenes; carried over, not yet tuned on the H100)."""
    import dataclasses

    from ray_tracer_tpu.ops.traverse_packed import _slab_entry

    cfg = prep.cfg
    cam = dataclasses.replace(
        cfg.camera,
        width=max(cfg.camera.width // stride, 8),
        height=max(cfg.camera.height // stride, 8),
    )
    rays = camera_rays(cam)
    garr = (prep.packed.arrays if prep.packed is not None
            else prep.grid.arrays)
    import jax.numpy as jnp

    _, entered = _slab_entry(
        garr,
        rays.orig.astype(jnp.float32), rays.dirn.astype(jnp.float32),
        rays.mint.astype(jnp.float32), rays.maxt.astype(jnp.float32),
    )
    dead = 1.0 - float(np.asarray(entered).mean())
    return dead >= threshold


def estimate_coverage(prep, stride: int = 8) -> float:
    """Cheap scene-coverage probe: trace every `stride`-th pixel's
    primary ray (packed path) and return the hit rate.  One traversal
    over ~R/stride^2 rays — used to auto-pick the fused-vs-two-pass
    shadow schedule instead of a per-scene flag."""
    import dataclasses

    cfg = prep.cfg
    cam = dataclasses.replace(
        cfg.camera,
        width=max(cfg.camera.width // stride, 8),
        height=max(cfg.camera.height // stride, 8),
    )
    rays = camera_rays(cam)
    if prep.packed is not None:
        res = traverse_packed(rays, prep.packed.arrays, prep.packed.meta,
                              t_gate=0.0)
    else:
        v0, v1, v2 = prep.scene.triangle_soa()
        res = traverse_grid(
            rays=rays, grid=prep.grid.arrays, meta=prep.grid.meta,
            v0=v0, v1=v1, v2=v2, t_gate=0.0, early_exit=True,
            det_dtype=prep.cfg.render.det_dtype,
        )
    return float(np.asarray(res.hit).mean())


def choose_fused_shadow(prep, threshold: float = 0.75, stride: int = 8) -> bool:
    """Policy for RenderConfig.fused_shadow.

    Persistent scheduler: always fuse.  A retiring lane rearms in place
    and refills the same round, so there is no tile tail for the heavier
    fused body to waste — it won at BOTH ends of the density range on
    the previous chip (spot ~55% coverage and the 261k-tri stand-in at
    ~100%).

    Tiled scheduler: fusing won on SPARSE scenes (the shadow work hides
    in the primary tail) and lost on dense full-frame ones (every
    lock-step tile runs both phases and only the heavier body remains).
    The crossover sits well above spot and below full coverage —
    threshold 0.75, carried over and not yet tuned on the H100."""
    if prep.cfg.render.scheduler == "persistent":
        return True
    return estimate_coverage(prep, stride=stride) < threshold
