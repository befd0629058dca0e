"""Uniform-grid 3D-DDA traversal as a masked, fixed-bound vector march.

Batched re-design of the reference's per-ray PBRT grid walk
(Serial/grid.h:167-231, Parallel/grid.cuh:224-290).  Instead of one
divergent loop per ray, a whole ray batch advances in lock-step inside a
single `lax.while_loop`: every live ray tests the (padded) triangle list
of its current voxel, then steps one voxel along its dominant crossing
axis.  Dead lanes are frozen by predication; the loop ends when every
lane is dead, bounded by nx+ny+nz steps.

Faithfulness knobs reproduce the reference's exact hit semantics:

  * `t_gate=None` — the serial primary-ray regime: ANY barycentric pass
    updates the nearest hit, including t < 0 hits behind the origin
    (Serial/geometry.h:164-171 with use_eps == false).
  * `t_gate=eps` — the serial shadow regime (use_eps == true,
    geometry.h:166-167) and the CUDA variant's always-on t > eps gate
    (Parallel/geometry.cuh:155-161).
  * `any_pass` in the result is the reference's `hitSomething` — true if
    ANY triangle in a walked voxel passed the barycentric test even when
    no t-update happened; the serial shadow test consumes exactly this
    (Serial/raytracer.cpp:110-112).
  * `early_exit=False` walks the full ray extent like the reference
    (no break on hit); `early_exit=True` is the fast production mode
    that retires a ray once its recorded hit precedes the next voxel
    boundary (and, with `stop_on_first_hit`, on any accepted hit —
    the shadow-ray fast path).

The voxel step-axis selection uses the reference's 3-comparison bitmask
LUT cmpToAxis = [2,1,2,1,2,2,0,0] (grid.h:217-221).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ray_tracer_tpu.accel.grid import GridArrays, GridMeta
from ray_tracer_tpu.core.aabb import AABB, slab_intersect
from ray_tracer_tpu.core.rays import RayBatch
from ray_tracer_tpu.ops.intersect import barycentric_pass, cramer_tbg

# numpy (not jnp) so importing this module never initializes a backend —
# required for jax.distributed.initialize to run first on multi-host.
_CMP_TO_AXIS = np.asarray([2, 1, 2, 1, 2, 2, 0, 0], dtype=np.int32)


class TraceResult(NamedTuple):
    any_pass: jnp.ndarray  # (R,) bool — reference 'hitSomething'
    hit: jnp.ndarray  # (R,) bool — a nearest-hit record exists
    t: jnp.ndarray  # (R,) f32 nearest accepted t
    tri_id: jnp.ndarray  # (R,) i32 (-1 if no record)
    steps: jnp.ndarray  # (R,) i32 voxels visited (diagnostics)


def _dda_setup(rays: RayBatch, grid: GridArrays, n_voxels):
    """Grid entry + per-axis DDA state (Serial/grid.h:170-203)."""
    bounds = AABB(grid.lower, grid.upper)
    inside = bounds.inside(rays.at(rays.mint))
    slab_hit, t0, _ = slab_intersect(bounds, rays)
    ray_t = jnp.where(inside, rays.mint, t0)
    alive = inside | slab_hit

    gi = rays.at(ray_t)  # (R,3) grid entry point
    nvox = jnp.asarray(n_voxels, dtype=jnp.int32)
    pos_f = (gi - grid.lower) * grid.inv_width
    pos = jnp.clip(pos_f.astype(jnp.int32), 0, nvox - 1)  # C trunc-toward-zero

    dir_nonneg = rays.dirn >= 0
    step = jnp.where(dir_nonneg, 1, -1).astype(jnp.int32)
    out = jnp.where(dir_nonneg, nvox, -1).astype(jnp.int32)
    # voxelToPos(p, axis) = lower + p * width (grid.h:68-71)
    next_boundary = grid.lower + jnp.where(
        dir_nonneg, (pos + 1).astype(gi.dtype), pos.astype(gi.dtype)
    ) * grid.width
    next_crossing = ray_t[:, None] + (next_boundary - gi) / rays.dirn
    delta = jnp.where(dir_nonneg, grid.width, -grid.width) / rays.dirn
    return alive, pos, next_crossing, delta, step, out


@partial(
    jax.jit,
    static_argnames=(
        "meta", "t_gate", "early_exit", "stop_on_first_hit", "det_dtype", "max_steps",
    ),
)
def traverse_grid(
    rays: RayBatch,
    grid: GridArrays,
    meta: GridMeta,
    v0: jnp.ndarray,
    v1: jnp.ndarray,
    v2: jnp.ndarray,
    *,
    t_gate: Optional[float] = None,
    early_exit: bool = False,
    stop_on_first_hit: bool = False,
    det_dtype: str = "float32",
    max_steps: Optional[int] = None,
) -> TraceResult:
    nx, ny, nz = meta.n_voxels
    m_pad = max(meta.max_per_voxel, 1)
    nnz = max(meta.nnz, 1)
    ddt = jnp.dtype(det_dtype)
    if max_steps is None:
        max_steps = nx + ny + nz + 2

    r = rays.count
    if v0.shape[0] == 0:
        # empty mesh: build_grid supports it ("a valid empty grid, not a
        # crash") — so must the trace; the v0[tri] gathers below would
        # fail on a zero-length axis
        zb = jnp.zeros((r,), bool)
        return TraceResult(
            any_pass=zb, hit=zb,
            t=jnp.full((r,), jnp.inf, jnp.float32),
            tri_id=jnp.full((r,), -1, jnp.int32),
            steps=jnp.zeros((r,), jnp.int32),
        )
    alive0, pos0, next_crossing0, delta, step, out = _dda_setup(rays, grid, meta.n_voxels)

    tri_ids = grid.tri_ids if meta.nnz > 0 else jnp.zeros((1,), jnp.int32)
    big = jnp.asarray(jnp.inf, jnp.float32)
    j_idx = jnp.arange(m_pad, dtype=jnp.int32)

    def cond(state):
        i, alive, *_ = state
        return (i < max_steps) & jnp.any(alive)

    def body(state):
        i, alive, pos, next_crossing, any_pass, found, t_min, best, steps = state

        # ---- test every live ray's current voxel --------------------------
        xc = jnp.clip(pos[:, 0], 0, nx - 1)
        yc = jnp.clip(pos[:, 1], 0, ny - 1)
        zc = jnp.clip(pos[:, 2], 0, nz - 1)
        cell = zc * (nx * ny) + yc * nx + xc  # z-major (grid.h:73-75)
        start = grid.cell_start[cell]
        count = grid.cell_start[cell + 1] - start

        idx = jnp.clip(start[:, None] + j_idx[None, :], 0, nnz - 1)
        tri = tri_ids[idx]  # (R, M)
        valid = (j_idx[None, :] < count[:, None]) & alive[:, None]

        t, beta, gamma = cramer_tbg(
            rays.orig[:, None, :], rays.dirn[:, None, :],
            v0[tri], v1[tri], v2[tri], det_dtype=ddt,
        )
        passed = barycentric_pass(beta, gamma) & valid
        any_pass = any_pass | jnp.any(passed, axis=-1)

        cand = passed if t_gate is None else passed & (t > t_gate)
        t_masked = jnp.where(cand, t, jnp.asarray(jnp.inf, ddt))
        j_best = jnp.argmin(t_masked, axis=-1)
        m = jnp.take_along_axis(t_masked, j_best[:, None], axis=-1)[:, 0]
        # cross-step compare in det precision against the f32 running min,
        # mirroring the oracle's double-vs-float global_t compare
        # (Serial/geometry.h:164-169).
        upd = m < t_min.astype(ddt)
        t_min = jnp.where(upd, m.astype(jnp.float32), t_min)
        best = jnp.where(upd, jnp.take_along_axis(tri, j_best[:, None], axis=-1)[:, 0], best)
        found = found | upd

        # ---- advance to the next voxel (grid.h:214-228) -------------------
        n0, n1, n2 = next_crossing[:, 0], next_crossing[:, 1], next_crossing[:, 2]
        bits = (
            4 * (n0 < n1).astype(jnp.int32)
            + 2 * (n0 < n2).astype(jnp.int32)
            + (n1 < n2).astype(jnp.int32)
        )
        step_axis = jnp.asarray(_CMP_TO_AXIS)[bits]  # (R,)
        onehot = step_axis[:, None] == jnp.arange(3, dtype=jnp.int32)[None, :]
        ncr = jnp.take_along_axis(next_crossing, step_axis[:, None], axis=1)[:, 0]

        maxt_eff = rays.maxt
        if early_exit:
            maxt_eff = jnp.minimum(maxt_eff, jnp.where(found, t_min, big))
        die_maxt = maxt_eff < ncr

        move = alive & ~die_maxt
        pos_new = pos + jnp.where(onehot, step, 0)
        pos = jnp.where(move[:, None], pos_new, pos)
        hit_edge = jnp.take_along_axis(pos == out, step_axis[:, None], axis=1)[:, 0]
        die_out = move & hit_edge
        next_crossing = jnp.where(
            move[:, None], next_crossing + jnp.where(onehot, delta, 0.0), next_crossing
        )

        alive = move & ~die_out
        if stop_on_first_hit:
            alive = alive & ~found
        steps = steps + state[1].astype(jnp.int32)  # count pre-advance live lanes
        return (i + 1, alive, pos, next_crossing, any_pass, found, t_min, best, steps)

    # Derive the per-ray carry init from ray data (not fresh constants) so
    # its varying-mesh-axes type matches the body output under shard_map.
    zf = jnp.where(  # (R,) zeros, varying like the ray origins
        jnp.isfinite(rays.orig[:, 0]), 0.0, 0.0
    ).astype(jnp.float32)
    zi = zf.astype(jnp.int32)
    zb = zi != 0
    init = (
        jnp.asarray(0, jnp.int32),
        alive0,
        pos0,
        next_crossing0,
        zb,
        zb,
        zf + jnp.inf,
        zi - 1,
        zi,
    )
    _, _, _, _, any_pass, found, t_min, best, steps = jax.lax.while_loop(cond, body, init)
    return TraceResult(any_pass=any_pass, hit=found, t=t_min, tri_id=best, steps=steps)
