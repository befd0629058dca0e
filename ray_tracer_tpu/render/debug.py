"""Single-pixel debug hook.

The reference hard-wires a debug thread for pixel (275, 240) whose AABB
slab test prints bounds/ray state (Parallel/raytracer.cu:367,
Parallel/geometry.cuh:237-255).  The equivalent here: trace any
pixel through every stage and return the intermediates as a dict —
no special-cased kernel, just the same pure functions on a 1-ray batch.
"""

from __future__ import annotations

from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np

from ray_tracer_tpu.core.aabb import AABB, slab_intersect
from ray_tracer_tpu.core.rays import RayBatch
from ray_tracer_tpu.ops.camera import camera_rays
from ray_tracer_tpu.ops.traverse import traverse_grid
from ray_tracer_tpu.ops.traverse_packed import traverse_packed


def trace_pixel(prep, x: int, y: int, mesh=None,
                ring_grids=None) -> Dict[str, Any]:
    """Full diagnostic trace of pixel (x, y): camera ray, grid entry,
    traversal result, hit geometry, shadow query, shading inputs.

    mesh: run the primary and shadow queries as RING ORBITS over
    geometry sharded on the mesh's "tris" axis (parallel/shard.trace_
    ring) — the debug hook for scenes too big to replicate (the
    reference's debug thread, Parallel/raytracer.cu:367, now works on
    the memory-bound path too).  The ring reports no per-ray step
    count ("steps" = -1); every other field matches the single-device
    trace (ids exactly, floats to traversal arithmetic)."""
    cfg = prep.cfg
    rcfg = cfg.render
    # refuse configs whose shading this trace would misreport, instead
    # of silently diverging from the renderer (the bug class the shared
    # policy methods exist to prevent)
    if rcfg.normal_mode != "face":
        raise NotImplementedError(
            "trace_pixel reports the face-normal pipeline only"
        )
    if rcfg.shadow_samples > 1 and rcfg.light_radius > 0:
        raise NotImplementedError(
            "trace_pixel reports a single point-light shadow ray only"
        )
    all_rays = camera_rays(cfg.camera)
    idx = y * cfg.camera.width + x
    ray = jax.tree.map(lambda a: a[idx:idx + 1], all_rays)

    packed = rcfg.traversal == "packed"
    garr = prep.packed.arrays if packed else prep.grid.arrays
    box = AABB(garr.lower, garr.upper)
    slab_hit, t0, t1 = slab_intersect(box, ray)

    serial = rcfg.serial_shading
    # gates/mints come from the SAME RenderConfig policy methods the
    # renderer consumes — they cannot diverge (the class of bug fixed in
    # commits 6ec7515 and efb71f5)
    primary_gate = rcfg.primary_gate()
    if mesh is not None:
        from ray_tracer_tpu.parallel.shard import trace_ring

        if packed and ring_grids is None:
            from ray_tracer_tpu.parallel.shard import build_ring_grids

            ring_grids = build_ring_grids(prep, mesh.shape["tris"])
        b = trace_ring(
            prep, ray, mesh,
            t_gate=0.0 if primary_gate is None else primary_gate,
            ring_grids=ring_grids,
        )

        class res:  # quacks like the traversal result below
            pass

        res.hit, res.t, res.tri_id = b["hit"], b["t"], b["tri_id"]
        res.steps = jnp.full((1,), -1, jnp.int32)  # ring: not recorded
    elif packed:
        res = traverse_packed(
            ray, prep.packed.arrays, prep.packed.meta,
            t_gate=0.0 if primary_gate is None else primary_gate,
        )
    else:
        v0, v1, v2 = prep.scene.triangle_soa()
        res = traverse_grid(
            ray, prep.grid.arrays, prep.grid.meta, v0, v1, v2,
            t_gate=primary_gate,
            early_exit=not rcfg.faithful,
            det_dtype=rcfg.det_dtype,
        )

    out: Dict[str, Any] = {
        "pixel": (x, y),
        "ray_origin": np.asarray(ray.orig)[0].tolist(),
        "ray_dir": np.asarray(ray.dirn)[0].tolist(),
        "grid_bounds": (np.asarray(garr.lower).tolist(), np.asarray(garr.upper).tolist()),
        "slab_hit": bool(np.asarray(slab_hit)[0]),
        "slab_t0": float(np.asarray(t0)[0]),
        "slab_t1": float(np.asarray(t1)[0]),
        "hit": bool(np.asarray(res.hit)[0]),
        "t": float(np.asarray(res.t)[0]),
        "tri_id": int(np.asarray(res.tri_id)[0]),
        "steps": int(np.asarray(res.steps)[0]),
    }
    if not out["hit"]:
        return out

    tri = int(out["tri_id"])
    verts = np.asarray(prep.scene.verts)
    faces = np.asarray(prep.scene.faces)
    tv = verts[faces[tri]]
    poi = np.asarray(ray.orig)[0] + np.asarray(ray.dirn)[0] * out["t"]
    light = np.asarray(prep.scene.light_pos)
    if serial:
        normal = np.cross(tv[0] - tv[1], tv[2] - tv[0])
    else:
        normal = np.cross(tv[2] - tv[1], tv[0] - tv[1])
    sdir = -(light - poi) if rcfg.shadow_dir_away_from_light() else (light - poi)
    sdir = sdir / np.linalg.norm(sdir)
    smint = rcfg.shadow_mint()
    srays = RayBatch.make(jnp.asarray(poi[None]), jnp.asarray(sdir[None]),
                          mint=smint)
    if mesh is not None:
        from ray_tracer_tpu.parallel.shard import trace_ring

        sb = trace_ring(prep, srays, mesh, t_gate=rcfg.shadow_eps,
                        stop_first=True, ring_grids=ring_grids)
        in_shadow = bool(np.asarray(sb["hit"])[0])
    elif packed:
        sres = traverse_packed(
            srays, prep.packed.arrays, prep.packed.meta,
            t_gate=rcfg.shadow_eps, stop_on_first_hit=True,
        )
        in_shadow = bool(np.asarray(sres.hit)[0])
    else:
        v0, v1, v2 = prep.scene.triangle_soa()
        sres = traverse_grid(
            srays, prep.grid.arrays, prep.grid.meta, v0, v1, v2,
            t_gate=rcfg.shadow_eps, det_dtype=rcfg.det_dtype,
        )
        in_shadow = bool(np.asarray(rcfg.accepted_hit(sres))[0])

    mat_idx = int(np.asarray(prep.scene.face_material)[tri])
    out.update({
        "poi": poi.tolist(),
        "normal": normal.tolist(),
        "material_index": mat_idx,
        # shadow_dir/in_shadow describe the PRIMARY light's shadow ray;
        # extra_lights counts additional lights the render also shades
        "shadow_dir": sdir.tolist(),
        "in_shadow": in_shadow,
        "extra_lights": (0 if prep.scene.extra_light_pos is None
                         else int(prep.scene.extra_light_pos.shape[0])),
        "triangle": tv.tolist(),
    })
    return out
