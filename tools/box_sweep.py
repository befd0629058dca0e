"""Re-knee the dense-scene knobs under the empty-box leap geometry.

The round-2/3 sweeps that froze TUNED_KNOBS were measured under the
Chebyshev cube; the anisotropic boxes change the step profile (-27%
lane-steps on nefertiti), so the grid-resolution / row-width / wave /
pump knees move.  Times the fused persistent march per config on the
live chip.

Usage: python tools/box_sweep.py [scene] [size] [config_idx ...]
"""
import os, sys, time
from ray_tracer_tpu.utils.cache import use_compile_cache  # noqa: E402
use_compile_cache()
import dataclasses

import jax, numpy as np, jax.numpy as jnp

from ray_tracer_tpu.config import apply_turbo
from ray_tracer_tpu.models.scenes import (
    serial_scene_config, nefertiti_scene, parallel_scene_config,
)
from ray_tracer_tpu.render.renderer import prepare
from ray_tracer_tpu.ops.camera import camera_rays
from ray_tracer_tpu.ops.persistent import persistent_trace

scene_name = sys.argv[1] if len(sys.argv) > 1 else "nefertiti"
size = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
only = [int(a) for a in sys.argv[3:]]

SWEEPS = {
    # (label, bt, rm, max_res, wave, pump)
    "nefertiti": [
        # round 4: the w4096 knee (12.50) — final refinement
        ("bt14 rm2.0/128 w4k p4", 14, 2.0, 128, 4096, 4),
        ("bt14 rm2.0/128 w3k p4", 14, 2.0, 128, 3072, 4),
        ("bt14 rm2.0/128 w4k p5", 14, 2.0, 128, 4096, 5),
        ("bt14 rm2.0/128 w4608 p4", 14, 2.0, 128, 4608, 4),
    ],
    # spot/parallel: re-knee the shipped knobs under box leaps
    "serial": [
        ("shipped bt14 rm2.0/128 w12k p4", 14, 2.0, 128, 12288, 4),
        ("w8k", 14, 2.0, 128, 8192, 4),
        ("w6k", 14, 2.0, 128, 6144, 4),
        ("w16k", 14, 2.0, 128, 16384, 4),
        ("p5", 14, 2.0, 128, 12288, 5),
        ("rm2.5/160", 14, 2.5, 160, 12288, 4),
    ],
    "parallel": [
        ("shipped bt14 rm2.0/64 w8k p4", 14, 2.0, 64, 8192, 4),
        ("w6k", 14, 2.0, 64, 6144, 4),
        ("w4k", 14, 2.0, 64, 4096, 4),
        ("rm2.0/128", 14, 2.0, 128, 8192, 4),
        ("p5", 14, 2.0, 64, 8192, 5),
    ],
}
CONFIGS = SWEEPS.get(scene_name, SWEEPS["nefertiti"])

for i, (label, bt, rm, mres, wave, pump) in enumerate(CONFIGS):
    if only and i not in only:
        continue
    t0 = time.time()
    scene = None
    if scene_name == "nefertiti":
        scene, cfg = nefertiti_scene(size, size)
        fam = "nefertiti"
    elif scene_name == "parallel":
        cfg = parallel_scene_config(size, size); fam = "parallel"
    else:
        cfg = serial_scene_config(size, size); fam = "serial"
    cfg = apply_turbo(cfg, fam)
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, packed_block_tris=bt, wave=wave, pump=pump,
        grid=dataclasses.replace(
            cfg.render.grid, resolution_multiplier=rm, max_resolution=mres),
    ))
    try:
        prep = prepare(cfg, scene=scene)
    except Exception as e:
        print(f"[{i}] {label}: BUILD FAIL {e}", flush=True)
        continue
    meta = prep.packed.meta
    rays = camera_rays(cfg.camera, dtype=jnp.float32)
    light = prep.scene.light_pos
    quirk = fam == "serial"
    kw = dict(wave=wave, t_gate=0.0, fuse_shadow=True,
              shadow_gate=0.1 if quirk else 1e-4 + 0.02,
              shadow_mint=0.1 if quirk else 1e-4 + 0.02,
              serial_quirk=quirk, pump=pump,
              shadow_skip_dead=quirk, shade_serial=quirk)
    r = persistent_trace(rays, prep.packed.arrays, meta, light, **kw)
    _ = float(jax.device_get(r.t[0]))
    n = 4
    t1 = time.perf_counter()
    for _ in range(n):
        r = persistent_trace(rays, prep.packed.arrays, meta, light, **kw)
    _ = float(jax.device_get(r.t[0]))
    sec = (time.perf_counter() - t1) / n
    mrays = 2 * size * size / sec / 1e6
    print(f"[{i}] {label}: grid={meta.n_voxels} inline={meta.inline} "
          f"maxblk={meta.max_blocks} {sec*1e3:.1f} ms = {mrays:.2f} Mrays/s "
          f"[total {time.time()-t0:.0f}s]", flush=True)
