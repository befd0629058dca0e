"""Does queue compaction pay on CAMERA batches under the round-3 code?

The round-2 measurement (compact costs ~4% on full primaries) predates
the inline layout and pump 3.  step_stats now shows spot's wave at
~65% occupancy — idle slots come from never-entering sky rays parked
until the next refill and from pump-latch latency — so re-measure
compact x pump at the production call shape (fused shadow, camera
refill, need_t=False).
"""
import os, sys, time
from ray_tracer_tpu.utils.cache import use_compile_cache  # noqa: E402
use_compile_cache()
import jax, jax.numpy as jnp

from ray_tracer_tpu.config import apply_turbo
from ray_tracer_tpu.models.scenes import serial_scene_config
from ray_tracer_tpu.render.renderer import prepare
from ray_tracer_tpu.ops.camera import camera_rays
from ray_tracer_tpu.ops.persistent import persistent_trace

size = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
cfg = apply_turbo(serial_scene_config(size, size), "serial")
prep = prepare(cfg)
rays = camera_rays(cfg.camera, dtype=jnp.float32)
light = prep.scene.light_pos
rc = cfg.render


def run(compact, pump, wave):
    kw = dict(
        wave=wave, pump=pump, fuse_shadow=True, need_t=False,
        t_gate=0.0, shadow_gate=0.1, shadow_mint=0.1, serial_quirk=True,
        camera=cfg.camera, spp=1, compact=compact,
    )
    t0 = time.perf_counter()
    res = persistent_trace(rays, prep.packed.arrays, prep.packed.meta,
                           light, **kw)
    _ = int(jax.device_get(res.tri_id[0]))
    print(f"compact={compact} pump={pump} wave={wave}: compile+first "
          f"{time.perf_counter()-t0:.0f}s", flush=True)
    n = 8
    best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            res = persistent_trace(rays, prep.packed.arrays,
                                   prep.packed.meta, light, **kw)
        _ = int(jax.device_get(res.tri_id[0]))
        best = min(best, (time.perf_counter() - t0) / n)
    print(f"  -> {best*1e3:.1f} ms/frame, "
          f"{2*size*size/best/1e6:.2f} Mrays/s", flush=True)


for compact, pump, wave in [
    (False, 3, 12288),   # current production baseline
    (True, 3, 12288),
    (True, 2, 12288),
    (True, 4, 12288),
    (True, 3, 16384),
]:
    run(compact, pump, wave)
