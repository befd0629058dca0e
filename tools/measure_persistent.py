import os, time, sys
from ray_tracer_tpu.utils.cache import use_compile_cache  # noqa: E402
use_compile_cache()
import jax, dataclasses, numpy as np, jax.numpy as jnp
from ray_tracer_tpu.config import GridConfig
from ray_tracer_tpu.models.scenes import serial_scene_config
from ray_tracer_tpu.render.renderer import prepare
from ray_tracer_tpu.ops.camera import camera_rays
from ray_tracer_tpu.ops.persistent import persistent_trace
size = 1024
cfg = serial_scene_config(size,size)
cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, faithful=False, det_dtype="float32", traversal="packed", packed_block_tris=56, grid=GridConfig(resolution_multiplier=0.75)))
prep = prepare(cfg)
rays = camera_rays(cfg.camera, dtype=jnp.float32)
light = prep.scene.light_pos
def run(wave):
    t0=time.perf_counter()
    res, iters = persistent_trace(rays, prep.packed.arrays, prep.packed.meta, light,
        wave=wave, t_gate=0.0, fuse_shadow=True, shadow_gate=0.1, shadow_mint=0.1,
        serial_quirk=True, return_iters=True)
    it = int(jax.device_get(iters)); hits=int(np.asarray(res.hit).sum())
    print(f"wave={wave} compile+first {time.perf_counter()-t0:.0f}s iters={it} hits={hits}", flush=True)
    n=3; t0=time.perf_counter()
    for _ in range(n):
        res, iters = persistent_trace(rays, prep.packed.arrays, prep.packed.meta, light,
            wave=wave, t_gate=0.0, fuse_shadow=True, shadow_gate=0.1, shadow_mint=0.1,
            serial_quirk=True, return_iters=True)
    _ = int(jax.device_get(iters))
    sec=(time.perf_counter()-t0)/n
    print(f"wave={wave} {sec*1e3:.1f} ms/frame, {it} iters -> {sec/it*1e6:.1f} us/iter, {size*size*2/sec/1e6:.2f} Mrays/s", flush=True)
for w in (16384, 32768):
    run(w)
