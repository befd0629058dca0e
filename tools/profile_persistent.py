import os, time, glob, gzip, json, sys
from ray_tracer_tpu.utils.cache import use_compile_cache  # noqa: E402
use_compile_cache()
import jax, dataclasses, numpy as np, jax.numpy as jnp
from ray_tracer_tpu.config import GridConfig
from ray_tracer_tpu.models.scenes import serial_scene_config
from ray_tracer_tpu.render.renderer import prepare
from ray_tracer_tpu.ops.camera import camera_rays
from ray_tracer_tpu.ops.persistent import persistent_trace
size=1024
cfg = serial_scene_config(size,size)
cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, faithful=False, det_dtype="float32", traversal="packed", packed_block_tris=56, grid=GridConfig(resolution_multiplier=0.75)))
prep = prepare(cfg)
rays = camera_rays(cfg.camera, dtype=jnp.float32)
light = prep.scene.light_pos
def go():
    res, iters = persistent_trace(rays, prep.packed.arrays, prep.packed.meta, light,
        wave=16384, t_gate=0.0, fuse_shadow=True, shadow_gate=0.1, shadow_mint=0.1,
        serial_quirk=True, return_iters=True)
    return int(jax.device_get(iters))
print("warm:", go(), flush=True)
with jax.profiler.trace("/tmp/jaxtrace"):
    go()
print("traced", flush=True)
