"""Per-ray lane-step statistics for the persistent wave, per scene.

Answers "where do the dense scene's lane-steps go?" — the march cost is
~one gathered row per lane-step, so the frame
time is ~proportional to total lane-steps.  Reports the distribution of
per-ray steps (primary+shadow when fused) and the implied ns/step.
"""
import os, sys, time, dataclasses
from ray_tracer_tpu.utils.cache import use_compile_cache  # noqa: E402
use_compile_cache()
import jax, numpy as np, jax.numpy as jnp

from ray_tracer_tpu.config import apply_turbo
from ray_tracer_tpu.models.scenes import (
    serial_scene_config, nefertiti_scene, parallel_scene_config,
)
from ray_tracer_tpu.render.renderer import prepare
from ray_tracer_tpu.ops.camera import camera_rays
from ray_tracer_tpu.ops.persistent import persistent_trace

scene_name = sys.argv[1] if len(sys.argv) > 1 else "spot"
size = int(sys.argv[2]) if len(sys.argv) > 2 else 1024

scene = None
if scene_name == "nefertiti":
    scene, cfg = nefertiti_scene(size, size)
    fam = "nefertiti"
elif scene_name == "parallel":
    cfg = parallel_scene_config(size, size)
    fam = "parallel"
else:
    cfg = serial_scene_config(size, size)
    fam = "serial"
cfg = apply_turbo(cfg, fam)
prep = prepare(cfg, scene=scene)
rays = camera_rays(cfg.camera, dtype=jnp.float32)
light = prep.scene.light_pos
rc = cfg.render
quirk = fam == "serial"
kw = dict(
    wave=rc.wave, t_gate=0.0, fuse_shadow=True,
    shadow_gate=0.1 if quirk else 1e-4 + 0.02,
    shadow_mint=0.1 if quirk else 1e-4 + 0.02,
    serial_quirk=quirk, pump=rc.pump,
)

res, iters = persistent_trace(
    rays, prep.packed.arrays, prep.packed.meta, light,
    need_steps=True, return_iters=True, **kw)
steps = np.asarray(res.steps)
hit = np.asarray(res.hit)
it = int(jax.device_get(iters))

# warm the timed signature too (it compiles separately)
r2 = persistent_trace(rays, prep.packed.arrays, prep.packed.meta, light,
                      need_steps=False, **kw)
_ = float(jax.device_get(r2.t[0]))
n = 3
t0 = time.perf_counter()
for _ in range(n):
    r2 = persistent_trace(rays, prep.packed.arrays, prep.packed.meta, light,
                          need_steps=False, **kw)
_ = float(jax.device_get(r2.t[0]))
sec = (time.perf_counter() - t0) / n

r = steps.shape[0]
tot = int(steps.sum())
print(f"scene={scene_name} {size}x{size} wave={rc.wave} pump={rc.pump} "
      f"bt={rc.packed_block_tris} layout={prep.packed.meta.inline and 'inline' or 'blocks'}")
print(f"rays={r} hits={int(hit.sum())} ({hit.mean()*100:.1f}%)")
print(f"steps: mean={steps.mean():.2f} p50={np.percentile(steps,50):.0f} "
      f"p90={np.percentile(steps,90):.0f} p99={np.percentile(steps,99):.0f} "
      f"max={steps.max()} total={tot}")
print(f"steps(hit rays): mean={steps[hit].mean():.2f}; "
      f"steps(miss rays): mean={steps[~hit].mean() if (~hit).any() else 0:.2f}")
# `it` from return_iters is rounds*pump already (persistent_trace returns
# out["i"] * pump), so wave*it is the full lane-step slot budget.
print(f"frame {sec*1e3:.1f} ms, lane-steps executed={tot} vs "
      f"slot budget wave*rounds*pump={rc.wave*it}")
print(f"ns per executed lane-step: {sec/tot*1e9:.1f}; "
      f"ns per wave-slot-step: {sec/(rc.wave*it)*1e9:.1f}; "
      f"occupancy={tot/(rc.wave*it)*100:.1f}%")
print(f"Mrays/s (2 rays/px): {2*r/sec/1e6:.2f}")
