"""Dense-scene step diagnostics: primary vs shadow phase decomposition.

Separate jitted calls (one per traversal program — a single fused jit of
three while_loops compiles far more slowly) with on-device reductions;
only scalars are pulled to the host.
Usage: python tools/dense_diag.py [nefertiti|parallel|spot] [size]
"""
import os, sys, time
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
from ray_tracer_tpu.ops.traverse_packed import traverse_packed
from ray_tracer_tpu.core.rays import RayBatch

scene_name = sys.argv[1] if len(sys.argv) > 1 else "nefertiti"
size = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
t0 = time.time()

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
light = jnp.asarray(np.asarray(prep.scene.light_pos), jnp.float32)
rc = cfg.render
quirk = fam == "serial"
sg = 0.1 if quirk else 1e-4 + 0.02
meta = prep.packed.meta
garr = prep.packed.arrays

print(f"scene={scene_name} {size}x{size} layout="
      f"{meta.inline and 'inline' or 'blocks'} bt={meta.block_tris} "
      f"max_blocks={meta.max_blocks} grid={meta.n_voxels} "
      f"[prep {time.time()-t0:.0f}s]", flush=True)

f32 = lambda x: x.astype(jnp.float32)

# --- primary-only persistent march -------------------------------------
res = persistent_trace(
    rays, garr, meta, light,
    wave=rc.wave, t_gate=0.0, fuse_shadow=False, serial_quirk=quirk,
    pump=rc.pump, need_steps=True, need_t=True,
)
stats1 = jax.jit(lambda r: dict(
    p_mean=f32(r.steps).mean(),
    p_hit=f32(r.steps).sum(where=r.hit) / r.hit.sum(),
    p_miss=f32(r.steps).sum(where=~r.hit) / jnp.maximum((~r.hit).sum(), 1),
    p_total=r.steps.sum(), hits=r.hit.sum(),
))(res)
o1 = {k: float(v) for k, v in jax.device_get(stats1).items()}
print(f"PRIMARY: mean={o1['p_mean']:.2f} hit-mean={o1['p_hit']:.2f} "
      f"miss-mean={o1['p_miss']:.2f} total={o1['p_total']:.0f} "
      f"hits={o1['hits']:.0f} [{time.time()-t0:.0f}s]", flush=True)


# --- shadow rays from hit points ---------------------------------------
@jax.jit
def shadow_batch(res, clip):
    poi = rays.orig + rays.dirn * res.t[:, None]
    to_l = light[None, :] - poi
    dist_l = jnp.sqrt((to_l * to_l).sum(-1))
    sdir = to_l / jnp.maximum(dist_l, 1e-9)[:, None]
    if quirk:
        sdir = -sdir
    o = jnp.where(res.hit[:, None], poi, jnp.inf)
    maxt = jnp.where(clip, dist_l, jnp.inf)
    return RayBatch(orig=o, dirn=sdir,
                    mint=jnp.full_like(res.t, sg), maxt=maxt), dist_l


stats2 = jax.jit(lambda s, hit: dict(
    mean=f32(s.steps).sum(where=hit) / hit.sum(),
    blocked_mean=f32(s.steps).sum(where=s.hit) / jnp.maximum(s.hit.sum(), 1),
    lit_mean=(f32(s.steps).sum(where=hit & ~s.hit)
              / jnp.maximum((hit & ~s.hit).sum(), 1)),
    total=s.steps.sum(),
    frac_blocked=f32(s.hit).sum() / hit.sum(),
))

for tag, clip in (("inf", False), ("clip", True)):
    srays, dist_l = shadow_batch(res, clip)
    sres = traverse_packed(srays, garr, meta, t_gate=sg,
                           stop_on_first_hit=True)
    o2 = {k: float(v) for k, v in jax.device_get(stats2(sres, res.hit)).items()}
    print(f"SHADOW[{tag}]: mean(hit lanes)={o2['mean']:.2f} "
          f"blocked-mean={o2['blocked_mean']:.2f} "
          f"lit-mean={o2['lit_mean']:.2f} "
          f"blocked={o2['frac_blocked']*100:.1f}% total={o2['total']:.0f} "
          f"[{time.time()-t0:.0f}s]", flush=True)

dl = float(jax.device_get(jax.jit(
    lambda d, h: d.sum(where=h) / h.sum())(dist_l, res.hit)))
print(f"light={np.asarray(light)} mean dist to light={dl:.2f}")
print(f"grid lower={np.asarray(garr.lower)} upper={np.asarray(garr.upper)} "
      f"width={np.asarray(garr.width)}")
