"""Split march lane-steps into TEST steps (block-row Cramer on an
occupied cell) vs PROBE/LEAP steps (cell fetch, empty leap) — decides
whether the next structure should target empty-space skipping or the
occupied-cell test floor.  Reimplements the traverse_packed loop with
one extra counter (the production march stays uninstrumented).
Usage: python tools/phase_split.py [nefertiti|parallel|spot] [size]
"""
import os, sys
from ray_tracer_tpu.utils.cache import use_compile_cache  # noqa: E402
use_compile_cache()
import jax, numpy as np, jax.numpy as jnp
from functools import partial

from ray_tracer_tpu.config import apply_turbo
from ray_tracer_tpu.models.scenes import (
    serial_scene_config, nefertiti_scene, parallel_scene_config,
)
from ray_tracer_tpu.render.renderer import prepare
from ray_tracer_tpu.ops.camera import camera_rays
from ray_tracer_tpu.ops.traverse_packed import (
    _default_max_steps, _march_step, _slab_entry,
)
from ray_tracer_tpu.ops.persistent import persistent_trace
from ray_tracer_tpu.core.rays import RayBatch

scene_name = sys.argv[1] if len(sys.argv) > 1 else "nefertiti"
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
light = jnp.asarray(np.asarray(prep.scene.light_pos), jnp.float32)
meta = prep.packed.meta
garr = prep.packed.arrays
quirk = fam == "serial"
sg = 0.1 if quirk else 1e-4 + 0.02


@partial(jax.jit, static_argnames=("stop_first",))
def split_trace(rb, t_gate, stop_first):
    o = rb.orig.astype(jnp.float32)
    d = rb.dirn.astype(jnp.float32)
    t0, entered = _slab_entry(grid=garr, o=o, d=d,
                              mint=rb.mint.astype(jnp.float32),
                              maxt=rb.maxt.astype(jnp.float32))
    zf = jnp.zeros_like(t0)
    zi = zf.astype(jnp.int32)
    zb = zi != 0
    s = dict(alive=entered, testing=zb, t_cur=t0, t_exit_cell=zf,
             first_blk=zi, n_blk=zi, cursor=zi,
             best_t=zf + jnp.inf, best_blk=zi, best_slot=zi,
             steps=zi, tsteps=zi, i=jnp.asarray(0, jnp.int32))
    maxs = _default_max_steps(meta)
    invd = 1.0 / d
    maxt = rb.maxt.astype(jnp.float32)

    def cond(s):
        return (s["i"] < maxs) & jnp.any(s["alive"])

    def body(s):
        pre_alive = s["alive"]
        pre_testing = s["testing"]
        s2 = _march_step(s, o=o, d=d, invd=invd,
                         gate=jnp.full_like(t0, t_gate), maxt=maxt,
                         grid=garr, meta=meta)
        limit = jnp.minimum(maxt, s2["best_t"])
        alive = s2["alive"] & (s2["testing"] | (s2["t_cur"] <= limit))
        if stop_first:
            alive = alive & ~jnp.isfinite(s2["best_t"])
            s2 = dict(s2, testing=s2["testing"] & alive)
        return dict(
            s2, alive=alive,
            steps=s["steps"] + pre_alive.astype(jnp.int32),
            # a TEST step: the lane entered the step mid-cell (or
            # started testing this step via start_test -> it ran a
            # block row either way iff testing was True during the row
            # phase; _march_step sets testing |= start_test BEFORE the
            # row test, so read the post-step cursor advance)
            tsteps=s["tsteps"] + (pre_alive & (pre_testing
                                               | (s2["cursor"] > s["cursor"])
                                               )).astype(jnp.int32),
            i=s["i"] + 1,
        )

    out = jax.lax.while_loop(cond, body, s)
    return out["steps"], out["tsteps"], jnp.isfinite(out["best_t"]), out["best_t"]


f32 = lambda x: x.astype(jnp.float32)

# primary
ps, pt, phit, pbt = split_trace(rays, 0.0, False)
stats = jax.jit(lambda s, t, h: (s.sum(), t.sum(), h.sum(),
                                 f32(s).sum(where=h) / h.sum(),
                                 f32(t).sum(where=h) / h.sum()))
o = [float(v) for v in jax.device_get(stats(ps, pt, phit))]
print(f"{scene_name} PRIMARY: steps={o[0]:.0f} test-steps={o[1]:.0f} "
      f"({o[1]/o[0]*100:.0f}%) hit-mean {o[3]:.1f}/{o[4]:.1f}", flush=True)

# shadow from hits (fused equivalent)
@jax.jit
def mk_shadow():
    poi = rays.orig + rays.dirn * pbt[:, None]
    to_l = light[None] - poi
    dist = jnp.sqrt((to_l * to_l).sum(-1))
    sdir = to_l / jnp.maximum(dist, 1e-9)[:, None]
    if quirk:
        sdir = -sdir
    oo = jnp.where(phit[:, None], poi, jnp.inf)
    return RayBatch(orig=oo, dirn=sdir, mint=jnp.full_like(dist, sg),
                    maxt=jnp.full_like(dist, jnp.inf))

srb = mk_shadow()
ss, st, shit, _ = split_trace(srb, sg, True)
o = [float(v) for v in jax.device_get(stats(ss, st, phit))]
print(f"{scene_name} SHADOW: steps={o[0]:.0f} test-steps={o[1]:.0f} "
      f"({o[1]/o[0]*100:.0f}%) per-hit-lane {o[3]:.1f}/{o[4]:.1f}", flush=True)
