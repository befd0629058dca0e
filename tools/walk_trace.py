"""Host-side replay of the packed march's probe/leap schedule for a
SAMPLE of rays, recording what each probe saw (occupied? dist? leap
length in cells) — pins down where a walk's steps actually go.
Usage: python tools/walk_trace.py [nefertiti] [size] [n_samples]
"""
import os, sys
from ray_tracer_tpu.utils.cache import use_compile_cache  # noqa: E402
use_compile_cache()
import jax

jax.config.update("jax_platforms", "cpu")
import numpy as np, jax.numpy as jnp

from ray_tracer_tpu.config import apply_turbo
from ray_tracer_tpu.models.scenes import nefertiti_scene, serial_scene_config
from ray_tracer_tpu.render.renderer import prepare
from ray_tracer_tpu.ops.camera import camera_rays
from ray_tracer_tpu.accel.packed import decode_cell_info

scene_name = sys.argv[1] if len(sys.argv) > 1 else "nefertiti"
size = int(sys.argv[2]) if len(sys.argv) > 2 else 256
nsamp = int(sys.argv[3]) if len(sys.argv) > 3 else 400

if scene_name == "nefertiti":
    scene, cfg = nefertiti_scene(size, size)
    fam = "nefertiti"
else:
    scene, cfg = None, serial_scene_config(size, size)
    fam = "serial"
cfg = apply_turbo(cfg, fam)
prep = prepare(cfg, scene=scene)
meta = prep.packed.meta
g = prep.packed.arrays
lower = np.asarray(g.lower); width = np.asarray(g.width)
inv_w = np.asarray(g.inv_width)
info = np.asarray(g.cell_info)
first_a, nblk_a, lo_a, hi_a = (
    np.asarray(x) for x in decode_cell_info(jnp.asarray(info)))
nx, ny, nz = meta.n_voxels
nvox = np.asarray([nx, ny, nz])
delta = meta.probe_delta

# primary trace on CPU to get hit points (small size keeps this fast)
from ray_tracer_tpu.ops.traverse_packed import traverse_packed
rays = camera_rays(cfg.camera, dtype=jnp.float32)
res = traverse_packed(rays, g, meta, t_gate=0.0)
hit = np.asarray(res.hit); t = np.asarray(res.t)
o = np.asarray(rays.orig); d = np.asarray(rays.dirn)
light = np.asarray(prep.scene.light_pos)
idx = np.flatnonzero(hit)[:: max(1, hit.sum() // nsamp)][:nsamp]

def walk(o1, d1, mint):
    """Replay probe/leap; returns list of (kind, dist, nblk, leap_cells)."""
    events = []
    invd = np.where(d1 != 0, 1.0 / d1, np.inf)
    # slab entry
    t_near = (lower - o1) * invd; t_far = (upper_ - o1) * invd
    lo = np.minimum(t_near, t_far); hi = np.maximum(t_near, t_far)
    t0 = max(np.nanmax(lo), mint); t1 = np.nanmin(hi)
    if not (t0 <= t1 and np.isfinite(t0)):
        return events
    t_cur = t0
    for _ in range(2000):
        probe = t_cur + max(delta, t_cur * 4e-6)
        p = o1 + d1 * probe
        cell = np.floor((p - lower) * inv_w).astype(np.int64)
        if (cell < 0).any() or (cell >= nvox).any():
            break
        lin = cell[2] * nx * ny + cell[1] * nx + cell[0]
        occ = nblk_a[lin] > 0
        lo_e = np.zeros(3, np.int64) if occ else lo_a[lin]
        hi_e = np.zeros(3, np.int64) if occ else hi_a[lin]
        blo = lower + (cell - lo_e) * width
        bhi = lower + (cell + hi_e + 1) * width
        tf = np.where(np.isnan(np.maximum((blo - o1) * invd, (bhi - o1) * invd)),
                      np.inf, np.maximum((blo - o1) * invd, (bhi - o1) * invd))
        t_exit = max(tf.min(), probe)
        leap_cells = (t_exit - t_cur) / width.min()
        events.append(("occ" if occ else "empty",
                       0 if occ else int(max(lo_e.max(), hi_e.max())),
                       int(nblk_a[lin]), leap_cells))
        t_cur = t_exit
        if occ and len(events) > 500:
            break
    return events

upper_ = np.asarray(g.upper)
sg = 1e-4 + 0.02
from collections import Counter
kinds = Counter(); dists = Counter(); leaps = []
nsteps = []
occ_rows = 0; total_ev = 0
for i in idx:
    poi = o[i] + d[i] * t[i]
    to_l = light - poi
    dist_l = np.linalg.norm(to_l)
    sdir = to_l / dist_l
    ev = walk(poi.astype(np.float64), sdir.astype(np.float64), sg)
    nsteps.append(len(ev) + sum(max(e[2] - 1, 0) for e in ev if e[0] == "occ"))
    for k, dv, nb, lc in ev:
        kinds[k] += 1; total_ev += 1
        if k == "empty":
            dists[dv] += 1; leaps.append(lc)
        else:
            occ_rows += nb

print(f"scene={scene_name} grid={meta.n_voxels} bt={meta.block_tris} "
      f"probe_delta={delta:.2e} cellw={width.min():.4f}")
print(f"samples={len(idx)} mean shadow steps (probes+extra rows): "
      f"{np.mean(nsteps):.2f}")
print(f"probe kinds: {dict(kinds)}  occ rows total={occ_rows} "
      f"(mean rows/occ visit {occ_rows/max(kinds['occ'],1):.2f})")
print(f"empty-probe max-extent histogram: "
      f"{dict(sorted(dists.items())[:12])}")
print(f"empty leap lengths (cells): mean={np.mean(leaps):.2f} "
      f"p50={np.percentile(leaps,50):.2f} p90={np.percentile(leaps,90):.2f}")
