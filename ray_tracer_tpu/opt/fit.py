"""Inverse rendering: optimize scene parameters against a target image.

This is the capability layer the reference (forward-only, SURVEY.md §2
'Gradient/backward pass: absent') motivates for this rebuild:
pixel-loss gradients w.r.t. vertices, materials and the light flow
through the differentiable render (hit topology is a stop-gradient
island; t/normals/shading are recomputed analytically from gathered
vertices — render/renderer.py).

`make_train_step` builds one jitted step = forward render + L2 pixel
loss + backward + optax update.  With a mesh, rays are sharded via
shard_map and scene-parameter gradients all-reduce (psum) over the mesh
axis as the transpose of replication — overlapped with backward by
XLA's scheduler.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from ray_tracer_tpu.accel.grid import GridArrays, GridMeta
from ray_tracer_tpu.config import SceneConfig
from ray_tracer_tpu.core.rays import RayBatch
from ray_tracer_tpu.models.materials import MaterialTable
from ray_tracer_tpu.models.scenes import Scene
from ray_tracer_tpu.ops.camera import camera_rays
from ray_tracer_tpu.render.renderer import pad_rays, render_rays, render_rays_tiled


class SceneParams(NamedTuple):
    """The differentiable leaves of a Scene."""

    verts: jnp.ndarray
    base_color: jnp.ndarray
    kd: jnp.ndarray
    ks: jnp.ndarray
    spec_alpha: jnp.ndarray
    ka: jnp.ndarray
    km: jnp.ndarray
    light_pos: jnp.ndarray
    light_intensity: jnp.ndarray
    # None when the scene has no image texture (None is an empty pytree
    # node, so checkpoints and optimizer states are unaffected).
    texture_image: Optional[jnp.ndarray] = None
    # None when the scene has no extra lights (same empty-pytree rule).
    extra_light_pos: Optional[jnp.ndarray] = None
    extra_light_intensity: Optional[jnp.ndarray] = None
    # None when the scene has no environment map.
    env_image: Optional[jnp.ndarray] = None


def _grow_packed(m):
    """~30% packed-layout headroom so rebuilds over moved vertices pad
    back to one static meta instead of re-jitting (the ONE growth rule,
    used by the initial reserve and the in-loop regrow)."""
    return m._replace(n_blocks=int(m.n_blocks * 1.3) + 8,
                      max_blocks=m.max_blocks + 2)


def _grow_csr(m):
    return m._replace(nnz=int(m.nnz * 1.3) + 8,
                      max_per_voxel=m.max_per_voxel + 2)


def split_scene(scene: Scene) -> SceneParams:
    m = scene.materials
    return SceneParams(
        verts=scene.verts,
        base_color=m.base_color, kd=m.kd, ks=m.ks,
        spec_alpha=m.spec_alpha, ka=m.ka, km=m.km,
        light_pos=scene.light_pos, light_intensity=scene.light_intensity,
        texture_image=scene.texture_image,
        extra_light_pos=scene.extra_light_pos,
        extra_light_intensity=scene.extra_light_intensity,
        env_image=scene.env_image,
    )


def merge_scene(params: SceneParams, scene: Scene) -> Scene:
    return Scene(
        verts=params.verts,
        faces=scene.faces,
        face_material=scene.face_material,
        materials=MaterialTable(
            base_color=params.base_color, kd=params.kd, ks=params.ks,
            spec_alpha=params.spec_alpha, ka=params.ka, km=params.km,
            reflective=scene.materials.reflective,
        ),
        light_pos=params.light_pos,
        light_intensity=params.light_intensity,
        uvs=scene.uvs,
        uv_faces=scene.uv_faces,
        texture_image=params.texture_image,
        extra_light_pos=params.extra_light_pos,
        extra_light_intensity=params.extra_light_intensity,
        env_image=params.env_image,
        # dielectric tables pass through untrained (like faces/flags;
        # ior optimization would ride SceneParams if ever needed)
        transmissive=scene.transmissive,
        ior=scene.ior,
    )


def pixel_major_rays(rays: RayBatch, r: int, spp: int, padded: int) -> RayBatch:
    """Regroup a subsample-major camera batch (camera_rays layout:
    index = s*r + pixel) PIXEL-major (index = pixel*spp^2 + s) and pad
    by WHOLE pixels, so a contiguous shard split hands each device every
    subsample of its pixels (cross-shard subsample averaging would
    otherwise need a collective mid-loss).  Padding pixels get inf
    origins — the loss masks them explicitly."""
    fills = dict(orig=jnp.inf, dirn=1.0, mint=0.0, maxt=0.0)

    def one(x, fill):
        x2 = jnp.swapaxes(x.reshape((spp * spp, r) + x.shape[1:]), 0, 1)
        if padded != r:
            pad_block = jnp.full((padded - r,) + x2.shape[1:], fill, x.dtype)
            x2 = jnp.concatenate([x2, pad_block])
        return x2.reshape((padded * spp * spp,) + x2.shape[2:])

    return RayBatch(**{f: one(getattr(rays, f), fills[f])
                       for f in ("orig", "dirn", "mint", "maxt")})


def _render_flat(params: SceneParams, scene: Scene, grid: GridArrays,
                 meta: GridMeta, cfg: SceneConfig, rays: RayBatch,
                 camera_ok: bool = False) -> jnp.ndarray:
    """camera_ok: the caller guarantees `rays` IS the full camera batch in
    natural pixel order — lets the persistent wave use its zero-gather
    camera refill (regenerate rays from the pixel index) instead of
    gathering each popped ray from the (R,8) device table."""
    rcfg = cfg.render
    sc = merge_scene(params, scene)
    if (camera_ok and rcfg.traversal == "packed"
            and rcfg.scheduler == "persistent" and rcfg.spp == 1):
        return render_rays(rays, sc, grid, meta, rcfg, camera_cfg=cfg.camera)
    return render_rays_tiled(rays, sc, grid, meta, rcfg)


def image_loss(params: SceneParams, scene: Scene, grid: GridArrays,
               meta: GridMeta, cfg: SceneConfig, target: jnp.ndarray) -> jnp.ndarray:
    """Mean squared pixel error in linear color, normalized by 255.

    Honors cfg.render.spp so the model matches an spp-averaged target
    (e.g. cmd_fit's self-demo target = render(prep))."""
    spp = cfg.render.spp
    rays = camera_rays(cfg.camera, dtype=jnp.dtype(cfg.render.dtype), spp=spp)
    colors = _render_flat(params, scene, grid, meta, cfg, rays,
                          camera_ok=spp == 1)
    if spp > 1:
        colors = colors.reshape(spp * spp, -1, 3).mean(axis=0)
    tgt = target.reshape(-1, 3).astype(colors.dtype)
    return jnp.mean(((colors - tgt) / 255.0) ** 2)


@lru_cache(maxsize=16)
def _train_step_fn(meta: GridMeta, cfg: SceneConfig, optimizer_name: str,
                   lr: float, mesh: Optional[Mesh], axis: str,
                   trainable: Optional[Tuple[str, ...]] = None):
    optimizer = _make_optimizer(optimizer_name, lr)
    n_shards = mesh.shape[axis] if mesh is not None else 1
    r = cfg.camera.height * cfg.camera.width
    padded = ((r + n_shards - 1) // n_shards) * n_shards
    spp = cfg.render.spp

    def local_loss(params, scene, grid, rays, target_flat):
        if trainable is not None:
            # Detach frozen fields BEFORE the render so their whole
            # backward graph is dead code XLA deletes — e.g. freezing
            # `verts` removes the Cramer-t/normal VJPs and the (V,3)
            # scatter-add), instead of computing those grads and zeroing
            # after.
            params = params._replace(**{
                f: jax.lax.stop_gradient(getattr(params, f))
                for f in SceneParams._fields if f not in trainable
            })
        colors = _render_flat(params, scene, grid, meta, cfg, rays,
                              camera_ok=mesh is None and spp == 1
                              and padded == r)
        if spp > 1:
            # average the spp^2 subsamples per pixel, matching render().
            # Layouts differ by path: single-device rays are subsample-
            # major (camera_rays); sharded rays are regrouped PIXEL-
            # major in step() so each shard owns whole pixels — the
            # per-pixel summation order over subsamples is the same
            # either way (sequential s = 0..spp^2-1).
            if mesh is None:
                colors = colors.reshape(spp * spp, -1, 3).mean(axis=0)
            else:
                colors = colors.reshape(-1, spp * spp, 3).mean(axis=1)
        d = (colors - target_flat.astype(colors.dtype)) / 255.0
        if padded != r:
            # Padding lanes are masked out EXPLICITLY (identifiable by
            # their inf origins, shard-locally): with an env map a
            # padding miss lane renders an environment lookup, not the
            # background the target was padded with, so relying on the
            # residual cancelling would leak spurious env gradients.
            po = rays.orig
            if spp > 1 and mesh is not None:
                po = po.reshape(-1, spp * spp, 3)[:, 0, :]
            d = jnp.where(jnp.isfinite(po[:, :1]), d, 0.0)
        return jnp.sum(d * d)

    if mesh is None:
        def loss_fn(params, scene, grid, rays, target_flat):
            return local_loss(params, scene, grid, rays, target_flat) / (3 * r)
    else:
        def sharded_loss(params, scene, grid, rays, target_flat):
            s = local_loss(params, scene, grid, rays, target_flat)
            return jax.lax.psum(s, axis)

        shl = jax.shard_map(
            sharded_loss, mesh=mesh,
            in_specs=(P(), P(), P(), P(axis), P(axis)),
            out_specs=P(),
        )

        def loss_fn(params, scene, grid, rays, target_flat):
            return shl(params, scene, grid, rays, target_flat) / (3 * r)

    @jax.jit
    def step(params: SceneParams, opt_state, scene: Scene, grid: GridArrays,
             target: jnp.ndarray):
        rays = camera_rays(cfg.camera, dtype=jnp.dtype(cfg.render.dtype), spp=spp)
        if spp == 1:
            rays = pad_rays(rays, padded)
        elif mesh is not None:
            # Regroup the subsample-major batch PIXEL-major and pad by
            # WHOLE pixels (pixel_major_rays), so the shard split hands
            # each device every subsample of its pixels (cross-shard
            # subsample averaging would otherwise need a collective
            # mid-loss).
            rays = pixel_major_rays(rays, r, spp, padded)
        tgt = target.reshape(-1, 3)
        if padded != r:
            # padding rays render as the BACKGROUND color; pad the target
            # with the same so padding lanes contribute zero residual
            # regardless of cfg.render.background.
            bg = jnp.broadcast_to(
                jnp.asarray(cfg.render.background, tgt.dtype), (padded - r, 3)
            )
            tgt = jnp.concatenate([tgt, bg])
        # frozen fields were stop_gradient'ed inside local_loss, so
        # their grads are already exact zeros — no post-zeroing needed
        loss, grads = jax.value_and_grad(loss_fn)(params, scene, grid, rays, tgt)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step, optimizer


def _make_optimizer(name: str, lr: float) -> optax.GradientTransformation:
    if name == "adam":
        return optax.adam(lr)
    if name == "sgd":
        return optax.sgd(lr)
    raise ValueError(f"unknown optimizer {name!r}")


def make_train_step(
    meta: GridMeta,
    cfg: SceneConfig,
    optimizer: str = "adam",
    lr: float = 1e-2,
    mesh: Optional[Mesh] = None,
    axis: str = "rays",
    trainable: Optional[Tuple[str, ...]] = None,
):
    """-> (step_fn, init_fn).  step_fn(params, opt_state, scene, grid,
    target) -> (params, opt_state, loss); init_fn(params) -> opt_state.

    `trainable` restricts updates to the named SceneParams fields.  NOTE:
    optimizing `verts` moves geometry OUT of the prebuilt grid; callers
    doing vertex optimization must rebuild the grid between steps (see
    opt/fit.fit with rebuild_grid_every) or keep displacements below a
    voxel width.
    """
    if trainable is not None:
        unknown = set(trainable) - set(SceneParams._fields)
        if unknown:
            raise ValueError(f"unknown trainable fields {sorted(unknown)}")
        trainable = tuple(sorted(trainable))
    step, opt = _train_step_fn(meta, cfg, optimizer, lr, mesh, axis, trainable)
    return step, opt.init


class RingSceneArrays(NamedTuple):
    """Per-step device inputs of the tris-sharded train step: the
    non-differentiable scene topology (padded faces + material ids,
    reflective flags) and each shard's packed grid (None for all-pairs
    hops).  Kept OUT of the jit closure so a grid rebuild over moved
    vertices swaps arrays without re-jitting."""

    faces: jnp.ndarray  # (fp, 3) i32, padded to the shard multiple
    fmat: jnp.ndarray  # (fp,) i32
    reflective: jnp.ndarray  # (M,) bool
    garr: Optional[tuple] = None  # stacked PackedGridArrays or None


def make_ring_train_step(
    prep,
    mesh: Mesh,
    rays_axis: Optional[str] = "rays",
    tris_axis: str = "tris",
    optimizer: str = "adam",
    lr: float = 1e-2,
    trainable: Optional[Tuple[str, ...]] = None,
    ring_grids=None,
):
    """Train step with the GEOMETRY sharded over `tris_axis` — backward
    through the ring orbit (parallel/shard.ring_loss_fn), closing the
    memory-scaling loop: a scene too big to replicate can now be
    OPTIMIZED, not just rendered (SURVEY §2 parallelism table, psum
    gradient row; the replicated make_train_step shards rays only).

    -> (step_fn, init_fn, ring_scene) with
    step_fn(params, opt_state, ring_scene, target) -> (params,
    opt_state, loss).  Vertex gradients accumulate per-shard
    (scatter-add over the shard's faces) and psum over BOTH mesh axes;
    the loss matches the replicated step's loss up to FMA-contraction
    noise (pinned by tests/test_sharding.py).

    When optimizing verts, rebuild ring_scene.garr with
    parallel.shard.build_ring_grids between steps (same rule as the
    replicated fit's rebuild_grid_every)."""
    from ray_tracer_tpu.parallel.shard import build_ring_grids, ring_loss_fn
    from ray_tracer_tpu.render.renderer import _pad_to

    cfg = prep.cfg
    scene = prep.scene
    rcfg = cfg.render
    spp = rcfg.spp
    n_tri_shards = mesh.shape[tris_axis]
    f = scene.faces.shape[0]
    fp = _pad_to(f, n_tri_shards)
    faces_p = scene.faces
    fmat_p = scene.face_material
    if fp != f:
        # padding faces are degenerate point-triangles at vertex 0 —
        # they can never pass the strict barycentric test, and their
        # (masked) gradients are exact zeros
        faces_p = jnp.concatenate(
            [faces_p, jnp.zeros((fp - f, 3), faces_p.dtype)]
        )
        fmat_p = jnp.concatenate([fmat_p, jnp.zeros((fp - f,), fmat_p.dtype)])

    gmeta = None
    garr = None
    if rcfg.traversal == "packed":
        if ring_grids is None:
            ring_grids = build_ring_grids(prep, n_tri_shards)
        garr, gmeta, gfp = ring_grids
        assert gfp == fp, "ring_grids built for a different shard count"

    loss_sharded = ring_loss_fn(
        cfg, mesh, rays_axis, tris_axis, gmeta, fp,
        tuple(sorted(trainable)) if trainable is not None else None,
    )
    opt = _make_optimizer(optimizer, lr)
    r = cfg.camera.height * cfg.camera.width
    shards = n_tri_shards * (mesh.shape[rays_axis] if rays_axis else 1)
    rp = _pad_to(r, shards)
    ring_scene = RingSceneArrays(
        faces=faces_p, fmat=fmat_p,
        reflective=scene.materials.reflective, garr=garr,
    )

    @jax.jit
    def step(params: SceneParams, opt_state, ring_scene: RingSceneArrays,
             target: jnp.ndarray):
        rays = camera_rays(cfg.camera, dtype=jnp.dtype(rcfg.dtype), spp=spp)
        # spp > 1 regroups PIXEL-major and pads whole pixels — each ray
        # shard then owns every subsample of its pixels, the same rule
        # as the replicated sharded step (pixel_major_rays)
        rays_p = (pad_rays(rays, rp) if spp == 1
                  else pixel_major_rays(rays, r, spp, rp))
        tgt = target.reshape(-1, 3)
        if rp != r:
            bg = jnp.broadcast_to(
                jnp.asarray(rcfg.background, tgt.dtype), (rp - r, 3)
            )
            tgt = jnp.concatenate([tgt, bg])

        def loss_fn(p):
            return loss_sharded(
                p, ring_scene.reflective, ring_scene.faces, ring_scene.fmat,
                ring_scene.garr, rays_p, tgt,
            ) / (3 * r)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step, opt.init, ring_scene


def fit(
    prep,
    target: jnp.ndarray,
    steps: int = 100,
    lr: float = 1e-2,
    optimizer: str = "adam",
    mesh: Optional[Mesh] = None,
    axis: str = "rays",
    trainable: Optional[Tuple[str, ...]] = None,
    rebuild_grid_every: int = 0,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 50,
    resume: bool = False,
    log_every: int = 10,
) -> Tuple[SceneParams, list]:
    """Run the optimization loop; returns (final params, loss history).

    `steps` is the TOTAL step budget: resuming a run checkpointed at
    step k executes steps k..steps-1 (a preempted job relaunched with
    identical arguments terminates at the planned total instead of
    overrunning by another `steps`).

    When optimizing `verts`, pass rebuild_grid_every=k (k>0) to re-run the
    host-side grid build every k steps so moved geometry stays indexed.
    Rebuilt grids are padded to the compiled step's static meta
    (accel.packed.pack_grid pad_meta / accel.grid.pad_grid_like), so a
    rebuild normally does NOT re-jit; only a build that outgrows the
    padding recompiles, once, with ~30% headroom reserved for the rest
    of the run.

    resume=True restores the newest checkpoint in checkpoint_dir (if any)
    before stepping — crash/preemption recovery for long fits.
    """
    from ray_tracer_tpu.accel.grid import build_grid
    from ray_tracer_tpu.opt.checkpoint import restore_checkpoint, save_checkpoint
    from ray_tracer_tpu.utils.log import get_logger
    import numpy as np

    log = get_logger("ray_tracer_tpu.fit")
    scene, cfg = prep.scene, prep.cfg
    if scene.transmissive is not None:
        raise NotImplementedError(
            "fit() optimizes through the Whitted renderer, which has no "
            "refraction branch — transmissive (dielectric) materials "
            "are served by the path-traced integrator only "
            "(render/pathtrace.py)"
        )
    packed_mode = cfg.render.traversal == "packed"
    if packed_mode:
        grid, meta = prep.packed.arrays, prep.packed.meta
    else:
        grid, meta = prep.grid.arrays, prep.grid.meta
    if rebuild_grid_every:
        # Reserve rebuild headroom in the FIRST compile: pad the initial
        # grid ~30% so rebuilt grids (whose entry counts jitter as
        # vertices move) pad back to this meta instead of re-jitting.
        if packed_mode:
            head = _grow_packed(meta)
            extra = head.n_blocks - meta.n_blocks
            grid = grid._replace(
                blocks=jnp.concatenate([
                    grid.blocks,
                    jnp.zeros((extra,) + grid.blocks.shape[1:], grid.blocks.dtype),
                ]),
                slot_tri=jnp.concatenate([
                    grid.slot_tri,
                    jnp.full((extra * meta.block_tris,), -1, jnp.int32),
                ]),
            )
        else:
            head = _grow_csr(meta)
            grid = grid._replace(
                tri_ids=jnp.concatenate([
                    grid.tri_ids,
                    jnp.zeros((head.nnz - meta.nnz,), jnp.int32),
                ])
            )
        meta = head
    params = split_scene(scene)
    step, init = make_train_step(
        meta, cfg, optimizer=optimizer, lr=lr, mesh=mesh, axis=axis,
        trainable=trainable,
    )
    opt_state = init(params)
    start_step = 0
    if resume and checkpoint_dir:
        from ray_tracer_tpu.opt.checkpoint import latest_step

        last = latest_step(checkpoint_dir)
        if last is not None:
            # step_num=last pins the restore to the same checkpoint the
            # step numbering resumes from — a directory holding both a
            # 'latest' tag and step_N saves must not mix the two.
            params, restored_opt = restore_checkpoint(
                checkpoint_dir, {"params": params, "opt_state": opt_state},
                step_num=last,
            )
            if restored_opt is not None:
                opt_state = restored_opt
            start_step = last  # continue numbering: a later resume must
            # find THIS run's newest checkpoint, not the restored one
            log.info("resumed from step %s", last)

    def rebuild(cur_params):
        nonlocal grid, meta, step
        verts_np = np.asarray(cur_params.verts)
        faces_np = np.asarray(scene.faces)
        built = build_grid(
            verts_np, faces_np,
            resolution_multiplier=cfg.render.grid.resolution_multiplier,
            max_resolution=cfg.render.grid.max_resolution,
            exact_overlap=cfg.render.grid.exact_overlap,
        )
        if packed_mode:
            from ray_tracer_tpu.accel.packed import pack_grid

            # pad up to the compiled step's meta so the rebuild does
            # NOT re-jit; when the moved geometry outgrows it, grow
            # once with ~30% headroom so later rebuilds fit again
            # meta.block_tris is the RESOLVED row width (the config
            # value may be 0 = auto, resolved once by prepare())
            repacked = pack_grid(
                built, verts_np, faces_np,
                block_tris=meta.block_tris, pad_meta=meta,
                inline=meta.inline, leap=cfg.render.grid.leap,
            )
            if repacked.meta != meta:
                head = _grow_packed(repacked.meta)
                repacked = pack_grid(
                    built, verts_np, faces_np,
                    block_tris=meta.block_tris,
                    pad_meta=head,
                    inline=meta.inline, leap=cfg.render.grid.leap,
                )
            grid, new_meta = repacked.arrays, repacked.meta
        else:
            from ray_tracer_tpu.accel.grid import pad_grid_like

            grid_pad = pad_grid_like(built, meta)
            if grid_pad is None:
                head = _grow_csr(built.meta)
                grid_pad = pad_grid_like(built, head) or built
            grid, new_meta = grid_pad.arrays, grid_pad.meta
        if new_meta != meta:
            meta = new_meta
            step, _ = make_train_step(
                meta, cfg, optimizer=optimizer, lr=lr, mesh=mesh, axis=axis,
                trainable=trainable,
            )

    if start_step and rebuild_grid_every:
        # the restored verts may be far from the geometry prepare()
        # indexed; rebuild once so the first resumed steps do not trace
        # a stale acceleration structure
        rebuild(params)

    losses = []
    for step_no in range(start_step, steps):
        params, opt_state, loss = step(params, opt_state, scene, grid, target)
        losses.append(loss)  # device scalar; materialized lazily below
        if log_every and (step_no - start_step) % log_every == 0:
            # step numbering continues across resumes, matching the
            # checkpoint tags
            log.info("step %d loss %.6g", step_no, float(loss))
        if rebuild_grid_every and (step_no + 1) % rebuild_grid_every == 0:
            rebuild(params)
        if (checkpoint_dir and checkpoint_every
                and (step_no + 1) % checkpoint_every == 0):
            save_checkpoint(
                checkpoint_dir, params, opt_state, step_num=step_no + 1
            )
    # one sync at the end instead of one per step (float(loss) would
    # block async dispatch every iteration)
    return params, [float(x) for x in losses]
