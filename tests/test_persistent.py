"""The persistent wave march must agree exactly with the tiled packed
traversal: both drive the SAME `_march_step` core per ray, and a lane's
march is independent of its neighbors, so every per-ray result
(hit/t/tri/shadow) is bitwise reproducible across schedulers and wave
widths."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from ray_tracer_tpu.ops.camera import camera_rays
from ray_tracer_tpu.ops.persistent import persistent_trace
from ray_tracer_tpu.ops.traverse_packed import (
    traverse_packed,
    traverse_packed_fused_shadow,
)
from ray_tracer_tpu.render.renderer import prepare


@pytest.fixture(scope="module")
def packed_prep():
    from ray_tracer_tpu.config import GridConfig
    from ray_tracer_tpu.models.scenes import serial_scene_config

    cfg = serial_scene_config(48, 48)
    cfg = dataclasses.replace(
        cfg,
        render=dataclasses.replace(
            cfg.render, faithful=False, det_dtype="float32",
            traversal="packed", packed_block_tris=14,
            grid=GridConfig(resolution_multiplier=0.75),
        ),
    )
    return prepare(cfg)


@pytest.mark.parametrize("wave", [256, 1024, 48 * 48 + 100])
def test_persistent_matches_tiled_primary(packed_prep, wave):
    prep = packed_prep
    rays = camera_rays(prep.cfg.camera, dtype=jnp.float32)
    want = traverse_packed(rays, prep.packed.arrays, prep.packed.meta, t_gate=0.0)
    got = persistent_trace(
        rays, prep.packed.arrays, prep.packed.meta, wave=wave, t_gate=0.0
    )
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(want.hit))
    np.testing.assert_array_equal(np.asarray(got.tri_id), np.asarray(want.tri_id))
    h = np.asarray(want.hit)
    np.testing.assert_array_equal(
        np.asarray(got.t)[h], np.asarray(want.t)[h]
    )


def test_persistent_fused_matches_fused(packed_prep):
    prep = packed_prep
    rcfg = prep.cfg.render
    rays = camera_rays(prep.cfg.camera, dtype=jnp.float32)
    light = prep.scene.light_pos
    kw = dict(
        shadow_gate=rcfg.shadow_eps,
        shadow_mint=rcfg.shadow_mint(),
        serial_quirk=rcfg.shadow_dir_away_from_light(),
    )
    want = traverse_packed_fused_shadow(
        rays, prep.packed.arrays, prep.packed.meta, light,
        primary_gate=0.0, **kw,
    )
    got = persistent_trace(
        rays, prep.packed.arrays, prep.packed.meta, light,
        wave=512, t_gate=0.0, fuse_shadow=True, need_shadow_tri=True, **kw,
    )
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(want.hit))
    np.testing.assert_array_equal(np.asarray(got.tri_id), np.asarray(want.tri_id))
    np.testing.assert_array_equal(
        np.asarray(got.in_shadow), np.asarray(want.in_shadow)
    )
    h = np.asarray(want.hit)
    np.testing.assert_array_equal(np.asarray(got.t)[h], np.asarray(want.t)[h])
    # WHICH blocker an occlusion query retires on is ulp-sensitive: the
    # rearm's poi = o + d*t contracts differently (FMA) at different
    # batch widths, and a marginal shadow ray can legitimately find
    # either of two blockers first.  Presence must agree (asserted via
    # in_shadow above); identity must agree with the in_shadow flag.
    np.testing.assert_array_equal(
        np.asarray(got.shadow_tri_id) >= 0, np.asarray(got.in_shadow)
    )


def test_persistent_stop_on_first_hit_occlusion(packed_prep):
    """Occlusion queries: any-hit flag must match the tiled nearest-hit
    traversal's hit flag (stop-on-first changes WHICH hit, not whether)."""
    prep = packed_prep
    rays = camera_rays(prep.cfg.camera, dtype=jnp.float32)
    want = traverse_packed(rays, prep.packed.arrays, prep.packed.meta, t_gate=0.0)
    got = persistent_trace(
        rays, prep.packed.arrays, prep.packed.meta,
        wave=512, t_gate=0.0, stop_on_first_hit=True,
    )
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(want.hit))


def test_persistent_renderer_matches_tiled_spot(packed_prep):
    """Full spot render: persistent scheduler == tiled scheduler."""
    from ray_tracer_tpu.render.renderer import render

    prep = packed_prep
    tiled = np.asarray(render(prep))
    pcfg = dataclasses.replace(
        prep.cfg,
        render=dataclasses.replace(
            prep.cfg.render, scheduler="persistent", wave=700
        ),
    )
    pers = np.asarray(render(prep._replace(cfg=pcfg)))
    np.testing.assert_array_equal(pers, tiled)


def test_persistent_renderer_matches_tiled_reflective():
    """The CUDA-variant scene (3 mirror bounces): the bounce segments go
    through the persistent single-purpose march with refill compaction;
    image must equal the tiled render exactly."""
    from ray_tracer_tpu.config import GridConfig
    from ray_tracer_tpu.models.scenes import parallel_scene_config
    from ray_tracer_tpu.render.renderer import render

    cfg = parallel_scene_config(24, 24)
    cfg = dataclasses.replace(
        cfg,
        render=dataclasses.replace(
            cfg.render, faithful=False, det_dtype="float32",
            traversal="packed", packed_block_tris=14,
            grid=GridConfig(resolution_multiplier=0.75),
        ),
    )
    prep = prepare(cfg)
    tiled = np.asarray(render(prep))
    pcfg = dataclasses.replace(
        cfg,
        render=dataclasses.replace(
            cfg.render, faithful=False, det_dtype="float32",
            traversal="packed", packed_block_tris=14,
            grid=GridConfig(resolution_multiplier=0.75),
            scheduler="persistent", wave=256, fused_shadow=True,
        ),
    )
    pers = np.asarray(render(prep._replace(cfg=pcfg)))
    np.testing.assert_allclose(pers, tiled, atol=1e-4, rtol=1e-5)


def test_persistent_dead_and_padding_lanes(packed_prep):
    """Inf-origin rays (retired bounce lanes / padding) are refill-
    rejected and report miss."""
    prep = packed_prep
    rays = camera_rays(prep.cfg.camera, dtype=jnp.float32)
    import jax

    orig = np.array(rays.orig)
    orig[::3] = np.inf
    dead = rays._replace(orig=jnp.asarray(orig))
    got = persistent_trace(
        dead, prep.packed.arrays, prep.packed.meta, wave=333, t_gate=0.0
    )
    assert not np.asarray(got.hit)[::3].any()
    want = traverse_packed(dead, prep.packed.arrays, prep.packed.meta, t_gate=0.0)
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(want.hit))
    np.testing.assert_array_equal(np.asarray(got.tri_id), np.asarray(want.tri_id))


@pytest.mark.parametrize("pump", [2, 5])
def test_persistent_pump_invariant(packed_prep, pump):
    """Results are invariant to the scatter/refill cadence: pump=K only
    defers the flush, the latched records are identical."""
    prep = packed_prep
    rcfg = prep.cfg.render
    rays = camera_rays(prep.cfg.camera, dtype=jnp.float32)
    light = prep.scene.light_pos
    kw = dict(
        shadow_gate=rcfg.shadow_eps,
        shadow_mint=rcfg.shadow_mint(),
        serial_quirk=rcfg.shadow_dir_away_from_light(),
        wave=512, t_gate=0.0, fuse_shadow=True, need_shadow_tri=True,
        need_steps=True,
    )
    a = persistent_trace(
        rays, prep.packed.arrays, prep.packed.meta, light, pump=1, **kw
    )
    b = persistent_trace(
        rays, prep.packed.arrays, prep.packed.meta, light, pump=pump, **kw
    )
    for f in ("hit", "t", "tri_id", "in_shadow", "shadow_tri_id", "steps"):
        np.testing.assert_array_equal(
            np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), err_msg=f
        )


def test_persistent_need_t_false(packed_prep):
    """need_t=False drops the t scatter; hit/tri agree exactly and t
    keeps the isfinite(t) == hit invariant as a 0/inf placeholder."""
    prep = packed_prep
    rays = camera_rays(prep.cfg.camera, dtype=jnp.float32)
    a = persistent_trace(
        rays, prep.packed.arrays, prep.packed.meta, wave=512, t_gate=0.0
    )
    b = persistent_trace(
        rays, prep.packed.arrays, prep.packed.meta, wave=512, t_gate=0.0,
        need_t=False,
    )
    np.testing.assert_array_equal(np.asarray(a.hit), np.asarray(b.hit))
    np.testing.assert_array_equal(np.asarray(a.tri_id), np.asarray(b.tri_id))
    np.testing.assert_array_equal(
        np.isfinite(np.asarray(b.t)), np.asarray(b.hit)
    )


def test_persistent_camera_refill_matches(packed_prep):
    """Camera-generated refill (zero-gather ray source) is bitwise the
    same march as the packed-table refill."""
    prep = packed_prep
    rays = camera_rays(prep.cfg.camera, dtype=jnp.float32)
    a = persistent_trace(
        rays, prep.packed.arrays, prep.packed.meta, wave=400, t_gate=0.0
    )
    b = persistent_trace(
        rays, prep.packed.arrays, prep.packed.meta, wave=400, t_gate=0.0,
        camera=prep.cfg.camera,
    )
    for f in ("hit", "tri_id"):
        np.testing.assert_array_equal(
            np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        )
    # in-loop regenerated directions FMA-contract differently than the
    # batch expression: t drifts in the last ulp.  The renderer consumes
    # only hit/tri (it recomputes t differentiably), so ulp-t is fine.
    h = np.asarray(a.hit)
    np.testing.assert_allclose(
        np.asarray(b.t)[h], np.asarray(a.t)[h], rtol=1e-5
    )


def test_persistent_compact_bit_identical_and_fewer_rounds(packed_prep):
    """Queue compaction drops never-entering rays up front; results are
    bit-identical and a mostly-dead batch takes far fewer rounds."""
    import jax.numpy as jnp

    from ray_tracer_tpu.ops.camera import camera_rays
    from ray_tracer_tpu.ops.persistent import persistent_trace

    prep = packed_prep
    rays = camera_rays(prep.cfg.camera)
    # kill 7/8 of the batch the way retired bounce lanes die: inf origin
    r = rays.count
    dead = (jnp.arange(r) % 8) != 0
    rays = rays._replace(
        orig=jnp.where(dead[:, None], jnp.inf, rays.orig)
    )
    # small wave so the dead-ray pop sweep (ceil(R/W) rounds) dominates
    # the non-compacted round count
    kw = dict(wave=16, pump=1, need_t=True, return_iters=True)
    res0, it0 = persistent_trace(
        rays, prep.packed.arrays, prep.packed.meta, compact=False, **kw
    )
    res1, it1 = persistent_trace(
        rays, prep.packed.arrays, prep.packed.meta, compact=True, **kw
    )
    for a, b in zip(res0, res1):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert int(it1) < int(it0), (int(it0), int(it1))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_soup_cross_scheduler_agreement(seed):
    """Fuzz: random triangle soups x random ray batches — the brute
    all-pairs intersect, the tiled packed march, and the persistent
    wave must agree on every hit id and t (same Cramer arithmetic,
    independent search strategies)."""
    import numpy as onp

    from ray_tracer_tpu.accel.grid import build_grid
    from ray_tracer_tpu.accel.packed import pack_grid
    from ray_tracer_tpu.core.rays import RayBatch
    from ray_tracer_tpu.ops.intersect import intersect_brute

    rng = onp.random.default_rng(seed)
    nt = 200
    centers = rng.uniform(-2, 2, (nt, 1, 3))
    tris = centers + rng.normal(0, 0.35, (nt, 3, 3))
    verts = tris.reshape(-1, 3).astype(onp.float32)
    faces = onp.arange(3 * nt, dtype=onp.int32).reshape(-1, 3)

    grid = build_grid(verts, faces, resolution_multiplier=1.0)
    packed = pack_grid(grid, verts, faces, block_tris=14)

    r = 512
    orig = rng.uniform(-4, 4, (r, 3)).astype(onp.float32)
    dirn = rng.normal(0, 1, (r, 3)).astype(onp.float32)
    dirn /= onp.linalg.norm(dirn, axis=1, keepdims=True)
    rays = RayBatch.make(jnp.asarray(orig), jnp.asarray(dirn))

    v0 = jnp.asarray(tris[:, 0].astype(onp.float32))
    v1 = jnp.asarray(tris[:, 1].astype(onp.float32))
    v2 = jnp.asarray(tris[:, 2].astype(onp.float32))
    want = intersect_brute(rays, v0, v1, v2, t_lower=0.0)

    tiled = traverse_packed(rays, packed.arrays, packed.meta, t_gate=0.0)
    pers = persistent_trace(
        rays, packed.arrays, packed.meta, wave=128, pump=2, t_gate=0.0,
        compact=True,
    )

    wh = onp.asarray(want.hit)
    for name, got in (("tiled", tiled), ("persistent", pers)):
        gh = onp.asarray(got.hit)
        onp.testing.assert_array_equal(wh, gh, err_msg=name)
        onp.testing.assert_array_equal(
            onp.asarray(want.tri_id)[wh], onp.asarray(got.tri_id)[wh],
            err_msg=name,
        )
        # brute evaluates Cramer over (R, nt) batches, the marches over
        # (R, 14) rows — different FMA contraction, ulp-level t drift
        onp.testing.assert_allclose(
            onp.asarray(want.t)[wh], onp.asarray(got.t)[wh],
            rtol=1e-5, err_msg=name,
        )
    # the two grid schedulers share _march_step: bitwise equal
    onp.testing.assert_array_equal(onp.asarray(tiled.t), onp.asarray(pers.t))
    onp.testing.assert_array_equal(
        onp.asarray(tiled.tri_id), onp.asarray(pers.tri_id)
    )


def test_persistent_compact_with_camera_refill(packed_prep):
    """compact + camera combine: the queue is prefiltered on rays
    REGENERATED from the camera (the count-only contract), and the
    march matches the camera-refill run without compaction.  A
    placeholder ray table must not influence the result."""
    prep = packed_prep
    rays = camera_rays(prep.cfg.camera, dtype=jnp.float32)
    # placeholder batch: same count, garbage content (never entering)
    from ray_tracer_tpu.core.rays import RayBatch

    junk = RayBatch.make(
        jnp.full((rays.count, 3), jnp.inf, jnp.float32),
        jnp.ones((rays.count, 3), jnp.float32),
    )
    kw = dict(wave=400, t_gate=0.0, camera=prep.cfg.camera)
    a = persistent_trace(rays, prep.packed.arrays, prep.packed.meta, **kw)
    b = persistent_trace(
        junk, prep.packed.arrays, prep.packed.meta, compact=True, **kw
    )
    for f in ("hit", "tri_id"):
        np.testing.assert_array_equal(
            np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), err_msg=f
        )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_soup_cross_scheduler_shading_fuzz(seed):
    """Fuzz the FULL shaded render (primary + shadow, incl. the fused
    rearm) across every scheduler/fusion combination on random soups:
    fused and two-pass shadows must be bitwise-identical within a
    scheduler (same hits, same occlusion), and the two schedulers must
    agree to last-ulp (they share _march_step and the retire/rearm
    layer, but the tiled path shades in ray_tile batches while the
    persistent path shades the full batch — different XLA fusion
    shapes FMA-contract the shading arithmetic differently)."""
    import dataclasses

    import numpy as onp

    from ray_tracer_tpu.config import (
        CameraConfig, LightConfig, MaterialConfig, RenderConfig, SceneConfig,
    )
    from ray_tracer_tpu.io.obj import MeshArrays
    from ray_tracer_tpu.models.scenes import scene_from_meshes
    from ray_tracer_tpu.render.renderer import prepare, render

    rng = onp.random.default_rng(100 + seed)
    nt = 60
    centers = rng.uniform(-2, 2, (nt, 1, 3))
    tris = (centers + rng.normal(0, 0.4, (nt, 3, 3))).astype(onp.float32)
    mesh = MeshArrays(
        verts=tris.reshape(-1, 3),
        faces=onp.arange(3 * nt, dtype=onp.int32).reshape(-1, 3),
        uvs=onp.zeros((1, 2), onp.float32),
        uv_faces=onp.zeros((nt, 3), onp.int32),
    )
    mat = MaterialConfig(base_color=(180.0, 120.0, 60.0), kd=2.0, ks=2.0,
                         spec_alpha=4.0, ka=0.2)
    light = LightConfig(position=tuple(rng.uniform(-5, 5, 3)), intensity=1.0)
    scene = scene_from_meshes([(mesh, 0)], [mat], light)

    imgs = {}
    for sched, fused in (("tiled", True), ("tiled", False),
                         ("persistent", True), ("persistent", False)):
        cfg = SceneConfig(
            materials=(mat,),
            camera=CameraConfig(position=(4.0, 3.0, 4.0), target=(0, 0, 0),
                                up=(0, 1, 0), fov_degrees=50.0,
                                width=24, height=24),
            light=light,
            render=RenderConfig(shading="parallel", faithful=False,
                                traversal="packed", scheduler=sched,
                                fused_shadow=fused, wave=128, pump=2,
                                ray_tile=64, shadow_eps=1e-3),
        )
        imgs[(sched, fused)] = onp.asarray(render(prepare(cfg, scene=scene)))

    # within a scheduler: fused == two-pass, bitwise
    onp.testing.assert_array_equal(imgs[("tiled", True)],
                                   imgs[("tiled", False)])
    onp.testing.assert_array_equal(imgs[("persistent", True)],
                                   imgs[("persistent", False)])
    # across schedulers: last-ulp shading drift only
    onp.testing.assert_allclose(imgs[("tiled", True)],
                                imgs[("persistent", True)],
                                rtol=1e-5, atol=1e-3)


def test_shadow_skip_dead_bitwise(tiny_prep):
    """The zero-direct shadow skip (serial shading: ambient rides
    OUTSIDE the shadow scale, so n.l<=0 & n.h<=0 makes occlusion
    invisible) must not change a single bit of the image vs the same
    persistent fused render with the skip off."""
    import dataclasses

    import ray_tracer_tpu.ops.persistent as P
    from ray_tracer_tpu.render.renderer import prepare, render

    cfg = dataclasses.replace(
        tiny_prep.cfg,
        render=dataclasses.replace(
            tiny_prep.cfg.render, shading="serial", traversal="packed",
            scheduler="persistent", faithful=False, det_dtype="float32",
            wave=64, fused_shadow=True,
        ),
    )
    prep = prepare(cfg, scene=tiny_prep.scene)

    orig = P.persistent_trace
    forced = {}

    def wrap(*args, **kw):
        if "forced" in forced and "shadow_skip_dead" in kw:
            kw["shadow_skip_dead"] = forced["forced"]
        return orig(*args, **kw)

    P.persistent_trace = wrap
    try:
        forced["forced"] = True
        on = np.asarray(render(prep))
        forced["forced"] = False
        off = np.asarray(render(prep))
    finally:
        P.persistent_trace = orig
    np.testing.assert_array_equal(on, off)


def _packed_gradcheck(tiny_prep, layout):
    cfg = dataclasses.replace(
        tiny_prep.cfg,
        render=dataclasses.replace(
            tiny_prep.cfg.render, traversal="packed", faithful=False,
            det_dtype="float32", grid_layout=layout, packed_block_tris=14,
        ),
    )
    return prepare(cfg, scene=tiny_prep.scene)


def _march_winner_pick(prep):
    """March the camera rays with need_hit_tri and return the final
    (best_t, best_blk, best_slot, best_tri9) as numpy arrays."""
    import jax

    from ray_tracer_tpu.ops.traverse_packed import _march_step, _slab_entry

    grid, meta = prep.packed.arrays, prep.packed.meta
    rays = camera_rays(prep.cfg.camera)
    o = rays.orig.astype(jnp.float32)
    d = rays.dirn.astype(jnp.float32)
    maxt = rays.maxt.astype(jnp.float32)
    t0, entered = _slab_entry(grid, o, d, rays.mint.astype(jnp.float32), maxt)
    r = o.shape[0]
    zi = jnp.zeros((r,), jnp.int32)
    s = dict(alive=entered, testing=jnp.zeros((r,), bool), t_cur=t0,
             t_exit_cell=jnp.zeros((r,), jnp.float32), first_blk=zi,
             n_blk=zi, cursor=zi, best_t=jnp.full((r,), jnp.inf, jnp.float32),
             best_blk=zi, best_slot=zi,
             best_tri9=jnp.zeros((r, 9), jnp.float32))
    step = jax.jit(lambda s: _march_step(
        s, o=o, d=d, invd=1.0 / d, gate=jnp.zeros((r,), jnp.float32),
        maxt=maxt, grid=grid, meta=meta, need_hit_tri=True))
    for _ in range(4 * meta.n_voxels[0] * (meta.max_blocks + 1) + 64):
        if not bool(s["alive"].any()):
            break
        s = step(s)
    assert not bool(s["alive"].any()), "march did not finish"
    return {k: np.asarray(s[k]) for k in
            ("best_t", "best_blk", "best_slot", "best_tri9")}


def _assert_pick_is_row_gather(prep, got):
    blocks = np.asarray(prep.packed.arrays.blocks)
    hit = np.isfinite(got["best_t"])
    assert hit.any() and not hit.all()
    bt = prep.packed.meta.block_tris
    rows = blocks[got["best_blk"][hit]][:, : bt * 9].reshape(-1, bt, 9)
    want = rows[np.arange(rows.shape[0]), got["best_slot"][hit]]
    # bitwise: an exact selection, never a rounded contraction
    np.testing.assert_array_equal(got["best_tri9"][hit].view(np.uint32),
                                  want.astype(np.float32).view(np.uint32))


@pytest.mark.parametrize("layout", ["inline", "blocks"])
def test_winner_pick_is_exact_row_gather(tiny_prep, layout):
    """_march_step's best_tri9 (read by the dead-shadow skip and the
    in-wave shading) is exactly the winning slot's 9 floats of the
    winning row, bit for bit."""
    prep = _packed_gradcheck(tiny_prep, layout)
    assert prep.packed.meta.inline == (layout == "inline")
    _assert_pick_is_row_gather(prep, _march_winner_pick(prep))


def test_fused_shadow_skip_reads_exact_winner(tiny_prep):
    """The fused-shadow persistent march with the dead-shadow skip on
    the gradcheck scene: hits and triangles equal the skip-off march,
    and every lane whose shadow flag the skip changed has exactly zero
    direct light at its true winning triangle."""
    prep = _packed_gradcheck(tiny_prep, "auto")
    rays = camera_rays(prep.cfg.camera)
    light = prep.scene.light_pos
    kw = dict(wave=64, t_gate=0.0, fuse_shadow=True, shadow_gate=1e-3,
              shadow_mint=1e-3, serial_quirk=False, shade_serial=False)
    on = persistent_trace(rays, prep.packed.arrays, prep.packed.meta, light,
                          shadow_skip_dead=True, **kw)
    off = persistent_trace(rays, prep.packed.arrays, prep.packed.meta, light,
                           shadow_skip_dead=False, **kw)
    np.testing.assert_array_equal(np.asarray(on.hit), np.asarray(off.hit))
    np.testing.assert_array_equal(np.asarray(on.tri_id), np.asarray(off.tri_id))
    changed = np.asarray(on.in_shadow) != np.asarray(off.in_shadow)
    assert changed.any(), "the skip never fired on this scene"
    assert not np.asarray(on.in_shadow)[changed].any()
    tri = np.asarray(prep.scene.verts, np.float64)[
        np.asarray(prep.scene.faces)[np.asarray(on.tri_id)[changed]]]
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    n = np.cross(c - b, a - b)  # the parallel-shading facet normal
    o = np.asarray(rays.orig, np.float64)[changed]
    d = np.asarray(rays.dirn, np.float64)[changed]
    t = np.asarray(off.t, np.float64)[changed]
    to_l = np.asarray(light, np.float64) - (o + d * t[:, None])
    l = to_l / np.linalg.norm(to_l, axis=-1, keepdims=True)
    assert (np.sum(n * l, axis=-1) <= 0).all()
    assert (np.sum(n * (l - d), axis=-1) <= 0).all()


@pytest.mark.gpu
def test_winner_pick_is_exact_on_gpu(tiny_prep, gpu):
    """The same bitwise pin where it matters: on the card, where an f32
    contraction may run at reduced precision."""
    import jax

    with jax.default_device(gpu):
        prep = _packed_gradcheck(tiny_prep, "inline")
        _assert_pick_is_row_gather(prep, _march_winner_pick(prep))
