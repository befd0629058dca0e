"""Block-packed grid + production traversal (accel/packed.py,
ops/traverse_packed.py): layout invariants, brute-force agreement,
render path, sharding, and gradients."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tracer_tpu.accel.packed import (
    BLOCK_TRIS,
    chebyshev_distance_field,
    decode_cell_info,
    pack_grid,
)
from ray_tracer_tpu.core.rays import RayBatch
from ray_tracer_tpu.ops.camera import camera_rays
from ray_tracer_tpu.ops.intersect import intersect_brute
from ray_tracer_tpu.ops.traverse_packed import traverse_packed


@pytest.fixture(scope="module")
def packed(tiny_prep):
    return pack_grid(
        tiny_prep.grid,
        np.asarray(tiny_prep.scene.verts),
        np.asarray(tiny_prep.scene.faces),
    )


@pytest.fixture(scope="module")
def packed_prep(tiny_prep):
    from ray_tracer_tpu.render.renderer import prepare

    cfg = dataclasses.replace(
        tiny_prep.cfg,
        render=dataclasses.replace(
            tiny_prep.cfg.render, faithful=False, traversal="packed", ray_tile=64
        ),
    )
    return prepare(cfg, scene=tiny_prep.scene)


def test_pack_layout_matches_csr(tiny_prep, packed):
    """Every CSR (cell, slot) entry appears at the right block/lane with
    the right 9 floats, and slot_tri round-trips the triangle id."""
    grid = tiny_prep.grid
    cs = np.asarray(grid.arrays.cell_start)
    ids = np.asarray(grid.arrays.tri_ids)
    verts = np.asarray(tiny_prep.scene.verts)
    faces = np.asarray(tiny_prep.scene.faces)
    tri9 = verts[faces].reshape(-1, 9).astype(np.float32)
    info = np.asarray(packed.arrays.cell_info)
    blocks = np.asarray(packed.arrays.blocks)
    slot_tri = np.asarray(packed.arrays.slot_tri)

    first, nblk, _, _ = (np.asarray(x) for x in decode_cell_info(jnp.asarray(info)))
    rng = np.random.default_rng(0)
    for c in rng.choice(len(cs) - 1, size=200, replace=False):
        count = cs[c + 1] - cs[c]
        assert nblk[c] == -(-count // BLOCK_TRIS)
        assert (nblk[c] > 0) == (count > 0)
        for j in range(count):
            row = first[c] + j // BLOCK_TRIS
            slot = j % BLOCK_TRIS
            tid = ids[cs[c] + j]
            assert slot_tri[row * BLOCK_TRIS + slot] == tid
            np.testing.assert_array_equal(
                blocks[row, slot * 9:(slot + 1) * 9], tri9[tid]
            )


def test_inline_layout_matches_csr(tiny_prep):
    """Inline-layout build invariants: row `lin` holds cell lin's first
    block_tris triangles with a decodable header (overflow row, total
    rows, Chebyshev dist) in its last two lanes; overflow rows continue
    the cell's CSR order; slot_tri round-trips ids for both regions."""
    from ray_tracer_tpu.accel.packed import decode_inline_header

    grid = tiny_prep.grid
    verts = np.asarray(tiny_prep.scene.verts)
    faces = np.asarray(tiny_prep.scene.faces)
    inl = pack_grid(grid, verts, faces, inline=True)
    assert inl.meta.inline
    assert inl.arrays.cell_info.shape == (1,)  # unused by the march
    cs = np.asarray(grid.arrays.cell_start)
    ids = np.asarray(grid.arrays.tri_ids)
    tri9 = verts[faces].reshape(-1, 9).astype(np.float32)
    blocks = np.asarray(inl.arrays.blocks)
    slot_tri = np.asarray(inl.arrays.slot_tri)
    n_cells = inl.meta.total_voxels

    ref = pack_grid(grid, verts, faces)  # blocks layout for cross-check
    _, ref_nblk, ref_lo, ref_hi = (
        np.asarray(x) for x in decode_cell_info(jnp.asarray(ref.arrays.cell_info))
    )
    ovf, nrows, lo, hi = (
        np.asarray(x)
        for x in decode_inline_header(jnp.asarray(blocks[:n_cells]))
    )
    np.testing.assert_array_equal(nrows, ref_nblk)
    # empty cells carry identical leap boxes in both layouts
    e = nrows == 0
    np.testing.assert_array_equal(lo[e], ref_lo[e])
    np.testing.assert_array_equal(hi[e], ref_hi[e])

    rng = np.random.default_rng(1)
    for c in rng.choice(n_cells, size=200, replace=False):
        count = cs[c + 1] - cs[c]
        for j in range(count):
            row = c if j < BLOCK_TRIS else ovf[c] + j // BLOCK_TRIS - 1
            slot = j % BLOCK_TRIS
            tid = ids[cs[c] + j]
            assert slot_tri[row * BLOCK_TRIS + slot] == tid
            np.testing.assert_array_equal(
                blocks[row, slot * 9:(slot + 1) * 9], tri9[tid]
            )


def test_inline_traversal_bitwise_equals_blocks(tiny_prep, packed):
    """The inline (one-gather) march is bit-identical to the blocks
    layout on every packed path: plain traversal, the fused
    primary+shadow march, and the persistent wave (triangle order per
    cell is identical by construction, so even ties agree)."""
    from ray_tracer_tpu.ops.persistent import persistent_trace
    from ray_tracer_tpu.ops.traverse_packed import traverse_packed_fused_shadow

    prep = tiny_prep
    inl = pack_grid(
        prep.grid, np.asarray(prep.scene.verts), np.asarray(prep.scene.faces),
        inline=True,
    )
    rays = camera_rays(prep.cfg.camera)
    a = traverse_packed(rays, packed.arrays, packed.meta, t_gate=1e-4)
    b = traverse_packed(rays, inl.arrays, inl.meta, t_gate=1e-4)
    for f in ("hit", "t", "tri_id", "steps"):
        np.testing.assert_array_equal(
            np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), err_msg=f
        )

    light = prep.scene.light_pos
    kw = dict(primary_gate=1e-3, shadow_gate=1e-3, shadow_mint=1e-3 + 0.02,
              serial_quirk=False)
    fa = traverse_packed_fused_shadow(rays, packed.arrays, packed.meta, light, **kw)
    fb = traverse_packed_fused_shadow(rays, inl.arrays, inl.meta, light, **kw)
    for f in ("hit", "t", "tri_id", "in_shadow", "shadow_tri_id"):
        np.testing.assert_array_equal(
            np.asarray(getattr(fa, f)), np.asarray(getattr(fb, f)), err_msg=f
        )

    pkw = dict(wave=64, fuse_shadow=True, shadow_gate=1e-3,
               shadow_mint=1e-3 + 0.02, t_gate=1e-3, pump=2,
               need_shadow_tri=True)
    pa = persistent_trace(rays, packed.arrays, packed.meta, light, **pkw)
    pb = persistent_trace(rays, inl.arrays, inl.meta, light, **pkw)
    for f in ("hit", "t", "tri_id", "in_shadow", "shadow_tri_id"):
        np.testing.assert_array_equal(
            np.asarray(getattr(pa, f)), np.asarray(getattr(pb, f)), err_msg=f
        )


def test_grid_layout_config(tiny_prep):
    """grid_layout wiring: auto picks inline when the table fits, forced
    blocks/inline both render, and the images are identical."""
    from ray_tracer_tpu.render.renderer import prepare, render

    def prep_with(layout):
        cfg = dataclasses.replace(
            tiny_prep.cfg,
            render=dataclasses.replace(
                tiny_prep.cfg.render, faithful=False, traversal="packed",
                ray_tile=64, grid_layout=layout,
            ),
        )
        return prepare(cfg, scene=tiny_prep.scene)

    auto = prep_with("auto")
    assert auto.packed.meta.inline  # tiny scene: inline always fits
    blocks = prep_with("blocks")
    assert not blocks.packed.meta.inline
    np.testing.assert_array_equal(
        np.asarray(render(auto)), np.asarray(render(blocks))
    )
    with pytest.raises(ValueError):
        prep_with("bogus")


def test_distance_field_property():
    occ = np.zeros((6, 5, 4), bool)
    occ[1, 2, 3] = True
    occ[5, 0, 0] = True
    dist = chebyshev_distance_field(occ)
    xs = np.argwhere(occ)
    for idx in np.ndindex(occ.shape):
        want = min(np.abs(np.asarray(idx) - x).max() for x in xs)
        assert dist[idx] == min(want, 31), idx


def test_empty_box_field_safety():
    """Every empty cell's greedy box is verifiably empty and within the
    extent cap (on a random occupancy — the property the march's
    correctness rests on: a leap may only skip cells that contain no
    triangles), and boxes are non-degenerate wherever free space
    exists (each direction grows at least until it touches an occupied
    cell or the cap)."""
    from ray_tracer_tpu.accel.packed import EXT_CAP, greedy_empty_boxes

    rng = np.random.default_rng(7)
    occ = rng.random((12, 9, 11)) < 0.08
    occ[0, 0, 0] = True  # ensure at least one occupied cell
    ext = greedy_empty_boxes(occ)
    assert (ext >= 0).all() and (ext <= EXT_CAP).all()
    assert (ext[:, occ] == 0).all()
    for z, y, x in np.argwhere(~occ):
        xm, xp, ym, yp, zm, zp = ext[:, z, y, x]
        box = occ[max(z - zm, 0): z + zp + 1,
                  max(y - ym, 0): y + yp + 1,
                  max(x - xm, 0): x + xp + 1]
        assert not box.any(), (z, y, x)
        # maximality per direction: one more cell would hit something
        # or leave the cap (grid-edge slabs count as empty, so only the
        # in-grid case is checked)
        if xp < EXT_CAP and x + xp + 1 < occ.shape[2]:
            assert occ[max(z - zm, 0): z + zp + 1,
                       max(y - ym, 0): y + yp + 1,
                       x + xp + 1].any(), (z, y, x)


def test_extents_encode_decode_roundtrip():
    from ray_tracer_tpu.accel.packed import _decode_extents, pack_extents

    rng = np.random.default_rng(3)
    ext = rng.integers(0, 32, size=(6, 50)).astype(np.int32)
    word = pack_extents(ext)
    lo, hi = (np.asarray(x) for x in _decode_extents(jnp.asarray(word)))
    np.testing.assert_array_equal(lo, ext[[0, 2, 4]].T)
    np.testing.assert_array_equal(hi, ext[[1, 3, 5]].T)


@pytest.mark.parametrize("inline", [False, True])
def test_box_leap_bitwise_equals_cheb_hits(tiny_prep, inline):
    """leap='box' must find exactly the hits of the reproduction
    leap='cheb' build (leaps only skip verified-empty space) with no
    more steps, on both layouts and on the fused march."""
    from ray_tracer_tpu.ops.traverse_packed import traverse_packed_fused_shadow

    prep = tiny_prep
    verts = np.asarray(prep.scene.verts)
    faces = np.asarray(prep.scene.faces)
    box = pack_grid(prep.grid, verts, faces, inline=inline, leap="box")
    cheb = pack_grid(prep.grid, verts, faces, inline=inline, leap="cheb")
    rays = camera_rays(prep.cfg.camera)
    a = traverse_packed(rays, box.arrays, box.meta, t_gate=1e-4)
    b = traverse_packed(rays, cheb.arrays, cheb.meta, t_gate=1e-4)
    for f in ("hit", "t", "tri_id"):
        np.testing.assert_array_equal(
            np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), err_msg=f
        )
    assert np.asarray(a.steps).sum() <= np.asarray(b.steps).sum()

    light = prep.scene.light_pos
    kw = dict(primary_gate=1e-3, shadow_gate=1e-3, shadow_mint=1e-3 + 0.02,
              serial_quirk=False)
    fa = traverse_packed_fused_shadow(rays, box.arrays, box.meta, light, **kw)
    fb = traverse_packed_fused_shadow(rays, cheb.arrays, cheb.meta, light, **kw)
    for f in ("hit", "t", "tri_id", "in_shadow", "shadow_tri_id"):
        np.testing.assert_array_equal(
            np.asarray(getattr(fa, f)), np.asarray(getattr(fb, f)), err_msg=f
        )


def test_traverse_packed_matches_brute(tiny_prep, packed):
    rays = camera_rays(tiny_prep.cfg.camera)
    v0, v1, v2 = tiny_prep.scene.triangle_soa()
    want = intersect_brute(rays, v0, v1, v2, t_lower=1e-4)
    got = traverse_packed(rays, packed.arrays, packed.meta, t_gate=1e-4)
    np.testing.assert_array_equal(np.asarray(want.hit), np.asarray(got.hit))
    h = np.asarray(want.hit)
    np.testing.assert_array_equal(np.asarray(want.tri_id)[h], np.asarray(got.tri_id)[h])
    np.testing.assert_allclose(np.asarray(want.t)[h], np.asarray(got.t)[h], rtol=1e-5)


def test_wide_block_traversal_matches_brute(tiny_prep):
    """56-triangle/512-lane block rows (a previously tuned production config)
    find exactly the same hits."""
    prep = tiny_prep
    wide = pack_grid(
        prep.grid, np.asarray(prep.scene.verts), np.asarray(prep.scene.faces),
        block_tris=56,
    )
    assert wide.meta.row_lanes == 512
    rays = camera_rays(prep.cfg.camera)
    v0, v1, v2 = prep.scene.triangle_soa()
    want = intersect_brute(rays, v0, v1, v2, t_lower=1e-4)
    got = traverse_packed(rays, wide.arrays, wide.meta, t_gate=1e-4)
    np.testing.assert_array_equal(np.asarray(want.hit), np.asarray(got.hit))
    h = np.asarray(want.hit)
    np.testing.assert_array_equal(np.asarray(want.tri_id)[h], np.asarray(got.tri_id)[h])


def test_traverse_packed_occlusion_mode(tiny_prep, packed):
    rays = camera_rays(tiny_prep.cfg.camera)
    full = traverse_packed(rays, packed.arrays, packed.meta, t_gate=1e-4)
    occ = traverse_packed(
        rays, packed.arrays, packed.meta, t_gate=1e-4, stop_on_first_hit=True
    )
    np.testing.assert_array_equal(np.asarray(full.hit), np.asarray(occ.hit))
    assert np.asarray(occ.steps).sum() <= np.asarray(full.steps).sum()


def test_packed_render_matches_csr_fast_path(tiny_prep, packed_prep):
    """Same scene through csr-fast and packed pipelines: images agree on
    all but possible boundary pixels."""
    from ray_tracer_tpu.io.ppm import tonemap_u8
    from ray_tracer_tpu.render.renderer import prepare, render

    fast_cfg = dataclasses.replace(
        tiny_prep.cfg,
        render=dataclasses.replace(tiny_prep.cfg.render, faithful=False, ray_tile=64),
    )
    a = tonemap_u8(np.asarray(render(prepare(fast_cfg, scene=tiny_prep.scene))))
    b = tonemap_u8(np.asarray(render(packed_prep)))
    diff = np.abs(a.astype(int) - b.astype(int)).max(axis=-1)
    assert (diff > 2).mean() < 0.01, f"{(diff > 2).mean():.3%} pixels differ"


def test_fused_shadow_march_equals_two_pass(tiny_prep):
    """The fused primary+shadow march (lanes rearm as shadow rays on
    primary retirement) must give the identical image to the sequential
    two-pass pipeline."""
    from ray_tracer_tpu.render.renderer import prepare, render

    base = dataclasses.replace(
        tiny_prep.cfg,
        render=dataclasses.replace(
            tiny_prep.cfg.render, faithful=False, traversal="packed",
            ray_tile=64, fused_shadow=True,
        ),
    )
    off = dataclasses.replace(
        base, render=dataclasses.replace(base.render, fused_shadow=False)
    )
    a = np.asarray(render(prepare(base, scene=tiny_prep.scene)))
    b = np.asarray(render(prepare(off, scene=tiny_prep.scene)))
    np.testing.assert_array_equal(a, b)


def test_fused_shadow_direct_matches_components(tiny_prep, packed):
    """traverse_packed_fused_shadow vs separate primary + shadow calls."""
    import jax.numpy as jnp

    from ray_tracer_tpu.core import vecmath as vm
    from ray_tracer_tpu.ops.traverse_packed import traverse_packed_fused_shadow

    prep = tiny_prep
    rays = camera_rays(prep.cfg.camera)
    eps = 1e-3
    fused = traverse_packed_fused_shadow(
        rays, packed.arrays, packed.meta, prep.scene.light_pos,
        primary_gate=eps, shadow_gate=eps, shadow_mint=eps + 0.02,
        serial_quirk=False,
    )
    prim = traverse_packed(rays, packed.arrays, packed.meta, t_gate=eps)
    np.testing.assert_array_equal(np.asarray(fused.hit), np.asarray(prim.hit))
    h = np.asarray(prim.hit)
    np.testing.assert_array_equal(
        np.asarray(fused.tri_id)[h], np.asarray(prim.tri_id)[h]
    )
    np.testing.assert_allclose(
        np.asarray(fused.t)[h], np.asarray(prim.t)[h], rtol=1e-6
    )
    poi = rays.at(prim.t)
    sdir = vm.normalize(prep.scene.light_pos - poi)
    sorig = jnp.where(prim.hit[:, None], poi, jnp.inf)
    from ray_tracer_tpu.core.rays import RayBatch

    srays = RayBatch.make(sorig, sdir, mint=eps + 0.02)
    sres = traverse_packed(
        srays, packed.arrays, packed.meta, t_gate=eps, stop_on_first_hit=True
    )
    want_shadow = np.asarray(sres.hit) & h
    np.testing.assert_array_equal(np.asarray(fused.in_shadow), want_shadow)


def test_packed_render_sharded_equals_single(packed_prep, eight_device_mesh):
    from ray_tracer_tpu.parallel.shard import render_sharded
    from ray_tracer_tpu.render.renderer import render

    single = np.asarray(render(packed_prep))
    sharded = np.asarray(render_sharded(packed_prep, mesh=eight_device_mesh))
    np.testing.assert_array_equal(single, sharded)


def test_packed_gradients_finite_and_nonzero(packed_prep):
    from ray_tracer_tpu.opt.fit import image_loss, split_scene

    prep = packed_prep
    params = split_scene(prep.scene)
    target = jnp.zeros((prep.cfg.camera.height, prep.cfg.camera.width, 3), jnp.float32)
    g = jax.grad(image_loss)(
        params, prep.scene, prep.packed.arrays, prep.packed.meta, prep.cfg, target
    )
    leaves = jax.tree.leaves(g)
    assert all(np.isfinite(np.asarray(x)).all() for x in leaves)
    assert any(np.abs(np.asarray(x)).max() > 0 for x in leaves)


def test_parallel_scene_reflections_on_packed_path():
    """The reflective CUDA-variant scene through the production packed
    traversal: close to the faithful csr-fast image (boundary pixels
    only)."""
    from ray_tracer_tpu.io.ppm import tonemap_u8
    from ray_tracer_tpu.models.scenes import parallel_scene_config
    from ray_tracer_tpu.render.renderer import prepare, render

    cfg = parallel_scene_config(24, 24)
    csr = dataclasses.replace(
        cfg, render=dataclasses.replace(cfg.render, ray_tile=576)
    )
    packed_cfg = dataclasses.replace(
        cfg, render=dataclasses.replace(cfg.render, traversal="packed", ray_tile=576)
    )
    a = tonemap_u8(np.asarray(render(prepare(csr))))
    b = tonemap_u8(np.asarray(render(prepare(packed_cfg))))
    diff = np.abs(a.astype(int) - b.astype(int)).max(axis=-1)
    assert (diff > 2).mean() < 0.05, f"{(diff > 2).mean():.2%}"


def test_fused_shadow_serial_quirk_equals_two_pass():
    """Serial shading (away-from-light shadow quirk) through the fused
    march — the headline bench config — must equal the two-pass image."""
    from ray_tracer_tpu.models.scenes import serial_scene_config
    from ray_tracer_tpu.render.renderer import prepare, render

    cfg = serial_scene_config(24, 24)
    base = dataclasses.replace(
        cfg,
        render=dataclasses.replace(
            cfg.render, faithful=False, traversal="packed", ray_tile=576,
            fused_shadow=True,
        ),
    )
    off = dataclasses.replace(
        base, render=dataclasses.replace(base.render, fused_shadow=False)
    )
    a = np.asarray(render(prepare(base)))
    b = np.asarray(render(prepare(off)))
    np.testing.assert_array_equal(a, b)


def test_auto_block_tris_policy():
    """packed_block_tris=0 lets prepare() pick the row width from the
    measured density rule; reproduces the sweep-tuned winners."""
    import dataclasses

    from ray_tracer_tpu.config import GridConfig
    from ray_tracer_tpu.models.scenes import serial_scene_config
    from ray_tracer_tpu.render.renderer import prepare

    cfg = serial_scene_config(16, 16)
    cfg = dataclasses.replace(
        cfg,
        render=dataclasses.replace(
            cfg.render, faithful=False, traversal="packed",
            packed_block_tris=0,
            grid=GridConfig(resolution_multiplier=2.0, max_resolution=128),
        ),
    )
    prep = prepare(cfg)
    assert prep.packed.meta.block_tris == 14  # spot: 8.5 tris/occ voxel
    cfg2 = dataclasses.replace(
        cfg,
        render=dataclasses.replace(
            cfg.render, faithful=False, traversal="packed",
            packed_block_tris=0,
            grid=GridConfig(resolution_multiplier=0.75, max_resolution=64),
        ),
    )
    prep2 = prepare(cfg2)
    # coarse grid -> 33 tris/occupied voxel -> wider rows
    assert prep2.packed.meta.block_tris == 56


def test_empty_boxes_native_matches_numpy():
    """The C++ box builder must be bitwise-identical to the numpy
    reference (same balanced round-robin growth, occupancy-only)."""
    from ray_tracer_tpu.accel import native
    from ray_tracer_tpu.accel.packed import EXT_CAP, greedy_empty_boxes

    if not native.available() or native.empty_boxes_native(
        np.zeros((1, 1, 1), bool), 1
    ) is None:
        pytest.skip("native library not built")
    rng = np.random.default_rng(11)
    for shape, p in (((9, 7, 12), 0.1), ((20, 20, 20), 0.02),
                     ((5, 40, 3), 0.3)):
        occ = rng.random(shape) < p
        want = _greedy_numpy(occ)
        got = native.empty_boxes_native(occ, EXT_CAP)
        np.testing.assert_array_equal(got, want, err_msg=str(shape))


def _greedy_numpy(occ):
    """Force the numpy reference path (bypassing the native fast path)."""
    import unittest.mock as mock

    from ray_tracer_tpu.accel import packed

    with mock.patch("ray_tracer_tpu.accel.native.empty_boxes_native",
                    return_value=None):
        return packed.greedy_empty_boxes(occ)


@pytest.mark.parametrize("occ_kind", ["full", "empty", "single", "slab"])
def test_empty_box_degenerate_grids(occ_kind):
    """Box-field edge cases: fully occupied (all extents 0), fully
    empty (cap everywhere), a single cell, and a 1-thick slab grid —
    the safety property must hold on all of them."""
    from ray_tracer_tpu.accel.packed import EXT_CAP, greedy_empty_boxes

    if occ_kind == "full":
        occ = np.ones((4, 3, 5), bool)
    elif occ_kind == "empty":
        occ = np.zeros((4, 3, 5), bool)
    elif occ_kind == "single":
        occ = np.zeros((1, 1, 1), bool)
    else:  # 1-thick slab with a hole
        occ = np.zeros((1, 6, 6), bool)
        occ[0, 2:4, 2:4] = True
    ext = greedy_empty_boxes(occ)
    assert (ext >= 0).all() and (ext <= EXT_CAP).all()
    assert (ext[:, occ] == 0).all()
    if occ_kind == "empty":
        # nothing blocks growth: every direction reaches the cap
        assert (ext[:, ~occ] == EXT_CAP).all()
    for z, y, x in np.argwhere(~occ):
        xm, xp, ym, yp, zm, zp = ext[:, z, y, x]
        box = occ[max(z - zm, 0): z + zp + 1,
                  max(y - ym, 0): y + yp + 1,
                  max(x - xm, 0): x + xp + 1]
        assert not box.any(), (occ_kind, z, y, x)


def test_box_leap_render_on_tiny_grids(tiny_prep):
    """A 1-3 cell grid (coarse resolution clamp) still renders
    identically under box and cheb leaps."""
    from ray_tracer_tpu.accel.grid import build_grid

    verts = np.asarray(tiny_prep.scene.verts)
    faces = np.asarray(tiny_prep.scene.faces)
    g = build_grid(verts, faces, resolution_multiplier=0.1, max_resolution=2)
    assert max(g.meta.n_voxels) <= 2
    box = pack_grid(g, verts, faces, leap="box")
    cheb = pack_grid(g, verts, faces, leap="cheb")
    rays = camera_rays(tiny_prep.cfg.camera)
    a = traverse_packed(rays, box.arrays, box.meta, t_gate=1e-4)
    b = traverse_packed(rays, cheb.arrays, cheb.meta, t_gate=1e-4)
    for f in ("hit", "t", "tri_id"):
        np.testing.assert_array_equal(
            np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), err_msg=f
        )
