"""The renderer: camera -> traversal -> shading -> framebuffer.

Replaces the reference's two drivers — the serial per-pixel double loop
(Serial/raytracer.cpp:150-175) and the CUDA wavefront pipeline of three
persistent kernels glued by atomic work queues
(Parallel/raytracer.cu:32-334, 669-675) — with a single fused XLA
program over dense ray tiles:

  * primary rays for the whole image are one broadcasted batch;
  * the batch is processed in fixed-size tiles via `lax.map`, so each
    tile's DDA `while_loop` retires as soon as ITS rays are done (empty
    sky tiles exit immediately — the role the reference's ray-gen
    frustum cull played, Parallel/raytracer.cu:154-173);
  * mirror reflection is a statically unrolled masked bounce loop
    (replacing device-side recursion at Parallel/raytracer.cu:508-520);
    retired lanes get their origin set to +inf so the grid slab test
    kills them on entry;
  * the 'scheduler' is XLA — there are no queues to race on, and the
    same seed gives the same image on any topology.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ray_tracer_tpu.accel.grid import GridArrays, GridMeta, UniformGrid, build_grid
from ray_tracer_tpu.config import RenderConfig, SceneConfig
from ray_tracer_tpu.core import vecmath as vm
from ray_tracer_tpu.core.rays import RayBatch
from ray_tracer_tpu.models.scenes import Scene
from ray_tracer_tpu.ops.camera import camera_rays
from ray_tracer_tpu.ops.intersect import cramer_bg_safe, cramer_t_safe, intersect_brute
from ray_tracer_tpu.ops.shade import (
    apply_shadow,
    hit_geometry_parallel,
    hit_geometry_serial,
    interpolate_normal,
    light_sample_offsets,
    shade_direct_parallel,
    shade_direct_serial,
    shade_parallel,
    shade_serial,
    vertex_normals,
)
from ray_tracer_tpu.accel.packed import (
    PackedGrid,
    PackedGridArrays,
    PackedGridMeta,
    pack_grid,
)
from ray_tracer_tpu.ops.traverse import traverse_grid
from ray_tracer_tpu.ops.traverse_packed import (
    PackedTraceResult,
    traverse_packed,
    traverse_packed_fused_shadow,
)


def shadow_rays_for(rcfg: RenderConfig, light_pos, poi, hit) -> RayBatch:
    """Shadow-ray batch toward light_pos from hit points `poi`, per the
    shared policy (direction quirk, mint); non-hit lanes get +inf
    origins so the traversal retires them on entry.  The ONE builder
    used by the renderer and render/metrics — deriving this in more
    than one place has produced parity drift before."""
    nsd = vm.normalize(light_pos - poi)
    sdir = -nsd if rcfg.shadow_dir_away_from_light() else nsd
    sorig = jnp.where(hit[:, None], poi, jnp.full_like(poi, jnp.inf))
    return RayBatch.make(sorig, sdir, mint=rcfg.shadow_mint())


def _persistent_as_packed(res) -> PackedTraceResult:
    """Adapt a persistent-wave trace result to the tiled march's result
    type (the production convention: any_pass == hit).  The ONE
    adaptation used by both the non-fused trav wrapper and the fused
    branch so the two persistent paths cannot desynchronize."""
    return PackedTraceResult(
        any_pass=res.hit, hit=res.hit, t=res.t,
        tri_id=res.tri_id, steps=res.steps,
    )


class Prepared(NamedTuple):
    scene: Scene
    grid: UniformGrid
    cfg: SceneConfig
    packed: "PackedGrid" = None  # built when cfg.render.traversal == "packed"


def prepare(cfg: SceneConfig, scene: Scene = None) -> Prepared:
    """Host-side setup: load meshes, build the grid (numpy / native C++).

    Geometry stays in host numpy through the whole build and is shipped
    to the device once, inside the Scene.
    """
    if scene is None:
        from ray_tracer_tpu.models.scenes import scene_from_numpy, scene_numpy_arrays

        verts_np, faces_np, fmat_np, uvs_np, uvf_np = scene_numpy_arrays(cfg)
        scene = scene_from_numpy(
            verts_np, faces_np, fmat_np, cfg.materials, cfg.light,
            uvs_np, uvf_np, extra_lights=cfg.extra_lights,
        )
    else:
        from ray_tracer_tpu.models.scenes import host_geometry

        verts_np, faces_np = host_geometry(scene)
        if cfg.extra_lights and scene.extra_light_pos is None:
            # cfg.extra_lights applies to provided scenes too (the CLI
            # scene-object path); a scene that already carries extra
            # lights wins over the config
            dt = scene.verts.dtype
            scene = scene._replace(
                extra_light_pos=jnp.asarray(
                    [l.position for l in cfg.extra_lights], dt
                ),
                extra_light_intensity=jnp.asarray(
                    [l.intensity for l in cfg.extra_lights], dt
                ),
            )
    grid = build_grid(
        verts_np,
        faces_np,
        resolution_multiplier=cfg.render.grid.resolution_multiplier,
        max_resolution=cfg.render.grid.max_resolution,
        exact_overlap=cfg.render.grid.exact_overlap,
    )
    packed = None
    if cfg.render.traversal == "packed":
        if cfg.render.faithful:
            raise ValueError("traversal='packed' requires faithful=False")
        bt = cfg.render.packed_block_tris
        if bt == 0:  # auto: measured density rule (see RenderConfig)
            bt = choose_block_tris(grid)
        layout = cfg.render.grid_layout
        if layout not in ("auto", "inline", "blocks"):
            raise ValueError(f"unknown grid_layout {layout!r}")
        inline = (layout == "inline"
                  or (layout == "auto" and choose_inline_layout(grid, bt)))
        packed = pack_grid(grid, verts_np, faces_np, block_tris=bt,
                           inline=inline, leap=cfg.render.grid.leap)
    return Prepared(scene=scene, grid=grid, cfg=cfg, packed=packed)


def choose_inline_layout(grid: UniformGrid, block_tris: int,
                         budget_bytes: int = 64 << 20) -> bool:
    """auto grid_layout rule.

    The inline (one-gather) layout won on the previous chip whenever its
    dense table stayed SMALL enough for gather locality; table size —
    not scene density — separated the scenes: spot's and the mirror
    scene's tables took inline, the dense stand-in's larger table did
    not.

    Rule: inline iff the dense first-row-per-cell table (empty cells
    included) fits budget_bytes.  The 64 MiB budget is carried over
    from the previous chip and is not yet tuned on the H100."""
    host = grid.host
    if host is None:
        return False  # table size unknown; keep the compact layout
    counts = np.diff(host.cell_start)
    nx, ny, nz = grid.meta.n_voxels
    n_cells = nx * ny * nz
    row_lanes = -(-(block_tris * 9 + 2) // 128) * 128
    rows = n_cells + int(
        np.maximum((counts + block_tris - 1) // block_tris - 1, 0).sum()
    )
    return rows * (row_lanes + block_tris) * 4 <= budget_bytes


def choose_block_tris(grid: UniformGrid) -> int:
    """Row-width policy: narrow 14-triangle/128-lane rows won when
    voxels are sparse (no tile tail to amortize under the persistent
    wave — spot at 8.5 tris/occupied voxel), wider rows when a single
    voxel's list spans many rows (nefertiti 24.8 -> 28, reflective
    scene 56.9 -> 56).  Rule: round the mean
    triangles-per-occupied-voxel up to the next row capacity."""
    host = grid.host
    if host is None:
        return 14
    counts = np.diff(host.cell_start)
    occ = int((counts > 0).sum())
    avg = float(counts.sum()) / max(occ, 1)
    for bt in (14, 28):
        if avg <= bt:
            return bt
    return 56


def make_traversal(rcfg: RenderConfig, grid, meta, v0, v1, v2):
    """The traversal-backend switch — the ONE place a renderer turns
    RenderConfig.traversal/scheduler into a trace callable, shared by
    render_rays and the path-tracing integrator (render/pathtrace.py).

    Returns trav(rb, t_gate, stop_on_first_hit=False, **kw) -> a result
    with .hit/.t/.tri_id fields; the persistent backend additionally
    accepts camera= (zero-gather pixel-index refill) and compact=
    (pre-filtered work queue for mostly-dead batches)."""
    faithful = rcfg.faithful
    if rcfg.traversal == "packed":
        assert not faithful, "packed traversal has production semantics only"
        if rcfg.scheduler == "persistent":
            from ray_tracer_tpu.ops.persistent import persistent_trace

            def trav(rb, t_gate, stop_on_first_hit=False, camera=None,
                     compact=False, order_keys=None):
                res = persistent_trace(
                    rb, grid, meta, wave=rcfg.wave, pump=rcfg.pump,
                    probe_chain=1 if meta.inline else rcfg.probe_chain,
                    t_gate=0.0 if t_gate is None else t_gate,
                    stop_on_first_hit=stop_on_first_hit,
                    need_t=False,  # t is recomputed from tri_id by callers
                    camera=camera, spp=rcfg.spp if camera is not None else 1,
                    compact=compact, order_keys=order_keys,
                    refill_retries=rcfg.refill_retries,
                )
                return _persistent_as_packed(res)
        else:

            def trav(rb, t_gate, stop_on_first_hit=False):
                return traverse_packed(
                    rb, grid, meta,
                    t_gate=0.0 if t_gate is None else t_gate,
                    stop_on_first_hit=stop_on_first_hit,
                    unroll=rcfg.packed_unroll,
                    probe_chain=1 if meta.inline else rcfg.probe_chain,
                )
    elif rcfg.traversal == "brute":
        # The reference's naive O(N) integrator kept in-tree as an A/B
        # cross-check for the accelerated path (Serial/raytracer.cpp:21-69
        # call commented at :171; Parallel/raytracer.cu:372-443).  Gate
        # and eps regimes match the CSR walk, but the sweep tests EVERY
        # triangle while the grid tests only voxels a forward walk
        # visits: under the faithful serial regime (unrestricted t,
        # Serial/geometry.h:164-171) the sweep can accept behind-origin
        # hits on geometry the walk never reaches.  The A/B images agree
        # exactly iff all geometry lies in the walked frustum — true of
        # the reference scenes; pinned (both ways) by
        # tests/test_metrics_and_parity.py.
        sg = tuple(jax.lax.stop_gradient(x) for x in (v0, v1, v2))

        def trav(rb, t_gate, stop_on_first_hit=False):
            return intersect_brute(
                rb, *sg, t_lower=t_gate, det_dtype=jnp.dtype(rcfg.det_dtype)
            )
    else:
        trav = partial(
            traverse_grid,
            grid=grid,
            meta=meta,
            v0=jax.lax.stop_gradient(v0),
            v1=jax.lax.stop_gradient(v1),
            v2=jax.lax.stop_gradient(v2),
            det_dtype=rcfg.det_dtype,
            early_exit=not faithful,
        )
    return trav


def render_rays(
    rays: RayBatch,
    scene: Scene,
    grid: GridArrays,
    meta: GridMeta,
    rcfg: RenderConfig,
    camera_cfg=None,
) -> jnp.ndarray:
    """Trace + shade one ray batch -> (R,3) linear color.

    Differentiable w.r.t. scene.verts / materials / light: the traversal
    emits integer hit topology (a stop-gradient island by construction),
    and t / normals / shading are recomputed from the gathered vertices
    so gradients flow through the arithmetic, not the search.
    """
    serial = rcfg.serial_shading
    faithful = rcfg.faithful
    eps = rcfg.shadow_eps
    smooth = rcfg.normal_mode == "smooth"
    soft_shadows = rcfg.shadow_samples > 1 and rcfg.light_radius > 0.0
    if faithful and (smooth or soft_shadows
                     or scene.env_image is not None):
        raise ValueError(
            "smooth normals / area-light soft shadows / environment "
            "maps require faithful=False"
        )
    v0, v1, v2 = scene.triangle_soa()
    # ONE packed (F,9) row per triangle: per-hit vertex resolution then
    # costs one row gather instead of three.  Values are the same floats, so
    # the image stays bit-identical; gradients flow through the
    # concatenate's split transpose into verts exactly as before.
    # the material index rides lane 9 of the same row (exact int<->f32
    # roundtrip for any sane material count), saving the separate (R,)
    # face_material gather
    tri9 = jnp.concatenate(
        [v0, v1, v2,
         scene.face_material.astype(v0.dtype)[:, None]], axis=1
    )
    background = jnp.asarray(rcfg.background, v0.dtype)

    # Hit/shadow policy comes from ONE place (RenderConfig.primary_gate
    # and friends) so this renderer, render/debug.trace_pixel, and
    # render/metrics can never disagree on gates or mints again.
    primary_gate = rcfg.primary_gate()
    early = not faithful

    trav = make_traversal(rcfg, grid, meta, v0, v1, v2)

    r = rays.count
    cur = rays
    inf3 = jnp.full((r, 3), jnp.inf, v0.dtype)
    locals_ = []  # per-depth (local color, continuation weight km*reflecting)
    # Smooth shading normals: one area-weighted vertex-normal table per
    # render, recomputed from the DIFFERENTIABLE verts (so vertex
    # gradients flow through the interpolated normal into the shading).
    vn = vertex_normals(scene.verts, scene.faces, serial) if smooth else None

    # the fused march computes ONE shadow ray (toward the light center),
    # so area-light sampling forces the standalone shadow path
    fused = rcfg.traversal == "packed" and rcfg.fused_shadow and not soft_shadows

    for depth in range(rcfg.max_bounces + 1):
        # The traversal is a stop-gradient island (its while_loop is not
        # reverse-differentiable and must not be): search on detached
        # rays, then recompute t/geometry differentiably from the found
        # topology below.  Matters from bounce 1 on, where `cur` derives
        # from differentiable hit points.
        #
        # Bounce depths gate t >= eps (rcfg.bounce_gate — part of the
        # shared hit/shadow policy in RenderConfig, not derived here).
        gate_d = primary_gate if depth == 0 else rcfg.bounce_gate()
        # Difficulty-ordered queue for the depth-0 batch (bounce
        # batches keep the cheaper compact cumsum — they are mostly
        # dead, so the fifo tail is short).
        okeys = None
        if (depth == 0 and rcfg.queue_order == "chord"
                and rcfg.scheduler == "persistent"
                and rcfg.traversal == "packed"):
            from ray_tracer_tpu.ops.traverse_packed import chord_keys

            okeys = chord_keys(jax.lax.stop_gradient(cur), grid)
        fres = None
        if fused and (depth == 0 or rcfg.scheduler == "persistent"):
            # one march for primary + shadow: lanes rearm as their own
            # shadow ray the moment the primary retires (wavefront
            # pipelining; ops/traverse_packed.traverse_packed_fused_shadow
            # or its persistent-wave counterpart).  The persistent wave
            # fuses at EVERY bounce depth — halves the per-depth trace
            # count on reflective scenes; the tiled fused march serves
            # depth 0 only (its entry sort keys on the primary ray).
            fkw = dict(
                shadow_gate=eps,
                shadow_mint=rcfg.shadow_mint(),
                serial_quirk=rcfg.shadow_dir_away_from_light(),
            )
            if rcfg.scheduler == "persistent":
                from ray_tracer_tpu.ops.persistent import persistent_trace

                fres = persistent_trace(
                    jax.lax.stop_gradient(cur), grid, meta,
                    jax.lax.stop_gradient(scene.light_pos),
                    wave=rcfg.wave, pump=rcfg.pump, fuse_shadow=True,
                    probe_chain=1 if meta.inline else rcfg.probe_chain,
                    need_t=False,  # t is recomputed from tri_id below
                    # zero-direct hits (n.l<=0 and n.h<=0 under the
                    # facet normal) retire without marching their
                    # shadow ray — bit-identical image; valid ONLY for
                    # the serial shading variant (ambient is added
                    # AFTER the shadow scale, raytracer.cpp:102-117 —
                    # the parallel variant shadows ambient too,
                    # raytracer.cu:492-506, so occlusion always shows).
                    # Off whenever anything consumes true occlusion
                    # beyond shading (soft visibility's blocker id) or
                    # shades with a non-facet normal (smooth
                    # interpolation flips the sign test).
                    shadow_skip_dead=(serial
                                      and rcfg.soft_visibility <= 0.0
                                      and rcfg.normal_mode == "face"),
                    shade_serial=serial,
                    t_gate=0.0 if gate_d is None else gate_d,
                    # blocker identity costs an extra scatter/iteration;
                    # only soft visibility consumes it
                    need_shadow_tri=rcfg.soft_visibility > 0.0,
                    # depth-0 rays regenerate from the camera at refill
                    # (unless the scene-measured policy picked the
                    # gather path — RenderConfig.camera_refill)
                    camera=(camera_cfg if depth == 0
                            and rcfg.camera_refill != "off" else None),
                    spp=rcfg.spp if (camera_cfg is not None and depth == 0)
                    else 1,
                    # queue compaction pays only on provably mostly-dead
                    # batches (bounce segments); on full primaries the
                    # O(R) prefilter cost more than the pop savings on
                    # BOTH refill sources on the previous chip (dead pops
                    # only shorten the queue drain, not the
                    # straggler-bound tail)
                    compact=depth > 0,
                    order_keys=okeys,
                    refill_retries=rcfg.refill_retries,
                    **fkw,
                )
            else:
                fres = traverse_packed_fused_shadow(
                    jax.lax.stop_gradient(cur), grid, meta,
                    jax.lax.stop_gradient(scene.light_pos),
                    primary_gate=0.0 if primary_gate is None else primary_gate,
                    **fkw,
                )
            res = _persistent_as_packed(fres)
        else:
            tkw = {}
            if rcfg.scheduler == "persistent" and rcfg.traversal == "packed":
                if (depth == 0 and camera_cfg is not None
                        and rcfg.camera_refill != "off"):
                    tkw["camera"] = camera_cfg
                tkw["compact"] = depth > 0  # bounce batches are mostly dead
                if okeys is not None:
                    tkw["order_keys"] = okeys
            res = trav(jax.lax.stop_gradient(cur), t_gate=gate_d, **tkw)
        hit = rcfg.accepted_hit(res)
        tri = jnp.maximum(res.tri_id, 0)

        tv = tri9[tri]
        tv0, tv1, tv2 = tv[:, 0:3], tv[:, 3:6], tv[:, 6:9]
        # Recompute the hit distance from the (stop-gradient) hit topology
        # with the differentiable gathered vertices.  Forward value is
        # bit-identical to the traversal's recorded t (same Cramer
        # arithmetic in the same det dtype, Serial/geometry.h:131-171),
        # but gradients now flow through t into poi and shading.  The
        # determinant is guarded on MISSED lanes (whose gathered triangle
        # is arbitrary and may be ray-parallel, A == 0): inf/A in the
        # residual would poison the backward pass via inf * 0 = nan.
        ddt = jnp.dtype(rcfg.det_dtype)
        t_re = cramer_t_safe(cur.orig, cur.dirn, tv0, tv1, tv2, res.hit, det_dtype=ddt)
        # Miss lanes get t = 0 rather than the traversal's +inf: their
        # geometry is discarded by the `hit` selects, but inf would ride
        # into poi = orig + dirn*t, whose transpose multiplies the zero
        # cotangent by t — inf * 0 = nan in the dirn (hence vertex)
        # gradients from bounce 1 on.
        t = jnp.where(res.hit, t_re.astype(res.t.dtype), jnp.zeros_like(res.t))
        mat = scene.materials.gather(tv[:, 9].astype(jnp.int32))

        # hit barycentrics, shared by texture sampling and smooth
        # normals; cramer_bg_safe sanitizes invalid lanes internally
        hb = hg = None
        if smooth or (rcfg.texture != "none" and scene.uvs is not None):
            hb, hg = cramer_bg_safe(
                cur.orig, cur.dirn, tv0, tv1, tv2, res.hit, det_dtype=ddt,
            )

        if rcfg.texture != "none" and scene.uvs is not None:
            # Sample the carried vt data (the reference stores it per
            # triangle but never reads it, Serial/raytracer.cpp:252-283):
            # barycentric uv at the hit -> texture modulating base_color.
            # Differentiable in the vertices through beta/gamma (and, for
            # "image", in the texel grid through the bilinear gathers).
            uv = scene.interpolate_uv(tri, hb.astype(v0.dtype), hg.astype(v0.dtype))
            has_uv = scene.uv_faces[tri][:, 0] >= 0
            # texture_scale = repeat count across the unit uv square
            # (wrap sampling); dead lanes' uv is masked inside the ONE
            # shared factor expression (models/scenes.texture_factor)
            from ray_tracer_tpu.models.scenes import texture_factor

            tex = texture_factor(uv, has_uv, hit, rcfg.texture,
                                 rcfg.texture_scale, scene.texture_image,
                                 mat.base_color.dtype)
            mat = mat._replace(base_color=mat.base_color * tex.astype(mat.base_color.dtype))

        # Retired bounce lanes carry inf origins; sanitize BEFORE any
        # arithmetic so no inf/nan residual exists for the backward pass
        # to multiply with a zero cotangent (inf * 0 = nan).  Hit lanes
        # are untouched — forward image is bit-identical.
        orig_safe = jnp.where(res.hit[:, None], cur.orig, jnp.zeros_like(cur.orig))
        if serial:
            geom = hit_geometry_serial(orig_safe, cur.dirn, t, tv0, tv1, tv2)
        else:
            geom = hit_geometry_parallel(orig_safe, cur.dirn, t, tv0, tv1, tv2)
        geom = geom._replace(
            poi=jnp.where(hit[:, None], geom.poi, jnp.zeros_like(geom.poi))
        )
        if smooth:
            # Phong normal interpolation on the stop-gradient hit
            # topology; shading AND the reflection bounce below follow
            # the smooth DIRECTION, rescaled to the facet normal's own
            # magnitude (the variants' shading constants are tuned to
            # area-scaled normals — see interpolate_normal)
            unit = interpolate_normal(
                vn, scene.faces, tri, hb.astype(v0.dtype), hg.astype(v0.dtype)
            )
            geom = geom._replace(
                normal=unit * vm.length(geom.normal)[:, None]
            )

        # Shadow rays (direction quirk + mint from the shared policy).
        skw = {}
        if rcfg.scheduler == "persistent" and rcfg.traversal == "packed":
            # bounce-depth shadow batches are mostly dead (only
            # reflecting lanes have finite origins) — same compaction
            # rule as the primary trace above.  Area-light sample
            # batches are mostly dead at EVERY depth (only hit lanes
            # shoot, times shadow_sample_batch), and uncompacted they
            # pay a pop-round per dead lane (a regression on the batched
            # 8-sample penumbra without compaction, a gain with it)
            skw["compact"] = depth > 0 or soft_shadows

        def shadow_rays_toward(light_point):
            # detached: the traversal is a stop-gradient island
            return jax.tree.map(
                jax.lax.stop_gradient,
                shadow_rays_for(rcfg, light_point, geom.poi, hit),
            )

        def soften(srays, occ, shadow_tri, shadow_hit_rec):
            """SURVEY hard part #2: hard occlusion has zero-measure
            gradients.  Recompute the recorded blocker's barycentric
            margin from the DIFFERENTIABLE vertices and squash it:
            f = sigmoid(margin / s) -> 1 deep inside the blocker,
            0.5 at its silhouette — gradients pull blocker edges
            across shadow boundaries.  (One-sided: shadow rays that
            missed entirely contribute f = 0.)"""
            if rcfg.soft_visibility <= 0.0:
                return occ
            stri = jnp.maximum(shadow_tri, 0)
            stv = tri9[stri]
            sbeta, sgamma = cramer_bg_safe(
                srays.orig, srays.dirn, stv[:, 0:3], stv[:, 3:6], stv[:, 6:9],
                shadow_hit_rec, det_dtype=ddt,
            )
            margin = jnp.minimum(
                jnp.minimum(sbeta, sgamma), 1.0 - sbeta - sgamma
            ).astype(jnp.float32)
            f = jax.nn.sigmoid(margin / rcfg.soft_visibility)
            return jnp.where(occ, f, 0.0)

        def occlusion_toward(lp):
            """[0,1] occlusion factor toward light position lp: one
            hard shadow ray, or — with area-light soft shadows on —
            the mean over the fixed Fibonacci sample set (a float
            penumbra factor apply_shadow blends continuously).  Used
            by the primary light's standalone path AND every extra
            light, so the penumbra treatment cannot diverge between
            them."""
            if soft_shadows:
                # Up to shadow_sample_batch samples' rays ride ONE
                # traversal (the gi_sample_batch trick): lanes are
                # (sample, ray)-independent and each sample's occlusion
                # is softened/accumulated in the same sequential order
                # either way, so the image is bitwise-invariant in the
                # batch size.  A negative on the previous chip at
                # production shapes — default batch is 1; the knob and
                # the invariance tests stay for reproduction.
                offs = light_sample_offsets(rcfg.shadow_samples,
                                            rcfg.light_radius)
                S = rcfg.shadow_samples
                B = max(1, min(rcfg.shadow_sample_batch, S))
                occ = jnp.zeros((r,), jnp.float32)
                for s0 in range(0, S, B):
                    batches = [
                        shadow_rays_toward(lp + jnp.asarray(off, v0.dtype))
                        for off in offs[s0:s0 + B]
                    ]
                    nb = len(batches)
                    srays_all = batches[0] if nb == 1 else jax.tree.map(
                        lambda *xs: jnp.concatenate(xs, axis=0), *batches
                    )
                    sres = trav(srays_all, t_gate=eps,
                                stop_on_first_hit=early, **skw)
                    for j in range(nb):  # sequential, batch-invariant
                        sres_j = jax.tree.map(
                            lambda x: x[j * r:(j + 1) * r], sres
                        )
                        occ = occ + soften(
                            batches[j], rcfg.accepted_hit(sres_j) & hit,
                            sres_j.tri_id, sres_j.hit,
                        ).astype(jnp.float32)
                return occ / S
            srays = shadow_rays_toward(lp)
            sres = trav(srays, t_gate=eps, stop_on_first_hit=early, **skw)
            return soften(srays, rcfg.accepted_hit(sres) & hit,
                          sres.tri_id, sres.hit)

        if fres is not None:
            in_shadow = soften(shadow_rays_toward(scene.light_pos),
                               fres.in_shadow & hit,
                               fres.shadow_tri_id, fres.in_shadow)
        else:
            in_shadow = occlusion_toward(scene.light_pos)

        if serial:
            color = shade_serial(
                geom, mat, scene.light_pos, scene.light_intensity,
                in_shadow, rcfg.shadow_scale,
            )
        else:
            color = shade_parallel(
                geom, mat, scene.light_pos, in_shadow, rcfg.shadow_scale
            )

        if scene.extra_light_pos is not None:
            # Additional point lights (SceneConfig.extra_lights): each
            # adds its own shadow-tested diffuse+specular term; ambient
            # already rode the primary term above, exactly once.  The
            # loop is static (L is a shape); shadow direction/mint and
            # the soft-shadow/penumbra treatment follow the SAME shared
            # policy as the primary light's shadow (occlusion_toward).
            for i in range(scene.extra_light_pos.shape[0]):
                lp = scene.extra_light_pos[i]
                li = scene.extra_light_intensity[i]
                occ_i = occlusion_toward(lp)
                if serial:
                    direct = shade_direct_serial(geom, mat, lp, li)
                else:
                    direct = shade_direct_parallel(geom, mat, lp) * li
                color = color + apply_shadow(direct, occ_i,
                                              rcfg.shadow_scale)

        if scene.env_image is not None:
            # miss lanes look up the lat-long environment by THIS
            # depth's ray direction (bounce misses see the reflected
            # sky); dead lanes have finite dirs, the lookup is safe
            bg = scene.sample_env(vm.normalize(cur.dirn)).astype(color.dtype)
        else:
            bg = background

        if rcfg.soft_primary > 0.0:
            # Primary-silhouette softening (SURVEY §7.9): recompute the
            # hit's barycentric margin from the DIFFERENTIABLE vertices
            # and fade the surface color into the background with
            # tanh(margin/s).  tanh (not sigmoid) so the blend is 0
            # exactly at the silhouette: a pixel crossing from hit to
            # miss changes continuously, which is what makes vertex
            # gradients across silhouettes finite-difference-correct.
            if hb is None:
                # cramer_bg_safe sanitizes invalid lanes itself, so
                # these are bitwise-identical to the shared hb/hg the
                # texture/smooth paths computed from cur.orig
                hb, hg = cramer_bg_safe(
                    orig_safe, cur.dirn, tv0, tv1, tv2, res.hit,
                    det_dtype=ddt,
                )
            hbeta, hgamma = hb, hg
            hmargin = jnp.maximum(
                jnp.minimum(jnp.minimum(hbeta, hgamma), 1.0 - hbeta - hgamma),
                0.0,
            ).astype(color.dtype)
            fh = jnp.tanh(hmargin / rcfg.soft_primary)[:, None]
            color = fh * color + (1.0 - fh) * bg

        reflecting = hit & mat.reflective & (depth < rcfg.max_bounces)
        # Reflective surfaces blend their local color with the bounced
        # color: local*base*(1-km) + bounced*km (raytracer.cu:519-520).
        local = jnp.where(
            reflecting[:, None],
            color * mat.base_color * (1.0 - mat.km)[:, None],
            jnp.where(hit[:, None], color, bg),
        )
        locals_.append((local, jnp.where(reflecting, mat.km, 0.0)[:, None]))
        if depth == rcfg.max_bounces:
            break

        rdir = vm.normalize(
            vm.reflect(vm.normalize(cur.dirn), vm.normalize(geom.normal))
        )
        rorig = jnp.where(reflecting[:, None], geom.poi, inf3)
        cur = RayBatch.make(rorig, rdir, mint=eps)

    # Fold depths deepest-first so the blend associates exactly like the
    # reference's recursion (fast_trace at raytracer.cu:508-520):
    # color_d = local_d + km_d * color_{d+1}.
    result = locals_[-1][0]
    for local, km in reversed(locals_[:-1]):
        result = local + km * result
    return result


def _pad_to(n: int, tile: int) -> int:
    return ((n + tile - 1) // tile) * tile


def pad_rays(rays: RayBatch, padded: int) -> RayBatch:
    """Pad a ray batch with +inf-origin rays; the grid slab test kills the
    padding lanes on entry so they cost one while_loop evaluation."""
    r = rays.count
    if padded == r:
        return rays
    pad = padded - r
    return RayBatch(
        orig=jnp.concatenate([rays.orig, jnp.full((pad, 3), jnp.inf, rays.orig.dtype)]),
        dirn=jnp.concatenate([rays.dirn, jnp.ones((pad, 3), rays.dirn.dtype)]),
        mint=jnp.concatenate([rays.mint, jnp.zeros((pad,), rays.mint.dtype)]),
        maxt=jnp.concatenate([rays.maxt, jnp.zeros((pad,), rays.maxt.dtype)]),
    )


def render_rays_tiled(
    rays: RayBatch,
    scene: Scene,
    grid: GridArrays,
    meta: GridMeta,
    rcfg: RenderConfig,
) -> jnp.ndarray:
    """Pad to a tile multiple and trace tile-by-tile via `lax.map`.

    Returns (R, 3) colors for the original R rays.  Shared by the
    single-chip renderer and each shard of the sharded renderer.
    """
    r = rays.count
    tile = min(rcfg.ray_tile, r)
    padded = _pad_to(r, tile)
    rays = pad_rays(rays, padded)
    tiled = jax.tree.map(lambda x: x.reshape((padded // tile, tile) + x.shape[1:]), rays)
    colors = jax.lax.map(lambda rb: render_rays(rb, scene, grid, meta, rcfg), tiled)
    return colors.reshape(padded, 3)[:r]


def entry_sort_keys(rays: RayBatch, lower, upper, inv_width, n_voxels) -> jnp.ndarray:
    """Sort key for wavefront compaction: rays that miss the grid AABB go
    LAST (key = big), the rest sort by their entry-voxel linear index so
    spatially coherent rays share a tile.  A lock-step SIMD wave pays for
    its slowest lane; sorting concentrates the work so empty-sky tiles
    retire after one while_loop evaluation — the dense counterpart of the
    reference's ray-gen frustum cull (Parallel/raytracer.cu:154-173).

    Uses the traversal's own _slab_entry so the sort key cannot disagree
    with the march's entered test (incl. its boundary-plane NaN fix)."""
    from types import SimpleNamespace

    from ray_tracer_tpu.ops.traverse_packed import _slab_entry

    nvox = jnp.asarray(n_voxels, jnp.int32)
    # f32 like traverse_packed's own coercion (its path is f32 by
    # contract): under x64 an f64 slab interval here could classify a
    # grazing ray as entering while the march's f32 test rejects it
    o = rays.orig.astype(jnp.float32)
    d = rays.dirn.astype(jnp.float32)
    t0, entered = _slab_entry(
        SimpleNamespace(lower=lower, upper=upper),
        o, d, rays.mint.astype(jnp.float32), rays.maxt.astype(jnp.float32),
    )
    p = o + d * t0[:, None]
    cell = jnp.clip(
        jnp.floor((p - lower) * inv_width).astype(jnp.int32), 0, nvox - 1
    )
    nx, ny, _ = n_voxels
    lin = cell[:, 2] * (nx * ny) + cell[:, 1] * nx + cell[:, 0]
    return jnp.where(entered, lin, jnp.iinfo(jnp.int32).max)


def render_rays_tiled_sorted(
    rays: RayBatch,
    scene: Scene,
    grid: PackedGridArrays,
    meta: PackedGridMeta,
    rcfg: RenderConfig,
) -> jnp.ndarray:
    """Entry-sorted, tiled render for the packed production path."""
    r = rays.count
    key = entry_sort_keys(rays, grid.lower, grid.upper, grid.inv_width, meta.n_voxels)
    order = jnp.argsort(key)
    inv_order = jnp.argsort(order)
    sorted_rays = jax.tree.map(lambda x: x[order], rays)
    colors = render_rays_tiled(sorted_rays, scene, grid, meta, rcfg)
    return colors[inv_order]


def accumulate_spp(one, camera_cfg, spp: int, dtype) -> jnp.ndarray:
    """Sequential spp-subsample accumulation -> (R, 3) colors, one
    subsample batch at a time (O(H*W) memory instead of materializing
    all spp^2 * H * W rays at once).  The ONE implementation shared by
    `_render_image` and the sharded image fn so their accumulation
    order — which the sharded-equals-single bit-equality tests depend
    on — cannot diverge.  `one(rays, camera_ok)` traces a batch;
    camera_ok is True only for the full pixel-center batch in natural
    order (the persistent wave's zero-gather camera-refill contract)."""
    if spp == 1:
        return one(camera_rays(camera_cfg, dtype=dtype), True)
    from ray_tracer_tpu.ops.camera import camera_rays_subsample

    total = spp * spp
    acc = None
    for s in range(total):
        c = one(camera_rays_subsample(camera_cfg, s, spp, dtype=dtype), False)
        acc = c if acc is None else acc + c
    return acc / total


@partial(jax.jit, static_argnames=("meta", "cfg"))
def _render_image(scene: Scene, grid, meta, cfg: SceneConfig):
    rcfg = cfg.render

    def one(rays, camera_ok):
        if rcfg.traversal == "packed":
            if rcfg.scheduler == "persistent":
                # no sort, no tiles: the persistent wave IS the scheduler
                return render_rays(
                    rays, scene, grid, meta, rcfg,
                    camera_cfg=cfg.camera if camera_ok else None,
                )
            return render_rays_tiled_sorted(rays, scene, grid, meta, rcfg)
        return render_rays_tiled(rays, scene, grid, meta, rcfg)

    colors = accumulate_spp(one, cfg.camera, rcfg.spp, jnp.dtype(rcfg.dtype))
    return colors.reshape(cfg.camera.height, cfg.camera.width, 3)


def whitted_wave_eligible(prep: Prepared) -> bool:
    """Can this forward render take the cross-depth Whitted wave
    (ops/whitted_wave.py)?  Same opt-in contract as the GI wave:
    RenderConfig.whitted_wave "auto" | "on" (error if ineligible) |
    "off" (default)."""
    cfg = prep.cfg
    rcfg = cfg.render
    scene = prep.scene
    knob = rcfg.whitted_wave
    if knob == "off":
        return False
    ok = (
        rcfg.gi_samples == 0
        and rcfg.traversal == "packed"
        and rcfg.scheduler == "persistent"
        and not rcfg.faithful
        and rcfg.det_dtype == "float32"
        and jnp.dtype(rcfg.dtype) == jnp.dtype(jnp.float32)
        and rcfg.normal_mode != "smooth"
        and (rcfg.texture == "none" or scene.uvs is None)
        and scene.env_image is None
        and scene.extra_light_pos is None
        and rcfg.soft_visibility <= 0.0
        and rcfg.soft_primary <= 0.0
        and not (rcfg.shadow_samples > 1 and rcfg.light_radius > 0)
        # thin-lens DoF rides spp (camera_ray_at regenerates the lens
        # offsets per subsample, bitwise == camera_rays)
        and not (cfg.camera.aperture > 0.0 and rcfg.spp <= 1)
    )
    if knob == "on" and not ok:
        raise ValueError(
            "whitted_wave='on' but the configuration is ineligible "
            "(needs packed+persistent forward, one point light, "
            "face normals, no texture/env/extra lights, no softening, "
            "float32 dets)"
        )
    return ok


def _render_whitted_wave(prep: Prepared) -> jnp.ndarray:
    from ray_tracer_tpu.ops.whitted_wave import (
        build_wave_tables,
        whitted_wave_trace,
    )

    cfg = prep.cfg
    rcfg = cfg.render
    scene = prep.scene
    mat9, tri9 = build_wave_tables(scene)
    pg = rcfg.primary_gate()
    col = whitted_wave_trace(
        scene.light_pos, scene.light_intensity, mat9, tri9,
        prep.packed.arrays, prep.packed.meta,
        camera=cfg.camera, max_bounces=rcfg.max_bounces,
        serial=rcfg.serial_shading, spp=rcfg.spp,
        wave=rcfg.wave, pump=rcfg.pump,
        gate0=0.0 if pg is None else pg, gate_b=rcfg.bounce_gate(),
        eps=rcfg.shadow_eps, smint=rcfg.shadow_mint(),
        quirk=rcfg.shadow_dir_away_from_light(),
        shadow_scale=rcfg.shadow_scale, bg=tuple(rcfg.background),
        refill_retries=(3 if rcfg.refill_retries is None
                        else rcfg.refill_retries),
    )
    return col.reshape(cfg.camera.height, cfg.camera.width, 3)


def render(prep: Prepared) -> jnp.ndarray:
    """Render the prepared scene -> (H, W, 3) float32 linear color.

    gi_samples > 0 switches to the path-traced global-illumination
    integrator (render/pathtrace.py) over the same traversal backend;
    eligible forward renders with whitted_wave on take the cross-depth
    persistent wave (ops/whitted_wave.py, forward-only)."""
    if prep.cfg.render.gi_samples > 0:
        from ray_tracer_tpu.render.pathtrace import render_pt

        return render_pt(prep)
    if prep.scene.transmissive is not None:
        raise NotImplementedError(
            "transmissive (dielectric) materials are served by the "
            "path-traced integrator only — set render.gi_samples > 0 "
            "(the Whitted recursion has no refraction branch, matching "
            "the reference's mirror-only materials)"
        )
    if whitted_wave_eligible(prep):
        return _render_whitted_wave(prep)
    if prep.cfg.render.traversal == "packed":
        return _render_image(
            prep.scene, prep.packed.arrays, prep.packed.meta, prep.cfg
        )
    return _render_image(prep.scene, prep.grid.arrays, prep.grid.meta, prep.cfg)
