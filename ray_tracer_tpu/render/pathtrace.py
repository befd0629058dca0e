"""Path-traced global illumination on the wavefront traversal.

A production feature with no reference counterpart: the reference's
integrators are Whitted-style (direct Blinn-Phong + mirror recursion,
Serial/raytracer.cpp:71-118, Parallel/raytracer.cu:445-524).  This
module reuses the SAME traversal backends (renderer.make_traversal —
the persistent wave on the packed grid in production) to estimate the
rendering equation for Lambertian and mirror surfaces:

  * albedo = base_color / 255 clamped to [0, 1) — the reference's
    0-255 color convention mapped to a physical reflectance; with a
    texture configured the sampled texel modulates base_color BEFORE
    the clamp, exactly as the Whitted epilogue's `base_color * tex`
    (the reference's carried-but-unread vt data,
    Serial/raytracer.cpp:251-257);
  * cosine-weighted hemisphere importance sampling, so the BRDF x cos
    / pdf weight collapses to the albedo exactly (zero-variance for
    constant environments — see the furnace test);
  * next-event estimation: every path vertex sends one shadow ray to
    each point light (primary + extra lights), accumulating
    albedo/pi * I * cos / r^2 * visibility — point lights are
    delta lights, unreachable by BSDF sampling, so there is no
    double counting with the escape term;
  * escape radiance: a ray that misses the scene picks up the lat-long
    environment map (Scene.env_image) or the flat background color;
  * `reflective` materials (the CUDA variant's mirror palette) bounce
    as a Lambertian/mirror MIX: a deterministic hash draw takes the
    mirror branch with probability km, each branch weighted by its
    differentiable km factor over the stop-gradient selection
    probability (unbiased, exact d/d km) — the stochastic form of the
    Whitted `color·base·(1-km) + recurse·km` blend
    (config.RenderConfig.gi_specular).

Sampling is DETERMINISTIC: direction samples come from an integer hash
of (ray index, sample index, bounce depth) — no RNG state, no seed
plumbing, identical images across runs, tiles, shards and schedulers,
matching the repo-wide no-RNG-in-the-render-path convention (the same
policy as the Fibonacci area-light sampler).

Differentiability follows the repo's topology/arithmetic split: the
traversal and the sampled directions are stop-gradient (the search and
the estimator's sampling decisions are discrete/measure-zero), while
hit distances, normals, albedos and light terms are recomputed from
the differentiable scene leaves — base_color / light gradients flow
through every bounce (d radiance / d albedo is exact; vertex gradients
flow through the NEE geometry terms).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ray_tracer_tpu.config import SceneConfig
from ray_tracer_tpu.core import vecmath as vm
from ray_tracer_tpu.core.rays import RayBatch
from ray_tracer_tpu.models.scenes import Scene
from ray_tracer_tpu.ops.camera import camera_rays
from ray_tracer_tpu.ops.intersect import cramer_t_safe
from ray_tracer_tpu.ops.intersect import cramer_bg_safe
from ray_tracer_tpu.ops.shade import interpolate_normal, vertex_normals
from ray_tracer_tpu.render.renderer import make_traversal, shadow_rays_for

_INV_PI = 0.3183098861837907


def _hash_u01(x: jnp.ndarray, salt) -> jnp.ndarray:
    """lowbias32 integer hash -> f32 in [0, 1).  Deterministic, stateless,
    vectorized — the whole sampler.  `salt` may be a Python int OR a
    traced uint32 array (the GI wave carries the depth in its loop
    state); uint32 arithmetic wraps identically either way, so the two
    forms agree bit for bit — the ONE definition both integrators use
    (parity would silently break if they diverged)."""
    if not isinstance(salt, jnp.ndarray):
        salt = jnp.uint32(salt & 0xFFFFFFFF)
    x = (x.astype(jnp.uint32) + salt.astype(jnp.uint32)) ^ jnp.uint32(
        0x9E3779B9
    )
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return (x >> 8).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))


def ray_sample_keys(orig: jnp.ndarray, dirn: jnp.ndarray) -> jnp.ndarray:
    """Per-ray sample key: hash of the ray's OWN bits, so a ray keeps
    its sample sequence under any padding, permutation or sharding —
    the ONE key definition shared by the segment integrator and the GI
    wave (ops/gi_wave.py)."""
    def _bits(x):
        return jax.lax.bitcast_convert_type(
            jax.lax.stop_gradient(x.astype(jnp.float32)), jnp.uint32
        )

    ob, db = _bits(orig), _bits(dirn)
    return (
        db[:, 0] * jnp.uint32(0x85EBCA6B)
        ^ db[:, 1] * jnp.uint32(0xC2B2AE35)
        ^ db[:, 2] * jnp.uint32(0x27D4EB2F)
        ^ ob[:, 0] * jnp.uint32(0x165667B1)
        ^ ob[:, 1] * jnp.uint32(0x9E3779B1)
        ^ ob[:, 2] * jnp.uint32(0xFC0589B5)
    )


def _onb(n: jnp.ndarray):
    """Branchless orthonormal basis around unit normals (R,3) — Duff et
    al. 2017 (public construction).  Returns (b1, b2)."""
    s = jnp.where(n[:, 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    b1 = jnp.stack(
        [1.0 + s * n[:, 0] * n[:, 0] * a, s * b, -s * n[:, 0]], axis=-1
    )
    b2 = jnp.stack([b, s + n[:, 1] * n[:, 1] * a, -n[:, 1]], axis=-1)
    return b1, b2


def _cosine_sample(n: jnp.ndarray, u1: jnp.ndarray, u2: jnp.ndarray):
    """Cosine-weighted hemisphere directions around unit normals n."""
    b1, b2 = _onb(n)
    r = jnp.sqrt(u1)
    phi = (2.0 * jnp.pi) * u2
    x = r * jnp.cos(phi)
    y = r * jnp.sin(phi)
    z = jnp.sqrt(jnp.maximum(1.0 - u1, 0.0))
    return x[:, None] * b1 + y[:, None] * b2 + z[:, None] * n


def fresnel_refract(d_unit: jnp.ndarray, n: jnp.ndarray,
                    entering: jnp.ndarray, ior: jnp.ndarray):
    """Exact (unpolarized) Fresnel dielectric response at a surface.

    `d_unit`: (R,3) unit incident directions; `n`: (R,3) unit normals
    ORIENTED AGAINST the ray (n·d <= 0 — the integrator's double-sided
    flip guarantees this); `entering`: (R,) True where the ray meets
    the front face (outside medium is vacuum/air, n1 = 1); `ior`:
    (R,) per-lane index of refraction of the glass.

    Returns (F, refl_dir, refr_dir):
      * F (R,): reflectance (Rs^2 + Rp^2)/2 from the exact Fresnel
        equations (not the Schlick approximation, so `ior == 1` gives
        F == 0 at EVERY angle — the invariance the exactness test
        pins).  Under total internal reflection cos_t clamps to 0 and
        the equations evaluate to exactly 1: no explicit TIR branch.
        At normal incidence F == ((ior-1)/(ior+1))^2 exactly.
      * refl_dir (R,3): mirror direction d + 2 cos_i n.
      * refr_dir (R,3): Snell direction eta d + (eta cos_i - cos_t) n
        (unit where refraction exists; meaningless where F == 1).

    Differentiable in `ior` (the GI integrator's throughput weights
    carry d radiance / d ior through this F).
    """
    cos_i = jnp.clip(-jnp.sum(d_unit * n, axis=-1), 0.0, 1.0)
    eta = jnp.where(entering, 1.0 / ior, ior)  # n1/n2 as seen by the ray
    sin2_t = eta * eta * jnp.maximum(1.0 - cos_i * cos_i, 0.0)
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 0.0))  # 0 under TIR
    # guarded denominators: both only vanish at the measure-zero
    # grazing+TIR corner, where the numerators vanish too
    rs = (eta * cos_i - cos_t) / jnp.maximum(eta * cos_i + cos_t, 1e-20)
    rp = (eta * cos_t - cos_i) / jnp.maximum(eta * cos_t + cos_i, 1e-20)
    F = 0.5 * (rs * rs + rp * rp)
    refl = d_unit + 2.0 * cos_i[:, None] * n
    refr = eta[:, None] * d_unit + (eta * cos_i - cos_t)[:, None] * n
    return F, refl, refr


def pathtrace_rays(
    rays: RayBatch,
    scene: Scene,
    grid,
    meta,
    cfg: SceneConfig,
    tracer=None,
) -> jnp.ndarray:
    """Trace gi_samples Lambertian/mirror paths per input ray -> (R,3)
    linear radiance in the repo's 0-255 color units (reflective
    materials take the mirror branch unless cfg disables gi_specular).

    `tracer`: optional traversal/geometry provider for sharded-geometry
    (ring) execution.  When given, the replicated vertex table is never
    touched — each path segment's nearest hit comes back with its
    winning vertices and material CARRIED by the tracer (the ring
    payload), and occlusion queries go through tracer.occlude.  The
    physics (sampling, NEE, MIS, branch selection) is this ONE
    integrator either way, so the ring and replicated images cannot
    diverge beyond traversal arithmetic.  Interface:
      tracer.trace(rays_sg, t_gate) -> (hit (R,) bool,
                                        tv0/tv1/tv2 (R,3), mat (R,) i32,
                                        payload dict)
      tracer.occlude(rays_sg) -> (R,) bool (any accepted hit past eps)
      tracer.carries -> tuple of optional payload groups: "smooth"
        (payload carries corner normals vn0/vn1/vn2) and "uv" (corner
        uvs uv0/uv1/uv2 + has-uv flags huv) — the same per-face data
        the Whitted ring rides (parallel/shard._shade_payload).
    """
    rcfg = cfg.render
    assert rcfg.gi_samples > 0, "pathtrace_rays needs gi_samples > 0"
    if rcfg.faithful:
        raise ValueError("path tracing requires faithful=False")
    smooth = rcfg.normal_mode == "smooth"
    if tracer is None:
        v0, v1, v2 = scene.triangle_soa()
        # packed (F,9) rows: one gather per hit resolve (see renderer)
        tri9 = jnp.concatenate(
            [v0, v1, v2,
             scene.face_material.astype(v0.dtype)[:, None]], axis=1
        )  # material index rides lane 9 (see renderer)
        dt = v0.dtype
        trav = make_traversal(rcfg, grid, meta, v0, v1, v2)
        persistent = (rcfg.traversal == "packed"
                      and rcfg.scheduler == "persistent")
        # texture silently off without uv data — the Whitted epilogue's
        # rule (render/renderer.py)
        textured = rcfg.texture != "none" and scene.uvs is not None
    else:
        carries = getattr(tracer, "carries", ())
        if smooth and "smooth" not in carries:
            raise NotImplementedError(
                "ring GI: this tracer does not carry the corner-normal "
                "payload smooth normals need"
            )
        textured = rcfg.texture != "none" and "uv" in carries
        dt = scene.materials.base_color.dtype
        trav = None
        persistent = False
    r = rays.count
    eps = rcfg.shadow_eps
    vn = (vertex_normals(scene.verts, scene.faces, serial=False)
          if smooth and tracer is None else None)
    ddt = jnp.dtype(rcfg.det_dtype)
    background = jnp.asarray(rcfg.background, dt)

    # dielectric (glass) materials: Scene.transmissive/ior tables,
    # active in this integrator only (the Whitted paths raise).  The
    # tables are tiny (M,) replicated leaves, so the ring tracer path
    # consumes them identically (parallel/shard plumbs them into the
    # geometry-free scene stub).
    has_diel = scene.transmissive is not None
    if has_diel:
        trans_table = scene.transmissive
        ior_table = scene.ior.astype(dt)

    albedo_table = jnp.clip(scene.materials.base_color / 255.0, 0.0, 1.0)
    if textured:
        # the texture modulates the RAW base_color exactly as the
        # Whitted epilogue does (mat.base_color * tex, renderer.py /
        # reference vt plumbing Serial/raytracer.cpp:251-257), so the
        # clip to physical [0,1] reflectance happens AFTER modulation
        bc255_table = scene.materials.base_color / 255.0
    # mirror mix weight: km gated by the reference's `reflective` flag
    # (Parallel/raytracer.cu:449-453 palette; km is meaningless on
    # non-reflective entries there)
    km_table = (jnp.clip(scene.materials.km, 0.0, 1.0)
                * scene.materials.reflective.astype(dt))

    # point lights: primary + extras, all via next-event estimation
    lights = [(scene.light_pos, scene.light_intensity)]
    if scene.extra_light_pos is not None:
        for i in range(scene.extra_light_pos.shape[0]):
            lights.append(
                (scene.extra_light_pos[i], scene.extra_light_intensity[i])
            )

    # The per-ray sample key hashes the RAY ITSELF (origin/direction
    # bits), not its batch index: a ray keeps its sample sequence under
    # any padding, permutation or sharding, so the sharded render is
    # bitwise identical to the single-device one (the same convention
    # every other feature holds — tests/test_sharding.py).  Primary
    # rays have pairwise-distinct directions (distinct pixel centers),
    # so keys are distinct within a frame.
    ray_ids = ray_sample_keys(rays.orig, rays.dirn)

    # ---- environment-light NEE/MIS tables (gi_env_nee) ---------------
    # Piecewise-constant luminance x sin(theta) distribution over the
    # lat-long texels; a tiny uniform floor keeps pdf > 0 wherever the
    # (bilinear) env value can be nonzero, so the estimator stays
    # unbiased.  pdf/cdf are selection probabilities -> stop-gradient
    # (the env VALUE lookups stay differentiable).
    env_nee = rcfg.gi_env_nee and scene.env_image is not None
    if env_nee:
        env_img = scene.env_image
        He, We = env_img.shape[0], env_img.shape[1]
        # exact per-row solid angle: Omega_texel = (2pi/We) * dcos —
        # and directions are JITTERED uniformly within the chosen texel
        # (sampling only texel CENTERS is a discrete-atom distribution;
        # pretending a continuous pdf over it measured a 3.6% bias on
        # the 4x8 furnace env)
        edges = jnp.cos(jnp.arange(He + 1, dtype=jnp.float32) / He * jnp.pi)
        dcos = edges[:-1] - edges[1:]  # (He,) > 0
        th_c = (jnp.arange(He, dtype=jnp.float32) + 0.5) / He * jnp.pi
        lum = jnp.mean(jax.lax.stop_gradient(env_img), axis=-1)
        wtex = ((lum + jnp.float32(1e-3))
                * jnp.sin(th_c)[:, None]).reshape(-1)
        wsum = wtex.sum()
        env_cdf = jnp.cumsum(wtex) / wsum
        texel_sr = (2.0 * jnp.pi / We) * dcos  # (He,)

        def env_pdf(dirs):
            """Per-steradian pdf of the env sampler at unit dirs."""
            u = jnp.arctan2(dirs[:, 2], dirs[:, 0]) / (2.0 * jnp.pi) + 0.5
            v = jnp.arccos(jnp.clip(dirs[:, 1], -1.0, 1.0)) / jnp.pi
            iu = jnp.clip((u * We).astype(jnp.int32), 0, We - 1)
            iv = jnp.clip((v * He).astype(jnp.int32), 0, He - 1)
            idx = iv * We + iu
            return (wtex[idx] / wsum) / jnp.maximum(texel_sr[iv], 1e-12)

        def env_sample(u01, uj1, uj2):
            """u01 picks the texel; uj1/uj2 jitter within it ->
            (unit dirs (R,3), per-steradian pdf (R,))."""
            idx = jnp.clip(
                jnp.searchsorted(env_cdf, u01), 0, He * We - 1
            ).astype(jnp.int32)
            iv, iu = idx // We, idx % We
            cth = edges[iv] - uj1 * dcos[iv]  # uniform in cos(theta)
            phi = ((iu.astype(jnp.float32) + uj2) / We - 0.5) * (2.0 * jnp.pi)
            st = jnp.sqrt(jnp.maximum(1.0 - cth * cth, 0.0))
            d = jnp.stack(
                [st * jnp.cos(phi), cth, st * jnp.sin(phi)], axis=-1
            )
            pdf = (wtex[idx] / wsum) / jnp.maximum(texel_sr[iv], 1e-12)
            return d, pdf

    # Fused NEE: one point light on the persistent scheduler lets each
    # path segment's march rearm retiring lanes as their NEE shadow ray
    # (ops/persistent.py fuse_shadow — the same queue-free wavefront
    # trick the Whitted renderer uses), replacing the separate any-hit
    # shadow traversal per (sample, depth).  Visibility is the same
    # exists-a-blocker predicate; see RenderConfig.gi_fuse_nee.
    fuse_nee = persistent and rcfg.gi_fuse_nee and len(lights) == 1
    if fuse_nee:
        from ray_tracer_tpu.ops.persistent import persistent_trace

        lp0 = lights[0][0].astype(jnp.float32)

        def trav_fused(rb, t_gate, compact):
            return persistent_trace(
                rb, grid, meta, jax.lax.stop_gradient(lp0),
                wave=rcfg.wave, pump=rcfg.pump,
                t_gate=0.0 if t_gate is None else t_gate,
                fuse_shadow=True,
                shadow_gate=eps, shadow_mint=rcfg.shadow_mint(),
                serial_quirk=rcfg.shadow_dir_away_from_light(),
                need_t=False, compact=compact,
            )

    def _trace_batch(cur: RayBatch, key: jnp.ndarray) -> jnp.ndarray:
        """Trace one wavefront of (sample, ray) lanes; `key` is each
        lane's per-sample hash key.  Lanes are independent, so batching
        several samples into one call changes NOTHING per lane — it
        only amortizes the per-traversal fixed costs (queue sweep,
        straggler tail) over more work."""
        rr = cur.count
        radiance = jnp.zeros((rr, 3), dt)
        throughput = jnp.ones((rr, 3), dt)
        path_alive = jnp.ones((rr,), bool)
        inf3 = jnp.full((rr, 3), jnp.inf, dt)
        # cosine pdf of the segment's sampled direction (0 for camera
        # and mirror segments = delta/deterministic -> escape weight 1)
        bsdf_pdf = jnp.zeros((rr,), jnp.float32)

        for depth in range(rcfg.gi_depth + 1):
            gate = rcfg.primary_gate() if depth == 0 else rcfg.bounce_gate()
            if tracer is not None:
                res_hit, tv0, tv1, tv2, mat, payload = tracer.trace(
                    jax.lax.stop_gradient(cur),
                    0.0 if gate is None else gate,
                )
            elif fuse_nee:
                res = trav_fused(jax.lax.stop_gradient(cur), gate,
                                 compact=depth > 0)
                res_hit = res.hit
            else:
                tkw = {"compact": depth > 0} if persistent else {}
                res = trav(jax.lax.stop_gradient(cur), t_gate=gate, **tkw)
                res_hit = res.hit
            hit = res_hit & path_alive

            # escape: miss lanes pick up the environment by THIS
            # segment's direction, then the path ends
            if scene.env_image is not None:
                env = scene.sample_env(vm.normalize(cur.dirn)).astype(dt)
            else:
                env = jnp.broadcast_to(background, (rr, 3))
            escaped = path_alive & ~res_hit
            if env_nee:
                # balance-heuristic MIS: this escape direction could
                # also have been produced by the env sampler at the
                # previous diffuse vertex
                pe = env_pdf(vm.normalize(
                    jax.lax.stop_gradient(cur.dirn).astype(jnp.float32)
                ))
                w_mis = jnp.where(
                    bsdf_pdf > 0.0, bsdf_pdf / (bsdf_pdf + pe), 1.0
                ).astype(dt)
                env = env * w_mis[:, None]
            radiance = radiance + jnp.where(
                escaped[:, None], throughput * env, 0.0
            )

            if tracer is None:
                tri = jnp.maximum(res.tri_id, 0)
                tv = tri9[tri]  # one packed row gather (see renderer)
                tv0, tv1, tv2 = tv[:, 0:3], tv[:, 3:6], tv[:, 6:9]
                mat = tv[:, 9].astype(jnp.int32)
            else:
                # carried payload; miss lanes hold zeros — substitute a
                # constant non-degenerate triangle so normalize/cross
                # stay NaN-free (every consumer is hit-gated)
                ex = jnp.zeros_like(tv0).at[:, 0].set(1.0)
                ey = jnp.zeros_like(tv0).at[:, 1].set(1.0)
                tv0 = jnp.where(res_hit[:, None], tv0, 0.0).astype(dt)
                tv1 = jnp.where(res_hit[:, None], tv1, ex).astype(dt)
                tv2 = jnp.where(res_hit[:, None], tv2, ey).astype(dt)
            # differentiable hit distance from the stop-gradient topology
            # (the same recompute-t convention as render_rays)
            t_re = cramer_t_safe(cur.orig, cur.dirn, tv0, tv1, tv2,
                                 res_hit, det_dtype=ddt)
            t = jnp.where(res_hit, t_re.astype(dt), jnp.zeros_like(t_re).astype(dt))
            orig_safe = jnp.where(res_hit[:, None], cur.orig,
                                  jnp.zeros_like(cur.orig))
            poi = orig_safe + cur.dirn * t[:, None]
            gn = vm.normalize(vm.cross(tv1 - tv0, tv2 - tv0))
            if smooth or textured:
                # hit barycentrics shared by texture sampling and smooth
                # normals — same topology/arithmetic split as the
                # Whitted epilogue
                hb, hg = cramer_bg_safe(
                    orig_safe, cur.dirn, tv0, tv1, tv2, res_hit, det_dtype=ddt
                )
            if smooth:
                if tracer is None:
                    sn = interpolate_normal(
                        vn, scene.faces, tri, hb.astype(dt), hg.astype(dt)
                    )
                else:
                    # ring payload: Phong-interpolate the CARRIED corner
                    # normals (parallel/shard._shade_payload) — the same
                    # arithmetic as _ring_shade; miss lanes' zero payload
                    # is substituted before normalize (NaN-free backward)
                    alf = (1.0 - hb - hg).astype(jnp.float32)
                    hbf, hgf = hb.astype(jnp.float32), hg.astype(jnp.float32)
                    sn_raw = (alf[:, None] * payload["vn0"]
                              + hbf[:, None] * payload["vn1"]
                              + hgf[:, None] * payload["vn2"])
                    sn = vm.normalize(jnp.where(
                        res_hit[:, None], sn_raw,
                        jnp.zeros_like(sn_raw).at[:, 0].set(1.0)
                    )).astype(dt)
                n = vm.normalize(sn)
            else:
                n = gn
            # orient against the incoming ray (double-sided Lambertian)
            flip = jnp.sum(n * cur.dirn, axis=-1) > 0.0
            n = jnp.where(flip[:, None], -n, n)

            mat_c = jnp.clip(mat, 0, albedo_table.shape[0] - 1)
            # dielectric lanes: delta interface — no NEE, no km mix,
            # no albedo modulation; the bounce section below picks
            # reflect-vs-refract by the exact Fresnel reflectance
            diel = (hit & trans_table[mat_c] if has_diel
                    else jnp.zeros((rr,), bool))
            if textured:
                # barycentric uv -> texture factor, the Whitted
                # epilogue's exact expressions (renderer.py; ring:
                # parallel/shard._ring_shade) modulating the albedo
                if tracer is None:
                    uv = scene.interpolate_uv(tri, hb.astype(dt), hg.astype(dt))
                    has_uv = scene.uv_faces[tri][:, 0] >= 0
                else:
                    ald = (1.0 - hb - hg).astype(dt)
                    uv = (ald[:, None] * payload["uv0"]
                          + hb.astype(dt)[:, None] * payload["uv1"]
                          + hg.astype(dt)[:, None] * payload["uv2"])
                    has_uv = payload["huv"]
                from ray_tracer_tpu.models.scenes import texture_factor

                tex = texture_factor(uv, has_uv, hit, rcfg.texture,
                                     rcfg.texture_scale,
                                     scene.texture_image, dt)
                albedo = jnp.clip(bc255_table[mat_c] * tex, 0.0, 1.0)
            else:
                albedo = albedo_table[mat_c]

            # ---- Lambertian / mirror branch selection -----------------
            # (config.RenderConfig.gi_specular) one deterministic hash
            # draw per (pixel, sample, depth) picks the mirror branch
            # with probability km; each branch's weight divides by the
            # STOP-GRADIENT selection probability, so the estimator is
            # unbiased and d/d km flows exactly:
            #   E[w·L] = p·(km/p)·L_spec + (1-p)·((1-km)/(1-p))·L_diff
            #          = km·L_spec + (1-km)·L_diff        (p = sg(km))
            # — the stochastic form of the Whitted blend
            # `color·base·(1-km) + recurse·km` (Parallel/raytracer.cu:
            # 508-520).  km == 0 everywhere makes spec all-False and
            # every weight exactly 1.0: bitwise-identical images.
            if rcfg.gi_specular:
                km_d = km_table[mat]
                p_spec = jax.lax.stop_gradient(km_d)
                u3 = _hash_u01(key, 0x85EBCA77 * (depth + 1) + 13)
                spec = hit & ~diel & (u3.astype(dt) < p_spec)
                # unselected-branch denominators are never 0 where
                # selected (u3 < p rules out p == 0; p == 1 rules out
                # the diffuse branch), so both quotients stay finite
                # and the backward pass NaN-free
                w_branch = jnp.where(
                    spec,
                    km_d / jnp.where(p_spec > 0, p_spec, 1.0),
                    (1.0 - km_d) / jnp.where(p_spec < 1, 1.0 - p_spec, 1.0),
                )
                # dielectric lanes sit outside the km mix entirely
                throughput = throughput * jnp.where(
                    diel, 1.0, w_branch
                )[:, None]
            else:
                spec = jnp.zeros((rr,), bool)

            # ---- next-event estimation at every path vertex ----------
            # (diffuse branch only: the mirror is a delta BSDF — a point
            # light is unreachable through it, so NEE adds nothing)
            for lp, li in lights:
                to_l = lp - poi
                d2 = jnp.sum(to_l * to_l, axis=-1)
                wl = to_l / jnp.sqrt(jnp.maximum(d2, 1e-20))[:, None]
                cos_i = jnp.maximum(jnp.sum(n * wl, axis=-1), 0.0)
                if fuse_nee:
                    # visibility came back with the fused march
                    unoccluded = hit & ~spec & ~diel & ~res.in_shadow
                else:
                    srays = jax.tree.map(
                        jax.lax.stop_gradient,
                        shadow_rays_for(rcfg, lp, poi, hit),
                    )
                    if tracer is not None:
                        occ = tracer.occlude(srays)
                    else:
                        skw = {"compact": True} if persistent else {}
                        occ = trav(srays, t_gate=eps,
                                   stop_on_first_hit=True, **skw).hit
                    unoccluded = hit & ~spec & ~diel & ~occ
                direct = (
                    albedo * jnp.float32(_INV_PI)
                    * (li * cos_i / jnp.maximum(d2, 1e-20))[:, None]
                )
                radiance = radiance + jnp.where(
                    unoccluded[:, None], throughput * direct, 0.0
                )

            # ---- environment-light NEE (diffuse vertices) -------------
            # one env-sampled direction per vertex, shadow-tested for a
            # clear escape, MIS-weighted against the cosine sampler —
            # small bright env texels no longer rely on the bounce ray
            # stumbling into them (config.RenderConfig.gi_env_nee)
            if env_nee:
                u4 = _hash_u01(key, 0x68E31DA4 * (depth + 1) + 3)
                u5 = _hash_u01(key, 0x7F4A7C15 * (depth + 1) + 11)
                u6 = _hash_u01(key, 0x94D049BB * (depth + 1) + 29)
                edir, epdf = env_sample(u4, u5, u6)
                cos_e = jnp.maximum(
                    jnp.sum(n * edir.astype(dt), axis=-1), 0.0
                )
                live_e = hit & ~spec & ~diel & (cos_e > 0.0)
                eorig = jnp.where(live_e[:, None], poi, inf3)
                erays = jax.tree.map(jax.lax.stop_gradient, RayBatch.make(
                    eorig, edir.astype(dt), mint=jnp.asarray(eps, dt)
                ))
                if tracer is not None:
                    e_occ = tracer.occlude(erays)
                else:
                    skw = {"compact": True} if persistent else {}
                    e_occ = trav(erays, t_gate=eps, stop_on_first_hit=True,
                                 **skw).hit
                clear = live_e & ~e_occ
                L_env = scene.sample_env(edir.astype(dt)).astype(dt)
                pc_e = jax.lax.stop_gradient(cos_e).astype(jnp.float32) \
                    * jnp.float32(_INV_PI)
                w_nee = (epdf / (epdf + pc_e)).astype(dt)
                contrib = (
                    albedo * jnp.float32(_INV_PI) * L_env
                    * (cos_e / jnp.maximum(epdf, 1e-12).astype(dt)
                       * w_nee)[:, None]
                )
                radiance = radiance + jnp.where(
                    clear[:, None], throughput * contrib, 0.0
                )

            if depth == rcfg.gi_depth:
                break

            # ---- bounce: cosine-weighted diffuse or mirror ------------
            # the sample key mixes ray id, sample index and depth so
            # every (pixel, sample, bounce) gets its own 2-D point
            u1 = _hash_u01(key, 0x1000193 * (depth + 1))
            u2 = _hash_u01(key, 0x5BD1E995 * (depth + 1) + 7)
            ndir = _cosine_sample(jax.lax.stop_gradient(n), u1, u2)
            if rcfg.gi_specular:
                # mirror: d' = d - 2(d.n)n off the oriented normal; the
                # reference blend's `recurse * km` term is UNtinted, so
                # the mirror branch leaves throughput alone (its km
                # weight was applied at branch selection)
                mdir = cur.dirn - 2.0 * jnp.sum(
                    cur.dirn * n, axis=-1, keepdims=True
                ) * n
                ndir = jnp.where(spec[:, None], mdir, ndir)
            if has_diel:
                # ---- dielectric reflect/refract (exact Fresnel) ------
                # one deterministic draw takes the mirror branch with
                # probability F; each branch's weight divides by the
                # STOP-GRADIENT selection probability, so the estimator
                # is unbiased and d radiance / d ior flows through F:
                #   E[w·L] = F·L_refl + (1-F)·L_refr        (p = sg(F))
                # TIR evaluates to F == 1 inside fresnel_refract, so
                # u7 < 1 always reflects there (the hash is in [0,1)).
                # Glass is untinted: base_color does not modulate the
                # transmitted throughput (a delta interface, not a
                # Lambertian event).
                du = vm.normalize(cur.dirn)
                F, refl_dir, refr_dir = fresnel_refract(
                    du, n, ~flip, ior_table[mat_c]
                )
                p_refl = jax.lax.stop_gradient(F)
                u7 = _hash_u01(key, 0xA0761D65 * (depth + 1) + 17)
                refl_d = diel & (u7.astype(dt) < p_refl)
                # unselected-branch denominators never vanish where
                # selected (u7 < p rules out p == 0; p == 1 rules out
                # the refract branch) — same NaN-free rule as the km mix
                w_diel = jnp.where(
                    refl_d,
                    F / jnp.where(p_refl > 0, p_refl, 1.0),
                    (1.0 - F) / jnp.where(p_refl < 1, 1.0 - p_refl, 1.0),
                )
                throughput = throughput * jnp.where(
                    diel, w_diel, 1.0
                )[:, None]
                ndir = jnp.where(
                    diel[:, None],
                    jnp.where(refl_d[:, None], refl_dir, refr_dir),
                    ndir,
                )
            ndir = jax.lax.stop_gradient(ndir.astype(dt))
            if env_nee:
                # next segment's cosine pdf for the escape MIS weight;
                # mirror segments are delta -> 0 (weight 1 on escape)
                pc_next = jnp.maximum(
                    jnp.sum(jax.lax.stop_gradient(n).astype(jnp.float32)
                            * ndir.astype(jnp.float32), axis=-1), 0.0
                ) * jnp.float32(_INV_PI)
                bsdf_pdf = jnp.where(spec | diel | ~hit, 0.0, pc_next)
            # cosine-weighted pdf cancels BRDF x cos exactly: weight =
            # albedo (differentiable; the DIRECTION is stop-gradient)
            throughput = throughput * jnp.where(
                (spec | diel)[:, None], 1.0, albedo
            )
            path_alive = hit
            rorig = jnp.where(hit[:, None], poi, inf3)
            cur = RayBatch.make(rorig, ndir, mint=jnp.asarray(eps, dt))

        return radiance

    # ---- sample batching --------------------------------------------
    # Lanes are (sample, ray)-independent, so up to gi_sample_batch
    # samples ride ONE wavefront: (D+1) traversals instead of S*(D+1),
    # amortizing each traversal's fixed costs (the O(R) queue sweep and
    # the straggler tail at frame end) and keeping the wave fed.
    # Bitwise-invariant in the batch size: each lane's sample key is
    # the SAME hash of (ray, sample) either way, and the per-sample
    # images are accumulated in the same sequential order.
    S = rcfg.gi_samples
    B = max(1, min(rcfg.gi_sample_batch, S))
    acc = None
    salt = jnp.uint32(0x632BE59B)
    for s0 in range(0, S, B):
        nb = min(B, S - s0)
        if nb == 1:
            out = _trace_batch(rays, ray_ids + salt * jnp.uint32(s0 + 1))
            parts = [out]
        else:
            cur0 = jax.tree.map(
                lambda x: jnp.concatenate([x] * nb, axis=0), rays
            )
            s_plus1 = jnp.repeat(
                jnp.arange(s0 + 1, s0 + nb + 1, dtype=jnp.uint32), r
            )
            keys = jnp.concatenate([ray_ids] * nb) + salt * s_plus1
            out = _trace_batch(cur0, keys)
            parts = [out[j * r:(j + 1) * r] for j in range(nb)]
        for c in parts:  # sequential, batch-size-independent order
            acc = c if acc is None else acc + c
    return acc / S


from functools import partial


@partial(jax.jit, static_argnames=("meta", "cfg"))
def _render_pt_jit(scene, grid, meta, cfg):
    cam = cfg.camera
    rays = camera_rays(cam, dtype=jnp.dtype(cfg.render.dtype))
    colors = pathtrace_rays(rays, scene, grid, meta, cfg)
    return colors.reshape(cam.height, cam.width, 3)


def gi_wave_eligible(prep) -> bool:
    """Can this forward render take the cross-depth GI wave
    (ops/gi_wave.py)?  Decided here, OUTSIDE any jit, from the concrete
    scene: the wave covers the packed+persistent single-point-light
    Lambertian configuration (the official GI benchmark class); every
    other feature combination falls back to the segment loop.
    RenderConfig.gi_wave: "auto" | "on" (error if ineligible) | "off".
    """
    cfg = prep.cfg
    rcfg = cfg.render
    scene = prep.scene
    knob = rcfg.gi_wave
    if knob == "off":
        return False
    ok = (
        rcfg.gi_samples > 0
        and rcfg.traversal == "packed"
        and rcfg.scheduler == "persistent"
        and not rcfg.faithful
        and rcfg.det_dtype == "float32"
        and jnp.dtype(rcfg.dtype) == jnp.dtype(jnp.float32)
        # env maps are supported (escapes defer to one merged lookup
        # per round) — but env NEE/MIS stays segment-only
        and not (scene.env_image is not None and rcfg.gi_env_nee)
        and scene.extra_light_pos is None
        # dielectrics run the segment loop (the wave has no
        # reflect/refract rearm)
        and scene.transmissive is None
    )
    if knob == "on" and not ok:
        raise ValueError(
            "gi_wave='on' but the configuration is ineligible (needs "
            "packed+persistent, one point light, no env-NEE/extra "
            "lights/texture, float32 dets)"
        )
    return ok


def use_gi_wave_spec(scene, rcfg) -> bool:
    """STATIC decision (host values): does this scene need the wave's
    mirror-mix machinery?  False keeps the pure-Lambertian wave's exact
    shared-primary structure."""
    import numpy as np

    km_np = (np.asarray(scene.materials.km).clip(0.0, 1.0)
             * np.asarray(scene.materials.reflective).astype(np.float32))
    return bool(rcfg.gi_specular and (km_np > 0.0).any())


def build_gi_wave_tables(scene, rcfg, use_spec: bool):
    """(albedo_table, km_table, fuv7, tex_image, bc255_table, fvn9)
    for gi_wave_trace — jnp-only (safe inside shard_map traces), the
    ONE builder shared by the single-device and sharded dispatches."""
    albedo_table = jnp.clip(scene.materials.base_color / 255.0, 0.0, 1.0)
    km_table = (
        (jnp.clip(scene.materials.km, 0.0, 1.0)
         * scene.materials.reflective.astype(jnp.float32))
        if use_spec else None
    )
    # textures: (F,7) corner-uv + has-uv rows, RAW base_color (the
    # texture modulates before the clamp, the segment integrator's
    # exact convention)
    fuv7 = None
    tex_image = None
    bc255_table = None
    if rcfg.texture != "none" and scene.uvs is not None:
        if rcfg.texture == "image":
            if scene.texture_image is None:
                raise ValueError(
                    'cfg.render.texture == "image" but the scene has '
                    "no texture_image"
                )
            tex_image = scene.texture_image
        elif rcfg.texture != "checker":
            raise ValueError(f"unknown texture mode {rcfg.texture!r}")
        fuv = scene.uvs[jnp.maximum(scene.uv_faces, 0)].reshape(-1, 6)
        fhuv = (scene.uv_faces[:, 0] >= 0).astype(jnp.float32)[:, None]
        fuv7 = jnp.concatenate([fuv.astype(jnp.float32), fhuv], axis=1)
        bc255_table = scene.materials.base_color / 255.0
    fvn9 = None
    if rcfg.normal_mode == "smooth":
        # per-face corner normals packed into ONE (F,9) row so the
        # wave's smooth interpolation costs a single extra gather per
        # round (the integrator's serial=False vertex-normal table)
        vn = vertex_normals(scene.verts, scene.faces, serial=False)
        fvn9 = vn[scene.faces].reshape(-1, 9).astype(jnp.float32)
    return albedo_table, km_table, fuv7, tex_image, bc255_table, fvn9


def build_gi_wave_tri9(scene):
    v0, v1, v2 = scene.triangle_soa()
    return jnp.concatenate(
        [v0, v1, v2, scene.face_material.astype(v0.dtype)[:, None]], axis=1
    )


def _render_pt_wave(prep) -> jnp.ndarray:
    """Forward GI through the cross-depth wave (ops/gi_wave.py)."""
    from ray_tracer_tpu.ops.gi_wave import gi_wave_trace

    cfg = prep.cfg
    rcfg = cfg.render
    scene = prep.scene
    tri9 = build_gi_wave_tri9(scene)
    (albedo_table, km_table, fuv7, tex_image, bc255_table,
     fvn9) = build_gi_wave_tables(scene, rcfg,
                                  use_gi_wave_spec(scene, rcfg))
    pg = rcfg.primary_gate()
    rad = gi_wave_trace(
        scene.light_pos, scene.light_intensity, albedo_table, tri9,
        prep.packed.arrays, prep.packed.meta, scene.env_image, fvn9,
        km_table, fuv7, tex_image, bc255_table,
        camera=cfg.camera, tex_scale=float(rcfg.texture_scale),
        S=rcfg.gi_samples, D=rcfg.gi_depth,
        wave=rcfg.wave, pump=rcfg.pump,
        gate0=0.0 if pg is None else pg, gate_b=rcfg.bounce_gate(),
        eps=rcfg.shadow_eps, smint=rcfg.shadow_mint(),
        quirk=rcfg.shadow_dir_away_from_light(),
        bg=tuple(rcfg.background),
        refill_retries=(3 if rcfg.refill_retries is None
                        else rcfg.refill_retries),
    )
    cam = cfg.camera
    return (rad / rcfg.gi_samples).reshape(cam.height, cam.width, 3)


def render_pt(prep) -> jnp.ndarray:
    """Path-traced render of a Prepared scene -> (H, W, 3) linear color
    (same units/shape contract as renderer.render).

    Eligible forward renders take the cross-depth persistent wave
    (gi_wave_eligible above — forward-only, no gradients); everything
    else runs the segment-loop integrator under ONE module-level jit
    with static (meta, cfg) — an inner `@jax.jit def run` closure
    would be a FRESH jit cache per call, re-tracing the whole
    multi-traversal graph every frame — seconds of host time per frame,
    far more than the frame's device work."""
    cfg = prep.cfg
    if gi_wave_eligible(prep):
        return _render_pt_wave(prep)
    if cfg.render.traversal == "packed":
        grid, meta = prep.packed.arrays, prep.packed.meta
    else:
        grid, meta = prep.grid.arrays, prep.grid.meta
    return _render_pt_jit(prep.scene, grid, meta, cfg)
