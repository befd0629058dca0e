"""Cross-depth GI wave: ONE persistent while_loop for the whole
path-traced frame.

The segment-loop integrator (render/pathtrace.py) dispatches one
traversal per (sample-batch, depth) — S*(D+1) fused marches whose
queue sweeps, refill passes and per-depth epilogues run over the FULL
(B*R)-lane batch even when 95% of bounce lanes are dead.  This module
folds the whole estimator into the persistent scheduler instead (the
round-4 verdict's "extend the rearm to bounce->NEE->next-sample"): a
lane pops a PIXEL and serves its entire estimate —

    primary march -> NEE shadow -> bounce(sample 0) -> NEE -> ... ->
    bounce(sample 1) -> ... -> scatter ONE radiance record

— rearming in place at every transition, exactly like the Whitted
fused wave rearms primary->shadow (ops/persistent.py).  Three
structural wins over the segment loop:

  * the primary march runs ONCE per pixel, not once per sample: on a
    Lambertian scene every sample of a pixel shares the same depth-0
    hit, normal, albedo and NEE visibility, so the per-sample work is
    only the bounce sub-paths (the segment loop re-marches S identical
    primaries);
  * zero inter-segment overhead: no per-traversal queue sweeps over
    mostly-dead bounce batches, no O(R) compaction prefilters, no
    per-depth shading epilogues over dead lanes — integrator math runs
    only at retirement events on the lanes that retire;
  * occupancy: a lane that finishes a bounce immediately starts its
    next segment (or the next sample, or the next pixel) in the same
    round — live lanes from every depth and sample share one wave.

Scope (the eligibility gate lives in render/pathtrace.render_pt):
packed grid + persistent scheduler, ONE point light, no env NEE /
extra lights, float32 dets.  Served IN-wave: environment maps
(deferred merged escape lookups), smooth normals (one packed
corner-normal row), textures (one corner-uv row; checker and bilinear
image modes), and the Lambertian/mirror mix.  Segment-only remainder:
env NEE/MIS, extra point lights (whose segments also drop the fused
NEE), and ring-sharded geometry.
Environment maps ARE served: escapes stage their direction in the
carry and resolve through ONE merged bilinear lookup per round (a
per-escape-site lookup would be per-index gather-engine work — the
bitset lesson).  This covers the official GI benchmark configuration
(bench.py --gi); everything else takes the segment loop, whose physics
this module reproduces contribution-for-contribution in the same
chronological order (radiance associates as sum_s v_s with v_s built
escape/NEE-in-depth-order — pinned by the wave-vs-segments parity
test, tests/test_pathtrace.py).

FORWARD-ONLY: the whole estimator lives inside a while_loop carry, so
the output is one big stop-gradient island.  Training/gradient paths
must use the segment integrator (render_pt only routes here for plain
forward renders; pathtrace_rays never does).

Reference anchor: this replaces the CUDA reference's per-thread
recursion (Parallel/raytracer.cu:508-520) at production scale the same
way persistent_trace replaces its wavefront queues (:32-130).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ray_tracer_tpu.accel.packed import PackedGridArrays, PackedGridMeta
from ray_tracer_tpu.ops.camera import camera_ray_at
from ray_tracer_tpu.ops.traverse_packed import _march_step, _slab_entry

_INF = float("inf")
_INV_PI = 0.3183098861837907
_SALT = 0x632BE59B  # per-sample key stride (render/pathtrace.py)


# Parity-critical sampling arithmetic is imported from the segment
# integrator — ONE definition (render/pathtrace.py), so the wave's
# bitwise agreement with the segment loop's draws cannot drift.
from ray_tracer_tpu.core import vecmath as vm
from ray_tracer_tpu.render.pathtrace import (
    _cosine_sample,
    _hash_u01,
    ray_sample_keys,
)


@partial(
    jax.jit,
    static_argnames=(
        "meta", "camera", "S", "D", "wave", "pump", "gate0", "gate_b",
        "eps", "smint", "quirk", "bg", "refill_retries", "max_iters",
        "tex_scale", "pix_stride", "queue_len",
    ),
)
def gi_wave_trace(
    light_pos: jnp.ndarray,
    light_intensity: jnp.ndarray,
    albedo_table: jnp.ndarray,
    tri9: jnp.ndarray,
    grid: PackedGridArrays,
    meta: PackedGridMeta,
    env_image=None,
    fvn9=None,
    km_table=None,
    fuv7=None,
    tex_image=None,
    bc255_table=None,
    *,
    camera,
    tex_scale: float = 1.0,
    S: int,
    D: int,
    wave: int = 12288,
    pump: int = 1,
    gate0: float = 0.0,
    gate_b: float = 1e-4,
    eps: float = 1e-4,
    smint: float = 1e-4,
    quirk: bool = False,
    bg: tuple = (0.0, 0.0, 0.0),
    refill_retries: int = 3,
    max_iters=None,
    pix_offset=None,
    pix_stride: int = 1,
    queue_len=None,
) -> jnp.ndarray:
    """SUMMED radiance over S samples per pixel -> (H*W, 3) f32 (the
    caller divides by S).  Contribution order per pixel matches the
    segment integrator: rad = ((v_0 + v_1) + ...) with each v_s built
    escape/NEE-in-depth-order.

    gate0/gate_b/eps/smint/quirk: the shared hit/shadow policy
    (config.RenderConfig.primary_gate / bounce_gate / shadow_eps /
    shadow_mint / shadow_dir_away_from_light), so the wave's visibility
    topology is the segment loop's exactly.

    pix_offset/pix_stride/queue_len: the SHARDED queue (see
    whitted_wave_trace) — queue position k serves GLOBAL pixel
    pix_offset + k*pix_stride by pure index arithmetic, so a shard_map
    shard runs the wave over its own slice/striding and per-pixel
    results equal the single-device wave.  Output is (queue_len,)
    queue-ordered."""
    r = camera.width * camera.height
    qn = queue_len if queue_len is not None else r
    off = (jnp.asarray(0, jnp.int32) if pix_offset is None
           else pix_offset.astype(jnp.int32))
    w = min(wave, qn)
    bt = meta.block_tris
    n_slots = grid.slot_tri.shape[0]
    n_faces = tri9.shape[0]
    n_mats = albedo_table.shape[0]
    inf = jnp.float32(_INF)
    light = light_pos.astype(jnp.float32)
    li = light_intensity.astype(jnp.float32)
    alb_tab = albedo_table.astype(jnp.float32)
    # Lambertian/mirror mix (pathtrace's gi_specular): km_table is the
    # per-material clip(km)*reflective; None = Lambertian-only scene.
    # Forward branch weights are EXACTLY 1 (km/p and (1-km)/(1-p) with
    # p == km), so throughput is untouched by the selection — only the
    # draw, the bounce direction and the NEE skip differ per branch.
    has_spec = km_table is not None
    km_tab = (km_table.astype(jnp.float32) if has_spec else None)
    # Textures (round 5 cont.): fuv7 = (F,7) [uv corners x3, has_uv]
    # rows (one extra gather at vertex resolve); the sampled factor
    # modulates the RAW base_color before the clamp, exactly like the
    # segment integrator.  tex_image None = checker mode.
    textured = fuv7 is not None
    if textured:
        assert bc255_table is not None, "textured wave needs bc255_table"
        bc255_tab = bc255_table.astype(jnp.float32)
        tex_f32 = (None if tex_image is None
                   else tex_image.astype(jnp.float32))
    bg3 = jnp.asarray(bg, jnp.float32)
    # depth-0 miss: v_s = bg for every sample, summed sequentially in
    # f32 (the segment loop's acc association)
    bg_acc = np.zeros(3, np.float32)
    for _ in range(S):
        bg_acc = (bg_acc + np.asarray(bg, np.float32)).astype(np.float32)
    bg_acc_j = jnp.asarray(bg_acc)
    has_env = env_image is not None
    if has_env:
        # Environment escapes (round 5 cont.): the escape radiance is a
        # per-direction lookup, and a lookup is gather-engine work the
        # march must not pay per escape site — escapes are STAGED
        # (epend/edir carries) and resolved by ONE merged bilinear
        # lookup at the top of the next round's transition.  The
        # segment loop's arithmetic (sample_env(normalize(dir)),
        # radiance += throughput * env) is reproduced exactly, one
        # round later per escape.
        from ray_tracer_tpu.models.scenes import sample_env_image

        env_f32 = env_image.astype(jnp.float32)
        # AABB-rejected pixels never enter the wave: their output is
        # the dense per-pixel escape value, S-folded sequentially
        _gid_all = jnp.clip(
            off + jnp.arange(qn, dtype=jnp.int32) * pix_stride, 0, r - 1
        )
        _gen_all = camera_ray_at(camera, _gid_all)
        _env0 = sample_env_image(
            env_f32, vm.normalize(_gen_all.dirn.astype(jnp.float32))
        )
        _acc0 = jnp.zeros((qn, 3), jnp.float32)
        for _ in range(S):
            _acc0 = _acc0 + _env0

    from ray_tracer_tpu.ops.traverse_packed import _default_max_steps

    # per-SEGMENT lane-step bound: a lane caught in the march's
    # boundary-creep (the relative probe nudge can advance ~4e-6/step
    # on degenerate boundary rays) retires as its best-so-far at the
    # tiled traversal's own worst-case bound instead of spinning the
    # whole wave to max_rounds and silently discarding its pixel.
    seg_bound = _default_max_steps(meta)
    if max_iters is None:
        per_ray = seg_bound * 2 * (D + 1) * S
        max_iters = -(-qn * per_ray // w) + per_ray + 64
    max_rounds = -(-max_iters // pump)

    # shard_map carry-type treatment (the persistent wave's rule)
    from ray_tracer_tpu.parallel.collectives import pcast_varying, vma_union

    _want = vma_union((light_pos, light_intensity, albedo_table, tri9,
                       grid, off))
    zf = pcast_varying(jnp.zeros((w,), jnp.float32), _want)
    zi = zf.astype(jnp.int32)
    zb = zi != 0
    z3 = jnp.zeros((w, 3), jnp.float32) + zf[:, None]

    state = dict(
        # march core (ops/traverse_packed._march_step contract)
        o=z3, d=jnp.ones((w, 3), jnp.float32),
        alive=zb, testing=zb,
        t_cur=zf, t_exit_cell=zf,
        first_blk=zi, n_blk=zi, cursor=zi,
        best_t=zf + inf, best_blk=zi, best_slot=zi,
        gate=zf, maxt=zf,
        # estimator state machine
        ray_id=jnp.full((w,), qn, jnp.int32),
        phase=zb,            # False = path segment, True = NEE shadow
        lsteps=zi,           # steps in the CURRENT segment (see seg_bound)
        depth=zi,            # current vertex/segment depth
        samp=zi,             # current sample index
        key0=zf.astype(jnp.uint32),
        rad=z3,              # pixel radiance (sum over finished samples)
        vcur=z3,             # current sample's radiance
        tpt=jnp.ones((w, 3), jnp.float32),  # current throughput
        pend=z3,             # staged NEE contribution (awaiting shadow)
        nrm=z3,              # current vertex oriented normal
        alb=z3,              # current vertex albedo
        vpos=z3,             # current vertex position (recomputed t)
        idir=z3,             # incident segment direction (mirror input)
        vspec=zb,            # current vertex took the mirror branch
        vkm=zf,              # current vertex km (survives the shadow)
        idir0=z3,            # depth-0 incident dir (mirror restarts)
        km0=zf,              # depth-0 vertex km (restart branch draws)
        d0=z3,               # shared depth-0 NEE contribution
        poi0=z3, n0=z3, alb0=z3,  # shared depth-0 vertex (sample restarts)
        # emit latch + output buffers (per-lane dump rows keep scatters
        # unique-index; 1-D per channel — the measured fast lowering)
        # deferred environment escapes (has_env only; dead weight of a
        # few lanes otherwise)
        epend=zb,            # an escape awaits its env lookup
        e0=zb,               # ... and it is a depth-0 (whole-pixel) miss
        edir=jnp.ones((w, 3), jnp.float32),  # the escape direction
        done_acc=zb,
        rl0=zf, rl1=zf, rl2=zf,
        out0=(jnp.concatenate([_acc0[:, 0], jnp.zeros((w,), jnp.float32)])
              if has_env else jnp.full((qn + w,), float(bg_acc[0]),
                                       jnp.float32)),
        out1=(jnp.concatenate([_acc0[:, 1], jnp.zeros((w,), jnp.float32)])
              if has_env else jnp.full((qn + w,), float(bg_acc[1]),
                                       jnp.float32)),
        out2=(jnp.concatenate([_acc0[:, 2], jnp.zeros((w,), jnp.float32)])
              if has_env else jnp.full((qn + w,), float(bg_acc[2]),
                                       jnp.float32)),
        next=jnp.asarray(0, jnp.int32),
        i=jnp.asarray(0, jnp.int32),
    )

    def pop_once(s):
        """Idle lanes pop the next unserved pixels (the deterministic
        cumsum queue) and regenerate their camera ray from the index —
        pure arithmetic, zero gathers (ops/persistent.py)."""
        # an epend lane is dead-but-not-done (its escape resolves next
        # transition) — it must NOT be popped over
        idle = ~s["alive"] & ~s["epend"]
        order = jnp.cumsum(idle.astype(jnp.int32))
        new_id = jnp.where(idle, s["next"] + order - 1, s["ray_id"])
        got = idle & (new_id < qn)
        rid = jnp.where(got, new_id, jnp.where(idle, qn, s["ray_id"]))
        # queue position -> GLOBAL pixel (sharded: the shard's stride)
        gid = off + rid * pix_stride
        valid = got & (gid < r)
        gen = camera_ray_at(camera, jnp.clip(gid, 0, r - 1))
        o = jnp.where(got[:, None], gen.orig.astype(jnp.float32), s["o"])
        d = jnp.where(got[:, None], gen.dirn.astype(jnp.float32), s["d"])
        t0, entered = _slab_entry(
            grid, o, d, gen.mint.astype(jnp.float32),
            gen.maxt.astype(jnp.float32),
        )
        live = valid & entered
        key0 = ray_sample_keys(gen.orig, gen.dirn)
        return dict(
            s,
            o=o, d=d,
            maxt=jnp.where(got, gen.maxt.astype(jnp.float32), s["maxt"]),
            gate=jnp.where(got, jnp.float32(gate0), s["gate"]),
            ray_id=rid,
            alive=jnp.where(idle, live, s["alive"]),
            testing=jnp.where(got, False, s["testing"]),
            t_cur=jnp.where(got, t0, s["t_cur"]),
            cursor=jnp.where(got, 0, s["cursor"]),
            best_t=jnp.where(got, inf, s["best_t"]),
            best_blk=jnp.where(got, 0, s["best_blk"]),
            best_slot=jnp.where(got, 0, s["best_slot"]),
            phase=jnp.where(got, False, s["phase"]),
            lsteps=jnp.where(got, 0, s["lsteps"]),
            depth=jnp.where(got, 0, s["depth"]),
            samp=jnp.where(got, 0, s["samp"]),
            key0=jnp.where(got, key0, s["key0"]),
            rad=jnp.where(got[:, None], 0.0, s["rad"]),
            vcur=jnp.where(got[:, None], 0.0, s["vcur"]),
            tpt=jnp.where(got[:, None], 1.0, s["tpt"]),
            pend=jnp.where(got[:, None], 0.0, s["pend"]),
            next=jnp.minimum(s["next"] + order[-1], qn),
        )

    def refill(s):
        # AABB-rejected pixels keep the miss-initialized output (bg
        # summed S times) — they cost re-pops, not wave rounds
        for _ in range(1 + refill_retries):
            s = pop_once(s)
        return s

    if _want:
        state = pcast_varying(state, _want)
    state = refill(state)

    def cond(s):
        return (s["i"] < max_rounds) & (
            jnp.any(s["alive"]) | jnp.any(s["epend"]) | (s["next"] < qn)
        )

    def transition(s, pre_alive):
        """All retirement events of one round: segment retirements
        resolve their vertex (the round's ONE tri9 gather) and rearm as
        NEE shadows; shadow retirements settle their contribution; the
        sample-end cascade restarts the next sample or retires the
        pixel."""
        alive, testing = s["alive"], s["testing"]
        best_t = s["best_t"]
        hit_now = jnp.isfinite(best_t)
        walked = pre_alive & ~alive
        phase = s["phase"]
        timeout = alive & (s["lsteps"] > seg_bound)

        # ---- resolve LAST round's staged env escapes (one merged
        # bilinear lookup serves every escape category) ----------------
        if has_env:
            from ray_tracer_tpu.models.scenes import sample_env_image

            Lenv = sample_env_image(env_f32, vm.normalize(s["edir"]))
            ep = s["epend"]
            acc0 = jnp.zeros_like(Lenv)
            for _ in range(S):  # a depth-0 miss repeats for every sample
                acc0 = acc0 + Lenv
            prim_env_done = ep & s["e0"]
            rad_resolved = jnp.where(prim_env_done[:, None], acc0, s["rad"])
            E_carry = ep & ~s["e0"]
            vcur_resolved = s["vcur"] + jnp.where(
                E_carry[:, None], s["tpt"] * Lenv, 0.0
            )
        else:
            prim_env_done = zb
            E_carry = zb
            rad_resolved = s["rad"]
            vcur_resolved = s["vcur"]

        # ---- segment retirement (path phase) --------------------------
        limit = jnp.minimum(s["maxt"], best_t)
        seg_done = ~phase & (
            (alive & ~testing & (s["t_cur"] > limit)) | walked | timeout
        )
        hitP = seg_done & hit_now
        missP = seg_done & ~hit_now

        # ---- vertex resolve (the gathers; gated lanes read row 0) -----
        slotidx = jnp.clip(s["best_blk"] * bt + s["best_slot"], 0, n_slots - 1)
        tri = grid.slot_tri[jnp.where(hitP, slotidx, 0)]
        row = tri9[jnp.clip(tri, 0, n_faces - 1)]
        tv0, tv1, tv2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
        matid = row[:, 9].astype(jnp.int32)
        # TWO hit points, matching the segment loop exactly: the
        # integrator's poi is the RECOMPUTED Cramer t over the gathered
        # triangle (cramer_t_safe — last-ulp different contraction from
        # the march's bt-wide batch), while the fused NEE's shadow ray
        # originates from the MARCH t (_fused_retire_rearm's poi).
        # Using one for the other flips edge-case bounce topology
        # (measured: 45/366 hits differ by ~1e-6 in t on CPU).
        from ray_tracer_tpu.ops.intersect import cramer_t_safe

        t_re = cramer_t_safe(
            s["o"], s["d"], tv0, tv1, tv2, hitP, det_dtype=jnp.float32
        )
        t_r = jnp.where(hitP, t_re, 0.0)
        o_safe = jnp.where(hitP[:, None], s["o"], 0.0)
        poi_r = o_safe + s["d"] * t_r[:, None]  # integrator vertex
        t_m = jnp.where(hit_now, best_t, 0.0)
        poi_m = s["o"] + s["d"] * t_m[:, None]  # fused-shadow origin
        gn = vm.normalize(vm.cross(tv1 - tv0, tv2 - tv0))
        if fvn9 is not None or textured:
            # hit barycentrics shared by smooth normals and textures
            from ray_tracer_tpu.ops.intersect import cramer_bg_safe

            hb, hg = cramer_bg_safe(
                s["o"], s["d"], tv0, tv1, tv2, hitP,
                det_dtype=jnp.float32,
            )
            alpha = 1.0 - hb - hg
        if fvn9 is not None:
            # smooth normals: Phong-interpolate the face's packed
            # corner normals (one (F,9) row gather) at the recomputed
            # barycentrics — the segment integrator's exact arithmetic
            # (interpolate_normal then a second normalize)
            crow = fvn9[jnp.clip(tri, 0, n_faces - 1)]
            sn = (alpha[:, None] * crow[:, 0:3]
                  + hb[:, None] * crow[:, 3:6]
                  + hg[:, None] * crow[:, 6:9])
            gn = vm.normalize(vm.normalize(sn))
        flip = jnp.sum(gn * s["d"], axis=-1) > 0.0
        n = jnp.where(flip[:, None], -gn, gn)
        if textured:
            urow = fuv7[jnp.clip(tri, 0, n_faces - 1)]
            uv = (alpha[:, None] * urow[:, 0:2]
                  + hb[:, None] * urow[:, 2:4]
                  + hg[:, None] * urow[:, 4:6])
            has_uv = urow[:, 6] > 0.5
            from ray_tracer_tpu.models.scenes import texture_factor

            tex = texture_factor(
                uv, has_uv, hitP,
                "checker" if tex_f32 is None else "image",
                tex_scale, tex_f32, jnp.float32,
            )
            alb = jnp.clip(
                bc255_tab[jnp.clip(matid, 0, n_mats - 1)] * tex, 0.0, 1.0
            )
        else:
            alb = alb_tab[jnp.clip(matid, 0, n_mats - 1)]
        # NEE geometry — the segment integrator's exact expressions
        to_l = light - poi_r
        d2 = jnp.sum(to_l * to_l, axis=-1)
        wl = to_l / jnp.sqrt(jnp.maximum(d2, 1e-20))[:, None]
        cos_i = jnp.maximum(jnp.sum(n * wl, axis=-1), 0.0)
        direct = alb * jnp.float32(_INV_PI) * (
            li * cos_i / jnp.maximum(d2, 1e-20)
        )[:, None]
        pend_new = s["tpt"] * direct
        # ---- Lambertian/mirror branch draw (gi_specular) --------------
        # one deterministic hash draw per (pixel, sample, depth) takes
        # the mirror branch with probability km — the segment
        # integrator's exact u3 salt; forward weights are identically 1
        depth_v0 = s["depth"]
        key_v = s["key0"] + jnp.uint32(_SALT) * (
            s["samp"].astype(jnp.uint32) + 1
        )
        if has_spec:
            km_d = km_tab[jnp.clip(matid, 0, n_mats - 1)]
            u3 = _hash_u01(
                key_v,
                jnp.uint32(0x85EBCA77) * (depth_v0 + 1).astype(jnp.uint32)
                + 13,
            )
            spec_new = hitP & (u3 < km_d)
        else:
            spec_new = zb
        # shadow DIRECTION: the fused-rearm formula from the MARCH poi
        # (visibility topology == the segment loop's fused NEE)
        to_l_m = light - poi_m
        norm = jnp.sqrt(jnp.sum(to_l_m * to_l_m, axis=-1, keepdims=True))
        sdir = to_l_m / jnp.where(norm > 0, norm, 1.0)
        if quirk:  # Serial/raytracer.cpp:106 — away from the light
            sdir = -sdir
        st0, s_entered = _slab_entry(
            grid, poi_m, sdir, jnp.full((w,), jnp.float32(smint)),
            jnp.full((w,), inf),
        )
        # cos_i == 0 makes the contribution an exact zero — skip the
        # shadow march outright (bit-identical; the segment loop's
        # fused NEE marches it and multiplies by the same zero)
        # NEE applies to diffuse vertices only (a point light is
        # unreachable through a delta mirror) — but the DEPTH-0 shadow
        # still marches for spec samples so d0 (shared by every later
        # diffuse sample of the pixel) gets established
        want_nee = hitP & (cos_i > 0.0) & (~spec_new | (depth_v0 == 0))
        shadow_go = want_nee & s_entered
        imm = hitP & ~shadow_go  # NEE resolved without a march: visible
        vspec_v = jnp.where(hitP, spec_new, s["vspec"])
        # diffuse vertices bank the NEE contribution; spec vertices
        # skip it (delta mirror) — but d0 below records it either way
        vcur = vcur_resolved + jnp.where(
            (imm & ~spec_new)[:, None], pend_new, 0.0
        )
        c_imm = jnp.where(imm[:, None], pend_new, 0.0)

        # ---- shadow retirement ----------------------------------------
        sh_done = phase & ((alive & hit_now) | walked | timeout)
        occ = sh_done & hit_now
        nee_add = sh_done & ~occ
        vcur = vcur + jnp.where(
            (nee_add & ~s["vspec"])[:, None], s["pend"], 0.0
        )
        # the vertex's NEE contribution independent of its own branch
        # (d0 is shared by EVERY sample's depth-0, diffuse or not)
        c_vtx = c_imm + jnp.where(nee_add[:, None], s["pend"], 0.0)

        # ---- at-vertex merge (post-NEE) -------------------------------
        # hitP lanes (imm AND shadow-bound) store their fresh vertex;
        # sh_done lanes read back what they stored when entering the
        # shadow march; everyone else passes through
        av = imm | sh_done
        nrm_v = jnp.where(hitP[:, None], n, s["nrm"])
        alb_v = jnp.where(hitP[:, None], alb, s["alb"])
        vpos_v = jnp.where(hitP[:, None], poi_r, s["vpos"])
        # the incident direction must survive the shadow march (the
        # lane's d becomes the SHADOW direction there) — the mirror
        # bounce reflects the staged incident ray, like the segment
        # loop's cur.dirn
        idir_v = jnp.where(hitP[:, None], s["d"], s["idir"])
        # km needs its own current-vertex carry (like nrm/alb/vpos):
        # falling back to km0 here latched a STALE value whenever the
        # depth-0 NEE shadow actually marched (at0 then fired on the
        # shadow-retirement round where hitP is false) — every restart
        # sample drew its branch against the wrong km
        km_v = (jnp.where(hitP, km_d, s["vkm"]) if has_spec else zf)
        depth_v = s["depth"]
        at0 = av & (depth_v == 0)
        d0 = jnp.where(at0[:, None], c_vtx, s["d0"])
        poi0 = jnp.where(at0[:, None], vpos_v, s["poi0"])
        n0 = jnp.where(at0[:, None], nrm_v, s["n0"])
        alb0 = jnp.where(at0[:, None], alb_v, s["alb0"])
        idir0 = jnp.where(at0[:, None], idir_v, s["idir0"])
        km0 = jnp.where(at0, km_v, s["km0"])

        # ---- bounce (vertex depth < D) --------------------------------
        saltd = (depth_v + 1).astype(jnp.uint32)
        key_s = s["key0"] + jnp.uint32(_SALT) * (
            s["samp"].astype(jnp.uint32) + 1
        )
        u1 = _hash_u01(key_s, jnp.uint32(0x1000193) * saltd)
        u2 = _hash_u01(key_s, jnp.uint32(0x5BD1E995) * saltd + 7)
        ndir = _cosine_sample(nrm_v, u1, u2)
        if has_spec:
            # mirror: d' = d - 2(d.n)n off the oriented normal (the
            # segment loop's exact expression, UNnormalized); the
            # mirror branch leaves throughput alone
            mdir = idir_v - 2.0 * jnp.sum(
                idir_v * nrm_v, axis=-1, keepdims=True
            ) * nrm_v
            ndir = jnp.where(vspec_v[:, None], mdir, ndir)
            tpt_b = s["tpt"] * jnp.where(vspec_v[:, None], 1.0, alb_v)
        else:
            tpt_b = s["tpt"] * alb_v
        stb, entb = _slab_entry(
            grid, vpos_v, ndir, jnp.full((w,), jnp.float32(eps)),
            jnp.full((w,), inf),
        )
        bounce = av & (depth_v < D)
        bounce_go = bounce & entb
        bounce_esc = bounce & ~entb
        esc = missP & (depth_v >= 1)
        prim_miss = missP & (depth_v == 0)
        if has_env:
            # defer every escape to next round's merged lookup
            E = (av & (depth_v == D)) | E_carry
        else:
            vcur = vcur + jnp.where(bounce_esc[:, None], tpt_b * bg3, 0.0)
            vcur = vcur + jnp.where(esc[:, None], s["tpt"] * bg3, 0.0)
            E = (av & (depth_v == D)) | bounce_esc | esc | E_carry

        # ---- apply the non-cascade rearms -----------------------------
        new = dict(s)
        new["vcur"] = vcur
        new["rad"] = rad_resolved
        new["d0"], new["poi0"], new["n0"], new["alb0"] = d0, poi0, n0, alb0
        new["nrm"] = nrm_v
        new["alb"] = alb_v
        new["vpos"] = vpos_v
        new["idir"] = idir_v
        new["vspec"] = vspec_v
        new["vkm"] = km_v
        new["idir0"], new["km0"] = idir0, km0
        new["pend"] = jnp.where(shadow_go[:, None], pend_new, s["pend"])
        if has_env:
            # stage this round's escapes: resolved lanes clear, new
            # escapes record their direction + throughput weight
            stage = bounce_esc | esc | prim_miss
            # prim_env_done | E_carry == s["epend"] (they partition it),
            # so every staged escape resolves in exactly one round
            new["epend"] = stage
            new["e0"] = jnp.where(stage, prim_miss, s["e0"])
            new["edir"] = jnp.where(
                bounce_esc[:, None], ndir,
                jnp.where(stage[:, None], s["d"], s["edir"]),
            )
            new["tpt"] = jnp.where(
                bounce_esc[:, None], tpt_b, new["tpt"]
            )  # esc lanes keep their tpt; prim_miss weight is unused

        def rearm(cur, mask, o_n, d_n, t0_n, gate_n, phase_n, depth_n,
                  tpt_n):
            m1 = mask[:, None]
            return dict(
                cur,
                o=jnp.where(m1, o_n, cur["o"]),
                d=jnp.where(m1, d_n, cur["d"]),
                t_cur=jnp.where(mask, t0_n, cur["t_cur"]),
                gate=jnp.where(mask, jnp.float32(gate_n), cur["gate"]),
                maxt=jnp.where(mask, inf, cur["maxt"]),
                best_t=jnp.where(mask, inf, cur["best_t"]),
                best_blk=jnp.where(mask, 0, cur["best_blk"]),
                best_slot=jnp.where(mask, 0, cur["best_slot"]),
                cursor=jnp.where(mask, 0, cur["cursor"]),
                testing=cur["testing"] & ~mask,
                phase=jnp.where(mask, phase_n, cur["phase"]),
                lsteps=jnp.where(mask, 0, cur["lsteps"]),
                depth=jnp.where(mask, depth_n, cur["depth"]),
                tpt=jnp.where(m1, tpt_n, cur["tpt"]),
                alive=cur["alive"] | mask,
            )

        new = rearm(new, shadow_go, poi_m, sdir, st0, eps, True, depth_v,
                    s["tpt"])
        new = rearm(new, bounce_go, vpos_v, ndir, stb, gate_b, False,
                    depth_v + 1, tpt_b)
        # retire lanes that ended a march this round without rearming
        # (they either cascade below or idle for the refill)
        ended = (seg_done | sh_done) & ~shadow_go & ~bounce_go
        new["alive"] = new["alive"] & ~ended
        new["testing"] = new["testing"] & ~ended

        # ---- sample-end cascade (static S unroll) ---------------------
        # each iteration finishes one sample: bank vcur, then restart
        # the next sample from the shared depth-0 vertex — restarts
        # whose bounce escapes immediately loop again, so the cascade
        # fully resolves within the round (no pending states)
        if has_env:
            # depth-0 misses were STAGED above; the resolved ones
            # (prim_env_done) carry their S-folded escape in rad
            pix_done = prim_env_done
        else:
            pix_done = prim_miss
        rad = new["rad"]
        if not has_env:
            # depth-0 miss: EVERY sample sees the background — latch the
            # sequential S-sum (rad is still 0 here; without this the
            # flush scattered 0 over the correctly-initialized row)
            rad = jnp.where(prim_miss[:, None], bg_acc_j, rad)
        vcur = new["vcur"]
        samp = new["samp"]
        for _ in range(S):
            rad = rad + jnp.where(E[:, None], vcur, 0.0)
            samp_n = samp + E.astype(jnp.int32)
            fin = E & (samp_n >= S)
            pix_done = pix_done | fin
            re = E & ~fin
            if D == 0:
                # v_s == d0 for every DIFFUSE sample (a spec draw has
                # no NEE and nothing else at depth 0); no march
                vnext = new["d0"]
                if has_spec:
                    key_r0 = new["key0"] + jnp.uint32(_SALT) * (
                        samp_n.astype(jnp.uint32) + 1
                    )
                    u3r = _hash_u01(key_r0, jnp.uint32(0x85EBCA77) + 13)
                    vnext = jnp.where(
                        (u3r < new["km0"])[:, None], 0.0, vnext
                    )
                vcur = jnp.where(re[:, None], vnext, vcur)
                E = re
                samp = samp_n
                continue
            key_r = new["key0"] + jnp.uint32(_SALT) * (
                samp_n.astype(jnp.uint32) + 1
            )
            u1r = _hash_u01(key_r, jnp.uint32(0x1000193))
            u2r = _hash_u01(key_r, jnp.uint32(0x5BD1E995) + 7)
            ndir_r = _cosine_sample(new["n0"], u1r, u2r)
            if has_spec:
                # this sample's depth-0 branch: mirror reflects the
                # CAMERA ray off the shared depth-0 normal; its v_s
                # starts at 0 (the spec vertex skipped NEE)
                u3r = _hash_u01(key_r, jnp.uint32(0x85EBCA77) + 13)
                spec_r = u3r < new["km0"]
                mdir0 = new["idir0"] - 2.0 * jnp.sum(
                    new["idir0"] * new["n0"], axis=-1, keepdims=True
                ) * new["n0"]
                ndir_r = jnp.where(spec_r[:, None], mdir0, ndir_r)
                tpt_r = jnp.where(spec_r[:, None], 1.0, new["alb0"])
                v0_r = jnp.where(spec_r[:, None], 0.0, new["d0"])
            else:
                spec_r = zb
                tpt_r = new["alb0"]
                v0_r = new["d0"]
            str_, entr = _slab_entry(
                grid, new["poi0"], ndir_r,
                jnp.full((w,), jnp.float32(eps)), jnp.full((w,), inf),
            )
            goes = re & entr
            esc_r = re & ~entr
            vcur = jnp.where(re[:, None], v0_r, vcur)
            if has_env:
                # the restart-escape defers to the next merged lookup
                new["epend"] = new["epend"] | esc_r
                new["e0"] = jnp.where(esc_r, False, new["e0"])
                new["edir"] = jnp.where(esc_r[:, None], ndir_r,
                                        new["edir"])
                new["tpt"] = jnp.where(esc_r[:, None], tpt_r,
                                       new["tpt"])
                E = zb
            else:
                vcur = vcur + jnp.where(
                    esc_r[:, None], tpt_r * bg3, 0.0
                )
                E = esc_r
            new = rearm(new, goes, new["poi0"], ndir_r, str_, gate_b,
                        False, jnp.ones_like(samp), tpt_r)
            new["vspec"] = jnp.where(goes, spec_r, new["vspec"])
            new["idir"] = jnp.where(goes[:, None], ndir_r, new["idir"])
            samp = samp_n
        new["rad"] = rad
        new["vcur"] = vcur
        new["samp"] = samp

        # ---- latch finished pixels ------------------------------------
        new["done_acc"] = new["done_acc"] | pix_done
        new["rl0"] = jnp.where(pix_done, rad[:, 0], new["rl0"])
        new["rl1"] = jnp.where(pix_done, rad[:, 1], new["rl1"])
        new["rl2"] = jnp.where(pix_done, rad[:, 2], new["rl2"])
        new["alive"] = new["alive"] & ~pix_done
        new["testing"] = new["testing"] & ~pix_done
        return new

    def body(s):
        pre_alive = s["alive"]
        for _ in range(pump):
            s = _march_step(
                s, o=s["o"], d=s["d"], invd=1.0 / s["d"], gate=s["gate"],
                maxt=s["maxt"], grid=grid, meta=meta,
            )
        s = dict(s, lsteps=s["lsteps"] + jnp.where(pre_alive, pump, 0))
        s = transition(s, pre_alive)
        # ---- one scatter per round flushes the latches ----------------
        flushed = s["done_acc"]
        idx = jnp.where(
            flushed, s["ray_id"], qn + jnp.arange(w, dtype=jnp.int32)
        )
        s = dict(
            s,
            done_acc=zb,
            out0=s["out0"].at[idx].set(s["rl0"], unique_indices=True),
            out1=s["out1"].at[idx].set(s["rl1"], unique_indices=True),
            out2=s["out2"].at[idx].set(s["rl2"], unique_indices=True),
        )
        s = refill(s)
        return dict(s, i=s["i"] + 1)

    out = jax.lax.while_loop(cond, body, state)
    return jnp.stack([out["out0"][:qn], out["out1"][:qn], out["out2"][:qn]],
                     axis=-1)
