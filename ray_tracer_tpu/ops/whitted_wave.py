"""Cross-depth Whitted wave: mirror recursion inside ONE persistent
while_loop.

The production renderer serves the reference's mirror recursion
(Parallel/raytracer.cu:508-520) as a per-depth loop: each depth runs a
fused primary+shadow persistent trace over the FULL ray batch, then a
dense shading epilogue — bounce batches past depth 1 are ~95% dead
lanes paying queue sweeps and epilogue arithmetic.  This module is the
Whitted twin of the GI wave (ops/gi_wave.py): a lane pops a PIXEL and
serves its whole recursion in place —

    primary march -> shadow -> shade -> mirror bounce -> shadow -> ...
    -> ONE color scatter

— with the Blinn-Phong shading of each vertex evaluated at retirement
on the lanes that retire (the reference formulas verbatim:
ops/shade.shade_serial / shade_parallel, both variants' normal
conventions, the `color*base*(1-km) + recurse*km` blend, the shadow
direction quirk and mints from the ONE shared policy).

The blend accumulates FORWARD (carry weight w = product of km's;
col += w * local_d) instead of the renderer's deepest-first fold — the
same sum in a different float association, so images match the
bounce-loop renderer to last-ulp association error, not bitwise.
FORWARD-ONLY and opt-in (RenderConfig.whitted_wave; bench.py and
--turbo use "auto"), same contract as the GI wave.

Serial-variant zero-direct shadow skip is EXACT here: the wave tests
the very A-term it will shade with (the bounce-loop's skip_dead_shadow
needs a conservative margin because it recomputes the normal).
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


# Shared arithmetic — ONE definition each (core/vecmath, ops/shade),
# so the wave's shading cannot drift from the renderer's.
from ray_tracer_tpu.core import vecmath as vm
from ray_tracer_tpu.ops.shade import _pow_safe


def build_wave_tables(scene):
    """(mat9, tri9) for whitted_wave_trace from a Scene — the ONE
    builder shared by the single-device dispatch and the sharded
    branch."""
    v0, v1, v2 = scene.triangle_soa()
    tri9 = jnp.concatenate(
        [v0, v1, v2, scene.face_material.astype(v0.dtype)[:, None]], axis=1
    )
    m = scene.materials
    mat9 = jnp.stack(
        [m.base_color[:, 0], m.base_color[:, 1], m.base_color[:, 2],
         m.kd, m.ks, m.spec_alpha, m.ka, m.km,
         m.reflective.astype(jnp.float32)], axis=1
    )
    return mat9, tri9


@partial(
    jax.jit,
    static_argnames=(
        "meta", "camera", "max_bounces", "serial", "spp", "wave", "pump",
        "gate0", "gate_b", "eps", "smint", "quirk", "shadow_scale", "bg",
        "refill_retries", "max_iters", "pix_stride", "queue_len",
    ),
)
def whitted_wave_trace(
    light_pos: jnp.ndarray,
    light_intensity: jnp.ndarray,
    mat9: jnp.ndarray,
    tri9: jnp.ndarray,
    grid: PackedGridArrays,
    meta: PackedGridMeta,
    *,
    camera,
    max_bounces: int,
    serial: bool,
    spp: int = 1,
    wave: int = 12288,
    pump: int = 1,
    gate0: float = 0.0,
    gate_b: float = 1e-4,
    eps: float = 1e-4,
    smint: float = 1e-4,
    quirk: bool = False,
    shadow_scale: float = 0.5,
    bg: tuple = (0.0, 0.0, 0.0),
    refill_retries: int = 3,
    max_iters=None,
    pix_offset=None,
    pix_stride: int = 1,
    queue_len=None,
) -> jnp.ndarray:
    """Whitted-shaded color per pixel -> (H*W, 3) f32.

    mat9: (M, 9) material rows [base r, g, b, kd, ks, spec_alpha, ka,
    km, reflective]; tri9: (F, 10) packed triangle rows with the
    material index in lane 9 (the renderer's layout).

    spp > 1: the queue holds H*W*spp^2 SUBSAMPLE items (camera_ray_at's
    subsample-major index = s*H*W + pixel) and the per-subsample colors
    fold subsample-major after the loop — the same sequential
    accumulation order as renderer.accumulate_spp, so the anti-aliased
    image matches the bounce-loop renderer the usual way.

    pix_offset/pix_stride/queue_len (the SHARDED queue, round 5 cont.):
    queue position k serves GLOBAL pixel pix_offset + k*pix_stride —
    pure index arithmetic, so a shard_map shard regenerates ITS pixels
    (contiguous slices or the round-robin balance striding) with zero
    gathers and the per-pixel results stay identical to the
    single-device wave.  Output is (queue_len, 3) in queue order;
    positions mapping past the real pixel count are dead (their rows
    hold the background).  pix_offset may be traced (lax.axis_index).
    Requires spp == 1."""
    r = camera.width * camera.height * spp * spp
    sharded = pix_offset is not None
    if sharded:
        assert spp == 1, "the sharded wave queue serves spp == 1"
    qn = queue_len if queue_len is not None else r
    off = (jnp.asarray(0, jnp.int32) if pix_offset is None
           else pix_offset.astype(jnp.int32))
    w = min(wave, qn)
    bt = meta.block_tris
    n_slots = grid.slot_tri.shape[0]
    n_faces = tri9.shape[0]
    n_mats = mat9.shape[0]
    inf = jnp.float32(_INF)
    light = light_pos.astype(jnp.float32)
    li = light_intensity.astype(jnp.float32)
    bg3 = jnp.asarray(bg, jnp.float32)
    scale = jnp.float32(shadow_scale)

    from ray_tracer_tpu.ops.traverse_packed import _default_max_steps

    # per-SEGMENT lane-step bound (see ops/gi_wave.py): boundary-creep
    # lanes retire as their best-so-far instead of spinning the wave
    seg_bound = _default_max_steps(meta)
    if max_iters is None:
        per_ray = seg_bound * 2 * (max_bounces + 1)
        max_iters = -(-qn * per_ray // w) + per_ray + 64
    max_rounds = -(-max_iters // pump)

    # Under shard_map every while_loop carry leaf must enter with one
    # uniform varying-axes type (the persistent wave's rule): pcast the
    # round constants AND the assembled state up to the inputs' union.
    from ray_tracer_tpu.parallel.collectives import pcast_varying, vma_union

    _want = vma_union((light_pos, light_intensity, mat9, tri9, grid, off))
    zf = pcast_varying(jnp.zeros((w,), jnp.float32), _want)
    zi = zf.astype(jnp.int32)
    zb = zi != 0
    z3 = jnp.zeros((w, 3), jnp.float32) + zf[:, None]

    state = dict(
        o=z3, d=jnp.ones((w, 3), jnp.float32),
        alive=zb, testing=zb,
        t_cur=zf, t_exit_cell=zf,
        first_blk=zi, n_blk=zi, cursor=zi,
        best_t=zf + inf, best_blk=zi, best_slot=zi,
        gate=zf, maxt=zf,
        ray_id=jnp.full((w,), qn, jnp.int32),
        phase=zb,            # False = path segment, True = shadow
        lsteps=zi,           # steps in the CURRENT segment (seg_bound)
        depth=zi,
        col=z3,              # accumulated pixel color
        wgt=jnp.ones((w,), jnp.float32),  # km-product weight
        # staged vertex data (set at hit resolve, consumed post-shadow)
        pA=z3,               # shadow-scaled shading term
        pB=z3,               # shadow-independent term (serial ambient)
        tint=z3,             # base_color (the reflective blend's tint)
        km=zf,
        refl_go=zb,          # reflecting = hit & reflective & depth < MB
        nrm=z3,              # UNNORMALIZED variant normal (bounce dir)
        vpos=z3,             # recomputed-t hit point (bounce origin)
        idir=z3,             # incident segment direction (reflect input)
        done_acc=zb,
        rl0=zf, rl1=zf, rl2=zf,
        out0=jnp.full((qn + w,), float(bg[0]), jnp.float32),
        out1=jnp.full((qn + w,), float(bg[1]), jnp.float32),
        out2=jnp.full((qn + w,), float(bg[2]), jnp.float32),
        next=jnp.asarray(0, jnp.int32),
        i=jnp.asarray(0, jnp.int32),
    )

    def pop_once(s):
        """Idle lanes pop the next unserved pixels (the deterministic
        cumsum queue) and regenerate their camera ray from the index —
        pure arithmetic, ZERO gathers (a bitset-of-live-pixels variant
        lost on the previous chip: its per-attempt (W,) bool gather
        cost as much as a whole row fetch)."""
        idle = ~s["alive"]
        order = jnp.cumsum(idle.astype(jnp.int32))
        new_id = jnp.where(idle, s["next"] + order - 1, s["ray_id"])
        got = idle & (new_id < qn)
        rid = jnp.where(got, new_id, jnp.where(idle, qn, s["ray_id"]))
        # queue position -> GLOBAL pixel: pure index arithmetic, so a
        # shard regenerates its own slice/stride with zero gathers
        gid = off + rid * pix_stride
        valid = got & (gid < r)  # positions past the real pixel count
        gen = camera_ray_at(camera, jnp.clip(gid, 0, r - 1), spp=spp)
        o = jnp.where(got[:, None], gen.orig.astype(jnp.float32), s["o"])
        d = jnp.where(got[:, None], gen.dirn.astype(jnp.float32), s["d"])
        t0, entered = _slab_entry(
            grid, o, d, gen.mint.astype(jnp.float32),
            gen.maxt.astype(jnp.float32),
        )
        live = valid & entered
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
            col=jnp.where(got[:, None], 0.0, s["col"]),
            wgt=jnp.where(got, 1.0, s["wgt"]),
            next=jnp.minimum(s["next"] + order[-1], qn),
        )

    def refill(s):
        for _ in range(1 + refill_retries):
            s = pop_once(s)
        return s

    if _want:
        state = pcast_varying(state, _want)
    state = refill(state)

    def cond(s):
        return (s["i"] < max_rounds) & (
            jnp.any(s["alive"]) | (s["next"] < qn)
        )

    def transition(s, pre_alive):
        alive, testing = s["alive"], s["testing"]
        best_t = s["best_t"]
        hit_now = jnp.isfinite(best_t)
        walked = pre_alive & ~alive
        phase = s["phase"]
        timeout = alive & (s["lsteps"] > seg_bound)

        # ---- segment retirement --------------------------------------
        limit = jnp.minimum(s["maxt"], best_t)
        seg_done = ~phase & (
            (alive & ~testing & (s["t_cur"] > limit)) | walked | timeout
        )
        hitP = seg_done & hit_now
        missP = seg_done & ~hit_now

        # ---- vertex resolve (the round's gathers) --------------------
        slotidx = jnp.clip(s["best_blk"] * bt + s["best_slot"], 0, n_slots - 1)
        tri = grid.slot_tri[jnp.where(hitP, slotidx, 0)]
        row = tri9[jnp.clip(tri, 0, n_faces - 1)]
        tv0, tv1, tv2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
        matid = row[:, 9].astype(jnp.int32)
        m = mat9[jnp.clip(matid, 0, n_mats - 1)]
        base = m[:, 0:3]
        kd, ks, alpha, ka, km_m, refl = (
            m[:, 3], m[:, 4], m[:, 5], m[:, 6], m[:, 7], m[:, 8] > 0.5
        )
        # recomputed-t hit point for shading/bounce, march-t point for
        # the fused shadow origin — the renderer's exact split (the
        # shading recomputes t differentiably; the fused rearm uses the
        # march's poi)
        from ray_tracer_tpu.ops.intersect import cramer_t_safe

        t_re = cramer_t_safe(
            s["o"], s["d"], tv0, tv1, tv2, hitP, det_dtype=jnp.float32
        )
        t_r = jnp.where(hitP, t_re, 0.0)
        o_safe = jnp.where(hitP[:, None], s["o"], 0.0)
        poi_r = o_safe + s["d"] * t_r[:, None]
        t_m = jnp.where(hit_now, best_t, 0.0)
        poi_m = s["o"] + s["d"] * t_m[:, None]
        if serial:  # getNormalMod, Serial/geometry.h:234-240
            n = vm.cross(tv0 - tv1, tv2 - tv0)
        else:  # Parallel/geometry.cuh:160
            n = vm.cross(tv2 - tv1, tv0 - tv1)
        view = vm.normalize(-s["d"])
        l = vm.normalize(light - poi_r)
        # Blinn-Phong per variant (ops/shade.py verbatim): serial keeps
        # h UNnormalized (raytracer.cpp:95), parallel normalizes
        h = (view + l) if serial else vm.normalize(view + l)
        ndl = jnp.maximum(0.0, jnp.sum(n * l, axis=-1))
        ndh = jnp.maximum(0.0, jnp.sum(n * h, axis=-1))
        if serial:
            diffuse = base * (kd * ndl)[:, None] * li
            specular = base * (ks * _pow_safe(ndh, alpha))[:, None] * li
            A = specular + diffuse  # shade_direct_serial's add order
            B = base * ka[:, None]  # ambient added AFTER the shadow
        else:
            diffuse = base * ndl[:, None] * kd[:, None]
            specular = base * _pow_safe(ndh, alpha)[:, None] * ks[:, None]
            # the parallel variant's shadow scales ambient too
            A = (diffuse + specular) + base * ka[:, None]
            B = jnp.zeros_like(A)
        refl_go = hitP & refl & (s["depth"] < max_bounces)

        # shadow ray (fused-rearm formula from the march poi)
        to_l_m = light - poi_m
        norm = jnp.sqrt(jnp.sum(to_l_m * to_l_m, axis=-1, keepdims=True))
        sdir = to_l_m / jnp.where(norm > 0, norm, 1.0)
        if quirk:  # Serial/raytracer.cpp:106
            sdir = -sdir
        st0, s_entered = _slab_entry(
            grid, poi_m, sdir, jnp.full((w,), jnp.float32(smint)),
            jnp.full((w,), inf),
        )
        if serial:
            # EXACT zero-direct skip: ambient lands after the shadow
            # scale, so A == 0 makes occlusion irrelevant — and this IS
            # the A the shade will use, no conservative margin needed
            want_sh = hitP & jnp.any(A != 0.0, axis=-1)
        else:
            want_sh = hitP
        shadow_go = want_sh & s_entered
        imm = hitP & ~shadow_go  # unoccluded without a march

        # ---- shadow retirement ---------------------------------------
        sh_done = phase & ((alive & hit_now) | walked | timeout)
        occ = sh_done & hit_now

        # ---- at-vertex (post-shadow) shading + blend -----------------
        av = imm | sh_done
        A_v = jnp.where(hitP[:, None], A, s["pA"])
        B_v = jnp.where(hitP[:, None], B, s["pB"])
        tint_v = jnp.where(hitP[:, None], base, s["tint"])
        km_v = jnp.where(hitP, km_m, s["km"])
        rgo_v = jnp.where(hitP, refl_go, s["refl_go"])
        nrm_v = jnp.where(hitP[:, None], n, s["nrm"])
        vpos_v = jnp.where(hitP[:, None], poi_r, s["vpos"])
        # the incident direction must survive the shadow march (the
        # lane's d becomes the SHADOW direction there) — reflect always
        # takes the staged incident ray, like the renderer's cur.dirn
        idir_v = jnp.where(hitP[:, None], s["d"], s["idir"])
        color_v = jnp.where(occ[:, None], A_v * scale, A_v) + B_v
        local = jnp.where(
            rgo_v[:, None],
            color_v * tint_v * (1.0 - km_v)[:, None],
            color_v,
        )
        col = s["col"] + jnp.where(av[:, None], s["wgt"][:, None] * local,
                                   0.0)
        # miss: the depth's local term is the background
        col = col + jnp.where(missP[:, None], s["wgt"][:, None] * bg3, 0.0)
        wgt = jnp.where(av & rgo_v, s["wgt"] * km_v, s["wgt"])

        # ---- mirror bounce -------------------------------------------
        # rdir = normalize(reflect(normalize(incident), normalize(n)))
        nd = vm.normalize(idir_v)
        nn = vm.normalize(nrm_v)
        rdir = vm.normalize(
            nd - nn * (2.0 * jnp.sum(nd * nn, axis=-1))[:, None]
        )
        stb, entb = _slab_entry(
            grid, vpos_v, rdir, jnp.full((w,), jnp.float32(eps)),
            jnp.full((w,), inf),
        )
        bounce_go = av & rgo_v & entb
        bounce_esc = av & rgo_v & ~entb
        # an off-grid bounce is next depth's miss: local = bg
        col = col + jnp.where(bounce_esc[:, None], wgt[:, None] * bg3, 0.0)

        pix_done = missP | (av & ~bounce_go)

        new = dict(s)
        new["col"] = col
        new["wgt"] = wgt
        new["pA"], new["pB"] = A_v, B_v
        new["tint"], new["km"], new["refl_go"] = tint_v, km_v, rgo_v
        new["nrm"], new["vpos"] = nrm_v, vpos_v
        new["idir"] = idir_v

        def rearm(cur, mask, o_n, d_n, t0_n, gate_n, phase_n, depth_n):
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
                alive=cur["alive"] | mask,
            )

        new = rearm(new, shadow_go, poi_m, sdir, st0, eps, True,
                    s["depth"])
        new = rearm(new, bounce_go, vpos_v, rdir, stb, gate_b, False,
                    s["depth"] + 1)
        ended = (seg_done | sh_done) & ~shadow_go & ~bounce_go
        new["alive"] = new["alive"] & ~ended
        new["testing"] = new["testing"] & ~ended

        new["done_acc"] = new["done_acc"] | pix_done
        new["rl0"] = jnp.where(pix_done, col[:, 0], new["rl0"])
        new["rl1"] = jnp.where(pix_done, col[:, 1], new["rl1"])
        new["rl2"] = jnp.where(pix_done, col[:, 2], new["rl2"])
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
    col = jnp.stack([out["out0"][:qn], out["out1"][:qn], out["out2"][:qn]],
                    axis=-1)
    if spp > 1:
        # sequential subsample-major accumulation — accumulate_spp's
        # exact association (acc = c0; acc += c1; ...) then the mean
        ss = spp * spp
        px = camera.width * camera.height
        parts = col.reshape(ss, px, 3)
        acc = parts[0]
        for j in range(1, ss):
            acc = acc + parts[j]
        col = acc / jnp.float32(ss)
    return col
