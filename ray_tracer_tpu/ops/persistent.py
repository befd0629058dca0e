"""Persistent wave march: ONE while_loop for the whole ray batch.

The tiled scheduler (render/renderer.py + lax.map) pays two costs: a
fixed setup per while_loop instance (4,096 instances/frame at 1024^2)
and tile-tail divergence (a 512-lane lock-step tile retires at its
slowest lane).  This module is the dense translation of the CUDA
reference's persistent
threads (Parallel/raytracer.cu:177-233: an infinite per-thread loop
popping rays from a global atomic work queue): a fixed WAVE of W lanes
marches in lock-step inside a single `lax.while_loop`, and the atomic
queue becomes a cumsum prefix —

  * every lane serves one ray through the shared `_march_step` DDA core
    (ops/traverse_packed.py);
  * when a lane's primary march retires it can REARM in place as its
    own shadow ray (the fused wavefront trick), and when the ray is
    fully done the lane SCATTERS its result row at the ray's index and
    POPS the next ray: new_id = next + cumsum(idle) - 1 — the
    deterministic, race-free equivalent of atomicInc on a work queue
    (raytracer.cu:49);
  * rays that miss the grid AABB entirely are rejected at refill time
    and never occupy a lane: the output buffers are miss-initialized,
    so an empty-sky ray costs one refill slot instead of a tile's worth
    of lock-step waiting.

No entry sort, no unsort permutation, no per-tile loop setup: occupancy
stays near 100% because a retiring lane is refilled on the SAME
iteration.  Forward-only (a stop-gradient island, like every traversal
here); the renderer recomputes differentiable quantities from the
returned hit topology.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ray_tracer_tpu.accel.packed import PackedGridArrays, PackedGridMeta
from ray_tracer_tpu.core.rays import RayBatch
from ray_tracer_tpu.ops.camera import camera_ray_at
from ray_tracer_tpu.ops.traverse_packed import (
    FusedTraceResult,
    _default_max_steps,
    _fused_retire_rearm,
    _march_step,
    _primary_exhausted,
    _slab_entry,
)

_INF = float("inf")


def _pack_rays(rays: RayBatch) -> jnp.ndarray:
    """(R+1, 8) f32 rows [o xyz, d xyz, mint, maxt]; row R is the
    never-entering pad popped by lanes with no work left."""
    rows = jnp.concatenate(
        [
            rays.orig.astype(jnp.float32),
            rays.dirn.astype(jnp.float32),
            rays.mint.astype(jnp.float32)[:, None],
            rays.maxt.astype(jnp.float32)[:, None],
        ],
        axis=1,
    )
    pad = jnp.asarray([[0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 0.0, -1.0]], jnp.float32)
    return jnp.concatenate([rows, pad])


@partial(
    jax.jit,
    static_argnames=(
        "meta", "wave", "t_gate", "fuse_shadow", "shadow_gate", "shadow_mint",
        "serial_quirk", "stop_on_first_hit", "max_iters", "return_iters",
        "need_shadow_tri", "need_steps", "need_t", "camera", "spp", "pump",
        "compact", "order_classes", "refill_retries", "shadow_skip_dead",
        "shade_serial", "probe_chain",
    ),
)
def persistent_trace(
    rays: RayBatch,
    grid: PackedGridArrays,
    meta: PackedGridMeta,
    light_pos: Optional[jnp.ndarray] = None,
    *,
    wave: int = 65536,
    t_gate: float = 0.0,
    fuse_shadow: bool = False,
    shadow_gate: float = 1e-4,
    shadow_mint: float = 1e-4,
    serial_quirk: bool = False,
    stop_on_first_hit: bool = False,
    max_iters: Optional[int] = None,
    return_iters: bool = False,
    need_shadow_tri: bool = False,
    need_steps: bool = False,
    need_t: bool = True,
    camera=None,
    spp: int = 1,
    pump: int = 1,
    compact: bool = False,
    order_keys: Optional[jnp.ndarray] = None,
    order_classes: int = 4,
    refill_retries: Optional[int] = None,
    shadow_skip_dead: bool = False,
    shade_serial: bool = False,
    probe_chain: int = 1,
) -> FusedTraceResult:
    """March every ray of `rays` through the packed grid with a W-lane
    persistent wave; optionally fuse each ray's shadow query.

    Returns (R,)-aligned FusedTraceResult.  With fuse_shadow=False the
    shadow fields are all-clear and `light_pos` is unused.

    Every output beyond the hit code costs one extra 1-D scatter per
    round, so they are opt-in: shadow_tri_id is -1 everywhere unless
    need_shadow_tri (the renderer enables it only for soft-visibility),
    steps is 0 unless need_steps, and t is a 0/inf hit placeholder
    unless need_t — the renderer recomputes t differentiably from the
    returned hit topology, so the production path never pays for it
    (tests and AOV/debug consumers pass need_t=True).

    `pump` runs that many march steps per scatter+refill round: the
    scatter and refill costs amortize over `pump` steps, at the price
    of retired lanes idling until the round ends (rays average only a
    handful of steps, so a large pump loses occupancy).  Results are invariant to `pump` — a retiring
    lane's record is latched per-lane the step it finishes and only
    the scatter is deferred.

    `compact`: pre-filter the work queue with one vectorized slab test
    over the whole batch — rays that can never enter the grid (sky
    rays missing the scene AABB, dead bounce lanes with inf origins)
    are dropped from the queue entirely instead of being popped-and-
    rejected one wave at a time.  The queue then holds compacted ray
    ids; the camera-regen refill regenerates ray work_ids[k], the
    gather refill fetches its row.  A sparse or mostly-dead batch
    (sky-heavy primaries; reflection segments past depth 1, where the
    queue sweep of R ids at W pops/round dominates) finishes in
    ~ceil(live/W) pop rounds instead of ceil(R/W).  Output is
    bit-identical: each ray's march is lane-independent and results
    scatter by ray id.

    `order_keys` (an (R,) float array): pop rays in ASCENDING key order
    instead of arrival order.  The scheduling fix for the lock-step
    straggler tail: a FIFO queue leaves the longest walks (dense hit
    rays, p99 ~30-70 steps vs mean ~4) to START near frame end, when
    the queue is dry and most of the wave idles behind them (measured
    64.7% slot occupancy on spot 1024^2, 82.4% on nefertiti).  Keying
    hard-rays-first overlaps the stragglers' walks with everyone
    else's work — the same reason the CUDA reference popped its queue
    in generation order only by accident of atomicInc arrival
    (Parallel/raytracer.cu:193-232).  Output is bit-identical for any
    order (lane-independent marches, results scatter by ray id).
    Composes with `compact` (never-entering rays sort last AND the
    queue length shrinks to the live count).

    `refill_retries`: extra pop attempts per refill for lanes whose
    popped ray failed the entry slab test.  THE dead-ray scheduling
    fix for the camera-regen path: ~50% of a tight-AABB scene's camera
    rays never enter the grid, and a single-pop refill charges each
    one a full round of its lane (176 -> 127 rounds on spot 1024^2
    from compaction alone — but on the previous chip compaction's
    per-round work_ids gather cost more than the rounds it saved;
    retries drain dead rays with arithmetic re-pops instead).
    None = auto: 3 with camera regen (re-pops are arithmetic; the
    previous chip's knee, not yet tuned on the H100), 0 for the
    gather-refill path (each attempt re-gathers (W,8) rows).  Bit-identical output for any value
    (results scatter by ray id).
    """
    r = rays.count
    w = min(wave, r)
    bt = meta.block_tris
    n_slots = grid.slot_tri.shape[0]
    assert n_slots < (1 << 30), "slot index must fit in 30 bits"
    if fuse_shadow:
        assert light_pos is not None, "fuse_shadow needs light_pos"
        # stop_on_first_hit retires the primary at an ARBITRARY accepted
        # triangle (block-row order), so the rearmed shadow origin would
        # be a surface the ray may never reach — reject the combination
        assert not stop_on_first_hit, (
            "stop_on_first_hit (any-hit) cannot be fused with shadow "
            "rearm: the rearm point must be the NEAREST hit"
        )
    inf = jnp.float32(_INF)
    per_ray = _default_max_steps(meta) * (2 if fuse_shadow else 1)
    if max_iters is None:
        # total lane-work / wave width, plus one straggler's full walk
        max_iters = -(-r * per_ray // w) + per_ray + 8
    # With a static `camera`, popped rays are REGENERATED from their
    # index (camera_ray_at — pure arithmetic, bitwise == camera_rays)
    # instead of gathered from an (R, 8) device table; `rays` then only
    # supplies the count.  The gather refill path serves shadow/bounce
    # batches whose rays exist only as data.
    packed = None if camera is not None else _pack_rays(rays)
    if camera is not None:
        assert r == camera.width * camera.height * spp * spp
    light = (jnp.zeros((3,), jnp.float32) if light_pos is None
             else light_pos.astype(jnp.float32))

    if compact or order_keys is not None:
        # live-first work queue: one slab test over the batch, then a
        # cumsum scatter of the surviving ray ids to the queue front
        # (or, with order_keys, one argsort that both orders the live
        # rays and pushes the dead ones past n_work).
        # With a static camera the batch is REGENERATED for the test so
        # the "rays only supplies the count" contract holds for compact
        # too (the caller's placeholder rows are never read).
        if camera is not None:
            _gen = camera_ray_at(
                camera, jnp.arange(r, dtype=jnp.int32), spp=spp
            )
            _o, _d = _gen.orig, _gen.dirn
            _mint, _maxt = _gen.mint, _gen.maxt
        else:
            _o, _d = rays.orig, rays.dirn
            _mint, _maxt = rays.mint, rays.maxt
        _, live = _slab_entry(
            grid,
            _o.astype(jnp.float32), _d.astype(jnp.float32),
            _mint.astype(jnp.float32), _maxt.astype(jnp.float32),
        )
        if order_keys is not None:
            key = jnp.where(live, order_keys.astype(jnp.float32), jnp.inf)
            # M-CLASS stable counting sort, not a full argsort: a 1M-key
            # argsort cost more than the occupancy it buys back on the
            # previous chip.  Straggler overlap only needs the
            # long walks to START early, so a handful of difficulty
            # classes (linear quantization over the live key range;
            # dead rays in the last class) captures the win with
            # M+1 cumsums + one scatter — the compact path's cost class.
            M = order_classes
            finite = jnp.isfinite(key)
            kmin = jnp.min(jnp.where(finite, key, jnp.inf))
            kmax = jnp.max(jnp.where(finite, key, -jnp.inf))
            span = jnp.maximum(kmax - kmin, jnp.float32(1e-20))
            q = jnp.clip(((key - kmin) / span * M).astype(jnp.int32), 0, M - 1)
            q = jnp.where(finite, q, M)  # never-entering rays pop last
            ranks = jnp.zeros((r,), jnp.int32)
            base = jnp.asarray(0, jnp.int32)
            for c in range(M + 1):
                m = q == c
                pos = jnp.cumsum(m.astype(jnp.int32)) - 1
                ranks = jnp.where(m, base + pos, ranks)
                base = base + pos[-1] + 1
            work_ids = jnp.zeros((r,), jnp.int32).at[ranks].set(
                jnp.arange(r, dtype=jnp.int32), unique_indices=True
            )
            n_work = (finite.sum().astype(jnp.int32) if compact
                      else jnp.asarray(r, jnp.int32))
        else:
            pos = jnp.cumsum(live.astype(jnp.int32)) - 1
            buf = jnp.full((r + 1,), r, jnp.int32)
            # dead rays all land on dump row r (colliding writes are fine)
            buf = buf.at[jnp.where(live, pos, r)].set(
                jnp.arange(r, dtype=jnp.int32)
            )
            work_ids = buf[:r]
            n_work = pos[-1] + 1
    else:
        work_ids = None
        n_work = jnp.asarray(r, jnp.int32)

    # NEGATIVE RESULT on the previous chip (kept so it is not retried
    # blindly): baking the compaction/order INTO the ray table — queue
    # position k's row pre-gathered to hold ray work_ids[k] plus its
    # id, so pops skip the work_ids indirection — lost on every
    # workload there.  It pays a full R-row table build PER SEGMENT,
    # which dwarfs what it saves: the mostly-dead bounce batches it
    # would serve have few LIVE pops, and full primaries' dead pops
    # only shorten the queue drain, not the straggler-bound tail.  The
    # work_ids indirection below costs an O(R) 1-D build + one extra
    # (W,) int gather per refill, paid only on live pops.

    # Under shard_map every while_loop carry leaf must have one uniform
    # varying-axes type; fresh constants (queue cursor, output buffers,
    # per-round latch resets) enter unvarying while ray-derived leaves
    # vary over the mesh axes (identity outside shard_map).
    from ray_tracer_tpu.parallel.collectives import pcast_varying, vma_union

    _want = vma_union((rays, grid, light))
    zf = pcast_varying(jnp.zeros((w,), jnp.float32), _want)
    zi = zf.astype(jnp.int32)
    zb = zi != 0

    state = dict(
        # lane ray state
        o=jnp.zeros((w, 3), jnp.float32),
        d=jnp.ones((w, 3), jnp.float32),
        maxt=zf,
        gate=zf,
        ray_id=jnp.full((w,), r, jnp.int32),  # r = the pad row (no ray)
        # march state (see traverse_packed._march_step)
        alive=zb, testing=zb,
        t_cur=zf, t_exit_cell=zf,
        first_blk=zi, n_blk=zi, cursor=zi,
        best_t=zf + inf, best_blk=zi, best_slot=zi,
        # fused-only state: the shadow phase flag and the parked primary
        # record exist only when the rearm can happen
        **({"phase": zb, "p_best_t": zf + inf, "p_best_blk": zi,
            "p_best_slot": zi} if fuse_shadow else {}),
        # the winning triangle rides the carry (no reset at refill
        # needed: it is only read when hit_now, which implies an upd
        # since the lane's best_t was re-inf'd)
        **({"best_tri9": jnp.zeros((w, 9), jnp.float32)}
           if (fuse_shadow and shadow_skip_dead) else {}),
        lane_steps=zi,
        # per-lane emit latch: a lane that finishes mid-round parks its
        # record here; the round's ONE scatter flushes all latches
        done_acc=zb,
        code_l=jnp.full((w,), -1, jnp.int32),
        **({"t_l": zf + inf} if need_t else {}),
        **({"stri_l": jnp.full((w,), -1, jnp.int32)} if need_shadow_tri else {}),
        **({"steps_l": zi} if need_steps else {}),
        # Global queue cursor + output buffers (miss-initialized).  The
        # buffers carry W dump rows at the tail — one PER LANE — so every
        # scatter in the body has provably unique indices (done lanes
        # write their distinct ray_id, idle lanes their own dump row),
        # which keeps XLA on the fast scatter lowering.  All buffers are
        # 1-D (an (N,4) row scatter cost 8x a 1-D one on the previous
        # chip), so the hit record is packed into one int32 code =
        # slot_index | shadow<<30 and the triangle id is resolved AFTER
        # the loop with one gather.
        next=jnp.asarray(0, jnp.int32),
        **({"out_t": jnp.full((r + w,), inf, jnp.float32)} if need_t else {}),
        out_code=jnp.full((r + w,), -1, jnp.int32),
        i=jnp.asarray(0, jnp.int32),
        **(
            {"out_stri": jnp.full((r + w,), -1, jnp.int32)}
            if need_shadow_tri else {}
        ),
        **(
            {"out_steps": jnp.zeros((r + w,), jnp.int32)}
            if need_steps else {}
        ),
    )

    if refill_retries is None:
        # the previous chip's knee on spot 1024^2 (camera regen); not
        # yet tuned on the H100
        refill_retries = 3 if camera is not None else 0

    def pop_once(s):
        """Idle lanes pop the next unserved rays (deterministic cumsum
        'atomicInc'); lanes left without work stay idle on the pad row."""
        idle = ~s["alive"]
        order = jnp.cumsum(idle.astype(jnp.int32))
        new_id = jnp.where(idle, s["next"] + order - 1, s["ray_id"])
        got = idle & (new_id < n_work)
        if work_ids is not None:  # queue holds compacted ray ids
            new_id = work_ids[jnp.clip(new_id, 0, r - 1)]
        rid = jnp.where(got, new_id, jnp.where(idle, r, s["ray_id"]))
        if camera is not None:
            gen = camera_ray_at(camera, jnp.clip(rid, 0, r - 1), spp=spp)
            new_o, new_d = gen.orig, gen.dirn
            mint, maxt_new = gen.mint, gen.maxt
        else:
            row = packed[jnp.clip(rid, 0, r)]
            new_o, new_d = row[:, 0:3], row[:, 3:6]
            mint, maxt_new = row[:, 6], row[:, 7]
        o = jnp.where(got[:, None], new_o, s["o"])
        d = jnp.where(got[:, None], new_d, s["d"])
        t0, entered = _slab_entry(grid, o, d, mint, maxt_new)
        live = got & entered
        return dict(
            s,
            o=o, d=d,
            maxt=jnp.where(got, maxt_new, s["maxt"]),
            gate=jnp.where(got, jnp.float32(t_gate), s["gate"]),
            ray_id=rid,
            alive=jnp.where(idle, live, s["alive"]),
            testing=jnp.where(got, False, s["testing"]),
            t_cur=jnp.where(got, t0, s["t_cur"]),
            cursor=jnp.where(got, 0, s["cursor"]),
            best_t=jnp.where(got, inf, s["best_t"]),
            best_blk=jnp.where(got, 0, s["best_blk"]),
            best_slot=jnp.where(got, 0, s["best_slot"]),
            **({"phase": jnp.where(got, False, s["phase"]),
                "p_best_t": jnp.where(got, inf, s["p_best_t"])}
               if fuse_shadow else {}),
            lane_steps=jnp.where(got, 0, s["lane_steps"]),
            next=jnp.minimum(s["next"] + order[-1], n_work),
        )

    def refill(s):
        # retries re-pop only lanes whose candidate died at the slab
        # test (their alive stays False); pop_once is idempotent for
        # queue-exhausted lanes, so extra attempts are safe no-ops
        for _ in range(1 + refill_retries):
            s = pop_once(s)
        return s

    state = refill(state)

    max_rounds = -(-max_iters // pump)

    def cond(s):
        return (s["i"] < max_rounds) & (
            jnp.any(s["alive"]) | (s["next"] < n_work)
        )

    def one_step(s):
        """March + retire (+ fused rearm) for every lane, latching
        finished-ray records per-lane; no scatter, no refill."""
        pre_alive = s["alive"]
        maxt_lane = (jnp.where(s["phase"], inf, s["maxt"]) if fuse_shadow
                     else s["maxt"])
        s = _march_step(
            s, o=s["o"], d=s["d"], invd=1.0 / s["d"], gate=s["gate"],
            maxt=maxt_lane, grid=grid, meta=meta,
            need_hit_tri=fuse_shadow and shadow_skip_dead,
            probe_chain=probe_chain,
        )
        lane_steps = s["lane_steps"] + pre_alive.astype(jnp.int32)

        if fuse_shadow:
            # retire/rearm via the layer shared with the tiled fused
            # march (stop_on_first_hit is rejected up front, so the
            # any-hit `early` clause below never applies here)
            s, aux = _fused_retire_rearm(
                s, pre_alive=pre_alive, maxt_primary=s["maxt"],
                light=light, serial_quirk=serial_quirk,
                shadow_gate=shadow_gate, shadow_mint=shadow_mint,
                grid=grid, skip_dead_shadow=shadow_skip_dead,
                shade_serial=shade_serial,
            )
            done, in_shadow = aux["done"], aux["in_shadow"]
            final_t = aux["final_t"]
            final_blk, final_slot = aux["final_blk"], aux["final_slot"]
            # a retiring shadow lane's best_* freeze at retirement
            # (testing cleared), so this reads the blocker at first-hit
            # time — the record the latch wants
            sh_blk, sh_slot = s["best_blk"], s["best_slot"]
        else:
            walked_out = pre_alive & ~s["alive"]
            best_t = s["best_t"]
            hit_now = jnp.isfinite(best_t)
            limit = jnp.minimum(maxt_lane, best_t)
            early = s["alive"] & hit_now if stop_on_first_hit else zb
            # the ONE primary-retirement predicate (traverse_packed)
            done = _primary_exhausted(s, limit, walked_out) | early
            final_t, final_blk, final_slot = best_t, s["best_blk"], s["best_slot"]
            in_shadow = zb
            sh_blk, sh_slot = zi, zi
            # ~done matters only for stop_on_first_hit, which can retire
            # a lane mid-cell; the lane's record is latched below
            s = dict(s, alive=s["alive"] & ~done,
                     testing=s["testing"] & ~done)

        # ---- latch finished rays (misses latch code -1, matching the
        # miss-initialized output rows) ---------------------------------
        emit = done & jnp.isfinite(final_t)
        slotidx = jnp.clip(final_blk * bt + final_slot, 0, n_slots - 1)
        code = jnp.where(
            emit, slotidx | (in_shadow.astype(jnp.int32) << 30), -1
        )
        upd = dict(
            lane_steps=lane_steps,
            done_acc=s["done_acc"] | done,
            code_l=jnp.where(done, code, s["code_l"]),
        )
        if need_t:
            upd["t_l"] = jnp.where(emit, final_t, s["t_l"])
        if need_shadow_tri:
            sidx = jnp.clip(sh_blk * bt + sh_slot, 0, n_slots - 1)
            upd["stri_l"] = jnp.where(
                done, jnp.where(in_shadow, sidx, -1), s["stri_l"]
            )
        if need_steps:
            upd["steps_l"] = jnp.where(done, lane_steps, s["steps_l"])
        return dict(s, **upd)

    def body(s):
        for _ in range(pump):
            s = one_step(s)
        # ---- ONE scatter per round flushes every latched record -------
        flushed = s["done_acc"]
        idx = jnp.where(flushed, s["ray_id"], r + jnp.arange(w, dtype=jnp.int32))
        upd = dict(
            done_acc=zb,
            code_l=zi - 1,
            out_code=s["out_code"].at[idx].set(s["code_l"], unique_indices=True),
        )
        if need_t:
            upd["out_t"] = s["out_t"].at[idx].set(s["t_l"], unique_indices=True)
            upd["t_l"] = zf + inf
        if need_shadow_tri:
            upd["out_stri"] = s["out_stri"].at[idx].set(
                s["stri_l"], unique_indices=True
            )
            upd["stri_l"] = zi - 1
        if need_steps:
            upd["out_steps"] = s["out_steps"].at[idx].set(
                jnp.where(flushed, s["steps_l"], 0), unique_indices=True
            )
            upd["steps_l"] = zi
        s = dict(s, **upd)
        s = refill(s)
        return dict(s, i=s["i"] + 1)

    # Remaining unvarying carry leaves (queue cursor, miss-initialized
    # output buffers) are pcast up to the inputs' vma union — same
    # treatment as the zf/zi/zb round constants above.
    if _want:
        state = pcast_varying(state, _want)

    out = jax.lax.while_loop(cond, body, state)
    code = out["out_code"][:r]
    # code >= 0 iff the ray finished with an accepted hit (the emit
    # gate); out_t is finite on exactly the same rays when recorded
    hit = code >= 0
    if need_t:
        out_t = out["out_t"][:r]
    else:
        # placeholder preserving the isfinite(t) == hit invariant; the
        # renderer recomputes true t from tri_id differentiably
        out_t = jnp.where(hit, jnp.float32(0.0), inf)
    # resolve the winning slot -> triangle id with ONE post-loop gather
    tri = grid.slot_tri[jnp.clip(code & ((1 << 30) - 1), 0, n_slots - 1)]
    in_shadow = hit & (((code >> 30) & 1) > 0)
    if need_shadow_tri:
        sidx = out["out_stri"][:r]
        shadow_tri = jnp.where(
            sidx >= 0, grid.slot_tri[jnp.clip(sidx, 0, n_slots - 1)], -1
        )
    else:
        shadow_tri = jnp.full((r,), -1, jnp.int32)  # not recorded
    res = FusedTraceResult(
        hit=hit,
        t=out_t,
        tri_id=jnp.where(hit, tri, -1),
        in_shadow=in_shadow,
        shadow_tri_id=shadow_tri,
        steps=out["out_steps"][:r] if need_steps else jnp.zeros((r,), jnp.int32),
    )
    if return_iters:
        # march steps executed (rounds * pump), comparable across pump
        return res, out["i"] * pump
    return res
