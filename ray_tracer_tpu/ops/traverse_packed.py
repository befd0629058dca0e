"""Production traversal: stateless DDA over the block-packed grid.

A gather-oriented redesign of the voxel walk (reference:
Serial/grid.h:167-231).  The CSR walk in ops/traverse.py is the faithful
oracle-parity path; this one is built around the cost model of the
accelerator it was first tuned on — a random device-memory gather costs
about one row per ray whatever its width, and is paid per INDEX — so
each live ray pays at most two gathered rows per step:

  1. `cell_info[cell]` — a packed uint32 with the voxel's block range
     (occupied) or its maximal empty-box extents (empty);
  2. `blocks[row]` — one block row (meta.block_tris whole triangles)
     tested in a single fused vector sweep.

With the INLINE layout (meta.inline, the production default) the two
collapse into ONE: the probed cell's row carries its header in-row
(accel/packed.decode_inline_header), so a step issues a single gather.

March structure (all lanes in lock-step, predicated):

  * a lane NOT mid-voxel probes the point t_cur + delta, decodes its
    cell, and either (a) starts testing the cell's block rows, or
    (b) leaps the cell's verified-empty box in one step — empty-sky
    rays cross a 64-cell grid in a handful of steps instead of ~180,
    which matters because a SIMD wave retires at its slowest lane;
  * a lane mid-voxel tests one block row per step, recording the
    nearest accepted hit as (block, slot);
  * a lane dies when its next cell entry lies beyond min(maxt, best_t)
    (early exit) or, for occlusion queries, on any accepted hit.

The winning triangle id is resolved AFTER the march with one gather
from `slot_tri` — ids never ride through the loop.

Both entry points (`traverse_packed` and the fused primary+shadow
march) share ONE step implementation, `_march_step`, parameterized by
per-lane ray state — a fix in the probe/leap/accept logic cannot leave
the two marches divergent.

Not bit-faithful to the serial reference (different visit order for
equal-t ties across voxels, probe nudge can skip sub-1e-3-width cell
slivers); renders match the oracle to boundary-pixel tolerance and the
brute-force sweep exactly on the test scenes.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ray_tracer_tpu.accel.packed import (
    PackedGridArrays,
    PackedGridMeta,
    decode_cell_info,
    decode_inline_header,
)
from ray_tracer_tpu.core.rays import RayBatch
from ray_tracer_tpu.ops.intersect import cramer_tbg

_INF = float("inf")


class PackedTraceResult(NamedTuple):
    any_pass: jnp.ndarray  # == hit (production path has no faithful any_pass)
    hit: jnp.ndarray  # (R,) bool
    t: jnp.ndarray  # (R,) f32
    tri_id: jnp.ndarray  # (R,) i32, -1 on miss
    steps: jnp.ndarray  # (R,) i32


def _default_max_steps(meta: PackedGridMeta) -> int:
    """Worst case: every cell on the longest axis-aligned walk is occupied
    at the scene's max per-voxel block count — one probe iteration plus
    max_blocks block-test iterations per cell."""
    nx, ny, nz = meta.n_voxels
    return (nx + ny + nz + 2) * (meta.max_blocks + 1) + 64


def _slab_entry(grid, o, d, mint, maxt):
    """Grid AABB entry t and entered flag (per-lane o/d).

    IEEE-robust on boundary planes: an origin EXACTLY on a slab plane
    with a direction parallel to that axis yields 0 * inf = NaN in the
    naive formulation (and such rays are real — shadow rays rearm from
    floor-plane hits that sit on the grid's lower bound).  NaN on an
    axis means the ray runs inside that slab forever: its contribution
    to the interval is (-inf, +inf), restored with nan_to_num.
    """
    invd = 1.0 / d
    t_near = (grid.lower - o) * invd
    t_far = (grid.upper - o) * invd
    # posinf/neginf passthrough: nan_to_num's DEFAULT replaces ±inf with
    # ±f32max, which let inf-origin rays (retired bounce lanes, padding)
    # "enter" with a finite t0 = 3.4e38 — isfinite passed and the lane
    # marched one garbage step.  Worse, any downstream arithmetic that
    # nudges 3.4e38 overflows to inf and o + d*inf yields NaN positions,
    # which XLA's saturating float->int converts to CELL 0 — an alive
    # lane spinning in-grid until max_iters.  Only NaN (the 0*inf
    # boundary-plane case) is remapped; infinities stay infinite.
    lo = jnp.nan_to_num(
        jnp.minimum(t_near, t_far), nan=-jnp.inf, posinf=jnp.inf,
        neginf=-jnp.inf,
    )
    hi = jnp.nan_to_num(
        jnp.maximum(t_near, t_far), nan=jnp.inf, posinf=jnp.inf,
        neginf=-jnp.inf,
    )
    t0 = jnp.maximum(jnp.max(lo, axis=-1), mint)
    t1 = jnp.minimum(jnp.min(hi, axis=-1), maxt)
    # The NaN remap above is justified ONLY for the 0*inf boundary-plane
    # case (finite o, axis-parallel d); it must not admit rays that are
    # degenerate outright.  A NaN/inf component, or a zero DIRECTION
    # (e.g. a shadow ray whose hit point coincides with the light),
    # yields a lane that never progresses — the march would spin it at
    # cell 0 until the iteration bound (an immortal lane), and the
    # persistent wave would never flush its latched record.  Such rays
    # simply never enter.
    well_formed = (jnp.all(jnp.isfinite(o) & jnp.isfinite(d), axis=-1)
                   & jnp.any(d != 0.0, axis=-1))
    return t0, (t0 <= t1) & jnp.isfinite(t0) & well_formed


def chord_keys(rays: RayBatch, grid) -> jnp.ndarray:
    """Work-queue difficulty keys: NEGATED grid-slab chord length
    (t1 - t0), +inf for rays that never enter — ascending pop order then
    serves long-chord rays first.  The chord is an arithmetic predictor of
    walk length (long walks need long in-grid segments; grazing sky
    rays have short ones) costing no gathers, unlike the entry-cell
    distance-field lookup it approximates.  Used by the persistent
    wave's ordered queue (ops/persistent.persistent_trace order_keys;
    RenderConfig.queue_order)."""
    o = rays.orig.astype(jnp.float32)
    d = rays.dirn.astype(jnp.float32)
    invd = 1.0 / d
    t_near = (grid.lower - o) * invd
    t_far = (grid.upper - o) * invd
    lo = jnp.nan_to_num(jnp.minimum(t_near, t_far), nan=-jnp.inf,
                        posinf=jnp.inf, neginf=-jnp.inf)
    hi = jnp.nan_to_num(jnp.maximum(t_near, t_far), nan=jnp.inf,
                        posinf=jnp.inf, neginf=-jnp.inf)
    t0 = jnp.maximum(jnp.max(lo, axis=-1), rays.mint.astype(jnp.float32))
    t1 = jnp.minimum(jnp.min(hi, axis=-1), rays.maxt.astype(jnp.float32))
    chord = jnp.maximum(t1 - t0, 0.0)
    ok = (t0 <= t1) & jnp.isfinite(t0) & jnp.isfinite(chord)
    return jnp.where(ok, -chord, jnp.inf)


def _march_step(s, *, o, d, invd, gate, maxt, grid, meta,
                need_hit_tri: bool = False, probe_chain: int = 1):
    """The shared DDA core: one cell-probe phase + one block-test phase.

    o/d/invd are (R,3), gate/maxt are (R,) — per-lane so the fused march
    can rearm rays in place.  Updates the march-state keys {alive,
    testing, t_cur, t_exit_cell, first_blk, n_blk, cursor, best_t,
    best_blk, best_slot} of dict `s` (other keys pass through).

    need_hit_tri: also keep the winning triangle's 9 floats in carry
    key "best_tri9" (selected exactly from the row already in hand, no
    extra gather).  The dead-shadow skip reads it at rearm time to
    evaluate the hit's normal.

    probe_chain > 1 (blocks layout only): after the combined
    probe+test phase, lanes that are STILL pure leapers run up to
    probe_chain-1 more cell probes in the same step — each an extra
    DEPENDENT cell_info gather that either leaps again or arms the
    cell for next step's row test.
    Motivation (a device-independent count): 84-87%% of a dense rough-shell scene's
    lane-steps are probe/leap steps (tools/phase_split.py — nefertiti
    primaries 13%% test, shadows 16%% test), so collapsing k probes
    into one step attacks the dominant cost directly.  Results are
    invariant to the chain depth (same cells visited, same first-hit
    bookkeeping; only the step count drops).
    """
    nx, ny, nz = meta.n_voxels
    nvox = jnp.asarray([nx, ny, nz], jnp.int32)
    n_blocks = meta.n_blocks
    bt = meta.block_tris
    delta = jnp.float32(meta.probe_delta)
    inf = jnp.float32(_INF)
    r = o.shape[0]

    alive, testing, t_cur = s["alive"], s["testing"], s["t_cur"]

    # ---- cell probe + info fetch (lanes not mid-voxel) --------------------
    # The nudge is relative past t ~ delta/4e-6: an absolute delta below
    # ulp(t_cur) would round away (t_cur + delta == t_cur) and the lane
    # would re-probe the same cell until max_steps — a real stall for
    # rays far from the origin or for ring-sharded grids whose shared
    # probe_delta is the min over shards with very different cell sizes.
    # 4e-6 ≈ 33 f32 ulps at 1.0, far below any practical cell width, so
    # near-field behavior (probe == t_cur + delta) is unchanged.
    probe = t_cur + jnp.maximum(delta, t_cur * jnp.float32(4e-6))
    p = o + d * probe[:, None]
    cell = jnp.floor((p - grid.lower) * grid.inv_width).astype(jnp.int32)
    inside = jnp.all((cell >= 0) & (cell < nvox), axis=-1)
    fetch = alive & ~testing
    die = fetch & ~inside

    cc = jnp.clip(cell, 0, nvox - 1)
    lin = cc[:, 2] * (nx * ny) + cc[:, 1] * nx + cc[:, 0]
    if meta.inline:
        # THE one gather per step: probing lanes fetch the probed cell's
        # inline row (header + its first block_tris triangles); mid-cell
        # lanes fetch their next overflow row.  The same fetched row
        # feeds both the header decode below and the triangle test —
        # the cell_info gather of the blocks layout does not exist here.
        gidx = jnp.where(
            testing,
            jnp.clip(s["first_blk"] + s["cursor"] - 1, 0, n_blocks - 1),
            jnp.clip(lin, 0, n_blocks - 1),
        )
        row = grid.blocks[gidx]  # THE GATHER: (R, row_lanes) f32
        first, nblk, ext_lo, ext_hi = decode_inline_header(row)
    else:
        first, nblk, ext_lo, ext_hi = decode_cell_info(
            grid.cell_info[lin]
        )  # GATHER 1
    occupied = nblk > 0

    # safe-box exit: the cell itself for occupied cells, the packed
    # maximal empty box for empty ones (anisotropic — long tangential
    # leaps along a surface band; accel/packed.greedy_empty_boxes)
    lo_e = jnp.where(occupied[:, None], 0, ext_lo)
    hi_e = jnp.where(occupied[:, None], 0, ext_hi)
    blo = grid.lower + (cell - lo_e).astype(jnp.float32) * grid.width
    bhi = grid.lower + (cell + hi_e + 1).astype(jnp.float32) * grid.width
    # nan_to_num: a boundary-plane origin with a parallel direction gives
    # 0 * inf = NaN; the ray never exits the box along that axis (+inf)
    tf = jnp.nan_to_num(
        jnp.maximum((blo - o) * invd, (bhi - o) * invd), nan=jnp.inf
    )
    t_exit = jnp.maximum(jnp.min(tf, axis=-1), probe)  # monotone progress

    start_test = fetch & inside & occupied
    jump = fetch & inside & ~occupied
    first_blk = jnp.where(start_test, first, s["first_blk"])
    n_blk = jnp.where(start_test, nblk, s["n_blk"])
    cursor = jnp.where(start_test, 0, s["cursor"])
    t_exit_cell = jnp.where(start_test, t_exit, s["t_exit_cell"])
    t_cur = jnp.where(jump, t_exit, t_cur)
    testing = testing | start_test
    alive = alive & ~die

    # ---- one block row of meta.block_tris triangles ----------------------
    # A lane that just probed into an occupied cell tests that cell's
    # FIRST row in the same iteration (`testing` already includes
    # start_test lanes, which run with cursor 0) — the probe step is
    # never a test-free iteration.
    if meta.inline:
        # the row is already in hand: start_test lanes fetched their
        # cell's inline row (gidx == lin), mid-cell lanes their overflow
        # row — `blk` only records WHICH row for the best_* bookkeeping
        blk = gidx
    else:
        blk = jnp.clip(first_blk + cursor, 0, n_blocks - 1)
        row = grid.blocks[blk]  # GATHER 2: (R, row_lanes) f32
    tri = row[:, : bt * 9].reshape(r, bt, 9)
    t, beta, gamma = cramer_tbg(
        o[:, None, :], d[:, None, :],
        tri[..., 0:3], tri[..., 3:6], tri[..., 6:9],
        det_dtype=jnp.float32,
    )
    accept = (
        (beta > 0) & (gamma > 0) & (beta + gamma < 1)
        & (t > gate[:, None]) & (t <= maxt[:, None]) & testing[:, None]
    )
    tm = jnp.where(accept, t, inf)
    slot = jnp.argmin(tm, axis=-1).astype(jnp.int32)
    # min == tm[argmin] exactly; a reduction is one gather cheaper than
    # take_along_axis
    m = jnp.min(tm, axis=-1)
    upd = m < s["best_t"]

    cursor = jnp.where(testing, cursor + 1, cursor)
    done = testing & (cursor >= n_blk)
    extra = {}
    if need_hit_tri:
        # an exact pick of the winning slot's 9 floats: a one-hot f32
        # contraction would be free to run at reduced (TF32) precision
        # on a GPU and round the vertices the shadow rearm and in-wave
        # shading read
        tri9_win = jnp.take_along_axis(tri, slot[:, None, None], axis=1)[:, 0]
        extra["best_tri9"] = jnp.where(
            upd[:, None], tri9_win, s["best_tri9"]
        )
    out = dict(
        s,
        alive=alive,
        testing=testing & ~done,
        t_cur=jnp.where(done, t_exit_cell, t_cur),
        t_exit_cell=t_exit_cell,
        first_blk=first_blk,
        n_blk=n_blk,
        cursor=cursor,
        best_t=jnp.where(upd, m, s["best_t"]),
        best_blk=jnp.where(upd, blk, s["best_blk"]),
        best_slot=jnp.where(upd, slot, s["best_slot"]),
        **extra,
    )
    if probe_chain > 1:
        assert not meta.inline, (
            "probe_chain > 1 serves the blocks layout (a chained inline "
            "probe would need the row in hand to start testing)"
        )
        for _ in range(probe_chain - 1):
            out = _chain_probe(out, o=o, d=d, invd=invd, grid=grid, meta=meta)
    return out


def _chain_probe(s, *, o, d, invd, grid, meta):
    """One extra cell-probe for lanes that are pure leapers after the
    main march phase: leap again on empty, or ARM an occupied cell
    (first/n_blk/cursor=0, row test happens next step).  Exactly the
    main phase's probe semantics (nudge, safe-box exit, monotone
    progress) minus the row test; one dependent cell_info gather."""
    nx, ny, nz = meta.n_voxels
    nvox = jnp.asarray([nx, ny, nz], jnp.int32)
    delta = jnp.float32(meta.probe_delta)
    alive, testing, t_cur = s["alive"], s["testing"], s["t_cur"]
    act = alive & ~testing
    probe = t_cur + jnp.maximum(delta, t_cur * jnp.float32(4e-6))
    p = o + d * probe[:, None]
    cell = jnp.floor((p - grid.lower) * grid.inv_width).astype(jnp.int32)
    inside = jnp.all((cell >= 0) & (cell < nvox), axis=-1)
    die = act & ~inside
    cc = jnp.clip(cell, 0, nvox - 1)
    lin = cc[:, 2] * (nx * ny) + cc[:, 1] * nx + cc[:, 0]
    first, nblk, ext_lo, ext_hi = decode_cell_info(
        grid.cell_info[lin]
    )  # THE GATHER
    occupied = nblk > 0
    lo_e = jnp.where(occupied[:, None], 0, ext_lo)
    hi_e = jnp.where(occupied[:, None], 0, ext_hi)
    blo = grid.lower + (cell - lo_e).astype(jnp.float32) * grid.width
    bhi = grid.lower + (cell + hi_e + 1).astype(jnp.float32) * grid.width
    tf = jnp.nan_to_num(
        jnp.maximum((blo - o) * invd, (bhi - o) * invd), nan=jnp.inf
    )
    t_exit = jnp.maximum(jnp.min(tf, axis=-1), probe)
    start = act & inside & occupied
    jump = act & inside & ~occupied
    return dict(
        s,
        alive=alive & ~die,
        testing=testing | start,
        t_cur=jnp.where(jump, t_exit, t_cur),
        t_exit_cell=jnp.where(start, t_exit, s["t_exit_cell"]),
        first_blk=jnp.where(start, first, s["first_blk"]),
        n_blk=jnp.where(start, nblk, s["n_blk"]),
        cursor=jnp.where(start, 0, s["cursor"]),
    )


def _primary_exhausted(s, limit, walked_out):
    """A primary lane is done when it walks past min(maxt, best_t)
    between cells (not mid-row: `testing` lanes finish their block row
    first) or walks off the grid — the ONE retirement predicate shared
    by the tiled body, the fused retire/rearm layer and the persistent
    scheduler's non-fused path."""
    return (s["alive"] & ~s["testing"] & (s["t_cur"] > limit)) | walked_out


def _fused_retire_rearm(s, *, pre_alive, maxt_primary, light, serial_quirk,
                        shadow_gate, shadow_mint, grid,
                        skip_dead_shadow=False, shade_serial=False):
    """The ONE retire/rearm layer shared by both fused marches
    (traverse_packed_fused_shadow and ops.persistent.persistent_trace),
    like _march_step is their one DDA core — so a semantics fix cannot
    leave one of them stale.

    Runs right after _march_step: decides per-lane retirement, rearms a
    finished primary in place as its shadow ray (the queue-free
    wavefront trick, Parallel/raytracer.cu:177-334), and updates the
    march-state keys {o, d, phase, gate, p_best_*, best_*, t_cur,
    testing, cursor, alive} of dict `s` (other keys pass through).

    maxt_primary is each lane's PRIMARY-ray maxt (shadow rays march
    unbounded; retirement only consults it on ~phase lanes).

    Returns (s, aux) with aux = {done, hit0, retire_primary,
    retire_shadow, hit_now, in_shadow, final_t, final_blk, final_slot}:
    `done` lanes finished their ray THIS step with the final record in
    final_* / in_shadow (callers latch or accumulate it); best_blk/slot
    freeze at retirement (a done lane stops testing), so reading them
    on retire_shadow lanes after this call yields the blocker at
    first-hit time.

    skip_dead_shadow: lanes whose hit point has EXACTLY zero direct
    light — n.l <= 0 and n.h <= 0 makes both the diffuse and specular
    terms exact zeros under either shading variant (max(0, .) gates,
    ops/shade.py) — retire immediately as un-shadowed instead of
    marching a shadow ray whose outcome cannot change the pixel.
    Image bit-identical; the recorded in_shadow flag on those lanes is
    False regardless of true occlusion, so callers that CONSUME
    occlusion beyond shading (blocker identity for soft visibility,
    metrics) must keep this off.  Requires carry key "best_tri9" (the
    march's need_hit_tri) to evaluate the facet normal per
    shade_serial's convention (getNormalMod vs the CUDA cross,
    ops/shade.py:127-136); assumes unit ray directions (true of every
    camera/bounce ray here).
    """
    inf = jnp.float32(_INF)
    phase = s["phase"]
    best_t, testing, t_cur = s["best_t"], s["testing"], s["t_cur"]
    walked_out = pre_alive & ~s["alive"]
    hit_now = jnp.isfinite(best_t)
    limit = jnp.minimum(maxt_primary, best_t)
    retire_primary = ~phase & _primary_exhausted(s, limit, walked_out)
    retire_shadow = phase & ((s["alive"] & hit_now) | walked_out)

    # lanes whose primary just finished with a hit REARM as their shadow
    hit0 = retire_primary & hit_now
    poi = s["o"] + s["d"] * best_t[:, None]
    to_light = light - poi
    norm = jnp.sqrt(jnp.sum(to_light * to_light, axis=-1, keepdims=True))
    sdir = to_light / jnp.where(norm > 0, norm, 1.0)
    skip = jnp.zeros_like(hit0)
    if skip_dead_shadow:
        t9 = s["best_tri9"]
        a, b, c = t9[:, 0:3], t9[:, 3:6], t9[:, 6:9]
        if shade_serial:  # getNormalMod, Serial/geometry.h:234-240
            n = jnp.cross(a - b, c - a)
        else:  # Parallel/geometry.cuh:160
            n = jnp.cross(c - b, a - b)
        # h's SIGN is scale-invariant: view = -d (unit), l = sdir (unit)
        h = sdir - s["d"]
        # conservative margin: this dot and the shading's recomputation
        # (different normalize/cross contraction order) agree only to
        # last-ulp RELATIVE error of the TERM magnitudes (cancellation:
        # the cross error scales with |e1||e2|, not |n| — sliver
        # triangles), and ks ~ 5e11 amplifies pow(n.h ~ 0, alpha) into
        # visible counts right at the boundary — skip only lanes
        # strictly inside the dead region (margin = 2e-5 * |e1||e2|
        # covers the ~1e-7 relative discrepancy with ~100x slack;
        # boundary lanes march their shadow ray as before, so the
        # image stays bitwise)
        e1s = jnp.sum((a - b) ** 2, axis=-1)
        e2s = jnp.sum((c - a) ** 2, axis=-1)
        m = jnp.float32(2e-5) * jnp.sqrt(e1s * e2s)
        dead = (jnp.sum(n * sdir, axis=-1) <= -m) & (
            jnp.sum(n * h, axis=-1) <= -m
        )
        skip = hit0 & dead
        hit0 = hit0 & ~dead
    if serial_quirk:  # Serial/raytracer.cpp:106 — away from the light
        sdir = -sdir
    new_o = jnp.where(hit0[:, None], poi, s["o"])
    new_d = jnp.where(hit0[:, None], sdir, s["d"])
    smint = jnp.full_like(best_t, jnp.float32(shadow_mint))
    st0, s_entered = _slab_entry(
        grid, new_o, new_d, smint, jnp.full_like(best_t, inf)
    )
    done = (
        (retire_primary & ~hit_now)  # primary miss
        | (hit0 & ~s_entered)  # shadow ray misses the grid: lit
        | skip  # zero-direct hit: occlusion cannot affect the pixel
        | retire_shadow
    )
    in_shadow = retire_shadow & hit_now
    final_t = jnp.where(phase, s["p_best_t"], best_t)
    final_blk = jnp.where(phase, s["p_best_blk"], s["best_blk"])
    final_slot = jnp.where(phase, s["p_best_slot"], s["best_slot"])
    s = dict(
        s,
        o=new_o, d=new_d,
        phase=phase | hit0,
        gate=jnp.where(hit0, jnp.float32(shadow_gate), s["gate"]),
        p_best_t=jnp.where(retire_primary, best_t, s["p_best_t"]),
        p_best_blk=jnp.where(retire_primary, s["best_blk"], s["p_best_blk"]),
        p_best_slot=jnp.where(retire_primary, s["best_slot"], s["p_best_slot"]),
        best_t=jnp.where(hit0, inf, best_t),
        best_blk=jnp.where(hit0, 0, s["best_blk"]),
        best_slot=jnp.where(hit0, 0, s["best_slot"]),
        t_cur=jnp.where(hit0, st0, t_cur),
        # ~done: a shadow lane retires MID-cell at its first hit; left
        # testing, the dead lane would keep scanning the cell's rows and
        # a later (nearer) blocker would overwrite best_blk/best_slot
        testing=testing & ~hit0 & ~done,
        cursor=jnp.where(hit0, 0, s["cursor"]),
        alive=(s["alive"] | hit0) & ~done,
    )
    return s, dict(
        done=done, hit0=hit0, retire_primary=retire_primary,
        retire_shadow=retire_shadow, hit_now=hit_now, in_shadow=in_shadow,
        final_t=final_t, final_blk=final_blk, final_slot=final_slot,
    )


@partial(
    jax.jit,
    static_argnames=("meta", "t_gate", "stop_on_first_hit", "max_steps",
                     "unroll", "probe_chain"),
)
def traverse_packed(
    rays: RayBatch,
    grid: PackedGridArrays,
    meta: PackedGridMeta,
    *,
    t_gate: float = 0.0,
    stop_on_first_hit: bool = False,
    max_steps: Optional[int] = None,
    unroll: int = 1,
    probe_chain: int = 1,
) -> PackedTraceResult:
    bt = meta.block_tris
    if max_steps is None:
        max_steps = _default_max_steps(meta)

    # the packed path is f32 by contract; coerce so x64-mode callers
    # (tests, notebooks) don't promote the while_loop carry dtypes
    o = rays.orig.astype(jnp.float32)
    d = rays.dirn.astype(jnp.float32)
    mint = rays.mint.astype(jnp.float32)
    maxt = rays.maxt.astype(jnp.float32)
    inf = jnp.float32(_INF)
    invd = 1.0 / d  # +/-inf on axis-parallel rays; IEEE max/min below is fine

    t0, entered = _slab_entry(grid, o, d, mint, maxt)

    zf = jnp.where(jnp.isfinite(o[:, 0]), 0.0, 0.0).astype(jnp.float32)
    zi = zf.astype(jnp.int32)
    zb = zi != 0
    gate = zf + jnp.float32(t_gate)

    state = dict(
        alive=entered,
        testing=zb,
        t_cur=t0,
        t_exit_cell=zf,
        first_blk=zi,
        n_blk=zi,
        cursor=zi,
        best_t=zf + inf,
        best_blk=zi,
        best_slot=zi,
        steps=zi,
        i=jnp.asarray(0, jnp.int32),
    )

    max_iters = -(-max_steps // unroll)

    def cond(s):
        return (s["i"] < max_iters) & jnp.any(s["alive"])

    def body(s):
        # `unroll` march steps per while iteration amortize loop-control
        # overhead (measured: unroll=1 is optimal at production tiles;
        # the knob stays for future hardware).
        for _ in range(unroll):
            pre_alive = s["alive"]
            s = _march_step(s, o=o, d=d, invd=invd, gate=gate, maxt=maxt,
                            grid=grid, meta=meta, probe_chain=probe_chain)
            limit = jnp.minimum(maxt, s["best_t"])
            alive = s["alive"] & (s["testing"] | (s["t_cur"] <= limit))
            if stop_on_first_hit:
                alive = alive & ~jnp.isfinite(s["best_t"])
                # any-hit retirement can land mid-cell; stop the dead
                # lane's residual row scan (result already recorded)
                s = dict(s, testing=s["testing"] & alive)
            s = dict(
                s,
                alive=alive,
                # count march steps EXECUTED (pre-march alive), matching
                # persistent_trace and the fused march — a lane dying by
                # walking out still ran this step
                steps=s["steps"] + pre_alive.astype(jnp.int32),
            )
        return dict(s, i=s["i"] + 1)

    out = jax.lax.while_loop(cond, body, state)
    hit = jnp.isfinite(out["best_t"])
    slot_idx = jnp.clip(
        out["best_blk"] * bt + out["best_slot"], 0,
        grid.slot_tri.shape[0] - 1,
    )
    tri_id = jnp.where(hit, grid.slot_tri[slot_idx], -1)
    return PackedTraceResult(
        any_pass=hit, hit=hit, t=out["best_t"], tri_id=tri_id, steps=out["steps"]
    )


class FusedTraceResult(NamedTuple):
    hit: jnp.ndarray  # (R,) bool — primary hit
    t: jnp.ndarray  # (R,) f32 primary nearest t
    tri_id: jnp.ndarray  # (R,) i32 primary triangle (-1 on miss)
    in_shadow: jnp.ndarray  # (R,) bool — shadow ray found a blocker
    shadow_tri_id: jnp.ndarray  # (R,) i32 blocker id (-1 if unshadowed)
    steps: jnp.ndarray  # (R,) i32 total iterations


@partial(
    jax.jit,
    static_argnames=("meta", "primary_gate", "shadow_gate", "shadow_mint",
                     "serial_quirk", "max_steps"),
)
def traverse_packed_fused_shadow(
    rays: RayBatch,
    grid: PackedGridArrays,
    meta: PackedGridMeta,
    light_pos: jnp.ndarray,
    *,
    primary_gate: float = 0.0,
    shadow_gate: float = 1e-4,
    shadow_mint: float = 1e-4,
    serial_quirk: bool = False,
    max_steps: Optional[int] = None,
) -> FusedTraceResult:
    """Primary nearest-hit + shadow occlusion in ONE lock-step march.

    Wavefront pipelining without queues: the moment a lane's primary
    march retires, it REARMS in place as its own shadow ray (origin at
    the recorded hit point, direction per the shading mode — the serial
    reference's away-from-light quirk, Serial/raytracer.cpp:106, or the
    CUDA variant's toward-light ray, Parallel/raytracer.cu:492-506) and
    keeps marching while neighbors finish their primaries.  Compared to
    two sequential passes this halves the while-loop instances and
    absorbs the shadow work into the primary wave's tail — the dense
    counterpart of the reference's decoupled intersect/shading kernels
    overlapping in streams, with the scheduler compiled away.  Under the
    tiled scheduler it won on sparse scenes and lost on dense
    full-frame ones — hence the fused_shadow config.

    Forward-only (everything is stop-gradient territory; the renderer
    recomputes differentiable quantities from the returned ids).
    """
    bt = meta.block_tris
    if max_steps is None:
        # primary + shadow phases, each bounded like traverse_packed
        max_steps = 2 * _default_max_steps(meta)

    o0 = rays.orig.astype(jnp.float32)
    d0 = rays.dirn.astype(jnp.float32)
    mint0 = rays.mint.astype(jnp.float32)
    maxt0 = rays.maxt.astype(jnp.float32)
    inf = jnp.float32(_INF)
    light = light_pos.astype(jnp.float32)

    t_ent, entered = _slab_entry(grid, o0, d0, mint0, maxt0)

    zf = jnp.where(jnp.isfinite(o0[:, 0]), 0.0, 0.0).astype(jnp.float32)
    zi = zf.astype(jnp.int32)
    zb = zi != 0

    state = dict(
        o=o0, d=d0,
        phase=zb,  # False = primary, True = shadow
        gate=zf + jnp.float32(primary_gate),
        alive=entered,
        testing=zb,
        t_cur=t_ent,
        t_exit_cell=zf,
        first_blk=zi, n_blk=zi, cursor=zi,
        best_t=zf + inf, best_blk=zi, best_slot=zi,
        p_best_t=zf + inf, p_best_blk=zi, p_best_slot=zi,
        shadow_hit=zb,
        steps=zi,
        i=jnp.asarray(0, jnp.int32),
    )

    def cond(s):
        return (s["i"] < max_steps) & jnp.any(s["alive"])

    def body(s):
        pre_alive = s["alive"]
        # shadow rays trace unbounded (reference semantics: no light-
        # distance clipping); the primary's maxt is a DIFFERENT ray's
        # parameterization and must not leak into the rearmed ray
        maxt_lane = jnp.where(s["phase"], jnp.float32(_INF), maxt0)
        s = _march_step(
            s, o=s["o"], d=s["d"], invd=1.0 / s["d"], gate=s["gate"],
            maxt=maxt_lane, grid=grid, meta=meta,
        )
        s, aux = _fused_retire_rearm(
            s, pre_alive=pre_alive, maxt_primary=maxt0, light=light,
            serial_quirk=serial_quirk, shadow_gate=shadow_gate,
            shadow_mint=shadow_mint, grid=grid,
        )
        return dict(
            s,
            shadow_hit=s["shadow_hit"] | aux["in_shadow"],
            steps=s["steps"] + pre_alive.astype(jnp.int32),
            i=s["i"] + 1,
        )

    out = jax.lax.while_loop(cond, body, state)
    # lanes still in phase 0 at exhaustion: harvest their primary record
    final_primary_t = jnp.where(out["phase"], out["p_best_t"], out["best_t"])
    final_primary_blk = jnp.where(out["phase"], out["p_best_blk"], out["best_blk"])
    final_primary_slot = jnp.where(out["phase"], out["p_best_slot"], out["best_slot"])
    # a shadow lane that died mid-march with a recorded blocker counts
    shadow = out["shadow_hit"] | (out["phase"] & jnp.isfinite(out["best_t"]))

    hit = jnp.isfinite(final_primary_t)
    pidx = jnp.clip(final_primary_blk * bt + final_primary_slot, 0,
                    grid.slot_tri.shape[0] - 1)
    tri_id = jnp.where(hit, grid.slot_tri[pidx], -1)
    sidx = jnp.clip(out["best_blk"] * bt + out["best_slot"], 0,
                    grid.slot_tri.shape[0] - 1)
    shadow_tri = jnp.where(shadow & out["phase"], grid.slot_tri[sidx], -1)
    return FusedTraceResult(
        hit=hit, t=final_primary_t, tri_id=tri_id,
        in_shadow=shadow & hit, shadow_tri_id=shadow_tri,
        steps=out["steps"],
    )
