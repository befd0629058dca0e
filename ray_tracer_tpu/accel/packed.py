"""Block-packed uniform grid — the production layout.

It was designed on a chip whose random gathers cost about one ROW per
index whatever the row width, up to 128 lanes.  The CSR layout
(accel/grid.py) pays one row per (ray, triangle-slot) — dozens of rows
per ray per voxel.  This layout pays ~2 rows per ray per voxel step.
The 128-lane row width and 14-triangle rows are carried over from that
chip and are not yet tuned on the H100.

  * `blocks` (n_blocks, 128) f32 — each row packs BLOCK_TRIS=14 whole
    triangles (14 x 9 = 126 floats, slot-major [v0 v1 v2]); a voxel's
    triangle list is ceil(count/14) consecutive rows.  Padding slots are
    all-zero degenerate triangles whose zero determinant fails the
    strict barycentric test (Serial/geometry.h:162) automatically.
  * `cell_info` (n_cells,) uint32 — per-voxel record.  Bit 31
    discriminates:
      - occupied (bit31=0): [spare:4 | n_blocks:6 | first_block:21]
        with n_blocks >= 1 — row range of the voxel's triangle blocks;
      - empty (bit31=1): six 5-bit per-direction extents
        [z+:5 | z-:5 | y+:5 | y-:5 | x+:5 | x-:5] of the cell's greedy
        MAXIMAL EMPTY BOX — the safe leap box for empty-space skipping
        in the traversal (grown per direction while verifiably empty
        against a summed-area table of the occupancy).
  * `slot_tri` (n_blocks * BLOCK_TRIS,) i32 — global triangle id per
    (block, slot); fetched ONCE per ray after the march to resolve the
    winning hit (material index + differentiable vertex re-gather).

The reference's voxel lists (Serial/grid.h:17, Parallel/grid.cuh:26-28)
map to `blocks`; the empty-box field has no reference counterpart — it
exists because a lock-step SIMD march pays for its slowest lane, so
empty-sky rays must cross the grid in O(few) steps, not O(resolution).
The boxes are ANISOTROPIC because the empty space around a surface is:
a Chebyshev radius (rounds 1-3 of this layout) leaps 1 cell everywhere
near the occupied band, while the maximal box lets tangential rays
(shadow rays grazing a corrugated surface — the dense-scene hot case)
leap the long way: on the 261k-face displaced sphere, probe steps drop
21% (primary) / 36% (shadow) with hits bitwise unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ray_tracer_tpu.accel.grid import UniformGrid

BLOCK_TRIS = 14  # default: 14 triangles * 9 floats = 126 of 128 lanes
DIST_CAP = 31  # Chebyshev-field cap (leap="cheb" reproduction mode)
EXT_CAP = 31  # per-direction empty-box extent cap (5 bits each)

_FIRST_BITS = 21
_NBLK_BITS = 6
_NBLK_SHIFT = _FIRST_BITS
_FIRST_MASK = (1 << _FIRST_BITS) - 1
_NBLK_MASK = (1 << _NBLK_BITS) - 1
_EMPTY_FLAG = np.uint32(1 << 31)


class PackedGridMeta(NamedTuple):
    n_voxels: Tuple[int, int, int]
    n_blocks: int
    probe_delta: float  # robust cell-probe nudge, in t units (dirs are unit)
    block_tris: int = BLOCK_TRIS  # triangles per block row
    row_lanes: int = 128  # block row width (multiple of 128)
    max_blocks: int = 1  # largest per-voxel block count (march bound)
    # inline layout: the cell header (overflow row / empty-box extents,
    # row count) lives IN the last two lanes of each cell's first block row,
    # so a march step issues ONE gather instead of two (cell_info +
    # block row), which paid off where gathers cost per index.  Costs a
    # dense first-row per CELL (empty cells included): (n_cells +
    # overflow) * row_lanes * 4 bytes of device memory — prepare()
    # auto-selects it when that fits.
    inline: bool = False

    @property
    def total_voxels(self) -> int:
        nx, ny, nz = self.n_voxels
        return nx * ny * nz


class PackedGridArrays(NamedTuple):
    lower: jnp.ndarray  # (3,) f32
    upper: jnp.ndarray
    width: jnp.ndarray  # (3,)
    inv_width: jnp.ndarray
    cell_info: jnp.ndarray  # (n_cells,) uint32
    blocks: jnp.ndarray  # (n_blocks, 128) f32
    slot_tri: jnp.ndarray  # (n_blocks * BLOCK_TRIS,) i32


@dataclass(frozen=True)
class PackedGrid:
    arrays: PackedGridArrays
    meta: PackedGridMeta


def _decode_extents(word: jnp.ndarray):
    """30-bit packed extents -> (lo_ext (...,3) i32, hi_ext (...,3) i32)
    in [x, y, z] axis order.  `word` may be int32 or uint32; only bits
    0..29 are read, so the blocks layout's bit-31 empty flag and the
    occupied cells' aliasing fields are harmless (callers gate on the
    occupancy predicate)."""
    w = word.astype(jnp.int32) & 0x3FFFFFFF
    lo = jnp.stack(
        [w & 31, (w >> 10) & 31, (w >> 20) & 31], axis=-1
    )
    hi = jnp.stack(
        [(w >> 5) & 31, (w >> 15) & 31, (w >> 25) & 31], axis=-1
    )
    return lo, hi


def decode_cell_info(info: jnp.ndarray):
    """uint32 -> (first_block i32, n_blocks i32, lo_ext (...,3) i32,
    hi_ext (...,3) i32).

    n_blocks is 0 exactly for empty cells (bit 31 set), whose packed
    empty-box extents come back in lo/hi_ext; occupied cells' extents
    decode as garbage and must be gated on n_blocks > 0 (the march
    leaps only from empty cells)."""
    empty = (info >> 31) != 0
    first = (info & _FIRST_MASK).astype(jnp.int32)
    nblk = jnp.where(
        empty, 0, ((info >> _NBLK_SHIFT) & _NBLK_MASK).astype(jnp.int32)
    )
    lo, hi = _decode_extents(info)
    return first, nblk, lo, hi


def decode_inline_header(row: jnp.ndarray):
    """Inline-layout row -> (overflow_first i32, n_rows i32,
    lo_ext (...,3) i32, hi_ext (...,3) i32).

    The header rides the last two lanes of every cell's first row as
    bitcast int32: lane[-1] = n_rows (counts the inline row itself;
    0 = empty cell); lane[-2] = absolute index of the cell's first
    OVERFLOW row (rows 2..n are contiguous there) for occupied cells,
    or the 30-bit packed empty-box extents for empty cells (gate on
    n_rows == 0).  Overflow/padding rows carry zero headers — only
    probe lanes decode.
    """
    h0 = jax.lax.bitcast_convert_type(row[..., -2], jnp.int32)
    h1 = jax.lax.bitcast_convert_type(row[..., -1], jnp.int32)
    lo, hi = _decode_extents(h0)
    return h0, h1 & 0xFFFF, lo, hi


def greedy_empty_boxes(occupied: np.ndarray, cap: int = EXT_CAP) -> np.ndarray:
    """Per-cell maximal empty box for every EMPTY cell (host numpy).

    occupied: (nz, ny, nx) bool -> ext (6, nz, ny, nx) int32 extents
    [x-, x+, y-, y+, z-, z+] (numpy axis order is [z, y, x]; x is the
    fastest axis, matching the packed linear index).  The box spanned by
    cell c and its extents contains no occupied cell; cells outside the
    grid count as empty (the ray exits anyway).  Occupied cells get all
    zeros.

    Growth is BALANCED greedy round-robin: every direction attempts one
    cell per round, each attempted slab's emptiness one O(1) lookup
    against a 3-D summed-area table.  Balance matters more than speed:
    a geometric-step variant (grow x by 16 first, ...) was measured to
    REGRESS the march (nefertiti 9.55 -> 10.35 mean steps) because the
    early long-x boxes leave 33-cell-long y/z slabs that can never
    clear near the surface band, starving the other axes — diagonal
    rays then exit through a zero-extent face after one cell where the
    old Chebyshev cube leapt d-1.  Round-robin +1 growth keeps boxes
    cube-ish until a direction is genuinely blocked, which is what the
    21%/36% probe-step reduction was counted on.
    Greedy is a heuristic — the true maximal box per cell is NP-ish to
    pick globally — but the march only needs SAFE boxes.

    The native C++ builder (rtpu_empty_boxes, bitwise-identical growth)
    serves production builds — the numpy path below is the correctness
    reference and fallback (48 s vs ~1 s on the 128^3 dense-scene
    build).
    """
    from ray_tracer_tpu.accel.native import empty_boxes_native

    out = empty_boxes_native(occupied, cap)
    if out is not None:
        return out
    nz, ny, nx = occupied.shape
    S = np.zeros((nz + 1, ny + 1, nx + 1), np.int64)
    S[1:, 1:, 1:] = occupied.astype(np.int64).cumsum(0).cumsum(1).cumsum(2)

    def box_count(zlo, zhi, ylo, yhi, xlo, xhi):
        # inclusive cell-coord box, clipped (outside the grid is empty)
        zlo = np.clip(zlo, 0, nz); zhi = np.clip(zhi + 1, 0, nz)
        ylo = np.clip(ylo, 0, ny); yhi = np.clip(yhi + 1, 0, ny)
        xlo = np.clip(xlo, 0, nx); xhi = np.clip(xhi + 1, 0, nx)
        return (S[zhi, yhi, xhi] - S[zlo, yhi, xhi] - S[zhi, ylo, xhi]
                - S[zhi, yhi, xlo] + S[zlo, ylo, xhi] + S[zlo, yhi, xlo]
                + S[zhi, ylo, xlo] - S[zlo, ylo, xlo])

    # active set: flat coordinates of empty cells still growing — the
    # box_count gathers shrink with it as cells saturate
    zc, yc, xc = (a.ravel() for a in np.nonzero(~occupied))
    ext_a = np.zeros((6, len(zc)), np.int32)
    ext = np.zeros((6, nz, ny, nx), np.int32)
    for _ in range(cap):
        grew_any = np.zeros(len(zc), bool)
        for d in range(6):
            xlo, xhi = xc - ext_a[0], xc + ext_a[1]
            ylo, yhi = yc - ext_a[2], yc + ext_a[3]
            zlo, zhi = zc - ext_a[4], zc + ext_a[5]
            if d == 0:   slab = (zlo, zhi, ylo, yhi, xlo - 1, xlo - 1)
            elif d == 1: slab = (zlo, zhi, ylo, yhi, xhi + 1, xhi + 1)
            elif d == 2: slab = (zlo, zhi, ylo - 1, ylo - 1, xlo, xhi)
            elif d == 3: slab = (zlo, zhi, yhi + 1, yhi + 1, xlo, xhi)
            elif d == 4: slab = (zlo - 1, zlo - 1, ylo, yhi, xlo, xhi)
            else:        slab = (zhi + 1, zhi + 1, ylo, yhi, xlo, xhi)
            ok = (ext_a[d] < cap) & (box_count(*slab) == 0)
            ext_a[d][ok] += 1
            grew_any |= ok
        if not grew_any.any():
            break
        if not grew_any.all():
            # retire saturated cells
            ext[:, zc[~grew_any], yc[~grew_any], xc[~grew_any]] = (
                ext_a[:, ~grew_any]
            )
            zc, yc, xc = zc[grew_any], yc[grew_any], xc[grew_any]
            ext_a = ext_a[:, grew_any]
    if len(zc):
        ext[:, zc, yc, xc] = ext_a
    return ext


def pack_extents(ext: np.ndarray) -> np.ndarray:
    """(6, ...) int32 extents -> (...,) uint32, 5 bits per direction in
    bits 0..29 ([x-@0, x+@5, y-@10, y+@15, z-@20, z+@25] — the layout
    _decode_extents reads)."""
    e = ext.astype(np.uint32)
    return (e[0] | (e[1] << 5) | (e[2] << 10) | (e[3] << 15)
            | (e[4] << 20) | (e[5] << 25))


def chebyshev_distance_field(occupied: np.ndarray, cap: int = DIST_CAP) -> np.ndarray:
    """Chebyshev (L-inf) distance to the nearest True cell, capped.

    Separable iterative dilation: one 3x3x3 max-dilation per ring.
    occupied: (nx, ny, nz) bool -> (nx, ny, nz) int32.
    """
    dist = np.where(occupied, 0, cap).astype(np.int32)
    frontier = occupied.copy()
    for k in range(1, cap):
        if frontier.all():
            break
        grown = frontier.copy()
        for axis in range(3):
            shifted_fwd = np.roll(grown, 1, axis=axis)
            shifted_bwd = np.roll(grown, -1, axis=axis)
            # roll wraps; kill the wrapped slice
            sl_lo = [slice(None)] * 3
            sl_lo[axis] = 0
            sl_hi = [slice(None)] * 3
            sl_hi[axis] = -1
            shifted_fwd[tuple(sl_lo)] = False
            shifted_bwd[tuple(sl_hi)] = False
            grown = grown | shifted_fwd | shifted_bwd
        newly = grown & ~frontier
        dist[newly] = k
        frontier = grown
    return dist


def pack_grid(
    grid: UniformGrid,
    verts: np.ndarray,
    faces: np.ndarray,
    block_tris: int = BLOCK_TRIS,
    pad_meta: "PackedGridMeta | None" = None,
    as_numpy: bool = False,
    inline: bool = False,
    leap: str = "box",
) -> PackedGrid:
    """Build the packed layout from the CSR grid (host-side numpy).

    block_tris sets the row capacity; the row width is 9*block_tris
    rounded up to a multiple of 128 lanes (14 -> 128, 28 -> 256,
    56 -> 512).  Wider rows halve the iteration count for dense voxels
    at slightly higher per-gather cost — tune per scene density.

    inline=True builds the one-gather-per-step layout (see
    PackedGridMeta.inline): `blocks` row `lin` IS cell lin's first
    triangle row with the header bitcast into its last two lanes
    (decode_inline_header); rows past the first live contiguously in an
    overflow region after the n_cells dense rows.  cell_info is a dummy
    (1,) array — the march never gathers it.  Triangle order per cell
    is IDENTICAL to the blocks layout, so hits (including ties) are
    bit-identical between the two.

    pad_meta: a previous build's meta to pad up to, so a jitted
    consumer keyed on PackedGridMeta keeps its compiled step across
    vertex-optimization rebuilds.  Applied when compatible (same
    resolution/row shape, block count fits, probe nudge still sane);
    otherwise the fresh meta is returned and the caller re-jits.
    Padding block rows are unreachable — cell_info never points at
    them.

    as_numpy: keep every array leaf in host numpy (no device upload) —
    for builders that post-process/stack several packs before one
    upload (the ring-pass sharded-geometry build).  Requires a
    host-built grid (grid.host present).

    leap: empty-cell leap geometry.  "box" (default) builds greedy
    maximal empty boxes (anisotropic, the production winner on every
    scene class); "cheb" reproduces the rounds-1-3 Chebyshev cube
    (symmetric extents dist-1) — kept so the old behavior stays
    reconstructible and testable.  Hit results are identical either
    way (leaps only skip verified-empty cells); only step counts
    differ.
    """
    # inline rows reserve the last two lanes for the bitcast header;
    # rows round up to 128 lanes (carried over from the previous chip's
    # vector width, not yet tuned on the H100)
    row_lanes = -(-(block_tris * 9 + (2 if inline else 0)) // 128) * 128
    nx, ny, nz = grid.meta.n_voxels
    n_cells = nx * ny * nz
    host = grid.host
    if host is None:  # grid built elsewhere; pull once
        cell_start = np.asarray(grid.arrays.cell_start)
        tri_ids = np.asarray(grid.arrays.tri_ids)
        min_w = float(np.min(np.asarray(grid.arrays.width)))
    else:
        cell_start = host.cell_start
        tri_ids = host.tri_ids
        min_w = float(np.min(host.width))
    counts = np.diff(cell_start).astype(np.int64)

    nblk = (counts + block_tris - 1) // block_tris
    if nblk.max(initial=0) > (0xFFFF if inline else _NBLK_MASK):
        raise ValueError(
            f"voxel with {counts.max()} triangles exceeds the packed-layout "
            f"cap; increase grid resolution"
        )

    # occupancy + empty-box field (z-major linear index -> (x,y,z) shaped
    # as [z,y,x] to match offset = z*nx*ny + y*nx + x, grid.h:73-75)
    occ = (counts > 0).reshape(nz, ny, nx)
    if leap == "box":
        ext = greedy_empty_boxes(occ)
    elif leap == "cheb":
        # the pre-round-4 Chebyshev cube expressed as symmetric extents:
        # rad = max(dist, 1) spanned [cell-(rad-1), cell+rad-1]
        d = np.maximum(chebyshev_distance_field(occ) - 1, 0)
        ext = np.broadcast_to(d, (6,) + occ.shape).astype(np.int32)
    else:
        raise ValueError(f"unknown leap mode {leap!r}")
    extw = pack_extents(ext).reshape(-1)

    if inline:
        # cell c's first row IS row c; rows 2..n_rows live contiguously
        # in the overflow region starting at n_cells
        overflow = np.maximum(nblk - 1, 0)
        ov_first = np.full(n_cells, n_cells, np.int64)
        np.cumsum(overflow[:-1], out=ov_first[1:])
        ov_first += n_cells
        total_blocks = int(n_cells + overflow.sum())
        total_blocks = max(total_blocks, 1)
        info = np.zeros(1, np.uint32)  # unused by the inline march
    else:
        first = np.zeros(n_cells, np.int64)
        np.cumsum(nblk[:-1], out=first[1:])
        total_blocks = int(first[-1] + nblk[-1]) if n_cells else 0
        total_blocks = max(total_blocks, 1)
        if total_blocks > _FIRST_MASK:
            raise ValueError(
                f"{total_blocks} blocks exceeds the 21-bit block index"
            )
        info = np.where(
            counts > 0,
            first.astype(np.uint32) | (nblk.astype(np.uint32) << _NBLK_SHIFT),
            _EMPTY_FLAG | extw,
        )

    # scatter triangle data into block rows (vectorized)
    v = verts.astype(np.float32)[faces]  # (F, 3, 3)
    tri9 = v.reshape(-1, 9)  # (F, 9) [v0 v1 v2]

    blocks = np.zeros((total_blocks, row_lanes), np.float32)
    slot_tri = np.full((total_blocks * block_tris,), -1, np.int32)

    if inline and n_cells:
        # headers into every cell row's last two lanes (empty cells too:
        # the probe reads n_rows=0 + the leap box from them)
        hdr = blocks[:n_cells, row_lanes - 2:].view(np.int32)
        hdr[:, 0] = np.where(
            counts > 0, ov_first, extw.astype(np.int64)
        ).astype(np.int32)
        hdr[:, 1] = nblk.astype(np.int32)

    nnz = tri_ids.shape[0]
    if nnz:
        # CSR entry e belongs to cell c(e); its slot within the cell is
        # e - cell_start[c]; its block row is first[c] + slot//block_tris
        # (blocks layout) or cell/overflow row (inline layout).
        entry_cell = np.repeat(np.arange(n_cells, dtype=np.int64), counts)
        within = np.arange(nnz, dtype=np.int64) - cell_start[entry_cell]
        if inline:
            row = np.where(
                within < block_tris,
                entry_cell,
                ov_first[entry_cell] + within // block_tris - 1,
            )
        else:
            row = first[entry_cell] + within // block_tris
        slot = within % block_tris
        blocks_flat = blocks.reshape(-1)
        lane0 = row * row_lanes + slot * 9
        for c in range(9):
            blocks_flat[lane0 + c] = tri9[tri_ids, c]
        slot_tri[row * block_tris + slot] = tri_ids

    meta = PackedGridMeta(
        n_voxels=(nx, ny, nz),
        n_blocks=total_blocks,
        probe_delta=max(min_w * 1e-3, 1e-6),
        block_tris=block_tris,
        row_lanes=row_lanes,
        max_blocks=int(nblk.max(initial=1)),
        inline=inline,
    )
    if (
        pad_meta is not None
        and pad_meta.inline == inline
        and pad_meta.n_voxels == meta.n_voxels
        and pad_meta.block_tris == block_tris
        and pad_meta.row_lanes == row_lanes
        and pad_meta.n_blocks >= total_blocks
        and pad_meta.max_blocks >= meta.max_blocks
        # the old probe nudge must stay tiny vs the new cells (skip
        # hazard) yet large enough to make progress (march slowdown)
        and 0.2 * meta.probe_delta <= pad_meta.probe_delta <= 5.0 * meta.probe_delta
    ):
        extra = pad_meta.n_blocks - total_blocks
        if extra:
            blocks = np.concatenate(
                [blocks, np.zeros((extra, row_lanes), np.float32)]
            )
            slot_tri = np.concatenate(
                [slot_tri, np.full((extra * block_tris,), -1, np.int32)]
            )
        meta = pad_meta
    if as_numpy:
        assert host is not None, "as_numpy pack requires a host-built grid"
        arrays = PackedGridArrays(
            lower=np.asarray(host.lower, np.float32),
            upper=np.asarray(host.upper, np.float32),
            width=np.asarray(host.width, np.float32),
            inv_width=np.asarray(host.inv_width, np.float32),
            cell_info=info,
            blocks=blocks,
            slot_tri=slot_tri,
        )
        return PackedGrid(arrays=arrays, meta=meta)
    arrays = PackedGridArrays(
        lower=grid.arrays.lower,
        upper=grid.arrays.upper,
        width=grid.arrays.width,
        inv_width=grid.arrays.inv_width,
        cell_info=jnp.asarray(info),
        blocks=jnp.asarray(blocks),
        slot_tri=jnp.asarray(slot_tri),
    )
    return PackedGrid(arrays=arrays, meta=meta)
