"""Uniform-grid acceleration structure: vectorized two-pass CSR build.

Reproduces the reference's GridAccel construction exactly
(Serial/grid.h:79-153; the CUDA variant's two-pass count->alloc->fill at
Parallel/grid.cuh:137-207) but as a fully vectorized numpy build emitting
a CSR layout suited to batched device gathers:

  * resolution heuristic: voxelsPerUnitDist = 3*cbrt(F)/maxExtent,
    nVoxels = clamp(int(delta*vpud + 1), 1, 64) per axis, computed in
    float32 to match the reference's arithmetic (grid.h:94-101);
  * a triangle is inserted into every voxel overlapped by its AABB
    (grid.h:118-150) — conservative, no exact tri/box test, as in the
    reference;
  * z-major linear voxel index offset(x,y,z) = z*nx*ny + y*nx + x
    (grid.h:73-75);
  * within a voxel, triangles appear in ascending triangle order — the
    same order the reference's insertion loop produces — so sequential
    nearest-hit tie-breaking matches the oracle.

The device-side layout is CSR (cell_start (n+1,), tri_ids (nnz,))
instead of the reference's pointer-table-of-arrays, so traversal gathers
contiguous windows with static shapes.

An optional C++ builder (native/raytpu_native.cc) provides a faster host
build for large scenes; the numpy build is the correctness reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np


class GridMeta(NamedTuple):
    """Static (hashable) grid metadata — safe to close over in jit."""

    n_voxels: Tuple[int, int, int]
    max_per_voxel: int
    nnz: int

    @property
    def total_voxels(self) -> int:
        nx, ny, nz = self.n_voxels
        return nx * ny * nz


class GridArrays(NamedTuple):
    """Device-resident grid data."""

    lower: jnp.ndarray  # (3,) f32 scene AABB
    upper: jnp.ndarray  # (3,)
    width: jnp.ndarray  # (3,) voxel widths
    inv_width: jnp.ndarray  # (3,) 0 where width == 0
    cell_start: jnp.ndarray  # (total_voxels + 1,) i32 CSR offsets
    tri_ids: jnp.ndarray  # (nnz,) i32


class GridHost(NamedTuple):
    """Host (numpy) mirror of the grid, kept so downstream host-side
    consumers (block packing, scene edits) never pull arrays back off
    the device."""

    lower: np.ndarray
    upper: np.ndarray
    width: np.ndarray
    inv_width: np.ndarray
    cell_start: np.ndarray
    tri_ids: np.ndarray


@dataclass(frozen=True)
class UniformGrid:
    arrays: GridArrays
    meta: GridMeta
    host: GridHost = None


def _max_axis(delta: np.ndarray) -> int:
    """Reference maxAxis comparison chain (Serial/geometry.h:276-285)."""
    axis = 0 if delta[0] > delta[1] else 1
    if axis == 1:
        return 1 if delta[1] > delta[2] else 2
    return 0 if delta[0] > delta[2] else 2


def grid_resolution(
    lower: np.ndarray,
    upper: np.ndarray,
    num_tris: int,
    resolution_multiplier: float = 3.0,
    max_resolution: int = 64,
) -> np.ndarray:
    """nVoxels per axis with the reference's float32 arithmetic (grid.h:94-101)."""
    delta = (upper - lower).astype(np.float32)
    if delta[_max_axis(delta)] == 0.0:
        # fully degenerate mesh (all referenced points identical): the
        # reference formula divides by zero; define it as a 1-cell grid
        # instead of letting inf * 0 = NaN reach the int cast
        return np.ones((3,), np.int32)
    max_inv_width = np.float32(1.0) / delta[_max_axis(delta)]
    cube_root = np.float32(resolution_multiplier) * np.float32(
        np.power(np.float32(num_tris), np.float32(1.0 / 3.0))
    )
    vpud = cube_root * max_inv_width
    n = (delta * vpud + np.float32(1.0)).astype(np.int32)  # C truncation
    return np.clip(n, 1, max_resolution)


def pos_to_voxel(p: np.ndarray, lower: np.ndarray, inv_width: np.ndarray, n_voxels: np.ndarray) -> np.ndarray:
    """posToVoxel with C int-cast truncation + clamp (grid.h:59-66).
    p: (...,3) -> (...,3) int32."""
    v = ((p - lower) * inv_width).astype(np.float32)
    v = np.trunc(v).astype(np.int32)
    return np.clip(v, 0, n_voxels - 1)


def tri_box_overlap(
    v0: np.ndarray,
    v1: np.ndarray,
    v2: np.ndarray,
    box_lo: np.ndarray,
    box_hi: np.ndarray,
    pad: np.ndarray,
) -> np.ndarray:
    """Vectorized SAT triangle/AABB overlap (Akenine-Möller 2001).

    All inputs (P, 3) float64; `pad` inflates the box half-extents so
    the test stays CONSERVATIVE against float32 rounding elsewhere
    (grid binning, the traversal's probe-point cell assignment).  The
    three box-normal axes are assumed already tested by the caller
    (candidate pairs come from an AABB-overlap expansion), so this
    runs the triangle-plane axis and the 9 edge-cross axes, with
    inclusive comparisons (boundary touch counts as overlap).
    Returns (P,) bool.
    """
    c = (box_lo + box_hi) * 0.5
    h = (box_hi - box_lo) * 0.5 + pad
    u0, u1, u2 = v0 - c, v1 - c, v2 - c

    def sep(ax, ay, az):
        """True where the axis (ax, ay, az) separates box and triangle."""
        p0 = ax * u0[:, 0] + ay * u0[:, 1] + az * u0[:, 2]
        p1 = ax * u1[:, 0] + ay * u1[:, 1] + az * u1[:, 2]
        p2 = ax * u2[:, 0] + ay * u2[:, 1] + az * u2[:, 2]
        r = (h[:, 0] * np.abs(ax) + h[:, 1] * np.abs(ay)
             + h[:, 2] * np.abs(az))
        lo = np.minimum(np.minimum(p0, p1), p2)
        hi = np.maximum(np.maximum(p0, p1), p2)
        return (lo > r) | (hi < -r)

    e0, e1, e2 = u1 - u0, u2 - u1, u0 - u2
    # triangle-plane axis
    nx = e0[:, 1] * e1[:, 2] - e0[:, 2] * e1[:, 1]
    ny = e0[:, 2] * e1[:, 0] - e0[:, 0] * e1[:, 2]
    nz = e0[:, 0] * e1[:, 1] - e0[:, 1] * e1[:, 0]
    separated = sep(nx, ny, nz)
    # 9 edge-cross axes: cross(unit_j, edge) for j in {x, y, z}
    for e in (e0, e1, e2):
        ex, ey, ez = e[:, 0], e[:, 1], e[:, 2]
        zero = np.zeros_like(ex)
        separated |= sep(zero, -ez, ey)
        separated |= sep(ez, zero, -ex)
        separated |= sep(-ey, ex, zero)
    return ~separated


def build_grid(
    verts: np.ndarray,
    faces: np.ndarray,
    resolution_multiplier: float = 3.0,
    max_resolution: int = 64,
    use_native: bool = True,
    force_resolution: "tuple[int, int, int] | None" = None,
    exact_overlap: bool = False,
) -> UniformGrid:
    """force_resolution overrides the 3∛N heuristic with a fixed
    (nx, ny, nz) — needed when several grids must share one static
    meta (the ring-pass sharded-geometry build stacks per-shard grids
    under a common jit).

    Binning is FLOAT32 (the reference's vertex precision, and the
    native builder's ABI): cell lists are conservative for f32 scenes;
    a float64 scene is binned by its f32 rounding, so f64 geometry is
    not a supported bitwise surface (the oracle-parity mode uses f32
    verts with f64 determinants, not f64 verts)."""
    verts = np.asarray(verts, dtype=np.float32)
    faces = np.asarray(faces, dtype=np.int32)
    num_tris = faces.shape[0]
    if force_resolution is not None:
        use_native = False  # the native builder computes its own resolution

    if use_native and num_tris > 0:
        try:
            from ray_tracer_tpu.accel import native

            built = native.build_grid_native(
                verts, faces, resolution_multiplier, max_resolution,
                exact_overlap=exact_overlap,
            )
        except Exception:
            built = None
        if built is not None:
            n3, lower, upper, width, inv_width, cell_start, tri_ids = built
            nx, ny, nz = (int(x) for x in n3)
            return _assemble_grid(
                nx, ny, nz, lower, upper, width, inv_width,
                cell_start, tri_ids,
            )

    if num_tris == 0:
        # empty shard/selection: a valid empty grid, not a crash —
        # _build_csr_numpy's num_tris == 0 branch handles the CSR
        tri_lo = np.zeros((0, 3), np.float32)
        tri_hi = tri_lo
        lower = np.zeros((3,), np.float32)
        upper = np.zeros((3,), np.float32)
    else:
        v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
        tri_lo = np.minimum(np.minimum(v0, v1), v2)
        tri_hi = np.maximum(np.maximum(v0, v1), v2)
        lower = tri_lo.min(axis=0)
        upper = tri_hi.max(axis=0)

    if force_resolution is not None:
        n_voxels = np.asarray(force_resolution, np.int32)
    else:
        n_voxels = grid_resolution(
            lower, upper, num_tris, resolution_multiplier, max_resolution
        )
    delta = (upper - lower).astype(np.float32)
    width = delta / n_voxels.astype(np.float32)
    with np.errstate(divide="ignore"):  # zero-extent axes (thin slices)
        inv_width = np.where(
            width == 0.0, np.float32(0.0), np.float32(1.0) / width
        )

    nx, ny, nz = (int(x) for x in n_voxels)

    cell_start, tri_ids = _build_csr_numpy(
        tri_lo, tri_hi, lower, inv_width, n_voxels, nx, ny,
        exact=(verts, faces, width) if exact_overlap and num_tris else None,
    )
    return _assemble_grid(
        nx, ny, nz, lower, upper, width, inv_width, cell_start, tri_ids
    )


def _assemble_grid(nx, ny, nz, lower, upper, width, inv_width,
                   cell_start, tri_ids) -> "UniformGrid":
    """The one GridMeta/GridArrays/GridHost assembly shared by the
    native and numpy build branches."""
    counts = np.diff(cell_start)
    meta = GridMeta(
        n_voxels=(nx, ny, nz),
        max_per_voxel=int(counts.max()) if counts.size else 0,
        nnz=int(tri_ids.shape[0]),
    )
    arrays = GridArrays(
        lower=jnp.asarray(lower),
        upper=jnp.asarray(upper),
        width=jnp.asarray(width),
        inv_width=jnp.asarray(inv_width),
        cell_start=jnp.asarray(cell_start, dtype=jnp.int32),
        tri_ids=jnp.asarray(tri_ids, dtype=jnp.int32),
    )
    host = GridHost(
        lower=np.asarray(lower), upper=np.asarray(upper),
        width=np.asarray(width), inv_width=np.asarray(inv_width),
        cell_start=np.asarray(cell_start), tri_ids=np.asarray(tri_ids),
    )
    return UniformGrid(arrays=arrays, meta=meta, host=host)


def pad_grid_like(grid: "UniformGrid", like: GridMeta) -> "UniformGrid | None":
    """Pad a freshly built grid to `like`'s static sizes so a jitted
    consumer keyed on GridMeta keeps its compiled step across vertex-
    optimization rebuilds (opt/fit.fit with rebuild_grid_every).

    Returns None when incompatible — resolution changed or the build
    outgrew the padding — and the caller re-jits on the new meta.
    Padding tri_ids entries are unreachable: cell_start never points
    past the real nnz, so any fill value is inert."""
    m = grid.meta
    if m == like:
        return grid
    if (
        m.n_voxels != like.n_voxels
        or m.nnz > like.nnz
        or m.max_per_voxel > like.max_per_voxel
    ):
        return None
    host = grid.host
    if host is None:
        return None
    tri_ids = np.concatenate(
        [host.tri_ids, np.zeros(like.nnz - m.nnz, np.int32)]
    )
    arrays = grid.arrays._replace(tri_ids=jnp.asarray(tri_ids, dtype=jnp.int32))
    return UniformGrid(
        arrays=arrays, meta=like, host=host._replace(tri_ids=tri_ids)
    )


def _build_csr_numpy(tri_lo, tri_hi, lower, inv_width, n_voxels, nx, ny,
                     exact=None):
    """Vectorized insertion: expand each triangle into its overlapped voxel
    range, then stable-sort by cell.  Equivalent to the reference's triple
    loop (grid.h:135-148) including within-cell triangle ordering.

    exact=(verts, faces, width): SAT-filter the candidate pairs so a
    triangle only enters voxels it geometrically touches (GridConfig
    .exact_overlap) — the within-cell triangle order of the survivors
    is unchanged."""
    num_tris = tri_lo.shape[0]
    total = int(n_voxels[0]) * int(n_voxels[1]) * int(n_voxels[2])
    if num_tris == 0:
        return np.zeros(total + 1, dtype=np.int64), np.zeros(0, dtype=np.int32)

    vmin = pos_to_voxel(tri_lo, lower, inv_width, n_voxels)  # (F,3)
    vmax = pos_to_voxel(tri_hi, lower, inv_width, n_voxels)
    span = (vmax - vmin + 1).astype(np.int64)  # (F,3)
    per_tri = span[:, 0] * span[:, 1] * span[:, 2]
    starts = np.concatenate([[0], np.cumsum(per_tri)])
    total_entries = int(starts[-1])

    tri_of = np.repeat(np.arange(num_tris, dtype=np.int64), per_tri)
    within = np.arange(total_entries, dtype=np.int64) - starts[tri_of]

    syz = span[tri_of, 1] * span[tri_of, 2]
    dx = within // syz
    rem = within % syz
    dy = rem // span[tri_of, 2]
    dz = rem % span[tri_of, 2]

    x = vmin[tri_of, 0] + dx
    y = vmin[tri_of, 1] + dy
    z = vmin[tri_of, 2] + dz

    if exact is not None:
        verts, faces, width = exact
        # cell box in f64 from the f32 grid frame; the pad absorbs (a)
        # the f32 binning error of pos_to_voxel / the traversal's probe
        # point (relative to coordinate magnitude, so ~1e-4 of a cell
        # at 128 cells/axis) and (b) boundary-touching triangles, which
        # must stay discoverable from either neighbor.
        lo64 = lower.astype(np.float64)
        w64 = width.astype(np.float64)
        idx = np.stack([x, y, z], axis=1).astype(np.float64)
        box_lo = lo64 + idx * w64
        box_hi = lo64 + (idx + 1.0) * w64
        pad = np.maximum(w64 * 1e-4, 1e-12)
        pad = np.broadcast_to(pad, box_lo.shape)
        f = faces[tri_of]
        keep = tri_box_overlap(
            verts[f[:, 0]].astype(np.float64),
            verts[f[:, 1]].astype(np.float64),
            verts[f[:, 2]].astype(np.float64),
            box_lo, box_hi, pad,
        )
        tri_of, x, y, z = tri_of[keep], x[keep], y[keep], z[keep]

    cell = z * (nx * ny) + y * nx + x  # z-major (grid.h:73-75)

    order = np.argsort(cell, kind="stable")
    cell_sorted = cell[order]
    tri_ids = tri_of[order].astype(np.int32)

    counts = np.bincount(cell_sorted, minlength=total)
    cell_start = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return cell_start, tri_ids
