"""Ray-triangle intersection kernels.

`cramer_tbg` is the reference's Cramer's-rule solve
(Serial/geometry.h:131-177, det expansion Serial/raytracer.cpp:203-211)
computed elementwise over any broadcastable batch of (ray, triangle)
pairs.  With det_dtype=float64 on CPU it matches the oracle's
double-precision determinants bit-for-bit.  `intersect_brute` sweeps
all (ray, triangle) pairs with it — the O(N) cross-check of the grid
walks.

The acceptance test is the reference's exact strict-inequality predicate
beta > 0 and gamma > 0 and beta + gamma < 1 (geometry.h:162).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax.numpy as jnp

from ray_tracer_tpu.core import vecmath as vm
from ray_tracer_tpu.core.rays import RayBatch


def cramer_tbg(
    orig: jnp.ndarray,
    dirn: jnp.ndarray,
    v0: jnp.ndarray,
    v1: jnp.ndarray,
    v2: jnp.ndarray,
    det_dtype=jnp.float32,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Solve orig + t*dir = v0 + beta*(v1-v0) + gamma*(v2-v0) by Cramer.

    All inputs broadcast over leading dims with trailing dim 3.
    Returns (t, beta, gamma) in det_dtype.  Division by a zero determinant
    yields inf/nan which the strict comparisons downstream reject, exactly
    as in the reference.
    """
    o = orig.astype(det_dtype)
    d = dirn.astype(det_dtype)
    a = v0.astype(det_dtype)
    b = v1.astype(det_dtype)
    c = v2.astype(det_dtype)

    e1 = a - b  # column 1: v0 - v1
    e2 = a - c  # column 2: v0 - v2
    s = a - o  # rhs: v0 - orig

    A = vm.det3(
        e1[..., 0], e2[..., 0], d[..., 0],
        e1[..., 1], e2[..., 1], d[..., 1],
        e1[..., 2], e2[..., 2], d[..., 2],
    )
    t = vm.det3(
        e1[..., 0], e2[..., 0], s[..., 0],
        e1[..., 1], e2[..., 1], s[..., 1],
        e1[..., 2], e2[..., 2], s[..., 2],
    ) / A
    beta = vm.det3(
        s[..., 0], e2[..., 0], d[..., 0],
        s[..., 1], e2[..., 1], d[..., 1],
        s[..., 2], e2[..., 2], d[..., 2],
    ) / A
    gamma = vm.det3(
        e1[..., 0], s[..., 0], d[..., 0],
        e1[..., 1], s[..., 1], d[..., 1],
        e1[..., 2], s[..., 2], d[..., 2],
    ) / A
    return t, beta, gamma


def cramer_t_safe(
    orig: jnp.ndarray,
    dirn: jnp.ndarray,
    v0: jnp.ndarray,
    v1: jnp.ndarray,
    v2: jnp.ndarray,
    valid: jnp.ndarray,
    det_dtype=jnp.float32,
) -> jnp.ndarray:
    """Hit distance t only, with the divisor guarded on invalid lanes.

    On `valid` lanes the arithmetic (det expansion order, division) is
    bit-identical to `cramer_tbg`'s t.  On invalid lanes — whose gathered
    triangle is arbitrary (A may be 0) and whose ray may carry inf
    origins (retired bounce lanes) — ALL inputs are sanitized first:
    guarding only the outputs would still leak inf residuals into the
    backward pass as nan (inf * zero-cotangent).
    """
    e1, e2, s, d, A_safe, guard = _safe_cramer_columns(
        orig, dirn, v0, v1, v2, valid, det_dtype
    )
    tn = vm.det3(
        e1[..., 0], e2[..., 0], s[..., 0],
        e1[..., 1], e2[..., 1], s[..., 1],
        e1[..., 2], e2[..., 2], s[..., 2],
    )
    tn_safe = jnp.where(guard, tn, jnp.asarray(0.0, det_dtype))
    return tn_safe / A_safe


def cramer_bg_safe(
    orig: jnp.ndarray,
    dirn: jnp.ndarray,
    v0: jnp.ndarray,
    v1: jnp.ndarray,
    v2: jnp.ndarray,
    valid: jnp.ndarray,
    det_dtype=jnp.float32,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(beta, gamma) only, inputs sanitized on invalid lanes (see
    cramer_t_safe) — used by the soft-visibility path to differentiate
    the blocker's barycentric margin without nan leakage from lanes
    whose gathered triangle is arbitrary or whose ray is retired."""
    e1, e2, s, d, A_safe, guard = _safe_cramer_columns(
        orig, dirn, v0, v1, v2, valid, det_dtype
    )
    bn = vm.det3(
        s[..., 0], e2[..., 0], d[..., 0],
        s[..., 1], e2[..., 1], d[..., 1],
        s[..., 2], e2[..., 2], d[..., 2],
    )
    gn = vm.det3(
        e1[..., 0], s[..., 0], d[..., 0],
        e1[..., 1], s[..., 1], d[..., 1],
        e1[..., 2], s[..., 2], d[..., 2],
    )
    z = jnp.asarray(0.0, det_dtype)
    return (
        jnp.where(guard, bn, z) / A_safe,
        jnp.where(guard, gn, z) / A_safe,
    )


def _safe_cramer_columns(orig, dirn, v0, v1, v2, valid, det_dtype):
    """The shared sanitize + column + guarded-divisor block of the
    `_safe` Cramer variants: (e1, e2, s, d, A_safe, guard).  One
    implementation so an edit to the sanitization or the A != 0 guard
    cannot desynchronize t from beta/gamma on guarded lanes."""
    vmask = valid[..., None]
    o = jnp.where(vmask, orig, 0.0).astype(det_dtype)
    d = jnp.where(vmask, dirn, 1.0).astype(det_dtype)
    a = v0.astype(det_dtype)
    b = v1.astype(det_dtype)
    c = v2.astype(det_dtype)
    e1 = a - b
    e2 = a - c
    s = a - o
    A = vm.det3(
        e1[..., 0], e2[..., 0], d[..., 0],
        e1[..., 1], e2[..., 1], d[..., 1],
        e1[..., 2], e2[..., 2], d[..., 2],
    )
    guard = valid & (A != 0)
    A_safe = jnp.where(guard, A, jnp.asarray(1.0, det_dtype))
    return e1, e2, s, d, A_safe, guard


def barycentric_pass(beta: jnp.ndarray, gamma: jnp.ndarray) -> jnp.ndarray:
    """The reference's acceptance predicate (Serial/geometry.h:162)."""
    return (beta > 0) & (gamma > 0) & (beta + gamma < 1)


class BruteResult(NamedTuple):
    any_pass: jnp.ndarray  # (R,) bool: any barycentric pass at all
    t: jnp.ndarray  # (R,) nearest accepted t (f32)
    tri_id: jnp.ndarray  # (R,) i32 argmin triangle (valid iff hit)
    hit: jnp.ndarray  # (R,) bool: a nearest hit was recorded


def intersect_brute(
    rays: RayBatch,
    v0: jnp.ndarray,
    v1: jnp.ndarray,
    v2: jnp.ndarray,
    t_lower: Optional[float] = None,
    det_dtype=jnp.float32,
) -> BruteResult:
    """All-pairs nearest hit over (R rays x F tris).

    t_lower=None reproduces the serial reference's unrestricted-t update
    (negative t accepted, Serial/geometry.h:164-171); t_lower=eps
    reproduces the CUDA variant's t > eps gate
    (Parallel/geometry.cuh:155-161).
    """
    t, beta, gamma = cramer_tbg(
        rays.orig[:, None, :], rays.dirn[:, None, :], v0[None], v1[None], v2[None],
        det_dtype=det_dtype,
    )
    passed = barycentric_pass(beta, gamma)
    accept = passed if t_lower is None else passed & (t > t_lower)

    big = jnp.asarray(jnp.inf, t.dtype)
    t_masked = jnp.where(accept, t, big)
    tri_id = jnp.argmin(t_masked, axis=1).astype(jnp.int32)
    t_best = jnp.take_along_axis(t_masked, tri_id[:, None], axis=1)[:, 0]
    hit = jnp.isfinite(t_best)
    return BruteResult(
        any_pass=jnp.any(passed, axis=1),
        t=t_best.astype(jnp.float32),
        tri_id=tri_id,
        hit=hit,
    )

