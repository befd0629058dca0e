"""Unit tests: ray-triangle intersection kernels.

Covers closed-form cases (Serial/geometry.h:131-177 semantics), the
strict acceptance predicate (geometry.h:162), negative-t acceptance in
the unrestricted regime (geometry.h:164-171), and the all-pairs sweep.
"""

import jax.numpy as jnp
import numpy as np

from ray_tracer_tpu.core.rays import RayBatch
from ray_tracer_tpu.ops.intersect import (
    barycentric_pass,
    cramer_tbg,
    intersect_brute,
)


def _unit_tri():
    v0 = jnp.array([[0.0, 0.0, 0.0]])
    v1 = jnp.array([[1.0, 0.0, 0.0]])
    v2 = jnp.array([[0.0, 1.0, 0.0]])
    return v0, v1, v2


def test_closed_form_hit():
    v0, v1, v2 = _unit_tri()
    orig = jnp.array([[0.25, 0.25, 1.0]])
    dirn = jnp.array([[0.0, 0.0, -1.0]])
    t, beta, gamma = cramer_tbg(orig, dirn, v0, v1, v2)
    assert np.isclose(float(t[0]), 1.0)
    assert np.isclose(float(beta[0]), 0.25)
    assert np.isclose(float(gamma[0]), 0.25)
    assert bool(barycentric_pass(beta, gamma)[0])


def test_strict_edge_rejection():
    """beta > 0 and gamma > 0 and beta+gamma < 1 — edges/vertices REJECT."""
    v0, v1, v2 = _unit_tri()
    dirn = jnp.array([[0.0, 0.0, -1.0]])
    for (x, y), expect in [
        ((0.0, 0.5), False),   # beta == 0 edge
        ((0.5, 0.0), False),   # gamma == 0 edge
        ((0.5, 0.5), False),   # beta + gamma == 1 hypotenuse
        ((0.3, 0.3), True),
    ]:
        orig = jnp.array([[x, y, 1.0]])
        _, b, g = cramer_tbg(orig, dirn, v0, v1, v2)
        assert bool(barycentric_pass(b, g)[0]) is expect, (x, y)


def test_negative_t_accepted_in_unrestricted_regime():
    """Serial primary rays accept hits BEHIND the origin (geometry.h:164-171)."""
    v0, v1, v2 = _unit_tri()
    rays = RayBatch.make(
        jnp.array([[0.25, 0.25, -1.0]]), jnp.array([[0.0, 0.0, -1.0]])
    )
    res_any = intersect_brute(rays, v0, v1, v2, t_lower=None)
    assert bool(res_any.hit[0]) and np.isclose(float(res_any.t[0]), -1.0)
    res_eps = intersect_brute(rays, v0, v1, v2, t_lower=1e-4)
    assert not bool(res_eps.hit[0])


def test_parallel_ray_misses():
    v0, v1, v2 = _unit_tri()
    rays = RayBatch.make(jnp.array([[0.3, 0.3, 1.0]]), jnp.array([[1.0, 0.0, 0.0]]))
    res = intersect_brute(rays, v0, v1, v2)
    assert not bool(res.hit[0]) and not bool(res.any_pass[0])


def _random_scene(seed, f=64, r=128):
    g = np.random.default_rng(seed)
    v0 = g.normal(size=(f, 3)).astype(np.float32)
    v1 = v0 + g.normal(scale=0.5, size=(f, 3)).astype(np.float32)
    v2 = v0 + g.normal(scale=0.5, size=(f, 3)).astype(np.float32)
    orig = g.normal(scale=3.0, size=(r, 3)).astype(np.float32)
    dirn = g.normal(size=(r, 3)).astype(np.float32)
    dirn /= np.linalg.norm(dirn, axis=1, keepdims=True)
    return (jnp.asarray(x) for x in (v0, v1, v2, orig, dirn))


def test_brute_sweep_matches_numpy_solve():
    """The all-pairs sweep against a plain float64 linear solve per
    (ray, triangle) pair: same hits, same nearest triangle, same t."""
    v0, v1, v2, orig, dirn = _random_scene(7)
    res = intersect_brute(RayBatch.make(orig, dirn), v0, v1, v2,
                          t_lower=1e-4, det_dtype=jnp.float64)
    a, b, c, o, d = (np.asarray(x, np.float64) for x in (v0, v1, v2, orig, dirn))
    # [-d | e1 | e2] [t, beta, gamma]^T = o - v0 for every pair
    m = np.stack([np.broadcast_to(-d[:, None, :], (len(o), len(a), 3)),
                  np.broadcast_to((b - a)[None], (len(o), len(a), 3)),
                  np.broadcast_to((c - a)[None], (len(o), len(a), 3))], axis=-1)
    t, beta, gamma = np.moveaxis(
        np.linalg.solve(m, (o[:, None, :] - a[None])[..., None])[..., 0], -1, 0)
    ok = (beta > 0) & (gamma > 0) & (beta + gamma < 1) & (t > 1e-4)
    tm = np.where(ok, t, np.inf)
    hit = np.isfinite(tm.min(axis=1))
    assert hit.any() and not hit.all()
    np.testing.assert_array_equal(np.asarray(res.hit), hit)
    np.testing.assert_array_equal(np.asarray(res.tri_id)[hit],
                                  tm.argmin(axis=1)[hit])
    np.testing.assert_allclose(np.asarray(res.t)[hit], tm.min(axis=1)[hit],
                               rtol=1e-6)


def test_nearest_hit_tie_break_is_lowest_index():
    """Two coincident triangles: strict < keeps the first (geometry.h:164)."""
    v0 = jnp.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    v1 = jnp.array([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    v2 = jnp.array([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0]])
    rays = RayBatch.make(jnp.array([[0.2, 0.2, 1.0]]), jnp.array([[0.0, 0.0, -1.0]]))
    res = intersect_brute(rays, v0, v1, v2)
    assert int(res.tri_id[0]) == 0
