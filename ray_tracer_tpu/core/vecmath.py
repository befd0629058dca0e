"""Batched 3-vector math on arrays of shape (..., 3).

Dense counterpart of the reference's scalar Vec3<T> template
(Serial/geometry.h:13-78, Parallel/geometry.cuh:11-76): instead of one
object per vector, every op broadcasts over arbitrarily batched SoA
arrays so XLA vectorises them.
"""

from __future__ import annotations

import jax.numpy as jnp


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the trailing axis: (...,3),(...,3)->(...)."""
    return jnp.sum(a * b, axis=-1)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched cross product (reference: Serial/geometry.h:36-42)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def length2(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(a * a, axis=-1)


def length(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(length2(a))


def normalize(a: jnp.ndarray) -> jnp.ndarray:
    """Safe normalize: zero vectors stay zero.

    Matches Vec3::normalize's `if (nor2 > 0)` guard
    (reference: Serial/geometry.h:23-30).
    """
    n2 = length2(a)
    inv = jnp.where(n2 > 0, 1.0 / jnp.sqrt(jnp.where(n2 > 0, n2, 1.0)), 0.0)
    return a * inv[..., None]


def reflect(incident: jnp.ndarray, normal: jnp.ndarray) -> jnp.ndarray:
    """Mirror reflection I - 2(I.N)N (reference: Parallel/raytracer.cu:875-878)."""
    return incident - normal * (2.0 * dot(incident, normal))[..., None]


def det3(
    a1, a2, a3,
    b1, b2, b3,
    c1, c2, c3,
):
    """3x3 determinant with the reference's exact expansion order
    t1 - t2 + t3 (Serial/raytracer.cpp:203-211) so float rounding matches
    the oracle when run at the same precision."""
    t1 = a1 * (b2 * c3 - b3 * c2)
    t2 = a2 * (b1 * c3 - b3 * c1)
    t3 = a3 * (b1 * c2 - b2 * c1)
    return t1 - t2 + t3
