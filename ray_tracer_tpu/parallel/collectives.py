"""Explicit collectives API (inside shard_map bodies).

The reference has no distributed transport at all (SURVEY.md §2); this is
the framework's first-class equivalent: named-axis wrappers over XLA
collectives (NCCL over NVLink between the cards of a host).  These
are building blocks for custom shard_map programs; the stock renderers
in parallel/shard.py use them implicitly via in/out specs and grad
transposition.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp


def vma_union(*trees: Any, extra=()) -> frozenset:
    """Union of the varying-axes (vma) types over all leaves of the
    given pytrees, plus `extra` axis names — the target type for
    while_loop/scan carry leaves under shard_map (every carry leaf must
    enter with one uniform vma; fresh constants enter unvarying)."""
    ax = frozenset(extra)
    for t in trees:
        for x in jax.tree.leaves(t):
            ax |= jax.typeof(x).vma
    return ax


def pcast_varying(tree: Any, want: frozenset) -> Any:
    """pcast every leaf of `tree` up to the `want` varying-axes set.
    Identity outside shard_map, where vma is empty.  The ONE
    shard_map-compat helper shared by the persistent wave and the ring
    orbit, so a vma/pcast API change cannot leave one stale."""
    def one(x):
        missing = tuple(want - jax.typeof(x).vma)
        return jax.lax.pcast(x, missing, to="varying") if missing else x

    return jax.tree.map(one, tree)


def allreduce_gradients(grads: Any, axis: str = "rays") -> Any:
    """Sum parameter gradients over the mesh axis (psum across the axis).
    Call inside a shard_map body after a local backward pass; XLA's
    latency-hiding scheduler overlaps it with remaining backward work."""
    return jax.tree.map(lambda g: jax.lax.psum(g, axis) if g is not None else None, grads)


def gather_image(tile_colors: jnp.ndarray, axis: str = "rays") -> jnp.ndarray:
    """All-gather per-shard pixel colors into the full flat image:
    (R/D, 3) per shard -> (R, 3) everywhere."""
    g = jax.lax.all_gather(tile_colors, axis)  # (D, R/D, 3)
    return g.reshape(-1, tile_colors.shape[-1])


def scatter_rays(rays_flat: jnp.ndarray, axis: str = "rays") -> jnp.ndarray:
    """Take this shard's slice of a replicated flat ray array:
    (R, ...) -> (R/D, ...) using the shard's axis index."""
    d = jax.lax.axis_size(axis)
    i = jax.lax.axis_index(axis)
    per = rays_flat.shape[0] // d
    return jax.lax.dynamic_slice_in_dim(rays_flat, i * per, per, axis=0)


def min_reduce_hits(t: jnp.ndarray, payload: jnp.ndarray, axis: str = "tris"):
    """Nearest-hit combine across a sharded-geometry axis: returns
    (t_min, payload_of_winner).  First minimum wins, matching the
    reference's strict-< update (Serial/geometry.h:164-171) when shards
    are ordered by triangle-id range."""
    ts = jax.lax.all_gather(t, axis)
    ps = jax.lax.all_gather(payload, axis)
    s = jnp.argmin(ts, axis=0)
    take = lambda arr: jnp.take_along_axis(arr, s[None], axis=0)[0]
    return take(ts), take(ps)


def ring_shift(x: jnp.ndarray, axis: str, shift: int = 1) -> jnp.ndarray:
    """ppermute neighbor exchange — the building block for ring-passing
    ray batches through sharded geometry (the ray-tracing analog of ring
    attention; SURVEY.md §5 'long-context')."""
    n = jax.lax.axis_size(axis)
    perm = [(i, (i + shift) % n) for i in range(n)]
    return jax.lax.ppermute(x, axis, perm)
