"""Ray batches as SoA pytrees.

The reference's Ray is a scalar object {orig, dir, mint, maxt, depth}
(Serial/geometry.h:80-99).  Here a batch of R rays is one pytree of
dense arrays so every downstream stage is a fused vector program.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class RayBatch(NamedTuple):
    """A batch of rays: orig/dirn are (R,3); mint/maxt are (R,)."""

    orig: jnp.ndarray
    dirn: jnp.ndarray
    mint: jnp.ndarray
    maxt: jnp.ndarray

    @property
    def count(self) -> int:
        return self.orig.shape[0]

    def at(self, t: jnp.ndarray) -> jnp.ndarray:
        """Point along each ray: orig + t*dir (reference: geometry.h:91)."""
        return self.orig + self.dirn * t[..., None]

    @staticmethod
    def make(orig, dirn, mint=0.0, maxt=jnp.inf) -> "RayBatch":
        orig = jnp.asarray(orig)
        dirn = jnp.asarray(dirn)
        r = orig.shape[0]
        mint = jnp.broadcast_to(jnp.asarray(mint, orig.dtype), (r,))
        maxt = jnp.broadcast_to(jnp.asarray(maxt, orig.dtype), (r,))
        return RayBatch(orig, dirn, mint, maxt)


def concatenate(batches) -> RayBatch:
    return jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *batches)
