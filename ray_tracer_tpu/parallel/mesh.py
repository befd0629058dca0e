"""Device-mesh construction.

Axes:
  * "rays" — data parallelism over pixels/rays (the scaling axis the
    reference lacked entirely; its one GPU capped at 64x64 pixels,
    Parallel/raytracer.cu:16).  `make_mesh` lays devices out in
    jax.devices() order, with no torus shape: the cards of one host are
    joined all to all by NVLink, so every neighbour is as near as any
    other and the mesh follows the algorithm alone.  Across processes
    that order is host-major, so an axis crosses the network only at
    host boundaries.
  * "tris" — model parallelism over triangles for scenes too large to
    replicate: each shard intersects its triangle slice, nearest hits
    are min-reduced across the axis (parallel/shard.py).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Tuple[str, ...] = ("rays",),
    shape: Optional[Sequence[int]] = None,
    devices=None,
) -> Mesh:
    """Build a Mesh over the first `n_devices` devices.

    With one axis, all devices go to it.  With two axes and no explicit
    shape, "tris" gets 1 (replicated geometry) and "rays" everything —
    the default layout for scenes that fit per-chip HBM.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, axis_names)


def factor_mesh(n: int) -> Tuple[int, int]:
    """Split n devices into (rays, tris) axes: largest tris factor <= sqrt(n)."""
    best = 1
    for t in range(1, int(np.sqrt(n)) + 1):
        if n % t == 0:
            best = t
    return n // best, best
