"""Multi-host bring-up: process groups and cross-host data movement.

The reference has no distributed backend at all (SURVEY.md §2); this is
the framework's multi-host layer.  Every process runs the same
program: `initialize()` forms the process group, the global mesh spans
all devices of all processes, and `shard_map` programs
(parallel/shard.py) run unchanged — XLA routes the collectives between
devices and processes.

Single-process (1 host, N chips, or the CPU-simulated mesh used in
tests) is the degenerate case: every helper works without
jax.distributed being initialized.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

from ray_tracer_tpu.utils.log import get_logger


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Form the multi-host process group (idempotent).

    With no arguments, jax.distributed auto-detects only a cluster
    environment it knows (e.g. SLURM); a plain GPU host has none, so
    pass the coordinator address ("localhost:<port>" on one host), the
    process count and this process's id.  The same arguments run the
    CPU-cluster simulation: one python process per fake host with
    jax.distributed.initialize(addr, N, i).

    NOTE: must run before anything touches a backend (jax.devices(),
    jax.process_count(), any computation) — backend init pins the
    process group to single-process.
    """
    explicit = coordinator_address is not None or num_processes is not None
    try:
        if not explicit:
            jax.distributed.initialize()
        else:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
            )
    except RuntimeError as e:
        if "already initialized" in str(e).lower():
            return
        if explicit:
            # the caller ASKED for a process group; degrading to
            # single-process would have every process render the whole
            # frame and race on the host-0 output path
            raise
        get_logger(__name__).info("single-process mode (%s)", e)
    except Exception as e:
        if explicit:
            raise
        # auto-detect on a single host reaches here; that's fine
        get_logger(__name__).info("single-process mode (%s)", e)


def is_host0() -> bool:
    return jax.process_index() == 0


def global_mesh(axis_names: Tuple[str, ...] = ("rays",),
                shape: Optional[Sequence[int]] = None) -> Mesh:
    """Mesh over ALL devices of ALL hosts, host-major so the "rays"
    data-parallel axis crosses the network only at host boundaries."""
    devices = jax.devices()
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    return Mesh(np.asarray(devices).reshape(shape), axis_names)


def host_tile_bounds(total_rays: int) -> Tuple[int, int]:
    """This host's contiguous slice of the flat ray index space — for
    host-local framebuffer assembly / PPM writing on host 0.

    Mirrors the shard layer's actual layout: rays are padded to a
    multiple of the DEVICE count (renderer.pad_rays over the "rays"
    axis) and dealt in equal per-device chunks; a host owns its local
    devices' chunks.  A plain ceil-div over processes would misattribute
    rays whenever total_rays is not divisible.  Describes the
    balance=False (unpermuted) layout — render_sharded's round-robin
    balancing interleaves pixels across shards."""
    n_dev = jax.device_count()
    ld = jax.local_device_count()
    chunk = (-(-total_rays // n_dev))
    lo = min(jax.process_index() * ld * chunk, total_rays)
    hi = min(lo + ld * chunk, total_rays)
    return lo, hi


def broadcast_scene_host0(scene):
    """Replicate host-0's scene pytree to every host (geometry is
    replicated per host in the stock sharding; SURVEY.md §2 mapping).
    Uses multihost_utils; a no-op with one process."""
    if jax.process_count() == 1:
        return scene
    from jax.experimental import multihost_utils

    return multihost_utils.broadcast_one_to_all(scene)


def gather_image_host0(img) -> Optional[np.ndarray]:
    """Assemble the FULL image on host 0 from a (possibly multi-host)
    sharded render result -> host numpy (H, W, 3), or None on other
    hosts.  Single-process: a plain device pull."""
    if jax.process_count() == 1:
        return np.asarray(img) if is_host0() else None
    from jax.experimental import multihost_utils

    full = multihost_utils.process_allgather(img, tiled=True)
    return np.asarray(full) if is_host0() else None


def write_ppm_host0(path: str, img) -> bool:
    """Gather the sharded image and write the PPM artifact on host 0
    (the multi-host version of the reference's framebuffer write,
    Serial/raytracer.cpp:178-185).  Returns True on the writing host."""
    from ray_tracer_tpu.io.ppm import write_ppm

    full = gather_image_host0(img)
    if full is None:
        return False
    write_ppm(path, full)
    return True
