"""Driver-level fault tolerance: banded rendering with per-band retry.

The reference is a single-shot binary with no failure handling
(SURVEY.md §5).  Because every stage here is a pure function, re-running
any slice of the image is always safe — so the resilience story is
simply: split the primary-ray batch into independent horizontal bands,
dispatch each separately, retry a band on transient device errors, and
reassemble.  One band's failure cannot corrupt another's
output; a retried band is deterministic.  Bands compile as their own
XLA programs, so band images match the single-shot render to float
tolerance (identical math, possibly different fusion), and re-running
the SAME band is bit-stable.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import jax
import numpy as np

from ray_tracer_tpu.utils.log import get_logger


def render_banded(
    prep,
    bands: int = 8,
    retries: int = 2,
    backoff_s: float = 1.0,
    band_fn: Optional[Callable] = None,
) -> np.ndarray:
    """Render `prep` in `bands` horizontal strips with per-band retry.

    Each band is a slice of the full primary-ray batch (exact same ray
    directions as the single-shot render by construction).  band_fn
    (band_rays) -> (rows*W, 3) defaults to the stock tiled renderer and
    is injectable for testing fault paths.  Returns (H, W, 3) float32.
    """
    from ray_tracer_tpu.ops.camera import camera_rays_subsample
    from ray_tracer_tpu.render.renderer import render_rays_tiled

    log = get_logger(__name__)
    cfg = prep.cfg
    rcfg = cfg.render
    h, w = cfg.camera.height, cfg.camera.width
    bands = max(1, min(bands, h))
    edges = np.linspace(0, h, bands + 1, dtype=int)

    import jax.numpy as jnp

    if rcfg.traversal == "packed":
        garr, meta = prep.packed.arrays, prep.packed.meta
    else:
        garr, meta = prep.grid.arrays, prep.grid.meta

    if band_fn is None:
        def band_fn(band_rays):
            colors = render_rays_tiled(band_rays, prep.scene, garr, meta, rcfg)
            return np.asarray(jax.device_get(colors))

    # Supersampling: each band of rows is rendered once per subsample
    # and averaged — each (subsample, band) slice stays an independently
    # retryable dispatch.  One subsample batch is generated at a time
    # (camera_rays_subsample is bitwise-equal to the corresponding
    # camera_rays slice) — O(H*W) ray memory instead of materializing
    # all spp^2 batches, same as renderer.accumulate_spp.
    n_sub = rcfg.spp * rcfg.spp
    out = np.zeros((h * w, 3), np.float32)
    for b in range(bands):
        lo, hi = int(edges[b]) * w, int(edges[b + 1]) * w
        if hi <= lo:
            continue
        acc = np.zeros((hi - lo, 3), np.float32)
        for s in range(n_sub):
            sub = camera_rays_subsample(
                cfg.camera, s, rcfg.spp, dtype=jnp.dtype(rcfg.dtype)
            )
            band = jax.tree.map(lambda x: x[lo:hi], sub)
            for attempt in range(retries + 1):
                try:
                    acc += band_fn(band)
                    break
                except Exception as e:  # noqa: BLE001 — retry any dispatch error
                    if attempt == retries:
                        raise
                    log.warning(
                        "band %d sub %d attempt %d failed (%s); retrying",
                        b, s, attempt, e,
                    )
                    time.sleep(backoff_s * (attempt + 1))
        out[lo:hi] = acc / n_sub
    return out.reshape(h, w, 3)
