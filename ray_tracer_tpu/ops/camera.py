"""Pinhole look-at camera: the whole image's primary rays as one batch.

Reproduces the reference's camera model exactly
(Serial/raytracer.cpp:124-138, 150-161; duplicated per-thread at
Parallel/raytracer.cu:154-162):

    w  = -normalize(target - pos)
    u  = normalize(up x w)
    v  = normalize(w x u)
    fd = focal_height / (2 tan(fov/2))
    dir(x, y) = normalize(-w*fd + u * ar*(x - W/2 + 0.5)/W
                                + v *    (y - H/2 + 0.5)/H)

but emits the full (H*W, 3) direction array in one broadcasted expression
instead of a per-pixel loop.  Pixel (x, y) maps to flat index y*W + x,
matching the reference's framebuffer layout.
"""

from __future__ import annotations

import math
import jax.numpy as jnp

from ray_tracer_tpu.config import CameraConfig
from ray_tracer_tpu.core import vecmath as vm
from ray_tracer_tpu.core.rays import RayBatch


def camera_basis(cfg: CameraConfig, dtype=jnp.float32):
    pos = jnp.asarray(cfg.position, dtype=dtype)
    target = jnp.asarray(cfg.target, dtype=dtype)
    up = vm.normalize(jnp.asarray(cfg.up, dtype=dtype))
    w = vm.normalize(-(target - pos))
    u = vm.normalize(vm.cross(up, w))
    v = vm.normalize(vm.cross(w, u))
    focal_distance = 1.0 / (2.0 * math.tan(cfg.fov_degrees * math.pi / 360.0))
    return pos, u, v, w, focal_distance


def _subpixel_offset(s: int, spp: int) -> "tuple[float, float]":
    """(ox, oy) of subsample s as PYTHON floats — the one offset
    computation every ray source shares.  Offsets must be host-side
    float64 constants narrowed at use: an on-device f32 divide is not
    correctly rounded on all backends ((s+0.5)/spp drifts by 1 ulp for
    non-power-of-two spp), which would break the bitwise equality
    between the three ray sources below.  (spp == 1 falls out of the
    general formula: (0 + 0.5) / 1 == 0.5 exactly.)"""
    sx, sy = s % spp, s // spp
    return (sx + 0.5) / spp, (sy + 0.5) / spp


def _lens_offset(cfg: CameraConfig, s: int, spp: int):
    """(lx, ly) aperture-disk coordinates of subsample s as PYTHON
    floats (like _subpixel_offset, so every ray source bakes in the
    same constants), or None for the pinhole path.  Deterministic
    golden-spiral disk: radius grows with sqrt so samples are
    area-uniform."""
    n = spp * spp
    if cfg.aperture <= 0.0 or n == 1:
        return None
    r = cfg.aperture * math.sqrt((s + 0.5) / n)
    th = s * math.pi * (3.0 - math.sqrt(5.0))
    return r * math.cos(th), r * math.sin(th)


def _focus_distance(cfg: CameraConfig) -> float:
    if cfg.focus_distance > 0.0:
        return float(cfg.focus_distance)
    return math.dist(cfg.position, cfg.target)


def _lens_rays(pos, u, v, w, dirs, lx, ly, focus: float):
    """Thin-lens transform of normalized pinhole dirs: origin moves to
    the lens point pos + u*lx + v*ly, direction re-aims at the pixel's
    point on the focal plane (focus along the view axis -w).  lx/ly
    broadcast against dirs[..., 0] (python scalars or (R,) arrays) —
    the ONE expression all three ray sources share, so they stay
    bitwise-consistent."""
    cosw = -vm.dot(dirs, w)  # > 0 for any fov < 180
    focal = pos + dirs * (focus / cosw)[..., None]
    orig = pos + u * lx + v * ly
    ndir = vm.normalize(focal - orig)
    return jnp.broadcast_to(orig, ndir.shape), ndir


def _rays_from_grid(cfg: CameraConfig, ox: float, oy: float, dtype,
                    lens=None):
    """(orig, dirs) of shape (H*W, 3) for one subsample offset — the
    shared direction expression (camera_rays == concat of these per
    its docstring; camera_rays_subsample is exactly one).  `lens` is a
    (lx, ly) aperture point or None for the pinhole."""
    pos, u, v, w, fd = camera_basis(cfg, dtype=dtype)
    width, height = cfg.width, cfg.height
    aspect = float(width) / float(height)
    x = jnp.arange(width, dtype=dtype)
    y = jnp.arange(height, dtype=dtype)
    xw = aspect * (x - width / 2.0 + ox) / width  # (W,)
    yw = (y - height / 2.0 + oy) / height  # (H,)
    dirs = (
        -w * fd
        + u * xw[None, :, None]  # broadcast over (H, W, 3)
        + v * yw[:, None, None]
    )
    dirs = vm.normalize(dirs).reshape(-1, 3)
    if lens is None:
        return jnp.broadcast_to(pos, dirs.shape), dirs
    return _lens_rays(pos, u, v, w, dirs,
                      jnp.asarray(lens[0], dtype), jnp.asarray(lens[1], dtype),
                      _focus_distance(cfg))


def camera_rays(cfg: CameraConfig, dtype=jnp.float32, spp: int = 1) -> RayBatch:
    """Primary rays for every pixel, flat index = y*W + x.

    spp > 1 (anti-aliasing, no reference counterpart) emits spp x spp
    regular subpixel samples per pixel, subsample-major:
    ray[s*H*W + y*W + x]; callers average blocks of H*W.  spp == 1 keeps
    the reference's exact pixel-center expression (bitwise goldens).
    """
    origs, dirss = [], []
    for s in range(spp * spp):
        o, d = _rays_from_grid(cfg, *_subpixel_offset(s, spp), dtype,
                               lens=_lens_offset(cfg, s, spp))
        origs.append(o)
        dirss.append(d)
    if len(dirss) == 1:
        orig, dirs = origs[0], dirss[0]
    else:
        orig = jnp.concatenate(origs, axis=0)
        dirs = jnp.concatenate(dirss, axis=0)
    return RayBatch.make(orig, dirs, mint=0.0, maxt=jnp.inf)


def camera_rays_subsample(cfg: CameraConfig, s: int, spp: int,
                          dtype=jnp.float32) -> RayBatch:
    """The (H*W,) ray batch of ONE spp-subsample s (0 <= s < spp*spp),
    bitwise equal to rays [s*H*W:(s+1)*H*W] of camera_rays(cfg, spp=spp).
    Lets the renderer accumulate subsamples with O(H*W) memory instead
    of materializing all spp^2 batches at once."""
    orig, dirs = _rays_from_grid(cfg, *_subpixel_offset(s, spp), dtype,
                                 lens=_lens_offset(cfg, s, spp))
    return RayBatch.make(orig, dirs, mint=0.0, maxt=jnp.inf)


def camera_ray_at(cfg: CameraConfig, idx: jnp.ndarray, dtype=jnp.float32,
                  spp: int = 1) -> RayBatch:
    """Rays for ARBITRARY flat indices (same arithmetic as camera_rays,
    bitwise): idx = s*H*W + y*W + x with subsample s < spp*spp.

    This is the zero-gather ray source for the persistent wave's refill
    — regenerating a popped camera ray from its index is pure
    arithmetic, with no fetch from an (R, 8) device table."""
    pos, u, v, w, fd = camera_basis(cfg, dtype=dtype)
    width, height = cfg.width, cfg.height
    aspect = float(width) / float(height)
    hw = width * height
    idx = idx.astype(jnp.int32)
    p = idx % hw
    yi = (p // width).astype(dtype)
    xi = (p % width).astype(dtype)
    s = jnp.clip(idx // hw, 0, spp * spp - 1)  # per-lane subsample index
    if spp == 1:
        ox = oy = jnp.asarray(0.5, dtype)
    else:
        # gather the subsample offsets from a table of the SAME
        # Python-float constants camera_rays bakes in — computing
        # (s+0.5)/spp on device drifts by 1 ulp for non-power-of-two
        # spp (the f32 divide is not correctly rounded on this backend)
        offs = [_subpixel_offset(si, spp) for si in range(spp * spp)]
        ox_tab = jnp.asarray([o for o, _ in offs], dtype)
        oy_tab = jnp.asarray([o for _, o in offs], dtype)
        ox = ox_tab[s]
        oy = oy_tab[s]
    xw = aspect * (xi - width / 2.0 + ox) / width
    yw = (yi - height / 2.0 + oy) / height
    dirs = -w * fd + u * xw[:, None] + v * yw[:, None]
    dirs = vm.normalize(dirs)
    lens = [_lens_offset(cfg, si, spp) for si in range(spp * spp)]
    if lens[0] is None:
        orig = jnp.broadcast_to(pos, dirs.shape)
        return RayBatch.make(orig, dirs, mint=0.0, maxt=jnp.inf)
    # thin lens: per-lane aperture point from the same Python-float
    # table the batch generators bake in (see ox_tab above for why)
    lx_tab = jnp.asarray([l[0] for l in lens], dtype)
    ly_tab = jnp.asarray([l[1] for l in lens], dtype)
    orig, dirs = _lens_rays(pos, u, v, w, dirs,
                            lx_tab[s][:, None], ly_tab[s][:, None],
                            _focus_distance(cfg))
    return RayBatch.make(orig, dirs, mint=0.0, maxt=jnp.inf)
