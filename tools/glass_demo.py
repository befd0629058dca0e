"""Render the dielectric feature image (docs/images/feature_glass_256.png).

A glass sphere (transmissive, ior 1.52) in front of a matte red sphere
on a blue floor under a vertical-gradient sky: the refracted (inverted)
image of the scene shows through the glass, with a Fresnel-bright rim
at grazing angles — the physics tests/test_dielectric.py pins, at
picture scale.  Runs on whatever backend jax picks (the GPU where
there is one, CPU elsewhere).

Usage: python tools/glass_demo.py [size] [spp]
"""
import dataclasses
import sys

sys.path.insert(0, ".")

import jax.numpy as jnp
import numpy as np

from ray_tracer_tpu.config import (
    CameraConfig,
    LightConfig,
    MaterialConfig,
    SceneConfig,
)
from ray_tracer_tpu.models import meshes as mesh_gen
from ray_tracer_tpu.models.scenes import scene_from_meshes
from ray_tracer_tpu.render.renderer import prepare, render


def main(size=256, spp=128):
    plane = mesh_gen.make_plane(extent=16.0, y=-1.0, density=2)
    glass = mesh_gen.make_uv_sphere(center=(0.0, 0.0, 0.0), radius=1.0,
                                    n_lat=48, n_lon=72)
    red = mesh_gen.make_uv_sphere(center=(-1.7, -0.3, -3.2), radius=0.7,
                                  n_lat=32, n_lon=48)
    green = mesh_gen.make_uv_sphere(center=(1.9, -0.45, -3.8), radius=0.55,
                                    n_lat=32, n_lon=48)
    mats = (
        MaterialConfig(base_color=(95.0, 105.0, 150.0)),         # floor
        MaterialConfig(transmissive=True, ior=1.52),             # glass
        MaterialConfig(base_color=(225.0, 60.0, 45.0)),          # red ball
        MaterialConfig(base_color=(60.0, 190.0, 80.0)),          # green
    )
    light = LightConfig(position=(4.0, 7.0, 5.0), intensity=60.0)
    scene = scene_from_meshes(
        [(plane, 0), (glass, 1), (red, 2), (green, 3)], mats, light
    )
    # vertical-gradient sky: bright zenith, dim horizon-down
    rows = np.linspace(1.1, 0.25, 8, dtype=np.float32)[:, None, None]
    sky = np.broadcast_to(
        rows * np.array([150.0, 170.0, 210.0], np.float32), (8, 8, 3)
    ).copy()
    scene = scene._replace(env_image=jnp.asarray(sky))
    cfg = SceneConfig(
        materials=mats, light=light,
        camera=CameraConfig(position=(0.6, 1.1, 5.2),
                            target=(0.0, -0.25, 0.0),
                            fov_degrees=33.0, width=size, height=size),
    )
    cfg = dataclasses.replace(
        cfg,
        render=dataclasses.replace(
            cfg.render, faithful=False, traversal="packed",
            scheduler="persistent", gi_samples=spp, gi_depth=8,
        ),
    )
    img = np.asarray(render(prepare(cfg, scene=scene)))

    from ray_tracer_tpu.io.png import write_png

    out = "docs/images/feature_glass_256.png"
    write_png(out, img)
    print(out, "min/max", float(img.min()), float(img.max()))


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
