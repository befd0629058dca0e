"""ray_tracer_tpu — a differentiable ray-tracing framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference
CPU/CUDA ray tracer (kshanmol/ray-tracer): OBJ triangle meshes, a PBRT-style
uniform-grid acceleration structure with 3D-DDA traversal, Cramer's-rule
ray-triangle intersection, Blinn-Phong shading, shadow rays, and mirror
reflections — plus capabilities the reference lacks: differentiability
(pixel gradients w.r.t. vertices / materials / lights via custom VJPs),
multi-chip/multi-host sharding of ray batches over a `jax.sharding.Mesh`,
and a validation harness against a re-hosted serial C++ oracle.

Design stance (dense arrays, not a port):
  * No pointers, no queues, no recursion. Scenes are dense SoA arrays;
    rays are SoA pytrees; the wavefront "scheduler" of the reference
    (persistent CUDA kernels + atomic work queues,
    reference: Parallel/raytracer.cu:32-334) is replaced by fused dense
    tensor stages compiled by XLA.
  * Grid traversal is a masked, fixed-bound DDA march (`lax.while_loop`
    with per-ray live masks) instead of divergent per-thread loops
    (reference: Serial/grid.h:167-231).
  * Reflection recursion (reference: Parallel/raytracer.cu:508-520) is a
    statically unrolled, masked bounce loop.
  * Multi-device: `shard_map` over a device mesh shards pixel tiles;
    geometry + grid are replicated; gradients are `psum`-reduced.
"""

__version__ = "0.1.0"

from ray_tracer_tpu import config  # noqa: F401

__all__ = [
    "config",
    "__version__",
    "SceneConfig",
    "RenderConfig",
    "CameraConfig",
    "LightConfig",
    "MaterialConfig",
    "prepare",
    "render",
    "render_sharded",
    "render_aovs",
    "fit",
    "serial_scene_config",
    "parallel_scene_config",
    "gradcheck_scene",
    "write_ppm",
    "write_png",
]


def __getattr__(name):
    """Lazy top-level API (importing jax-heavy modules on demand):

        import ray_tracer_tpu as rt
        prep = rt.prepare(rt.serial_scene_config(256, 256))
        rt.write_ppm("out.ppm", rt.render(prep))
    """
    if name in ("SceneConfig", "RenderConfig", "CameraConfig",
                "LightConfig", "MaterialConfig"):
        from ray_tracer_tpu import config as _c

        return getattr(_c, name)
    if name in ("prepare", "render"):
        from ray_tracer_tpu.render import renderer

        return getattr(renderer, name)
    if name == "render_sharded":
        from ray_tracer_tpu.parallel.shard import render_sharded

        return render_sharded
    if name == "render_aovs":
        from ray_tracer_tpu.render.aov import render_aovs

        return render_aovs
    if name == "fit":
        from ray_tracer_tpu.opt.fit import fit

        return fit
    if name in ("serial_scene_config", "parallel_scene_config",
                "gradcheck_scene"):
        from ray_tracer_tpu.models import scenes

        return getattr(scenes, name)
    if name == "write_ppm":
        from ray_tracer_tpu.io.ppm import write_ppm

        return write_ppm
    if name == "write_png":
        from ray_tracer_tpu.io.png import write_png

        return write_png
    raise AttributeError(name)
