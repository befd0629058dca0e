"""Command-line interface.

The reference binaries take no arguments at all (Serial/raytracer.cpp:191,
Parallel/raytracer.cu:769 — scene, size and output are compile-time
constants).  This CLI exposes the same capabilities as composable
commands:

  python -m ray_tracer_tpu.cli render --scene serial --width 256 --out x.ppm
  python -m ray_tracer_tpu.cli render --config scene.json --out x.ppm
  python -m ray_tracer_tpu.cli fit --scene gradcheck --steps 100 --out-dir ckpt/
  python -m ray_tracer_tpu.cli info
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def _build_cfg(args):
    from ray_tracer_tpu.config import load_scene_config
    from ray_tracer_tpu.models import scenes

    if args.config:
        cfg = load_scene_config(args.config)
        scene = None
    elif args.scene == "serial":
        cfg = scenes.serial_scene_config(args.width, args.height)
        scene = None
    elif args.scene == "parallel":
        cfg = scenes.parallel_scene_config(args.width, args.height)
        scene = None
    elif args.scene == "gradcheck":
        scene, cfg = scenes.gradcheck_scene(args.width, args.height)
    elif args.scene == "nefertiti":
        scene, cfg = scenes.nefertiti_scene(args.width, args.height)
    elif args.scene == "nefertiti_spot":
        scene, cfg = scenes.nefertiti_scene(args.width, args.height, with_spot=True)
    else:
        raise SystemExit(f"unknown scene {args.scene!r}")
    if args.width and not args.config:
        cfg = dataclasses.replace(
            cfg,
            camera=dataclasses.replace(cfg.camera, width=args.width, height=args.height),
        )
    if args.fast:
        cfg = dataclasses.replace(
            cfg, render=dataclasses.replace(cfg.render, faithful=False)
        )
    if getattr(args, "turbo", False):
        # the tuned production pipeline (what bench.py runs), from the
        # ONE shared per-scene knob table (config.TUNED_KNOBS): packed
        # block rows + the persistent wavefront + auto grid layout +
        # SAT-exact grid insertion, with the tuned wave/pump/
        # row-width/grid knobs per scene family.
        # gi_samples must be on cfg BEFORE apply_turbo so the knob
        # selection sees a GI run (GI has its own gi_pump knee; the
        # Whitted-wave wave/pump knobs would mistune it).
        from ray_tracer_tpu.config import apply_turbo

        if getattr(args, "gi_samples", 0) > 0:
            cfg = dataclasses.replace(
                cfg,
                render=dataclasses.replace(
                    cfg.render, gi_samples=args.gi_samples
                ),
            )
        family = {
            "serial": "serial", "parallel": "parallel",
            "nefertiti": "nefertiti", "nefertiti_spot": "nefertiti",
        }.get(getattr(args, "scene", None))
        cfg = apply_turbo(cfg, family)
    if getattr(args, "spp", 1) > 1:
        cfg = dataclasses.replace(
            cfg, render=dataclasses.replace(cfg.render, spp=args.spp)
        )
    if getattr(args, "gi_samples", 0) > 0:
        cfg = dataclasses.replace(
            cfg,
            render=dataclasses.replace(
                cfg.render, faithful=False,
                gi_samples=args.gi_samples,
                gi_depth=getattr(args, "gi_depth", 2),
                gi_specular=not getattr(args, "gi_no_specular", False),
            ),
        )
    if getattr(args, "smooth_normals", False):
        cfg = dataclasses.replace(
            cfg,
            render=dataclasses.replace(
                cfg.render, normal_mode="smooth", faithful=False
            ),
        )
    li = getattr(args, "light_intensity", None)
    if li is not None:
        if cfg.render.faithful:
            print("warning: --light-intensity overrides a faithful render's "
                  "reference light — output will not be oracle bit-exact",
                  file=sys.stderr)
        # override the primary light's intensity (the faithful parallel
        # and gradcheck configs use 1.0 — too dim for the path tracer's
        # radiometric 0-255 units, so GI wants an explicit boost here)
        cfg = dataclasses.replace(
            cfg, light=dataclasses.replace(cfg.light, intensity=li)
        )
    for spec in getattr(args, "extra_light", None) or ():
        from ray_tracer_tpu.config import LightConfig

        try:
            parts = [float(x) for x in spec.split(",")]
        except ValueError:
            parts = []
        if len(parts) not in (3, 4):
            raise SystemExit(
                f"--extra-light wants x,y,z[,intensity], got {spec!r}"
            )
        lc = LightConfig(position=tuple(parts[:3]),
                         intensity=parts[3] if len(parts) == 4 else 1.0)
        cfg = dataclasses.replace(cfg, extra_lights=cfg.extra_lights + (lc,))
    ap = getattr(args, "aperture", 0.0)
    if ap:
        cfg = dataclasses.replace(
            cfg,
            camera=dataclasses.replace(
                cfg.camera, aperture=ap,
                focus_distance=getattr(args, "focus_distance", 0.0) or 0.0,
            ),
        )
    if (cfg.camera.aperture > 0 and cfg.render.spp <= 1
            and getattr(args, "renders_color", False)):
        # checks the EFFECTIVE spp (a config file may set either side);
        # guards the color-rendering subcommands (render AND fit, which
        # honors cfg.render.spp in image_loss) — aov/stats/debug
        # intentionally trace pinhole pixel centers
        raise SystemExit("depth of field needs render.spp > 1 "
                         "(one lens point per subsample)")
    ss = getattr(args, "shadow_samples", 0)
    lr = getattr(args, "light_radius", 0.0)
    if ss or lr:
        # the EFFECTIVE radius: a config file may supply it while the
        # CLI only bumps the sample count (same rule as the DoF check)
        eff_lr = lr or cfg.render.light_radius
        if ss and not eff_lr:
            raise SystemExit("--shadow-samples requires --light-radius "
                             "(or render.light_radius in the config)")
        if ss == 1:
            raise SystemExit("--shadow-samples must be > 1 for a penumbra")
        eff_ss = ss or (cfg.render.shadow_samples
                        if cfg.render.shadow_samples > 1 else 16)
        cfg = dataclasses.replace(
            cfg,
            render=dataclasses.replace(
                cfg.render, faithful=False,
                light_radius=eff_lr, shadow_samples=eff_ss,
            ),
        )
    if getattr(args, "texture", None):
        cfg = dataclasses.replace(
            cfg,
            render=dataclasses.replace(
                cfg.render,
                texture=args.texture,
                texture_scale=getattr(args, "texture_scale", None)
                or cfg.render.texture_scale,
            ),
        )
    if getattr(args, "texture_file", None):
        # Attach a PPM as the scene's bilinear texture (requires a scene
        # object; config-only scenes get it after prepare via _replace).
        import jax.numpy as jnp

        from ray_tracer_tpu.io.ppm import read_ppm

        tex = jnp.asarray(read_ppm(args.texture_file), jnp.float32) / 255.0
        if scene is None:
            from ray_tracer_tpu.models.scenes import (
                scene_from_numpy, scene_numpy_arrays,
            )

            v, f, fm, uv, uvf = scene_numpy_arrays(cfg)
            scene = scene_from_numpy(v, f, fm, cfg.materials, cfg.light, uv,
                                     uvf, extra_lights=cfg.extra_lights)
        scene = scene._replace(texture_image=tex)
    if getattr(args, "env_file", None):
        # Lat-long environment map for miss lanes, in color units
        # (u8 values pass through: 255 tonemaps to full white).
        import jax.numpy as jnp

        from ray_tracer_tpu.io.png import read_png
        from ray_tracer_tpu.io.ppm import read_ppm

        rd = read_png if args.env_file.lower().endswith(".png") else read_ppm
        env = jnp.asarray(rd(args.env_file), jnp.float32)
        if scene is None:
            from ray_tracer_tpu.models.scenes import build_scene

            scene = build_scene(cfg)
        scene = scene._replace(env_image=env)
        cfg = dataclasses.replace(
            cfg, render=dataclasses.replace(cfg.render, faithful=False)
        )
    return cfg, scene


def cmd_render(args) -> None:
    import jax
    import numpy as np

    from ray_tracer_tpu.io.ppm import write_ppm
    from ray_tracer_tpu.render.renderer import prepare, render

    from ray_tracer_tpu.utils.timing import profile_trace

    cfg, scene = _build_cfg(args)
    prep = prepare(cfg, scene=scene)
    logdir = getattr(args, "profile", None)
    t0 = time.perf_counter()
    with profile_trace(logdir):  # None-safe; flushes even when we raise
        if args.devices and args.devices > 1:
            from ray_tracer_tpu.parallel.mesh import make_mesh

            if getattr(args, "ring", False):
                from ray_tracer_tpu.parallel.shard import (
                    render_sharded_geometry,
                )

                # ALL devices on the triangle axis — the memory-bound
                # path exists to hold 1/N of the soup per device (the
                # default two-axis factoring would put size 1 on tris
                # and silently replicate the geometry)
                img = render_sharded_geometry(
                    prep,
                    mesh=make_mesh(args.devices, ("tris",),
                                   shape=(args.devices,)),
                    rays_axis=None,
                )
            else:
                from ray_tracer_tpu.parallel.shard import render_sharded

                img = render_sharded(prep, mesh=make_mesh(args.devices))
        else:
            img = render(prep)
        jax.block_until_ready(img)
    dt = time.perf_counter() - t0
    if logdir:
        print(f"profiler trace written to {logdir}", file=sys.stderr)
    if args.out.lower().endswith(".png"):
        from ray_tracer_tpu.io.png import write_png

        write_png(args.out, np.asarray(img))
    else:
        write_ppm(args.out, np.asarray(img))
    spp2 = cfg.render.spp * cfg.render.spp
    # shadow fan per light: 1 point-light ray, or shadow_samples
    # area-light rays; every extra light traces the same fan
    sfan = (cfg.render.shadow_samples
            if cfg.render.shadow_samples > 1 and cfg.render.light_radius > 0
            else 1)
    n_lights = 1 + len(cfg.extra_lights)
    rays = cfg.camera.width * cfg.camera.height * spp2 * (1 + sfan * n_lights)
    print(f"wrote {args.out} ({cfg.camera.width}x{cfg.camera.height}"
          f"{f', spp={cfg.render.spp}' if spp2 > 1 else ''}) "
          f"in {dt:.2f}s = {rays / dt / 1e6:.2f} Mrays/s "
          f"(primary+shadow, excl. reflection bounces, incl compile)",
          file=sys.stderr)


def cmd_fit(args) -> None:
    import jax
    import numpy as np

    from ray_tracer_tpu.opt.fit import fit, merge_scene, split_scene
    from ray_tracer_tpu.render.renderer import prepare, render

    cfg, scene = _build_cfg(args)
    prep = prepare(cfg, scene=scene)
    if args.target:
        from ray_tracer_tpu.io.ppm import read_ppm

        target = jax.numpy.asarray(read_ppm(args.target).astype(np.float32))
    else:
        # self-supervised demo: perturb materials, recover the render
        target = render(prep)
        params = split_scene(prep.scene)
        prep = prep._replace(scene=merge_scene(
            params._replace(kd=params.kd * 1.5, base_color=params.base_color * 0.6),
            prep.scene,
        ))
    trainable = (tuple(f.strip() for f in args.trainable.split(",") if f.strip())
                 if args.trainable else None)
    _, losses = fit(
        prep, target, steps=args.steps, lr=args.lr, trainable=trainable,
        checkpoint_dir=args.out_dir, log_every=max(1, args.steps // 10),
    )
    print(json.dumps({"first_loss": losses[0], "last_loss": losses[-1]}))


def cmd_bench(args) -> None:
    os.execv(sys.executable, [sys.executable, os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "bench.py"
    )] + (["--size", str(args.width)] if args.width else []))


def cmd_stats(args) -> None:
    from ray_tracer_tpu.render.metrics import collect_render_metrics
    from ray_tracer_tpu.render.renderer import prepare

    cfg, scene = _build_cfg(args)
    prep = prepare(cfg, scene=scene)
    print(json.dumps(collect_render_metrics(prep), indent=2))


def _inspect_mesh(args):
    """--devices/--ring mesh for the aov/debug inspection commands:
    None = single-device; otherwise a ("rays","tris") mesh whose tris
    axis carries the geometry shards when --ring is set."""
    n = getattr(args, "devices", 0)
    if not n:
        return None, False
    from ray_tracer_tpu.parallel.mesh import make_mesh

    if getattr(args, "ring", False):
        return make_mesh(n, ("rays", "tris"), shape=(1, n)), True
    return make_mesh(n, ("rays", "tris"), shape=(n, 1)), False


def cmd_debug(args) -> None:
    from ray_tracer_tpu.render.debug import trace_pixel
    from ray_tracer_tpu.render.renderer import prepare

    cfg, scene = _build_cfg(args)
    prep = prepare(cfg, scene=scene)
    mesh, ring = _inspect_mesh(args)
    print(json.dumps(trace_pixel(
        prep, args.x, args.y, mesh=mesh if ring else None
    ), indent=2))


def cmd_aov(args) -> None:
    import numpy as np

    from ray_tracer_tpu.render.aov import render_aovs
    from ray_tracer_tpu.render.renderer import prepare

    cfg, scene = _build_cfg(args)
    prep = prepare(cfg, scene=scene)
    mesh, ring = _inspect_mesh(args)
    aovs = {k: np.asarray(v)
            for k, v in render_aovs(prep, mesh=mesh, ring=ring).items()}
    if getattr(args, "ao_samples", 0):
        from ray_tracer_tpu.render.aov import render_ao

        aovs["ao"] = np.asarray(render_ao(
            prep, samples=args.ao_samples, radius=args.ao_radius,
            mesh=mesh, ring=ring,
        ))
    np.savez(args.out, **aovs)
    print(f"wrote {args.out}: " + ", ".join(
        f"{k}{list(v.shape)}" for k, v in aovs.items()), file=sys.stderr)


def cmd_info(_args) -> None:
    import jax

    from ray_tracer_tpu.accel import native

    print(json.dumps({
        "devices": [str(d) for d in jax.devices()],
        "process_count": jax.process_count(),
        "native_library": native.available(),
        "default_backend": jax.default_backend(),
    }, indent=2))


def parse_args(argv=None) -> argparse.Namespace:
    """The CLI's arguments, with every subcommand's defaults filled in
    (what main() acts on; chip_smoke.py builds its configs from it)."""
    ap = argparse.ArgumentParser(prog="ray_tracer_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    scene_choices = ["serial", "parallel", "gradcheck", "nefertiti", "nefertiti_spot"]
    r = sub.add_parser("render", help="render a scene to PPM")
    r.add_argument("--scene", default="serial", choices=scene_choices)
    r.add_argument("--config", help="scene config JSON (overrides --scene)")
    r.add_argument("--width", type=int, default=256)
    r.add_argument("--height", type=int, default=0)
    r.add_argument("--out", default="out.ppm")
    r.add_argument("--fast", action="store_true",
                   help="production semantics (early-exit DDA, f32 dets)")
    r.add_argument("--turbo", action="store_true",
                   help="tuned production pipeline: packed grid + "
                        "persistent wavefront (the bench.py path)")
    r.add_argument("--devices", type=int, default=0,
                   help="shard rays over this many devices")
    r.add_argument("--ring", action="store_true",
                   help="with --devices: shard the GEOMETRY over the "
                        "device mesh and ring-pass ray bundles between "
                        "neighbors (the memory-bound-scene path, "
                        "parallel/shard.render_sharded_geometry) "
                        "instead of sharding rays")
    r.add_argument("--profile", default=None,
                   help="write a jax.profiler trace to this directory")
    r.add_argument("--texture", default=None,
                   choices=["none", "checker", "image"],
                   help="modulate base_color from the carried uvs")
    r.add_argument("--texture-file", default=None,
                   help="PPM image sampled bilinearly when --texture image")
    r.add_argument("--texture-scale", type=float, default=None,
                   help="checker cells / image repeats per uv unit")
    r.add_argument("--spp", type=int, default=1,
                   help="anti-aliasing: spp x spp subpixel samples per pixel")
    r.add_argument("--env-file", default=None,
                   help="lat-long environment map (PPM/PNG) for miss rays")
    r.add_argument("--extra-light", action="append", default=None,
                   metavar="X,Y,Z[,I]",
                   help="additional point light (repeatable)")
    r.add_argument("--aperture", type=float, default=0.0,
                   help="thin-lens radius for depth of field (needs --spp>1)")
    r.add_argument("--focus-distance", type=float, default=0.0,
                   help="focal-plane distance (default: distance to target)")
    r.add_argument("--smooth-normals", action="store_true",
                   help="Phong-interpolated vertex normals (production mode)")
    r.add_argument("--gi-samples", type=int, default=0,
                    help="path-traced GI: paths per pixel (0 = off; "
                         "deterministic hash sampling, render/pathtrace.py)")
    r.add_argument("--gi-depth", type=int, default=2,
                    help="path-traced GI: max indirect bounces")
    r.add_argument("--gi-no-specular", action="store_true",
                    help="path-traced GI: disable the mirror branch on "
                         "reflective materials (treat everything as "
                         "Lambertian)")
    r.add_argument("--light-intensity", type=float, default=None,
                   help="override the primary light's intensity (the "
                        "faithful parallel/gradcheck configs use 1.0, "
                        "too dim for GI's 0-255 radiometric units); "
                        "applies in EVERY render mode — combined with a "
                        "faithful render it breaks oracle bit-exactness")
    r.add_argument("--light-radius", type=float, default=0.0,
                   help="spherical area light radius -> soft shadows")
    r.add_argument("--shadow-samples", type=int, default=0,
                   help="shadow rays per pixel for --light-radius "
                        "(default 16)")
    r.set_defaults(fn=cmd_render, renders_color=True)

    f = sub.add_parser("fit", help="inverse-rendering optimization demo")
    f.add_argument("--scene", default="gradcheck",
                   choices=["serial", "parallel", "gradcheck"])
    f.add_argument("--config")
    f.add_argument("--width", type=int, default=64)
    f.add_argument("--height", type=int, default=0)
    f.add_argument("--steps", type=int, default=100)
    f.add_argument("--lr", type=float, default=2e-2)
    f.add_argument("--target", help="target PPM image (default: self-demo)")
    f.add_argument("--texture", default=None,
                   choices=["none", "checker", "image"])
    f.add_argument("--texture-file", default=None,
                   help="PPM sampled bilinearly when --texture image "
                        "(also the init for --trainable texture_image)")
    f.add_argument("--texture-scale", type=float, default=None)
    f.add_argument("--smooth-normals", action="store_true",
                   help="Phong-interpolated vertex normals")
    f.add_argument("--env-file", default=None,
                   help="lat-long environment map (PPM/PNG; also the "
                        "init for --trainable env_image)")
    f.add_argument("--extra-light", action="append", default=None,
                   metavar="X,Y,Z[,I]", help="additional point light")
    f.add_argument("--trainable", default="base_color,kd,ks,ka,light_pos",
                   help="comma-separated SceneParams fields")
    f.add_argument("--out-dir", default=None, help="checkpoint directory")
    f.add_argument("--fast", action="store_true")
    f.set_defaults(fn=cmd_fit, renders_color=True)

    b = sub.add_parser("bench", help="run the primary benchmark")
    b.add_argument("--width", type=int, default=0)
    b.set_defaults(fn=cmd_bench)

    st = sub.add_parser("stats", help="per-stage render metrics (SURVEY §5)")
    st.add_argument("--scene", default="serial", choices=scene_choices)
    st.add_argument("--config")
    st.add_argument("--width", type=int, default=64)
    st.add_argument("--height", type=int, default=0)
    st.add_argument("--fast", action="store_true")
    st.set_defaults(fn=cmd_stats)

    dbg = sub.add_parser("debug", help="single-pixel diagnostic trace "
                         "(the reference's debug-thread hook)")
    dbg.add_argument("--scene", default="serial", choices=scene_choices)
    dbg.add_argument("--config")
    dbg.add_argument("--width", type=int, default=64)
    dbg.add_argument("--height", type=int, default=0)
    dbg.add_argument("--x", type=int, required=True)
    dbg.add_argument("--y", type=int, required=True)
    dbg.add_argument("--fast", action="store_true")
    dbg.add_argument("--devices", type=int, default=0,
                     help="with --ring: ring-shard the geometry over "
                          "this many devices for the debug queries")
    dbg.add_argument("--ring", action="store_true",
                     help="trace the pixel through ring orbits over "
                          "sharded geometry (steps not recorded)")
    dbg.set_defaults(fn=cmd_debug)

    av = sub.add_parser("aov", help="export geometry buffers (depth/normal/ids)")
    av.add_argument("--scene", default="serial", choices=scene_choices)
    av.add_argument("--config")
    av.add_argument("--width", type=int, default=256)
    av.add_argument("--height", type=int, default=0)
    av.add_argument("--out", default="aovs.npz")
    av.add_argument("--ao-samples", type=int, default=0,
                    help="add an 'ao' buffer (N hemisphere rays/pixel)")
    av.add_argument("--ao-radius", type=float, default=1.0,
                    help="ambient-occlusion ray length")
    av.add_argument("--fast", action="store_true")
    av.add_argument("--devices", type=int, default=0,
                    help="shard the AOV/AO rays over this many devices")
    av.add_argument("--ring", action="store_true",
                    help="with --devices: shard the GEOMETRY and run "
                         "ring orbits instead (memory-bound scenes)")
    av.set_defaults(fn=cmd_aov)

    i = sub.add_parser("info", help="device / build info")
    i.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    if getattr(args, "height", 0) == 0 and hasattr(args, "height"):
        args.height = args.width
    return args


def main(argv=None) -> None:
    from ray_tracer_tpu.utils.cache import use_compile_cache

    use_compile_cache()
    args = parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
