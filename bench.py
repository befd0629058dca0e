"""Primary benchmark: Mrays/s (primary+shadow) on the flagship scene.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

The baseline is the re-hosted serial C++ oracle (native/build/oracle)
timed on this host at the same scene — the reference publishes no
numbers (BASELINE.md), so the oracle's single-core Mrays/s is the
yardstick.  vs_baseline > 1 means faster than the reference algorithm
on a CPU core.

Every row names its device (JAX's platform, device kind and count, and
the card's name and power limit from nvidia-smi).  The bench refuses to
run where JAX finds no GPU.

Usage: python bench.py [--size N] [--scene serial] [--repeat K]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def oracle_mrays(size: int, scene: str = "spot") -> float:
    """Build + run the C++ oracle, return its Mrays/s (counted as
    2*W*H rays/frame, matching the oracle's own reporting)."""
    oracle = os.path.join(REPO, "native", "build", "oracle")
    a = lambda n: os.path.join(REPO, "assets", n)  # noqa: E731
    if scene == "parallel":
        scene_args = [
            "--variant", "parallel", "--camera", "18,18,19", "--fov", "60",
            "--light", "2,5,0",
            "--mesh", a("plane.obj") + ":0,0.4,0:3:0",
            "--mesh", a("blub_triangulated.obj") + ":-2,0,0:5:1",
            "--mesh", a("spot_triangulated.obj") + ":0,0,0:5:1",
            "--mesh", a("blub_triangulated.obj") + ":2,0,0:5:3",
        ]
    else:
        scene_args = [
            "--mesh", a("spot_triangulated.obj"),
            "--mesh", a("blub_triangulated.obj") + ":1.5,0,0",
        ]
    try:
        if not os.path.exists(oracle):
            subprocess.run(["make", "-C", os.path.join(REPO, "native"), "-j4"],
                           check=True, capture_output=True, timeout=300)
        out = subprocess.run(
            [
                oracle, "--width", str(size), "--height", str(size),
                "--out", os.path.join(tempfile.gettempdir(), "bench_oracle.ppm"),
                "--repeat", "3",
            ] + scene_args,
            check=True, capture_output=True, timeout=1200, text=True,
        )
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        return float(rec["mrays_per_s"])
    except Exception as e:  # baseline failure must not kill the bench
        log(f"oracle baseline unavailable: {e}")
        return 0.0


def _bench_grad(prep, args, size: int) -> None:
    """BASELINE config 4: forward + backward (one train step) throughput."""
    import jax
    import jax.numpy as jnp

    from ray_tracer_tpu.opt.fit import make_train_step, split_scene

    trainable = tuple(f.strip() for f in args.trainable.split(",") if f.strip())
    step, init = make_train_step(
        prep.packed.meta if prep.cfg.render.traversal == "packed" else prep.grid.meta,
        prep.cfg, lr=1e-3,
        trainable=trainable,
    )
    params = split_scene(prep.scene)
    opt_state = init(params)
    garr = (prep.packed.arrays if prep.cfg.render.traversal == "packed"
            else prep.grid.arrays)
    target = jnp.zeros((size, size, 3), jnp.float32)

    p, o, loss = step(params, opt_state, prep.scene, garr, target)
    jax.block_until_ready(loss)
    n = max(args.repeat, 2)
    sec = float("inf")  # best-of-rounds, same protocol as the forward bench
    for _ in range(max(args.rounds, 1)):
        p, o = params, opt_state
        t0 = time.perf_counter()
        for _ in range(n):
            p, o, loss = step(p, o, prep.scene, garr, target)
        jax.block_until_ready(loss)
        sec = min(sec, (time.perf_counter() - t0) / n)
    rays = size * size * 2
    print(json.dumps({
        "metric": f"train_step_mrays_per_s_{args.scene}",
        "value": round(rays / sec / 1e6, 4),
        "unit": "Mrays/s (fwd+bwd)",
        "vs_baseline": 0.0,  # the reference has no backward pass
        "seconds_per_step": round(sec, 4),
        "size": size,
        "trainable": list(trainable),
        **_device_fields(),
    }))


def _bench_gi(prep, args, size: int) -> None:
    """Path-traced GI throughput (render/pathtrace.py) — a beyond-
    reference feature, so vs_baseline is 0.  Counted as all dispatched
    ray segments: per sample and per path vertex, one path segment plus
    one NEE shadow segment (dead/compacted lanes included, so this is
    the same generous convention as the reflective-scene count)."""
    import dataclasses as _dc
    import time as _time

    import jax

    from ray_tracer_tpu.render.renderer import render

    cfg = _dc.replace(
        prep.cfg,
        render=_dc.replace(
            prep.cfg.render, gi_samples=args.gi, gi_depth=args.gi_depth,
            gi_wave=args.gi_wave,
        ),
    )
    prep = prep._replace(cfg=cfg)
    from ray_tracer_tpu.render.pathtrace import gi_wave_eligible

    log(f"gi_wave: {args.gi_wave} -> "
        f"{'wave' if gi_wave_eligible(prep) else 'segments'}")

    t0 = _time.perf_counter()
    jax.block_until_ready(render(prep))
    log(f"first GI render (incl compile): {_time.perf_counter() - t0:.1f}s")
    n = max(args.repeat, 2)
    chains = []
    for _ in range(max(args.rounds, 1)):
        t0 = _time.perf_counter()
        img = None
        for _ in range(n):
            img = render(prep)
        jax.block_until_ready(img)
        chains.append((_time.perf_counter() - t0) / n)
    sec = min(chains)
    med = sorted(chains)[len(chains) // 2]
    segments = size * size * args.gi * 2 * (args.gi_depth + 1)
    print(json.dumps({
        "metric": f"gi_mrays_per_s_{args.scene}",
        "value": round(segments / sec / 1e6, 4),
        "unit": "Mrays/s (path+NEE segments)",
        "vs_baseline": 0.0,  # the reference has no GI integrator
        "seconds_per_frame": round(sec, 4),
        "secs_chains": [round(c, 4) for c in chains],
        "size": size,
        "gi_samples": args.gi,
        "gi_depth": args.gi_depth,
        "paths_per_s_m": round(size * size * args.gi / sec / 1e6, 4),
        "paths_per_s_m_median": round(
            size * size * args.gi / med / 1e6, 4
        ),
        **_device_fields(),
    }))


SUITE = (
    # the benchmark table: both flagship resolutions incl. the BASELINE
    # config-5 2048^2, the reflective CUDA-variant scene and the
    # official GI configuration
    {"workload": "spot_1024", "args": ["--scene", "spot", "--size", "1024"]},
    {"workload": "spot_2048", "args": ["--scene", "spot", "--size", "2048"]},
    {"workload": "nefertiti_1024",
     "args": ["--scene", "nefertiti", "--size", "1024"]},
    {"workload": "nefertiti_2048",
     "args": ["--scene", "nefertiti", "--size", "2048"]},
    {"workload": "parallel_1024",
     "args": ["--scene", "parallel", "--size", "1024"]},
    {"workload": "gi_spot_1024_s4d2",
     "args": ["--scene", "spot", "--size", "1024", "--gi", "4"]},
)


def run_suite(timeout_s: float) -> None:
    """One row per workload, each measured in its own subprocess (a
    failure or hang in one cannot lose the others' numbers), emitted as
    ONE JSON line whose headline fields are the primary spot 1024^2
    metric and whose "rows" list carries every workload with best +
    median + per-chain spread."""
    rows = []
    for w in SUITE:
        cmd = [sys.executable, os.path.abspath(__file__)] + w["args"]
        log(f"suite: {w['workload']} ...")
        try:
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=timeout_s)
            line = (out.stdout or "").strip().splitlines()[-1]
            row = json.loads(line)
            if out.returncode != 0 and "error" not in row:
                row["error"] = f"rc={out.returncode}"
        except Exception as e:
            row = {"error": f"{type(e).__name__}: {e}"}
        row["workload"] = w["workload"]
        rows.append(row)
        log(f"suite: {w['workload']} -> "
            f"{row.get('value', row.get('error'))}")
    head = next((r for r in rows if r["workload"] == "spot_1024"), rows[0])
    rec = dict(head)
    rec["rows"] = rows
    print(json.dumps(rec))


def _device_fields() -> dict:
    """The device every row names: JAX's view of it and the card's."""
    from ray_tracer_tpu.utils.device import card_name_and_power, require_gpu

    return {"device": require_gpu(), "card": card_name_and_power()}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=None,
                    help="render resolution (default 1024)")
    ap.add_argument("--suite", default="auto", choices=["auto", "on", "off"],
                    help="run the full recorded workload table (one row "
                         "per workload with best/median/spread) instead "
                         "of a single measurement; 'auto' = suite when "
                         "invoked bare (the driver's `python bench.py`), "
                         "single when --scene/--size/--gi/--grad given")
    ap.add_argument("--suite-timeout", type=float, default=1500.0)
    ap.add_argument("--oracle-size", type=int, default=None,
                    help="oracle baseline resolution (default: same as "
                         "--size, so vs_baseline is same-scene-same-size)")
    ap.add_argument("--repeat", type=int, default=8,
                    help="frames per timed chain")
    ap.add_argument("--rounds", type=int, default=3,
                    help="timed chains; the fastest is reported (transient "
                         "shared-host stalls only ever slow a chain)")
    ap.add_argument("--scene", default=None,
                    choices=["spot", "nefertiti", "parallel"],
                    help="spot = BASELINE config 3 (primary metric); "
                         "nefertiti = config 4 (260k-tri stand-in); "
                         "parallel = CUDA-variant reflective scene")
    ap.add_argument("--grad", action="store_true",
                    help="benchmark one fwd+bwd train step instead of forward")
    ap.add_argument("--gi", type=int, default=0, metavar="SAMPLES",
                    help="benchmark the path-traced GI integrator at this "
                         "many samples/pixel instead of the Whitted forward")
    ap.add_argument("--gi-depth", type=int, default=2,
                    help="GI bounce depth (with --gi)")
    ap.add_argument("--gi-wave", default="auto",
                    choices=["auto", "on", "off"],
                    help="cross-depth GI wave (ops/gi_wave.py): the bench "
                         "opts in ('auto'); 'off' = the per-(sample,depth) "
                         "segment loop for A/B")
    ap.add_argument("--whitted-wave", default=None,
                    choices=["auto", "on", "off"],
                    help="cross-depth Whitted wave (ops/whitted_wave.py): "
                         "default = the per-scene tuned policy (on for "
                         "the mirror scene, off for single-depth scenes "
                         "where the fused march already is one wave)")
    ap.add_argument("--trainable",
                    default="base_color,kd,ks,ka,light_pos",
                    help="comma list of SceneParams fields to differentiate "
                         "in --grad mode; add 'verts' for the BASELINE "
                         "config-4 vertex-gradient step (grid held fixed "
                         "for the timed steps, as fit does between rebuilds)")
    ap.add_argument("--scheduler", default="persistent",
                    choices=["tiled", "persistent"])
    ap.add_argument("--wave", type=int, default=None,
                    help="persistent-scheduler lane count")
    ap.add_argument("--pump", type=int, default=None,
                    help="persistent march steps per scatter+refill round")
    ap.add_argument("--block-tris", type=int, default=None,
                    help="triangles per packed block row")
    ap.add_argument("--fused", default="auto", choices=["auto", "on", "off"],
                    help="fuse the shadow pass into the primary march")
    ap.add_argument("--layout", default="auto",
                    choices=["auto", "inline", "blocks"],
                    help="packed-grid memory layout (inline = one gather "
                         "per march step; see config.RenderConfig)")
    ap.add_argument("--rm", type=float, default=None,
                    help="grid resolution multiplier (cells ~ rm * 3*cbrt(N))")
    ap.add_argument("--max-res", type=int, default=None,
                    help="per-axis grid resolution clamp (reference: 64)")
    ap.add_argument("--probe-chain", type=int, default=None,
                    help="cell probes per march step for leap-only lanes "
                         "(blocks layout; see RenderConfig.probe_chain)")
    ap.add_argument("--order", default=None, choices=["fifo", "chord"],
                    help="persistent work-queue pop order (chord = longest "
                         "slab chord first, the straggler-overlap schedule; "
                         "default: per-scene tuned value)")
    ap.add_argument("--exact", default=None, choices=["on", "off"],
                    help="SAT exact triangle-box grid insertion "
                         "(GridConfig.exact_overlap); default: the "
                         "per-scene tuned value (on)")
    args = ap.parse_args()
    suite = args.suite == "on" or (
        args.suite == "auto" and args.scene is None and args.size is None
        and args.gi == 0 and not args.grad
    )
    if args.scene is None:
        args.scene = "spot"
    if args.size is None:
        args.size = 1024

    from ray_tracer_tpu.utils.cache import use_compile_cache
    from ray_tracer_tpu.utils.device import require_gpu

    use_compile_cache()
    require_gpu()

    if suite:
        run_suite(args.suite_timeout)
        return

    # Per-scene tuned defaults from the ONE shared knob table
    # (ray_tracer_tpu.config.TUNED_KNOBS, also behind the CLI's --turbo;
    # carried over from the previous chip): sparse spot wants
    # narrow 14-tri rows, a fine unclamped grid and pump 3 under the
    # inline layout; the dense 261k-tri stand-in wants 28-tri rows and
    # the stock cap (rm 1.0-1.5 is a wide plateau).  grid_layout "auto"
    # resolves to inline for spot (probe-heavy) and blocks for the
    # dense/reflective scenes (renderer.choose_inline_layout).
    from ray_tracer_tpu.config import TUNED_KNOBS

    _tuned = TUNED_KNOBS[{"spot": "serial"}.get(args.scene, args.scene)]
    if args.block_tris is None:
        args.block_tris = _tuned["block_tris"]
    if args.rm is None:
        args.rm = _tuned["rm"]
    if args.max_res is None:
        args.max_res = _tuned["max_res"]
    if args.wave is None:
        args.wave = _tuned["wave"]
    if args.pump is None:
        args.pump = _tuned["pump"]
    exact = (_tuned["exact"] if args.exact is None else args.exact == "on")
    if args.order is None:
        args.order = _tuned.get("order", "fifo")
    if args.whitted_wave is None:
        args.whitted_wave = "auto" if _tuned.get("wwave") else "off"
    if (args.whitted_wave != "off" and _tuned.get("wwave")
            and args.gi == 0 and not args.grad):
        # the cross-depth Whitted wave's own measured knee (TUNED_KNOBS):
        # the transition pass amortizes over pump, so its knee sits far
        # beyond the plain fused march's.  Forward renders only — GI and
        # grad runs never take the Whitted wave, so they keep their own
        # tuned knobs.
        if "--pump" not in sys.argv:
            args.pump = _tuned.get("wwave_pump", args.pump)
        if "--wave" not in sys.argv:
            args.wave = _tuned.get("wwave_wave", args.wave)
    if args.probe_chain is None:
        args.probe_chain = _tuned.get("chain", 1)
    if args.gi > 0 and "--pump" not in sys.argv:
        # the GI wave's own pump knee (TUNED_KNOBS gi_pump)
        args.pump = _tuned.get("gi_pump", args.pump)

    import dataclasses

    import jax

    from ray_tracer_tpu.models.scenes import serial_scene_config
    from ray_tracer_tpu.render.renderer import prepare, render

    size = args.size
    from ray_tracer_tpu.config import GridConfig

    scene = None
    if args.scene == "nefertiti":
        from ray_tracer_tpu.models.scenes import nefertiti_scene

        scene, cfg = nefertiti_scene(size, size)
    elif args.scene == "parallel":
        from ray_tracer_tpu.models.scenes import parallel_scene_config

        cfg = parallel_scene_config(size, size)
    else:
        cfg = serial_scene_config(size, size)
    cfg = dataclasses.replace(
        cfg,
        render=dataclasses.replace(
            cfg.render, faithful=False, det_dtype="float32",
            traversal="packed", ray_tile=768,
            packed_block_tris=args.block_tris,
            fused_shadow=False,  # decided below (measured, or forced by --fused)
            scheduler=args.scheduler, wave=args.wave, pump=args.pump,
            queue_order=args.order, probe_chain=args.probe_chain,
            grid_layout=args.layout,
            grid=GridConfig(resolution_multiplier=args.rm,
                            max_resolution=args.max_res,
                            exact_overlap=exact),
        ),
    )
    log(f"device: {jax.devices()[0]}")
    t0 = time.perf_counter()
    prep = prepare(cfg, scene=scene)
    log(f"prepare: {time.perf_counter() - t0:.1f}s; "
        f"scene: {args.scene} {prep.scene.num_faces} tris @ {size}x{size}")

    # fused-vs-two-pass shadow schedule: measured coverage probe, not a
    # scene-name switch (sparse scenes fuse, dense full-frame don't)
    if args.fused == "auto":
        from ray_tracer_tpu.render.metrics import choose_fused_shadow

        fused = choose_fused_shadow(prep)
        log(f"auto fused_shadow: {fused}")
    else:
        fused = args.fused == "on"
    # depth-0 refill source: regen-from-camera vs ray-table gather —
    # the same measured-probe pattern (render/metrics.choose_camera_refill)
    from ray_tracer_tpu.render.metrics import choose_camera_refill

    refill = "on" if choose_camera_refill(prep) else "off"
    log(f"auto camera_refill: {refill}")
    cfg = dataclasses.replace(
        cfg, render=dataclasses.replace(cfg.render, fused_shadow=fused,
                                        camera_refill=refill,
                                        whitted_wave=args.whitted_wave)
    )
    prep = prep._replace(cfg=cfg)
    if not args.grad and args.gi == 0:
        from ray_tracer_tpu.render.renderer import whitted_wave_eligible

        log(f"whitted_wave: {args.whitted_wave} -> "
            f"{'wave' if whitted_wave_eligible(prep) else 'bounce loop'}")

    if args.grad:
        _bench_grad(prep, args, size)
        return

    if args.gi > 0:
        _bench_gi(prep, args, size)
        return

    t0 = time.perf_counter()
    jax.block_until_ready(render(prep))
    log(f"first render (incl compile): {time.perf_counter() - t0:.1f}s")

    # Chain N dispatches, sync once.  Best-of over a few chains: host
    # noise only ever slows a chain.
    n = max(args.repeat, 2)
    chains = []
    for _ in range(max(args.rounds, 1)):
        t0 = time.perf_counter()
        img = None
        for _ in range(n):
            img = render(prep)
        jax.block_until_ready(img)
        chains.append((time.perf_counter() - t0) / n)
    sec = min(chains)
    med = sorted(chains)[len(chains) // 2]

    rays = size * size * 2  # primary + shadow (BASELINE.md primary metric)
    mrays = rays / sec / 1e6
    base = oracle_mrays(args.oracle_size or args.size, args.scene)
    vs = mrays / base if base > 0 else 0.0
    print(json.dumps({
        "metric": f"mrays_per_s_{args.scene}_primary_shadow",
        "value": round(mrays, 4),
        "unit": "Mrays/s",
        "vs_baseline": round(vs, 4),
        "seconds_per_frame": round(sec, 4),
        # per-chain spread: best-of is the record (host noise only ever
        # slows a chain), median + the raw chains expose the spread so
        # a regression cannot hide inside host variance
        "value_median": round(rays / med / 1e6, 4),
        "secs_chains": [round(c, 4) for c in chains],
        "size": size,
        "oracle_mrays_per_s": round(base, 4),
        **_device_fields(),
    }))


if __name__ == "__main__":
    main()
