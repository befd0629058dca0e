#!/usr/bin/env python
"""Proof that the renderer's main path runs on an NVIDIA GPU.

    python chip_smoke.py           # every phase at full size, one card
    python chip_smoke.py --four    # only the multi-device paths, four cards

Each phase prints one JSON line: what it compared, against what, under
which bound, and — for the timed phases — the first call (compile + one
run), the median of 5 further calls each ended by jax.block_until_ready,
the rate, and the device's peak_bytes_in_use so far.  The times are a
record of this run, not a claim.  The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

with N the number of devices the run used.  A phase that fails raises,
so the script exits non-zero and prints no result; it also exits
non-zero where JAX finds no GPU.  Everything runs in this one process:
no child process opens the card.

The phases are importable functions of the image size, so the CPU tests
run each of them at a tiny size (tests/test_chip_smoke.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import jax
import numpy as np

from ray_tracer_tpu import cli
from ray_tracer_tpu.io.ppm import read_ppm, tonemap_u8, write_ppm
from ray_tracer_tpu.models.scenes import asset
from ray_tracer_tpu.render.renderer import prepare, render

REPO = os.path.dirname(os.path.abspath(__file__))
NATIVE = os.path.join(REPO, "native")
REPS = 5

# Image bounds, fixed before the first run on the card.  Two renders of
# one scene by different traversals (or by one traversal on two
# backends) differ at boundary pixels: a ray grazing a silhouette or a
# shadow edge can flip between hit and miss under a different
# floating-point contraction (FMA) or reduction order.
MAX_FLIPPED_PIXELS = 0.01  # share of pixels differing by > 2 u8 counts
# GI wave vs segment loop: the wave hashes its own ray bits, so bounce
# draws on silhouette-grazing pixels differ; the images agree in mean.
GI_MEAN_ABS_BOUND = 0.05  # x the reference's mean radiance (+ 1e-3)
# One train-step gradient, card vs the CPU backend: the same math in
# another summation order and contraction, plus rare silhouette flips.
GRAD_REL_BOUND = 1e-2  # relative L2 error per trainable leaf
LOSS_REL_BOUND = 1e-4
# The faithful scenes in float64 against the C++ oracle: bit-identical
# on the CPU (tests/test_render_golden.py); on the card FMA contraction
# and reduction order move last bits, which can cross a u8 truncation
# boundary or flip a shadow on a knife-edge blocker.
MAX_ORACLE_PIXELS = 0.01  # share of pixels with any byte mismatched

GRAD_TRAINABLE = ("base_color", "kd", "ks", "ka", "light_pos")
LIGHT_SHIFT = np.asarray([0.5, 0.0, 0.0], np.float32)  # fit's starting error


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def _peak_bytes(device=None):
    stats = (device or jax.devices()[0]).memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def _timed(fn, reps: int = REPS):
    """-> (result, first-call seconds, median seconds of `reps` calls)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return out, first, statistics.median(times)


def _timing(first: float, median: float, units: float, unit: str) -> dict:
    return {
        "first_call_s": first,
        "compile_s": max(first - median, 0.0),
        "median_s": median,
        unit: units / median / 1e6,
        "peak_bytes_in_use": _peak_bytes(),
    }


def _flipped_share(img, ref) -> float:
    """Share of pixels whose u8 tonemap differs by more than 2 counts."""
    a = tonemap_u8(np.asarray(img)).astype(int)
    b = tonemap_u8(np.asarray(ref)).astype(int)
    return float((np.abs(a - b).max(axis=-1) > 2).mean())


def _check(ok: bool, rec: dict) -> dict:
    emit(rec)
    if not ok:
        raise AssertionError(f"phase {rec['phase']} failed its bound")
    return rec


def _cfg(argv):
    return cli._build_cfg(cli.parse_args(argv))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_env() -> dict:
    """The device, JAX's version, the card, and the compile cache.
    Raises SystemExit unless JAX's first device is a GPU."""
    from ray_tracer_tpu.utils.cache import use_compile_cache
    from ray_tracer_tpu.utils.device import card_name_and_power, require_gpu

    cache = use_compile_cache()
    dev = require_gpu()
    rec = {
        "phase": "env",
        "device_kind": dev["kind"],
        "device_count": dev["count"],
        "jax": jax.__version__,
        "card": card_name_and_power(),
        "compile_cache": cache,
    }
    emit(rec)
    return rec


def phase_build(build_dir: str = os.path.join(NATIVE, "build")) -> dict:
    """Build the oracle and libraytpu.so afresh from the committed
    sources: a build copied from another host may be newer than the
    sources and still be built for another CPU (-march=native)."""
    t0 = time.perf_counter()
    subprocess.run(
        ["make", "-C", NATIVE, "-B", "-j8", f"BUILD={build_dir}"],
        check=True, capture_output=True, timeout=900,
    )
    from ray_tracer_tpu.accel import native

    oracle = os.path.join(build_dir, "oracle")
    rec = {"phase": "build", "seconds": time.perf_counter() - t0,
           "oracle": os.path.exists(oracle),
           "native_library": native.available()}
    return _check(rec["oracle"], rec)


def _forward(phase: str, scene: str, size: int, ref_render,
             path: str = "persistent wave") -> dict:
    """One --turbo render of `scene` (as `cli render --turbo` builds it),
    timed, against `ref_render(cfg, scene_obj)` on the same device."""
    from ray_tracer_tpu.render.renderer import whitted_wave_eligible

    cfg, sc = _cfg(["render", "--scene", scene, "--width", str(size),
                    "--turbo"])
    prep = prepare(cfg, scene=sc)
    took = "Whitted wave" if whitted_wave_eligible(prep) else "persistent wave"
    if took != path:
        raise AssertionError(f"{phase} took the {took}, not the {path}")
    img, first, med = _timed(lambda: render(prep))
    ref, ref_name = ref_render(cfg, sc)
    flipped = _flipped_share(img, ref)
    img = np.asarray(img)
    return _check(
        bool(np.isfinite(img).all()) and flipped <= MAX_FLIPPED_PIXELS,
        {"phase": phase, "size": size, "faces": int(prep.scene.num_faces),
         "path": took,
         "layout": "inline" if prep.packed.meta.inline else "blocks",
         "reference": ref_name, "flipped_pixel_share": flipped,
         "bound": MAX_FLIPPED_PIXELS,
         **_timing(first, med, 2 * size * size, "mrays_per_s")},
    )


def _csr_reference(scene: str, size: int):
    def ref(_cfg_turbo, _sc):
        cfg, sc = _cfg(["render", "--scene", scene, "--width", str(size),
                        "--fast"])
        cfg = dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, traversal="csr", scheduler="tiled", ray_tile=16384))
        return render(prepare(cfg, scene=sc)), "csr walk, faithful=False"

    return ref


def phase_forward_spot(size: int = 1024) -> dict:
    return _forward("forward_spot", "serial", size,
                    _csr_reference("serial", size))


def phase_forward_dense(size: int = 1024) -> dict:
    return _forward("forward_dense", "nefertiti", size,
                    _csr_reference("nefertiti", size))


def phase_forward_mirror(size: int = 1024) -> dict:
    def bounce_loop(cfg, sc):
        cfg = dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, whitted_wave="off"))
        return render(prepare(cfg, scene=sc)), "bounce loop (whitted_wave=off)"

    return _forward("forward_mirror", "parallel", size, bounce_loop,
                    path="Whitted wave")


def phase_gi(size: int = 1024, spp: int = 4, depth: int = 2) -> dict:
    from ray_tracer_tpu.render.pathtrace import gi_wave_eligible

    cfg, sc = _cfg(["render", "--scene", "serial", "--width", str(size),
                    "--turbo", "--gi-samples", str(spp),
                    "--gi-depth", str(depth)])
    prep = prepare(cfg, scene=sc)
    if not gi_wave_eligible(prep):
        raise AssertionError("the GI config no longer takes the GI wave")
    img, first, med = _timed(lambda: render(prep))
    loop = prep._replace(cfg=dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, gi_wave="off")))
    ref = np.asarray(render(loop))
    img = np.asarray(img)
    mean_abs = float(np.abs(img - ref).mean())
    bound = GI_MEAN_ABS_BOUND * max(float(ref.mean()), 1e-6) + 1e-3
    return _check(
        bool(np.isfinite(img).all()) and mean_abs < bound,
        {"phase": "gi", "size": size, "spp": spp, "depth": depth,
         "reference": "segment loop (gi_wave=off)",
         "mean_abs_diff": mean_abs, "bound": bound,
         **_timing(first, med, size * size * spp, "mpaths_per_s")},
    )


def _fit_setup(size: int):
    """cmd_fit's self-demo on the serial scene: the target is the scene's
    own render, and training starts from perturbed materials — and a
    moved light.  With the light at its optimum, Adam's first steps
    (about lr per coordinate whatever the gradient) only push it off,
    and on this scene's sharp highlights the loss then rises."""
    from ray_tracer_tpu.opt.fit import merge_scene, split_scene

    args = cli.parse_args(["fit", "--scene", "serial", "--width", str(size)])
    cfg, sc = cli._build_cfg(args)
    prep = prepare(cfg, scene=sc)
    target = render(prep)
    p = split_scene(prep.scene)
    prep = prep._replace(scene=merge_scene(
        p._replace(kd=p.kd * 1.5, base_color=p.base_color * 0.6,
                   light_pos=p.light_pos + LIGHT_SHIFT), prep.scene))
    return args, prep, target


def _grad_on(device, prep, target):
    """(loss, grads of the trainable fields) of one train step's loss
    on `device`."""
    from ray_tracer_tpu.opt.fit import image_loss, split_scene

    with jax.default_device(device):
        params, scene, grid, tgt = jax.device_put(
            (split_scene(prep.scene), prep.scene, prep.grid.arrays, target),
            device)
        fn = jax.jit(jax.value_and_grad(image_loss), static_argnums=(3, 4))
        loss, g = fn(params, scene, grid, prep.grid.meta, prep.cfg, tgt)
        return float(loss), {f: np.asarray(getattr(g, f), np.float64)
                             for f in GRAD_TRAINABLE}


def phase_fit(size: int = 1024, steps: int = 4, grad_size: int = 128) -> dict:
    from ray_tracer_tpu.opt.fit import fit, make_train_step, split_scene

    args, prep, target = _fit_setup(size)
    trainable = tuple(f.strip() for f in args.trainable.split(","))
    # the same cached step fit() builds (make_train_step is memoized on
    # its arguments), timed on its own
    step, init = make_train_step(prep.grid.meta, prep.cfg, lr=args.lr,
                                 trainable=trainable)
    params = split_scene(prep.scene)
    opt_state = init(params)
    _, first, med = _timed(lambda: step(params, opt_state, prep.scene,
                                        prep.grid.arrays, target))
    _, losses = fit(prep, target, steps=steps, lr=args.lr,
                    trainable=trainable, log_every=0)
    decreasing = all(np.isfinite(losses)) and losses[-1] < losses[0]

    _, gprep, gtarget = _fit_setup(grad_size)
    card_loss, card_g = _grad_on(jax.devices()[0], gprep, gtarget)
    cpu_loss, cpu_g = _grad_on(jax.devices("cpu")[0], gprep, gtarget)
    rel = {f: float(np.linalg.norm(card_g[f] - cpu_g[f])
                    / max(np.linalg.norm(cpu_g[f]), 1e-30))
           for f in GRAD_TRAINABLE}
    loss_rel = abs(card_loss - cpu_loss) / max(abs(cpu_loss), 1e-30)
    return _check(
        decreasing and max(rel.values()) <= GRAD_REL_BOUND
        and loss_rel <= LOSS_REL_BOUND,
        {"phase": "fit", "size": size, "losses": losses,
         "trainable": list(trainable), "grad_size": grad_size,
         "grad_rel_err_vs_cpu": rel, "grad_bound": GRAD_REL_BOUND,
         "loss_rel_err_vs_cpu": loss_rel, "loss_bound": LOSS_REL_BOUND,
         **_timing(first, med, 2 * size * size, "mrays_per_s")},
    )


def _oracle_ppm(oracle: str, size: int, variant_args) -> np.ndarray:
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "oracle.ppm")
        subprocess.run([oracle, "--width", str(size), "--height", str(size),
                        "--out", out] + variant_args,
                       check=True, capture_output=True, timeout=900)
        return read_ppm(out)


def _ours_ppm(cfg) -> np.ndarray:
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, det_dtype="float64", ray_tile=1024))
    img = np.asarray(render(prepare(cfg)))
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "ours.ppm")
        write_ppm(out, img)
        return read_ppm(out)


def phase_oracle(serial_size: int = 512, parallel_size: int = 256,
                 build_dir: str = os.path.join(NATIVE, "build")) -> dict:
    """The faithful scenes with float64 determinants against the C++
    oracle's PPM.  x64 is on for this phase only."""
    from ray_tracer_tpu.models.scenes import (
        parallel_scene_config,
        serial_scene_config,
    )

    oracle = os.path.join(build_dir, "oracle")
    cases = {
        "serial": (serial_scene_config, serial_size, [
            "--mesh", asset("spot_triangulated.obj"),
            "--mesh", asset("blub_triangulated.obj") + ":1.5,0,0"]),
        "parallel": (parallel_scene_config, parallel_size, [
            "--variant", "parallel", "--camera", "18,18,19", "--fov", "60",
            "--light", "2,5,0",
            "--mesh", asset("plane.obj") + ":0,0.4,0:3:0",
            "--mesh", asset("blub_triangulated.obj") + ":-2,0,0:5:1",
            "--mesh", asset("spot_triangulated.obj") + ":0,0,0:5:1",
            "--mesh", asset("blub_triangulated.obj") + ":2,0,0:5:3"]),
    }
    rec = {"phase": "oracle", "bound_pixel_share": MAX_ORACLE_PIXELS}
    ok = True
    with jax.enable_x64(True):
        for name, (make_cfg, size, oargs) in cases.items():
            want = _oracle_ppm(oracle, size, oargs)
            got = _ours_ppm(make_cfg(size, size))
            pix = float((got != want).any(axis=-1).mean())
            rec[name] = {"size": size,
                         "mismatched_bytes": int((got != want).sum()),
                         "mismatched_pixel_share": pix}
            ok = ok and pix <= MAX_ORACLE_PIXELS
    return _check(ok, rec)


# ---------------------------------------------------------------------------
# --four: the multi-device paths, each against the same work on one card
# ---------------------------------------------------------------------------


def _per_device_peaks(devices) -> list:
    return [_peak_bytes(d) for d in devices]


def four_rays(devices, size: int = 2048) -> dict:
    """render_sharded over a 4-way "rays" mesh vs one card."""
    from ray_tracer_tpu.parallel.mesh import make_mesh
    from ray_tracer_tpu.parallel.shard import render_sharded

    cfg, sc = _cfg(["render", "--scene", "serial", "--width", str(size),
                    "--turbo"])
    prep = prepare(cfg, scene=sc)
    mesh = make_mesh(len(devices), ("rays",), devices=devices)
    img, first, med = _timed(lambda: render_sharded(prep, mesh=mesh))
    peaks = _per_device_peaks(devices)
    ref = render(prep)
    flipped = _flipped_share(img, ref)
    return _check(
        flipped <= MAX_FLIPPED_PIXELS,
        {"phase": "four_rays", "size": size, "devices": len(devices),
         "reference": "render() on one device",
         "flipped_pixel_share": flipped, "bound": MAX_FLIPPED_PIXELS,
         "max_abs_diff": float(np.abs(np.asarray(img) - np.asarray(ref)).max()),
         "first_call_s": first, "median_s": med,
         "mrays_per_s": 2 * size * size / med / 1e6,
         "peak_bytes_in_use_per_device": peaks},
    )


def four_ring(devices, size: int = 1024) -> dict:
    """render_sharded_geometry with every device on "tris" (the CLI's
    `render --devices N --ring`) vs one card."""
    from ray_tracer_tpu.parallel.mesh import make_mesh
    from ray_tracer_tpu.parallel.shard import render_sharded_geometry

    cfg, sc = _cfg(["render", "--scene", "parallel", "--width", str(size),
                    "--turbo"])
    prep = prepare(cfg, scene=sc)
    mesh = make_mesh(len(devices), ("tris",), shape=(len(devices),),
                     devices=devices)
    img, first, med = _timed(
        lambda: render_sharded_geometry(prep, mesh=mesh, rays_axis=None))
    peaks = _per_device_peaks(devices)
    ref = render(prep)
    flipped = _flipped_share(img, ref)
    return _check(
        flipped <= MAX_FLIPPED_PIXELS,
        {"phase": "four_ring", "size": size, "devices": len(devices),
         "reference": "render() on one device",
         "flipped_pixel_share": flipped, "bound": MAX_FLIPPED_PIXELS,
         "first_call_s": first, "median_s": med,
         "mrays_per_s": 2 * size * size / med / 1e6,
         "peak_bytes_in_use_per_device": peaks},
    )


def four_train(devices, size: int = 1024) -> dict:
    """One ray-sharded make_train_step step vs the unsharded step: the
    loss, and the gradients read back through plain SGD at lr 1
    (params - new_params == grads)."""
    from ray_tracer_tpu.opt.fit import make_train_step, split_scene
    from ray_tracer_tpu.parallel.mesh import make_mesh

    _, prep, target = _fit_setup(size)
    params = split_scene(prep.scene)
    mesh = make_mesh(len(devices), ("rays",), devices=devices)
    out = {}
    for name, m in (("sharded", mesh), ("single", None)):
        step, init = make_train_step(prep.grid.meta, prep.cfg,
                                     optimizer="sgd", lr=1.0, mesh=m,
                                     trainable=GRAD_TRAINABLE)
        (new, _, loss), first, med = _timed(lambda: step(
            params, init(params), prep.scene, prep.grid.arrays, target))
        grads = {f: np.asarray(getattr(params, f), np.float64)
                 - np.asarray(getattr(new, f), np.float64)
                 for f in GRAD_TRAINABLE}
        out[name] = (float(loss), grads, first, med)
        if name == "sharded":
            peaks = _per_device_peaks(devices)
    (sl, sg, first, med), (ul, ug, _, umed) = out["sharded"], out["single"]
    rel = {f: float(np.linalg.norm(sg[f] - ug[f])
                    / max(np.linalg.norm(ug[f]), 1e-30))
           for f in GRAD_TRAINABLE}
    loss_rel = abs(sl - ul) / max(abs(ul), 1e-30)
    return _check(
        max(rel.values()) <= GRAD_REL_BOUND and loss_rel <= LOSS_REL_BOUND,
        {"phase": "four_train", "size": size, "devices": len(devices),
         "reference": "make_train_step without a mesh, one device",
         "loss_rel_err": loss_rel, "grad_rel_err": rel,
         "grad_bound": GRAD_REL_BOUND, "loss_bound": LOSS_REL_BOUND,
         "first_call_s": first, "median_s": med, "single_median_s": umed,
         "peak_bytes_in_use_per_device": peaks},
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-device paths, on four cards")
    args = ap.parse_args(argv)

    env = phase_env()
    if args.four:
        if env["device_count"] < 4:
            raise SystemExit(f"--four needs 4 GPUs, JAX sees {env['device_count']}")
        devices = jax.devices()[:4]
        four_rays(devices)
        four_ring(devices)
        four_train(devices)
        count = 4
    else:
        phase_build()
        phase_forward_spot()
        phase_forward_dense()
        phase_forward_mirror()
        phase_gi()
        phase_fit()
        phase_oracle()
        count = 1
    emit({"ok": True, "device": {"platform": jax.devices()[0].platform,
                                 "kind": env["device_kind"], "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
