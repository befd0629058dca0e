"""Typed configuration for scenes, cameras, lights, materials and rendering.

The reference has no config system — every knob is a compile-time literal
(camera at Serial/raytracer.cpp:124-128, shading constants at :82-89,
Parallel constants at Parallel/raytracer.cu:13-18, 449-453, 470).  Here a
single set of dataclasses reproduces those exact defaults and serialises
to/from JSON so every benchmark config in BASELINE.md is a config file,
not a code edit.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

Vec3 = Tuple[float, float, float]


@dataclass(frozen=True)
class CameraConfig:
    """Pinhole look-at camera (reference: Serial/raytracer.cpp:124-138).

    aperture > 0 turns it into a thin lens for depth of field: each
    spp-subsample's ray starts from a deterministic golden-spiral point
    on the aperture disk and aims at the pixel's point on the focal
    plane (focus_distance along the view axis; 0 = the distance to
    `target`).  Blur needs spp > 1 (one subsample = one lens point);
    aperture == 0 is the reference-exact pinhole, bitwise.  Production
    feature; no reference counterpart."""

    position: Vec3 = (3.0, 5.0, 3.0)
    target: Vec3 = (0.0, 0.0, 0.0)
    up: Vec3 = (0.0, -1.0, 0.0)
    fov_degrees: float = 45.0
    width: int = 512
    height: int = 512
    aperture: float = 0.0
    focus_distance: float = 0.0


@dataclass(frozen=True)
class LightConfig:
    """Single point light (reference: Serial/raytracer.cpp:87-89)."""

    position: Vec3 = (5.0, -5.0, 2.0)
    intensity: float = 255.0


@dataclass(frozen=True)
class MaterialConfig:
    """Blinn-Phong material (reference: Parallel/geometry.cuh:284-303).

    The serial variant hardcodes one implicit material
    (Serial/raytracer.cpp:83-89); the parallel variant uses a 4-entry
    table (Parallel/raytracer.cu:449-453).
    """

    base_color: Vec3 = (255.0, 0.0, 0.0)
    kd: float = 2.0
    ks: float = 5.0e11
    spec_alpha: float = 4.0
    ka: float = 0.2
    km: float = 0.0
    reflective: bool = False
    # Dielectric (glass) extension — no reference counterpart (the
    # reference's materials are Blinn-Phong + mirror only).  A
    # transmissive material refracts/reflects by the exact Fresnel
    # dielectric equations in the path-traced GI integrator
    # (render/pathtrace.py); the Whitted paths reject it (the Whitted
    # recursion has no refraction branch, matching the reference).
    transmissive: bool = False
    ior: float = 1.5  # index of refraction (only read when transmissive)


@dataclass(frozen=True)
class MeshConfig:
    """One OBJ mesh instance in a scene (reference: load_mesh signatures,
    Serial/raytracer.cpp:189, Parallel/geometry.cuh:280-282)."""

    path: str
    material_index: int = 0
    offset: Vec3 = (0.0, 0.0, 0.0)
    scale: float = 1.0
    has_vt: bool = True


@dataclass(frozen=True)
class GridConfig:
    """Uniform-grid acceleration structure (reference: Serial/grid.h:94-101).

    resolution_multiplier=3 and max_resolution=64 reproduce the reference
    heuristic nVoxels = clamp(delta * 3*cbrt(N)/maxExtent + 1, 1, 64).
    """

    resolution_multiplier: float = 3.0
    max_resolution: int = 64
    # Insertion policy.  False reproduces the reference: a triangle
    # enters every voxel overlapped by its AABB (Serial/grid.h:118-150)
    # — conservative, and false-positive-heavy for diagonal triangles
    # on finely tessellated surfaces.  True filters each candidate
    # (triangle, voxel) pair with an exact SAT triangle-box test
    # (Akenine-Möller 2001, 13 axes; epsilon-inflated so it stays
    # conservative against the build's float32 binning), shrinking
    # per-voxel lists and turning grazed-but-not-touched cells empty
    # (better Chebyshev leaps).  Nearest-hit results are unchanged:
    # the cell containing any hit point always keeps its triangle.
    # A production knob — the bit-faithful oracle configs leave it off.
    exact_overlap: bool = False
    # Empty-cell leap geometry for the packed layouts: "box" (default)
    # stores each empty cell's greedy maximal empty box (six 5-bit
    # per-direction extents — anisotropic leaps; 21% fewer primary and
    # 36% fewer shadow probe steps on the dense displaced-sphere scene),
    # "cheb" the rounds-1-3 symmetric Chebyshev cube (kept for
    # reproduction).  Hits are identical either way; only step counts
    # and therefore throughput differ (accel/packed.greedy_empty_boxes).
    leap: str = "box"


@dataclass(frozen=True)
class RenderConfig:
    """End-to-end render settings.

    shading="serial" reproduces Serial/raytracer.cpp:71-118 (single implicit
    material, shadow scale 0.1, negated shadow direction quirk);
    shading="parallel" reproduces Parallel/raytracer.cu:445-524 (material
    table, shadow halving, <=3 mirror bounces).

    faithful=True reproduces the reference's exact hit semantics
    (negative-t hits allowed, shadow ray counts any barycentric pass along
    the walked voxels — Serial/geometry.h:162-174); faithful=False uses
    corrected semantics (t in (mint, maxt), DDA early-exit on confirmed
    hit) which is the fast production path.
    """

    shading: str = "serial"  # "serial" | "parallel"
    faithful: bool = True
    # "csr": oracle-faithful lock-step DDA over the CSR grid (supports
    # faithful semantics).  "packed": production block-packed traversal
    # with empty-space skipping and entry-sorted tiling — the fast path
    # (requires faithful=False).
    traversal: str = "csr"
    # Triangles per packed block row (14/28/56); 0 = auto: prepare()
    # rounds the measured mean triangles-per-occupied-voxel up to the
    # next row size (the previous chip's sweep winners: spot 8.5 -> 14,
    # nefertiti 24.8 -> 28, parallel scene 56.9 -> 56).
    packed_block_tris: int = 14
    packed_unroll: int = 1  # march steps per while_loop iteration
    # Packed-grid memory layout.  "blocks": cell_info uint32 table +
    # block rows (two gathers per march step).  "inline": each cell's
    # first row carries its header in-row, one gather per step (~17%
    # less march memory floor; costs a dense first-row per cell —
    # accel/packed.PackedGridMeta.inline).  "auto": inline when the
    # table fits the HBM budget, else blocks.
    grid_layout: str = "auto"
    # Scheduler for the packed path.  "tiled": entry-sorted fixed tiles
    # via lax.map (one while_loop per tile).  "persistent": ONE
    # while_loop with a `wave`-lane persistent wavefront — retiring
    # lanes scatter their result and pop the next ray (ops/persistent.py,
    # the dense translation of the CUDA persistent-thread work queue,
    # Parallel/raytracer.cu:177-233).
    scheduler: str = "tiled"
    wave: int = 65536  # persistent-scheduler lane count
    pump: int = 1  # persistent march steps per scatter+refill round
    # Work-queue pop order for the persistent wave's PRIMARY batch:
    # "fifo" = arrival order; "chord" = longest grid-slab chord first
    # (ops/traverse_packed.chord_keys) so the straggler walks start
    # early and overlap everyone else's work instead of serializing at
    # frame end behind a dry queue (the measured occupancy hole:
    # 64.7% on spot, 82.4% on nefertiti under fifo).  Image is
    # bit-identical for any order.
    queue_order: str = "fifo"
    # Cell probes per march step (blocks layout only): lanes that are
    # pure leapers after the combined probe+test phase run up to
    # probe_chain-1 more cell_info probes in the SAME step — 84-87% of
    # a dense rough-shell scene's lane-steps are probe/leap steps
    # (tools/phase_split.py), so an extra dependent gather per step can
    # replace whole steps.  Results are chain-invariant (same cells,
    # same hits; fewer steps).
    probe_chain: int = 1
    # Extra pop attempts per persistent-wave refill for lanes whose
    # popped camera ray fails the entry slab test (ops/persistent):
    # None = the scheduler's auto (3 on the camera-regen path — the
    # spot knee on the previous chip, where ~50% of camera rays miss
    # the tight AABB; 0 on the gather path).  Full-coverage scenes whose camera
    # rays nearly all enter (the dense stand-in) want 0-1: each retry
    # re-runs the camera math for the whole wave.  Bit-identical
    # output for any value.
    refill_retries: "int | None" = None
    # Persistent-wave depth-0 refill source: "on" = regenerate popped
    # camera rays from their pixel index (zero-gather; won when many
    # camera rays die at the grid AABB slab — spot), "off" = gather
    # from the packed (R,8) ray table (won on full-coverage scenes such
    # as the dense stand-in), "auto" = callers
    # that hold a Prepared scene resolve it with the strided slab probe
    # render/metrics.choose_camera_refill; the renderer treats an
    # unresolved "auto" as "on" (the historical default).  Bit-identical
    # image either way (camera_ray_at == the batch generator bitwise).
    camera_refill: str = "auto"
    # Soft-edge visibility scale (0 = reference-exact hard shadows).
    # > 0: shadow attenuation becomes sigmoid(blocker barycentric margin
    # / scale) — differentiable across silhouettes (SURVEY hard part #2).
    soft_visibility: float = 0.0
    # Primary-silhouette softening scale (0 = reference-exact hard
    # edges).  > 0: each hit's color blends toward the background by
    # tanh(hit barycentric margin / scale) — 0 exactly AT the edge, so
    # coverage is CONTINUOUS across a silhouette and a vertex dragging
    # an object edge over a pixel has a finite-difference-checkable
    # gradient (one-sided: only covered pixels contribute).
    soft_primary: float = 0.0
    # Anti-aliasing: spp x spp regular subpixel samples averaged per
    # pixel (1 = reference-exact pixel centers).  No reference
    # counterpart; production feature.
    spp: int = 1
    # Texture sampling on the OBJ's vt data.  The reference parses and
    # carries uvs per triangle but never samples them in shading
    # (Serial/raytracer.cpp:252-283); "checker" completes that plumbing
    # with a procedural checkerboard modulating base_color (x1 / x0.5
    # cells, texture_scale cells per uv unit); "image" samples the
    # scene's (Th,Tw,3) texture_image bilinearly (wrap tiling,
    # texture_scale repeats per uv unit) — a differentiable leaf that
    # fit() can recover from renders.  "none" = reference-exact.
    texture: str = "none"
    texture_scale: float = 8.0
    # Shading normal source: "face" = the variant's geometric facet
    # normal, unnormalized (reference-exact); "smooth" = area-weighted
    # vertex normals interpolated barycentrically at the hit and
    # normalized (Phong normal interpolation) — flat-shaded facets
    # render as smooth surfaces, and reflection bounces follow the
    # smooth normal.  Differentiable w.r.t. vertices.  Production
    # feature (requires faithful=False); no reference counterpart.
    normal_mode: str = "face"
    # Area-light soft shadows: when BOTH shadow_samples > 1 and
    # light_radius > 0, the occlusion factor is the mean over
    # shadow_samples shadow rays aimed at a deterministic Fibonacci-
    # sphere point set of that radius around the light — a penumbra in
    # [0,1] blended like soft visibility.  The fixed sample pattern is
    # shared by every pixel (reproducible on any topology; banding, not
    # noise — no RNG in the render path).  Defaults reproduce the
    # reference's point light exactly.  Production feature (requires
    # faithful=False; forces the non-fused shadow path).  Under SERIAL
    # shading the sampled rays inherit the reference's away-from-light
    # direction quirk (shadow_dir_away_from_light) deliberately: the
    # penumbra then softens the same mirrored shadow the hard serial
    # path casts, so radius -> 0 recovers the hard image; the
    # physically-oriented penumbra is the parallel-shading one.
    shadow_samples: int = 1
    light_radius: float = 0.0
    # Shadow samples traced per wavefront (the gi_sample_batch trick
    # applied to area-light shadows).  Bitwise-invariant — each
    # sample's occlusion is computed and accumulated in the same
    # sequential order either way.  A negative on the previous chip
    # (unlike the GI sample batch): with the sample traversals
    # compacted, separate per-sample waves were faster on the 8-sample
    # 1024^2 penumbra, so the default stays 1.  Not yet measured on
    # the H100.
    shadow_sample_batch: int = 1
    # Path-traced global illumination (render/pathtrace.py — a
    # production feature far beyond the reference's Whitted-style
    # pipeline, built on the same persistent-wave traversal).
    # gi_samples > 0 switches render() to the path integrator:
    # gi_samples paths per pixel, each bouncing up to gi_depth times
    # off Lambertian surfaces (albedo = base_color/255) with
    # cosine-weighted importance sampling, next-event estimation
    # toward the point light(s), and the environment map (or
    # `background`) as escape radiance.  Sampling is DETERMINISTIC
    # (hash of pixel/sample/depth — no RNG state, same image on any
    # topology/scheduler), matching the repo-wide no-RNG convention.
    # Requires faithful=False.
    gi_samples: int = 0
    gi_depth: int = 2
    # Samples traced per wavefront: up to gi_sample_batch samples'
    # lanes ride ONE traversal per depth ((D+1) marches instead of
    # S*(D+1)), amortizing the per-traversal queue sweep and straggler
    # tail.  Bitwise-invariant (sample keys hash the ray and sample,
    # not the batch layout); the knob only trades HBM footprint
    # (gi_sample_batch * W * H lanes of path state) against fixed-cost
    # amortization.
    gi_sample_batch: int = 4
    # Fuse each path vertex's NEE shadow query into its segment's
    # persistent-wave march (the same retire/rearm trick as the Whitted
    # fused_shadow): one fused traversal per (sample, depth) instead of
    # a path traversal plus a separate any-hit shadow traversal.
    # Applies only on the persistent scheduler with exactly ONE point
    # light; other configurations always take the separate-NEE path.
    # Visibility is the same predicate either way (exists an accepted
    # hit along the shadow ray); the shadow ORIGIN differs by ~1 ulp
    # (the march's best_t vs the recomputed differentiable t), which
    # can only matter on knife-edge blocker silhouettes.
    gi_fuse_nee: bool = True
    # Environment-light next-event estimation with balance-heuristic
    # MIS (render/pathtrace.py): each diffuse path vertex also samples
    # ONE direction from the env map's luminance x sin(theta)
    # distribution, shadow-tests it, and weights both that sample and
    # the BSDF-sampled escape term by pdf/(pdf_env + pdf_cos) — small
    # bright env features stop being rare-escape-only events.
    # Opt-in: cosine sampling is already ZERO-variance for constant
    # environments (the furnace tests pin exact equality, which any
    # MIS split necessarily trades for statistical convergence), so
    # this pays off only on concentrated env maps.
    gi_env_nee: bool = False
    # GI treats `reflective` materials (km > 0, the parallel variant's
    # mirror palette, Parallel/raytracer.cu:449-453) as a Lambertian/
    # mirror MIX: at each path vertex a deterministic hash draw picks
    # the mirror branch with probability km (the Whitted blend's
    # km-weight, raytracer.cu:508-520, estimated stochastically), else
    # the diffuse branch.  Branch weights divide by the stop-gradient
    # selection probability, so radiance stays unbiased AND km keeps an
    # exact pathwise gradient (d/d km [km*L_spec + (1-km)*L_diff]).
    # Mirror radiance is UNtinted, matching the reference blend's
    # `recurse * km` term.  km == 0 scenes are bitwise unaffected.
    gi_specular: bool = True
    # Cross-depth GI wave (round 5, ops/gi_wave.py): fold the WHOLE
    # path-traced estimate into one persistent while_loop — a lane pops
    # a pixel and serves primary -> NEE -> bounce -> ... -> next sample
    # in place, sharing the depth-0 hit across samples on Lambertian
    # scenes.  "auto" = use it for eligible forward renders (packed +
    # persistent, one point light, no env map/extra lights/smooth/
    # texture, float32 dets, no reflective km) and fall back to the
    # per-(sample,depth) segment loop otherwise; "on" = require it
    # (error when ineligible); "off" (default) = always the segment
    # loop.  FORWARD-ONLY: the wave is a stop-gradient island --
    # gradient consumers (and pathtrace_rays itself) always use the
    # segment loop.  OFF BY DEFAULT because the wave relaxes ONE
    # documented invariant: its Monte-Carlo draws hash the ray bits
    # its own program computes, so images are deterministic run-to-run
    # but can differ from the segment loop's on silhouette-grazing
    # bounce pixels (last-ulp direction differences flip hit topology
    # there -- the ring grids' boundary-flip class).  On direction-
    # independent scenes the two are exactly equal
    # (tests/test_pathtrace.py); bench.py and `cli --turbo` opt in.
    gi_wave: str = "off"
    # Cross-depth WHITTED wave (round 5, ops/whitted_wave.py): the
    # mirror recursion's twin of gi_wave — one persistent while_loop
    # serves primary -> shadow -> shade -> mirror bounce -> ... per
    # pixel, with the Blinn-Phong vertex shading evaluated in-wave at
    # retirement.  Same contract as gi_wave: "auto" for eligible
    # forward renders (packed+persistent, one point light, face
    # normals, no texture/env/extra lights, no soft shadows/silhouette
    # softening, float32 dets; spp anti-aliasing and thin-lens DoF ARE
    # served — the queue holds subsample items), "on" requires it,
    # "off" (default) keeps the per-depth bounce loop.  Forward-only; images match the bounce
    # loop to float association (the km blend accumulates forward
    # instead of folding deepest-first) — the bit-faithful goldens stay
    # on the default path.  bench.py and `cli --turbo` opt in.
    whitted_wave: str = "off"
    # Packed path: fuse the shadow pass into the primary march (lanes
    # rearm as their own shadow ray on primary retirement) — fewer
    # while-loop instances, shadow work overlaps the primary tail.
    fused_shadow: bool = True
    max_bounces: int = 0  # reflection bounces; parallel reference uses 3
    shadow_eps: float = 1e-1  # Serial/geometry.h:2; parallel uses 1e-4
    shadow_scale: float = 0.1
    background: Vec3 = (0.0, 0.0, 0.0)
    ray_tile: int = 16384  # rays per traversal tile (static-shape chunk)
    dtype: str = "float32"  # compute dtype on device
    det_dtype: str = "float32"  # "float64" on CPU matches oracle bitwise
    grid: GridConfig = field(default_factory=GridConfig)

    # ---- derived hit/shadow policy: the ONE source of truth ------------
    # Consumed by render/renderer.py, render/debug.py, render/metrics.py
    # and the fused march's parameters; deriving these in more than one
    # place twice produced parity bugs (renderer vs trace_pixel gates).

    @property
    def serial_shading(self) -> bool:
        return self.shading == "serial"

    def primary_gate(self):
        """Hit-update gate for primary rays: None = accept ANY t (the
        faithful serial reference counts behind-origin hits,
        Serial/geometry.h:164-171); the CUDA variant gates t > eps
        always (Parallel/geometry.cuh:155-161); the fast serial path
        gates t > 0 (no scene content behind the camera)."""
        if self.serial_shading and self.faithful:
            return None
        return 0.0 if self.serial_shading else self.shadow_eps

    def bounce_gate(self) -> float:
        """Hit-update gate for bounce (depth >= 1) rays: at least eps.
        The traversals consult only the gate for acceptance (rays.mint
        seeds grid entry, not the t test), so without this a reflected
        ray re-accepts its own origin triangle at t ~ 1e-7 under serial
        shading, whose primary gate is 0/None.  (The parallel variant's
        gate is already eps, Parallel/geometry.cuh:155-161.)"""
        pg = self.primary_gate()
        return self.shadow_eps if pg is None else max(pg, self.shadow_eps)

    def shadow_mint(self) -> float:
        """Shadow-ray mint: the serial reference re-enters the grid with
        mint = eps (Serial/geometry.h:2); the CUDA variant offsets by an
        extra 0.02 (Parallel/raytracer.cu:502)."""
        return self.shadow_eps if self.serial_shading else self.shadow_eps + 0.02

    def shadow_dir_away_from_light(self) -> bool:
        """The serial reference points the shadow ray AWAY from the
        light (raytracer.cpp:106 — a quirk reproduced for
        bit-faithfulness); the CUDA variant points toward it."""
        return self.serial_shading

    def accepted_hit(self, res):
        """The per-ray 'counts as a hit' field of a trace result: the
        faithful serial path counts any barycentric pass along the
        walked voxels (any_pass, Serial/geometry.h:162-174); every
        other mode uses the gated nearest hit."""
        return res.any_pass if (self.serial_shading and self.faithful) else res.hit


@dataclass(frozen=True)
class SceneConfig:
    meshes: Tuple[MeshConfig, ...] = ()
    materials: Tuple[MaterialConfig, ...] = (MaterialConfig(),)
    camera: CameraConfig = field(default_factory=CameraConfig)
    light: LightConfig = field(default_factory=LightConfig)
    # Additional point lights (production feature — the reference has
    # exactly one).  Each contributes its own shadow-tested
    # diffuse+specular term; ambient is counted once, riding the
    # primary light's term exactly as the single-light variants do, so
    # () reproduces the reference bitwise.  Differentiable like the
    # primary (Scene.extra_light_pos / _intensity leaves).
    extra_lights: Tuple[LightConfig, ...] = ()
    render: RenderConfig = field(default_factory=RenderConfig)


# ---------------------------------------------------------------------------
# Tuned production knobs
# ---------------------------------------------------------------------------

# The ONE per-scene tuned-knob table, consumed by bench.py AND the CLI's
# --turbo preset so the two cannot diverge (a divergence here shipped
# once: the turbo wave hardcoded 12288 for every scene while bench kept
# per-scene values).  Keys are scene families: "serial" = the sparse
# spot+blub flagship; "nefertiti" = the dense 261k-tri stand-in;
# "parallel" = the CUDA-variant reflective scene.  None = generic
# fallback for unknown/custom scenes.
#
# The values were swept on the previous chip (tools/box_sweep.py and
# the bench) and are carried over unchanged: they are correct on any
# device, but none has been tuned on the H100 yet.
TUNED_KNOBS = {
    # Box leaps made empty cells cheap, which moved the DENSE-scene
    # knee to a 2x finer grid with narrow rows (bt14/rm2.0/128/w4608).
    # wwave: the cross-depth Whitted wave (ops/whitted_wave.py) won on
    # the MIRROR scene (it deletes the per-depth queue sweeps and
    # dead-lane epilogues).  On single-depth scenes the fused persistent
    # march already is one wave, so the wave's per-round vertex-resolve
    # gathers only add cost — off there.
    # gi_pump: the GI wave's own pump knee at the official GI config.
    "serial": dict(block_tris=14, rm=2.0, max_res=128, wave=12288, pump=4,
                   exact=True, wwave=False, gi_pump=6),
    "nefertiti": dict(block_tris=14, rm=2.0, max_res=128, wave=4608, pump=4,
                      exact=True, wwave=False),
    # wwave_pump/wwave_wave: the cross-depth wave's own knee — its
    # per-round transition (vertex resolve + in-wave shading) amortizes
    # over pump march steps, pushing the knee far beyond the plain
    # fused march's
    "parallel": dict(block_tris=14, rm=2.0, max_res=64, wave=8192, pump=4,
                     exact=True, wwave=True, wwave_pump=10,
                     wwave_wave=12288),
    None: dict(block_tris=0, rm=3.0, max_res=64, wave=8192, pump=2,
               exact=True, wwave=False),
}


def apply_turbo(cfg: "SceneConfig", scene_family: "str | None") -> "SceneConfig":
    """The tuned production pipeline: packed block rows + the persistent
    wavefront + auto grid layout + SAT-exact grid insertion, with the
    per-scene knobs from TUNED_KNOBS."""
    import dataclasses

    k = TUNED_KNOBS.get(scene_family, TUNED_KNOBS[None])
    wwave = bool(k.get("wwave"))
    return dataclasses.replace(
        cfg,
        render=dataclasses.replace(
            cfg.render,
            faithful=False, det_dtype="float32",
            traversal="packed", scheduler="persistent",
            gi_wave="auto",  # the tuned pipeline opts into the waves
            whitted_wave="auto" if wwave else "off",
            packed_block_tris=k["block_tris"],
            # the wwave knobs apply only to renders that actually take
            # the Whitted wave (gi_samples > 0 never does)
            wave=(k.get("wwave_wave", k["wave"])
                  if wwave and cfg.render.gi_samples == 0 else k["wave"]),
            pump=(k.get("gi_pump", k["pump"])
                  if cfg.render.gi_samples > 0
                  else (k.get("wwave_pump", k["pump"]) if wwave
                        else k["pump"])),
            # only override when the knob table actually records a
            # value — otherwise an explicit user refill_retries would
            # be silently reset to auto
            **({"refill_retries": k["retries"]} if "retries" in k else {}),
            grid_layout="auto",
            grid=dataclasses.replace(
                cfg.render.grid,
                resolution_multiplier=k["rm"],
                max_resolution=k["max_res"],
                exact_overlap=k["exact"],
            ),
        ),
    )


# ---------------------------------------------------------------------------
# JSON round-trip
# ---------------------------------------------------------------------------

_CONFIG_TYPES = {
    "camera": CameraConfig,
    "light": LightConfig,
    "render": RenderConfig,
    "grid": GridConfig,
}


def _to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_jsonable(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(x) for x in obj]
    return obj


def _from_dict(cls, data: Dict[str, Any]):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        val = data[f.name]
        if f.name == "meshes":
            val = tuple(_from_dict(MeshConfig, m) for m in val)
        elif f.name == "materials":
            val = tuple(_from_dict(MaterialConfig, m) for m in val)
        elif f.name == "extra_lights":
            val = tuple(_from_dict(LightConfig, m) for m in val)
        elif f.name in _CONFIG_TYPES and isinstance(val, dict):
            val = _from_dict(_CONFIG_TYPES[f.name], val)
        elif isinstance(val, list):
            val = tuple(val)
        kwargs[f.name] = val
    return cls(**kwargs)


def save_scene_config(cfg: SceneConfig, path: str) -> None:
    with open(path, "w") as fh:
        json.dump(_to_jsonable(cfg), fh, indent=2)


def load_scene_config(path: str) -> SceneConfig:
    with open(path) as fh:
        return _from_dict(SceneConfig, json.load(fh))
