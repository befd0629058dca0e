"""Scene representation and the reference scene definitions.

A Scene is one pytree of dense device arrays — the dense counterpart
of the reference's `std::vector<Triangle*>` heap soup
(Serial/raytracer.cpp:193-196).  Geometry stays indexed (verts + faces)
rather than flattened per-triangle so that vertex gradients aggregate
across shared vertices, and materials live in a gatherable table.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from ray_tracer_tpu.config import (
    CameraConfig,
    LightConfig,
    MaterialConfig,
    MeshConfig,
    RenderConfig,
    SceneConfig,
)
from ray_tracer_tpu.io.obj import MeshArrays, load_obj
from ray_tracer_tpu.models import meshes as mesh_gen
from ray_tracer_tpu.models.materials import (
    PARALLEL_REFERENCE_MATERIALS,
    SERIAL_REFERENCE_MATERIAL,
    MaterialTable,
)

ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "assets")

# Host mirrors of device geometry, keyed by id() of the device verts
# array with a weakref finalizer for cleanup: prepare() and grid
# rebuilds consult this instead of pulling arrays back off the device.
import weakref

_HOST_GEOMETRY: dict = {}


def _register_host_geometry(device_verts, device_faces, verts_np,
                            faces_np) -> None:
    # keyed by BOTH arrays: a scene._replace(faces=...) keeps the verts
    # object, and a verts-only key would serve the stale face list to
    # the grid builder (deleted triangles still rendering)
    key = (id(device_verts), id(device_faces))
    _HOST_GEOMETRY[key] = (verts_np, faces_np)
    try:
        weakref.finalize(device_verts, _HOST_GEOMETRY.pop, key, None)
    except TypeError:
        # Not weak-referenceable: a permanent id()-keyed entry could be
        # silently served for a DIFFERENT later array that recycles the
        # same id().  Don't cache at all — host_geometry falls back to a
        # device pull for such arrays.
        _HOST_GEOMETRY.pop(key, None)


def host_geometry(scene: "Scene"):
    """-> (verts_np, faces_np) host mirror, pulling from device only if
    the scene was built outside this module (or its topology was
    replaced since)."""
    cached = _HOST_GEOMETRY.get((id(scene.verts), id(scene.faces)))
    if cached is not None:
        return cached
    return np.asarray(scene.verts), np.asarray(scene.faces)


def asset(name: str) -> str:
    return os.path.join(ASSET_DIR, name)


class Scene(NamedTuple):
    """Differentiable scene parameters + static topology.

    verts/materials/light_* are differentiable leaves; faces and
    face_material are integer topology.  uvs/uv_faces carry the OBJ's
    `vt` data (the reference parses and stores it per triangle,
    Serial/raytracer.cpp:252-283, but never samples it in shading —
    kept here for the same parity and for texture extensions;
    `interpolate_uv` maps hits to uv space).  None when absent.
    """

    verts: jnp.ndarray  # (V,3) f32
    faces: jnp.ndarray  # (F,3) i32
    face_material: jnp.ndarray  # (F,) i32
    materials: MaterialTable
    light_pos: jnp.ndarray  # (3,)
    light_intensity: jnp.ndarray  # ()
    uvs: Optional[jnp.ndarray] = None  # (VT,2) f32
    uv_faces: Optional[jnp.ndarray] = None  # (F,3) i32, -1 where absent
    # Optional (Th,Tw,3) f32 texel grid in [0,1], sampled bilinearly at
    # the carried uvs when cfg.render.texture == "image".  A
    # differentiable leaf: fit() can recover it from renders
    # (trainable=("texture_image",)).
    texture_image: Optional[jnp.ndarray] = None
    # Additional point lights (SceneConfig.extra_lights) —
    # differentiable leaves like the primary light_pos/_intensity.
    # None = the reference's single light.
    extra_light_pos: Optional[jnp.ndarray] = None  # (L,3)
    extra_light_intensity: Optional[jnp.ndarray] = None  # (L,)
    # Optional (Eh,Ew,3) f32 lat-long environment map in COLOR units
    # (0..255 linear, like material base colors): miss lanes sample it
    # by ray direction instead of the constant rcfg.background, at
    # every bounce depth.  A differentiable leaf (fit can recover it).
    # None = constant background (reference-exact).
    env_image: Optional[jnp.ndarray] = None
    # Optional per-material dielectric (glass) data
    # (MaterialConfig.transmissive/ior): (M,) flags + (M,) indices of
    # refraction.  Consumed ONLY by the path-traced GI integrator
    # (render/pathtrace.py — exact Fresnel reflect/refract); the
    # Whitted paths raise on transmissive scenes.  `ior` is a
    # differentiable leaf (d radiance / d ior flows through the
    # Fresnel weights).  None = no dielectrics: every existing path
    # is unchanged.
    transmissive: Optional[jnp.ndarray] = None  # (M,) bool
    ior: Optional[jnp.ndarray] = None  # (M,) f32

    def sample_texture(self, uv: jnp.ndarray) -> jnp.ndarray:
        """Bilinear wrap-mode sample: (R,2) uv -> (R,3) rgb in [0,1]
        (sample_texture_image on this scene's texture)."""
        if self.texture_image is None:
            raise ValueError("scene has no texture_image")
        return sample_texture_image(self.texture_image, uv)

    def sample_env(self, dirn: jnp.ndarray) -> jnp.ndarray:
        """Lat-long (equirectangular) environment lookup: (R,3) unit
        directions -> (R,3) color.  u = azimuth around +y (wraps),
        v = polar angle from +y (clamped at the pole rows).  Bilinear;
        differentiable in the texel grid (through the gathers) and in
        the direction (through the weights).  A CONSTANT map returns
        that constant exactly (all bilinear deltas are zero), so it
        degenerates to the constant-background path bitwise."""
        if self.env_image is None:
            raise ValueError("scene has no env_image")
        return sample_env_image(self.env_image, dirn)

    def interpolate_uv(self, tri: jnp.ndarray, beta: jnp.ndarray,
                       gamma: jnp.ndarray) -> jnp.ndarray:
        """Barycentric uv at hits: (R,) tri ids + (R,) beta/gamma -> (R,2)."""
        if self.uvs is None or self.uv_faces is None:
            raise ValueError("scene has no uv data")
        f = jnp.maximum(self.uv_faces[tri], 0)  # (R,3)
        u0, u1, u2 = self.uvs[f[:, 0]], self.uvs[f[:, 1]], self.uvs[f[:, 2]]
        alpha = 1.0 - beta - gamma
        return alpha[:, None] * u0 + beta[:, None] * u1 + gamma[:, None] * u2

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]

    def triangle_soa(self) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """Gathered per-triangle vertices (F,3) x3 — gradients flow to verts."""
        return (
            self.verts[self.faces[:, 0]],
            self.verts[self.faces[:, 1]],
            self.verts[self.faces[:, 2]],
        )


def sample_texture_image(tex: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Bilinear wrap-mode sample of an (H,W,3) texture at (R,2) uv ->
    (R,3).  v follows OBJ convention (v=0 is the image BOTTOM row);
    texels are centered at (i+0.5)/size; coordinates wrap (repeat
    tiling).  Differentiable in uv (through the bilinear weights) and
    in the texel grid (through the four gathers).  Standalone so the
    ring-sharded renderer (which has no Scene object inside shard_map)
    samples with bit-identical arithmetic."""
    th, tw = tex.shape[0], tex.shape[1]
    u = uv[:, 0] * tw - 0.5
    v = (1.0 - uv[:, 1]) * th - 0.5
    u0f, v0f = jnp.floor(u), jnp.floor(v)
    fu, fv = u - u0f, v - v0f
    iu0 = jnp.mod(u0f.astype(jnp.int32), tw)
    iv0 = jnp.mod(v0f.astype(jnp.int32), th)
    iu1 = jnp.mod(iu0 + 1, tw)
    iv1 = jnp.mod(iv0 + 1, th)
    c00, c01 = tex[iv0, iu0], tex[iv0, iu1]
    c10, c11 = tex[iv1, iu0], tex[iv1, iu1]
    top = c00 + (c01 - c00) * fu[:, None]
    bot = c10 + (c11 - c10) * fu[:, None]
    return top + (bot - top) * fv[:, None]


def texture_factor(uv, has_uv, hit, mode: str, scale, tex_image,
                   rgb_dtype):
    """The ONE texture-factor expression (checker pattern / bilinear
    image sample gated by has-uv-and-hit), shared by the Whitted
    epilogue, the segment integrator, the ring shade and the GI wave —
    their bitwise-parity contracts depend on these never drifting.
    Returns the (R,1) or (R,3) factor that multiplies base_color."""
    n = jnp.asarray(scale, uv.dtype)
    if mode == "checker":
        checker = (jnp.floor(uv[:, 0] * n) + jnp.floor(uv[:, 1] * n)) % 2.0
        return jnp.where(has_uv & hit, 1.0 - 0.5 * checker, 1.0)[:, None]
    if mode == "image":
        if tex_image is None:
            raise ValueError(
                'cfg.render.texture == "image" but the scene has '
                "no texture_image"
            )
        uv_s = jnp.where(hit[:, None], uv, jnp.zeros_like(uv)) * n
        rgb = sample_texture_image(tex_image, uv_s).astype(rgb_dtype)
        return jnp.where((has_uv & hit)[:, None], rgb, jnp.ones_like(rgb))
    raise ValueError(f"unknown texture mode {mode!r}")


def sample_env_image(env: jnp.ndarray, dirn: jnp.ndarray) -> jnp.ndarray:
    """Lat-long (equirectangular) environment lookup: (R,3) unit
    directions -> (R,3) color.  u = azimuth around +y (wraps),
    v = polar angle from +y (clamped at the pole rows).  Bilinear;
    differentiable in the texel grid (through the gathers) and in
    the direction (through the weights).  A CONSTANT map returns
    that constant exactly (all bilinear deltas are zero), so it
    degenerates to the constant-background path bitwise."""
    th, tw = env.shape[0], env.shape[1]
    u = jnp.arctan2(dirn[:, 2], dirn[:, 0]) / (2.0 * jnp.pi) + 0.5
    v = jnp.arccos(jnp.clip(dirn[:, 1], -1.0, 1.0)) / jnp.pi
    uu = u * tw - 0.5
    # polar coordinate clamps at the pole texel CENTERS so the
    # exact poles sample their row fully (no blend past the edge)
    vv = jnp.clip(v * th - 0.5, 0.0, th - 1.0)
    u0f, v0f = jnp.floor(uu), jnp.floor(vv)
    fu, fv = uu - u0f, vv - v0f
    iu0 = jnp.mod(u0f.astype(jnp.int32), tw)
    iu1 = jnp.mod(iu0 + 1, tw)
    iv0 = jnp.clip(v0f.astype(jnp.int32), 0, th - 1)
    iv1 = jnp.clip(iv0 + 1, 0, th - 1)
    c00, c01 = env[iv0, iu0], env[iv0, iu1]
    c10, c11 = env[iv1, iu0], env[iv1, iu1]
    top = c00 + (c01 - c00) * fu[:, None]
    bot = c10 + (c11 - c10) * fu[:, None]
    return top + (bot - top) * fv[:, None]


def concat_mesh_arrays(
    parts: Sequence[Tuple[MeshArrays, int]],
):
    """Host-side concat -> (verts (V,3) f32, faces (F,3) i32, fmat (F,) i32,
    uvs (VT,2) f32, uv_faces (F,3) i32 with -1 for faces without vt).

    Kept in numpy so host consumers (grid build, packing) never round-trip
    through the device.
    """
    if not parts:
        raise ValueError(
            "no meshes to concatenate: this SceneConfig is not "
            "self-describing (procedural scenes like gradcheck/nefertiti "
            "carry their geometry in the Scene object — pass scene= to "
            "prepare())"
        )
    all_verts = []
    all_faces = []
    all_fmat = []
    all_uvs = []
    all_uvf = []
    voffset = 0
    uvoffset = 0
    for mesh, midx in parts:
        nf = mesh.faces.shape[0]
        all_verts.append(mesh.verts)
        all_faces.append(mesh.faces + voffset)
        all_fmat.append(np.full((nf,), midx, dtype=np.int32))
        if mesh.uvs.size and mesh.uv_faces.size:
            all_uvs.append(mesh.uvs)
            # -1 rows mark faces without vt (partially-textured mesh)
            # and must not be shifted into valid range by the offset
            all_uvf.append(
                np.where(mesh.uv_faces >= 0, mesh.uv_faces + uvoffset, -1)
            )
            uvoffset += mesh.uvs.shape[0]
        else:
            all_uvf.append(np.full((nf, 3), -1, dtype=np.int32))
        voffset += mesh.verts.shape[0]
    uvs = (np.concatenate(all_uvs, axis=0).astype(np.float32)
           if all_uvs else np.zeros((1, 2), np.float32))
    return (
        np.concatenate(all_verts, axis=0).astype(np.float32),
        np.concatenate(all_faces, axis=0).astype(np.int32),
        np.concatenate(all_fmat, axis=0),
        uvs,
        np.concatenate(all_uvf, axis=0).astype(np.int32),
    )


def scene_from_numpy(
    verts: np.ndarray,
    faces: np.ndarray,
    fmat: np.ndarray,
    materials: Sequence[MaterialConfig],
    light: LightConfig,
    uvs: Optional[np.ndarray] = None,
    uv_faces: Optional[np.ndarray] = None,
    dtype=jnp.float32,
    extra_lights: Sequence[LightConfig] = (),
) -> Scene:
    scene = Scene(
        verts=jnp.asarray(verts, dtype=dtype),
        faces=jnp.asarray(faces),
        face_material=jnp.asarray(fmat),
        materials=MaterialTable.from_configs(materials, dtype=dtype),
        light_pos=jnp.asarray(light.position, dtype=dtype),
        light_intensity=jnp.asarray(light.intensity, dtype=dtype),
        uvs=jnp.asarray(uvs, dtype=dtype) if uvs is not None else None,
        uv_faces=jnp.asarray(uv_faces) if uv_faces is not None else None,
        extra_light_pos=(jnp.asarray([l.position for l in extra_lights], dtype)
                         if extra_lights else None),
        extra_light_intensity=(
            jnp.asarray([l.intensity for l in extra_lights], dtype)
            if extra_lights else None),
        # dielectric tables only materialize when some material asks —
        # all-default configs keep the exact pre-existing pytree
        transmissive=(jnp.asarray([m.transmissive for m in materials],
                                  dtype=bool)
                      if any(m.transmissive for m in materials) else None),
        ior=(jnp.asarray([m.ior for m in materials], dtype=dtype)
             if any(m.transmissive for m in materials) else None),
    )
    _register_host_geometry(
        scene.verts,
        scene.faces,
        # the mirror matches the DEVICE dtype: an f32 mirror for an f64
        # scene would bin triangles into cells that may not cover their
        # true (device) extent
        np.asarray(verts, dtype=np.dtype(dtype)),
        np.asarray(faces, dtype=np.int32),
    )
    return scene


def scene_from_meshes(
    parts: Sequence[Tuple[MeshArrays, int]],
    materials: Sequence[MaterialConfig],
    light: LightConfig,
    dtype=jnp.float32,
    extra_lights: Sequence[LightConfig] = (),
) -> Scene:
    """Concatenate (mesh, material_index) parts into one Scene."""
    verts, faces, fmat, uvs, uvf = concat_mesh_arrays(parts)
    return scene_from_numpy(
        verts, faces, fmat, materials, light, uvs, uvf, dtype=dtype,
        extra_lights=extra_lights,
    )


def scene_numpy_arrays(cfg: SceneConfig):
    """Load cfg.meshes and return host numpy arrays
    (verts, faces, fmat, uvs, uv_faces)."""
    parts = []
    for m in cfg.meshes:
        mesh = load_obj(m.path, offset=m.offset, scale=m.scale)
        parts.append((mesh, m.material_index))
    return concat_mesh_arrays(parts)


def build_scene(cfg: SceneConfig, dtype=jnp.float32) -> Scene:
    verts, faces, fmat, uvs, uvf = scene_numpy_arrays(cfg)
    return scene_from_numpy(
        verts, faces, fmat, cfg.materials, cfg.light, uvs, uvf, dtype=dtype,
        extra_lights=cfg.extra_lights,
    )


# ---------------------------------------------------------------------------
# Reference scenes
# ---------------------------------------------------------------------------


def serial_scene_config(width: int = 512, height: int = 512) -> SceneConfig:
    """The serial reference's hard-coded scene (Serial/raytracer.cpp:191-200):
    spot + blub offset (1.5,0,0), red, 512x512, camera (3,5,3) fov 45,
    light (5,-5,2) intensity 255."""
    return SceneConfig(
        meshes=(
            MeshConfig(path=asset("spot_triangulated.obj"), material_index=0),
            MeshConfig(path=asset("blub_triangulated.obj"), material_index=0, offset=(1.5, 0.0, 0.0)),
        ),
        materials=(SERIAL_REFERENCE_MATERIAL,),
        camera=CameraConfig(position=(3, 5, 3), target=(0, 0, 0), up=(0, -1, 0), fov_degrees=45.0, width=width, height=height),
        light=LightConfig(position=(5, -5, 2), intensity=255.0),
        render=RenderConfig(shading="serial", faithful=True, max_bounces=0, shadow_eps=1e-1, shadow_scale=0.1),
    )


def parallel_scene_config(width: int = 64, height: int = 64) -> SceneConfig:
    """The parallel reference's hard-coded scene (Parallel/raytracer.cu:769-786):
    plane(mat0, +0.4y, x3) + blub(mat1, -2x, x5) + spot(mat1, x5) +
    blub(mat3, +2x, x5); camera (18,18,19) fov 60; light (2,5,0)."""
    return SceneConfig(
        meshes=(
            MeshConfig(path=asset("plane.obj"), material_index=0, offset=(0.0, 0.4, 0.0), scale=3.0),
            MeshConfig(path=asset("blub_triangulated.obj"), material_index=1, offset=(-2.0, 0.0, 0.0), scale=5.0),
            MeshConfig(path=asset("spot_triangulated.obj"), material_index=1, scale=5.0),
            MeshConfig(path=asset("blub_triangulated.obj"), material_index=3, offset=(2.0, 0.0, 0.0), scale=5.0),
        ),
        materials=PARALLEL_REFERENCE_MATERIALS,
        camera=CameraConfig(position=(18, 18, 19), target=(0, 0, 0), up=(0, -1, 0), fov_degrees=60.0, width=width, height=height),
        light=LightConfig(position=(2, 5, 0), intensity=1.0),
        render=RenderConfig(shading="parallel", faithful=False, max_bounces=3, shadow_eps=1e-4, shadow_scale=0.5),
    )


def serial_scene(width: int = 512, height: int = 512, dtype=jnp.float32):
    cfg = serial_scene_config(width, height)
    return build_scene(cfg, dtype=dtype), cfg


def parallel_scene(width: int = 64, height: int = 64, dtype=jnp.float32):
    cfg = parallel_scene_config(width, height)
    return build_scene(cfg, dtype=dtype), cfg


def gradcheck_scene(width: int = 64, height: int = 64, dtype=jnp.float32):
    """BASELINE config 2: plane + spheres, shadow rays — the flat scene
    used for finite-difference gradient checks."""
    plane = mesh_gen.make_plane(extent=8.0, y=-1.0, density=2)
    sphere_a = mesh_gen.make_uv_sphere(center=(0.0, 0.2, 0.0), radius=0.8, n_lat=12, n_lon=18)
    sphere_b = mesh_gen.make_uv_sphere(center=(1.6, 0.0, 0.8), radius=0.5, n_lat=10, n_lon=14)
    materials = (
        MaterialConfig(base_color=(90.0, 90.0, 220.0), kd=2.0, ks=4.0, spec_alpha=4.0, ka=0.2),
        MaterialConfig(base_color=(220.0, 60.0, 60.0), kd=2.0, ks=4.0, spec_alpha=4.0, ka=0.2),
    )
    light = LightConfig(position=(4.0, 6.0, 2.0), intensity=1.0)
    scene = scene_from_meshes(
        [(plane, 0), (sphere_a, 1), (sphere_b, 1)], materials, light, dtype=dtype
    )
    cfg = SceneConfig(
        materials=materials,
        camera=CameraConfig(position=(3.0, 3.0, 4.0), target=(0, 0, 0), up=(0, 1, 0), fov_degrees=45.0, width=width, height=height),
        light=light,
        render=RenderConfig(shading="parallel", faithful=False, max_bounces=0, shadow_eps=1e-3, shadow_scale=0.5),
    )
    return scene, cfg


def flagship_scene(width: int = 1024, height: int = 1024, dtype=jnp.float32):
    """BASELINE config 3 / primary benchmark: spot at 1024x1024,
    grid traversal, primary + shadow rays."""
    return serial_scene(width, height, dtype=dtype)


def nefertiti_scene(
    width: int = 1024,
    height: int = 1024,
    n_lat: int = 256,
    n_lon: int = 512,
    with_spot: bool = False,
    dtype=jnp.float32,
):
    """BASELINE configs 4-5 workload.  The reference's `nefertiti` scan
    was stripped from its repo (.MISSING_LARGE_BLOBS, SURVEY.md #22), so
    a deterministic displaced sphere of comparable size (~260k faces at
    the default resolution) stands in.  with_spot=True adds the spot
    mesh beside it (config 5's two-mesh 2048x2048 scene)."""
    bust = mesh_gen.make_displaced_sphere(n_lat=n_lat, n_lon=n_lon, radius=1.2)
    parts = [(bust, 0)]
    if with_spot:
        spot = load_obj(asset("spot_triangulated.obj"), offset=(2.6, 0.0, 0.0))
        parts.append((spot, 1))
    materials = (
        MaterialConfig(base_color=(210.0, 180.0, 140.0), kd=2.0, ks=4.0,
                       spec_alpha=6.0, ka=0.2),
        MaterialConfig(base_color=(200.0, 60.0, 60.0), kd=2.0, ks=4.0,
                       spec_alpha=4.0, ka=0.2),
    )
    light = LightConfig(position=(4.0, 5.0, 3.0), intensity=1.0)
    scene = scene_from_meshes(parts, materials, light, dtype=dtype)
    cfg = SceneConfig(
        materials=materials,
        camera=CameraConfig(position=(0.0, 1.5, 4.5), target=(0.8 if with_spot else 0.0, 0, 0),
                            up=(0, 1, 0), fov_degrees=45.0, width=width, height=height),
        light=light,
        render=RenderConfig(
            shading="parallel", faithful=False, traversal="packed",
            max_bounces=0, shadow_eps=1e-3, shadow_scale=0.5, ray_tile=512,
        ),
    )
    return scene, cfg
