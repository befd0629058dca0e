"""Wavefront OBJ loading into flat SoA arrays.

Array counterpart of the reference's load_mesh
(Serial/raytracer.cpp:220-287, Parallel/raytracer.cu:805-873): the same
subset of OBJ (`v`, `vt`, `f v/vt v/vt v/vt`), 1-based indices, per-mesh
offset and scale applied as scale * (coord + offset) in double precision
before narrowing to float32 — but producing dense numpy arrays
(verts (V,3) f32, faces (F,3) i32, uvs, uv_faces) instead of one heap
object per triangle.

A C++ fast path (native/raytpu_native.cc) is used when the shared
library has been built; the numpy parser is the always-available
fallback and the correctness reference for it.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import numpy as np


class MeshArrays(NamedTuple):
    verts: np.ndarray  # (V,3) float32
    faces: np.ndarray  # (F,3) int32, 0-based
    uvs: np.ndarray  # (VT,2) float32 (may be empty)
    uv_faces: np.ndarray  # (F,3) int32, 0-based (may be empty)

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]


def _parse_obj_numpy(path: str) -> MeshArrays:
    verts = []
    uvs = []
    faces = []
    uv_faces = []
    with open(path, "r") as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif line.startswith("vt "):
                parts = line.split()
                uvs.append((float(parts[1]), float(parts[2])))
            elif line.startswith("f "):
                parts = line.split()[1:4]
                vi = []
                ti = []
                uv_ok = True
                for p in parts:
                    comps = p.split("/")
                    iv = int(comps[0])
                    # OBJ negative indices are relative to the count of
                    # elements defined SO FAR (-1 = most recent); store
                    # 1-based so the uniform -1 shift below applies
                    vi.append(iv if iv > 0 else len(verts) + iv + 1)
                    if len(comps) > 1 and comps[1]:
                        it = int(comps[1])
                        if it == 0:
                            # an explicit vt index of 0 is invalid OBJ:
                            # treat the face as untextured (the native
                            # loader maps vt==0 to -1) instead of
                            # pointing one past the uv table
                            uv_ok = False
                        else:
                            ti.append(it if it > 0 else len(uvs) + it + 1)
                faces.append(vi)
                # one row PER face so uv_faces stays index-aligned with
                # faces (0 here -> -1 after the 1-based shift below ->
                # "no uv", matching the native loader's -1-if-absent)
                uv_faces.append(ti if (uv_ok and len(ti) == 3) else [0, 0, 0])
    v = np.asarray(verts, dtype=np.float64).reshape(-1, 3)
    f = np.asarray(faces, dtype=np.int32).reshape(-1, 3) - 1
    vt = np.asarray(uvs, dtype=np.float32).reshape(-1, 2)
    fvt = np.asarray(uv_faces, dtype=np.int32).reshape(-1, 3) - 1
    if fvt.size == 0 or (fvt < 0).all():
        # untextured mesh (or no faces at all): drop BOTH tables, like
        # accel/native.py — consumers branch on uvs.size/uv_faces.size
        vt = np.zeros((0, 2), dtype=np.float32)
        fvt = np.zeros((0, 3), dtype=np.int32)
    return MeshArrays(v, f, vt, fvt)


def load_obj(
    path: str,
    offset: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    scale: float = 1.0,
    use_native: Optional[bool] = None,
) -> MeshArrays:
    """Load an OBJ; vertex transform matches the reference exactly:
    scale * (coord + offset) computed in float64 then cast to float32
    (Parallel/raytracer.cu:824; Serial applies offset only, i.e. scale=1,
    Serial/raytracer.cpp:239)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)

    mesh = None
    if use_native is not False:
        try:
            from ray_tracer_tpu.accel import native

            mesh = native.load_obj_native(path)
        except Exception:
            if use_native is True:
                raise
            mesh = None
    if mesh is None:
        mesh = _parse_obj_numpy(path)

    off = np.asarray(offset, dtype=np.float64)
    v = (float(scale) * (mesh.verts.astype(np.float64) + off)).astype(np.float32)
    return MeshArrays(v, mesh.faces, mesh.uvs, mesh.uv_faces)
