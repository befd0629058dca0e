"""ctypes bindings to the native host runtime (native/libraytpu.so).

The framework works without the native library (numpy fallbacks are the
correctness references); when built (`make -C native`), OBJ parsing and
grid construction run in C++ — the counterpart of the
reference's native host components (OBJ loader Serial/raytracer.cpp:220-287,
two-pass grid build Parallel/grid.cuh:137-207).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from ray_tracer_tpu.io.obj import MeshArrays

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "native"
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libraytpu.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False

_c_double_p = ctypes.POINTER(ctypes.c_double)
_c_float_p = ctypes.POINTER(ctypes.c_float)
_c_int32_p = ctypes.POINTER(ctypes.c_int32)
_c_int64_p = ctypes.POINTER(ctypes.c_int64)


def ensure_built(timeout: int = 300) -> bool:
    """Build (or freshen) the native library. Returns True if available.

    Always runs make — a no-op when build/ is newer than the sources,
    and the rebuild path for a stale pre-v2 libraytpu.so (which _load
    rejects so the numpy fallback stays correct)."""
    global _lib_failed
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR, "-j4"],
            check=True,
            capture_output=True,
            timeout=timeout,
        )
    except Exception:
        return False
    ok = os.path.exists(_LIB_PATH)
    if ok:
        # a probe before the build latched "failed"; the library exists
        # now, so let the next _load() try again
        with _lock:
            _lib_failed = False
    return ok


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        if not os.path.exists(_LIB_PATH):
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            # corrupt / wrong-arch build: report "unavailable" (callers
            # fall back to numpy) instead of raising on every probe
            _lib_failed = True
            return None
        lib.rtpu_obj_load.restype = ctypes.c_void_p
        lib.rtpu_obj_load.argtypes = [ctypes.c_char_p]
        lib.rtpu_obj_num_verts.restype = ctypes.c_long
        lib.rtpu_obj_num_verts.argtypes = [ctypes.c_void_p]
        lib.rtpu_obj_num_faces.restype = ctypes.c_long
        lib.rtpu_obj_num_faces.argtypes = [ctypes.c_void_p]
        lib.rtpu_obj_num_uvs.restype = ctypes.c_long
        lib.rtpu_obj_num_uvs.argtypes = [ctypes.c_void_p]
        lib.rtpu_obj_fill.restype = None
        lib.rtpu_obj_fill.argtypes = [ctypes.c_void_p, _c_double_p, _c_int32_p, _c_float_p, _c_int32_p]
        lib.rtpu_obj_free.restype = None
        lib.rtpu_obj_free.argtypes = [ctypes.c_void_p]

        # probe the v2 symbol (SAT exact insertion): a stale pre-exact
        # build would silently ignore the `exact` argument, so treat it
        # as unavailable and let callers fall back to numpy
        if not hasattr(lib, "rtpu_grid_build_v2"):
            _lib_failed = True
            return None
        lib.rtpu_grid_build_v2.restype = ctypes.c_void_p
        lib.rtpu_grid_build_v2.argtypes = [_c_float_p, ctypes.c_long, _c_int32_p, ctypes.c_long, ctypes.c_float, ctypes.c_int, ctypes.c_int]
        lib.rtpu_grid_dims.restype = None
        lib.rtpu_grid_dims.argtypes = [ctypes.c_void_p, _c_int32_p, _c_float_p, _c_float_p, _c_float_p, _c_float_p, _c_int64_p]
        lib.rtpu_grid_fill.restype = None
        lib.rtpu_grid_fill.argtypes = [ctypes.c_void_p, _c_int64_p, _c_int32_p]
        lib.rtpu_grid_free.restype = None
        lib.rtpu_grid_free.argtypes = [ctypes.c_void_p]
        if hasattr(lib, "rtpu_empty_boxes"):  # round-4 symbol; optional
            lib.rtpu_empty_boxes.restype = None
            lib.rtpu_empty_boxes.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_long, ctypes.c_long,
                ctypes.c_long, ctypes.c_int, _c_int32_p,
            ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def load_obj_native(path: str) -> MeshArrays:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built (run `make -C native`)")
    handle = lib.rtpu_obj_load(path.encode())
    if not handle:
        raise FileNotFoundError(path)
    try:
        nv = lib.rtpu_obj_num_verts(handle)
        nf = lib.rtpu_obj_num_faces(handle)
        nvt = lib.rtpu_obj_num_uvs(handle)
        verts = np.empty((nv, 3), dtype=np.float64)
        faces = np.empty((nf, 3), dtype=np.int32)
        uvs = np.empty((max(nvt, 0), 2), dtype=np.float32)
        uv_faces = np.empty((nf, 3), dtype=np.int32)
        lib.rtpu_obj_fill(
            handle,
            _ptr(verts, ctypes.c_double),
            _ptr(faces, ctypes.c_int32),
            _ptr(uvs, ctypes.c_float) if nvt else None,
            _ptr(uv_faces, ctypes.c_int32),
        )
    finally:
        lib.rtpu_obj_free(handle)
    if nvt == 0 or (uv_faces < 0).all():
        uvs = np.zeros((0, 2), dtype=np.float32)
        uv_faces = np.zeros((0, 3), dtype=np.int32)
    return MeshArrays(verts, faces, uvs, uv_faces)


def empty_boxes_native(occupied: np.ndarray, cap: int) -> Optional[np.ndarray]:
    """Native greedy maximal empty boxes: (nz,ny,nx) bool -> (6,nz,ny,nx)
    int32, bitwise-identical to accel/packed.greedy_empty_boxes' numpy
    reference (per-cell growth is occupancy-only, so the lock-step
    round-robin and the native per-cell round-robin coincide).  None if
    the library (or the round-4 symbol) is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "rtpu_empty_boxes"):
        return None
    occ = np.ascontiguousarray(occupied, dtype=np.uint8)
    nz, ny, nx = occ.shape
    ext = np.empty((6, nz, ny, nx), dtype=np.int32)
    lib.rtpu_empty_boxes(
        _ptr(occ, ctypes.c_uint8), nx, ny, nz, ctypes.c_int(cap),
        _ptr(ext, ctypes.c_int32),
    )
    return ext


def build_grid_native(
    verts: np.ndarray,
    faces: np.ndarray,
    resolution_multiplier: float,
    max_resolution: int,
    exact_overlap: bool = False,
) -> Optional[Tuple[np.ndarray, ...]]:
    """Returns (n3, lower, upper, width, inv_width, cell_start, tri_ids) or None."""
    lib = _load()
    if lib is None:
        return None
    verts = np.ascontiguousarray(verts, dtype=np.float32)
    faces = np.ascontiguousarray(faces, dtype=np.int32)
    handle = lib.rtpu_grid_build_v2(
        _ptr(verts, ctypes.c_float),
        verts.shape[0],
        _ptr(faces, ctypes.c_int32),
        faces.shape[0],
        ctypes.c_float(resolution_multiplier),
        ctypes.c_int(max_resolution),
        ctypes.c_int(1 if exact_overlap else 0),
    )
    if not handle:  # allocation failure inside the builder
        return None
    try:
        n3 = np.empty(3, dtype=np.int32)
        lower = np.empty(3, dtype=np.float32)
        upper = np.empty(3, dtype=np.float32)
        width = np.empty(3, dtype=np.float32)
        inv_width = np.empty(3, dtype=np.float32)
        nnz = np.empty(1, dtype=np.int64)
        lib.rtpu_grid_dims(
            handle,
            _ptr(n3, ctypes.c_int32), _ptr(lower, ctypes.c_float),
            _ptr(upper, ctypes.c_float), _ptr(width, ctypes.c_float),
            _ptr(inv_width, ctypes.c_float), _ptr(nnz, ctypes.c_int64),
        )
        total = int(n3[0]) * int(n3[1]) * int(n3[2])
        cell_start = np.empty(total + 1, dtype=np.int64)
        tri_ids = np.empty(max(int(nnz[0]), 1), dtype=np.int32)
        lib.rtpu_grid_fill(handle, _ptr(cell_start, ctypes.c_int64), _ptr(tri_ids, ctypes.c_int32))
        tri_ids = tri_ids[: int(nnz[0])]
    finally:
        lib.rtpu_grid_free(handle)
    return n3, lower, upper, width, inv_width, cell_start, tri_ids
