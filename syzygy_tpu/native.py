"""ctypes bindings for the C++ host-engine core (native/szg_native.cpp).

The library is built from ``native/szg_native.cpp`` with ``make`` on first
use, into ``native/build/`` (not committed); every entry point has a numpy
fallback so the package works without a toolchain. The C++ path matters at scale: ticking/bounding thousands of
instances or exact-binning hundreds of thousands of triangles is a tight
loop the interpreter cannot afford per frame.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Optional

import numpy as np

log = logging.getLogger("syzygy")

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libszg_native.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    # build under a private name, then rename: concurrent first uses
    # (parallel test workers) never load a half-written library
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["make", "-s", f"OUT={tmp}"],
            cwd=_NATIVE_DIR,
            check=True,
            capture_output=True,
        )
        os.replace(tmp, _LIB_PATH)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError, OSError) as e:
        log.debug("native build failed: %s", e)
        return False


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None on failure."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH) and not _build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:
        log.debug("native load failed: %s", e)
        return None

    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")

    lib.szg_tick_animations.argtypes = [
        ctypes.c_int64, i32p, f32p, f32p, f32p, ctypes.c_double, ctypes.c_double,
    ]
    lib.szg_tick_animations.restype = None
    lib.szg_trs_to_matrices.argtypes = [ctypes.c_int64, f32p, f32p, f32p, f32p]
    lib.szg_trs_to_matrices.restype = None
    lib.szg_shadow_bounds.argtypes = [
        ctypes.c_int64, u8p, f32p, f32p, f32p, f32p,
    ]
    lib.szg_shadow_bounds.restype = ctypes.c_int32
    lib.szg_bin_triangles.argtypes = [
        ctypes.c_int64, f32p, u8p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, i32p, i32p,
    ]
    lib.szg_bin_triangles.restype = ctypes.c_int64
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def trs_to_matrices(translations, eulers, scales) -> np.ndarray:
    """(n,3)x3 float32 -> (n,4,4) model matrices (T @ R @ S)."""
    t = np.ascontiguousarray(translations, np.float32)
    e = np.ascontiguousarray(eulers, np.float32)
    s = np.ascontiguousarray(scales, np.float32)
    n = t.shape[0]
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    out = np.empty((n, 16), np.float32)
    lib.szg_trs_to_matrices(n, t, e, s, out)
    return out.reshape(n, 4, 4)


def shadow_bounds(casts, corners, matrices):
    """Transformed-corner AABB (scene.cpp:95-148). Returns (found, min, max)."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    casts = np.ascontiguousarray(casts, np.uint8)
    corners = np.ascontiguousarray(corners, np.float32)
    matrices = np.ascontiguousarray(matrices.reshape(-1, 16), np.float32)
    out_min = np.empty(3, np.float32)
    out_max = np.empty(3, np.float32)
    found = lib.szg_shadow_bounds(
        casts.shape[0], casts, corners, matrices, out_min, out_max
    )
    return bool(found), out_min, out_max


def bin_triangles(
    bboxes, valid, tiles_x, tiles_y, tile_w, tile_h, capacity
):
    """Exact per-tile triangle lists. Returns (counts, indices, dropped)."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    bboxes = np.ascontiguousarray(bboxes, np.float32)
    valid = np.ascontiguousarray(valid, np.uint8)
    counts = np.empty(tiles_y * tiles_x, np.int32)
    indices = np.empty(tiles_y * tiles_x * capacity, np.int32)
    dropped = lib.szg_bin_triangles(
        bboxes.shape[0], bboxes, valid,
        tiles_x, tiles_y, tile_w, tile_h, capacity, counts, indices,
    )
    return (
        counts.reshape(tiles_y, tiles_x),
        indices.reshape(tiles_y, tiles_x, capacity),
        int(dropped),
    )


def tick_animations(kinds, original_translations, translations, eulers,
                    time_elapsed, delta_time) -> None:
    """In-place animation tick (scene.cpp:463-527)."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    kinds = np.ascontiguousarray(kinds, np.int32)
    lib.szg_tick_animations(
        kinds.shape[0],
        kinds,
        np.ascontiguousarray(original_translations, np.float32),
        translations,
        eulers,
        float(time_elapsed),
        float(delta_time),
    )
