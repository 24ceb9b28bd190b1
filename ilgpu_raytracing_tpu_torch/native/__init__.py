"""ctypes binding of the shared native scene core (`native/scenecore.cpp`).

The port compiles the repository's C++ source with g++ into its own
git-ignored `_build/` directory and never writes into `native/`. The
entry points return None when no compiler is available; `models/bvh.py`
then falls back to its Python median build (host code, logged when it
changes the requested method).
"""

from __future__ import annotations

import ctypes
import os
import shutil

import numpy as np

from ilgpu_raytracing_tpu_torch.utils.build import REPO_DIR, build_and_load

_SRC = os.path.join(REPO_DIR, "native", "scenecore.cpp")

BUILD_MEDIAN = 0
BUILD_SAH = 1
BUILD_LBVH = 2

_state: dict[str, object] = {}


def _load():
    if "lib" in _state:
        return _state["lib"]
    lib = None
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is not None and os.path.exists(_SRC):
        lib, _ = build_and_load(
            "scenecore",
            [cxx, "-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"],
            [_SRC],
        )
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i32 = ctypes.c_int32
        lib.sc_build_bvh.restype = i32
        lib.sc_build_bvh.argtypes = [
            f32p, f32p, f32p, i32, i32, i32, f32p, f32p, i32p, i32p,
        ]
        lib.sc_refit_bvh.restype = None
        lib.sc_refit_bvh.argtypes = [i32p, i32p, f32p, f32p, i32, f32p, f32p]
        lib.sc_triangle_bounds.restype = None
        lib.sc_triangle_bounds.argtypes = [f32p, f32p, f32p, i32, f32p, f32p, f32p]
    _state["lib"] = lib
    return lib


def available() -> bool:
    return _load() is not None


def build_bvh(bmin, bmax, centroid, leaf_size: int, method: int = BUILD_MEDIAN):
    """Native skip-index BVH build. Returns (node_bmin, node_bmax,
    node_ifields, leaf_order) or None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    bmin = np.ascontiguousarray(bmin, np.float32)
    bmax = np.ascontiguousarray(bmax, np.float32)
    centroid = np.ascontiguousarray(centroid, np.float32)
    p = bmin.shape[0]
    cap = 2 * p + 2
    nb = np.empty((cap, 3), np.float32)
    nx = np.empty((cap, 3), np.float32)
    nif = np.empty((cap, 4), np.int32)
    order = np.empty((p,), np.int32)
    count = lib.sc_build_bvh(
        bmin, bmax, centroid, p, leaf_size, method, nb, nx, nif, order
    )
    if count <= 0:
        return None
    return nb[:count].copy(), nx[:count].copy(), nif[:count].copy(), order


def refit_bvh(node_ifields, leaf_order, prim_bmin, prim_bmax):
    """Native bottom-up refit (models/bvh.refit_bvh). Returns (node_bmin,
    node_bmax) or None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    node_ifields = np.ascontiguousarray(node_ifields, np.int32)
    leaf_order = np.ascontiguousarray(leaf_order, np.int32)
    prim_bmin = np.ascontiguousarray(prim_bmin, np.float32)
    prim_bmax = np.ascontiguousarray(prim_bmax, np.float32)
    n = node_ifields.shape[0]
    nb = np.empty((n, 3), np.float32)
    nx = np.empty((n, 3), np.float32)
    lib.sc_refit_bvh(node_ifields, leaf_order, prim_bmin, prim_bmax, n, nb, nx)
    return nb, nx


def triangle_bounds(v0, v1, v2):
    """Native triangle bounds and centroids in one pass. Returns (bmin,
    bmax, centroid) or None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    v0 = np.ascontiguousarray(v0, np.float32)
    v1 = np.ascontiguousarray(v1, np.float32)
    v2 = np.ascontiguousarray(v2, np.float32)
    t = v0.shape[0]
    bmin = np.empty((t, 3), np.float32)
    bmax = np.empty((t, 3), np.float32)
    cen = np.empty((t, 3), np.float32)
    lib.sc_triangle_bounds(v0, v1, v2, t, bmin, bmax, cen)
    return bmin, bmax, cen
