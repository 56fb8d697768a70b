"""Native (C++) host-plane helpers, loaded via ctypes.

The shared libraries build on first use with g++ into the git-ignored
``feabas_tpu_torch/_build/`` (the sources stay here); every entry point
has a pure-numpy fallback so the framework works without a toolchain.

The port's copy of ``feabas_tpu/native/__init__.py``, cut to what the port reaches.
"""

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(os.path.dirname(_HERE), '_build')
_SRC = os.path.join(_HERE, 'rasterize.cpp')
_LIB = os.path.join(_BUILD, 'librasterize.so')
_CDT_SRC = os.path.join(_HERE, 'cdt.cpp')
_CDT_LIB = os.path.join(_BUILD, 'libcdt.so')
_lock = threading.Lock()
_lib = None
_cdt_lib = None
_build_failed = False
_cdt_build_failed = False


def _build(src, lib, timeout):
    """g++ ``src`` into ``lib`` unless it is up to date; the library is
    written under a temporary name and renamed, so processes building at
    once never load a partial file."""
    if os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
        return
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=_BUILD)
    os.close(fd)
    try:
        subprocess.run(['g++', '-O3', '-shared', '-fPIC', src, '-o', tmp],
                       check=True, capture_output=True, timeout=timeout)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            _build(_SRC, _LIB, 120)
            lib = ctypes.CDLL(_LIB)
            lib.rasterize_triangles.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64,
                ctypes.c_double, ctypes.c_double]
            lib.field_from_tids.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_double, ctypes.c_double,
                ctypes.c_void_p, ctypes.c_void_p]
            _lib = lib
        except Exception:
            _build_failed = True
            _lib = None
    return _lib


def _load_cdt():
    global _cdt_lib, _cdt_build_failed
    if _cdt_lib is not None or _cdt_build_failed:
        return _cdt_lib
    with _lock:
        if _cdt_lib is not None or _cdt_build_failed:
            return _cdt_lib
        try:
            _build(_CDT_SRC, _CDT_LIB, 180)
            lib = ctypes.CDLL(_CDT_LIB)
            lib.cdt_enforce.restype = ctypes.c_int64
            lib.cdt_enforce.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64]
            _cdt_lib = lib
        except Exception:
            _cdt_build_failed = True
            _cdt_lib = None
    return _cdt_lib


def cdt_available():
    return _load_cdt() is not None


def cdt_triangulate(points, segments=None):
    """Constrained Delaunay triangulation: Qhull (scipy, robust) builds
    the Delaunay triangulation; the C++ helper recovers every requested
    segment as an edge by flipping crossing edges. Returns ((K, 3) int32
    triangles, n_segments_recovered), or (None, 0) when the native
    library is unavailable. Outside/hole trimming is the caller's job."""
    lib = _load_cdt()
    if lib is None:
        return None, 0
    from scipy.spatial import Delaunay
    pts = np.ascontiguousarray(points, dtype=np.float64).reshape(-1, 2)
    if pts.shape[0] < 3:
        return np.zeros((0, 3), np.int32), 0
    d = Delaunay(pts)
    tris = np.array(d.simplices, dtype=np.int32)
    nbrs = np.array(d.neighbors, dtype=np.int32)
    # canonicalize to CCW (Qhull does not guarantee orientation); a vertex
    # swap also swaps the corresponding opposite-neighbor entries
    p = pts[tris]
    o = ((p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
         - (p[:, 1, 1] - p[:, 0, 1]) * (p[:, 2, 0] - p[:, 0, 0]))
    cw = o < 0
    tris[cw] = tris[cw][:, [0, 2, 1]]
    nbrs[cw] = nbrs[cw][:, [0, 2, 1]]
    tris = np.ascontiguousarray(tris)
    nbrs = np.ascontiguousarray(nbrs)
    if segments is None or len(segments) == 0:
        return tris, 0
    segs = np.ascontiguousarray(segments, dtype=np.int32).reshape(-1, 2)
    ok = lib.cdt_enforce(pts.ctypes.data, pts.shape[0],
                         tris.ctypes.data, nbrs.ctypes.data, tris.shape[0],
                         segs.ctypes.data, segs.shape[0])
    return tris, int(ok)


def available():
    return _load() is not None


def rasterize_triangles(verts, tris, H, W, x0, y0, weights=None):
    """C++ tid-map rasterization; returns (H, W) int32 (-1 outside) or
    None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    verts = np.ascontiguousarray(verts, dtype=np.float64)
    tris = np.ascontiguousarray(tris, dtype=np.int32)
    tid = np.full((H, W), -1, dtype=np.int32)
    if weights is not None:
        weights = np.ascontiguousarray(weights, dtype=np.float32)
        wmap = np.full((H, W), -np.inf, dtype=np.float32)
        wptr = wmap.ctypes.data
        wgt_ptr = weights.ctypes.data
    else:
        wptr = None
        wgt_ptr = None
    lib.rasterize_triangles(
        verts.ctypes.data, verts.shape[0],
        tris.ctypes.data, tris.shape[0],
        wgt_ptr, tid.ctypes.data, wptr,
        H, W, float(x0), float(y0))
    return tid


def field_from_tids(tid, A, b, x0, y0):
    """C++ affine-field evaluation; returns (map_x, map_y) float32 with
    NaN outside, or None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    tid = np.ascontiguousarray(tid, dtype=np.int32)
    A = np.ascontiguousarray(A, dtype=np.float64)
    b = np.ascontiguousarray(b, dtype=np.float64)
    H, W = tid.shape
    map_x = np.empty((H, W), np.float32)
    map_y = np.empty((H, W), np.float32)
    lib.field_from_tids(tid.ctypes.data, H, W, A.ctypes.data, b.ctypes.data,
                        float(x0), float(y0),
                        map_x.ctypes.data, map_y.ctypes.data)
    return map_x, map_y
