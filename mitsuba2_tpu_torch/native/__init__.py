"""Native libraries of the port, built at first use and loaded with ctypes.

Four are built here: the C++ BVH builder and OBJ parser (g++, the port's
copies of mitsuba2_tpu/native/bvh_builder.cpp and obj_parser.cpp), the
CUDA traversal kernels (nvcc,
csrc/cluster_walk.cu; see kernels/traverse.py) and the CUDA probes (nvcc,
csrc/probes.cu; see kernels/probes.py). All go into
`mitsuba2_tpu_torch/_build/`, named by a hash of their sources (the
headers they include among them) and flags, so an edited source is
rebuilt and concurrent builders do not collide.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
_LOCK = threading.Lock()
_LIBS = {}
BUILD_LOG = {}   # name -> the compiler's stderr, for libraries built here


def _host_fingerprint() -> bytes:
    """The CPU model and feature flags: a library built with -march=native
    on one machine is not reused on another."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return b""
    return b"".join(ln for ln in lines
                    if ln.startswith((b"model name", b"flags")))[:4096]


def build_library(name: str, src: str, cmd_prefix: list, deps=()) -> str:
    """Compile `src` with `cmd_prefix + [src, "-o", out]` into BUILD_DIR
    unless a library of the same source, headers `deps`, flags and host
    CPU is already there. Returns the library's path; raises
    CalledProcessError with the compiler's output on failure."""
    h = hashlib.sha256()
    for path in (src, *deps):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(repr(cmd_prefix).encode() + _host_fingerprint())
    digest = h.hexdigest()
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"lib{name}_{digest[:16]}.so")
    if os.path.exists(so):
        return so
    import fcntl
    with open(so + ".lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            if os.path.exists(so):  # another process built it meanwhile
                return so
            tmp = f"{so[:-3]}.{os.getpid()}.tmp.so"
            try:
                proc = subprocess.run(cmd_prefix + [src, "-o", tmp],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise subprocess.CalledProcessError(
                        proc.returncode, proc.args, proc.stdout, proc.stderr)
                BUILD_LOG[name] = proc.stderr
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)
    return so


def load_library(name: str, src: str, cmd_prefix: list, declare=None,
                 deps=()):
    """Build (if needed) and dlopen a library once per process;
    `declare(lib)` sets its function signatures once, at load."""
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(build_library(name, src, cmd_prefix, deps))
            if declare is not None:
                declare(lib)
            _LIBS[name] = lib
        return _LIBS[name]


_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


# the JAX package's g++ flags for its native libraries
_GXX = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]
_HERE = os.path.dirname(os.path.abspath(__file__))


def build_bvh_native(bb_min: np.ndarray, bb_max: np.ndarray):
    """Binned-SAH BVH2 build in C++; same tuple layout as bvh.build_bvh's
    fields. Same flags as the JAX package's build of the same source."""
    lib = load_library("mts_bvh", os.path.join(_HERE, "bvh_builder.cpp"),
                       _GXX)
    fn = lib.mts_build_bvh
    fn.restype = ctypes.c_int64
    fn.argtypes = [_f32p, _f32p, ctypes.c_int64, _f32p, _f32p,
                   _i32p, _i32p, _i32p, _i32p]
    P = bb_min.shape[0]
    cap = max(2 * P, 2)
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    leaf_start = np.empty(cap, np.int32)
    leaf_count = np.empty(cap, np.int32)
    miss = np.empty(cap, np.int32)
    prim_order = np.empty(P, np.int32)
    n = fn(np.ascontiguousarray(bb_min, np.float32),
           np.ascontiguousarray(bb_max, np.float32),
           P, node_min, node_max, leaf_start, leaf_count, miss, prim_order)
    return (node_min[:n].copy(), node_max[:n].copy(), leaf_start[:n].copy(),
            leaf_count[:n].copy(), miss[:n].copy(), prim_order)


def _declare_obj(lib):
    c_fpp = ctypes.POINTER(ctypes.c_float)
    c_ipp = ctypes.POINTER(ctypes.c_int32)
    lib.mts_parse_obj.restype = ctypes.c_int64
    lib.mts_parse_obj.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(c_fpp), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(c_ipp), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(c_fpp), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(c_fpp), ctypes.POINTER(ctypes.c_int32)]
    lib.mts_free.argtypes = [ctypes.c_void_p]


def parse_obj_native(path: str, flip_tex_coords: bool = True):
    """The C++ OBJ parse (obj_parser.cpp, built with the JAX package's
    flags). Returns (vertices (V,3) f32, faces (F,3) i32, normals (V,3)
    f32 or None, uvs (V,2) f32 or None): the split vertices of
    scene/mesh_io.py's Python parser, numbered by first use where that one
    sorts them. Raises on a toolchain or parse failure."""
    lib = load_library("mts_obj", os.path.join(_HERE, "obj_parser.cpp"),
                       _GXX, _declare_obj)
    c_fpp = ctypes.POINTER(ctypes.c_float)
    c_ipp = ctypes.POINTER(ctypes.c_int32)
    pv, pf, pn, puv = c_fpp(), c_ipp(), c_fpp(), c_fpp()
    nv, nf = ctypes.c_int64(), ctypes.c_int64()
    hn, huv = ctypes.c_int32(), ctypes.c_int32()
    rc = lib.mts_parse_obj(path.encode(), 1 if flip_tex_coords else 0,
                           ctypes.byref(pv), ctypes.byref(nv),
                           ctypes.byref(pf), ctypes.byref(nf),
                           ctypes.byref(pn), ctypes.byref(hn),
                           ctypes.byref(puv), ctypes.byref(huv))
    if rc != 0:
        raise RuntimeError(f"mts_parse_obj failed with code {rc}")
    try:
        V, F = int(nv.value), int(nf.value)
        verts = np.ctypeslib.as_array(pv, (V, 3)).copy()
        faces = np.ctypeslib.as_array(pf, (F, 3)).copy()
        normals = (np.ctypeslib.as_array(pn, (V, 3)).copy()
                   if hn.value else None)
        uvs = (np.ctypeslib.as_array(puv, (V, 2)).copy()
               if huv.value else None)
    finally:
        for p in (pv, pf, pn, puv):
            if p:
                lib.mts_free(ctypes.cast(p, ctypes.c_void_p))
    return verts, faces, normals, uvs
