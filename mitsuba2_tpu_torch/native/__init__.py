"""Native libraries of the port, built at first use and loaded with ctypes.

Three are built here: the C++ BVH builder (g++, the port's copy of
mitsuba2_tpu/native/bvh_builder.cpp), the CUDA traversal kernels (nvcc,
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


def build_bvh_native(bb_min: np.ndarray, bb_max: np.ndarray):
    """Binned-SAH BVH2 build in C++; same tuple layout as bvh.build_bvh's
    fields. Same flags as the JAX package's build of the same source."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "bvh_builder.cpp")
    lib = load_library("mts_bvh", src,
                       ["g++", "-O3", "-march=native", "-std=c++17",
                        "-shared", "-fPIC"])
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
