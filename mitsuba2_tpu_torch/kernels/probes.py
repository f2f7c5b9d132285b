"""Probes: three small hand-written CUDA kernels (csrc/probes.cu) that time
the parts of the traversal kernels one at a time, their wrappers and their
plain PyTorch twins (counterparts of the JAX package's TPU probes,
benchmarks/probe_walk_latency.py, probe_mxu_dma.py and probe_mxu_cost.py).

    walk_step      (P1) n_steps walk steps a lane over random node rows and
                   links: dependent (the next node from the slab result, as
                   the port's walks) or independent (from the step counter)
    row_load       (P2) 128-row blocks of 16-float rows against each lane's
                   16 floats: rows read by each thread (warp-uniform
                   addresses) or staged in shared memory first
    cluster_visit  (P3) P1's dependent walk plus a visit of one cluster of
                   CK plane rows through the cluster walks' first,
                   per-thread visit: never, every 4th step where the slab
                   hits, or every step

Each output is a deterministic function of the inputs, equal bit for bit
between a kernel and its twin (everything in f32, no contraction). The
tables and lane parameters come from `walk_tables`, `row_tables`,
`visit_tables` and `lanes`, made from numpy seeds as the TPU probes make
theirs. A CPU tensor goes to the twin, a CUDA tensor to the kernel; each
wrapper counts its launches in `launches`. The twins' `stats` count the
work a probe does (slab tests, rows, cluster visits, slot tests), from
which chip_smoke.py takes each probe's bound and its costs per unit.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from . import traverse

_SRC = os.path.join(traverse._CSRC, "probes.cu")
ROWS = 128         # P2: rows a step (csrc/probes.cu::ROWS)
ROW_W = 16         # P2: floats a row
FAR = 1e30         # the probes' t_best (csrc/probes.cu::FAR)
EVERY = (0, 4, 1)  # P3: no visit, every 4th step where the slab hits, every


def _declare(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mts_probe_walk_step.argtypes = [p] * 6 + [i] * 4 + [p]
    lib.mts_probe_row_load.argtypes = [p] * 3 + [i] * 4 + [p]
    lib.mts_probe_cluster_visit.argtypes = [p] * 8 + [i] * 5 + [p]
    for fn in (lib.mts_probe_walk_step, lib.mts_probe_row_load,
               lib.mts_probe_cluster_visit):
        fn.restype = ctypes.c_int
    lib.mts_probe_error_string.restype = ctypes.c_char_p
    lib.mts_probe_error_string.argtypes = [ctypes.c_int]


def load_cuda_library():
    """Build csrc/probes.cu with nvcc at first use (into
    mitsuba2_tpu_torch/_build/, with the traversal kernels' flags) and load
    it with ctypes."""
    from ..native import load_library
    return load_library("probes", _SRC,
                        [traverse.nvcc_path()] + traverse.NVCC_FLAGS,
                        declare=_declare, deps=traverse.HEADERS)


def _launch(what, args, sizes, dev):
    lib = load_cuda_library()
    with torch.cuda.device(dev):
        rc = getattr(lib, f"mts_probe_{what}")(
            *(a.data_ptr() for a in args), *sizes,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.mts_probe_error_string(rc).decode()
        raise RuntimeError(f"probe {what} launch failed: CUDA error {rc} "
                           f"({msg})")


def _check(tabs):
    """Each (name, tensor, dtype, shape with None for any size): of its
    dtype and shape, contiguous, 16-byte aligned, all on one cpu or cuda
    device. Returns the device."""
    dev = tabs[0][1].device
    for name, a, dt, shape in tabs:
        if (a.dtype != dt or a.dim() != len(shape) or not a.is_contiguous()
                or any(w is not None and a.shape[k] != w
                       for k, w in enumerate(shape))):
            raise ValueError(f"{name}: need a contiguous {dt} tensor of "
                             f"shape {shape}, got {a.dtype} "
                             f"{tuple(a.shape)}")
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, {tabs[0][0]} on "
                             f"{dev}")
        if a.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_steps(n_steps):
    if not 0 < n_steps < (1 << 24):
        raise ValueError(f"n_steps {n_steps} out of range")


def _check_start(start, n_rows):
    if start.numel() and not (int(start.min()) >= 0
                              and int(start.max()) < n_rows):
        raise ValueError(f"start nodes must lie in [0, {n_rows})")


# ---------------------------------------------------------------------------
# Inputs, from numpy seeds
# ---------------------------------------------------------------------------

# the node rows' scale: the TPU probes' unit normal leaves their rays, which
# start at (0, 1, 2) and run away from the origin, missing all but ~0.4% of
# the boxes; at 4 about 15% are hit, so that both links are taken
BOX_SCALE = 4.0


def walk_tables(n_rows: int, seed: int = 0):
    """P1's node rows (R, 8) f32 and links (R, 16) i32, drawn as the TPU
    probes draw theirs (rows from a normal, here of scale BOX_SCALE, links
    uniform over the rows)."""
    rng = np.random.default_rng(seed)
    node = (BOX_SCALE * rng.normal(size=(n_rows, 8))).astype(np.float32)
    link = rng.integers(0, n_rows, size=(n_rows, 16)).astype(np.int32)
    return node, link


def row_tables(n_lanes: int, n_rows: int = 512):
    """P2's rows (S, 16) f32 (seed 0) and lane vectors rt (16, N) f32
    (seed 1), as benchmarks/probe_mxu_dma.py draws them."""
    feat = np.random.default_rng(0).normal(
        size=(n_rows, ROW_W)).astype(np.float32)
    rt = np.random.default_rng(1).normal(
        size=(ROW_W, n_lanes)).astype(np.float32)
    return feat, rt


def visit_tables(n_clusters: int = 64, cluster_k: int = 128,
                 n_rows: int = 768, seed: int = 0):
    """P3's tables: P1's node rows and links over `n_rows` rows, then the
    slot-major plane rows of `n_clusters` random clusters, (C*CK, 20) f32,
    from the same generator, and the fixed centroid (4,) f32."""
    rng = np.random.default_rng(seed)
    node = (BOX_SCALE * rng.normal(size=(n_rows, 8))).astype(np.float32)
    link = rng.integers(0, n_rows, size=(n_rows, 16)).astype(np.int32)
    feat = rng.normal(size=(n_clusters * cluster_k,
                            traverse.FEAT_W)).astype(np.float32)
    centroid = np.array([0.25, 0.5, 0.75, 0.0], np.float32)
    return node, link, feat, centroid


def lanes(n_lanes: int, n_rows: int, divergent: bool):
    """Each lane's ray parameter s (N,) f32 and start node (N,) i32.
    Coherent: s = 0 and node 0 for every lane (one ray and one walk, as
    the TPU probes'). Divergent: from the scrambled lane index h = lane *
    2654435761 mod 2^32, s = h >> 20 (in [0, 4096): origins up to 4
    apart) and the start node h mod R, so that the threads of a warp walk
    apart from the first step."""
    if not divergent:
        return np.zeros(n_lanes, np.float32), np.zeros(n_lanes, np.int32)
    h = (np.arange(n_lanes, dtype=np.uint64) * 2654435761) & 0xFFFFFFFF
    return (h >> 20).astype(np.float32), (h % n_rows).astype(np.int32)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def walk_step(node, link, s, start, n_steps: int, dep: bool):
    """P1: (final node (N,) i32, slab hits (N,) i32) of each lane's walk of
    n_steps over `node` (R, 8) f32 and `link` (R, 16) i32 from its node
    `start` (N,) i32; its ray from s (N,) f32."""
    n = s.shape[0]
    dev = _check([("node", node, torch.float32, (None, 8)),
                  ("link", link, torch.int32, (node.shape[0], 16)),
                  ("s", s, torch.float32, (n,)),
                  ("start", start, torch.int32, (n,))])
    _check_steps(n_steps)
    _check_start(start, node.shape[0])
    if dev.type == "cpu":
        return walk_step_plain(node, link, s, start, n_steps, dep)
    outs = (torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev))
    if n:
        _launch("walk_step", (node, link, s, start, *outs),
                (n, node.shape[0], n_steps, int(dep)), dev)
        walk_step.launches += 1
    return outs


walk_step.launches = 0


def row_load(feat, rt, n_steps: int, smem: bool):
    """P2: (N,) f32, out[lane] = sum over i < n_steps of the min over k <
    128 of dot(feat[(i*128 mod S) + k], rt[:, lane]); feat (S, 16) f32 with
    S a multiple of 128, rt (16, N) f32."""
    n = rt.shape[1]
    dev = _check([("feat", feat, torch.float32, (None, ROW_W)),
                  ("rt", rt, torch.float32, (ROW_W, n))])
    _check_steps(n_steps)
    if feat.shape[0] % ROWS or not feat.shape[0]:
        raise ValueError(f"feat needs a positive multiple of {ROWS} rows")
    if dev.type == "cpu":
        return row_load_plain(feat, rt, n_steps)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n:
        _launch("row_load", (feat, rt, out),
                (n, feat.shape[0], n_steps, int(smem)), dev)
        row_load.launches += 1
    return out


row_load.launches = 0


def cluster_visit(node, link, feat, centroid, s, start, n_steps: int,
                  every: int, cluster_k: int):
    """P3: (t_best (N,) f32, slot (N,) i32) of P1's dependent walk with a
    visit of cluster (step mod C) of `feat` (C*CK, 20) f32, recentred at
    `centroid` (4,) f32: never (every 0), every 4th step where the slab
    hits (4) or every step (1). t_best is 1e30 and slot -1 where no slot
    was hit."""
    n = s.shape[0]
    dev = _check([("node", node, torch.float32, (None, 8)),
                  ("link", link, torch.int32, (node.shape[0], 16)),
                  ("feat", feat, torch.float32, (None, traverse.FEAT_W)),
                  ("centroid", centroid, torch.float32, (4,)),
                  ("s", s, torch.float32, (n,)),
                  ("start", start, torch.int32, (n,))])
    _check_steps(n_steps)
    _check_start(start, node.shape[0])
    if every not in EVERY:
        raise ValueError(f"every must be one of {EVERY}")
    if feat.shape[0] % cluster_k or not feat.shape[0]:
        raise ValueError(f"feat must be (C*{cluster_k}, {traverse.FEAT_W})")
    if dev.type == "cpu":
        return cluster_visit_plain(node, link, feat, centroid, s, start,
                                   n_steps, every, cluster_k)
    outs = (torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev))
    if n:
        _launch("cluster_visit", (node, link, feat, centroid, s, start,
                                  *outs),
                (n, n_steps, feat.shape[0] // cluster_k, cluster_k, every),
                dev)
        cluster_visit.launches += 1
    return outs


cluster_visit.launches = 0


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------

def _probe_ray(s):
    """The probes' rays: o = s * 0.001 + (0, 1, 2), d = o.x + (0.1, 0.2,
    0.3), and 1/d as the kernels' make_ray takes it."""
    ox = s * 0.001
    ray = (ox, ox + 1.0, ox + 2.0, ox + 0.1, ox + 0.2, ox + 0.3)
    return ray, tuple(traverse._safe_inv(d) for d in ray[3:])


def _count(stats, key, k):
    if stats is not None:
        stats[key] = stats.get(key, 0) + k


def _indep_node(k, n_rows):
    return (k * 7919 + 1) % n_rows


def walk_step_plain(node, link, s, start, n_steps: int, dep: bool,
                    stats=None):
    """The twin of walk_step. Its `stats` count the slab tests."""
    (ox, oy, oz, _, _, _), inv = _probe_ray(s)
    n = s.shape[0]
    nd = start.long()
    hits = torch.zeros(n, dtype=torch.int32, device=s.device)
    for k in range(n_steps):
        hit = traverse._slab(node[nd], ox, oy, oz, *inv, FAR)
        hits += hit.int()
        nd = (link[nd, torch.where(hit, 0, 8)].long() if dep else
              torch.full_like(nd, _indep_node(k + 1, node.shape[0])))
    _count(stats, "slab_tests", n * n_steps)
    return nd.int(), hits


def row_load_plain(feat, rt, n_steps: int, stats=None):
    """The twin of row_load: each dot summed left to right, as the
    kernel's. Its `stats` count the rows a lane reads."""
    acc = torch.zeros(rt.shape[1], dtype=torch.float32, device=rt.device)
    for st in range(n_steps):
        base = (st * ROWS) % feat.shape[0]
        f = feat[base:base + ROWS]
        d = f[:, 0:1] * rt[0]
        for j in range(1, ROW_W):
            d = d + f[:, j:j + 1] * rt[j]
        acc = acc + d.amin(0)
    _count(stats, "rows", rt.shape[1] * n_steps * ROWS)
    return acc


def cluster_visit_plain(node, link, feat, centroid, s, start, n_steps: int,
                        every: int, cluster_k: int, stats=None):
    """The twin of cluster_visit: P1's dependent walk, the visit through
    the cluster walks' twin's visit. Its `stats` count the slab tests,
    the cluster visits and their slot tests."""
    ray, inv = _probe_ray(s)
    n, dev = s.shape[0], s.device
    n_clusters = feat.shape[0] // cluster_k
    c = centroid[0:3].unbind(0)
    nd = start.long()
    t_best = torch.full((n,), FAR, dtype=torch.float32, device=dev)
    best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for k in range(n_steps):
        hit = traverse._slab(node[nd], *ray[:3], *inv, FAR)
        nxt = link[nd, torch.where(hit, 0, 8)].long()
        if every == 1 or (every == 4 and k % 4 == 0):
            vis = (torch.arange(n, device=dev) if every == 1
                   else torch.nonzero(hit).squeeze(1))
            base = (k % n_clusters) * cluster_k
            closer, t_c, slot = traverse._cluster_visit(
                feat[base:base + cluster_k], base, c,
                [a[vis] for a in ray], t_best[vis], cluster_k, False, stats)
            sel = vis[closer]
            t_best[sel] = t_c[closer]
            best[sel] = slot[closer]
        nd = nxt
    _count(stats, "slab_tests", n * n_steps)
    return t_best, best.int()
