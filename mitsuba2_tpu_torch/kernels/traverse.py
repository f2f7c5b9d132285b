"""Traversal: the hand-written CUDA kernels, their wrappers and their
plain PyTorch twins (counterpart of kernels/traverse_pallas.py: the MXU
cluster walks and the scalar BVH2 walks, flat and instanced).

Tables (scene/scene.py builds them exactly as the JAX package does;
convert.py packs the walk-only copies once at upload, and uploads the
tables of the one walk a scene takes):
    mxu_node_f   (R, 16) f32  pruned cut tree: [min.xyz, max.xyz, slot
                 base (-1 at inner nodes), instance id (-1 except at a
                 TLAS instance leaf), centroid.xyz, pad]
    mxu_link     (R, 16) i32  [hit8 | miss8] per-octant threaded links;
                 BLAS_EXIT (-2) leaves an instance's cut tree
    cluster_feat (S, 20) f32  slot-major copy of the Möller–Trumbore
                 plane rows of `mxu_feat`: [det(3) | u(6) | v(6) | t(4) |
                 pad] against the ray features [d, (o-c) x d, o-c, 1]
                 (c = cluster centroid)
    bvh_node     (B, 8) f32   the full BVH2: [min.xyz, max.xyz, leaf_start,
                 leaf_count] (-1 / 0 at inner nodes; instanced scenes: a
                 TLAS leaf has count 0 and its instance id as start)
    bvh_link     (B, 16) i32  [hit8 | miss8], BLAS_EXIT leaves a BLAS
    bvh_pair     (B, 16) i32  an inner node's two children, each [min.xyz,
                 max.xyz (f32 bits), reference, row], the octant order in
                 the top byte of the first row word (convert.bvh_pair_rows;
                 read by the pair walk of K3's both hits and K4's any hit)
    bvh_prim     (P, 12) f32  [p0, e1, e2, type, 0, 0]: a triangle's vertex
                 and edges, or a sphere's center and [radius, ±1, 0]
    inst_inv     (K, 16) f32  instanced scenes: [world->local 3x4 | BVH2
                 root (not read) | cut-tree root | pad]
    inst_bvh_root (K,) i32    instanced scenes: each instance's BVH2 BLAS
                 root row
    bvh8_child   (M*8, 8) f32 the BVH8 collapse of the BVH2 (K6): [min.xyz,
                 max.xyz, kind, count], kind >= 0 a leaf's first prim, -1
                 an empty slot, <= -2 the inner child node -2 - kind
    bvh8c_child  (Mc*8, 16) f32 the BVH8 collapse of the cut tree (K7):
                 [min.xyz, max.xyz, kind, 0, centroid.xyz, pad], kind >= 0
                 a cluster's slot base
    bvh8_order / bvh8c_order (M*8, 8) i32 row node*8 + octant: the node's
                 child slots in near-first order for that octant
    mxu_ccs      (C, 8) f32   each cluster's centroid [c.xyz, pad] (K8)
    mxu_ccount   (C,) i32     each cluster's slots up to its last real
                 one: the span K8 tests (convert.slot_counts)

The wrappers: `cluster_closest_hit` and `cluster_any_hit` (K1/K2: one cut
tree), `inst_cluster_closest_hit` and `inst_cluster_any_hit` (K5: a TLAS
over instances, each entered into its group's local-space cut tree),
`bvh_closest_hit` and `bvh_any_hit` (K3: the full BVH2 with leaves of up
to LEAF_K triangles or spheres) and `inst_bvh_closest_hit` and
`inst_bvh_any_hit` (K4: the stitched TLAS + per-group BVH2 table; K3's
two and K4's any hit walk the child-pair rows with a stack, K4's closest
hit the threaded links, and all four take the same tables),
`bvh8_closest_hit` and `bvh8_any_hit` (K6: the BVH8 walk over prim
leaves), `bvh8mxu_closest_hit` and `bvh8mxu_any_hit` (K7: the BVH8
walk over cluster leaves) and `dense_closest_hit` and `dense_any_hit`
(K8: every cluster against every ray). A CPU tensor goes to the plain
twin, a CUDA tensor to the kernel; nothing falls back from one to the
other. Each wrapper counts its kernel launches in its `launches`
attribute.
`ray_intersect_preliminary`, `ray_test`, `ray_intersect_instanced`,
`ray_test_instanced`, `ray_intersect_bvh8`, `ray_test_bvh8`,
`ray_intersect_bvh8mxu` and `ray_test_bvh8mxu` are the entry points, the
counterparts of traverse_pallas's functions of the same names: by default
a scene holding a sphere takes the BVH2 walks (spheres have no plane
form), any other the cluster walks; set_backend("bvh8" | "bvh8mxu")
routes a flat scene through the BVH8 walks (scene/scene.py). The JAX
package's two module switches on the same dispatch line are read here
too: MXU_LEAVES (MI_MXU_LEAVES) off sends triangle scenes to the BVH2
walks, and _MXU_DENSE (MI_MXU_DENSE) sends a flat triangle scene on the
cluster path to the dense sweep.
"""
from __future__ import annotations

import ctypes
import os
import re

import torch

from ..scene.bvh import BLAS_EXIT, LEAF_K
from ..scene.shapes import PRIM_TRI
from .brute import sphere_test, tri_test

FEAT_W = 20  # floats per slot in cluster_feat
WARP = 32    # threads of a CUDA warp
BLOCK = 128  # threads of a kernel block (csrc/cluster_walk.cu)
CCS_W = 8    # floats per cluster in mxu_ccs
# slots a warp tests in one pass of a cooperative cluster visit
# (csrc/cluster_walk.cu::warp_visit): TILE_J = 2 slots a lane, and
# INST_ANY_TILE_J = 1 on the instanced any hit, BVH8C_TILE_J = 1 on K7
TILE = 2 * WARP
INST_ANY_TILE = WARP
BVH8C_TILE = WARP
# The JAX package's module switches (traverse_pallas.py:379, :1025-1027),
# read once at import with the same accepted values; tests set the module
# attributes. MXU_LEAVES (MI_MXU_LEAVES, default on): off, triangle scenes
# take the BVH2 walks (K3 flat, K4 instanced) instead of the cluster walks.
MXU_LEAVES = os.environ.get("MI_MXU_LEAVES", "1").lower() in ("1", "true")
# _MXU_DENSE (MI_MXU_DENSE): a flat triangle scene on the cluster path
# sweeps every cluster (K8) instead of walking the cut tree (K1/K2): "1"
# always, "auto" up to MXU_DENSE_MAX clusters, "0" never
MXU_DENSE_MAX = int(os.environ.get("MI_MXU_DENSE_MAX", "768"))
_MXU_DENSE = os.environ.get("MI_MXU_DENSE", "0")
if _MXU_DENSE not in ("auto", "0", "1"):
    raise ValueError(f"MI_MXU_DENSE={_MXU_DENSE!r}: one of auto, 0, 1")
# rays a thread of the dense sweep sweeps (csrc/cluster_walk.cu's
# DENSE_RAYS): the twins' default for counting the threads' loads
DENSE_RAYS = 2
# the most steps a lane of K4's (K6's) closest-hit walk takes in a round
# before its warp tests the round's leaves together (csrc/cluster_walk.cu's
# BVH_ROUND_STEPS, BVH8_ROUND_STEPS): the twins' rounds for `leaf_passes`
BVH_ROUND_STEPS = 8
BVH8_ROUND_STEPS = 2
# (reference, tmin or row) entries of the pair walk's stack (K3's closest
# and any hit, K4's any hit; csrc/cluster_walk.cu's BVH_PAIR_STACK): a push
# that finds it full hands the lane to the threaded walk (`fallback_steps`)
BVH_PAIR_STACK = 32
# the wrappers whose kernels take the pair walk and read bvh_pair (K4's
# closest hit, the threaded walk in rounds, takes no bvh_pair)
PAIR_WALKS = ("bvh_closest_hit", "bvh_any_hit", "inst_bvh_any_hit")
# the child-pair rows' encoding (convert.bvh_pair_rows, csrc/cluster_walk.cu):
# an instance leaf's tag in a reference, and the bits of a row id below the
# octant mask in the first record's row word
PAIR_INST = 1 << 30
PAIR_ROW_BITS = 24
# (node, mask) entries of a BVH8 walk's stack (csrc/cluster_walk.cu), and
# the margin over the tree's depth that the JAX kernels size it with
BVH8_STACK = 32
BVH8_STACK_MARGIN = 2
_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")
_SRC = os.path.join(_CSRC, "cluster_walk.cu")
# the device helpers cluster_walk.cu shares with csrc/probes.cu
HEADERS = (os.path.join(_CSRC, "walk.cuh"),)
# --fmad=false: no multiply-add contraction, so the kernels round every
# product and sum as the twins' separate torch ops do and the two agree
# bit for bit on the card. -Xptxas -v: registers and spills per kernel in
# the build log (native.BUILD_LOG)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]


def with_constants(src: str, **values) -> str:
    """A CUDA source's text with each `constexpr int NAME = v;` line of
    `values` set to its value (builds of cluster_walk.cu at other tile
    widths, rays a thread or round lengths); raises where the source has
    no such line."""
    for name, v in values.items():
        src, n = re.subn(rf"^constexpr int {name} = \d+;$",
                         f"constexpr int {name} = {int(v)};", src,
                         flags=re.M)
        if n != 1:
            raise ValueError(f"no line 'constexpr int {name} = ...;'")
    return src


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def _declare(lib):
    """Set the C signatures: pointers and the stream as void*, sizes as int."""
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn, n_tab, n_out in ((lib.mts_cluster_closest_hit, 3, 2),
                             (lib.mts_cluster_any_hit, 3, 1),
                             (lib.mts_bvh8mxu_closest_hit, 3, 2),
                             (lib.mts_bvh8mxu_any_hit, 3, 1),
                             (lib.mts_dense_closest_hit, 3, 2),
                             (lib.mts_dense_any_hit, 3, 1)):
        fn.restype = ctypes.c_int
        fn.argtypes = [p] * n_tab + [p] * 7 + [p] * n_out + [i, i, i, p]
    for fn, n_out in ((lib.mts_inst_cluster_closest_hit, 3),
                      (lib.mts_inst_cluster_any_hit, 1)):
        fn.restype = ctypes.c_int
        fn.argtypes = [p, p, p, p] + [p] * 7 + [p] * n_out + [i, i, i, p]
    for fn, n_tab, n_out in ((lib.mts_bvh_closest_hit, 4, 4),
                             (lib.mts_bvh_any_hit, 4, 1),
                             (lib.mts_inst_bvh_closest_hit, 5, 5),
                             (lib.mts_inst_bvh_any_hit, 6, 1),
                             (lib.mts_bvh8_closest_hit, 3, 4),
                             (lib.mts_bvh8_any_hit, 3, 1)):
        fn.restype = ctypes.c_int
        fn.argtypes = [p] * n_tab + [p] * 7 + [p] * n_out + [i, i, p]
    lib.mts_cuda_error_string.restype = ctypes.c_char_p
    lib.mts_cuda_error_string.argtypes = [ctypes.c_int]


def load_cuda_library():
    """Build csrc/cluster_walk.cu with nvcc at first use (into
    mitsuba2_tpu_torch/_build/) and load it with ctypes."""
    from ..native import load_library
    return load_library("cluster_walk", _SRC, [nvcc_path()] + NVCC_FLAGS,
                        declare=_declare, deps=HEADERS)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _check_tables(tabs, rays):
    """Each (name, table, dtype, rank): contiguous, of its dtype and rank,
    16-byte aligned where the kernels read it as float4 or int4, on the
    rays' device; the rays (N,) f32 and contiguous. Returns (N, device)."""
    n = rays[0].shape[0]
    dev = rays[0].device
    for name, a, dt, rank in tabs:
        if a.dtype != dt or a.dim() != rank or not a.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {rank}-D {dt} "
                             f"tensor, got {a.dtype} {tuple(a.shape)}")
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, rays on {dev}")
        if rank == 2 and a.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernels "
                             "read its rows as float4)")
    for a in rays:
        if (a.dtype != torch.float32 or a.shape != (n,)
                or not a.is_contiguous() or a.device != dev):
            raise ValueError("ray components and t_max must be contiguous "
                             f"(N,) float32 tensors on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return n, dev


def _check(node_f, link, feat, rays, cluster_k, inst_inv=None):
    tabs = [("mxu_node_f", node_f, torch.float32, 2),
            ("mxu_link", link, torch.int32, 2),
            ("cluster_feat", feat, torch.float32, 2)]
    if inst_inv is not None:
        tabs.append(("inst_inv", inst_inv, torch.float32, 2))
        if inst_inv.dim() != 2 or inst_inv.shape[1] != 16:
            raise ValueError("inst_inv must be (K, 16)")
    n, dev = _check_tables(tabs, rays)
    if node_f.shape[1] != 16 or link.shape != node_f.shape:
        raise ValueError("mxu_node_f and mxu_link must both be (R, 16)")
    if feat.shape[1] != FEAT_W or feat.shape[0] % cluster_k != 0:
        raise ValueError(f"cluster_feat must be (C*{cluster_k}, {FEAT_W})")
    return n, dev


def _check_bvh(node, link, pair, prim, rays, fuel, inst_inv=None,
               inst_root=None):
    tabs = [("bvh_node", node, torch.float32, 2),
            ("bvh_link", link, torch.int32, 2),
            ("bvh_pair", pair, torch.int32, 2),
            ("bvh_prim", prim, torch.float32, 2)]
    if inst_inv is not None:
        tabs += [("inst_inv", inst_inv, torch.float32, 2),
                 ("inst_bvh_root", inst_root, torch.int32, 1)]
        if (inst_inv.dim() != 2 or inst_inv.shape[1] != 16
                or inst_root.shape != inst_inv.shape[:1]):
            raise ValueError("inst_inv must be (K, 16) and inst_bvh_root "
                             "(K,)")
    n, dev = _check_tables(tabs, rays)
    if (node.shape[1] != 8 or link.shape != (node.shape[0], 16)
            or pair.shape != link.shape):
        raise ValueError("bvh_node must be (B, 8), bvh_link and bvh_pair "
                         "(B, 16)")
    if prim.shape[1] != 12:
        raise ValueError("bvh_prim must be (P, 12)")
    if not 0 < fuel < (1 << 31):
        raise ValueError(f"walk fuel {fuel} does not fit an int32")
    return n, dev


def _check_bvh8(child, order, leaf, rays, stack, fuel, cluster_k=None):
    """The BVH8 walks' tables: K6's (cluster_k None: bvh8_child, bvh8_order,
    bvh_prim) or K7's (bvh8c_child, bvh8c_order, cluster_feat)."""
    k7 = cluster_k is not None
    cn, on, ln = (("bvh8c_child", "bvh8c_order", "cluster_feat") if k7
                  else ("bvh8_child", "bvh8_order", "bvh_prim"))
    n, dev = _check_tables([(cn, child, torch.float32, 2),
                            (on, order, torch.int32, 2),
                            (ln, leaf, torch.float32, 2)], rays)
    width = 16 if k7 else 8
    if (child.shape[1] != width or child.shape[0] % 8 != 0
            or order.shape != (child.shape[0], 8)):
        raise ValueError(f"{cn} must be (M*8, {width}) and {on} (M*8, 8)")
    if k7 and (leaf.shape[1] != FEAT_W or leaf.shape[0] % cluster_k != 0):
        raise ValueError(f"cluster_feat must be (C*{cluster_k}, {FEAT_W})")
    if not k7 and leaf.shape[1] != 12:
        raise ValueError("bvh_prim must be (P, 12)")
    if not 0 < stack <= BVH8_STACK:
        raise ValueError(f"a BVH8 walk needs a stack of {stack} entries "
                         f"(depth + {BVH8_STACK_MARGIN}); the kernels hold "
                         f"{BVH8_STACK}")
    if not 0 < fuel < (1 << 31):
        raise ValueError(f"walk fuel {fuel} does not fit an int32")
    return n, dev


def _check_dense(ccs, count, feat, rays, cluster_k):
    n, dev = _check_tables([("mxu_ccs", ccs, torch.float32, 2),
                            ("mxu_ccount", count, torch.int32, 1),
                            ("cluster_feat", feat, torch.float32, 2)], rays)
    if ccs.shape[1] != CCS_W:
        raise ValueError(f"mxu_ccs must be (C, {CCS_W})")
    if count.shape != ccs.shape[:1]:
        raise ValueError(f"mxu_ccount must be ({ccs.shape[0]},), one count "
                         f"a cluster of mxu_ccs")
    if bool(((count < 0) | (count > cluster_k)).any()):
        raise ValueError(f"mxu_ccount: each count must lie in [0, "
                         f"{cluster_k}]")
    if feat.shape != (ccs.shape[0] * cluster_k, FEAT_W):
        raise ValueError(f"cluster_feat must be (C*{cluster_k}, {FEAT_W}) "
                         f"for the {ccs.shape[0]} clusters of mxu_ccs")
    return n, dev


def _raise_on_error(lib, rc, what):
    if rc != 0:
        msg = lib.mts_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _launch(what, tabs, rays, outs, *sizes):
    """Launch the kernel behind wrapper `what` (C entry mts_<what>) on the
    tensors' own card and stream; `sizes` follow the lane count: the
    cluster walks' table rows (flat) or step cap (instanced) and cluster
    size, the BVH2 walks' step cap, the BVH8 walks' step cap (and cluster
    size), the dense sweep's cluster count and cluster size. Raises on a
    launch error."""
    lib = load_cuda_library()
    dev = rays[0].device
    with torch.cuda.device(dev):
        rc = getattr(lib, f"mts_{what}")(
            *(a.data_ptr() for a in tabs), *(a.data_ptr() for a in rays),
            *(a.data_ptr() for a in outs), rays[0].shape[0], *sizes,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on_error(lib, rc, what)


def cluster_closest_hit(node_f, link, feat, ox, oy, oz, dx, dy, dz, t_max,
                        cluster_k: int):
    """Closest hit over the cluster cut tree: (t (N,) f32, slot (N,) i32),
    t = +inf and slot = -1 on a miss."""
    rays = (ox, oy, oz, dx, dy, dz, t_max)
    n, dev = _check(node_f, link, feat, rays, cluster_k)
    if dev.type == "cpu":
        return closest_hit_plain(node_f, link, feat, *rays, cluster_k)
    outs = (torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev))
    if n == 0:
        return outs
    _launch("cluster_closest_hit", (node_f, link, feat), rays, outs,
            node_f.shape[0], cluster_k)
    cluster_closest_hit.launches += 1
    return outs


cluster_closest_hit.launches = 0


def cluster_any_hit(node_f, link, feat, ox, oy, oz, dx, dy, dz, t_max,
                    cluster_k: int):
    """Occlusion over the cluster cut tree: (N,) bool, True iff a triangle
    is hit at 0 < t <= t_max."""
    rays = (ox, oy, oz, dx, dy, dz, t_max)
    n, dev = _check(node_f, link, feat, rays, cluster_k)
    if dev.type == "cpu":
        return any_hit_plain(node_f, link, feat, *rays, cluster_k)
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return occ
    _launch("cluster_any_hit", (node_f, link, feat), rays, (occ,),
            node_f.shape[0], cluster_k)
    cluster_any_hit.launches += 1
    return occ


cluster_any_hit.launches = 0


def inst_cluster_closest_hit(node_f, link, feat, inst_inv, ox, oy, oz, dx,
                             dy, dz, t_max, cluster_k: int, fuel: int):
    """Closest hit over the TLAS and the instances' cut trees: (t (N,) f32,
    slot (N,) i32, inst (N,) i32); t = +inf, slot = inst = -1 on a miss.
    `fuel` caps a walk's steps (the scene's inst_mxu_fuel + 64)."""
    rays = (ox, oy, oz, dx, dy, dz, t_max)
    n, dev = _check(node_f, link, feat, rays, cluster_k, inst_inv)
    if dev.type == "cpu":
        return inst_closest_hit_plain(node_f, link, feat, inst_inv, *rays,
                                      cluster_k, fuel)
    outs = (torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev))
    if n == 0:
        return outs
    _launch("inst_cluster_closest_hit", (node_f, link, feat, inst_inv), rays,
            outs, fuel, cluster_k)
    inst_cluster_closest_hit.launches += 1
    return outs


inst_cluster_closest_hit.launches = 0


def inst_cluster_any_hit(node_f, link, feat, inst_inv, ox, oy, oz, dx, dy,
                         dz, t_max, cluster_k: int, fuel: int):
    """Occlusion over the TLAS and the instances' cut trees: (N,) bool,
    True iff a triangle of some instance is hit at 0 < t <= t_max."""
    rays = (ox, oy, oz, dx, dy, dz, t_max)
    n, dev = _check(node_f, link, feat, rays, cluster_k, inst_inv)
    if dev.type == "cpu":
        return inst_any_hit_plain(node_f, link, feat, inst_inv, *rays,
                                  cluster_k, fuel)
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return occ
    _launch("inst_cluster_any_hit", (node_f, link, feat, inst_inv), rays,
            (occ,), fuel, cluster_k)
    inst_cluster_any_hit.launches += 1
    return occ


inst_cluster_any_hit.launches = 0


def _empty_hits(n, dev, inst):
    """Closest-hit outputs: t, prim, u, v (and inst)."""
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    outs = (torch.empty(n, **f32), torch.empty(n, **i32),
            torch.empty(n, **f32), torch.empty(n, **f32))
    return outs + (torch.empty(n, **i32),) if inst else outs


def bvh_closest_hit(node, link, pair, prim, ox, oy, oz, dx, dy, dz, t_max,
                    fuel: int):
    """Closest hit over the BVH2, by the pair walk: (t, prim, u, v) (N,)
    each; t = +inf, prim = -1 and u = v = 0 on a miss, u = v = 0 on a
    sphere. `fuel` caps a walk's steps (the node count + 64: the threaded
    walk reaches each row at most once, so it cannot bind on a built
    table); the results equal the twin's wherever it does not bind."""
    rays = (ox, oy, oz, dx, dy, dz, t_max)
    n, dev = _check_bvh(node, link, pair, prim, rays, fuel)
    if dev.type == "cpu":
        return bvh_closest_hit_plain(node, link, pair, prim, *rays, fuel)
    outs = _empty_hits(n, dev, False)
    if n == 0:
        return outs
    _launch("bvh_closest_hit", (node, link, pair, prim), rays, outs, fuel)
    bvh_closest_hit.launches += 1
    return outs


bvh_closest_hit.launches = 0


def bvh_any_hit(node, link, pair, prim, ox, oy, oz, dx, dy, dz, t_max,
                fuel: int):
    """Occlusion over the BVH2, by the pair walk: (N,) bool, True iff a
    prim is hit at a finite 0 < t <= t_max. `fuel` caps a walk's steps
    (the node count + 64: the threaded walk reaches each row at most once,
    so it cannot bind on a built table); the results equal the twin's
    wherever it does not bind."""
    rays = (ox, oy, oz, dx, dy, dz, t_max)
    n, dev = _check_bvh(node, link, pair, prim, rays, fuel)
    if dev.type == "cpu":
        return bvh_any_hit_plain(node, link, pair, prim, *rays, fuel)
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return occ
    _launch("bvh_any_hit", (node, link, pair, prim), rays, (occ,), fuel)
    bvh_any_hit.launches += 1
    return occ


bvh_any_hit.launches = 0


def inst_bvh_closest_hit(node, link, pair, prim, inst_inv, inst_root, ox,
                         oy, oz, dx, dy, dz, t_max, fuel: int):
    """Closest hit over the stitched TLAS + BLAS BVH2 table, by the
    threaded walk in rounds (which does not read `pair`): (t, prim, u, v,
    inst); t = +inf, prim = inst = -1 and u = v = 0 on a miss. `fuel`
    caps a walk's steps (the scene's inst_fuel + 64)."""
    rays = (ox, oy, oz, dx, dy, dz, t_max)
    n, dev = _check_bvh(node, link, pair, prim, rays, fuel, inst_inv,
                        inst_root)
    if dev.type == "cpu":
        return inst_bvh_closest_hit_plain(node, link, pair, prim, inst_inv,
                                          inst_root, *rays, fuel)
    outs = _empty_hits(n, dev, True)
    if n == 0:
        return outs
    _launch("inst_bvh_closest_hit", (node, link, prim, inst_inv, inst_root),
            rays, outs, fuel)
    inst_bvh_closest_hit.launches += 1
    return outs


inst_bvh_closest_hit.launches = 0


def inst_bvh_any_hit(node, link, pair, prim, inst_inv, inst_root, ox, oy,
                     oz, dx, dy, dz, t_max, fuel: int):
    """Occlusion over the stitched TLAS + BLAS BVH2 table, by the pair
    walk: (N,) bool. `fuel` caps a walk's steps (the scene's inst_fuel +
    64, which the threaded walk cannot reach on a built table); the
    results equal the twin's wherever it does not bind."""
    rays = (ox, oy, oz, dx, dy, dz, t_max)
    n, dev = _check_bvh(node, link, pair, prim, rays, fuel, inst_inv,
                        inst_root)
    if dev.type == "cpu":
        return inst_bvh_any_hit_plain(node, link, pair, prim, inst_inv,
                                      inst_root, *rays, fuel)
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return occ
    _launch("inst_bvh_any_hit",
            (node, link, pair, prim, inst_inv, inst_root), rays, (occ,),
            fuel)
    inst_bvh_any_hit.launches += 1
    return occ


inst_bvh_any_hit.launches = 0


def bvh8_closest_hit(child, order, prim, ox, oy, oz, dx, dy, dz, t_max,
                     stack: int, fuel: int):
    """Closest hit over the BVH8 tree, prim leaves (K6): (t, prim, u, v)
    (N,) each; t = +inf, prim = -1 and u = v = 0 on a miss, u = v = 0 on a
    sphere. `stack` is the tree's depth + 2, `fuel` caps a walk's steps."""
    rays = (ox, oy, oz, dx, dy, dz, t_max)
    n, dev = _check_bvh8(child, order, prim, rays, stack, fuel)
    if dev.type == "cpu":
        return bvh8_closest_hit_plain(child, order, prim, *rays, stack, fuel)
    outs = _empty_hits(n, dev, False)
    if n == 0:
        return outs
    _launch("bvh8_closest_hit", (child, order, prim), rays, outs, fuel)
    bvh8_closest_hit.launches += 1
    return outs


bvh8_closest_hit.launches = 0


def bvh8_any_hit(child, order, prim, ox, oy, oz, dx, dy, dz, t_max,
                 stack: int, fuel: int):
    """Occlusion over the BVH8 tree, prim leaves (K6): (N,) bool, True iff
    a prim is hit at a finite 0 < t <= t_max."""
    rays = (ox, oy, oz, dx, dy, dz, t_max)
    n, dev = _check_bvh8(child, order, prim, rays, stack, fuel)
    if dev.type == "cpu":
        return bvh8_any_hit_plain(child, order, prim, *rays, stack, fuel)
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return occ
    _launch("bvh8_any_hit", (child, order, prim), rays, (occ,), fuel)
    bvh8_any_hit.launches += 1
    return occ


bvh8_any_hit.launches = 0


def bvh8mxu_closest_hit(child, order, feat, ox, oy, oz, dx, dy, dz, t_max,
                        cluster_k: int, stack: int, fuel: int):
    """Closest hit over the BVH8 collapse of the cut tree, cluster leaves
    (K7): (t (N,) f32, slot (N,) i32), t = +inf and slot = -1 on a
    miss."""
    rays = (ox, oy, oz, dx, dy, dz, t_max)
    n, dev = _check_bvh8(child, order, feat, rays, stack, fuel, cluster_k)
    if dev.type == "cpu":
        return bvh8mxu_closest_hit_plain(child, order, feat, *rays,
                                         cluster_k, stack, fuel)
    outs = (torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev))
    if n == 0:
        return outs
    _launch("bvh8mxu_closest_hit", (child, order, feat), rays, outs, fuel,
            cluster_k)
    bvh8mxu_closest_hit.launches += 1
    return outs


bvh8mxu_closest_hit.launches = 0


def bvh8mxu_any_hit(child, order, feat, ox, oy, oz, dx, dy, dz, t_max,
                    cluster_k: int, stack: int, fuel: int):
    """Occlusion over the BVH8 collapse of the cut tree (K7): (N,) bool,
    True iff a triangle is hit at 0 < t <= t_max."""
    rays = (ox, oy, oz, dx, dy, dz, t_max)
    n, dev = _check_bvh8(child, order, feat, rays, stack, fuel, cluster_k)
    if dev.type == "cpu":
        return bvh8mxu_any_hit_plain(child, order, feat, *rays, cluster_k,
                                     stack, fuel)
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return occ
    _launch("bvh8mxu_any_hit", (child, order, feat), rays, (occ,), fuel,
            cluster_k)
    bvh8mxu_any_hit.launches += 1
    return occ


bvh8mxu_any_hit.launches = 0


def dense_closest_hit(ccs, count, feat, ox, oy, oz, dx, dy, dz, t_max,
                      cluster_k: int):
    """Closest hit by the dense sweep (K8), every cluster (its slots below
    its `count`, mxu_ccount) against every ray: (t (N,) f32, slot (N,)
    i32), t = +inf and slot = -1 on a miss."""
    rays = (ox, oy, oz, dx, dy, dz, t_max)
    n, dev = _check_dense(ccs, count, feat, rays, cluster_k)
    if dev.type == "cpu":
        return dense_closest_hit_plain(ccs, count, feat, *rays, cluster_k)
    outs = (torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev))
    if n == 0:
        return outs
    _launch("dense_closest_hit", (ccs, count, feat), rays, outs,
            ccs.shape[0], cluster_k)
    dense_closest_hit.launches += 1
    return outs


dense_closest_hit.launches = 0


def dense_any_hit(ccs, count, feat, ox, oy, oz, dx, dy, dz, t_max,
                  cluster_k: int):
    """Occlusion by the dense sweep (K8): (N,) bool, True iff a triangle
    is hit at 0 < t <= t_max."""
    rays = (ox, oy, oz, dx, dy, dz, t_max)
    n, dev = _check_dense(ccs, count, feat, rays, cluster_k)
    if dev.type == "cpu":
        return dense_any_hit_plain(ccs, count, feat, *rays, cluster_k)
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return occ
    _launch("dense_any_hit", (ccs, count, feat), rays, (occ,),
            ccs.shape[0], cluster_k)
    dense_any_hit.launches += 1
    return occ


dense_any_hit.launches = 0


# ---------------------------------------------------------------------------
# Plain twins: a vectorised lane walk, each lane with its own cursor. The
# plane dots are elementwise products and sums (no matmul, so no TF32).
# ---------------------------------------------------------------------------

def _safe_inv(d):
    return 1.0 / torch.where(d.abs() < 1e-20,
                             torch.where(d >= 0, 1e-20, -1e-20), d)


def _slab(nf, ox, oy, oz, ix, iy, iz, t_best):
    """Box rows nf[..., 0:6] against rays that broadcast with nf[..., 0]."""
    t0x = (nf[..., 0] - ox) * ix
    t1x = (nf[..., 3] - ox) * ix
    t0y = (nf[..., 1] - oy) * iy
    t1y = (nf[..., 4] - oy) * iy
    t0z = (nf[..., 2] - oz) * iz
    t1z = (nf[..., 5] - oz) * iz
    tmin = torch.maximum(torch.maximum(torch.minimum(t0x, t1x),
                                       torch.minimum(t0y, t1y)),
                         torch.minimum(t0z, t1z))
    tmax = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                       torch.maximum(t0y, t1y)),
                         torch.maximum(t0z, t1z))
    return (tmin <= tmax) & (tmax > 0.0) & (tmin < t_best)


def _cluster_planes(f, c, ox, oy, oz, dx, dy, dz):
    """Plane rows `f` of CK slots, (m, CK, 20) or (CK, 20) shared by every
    lane, against each lane's ray recentred at its cluster's centroid
    c = (cx, cy, cz) ((m,) each, or 0-d): (u, v, t, inv) as (m, CK)
    tensors."""
    cx, cy, cz = c
    px, py, pz = (ox - cx)[:, None], (oy - cy)[:, None], (oz - cz)[:, None]
    dx, dy, dz = dx[:, None], dy[:, None], dz[:, None]
    mx = py * dz - pz * dy
    my = pz * dx - px * dz
    mz = px * dy - py * dx
    det = f[..., 0] * dx + f[..., 1] * dy + f[..., 2] * dz
    unum = (f[..., 3] * dx + f[..., 4] * dy + f[..., 5] * dz
            + f[..., 6] * mx + f[..., 7] * my + f[..., 8] * mz)
    vnum = (f[..., 9] * dx + f[..., 10] * dy + f[..., 11] * dz
            + f[..., 12] * mx + f[..., 13] * my + f[..., 14] * mz)
    tnum = f[..., 15] * px + f[..., 16] * py + f[..., 17] * pz + f[..., 18]
    inv = torch.where(det.abs() < 1e-12, 0.0, 1.0 / det)
    return unum * inv, vnum * inv, tnum * inv, inv


def _slot_rows(feat, base, cluster_k):
    """The plane rows of the clusters at slot bases `base` ((m,)):
    (m, CK, 20)."""
    return feat[base[:, None] + torch.arange(cluster_k, device=base.device)]


def _cluster_visit(f, base, c, ray, tl, cluster_k, any_hit, stats,
                   tile=None):
    """One cluster visit of each of m lanes: the CK slots of plane rows `f`
    (_cluster_planes': each lane's cluster, or one shared by all) from slot
    `base` ((m,), or an int), the lanes' rays (ox, oy, oz, dx, dy, dz)
    recentred at the centroid `c`, against their limits `tl`. Any hit:
    (hit, the slots tested) (m,) each, hit: a slot hit at t <= tl; the
    kernel tests `tile` slots a pass (a warp-cooperative visit's tile, or
    1 for a thread alone), so a ray's tests end with the pass of its
    first hit. Closest hit:
    (closer, t, slot) (m,) each, the nearest slot strictly under tl, the
    lowest on a tie. Counts the slot tests the kernels make (`slot_tests`,
    padding included) and those of real slots up to a first hit
    (`real_slot_tests`: a padding slot's plane row is all zero)."""
    m = ray[0].numel()
    _count(stats, "cluster_visits", m)
    u, v, t, inv = _cluster_planes(f, c, *ray)
    ok = ((inv != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > 0.0))
    tl = tl[:, None]
    k = torch.arange(cluster_k, device=f.device)
    # slots 0..k needed, k the first hit; tested, the same or whole tiles
    needed = torch.full((m,), cluster_k, dtype=torch.int64, device=f.device)
    if any_hit:
        hm = ok & (t <= tl)
        h = hm.any(1)
        needed = torch.where(h, hm.int().argmax(1) + 1, needed)
    tested = (needed if tile is None else
              (-(-needed // tile) * tile).clamp(max=cluster_k))
    if stats is not None:
        real = (f != 0.0).any(-1)
        _count(stats, "slot_tests", int(tested.sum()))
        _count(stats, "real_slot_tests",
               int((real & (k < needed[:, None])).sum()))
    if any_hit:
        return h, tested
    ok = ok & (t < tl)
    t_m = torch.where(ok, t, float("inf"))
    t_c = t_m.amin(1)
    win = ok & (t_m <= t_c[:, None])
    k_c = torch.where(win, k, 1 << 30).amin(1)  # lowest slot wins
    return t_c < tl[:, 0], t_c, base + k_c


def _octant(dx, dy, dz):
    return ((dx < 0).long() | ((dy < 0).long() << 1)
            | ((dz < 0).long() << 2))


def _to_local(it, ox, oy, oz, dx, dy, dz):
    """World rays -> instance space from (m, 16) inst_inv rows, in the
    kernels' order of operations; d stays unnormalised, so t is kept."""
    return (it[:, 0] * ox + it[:, 1] * oy + it[:, 2] * oz + it[:, 3],
            it[:, 4] * ox + it[:, 5] * oy + it[:, 6] * oz + it[:, 7],
            it[:, 8] * ox + it[:, 9] * oy + it[:, 10] * oz + it[:, 11],
            it[:, 0] * dx + it[:, 1] * dy + it[:, 2] * dz,
            it[:, 4] * dx + it[:, 5] * dy + it[:, 6] * dz,
            it[:, 8] * dx + it[:, 9] * dy + it[:, 10] * dz)


def _count(stats, key, k):
    if stats is not None:
        stats[key] = stats.get(key, 0) + k


def _group_rows(lanes, n_vis, base, loaded):
    """The warp-cooperative walks' visits of `lanes` ((m,) each: the lane's
    visit number, the cluster's slot base, the slots up to the last tile
    its ray is tested on) as _count_groups' rows; moves n_vis on."""
    rows = torch.stack([lanes // WARP, n_vis[lanes], base, loaded], 1)
    n_vis[lanes] += 1
    return rows


def _count_groups(stats, groups):
    """The kernels' warps serve the visits due in a round together, and a
    lane's j-th visit falls in round j: a warp loads a cluster's plane rows
    once for each (warp, j, cluster) (csrc/cluster_walk.cu::warp_visit),
    counted as `cluster_groups`, tile by tile up to the last tile one of
    the group's rays is tested on: `loaded_slots`. `groups`: a list of
    _group_rows' rows."""
    if not groups:
        return
    g = torch.cat(groups)
    key, inv = torch.unique(g[:, :3], dim=0, return_inverse=True)
    rows = torch.zeros(key.shape[0], dtype=torch.int64, device=g.device)
    rows.scatter_reduce_(0, inv, g[:, 3], "amax")
    _count(stats, "cluster_groups", key.shape[0])
    _count(stats, "loaded_slots", int(rows.sum()))


def _walk_plain(node_f, link, feat, rays, cluster_k, any_hit, stats,
                inst_inv=None, fuel=None):
    """The kernels' walk for every lane at once, each lane with its own
    cursor. With `inst_inv` it is the instanced walk: a lane entering an
    instance leaf saves the leaf's miss link, continues at the group's
    cut-tree root with its ray in instance space, and at a BLAS_EXIT link
    pops back to the saved row and its world ray."""
    ox, oy, oz, dx, dy, dz, t_max = rays
    n, dev = ox.shape[0], ox.device
    # the lane's ray in its current space: o, d, 1/d and the octant
    world = [ox, oy, oz, dx, dy, dz, _safe_inv(dx), _safe_inv(dy),
             _safe_inv(dz), _octant(dx, dy, dz)]
    inst = inst_inv is not None
    cur = [a.clone() for a in world] if inst else world
    # lanes with t_max <= 0 cannot hit (0 < t < t_max): they never walk
    node = torch.where(t_max > 0, 0, -1).long()
    t_best = t_max.clone()
    best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    if inst:
        ret = torch.full((n,), -1, dtype=torch.int64, device=dev)
        cinst = torch.full((n,), -1, dtype=torch.int64, device=dev)
        binst = torch.full((n,), -1, dtype=torch.int64, device=dev)
    # each lane's visits so far, and the warps' groups (_count_groups)
    groups = [] if stats is not None else None
    n_vis = torch.zeros(n, dtype=torch.int64, device=dev)
    for _ in range(node_f.shape[0] + 64 if fuel is None else fuel):
        act = torch.nonzero(node >= 0).squeeze(1)
        if act.numel() == 0:
            break
        lox, loy, loz, ldx, ldy, ldz, lix, liy, liz, loc = \
            (a[act] for a in cur)
        nd = node[act]
        nf = node_f[nd]
        lk = link[nd]
        hit_l = lk.gather(1, loc[:, None]).squeeze(1).long()
        miss_l = lk.gather(1, loc[:, None] + 8).squeeze(1).long()
        tb = t_max[act] if any_hit else t_best[act]
        hit = _slab(nf, lox, loy, loz, lix, liy, liz, tb)
        base = nf[:, 6].long()
        is_cl = base >= 0
        nxt = torch.where(is_cl | ~hit, miss_l, hit_l)
        _count(stats, "node_steps", act.numel())
        visit = is_cl & hit
        if bool(visit.any()):
            lanes = act[visit]
            vb, vc = base[visit], nf[visit]
            res = _cluster_visit(
                _slot_rows(feat, vb, cluster_k), vb, vc[:, 8:11].unbind(1),
                [a[visit] for a in (lox, loy, loz, ldx, ldy, ldz)],
                tb[visit], cluster_k, any_hit, stats,
                INST_ANY_TILE if inst and any_hit else TILE)
            if any_hit:
                res, tested = res
            if groups is not None:
                groups.append(_group_rows(
                    lanes, n_vis, vb,
                    tested if any_hit else torch.full_like(vb, cluster_k)))
            if any_hit:
                occ[lanes[res]] = True
                nxt[visit.nonzero().squeeze(1)[res]] = -1  # stop at a hit
            else:
                closer, t_c, slot = res
                sel = lanes[closer]
                t_best[sel] = t_c[closer]
                best[sel] = slot[closer]
                if inst:
                    binst[sel] = cinst[sel]
        if inst:
            iid = nf[:, 7].long()
            enter = ~is_cl & (iid >= 0) & hit
            if bool(enter.any()):
                e = act[enter]
                _count(stats, "instance_entries", e.numel())
                it = inst_inv[iid[enter]]
                loc_ray = _to_local(it, *(a[e] for a in world[:6]))
                for k_, a in enumerate(loc_ray):
                    cur[k_][e] = a
                for k_ in range(3):
                    cur[6 + k_][e] = _safe_inv(loc_ray[3 + k_])
                cur[9][e] = _octant(*loc_ray[3:])
                ret[e] = miss_l[enter]
                cinst[e] = iid[enter]
                nxt[enter] = it[:, 13].long()
            pop = nxt == BLAS_EXIT
            if bool(pop.any()):
                p_ = act[pop]
                nxt[pop] = ret[p_]
                ret[p_] = -1
                cinst[p_] = -1
                for c_, w_ in zip(cur, world):
                    c_[p_] = w_[p_]
        node[act] = nxt
    _count_groups(stats, groups)
    if any_hit:
        return occ
    t_out = torch.where(best >= 0, t_best, float("inf"))
    if inst:
        return (t_out, best.to(torch.int32),
                torch.where(best >= 0, binst, -1).to(torch.int32))
    return t_out, best.to(torch.int32)


def _chunked(fn, rays, chunk, unit=WARP):
    # whole warps (or `unit`s of lanes) to a chunk, so that what a twin
    # counts per warp (or per thread of the dense sweep) holds
    chunk = -(-chunk // unit) * unit
    n = rays[0].shape[0]
    outs = [fn(tuple(a[s:s + chunk] for a in rays))
            for s in range(0, n, chunk)] or [fn(rays)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def closest_hit_plain(node_f, link, feat, ox, oy, oz, dx, dy, dz, t_max,
                      cluster_k: int, chunk: int = 8192, stats=None):
    """The twin of the closest-hit kernel: same function, torch ops. With
    a `stats` dict it also counts the kernel's work: node steps, cluster
    visits, slot tests, the warps' groups of visits to one cluster
    (`cluster_groups`) and the slots whose plane rows they load
    (`loaded_slots`: every slot of the cluster, once a group)."""
    return _chunked(
        lambda r: _walk_plain(node_f, link, feat, r, cluster_k, False, stats),
        (ox, oy, oz, dx, dy, dz, t_max), chunk)


def any_hit_plain(node_f, link, feat, ox, oy, oz, dx, dy, dz, t_max,
                  cluster_k: int, chunk: int = 8192, stats=None):
    """The twin of the any-hit kernel. Its `stats` count a ray's slot
    tests in whole tiles up to its first hit, where the kernel's warp
    stops testing it, and a group's loaded slots up to the tile where its
    last ray hits, or all of them."""
    return _chunked(
        lambda r: _walk_plain(node_f, link, feat, r, cluster_k, True, stats),
        (ox, oy, oz, dx, dy, dz, t_max), chunk)


def inst_closest_hit_plain(node_f, link, feat, inst_inv, ox, oy, oz, dx, dy,
                           dz, t_max, cluster_k: int, fuel: int,
                           chunk: int = 8192, stats=None):
    """The twin of the instanced closest-hit kernel: (t, slot, inst). Its
    `stats` also count instance entries."""
    return _chunked(
        lambda r: _walk_plain(node_f, link, feat, r, cluster_k, False, stats,
                              inst_inv, fuel),
        (ox, oy, oz, dx, dy, dz, t_max), chunk)


def inst_any_hit_plain(node_f, link, feat, inst_inv, ox, oy, oz, dx, dy, dz,
                       t_max, cluster_k: int, fuel: int, chunk: int = 8192,
                       stats=None):
    """The twin of the instanced any-hit kernel."""
    return _chunked(
        lambda r: _walk_plain(node_f, link, feat, r, cluster_k, True, stats,
                              inst_inv, fuel),
        (ox, oy, oz, dx, dy, dz, t_max), chunk)


def _prim_test(pr, ox, oy, oz, dx, dy, dz):
    """(m,) lanes against their (m, 12) prim rows, in the kernels' order of
    operations: (t, u, v, is_tri), t = +inf where missed. Triangles by
    Möller–Trumbore, spheres (center p0, radius e1.x) by the stable
    quadratic, u = v = 0 for a sphere."""
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z, typ = pr[:, :10].unbind(1)
    ray = (ox, oy, oz, dx, dy, dz)
    t, u, v = tri_test(p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z, *ray)
    t_s = sphere_test(p0x, p0y, p0z, e1x, *ray)
    is_tri = typ == PRIM_TRI
    return (torch.where(is_tri, t, t_s), torch.where(is_tri, u, 0.0),
            torch.where(is_tri, v, 0.0), is_tri)


def _leaf_prims(prim, start, count, ray, tl, any_hit, stats):
    """One leaf visit of each of m lanes: up to LEAF_K prims from `start`
    (`count` of them) tested in order against the lanes' rays (ox, oy, oz,
    dx, dy, dz). Any hit: (m,) bool, a finite t <= tl (the thread stops at
    its first, so the tests counted end there). Closest hit: (closer, t,
    prim, u, v) (m,) each, the prim nearest strictly under tl, the first in
    leaf order on a tie."""
    m, dev = start.numel(), start.device
    live = torch.ones(m, dtype=torch.bool, device=dev)
    t_b = tl.clone()
    best = torch.full((m,), -1, dtype=torch.int64, device=dev)
    bu = torch.zeros(m, dtype=torch.float32, device=dev)
    bv = torch.zeros(m, dtype=torch.float32, device=dev)
    for k in range(LEAF_K if m else 0):
        sel = torch.nonzero((k < count) & live).squeeze(1)
        if sel.numel() == 0:
            break
        pid = start[sel] + k
        t, u, v, is_tri = _prim_test(prim[pid], *(a[sel] for a in ray))
        n_tri = int(is_tri.sum())
        _count(stats, "tri_tests", n_tri)
        _count(stats, "sphere_tests", sel.numel() - n_tri)
        if any_hit:
            live[sel[torch.isfinite(t) & (t <= tl[sel])]] = False
        else:
            closer = t < t_b[sel]
            c = sel[closer]
            t_b[c] = t[closer]
            best[c] = pid[closer]
            bu[c] = u[closer]
            bv[c] = v[closer]
    if any_hit:
        return ~live
    return best >= 0, t_b, best, bu, bv


class _LeafRounds:
    """The rounds of K4's and K6's closest-hit warps (csrc/cluster_walk.cu::
    warp_leaf_visit): a lane walks up to `steps` steps a round and stops
    at the step that reaches a due leaf, so a lane's j-th such stretch of
    steps falls in its warp's j-th round, where the warp tests the round's
    due (ray, prim) pairs together, 32 a pass. Lanes are chunk-local, whole
    warps to a chunk. Counts ceil(pairs / 32) passes for each round of a
    warp with a due leaf: `leaf_passes`."""

    def __init__(self, n, dev, steps):
        self.steps = steps
        self.round = torch.zeros(n, dtype=torch.int64, device=dev)
        self.taken = torch.zeros(n, dtype=torch.int64, device=dev)
        self.rows = []

    def walk(self, lanes):
        """`lanes` take a step; a lane whose last step was its round's
        last starts a new round."""
        full = self.taken >= self.steps
        self.round += full.long()
        self.taken[full] = 0
        self.taken[lanes] += 1

    def leaves(self, lanes, count):
        """`lanes` reached leaves of `count` prims at their last step,
        which ends their round."""
        self.rows.append(torch.stack([lanes // WARP, self.round[lanes],
                                      count], 1))
        self.round[lanes] += 1
        self.taken[lanes] = 0

    def count(self, stats):
        if not self.rows:
            return
        g = torch.cat(self.rows)
        key, inv = torch.unique(g[:, :2], dim=0, return_inverse=True)
        pairs = torch.zeros(key.shape[0], dtype=torch.int64,
                            device=g.device).scatter_add_(0, inv, g[:, 2])
        _count(stats, "leaf_passes", int((-(-pairs // WARP)).sum()))


class _PairWalk:
    """The work of the pair walk (csrc/cluster_walk.cu::bvh_pair_walk: K3's
    closest and any hit, K4's any hit), read off the threaded walk, which
    reaches the same nodes in the same order: a lane's root test (and one an
    instance entry: `root_tests`); each inner node whose slab it hits is a
    pair-row expansion (`pair_rows`), which pushes the far child (its row
    here) where both children's slabs, from the pair row, pass at that
    step; a step at the row on top of the stack is its pop (`pops`, a
    failed re-cull included). A push that finds `cap` entries hands the
    lane to the threaded walk: its later steps are `fallback_steps`, and
    `fallback_rets` counts the hand-overs inside an instance, which load
    the TLAS leaf's miss link."""

    def __init__(self, pair, n, dev, cap, live):
        self.pair, self.cap = pair, cap
        self.stack = torch.zeros((n, cap), dtype=torch.int64, device=dev)
        self.depth = torch.zeros(n, dtype=torch.int64, device=dev)
        self.fell = torch.zeros(n, dtype=torch.bool, device=dev)
        self.n = dict(root_tests=int(live.sum()), pair_rows=0, pops=0,
                      fallback_steps=0, fallback_rets=0)

    def step(self, act, nd, inner_hit, ray, lim, in_inst):
        """`act` lanes take a threaded step at rows `nd`; `inner_hit`: at
        an inner node whose slab they hit; `ray`: their (ox, oy, oz, ix,
        iy, iz, octant) in the current space; `lim`: their slab limit;
        `in_inst`: inside an instance (or None)."""
        fell = self.fell[act]
        self.n["fallback_steps"] += int(fell.sum())
        d = self.depth[act]
        pop = ~fell & (d > 0) & (
            self.stack[act, (d - 1).clamp_min(0)] == nd)
        self.n["pops"] += int(pop.sum())
        self.depth[act[pop]] -= 1
        e = ~fell & inner_hit
        self.n["pair_rows"] += int(e.sum())
        pr = self.pair[nd[e]]
        box = pr.view(torch.float32)
        r = [a[e] for a in ray[:6]]
        both = (_slab(box[:, 0:6], *r, lim[e])
                & _slab(box[:, 8:14], *r, lim[e]))
        if not bool(both.any()):
            return
        lanes = act[e][both]
        word0 = pr[both, 7].long() & 0xFFFFFFFF
        first1 = ((word0 >> (PAIR_ROW_BITS + ray[6][e][both])) & 1) == 1
        far = torch.where(first1, word0 & ((1 << PAIR_ROW_BITS) - 1),
                          pr[both, 15].long())
        full = self.depth[lanes] >= self.cap
        self.fell[lanes[full]] = True
        if in_inst is not None:
            self.n["fallback_rets"] += int((in_inst[e][both] & full).sum())
        lanes, far = lanes[~full], far[~full]
        self.stack[lanes, self.depth[lanes]] = far
        self.depth[lanes] += 1

    def entered(self, lanes):
        """`lanes` entered an instance: the BLAS root's test."""
        self.n["root_tests"] += int((~self.fell[lanes]).sum())

    def count(self, stats):
        for k, v in self.n.items():
            _count(stats, k, v)


def _bvh_walk_plain(node, link, pair, prim, rays, any_hit, stats, fuel,
                    inst_inv=None, inst_root=None, pair_stack=None):
    """The BVH2 kernels' walk for every lane at once, each lane with its
    own cursor and octant: a leaf whose box the lane hits tests its prims
    in order (closest hit: strictly closer replaces, so the lowest prim of
    a leaf keeps a tie; any hit: the first finite t <= t_max ends the
    walk) and continues at its miss link. With `inst_inv` it is the
    instanced walk: a TLAS leaf (count 0) moves the lane's ray to
    instance space, saves the leaf's miss link and continues at the
    instance's BLAS root (`inst_root`); a BLAS_EXIT link pops back. The
    instanced closest hit also counts its warps' passes over their
    rounds' due prims (`leaf_passes`: _LeafRounds); the twins of the pair
    walk (`pair_stack`: its stack's entries) its work (_PairWalk)."""
    ox, oy, oz, dx, dy, dz, t_max = rays
    n, dev = ox.shape[0], ox.device
    world = [ox, oy, oz, dx, dy, dz, _safe_inv(dx), _safe_inv(dy),
             _safe_inv(dz), _octant(dx, dy, dz)]
    inst = inst_inv is not None
    cur = [a.clone() for a in world] if inst else world
    # lanes with t_max <= 0 cannot hit (0 < t < t_max): they never walk
    node_i = torch.where(t_max > 0, 0, -1).long()
    t_best = t_max.clone()
    best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    bu = torch.zeros(n, dtype=torch.float32, device=dev)
    bv = torch.zeros(n, dtype=torch.float32, device=dev)
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    if inst:
        ret = torch.full((n,), -1, dtype=torch.int64, device=dev)
        cinst = torch.full((n,), -1, dtype=torch.int64, device=dev)
        binst = torch.full((n,), -1, dtype=torch.int64, device=dev)
    rounds = (_LeafRounds(n, dev, BVH_ROUND_STEPS)
              if stats is not None and inst and not any_hit else None)
    pw = (_PairWalk(pair, n, dev, pair_stack, t_max > 0)
          if stats is not None and pair_stack is not None else None)
    for _ in range(fuel):
        act = torch.nonzero(node_i >= 0).squeeze(1)
        if act.numel() == 0:
            break
        if rounds is not None:
            rounds.walk(act)
        lox, loy, loz, ldx, ldy, ldz, lix, liy, liz, loc = \
            (a[act] for a in cur)
        nf = node[node_i[act]]
        lk = link[node_i[act]]
        hit_l = lk.gather(1, loc[:, None]).squeeze(1).long()
        miss_l = lk.gather(1, loc[:, None] + 8).squeeze(1).long()
        hit = _slab(nf, lox, loy, loz, lix, liy, liz,
                    t_max[act] if any_hit else t_best[act])
        start, count = nf[:, 6].long(), nf[:, 7].long()
        is_leaf = start >= 0
        nxt = torch.where(is_leaf | ~hit, miss_l, hit_l)
        _count(stats, "node_steps", act.numel())
        if pw is not None:
            pw.step(act, node_i[act], ~is_leaf & hit,
                    (lox, loy, loz, lix, liy, liz, loc),
                    t_max[act] if any_hit else t_best[act],
                    cinst[act] >= 0 if inst else None)
        vi = torch.nonzero(is_leaf & (count > 0) & hit).squeeze(1)
        if vi.numel():
            lanes = act[vi]
            res = _leaf_prims(
                prim, start[vi], count[vi],
                [a[vi] for a in (lox, loy, loz, ldx, ldy, ldz)],
                t_max[lanes] if any_hit else t_best[lanes], any_hit, stats)
            if any_hit:
                occ[lanes[res]] = True
                nxt[vi[res]] = -1           # stop at the first hit
            else:
                if rounds is not None:
                    rounds.leaves(lanes, count[vi])
                closer, t, pid, u, v = res
                lc = lanes[closer]
                t_best[lc] = t[closer]
                best[lc] = pid[closer]
                bu[lc] = u[closer]
                bv[lc] = v[closer]
                if inst:
                    binst[lc] = cinst[lc]
        if inst:
            enter = is_leaf & (count == 0) & hit
            if bool(enter.any()):
                e = act[enter]
                iid = start[enter]
                _count(stats, "instance_entries", e.numel())
                if pw is not None:
                    pw.entered(e)
                loc_ray = _to_local(inst_inv[iid], *(a[e] for a in world[:6]))
                for k_, a in enumerate(loc_ray):
                    cur[k_][e] = a
                for k_ in range(3):
                    cur[6 + k_][e] = _safe_inv(loc_ray[3 + k_])
                cur[9][e] = _octant(*loc_ray[3:])
                ret[e] = miss_l[enter]
                cinst[e] = iid
                nxt[enter] = inst_root[iid].long()
            pop = nxt == BLAS_EXIT
            if bool(pop.any()):
                p_ = act[pop]
                nxt[pop] = ret[p_]
                ret[p_] = -1
                cinst[p_] = -1
                for c_, w_ in zip(cur, world):
                    c_[p_] = w_[p_]
        node_i[act] = nxt
    if rounds is not None:
        rounds.count(stats)
    if pw is not None:
        pw.count(stats)
    if any_hit:
        return occ
    found = best >= 0
    outs = (torch.where(found, t_best, float("inf")), best.to(torch.int32),
            bu, bv)
    if inst:
        return outs + (torch.where(found, binst, -1).to(torch.int32),)
    return outs


def bvh_closest_hit_plain(node, link, pair, prim, ox, oy, oz, dx, dy, dz,
                          t_max, fuel: int, chunk: int = 8192, stats=None,
                          pair_stack: int = BVH_PAIR_STACK):
    """The twin of the BVH2 closest-hit kernel: (t, prim, u, v). With a
    `stats` dict it also counts the walk's work: node steps (the threaded
    walk's, which the bound charges), triangle tests and sphere tests, and
    the pair walk's work with a stack of `pair_stack` entries
    (_PairWalk)."""
    return _chunked(
        lambda r: _bvh_walk_plain(node, link, pair, prim, r, False, stats,
                                  fuel, pair_stack=pair_stack),
        (ox, oy, oz, dx, dy, dz, t_max), chunk)


def bvh_any_hit_plain(node, link, pair, prim, ox, oy, oz, dx, dy, dz, t_max,
                      fuel: int, chunk: int = 8192, stats=None,
                      pair_stack: int = BVH_PAIR_STACK):
    """The twin of the BVH2 any-hit kernel. Its `stats` count a lane's
    prim tests up to its first hit, where the kernel's thread stops, and
    the pair walk's work with a stack of `pair_stack` entries
    (_PairWalk)."""
    return _chunked(
        lambda r: _bvh_walk_plain(node, link, pair, prim, r, True, stats,
                                  fuel, pair_stack=pair_stack),
        (ox, oy, oz, dx, dy, dz, t_max), chunk)


def inst_bvh_closest_hit_plain(node, link, pair, prim, inst_inv, inst_root,
                               ox, oy, oz, dx, dy, dz, t_max, fuel: int,
                               chunk: int = 8192, stats=None):
    """The twin of the instanced BVH2 closest-hit kernel: (t, prim, u, v,
    inst). Its `stats` also count instance entries and the warps' leaf
    passes (`leaf_passes`)."""
    return _chunked(
        lambda r: _bvh_walk_plain(node, link, pair, prim, r, False, stats,
                                  fuel, inst_inv, inst_root),
        (ox, oy, oz, dx, dy, dz, t_max), chunk)


def inst_bvh_any_hit_plain(node, link, pair, prim, inst_inv, inst_root, ox,
                           oy, oz, dx, dy, dz, t_max, fuel: int,
                           chunk: int = 8192, stats=None,
                           pair_stack: int = BVH_PAIR_STACK):
    """The twin of the instanced BVH2 any-hit kernel. Its `stats` also
    count instance entries and the pair walk's work with a stack of
    `pair_stack` entries (_PairWalk)."""
    return _chunked(
        lambda r: _bvh_walk_plain(node, link, pair, prim, r, True, stats,
                                  fuel, inst_inv, inst_root, pair_stack),
        (ox, oy, oz, dx, dy, dz, t_max), chunk)


# lowest set bit of an 8-bit mask (0 for an empty one)
_LOW_BIT = torch.tensor([(m & -m).bit_length() - 1 if m else 0
                         for m in range(256)])


def _bvh8_walk_plain(child, order, leaf, rays, any_hit, stats, stack, fuel,
                     cluster_k=None):
    """The BVH8 kernels' walk for every lane at once, each lane with its
    own node, mask, stack and octant, one step of the kernels' loop an
    iteration: a fresh visit slab-tests the node's 8 children in the
    octant's order (bit j of the mask: position j of that order); a step
    pops on an empty mask (an empty stack ends the lane's walk), else
    advances the lowest set bit: closest hit re-culls that child, a leaf
    child is tested (cluster_k None: its prims, K6; else its cluster's
    slots, K7), an inner child is descended into, the parent pushed only
    if its mask is not yet empty. Counts fresh visits and the non-empty
    children they test (`child_tests`), advances, pushes, pops (resumes
    from the stack), prim tests or cluster visits and slot tests. K7's
    kernels visit clusters warp-cooperatively (BVH8C_TILE slots a pass)
    as K1's do, and the twin counts their groups and loads as _walk_plain
    does (`cluster_groups`, `loaded_slots`: _count_groups); K6's closest
    hit tests its rounds' due prims with the whole warp, and the twin
    counts those passes (`leaf_passes`: _LeafRounds)."""
    ox, oy, oz, dx, dy, dz, t_max = rays
    n, dev = ox.shape[0], ox.device
    ray = (ox, oy, oz, dx, dy, dz)
    ix, iy, iz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)
    oc = _octant(dx, dy, dz)
    # lanes with t_max <= 0 cannot hit (0 < t < t_max): they never walk
    cur = torch.where(t_max > 0, 0, -1).long()
    mask = torch.zeros(n, dtype=torch.int64, device=dev)
    fresh = torch.ones(n, dtype=torch.bool, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    stk = torch.zeros((n, stack), dtype=torch.int64, device=dev)
    perm = torch.zeros((n, 8), dtype=torch.int64, device=dev)
    t_best = t_max.clone()
    best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    bu = torch.zeros(n, dtype=torch.float32, device=dev)
    bv = torch.zeros(n, dtype=torch.float32, device=dev)
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    bit = torch.arange(8, device=dev)
    low_bit = _LOW_BIT.to(dev)
    groups = [] if stats is not None and cluster_k is not None else None
    n_vis = torch.zeros(n, dtype=torch.int64, device=dev)
    rounds = (_LeafRounds(n, dev, BVH8_ROUND_STEPS) if stats is not None
              and cluster_k is None and not any_hit else None)
    for _ in range(fuel):
        act = torch.nonzero(cur >= 0).squeeze(1)
        if act.numel() == 0:
            break
        if rounds is not None:
            rounds.walk(act)
        fa = act[fresh[act]]
        if fa.numel():
            _count(stats, "fresh_visits", fa.numel())
            perm[fa] = order[cur[fa] * 8 + oc[fa]].long()
            cr = child[(cur[fa] * 8)[:, None] + perm[fa]]      # (m, 8, W)
            tl = (t_max if any_hit else t_best)[fa][:, None]
            hit = _slab(cr, *(a[fa][:, None] for a in (ox, oy, oz, ix, iy,
                                                       iz)), tl)
            filled = cr[..., 6] != -1.0         # kind -1: an empty slot
            _count(stats, "child_tests", int(filled.sum()))
            mask[fa] = ((hit & filled).long() << bit).sum(1)
            fresh[fa] = False
        done = mask[act] == 0
        pop = act[done]
        if pop.numel():
            cur[pop[sp[pop] == 0]] = -1         # an empty stack: the end
            r = pop[sp[pop] > 0]
            _count(stats, "pops", r.numel())
            sp[r] -= 1
            e = stk[r, sp[r]]
            cur[r] = e >> 8
            mask[r] = e & 255
            perm[r] = order[cur[r] * 8 + oc[r]].long()
        adv = act[~done]
        if adv.numel() == 0:
            continue
        _count(stats, "advances", adv.numel())
        mk = mask[adv]
        j = low_bit[mk]
        mask[adv] = mk & (mk - 1)
        cr = child[cur[adv] * 8 + perm[adv].gather(1, j[:, None]).squeeze(1)]
        kind = cr[:, 6].long()
        if not any_hit:        # re-cull against the improved t_best
            keep = _slab(cr, *(a[adv] for a in (ox, oy, oz, ix, iy, iz)),
                         t_best[adv])
            adv, cr, kind = adv[keep], cr[keep], kind[keep]
        desc = kind <= -2
        di = adv[desc]
        if di.numel():
            pu = di[(mask[di] != 0) & (sp[di] < stack)]
            _count(stats, "pushes", pu.numel())
            stk[pu, sp[pu]] = (cur[pu] << 8) | mask[pu]
            sp[pu] += 1
            cur[di] = -2 - kind[desc]
            fresh[di] = True
        li = torch.nonzero(kind >= 0).squeeze(1)
        if li.numel() == 0:
            continue
        lanes = adv[li]
        tl = t_max[lanes] if any_hit else t_best[lanes]
        lray = [a[lanes] for a in ray]
        if cluster_k is None:
            res = _leaf_prims(leaf, kind[li], cr[li, 7].long(), lray, tl,
                              any_hit, stats)
            if rounds is not None:
                rounds.leaves(lanes, cr[li, 7].long())
        else:
            res = _cluster_visit(_slot_rows(leaf, kind[li], cluster_k),
                                 kind[li], cr[li, 8:11].unbind(1), lray, tl,
                                 cluster_k, any_hit, stats, BVH8C_TILE)
            if any_hit:
                res, tested = res
            if groups is not None:
                groups.append(_group_rows(
                    lanes, n_vis, kind[li],
                    tested if any_hit else torch.full_like(lanes, cluster_k)))
        if any_hit:
            occ[lanes[res]] = True
            cur[lanes[res]] = -1                # stop at the first hit
            continue
        closer, t, pid = res[:3]
        lc = lanes[closer]
        t_best[lc] = t[closer]
        best[lc] = pid[closer]
        if cluster_k is None:
            bu[lc] = res[3][closer]
            bv[lc] = res[4][closer]
    _count_groups(stats, groups)
    if rounds is not None:
        rounds.count(stats)
    if any_hit:
        return occ
    t_out = torch.where(best >= 0, t_best, float("inf"))
    if cluster_k is None:
        return t_out, best.to(torch.int32), bu, bv
    return t_out, best.to(torch.int32)


def bvh8_closest_hit_plain(child, order, prim, ox, oy, oz, dx, dy, dz, t_max,
                           stack: int, fuel: int, chunk: int = 8192,
                           stats=None):
    """The twin of the BVH8 closest-hit kernel, prim leaves (K6): (t,
    prim, u, v). With a `stats` dict it also counts the kernel's work:
    fresh visits, advances, pushes, pops, triangle and sphere tests, and
    the warps' leaf passes."""
    return _chunked(
        lambda r: _bvh8_walk_plain(child, order, prim, r, False, stats,
                                   stack, fuel),
        (ox, oy, oz, dx, dy, dz, t_max), chunk)


def bvh8_any_hit_plain(child, order, prim, ox, oy, oz, dx, dy, dz, t_max,
                       stack: int, fuel: int, chunk: int = 8192, stats=None):
    """The twin of the BVH8 any-hit kernel, prim leaves (K6)."""
    return _chunked(
        lambda r: _bvh8_walk_plain(child, order, prim, r, True, stats,
                                   stack, fuel),
        (ox, oy, oz, dx, dy, dz, t_max), chunk)


def bvh8mxu_closest_hit_plain(child, order, feat, ox, oy, oz, dx, dy, dz,
                              t_max, cluster_k: int, stack: int, fuel: int,
                              chunk: int = 8192, stats=None):
    """The twin of the BVH8 closest-hit kernel over cluster leaves (K7):
    (t, slot). Its `stats` count cluster visits, the warps' groups of
    visits to one cluster (`cluster_groups`), the slots whose plane rows
    they load (`loaded_slots`) and slot tests besides the walk's steps."""
    return _chunked(
        lambda r: _bvh8_walk_plain(child, order, feat, r, False, stats,
                                   stack, fuel, cluster_k),
        (ox, oy, oz, dx, dy, dz, t_max), chunk)


def bvh8mxu_any_hit_plain(child, order, feat, ox, oy, oz, dx, dy, dz, t_max,
                          cluster_k: int, stack: int, fuel: int,
                          chunk: int = 8192, stats=None):
    """The twin of the BVH8 any-hit kernel over cluster leaves (K7)."""
    return _chunked(
        lambda r: _bvh8_walk_plain(child, order, feat, r, True, stats,
                                   stack, fuel, cluster_k),
        (ox, oy, oz, dx, dy, dz, t_max), chunk)


def _dense_plain(ccs, count, feat, rays, cluster_k, any_hit, stats,
                 rays_per_thread):
    """The dense sweep for every lane at once: cluster c = 0..C-1 in
    order, its plane rows shared by all lanes, its slots below count[c]
    through K1's visit (the slots past it are padding, whose zero rows
    never hit). Closest hit: a strictly nearer slot replaces (the first
    cluster keeps a tie). Any hit: a lane is done at its first hit.

    `stats` count per ray K1's cluster visits, slot tests (over the
    tested span; an any-hit ray's up to its first hit) and real slot
    tests, and the loads of the kernel's threads, each of which sweeps
    `rays_per_thread` = R rays (lanes b*BLOCK*R + j*BLOCK + t of a chunk,
    j < R; chunks start at multiples of BLOCK*R): `thread_visits`, the
    centroid rows, one a cluster a thread sweeps, and `loaded_slots`, the
    slots whose five float4 of plane rows it loads in them. A thread
    whose rays are all dead (t_max <= 0) sweeps nothing. Closest hit: a
    thread with a live ray sweeps every cluster and loads its count[c]
    slots. Any hit: a thread leaves the sweep once all its rays are done,
    so it sweeps cluster c iff one of its live rays has no hit before c,
    and loads slots 0..k of c, k the last first hit in c among those rays
    (all count[c] where one of them has no hit in c)."""
    ox, oy, oz, dx, dy, dz, t_max = rays
    n, dev = ox.shape[0], ox.device
    ray = (ox, oy, oz, dx, dy, dz)
    # lanes with t_max <= 0 cannot hit (0 < t < t_max): they never sweep
    act = torch.nonzero(t_max > 0).squeeze(1)
    t_best = t_max.clone()
    best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    span = BLOCK * rays_per_thread
    for c, k in enumerate(count.tolist()):
        if act.numel() == 0:
            break
        if stats is not None:
            # each active lane's thread, and a thread's index among them
            thread, lane_thread = torch.unique(
                act // span * BLOCK + act % BLOCK, return_inverse=True)
            _count(stats, "thread_visits", thread.numel())
        if k == 0:                  # a cluster without a real slot
            _count(stats, "cluster_visits", act.numel())
            continue
        base = c * cluster_k
        res = _cluster_visit(
            feat[base:base + k], base, ccs[c, 0:3].unbind(0),
            [a[act] for a in ray], (t_max if any_hit else t_best)[act],
            k, any_hit, stats, tile=1 if any_hit else None)
        if stats is not None:
            # a thread loads the slots up to the last its rays test
            loaded = (torch.zeros(thread.numel(), dtype=torch.int64,
                                  device=dev).scatter_reduce_(
                0, lane_thread, res[1], "amax").sum() if any_hit
                else k * thread.numel())
            _count(stats, "loaded_slots", int(loaded))
        if any_hit:
            hit = res[0]
            occ[act[hit]] = True
            act = act[~hit]
            continue
        closer, t_c, slot = res
        sel = act[closer]
        t_best[sel] = t_c[closer]
        best[sel] = slot[closer]
    if any_hit:
        return occ
    return (torch.where(best >= 0, t_best, float("inf")),
            best.to(torch.int32))


def dense_closest_hit_plain(ccs, count, feat, ox, oy, oz, dx, dy, dz, t_max,
                            cluster_k: int, chunk: int = 8192, stats=None,
                            rays_per_thread: int = DENSE_RAYS):
    """The twin of the dense closest-hit kernel (K8): (t, slot). Its
    `stats` count cluster visits and slot tests, as K1's twin does, and
    the loads of the kernel's threads at `rays_per_thread` rays a thread
    (_dense_plain)."""
    return _chunked(
        lambda r: _dense_plain(ccs, count, feat, r, cluster_k, False, stats,
                               rays_per_thread),
        (ox, oy, oz, dx, dy, dz, t_max), chunk, BLOCK * rays_per_thread)


def dense_any_hit_plain(ccs, count, feat, ox, oy, oz, dx, dy, dz, t_max,
                        cluster_k: int, chunk: int = 8192, stats=None,
                        rays_per_thread: int = DENSE_RAYS):
    """The twin of the dense any-hit kernel (K8)."""
    return _chunked(
        lambda r: _dense_plain(ccs, count, feat, r, cluster_k, True, stats,
                               rays_per_thread),
        (ox, oy, oz, dx, dy, dz, t_max), chunk, BLOCK * rays_per_thread)


# ---------------------------------------------------------------------------
# Entry points (traverse_pallas.ray_intersect_preliminary / ray_test and
# their instanced forms)
# ---------------------------------------------------------------------------

def takes_bvh2(has_spheres: bool) -> bool:
    """Do the default walks run over the BVH2 (K3, K4) rather than the
    clusters? On a scene holding a sphere (no plane form), and on every
    scene with MXU_LEAVES off (traverse_pallas's `use_mxu` and
    `_use_instmxu`)."""
    return has_spheres or not MXU_LEAVES


def _use_dense(scene) -> bool:
    """traverse_pallas._use_dense: does a flat triangle scene on the
    cluster path take the dense sweep (K8)? "1" always, "auto" when it has
    at most MXU_DENSE_MAX clusters, never without mxu_ccs."""
    if _MXU_DENSE == "0" or scene.mxu_ccs is None:
        return False
    return _MXU_DENSE == "1" or scene.mxu_ccs.shape[0] <= MXU_DENSE_MAX


def emits_uv(scene, backend: str) -> bool:
    """Do the walk entry points of `backend` (scene._pick_backend's)
    return real barycentrics, which the presort must unsort? The BVH2
    walks, which a scene takes by default when it holds a sphere or
    MXU_LEAVES is off, and K6 do (0 on a sphere); the cluster walks, the
    dense sweep and K7 emit u = v = 0 and the shading record re-solves
    them."""
    if backend == "bvh8mxu":
        return False
    return backend == "bvh8" or takes_bvh2(scene.has_spheres)


def _bvh_args(scene, ray_o, ray_d, t_max):
    tabs = (scene.bvh_node, scene.bvh_link, scene.bvh_pair, scene.bvh_prim)
    if scene.has_instances:
        tabs += (scene.inst_inv, scene.inst_bvh_root)
        fuel = scene.inst_fuel + 64
    else:
        fuel = scene.bvh_node.shape[0] + 64
    return (*tabs, ray_o.x, ray_o.y, ray_o.z, ray_d.x, ray_d.y, ray_d.z,
            t_max, fuel)


def _slot_prims(scene, slot):
    return torch.where(
        slot >= 0, scene.cluster_slot_prim[torch.clamp_min(slot, 0).long()],
        -1)


def _rays(ray_o, ray_d, t_max):
    return ray_o.x, ray_o.y, ray_o.z, ray_d.x, ray_d.y, ray_d.z, t_max


def ray_intersect_preliminary(scene, ray_o, ray_d, t_max):
    """Closest hit: (t, prim, u, v). A scene holding a sphere, or any
    scene with MXU_LEAVES off, takes the BVH2 walk, which returns real
    u/v; the others the cluster walk, or the dense sweep where _use_dense
    holds, whose slot ids are mapped here to prim ids through
    `cluster_slot_prim`, with u = v = 0 (the shading record re-solves them
    exactly)."""
    if takes_bvh2(scene.has_spheres):
        return bvh_closest_hit(*_bvh_args(scene, ray_o, ray_d, t_max))
    rays = _rays(ray_o, ray_d, t_max)
    if _use_dense(scene):
        t, slot = dense_closest_hit(scene.mxu_ccs, scene.mxu_ccount,
                                    scene.cluster_feat, *rays,
                                    scene.cluster_k)
    else:
        t, slot = cluster_closest_hit(scene.mxu_node_f, scene.mxu_link,
                                      scene.cluster_feat, *rays,
                                      scene.cluster_k)
    z = torch.zeros_like(t)
    return t, _slot_prims(scene, slot), z, z


def ray_test(scene, ray_o, ray_d, t_max):
    """Any-hit occlusion within t_max: (N,) bool."""
    if takes_bvh2(scene.has_spheres):
        return bvh_any_hit(*_bvh_args(scene, ray_o, ray_d, t_max))
    rays = _rays(ray_o, ray_d, t_max)
    if _use_dense(scene):
        return dense_any_hit(scene.mxu_ccs, scene.mxu_ccount,
                             scene.cluster_feat, *rays, scene.cluster_k)
    return cluster_any_hit(scene.mxu_node_f, scene.mxu_link,
                           scene.cluster_feat, *rays, scene.cluster_k)


def _inst_args(scene, ray_o, ray_d, t_max):
    return (scene.mxu_node_f, scene.mxu_link, scene.cluster_feat,
            scene.inst_inv, ray_o.x, ray_o.y, ray_o.z, ray_d.x, ray_d.y,
            ray_d.z, t_max, scene.cluster_k, scene.inst_mxu_fuel + 64)


def ray_intersect_instanced(scene, ray_o, ray_d, t_max):
    """Closest hit on a shared-BLAS instanced scene: (t, prim, u, v, inst),
    prim and inst -1 on a miss. A scene holding a sphere anywhere, or any
    scene with MXU_LEAVES off, takes the instanced BVH2 walk (real u/v),
    the others the instanced cluster walk (u = v = 0), as
    traverse_pallas._use_instmxu routes them."""
    if takes_bvh2(scene.has_spheres):
        return inst_bvh_closest_hit(*_bvh_args(scene, ray_o, ray_d, t_max))
    t, slot, inst = inst_cluster_closest_hit(
        *_inst_args(scene, ray_o, ray_d, t_max))
    z = torch.zeros_like(t)
    return t, _slot_prims(scene, slot), z, z, inst


def ray_test_instanced(scene, ray_o, ray_d, t_max):
    """Any-hit occlusion within t_max on a shared-BLAS instanced scene."""
    if takes_bvh2(scene.has_spheres):
        return inst_bvh_any_hit(*_bvh_args(scene, ray_o, ray_d, t_max))
    return inst_cluster_any_hit(*_inst_args(scene, ray_o, ray_d, t_max))


# ---------------------------------------------------------------------------
# Entry points of the BVH8 walks (traverse_pallas.ray_intersect_bvh8,
# ray_test_bvh8, ray_intersect_bvh8mxu, ray_test_bvh8mxu)
# ---------------------------------------------------------------------------

def _bvh8_args(scene, ray_o, ray_d, t_max):
    """K6's arguments; the walk bounds of traverse_pallas._bvh8_meta."""
    if scene.bvh8_child is None:
        raise ValueError("scene has no BVH8 tables (tiny or instanced)")
    M = scene.bvh8_child.shape[0] // 8
    return (scene.bvh8_child, scene.bvh8_order, scene.bvh_prim, ray_o.x,
            ray_o.y, ray_o.z, ray_d.x, ray_d.y, ray_d.z, t_max,
            scene.bvh8_depth + BVH8_STACK_MARGIN, 10 * M + scene.n_prims + 64)


def _bvh8mxu_args(scene, ray_o, ray_d, t_max):
    """K7's arguments; the walk bounds of traverse_pallas._bvh8mxu_meta."""
    if scene.bvh8c_child is None:
        raise ValueError("scene has no composed BVH8-cut tables (tiny, "
                         "instanced, or sphere-bearing scene)")
    Mc = scene.bvh8c_child.shape[0] // 8
    n_clusters = scene.cluster_slot_prim.shape[0] // scene.cluster_k
    return (scene.bvh8c_child, scene.bvh8c_order, scene.cluster_feat,
            ray_o.x, ray_o.y, ray_o.z, ray_d.x, ray_d.y, ray_d.z, t_max,
            scene.cluster_k, scene.bvh8c_depth + BVH8_STACK_MARGIN,
            10 * Mc + 2 * n_clusters + 64)


def ray_intersect_bvh8(scene, ray_o, ray_d, t_max):
    """Closest hit via the BVH8 walk over prim leaves (K6): (t, prim, u,
    v) with real u/v (0 on a sphere)."""
    return bvh8_closest_hit(*_bvh8_args(scene, ray_o, ray_d, t_max))


def ray_test_bvh8(scene, ray_o, ray_d, t_max):
    """Any-hit occlusion within t_max via the BVH8 walk (K6)."""
    return bvh8_any_hit(*_bvh8_args(scene, ray_o, ray_d, t_max))


def ray_intersect_bvh8mxu(scene, ray_o, ray_d, t_max):
    """Closest hit via the BVH8 walk over cluster leaves (K7): (t, prim,
    u, v), slot ids mapped to prim ids through `cluster_slot_prim`, u = v
    = 0 (the shading record re-solves them)."""
    t, slot = bvh8mxu_closest_hit(*_bvh8mxu_args(scene, ray_o, ray_d, t_max))
    z = torch.zeros_like(t)
    return t, _slot_prims(scene, slot), z, z


def ray_test_bvh8mxu(scene, ray_o, ray_d, t_max):
    """Any-hit occlusion within t_max via the BVH8 walk over cluster
    leaves (K7)."""
    return bvh8mxu_any_hit(*_bvh8mxu_args(scene, ray_o, ray_d, t_max))
