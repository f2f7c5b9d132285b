"""Host-side BVH construction (numpy) with a threaded, stackless layout.

The port's copy of mitsuba2_tpu/scene/bvh.py, cut to what the cluster walk
needs: the binned-SAH BVH2 build flattened in DFS order with miss links,
the per-octant threaded links, the cluster cut and the pruned cut tree,
the two-level (TLAS over instances + per-group BLAS) stitching and the
BVH8 collapse of a tree or of its cut tree.
It must stay decision-for-decision equal to the JAX package's builder, so
that the scene tables of both packages are byte-equal. The C++ builder
(native/bvh_builder.cpp) is taken for scenes above 512 prims, the same
rule as the JAX package's; the two builders give different, equally valid
trees, so the rule is part of the contract.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

LEAF_K = 4        # max prims per leaf
# Cluster size of the cluster walk (prims per BVH-cut cluster). The
# MI_CLUSTER_K override binds at scene build, as in the JAX package.
CLUSTER_K = int(os.environ.get("MI_CLUSTER_K", "128"))
CK_FORCED = "MI_CLUSTER_K" in os.environ
if CLUSTER_K < 32 or CLUSTER_K % 8 != 0:
    raise ValueError(f"MI_CLUSTER_K={CLUSTER_K}: must be a multiple of 8, "
                     ">= 32")
N_BINS = 16       # SAH bins per axis


def set_cluster_k(k: int, force: bool = True) -> None:
    """Pin the cluster size of scenes built from now on, as MI_CLUSTER_K
    pins it (force=False restores the automatic policy,
    scene.py::_pick_cluster_k). Each scene carries its own
    (SceneData.cluster_k), so scenes of different sizes coexist."""
    global CLUSTER_K, CK_FORCED
    if k < 32 or k % 8 != 0 or k < LEAF_K:
        raise ValueError(f"cluster size {k}: must be a multiple of 8, >= 32")
    CLUSTER_K = int(k)
    CK_FORCED = bool(force)


@dataclasses.dataclass
class BVH:
    bounds_min: np.ndarray   # (N, 3) f32
    bounds_max: np.ndarray   # (N, 3) f32
    leaf_start: np.ndarray   # (N,) i32; -1 for inner nodes
    leaf_count: np.ndarray   # (N,) i32; 0 for inner nodes
    miss: np.ndarray         # (N,) i32; -1 = exit traversal
    prim_order: np.ndarray   # (P,) i32 permutation: new prim i = old prim_order[i]


def children(bvh: BVH):
    """Recover (left, right) child indices of every node from the canonical
    DFS layout: left(i) = i + 1, right(i) = miss(i + 1) (the node visited
    after the left subtree IS the right sibling). Leaves get (-1, -1)."""
    n = bvh.miss.shape[0]
    inner = bvh.leaf_start < 0
    left = np.where(inner, np.arange(n, dtype=np.int64) + 1, -1)
    right = np.where(inner, bvh.miss[np.minimum(left, n - 1)], -1)
    return left.astype(np.int32), right.astype(np.int32)


def _levels(left, right, inner):
    """Frontier per tree depth, root first (vectorized sweeps iterate
    these instead of per-node python loops)."""
    levels = []
    f = np.array([0], np.int64)
    while f.size:
        levels.append(f)
        fi = f[inner[f]]
        f = np.concatenate([left[fi], right[fi]]).astype(np.int64) \
            if fi.size else np.zeros(0, np.int64)
    return levels


def cluster_cut(bvh: BVH, max_prims: int = 128):
    """Cut the BVH into disjoint CLUSTERS: the highest nodes whose subtree
    holds <= max_prims primitives (every leaf is below exactly one cut
    node, and DFS order makes each cluster's primitives CONTIGUOUS in
    prim_order). The MXU leaf path (kernels/traverse_pallas.py) stops the
    node walk at cluster roots and batch-tests the whole cluster on the
    matrix unit, so the walked tree shrinks from ~P/2 nodes to
    ~P/max_prims clusters.

    Returns (cluster_id (N,) i32 — cluster index at cut nodes, -1
    elsewhere; starts (C,) i64 prim start per cluster; counts (C,) i64).
    """
    n = bvh.miss.shape[0]
    left, right = children(bvh)
    inner = bvh.leaf_start < 0
    levels = _levels(left, right, inner)
    # subtree prim counts + leftmost prim start: LEVEL-SYNCHRONOUS
    # bottom-up sweep (the reverse python loop cost ~0.25 s / 313k nodes)
    counts = np.where(inner, 0, bvh.leaf_count).astype(np.int64)
    starts = np.where(inner, np.iinfo(np.int64).max,
                      bvh.leaf_start).astype(np.int64)
    for f in reversed(levels):
        fi = f[inner[f]]
        if fi.size:
            counts[fi] = counts[left[fi]] + counts[right[fi]]
            starts[fi] = np.minimum(starts[left[fi]], starts[right[fi]])

    # cut nodes: counts <= max_prims with the PARENT above the cut
    small = counts <= max_prims
    parent = np.full(n, -1, np.int64)
    fi = np.nonzero(inner)[0]
    parent[left[fi]] = fi
    parent[right[fi]] = fi
    is_cut = small & ((parent < 0) | ~small[np.maximum(parent, 0)])
    cut_nodes = np.nonzero(is_cut)[0]
    # DFS index order == ascending `starts` order (subtrees are
    # contiguous prim ranges); number clusters in that order
    cut_nodes = cut_nodes[np.argsort(starts[cut_nodes], kind="stable")]
    cluster_id = np.full(n, -1, np.int32)
    cluster_id[cut_nodes] = np.arange(len(cut_nodes), dtype=np.int32)
    return (cluster_id, starts[cut_nodes].astype(np.int64),
            counts[cut_nodes].astype(np.int64))


def cut_tree_tables(bvh: BVH, cluster_id: np.ndarray,
                    hit8: np.ndarray, miss8: np.ndarray):
    """Compact the BVH to the nodes the MXU cluster walk can reach: cut
    nodes and their ancestors (~2*C rows instead of ~P/2). The walk never
    descends past a cut node, so below-cut rows are dead weight in VMEM —
    pruning keeps the kernel's table footprint O(C) and makes million-tri
    scenes feasible. Links are remapped to compact indices; a cut node's
    hit links (which point below the cut and are never taken) remap to -1.

    Returns (node_min (R,3), node_max (R,3), hit8c (R*8,), miss8c (R*8,),
    cluster_id_c (R,)) with the root at compact index 0.
    """
    n = bvh.miss.shape[0]
    left, right = children(bvh)
    inner = bvh.leaf_start < 0
    # below-the-cut flags: level-synchronous ancestor propagation
    below = np.zeros(n, bool)
    for f in _levels(left, right, inner):
        fi = f[inner[f]]
        if fi.size == 0:
            continue
        mark = below[fi] | (cluster_id[fi] >= 0)
        below[left[fi]] |= mark
        below[right[fi]] |= mark
    keep_idx = np.nonzero(~below)[0]
    remap = np.full(n, -1, np.int32)
    remap[keep_idx] = np.arange(len(keep_idx), dtype=np.int32)

    def rm(links):
        l = links.reshape(n, 8)[keep_idx]
        return np.where(l >= 0, remap[np.maximum(l, 0)], -1) \
            .astype(np.int32).reshape(-1)

    return (bvh.bounds_min[keep_idx], bvh.bounds_max[keep_idx],
            rm(hit8), rm(miss8), cluster_id[keep_idx].astype(np.int32))


def build_octant_links(bvh: BVH):
    """Direction-ordered threaded links: for each of the 8 ray-direction
    octants, a DFS order that visits the NEAR child first (classic
    multi-threaded/roped BVH, the ordered-traversal replacement for the
    per-lane stack the reference's kd-tree keeps in
    include/mitsuba/render/kdtree.h::ray_intersect). Near-first ordering
    restores the t-culling power of ordered traversal, which a single
    fixed skip-link order gives up.

    Returns (hit8, miss8), each (N*8,) i32 flattened as node*8 + octant —
    a flat 1-D layout so device lookups are rank-1 gathers (the measured
    fast TPU pattern, kernels/gather.py). Octant bit k set means
    ray.d[k] < 0.  hit8 = node entered when the box test passes (first
    child for inner nodes; for leaves the continuation after its prims,
    i.e. == miss8). miss8 = node after skipping the subtree; -1 = done.
    """
    n = bvh.miss.shape[0]
    left, right = children(bvh)
    inner = bvh.leaf_start < 0

    cent = 0.5 * (bvh.bounds_min + bvh.bounds_max)  # (N, 3)
    # Split axis of each inner node: the axis along which its children's
    # centroids are farthest apart; fall back to axis 0 for leaves.
    li = np.maximum(left, 0)
    ri = np.maximum(right, 0)
    sep = np.abs(cent[ri] - cent[li])               # (N, 3)
    axis = np.argmax(sep, axis=1)                   # (N,)
    left_is_lower = (np.take_along_axis(cent[li], axis[:, None], 1)
                     <= np.take_along_axis(cent[ri], axis[:, None], 1))[:, 0]

    # The threading recurrence per octant o:
    #     miss8[root] = -1
    #     miss8[first[n], o]  = second[n, o]      (n inner)
    #     miss8[second[n], o] = miss8[n, o]
    # Assignments at one tree DEPTH depend only on completed parents, so
    # a LEVEL-SYNCHRONOUS sweep vectorizes over (nodes-in-level, octants)
    # — the old per-octant python DFS cost ~3.4 s on a 313k-node tree;
    # this runs the whole table in ~0.1 s.
    neg = np.array([[(o >> k) & 1 for k in range(3)] for o in range(8)],
                   bool)                           # (8, 3)
    left_first8 = left_is_lower[:, None] ^ neg.T[axis]      # (N, 8)
    first8 = np.where(left_first8, left[:, None], right[:, None])
    second8 = np.where(left_first8, right[:, None], left[:, None])

    miss8 = np.full((n, 8), -1, np.int32)
    frontier = np.array([0], np.int64)
    while frontier.size:
        f = frontier[inner[frontier]]
        if f.size == 0:
            break
        for o in range(8):
            miss8[first8[f, o], o] = second8[f, o]
            miss8[second8[f, o], o] = miss8[f, o]
        frontier = np.concatenate([left[f], right[f]]).astype(np.int64)
    # hit: first child for inner nodes; leaves continue past their prims
    hit8 = np.where(inner[:, None], first8, miss8).astype(np.int32)
    return hit8.reshape(-1), miss8.reshape(-1)


def build_bvh(prim_bb_min: np.ndarray, prim_bb_max: np.ndarray,
              native: bool = True, leaf_k: int = None) -> BVH:
    """Binned-SAH BVH2 over primitive AABBs, flattened with miss links.

    Scenes above 512 prims take the C++ builder (native/bvh_builder.cpp);
    a toolchain failure raises rather than falling back to this numpy
    builder, whose tree would differ from the JAX package's. `leaf_k`
    overrides the leaf size (the TLAS takes 1, one instance a leaf) and
    then forces the numpy builder, which alone takes it."""
    P = prim_bb_min.shape[0]
    if P == 0:
        raise ValueError("cannot build a BVH over zero primitives")
    if leaf_k is None:
        leaf_k = LEAF_K
    else:
        native = False
    LEAF = leaf_k
    if native and P > 512:  # tiny scenes: numpy is fast enough
        from .. import native as native_mod
        (n_min, n_max, l_start, l_count,
         miss, order) = native_mod.build_bvh_native(prim_bb_min, prim_bb_max)
        return BVH(bounds_min=n_min, bounds_max=n_max,
                   leaf_start=l_start, leaf_count=l_count, miss=miss,
                   prim_order=order)
    centroids = 0.5 * (prim_bb_min + prim_bb_max)

    # --- recursive build into a temporary node list -------------------------
    nodes = []  # each: dict(bb_min, bb_max, left, right, start, count)

    def make_leaf(idxs):
        nodes.append(dict(
            bb_min=prim_bb_min[idxs].min(0), bb_max=prim_bb_max[idxs].max(0),
            left=-1, right=-1, idxs=idxs))
        return len(nodes) - 1

    def sah_split(idxs):
        """Return a go-left mask or None for leaf. All three axes are
        binned and swept (kdtree.h sweeps every axis too); the global
        minimum-cost (axis, bin) wins — measurably better trees than
        widest-axis-only binning on the walk model."""
        if len(idxs) <= LEAF:
            return None
        c = centroids[idxs]
        ext = c.max(0) - c.min(0)
        if ext.max() <= 1e-12:
            return None  # all centroids coincide

        def areas(mn, mx):
            d = np.maximum(mx - mn, 0)
            return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

        best_cost, best_mask = np.inf, None
        for axis in range(3):
            if ext[axis] <= 1e-12:
                continue
            lo = c[:, axis].min()
            scale = N_BINS * (1.0 - 1e-6) / max(ext[axis], 1e-30)
            bins = np.minimum(((c[:, axis] - lo) * scale).astype(np.int64),
                              N_BINS - 1)
            counts = np.bincount(bins, minlength=N_BINS)
            bmin = np.full((N_BINS, 3), np.inf)
            bmax = np.full((N_BINS, 3), -np.inf)
            for b in range(N_BINS):
                sel = bins == b
                if counts[b]:
                    bmin[b] = prim_bb_min[idxs[sel]].min(0)
                    bmax[b] = prim_bb_max[idxs[sel]].max(0)
            lmin = np.minimum.accumulate(bmin, 0)
            lmax = np.maximum.accumulate(bmax, 0)
            rmin = np.minimum.accumulate(bmin[::-1], 0)[::-1]
            rmax = np.maximum.accumulate(bmax[::-1], 0)[::-1]
            lcnt = np.cumsum(counts)
            rcnt = np.cumsum(counts[::-1])[::-1]
            cost = np.full(N_BINS - 1, np.inf)
            for s in range(N_BINS - 1):
                if lcnt[s] == 0 or rcnt[s + 1] == 0:
                    continue
                cost[s] = areas(lmin[s:s+1], lmax[s:s+1])[0] * lcnt[s] + \
                    areas(rmin[s+1:s+2], rmax[s+1:s+2])[0] * rcnt[s + 1]
            s = int(np.argmin(cost))
            if np.isfinite(cost[s]) and cost[s] < best_cost:
                mask = bins <= s
                if not (mask.all() or not mask.any()):
                    best_cost, best_mask = cost[s], mask
        if best_mask is None:
            # degenerate; median fallback on the widest axis
            axis = int(np.argmax(ext))
            order = np.argsort(c[:, axis], kind="stable")
            best_mask = np.zeros(len(idxs), bool)
            best_mask[order[: len(idxs) // 2]] = True
        return best_mask

    def build(idxs):
        split = sah_split(idxs)
        if split is None and len(idxs) > LEAF:
            # forced split into LEAF-sized chunks via median
            c = centroids[idxs]
            axis = int(np.argmax(c.max(0) - c.min(0)))
            order = np.argsort(c[:, axis], kind="stable")
            split = np.zeros(len(idxs), bool)
            split[order[: len(idxs) // 2]] = True
        if split is None:
            return make_leaf(idxs)
        me = len(nodes)
        nodes.append(dict(bb_min=prim_bb_min[idxs].min(0),
                          bb_max=prim_bb_max[idxs].max(0),
                          left=-1, right=-1, idxs=None))
        left = build(idxs[split])
        right = build(idxs[~split])
        nodes[me]["left"] = left
        nodes[me]["right"] = right
        return me

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000 + 64 * int(np.log2(P + 1))))
    root = build(np.arange(P, dtype=np.int64))
    sys.setrecursionlimit(old_limit)
    assert root == 0

    # --- flatten to DFS order with miss links -------------------------------
    # Two passes: DFS assigns positions + subtree sizes; then
    # miss[i] = i + subtree_size[i] (the node visited after skipping i's
    # subtree), or -1 past the end.
    n = len(nodes)
    order = np.empty(n, np.int64)          # dfs position -> temp index
    new_index = np.empty(n, np.int64)      # temp index -> dfs position
    prim_order = []
    leaf_start = np.full(n, -1, np.int64)
    leaf_count = np.zeros(n, np.int64)
    pos = 0
    subtree = np.zeros(n, np.int64)

    def dfs2(tmp_idx):
        nonlocal pos
        my_pos = pos
        new_index[tmp_idx] = my_pos
        order[my_pos] = tmp_idx
        pos += 1
        node = nodes[tmp_idx]
        if node["left"] == -1:
            leaf_start[my_pos] = len(prim_order)
            leaf_count[my_pos] = len(node["idxs"])
            prim_order.extend(node["idxs"].tolist())
            subtree[my_pos] = 1
        else:
            dfs2(node["left"])
            dfs2(node["right"])
            subtree[my_pos] = pos - my_pos

    sys.setrecursionlimit(max(old_limit, 10000 + 64 * int(np.log2(P + 1))))
    dfs2(root)
    sys.setrecursionlimit(old_limit)

    # miss[i] = i + subtree[i] if that's within bounds else -1
    nxt = np.arange(n, dtype=np.int64) + subtree
    miss = np.where(nxt < n, nxt, -1)

    bb_min = np.stack([nodes[order[i]]["bb_min"] for i in range(n)]).astype(np.float32)
    bb_max = np.stack([nodes[order[i]]["bb_max"] for i in range(n)]).astype(np.float32)

    return BVH(bounds_min=bb_min, bounds_max=bb_max,
               leaf_start=leaf_start.astype(np.int32),
               leaf_count=leaf_count.astype(np.int32),
               miss=miss.astype(np.int32),
               prim_order=np.asarray(prim_order, np.int32))


# ---------------------------------------------------------------------------
# Two-level (TLAS/BLAS) stitching for shared instances (instance.cpp, the
# OptiX IAS analog)
# ---------------------------------------------------------------------------

BLAS_EXIT = -2   # link sentinel: BLAS exhausted -> pop to the saved TLAS row


def build_tlas(inst_bb_min, inst_bb_max):
    """The TLAS over instance world boxes, one instance a leaf: (tree,
    hit8, miss8, inst_ids (T,) i32 = the instance at each leaf row, -1 at
    inner rows). Both stitchings below start with these rows."""
    tlas = build_bvh(np.asarray(inst_bb_min, np.float32),
                     np.asarray(inst_bb_max, np.float32), leaf_k=1)
    t_hit8, t_miss8 = build_octant_links(tlas)
    t_leaf = tlas.leaf_start >= 0
    inst_ids = np.where(t_leaf, tlas.prim_order[
        np.minimum(np.maximum(tlas.leaf_start, 0),
                   len(tlas.prim_order) - 1)], -1).astype(np.int32)
    return tlas, t_hit8, t_miss8, inst_ids


def build_two_level(blas_list, inst_group, tlas_parts):
    """Stitch per-group BLASes behind the TLAS into one BVH2 node table:
    rows [0, T) the TLAS, whose leaves are instance leaves (leaf_start =
    instance id, leaf_count = 0), then each group's BLAS block in local
    space with its exit links (-1) turned into BLAS_EXIT.

    blas_list: [(BVH, hit8, miss8, prim_base)] per group; inst_group: (K,)
    group per instance; tlas_parts: build_tlas's result. Returns the
    stitched node arrays, each group's BLAS root row per instance
    (blas_root) and the walk fuel bound."""
    if len(inst_group) == 0:
        raise ValueError("two-level build needs at least one instance")
    tlas, t_hit8, t_miss8, inst_ids = tlas_parts
    T = tlas.miss.shape[0]

    blas_base = []
    off = T
    for (tree, _, _, _) in blas_list:
        blas_base.append(off)
        off += tree.miss.shape[0]
    total = off

    node_min = np.empty((total, 3), np.float32)
    node_max = np.empty((total, 3), np.float32)
    leaf_start = np.empty(total, np.int32)
    leaf_count = np.empty(total, np.int32)
    miss = np.empty(total, np.int32)
    hit8 = np.empty(total * 8, np.int32)
    miss8 = np.empty(total * 8, np.int32)

    node_min[:T] = tlas.bounds_min
    node_max[:T] = tlas.bounds_max
    leaf_start[:T] = inst_ids
    leaf_count[:T] = 0            # count == 0 everywhere in the TLAS
    miss[:T] = tlas.miss
    hit8[:T * 8] = t_hit8
    miss8[:T * 8] = t_miss8

    for g, (tree, b_hit8, b_miss8, prim_base) in enumerate(blas_list):
        b0 = blas_base[g]
        n = tree.miss.shape[0]
        sl = slice(b0, b0 + n)
        node_min[sl] = tree.bounds_min
        node_max[sl] = tree.bounds_max
        leaf_start[sl] = np.where(tree.leaf_start >= 0,
                                  tree.leaf_start + prim_base, -1)
        leaf_count[sl] = tree.leaf_count

        def _shift(links):
            return np.where(links >= 0, links + b0, BLAS_EXIT).astype(np.int32)

        miss[sl] = _shift(tree.miss)
        hit8[b0 * 8:(b0 + n) * 8] = _shift(b_hit8)
        miss8[b0 * 8:(b0 + n) * 8] = _shift(b_miss8)

    blas_root = np.asarray([blas_base[g] for g in inst_group], np.int32)
    # fuel: TLAS visited once; each instance's BLAS visited at most once
    fuel = T + int(sum(blas_list[g][0].miss.shape[0] for g in inst_group)) + 64
    return dict(node_min=node_min, node_max=node_max,
                leaf_start=leaf_start, leaf_count=leaf_count, miss=miss,
                hit8=hit8, miss8=miss8, blas_root=blas_root, fuel=fuel)


def build_two_level_mxu(blas_list, inst_group, tlas_parts, max_prims: int):
    """The TLAS stitched to each group's pruned cluster cut tree: the
    tables of the instanced cluster walk. Cluster slots are global across
    groups (group g's clusters follow group g-1's); each group's plane
    rows are built by the caller from its local-space prims about local
    centroids, so one table serves every instance of a group.

    Returns dict(
      node_f (R, 16) f32 [min 3 | max 3 | slot | inst_id | centroid 3
             (caller fills) | pad 5]: slot >= 0 marks a cluster row,
             inst_id >= 0 a TLAS instance leaf
      link (R, 16) i32 [hit8 | miss8], group exits BLAS_EXIT
      slot_prim (S,) i32 prim index per padded slot, -1 padding
      row_cluster (R,) i32 global cluster id at cluster rows, -1 else
      blas_root (G,) i32 each group's cut-tree root row
      fuel: walk bound (TLAS once + each instance's cut tree once))"""
    if len(inst_group) == 0:
        raise ValueError("two-level build needs at least one instance")
    tlas, t_hit8, t_miss8, inst_ids = tlas_parts
    T = tlas.miss.shape[0]

    mins, maxs = [tlas.bounds_min], [tlas.bounds_max]
    slots = [np.full(T, -1, np.int32)]
    insts = [inst_ids]
    row_cl = [np.full(T, -1, np.int32)]
    hits = [t_hit8.reshape(T, 8)]
    misses = [t_miss8.reshape(T, 8)]
    slot_parts = []
    blas_root, cut_rows = [], []
    off, ccount = T, 0
    for (tree_g, h8, m8, prim_base) in blas_list:
        cl_id, starts, counts = cluster_cut(tree_g, max_prims=max_prims)
        cmin, cmax, ch8, cm8, cl_id_c = cut_tree_tables(tree_g, cl_id,
                                                        h8, m8)
        R = cmin.shape[0]
        blas_root.append(off)
        cut_rows.append(R)

        def _shift(links):
            return np.where(links >= 0, links + off,
                            BLAS_EXIT).astype(np.int32)

        mins.append(cmin)
        maxs.append(cmax)
        hits.append(_shift(ch8).reshape(R, 8))
        misses.append(_shift(cm8).reshape(R, 8))
        slots.append(np.where(cl_id_c >= 0,
                              (cl_id_c + ccount) * max_prims,
                              -1).astype(np.int32))
        insts.append(np.full(R, -1, np.int32))
        row_cl.append(np.where(cl_id_c >= 0, cl_id_c + ccount,
                               -1).astype(np.int32))
        sp = np.full(len(starts) * max_prims, -1, np.int32)
        for c, (s0, cnt) in enumerate(zip(starts, counts)):
            sp[c * max_prims: c * max_prims + cnt] = \
                prim_base + np.arange(s0, s0 + cnt)
        slot_parts.append(sp)
        ccount += len(starts)
        off += R
    if ccount * max_prims >= (1 << 24):
        raise ValueError("instanced cluster slot ids exceed the f32 "
                         "exact-integer range")

    node_min = np.concatenate(mins, 0).astype(np.float32)
    node_max = np.concatenate(maxs, 0).astype(np.float32)
    Rt = node_min.shape[0]
    node_f = np.concatenate(
        [node_min, node_max,
         np.concatenate(slots)[:, None].astype(np.float32),
         np.concatenate(insts)[:, None].astype(np.float32),
         np.zeros((Rt, 8), np.float32)], -1)
    link = np.concatenate([np.concatenate(hits, 0),
                           np.concatenate(misses, 0)], -1).astype(np.int32)
    fuel = T + int(sum(cut_rows[g] for g in inst_group)) + 64
    return dict(node_f=node_f, link=link,
                slot_prim=np.concatenate(slot_parts),
                row_cluster=np.concatenate(row_cl),
                blas_root=np.asarray(blas_root, np.int32), fuel=fuel)


# ---------------------------------------------------------------------------
# BVH8 collapse: the tables of the BVH8 walks (K6, and K7 over the cut tree)
# ---------------------------------------------------------------------------

def collapse_bvh8(bvh: BVH, cluster_id=None, cluster_c=None,
                  cluster_k: int = 0):
    """Collapse the DFS BVH2 into 8-wide nodes, level by level.

    Each BVH8 node takes the 3-level frontier under its BVH2 root: a
    child is a BVH2 prim leaf reached within 3 expansions, or the inner
    BVH2 node left at the frontier (which roots another BVH8 node).

    Returns (child (M*8, 8) f32 rows [min.xyz, max.xyz, kind, count],
    order8 (M*8, 8) i32, depth): kind >= 0 is a prim-leaf start, -1 an
    empty slot, and kind <= -2 an inner child, BVH8 node (-2 - kind).
    order8 row (node*8 + octant) permutes the node's child slots into
    near-first visit order for rays of that direction octant (ties and
    empties last). `depth` (levels below the root) bounds the walk's
    stack.

    Cut mode (cluster_id, cluster_c, cluster_k given): collapse the
    pruned cluster-cut tree instead. Descent stops at cut nodes
    (cluster_id >= 0), which become cluster leaves with kind = their slot
    base (cluster_id * cluster_k), count 0 and the cluster centroid in
    cols 8:11 of (M*8, 16) rows: the tables of the BVH8 walk over cluster
    leaves (K7)."""
    left, right = children(bvh)
    inner = bvh.leaf_start < 0
    cut_mode = cluster_id is not None
    if cut_mode:
        # every node at the cut ends descent (leaves lie at or below it,
        # so every node reached above the cut is inner)
        inner = inner & (cluster_id < 0)
    if not inner[0]:
        raise ValueError("collapse_bvh8 needs an inner root (tiny scenes "
                         "take the brute-force path)")

    def expand(slots):
        """(R, k) child slots -> (R, 2k): inner slots split, leaves copy,
        -1 pads stay."""
        R, k = slots.shape
        safe = np.maximum(slots, 0)
        is_in = (slots >= 0) & inner[safe]
        out = np.full((R, 2 * k), -1, np.int64)
        out[:, 0::2] = np.where(is_in, left[safe], slots)
        out[:, 1::2] = np.where(is_in, right[safe], -1)
        return out

    levels = []          # per level: (roots (R,), slots (R, 8))
    roots = np.array([0], np.int64)
    total = 0
    bases = []
    while roots.size:
        slots = expand(expand(expand(roots[:, None])))
        levels.append((roots, slots))
        bases.append(total)
        total += roots.size
        safe = np.maximum(slots, 0)
        roots = slots[(slots >= 0) & inner[safe]].astype(np.int64)
    depth = len(levels) - 1

    # BVH8 ids level by level: the inner children of level L, in row-major
    # order, are level L+1's roots in order
    M = total
    W = 16 if cut_mode else 8
    child = np.zeros((M * 8, W), np.float32)
    child[:, 6] = -1.0
    order8 = np.zeros((M * 8, 8), np.int32)
    for li, (roots, slots) in enumerate(levels):
        R = roots.size
        base = bases[li]
        rows = (base + np.arange(R))[:, None] * 8 + np.arange(8)  # (R, 8)
        safe = np.maximum(slots, 0)
        valid = slots >= 0
        is_in = valid & inner[safe]
        is_leaf = valid & ~inner[safe]
        bmin = np.where(valid[..., None], bvh.bounds_min[safe], 0.0)
        bmax = np.where(valid[..., None], bvh.bounds_max[safe], 0.0)
        child[rows, 0:3] = bmin
        child[rows, 3:6] = bmax
        kind = np.full((R, 8), -1.0, np.float32)
        if li + 1 < len(levels):
            ids = np.full((R, 8), -1, np.int64)
            ids[is_in] = bases[li + 1] + np.arange(int(is_in.sum()))
            kind[is_in] = (-2 - ids[is_in]).astype(np.float32)
        cnt = np.zeros((R, 8), np.float32)
        if cut_mode:
            cl = cluster_id[safe[is_leaf]]
            kind[is_leaf] = (cl * cluster_k).astype(np.float32)
            child[rows[is_leaf], 8:11] = cluster_c[cl]
        else:
            kind[is_leaf] = bvh.leaf_start[safe[is_leaf]].astype(np.float32)
            cnt[is_leaf] = bvh.leaf_count[safe[is_leaf]].astype(np.float32)
        child[rows, 6] = kind
        child[rows, 7] = cnt

        cent = 0.5 * (bmin + bmax)                       # (R, 8, 3)
        for o in range(8):
            sign = np.array([(-1.0 if (o >> a) & 1 else 1.0)
                             for a in range(3)], np.float32)
            key = cent @ sign
            key[~valid] = np.inf                         # empties last
            order8[(base + np.arange(R)) * 8 + o] = \
                np.argsort(key, axis=1, kind="stable").astype(np.int32)

    # the kind column holds node and prim ids, exact in f32 below 2^24
    assert M * 8 < (1 << 24) and len(bvh.prim_order) < (1 << 24)
    return child, order8, depth
