"""Ray-triangle queries of the reference, a wavefront at a time in plain
PyTorch: brute force over the large triangles (a box over an eighth of
the scene's diagonal, or every triangle of a scene of BRUTE_MAX or
fewer), and a median-split BVH, built in numpy, over the rest.

In the BVH each lane keeps a stack of node indices; every round pops one
node a live lane, tests its box, and either tests the node's triangles
(Möller-Trumbore) or pushes its two children, the nearer on top. A lane
leaves the rounds when its stack is empty (a shadow ray also at its
first hit). The answer is the closest hit over all triangles, as brute
force gives it (`brute_closest_hit`, kept for the tests); only the
visiting order, and with it the winner of an exact tie in t, differs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

LEAF = 4
MAX_DEPTH = 64
BRUTE_MAX = 64
LARGE = 0.125


@dataclasses.dataclass
class BVH:
    large: tuple          # (i, p0, e1, e2) of each triangle tested by
                          # brute force, its rows as host floats
    empty: bool           # no triangle in the tree
    bmin: torch.Tensor    # (B, 3) node boxes, padded outward
    bmax: torch.Tensor
    left: torch.Tensor    # (B,) int64 child rows, -1 at a leaf
    right: torch.Tensor
    axis: torch.Tensor    # (B,) int64 split axis
    start: torch.Tensor   # (B,) int64 first slot of a leaf in `prims`
    count: torch.Tensor   # (B,) int64 triangles of a leaf, 0 inside
    prims: torch.Tensor   # (P,) int64 triangle ids in leaf order


def build_bvh(p0: np.ndarray, e1: np.ndarray, e2: np.ndarray, device,
              dtype=torch.float32) -> BVH:
    """The large triangles apart; over the others a median split on the
    widest axis of their centroids, down to LEAF triangles a leaf."""
    lo = np.minimum(np.minimum(p0, p0 + e1), p0 + e2).astype(np.float64)
    hi = np.maximum(np.maximum(p0, p0 + e1), p0 + e2).astype(np.float64)
    cen = 0.5 * (lo + hi)
    diag = float(np.linalg.norm(hi.max(0) - lo.min(0)))
    pad = 1e-5 * diag + 1e-7
    big = np.linalg.norm(hi - lo, axis=1) > LARGE * diag
    if p0.shape[0] <= BRUTE_MAX:
        big[:] = True
    bmin, bmax, left, right, axis, start, count = ([] for _ in range(7))
    order = []

    def node(idx, depth=1):
        if depth > MAX_DEPTH - 2:
            raise ValueError("the BVH is deeper than a lane's stack")
        me = len(bmin)
        bmin.append(lo[idx].min(0) - pad)
        bmax.append(hi[idx].max(0) + pad)
        left.append(-1)
        right.append(-1)
        ext = cen[idx].max(0) - cen[idx].min(0)
        ax = int(np.argmax(ext))
        axis.append(ax)
        if len(idx) <= LEAF:
            start.append(len(order))
            count.append(len(idx))
            order.extend(idx.tolist())
            return me
        start.append(0)
        count.append(0)
        srt = idx[np.argsort(cen[idx, ax], kind="stable")]
        half = len(idx) // 2
        left[me] = node(srt[:half], depth + 1)
        right[me] = node(srt[half:], depth + 1)
        return me

    small = np.nonzero(~big)[0]
    if len(small):
        node(small)
    else:   # an empty box: every ray misses it
        bmin.append(np.full(3, np.inf))
        bmax.append(np.full(3, -np.inf))
        left.append(-1)
        right.append(-1)
        axis.append(0)
        start.append(0)
        count.append(0)

    def up(a, dt):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    # host floats of the large triangles' rows, rounded to `dtype`
    rows = torch.as_tensor(np.stack([p0, e1, e2], 1), dtype=dtype)
    large = tuple((int(i), *(tuple(r) for r in rows[i].tolist()))
                  for i in np.nonzero(big)[0])
    return BVH(large=large, empty=not len(small),
               bmin=up(np.stack(bmin), dtype), bmax=up(np.stack(bmax), dtype),
               left=up(left, torch.int64), right=up(right, torch.int64),
               axis=up(axis, torch.int64), start=up(start, torch.int64),
               count=up(count, torch.int64), prims=up(order, torch.int64))


def tri_test(p0, e1, e2, o, d):
    """Möller-Trumbore on (N, 3) rows -> (t, u, v); t = +inf where the
    ray misses, a |det| under 1e-12 misses."""
    tv = o - p0
    pv = torch.cross(d, e2, dim=-1)
    det = (e1 * pv).sum(-1)
    inv = torch.where(det.abs() < 1e-12, 0.0, 1.0 / det)
    u = (tv * pv).sum(-1) * inv
    qv = torch.cross(tv, e1, dim=-1)
    v = (d * qv).sum(-1) * inv
    t = (e2 * qv).sum(-1) * inv
    ok = (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0) & (inv != 0)
    return torch.where(ok, t, float("inf")), u, v


def _tri_test_planar(p0, e1, e2, o, d):
    """tri_test with one triangle's rows as host floats and the rays as
    planar (x, y, z) tensors -> t, +inf where missed."""
    tv = (o[0] - p0[0], o[1] - p0[1], o[2] - p0[2])
    pv = (d[1] * e2[2] - d[2] * e2[1], d[2] * e2[0] - d[0] * e2[2],
          d[0] * e2[1] - d[1] * e2[0])
    det = e1[0] * pv[0] + e1[1] * pv[1] + e1[2] * pv[2]
    inv = torch.where(det.abs() < 1e-12, 0.0, 1.0 / det)
    u = (tv[0] * pv[0] + tv[1] * pv[1] + tv[2] * pv[2]) * inv
    qv = (tv[1] * e1[2] - tv[2] * e1[1], tv[2] * e1[0] - tv[0] * e1[2],
          tv[0] * e1[1] - tv[1] * e1[0])
    v = (d[0] * qv[0] + d[1] * qv[1] + d[2] * qv[2]) * inv
    t = (e2[0] * qv[0] + e2[1] * qv[1] + e2[2] * qv[2]) * inv
    ok = (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0) & (inv != 0)
    return torch.where(ok, t, float("inf"))


def _walk(bvh: BVH, tris, o, d, tmax, any_hit: bool):
    """Brute force over the large triangles, then the stack walk over
    all lanes with tmax > 0 -> (t, prim). o, d: planar (x, y, z)."""
    p0, e1, e2 = tris
    n, dev = tmax.shape[0], tmax.device
    t_best = tmax.clone()
    prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for i, q0, f1, f2 in bvh.large:
        t = _tri_test_planar(q0, f1, f2, o, d)
        if any_hit:
            closer = torch.isfinite(t) & (t <= tmax)
        else:
            closer = t < t_best
            t_best = torch.where(closer, t, t_best)
        prim = torch.where(closer, i, prim)
    if bvh.empty:
        return t_best, prim
    o, d = torch.stack(o, -1), torch.stack(d, -1)
    tiny = torch.finfo(o.dtype).tiny
    inv_d = 1.0 / torch.where(d.abs() < tiny, tiny, d)
    stack = torch.zeros((n, MAX_DEPTH), dtype=torch.int32, device=dev)
    sp = torch.ones(n, dtype=torch.int64, device=dev)
    live = tmax > 0
    if any_hit:
        live &= prim < 0
    lanes = torch.nonzero(live).squeeze(1)
    while lanes.numel():
        s = sp[lanes] - 1
        nd = stack[lanes, s].long()
        sp[lanes] = s
        lo = (bvh.bmin[nd] - o[lanes]) * inv_d[lanes]
        hi = (bvh.bmax[nd] - o[lanes]) * inv_d[lanes]
        tnear = torch.minimum(lo, hi).amax(-1)
        tfar = torch.maximum(lo, hi).amin(-1)
        hit = (tnear <= tfar) & (tfar >= 0) & (tnear <= t_best[lanes])
        leaf = bvh.count[nd] > 0
        sel = hit & leaf
        lf, nl = lanes[sel], nd[sel]
        for k in range(LEAF):
            has = k < bvh.count[nl]
            lk, nk = lf[has], nl[has]
            pid = bvh.prims[bvh.start[nk] + k]
            t, _, _ = tri_test(p0[pid], e1[pid], e2[pid], o[lk], d[lk])
            if any_hit:
                closer = torch.isfinite(t) & (t <= tmax[lk])
            else:
                closer = t < t_best[lk]
            lk, pid, t = lk[closer], pid[closer], t[closer]
            if not any_hit:
                # a lane pops one node a round, so lk holds no lane twice
                t_best[lk] = t
            prim[lk] = pid
        sel = hit & ~leaf
        li, ni = lanes[sel], nd[sel]
        # the near child on top: left where the ray runs up the axis
        up_axis = d[li, bvh.axis[ni]] > 0
        near = torch.where(up_axis, bvh.left[ni], bvh.right[ni])
        far = torch.where(up_axis, bvh.right[ni], bvh.left[ni])
        s = sp[li]
        stack[li, s] = far.int()
        stack[li, s + 1] = near.int()
        sp[li] = s + 2
        if any_hit:
            sp[lf[prim[lf] >= 0]] = 0
        lanes = lanes[sp[lanes] > 0]
    return t_best, prim


def closest_hit(bvh: BVH, tris, o, d, tmax):
    """(t, prim): the nearest triangle hit with t < tmax, prim -1 and
    t = tmax where none; o, d planar (x, y, z) tensors."""
    return _walk(bvh, tris, o, d, tmax, any_hit=False)


def any_hit(bvh: BVH, tris, o, d, tmax):
    """Whether some triangle is hit with 0 < t <= tmax."""
    return _walk(bvh, tris, o, d, tmax, any_hit=True)[1] >= 0


def brute_closest_hit(tris, o, d, tmax):
    """Every triangle against every lane: (t, prim) as closest_hit gives
    them (for the tests); o, d as (N, 3) rows."""
    p0, e1, e2 = tris
    t_best = tmax.clone()
    prim = torch.full((o.shape[0],), -1, dtype=torch.int64, device=o.device)
    for i in range(p0.shape[0]):
        t, _, _ = tri_test(p0[i].expand_as(o), e1[i].expand_as(o),
                           e2[i].expand_as(o), o, d)
        closer = t < t_best
        t_best = torch.where(closer, t, t_best)
        prim = torch.where(closer, i, prim)
    return t_best, prim
