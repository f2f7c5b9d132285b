"""Brute-force intersection for small scenes (counterpart of
kernels/brute.py, which is plain XLA: this is plain torch).

Every prim is tested against every lane, one prim per loop step; scenes
of MAX_BRUTE_PRIMS prims or fewer (the Cornell box) take this path.
Triangle scenes only. The lowest prim index wins on equal t (`t < t_best`).
"""
from __future__ import annotations

import torch

MAX_BRUTE_PRIMS = 192


def _intersect_one(scene, i, ox, oy, oz, dx, dy, dz):
    """All lanes against triangle i: Möller–Trumbore -> (t, u, v)."""
    p0x, p0y, p0z = scene.prim_p0[i].unbind(0)
    e1x, e1y, e1z = scene.prim_e1[i].unbind(0)
    e2x, e2y, e2z = scene.prim_e2[i].unbind(0)
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv_det = 1.0 / torch.where(det.abs() < 1e-12, float("inf"), det)
    tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    hit = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    return torch.where(hit, t, float("inf")), u, v


def ray_intersect_brute(scene, ray_o, ray_d, t_max):
    """Closest hit by testing every prim: (t, prim, u, v)."""
    ox, oy, oz = ray_o.x, ray_o.y, ray_o.z
    dx, dy, dz = ray_d.x, ray_d.y, ray_d.z
    n = oz.shape[0]
    t_best = t_max.expand(n).clone()
    prim = torch.full((n,), -1, dtype=torch.int32, device=oz.device)
    bu = torch.zeros_like(t_best)
    bv = torch.zeros_like(t_best)
    for i in range(scene.n_prims):
        t, u, v = _intersect_one(scene, i, ox, oy, oz, dx, dy, dz)
        closer = t < t_best
        t_best = torch.where(closer, t, t_best)
        prim = torch.where(closer, i, prim)
        bu = torch.where(closer, u, bu)
        bv = torch.where(closer, v, bv)
    return torch.where(prim >= 0, t_best, float("inf")), prim, bu, bv


def ray_test_brute(scene, ray_o, ray_d, t_max):
    """Any hit within t_max by testing every prim."""
    ox, oy, oz = ray_o.x, ray_o.y, ray_o.z
    dx, dy, dz = ray_d.x, ray_d.y, ray_d.z
    occluded = torch.zeros(oz.shape[0], dtype=torch.bool, device=oz.device)
    for i in range(scene.n_prims):
        t, _, _ = _intersect_one(scene, i, ox, oy, oz, dx, dy, dz)
        occluded = occluded | (torch.isfinite(t) & (t <= t_max))
    return occluded
