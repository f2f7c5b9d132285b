"""Brute-force intersection for small scenes (counterpart of
kernels/brute.py, which is plain XLA: this is plain torch).

Every prim is tested against every lane, one prim per loop step; scenes
of MAX_BRUTE_PRIMS prims or fewer (the Cornell box, the furnace) take
this path. Triangles by Möller–Trumbore, spheres by the stable
quadratic (`tri_test`, `sphere_test`: the BVH2 walks' twins test prims
with the same two functions). The lowest prim index wins on equal t
(`t < t_best`).
"""
from __future__ import annotations

import torch

from ..scene.shapes import PRIM_TRI

MAX_BRUTE_PRIMS = 192


def takes_brute_force(n_prims: int, has_instances: bool) -> bool:
    """The JAX package's rule: flat scenes of MAX_BRUTE_PRIMS prims or
    fewer. Never an instanced scene, whatever its size: its prim tables are
    local-space, which brute force would test as they stand."""
    return not has_instances and n_prims <= MAX_BRUTE_PRIMS


def tri_test(p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z, ox, oy, oz, dx,
             dy, dz):
    """Möller–Trumbore in the BVH2 kernels' order of operations ->
    (t, u, v), t = +inf where missed. A |det| under 1e-12 misses."""
    tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv = torch.where(det.abs() < 1e-12, 0.0, 1.0 / det)
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
    ok = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
          & (inv != 0.0))
    return torch.where(ok, t, float("inf")), u, v


def sphere_test(cx, cy, cz, r, ox, oy, oz, dx, dy, dz):
    """The stable quadratic for a sphere (center c, radius r) -> t, +inf
    where missed: the nearer root if it lies ahead, else the farther. d
    need not be unit (A = |d|^2), so t holds in instance space too."""
    inf = float("inf")
    tvx, tvy, tvz = ox - cx, oy - cy, oz - cz
    A = dx * dx + dy * dy + dz * dz
    B = 2.0 * (tvx * dx + tvy * dy + tvz * dz)
    C = tvx * tvx + tvy * tvy + tvz * tvz - r * r
    disc = B * B - 4.0 * A * C
    # the square root correctly rounded, as the kernels' sqrtf is: a float's
    # root taken in f64 rounds to the right f32, while torch's f32 root on
    # the CPU can miss it by an ulp
    sq = torch.sqrt(torch.clamp_min(disc, 0.0).double()).float()
    qq = -0.5 * (B + torch.sign(B) * sq)
    t0 = torch.where(A.abs() > 1e-20, qq / A, inf)
    t1 = torch.where(qq.abs() > 1e-20, C / qq, inf)
    lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
    t = torch.where(lo > 0.0, lo, hi)
    return torch.where((disc >= 0.0) & (t > 0.0), t, inf)


def _intersect_one(scene, i, sphere, ox, oy, oz, dx, dy, dz):
    """All lanes against prim i (a sphere if `sphere`) -> (t, u, v);
    t = +inf where missed, and u = v = 0 for a sphere."""
    p0 = scene.prim_p0[i].unbind(0)
    e1 = scene.prim_e1[i].unbind(0)
    if not sphere:
        return tri_test(*p0, *e1, *scene.prim_e2[i].unbind(0), ox, oy, oz,
                        dx, dy, dz)
    # sphere (center p0, radius e1.x)
    t = sphere_test(*p0, e1[0], ox, oy, oz, dx, dy, dz)
    z = torch.zeros_like(t)
    return t, z, z


def ray_intersect_brute(scene, ray_o, ray_d, t_max):
    """Closest hit by testing every prim: (t, prim, u, v)."""
    ox, oy, oz = ray_o.x, ray_o.y, ray_o.z
    dx, dy, dz = ray_d.x, ray_d.y, ray_d.z
    n = oz.shape[0]
    t_best = t_max.expand(n).clone()
    prim = torch.full((n,), -1, dtype=torch.int32, device=oz.device)
    bu = torch.zeros_like(t_best)
    bv = torch.zeros_like(t_best)
    for i, ptype in enumerate(scene.prim_type.tolist()):
        t, u, v = _intersect_one(scene, i, ptype != PRIM_TRI, ox, oy, oz,
                                 dx, dy, dz)
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
    for i, ptype in enumerate(scene.prim_type.tolist()):
        t, _, _ = _intersect_one(scene, i, ptype != PRIM_TRI, ox, oy, oz,
                                 dx, dy, dz)
        occluded = occluded | (torch.isfinite(t) & (t <= t_max))
    return occluded
