"""Sampling warps the diffuse BSDF and the area and constant emitters
draw with (counterpart of core/warp.py; same formulas, planar tensors)."""
from __future__ import annotations

import math

import torch

from . import math as m
from .vec import Vec3

INV_PI = 1.0 / math.pi
INV_FOUR_PI = 1.0 / (4.0 * math.pi)


def square_to_uniform_disk_concentric(ua, ub):
    """Shirley–Chiu concentric disk mapping."""
    x = 2.0 * ua - 1.0
    y = 2.0 * ub - 1.0
    is_zero = (x == 0.0) & (y == 0.0)
    quadrant_1_or_3 = x.abs() < y.abs()
    r = torch.where(quadrant_1_or_3, y, x)
    rp = torch.where(quadrant_1_or_3, x, y)
    phi = 0.25 * math.pi * rp / torch.where(r == 0.0, 1.0, r)
    phi = torch.where(quadrant_1_or_3, 0.5 * math.pi - phi, phi)
    phi = torch.where(is_zero, 0.0, phi)
    return r * torch.cos(phi), r * torch.sin(phi)


def square_to_cosine_hemisphere(ua, ub) -> Vec3:
    """Cosine-weighted hemisphere via Malley (concentric disk + lift)."""
    px, py = square_to_uniform_disk_concentric(ua, ub)
    z = m.safe_sqrt(1.0 - (px * px + py * py))
    return Vec3(px, py, z)


def square_to_cosine_hemisphere_pdf(v: Vec3):
    return torch.where(v.z >= 0, v.z * INV_PI, 0.0)


def square_to_uniform_triangle(ua, ub):
    """Uniform barycentrics (b0, b1) on the standard triangle."""
    t = m.safe_sqrt(1.0 - ua)
    return 1.0 - t, t * ub


def square_to_uniform_sphere(ua, ub) -> Vec3:
    z = 1.0 - 2.0 * ua
    r = m.safe_sqrt(1.0 - z * z)
    phi = 2.0 * math.pi * ub
    return Vec3(r * torch.cos(phi), r * torch.sin(phi), z)
