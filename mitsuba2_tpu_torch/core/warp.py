"""Sampling warps: measure-preserving maps from [0, 1)^2 to common domains
(counterpart of core/warp.py; same formulas, planar tensors).

Every `square_to_X` has its `square_to_X_pdf` (density with respect to
the solid angle or area measure of the target domain) and, where the
reference has one, an inverse `X_to_square`. A 2D sample comes in as two
(N,) tensors `ua, ub`, a 2D point as `px, py` and returns as a tuple; a
direction is a planar Vec3.
"""
from __future__ import annotations

import math

import torch

from . import math as m
from .vec import Vec3

INV_PI = 1.0 / math.pi
INV_TWO_PI = 1.0 / (2.0 * math.pi)
INV_FOUR_PI = 1.0 / (4.0 * math.pi)


def _const(like, value, mask=None):
    """`value` on the lanes of `like` (where `mask`, else 0)."""
    out = torch.full_like(like, value)
    return out if mask is None else torch.where(mask, out, 0.0)


# ---------------------------------------------------------------------------
# Disk
# ---------------------------------------------------------------------------

def square_to_uniform_disk(ua, ub):
    r = torch.sqrt(ua)
    theta = 2.0 * math.pi * ub
    return r * torch.cos(theta), r * torch.sin(theta)


def square_to_uniform_disk_pdf(px, py):
    return _const(px, INV_PI, px * px + py * py <= 1.0)


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


def uniform_disk_to_square_concentric(px, py):
    """Inverse of the Shirley–Chiu concentric mapping."""
    rr = torch.sqrt(px * px + py * py)
    ang = torch.atan2(py, px)  # [-pi, pi]
    quarter_pi = 0.25 * math.pi
    case_px = ang.abs() <= quarter_pi
    case_py = (ang >= quarter_pi) & (ang <= 3 * quarter_pi)
    case_nx = ang.abs() >= 3 * quarter_pi
    phi_nx = torch.where(ang > 0, ang - math.pi, ang + math.pi)
    x1 = torch.where(case_px, rr, -rr)
    y1 = x1 * torch.where(case_px, ang, phi_nx) / quarter_pi
    phi_ny = ang + math.pi
    y2 = torch.where(case_py, rr, -rr)
    x2 = y2 * (0.5 * math.pi - torch.where(case_py, ang, phi_ny)) / quarter_pi
    x_branch = case_px | case_nx
    x = torch.where(x_branch, x1, x2)
    y = torch.where(x_branch, y1, y2)
    return (x + 1.0) * 0.5, (y + 1.0) * 0.5


# ---------------------------------------------------------------------------
# Sphere / hemisphere / cone
# ---------------------------------------------------------------------------

def square_to_uniform_sphere(ua, ub) -> Vec3:
    z = 1.0 - 2.0 * ua
    r = m.safe_sqrt(1.0 - z * z)
    phi = 2.0 * math.pi * ub
    return Vec3(r * torch.cos(phi), r * torch.sin(phi), z)


def square_to_uniform_sphere_pdf(v: Vec3):
    return _const(v.z, INV_FOUR_PI)


def uniform_sphere_to_square(v: Vec3):
    phi = torch.atan2(v.y, v.x)
    phi = torch.where(phi < 0, phi + 2.0 * math.pi, phi)
    return (1.0 - v.z) * 0.5, phi * INV_TWO_PI


def square_to_uniform_hemisphere(ua, ub) -> Vec3:
    """Uniform hemisphere (+z), through the concentric disk's lift."""
    px, py = square_to_uniform_disk_concentric(ua, ub)
    r2 = px * px + py * py
    z = 1.0 - r2
    s = torch.sqrt(torch.clamp_min(2.0 - r2, 0.0))
    return Vec3(px * s, py * s, z)


def square_to_uniform_hemisphere_pdf(v: Vec3):
    return _const(v.z, INV_TWO_PI, v.z >= 0)


def square_to_cosine_hemisphere(ua, ub) -> Vec3:
    """Cosine-weighted hemisphere via Malley (concentric disk + lift)."""
    px, py = square_to_uniform_disk_concentric(ua, ub)
    z = m.safe_sqrt(1.0 - (px * px + py * py))
    return Vec3(px, py, z)


def square_to_cosine_hemisphere_pdf(v: Vec3):
    return torch.where(v.z >= 0, v.z * INV_PI, 0.0)


def cosine_hemisphere_to_square(v: Vec3):
    return uniform_disk_to_square_concentric(v.x, v.y)


def square_to_uniform_cone(ua, ub, cos_cutoff) -> Vec3:
    """Uniform direction in the cone around +z of cos(angle) >= cos_cutoff."""
    cos_theta = (1.0 - ua) + ua * cos_cutoff
    sin_theta = m.safe_sqrt(1.0 - cos_theta * cos_theta)
    phi = 2.0 * math.pi * ub
    return Vec3(sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
                cos_theta)


def square_to_uniform_cone_pdf(v: Vec3, cos_cutoff):
    return _const(v.z, INV_TWO_PI / (1.0 - cos_cutoff), v.z >= cos_cutoff)


# ---------------------------------------------------------------------------
# Triangle
# ---------------------------------------------------------------------------

def square_to_uniform_triangle(ua, ub):
    """Uniform barycentrics (b0, b1) on the standard triangle."""
    t = m.safe_sqrt(1.0 - ua)
    return 1.0 - t, t * ub


def square_to_uniform_triangle_pdf(b0, b1):
    return _const(b0, 2.0, (b0 >= 0) & (b1 >= 0) & (b0 + b1 <= 1.0))


# ---------------------------------------------------------------------------
# Gaussian / Beckmann / von Mises–Fisher
# ---------------------------------------------------------------------------

def square_to_std_normal(ua, ub):
    """Box–Muller."""
    r = torch.sqrt(-2.0 * torch.log(torch.clamp_min(1.0 - ua, 1e-38)))
    phi = 2.0 * math.pi * ub
    return r * torch.cos(phi), r * torch.sin(phi)


def square_to_std_normal_pdf(px, py):
    return INV_TWO_PI * torch.exp(-0.5 * (px * px + py * py))


def square_to_beckmann(ua, ub, alpha) -> Vec3:
    """The isotropic Beckmann distribution of normals."""
    phi = 2.0 * math.pi * ub
    tan_theta_2 = -alpha * alpha * torch.log(torch.clamp_min(1.0 - ua, 1e-38))
    cos_theta = torch.rsqrt(1.0 + tan_theta_2)   # XLA's 1 / sqrt
    sin_theta = m.safe_sqrt(1.0 - cos_theta * cos_theta)
    return Vec3(sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
                cos_theta)


def square_to_beckmann_pdf(v: Vec3, alpha):
    cos_theta = v.z
    tan_theta_2 = (torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0)
                   / torch.clamp_min(cos_theta * cos_theta, 1e-20))
    a2 = alpha * alpha
    pdf = (torch.exp(-tan_theta_2 / a2)
           / (math.pi * a2 * torch.clamp_min(cos_theta, 1e-20) ** 3))
    return torch.where(cos_theta > 0, pdf, 0.0)


def square_to_von_mises_fisher(ua, ub, kappa: float) -> Vec3:
    """The vMF distribution around +z of concentration kappa (warp.cpp)."""
    kappa = float(kappa)
    if kappa <= 0.0:
        cos_theta = 1.0 - 2.0 * ua
    else:
        e2k = float(torch.exp(torch.tensor(-2.0 * kappa)))
        cos_theta = 1.0 + torch.log(ua + (1.0 - ua) * e2k) / max(kappa, 1e-20)
    sin_theta = m.safe_sqrt(1.0 - cos_theta * cos_theta)
    phi = 2.0 * math.pi * ub
    return Vec3(sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
                cos_theta)


def square_to_von_mises_fisher_pdf(v: Vec3, kappa: float):
    kappa = float(kappa)
    if kappa <= 0.0:
        return _const(v.z, INV_FOUR_PI)
    e2k = float(torch.exp(torch.tensor(-2.0 * kappa)))
    return (torch.exp(kappa * (v.z - 1.0)) * kappa
            / (2.0 * math.pi * (1.0 - e2k)))


# ---------------------------------------------------------------------------
# Tent (reconstruction-filter importance sampling)
# ---------------------------------------------------------------------------

def interval_to_tent(u):
    """[0, 1) -> [-1, 1] with the tent density 1 - |x|."""
    u2 = 2.0 * u - 1.0
    return torch.where(u2 >= 0, 1.0 - torch.sqrt(torch.clamp_min(1.0 - u2, 0.0)),
                       torch.sqrt(torch.clamp_min(u2 + 1.0, 0.0)) - 1.0)


def square_to_tent(ua, ub):
    return interval_to_tent(ua), interval_to_tent(ub)


def square_to_tent_pdf(px, py):
    inside = (px.abs() <= 1) & (py.abs() <= 1)
    return torch.where(inside, (1.0 - px.abs()) * (1.0 - py.abs()), 0.0)


def interval_to_nonuniform_tent(u, a: float, b: float, c: float):
    """[0, 1) -> [a, c], a tent peaked at b."""
    u_pivot = (b - a) / (c - a)
    lo = u < u_pivot
    factor = torch.where(lo, a - b, c - b)
    u2 = torch.where(lo, u * ((a - c) / (a - b)),
                     ((a - c) / (b - c)) * (u - u_pivot))
    return b + factor * (1.0 - m.safe_sqrt(torch.clamp(u2, 0.0, 1.0)))
