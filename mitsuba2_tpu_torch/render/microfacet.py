"""Microfacet distributions: GGX and Beckmann with anisotropy
(counterpart of render/microfacet.py; the same f32 arithmetic in the same
order).

`eval_d` (the NDF D), `smith_g1`, `g_smith`, `sample` and `pdf`. GGX
samples visible normals (Heitz 2018), Beckmann the whole NDF (the JAX
package's choice, kept: ROADMAP.md Queue 3). Directions are planar Vec3 in
the local shading frame; `dist` is a per-lane int32 (0 GGX, 1 Beckmann).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from ..core import math as m
from ..core.vec import Vec3, vdot, vnormalize, vwhere

GGX = 0
BECKMANN = 1


def eval_d(dist, m_dir: Vec3, alpha_u, alpha_v):
    """NDF D(m)."""
    cos2 = m_dir.z * m_dir.z
    xa = m_dir.x / alpha_u
    ya = m_dir.y / alpha_v
    inv_norm = 1.0 / (math.pi * alpha_u * alpha_v)
    denom_g = xa * xa + ya * ya + cos2
    d_ggx = inv_norm / torch.clamp_min(denom_g * denom_g, 1e-20)
    t2 = (xa * xa + ya * ya) / torch.clamp_min(cos2, 1e-20)
    d_bk = inv_norm * torch.exp(-t2) / torch.clamp_min(cos2 * cos2, 1e-20)
    d = torch.where(dist == GGX, d_ggx, d_bk)
    return torch.where(m_dir.z > 0, d, 0.0)


def smith_g1(dist, v: Vec3, m_dir: Vec3, alpha_u, alpha_v):
    """Monodirectional Smith shadowing-masking G1(v, m)."""
    xy_alpha_2 = (alpha_u * v.x) ** 2 + (alpha_v * v.y) ** 2
    cos2 = v.z * v.z
    tan_theta_alpha_2 = xy_alpha_2 / torch.clamp_min(cos2, 1e-20)
    g_ggx = 2.0 / (1.0 + torch.sqrt(1.0 + tan_theta_alpha_2))
    # NaN-safe under autograd (the backward of an UNSELECTED where branch
    # gets a zero cotangent, and 0 * inf = NaN): (a) the eps goes INSIDE
    # the sqrt, whose derivative at 0 is infinite; (b) `a` is clamped to
    # the rational's selected range: unclamped, a^2 overflows f32 to inf
    # at tan -> 0 and inf/inf = NaN poisons d(alpha) though the branch is
    # discarded. (eps 1e-30, not smaller: f32 denormals may flush to zero,
    # which would put the infinite sqrt derivative back)
    a = 1.0 / torch.sqrt(torch.clamp_min(tan_theta_alpha_2, 1e-30))
    a_s = torch.clamp_max(a, 1.6)
    a2 = a_s * a_s
    g_bk = torch.where(a >= 1.6, 1.0,
                       (3.535 * a_s + 2.181 * a2) /
                       (1.0 + 2.276 * a_s + 2.577 * a2))
    g = torch.where(dist == GGX, g_ggx, g_bk)
    same_side = (vdot(v, m_dir) * v.z) > 0
    g = torch.where(same_side, g, 0.0)
    return torch.where(xy_alpha_2 == 0.0, 1.0, g)


def g_smith(dist, wi: Vec3, wo: Vec3, m_dir: Vec3, alpha_u, alpha_v):
    """Separable Smith G = G1(wi) G1(wo)."""
    return (smith_g1(dist, wi, m_dir, alpha_u, alpha_v) *
            smith_g1(dist, wo, m_dir, alpha_u, alpha_v))


def _sample_vndf_ggx(wi: Vec3, alpha_u, alpha_v, ua, ub) -> Vec3:
    """Heitz 2018 visible-normal sampling for GGX (the caller flips wi
    into the upper hemisphere)."""
    vh = vnormalize(Vec3(alpha_u * wi.x, alpha_v * wi.y, wi.z))
    lensq = vh.x * vh.x + vh.y * vh.y
    inv_len = 1.0 / torch.sqrt(torch.clamp_min(lensq, 1e-20))
    zero, one = torch.zeros_like(inv_len), torch.ones_like(inv_len)
    t1 = vwhere(lensq > 1e-12,
                Vec3(-vh.y * inv_len, vh.x * inv_len, zero),
                Vec3(one, zero, zero))
    t2 = Vec3(vh.y * t1.z - vh.z * t1.y,
              vh.z * t1.x - vh.x * t1.z,
              vh.x * t1.y - vh.y * t1.x)
    r = torch.sqrt(ua)
    phi = 2.0 * math.pi * ub
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh.z)
    # safe_sqrt: the JAX package's sqrt(max(x, 0)), whose derivative at
    # x = 0 is infinite (0 * inf = NaN in a backward sweep)
    p2 = (1.0 - s) * m.safe_sqrt(1.0 - p1 * p1) + s * p2
    pz = m.safe_sqrt(1.0 - p1 * p1 - p2 * p2)
    nh = t1 * p1 + t2 * p2 + vh * pz
    return vnormalize(Vec3(alpha_u * nh.x, alpha_v * nh.y,
                           torch.clamp_min(nh.z, 1e-6)))


def sample(dist, wi: Vec3, alpha_u, alpha_v, u) -> Tuple[Vec3, torch.Tensor]:
    """A microfacet normal m for incident wi and its pdf, from u = (ua,
    ub). GGX: the visible-normal distribution (pdf = G1 |wi.m| D / |cos
    wi|); Beckmann: the NDF (pdf = D cos_m)."""
    ua, ub = u
    wi_f = vwhere(wi.z < 0, -wi, wi)
    m_ggx = _sample_vndf_ggx(wi_f, alpha_u, alpha_v, ua, ub)
    # Beckmann (anisotropy via the phi-scaling trick, Heitz)
    phi = 2.0 * math.pi * ub
    cp = torch.cos(phi) * alpha_u
    sp = torch.sin(phi) * alpha_v
    norm = torch.sqrt(torch.clamp_min(cp * cp + sp * sp, 1e-30))
    cp, sp = cp / norm, sp / norm
    alpha2 = 1.0 / torch.clamp_min((cp / alpha_u) ** 2 + (sp / alpha_v) ** 2,
                                   1e-20)
    tan2 = -alpha2 * torch.log(torch.clamp_min(1.0 - ua, 1e-38))
    cos_t = 1.0 / torch.sqrt(1.0 + tan2)
    sin_t = m.safe_sqrt(1.0 - cos_t * cos_t)
    m_bk = Vec3(sin_t * cp, sin_t * sp, cos_t)

    m_out = vwhere(dist == GGX, m_ggx, m_bk)
    return m_out, pdf(dist, wi, m_out, alpha_u, alpha_v)


def pdf(dist, wi: Vec3, m_dir: Vec3, alpha_u, alpha_v):
    """The pdf of `sample` with respect to the solid angle of m."""
    d = eval_d(dist, m_dir, alpha_u, alpha_v)
    wi_f = vwhere(wi.z < 0, -wi, wi)
    pdf_ggx = (smith_g1(dist, wi_f, m_dir, alpha_u, alpha_v) *
               vdot(wi_f, m_dir).abs() * d /
               torch.clamp_min(wi_f.z.abs(), 1e-20))
    pdf_bk = d * m_dir.z
    return torch.where(dist == GGX, pdf_ggx, torch.clamp_min(pdf_bk, 0.0))
