"""Fresnel terms for dielectrics and conductors (counterpart of
render/fresnel.py; the same f32 arithmetic in the same order).

`fresnel` takes the SIGNED cosine (positive = outside) and the relative
IOR eta = n_transmitted / n_incident for the outside case, handles total
internal reflection and returns the eta bookkeeping of the dielectric
BSDFs.
"""
from __future__ import annotations

import torch

from ..core import math as m
from ..core.spec import Spec
from ..core.vec import Vec3, vdot


def fresnel(cos_theta_i, eta):
    """Unpolarized dielectric Fresnel: (F, cos_theta_t, eta_it, eta_ti).

    F            reflectance
    cos_theta_t  SIGNED cosine of the transmitted direction (opposite
                 hemisphere to cos_theta_i); 0 under TIR
    eta_it       relative IOR along incident->transmitted
    eta_ti       its reciprocal (used by `refract`)
    """
    eta = torch.as_tensor(eta, dtype=torch.float32,
                          device=cos_theta_i.device)
    outside = cos_theta_i >= 0.0
    rcp_eta = 1.0 / eta
    eta_it = torch.where(outside, eta, rcp_eta)
    eta_ti = torch.where(outside, rcp_eta, eta)

    cos_theta_t_sqr = 1.0 - eta_ti * eta_ti * (1.0 - cos_theta_i * cos_theta_i)
    cos_i_abs = cos_theta_i.abs()
    cos_t_abs = m.safe_sqrt(cos_theta_t_sqr)

    index_matched = eta == 1.0
    tir = cos_theta_t_sqr <= 0.0

    a_s = ((cos_i_abs - eta_it * cos_t_abs)
           / torch.clamp_min(cos_i_abs + eta_it * cos_t_abs, 1e-20))
    a_p = ((eta_it * cos_i_abs - cos_t_abs)
           / torch.clamp_min(eta_it * cos_i_abs + cos_t_abs, 1e-20))
    F = 0.5 * (a_s * a_s + a_p * a_p)
    F = torch.where(tir, 1.0, F)
    F = torch.where(index_matched, 0.0, F)

    cos_theta_t = m.mulsign(cos_t_abs, -cos_theta_i)
    cos_theta_t = torch.where(tir, 0.0, cos_theta_t)
    return F, cos_theta_t, eta_it, eta_ti


def fresnel_conductor(cos_theta_i, eta, k):
    """Unpolarized conductor Fresnel with complex IOR eta + i k; eta and k
    may be planar Specs (evaluated channel by channel) or tensors."""
    if isinstance(eta, Spec):
        return Spec(tuple(fresnel_conductor(cos_theta_i, e, kk)
                          for e, kk in zip(eta.ch, k.ch)))
    cos_theta_i_2 = cos_theta_i * cos_theta_i
    sin_theta_i_2 = 1.0 - cos_theta_i_2
    sin_theta_i_4 = sin_theta_i_2 * sin_theta_i_2

    temp_1 = eta * eta - k * k - sin_theta_i_2
    a_2_pb_2 = m.safe_sqrt(temp_1 * temp_1 + 4.0 * k * k * eta * eta)
    a = m.safe_sqrt(0.5 * (a_2_pb_2 + temp_1))

    term_1 = a_2_pb_2 + cos_theta_i_2
    term_2 = 2.0 * a * cos_theta_i
    r_s = (term_1 - term_2) / torch.clamp_min(term_1 + term_2, 1e-20)

    term_3 = a_2_pb_2 * cos_theta_i_2 + sin_theta_i_4
    term_4 = term_2 * sin_theta_i_2
    r_p = r_s * (term_3 - term_4) / torch.clamp_min(term_3 + term_4, 1e-20)

    return 0.5 * (r_s + r_p)


def reflect(wi: Vec3) -> Vec3:
    """Mirror reflection in the local frame (n = +z)."""
    return Vec3(-wi.x, -wi.y, wi.z)


def reflect_m(wi: Vec3, m_dir: Vec3) -> Vec3:
    """Reflection about an arbitrary normal m."""
    return m_dir * (2.0 * vdot(wi, m_dir)) - wi


def refract(wi: Vec3, cos_theta_t, eta_ti) -> Vec3:
    """Refraction in the local frame given fresnel()'s outputs."""
    return Vec3(-eta_ti * wi.x, -eta_ti * wi.y, cos_theta_t)


def refract_m(wi: Vec3, m_dir: Vec3, cos_theta_t, eta_ti) -> Vec3:
    """Refraction about an arbitrary normal m (fresnel.h::refract)."""
    mu = vdot(wi, m_dir) * eta_ti + cos_theta_t
    return m_dir * mu - wi * eta_ti


def fresnel_diffuse_reflectance(eta):
    """Average Fresnel reflectance for diffuse illumination (Egan &
    Hilgeman fit): eta > 1 external, eta < 1 internal."""
    eta = torch.as_tensor(eta, dtype=torch.float32)
    e2 = eta * eta
    e3 = e2 * eta
    f_ext = -1.4399 / e2 + 0.7099 / eta + 0.6681 + 0.0636 * eta
    f_int = (0.919317 - 3.4793 * eta + 6.75335 * e2 - 7.80989 * e3 +
             4.98554 * e3 * eta - 1.36881 * e3 * e2)
    return torch.where(eta >= 1.0, f_ext, f_int)
