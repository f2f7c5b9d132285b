"""Mueller calculus for polarized transport (counterpart of
render/mueller.py).

Stokes vectors are (..., 4) tensors (I, Q, U, V), Mueller matrices
(..., 4, 4), in the reference's conventions (include/mitsuba/render/
mueller.h): the Stokes basis' +Q is horizontal in the local frame, and
angles are counter-clockwise looking INTO the propagating beam. The
complex Fresnel amplitudes of a conductor are complex64, as in the JAX
package; every function takes and returns float32 tensors.
"""
from __future__ import annotations

import torch

from ..core.math import safe_rsqrt


def _f32(x, like=None):
    dev = like.device if torch.is_tensor(like) else None
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _matrix(rows):
    """4 x 4 nested lists of (...) tensors -> (..., 4, 4)."""
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def depolarizer(value=1.0):
    """Depolarizing Mueller matrix scaling total intensity (mueller.h)."""
    value = _f32(value)
    m = torch.zeros(value.shape + (4, 4), dtype=torch.float32,
                    device=value.device)
    m[..., 0, 0] = value
    return m


def absorber(value=1.0):
    """Ideal absorber: uniform attenuation of all Stokes components."""
    value = _f32(value)
    return (torch.eye(4, dtype=torch.float32, device=value.device)
            * value[..., None, None])


def linear_polarizer(value=1.0):
    """Ideal linear polarizer along +Q (horizontal), transmission `value`."""
    v = _f32(value) * 0.5
    z = torch.zeros_like(v)
    return _matrix([[v, v, z, z], [v, v, z, z], [z, z, z, z], [z, z, z, z]])


def linear_retarder(phase):
    """Linear retarder with its fast axis horizontal, retardance `phase`
    rad (quarter-wave plate: pi / 2; half-wave: pi)."""
    phase = _f32(phase)
    c, s = torch.cos(phase), torch.sin(phase)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _matrix([[o, z, z, z], [z, o, z, z], [z, z, c, -s], [z, z, s, c]])


def rotator(theta):
    """Rotation of the Stokes reference frame by theta (mueller.h::
    rotator): the doubled angles on Q and U."""
    theta = _f32(theta)
    c, s = torch.cos(2 * theta), torch.sin(2 * theta)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _matrix([[o, z, z, z], [z, c, s, z], [z, -s, c, z], [z, z, z, o]])


def rotated_element(theta, m):
    """Element `m` with its axis rotated by theta: R(theta) @ m @
    R(-theta) (mueller.h::rotated_element)."""
    theta = _f32(theta, m)
    return rotator(theta) @ m @ rotator(-theta)


def _fresnel_amplitudes_conductor(cos_theta_i, eta_re, eta_im):
    """Complex r_s, r_p of a conductor (complex relative IOR), complex64."""
    eta = torch.complex(_f32(eta_re), _f32(eta_im))
    ct = _f32(cos_theta_i).to(torch.complex64)
    st2 = 1.0 - ct * ct
    ctt = torch.sqrt(1.0 - st2 / (eta * eta))
    r_s = (ct - eta * ctt) / (ct + eta * ctt)
    r_p = (eta * ct - ctt) / (eta * ct + ctt)
    return r_s, r_p


def _fresnel_amplitudes_dielectric(cos_theta_i, eta):
    """Real r_s, r_p of a dielectric; total internal reflection clamps them
    to +-1."""
    ct = torch.abs(_f32(cos_theta_i))
    eta = _f32(eta, ct)
    st2 = 1.0 - ct * ct
    inner = 1.0 - st2 / (eta * eta)
    tir = inner < 0
    ctt = torch.sqrt(torch.clamp_min(inner, 0.0))
    r_s = (ct - eta * ctt) / (ct + eta * ctt)
    r_p = (eta * ct - ctt) / (eta * ct + ctt)
    return torch.where(tir, 1.0, r_s), torch.where(tir, -1.0, r_p)


def _amplitudes_to_mueller(r_s, r_p):
    """Jones reflection amplitudes -> Mueller matrix (mueller.h::
    specular_reflection's construction)."""
    a = torch.abs(r_s) ** 2
    b = torch.abs(r_p) ** 2
    cross = r_s * torch.conj(r_p)
    c, s = cross.real, cross.imag
    m00 = 0.5 * (a + b)
    m01 = 0.5 * (a - b)
    z = torch.zeros_like(m00)
    return _matrix([[m00, m01, z, z], [m01, m00, z, z], [z, z, c, s],
                    [z, z, -s, c]])


def specular_reflection_conductor(cos_theta_i, eta_re, eta_im):
    """Mueller matrix of specular reflection off a conductor."""
    return _amplitudes_to_mueller(
        *_fresnel_amplitudes_conductor(cos_theta_i, eta_re, eta_im))


def specular_reflection_dielectric(cos_theta_i, eta):
    """Mueller matrix of specular reflection off a dielectric."""
    r_s, r_p = _fresnel_amplitudes_dielectric(cos_theta_i, eta)
    return _amplitudes_to_mueller(r_s.to(torch.complex64),
                                  r_p.to(torch.complex64))


def specular_transmission_dielectric(cos_theta_i, eta):
    """Mueller matrix of specular refraction into a dielectric
    (mueller.h::specular_transmission), with the radiance-compression
    solid-angle factor; zero under total internal reflection."""
    ct = torch.abs(_f32(cos_theta_i))
    eta = _f32(eta, ct)
    st2 = 1.0 - ct * ct
    inner = 1.0 - st2 / (eta * eta)
    valid = inner > 0
    ctt = torch.sqrt(torch.clamp_min(inner, 1e-20))
    t_s = 2.0 * ct / (ct + eta * ctt)
    t_p = 2.0 * ct / (eta * ct + ctt)
    factor = (ctt / ct) * eta
    a = t_s * t_s * factor
    b = t_p * t_p * factor
    m00 = 0.5 * (a + b)
    m01 = 0.5 * (a - b)
    c = t_s * t_p * factor
    z = torch.zeros_like(m00)
    m = _matrix([[m00, m01, z, z], [m01, m00, z, z], [z, z, c, z],
                 [z, z, z, c]])
    return torch.where(valid[..., None, None], m, 0.0)


def normalize(v):
    """(..., 3) rows to unit length (core/geometry.py::normalize)."""
    return v * safe_rsqrt(torch.sum(v * v, -1, keepdim=True))


def stokes_basis(w):
    """The canonical perpendicular of propagation direction w (..., 3)
    (mueller.h::stokes_basis): coordinate_system's first tangent, the
    horizontal (+Q) axis."""
    w = _f32(w)
    sign = torch.where(w[..., 2] >= 0, 1.0, -1.0)
    a = -1.0 / (sign + w[..., 2])
    b = w[..., 0] * w[..., 1] * a
    return torch.stack([1.0 + sign * w[..., 0] ** 2 * a, sign * b,
                        -sign * w[..., 0]], -1)


def rotate_stokes_basis(w, basis_old, basis_new):
    """The Mueller rotator that turns basis_old into basis_new about w
    (mueller.h::rotate_stokes_basis)."""
    cos_t = torch.sum(basis_old * basis_new, -1)
    sin_t = torch.sum(torch.linalg.cross(basis_old, basis_new) * w, -1)
    return rotator(torch.atan2(sin_t, cos_t))


def unpolarized_intensity(m00_scale):
    """The Stokes vector of unpolarized light of intensity I."""
    i = _f32(m00_scale)
    z = torch.zeros_like(i)
    return torch.stack([i, z, z, z], -1)
