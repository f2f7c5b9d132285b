"""BSDF layer (counterpart of render/bsdf.py): the leaf families, the
wrappers and `twosided`.

A family is a set of pure functions over a packed material row; the
wavefront dispatch is masked evaluate-all over the families present in
the scene, as in the JAX package. The leaves are diffuse, conductor,
roughconductor, dielectric, thindielectric, roughdielectric, plastic,
roughplastic, null and the ideal optical elements polarizer and
retarder; the wrappers mask, blendbsdf, normalmap and bumpmap hold their
children's row indices (cols 30 and 31) and dispatch them per lane, and
measured and measured_polarized read the scene's tabulated BRDFs
(render/measured.py, SceneData.measured) by the table id in col 28;
`twosided` is a flag on its child's row (the dispatch flips the local
frame of a lane that hits it from behind). Any color slot may be a
texture (render/texture.py), and the rough families' roughness too
(ALPHA_SLOT). The polarizing action of polarizer, retarder and
measured_polarized lives in the polarized integrator (render/stokes.py).

Conventions follow the reference: directions in the LOCAL shading frame,
`wi` points away from the surface, `sample(u1, u2)` returns (BSDFSample,
weight = f * cos / pdf), radiance transport (the eta^2 compression on
refraction).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..core import warp
from ..core.geometry import Frame
from ..core.spec import Spec, swhere
from ..core.spectrum import _clip as sp_clip, _max as sp_max
from ..core.vec import Vec2, Vec3, vdot, vnormalize, vwhere
from . import fresnel as fr
from . import ior as ior_mod
from . import measured as measured_mod
from . import microfacet as mf
from . import rgl
from .spectra import LaneRows, SLOT_W, eval_spectrum_slot, pack_color

MAT_W = 40
# cols [0:24]: three 8-wide spectrum slots (family-specific)
# cols [24:32]: family-specific scalars (alphas, IOR ratios, child rows)
# cols [32:40]: ALPHA_SLOT, the rough families' roughness texture (its
#   channel mean, isotropic); all zero for a scalar roughness
ALPHA_SLOT = 32

# BSDFFlags (include/mitsuba/render/bsdf.h)
F_NULL = 1 << 0
F_DIFFUSE_R = 1 << 1
F_DIFFUSE_T = 1 << 2
F_GLOSSY_R = 1 << 3
F_GLOSSY_T = 1 << 4
F_DELTA_R = 1 << 5
F_DELTA_T = 1 << 6
F_TWOSIDED_FLAG = 1 << 16  # dispatch-layer frame flip (bsdfs/twosided.cpp)
F_SMOOTH = F_DIFFUSE_R | F_DIFFUSE_T | F_GLOSSY_R | F_GLOSSY_T
F_DELTA = F_DELTA_R | F_DELTA_T

# Family ids
DIFFUSE = 0
CONDUCTOR = 1
ROUGHCONDUCTOR = 2
DIELECTRIC = 3
THINDIELECTRIC = 4
ROUGHDIELECTRIC = 5
PLASTIC = 6
ROUGHPLASTIC = 7
NULL_BSDF = 8
MASK = 9
BLEND = 10
NORMALMAP = 11
BUMPMAP = 12
MEASURED = 13
POLARIZER = 14
RETARDER = 15
MEASURED_POLARIZED = 16

_DIST_NAME = {"ggx": mf.GGX, "beckmann": mf.BECKMANN}


@dataclasses.dataclass
class BSDFSample:
    wo: Vec3
    pdf: torch.Tensor
    eta: torch.Tensor
    sampled_flags: torch.Tensor


def _zero_sample(n, dev):
    z = torch.zeros(n, dtype=torch.float32, device=dev)
    return BSDFSample(wo=Vec3(z, z, z), pdf=z, eta=torch.ones_like(z),
                      sampled_flags=torch.zeros(n, dtype=torch.int32,
                                                device=dev))


def _flags(active, flag):
    return torch.where(active, flag, 0).to(torch.int32)


def _flags2(active, pick, flag_a, flag_b):
    return torch.where(active, torch.where(pick, flag_a, flag_b),
                       0).to(torch.int32)


def _duv(si):
    return None if si.duv_dx is None else (si.duv_dx, si.duv_dy)


def _tex(data, i, si):
    """The atlas where slot i of the lanes' rows may be a texture, else
    None: no row of the family textures it, and the lookup the JAX
    package makes there on every lane, its value discarded, is skipped."""
    return si.tex if i in data.textured else None


def _spec(data, i, si, config) -> Spec:
    return eval_spectrum_slot(data.slot(i), si.wavelengths, config.color_mode,
                              tex=_tex(data, i, si), uv=si.uv, duv=_duv(si))


def _pack_alpha(data, props, key="alpha", default=0.1) -> float:
    """Host: a scalar roughness, for its column; a texture packs into
    ALPHA_SLOT (isotropic, alpha_u and alpha_v share it) and the column
    takes the mean of its slot's RGB columns."""
    a = props.get(key, default)
    if isinstance(a, dict):
        slot = pack_color(a)
        data[ALPHA_SLOT:ALPHA_SLOT + SLOT_W] = slot
        return float(np.mean(slot[0:3]))
    return float(a)


def _alpha_tex(data, si, au, av):
    """Where ALPHA_SLOT holds a texture (kind column >= 2), a lane's
    roughness is the texture's channel mean at its uv (Texture::eval_1),
    for both alphas; skipped where no material of the scene has one."""
    if _tex(data, ALPHA_SLOT // SLOT_W, si) is None:
        return au, av
    from . import texture as texture_mod
    kind = data.col(ALPHA_SLOT + 7).to(torch.int64)
    tid = torch.clamp_min(torch.div(kind - 2, 2, rounding_mode="floor"), 0)
    rgb = texture_mod.eval_rgb(si.tex, tid, si.uv, duv=_duv(si))
    a = sp_max(sum(rgb.ch) / len(rgb.ch), 1e-4)
    is_tex = kind >= 2
    return torch.where(is_tex, a, au), torch.where(is_tex, a, av)


def _f64_derivative(value, exact):
    """`value` (f32) as it stands, with the derivative of `exact`, the same
    quantity computed in f64: value + (exact - exact.detach()), the
    second term zero where exact is finite, else dropped."""
    d = exact - exact.detach()
    return value.detach() + torch.where(torch.isfinite(exact), d,
                                        0.0).to(value.dtype)


def _dielectric_eta(props, default_int):
    int_ior = ior_mod.lookup_dielectric(props.get("int_ior"), default_int)
    ext_ior = ior_mod.lookup_dielectric(props.get("ext_ior"), 1.000277)
    return int_ior / ext_ior


# ===========================================================================
# diffuse (src/bsdfs/diffuse.cpp)
# ===========================================================================

class Diffuse:
    id = DIFFUSE
    flags = F_DIFFUSE_R

    @staticmethod
    def pack(props, build_child) -> np.ndarray:
        data = np.zeros(MAT_W, np.float32)
        data[0:SLOT_W] = pack_color(props.get("reflectance", [0.5, 0.5, 0.5]))
        return data

    @staticmethod
    def sample(data, si, u1, u2, config):
        cos_i = Frame.cos_theta(si.wi)
        wo = warp.square_to_cosine_hemisphere(*u2)
        pdf = warp.square_to_cosine_hemisphere_pdf(wo)
        active = cos_i > 0
        value = _spec(data, 0, si, config)
        bs = BSDFSample(wo=wo, pdf=torch.where(active, pdf, 0.0),
                        eta=torch.ones_like(pdf),
                        sampled_flags=_flags(active, F_DIFFUSE_R))
        return bs, value.masked(active)

    @staticmethod
    def eval(data, si, wo, config):
        cos_i = Frame.cos_theta(si.wi)
        cos_o = Frame.cos_theta(wo)
        active = (cos_i > 0) & (cos_o > 0)
        value = _spec(data, 0, si, config)
        return (value * (warp.INV_PI * cos_o)).masked(active)

    @staticmethod
    def pdf(data, si, wo, config):
        cos_i = Frame.cos_theta(si.wi)
        cos_o = Frame.cos_theta(wo)
        return torch.where((cos_i > 0) & (cos_o > 0), cos_o * warp.INV_PI, 0.0)


def _no_eval(data, si, wo, config):
    """eval of a family whose lobes are all delta: zero."""
    return Spec.zeros(si.wi.z.shape[0], config.n_channels, si.wi.z.device)


def _no_pdf(data, si, wo, config):
    return torch.zeros_like(si.wi.z)


# ===========================================================================
# conductor (src/bsdfs/conductor.cpp): delta reflection, complex IOR
# ===========================================================================

class Conductor:
    id = CONDUCTOR
    flags = F_DELTA_R

    @staticmethod
    def pack(props, build_child) -> np.ndarray:
        data = np.zeros(MAT_W, np.float32)
        if "eta" in props or "k" in props:
            eta = props.get("eta", 0.0)
            k = props.get("k", 1.0)
        else:
            eta, k = ior_mod.lookup_conductor(props.get("material"))
        data[0:SLOT_W] = pack_color(eta)
        data[SLOT_W:2 * SLOT_W] = pack_color(k)
        data[2 * SLOT_W:3 * SLOT_W] = pack_color(
            props.get("specular_reflectance", [1, 1, 1]))
        return data

    @staticmethod
    def _fresnel(data, cos_i, si, config) -> Spec:
        return fr.fresnel_conductor(cos_i, _spec(data, 0, si, config),
                                    _spec(data, 1, si, config))

    @staticmethod
    def sample(data, si, u1, u2, config):
        cos_i = Frame.cos_theta(si.wi)
        active = cos_i > 0
        wo = fr.reflect(si.wi)
        F = Conductor._fresnel(data, cos_i, si, config)
        value = _spec(data, 2, si, config) * F
        bs = BSDFSample(wo=wo, pdf=torch.where(active, 1.0, 0.0),
                        eta=torch.ones_like(cos_i),
                        sampled_flags=_flags(active, F_DELTA_R))
        return bs, value.masked(active)

    eval = staticmethod(_no_eval)
    pdf = staticmethod(_no_pdf)


# ===========================================================================
# roughconductor (src/bsdfs/roughconductor.cpp)
# ===========================================================================

class RoughConductor:
    id = ROUGHCONDUCTOR
    flags = F_GLOSSY_R

    @staticmethod
    def pack(props, build_child) -> np.ndarray:
        data = Conductor.pack(props, build_child)
        a = _pack_alpha(data, props)
        data[24] = _pack_alpha(data, props, "alpha_u", a)
        data[25] = _pack_alpha(data, props, "alpha_v", a)
        data[26] = _DIST_NAME[props.get("distribution", "ggx")]
        return data

    @staticmethod
    def _params(data, si, dtype=None):
        """(alpha_u, alpha_v, distribution), the alphas in `dtype` (else
        the table's)."""
        au, av = _alpha_tex(data, si, torch.clamp_min(data.col(24), 1e-4),
                            torch.clamp_min(data.col(25), 1e-4))
        dtype = dtype or au.dtype
        return au.to(dtype), av.to(dtype), data.col(26).to(torch.int32)

    @staticmethod
    def sample(data, si, u1, u2, config):
        bs, weight = RoughConductor._sample(data, si, si.wi, u2, config)
        if not torch.is_grad_enabled():
            return bs, weight
        # the values in f32, as the JAX package computes them, and their
        # derivatives from the same arithmetic in f64: at alpha 0.005 the
        # weight's roughness derivative is a difference of terms of size
        # 1/alpha, which f32 leaves wrong by up to 120% on some lanes
        # (the JAX package's f32 by up to 13%)
        bs64, w64 = RoughConductor._sample(
            data, si, Vec3(*(c.double() for c in (si.wi.x, si.wi.y,
                                                  si.wi.z))),
            tuple(c.double() for c in u2), config)
        return (BSDFSample(wo=Vec3(*(_f64_derivative(a, b) for a, b in zip(
                    (bs.wo.x, bs.wo.y, bs.wo.z),
                    (bs64.wo.x, bs64.wo.y, bs64.wo.z)))),
                    pdf=_f64_derivative(bs.pdf, bs64.pdf), eta=bs.eta,
                    sampled_flags=bs.sampled_flags),
                Spec(tuple(_f64_derivative(a, b)
                           for a, b in zip(weight.ch, w64.ch))))

    @staticmethod
    def _sample(data, si, wi, u2, config):
        """sample() at incident wi in wi's dtype (the table's f32 columns
        promote to it)."""
        au, av, dist = params = RoughConductor._params(data, si, wi.x.dtype)
        cos_i = Frame.cos_theta(wi)
        m_dir, pdf_m = mf.sample(dist, wi, au, av, u2)
        wo = fr.reflect_m(wi, m_dir)
        cos_o = Frame.cos_theta(wo)
        dot_wim = vdot(wi, m_dir)
        pdf = pdf_m / torch.clamp_min(4.0 * dot_wim.abs(), 1e-20)
        active = (cos_i > 0) & (cos_o > 0) & (pdf_m > 0)
        # weight = f cos_o / pdf, through eval (on the same roughness
        # tensors: their derivatives' terms cancel in wi's dtype)
        f_cos = RoughConductor._eval(data, si, wi, wo, config, params)
        weight = f_cos / torch.clamp_min(pdf, 1e-20)
        bs = BSDFSample(wo=wo, pdf=torch.where(active, pdf, 0.0),
                        eta=torch.ones_like(si.wi.z),
                        sampled_flags=_flags(active, F_GLOSSY_R))
        return bs, weight.masked(active)

    @staticmethod
    def eval(data, si, wo, config):
        return RoughConductor._eval(data, si, si.wi, wo, config)

    @staticmethod
    def _eval(data, si, wi, wo, config, params=None):
        au, av, dist = params or RoughConductor._params(data, si)
        cos_i = Frame.cos_theta(wi)
        cos_o = Frame.cos_theta(wo)
        h = vnormalize(wi + wo)
        D = mf.eval_d(dist, h, au, av)
        G = mf.g_smith(dist, wi, wo, h, au, av)
        F = Conductor._fresnel(data, vdot(wi, h), si, config)
        spec = _spec(data, 2, si, config)
        f_cos = spec * F * (D * G / torch.clamp_min(4.0 * cos_i, 1e-20))
        return f_cos.masked((cos_i > 0) & (cos_o > 0))

    @staticmethod
    def pdf(data, si, wo, config):
        au, av, dist = RoughConductor._params(data, si)
        cos_i = Frame.cos_theta(si.wi)
        cos_o = Frame.cos_theta(wo)
        h = vnormalize(si.wi + wo)
        pdf_m = mf.pdf(dist, si.wi, h, au, av)
        pdf = pdf_m / torch.clamp_min(4.0 * vdot(si.wi, h).abs(), 1e-20)
        return torch.where((cos_i > 0) & (cos_o > 0), pdf, 0.0)


# ===========================================================================
# dielectric (src/bsdfs/dielectric.cpp): smooth delta reflect / refract
# ===========================================================================

class Dielectric:
    id = DIELECTRIC
    flags = F_DELTA_R | F_DELTA_T

    @staticmethod
    def pack(props, build_child) -> np.ndarray:
        data = np.zeros(MAT_W, np.float32)
        data[0:SLOT_W] = pack_color(props.get("specular_reflectance",
                                              [1, 1, 1]))
        data[SLOT_W:2 * SLOT_W] = pack_color(
            props.get("specular_transmittance", [1, 1, 1]))
        data[24] = _dielectric_eta(props, 1.5046)
        return data

    @staticmethod
    def sample(data, si, u1, u2, config):
        eta = data.col(24)
        cos_i = Frame.cos_theta(si.wi)
        F, cos_t, eta_it, eta_ti = fr.fresnel(cos_i, eta)
        pick_reflect = u1 < F
        wo = vwhere(pick_reflect, fr.reflect(si.wi),
                    fr.refract(si.wi, cos_t, eta_ti))
        spec_r = _spec(data, 0, si, config)
        # radiance transport: eta^-2 compression on refraction
        spec_t = _spec(data, 1, si, config) * (eta_ti * eta_ti)
        value = swhere(pick_reflect, spec_r, spec_t)
        pdf = torch.where(pick_reflect, F, 1.0 - F)
        active = cos_i != 0
        bs = BSDFSample(
            wo=wo, pdf=torch.where(active, pdf, 0.0),
            eta=torch.where(pick_reflect, 1.0, eta_it),
            sampled_flags=_flags2(active, pick_reflect, F_DELTA_R,
                                  F_DELTA_T))
        return bs, value.masked(active)

    eval = staticmethod(_no_eval)
    pdf = staticmethod(_no_pdf)


# ===========================================================================
# thindielectric (src/bsdfs/thindielectric.cpp)
# ===========================================================================

class ThinDielectric:
    id = THINDIELECTRIC
    flags = F_DELTA_R | F_DELTA_T

    pack = staticmethod(Dielectric.pack)

    @staticmethod
    def sample(data, si, u1, u2, config):
        eta = data.col(24)
        cos_i = Frame.cos_theta(si.wi)
        F = fr.fresnel(cos_i.abs(), eta)[0]
        # the internal bounces: R' = 2R / (1 + R)
        R = torch.where(F < 1.0,
                        F + (1.0 - F) * (1.0 - F) * F / (1.0 - F * F), 1.0)
        pick_reflect = u1 < R
        wo = vwhere(pick_reflect, fr.reflect(si.wi), -si.wi)
        value = swhere(pick_reflect, _spec(data, 0, si, config),
                       _spec(data, 1, si, config))
        pdf = torch.where(pick_reflect, R, 1.0 - R)
        active = cos_i != 0
        bs = BSDFSample(
            wo=wo, pdf=torch.where(active, pdf, 0.0),
            eta=torch.ones_like(pdf),
            sampled_flags=_flags2(active, pick_reflect, F_DELTA_R,
                                  F_DELTA_T))
        return bs, value.masked(active)

    eval = staticmethod(_no_eval)
    pdf = staticmethod(_no_pdf)


# ===========================================================================
# roughdielectric (src/bsdfs/roughdielectric.cpp; Walter et al. 2007)
# ===========================================================================

class RoughDielectric:
    id = ROUGHDIELECTRIC
    flags = F_GLOSSY_R | F_GLOSSY_T

    @staticmethod
    def pack(props, build_child) -> np.ndarray:
        data = Dielectric.pack(props, build_child)
        a = _pack_alpha(data, props)
        data[25] = _pack_alpha(data, props, "alpha_u", a)
        data[26] = _pack_alpha(data, props, "alpha_v", a)
        data[27] = _DIST_NAME[props.get("distribution", "ggx")]
        return data

    @staticmethod
    def _params(data, si):
        return (data.col(24),
                *_alpha_tex(data, si, torch.clamp_min(data.col(25), 1e-4),
                            torch.clamp_min(data.col(26), 1e-4)),
                data.col(27).to(torch.int32))

    @staticmethod
    def sample(data, si, u1, u2, config):
        eta, au, av, dist = RoughDielectric._params(data, si)
        cos_i = Frame.cos_theta(si.wi)
        # m stays in the upper hemisphere; the SIGNED dot(wi, m) tells
        # fresnel which side the ray comes from
        m_dir, pdf_m = mf.sample(dist, si.wi, au, av, u2)
        dot_wim = vdot(si.wi, m_dir)
        F, cos_t, eta_it, eta_ti = fr.fresnel(dot_wim, eta)
        pick_reflect = u1 < F
        wo = vwhere(pick_reflect, fr.reflect_m(si.wi, m_dir),
                    fr.refract_m(si.wi, m_dir, cos_t, eta_ti))
        cos_o = Frame.cos_theta(wo)
        # a reflection stays in wi's hemisphere, a refraction crosses
        valid_r = pick_reflect & (cos_i * cos_o > 0)
        valid_t = ~pick_reflect & (cos_i * cos_o < 0)
        active = (valid_r | valid_t) & (pdf_m > 0)

        pdf = RoughDielectric.pdf(data, si, wo, config)
        f_cos = RoughDielectric.eval(data, si, wo, config)
        weight = f_cos / torch.clamp_min(pdf, 1e-20)
        bs = BSDFSample(
            wo=wo, pdf=torch.where(active, pdf, 0.0),
            eta=torch.where(pick_reflect, 1.0, eta_it),
            sampled_flags=_flags2(active, pick_reflect, F_GLOSSY_R,
                                  F_GLOSSY_T))
        return bs, weight.masked(active)

    @staticmethod
    def _half_vectors(wi, wo, eta):
        """The reflection and transmission half vectors, both turned to
        the +z side (the NDF's); fresnel gets the SIGNED dot with wi."""
        cos_i = Frame.cos_theta(wi)
        hr = wi + wo
        hr = vnormalize(vwhere(Frame.cos_theta(hr) < 0, -hr, hr))
        # transmission half vector: -(wi + eta_it wo)
        eta_it = torch.where(cos_i >= 0, eta, 1.0 / eta)
        ht = -(wi + wo * eta_it)
        ht = vnormalize(vwhere(Frame.cos_theta(ht) < 0, -ht, ht))
        return hr, ht, eta_it

    @staticmethod
    def eval(data, si, wo, config):
        eta, au, av, dist = RoughDielectric._params(data, si)
        cos_i = Frame.cos_theta(si.wi)
        cos_o = Frame.cos_theta(wo)
        is_reflect = cos_i * cos_o > 0
        hr, ht, eta_it = RoughDielectric._half_vectors(si.wi, wo, eta)

        # reflection lobe
        D_r = mf.eval_d(dist, hr, au, av)
        G_r = mf.g_smith(dist, si.wi, wo, hr, au, av)
        F_r = fr.fresnel(vdot(si.wi, hr), eta)[0]
        f_r = F_r * D_r * G_r / torch.clamp_min(4.0 * cos_i.abs(), 1e-20)

        # transmission lobe (Walter 2007 eq. 21, radiance transport: the
        # eta^2 of the Jacobian and the 1/eta_it^2 compression cancel)
        wi_ht = vdot(si.wi, ht)
        wo_ht = vdot(wo, ht)
        F_t = fr.fresnel(wi_ht, eta)[0]
        D_t = mf.eval_d(dist, ht, au, av)
        G_t = mf.g_smith(dist, si.wi, wo, ht, au, av)
        denom = wi_ht + eta_it * wo_ht
        f_t = (1.0 - F_t) * D_t * G_t * (
            (wi_ht * wo_ht).abs()
            / torch.clamp_min(cos_i.abs() * denom * denom, 1e-20))
        # Walter 2007 sidedness (chi+): a refraction crosses the
        # microfacet, wi and wo on opposite sides of ht
        f_t = torch.where(wi_ht * wo_ht < 0, f_t, 0.0)

        f_cos = swhere(is_reflect, _spec(data, 0, si, config) * f_r,
                       _spec(data, 1, si, config) * f_t)
        return f_cos.masked((cos_i != 0) & (cos_o != 0))

    @staticmethod
    def pdf(data, si, wo, config):
        eta, au, av, dist = RoughDielectric._params(data, si)
        cos_i = Frame.cos_theta(si.wi)
        cos_o = Frame.cos_theta(wo)
        is_reflect = cos_i * cos_o > 0
        hr, ht, eta_it = RoughDielectric._half_vectors(si.wi, wo, eta)

        F_r = fr.fresnel(vdot(si.wi, hr), eta)[0]
        pdf_m_r = mf.pdf(dist, si.wi, hr, au, av)
        jac_r = 1.0 / torch.clamp_min(4.0 * vdot(si.wi, hr).abs(), 1e-20)
        pdf_r = F_r * pdf_m_r * jac_r

        wi_ht = vdot(si.wi, ht)
        wo_ht = vdot(wo, ht)
        F_t = fr.fresnel(wi_ht, eta)[0]
        pdf_m_t = mf.pdf(dist, si.wi, ht, au, av)
        denom = wi_ht + eta_it * wo_ht
        jac_t = ((eta_it * eta_it * wo_ht.abs())
                 / torch.clamp_min(denom * denom, 1e-20))
        pdf_t = (1.0 - F_t) * pdf_m_t * jac_t
        pdf_t = torch.where(wi_ht * wo_ht < 0, pdf_t, 0.0)  # chi+

        pdf = torch.where(is_reflect, pdf_r, pdf_t)
        return torch.where((cos_i != 0) & (cos_o != 0), pdf, 0.0)


# ===========================================================================
# plastic (src/bsdfs/plastic.cpp): smooth specular coat over diffuse
# ===========================================================================

def _substrate(data, si, cos_i, cos_o, F_i, F_o, config) -> Spec:
    """The plastics' diffuse substrate under the coat, with the internal
    scattering's compensation (nonlinear: divided by 1 - albedo * fdr)."""
    diff = _spec(data, 0, si, config)
    fdr = data.col(26)
    nonlinear = data.col(25)
    denom = 1.0 - swhere(nonlinear > 0, diff, 1.0) * fdr
    denom = Spec(tuple(torch.clamp_min(c, 1e-8) for c in denom.ch))
    return (diff / denom *
            (warp.INV_PI * cos_o * data.col(28) * (1.0 - F_i) * (1.0 - F_o)))


class Plastic:
    id = PLASTIC
    flags = F_DIFFUSE_R | F_DELTA_R

    @staticmethod
    def pack(props, build_child) -> np.ndarray:
        data = np.zeros(MAT_W, np.float32)
        data[0:SLOT_W] = pack_color(props.get("diffuse_reflectance",
                                              [0.5, 0.5, 0.5]))
        data[SLOT_W:2 * SLOT_W] = pack_color(props.get("specular_reflectance",
                                                       [1, 1, 1]))
        eta = _dielectric_eta(props, 1.49)
        data[24] = eta
        data[25] = 1.0 if props.get("nonlinear", False) else 0.0
        # fresnel_diffuse_reflectance(1 / eta), on the host
        e = 1.0 / eta
        if e >= 1.0:
            fdr = -1.4399 / (e * e) + 0.7099 / e + 0.6681 + 0.0636 * e
        else:
            e2, e3 = e * e, e * e * e
            fdr = (0.919317 - 3.4793 * e + 6.75335 * e2 - 7.80989 * e3 +
                   4.98554 * e3 * e - 1.36881 * e3 * e2)
        data[26] = fdr
        d_mean = float(np.mean(data[0:3]))
        s_mean = float(np.mean(data[SLOT_W:SLOT_W + 3]))
        data[27] = s_mean / max(d_mean + s_mean, 1e-8)  # specular weight
        data[28] = 1.0 / (eta * eta)
        return data

    @staticmethod
    def _probs(data, cos_i):
        ssw = data.col(27)
        F_i = fr.fresnel(cos_i, data.col(24))[0]
        prob_spec = (F_i * ssw) / torch.clamp_min(
            F_i * ssw + (1.0 - F_i) * (1.0 - ssw), 1e-20)
        return F_i, prob_spec

    @staticmethod
    def sample(data, si, u1, u2, config):
        cos_i = Frame.cos_theta(si.wi)
        active = cos_i > 0
        F_i, prob_spec = Plastic._probs(data, cos_i)
        pick_spec = u1 < prob_spec

        wo_d = warp.square_to_cosine_hemisphere(*u2)
        wo = vwhere(pick_spec, fr.reflect(si.wi), wo_d)
        w_spec = _spec(data, 1, si, config) * (
            F_i / torch.clamp_min(prob_spec, 1e-20))
        pdf_d = (1.0 - prob_spec) * warp.square_to_cosine_hemisphere_pdf(wo_d)
        w_diff = (Plastic.eval(data, si, wo_d, config)
                  / torch.clamp_min(pdf_d, 1e-20))

        value = swhere(pick_spec, w_spec, w_diff)
        pdf = torch.where(pick_spec, prob_spec, pdf_d)
        bs = BSDFSample(
            wo=wo, pdf=torch.where(active, pdf, 0.0),
            eta=torch.ones_like(pdf),
            sampled_flags=_flags2(active, pick_spec, F_DELTA_R, F_DIFFUSE_R))
        return bs, value.masked(active)

    @staticmethod
    def eval(data, si, wo, config):
        eta = data.col(24)
        cos_i = Frame.cos_theta(si.wi)
        cos_o = Frame.cos_theta(wo)
        F_i = fr.fresnel(cos_i, eta)[0]
        F_o = fr.fresnel(cos_o, eta)[0]
        value = _substrate(data, si, cos_i, cos_o, F_i, F_o, config)
        return value.masked((cos_i > 0) & (cos_o > 0))

    @staticmethod
    def pdf(data, si, wo, config):
        cos_i = Frame.cos_theta(si.wi)
        cos_o = Frame.cos_theta(wo)
        prob_spec = Plastic._probs(data, cos_i)[1]
        pdf = (1.0 - prob_spec) * warp.square_to_cosine_hemisphere_pdf(wo)
        return torch.where((cos_i > 0) & (cos_o > 0), pdf, 0.0)


# ===========================================================================
# roughplastic (src/bsdfs/roughplastic.cpp): microfacet coat over diffuse
# ===========================================================================

class RoughPlastic:
    id = ROUGHPLASTIC
    flags = F_DIFFUSE_R | F_GLOSSY_R

    @staticmethod
    def pack(props, build_child) -> np.ndarray:
        data = Plastic.pack(props, build_child)
        data[29] = _pack_alpha(data, props)
        data[30] = _DIST_NAME[props.get("distribution", "ggx")]
        return data

    @staticmethod
    def _params(data, si):
        au = _alpha_tex(data, si, torch.clamp_min(data.col(29), 1e-4), 0.0)[0]
        return au, data.col(30).to(torch.int32)

    @staticmethod
    def sample(data, si, u1, u2, config):
        cos_i = Frame.cos_theta(si.wi)
        prob_spec = Plastic._probs(data, cos_i)[1]
        pick_spec = u1 < prob_spec
        au, dist = RoughPlastic._params(data, si)

        m_dir = mf.sample(dist, si.wi, au, au, u2)[0]
        wo = vwhere(pick_spec, fr.reflect_m(si.wi, m_dir),
                    warp.square_to_cosine_hemisphere(*u2))

        pdf = RoughPlastic.pdf(data, si, wo, config)
        f_cos = RoughPlastic.eval(data, si, wo, config)
        value = f_cos / torch.clamp_min(pdf, 1e-20)
        active = (cos_i > 0) & (pdf > 0) & (Frame.cos_theta(wo) > 0)
        bs = BSDFSample(
            wo=wo, pdf=torch.where(active, pdf, 0.0),
            eta=torch.ones_like(pdf),
            sampled_flags=_flags2(active, pick_spec, F_GLOSSY_R,
                                  F_DIFFUSE_R))
        return bs, value.masked(active)

    @staticmethod
    def eval(data, si, wo, config):
        eta = data.col(24)
        au, dist = RoughPlastic._params(data, si)
        cos_i = Frame.cos_theta(si.wi)
        cos_o = Frame.cos_theta(wo)
        h = vnormalize(si.wi + wo)
        D = mf.eval_d(dist, h, au, au)
        G = mf.g_smith(dist, si.wi, wo, h, au, au)
        F_h = fr.fresnel(vdot(si.wi, h), eta)[0]
        f_spec = _spec(data, 1, si, config) * (
            F_h * D * G / torch.clamp_min(4.0 * cos_i, 1e-20))
        F_i = fr.fresnel(cos_i, eta)[0]
        F_o = fr.fresnel(cos_o, eta)[0]
        f_diff = _substrate(data, si, cos_i, cos_o, F_i, F_o, config)
        return (f_spec + f_diff).masked((cos_i > 0) & (cos_o > 0))

    @staticmethod
    def pdf(data, si, wo, config):
        cos_i = Frame.cos_theta(si.wi)
        cos_o = Frame.cos_theta(wo)
        prob_spec = Plastic._probs(data, cos_i)[1]
        au, dist = RoughPlastic._params(data, si)
        h = vnormalize(si.wi + wo)
        pdf_m = mf.pdf(dist, si.wi, h, au, au)
        pdf_spec = pdf_m / torch.clamp_min(4.0 * vdot(si.wi, h).abs(), 1e-20)
        pdf_diff = warp.square_to_cosine_hemisphere_pdf(wo)
        pdf = prob_spec * pdf_spec + (1.0 - prob_spec) * pdf_diff
        return torch.where((cos_i > 0) & (cos_o > 0), pdf, 0.0)


# ===========================================================================
# null (src/bsdfs/null.cpp): pass-through
# ===========================================================================

class Null:
    id = NULL_BSDF
    flags = F_NULL

    @staticmethod
    def pack(props, build_child) -> np.ndarray:
        return np.zeros(MAT_W, np.float32)

    @staticmethod
    def sample(data, si, u1, u2, config):
        one = torch.ones_like(si.wi.z)
        bs = BSDFSample(wo=-si.wi, pdf=one, eta=one,
                        sampled_flags=torch.full_like(
                            si.wi.z, F_NULL, dtype=torch.int32))
        return bs, Spec.ones(one.shape[0], config.n_channels, one.device)

    eval = staticmethod(_no_eval)
    pdf = staticmethod(_no_pdf)


# ===========================================================================
# The wrappers: a wrapper's row holds its children's row indices (col 30,
# blend's second child col 31), and it dispatches each lane's child through
# the leaf dispatch (_sample_leaf, _eval_leaf, _pdf_leaf) with the lane's
# child row, each leaf family on rows of its own family (_leaf_lanes)
# ===========================================================================

def _child(scene, data, wrapper, col=30):
    """The lanes' child rows (col `col` of their rows of family
    `wrapper`), their families, and the leaf families a child in that
    column of the scene's rows of `wrapper` has (scene.wrapper_children):
    the only ones the child dispatch runs. The JAX package runs every
    leaf family of the scene there, and its selects discard the others."""
    idx = data.col(col).to(torch.int64)
    return (idx, scene.mat_type[idx],
            dict(scene.wrapper_children).get((wrapper, col), ()))


class Mask:
    """mask.cpp: the child with probability q = mean(opacity), else the
    null lobe (wo = -wi, pdf 1 - q, F_NULL)."""
    id = MASK
    flags = F_NULL   # | the child's lobes at build

    @staticmethod
    def pack(props, build_child) -> np.ndarray:
        data = np.zeros(MAT_W, np.float32)
        data[2 * SLOT_W:3 * SLOT_W] = pack_color(props.get("opacity",
                                                           [0.5, 0.5, 0.5]))
        data[30] = build_child(props.get("bsdf", {"type": "diffuse"}))
        return data

    @staticmethod
    def _q(opacity):
        return sp_clip(opacity.hmean(), 1e-6, 1.0 - 1e-6)

    @staticmethod
    def sample(scene, data, si, u1, u2, config):
        opacity = _spec(data, 2, si, config)
        q = Mask._q(opacity)
        pick = u1 < q
        u1r = torch.where(pick, u1 / q, (u1 - q) / (1.0 - q))
        idx, ct, fams = _child(scene, data, Mask.id)
        bs_c, w_c = _sample_leaf(scene, ct, idx, si, u1r, u2, config, fams)
        w_c = w_c * opacity / q
        bs = BSDFSample(
            wo=vwhere(pick, bs_c.wo, -si.wi),
            pdf=torch.where(pick, bs_c.pdf * q, 1.0 - q),
            eta=torch.where(pick, bs_c.eta, 1.0),
            sampled_flags=torch.where(pick, bs_c.sampled_flags,
                                      F_NULL).to(torch.int32))
        return bs, swhere(pick, w_c, (1.0 - opacity) / (1.0 - q))

    @staticmethod
    def eval(scene, data, si, wo, config):
        idx, ct, fams = _child(scene, data, Mask.id)
        return _spec(data, 2, si, config) * _eval_leaf(scene, ct, idx, si,
                                                       wo, config, fams)

    @staticmethod
    def pdf(scene, data, si, wo, config):
        q = Mask._q(_spec(data, 2, si, config))
        idx, ct, fams = _child(scene, data, Mask.id)
        return q * _pdf_leaf(scene, ct, idx, si, wo, config, fams)


class Blend:
    """blendbsdf.cpp: child b with probability `weight`, else child a;
    eval and pdf the weighted sums."""
    id = BLEND
    flags = 0   # | the children's lobes at build

    @staticmethod
    def pack(props, build_child) -> np.ndarray:
        data = np.zeros(MAT_W, np.float32)
        data[29] = float(props.get("weight", 0.5))
        children = props.get("bsdfs")
        if children is None:
            children = [props.get("bsdf_0", {"type": "diffuse"}),
                        props.get("bsdf_1", {"type": "diffuse"})]
        data[30] = build_child(children[0])
        data[31] = build_child(children[1])
        return data

    @staticmethod
    def sample(scene, data, si, u1, u2, config):
        w = data.col(29)
        pick_b = u1 < w
        u1r = torch.where(pick_b, u1 / sp_max(w, 1e-8),
                          (u1 - w) / sp_max(1.0 - w, 1e-8))
        ia, ta, fa = _child(scene, data, Blend.id, 30)
        ib, tb, fb = _child(scene, data, Blend.id, 31)
        bs_a, w_a = _sample_leaf(scene, ta, ia, si, u1r, u2, config, fa)
        bs_b, w_b = _sample_leaf(scene, tb, ib, si, u1r, u2, config, fb)
        bs = BSDFSample(
            wo=vwhere(pick_b, bs_b.wo, bs_a.wo),
            pdf=torch.where(pick_b, w * bs_b.pdf, (1 - w) * bs_a.pdf),
            eta=torch.where(pick_b, bs_b.eta, bs_a.eta),
            sampled_flags=torch.where(pick_b, bs_b.sampled_flags,
                                      bs_a.sampled_flags))
        return bs, swhere(pick_b, w_b, w_a)

    @staticmethod
    def eval(scene, data, si, wo, config):
        w = data.col(29)
        ia, ta, fa = _child(scene, data, Blend.id, 30)
        ib, tb, fb = _child(scene, data, Blend.id, 31)
        return (_eval_leaf(scene, ta, ia, si, wo, config, fa) * (1.0 - w)
                + _eval_leaf(scene, tb, ib, si, wo, config, fb) * w)

    @staticmethod
    def pdf(scene, data, si, wo, config):
        w = data.col(29)
        ia, ta, fa = _child(scene, data, Blend.id, 30)
        ib, tb, fb = _child(scene, data, Blend.id, 31)
        return ((1.0 - w) * _pdf_leaf(scene, ta, ia, si, wo, config, fa)
                + w * _pdf_leaf(scene, tb, ib, si, wo, config, fb))


def _normalmap_frame(data, si) -> Frame:
    """normalmap.cpp: the tangent-space normal of slot 2's RGB (2 rgb -
    1, a texture read at level 0) -> a frame inside the local one."""
    rgb = eval_spectrum_slot(data.slot(2), si.wavelengths, "rgb",
                             tex=_tex(data, 2, si), uv=si.uv)
    return Frame.from_n(vnormalize(Vec3(2.0 * rgb.ch[0] - 1.0,
                                        2.0 * rgb.ch[1] - 1.0,
                                        2.0 * rgb.ch[2] - 1.0)))


BUMP_EPS = 5e-4


def _bumpmap_frame(data, si) -> Frame:
    """bumpmap.cpp: the height of slot 2 (its channel mean, a texture
    read at level 0) differenced centrally at uv +- BUMP_EPS, scaled by
    col 29 -> the perturbed normal's frame inside the local one."""
    def h(uv):
        return eval_spectrum_slot(data.slot(2), si.wavelengths, "rgb",
                                  tex=_tex(data, 2, si), uv=uv).hmean()

    scale = data.col(29)
    uv = si.uv
    dh_du = (h(Vec2(uv.x + BUMP_EPS, uv.y))
             - h(Vec2(uv.x - BUMP_EPS, uv.y))) / (2 * BUMP_EPS)
    dh_dv = (h(Vec2(uv.x, uv.y + BUMP_EPS))
             - h(Vec2(uv.x, uv.y - BUMP_EPS))) / (2 * BUMP_EPS)
    return Frame.from_n(vnormalize(Vec3(-scale * dh_du, -scale * dh_dv,
                                        torch.ones_like(dh_du))))


class _FramePerturb:
    """normalmap and bumpmap: the child in a perturbed frame inside the
    local one (the reference's frame-within-frame)."""

    @classmethod
    def sample(cls, scene, data, si, u1, u2, config):
        fp = cls._frame(data, si)
        si_p = dataclasses.replace(si, wi=fp.to_local(si.wi))
        idx, ct, fams = _child(scene, data, cls.id)
        bs, w = _sample_leaf(scene, ct, idx, si_p, u1, u2, config, fams)
        wo = fp.to_world(bs.wo)
        # a sample the perturbation pushed below the true surface is void
        ok = Frame.cos_theta(wo) * Frame.cos_theta(bs.wo) > 0
        bs = dataclasses.replace(bs, wo=wo, pdf=torch.where(ok, bs.pdf, 0.0))
        return bs, w.masked(ok)

    @classmethod
    def eval(cls, scene, data, si, wo, config):
        fp = cls._frame(data, si)
        si_p = dataclasses.replace(si, wi=fp.to_local(si.wi))
        idx, ct, fams = _child(scene, data, cls.id)
        return _eval_leaf(scene, ct, idx, si_p, fp.to_local(wo), config,
                          fams)

    @classmethod
    def pdf(cls, scene, data, si, wo, config):
        fp = cls._frame(data, si)
        si_p = dataclasses.replace(si, wi=fp.to_local(si.wi))
        idx, ct, fams = _child(scene, data, cls.id)
        return _pdf_leaf(scene, ct, idx, si_p, fp.to_local(wo), config,
                         fams)


class NormalMap(_FramePerturb):
    id = NORMALMAP
    flags = 0   # | the child's lobes at build
    _frame = staticmethod(_normalmap_frame)

    @staticmethod
    def pack(props, build_child) -> np.ndarray:
        data = np.zeros(MAT_W, np.float32)
        data[2 * SLOT_W:3 * SLOT_W] = pack_color(
            props.get("normalmap", [0.5, 0.5, 1.0]))
        data[30] = build_child(props.get("bsdf", {"type": "diffuse"}))
        return data


class BumpMap(_FramePerturb):
    id = BUMPMAP
    flags = 0
    _frame = staticmethod(_bumpmap_frame)

    @staticmethod
    def pack(props, build_child) -> np.ndarray:
        data = np.zeros(MAT_W, np.float32)
        data[2 * SLOT_W:3 * SLOT_W] = pack_color(props.get("bumpmap", 0.0))
        data[29] = float(props.get("scale", 1.0))
        data[30] = build_child(props.get("bsdf", {"type": "diffuse"}))
        return data


# ===========================================================================
# measured (src/bsdfs/measured.cpp): a tabulated BRDF sampled by per-
# incident-angle 2D CDF inversion (render/measured.py); it reads
# scene.measured, so it dispatches with the wrappers. Row: [28] table id
# ===========================================================================

def _measured_table(props, grid):
    """A measured row's table: from `values`, an RGL `.bsdf` file
    (`filename`) or a bake of an analytic family (`bake`)."""
    if "values" in props:
        return np.asarray(props["values"], np.float32)
    if "filename" in props:
        return rgl.load_rgl(props["filename"], *grid)
    if "bake" in props:
        return measured_mod.bake_from_desc(props["bake"], *grid)
    raise ValueError(f"{props.get('type', 'measured')} bsdf needs "
                     "'filename' (.bsdf), 'values' or 'bake'")


def _grid(props):
    return (int(props.get("n_ti", 32)), int(props.get("n_to", 64)),
            int(props.get("n_phi", 64)))


class Measured:
    id = MEASURED
    flags = F_GLOSSY_R
    stages_table = True   # build_material passes the build's staging list

    @staticmethod
    def pack(props, build_child, staging) -> np.ndarray:
        data = np.zeros(MAT_W, np.float32)
        data[28] = measured_mod.stage_table(
            staging, _measured_table(props, _grid(props)))
        return data

    @staticmethod
    def _rgb_to_channels(val: Spec, config) -> Spec:
        """The table's RGB in the config's channels: their mean, splat,
        outside rgb mode."""
        C = config.n_channels
        return val if C == 3 else Spec((val.hmean(),) * C)

    @staticmethod
    def sample(scene, data, si, u1, u2, config):
        tid = data.col(28)
        wo, pdf = measured_mod.sample_measured(scene.measured, tid, si.wi, u2)
        val = measured_mod.eval_measured(scene.measured, tid, si.wi, wo)
        weight = Measured._rgb_to_channels(val / sp_max(pdf, 1e-20), config)
        bs = BSDFSample(wo=wo, pdf=pdf, eta=torch.ones_like(pdf),
                        sampled_flags=_flags(pdf > 0, F_GLOSSY_R))
        return bs, weight.masked(pdf > 0)

    @staticmethod
    def eval(scene, data, si, wo, config):
        return Measured._rgb_to_channels(measured_mod.eval_measured(
            scene.measured, data.col(28), si.wi, wo), config)

    @staticmethod
    def pdf(scene, data, si, wo, config):
        return measured_mod.pdf_measured(scene.measured, data.col(28), si.wi,
                                         wo)


class MeasuredPolarized(Measured):
    """measured_polarized (src/bsdfs/measured_polarized.cpp): a measured
    intensity table and, per cell, an intensity-normalized Mueller matrix
    (`mueller` (n_ti, n_to, n_phi, 4, 4), or `pbake_eta`, a conductor's
    complex IOR baked by measured.bake_mueller_conductor) that the
    polarized integrator reads; eval, sample and pdf are measured's."""
    id = MEASURED_POLARIZED

    @staticmethod
    def pack(props, build_child, staging) -> np.ndarray:
        data = np.zeros(MAT_W, np.float32)
        table = _measured_table(props, _grid(props))
        if "mueller" in props:
            mm = np.asarray(props["mueller"], np.float32)
        elif "pbake_eta" in props:
            eta = props["pbake_eta"]
            mm = measured_mod.bake_mueller_conductor(
                float(np.real(eta)), float(np.imag(eta)), *table.shape[:3])
        else:
            raise ValueError("measured_polarized needs 'mueller' "
                             "(n_ti,n_to,n_phi,4,4) or 'pbake_eta'")
        data[28] = measured_mod.stage_table(staging, table, mueller=mm)
        return data


# ===========================================================================
# polarizer and retarder (src/bsdfs/{polarizer,retarder}.cpp): ideal optical
# elements, delta straight-through transmission. Unpolarized scalar
# transport passes t / 2 through a polarizer, everything through a
# retarder; their Mueller matrices act in render/stokes.py.
# Row: [24] the element's angle theta (rad), [25] transmittance | phase
# ===========================================================================

def _straight_through(si, config, value):
    one = torch.ones_like(si.wi.z)
    bs = BSDFSample(wo=-si.wi, pdf=one, eta=one,
                    sampled_flags=torch.full_like(si.wi.z, F_DELTA_T,
                                                  dtype=torch.int32))
    return bs, Spec((value,) * config.n_channels)


class Polarizer:
    id = POLARIZER
    flags = F_DELTA_T

    @staticmethod
    def pack(props, build_child) -> np.ndarray:
        data = np.zeros(MAT_W, np.float32)
        data[24] = np.deg2rad(float(props.get("theta", 0.0)))
        data[25] = float(props.get("transmittance", 1.0))
        return data

    @staticmethod
    def sample(data, si, u1, u2, config):
        return _straight_through(si, config, 0.5 * data.col(25))

    eval = staticmethod(_no_eval)
    pdf = staticmethod(_no_pdf)


class Retarder:
    id = RETARDER
    flags = F_DELTA_T

    @staticmethod
    def pack(props, build_child) -> np.ndarray:
        data = np.zeros(MAT_W, np.float32)
        data[24] = np.deg2rad(float(props.get("theta", 0.0)))
        data[25] = np.deg2rad(float(props.get("delta", 90.0)))  # retardance
        return data

    @staticmethod
    def sample(data, si, u1, u2, config):
        return _straight_through(si, config, torch.ones_like(si.wi.z))

    eval = staticmethod(_no_eval)
    pdf = staticmethod(_no_pdf)


# Differentiable parameters of each family (name -> location in its row),
# read by scene.build_fields into SceneData.param_paths: ("slot", k) is the
# RGB at cols [8k, 8k + 3) of spectrum slot k, ("scalar", c) one column
Diffuse.param_spec = {"reflectance": ("slot", 0)}
Conductor.param_spec = {"eta": ("slot", 0), "k": ("slot", 1),
                        "specular_reflectance": ("slot", 2)}
RoughConductor.param_spec = {**Conductor.param_spec,
                             "alpha_u": ("scalar", 24),
                             "alpha_v": ("scalar", 25)}
Dielectric.param_spec = {"specular_reflectance": ("slot", 0),
                         "specular_transmittance": ("slot", 1),
                         "eta": ("scalar", 24)}
ThinDielectric.param_spec = dict(Dielectric.param_spec)
RoughDielectric.param_spec = {**Dielectric.param_spec,
                              "alpha_u": ("scalar", 25),
                              "alpha_v": ("scalar", 26)}
Plastic.param_spec = {"diffuse_reflectance": ("slot", 0),
                      "specular_reflectance": ("slot", 1)}
RoughPlastic.param_spec = {**Plastic.param_spec, "alpha": ("scalar", 29)}
Null.param_spec = {}
Mask.param_spec = {"opacity": ("slot", 2)}
Blend.param_spec = {"weight": ("scalar", 29)}
NormalMap.param_spec = {"normalmap": ("slot", 2)}
BumpMap.param_spec = {"bumpmap": ("slot", 2), "scale": ("scalar", 29)}
Measured.param_spec = {}
MeasuredPolarized.param_spec = {}
Polarizer.param_spec = {"theta": ("scalar", 24),
                        "transmittance": ("scalar", 25)}
Retarder.param_spec = {"theta": ("scalar", 24), "delta": ("scalar", 25)}
# the columns of a wrapper's rows that hold child rows
Mask.child_cols = NormalMap.child_cols = BumpMap.child_cols = (30,)
Blend.child_cols = (30, 31)
Measured.child_cols = ()

LEAF_FAMILIES = {c.id: c for c in (Diffuse, Conductor, RoughConductor,
                                   Dielectric, ThinDielectric,
                                   RoughDielectric, Plastic, RoughPlastic,
                                   Null, Polarizer, Retarder)}
WRAPPER_FAMILIES = {c.id: c for c in (Mask, Blend, NormalMap, BumpMap,
                                      Measured, MeasuredPolarized)}
FAMILIES = {**LEAF_FAMILIES, **WRAPPER_FAMILIES}
_BY_NAME = {"diffuse": Diffuse, "conductor": Conductor,
            "roughconductor": RoughConductor, "dielectric": Dielectric,
            "thindielectric": ThinDielectric,
            "roughdielectric": RoughDielectric, "plastic": Plastic,
            "roughplastic": RoughPlastic, "null": Null, "mask": Mask,
            "blendbsdf": Blend, "blend": Blend, "normalmap": NormalMap,
            "bumpmap": BumpMap, "measured": Measured,
            "measured_polarized": MeasuredPolarized,
            "polarizer": Polarizer, "retarder": Retarder}


def register_bsdf(name: str, cls) -> None:
    """Register a user-defined BSDF plugin under `name` (the reference's
    Python plugins, pybind trampolines of BSDF; the JAX package's
    register_bsdf). A plugin is a class of four static methods over the
    port's own types:

        class MyBSDF:
            id = None            # given on registration, from 1000 up
            flags = F_DIFFUSE_R  # its lobes (BSDFFlags)
            @staticmethod
            def pack(props, build_child) -> np.ndarray   # (MAT_W,) f32
            @staticmethod
            def sample(data, si, u1, u2, config) -> (BSDFSample, Spec)
            @staticmethod
            def eval(data, si, wo, config) -> Spec
            @staticmethod
            def pdf(data, si, wo, config) -> torch.Tensor

    `data` is its lanes' rows (spectra.LaneRows: `_spec(data, k, si,
    config)` reads spectrum slot k, `data.col(c)` a column), `si` the
    shading record with wi in the local frame, u1 (N,) and u2 a Vec2 of
    samples; core/warp.py has the warps. After registration the name
    works wherever a built-in's does: XML `<bsdf type="name">`,
    load_dict, build_scene; the dispatch runs the plugin on the rows of
    its own family alone, as a built-in leaf family (no wrappers: a
    wrapper's child re-dispatch is the transport loop's). A registration
    lives in its process's registry alone: a process spawned or
    launched apart (a torch.distributed rank, a CLI subprocess) does not
    see it unless it registers the plugin itself."""
    global _USER_ID_NEXT
    if name in _BY_NAME:
        raise ValueError(f"bsdf name {name!r} already registered")
    for attr in ("flags", "pack", "sample", "eval", "pdf"):
        if not hasattr(cls, attr):
            raise TypeError(f"plugin {name!r} lacks required attribute "
                            f"{attr!r}")
    if getattr(cls, "id", None) is None:
        cls.id = _USER_ID_NEXT
        _USER_ID_NEXT += 1
    if cls.id in FAMILIES or any(c.id == cls.id for c in _BY_NAME.values()):
        raise ValueError(f"bsdf id {cls.id} already taken")
    if not hasattr(cls, "param_spec"):
        cls.param_spec = {}
    _BY_NAME[name] = cls
    LEAF_FAMILIES[cls.id] = cls
    FAMILIES[cls.id] = cls


_USER_ID_NEXT = 1000  # user plugins' ids; the built-ins' stay below


def build_material(desc: dict, mats: List, staging: list = None) -> int:
    """Host: append the rows of `desc` to `mats` ([type, flags, row]
    entries); returns its row index. `twosided` (nested too) is a flag on
    its child's row; a wrapper's children get rows of their own after
    its, and its flags take in their lobes. A measured family stages its
    table in `staging`, the scene build's list (render/measured.py)."""
    desc = dict(desc or {"type": "diffuse"})
    t = desc.get("type")
    extra_flags = 0
    while t == "twosided":
        desc = dict(desc.get("bsdf", {"type": "diffuse"}))
        extra_flags |= F_TWOSIDED_FLAG
        t = desc.get("type")
    cls = _BY_NAME.get(t)
    if cls is None:
        raise ValueError(f"unknown bsdf type {t!r}")

    idx = len(mats)
    mats.append([cls.id, cls.flags | extra_flags, None])  # reserve the row
    child_flags = []

    def build_child(child_desc) -> int:
        ci = build_material(child_desc, mats, staging)
        child_flags.append(mats[ci][1])
        return ci

    if getattr(cls, "stages_table", False):
        row = cls.pack(desc, build_child, staging)
    else:
        row = cls.pack(desc, build_child)
    flags = cls.flags | extra_flags
    for cf in child_flags:  # wrappers inherit their children's lobes
        flags |= cf & ~F_TWOSIDED_FLAG
    mats[idx][1] = flags
    mats[idx][2] = row
    return idx


# ---------------------------------------------------------------------------
# Wavefront dispatch
# ---------------------------------------------------------------------------

def textured_slots(mat_type: np.ndarray, mat_data: np.ndarray) -> tuple:
    """((family id, slots), ...): each family's spectrum slots (0-2, and
    4 for ALPHA_SLOT) that some row of it fills with a texture (kind
    column >= 2), the static metadata of the lookups it makes."""
    slots = np.asarray([0, 1, 2, ALPHA_SLOT // SLOT_W])  # not the scalars
    kinds = mat_data[:, slots * SLOT_W + SLOT_W - 1]
    return tuple(
        (int(fid), frozenset(int(k) for k in slots[
            (kinds[mat_type == fid] >= 2).any(0)]))
        for fid in np.unique(mat_type))


def wrapper_children(mat_type: np.ndarray, mat_data: np.ndarray) -> tuple:
    """(((wrapper family, column), leaf families), ...): the families of
    the children in each child column of each wrapper family's rows."""
    out = []
    for fid, cls in WRAPPER_FAMILIES.items():
        rows = mat_data[mat_type == fid]
        for col in cls.child_cols:
            if rows.shape[0]:
                kids = mat_type[rows[:, col].astype(np.int64)]
                out.append(((fid, col), frozenset(
                    int(k) for k in kids if int(k) in LEAF_FAMILIES)))
    return tuple(out)


def _lane_materials(scene, si):
    mat_idx = torch.clamp_min(scene.shape_mat[torch.clamp_min(si.shape, 0)], 0)
    return mat_idx, scene.mat_type[mat_idx], scene.mat_flags[mat_idx]


def lane_flags(scene, si):
    """Per-lane BSDFFlags."""
    return _lane_materials(scene, si)[2]


def _family_lanes(scene, mat_idx, mtype, families):
    """(family id, its lanes, the rows it reads) for each of `families`
    the scene holds: the masked evaluate-all runs every family on every
    lane, each on rows of its own family (a lane of another family's
    reads the family's first row, scene.family_rows). The JAX package
    runs a family on the other families' rows, whose columns mean other
    things (a diffuse row's eta is 0): values its selects discard, but
    whose infinite derivatives its backward multiplies by the zero
    cotangent of the unselected branch, NaN in every mat_data gradient of
    veach_mis() (diffuse walls beside conductor plates) and of the
    material gallery. A wrapper's children (mat_idx its lanes' child
    rows, mtype their families) follow the same rule."""
    single = len(scene.mat_families) == 1
    tex_slots = dict(scene.family_tex)
    for fid, row in zip(scene.mat_families, scene.family_rows):
        if fid not in families:
            continue
        own = mtype == fid
        idx = mat_idx if single else torch.where(own, mat_idx, row)
        yield fid, own, LaneRows(scene.mat_data, idx,
                                 textured=tex_slots.get(fid, frozenset()))


def _sample_leaf(scene, mtype, mat_idx, si, u1, u2, config,
                 families=LEAF_FAMILIES):
    """BSDF::sample of the leaf families (of `families`) on their lanes."""
    n, dev = mtype.shape[0], mtype.device
    bs = _zero_sample(n, dev)
    weight = Spec.zeros(n, config.n_channels, dev)
    for fid, sel, mdata in _family_lanes(scene, mat_idx, mtype, families):
        fam_bs, fam_w = LEAF_FAMILIES[fid].sample(mdata, si, u1, u2, config)
        bs = _select_sample(sel, fam_bs, bs)
        weight = swhere(sel, fam_w, weight)
    return bs, weight


def _eval_leaf(scene, mtype, mat_idx, si, wo, config,
               families=LEAF_FAMILIES) -> Spec:
    out = Spec.zeros(mtype.shape[0], config.n_channels, mtype.device)
    for fid, sel, mdata in _family_lanes(scene, mat_idx, mtype, families):
        out = swhere(sel, LEAF_FAMILIES[fid].eval(mdata, si, wo, config), out)
    return out


def _pdf_leaf(scene, mtype, mat_idx, si, wo, config,
              families=LEAF_FAMILIES) -> torch.Tensor:
    out = torch.zeros(mtype.shape[0], dtype=torch.float32, device=mtype.device)
    for fid, sel, mdata in _family_lanes(scene, mat_idx, mtype, families):
        out = torch.where(sel, LEAF_FAMILIES[fid].pdf(mdata, si, wo, config),
                          out)
    return out


def _select_sample(sel, a: BSDFSample, b: BSDFSample) -> BSDFSample:
    return BSDFSample(
        wo=vwhere(sel, a.wo, b.wo), pdf=torch.where(sel, a.pdf, b.pdf),
        eta=torch.where(sel, a.eta, b.eta),
        sampled_flags=torch.where(sel, a.sampled_flags, b.sampled_flags))


def _maybe_flip(scene, si, flags):
    """twosided: flip the local frame where a lane hits from behind
    (twosided.cpp). A scene without a twosided row skips it (flip None)."""
    if not scene.has_twosided:
        return si, None
    flip = ((flags & F_TWOSIDED_FLAG) != 0) & (Frame.cos_theta(si.wi) < 0)
    wi = vwhere(flip, Vec3(si.wi.x, si.wi.y, -si.wi.z), si.wi)
    return dataclasses.replace(si, wi=wi), flip


def _flip_wo(wo, flip):
    if flip is None:
        return wo
    return vwhere(flip, Vec3(wo.x, wo.y, -wo.z), wo)


def sample(scene, si, u1, u2, config) -> Tuple[BSDFSample, Spec]:
    """BSDF::sample over the wavefront: the leaf families, then the
    wrappers on their lanes."""
    mat_idx, mtype, flags = _lane_materials(scene, si)
    si_f, flip = _maybe_flip(scene, si, flags)
    bs, weight = _sample_leaf(scene, mtype, mat_idx, si_f, u1, u2, config)
    for fid, sel, mdata in _family_lanes(scene, mat_idx, mtype,
                                         WRAPPER_FAMILIES):
        fam_bs, fam_w = WRAPPER_FAMILIES[fid].sample(scene, mdata, si_f, u1,
                                                     u2, config)
        bs = _select_sample(sel, fam_bs, bs)
        weight = swhere(sel, fam_w, weight)
    bs.wo = _flip_wo(bs.wo, flip)
    return bs, weight


def eval_(scene, si, wo, config) -> Spec:
    """BSDF::eval (f * cos) over the wavefront."""
    mat_idx, mtype, flags = _lane_materials(scene, si)
    si_f, flip = _maybe_flip(scene, si, flags)
    wo_f = _flip_wo(wo, flip)
    out = _eval_leaf(scene, mtype, mat_idx, si_f, wo_f, config)
    for fid, sel, mdata in _family_lanes(scene, mat_idx, mtype,
                                         WRAPPER_FAMILIES):
        out = swhere(sel, WRAPPER_FAMILIES[fid].eval(scene, mdata, si_f,
                                                     wo_f, config), out)
    return out


def pdf(scene, si, wo, config) -> torch.Tensor:
    """BSDF::pdf over the wavefront."""
    mat_idx, mtype, flags = _lane_materials(scene, si)
    si_f, flip = _maybe_flip(scene, si, flags)
    wo_f = _flip_wo(wo, flip)
    out = _pdf_leaf(scene, mtype, mat_idx, si_f, wo_f, config)
    for fid, sel, mdata in _family_lanes(scene, mat_idx, mtype,
                                         WRAPPER_FAMILIES):
        out = torch.where(sel, WRAPPER_FAMILIES[fid].pdf(scene, mdata, si_f,
                                                         wo_f, config), out)
    return out


def null_transmission(scene, si, config) -> Spec:
    """The straight-through transmission of the hit surface's null lobe
    (BSDF::eval_null_transmission, read by volpath's transmittance): 1
    for `null` boundaries, 1 - opacity for `mask` surfaces, 1 on the
    other lanes (whose callers gate on F_NULL). A scene without a mask
    row reads no table."""
    one = Spec.ones(si.t.shape[0], config.n_channels, si.t.device)
    if MASK not in scene.mat_families:
        return one
    mat_idx, mtype, _ = _lane_materials(scene, si)
    for _, sel, mdata in _family_lanes(scene, mat_idx, mtype, (MASK,)):
        one = swhere(sel, one - _spec(mdata, 2, si, config), one)
    return one
