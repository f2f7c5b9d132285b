"""BSDF layer (counterpart of render/bsdf.py): the leaf families of
config 2 and the `twosided` wrapper.

A family is a set of pure functions over a packed material row; the
wavefront dispatch is masked evaluate-all over the families present in
the scene, as in the JAX package. This slice ports diffuse, conductor,
roughconductor, dielectric, thindielectric, roughdielectric, plastic and
roughplastic, and `twosided` (a flag on its child's row: the dispatch
flips the local frame of a lane that hits it from behind). The other
families raise at scene build, naming themselves, and so does a
roughness texture.

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
from ..core.vec import Vec3, vdot, vnormalize, vwhere
from . import fresnel as fr
from . import ior as ior_mod
from . import microfacet as mf
from .spectra import LaneRows, SLOT_W, eval_spectrum_slot, pack_color

MAT_W = 40
# cols [0:24]: three 8-wide spectrum slots (family-specific)
# cols [24:32]: family-specific scalars (alphas, IOR ratios)
# cols [32:40]: ALPHA_SLOT, the JAX package's roughness texture of the
#   rough families: all zero here (a textured roughness is refused)
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

# the JAX package's families this slice does not port, by id, and the
# names that select them
UNPORTED = {8: "null", 9: "mask", 10: "blendbsdf", 11: "normalmap",
            12: "bumpmap", 13: "measured", 14: "polarizer", 15: "retarder",
            16: "measured_polarized"}
_UNPORTED_NAMES = set(UNPORTED.values()) | {"blend"}

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


def _spec(data, i, si, config) -> Spec:
    return eval_spectrum_slot(data.slot(i), si.wavelengths, config.color_mode)


def _pack_alpha(props, key="alpha", default=0.1) -> float:
    """Host: a scalar roughness, for its column. The JAX package also
    takes a texture here (into ALPHA_SLOT): not in this slice."""
    a = props.get(key, default)
    if isinstance(a, dict):
        raise NotImplementedError(
            "mitsuba2_tpu_torch does not support textured roughness yet "
            f"({key} = {a.get('type')!r})")
    return float(a)


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
        a = _pack_alpha(props)
        data[24] = _pack_alpha(props, "alpha_u", a)
        data[25] = _pack_alpha(props, "alpha_v", a)
        data[26] = _DIST_NAME[props.get("distribution", "ggx")]
        return data

    @staticmethod
    def _params(data):
        return (torch.clamp_min(data.col(24), 1e-4),
                torch.clamp_min(data.col(25), 1e-4),
                data.col(26).to(torch.int32))

    @staticmethod
    def sample(data, si, u1, u2, config):
        au, av, dist = RoughConductor._params(data)
        cos_i = Frame.cos_theta(si.wi)
        m_dir, pdf_m = mf.sample(dist, si.wi, au, av, u2)
        wo = fr.reflect_m(si.wi, m_dir)
        cos_o = Frame.cos_theta(wo)
        dot_wim = vdot(si.wi, m_dir)
        pdf = pdf_m / torch.clamp_min(4.0 * dot_wim.abs(), 1e-20)
        active = (cos_i > 0) & (cos_o > 0) & (pdf_m > 0)
        # weight = f cos_o / pdf, through eval
        f_cos = RoughConductor.eval(data, si, wo, config)
        weight = f_cos / torch.clamp_min(pdf, 1e-20)
        bs = BSDFSample(wo=wo, pdf=torch.where(active, pdf, 0.0),
                        eta=torch.ones_like(pdf),
                        sampled_flags=_flags(active, F_GLOSSY_R))
        return bs, weight.masked(active)

    @staticmethod
    def eval(data, si, wo, config):
        au, av, dist = RoughConductor._params(data)
        cos_i = Frame.cos_theta(si.wi)
        cos_o = Frame.cos_theta(wo)
        h = vnormalize(si.wi + wo)
        D = mf.eval_d(dist, h, au, av)
        G = mf.g_smith(dist, si.wi, wo, h, au, av)
        F = Conductor._fresnel(data, vdot(si.wi, h), si, config)
        spec = _spec(data, 2, si, config)
        f_cos = spec * F * (D * G / torch.clamp_min(4.0 * cos_i, 1e-20))
        return f_cos.masked((cos_i > 0) & (cos_o > 0))

    @staticmethod
    def pdf(data, si, wo, config):
        au, av, dist = RoughConductor._params(data)
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
        a = _pack_alpha(props)
        data[25] = _pack_alpha(props, "alpha_u", a)
        data[26] = _pack_alpha(props, "alpha_v", a)
        data[27] = _DIST_NAME[props.get("distribution", "ggx")]
        return data

    @staticmethod
    def _params(data):
        return (data.col(24), torch.clamp_min(data.col(25), 1e-4),
                torch.clamp_min(data.col(26), 1e-4),
                data.col(27).to(torch.int32))

    @staticmethod
    def sample(data, si, u1, u2, config):
        eta, au, av, dist = RoughDielectric._params(data)
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
        eta, au, av, dist = RoughDielectric._params(data)
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
        eta, au, av, dist = RoughDielectric._params(data)
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
        data[29] = _pack_alpha(props)
        data[30] = _DIST_NAME[props.get("distribution", "ggx")]
        return data

    @staticmethod
    def _params(data):
        return (torch.clamp_min(data.col(29), 1e-4),
                data.col(30).to(torch.int32))

    @staticmethod
    def sample(data, si, u1, u2, config):
        cos_i = Frame.cos_theta(si.wi)
        prob_spec = Plastic._probs(data, cos_i)[1]
        pick_spec = u1 < prob_spec
        au, dist = RoughPlastic._params(data)

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
        au, dist = RoughPlastic._params(data)
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
        au, dist = RoughPlastic._params(data)
        h = vnormalize(si.wi + wo)
        pdf_m = mf.pdf(dist, si.wi, h, au, au)
        pdf_spec = pdf_m / torch.clamp_min(4.0 * vdot(si.wi, h).abs(), 1e-20)
        pdf_diff = warp.square_to_cosine_hemisphere_pdf(wo)
        pdf = prob_spec * pdf_spec + (1.0 - prob_spec) * pdf_diff
        return torch.where((cos_i > 0) & (cos_o > 0), pdf, 0.0)


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

FAMILIES = {c.id: c for c in (Diffuse, Conductor, RoughConductor,
                              Dielectric, ThinDielectric, RoughDielectric,
                              Plastic, RoughPlastic)}
_BY_NAME = {"diffuse": Diffuse, "conductor": Conductor,
            "roughconductor": RoughConductor, "dielectric": Dielectric,
            "thindielectric": ThinDielectric,
            "roughdielectric": RoughDielectric, "plastic": Plastic,
            "roughplastic": RoughPlastic}


def build_material(desc: dict, mats: List) -> int:
    """Host: append the rows of `desc` to `mats` ([type, flags, row]
    entries); returns its row index. `twosided` (nested too) is a flag on
    its child's row; a wrapper's flags take in its children's lobes."""
    desc = dict(desc or {"type": "diffuse"})
    t = desc.get("type")
    extra_flags = 0
    while t == "twosided":
        desc = dict(desc.get("bsdf", {"type": "diffuse"}))
        extra_flags |= F_TWOSIDED_FLAG
        t = desc.get("type")
    cls = _BY_NAME.get(t)
    if cls is None:
        if t in _UNPORTED_NAMES:
            raise NotImplementedError(
                f"mitsuba2_tpu_torch does not support the {t!r} BSDF yet")
        raise ValueError(f"unknown bsdf type {t!r}")

    idx = len(mats)
    mats.append([cls.id, cls.flags | extra_flags, None])  # reserve the row
    child_flags = []

    def build_child(child_desc) -> int:
        ci = build_material(child_desc, mats)
        child_flags.append(mats[ci][1])
        return ci

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

def _lane_materials(scene, si):
    mat_idx = torch.clamp_min(scene.shape_mat[torch.clamp_min(si.shape, 0)], 0)
    return mat_idx, scene.mat_type[mat_idx], scene.mat_flags[mat_idx]


def lane_flags(scene, si):
    """Per-lane BSDFFlags."""
    return _lane_materials(scene, si)[2]


def _family_lanes(scene, mat_idx, mtype):
    """(family id, its lanes, the rows it reads) for each family of the
    scene: the masked evaluate-all runs every family on every lane, each
    on rows of its own family (a lane of another family's reads the
    family's first row, scene.family_rows). The JAX package runs a family
    on the other families' rows, whose columns mean other things (a
    diffuse row's eta is 0): values its selects discard, but whose
    infinite derivatives its backward multiplies by the zero cotangent of
    the unselected branch, NaN in every mat_data gradient of veach_mis()
    (diffuse walls beside conductor plates) and of the material
    gallery."""
    single = len(scene.mat_families) == 1
    for fid, row in zip(scene.mat_families, scene.family_rows):
        own = mtype == fid
        idx = mat_idx if single else torch.where(own, mat_idx, row)
        yield fid, own, LaneRows(scene.mat_data, idx)


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
    """BSDF::sample over the wavefront."""
    mat_idx, mtype, flags = _lane_materials(scene, si)
    si_f, flip = _maybe_flip(scene, si, flags)
    n, dev = mtype.shape[0], mtype.device
    bs = _zero_sample(n, dev)
    weight = Spec.zeros(n, config.n_channels, dev)
    for fid, sel, mdata in _family_lanes(scene, mat_idx, mtype):
        fam_bs, fam_w = FAMILIES[fid].sample(mdata, si_f, u1, u2, config)
        bs = BSDFSample(
            wo=vwhere(sel, fam_bs.wo, bs.wo),
            pdf=torch.where(sel, fam_bs.pdf, bs.pdf),
            eta=torch.where(sel, fam_bs.eta, bs.eta),
            sampled_flags=torch.where(sel, fam_bs.sampled_flags,
                                      bs.sampled_flags))
        weight = swhere(sel, fam_w, weight)
    bs.wo = _flip_wo(bs.wo, flip)
    return bs, weight


def eval_(scene, si, wo, config) -> Spec:
    """BSDF::eval (f * cos) over the wavefront."""
    mat_idx, mtype, flags = _lane_materials(scene, si)
    si_f, flip = _maybe_flip(scene, si, flags)
    wo_f = _flip_wo(wo, flip)
    out = Spec.zeros(mtype.shape[0], config.n_channels, mtype.device)
    for fid, sel, mdata in _family_lanes(scene, mat_idx, mtype):
        out = swhere(sel, FAMILIES[fid].eval(mdata, si_f, wo_f, config), out)
    return out


def pdf(scene, si, wo, config) -> torch.Tensor:
    """BSDF::pdf over the wavefront."""
    mat_idx, mtype, flags = _lane_materials(scene, si)
    si_f, flip = _maybe_flip(scene, si, flags)
    wo_f = _flip_wo(wo, flip)
    out = torch.zeros(mtype.shape[0], dtype=torch.float32, device=mtype.device)
    for fid, sel, mdata in _family_lanes(scene, mat_idx, mtype):
        out = torch.where(sel, FAMILIES[fid].pdf(mdata, si_f, wo_f, config),
                          out)
    return out
