"""BSDF layer with the diffuse family (counterpart of render/bsdf.py).

A family is a set of pure functions over a packed material row; the
wavefront dispatch is masked evaluate-all over the families present in
the scene, as in the JAX package. This slice ports `diffuse`; any other
family (`twosided` included) raises at scene build, naming itself.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..core import warp
from ..core.geometry import Frame
from ..core.spec import Spec, swhere
from ..core.vec import Vec3, vwhere
from .spectra import LaneRows, SLOT_W, eval_spectrum_slot, pack_color

MAT_W = 40

F_DIFFUSE_R = 1 << 1
F_DIFFUSE_T = 1 << 2
F_GLOSSY_R = 1 << 3
F_GLOSSY_T = 1 << 4
F_DELTA_R = 1 << 5
F_DELTA_T = 1 << 6
F_TWOSIDED_FLAG = 1 << 16   # the JAX package's twosided flag: refused here
F_SMOOTH = F_DIFFUSE_R | F_DIFFUSE_T | F_GLOSSY_R | F_GLOSSY_T
F_DELTA = F_DELTA_R | F_DELTA_T

DIFFUSE = 0


@dataclasses.dataclass
class BSDFSample:
    wo: Vec3
    pdf: torch.Tensor
    eta: torch.Tensor
    sampled_flags: torch.Tensor


class Diffuse:
    id = DIFFUSE
    flags = F_DIFFUSE_R

    @staticmethod
    def pack(props) -> np.ndarray:
        data = np.zeros(MAT_W, np.float32)
        data[0:SLOT_W] = pack_color(props.get("reflectance", [0.5, 0.5, 0.5]))
        return data

    @staticmethod
    def sample(data, si, u1, u2, config):
        cos_i = Frame.cos_theta(si.wi)
        wo = warp.square_to_cosine_hemisphere(*u2)
        pdf = warp.square_to_cosine_hemisphere_pdf(wo)
        active = cos_i > 0
        value = eval_spectrum_slot(data.slot(0), config.color_mode)
        bs = BSDFSample(wo=wo, pdf=torch.where(active, pdf, 0.0),
                        eta=torch.ones_like(pdf),
                        sampled_flags=torch.where(
                            active, F_DIFFUSE_R, 0).to(torch.int32))
        return bs, value.masked(active)

    @staticmethod
    def eval(data, si, wo, config):
        cos_i = Frame.cos_theta(si.wi)
        cos_o = Frame.cos_theta(wo)
        active = (cos_i > 0) & (cos_o > 0)
        value = eval_spectrum_slot(data.slot(0), config.color_mode)
        return (value * (warp.INV_PI * cos_o)).masked(active)

    @staticmethod
    def pdf(data, si, wo, config):
        cos_i = Frame.cos_theta(si.wi)
        cos_o = Frame.cos_theta(wo)
        return torch.where((cos_i > 0) & (cos_o > 0), cos_o * warp.INV_PI, 0.0)


# Differentiable parameters of each family (name -> location in its row),
# read by scene.build_fields into SceneData.param_paths: ("slot", k) is the
# RGB at cols [8k, 8k + 3) of spectrum slot k, ("scalar", c) one column
Diffuse.param_spec = {"reflectance": ("slot", 0)}

FAMILIES = {Diffuse.id: Diffuse}
_BY_NAME = {"diffuse": Diffuse}


def build_material(desc: dict, mats: List) -> int:
    """Host: append the row of `desc` to `mats` ([type, flags, row]
    entries); returns the row index."""
    desc = desc or {"type": "diffuse"}
    t = desc.get("type")
    cls = _BY_NAME.get(t)
    if cls is None:
        raise NotImplementedError(
            f"mitsuba2_tpu_torch does not support the {t!r} BSDF yet")
    mats.append([cls.id, cls.flags, cls.pack(desc)])
    return len(mats) - 1


def _lane_materials(scene, si):
    mat_idx = torch.clamp_min(scene.shape_mat[torch.clamp_min(si.shape, 0)], 0)
    return (scene.mat_type[mat_idx], LaneRows(scene.mat_data, mat_idx),
            scene.mat_flags[mat_idx])


def lane_flags(scene, si):
    """Per-lane BSDFFlags."""
    return _lane_materials(scene, si)[2]


def sample(scene, si, u1, u2, config) -> Tuple[BSDFSample, Spec]:
    """BSDF::sample over the wavefront."""
    mtype, mdata, _ = _lane_materials(scene, si)
    n, dev = mtype.shape[0], mtype.device
    z = torch.zeros(n, dtype=torch.float32, device=dev)
    bs = BSDFSample(wo=Vec3(z, z, z), pdf=z, eta=torch.ones_like(z),
                    sampled_flags=torch.zeros(n, dtype=torch.int32, device=dev))
    weight = Spec.zeros(n, config.n_channels, dev)
    for fid in scene.mat_families:
        fam_bs, fam_w = FAMILIES[fid].sample(mdata, si, u1, u2, config)
        sel = mtype == fid
        bs = BSDFSample(
            wo=vwhere(sel, fam_bs.wo, bs.wo),
            pdf=torch.where(sel, fam_bs.pdf, bs.pdf),
            eta=torch.where(sel, fam_bs.eta, bs.eta),
            sampled_flags=torch.where(sel, fam_bs.sampled_flags,
                                      bs.sampled_flags))
        weight = swhere(sel, fam_w, weight)
    return bs, weight


def eval_(scene, si, wo, config) -> Spec:
    """BSDF::eval (f * cos) over the wavefront."""
    mtype, mdata, _ = _lane_materials(scene, si)
    out = Spec.zeros(mtype.shape[0], config.n_channels, mtype.device)
    for fid in scene.mat_families:
        out = swhere(mtype == fid,
                     FAMILIES[fid].eval(mdata, si, wo, config), out)
    return out


def pdf(scene, si, wo, config) -> torch.Tensor:
    """BSDF::pdf over the wavefront."""
    mtype, mdata, _ = _lane_materials(scene, si)
    out = torch.zeros(mtype.shape[0], dtype=torch.float32, device=mtype.device)
    for fid in scene.mat_families:
        out = torch.where(mtype == fid,
                          FAMILIES[fid].pdf(mdata, si, wo, config), out)
    return out
