"""Participating media and phase functions (counterpart of
render/media.py).

Media live in the scene as a packed table (`med_type`, `med_data`); a
shape carries the index of its interior medium (`shape_interior`, -1 =
vacuum) and the volumetric integrator (render/volpath.py) tracks each
lane's current medium as an integer.

Medium row layout (MED_W = 8), as the JAX package packs it:
    [0:3] sigma_t RGB (extinction)  [3:6] albedo RGB (sigma_s / sigma_t)
    [6]   phase g (Henyey-Greenstein; 0 = isotropic)
    [7]   scale applied to grid densities (heterogeneous)

Heterogeneous media share one density grid a scene (`GridVolume`);
sigma_t(x) = grid(x) * row sigma_t * scale.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import warp
from ..core.geometry import Frame
from ..core.vec import Vec3, vdot
from .spectra import lane_gather

MED_W = 8
MEDIUM_HOMOGENEOUS = 0
MEDIUM_HETEROGENEOUS = 1


@dataclasses.dataclass
class GridVolume:
    """A 3D voxel grid over a world-space box, trilinear (volume.h's
    grid3d): data (D, H, W) density, bbox_min and bbox_max (3,)."""
    data: torch.Tensor
    bbox_min: torch.Tensor
    bbox_max: torch.Tensor

    def to(self, device) -> "GridVolume":
        return GridVolume(*(t.to(device) for t in (self.data, self.bbox_min,
                                                   self.bbox_max)))

    def eval(self, p: Vec3):
        """Trilinear density at world points p (any lane shape), 0
        outside the box. The arithmetic is the JAX package's, operation
        for operation: the density feeds delta-tracking decisions (u <
        density / majorant), where an ulp can change a lane's path. The
        eight corners are one gather through spectra.lane_gather (its
        spread backward under autograd)."""
        D, H, W = self.data.shape
        bmn = self.bbox_min
        ext = self.bbox_max - bmn
        tx = (p.x - bmn[0]) / ext[0]
        ty = (p.y - bmn[1]) / ext[1]
        tz = (p.z - bmn[2]) / ext[2]
        inside = ((tx >= 0) & (tx <= 1) & (ty >= 0) & (ty <= 1) &
                  (tz >= 0) & (tz <= 1))
        xx = tx * (W - 1)
        xy = ty * (H - 1)
        xz = tz * (D - 1)
        # clamped before the integer cast: a point far outside the box
        # (a flight through vacuum) would overflow it
        ix = torch.clamp(torch.floor(xx), 0, W - 2).to(torch.int64)
        iy = torch.clamp(torch.floor(xy), 0, H - 2).to(torch.int64)
        iz = torch.clamp(torch.floor(xz), 0, D - 2).to(torch.int64)
        fx, fy, fz = xx - ix, xy - iy, xz - iz
        base = (iz * H + iy) * W + ix
        # a grid one voxel thick along an axis clamps its index to -1 (the
        # range [0, -1]), whose corner the JAX package's indexing wraps to
        # the last plane, its only one: wrapped here too (no index
        # reaches past the end)
        corners = torch.remainder(torch.stack(
            [base + (dz * H + dy) * W + dx for dz in (0, 1)
             for dy in (0, 1) for dx in (0, 1)]), D * H * W)
        (g000, g100, g010, g110, g001, g101, g011, g111) = lane_gather(
            self.data.reshape(-1), corners.reshape(-1)).view(
                corners.shape).unbind(0)
        gx, gy, gz = 1 - fx, 1 - fy, 1 - fz
        v = ((g000 * gx + g100 * fx) * gy +
             (g010 * gx + g110 * fx) * fy) * gz + \
            ((g001 * gx + g101 * fx) * gy +
             (g011 * gx + g111 * fx) * fy) * fz
        return torch.where(inside, v, 0.0)


def pack_medium(desc: dict) -> Tuple[int, np.ndarray, Optional[dict]]:
    """Host: medium descriptor -> (type, row, grid descriptor or None),
    byte-equal to the JAX package's.

    homogeneous: {"type": "homogeneous", "sigma_t": rgb, "albedo": rgb,
                  "g": float} or {"sigma_s": rgb, "sigma_a": rgb}
    heterogeneous: {"type": "heterogeneous", "density": (D,H,W) array, a
                    scalar (a constant 2^3 grid) or a Mitsuba .vol
                    filename (also under "filename"), "bbox_min",
                    "bbox_max" (default: the .vol header's box, else the
                    unit cube), "sigma_t", "albedo", "scale"}
    A color may be a scalar, an RGB triple or a tabulated spectrum
    (projected to RGB)."""
    row = np.zeros(MED_W, np.float32)
    t = desc.get("type", "homogeneous")

    def rgb(v, default):
        v = desc.get(v, default)
        if isinstance(v, dict):  # tabulated spectrum -> CIE-projected RGB
            from ..core import spectrum as sp
            from .spectra import tabulated_wls_vals
            v = np.clip(sp.spectrum_to_rgb_host(*tabulated_wls_vals(v)),
                        0.0, None)
        if isinstance(v, (int, float)):
            v = [v] * 3
        return np.asarray(v, np.float32)

    if "sigma_s" in desc or "sigma_a" in desc:
        ss = rgb("sigma_s", 1.0)
        sa = rgb("sigma_a", 0.0)
        st = ss + sa
        alb = ss / np.maximum(st, 1e-20)
    else:
        st = rgb("sigma_t", 1.0)
        alb = rgb("albedo", 0.75)
    row[0:3] = st
    row[3:6] = alb
    row[6] = float(desc.get("g", 0.0))
    row[7] = float(desc.get("scale", 1.0))
    if t == "homogeneous":
        return MEDIUM_HOMOGENEOUS, row, None
    if t == "heterogeneous":
        density = desc.get("density", desc.get("filename"))
        bmn = desc.get("bbox_min")
        bmx = desc.get("bbox_max")
        if isinstance(density, str):  # Mitsuba .vol file (gridvolume)
            from ..core.io_vol import read_vol
            density, fmn, fmx = read_vol(density)
            if density.ndim == 4:  # multi-channel grid: mean density
                density = density.mean(-1)
            bmn = fmn if bmn is None else bmn
            bmx = fmx if bmx is None else bmx
        if density is None:
            raise ValueError("heterogeneous medium needs a 'density' grid "
                             "or a .vol 'filename'")
        density = np.asarray(density, np.float32)
        if density.ndim == 0:  # constvolume density
            density = np.full((2, 2, 2), float(density), np.float32)
        return MEDIUM_HETEROGENEOUS, row, {
            "density": density,
            "bbox_min": np.asarray([0, 0, 0] if bmn is None else bmn,
                                   np.float32),
            "bbox_max": np.asarray([1, 1, 1] if bmx is None else bmx,
                                   np.float32)}
    raise ValueError(f"unknown medium type {t!r}")


# ---------------------------------------------------------------------------
# Phase functions (src/phase/{isotropic,hg}.cpp). g = 0 is isotropic: the
# HG formulas give 1 / (4 pi) there, so one code path serves both.
# ---------------------------------------------------------------------------

def phase_hg_eval(g, cos_theta):
    """Henyey-Greenstein phase value (= its pdf over the sphere)."""
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return warp.INV_FOUR_PI * (1.0 - g * g) / torch.clamp_min(
        denom * torch.sqrt(torch.clamp_min(denom, 1e-12)), 1e-12)


def phase_hg_sample(g, wi: Vec3, u2):
    """Sample wo from HG around -wi (forward scattering for g > 0); wi
    points toward the viewer (as si.wi), wo along the new propagation
    direction. u2: a (ua, ub) pair. Returns (wo Vec3, pdf); g is clamped
    to 1e-4 in magnitude. The sampling is detached (Mitsuba 2's
    convention): wo carries no derivative, the pdf carries g's, so a
    caller's weight value / detach(pdf), 1 in value, has d/dg of
    d(pdf)/dg / pdf. Moving wo with g instead would differentiate the
    radiance along it, whose visibility steps a derivative misses."""
    ua, ub = u2
    g = torch.where(g.abs() < 1e-4, torch.full_like(g, 1e-4), g)
    gd = g.detach()
    sqr = (1.0 - gd * gd) / (1.0 - gd + 2.0 * gd * ua)
    cos_theta = -(1.0 + gd * gd - sqr * sqr) / (2.0 * gd)
    cos_theta = torch.clamp(cos_theta, -1.0, 1.0)
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    phi = 2.0 * math.pi * ub
    frame = Frame.from_n(-wi)  # the propagation direction
    wo = frame.to_world(Vec3(sin_theta * torch.cos(phi),
                             sin_theta * torch.sin(phi), cos_theta))
    return wo, phase_hg_eval(g, cos_theta)


def phase_eval(g, wi: Vec3, wo: Vec3):
    """Phase value for scattering wi (toward the viewer) into wo: the
    cosine is between the propagation direction -wi and wo."""
    return phase_hg_eval(g, -vdot(wi, wo))
