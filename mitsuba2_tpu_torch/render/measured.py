"""Measured (data-driven) BSDF tables (counterpart of render/measured.py).

mitsuba2's `measured` plugin (src/bsdfs/measured.cpp, Dupuy & Jakob 2018)
importance-samples a tabulated BRDF by a per-incident-angle Marginal2D
warp. As in the JAX package the table is a plain isotropic grid:

    values:   (T, n_ti, n_to, n_phi, 3)  f * cos over the outgoing hemisphere
    weights:  (T, n_ti, n_to, n_phi)     sampling density (luminance * sin)
    marg_cdf: (T, n_ti, n_to)            cumulative row (theta_o) weight
    cond_cdf: (T, n_ti, n_to, n_phi)     within-row cumulative weight
    mueller:  (T, n_ti, n_to, n_phi, 4, 4) or None, measured_polarized's
              intensity-normalized Mueller matrices (m00 = 1)

with theta_i and theta_o uniform over [0, pi/2] and phi_d = phi_o - phi_i
over [0, 2 pi). A table comes from an RGL `.bsdf` file (render/rgl.py),
from `values`, or is baked from one of the analytic families
(`bake_from_desc`, run on the CPU at build time). The CDFs are built in
numpy on the host (`build_measured`) exactly as the JAX package builds
them, so one table gives byte-equal CDFs in both packages. A scene build
stages its tables in a list of its own (`stage_table`), never a module
global: two builds, or two ranks, never share one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..core.spec import Spec
from ..core.vec import Vec3

# the tables of MeasuredData, as scene_from_numpy takes them
TABLES = ("values", "weights", "marg_cdf", "cond_cdf", "mueller")
_HALF_PI = math.pi / 2
_TWO_PI = 2 * math.pi


@dataclasses.dataclass
class MeasuredData:
    values: torch.Tensor     # (T, n_ti, n_to, n_phi, 3) f * cos
    weights: torch.Tensor    # (T, n_ti, n_to, n_phi)
    marg_cdf: torch.Tensor   # (T, n_ti, n_to)
    cond_cdf: torch.Tensor   # (T, n_ti, n_to, n_phi)
    mueller: Optional[torch.Tensor] = None   # (T, n_ti, n_to, n_phi, 4, 4)

    def to(self, device) -> "MeasuredData":
        return MeasuredData(*(None if t is None else t.to(device)
                              for t in (self.values, self.weights,
                                        self.marg_cdf, self.cond_cdf,
                                        self.mueller)))

    @property
    def grid(self):
        """(n_ti, n_to, n_phi)."""
        return tuple(self.weights.shape[1:])


def measured_from_numpy(tabs: dict, device) -> MeasuredData:
    """build_measured's tables -> MeasuredData on `device`."""
    def up(k):
        a = tabs.get(k)
        return None if a is None else torch.from_numpy(
            np.array(a, np.float32, order="C")).to(device)
    return MeasuredData(*(up(k) for k in TABLES))


# ---------------------------------------------------------------------------
# Host build
# ---------------------------------------------------------------------------

def stage_table(staging: list, table, mueller=None) -> int:
    """Append a table (and measured_polarized's Mueller table) to a scene
    build's `staging` list; returns its table id (a row's col 28)."""
    if staging is None:
        raise RuntimeError("measured bsdf outside scene build")
    staging.append((np.asarray(table, np.float32),
                    None if mueller is None
                    else np.asarray(mueller, np.float32)))
    return len(staging) - 1


def _angle_grid(n_ti, n_to, n_phi):
    """The cell centres' local (wi, wo), (n_ti, n_to, n_phi, 3) each."""
    ti = (np.arange(n_ti) + 0.5) / n_ti * (np.pi / 2)
    to = (np.arange(n_to) + 0.5) / n_to * (np.pi / 2)
    ph = (np.arange(n_phi) + 0.5) / n_phi * (2 * np.pi)
    TI, TO, PH = np.meshgrid(ti, to, ph, indexing="ij")
    wi = np.stack([np.sin(TI), np.zeros_like(TI), np.cos(TI)], -1)
    wo = np.stack([np.sin(TO) * np.cos(PH), np.sin(TO) * np.sin(PH),
                   np.cos(TO)], -1)
    return wi, wo


def bake_from_desc(desc: dict, n_ti=32, n_to=64, n_phi=64) -> np.ndarray:
    """Tabulate one of the analytic leaf families into a measured table,
    evaluated by the port's own family on the CPU (the capture
    pipeline's stand-in)."""
    from ..config import RenderConfig
    from ..core.geometry import Frame
    from ..core.vec import Vec2
    from . import bsdf as bsdf_mod
    from .interaction import SurfaceInteraction
    from .spectra import LaneRows

    mats = []
    idx = bsdf_mod.build_material(desc, mats)
    mtype, _, row = mats[idx]
    cls = bsdf_mod.LEAF_FAMILIES[mtype]
    cfg = RenderConfig(color_mode="rgb")
    table = torch.from_numpy(np.asarray(row, np.float32)[None])

    def eval_fn(wi, wo):
        n = wi.shape[0]
        z, one = torch.zeros(n), torch.ones(n)
        up = Vec3(z, z, one)
        si = SurfaceInteraction(
            valid=torch.ones(n, dtype=torch.bool), t=one, p=Vec3(z, z, z),
            n=up, sh_frame=Frame.from_n(up), uv=Vec2(z, z),
            wi=Vec3(*wi.unbind(1)), shape=torch.zeros(n, dtype=torch.int32),
            prim_index=torch.zeros(n, dtype=torch.int32))
        data = LaneRows(table, torch.zeros(n, dtype=torch.int64))
        return torch.stack(cls.eval(data, si, Vec3(*wo.unbind(1)),
                                    cfg).ch, -1)

    with torch.inference_mode():
        return tabulate_bsdf(eval_fn, n_ti, n_to, n_phi)


def build_measured(tables) -> dict:
    """Staged tables (f * cos arrays, or (values, mueller or None) tuples)
    -> the numpy tables of MeasuredData (TABLES; mueller None where no
    table has one), the JAX package's arithmetic: the weights and CDFs
    in float64, stored as float32."""
    entries = [(t, None) if not isinstance(t, tuple) else t for t in tables]
    vals = np.stack([np.asarray(t, np.float32) for t, _ in entries])
    _, n_ti, n_to, n_phi, _ = vals.shape
    lum = vals @ np.array([0.2126, 0.7152, 0.0722], np.float32)
    theta_o = (np.arange(n_to) + 0.5) / n_to * (np.pi / 2)
    w = lum * np.sin(theta_o)[None, None, :, None]
    w = np.maximum(w, 1e-12)
    cond = np.cumsum(w, axis=-1)
    marg = np.cumsum(cond[..., -1], axis=-1)
    mueller = None
    if any(m is not None for _, m in entries):
        ident = np.zeros((n_ti, n_to, n_phi, 4, 4), np.float32)
        ident[..., 0, 0] = 1.0   # a pure depolarizer for plain entries
        mueller = np.stack([ident if m is None else np.asarray(m, np.float32)
                            for _, m in entries])
    return {"values": vals, "weights": w.astype(np.float32),
            "marg_cdf": marg.astype(np.float32),
            "cond_cdf": cond.astype(np.float32), "mueller": mueller}


def tabulate_bsdf(eval_fn, n_ti=32, n_to=64, n_phi=64) -> np.ndarray:
    """Bake a BSDF into a measured table: eval_fn(wi (N, 3), wo (N, 3)
    float32 tensors, local frame) -> (N, 3) f * cos."""
    wi, wo = _angle_grid(n_ti, n_to, n_phi)
    vals = eval_fn(torch.from_numpy(wi.reshape(-1, 3).astype(np.float32)),
                   torch.from_numpy(wo.reshape(-1, 3).astype(np.float32)))
    return np.asarray(vals, np.float32).reshape(n_ti, n_to, n_phi, 3)


def bake_mueller_conductor(eta_re: float, eta_im: float,
                           n_ti=32, n_to=64, n_phi=64) -> np.ndarray:
    """Intensity-normalized conductor-Fresnel Mueller matrices on the
    measured grid, at each cell's microfacet half angle: the polarization
    structure of a metallic capture when no polarized capture is given."""
    from . import mueller as mu
    wi, wo = _angle_grid(n_ti, n_to, n_phi)
    h = wi + wo
    h /= np.maximum(np.linalg.norm(h, axis=-1, keepdims=True), 1e-9)
    cos_h = np.clip(np.abs((wi * h).sum(-1)), 1e-4, 1.0)
    n = cos_h.size
    m = mu.specular_reflection_conductor(
        torch.from_numpy(cos_h.reshape(-1).astype(np.float32)),
        torch.full((n,), eta_re, dtype=torch.float32),
        torch.full((n,), eta_im, dtype=torch.float32)).numpy()
    m = m.reshape(n_ti, n_to, n_phi, 4, 4)
    return (m / np.maximum(m[..., 0:1, 0:1], 1e-12)).astype(np.float32)


# ---------------------------------------------------------------------------
# Lane-batched evaluation and sampling over a wavefront
# ---------------------------------------------------------------------------

def _theta_i_index(md: MeasuredData, wi: Vec3):
    n_ti = md.grid[0]
    theta_i = torch.acos(torch.clamp(wi.z, 1e-6, 1.0))
    return torch.clamp((theta_i / _HALF_PI * n_ti).to(torch.int64), 0,
                       n_ti - 1)


def _phi_d(wi: Vec3, wo: Vec3):
    return torch.remainder(torch.atan2(wo.y, wo.x) - torch.atan2(wi.y, wi.x),
                           _TWO_PI)


def _coords(md: MeasuredData, wi: Vec3, wo: Vec3):
    """(theta_o, theta_i's cell, the continuous theta_o and phi_d cell
    coordinates of the bilinear read)."""
    n_ti, n_to, n_phi = md.grid
    theta_o = torch.acos(torch.clamp(wo.z, 0.0, 1.0))
    x_to = torch.clamp(theta_o / _HALF_PI * n_to - 0.5, 0.0, n_to - 1.0)
    x_ph = _phi_d(wi, wo) / _TWO_PI * n_phi - 0.5
    return theta_o, _theta_i_index(md, wi), x_to, x_ph


def _grid_lookup(md: MeasuredData, tid, wi: Vec3, wo: Vec3):
    """Nearest theta_i, bilinear theta_o and phi_d read of the table:
    (f * cos Spec, the sampling pdf in solid angle)."""
    n_ti, n_to, n_phi = md.grid
    theta_o, i_ti, x_to, x_ph = _coords(md, wi, wo)
    i_to = torch.clamp(torch.floor(x_to).to(torch.int64), 0, n_to - 2)
    f_to = x_to - i_to
    i_ph = torch.floor(x_ph).to(torch.int64)
    f_ph = x_ph - i_ph
    flat_vals = md.values.reshape(-1, 3)
    base = (tid.to(torch.int64) * n_ti + i_ti) * n_to

    def read(d_to, d_ph):
        ito = torch.clamp(i_to + d_to, 0, n_to - 1)
        iph = torch.remainder(i_ph + d_ph, n_phi)
        return flat_vals[(base + ito) * n_phi + iph].unbind(1)

    r00, r01 = read(0, 0), read(0, 1)
    r10, r11 = read(1, 0), read(1, 1)
    val = Spec(tuple(
        r00[c] * ((1 - f_to) * (1 - f_ph)) + r01[c] * ((1 - f_to) * f_ph)
        + r10[c] * (f_to * (1 - f_ph)) + r11[c] * (f_to * f_ph)
        for c in range(3)))
    # the sampling pdf of the piecewise-constant weight table
    iph0 = torch.remainder(torch.round(x_ph).to(torch.int64), n_phi)
    ito0 = torch.clamp(torch.round(x_to).to(torch.int64), 0, n_to - 1)
    w_cell = md.weights.reshape(-1)[(base + ito0) * n_phi + iph0]
    total = md.marg_cdf.reshape(-1)[base + (n_to - 1)]
    pdf_cell = w_cell / torch.clamp_min(total, 1e-20)
    # a (theta_o, phi_d) cell's area -> solid angle: sin(to) dto dphi
    dto, dph = _HALF_PI / n_to, _TWO_PI / n_phi
    sin_to = torch.clamp_min(torch.sin(theta_o), 1e-6)
    return val, pdf_cell / (dto * dph * sin_to)


def lookup_cells(md: MeasuredData, wi: Vec3, wo: Vec3) -> torch.Tensor:
    """(N, 6) int64: the cells a lookup at (wi, wo) reads, as rounded from
    arccos and arctan2: theta_i's; the bilinear read's first theta_o and
    phi_d cells; the pdf's nearest theta_o and phi_d; mueller_lookup's
    flat cell of table 0. Two devices that round one of them otherwise
    read a neighbouring cell there."""
    _, i_ti, x_to, x_ph = _coords(md, wi, wo)
    tid = torch.zeros_like(i_ti)
    return torch.stack([i_ti, torch.floor(x_to).to(torch.int64),
                        torch.floor(x_ph).to(torch.int64),
                        torch.round(x_to).to(torch.int64),
                        torch.round(x_ph).to(torch.int64),
                        cell_index(md, tid, wi, wo)], 1)


def eval_measured(md: MeasuredData, tid, wi: Vec3, wo: Vec3) -> Spec:
    """f * cos for wi, wo in the local frame; zero below the horizon."""
    val, _ = _grid_lookup(md, tid, wi, wo)
    return val.masked((wi.z > 0) & (wo.z > 0))


def pdf_measured(md: MeasuredData, tid, wi: Vec3, wo: Vec3):
    _, pdf = _grid_lookup(md, tid, wi, wo)
    return torch.where((wi.z > 0) & (wo.z > 0), pdf, 0.0)


def _bisect(flat, base, width: int, target):
    """Per-lane lower bound: the first k in [0, width) with flat[base + k]
    >= target, by ceil(log2 width) + 1 gathers of one value a lane (never
    an (N, width) row)."""
    lo = torch.zeros_like(base)
    hi = torch.full_like(base, width)
    for _ in range(int(np.ceil(np.log2(max(width, 2)))) + 1):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        right = flat[base + mid] < target
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(right, hi, mid)
    return lo


def sample_measured(md: MeasuredData, tid, wi: Vec3, u2):
    """Importance-sample (theta_o, phi_d) by 2D CDF inversion in wi's
    theta_i slice (measured.cpp's Marginal2D warp): (wo, solid-angle pdf)."""
    n_ti, n_to, n_phi = md.grid
    tid = tid.to(torch.int64)
    i_ti = _theta_i_index(md, wi)
    u2a, u2b = u2
    flat_marg = md.marg_cdf.reshape(-1)
    flat_cond = md.cond_cdf.reshape(-1)
    marg_base = (tid * n_ti + i_ti) * n_to
    total = flat_marg[marg_base + (n_to - 1)]
    t_r = u2b * total
    row = torch.clamp(_bisect(flat_marg, marg_base, n_to, t_r), 0, n_to - 1)
    marg_lo = torch.where(
        row > 0, flat_marg[marg_base + torch.clamp_min(row - 1, 0)], 0.0)
    row_sum = flat_marg[marg_base + row] - marg_lo
    ur = torch.clamp((t_r - marg_lo) / torch.clamp_min(row_sum, 1e-20), 0.0,
                     1.0 - 1e-7)
    cond_base = (marg_base + row) * n_phi
    t_c = u2a * row_sum
    col = torch.clamp(_bisect(flat_cond, cond_base, n_phi, t_c), 0,
                      n_phi - 1)
    cond_lo = torch.where(
        col > 0, flat_cond[cond_base + torch.clamp_min(col - 1, 0)], 0.0)
    cell = flat_cond[cond_base + col] - cond_lo
    uc = torch.clamp((t_c - cond_lo) / torch.clamp_min(cell, 1e-20), 0.0,
                     1.0 - 1e-7)
    theta_o = (row + ur) / n_to * _HALF_PI
    phi_o = torch.atan2(wi.y, wi.x) + (col + uc) / n_phi * _TWO_PI
    st, ct = torch.sin(theta_o), torch.cos(theta_o)
    wo = Vec3(st * torch.cos(phi_o), st * torch.sin(phi_o), ct)
    pdf_cell = cell / torch.clamp_min(total, 1e-20)
    dto, dph = _HALF_PI / n_to, _TWO_PI / n_phi
    pdf = pdf_cell / (dto * dph * torch.clamp_min(st, 1e-6))
    return wo, torch.where((total > 0) & (wi.z > 0), pdf, 0.0)


def cell_index(md: MeasuredData, tid, wi: Vec3, wo: Vec3):
    """The flat index of the nearest (theta_i, theta_o, phi_d) cell, the
    one mueller_lookup reads."""
    n_ti, n_to, n_phi = md.grid
    theta_o = torch.acos(torch.clamp(wo.z, 0.0, 1.0))
    i_ti = _theta_i_index(md, wi)
    i_to = torch.clamp((theta_o / _HALF_PI * n_to).to(torch.int64), 0,
                       n_to - 1)
    i_ph = torch.remainder((_phi_d(wi, wo) / _TWO_PI * n_phi).to(torch.int64),
                           n_phi)
    return ((tid.to(torch.int64) * n_ti + i_ti) * n_to + i_to) * n_phi + i_ph


def mueller_lookup(md: MeasuredData, tid, wi: Vec3, wo: Vec3):
    """The nearest cell's Mueller structure (N, 4, 4) at local (wi, wo)."""
    return md.mueller.reshape(-1, 4, 4)[cell_index(md, tid, wi, wo)]
