"""Spectral fit of packed color slots (counterpart of core/spectrum.py).

The port's copy of the host half of mitsuba2_tpu/core/spectrum.py: the
sigmoid-polynomial fit that every packed spectrum slot stores beside its
RGB value. The port renders rgb and mono, which read only the RGB columns,
but it packs the same slots so its scene tables stay byte-equal to the
JAX package's. `diff.params.scene_with` rebuilds a slot from a new RGB
value on the device, differentiably, through the committed coefficient
lattice (`srgb_model_fetch_lattice`, `srgb_model_fetch_interp`).
Device-side spectral evaluation comes with spectral mode.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import cie_data as _cie

WAVELENGTH_MIN = 360.0
WAVELENGTH_MAX = 830.0

_D65_LUM = float((_cie.D65_TBL * _cie.CIE_1931_TBL[:, 1]).sum()
                 / _cie.CIE_1931_TBL[:, 1].sum())

XYZ_TO_SRGB = np.array([
    [3.240479, -1.537150, -0.498535],
    [-0.969256, 1.875991, 0.041556],
    [0.055648, -0.204043, 1.057311]], dtype=np.float32)

_FIT_WL = np.linspace(WAVELENGTH_MIN, WAVELENGTH_MAX, 95)
_XYZ_W = (_cie.interp_table(_cie.CIE_1931_TBL, _FIT_WL)
          * (_cie.interp_table(_cie.D65_TBL, _FIT_WL) / _D65_LUM)[:, None])
_XYZ_W = _XYZ_W / np.trapezoid(_XYZ_W[:, 1], _FIT_WL)
_PROJ = (np.asarray(XYZ_TO_SRGB, np.float64) @
         (_XYZ_W.T * np.gradient(_FIT_WL)))  # (3, 95): rgb = PROJ @ R(wl)


def fit_srgb_model(rgb, iters: int = 50):
    """Gauss–Newton fit of sigmoid-polynomial coefficients to one linear
    sRGB color; returns (coeffs (3,) on the raw wavelength axis, scale)."""
    rgb = np.asarray(rgb, np.float64)
    scale = 1.0
    mx = rgb.max()
    if mx > 0.999:
        scale = mx / 0.999
        rgb = rgb / scale
    lum = float(rgb @ np.array([0.2126, 0.7152, 0.0722]))
    lum = min(max(lum, 1e-4), 0.9999)
    x0 = np.arctanh(2.0 * lum - 1.0)
    wlc = (_FIT_WL - 560.0) / 100.0
    coeffs = np.array([0.0, 0.0, x0])

    def model(cf):
        x = (cf[0] * wlc + cf[1]) * wlc + cf[2]
        return 0.5 + 0.5 * x / np.sqrt(1.0 + x * x)

    for _ in range(iters):
        f = _PROJ @ model(coeffs) - rgb
        if np.abs(f).max() < 1e-7:
            break
        x = (coeffs[0] * wlc + coeffs[1]) * wlc + coeffs[2]
        dr_dx = 0.5 / np.power(1.0 + x * x, 1.5)
        J = _PROJ @ (dr_dx[:, None] * np.stack(
            [wlc * wlc, wlc, np.ones_like(wlc)], axis=-1))
        try:
            step = np.linalg.solve(J + 1e-12 * np.eye(3), f)
        except np.linalg.LinAlgError:
            break
        coeffs = coeffs - step
    a, b, c = coeffs
    c2 = a / 100.0 ** 2
    c1 = b / 100.0 - 2 * a * 560.0 / 100.0 ** 2
    c0 = a * (560.0 / 100.0) ** 2 - b * 560.0 / 100.0 + c
    return np.array([c2, c1, c0], np.float64), scale


def luminance_t(r, g, b):
    """Planar luminance of linear sRGB channels (mono mode)."""
    return 0.212671 * r + 0.715160 * g + 0.072169 * b


# ---------------------------------------------------------------------------
# The RGB -> coefficient lattice (rgb2spec's max-channel parameterization)
# ---------------------------------------------------------------------------

LATTICE_RES = 64   # the committed table's resolution (data/srgb_coeff_64.npz)
_LATTICE = {}      # the table, host copy (None) and one tensor a device


def _z_nodes(res: int):
    """Nonuniform z (max-channel value) lattice nodes: a double smoothstep
    (ext/rgb2spec's scale array)."""
    t = np.linspace(0.0, 1.0, res)
    s = t * t * (3.0 - 2.0 * t)
    return (s * s * (3.0 - 2.0 * s)).astype(np.float64)


def srgb_model_fetch_lattice(res: int = LATTICE_RES) -> np.ndarray:
    """The (3, res, res, res, 3) f32 coefficient lattice indexed [max
    channel k][z node][y][x][coeff]: the committed table, the port's own
    byte-identical copy of the JAX package's. Only its resolution exists
    here; the JAX package's on-demand fit of others and its external-table
    override (MI_SRGB_COEFF) are not ported."""
    if res != LATTICE_RES:
        raise NotImplementedError(
            f"mitsuba2_tpu_torch has only the res {LATTICE_RES} lattice")
    if None not in _LATTICE:
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "data", f"srgb_coeff_{res}.npz")
        out = np.load(path)["coeffs"].astype(np.float32)
        assert out.shape == (3, res, res, res, 3), out.shape
        _LATTICE[None] = out
    return _LATTICE[None]


def _lattice_on(lattice, device) -> torch.Tensor:
    """The lattice as a tensor on `device`, the committed one uploaded once
    a device, and made outside inference mode so that autograd may use it."""
    if lattice is not _LATTICE.get(None):
        return torch.as_tensor(lattice, device=device)
    if device not in _LATTICE:
        with torch.inference_mode(False):
            _LATTICE[device] = torch.as_tensor(lattice, device=device)
    return _LATTICE[device]


def _max(x, c: float):
    """jnp.maximum(x, c): half the derivative to each side of a tie, as
    torch.maximum gives it (torch.clamp would give all of it)."""
    return torch.maximum(x, torch.tensor(c, dtype=x.dtype, device=x.device))


def _clip(x, lo: float, hi: float):
    """jnp.clip(x, lo, hi), with its derivative at the bounds."""
    return torch.minimum(_max(x, lo),
                         torch.tensor(hi, dtype=x.dtype, device=x.device))


def srgb_model_fetch_interp_t(lattice, r, g, b):
    """Planar trilinear coefficient fetch: (N,) rgb channels -> (c2, c1,
    c0) each (N,), differentiable in the channels. The lattice is sliced
    by the max channel k, z = that channel's value on the _z_nodes scale,
    (x, y) = the other two channels divided by it."""
    lat = _lattice_on(lattice, r.device)
    ZR, R = lat.shape[1], lat.shape[2]
    mx = torch.maximum(torch.maximum(r, g), b)
    k = torch.where(r >= torch.maximum(g, b), 0,
                    torch.where(g >= b, 1, 2))
    mxc = _max(mx, 1e-9)
    x = torch.where(k == 0, g, torch.where(k == 1, b, r)) / mxc
    y = torch.where(k == 0, b, torch.where(k == 1, r, g)) / mxc
    z = _clip(mx, 0.0, 1.0)

    zn = torch.as_tensor(_z_nodes(ZR), dtype=torch.float32, device=r.device)
    iz = torch.clamp((z[..., None] >= zn).sum(-1) - 1, 0, ZR - 2)
    z_lo, z_hi = zn[iz], zn[iz + 1]
    fz = _clip((z - z_lo) / _max(z_hi - z_lo, 1e-12), 0.0, 1.0)

    tx = _clip(x, 0.0, 1.0) * (R - 1)
    ty = _clip(y, 0.0, 1.0) * (R - 1)
    ix = torch.clamp(torch.floor(tx).to(torch.int64), 0, R - 2)
    iy = torch.clamp(torch.floor(ty).to(torch.int64), 0, R - 2)
    fx, fy = tx - ix, ty - iy

    flat = lat.reshape(3 * ZR * R * R, 3)
    out = []
    for c in range(3):
        col = flat[:, c]
        acc = 0.0
        for dz in (0, 1):
            wz = fz if dz else (1.0 - fz)
            for dy in (0, 1):
                wy = fy if dy else (1.0 - fy)
                for dx in (0, 1):
                    wx = fx if dx else (1.0 - fx)
                    idx = ((k * ZR + iz + dz) * R + iy + dy) * R + ix + dx
                    acc = acc + col[idx] * (wz * wy * wx)
        out.append(acc)
    return out[0], out[1], out[2]


def srgb_model_fetch_interp(lattice, rgb):
    """(..., 3) rgb in [0, 1]^3 -> (..., 3) coefficients (c2, c1, c0)."""
    shape = rgb.shape[:-1]
    r, g, b = (rgb[..., i].reshape(-1) for i in range(3))
    c2, c1, c0 = srgb_model_fetch_interp_t(lattice, r, g, b)
    return torch.stack([c2, c1, c0], -1).reshape(shape + (3,))
