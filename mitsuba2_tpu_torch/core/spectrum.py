"""Host-side spectral fit of packed color slots (numpy).

The port's copy of the host half of mitsuba2_tpu/core/spectrum.py: the
sigmoid-polynomial fit that every packed spectrum slot stores beside its
RGB value. The port renders rgb and mono, which read only the RGB columns,
but it packs the same slots so its scene tables stay byte-equal to the
JAX package's. Device-side spectral evaluation comes with spectral mode.
"""
from __future__ import annotations

import numpy as np

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
