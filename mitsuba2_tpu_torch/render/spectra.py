"""Spectrum slots (counterpart of render/spectra.py).

Every color parameter is one 8-float slot [r, g, b, c2, c1, c0, scale,
kind], packed exactly as the JAX package packs it: the linear-sRGB value,
the sigmoid-polynomial coefficients of its spectrum (core/spectrum.py)
and the brightness the fit normalized away, and whether it is a
reflectance or an illuminant (which multiplies D65 in spectral mode).
rgb and mono read the RGB columns, spectral mode evaluates the
coefficients at each lane's hero wavelengths. Tabulated (regular,
irregular) and blackbody spectra pack into the same slots.

Textured slots (src/textures/bitmap.cpp): kind = 2 + 2 * tex_id + the
illuminant bit. Evaluation reads the scene's texture atlas at the
lane's uv (render/texture.py) and, in spectral mode, upsamples the RGB
through the coefficient lattice lane by lane. A build stages the
textures its colors name (`texture_staging`) and packs them into the
atlas in that order.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..core import spectrum as sp
from ..core.spec import Spec, swhere

SLOT_W = 8
SLOT_REFLECTANCE = 0.0
SLOT_ILLUMINANT = 1.0
SLOT_TEX_BASE = 2.0   # kind >= 2: textured; kind = 2 + 2 * tex_id + illum


# lanes whose gradients a column gather's backward adds up apart (below),
# and the most entries of that buffer (a large table's rows spread less)
GATHER_SPREAD = 1024
GATHER_BUFFER = 1 << 22


class _LaneGather(torch.autograd.Function):
    """col.index_select(0, idx) for a column `col` of a few rows and a
    wavefront of lanes. Its backward adds lane i's gradient into row
    i % S of an (S, M) buffer with index_add_, then sums the buffer's
    rows; S is GATHER_SPREAD, less where S * M would exceed GATHER_BUFFER
    (an envmap's texels). Adding a million lanes into M rows directly
    serializes their atomics on a handful of addresses (0.39 ms a column
    on an H100); advanced indexing's backward (index_put_ with accumulate)
    sorts the indices and sums each row's run serially (~15 ms)."""

    @staticmethod
    def forward(ctx, col, idx):
        ctx.save_for_backward(idx)
        ctx.rows = col.shape[0]
        return col.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        m = ctx.rows
        rows = max(1, min(GATHER_SPREAD, GATHER_BUFFER // m))
        lane = torch.arange(idx.shape[0], device=idx.device)
        spread = (lane % rows) * m + idx
        buf = g.new_zeros(rows * m).index_add_(0, spread, g)
        return buf.view(rows, m).sum(0), None


def lane_gather(col, idx):
    """col[idx] for a wavefront of lanes: through _LaneGather where
    autograd records, else a plain index_select."""
    if torch.is_grad_enabled() and col.requires_grad:
        return _LaneGather.apply(col, idx)
    return col.index_select(0, idx)


def gather_columns(table, idx, k: int):
    """Columns 0..k-1 of table[idx], each (N,): column by column through
    _LaneGather where autograd records into `table` (the geometry's
    gathers under a loss over moved prims), else one row gather."""
    if torch.is_grad_enabled() and table.requires_grad:
        return tuple(_LaneGather.apply(table[:, c], idx) for c in range(k))
    return table[idx].unbind(1)[:k]


@dataclasses.dataclass
class LaneRows:
    """Lazy per-lane rows of a small packed (M, W) table: one (N,) column
    gather per column read: through _LaneGather under autograd, else a
    plain index_select (the forward render skips the Function call's
    host time). `textured`: the slots (k of slot(k)) that a row these
    lanes may read fills with a texture; the others skip the lookup."""
    table: torch.Tensor
    idx: torch.Tensor
    base: int = 0
    textured: frozenset = frozenset()

    def col(self, i: int):
        return lane_gather(self.table[:, self.base + i], self.idx)

    def slot(self, k: int) -> "LaneRows":
        return dataclasses.replace(self, base=self.base + k * SLOT_W)


def pack_spectrum_slot(rgb, illuminant: bool = False) -> np.ndarray:
    rgb = np.asarray(rgb, np.float64).reshape(3)
    coeffs, scale = sp.fit_srgb_model(rgb)
    return np.array([rgb[0], rgb[1], rgb[2], coeffs[0], coeffs[1], coeffs[2],
                     scale, SLOT_ILLUMINANT if illuminant else SLOT_REFLECTANCE],
                    np.float32)


def pack_texture_slot(tex_id: int, illuminant: bool = False,
                      mean_rgb=(0.5, 0.5, 0.5)) -> np.ndarray:
    """Host: a slot naming texture `tex_id`; its RGB columns hold the
    texture's mean."""
    m = np.asarray(mean_rgb, np.float32).reshape(3)
    kind = SLOT_TEX_BASE + 2 * tex_id + (1 if illuminant else 0)
    return np.array([m[0], m[1], m[2], 0, 0, 0, 1.0, kind], np.float32)


# the textures of the build in progress (texture_staging), None outside one
_TEX_STAGING = None


@contextlib.contextmanager
def texture_staging():
    """A scene build's texture staging: inside the block, pack_color
    appends each texture descriptor it meets to the list it yields (a
    slot's texture id is its index there)."""
    global _TEX_STAGING
    outer, _TEX_STAGING = _TEX_STAGING, []
    try:
        yield _TEX_STAGING
    finally:
        _TEX_STAGING = outer


def tabulated_wls_vals(value: dict):
    """Host: a regular or irregular spectrum dict -> (wavelengths, values)
    f64 arrays."""
    if value.get("type") == "regular":
        vals = np.asarray(value["values"], np.float64)
        lo = float(value.get("lambda_min", sp.WAVELENGTH_MIN))
        hi = float(value.get("lambda_max", sp.WAVELENGTH_MAX))
        wls = np.linspace(lo, hi, len(vals))
    else:
        wls = np.asarray(value["wavelengths"], np.float64)
        vals = np.asarray(value["values"], np.float64)
    return wls, vals


def pack_color(value, illuminant: bool = False) -> np.ndarray:
    """Host: a scalar, an RGB triple, a spectrum dict (uniform, srgb,
    d65, regular, irregular, blackbody) or a texture dict (bitmap,
    checkerboard; inside texture_staging) -> one slot."""
    if isinstance(value, dict):
        t = value.get("type")
        if t in ("bitmap", "checkerboard"):
            from . import texture as texture_mod
            tb = texture_mod.build_texture(value, name=value.get("id", ""))
            if _TEX_STAGING is None:
                raise RuntimeError(
                    "textured color outside scene build (no staging active)")
            tid = len(_TEX_STAGING)
            _TEX_STAGING.append(tb)
            return pack_texture_slot(tid, illuminant,
                                     tb.data.reshape(-1, 3).mean(0))
        if t in ("uniform", "d65", "srgb", "rgb"):
            return pack_color(value.get("value", 1.0), illuminant or t == "d65")
        if t in ("regular", "irregular"):
            # src/spectra/{regular,irregular}.cpp: the exact CIE -> sRGB
            # projection for the rgb columns, a direct fit for spectral
            # mode; always a reflectance slot (the table is the whole
            # spectrum: a D65 factor would be wrong even for emission)
            wls, vals = tabulated_wls_vals(value)
            rgb = np.clip(sp.spectrum_to_rgb_host(wls, vals), 0.0, None)
            coeffs, scale = sp.fit_srgb_model_to_spectrum(wls, vals)
            return np.array([rgb[0], rgb[1], rgb[2],
                             coeffs[0], coeffs[1], coeffs[2], scale,
                             SLOT_REFLECTANCE], np.float32)
        if t == "blackbody":
            # src/spectra/blackbody.cpp: Planck at `temperature`, tabulated
            wls = np.linspace(sp.WAVELENGTH_MIN, sp.WAVELENGTH_MAX, 64)
            temp = float(value.get("temperature", 6500.0))
            vals = sp.blackbody_radiance(wls, temp)
            vals = vals * float(value.get("scale", 1.0))
            return pack_color({"type": "irregular", "wavelengths": wls,
                               "values": vals}, illuminant=True)
        raise ValueError(f"unknown spectrum/texture type {t!r}")
    v = value
    if isinstance(v, (int, float)):
        v = [v, v, v]
    return pack_spectrum_slot(v, illuminant=illuminant)


def _const_value(col, wavelengths, color_mode) -> Spec:
    r, g, b = col(0), col(1), col(2)
    if color_mode == "rgb":
        return Spec((r, g, b))
    if color_mode == "mono":
        return Spec((sp.luminance_t(r, g, b),))
    # spectral: the sigmoid polynomial times its scale
    c2, c1, c0, scale = col(3), col(4), col(5), col(6)
    return Spec(tuple(sp.srgb_model_eval_t(c2, c1, c0, w) * scale
                      for w in wavelengths.ch))


def _tex_value(rgb: Spec, wavelengths, color_mode) -> Spec:
    """Per-lane RGB (a Spec3) -> the value in `color_mode`. Spectral mode
    upsamples through the coefficient lattice, RGB above 1 folded into a
    scale as rgb2spec does (envmap NEE's path)."""
    if color_mode == "rgb":
        return rgb
    if color_mode == "mono":
        return Spec((sp.luminance_t(*rgb.ch),))
    scale = sp._max(rgb.hmax() / 0.999, 1.0)
    inv = 1.0 / scale
    c2, c1, c0 = sp.srgb_model_fetch_interp_t(
        sp.srgb_model_fetch_lattice(), rgb.ch[0] * inv, rgb.ch[1] * inv,
        rgb.ch[2] * inv)
    return Spec(tuple(sp.srgb_model_eval_t(c2, c1, c0, w) * scale
                      for w in wavelengths.ch))


def eval_spectrum_slot(slot: LaneRows, wavelengths, color_mode: str,
                       tex=None, uv=None, duv=None) -> Spec:
    """Device: a batch of slots -> planar Spec: 1 channel (mono), 3 (rgb)
    or 4 (spectral, at the lanes' hero wavelengths `wavelengths`, ignored
    otherwise; an illuminant slot times D65). With the scene's texture
    atlas `tex` and the lanes' `uv`, a textured slot reads the atlas
    (mip-filtered over `duv` = (duv_dx, duv_dy) where given)."""
    val = _const_value(slot.col, wavelengths, color_mode)
    textured = tex is not None and uv is not None
    if not textured and color_mode != "spectral":
        return val
    kind = slot.col(7)
    is_illum = kind == SLOT_ILLUMINANT
    if textured:
        from . import texture as texture_mod
        kind_i = kind.to(torch.int64)
        is_tex = kind_i >= 2
        tid = torch.clamp_min(torch.div(kind_i - 2, 2, rounding_mode="floor"),
                              0)
        rgb_t = texture_mod.eval_rgb(tex, tid, uv, duv=duv)
        val = swhere(is_tex, _tex_value(rgb_t, wavelengths, color_mode), val)
        is_illum = is_illum | (is_tex & (torch.remainder(kind_i - 2, 2) == 1))
    if color_mode != "spectral":
        return val
    d65 = Spec(tuple(sp.d65_approx(w) for w in wavelengths.ch))
    return swhere(is_illum, val * d65, val)
