"""Spectrum slots (counterpart of render/spectra.py).

Every color parameter is one 8-float slot [r, g, b, c2, c1, c0, scale,
kind], packed exactly as the JAX package packs it. The port evaluates
slots in rgb and mono mode; textured slots (kind >= 2) raise at build.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import spectrum as sp
from ..core.spec import Spec

SLOT_W = 8
SLOT_REFLECTANCE = 0.0
SLOT_ILLUMINANT = 1.0
SLOT_TEX_BASE = 2.0   # the JAX package's textured slots: refused here


# lanes whose gradients a column gather's backward adds up apart (below)
GATHER_SPREAD = 1024


class _LaneGather(torch.autograd.Function):
    """col.index_select(0, idx) for a column `col` of a few rows and a
    wavefront of lanes. Its backward adds lane i's gradient into row
    i % GATHER_SPREAD of a (GATHER_SPREAD, M) buffer with index_add_, then
    sums the buffer's rows. Adding a million lanes into M rows directly
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
        lane = torch.arange(idx.shape[0], device=idx.device)
        spread = (lane % GATHER_SPREAD) * m + idx
        buf = g.new_zeros(GATHER_SPREAD * m).index_add_(0, spread, g)
        return buf.view(GATHER_SPREAD, m).sum(0), None


@dataclasses.dataclass
class LaneRows:
    """Lazy per-lane rows of a small packed (M, W) table: one (N,) column
    gather per column read: through _LaneGather under autograd, else a
    plain index_select (the forward render skips the Function call's
    host time)."""
    table: torch.Tensor
    idx: torch.Tensor
    base: int = 0

    def col(self, i: int):
        col = self.table[:, self.base + i]
        if torch.is_grad_enabled():
            return _LaneGather.apply(col, self.idx)
        return col.index_select(0, self.idx)

    def slot(self, k: int) -> "LaneRows":
        return LaneRows(self.table, self.idx, self.base + k * SLOT_W)


def pack_spectrum_slot(rgb, illuminant: bool = False) -> np.ndarray:
    rgb = np.asarray(rgb, np.float64).reshape(3)
    coeffs, scale = sp.fit_srgb_model(rgb)
    return np.array([rgb[0], rgb[1], rgb[2], coeffs[0], coeffs[1], coeffs[2],
                     scale, SLOT_ILLUMINANT if illuminant else SLOT_REFLECTANCE],
                    np.float32)


def pack_color(value, illuminant: bool = False) -> np.ndarray:
    """Host: a scalar, an RGB triple or a uniform/srgb/d65 spectrum dict ->
    one slot. Textures and tabulated spectra come in a later slice."""
    if isinstance(value, dict):
        t = value.get("type")
        if t in ("uniform", "d65", "srgb", "rgb"):
            return pack_color(value.get("value", 1.0), illuminant or t == "d65")
        raise NotImplementedError(
            f"mitsuba2_tpu_torch does not support {t!r} colors yet "
            "(textures and tabulated spectra)")
    v = value
    if isinstance(v, (int, float)):
        v = [v, v, v]
    return pack_spectrum_slot(v, illuminant=illuminant)


def eval_spectrum_slot(slot: LaneRows, color_mode: str) -> Spec:
    """Device: a batch of constant slots -> planar Spec (rgb or mono)."""
    r, g, b = slot.col(0), slot.col(1), slot.col(2)
    if color_mode == "rgb":
        return Spec((r, g, b))
    return Spec((sp.luminance_t(r, g, b),))
