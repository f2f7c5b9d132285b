"""Low-level math (counterpart of mitsuba2_tpu/core/math.py).

`safe_sqrt` and `safe_acos` carry the JAX package's custom derivatives:
finite where the plain ones are infinite, because the adjoint's zero
cotangent times an infinite derivative turns whole gradients into NaN.
"""
from __future__ import annotations

import numpy as np
import torch

EPSILON = float(np.finfo(np.float32).eps) / 2
RAY_EPSILON = EPSILON * 1500.0
_TINY = float(np.finfo(np.float32).tiny)


def _sqrt0(x):
    return torch.sqrt(torch.clamp_min(x, 0.0))


class _SafeSqrt(torch.autograd.Function):
    """sqrt(max(x, 0)) whose derivative is 0.5 / max(y, 1e-10) where
    x > 1e-20 and 0 elsewhere (dr::safe_sqrt)."""

    @staticmethod
    def forward(ctx, x):
        y = _sqrt0(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return g * torch.where(x > 1e-20, 0.5 / torch.clamp_min(y, 1e-10),
                               0.0)


class _SafeAcos(torch.autograd.Function):
    """arccos of x clamped to [-1, 1] whose derivative is
    -1 / safe_sqrt(1 - xc^2 + 1e-12), bounded at the endpoints."""

    @staticmethod
    def forward(ctx, x):
        xc = torch.clamp(x, -1.0, 1.0)
        ctx.save_for_backward(xc)
        return torch.acos(xc)

    @staticmethod
    def backward(ctx, g):
        xc, = ctx.saved_tensors
        return g * (-1.0 / _sqrt0(1.0 - xc * xc + 1e-12))


def safe_sqrt(x):
    return _SafeSqrt.apply(x) if torch.is_grad_enabled() else _sqrt0(x)


def safe_rsqrt(x):
    return torch.rsqrt(torch.clamp_min(x, _TINY))


def safe_acos(x):
    """arccos with its argument clamped to [-1, 1]."""
    if torch.is_grad_enabled():
        return _SafeAcos.apply(x)
    return torch.acos(torch.clamp(x, -1.0, 1.0))


def mulsign(x, y):
    """x * sign(y), +1 for y = +0 (enoki::mulsign)."""
    return torch.where(y >= 0, x, -x)


def sinxx(x):
    """sin(x) / x with the limit 1 at 0."""
    return torch.where(torch.abs(x) < 1e-6, 1.0,
                       torch.sin(x) / torch.where(x == 0, 1.0, x))
