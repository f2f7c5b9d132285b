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


def promote(x, like):
    """x in the wider float dtype of x and `like`: torch keeps a lane
    tensor's f32 against a 0-dim f64 scene scalar where the JAX package's
    promotion (a float64 render's) widens it; an f32 value widens
    exactly, so the op that follows rounds as the JAX package's."""
    dt = torch.promote_types(x.dtype, like.dtype)
    return x if x.dtype == dt else x.to(dt)


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


def solve_quadratic(a, b, c):
    """(valid, x0, x1), x0 <= x1, of a x^2 + b x + c = 0, the linear case
    where |a| < 1e-20 and the stable +-sqrt form (math::solve_quadratic)."""
    is_linear = a.abs() < 1e-20
    disc = b * b - 4.0 * a * c
    sqrt_disc = safe_sqrt(disc)
    temp = -0.5 * (b + mulsign(sqrt_disc, b))
    x0q = temp / torch.where(is_linear, 1.0, a)
    x1q = c / torch.where(temp.abs() < 1e-20, 1.0, temp)
    lo, hi = torch.minimum(x0q, x1q), torch.maximum(x0q, x1q)
    x_lin = -c / torch.where(b.abs() < 1e-20, 1.0, b)
    valid = torch.where(is_linear, b.abs() >= 1e-20, disc >= 0.0)
    return (valid, torch.where(is_linear, x_lin, lo),
            torch.where(is_linear, x_lin, hi))


def find_interval(values, x):
    """The largest i with values[i] <= x, clamped to [0, len - 2]
    (math::find_interval); `values` sorted and 1-D."""
    idx = torch.searchsorted(values, x, right=True) - 1
    return torch.clamp(idx, 0, values.shape[0] - 2)
