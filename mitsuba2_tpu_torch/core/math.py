"""Low-level math (counterpart of mitsuba2_tpu/core/math.py, forward only)."""
from __future__ import annotations

import numpy as np
import torch

EPSILON = float(np.finfo(np.float32).eps) / 2
RAY_EPSILON = EPSILON * 1500.0
_TINY = float(np.finfo(np.float32).tiny)


def safe_sqrt(x):
    return torch.sqrt(torch.clamp_min(x, 0.0))


def safe_rsqrt(x):
    return torch.rsqrt(torch.clamp_min(x, _TINY))


def safe_acos(x):
    """arccos with its argument clamped to [-1, 1]."""
    return torch.acos(torch.clamp(x, -1.0, 1.0))


def mulsign(x, y):
    """x * sign(y), +1 for y = +0 (enoki::mulsign)."""
    return torch.where(y >= 0, x, -x)
