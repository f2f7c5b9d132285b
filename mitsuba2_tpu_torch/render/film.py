"""Box-filter film (counterpart of render/film.py).

Lanes are laid out (spp, H, W), so a box filter is a reshape and a sum.
"""
from __future__ import annotations

import torch

from ..core.spec import Spec


def accumulate_pass(image, wsum, values: Spec, config):
    """Add one pass of per-lane radiance into the (H, W, C) accumulator."""
    H, W = config.height, config.width
    sppc = values.ch[0].shape[0] // (H * W)
    img = torch.stack([c.reshape(sppc, H, W).sum(0) for c in values.ch], -1)
    return image + img, wsum + sppc


def develop(image, wsum):
    """Film::develop — normalize by the accumulated filter weight."""
    return image / max(float(wsum), 1e-8)
