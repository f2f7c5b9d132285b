"""Film accumulation and development (counterpart of render/film.py).

Lanes are laid out (spp, H, W), so a box filter is a reshape and a sum
and its weight a count. A wider filter (tent, gaussian, mitchell,
catmullrom, lanczos) splats each sample to its (2R+1)^2 neighbours, one
tap at a time (a roll and a border mask, as the JAX package does), from
2R+1 column and 2R+1 row weights, and its weight sum is an (H, W)
tensor.
"""
from __future__ import annotations

import math

import torch

from ..core import math as m
from ..core.spec import Spec

FILTER_RADIUS = {"box": 0, "tent": 1, "gaussian": 2, "mitchell": 2,
                 "catmullrom": 2, "lanczos": 3}


def _mitchell(ax, B: float, C: float):
    x2, x3 = ax * ax, ax * ax * ax
    p1 = ((12 - 9 * B - 6 * C) * x3 + (-18 + 12 * B + 6 * C) * x2
          + (6 - 2 * B)) * (1 / 6)
    p2 = ((-B - 6 * C) * x3 + (6 * B + 30 * C) * x2
          + (-12 * B - 48 * C) * ax + (8 * B + 24 * C)) * (1 / 6)
    return torch.where(ax < 1.0, p1, torch.where(ax < 2.0, p2, 0.0))


def filter_eval(name: str, x: torch.Tensor) -> torch.Tensor:
    """The reconstruction filters (src/rfilters/*.cpp) at distance x from
    the sample, in pixels; 0 outside their radius."""
    ax = torch.abs(x)
    if name == "box":
        return torch.where(ax <= 0.5, 1.0, 0.0)
    if name == "tent":
        return torch.clamp_min(1.0 - ax, 0.0)
    if name == "gaussian":
        # sigma 0.5, truncated at radius 2 (rfilters/gaussian.cpp)
        alpha = -1.0 / (2.0 * 0.5 * 0.5)
        offset = torch.exp(torch.tensor(alpha * 4.0, dtype=x.dtype,
                                        device=x.device))
        return torch.clamp_min(torch.exp(alpha * x * x) - offset, 0.0)
    if name == "mitchell":
        return _mitchell(ax, 1.0 / 3.0, 1.0 / 3.0)
    if name == "catmullrom":
        return _mitchell(ax, 0.0, 0.5)
    if name == "lanczos":
        tau = 3.0
        return torch.where(ax < tau, m.sinxx(math.pi * x)
                           * m.sinxx(math.pi * x / tau), 0.0)
    raise ValueError(f"unknown rfilter {name!r}")


def accumulate_pass(image, wsum, values: Spec, jitter, config):
    """Add one pass of per-lane radiance, laid out (spp, H, W), into the
    (H, W, C) accumulator. `jitter` is the lanes' (jx, jy) subpixel
    position in [0, 1)^2; a box filter ignores it. Returns (image, wsum):
    wsum a count under the box filter, else an (H, W) tensor."""
    H, W = config.height, config.width
    sppc = values.ch[0].shape[0] // (H * W)
    name = config.rfilter
    if name == "box":
        img = torch.stack([c.reshape(sppc, H, W).sum(0) for c in values.ch],
                          -1)
        return image + img, wsum + sppc
    R = FILTER_RADIUS[name]
    vals = [c.reshape(sppc, H, W) for c in values.ch]
    # the sample's position relative to its own pixel's centre
    rel_x = jitter[0].reshape(sppc, H, W) - 0.5
    rel_y = jitter[1].reshape(sppc, H, W) - 0.5
    dev = image.device
    ys = torch.arange(H, device=dev)
    xs = torch.arange(W, device=dev)
    # the 2R+1 column weights, evaluated once for every row of taps
    wxs = [filter_eval(name, dx - rel_x) for dx in range(-R, R + 1)]
    for dy in range(-R, R + 1):
        wy = filter_eval(name, dy - rel_y)
        ymask = (ys >= max(dy, 0)) & (ys < H + min(dy, 0))
        for dx, wx in zip(range(-R, R + 1), wxs):
            # the sample's weight at pixel (y + dy, x + dx)
            wgt = wx * wy
            contrib = torch.stack([(c * wgt).sum(0) for c in vals], -1)
            wimg = wgt.sum(0)
            del wgt
            # the tap lands at (y + dy, x + dx): roll, and mask the wrap
            contrib = torch.roll(contrib, (dy, dx), dims=(0, 1))
            wimg = torch.roll(wimg, (dy, dx), dims=(0, 1))
            mask = ymask[:, None] & ((xs >= max(dx, 0))
                                     & (xs < W + min(dx, 0)))[None, :]
            image = image + torch.where(mask[..., None], contrib, 0.0)
            wsum = wsum + torch.where(mask, wimg, 0.0)
    return image, wsum


def zero_weight(config, device):
    """The film's empty weight sum: a count under the box filter, else an
    (H, W) tensor."""
    if config.rfilter == "box":
        return 0
    return torch.zeros((config.height, config.width), dtype=torch.float32,
                       device=device)


def develop(image, wsum):
    """Film::develop — normalize by the accumulated filter weight."""
    if torch.is_tensor(wsum) and wsum.dim() == 2:
        return image / torch.clamp_min(wsum, 1e-8)[..., None]
    return image / max(float(wsum), 1e-8)
