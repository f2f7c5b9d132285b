"""Morton codes for the wavefront presort key (counterpart of
kernels/compact.py::morton3)."""
from __future__ import annotations

import torch


def _part1by2(x):
    """Spread the bits of a 10-bit int: b9..b0 -> b9 0 0 b8 0 0 ... b0."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton3(p, lo, hi):
    """Planar points in [lo, hi]^3 -> 30-bit Morton codes (int64 holding
    uint32 values). lo, hi: (3,) tensors."""
    ext = torch.clamp_min(hi - lo, 1e-20)

    def q(c, k):
        t = torch.clamp((c - lo[k]) / ext[k], 0.0, 1.0)
        return (t * 1023.0).to(torch.int64)

    return (_part1by2(q(p.x, 0)) | (_part1by2(q(p.y, 1)) << 1)
            | (_part1by2(q(p.z, 2)) << 2))
