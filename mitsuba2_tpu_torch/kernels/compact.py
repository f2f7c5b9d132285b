"""Morton codes and wavefront compaction (counterpart of
kernels/compact.py).

`morton3` keys the traversal presort (scene.coherence_key). With
RenderConfig(compact=True) the path tracer also permutes its whole
wavefront before each bounce (render/integrators.py::_path_bounce): dead
lanes to the back, live lanes in Morton order of their hit points; every
per-lane tensor moves, the sampler's state too, so each lane draws and
decides what it would have unpermuted, and the radiance goes back to
lane order at the end (`unsort`).
"""
from __future__ import annotations

import dataclasses

import torch

# a dead lane's key: above every 30-bit Morton code
DEAD_KEY = 0xFFFFFFFF


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


def compaction_order(active, p, bb_min, bb_max):
    """The permutation (N,) int64 `perm`, arr[perm] the compacted layout:
    live lanes first, Morton-ordered by their points `p`, dead lanes
    last; ties keep lane order (a stable sort, as jnp.argsort)."""
    key = torch.where(active, morton3(p, bb_min, bb_max), DEAD_KEY)
    return torch.sort(key, stable=True)[1]


def permute(tree, perm):
    """`tree` (tuples, named ones too, and dataclasses of tensors: the
    path tracer's carry) with every per-lane tensor, first dimension N =
    len(perm), gathered by `perm`; other leaves unchanged."""
    n = perm.shape[0]

    def go(a):
        if torch.is_tensor(a):
            return a[perm] if a.dim() >= 1 and a.shape[0] == n else a
        if dataclasses.is_dataclass(a):
            return dataclasses.replace(a, **{
                f.name: go(getattr(a, f.name)) for f in dataclasses.fields(a)})
        if isinstance(a, tuple):
            return (type(a)(*map(go, a)) if hasattr(a, "_fields")
                    else tuple(map(go, a)))
        return a
    return go(tree)


def unsort(values, orig_lane):
    """Per-lane values (a tensor, or a tree of them as `permute` walks)
    scattered back to their original lanes: out[orig_lane[i]] =
    values[i]."""
    inv = torch.empty_like(orig_lane)
    inv[orig_lane] = torch.arange(orig_lane.shape[0],
                                  device=orig_lane.device)
    return permute(values, inv)
