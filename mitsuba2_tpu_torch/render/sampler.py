"""The independent sampler (counterpart of render/sampler.py).

One PCG32 stream per lane, seeded from (base_seed, lane index) through a
TEA hash, bit-equal to the JAX package's streams. The generator is
explicit state, so no torch.Generator is involved.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..core import pcg32


@dataclasses.dataclass
class Sampler:
    state: pcg32.PCG32State

    @staticmethod
    def seed(base_seed: int, lane_idx: torch.Tensor) -> "Sampler":
        return Sampler(state=pcg32.seed_lanes(base_seed, lane_idx))

    def next_1d(self) -> Tuple[torch.Tensor, "Sampler"]:
        f, st = pcg32.next_float32(self.state)
        return f, Sampler(state=st)

    def next_2d(self):
        """Two uniforms as a planar (u, v) tuple."""
        f1, st = pcg32.next_float32(self.state)
        f2, st = pcg32.next_float32(st)
        return (f1, f2), Sampler(state=st)


def make_sampler(kind: str, seed: int, lane_idx: torch.Tensor) -> Sampler:
    """Factory over the sampler kinds this slice renders (independent)."""
    if kind != "independent":
        raise NotImplementedError(
            f"mitsuba2_tpu_torch does not support the {kind!r} sampler yet")
    return Sampler.seed(seed, lane_idx)
