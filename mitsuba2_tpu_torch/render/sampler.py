"""Wavefront samplers (counterpart of render/sampler.py).

- `independent`: one PCG32 stream per lane, seeded from (base_seed, lane
  index) through a TEA hash.
- `stratified`: dimension d of pixel p takes stratum (spp_index +
  shift(p, d)) mod spp, jittered within it from a second PCG32 stream
  (seeded from seed ^ 0xC0FFEE11).
- `ldsampler` (alias `halton`): the Halton radical inverse of the sample
  index in PRIMES[d % 16], Cranley-Patterson rotated per (pixel,
  dimension, seed); its multiply-adds rounded as the JAX package's
  compiled draw rounds them (core/qmc.py).

All keep the `next_1d` / `next_2d` protocol the integrators thread, and
each draw is bit-equal to the JAX package's. uint32 values live in int64
tensors, and every product goes through pcg32.mullo32's 16-bit partials,
so nothing overflows. The dimension counter is a host integer: the
bounce loop is a Python loop, so the Halton base is a Python branch.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..core import pcg32, qmc
from ..core.pcg32 import M32, mullo32

_GOLDEN = 0x9E3779B9
_LD_PRIMES = qmc.PRIMES[:16]


def _u32_mul(a, b: int):
    """a * b mod 2^32, for a an int64 tensor of uint32 values or an int."""
    if torch.is_tensor(a):
        return mullo32(a, b)
    return (int(a) * b) & M32


def _hash3(a, b, c):
    """Cheap uint32 mix (Wang-style) of three values, each an int64 tensor
    of uint32 values or a host integer."""
    h = ((a ^ _u32_mul(b, _GOLDEN)) + _u32_mul(c, 0x85EBCA6B)) & M32
    h = h ^ (h >> 16)
    h = _u32_mul(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _u32_mul(h, 0x846CA68B)
    return h ^ (h >> 16)


@dataclasses.dataclass
class Sampler:
    """`independent` (PCG32 per lane)."""
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


@dataclasses.dataclass
class StratifiedSampler:
    """Per-(pixel, dimension) stratified jittered sampling."""
    rng: pcg32.PCG32State   # the jitter stream, one a lane
    pix: torch.Tensor       # (N,) pixel id
    sidx: torch.Tensor      # (N,) stratum (the sample's place in the pass)
    dim: int                # dimension counter
    seed: int
    spp: int = 1

    def _draw(self, rng_state, dim: int):
        jit_, st = pcg32.next_float32(rng_state)
        shift = _hash3(self.pix, dim, self.seed) % self.spp
        stratum = (self.sidx + shift) % self.spp
        v = (stratum.to(torch.float32) + jit_) * float(
            np.float32(1.0 / self.spp))
        return torch.clamp_max(v, qmc.ONE_MINUS_EPS), st

    def next_1d(self):
        v, st = self._draw(self.rng, self.dim)
        return v, dataclasses.replace(self, rng=st, dim=self.dim + 1)

    def next_2d(self):
        v1, st = self._draw(self.rng, self.dim)
        v2, st2 = self._draw(st, self.dim + 1)
        return (v1, v2), dataclasses.replace(self, rng=st2, dim=self.dim + 2)


@dataclasses.dataclass
class LDSampler:
    """Halton low-discrepancy sampler with Cranley-Patterson rotation."""
    pix: torch.Tensor       # (N,) pixel id
    sidx: torch.Tensor      # (N,) sample index within the pass
    dim: int                # dimension counter
    seed: int

    def _draw(self, dim: int):
        h = qmc.radical_inverse(self.sidx, _LD_PRIMES[dim % 16], fused=True)
        rot = (_hash3(self.pix, dim, self.seed).to(torch.float32)
               * qmc.INV_2_32)
        v = h + rot
        return torch.where(v >= 1.0, v - 1.0, v)

    def next_1d(self):
        return self._draw(self.dim), dataclasses.replace(self,
                                                         dim=self.dim + 1)

    def next_2d(self):
        return ((self._draw(self.dim), self._draw(self.dim + 1)),
                dataclasses.replace(self, dim=self.dim + 2))


def make_sampler(kind: str, seed: int, lane_idx: torch.Tensor,
                 n_pixels: int = 1, spp: int = 1):
    """Factory: the lanes are laid out (spp, pixels), flattened."""
    seed = int(seed) & M32
    if kind == "independent":
        return Sampler.seed(seed, lane_idx)
    lane_idx = lane_idx & M32
    pix = lane_idx % n_pixels
    sidx = lane_idx // n_pixels
    if kind == "stratified":
        # a jitter stream decorrelated from the independent sampler's
        rng = pcg32.seed_lanes(seed ^ 0xC0FFEE11, lane_idx)
        return StratifiedSampler(rng=rng, pix=pix, sidx=sidx, dim=0,
                                 seed=seed, spp=spp)
    if kind in ("ldsampler", "halton"):
        return LDSampler(pix=pix, sidx=sidx, dim=0, seed=seed)
    raise ValueError(f"unknown sampler {kind!r}")
