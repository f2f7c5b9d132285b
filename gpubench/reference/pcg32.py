"""PCG32 and the TEA hash in plain PyTorch, for the reference.

The independent sampler draws one PCG32 stream a lane, seeded from a
TEA hash of (pass seed, lane index), as Mitsuba 2's independent sampler
does; the reference draws the same numbers as the program so that both
trace the same paths. A 64-bit state is a (hi, lo) pair of int64
tensors holding 32-bit words; every product is built from 16-bit halves,
so no intermediate leaves int64.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
M16 = 0xFFFF
MULT_HI, MULT_LO = 0x5851F42D, 0x4C957F2D


def _mul32(a, b):
    """The 64-bit product of two 32-bit words, as (hi, lo) words."""
    a0, a1 = a & M16, a >> 16
    b0, b1 = b & M16, b >> 16
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = (p00 >> 16) + (p01 & M16) + (p10 & M16)
    lo = ((mid & M16) << 16) | (p00 & M16)
    hi = (p11 + (p01 >> 16) + (p10 >> 16) + (mid >> 16)) & M32
    return hi, lo


def _mul64(ah, al, bh, bl):
    """(a * b) mod 2^64 on (hi, lo) words."""
    hi, lo = _mul32(al, bl)
    hi = (hi + _mul32(ah, bl)[1] + _mul32(al, bh)[1]) & M32
    return hi, lo


def _add64(ah, al, bh, bl):
    lo = al + bl
    return (ah + bh + (lo >> 32)) & M32, lo & M32


class PCG32:
    """One stream a lane: state and increment as (hi, lo) word pairs."""

    def __init__(self, sh, sl, ih, il):
        self.sh, self.sl, self.ih, self.il = sh, sl, ih, il

    def _step(self):
        h, l = _mul64(self.sh, self.sl, MULT_HI, MULT_LO)
        self.sh, self.sl = _add64(h, l, self.ih, self.il)

    @staticmethod
    def seed(state_hi, state_lo, seq_hi, seq_lo) -> "PCG32":
        """pcg32::seed(initstate, initseq)."""
        ih = ((seq_hi << 1) & M32) | (seq_lo >> 31)
        il = ((seq_lo << 1) & M32) | 1
        zero = torch.zeros_like(state_lo)
        rng = PCG32(zero, zero, ih, il)
        rng._step()
        rng.sh, rng.sl = _add64(rng.sh, rng.sl, state_hi, state_lo)
        rng._step()
        return rng

    def next_uint32(self):
        hi, lo = self.sh, self.sl
        x_hi = (hi >> 18) ^ hi
        x_lo = ((lo >> 18) | ((hi << 14) & M32)) ^ lo
        xs = ((x_lo >> 27) | ((x_hi << 5) & M32)) & M32
        rot = hi >> 27
        self._step()
        return (xs >> rot) | ((xs << ((32 - rot) & 31)) & M32)

    def next_float(self):
        """A uniform float32 in [0, 1) from 23 random mantissa bits."""
        bits = self.next_uint32()
        f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
        return f - 1.0


def tea(v0, v1, rounds: int = 4):
    """The TEA block cipher as a hash of two 32-bit words."""
    s = 0
    for _ in range(rounds):
        s = (s + 0x9E3779B9) & M32
        v0 = (v0 + ((((v1 << 4) + 0xA341316C) ^ (v1 + s)
                     ^ ((v1 >> 5) + 0xC8013EA4)) & M32)) & M32
        v1 = (v1 + ((((v0 << 4) + 0xAD90777D) ^ (v0 + s)
                     ^ ((v0 >> 5) + 0x7E95761E)) & M32)) & M32
    return v0, v1


def independent(pass_seed: int, lane: torch.Tensor) -> PCG32:
    """The independent sampler's stream of each lane: state seeded with
    the 64-bit TEA hash of (pass seed, lane), sequence the lane index."""
    lane = lane.to(torch.int64) & M32
    a, b = tea(torch.full_like(lane, int(pass_seed) & M32), lane)
    return PCG32.seed(b, a, torch.zeros_like(lane), lane)


def pass_seed(seed: int, p: int = 0) -> int:
    """The seed of pass p of a render seeded `seed`."""
    return ((int(seed) & M32) * 0x9E3779B1 + p) & M32
