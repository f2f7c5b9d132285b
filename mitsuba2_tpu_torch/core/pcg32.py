"""Bit-exact PCG32 RNG + TEA hash (counterpart of core/pcg32.py).

The 64-bit LCG state is held as (hi, lo) pairs of 32-bit values, as in
the JAX package, but stored in int64 tensors: torch's uint32 has thin
operator coverage. Every product is built from 16-bit partials so that no
intermediate leaves [0, 2^49): nothing overflows int64, and a mask to 32
bits after each step gives the uint32 arithmetic exactly. The streams
are bit-equal to the JAX package's (tests/test_torch_rng.py).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

M32 = 0xFFFFFFFF
M16 = 0xFFFF

PCG32_MULT_HI = 0x5851F42D
PCG32_MULT_LO = 0x4C957F2D


def mulhi32(a, b):
    """High 32 bits of the 32x32 -> 64 product."""
    a_lo, a_hi = a & M16, a >> 16
    b_lo, b_hi = b & M16, b >> 16
    lo = a_lo * b_lo
    m1 = a_hi * b_lo + (lo >> 16)
    m2 = a_lo * b_hi + (m1 & M16)
    return (a_hi * b_hi + (m1 >> 16) + (m2 >> 16)) & M32


def mullo32(a, b):
    """Low 32 bits of the 32x32 product."""
    a_lo, a_hi = a & M16, a >> 16
    b_lo = b & M16
    b_hi = b >> 16
    return (a_lo * b_lo + (((a_hi * b_lo + a_lo * b_hi) & M16) << 16)) & M32


def add64(ah, al, bh, bl):
    lo = al + bl
    return (ah + bh + (lo >> 32)) & M32, lo & M32


def mul64(ah, al, bh, bl):
    lo = mullo32(al, bl)
    hi = (mulhi32(al, bl) + mullo32(ah, bl) + mullo32(al, bh)) & M32
    return hi, lo


class PCG32State(NamedTuple):
    """SoA PCG32 state: four int64 tensors holding uint32 values."""
    state_hi: torch.Tensor
    state_lo: torch.Tensor
    inc_hi: torch.Tensor
    inc_lo: torch.Tensor


def _step(s: PCG32State) -> PCG32State:
    h, l = mul64(s.state_hi, s.state_lo, PCG32_MULT_HI, PCG32_MULT_LO)
    h, l = add64(h, l, s.inc_hi, s.inc_lo)
    return PCG32State(h, l, s.inc_hi, s.inc_lo)


def _output(state_hi, state_lo):
    x_hi = (state_hi >> 18) ^ state_hi
    x_lo = ((state_lo >> 18) | ((state_hi << 14) & M32)) ^ state_lo
    xorshifted = ((x_lo >> 27) | ((x_hi << 5) & M32)) & M32
    rot = state_hi >> 27
    return ((xorshifted >> rot) | ((xorshifted << ((32 - rot) & 31)) & M32))


def _u32(x, like=None):
    if torch.is_tensor(x):
        return x.to(torch.int64) & M32
    return torch.full_like(like, int(x) & M32)


def seed(initstate_hi, initstate_lo, initseq_hi, initseq_lo) -> PCG32State:
    """PCG32::seed on int64 tensors of uint32 values."""
    initstate_hi, initstate_lo = _u32(initstate_hi), _u32(initstate_lo)
    initseq_hi, initseq_lo = _u32(initseq_hi), _u32(initseq_lo)
    inc_hi = ((initseq_hi << 1) & M32) | (initseq_lo >> 31)
    inc_lo = ((initseq_lo << 1) & M32) | 1
    zero = torch.zeros_like(initstate_hi)
    s = _step(PCG32State(zero, zero, inc_hi, inc_lo))
    h, l = add64(s.state_hi, s.state_lo, initstate_hi, initstate_lo)
    return _step(PCG32State(h, l, inc_hi, inc_lo))


def next_uint32(s: PCG32State) -> Tuple[torch.Tensor, PCG32State]:
    """Output from the OLD state, then advance."""
    return _output(s.state_hi, s.state_lo), _step(s)


def next_float32(s: PCG32State) -> Tuple[torch.Tensor, PCG32State]:
    """Uniform float in [0, 1) with 23 random mantissa bits."""
    bits, s = next_uint32(s)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0, s


def sample_tea_32(v0, v1, rounds: int = 4):
    """TEA block cipher as a hash; returns the mixed (v0, v1) pair."""
    s = 0
    for _ in range(rounds):
        s = (s + 0x9E3779B9) & M32
        v0 = (v0 + ((((v1 << 4) + 0xA341316C) ^ (v1 + s)
                     ^ ((v1 >> 5) + 0xC8013EA4)) & M32)) & M32
        v1 = (v1 + ((((v0 << 4) + 0xAD90777D) ^ (v0 + s)
                     ^ ((v0 >> 5) + 0x7E95761E)) & M32)) & M32
    return v0, v1


def seed_lanes(base_seed: int, lane_idx: torch.Tensor) -> PCG32State:
    """One decorrelated stream per lane (independent.cpp seeding)."""
    lane_idx = _u32(lane_idx)
    a, b = sample_tea_32(_u32(base_seed, lane_idx), lane_idx)
    return seed(b, a, torch.zeros_like(lane_idx), lane_idx)
