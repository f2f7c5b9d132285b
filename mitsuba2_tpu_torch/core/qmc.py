"""Quasi-Monte-Carlo helpers: radical inverse and Halton points
(counterpart of core/qmc.py; mitsuba2's src/libcore/qmc.cpp).

uint32 values are held in int64 tensors, as in core/pcg32.py: the digit
loop's `i % base` and `i // base` act on values in [0, 2^32), so they are
the unsigned operations. The f32 accumulation keeps the JAX package's
operation order, `result + digit * scale`, and its clamp below 1.

Where the JAX package compiles the digit loop (its ld sampler draws
through lax.switch, always compiled), XLA:CPU contracts the chain of
multiply-adds into FMAs: the first two digits as fma(d0, s0, d1 * s1),
each later one as fma(dk, sk, result). `radical_inverse(..., fused=True)`
rounds the same way (fma_f32), so that the port's ld draws are the JAX
package's bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from .pcg32 import M32

PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53,
          59, 61, 67, 71, 73, 79, 83, 89, 97, 101)

INV_2_32 = float(np.float32(2.3283064365386963e-10))
ONE_MINUS_EPS = float(np.float32(1.0 - 1e-7))


def radical_inverse_base2(i: torch.Tensor) -> torch.Tensor:
    """Van der Corput: the 32 bits of i reversed, as a float in [0, 1)."""
    i = i & M32
    i = ((i & 0x55555555) << 1) | ((i >> 1) & 0x55555555)
    i = ((i & 0x33333333) << 2) | ((i >> 2) & 0x33333333)
    i = ((i & 0x0F0F0F0F) << 4) | ((i >> 4) & 0x0F0F0F0F)
    i = ((i & 0x00FF00FF) << 8) | ((i >> 8) & 0x00FF00FF)
    i = ((i << 16) & M32) | (i >> 16)
    return i.to(torch.float32) * INV_2_32


def fma_f32(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to float32, for float32 a and c and a
    float32 value b with a * b exact in float64 (|a| < 2^29). The sum is
    rounded to odd in float64 (TwoSum's error decides the last bit), from
    which the rounding to float32 is the correctly rounded one."""
    p = a.double() * b
    c = c.double()
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.nextafter(s, torch.where(err > 0, torch.inf, -torch.inf))
    return torch.where((err != 0) & even, away, s).float()


def radical_inverse(i: torch.Tensor, base: int,
                    fused: bool = False) -> torch.Tensor:
    """Radical inverse of i (int64 tensor of uint32 values) in `base`;
    `fused`: the multiply-adds rounded as XLA:CPU's compiled loop rounds
    them (the module's note)."""
    if base == 2:
        return radical_inverse_base2(i)
    i = i & M32
    n_digits = int(np.ceil(32 * np.log(2) / np.log(base))) + 1
    inv_base = np.float32(1.0 / base)
    scale = np.float32(1.0)
    result = first = None
    for k in range(n_digits):
        digit = (i % base).to(torch.float32)
        scale = np.float32(scale * inv_base)
        i = i // base
        if not fused:
            result = digit * float(scale) if k == 0 else \
                result + digit * float(scale)
        elif k == 0:
            first = (digit, float(scale))
        elif k == 1:
            result = fma_f32(*first, digit * float(scale))
        else:
            result = fma_f32(digit, float(scale), result)
    return torch.clamp_max(result, ONE_MINUS_EPS)


def halton(i: torch.Tensor, dim: int) -> torch.Tensor:
    """The dim-th Halton coordinate of sample i (dim < len(PRIMES))."""
    return radical_inverse(i, PRIMES[dim])


def halton_points(n: int, dims: int, device=None) -> torch.Tensor:
    """(n, dims) Halton point set on `device` (None = the CUDA device;
    raises without one)."""
    from ..device import resolve_device
    i = torch.arange(n, dtype=torch.int64, device=resolve_device(device))
    return torch.stack([halton(i, d) for d in range(dims)], -1)
