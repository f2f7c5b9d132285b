"""Planar (struct-of-arrays) 2- and 3-vectors (counterpart of core/vec.py).

The layout is kept from the JAX package so that the port's tests compare
like with like: x, y and z are separate (N,) tensors.
"""
from __future__ import annotations

import dataclasses

import torch

from . import math as m


@dataclasses.dataclass
class Vec3:
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @staticmethod
    def zeros(n: int, device) -> "Vec3":
        z = torch.zeros(n, dtype=torch.float32, device=device)
        return Vec3(z, z, z)

    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)


@dataclasses.dataclass
class Vec2:
    x: torch.Tensor
    y: torch.Tensor


def vdot(a: Vec3, b: Vec3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def vsqnorm(v: Vec3):
    return v.x * v.x + v.y * v.y + v.z * v.z


def vnormalize(v: Vec3) -> Vec3:
    inv = m.safe_rsqrt(vsqnorm(v))
    return Vec3(v.x * inv, v.y * inv, v.z * inv)


def vwhere(mask, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y),
                torch.where(mask, a.z, b.z))


def vmax_abs(v: Vec3):
    return torch.maximum(torch.maximum(v.x.abs(), v.y.abs()), v.z.abs())
