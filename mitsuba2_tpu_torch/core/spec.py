"""Planar colors (counterpart of core/spec.py): C separate (N,) channels."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


def _coerce(o, n):
    if isinstance(o, Spec):
        if len(o.ch) == n:
            return o.ch
        if len(o.ch) == 1:
            return (o.ch[0],) * n
        raise ValueError(f"channel mismatch: {len(o.ch)} vs {n}")
    return (o,) * n


@dataclasses.dataclass
class Spec:
    ch: Tuple[torch.Tensor, ...]

    @staticmethod
    def zeros(n: int, c: int, device) -> "Spec":
        z = torch.zeros(n, dtype=torch.float32, device=device)
        return Spec((z,) * c)

    @staticmethod
    def ones(n: int, c: int, device) -> "Spec":
        o = torch.ones(n, dtype=torch.float32, device=device)
        return Spec((o,) * c)

    @property
    def n(self) -> int:
        return len(self.ch)

    def __add__(self, o):
        return Spec(tuple(a + b for a, b in zip(self.ch, _coerce(o, self.n))))

    __radd__ = __add__

    def __sub__(self, o):
        return Spec(tuple(a - b for a, b in zip(self.ch, _coerce(o, self.n))))

    def __rsub__(self, o):
        return Spec(tuple(b - a for a, b in zip(self.ch, _coerce(o, self.n))))

    def __mul__(self, o):
        return Spec(tuple(a * b for a, b in zip(self.ch, _coerce(o, self.n))))

    __rmul__ = __mul__

    def __truediv__(self, o):
        return Spec(tuple(a / b for a, b in zip(self.ch, _coerce(o, self.n))))

    def hmax(self):
        out = self.ch[0]
        for c in self.ch[1:]:
            out = torch.maximum(out, c)
        return out

    def hsum(self):
        out = self.ch[0]
        for c in self.ch[1:]:
            out = out + c
        return out

    def hmean(self):
        return self.hsum() * (1.0 / len(self.ch))

    def any_positive(self):
        out = self.ch[0] > 0
        for c in self.ch[1:]:
            out = out | (c > 0)
        return out

    def masked(self, mask) -> "Spec":
        """Zero the lanes where `mask` is False."""
        return Spec(tuple(torch.where(mask, c, 0.0) for c in self.ch))


def swhere(mask, a, b) -> Spec:
    """Lane select between two Specs (a scalar broadcasts)."""
    n = a.n if isinstance(a, Spec) else b.n
    out = []
    for x, y in zip(_coerce(a, n), _coerce(b, n)):
        if not torch.is_tensor(x):
            x = torch.full_like(y, float(x))
        out.append(torch.where(mask, x, y))
    return Spec(tuple(out))


def slerp(a: Spec, b: Spec, t) -> Spec:
    """The linear blend a + (b - a) t."""
    return a + (b - a) * t
