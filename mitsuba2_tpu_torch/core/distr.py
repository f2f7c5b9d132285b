"""1D and 2D sampling distributions (counterpart of core/distr.py):
DiscreteDistribution, ContinuousDistribution and
IrregularContinuousDistribution (distr_1d.h), Marginal2D, the envmap's
importance table, and Hierarchical2D (distr_2d.h).

Each `build` makes its tables on the host exactly as the JAX package
makes them (the same f64 sums, the same Vose pop order, the same f32 and
int32 casts), so a table the port builds is byte-equal to the JAX
build's; `build_numpy` returns them as numpy and `from_numpy` carries
one across. Sampling is a per-lane search on the device: torch's
searchsorted with right=True picks, in a flat run of a CDF (zero
weights), the index jnp.searchsorted(side="right") picks, past the run,
so a zero-weight entry is never drawn.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import math as m
from .vec import Vec2

ONE_MINUS_EPSILON = float(np.nextafter(np.float32(1.0), np.float32(0.0)))
# the tables, in the JAX package's Marginal2D field order
FIELDS = ("data", "marg_cdf", "cond_cdf", "total", "alias_p", "alias_i")


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _inv(total: float) -> np.ndarray:
    return np.float32(1.0 / total if total > 0 else 0.0)


class _Tables:
    """A distribution's tables: torch tensors under the names of the JAX
    package's fields (`_fields`), built as numpy by `build_numpy`."""
    _fields: tuple = ()

    def __init__(self, **tables):
        for k in self._fields:
            setattr(self, k, tables[k])

    @classmethod
    def from_numpy(cls, tables: dict, device="cpu"):
        return cls(**{k: torch.from_numpy(np.array(tables[k], order="C"))
                      .to(device) for k in cls._fields})

    @classmethod
    def build(cls, *args, device="cpu"):
        return cls.from_numpy(cls.build_numpy(*args), device)

    def to(self, device):
        return type(self)(**{k: getattr(self, k).to(device)
                             for k in self._fields})


def _take(table, idx):
    return table[idx.long()]


def _lower_cdf(cdf, idx):
    """cdf[idx - 1], 0 at idx 0."""
    return torch.where(idx > 0, _take(cdf, torch.clamp_min(idx - 1, 0)), 0.0)


class DiscreteDistribution(_Tables):
    """A discrete distribution over n entries, sampled by CDF inversion."""
    _fields = ("pmf", "cdf", "total", "normalization")

    @staticmethod
    def build_numpy(weights) -> dict:
        w = np.asarray(weights, np.float64)
        cdf = np.cumsum(w)
        total = float(cdf[-1]) if w.size else 0.0
        return dict(pmf=_f32(w), cdf=_f32(cdf), total=np.float32(total),
                    normalization=_inv(total))

    def eval_pmf_normalized(self, index):
        return _take(self.pmf, index) * self.normalization

    def sample(self, u):
        """u in [0, 1) -> index (int64)."""
        idx = torch.searchsorted(self.cdf, u * self.total, right=True)
        return torch.clamp(idx, 0, self.pmf.shape[0] - 1)

    def sample_pmf(self, u):
        idx = self.sample(u)
        return idx, self.eval_pmf_normalized(idx)

    def sample_reuse(self, u):
        """An index, and u rescaled within its entry for reuse."""
        idx = self.sample(u)
        u_new = ((u * self.total - _lower_cdf(self.cdf, idx))
                 / torch.clamp_min(_take(self.pmf, idx), 1e-20))
        return idx, torch.clamp(u_new, 0.0, ONE_MINUS_EPSILON)


def _invert_linear(rem, v0, v1, width):
    """t in [0, 1] of 0.5 (v0 + v(t)) t width = rem, v(t) the linear
    interpolant of v0 and v1 (a piecewise-linear pdf's quadratic CDF)."""
    a = 0.5 * (v1 - v0) * width
    b = v0 * width
    valid, t0, t1 = m.solve_quadratic(a, b, -rem)
    t = torch.where((t0 >= 0) & (t0 <= 1), t0, t1)
    return torch.where(valid, torch.clamp(t, 0.0, 1.0),
                       rem / torch.clamp_min(b, 1e-20))


class ContinuousDistribution(_Tables):
    """A piecewise-linear pdf over [range_min, range_max] given by its
    values at n regularly spaced nodes."""
    _fields = ("pdf", "cdf", "range_min", "range_max", "interval_size",
               "total", "normalization")

    @staticmethod
    def build_numpy(values, range_min: float, range_max: float) -> dict:
        v = np.asarray(values, np.float64)
        dx = (range_max - range_min) / (v.size - 1)
        cdf = np.cumsum(0.5 * (v[1:] + v[:-1]) * dx)
        total = float(cdf[-1])
        return dict(pdf=_f32(v), cdf=_f32(cdf),
                    range_min=np.float32(range_min),
                    range_max=np.float32(range_max),
                    interval_size=np.float32(dx), total=np.float32(total),
                    normalization=_inv(total))

    def eval_pdf(self, x):
        t = (x - self.range_min) / self.interval_size
        idx = torch.clamp(torch.floor(t).to(torch.int64), 0,
                          self.pdf.shape[0] - 2)
        v0, v1 = _take(self.pdf, idx), _take(self.pdf, idx + 1)
        inside = (x >= self.range_min) & (x <= self.range_max)
        return torch.where(inside, v0 + (v1 - v0) * (t - idx), 0.0)

    def eval_pdf_normalized(self, x):
        return self.eval_pdf(x) * self.normalization

    def sample(self, u):
        """Inverts the piecewise-quadratic CDF: u -> x."""
        target = u * self.total
        idx = torch.clamp(torch.searchsorted(self.cdf, target, right=True),
                          0, self.cdf.shape[0] - 1)
        t = _invert_linear(target - _lower_cdf(self.cdf, idx),
                           _take(self.pdf, idx), _take(self.pdf, idx + 1),
                           self.interval_size)
        return self.range_min + (idx + t) * self.interval_size


class IrregularContinuousDistribution(_Tables):
    """A piecewise-linear pdf on irregularly spaced nodes."""
    _fields = ("nodes", "pdf", "cdf", "total", "normalization")

    @staticmethod
    def build_numpy(nodes, values) -> dict:
        x = np.asarray(nodes, np.float64)
        v = np.asarray(values, np.float64)
        cdf = np.cumsum(0.5 * (v[1:] + v[:-1]) * np.diff(x))
        total = float(cdf[-1])
        return dict(nodes=_f32(x), pdf=_f32(v), cdf=_f32(cdf),
                    total=np.float32(total), normalization=_inv(total))

    def eval_pdf(self, x):
        idx = m.find_interval(self.nodes, x)
        x0, x1 = _take(self.nodes, idx), _take(self.nodes, idx + 1)
        v0, v1 = _take(self.pdf, idx), _take(self.pdf, idx + 1)
        t = (x - x0) / torch.clamp_min(x1 - x0, 1e-20)
        inside = (x >= self.nodes[0]) & (x <= self.nodes[-1])
        return torch.where(inside, v0 + (v1 - v0) * t, 0.0)

    def sample(self, u):
        target = u * self.total
        idx = torch.clamp(torch.searchsorted(self.cdf, target, right=True),
                          0, self.cdf.shape[0] - 1)
        x0, x1 = _take(self.nodes, idx), _take(self.nodes, idx + 1)
        t = _invert_linear(target - _lower_cdf(self.cdf, idx),
                           _take(self.pdf, idx), _take(self.pdf, idx + 1),
                           x1 - x0)
        return x0 + t * (x1 - x0)


def _vose_tables(weights: np.ndarray):
    """Walker/Vose alias tables of a discrete pmf (host): (prob (n,),
    alias (n,)). Sample i0 ~ U{0..n-1}, keep it with probability
    prob[i0], else take alias[i0]. The pairing pops from the ends of the
    small and large worklists in the JAX package's order, which decides
    the tables."""
    w = np.asarray(weights, np.float64).ravel()
    n = w.size
    s = w.sum()
    assert n > 0 and s > 0, "alias table needs a non-empty positive pmf"
    scaled = w * (n / s)
    prob = np.ones(n)
    alias = np.arange(n, dtype=np.int64)
    small = list(np.nonzero(scaled < 1.0)[0])
    large = list(np.nonzero(scaled >= 1.0)[0])
    scaled = scaled.copy()
    while small and large:
        s_i = small.pop()
        l_i = large.pop()
        prob[s_i] = scaled[s_i]
        alias[s_i] = l_i
        scaled[l_i] = (scaled[l_i] + scaled[s_i]) - 1.0
        (small if scaled[l_i] < 1.0 else large).append(l_i)
    # float residue: the leftovers are ~1, always kept
    for i in small + large:
        prob[i] = 1.0
    return prob, alias


@dataclasses.dataclass
class Marginal2D:
    """A 2D density on an (h, w) grid over [0, 1]^2, piecewise constant
    over its cells (the pdf matches the sample exactly, which MIS needs),
    sampled through alias tables over the flattened cells when the build
    made them, else by inverting the row-marginal and per-row CDFs."""
    data: torch.Tensor       # (h, w) cell densities, un-normalized
    marg_cdf: torch.Tensor   # (h,) cumulative row sums
    cond_cdf: torch.Tensor   # (h, w) cumulative sums within each row
    total: torch.Tensor      # ()
    alias_p: Optional[torch.Tensor] = None   # (h*w,) acceptance
    alias_i: Optional[torch.Tensor] = None   # (h*w,) i32 alias targets

    @staticmethod
    def build_numpy(data, alias: bool = False) -> dict:
        """The host tables (FIELDS, alias ones None without `alias`) with
        the JAX package's dtypes."""
        d = np.asarray(data, np.float64)
        assert d.ndim == 2
        cond = np.cumsum(d, axis=1)
        marg = np.cumsum(cond[:, -1])
        out = dict(data=d.astype(np.float32), marg_cdf=marg.astype(np.float32),
                   cond_cdf=cond.astype(np.float32),
                   total=np.float32(marg[-1]), alias_p=None, alias_i=None)
        if alias:
            p, i = _vose_tables(d.ravel())
            out.update(alias_p=p.astype(np.float32),
                       alias_i=i.astype(np.int32))
        return out

    @staticmethod
    def from_numpy(tables: dict, device) -> "Marginal2D":
        return Marginal2D(**{
            k: None if tables.get(k) is None else torch.from_numpy(
                np.array(tables[k], order="C")).to(device)
            for k in FIELDS})

    @staticmethod
    def build(data, alias: bool = False, device="cpu") -> "Marginal2D":
        return Marginal2D.from_numpy(Marginal2D.build_numpy(data, alias),
                                     device)

    def to(self, device) -> "Marginal2D":
        return Marginal2D(**{k: None if getattr(self, k) is None
                             else getattr(self, k).to(device)
                             for k in FIELDS})

    def sample(self, u: Vec2):
        """u (planar, in [0, 1)^2) -> (position Vec2 in [0, 1]^2, pdf with
        respect to the unit square)."""
        h, w = self.data.shape
        total = torch.clamp_min(self.total, 1e-20)
        if self.alias_p is not None:
            n = h * w
            z = torch.clamp_max(u.x, ONE_MINUS_EPSILON) * n
            # clamped: at n not a power of two z may round up to n, where
            # the JAX package's jnp.take would fill NaN
            i0 = torch.clamp_max(z.to(torch.int64), n - 1)
            frac = z - i0
            p = self.alias_p[i0]
            take = frac < p
            idx = torch.where(take, i0, self.alias_i[i0].to(torch.int64))
            # the residual is uniform in [0, p) or [p, 1): rescaled into
            # the cell's x (Vose's entropy reuse)
            uc = torch.where(take, frac / torch.clamp_min(p, 1e-20),
                             (frac - p) / torch.clamp_min(1.0 - p, 1e-20))
            uc = torch.clamp(uc, 0.0, ONE_MINUS_EPSILON)
            row = idx // w
            col = idx - row * w
            ur = torch.clamp(u.y, 0.0, ONE_MINUS_EPSILON)
            pos = Vec2((col + uc) / w, (row + ur) / h)
            pdf = self.data.reshape(-1)[idx] * (h * w) / total
            return pos, pdf
        flat_cond = self.cond_cdf.reshape(-1)
        # the row from the marginal
        target_r = u.y * self.total
        row = torch.clamp(torch.searchsorted(self.marg_cdf, target_r,
                                             right=True), 0, h - 1)
        marg_lo = torch.where(row > 0,
                              self.marg_cdf[torch.clamp_min(row - 1, 0)], 0.0)
        row_sum = self.marg_cdf[row] - marg_lo
        ur = torch.clamp((target_r - marg_lo) / torch.clamp_min(row_sum, 1e-20),
                         0.0, ONE_MINUS_EPSILON)
        # the column: a lower-bound bisection in cond_cdf[row, :]
        target_c = u.x * row_sum
        base = row * w
        lo = torch.zeros_like(row)
        hi = torch.full_like(row, w)
        for _ in range(int(np.ceil(np.log2(max(w, 2)))) + 1):
            mid = (lo + hi) // 2
            go_right = flat_cond[base + torch.clamp_max(mid, w - 1)] < target_c
            lo = torch.where(go_right, mid + 1, lo)
            hi = torch.where(go_right, hi, mid)
        col = torch.clamp(lo, 0, w - 1)
        cond_lo = torch.where(
            col > 0, flat_cond[base + torch.clamp_min(col - 1, 0)], 0.0)
        cell = flat_cond[base + col] - cond_lo
        uc = torch.clamp((target_c - cond_lo) / torch.clamp_min(cell, 1e-20),
                         0.0, ONE_MINUS_EPSILON)
        pos = Vec2((col + uc) / w, (row + ur) / h)
        pdf = cell * (h * w) / total
        return pos, pdf

    def eval_pdf(self, pos: Vec2):
        """The pdf at pos in [0, 1]^2 with respect to the unit square."""
        h, w = self.data.shape
        col = torch.clamp((pos.x * w).to(torch.int64), 0, w - 1)
        row = torch.clamp((pos.y * h).to(torch.int64), 0, h - 1)
        val = self.data.reshape(-1)[row * w + col]
        return val * (h * w) / torch.clamp_min(self.total, 1e-20)


def _searchsorted_rows(cdf_rows, targets):
    """searchsorted along the last axis of batched rows: cdf_rows (..., w)
    ascending, targets (...,) -> int64 (...,), the count of entries
    below the target."""
    return (cdf_rows < targets[..., None]).sum(-1)


class Hierarchical2D:
    """Hierarchical sample warping over a 2D density (distr_2d.h ::
    Hierarchical2D0): a mip pyramid of the density, descended a level a
    step, the sample picking one of the four children of its texel in
    proportion to their sums and reused (a continuous warp), then a
    uniform jitter inside the finest texel. The same distribution as
    Marginal2D with a locality-preserving u -> position map."""

    def __init__(self, levels, data, total, res: int, h: int, w: int):
        self.levels = tuple(levels)   # flattened (4^k,) sums, coarse first
        self.data = data              # (h, w) the density (pdf eval)
        self.total = total            # ()
        self.res, self.h, self.w = res, h, w

    @staticmethod
    def build_numpy(data) -> dict:
        d = np.asarray(data, np.float64)
        assert d.ndim == 2
        h, w = d.shape
        res = 1
        while res < max(h, w):
            res *= 2
        padded = np.zeros((res, res), np.float64)
        padded[:h, :w] = d
        levels = [padded]
        while levels[-1].shape[0] > 1:
            p = levels[-1]
            levels.append(p[0::2, 0::2] + p[0::2, 1::2] +
                          p[1::2, 0::2] + p[1::2, 1::2])
        return dict(levels=tuple(_f32(l.reshape(-1))
                                 for l in reversed(levels)),
                    data=_f32(d), total=np.float32(d.sum()),
                    res=res, h=h, w=w)

    @staticmethod
    def from_numpy(tables: dict, device="cpu") -> "Hierarchical2D":
        def t(a):
            return torch.from_numpy(np.array(a, order="C")).to(device)
        return Hierarchical2D([t(l) for l in tables["levels"]],
                              t(tables["data"]), t(tables["total"]),
                              int(tables["res"]), int(tables["h"]),
                              int(tables["w"]))

    @staticmethod
    def build(data, device="cpu") -> "Hierarchical2D":
        return Hierarchical2D.from_numpy(Hierarchical2D.build_numpy(data),
                                         device)

    def sample(self, u: Vec2):
        """u -> (position Vec2 in [0, 1]^2, pdf with respect to the unit
        square over the (h, w) domain)."""
        ux, uy = u.x, u.y
        row = torch.zeros(ux.shape, dtype=torch.int64, device=ux.device)
        col = torch.zeros_like(row)
        # levels[k] has 2^k texels a side; the children of (row, col) are
        # (2 row + dy, 2 col + dx) of levels[k + 1]
        for k in range(len(self.levels) - 1):
            child = self.levels[k + 1]
            size = 1 << (k + 1)
            base_r, base_c = row * 2, col * 2
            v00 = child[base_r * size + base_c]
            v01 = child[base_r * size + base_c + 1]
            v10 = child[(base_r + 1) * size + base_c]
            v11 = child[(base_r + 1) * size + base_c + 1]
            top = v00 + v01
            bottom = v10 + v11
            tot = torch.clamp_min(top + bottom, 1e-30)
            # split vertically, the sample reused (distr_2d.h)
            p_top = top / tot
            go_bottom = uy >= p_top
            uy = torch.where(go_bottom,
                             (uy - p_top) / torch.clamp_min(1.0 - p_top, 1e-20),
                             uy / torch.clamp_min(p_top, 1e-20))
            left = torch.where(go_bottom, v10, v00)
            lr_tot = torch.clamp_min(torch.where(go_bottom, bottom, top), 1e-30)
            p_left = left / lr_tot
            go_right = ux >= p_left
            ux = torch.where(go_right,
                             (ux - p_left) / torch.clamp_min(1.0 - p_left, 1e-20),
                             ux / torch.clamp_min(p_left, 1e-20))
            row = base_r + go_bottom.to(torch.int64)
            col = base_c + go_right.to(torch.int64)
        ux = torch.clamp(ux, 0.0, ONE_MINUS_EPSILON)
        uy = torch.clamp(uy, 0.0, ONE_MINUS_EPSILON)
        # over the padded res, rescaled to the (h, w) box
        pos = Vec2((col + ux) * (self.res / self.w) / self.res,
                   (row + uy) * (self.res / self.h) / self.res)
        return pos, self.eval_pdf(pos)

    def eval_pdf(self, pos: Vec2):
        col = torch.clamp((pos.x * self.w).to(torch.int64), 0, self.w - 1)
        row = torch.clamp((pos.y * self.h).to(torch.int64), 0, self.h - 1)
        val = self.data.reshape(-1)[row * self.w + col]
        return val * (self.h * self.w) / torch.clamp_min(self.total, 1e-20)
