"""2D sampling distributions (counterpart of core/distr.py): Marginal2D,
the envmap's importance table. The JAX package's 1D distributions and
Hierarchical2D are not ported yet.

`Marginal2D.build` makes the tables on the host exactly as the JAX
package makes them (the same f64 sums, the same Vose pop order, the same
f32 and int32 casts), so a table the port builds is byte-equal to the JAX
build's, and `Marginal2D.from_numpy` carries one across.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .vec import Vec2

ONE_MINUS_EPSILON = float(np.nextafter(np.float32(1.0), np.float32(0.0)))
# the tables, in the JAX package's Marginal2D field order
FIELDS = ("data", "marg_cdf", "cond_cdf", "total", "alias_p", "alias_i")


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
