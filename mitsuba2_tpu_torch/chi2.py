"""Chi-square goodness-of-fit harness for sampling routines (counterpart of
mitsuba2_tpu/chi2.py, itself mitsuba's src/python/python/chi2.py).

Draw ~1e6 samples from a sampling routine, histogram them over a
discretized domain, integrate the claimed pdf over each bin, and compare
the two with Pearson's chi^2 test. The bookkeeping is numpy; the routine
under test takes and returns torch tensors (the port's planar Vec3, or
an (N, k) tensor), on the CPU. `lobe_test` does the same for the
discrete choice among a delta BSDF's lobes.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch


def rlgamma(a: float, x: float) -> float:
    """Regularized lower incomplete gamma P(a, x) (mitsuba's math_py.py):
    the series for x < a + 1, Lentz's continued fraction otherwise."""
    if x < 0 or a <= 0:
        raise ValueError("rlgamma: invalid arguments")
    if x == 0:
        return 0.0
    lg = math.lgamma(a)
    if x < a + 1.0:
        term = 1.0 / a
        s, n = term, a
        for _ in range(1000):
            n += 1.0
            term *= x / n
            s += term
            if abs(term) < abs(s) * 1e-15:
                break
        return math.exp(-x + a * math.log(x) - lg) * s
    tiny = 1e-300
    b = x + 1.0 - a
    c = 1.0 / tiny
    d = 1.0 / b
    h = d
    for i in range(1, 1000):
        an = -i * (i - a)
        b += 2.0
        d = an * d + b
        if abs(d) < tiny:
            d = tiny
        c = b + an / c
        if abs(c) < tiny:
            c = tiny
        d = 1.0 / d
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < 1e-15:
            break
    return 1.0 - math.exp(-x + a * math.log(x) - lg) * h


def pearson(obs: np.ndarray, exp: np.ndarray, significance_level=0.01,
            test_count=1):
    """Pearson's test of observed against expected counts, the cells with
    the lowest expectations pooled until they hold 5 (mitsuba's rule):
    (passed, message, p value)."""
    order = np.argsort(exp)
    exp_s, obs_s = exp[order], obs[order]
    n_pooled = int((np.cumsum(exp_s) < 5.0).sum())
    if n_pooled > 0:
        exp_s = np.concatenate([[exp_s[:n_pooled].sum()], exp_s[n_pooled:]])
        obs_s = np.concatenate([[obs_s[:n_pooled].sum()], obs_s[n_pooled:]])
    mask = exp_s > 0
    stat = float((((obs_s - exp_s) ** 2) / np.maximum(exp_s, 1e-9))[mask].sum())
    dof = int(mask.sum()) - 1
    if dof <= 0:
        return False, "chi2: no degrees of freedom", None
    p_value = 1.0 - rlgamma(dof / 2.0, stat / 2.0)
    # Sidak's correction for `test_count` independent tests
    alpha = 1.0 - (1.0 - significance_level) ** (1.0 / test_count)
    ok = p_value >= alpha
    return ok, (f"chi2: stat={stat:.2f} dof={dof} p={p_value:.4g} "
                f"alpha={alpha:.4g} {'PASS' if ok else 'FAIL'}"), p_value


class SphericalDomain:
    """Directions on S^2 as (phi, cos_theta): equal-area bins."""

    def bounds(self):
        return np.array([[-np.pi, np.pi], [-1.0, 1.0]])

    def map_forward(self, d):
        d = np.asarray(d)
        return np.stack([np.arctan2(d[..., 1], d[..., 0]),
                         np.clip(d[..., 2], -1.0, 1.0)], axis=-1)

    def map_backward(self, p):
        phi, ct = p[..., 0], p[..., 1]
        st = np.sqrt(np.maximum(1.0 - ct * ct, 0.0))
        return np.stack([st * np.cos(phi), st * np.sin(phi), ct], axis=-1)

    def measure_factor(self, p):
        # solid angle per unit (phi, cos_theta) is 1
        return np.ones(p.shape[:-1])


def _to_numpy(pts) -> np.ndarray:
    """A routine's points (a planar Vec3, a tuple of (N,) tensors or an
    (N, k) tensor) -> (N, k) numpy."""
    if hasattr(pts, "x"):
        pts = torch.stack([pts.x, pts.y, pts.z], -1)
    elif isinstance(pts, (tuple, list)):
        pts = torch.stack(list(pts), -1)
    return pts.detach().cpu().numpy()


class ChiSquareTest:
    """Pearson's chi^2 between a sampler and its claimed pdf, with the
    reference harness' parameters: `sample_func(u) -> points` ((N, 3) on
    the sphere), `pdf_func(points) -> density` in the domain's measure,
    `sample_count` draws from a numpy generator of `seed`, a res x 2 res
    grid of bins and ires^2 midpoints a bin for the expected counts. A
    draw the routine rejects (a zero direction) counts toward the total
    and no bin: its mass is what the pdf integrates to below 1."""

    def __init__(self, domain, sample_func: Callable, pdf_func: Callable,
                 sample_count: int = 1_000_000, res: int = 33, ires: int = 8,
                 seed: int = 0, sample_dim: int = 2):
        self.domain = domain
        self.sample_func = sample_func
        self.pdf_func = pdf_func
        self.sample_count = int(sample_count)
        self.res = (res, 2 * res)  # (cos_theta bins, phi bins)
        self.ires = ires
        self.seed = seed
        self.sample_dim = sample_dim
        self.messages = []
        self.histogram = None
        self.pdf = None
        self.p_value = None

    def tabulate_histogram(self):
        rng = np.random.default_rng(self.seed)
        u = rng.random((self.sample_count, self.sample_dim),
                       dtype=np.float64).astype(np.float32)
        pts = _to_numpy(self.sample_func(torch.from_numpy(u)))
        p = self.domain.map_forward(pts)
        b = self.domain.bounds()
        valid = np.isfinite(p).all(axis=-1)
        if pts.shape[-1] == 3:
            valid &= np.abs(np.linalg.norm(pts, axis=-1) - 1.0) < 1e-2
        p = p[valid]
        self.valid_frac = valid.mean()
        self.histogram = np.histogram2d(
            p[..., 1], p[..., 0], bins=self.res,
            range=[[b[1, 0], b[1, 1]], [b[0, 0], b[0, 1]]])[0]

    def tabulate_pdf(self):
        b = self.domain.bounds()
        ny, nx = self.res
        ir = self.ires
        ys = np.linspace(b[1, 0], b[1, 1], ny * ir + 1)
        xs = np.linspace(b[0, 0], b[0, 1], nx * ir + 1)
        X, Y = np.meshgrid(0.5 * (xs[1:] + xs[:-1]), 0.5 * (ys[1:] + ys[:-1]))
        P = np.stack([X, Y], axis=-1)
        pts = torch.from_numpy(self.domain.map_backward(P).astype(np.float32))
        dens = self.pdf_func(pts).detach().cpu().numpy().astype(np.float64)
        dens = dens * self.domain.measure_factor(P)
        cell = (((b[0, 1] - b[0, 0]) / (nx * ir))
                * ((b[1, 1] - b[1, 0]) / (ny * ir)))
        dens = dens.reshape(ny, ir, nx, ir).sum(axis=(1, 3)) * cell
        self.pdf = dens * self.sample_count

    def run(self, significance_level: float = 0.01,
            test_count: int = 1) -> bool:
        if self.histogram is None:
            self.tabulate_histogram()
        if self.pdf is None:
            self.tabulate_pdf()
        obs, exp = self.histogram.ravel(), self.pdf.ravel()
        total_exp, total_obs = exp.sum(), obs.sum()
        if total_exp <= 0:
            self.messages.append("chi2: expected distribution integrates "
                                 "to zero")
            return False
        if abs(total_exp - total_obs) / max(total_obs, 1) > 0.02:
            self.messages.append(
                f"chi2: sample count mismatch: observed {total_obs}, "
                f"expected {total_exp:.1f}: pdf likely not normalized "
                "consistently")
            return False
        ok, msg, self.p_value = pearson(obs, exp, significance_level,
                                        test_count)
        self.messages.append(msg)
        return ok


def lobe_test(lobes: np.ndarray, probs: np.ndarray,
              significance_level: float = 0.01):
    """Pearson's test of a delta BSDF's discrete lobe choice: `lobes` the
    (N,) lobe index each draw took, `probs` its claimed (N, L) lobe
    probabilities; the expected count of lobe l is their column sum.
    Returns (passed, message)."""
    L = probs.shape[1]
    obs = np.bincount(lobes, minlength=L).astype(np.float64)
    exp = probs.astype(np.float64).sum(0)
    ok, msg, _ = pearson(obs, exp, significance_level)
    return ok, msg
