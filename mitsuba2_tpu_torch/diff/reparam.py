"""Reparameterized directions: visibility (boundary) gradients
(counterpart of mitsuba2_tpu/diff/reparam.py; Loubet, Nimier-David &
Jakob 2019).

Plain autograd of a render misses the boundary term: moving an occluder
moves the discontinuity of the integrand, which the detached traversal
never sees. Each direction whose visibility can change under a geometry
move is replaced by d' = normalize(d + (V - V.detach())), whose primal is
d's and whose tangent follows the warp V, and its contribution is
multiplied by det, the change of variables' Jacobian, whose primal is
exactly 1. V is a vMF-kernel-weighted, harmonic-weighted mean of the
directions to K auxiliary rays' hits, which follow the geometry
(scene.ray_intersect_positions), so the primal image is unchanged.

The K auxiliary rays of a site are one (K, N) batch, and every site's
rays go through one traversal (`warp_and_divergence_multi`). The JAX
package takes det's Jacobian from two jax.jvp probes of V; here the
probes are V's directional derivatives in closed form, the derivatives of
its two clamps and of rsqrt as the JAX package takes them, with the
primal removed as there (dV - dV.detach()), so that autograd carries the
boundary derivative alone.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from ..config import RenderConfig, check_kaux
from ..core.geometry import Ray
from ..core.math import _TINY
from ..core.spec import swhere
from ..core.vec import Vec3, vdot, vnormalize, vwhere
from ..device import resolve_device
from ..render import emitters, sensors
from ..render.sampler import Sampler

K_AUX = 16      # auxiliary rays a reparameterized direction traces
KAPPA = 5e3     # the warp kernel's vMF concentration; the aux rays spread
                # over 3 / sqrt(KAPPA)
_FAR = 1e4
CHUNK_VAR = "MI_REPARAM_CHUNK"
# lanes a chunk of the auxiliary wavefront holds under brute force, whose
# per-prim sweeps materialize a wavefront's worth of each intermediate
# (the JAX package's measured knee); the walks take one batch
BRUTE_CHUNK = 2097152


def _aux_offsets(k: int = K_AUX) -> np.ndarray:
    """Fixed unit-disk offsets, (K, 2) f32: the golden-angle spiral."""
    i = np.arange(k) + 0.5
    r = np.sqrt(i / k)
    th = i * 2.399963229728653
    return np.stack([r * np.cos(th), r * np.sin(th)], -1).astype(np.float32)


def _cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
                a.x * b.y - a.y * b.x)


def _tangent_frame(d0: Vec3):
    vertical = d0.z.abs() < 0.9
    zero = torch.zeros_like(d0.z)
    up = Vec3(torch.where(vertical, 0.0, 1.0), zero,
              torch.where(vertical, 1.0, 0.0))
    t1 = vnormalize(_cross(up, d0))
    return t1, _cross(d0, t1)


def _follow_points_batched(scene, o: Vec3, d: Vec3, n: int):
    """The followed hit points of R rays of n lanes each, o and d (R*n,)
    flat, ray r at lanes [r*n, (r+1)*n): (x Vec3, t) of (R*n,), x the hit
    position (scene.ray_intersect_positions: it follows the geometry
    under differentiation) or o + d * _FAR on a miss, t its distance
    (detached) or _FAR. One traversal for all of them, in chunks of whole
    rays of at most MI_REPARAM_CHUNK lanes (BRUTE_CHUNK by default under
    brute force; 0, one batch, by default on the walks, which each chunk
    would cost a presort)."""
    from ..scene import scene as scene_mod
    n_rays = o.x.shape[0] // n
    cap = int(os.environ.get(
        CHUNK_VAR, str(BRUTE_CHUNK)
        if scene_mod._pick_backend(scene) == "brute" else "0"))
    per = max(1, cap // max(n, 1)) if cap else n_rays
    xs, ts = [], []
    for r0 in range(0, n_rays, per):
        sl = slice(r0 * n, min(n_rays, r0 + per) * n)
        O = Vec3(o.x[sl], o.y[sl], o.z[sl])
        D = Vec3(d.x[sl], d.y[sl], d.z[sl])
        p, t, valid = scene_mod.ray_intersect_positions(scene, Ray.make(O, D))
        xs.append(vwhere(valid, p, O + D * _FAR))
        ts.append(torch.where(valid, t, _FAR))
    if len(xs) == 1:
        return xs[0], ts[0]
    return (Vec3(*(torch.cat([getattr(x, c) for x in xs]) for c in "xyz")),
            torch.cat(ts))


def _gated(dy, x, floor):
    """dy times the derivative of max(x, floor) with respect to x, as the
    JAX package takes it (1 above, 1/2 at the tie), and 0 below whatever
    dy is: where x is clamped, dy may be infinite (a zero direction's
    rsqrt derivative at the floor), whose product with the JAX package's
    0 is NaN."""
    return torch.where(x > floor, dy, torch.where(x == floor, 0.5 * dy, 0.0))


def _warp(omega: Vec3, h, dirs: Vec3, d0: Vec3, probes):
    """V(d0) = normalize(sum_k w_k omega_k / max(sum_k w_k, 1e-20)), w_k =
    exp(max(KAPPA (d0 . d_k - 1), -30)) h_k, over the (K, N) batch, and
    its directional derivatives at d0 along each tangent of `probes`."""
    lw = KAPPA * (vdot(d0, dirs) - 1.0)
    e = torch.exp(torch.clamp_min(lw, -30.0))
    wk = e * h
    num = Vec3((omega.x * wk).sum(0), (omega.y * wk).sum(0),
               (omega.z * wk).sum(0))
    den = wk.sum(0)
    r = 1.0 / torch.clamp_min(den, 1e-20)
    u = num * r
    q = u.x * u.x + u.y * u.y + u.z * u.z
    qc = torch.clamp_min(q, _TINY)
    s = torch.rsqrt(qc)
    V = Vec3(u.x * s, u.y * s, u.z * s)
    de = _gated(e, lw, -30.0) * h          # d w_k / d lw_k
    dr_dden = _gated(-(r * r), den, 1e-20)
    ds_dq = _gated(-0.5 * s / qc, q, _TINY)
    dV = []
    for t in probes:
        dwk = de * (KAPPA * vdot(t, dirs))
        dnum = Vec3((omega.x * dwk).sum(0), (omega.y * dwk).sum(0),
                    (omega.z * dwk).sum(0))
        dr = dr_dden * dwk.sum(0)
        du = dnum * r + num * dr
        ds = ds_dq * (2.0 * vdot(u, du))
        dV.append(du * s + u * ds)
    return V, dV


def warp_and_divergence_multi(scene, sites, k_aux: int = None):
    """Loubet-style warps of several reparameterization sites in one
    traversal. `sites`: (o, d) pairs of planar Vec3 of one wavefront size
    N (a bounce's NEE direction and its BSDF-sampled continuation). Each
    site's K auxiliary directions lie on a fixed golden-angle disk of
    radius 3 / sqrt(KAPPA) about d (detached) in its tangent plane; all
    sites' K * N rays go through _follow_points_batched at once. Returns,
    a site each, (V(d), det): det's primal is exactly 1 and it carries the
    change of variables' derivative."""
    k = check_kaux(K_AUX if k_aux is None else k_aux)
    offs = _aux_offsets(k)
    radius = np.float32(3.0 / np.sqrt(KAPPA))
    n = sites[0][1].x.shape[0]
    dev = sites[0][1].x.device
    c1, c2 = (torch.from_numpy(radius * offs[:, i]).to(dev)[:, None]
              for i in (0, 1))
    frames, aux_o, aux_d = [], [], []
    for o, d in sites:
        d0 = Vec3(d.x.detach(), d.y.detach(), d.z.detach())
        t1, t2 = _tangent_frame(d0)
        dirs = vnormalize(Vec3(*(
            getattr(d0, c)[None] + getattr(t1, c)[None] * c1
            + getattr(t2, c)[None] * c2 for c in "xyz")))   # (K, N)
        frames.append((o, d0, t1, t2, dirs))
        aux_o.append(Vec3(*(getattr(o, c).expand(k, n).reshape(-1)
                            for c in "xyz")))
        aux_d.append(Vec3(*(getattr(dirs, c).reshape(-1) for c in "xyz")))
    x, t = _follow_points_batched(
        scene, Vec3(*(torch.cat([getattr(a, c) for a in aux_o])
                      for c in "xyz")),
        Vec3(*(torch.cat([getattr(a, c) for a in aux_d]) for c in "xyz")), n)

    out = []
    for i, (o, d0, t1, t2, dirs) in enumerate(frames):
        sl = slice(i * k * n, (i + 1) * k * n)
        omega = vnormalize(Vec3(*(getattr(x, c)[sl].view(k, n)
                                  - getattr(o, c)[None] for c in "xyz")))
        # the nearest aux hit owns the silhouette: harmonic weights in the
        # distance above the minimum, so that the warp moves with the
        # occluder at its edge (a plain mean would move at half its speed)
        t_k = t[sl].view(k, n)
        t_min = t_k.min(0).values
        h = 1.0 / (0.05 * t_min + (t_k - t_min) + 1e-4)
        V, (dV1, dV2) = _warp(omega, h, dirs, d0, (t1, t2))
        dV1 = dV1 - Vec3(dV1.x.detach(), dV1.y.detach(), dV1.z.detach())
        dV2 = dV2 - Vec3(dV2.x.detach(), dV2.y.detach(), dV2.z.detach())
        j11, j12 = vdot(dV1, t1), vdot(dV1, t2)
        j21, j22 = vdot(dV2, t1), vdot(dV2, t2)
        out.append((V, (1.0 + j11) * (1.0 + j22) - j12 * j21))
    return out


def warp_and_divergence(scene, o, d, k_aux: int = None):
    """Single-site convenience wrapper over warp_and_divergence_multi."""
    return warp_and_divergence_multi(scene, [(o, d)], k_aux)[0]


def warp_field(scene, o, d):
    """V(d) alone (see warp_and_divergence)."""
    return warp_and_divergence(scene, o, d)[0]


def reparameterize(d: Vec3, V: Vec3) -> Vec3:
    """normalize(d + (V - V.detach())): d's primal, V's tangent."""
    return vnormalize(Vec3(*(getattr(d, c) + (getattr(V, c)
                                              - getattr(V, c).detach())
                             for c in "xyz")))


def _radiance_at(scene, o, d, wavelengths, config):
    """Direct radiance along (o, d): the emitter hit or the environment;
    the hit position follows the geometry, the emitter lookup is smooth."""
    from ..scene import scene as scene_mod
    si = scene_mod.ray_intersect(scene, Ray.make(o, d))
    return swhere(si.valid, emitters.eval_hit(scene, si, config),
                  emitters.eval_env(scene, d, wavelengths, config))


def _reparam_pass(scene, config: RenderConfig, sppc: int, seed_p: int):
    H, W = config.height, config.width
    n = sppc * H * W
    lane = torch.arange(n, dtype=torch.int64, device=scene.device)
    sampler = Sampler.seed(seed_p, lane)
    pix = lane % (H * W)
    x = (pix % W).to(torch.float32)
    y = (pix // W).to(torch.float32)
    jitter, sampler = sampler.next_2d()
    ray = sensors.sample_ray(scene, sensors.film_uv(x, y, jitter, W, H))
    V, det = warp_and_divergence(scene, ray.o, ray.d, config.reparam_kaux)
    L = _radiance_at(scene, ray.o, reparameterize(ray.d, V), None, config)
    vals = torch.stack((L * det).ch, -1)
    return vals.reshape(sppc, H, W, -1).mean(0)


def render_direct_reparam(scene, config: RenderConfig, seed: int = None,
                          device=None) -> torch.Tensor:
    """Primary-visibility render with reparameterized camera rays: the
    directly visible emitters and environment, each pass the mean of its
    spp_per_pass samples, the passes averaged (pass seeds as render's).
    Differentiable with respect to the scene's geometry tables, the
    visibility boundary term included; its value is the plain render's
    at max_depth 1. Runs on `device` (None = the CUDA device; raises
    without one), under autograd where scene.needs_tape(scene), else in
    inference mode. The path integrator reparameterizes every vertex with
    RenderConfig(reparam=True) (render/integrators.py)."""
    from ..render.integrators import pass_seeds
    from ..scene.scene import needs_tape, to_device
    scene = to_device(scene, resolve_device(device))
    if seed is None:
        seed = config.seed
    sppc = min(config.spp_per_pass, config.spp)
    n_passes = (config.spp + sppc - 1) // sppc
    acc = None
    with (contextlib.nullcontext() if needs_tape(scene)
          else torch.inference_mode()):
        for s in pass_seeds(seed, n_passes):
            img = _reparam_pass(scene, config, sppc, s)
            acc = img if acc is None else acc + img
    return acc / n_passes
