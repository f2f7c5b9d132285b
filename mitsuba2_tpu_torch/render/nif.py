"""Neural occlusion oracle: an optional, approximate shadow-ray test
(counterpart of render/nif.py; off unless a scene carries one).

A small per-scene MLP stands in for the any-hit traversal of shadow
rays ("Neural Intersection Function", Fujieda et al., arXiv 2306.07191):
dense matrix products instead of a BVH walk, at a measured
approximation error. The reference renderer has no counterpart.

- A query is an NEE shadow segment, surface point a -> emitter point b.
- Its features: both endpoints normalized to the scene's box, each
  coordinate sinusoidally encoded at `n_freq` octaves, and the unit
  direction: 3 + 6 * 2 * n_freq values.
- The model: two hidden ReLU layers of `width`, one logit;
  occluded = logit > 0.
- Training: NEE-shaped segments (origins area-sampled on the geometry
  and pushed off it along the normal to a random side, endpoints
  area-sampled on emitting prims), labelled by the exact
  `scene.ray_test` (on the card the any-hit kernel of the scene's walk,
  its twin on the CPU, brute force on small scenes); minibatch Adam on
  the binary cross-entropy (diff/optimizers.py).

The JAX package draws its segments with jax.random, the port with a
torch.Generator: the datasets differ, and so do the trained weights.
With the same weights (convert.shadow_nif_from_numpy) the two answer
alike; the trainings agree in their accuracy only.

    nif = train_shadow_nif(scene, steps=2000)
    occ = nif_ray_test(nif, o, d, maxt)
    scene_n = dataclasses.replace(scene, shadow_nif=nif)  # NEE uses it
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.geometry import Ray
from ..core.vec import Vec3

# the lanes of one pass through the MLP: (N, 75) features and two (N,
# width) hidden layers a chunk
CHUNK = 1 << 18
# training segments drawn (and labelled) a call, as the JAX package
DATASET_CHUNK = 65536


@dataclasses.dataclass
class ShadowNIF:
    """The MLP's parameters and the scene box it normalizes with."""
    w0: torch.Tensor
    b0: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    bb_min: torch.Tensor   # (3,)
    bb_inv: torch.Tensor   # (3,) 1 / extent
    n_freq: int = 4

    PARAMS = ("w0", "b0", "w1", "b1", "w2", "b2")

    def params(self) -> dict:
        return {k: getattr(self, k) for k in self.PARAMS}

    def to(self, device) -> "ShadowNIF":
        return dataclasses.replace(self, **{
            k: getattr(self, k).to(device)
            for k in self.PARAMS + ("bb_min", "bb_inv")})


def _encode(nif: ShadowNIF, ax, ay, az, bx, by, bz, dx, dy, dz):
    """Segments -> (N, F) features: the direction, then sin/cos octaves
    of both normalized endpoints."""
    feats = [dx, dy, dz]
    for (px, py, pz) in ((ax, ay, az), (bx, by, bz)):
        nx = (px - nif.bb_min[0]) * nif.bb_inv[0]
        ny = (py - nif.bb_min[1]) * nif.bb_inv[1]
        nz = (pz - nif.bb_min[2]) * nif.bb_inv[2]
        for k in range(nif.n_freq):
            f = (2.0 ** k) * math.pi
            for c in (nx, ny, nz):
                feats.append(torch.sin(f * c))
                feats.append(torch.cos(f * c))
    return torch.stack(feats, -1)


def _logits(nif: ShadowNIF, feats):
    h = torch.relu(feats @ nif.w0 + nif.b0)
    h = torch.relu(h @ nif.w1 + nif.b1)
    return (h @ nif.w2 + nif.b2)[..., 0]


def nif_logits(nif: ShadowNIF, ray_o: Vec3, ray_d: Vec3, t_max):
    """The logits of shadow segments o -> o + d * t_max, in chunks of
    CHUNK lanes, in the weights' dtype (a float64 render's segments are
    rounded to them)."""
    dt = nif.w0.dtype
    t = torch.clamp_max(t_max, 1e6)   # an env shadow ray's inf endpoint
    out = []
    for s in range(0, t.shape[0], CHUNK):
        sl = slice(s, s + CHUNK)
        o = [c[sl].to(dt) for c in (ray_o.x, ray_o.y, ray_o.z)]
        d = [c[sl].to(dt) for c in (ray_d.x, ray_d.y, ray_d.z)]
        tt = t[sl].to(dt)
        b = [oc + dc * tt for oc, dc in zip(o, d)]
        out.append(_logits(nif, _encode(nif, *o, *b, *d)))
    return torch.cat(out) if out else t.new_zeros(0, dtype=dt)


def nif_ray_test(nif: ShadowNIF, ray_o: Vec3, ray_d: Vec3, t_max):
    """Approximate Scene::ray_test of shadow segments: the endpoint is
    o + d * t_max (NEE passes the emitter's distance as maxt)."""
    return nif_logits(nif, ray_o, ray_d, t_max) > 0.0


def scene_bb_min(scene):
    return scene.bvh_min[0]


def scene_bb_inv(scene):
    return 1.0 / torch.clamp_min(scene.bvh_max[0] - scene.bvh_min[0], 1e-6)


def _area_sample(scene, gen, n, weight):
    """n points area-sampled on the prims of positive `weight` (numpy,
    (P,)): a prim picked in proportion to its area, a uniform point on
    it (a sphere prim samples as its table's triangle, as in the JAX
    package), and its unit geometric normal."""
    dev = scene.prim_p0.device
    w = scene.prim_area.detach().cpu().numpy().astype(np.float64) * weight
    w = torch.as_tensor(w / max(w.sum(), 1e-20), device=dev)
    idx = torch.multinomial(w, n, replacement=True, generator=gen)
    u = torch.rand((n, 2), generator=gen, device=dev)
    s = torch.sqrt(u[:, 0])
    b0 = 1.0 - s
    b1 = u[:, 1] * s
    p0, e1, e2 = scene.prim_p0[idx], scene.prim_e1[idx], scene.prim_e2[idx]
    p = p0 + e1 * b0[:, None] + e2 * b1[:, None]
    n_g = torch.linalg.cross(e1, e2)
    n_g = n_g / torch.clamp_min(torch.linalg.norm(n_g, dim=-1, keepdim=True),
                                1e-20)
    return p, n_g


def _sample_segments(scene, gen, n):
    """n NEE-shaped training segments and their exact labels: (o, d,
    maxt, occluded)."""
    from ..scene import scene as scene_mod
    dev = scene.prim_p0.device
    P = scene.prim_p0.shape[0]
    shape_emitter = scene.shape_emitter.cpu().numpy()
    emit_w = (shape_emitter[scene.prim_shape.cpu().numpy()] >= 0
              ).astype(np.float64)
    surf_p, surf_n = _area_sample(scene, gen, n, np.ones(P))
    # the offset normal turned to a random side: shadow rays leave both
    side = torch.where(torch.rand(n, generator=gen, device=dev) < 0.5,
                       1.0, -1.0)
    surf_p = surf_p + surf_n * (side * 1e-3)[:, None]
    if emit_w.sum() > 0:
        emit_p, _ = _area_sample(scene, gen, n, emit_w)
    else:  # no area emitter: random points of the box (env shadows)
        emit_p = (torch.rand((n, 3), generator=gen, device=dev)
                  * (1.0 / torch.clamp_min(scene_bb_inv(scene), 1e-9))
                  + scene_bb_min(scene))
    d = emit_p - surf_p
    dist = torch.clamp_min(torch.linalg.norm(d, dim=-1), 1e-9)
    d = d / dist[:, None]
    o = Vec3(surf_p[:, 0], surf_p[:, 1], surf_p[:, 2])
    dv = Vec3(d[:, 0], d[:, 1], d[:, 2])
    maxt = dist * (1.0 - 1e-3)
    exact = dataclasses.replace(scene, shadow_nif=None)
    occ = scene_mod.ray_test(exact, Ray.make(o, dv, maxt=maxt))
    return o, dv, maxt, occ


def init_nif(scene, width: int = 64, n_freq: int = 4, seed: int = 0
             ) -> ShadowNIF:
    """Glorot-uniform weights from a numpy generator of `seed` (the JAX
    package's draws, in its order), zero biases."""
    F = 3 + 6 * 2 * n_freq
    rng = np.random.default_rng(seed)
    dev = scene.prim_p0.device

    def glorot(fan_in, fan_out):
        s = np.sqrt(6.0 / (fan_in + fan_out))
        return torch.as_tensor(rng.uniform(-s, s, (fan_in, fan_out)),
                               dtype=torch.float32, device=dev)

    def zeros(k):
        return torch.zeros(k, dtype=torch.float32, device=dev)

    return ShadowNIF(w0=glorot(F, width), b0=zeros(width),
                     w1=glorot(width, width), b1=zeros(width),
                     w2=glorot(width, 1), b2=zeros(1),
                     bb_min=scene_bb_min(scene).float(),
                     bb_inv=scene_bb_inv(scene).float(), n_freq=n_freq)


def make_dataset(scene, n: int = 262144, seed: int = 0):
    """(o, d, maxt, occluded) of n segments, drawn and labelled in chunks
    of DATASET_CHUNK: training then never calls the exact test again."""
    gen = torch.Generator(device=scene.prim_p0.device).manual_seed(seed)
    chunks = [_sample_segments(scene, gen, DATASET_CHUNK)
              for _ in range((n + DATASET_CHUNK - 1) // DATASET_CHUNK)]
    o = Vec3(*(torch.cat([getattr(c[0], a) for c in chunks])[:n]
               for a in "xyz"))
    d = Vec3(*(torch.cat([getattr(c[1], a) for c in chunks])[:n]
               for a in "xyz"))
    maxt = torch.cat([c[2] for c in chunks])[:n]
    occ = torch.cat([c[3] for c in chunks])[:n]
    return o, d, maxt, occ


def _bce(logit, y):
    return torch.mean(torch.clamp_min(logit, 0) - logit * y
                      + torch.log1p(torch.exp(-logit.abs())))


def train_shadow_nif(scene, steps: int = 3000, batch: int = 8192,
                     lr: float = 2e-3, width: int = 128, n_freq: int = 6,
                     seed: int = 0, dataset_size: int = 262144,
                     log_every: int = 0) -> ShadowNIF:
    """Fit the oracle to `scene` on the scene's device: the dataset drawn
    once, then `steps` Adam steps on consecutive minibatches of `batch`
    (wrapping around), the JAX package's schedule."""
    if getattr(scene, "has_instances", False):
        raise ValueError("shadow-NIF training samples the packed prim "
                         "tables, which are instance-local on shared-BLAS "
                         "instanced scenes; flatten the instances "
                         "(shapes.instance(..., flatten=True)) to train")
    from ..diff import optimizers as opt_mod
    with torch.no_grad():
        nif = init_nif(scene, width=width, n_freq=n_freq, seed=seed)
        o, d, maxt, occ = make_dataset(scene, dataset_size, seed)
        t = torch.clamp_max(maxt, 1e6)
        feats = _encode(nif, o.x, o.y, o.z, o.x + d.x * t, o.y + d.y * t,
                        o.z + d.z * t, d.x, d.y, d.z)
        labels = occ.to(torch.float32)
    n = feats.shape[0]
    params = nif.params()
    state = opt_mod.adam_init(params)
    for s in range(steps):
        i0 = (s * batch) % (n - batch + 1)
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        with torch.enable_grad():
            loss = _bce(_logits(dataclasses.replace(nif, **p),
                                feats[i0:i0 + batch]),
                        labels[i0:i0 + batch])
            grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        with torch.no_grad():
            params, state = opt_mod.adam_step(params, grads, state, lr)
        if log_every and s % log_every == 0:
            print(f"nif step {s}: bce {float(loss):.4f}")
    return dataclasses.replace(nif, **{k: v.detach()
                                       for k, v in params.items()})


def accuracy(nif: ShadowNIF, scene, n: int = 20000, seed: int = 99
             ) -> float:
    """Held-out agreement with the exact test on NEE-shaped segments."""
    with torch.no_grad():
        gen = torch.Generator(device=scene.prim_p0.device).manual_seed(seed)
        o, d, maxt, occ = _sample_segments(scene, gen, n)
        pred = nif_ray_test(nif, o, d, maxt)
        return float((pred == occ).float().mean())
