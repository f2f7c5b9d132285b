"""Probe wavefronts for checking the traversal kernels (numpy, seeded).

Four kinds of rays over a built scene, the kinds a forward render sends
through traversal: camera rays, first-bounce rays cosine-sampled from the
camera hits, shadow rays from those hits toward points on the area
emitters (triangles or spheres), or in a scene without one uniform
directions out to the infinite emitters' distance (t_max = dist * (1 -
1e-3)), and uniform random
rays from inside the scene bounds, a quarter of them aimed into the
scene's spheres when it holds any. The tests hand the same arrays to
both packages, and chip_smoke.py uses them to hold each CUDA kernel
against its twin.
"""
from __future__ import annotations

import numpy as np

from .render.emitters import _INF_DIST

RAY_EPSILON = float(np.finfo(np.float32).eps) / 2 * 1500.0
KINDS = ("camera", "bounce", "shadow", "random")
# rounds of shadow-ray candidates drawn before giving up
SHADOW_ROUNDS = 16


def _normalize(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _frame(n):
    """Orthonormal (s, t) around unit normals n (Duff et al. 2017)."""
    sign = np.where(n[:, 2] >= 0, 1.0, -1.0)
    a = -1.0 / (sign + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    s = np.stack([1.0 + sign * n[:, 0] ** 2 * a, sign * b, -sign * n[:, 0]], -1)
    t = np.stack([b, sign + n[:, 1] ** 2 * a, -n[:, 1]], -1)
    return s, t


def probe_rays(scene, n: int, seed: int, closest_hit):
    """{kind: (o (n, 3), d (n, 3), t_max (n,))} float32 arrays.

    `closest_hit(o, d, t_max) -> (t, prim, inst)` (numpy in and out, inst
    None on a scene without instances) finds the camera hits the bounce
    and shadow rays start from."""
    rng = np.random.default_rng(seed)
    tab = {k: getattr(scene, k).cpu().numpy() for k in (
        "cam_to_world", "cam_fov_x", "prim_p0", "prim_e1", "prim_e2",
        "prim_type", "emitter_prims", "bvh_min", "bvh_max")}
    fwd = (scene.inst_fwd.cpu().numpy()[:, :12].reshape(-1, 3, 4)
           .astype(np.float64) if scene.has_instances else None)
    mat = tab["cam_to_world"]
    tan_x = np.tan(np.deg2rad(float(tab["cam_fov_x"])) * 0.5)
    uv = rng.uniform(0.0, 1.0, (n, 2))
    local = np.stack([(1 - 2 * uv[:, 0]) * tan_x, (1 - 2 * uv[:, 1]) * tan_x,
                      np.ones(n)], -1)
    cam_d = _normalize(local @ mat[:3, :3].T.astype(np.float64))
    cam_o = np.broadcast_to(mat[:3, 3], (n, 3)).astype(np.float64)
    inf = np.full(n, np.inf)
    out = {"camera": (cam_o, cam_d, inf)}

    t, prim, inst = closest_hit(cam_o.astype(np.float32),
                                cam_d.astype(np.float32),
                                inf.astype(np.float32))
    hit = np.nonzero(prim >= 0)[0]
    if hit.size == 0:
        raise ValueError("no camera ray hits the scene")
    pick = hit[rng.integers(0, hit.size, n)]
    p = cam_o[pick] + cam_d[pick] * t[pick, None].astype(np.float64)
    e1, e2 = tab["prim_e1"][prim[pick]], tab["prim_e2"][prim[pick]]
    ng = np.cross(e1, e2).astype(np.float64)
    center = tab["prim_p0"][prim[pick]].astype(np.float64)
    if inst is not None:
        # local-space normal -> world: the inverse transpose, i.e. the
        # transpose of the instance's world->local 3x3
        inv = scene.inst_inv.cpu().numpy()[inst[pick], :12].reshape(n, 3, 4)
        ng = np.einsum("nji,nj->ni", inv[:, :, :3].astype(np.float64), ng)
        m = fwd[inst[pick]]
        center = np.einsum("nij,nj->ni", m[:, :, :3], center) + m[:, :, 3]
    # a sphere's normal points away from its (world) center
    ng = np.where((tab["prim_type"][prim[pick]] != 0)[:, None], p - center,
                  ng)
    ng = _normalize(ng)
    ng = np.where((np.sum(ng * cam_d[pick], -1) > 0)[:, None], -ng, ng)
    org = p + ng * (RAY_EPSILON * (1.0 + np.abs(p).max(-1)))[:, None]

    u = rng.uniform(0.0, 1.0, (n, 2))
    r, phi = np.sqrt(u[:, 0]), 2 * np.pi * u[:, 1]
    s, tt = _frame(ng)
    cz = np.sqrt(np.maximum(1.0 - r * r, 0.0))
    bd = (s * (r * np.cos(phi))[:, None] + tt * (r * np.sin(phi))[:, None]
          + ng * cz[:, None])
    out["bounce"] = (org, _normalize(bd), inf)

    # shadow rays as next-event estimation casts them: only where the
    # light's emitting side faces the origin and the origin's side faces
    # the light (elsewhere the NEE pdf is 0 and the renderer casts none)
    lights = tab["emitter_prims"].reshape(-1)
    lights = lights[lights >= 0]
    if lights.size == 0:
        # no area light (a constant sky, an envmap, delta lights):
        # uniform directions, turned into the origin's hemisphere, out to
        # the infinite emitters' sample distance
        sd = _normalize(rng.normal(size=(n, 3)))
        sd = np.where((np.sum(ng * sd, -1) < 0)[:, None], -sd, sd)
        out["shadow"] = (org, sd, np.full(n, _INF_DIST * (1.0 - 1e-3)))
        return _finish(out, tab, fwd, rng, n)
    # rounds of 8 n candidates until n qualify: one round on most scenes;
    # more where few camera hits face a light (a scene seen mostly
    # through null boundaries)
    got = []
    for _ in range(SHADOW_ROUNDS):
        got.append(_shadow_candidates(tab, lights, org, ng, rng, n, 8 * n))
        if sum(g[0].shape[0] for g in got) >= n:
            break
    else:
        raise ValueError("too few camera hits see the emitting side of a light")
    o, sd, dist = (np.concatenate(x)[:n] for x in zip(*got))
    out["shadow"] = (o, sd, dist * (1.0 - 1e-3))
    return _finish(out, tab, fwd, rng, n)


def _shadow_candidates(tab, lights, org, ng, rng, n, m):
    """`m` shadow rays from random origins of `org` (normals `ng`) to
    uniform points on random light prims: (origins, directions,
    distances) of those whose light's emitting side faces the origin and
    whose origin's side faces the light."""
    src = rng.integers(0, n, m)
    lp = lights[rng.integers(0, lights.size, m)]
    b = rng.uniform(0.0, 1.0, (m, 2))
    sq = np.sqrt(1.0 - b[:, 0])
    b0, b1 = 1.0 - sq, sq * b[:, 1]
    e1, e2 = tab["prim_e1"][lp], tab["prim_e2"][lp]
    target = tab["prim_p0"][lp] + e1 * b0[:, None] + e2 * b1[:, None]
    n_light = _normalize(np.cross(e1, e2).astype(np.float64))
    sph = tab["prim_type"][lp] != 0
    if sph.any():
        # a sphere light (center p0, e1 = [radius, normal sign, 0]): the
        # same two numbers give a uniform point on it, its normal outward
        # (inward for a flipped sphere)
        z, phi = 1.0 - 2.0 * b[:, 0], 2.0 * np.pi * b[:, 1]
        rz = np.sqrt(np.maximum(1.0 - z * z, 0.0))
        u = np.stack([rz * np.cos(phi), rz * np.sin(phi), z], -1)
        target = np.where(sph[:, None], tab["prim_p0"][lp]
                          + u * e1[:, :1].astype(np.float64), target)
        n_light = np.where(sph[:, None], u * np.sign(e1[:, 1:2]), n_light)
    sd = target - org[src]
    dist = np.linalg.norm(sd, axis=-1)
    sd = sd / dist[:, None]
    ok = np.nonzero((np.sum(n_light * sd, -1) < 0)
                    & (np.sum(ng[src] * sd, -1) > 0))[0]
    return org[src[ok]], sd[ok], dist[ok]


def _finish(out, tab, fwd, rng, n):
    lo, hi = tab["bvh_min"][0], tab["bvh_max"][0]
    mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo) * 0.95
    ro = mid + rng.uniform(-1.0, 1.0, (n, 3)) * half
    rd = _normalize(rng.normal(size=(n, 3)))
    sph = np.nonzero(tab["prim_type"] != 0)[0]
    if sph.size:
        # a quarter of the rays aimed at points inside the spheres: under
        # instances, each stored sphere as every instance would place it
        # (for an instance whose group lacks that sphere, a point in
        # whatever lies there)
        c = tab["prim_p0"][sph].astype(np.float64)
        r = tab["prim_e1"][sph, 0].astype(np.float64)
        if fwd is not None:
            c = (np.einsum("kij,sj->ksi", fwd[:, :, :3], c)
                 + fwd[:, None, :, 3]).reshape(-1, 3)
            r = np.tile(r, fwd.shape[0]) * np.cbrt(np.abs(np.linalg.det(
                fwd[:, :, :3]))).repeat(sph.size)
        m = n // 4
        k = rng.integers(0, c.shape[0], m)
        aim = c[k] + (_normalize(rng.normal(size=(m, 3)))
                      * (0.9 * r[k] * rng.uniform(0.0, 1.0, m))[:, None])
        rd[:m] = _normalize(aim - ro[:m])
    out["random"] = (ro, rd, np.full(n, np.inf))
    return {k: tuple(np.ascontiguousarray(a, dtype=np.float32) for a in v)
            for k, v in out.items()}
