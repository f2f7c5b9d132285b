"""The plain reference: a unidirectional path tracer in PyTorch for the
benchmark's scenes (gpubench/scenes/), which imports nothing of the
program and takes nothing it made.

It computes what the program's `render` and `render_l2_grad` compute for
these scenes, in the program's sample order, so that both trace the same
paths from the same random numbers: the independent sampler (pcg32.py),
one pass of spp x H x W lanes laid out (sample, row, column), the pixel
jitter, a perspective camera (horizontal fov, no clip), and per bounce
next-event estimation (an emitter picked uniformly, a point uniform on
its triangle) with its shadow ray, a cosine-weighted diffuse sample, the
emitter hit along it, both weighted by the power heuristic; a box film.
Russian roulette is not implemented: a config must start it at or past
its last bounce (rr_depth >= max_depth), where it draws nothing.

`dtype` is the precision of every floating-point step; the benchmark's
control runs it in bfloat16, one step below the configuration's float32.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import accel, pcg32

INV_PI = 1.0 / math.pi
RAY_EPSILON = float(np.finfo(np.float32).eps) / 2 * 1500.0


@dataclasses.dataclass
class Scene:
    p0: torch.Tensor            # (P, 3) triangle vertex 0
    e1: torch.Tensor            # (P, 3) edges
    e2: torch.Tensor
    n0: torch.Tensor            # (P, 3) shading normals at the corners
    n1: torch.Tensor
    n2: torch.Tensor
    prim_shape: torch.Tensor    # (P,) int64
    shape_mat: torch.Tensor     # (S,) int64
    shape_emitter: torch.Tensor  # (S,) int64, -1 = none
    emitter_prim: torch.Tensor  # (E,) int64: one triangle an emitter
    emitter_area: torch.Tensor  # (E,)
    reflectance: torch.Tensor   # (M, 3) a row per distinct material
    radiance: torch.Tensor      # (E, 3)
    cam: torch.Tensor           # (4, 4) camera to world
    tan_half: torch.Tensor      # () tan of half the horizontal fov
    bvh: accel.BVH
    dtype: torch.dtype
    shape_ids: tuple

    @property
    def tris(self):
        return self.p0, self.e1, self.e2


def build(spec: dict, device, dtype=torch.float32) -> Scene:
    """A scene dict (gpubench/scenes/_geometry.py) -> tensors on `device`.
    Materials are rows of distinct reflectances in order of first use,
    emitters in shape order."""
    p0s, e1s, e2s, ns = [], [], [], []
    prim_shape, shape_mat, shape_emitter = [], [], []
    mats, mat_row, rad, em_prim, em_area = [], {}, [], [], []
    n_prims = 0
    for s_idx, sh in enumerate(spec["shapes"]):
        key = tuple(sh["reflectance"])
        if key not in mat_row:
            mat_row[key] = len(mats)
            mats.append(list(key))
        shape_mat.append(mat_row[key])
        v, f = sh["vertices"], sh["faces"]
        a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
        e1, e2 = b - a, c - a
        fn = np.cross(e1, e2)
        area = 0.5 * np.linalg.norm(fn, axis=-1)
        fn = (fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True),
                              1e-20)).astype(np.float32)
        if sh["normals"] is not None:
            ns.append(np.stack([sh["normals"][f[:, k]] for k in range(3)]))
        else:
            ns.append(np.stack([fn] * 3))
        p0s.append(a)
        e1s.append(e1)
        e2s.append(e2)
        prim_shape.append(np.full(f.shape[0], s_idx))
        if sh["radiance"] is not None:
            if f.shape[0] != 1:
                raise ValueError("an emitter is one triangle")
            shape_emitter.append(len(rad))
            rad.append(sh["radiance"])
            em_prim.append(n_prims)
            em_area.append(np.float32(area[0]))
        else:
            shape_emitter.append(-1)
        n_prims += f.shape[0]
    p0, e1, e2 = (np.concatenate(x).astype(np.float32)
                  for x in (p0s, e1s, e2s))
    n = np.concatenate(ns, axis=1).astype(np.float32)

    def up(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    cam = spec["camera"]
    fov = torch.tensor(np.float32(cam["fov"]), device=device)
    return Scene(
        p0=up(p0), e1=up(e1), e2=up(e2), n0=up(n[0]), n1=up(n[1]),
        n2=up(n[2]), prim_shape=up(np.concatenate(prim_shape), torch.int64),
        shape_mat=up(shape_mat, torch.int64),
        shape_emitter=up(shape_emitter, torch.int64),
        emitter_prim=up(em_prim, torch.int64), emitter_area=up(em_area),
        reflectance=up(np.asarray(mats, np.float32)),
        radiance=up(np.asarray(rad, np.float32)),
        cam=up(np.asarray(cam["to_world"], np.float32)),
        tan_half=torch.tan(torch.deg2rad(fov) * 0.5).to(dtype),
        bvh=accel.build_bvh(p0, e1, e2, device, dtype), dtype=dtype,
        shape_ids=tuple(sh["id"] for sh in spec["shapes"]))


def with_reflectance(scene: Scene, shape_id: str, value) -> Scene:
    """The scene with the material of shape `shape_id` set to `value`
    (a material row of its own in both scenes the benchmark perturbs)."""
    row = int(scene.shape_mat[scene.shape_ids.index(shape_id)])
    refl = scene.reflectance.clone()
    refl[row] = torch.as_tensor(value, dtype=refl.dtype, device=refl.device)
    return dataclasses.replace(scene, reflectance=refl)


def with_values(scene: Scene, values: dict) -> Scene:
    """The scene with every material's reflectance and every emitter's
    radiance set by name, as `<shape id>.bsdf.reflectance` and
    `<shape id>.emitter.radiance` (Mitsuba's parameter names): one value
    a material row and an emitter, no row left unset."""
    refl, rad = scene.reflectance.clone(), scene.radiance.clone()
    rows, ems = [], []
    for name, v in values.items():
        sid, kind = name.split(".", 1)
        s_idx = scene.shape_ids.index(sid)
        v = torch.as_tensor(v).to(refl.dtype).to(refl.device)
        if kind == "bsdf.reflectance":
            row = int(scene.shape_mat[s_idx])
            refl[row] = v
            rows.append(row)
        elif kind == "emitter.radiance":
            row = int(scene.shape_emitter[s_idx])
            rad[row] = v
            ems.append(row)
        else:
            raise KeyError(f"no reference parameter {name!r}")
    if (sorted(rows) != list(range(refl.shape[0]))
            or sorted(ems) != list(range(rad.shape[0]))):
        raise ValueError(f"values set material rows {sorted(rows)} of "
                         f"{refl.shape[0]} and emitters {sorted(ems)} of "
                         f"{rad.shape[0]}: one value each")
    return dataclasses.replace(scene, reflectance=refl, radiance=rad)


# --- planar 3-vectors: tuples of (N,) tensors ------------------------------

def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _normalize(v):
    inv = 1.0 / torch.sqrt(torch.clamp_min(_dot(v, v), 1e-30))
    return tuple(c * inv for c in v)


def _where(m, a, b):
    return tuple(torch.where(m, x, y) for x, y in zip(a, b))


def _cols(t):
    return t[:, 0], t[:, 1], t[:, 2]


def _frame(n):
    """An orthonormal basis (s, t) around the unit n (Duff et al.)."""
    sign = torch.where(n[2] >= 0, 1.0, -1.0).to(n[2].dtype)
    a = -1.0 / (sign + n[2])
    b = n[0] * n[1] * a
    s = (1.0 + sign * n[0] * n[0] * a, sign * b, -sign * n[0])
    t = (b, sign + n[1] * n[1] * a, -n[1])
    return s, t, n


def _to_local(f, v):
    return _dot(v, f[0]), _dot(v, f[1]), _dot(v, f[2])


def _to_world(f, v):
    s, t, n = f
    return tuple(s[i] * v[0] + t[i] * v[1] + n[i] * v[2] for i in range(3))


def _mis(a, b):
    a2 = a * a
    return torch.where(a > 0, a2 / torch.clamp_min(a2 + b * b, 1e-38), 0.0)


def _spawn(p, n, d):
    """A ray origin pushed off the surface along the geometric normal."""
    m = torch.maximum(torch.maximum(p[0].abs(), p[1].abs()), p[2].abs())
    eps = RAY_EPSILON * (1.0 + m)
    eps = torch.where(_dot(n, d) >= 0, eps, -eps)
    return tuple(p[i] + n[i] * eps for i in range(3))


@dataclasses.dataclass
class Hit:
    valid: torch.Tensor
    p: tuple
    n: tuple        # geometric normal
    frame: tuple    # shading frame (s, t, n)
    wi: tuple       # toward the viewer, local
    shape: torch.Tensor


class Queries:
    """The lanes' traversals, or their recorded answers: `record` keeps
    each answer in order, and a Queries made from it hands them back in
    the same order instead of traversing (the adjoint's replay: its
    paths are the forward's, the tables move no ray)."""

    def __init__(self, scene: Scene, record=None):
        self.scene = scene
        self.replay = None if record is None else iter(record)
        self.record = []

    def _ask(self, fn, o, d, tmax):
        if self.replay is not None:
            return next(self.replay)
        ans = fn(self.scene.bvh, self.scene.tris, o, d, tmax)
        self.record.append(ans)
        return ans

    def closest(self, o, d, tmax):
        return self._ask(lambda *a: accel.closest_hit(*a)[1], o, d, tmax)

    def occluded(self, o, d, tmax):
        return self._ask(accel.any_hit, o, d, tmax)


def _intersect(scene: Scene, o, d, prim) -> Hit:
    """The shading record of the closest hit `prim`, solved again in
    Möller-Trumbore's order of operations on the winning triangle."""
    valid = prim >= 0
    idx = torch.clamp_min(prim, 0)
    p0, e1, e2 = (_cols(x[idx]) for x in (scene.p0, scene.e1, scene.e2))
    pv = _cross(d, e2)
    det = _dot(e1, pv)
    inv = torch.where(det.abs() < 1e-18, 0.0, 1.0 / det)
    tv = tuple(o[i] - p0[i] for i in range(3))
    qv = _cross(tv, e1)
    u = torch.where(valid, _dot(tv, pv) * inv, 0.0)
    v = torch.where(valid, _dot(d, qv) * inv, 0.0)
    p = tuple(p0[i] + e1[i] * u + e2[i] * v for i in range(3))
    ng = _normalize(_cross(e1, e2))
    w = 1.0 - u - v
    n0, n1, n2 = (_cols(x[idx]) for x in (scene.n0, scene.n1, scene.n2))
    ns = _normalize(tuple(n0[i] * w + n1[i] * u + n2[i] * v
                          for i in range(3)))
    frame = _frame(ns)
    wi = _to_local(frame, tuple(-c for c in d))
    shape = torch.where(valid, scene.prim_shape[idx], -1)
    return Hit(valid=valid, p=p, n=ng, frame=frame, wi=wi, shape=shape)


def _rows(table, idx):
    """table[idx], (N, C). Under autograd a sum of one masked row a
    table row, whose backward is a reduction a row: the backward of an
    indexed gather adds millions of lanes atomically into a few rows."""
    if not table.requires_grad:
        return table[idx]
    out = torch.zeros((idx.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    for r in range(table.shape[0]):
        out = out + torch.where((idx == r)[:, None], table[r], 0.0)
    return out


def _emitted(scene: Scene, hit: Hit, radiance):
    """Area radiance toward the viewer; zero from the back side."""
    e_idx = scene.shape_emitter[torch.clamp_min(hit.shape, 0)]
    on = hit.valid & (hit.shape >= 0) & (e_idx >= 0) & (hit.wi[2] > 0)
    return torch.where(on[:, None], _rows(radiance, torch.clamp_min(e_idx, 0)),
                       0.0)


def _disk(ua, ub):
    """Shirley-Chiu concentric mapping of the square to the disk."""
    x = 2.0 * ua - 1.0
    y = 2.0 * ub - 1.0
    zero = (x == 0.0) & (y == 0.0)
    q13 = x.abs() < y.abs()
    r = torch.where(q13, y, x)
    rp = torch.where(q13, x, y)
    phi = 0.25 * math.pi * rp / torch.where(r == 0.0, 1.0, r)
    phi = torch.where(q13, 0.5 * math.pi - phi, phi)
    phi = torch.where(zero, 0.0, phi)
    return r * torch.cos(phi), r * torch.sin(phi)


def trace(scene: Scene, cfg: dict, seed: int, lanes: torch.Tensor,
          reflectance=None, radiance=None, queries=None) -> torch.Tensor:
    """The radiance of each of `lanes` (ids in the pass's spp x H x W
    layout) in a render seeded `seed`, (N, 3). `reflectance` and
    `radiance`, where given, replace the scene's tables (the gradient
    flows to them); `queries` answers the traversals (Queries)."""
    if cfg["spp_per_pass"] < cfg["spp"]:
        raise ValueError("the reference renders one pass")
    q = queries or Queries(scene)
    H, W = cfg["height"], cfg["width"]
    depth = cfg["max_depth"]
    if cfg["rr_depth"] < depth:
        raise ValueError("the reference draws no Russian roulette: "
                         "rr_depth must be >= max_depth")
    dt = scene.dtype
    refl = scene.reflectance if reflectance is None else reflectance
    rad = scene.radiance if radiance is None else radiance
    E = scene.emitter_prim.shape[0]
    rng = pcg32.independent(pcg32.pass_seed(seed), lanes)

    def u1():
        return rng.next_float().to(dt)

    pix = lanes % (H * W)
    x, y = (pix % W).to(dt), (pix // W).to(dt)
    jx, jy = u1(), u1()
    u = (x + jx) / W
    v = (y + jy) / W + 0.5 * (1.0 - H / W)
    cx = (1.0 - 2.0 * u) * scene.tan_half
    cy = (1.0 - 2.0 * v) * scene.tan_half
    M = scene.cam
    d = tuple(M[r, 0] * cx + M[r, 1] * cy + M[r, 2] for r in range(3))
    inv = torch.rsqrt(torch.clamp_min(_dot(d, d), torch.finfo(dt).tiny))
    d = tuple(c * inv for c in d)
    o = tuple(M[r, 3].expand_as(cx) for r in range(3))
    inf = torch.full_like(cx, float("inf"))
    hit = _intersect(scene, o, d, q.closest(o, d, inf))
    result = _emitted(scene, hit, rad)
    active = hit.valid
    throughput = torch.ones_like(result)
    for _ in range(1, depth):
        mat = scene.shape_mat[torch.clamp_min(hit.shape, 0)]
        albedo = _rows(refl, mat)
        # next-event estimation: an emitter, a point on its triangle
        u_nee, ua, ub = u1(), u1(), u1()
        e_idx = torch.clamp((u_nee * E).to(torch.int32), 0, E - 1).long()
        ep = scene.emitter_prim[e_idx]
        q0, f1, f2 = (_cols(x[ep]) for x in (scene.p0, scene.e1, scene.e2))
        tt = torch.sqrt(torch.clamp_min(1.0 - ua, 0.0))
        b0, b1 = 1.0 - tt, tt * ub
        pe = tuple(q0[i] + f1[i] * b0 + f2[i] * b1 for i in range(3))
        ne = _normalize(_cross(f1, f2))
        dv = tuple(pe[i] - hit.p[i] for i in range(3))
        dist2 = _dot(dv, dv)
        dist = torch.sqrt(torch.clamp_min(dist2, 1e-30))
        inv_dist = 1.0 / dist
        dl = tuple(c * inv_dist for c in dv)
        cos_e = -_dot(ne, dl)
        pdf_area = 1.0 / torch.clamp_min(scene.emitter_area[e_idx], 1e-20)
        pdf_sa = (1.0 / E) * pdf_area * dist2 / torch.clamp_min(cos_e, 1e-20)
        ok = cos_e > 0
        zero = torch.zeros_like(dist)
        dl = _where(ok, dl, (zero, zero, zero))
        dist = torch.where(ok, dist, float("inf"))
        pdf_nee = torch.where(ok, pdf_sa, 0.0)
        e_val = torch.where(ok[:, None], _rows(rad, e_idx), 0.0)
        nee_active = active & (pdf_nee > 0)
        so = _spawn(hit.p, hit.n, dl)
        smax = torch.where(nee_active, dist * (1.0 - 1e-3), 0.0)
        # the diffuse sample: cosine-weighted, weight = the albedo
        ub1, ua2, ub2 = u1(), u1(), u1()
        del ub1   # the BSDF's 1D draw: a diffuse BSDF has one lobe
        cos_i = hit.wi[2]
        px, py = _disk(ua2, ub2)
        pz = torch.sqrt(torch.clamp_min(1.0 - (px * px + py * py), 0.0))
        front = cos_i > 0
        bs_pdf = torch.where(front, torch.where(pz >= 0, pz * INV_PI, 0.0),
                             0.0)
        b_weight = torch.where(front[:, None], albedo, 0.0)
        bd = _to_world(hit.frame, (px, py, pz))
        no = _spawn(hit.p, hit.n, bd)
        occluded = q.occluded(so, dl, smax)
        wo = _to_local(hit.frame, dl)
        both = front & (wo[2] > 0)
        f_val = torch.where(both[:, None], albedo * (INV_PI * wo[2])[:, None],
                            0.0)
        f_pdf = torch.where(both, wo[2] * INV_PI, 0.0)
        w_nee = _mis(pdf_nee, f_pdf)
        contrib = throughput * e_val * f_val * (
            w_nee / torch.clamp_min(pdf_nee, 1e-20))[:, None]
        result = result + torch.where((nee_active & ~occluded)[:, None],
                                      contrib, 0.0)
        throughput = throughput * torch.where(active[:, None], b_weight, 1.0)
        active = active & (bs_pdf > 0) & (b_weight > 0).any(-1)
        nxt = _intersect(scene, no, bd,
                         q.closest(no, bd, torch.where(active, inf, 0.0)))
        # the emitter hit along the sampled direction, MIS against NEE
        e_hit = scene.shape_emitter[torch.clamp_min(nxt.shape, 0)]
        dv = tuple(nxt.p[i] - hit.p[i] for i in range(3))
        dist2 = _dot(dv, dv)
        dist = torch.sqrt(torch.clamp_min(dist2, 1e-30))
        cos_h = _dot(nxt.n, tuple(c * (-1.0 / dist) for c in dv))
        good = nxt.valid & (nxt.shape >= 0) & (e_hit >= 0) & (cos_h > 0)
        area = scene.emitter_area[torch.clamp_min(e_hit, 0)]
        denom = torch.where(good, cos_h * area, 1.0)
        em_pdf = (1.0 / E) * torch.where(good, dist2, 0.0) / \
            torch.clamp_min(denom, 1e-20)
        em_pdf = torch.where(nxt.valid, em_pdf, 0.0)
        w_bsdf = _mis(bs_pdf, em_pdf)
        L = _emitted(scene, nxt, rad)
        result = result + torch.where(active[:, None],
                                      throughput * L * w_bsdf[:, None], 0.0)
        active = active & nxt.valid
        hit = nxt
    return result


def pixel_lanes(cfg: dict, pixels: torch.Tensor) -> torch.Tensor:
    """The lanes of `pixels` (flat ids y * W + x), (spp, n) flattened."""
    n_pix = cfg["height"] * cfg["width"]
    s = torch.arange(cfg["spp"], device=pixels.device)
    return (s[:, None] * n_pix + pixels[None, :]).reshape(-1)


def render_pixels(scene: Scene, cfg: dict, seed: int, pixels: torch.Tensor,
                  chunk: int = 1 << 23, **tables) -> torch.Tensor:
    """The developed value of each of `pixels`, (n, 3): the mean of its
    spp lanes."""
    spp = cfg["spp"]
    lanes = pixel_lanes(cfg, pixels)
    out = torch.cat([trace(scene, cfg, seed, lanes[i:i + chunk], **tables)
                     for i in range(0, lanes.numel(), chunk)])
    return out.reshape(spp, -1, 3).sum(0) / spp


def render(scene: Scene, cfg: dict, seed: int, chunk: int = 1 << 24,
           **tables) -> torch.Tensor:
    """The whole image, (H, W, 3)."""
    H, W = cfg["height"], cfg["width"]
    img = torch.zeros((H * W, 3), dtype=scene.dtype, device=scene.p0.device)
    n = cfg["spp"] * H * W
    for i in range(0, n, chunk):
        lanes = torch.arange(i, min(i + chunk, n), device=img.device)
        img.index_add_(0, lanes % (H * W),
                       trace(scene, cfg, seed, lanes, **tables))
    return (img / cfg["spp"]).reshape(H, W, 3)


def l2_grad(scene: Scene, cfg: dict, seed: int, target: torch.Tensor,
            chunk: int = 1 << 23):
    """The image, the loss mean((image - target)^2) and its gradients
    with respect to the reflectance and radiance tables: the image
    without a tape, then each chunk of lanes again under autograd, on
    the same paths, with dLoss/dImage as its output gradient."""
    H, W = cfg["height"], cfg["width"]
    n = cfg["spp"] * H * W
    dev = scene.p0.device
    img = torch.zeros((H * W, 3), dtype=scene.dtype, device=dev)
    records = []
    with torch.no_grad():
        for i in range(0, n, chunk):
            lanes = torch.arange(i, min(i + chunk, n), device=dev)
            q = Queries(scene)
            img.index_add_(0, lanes % (H * W),
                           trace(scene, cfg, seed, lanes, queries=q))
            records.append(q.record)
        image = (img / cfg["spp"]).reshape(H, W, 3)
        diff = image - target
        loss = (diff * diff).mean()
        ct = (2.0 * diff / diff.numel() / cfg["spp"]).reshape(-1, 3)
    refl = scene.reflectance.detach().clone().requires_grad_(True)
    rad = scene.radiance.detach().clone().requires_grad_(True)
    for i, rec in zip(range(0, n, chunk), records):
        lanes = torch.arange(i, min(i + chunk, n), device=dev)
        with torch.enable_grad():
            L = trace(scene, cfg, seed, lanes, reflectance=refl,
                      radiance=rad, queries=Queries(scene, rec))
            (L * ct[lanes % (H * W)]).sum().backward()
    return image, loss, {"reflectance": refl.grad, "radiance": rad.grad}
