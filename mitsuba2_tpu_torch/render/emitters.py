"""Emitters: packing, evaluation, NEE sampling and pdfs (counterpart of
render/emitters.py): area, point, constant, envmap, spot, directional and
projector emitters. An area emitter's radiance and a projector's
irradiance may be textures (render/texture.py), read at the emitter
point's uv and at the projector's frustum uv.

Emitter row layout (EMIT_W = 16):
    [0:8]   radiance / intensity / irradiance spectrum slot (spectra.py)
    [8:11]  position (point, spot, projector)
    [11:14] direction (spot, directional, projector)
    [14:16] scalars (spot: cos cutoff, cos beam; projector: tan of half
            the fov, aspect)
A scene holds at most one environment emitter (constant or envmap,
`scene.env_emitter`); an envmap's image and importance tables live
beside the rows (`scene.envmap`, EnvMapData). Sampling picks an emitter
uniformly and runs the sampler of each kind the scene holds
(`scene.emitter_kinds`) over every lane, masked, as the JAX package does.
"""
from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from ..core import math as m
from ..core import spectrum as sp
from ..core import warp
from ..core.distr import FIELDS as DISTR_FIELDS, Marginal2D
from ..core.geometry import Frame, coordinate_system
from ..core.spec import Spec, swhere
from ..core.vec import Vec2, Vec3, vdot, vwhere
from ..scene.shapes import PRIM_TRI
from .interaction import DirectionSample
from .spectra import (LaneRows, SLOT_W, _tex_value, eval_spectrum_slot,
                      gather_columns, lane_gather, pack_color)

EMIT_W = 16
AREA = 0
POINT = 1
CONSTANT = 2
ENVMAP = 3
SPOT = 4
DIRECTIONAL = 5
PROJECTOR = 6
# the far-away distance of infinite emitters (constant, envmap,
# directional): the JAX package's; the reference uses 2 x the scene's
# bounding radius
_INF_DIST = 1e7
# the differentiable parameter of each emitter type (SceneData.param_paths)
PARAM_NAME = {AREA: "radiance", POINT: "intensity", CONSTANT: "radiance",
              SPOT: "intensity", DIRECTIONAL: "irradiance",
              PROJECTOR: "irradiance"}
# an envmap's host tables, the keys scene_from_numpy carries it by: the
# image, its importance table (core/distr.py's Marginal2D fields), the
# rotation, the scale and the per-texel spectral coefficients
ENV_FIELDS = ("image",) + DISTR_FIELDS + ("to_world", "scale", "coeffs")


@dataclasses.dataclass
class EnvMapData:
    """A lat-long environment map (src/emitters/envmap.cpp): the radiance
    image, its luminance x sin(theta) importance table, the
    emitter-to-world rotation, the overall scale, and per-texel
    sigmoid-polynomial coefficients [c2, c1, c0, hdr scale] fitted at the
    build, which spectral mode's eval interpolates."""
    image: torch.Tensor      # (H, W, 3) linear RGB radiance
    distr: Marginal2D        # importance over [0, 1]^2 uv
    to_world: torch.Tensor   # (3, 3) rotation
    scale: torch.Tensor      # ()
    coeffs: torch.Tensor     # (H, W, 4)

    def to(self, device) -> "EnvMapData":
        return EnvMapData(image=self.image.to(device),
                          distr=self.distr.to(device),
                          to_world=self.to_world.to(device),
                          scale=self.scale.to(device),
                          coeffs=self.coeffs.to(device))


def build_envmap(desc: dict) -> dict:
    """Host: envmap descriptor -> its tables (ENV_FIELDS) as numpy arrays,
    byte-equal to the JAX package's EnvMapData. The importance table
    carries alias tables unless MI_ENVMAP_ALIAS (the JAX package's
    switch, read here) is not "1": then NEE inverts its CDFs."""
    if "data" in desc:
        img = np.asarray(desc["data"], np.float32)
    else:   # read as stored: the JAX package linearises no envmap file
        from ..core import io_bitmap
        img = io_bitmap.read(desc["filename"])
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    img = img[..., :3].astype(np.float32)
    H, W = img.shape[:2]
    lum = img @ np.array([0.2126, 0.7152, 0.0722], np.float32)
    theta = (np.arange(H) + 0.5) / H * np.pi
    weight = np.maximum(lum, 0) * np.sin(theta)[:, None]
    tw = desc.get("to_world")
    rot = (np.asarray(tw, np.float32).reshape(-1)[:12].reshape(3, 4)[:, :3]
           if tw is not None else np.eye(3, dtype=np.float32))
    use_alias = os.environ.get("MI_ENVMAP_ALIAS", "1") == "1"
    cf, scales = sp.fit_srgb_model_batch(img.reshape(-1, 3))
    coeffs = np.concatenate(
        [np.asarray(cf, np.float32),
         np.asarray(scales, np.float32)[:, None]], axis=1).reshape(H, W, 4)
    return dict(image=img, **Marginal2D.build_numpy(weight, alias=use_alias),
                to_world=np.asarray(rot, np.float32),
                scale=np.float32(desc.get("scale", 1.0)), coeffs=coeffs)


def envmap_from_numpy(tabs: dict, device) -> EnvMapData:
    """An envmap's host tables (ENV_FIELDS) -> EnvMapData on `device`."""
    def up(a):
        return torch.from_numpy(np.array(a, order="C")).to(device)
    return EnvMapData(
        image=up(tabs["image"]),
        distr=Marginal2D.from_numpy({k: tabs[k] for k in DISTR_FIELDS},
                                    device),
        to_world=up(tabs["to_world"]), scale=up(tabs["scale"]),
        coeffs=up(tabs["coeffs"]))


def _unit(v) -> np.ndarray:
    d = np.asarray(v, np.float32)
    return d / max(np.linalg.norm(d), 1e-20)


def pack_emitter(desc: dict):
    """Host: emitter descriptor -> (type id, packed row, the envmap's
    tables or None)."""
    row = np.zeros(EMIT_W, np.float32)
    t = desc.get("type")
    if t == "envmap":
        return ENVMAP, row, build_envmap(desc)
    key = {"area": "radiance", "constant": "radiance", "point": "intensity",
           "spot": "intensity", "directional": "irradiance",
           "projector": "irradiance"}.get(t)
    if key is None:
        raise ValueError(f"unknown emitter type {t!r}")
    row[0:SLOT_W] = pack_color(desc.get(key, [1, 1, 1]), illuminant=True)
    if t in ("point", "spot", "projector"):
        row[8:11] = np.asarray(desc.get("position", [0, 0, 0]), np.float32)
    if t in ("spot", "directional", "projector"):
        row[11:14] = _unit(desc.get("direction", [0, 0, 1]))
    if t == "spot":
        cutoff = float(desc.get("cutoff_angle", 20.0))
        beam = float(desc.get("beam_width", cutoff * 0.75))
        row[14] = np.cos(np.deg2rad(cutoff))
        row[15] = np.cos(np.deg2rad(beam))
    if t == "projector":
        row[14] = np.tan(np.deg2rad(float(desc.get("fov", 45.0))) * 0.5)
        row[15] = float(desc.get("aspect", 1.0))  # tan_y = aspect * tan_x
    return {"area": AREA, "constant": CONSTANT, "point": POINT,
            "spot": SPOT, "directional": DIRECTIONAL,
            "projector": PROJECTOR}[t], row, None


# ---------------------------------------------------------------------------
# Envmap direction <-> uv (envmap.cpp's y-up lat-long)
# ---------------------------------------------------------------------------

def _envmap_dir_to_uv(env: EnvMapData, d: Vec3) -> Vec2:
    tw = env.to_world   # world -> local by the transpose (a rotation)
    dx = tw[0, 0] * d.x + tw[1, 0] * d.y + tw[2, 0] * d.z
    dy = tw[0, 1] * d.x + tw[1, 1] * d.y + tw[2, 1] * d.z
    dz = tw[0, 2] * d.x + tw[1, 2] * d.y + tw[2, 2] * d.z
    u = torch.atan2(dx, -dz) * (0.5 / math.pi)
    u = torch.where(u < 0, u + 1.0, u)
    return Vec2(u, m.safe_acos(dy) / math.pi)


def _envmap_uv_to_dir(env: EnvMapData, uv: Vec2) -> Vec3:
    phi = uv.x * (2 * math.pi)
    theta = uv.y * math.pi
    st, ct = torch.sin(theta), torch.cos(theta)
    lx, ly, lz = st * torch.sin(phi), ct, -st * torch.cos(phi)
    tw = env.to_world
    return Vec3(tw[0, 0] * lx + tw[0, 1] * ly + tw[0, 2] * lz,
                tw[1, 0] * lx + tw[1, 1] * ly + tw[1, 2] * lz,
                tw[2, 0] * lx + tw[2, 1] * ly + tw[2, 2] * lz)


def _envmap_bilinear_rows(img, uv: Vec2, gain=1.0):
    """Bilinear fetch of an (H, W, C) lat-long image at per-lane uv, the
    azimuth wrapping: a C-tuple of (N,) channels. Under autograd each
    channel of each corner is one _LaneGather (most NEE lanes land on the
    few sun texels), else each corner one row gather."""
    H, W, C = img.shape
    x = uv.x * W - 0.5
    y = torch.clamp(uv.y * H - 0.5, 0.0, H - 1.0)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    y0 = torch.clamp(y0, 0, H - 1)
    x0w = torch.remainder(x0, W)
    x1w = torch.remainder(x0 + 1, W)
    flat = img.reshape(H * W, C)
    idx = (y0 * W + x0w, y0 * W + x1w, y1 * W + x0w, y1 * W + x1w)
    if torch.is_grad_enabled() and flat.requires_grad:
        r = [[lane_gather(flat[:, c], i) for c in range(C)] for i in idx]
    else:
        r = [flat.index_select(0, i).unbind(1) for i in idx]
    return tuple(((r[0][c] * (1 - fx) + r[1][c] * fx) * (1 - fy)
                  + (r[2][c] * (1 - fx) + r[3][c] * fx) * fy) * gain
                 for c in range(C))


def envmap_eval(env: EnvMapData, d: Vec3, wavelengths, color_mode) -> Spec:
    """The envmap's radiance toward -d. Spectral mode interpolates the
    baked per-texel coefficients; NEE's _sample_envmap upsamples the
    interpolated RGB through the lattice instead (the JAX package's two
    paths, kept)."""
    uv = _envmap_dir_to_uv(env, d)
    if color_mode == "spectral":
        c2, c1, c0, hs = _envmap_bilinear_rows(env.coeffs, uv)
        gain = hs * env.scale
        return Spec(tuple(sp.srgb_model_eval_t(c2, c1, c0, w) * gain
                          for w in wavelengths.ch))
    return _tex_value(Spec(_envmap_bilinear_rows(env.image, uv, env.scale)),
                      wavelengths, color_mode)


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

def eval_hit(scene, si, config) -> Spec:
    """Area radiance toward the viewer (a texture read at the hit's uv,
    level 0); zero from the back side."""
    e_idx = scene.shape_emitter[torch.clamp_min(si.shape, 0)]
    has_e = si.valid & (si.shape >= 0) & (e_idx >= 0)
    row = LaneRows(scene.emitter_data, torch.clamp_min(e_idx, 0))
    front = Frame.cos_theta(si.wi) > 0
    tex = si.tex if AREA in scene.emitter_tex else None
    return eval_spectrum_slot(row, si.wavelengths, config.color_mode,
                              tex=tex, uv=si.uv).masked(has_e & front)


def eval_env(scene, d_world: Vec3, wavelengths, config) -> Spec:
    """Environment radiance for escaped rays: the envmap's or the constant
    emitter's, zero without one."""
    n, dev = d_world.z.shape[0], d_world.z.device
    if scene.env_emitter < 0:
        return Spec.zeros(n, config.n_channels, dev)
    if scene.envmap is not None:
        return envmap_eval(scene.envmap, d_world, wavelengths,
                           config.color_mode)
    idx = torch.full((n,), scene.env_emitter, dtype=torch.int64, device=dev)
    return eval_spectrum_slot(LaneRows(scene.emitter_data, idx), wavelengths,
                              config.color_mode)


# ---------------------------------------------------------------------------
# NEE sampling (Scene::sample_emitter_direction)
# ---------------------------------------------------------------------------

def sample_direction(scene, ref_p: Vec3, wavelengths, u1, u2, config):
    """Pick an emitter uniformly and sample a direction toward it; returns
    the DirectionSample (solid-angle pdf with the 1/E pick) and the
    radiance, not divided by the pdf. Visibility is not tested here."""
    n, dev = ref_p.z.shape[0], ref_p.z.device
    E = scene.n_emitters
    z = torch.zeros(n, dtype=torch.float32, device=dev)
    ds = DirectionSample(
        d=Vec3(z, z, z), dist=torch.full((n,), float("inf"), device=dev),
        pdf=z, delta=torch.zeros(n, dtype=torch.bool, device=dev))
    val = Spec.zeros(n, config.n_channels, dev)
    if E == 0:
        return ds, val
    scaled = u1 * E
    e_idx = torch.clamp(scaled.to(torch.int32), 0, E - 1)
    etype = scene.emitter_type[e_idx]
    row = LaneRows(scene.emitter_data, e_idx)
    pick = 1.0 / E
    kinds = scene.emitter_kinds
    if AREA in kinds:
        ds, val = _sample_area(scene, ref_p, wavelengths, e_idx, etype, row,
                               scaled, u2, pick, ds, val, config)
    if POINT in kinds:
        ds, val = _sample_point(ref_p, wavelengths, etype, row, pick, ds,
                                val, config)
    if CONSTANT in kinds:
        ds, val = _sample_constant(wavelengths, etype, row, u2, pick, ds,
                                   val, config)
    if ENVMAP in kinds:
        ds, val = _sample_envmap(scene, wavelengths, etype, u2, pick, ds,
                                 val, config)
    if SPOT in kinds:
        ds, val = _sample_spot(ref_p, wavelengths, etype, row, pick, ds,
                               val, config)
    if DIRECTIONAL in kinds:
        ds, val = _sample_directional(wavelengths, etype, row, pick, ds,
                                      val, config)
    if PROJECTOR in kinds:
        ds, val = _sample_projector(scene, ref_p, wavelengths, etype, row,
                                    pick, ds, val, config)
    return ds, val


def _delta_sample(sel, ok, d, dist, pick, ds):
    """A delta emitter's DirectionSample on the lanes `sel` picked: pdf
    the pick's where `ok`, else 0."""
    return DirectionSample(
        d=vwhere(sel, d, ds.d), dist=torch.where(sel, dist, ds.dist),
        pdf=torch.where(ok, pick, torch.where(sel, 0.0, ds.pdf)),
        delta=torch.where(sel, True, ds.delta))


def _sample_point(ref_p, wavelengths, etype, row, pick, ds, val, config):
    """Point light (emitters/point.cpp): a delta position."""
    is_point = etype == POINT
    p_l = Vec3(row.col(8), row.col(9), row.col(10))
    d_vec = p_l - ref_p
    dist2 = vdot(d_vec, d_vec)
    dist = torch.sqrt(torch.clamp_min(dist2, 1e-30))
    intensity = eval_spectrum_slot(row, wavelengths, config.color_mode)
    ds = _delta_sample(is_point, is_point, d_vec * (1.0 / dist), dist, pick,
                       ds)
    return ds, swhere(is_point, intensity / torch.clamp_min(dist2, 1e-20),
                      val)


def _sample_constant(wavelengths, etype, row, u2, pick, ds, val, config):
    """Constant environment (emitters/constant.cpp): a uniform direction
    on the sphere, at _INF_DIST."""
    is_const = etype == CONSTANT
    d_c = warp.square_to_uniform_sphere(*u2)
    ds = DirectionSample(
        d=vwhere(is_const, d_c, ds.d),
        dist=torch.where(is_const, _INF_DIST, ds.dist),
        pdf=torch.where(is_const, pick * warp.INV_FOUR_PI, ds.pdf),
        delta=ds.delta)
    return ds, swhere(is_const, eval_spectrum_slot(row, wavelengths,
                                                   config.color_mode), val)


def _sample_envmap(scene, wavelengths, etype, u2, pick, ds, val, config):
    """Importance-sample the envmap's luminance table (envmap.cpp's
    sample_direction); the radiance upsampled through the lattice."""
    env = scene.envmap
    uv, pdf_uv = env.distr.sample(Vec2(*u2))
    d_w = _envmap_uv_to_dir(env, uv)
    sin_theta = torch.sin(uv.y * math.pi)
    pdf_sa = pick * pdf_uv / torch.clamp_min(
        2.0 * math.pi * math.pi * sin_theta, 1e-20)
    rgb = Spec(_envmap_bilinear_rows(env.image, uv, env.scale))
    radiance = _tex_value(rgb, wavelengths, config.color_mode)
    ok = (etype == ENVMAP) & (pdf_sa > 0) & (sin_theta > 0)
    ds = DirectionSample(
        d=vwhere(ok, d_w, ds.d), dist=torch.where(ok, _INF_DIST, ds.dist),
        pdf=torch.where(ok, pdf_sa, ds.pdf), delta=ds.delta)
    return ds, swhere(ok, radiance, val)


def _sample_spot(ref_p, wavelengths, etype, row, pick, ds, val, config):
    """Spot light (emitters/spot.cpp): a delta position, the falloff
    linear in the cosine between beam_width and cutoff_angle."""
    is_spot = etype == SPOT
    p_l = Vec3(row.col(8), row.col(9), row.col(10))
    spot_d = Vec3(row.col(11), row.col(12), row.col(13))
    cos_cutoff, cos_beam = row.col(14), row.col(15)
    d_vec = p_l - ref_p
    dist2 = vdot(d_vec, d_vec)
    dist = torch.sqrt(torch.clamp_min(dist2, 1e-30))
    d_unit = d_vec * (1.0 / dist)
    cos_a = vdot(spot_d, -d_unit)   # the spot's axis against the way to ref
    falloff = sp._clip((cos_a - cos_cutoff) / torch.clamp_min(
        cos_beam - cos_cutoff, 1e-8), 0.0, 1.0)
    intensity = eval_spectrum_slot(row, wavelengths, config.color_mode)
    v = intensity * (falloff / torch.clamp_min(dist2, 1e-20))
    ok = is_spot & (cos_a > cos_cutoff)
    ds = _delta_sample(is_spot, ok, d_unit, dist, pick, ds)
    return ds, swhere(ok, v, swhere(is_spot, 0.0, val))


def _sample_directional(wavelengths, etype, row, pick, ds, val, config):
    """Directional emitter (emitters/directional.cpp): a delta direction,
    `irradiance` through a unit surface facing it."""
    is_dir = etype == DIRECTIONAL
    d_unit = -Vec3(row.col(11), row.col(12), row.col(13))
    irradiance = eval_spectrum_slot(row, wavelengths, config.color_mode)
    dist = torch.full_like(d_unit.x, _INF_DIST)
    ds = _delta_sample(is_dir, is_dir, d_unit, dist, pick, ds)
    return ds, swhere(is_dir, irradiance, val)


def _sample_projector(scene, ref_p, wavelengths, etype, row, pick, ds, val,
                      config):
    """Projector (emitters/projector.cpp): a delta position, the
    irradiance (a texture read at the frustum uv of the reference point)
    scaled 1/dist^2 inside the pinhole frustum, zero outside it."""
    is_proj = etype == PROJECTOR
    p_l = Vec3(row.col(8), row.col(9), row.col(10))
    fwd = Vec3(row.col(11), row.col(12), row.col(13))
    tan_x = row.col(14)
    tan_y = row.col(15) * tan_x
    s_ax, t_ax = coordinate_system(fwd)
    v = ref_p - p_l
    z, x, y = vdot(v, fwd), vdot(v, s_ax), vdot(v, t_ax)
    dist2 = vdot(v, v)
    dist = torch.sqrt(torch.clamp_min(dist2, 1e-30))
    d_unit = v * (-1.0 / dist)   # from ref toward the projector
    # behind the projector (z <= 0, never inside) the frustum uv divides
    # by 1 instead of 1e-20: finite derivatives for a textured slide
    zc = torch.clamp_min(torch.where(z > 0, z, 1.0), 1e-20)
    u_f = 0.5 * (x / (zc * torch.clamp_min(tan_x, 1e-8)) + 1.0)
    v_f = 0.5 * (y / (zc * torch.clamp_min(tan_y, 1e-8)) + 1.0)
    inside = (z > 0) & (u_f >= 0) & (u_f <= 1) & (v_f >= 0) & (v_f <= 1)
    tex = scene.textures if PROJECTOR in scene.emitter_tex else None
    if tex is not None:
        # a slide is read inside the frustum alone: far off it the texel
        # arithmetic overflows, and the zero cotangent of the discarded
        # value times its infinite derivative would be NaN in
        # emitter_data's gradient
        u_f = torch.where(inside, u_f, 0.5)
        v_f = torch.where(inside, v_f, 0.5)
    irr = eval_spectrum_slot(row, wavelengths, config.color_mode,
                             tex=tex, uv=Vec2(u_f, v_f))
    ok = is_proj & inside
    ds = _delta_sample(is_proj, ok, d_unit, dist, pick, ds)
    return ds, swhere(ok, irr / torch.clamp_min(dist2, 1e-20),
                      swhere(is_proj, 0.0, val))


def _sample_area(scene, ref_p, wavelengths, e_idx, etype, row, scaled, u2,
                 pick, ds, val, config):
    total = scene.emitter_area[e_idx]
    Fmax = scene.emitter_prims.shape[1]
    target = (scaled - e_idx) * total
    flat_cdf = scene.emitter_prim_cdf.reshape(-1)
    base = e_idx.to(torch.int64) * Fmax
    # per-lane bisection over the padded CDF row: the count of entries
    # below the target, as the JAX package's scan and bisection find it
    lo = torch.zeros_like(base)
    hi = torch.full_like(base, Fmax)
    for _ in range(int(np.ceil(np.log2(max(Fmax, 2)))) + 1):
        mid = torch.clamp_max((lo + hi) // 2, Fmax - 1)
        go_right = flat_cdf[base + mid] < target
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    slot = torch.clamp(lo, 0, Fmax - 1)
    prim = scene.emitter_prims.reshape(-1)[base + slot]
    pc = torch.clamp_min(prim, 0)

    p0x, p0y, p0z = gather_columns(scene.prim_p0, pc, 3)
    e1x, e1y, e1z = gather_columns(scene.prim_e1, pc, 3)
    e2x, e2y, e2z = gather_columns(scene.prim_e2, pc, 3)
    b0, b1 = warp.square_to_uniform_triangle(*u2)
    uv = None
    if AREA in scene.emitter_tex:
        # the point's uv, for a textured radiance (a sphere's: u2)
        bw = 1.0 - b0 - b1
        uv0, uv1, uv2 = (t[pc].unbind(1) for t in (
            scene.prim_uv0, scene.prim_uv1, scene.prim_uv2))
        uv = Vec2(uv0[0] * bw + uv1[0] * b0 + uv2[0] * b1,
                  uv0[1] * bw + uv1[1] * b0 + uv2[1] * b1)
    px = p0x + e1x * b0 + e2x * b1
    py = p0y + e1y * b0 + e2y * b1
    pz = p0z + e1z * b0 + e2z * b1
    cx = e1y * e2z - e1z * e2y
    cy = e1z * e2x - e1x * e2z
    cz = e1x * e2y - e1y * e2x
    inv = 1.0 / torch.sqrt(torch.clamp_min(cx * cx + cy * cy + cz * cz, 1e-30))
    nx, ny, nz = cx * inv, cy * inv, cz * inv
    if scene.has_spheres:
        # a point uniform on the sphere (center p0, radius e1.x); e1.y < 0
        # marks flip_normals spheres, which emit inward
        is_sph = scene.prim_type[pc] != PRIM_TRI
        s = warp.square_to_uniform_sphere(*u2)
        px = torch.where(is_sph, p0x + s.x * e1x, px)
        py = torch.where(is_sph, p0y + s.y * e1x, py)
        pz = torch.where(is_sph, p0z + s.z * e1x, pz)
        sgn = torch.where(e1y < 0, -1.0, 1.0)
        nx = torch.where(is_sph, s.x * sgn, nx)
        ny = torch.where(is_sph, s.y * sgn, ny)
        nz = torch.where(is_sph, s.z * sgn, nz)
        if uv is not None:
            uv = Vec2(torch.where(is_sph, u2[0], uv.x),
                      torch.where(is_sph, u2[1], uv.y))
    dvx, dvy, dvz = px - ref_p.x, py - ref_p.y, pz - ref_p.z
    dist2 = dvx * dvx + dvy * dvy + dvz * dvz
    dist = torch.sqrt(torch.clamp_min(dist2, 1e-30))
    inv_dist = 1.0 / dist
    dux, duy, duz = dvx * inv_dist, dvy * inv_dist, dvz * inv_dist
    cos_e = -(nx * dux + ny * duy + nz * duz)
    pdf_area = 1.0 / torch.clamp_min(total, 1e-20)
    pdf_sa = pick * pdf_area * dist2 / torch.clamp_min(cos_e, 1e-20)
    area_ok = (etype == AREA) & (cos_e > 0) & (prim >= 0)
    radiance = eval_spectrum_slot(row, wavelengths, config.color_mode,
                                  tex=scene.textures if uv is not None
                                  else None, uv=uv)
    ds = DirectionSample(
        d=vwhere(area_ok, Vec3(dux, duy, duz), ds.d),
        dist=torch.where(area_ok, dist, ds.dist),
        pdf=torch.where(area_ok, pdf_sa, ds.pdf),
        delta=ds.delta)
    return ds, swhere(area_ok, radiance, val)


def pdf_direction_hit(scene, ref_p: Vec3, si_hit, config) -> torch.Tensor:
    """Solid-angle NEE pdf of a BSDF-sampled direction that hit an
    emissive surface (for MIS)."""
    E = scene.n_emitters
    if E == 0:
        return torch.zeros_like(ref_p.z)
    e_idx = scene.shape_emitter[torch.clamp_min(si_hit.shape, 0)]
    valid = si_hit.valid & (si_hit.shape >= 0) & (e_idx >= 0)
    area = scene.emitter_area[torch.clamp_min(e_idx, 0)]
    d_vec = si_hit.p - ref_p
    dist2 = vdot(d_vec, d_vec)
    dist = torch.sqrt(torch.clamp_min(dist2, 1e-30))
    cos_e = vdot(si_hit.n, d_vec * (-1.0 / dist))
    good = valid & (cos_e > 0)
    denom = torch.where(good, cos_e * area, 1.0)
    return (1.0 / E) * torch.where(good, dist2, 0.0) / \
        torch.clamp_min(denom, 1e-20)


def pdf_direction_env(scene, d_world: Vec3) -> torch.Tensor:
    """NEE pdf of an escaped direction (for MIS) with the 1/E pick: the
    envmap's importance table's, else the constant emitter's uniform
    sphere's; zero without an environment emitter."""
    E = scene.n_emitters
    if E == 0 or scene.env_emitter < 0:
        return torch.zeros_like(d_world.z)
    if scene.envmap is not None:
        env = scene.envmap
        uv = _envmap_dir_to_uv(env, d_world)
        pdf_uv = env.distr.eval_pdf(uv)
        sin_theta = torch.sin(uv.y * math.pi)
        return pdf_uv / torch.clamp_min(
            2.0 * math.pi * math.pi * sin_theta, 1e-20) / E
    return torch.full_like(d_world.z, warp.INV_FOUR_PI / E)
