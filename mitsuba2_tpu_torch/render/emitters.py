"""Area and constant emitters: packing, evaluation, NEE sampling and
pdfs (counterpart of render/emitters.py).

Emitter row layout (EMIT_W = 16): [0:8] radiance slot, the rest unused by
these two kinds. A scene holds at most one environment emitter (the
constant one here, `scene.env_emitter`); envmaps and the delta emitters
come in a later slice, and building a scene with one raises.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import warp
from ..core.geometry import Frame
from ..core.spec import Spec, swhere
from ..core.vec import Vec3, vdot, vwhere
from ..scene.shapes import PRIM_TRI
from .interaction import DirectionSample
from .spectra import LaneRows, SLOT_W, eval_spectrum_slot, pack_color

EMIT_W = 16
AREA = 0
CONSTANT = 2
ENV_DIST = 1e7   # the constant emitter's sample distance, as in the JAX package
# the differentiable parameter of each emitter type (SceneData.param_paths)
PARAM_NAME = {AREA: "radiance", CONSTANT: "radiance"}


def pack_emitter(desc: dict):
    """Host: emitter descriptor -> (type id, packed row)."""
    t = desc.get("type")
    if t not in ("area", "constant"):
        raise NotImplementedError(
            f"mitsuba2_tpu_torch does not support {t!r} emitters yet")
    row = np.zeros(EMIT_W, np.float32)
    row[0:SLOT_W] = pack_color(desc.get("radiance", [1, 1, 1]),
                               illuminant=True)
    return (AREA if t == "area" else CONSTANT), row


def eval_hit(scene, si, config) -> Spec:
    """Area radiance toward the viewer; zero from the back side."""
    e_idx = scene.shape_emitter[torch.clamp_min(si.shape, 0)]
    has_e = si.valid & (si.shape >= 0) & (e_idx >= 0)
    row = LaneRows(scene.emitter_data, torch.clamp_min(e_idx, 0))
    front = Frame.cos_theta(si.wi) > 0
    return eval_spectrum_slot(row, config.color_mode).masked(has_e & front)


def eval_env(scene, d_world: Vec3, config) -> Spec:
    """Environment radiance for escaped rays: the constant emitter's, or
    zero without one."""
    n, dev = d_world.z.shape[0], d_world.z.device
    if scene.env_emitter < 0:
        return Spec.zeros(n, config.n_channels, dev)
    idx = torch.full((n,), scene.env_emitter, dtype=torch.int64, device=dev)
    return eval_spectrum_slot(LaneRows(scene.emitter_data, idx),
                              config.color_mode)


def sample_direction(scene, ref_p: Vec3, u1, u2, config):
    """Pick an emitter uniformly and sample a point on it; returns the
    DirectionSample (solid-angle pdf with the 1/E pick) and the radiance.
    Visibility is not tested here."""
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
    if AREA in scene.emitter_kinds:
        ds, val = _sample_area(scene, ref_p, e_idx, etype, row, scaled, u2,
                               1.0 / E, ds, val, config)
    if CONSTANT in scene.emitter_kinds:
        ds, val = _sample_constant(etype, row, u2, 1.0 / E, ds, val, config)
    return ds, val


def _sample_constant(etype, row, u2, pick_pdf, ds, val, config):
    """Constant environment (emitters/constant.cpp): a uniform direction
    on the sphere, at ENV_DIST."""
    is_const = etype == CONSTANT
    d_c = warp.square_to_uniform_sphere(*u2)
    ds = DirectionSample(
        d=vwhere(is_const, d_c, ds.d),
        dist=torch.where(is_const, ENV_DIST, ds.dist),
        pdf=torch.where(is_const, pick_pdf * warp.INV_FOUR_PI, ds.pdf),
        delta=ds.delta)
    return ds, swhere(is_const, eval_spectrum_slot(row, config.color_mode),
                      val)


def _sample_area(scene, ref_p, e_idx, etype, row, scaled, u2, pick_pdf,
                 ds, val, config):
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

    p0, e1, e2 = scene.prim_p0[pc], scene.prim_e1[pc], scene.prim_e2[pc]
    p0x, p0y, p0z = p0.unbind(1)
    e1x, e1y, e1z = e1.unbind(1)
    e2x, e2y, e2z = e2.unbind(1)
    b0, b1 = warp.square_to_uniform_triangle(*u2)
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
    dvx, dvy, dvz = px - ref_p.x, py - ref_p.y, pz - ref_p.z
    dist2 = dvx * dvx + dvy * dvy + dvz * dvz
    dist = torch.sqrt(torch.clamp_min(dist2, 1e-30))
    inv_dist = 1.0 / dist
    dux, duy, duz = dvx * inv_dist, dvy * inv_dist, dvz * inv_dist
    cos_e = -(nx * dux + ny * duy + nz * duz)
    pdf_area = 1.0 / torch.clamp_min(total, 1e-20)
    pdf_sa = pick_pdf * pdf_area * dist2 / torch.clamp_min(cos_e, 1e-20)
    area_ok = (etype == AREA) & (cos_e > 0) & (prim >= 0)
    radiance = eval_spectrum_slot(row, config.color_mode)
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
    """NEE pdf of an escaped direction (for MIS): the constant emitter's
    uniform-sphere pdf with the 1/E pick, zero without one."""
    if scene.n_emitters == 0 or scene.env_emitter < 0:
        return torch.zeros_like(d_world.z)
    return torch.full_like(d_world.z, warp.INV_FOUR_PI / scene.n_emitters)
