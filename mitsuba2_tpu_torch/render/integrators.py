"""The wavefront path tracer and the render driver (counterpart of
render/integrators.py).

`lax.scan` over bounces becomes a Python loop over bounces, and the
passes run as a Python loop with the JAX package's pass seeds, so both
packages draw the same PCG32 numbers in the same order: the pixel jitter
first, in spectral mode the hero wavelengths' draw, under the thin-lens
camera and the irradiance meter the aperture sample, under a keyframed
camera the shutter time, then per bounce u_nee, u2_nee, u1_b, u2_b
and, only when rr_depth < max_depth, u_rr; from the sampler the config
names (render/sampler.py), into the film under its filter
(render/film.py). A scene with media, or
RenderConfig(integrator="volpath" | "volpathmis"), goes through the
volumetric path tracer instead (render/volpath.py, its own stream
layout after the camera's draws).
Spectral mode carries four hero wavelengths a lane on its rays and
shading records and develops each lane to linear sRGB before the film.
On a scene with textures the camera rays carry differentials, scaled to
a sample's share of its pixel, so that the first hit's lookups are
mip-filtered; later hits carry a zero footprint (level 0), as in the
reference. Beside `render` stand the JAX package's other integrators:
direct, depth, aov, moment and stokes (`render_any` dispatches on
RenderConfig.integrator; stokes and the polarized transport are
render/stokes.py's). With RenderConfig(compact=True) each bounce
first permutes its wavefront (kernels/compact.py: dead lanes to the
back, live lanes in Morton order of their hit points) and the path's
radiance is put back in lane order at its end. `render_pass`'s
`lane_offset` shifts the lanes' global ids, the sampler streams' seeds,
so that ranks rendering a pass's samples apart draw what one process
draws (dist/sharding.py).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..config import RenderConfig
from ..core import spectrum as sp
from ..core.geometry import Ray
from ..core.spec import Spec, swhere
from ..core.vec import Vec2
from ..device import resolve_device
from ..scene.scene import needs_tape
from . import bsdf as bsdf_mod
from . import emitters, film as film_mod, sensors
from .sampler import Sampler, make_sampler
from .spectra import LaneRows, eval_spectrum_slot

M32 = 0xFFFFFFFF


def mis_weight(pdf_a, pdf_b):
    """Power heuristic, beta = 2 (path.cpp::mis_weight)."""
    a2 = pdf_a * pdf_a
    return torch.where(pdf_a > 0,
                       a2 / torch.clamp_min(a2 + pdf_b * pdf_b, 1e-38), 0.0)


def _path_bounce(scene, config: RenderConfig, depth: int, carry):
    """One bounce of path.cpp's loop: NEE (+MIS), BSDF sampling, the
    emitter hit along the new ray (+MIS), Russian roulette. carry = (si,
    active, throughput, result, sampler, orig): `orig` the lanes' places
    in the wavefront as it was made, which compaction permutes with the
    rest."""
    from ..scene import scene as scene_mod
    si, active, throughput, result, sampler, orig = carry
    if config.compact:
        from ..kernels import compact as compact_mod
        perm = compact_mod.compaction_order(active, si.p, scene.bvh_min[0],
                                            scene.bvh_max[0])
        # the scene's atlas rides on si and is no lane's: kept out
        tex, si = si.tex, dataclasses.replace(si, tex=None)
        si, active, throughput, result, sampler, orig = compact_mod.permute(
            (si, active, throughput, result, sampler, orig), perm)
        si.tex = tex

    flags = bsdf_mod.lane_flags(scene, si)
    is_smooth = (flags & bsdf_mod.F_SMOOTH) != 0
    u_nee, sampler = sampler.next_1d()
    u2_nee, sampler = sampler.next_2d()
    ds, e_val = emitters.sample_direction(scene, si.p, si.wavelengths,
                                          u_nee, u2_nee, config)
    nee_active = active & is_smooth & (ds.pdf > 0)
    shadow_ray = si.spawn_ray_d(
        ds.d, maxt=torch.where(nee_active, ds.dist * (1.0 - 1e-3), 0.0))

    u1_b, sampler = sampler.next_1d()
    u2_b, sampler = sampler.next_2d()
    bs, b_weight = bsdf_mod.sample(scene, si, u1_b, u2_b, config)
    bounce_d = si.to_world(bs.wo)
    next_ray = si.spawn_ray_d(bounce_d)

    d_nee, det_nee, det_b = ds.d, None, None
    if config.reparam:
        from ..diff import reparam as reparam_mod
        # the NEE direction and the BSDF-sampled continuation follow the
        # moving silhouettes (diff/reparam.py); both sites' auxiliary rays
        # in one traversal, from the rays' origins
        (Vn, det_nee), (Vb, det_b) = reparam_mod.warp_and_divergence_multi(
            scene, [(shadow_ray.o, ds.d), (next_ray.o, bounce_d)],
            config.reparam_kaux)
        d_nee = reparam_mod.reparameterize(ds.d, Vn)
        bounce_d = reparam_mod.reparameterize(bounce_d, Vb)
        next_ray.d = bounce_d

    occluded = scene_mod.ray_test(scene, shadow_ray)
    wo_local = si.to_local(d_nee)
    f_val = bsdf_mod.eval_(scene, si, wo_local, config)
    f_pdf = bsdf_mod.pdf(scene, si, wo_local, config)
    w_nee = torch.where(ds.delta, 1.0, mis_weight(ds.pdf, f_pdf))
    if det_nee is not None:
        w_nee = det_nee * w_nee
    contrib = throughput * e_val * f_val * \
        (w_nee / torch.clamp_min(ds.pdf, 1e-20))
    result = result + contrib.masked(nee_active & ~occluded)

    throughput = throughput * swhere(active, b_weight, 1.0)
    active = active & (bs.pdf > 0) & b_weight.any_positive()
    if det_b is not None:
        # the Jacobian chains into every later contribution of the path
        throughput = throughput * torch.where(active, det_b, 1.0)
    next_ray.maxt = torch.where(active, float("inf"), 0.0)
    si_next = scene_mod.ray_intersect(scene, next_ray)

    delta_sample = (bs.sampled_flags & bsdf_mod.F_DELTA) != 0
    em_pdf_hit = emitters.pdf_direction_hit(scene, si.p, si_next, config)
    em_pdf_env = emitters.pdf_direction_env(scene, bounce_d)
    em_pdf = torch.where(si_next.valid, em_pdf_hit, em_pdf_env)
    em_pdf = torch.where(delta_sample, 0.0, em_pdf)
    w_bsdf = mis_weight(bs.pdf, em_pdf)
    L = swhere(si_next.valid, emitters.eval_hit(scene, si_next, config),
               emitters.eval_env(scene, bounce_d, si.wavelengths, config))
    result = result + (throughput * L * w_bsdf).masked(active)

    if config.rr_depth < config.max_depth:
        do_rr = (depth + 1 >= config.rr_depth) and (depth + 1 < config.max_depth)
        q = (torch.clamp_max(throughput.hmax() * bs.eta * bs.eta, 0.95)
             if do_rr else torch.ones_like(bs.eta))
        u_rr, sampler = sampler.next_1d()
        throughput = throughput / torch.clamp_min(q, 1e-8)
        active = active & (u_rr < q)

    active = active & si_next.valid
    if si.duv_dx is not None:
        # a bounce ray carries no differentials: a zero footprint, the
        # finest level (interaction.h: differentials from the camera alone)
        z = torch.zeros_like(si.duv_dx.x)
        si_next.duv_dx = si_next.duv_dy = Vec2(z, z)
    return si_next, active, throughput, result, sampler, orig


def sample_path(scene, ray: Ray, sampler: Sampler, config: RenderConfig
                ) -> Tuple[Spec, Sampler]:
    """Path-trace one wavefront (src/integrators/path.cpp)."""
    from ..scene import scene as scene_mod
    n, dev = ray.o.x.shape[0], ray.o.x.device
    C = config.n_channels
    # primary rays are already coherent in (spp, H, W) order: no presort
    si = scene_mod.ray_intersect(scene, ray, sort=False)
    active = si.valid
    throughput = Spec.ones(n, C, dev)
    result = Spec.zeros(n, C, dev)
    if not config.hide_emitters:
        result = result + emitters.eval_hit(scene, si, config)
        result = result + emitters.eval_env(
            scene, ray.d, ray.wavelengths, config).masked(~si.valid)
    carry = (si, active, throughput, result, sampler,
             torch.arange(n, device=dev))
    for depth in range(1, config.max_depth):
        carry = _path_bounce(scene, config, depth, carry)
    _, _, _, result, sampler, orig = carry
    if config.compact:
        from ..kernels import compact as compact_mod
        result = compact_mod.unsort(result, orig)
    return result, sampler


def render_pass(scene, config: RenderConfig, seed: int, device=None,
                lane_offset: int = 0):
    """One pass of (spp_per_pass x H x W) lanes -> ((H, W, C) image sum,
    weight sum), on `device` (None = the CUDA device; raises without
    one), moving the scene there if it is elsewhere. The weight is a
    count under the box filter, else an (H, W) tensor.

    `lane_offset` shifts the lanes' global ids, which seed every sampler
    stream (mod 2^32, as the JAX package's uint32 lanes): D ranks, rank
    r rendering spp_per_pass / D samples at offset r * that many lanes
    with the same seed, draw the independent sampler's numbers of the
    whole pass. The pixel of a lane is its local index's, and the
    stratified and ld samplers take the local spp_per_pass, as in the
    JAX package."""
    from ..scene.scene import to_device, to_float64
    dev = resolve_device(device)
    scene = to_device(scene, dev)
    if config.dtype == "float64":
        scene = to_float64(scene)
    H, W = config.height, config.width
    sppc = config.spp_per_pass
    n = sppc * H * W
    local = torch.arange(n, dtype=torch.int64, device=dev)
    lane = (local + int(lane_offset)) & M32
    sampler = make_sampler(config.sampler, int(seed) & M32, lane, H * W, sppc)
    pix = local % (H * W)
    x = (pix % W).to(torch.float32)
    y = (pix // W).to(torch.float32)
    jitter, sampler = sampler.next_2d()
    uv = sensors.film_uv(x, y, jitter, W, H,
                         crop=(config.crop_x, config.crop_y,
                               config.film_width, config.film_height))
    wl = wl_pdf = None
    if config.color_mode == "spectral":
        u_wl, sampler = sampler.next_1d()
        wl, wl_pdf = sp.sample_hero_wavelengths_t(u_wl)
    u_lens = None
    if scene.cam_type in sensors.NEEDS_APERTURE_SAMPLE:
        u_lens, sampler = sampler.next_2d()
    cam_time = None
    if scene.cam_motion is not None:
        # camera motion blur: a uniform shutter time over the keys' range,
        # clamped to [shutter_open, shutter_close] (cam_data[10:12])
        u_time, sampler = sampler.next_1d()
        times = scene.cam_motion.times
        t0 = torch.maximum(times[0], scene.cam_data[10])
        t1 = torch.minimum(times[-1], scene.cam_data[11])
        cam_time = t0 + u_time * (t1 - t0)
    if (scene.textures is not None
            and scene.cam_type in sensors.HAS_DIFFERENTIALS):
        # a sample covers 1 / spp of its pixel (integrator.cpp's
        # diff_scale_factor), the factor in f32 as the JAX package takes it
        ray = sensors.sample_ray_differential(scene, uv, W, wavelengths=wl,
                                              u_lens=u_lens, time=cam_time)
        ray = ray.scale_differential(
            float(np.float32(1.0) / np.sqrt(np.float32(config.spp))))
    else:
        ray = sensors.sample_ray(scene, uv, wavelengths=wl, u_lens=u_lens,
                                 time=cam_time)
    det_cam = None
    if config.reparam:
        from ..diff import reparam as reparam_mod
        # reparameterized camera rays: the primary visibility's boundary
        Vc, det_cam = reparam_mod.warp_and_divergence(
            scene, ray.o, ray.d, config.reparam_kaux)
        ray.d = reparam_mod.reparameterize(ray.d, Vc)
    if config.integrator in ("volpath", "volpathmis") or scene.has_media:
        # with reparam=True the camera ray alone is warped: volpath's
        # bounces take no warps, as in the JAX package
        from .volpath import sample_path_vol
        spec, _ = sample_path_vol(scene, ray, sampler, config)
    else:
        spec, _ = sample_path(scene, ray, sampler, config)
    if det_cam is not None:
        spec = spec * det_cam
    spec = spec * scene.cam_weight  # sensor importance (irradiance meter)
    if wl is not None:
        spec = sp.spectrum_to_srgb_t(spec, wl, wl_pdf)
    image = torch.zeros((H, W, config.n_image_channels),
                        dtype=config.float_dtype, device=dev)
    return film_mod.accumulate_pass(image, film_mod.zero_weight(config, dev),
                                    spec, jitter, config)


def pass_seeds(seed: int, n_passes: int):
    """The JAX package's pass seeds: seed * 0x9E3779B1 + p (mod 2^32)."""
    return [((seed & M32) * 0x9E3779B1 + p) & M32 for p in range(n_passes)]


def _passes(config: RenderConfig):
    """(config with spp_per_pass clamped to spp, number of passes)."""
    sppc = min(config.spp_per_pass, config.spp)
    return (config.replace(spp_per_pass=sppc),
            (config.spp + sppc - 1) // sppc)


def _tape(scene):
    """Autograd where a tensor of the scene requires grad, else inference
    mode."""
    return (contextlib.nullcontext() if needs_tape(scene)
            else torch.inference_mode())


def render(scene, config: RenderConfig, seed: int = None, device=None
           ) -> torch.Tensor:
    """SamplingIntegrator::render: spp in passes of spp_per_pass, then
    develop. Runs on `device` (None = the CUDA device; raises without
    one), moving the scene there if it is elsewhere. Returns (H, W, C).

    Differentiable: where grad is enabled and a tensor of the scene
    requires grad (scene.needs_tape: a table of diff_tables, or the
    geometry: prim_p0, prim_e1, prim_e2, inst_fwd), the render runs
    under autograd; else in inference mode. The traversals run detached
    either way (scene.ray_test, scene._preliminary_dispatch), so the tape
    holds the shading alone and a backward sweep traces no ray. With
    RenderConfig(reparam=True) the camera, NEE and BSDF directions are
    reparameterized (diff/reparam.py): the image is unchanged, and a
    geometry table's gradient carries the visibility boundary's term; the
    auxiliary rays are traced whether or not a gradient is asked, as in
    the JAX package."""
    from ..scene.scene import to_device
    dev = resolve_device(device)
    scene = to_device(scene, dev)
    if seed is None:
        seed = config.seed
    config, n_passes = _passes(config)
    image, wsum = None, 0
    with _tape(scene):
        for s in pass_seeds(seed, n_passes):
            img_p, w_p = render_pass(scene, config, s, dev)
            image = img_p if image is None else image + img_p
            wsum = wsum + w_p
    return film_mod.develop(image, wsum)


# ---------------------------------------------------------------------------
# The other integrators (src/integrators/{direct,depth,aov,moment}.cpp)
# ---------------------------------------------------------------------------

def sample_depth(scene, ray: Ray, config: RenderConfig) -> torch.Tensor:
    """`depth` integrator: the hit distance, 0 on a miss; (N, 1)."""
    from ..scene import scene as scene_mod
    si = scene_mod.ray_intersect(scene, ray)
    return torch.where(si.valid, si.t, 0.0)[:, None]


# the channels of each AOV (albedo: the image's)
AOV_CHANNELS = {"depth": 1, "position": 3, "sh_normal": 3, "geo_normal": 3,
                "uv": 2, "prim_index": 1, "shape_index": 1, "albedo": None}


def _masked(valid, *chans):
    return torch.where(valid[:, None], torch.stack(chans, -1), 0.0)


def sample_aovs(scene, ray: Ray, config: RenderConfig,
                aovs: Tuple[str, ...]) -> dict:
    """`aov` integrator: geometric output variables of the first hit,
    {name: (N, C)}."""
    from ..scene import scene as scene_mod
    si = scene_mod.ray_intersect(scene, ray)
    v = si.valid
    out = {}
    for name in aovs:
        if name == "depth":
            out[name] = torch.where(v, si.t, 0.0)[:, None]
        elif name == "position":
            out[name] = _masked(v, si.p.x, si.p.y, si.p.z)
        elif name == "sh_normal":
            n = si.sh_frame.n
            out[name] = _masked(v, n.x, n.y, n.z)
        elif name == "geo_normal":
            out[name] = _masked(v, si.n.x, si.n.y, si.n.z)
        elif name == "uv":
            out[name] = _masked(v, si.uv.x, si.uv.y)
        elif name == "prim_index":
            out[name] = si.prim_index.to(torch.float32)[:, None]
        elif name == "shape_index":
            out[name] = si.shape.to(torch.float32)[:, None]
        elif name == "albedo":
            # the hit material's first spectrum slot (a denoiser's guide)
            mat_idx = bsdf_mod._lane_materials(scene, si)[0]
            alb = eval_spectrum_slot(LaneRows(scene.mat_data, mat_idx).slot(0),
                                     si.wavelengths, "rgb", tex=si.tex,
                                     uv=si.uv)
            out[name] = _masked(v, *alb.ch)
        else:
            raise ValueError(f"unknown aov {name!r}")
    return out


def render_aovs(scene, config: RenderConfig,
                aovs: Tuple[str, ...] = ("depth", "sh_normal", "position"),
                seed: int = None, device=None) -> dict:
    """AOV render, {name: (H, W, C)}: one pass of min(spp_per_pass, spp)
    samples, as the JAX package renders it: the independent sampler
    seeded with the raw seed, the box filter, no crop, no shutter time,
    no wavelength draw."""
    from ..scene.scene import to_device
    dev = resolve_device(device)
    scene = to_device(scene, dev)
    if seed is None:
        seed = config.seed
    H, W = config.height, config.width
    sppc = min(config.spp_per_pass, config.spp)
    with torch.inference_mode():
        lane = torch.arange(sppc * H * W, dtype=torch.int64, device=dev)
        sampler = Sampler.seed(int(seed) & M32, lane)
        pix = lane % (H * W)
        jitter, sampler = sampler.next_2d()
        uv = sensors.film_uv((pix % W).to(torch.float32),
                             (pix // W).to(torch.float32), jitter, W, H)
        u_lens = None
        if scene.cam_type in sensors.NEEDS_APERTURE_SAMPLE:
            u_lens, sampler = sampler.next_2d()
        ray = sensors.sample_ray(scene, uv, u_lens=u_lens)
        outs = sample_aovs(scene, ray, config, tuple(aovs))
        return {k: v.reshape(sppc, H, W, v.shape[-1]).mean(0)
                for k, v in outs.items()}


def render_direct(scene, config: RenderConfig, seed: int = None,
                  device=None) -> torch.Tensor:
    """`direct` integrator: one-bounce MIS direct illumination, the path
    tracer at depth 2."""
    return render(scene, config.replace(max_depth=2, integrator="path"),
                  seed, device)


def render_with_variance(scene, config: RenderConfig, seed: int = None,
                         device=None):
    """`moment` integrator: (mean, variance of the mean). Each pass is
    developed on its own and the variance is taken across passes, so it
    needs two passes or more."""
    from ..scene.scene import to_device
    dev = resolve_device(device)
    scene = to_device(scene, dev)
    if seed is None:
        seed = config.seed
    config, n_passes = _passes(config)
    m1 = m2 = None
    with _tape(scene):
        for s in pass_seeds(seed, n_passes):
            img_p = film_mod.develop(*render_pass(scene, config, s, dev))
            m1 = img_p if m1 is None else m1 + img_p
            m2 = img_p ** 2 if m2 is None else m2 + img_p ** 2
    mean = m1 / n_passes
    var_pass = m2 / n_passes - mean ** 2
    return mean, var_pass / max(n_passes - 1, 1)


def render_any(scene, config: RenderConfig, seed: int = None, device=None):
    """Top-level integrator dispatch on `config.integrator`: the loader's
    and the CLI's entry point. Returns, by integrator:

      path | volpath | volpathmis | direct   (H, W, C) image
      depth                                  (H, W, 1) first-hit distance
      aov     {"image": the aov_child's render, name: (H, W, Ck), ...}
      moment                                 (mean, variance) pair
      stokes                                 (H, W, 4) Stokes image
                                             (render/stokes.py)"""
    it = config.integrator
    if it == "direct":
        return render_direct(scene, config, seed, device)
    if it == "depth":
        return render_aovs(scene, config, ("depth",), seed, device)["depth"]
    if it == "aov":
        names = tuple(config.aovs) or ("depth", "sh_normal", "position")
        out = dict(render_aovs(scene, config, names, seed, device))
        out["image"] = render_any(
            scene, config.replace(integrator=config.aov_child), seed, device)
        return out
    if it == "moment":
        return render_with_variance(scene, config, seed, device)
    if it == "stokes":
        from .stokes import render_stokes
        return render_stokes(scene, config.replace(polarized=True), seed,
                             device)
    return render(scene, config, seed, device)
