"""The wavefront path tracer and the render driver (counterpart of
render/integrators.py).

`lax.scan` over bounces becomes a Python loop over bounces, and the
passes run as a Python loop with the JAX package's pass seeds, so both
packages draw the same PCG32 numbers in the same order: the pixel jitter
first, in spectral mode the hero wavelengths' draw, then per bounce
u_nee, u2_nee, u1_b, u2_b and, only when rr_depth < max_depth, u_rr.
Spectral mode carries four hero wavelengths a lane on its rays and
shading records and develops each lane to linear sRGB before the film.
On a scene with textures the camera rays carry differentials, scaled to
a sample's share of its pixel, so that the first hit's lookups are
mip-filtered; later hits carry a zero footprint (level 0), as in the
reference.
"""
from __future__ import annotations

import contextlib
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

M32 = 0xFFFFFFFF


def mis_weight(pdf_a, pdf_b):
    """Power heuristic, beta = 2 (path.cpp::mis_weight)."""
    a2 = pdf_a * pdf_a
    return torch.where(pdf_a > 0,
                       a2 / torch.clamp_min(a2 + pdf_b * pdf_b, 1e-38), 0.0)


def _path_bounce(scene, config: RenderConfig, depth: int, carry):
    """One bounce of path.cpp's loop: NEE (+MIS), BSDF sampling, the
    emitter hit along the new ray (+MIS), Russian roulette."""
    from ..scene import scene as scene_mod
    si, active, throughput, result, sampler = carry

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
    return si_next, active, throughput, result, sampler


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
    carry = (si, active, throughput, result, sampler)
    for depth in range(1, config.max_depth):
        carry = _path_bounce(scene, config, depth, carry)
    return carry[3], carry[4]


def render_pass(scene, config: RenderConfig, seed: int, device=None
                ) -> Tuple[torch.Tensor, int]:
    """One pass of (spp_per_pass x H x W) lanes -> ((H, W, C) image sum,
    weight), on `device` (None = the CUDA device; raises without one),
    moving the scene there if it is elsewhere."""
    from ..scene.scene import to_device
    dev = resolve_device(device)
    scene = to_device(scene, dev)
    H, W = config.height, config.width
    sppc = config.spp_per_pass
    n = sppc * H * W
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    sampler = make_sampler(config.sampler, int(seed) & M32, lane)
    pix = torch.arange(n, dtype=torch.int64, device=dev) % (H * W)
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
    if (scene.textures is not None
            and scene.cam_type in sensors.HAS_DIFFERENTIALS):
        # a sample covers 1 / spp of its pixel (integrator.cpp's
        # diff_scale_factor), the factor in f32 as the JAX package takes it
        ray = sensors.sample_ray_differential(scene, uv, W, wavelengths=wl)
        ray = ray.scale_differential(
            float(np.float32(1.0) / np.sqrt(np.float32(config.spp))))
    else:
        ray = sensors.sample_ray(scene, uv, wavelengths=wl)
    det_cam = None
    if config.reparam:
        from ..diff import reparam as reparam_mod
        # reparameterized camera rays: the primary visibility's boundary
        Vc, det_cam = reparam_mod.warp_and_divergence(
            scene, ray.o, ray.d, config.reparam_kaux)
        ray.d = reparam_mod.reparameterize(ray.d, Vc)
    spec, _ = sample_path(scene, ray, sampler, config)
    if det_cam is not None:
        spec = spec * det_cam
    if wl is not None:
        spec = sp.spectrum_to_srgb_t(spec, wl, wl_pdf)
    image = torch.zeros((H, W, config.n_image_channels), dtype=torch.float32,
                        device=dev)
    return film_mod.accumulate_pass(image, 0, spec, config)


def pass_seeds(seed: int, n_passes: int):
    """The JAX package's pass seeds: seed * 0x9E3779B1 + p (mod 2^32)."""
    return [((seed & M32) * 0x9E3779B1 + p) & M32 for p in range(n_passes)]


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
    sppc = min(config.spp_per_pass, config.spp)
    config = config.replace(spp_per_pass=sppc)
    n_passes = (config.spp + sppc - 1) // sppc
    image, wsum = None, 0
    with (contextlib.nullcontext() if needs_tape(scene)
          else torch.inference_mode()):
        for s in pass_seeds(seed, n_passes):
            img_p, w_p = render_pass(scene, config, s, dev)
            image = img_p if image is None else image + img_p
            wsum += w_p
    return film_mod.develop(image, wsum)
