"""Polarized rendering (counterpart of render/stokes.py): the `stokes`
integrator and the full polarized transport of the `*_polarized` variants.

`render_stokes` (src/integrators/stokes.cpp's Stokes output over polarized
direct illumination): a camera ray's first hit; a smooth conductor or
dielectric reflects the radiance arriving along its mirror direction
(the mirror ray: one more closest hit) through its Fresnel Mueller matrix,
rotated into and out of the plane of incidence; any other surface
depolarizes, its intensity the scalar direct illumination of one NEE
sample (one shadow ray). It draws from the independent sampler whatever
the config names, as the JAX package does. Output (H, W, 4), the
channel-averaged Stokes image (S0 the radiance).

`render_polarized`: a BSDF-sampling path tracer (no NEE, so no shadow
rays) carrying a Mueller throughput (N, C, 4, 4) a lane from the camera
toward the light and applying it to unpolarized emission at each
vertex. Sampling reuses the scalar BSDFs; each vertex's Mueller matrix is
intensity-normalized and scaled by the scalar sample weight, so S0 is
the scalar BSDF-sampling estimate. Smooth and rough conductors reflect
by their per-channel complex IOR (the RGB columns 0-2 and 8-10 of their
rows, in spectral mode too), dielectrics reflect or transmit by Fresnel,
polarizer and retarder act as ideal elements about their axis in the
canonical Stokes basis of the beam, measured_polarized applies its
tabulated cell (render/measured.py), everything else depolarizes. In
spectral mode each Stokes component's hero-wavelength sample develops to
sRGB on its own. Output (H, W, C, 4), C the image's channels.

Both average their passes with no film filter, at the JAX package's pass
seeds; their Mueller products are batched 4 x 4 matmuls outside any
kernel, as in the JAX package, and the traversals are the scene's walk
(the cluster walk's K1 and K2 on a triangle scene).
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import RenderConfig
from ..core import spectrum as sp
from ..core.geometry import Frame
from ..core.spec import Spec, swhere
from ..core.vec import Vec3, vdot, vnormalize
from ..device import resolve_device
from . import bsdf as bsdf_mod
from . import emitters, measured as measured_mod, mueller as mu, sensors
from .integrators import M32, _passes, pass_seeds
from .sampler import Sampler, make_sampler
from .spectra import LaneRows


def _rows(v: Vec3):
    return torch.stack((v.x, v.y, v.z), -1)


def _lane_rows(scene, si):
    """(each lane's family, a LaneRows of its own material row)."""
    mat_idx, mtype, _ = bsdf_mod._lane_materials(scene, si)
    return mtype, LaneRows(scene.mat_data, mat_idx)


def _plane_rotators(dir_in, dir_out, s_axis_default, threshold):
    """The rotators from the beams' canonical Stokes bases into the
    scattering plane's (its s axis perpendicular to the plane of
    incidence; `s_axis_default` where the plane degenerates) and back."""
    plane_n = torch.linalg.cross(dir_in, dir_out)
    degenerate = torch.sum(plane_n * plane_n, -1) < threshold
    s_axis = torch.where(degenerate[..., None], s_axis_default,
                         mu.normalize(plane_n))
    return (mu.rotate_stokes_basis(dir_in, mu.stokes_basis(dir_in), s_axis),
            mu.rotate_stokes_basis(dir_out, s_axis, mu.stokes_basis(dir_out)))


def _specular_stokes(scene, si, ray_d: Vec3, config):
    """The Stokes radiance a smooth specular first hit reflects toward the
    camera (conductor or dielectric reflection lobe), (N, 4)."""
    from ..scene import scene as scene_mod
    n = si.sh_frame.n
    wi_world = -ray_d
    cos_i = vdot(n, wi_world)
    wr = vnormalize(n * (2.0 * cos_i) - wi_world)
    # unpolarized radiance along the mirror direction
    si_r = scene_mod.ray_intersect(scene, si.spawn_ray_d(wr))
    L = swhere(si_r.valid, emitters.eval_hit(scene, si_r, config),
               emitters.eval_env(scene, wr, si.wavelengths, config))
    I_in = L.hmean()
    mtype, mdata = _lane_rows(scene, si)
    cos_c = torch.clamp(torch.abs(cos_i), 1e-4, 1.0)
    # a conductor's channel-averaged complex IOR (slots 0 and 1), a
    # dielectric's eta (col 24)
    eta_re = (mdata.col(0) + mdata.col(1) + mdata.col(2)) * (1.0 / 3.0)
    eta_im = (mdata.col(8) + mdata.col(9) + mdata.col(10)) * (1.0 / 3.0)
    m_f = torch.where((mtype == bsdf_mod.CONDUCTOR)[..., None, None],
                      mu.specular_reflection_conductor(cos_c, eta_re, eta_im),
                      mu.specular_reflection_dielectric(cos_c, mdata.col(24)))
    wi_a, wr_a = _rows(-wi_world), _rows(wr)
    r_in, r_out = _plane_rotators(wi_a, wr_a, mu.stokes_basis(wi_a), 1e-12)
    M = r_out @ m_f @ r_in
    return (M @ mu.unpolarized_intensity(I_in)[..., None])[..., 0]


def _diffuse_intensity(scene, si, sampler, config):
    """Scalar direct illumination at si by one NEE sample, plus the
    emission seen directly (depolarized)."""
    from ..scene import scene as scene_mod
    u1, sampler = sampler.next_1d()
    u2, sampler = sampler.next_2d()
    ds, e_val = emitters.sample_direction(scene, si.p, si.wavelengths, u1,
                                          u2, config)
    occ = scene_mod.ray_test(scene, si.spawn_ray_d(
        ds.d, maxt=ds.dist * (1 - 1e-3)))
    f_val = bsdf_mod.eval_(scene, si, si.to_local(ds.d), config)
    contrib = e_val * f_val / torch.clamp_min(ds.pdf, 1e-20)
    ok = si.valid & (ds.pdf > 0) & ~occ
    I = contrib.masked(ok).hmean()
    return I + emitters.eval_hit(scene, si, config).hmean(), sampler


def _pixel_lanes(config, dev):
    H, W = config.height, config.width
    n = config.spp_per_pass * H * W
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    pix = lane % (H * W)
    return lane, (pix % W).to(torch.float32), (pix // W).to(torch.float32)


def stokes_pass(scene, config: RenderConfig, seed: int) -> torch.Tensor:
    """One pass of the stokes integrator: (H, W, 4), its lanes' mean."""
    from ..scene import scene as scene_mod
    H, W = config.height, config.width
    lane, x, y = _pixel_lanes(config, scene.device)
    sampler = Sampler.seed(int(seed) & M32, lane)
    jitter, sampler = sampler.next_2d()
    ray = sensors.sample_ray(scene, sensors.film_uv(x, y, jitter, W, H))
    si = scene_mod.ray_intersect(scene, ray)
    flags = bsdf_mod.lane_flags(scene, si)
    is_delta = si.valid & ((flags & bsdf_mod.F_DELTA_R) != 0)
    s_spec = _specular_stokes(scene, si, ray.d, config)
    I_diff, sampler = _diffuse_intensity(scene, si, sampler, config)
    I_env = emitters.eval_env(scene, ray.d, ray.wavelengths, config).hmean()
    s_diff = mu.unpolarized_intensity(torch.where(si.valid, I_diff, I_env))
    s = torch.where(is_delta[..., None], s_spec, s_diff)
    return s.reshape(config.spp_per_pass, H, W, 4).mean(0)


def _render_passes(scene, config, seed, device, one_pass):
    """The mean of one_pass(scene, config, pass seed) over the config's
    passes, on `device`, moving the scene there: no film filter."""
    from ..scene.scene import to_device
    dev = resolve_device(device)
    scene = to_device(scene, dev)
    if seed is None:
        seed = config.seed
    config, n_passes = _passes(config)
    acc = None
    with torch.inference_mode():
        for s in pass_seeds(seed, n_passes):
            img = one_pass(scene, config, s)
            acc = img if acc is None else acc + img
    return acc / n_passes


def render_stokes(scene, config: RenderConfig, seed: int = None,
                  device=None) -> torch.Tensor:
    """(H, W, 4) Stokes image of polarized direct illumination, on
    `device` (None = the CUDA device; raises without one). Its camera
    rays carry no wavelengths, so spectral mode is refused (the JAX
    package's raises AttributeError there)."""
    if config.color_mode == "spectral":
        raise ValueError("the stokes integrator renders rgb and mono: its "
                         "camera rays draw no hero wavelengths")
    return _render_passes(scene, config, seed, device, stokes_pass)


# ---------------------------------------------------------------------------
# Full polarized path transport (the *_polarized variants)
# ---------------------------------------------------------------------------

def _mueller_at_vertex(scene, si, d_cam: Vec3, bounce_d: Vec3, b_weight,
                       config):
    """The sampled interaction's per-channel Mueller matrix (N, C, 4, 4),
    normalized so that its intensity gain is the scalar sample weight."""
    mtype, mdata = _lane_rows(scene, si)
    N, C = si.wi.z.shape[0], config.n_channels
    # the light arrives along -bounce_d and leaves toward the camera along
    # -d_cam; both beams share the scattering plane's s axis
    dir_in, dir_out = _rows(-bounce_d), _rows(-d_cam)
    r_in, r_out = _plane_rotators(dir_in, dir_out, mu.stokes_basis(dir_out),
                                  1e-9)
    cos_i = torch.clamp(torch.abs(Frame.cos_theta(si.wi)), 1e-4, 1.0)

    def norm(m):
        return m / torch.clamp_min(m[..., 0:1, 0:1], 1e-12)

    def put(out, family_sel, m):
        return torch.where(family_sel[:, None, None, None], m, out)

    # the default: a depolarizer (value 1, the scalar weight scales it)
    out = mu.depolarizer(torch.ones(N, device=si.wi.z.device))[:, None] \
        .expand(N, C, 4, 4)
    fams = set(scene.mat_families)
    if {bsdf_mod.CONDUCTOR, bsdf_mod.ROUGHCONDUCTOR} & fams:
        ms = [norm(mu.specular_reflection_conductor(
            cos_i, mdata.col(c), mdata.col(8 + c))) for c in range(min(C, 3))]
        ms += [ms[-1]] * (C - len(ms))
        out = put(out, (mtype == bsdf_mod.CONDUCTOR)
                  | (mtype == bsdf_mod.ROUGHCONDUCTOR), torch.stack(ms, 1))
        del ms
    diel = (bsdf_mod.DIELECTRIC, bsdf_mod.THINDIELECTRIC,
            bsdf_mod.ROUGHDIELECTRIC)
    if set(diel) & fams:
        eta = mdata.col(24)
        reflected = (Frame.cos_theta(si.wi)
                     * Frame.cos_theta(si.to_local(bounce_d))) > 0
        m_diel = torch.where(
            reflected[..., None, None],
            norm(mu.specular_reflection_dielectric(cos_i, eta)),
            norm(mu.specular_transmission_dielectric(cos_i, eta)))
        out = put(out, (mtype == diel[0]) | (mtype == diel[1])
                  | (mtype == diel[2]), m_diel[:, None])
        del m_diel
    if bsdf_mod.POLARIZER in fams:
        out = put(out, mtype == bsdf_mod.POLARIZER, norm(mu.rotated_element(
            mdata.col(24), mu.linear_polarizer(mdata.col(25))))[:, None])
    if bsdf_mod.RETARDER in fams:
        out = put(out, mtype == bsdf_mod.RETARDER, mu.rotated_element(
            mdata.col(24), mu.linear_retarder(mdata.col(25)))[:, None])
    if (bsdf_mod.MEASURED_POLARIZED in fams
            and getattr(scene.measured, "mueller", None) is not None):
        m_meas = measured_mod.mueller_lookup(
            scene.measured, mdata.col(28), si.wi, si.to_local(bounce_d))
        out = put(out, mtype == bsdf_mod.MEASURED_POLARIZED, m_meas[:, None])
        del m_meas
    # the frame rotations (identity for the straight-through elements)
    out = r_out[:, None] @ out @ r_in[:, None]
    return out * torch.stack(b_weight.ch, -1)[..., None, None]


def sample_path_polarized(scene, ray, sampler, config: RenderConfig):
    """BSDF-sampling polarized path tracer: ((N, C, 4) Stokes radiance in
    the canonical basis of each camera ray, sampler)."""
    from ..scene import scene as scene_mod
    N, C = ray.o.x.shape[0], config.n_channels
    dev = ray.o.x.device
    M_total = torch.eye(4, device=dev).expand(N, C, 4, 4)
    result = torch.zeros((N, C, 4), device=dev)
    active = torch.ones(N, dtype=torch.bool, device=dev)
    for depth in range(config.max_depth):
        si = scene_mod.ray_intersect(scene, ray)
        # emission reaching the camera through the Mueller chain
        L = swhere(si.valid, emitters.eval_hit(scene, si, config),
                   emitters.eval_env(scene, ray.d, ray.wavelengths, config))
        contrib = M_total[..., :, 0] * torch.stack(L.ch, -1)[..., None]
        result = result + torch.where(active[:, None, None], contrib, 0.0)
        active = active & si.valid
        if depth == config.max_depth - 1:
            break
        u1, sampler = sampler.next_1d()
        u2, sampler = sampler.next_2d()
        bs, b_weight = bsdf_mod.sample(scene, si, u1, u2, config)
        bounce_d = si.to_world(bs.wo)
        M_v = _mueller_at_vertex(scene, si, ray.d, bounce_d, b_weight,
                                 config)
        M_total = torch.where(active[:, None, None, None], M_total @ M_v,
                              M_total)
        del M_v
        active = active & (bs.pdf > 0)
        ray = si.spawn_ray_d(bounce_d)
        ray = dataclasses.replace(ray, maxt=torch.where(
            active, float("inf"), 0.0))
    return result, sampler


def polarized_pass(scene, config: RenderConfig, seed: int) -> torch.Tensor:
    """One pass of full polarized transport: (H, W, C, 4)."""
    H, W = config.height, config.width
    sppc = config.spp_per_pass
    lane, x, y = _pixel_lanes(config, scene.device)
    sampler = make_sampler(config.sampler, int(seed) & M32, lane, H * W,
                           sppc)
    jitter, sampler = sampler.next_2d()
    uv = sensors.film_uv(x, y, jitter, W, H)
    wl = wl_pdf = None
    if config.color_mode == "spectral":
        u_wl, sampler = sampler.next_1d()
        wl, wl_pdf = sp.sample_hero_wavelengths_t(u_wl)
    ray = sensors.sample_ray(scene, uv, wavelengths=wl)
    s, _ = sample_path_polarized(scene, ray, sampler, config)
    if wl is not None:
        # each Stokes component's hero samples -> sRGB
        s = torch.stack([torch.stack(sp.spectrum_to_srgb_t(
            Spec(tuple(s[:, c, i] for c in range(config.n_channels))),
            wl, wl_pdf).ch, -1) for i in range(4)], -1)
    return s.reshape(sppc, H, W, s.shape[-2], 4).mean(0)


def render_polarized(scene, config: RenderConfig, seed: int = None,
                     device=None) -> torch.Tensor:
    """Full polarized transport: the (H, W, C, 4) per-channel Stokes
    image, on `device` (None = the CUDA device; raises without one)."""
    return _render_passes(scene, config, seed, device, polarized_pass)
