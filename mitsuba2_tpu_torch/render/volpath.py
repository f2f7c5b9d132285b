"""The volumetric path tracer (counterpart of render/volpath.py, the
`volpath` and `volpathmis` integrators of src/integrators/volpath.cpp).

What it adds to the surface path tracer (render/integrators.py):

- each lane carries its current medium as an integer (-1 = vacuum),
  switched where it crosses a null boundary or refracts;
- between interactions a free-flight distance is sampled: analytically
  in a homogeneous medium (at the channel-mean rate, or under
  `volpathmis` by spectral MIS over the channels), by delta tracking
  against the grid's majorant in a heterogeneous one;
- shadow rays accumulate transmittance through media and pass through up
  to _MAX_NULL null boundaries (Scene::eval_transmittance), failing dark
  when that budget runs out;
- medium events scatter by the Henyey-Greenstein phase function, with
  MIS against emitter sampling.

The JAX package's stream layout is kept draw for draw, so both packages
trace the same paths from the same seed: per flight u_ff (under
volpathmis on a homogeneous scene u_ch next, on a scene with a grid three
draws that seed the forked tracking stream), then per bounce u_nee,
u2_nee, u2_ph, u_s, u2_s, u1_b, u2_b and, only when rr_depth <
max_depth, u_rr. Its deviations from volpath.cpp are kept too: a null
crossing consumes a bounce of max_depth, heterogeneous flights track
with the channel-mean extinction and a gray weight, exhausting
_MAX_NULL fails dark (ROADMAP.md, Queue 3).

Gradients: sampled distances, the majorant and every pdf denominator are
detached, where the JAX package stops them; a heterogeneous flight's
derivative comes from the factor exp(log R - sg(log R)) over a
_TAU_STEPS-point midpoint raymarch (primal exactly 1). A camera ray's
differentials are dropped, as the JAX package drops them: every texture
lookup of a volumetric path reads level 0.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import RenderConfig
from ..core import pcg32
from ..core import spectrum as sp
from ..core.geometry import Ray
from ..core.spec import Spec, swhere
from ..core.vec import Vec3, vdot, vwhere
from . import bsdf as bsdf_mod
from . import emitters
from . import media as media_mod
from .integrators import mis_weight
from .sampler import Sampler
from .spectra import LaneRows

_MAX_NULL = 3       # transmittance segments a shadow ray: a null-bounded
                    # volume needs three (enter, exit, the clear segment)
_DELTA_STEPS = 64   # delta-tracking trials a free flight
_TAU_STEPS = 8      # midpoint raymarch points of a heterogeneous flight's
                    # derivative-side optical depth (and of shadow rays')
# the tracking loop tests "every lane done" (one host sync) after this many
# trials: a lane that is done never changes again and its forked stream is
# thrown away, so the result is the one of a test after every trial
_DONE_CHECK = 8

# when a list: each heterogeneous flight appends (its trip count: the
# most trials a lane took, the trials its lanes took, the lanes it
# tracked, the trials the loop ran); None: not recorded
TRACK_STATS: Optional[list] = None


def _medium_coeffs(scene, med_idx, config, wavelengths=None):
    """Per-lane (sigma_t Spec, albedo Spec, g (N,), scale (N,)): rgb mode
    the stored channels, spectral mode the RGB lifted to the lanes' hero
    wavelengths through the coefficient lattice, mono the channel mean;
    zero outside a medium."""
    rows = LaneRows(scene.med_data, torch.clamp_min(med_idx, 0))
    c = [rows.col(i) for i in range(media_mod.MED_W)]
    C = config.n_channels

    def lift(r, g, b):
        if C == 3:
            return Spec((r, g, b))
        if config.color_mode == "spectral" and wavelengths is not None:
            mx = sp._max(torch.maximum(r, torch.maximum(g, b)), 1e-9)
            scale_c = sp._max(mx / 0.999, 1.0)
            inv = 1.0 / scale_c
            c2, c1, c0 = sp.srgb_model_fetch_interp_t(
                sp.srgb_model_fetch_lattice(), r * inv, g * inv, b * inv)
            return Spec(tuple(sp.srgb_model_eval_t(c2, c1, c0, w) * scale_c
                              for w in wavelengths.ch))
        return Spec(((r + g + b) * (1.0 / 3.0),) * C)

    in_med = med_idx >= 0
    return (lift(c[0], c[1], c[2]).masked(in_med),
            lift(c[3], c[4], c[5]).masked(in_med), c[6], c[7])


def _density(scene, med_idx, p: Vec3):
    """The density multiplier at points p of the lanes in medium med_idx
    (N,), p's components (N,) or (K, N): the grid's in a heterogeneous
    medium, 1 elsewhere."""
    if scene.medium_grid is None:
        return torch.ones_like(p.z)
    hetero = scene.med_type[torch.clamp_min(med_idx, 0)] == \
        media_mod.MEDIUM_HETEROGENEOUS
    d = scene.medium_grid.eval(p)
    return torch.where(hetero & (med_idx >= 0), d, 1.0)


def _march(scene, med_idx, o: Vec3, d: Vec3, t):
    """The densities at o + d * t for (K, N) distances t along the
    lanes' rays, in one grid lookup: (K, N)."""
    return _density(scene, med_idx, o + d * t)


def _midpoints(n_steps, like):
    """(i + 0.5) for i < n_steps as a (n_steps, 1) column on like's
    device: the raymarch's midpoints, exact in f32."""
    return torch.arange(0.5, n_steps, 1.0, dtype=torch.float32,
                        device=like.device)[:, None]


def _ordered_sum(x):
    """x (K, N) summed over K one row at a time from 0, the order of the
    JAX package's loop."""
    out = torch.zeros_like(x[0])
    for row in x:
        out = out + row
    return out


def _sample_free_flight(scene, med_idx, ray: Ray, t_surf, u,
                        sampler: Sampler, config: RenderConfig):
    """A collision distance along `ray`, capped at t_surf: (t_col,
    is_medium_event, weight Spec, sampler). Homogeneous (a scene without
    a grid): analytic exponential sampling, the weight transmittance over
    pdf for either outcome. With a grid: delta tracking (unit weight)."""
    sig, _, _, scale = _medium_coeffs(scene, med_idx, config,
                                      ray.wavelengths)
    in_med = med_idx >= 0
    C = config.n_channels

    if scene.medium_grid is None:
        sig_rgb = sig * scale
        if config.integrator == "volpathmis" and C > 1:
            # spectral MIS (volpathmis.cpp): one channel's extinction
            # picked uniformly as the distance technique, the C
            # techniques combined by the balance heuristic
            u_ch, sampler = sampler.next_1d()
            k = torch.clamp_max((u_ch * C).to(torch.int32), C - 1)
            sig_k = sig_rgb.ch[0]
            for ch in range(1, C):
                sig_k = torch.where(k == ch, sig_rgb.ch[ch], sig_k)
            t_s = (-torch.log(torch.clamp_min(1.0 - u, 1e-38)) /
                   torch.clamp_min(sig_k, 1e-20)).detach()
            med_event = in_med & (t_s < t_surf) & (sig_k > 0)
            t_col = torch.where(med_event, t_s, t_surf)
            t_cl = torch.clamp_max(t_col, 1e20)
            tr = Spec(tuple(torch.exp(s * (-t_cl)) for s in sig_rgb.ch))
            pdf_med = (sig_rgb * tr).hmean()
            pdf_surf = Spec(tuple(
                torch.exp(s * (-torch.clamp_max(t_surf, 1e20)))
                for s in sig_rgb.ch)).hmean()
        else:
            sig_bar = sig.hmean() * scale
            t_s = (-torch.log(torch.clamp_min(1.0 - u, 1e-38)) /
                   torch.clamp_min(sig_bar, 1e-20)).detach()
            med_event = in_med & (t_s < t_surf) & (sig_bar > 0)
            t_col = torch.where(med_event, t_s, t_surf)
            t_cl = torch.clamp_max(t_col, 1e20)
            tr = Spec(tuple(torch.exp(s * (-t_cl)) for s in sig_rgb.ch))
            pdf_med = sig_bar * torch.exp(-sig_bar * t_s)
            pdf_surf = torch.exp(-sig_bar * torch.clamp_max(t_surf, 1e20))
        # detached denominators, neutralized (1) on the branch a lane did
        # not take: the differentiable pdf would cancel the transmittance's
        # derivative, and its 1/pdf^2 backward is a masked lane's NaN
        w_med = tr * sig_rgb / torch.where(
            med_event, torch.clamp_min(pdf_med, 1e-30), 1.0).detach()
        w_surf = tr / torch.where(
            med_event, 1.0, torch.clamp_min(pdf_surf, 1e-30)).detach()
        w = swhere(in_med, swhere(med_event, w_med, w_surf), 1.0)
        return t_col, med_event, w, sampler

    # delta tracking against the global majorant, a sampling decision
    # (detached); the 1.05 margin keeps the real-collision ratio below 1,
    # the floor of 1 majorizes homogeneous lanes (density multiplier 1)
    sig_bar = sig.hmean() * scale
    gmax = torch.clamp_min(scene.medium_grid.data.max(), 1.0)
    maj = torch.clamp_min((1.05 * sig_bar * gmax).detach(), 1e-20)

    # the forked tracking stream: the main stream advances by exactly
    # three draws, which seed a per-lane PCG32 the loop draws from
    u_f1, sampler = sampler.next_1d()
    u_f2, sampler = sampler.next_1d()
    u_f3, sampler = sampler.next_1d()
    # (1 - 2^-23) * 2^32 is exact in f32: the u32 values, held in int64
    k1, k2, k3 = ((f * 4294967296.0).to(torch.int64) & pcg32.M32
                  for f in (u_f1, u_f2, u_f3))
    done0 = ~in_med | (sig_bar <= 0)
    with torch.no_grad():
        t, collided = _delta_track(
            scene, med_idx, ray, t_surf, sig_bar.detach(), maj, done0,
            pcg32.seed(k1, k2, k3, k2 ^ (k1 >> 7)))
    med_event = collided & in_med
    t_col = torch.where(med_event, t, t_surf)

    # the differential free flight: primal 1, derivative d log R with R =
    # exp(-tau) [x sigma(x_col) on a collision], tau by a deterministic
    # midpoint raymarch
    t_cl = torch.clamp_max(t_col, 1e20).detach()
    dt_m = t_cl / _TAU_STEPS
    # the midpoints and the collision point in one lookup
    dens = _march(scene, med_idx, ray.o, ray.d, torch.cat(
        [_midpoints(_TAU_STEPS, t_cl) * dt_m, t_cl[None]]))
    tau = sig_bar * dt_m * _ordered_sum(dens[:_TAU_STEPS])
    col_dens = dens[_TAU_STEPS]
    log_r = -tau + torch.where(
        med_event, torch.log(torch.clamp_min(sig_bar * col_dens, 1e-30)),
        0.0)
    w_track = torch.where(in_med, torch.exp(log_r - log_r.detach()), 1.0)
    return t_col, med_event, Spec((w_track,) * C), sampler


def _delta_track(scene, med_idx, ray: Ray, t_surf, sig_bar, maj, done0,
                 state: pcg32.PCG32State):
    """Up to _DELTA_STEPS delta-tracking trials: (t, collided). The loop
    ends at the first done test (one host sync, every _DONE_CHECK
    trials) that finds every lane done: a done lane never changes again
    and its forked stream is thrown away, so this is the result of the
    JAX package's test after every trial."""
    t = torch.zeros_like(t_surf)
    done, collided = done0, torch.zeros_like(done0)
    trials = (torch.zeros_like(t, dtype=torch.int32)
              if TRACK_STATS is not None else None)
    loop = 0
    for i in range(_DELTA_STEPS):
        if i % _DONE_CHECK == 0 and bool(done.all()):
            break
        u1, state = pcg32.next_float32(state)
        u2, state = pcg32.next_float32(state)
        t_new = t - torch.log(torch.clamp_min(1.0 - u1, 1e-38)) / maj
        past = t_new >= t_surf
        dens = _density(scene, med_idx, ray.o + ray.d * t_new)
        real = u2 < torch.clamp((sig_bar * dens) / maj, 0.0, 1.0)
        collided = torch.where(~done & ~past & real, True, collided)
        t = torch.where(done, t, t_new)
        if trials is not None:
            trials = trials + (~done).to(torch.int32)
        done = done | past | real
        loop = i + 1
    if trials is not None:
        TRACK_STATS.append((int(trials.max()), int(trials.sum()),
                            int((~done0).sum()), loop))
    return t, collided


def _transition(scene, si, d_world: Vec3, cur_med):
    """The medium after crossing shape `si` along d_world: entering, the
    shape's interior medium; leaving, vacuum (nested media collapse to
    the outermost, as volpath.cpp without a medium stack)."""
    entering = vdot(d_world, si.n) < 0
    interior = scene.shape_interior[torch.clamp_min(si.shape, 0)]
    new_med = torch.where(entering, interior, -1)
    return torch.where(si.valid & (si.shape >= 0), new_med, cur_med)


def eval_transmittance(scene, p: Vec3, d: Vec3, dist, med_idx, config,
                       wavelengths=None) -> Spec:
    """Transmittance from p along d over `dist`, through up to _MAX_NULL
    null boundaries (Scene::eval_transmittance in volpath.cpp), each
    crossing times its surface's null transmission (a mask's 1 -
    opacity); fails dark where the budget runs out. A lane of dist <= 0
    traces nothing (its rays have t_max 0)."""
    from ..scene import scene as scene_mod
    n, dev = p.z.shape[0], p.z.device
    C = config.n_channels
    tr = Spec.ones(n, C, dev)
    cur, o, remaining = med_idx, p, dist
    active = remaining > 0
    eps = 1e-4
    for _ in range(_MAX_NULL):
        si = scene_mod.ray_intersect(scene, Ray.make(
            o, d, maxt=torch.where(active, remaining, 0.0),
            wavelengths=wavelengths))
        seg = torch.where(si.valid, si.t, remaining)
        sig, _, _, scale = _medium_coeffs(scene, cur, config, wavelengths)
        seg_cl = torch.clamp_max(seg, 1e20)
        if scene.medium_grid is None:
            seg_tr = Spec(tuple(torch.exp(s * (-scale * seg_cl))
                                for s in sig.ch))
        else:
            dens_sum = _ordered_sum(_march(
                scene, cur, o, d,
                (_midpoints(_TAU_STEPS, seg_cl) / _TAU_STEPS) * seg_cl))
            seg_tr = Spec(tuple(
                torch.exp(s * (-(scale * dens_sum / _TAU_STEPS) * seg_cl))
                for s in sig.ch))
        tr = swhere(active, tr * seg_tr, tr)

        flags = bsdf_mod.lane_flags(scene, si)
        is_null = si.valid & ((flags & bsdf_mod.F_NULL) != 0)
        tr = tr.masked(~(active & si.valid & ~is_null))
        cross = active & is_null
        tr = swhere(cross, tr * bsdf_mod.null_transmission(scene, si, config),
                    tr)
        cur = torch.where(cross, _transition(scene, si, d, cur), cur)
        o = vwhere(cross, si.p + d * eps, o)
        remaining = torch.where(cross, remaining - si.t - eps, remaining)
        active = cross & (remaining > 0)
    return tr.masked(~active)


def _vol_flight(scene, config: RenderConfig, depth: int, carry, sort=None):
    """The head of each iteration: intersect, free flight, the
    MIS-weighted emitter hit of the lanes that reached a surface."""
    from ..scene import scene as scene_mod
    ray, sampler, throughput, result, med, active, prev_pdf, prev_delta = \
        carry
    si = scene_mod.ray_intersect(scene, ray, sort=sort)
    t_surf = torch.where(si.valid, si.t, 1e20)

    u_ff, sampler = sampler.next_1d()
    t_col, med_event, w_ff, sampler = _sample_free_flight(
        scene, med, ray, t_surf, u_ff, sampler, config)
    throughput = throughput * swhere(active, w_ff, 1.0)
    p_med = ray.o + ray.d * t_col

    surf_event = active & ~med_event
    em_pdf = torch.where(si.valid,
                         emitters.pdf_direction_hit(scene, ray.o, si, config),
                         emitters.pdf_direction_env(scene, ray.d))
    w_mis = torch.where(prev_delta, 1.0, mis_weight(prev_pdf, em_pdf))
    L = swhere(si.valid, emitters.eval_hit(scene, si, config),
               emitters.eval_env(scene, ray.d, ray.wavelengths, config))
    gate = surf_event & (not config.hide_emitters or depth > 0)
    result = result + (throughput * L * w_mis).masked(gate)
    active = active & (med_event | si.valid)
    return si, med_event, p_med, sampler, throughput, result, active


def _vol_bounce(scene, config: RenderConfig, depth: int, carry, sort=None):
    """One full iteration: the flight head, then medium or surface
    scattering (NEE with transmittance, phase or BSDF sampling), medium
    switches at crossings, Russian roulette."""
    ray, _, _, _, med, _, prev_pdf, prev_delta = carry
    si, med_event, p_med, sampler, throughput, result, active = \
        _vol_flight(scene, config, depth, carry, sort)
    C = config.n_channels
    _, alb, g_hg, _ = _medium_coeffs(scene, med, config, ray.wavelengths)

    # ---- a medium interaction: NEE from the medium point -----------------
    m_act = active & med_event
    wi_med = -ray.d
    u_nee, sampler = sampler.next_1d()
    u2_nee, sampler = sampler.next_2d()
    ds, e_val = emitters.sample_direction(scene, p_med, ray.wavelengths,
                                          u_nee, u2_nee, config)
    tr_sh = eval_transmittance(
        scene, p_med + ds.d * 1e-4, ds.d,
        torch.where(m_act & (ds.pdf > 0), ds.dist * (1 - 1e-3), 0.0), med,
        config, ray.wavelengths)
    ph_val = media_mod.phase_eval(g_hg, wi_med, ds.d)
    w_nee = torch.where(ds.delta, 1.0, mis_weight(ds.pdf, ph_val))
    contrib = throughput * alb * e_val * tr_sh * \
        (ph_val * w_nee / torch.clamp_min(ds.pdf, 1e-20))
    result = result + contrib.masked(m_act & (ds.pdf > 0))
    # phase sampling: value / pdf = 1
    u2_ph, sampler = sampler.next_2d()
    wo_med, ph_pdf = media_mod.phase_hg_sample(g_hg, wi_med, u2_ph)
    thr_med = throughput * alb

    # ---- a surface interaction ----------------------------------------------
    s_act = active & ~med_event & si.valid
    flags = bsdf_mod.lane_flags(scene, si)
    is_smooth = (flags & bsdf_mod.F_SMOOTH) != 0
    u_s, sampler = sampler.next_1d()
    u2_s, sampler = sampler.next_2d()
    ds_s, e_val_s = emitters.sample_direction(scene, si.p, si.wavelengths,
                                              u_s, u2_s, config)
    nee_s = s_act & is_smooth & (ds_s.pdf > 0)
    tr_s = eval_transmittance(
        scene, si.p + si.n * (torch.sign(vdot(si.n, ds_s.d)) * 1e-4),
        ds_s.d, torch.where(nee_s, ds_s.dist * (1 - 1e-3), 0.0), med, config,
        si.wavelengths)
    wo_local = si.to_local(ds_s.d)
    f_val = bsdf_mod.eval_(scene, si, wo_local, config)
    f_pdf = bsdf_mod.pdf(scene, si, wo_local, config)
    w_nee_s = torch.where(ds_s.delta, 1.0, mis_weight(ds_s.pdf, f_pdf))
    contrib_s = throughput * e_val_s * f_val * tr_s * \
        (w_nee_s / torch.clamp_min(ds_s.pdf, 1e-20))
    result = result + contrib_s.masked(nee_s)

    u1_b, sampler = sampler.next_1d()
    u2_b, sampler = sampler.next_2d()
    bs, b_weight = bsdf_mod.sample(scene, si, u1_b, u2_b, config)
    wo_surf = si.to_world(bs.wo)
    delta_s = (bs.sampled_flags & bsdf_mod.F_DELTA) != 0

    # ---- the continuation wavefront ---------------------------------------
    new_d = vwhere(med_event, wo_med, wo_surf)
    new_o = vwhere(med_event, p_med,
                   si.p + si.n * (torch.sign(vdot(si.n, wo_surf)) * 1e-4))
    throughput = swhere(m_act, thr_med,
                        swhere(s_act, throughput * b_weight, throughput))
    # a crossing by the SAMPLED lobe (a mask child's reflection stays on
    # its side), a delta or glossy transmission
    null_sampled = (bs.sampled_flags & bsdf_mod.F_NULL) != 0
    crossing = s_act & (
        null_sampled | ((bs.sampled_flags & bsdf_mod.F_DELTA_T) != 0)
        | ((bs.sampled_flags & bsdf_mod.F_GLOSSY_T) != 0))
    med = torch.where(crossing, _transition(scene, si, wo_surf, med), med)
    # a pure null crossing is no scattering event: it keeps the previous
    # vertex's MIS pdf and delta flag
    prev_pdf = torch.where(med_event, ph_pdf,
                           torch.where(null_sampled, prev_pdf, bs.pdf))
    prev_delta = torch.where(med_event, False,
                             torch.where(null_sampled, prev_delta, delta_s))
    active = active & (med_event | (s_act & (bs.pdf > 0)))
    active = active & throughput.any_positive()

    if config.rr_depth < config.max_depth:
        do_rr = (depth + 2 >= config.rr_depth) and \
            (depth + 2 < config.max_depth)
        q = (torch.clamp_max(throughput.hmax(), 0.95) if do_rr
             else torch.ones_like(prev_pdf))
        u_rr, sampler = sampler.next_1d()
        throughput = throughput / torch.clamp_min(q, 1e-8)
        active = active & (u_rr < q)

    ray = Ray.make(new_o, new_d, maxt=torch.where(active, float("inf"), 0.0),
                   wavelengths=ray.wavelengths)
    return (ray, sampler, throughput, result, med, active, prev_pdf,
            prev_delta)


def sample_path_vol(scene, ray: Ray, sampler: Sampler, config: RenderConfig
                    ) -> Tuple[Spec, Sampler]:
    """volpath.cpp's transport loop over one wavefront: max_depth - 1 full
    iterations, then a flight-only one that collects the last emitter
    hit. The camera starts in vacuum."""
    n, dev = ray.o.x.shape[0], ray.o.x.device
    C = config.n_channels
    # a camera RayDifferential becomes a plain Ray (no footprints here)
    ray = Ray(o=ray.o, d=ray.d, maxt=ray.maxt, wavelengths=ray.wavelengths,
              time=ray.time)
    carry = (ray, sampler, Spec.ones(n, C, dev), Spec.zeros(n, C, dev),
             torch.full((n,), -1, dtype=torch.int32, device=dev),
             torch.ones(n, dtype=torch.bool, device=dev),
             torch.zeros(n, dtype=torch.float32, device=dev),
             torch.ones(n, dtype=torch.bool, device=dev))
    for depth in range(config.max_depth - 1):
        # primary rays are already coherent: no presort
        carry = _vol_bounce(scene, config, depth, carry,
                            sort=False if depth == 0 else None)
    out = _vol_flight(scene, config, config.max_depth - 1, carry,
                      sort=False if config.max_depth == 1 else None)
    return out[5], out[3]
