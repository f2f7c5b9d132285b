"""The volumetric path tracer of the PyTorch port (render/volpath.py)
against the JAX package's, on the same seeds.

Homogeneous media draw the same numbers from the same streams in both
packages and take the same decisions: every pixel within rtol 1e-3 /
atol 1e-4 (absorbing and scattering slabs, volpathmis on a chromatic
medium in rgb and spectral mode, mono, a mask's partial shadow through
null_transmission). Delta tracking (a density grid) decides by
u < density / majorant, so an ulp can change a lane's path: its flights
are held decision by decision, the tie-free heterogeneous slab pixel by
pixel, and smoke_box(8) by its image mean and by the lanes of one bounce
that differ, all of which sit on its one exact tie (below). kitchen_sink
(the thin lens, the envmap, textures, a dielectric and a medium) passes
tests/test_golden.py's z-test against the committed golden.

smoke_box's tie: the null box's bottom face and the floor are coplanar
(y = 0). A ray leaving the smoke downward meets both at the same t;
op by op, in both packages, the two t are equal and the lower prim id,
the null face, wins; the JAX package's jit-fused Moller-Trumbore rounds
the floor's t one ulp lower. A lane that takes the null face is moved
1e-4 below the floor and escapes, one that takes the floor scatters off
it: the port's image is darker there (ROADMAP.md, Queue 3).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import mitsuba2_tpu as mi
from mitsuba2_tpu.scene import presets as jpresets
from mitsuba2_tpu.scene import shapes as jshapes
from mitsuba2_tpu.scene.scene import build_scene as jbuild
import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.core.geometry import Ray, Transform4
from mitsuba2_tpu_torch.core.spec import Spec
from mitsuba2_tpu_torch.core.vec import Vec3
from mitsuba2_tpu_torch.render import sampler as tsampler
from mitsuba2_tpu_torch.render import volpath
from mitsuba2_tpu_torch.scene import scene as scene_mod
from mitsuba2_tpu_torch.scene import shapes as tshapes

from goldens.jax_refs import Refs
from test_torch_render import GOLDEN_DIR, golden_z_test

# one intra-op thread: the suite's test processes share the cores
# (pytest-xdist), and torch's OpenMP regions stall when they
# oversubscribe them
torch.set_num_threads(1)

REFS = Refs("test_torch_volpath")

RENDER = dict(width=16, height=16, spp=8, spp_per_pass=8, max_depth=4,
              rr_depth=2)
MEDIA = {
    "absorbing": {"type": "homogeneous", "sigma_t": 0.6, "albedo": 0.0},
    "scattering": {"type": "homogeneous", "sigma_t": 1.5, "albedo": 0.8,
                   "g": 0.3},
    "chromatic": {"type": "homogeneous", "sigma_t": [0.3, 1.0, 3.0],
                  "albedo": [0.9, 0.5, 0.7], "g": -0.2},
    "grid": {"type": "heterogeneous", "sigma_t": 1.2, "albedo": 0.7,
             "g": 0.4, "bbox_min": [-2.0, -2.0, -0.5],
             "bbox_max": [2.0, 2.0, 0.5],
             "density": np.random.default_rng(9).uniform(
                 0, 1.5, (4, 6, 6)).astype(np.float32)},
}


def _slab(name, pkg):
    """The slab holding MEDIA[name]: the port's scene, or (pkg "jax") a
    function that builds the JAX package's."""
    med = MEDIA[name]
    if pkg == "jax":
        return lambda: _with_medium(jshapes, jbuild, med)
    return _with_medium(tshapes, mt.build_scene, med, device="cpu")


def _with_medium(shapes, build, med, **kw):
    """tests/test_medium_grad.py's slab holding `med`, seen from above and
    beside, over a diffuse floor that the medium's scattering lights."""
    cube = shapes.cube(bsdf={"type": "null"}, id="vol").transformed(
        np.asarray((Transform4.translate([0, 0, 0]) @
                    Transform4.scale([2.0, 2.0, 0.5])).matrix))
    cube.interior = med
    wall = shapes.rectangle(
        bsdf={"type": "diffuse", "reflectance": [0, 0, 0]},
        emitter={"type": "area", "radiance": [2.0] * 3},
        id="wall").transformed(
        np.asarray(Transform4.translate([0, 0, -2.0]).matrix))
    side = shapes.rectangle(
        bsdf={"type": "diffuse", "reflectance": [0.6, 0.5, 0.4]},
        id="side").transformed(
        np.asarray((Transform4.translate([0, -2.5, -1.0]) @
                    Transform4.rotate([1, 0, 0], -90.0) @
                    Transform4.scale([3.0, 3.0, 1.0])).matrix))
    cam = Transform4.look_at(origin=[0.5, 1.0, 4], target=[0, -0.3, 0],
                             up=[0, 1, 0])
    return build([cube, wall, side],
                 {"type": "perspective",
                  "to_world": np.asarray(cam.matrix), "fov": 35.0}, **kw)


def _renders(key, mk_j, st, seed=1, **kw):
    """The port's render of `st` and the JAX package's of mk_j()'s scene,
    read from tests/goldens/test_torch_volpath.npz under `key`."""
    cfg = {**RENDER, **kw}
    img_j = REFS.get(key, lambda: np.asarray(
        mi.render(mk_j(), mi.RenderConfig(**cfg), seed=seed)))
    img_t = mt.render(st, mt.RenderConfig(**cfg), seed=seed,
                      device="cpu").numpy()
    assert img_t.shape == img_j.shape and np.isfinite(img_t).all()
    return img_t, img_j


def _every_pixel(img_t, img_j):
    assert np.isclose(img_t, img_j, rtol=1e-3, atol=1e-4).all(), \
        np.abs(img_t - img_j).max()
    assert img_j.mean() > 0


@pytest.mark.parametrize("name", ["absorbing", "scattering"])
def test_homogeneous_slab_matches_jax(name):
    _every_pixel(*_renders(f"slab_{name}", _slab(name, "jax"),
                           _slab(name, "port"), integrator="volpath"))


def test_golden_is_fresh():
    """The golden's absorbing-slab image recomputed by the JAX package."""
    cfg = mi.RenderConfig(**RENDER, integrator="volpath")
    stored, live = REFS.fresh("slab_absorbing", lambda: np.asarray(
        mi.render(_slab("absorbing", "jax")(), cfg, seed=1)))
    np.testing.assert_array_equal(stored, live)


@pytest.mark.parametrize("mode", ["rgb", "spectral"])
def test_volpathmis_chromatic_matches_jax(mode):
    """Spectral MIS over the channels (volpathmis.cpp) on a medium whose
    extinction spans 10x across the channels."""
    _every_pixel(*_renders(f"chromatic_{mode}", _slab("chromatic", "jax"),
                           _slab("chromatic", "port"),
                           integrator="volpathmis", color_mode=mode))


def test_mono_matches_jax():
    """mono: the channel-mean extinction and albedo."""
    _every_pixel(*_renders("chromatic_mono", _slab("chromatic", "jax"),
                           _slab("chromatic", "port"),
                           integrator="volpath", color_mode="mono"))


def _mask_scene(shapes, build, **kw):
    """A floor under an area light, a mask of opacity 0.3 between them
    (its shadow: 1 - opacity through null_transmission) and a null pane
    (transmission 1) beside it."""
    floor = shapes.rectangle(
        bsdf={"type": "diffuse", "reflectance": [0.8] * 3},
        id="floor").transformed(
        np.asarray((Transform4.rotate([1, 0, 0], -90.0) @
                    Transform4.scale([3.0, 3.0, 1.0])).matrix))
    mask = shapes.rectangle(
        bsdf={"type": "mask", "opacity": 0.3,
              "bsdf": {"type": "diffuse", "reflectance": [0.2, 0.7, 0.3]}},
        id="mask").transformed(
        np.asarray((Transform4.translate([-0.6, 1.0, 0.0]) @
                    Transform4.rotate([1, 0, 0], 90.0) @
                    Transform4.scale([0.6, 0.6, 1.0])).matrix))
    pane = shapes.rectangle(bsdf={"type": "null"}, id="pane").transformed(
        np.asarray((Transform4.translate([0.7, 0.8, 0.0]) @
                    Transform4.rotate([1, 0, 0], 90.0) @
                    Transform4.scale([0.5, 0.5, 1.0])).matrix))
    light = shapes.rectangle(
        bsdf={"type": "diffuse", "reflectance": [0, 0, 0]},
        emitter={"type": "area", "radiance": [6.0] * 3},
        id="light").transformed(
        np.asarray((Transform4.translate([0, 2.2, 0]) @
                    Transform4.rotate([1, 0, 0], 90.0) @
                    Transform4.scale([0.5, 0.5, 1.0])).matrix))
    cam = Transform4.look_at(origin=[0, 3.0, 3.5], target=[0, 0, 0],
                             up=[0, 1, 0])
    return build([floor, mask, pane, light],
                 {"type": "perspective",
                  "to_world": np.asarray(cam.matrix), "fov": 50.0}, **kw)


def test_mask_shadow_matches_jax():
    """volpath's shadow rays through a mask (1 - opacity) and a null pane
    (1): the partial shadow on the floor, pixel by pixel."""
    st = _mask_scene(tshapes, mt.build_scene, device="cpu")
    img_t, img_j = _renders("mask", lambda: _mask_scene(jshapes, jbuild), st,
                            integrator="volpath", max_depth=3, rr_depth=8)
    _every_pixel(img_t, img_j)
    # the mask's shadow is partial: neither black nor the open floor
    from mitsuba2_tpu_torch.render import bsdf
    si = scene_mod.ray_intersect(st, Ray.make(
        Vec3(*torch.tensor([[-0.6, 0.7], [2.0, 2.0], [0.0, 0.0]]).unbind(0)),
        Vec3(*torch.tensor([[0.0, 0.0], [-1.0, -1.0], [0.0, 0.0]]).unbind(
            0))))
    tr = bsdf.null_transmission(st, si, mt.RenderConfig())
    assert torch.allclose(tr.ch[0], torch.tensor([0.7, 1.0]))


def test_heterogeneous_slab_matches_jax():
    """Delta tracking on a tie-free scene: every pixel."""
    img_t, img_j = _renders("slab_grid", _slab("grid", "jax"),
                            _slab("grid", "port"), integrator="volpath")
    _every_pixel(img_t, img_j)


# ---------------------------------------------------------------------------
# smoke_box(8)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    """A function that builds the JAX package's smoke_box(8), and the
    port's."""
    return (lambda: jpresets.smoke_box(8)), mt.smoke_box(8, device="cpu")


def _inside_lanes(n=4096, seed=0):
    """Rays from inside smoke_box's plume box, in every direction."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-0.7, 0.1, -0.7], [0.7, 1.7, 0.7], (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _jax_ray(o, d):
    import jax.numpy as jnp
    from mitsuba2_tpu.core.geometry import Ray as JRay
    from mitsuba2_tpu.core.vec import Vec3 as JVec3
    return JRay.make(JVec3(*jnp.asarray(o.T)), JVec3(*jnp.asarray(d.T)))


def _port_ray(o, d):
    return Ray.make(Vec3(*torch.from_numpy(o.T.copy())),
                    Vec3(*torch.from_numpy(d.T.copy())))


def test_delta_tracking_decisions_match_jax(smoke):
    """One heterogeneous flight of 4 096 lanes inside the plume: the same
    forked streams, the same decisions (no lane flips), the same
    distances to f32 rounding, the same unit weights; and the loop's trip
    count (the JAX while_loop's) among the stats it records."""
    import jax
    import jax.numpy as jnp
    from mitsuba2_tpu.render import sampler as jsampler
    from mitsuba2_tpu.render import volpath as jvolpath
    from mitsuba2_tpu.scene import scene as jscene
    mk_j, st = smoke
    o, d = _inside_lanes()
    n = o.shape[0]
    med = np.zeros(n, np.int32)
    med[::7] = -1                                   # some lanes in vacuum
    u = np.random.default_rng(1).uniform(size=n).astype(np.float32)

    def jax_flight():
        sj = mk_j()
        rj = _jax_ray(o, d)
        si = jscene.ray_intersect(sj, rj)
        t_surf = np.asarray(jnp.where(si.valid, si.t, 1e20))
        flight = jax.jit(lambda r, m, t, uu, s: jvolpath._sample_free_flight(
            sj, m, r, t, uu, s, mi.RenderConfig(integrator="volpath")))
        tj, ej, wj, _ = flight(rj, jnp.asarray(med), jnp.asarray(t_surf),
                               jnp.asarray(u), jsampler.make_sampler(
                                   "independent", jnp.uint32(5),
                                   jnp.arange(n, dtype=jnp.uint32), 1, 1))
        return t_surf, np.asarray(tj), np.asarray(ej), np.asarray(wj.ch[0])
    t_surf, tj, ej, wj = REFS.get("smoke_flight", jax_flight)
    volpath.TRACK_STATS = []
    try:
        tt, et, wt, _ = volpath._sample_free_flight(
            st, torch.from_numpy(med), _port_ray(o, d),
            torch.from_numpy(t_surf.copy()), torch.from_numpy(u),
            tsampler.make_sampler("independent", 5, torch.arange(n)),
            mt.RenderConfig(integrator="volpath"))
        (trip, trials, tracked, loop), = volpath.TRACK_STATS
    finally:
        volpath.TRACK_STATS = None
    flips = int((et.numpy() != np.asarray(ej)).sum())
    assert flips == 0 and 0.1 < et.numpy().mean() < 0.9
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-5)
    assert (wt.ch[0].numpy() == 1.0).all() and (wj == 1).all()
    assert tracked == n - len(med[::7]) and trials >= tracked
    assert 0 < trip <= loop <= volpath._DELTA_STEPS and loop % 8 == 0


def test_smoke_box_bounce_differs_only_on_the_tie(smoke):
    """One full volpath bounce (medium and surface events, NEE through the
    grid, phase sampling, crossings) of 4 096 lanes inside the plume:
    every lane whose outputs differ from the JAX package's is a lane whose
    closest hit is the coplanar box-bottom / floor tie, resolved the other
    way (the box's prims 0-1 against the floor's 2-3)."""
    import jax
    import jax.numpy as jnp
    from mitsuba2_tpu.core.spec import Spec as JSpec
    from mitsuba2_tpu.render import sampler as jsampler
    from mitsuba2_tpu.render import volpath as jvolpath
    from mitsuba2_tpu.scene import scene as jscene
    mk_j, st = smoke
    o, d = _inside_lanes(seed=2)
    n = o.shape[0]
    cfg = dict(integrator="volpath", max_depth=3, rr_depth=8)

    def jax_bounce():
        sj = mk_j()
        carry_j = (_jax_ray(o, d), jsampler.make_sampler(
            "independent", jnp.uint32(5), jnp.arange(n, dtype=jnp.uint32), 1,
            1), JSpec.ones((n,), 3), JSpec.zeros((n,), 3),
            jnp.zeros(n, jnp.int32), jnp.ones(n, bool),
            jnp.full(n, 0.3, jnp.float32), jnp.zeros(n, bool))
        out_j = jax.jit(lambda c: jvolpath._vol_bounce(
            sj, mi.RenderConfig(**cfg), 1, c))(carry_j)
        prim_j = jax.jit(lambda r: jscene.ray_intersect(sj, r))(
            _jax_ray(o, d)).prim_index
        return ({k: [np.asarray(c) for c in out_j[k].ch] for k in (2, 3)},
                {k: np.asarray(out_j[k]) for k in (4, 5, 7)},
                np.asarray(prim_j))
    specs_j, flags_j, prim_j = REFS.get("smoke_bounce", jax_bounce)
    carry_t = (_port_ray(o, d),
               tsampler.make_sampler("independent", 5, torch.arange(n)),
               Spec.ones(n, 3, "cpu"), Spec.zeros(n, 3, "cpu"),
               torch.zeros(n, dtype=torch.int32),
               torch.ones(n, dtype=torch.bool), torch.full((n,), 0.3),
               torch.zeros(n, dtype=torch.bool))
    out_t = volpath._vol_bounce(st, mt.RenderConfig(**cfg), 1, carry_t)
    differ = np.zeros(n, bool)
    for k in (2, 3):    # throughput, result
        for c in range(3):
            differ |= ~np.isclose(out_t[k].ch[c].numpy(),
                                  specs_j[str(k)][c], rtol=1e-4,
                                  atol=1e-6)
    for k in (4, 5, 7):  # medium, active, previous delta
        differ |= out_t[k].numpy() != flags_j[str(k)]
    prim_t = scene_mod.ray_intersect(st, _port_ray(o, d)).prim_index.numpy()
    tie = (prim_j != prim_t) & (d[:, 1] < 0)
    assert set(prim_t[tie]) | set(prim_j[tie]) <= {0, 1, 2, 3}
    assert not (differ & ~tie).any()
    assert differ.sum() <= tie.sum() and tie.mean() < 0.03


def test_smoke_box_image_mean(smoke):
    """smoke_box(8) at 16x16, 4 spp, depth 3 (bench.py's smoke config at
    test size): depth 2 (no scattering vertex) pixel for pixel; depth 3
    within 8% of the JAX package's image mean, darker (the tie above:
    6.4% at this seed), most pixels close."""
    mk_j, st = smoke
    kw = dict(spp=4, spp_per_pass=4, rr_depth=8, integrator="volpath")
    _every_pixel(*_renders("smoke_d2", mk_j, st, max_depth=2, **kw))
    img_t, img_j = _renders("smoke_d3", mk_j, st, max_depth=3, **kw)
    ratio = img_t.mean() / img_j.mean()
    assert 0.92 < ratio < 1.0
    close = np.isclose(img_t, img_j, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() > 0.8


def test_kitchen_sink_golden():
    """tests/test_golden.py's kitchen_sink z-test on the port's render:
    the thin-lens camera, the envmap, textures, a rough conductor, a
    dielectric sphere and a homogeneous medium in a null cube."""
    ref = np.load(os.path.join(GOLDEN_DIR, "kitchen_sink.npz"))["image"]
    cfg = mt.RenderConfig(width=32, height=32, spp=64, spp_per_pass=64,
                          max_depth=4, rr_depth=99)
    golden_z_test(mt.kitchen_sink(device="cpu"), cfg, ref)


def _jax_reparam_slab(cfg):
    from mitsuba2_tpu.diff.adjoint import render_and_grad
    import jax.numpy as jnp
    img, loss, g = render_and_grad(
        _slab("scattering", "jax")(), mi.RenderConfig(**cfg),
        lambda im: jnp.mean(im ** 2), seed=1)
    return np.asarray(img), float(loss), {k: np.asarray(v)
                                          for k, v in g.items()}


def test_reparam_with_media_refused():
    """reparam=True on a volumetric render, which the port refused until
    it rendered it: the camera ray warped, volpath's bounces without
    warps, as the JAX package does. The scattering slab's image every
    pixel as above, render_and_grad's loss within rtol 1e-4 and each
    gradient table within 1e-3 of its largest JAX entry. The JAX
    package's d/d(phase g) is NaN on this slab with or without reparam
    (ROADMAP.md, Queue 3): there the port's must be finite."""
    cfg = {**RENDER, "integrator": "volpath", "reparam": True}
    img_j, loss_j, g_j = REFS.get("reparam_scattering",
                                  lambda: _jax_reparam_slab(cfg))
    from mitsuba2_tpu_torch.diff.adjoint import render_and_grad
    img, loss, g = render_and_grad(
        _slab("scattering", "port"), mt.RenderConfig(**cfg),
        lambda im: torch.mean(im ** 2), seed=1, device="cpu")
    _every_pixel(img.numpy(), img_j)
    np.testing.assert_allclose(float(loss), loss_j, rtol=1e-4)
    assert set(g) == set(g_j)
    for k, gj in g_j.items():
        nan = np.isnan(gj)
        assert nan.sum() <= (1 if k == "med_data" else 0), k
        assert np.isfinite(g[k].numpy()).all(), k
        np.testing.assert_allclose(g[k].numpy()[~nan], gj[~nan], rtol=0,
                                   atol=1e-3 * np.abs(gj[~nan]).max(),
                                   err_msg=k)


def test_phase_g_gradient_matches_central_difference():
    """d/d med_data[0, 6] (the HG asymmetry g 0.3) of the scattering slab's
    mean squared image (16x16, 8 spp, depth 4, seed 1) by render_and_grad
    against a central difference of two renders at the same seed, in
    tests/test_medium_grad.py's band. The JAX package's is NaN here
    (ROADMAP.md, Queue 3); the port samples HG detached, so the
    derivative is d(phase)/dg / phase on the phase-sampled paths."""
    import chip_smoke
    from mitsuba2_tpu_torch.diff.adjoint import render_and_grad
    scene = _slab("scattering", "port")
    cfg = mt.RenderConfig(**RENDER, integrator="volpath")
    _, _, g = render_and_grad(scene, cfg, lambda im: torch.mean(im ** 2),
                              seed=1, device="cpu")
    ad = float(g["med_data"][0, 6])

    def loss_at(d):
        md = scene.med_data.clone()
        md[0, 6] += d
        img = mt.render(dataclasses.replace(scene, med_data=md), cfg, seed=1,
                        device="cpu")
        return float(torch.mean(img ** 2))

    # tests/test_medium_grad.py's central-difference step and band
    eps = chip_smoke.MEDIUM_FD_EPS
    fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
    print(f"d/dg: AD {ad:.4e}, central difference {fd:.4e}")
    assert np.isfinite(ad) and ad < 0
    np.testing.assert_allclose(ad, fd, rtol=chip_smoke.MEDIUM_FD_RTOL)


def test_volpath_traversal_calls_per_pass():
    """A volpath pass calls the closest hit chip_smoke's count of times (a
    flight a bounce and the trailing one, three transmittance segments a
    shadow ray, two shadow rays a bounce) and never the any hit:
    chip_smoke holds the walk kernels' launches to it on gallery_fog."""
    import chip_smoke
    from mitsuba2_tpu_torch.kernels import traverse
    from mitsuba2_tpu_torch.scene import presets as tpresets
    scene = chip_smoke.gallery_fog(tpresets, 1, device="cpu")
    assert scene.mxu_node_f is not None and scene.has_media
    calls = []
    orig = (traverse.ray_intersect_preliminary, traverse.ray_test)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(traverse, "ray_intersect_preliminary",
                   lambda *a: calls.append("closest") or orig[0](*a))
        mp.setattr(traverse, "ray_test",
                   lambda *a: calls.append("any") or orig[1](*a))
        for depth in (1, 3):
            calls.clear()
            img = mt.render(scene, mt.RenderConfig(
                width=8, height=8, spp=2, spp_per_pass=2, max_depth=depth,
                integrator="volpath"), device="cpu")
            assert bool(torch.isfinite(img).all())
            assert calls == ["closest"] * \
                chip_smoke.volpath_closest_launches(depth)


def test_probe_rays_on_smoke_box(smoke):
    """chip_smoke's probe rays on a scene seen mostly through a null box:
    shadow rays drawn in more rounds, each facing its light."""
    from mitsuba2_tpu_torch.probe_rays import KINDS, probe_rays
    from mitsuba2_tpu_torch.kernels import brute
    st = smoke[1]

    def closest(o, d, t_max):
        t, prim, _, _ = brute.ray_intersect_brute(
            st, Vec3(*torch.from_numpy(o.T.copy())),
            Vec3(*torch.from_numpy(d.T.copy())), torch.from_numpy(t_max))
        return t.numpy(), prim.numpy(), None

    rays = probe_rays(st, 2048, 0, closest)
    assert set(rays) == set(KINDS)
    o, d, tm = rays["shadow"]
    assert o.shape == (2048, 3) and (tm > 0).all()
    assert (d[:, 1] > 0).all()           # up to the light at y = 2.6


def test_media_presets_need_cuda():
    """smoke_box and kitchen_sink run on the CUDA device unless asked for
    the CPU, and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    for make in (lambda: mt.smoke_box(4), mt.kitchen_sink):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
