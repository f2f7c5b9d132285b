"""Polarized rendering in the PyTorch port against the JAX package.

The Mueller calculus (render/mueller.py) function by function over a
seeded sweep of angles and IORs, grazing incidence and large extinction
coefficients among them (atol 1e-6), the conductor on its complex square
root's branch cut (k = 0, eta < 1), and tests/test_mueller.py's
identities on the port's functions; tests/test_stokes.py's scenes (the
Brewster plate, the gold plate, a diffuse Cornell box, two polarizers at
0, 45 and 90 degrees, a diffuse plane against the scalar render, a tilted
gold mirror, the Cornell box in spectral mode) through render_stokes and
render_polarized, rgb and spectral, each image held to the JAX package's
(>= 99% of pixels within rtol 1e-3 / atol 1e-4) and to the physics the
JAX test asserts; chip_smoke's gallery_polarized at subdiv 1 carried from
the JAX build through scene_from_numpy (render_polarized in rgb and
spectral mode, render_stokes, the scalar render of its measured blobs);
render_any's stokes route; a polarizer and a retarder's parameters and
render_l2_grad with respect to the polarizer's transmittance against the
JAX package's render_and_grad. The JAX package's arrays are committed
(tests/goldens/test_torch_polarized.npz, `python tests/goldens/
make_refs.py test_torch_polarized`); one entry is recomputed live.
"""
import types

import numpy as np
import pytest
import torch

import chip_smoke
import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.render import mueller as tmu
from mitsuba2_tpu_torch.render.measured import TABLES
from mitsuba2_tpu_torch.scene import presets as tpresets

from goldens.jax_refs import Refs
from test_torch_media import jax_fields

# one intra-op thread: the suite's test processes share the cores
# (pytest-xdist), and torch's OpenMP regions stall when they
# oversubscribe them
torch.set_num_threads(1)

REFS = Refs("test_torch_polarized")


def package(which):
    """A package's scene building and polarized entry points, under common
    names; the port's on the CPU."""
    if which == "jax":
        import mitsuba2_tpu as mi
        from mitsuba2_tpu.core.geometry import Transform4
        from mitsuba2_tpu.render import integrators, stokes
        from mitsuba2_tpu.scene import presets, shapes
        from mitsuba2_tpu.scene.scene import build_scene
        return types.SimpleNamespace(
            shapes=shapes, T4=Transform4, build=build_scene, presets=presets,
            Config=mi.RenderConfig, render=integrators.render,
            polarized=stokes.render_polarized, stokes=stokes.render_stokes,
            np=np.asarray)
    from mitsuba2_tpu_torch.core.geometry import Transform4
    from mitsuba2_tpu_torch.scene import shapes

    def cpu(fn):
        return lambda *a, **kw: fn(*a, device="cpu", **kw)

    return types.SimpleNamespace(
        shapes=shapes, T4=Transform4, build=cpu(mt.build_scene),
        presets=types.SimpleNamespace(
            cornell_box=cpu(tpresets.cornell_box)),
        Config=mt.RenderConfig, render=cpu(mt.render),
        polarized=cpu(mt.render_polarized), stokes=cpu(mt.render_stokes),
        np=lambda t: t.numpy())


def assert_image_close(img_t, img_j):
    """>= 99% of the pixels within rtol 1e-3 / atol 1e-4 in every channel
    and Stokes component, finite."""
    img_j = np.asarray(img_j)
    assert img_t.shape == img_j.shape and np.isfinite(img_t).all()
    pix = img_t.reshape(img_t.shape[0], img_t.shape[1], -1)
    ref = img_j.reshape(pix.shape)
    close = np.isclose(pix, ref, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99, close.mean()


# ---------------------------------------------------------------------------
# Mueller calculus
# ---------------------------------------------------------------------------

N_SWEEP = 1024


def _sweep():
    """Seeded inputs: cosines down to 1e-4 (a tenth of them grazing,
    below 1e-2), conductors' eta up to 3 and k up to 12, dielectrics'
    eta on both sides of 1 (total internal reflection), angles, unit
    directions and bases."""
    rng = np.random.default_rng(23)
    n = N_SWEEP
    cos = rng.uniform(1e-4, 1.0, n)
    cos[: n // 10] = rng.uniform(1e-4, 1e-2, n // 10)
    w = rng.normal(size=(n, 3))
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    b2 = np.cross(w, rng.normal(size=(n, 3)))
    b2 /= np.linalg.norm(b2, axis=-1, keepdims=True)
    f = np.float32
    return dict(cos=cos.astype(f), eta_re=rng.uniform(0.05, 3.0, n).astype(f),
                eta_im=rng.uniform(0.0, 12.0, n).astype(f),
                eta_d=rng.uniform(0.4, 2.5, n).astype(f),
                theta=rng.uniform(-np.pi, np.pi, n).astype(f),
                value=rng.uniform(0.0, 1.5, n).astype(f),
                w=w.astype(f), b2=b2.astype(f))


# name -> f(mueller module, inputs as that module's arrays): each function
# of render/mueller.py
SWEEP = {
    "depolarizer": lambda mu, x: mu.depolarizer(x["value"]),
    "absorber": lambda mu, x: mu.absorber(x["value"]),
    "linear_polarizer": lambda mu, x: mu.linear_polarizer(x["value"]),
    "linear_retarder": lambda mu, x: mu.linear_retarder(x["theta"]),
    "rotator": lambda mu, x: mu.rotator(x["theta"]),
    "rotated_element": lambda mu, x: mu.rotated_element(
        x["theta"], mu.linear_retarder(x["value"])),
    "specular_reflection_conductor": lambda mu, x:
        mu.specular_reflection_conductor(x["cos"], x["eta_re"], x["eta_im"]),
    "specular_reflection_dielectric": lambda mu, x:
        mu.specular_reflection_dielectric(x["cos"], x["eta_d"]),
    "specular_transmission_dielectric": lambda mu, x:
        mu.specular_transmission_dielectric(x["cos"], x["eta_d"]),
    "stokes_basis": lambda mu, x: mu.stokes_basis(x["w"]),
    "rotate_stokes_basis": lambda mu, x: mu.rotate_stokes_basis(
        x["w"], mu.stokes_basis(x["w"]), x["b2"]),
    "unpolarized_intensity": lambda mu, x: mu.unpolarized_intensity(
        x["value"]),
}


def _jax_sweep(name):
    import jax.numpy as jnp
    from mitsuba2_tpu.render import mueller as jmu
    x = {k: jnp.asarray(v) for k, v in _sweep().items()}
    return np.asarray(SWEEP[name](jmu, x))


def test_golden_is_fresh():
    """The golden's conductor sweep recomputed now."""
    stored, live = REFS.fresh("sweep/specular_reflection_conductor",
                              lambda: _jax_sweep(
                                  "specular_reflection_conductor"))
    np.testing.assert_array_equal(stored, live)


@pytest.mark.parametrize("name", sorted(SWEEP))
def test_mueller_sweep_matches_jax(name):
    """Each function on the sweep's inputs within atol 1e-6 of the JAX
    package's (the conductor's complex64 square root among them); the
    largest gap is printed."""
    ref = REFS.get(f"sweep/{name}", lambda: _jax_sweep(name))
    x = {k: torch.from_numpy(v) for k, v in _sweep().items()}
    got = SWEEP[name](tmu, x).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    gap = float(np.abs(got - ref).max())
    print(f"{name}: largest gap {gap:.3e}")
    assert gap <= 1e-6


def _branch_cut_inputs():
    """A conductor with k = 0 and eta from 0.3 to 1.5 over cosines from
    1e-4 to 1: for eta < 1, past the critical angle, the complex square
    root's argument is a negative real, on its branch cut."""
    cos = np.linspace(1e-4, 1.0, 2001).astype(np.float32)
    eta = np.repeat(np.float32([0.3, 0.5, 0.9, 1.5]), cos.size)
    return np.tile(cos, 4), eta, np.zeros_like(eta)


def _jax_branch_cut():
    import jax.numpy as jnp
    from mitsuba2_tpu.render import mueller as jmu
    return np.asarray(jmu.specular_reflection_conductor(
        *(jnp.asarray(a) for a in _branch_cut_inputs())))


def test_conductor_branch_cut_matches_jax():
    """On the branch cut both packages take the same root: every entry's
    sign agrees, and the largest gap (printed; 2.4e-6 on two lanes at
    eta 0.9's critical angle, where the root of a near-zero argument
    loses its digits) stays within 1e-5."""
    ref = REFS.get("branch_cut", _jax_branch_cut)
    got = tmu.specular_reflection_conductor(
        *(torch.from_numpy(a) for a in _branch_cut_inputs())).numpy()
    gap = np.abs(got - ref).max((1, 2))
    print(f"branch cut: largest gap {gap.max():.3e}, "
          f"{int((gap > 1e-6).sum())} of {gap.size} lanes beyond 1e-6")
    big = np.abs(ref) > 1e-3
    assert (np.sign(got[big]) == np.sign(ref[big])).all()
    assert gap.max() <= 1e-5


def _identity_cases(mu, fr, arr):
    """tests/test_mueller.py's eight cases, computed with a package's
    mueller and fresnel modules (`arr` its array constructor): name ->
    (the arrays the case asserts on)."""
    out = {}
    s0 = mu.unpolarized_intensity(arr(1.0))
    p0 = mu.linear_polarizer(arr(1.0))
    malus = []
    for deg in (0, 30, 45, 60, 90):
        p1 = mu.rotated_element(arr(np.deg2rad(deg)),
                                mu.linear_polarizer(arr(1.0)))
        malus.append((p1 @ (p0 @ s0[..., None]))[0, 0])
    out["malus_law"] = (np.asarray([float(v) for v in malus]),)
    out["quarter_wave_plate_circular"] = (np.asarray(
        mu.linear_retarder(arr(np.pi / 2)) @ arr([1.0, 0.0, 1.0, 0.0])),)
    out["rotator_roundtrip"] = (np.asarray(
        mu.rotator(arr(0.7)) @ mu.rotator(arr(-0.7))),)
    cos_i = arr(np.linspace(0.05, 1.0, 32))
    out["fresnel_unpolarized_matches_scalar"] = (
        np.asarray(mu.specular_reflection_dielectric(cos_i, arr(1.5))[
            ..., 0, 0]),
        np.asarray(fr.fresnel(cos_i, arr(1.5))[0]),
        np.asarray(mu.specular_reflection_conductor(cos_i, arr(0.2), arr(
            3.0))[..., 0, 0]),
        np.asarray(fr.fresnel_conductor(cos_i, arr(0.2), arr(3.0))))
    out["brewster_full_polarization"] = (np.asarray(
        mu.specular_reflection_dielectric(arr(np.cos(np.arctan(1.5))),
                                          arr(1.5))
        @ arr([1.0, 0.0, 0.0, 0.0])),)
    c3 = arr([0.9, 0.7, 0.6])
    out["transmission_energy_plus_reflection"] = (
        np.asarray(mu.specular_reflection_dielectric(c3, arr(1.5))[
            ..., 0, 0]),
        np.asarray(mu.specular_transmission_dielectric(c3, arr(1.5))[
            ..., 0, 0]))
    w = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    out["stokes_basis_orthogonal"] = (w, np.asarray(mu.stokes_basis(arr(w))))
    z = arr([0.0, 0.0, 1.0])
    out["rotate_stokes_basis_identity"] = (np.asarray(mu.rotate_stokes_basis(
        z, mu.stokes_basis(z), mu.stokes_basis(z))),)
    return out


def _port_identity_cases():
    from mitsuba2_tpu_torch.render import fresnel as tfr
    return _identity_cases(tmu, tfr, lambda a: torch.as_tensor(
        np.asarray(a, np.float32)))


def _jax_identity_case(name):
    import jax.numpy as jnp
    from mitsuba2_tpu.render import fresnel as jfr
    from mitsuba2_tpu.render import mueller as jmu
    return _identity_cases(jmu, jfr, lambda a: jnp.asarray(
        np.asarray(a, np.float32)))[name]


IDENTITY_CASES = ("malus_law", "quarter_wave_plate_circular",
                  "rotator_roundtrip", "fresnel_unpolarized_matches_scalar",
                  "brewster_full_polarization",
                  "transmission_energy_plus_reflection",
                  "stokes_basis_orthogonal", "rotate_stokes_basis_identity")


@pytest.mark.parametrize("name", IDENTITY_CASES)
def test_mueller_identities(name):
    """tests/test_mueller.py's cases on the port's functions: the
    identity the JAX test asserts, and every array within atol 1e-6 of
    the JAX package's."""
    got = _port_identity_cases()[name]
    ref = REFS.get(f"identity/{name}", lambda: _jax_identity_case(name))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=1e-6)
    if name == "malus_law":
        th = np.deg2rad([0, 30, 45, 60, 90])
        np.testing.assert_allclose(got[0], 0.5 * np.cos(th) ** 2, atol=1e-6)
    elif name == "quarter_wave_plate_circular":
        np.testing.assert_allclose(got[0], [1, 0, 0, 1], atol=1e-6)
    elif name == "rotator_roundtrip":
        np.testing.assert_allclose(got[0], np.eye(4), atol=1e-6)
    elif name == "fresnel_unpolarized_matches_scalar":
        np.testing.assert_allclose(got[0], got[1], atol=1e-5)
        np.testing.assert_allclose(got[2], got[3], atol=1e-4)
    elif name == "brewster_full_polarization":
        np.testing.assert_allclose(abs(got[0][1]), got[0][0], rtol=1e-4)
    elif name == "transmission_energy_plus_reflection":
        np.testing.assert_allclose(got[0] + got[1], 1.0, atol=1e-4)
    elif name == "stokes_basis_orthogonal":
        w, b = got
        np.testing.assert_allclose((b * w).sum(-1), 0, atol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(b, axis=-1), 1, atol=1e-4)
    else:
        np.testing.assert_allclose(got[0], np.eye(4), atol=1e-6)


# ---------------------------------------------------------------------------
# tests/test_stokes.py's scenes, in both packages
# ---------------------------------------------------------------------------

SKY = [{"type": "constant", "radiance": [1.0] * 3}]


def _sensor(pkg, origin, target, up, fov):
    cam = pkg.T4.look_at(origin=origin, target=target, up=up)
    return {"type": "perspective", "to_world": np.asarray(cam.matrix),
            "fov": fov}


def brewster_plate(pkg):
    """A glass plate (eta 1.5) seen at Brewster's angle under the sky."""
    th = np.arctan(1.5)
    return pkg.build(
        [pkg.shapes.rectangle(bsdf={"type": "dielectric", "int_ior": 1.5})],
        _sensor(pkg, [0, -3 * np.sin(th), 3 * np.cos(th)], [0, 0, 0],
                [0, 0, 1], 10.0), emitters=SKY)


def gold_plate(pkg):
    return pkg.build(
        [pkg.shapes.rectangle(bsdf={"type": "conductor", "material": "Au"})],
        _sensor(pkg, [0, -2, 2], [0, 0, 0], [0, 0, 1], 20.0), emitters=SKY)


def diffuse_box(pkg):
    return pkg.presets.cornell_box(boxes=False)


def two_polarizers(pkg, theta2):
    """The camera looks -z through polarizers at 0 and theta2 degrees."""
    T4, sh = pkg.T4, pkg.shapes
    panes = [sh.rectangle(bsdf={"type": "polarizer", "theta": th}).transformed(
        np.diag([3.0, 3.0, 1.0, 1.0]) @ np.asarray(T4.translate(
            [0, 0, z]).matrix)) for th, z in ((0.0, 2), (theta2, 1))]
    return pkg.build(panes, _sensor(pkg, [0, 0, 5], [0, 0, 0], [0, 1, 0],
                                    20.0), emitters=SKY)


def diffuse_plane(pkg):
    return pkg.build(
        [pkg.shapes.rectangle(bsdf={"type": "diffuse",
                                    "reflectance": [0.7] * 3})],
        _sensor(pkg, [0, 0, 3], [0, 0, 0], [0, 1, 0], 45.0), emitters=SKY)


def gold_mirror(pkg):
    """A gold mirror tilted 45 degrees about x, reflecting the sky."""
    mirror = pkg.shapes.rectangle(
        bsdf={"type": "conductor", "material": "Au"}).transformed(
        np.asarray(pkg.T4.rotate([1, 0, 0], 45.0).matrix))
    return pkg.build([mirror], _sensor(pkg, [0, -3, 0.3], [0, 0, 0.3],
                                       [0, 0, 1], 30.0), emitters=SKY)


def cornell(pkg):
    return pkg.presets.cornell_box()


STOKES = dict(width=16, height=16, spp=16, spp_per_pass=16, max_depth=2)
POLARIZED = dict(width=16, height=16, spp=16, spp_per_pass=16, max_depth=4,
                 rr_depth=99)
# name -> (scene builder, entry point, config, color modes)
CASES = {
    "brewster": (brewster_plate, "stokes", STOKES, ("rgb",)),
    "gold": (gold_plate, "stokes", STOKES, ("rgb",)),
    "diffuse_box": (diffuse_box, "stokes", STOKES, ("rgb",)),
    "polarizers_0": (lambda p: two_polarizers(p, 0.0), "polarized",
                     POLARIZED, ("rgb", "spectral")),
    "polarizers_45": (lambda p: two_polarizers(p, 45.0), "polarized",
                      POLARIZED, ("rgb", "spectral")),
    "polarizers_90": (lambda p: two_polarizers(p, 90.0), "polarized",
                      POLARIZED, ("rgb", "spectral")),
    "diffuse_plane": (diffuse_plane, "polarized",
                      dict(POLARIZED, spp=256, spp_per_pass=64, max_depth=2),
                      ("rgb",)),
    "gold_mirror": (gold_mirror, "polarized", dict(POLARIZED, max_depth=3),
                    ("rgb", "spectral")),
    "cornell": (cornell, "polarized",
                dict(POLARIZED, spp=64, spp_per_pass=32, max_depth=3),
                ("rgb", "spectral")),
}
CASE_MODES = [(n, m) for n, c in CASES.items() for m in c[3]]


def _render(which, name, mode, seed=0):
    pkg = package(which)
    make, entry, cfg, _ = CASES[name]
    return pkg.np(getattr(pkg, entry)(
        make(pkg), pkg.Config(**cfg, color_mode=mode), seed=seed))


def _dop(c):
    return np.sqrt((c[1:] ** 2).sum()) / c[0]


@pytest.mark.parametrize("name,mode", CASE_MODES)
def test_stokes_scenes_match_jax(name, mode):
    """Each scene through the port's render_stokes or render_polarized
    against the JAX package's (same seed), and what tests/test_stokes.py
    asserts of it."""
    img = _render("port", name, mode)
    ref = REFS.get(f"scene/{name}/{mode}",
                   lambda: _render("jax", name, mode))
    assert_image_close(img, ref)
    if name == "brewster":
        c = img[8, 8]
        assert c[0] > 1e-4 and _dop(c) > 0.9
    elif name == "gold":
        c = img[8, 8]
        assert c[0] > 0.1 and 0.02 < _dop(c) < 0.9
    elif name == "diffuse_box":
        assert img[..., 0].max() > 0.01
        np.testing.assert_allclose(img[..., 1:], 0.0, atol=1e-6)
    elif name.startswith("polarizers"):
        i = img[7:9, 7:9, :, 0].mean()
        want = {"polarizers_0": 0.5, "polarizers_45": 0.25}.get(name)
        if want is None:
            assert i < 0.01 * 0.5
        else:
            np.testing.assert_allclose(i, want, atol=0.02)
    elif name == "diffuse_plane":
        scalar = mt.render(diffuse_plane(package("port")), mt.RenderConfig(
            **CASES[name][2]), device="cpu").numpy()
        np.testing.assert_allclose(img[4:12, 4:12, :, 0].mean(),
                                   scalar[4:12, 4:12].mean(), rtol=0.03)
        assert np.abs(img[..., 1:]).max() < 0.02
    elif name == "gold_mirror":
        i0 = img[7:9, 7:9, :, 0].mean()
        assert i0 > 0.3 and np.abs(img[7:9, 7:9, :, 1]).mean() / i0 > 0.02
    else:
        assert img.shape == (16, 16, 3, 4)


def test_cornell_spectral_consistent_with_rgb():
    """tests/test_stokes.py::test_polarized_spectral_mode: the spectral
    Stokes image's S0 mean within 35% of rgb mode's."""
    a = _render("port", "cornell", "rgb")[..., 0].mean()
    b = _render("port", "cornell", "spectral")[..., 0].mean()
    assert abs(a - b) < 0.35 * max(a, b)


def test_stokes_refuses_spectral():
    with pytest.raises(ValueError, match="stokes"):
        mt.render_stokes(gold_plate(package("port")),
                         mt.RenderConfig(**STOKES, color_mode="spectral"),
                         device="cpu")


def test_render_any_routes_stokes():
    """render_any(integrator="stokes") is render_stokes; the aov
    integrator's stokes child too."""
    scene = gold_plate(package("port"))
    cfg = mt.RenderConfig(**STOKES)
    want = mt.render_stokes(scene, cfg, seed=3, device="cpu")
    got = mt.render_any(scene, cfg.replace(integrator="stokes"), seed=3,
                        device="cpu")
    assert torch.equal(got, want)
    aov = mt.render_any(scene, cfg.replace(integrator="aov",
                                           aov_child="stokes",
                                           aovs=("depth",)), seed=3,
                        device="cpu")
    assert torch.equal(aov["image"], want) and aov["depth"].shape[-1] == 1


# ---------------------------------------------------------------------------
# gallery_polarized through scene_from_numpy
# ---------------------------------------------------------------------------

GALLERY = dict(width=16, height=16, spp=4, spp_per_pass=4, max_depth=3)
GALLERY_RENDERS = {"polarized_rgb": ("polarized", "rgb"),
                   "polarized_spectral": ("polarized", "spectral"),
                   "stokes": ("stokes", "rgb"), "measured": ("render", "rgb")}


@pytest.fixture(scope="module")
def jax_gallery():
    from mitsuba2_tpu.scene import presets as jpresets
    return chip_smoke.gallery_polarized(jpresets, 1)


@pytest.fixture(scope="module")
def carried(jax_gallery):
    return mt.scene_from_numpy(jax_fields(jax_gallery), device="cpu")


def _gallery_render(which, scene, name):
    pkg = package(which)
    entry, mode = GALLERY_RENDERS[name]
    return pkg.np(getattr(pkg, entry)(
        scene, pkg.Config(**GALLERY, color_mode=mode), seed=0))


@pytest.mark.parametrize("name", sorted(GALLERY_RENDERS))
def test_gallery_polarized_matches_jax(jax_gallery, carried, name):
    """The JAX build carried across: each entry point's image against the
    JAX package's on the same tables."""
    assert carried.measured.mueller is not None
    img = _gallery_render("port", carried, name)
    ref = REFS.get(f"gallery/{name}",
                   lambda: _gallery_render("jax", jax_gallery, name))
    assert_image_close(img, ref)
    s0 = img if name == "measured" else img[..., 0]
    assert s0.mean() > 0


def test_gallery_polarized_builds_as_jax(jax_gallery):
    """The port's own build: every table byte-equal to the JAX build's
    but the baked measured ones, within rtol 1e-5 of its (each package
    bakes rough gold with its own arithmetic); the same families."""
    st = chip_smoke.gallery_polarized(tpresets, 1, device="cpu")
    assert st.mat_families == jax_gallery.mat_families == (
        0, 1, 2, 3, 13, 14, 15, 16)
    for k in ("mat_type", "mat_flags", "mat_data", "shape_mat", "prim_p0"):
        np.testing.assert_array_equal(getattr(st, k).numpy(),
                                      np.asarray(getattr(jax_gallery, k)))
    for k in TABLES:
        a = np.asarray(getattr(jax_gallery.measured, k))
        np.testing.assert_allclose(getattr(st.measured, k).numpy(), a,
                                   rtol=1e-5, atol=1e-6 * np.abs(a).max())


# ---------------------------------------------------------------------------
# A polarizer's and a retarder's parameters
# ---------------------------------------------------------------------------

GRAD = dict(width=16, height=16, spp=4, spp_per_pass=4, max_depth=3)


def optics_scene(pkg):
    """A diffuse plane behind a polarizer pane and a retarder pane, under
    the sky: the scalar transport's straight-through elements."""
    sh, T4 = pkg.shapes, pkg.T4
    plane = sh.rectangle(bsdf={"type": "diffuse", "reflectance": [0.6] * 3},
                         id="plane").transformed(np.diag([3.0, 3, 1, 1]))
    pol = sh.rectangle(bsdf={"type": "polarizer", "theta": 20.0,
                             "transmittance": 0.8}, id="pol").transformed(
        np.asarray((T4.translate([-0.5, 0, 1]) @ T4.scale([0.6] * 3)).matrix))
    ret = sh.rectangle(bsdf={"type": "retarder", "theta": 10.0,
                             "delta": 45.0}, id="ret").transformed(
        np.asarray((T4.translate([0.5, 0, 1.5]) @ T4.scale([0.6] * 3)).matrix))
    return pkg.build([plane, pol, ret], _sensor(pkg, [0, 0, 5], [0, 0, 0],
                                                [0, 1, 0], 40.0),
                     emitters=[{"type": "constant", "radiance": [1.0] * 3}])


def _jax_optics_grad():
    import jax.numpy as jnp
    import mitsuba2_tpu as mi
    from mitsuba2_tpu.diff import render_l2_grad
    img, loss, grads = render_l2_grad(
        optics_scene(package("jax")), mi.RenderConfig(**GRAD),
        jnp.zeros((16, 16, 3), jnp.float32), seed=0)
    return np.asarray(img), float(loss), np.asarray(grads["mat_data"])


def test_optics_params_and_transmittance_gradient_match_jax():
    """The polarizer's theta and transmittance and the retarder's theta
    and delta in param_paths as the JAX build records them; render_l2_grad
    through the scalar path: the image, the loss and the transmittance's
    gradient (mat_data col 25 of the polarizer's row) against the JAX
    package's render_and_grad."""
    sj = optics_scene(package("jax"))
    st = optics_scene(package("port"))
    assert st.param_paths == sj.param_paths
    names = {p[0] for p in st.param_paths}
    assert {"pol.bsdf.theta", "pol.bsdf.transmittance", "ret.bsdf.theta",
            "ret.bsdf.delta"} <= names
    img, loss, grads = mt.render_l2_grad(st, mt.RenderConfig(**GRAD),
                                         torch.zeros(16, 16, 3), seed=0,
                                         device="cpu")
    img_j, loss_j, g_j = REFS.get("optics_grad", _jax_optics_grad)
    assert_image_close(img.detach().numpy(), img_j)
    np.testing.assert_allclose(float(loss), loss_j, rtol=1e-3)
    _, _, row, c0, _, _ = {p[0]: p for p in st.param_paths}[
        "pol.bsdf.transmittance"]
    g = float(grads["mat_data"][row, c0])
    assert g > 0 and np.isfinite(grads["mat_data"].numpy()).all()
    np.testing.assert_allclose(g, g_j[row, c0], rtol=1e-3)
