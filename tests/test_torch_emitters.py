"""The emitters of config 3 in the PyTorch port against the JAX package:
the envmap (its Marginal2D importance table, alias or CDF sampled), point,
spot, directional and untextured projector lights beside the area and
constant ones.

Per lane: Marginal2D's samples and pdfs, each emitter kind's
sample_direction (direction, distance, pdf, delta flag and value, in rgb
and in spectral mode) and pdf_direction_env and eval_env, within rtol
1e-5 / atol 1e-6. Byte-equal: build_envmap's tables, with and without
alias tables. The JAX package's own emitter tests (tests/test_emitters.py)
ported to the port. Renders: chip_smoke's gallery_lights (the cluster
walk's twins on delta and envmap shadow rays) against the JAX package,
pixel for pixel. Gradients: render_l2_grad of veach_mis(envmap=True) at
12x12 in spectral and rgb mode against the JAX package's (its roughness
columns NaN: tests/test_torch_veach.py), all four tables within 1e-3,
and env_scale and a sun texel of env_image against central differences.
The JAX package's renders and gradients are committed
(tests/goldens/test_torch_emitters.npz); one is recomputed live.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
import mitsuba2_tpu as mi
from mitsuba2_tpu.core import distr as jdistr, spectrum as jsp
from mitsuba2_tpu.core.vec import Vec2 as JVec2, Vec3 as JVec3
from mitsuba2_tpu.render import emitters as jem
from mitsuba2_tpu.scene import presets as jpresets

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.core import distr, spectrum as tsp
from mitsuba2_tpu_torch.core.geometry import Transform4 as T4
from mitsuba2_tpu_torch.core.spec import Spec
from mitsuba2_tpu_torch.core.vec import Vec2, Vec3
from mitsuba2_tpu_torch.diff import adjoint
from mitsuba2_tpu_torch.render import emitters as em
from mitsuba2_tpu_torch.scene import presets as tpresets
from mitsuba2_tpu_torch.scene import scene as scene_mod

from goldens.jax_refs import Refs
from test_torch_veach import _jax_l2_grad, _rel

# one intra-op thread: the suite's test processes share the cores
# (pytest-xdist), and torch's OpenMP regions stall when they
# oversubscribe them
torch.set_num_threads(1)

REFS = Refs("test_torch_emitters")

RTOL, ATOL = 1e-5, 1e-6
N = 4096


def _close(a, b, what=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _close_lanes(a, b, what="", share=0.999, rtol=1e-3, atol=ATOL):
    """>= `share` of lanes within RTOL / ATOL, every lane within `rtol` /
    `atol`: the others divide an f32 rounding difference, which XLA's
    fused arithmetic and torch's round apart, by a small quantity: an
    area light's pdf by a grazing cosine, a spot's falloff by its beam
    and cutoff cosines 0.02 apart, a spectral value by the cancellation
    in c2 wl^2 + c1 wl + c0 (|c0| ~ 10-30 on the raw nm axis, x ~ 1), an
    envmap's v = acos(y) / pi by sqrt(1 - y^2) near a pole."""
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)
    assert np.isclose(a, b, rtol=RTOL, atol=ATOL).mean() >= share, what


def _env_image(H=32, W=64, kind="gradient"):
    """tests/test_emitters.py's images: a gradient with a red stripe, or
    uniform noise."""
    rng = np.random.default_rng(3)
    if kind == "gradient":
        v = np.linspace(0.05, 2.0, H)[:, None, None]
        img = np.broadcast_to(v, (H, W, 3)).copy()
        img[:, : W // 4, 0] *= 5.0
        return img.astype(np.float32)
    return rng.uniform(0.01, 1.0, (H, W, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# Marginal2D and the envmap's tables
# ---------------------------------------------------------------------------

def _density():
    rng = np.random.default_rng(11)
    d = rng.exponential(1.0, (12, 20)) ** 3
    d[3] = 0.0                      # an empty row
    d[:, 7] = 0.0                   # an empty column
    d[5, 9] = 40.0                  # a peak
    return d


def test_vose_tables_byte_equal():
    for w in (_density().ravel(), np.ones(17), np.arange(1.0, 64.0) ** 2):
        p_t, a_t = distr._vose_tables(w)
        p_j, a_j = jdistr._vose_tables(w)
        assert np.array_equal(p_t, p_j) and np.array_equal(a_t, a_j)


@pytest.mark.parametrize("alias", [True, False])
def test_marginal2d_matches_jax(alias):
    """Alias and CDF-inversion sampling and eval_pdf, lane by lane, on a
    density with an empty row, an empty column and a peak; u includes 0
    and the largest float below 1."""
    d = _density()
    mj = jdistr.Marginal2D.build(d, alias=alias)
    mtd = distr.Marginal2D.build(d, alias=alias)
    for f in distr.FIELDS:
        a, b = getattr(mj, f), getattr(mtd, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert np.array_equal(np.asarray(a), b.numpy()), f
    rng = np.random.default_rng(1)
    u = rng.uniform(size=(2, N)).astype(np.float32)
    u[:, :4] = [[0.0, distr.ONE_MINUS_EPSILON, 0.5, 0.0],
                [0.0, distr.ONE_MINUS_EPSILON, 0.0, 0.999]]
    pos_j, pdf_j = mj.sample((jnp.asarray(u[0]), jnp.asarray(u[1])))
    pos_t, pdf_t = mtd.sample(Vec2(torch.from_numpy(u[0]),
                                   torch.from_numpy(u[1])))
    _close(pos_t.x, pos_j.x, "u")
    _close(pos_t.y, pos_j.y, "v")
    _close(pdf_t, pdf_j, "pdf")
    assert (pdf_t.numpy() > 0).all()
    ev_j = mj.eval_pdf((pos_j.x, pos_j.y))
    _close(mtd.eval_pdf(pos_t), ev_j, "eval_pdf")


def test_marginal2d_sample_pdf_consistent():
    """tests/test_distr.py's consistency on the port: eval_pdf at the
    sampled positions is the sampled pdf, alias or not."""
    d = _density()
    rng = np.random.default_rng(2)
    u = torch.from_numpy(rng.uniform(size=(2, 50_000)).astype(np.float32))
    for alias in (True, False):
        m = distr.Marginal2D.build(d, alias=alias)
        pos, pdf = m.sample(Vec2(u[0], u[1]))
        rel = (m.eval_pdf(pos) - pdf).abs() / pdf.clamp_min(1e-6)
        assert float((rel < 1e-3).float().mean()) > 0.999


ENV_DESCS = {
    "veach_sky": lambda: {"type": "envmap",
                          "data": tpresets.procedural_sky()},
    "rotated_hdr": lambda: {
        "type": "envmap", "scale": 1.7,
        "data": _env_image(16, 24, "noise") * np.float32(3.0),
        "to_world": np.asarray((T4.rotate([0, 1, 0], 35.0)
                                @ T4.rotate([1, 0, 0], -20.0)).matrix)},
    "mono_2d": lambda: {"type": "envmap",
                        "data": _env_image(8, 16)[..., 0]},
}


@pytest.mark.parametrize("alias", ["1", "0"])
@pytest.mark.parametrize("name", sorted(ENV_DESCS))
def test_build_envmap_tables_byte_equal(name, alias, monkeypatch):
    """Every table of the JAX package's EnvMapData, byte for byte: the
    image, the importance table and its alias tables (none under
    MI_ENVMAP_ALIAS=0), the rotation, the scale and the per-texel
    coefficients."""
    monkeypatch.setenv("MI_ENVMAP_ALIAS", alias)
    desc = ENV_DESCS[name]()
    ej = jem.build_envmap(desc)
    tabs = em.build_envmap(desc)
    assert set(tabs) == set(em.ENV_FIELDS)
    for k in em.ENV_FIELDS:
        a = getattr(ej.distr, k) if k in distr.FIELDS else getattr(ej, k)
        b = tabs[k]
        assert (a is None) == (b is None), k
        if a is None:
            continue
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k
    assert (tabs["alias_p"] is None) == (alias == "0")


def _env_files(tmp_path):
    """An envmap image as a half EXR and as an RGBE file."""
    img = _env_image(8, 16, "noise") * np.float32(2.0)
    paths = {ext: str(tmp_path / f"sky{ext}") for ext in (".exr", ".hdr")}
    from mitsuba2_tpu_torch.core import io_bitmap
    io_bitmap.write_exr(paths[".exr"], img, half=True)
    io_bitmap.write(paths[".hdr"], img)
    return paths


def test_envmap_from_file_raises_by_name(tmp_path):
    """An envmap read from an image file builds, seen by an orthographic
    sensor too, and beside a polarizer (since the polarized slice), which
    render_polarized renders under it."""
    cam = {"type": "orthographic", "to_world": np.eye(4)}
    plane = tpresets.shapes.rectangle(bsdf={"type": "diffuse"})
    env = [{"type": "envmap", "filename": _env_files(tmp_path)[".exr"]}]
    assert mt.build_scene([plane], cam, env, device="cpu").envmap is not None
    other = tpresets.shapes.rectangle(bsdf={"type": "polarizer"})
    both = mt.build_scene([plane, other], cam, env, device="cpu")
    assert both.envmap is not None and 14 in both.mat_families
    img = mt.render_polarized(both, mt.RenderConfig(
        width=4, height=4, spp=2, spp_per_pass=2, max_depth=2), device="cpu")
    assert img.shape == (4, 4, 3, 4) and torch.isfinite(img).all()


@pytest.mark.parametrize("ext", [".exr", ".hdr"])
def test_envmap_from_file_matches_jax(tmp_path, ext):
    """build_envmap of a file: the JAX package's tables of the same file
    byte for byte, and the port's of the array it decodes to (envmap
    files are not linearised)."""
    from mitsuba2_tpu_torch.core import io_bitmap
    path = _env_files(tmp_path)[ext]
    tabs = em.build_envmap({"type": "envmap", "filename": path})
    ej = jem.build_envmap({"type": "envmap", "filename": path})
    own = em.build_envmap({"type": "envmap", "data": io_bitmap.read(path)})
    for k in em.ENV_FIELDS:
        a = getattr(ej.distr, k) if k in distr.FIELDS else getattr(ej, k)
        assert (a is None) == (tabs[k] is None) == (own[k] is None), k
        if a is not None:
            assert np.asarray(a).tobytes() == tabs[k].tobytes(), k
            assert own[k].tobytes() == tabs[k].tobytes(), k


# ---------------------------------------------------------------------------
# Each emitter kind, lane by lane
# ---------------------------------------------------------------------------

def _plane(P, emitters, **kw):
    """A diffuse plane under `emitters`, from either package's shapes."""
    cam = P.Transform4.look_at(origin=[0, 0, 3], target=[0, 0, 0],
                               up=[0, 1, 0])
    sensor = {"type": "perspective", "to_world": np.asarray(cam.matrix),
              "fov": 45.0}
    plane = P.shapes.rectangle(bsdf={"type": "diffuse",
                                     "reflectance": [0.8, 0.8, 0.8]})
    return P.build_scene([plane], sensor, emitters=emitters, **kw)


# the emitter sets: every kind of config 3 (chip_smoke.gallery_lights,
# subdiv 0), veach's area lights beside the envmap, a constant sky beside
# a point light and a spot aimed off the plane
SCENES = {
    "gallery_lights": lambda P, **kw: chip_smoke.gallery_lights(P, 0, **kw),
    "veach_envmap": lambda P, **kw: P.veach_mis(envmap=True, **kw),
    "constant_point_spot": lambda P, **kw: _plane(P, [
        {"type": "constant", "radiance": [0.3, 0.4, 0.5]},
        {"type": "point", "position": [0.2, 0.5, 1.0],
         "intensity": {"type": "blackbody", "temperature": 3200.0,
                       "scale": 1e-2}},
        {"type": "spot", "position": [0, 0, 2], "direction": [0.2, 0, -1],
         "intensity": [20, 15, 10], "cutoff_angle": 15.0,
         "beam_width": 9.0}], **kw),
}


@pytest.fixture(scope="module")
def scene_pairs():
    return {name: (mk(jpresets), mk(tpresets, device="cpu"))
            for name, mk in SCENES.items()}


def _lanes(sj, seed):
    """Reference points inside the scene's box, hero wavelengths and the
    uniforms: numpy arrays."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(sj.bvh_min[0]), np.asarray(sj.bvh_max[0])
    p = (lo + (hi - lo) * rng.uniform(0.05, 0.95, (N, 3))).astype(np.float32)
    u = rng.uniform(size=(4, N)).astype(np.float32)
    return p, u


def _wavelengths(u):
    wl_j, _ = jsp.sample_hero_wavelengths_t(jnp.asarray(u))
    wl_t, _ = tsp.sample_hero_wavelengths_t(torch.from_numpy(u))
    return wl_j, wl_t


@pytest.mark.parametrize("mode", ["rgb", "spectral"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_sample_direction_matches_jax(scene_pairs, name, mode):
    sj, st = scene_pairs[name]
    assert st.emitter_kinds == tuple(sj.emitter_kinds)
    assert st.env_emitter == sj.env_emitter and st.n_emitters == sj.n_emitters
    p, u = _lanes(sj, 3)
    wl_j, wl_t = _wavelengths(u[3])
    cj, ct = mi.RenderConfig(color_mode=mode), mt.RenderConfig(
        color_mode=mode)
    ds_j, v_j = jem.sample_direction(
        sj, JVec3(*map(jnp.asarray, p.T)), wl_j, jnp.asarray(u[0]),
        (jnp.asarray(u[1]), jnp.asarray(u[2])), cj)
    ds_t, v_t = em.sample_direction(
        st, Vec3(*torch.from_numpy(p.T.copy())), wl_t,
        torch.from_numpy(u[0]), (torch.from_numpy(u[1]),
                                 torch.from_numpy(u[2])), ct)
    assert np.array_equal(ds_t.delta.numpy(), np.asarray(ds_j.delta))
    _close_lanes(ds_t.pdf, ds_j.pdf, "pdf")
    _close(ds_t.dist, ds_j.dist, "dist")
    for c in "xyz":
        _close(getattr(ds_t.d, c), getattr(ds_j.d, c), "d." + c)
    assert v_t.n == v_j.n == ct.n_channels
    for a, b in zip(v_t.ch, v_j.ch):
        _close_lanes(a, b, "value")
    # every kind is drawn, and each draws lanes with a positive pdf
    etype = st.emitter_type.numpy()[np.clip(
        (u[0] * st.n_emitters).astype(np.int32), 0, st.n_emitters - 1)]
    for k in st.emitter_kinds:
        assert (ds_t.pdf.numpy()[etype == k] > 0).any(), k


@pytest.mark.parametrize("mode", ["rgb", "spectral", "mono"])
@pytest.mark.parametrize("name", ["veach_envmap", "constant_point_spot"])
def test_env_eval_and_pdf_match_jax(scene_pairs, name, mode):
    """eval_env and pdf_direction_env of escaped directions (every
    direction of the sphere, the poles and the seam included)."""
    sj, st = scene_pairs[name]
    rng = np.random.default_rng(4)
    d = rng.normal(size=(N, 3))
    d[:4] = [[0, 1, 0], [0, -1, 0], [0, 0, -1], [1e-7, 0, 1]]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    _, u = _lanes(sj, 5)
    wl_j, wl_t = _wavelengths(u[0])
    dj, dt = JVec3(*map(jnp.asarray, d.T)), Vec3(*torch.from_numpy(d.T.copy()))
    cj, ct = mi.RenderConfig(color_mode=mode), mt.RenderConfig(
        color_mode=mode)
    for a, b in zip(em.eval_env(st, dt, wl_t, ct).ch,
                    jem.eval_env(sj, dj, wl_j, cj).ch):
        _close_lanes(a, b, "eval_env", 0.99)
    _close(em.pdf_direction_env(st, dt), jem.pdf_direction_env(sj, cj, dj),
           "pdf_direction_env")


def test_envmap_uv_maps_match_jax():
    desc = ENV_DESCS["rotated_hdr"]()
    ej = jem.build_envmap(desc)
    et = em.envmap_from_numpy(em.build_envmap(desc), "cpu")
    rng = np.random.default_rng(6)
    uv = rng.uniform(size=(2, N)).astype(np.float32)
    dj = jem._envmap_uv_to_dir(ej, JVec2(*map(jnp.asarray, uv)))
    dt = em._envmap_uv_to_dir(et, Vec2(*torch.from_numpy(uv)))
    for c in "xyz":
        _close(getattr(dt, c), getattr(dj, c), c)
    uvj = jem._envmap_dir_to_uv(ej, dj)
    uvt = em._envmap_dir_to_uv(et, dt)
    _close(uvt.x, uvj.x, "u")
    _close_lanes(uvt.y, uvj.y, "v", rtol=0.0, atol=1e-4)


# ---------------------------------------------------------------------------
# tests/test_emitters.py's cases on the port
# ---------------------------------------------------------------------------

CFG = dict(width=16, height=16, spp=16, spp_per_pass=16, max_depth=2)


def _render(scene, **kw):
    return mt.render(scene, mt.RenderConfig(**{**CFG, **kw}), seed=0,
                     device="cpu").numpy()


def test_envmap_sample_pdf_consistency():
    """E[pdf/pdf] over the sphere: eval_pdf agrees with the sampled pdf,
    and uv -> direction -> uv round-trips."""
    env = em.envmap_from_numpy(
        em.build_envmap({"type": "envmap", "data": _env_image()}), "cpu")
    rng = np.random.default_rng(0)
    u = torch.from_numpy(rng.uniform(size=(2, 200_000)).astype(np.float32))
    uv, pdf = env.distr.sample(Vec2(u[0], u[1]))
    rel = (pdf - env.distr.eval_pdf(uv)).abs() / env.distr.eval_pdf(
        uv).abs().clamp_min(1e-6)
    assert float((rel < 1e-3).float().mean()) > 0.999
    uv2 = em._envmap_dir_to_uv(env, em._envmap_uv_to_dir(env, uv))
    np.testing.assert_allclose(uv2.x.numpy(), uv.x.numpy(), atol=2e-3)
    np.testing.assert_allclose(uv2.y.numpy(), uv.y.numpy(), atol=2e-3)


def test_envmap_importance_proportional_to_luminance():
    img = _env_image()
    env = em.envmap_from_numpy(em.build_envmap({"type": "envmap",
                                                "data": img}), "cpu")
    rng = np.random.default_rng(1)
    u = torch.from_numpy(rng.uniform(size=(2, 400_000)).astype(np.float32))
    uv, _ = env.distr.sample(Vec2(u[0], u[1]))
    H, W = img.shape[:2]
    counts, _, _ = np.histogram2d(uv.y.numpy(), uv.x.numpy(), bins=[H, W],
                                  range=[[0, 1], [0, 1]])
    lum = img @ np.array([0.2126, 0.7152, 0.0722])
    expect = lum * np.sin((np.arange(H) + 0.5) / H * np.pi)[:, None]
    expect = expect / expect.sum() * counts.sum()
    mask = expect > 50
    assert (np.abs(counts[mask] - expect[mask]) / expect[mask]).mean() < 0.15


def test_uniform_envmap_matches_constant():
    img = np.full((16, 32, 3), 0.7, np.float32)
    i_env = _render(_plane(tpresets, [{"type": "envmap", "data": img}],
                           device="cpu"), spp=128, spp_per_pass=128)
    i_const = _render(_plane(tpresets, [{"type": "constant",
                                         "radiance": [0.7] * 3}],
                             device="cpu"), spp=128, spp_per_pass=128)
    np.testing.assert_allclose(i_env[6:10, 6:10].mean(),
                               i_const[6:10, 6:10].mean(), atol=0.01)
    np.testing.assert_allclose(i_env, i_const, atol=0.06)


def test_envmap_escaped_rays_show_image():
    img = np.zeros((8, 16, 3), np.float32)
    img[:, :, 2] = 3.0
    out = _render(_plane(tpresets, [{"type": "envmap", "data": img}],
                         device="cpu"))
    assert out[0, 0, 2] > 2.0 and out[0, 0, 0] < 0.5


def test_spot_falloff():
    out = _render(_plane(tpresets, [{
        "type": "spot", "position": [0, 0, 2], "direction": [0, 0, -1],
        "intensity": [20] * 3, "cutoff_angle": 15.0}], device="cpu"))
    c, edge = out[8, 8].mean(), out[8, 1].mean()
    assert c > 0.2 and edge < 0.05 * max(c, 1e-9)


def test_directional_lambert():
    def lit(d):
        return _render(_plane(tpresets, [{
            "type": "directional", "direction": d,
            "irradiance": [1.0] * 3}], device="cpu"))[8, 8].mean()
    d60 = [np.sin(np.deg2rad(60)), 0, -np.cos(np.deg2rad(60))]
    np.testing.assert_allclose(lit(d60) / lit([0, 0, -1]), 0.5, atol=0.05)


def test_projector_lights_its_frustum_alone():
    """An untextured projector aimed at the plane's center: inside its
    frustum the plane is lit by irradiance / dist^2, outside it dark."""
    out = _render(_plane(tpresets, [{
        "type": "projector", "position": [0, 0, 2], "direction": [0, 0, -1],
        "irradiance": [8.0] * 3, "fov": 20.0}], device="cpu"))
    c, edge = out[8, 8].mean(), out[8, 1].mean()
    # diffuse 0.8 / pi x 8 / 2^2 at normal incidence
    np.testing.assert_allclose(c, 0.8 / np.pi * 2.0, rtol=0.05)
    assert edge == 0.0


def test_envmap_spectral_coeff_bake_matches_lattice_path():
    """The baked per-texel coefficients (spectral envmap_eval) reproduce
    the lattice upsampling of the interpolated RGB (_tex_value, NEE's
    path) within the fit's and the interpolation's error, HDR texels
    included; rgb mode reads the image alone."""
    img = _env_image().copy()
    img[2:4, 5:8] = [9.0, 7.5, 4.0]
    env = em.envmap_from_numpy(em.build_envmap(
        {"type": "envmap", "data": img, "scale": 1.3}), "cpu")
    rng = np.random.default_rng(5)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dv = Vec3(*torch.from_numpy(d.T.copy()))
    wl, _ = tsp.sample_hero_wavelengths_t(
        torch.from_numpy(rng.uniform(size=N).astype(np.float32)))
    a = em.envmap_eval(env, dv, wl, "spectral").ch[0].numpy()
    uv = em._envmap_dir_to_uv(env, dv)
    from mitsuba2_tpu_torch.render.spectra import _tex_value
    b = _tex_value(Spec(em._envmap_bilinear_rows(env.image, uv, env.scale)),
                   wl, "spectral").ch[0].numpy()
    assert np.isfinite(a).all()
    rel = np.abs(a - b) / np.maximum(np.abs(b), 0.05 * np.abs(b).mean())
    assert np.median(rel) < 0.02 and np.percentile(rel, 95) < 0.08
    no_bake = dataclasses.replace(env, coeffs=torch.zeros_like(env.coeffs))
    np.testing.assert_array_equal(
        em.envmap_eval(env, dv, None, "rgb").ch[0].numpy(),
        em.envmap_eval(no_bake, dv, None, "rgb").ch[0].numpy())


def test_textured_projector_raises_by_name(tmp_path):
    """A projector's slide packs the JAX package's row inside a build's
    texture staging, given as an array (since the textures' slice) or read
    from a PNG (since the scene loader's: the same row and texels as the
    array the file decodes to, linearised); a scene seen by a sensor the
    port lacks (radiancemeter) still raises by name."""
    from mitsuba2_tpu_torch.core import io_bitmap
    from mitsuba2_tpu_torch.render import spectra
    from mitsuba2_tpu.render import spectra as jspectra
    slide = str(tmp_path / "slide.png")
    io_bitmap.write(slide, np.linspace(0, 1, 48, dtype=np.float32).reshape(
        4, 4, 3))
    data = io_bitmap.srgb_to_linear(io_bitmap.read(slide))
    for tex, fill in (({"data": np.full((4, 4, 3), 2.0, np.float32)}, 3.0),
                      ({"filename": slide}, None)):
        desc = {"type": "projector",
                "irradiance": {"type": "bitmap", **tex}}
        with spectra.texture_staging() as staged:
            row_t = em.pack_emitter(desc)[1]
        jspectra.begin_texture_staging()
        try:
            row_j = jem.pack_emitter(desc)[1]
        finally:
            jspectra.end_texture_staging()
        assert row_t.tobytes() == row_j.tobytes() and len(staged) == 1
        if fill is not None:
            assert row_t[7] == fill
        else:
            assert np.array_equal(staged[0].data, data)
    sensor = {"type": "radiancemeter", "to_world": np.eye(4)}
    plane = tpresets.shapes.rectangle(bsdf={"type": "diffuse"})
    assert mt.build_scene([plane], sensor, [desc],
                          device="cpu").cam_type == "radiancemeter"
    other = tpresets.shapes.rectangle(bsdf={"type": "retarder"})
    both = mt.build_scene([plane, other], sensor, [desc], device="cpu")
    assert both.cam_type == "radiancemeter" and 15 in both.mat_families


# ---------------------------------------------------------------------------
# Renders and gradients against the JAX package
# ---------------------------------------------------------------------------

LIGHTS = dict(width=16, height=16, spp=4, spp_per_pass=4, max_depth=3,
              rr_depth=8)


@pytest.mark.parametrize("mode", ["spectral", "rgb"])
def test_gallery_lights_render_matches_jax(mode):
    """chip_smoke.gallery_lights (subdiv 1: the cluster walk's twins, K1
    and K2, on shadow rays toward delta lights and the sky, t_max up to
    ~1e7) against the JAX package: >= 99% of pixels within rtol 1e-3 /
    atol 1e-4, the mean within rtol 1e-3."""
    st = chip_smoke.gallery_lights(tpresets, 1, device="cpu")
    assert st.mxu_node_f is not None and st.envmap is not None
    img_j = REFS.get(f"gallery_lights_{mode}", lambda: np.asarray(mi.render(
        chip_smoke.gallery_lights(jpresets, 1),
        mi.RenderConfig(**LIGHTS, color_mode=mode), seed=0)))
    img_t = mt.render(st, mt.RenderConfig(**LIGHTS, color_mode=mode),
                      seed=0, device="cpu").numpy()
    assert img_t.shape == img_j.shape == (16, 16, 3)
    assert np.isfinite(img_t).all() and img_t.mean() > 0
    close = np.isclose(img_t, img_j, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99
    np.testing.assert_allclose(img_t.mean(), img_j.mean(), rtol=1e-3)


GRAD = dict(width=12, height=12, spp=4, spp_per_pass=4, max_depth=3,
            rr_depth=8)


@pytest.fixture(scope="module")
def grad_refs():
    """The JAX package's render_l2_grad of veach_mis(envmap=True) at GRAD's
    sizes, spectral and rgb, under tests/test_torch_veach.py's own-rows
    dispatch (its roughness columns still NaN)."""
    return {mode: REFS.get(f"envmap_grads_{mode}", lambda m=mode:
                           _jax_l2_grad(jpresets.veach_mis(envmap=True),
                                        mi.RenderConfig(**GRAD,
                                                        color_mode=m)))
            for mode in ("spectral", "rgb")}


def test_golden_is_fresh():
    """The golden's rgb light-gallery image recomputed by the JAX
    package."""
    stored, live = REFS.fresh("gallery_lights_rgb", lambda: np.asarray(
        mi.render(chip_smoke.gallery_lights(jpresets, 1),
                  mi.RenderConfig(**LIGHTS, color_mode="rgb"), seed=0)))
    np.testing.assert_array_equal(stored, live)


@pytest.mark.parametrize("mode", ["spectral", "rgb"])
def test_envmap_render_l2_grad_matches_jax(grad_refs, mode):
    """Every gradient table (mat_data where the JAX package's are finite,
    emitter_data, env_image, env_scale) within 1e-3 in relative norm, the
    port's finite everywhere; env_image's nonzero only through NEE in
    spectral mode (the eval reads the baked coefficients), through both
    paths in rgb."""
    img_j, loss_j, grads_j = grad_refs[mode]
    scene = mt.veach_mis(envmap=True, device="cpu")
    img, loss, grads = mt.render_l2_grad(
        scene, mt.RenderConfig(**GRAD, color_mode=mode),
        torch.zeros(12, 12, 3), seed=0, device="cpu")
    close = np.isclose(img.numpy(), img_j, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99
    np.testing.assert_allclose(float(loss), loss_j, rtol=1e-3)
    assert set(grads) == set(grads_j) == {"mat_data", "emitter_data",
                                          "env_image", "env_scale"}
    for k, g in grads.items():
        g = g.numpy()
        assert g.shape == np.shape(grads_j[k]) and np.isfinite(g).all(), k
        fin = np.isfinite(grads_j[k])
        assert np.abs(grads_j[k][fin]).max() > 0, k
        assert _rel(g[fin], grads_j[k][fin]) <= 1e-3, k


def _fd_env(scene, cfg, key, index, eps):
    """d mean(image^2) / d (env table `key`)[index] by a central
    difference at seed 0 (the importance table and coefficients stay as
    built, as with_tables keeps them), summed in float64."""
    def render(delta):
        tabs = adjoint.diff_tables(scene)
        t = tabs[key].clone()
        t[index] += delta
        img = mt.render(adjoint.with_tables(scene, {**tabs, key: t}), cfg,
                        seed=0, device="cpu").double()
        return img
    with torch.no_grad():
        hi, lo = render(eps), render(-eps)
    return float((hi * hi - lo * lo).mean()) / (2 * eps)


@pytest.mark.parametrize("mode", ["spectral", "rgb"])
@pytest.mark.parametrize("key,index,eps", [
    ("env_scale", (), 1e-2), ("env_image", (4, 7, 0), 5e-3),
    ("env_image", (4, 8, 2), 5e-3)])
def test_env_gradients_match_finite_differences(mode, key, index, eps):
    """env_scale and sun texels of env_image (red of one, blue of another):
    render_l2_grad against central differences, within 1%. The texel's
    step stays small: spectral NEE upsamples it through the lattice,
    trilinear in cells the difference would otherwise straddle."""
    scene = mt.veach_mis(envmap=True, device="cpu")
    cfg = mt.RenderConfig(**GRAD, color_mode=mode)
    _, _, grads = mt.render_l2_grad(scene, cfg, torch.zeros(12, 12, 3),
                                    seed=0, device="cpu")
    ad = float(grads[key][index])
    fd = _fd_env(scene, cfg, key, index, eps)
    assert abs(fd) > 1e-7
    np.testing.assert_allclose(ad, fd, rtol=0.01)


def test_with_tables_keeps_the_importance_table():
    """with_tables replaces the envmap's image and scale alone: the
    importance table and the coefficients stay as built (the JAX
    package's adjoint.py:87-90)."""
    scene = mt.veach_mis(envmap=True, device="cpu")
    tabs = adjoint.diff_tables(scene)
    assert list(tabs) == ["mat_data", "emitter_data", "env_image",
                          "env_scale"]
    new = adjoint.with_tables(scene, {**tabs, "env_image": tabs[
        "env_image"] * 2, "env_scale": tabs["env_scale"] + 1})
    assert new.envmap.distr is scene.envmap.distr
    assert new.envmap.coeffs is scene.envmap.coeffs
    assert torch.equal(new.envmap.image, scene.envmap.image * 2)
    assert float(new.envmap.scale) == float(scene.envmap.scale) + 1
    assert scene_mod.diff_tables(new)["env_scale"] is new.envmap.scale


def _jax_fields(sj):
    """A JAX scene's tables as numpy, its envmap's under "envmap"."""
    from mitsuba2_tpu_torch.scene.scene import FIELDS
    out = {**{k: np.asarray(getattr(sj, k)) for k in FIELDS},
           "param_paths": sj.param_paths, "envmap": None}
    if sj.envmap is not None:
        out["envmap"] = {k: None if v is None else np.asarray(v) for k, v in (
            (k, getattr(sj.envmap.distr, k) if k in distr.FIELDS
             else getattr(sj.envmap, k)) for k in em.ENV_FIELDS)}
    return out


@pytest.mark.parametrize("name", ["gallery_lights", "veach_envmap"])
def test_scene_from_numpy_carries_envmap_and_delta_emitters(scene_pairs,
                                                            name):
    """The JAX build's tables carried across (scene_from_numpy), envmap
    included, render as the port's own build does, bit for bit."""
    sj, st = scene_pairs[name]
    sc = mt.scene_from_numpy(_jax_fields(sj), device="cpu")
    assert sc.emitter_kinds == st.emitter_kinds
    assert sc.env_emitter == st.env_emitter >= 0
    for f in ("image", "to_world", "scale", "coeffs"):
        assert torch.equal(getattr(sc.envmap, f), getattr(st.envmap, f)), f
    cfg = mt.RenderConfig(width=8, height=8, spp=2, spp_per_pass=2,
                          max_depth=3, color_mode="spectral")
    assert torch.equal(mt.render(sc, cfg, seed=1, device="cpu"),
                       mt.render(st, cfg, seed=1, device="cpu"))
    with pytest.raises(KeyError, match="envmap"):
        mt.scene_from_numpy({**_jax_fields(sj), "envmap": None},
                            device="cpu")


def test_scene_from_numpy_refuses_textured_projector(scene_pairs):
    fields = _jax_fields(scene_pairs["gallery_lights"][0])
    fields["emitter_data"] = fields["emitter_data"].copy()
    proj = fields["emitter_type"] == em.PROJECTOR
    fields["emitter_data"][proj, 7] = 3.0
    # a textured slide needs the atlas that holds it (the textures' slice)
    with pytest.raises(KeyError, match="textures"):
        mt.scene_from_numpy(fields, device="cpu")


def test_delta_emitter_parameters_named():
    st = chip_smoke.gallery_lights(tpresets, 0, device="cpu")
    sj = chip_smoke.gallery_lights(jpresets, 0)
    assert st.param_paths == tuple(sj.param_paths)
    names = {p[0] for p in st.param_paths}
    assert {"point.intensity", "spot.intensity", "sun.irradiance",
            "projector.irradiance"} <= names
    v = mt.traverse(st)["spot.intensity"]
    assert torch.equal(v, st.emitter_data[1, 0:3])
