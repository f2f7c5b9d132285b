"""Spectral rendering in the PyTorch port against the JAX package: the
spectral core (core/spectrum.py), the spectrum slots of config 3 and
color_mode="spectral" renders.

Per lane, within rtol 1e-5 / atol 1e-6 on seeded inputs: the CIE and D65
lookups, the color matrices, the sigmoid-polynomial eval, hero-wavelength
sampling and its pdf (fract(u + i/4), 0 at exactly 1), blackbody
radiance, spectrum_to_srgb_t, and each slot's spectral evaluation (D65 on
illuminants) and the lattice upsampling of per-lane RGB. Byte-equal: the
host fits, the res-32 and built lattices, regular and irregular slots;
blackbody slots within 1e-5 (the JAX package computes Planck in f32). The
reference-format .coeff table round-trips across both packages and
replaces the default through MI_SRGB_COEFF. Renders at 16x16, 4 spp,
depth 3, pixel for pixel (>= 99% within rtol 1e-3 / atol 1e-4, the mean
within 1e-3): veach_mis(envmap=True) under "auto" (brute force) and
"pallas" (the BVH2 walk's twins, K3), and mesh_gallery(subdiv=1) (the
cluster walk's twins, K1 and K2); and the port of the JAX package's
tests/test_veach.py::test_veach_spectral_matches_rgb. The JAX package's
renders are committed (tests/goldens/test_torch_spectral.npz); one is
recomputed live.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mitsuba2_tpu as mi
from mitsuba2_tpu.core import spectrum as jsp
from mitsuba2_tpu.core.spec import Spec as JSpec
from mitsuba2_tpu.render import spectra as jspectra
from mitsuba2_tpu.scene import presets as jpresets

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.core import spectrum as tsp
from mitsuba2_tpu_torch.core.spec import Spec
from mitsuba2_tpu_torch.render import spectra
from mitsuba2_tpu_torch.scene import scene as scene_mod

from goldens.jax_refs import Refs

# one intra-op thread: the suite's test processes share the cores
# (pytest-xdist), and torch's OpenMP regions stall when they
# oversubscribe them
torch.set_num_threads(1)

REFS = Refs("test_torch_spectral")

RTOL, ATOL = 1e-5, 1e-6
N = 4096


def _close(a, b, what="", rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=ATOL, err_msg=what)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def wl():
    """Wavelengths across and beyond [360, 830] nm, the table's nodes and
    both ends included."""
    rng = np.random.default_rng(0)
    w = rng.uniform(340.0, 850.0, N).astype(np.float32)
    w[:6] = [360.0, 830.0, 555.0, 359.99, 830.01, 362.5]
    return w


# ---------------------------------------------------------------------------
# The spectral core
# ---------------------------------------------------------------------------

def test_tables_and_constants_equal():
    assert tsp.CIE_Y_INTEGRAL == jsp.CIE_Y_INTEGRAL
    assert tsp.N_HERO == jsp.N_HERO == 4
    for k in ("XYZ_TO_SRGB", "SRGB_TO_XYZ", "_CIE_PAIR", "_D65_PAIR",
              "_PROJ"):
        assert np.array_equal(getattr(tsp, k), getattr(jsp, k)), k


def test_cie_and_d65_lookups_match_jax(wl):
    _close(tsp.cie1931_xyz(_t(wl)), jsp.cie1931_xyz(jnp.asarray(wl)))
    _close(tsp.d65_approx(_t(wl)), jsp.d65_approx(jnp.asarray(wl)))
    for a, b in zip(tsp.cie1931_xyz_t(_t(wl)),
                    jsp.cie1931_xyz_t(jnp.asarray(wl))):
        _close(a, b)
    # a (..., 4) input keeps its shape
    w4 = wl.reshape(-1, 4)
    _close(tsp.cie1931_xyz(_t(w4)), jsp.cie1931_xyz(jnp.asarray(w4)))


def test_color_transforms_match_jax():
    rng = np.random.default_rng(1)
    v = rng.uniform(-0.2, 3.0, (N, 3)).astype(np.float32)
    _close(tsp.xyz_to_srgb(_t(v)), jsp.xyz_to_srgb(jnp.asarray(v)))
    _close(tsp.srgb_to_xyz(_t(v)), jsp.srgb_to_xyz(jnp.asarray(v)))
    for a, b in zip(tsp.xyz_to_srgb_t(*_t(v.T.copy())),
                    jsp.xyz_to_srgb_t(*jnp.asarray(v.T))):
        _close(a, b)


def test_srgb_model_eval_matches_jax(wl):
    rng = np.random.default_rng(2)
    cf, _ = jsp.fit_srgb_model_batch(rng.uniform(0, 1, (N, 3)))
    cf = cf.astype(np.float32)
    _close(tsp.srgb_model_eval(_t(cf), _t(wl)),
           jsp.srgb_model_eval(jnp.asarray(cf), jnp.asarray(wl)))


def _uniforms():
    """u in [0, 1): the quarter points, whose rotations land exactly on
    1.0 (fract -> 0), the largest float below 1, and random values."""
    rng = np.random.default_rng(3)
    u = rng.uniform(size=N).astype(np.float32)
    u[:6] = [0.0, 0.25, 0.5, 0.75, np.nextafter(np.float32(1), 0), 1e-7]
    return u


def test_hero_sampling_matches_jax():
    u = _uniforms()
    wl_t, pdf_t = tsp.sample_rgb_spectrum(_t(u))
    wl_j, pdf_j = jsp.sample_rgb_spectrum(jnp.asarray(u))
    _close(wl_t, wl_j, "wl")
    _close(pdf_t, pdf_j, "pdf")
    _close(tsp.pdf_rgb_spectrum(wl_t), jsp.pdf_rgb_spectrum(wl_j))
    w4t, p4t = tsp.sample_hero_wavelengths(_t(u))
    w4j, p4j = jsp.sample_hero_wavelengths(jnp.asarray(u))
    assert tuple(w4t.shape) == (N, 4)
    _close(w4t, w4j, "wl4")
    _close(p4t, p4j, "pdf4")
    st, pt = tsp.sample_hero_wavelengths_t(_t(u))
    sj, pj = jsp.sample_hero_wavelengths_t(jnp.asarray(u))
    for i in range(4):
        _close(st.ch[i], sj.ch[i], f"wl {i}")
        _close(pt.ch[i], pj.ch[i], f"pdf {i}")
        _close(st.ch[i], w4t[:, i], "planar = stacked")
    # u = 0.25: the rotation u + 3/4 is exactly 1.0, fract 0 (jnp.mod)
    assert float(st.ch[3][1]) == float(st.ch[0][0])
    w = torch.stack(st.ch).numpy()
    assert (w >= tsp.WAVELENGTH_MIN).all() and (w <= tsp.WAVELENGTH_MAX).all()


def test_hero_pdf_normalized():
    """tests/test_spectrum.py's normalization on the port: the pdf
    integrates to 1 over [360, 830] nm."""
    w = torch.linspace(tsp.WAVELENGTH_MIN, tsp.WAVELENGTH_MAX, 20001,
                       dtype=torch.float64)
    integral = torch.trapezoid(tsp.pdf_rgb_spectrum(w), w)
    np.testing.assert_allclose(float(integral), 1.0, rtol=1e-3)


def _close_srgb(a, b):
    """sRGB from XYZ subtracts products a few times larger than the
    result (3.24 X - 1.54 Y - 0.50 Z): each value within RTOL of the
    channel's largest magnitude."""
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=RTOL,
                               atol=RTOL * np.abs(b).max())


def test_spectrum_to_srgb_matches_jax():
    rng = np.random.default_rng(4)
    u = rng.uniform(size=N).astype(np.float32)
    vals = rng.uniform(0.0, 5.0, (4, N)).astype(np.float32)
    wl_t, pdf_t = tsp.sample_hero_wavelengths_t(_t(u))
    wl_j, pdf_j = jsp.sample_hero_wavelengths_t(jnp.asarray(u))
    out_t = tsp.spectrum_to_srgb_t(Spec(tuple(_t(v) for v in vals)), wl_t,
                                   pdf_t)
    out_j = jsp.spectrum_to_srgb_t(JSpec(tuple(jnp.asarray(v)
                                               for v in vals)), wl_j, pdf_j)
    assert out_t.n == 3
    for a, b in zip(out_t.ch, out_j.ch):
        _close_srgb(a, b)
    w4, p4 = (torch.stack(s.ch, -1) for s in (wl_t, pdf_t))
    _close_srgb(tsp.spectrum_to_srgb(_t(vals.T.copy()), w4, p4),
                jsp.spectrum_to_srgb(jnp.asarray(vals.T),
                                     jnp.asarray(w4.numpy()),
                                     jnp.asarray(p4.numpy())))
    _close(tsp.spectrum_to_xyz(_t(vals.T.copy()), w4, p4),
           jsp.spectrum_to_xyz(jnp.asarray(vals.T), jnp.asarray(w4.numpy()),
                               jnp.asarray(p4.numpy())))


def test_blackbody_matches_jax(wl):
    for temp in (1800.0, 3200.0, 6500.0, 12000.0):
        a = tsp.blackbody_radiance(wl.astype(np.float64), temp)
        assert isinstance(a, np.ndarray) and a.dtype == np.float32
        _close(a, jsp.blackbody_radiance(wl.astype(np.float64), temp))
        _close(tsp.blackbody_radiance(_t(wl), temp), a)


# ---------------------------------------------------------------------------
# The host fits and the lattice
# ---------------------------------------------------------------------------

def test_host_fits_byte_equal():
    rng = np.random.default_rng(5)
    rgbs = rng.uniform(0, 1.4, (256, 3))
    rgbs[:3] = [[0, 0, 0], [1, 1, 1], [3.0, 0.2, 0.1]]
    for a, b in zip(tsp.fit_srgb_model_batch(rgbs),
                    jsp.fit_srgb_model_batch(rgbs)):
        assert np.array_equal(a, b)
    wls = np.linspace(380, 780, 41)
    vals = 0.5 + 0.4 * np.sin(wls / 37.0)
    for a, b in zip(tsp.fit_srgb_model_to_spectrum(wls, vals),
                    jsp.fit_srgb_model_to_spectrum(wls, vals)):
        assert np.array_equal(a, b)
    assert np.array_equal(tsp.spectrum_to_rgb_host(wls, vals),
                          jsp.spectrum_to_rgb_host(wls, vals))
    for rgb in rgbs[:8]:
        for a, b in zip(tsp.fit_srgb_model(rgb), jsp.fit_srgb_model(rgb)):
            assert np.array_equal(a, b)


def test_lattices_byte_equal():
    """The committed res-32 table (the port's copy) and a fitted res-4
    lattice (_build_srgb_lattice) equal the JAX package's."""
    assert np.array_equal(tsp.srgb_model_fetch_lattice(32),
                          jsp.srgb_model_fetch_lattice(32))
    assert np.array_equal(tsp._build_srgb_lattice(4),
                          jsp._build_srgb_lattice(4))


def test_lattice_fetch_matches_jax():
    rng = np.random.default_rng(6)
    rgb = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    rgb[:3] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5]]
    for res in (64, 32):
        lat_t = tsp.srgb_model_fetch_lattice(res)
        lat_j = jsp.srgb_model_fetch_lattice(res)
        _close(tsp.srgb_model_fetch_interp(lat_t, _t(rgb)),
               jsp.srgb_model_fetch_interp(lat_j, jnp.asarray(rgb)),
               f"res {res}", rtol=1e-4)


def test_coeff_file_round_trip(tmp_path, monkeypatch):
    """A lattice saved in the reference's .coeff format loads back equal in
    both packages (each reads the other's file); under MI_SRGB_COEFF it
    replaces the default, its own z nodes in the fetch."""
    lat = tsp.srgb_model_fetch_lattice(32)
    zn = tsp._z_nodes(32) ** 1.1
    p_t, p_j = tmp_path / "port.coeff", tmp_path / "jax.coeff"
    tsp.save_rgb2spec_coeff(p_t, lat, zn)
    jsp.save_rgb2spec_coeff(p_j, lat, zn)
    assert p_t.read_bytes() == p_j.read_bytes()
    for loader in (tsp.load_rgb2spec_coeff, jsp.load_rgb2spec_coeff):
        got, nodes = loader(p_t)
        assert np.array_equal(got, lat)
        assert np.array_equal(nodes, zn.astype(np.float32))
    bad = tmp_path / "bad.coeff"
    bad.write_bytes(b"NOPE" + bytes(8))
    with pytest.raises(ValueError, match="magic"):
        tsp.load_rgb2spec_coeff(bad)
    monkeypatch.setenv("MI_SRGB_COEFF", str(p_t))
    monkeypatch.setattr(tsp, "_ACTIVE_EXTERNAL", None)
    monkeypatch.setattr(tsp, "_LATTICE_CACHE", {})
    try:
        active = tsp.srgb_model_fetch_lattice()
        assert active.shape == lat.shape and np.array_equal(active, lat)
        rgb = _t(np.asarray([[0.3, 0.6, 0.2], [0.9, 0.1, 0.4]], np.float32))
        with_file = tsp.srgb_model_fetch_interp(active, rgb)
        monkeypatch.setattr(tsp, "_ACTIVE_EXTERNAL", None)
        plain = tsp.srgb_model_fetch_interp(lat, rgb)
        assert not torch.equal(with_file, plain)   # the file's z nodes
    finally:
        monkeypatch.setattr(tsp, "_ACTIVE_EXTERNAL", None)


# ---------------------------------------------------------------------------
# Spectrum slots
# ---------------------------------------------------------------------------

SLOTS = {
    "regular": {"type": "regular", "lambda_min": 400.0, "lambda_max": 700.0,
                "values": [0.1, 0.3, 0.8, 0.6, 0.2]},
    "irregular": {"type": "irregular",
                  "wavelengths": [380.0, 450.0, 520.0, 610.0, 780.0],
                  "values": [0.9, 0.2, 0.1, 0.5, 0.95]},
    "blackbody": {"type": "blackbody", "temperature": 3000.0,
                  "scale": 1e-3},
    "d65": {"type": "d65", "value": 2.0},
    "uniform": {"type": "uniform", "value": 0.4},
    "rgb": [0.2, 0.7, 0.4],
}


@pytest.mark.parametrize("illuminant", [False, True])
@pytest.mark.parametrize("name", sorted(SLOTS))
def test_slots_match_jax(name, illuminant):
    a = spectra.pack_color(SLOTS[name], illuminant=illuminant)
    b = jspectra.pack_color(SLOTS[name], illuminant=illuminant)
    assert a.dtype == b.dtype == np.float32 and a.shape == (8,)
    if name == "blackbody":   # Planck in f32: XLA's exp and torch's
        _close(a, b)
        # a tabulated spectrum is the whole spectrum: no D65 factor
        assert a[7] == b[7] == spectra.SLOT_REFLECTANCE
    else:
        assert np.array_equal(a, b)


def test_textured_slot_raises_by_name(tmp_path):
    """A bitmap read from an image file (since the scene loader's slice)
    packs the JAX package's spectral slot, and the texels of the array it
    decodes to, linearised; rendering it in the spectral_polarized variant
    still raises by name."""
    from mitsuba2_tpu_torch.core import io_bitmap
    path = str(tmp_path / "x.exr")
    io_bitmap.write_exr(path, np.random.default_rng(3).uniform(
        0, 1, (4, 6, 3)).astype(np.float32))
    desc = {"type": "bitmap", "filename": path}
    with spectra.texture_staging() as staged:
        row_t = spectra.pack_color(desc)
    jspectra.begin_texture_staging()
    try:
        row_j = jspectra.pack_color(desc)
    finally:
        jspectra.end_texture_staging()
    assert row_t.tobytes() == np.asarray(row_j).tobytes()
    assert np.array_equal(staged[0].data, io_bitmap.srgb_to_linear(
        io_bitmap.read(path)))
    with pytest.raises(NotImplementedError, match="spectral_polarized"):
        mt.RenderConfig(color_mode="spectral", polarized=True)


@pytest.mark.parametrize("mode", ["spectral", "rgb", "mono"])
def test_eval_spectrum_slot_matches_jax(mode):
    """Reflectance and illuminant slots of every kind above, gathered by a
    random row a lane, at each lane's hero wavelengths."""
    rows = np.stack([spectra.pack_color(v, illuminant=i)
                     for v in SLOTS.values() for i in (False, True)])
    rng = np.random.default_rng(7)
    idx = rng.integers(0, len(rows), N).astype(np.int32)
    u = rng.uniform(size=N).astype(np.float32)
    wl_t, _ = tsp.sample_hero_wavelengths_t(_t(u))
    wl_j, _ = jsp.sample_hero_wavelengths_t(jnp.asarray(u))
    out_t = spectra.eval_spectrum_slot(
        spectra.LaneRows(_t(rows), _t(idx.astype(np.int64))), wl_t, mode)
    out_j = jspectra.eval_spectrum_slot(
        jspectra.LaneRows(jnp.asarray(rows), jnp.asarray(idx)), wl_j, mode)
    assert out_t.n == {"spectral": 4, "rgb": 3, "mono": 1}[mode]
    for a, b in zip(out_t.ch, out_j.ch):
        _close(a, b)


def test_tex_value_matches_jax():
    """Per-lane RGB upsampled through the lattice (envmap NEE's path),
    HDR values folded into the scale."""
    rng = np.random.default_rng(8)
    rgb = rng.uniform(0, 1, (3, N)).astype(np.float32)
    rgb[:, :N // 4] *= 6.0
    u = rng.uniform(size=N).astype(np.float32)
    wl_t, _ = tsp.sample_hero_wavelengths_t(_t(u))
    wl_j, _ = jsp.sample_hero_wavelengths_t(jnp.asarray(u))
    out_t = spectra._tex_value(Spec(tuple(_t(c) for c in rgb)), wl_t,
                               "spectral")
    out_j = jspectra._tex_value(JSpec(tuple(jnp.asarray(c) for c in rgb)),
                                wl_j, "spectral")
    for a, b in zip(out_t.ch, out_j.ch):
        _close(a, b, rtol=1e-4)


def test_spec_ops_at_four_channels():
    """Spec's hmax, any_positive and masked at 4 channels."""
    ch = tuple(torch.tensor(v) for v in ([0.0, -1.0, 2.0], [0.0, 3.0, 0.0],
                                         [0.0, 0.0, -5.0], [0.0, 0.5, 1.0]))
    s = Spec(ch)
    assert s.n == 4
    assert s.hmax().tolist() == [0.0, 3.0, 2.0]
    assert s.any_positive().tolist() == [False, True, True]
    m = s.masked(torch.tensor([True, False, True]))
    assert [c.tolist() for c in m.ch] == [[0.0, 0.0, 2.0], [0.0, 0.0, 0.0],
                                          [0.0, 0.0, -5.0], [0.0, 0.0, 1.0]]


def test_config_spectral_channels():
    cfg = mt.RenderConfig(color_mode="spectral")
    assert cfg.n_channels == 4 and cfg.n_image_channels == 3
    assert mt.RenderConfig(color_mode="mono").n_image_channels == 1


# ---------------------------------------------------------------------------
# Renders
# ---------------------------------------------------------------------------

RENDER = dict(width=16, height=16, spp=4, spp_per_pass=4, max_depth=3,
              rr_depth=8, color_mode="spectral")


@pytest.fixture(scope="module")
def refs():
    """The JAX package's spectral renders of veach_mis(envmap=True) and
    mesh_gallery(subdiv=1) at RENDER, seed 0."""
    cfg = mi.RenderConfig(**RENDER)
    return {"veach": REFS.get("veach", lambda: np.asarray(mi.render(
                jpresets.veach_mis(envmap=True), cfg, seed=0))),
            "gallery": REFS.get("gallery", lambda: np.asarray(mi.render(
                jpresets.mesh_gallery(subdiv=1), cfg, seed=0)))}


def test_golden_is_fresh():
    """The golden's gallery image recomputed by the JAX package now."""
    stored, live = REFS.fresh("gallery", lambda: np.asarray(mi.render(
        jpresets.mesh_gallery(subdiv=1), mi.RenderConfig(**RENDER), seed=0)))
    np.testing.assert_array_equal(stored, live)


def _assert_image_close(img_t, img_j):
    assert img_t.shape == img_j.shape == (16, 16, 3)
    assert np.isfinite(img_t).all() and img_t.mean() > 0
    close = np.isclose(img_t, img_j, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99
    np.testing.assert_allclose(img_t.mean(), img_j.mean(), rtol=1e-3)


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_veach_envmap_spectral_matches_jax(refs, backend):
    """Under "auto" brute force; under "pallas" (set before the build)
    the BVH2 walk's twins (K3), on envmap shadow rays of t_max ~1e7."""
    scene_mod.set_backend(backend)
    try:
        scene = mt.veach_mis(envmap=True, device="cpu")
        img = mt.render(scene, mt.RenderConfig(**RENDER), seed=0,
                        device="cpu").numpy()
    finally:
        scene_mod.set_backend("auto")
    assert (scene.bvh_node is not None) == (backend == "pallas")
    _assert_image_close(img, refs["veach"])


def test_gallery_spectral_matches_jax(refs):
    scene = mt.mesh_gallery(subdiv=1, device="cpu")
    assert scene.mxu_node_f is not None          # the cluster walk's twins
    img = mt.render(scene, mt.RenderConfig(**RENDER), seed=0,
                    device="cpu").numpy()
    _assert_image_close(img, refs["gallery"])


def test_veach_spectral_matches_rgb():
    """tests/test_veach.py's case on the port: hero-wavelength MC with
    RGB-upsampled metals agrees with the rgb render to ~10% on lit
    pixels (median relative difference under 0.12)."""
    scene = mt.veach_mis(device="cpu")
    cfg = mt.RenderConfig(width=32, height=32, spp=48, spp_per_pass=48,
                          max_depth=3, rr_depth=99)
    rgb = mt.render(scene, cfg, device="cpu").numpy()
    spec = mt.render(scene, cfg.replace(color_mode="spectral"),
                     device="cpu").numpy()
    assert np.isfinite(spec).all()
    mask = rgb.max(-1) > 0.05
    rel = np.abs(spec - rgb)[mask] / np.maximum(rgb[mask], 0.05)
    assert np.median(rel) < 0.12


def test_spectral_white_furnace():
    """The furnace (a white diffuse sphere under a white constant sky) in
    spectral mode: an illuminant slot of radiance 1 integrates to RGB 1
    through D65 at unit luminance (tests/test_spectrum.py's white)."""
    cfg = mt.RenderConfig(width=16, height=16, spp=64, spp_per_pass=64,
                          max_depth=2, color_mode="spectral")
    img = mt.render(mt.furnace(albedo=1.0, device="cpu"), cfg,
                    device="cpu").numpy()
    np.testing.assert_allclose(img.mean((0, 1)), 1.0, rtol=0.05)
