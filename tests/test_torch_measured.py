"""The measured BSDFs in the PyTorch port against the JAX package.

render/rgl.py (the port's copy of the RGL `.bsdf` reader): the tensor
file's round trip and its bytes against the JAX writer's, the
Marginal2D warp, the synthetic GGX capture written byte for byte as the
JAX package writes it and loaded into a byte-equal table, near the
analytic model it was baked from; tests/test_rgl_spectral.py's spectral
container (its independent serializer) loaded byte-equal, against the
rgb branch. render/measured.py: the CDFs of one table byte-equal; a
bake of rough gold and the conductor Mueller bake within rtol 1e-5 of the
JAX package's (each package evaluates its own model); eval, pdf, sample
and mueller_lookup lane by lane against the JAX package's on the same
table, on the lanes whose cells agree (the share of lanes whose arccos
or arctan2 rounds to another cell is printed and held under 1%); the
measured sampler's chi^2 through the port's chi2.py; tests/test_measured.py's
and tests/test_measured_polarized.py's cases on the port; measured and
measured_polarized captures from `values` and from a file built into
tables byte-equal to the JAX build's; measured renders in mono and
spectral mode (the channel mean) against the JAX package's; each scene
build's staging its own; scene_from_numpy's KeyError for a measured row
without its tables. The JAX package's arrays are committed
(tests/goldens/test_torch_measured.npz, `python tests/goldens/make_refs.py
test_torch_measured`); its numpy-only code (rgl.py, the CDF build) runs
live, and one golden entry is recomputed live.
"""
import os

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu.render import measured as jms
from mitsuba2_tpu.render import rgl as jrgl
from mitsuba2_tpu_torch.chi2 import ChiSquareTest, SphericalDomain
from mitsuba2_tpu_torch.core.vec import Vec3
from mitsuba2_tpu_torch.render import measured as tms
from mitsuba2_tpu_torch.render import rgl as trgl

from goldens.jax_refs import Refs
from test_torch_instancing import recorded_fields
from test_torch_media import jax_fields
from test_torch_polarized import assert_image_close, package

# one intra-op thread: the suite's test processes share the cores
# (pytest-xdist), and torch's OpenMP regions stall when they
# oversubscribe them
torch.set_num_threads(1)

REFS = Refs("test_torch_measured")
ROUGH_GOLD = {"type": "roughconductor", "material": "Au", "alpha": 0.3}
SMALL = dict(n_ti=16, n_to=32, n_phi=32)
AU_ETA = complex(0.3749, 2.3857)


# ---------------------------------------------------------------------------
# rgl.py
# ---------------------------------------------------------------------------

def _fields():
    return {"theta_i": np.linspace(0, 1.5, 7).astype(np.float32),
            "ndf": np.random.default_rng(0).random((16, 16)).astype(
                np.float32),
            "counts": np.arange(10, dtype=np.int32),
            "description": np.frombuffer(b"hello", np.uint8).copy()}


def test_tensor_file_roundtrip(tmp_path):
    """tests/test_rgl.py's round trip through the port's writer and
    reader; the file byte-equal to the JAX writer's, each package reading
    the other's."""
    fields = _fields()
    p, pj = str(tmp_path / "t.bsdf"), str(tmp_path / "tj.bsdf")
    trgl.write_tensor_file(p, fields)
    jrgl.write_tensor_file(pj, fields)
    assert open(p, "rb").read() == open(pj, "rb").read()
    for back in (trgl.read_tensor_file(p), jrgl.read_tensor_file(p),
                 trgl.read_tensor_file(pj)):
        assert set(back) == set(fields)
        for k in fields:
            np.testing.assert_array_equal(back[k], fields[k])
            assert back[k].dtype == fields[k].dtype


def test_marginal2d_invert_roundtrip():
    rng = np.random.default_rng(1)
    density = rng.random((32, 32)) + 0.1
    u1, u2 = rng.random((64,)), rng.random((64,))
    warp = trgl._Marginal2D(density)
    u, v = warp.sample(u1, u2)
    r1, r2 = warp.invert(u, v)
    np.testing.assert_allclose(r1, u1, atol=2e-3)
    np.testing.assert_allclose(r2, u2, atol=2e-3)
    ju, jv = jrgl._Marginal2D(density).sample(u1, u2)
    assert np.array_equal(u, ju) and np.array_equal(v, jv)


@pytest.fixture(scope="module")
def ggx_capture(tmp_path_factory):
    """tests/test_rgl.py's synthetic GGX capture (alpha 0.35), written by
    each package: (the port's file, the JAX package's)."""
    d = tmp_path_factory.mktemp("rgl")
    kw = dict(alpha=0.35, rgb_tint=(0.9, 0.7, 0.4), n_ti=24, res=96, res2=96)
    p, pj = str(d / "ggx.bsdf"), str(d / "ggx_jax.bsdf")
    trgl.write_rgl_ggx(p, **kw)
    jrgl.write_rgl_ggx(pj, **kw)
    return p, pj


def test_ggx_capture_byte_equal(ggx_capture):
    p, pj = ggx_capture
    assert open(p, "rb").read() == open(pj, "rb").read()
    t = trgl.load_rgl(p, n_ti=12, n_to=24, n_phi=24)
    assert t.dtype == np.float32 and t.tobytes() == jrgl.load_rgl(
        p, n_ti=12, n_to=24, n_phi=24).tobytes()


def test_rgl_load_matches_analytic_ggx(ggx_capture):
    """tests/test_rgl.py's check on the port's loader: the reconstruction
    near the analytic GGX values the capture was baked from."""
    table = trgl.load_rgl(ggx_capture[0], n_ti=24, n_to=48, n_phi=48)
    assert table.shape == (24, 48, 48, 3)
    a2 = 0.35 ** 2
    ti = (np.arange(24) + 0.5) / 24 * (np.pi / 2)
    to = (np.arange(48) + 0.5) / 48 * (np.pi / 2)
    ph = (np.arange(48) + 0.5) / 48 * (2 * np.pi)
    TI, TO, PH = np.meshgrid(ti, to, ph, indexing="ij")
    wi = np.stack([np.sin(TI), np.zeros_like(TI), np.cos(TI)], -1)
    wo = np.stack([np.sin(TO) * np.cos(PH), np.sin(TO) * np.sin(PH),
                   np.cos(TO)], -1)
    wm = wi + wo
    wm /= np.linalg.norm(wm, axis=-1, keepdims=True)
    cm = wm[..., 2]
    D = a2 / (np.pi * np.maximum((cm * cm * (a2 - 1) + 1) ** 2, 1e-12))

    def lam(c):
        t2 = np.maximum(1 - c * c, 0.0) / np.maximum(c * c, 1e-12)
        return 0.5 * (np.sqrt(1 + a2 * t2) - 1)

    G = 1.0 / (1.0 + lam(np.cos(TI)) + lam(np.cos(TO)))
    ref = D * G / np.maximum(4 * np.cos(TI) * np.cos(TO), 1e-9) * np.cos(TO)
    sel = (TI < 1.25) & (TO < 1.25) & (ref > 1e-3)
    tint = np.array([0.9, 0.7, 0.4])
    rel = (np.abs(table[sel] / tint - ref[sel, None])
           / (ref[sel, None] + 1e-2))
    assert np.median(rel) < 0.1 and np.mean(rel) < 0.25


def _measured_on(table, device="cpu"):
    return tms.measured_from_numpy(tms.build_measured([table]), device)


def test_rgl_sampler_chi2(ggx_capture):
    """tests/test_rgl.py's chi^2 of the measured sampler built from the
    loaded capture against its own pdf, through the port's chi2.py."""
    md = _measured_on(trgl.load_rgl(ggx_capture[0]))
    theta_i = 0.7

    def wi_of(n):
        return Vec3(torch.full((n,), np.sin(theta_i)), torch.zeros(n),
                    torch.full((n,), np.cos(theta_i)))

    def sample_fn(u):
        n = u.shape[0]
        wo, pdf = tms.sample_measured(md, torch.zeros(n, dtype=torch.int64),
                                      wi_of(n), (u[:, 0], u[:, 1]))
        m = (pdf > 0).float()
        return Vec3(wo.x * m, wo.y * m, wo.z * m)

    def pdf_fn(wo):
        flat = wo.reshape(-1, 3)
        n = flat.shape[0]
        return tms.pdf_measured(md, torch.zeros(n, dtype=torch.int64),
                                wi_of(n), Vec3(*flat.unbind(1))).reshape(
            wo.shape[:-1])

    test = ChiSquareTest(SphericalDomain(), sample_fn, pdf_fn,
                         sample_count=200_000, res=16)
    assert test.run(), test.messages


def _spectral_tint(wav, S):
    """tests/test_rgl.py's expected tint of an SPD (its CIE weighting)."""
    from mitsuba2_tpu_torch.core import cie_data as cie
    from mitsuba2_tpu_torch.core import spectrum as sp
    w = cie.interp_table(cie.CIE_1931_TBL, wav) * (
        cie.interp_table(cie.D65_TBL, wav) / 100.0)[:, None]
    w /= np.trapezoid(w[:, 1], wav)
    xyz = (S[:, None] * w * np.gradient(wav)[:, None]).sum(0)
    return np.asarray(sp.XYZ_TO_SRGB, np.float64) @ xyz


def test_rgl_spectral_branch_matches_rgb(tmp_path):
    """tests/test_rgl.py's spectral capture through the port: the same
    material as the rgb capture of its projected tint; its tables
    byte-equal to the JAX loader's."""
    wav = np.linspace(380.0, 780.0, 41)
    S = 0.35 + 0.55 * np.exp(-0.5 * ((wav - 600.0) / 70.0) ** 2)
    p_spec, p_rgb = str(tmp_path / "spec.bsdf"), str(tmp_path / "rgb.bsdf")
    trgl.write_rgl_ggx(p_spec, alpha=0.3, n_ti=8, res=48, res2=48,
                       spectral=(wav, S))
    trgl.write_rgl_ggx(p_rgb, alpha=0.3, n_ti=8, res=48, res2=48,
                       rgb_tint=tuple(_spectral_tint(wav, S)))
    fields = trgl.read_tensor_file(p_spec)
    assert {"spectra", "wavelengths", "description", "jacobian", "valid",
            "luminance"} <= set(fields) and "rgb" not in fields
    tab_spec = trgl.load_rgl(p_spec, n_ti=12, n_to=32, n_phi=32)
    tab_rgb = trgl.load_rgl(p_rgb, n_ti=12, n_to=32, n_phi=32)
    sel = tab_rgb > 1e-4
    np.testing.assert_allclose(np.median(tab_rgb[sel] / tab_spec[sel]), 1.0,
                               rtol=5e-3)
    np.testing.assert_allclose(tab_spec, tab_rgb, rtol=2e-2, atol=2e-3)
    assert tab_spec.tobytes() == jrgl.load_rgl(p_spec, n_ti=12, n_to=32,
                                               n_phi=32).tobytes()


@pytest.fixture(scope="module")
def spectral_pair(tmp_path_factory):
    """tests/test_rgl_spectral.py's capture pair: its spectral container
    (irregular wavelengths, a separable spectrum, the full field census)
    written by that file's independent serializer, and the rgb capture of
    the trapezoid-integrated tint, both through the port's writer for the
    geometry tensors."""
    import test_rgl_spectral as trs
    from mitsuba2_tpu_torch.core import cie_data as cie
    from mitsuba2_tpu_torch.core import spectrum as sp
    d = tmp_path_factory.mktemp("rgl_spec")
    n_ti, res = trs.N_TI, trs.RES
    base_p = str(d / "base.bsdf")
    trgl.write_rgl_ggx(base_p, alpha=0.3, rgb_tint=(1.0, 1.0, 1.0),
                       n_ti=n_ti, res=res, res2=trs.RES2)
    base = trgl.read_tensor_file(base_p)
    resid = base["rgb"][:, :, 0]
    wav = np.array([400., 435., 465., 500., 530., 565., 600., 640., 675.,
                    705., 730.], np.float32)
    s = trs._spectral_curve(wav.astype(np.float64))
    w = cie.interp_table(cie.CIE_1931_TBL, wav) * (
        cie.interp_table(cie.D65_TBL, wav) / 100.0)[:, None]
    w = w / np.trapezoid(w[:, 1], wav)
    tint = np.asarray(sp.XYZ_TO_SRGB, np.float64) @ np.stack(
        [np.trapezoid(s * w[:, c], wav) for c in range(3)])
    spec_p, rgb_p = str(d / "spectral.bsdf"), str(d / "rgb.bsdf")
    trs._write_powitacq_bytes(spec_p, {
        "description": np.frombuffer(b"synthetic spectral ggx",
                                     np.uint8).copy(),
        "theta_i": base["theta_i"], "phi_i": np.zeros(1, np.float32),
        "ndf": base["ndf"], "sigma": base["sigma"], "vndf": base["vndf"],
        "luminance": resid.astype(np.float32),
        "spectra": (resid[:, :, None] * s[None, None, :, None, None]
                    ).astype(np.float32),
        "wavelengths": wav, "jacobian": np.ones(1, np.uint8),
        "valid": np.ones((res, res), np.uint8)})
    trgl.write_rgl_ggx(rgb_p, alpha=0.3, rgb_tint=tuple(tint), n_ti=n_ti,
                       res=res, res2=trs.RES2)
    return spec_p, rgb_p, tint


def test_spectral_container_loads_byte_equal(spectral_pair):
    """tests/test_rgl_spectral.py's cases on the port's reader: the full
    field census, the spectral branch against the rgb one (99% of cells
    within 2%), the measured eval of both captures (99% within 3%); the
    tables byte-equal to the JAX loader's."""
    spec_p, rgb_p, _ = spectral_pair
    fields = trgl.read_tensor_file(spec_p)
    assert {"theta_i", "phi_i", "ndf", "sigma", "vndf", "luminance",
            "spectra", "wavelengths", "jacobian", "description",
            "valid"} <= set(fields) and "rgb" not in fields
    assert fields["description"].tobytes() == b"synthetic spectral ggx"
    t_spec = trgl.load_rgl(spec_p, n_ti=10, n_to=24, n_phi=24)
    t_rgb = trgl.load_rgl(rgb_p, n_ti=10, n_to=24, n_phi=24)
    assert t_spec.tobytes() == jrgl.load_rgl(spec_p, n_ti=10, n_to=24,
                                             n_phi=24).tobytes()
    rel = np.abs(t_spec - t_rgb) / np.maximum(t_rgb, 1e-4)
    assert np.quantile(rel[t_rgb > 1e-3], 0.99) < 0.02
    md = tms.measured_from_numpy(tms.build_measured([
        trgl.load_rgl(spec_p, n_ti=12, n_to=32, n_phi=32),
        trgl.load_rgl(rgb_p, n_ti=12, n_to=32, n_phi=32)]), "cpu")
    wi, wo = _directions(256, 3, lift=0.2)
    v_s = _stack(tms.eval_measured(md, torch.zeros(256), wi, wo))
    v_r = _stack(tms.eval_measured(md, torch.ones(256), wi, wo))
    assert np.isfinite(v_s).all() and (v_s >= 0).all() and v_s.max() > 0
    sel = v_r > 1e-3
    assert np.quantile(np.abs(v_s - v_r)[sel] / v_r[sel], 0.99) < 0.03


# ---------------------------------------------------------------------------
# measured.py: the tables
# ---------------------------------------------------------------------------

def _stack(spec):
    return torch.stack(spec.ch, -1).numpy()


def _directions(n, seed, lift=0.15):
    """tests/test_measured.py's upper-hemisphere directions, (wi, wo)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        w = rng.normal(size=(n, 3))
        w[:, 2] = np.abs(w[:, 2]) + lift
        w /= np.linalg.norm(w, axis=-1, keepdims=True)
        out.append(Vec3(*torch.from_numpy(w.astype(np.float32)).unbind(1)))
    return out


def _jax_bake():
    return jms.bake_from_desc(ROUGH_GOLD, **SMALL)


@pytest.fixture(scope="module")
def small_table():
    """The port's bake of rough gold on SMALL's grid."""
    return tms.bake_from_desc(ROUGH_GOLD, **SMALL)


def test_golden_is_fresh():
    stored, live = REFS.fresh("mueller_bake", lambda: jms.bake_mueller_conductor(
        AU_ETA.real, AU_ETA.imag, 8, 16, 16))
    np.testing.assert_array_equal(stored, live)


def test_bakes_match_jax(small_table):
    """The rough-gold bake and the conductor Mueller bake within rtol 1e-5
    of the JAX package's: each package evaluates its own model."""
    ref = REFS.get("bake", _jax_bake)
    assert small_table.dtype == np.float32 and small_table.shape == (
        16, 32, 32, 3)
    np.testing.assert_allclose(small_table, ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())
    mm = tms.bake_mueller_conductor(AU_ETA.real, AU_ETA.imag, 8, 16, 16)
    ref_mm = REFS.get("mueller_bake", lambda: jms.bake_mueller_conductor(
        AU_ETA.real, AU_ETA.imag, 8, 16, 16))
    np.testing.assert_allclose(mm, ref_mm, rtol=1e-5, atol=1e-6)


def test_build_measured_byte_equal(small_table):
    """One table (and a Mueller table beside a plain entry) -> the same
    weights and CDFs bytes as the JAX package's build."""
    mm = tms.bake_mueller_conductor(AU_ETA.real, AU_ETA.imag, **SMALL)
    got = tms.build_measured([small_table, (small_table, mm)])
    ref = jms.build_measured([small_table, (small_table, mm)])
    for k in tms.TABLES:
        a = np.asarray(getattr(ref, k))
        assert got[k].dtype == a.dtype and got[k].shape == a.shape, k
        assert got[k].tobytes() == a.tobytes(), k


# ---------------------------------------------------------------------------
# measured.py: the lookups, lane by lane
# ---------------------------------------------------------------------------

N_LANES = 4096


def _jax_lookups(table, mm):
    """The JAX package's eval, pdf, sample (wo, pdf) and mueller_lookup on
    _directions(N_LANES, 7) and seeded u2 over the table and its Mueller
    table, and the cells its lookups round to (the JAX arithmetic of
    measured.py's _grid_lookup and mueller_lookup)."""
    import jax.numpy as jnp
    md = jms.build_measured([(table, mm)])
    wi, wo = (np.stack([v.x.numpy(), v.y.numpy(), v.z.numpy()], -1)
              for v in _directions(N_LANES, 7))
    wi, wo = jnp.asarray(wi), jnp.asarray(wo)
    u2 = jnp.asarray(np.random.default_rng(8).uniform(
        size=(N_LANES, 2)).astype(np.float32))
    tid = jnp.zeros(N_LANES, jnp.int32)
    s_wo, s_pdf = jms.sample_measured(md, tid, wi, u2)
    n_ti, n_to, n_phi = table.shape[:3]
    theta_i = jnp.arccos(jnp.clip(wi[:, 2], 1e-6, 1.0))
    theta_o = jnp.arccos(jnp.clip(wo[:, 2], 0.0, 1.0))
    phi_d = jnp.remainder(jnp.arctan2(wo[:, 1], wo[:, 0])
                          - jnp.arctan2(wi[:, 1], wi[:, 0]), 2 * jnp.pi)
    x_to = jnp.clip(theta_o / (jnp.pi / 2) * n_to - 0.5, 0.0, n_to - 1.0)
    x_ph = phi_d / (2 * jnp.pi) * n_phi - 0.5
    i_ti = jnp.clip((theta_i / (jnp.pi / 2) * n_ti).astype(jnp.int32), 0,
                    n_ti - 1)
    i_to = jnp.clip((theta_o / (jnp.pi / 2) * n_to).astype(jnp.int32), 0,
                    n_to - 1)
    i_ph = jnp.remainder((phi_d / (2 * jnp.pi) * n_phi).astype(jnp.int32),
                         n_phi)
    cells = jnp.stack([i_ti, jnp.floor(x_to).astype(jnp.int32),
                       jnp.floor(x_ph).astype(jnp.int32),
                       jnp.round(x_to).astype(jnp.int32),
                       jnp.round(x_ph).astype(jnp.int32),
                       ((i_ti * n_to) + i_to) * n_phi + i_ph], 1)
    # sample's theta_i cell comes from wi alone, as the lookups'
    return dict(
        eval=np.asarray(jms.eval_measured(md, tid, wi, wo).to_array()),
        pdf=np.asarray(jms.pdf_measured(md, tid, wi, wo)),
        sample_wo=np.asarray(s_wo.to_array()), sample_pdf=np.asarray(s_pdf),
        mueller=np.asarray(jms.mueller_lookup(md, tid, wi, wo)),
        cells=np.asarray(cells))


@pytest.fixture(scope="module")
def lookups(small_table):
    """The port's lookups on the JAX package's bake (both packages read
    one table) and the JAX package's (golden)."""
    table = REFS.get("bake", _jax_bake)
    mm = tms.bake_mueller_conductor(AU_ETA.real, AU_ETA.imag, **SMALL)
    md = tms.measured_from_numpy(tms.build_measured([(table, mm)]), "cpu")
    wi, wo = _directions(N_LANES, 7)
    u = torch.from_numpy(np.random.default_rng(8).uniform(
        size=(N_LANES, 2)).astype(np.float32))
    tid = torch.zeros(N_LANES, dtype=torch.int64)
    s_wo, s_pdf = tms.sample_measured(md, tid, wi, (u[:, 0], u[:, 1]))
    got = dict(eval=_stack(tms.eval_measured(md, tid, wi, wo)),
               pdf=tms.pdf_measured(md, tid, wi, wo).numpy(),
               sample_wo=torch.stack([s_wo.x, s_wo.y, s_wo.z], -1).numpy(),
               sample_pdf=s_pdf.numpy(),
               mueller=tms.mueller_lookup(md, tid, wi, wo).numpy(),
               cells=tms.lookup_cells(md, wi, wo).numpy())
    return got, REFS.get("lookups", lambda: _jax_lookups(table, mm))


def test_lookup_cells_agree(lookups):
    """The cells each lane's lookups round to: the share of lanes where
    one differs from the JAX package's, printed, under 1%."""
    got, ref = lookups
    differ = (got["cells"] != ref["cells"]).any(1)
    print(f"measured lookups: {differ.mean():.6f} of {N_LANES} lanes round "
          f"to another cell than the JAX package's")
    assert differ.mean() < 0.01


@pytest.mark.parametrize("what", ["eval", "pdf", "mueller"])
def test_lookups_match_jax(lookups, what):
    """eval, pdf and mueller_lookup on the lanes whose cells agree, within
    rtol 1e-5 / atol 1e-6 of the JAX package's."""
    got, ref = lookups
    same = (got["cells"] == ref["cells"]).all(1)
    assert same.mean() > 0.99
    np.testing.assert_allclose(got[what][same], ref[what][same], rtol=1e-5,
                               atol=1e-6)


def test_sample_matches_jax(lookups):
    """sample_measured's direction and pdf: the bisection picks the same
    cell on every lane (the CDFs are byte-equal), the direction within
    2e-6 and the pdf within rtol 1e-5."""
    got, ref = lookups
    np.testing.assert_allclose(got["sample_wo"], ref["sample_wo"],
                               atol=2e-6)
    np.testing.assert_allclose(got["sample_pdf"], ref["sample_pdf"],
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# tests/test_measured.py and tests/test_measured_polarized.py on the port
# ---------------------------------------------------------------------------

def test_bake_and_eval_matches_analytic():
    """The table baked from rough gold evaluates near the analytic model
    (median relative error under 0.1 on non-grazing angles)."""
    from mitsuba2_tpu_torch.core.geometry import Frame
    from mitsuba2_tpu_torch.core.vec import Vec2
    from mitsuba2_tpu_torch.render import bsdf as B
    from mitsuba2_tpu_torch.render.interaction import SurfaceInteraction
    from mitsuba2_tpu_torch.render.spectra import LaneRows
    md = _measured_on(tms.bake_from_desc(ROUGH_GOLD))
    n = 4096
    wi, wo = _directions(n, 0)
    got = _stack(tms.eval_measured(md, torch.zeros(n), wi, wo))
    mats = []
    B.build_material(ROUGH_GOLD, mats)
    z, one = torch.zeros(n), torch.ones(n)
    up = Vec3(z, z, one)
    si = SurfaceInteraction(valid=one > 0, t=one, p=Vec3(z, z, z), n=up,
                            sh_frame=Frame.from_n(up), uv=Vec2(z, z), wi=wi,
                            shape=z.int(), prim_index=z.int())
    ref = _stack(B.RoughConductor.eval(
        LaneRows(torch.from_numpy(mats[0][2][None]), z.long()), si, wo,
        mt.RenderConfig()))
    mask = ref.max(-1) > 0.01
    rel = np.abs(got - ref)[mask] / np.maximum(ref[mask], 0.01)
    assert np.median(rel) < 0.1


def test_sample_pdf_consistency(small_table):
    """sample's pdf is pdf_measured at the sampled direction (99% of
    lanes within 1e-3; cell boundaries excepted), and the MC estimate of
    the hemispherical reflectance lies in (0.01, 1.2)."""
    md = _measured_on(small_table)
    n = 50_000
    wi = Vec3(torch.full((n,), 0.4), torch.zeros(n),
              torch.full((n,), float(np.sqrt(1 - 0.16))))
    u = torch.from_numpy(np.random.default_rng(1).uniform(
        size=(n, 2)).astype(np.float32))
    tid = torch.zeros(n, dtype=torch.int64)
    wo, pdf = tms.sample_measured(md, tid, wi, (u[:, 0], u[:, 1]))
    a, b = pdf.numpy(), tms.pdf_measured(md, tid, wi, wo).numpy()
    assert (np.abs(a - b) / np.maximum(b, 1e-6) < 1e-3).mean() > 0.99
    val = _stack(tms.eval_measured(md, tid, wi, wo))
    est = (val / np.maximum(a, 1e-9)[:, None]).mean(0)
    assert (est > 0.01).all() and (est < 1.2).all()


def _plate(pkg, bsdf, sky=0.8, fov=30.0):
    cam = pkg.T4.look_at(origin=[0, -2, 2], target=[0, 0, 0], up=[0, 0, 1])
    return pkg.build([pkg.shapes.rectangle(bsdf=bsdf)],
                     {"type": "perspective", "to_world": np.asarray(
                         cam.matrix), "fov": fov},
                     emitters=[{"type": "constant", "radiance": [sky] * 3}])


def _median_rel(a, b, floor=0.02):
    sel = a.max(-1) > 0.02
    return np.median(np.abs(b - a)[sel] / (a[sel] + floor))


def test_measured_render_matches_analytic():
    pkg = package("port")
    cfg = mt.RenderConfig(width=16, height=16, spp=64, spp_per_pass=64,
                          max_depth=2)
    a = pkg.render(_plate(pkg, ROUGH_GOLD), cfg).numpy()
    b = pkg.render(_plate(pkg, {"type": "measured", "bake": ROUGH_GOLD}),
                   cfg).numpy()
    sel = a.max(-1) > 0.02
    assert np.median(np.abs(b - a)[sel] / np.maximum(a[sel], 0.02)) < 0.15


PGOLD = {"type": "roughconductor", "material": "Au", "alpha": 0.2}


def _pol_desc():
    return {"type": "measured_polarized", "bake": PGOLD, "pbake_eta": AU_ETA,
            **SMALL}


def test_measured_polarized_intensity_matches_analytic():
    pkg = package("port")
    cfg = mt.RenderConfig(width=16, height=16, spp=32, spp_per_pass=32,
                          max_depth=2)
    a = pkg.render(_plate(pkg, PGOLD, 1.0, 20.0), cfg, seed=1).numpy()
    b = pkg.render(_plate(pkg, _pol_desc(), 1.0, 20.0), cfg, seed=1).numpy()
    assert _median_rel(a, b) < 0.15


def test_measured_polarized_signature_matches_conductor():
    """The tabulated Mueller structure polarizes the oblique reflection as
    the smooth gold conductor does: degree of polarization within a
    factor 4 of it, the same sign of S1."""
    pkg = package("port")
    cfg = mt.RenderConfig(width=16, height=16, spp=16, spp_per_pass=16,
                          max_depth=2, rr_depth=99)
    s_m = pkg.polarized(_plate(pkg, _pol_desc(), 1.0, 20.0), cfg).numpy()
    s_a = pkg.polarized(_plate(pkg, {"type": "conductor", "material": "Au"},
                               1.0, 20.0), cfg).numpy()
    c_m = s_m[7:10, 7:10].mean((0, 1, 2))
    c_a = s_a[7:10, 7:10].mean((0, 1, 2))
    dop_m = np.sqrt((c_m[1:] ** 2).sum()) / c_m[0]
    dop_a = np.sqrt((c_a[1:] ** 2).sum()) / c_a[0]
    assert c_m[0] > 0.02 and dop_m > 0.01
    assert 0.25 * dop_a < dop_m < 4.0 * dop_a
    assert np.sign(c_m[1]) == np.sign(c_a[1])


def _mixed(pkg):
    """A measured_polarized plate above a plain measured one (mixed
    staging: a Mueller table for one entry, the depolarizer for the
    other)."""
    cam = pkg.T4.look_at(origin=[0, -2, 2], target=[0, 0, 0], up=[0, 0, 1])
    p1 = pkg.shapes.rectangle(bsdf=_pol_desc(), id="a")
    p2 = pkg.shapes.rectangle(bsdf={"type": "measured", "bake": PGOLD,
                                    **SMALL}, id="b").transformed(
        np.asarray(pkg.T4.translate([0, 0, -0.5]).matrix))
    return pkg.build([p1, p2], {"type": "perspective", "to_world": np.asarray(
        cam.matrix), "fov": 20.0},
        emitters=[{"type": "constant", "radiance": [1.0] * 3}])


def test_unpolarized_measured_unaffected():
    scene = _mixed(package("port"))
    assert scene.measured.mueller is not None
    m = scene.measured.mueller.numpy()
    np.testing.assert_array_equal(m[1][..., 0, 0], 1.0)
    assert np.count_nonzero(m[1]) == m[1][..., 0, 0].size
    img = mt.render(scene, mt.RenderConfig(width=8, height=8, spp=4,
                                           spp_per_pass=4, max_depth=2),
                    device="cpu")
    assert torch.isfinite(img).all()


@pytest.mark.parametrize("mode", ["mono", "spectral"])
def test_measured_render_modes_match_jax(mode):
    """Outside rgb mode a measured row splats its RGB's mean: the mixed
    scene carried from the JAX build, rendered in mono and spectral mode,
    against the JAX package's images."""
    sj = _mixed(package("jax"))
    st = mt.scene_from_numpy(jax_fields(sj), device="cpu")
    kw = dict(width=16, height=16, spp=8, spp_per_pass=8, max_depth=3,
              color_mode=mode)
    img = mt.render(st, mt.RenderConfig(**kw), seed=0, device="cpu").numpy()
    ref = REFS.get(f"render/{mode}", lambda: np.asarray(
        package("jax").render(sj, package("jax").Config(**kw), seed=0)))
    assert_image_close(img, ref)


# ---------------------------------------------------------------------------
# Scene builds
# ---------------------------------------------------------------------------

def _capture_scene(pkg, path, values, mueller):
    """A plate of each capture source: an RGL file, `values`, and
    measured_polarized from `values` with a `mueller` table."""
    sh, T4 = pkg.shapes, pkg.T4
    plates = [sh.rectangle(bsdf=b, id=f"p{k}").transformed(np.asarray(
        T4.translate([2.5 * k - 2.5, 0, 0]).matrix)) for k, b in enumerate((
            {"type": "measured", "filename": path, **SMALL},
            {"type": "measured", "values": values},
            {"type": "measured_polarized", "values": values,
             "mueller": mueller}))]
    cam = T4.look_at(origin=[0, -6, 4], target=[0, 0, 0], up=[0, 0, 1])
    return pkg.build(plates, {"type": "perspective", "to_world": np.asarray(
        cam.matrix), "fov": 45.0},
        emitters=[{"type": "constant", "radiance": [1.0] * 3}])


def test_captures_build_byte_equal(ggx_capture, small_table):
    """File- and values-sourced captures: the port's host tables and its
    measured tables byte-equal to the JAX build's; the tables on the
    device equal to them."""
    mm = tms.bake_mueller_conductor(AU_ETA.real, AU_ETA.imag, **SMALL)
    args = (ggx_capture[0], small_table, mm)
    sj = _capture_scene(package("jax"), *args)
    with recorded_fields() as got:
        st = _capture_scene(package("port"), *args)
    f = got[0]
    for k in ("mat_type", "mat_flags", "mat_data"):
        assert f[k].tobytes() == np.asarray(getattr(sj, k)).tobytes(), k
    assert f["param_paths"] == sj.param_paths
    for k in tms.TABLES:
        a = np.asarray(getattr(sj.measured, k))
        assert f["measured"][k].dtype == a.dtype, k
        assert f["measured"][k].tobytes() == a.tobytes(), k
        assert np.array_equal(getattr(st.measured, k).numpy(), a), k
    assert st.mat_families == sj.mat_families


def test_staging_is_per_build(small_table):
    """Each build stages its own tables: two builds each hold table 0
    alone; a measured row outside a build raises."""
    pkg = package("port")
    one = _plate(pkg, {"type": "measured", "values": small_table})
    two = _plate(pkg, {"type": "measured", "values": small_table * 0.5})
    for s, scale in ((one, 1.0), (two, 0.5)):
        assert s.measured.values.shape[0] == 1
        assert float(s.mat_data[0, 28]) == 0.0
        np.testing.assert_array_equal(s.measured.values[0].numpy(),
                                      small_table * np.float32(scale))
    from mitsuba2_tpu_torch.render import bsdf as B
    with pytest.raises(RuntimeError, match="outside scene build"):
        B.build_material({"type": "measured", "values": small_table}, [])


def test_scene_from_numpy_needs_the_tables(small_table):
    """A measured row without `measured`, a measured_polarized row without
    its Mueller tables, or tables without a measured row: KeyError, as a
    heterogeneous medium without its grid."""
    sj = _plate(package("jax"), {"type": "measured", "values": small_table})
    fields = jax_fields(sj)
    with pytest.raises(KeyError, match="measured"):
        mt.scene_from_numpy({k: v for k, v in fields.items()
                             if k != "measured"}, device="cpu")
    pol = jax_fields(_plate(package("jax"), _pol_desc()))
    pol["measured"]["mueller"] = None
    with pytest.raises(KeyError, match="mueller"):
        mt.scene_from_numpy(pol, device="cpu")
    plain = jax_fields(_plate(package("jax"), {"type": "diffuse"}))
    plain["measured"] = fields["measured"]
    with pytest.raises(KeyError, match="measured"):
        mt.scene_from_numpy(plain, device="cpu")
    st = mt.scene_from_numpy(fields, device="cpu")
    assert st.measured.mueller is None and st.mat_families == (13,)
