"""The BSDF wrappers in the PyTorch port against the JAX package: null,
mask, blendbsdf, normalmap and bumpmap, over children of mixed families,
with textured opacity, normal and height maps.

Byte-equal: build_material's rows and flags for nested descriptors (the
children's rows after their wrapper's, the lobes inherited) and the
textures they stage. Per lane, through the wavefront dispatch, on a
stand-in scene holding every row: sample (direction, pdf, eta, sampled
flags, weight), eval_ and pdf, in rgb and mono mode, from both
hemispheres and at random uv; within tests/test_torch_bsdf.py's
_assert_close (>= 99.9% of lanes within rtol 1e-4 / atol 1e-5, every
lane within 100x). bumpmap's central difference (eps 5e-4) divides an
f32 rounding difference of two texture reads by 1e-3: its lanes are held
to the same flags on >= 99% of them, and within rtol 1e-5 / atol 1e-6 on
>= 99%, rtol 1e-2 on the others that sampled alike. A lane within eps of
a checker edge has a nearly tangent normal, whose hemisphere rounding
decides, and a sample there may be valid in one package and void in the
other (2 of the 4 096 lanes). Gradients of
mask.opacity and blend.weight through eval_ and pdf against the JAX
package's (its dispatch with each family on its own rows,
tests/test_torch_veach.py::_own_rows_dispatch) and central differences.
tests/test_normalmap.py's three cases, ported.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mitsuba2_tpu as mi
from mitsuba2_tpu.render import bsdf as JB
from mitsuba2_tpu.render import spectra as jspectra, texture as jtex
from mitsuba2_tpu.core.vec import Vec2 as JVec2, Vec3 as JVec3

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.core.vec import Vec2
from mitsuba2_tpu_torch.render import bsdf as B
from mitsuba2_tpu_torch.render import spectra, texture as tex
from mitsuba2_tpu_torch.scene import presets as tpresets

from test_torch_bsdf import _StandIn, _assert_close, _pack, _si_j, _si_t, _v3t
from test_torch_veach import _own_rows_dispatch

N = 4096
RNG_TEX = np.random.default_rng(31)
CHECKER = {"type": "checkerboard", "color0": [0.1, 0.3, 0.2],
           "color1": [0.9, 0.7, 0.8], "to_uv": np.diag([4.0, 4.0, 1.0])}
NORMALS = {"type": "bitmap", "data": np.concatenate([
    RNG_TEX.uniform(0.2, 0.8, (9, 11, 2)), np.ones((9, 11, 1))],
    -1).astype(np.float32)}
RAMP = {"type": "bitmap", "data": np.linspace(0, 1, 24, dtype=np.float32)[
    None].repeat(16, 0) + RNG_TEX.uniform(0, 0.2, (16, 24)).astype(
        np.float32)}
DESCS = [
    {"type": "null"},
    {"type": "mask", "opacity": 0.3, "bsdf": {"type": "diffuse"}},
    {"type": "mask", "opacity": CHECKER, "bsdf": {
        "type": "roughconductor", "material": "Au", "alpha": 0.2}},
    {"type": "twosided", "bsdf": {"type": "mask", "opacity": [0.2, 0.5, 0.8],
                                  "bsdf": {"type": "plastic"}}},
    {"type": "blendbsdf", "weight": 0.35, "bsdfs": [
        {"type": "diffuse", "reflectance": [0.3, 0.55, 0.7]},
        {"type": "roughconductor", "material": "Cu", "alpha": 0.15}]},
    {"type": "blend", "weight": 0.7, "bsdf_0": {"type": "conductor"},
     "bsdf_1": {"type": "roughdielectric", "alpha": 0.3}},
    {"type": "normalmap", "normalmap": [0.6, 0.45, 0.9],
     "bsdf": {"type": "roughplastic", "alpha": 0.25}},
    {"type": "normalmap", "normalmap": NORMALS, "bsdf": {
        "type": "diffuse", "reflectance": CHECKER}},
    {"type": "bumpmap", "scale": 0.5, "bumpmap": RAMP, "bsdf": {
        "type": "diffuse"}},
    {"type": "bumpmap", "scale": 0.3, "bumpmap": CHECKER, "bsdf": {
        "type": "roughconductor", "alpha": {
            "type": "bitmap", "data": RNG_TEX.uniform(0.05, 0.5, (6, 6))}}},
    {"type": "diffuse", "reflectance": [0.5, 0.4, 0.3]},
    {"type": "dielectric"},
]
# built, never dispatched: a wrapper under a wrapper (the JAX package's
# dispatch runs the leaf families alone on a wrapper's child)
NESTED = [{"type": "mask", "opacity": 0.4, "bsdf": {
    "type": "blendbsdf", "weight": 0.5, "bsdfs": [
        {"type": "normalmap", "bsdf": {"type": "twosided"}},
        {"type": "null"}]}}]


def _build(pkg, descs):
    """Both packages' rows of `descs` in one build's staging, and the
    atlas of its textures (tables of the JAX package's, built by each)."""
    mats, rows = [], []
    if pkg == "jax":
        jspectra.begin_texture_staging()
        try:
            rows = [JB.build_material(d, mats) for d in descs]
        finally:
            staged = jspectra.end_texture_staging()
        atlas = jtex.pack_atlas(staged)
        # the flag the JAX package's scene build sets where a roughness
        # is textured (its _alpha_tex reads the texture only then)
        alpha = any(m[2][JB.ALPHA_SLOT + 7] != 0 for m in mats)
        return mats, rows, atlas and atlas.replace(any_alpha_tex=alpha)
    with spectra.texture_staging() as staged:
        rows = [B.build_material(d, mats) for d in descs]
    tabs = tex.pack_atlas(staged)
    return mats, rows, tabs and tex.atlas_from_numpy(tabs, "cpu")


@pytest.fixture(scope="module")
def tables():
    mats_j, rows_j, atlas_j = _build("jax", DESCS)
    mats_t, rows_t, atlas_t = _build("torch", DESCS)
    rng = np.random.default_rng(32)
    d = rng.normal(size=(N, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    wo = rng.normal(size=(N, 3))
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    # each lane a top-level row (wrappers three times as often as leaves)
    tops = np.asarray(rows_t)
    weight = np.where(np.asarray([mats_t[r][0] for r in tops]) >= 8, 3.0, 1.0)
    idx = rng.choice(tops, N, p=weight / weight.sum()).astype(np.int32)
    return dict(mats_j=mats_j, mats_t=mats_t, rows=rows_t, atlas_j=atlas_j,
                atlas_t=atlas_t, wi=d.astype(np.float32),
                wo=wo.astype(np.float32),
                u=rng.uniform(size=(N, 3)).astype(np.float32),
                uv=rng.uniform(-0.5, 1.5, (N, 2)).astype(np.float32),
                idx=idx)


def test_build_material_rows_and_flags_byte_equal(tables):
    """DESCS and NESTED: types, flags (a wrapper's the union of its
    children's lobes, twosided apart) and rows byte-equal, the staged
    textures' atlas too."""
    assert tables["rows"] == _build("jax", DESCS)[1]
    for descs in (DESCS, NESTED):
        mats_j, _, atlas_j = _build("jax", descs)
        mats_t, _, atlas_t = _build("torch", descs)
        assert [(t, f) for t, f, _ in mats_t] == [(t, f) for t, f, _ in mats_j]
        for (_, _, rt), (_, _, rj) in zip(mats_t, mats_j):
            assert rt.tobytes() == rj.tobytes()
        if atlas_j is not None:
            for k in ("data", "info", "uvt", "mips"):
                assert (np.asarray(getattr(atlas_j, k)).tobytes()
                        == getattr(atlas_t, k).numpy().tobytes()), k
    mats_t = tables["mats_t"]
    assert {m[0] for m in mats_t} >= {B.NULL_BSDF, B.MASK, B.BLEND,
                                      B.NORMALMAP, B.BUMPMAP}
    mask = mats_t[tables["rows"][2]]
    child = mats_t[int(mask[2][30])]
    assert mask[1] == B.F_NULL | child[1]
    assert mats_t[tables["rows"][3]][1] & B.F_TWOSIDED_FLAG


def _run(tables, mode, pkg):
    """sample, then eval_ and pdf at the random wo, through each package's
    dispatch, at the lanes' uv with the atlas."""
    wi, idx, u, wo, uv = (tables[k] for k in ("wi", "idx", "u", "wo", "uv"))
    if pkg == "jax":
        scene = _StandIn(tables["mats_j"], jnp)
        si = _si_j(wi, idx).replace(
            uv=JVec2(jnp.asarray(uv[:, 0]), jnp.asarray(uv[:, 1])),
            tex=tables["atlas_j"])
        cfg = mi.RenderConfig(color_mode=mode)
        args = (jnp.asarray(u[:, 0]), (jnp.asarray(u[:, 1]),
                                       jnp.asarray(u[:, 2])))
        wo_ = JVec3.from_array(jnp.asarray(wo))
        lib = JB
    else:
        scene = _StandIn(tables["mats_t"], torch)
        si = dataclasses.replace(_si_t(wi, idx),
                                 uv=Vec2(torch.from_numpy(uv[:, 0]),
                                         torch.from_numpy(uv[:, 1])),
                                 tex=tables["atlas_t"])
        cfg = mt.RenderConfig(color_mode=mode)
        t = torch.from_numpy(u)
        args = (t[:, 0], (t[:, 1], t[:, 2]))
        wo_ = _v3t(wo)
        lib = B
    bs, w = lib.sample(scene, si, *args, cfg)
    f = lib.eval_(scene, si, wo_, cfg)
    p = lib.pdf(scene, si, wo_, cfg)
    return _pack(bs.wo.x, bs.wo.y, bs.wo.z, bs.pdf, bs.eta, bs.sampled_flags,
                 w.ch, f.ch, p)


@pytest.fixture(scope="module")
def refs(tables):
    return {mode: _run(tables, mode, "jax") for mode in ("rgb", "mono")}


@pytest.mark.parametrize("mode", ["rgb", "mono"])
def test_wrappers_match_jax(tables, refs, mode):
    out_t, out_j = _run(tables, mode, "torch"), refs[mode]
    mats = tables["mats_t"]
    fam = np.asarray([mats[i][0] for i in tables["idx"]])
    bump = fam == B.BUMPMAP
    np.testing.assert_array_equal(out_t["flags"][~bump], out_j["flags"][~bump])
    same = out_t["flags"][bump] == out_j["flags"][bump]
    assert same.mean() >= 0.99
    for k in ("wo", "pdf", "eta", "weight", "eval", "eval_pdf"):
        _assert_close(out_t[k][~bump], out_j[k][~bump], k)
        a, b = (o[k][bump].reshape(same.size, -1) for o in (out_t, out_j))
        close = np.isclose(a, b, rtol=1e-5, atol=1e-6).all(-1)
        assert close.mean() >= 0.99, (k, close.mean())
        np.testing.assert_allclose(a[same], b[same], rtol=1e-2, atol=1e-5,
                                   err_msg=k)
    # every wrapper samples, and mask's null lobe and null pass straight
    for f in (B.NULL_BSDF, B.MASK, B.BLEND, B.NORMALMAP, B.BUMPMAP):
        assert (out_t["flags"][fam == f] != 0).mean() > 0.3, f
    through = (out_t["flags"] & B.F_NULL) != 0
    np.testing.assert_allclose(out_t["wo"][through], -tables["wi"][through],
                               atol=1e-7)
    assert set(np.unique(fam[through])) == {B.NULL_BSDF, B.MASK}


class _Replace:
    """A stand-in scene with another mat_data."""

    def __init__(self, scene, mat_data):
        self.__dict__.update(scene.__dict__)
        self.mat_data = mat_data


def _grad_fn(lib, scene, si, wo, cfg):
    """sum of eval_ and pdf over the lanes, linear in opacity and weight."""
    def f(mat_data):
        sc = _Replace(scene, mat_data)
        val = lib.eval_(sc, si, wo, cfg)
        return sum(c.sum() for c in val.ch) + lib.pdf(sc, si, wo, cfg).sum()
    return f


# masks and blends over smooth leaves: the JAX package's gradients of
# families with microfacet lobes are NaN in whole columns (its one-hot
# gather adjoint; tests/test_torch_veach.py), the opacity slots among them
GRAD_DESCS = [
    {"type": "mask", "opacity": 0.3, "bsdf": {"type": "diffuse"}},
    {"type": "mask", "opacity": [0.2, 0.5, 0.8], "bsdf": {
        "type": "plastic", "diffuse_reflectance": [0.6, 0.3, 0.2]}},
    {"type": "blendbsdf", "weight": 0.35, "bsdfs": [
        {"type": "diffuse", "reflectance": [0.3, 0.55, 0.7]},
        {"type": "plastic"}]},
    {"type": "blendbsdf", "weight": 0.8, "bsdfs": [
        {"type": "diffuse"}, {"type": "diffuse", "reflectance": 0.9}]},
]


def test_wrapper_gradients_match_jax_and_finite_differences(tables):
    """d(sum eval_ + sum pdf)/d(mat_data) in the opacity slots of the mask
    rows and the weight column of the blend rows, on GRAD_DESCS' rows at
    the lanes' directions: the port's against the JAX package's (each
    family on its own rows) within 1e-4 relative, and against central
    differences within 1e-3 (eval_ and pdf are linear in both)."""
    mats_t, rows, _ = _build("torch", GRAD_DESCS)
    mats_j = _build("jax", GRAD_DESCS)[0]
    wi, wo = tables["wi"], tables["wo"]
    idx = np.asarray(rows, np.int32)[np.arange(N) % len(rows)]
    entries = ([(r, c) for r, m in enumerate(mats_t) if m[0] == B.MASK
                for c in range(16, 19)]
               + [(r, 29) for r, m in enumerate(mats_t) if m[0] == B.BLEND])
    rws, cols = (np.asarray(v) for v in zip(*entries))
    # the port
    scene_t = _StandIn(mats_t, torch)
    f_t = _grad_fn(B, scene_t, _si_t(wi, idx), _v3t(wo), mt.RenderConfig())
    md = scene_t.mat_data.clone().requires_grad_(True)
    f_t(md).backward()
    g_t = md.grad.numpy()[rws, cols]
    # the JAX package, its leaves on their own rows
    scene_j = _StandIn(mats_j, jnp)
    with pytest.MonkeyPatch.context() as mp:
        for name, fn in zip(("_sample_leaf", "_eval_leaf", "_pdf_leaf"),
                            _own_rows_dispatch(JB, jnp)):
            mp.setattr(JB, name, fn)
        g_j = np.asarray(jax.grad(_grad_fn(
            JB, scene_j, _si_j(wi, idx), JVec3.from_array(jnp.asarray(wo)),
            mi.RenderConfig()))(scene_j.mat_data))[rws, cols]
    assert np.isfinite(g_t).all() and np.isfinite(g_j).all()
    assert np.abs(g_t).min() > 0
    np.testing.assert_allclose(g_t, g_j, rtol=1e-4)
    eps = 1e-2
    fd = []
    with torch.no_grad():
        for r, c in zip(rws, cols):
            vals = []
            for s in (eps, -eps):
                m = scene_t.mat_data.clone()
                m[r, c] += s
                vals.append(float(f_t(m)))
            fd.append((vals[0] - vals[1]) / (2 * eps))
    np.testing.assert_allclose(g_t, fd, rtol=1e-3)


# ---------------------------------------------------------------------------
# tests/test_normalmap.py, ported
# ---------------------------------------------------------------------------

CFG = dict(width=16, height=16, spp=32, spp_per_pass=32, max_depth=2)
BASE = {"type": "diffuse", "reflectance": [0.7, 0.7, 0.7]}


def _plane(bsdf, light_dir=(0.6, 0, -0.8)):
    T = tpresets.Transform4
    cam = T.look_at(origin=[0, 0, 3], target=[0, 0, 0], up=[0, 1, 0])
    return tpresets.build_scene(
        [tpresets.shapes.rectangle(bsdf=bsdf)],
        {"type": "perspective", "to_world": np.asarray(cam.matrix),
         "fov": 30.0},
        emitters=[{"type": "directional", "direction": list(light_dir),
                   "irradiance": [1.0] * 3}], device="cpu")


def _render(bsdf):
    return mt.render(_plane(bsdf), mt.RenderConfig(**CFG),
                     device="cpu").numpy()


def test_flat_normalmap_is_identity():
    np.testing.assert_allclose(
        _render({"type": "normalmap", "normalmap": [0.5, 0.5, 1.0],
                 "bsdf": BASE}), _render(BASE), atol=1e-5)


def test_tilted_normalmap_changes_shading():
    """A normal tilted toward the light brightens the plane by the ratio
    of the cosines (0.982 / 0.8)."""
    plain = _render(BASE)
    enc = (np.array([-0.45, 0.0, 0.89]) + 1) / 2
    tilted = _render({"type": "normalmap", "normalmap": enc.tolist(),
                      "bsdf": BASE})
    np.testing.assert_allclose(tilted[8, 8].mean() / plain[8, 8].mean(),
                               0.982 / 0.8, rtol=0.05)


def test_bumpmap_checker_creates_variation():
    """A ramp height tilts the normals; a constant height changes nothing."""
    ramp = np.linspace(0, 1, 32, dtype=np.float32)[None, :].repeat(32, 0)
    bumped = _render({"type": "bumpmap", "scale": 0.2, "bumpmap": {
        "type": "bitmap", "data": ramp}, "bsdf": BASE})
    flat = _render({"type": "bumpmap", "scale": 0.2, "bumpmap": 0.5,
                    "bsdf": BASE})
    np.testing.assert_allclose(flat[8, 8], _render(BASE)[8, 8], atol=1e-5)
    assert abs(bumped[8, 8].mean() - flat[8, 8].mean()) > 0.005
