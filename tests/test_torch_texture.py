"""Textures of config 4 in the PyTorch port against the JAX package: the
atlas with its mip pyramid, texture lookups with and without ray
differentials, textured slots, the textured area light and projector,
and texture gradients.

Byte-equal: the atlas (the padded texels, info, uvt) and the pyramid the
port rebuilds on its side, the builds' slot kinds and param_paths (with
their "image" entries). Per lane: eval_rgb for each wrap and filter mode,
with and without a footprint, its texel indices and mip levels
(>= 99.9% equal: a lane whose u * w - 0.5 or log2 of its footprint
lands on an integer may round to the other side, XLA's fused arithmetic
against torch's), and values by tests/test_torch_emitters.py's
_close_lanes (>= 99.9% of lanes within rtol 1e-5 / atol 1e-6, every lane
within rtol 1e-3); sample_ray_differential and the uv partials; textured
slots in rgb, mono and spectral mode; the textured area light's and
projector's samples. tests/test_texture.py's seven cases and
tests/test_ray_differentials.py's five, ported.

The slice as a whole: chip_smoke.gallery_textured (subdiv 1, 32 x 32
floor texture) at 16x16, 4 spp, depth 3 against the JAX package's render
in rgb and spectral mode, and its render_l2_grad against the JAX
package's under tests/test_torch_veach.py::_own_rows_dispatch, from
tests/goldens/gallery_textured.npz (tests/goldens/make_gallery_textured.py
writes it: the JAX package compiles each of these for minutes); and
central differences on a floor-albedo texel and a roughness texel.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import mitsuba2_tpu as mi
from mitsuba2_tpu.core import spectrum as jsp
from mitsuba2_tpu.core.vec import Vec2 as JVec2, Vec3 as JVec3
from mitsuba2_tpu.render import emitters as jem, sensors as jsensors
from mitsuba2_tpu.render import spectra as jspectra, texture as jtex
from mitsuba2_tpu.scene import presets as jpresets
from mitsuba2_tpu.scene import scene as jscene

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.core import spectrum as tsp
from mitsuba2_tpu_torch.core.vec import Vec2, Vec3
from mitsuba2_tpu_torch.diff import adjoint
from mitsuba2_tpu_torch.render import emitters as em, sensors, spectra
from mitsuba2_tpu_torch.render import texture as tex
from mitsuba2_tpu_torch.scene import presets as tpresets
from mitsuba2_tpu_torch.scene import scene as scene_mod

from test_torch_emitters import _close_lanes
from test_torch_veach import _rel

N = 4096
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "gallery_textured.npz")
GALLERY = dict(width=16, height=16, spp=4, spp_per_pass=4, max_depth=3,
               rr_depth=8)


def _t(a, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(a, dtype))


def _np_spec(s):
    return np.stack([np.asarray(c) for c in s.ch], -1)


# ---------------------------------------------------------------------------
# the atlas
# ---------------------------------------------------------------------------

ROT_UV = np.array([[1.5, 0.3, 0.1], [-0.2, 2.0, 0.05], [0, 0, 1]], np.float32)
# one texture of each wrap and filter mode, of odd and even sizes, and a
# checkerboard; (wrap, filter) -> their ids
TEXTURES = [
    dict(type="bitmap", size=(13, 7), wrap_mode="repeat",
         filter_type="bilinear", to_uv=ROT_UV),
    dict(type="bitmap", size=(16, 16), wrap_mode="clamp"),
    dict(type="bitmap", size=(5, 9), wrap_mode="mirror",
         filter_type="nearest"),
    dict(type="checkerboard", color0=[0.1, 0.7, 0.2], color1=0.9,
         to_uv=np.diag([3.0, 3.0, 1.0])),
    dict(type="bitmap", size=(32, 20), filter_type="nearest"),
    dict(type="bitmap", size=(8, 8, 1), wrap_mode="mirror"),
    dict(type="bitmap", size=(3, 4), wrap_mode="clamp",
         filter_type="nearest"),
]
MODES = {("repeat", "bilinear"): [0], ("clamp", "bilinear"): [1],
         ("mirror", "nearest"): [2], ("repeat", "nearest"): [3, 4],
         ("mirror", "bilinear"): [5], ("clamp", "nearest"): [6]}


def _descs():
    rng = np.random.default_rng(21)
    out = []
    for d in TEXTURES:
        d = dict(d)
        if "size" in d:
            d["data"] = rng.uniform(0.0, 2.0, d.pop("size")).astype(
                np.float32)
        out.append(d)
    return out


@pytest.fixture(scope="module")
def atlases():
    descs = _descs()
    atlas_j = jtex.pack_atlas([jtex.build_texture(d) for d in descs])
    tabs = tex.pack_atlas([tex.build_texture(d) for d in descs])
    return atlas_j, tex.atlas_from_numpy(tabs, "cpu"), tabs


def test_atlas_tables_byte_equal(atlases):
    """The padded texels, info and uvt (the host packing) and the pyramid
    the port builds with torch, byte for byte, and its geometry."""
    atlas_j, atlas_t, tabs = atlases
    for k in tex.TEX_FIELDS:
        a, b = np.asarray(getattr(atlas_j, k)), tabs[k]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
        assert getattr(atlas_t, k).numpy().tobytes() == a.tobytes(), k
    assert np.asarray(atlas_j.mips).tobytes() == atlas_t.mips.numpy().tobytes()
    assert atlas_j.level_shapes == atlas_t.level_shapes
    assert atlas_j.level_offsets == atlas_t.level_offsets
    assert tex.mip_level_geometry(13, 7) == jtex.mip_level_geometry(13, 7)
    assert (tex._uv_transform({"to_uv": ROT_UV}).tobytes()
            == jtex._uv_transform({"to_uv": ROT_UV}).tobytes())


def test_build_mips_gradients_match_jax(atlases):
    """The pyramid's derivative: d(sum of w * mips)/d(texels), random w."""
    atlas_j, atlas_t, _ = atlases
    w = np.random.default_rng(3).normal(size=atlas_t.mips.shape).astype(
        np.float32)
    g_j = jax.grad(lambda d: jnp.sum(jtex.build_mips(d, atlas_j.info) * w))(
        atlas_j.data)
    d = atlas_t.data.clone().requires_grad_(True)
    (tex.build_mips(d, atlas_t.info) * _t(w)).sum().backward()
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(g_j), rtol=1e-5,
                               atol=1e-6)


def test_profiler_ranges_named_in_chip_smoke():
    """chip_smoke.py drops the device-side rows of these ranges from its
    kernel times (they span kernels) and reads the kernels inside them."""
    assert chip_smoke.RANGES[1:] == (tex.TEXTURE_RANGE,
                                     tex.TEXEL_BACKWARD_RANGE)


def test_wrap_coord_matches_jax():
    """Integer wraps at negative and far indices: torch.remainder and
    jnp.remainder both floor."""
    i, n, w = np.meshgrid(np.arange(-41, 42), np.arange(1, 8), np.arange(3),
                          indexing="ij")
    i, n, w = (a.ravel() for a in (i, n, w))
    got = tex._wrap_coord(_t(i), _t(n), _t(w)).numpy()
    want = np.asarray(jtex._wrap_coord(jnp.asarray(i, jnp.int32),
                                       jnp.asarray(n, jnp.int32),
                                       jnp.asarray(w, jnp.int32)))
    assert np.array_equal(got, want)
    assert (got >= 0).all() and (got < n).all()


def _lanes(ids, seed):
    """Lanes over textures `ids`: uv in [-1.5, 2.5] (every wrap at work;
    a sixteenth on texel centres and edges of 8 x 8), footprints of 1e-4
    to 2 in uv, as log-uniform lengths in random directions."""
    rng = np.random.default_rng(seed)
    tid = rng.choice(ids, N).astype(np.int32)
    uv = rng.uniform(-1.5, 2.5, (N, 2)).astype(np.float32)
    k = N // 16
    uv[:k] = rng.integers(-8, 17, (k, 2)) / 8.0
    mag = np.exp(rng.uniform(np.log(1e-4), np.log(2.0), (2, N)))
    ang = rng.uniform(0, 2 * np.pi, (2, N))
    duv = np.stack([mag * np.cos(ang), mag * np.sin(ang)], -1).astype(
        np.float32)
    return tid, uv, duv


def _eval_both(atlases, tid, uv, duv):
    atlas_j, atlas_t, _ = atlases
    d_j = d_t = None
    if duv is not None:
        d_j = tuple(JVec2(jnp.asarray(duv[i, :, 0]), jnp.asarray(duv[i, :, 1]))
                    for i in range(2))
        d_t = tuple(Vec2(_t(duv[i, :, 0]), _t(duv[i, :, 1])) for i in range(2))
    want = _np_spec(jtex.eval_rgb(atlas_j, jnp.asarray(tid),
                                  JVec2(jnp.asarray(uv[:, 0]),
                                        jnp.asarray(uv[:, 1])), duv=d_j))
    got = _np_spec(tex.eval_rgb(atlas_t, _t(tid), Vec2(_t(uv[:, 0]),
                                                       _t(uv[:, 1])),
                                duv=d_t))
    return got, want


@pytest.mark.parametrize("footprint", [False, True])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_eval_rgb_matches_jax(atlases, mode, footprint):
    tid, uv, duv = _lanes(MODES[mode], seed=len(MODES[mode]) + sum(
        map(len, mode)))
    got, want = _eval_both(atlases, tid, uv, duv if footprint else None)
    _close_lanes(got, want, f"{mode} footprint={footprint}")


def test_texel_indices_and_levels_match_jax(atlases):
    """The corner texel of each bilinear lookup, the nearest texel and the
    mip level, each computed from the lane's uv by either package's
    arithmetic: equal on >= 99.9% of lanes."""
    atlas_j, atlas_t, _ = atlases
    tid, uv, duv = _lanes(list(range(len(TEXTURES))), seed=5)
    info, uvt = atlas_t.info.numpy()[tid], atlas_t.uvt.numpy()[tid]
    h, w = info[:, 0], info[:, 1]

    def idx(lib, f):
        floor_at = torch.clamp_min if lib is torch else jnp.maximum
        a = [f(c) for c in uvt.T]
        x, y = f(uv[:, 0]), f(uv[:, 1])
        u = a[0] * x + a[1] * y + a[2]
        v = a[3] * x + a[4] * y + a[5]
        hh, ww = f(h), f(w)
        d = [(f(duv[i, :, 0]), f(duv[i, :, 1])) for i in range(2)]
        rho = lib.maximum(*[lib.sqrt(((a[0] * dx + a[1] * dy) * ww) ** 2
                                     + ((a[3] * dx + a[4] * dy) * hh) ** 2)
                            for dx, dy in d])
        return [np.asarray(lib.floor(t)) for t in (
            u * ww - 0.5, v * hh - 0.5, u * ww, v * hh,
            lib.log2(floor_at(rho, 1e-8)))]

    got = idx(torch, _t)
    want = idx(jnp, jnp.asarray)
    for name, a, b in zip(("x0", "y0", "xn", "yn", "lod"), got, want):
        assert (a == b).mean() >= 0.999, name
        assert (np.abs(a - b) <= 1).all(), name


# ---------------------------------------------------------------------------
# tests/test_texture.py, ported
# ---------------------------------------------------------------------------

def _one(data, wrap="repeat", filt="bilinear"):
    return tex.atlas_from_numpy(tex.pack_atlas([tex.build_texture(
        {"type": "bitmap", "data": data, "wrap_mode": wrap,
         "filter_type": filt})]), "cpu")


def _rgb(atlas, uv):
    uv = np.asarray(uv, np.float32)
    n = uv.shape[0]
    return _np_spec(tex.eval_rgb(atlas, torch.zeros(n, dtype=torch.int64),
                                 Vec2(_t(uv[:, 0]), _t(uv[:, 1]))))


def test_bilinear_matches_numpy():
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(7, 5, 3)).astype(np.float32)
    atlas = _one(img, wrap="clamp")
    ys, xs = np.meshgrid(np.arange(7), np.arange(5), indexing="ij")
    uv = np.stack([(xs.ravel() + 0.5) / 5, (ys.ravel() + 0.5) / 7], -1)
    np.testing.assert_allclose(_rgb(atlas, uv), img.reshape(-1, 3), rtol=1e-5)
    np.testing.assert_allclose(_rgb(atlas, [[1.0 / 5, 0.5 / 7]])[0],
                               (img[0, 0] + img[0, 1]) / 2, rtol=1e-5)


def test_wrap_modes():
    img = np.repeat(np.arange(4, dtype=np.float32).reshape(1, 4, 1), 3, -1)
    uv = [[1.125, 0.5]]   # past the right edge
    assert _rgb(_one(img, "repeat", "nearest"), uv)[0, 0] == 0.0
    assert _rgb(_one(img, "clamp", "nearest"), uv)[0, 0] == 3.0
    assert _rgb(_one(img, "mirror", "nearest"), uv)[0, 0] == 3.0


def test_checkerboard_quadrants():
    atlas = tex.atlas_from_numpy(tex.pack_atlas([tex.build_texture(
        {"type": "checkerboard", "color0": [1, 0, 0],
         "color1": [0, 1, 0]})]), "cpu")
    out = _rgb(atlas, [[0.25, 0.25], [0.75, 0.25], [0.25, 0.75],
                       [0.75, 0.75]])
    np.testing.assert_allclose(out[[0, 3]], [[1, 0, 0]] * 2)
    np.testing.assert_allclose(out[[1, 2]], [[0, 1, 0]] * 2)


def _plane(bsdf, P=tpresets, **kw):
    """tests/test_texture.py's camera on +z over a z = 0 rectangle under a
    constant environment, in the presets module P's package."""
    cam = P.Transform4.look_at(origin=[0, 0, 3], target=[0, 0, 0],
                               up=[0, 1, 0])
    sensor = {"type": "perspective", "to_world": np.asarray(cam.matrix),
              "fov": 45.0}
    return P.build_scene([P.shapes.rectangle(bsdf=bsdf)], sensor, emitters=[
        {"type": "constant", "radiance": [1.0, 1.0, 1.0]}], **kw)


def test_textured_render_shows_texture():
    scene = _plane({"type": "diffuse", "reflectance": {
        "type": "checkerboard", "color0": [0.9, 0.1, 0.1],
        "color1": [0.1, 0.9, 0.1]}}, device="cpu")
    img = mt.render(scene, mt.RenderConfig(width=32, height=32, spp=16,
                                           spp_per_pass=16, max_depth=2),
                    device="cpu").numpy()
    assert img[16, 16].max() > 0.05
    assert (img[..., 0] > img[..., 1] * 2).any()
    assert (img[..., 1] > img[..., 0] * 2).any()


def test_texel_gradients_flow():
    scene = _plane({"type": "diffuse", "reflectance": {
        "type": "bitmap", "data": np.full((4, 4, 3), 0.5, np.float32)}},
        device="cpu")
    data = scene.textures.data.clone().requires_grad_(True)
    img = mt.render(adjoint.with_tables(scene, {
        **adjoint.diff_tables(scene), "tex_data": data}),
        mt.RenderConfig(width=8, height=8, spp=4, spp_per_pass=4,
                        max_depth=2), device="cpu")
    img.mean().backward()
    g = data.grad.numpy()
    assert np.isfinite(g).all() and (g > 0).any()


def test_spectral_textured_matches_rgb_roughly():
    scene = _plane({"type": "diffuse", "reflectance": {
        "type": "checkerboard", "color0": [0.8, 0.3, 0.2],
        "color1": [0.2, 0.3, 0.8]}}, device="cpu")
    cfg = mt.RenderConfig(width=16, height=16, spp=32, spp_per_pass=32,
                          max_depth=2)
    img_rgb = mt.render(scene, cfg, device="cpu").numpy()
    img_spec = mt.render(scene, cfg.replace(color_mode="spectral"),
                         device="cpu").numpy()
    mask = img_rgb.max(-1) > 0.05
    assert np.abs(img_spec - img_rgb)[mask].mean() < 0.08


def _rough_plate(alpha, P=tpresets, **kw):
    """tests/test_texture.py's rough aluminium plate under a small light."""
    T = P.Transform4
    rect = P.shapes.rectangle(bsdf={"type": "roughconductor", "alpha": alpha,
                                    "material": "Al"})
    light = P.shapes.rectangle(
        bsdf={"type": "diffuse", "reflectance": [0, 0, 0]},
        emitter={"type": "area", "radiance": [8, 8, 8]}).transformed(
        np.asarray((T.translate([0.9, 0.9, 1.6]) @ T.rotate([1, 0, 0], 180.0)
                    @ T.scale([0.15, 0.15, 1.0])).matrix))
    cam = T.look_at(origin=[0, 0, 3], target=[0, 0, 0], up=[0, 1, 0])
    return P.build_scene([rect, light], {
        "type": "perspective", "to_world": np.asarray(cam.matrix),
        "fov": 35.0}, **kw)


def test_textured_roughness_checkerboard():
    """A checkerboard roughness renders every pixel as the uniform
    roughness of its cell does (same seed, same rays)."""
    cfg = mt.RenderConfig(width=32, height=32, spp=16, max_depth=2, seed=7)
    checker = {"type": "checkerboard", "color0": [0.04] * 3,
               "color1": [0.45] * 3}
    a, b, c = (mt.render(_rough_plate(x, device="cpu"), cfg,
                         device="cpu").numpy() for x in (checker, 0.04, 0.45))
    close_b = np.isclose(a, b, rtol=1e-4, atol=1e-5).all(-1)
    close_c = np.isclose(a, c, rtol=1e-4, atol=1e-5).all(-1)
    assert (close_b | close_c).all()
    assert close_b.any() and close_c.any()
    assert not np.allclose(b, c)


# ---------------------------------------------------------------------------
# ray differentials (tests/test_ray_differentials.py, ported, and against
# the JAX package)
# ---------------------------------------------------------------------------

def _checker_floor(P=tpresets, reps=24.0, **kw):
    """A long checkerboard floor seen at a grazing angle."""
    v = np.asarray([[-8, 0, -1], [8, 0, -1], [8, 0, 31], [-8, 0, 31]],
                   np.float32)
    f = np.asarray([[0, 2, 1], [0, 3, 2]], np.int32)
    uvs = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    checker = {"type": "checkerboard", "color0": [0.05] * 3,
               "color1": [0.95] * 3,
               "to_uv": np.diag([reps, reps, 1.0]).astype(np.float32)}
    floor = P.shapes.mesh(v, f, uvs=uvs, bsdf={
        "type": "diffuse", "reflectance": checker}, id="floor")
    cam = P.Transform4.look_at(origin=[0, 0.7, -0.5], target=[0, 0.0, 8.0],
                               up=[0, 1, 0])
    return P.build_scene([floor], {
        "type": "perspective", "to_world": np.asarray(cam.matrix),
        "fov": 45.0}, emitters=[{"type": "constant", "radiance": [1.0] * 3}],
        **kw)


@pytest.fixture(scope="module")
def floors():
    return _checker_floor(jpresets), _checker_floor(device="cpu")


def _dd(rd, a):
    off = getattr(rd, a)
    return torch.sqrt((off.x - rd.d.x) ** 2 + (off.y - rd.d.y) ** 2
                      + (off.z - rd.d.z) ** 2)


def test_sample_ray_differential_offsets(floors):
    scene = floors[1]
    n = 16
    uv = Vec2(torch.linspace(0.2, 0.8, n), torch.full((n,), 0.5))
    rd = sensors.sample_ray_differential(scene, uv, 64)
    dd = _dd(rd, "d_x")
    assert float(dd.min()) > 1e-4 and float(dd.max()) < 0.1
    np.testing.assert_allclose(_dd(rd.scale_differential(0.5), "d_x"),
                               0.5 * dd, rtol=1e-5)


def test_uv_partials_scale_with_distance(floors):
    scene = floors[1]
    n = 8
    uv = Vec2(torch.full((n,), 0.5), torch.linspace(0.45, 0.95, n))
    si = scene_mod.ray_intersect(scene, sensors.sample_ray_differential(
        scene, uv, 64))
    mag = torch.sqrt(si.duv_dx.x ** 2 + si.duv_dx.y ** 2).numpy()
    assert bool(si.valid.all()) and mag[0] > 4 * mag[-1], mag


def test_mip_pyramid_averages():
    img = np.random.default_rng(0).random((64, 64, 3)).astype(np.float32)
    atlas = _one(img)
    np.testing.assert_allclose(atlas.mips[atlas.level_offsets[-1]:][0],
                               img.mean((0, 1)), rtol=1e-5)
    uvq = Vec2(torch.tensor([0.1, 0.3, 0.6, 0.9]),
               torch.tensor([0.2, 0.5, 0.7, 0.9]))
    big = Vec2(torch.full((4,), 4.0), torch.zeros(4))
    out = tex.eval_rgb(atlas, torch.zeros(4, dtype=torch.int64), uvq,
                       duv=(big, big))
    for c in range(3):
        np.testing.assert_allclose(out.ch[c], img.mean((0, 1))[c], rtol=1e-3)


def test_checkerboard_glancing_alias_reduction(floors):
    """With differentials the far floor converges to the checker's mean;
    point sampling (no pyramid) aliases."""
    scene = _checker_floor(reps=48.0, device="cpu")
    cfg = mt.RenderConfig(width=64, height=64, spp=1, spp_per_pass=1,
                          max_depth=2, seed=0)
    img_f = mt.render(scene, cfg, device="cpu").numpy()
    point = dataclasses.replace(scene, textures=dataclasses.replace(
        scene.textures, mips=None))
    img_p = mt.render(point, cfg, device="cpu").numpy()
    far_f, far_p = img_f[30:40, :, 0].ravel(), img_p[30:40, :, 0].ravel()
    assert far_p.mean() > 1e-3
    assert (np.abs(far_f - far_f.mean()).mean()
            < 0.5 * np.abs(far_p - far_p.mean()).mean())


def test_texture_grads_flow_through_mips():
    img = np.random.default_rng(1).random((16, 16, 3)).astype(np.float32)
    atlas = _one(img)
    uvq = Vec2(torch.tensor([0.4]), torch.tensor([0.6]))
    duv = (Vec2(torch.tensor([0.2]), torch.tensor([0.0])),
           Vec2(torch.tensor([0.0]), torch.tensor([0.2])))

    def f(data):
        return tex.eval_rgb(atlas.with_data(data),
                            torch.zeros(1, dtype=torch.int64), uvq,
                            duv=duv).ch[0][0]

    data = atlas.data.clone().requires_grad_(True)
    f(data).backward()
    g = data.grad
    assert float(g.abs().sum()) > 0
    gi = np.unravel_index(int(g.abs().argmax()), g.shape)
    eps = 1e-2
    with torch.no_grad():
        dp, dm = atlas.data.clone(), atlas.data.clone()
        dp[gi] += eps
        dm[gi] -= eps
        fd = (f(dp) - f(dm)) / (2 * eps)
    np.testing.assert_allclose(float(g[gi]), float(fd), rtol=2e-2)


def test_ray_differentials_and_uv_partials_match_jax(floors):
    """sample_ray_differential on a film grid, its scale by 1/sqrt(spp)
    and the uv partials of the hits, against the JAX package's."""
    sj, st = floors
    g = (np.arange(24) + 0.5) / 24
    u, v = (a.ravel().astype(np.float32) for a in np.meshgrid(g, g))
    rj = jsensors.sample_ray_differential(sj, JVec2(jnp.asarray(u),
                                                    jnp.asarray(v)), None,
                                          film_width=24)
    rt = sensors.sample_ray_differential(st, Vec2(_t(u), _t(v)), 24)
    amount = float(np.float32(1.0) / np.sqrt(np.float32(16)))
    rj, rt = rj.scale_differential(1.0 / jnp.sqrt(jnp.float32(16))), \
        rt.scale_differential(amount)
    for a in ("o", "d", "o_x", "o_y", "d_x", "d_y"):
        for c in "xyz":
            _close_lanes(getattr(getattr(rt, a), c),
                         getattr(getattr(rj, a), c), f"{a}.{c}")
    si_j = jscene.ray_intersect(sj, rj)
    si_t = scene_mod.ray_intersect(st, rt)
    assert np.array_equal(si_t.valid.numpy(), np.asarray(si_j.valid))
    assert si_t.valid.float().mean() > 0.3
    for a in ("duv_dx", "duv_dy"):
        for c in "xy":
            _close_lanes(getattr(getattr(si_t, a), c),
                         getattr(getattr(si_j, a), c), f"{a}.{c}")


# ---------------------------------------------------------------------------
# textured slots and emitters
# ---------------------------------------------------------------------------

def _slots(illum_ids=(1, 3)):
    """Slots of both packages over the TEXTURES: each texture as a
    reflectance and as an illuminant slot, and a constant of each kind."""
    descs = _descs()
    rows_j, rows_t = [], []
    jspectra.begin_texture_staging()
    try:
        for i, d in enumerate(descs):
            rows_j.append(jspectra.pack_color(d, illuminant=i in illum_ids))
        rows_j.append(jspectra.pack_color([0.3, 0.6, 0.2]))
        rows_j.append(jspectra.pack_color([4.0, 2.0, 1.0], illuminant=True))
    finally:
        jspectra.end_texture_staging()
    with spectra.texture_staging():
        for i, d in enumerate(descs):
            rows_t.append(spectra.pack_color(d, illuminant=i in illum_ids))
        rows_t.append(spectra.pack_color([0.3, 0.6, 0.2]))
        rows_t.append(spectra.pack_color([4.0, 2.0, 1.0], illuminant=True))
    return np.stack(rows_j), np.stack(rows_t)


@pytest.mark.parametrize("mode", ["rgb", "mono", "spectral"])
def test_textured_slots_match_jax(atlases, mode):
    """pack_color of textures (kinds 2 + 2 id + illuminant bit, the mean
    in the RGB columns) byte-equal; eval_spectrum_slot of every slot at
    random uv with footprints, per lane, at hero wavelengths in spectral
    mode (the lattice upsampling of the texel RGB)."""
    atlas_j, atlas_t, _ = atlases
    rows_j, rows_t = _slots()
    assert rows_j.tobytes() == rows_t.tobytes()
    assert (rows_t[:len(TEXTURES), 7] == 2 + 2 * np.arange(len(TEXTURES))
            + np.isin(np.arange(len(TEXTURES)), (1, 3))).all()
    _, uv, duv = _lanes([0], seed=9)
    rng = np.random.default_rng(10)
    idx = rng.integers(0, rows_t.shape[0], N).astype(np.int32)
    u_wl = rng.uniform(size=N).astype(np.float32)
    wl_j = jsp.sample_hero_wavelengths_t(jnp.asarray(u_wl))[0]
    wl_t = tsp.sample_hero_wavelengths_t(_t(u_wl))[0]
    want = _np_spec(jspectra.eval_spectrum_slot(
        jspectra.LaneRows(jnp.asarray(rows_j), jnp.asarray(idx)), wl_j, mode,
        tex=atlas_j, uv=JVec2(jnp.asarray(uv[:, 0]), jnp.asarray(uv[:, 1])),
        duv=tuple(JVec2(jnp.asarray(duv[i, :, 0]), jnp.asarray(duv[i, :, 1]))
                  for i in range(2))))
    got = _np_spec(spectra.eval_spectrum_slot(
        spectra.LaneRows(_t(rows_t), _t(idx).long()), wl_t, mode,
        tex=atlas_t, uv=Vec2(_t(uv[:, 0]), _t(uv[:, 1])),
        duv=tuple(Vec2(_t(duv[i, :, 0]), _t(duv[i, :, 1]))
                  for i in range(2))))
    _close_lanes(got, want, mode, share=0.99 if mode == "spectral" else 0.999)


def _emitter_scene(P, **kw):
    """A diffuse floor under a textured area light (a 6 x 5 radiance on
    a rectangle) and a textured projector (a 7 x 9 slide), in P's
    package."""
    rng = np.random.default_rng(12)
    T = P.Transform4
    light = P.shapes.rectangle(
        bsdf={"type": "diffuse", "reflectance": [0, 0, 0]},
        emitter={"type": "area", "radiance": {
            "type": "bitmap", "data": rng.uniform(1, 6, (6, 5, 3)).astype(
                np.float32)}}).transformed(np.asarray(
                    (T.translate([0.0, 1.5, 0.0])
                     @ T.rotate([1, 0, 0], 90.0)
                     @ T.scale([0.6, 0.6, 1.0])).matrix))
    floor = P.shapes.rectangle(bsdf={"type": "diffuse"}).transformed(
        np.asarray((T.rotate([1, 0, 0], -90.0) @ T.scale([3, 3, 1])).matrix))
    proj = {"type": "projector", "position": [0.2, 2.5, -0.3],
            "direction": [-0.05, -1.0, 0.1], "fov": 80.0, "irradiance": {
                "type": "bitmap", "data": rng.uniform(0, 3, (7, 9, 3)).astype(
                    np.float32), "wrap_mode": "clamp"}}
    # below the light, which faces down
    cam = T.look_at(origin=[0, 0.8, -3.5], target=[0, 1.3, 0], up=[0, 1, 0])
    return P.build_scene([floor, light], {
        "type": "perspective", "to_world": np.asarray(cam.matrix),
        "fov": 45.0}, emitters=[proj], **kw)


@pytest.mark.parametrize("mode", ["rgb", "spectral"])
def test_textured_area_light_and_projector_match_jax(mode):
    """sample_direction per lane from points over the floor, each lane
    picking the projector or the light: direction, distance, pdf, delta
    and value; and the light's radiance where camera rays hit it."""
    sj, st = _emitter_scene(jpresets), _emitter_scene(tpresets, device="cpu")
    rng = np.random.default_rng(13)
    p = np.stack([rng.uniform(-2, 2, N), rng.uniform(-0.05, 0.3, N),
                  rng.uniform(-2, 2, N)], -1).astype(np.float32)
    u = rng.uniform(size=(3, N)).astype(np.float32)
    wl_j = jsp.sample_hero_wavelengths_t(jnp.asarray(u[0]))[0]
    wl_t = tsp.sample_hero_wavelengths_t(_t(u[0]))[0]
    cfg_j, cfg_t = (lib.RenderConfig(color_mode=mode) for lib in (mi, mt))
    ds_j, v_j = jem.sample_direction(
        sj, JVec3.from_array(jnp.asarray(p)), wl_j, jnp.asarray(u[0]),
        (jnp.asarray(u[1]), jnp.asarray(u[2])), cfg_j)
    ds_t, v_t = em.sample_direction(
        st, Vec3(*_t(p).unbind(1)), wl_t, _t(u[0]), (_t(u[1]), _t(u[2])),
        cfg_t)
    assert np.array_equal(ds_t.delta.numpy(), np.asarray(ds_j.delta))
    assert 0.2 < ds_t.delta.float().mean() < 0.8
    for c in "xyz":
        _close_lanes(getattr(ds_t.d, c), getattr(ds_j.d, c), f"d.{c}")
    _close_lanes(ds_t.dist, ds_j.dist, "dist")
    _close_lanes(ds_t.pdf, ds_j.pdf, "pdf")
    share = 0.99 if mode == "spectral" else 0.999
    _close_lanes(_np_spec(v_t), _np_spec(v_j), "value", share=share)
    lit = _np_spec(v_t).max(-1) > 0
    assert lit[ds_t.delta.numpy()].mean() > 0.3
    assert lit[~ds_t.delta.numpy()].mean() > 0.5
    # the light seen from the camera (eval_hit at the hits' uv)
    cfg = dict(width=12, height=12, spp=1, spp_per_pass=1, max_depth=1,
               color_mode=mode)
    img_j = np.asarray(mi.render(sj, mi.RenderConfig(**cfg), seed=3))
    img_t = mt.render(st, mt.RenderConfig(**cfg), seed=3,
                      device="cpu").numpy()
    assert (img_t.max(-1) > 1).sum() > 4
    _close_lanes(img_t, img_j, "eval_hit", share=share)


# ---------------------------------------------------------------------------
# the textured gallery (config 4): the build, renders and gradients
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gallery():
    return (chip_smoke.gallery_textured(jpresets, 1, 32),
            chip_smoke.gallery_textured(tpresets, 1, 32, device="cpu"))


@pytest.fixture(scope="module")
def golden():
    ref = dict(np.load(GOLDEN))
    cfg = json.loads(str(ref.pop("config")))
    assert cfg == dict(subdiv=1, res=32, render=GALLERY, seed=0)
    return ref


def test_gallery_build_matches_jax(gallery):
    """Slot kinds, rows, the atlas (six textures padded to 32 x 32) and
    its pyramid byte-equal; param_paths equal, with an "image" entry a
    texture, which traverse and scene_with read and write (the pyramid
    rebuilt from the new texels, byte-equal to the JAX package's)."""
    sj, st = gallery
    for k in ("mat_type", "mat_flags", "mat_data", "emitter_type",
              "emitter_data"):
        assert np.asarray(getattr(sj, k)).tobytes() == \
            getattr(st, k).numpy().tobytes(), k
    for k in ("data", "info", "uvt", "mips"):
        assert np.asarray(getattr(sj.textures, k)).tobytes() == \
            getattr(st.textures, k).numpy().tobytes(), k
    # the lookups the port makes: the floor's albedo, the back wall's
    # roughness, the maps' slot 2, the light's and the slide's
    assert sj.textures.any_alpha_tex
    assert {f: sorted(k) for f, k in st.family_tex if k} == {
        0: [0], 2: [4], 11: [2], 12: [2]}
    assert st.emitter_tex == (em.AREA, em.PROJECTOR)
    assert st.param_paths == tuple(sj.param_paths)
    images = [p for p in st.param_paths if p[5] == "image"]
    assert [p[0] for p in images] == [
        "floor_albedo.data", "back_roughness.data", "left_height.data",
        "right_normals.data", "slide.data", "light_radiance.data"]
    pm = mt.traverse(st)
    assert torch.equal(pm["slide.data"], st.textures.data[4])
    new = torch.full((32, 32, 3), 0.25)
    s2 = mt.scene_with(st, {"floor_albedo.data": new})
    j2 = mi.scene_with(sj, {"floor_albedo.data": jnp.asarray(new.numpy())})
    assert torch.equal(s2.textures.data[0], new)
    assert np.asarray(j2.textures.mips).tobytes() == \
        s2.textures.mips.numpy().tobytes()
    assert torch.equal(st.textures.data[0], pm["floor_albedo.data"])


def test_static_gates_change_nothing(gallery):
    """The lookups and child dispatches the port skips by its scene's
    static metadata (slots no row of a family textures, emitter types
    with no textured row, a wrapper column's absent child families, the
    atlas' absent wrap modes and filters) are the ones whose values the
    JAX package computes and discards: with every gate open, the render
    and its gradients are bit for bit the same."""
    from mitsuba2_tpu_torch.render import bsdf as B
    st = gallery[1]
    everything = frozenset({0, 1, 2, B.ALPHA_SLOT // 8})
    leaves = frozenset(B.LEAF_FAMILIES)
    open_ = dataclasses.replace(
        st, family_tex=tuple((f, everything) for f in st.mat_families),
        emitter_tex=(em.AREA, em.PROJECTOR),
        wrapper_children=tuple((k, leaves) for k, _ in st.wrapper_children),
        textures=dataclasses.replace(st.textures, wraps=(0, 1, 2),
                                     filters=(0, 1)))
    cfg = mt.RenderConfig(width=8, height=8, spp=2, spp_per_pass=2,
                          max_depth=3, rr_depth=8)
    outs = [mt.render_l2_grad(sc, cfg, torch.zeros(8, 8, 3), seed=4,
                              device="cpu") for sc in (st, open_)]
    assert torch.equal(outs[0][0], outs[1][0])
    for k, g in outs[0][2].items():
        torch.testing.assert_close(g, outs[1][2][k], rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("mode", ["rgb", "spectral"])
def test_gallery_render_matches_jax(gallery, golden, mode):
    """The textured gallery's render against the JAX package's: >= 99% of
    pixels within rtol 1e-3 / atol 1e-4 (phase 4's limits), means within
    1e-3."""
    img = mt.render(gallery[1], mt.RenderConfig(**GALLERY, color_mode=mode),
                    seed=0, device="cpu").numpy()
    ref = golden[f"image_{mode}"]
    assert np.isfinite(img).all() and img.mean() > 0.05
    assert np.isclose(img, ref, rtol=1e-3, atol=1e-4).all(-1).mean() >= 0.99
    assert abs(img.mean() - ref.mean()) <= 1e-3 * ref.mean()


@pytest.fixture(scope="module")
def port_grads(gallery):
    return mt.render_l2_grad(gallery[1], mt.RenderConfig(**GALLERY),
                             torch.zeros(16, 16, 3), seed=0, device="cpu")


def test_gallery_l2_grad_matches_jax(port_grads, golden):
    """render_l2_grad against the JAX package's under the own-rows
    dispatch: the image and loss; tex_data, mat_data and emitter_data
    within 1e-3 in relative norm over the entries the JAX package leaves
    finite; every port entry finite, every texture reached. The JAX
    package's are NaN in the back wall's roughness texture, the bump
    map's height and 168 of the normal map's 192 entries, mat_data's cols
    16-18 and 29 and emitter_data's cols 8-15 (the projector's position,
    direction and frustum): a NaN derivative on a lane its selects
    discard (a microfacet lobe at 0, a slide read far off the frustum)
    times the zero cotangent, which its one-hot gather adjoint spreads
    over the column (tests/test_torch_veach.py)."""
    img, loss, grads = port_grads
    assert np.isclose(img.numpy(), golden["grad_image"], rtol=1e-3,
                      atol=1e-4).all(-1).mean() >= 0.99
    np.testing.assert_allclose(float(loss), float(golden["grad_loss"]),
                               rtol=1e-3)
    for k in ("tex_data", "mat_data", "emitter_data"):
        g, ref = grads[k].numpy(), golden[f"grad_{k}"]
        fin = np.isfinite(ref)
        assert g.shape == ref.shape and np.isfinite(g).all(), k
        assert fin.mean() >= 0.5, k
        if ref[fin].any():
            assert _rel(g[fin], ref[fin]) <= 1e-3, k
        else:   # emitter_data: both emitters' slots are textures
            assert not g[fin].any(), k
    fin = np.isfinite(golden["grad_tex_data"]).all((1, 2, 3))
    assert fin.tolist() == [True, False, False, False, True, True]
    reached = np.abs(grads["tex_data"].numpy()).reshape(6, -1).max(1)
    assert (reached > 0).all(), reached


def _fd_texel(scene, cfg, t, y, x, eps):
    """Central difference of render_l2_grad's loss in one texel's three
    channels together (the same seed: the same paths)."""
    losses = []
    for s in (eps, -eps):
        data = scene.textures.data.clone()
        data[t, y, x] += s
        sc = adjoint.with_tables(scene, {**adjoint.diff_tables(scene),
                                         "tex_data": data})
        img = mt.render(sc, cfg, seed=0, device="cpu")
        losses.append(float(torch.mean(img.double() ** 2)))
    return (losses[0] - losses[1]) / (2 * eps)


@pytest.mark.parametrize("texture,eps", [(0, 5e-2), (1, 2e-3)])
def test_texel_gradients_match_finite_differences(gallery, port_grads,
                                                  texture, eps):
    """The texel of the floor's albedo (texture 0) and of the back wall's
    roughness (texture 1) with the largest gradient, its three channels'
    sum against a central difference: within 5% (the roughness steers
    sampled directions, whose moved hits autograd does not follow)."""
    st = gallery[1]
    cfg = mt.RenderConfig(**GALLERY)
    g = port_grads[2]["tex_data"][texture].sum(-1)
    y, x = np.unravel_index(int(g.abs().argmax()), g.shape)
    fd = _fd_texel(st, cfg, texture, y, x, eps)
    assert abs(fd) > 1e-7
    np.testing.assert_allclose(float(g[y, x]), fd, rtol=0.05)
