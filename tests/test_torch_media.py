"""Participating media in the PyTorch port against the JAX package: the
.vol codec (core/io_vol.py), medium packing, the density grid's lookup
and the Henyey-Greenstein phase function (render/media.py), the media
tables of the scene build and their carriage through scene_from_numpy,
and the thin-lens camera (render/sensors.py).

Tolerances: host tables byte-equal; the grid lookup, the phase function
and the camera rays per lane within rtol 1e-6 (atol 1e-6 where a value
crosses zero: sines and cosines round otherwise in XLA and in torch);
the HG sampler's chi^2 at the harness' 1% level.
"""
import numpy as np
import pytest
import torch

from mitsuba2_tpu.core import io_vol as jio
from mitsuba2_tpu.render import media as jmedia
from mitsuba2_tpu.render import sensors as jsensors
from mitsuba2_tpu.scene import presets as jpresets
from mitsuba2_tpu.scene import shapes as jshapes
from mitsuba2_tpu.scene.scene import build_scene as jbuild
import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch import chi2
from mitsuba2_tpu_torch.core import io_vol
from mitsuba2_tpu_torch.core.vec import Vec2, Vec3
from mitsuba2_tpu_torch.render import media, sensors
from mitsuba2_tpu_torch.scene import scene as scene_mod
from mitsuba2_tpu_torch.scene import shapes as tshapes

import chip_smoke
from test_torch_instancing import assert_port_tables, recorded_fields

# one intra-op thread: the suite's test processes share the cores
# (pytest-xdist), and torch's OpenMP regions stall when they
# oversubscribe them
torch.set_num_threads(1)

N = 4096


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _jv3(a):
    import jax.numpy as jnp
    from mitsuba2_tpu.core.vec import Vec3 as JVec3
    return JVec3(*jnp.asarray(np.asarray(a, np.float32).T))


# ---------------------------------------------------------------------------
# .vol files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("encoding,channels", [("float32", 1),
                                               ("float16", 1),
                                               ("uint8", 1),
                                               ("float32", 3)])
def test_vol_round_trip_matches_jax(tmp_path, encoding, channels):
    rng = np.random.default_rng(1)
    shape = (3, 4, 5) + ((channels,) if channels > 1 else ())
    data = rng.uniform(0, 1, shape).astype(np.float32)
    path = str(tmp_path / "grid.vol")
    io_vol.write_vol(path, data, (-1, -2, -3), (1, 2, 3), encoding)
    jpath = str(tmp_path / "grid_jax.vol")
    jio.write_vol(jpath, data, (-1, -2, -3), (1, 2, 3), encoding)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    got, want = io_vol.read_vol(path), jio.read_vol(path)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[0].shape == shape
    tol = {"float32": 0, "float16": 1e-3, "uint8": 0.5 / 255 + 1e-7}
    np.testing.assert_allclose(got[0], data, rtol=0, atol=tol[encoding])
    np.testing.assert_array_equal(got[1], [-1, -2, -3])


@pytest.mark.parametrize("raw,what", [(b"VXL\x03", "magic"),
                                      (b"VOL\x02", "version")])
def test_vol_bad_header_raises_as_jax(tmp_path, raw, what):
    path = str(tmp_path / "bad.vol")
    with open(path, "wb") as f:
        f.write(raw + bytes(44))
    for read in (io_vol.read_vol, jio.read_vol):
        with pytest.raises(ValueError, match=what):
            read(path)


# ---------------------------------------------------------------------------
# Medium packing and the grid
# ---------------------------------------------------------------------------

def _descriptors(tmp_path):
    rng = np.random.default_rng(2)
    grid = rng.uniform(0, 2, (3, 4, 5)).astype(np.float32)
    path = str(tmp_path / "dens.vol")
    io_vol.write_vol(path, grid, (-1, 0, -1), (1, 2, 1))
    path3 = str(tmp_path / "dens3.vol")
    io_vol.write_vol(path3, rng.uniform(0, 1, (2, 3, 4, 3)), (0, 0, 0),
                     (1, 1, 1), "float16")
    return {
        "scalar": {"type": "homogeneous", "sigma_t": 1.5, "albedo": 0.3,
                   "g": 0.4},
        "rgb": {"sigma_t": [0.2, 1.0, 3.0], "albedo": [0.9, 0.5, 0.1]},
        "sigma_s_a": {"sigma_s": [0.5, 1.0, 0.0], "sigma_a": 0.25,
                      "scale": 2.0},
        "tabulated": {"sigma_t": {"type": "regular", "lambda_min": 400,
                                  "lambda_max": 700,
                                  "values": [0.1, 0.5, 2.0, 1.0]},
                      "albedo": 0.8},
        "grid": {"type": "heterogeneous", "density": grid, "sigma_t": 2.0,
                 "bbox_min": [-1, -1, -1], "bbox_max": [1, 1, 1]},
        "constant": {"type": "heterogeneous", "density": 0.7},
        "vol_file": {"type": "heterogeneous", "filename": path,
                     "albedo": 0.5},
        "vol_file_rgb": {"type": "heterogeneous", "density": path3,
                         "bbox_min": [0, 0, -1]},
    }


def test_pack_medium_matches_jax(tmp_path):
    for name, desc in _descriptors(tmp_path).items():
        mtype, row, grid = media.pack_medium(desc)
        jtype, jrow, jgrid = jmedia.pack_medium(desc)
        assert mtype == jtype and row.dtype == jrow.dtype, name
        assert np.array_equal(row, jrow), name
        assert (grid is None) == (jgrid is None), name
        if grid is not None:
            for k in ("density", "bbox_min", "bbox_max"):
                assert grid[k].dtype == jgrid[k].dtype, (name, k)
                assert np.array_equal(grid[k], jgrid[k]), (name, k)
    with pytest.raises(ValueError, match="density"):
        media.pack_medium({"type": "heterogeneous"})
    with pytest.raises(ValueError, match="unknown medium"):
        media.pack_medium({"type": "fog"})


def test_grid_eval_matches_jax():
    """Trilinear lookups on 4 096 points, a quarter of them outside the
    box (0 there)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    data = rng.uniform(0, 3, (5, 6, 7)).astype(np.float32)
    lo, hi = np.float32([-1, 0, -0.5]), np.float32([1, 2, 0.5])
    p = rng.uniform(lo - 0.25 * (hi - lo), hi + 0.25 * (hi - lo), (N, 3))
    p[: N // 8] = lo + (hi - lo) * rng.integers(0, 2, (N // 8, 3))  # corners
    gj = jmedia.GridVolume(data=jnp.asarray(data), bbox_min=jnp.asarray(lo),
                           bbox_max=jnp.asarray(hi))
    gt = media.GridVolume(_t(data), _t(lo), _t(hi))
    want = np.asarray(gj.eval(_jv3(p)))
    got = gt.eval(Vec3(*_t(p).unbind(1))).numpy()
    inside = ((p >= lo) & (p <= hi)).all(1)
    assert 0.25 < inside.mean() < 0.75 and (got[~inside] == 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_grid_eval_gradient_reaches_the_voxels():
    """d(sum of lookups)/d(data): the trilinear weights, scattered back
    through spectra.lane_gather."""
    rng = np.random.default_rng(4)
    data = _t(rng.uniform(0, 1, (3, 3, 3))).requires_grad_(True)
    g = media.GridVolume(data, _t([0, 0, 0]), _t([1, 1, 1]))
    p = _t(rng.uniform(0, 1, (256, 3)))
    g.eval(Vec3(*p.unbind(1))).sum().backward()
    assert abs(float(data.grad.sum()) - 256.0) < 1e-3


# ---------------------------------------------------------------------------
# Henyey-Greenstein
# ---------------------------------------------------------------------------

def _hg_lanes():
    rng = np.random.default_rng(5)
    g = rng.choice([0.0, 0.3, -0.5, 0.9, 1e-5], N).astype(np.float32)
    wi = rng.normal(size=(N, 3))
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    u = rng.uniform(size=(N, 2)).astype(np.float32)
    return g, wi.astype(np.float32), u


def test_hg_eval_and_sample_match_jax():
    import jax.numpy as jnp
    g, wi, u = _hg_lanes()
    wo_j, pdf_j = jmedia.phase_hg_sample(jnp.asarray(g), _jv3(wi),
                                         (jnp.asarray(u[:, 0]),
                                          jnp.asarray(u[:, 1])))
    wo_t, pdf_t = media.phase_hg_sample(_t(g), Vec3(*_t(wi).unbind(1)),
                                        (_t(u[:, 0]), _t(u[:, 1])))
    np.testing.assert_allclose(pdf_t.numpy(), np.asarray(pdf_j), rtol=1e-6)
    for c in "xyz":
        np.testing.assert_allclose(getattr(wo_t, c).numpy(),
                                   np.asarray(getattr(wo_j, c)), rtol=1e-6,
                                   atol=1e-6)
    # the phase value on the same directions (the sampled ones differ in
    # the last bits, which a peaked lobe (g 0.9) magnifies)
    wo = np.stack([np.asarray(getattr(wo_j, c)) for c in "xyz"], -1)
    val_j = jmedia.phase_eval(jnp.asarray(g), _jv3(wi), _jv3(wo))
    val_t = media.phase_eval(_t(g), Vec3(*_t(wi).unbind(1)),
                             Vec3(*_t(wo).unbind(1)))
    np.testing.assert_allclose(val_t.numpy(), np.asarray(val_j), rtol=1e-6)
    # the sampler's pdf is the phase value at its own direction (where g
    # is above the sampler's clamp)
    big = np.abs(g) >= 1e-4
    np.testing.assert_allclose(media.phase_eval(
        _t(g), Vec3(*_t(wi).unbind(1)), wo_t).numpy()[big],
        pdf_t.numpy()[big], rtol=1e-4)


@pytest.mark.parametrize("g", [0.0, 0.6, -0.3])
def test_hg_sampler_chi2(g):
    wi = Vec3(*_t([0.3, -0.4, np.sqrt(0.75)]).unbind(0))

    def lanes(n, v):
        return torch.full((n,), v)

    def sample_fn(u):
        n = u.shape[0]
        wo, _ = media.phase_hg_sample(
            lanes(n, g), Vec3(lanes(n, float(wi.x)), lanes(n, float(wi.y)),
                              lanes(n, float(wi.z))), (u[:, 0], u[:, 1]))
        return wo

    def pdf_fn(d):
        flat = d.reshape(-1, 3)
        n = flat.shape[0]
        val = media.phase_eval(
            lanes(n, g), Vec3(lanes(n, float(wi.x)), lanes(n, float(wi.y)),
                              lanes(n, float(wi.z))), Vec3(*flat.unbind(1)))
        return val.reshape(d.shape[:-1])

    t = chi2.ChiSquareTest(chi2.SphericalDomain(), sample_fn, pdf_fn,
                           sample_count=200_000, res=16, ires=4)
    assert t.run(), "\n".join(t.messages)


# ---------------------------------------------------------------------------
# The scene build and scene_from_numpy
# ---------------------------------------------------------------------------

def _vol_slab(P, build, tmp_path, **kw):
    """A slab whose grid is read from a .vol file (its header's box)."""
    path = str(tmp_path / "slab.vol")
    rng = np.random.default_rng(6)
    io_vol.write_vol(path, rng.uniform(0, 2, (4, 5, 6)), (-2, -2, -0.5),
                     (2, 2, 0.5))
    shape = P.cube(bsdf={"type": "null"}, id="vol")
    shape.interior = {"type": "heterogeneous", "filename": path,
                      "sigma_t": 0.5, "albedo": [0.7, 0.6, 0.5], "g": 0.2}
    light = P.rectangle(emitter={"type": "area", "radiance": [1.0] * 3})
    sensor = {"type": "thinlens", "to_world": np.eye(4), "fov": 30.0,
              "aperture_radius": 0.1, "focus_distance": 3.0}
    return build([shape, light], sensor, **kw)


SCENES = {
    "smoke_box": (lambda P, b, **kw: P.smoke_box(8, **kw), None),
    "kitchen_sink": (lambda P, b, **kw: P.kitchen_sink(**kw), None),
    "slab_homogeneous": ("presets", dict(sigma=0.6)),
    "slab_heterogeneous": ("presets", dict(
        sigma=0.8, grid=np.full((4, 8, 8), 1.0, np.float32))),
    "slab_vol_file": ("vol", None),
    "gallery_fog": (lambda P, b, **kw: chip_smoke.gallery_fog(
        jpresets if P is jpresets else _port_presets(), 1, **kw), None),
}


def _port_presets():
    from mitsuba2_tpu_torch.scene import presets as tpresets
    return tpresets


def _build(name, pkg, tmp_path):
    mk, kw = SCENES[name]
    dev = {} if pkg == "jax" else {"device": "cpu"}
    P = jpresets if pkg == "jax" else mt
    shapes_, build = ((jshapes, jbuild) if pkg == "jax"
                      else (tshapes, mt.build_scene))
    if mk == "presets":
        from mitsuba2_tpu_torch.scene import presets as tpresets
        return chip_smoke.medium_slab(jpresets if pkg == "jax" else tpresets,
                                      **kw, **dev)
    if mk == "vol":
        return _vol_slab(shapes_, build, tmp_path, **dev)
    return mk(P, build, **dev)


def jax_fields(sj):
    """A JAX scene's tables as numpy, with its envmap's, atlas', density
    grid's and measured BSDFs', and the sensor type."""
    from mitsuba2_tpu_torch.render import emitters as em
    out = {**{k: np.asarray(getattr(sj, k)) for k in scene_mod.FIELDS},
           "param_paths": sj.param_paths, "cam_type": sj.cam_type}
    if sj.envmap is not None:
        from mitsuba2_tpu_torch.core import distr
        out["envmap"] = {k: None if v is None else np.asarray(v) for k, v in (
            (k, getattr(sj.envmap.distr, k) if k in distr.FIELDS
             else getattr(sj.envmap, k)) for k in em.ENV_FIELDS)}
    if sj.textures is not None:
        out["textures"] = {k: np.asarray(getattr(sj.textures, k))
                           for k in ("data", "info", "uvt")}
    if sj.medium_grid is not None:
        out["medium_grid"] = {k: np.asarray(getattr(sj.medium_grid, k))
                              for k in ("data", "bbox_min", "bbox_max")}
    if sj.measured is not None:
        from mitsuba2_tpu_torch.render.measured import TABLES
        out["measured"] = {k: None if getattr(sj.measured, k) is None
                           else np.asarray(getattr(sj.measured, k))
                           for k in TABLES}
    return out


@pytest.mark.parametrize("name", sorted(SCENES))
def test_media_tables_byte_equal(tmp_path, name):
    sj = _build(name, "jax", tmp_path)
    with recorded_fields() as got:
        st = _build(name, "port", tmp_path)
    fields = got[0]
    assert_port_tables({k: np.asarray(getattr(sj, k))
                        for k in scene_mod.FIELDS}, fields, st)
    assert fields["param_paths"] == sj.param_paths
    assert st.has_media == sj.has_media is True
    assert st.cam_type == sj.cam_type
    assert (st.medium_grid is None) == (sj.medium_grid is None)
    if sj.medium_grid is not None:
        for k in ("data", "bbox_min", "bbox_max"):
            a = np.asarray(getattr(sj.medium_grid, k))
            assert np.array_equal(fields["medium_grid"][k], a), k
            assert np.array_equal(getattr(st.medium_grid, k).numpy(), a), k

    # the JAX build carried across is the port's own build
    conv = mt.scene_from_numpy(jax_fields(sj), device="cpu")
    for f in scene_mod.SceneData.__dataclass_fields__:
        a, b = getattr(conv, f), getattr(st, f)
        if torch.is_tensor(a):
            assert a.dtype == b.dtype and torch.equal(a, b), f
        elif f == "medium_grid":
            assert (a is None) == (b is None)
            if a is not None:
                assert all(torch.equal(getattr(a, k), getattr(b, k))
                           for k in ("data", "bbox_min", "bbox_max"))
        elif f not in ("envmap", "textures"):
            assert a == b, f
    if sj.medium_grid is not None:
        with pytest.raises(KeyError, match="medium_grid"):
            mt.scene_from_numpy({**jax_fields(sj), "medium_grid": None},
                                device="cpu")


def test_media_inside_shapegroups_refused():
    """As the JAX build, whichever side of the flatten cap."""
    cube = tshapes.cube(bsdf={"type": "null"})
    cube.interior = {"type": "homogeneous"}
    inst = tshapes.instance(tshapes.shapegroup([cube]), np.eye(4))
    sensor = {"type": "perspective", "to_world": np.eye(4), "fov": 45.0}
    with pytest.raises(ValueError, match="interior media"):
        mt.build_scene([inst], sensor, device="cpu")


# ---------------------------------------------------------------------------
# The thin-lens camera
# ---------------------------------------------------------------------------

def test_thinlens_rays_match_jax():
    """sample_ray and sample_ray_differential on kitchen_sink's thin lens,
    per lane; the offset rays share the main ray's aperture sample."""
    import jax.numpy as jnp
    from mitsuba2_tpu.core.vec import Vec2 as JVec2
    sj, st = jpresets.kitchen_sink(), mt.kitchen_sink(device="cpu")
    assert st.cam_type == "thinlens"
    assert "thinlens" in sensors.NEEDS_APERTURE_SAMPLE
    rng = np.random.default_rng(7)
    u = rng.uniform(size=(4, N)).astype(np.float32)
    rj = jsensors.sample_ray_differential(
        sj, JVec2(jnp.asarray(u[0]), jnp.asarray(u[1])),
        (jnp.asarray(u[2]), jnp.asarray(u[3])), 32)
    rt = sensors.sample_ray_differential(
        st, Vec2(_t(u[0]), _t(u[1])), 32, u_lens=(_t(u[2]), _t(u[3])))
    for f in ("o", "d", "o_x", "d_x", "o_y", "d_y"):
        for c in "xyz":
            np.testing.assert_allclose(
                getattr(getattr(rt, f), c).numpy(),
                np.asarray(getattr(getattr(rj, f), c)), rtol=1e-6,
                atol=1e-6, err_msg=f + c)
    plain = sensors.sample_ray(st, Vec2(_t(u[0]), _t(u[1])),
                               u_lens=(_t(u[2]), _t(u[3])))
    assert torch.equal(plain.o.x, rt.o.x) and torch.equal(plain.d.z, rt.d.z)
    # the origins spread over the aperture disk about the camera's position
    r = torch.sqrt((rt.o.x - 0.3) ** 2 + (rt.o.y - 0.4) ** 2
                   + (rt.o.z + 3.4) ** 2)
    assert float(r.max()) <= 0.06 + 1e-6 and float(r.mean()) > 0.03
    # the orthographic camera, beside it, keeps its aperture slots empty
    ortho = mt.build_scene([tshapes.rectangle()], {
        "type": "orthographic", "to_world": np.eye(4)}, device="cpu")
    assert ortho.cam_type == "orthographic" and not ortho.cam_data[:2].any()
