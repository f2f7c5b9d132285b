"""Scene tables of the PyTorch port, byte-equal to the JAX package's.

Prim ids, cluster slots and plane rows can only be compared between the
packages when their tables are byte-equal, so every SceneData field the
port reads is held with np.array_equal (dtype and shape included) on a
brute-force scene, a numpy-built BVH (492 prims) and a native-built one
(1932 prims, above the 512-prim switch to the C++ builder)."""
import dataclasses

import numpy as np
import pytest
import torch

from mitsuba2_tpu.scene import presets as jpresets
import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch import convert
from mitsuba2_tpu_torch.render import bsdf as bsdf_mod
from mitsuba2_tpu_torch.scene.scene import FIELDS, SceneData

from test_torch_instancing import assert_port_tables, recorded_fields

# one intra-op thread: the suite's test processes share the cores
# (pytest-xdist), and torch's OpenMP regions stall when they
# oversubscribe them
torch.set_num_threads(1)

SCENES = {
    "cornell_box": (jpresets.cornell_box, mt.cornell_box, {}),
    "mesh_gallery_1": (jpresets.mesh_gallery, mt.mesh_gallery, {"subdiv": 1}),
    "mesh_gallery_2": (jpresets.mesh_gallery, mt.mesh_gallery, {"subdiv": 2}),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def pair(request):
    mk_j, mk_t, kw = SCENES[request.param]
    sj = mk_j(**kw)
    with recorded_fields() as got:
        st = mk_t(device="cpu", **kw)
    return request.param, sj, st, got[0]


def jax_fields(sj):
    return {**{k: np.asarray(getattr(sj, k)) for k in FIELDS},
            "param_paths": sj.param_paths}


def test_tables_byte_equal(pair):
    _, sj, st, fields = pair
    assert_port_tables(jax_fields(sj), fields, st)


def test_static_metadata_equal(pair):
    _, sj, st, _ = pair
    assert st.n_prims == sj.n_prims
    assert st.cluster_k == sj.cluster_k == 128
    assert st.n_emitters == sj.n_emitters
    assert st.n_shapes == sj.n_shapes
    assert st.mat_families == sj.mat_families
    assert st.cam_type == sj.cam_type == "perspective"
    assert st.device == torch.device("cpu")


def test_scene_from_numpy_equals_own_build(pair):
    """The JAX scene's arrays carried across equal the port's own build,
    the slot-major walk table included."""
    _, sj, st, _ = pair
    conv = mt.scene_from_numpy(jax_fields(sj), device="cpu")
    for f in dataclasses.fields(SceneData):
        a, b = getattr(conv, f.name), getattr(st, f.name)
        if torch.is_tensor(a):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b, f.name


def test_cluster_feat_is_a_slot_major_copy(pair):
    """cluster_feat row s holds slot s's four plane rows of mxu_feat (the
    brute-force Cornell box uploads neither: its copy is made here)."""
    _, _, st, fields = pair
    ck = st.cluster_k
    feat = fields["mxu_feat"]                      # (16, 4*C*CK)
    cf = convert.slot_major_feat(feat, ck)         # (C*CK, 20)
    if st.cluster_feat is not None:
        assert np.array_equal(st.cluster_feat.numpy(), cf)
    rng = np.random.default_rng(0)
    for s in rng.integers(0, cf.shape[0], 64):
        c, k = divmod(int(s), ck)
        col = lambda q: feat[:, 4 * ck * c + q * ck + k]
        np.testing.assert_array_equal(cf[s, 0:3], col(0)[0:3])
        np.testing.assert_array_equal(cf[s, 3:9], col(1)[0:6])
        np.testing.assert_array_equal(cf[s, 9:15], col(2)[0:6])
        np.testing.assert_array_equal(cf[s, 15:19], col(3)[6:10])
        # the plane rows hold nothing outside the columns the walk reads
        assert not col(0)[3:].any() and not col(1)[6:].any()
        assert not col(2)[6:].any() and not col(3)[:6].any()
        assert not col(3)[10:].any()


def test_to_device_and_default_device():
    st = mt.cornell_box(device="cpu")
    assert mt.to_device(st, "cpu") is st
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        mt.cornell_box()
    with pytest.raises(RuntimeError, match="CUDA"):
        mt.to_device(st, None)


# the measured and polarized families, each with what its build needs: a
# tiny table (and Mueller table) for the measured ones
_TABLE = np.random.default_rng(12).uniform(0.0, 0.5, (4, 8, 8, 3)).astype(
    np.float32)
OPTICS_DESCS = {
    "measured": {"type": "measured", "values": _TABLE},
    "measured_polarized": {"type": "measured_polarized", "values": _TABLE,
                           "mueller": np.broadcast_to(np.eye(
                               4, dtype=np.float32), (4, 8, 8, 4, 4))},
    "polarizer": {"type": "polarizer", "theta": 30.0, "transmittance": 0.9},
    "retarder": {"type": "retarder", "theta": 15.0, "delta": 90.0},
}


@pytest.mark.parametrize("feature", ["sphere", "medium", "instance",
                                     "envmap", "texture", "plastic",
                                     "twosided", "orthographic"])
def test_unsupported_features_raise_by_name(feature, tmp_path):
    """Each feature builds, and so does each beside one of the measured and
    polarized families, which render since the polarized slice: the
    family's row, and a measured one's table, in the scene."""
    from mitsuba2_tpu_torch.scene import shapes
    from mitsuba2_tpu_torch.scene.scene import build_scene
    mesh = shapes.rectangle(bsdf={"type": "diffuse"})
    sensor = {"type": "perspective", "to_world": np.eye(4), "fov": 45.0}
    emitters = ()
    lacking = "polarizer"
    if feature == "sphere":
        mesh = shapes.sphere(bsdf={"type": "diffuse"})
    elif feature == "medium":
        # seen by a radiance meter, which renders since the sensors' slice
        mesh.interior = {"type": "homogeneous"}
        sensor["type"] = "radiancemeter"
        lacking = "measured_polarized"
    elif feature == "instance":
        metal = shapes.cube(bsdf={"type": "conductor"})
        mesh = shapes.instance(shapes.shapegroup([metal, shapes.sphere()]),
                               np.eye(4))
        lacking = "retarder"
    elif feature == "envmap":
        # read from an image file, seen by an irradiance meter
        emitters = ({"type": "envmap",
                     "filename": _bitmap_files(tmp_path)[".exr"]},)
        sensor["type"] = "irradiancemeter"
    elif feature == "texture":
        # a bitmap read from an image file, seen by the distant sensor
        mesh.bsdf = {"type": "diffuse", "reflectance": {
            "type": "bitmap", "filename": _bitmap_files(tmp_path)[".exr"]}}
        sensor["type"] = "distant"
        lacking = "retarder"
    elif feature == "plastic":
        # textured roughness read from an image file, seen by a moving
        # camera (motion blur)
        mesh.bsdf = {"type": "roughplastic", "alpha": {
            "type": "bitmap", "filename": _bitmap_files(tmp_path)[".png"]}}
        sensor["to_world_keys"] = [(0.0, np.eye(4)), (1.0, np.eye(4))]
        lacking = "measured_polarized"
    elif feature == "twosided":
        mesh.bsdf = {"type": "twosided", "bsdf": {"type": "blendbsdf"}}
        lacking = "measured"
    elif feature == "orthographic":
        sensor["type"] = "orthographic"
    st = build_scene([mesh], sensor, emitters, device="cpu")
    assert st.cam_type == sensor["type"]
    assert (st.cam_motion is not None) == ("to_world_keys" in sensor)
    other = shapes.rectangle(bsdf=OPTICS_DESCS[lacking])
    both = build_scene([mesh, other], sensor, emitters, device="cpu")
    fid = bsdf_mod._BY_NAME[lacking].id
    assert fid in both.mat_families
    measured = lacking.startswith("measured")
    assert (both.measured is not None) == measured
    if measured:
        assert (both.measured.mueller is not None) == (
            lacking == "measured_polarized")
        np.testing.assert_array_equal(both.measured.values[0].numpy(),
                                      OPTICS_DESCS[lacking]["values"])


def _bitmap_files(tmp_path):
    """One image as a float EXR and as an 8-bit PNG."""
    from mitsuba2_tpu_torch.core import io_bitmap
    img = np.random.default_rng(4).uniform(0.02, 0.98, (6, 10, 3)).astype(
        np.float32)
    paths = {ext: str(tmp_path / f"tex{ext}") for ext in (".exr", ".png")}
    io_bitmap.write_exr(paths[".exr"], img, half=False)
    io_bitmap.write(paths[".png"], img)
    return paths


@pytest.mark.parametrize("raw", [False, True])
def test_bitmap_files_build_like_jax_and_arrays(tmp_path, raw):
    """Bitmaps read from an EXR (an albedo) and a PNG (a roughness): the
    atlas, its pyramid and the material rows byte-equal to the JAX
    package's build of the same files, and to the port's build of the
    arrays the files decode to (sRGB-linearised, the EXR too, unless
    `raw` is set, as the JAX package reads them)."""
    from mitsuba2_tpu.scene import shapes as jshapes
    from mitsuba2_tpu.scene.scene import build_scene as jbuild
    from mitsuba2_tpu_torch.core import io_bitmap
    from mitsuba2_tpu_torch.scene import shapes
    files = _bitmap_files(tmp_path)

    def bsdfs(src):
        return [{"type": "diffuse", "reflectance": {
                    "type": "bitmap", **src(".exr")}},
                {"type": "roughplastic", "alpha": {
                    "type": "bitmap", "filter_type": "nearest",
                    **src(".png")}}]

    def from_file(ext):
        return {"filename": files[ext], "raw": raw}

    def from_array(ext):
        data = io_bitmap.read(files[ext])
        return {"data": data if raw else io_bitmap.srgb_to_linear(data)}
    sensor = {"type": "perspective", "to_world": np.eye(4), "fov": 45.0}
    with recorded_fields() as got:
        st = mt.build_scene([shapes.rectangle(bsdf=b)
                             for b in bsdfs(from_file)], sensor,
                            device="cpu")
        sa = mt.build_scene([shapes.rectangle(bsdf=b)
                             for b in bsdfs(from_array)], sensor,
                            device="cpu")
    sj = jbuild([jshapes.rectangle(bsdf=b) for b in bsdfs(from_file)],
                sensor)
    assert_port_tables(jax_fields(sj), got[0], st)
    for k in ("data", "info", "uvt", "mips"):
        a = getattr(st.textures, k).numpy().tobytes()
        assert a == np.asarray(getattr(sj.textures, k)).tobytes(), k
        assert a == getattr(sa.textures, k).numpy().tobytes(), k
    for k in ("mat_type", "mat_flags", "mat_data"):
        assert torch.equal(getattr(st, k), getattr(sa, k)), k


@pytest.mark.parametrize("what", ["spheres", "twosided", "textured"])
def test_scene_from_numpy_refuses_what_the_port_does_not_render(what):
    from mitsuba2_tpu.scene import shapes as jshapes
    from mitsuba2_tpu.scene.scene import build_scene as jbuild
    sensor = {"type": "perspective", "to_world": np.eye(4), "fov": 45.0}
    if what == "spheres":
        # spheres, veach_mis's rough conductors and twosided carry across
        # now: a sphere under a BSDF family the port lacks
        shape = jshapes.sphere(bsdf={"type": "null"})
    else:
        bsdf = ({"type": "twosided", "bsdf": {
                    "type": "mask", "opacity": 0.5,
                    "bsdf": {"type": "diffuse"}}}
                if what == "twosided" else
                {"type": "diffuse", "reflectance": {
                    "type": "checkerboard", "color0": [0.2] * 3,
                    "color1": [0.8] * 3}})
        shape = jshapes.rectangle(bsdf=bsdf)
    sj = jbuild([shape], sensor)
    fields = jax_fields(sj)
    if what == "textured":
        # a textured slot needs its atlas (the textures' slice)
        with pytest.raises(KeyError, match="textures"):
            mt.scene_from_numpy(fields, device="cpu")
        fields["textures"] = {k: np.asarray(getattr(sj.textures, k))
                              for k in ("data", "info", "uvt")}
    # null and mask carry across since the textures' slice
    st = mt.scene_from_numpy(fields, device="cpu")
    assert np.array_equal(st.mat_data.numpy(), fields["mat_data"])
    assert st.mat_families == tuple(sorted(set(fields["mat_type"].tolist())))
    assert (st.textures is None) == (what != "textured")


@pytest.mark.parametrize("kw,what", [
    ({"dtype": "float64"}, "float64"),
    # the polarized variants and the stokes integrator render since the
    # polarized slice: their cases render a small scene
    ({"color_mode": "spectral", "polarized": True}, "spectral"),
    ({"polarized": True}, "polarized"),
    # the filters, the depth and direct integrators render since the
    # integrator variants' slice. The cases keep the ids of the refusals
    # they replace: kw3-gaussian holds the stokes integrator's, kw4-volpath
    # an aov over stokes, kw6-direct mono's polarized variant
    pytest.param({"integrator": "stokes"}, "stokes", id="kw3-gaussian"),
    pytest.param({"integrator": "aov", "aov_child": "stokes"}, "stokes",
                 id="kw4-volpath"),
    # compact renders since the multi-process slice: its case holds a
    # double polarized variant, refused by its first feature
    pytest.param({"dtype": "float64", "polarized": True}, "float64",
                 id="kw5-compact"),
    pytest.param({"color_mode": "mono", "polarized": True}, "mono_polarized",
                 id="kw6-direct"),
])
def test_config_refuses_what_the_port_does_not_render(kw, what):
    """The _double variants raise by name; the polarized variants and the
    stokes integrator make a config that renders: the variant string,
    render_polarized's (H, W, C, 4) Stokes image, render_any's stokes
    image (an aov's child too)."""
    assert mt.RenderConfig().float_dtype is torch.float32
    if kw.get("dtype") == "float64":
        with pytest.raises(NotImplementedError, match=what):
            mt.RenderConfig(**kw)
        return
    cfg = mt.RenderConfig(width=4, height=4, spp=2, spp_per_pass=2,
                          max_depth=2, **kw)
    scene = mt.cornell_box(device="cpu")
    if cfg.polarized:
        assert what in cfg.variant and cfg.variant.endswith("_polarized")
        img = mt.render_polarized(scene, cfg, device="cpu")
        assert img.shape == (4, 4, cfg.n_image_channels, 4)
    else:
        out = mt.render_any(scene, cfg, device="cpu")
        img = out["image"] if cfg.integrator == "aov" else out
        assert img.shape == (4, 4, 4)
    assert torch.isfinite(img).all() and float(img[..., 0].mean()) > 0
