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
from mitsuba2_tpu_torch.scene.scene import FIELDS, SceneData

from test_torch_instancing import assert_port_tables, recorded_fields

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


@pytest.mark.parametrize("feature", ["sphere", "medium", "instance",
                                     "envmap", "texture", "plastic",
                                     "twosided", "orthographic"])
def test_unsupported_features_raise_by_name(feature):
    from mitsuba2_tpu_torch.scene import shapes
    from mitsuba2_tpu_torch.scene.scene import build_scene
    mesh = shapes.rectangle(bsdf={"type": "diffuse"})
    sensor = {"type": "perspective", "to_world": np.eye(4), "fov": 45.0}
    emitters = ()
    if feature == "sphere":
        # spheres render now: a sphere under a BSDF the port lacks (null,
        # the first one, renders since the textures' slice)
        mesh = shapes.sphere(bsdf={"type": "polarizer"})
    elif feature == "medium":
        mesh.interior = {"type": "homogeneous"}
    elif feature == "instance":
        # an instanced group holding a BSDF the port lacks (mask, the
        # first one, renders since the textures' slice)
        metal = shapes.cube(bsdf={"type": "retarder"})
        mesh = shapes.instance(shapes.shapegroup([metal, shapes.sphere()]),
                               np.eye(4))
    elif feature == "envmap":
        emitters = ({"type": "envmap"},)
    elif feature == "texture":
        mesh.bsdf = {"type": "diffuse",
                     "reflectance": {"type": "bitmap", "filename": "x.exr"}}
    elif feature == "plastic":
        # the plastics render now, and textured roughness since the
        # textures' slice: one read from an image file
        mesh.bsdf = {"type": "roughplastic",
                     "alpha": {"type": "bitmap", "filename": "x.exr"}}
    elif feature == "twosided":
        # twosided renders now: twosided around a BSDF the port lacks
        # (blendbsdf, the first one, renders since the textures' slice)
        mesh.bsdf = {"type": "twosided", "bsdf": {"type": "measured"}}
    elif feature == "orthographic":
        sensor["type"] = "orthographic"
    names = {"sphere": "polarizer", "medium": "media",
             "instance": "retarder", "envmap": "envmap", "texture": "bitmap",
             "plastic": "image files", "twosided": "measured",
             "orthographic": "orthographic"}
    with pytest.raises(NotImplementedError, match=names[feature]):
        build_scene([mesh], sensor, emitters, device="cpu")


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
    # spectral renders since the spectral slice: its polarized variant not
    ({"color_mode": "spectral", "polarized": True}, "spectral"),
    ({"polarized": True}, "polarized"),
    ({"rfilter": "gaussian"}, "gaussian"),
    ({"integrator": "volpath"}, "volpath"),
    ({"compact": True}, "compact"),
    # reparam=True renders since the reparameterization's slice: the
    # direct integrator not
    ({"integrator": "direct"}, "direct"),
])
def test_config_refuses_what_the_port_does_not_render(kw, what):
    with pytest.raises(NotImplementedError, match=what):
        mt.RenderConfig(**kw)
    assert mt.RenderConfig().float_dtype is torch.float32
