"""The port's scene loader (mitsuba2_tpu_torch/scene/loader.py) against the
JAX package's.

The XML scenes of tests/test_loader.py and tests/test_cli.py and dicts
like test_load_dict_full_types go through both loaders. A scene the port
renders must build host tables byte-equal to the JAX package's (its
atlas, envmap and density grid too) and a RenderConfig equal field by
field; one it does not render raises NotImplementedError naming the
feature. One file scene (OBJ and PLY meshes, an EXR bitmap, an EXR envmap,
a PNG bitmap, a disk, a cylinder, a flip_normals rectangle) is rendered at
16x16, 4 spp by both packages: every pixel within rtol 1e-3 / atol 1e-4.
"""
import copy
import dataclasses
import logging

import numpy as np
import pytest
import torch

from mitsuba2_tpu.render.integrators import render as jrender
from mitsuba2_tpu.scene import loader as jl
import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.scene import loader as tl

import chip_smoke
import test_cli
import test_loader
from test_torch_instancing import (assert_port_tables, flatten_mode,
                                   jax_fields, recorded_fields)
from test_torch_media import jax_fields as jax_extras
from test_torch_scene import OPTICS_DESCS

# one intra-op thread: the suite's test processes share the cores
# (pytest-xdist), and torch's OpenMP regions stall when they
# oversubscribe them
torch.set_num_threads(1)

META = ("n_prims", "n_shapes", "n_emitters", "has_instances", "has_spheres",
        "has_media", "cam_type", "mat_families", "env_emitter")


def _extras_equal(sj, fields):
    """The envmap's, the atlas', the density grid's and the measured
    BSDFs' tables."""
    want = jax_extras(sj)
    for what in ("envmap", "textures", "medium_grid", "measured"):
        assert (fields[what] is None) == (what not in want), what
        for k, v in want.get(what, {}).items():
            got = fields[what][k]
            assert (got is None) == (v is None), (what, k)
            if v is not None:
                assert got.dtype == v.dtype and got.shape == v.shape
                assert got.tobytes() == v.tobytes(), (what, k)


def both(load, *args, **kw):
    """One scene through `load` of both loaders: the port's tables, metadata
    and config held to the JAX package's. Returns both scenes and the
    port's config."""
    jargs = copy.deepcopy(args)
    sj, cj = getattr(jl, load)(*jargs, **kw)
    with recorded_fields() as got:
        st, ct = getattr(tl, load)(*args, device="cpu", **kw)
    assert_port_tables(jax_fields(sj), got[0], st)
    assert got[0]["param_paths"] == sj.param_paths
    _extras_equal(sj, got[0])
    for k in META:
        assert getattr(st, k) == getattr(sj, k), k
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    return sj, st, ct


# ---------------------------------------------------------------------------
# tests/test_loader.py's and tests/test_cli.py's scenes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("params", [dict(depth=3), dict(depth=2, spp=4)])
def test_cbox_xml_matches_jax(params):
    _, st, ct = both("load_string", test_loader.CBOX_XML, **params)
    assert ct.max_depth == params["depth"] and ct.spp == params.get("spp", 8)
    assert st.n_shapes == 2 and (ct.width, ct.height) == (24, 24)


def test_cli_xml_matches_jax():
    _, st, ct = both("load_string", test_cli.XML)
    assert (ct.width, ct.height, ct.spp, ct.max_depth) == (16, 16, 4, 2)


def test_parse_errors_match_jax(tmp_path):
    for mod in (jl, tl):
        with pytest.raises(ValueError, match="undefined parameter"):
            mod.load_string(test_loader.CBOX_XML)
        with pytest.raises(ValueError, match="undefined reference"):
            mod.load_string('<scene version="2.0.0"><shape type="sphere">'
                            '<ref id="nope"/></shape></scene>')
        with pytest.raises(ValueError, match="expected <scene>"):
            mod.load_string("<shape/>")


def test_include_matches_jax(tmp_path):
    (tmp_path / "mat.xml").write_text(
        '<scene version="2.0.0"><bsdf type="diffuse" id="white">'
        '<rgb name="reflectance" value="0.8 0.8 0.8"/></bsdf></scene>')
    main = tmp_path / "main.xml"
    main.write_text('<scene version="2.0.0"><include filename="mat.xml"/>'
                    '<shape type="sphere"><ref id="white"/></shape></scene>')
    _, st, _ = both("load_file", str(main))
    assert st.n_shapes == 1 and st.has_spheres


def _instance_xml(sampler):
    xml = test_loader.test_shapegroup_instance_xml.__code__.co_consts
    src = next(c for c in xml if isinstance(c, str) and "shapegroup" in c
               and "<scene" in c)
    return src.replace('sampler type="stratified"',
                       f'sampler type="{sampler}"')


@pytest.mark.parametrize("flatten", ["0", "1"])
def test_shapegroup_instance_xml_matches_jax(flatten):
    """test_shapegroup_instance_xml's scene, its stratified sampler
    swapped for the independent one the port renders: shared BLAS (one
    stored sphere, two instances) and flattened."""
    with flatten_mode(flatten):
        _, st, _ = both("load_string", _instance_xml("independent"))
    assert st.has_instances == (flatten == "0")
    assert st.n_prims == (1 if flatten == "0" else 2)


def test_version_upgrade_matches_jax():
    xml = next(c for c in
               test_loader.test_version_upgrade_camelcase.__code__.co_consts
               if isinstance(c, str) and "<scene" in c)
    _, st, _ = both("load_string", xml)
    assert st.n_prims >= 2 and st.n_emitters == 1


def test_inline_bsdf_and_alias_match_jax():
    from mitsuba2_tpu_torch.render import bsdf
    xml = next(c for c in test_loader.test_inline_shape_bsdf.__code__.co_consts
               if isinstance(c, str) and "<scene" in c)
    _, st, _ = both("load_string", xml)
    assert st.mat_type[st.shape_mat[0]] == bsdf.CONDUCTOR
    assert st.mat_type[st.shape_mat[1]] == bsdf.DIFFUSE
    xml = next(c for c in
               test_loader.test_alias_and_multi_sensor.__code__.co_consts
               if isinstance(c, str) and "<scene" in c)
    _, st, ct = both("load_string", xml)
    assert (ct.width, ct.height) == (16, 16)
    _, _, ct = both("load_string", xml, sensor_index=1)
    assert (ct.width, ct.height) == (48, 48)
    for mod in (jl, tl):
        with pytest.raises(ValueError, match="sensor_index"):
            mod.load_string(xml, sensor_index=5)


def test_spectrum_pairs_and_spd_files_match_jax(tmp_path):
    (tmp_path / "green.spd").write_text(
        "# green-peaked SPD\n400 0.0\n500 0.2\n540 1.0\n580 0.2\n700 0.0\n")
    (tmp_path / "scene.xml").write_text("""<scene version="2.0.0">
      <sensor type="perspective"/>
      <shape type="rectangle"><emitter type="area">
        <spectrum name="radiance" filename="green.spd"/></emitter></shape>
      <shape type="sphere"><bsdf type="diffuse">
        <spectrum name="reflectance" value="400:0.9, 500:0.5, 700:0.1"/>
      </bsdf></shape></scene>""")
    _, st, _ = both("load_file", str(tmp_path / "scene.xml"))
    r, g, b = st.emitter_data[0, :3].tolist()
    assert g > 5 * r and g > 5 * b


@pytest.mark.parametrize("axis", ["x", "y", "diagonal", "smaller", "larger"])
@pytest.mark.parametrize("shape", ["sphere", "rectangle", "disk",
                                   "cylinder", "cube"])
def test_fov_axis_and_flip_normals_match_jax(axis, shape):
    xml = f"""<scene version="2.0.0">
      <sensor type="perspective"><float name="fov" value="60"/>
        <string name="fov_axis" value="{axis}"/>
        <film type="hdrfilm"><integer name="width" value="200"/>
        <integer name="height" value="100"/></film></sensor>
      <shape type="{shape}"><float name="radius" value="0.5"/>
        <boolean name="flip_normals" value="true"/>
        <transform name="to_world"><rotate y="1" angle="30"/>
          <translate z="2"/></transform></shape>
    </scene>"""
    _, st, _ = both("load_string", xml)
    if shape == "sphere":
        assert float(st.prim_e1[0, 1]) < 0     # the flip's sign channel


def test_load_dict_matches_jax():
    """test_load_dict's scene."""
    scene = {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 2},
        "sensor": {"type": "perspective", "fov": 40.0, "to_world": np.eye(4),
                   "film": {"width": 16, "height": 16},
                   "sampler": {"sample_count": 4}},
        "white": {"type": "diffuse", "reflectance": [0.8, 0.8, 0.8]},
        "ball": {"type": "sphere", "center": [0, 0, 3], "radius": 1.0,
                 "bsdf": "white"},
        "env": {"type": "constant", "radiance": [0.5, 0.5, 0.5]},
    }
    _, st, ct = both("load_dict", scene)
    assert ct.max_depth == 2 and ct.spp == 4 and st.n_emitters == 1


def full_types_dict(**over):
    """test_load_dict_full_types' dict, with `over` replacing entries."""
    d = {
        "type": "scene",
        "integrator": {"type": "volpathmis", "max_depth": 4},
        "sensor": {"type": "thinlens", "fov": 60.0, "fov_axis": "y",
                   "aperture_radius": 0.05, "focus_distance": 3.0,
                   "near_clip": 0.01, "to_world": np.eye(4),
                   "film": {"width": 64, "height": 32},
                   "sampler": {"type": "halton", "sample_count": 8}},
        "gold": {"type": "roughconductor", "material": "Au", "alpha": 0.2},
        "ball": {"type": "sphere", "bsdf": "gold", "flip_normals": True},
        "flash": {"type": "projector", "irradiance": [2, 2, 2],
                  "position": [0, 0, 4], "direction": [0, 0, -1]},
    }
    d.update(over)
    return d


def test_load_dict_full_types_matches_jax():
    """test_load_dict_full_types' dict with the independent sampler (the
    port refuses halton): thin lens, fov_axis, clip, volpathmis, a rough
    gold sphere flipped, a projector, and the shapes of the dict path."""
    sensor = dict(full_types_dict()["sensor"])
    sensor["sampler"] = {"type": "independent", "sample_count": 8}
    d = full_types_dict(sensor=sensor, plate={
        "type": "disk", "bsdf": {"type": "diffuse"},
        "to_world": np.diag([2.0, 2.0, 2.0, 1.0])},
        post={"type": "cylinder", "flip_normals": True})
    _, st, ct = both("load_dict", d)
    assert ct.integrator == "volpathmis" and st.cam_type == "thinlens"
    assert float(st.cam_data[0]) == np.float32(0.05)


def test_load_dict_knows_every_bsdf_name():
    """Every BSDF name the JAX package knows is the port's, and a dict
    naming one of the families that came with the polarized slice loads
    the JAX loader's tables, the measured ones' too."""
    from mitsuba2_tpu.render import bsdf as jbsdf
    from mitsuba2_tpu_torch.render import bsdf as tbsdf
    assert set(jbsdf._BY_NAME) <= set(tbsdf._BY_NAME)
    for name, desc in OPTICS_DESCS.items():
        d = {"type": "scene", "mat": desc,
             "ball": {"type": "sphere", "bsdf": "mat"}}
        _, st, _ = both("load_dict", d)
        assert st.mat_families == (tbsdf._BY_NAME[name].id,)


# ---------------------------------------------------------------------------
# Sensors, integrators, samplers and filters; what the port does not render
# yet is refused by name
# ---------------------------------------------------------------------------

REFUSED = {
    "orthographic": ('<sensor type="perspective">',
                     '<sensor type="orthographic">'),
    "direct": ('<integrator type="path">', '<integrator type="direct">'),
    "stratified": ('<sampler type="independent">',
                   '<sampler type="stratified">'),
}


@pytest.mark.parametrize("feature", sorted(REFUSED))
def test_xml_refusals_name_the_feature(feature):
    """Each edit of the CLI's scene loads in the port as in the JAX
    package: the same tables and config, the feature in them."""
    a, b = REFUSED[feature]
    assert a in test_cli.XML
    _, st, ct = both("load_string", test_cli.XML.replace(a, b))
    assert feature in (st.cam_type, ct.integrator, ct.sampler)


@pytest.mark.parametrize("over,name", [
    (None, "halton"),
    # the XML loaders of both packages reject <rfilter> inside <film>
    # (its _collect_props knows no such tag): a dict's film names it
    ({"sensor": {"type": "perspective",
                 "film": {"width": 8, "height": 8, "rfilter": "gaussian"}}},
     "gaussian"),
    # its file is written by the test (rgl_file)
    ({"gold": {"type": "measured", "filename": "x.bsdf"}}, "measured"),
    ({"integrator": {"type": "depth"}}, "depth"),
])
def test_dict_refusals_name_the_feature(over, name, rgl_file):
    """The sampler, filter, integrator and (since the polarized slice) a
    measured BSDF read from an RGL .bsdf file load as in the JAX
    package: the measured tables byte-equal."""
    d = full_types_dict(**(over or {}))
    if over is not None:
        d["sensor"] = {**d["sensor"], "sampler": {"type": "independent",
                                                  "sample_count": 8}}
    if name == "measured":
        d["gold"] = {**d["gold"], "filename": rgl_file, "n_ti": 8,
                     "n_to": 16, "n_phi": 16}
        _, st, _ = both("load_dict", d)
        assert st.measured.values.shape == (1, 8, 16, 16, 3)
        return
    _, _, ct = both("load_dict", d)
    assert name in (ct.sampler, ct.rfilter, ct.integrator)


@pytest.fixture(scope="module")
def rgl_file(tmp_path_factory):
    """A synthetic GGX capture in RGL .bsdf layout."""
    from mitsuba2_tpu_torch.render import rgl
    p = str(tmp_path_factory.mktemp("rgl") / "ggx.bsdf")
    rgl.write_rgl_ggx(p, alpha=0.3, n_ti=8, res=32, res2=32)
    return p


POLARIZED_XML = """<scene version="2.0.0">
  <integrator type="stokes"/>
  <sensor type="perspective">
    <transform name="to_world">
      <lookat origin="0,-3,2" target="0,0,0" up="0,0,1"/></transform>
    <float name="fov" value="40"/>
    <film type="hdrfilm"><integer name="width" value="8"/>
      <integer name="height" value="8"/></film>
    <sampler type="independent"><integer name="sample_count" value="4"/>
    </sampler>
  </sensor>
  <bsdf type="measured" id="gold">
    <string name="filename" value="$capture"/>
    <integer name="n_ti" value="8"/><integer name="n_to" value="16"/>
    <integer name="n_phi" value="16"/>
  </bsdf>
  <shape type="rectangle"><ref id="gold"/></shape>
  <shape type="rectangle">
    <transform name="to_world"><translate value="0,0,0.5"/></transform>
    <bsdf type="polarizer"><float name="theta" value="30"/></bsdf>
  </shape>
  <shape type="rectangle">
    <transform name="to_world"><translate value="0,0,1"/></transform>
    <bsdf type="retarder"><float name="delta" value="90"/></bsdf>
  </shape>
  <emitter type="constant"><rgb name="radiance" value="1,1,1"/></emitter>
</scene>"""


def test_polarized_xml_loads_as_jax(rgl_file):
    """An XML scene of a measured capture (its file resolved as the JAX
    loader resolves it), a polarizer and a retarder under the stokes
    integrator: the JAX loader's tables and config; it renders."""
    _, st, ct = both("load_string", POLARIZED_XML, capture=rgl_file)
    assert ct.integrator == "stokes"
    assert set(st.mat_families) == {13, 14, 15}
    img = mt.render_any(st, ct, device="cpu")
    assert img.shape == (8, 8, 4) and torch.isfinite(img).all()


def test_variants_refused_at_load(monkeypatch):
    """set_variant applies to the loaded config: a _double variant raises
    there by name; a _polarized one (since the polarized slice) loads the
    JAX package's config under its set_variant and renders through
    render_polarized."""
    import mitsuba2_tpu as mi
    monkeypatch.setattr(mt, "_variant", None)
    mt.set_variant("mono_double")
    with pytest.raises(NotImplementedError, match="float64"):
        mt.load_string(test_cli.XML, device="cpu")
    mt.set_variant("rgb_polarized")
    st, ct = mt.load_string(test_cli.XML, device="cpu")
    monkeypatch.setattr(mi, "_variant", None)
    mi.set_variant("rgb_polarized")
    _, cj = mi.load_string(test_cli.XML)
    assert ct.variant == "rgb_polarized"
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    img = mt.render_polarized(st, ct.replace(width=4, height=4),
                              device="cpu")
    assert img.shape == (4, 4, 3, 4) and torch.isfinite(img).all()


def test_unknown_integrator_falls_back_to_path(caplog):
    xml = test_cli.XML.replace('<integrator type="path">',
                               '<integrator type="ptracer">')
    with caplog.at_level(logging.WARNING):
        _, st, ct = both("load_string", xml)
    assert ct.integrator == "path" and "ptracer" in caplog.text


def test_device_is_reserved_and_cuda_by_default(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tl.load_string(test_cli.XML)
    with pytest.raises(RuntimeError, match="CUDA"):
        mt.load_dict(full_types_dict(sensor={"type": "perspective"},
                                     integrator={"type": "path"}))
    st, _ = mt.load_string(test_cli.XML, device="cpu")
    assert st.device == torch.device("cpu")


# ---------------------------------------------------------------------------
# A scene from files, built and rendered by both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def file_scene(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("files"))
    return d, chip_smoke.write_file_scene(d, medium=False)


def test_file_scene_with_medium_matches_jax(tmp_path):
    """chip_smoke's phase-4 scene (a .vol grid in a null cube, volpath):
    tables byte-equal, the atlas, envmap and grid among them; the atlas
    and envmap those of the same images given as arrays."""
    path, arrays = chip_smoke.write_file_scene(str(tmp_path))
    _, st, ct = both("load_file", path, res=8)
    assert st.has_media and st.medium_grid is not None and ct.width == 8
    assert ct.integrator == "volpath"
    ref = chip_smoke.file_scene_from_arrays(mt, arrays, "cpu")
    for what in ("textures", "envmap"):
        got, want = (chip_smoke._tables(getattr(s, what)) for s in (st, ref))
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert got[k].numpy().tobytes() == v.numpy().tobytes(), (what, k)


@pytest.fixture(scope="module")
def jax_file_render(file_scene):
    """The JAX package's render of the file scene, once a module."""
    _, (path, _) = file_scene
    sj, cj = jl.load_file(path, res=16, spp=4)
    return np.asarray(jrender(sj, cj))


def test_file_scene_render_matches_jax(file_scene, jax_file_render):
    _, (path, _) = file_scene
    _, st, ct = both("load_file", path, res=16, spp=4)
    assert (ct.width, ct.spp, ct.integrator) == (16, 4, "path")
    assert st.textures.data.shape[0] == 2 and st.envmap is not None
    img = mt.render_any(st, ct, device="cpu").numpy()
    assert img.shape == jax_file_render.shape == (16, 16, 3)
    assert np.isfinite(img).all() and img.mean() > 0.05
    np.testing.assert_allclose(img, jax_file_render, rtol=1e-3, atol=1e-4)
