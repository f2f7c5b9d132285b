"""User BSDF plugins in the PyTorch port (render/bsdf.py::register_bsdf),
case for case with tests/test_plugins.py, with the port's HemiDiffuse
(chip_smoke.HemiDiffuse: a Lambertian sampled by the uniform hemisphere
warp).

Registration keeps the JAX package's validation (a duplicate name and an
id already taken raise ValueError, a class without the four static
methods TypeError) and its user id space from 1000; the plugin passes
the chi^2 test through the dispatch and its own methods; it renders from
XML, where the image is held to the JAX package's render of its own
HemiDiffuse on the same seed (>= 99% of pixels within rtol 1e-3 / atol
1e-4); it conserves energy in the furnace; and the dispatch runs it on
its own rows alone in a scene of built-in families beside it
(chip_smoke.gallery_plugin). The JAX image is committed
(tests/goldens/test_torch_plugins.npz, `python tests/goldens/make_refs.py
test_torch_plugins`) and recomputed live once.
"""
import numpy as np
import pytest
import torch

import chip_smoke
import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.render import bsdf as B
from mitsuba2_tpu_torch.scene import presets as tp

from goldens.jax_refs import Refs
from test_torch_chi2 import WI_30, bsdf_chi2

torch.set_num_threads(1)

REFS = Refs("test_torch_plugins")
XML = """
<scene version="2.0.0">
  <integrator type="path"><integer name="max_depth" value="3"/></integrator>
  <sensor type="perspective">
    <float name="fov" value="60"/>
    <transform name="to_world">
      <lookat origin="0, 0, 2" target="0, 0, -2" up="0, 1, 0"/>
    </transform>
    <film type="hdrfilm">
      <integer name="width" value="16"/><integer name="height" value="16"/>
    </film>
    <sampler type="independent"><integer name="sample_count" value="8"/></sampler>
  </sensor>
  <shape type="rectangle">
    <transform name="to_world"><translate z="-2"/></transform>
    <bsdf type="hemi_diffuse">
      <rgb name="reflectance" value="0.7 0.4 0.2"/>
    </bsdf>
  </shape>
  <emitter type="constant"><rgb name="radiance" value="1 1 1"/></emitter>
</scene>
"""


@pytest.fixture(scope="module")
def registered():
    return chip_smoke.register_plugin()


def test_register_validation(registered):
    with pytest.raises(ValueError):
        B.register_bsdf(chip_smoke.PLUGIN, chip_smoke.HemiDiffuse)
    with pytest.raises(TypeError):
        B.register_bsdf("broken", type("Broken", (), {"flags": 0}))
    taken = type("Taken", (chip_smoke.HemiDiffuse,), {"id": registered.id})
    with pytest.raises(ValueError):
        B.register_bsdf("taken", taken)
    assert registered.id >= 1000 and B.LEAF_FAMILIES[registered.id] is \
        registered
    assert "broken" not in B._BY_NAME and "taken" not in B._BY_NAME


def test_plugin_chi2(registered):
    """Its sampler matches its pdf through the chi^2 oracle, on its own
    methods and through the wavefront dispatch."""
    desc = {"type": chip_smoke.PLUGIN}
    bsdf_chi2(desc, WI_30)
    bsdf_chi2(desc, WI_30, wrapper=True)


def _jax_xml_render():
    import mitsuba2_tpu as mi
    from mitsuba2_tpu.render import bsdf as JB
    from test_plugins import HemiDiffuse as JHemi
    if "hemi_diffuse" not in JB._BY_NAME:
        JB.register_bsdf("hemi_diffuse", JHemi)
    scene, config = mi.load_string(XML)
    return np.asarray(mi.render(scene, config))


def test_plugin_renders_from_xml(registered):
    scene, config = mt.load_string(XML, device="cpu")
    assert registered.id in scene.mat_families
    img = mt.render(scene, config, device="cpu").numpy()
    assert np.isfinite(img).all() and (img > 0).any()
    ref = REFS.get("xml_render", _jax_xml_render)
    ok = np.isclose(img, ref, rtol=1e-3, atol=1e-4).all(-1)
    print(f"pixels within rtol 1e-3 / atol 1e-4: {ok.mean():.4f}, largest "
          f"gap {np.abs(img - ref).max():.3e}")
    assert ok.mean() >= 0.99


def test_golden_is_fresh(registered):
    stored, live = REFS.fresh("xml_render", _jax_xml_render)
    np.testing.assert_array_equal(stored, live)


def test_plugin_furnace(registered):
    """An albedo-1 plugin surface in a uniform furnace returns the
    emitter's radiance: its weight 2 albedo cos integrates to 1."""
    scene, _ = mt.load_dict({
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 16, "rr_depth": 64},
        "sensor": {
            "type": "perspective", "fov": 45.0,
            "film": {"type": "hdrfilm", "width": 8, "height": 8},
            "sampler": {"type": "independent", "sample_count": 256},
        },
        "white": {"type": chip_smoke.PLUGIN, "reflectance": [1.0, 1.0, 1.0]},
        "ball": {"type": "sphere", "radius": 0.5,
                 "center": [0.0, 0.0, -3.0], "bsdf": "white"},
        "sky": {"type": "constant", "radiance": [1.0, 1.0, 1.0]},
    }, device="cpu")
    img = mt.render(scene, mt.RenderConfig(
        width=8, height=8, spp=256, spp_per_pass=256, max_depth=16,
        rr_depth=64), device="cpu").numpy()
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img.mean(), 1.0, rtol=0.05)


def test_dispatch_runs_plugin_on_its_rows(registered, monkeypatch):
    """In the gallery (diffuse walls and light, the six blobs under the
    plugin) the dispatch hands the plugin's methods its own rows alone,
    and its render matches, in its mean, the same room with diffuse
    blobs of the same albedos: the plugin's lobe is Lambertian in
    expectation."""
    scene = chip_smoke.gallery_plugin(tp, 1, device="cpu")
    plugin_rows = set(np.nonzero(scene.mat_type.numpy()
                                 == registered.id)[0].tolist())
    assert len(plugin_rows) == 6 and set(scene.mat_families) == {
        B.DIFFUSE, registered.id}
    seen = []
    for name in ("sample", "eval", "pdf"):
        fn = getattr(registered, name)

        def rec(data, *a, _fn=fn):
            seen.append(set(data.idx.unique().tolist()))
            return _fn(data, *a)
        monkeypatch.setattr(registered, name, staticmethod(rec))
    cfg = mt.RenderConfig(width=16, height=16, spp=64, spp_per_pass=64,
                          max_depth=3)
    img = mt.render(scene, cfg, device="cpu").numpy()
    assert seen and all(s <= plugin_rows for s in seen)
    assert np.isfinite(img).all() and img.mean() > 0
    shapes, X, _, _ = chip_smoke._gallery_room(tp, 1, lambda k: {
        "type": "diffuse", "reflectance": chip_smoke.GALLERY_ALBEDO[k]})
    diffuse = mt.build_scene(shapes, chip_smoke._gallery_sensor(tp, X),
                             device="cpu")
    ref = mt.render(diffuse, cfg, device="cpu")
    np.testing.assert_allclose(img.mean(), float(ref.mean()), rtol=0.05)
