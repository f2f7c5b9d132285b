"""The integrator variants of the PyTorch port against the JAX package:
direct, depth, aov and moment through render_any, from Python, from
XML and dict scenes and from the command line (its -a and sidecars), and
render_l2_grad under a wide filter and the stratified sampler.

The JAX package's renders and gradients are read from
tests/goldens/test_torch_variants.npz (python tests/goldens/make_refs.py
test_torch_variants writes it); one entry is recomputed live.

Tolerances:
- images (path, direct, moment's mean and variance) and the depth,
  position and normal AOVs: within rtol 1e-4 / atol 1e-5 on every
  pixel (the same streams; the shading rounds apart by ulps); uv within
  atol 1e-5; prim_index, shape_index and albedo equal;
- render_l2_grad: the image and loss within rtol 1e-4, each gradient
  table within 1e-4 in relative norm.
"""
import os

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch import cli
from mitsuba2_tpu_torch.core import io_bitmap
from mitsuba2_tpu_torch.kernels import brute, traverse
from mitsuba2_tpu_torch.render import integrators as ti
from mitsuba2_tpu_torch.scene import loader as tl

from goldens.jax_refs import Refs
from test_torch_cli import XML

# one intra-op thread: the suite's test processes share the cores
# (pytest-xdist), and torch's OpenMP regions stall when they
# oversubscribe them
torch.set_num_threads(1)

REFS = Refs("test_torch_variants")
AOVS = ("depth", "position", "sh_normal", "geo_normal", "uv", "prim_index",
        "shape_index", "albedo")
BASE = dict(width=16, height=16, spp=4, spp_per_pass=2, max_depth=3,
            rr_depth=2)
CASES = {"direct": dict(integrator="direct"),
         "depth": dict(integrator="depth"),
         "aov": dict(integrator="aov", aovs=AOVS),
         "moment": dict(integrator="moment")}
SCENES = {"cornell": ("cornell_box", {}),
          "gallery": ("mesh_gallery", dict(subdiv=1))}


def _jax_any(scene, case, **over):
    import mitsuba2_tpu as mi
    from mitsuba2_tpu.render.integrators import render_any
    from mitsuba2_tpu.scene import presets as jpresets
    make, kw = SCENES[scene]
    out = render_any(getattr(jpresets, make)(**kw), mi.RenderConfig(
        **{**BASE, **CASES[case], **over}), seed=3)
    if isinstance(out, dict):
        return {k: np.asarray(v) for k, v in out.items()}
    if isinstance(out, tuple):
        return tuple(np.asarray(v) for v in out)
    return np.asarray(out)


@pytest.fixture(scope="module")
def port_scenes():
    return {k: getattr(mt, make)(device="cpu", **kw)
            for k, (make, kw) in SCENES.items()}


def _close(got, want, name=""):
    got = got.numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape and np.isfinite(got).all(), name
    if name in ("prim_index", "shape_index", "albedo"):
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("scene", list(SCENES))
def test_render_any_matches_jax(port_scenes, scene, case):
    want = REFS.get(f"{scene}_{case}", lambda: _jax_any(scene, case))
    got = ti.render_any(port_scenes[scene], mt.RenderConfig(
        **BASE, **CASES[case]), seed=3, device="cpu")
    if case == "aov":
        assert set(got) == set(AOVS) | {"image"} == set(want)
        for k, v in got.items():
            c = ti.AOV_CHANNELS.get(k) or 3
            assert v.shape == (16, 16, c), k
            _close(v, want[k], k)
        assert (got["depth"] > 0).float().mean() > 0.5
        assert got["shape_index"].max() > 1
    elif case == "moment":
        mean, var = got
        _close(mean, want[0], "mean")
        _close(var, want[1], "variance")
        assert float(var.min()) >= 0 and float(var.max()) > 0
    else:
        _close(got, want, case)
        assert got.shape[-1] == (1 if case == "depth" else 3)
        assert float(got.max()) > 0


def test_golden_is_fresh():
    stored, live = REFS.fresh("cornell_depth",
                              lambda: _jax_any("cornell", "depth"))
    np.testing.assert_array_equal(stored, live)


def test_direct_is_depth2_path(port_scenes):
    """tests/test_integrator_variants.py's case: direct at any max_depth
    is the path tracer at depth 2, bit for bit."""
    cfg = mt.RenderConfig(**BASE)
    a = ti.render_direct(port_scenes["cornell"], cfg.replace(max_depth=5),
                         seed=1, device="cpu")
    b = ti.render(port_scenes["cornell"], cfg.replace(max_depth=2), seed=1,
                  device="cpu")
    assert torch.equal(a, b)


def test_aov_ignores_the_filter_and_seeds_raw(port_scenes):
    """render_aovs renders one pass of min(spp_per_pass, spp) samples from
    the independent sampler at the raw seed, whatever the config's
    sampler, filter and spp."""
    cfg = mt.RenderConfig(**BASE)
    a = ti.render_aovs(port_scenes["cornell"], cfg, ("depth",), seed=7,
                       device="cpu")["depth"]
    b = ti.render_aovs(port_scenes["cornell"], cfg.replace(
        sampler="stratified", rfilter="lanczos", spp=64), ("depth",),
        seed=7, device="cpu")["depth"]
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Scene files: tests/test_integrator_variants.py's XML cases
# ---------------------------------------------------------------------------

VARIANT_XML = """<scene version="2.0.0">
  <integrator type="aov">
    <string name="aovs" value="dd:depth, nn:sh_normal"/>
    <integrator type="path"><integer name="max_depth" value="5"/></integrator>
  </integrator>
  <sensor type="perspective"/>
  <shape type="sphere"/>
</scene>"""


def test_xml_integrator_types():
    _, cfg = tl.load_string(VARIANT_XML, device="cpu")
    assert cfg.integrator == "aov" and cfg.aovs == ("depth", "sh_normal")
    assert cfg.aov_child == "path" and cfg.max_depth == 5
    _, cfg2 = tl.load_string(VARIANT_XML.replace(
        '<integrator type="aov">', '<integrator type="moment">').replace(
        '<string name="aovs" value="dd:depth, nn:sh_normal"/>', ""),
        device="cpu")
    assert cfg2.integrator == "moment"


def test_wrapper_integrator_guards():
    with pytest.raises(ValueError, match="aov child"):
        mt.RenderConfig(integrator="aov", aov_child="aov")
    xml = """<scene version="2.0.0"><integrator type="ptracer"/>
      <sensor type="perspective"/><shape type="sphere"/></scene>"""
    assert tl.load_string(xml, device="cpu")[1].integrator == "path"
    xml2 = """<scene version="2.0.0">
      <integrator type="moment"><integrator type="path">
        <integer name="max_depth" value="5"/></integrator></integrator>
      <sensor type="perspective"/><shape type="sphere"/></scene>"""
    cfg2 = tl.load_string(xml2, device="cpu")[1]
    assert cfg2.integrator == "moment" and cfg2.max_depth == 5
    # stokes came with the polarized slice: it loads as the JAX package's
    xml3 = xml2.replace('type="moment"><integrator type="path">',
                        'type="aov"><integrator type="stokes">')
    for xml_s, want in ((xml.replace("ptracer", "stokes"), "stokes"),
                        (xml3, "aov")):
        cfg3 = tl.load_string(xml_s, device="cpu")[1]
        assert cfg3.integrator == want
        assert want == "stokes" or cfg3.aov_child == "stokes"


def test_render_any_thinlens_aov():
    """kitchen_sink's thin lens draws its aperture sample in render_aovs
    too (the JAX package's regression case), against its depth image."""
    cfg = dict(width=8, height=8, spp=4, spp_per_pass=4, integrator="depth")

    def jax_depth():
        import mitsuba2_tpu as mi
        from mitsuba2_tpu.render.integrators import render_any
        from mitsuba2_tpu.scene import presets as jpresets
        return np.asarray(render_any(jpresets.kitchen_sink(),
                                     mi.RenderConfig(**cfg)))
    want = REFS.get("kitchen_sink_depth", jax_depth)
    d = ti.render_any(mt.kitchen_sink(device="cpu"), mt.RenderConfig(**cfg),
                      device="cpu")
    assert d.shape == (8, 8, 1) and float(d.max()) > 0
    _close(d, want, "depth")


@pytest.mark.parametrize("integrator", ["path", "volpathmis"])
@pytest.mark.parametrize("mode", ["mono", "spectral"])
def test_variant_matrix(integrator, mode):
    """tests/test_integrator_variants.py's variant matrix on kitchen_sink
    (media, textures, a thin lens), its unpolarized cells: finite and lit."""
    base = mt.RenderConfig(width=8, height=8, spp=2, spp_per_pass=2,
                           max_depth=3, rr_depth=99)
    img = ti.render_any(mt.kitchen_sink(device="cpu"), base.replace(
        integrator=integrator, color_mode=mode), device="cpu")
    assert torch.isfinite(img).all() and float(img.max()) > 0


# ---------------------------------------------------------------------------
# The adjoint under a wide filter and the stratified sampler
# ---------------------------------------------------------------------------

GRAD = dict(BASE, rfilter="gaussian", sampler="stratified")


def _jax_grad():
    import jax.numpy as jnp
    import mitsuba2_tpu as mi
    from mitsuba2_tpu.diff import render_l2_grad
    from mitsuba2_tpu.scene import presets as jpresets
    img, loss, grads = render_l2_grad(
        jpresets.cornell_box(), mi.RenderConfig(**GRAD),
        jnp.zeros((16, 16, 3), jnp.float32), seed=0)
    return (np.asarray(img), float(loss),
            {k: np.asarray(v) for k, v in grads.items()})


def test_render_l2_grad_wide_filter_matches_jax(port_scenes, monkeypatch):
    """Two passes; develop's derivative divides by each pixel's weight.
    The backward sweeps trace no ray."""
    img_j, loss_j, grads_j = REFS.get("cornell_l2_grad", _jax_grad)
    calls, during = [], []
    for mod, name in ((traverse, "ray_intersect_preliminary"),
                      (traverse, "ray_test"),
                      (brute, "ray_intersect_brute"),
                      (brute, "ray_test_brute")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=orig, **kw:
                            calls.append(1) or _o(*a, **kw))
    backward = torch.autograd.backward

    def watched(*a, **kw):
        before = len(calls)
        out = backward(*a, **kw)
        during.append(len(calls) - before)
        return out
    monkeypatch.setattr(torch.autograd, "backward", watched)
    img, loss, grads = mt.render_l2_grad(
        port_scenes["cornell"], mt.RenderConfig(**GRAD),
        torch.zeros(16, 16, 3), seed=0, device="cpu")
    assert during == [0, 0] and len(calls) > 0
    np.testing.assert_allclose(img.numpy(), img_j, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(loss), loss_j, rtol=1e-4)
    assert set(grads) == set(grads_j)
    for k, g in grads.items():
        g, gj = g.numpy(), grads_j[k]
        assert np.isfinite(g).all() and np.abs(gj).max() > 0, k
        assert np.linalg.norm(g - gj) <= 1e-4 * np.linalg.norm(gj), k


# ---------------------------------------------------------------------------
# The command line: sidecars and -a
# ---------------------------------------------------------------------------

def _half(a):
    """What a half-float EXR keeps of an image."""
    return np.asarray(a, np.float32).astype(np.float16).astype(np.float32)


@pytest.mark.parametrize("integrator", ["moment", "aov"])
def test_cli_sidecars(tmp_path, integrator):
    """The moment integrator's _variance and the aov integrator's AOVs
    beside the image, and -a's AOVs, each the in-process result."""
    if integrator == "moment":
        xml = XML.replace('<integrator type="path">',
                          '<integrator type="moment">')
        sidecars = ["variance", "depth", "sh_normal"]
    else:
        xml = XML.replace(
            '<integrator type="path"><integer name="max_depth" value="2"/>'
            '</integrator>',
            '<integrator type="aov"><string name="aovs" value="p:position,'
            ' u:uv"/><integrator type="path"><integer name="max_depth" '
            'value="2"/></integrator></integrator>')
        sidecars = ["position", "uv", "depth", "sh_normal"]
    path = tmp_path / "s.xml"
    path.write_text(xml)
    out = tmp_path / "out.pfm"
    assert cli.main([str(path), "-o", str(out), "--device", "cpu",
                     "-a", "depth", "-a", "sh_normal"]) == 0
    scene, cfg = mt.load_file(str(path), device="cpu")
    assert cfg.integrator == integrator
    got = ti.render_any(scene, cfg, device="cpu")
    if integrator == "moment":
        img, extra = got[0], {"variance": got[1]}
    else:
        img = got.pop("image")
        extra = got
    for name in ("depth", "sh_normal"):
        extra[name] = ti.render_aovs(scene, cfg, (name,),
                                     device="cpu")[name]
    assert np.array_equal(mt.read_bitmap(str(out)), img.numpy())
    for name in sidecars:
        f = str(tmp_path / f"out_{name}.exr")
        assert os.path.exists(f), name
        arr = io_bitmap.read(f)
        want = extra[name].numpy()
        assert np.array_equal(arr.reshape(want.shape), _half(want)), name
