"""The forward render of the PyTorch port against the JAX package.

On the CPU the JAX package traverses mesh_gallery with its f32 BVH2
walker (traverse_jnp) and the port with its cluster-walk twins; both draw
the same PCG32 numbers in the same order, so the images agree pixel for
pixel up to f32 rounding and the rare exact tie between two triangles
(see tests/test_torch_traverse.py). The JAX package's renders are
committed (tests/goldens/test_torch_render.npz); one is recomputed live.
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mitsuba2_tpu as mi
from mitsuba2_tpu.scene import presets as jpresets
import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.kernels import traverse
from mitsuba2_tpu_torch.render import film, integrators

from goldens.jax_refs import Refs

# one intra-op thread: the suite's test processes share the cores
# (pytest-xdist), and torch's OpenMP regions stall when they
# oversubscribe them
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")
REFS = Refs("test_torch_render")


@pytest.fixture(scope="module")
def gallery():
    return jpresets.mesh_gallery(subdiv=1), mt.mesh_gallery(subdiv=1,
                                                           device="cpu")


@pytest.mark.parametrize("seed,color_mode", [(0, "rgb"), (1, "rgb"),
                                             (0, "mono")])
def test_mesh_gallery_render_matches_jax(gallery, seed, color_mode):
    sj, st = gallery
    kw = dict(width=32, height=32, spp=1, spp_per_pass=1, max_depth=3,
              rr_depth=8, color_mode=color_mode)
    n_ch = {"rgb": 3, "mono": 1}[color_mode]
    img_j = REFS.get(f"gallery_{seed}_{color_mode}", lambda: np.asarray(
        mi.render(sj, mi.RenderConfig(**kw), seed=seed)))
    launches = (traverse.cluster_closest_hit.launches,
                traverse.cluster_any_hit.launches)
    img_t = mt.render(st, mt.RenderConfig(**kw), seed=seed,
                      device="cpu").numpy()
    assert launches == (traverse.cluster_closest_hit.launches,
                        traverse.cluster_any_hit.launches)
    assert img_t.shape == img_j.shape == (32, 32, n_ch)
    assert img_t.dtype == np.float32 and np.isfinite(img_t).all()
    # rtol 1e-3 / atol 1e-4: the shading math runs in f32 in both packages
    # but in other operation orders (XLA fuses and reassociates), so a path
    # of three bounces differs in the last bits; larger differences on
    # under 1% of pixels come from rays that meet an exact tie between two
    # triangles, where the two traversals may pick either one
    close = np.isclose(img_t, img_j, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99
    # the image mean moves by at most those few pixels' share
    np.testing.assert_allclose(img_t.mean(), img_j.mean(), rtol=1e-3)


def _golden_stats(scene, cfg):
    """render_with_variance's statistics, from the port's per-pass images
    of `scene`."""
    cfg = cfg.replace(spp_per_pass=16)
    n_passes = cfg.spp // cfg.spp_per_pass
    imgs = []
    with torch.inference_mode():
        for s in integrators.pass_seeds(3, n_passes):
            img, w = integrators.render_pass(scene, cfg, s, device="cpu")
            imgs.append(film.develop(img, w).numpy())
    imgs = np.stack(imgs)
    mean = imgs.mean(0)
    var = ((imgs ** 2).mean(0) - mean ** 2) / max(n_passes - 1, 1)
    return mean, var


def golden_z_test(scene, cfg, ref):
    """The z-test of tests/test_golden.py on the port's render of `scene`
    against the golden `ref`: same configuration, seed and pass split."""
    mean, var = _golden_stats(scene, cfg)
    sigma = np.sqrt(var + 1e-8) + 5e-3 * np.abs(mean)
    z = np.abs(mean - ref) / sigma
    assert np.median(z) < 2.0, f"median z {np.median(z):.2f}"
    assert (z > 6.0).mean() < 0.02
    np.testing.assert_allclose(np.minimum(mean, 2.0).mean(),
                               np.minimum(ref, 2.0).mean(), rtol=0.05)


@pytest.mark.parametrize("name,depth,rr", [("cornell_d2", 2, 5),
                                           ("cornell_d4", 4, 99)])
def test_cornell_goldens(name, depth, rr):
    """The z-test of tests/test_golden.py on the goldens it renders, with
    the port's images: same configuration, seed and pass split."""
    ref = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))["image"]
    cfg = mt.RenderConfig(width=32, height=32, spp=64, spp_per_pass=64,
                          max_depth=depth, rr_depth=rr)
    golden_z_test(mt.cornell_box(device="cpu"), cfg, ref)


def test_cornell_pass_matches_jax():
    """The brute-force path, one pass, against the JAX package's."""
    cfg_kw = dict(width=16, height=16, spp=4, spp_per_pass=4, max_depth=3,
                  rr_depth=2)
    from mitsuba2_tpu.render.integrators import render_pass as jpass
    img_j = REFS.get("cornell_pass", lambda: np.asarray(jpass(
        jpresets.cornell_box(), mi.RenderConfig(**cfg_kw), 77)[0]))
    img_t, w = integrators.render_pass(mt.cornell_box(device="cpu"),
                                       mt.RenderConfig(**cfg_kw), 77,
                                       device="cpu")
    assert w == 4
    close = np.isclose(img_t.numpy(), np.asarray(img_j), rtol=1e-3,
                       atol=1e-4).all(-1)
    assert close.mean() >= 0.99


def test_golden_is_fresh():
    """The golden's cornell pass recomputed by the JAX package now."""
    from mitsuba2_tpu.render.integrators import render_pass as jpass
    cfg_kw = dict(width=16, height=16, spp=4, spp_per_pass=4, max_depth=3,
                  rr_depth=2)
    np.testing.assert_array_equal(
        REFS.get("cornell_pass"), np.asarray(jpass(
            jpresets.cornell_box(), mi.RenderConfig(**cfg_kw), 77)[0]))


# each a config field no other port test sets, over CONFIG_BASE
CONFIG_FIELDS = {
    "crop_window": dict(film_width=32, film_height=32, crop_x=8, crop_y=6),
    "hide_emitters": dict(hide_emitters=True),
    "max_depth_1": dict(max_depth=1),
    "spp_6_per_pass_4": dict(spp=6, spp_per_pass=4),
    "rr_depth_2": dict(rr_depth=2),
    "film_20x10": dict(width=20, height=10),
}
CONFIG_BASE = dict(width=16, height=16, spp=2, spp_per_pass=2, max_depth=3,
                   rr_depth=5)


@pytest.mark.parametrize("field", list(CONFIG_FIELDS))
def test_config_field_matches_jax(field):
    """The Cornell box (brute force) at 16x16 with one config field set,
    port against JAX on the same seed: the same PCG32 streams and the same
    f32 shading give every pixel within 1e-6."""
    kw = {**CONFIG_BASE, **CONFIG_FIELDS[field]}
    img_j = REFS.get(f"config_{field}", lambda: np.asarray(mi.render(
        jpresets.cornell_box(), mi.RenderConfig(**kw), seed=3)))
    img_t = mt.render(mt.cornell_box(device="cpu"), mt.RenderConfig(**kw),
                      seed=3, device="cpu").numpy()
    assert img_t.shape == img_j.shape == (kw["height"], kw["width"], 3)
    assert np.isfinite(img_t).all() and img_t.mean() > 0
    assert np.abs(img_t - img_j).max() <= 1e-6


_HYGIENE = """
import sys
import torch
import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.kernels import probes
cfg = mt.RenderConfig(width=8, height=8, spp=2, spp_per_pass=1, max_depth=3)
img = mt.render(mt.mesh_gallery(subdiv=1, device="cpu"), cfg, device="cpu")
assert img.shape == (8, 8, 3) and bool(img.isfinite().all())
node, link = (torch.from_numpy(a) for a in probes.walk_tables(64))
s, start = (torch.from_numpy(a) for a in probes.lanes(8, 64, True))
assert probes.walk_step(node, link, s, start, 4, True)[0].shape == (8,)
from mitsuba2_tpu_torch.diff import render_l2_grad
_, loss, grads = render_l2_grad(mt.mesh_gallery(subdiv=1, device="cpu"), cfg,
                                torch.zeros(8, 8, 3), device="cpu")
assert all(bool(g.isfinite().all()) for g in grads.values())
img = mt.render(mt.veach_mis(envmap=True, device="cpu"),
                cfg.replace(color_mode="spectral"), device="cpu")
assert img.shape == (8, 8, 3) and bool(img.isfinite().all())
import chip_smoke
from mitsuba2_tpu_torch import chi2
from mitsuba2_tpu_torch.render import bsdf, texture
from mitsuba2_tpu_torch.scene import presets
scene = chip_smoke.gallery_textured(presets, 1, 16, device="cpu")
assert scene.textures is not None and {bsdf.MASK, bsdf.BLEND, bsdf.NULL_BSDF,
    bsdf.NORMALMAP, bsdf.BUMPMAP} <= set(scene.mat_families)
img = mt.render(scene, cfg, device="cpu")
assert img.shape == (8, 8, 3) and bool(img.isfinite().all())
assert chi2.rlgamma(2.0, 1.0) > 0 and texture.TEXTURE_RANGE
import dataclasses
from mitsuba2_tpu_torch.diff import reparam
from mitsuba2_tpu_torch.scene.scene import refresh_mxu_feat
scene, rows = chip_smoke.shadow_scene(presets, device="cpu")
p0 = scene.prim_p0.clone().requires_grad_(True)
img = mt.render(refresh_mxu_feat(dataclasses.replace(scene, prim_p0=p0)),
                cfg.replace(reparam=True, reparam_kaux=4), device="cpu")
(g,) = torch.autograd.grad(img.mean(), p0)
assert bool(g.isfinite().all()) and float(g[rows].abs().max()) > 0
img = reparam.render_direct_reparam(scene, cfg.replace(max_depth=1),
                                    device="cpu")
assert img.shape == (8, 8, 3) and bool(img.isfinite().all())
from mitsuba2_tpu_torch.core import io_vol
from mitsuba2_tpu_torch.render import media, volpath
img = mt.render(mt.smoke_box(4, device="cpu"),
                cfg.replace(integrator="volpath"), device="cpu")
assert img.shape == (8, 8, 3) and bool(img.isfinite().all())
assert media.MED_W == 8 and volpath._MAX_NULL == 3 and io_vol.read_vol
import contextlib, io, runpy, tempfile
import numpy as np
from mitsuba2_tpu_torch import cli, native
from mitsuba2_tpu_torch.core import io_bitmap
from mitsuba2_tpu_torch.scene import loader, mesh_io
d = tempfile.mkdtemp()
io_bitmap.write(d + "/t.png", np.full((2, 3, 3), 0.5, np.float32))
assert io_bitmap.read(d + "/t.png").shape == (2, 3, 3)
assert "imageio" not in sys.modules and "PIL" not in sys.modules
with open(d + "/m.obj", "w") as f:
    f.write("v 0 0 1\\nv 1 0 1\\nv 0 1 1\\nf 1 2 3\\n")
assert native.parse_obj_native(d + "/m.obj")[1].shape == (1, 3)
xml = ('<scene version="2.0.0"><shape type="obj"><string name="filename" '
       'value="m.obj"/><bsdf type="diffuse"><texture name="reflectance" '
       f'type="bitmap"><string name="filename" value="{d}/t.png"/>'
       '</texture></bsdf></shape><sensor type="perspective"><film '
       'type="hdrfilm"><integer name="width" value="4"/><integer '
       'name="height" value="4"/></film></sensor></scene>')
with open(d + "/s.xml", "w") as f:
    f.write(xml)
scene, cfg = loader.load_file(d + "/s.xml", device="cpu")
assert scene.n_prims == 1 and scene.textures is not None
assert mesh_io.load_mesh(d + "/m.obj").faces.shape == (1, 3)
assert cli.main([d + "/s.xml", "-o", d + "/o.pfm", "--device", "cpu"]) == 0
assert mt.read_bitmap(d + "/o.pfm").shape == (4, 4, 3)
out, sys.argv = io.StringIO(), ["mitsuba2_tpu_torch", "--help"]
with contextlib.redirect_stdout(out):
    try:
        runpy.run_module("mitsuba2_tpu_torch", run_name="__main__",
                         alter_sys=True)
    except SystemExit as e:
        assert e.code == 0
assert "--device" in out.getvalue()
from mitsuba2_tpu_torch import dist as _dist
from mitsuba2_tpu_torch.dist import checkpoint, multihost, sharding
from mitsuba2_tpu_torch.utils import observability
mesh = multihost.pod_mesh(device="cpu")
img = sharding.render_sharded(mt.cornell_box(device="cpu"), mt.RenderConfig(
    width=8, height=8, spp=2, spp_per_pass=2, compact=True), mesh)
assert img.shape == (8, 8, 3) and bool(img.isfinite().all())
assert checkpoint.CheckpointedRender and observability.render_instrumented
from mitsuba2_tpu_torch import chi2 as _chi2
from mitsuba2_tpu_torch.core import distr, pcg32, warp
from mitsuba2_tpu_torch.render import nif
assert _chi2.PlanarDomain and distr.Hierarchical2D and pcg32.advance
assert warp.square_to_von_mises_fisher and nif.nif_ray_test
img = mt.render(mt.cornell_box(device="cpu"), cfg.replace(dtype="float64"),
                device="cpu")
assert img.dtype == torch.float64 and bool(img.isfinite().all())
net = mt.train_shadow_nif(mt.cornell_box(device="cpu"), steps=2,
                          dataset_size=2048, width=8, n_freq=1, batch=512)
assert net.w0.shape == (15, 8)
chip_smoke.register_plugin()
img = mt.render(chip_smoke.gallery_plugin(presets, 1, device="cpu"), cfg,
                device="cpu")
assert bool(img.isfinite().all())
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "flax", "mitsuba2_tpu"))
print("BAD", bad)
assert not bad, bad
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _HYGIENE], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD []" in proc.stdout


def _import_roots(script):
    """The top-level packages a script of the repo's root imports."""
    tree = ast.parse(open(os.path.join(REPO, script)).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    return {n.split(".")[0] for n in names}


def test_chip_smoke_imports_no_jax():
    roots = _import_roots("chip_smoke.py")
    assert not roots & {"jax", "jaxlib", "flax", "mitsuba2_tpu"}
    assert "mitsuba2_tpu_torch" in roots


def test_chip_tiles_imports_no_jax():
    roots = _import_roots("chip_tiles.py")
    assert not roots & {"jax", "jaxlib", "flax", "mitsuba2_tpu"}
    assert {"mitsuba2_tpu_torch", "chip_smoke"} <= roots


def test_render_without_device_needs_cuda(gallery):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    cfg = mt.RenderConfig(width=4, height=4, spp=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        mt.render(gallery[1], cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        mt.render_pass(gallery[1], cfg, 0)


def test_shading_chain_matches_jax(gallery):
    """The modules a render runs between traversal calls, on the same
    numbers in both packages: camera rays, the shading record, the BSDF's
    sample/eval/pdf and next-event estimation. Lanes whose closest prim
    differs (exact ties) are left out; they must be under 1%."""
    import jax.numpy as jnp
    from mitsuba2_tpu.core.vec import Vec2 as JVec2
    from mitsuba2_tpu.render import bsdf as jbsdf
    from mitsuba2_tpu.render import emitters as jemitters
    from mitsuba2_tpu.render import sensors as jsensors
    from mitsuba2_tpu.scene import scene as jscene
    from mitsuba2_tpu_torch.core.vec import Vec2
    from mitsuba2_tpu_torch.render import bsdf, emitters, sensors
    from mitsuba2_tpu_torch.scene import scene as tscene

    sj, st = gallery
    u = np.random.default_rng(11).uniform(0, 1, (7, 4096)).astype(np.float32)
    J = [jnp.asarray(a) for a in u]
    T = [torch.from_numpy(a) for a in u]
    cfg_j, cfg_t = mi.RenderConfig(), mt.RenderConfig()

    def close(a, b, sel, rtol=1e-5, atol=1e-6):
        np.testing.assert_allclose(b.numpy()[sel], np.asarray(a)[sel],
                                   rtol=rtol, atol=atol)

    ray_j = jsensors.sample_ray(sj, JVec2(J[0], J[1]), None)
    ray_t = sensors.sample_ray(st, Vec2(T[0], T[1]))
    every = np.ones(4096, bool)
    for c in "xyz":
        close(getattr(ray_j.o, c), getattr(ray_t.o, c), every)
        close(getattr(ray_j.d, c), getattr(ray_t.d, c), every)

    si_j = jscene.ray_intersect(sj, ray_j, sort=False)
    si_t = tscene.ray_intersect(st, ray_t, sort=False)
    valid = si_t.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(si_j.valid))
    sel = valid & (si_t.prim_index.numpy() == np.asarray(si_j.prim_index))
    assert sel.sum() > 0.99 * valid.sum() and valid.mean() > 0.5
    close(si_j.t, si_t.t, sel)
    for name in ("p", "n", "wi"):
        for c in "xyz":
            close(getattr(getattr(si_j, name), c),
                  getattr(getattr(si_t, name), c), sel)
    for c in "xyz":
        close(getattr(si_j.sh_frame.n, c), getattr(si_t.sh_frame.n, c), sel)
    close(si_j.uv.x, si_t.uv.x, sel)
    np.testing.assert_array_equal(si_t.shape.numpy()[sel],
                                  np.asarray(si_j.shape)[sel])

    bs_j, w_j = jbsdf.sample(sj, si_j, J[2], (J[3], J[4]), cfg_j)
    bs_t, w_t = bsdf.sample(st, si_t, T[2], (T[3], T[4]), cfg_t)
    close(bs_j.pdf, bs_t.pdf, sel)
    for c in "xyz":
        close(getattr(bs_j.wo, c), getattr(bs_t.wo, c), sel)
    for a, b in zip(w_j.ch, w_t.ch):
        close(a, b, sel)
    for a, b in zip(jbsdf.eval_(sj, si_j, bs_j.wo, cfg_j).ch,
                    bsdf.eval_(st, si_t, bs_t.wo, cfg_t).ch):
        close(a, b, sel)
    close(jbsdf.pdf(sj, si_j, bs_j.wo, cfg_j),
          bsdf.pdf(st, si_t, bs_t.wo, cfg_t), sel)

    ds_j, e_j = jemitters.sample_direction(sj, si_j.p, None, J[5],
                                           (J[6], J[2]), cfg_j)
    ds_t, e_t = emitters.sample_direction(st, si_t.p, None, T[5],
                                          (T[6], T[2]), cfg_t)
    # the solid-angle pdf divides by the cosine at the light, which turns
    # last-bit differences (XLA may take 1/sqrt as rsqrt) into ~1e-4 on
    # samples that graze the light
    close(ds_j.pdf, ds_t.pdf, sel, rtol=1e-3)
    close(ds_j.dist, ds_t.dist, sel)
    for c in "xyz":
        close(getattr(ds_j.d, c), getattr(ds_t.d, c), sel)
    for a, b in zip(e_j.ch, e_t.ch):
        close(a, b, sel)


# the JAX package's public names (its __dir__: its module's names and its
# lazy re-exports, and the subpackages a session has imported) that the
# port has no counterpart of: none
JAX_ONLY = frozenset()


def test_exports_cover_the_jax_package():
    """Every public name of mitsuba2_tpu.__dir__() resolves on
    mitsuba2_tpu_torch, as an attribute or as a submodule of that name,
    apart from JAX_ONLY."""
    import importlib
    import mitsuba2_tpu as mi
    missing = set()
    for name in mi.__dir__():
        if name.startswith("_") or hasattr(mt, name):
            continue
        try:
            importlib.import_module(f"mitsuba2_tpu_torch.{name}")
        except ImportError:
            missing.add(name)
    assert missing == JAX_ONLY, sorted(missing)
    for name in ("register_bsdf", "ParameterMap", "Transform4",
                 "diff_tables", "with_tables", "make_mesh", "render_sharded",
                 "shapes", "presets", "train_shadow_nif"):
        assert name in mt.__all__ and getattr(mt, name) is not None
