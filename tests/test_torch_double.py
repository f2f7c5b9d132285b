"""The float64 variants of the PyTorch port (RenderConfig(dtype="float64"),
the `_double` variants) against the JAX package's.

Where the JAX package renders in float64 (the Cornell box at depth 2 in
rgb, mono and spectral, veach_mis() at depth 2, smoke_box(8) under the
direct, moment, volpath and volpathmis integrators, the tent filter, the
stratified sampler and reparam on the Cornell box), the port's float64
image at 16 x 16 x 4 spp holds every pixel within rtol 1e-6 / atol 1e-9
of the JAX package's, the largest gap printed; but for two cases. Both
packages draw their samples and warp them in f32 (JAX's weak typing
keeps a sample's arithmetic f32 under float64), and XLA's f32 atanh, log
and cos differ from torch's in the last place on some lanes: spectral
mode's hero wavelengths (atanh) move by up to 6e-5 nm, and veach_mis()'s
rough plates' microfacet samples (log, cos) by an ulp, which its
highlights magnify. Those two are held within rtol 1e-4 / atol 1e-7
(their largest gaps: 1.9e-5 and 4.2e-5 relative, on a few pixels). tests/test_double.py's
finite-difference oracle has its counterpart (render_l2_grad of the
emitter radiance against central differences in float64, rtol 1e-6, and
against the JAX package's gradient). Where the JAX package raises (a
bounce scan or a BVH walk whose carry changes dtype: depth 3, and
mesh_gallery(subdiv=1) at depth 2), the port's float64 render is held
to its own float32 render at tests/test_double.py's limits (rtol 2e-4,
atol 2e-5). The depth integrator, render_polarized and the stokes
integrator return float32 under float64, as the JAX package's do. The
JAX package's images are committed (tests/goldens/test_torch_double.npz,
`python tests/goldens/make_refs.py test_torch_double`); one entry is
recomputed live.
"""
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.scene import presets as tp

from goldens.jax_refs import Refs

torch.set_num_threads(1)

REFS = Refs("test_torch_double")
SMALL = dict(width=16, height=16, spp=4, spp_per_pass=4, max_depth=2,
             dtype="float64")
SEED = 1
# (scene, RenderConfig keywords) of the cases the JAX package renders
JAX_CASES = {
    "cornell_rgb": ("cornell", {}),
    "cornell_mono": ("cornell", {"color_mode": "mono"}),
    "cornell_spectral": ("cornell", {"color_mode": "spectral"}),
    "veach": ("veach", {}),
    "smoke_direct": ("smoke", {"integrator": "direct"}),
    "smoke_moment": ("smoke", {"integrator": "moment", "spp_per_pass": 2}),
    "smoke_volpath": ("smoke", {"integrator": "volpath"}),
    "smoke_volpathmis": ("smoke", {"integrator": "volpathmis"}),
    "cornell_tent": ("cornell", {"rfilter": "tent"}),
    "cornell_stratified": ("cornell", {"sampler": "stratified"}),
    "cornell_reparam": ("cornell", {"reparam": True, "reparam_kaux": 4}),
}
# the cases whose f32 sample warps meet libm differences (the docstring)
F32_WARP_CASES = {"cornell_spectral", "veach"}


def _scene(pkg, name):
    """A case's scene from the presets module `pkg` of either package."""
    cpu = {} if pkg.__name__.startswith("mitsuba2_tpu.") else {
        "device": "cpu"}
    return {"cornell": lambda: pkg.cornell_box(**cpu),
            "veach": lambda: pkg.veach_mis(**cpu),
            "smoke": lambda: pkg.smoke_box(8, **cpu),
            # smoke_box(8) with its floor 1e-3 below the box's bottom: the
            # two are coplanar in smoke_box, where the f64 re-solve of a
            # hit's t breaks their tie apart from the f32 render's
            "smoke_lowered": lambda: chip_smoke.smoke_floor_lowered(
                mt, "cpu"),
            "gallery": lambda: pkg.mesh_gallery(subdiv=1, **cpu)}[name]()


def _np(out):
    if isinstance(out, (tuple, list)):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


def _jax_render(scene, kw, entry="render_any"):
    import jax
    import mitsuba2_tpu as mi
    from mitsuba2_tpu.render import integrators, stokes
    from mitsuba2_tpu.scene import presets as jp
    fn = {"render_any": integrators.render_any,
          "render_polarized": stokes.render_polarized}[entry]
    with jax.enable_x64(True):
        return _np(fn(_scene(jp, scene), mi.RenderConfig(**kw), seed=SEED))


def _port_render(scene, kw, entry="render_any"):
    fn = getattr(mt, entry)
    out = fn(_scene(tp, scene), mt.RenderConfig(**kw), seed=SEED,
             device="cpu")
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


def _gap(mine, ref, rtol=1e-6, atol=1e-9):
    """The largest absolute and relative gaps; asserts every pixel within
    rtol / atol."""
    assert mine.dtype == np.float64 and ref.dtype == np.float64
    assert mine.shape == ref.shape and np.isfinite(mine).all()
    d = np.abs(mine - ref)
    rel = d / np.maximum(np.abs(ref), 1e-300)
    print(f"largest gap {d.max():.3e} abs, {rel[d > 0].max() if (d > 0).any() else 0:.3e} rel")
    np.testing.assert_allclose(mine, ref, rtol=rtol, atol=atol)
    return d.max()


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_f64_render_matches_jax(case):
    scene, kw = JAX_CASES[case]
    kw = {**SMALL, **kw}
    ref = REFS.get(case, lambda: _jax_render(scene, kw))
    mine = _port_render(scene, kw)
    tol = (dict(rtol=1e-4, atol=1e-7) if case in F32_WARP_CASES
           else dict(rtol=1e-6, atol=1e-9))
    if isinstance(mine, tuple):
        for m, r in zip(mine, ref):
            _gap(m, r, **tol)
    else:
        _gap(mine, ref, **tol)
        assert mine.mean() > 0


def test_golden_is_fresh():
    scene, kw = JAX_CASES["cornell_rgb"]
    kw = {**SMALL, **kw}
    stored, live = REFS.fresh("cornell_rgb", lambda: _jax_render(scene, kw))
    np.testing.assert_array_equal(stored, live)


def _emitter_loss_grad(scene64, cfg, target, r, c):
    """The loss mean(img^2) at emitter_data[r, c] moved by +-eps."""
    def loss_at(delta):
        ed = scene64.emitter_data.clone()
        ed[r, c] += delta
        img = mt.render(dataclasses.replace(scene64, emitter_data=ed), cfg,
                        seed=3, device="cpu")
        return float(torch.mean(img ** 2))
    return loss_at


def test_fd_vs_ad_in_double_tightened():
    """tests/test_double.py's oracle on the port: central differences of
    mean(img^2) in an emitter radiance entry match the adjoint gradient
    to rtol 1e-6 in float64, and the JAX package's gradient."""
    from mitsuba2_tpu_torch.scene.scene import to_float64
    cfg = mt.RenderConfig(width=16, height=16, spp=16, spp_per_pass=16,
                          max_depth=2, dtype="float64")
    scene64 = to_float64(tp.cornell_box(boxes=False, device="cpu"))
    target = torch.zeros((16, 16, 3), dtype=torch.float64)
    _, _, grads = mt.render_l2_grad(scene64, cfg, target, seed=3,
                                    device="cpu")
    g_em = grads["emitter_data"].numpy()
    assert g_em.dtype == np.float64

    def jax_grad():
        import jax
        import jax.numpy as jnp
        import mitsuba2_tpu as mi
        from mitsuba2_tpu.diff import adjoint as jadj
        from mitsuba2_tpu.scene.presets import cornell_box
        with jax.enable_x64(True):
            s = jax.tree.map(
                lambda a: a.astype(jnp.float64) if hasattr(a, "dtype")
                and jnp.issubdtype(a.dtype, jnp.floating) else a,
                cornell_box(boxes=False))
            _, _, g = jadj.render_l2_grad(
                s, mi.RenderConfig(**{**vars(cfg)}), jnp.zeros((16, 16, 3)),
                seed=3)
            return np.asarray(g["emitter_data"])

    ref = REFS.get("fd_grad_emitter", jax_grad)
    np.testing.assert_allclose(g_em, ref, rtol=1e-6, atol=1e-12)
    r, c = np.unravel_index(np.abs(g_em).argmax(), g_em.shape)
    eps = 1e-4
    loss_at = _emitter_loss_grad(scene64, cfg, target, r, c)
    fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
    assert abs(g_em[r, c]) > 0
    np.testing.assert_allclose(g_em[r, c], fd, rtol=1e-6)


# the cases the JAX package raises on (TypeError: a scan or while_loop
# carry that changes dtype), held to the port's own float32 render
OWN_CASES = {
    "cornell_d3": ("cornell", {"max_depth": 3}),
    "veach_d3": ("veach", {"max_depth": 3}),
    "smoke_volpath_d3": ("smoke_lowered", {"max_depth": 3,
                                           "integrator": "volpath"}),
    "gallery_d2": ("gallery", {}),
    "gallery_d3": ("gallery", {"max_depth": 3}),
}


@pytest.mark.parametrize("case", sorted(OWN_CASES))
def test_f64_where_jax_raises_matches_f32(case):
    scene, kw = OWN_CASES[case]
    kw = {**SMALL, **kw}
    img64 = _port_render(scene, kw)
    img32 = _port_render(scene, {**kw, "dtype": "float32"})
    assert img64.dtype == np.float64 and img32.dtype == np.float32
    assert img64.mean() > 0
    np.testing.assert_allclose(img64, img32, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("entry,kw", [
    ("render_any", {"integrator": "depth"}),
    ("render_polarized", {"polarized": True}),
    ("render_any", {"integrator": "stokes"}),
], ids=["depth", "polarized", "stokes"])
def test_float32_outputs_as_jax(entry, kw):
    """Under dtype="float64" the depth integrator, render_polarized and
    the stokes integrator return float32, as the JAX package's do."""
    kw = {**SMALL, "width": 8, "height": 8, **kw}
    ref = REFS.get(f"dtype_{entry}_{kw.get('integrator', 'pol')}",
                   lambda: str(_jax_render("cornell", kw, entry).dtype))
    mine = _port_render("cornell", kw, entry)
    assert ref == "float32" and mine.dtype == np.float32
    assert np.isfinite(mine).all()
