"""The film of the PyTorch port (render/film.py) against the JAX package:
the reconstruction filters, the splat of a pass and develop.

Tolerances:
- filter_eval on a grid of distances: within 1e-7 absolute; lanczos
  within 2 ulps (1.2e-7 near its peak of 1): torch's and XLA's f32 sin
  each round within 0.6 ulp, apart by an ulp at some x, and lanczos
  multiplies two of them;
- accumulate_pass on the same values and jitter: within 1e-6 relative to
  the image's largest value (the splat sums over the spp axis in an order
  torch and XLA need not share), the weights likewise; the JAX package's
  splats are committed (tests/goldens/test_torch_film.npz), the tent's
  recomputed live;
- tests/test_film_filters.py's constant image: the interior of a 16x16
  render of a constant radiance field at 0.5 within 0.01, its std below
  0.03, under every filter.
"""
import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.core.geometry import Transform4
from mitsuba2_tpu_torch.core.spec import Spec
from mitsuba2_tpu_torch.render import film
from mitsuba2_tpu_torch.scene import shapes

from goldens.jax_refs import Refs

# one intra-op thread: the suite's test processes share the cores
# (pytest-xdist), and torch's OpenMP regions stall when they
# oversubscribe them
torch.set_num_threads(1)

REFS = Refs("test_torch_film")
WIDE = ("tent", "gaussian", "mitchell", "catmullrom", "lanczos")


@pytest.mark.parametrize("name", ("box",) + WIDE)
def test_filter_eval_matches_jax(name):
    import jax.numpy as jnp
    from mitsuba2_tpu.render import film as jfilm
    x = np.linspace(-4.0, 4.0, 4097, dtype=np.float32)
    want = np.asarray(jfilm.filter_eval(name, jnp.asarray(x)))
    got = film.filter_eval(name, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    if name == "lanczos":
        np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=2)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)
    # zero outside the radius the splat covers (box: its half pixel)
    R = film.FILTER_RADIUS[name]
    assert not got[np.abs(x) > max(R, 0.5)].any()
    assert film.FILTER_RADIUS == jfilm.FILTER_RADIUS


def _pass(name, H=12, W=10, spp=3, C=3, seed=0):
    rng = np.random.default_rng(seed)
    vals = rng.random((C, spp * H * W)).astype(np.float32)
    jit = rng.random((2, spp * H * W)).astype(np.float32)
    return vals, jit, mt.RenderConfig(width=W, height=H, rfilter=name)


def _jax_passes(name):
    """The JAX package's accumulate_pass of the two passes, and its
    develop of the sum: (image, wsum, developed)."""
    import jax.numpy as jnp
    import mitsuba2_tpu as mi
    from mitsuba2_tpu.core.spec import Spec as JSpec
    from mitsuba2_tpu.render import film as jfilm
    cfg = _pass(name)[2]
    img = jnp.zeros((cfg.height, cfg.width, 3))
    w = jnp.zeros((cfg.height, cfg.width) if name != "box" else ())
    jcfg = mi.RenderConfig(width=cfg.width, height=cfg.height, rfilter=name)
    for seed in (0, 1):
        vals, jit, _ = _pass(name, seed=seed)
        img, w = jfilm.accumulate_pass(
            img, w, JSpec(tuple(jnp.asarray(v) for v in vals)),
            (jnp.asarray(jit[0]), jnp.asarray(jit[1])), jcfg)
    return (np.asarray(img), np.asarray(w),
            np.asarray(jfilm.develop(img, w)))


@pytest.mark.parametrize("name", ("box",) + WIDE)
def test_accumulate_pass_matches_jax(name):
    """Two passes accumulated onto an image that already holds one,
    against the JAX package's (tests/goldens/test_torch_film.npz)."""
    img_j, w_j, dev_j = REFS.get(f"passes_{name}",
                                 lambda: _jax_passes(name))
    cfg = _pass(name)[2]
    img_t = torch.zeros((cfg.height, cfg.width, 3))
    w_t = film.zero_weight(cfg, "cpu")
    for seed in (0, 1):
        vals, jit, cfg = _pass(name, seed=seed)
        img_t, w_t = film.accumulate_pass(
            img_t, w_t, Spec(tuple(torch.from_numpy(v) for v in vals)),
            (torch.from_numpy(jit[0]), torch.from_numpy(jit[1])), cfg)
    np.testing.assert_allclose(img_t.numpy(), img_j, rtol=0,
                               atol=1e-6 * np.abs(img_j).max())
    if name == "box":
        assert w_t == 6 and float(w_j) == 6
    else:
        assert w_t.shape == (cfg.height, cfg.width) and w_t.min() > 0
        np.testing.assert_allclose(w_t.numpy(), w_j, rtol=0,
                                   atol=1e-6 * w_j.max())
    np.testing.assert_allclose(film.develop(img_t, w_t).numpy(), dev_j,
                               rtol=1e-5, atol=1e-6)


def test_golden_is_fresh():
    """The golden's tent passes recomputed by the JAX package now."""
    stored, live = REFS.fresh("passes_tent", lambda: _jax_passes("tent"))
    for a, b in zip(stored, live):
        np.testing.assert_array_equal(a, b)


def _const_scene():
    cam = Transform4.look_at(origin=[0, 0, 3], target=[0, 0, 0],
                             up=[0, 1, 0])
    return mt.build_scene(
        [shapes.rectangle(bsdf={"type": "diffuse",
                                "reflectance": [0.5] * 3})],
        {"type": "perspective", "to_world": np.asarray(cam.matrix),
         "fov": 20.0},
        emitters=[{"type": "constant", "radiance": [1.0] * 3}],
        device="cpu")


@pytest.mark.parametrize("rfilter", WIDE)
def test_filters_preserve_constant_image(rfilter):
    """Any normalized filter reproduces a constant radiance field after
    develop (a partition of unity); the borders lose taps."""
    cfg = mt.RenderConfig(width=16, height=16, spp=32, spp_per_pass=32,
                          max_depth=2, rr_depth=99, rfilter=rfilter)
    img = mt.render(_const_scene(), cfg, seed=1, device="cpu").numpy()
    interior = img[4:12, 4:12]
    assert abs(interior.mean() - 0.5) < 0.01
    assert interior.std() < 0.03


def test_unknown_filter_refused():
    with pytest.raises(ValueError, match="sinc"):
        mt.RenderConfig(rfilter="sinc")
    with pytest.raises(ValueError, match="sinc"):
        film.filter_eval("sinc", torch.zeros(2))
