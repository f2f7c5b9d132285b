"""The port's parameter map, scene_with, optimizers, render_torch and the
safe math's derivatives, against the JAX package's. JAX is imported by
the `J` fixture, so that the card-only case runs where JAX is not
installed."""
import types

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.core import math as tmath
from mitsuba2_tpu_torch.diff import optimizers as topt
from mitsuba2_tpu_torch.diff.torch_interop import render_torch

SCENES = {"cornell_box": (lambda p: p.cornell_box(),
                          lambda: mt.cornell_box(device="cpu")),
          "mesh_gallery": (lambda p: p.mesh_gallery(subdiv=1),
                           lambda: mt.mesh_gallery(subdiv=1, device="cpu"))}


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules these tests hold the port against."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import mitsuba2_tpu as mi
    from mitsuba2_tpu.core import math as jmath
    from mitsuba2_tpu.diff import optimizers as jopt
    from mitsuba2_tpu.diff import params as jparams
    from mitsuba2_tpu.diff.torch_interop import render_torch as j_render_torch
    from mitsuba2_tpu.scene import presets as jpresets
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, mi=mi, jmath=jmath, jopt=jopt, jparams=jparams,
        render_torch=j_render_torch, presets=jpresets)


@pytest.fixture(scope="module")
def scenes(J):
    return {k: (mj(J.presets), mk()) for k, (mj, mk) in SCENES.items()}


@pytest.mark.parametrize("name", list(SCENES))
def test_traverse_matches_jax(J, scenes, name):
    sj, st = scenes[name]
    pj, pt = J.jparams.traverse(sj), mt.traverse(st)
    assert list(pt.keys()) == list(pj.keys()) and len(pt) == len(pj) > 0
    assert st.param_paths == sj.param_paths
    for k, v in pt.items():
        assert k in pt
        np.testing.assert_array_equal(v.numpy(), np.asarray(pj[k]))
    assert set(pt.flat()) == set(pt)


def test_keep_and_update_match_jax(J, scenes):
    sj, st = scenes["cornell_box"]
    for pat in (r"reflectance", [r"^light", r"left"]):
        kj, kt = J.jparams.traverse(sj).keep(pat), mt.traverse(st).keep(pat)
        assert list(kt.keys()) == list(kj.keys()) and len(kt) > 0
    kept = mt.traverse(st).keep(r"reflectance")
    assert "light.emitter.radiance" not in kept
    value = [0.0, 0.0, 1.0]
    uj = J.jparams.traverse(sj).update({"left.bsdf.reflectance":
                                        J.jnp.asarray(value)})
    before = st.mat_data.clone()
    ut = mt.traverse(st).update({"left.bsdf.reflectance": torch.tensor(value)})
    np.testing.assert_allclose(ut.scene.mat_data.numpy(),
                               np.asarray(uj.scene.mat_data), atol=1e-6)
    np.testing.assert_array_equal(ut["left.bsdf.reflectance"].numpy(), value)
    # functional: the old scene's table is untouched
    assert torch.equal(st.mat_data, before)
    assert ut.scene is not st and list(ut.keys()) == list(uj.keys())


@pytest.mark.parametrize("name,value", [
    ("left.bsdf.reflectance", [0.2, 0.6, 0.3]),
    ("floor.bsdf.reflectance", [0.6, 0.6, 0.6]),
    ("light.emitter.radiance", [18.4, 15.6, 8.0])])
def test_scene_with_matches_jax(J, scenes, name, value):
    """The whole 8-wide slot (RGB, coefficients, scale, kind) within 1e-6,
    relative on the coefficients, and the slot's gradient with respect
    to the value against jax.grad's."""
    sj, st = scenes["cornell_box"]
    _, table, row, c0, _, _ = next(p for p in st.param_paths
                                   if p[0] == name)
    w = np.random.default_rng(1).normal(size=8).astype(np.float32)

    def row_j(v):
        return getattr(J.jparams.scene_with(sj, {name: v}), table)[
            row, c0:c0 + 8]

    v = torch.tensor(value, dtype=torch.float32, requires_grad=True)
    got = getattr(mt.scene_with(st, {name: v}), table)[row, c0:c0 + 8]
    want = np.asarray(row_j(J.jnp.asarray(value, J.jnp.float32)))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-6)
    (got * torch.from_numpy(w)).sum().backward()
    g_j = np.asarray(J.jax.grad(lambda x: J.jnp.sum(row_j(x) * w))(
        J.jnp.asarray(value, J.jnp.float32)))
    assert np.isfinite(g_j).all() and np.abs(g_j).max() > 0
    np.testing.assert_allclose(v.grad.numpy(), g_j, rtol=1e-5,
                               atol=1e-5 * np.abs(g_j).max())


def _seeded_dicts(seed):
    rng = np.random.default_rng(seed)
    return {"mat_data": rng.normal(size=(4, 40)).astype(np.float32),
            "emitter_data": rng.normal(size=(1, 16)).astype(np.float32)}


@pytest.mark.parametrize("kind", ["sgd", "sgd_momentum", "adam"])
def test_optimizer_steps_match_jax(J, kind):
    """Five steps of the functional optimizers and of the stateful
    wrappers on seeded dicts: the JAX package's values within 1e-6."""
    params = _seeded_dicts(0)
    jnp, jopt = J.jnp, J.jopt
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    pt = {k: torch.from_numpy(v) for k, v in params.items()}
    if kind == "adam":
        sj, st = jopt.adam_init(pj), topt.adam_init(pt)
        wrap = mt.Adam(pt, lr=0.05)
    else:
        sj, st = jopt.sgd_init(pj), topt.sgd_init(pt)
        mom = 0.9 if kind == "sgd_momentum" else 0.0
        wrap = mt.SGD(pt, lr=0.05, momentum=mom)
    for i in range(5):
        g = _seeded_dicts(10 + i)
        gj = {k: jnp.asarray(v) for k, v in g.items()}
        gt = {k: torch.from_numpy(v) for k, v in g.items()}
        if kind == "adam":
            pj, sj = jopt.adam_step(pj, gj, sj, lr=0.05)
            pt, st = topt.adam_step(pt, gt, st, lr=0.05)
        else:
            pj, sj = jopt.sgd_step(pj, gj, sj, lr=0.05, momentum=mom)
            pt, st = topt.sgd_step(pt, gt, st, lr=0.05, momentum=mom)
        wrap.step(gt)
    for k in params:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                   rtol=1e-6, atol=1e-7)
        assert torch.equal(wrap[k], pt[k])
    if kind == "adam":
        assert int(st["step"]) == int(sj["step"]) == 5
    wrap["mat_data"] = np.zeros((1,), np.float32)
    assert torch.is_tensor(wrap["mat_data"])


def test_render_torch_matches_jax(J):
    """render_torch's image and its tables' .grad under an MSE loss, the
    port against the JAX package's torch bridge."""
    cfg_kw = dict(width=12, height=12, spp=4, spp_per_pass=4, max_depth=3,
                  rr_depth=99)
    sj = J.presets.cornell_box(boxes=False)
    st = mt.cornell_box(boxes=False, device="cpu")
    out = []
    for fn, scene, cfg in ((J.render_torch, sj, J.mi.RenderConfig(**cfg_kw)),
                           (render_torch, st, mt.RenderConfig(**cfg_kw))):
        params = {"mat_data": torch.tensor(np.asarray(scene.mat_data),
                                           requires_grad=True),
                  "emitter_data": torch.tensor(np.asarray(scene.emitter_data),
                                               requires_grad=True)}
        kw = {"device": "cpu"} if fn is render_torch else {}
        img = fn(scene, cfg, params, seed=2, **kw)
        torch.nn.functional.mse_loss(img, torch.zeros_like(img)).backward()
        out.append((img.detach(), {k: v.grad for k, v in params.items()}))
    (img_j, g_j), (img_t, g_t) = out
    np.testing.assert_allclose(img_t.numpy(), img_j.numpy(), rtol=1e-5,
                               atol=1e-6)
    for k in g_j:
        np.testing.assert_allclose(g_t[k].numpy(), g_j[k].numpy(),
                                   rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError, match="unknown param tables"):
        render_torch(st, mt.RenderConfig(**cfg_kw),
                     {"tex_data": torch.zeros(1)}, device="cpu")


@pytest.mark.parametrize("fn,xs", [
    ("safe_sqrt", [0.0, -1.0, 1e-30, 1e-10, 4.0]),
    ("safe_acos", [-1.0, 1.0, 0.0, 0.5, 1.5, -2.0])])
def test_safe_math_gradients_match_jax(J, fn, xs):
    """Finite derivatives where the plain ones are infinite (0 for sqrt,
    +-1 for acos), equal to jax.grad of the JAX package's custom_jvp."""
    x = torch.tensor(xs, dtype=torch.float32, requires_grad=True)
    y = getattr(tmath, fn)(x)
    y.sum().backward()
    jax, jnp = J.jax, J.jnp
    f_j = getattr(J.jmath, fn)
    y_j = np.asarray(f_j(jnp.asarray(xs, jnp.float32)))
    g_j = np.asarray(jax.vmap(jax.grad(f_j))(jnp.asarray(xs, jnp.float32)))
    np.testing.assert_array_equal(y.detach().numpy(), y_j)
    assert np.isfinite(x.grad.numpy()).all()
    np.testing.assert_allclose(x.grad.numpy(), g_j, rtol=1e-6)


def test_adam_invert_loop_reduces_albedo_error():
    """tests/test_adjoint.py's invert loop on the port: Adam on one wall's
    albedo through scene_with and render_l2_grad moves it toward the
    value that rendered the target."""
    cfg = mt.RenderConfig(width=16, height=16, spp=8, spp_per_pass=8,
                          max_depth=3, rr_depth=99)
    scene = mt.cornell_box(boxes=False, device="cpu")
    name = "left.bsdf.reflectance"
    true = torch.tensor([0.1, 0.7, 0.2])
    target = mt.render(mt.scene_with(scene, {name: true}), cfg, seed=1,
                       device="cpu")
    _, _, row, c0, c1, _ = next(p for p in scene.param_paths if p[0] == name)
    theta = {"a": torch.tensor([0.5, 0.5, 0.5])}
    state = topt.adam_init(theta)
    err0 = float((theta["a"] - true).abs().max())
    losses = []
    for _ in range(6):
        s = mt.scene_with(scene, {name: theta["a"]})
        _, loss, grads = mt.render_l2_grad(s, cfg, target, seed=1,
                                           device="cpu")
        losses.append(float(loss))
        theta, state = topt.adam_step(
            theta, {"a": grads["mat_data"][row, c0:c1]}, state, lr=0.1)
    assert float((theta["a"] - true).abs().max()) < err0 - 0.2
    assert losses[-1] < losses[0]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_cuda_scene_with_and_adam_match_cpu(cuda):
    """scene_with and an Adam step on the card give the CPU's values."""
    name, value = "left.bsdf.reflectance", torch.tensor([0.2, 0.6, 0.3])
    rows = [mt.scene_with(mt.cornell_box(device=d), {name: value.to(d)})
            .mat_data.cpu() for d in ("cpu", cuda)]
    torch.testing.assert_close(rows[1], rows[0], rtol=1e-6, atol=1e-6)
    p = {k: torch.from_numpy(v) for k, v in _seeded_dicts(0).items()}
    g = {k: torch.from_numpy(v) for k, v in _seeded_dicts(1).items()}
    want, _ = topt.adam_step(p, g, topt.adam_init(p), lr=0.05)
    pc = {k: v.to(cuda) for k, v in p.items()}
    got, _ = topt.adam_step(pc, {k: v.to(cuda) for k, v in g.items()},
                            topt.adam_init(pc), lr=0.05)
    for k in want:
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-6,
                                   atol=1e-7)
