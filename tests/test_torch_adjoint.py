"""The adjoint of the PyTorch port against the JAX package's.

Both packages draw the same PCG32 numbers in the same order and replay
the same passes, so `render_l2_grad` gives the same image, loss and
table gradients up to f32 rounding: on the Cornell box (brute force) and
on mesh_gallery(subdiv=1) (the cluster walks' twins on the port's side,
the JAX package's f32 BVH2 walker on its side). The JAX references are
committed (tests/goldens/test_torch_adjoint.npz); one is recomputed
live. JAX is imported where a reference needs it, so that the card-only
cases run where JAX is not installed.
"""
import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.diff import adjoint
from mitsuba2_tpu_torch.kernels import brute, traverse

from goldens.jax_refs import Refs

# one intra-op thread: the suite's test processes share the cores
# (pytest-xdist), and torch's OpenMP regions stall when they
# oversubscribe them
torch.set_num_threads(1)

REFS = Refs("test_torch_adjoint")

# tests/test_adjoint.py's CFG
CORNELL = dict(width=12, height=12, spp=16, spp_per_pass=4, max_depth=3,
               rr_depth=99)
GALLERY = dict(width=16, height=16, spp=4, spp_per_pass=4, max_depth=3,
               rr_depth=8)
CASES = {"cornell": (lambda d=None: mt.cornell_box(boxes=False, device=d),
                     lambda p: p.cornell_box(boxes=False), CORNELL),
         "gallery": (lambda d=None: mt.mesh_gallery(subdiv=1, device=d),
                     lambda p: p.mesh_gallery(subdiv=1), GALLERY)}
# the entry points every traversal of the port goes through: the walks'
# (scene._walk_fns) and brute force's
ENTRIES = ((traverse, "ray_intersect_preliminary"), (traverse, "ray_test"),
           (traverse, "ray_intersect_instanced"),
           (traverse, "ray_test_instanced"),
           (brute, "ray_intersect_brute"), (brute, "ray_test_brute"))


@pytest.fixture(scope="module")
def refs():
    """Each case's port scene, config, and the JAX package's render_l2_grad
    (image, loss, grads) against a zero target, seed 0."""
    pytest.importorskip("jax")
    return {name: (mk_t("cpu"), mt.RenderConfig(**kw),
                   REFS.get(name, lambda n=name: _jax_l2_grad(n)))
            for name, (mk_t, _, kw) in CASES.items()}


def _jax_l2_grad(name):
    """The JAX package's render_l2_grad of case `name` (read from
    tests/goldens/test_torch_adjoint.npz by refs)."""
    import jax.numpy as jnp
    import mitsuba2_tpu as mi
    from mitsuba2_tpu.diff import render_l2_grad as j_render_l2_grad
    from mitsuba2_tpu.scene import presets as jpresets
    _, mk_j, kw = CASES[name]
    target = jnp.zeros((kw["height"], kw["width"], 3), jnp.float32)
    img, loss, grads = j_render_l2_grad(
        mk_j(jpresets), mi.RenderConfig(**kw), target, seed=0)
    return (np.asarray(img), float(loss),
            {k: np.asarray(v) for k, v in grads.items()})


def test_golden_is_fresh():
    """The golden's cornell gradients recomputed by the JAX package now."""
    stored, live = REFS.fresh("cornell", lambda: _jax_l2_grad("cornell"))
    np.testing.assert_array_equal(stored[0], live[0])
    assert stored[1] == live[1]
    for k in live[2]:
        np.testing.assert_array_equal(stored[2][k], live[2][k])


def _zero_target(cfg):
    return torch.zeros((cfg.height, cfg.width, 3))


@pytest.mark.parametrize("name,rtol,atol", [("cornell", 1e-4, 1e-6),
                                            ("gallery", 1e-3, 1e-5)])
def test_render_l2_grad_matches_jax(refs, name, rtol, atol):
    scene, cfg, (img_j, loss_j, grads_j) = refs[name]
    img, loss, grads = mt.render_l2_grad(scene, cfg, _zero_target(cfg),
                                         seed=0, device="cpu")
    assert set(grads) == set(grads_j) == {"mat_data", "emitter_data"}
    if name == "cornell":
        np.testing.assert_allclose(img.numpy(), img_j, rtol=1e-5, atol=1e-6)
    else:
        # tests/test_torch_render.py's limits: the two traversals may pick
        # either triangle of an exact tie
        close = np.isclose(img.numpy(), img_j, rtol=1e-3, atol=1e-4)
        assert close.all(-1).mean() >= 0.99
    np.testing.assert_allclose(float(loss), loss_j, rtol=1e-5)
    for k, g in grads.items():
        assert g.shape == grads_j[k].shape and bool(g.isfinite().all())
        np.testing.assert_allclose(g.numpy(), grads_j[k], rtol=rtol,
                                   atol=atol)
    assert float(grads["mat_data"].abs().max()) > 1e-4


def _end_to_end(scene, cfg):
    """Plain autograd through the port's whole multi-pass render."""
    tables = {k: v.clone().requires_grad_(True)
              for k, v in adjoint.diff_tables(scene).items()}
    img = mt.render(adjoint.with_tables(scene, tables), cfg, seed=0,
                    device="cpu")
    torch.mean(img ** 2).backward()
    return img.detach(), {k: v.grad for k, v in tables.items()}


def test_render_and_grad_equals_end_to_end_autograd(refs):
    scene, cfg, _ = refs["cornell"]
    img, loss, grads = mt.render_and_grad(
        scene, cfg, lambda im: torch.mean(im ** 2), seed=0, device="cpu")
    img_e, ref = _end_to_end(scene, cfg)
    # the forward image is the plain render's, bit for bit, taped or not
    assert torch.equal(img, img_e)
    assert torch.equal(img, mt.render(scene, cfg, seed=0, device="cpu"))
    assert torch.equal(loss, torch.mean(img ** 2))
    for k in grads:
        assert torch.allclose(grads[k], ref[k], rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("name", list(CASES))
def test_backward_traces_no_ray(refs, name, monkeypatch):
    """Phase 2's replays trace their rays; the backward sweeps after them
    trace none (the tape holds the shading alone)."""
    scene, cfg, _ = refs[name]
    calls = []
    for mod, fn_name in ENTRIES:
        orig = getattr(mod, fn_name)

        def counted(*a, _orig=orig, _name=fn_name, **kw):
            calls.append(_name)
            return _orig(*a, **kw)
        monkeypatch.setattr(mod, fn_name, counted)
    during = []
    backward = torch.autograd.backward

    def watched(*a, **kw):
        before = len(calls)
        out = backward(*a, **kw)
        during.append(len(calls) - before)
        return out
    monkeypatch.setattr(torch.autograd, "backward", watched)
    mt.render_l2_grad(scene, cfg, _zero_target(cfg), seed=0, device="cpu")
    n_passes = cfg.spp // cfg.spp_per_pass
    assert during == [0] * n_passes
    # each pass: the camera rays, then a shadow and a bounce ray a bounce,
    # in phase 1 and again in phase 2
    assert len(calls) == 2 * n_passes * (1 + 2 * (cfg.max_depth - 1))


def _fd_grad(f, x, eps=2e-3):
    x = np.asarray(x, np.float64)
    g = np.zeros_like(x)
    for i in range(x.size):
        dx = np.zeros_like(x)
        dx.flat[i] = eps
        up = f(torch.tensor(x + dx, dtype=torch.float32))
        down = f(torch.tensor(x - dx, dtype=torch.float32))
        g.flat[i] = (up - down) / (2 * eps)
    return g


@pytest.mark.parametrize("name,value,atol", [
    ("left.bsdf.reflectance", [0.6, 0.1, 0.1], 1e-4),
    ("light.emitter.radiance", [18.4, 15.6, 8.0], 1e-5)])
def test_gradient_matches_finite_differences(name, value, atol):
    """tests/test_grad.py's check on the port: with a fixed seed the render
    is a deterministic function of an albedo or a radiance, which steer
    no sampling decision, so autograd and central differences agree."""
    scene = mt.cornell_box(boxes=False, device="cpu")
    cfg = mt.RenderConfig(width=12, height=12, spp=8, spp_per_pass=8,
                          max_depth=3, rr_depth=99)

    def loss(v):
        img = mt.render(mt.scene_with(scene, {name: v}), cfg, device="cpu")
        return torch.mean(img)

    v = torch.tensor(value, dtype=torch.float32, requires_grad=True)
    loss(v).backward()
    ad = v.grad.numpy()
    with torch.no_grad():
        fd = _fd_grad(lambda x: float(loss(x)), value)
    assert np.isfinite(ad).all() and np.abs(ad).max() > 1e-6
    np.testing.assert_allclose(ad, fd, rtol=0.05, atol=atol)


def test_later_tables_raise(refs):
    """The medium tables came with the media slice: a medium scene's diff
    tables carry `med_data` and, with a density grid, `med_grid`, which
    with_tables replaces; the Cornell box's carry neither (nor texels:
    tests/test_torch_texture.py)."""
    scene = refs["cornell"][0]
    assert not {"tex_data", "med_data", "med_grid"} & set(
        adjoint.diff_tables(scene))
    smoke = mt.smoke_box(4, device="cpu")
    tables = adjoint.diff_tables(smoke)
    assert tables["med_data"] is smoke.med_data
    assert tables["med_grid"] is smoke.medium_grid.data
    new = adjoint.with_tables(smoke, {**tables,
                                      "med_data": tables["med_data"] * 2,
                                      "med_grid": tables["med_grid"] + 1})
    assert torch.equal(new.med_data, smoke.med_data * 2)
    assert torch.equal(new.medium_grid.data, smoke.medium_grid.data + 1)
    assert torch.equal(new.medium_grid.bbox_min, smoke.medium_grid.bbox_min)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _textured(device):
    import chip_smoke
    from mitsuba2_tpu_torch.scene import presets
    return chip_smoke.gallery_textured(presets, 1, 32, device=device)


@pytest.mark.parametrize("name", ["cornell", "gallery", "gallery_textured"])
def test_cuda_render_l2_grad_matches_cpu(cuda, name):
    """chip_smoke.py phase 7's card-vs-CPU check: each gradient table
    within 1e-3 of the CPU's in relative norm (the textured gallery's
    texels among them), the images within phase 4's limits, and no kernel
    launched during a backward sweep."""
    mk = {"cornell": lambda d: mt.cornell_box(boxes=False, device=d),
          "gallery": lambda d: mt.mesh_gallery(subdiv=2, device=d),
          "gallery_textured": _textured}[name]
    cfg = mt.RenderConfig(width=32, height=32, spp=4, spp_per_pass=2,
                          max_depth=3, rr_depth=8)
    target = torch.zeros((32, 32, 3))
    img_c, _, g_c = mt.render_l2_grad(mk("cpu"), cfg, target, seed=3,
                                      device="cpu")
    wrappers = (traverse.cluster_closest_hit, traverse.cluster_any_hit)
    backward = torch.autograd.backward
    during = []

    def watched(*a, **kw):
        before = [w.launches for w in wrappers]
        out = backward(*a, **kw)
        torch.cuda.synchronize()
        during.append([w.launches for w in wrappers] != before)
        return out
    torch.autograd.backward = watched
    try:
        img_g, _, g_g = mt.render_l2_grad(mk(cuda), cfg, target.to(cuda),
                                          seed=3)
    finally:
        torch.autograd.backward = backward
    assert during and not any(during)
    for k in g_c:
        diff = float((g_g[k].cpu() - g_c[k]).norm())
        assert diff <= 1e-3 * float(g_c[k].norm()), k
    img_g, img_c = img_g.cpu().numpy(), img_c.numpy()
    close = np.isclose(img_g, img_c, rtol=1e-3, atol=1e-4).all(-1).mean()
    assert np.isfinite(img_g).all() and close >= 0.99
    assert abs(img_g.mean() - img_c.mean()) <= 1e-3 * img_c.mean()


def test_cuda_textured_gallery_kernels_match_twins(cuda):
    """chip_smoke.py phases 2-3 on the textured gallery (subdiv 1): K1 and
    K2 on the card bit-equal to their twins on probe rays of each kind
    (the null blob's pass-through and the mask's among their hits)."""
    from mitsuba2_tpu_torch.probe_rays import KINDS, probe_rays
    from mitsuba2_tpu_torch.core.vec import Vec3

    def planar(a, device):
        return Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])).to(
            device) for i in range(3)))

    sc = _textured("cpu")

    def closest(o, d, t_max):
        t, prim, _, _ = traverse.ray_intersect_preliminary(
            sc, planar(o, "cpu"), planar(d, "cpu"), torch.from_numpy(t_max))
        return t.numpy(), prim.numpy(), None

    rays = probe_rays(sc, 4096, 0, closest)
    st = mt.to_device(sc, cuda)
    tabs = (st.mxu_node_f, st.mxu_link, st.cluster_feat)
    for kind in KINDS:
        o, d, tm = rays[kind]
        args = (*planar(o, cuda).__dict__.values(),
                *planar(d, cuda).__dict__.values(),
                torch.from_numpy(tm).to(cuda))
        t, slot = traverse.cluster_closest_hit(*tabs, *args, st.cluster_k)
        occ = traverse.cluster_any_hit(*tabs, *args, st.cluster_k)
        t_p, slot_p = traverse.closest_hit_plain(*tabs, *args, st.cluster_k)
        occ_p = traverse.any_hit_plain(*tabs, *args, st.cluster_k)
        assert torch.equal(t, t_p) and torch.equal(slot, slot_p), kind
        assert torch.equal(occ, occ_p), kind


def test_diff_tables_and_with_tables_are_functional(refs):
    scene = refs["cornell"][0]
    tables = adjoint.diff_tables(scene)
    assert list(tables) == ["mat_data", "emitter_data"]
    new = {k: v * 2 for k, v in tables.items()}
    s2 = adjoint.with_tables(scene, new)
    assert s2 is not scene and s2.mat_data is new["mat_data"]
    assert torch.equal(scene.mat_data, tables["mat_data"])
    assert s2.prim_p0 is scene.prim_p0
