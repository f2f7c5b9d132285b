"""Veach's MIS scene and the material gallery in the PyTorch port against
the JAX package.

`veach_mis()` (four rough aluminium plates, GGX at alpha 0.005 to 0.1,
four sphere lights) and `gallery_materials` (chip_smoke.py's scene, built
from either package: mesh_gallery's blobs under conductor, roughconductor,
dielectric, roughdielectric, plastic and roughplastic, a twosided rough
aluminium quad seen from behind and a thin glass pane): tables
byte-equal; renders pixel for pixel (>= 99% within rtol 1e-3 / atol 1e-4,
the mean within rtol 1e-3) under "auto" (brute force on veach's 16
prims, the cluster walk's twins on the gallery) and, on veach, under
"pallas" (the BVH2 walk's twins, K3); the golden `veach_d3` by the
z-test; render_l2_grad's gradients on both scenes within 1e-3 in
relative norm of the JAX package's wherever its are finite. Its are NaN
in every mat_data entry of both scenes (its masked evaluate-all's NaN
derivatives, spread over whole columns by its one-hot gather adjoint):
the test runs it with each family on its own rows, as the port does,
which leaves NaN its roughness columns alone on veach and, on the
gallery, columns 24-27 (the rough families' roughness, the dielectrics'
eta); the port's gradients there are held to central differences here
and, family by family, to the JAX package's in
tests/test_torch_bsdf.py. The JAX package's renders and gradients are
committed (tests/goldens/test_torch_veach.npz); one is recomputed live.
"""
import numpy as np
import pytest
import torch

import chip_smoke
import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.diff import adjoint
from mitsuba2_tpu_torch.scene import presets as tpresets
from mitsuba2_tpu_torch.scene import scene as scene_mod
from mitsuba2_tpu_torch.scene.scene import FIELDS

from goldens.jax_refs import Refs
from test_torch_instancing import assert_port_tables, recorded_fields
from test_torch_render import GOLDEN_DIR, golden_z_test

# one intra-op thread: the suite's test processes share the cores
# (pytest-xdist), and torch's OpenMP regions stall when they
# oversubscribe them
torch.set_num_threads(1)

REFS = Refs("test_torch_veach")

VEACH = dict(width=16, height=16, spp=4, spp_per_pass=4, max_depth=3,
             rr_depth=8)
GALLERY = dict(width=16, height=16, spp=4, spp_per_pass=4, max_depth=4,
               rr_depth=8)


def _veach(device="cpu"):
    return mt.veach_mis(device=device)


def _gallery(device="cpu"):
    return chip_smoke.gallery_materials(tpresets, 1, device=device)


def _jax_fields(sj):
    return {**{k: np.asarray(getattr(sj, k)) for k in FIELDS},
            "param_paths": sj.param_paths}


def _own_rows_dispatch(JB, jnp):
    """The JAX package's leaf dispatch with each family run on rows of its
    own family (the port's bsdf._family_lanes), as (_sample_leaf,
    _eval_leaf, _pdf_leaf). Its own runs every family on every row: a
    diffuse row read as a conductor's (eta 0) gives values its selects
    discard, but NaN derivatives that its backward multiplies by the
    unselected branch's zero cotangent, and its one-hot gather adjoint
    (kernels/gather.py) then spreads each NaN lane over a whole column:
    every mat_data entry of veach_mis() is NaN in its render_and_grad."""
    from mitsuba2_tpu.core.spec import Spec, swhere
    from mitsuba2_tpu.core.vec import vwhere
    from mitsuba2_tpu.render.spectra import LaneRows as JRows

    def lanes(scene, mtype, mdata):
        for fid in JB._leaf_ids(scene):
            row = jnp.argmax(scene.mat_type == fid).astype(jnp.int32)
            sel = mtype == fid
            yield fid, sel, JRows(mdata.table, jnp.where(sel, mdata.idx, row))

    def sample_leaf(scene, mtype, mdata, si, u1, u2, config):
        bs = JB._zero_sample(mtype.shape[0])
        w = Spec.zeros((mtype.shape[0],), config.n_channels)
        for fid, sel, d in lanes(scene, mtype, mdata):
            fb, fw = JB.LEAF_FAMILIES[fid].sample(d, si, u1, u2, config)
            bs = JB.BSDFSample(
                wo=vwhere(sel, fb.wo, bs.wo),
                pdf=jnp.where(sel, fb.pdf, bs.pdf),
                eta=jnp.where(sel, fb.eta, bs.eta),
                sampled_flags=jnp.where(sel, fb.sampled_flags,
                                        bs.sampled_flags))
            w = swhere(sel, fw, w)
        return bs, w

    def eval_leaf(scene, mtype, mdata, si, wo, config):
        out = Spec.zeros((mtype.shape[0],), config.n_channels)
        for fid, sel, d in lanes(scene, mtype, mdata):
            out = swhere(sel, JB.LEAF_FAMILIES[fid].eval(d, si, wo, config),
                         out)
        return out

    def pdf_leaf(scene, mtype, mdata, si, wo, config):
        out = jnp.zeros(mtype.shape[0], jnp.float32)
        for fid, sel, d in lanes(scene, mtype, mdata):
            out = jnp.where(sel, JB.LEAF_FAMILIES[fid].pdf(d, si, wo, config),
                            out)
        return out

    return sample_leaf, eval_leaf, pdf_leaf


def _jax_l2_grad(scene, cfg):
    """The JAX package's render_l2_grad against a zero target (seed 0)
    under the own-rows dispatch (_own_rows_dispatch): image, loss and
    gradients as numpy."""
    import jax
    from mitsuba2_tpu.diff import render_l2_grad as j_l2_grad
    from mitsuba2_tpu.render import bsdf as JB
    with pytest.MonkeyPatch.context() as mp:
        for name, fn in zip(("_sample_leaf", "_eval_leaf", "_pdf_leaf"),
                            _own_rows_dispatch(JB, jax.numpy)):
            mp.setattr(JB, name, fn)
        img, loss, grads = j_l2_grad(
            scene, cfg, jax.numpy.zeros((cfg.height, cfg.width, 3),
                                        jax.numpy.float32), seed=0)
        out = (np.asarray(img), float(loss),
               {k: np.asarray(v) for k, v in grads.items()})
        jax.clear_caches()
    return out


def _jax_image(name, mode):
    import mitsuba2_tpu as mi
    from mitsuba2_tpu.scene import presets as jpresets
    scene = (jpresets.veach_mis() if name == "veach"
             else chip_smoke.gallery_materials(jpresets, 1))
    kw = VEACH if name == "veach" else GALLERY
    return np.asarray(mi.render(scene, mi.RenderConfig(
        **kw, color_mode=mode), seed=0))


def _jax_grads(name):
    import mitsuba2_tpu as mi
    from mitsuba2_tpu.scene import presets as jpresets
    scene = (jpresets.veach_mis() if name == "veach"
             else chip_smoke.gallery_materials(jpresets, 1))
    return _jax_l2_grad(scene, mi.RenderConfig(**VEACH))


@pytest.fixture(scope="module")
def refs():
    """The JAX package's scenes, its renders of veach in mono and of the
    gallery, and its render_l2_grad (_jax_l2_grad) of veach and of the
    gallery at VEACH's sizes, NaN still in some columns (see
    test_render_l2_grad_matches_jax and
    test_gallery_render_l2_grad_matches_jax). The renders and gradients
    are read from tests/goldens/test_torch_veach.npz (python
    tests/goldens/make_refs.py test_torch_veach writes it)."""
    pytest.importorskip("jax")
    from mitsuba2_tpu.scene import presets as jpresets
    scenes = {"veach": jpresets.veach_mis(),
              "gallery": chip_smoke.gallery_materials(jpresets, 1)}
    out = {"scenes": scenes, "images": {}}
    out["images"]["veach", "mono"] = REFS.get(
        "veach_mono", lambda: _jax_image("veach", "mono"))
    out["images"]["gallery", "rgb"] = REFS.get(
        "gallery_rgb", lambda: _jax_image("gallery", "rgb"))
    out["grads"] = {name: REFS.get(f"{name}_grads",
                                   lambda n=name: _jax_grads(n))
                    for name in scenes}
    # the forward is the JAX package's own: the patch moves no value
    out["images"]["veach", "rgb"] = out["grads"]["veach"][0]
    return out


def test_golden_is_fresh():
    """The golden's smallest entry, veach's mono image, recomputed now."""
    stored, live = REFS.fresh("veach_mono",
                              lambda: _jax_image("veach", "mono"))
    np.testing.assert_array_equal(stored, live)


@pytest.mark.parametrize("name,make", [("veach", _veach),
                                       ("gallery", _gallery)])
def test_tables_byte_equal(refs, name, make):
    sj = refs["scenes"][name]
    with recorded_fields() as got:
        st = make()
    assert_port_tables(_jax_fields(sj), got[0], st)
    assert st.mat_families == sj.mat_families
    assert st.has_twosided == (name == "gallery")


def _assert_image_close(img_t, img_j):
    assert img_t.shape == img_j.shape and np.isfinite(img_t).all()
    close = np.isclose(img_t, img_j, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99
    np.testing.assert_allclose(img_t.mean(), img_j.mean(), rtol=1e-3)


@pytest.mark.parametrize("backend", ["auto", "pallas"])
@pytest.mark.parametrize("mode", ["rgb", "mono"])
def test_veach_render_matches_jax(refs, backend, mode):
    """Under "auto" the 16-prim scene takes brute force; under "pallas"
    (set before the build, which uploads the walk's tables) the BVH2
    walk's twins (K3), the walk the card runs on veach_bvh2."""
    scene_mod.set_backend(backend)
    try:
        scene = _veach()
        img = mt.render(scene, mt.RenderConfig(**VEACH, color_mode=mode),
                        seed=0, device="cpu").numpy()
    finally:
        scene_mod.set_backend("auto")
    assert (scene.bvh_node is not None) == (backend == "pallas")
    _assert_image_close(img, refs["images"]["veach", mode])


def test_gallery_materials_render_matches_jax(refs):
    scene = _gallery()
    assert scene.mxu_node_f is not None        # the cluster walk's twins
    img = mt.render(scene, mt.RenderConfig(**GALLERY), seed=0,
                    device="cpu").numpy()
    _assert_image_close(img, refs["images"]["gallery", "rgb"])


def test_veach_golden():
    """tests/test_golden.py's z-test on its veach_d3 golden, with the
    port's images: the same configuration, seed and pass split."""
    ref = np.load(f"{GOLDEN_DIR}/veach_d3.npz")["image"]
    cfg = mt.RenderConfig(width=32, height=32, spp=64, spp_per_pass=64,
                          max_depth=3, rr_depth=99)
    golden_z_test(_veach(), cfg, ref)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def port_l2():
    """The port's render_l2_grad of each scene at VEACH's sizes against a
    zero target, seed 0, computed once for the module: the scene, and
    (image, loss, grads)."""
    memo = {}

    def get(name):
        if name not in memo:
            scene = _veach() if name == "veach" else _gallery()
            memo[name] = scene, mt.render_l2_grad(
                scene, mt.RenderConfig(**VEACH), torch.zeros(16, 16, 3),
                seed=0, device="cpu")
        return memo[name]
    return get


def _l2_grad_matches_jax(port, ref):
    """The port's render_l2_grad (`port`, port_l2's) at VEACH's sizes
    against the JAX package's (`ref`, _jax_l2_grad): the image, the loss
    and every gradient entry the JAX package leaves finite within 1e-3 in
    relative norm, the port's finite everywhere. Returns the port's
    gradients and the mat_data columns the JAX package leaves NaN."""
    img_j, loss_j, grads_j = ref
    img, loss, grads = port
    _assert_image_close(img.numpy(), img_j)
    np.testing.assert_allclose(float(loss), loss_j, rtol=1e-3)
    assert set(grads) == set(grads_j)
    for k, g in grads.items():
        g = g.numpy()
        assert g.shape == grads_j[k].shape and np.isfinite(g).all(), k
        fin = np.isfinite(grads_j[k])
        assert _rel(g[fin], grads_j[k][fin]) <= 1e-3, k
    nan_cols = np.nonzero(~np.isfinite(grads_j["mat_data"]).all(0))[0]
    return grads, set(nan_cols.tolist())


def _named(grads, scene, name):
    """A named parameter's gradient entries (scene.param_paths)."""
    _, table, row, c0, c1, _ = {p[0]: p for p in scene.param_paths}[name]
    return np.asarray(grads[table][row, c0:c1])


def test_render_l2_grad_matches_jax(refs, port_l2):
    """veach_mis() at 16x16, 4 spp, depth 3 (_l2_grad_matches_jax), each
    named parameter too (the floor's albedo, the plates' conductor
    colors). The JAX package's roughness columns stay NaN (its backward
    meets 0 * inf in the microfacet code on a few lanes, which its
    one-hot gather adjoint spreads over the column);
    tests/test_torch_bsdf.py's family gradients and the finite
    differences below hold the port's roughness gradients instead."""
    scene, port = port_l2("veach")
    grads, nan_cols = _l2_grad_matches_jax(port, refs["grads"]["veach"])
    grads_j = refs["grads"]["veach"][2]
    assert nan_cols <= {24, 25}             # the roughness columns alone
    # floor and back share one row (one material), the lights another
    for p in ["floor.bsdf.reflectance", "light0.bsdf.reflectance"] + [
            f"plate{i}.bsdf.{q}" for i in range(4)
            for q in ("eta", "k", "specular_reflectance")]:
        g, gj = _named(grads, scene, p), _named(grads_j, scene, p)
        assert np.abs(gj).max() > 0, p
        assert _rel(g, gj) <= 1e-3, p


# the gallery's parameters in mat_data columns 24-27, which the JAX
# package's render_l2_grad leaves NaN even under the own-rows dispatch:
# the rough families' roughness and every dielectric's eta
GALLERY_NAN = {"blob1.bsdf.alpha_u", "blob1.bsdf.alpha_v", "blob2.bsdf.eta",
               "blob3.bsdf.alpha_u", "blob3.bsdf.alpha_v", "blob3.bsdf.eta",
               "metal.bsdf.alpha_u", "metal.bsdf.alpha_v", "pane.bsdf.eta"}


def test_gallery_render_l2_grad_matches_jax(refs, port_l2):
    """gallery_materials (subdiv 1) at VEACH's sizes
    (_l2_grad_matches_jax), each named parameter whose gradient the JAX
    package leaves finite too, within 1e-3 in relative norm (zero where
    its is): the conductors' colors, the plastics' albedos and
    blob5's roughness, the dielectrics' and the pane's reflectance and
    transmittance, the walls' albedo, the light's radiance. The JAX
    package's are NaN in columns 24-27 on every row (GALLERY_NAN: 0 *
    inf in its backward on some lanes, spread over each column by its
    one-hot gather adjoint), so the eta of blob2, blob3 and the pane and
    the rough families' roughness are held to it family by family
    (tests/test_torch_bsdf.py) and, metal's alpha, to central
    differences (test_gallery_gradients_finite_and_end_to_end)."""
    scene, port = port_l2("gallery")
    grads, nan_cols = _l2_grad_matches_jax(port, refs["grads"]["gallery"])
    grads_j = refs["grads"]["gallery"][2]
    assert nan_cols <= {24, 25, 26, 27}
    held = 0
    for p in (p[0] for p in scene.param_paths):
        g, gj = _named(grads, scene, p), _named(grads_j, scene, p)
        if not np.isfinite(gj).all():
            assert p in GALLERY_NAN, p
            continue
        assert np.linalg.norm(g - gj) <= 1e-3 * np.linalg.norm(gj), p
        held += bool(np.abs(gj).max() > 0)
    assert held >= 20


def _fd(scene, cfg, name, v0, eps):
    """d mean(image^2) / d `name` by a central difference at seed 0, the
    two images' difference summed in float64 (the mean's f32 rounding
    would swamp it)."""
    def render(v):
        return mt.render(mt.scene_with(scene, {name: v}), cfg, seed=0,
                         device="cpu").double()
    with torch.no_grad():
        hi, lo = render(torch.tensor(v0 + eps)), render(torch.tensor(v0 - eps))
    return float((hi * hi - lo * lo).mean()) / (2 * eps)


@pytest.mark.parametrize("name,v0,eps", [
    ("plate0.bsdf.alpha_u", 0.005, 1e-4), ("plate0.bsdf.alpha_v", 0.005, 1e-4),
    ("plate1.bsdf.alpha_v", 0.02, 4e-4)])
def test_plate_roughness_gradients_match_finite_differences(name, v0, eps):
    """render_l2_grad's roughness gradients on veach against central
    differences at the same seed, rr_depth 99 (Russian roulette would
    step with the throughput). The roughness steers the sampled
    directions, which autograd follows, and moves the traced hits, which
    it does not (traversal is detached): within 15%."""
    scene = _veach()
    cfg = mt.RenderConfig(**{**VEACH, "rr_depth": 99})
    _, _, grads = mt.render_l2_grad(scene, cfg, torch.zeros(16, 16, 3),
                                    seed=0, device="cpu")
    row, c0, _ = {p[0]: p[2:5] for p in scene.param_paths}[name]
    ad = float(grads["mat_data"][row, c0])
    fd = _fd(scene, cfg, name, v0, eps)
    assert np.isfinite(ad) and abs(fd) > 1e-6
    np.testing.assert_allclose(ad, fd, rtol=0.15)


GALLERY_PARAMS = ["blob1.bsdf.alpha_u", "blob1.bsdf.alpha_v",
                  "blob3.bsdf.alpha_u", "blob3.bsdf.eta", "blob2.bsdf.eta",
                  "blob5.bsdf.alpha", "metal.bsdf.alpha_u",
                  "metal.bsdf.alpha_v", "pane.bsdf.eta",
                  "blob4.bsdf.diffuse_reflectance",
                  "blob0.bsdf.specular_reflectance"]


def test_gallery_gradients_finite_and_end_to_end(port_l2):
    """gallery_materials (subdiv 1) at 16x16, 4 spp, depth 3: every
    gradient entry finite (the JAX package's are NaN in every row there),
    render_l2_grad equal to plain autograd through the whole render, and
    metal.bsdf.alpha_v (the twosided quad seen from behind) within 5% of
    a central difference, and alpha_u too."""
    scene, (img, loss, grads) = port_l2("gallery")
    cfg = mt.RenderConfig(**VEACH)
    assert all(bool(g.isfinite().all()) for g in grads.values())
    tables = {k: v.clone().requires_grad_(True)
              for k, v in adjoint.diff_tables(scene).items()}
    img_e = mt.render(adjoint.with_tables(scene, tables), cfg, seed=0,
                      device="cpu")
    torch.mean(img_e ** 2).backward()
    assert torch.equal(img, img_e.detach())
    for k in grads:
        assert torch.allclose(grads[k], tables[k].grad, rtol=1e-5, atol=1e-8)
    paths = {p[0]: p[2:5] for p in scene.param_paths}
    assert all(p in paths for p in GALLERY_PARAMS)
    for name in ("metal.bsdf.alpha_u", "metal.bsdf.alpha_v"):
        row, c0, _ = paths[name]
        ad = float(grads["mat_data"][row, c0])
        np.testing.assert_allclose(ad, _fd(scene, cfg, name, 0.1, 1e-3),
                                   rtol=0.05)


def _plate_lanes(scene, name="plate0"):
    """The lanes of veach's render at VEACH's sizes (16x16, 4 spp, seed 0)
    whose camera ray hits plate `name` from its front: each lane's local
    wi, its NEE direction (the render's u_nee, u2_nee draws) in the local
    frame as wo, and its BSDF sample's u1, u2 draws, as numpy."""
    from mitsuba2_tpu_torch.render import emitters, integrators, sensors
    from mitsuba2_tpu_torch.render.sampler import make_sampler
    cfg = mt.RenderConfig(**VEACH)
    H, W, n = cfg.height, cfg.width, cfg.spp * cfg.height * cfg.width
    lane = torch.arange(n)
    sampler = make_sampler("independent", integrators.pass_seeds(0, 1)[0],
                           lane)
    pix = lane % (H * W)
    jitter, sampler = sampler.next_2d()
    ray = sensors.sample_ray(scene, sensors.film_uv(
        (pix % W).float(), (pix // W).float(), jitter, W, H))
    with torch.no_grad():
        si = scene_mod.ray_intersect(scene, ray, sort=False)
        u_nee, sampler = sampler.next_1d()
        u2_nee, sampler = sampler.next_2d()
        ds, _ = emitters.sample_direction(scene, si.p, None, u_nee, u2_nee,
                                          cfg)
        u1, sampler = sampler.next_1d()
        u2, sampler = sampler.next_2d()
    shape = [i for i, p in enumerate(scene.param_paths)
             if p[0] == f"{name}.bsdf.alpha_u"]
    assert shape
    row = {p[0]: p[2] for p in scene.param_paths}[f"{name}.bsdf.alpha_u"]
    on = (si.valid & (scene.shape_mat[si.shape.clamp_min(0).long()] == row)
          & (si.wi.z > 0)).numpy()
    wo = si.to_local(ds.d)
    v3 = lambda v: np.stack([v.x.numpy(), v.y.numpy(), v.z.numpy()], -1)
    return (v3(si.wi)[on], v3(wo)[on],
            np.stack([u1.numpy(), u2[0].numpy(), u2[1].numpy()], -1)[on],
            row)


def test_plate0_roughness_gradients_per_lane_match_jax():
    """veach_mis()'s plate0 (GGX, alpha 0.005) on the lanes of the render
    at 16x16, 4 spp that see it: d(sample weight, eval, pdf at the NEE
    direction) / d(alpha_u, alpha_v), lane by lane (each lane reads its
    own copy of plate0's row, as the family runs on its own rows), in
    float32 against the JAX package's arithmetic in float64 on the same
    float32 inputs: 99% of the lanes within 1e-3 of the lane's largest
    entry (floored at 1e-3 of the largest over all lanes), every lane
    within 2e-2; eval and pdf also against the JAX package's float32. The
    sample weight's roughness derivative is a difference of terms of size
    1/alpha: in float32 the JAX package's is within 1e-3 of its float64
    on 16% of these lanes (13% off at worst), the port's was on 3% (120%
    off), so the port samples this family in float64."""
    import jax
    import jax.numpy as jnp
    import mitsuba2_tpu as mi
    from mitsuba2_tpu.core.vec import Vec3 as JVec3
    from mitsuba2_tpu.render import bsdf as JB
    from mitsuba2_tpu.render.spectra import LaneRows as JRows
    from mitsuba2_tpu_torch.core.vec import Vec3
    from mitsuba2_tpu_torch.render import bsdf as B
    from mitsuba2_tpu_torch.render.spectra import LaneRows
    from test_torch_bsdf import _si_j, _si_t
    scene = _veach()
    wi, wo, u, row = _plate_lanes(scene)
    n = wi.shape[0]
    assert n >= 64
    rows = np.repeat(scene.mat_data.numpy()[row:row + 1], n, 0)
    fid = int(scene.mat_type[row])

    def jax_grads(dt):
        fam, cfg = JB.FAMILIES[fid], mi.RenderConfig()
        idx = jnp.arange(n, dtype=jnp.int32)

        def outs(table):
            si = _si_j(jnp.asarray(wi, dt), idx)
            w = JVec3.from_array(jnp.asarray(wo, dt))
            uj = jnp.asarray(u, dt)
            data = JRows(table, idx)
            bs, wt = fam.sample(data, si, uj[:, 0], (uj[:, 1], uj[:, 2]),
                                cfg)
            return (sum(jnp.sum(c) for c in wt.ch),
                    sum(jnp.sum(c) for c in fam.eval(data, si, w, cfg).ch),
                    jnp.sum(fam.pdf(data, si, w, cfg)) + jnp.sum(bs.pdf))
        g = jax.jit(lambda tb: tuple(jax.grad(lambda x, k=k: outs(x)[k])(tb)
                                     for k in range(3)))(jnp.asarray(rows,
                                                                     dt))
        return [np.asarray(a, np.float64)[:, 24:26] for a in g]
    def both():
        g_32 = jax_grads(jnp.float32)
        with jax.enable_x64(True):
            return g_32, jax_grads(jnp.float64)
    g_32, g_64 = REFS.get("plate0_lane_grads", both)
    fam, cfg = B.FAMILIES[fid], mt.RenderConfig()
    si = _si_t(wi, np.zeros(n, np.int32))
    ut = torch.from_numpy(u)
    w = Vec3(*torch.from_numpy(np.ascontiguousarray(wo.T)))

    def err(a, b):
        scale = np.maximum(np.abs(b).max(-1, keepdims=True),
                           1e-3 * np.abs(b).max())
        e = (np.abs(a - b) / scale).max(-1)
        return float((e <= 1e-3).mean()), float(e.max())
    worst = []
    for k in range(3):
        table = torch.from_numpy(rows).requires_grad_(True)
        data = LaneRows(table, torch.arange(n))
        bs, wt = fam.sample(data, si, ut[:, 0], (ut[:, 1], ut[:, 2]), cfg)
        out = (sum(wt.ch), sum(fam.eval(data, si, w, cfg).ch),
               fam.pdf(data, si, w, cfg) + bs.pdf)[k].sum()
        a = torch.autograd.grad(out, table)[0].numpy()[:, 24:26]
        assert np.isfinite(a).all() and np.abs(g_64[k]).max() > 0, k
        worst.append((k, "float64", *err(a, g_64[k])))
        if k:
            worst.append((k, "float32", *err(a, g_32[k])))
    assert all(frac >= 0.99 and mx <= 2e-2 for *_, frac, mx in worst), worst
