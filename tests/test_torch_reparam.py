"""Reparameterized gradients (config 5) in the PyTorch port against the
JAX package: ray_intersect_positions, refresh_mxu_feat, the Loubet warp
(diff/reparam.py), render_direct_reparam and RenderConfig(reparam=True)
on the camera, NEE and BSDF directions, with the occluder-translation
gradients of tests/test_reparam.py's two scenes (chip_smoke's
occluder_scene and shadow_scene, built from either package).

The JAX package's gradients and renders of those scenes compile for a
minute or more on a CPU: tests/goldens/reparam.npz holds them, written
by tests/goldens/make_reparam.py (rerun it after changing a scene, a
config or the warp sites below). The cheap references (positions, the
refreshed tables) run live, once per module.

Tolerances:
- ray_intersect_positions against the port's own si.p, si.t, si.valid:
  bit-equal on every valid lane, p's gradient too; against the JAX
  package's: rtol/atol 1e-5 (tests/test_follow_positions.py's), valid
  masks equal; d(sum p.x)/d(shift) within 1e-4;
- the refreshed tables byte-equal to the JAX package's refresh;
- V within 1e-6, det's primal exactly 1, the gradient of sum(det * g)
  within 1e-3 relative;
- images within atol 1e-5 (tests/test_reparam.py's);
- occluder gradients within 1e-3 relative of the JAX package's, and
  inside the JAX tests' finite-difference bands.
"""
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch import convert
from mitsuba2_tpu_torch.core.geometry import Ray
from mitsuba2_tpu_torch.core.vec import Vec3
from mitsuba2_tpu_torch.diff import reparam
from mitsuba2_tpu_torch.scene import presets as tpresets
from mitsuba2_tpu_torch.scene import scene as scene_mod

from test_torch_render import GOLDEN_DIR

OCC_CFG = dict(width=32, height=32, spp=4, spp_per_pass=4, max_depth=1)
OCC_EPS = 0.03
SHADOW_CFG = dict(width=24, height=24, spp=16, spp_per_pass=16,
                  max_depth=2)
SHADOW_EPS = 0.04
SHADOW_RENDER = dict(width=16, height=16, spp=4, spp_per_pass=4,
                     max_depth=3)
WARP_KS = (16, 4)
WARP_N = 256
FOLLOW = dict(n=256, seed=3)


def warp_sites(weights=False):
    """Two warp sites of WARP_N lanes on shadow_scene, as numpy (o, d)
    pairs: rays from above the occluder down to the floor, and rays from
    floor points up to the light; many graze the occluder's edges. With
    `weights`, each site's fixed lane weights g instead."""
    rng = np.random.default_rng(18)
    n = WARP_N
    if weights:
        return [rng.normal(size=n).astype(np.float32) for _ in range(2)]
    floor = np.stack([rng.uniform(-0.2, 0.9, n), np.full(n, 1e-3),
                      rng.uniform(-0.35, 0.35, n)], -1)
    o_a = np.broadcast_to([0.3, 1.9, 0.05], (n, 3))
    light = np.stack([0.25 + rng.uniform(-0.12, 0.12, n), np.full(n, 2.0),
                      rng.uniform(-0.12, 0.12, n)], -1)
    sites = []
    for o, tgt in ((o_a, floor), (floor, light)):
        d = tgt - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        sites.append((np.asarray(o, np.float32), d.astype(np.float32)))
    return sites


def follow_rays(lo, hi, n, seed):
    """tests/test_follow_positions.py's _rays: origins about the scene's
    center, directions uniform on the sphere, as numpy (n, 3) arrays."""
    rng = np.random.default_rng(seed)
    c = 0.5 * (lo + hi)
    ext = float(np.linalg.norm(hi - lo))
    o = c + rng.normal(size=(n, 3)) * 0.1 * ext
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.fixture(scope="module")
def golden():
    """tests/goldens/reparam.npz, checked against this file's configs."""
    import json
    ref = dict(np.load(f"{GOLDEN_DIR}/reparam.npz"))
    cfg = json.loads(str(ref["config"]))
    assert cfg == json.loads(json.dumps(dict(
        occ=OCC_CFG, shadow=SHADOW_CFG, shadow_render=SHADOW_RENDER,
        occ_eps=OCC_EPS, shadow_eps=SHADOW_EPS, warp_ks=WARP_KS,
        follow=FOLLOW))), "rerun tests/goldens/make_reparam.py"
    return ref


def _jax_pkg():
    from mitsuba2_tpu.scene import presets as jpresets
    return jpresets


def _t3(a):
    a = torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).T))
    return Vec3(a[0], a[1], a[2])


def _np3(v):
    return np.stack([np.asarray(c.detach()) for c in (v.x, v.y, v.z)], -1)


def _moved(scene, rows, theta):
    """The scene with prim_p0 of `rows` shifted by theta along x (the JAX
    tests' `_translated`)."""
    mask = torch.zeros(scene.n_prims, dtype=torch.bool)
    mask[torch.as_tensor(rows)] = True
    shift = torch.stack([theta, torch.zeros_like(theta),
                         torch.zeros_like(theta)])
    return dataclasses.replace(
        scene, prim_p0=scene.prim_p0 + mask[:, None] * shift[None])


def _grad(loss, theta0=0.0):
    """d loss / d theta at theta0; 0 where the loss does not depend on it
    (autograd records no tape then, as plain AD of visibility reads)."""
    theta = torch.tensor(theta0, requires_grad=True)
    out = loss(theta)
    if not out.requires_grad:
        return 0.0
    g, = torch.autograd.grad(out, theta, allow_unused=True)
    return 0.0 if g is None else float(g)


def _fd(loss, eps):
    with torch.no_grad():
        return (float(loss(torch.tensor(eps)))
                - float(loss(torch.tensor(-eps)))) / (2 * eps)


# ---------------------------------------------------------------------------
# ray_intersect_positions
# ---------------------------------------------------------------------------

def _pkg(which):
    from test_torch_spheres import package
    return package(which)


def _preset(pkg, name, **kw):
    """A preset of either package, the port's on the CPU."""
    if pkg.presets.__name__.startswith("mitsuba2_tpu_torch"):
        kw["device"] = "cpu"
    return getattr(pkg.presets, name)(**kw)


def _sphere_field(pkg):
    from test_torch_spheres import sphere_field
    return sphere_field(pkg, 6, 2)


POSITION_SCENES = {
    # brute force
    "cornell": (lambda pkg: _preset(pkg, "cornell_box"), None),
    # the cluster walk (K1's twin)
    "gallery": (lambda pkg: _preset(pkg, "mesh_gallery", subdiv=2), None),
    # the instanced cluster walk (K5's twin)
    "instanced": (lambda pkg: _preset(pkg, "instanced_field", n=6,
                                      subdiv=2), "0"),
    # the BVH2 walk with spheres (K3's twin), and instanced (K4's)
    "spheres": (_sphere_field, None),
    "spheres_instanced": (_sphere_field, "0"),
}


def _build(name, which):
    from test_torch_instancing import flatten_mode
    make, mode = POSITION_SCENES[name]
    with flatten_mode(mode):
        return make(_pkg(which))


@pytest.fixture(scope="module", params=sorted(POSITION_SCENES))
def positions(request):
    """(name, the port's scene, its rays, the JAX package's (p, t, valid)
    on them)."""
    from mitsuba2_tpu.core.geometry import Ray as JRay
    from mitsuba2_tpu.core.vec import Vec3 as JVec3
    from mitsuba2_tpu.scene import scene as jscene
    sj, st = _build(request.param, "jax"), _build(request.param, "port")
    o, d = follow_rays(np.asarray(sj.bvh_min)[0], np.asarray(sj.bvh_max)[0],
                       n=512, seed=0)
    p, t, valid = jscene.ray_intersect_positions(
        sj, JRay.make(JVec3(*o.T), JVec3(*d.T)))
    ref = (np.stack([np.asarray(c) for c in (p.x, p.y, p.z)], -1),
           np.asarray(t), np.asarray(valid))
    return request.param, st, (o, d), ref


def test_positions_equal_the_shading_record(positions):
    """p, t and valid bit-equal to ray_intersect's si.p, si.t, si.valid on
    every valid lane, and p's gradient with respect to the geometry
    tables (and inst_fwd on an instanced scene) bit-equal to si.p's."""
    name, st, (o, d), _ = positions
    tables = ["prim_p0", "prim_e1"] + (["inst_fwd"] if st.has_instances
                                       else [])
    w = torch.from_numpy(np.random.default_rng(1).normal(
        size=(3, o.shape[0])).astype(np.float32))
    grads, outs = [], []
    for fn in ("positions", "si"):
        leaves = {k: getattr(st, k).clone().requires_grad_(True)
                  for k in tables}
        s = dataclasses.replace(st, **leaves)
        ray = Ray.make(_t3(o), _t3(d))
        if fn == "positions":
            p, t, valid = scene_mod.ray_intersect_positions(s, ray)
        else:
            si = scene_mod.ray_intersect(s, ray)
            p, t, valid = si.p, si.t, si.valid
        outs.append((_np3(p), t.detach().numpy(), valid.numpy()))
        loss = sum((torch.where(valid, c, 0.0) * w[i]).sum()
                   for i, c in enumerate((p.x, p.y, p.z)))
        grads.append(torch.autograd.grad(loss, list(leaves.values())))
    (p1, t1, v1), (p2, t2, v2) = outs
    assert v1.any() and np.array_equal(v1, v2), name
    assert np.array_equal(p1[v1], p2[v1]) and np.array_equal(t1[v1], t2[v1])
    for a, b in zip(*grads):
        assert torch.equal(a, b) and bool(a.abs().max() > 0), name


def test_positions_match_jax(positions):
    """The JAX package's ray_intersect_positions on the same rays: valid
    masks equal, p and t within rtol/atol 1e-5 where valid."""
    name, st, (o, d), (pj, tj, vj) = positions
    p, t, valid = scene_mod.ray_intersect_positions(
        st, Ray.make(_t3(o), _t3(d)))
    v = valid.numpy()
    assert np.array_equal(v, vj), name
    np.testing.assert_allclose(_np3(p)[v], pj[v], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t.numpy()[v], tj[v], rtol=1e-5)


def test_positions_follow_geometry(golden):
    """d(sum p.x) / d(a shift of every vertex) on the Cornell box
    (tests/test_follow_positions.py's contract) equal to the JAX
    package's within 1e-4: the hits follow an x-translation."""
    st = mt.cornell_box(device="cpu")
    o, d = follow_rays(st.bvh_min[0].numpy(), st.bvh_max[0].numpy(),
                       **FOLLOW)
    ray = Ray.make(_t3(o), _t3(d))
    shift = torch.zeros(3, requires_grad=True)
    s = dataclasses.replace(st, prim_p0=st.prim_p0 + shift[None, :])
    p, _, valid = scene_mod.ray_intersect_positions(s, ray)
    g, = torch.autograd.grad(torch.where(valid, p.x, 0.0).sum(), shift)
    assert float(g[0]) > 0
    np.testing.assert_allclose(g.numpy(), golden["follow_grad"], rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# refresh_mxu_feat
# ---------------------------------------------------------------------------

def _blob_shift(n_prims, shapes, blob, vec):
    """A (P, 3) shift of `vec` on the prims of shape `blob`, zero else."""
    out = np.zeros((n_prims, 3), np.float32)
    out[np.asarray(shapes) == blob] = vec
    return out


def test_refresh_mxu_feat_matches_jax():
    """mesh_gallery(subdiv=1) with every vertex shifted and one blob moved
    further: the refreshed plane rows (plane_rows, the JAX layout),
    mxu_node_f and mxu_ccs byte-equal to the JAX package's
    refresh_mxu_feat; cluster_feat equal to slot_major_feat of the JAX
    package's rows; the boxes and slot counts as built. Then K1's twin on
    the refreshed scene against the JAX package's BVH2 oracle
    (traverse_jnp, which reads prim_p0 live) on the moved scene: on every
    lane the oracle hits, the same prim and t within 1e-5; the twin hits
    4 more of the 4 096 (2.5e-3 allowed): the boxes are not refit, and
    stale boxes cull the BVH2 and the cut tree differently (out of
    contract in tests/test_traverse_pallas.py too). The stale tables
    miss the move by as much as it is."""
    import jax.numpy as jnp
    from mitsuba2_tpu.kernels import traverse_jnp
    from mitsuba2_tpu.scene import presets as jpresets
    from mitsuba2_tpu.scene.scene import refresh_mxu_feat as j_refresh
    from mitsuba2_tpu_torch.kernels import traverse
    sj = jpresets.mesh_gallery(subdiv=1)
    st = mt.mesh_gallery(subdiv=1, device="cpu")
    blob = int(np.asarray(sj.prim_shape).max())
    shift = _blob_shift(st.n_prims, st.prim_shape.numpy(), blob,
                        [0.0, 0.004, 0.0]) + np.float32([1e-3, -2e-3, 5e-4])
    rj = j_refresh(sj.replace(prim_p0=sj.prim_p0 + jnp.asarray(shift)))
    moved = dataclasses.replace(
        st, prim_p0=st.prim_p0 + torch.from_numpy(shift))
    rt = scene_mod.refresh_mxu_feat(moved)
    feat, _ = scene_mod.plane_rows(moved)
    assert np.array_equal(feat.numpy(), np.asarray(rj.mxu_feat))
    for k in ("mxu_node_f", "mxu_ccs"):
        assert np.array_equal(getattr(rt, k).numpy(), np.asarray(
            getattr(rj, k))), k
    assert np.array_equal(rt.cluster_feat.numpy(), convert.slot_major_feat(
        np.asarray(rj.mxu_feat), st.cluster_k))
    assert not np.array_equal(rt.cluster_feat.numpy(),
                              st.cluster_feat.numpy())
    for k in ("bvh_min", "bvh_max", "mxu_ccount", "mxu_link"):
        assert torch.equal(getattr(rt, k), getattr(st, k)), k

    o, d, tmax = _camera_rays(st, 4096, seed=2)
    tj, pj, _, _ = traverse_jnp.ray_intersect_preliminary(
        rj, *(_jv3(a) for a in (o, d)), jnp.asarray(tmax.numpy()))
    tj, pj = np.asarray(tj), np.asarray(pj)
    for s, fresh in ((rt, True), (moved, False)):
        t, prim, _, _ = traverse.ray_intersect_preliminary(s, o, d, tmax)
        t, prim = t.numpy(), prim.numpy()
        hit = np.isfinite(tj)
        same = hit & (prim == pj)
        if not fresh:
            on_blob = same & (np.asarray(sj.prim_shape)[np.maximum(pj, 0)]
                              == blob)
            assert on_blob.any()
            assert np.abs(t[on_blob] - tj[on_blob]).max() > 1e-3
            continue
        assert same.sum() == hit.sum()
        assert (np.isfinite(t) != hit).mean() <= 2.5e-3
        np.testing.assert_allclose(t[same], tj[same], rtol=1e-5, atol=1e-6)


def _jv3(v):
    import jax.numpy as jnp
    from mitsuba2_tpu.core.vec import Vec3 as JVec3
    return JVec3(*(jnp.asarray(c.numpy()) for c in (v.x, v.y, v.z)))


def _camera_rays(scene, n, seed):
    """n camera rays through uniform film points: (o, d, t_max)."""
    from mitsuba2_tpu_torch.render import sensors
    from mitsuba2_tpu_torch.core.vec import Vec2
    uv = torch.from_numpy(np.random.default_rng(seed).uniform(
        size=(2, n)).astype(np.float32))
    ray = sensors.sample_ray(scene, Vec2(uv[0], uv[1]))
    return ray.o, ray.d, ray.maxt


@pytest.mark.parametrize("backend", ["pallas", "bvh8", "bvh8mxu"])
def test_refresh_rebuilds_the_walk_tables(backend):
    """The other walks' tables: the BVH2 walk's (sphere field) and the
    BVH8 walk's prim rows (bvh_prim) equal to convert.prim_rows of the
    moved tables, and the cut tree's BVH8 cluster leaves' centroids
    (bvh8c_child cols 8:11, K7's) the refreshed cluster centroids; the
    walk on the refreshed scene then finds the moved prims where brute
    force does: the same prim on 99% of brute force's hit lanes (99.88%
    under the BVH8 walks, whose stale boxes cull some moved hits), t
    within 1e-5 there."""
    from mitsuba2_tpu_torch.kernels import brute
    try:
        scene_mod.set_backend("auto" if backend == "pallas" else backend)
        st = (_sphere_field(_pkg("port")) if backend == "pallas"
              else mt.mesh_gallery(subdiv=2, device="cpu"))
        shift = np.float32([2e-3, 1e-3, -1e-3])
        moved = dataclasses.replace(
            st, prim_p0=st.prim_p0 + torch.from_numpy(shift))
        rt = scene_mod.refresh_mxu_feat(moved)
        if backend == "bvh8mxu":
            _, cl_c = scene_mod.plane_rows(moved)
            leaf = rt.bvh8c_child[:, 6] >= 0
            slot = rt.bvh8c_child[leaf, 6].long() // st.cluster_k
            assert torch.equal(rt.bvh8c_child[leaf, 8:11], cl_c[slot])
            assert torch.equal(rt.bvh8c_child[~leaf], st.bvh8c_child[~leaf])
        else:
            assert torch.equal(rt.bvh_prim, convert.prim_rows(
                {k: getattr(moved, k) for k in ("prim_p0", "prim_e1",
                                                "prim_e2", "prim_type")}))
        o, d, tmax = _camera_rays(st, 2048, seed=4)
        t, prim = scene_mod._preliminary_dispatch(
            rt, Ray(o=o, d=d, maxt=tmax))[:2]
        tb, pb = brute.ray_intersect_brute(rt, o, d, tmax)[:2]
        hit = torch.isfinite(tb)
        same = hit & (prim == pb)
        assert int(same.sum()) >= 0.99 * int(hit.sum()) > 0
        np.testing.assert_allclose(t[same].numpy(), tb[same].numpy(),
                                   rtol=1e-5, atol=1e-6)
    finally:
        scene_mod.set_backend("auto")


# ---------------------------------------------------------------------------
# The warp
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shadow():
    """chip_smoke.shadow_scene on the CPU and its occluder's rows."""
    return chip_smoke.shadow_scene(tpresets, device="cpu")


def _warp_sites_t():
    return [(_t3(o), _t3(d)) for o, d in warp_sites()]


@pytest.mark.parametrize("k", WARP_KS)
def test_warp_matches_jax(golden, shadow, k):
    """warp_and_divergence_multi on warp_sites' two sites of shadow_scene:
    each site's V within 1e-5 of the JAX package's, det's primal exactly
    1, and d sum(det * g) / d(the occluder's x) within 1e-3 relative of
    the JAX package's, for K = 16 and K = 4. V is held to 1e-6 on the
    same inputs below (test_warp_closed_form_matches_jvp): here the
    auxiliary directions are each package's own, whose last bits differ
    (XLA's rsqrt on the CPU is an approximation, torch's 1 / sqrt; they
    differ on a third of the inputs), and the kernel's KAPPA = 5000
    turns a direction's 6e-8 into 3e-4 of a weight: 10-55% of the lanes
    are within 1e-6, every one within 7e-6."""
    scene, rows = shadow
    sites = _warp_sites_t()
    with torch.no_grad():
        out = reparam.warp_and_divergence_multi(scene, sites, k)
    for i, (V, det) in enumerate(out):
        np.testing.assert_allclose(_np3(V), golden[f"warp_V{i}_k{k}"],
                                   rtol=0, atol=1e-5)
        assert torch.equal(det, torch.ones_like(det))
        assert np.array_equal(det.numpy(), golden[f"warp_det{i}_k{k}"])
    gs = [torch.from_numpy(g) for g in warp_sites(weights=True)]

    def f(theta):
        return sum((det * g).sum() for (_, det), g in zip(
            reparam.warp_and_divergence_multi(
                _moved(scene, rows, theta), sites, k), gs))
    g = _grad(f)
    ref = float(golden[f"warp_grad_k{k}"])
    assert abs(ref) > 1.0
    np.testing.assert_allclose(g, ref, rtol=1e-3)


def _jax_warp(omega, h, dirs):
    """The JAX package's warp V(w) (diff/reparam.py's closure in
    warp_and_divergence_multi, its K terms in turn) over (K, N) arrays."""
    import jax.numpy as jnp
    from mitsuba2_tpu.core.vec import Vec3 as JVec3, vdot, vnormalize
    kappa = jnp.float32(reparam.KAPPA)
    k = omega.shape[0]
    om = [JVec3(*(omega[j, :, c] for c in range(3))) for j in range(k)]
    dk = [JVec3(*(dirs[j, :, c] for c in range(3))) for j in range(k)]

    def V(w):
        num = JVec3.zeros(jnp.shape(w.z))
        den = jnp.zeros(jnp.shape(w.z), jnp.float32)
        for j in range(k):
            wk = jnp.exp(jnp.maximum(kappa * (vdot(w, dk[j]) - 1.0),
                                     -30.0)) * h[j]
            num = num + om[j] * wk
            den = den + wk
        return vnormalize(num * (1.0 / jnp.maximum(den, 1e-20)))
    return V


def test_warp_closed_form_matches_jvp():
    """The port's V and its two directional derivatives (diff/reparam.py's
    closed form) against the JAX package's V and jax.jvp on the same (K,
    N) inputs: V within 1e-6; each probe within 1e-3 of its lane's
    largest entry (floored at 1e-4 of the largest of all), 1e-2 on the
    lanes whose aux directions lie past the kernel's exp(-30) floor: the
    kernel's exponent KAPPA (d0 . d_k - 1) cancels, and an ulp of the dot
    product, which XLA's fused multiply-adds round otherwise, is 3e-4 of
    a weight's derivative; and the gradients of sum(g . dV) with respect
    to the followed directions omega (what a geometry gradient flows
    through) within 1e-5 relative (2.3e-7 measured), the JAX package's by
    reverse mode over jvp."""
    import jax
    import jax.numpy as jnp
    from mitsuba2_tpu.core.vec import Vec3 as JVec3
    rng = np.random.default_rng(5)
    k, n = 8, 512
    d0 = rng.normal(size=(n, 3))
    d0 /= np.linalg.norm(d0, axis=1, keepdims=True)
    spread = np.where(np.arange(n) < n // 8, 0.2, 0.04)[None, :, None]
    dirs = d0[None] + rng.normal(size=(k, n, 3)) * spread
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    omega = dirs + rng.normal(size=(k, n, 3)) * 0.01
    omega /= np.linalg.norm(omega, axis=-1, keepdims=True)
    h = rng.uniform(0.1, 20.0, size=(k, n))
    d0, dirs, omega, h = (a.astype(np.float32) for a in (d0, dirs, omega, h))
    t1 = np.cross(d0, [0.0, 0.0, 1.0])
    t1 /= np.linalg.norm(t1, axis=1, keepdims=True)
    t2 = np.cross(d0, t1).astype(np.float32)
    t1 = t1.astype(np.float32)
    g = rng.normal(size=(2, n, 3)).astype(np.float32)

    def jv(a):
        return JVec3(*(jnp.asarray(a[..., c]) for c in range(3)))

    def probes(om):
        V = _jax_warp(om, jnp.asarray(h), jnp.asarray(dirs))
        V0, dV1 = jax.jvp(V, (jv(d0),), (jv(t1),))
        _, dV2 = jax.jvp(V, (jv(d0),), (jv(t2),))
        return V0, dV1, dV2

    V0j, dV1j, dV2j = probes(jnp.asarray(omega))

    def jloss(om):
        _, a, b = probes(om)
        return sum(jnp.sum(getattr(v, c) * g[i, :, j])
                   for i, v in enumerate((a, b)) for j, c in enumerate("xyz"))
    gj = np.asarray(jax.grad(jloss)(jnp.asarray(omega)))

    om_t = torch.from_numpy(omega).requires_grad_(True)
    V0, (dV1, dV2) = reparam._warp(
        Vec3(*om_t.unbind(-1)), torch.from_numpy(h),
        Vec3(*torch.from_numpy(dirs).unbind(-1)),
        _t3(d0), (_t3(t1), _t3(t2)))

    def j3(v):
        return np.stack([np.asarray(c) for c in (v.x, v.y, v.z)], -1)
    np.testing.assert_allclose(_np3(V0), j3(V0j), rtol=0, atol=1e-6)
    for a, b in ((dV1, dV1j), (dV2, dV2j)):
        b = j3(b)
        scale = np.maximum(np.abs(b).max(-1, keepdims=True),
                           1e-4 * np.abs(b).max())
        err = (np.abs(_np3(a) - b) / scale).max(-1)
        assert err[n // 8:].max() <= 1e-3 and err.max() <= 1e-2
    loss = sum((getattr(v, c) * torch.from_numpy(g[i, :, j])).sum()
               for i, v in enumerate((dV1, dV2)) for j, c in enumerate("xyz"))
    gt, = torch.autograd.grad(loss, om_t)
    assert np.linalg.norm(gt.numpy() - gj) <= 1e-5 * np.linalg.norm(gj)


def test_kaux_below_one_is_refused(shadow):
    with pytest.raises(ValueError, match="reparam_kaux=0"):
        mt.RenderConfig(reparam=True, reparam_kaux=0)
    mt.RenderConfig(reparam_kaux=0)          # inert without reparam
    with pytest.raises(ValueError, match="needs >= 1 auxiliary ray"):
        reparam.warp_and_divergence_multi(shadow[0], _warp_sites_t(), 0)


def test_warp_chunks_give_the_same_warp(shadow, monkeypatch):
    """MI_REPARAM_CHUNK: brute force's default chunks, one batch (0) and
    chunks of one ray each give the same warp, bit for bit, and the same
    gradient within 1e-6 (the backward adds the chunks' parts in another
    order)."""
    scene, rows = shadow
    sites = _warp_sites_t()
    out = []
    for cap in (None, "0", str(WARP_N)):
        if cap is None:
            monkeypatch.delenv(reparam.CHUNK_VAR, raising=False)
        else:
            monkeypatch.setenv(reparam.CHUNK_VAR, cap)
        theta = torch.tensor(0.0, requires_grad=True)
        res = reparam.warp_and_divergence_multi(
            _moved(scene, rows, theta), sites, 4)
        g, = torch.autograd.grad(sum(det.sum() for _, det in res), theta)
        out.append((torch.stack([_np3_t(V) for V, _ in res]), g))
    for V, g in out[1:]:
        assert torch.equal(V, out[0][0])
        np.testing.assert_allclose(float(g), float(out[0][1]), rtol=1e-6)


def _np3_t(v):
    return torch.stack([v.x.detach(), v.y.detach(), v.z.detach()], -1)


# ---------------------------------------------------------------------------
# Renders
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def occluder():
    return chip_smoke.occluder_scene(tpresets, device="cpu")


def test_scenes_match_the_jax_tests():
    """chip_smoke's builders over the JAX package give tests/test_reparam.py's
    scenes, table for table."""
    import test_reparam
    from mitsuba2_tpu.scene import presets as jpresets
    for mine, theirs in ((chip_smoke.occluder_scene, test_reparam
                          ._occluder_scene), (chip_smoke.shadow_scene,
                                              test_reparam._shadow_scene)):
        (a, ra), (b, rb) = mine(jpresets), theirs()
        assert np.array_equal(ra, np.asarray(rb))
        for k in scene_mod.FIELDS:
            assert np.array_equal(np.asarray(getattr(a, k)),
                                  np.asarray(getattr(b, k))), k


def test_render_direct_reparam_matches_jax_and_plain(golden, occluder):
    """render_direct_reparam on the occluder scene (tests/test_reparam.py's
    forward case): the JAX package's image, and the port's plain render
    at max_depth 1, within atol 1e-5."""
    scene, _ = occluder
    cfg = mt.RenderConfig(**OCC_CFG)
    img = reparam.render_direct_reparam(scene, cfg, device="cpu")
    np.testing.assert_allclose(img.numpy(), golden["occ_image_reparam"],
                               atol=1e-5)
    np.testing.assert_allclose(
        img.numpy(), mt.render(scene, cfg, device="cpu").numpy(), atol=1e-5)
    np.testing.assert_allclose(golden["occ_image_plain"],
                               golden["occ_image_reparam"], atol=1e-5)


def test_reparam_leaves_the_path_render_unchanged(golden, shadow):
    """reparam=True at 16x16, 4 spp, depth 3 on the shadow scene: within
    1e-5 of reparam=False and of the JAX package's reparam render."""
    scene, _ = shadow
    cfg = mt.RenderConfig(**SHADOW_RENDER)
    img = mt.render(scene, cfg.replace(reparam=True), device="cpu").numpy()
    plain = mt.render(scene, cfg, device="cpu").numpy()
    assert img.mean() > 0
    np.testing.assert_allclose(img, plain, atol=1e-5)
    np.testing.assert_allclose(plain, golden["shadow_image_plain"], atol=1e-5)
    np.testing.assert_allclose(img, golden["shadow_image_reparam"],
                               atol=1e-5)


def test_reparam_spectral_matches_jax(golden, shadow):
    """The reparameterized path in spectral mode (the JAX package's
    tests/test_integrator_variants.py combination) on the shadow scene:
    the JAX package's image within 1e-5."""
    scene, _ = shadow
    cfg = mt.RenderConfig(**SHADOW_RENDER, reparam=True,
                          color_mode="spectral")
    img = mt.render(scene, cfg, device="cpu").numpy()
    assert np.isfinite(img).all() and img.max() > 0
    np.testing.assert_allclose(img, golden["shadow_image_reparam_spectral"],
                               atol=1e-5)


def _occluder_loss(scene, rows, reparam_on):
    cfg = mt.RenderConfig(**OCC_CFG)

    def loss(theta):
        s = _moved(scene, rows, theta)
        img = (reparam.render_direct_reparam(s, cfg, device="cpu")
               if reparam_on else mt.render(s, cfg, device="cpu"))
        return img.mean()
    return loss


def _shadow_loss(scene, rows, reparam_on):
    cfg = mt.RenderConfig(**SHADOW_CFG, reparam=reparam_on)

    def loss(theta):
        return mt.render(_moved(scene, rows, theta), cfg,
                         device="cpu").mean()
    return loss


@pytest.mark.parametrize("name,make_loss,eps,band", [
    ("occ", _occluder_loss, OCC_EPS, (0.5, 2.0)),
    ("shadow", _shadow_loss, SHADOW_EPS, (0.4, 2.5))])
def test_occluder_translation_gradients(golden, occluder, shadow, name,
                                        make_loss, eps, band):
    """tests/test_reparam.py's two gradient cases in the port: the
    occluder's translation through primary visibility
    (render_direct_reparam) and through the second vertex's shadow edge
    (reparam=True, depth 2). The reparameterized gradient within 1e-3
    relative of the JAX package's, of the central difference's sign and
    within the JAX tests' band of its size; plain autograd under 0.25 of
    it, as the JAX package's (0)."""
    scene, rows = occluder if name == "occ" else shadow
    fd = _fd(make_loss(scene, rows, False), eps)
    np.testing.assert_allclose(fd, golden[f"{name}_fd"], rtol=1e-3)
    assert abs(fd) > 1e-3
    plain = _grad(make_loss(scene, rows, False))
    rep = _grad(make_loss(scene, rows, True))
    assert abs(plain) < 0.25 * abs(fd) and plain == golden[f"{name}_plain"]
    np.testing.assert_allclose(rep, golden[f"{name}_reparam"], rtol=1e-3)
    assert np.sign(rep) == np.sign(fd)
    assert band[0] * abs(fd) < abs(rep) < band[1] * abs(fd), (rep, fd)


def test_tape_only_where_a_table_requires_grad(shadow, monkeypatch):
    """The render records a tape exactly when a tensor of the scene
    requires grad and grad is enabled (prim_p0 here, which diff_tables
    does not name), and its geometry gathers' backward goes through
    _LaneGather (no index_put_ accumulation); with nothing to
    differentiate, or under no_grad, it runs in inference mode. On an
    instanced scene inst_fwd alone records one too."""
    from mitsuba2_tpu_torch.render import integrators
    from test_torch_instancing import flatten_mode
    scene, rows = shadow
    cfg = mt.RenderConfig(**SHADOW_RENDER, reparam=True)
    modes = []
    render_pass = integrators.render_pass

    def spy(*a, **kw):
        modes.append(torch.is_inference_mode_enabled())
        return render_pass(*a, **kw)
    monkeypatch.setattr(integrators, "render_pass", spy)
    assert not mt.render(scene, cfg, device="cpu").requires_grad
    p0 = scene.prim_p0.clone().requires_grad_(True)
    moved = dataclasses.replace(scene, prim_p0=p0)
    with torch.no_grad():
        assert not mt.render(moved, cfg, device="cpu").requires_grad
    img = mt.render(moved, cfg, device="cpu")
    assert img.requires_grad and modes == [True, True, False]
    names, seen, todo = set(), set(), [img.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo += [nxt for nxt, _ in fn.next_functions]
    assert "_LaneGatherBackward" in names
    assert not {"IndexBackward0", "IndexPutBackward0"} & names, names
    g, = torch.autograd.grad(img.mean(), p0)
    assert bool(g.isfinite().all()) and bool(g[torch.as_tensor(rows)].abs()
                                             .max() > 0)
    with flatten_mode("0"):
        field = mt.instanced_field(n=2, subdiv=1, device="cpu")
    fwd = field.inst_fwd.clone().requires_grad_(True)
    small = mt.RenderConfig(width=8, height=8, spp=1, spp_per_pass=1,
                            max_depth=2, reparam=True)
    img = mt.render(dataclasses.replace(field, inst_fwd=fwd), small,
                    device="cpu")
    g, = torch.autograd.grad(img.mean(), fwd)
    assert bool(g.isfinite().all()) and bool(g[:, :12].abs().max() > 0)
