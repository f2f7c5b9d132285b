"""The BVH8 walks of the PyTorch port against the JAX package: the tables
of bvh.collapse_bvh8, the backend switch (scene.set_backend "bvh8" and
"bvh8mxu"), the twins of K6 (prim leaves) and K7 (cluster leaves), the
CUDA source through the g++ emulation of tests/test_torch_traverse.py,
and renders under each backend.

Scenes: mesh_gallery(subdiv=2) (1 932 triangles) and subdiv=1 for the
renders; the sphere field of tests/test_torch_spheres.py at n=6, subdiv=2
(1 928 prims, flattened) for K6's sphere branch.

Tolerances:
- K6 vs the f32 oracle (traverse_jnp) and interpret-mode Pallas, as
  tests/test_traverse_bvh8.py holds the JAX kernel: hit masks equal, prims
  equal, t at rtol 1e-5, u at atol 1e-5; occlusion equal.
- K7 vs brute force and the f32 oracle, as tests/test_traverse_bvh8.py
  holds it to brute force: hit masks equal, t at rtol 1e-3 / atol 1e-5
  with the 99th percentile of the relative error under 1e-4 (the plane
  form's t error does not shrink with t), prims equal on more than 99% of
  hit lanes (exact ties); occlusion equal to the f32 oracle's.
- Twin against twin on the same rays (K6 vs K3, K7 vs K1): hit masks
  equal and t bit-equal wherever both hit, since a BVH8 child box is a
  BVH2 node box and both walks test the winner with the same arithmetic;
  prims equal except on exact ties (t equal), which none of these rays
  meets.
- Renders: tests/test_torch_render.py's 32x32 tolerance.
- On the card, each kernel against its twin: K6's any hit on 99.9% of
  lanes; K6's closest hit, whose warps test a step's due prims together
  in the twin's order and tie rule, and K7, whose warp-cooperative visits
  keep them, bit-equal (t, prim or slot, u and v, and K7's occlusion, on
  every lane).

The JAX package's walk answers and renders are committed (tests/goldens/
test_torch_bvh8.npz); one is recomputed live.
"""
import contextlib
import functools
import re

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch import convert
from mitsuba2_tpu_torch.core.geometry import Ray
from mitsuba2_tpu_torch.kernels import traverse
from mitsuba2_tpu_torch.probe_rays import KINDS, probe_rays
from mitsuba2_tpu_torch.scene import bvh as bvh_mod
from mitsuba2_tpu_torch.scene import scene as scene_mod
from mitsuba2_tpu_torch.scene.scene import BVH8_FIELDS

from goldens.jax_refs import Refs
from test_torch_instancing import flatten_mode, recorded_fields
from test_torch_dense import source_constant
from test_torch_spheres import package, sphere_field
from test_torch_traverse import (build_emulation, load_counters, planar,
                                 work_counter)

# one intra-op thread: the suite's test processes share the cores
# (pytest-xdist), and torch's OpenMP regions stall when they
# oversubscribe them
torch.set_num_threads(1)

REFS = Refs("test_torch_bvh8")
N_RAYS = 512
N_ORACLE = 2048


@contextlib.contextmanager
def backend(name):
    """The port's backend forced inside the block, "auto" after it."""
    scene_mod.set_backend(name)
    try:
        yield
    finally:
        scene_mod.set_backend("auto")


SCENES = {
    "gallery": lambda pkg: pkg.presets.mesh_gallery(subdiv=2),
    "field": lambda pkg: sphere_field(pkg, 6, 2),
}


def build_port(name, which="auto"):
    """(scene, host tables) of the port's build uploaded under `which`."""
    with flatten_mode(None), backend(which), recorded_fields() as got:
        scene = (mt.mesh_gallery(subdiv=2, device="cpu") if name == "gallery"
                 else SCENES[name](package("port")))
    return scene, got[0]


def jax_bvh8(sj):
    return {k: (getattr(sj, k) if k.endswith("depth") or getattr(sj, k) is None
                else np.asarray(getattr(sj, k))) for k in BVH8_FIELDS}


@functools.lru_cache(maxsize=None)
def jax_scene(name):
    with flatten_mode(None):
        return SCENES[name](package("jax"))


def _rays(scene, n, seed, coherent):
    """tests/test_traverse_bvh8.py's rays, numpy: from one eye toward the
    scene box (coherent), or from anywhere in it in any direction."""
    rng = np.random.default_rng(seed)
    lo, hi = scene.bvh_min[0].numpy(), scene.bvh_max[0].numpy()
    if coherent:
        eye = 0.5 * (lo + hi) + np.asarray([0, 0.2, -2.8], np.float32)
        o = np.broadcast_to(eye, (n, 3)).astype(np.float32)
        d = rng.uniform(lo, hi, (n, 3)).astype(np.float32) - eye
    else:
        o = rng.uniform(lo - 0.5, hi + 0.5, (n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def jvec(a):
    import jax.numpy as jnp
    from mitsuba2_tpu.core.vec import Vec3 as JVec3
    return JVec3(*(jnp.asarray(a[:, i]) for i in range(3)))


# ---------------------------------------------------------------------------
# (a) The tables
# ---------------------------------------------------------------------------

def test_collapse_bvh8_equals_jax():
    """The port's collapse_bvh8 on the JAX package's own trees, both modes,
    gives the JAX collapse's arrays; a leaf root raises in both."""
    from mitsuba2_tpu.scene import bvh as jbvh
    rng = np.random.default_rng(5)
    lo = rng.uniform(-5, 5, (700, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.01, 0.5, (700, 3)).astype(np.float32)
    tree = jbvh.build_bvh(lo, hi)
    mine = bvh_mod.BVH(tree.bounds_min, tree.bounds_max, tree.leaf_start,
                       tree.leaf_count, tree.miss, tree.prim_order)
    for a, b in zip(jbvh.collapse_bvh8(tree), bvh_mod.collapse_bvh8(mine)):
        assert np.array_equal(a, b)
    cl_id, starts, _ = jbvh.cluster_cut(tree, max_prims=32)
    cl_c = rng.normal(size=(len(starts), 3)).astype(np.float32)
    ref = jbvh.collapse_bvh8(tree, cluster_id=cl_id, cluster_c=cl_c,
                             cluster_k=32)
    got = bvh_mod.collapse_bvh8(mine, cluster_id=cl_id, cluster_c=cl_c,
                                cluster_k=32)
    assert got[0].shape[1] == 16 and got[2] >= 1
    for a, b in zip(ref, got):
        assert np.array_equal(a, b)
    one = bvh_mod.build_bvh(lo[:3], hi[:3])
    with pytest.raises(ValueError, match="inner root"):
        bvh_mod.collapse_bvh8(one)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_bvh8_tables_byte_equal(name):
    """All six BVH8 fields of the port's build equal the JAX build's; a
    scene uploaded under "bvh8" or "bvh8mxu" holds that walk's tables and
    no other walk's; scene_from_numpy of the JAX tables equals the port's
    own upload under each backend."""
    sj = jax_scene(name)
    ref = jax_bvh8(sj)
    for which in ("bvh8", "bvh8mxu"):
        st, f = build_port(name, which)
        for k in BVH8_FIELDS:
            if k.endswith("depth"):
                assert f[k] == ref[k], k
            else:
                assert f[k].dtype == ref[k].dtype, k
                assert np.array_equal(f[k], ref[k]), k
        k6 = which == "bvh8"
        k7 = which == "bvh8mxu" and not st.has_spheres
        for k in ("bvh8_child", "bvh8_order"):
            assert (getattr(st, k) is not None) == k6, k
        for k in ("bvh8c_child", "bvh8c_order"):
            assert (getattr(st, k) is not None) == k7, k
        if k6:
            assert np.array_equal(st.bvh8_child.numpy(), f["bvh8_child"])
            assert np.array_equal(st.bvh_prim.numpy(), convert.prim_rows(f))
            assert st.bvh8_depth == f["bvh8_depth"] and st.bvh_node is None
        if k7:
            assert np.array_equal(st.bvh8c_order.numpy(), f["bvh8c_order"])
            assert st.bvh8c_depth == f["bvh8c_depth"]
        # under "bvh8mxu" the sphere field keeps its default (BVH2) tables
        assert (st.mxu_node_f is None) and (
            (st.bvh_node is not None) == (st.has_spheres and not k6))
        fields = {k: (getattr(sj, k) if isinstance(getattr(sj, k), int)
                      else np.asarray(getattr(sj, k)))
                  for k in scene_mod.FIELDS}
        fields.update(ref, param_paths=sj.param_paths)
        with backend(which):
            conv = mt.scene_from_numpy(fields, device="cpu")
        for fl in scene_mod.SceneData.__dataclass_fields__:
            a, b = getattr(conv, fl), getattr(st, fl)
            if torch.is_tensor(a):
                assert torch.equal(a, b), fl
            else:
                assert a == b, fl


def test_bvh8_tables_none_where_jax_has_none():
    """A tiny scene and an instanced scene have no BVH8 tables in either
    build (the JAX gate: more than 96 BVH2 rows, flat)."""
    for which in ("jax", "port"):
        pkg = package(which)
        tiny = pkg.build([pkg.shapes.rectangle(bsdf={"type": "diffuse"})],
                         {"type": "perspective", "fov": 45.0,
                          "to_world": np.eye(4, dtype=np.float32)},
                         [{"type": "constant", "radiance": [1, 1, 1]}])
        with flatten_mode("0"):
            shared = sphere_field(pkg, 6, 2)
        for sc in (tiny, shared):
            assert sc.bvh8_child is None and sc.bvh8c_child is None
            assert sc.bvh8_depth == 0 and sc.bvh8c_depth == 0
    with recorded_fields() as got, flatten_mode("0"), backend("bvh8"):
        sphere_field(package("port"), 6, 2)
    assert all(got[0][k] is None for k in ("bvh8_child", "bvh8_order",
                                           "bvh8c_child", "bvh8c_order"))
    assert got[0]["bvh8_depth"] == got[0]["bvh8c_depth"] == 0


# ---------------------------------------------------------------------------
# (b)-(d) The twins
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gallery():
    """The gallery uploaded under each walk: {"bvh8", "bvh8mxu", "auto"}
    scenes, and the host tables."""
    out = {w: build_port("gallery", w) for w in ("bvh8", "bvh8mxu", "auto")}
    return {w: s for w, (s, _) in out.items()}, out["auto"][1]


def k6(st, o, d, tm):
    args = (planar(o), planar(d), torch.from_numpy(tm))
    return (traverse.ray_intersect_bvh8(st, *args),
            traverse.ray_test_bvh8(st, *args))


def k7(st, o, d, tm):
    args = (planar(o), planar(d), torch.from_numpy(tm))
    return (traverse.ray_intersect_bvh8mxu(st, *args),
            traverse.ray_test_bvh8mxu(st, *args))


@pytest.mark.parametrize("coherent", [True, False])
def test_k6_twin_matches_oracle(gallery, coherent):
    import jax.numpy as jnp
    from mitsuba2_tpu.kernels import traverse_jnp
    scenes, _ = gallery
    o, d = _rays(scenes["auto"], N_ORACLE, 1, coherent)
    tm = np.full(N_ORACLE, np.inf, np.float32)
    (t, p, u, v), _ = k6(scenes["bvh8"], o, d, tm)

    def oracle():
        sj = jax_scene("gallery")
        out = traverse_jnp.ray_intersect_preliminary(sj, jvec(o), jvec(d),
                                                     jnp.inf)
        occ = traverse_jnp.ray_test(sj, jvec(o), jvec(d), jnp.asarray(3.0))
        return (*(np.asarray(a) for a in out), np.asarray(occ))
    tj, pj, uj, vj, occ_j = REFS.get(f"k6_oracle_{coherent}", oracle)
    t, p, u = t.numpy(), p.numpy(), u.numpy()
    hit = np.isfinite(t)
    assert 0.2 < hit.mean()
    np.testing.assert_array_equal(hit, np.isfinite(tj))
    np.testing.assert_array_equal(p[hit], pj[hit])
    np.testing.assert_allclose(t[hit], tj[hit], rtol=1e-5)
    np.testing.assert_allclose(u[hit], uj[hit], atol=1e-5)
    assert bool(v.abs().max() > 0)
    tm3 = np.full(N_ORACLE, 3.0, np.float32)
    _, occ = k6(scenes["bvh8"], o, d, tm3)
    np.testing.assert_array_equal(occ.numpy(), occ_j)


def test_golden_is_fresh(gallery):
    """The golden's K6 oracle answer on coherent rays recomputed now."""
    import jax.numpy as jnp
    from mitsuba2_tpu.kernels import traverse_jnp
    scenes, _ = gallery
    o, d = _rays(scenes["auto"], N_ORACLE, 1, True)
    t, p = traverse_jnp.ray_intersect_preliminary(
        jax_scene("gallery"), jvec(o), jvec(d), jnp.inf)[:2]
    stored = REFS.get("k6_oracle_True", None)
    np.testing.assert_array_equal(stored[0], np.asarray(t))
    np.testing.assert_array_equal(stored[1], np.asarray(p))


def test_k6_twin_matches_interpret_pallas(gallery):
    import jax.numpy as jnp
    from mitsuba2_tpu.kernels import traverse_pallas
    scenes, _ = gallery
    o, d = _rays(scenes["auto"], 1024, 2, False)
    tm = np.full(1024, 3.0, np.float32)
    (t, p, u, v), occ = k6(scenes["bvh8"], o, d, tm)

    def interpret():
        sj = jax_scene("gallery")
        out = traverse_pallas.ray_intersect_bvh8(
            sj, jvec(o), jvec(d), jnp.asarray(tm), interpret=True)
        occ_j = traverse_pallas.ray_test_bvh8(sj, jvec(o), jvec(d),
                                              jnp.asarray(tm), interpret=True)
        return (*(np.asarray(a) for a in out), np.asarray(occ_j))
    tj, pj, uj, vj, occ_j = REFS.get("k6_pallas", interpret)
    hit = np.isfinite(t.numpy())
    assert 0.1 < hit.mean()
    np.testing.assert_array_equal(hit, np.isfinite(tj))
    np.testing.assert_array_equal(p.numpy()[hit], pj[hit])
    np.testing.assert_allclose(t.numpy()[hit], tj[hit], rtol=1e-5)
    np.testing.assert_allclose(u.numpy()[hit], uj[hit], atol=1e-5)
    np.testing.assert_allclose(v.numpy()[hit], vj[hit], atol=1e-5)
    np.testing.assert_array_equal(occ.numpy(), occ_j)


@pytest.mark.parametrize("coherent", [True, False])
def test_k7_twin_matches_brute_and_oracle(gallery, coherent):
    """K7 against brute force (the port's, which tests/test_torch_spheres.py
    holds to the JAX package's) and the JAX package's f32 oracle."""
    import jax.numpy as jnp
    from mitsuba2_tpu.kernels import traverse_jnp
    from mitsuba2_tpu_torch.kernels import brute
    scenes, _ = gallery
    o, d = _rays(scenes["auto"], N_ORACLE, 3, coherent)

    def oracle():
        sj = jax_scene("gallery")
        out = traverse_jnp.ray_intersect_preliminary(sj, jvec(o), jvec(d),
                                                     jnp.inf)
        occ = traverse_jnp.ray_test(sj, jvec(o), jvec(d), jnp.asarray(3.0))
        return np.asarray(out[0]), np.asarray(out[1]), np.asarray(occ)
    tj, pj, occ_j = REFS.get(f"k7_oracle_{coherent}", oracle)
    (t, p, u, v), _ = k7(scenes["bvh8mxu"], o, d,
                         np.full(N_ORACLE, np.inf, np.float32))
    assert not u.any() and not v.any()
    t, p = t.numpy(), p.numpy()
    hit = np.isfinite(t)
    assert 0.2 < hit.mean()
    inf = torch.full((N_ORACLE,), np.inf)
    for ref in (brute.ray_intersect_brute(scenes["auto"], planar(o),
                                          planar(d), inf), (tj, pj)):
        tb, pb = np.asarray(ref[0]), np.asarray(ref[1])
        np.testing.assert_array_equal(hit, np.isfinite(tb))
        np.testing.assert_allclose(t[hit], tb[hit], rtol=1e-3, atol=1e-5)
        rel = np.abs(t[hit] - tb[hit]) / np.maximum(np.abs(tb[hit]), 1e-9)
        assert np.percentile(rel, 99) < 1e-4
        assert (p == pb)[hit].mean() > 0.99
    tm3 = np.full(N_ORACLE, 3.0, np.float32)
    _, occ = k7(scenes["bvh8mxu"], o, d, tm3)
    np.testing.assert_array_equal(occ.numpy(), occ_j)


def test_k7_twin_matches_interpret_pallas(gallery):
    import jax.numpy as jnp
    from mitsuba2_tpu.kernels import traverse_pallas
    scenes, _ = gallery
    o, d = _rays(scenes["auto"], 1024, 4, True)
    tm = np.full(1024, 3.0, np.float32)
    (t, p, _, _), occ = k7(scenes["bvh8mxu"], o, d, tm)

    def interpret():
        sj = jax_scene("gallery")
        out = traverse_pallas.ray_intersect_bvh8mxu(
            sj, jvec(o), jvec(d), jnp.asarray(tm), interpret=True)
        occ_j = traverse_pallas.ray_test_bvh8mxu(
            sj, jvec(o), jvec(d), jnp.asarray(tm), interpret=True)
        return np.asarray(out[0]), np.asarray(out[1]), np.asarray(occ_j)
    tj, pj, occ_j = REFS.get("k7_pallas", interpret)
    hit = np.isfinite(t.numpy())
    np.testing.assert_array_equal(hit, np.isfinite(tj))
    # the Pallas kernel's plane dots run in split bf16: tests/
    # test_torch_traverse.py's band for the cluster walk
    np.testing.assert_allclose(t.numpy()[hit], tj[hit], rtol=1e-3,
                               atol=1e-5)
    assert (p.numpy() == pj)[hit].mean() > 0.99
    np.testing.assert_array_equal(occ.numpy(), occ_j)


def probe(scene):
    """probe_rays on a scene through its default walks."""
    def closest(o, d, t_max):
        t, prim, _, _, _ = scene_mod._preliminary_dispatch(
            scene, Ray(planar(o), planar(d), torch.from_numpy(t_max)),
            sort=False)
        return t.numpy(), prim.numpy(), None
    return probe_rays(scene, N_RAYS, 3, closest)


@pytest.fixture(scope="module")
def field():
    """The flattened sphere field uploaded under "bvh8" and "auto" (the
    BVH2 walks, K3's tables), and probe rays on it."""
    s8, _ = build_port("field", "bvh8")
    s2, _ = build_port("field", "auto")
    assert s8.has_spheres and not s8.has_instances
    return s8, s2, probe(s2)


@pytest.fixture(scope="module")
def gallery_rays(gallery):
    return probe(gallery[0]["auto"])


def assert_twins_agree(a, b, uv):
    """Twin against twin: hit masks equal, t bit-equal where both hit,
    prims (and u/v) equal."""
    hit = torch.isfinite(a[0])
    assert torch.equal(hit, torch.isfinite(b[0]))
    assert torch.equal(a[0][hit], b[0][hit])
    assert torch.equal(a[1], b[1])
    if uv:
        assert torch.equal(a[2], b[2]) and torch.equal(a[3], b[3])
    return hit


@pytest.mark.parametrize("name,kind", [("gallery", k) for k in KINDS]
                         + [("field", "camera"), ("field", "random")])
def test_k6_twin_equals_k3_twin(gallery, gallery_rays, field, name, kind):
    """K6 and K3 on the same rays: the gallery (K3's tables packed here)
    and the sphere field, whose random rays aim a quarter into spheres."""
    if name == "gallery":
        scenes, f = gallery
        st, rays = scenes["bvh8"], gallery_rays
        tabs = [torch.from_numpy(a) for a in convert.bvh_walk_tables(f)]
    else:
        st, s2, rays = field
        tabs = (s2.bvh_node, s2.bvh_link, s2.bvh_pair, s2.bvh_prim)
    o, d, tm = rays[kind]
    args = (planar(o), planar(d), torch.from_numpy(tm))
    out8 = traverse.ray_intersect_bvh8(st, *args)
    occ8 = traverse.ray_test_bvh8(st, *args)
    ray = (*args[0].__dict__.values(), *args[1].__dict__.values(), args[2])
    out2 = traverse.bvh_closest_hit(*tabs, *ray, tabs[0].shape[0] + 64)
    occ2 = traverse.bvh_any_hit(*tabs, *ray, tabs[0].shape[0] + 64)
    hit = assert_twins_agree(out8, out2, uv=True)
    assert torch.equal(occ8, occ2)
    assert 0.1 < hit.float().mean()
    if name == "field" and kind == "random":
        sphere = st.prim_type[out8[1][hit].long()] == 1
        assert int(sphere.sum()) > 30


@pytest.mark.parametrize("kind", KINDS)
def test_k7_twin_equals_k1_twin(gallery, gallery_rays, kind):
    scenes, _ = gallery
    o, d, tm = gallery_rays[kind]
    args = (planar(o), planar(d), torch.from_numpy(tm))
    out7, occ7 = k7(scenes["bvh8mxu"], o, d, tm)
    out1 = traverse.ray_intersect_preliminary(scenes["auto"], *args)
    occ1 = traverse.ray_test(scenes["auto"], *args)
    hit = assert_twins_agree(out7, out1, uv=False)
    assert torch.equal(occ7, occ1) and 0.1 < hit.float().mean()


def test_twins_count_walk_work(gallery, gallery_rays):
    """The work counts the bounds rest on: a fresh visit per descent and
    the root's, a pop per push, (closest hit) every cluster visit tests
    all CK slots; K7's warp-cooperative loads: a group loads all CK slots
    (closest hit), or at least one slot and at most its visits' CK (any
    hit); and the work the rays need, which the bounds count: the real
    slots (a padding slot's plane row, and only its, is all zero) and the
    non-empty children of a fresh visit."""
    scenes, _ = gallery
    st = scenes["bvh8mxu"]
    assert torch.equal((st.cluster_feat != 0).any(1),
                       st.cluster_slot_prim >= 0)
    o, d, tm = gallery_rays["camera"]
    ray = (planar(o), planar(d), torch.from_numpy(tm))
    args = traverse._bvh8mxu_args(st, *ray)
    stats, any_stats = {}, {}
    traverse.bvh8mxu_closest_hit_plain(*args, chunk=500, stats=stats)
    traverse.bvh8mxu_any_hit_plain(*args, chunk=500, stats=any_stats)
    assert stats["pushes"] == stats["pops"]
    assert stats["fresh_visits"] >= N_RAYS
    assert stats["slot_tests"] == stats["cluster_visits"] * st.cluster_k
    assert stats["advances"] >= stats["cluster_visits"]
    assert 0 < stats["real_slot_tests"] < stats["slot_tests"]
    assert 0 < any_stats["real_slot_tests"] < any_stats["slot_tests"]
    assert any_stats["real_slot_tests"] < stats["real_slot_tests"]
    ck = st.cluster_k
    assert stats["loaded_slots"] == ck * stats["cluster_groups"]
    assert stats["cluster_groups"] <= stats["cluster_visits"]
    assert (any_stats["cluster_groups"] <= any_stats["loaded_slots"]
            <= any_stats["cluster_visits"] * ck)
    k6_stats = {}
    traverse.bvh8_closest_hit_plain(*traverse._bvh8_args(scenes["bvh8"], *ray),
                                    chunk=500, stats=k6_stats)
    for s in (stats, k6_stats):
        assert s["fresh_visits"] < s["child_tests"] < 8 * s["fresh_visits"]


# ---------------------------------------------------------------------------
# (e) The CUDA source, emulated on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return build_emulation(tmp_path_factory.mktemp("bvh8_walk_emu"))


def emulate(lib, which, tabs, rays, extra, any_hit):
    """The kernel's C entry on CPU tensors: its outputs."""
    n = rays[0].shape[0]
    if any_hit:
        outs = (torch.empty(n, dtype=torch.bool),)
    elif which == "bvh8":
        outs = (torch.empty(n), torch.empty(n, dtype=torch.int32),
                torch.empty(n), torch.empty(n))
    else:
        outs = (torch.empty(n), torch.empty(n, dtype=torch.int32))
    fn = getattr(lib, f"mts_{which}_{'any' if any_hit else 'closest'}_hit")
    assert fn(*(a.data_ptr() for a in tabs + rays + outs), n, *extra,
              None) == 0
    return outs


def assert_emulated_matches_twins(lib, which, st, o, d, tm):
    """The CUDA source of K6 or K7 (`which`), emulated, against the twins
    on the rays (o, d, tm), bit-equal; and the walk work the twins count
    equals the loads the kernels make: two int4 of an order row a fresh
    visit or a pop (a fresh visit alone on K6's any hit, whose stack
    keeps the order row), two float4 of a child row per child
    slab-tested at a fresh visit (8) and per advance that re-culls it
    (one, its kind and count, on K6's any hit, which does not), three
    float4 a prim test (K6), and on K6's closest hit, whose warps test a
    step's due prims together, the passes the emulation counts
    (`leaf_passes`); on K7,
    whose warps visit clusters together, a centroid per lane-visit, five
    float4 a loaded slot (`loaded_slots`: a warp's group of lanes due at
    one cluster loads its rows once) and the slot tests on rows held in
    registers as the twin counts them."""
    rays = tuple(torch.from_numpy(np.ascontiguousarray(a))
                 for a in (*o.T, *d.T, tm))
    if which == "bvh8":
        args = traverse._bvh8_args(st, planar(o), planar(d),
                                   torch.from_numpy(tm))
        extra = (args[-1],)
        twins = (traverse.bvh8_closest_hit_plain,
                 traverse.bvh8_any_hit_plain)
    else:
        args = traverse._bvh8mxu_args(st, planar(o), planar(d),
                                      torch.from_numpy(tm))
        extra = (args[-1], st.cluster_k)
        twins = (traverse.bvh8mxu_closest_hit_plain,
                 traverse.bvh8mxu_any_hit_plain)
    tabs = args[:3]
    for any_hit in (False, True):
        loads = load_counters(lib, tabs)
        out = emulate(lib, which, tabs, rays, extra, any_hit)
        stats = {}
        twin = twins[any_hit](*args, chunk=700, stats=stats)
        twin = (twin,) if any_hit else twin
        assert all(torch.equal(a, b) for a, b in zip(out, twin))
        g = stats.get
        visits = g("cluster_visits", 0)
        k6_any = which == "bvh8" and any_hit
        assert loads[0] == (16 * g("fresh_visits")
                            + (1 if k6_any else 2) * g("advances") + visits)
        # K6's any hit: a pop loads nothing
        assert loads[1] == 2 * (g("fresh_visits")
                                + (0 if k6_any else g("pops", 0)))
        assert not k6_any or g("pops") > 0
        tests = g("tri_tests", 0) + g("sphere_tests", 0)
        if which == "bvh8":
            assert loads[2] == 3 * tests and tests > 0
            assert work_counter(lib).value == g("leaf_passes", 0)
            # a pass tests up to 32 of a warp's due prims
            assert any_hit or tests / 32 <= g("leaf_passes") <= tests
            continue
        assert loads[2] == 5 * g("loaded_slots")
        assert work_counter(lib).value == g("slot_tests")
        assert 0 < g("cluster_groups") <= visits


@pytest.mark.parametrize("kind", KINDS)
def test_cuda_source_emulated_matches_twins(gallery, gallery_rays, field,
                                            emulated, kind):
    """K6 on the gallery and the sphere field, K7 on the gallery:
    assert_emulated_matches_twins on each kind of probe ray."""
    scenes, _ = gallery
    for which, st, (o, d, tm) in (
            ("bvh8", scenes["bvh8"], gallery_rays[kind]),
            ("bvh8", field[0], field[2][kind]),
            ("bvh8mxu", scenes["bvh8mxu"], gallery_rays[kind])):
        assert_emulated_matches_twins(emulated, which, st, o, d, tm)


def test_tiles_mirror_the_source():
    """The twins count the warps' loads with the source's tile widths:
    K1/K2 and K5's closest hit, K5's any hit and K7's; K4's and K6's
    closest-hit leaf passes with the source's round lengths; and the pair
    walk's fallbacks with its stack, on its rows' layout. The warps'
    leaf passes hold the BVH build's largest leaf."""
    for twin, name in ((traverse.TILE, "TILE_J"),
                       (traverse.INST_ANY_TILE, "INST_ANY_TILE_J"),
                       (traverse.BVH8C_TILE, "BVH8C_TILE_J")):
        assert twin == traverse.WARP * source_constant(name), name
    for name in ("BVH_ROUND_STEPS", "BVH8_ROUND_STEPS", "BVH_PAIR_STACK",
                 "PAIR_ROW_BITS"):
        assert getattr(traverse, name) == source_constant(name), name
    assert bvh_mod.LEAF_K == source_constant("LEAF_K")


def braced(text):
    """The brace-delimited block that `text` opens with."""
    depth = 0
    for j, ch in enumerate(text):
        depth += {"{": 1, "}": -1}.get(ch, 0)
        if depth == 0:
            return text[:j + 1]
    raise ValueError("unbalanced braces")


def loop_bodies(text):
    """The body of each `for` and `while` loop in the C source `text`: a
    block, or a statement up to its `;`."""
    for m in re.finditer(r"\b(for|while) *\(", text):
        j, depth = m.end(), 1
        while depth:
            depth += {"(": 1, ")": -1}.get(text[j], 0)
            j += 1
        rest = text[j:].lstrip()
        yield (braced(rest) if rest.startswith("{")
               else rest[:rest.index(";") + 1])


@pytest.mark.parametrize("walk", ["bvh_pair_walk", "bvh8_any_walk",
                                  "bvh8_closest_walk"])
def test_walk_loops_have_one_exit(walk):
    """The per-thread walks' loops leave by their condition alone: no
    `break`, `continue` or `return` in a loop's body. With such jumps in
    its branches a warp's lanes did not reconverge inside the loop, and
    the pair walk's first build ran 2.5x slower (PERF.md §6)."""
    src = re.sub(r"//[^\n]*", "", open(traverse._SRC).read())
    head = re.search(rf"\bvoid {walk}\(", src).end()
    body = braced(src[src.index("{", head):])
    loops = list(loop_bodies(body))
    assert len(loops) >= 2
    for loop in loops:
        assert not re.search(r"\b(break|continue|return)\b", loop), walk


@pytest.mark.parametrize("kind", KINDS)
def test_k7_source_emulated_tail_and_dead_lanes(gallery, gallery_rays,
                                                emulated, kind):
    """K7 at n = 512 + 37, not a multiple of a warp (the last block of
    128 lanes holds 37: a warp with 5, its other lanes past n), with dead
    lanes (t_max <= 0) amid the live ones: every lane takes part in its
    warp's visits (the emulation aborts on a lane that leaves early) and
    the results stay bit-equal."""
    o, d, tm = (np.concatenate([a, a[:37]]) for a in gallery_rays[kind])
    tm[[5, 40, 41, 300, 530]] = 0.0
    tm[[6, 200, 545]] = -1.0
    assert tm.shape[0] == 549 and bool((tm > 0).any())
    assert_emulated_matches_twins(emulated, "bvh8mxu",
                                  gallery[0]["bvh8mxu"], o, d, tm)


@pytest.mark.parametrize("kind", KINDS)
def test_k6_source_emulated_tail_and_dead_lanes(gallery, gallery_rays, field,
                                                emulated, kind):
    """K6 at n = 549 with dead lanes, as K7 above, on the gallery and on
    the sphere field: every lane takes part in its warp's leaf passes and
    the results stay bit-equal."""
    for st, rays in ((gallery[0]["bvh8"], gallery_rays[kind]),
                     (field[0], field[2][kind])):
        o, d, tm = (np.concatenate([a, a[:37]]) for a in rays)
        tm[[5, 40, 41, 300, 530]] = 0.0
        tm[[6, 200, 545]] = -1.0
        assert tm.shape[0] == 549 and bool((tm > 0).any())
        assert_emulated_matches_twins(emulated, "bvh8", st, o, d, tm)


# ---------------------------------------------------------------------------
# (f)-(h) The backend switch: renders, the presort, the errors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["bvh8", "bvh8mxu"])
def test_render_matches_jax_under_backend(which):
    """A 32x32 render of mesh_gallery(subdiv=1) under the same
    set_backend in both packages (JAX: the interpret-mode BVH8 kernels;
    the port: the K6 or K7 twins), same seed."""
    kw = dict(width=32, height=32, spp=1, spp_per_pass=1, max_depth=2,
              rr_depth=8)

    def jax_render():
        import jax
        import mitsuba2_tpu as mi
        from mitsuba2_tpu.scene import presets as jpresets
        from mitsuba2_tpu.scene import scene as jscene
        sj = jpresets.mesh_gallery(subdiv=1)
        jscene.set_backend(which)
        jax.clear_caches()
        try:
            return np.asarray(mi.render(sj, mi.RenderConfig(**kw), seed=0))
        finally:
            jscene.set_backend("auto")
            jax.clear_caches()
    img_j = REFS.get(f"render_{which}", jax_render)
    counts = {k: getattr(traverse, k).launches for k in (
        "bvh8_closest_hit", "bvh8mxu_closest_hit", "cluster_closest_hit")}
    seen = []
    fn = traverse.ray_intersect_bvh8 if which == "bvh8" else \
        traverse.ray_intersect_bvh8mxu
    with backend(which), pytest.MonkeyPatch.context() as mp:
        mp.setattr(traverse, fn.__name__,
                   lambda *a: seen.append(1) or fn(*a))
        st = mt.mesh_gallery(subdiv=1, device="cpu")
        img_t = mt.render(st, mt.RenderConfig(**kw), seed=0,
                          device="cpu").numpy()
    assert len(seen) == 2                  # camera and one bounce
    assert counts == {k: getattr(traverse, k).launches for k in counts}
    assert img_t.shape == img_j.shape == (32, 32, 3)
    assert np.isfinite(img_t).all() and img_t.mean() > 0
    close = np.isclose(img_t, img_j, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99
    np.testing.assert_allclose(img_t.mean(), img_j.mean(), rtol=1e-3)


def test_presort_unsorts_uv_under_bvh8(gallery, gallery_rays):
    """Under "bvh8" a triangle-only scene gets real u/v from K6: the
    sorted dispatch hands back every output, u and v included, in the
    unsorted walk's lane order; under "bvh8mxu" u = v = 0."""
    scenes, _ = gallery
    o, d, tm = gallery_rays["bounce"]
    tm = tm.copy()
    tm[::5] = 0.0
    ray = Ray(planar(o), planar(d), torch.from_numpy(tm))
    with backend("bvh8"):
        st = scenes["bvh8"]
        assert scene_mod._pick_backend(st) == "bvh8"
        assert traverse.emits_uv(st, "bvh8") and not st.has_spheres
        outs_s = scene_mod._preliminary_dispatch(st, ray, sort=True)
        outs_u = scene_mod._preliminary_dispatch(st, ray, sort=False)
        occ = scene_mod.ray_test(st, ray)
    for a, b in zip(outs_s[:4], outs_u[:4]):
        assert torch.equal(a, b)
    assert outs_s[4] is None and bool(outs_s[2].any())
    assert not torch.isfinite(outs_s[0][::5]).any()
    assert torch.equal(occ, torch.isfinite(outs_u[0]))
    with backend("bvh8mxu"):
        st = scenes["bvh8mxu"]
        assert scene_mod._pick_backend(st) == "bvh8mxu"
        assert not traverse.emits_uv(st, "bvh8mxu")
        outs_s = scene_mod._preliminary_dispatch(st, ray, sort=True)
        outs_u = scene_mod._preliminary_dispatch(st, ray, sort=False)
    assert not outs_s[2].any() and not outs_s[3].any()
    assert torch.equal(outs_s[0], outs_u[0])
    assert torch.equal(outs_s[1], outs_u[1])


def test_forced_backends_override_the_size_test():
    """"pallas" walks a brute-force-sized scene (its walk tables are
    uploaded), "brute" brute-forces a walking one: the same hits."""
    with backend("pallas"):
        walked = mt.cornell_box(device="cpu")
        assert scene_mod._pick_backend(walked) == "walk"
    assert walked.mxu_node_f is not None
    brute_sz = mt.cornell_box(device="cpu")
    assert brute_sz.mxu_node_f is None
    assert scene_mod._pick_backend(brute_sz) == "brute"
    o, d = _rays(brute_sz, 512, 6, True)
    ray = Ray(planar(o), planar(d), torch.full((512,), np.inf))
    with backend("pallas"):
        t_w, p_w = scene_mod._preliminary_dispatch(walked, ray)[:2]
    t_b, p_b = scene_mod._preliminary_dispatch(brute_sz, ray)[:2]
    hit = torch.isfinite(t_b)
    assert torch.equal(hit, torch.isfinite(t_w)) and bool(hit.any())
    assert (p_w == p_b)[hit].float().mean() > 0.99
    with backend("brute"):
        assert scene_mod._pick_backend(walked) == "brute"


def test_pick_backend_errors(gallery):
    """Every ValueError of the backend switch, with the JAX package's
    words."""
    scenes, _ = gallery
    with pytest.raises(ValueError, match="unknown backend"):
        scene_mod.set_backend("cuda")
    with flatten_mode("0"):
        shared = sphere_field(package("port"), 6, 2)
    for which in ("brute", "bvh8", "bvh8mxu"):
        with backend(which), pytest.raises(ValueError,
                                           match="shared-BLAS instanced"):
            scene_mod._pick_backend(shared)
    tiny = mt.cornell_box(device="cpu")
    spheres = (mt.furnace(device="cpu"), build_port("field")[0])
    with backend("bvh8"):
        for sc in (tiny, scenes["auto"], scenes["bvh8mxu"]):
            with pytest.raises(ValueError, match="BVH8 tables"):
                scene_mod._pick_backend(sc)
    with backend("bvh8mxu"):
        for sc in (tiny, scenes["bvh8"]):
            with pytest.raises(ValueError, match="composed cut-tree"):
                scene_mod._pick_backend(sc)
        for sc in spheres:
            with pytest.raises(ValueError, match="triangle-only"):
                scene_mod._pick_backend(sc)
    # the default walks on a scene uploaded under another backend
    for sc in (scenes["bvh8"], scenes["bvh8mxu"]):
        with pytest.raises(ValueError, match="uploaded under another"):
            scene_mod._pick_backend(sc)
    with pytest.raises(ValueError, match="no BVH8 tables"):
        traverse.ray_intersect_bvh8(scenes["auto"], *(
            planar(np.zeros((4, 3), np.float32)),) * 2, torch.ones(4))
    with pytest.raises(ValueError, match="composed BVH8-cut"):
        traverse.ray_test_bvh8mxu(scenes["auto"], *(
            planar(np.zeros((4, 3), np.float32)),) * 2, torch.ones(4))


def test_bvh8_wrappers_check_and_count(gallery):
    scenes, _ = gallery
    tm = torch.full((8,), np.inf)
    for which, st in (("bvh8", scenes["bvh8"]),
                      ("bvh8mxu", scenes["bvh8mxu"])):
        args = list((traverse._bvh8_args if which == "bvh8"
                     else traverse._bvh8mxu_args)(
            st, planar(np.zeros((8, 3), np.float32)),
            planar(np.ones((8, 3), np.float32)), tm))
        closest = getattr(traverse, f"{which}_closest_hit")
        any_hit = getattr(traverse, f"{which}_any_hit")
        before = (closest.launches, any_hit.launches)
        outs = closest(*args)
        assert len(outs) == (4 if which == "bvh8" else 2)
        assert outs[1].dtype == torch.int32 and outs[0].shape == (8,)
        any_hit(*args)
        # CPU tensors go to the twins: no kernel launch is counted
        assert (closest.launches, any_hit.launches) == before
        with pytest.raises(ValueError, match="float32"):
            closest(*args[:9], tm.double(), *args[10:])
        with pytest.raises(ValueError, match="order"):
            any_hit(args[0], args[1].long(), *args[2:])
        with pytest.raises(ValueError, match="stack"):
            closest(*args[:-2], traverse.BVH8_STACK + 1, args[-1])


# ---------------------------------------------------------------------------
# (i) On the card: each kernel against its twin
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("kind", KINDS)
def test_cuda_bvh8_kernels_match_twins(gallery, gallery_rays, field, cuda,
                                       kind):
    scenes, _ = gallery
    for which, st, (o, d, tm) in (
            ("bvh8", scenes["bvh8"], gallery_rays[kind]),
            ("bvh8", field[0], field[2][kind]),
            ("bvh8mxu", scenes["bvh8mxu"], gallery_rays[kind])):
        st = mt.to_device(st, cuda)
        ray = (planar(o, cuda), planar(d, cuda),
               torch.from_numpy(tm).to(cuda))
        args = (traverse._bvh8_args if which == "bvh8"
                else traverse._bvh8mxu_args)(st, *ray)
        closest = getattr(traverse, f"{which}_closest_hit")
        any_hit = getattr(traverse, f"{which}_any_hit")
        before = closest.launches
        out = closest(*args)
        occ = any_hit(*args)
        torch.cuda.synchronize()
        assert closest.launches == before + 1
        out_p = getattr(traverse, f"{which}_closest_hit_plain")(*args)
        occ_p = getattr(traverse, f"{which}_any_hit_plain")(*args)
        if which == "bvh8mxu":
            # K7's warp-cooperative visits keep the twin's order and tie
            # rule, and --fmad=false its rounding: bit-equal
            assert torch.equal(out[0], out_p[0])
            assert torch.equal(out[1], out_p[1]) and torch.equal(occ, occ_p)
            continue
        # K6's warp-wide leaf tests keep the serial walk's order and tie
        # rule: t, prim, u and v bit-equal; its any hit visits the twin's
        # children in the twin's order: the occlusion too
        assert all(torch.equal(a, b) for a, b in zip(out, out_p))
        assert torch.equal(occ, occ_p)
        hit = torch.isfinite(out_p[0])
        assert torch.equal(torch.isfinite(out[0]), hit)
        assert (out[1] == out_p[1])[hit].float().mean() >= 0.999
        torch.testing.assert_close(out[0][hit], out_p[0][hit], rtol=1e-5,
                                   atol=1e-5)
        assert (occ == occ_p).float().mean() >= 0.999
