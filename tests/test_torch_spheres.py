"""Analytic spheres in the PyTorch port against the JAX package: the scene
build, brute force, the BVH2 walks (K3 flat, K4 instanced) and the
shading, emitter and render paths that spheres reach.

The scenes:
- `furnace()` (one sphere: brute force);
- "the sphere field", built here the same way in both packages from the
  public shape API: presets.instanced_field's construction with a sphere
  added to the group. Small (n=6, subdiv=2: 1 928 prims) it is flattened
  by the JAX package's policy and takes K3; with MI_FLATTEN_INSTANCES=0
  it keeps shared BLAS and takes K4 (tests/test_instancing.py sets the
  same variable);
- groups brought out of order (A, A, B), where the JAX build's inst_inv
  col 12 gives B the BLAS root of A.

Tolerances:
- hit masks equal; prim (and instance) ids equal on more than 99% of hit
  lanes: the reference visits in its block's majority octant, the port in
  each ray's own, so an exact tie between two leaves may resolve either
  way;
- t at rtol 1e-5 / atol 1e-5 against the f32 oracle (traverse_jnp) and
  interpret-mode Pallas (K3 and K4 are f32 in both): XLA on the CPU fuses
  products into multiply-adds, which moves t near t = 0 by up to ~4e-7.
  On sphere hits that holds for 99% of lanes and rtol 1e-4 for all: the
  fused B*B - 4*A*C rounds the discriminant otherwise, and where a ray
  passes near the sphere's rim the two roots come close and that
  rounding moves t further (1.6e-5 relative on one lane of 338 here);
- u/v within 1e-4 where the prims agree, for the same reason (barycentrics
  lie in [0, 1]);
- occlusion equal on every lane;
- on the card, each kernel against its twin: hit masks equal, prims (and
  instances) on 99.9% of hit lanes, t at rtol 1e-5, occlusion on 99.9%;
  K4's closest hit, whose warps test a step's due prims together in the
  twin's order and tie rule, bit-equal (t, prim, u, v and instance).

The JAX package's walk answers and renders are committed (tests/goldens/
test_torch_spheres.npz); one is recomputed live.
"""
import functools
import os
import types

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch import convert
from mitsuba2_tpu_torch.core.geometry import Ray
from mitsuba2_tpu_torch.kernels import brute, traverse
from mitsuba2_tpu_torch.probe_rays import KINDS, probe_rays
from mitsuba2_tpu_torch.scene import scene as scene_mod
from mitsuba2_tpu_torch.scene.scene import FIELDS, INST_FIELDS

from test_torch_instancing import (assert_port_tables, flatten_mode,
                                   recorded_fields)
from test_torch_traverse import (build_emulation, load_counters, planar,
                                 work_counter)

from goldens.jax_refs import Refs

# one intra-op thread: the suite's test processes share the cores
# (pytest-xdist), and torch's OpenMP regions stall when they
# oversubscribe them
torch.set_num_threads(1)

REFS = Refs("test_torch_spheres")
N_RAYS = 2048
META = ("has_instances", "has_spheres", "inst_fuel", "inst_mxu_fuel",
        "n_emitters", "env_emitter", "emitter_kinds", "n_shapes",
        "cluster_k", "mat_families", "n_prims")


def package(which):
    """A package's scene-building modules under common names; JAX is
    imported only for "jax", so that the card-only cases run without it."""
    if which == "jax":
        from mitsuba2_tpu.core.geometry import Transform4
        from mitsuba2_tpu.scene import presets, shapes
        from mitsuba2_tpu.scene.scene import build_scene
        return types.SimpleNamespace(shapes=shapes, presets=presets,
                                     T4=Transform4, build=build_scene,
                                     furnace=presets.furnace)
    from mitsuba2_tpu_torch.core.geometry import Transform4
    from mitsuba2_tpu_torch.scene import presets, shapes
    return types.SimpleNamespace(
        shapes=shapes, presets=presets, T4=Transform4,
        build=functools.partial(mt.build_scene, device="cpu"),
        furnace=functools.partial(mt.furnace, device="cpu"))


def sphere_field(pkg, n, subdiv):
    """presets.instanced_field(n, subdiv) with a sphere in the group: the
    displaced icosphere blob and a 0.3-radius cap above it, n instances
    under rotations about y and uniform scales, a ground quad and a
    constant sky."""
    sh, P, T4 = pkg.shapes, pkg.presets, pkg.T4
    rng = np.random.default_rng(7)
    base_v, faces = P._icosphere(subdiv)
    blob = sh.mesh(P._displace(base_v.copy(), seed=3), faces,
                   bsdf={"type": "diffuse", "reflectance": [0.55, 0.5, 0.4]},
                   id="blob")
    cap = sh.sphere(center=(0, 1.4, 0), radius=0.3,
                    bsdf={"type": "diffuse", "reflectance": [0.8, 0.8, 0.8]},
                    id="cap")
    grp = sh.shapegroup([blob, cap], id="blob_grp")
    side = int(np.ceil(np.sqrt(n)))
    s = [P._quad([-side, 0, -side], [-side, 0, side], [side, 0, side],
                 [side, 0, -side],
                 bsdf={"type": "diffuse", "reflectance": P.WHITE},
                 id="ground")]
    for k in range(n):
        i, j = divmod(k, side)
        t = (T4.translate([2.0 * i - side + 1.0,
                           0.45 + 0.15 * float(rng.uniform()),
                           2.0 * j - side + 1.0])
             @ T4.rotate([0, 1, 0], float(rng.uniform(0, 360)))
             @ T4.scale([0.35 + 0.15 * float(rng.uniform())] * 3))
        s.append(sh.instance(grp, np.asarray(t.matrix), id=f"b{k}"))
    cam = T4.look_at(origin=[0.0, side * 0.8, -side * 1.6],
                     target=[0.0, 0.3, 0.0], up=[0, 1, 0])
    sensor = {"type": "perspective", "to_world": np.asarray(cam.matrix),
              "fov": 55.0}
    return pkg.build(s, sensor,
                     [{"type": "constant", "radiance": [0.9, 0.95, 1.0]}])


def out_of_order_scene(pkg):
    """Instances of groups A, A, B at x = -3, 0, 3: A = [cube, sphere], B =
    [unit sphere], under a constant sky (27 stored prims)."""
    sh, T4 = pkg.shapes, pkg.T4
    a = sh.shapegroup([
        sh.cube(bsdf={"type": "diffuse"}).transformed(
            T4.scale([0.6] * 3).matrix),
        sh.sphere(center=(0, 0.9, 0), radius=0.5, bsdf={"type": "diffuse"})])
    b = sh.shapegroup([sh.sphere(center=(0, 0, 0), radius=1.0,
                                 bsdf={"type": "diffuse"})])
    insts = [sh.instance(g, np.asarray(T4.translate([x, 0, 0]).matrix))
             for g, x in ((a, -3.0), (a, 0.0), (b, 3.0))]
    sensor = {"type": "perspective", "fov": 60, "to_world": np.asarray(
        T4.look_at(origin=[0, 0, -9], target=[0, 0, 0], up=[0, 1, 0]).matrix)}
    return pkg.build(insts, sensor,
                     [{"type": "constant", "radiance": [1.0, 1.0, 1.0]}])


SCENES = {
    "furnace": (lambda pkg: pkg.furnace(), None),
    "field_flat": (lambda pkg: sphere_field(pkg, 6, 2), None),
    "field_shared": (lambda pkg: sphere_field(pkg, 6, 2), "0"),
}


def build(name, which):
    make, mode = SCENES[name]
    with flatten_mode(mode):
        scene = make(package(which))
    return scene


def jax_fields(sj):
    keys = FIELDS + (INST_FIELDS if sj.has_instances else ())
    return {**{k: (getattr(sj, k) if isinstance(getattr(sj, k), int)
                   else np.asarray(getattr(sj, k))) for k in keys},
            "param_paths": sj.param_paths}


# ---------------------------------------------------------------------------
# The scene build
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=sorted(SCENES))
def pair(request):
    """(name, the JAX scene, the port's, the port's host tables)."""
    with recorded_fields() as got:
        st = build(request.param, "port")
    return request.param, build(request.param, "jax"), st, got[0]


def test_tables_byte_equal(pair):
    name, sj, st, fields = pair
    assert st.has_spheres and st.has_instances == (name == "field_shared")
    assert_port_tables(jax_fields(sj), fields, st)
    for k in META:
        assert getattr(st, k) == getattr(sj, k), k


def test_scene_from_numpy_equals_own_build(pair):
    _, sj, st, _ = pair
    conv = mt.scene_from_numpy(jax_fields(sj), device="cpu")
    for f in scene_mod.SceneData.__dataclass_fields__:
        a, b = getattr(conv, f), getattr(st, f)
        if torch.is_tensor(a):
            assert a.dtype == b.dtype and torch.equal(a, b), f
        else:
            assert a == b, f


def test_walk_tables_pack_the_scene_arrays(pair):
    """bvh_node / bvh_link / bvh_prim (convert.bvh_walk_tables) hold the
    BVH2 and prim arrays as the kernels read them, and bvh_pair the pair
    rows derived from them; a walking scene holds them on its device (the
    brute-force furnace does not)."""
    name, _, st, f = pair
    node, link, pair_rows, prim = convert.bvh_walk_tables(f)
    B = f["bvh_min"].shape[0]
    assert node.shape == (B, 8) and link.shape == (B, 16)
    assert np.array_equal(node[:, 0:3], f["bvh_min"])
    assert np.array_equal(node[:, 3:6], f["bvh_max"])
    assert np.array_equal(node[:, 6].astype(np.int32), f["bvh_leaf_start"])
    assert np.array_equal(node[:, 7].astype(np.int32), f["bvh_leaf_count"])
    assert np.array_equal(link[:, :8].reshape(-1), f["bvh_hit8"])
    assert np.array_equal(link[:, 8:].reshape(-1), f["bvh_miss8"])
    assert np.array_equal(prim[:, 0:3], f["prim_p0"])
    assert np.array_equal(prim[:, 3:6], f["prim_e1"])
    assert np.array_equal(prim[:, 6:9], f["prim_e2"])
    assert np.array_equal(prim[:, 9].astype(np.int32), f["prim_type"])
    if name == "furnace":
        assert st.bvh_node is None and st.cluster_feat is None
        return
    for a, b in zip((st.bvh_node, st.bvh_link, st.bvh_pair, st.bvh_prim),
                    (node, link, pair_rows, prim)):
        assert np.array_equal(a.numpy(), b)


def assert_pair_rows(st):
    """st.bvh_pair against the node rows and links it was derived from:
    a leaf's row zero; an inner node's two records each a child's box, bit
    for bit its node row's, its reference (its row, or ~(start << 2 |
    count - 1), or ~(PAIR_INST | id) for an instance leaf) and its row;
    and for every octant the record the octant bits name first is the
    child the hit link enters, the other the first child's miss link (so
    neither is BLAS_EXIT). Returns the references' kinds (inner, prim
    leaf, instance leaf) counted over every record."""
    node, link = st.bvh_node.numpy(), st.bvh_link.numpy()
    pr = st.bvh_pair.numpy()
    start, count = node[:, 6].astype(np.int64), node[:, 7].astype(np.int64)
    inner = np.nonzero(start < 0)[0]
    assert pr.shape == (node.shape[0], 16)
    assert not pr[start >= 0].any()
    kinds = np.zeros(3, np.int64)
    word0 = pr[inner, 7].view(np.uint32).astype(np.int64)
    rows = [word0 & ((1 << traverse.PAIR_ROW_BITS) - 1),
            pr[inner, 15].astype(np.int64)]
    for k, row in enumerate(rows):
        rec = pr[inner, 8 * k:8 * k + 8]
        assert (row >= 0).all() and (row < node.shape[0]).all()
        assert np.array_equal(rec[:, 0:6], node[row, 0:6].view(np.int32))
        s_, c_ = start[row], count[row]
        want = np.where(s_ < 0, row, ~np.where(
            c_ > 0, s_ * 4 + c_ - 1, traverse.PAIR_INST + s_))
        assert np.array_equal(rec[:, 6], want)
        kinds += [(s_ < 0).sum(), (c_ > 0).sum(),
                  ((s_ >= 0) & (c_ == 0)).sum()]
    for o in range(8):
        second_first = (word0 >> (traverse.PAIR_ROW_BITS + o)) & 1 == 1
        first = np.where(second_first, rows[1], rows[0])
        other = np.where(second_first, rows[0], rows[1])
        assert np.array_equal(first, link[inner, o])
        assert np.array_equal(other, link[first, 8 + o])
    return kinds


@pytest.mark.parametrize("name", ["field_flat", "field_shared", "gallery1",
                                  "gallery2"])
def test_pair_rows_follow_the_links(name, monkeypatch):
    """The pair walk's child-pair rows (convert.bvh_pair_rows) on the flat
    and the shared sphere field (TLAS and BLASes: instance leaves among
    the children, no BLAS_EXIT) and on mesh_gallery(subdiv=1, 2) with
    MXU_LEAVES off (the BVH2 walks on triangles): assert_pair_rows."""
    if name.startswith("gallery"):
        monkeypatch.setattr(traverse, "MXU_LEAVES", False)
        st = mt.mesh_gallery(subdiv=int(name[-1]), device="cpu")
    else:
        st = build(name, "port")
    kinds = assert_pair_rows(st)
    assert kinds[0] > 0 and kinds[1] > 0
    assert (kinds[2] > 0) == (name == "field_shared") == st.has_instances


def test_instance_roots_where_groups_come_in_order():
    """Each instance's BLAS root (convert.instance_bvh_roots) is the
    per-instance root of the two-level build; where instances bring their
    groups in order (the sphere field, a world group, two interleaved
    groups) inst_inv col 12 agrees with it, and with A, A, B it does not."""
    from test_torch_instancing import groups_scene
    from mitsuba2_tpu_torch.scene import bvh
    pkg = package("port")
    with flatten_mode("0"), recorded_fields() as got:
        scenes = [build("field_shared", "port"), groups_scene(pkg),
                  out_of_order_scene(pkg)]
    for st, f in zip(scenes[:2], got):
        # groups_scene holds no sphere: its roots are derived here
        roots = (st.inst_bvh_root.numpy() if st.has_spheres else
                 convert.instance_bvh_roots(f, f["inst_inv"]))
        assert np.array_equal(roots, f["inst_inv"][:, 12].astype(np.int32))
        # every root is the first row of a BLAS block: right after the
        # TLAS, or after a row that ends a block
        miss, count = f["bvh_miss"], f["bvh_leaf_count"]
        tlas = int(f["inst_inv"][:, 13].min())
        assert all(r == tlas or (miss[r - 1] == bvh.BLAS_EXIT
                                 and count[r - 1] > 0) for r in roots)
    st = scenes[2]
    roots = st.inst_bvh_root.numpy()
    col12 = st.inst_inv[:, 12].numpy().astype(np.int32)
    assert roots[0] == roots[1] == col12[0] and roots[2] != roots[0]
    assert col12[2] == col12[0]           # the JAX build's col 12 fault


def test_non_uniform_scale_of_a_sphere_group_raises():
    for which in ("jax", "port"):
        pkg = package(which)
        grp = pkg.shapes.shapegroup([pkg.shapes.sphere()])
        inst = pkg.shapes.instance(
            grp, np.asarray(pkg.T4.scale([1.0, 2.0, 1.0]).matrix))
        sensor = {"type": "perspective", "to_world": np.eye(4), "fov": 45.0}
        with flatten_mode("0"), pytest.raises(ValueError, match="uniform"):
            pkg.build([inst], sensor)


def test_full_size_sphere_fields():
    """The chip path's two scenes, built by the port: the JAX package's
    policy flattens sphere_field(n=64, subdiv=4) (327 746 prims, K3) and
    keeps shared BLAS for n=1024 (5 243 906 effective prims, K4)."""
    pkg = package("port")
    with flatten_mode(None):
        flat = sphere_field(pkg, 64, 4)
        shared = sphere_field(pkg, 1024, 4)
    assert not flat.has_instances and flat.has_spheres
    assert flat.n_prims == 327746 and flat.bvh_node.shape[0] == 208001
    assert int((flat.prim_type == 1).sum()) == 64 and flat.cluster_k == 256
    assert flat.cluster_feat is None and flat.inst_bvh_root is None
    assert shared.has_instances and shared.has_spheres
    assert shared.n_prims == 5123 and shared.bvh_node.shape[0] == 5345
    assert shared.inst_inv.shape == (1025, 16)
    assert shared.inst_fuel == 3376194 and shared.cluster_k == 128
    assert shared.cluster_feat is None
    assert shared.inst_bvh_root.shape == (1025,)


# ---------------------------------------------------------------------------
# Brute force with a sphere
# ---------------------------------------------------------------------------

def test_brute_force_furnace_matches_jax():
    import jax.numpy as jnp
    from mitsuba2_tpu.core.vec import Vec3 as JVec3
    from mitsuba2_tpu.kernels import brute as jbrute
    sj, st = build("furnace", "jax"), build("furnace", "port")
    assert brute.takes_brute_force(st.n_prims, st.has_instances)
    rng = np.random.default_rng(3)
    o = rng.uniform(-3, 3, (N_RAYS, 3)).astype(np.float32)
    o[: N_RAYS // 2] *= 0.2                # half start inside the sphere
    aim = rng.normal(size=(N_RAYS, 3)) * 0.6
    d = aim - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tm = rng.uniform(0.5, 6.0, N_RAYS).astype(np.float32)
    jo, jd = (JVec3(*(jnp.asarray(a[:, i]) for i in range(3)))
              for a in (o, d))
    t_j, p_j, _, _ = jbrute.ray_intersect_brute(sj, jo, jd, jnp.full(
        N_RAYS, jnp.inf))
    t, p, u, v = brute.ray_intersect_brute(st, planar(o), planar(d),
                                           torch.full((N_RAYS,), np.inf))
    hit = np.isfinite(t.numpy())
    assert 0.5 < hit.mean() < 1.0
    np.testing.assert_array_equal(hit, np.isfinite(np.asarray(t_j)))
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_j))
    np.testing.assert_allclose(t.numpy()[hit], np.asarray(t_j)[hit],
                               rtol=1e-5, atol=1e-5)
    assert not u.any() and not v.any()
    occ_j = jbrute.ray_test_brute(sj, jo, jd, jnp.asarray(tm))
    occ = brute.ray_test_brute(st, planar(o), planar(d), torch.from_numpy(tm))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_j))
    assert 0.1 < occ.numpy().mean() < hit.mean()


# ---------------------------------------------------------------------------
# The K3 and K4 twins against the JAX package's BVH2 walks
# ---------------------------------------------------------------------------

class Case:
    """A sphere field in the port, probe rays on it and the reference
    answers, each computed once for the module."""

    def __init__(self, name):
        self.name = name
        self.st = build(name, "port")
        self.rays = probe_rays(self.st, N_RAYS, 2, self._closest_np)
        self._memo = {}

    @property
    def sj(self):
        return self.memo("jax_scene", lambda: build(self.name, "jax"))

    def _closest_np(self, o, d, t_max):
        out = self.closest(planar(o), planar(d), torch.from_numpy(t_max))
        return out[0].numpy(), out[1].numpy(), (
            out[4].numpy() if self.st.has_instances else None)

    def closest(self, o, d, tm):
        fn = (traverse.ray_intersect_instanced if self.st.has_instances
              else traverse.ray_intersect_preliminary)
        return fn(self.st, o, d, tm)

    def memo(self, key, fn):
        if key not in self._memo:
            self._memo[key] = fn()
        return self._memo[key]

    def port(self, kind):
        """(t, prim, u, v, inst or None, occ), numpy."""
        def run():
            o, d, tm = self.rays[kind]
            args = (planar(o), planar(d), torch.from_numpy(tm))
            out = self.closest(*args)
            occ = (traverse.ray_test_instanced if self.st.has_instances
                   else traverse.ray_test)(self.st, *args)
            out = [a.numpy() for a in out]
            return (*out[:4], out[4] if len(out) > 4 else None, occ.numpy())
        return self.memo(("port", kind), run)

    def ref(self, kind, which):
        """The JAX package's answer, its interpret-mode walks ("pallas")
        or its f32 walkers ("jnp"), read from tests/goldens/
        test_torch_spheres.npz."""
        def run():
            import jax.numpy as jnp
            from mitsuba2_tpu.core.vec import Vec3 as JVec3
            from mitsuba2_tpu.kernels import traverse_jnp, traverse_pallas
            o, d, tm = self.rays[kind]
            args = (self.sj, *(JVec3(*(jnp.asarray(a[:, i])
                                       for i in range(3))) for a in (o, d)),
                    jnp.asarray(tm))
            inst = self.st.has_instances
            if which == "pallas":
                kw = {"interpret": True}
                closest = (traverse_pallas.ray_intersect_instanced if inst
                           else traverse_pallas.ray_intersect_preliminary)
                test = (traverse_pallas.ray_test_instanced if inst
                        else traverse_pallas.ray_test)
            else:
                kw = {}
                closest = (traverse_jnp._ray_intersect_instanced if inst
                           else traverse_jnp.ray_intersect_preliminary)
                test = (traverse_jnp._ray_test_instanced if inst
                        else traverse_jnp.ray_test)
            out = [np.array(a) for a in closest(*args, **kw)]
            occ = np.array(test(*args, **kw))
            return (*out[:4], out[4] if inst else None, occ)
        return self.memo((which, kind), lambda: REFS.get(
            f"{self.name}_{which}_{kind}", run))


@pytest.fixture(scope="module", params=["field_flat", "field_shared"])
def case(request):
    return Case(request.param)


@pytest.mark.parametrize("which", ["pallas", "jnp"])
@pytest.mark.parametrize("kind", KINDS)
def test_closest_hit_twin(case, kind, which):
    t, prim, u, v, inst, _ = case.port(kind)
    t_r, prim_r, u_r, v_r, inst_r, _ = case.ref(kind, which)
    hit = np.isfinite(t)
    np.testing.assert_array_equal(hit, np.isfinite(t_r))
    assert hit.mean() > 0.1
    np.testing.assert_array_equal(prim[~hit], -1)
    same = prim == prim_r
    if inst is not None:
        np.testing.assert_array_equal(inst[~hit], -1)
        same &= inst == inst_r
    assert same[hit].mean() > 0.99
    sphere = case.st.prim_type.numpy()[np.maximum(prim, 0)] == 1
    tri = hit & ~sphere
    np.testing.assert_allclose(t[tri], t_r[tri], rtol=1e-5, atol=1e-5)
    if (hit & sphere).any():
        t_s, t_rs = t[hit & sphere], t_r[hit & sphere]
        assert np.isclose(t_s, t_rs, rtol=1e-5, atol=1e-5).mean() >= 0.99
        np.testing.assert_allclose(t_s, t_rs, rtol=1e-4)
    sel = hit & same
    np.testing.assert_allclose(u[sel], u_r[sel], atol=1e-4)
    np.testing.assert_allclose(v[sel], v_r[sel], atol=1e-4)
    assert not u[sphere].any() and not v[sphere].any()
    if kind == "random":     # a quarter of the random rays aim at spheres
        assert (hit & sphere).sum() > 100


@pytest.mark.parametrize("which", ["pallas", "jnp"])
@pytest.mark.parametrize("kind", KINDS)
def test_any_hit_twin(case, kind, which):
    t, occ = case.port(kind)[0], case.port(kind)[5]
    np.testing.assert_array_equal(occ, case.ref(kind, which)[5])
    # occlusion within t_max is a hit of the closest-hit walk within it
    np.testing.assert_array_equal(occ, np.isfinite(t))


def test_presorted_dispatch_unsorts_uv(case):
    """The presort only reorders: every output of the sorted dispatch,
    u and v included (the BVH2 walks emit them), equals the unsorted
    walk's lane for lane."""
    o, d, tm = case.rays["bounce"]
    tm = tm.copy()
    tm[::5] = 0.0
    ray = Ray(planar(o), planar(d), torch.from_numpy(tm))
    outs_s = scene_mod._preliminary_dispatch(case.st, ray, sort=True)
    outs_u = scene_mod._preliminary_dispatch(case.st, ray, sort=False)
    assert traverse.emits_uv(case.st, scene_mod._pick_backend(case.st))
    for a, b in zip(outs_s, outs_u):
        assert (a is None and b is None) or torch.equal(a, b)
    assert bool(outs_s[2].any()) and bool(outs_s[3].any())
    assert not torch.isfinite(outs_s[0][::5]).any()
    occ = scene_mod.ray_test(case.st, ray)
    assert torch.equal(occ, torch.isfinite(outs_u[0]))


def test_shading_on_sphere_hits_matches_jax(case):
    """compute_surface_interaction on the oracle's own hits in both
    packages, sphere hits among them: flat, and lifted to world space by
    the instance (the center moved, the radius scaled)."""
    import jax.numpy as jnp
    from mitsuba2_tpu.core.geometry import Ray as JRay
    from mitsuba2_tpu.core.vec import Vec2 as JVec2, Vec3 as JVec3
    from mitsuba2_tpu.render.interaction import PreliminaryIntersection
    from mitsuba2_tpu.scene import scene as jscene
    n_sphere = 0
    for kind in ("camera", "random"):
        o, d, tm = case.rays[kind]
        t, prim, u, v, inst, _ = case.ref(kind, "jnp")
        si_j = jscene.compute_surface_interaction(
            case.sj, JRay(o=JVec3(*(jnp.asarray(o[:, i]) for i in range(3))),
                          d=JVec3(*(jnp.asarray(d[:, i]) for i in range(3))),
                          maxt=jnp.asarray(tm), time=jnp.zeros(tm.shape[0])),
            PreliminaryIntersection(
                t=jnp.asarray(t), prim_index=jnp.asarray(prim),
                prim_uv=JVec2(jnp.asarray(u), jnp.asarray(v)),
                inst=None if inst is None else jnp.asarray(inst)))
        si_t = scene_mod.compute_surface_interaction(
            case.st, Ray(planar(o), planar(d), torch.from_numpy(tm)),
            *(torch.from_numpy(a) for a in (t, prim, u, v)),
            None if inst is None else torch.from_numpy(inst))
        valid = si_t.valid.numpy()
        np.testing.assert_array_equal(valid, np.asarray(si_j.valid))
        n_sphere += int((valid & (case.st.prim_type.numpy()[
            np.maximum(prim, 0)] == 1)).sum())

        def close(a, b):
            np.testing.assert_allclose(b.numpy()[valid],
                                       np.asarray(a)[valid], rtol=1e-5,
                                       atol=1e-5)
        close(si_j.t, si_t.t)
        for c in "xyz":
            close(getattr(si_j.p, c), getattr(si_t.p, c))
            close(getattr(si_j.n, c), getattr(si_t.n, c))
            close(getattr(si_j.sh_frame.n, c), getattr(si_t.sh_frame.n, c))
            close(getattr(si_j.wi, c), getattr(si_t.wi, c))
        close(si_j.uv.x, si_t.uv.x)
        close(si_j.uv.y, si_t.uv.y)
        np.testing.assert_array_equal(si_t.shape.numpy(),
                                      np.asarray(si_j.shape))
    assert n_sphere > 100


def test_golden_is_fresh(case):
    """The golden's f32-walker answer on camera rays recomputed now."""
    import jax.numpy as jnp
    from mitsuba2_tpu.core.vec import Vec3 as JVec3
    from mitsuba2_tpu.kernels import traverse_jnp
    o, d, tm = case.rays["camera"]
    args = (case.sj, *(JVec3(*(jnp.asarray(a[:, i]) for i in range(3)))
                       for a in (o, d)), jnp.asarray(tm))
    closest = (traverse_jnp._ray_intersect_instanced
               if case.st.has_instances
               else traverse_jnp.ray_intersect_preliminary)
    t, prim = closest(*args)[:2]
    stored = case.ref("camera", "jnp")
    np.testing.assert_array_equal(stored[0], np.asarray(t))
    np.testing.assert_array_equal(stored[1], np.asarray(prim))


@pytest.mark.parametrize("seed", [0])
def test_render_matches_jax(case, seed):
    """A 32x32 render of the sphere field: the JAX package traverses it
    with its f32 BVH2 walkers, the port with the K3 or K4 twins; same
    seed, so the same PCG32 streams. Tolerances as
    tests/test_torch_render.py's gallery render."""
    import mitsuba2_tpu as mi
    kw = dict(width=32, height=32, spp=1, spp_per_pass=1, max_depth=3,
              rr_depth=8)
    img_j = REFS.get(f"{case.name}_render_{seed}", lambda: np.asarray(
        mi.render(case.sj, mi.RenderConfig(**kw), seed=seed)))
    img_t = mt.render(case.st, mt.RenderConfig(**kw), seed=seed,
                      device="cpu").numpy()
    assert img_t.shape == img_j.shape == (32, 32, 3)
    assert np.isfinite(img_t).all() and img_t.mean() > 0
    close = np.isclose(img_t, img_j, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99
    np.testing.assert_allclose(img_t.mean(), img_j.mean(), rtol=1e-3)


# ---------------------------------------------------------------------------
# The out-of-order groups: the port against the same scene flattened
# ---------------------------------------------------------------------------

def out_of_order_rays(n=N_RAYS):
    """Rays down +z aimed at the three instances' boxes, a third each."""
    rng = np.random.default_rng(4)
    x = np.repeat([-3.0, 0.0, 3.0], -(-n // 3))[:n]
    o = np.stack([x + rng.uniform(-1.2, 1.2, n), rng.uniform(-1.2, 1.6, n),
                  np.full(n, -5.0)], -1).astype(np.float32)
    d = np.tile(np.float32([0, 0, 1]), (n, 1))
    return o, d, np.full(n, np.inf, np.float32)


def test_out_of_order_groups_match_the_flattened_scene():
    """Instances A, A, B: the instanced walk enters each instance at its
    own BLAS root and hits what the flattened scene's BVH2 walk hits, in
    the instance whose flattened copy was hit. The flattened scene is
    small enough for brute force, so its walk tables are packed here."""
    pkg = package("port")
    with flatten_mode("0"):
        shared = out_of_order_scene(pkg)
    with flatten_mode("1"), recorded_fields() as got:
        flat = out_of_order_scene(pkg)
    assert shared.has_instances and not flat.has_instances
    tabs = [torch.from_numpy(a) for a in convert.bvh_walk_tables(got[0])]
    o, d, tm = out_of_order_rays()
    o, d, tm = planar(o), planar(d), torch.from_numpy(tm)
    t, _, _, _, inst = traverse.ray_intersect_instanced(shared, o, d, tm)
    t_f, p_f, _, _ = traverse.bvh_closest_hit(
        *tabs, o.x, o.y, o.z, d.x, d.y, d.z, tm, tabs[0].shape[0] + 64)
    hit = torch.isfinite(t)
    assert torch.equal(hit, torch.isfinite(t_f))
    torch.testing.assert_close(t[hit], t_f[hit], rtol=1e-4, atol=0.0)
    # flattened shapes come in instance order: A's two, A's two, B's one
    shape_inst = torch.tensor([0, 0, 1, 1, 2])
    inst_f = shape_inst[flat.prim_shape[p_f[hit].long()].long()]
    assert torch.equal(inst[hit].long(), inst_f)
    on_b = hit & (o.x > 1.5)
    assert on_b.sum() > 200 and (inst[on_b] == 2).all()
    occ = traverse.ray_test_instanced(shared, o, d, tm)
    assert torch.equal(occ, hit)


# ---------------------------------------------------------------------------
# Emitters, the golden furnace
# ---------------------------------------------------------------------------

def _sphere_light_scene(pkg):
    sh, T4 = pkg.shapes, pkg.T4
    floor = sh.rectangle(bsdf={"type": "diffuse"}).transformed(
        (T4.translate([0, -1, 0]) @ T4.rotate([1, 0, 0], -90.0)
         @ T4.scale([4.0, 4.0, 1.0])).matrix)
    bulb = sh.sphere(center=(0.3, 1.2, -0.2), radius=0.4,
                     emitter={"type": "area", "radiance": [4.0, 3.0, 2.0]})
    sensor = {"type": "perspective", "to_world": np.eye(4), "fov": 45.0}
    return pkg.build([floor, bulb], sensor)


def test_sphere_area_emitter_sample_matches_jax():
    """sample_direction on a sphere light in both packages, same numbers."""
    import jax.numpy as jnp
    import mitsuba2_tpu as mi
    from mitsuba2_tpu.core.vec import Vec3 as JVec3
    from mitsuba2_tpu.render import emitters as jemitters
    from mitsuba2_tpu_torch.core.vec import Vec3
    from mitsuba2_tpu_torch.render import emitters
    sj = _sphere_light_scene(package("jax"))
    st = _sphere_light_scene(package("port"))
    assert st.has_spheres and float(st.emitter_area[0]) == pytest.approx(
        4 * np.pi * 0.16, rel=1e-6)
    u = np.random.default_rng(8).uniform(0, 1, (6, 4096)).astype(np.float32)
    ref_p = u[:3] * 4.0 - 2.0
    ds_j, e_j = jemitters.sample_direction(
        sj, JVec3(*(jnp.asarray(a) for a in ref_p)), None, jnp.asarray(u[3]),
        (jnp.asarray(u[4]), jnp.asarray(u[5])), mi.RenderConfig())
    ds_t, e_t = emitters.sample_direction(
        st, Vec3(*(torch.from_numpy(np.ascontiguousarray(a))
                   for a in ref_p)), None,
        torch.from_numpy(u[3]), (torch.from_numpy(u[4]),
                                 torch.from_numpy(u[5])), mt.RenderConfig())
    ok = ds_t.pdf.numpy() > 0
    assert 0.2 < ok.mean() < 1.0
    np.testing.assert_array_equal(ok, np.asarray(ds_j.pdf) > 0)
    for c in "xyz":
        np.testing.assert_allclose(getattr(ds_t.d, c).numpy(),
                                   np.asarray(getattr(ds_j.d, c)),
                                   rtol=1e-5, atol=1e-6)
    # the solid-angle pdf divides by the cosine at the light: last-bit
    # differences grow on grazing samples (tests/test_torch_render.py)
    np.testing.assert_allclose(ds_t.pdf.numpy(), np.asarray(ds_j.pdf),
                               rtol=1e-3)
    np.testing.assert_allclose(ds_t.dist.numpy(), np.asarray(ds_j.dist),
                               rtol=1e-5)
    for a, b in zip(e_j.ch, e_t.ch):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)


def test_furnace_golden():
    """The z-test of tests/test_golden.py on its furnace golden, with the
    port's images: same scene (albedo 0.7), configuration, seed and pass
    split (render_with_variance's statistics from the per-pass images)."""
    from mitsuba2_tpu_torch.render import film, integrators
    ref = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                               "furnace.npz"))["image"]
    cfg = mt.RenderConfig(width=24, height=24, spp=64, spp_per_pass=16,
                          max_depth=8, rr_depth=99)
    scene = mt.furnace(albedo=0.7, device="cpu")
    n_passes = cfg.spp // cfg.spp_per_pass
    imgs = []
    with torch.inference_mode():
        for s in integrators.pass_seeds(3, n_passes):
            img, w = integrators.render_pass(scene, cfg, s, device="cpu")
            imgs.append(film.develop(img, w).numpy())
    imgs = np.stack(imgs)
    mean = imgs.mean(0)
    var = ((imgs ** 2).mean(0) - mean ** 2) / max(n_passes - 1, 1)
    sigma = np.sqrt(var + 1e-8) + 5e-3 * np.abs(mean)
    z = np.abs(mean - ref) / sigma
    assert np.median(z) < 2.0, f"median z {np.median(z):.2f}"
    assert (z > 6.0).mean() < 0.02
    np.testing.assert_allclose(np.minimum(mean, 2.0).mean(),
                               np.minimum(ref, 2.0).mean(), rtol=0.05)


# ---------------------------------------------------------------------------
# Wrappers, and the CUDA source: emulated on the CPU, on the card where
# there is one
# ---------------------------------------------------------------------------

def kernel_args(st):
    """(tables, step cap, C entry prefix) of a scene's BVH2 walks."""
    tabs = (st.bvh_node, st.bvh_link, st.bvh_pair, st.bvh_prim)
    if st.has_instances:
        return (tabs + (st.inst_inv, st.inst_bvh_root), st.inst_fuel + 64,
                "inst_bvh_")
    return tabs, st.bvh_node.shape[0] + 64, "bvh_"


def c_tables(tabs, name):
    """The tables the C entry of BVH2 wrapper `name` takes: the pair
    walks' (traverse.PAIR_WALKS) all of kernel_args's, the threaded
    walks' all but bvh_pair."""
    return tabs if name in traverse.PAIR_WALKS else tabs[:2] + tabs[3:]


def twins(prefix):
    return (getattr(traverse, f"{prefix}closest_hit_plain"),
            getattr(traverse, f"{prefix}any_hit_plain"))


def kind_rays(case, kind, device="cpu"):
    o, d, tm = case.rays[kind]
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (*o.T, *d.T, tm))


def test_bvh_wrappers_check_and_count(case):
    tabs, fuel, prefix = kernel_args(case.st)
    closest = getattr(traverse, f"{prefix}closest_hit")
    any_hit = getattr(traverse, f"{prefix}any_hit")
    o, d, tm = (torch.zeros(8), torch.ones(8), torch.full((8,), np.inf))
    rays = (o, o, o, d, d, d, tm)
    before = (closest.launches, any_hit.launches)
    outs = closest(*tabs, *rays, fuel)
    assert len(outs) == (5 if case.st.has_instances else 4)
    assert outs[0].shape == (8,) and outs[1].dtype == torch.int32
    any_hit(*tabs, *rays, fuel)
    # CPU tensors go to the twins: no kernel launch is counted
    assert (closest.launches, any_hit.launches) == before
    with pytest.raises(ValueError, match="float32"):
        closest(*tabs, *rays[:6], tm.double(), fuel)
    with pytest.raises(ValueError, match="bvh_link"):
        any_hit(tabs[0], tabs[1].long(), *tabs[2:], *rays, fuel)
    with pytest.raises(ValueError, match="bvh_pair"):
        closest(*tabs[:2], tabs[2][:-1], *tabs[3:], *rays, fuel)
    with pytest.raises(ValueError, match="int32"):
        any_hit(*tabs, *rays, 1 << 31)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return build_emulation(tmp_path_factory.mktemp("bvh_walk_emu"))


@pytest.mark.parametrize("kind", KINDS)
def test_cuda_source_emulated_matches_twins(case, emulated, kind):
    """The CUDA source run warp by warp (g++) against the twins: the same
    f32 operations in the same order, so bit-equal; and the walk work the
    twins count (chip_smoke.py's bound rests on it) equals the loads the
    kernels make. The threaded walk (K4's closest hit): two float4 of a
    node row and two links a step. The pair walks (K3's closest and any
    hit, K4's any hit; traverse.PAIR_WALKS): two float4 of a node row a
    root test or a fallback step, four of a pair row an expansion, no
    links but a fallback's, and each stack pop counted apart (`pops`).
    All: three float4 of a prim row a test, three of an inst_inv row and
    one root an entry; and on K4's closest hit, whose warps test a step's
    due prims together, the passes the emulation counts (`leaf_passes`).
    At the kernels' 32-entry stack no lane falls back to the threaded
    walk here."""
    for stats in assert_emulated_matches_twins(emulated, case.st,
                                               kind_rays(case, kind)):
        assert stats["fallback_steps"] == 0


@pytest.mark.parametrize("case", ["field_shared", "field_flat"],
                         indirect=True)
@pytest.mark.parametrize("kind", KINDS)
def test_k4_source_emulated_tail_and_dead_lanes(case, emulated, kind):
    """K4 (field_shared) and K3 (field_flat) at n = 512 + 37, not a
    multiple of a warp, with dead lanes (t_max <= 0) amid the live ones:
    every lane of K4's closest hit takes part in its warp's leaf passes
    (the emulation aborts on a lane that leaves early), and the results
    stay bit-equal and the loads equal to the twins' counts."""
    rays = [torch.cat([a[:512], a[:37]]) for a in kind_rays(case, kind)]
    tm = rays[6]
    tm[[5, 40, 41, 300, 530]] = 0.0
    tm[[6, 200, 545]] = -1.0
    assert tm.shape[0] == 549 and bool((tm > 0).any())
    assert_emulated_matches_twins(emulated, case.st, tuple(rays))


@pytest.fixture(scope="module")
def emulated_stack2(tmp_path_factory):
    """The source built with a pair-walk stack of two entries."""
    return build_emulation(tmp_path_factory.mktemp("bvh_walk_emu_stack2"),
                           BVH_PAIR_STACK=2)


@pytest.mark.parametrize("kind", ["camera", "bounce"])
def test_pair_walk_overflow_emulated_matches_twins(case, emulated_stack2,
                                                   kind):
    """At a stack of two entries a push finds it full on many lanes, flat
    and instanced, and the lane walks on by the threaded walk from the
    child it was entering, inside an instance with the TLAS leaf's miss
    link: t, prim, u, v and the occlusion stay bit-equal to the twins,
    and the loads equal the twins' counts at that stack (the fallback's
    steps, `fallback_steps`, among them): K3's closest and any hit flat,
    K4's any hit instanced."""
    for stats in assert_emulated_matches_twins(
            emulated_stack2, case.st, kind_rays(case, kind), pair_stack=2):
        assert stats["fallback_steps"] > 0
        if case.st.has_instances:
            assert stats["fallback_rets"] > 0


def assert_emulated_matches_twins(emulated, st, rays,
                                  pair_stack=traverse.BVH_PAIR_STACK):
    """The CUDA source of the scene `st`'s BVH2 walks (K3 flat, K4
    instanced), emulated (with a pair-walk stack of `pair_stack`
    entries), against their twins on the torch rays `rays`:
    test_cuda_source_emulated_matches_twins's checks. Returns the pair
    walks' counts, one dict each (K3's closest and any hit, K4's any
    hit)."""
    tabs, fuel, prefix = kernel_args(st)
    n = rays[0].shape[0]
    inst = st.has_instances
    counted = (st.bvh_node, st.bvh_prim, st.inst_inv, st.inst_bvh_root,
               st.bvh_pair, st.bvh_link)
    closest_p, any_p = twins(prefix)
    pair_stats = []
    for any_hit in (False, True):
        name = f"{prefix}{'any' if any_hit else 'closest'}_hit"
        ptrs = [a.data_ptr() for a in c_tables(tabs, name) + rays]
        loads = load_counters(emulated, counted)
        if any_hit:
            out = torch.empty(n, dtype=torch.bool)
            assert getattr(emulated, f"mts_{name}")(
                *ptrs, out.data_ptr(), n, fuel, None) == 0
        else:
            out = (torch.empty(n), torch.empty(n, dtype=torch.int32),
                   torch.empty(n), torch.empty(n)) + (
                (torch.empty(n, dtype=torch.int32),) if inst else ())
            assert getattr(emulated, f"mts_{name}")(
                *ptrs, *(a.data_ptr() for a in out), n, fuel, None) == 0
        stats = {}
        pair_walk = name in traverse.PAIR_WALKS
        kw = dict(pair_stack=pair_stack) if pair_walk else {}
        twin = (any_p if any_hit else closest_p)(*tabs, *rays, fuel,
                                                 chunk=500, stats=stats,
                                                 **kw)
        if any_hit:
            assert torch.equal(out, twin)
        else:
            assert all(torch.equal(a, b) for a, b in zip(out, twin))
        tests = stats.get("tri_tests", 0) + stats.get("sphere_tests", 0)
        entries = stats.get("instance_entries", 0)
        assert loads[1] == 3 * tests
        assert loads[2] == 3 * entries and loads[3] == entries
        assert tests > 0 and (entries > 0) == inst
        passes = stats.get("leaf_passes", 0)
        if pair_walk:
            fall = stats["fallback_steps"]
            assert loads[0] == 2 * (stats["root_tests"] + fall)
            assert loads[4] == 4 * stats["pair_rows"]
            assert loads[5] == 2 * fall + stats["fallback_rets"]
            assert work_counter(emulated).value == stats["pops"]
            assert stats["pair_rows"] > 0 and stats["pops"] > 0
            pair_stats.append(stats)
        else:
            assert loads[0] == 2 * stats["node_steps"]
            assert loads[4] == 0 and loads[5] == 2 * stats["node_steps"]
            assert work_counter(emulated).value == passes
        if inst and not any_hit:
            # a pass tests up to 32 of a warp's due prims
            assert tests / 32 <= passes <= tests
        else:
            assert passes == 0
    return pair_stats


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("kind", KINDS)
def test_cuda_bvh_kernels_match_twins(case, cuda, kind):
    st = mt.to_device(case.st, cuda)
    tabs, fuel, prefix = kernel_args(st)
    rays = kind_rays(case, kind, cuda)
    closest = getattr(traverse, f"{prefix}closest_hit")
    any_hit = getattr(traverse, f"{prefix}any_hit")
    before = closest.launches
    out = closest(*tabs, *rays, fuel)
    occ = any_hit(*tabs, *rays, fuel)
    torch.cuda.synchronize()
    assert closest.launches == before + 1
    closest_p, any_p = twins(prefix)
    out_p = closest_p(*tabs, *rays, fuel)
    occ_p = any_p(*tabs, *rays, fuel)
    if st.has_instances:
        # K4's warp-wide leaf tests keep the serial walk's order and tie
        # rule, and --fmad=false its rounding: t, prim, u, v and instance
        # bit-equal; its pair walk visits the leaves in the same order:
        # the occlusion too
        assert all(torch.equal(a, b) for a, b in zip(out, out_p))
        assert torch.equal(occ, occ_p)
    else:
        # K3's pair walks: the threaded walk's leaves in its order, with
        # the same t_best at each test: t, prim, u, v and the occlusion
        assert all(torch.equal(a, b) for a, b in zip(out, out_p))
        assert torch.equal(occ, occ_p)
    hit = torch.isfinite(out_p[0])
    assert torch.equal(torch.isfinite(out[0]), hit)
    same = out[1] == out_p[1]
    if len(out) > 4:
        same &= out[4] == out_p[4]
    assert same[hit].float().mean() >= 0.999
    torch.testing.assert_close(out[0][hit], out_p[0][hit], rtol=1e-5,
                               atol=1e-5)
    assert (occ == occ_p).float().mean() >= 0.999
