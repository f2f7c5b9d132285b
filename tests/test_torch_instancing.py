"""Shared-BLAS instancing in the PyTorch port against the JAX package.

The scene build (two-level tables, instance transforms, the constant
emitter) is held byte-equal; the instanced cluster-walk twins are held to
the JAX package's f32 instanced BVH2 oracle (traverse_jnp) and to its
interpret-mode Pallas kernels, and the CUDA source is run against the
twins through the g++ emulation of tests/test_torch_traverse.py. Small
instanced scenes are flattened by the JAX package's policy, so the
shared-BLAS cases set MI_FLATTEN_INSTANCES=0 as tests/test_instancing.py
does.

Tolerances, as tests/test_torch_traverse.py holds the flat walk:
- hit masks equal; prim and instance ids equal on more than 99% of hit
  lanes (an exact tie between two triangles, or two instances of a group
  at one t, may resolve either way);
- vs traverse_jnp (exact f32 Möller–Trumbore): t at rtol 1e-5 / atol
  1e-5, the atol for the plane form's absolute error near t = 0;
- vs interpret-mode Pallas (split-bf16 plane dots): t at rtol 1e-3 /
  atol 1e-5, or the port the closer of the two to the oracle.

The JAX package's walk answers and renders are committed (tests/goldens/
test_torch_instancing.npz); one is recomputed live.
"""
import contextlib
import functools
import types

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.core.geometry import Ray
from mitsuba2_tpu_torch.core.vec import Vec3
from mitsuba2_tpu_torch.kernels import brute, traverse
from mitsuba2_tpu_torch.probe_rays import KINDS, probe_rays
from mitsuba2_tpu_torch.scene import scene as scene_mod
from mitsuba2_tpu_torch.scene.scene import FIELDS, INST_FIELDS

from goldens.jax_refs import Refs
from test_torch_traverse import (assert_kernel_work, build_emulation,
                                 load_counters, planar, work_counter)

# one intra-op thread: the suite's test processes share the cores
# (pytest-xdist), and torch's OpenMP regions stall when they
# oversubscribe them
torch.set_num_threads(1)

REFS = Refs("test_torch_instancing")
N_RAYS = 2048
META = ("has_instances", "inst_fuel", "inst_mxu_fuel", "n_emitters",
        "env_emitter", "emitter_kinds", "n_shapes", "cluster_k",
        "mat_families", "n_prims")


@contextlib.contextmanager
def flatten_mode(mode):
    """MI_FLATTEN_INSTANCES for the builds inside (None: unset)."""
    with pytest.MonkeyPatch.context() as mp:
        if mode is None:
            mp.delenv("MI_FLATTEN_INSTANCES", raising=False)
        else:
            mp.setenv("MI_FLATTEN_INSTANCES", mode)
        mp.delenv("MI_FLATTEN_MAX", raising=False)
        yield


@contextlib.contextmanager
def recorded_fields():
    """The numpy tables (scene.build_fields' output, what the port uploads
    from) of each scene the port builds inside the block, in build order.
    The device holds only the tables of the walk a scene takes, so the
    tables are held byte-equal to the JAX package's on the host."""
    got = []
    build_fields = scene_mod.build_fields

    def record(*a, **kw):
        got.append(build_fields(*a, **kw))
        return got[-1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scene_mod, "build_fields", record)
        yield got


def assert_port_tables(jax_f, port_f, st):
    """The port's host tables `port_f` byte-equal to the JAX package's
    `jax_f`; each of them that scene `st` holds on its device equal to its
    host table; the walk tables of the walk `st` takes, and only those,
    on the device (the BVH2 walks' on a scene holding a sphere or under
    MXU_LEAVES off, the cluster walks' on the others, none for brute
    force)."""
    for k, a in jax_f.items():
        b = port_f[k]
        if isinstance(a, (int, tuple)):     # walk bounds, param_paths
            assert a == b, k
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k
        held = getattr(st, k, None)
        if held is not None:
            assert np.array_equal(held.cpu().numpy(), b), k
    walk = not brute.takes_brute_force(st.n_prims, st.has_instances)
    bvh2 = walk and traverse.takes_bvh2(st.has_spheres)
    cluster = walk and not bvh2
    for k in ("bvh_node", "bvh_link", "bvh_prim", "bvh_pair"):
        assert (getattr(st, k) is not None) == bvh2, k
    assert (st.inst_bvh_root is not None) == (bvh2 and st.has_instances)
    for k in scene_mod.CLUSTER_FIELDS + ("cluster_feat", "mxu_ccount"):
        assert (getattr(st, k) is not None) == cluster, k
    for k in scene_mod.UPLOAD_FIELDS:
        assert not hasattr(st, k), k


def package(which):
    """A package's scene-building modules, under common names. JAX is
    imported only for "jax", so that the card-only cases also run where
    it is not installed (`--noconftest -k cuda`)."""
    if which == "jax":
        from mitsuba2_tpu.core.geometry import Transform4 as JT4
        from mitsuba2_tpu.scene import presets as jpresets
        from mitsuba2_tpu.scene import shapes as jshapes
        from mitsuba2_tpu.scene.scene import build_scene as jbuild
        return types.SimpleNamespace(shapes=jshapes, T4=JT4, build=jbuild,
                                     field=jpresets.instanced_field,
                                     presets=jpresets)
    from mitsuba2_tpu_torch.core.geometry import Transform4
    from mitsuba2_tpu_torch.scene import presets, shapes
    return types.SimpleNamespace(
        shapes=shapes, T4=Transform4,
        build=functools.partial(mt.build_scene, device="cpu"),
        field=functools.partial(mt.instanced_field, device="cpu"),
        presets=presets)


def groups_scene(pkg):
    """Two groups instanced in the order A, B, A, B, A (rotated, scaled)
    over a plain floor, under a constant sky: 28 stored triangles, few
    enough for brute force, which an instanced scene must not take."""
    sh, T4 = pkg.shapes, pkg.T4
    a = sh.shapegroup([
        sh.cube(bsdf={"type": "diffuse", "reflectance": [0.6, 0.3, 0.2]}),
        sh.rectangle(bsdf={"type": "diffuse"}).transformed(
            (T4.translate([0, 1.5, 0]) @ T4.scale([0.4] * 3)).matrix)])
    b = sh.shapegroup([sh.cube(
        bsdf={"type": "diffuse", "reflectance": [0.2, 0.5, 0.3]}
    ).transformed(T4.scale([0.5, 1.5, 0.5]).matrix)])
    floor = sh.rectangle(bsdf={"type": "diffuse"}).transformed(
        (T4.translate([0, 0, -2]) @ T4.scale([20, 20, 1])).matrix)
    insts = [sh.instance(
        (a, b)[k % 2], np.asarray((T4.translate([k * 3.0, 0, 0])
                                   @ T4.rotate([0, 1, 0], 30.0 * k)
                                   @ T4.scale([0.6] * 3)).matrix))
        for k in range(5)]
    sensor = {"type": "perspective", "fov": 60,
              "to_world": np.asarray(T4.look_at(
                  origin=[6, 2, 9], target=[6, 0, 0], up=[0, 1, 0]).matrix)}
    return pkg.build([floor] + insts, sensor,
                     [{"type": "constant", "radiance": [1.0, 1.0, 1.0]}])


SCENES = {
    "field_shared": (lambda pkg: pkg.field(n=6, subdiv=2), "0"),
    "field_flattened": (lambda pkg: pkg.field(n=6, subdiv=2), None),
    "groups_shared": (groups_scene, "0"),
}


def build(name, which):
    make, mode = SCENES[name]
    with flatten_mode(mode):
        return make(package(which))


def build_pair(name):
    """The JAX scene, the port's and the port's host tables."""
    with recorded_fields() as got:
        st = build(name, "port")
    return build(name, "jax"), st, got[0]


def jax_fields(sj):
    keys = FIELDS + (INST_FIELDS if sj.has_instances else ())
    return {**{k: (getattr(sj, k) if isinstance(getattr(sj, k), int)
                   else np.asarray(getattr(sj, k))) for k in keys},
            "param_paths": sj.param_paths}


def assert_same_scene(sj, st, fields):
    assert_port_tables(jax_fields(sj), fields, st)
    if not sj.has_instances:
        assert st.inst_inv is None and st.inst_fwd is None
    for k in META:
        assert getattr(st, k) == getattr(sj, k), k


@pytest.fixture(scope="module", params=sorted(SCENES))
def pair(request):
    return request.param, *build_pair(request.param)


def test_tables_byte_equal(pair):
    name, sj, st, fields = pair
    assert st.has_instances == name.endswith("shared")
    assert_same_scene(sj, st, fields)


def test_scene_from_numpy_equals_own_build(pair):
    _, sj, st, _ = pair
    conv = mt.scene_from_numpy(jax_fields(sj), device="cpu")
    for f in scene_mod.SceneData.__dataclass_fields__:
        a, b = getattr(conv, f), getattr(st, f)
        if torch.is_tensor(a):
            assert a.dtype == b.dtype and torch.equal(a, b), f
        else:
            assert a == b, f


def test_full_size_field_keeps_shared_blas():
    """instanced_field(n=1024, subdiv=4): 5 242 882 effective triangles,
    above the 4M flatten cap, so the default policy keeps shared BLAS."""
    with flatten_mode(None), recorded_fields() as got:
        sj = package("jax").field(n=1024, subdiv=4)
        st = package("port").field(n=1024, subdiv=4)
    assert_same_scene(sj, st, got[0])
    assert st.n_prims == 5122 and st.inst_inv.shape == (1025, 16)
    assert st.mxu_node_f.shape == (2163, 16)
    assert got[0]["mxu_feat"].shape == (16, 29696) and st.cluster_k == 128
    assert st.inst_mxu_fuel == 117826 and st.emitter_kinds == (2,)


def test_instanced_scene_never_takes_brute_force():
    st = build("groups_shared", "port")
    assert st.n_prims <= brute.MAX_BRUTE_PRIMS
    assert not brute.takes_brute_force(st.n_prims, st.has_instances)
    assert st.cluster_feat is not None and st.bvh_node is None


# ---------------------------------------------------------------------------
# The twins against the JAX package's instanced walks
# ---------------------------------------------------------------------------

class Case:
    """A shared-BLAS scene in both packages, probe rays on it and every
    reference answer, each computed once for the module."""

    def __init__(self, name):
        self.name = name
        self.st = build(name, "port")
        self.rays = probe_rays(self.st, N_RAYS, 1, self._closest_np)
        self._memo = {}

    @property
    def sj(self):
        return self.memo("jax_scene", lambda: build(self.name, "jax"))

    def _closest_np(self, o, d, t_max):
        t, prim, _, _, inst = traverse.ray_intersect_instanced(
            self.st, planar(o), planar(d), torch.from_numpy(t_max))
        return t.numpy(), prim.numpy(), inst.numpy()

    def memo(self, key, fn):
        if key not in self._memo:
            self._memo[key] = fn()
        return self._memo[key]

    def port(self, kind):
        def run():
            o, d, tm = self.rays[kind]
            t, prim, u, v, inst = traverse.ray_intersect_instanced(
                self.st, planar(o), planar(d), torch.from_numpy(tm))
            assert not u.any() and not v.any()
            occ = traverse.ray_test_instanced(
                self.st, planar(o), planar(d), torch.from_numpy(tm))
            return t.numpy(), prim.numpy(), inst.numpy(), occ.numpy()
        return self.memo(("port", kind), run)

    def ref(self, kind, which):
        """The JAX package's answer, its interpret-mode walk ("pallas") or
        its f32 walker ("jnp"), read from tests/goldens/
        test_torch_instancing.npz."""
        def run():
            import jax.numpy as jnp
            from mitsuba2_tpu.core.vec import Vec3 as JVec3
            from mitsuba2_tpu.kernels import traverse_jnp, traverse_pallas

            def jplanar(a):
                return JVec3(*(jnp.asarray(a[:, i]) for i in range(3)))
            o, d, tm = self.rays[kind]
            args = (self.sj, jplanar(o), jplanar(d), jnp.asarray(tm))
            if which == "pallas":
                t, prim, _, _, inst = traverse_pallas.ray_intersect_instanced(
                    *args, interpret=True)
                occ = traverse_pallas.ray_test_instanced(*args,
                                                         interpret=True)
            else:
                t, prim, _, _, inst = traverse_jnp._ray_intersect_instanced(
                    *args)
                occ = traverse_jnp._ray_test_instanced(*args)
            return tuple(np.array(a) for a in (t, prim, inst, occ))
        return self.memo((which, kind), lambda: REFS.get(
            f"{self.name}_{which}_{kind}", run))


@pytest.fixture(scope="module")
def case():
    return Case("field_shared")


@pytest.fixture(scope="module")
def groups_case():
    return Case("groups_shared")


def check_closest(port, ref, oracle_t=None, min_hit=0.1):
    t, prim, inst, _ = port
    t_r, prim_r, inst_r, _ = ref
    hit = np.isfinite(t)
    np.testing.assert_array_equal(hit, np.isfinite(t_r))
    assert hit.mean() > min_hit
    np.testing.assert_array_equal(prim[~hit], -1)
    np.testing.assert_array_equal(inst[~hit], -1)
    assert (inst[hit] >= 0).all()
    same = (prim == prim_r) & (inst == inst_r)
    assert same[hit].mean() > 0.99
    if oracle_t is None:
        np.testing.assert_allclose(t[hit], t_r[hit], rtol=1e-5, atol=1e-5)
        return
    t, t_r, t_o = t[hit], t_r[hit], oracle_t[hit]
    band = np.isclose(t, t_r, rtol=1e-3, atol=1e-5)
    closer = np.abs(t - t_o) <= np.abs(t_r - t_o)
    assert (band | closer).all()


@pytest.mark.parametrize("which", ["pallas", "jnp"])
@pytest.mark.parametrize("kind", KINDS)
def test_closest_hit_twin(case, kind, which):
    oracle = case.ref(kind, "jnp")[0] if which == "pallas" else None
    check_closest(case.port(kind), case.ref(kind, which), oracle)


@pytest.mark.parametrize("which", ["pallas", "jnp"])
@pytest.mark.parametrize("kind", KINDS)
def test_any_hit_twin(case, kind, which):
    t, _, _, occ = case.port(kind)
    np.testing.assert_array_equal(occ, case.ref(kind, which)[3])
    # occlusion within t_max is a hit of the closest-hit walk within it
    np.testing.assert_array_equal(occ, np.isfinite(t))


@pytest.mark.parametrize("kind", KINDS)
def test_twins_on_two_groups(groups_case, kind):
    """Two groups, interleaved instances, a world group: the twins against
    the f32 oracle (most bounce rays there escape to the sky)."""
    port, ref = groups_case.port(kind), groups_case.ref(kind, "jnp")
    check_closest(port, ref, min_hit=0.02)
    np.testing.assert_array_equal(port[3], ref[3])


def test_presorted_dispatch_matches_unsorted(case):
    o, d, tm = case.rays["bounce"]
    tm = tm.copy()
    tm[::5] = 0.0
    ray = Ray(planar(o), planar(d), torch.from_numpy(tm))
    outs_s = scene_mod._preliminary_dispatch(case.st, ray, sort=True)
    outs_u = scene_mod._preliminary_dispatch(case.st, ray, sort=False)
    for a, b in zip(outs_s, outs_u):
        assert torch.equal(a, b)
    assert not torch.isfinite(outs_s[0][::5]).any()
    assert (outs_s[4][::5] == -1).all()
    assert torch.equal(scene_mod.ray_test(case.st, ray),
                       traverse.ray_test_instanced(case.st, ray.o, ray.d,
                                                   ray.maxt))


def test_world_lift_matches_jax(case):
    """The shading record on the oracle's own hits, in both packages: the
    local-space prim lifted by its instance's transform."""
    import jax.numpy as jnp
    from mitsuba2_tpu.core.geometry import Ray as JRay
    from mitsuba2_tpu.core.vec import Vec2 as JVec2, Vec3 as JVec3
    from mitsuba2_tpu.render.interaction import PreliminaryIntersection
    from mitsuba2_tpu.scene import scene as jscene
    for kind in ("camera", "bounce"):
        o, d, tm = case.rays[kind]
        t, prim, inst, _ = case.ref(kind, "jnp")
        z = np.zeros_like(t)
        jo = JVec3(*(jnp.asarray(o[:, i]) for i in range(3)))
        jd = JVec3(*(jnp.asarray(d[:, i]) for i in range(3)))
        si_j = jscene.compute_surface_interaction(
            case.sj, JRay(o=jo, d=jd, maxt=jnp.asarray(tm),
                          time=jnp.zeros(tm.shape[0])),
            PreliminaryIntersection(
                t=jnp.asarray(t), prim_index=jnp.asarray(prim),
                prim_uv=JVec2(jnp.asarray(z), jnp.asarray(z)),
                inst=jnp.asarray(inst)))
        si_t = scene_mod.compute_surface_interaction(
            case.st, Ray(planar(o), planar(d), torch.from_numpy(tm)),
            torch.from_numpy(t), torch.from_numpy(prim), torch.from_numpy(z),
            torch.from_numpy(z), torch.from_numpy(inst))
        valid = si_t.valid.numpy()
        np.testing.assert_array_equal(valid, np.asarray(si_j.valid))
        assert valid.mean() > 0.1

        def close(a, b, rtol=1e-5, atol=1e-5):
            np.testing.assert_allclose(b.numpy()[valid],
                                       np.asarray(a)[valid], rtol=rtol,
                                       atol=atol)
        close(si_j.t, si_t.t)
        for c in "xyz":
            close(getattr(si_j.p, c), getattr(si_t.p, c))
            close(getattr(si_j.n, c), getattr(si_t.n, c))
            close(getattr(si_j.sh_frame.n, c), getattr(si_t.sh_frame.n, c))
            close(getattr(si_j.wi, c), getattr(si_t.wi, c))
        close(si_j.uv.x, si_t.uv.x)
        np.testing.assert_array_equal(si_t.shape.numpy(),
                                      np.asarray(si_j.shape))


def test_constant_emitter_matches_jax(case):
    """eval_env, sample_direction and pdf_direction_env of the constant
    sky on the same numbers in both packages."""
    import jax.numpy as jnp
    import mitsuba2_tpu as mi
    from mitsuba2_tpu.core.vec import Vec3 as JVec3
    from mitsuba2_tpu.render import emitters as jemitters
    from mitsuba2_tpu_torch.render import emitters
    u = np.random.default_rng(5).uniform(0, 1, (6, 4096)).astype(np.float32)
    d = u[:3] - 0.5
    d /= np.linalg.norm(d, axis=0)
    jd = JVec3(*(jnp.asarray(a) for a in d))
    td = Vec3(*(torch.from_numpy(np.ascontiguousarray(a)) for a in d))
    for mode, n_ch in (("rgb", 3), ("mono", 1)):
        cfg_j, cfg_t = mi.RenderConfig(color_mode=mode), \
            mt.RenderConfig(color_mode=mode)
        env_j = jemitters.eval_env(case.sj, jd, None, cfg_j)
        env_t = emitters.eval_env(case.st, td, None, cfg_t)
        assert len(env_t.ch) == n_ch
        for a, b in zip(env_j.ch, env_t.ch):
            np.testing.assert_allclose(b.numpy(), np.broadcast_to(
                np.asarray(a), (4096,)), rtol=1e-6)
    np.testing.assert_allclose(
        emitters.pdf_direction_env(case.st, td).numpy(),
        np.asarray(jemitters.pdf_direction_env(case.sj, cfg_j, jd)),
        rtol=1e-7)
    ref_p = u[:3] * 4.0 - 2.0
    ds_j, e_j = jemitters.sample_direction(
        case.sj, JVec3(*(jnp.asarray(a) for a in ref_p)), None,
        jnp.asarray(u[3]), (jnp.asarray(u[4]), jnp.asarray(u[5])),
        mi.RenderConfig())
    ds_t, e_t = emitters.sample_direction(
        case.st, Vec3(*(torch.from_numpy(np.ascontiguousarray(a))
                        for a in ref_p)), None,
        torch.from_numpy(u[3]), (torch.from_numpy(u[4]),
                                 torch.from_numpy(u[5])), mt.RenderConfig())
    for c in "xyz":
        np.testing.assert_allclose(getattr(ds_t.d, c).numpy(),
                                   np.asarray(getattr(ds_j.d, c)),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ds_t.pdf.numpy(), np.asarray(ds_j.pdf),
                               rtol=1e-7)
    np.testing.assert_allclose(ds_t.dist.numpy(), np.asarray(ds_j.dist))
    assert not ds_t.delta.any()
    for a, b in zip(e_j.ch, e_t.ch):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)


def test_golden_is_fresh(case):
    """The golden's f32-walker answer on camera rays recomputed now."""
    import jax.numpy as jnp
    from mitsuba2_tpu.core.vec import Vec3 as JVec3
    from mitsuba2_tpu.kernels import traverse_jnp
    o, d, tm = case.rays["camera"]
    t, prim = traverse_jnp._ray_intersect_instanced(
        case.sj, *(JVec3(*(jnp.asarray(a[:, i]) for i in range(3)))
                   for a in (o, d)), jnp.asarray(tm))[:2]
    stored = case.ref("camera", "jnp")
    np.testing.assert_array_equal(stored[0], np.asarray(t))
    np.testing.assert_array_equal(stored[1], np.asarray(prim))


@pytest.mark.parametrize("seed", [0, 1])
def test_render_matches_jax(case, seed):
    """A 32x32 render of the shared-BLAS field: the JAX package traverses
    it with its f32 instanced BVH2 walker, the port with the instanced
    cluster-walk twins; same seed, so the same PCG32 streams. Tolerances
    as tests/test_torch_render.py's gallery render."""
    import mitsuba2_tpu as mi
    kw = dict(width=32, height=32, spp=1, spp_per_pass=1, max_depth=3,
              rr_depth=8)
    img_j = REFS.get(f"field_render_{seed}", lambda: np.asarray(
        mi.render(case.sj, mi.RenderConfig(**kw), seed=seed)))
    img_t = mt.render(case.st, mt.RenderConfig(**kw), seed=seed,
                      device="cpu").numpy()
    assert img_t.shape == img_j.shape == (32, 32, 3)
    assert np.isfinite(img_t).all() and img_t.mean() > 0
    close = np.isclose(img_t, img_j, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99
    np.testing.assert_allclose(img_t.mean(), img_j.mean(), rtol=1e-3)


def mirrored_scene(pkg):
    """One displaced icosphere without vertex normals (_icosphere(2),
    _displace(seed=3)) in a group, instanced mirrored at
    translate(1.5, 0.6, 0) @ scale(-1, 1, 1), over a ground quad under a
    quad area light."""
    P, sh, T4 = pkg.presets, pkg.shapes, pkg.T4
    v, f = P._icosphere(2)
    blob = sh.mesh(P._displace(v.copy(), seed=3), f,
                   bsdf={"type": "diffuse", "reflectance": [0.6, 0.5, 0.4]})
    inst = sh.instance(sh.shapegroup([blob]), np.asarray(
        (T4.translate([1.5, 0.6, 0.0]) @ T4.scale([-1.0, 1.0, 1.0])).matrix))
    ground = P._quad([-4, 0, -4], [-4, 0, 4], [4, 0, 4], [4, 0, -4],
                     bsdf={"type": "diffuse", "reflectance": [0.7] * 3})
    light = P._quad([0, 4, -1], [3, 4, -1], [3, 4, 2], [0, 4, 2],
                    emitter={"type": "area", "radiance": [8.0] * 3})
    sensor = {"type": "perspective", "fov": 45.0,
              "to_world": np.asarray(T4.look_at(
                  origin=[1.5, 2.0, -4.5], target=[1.5, 0.5, 0.0],
                  up=[0, 1, 0]).matrix)}
    return pkg.build([ground, light, inst], sensor, [])


@pytest.fixture(scope="module")
def mirrored_renders():
    """The mirrored instance rendered by both packages in both
    MI_FLATTEN_INSTANCES modes, 16x16 at 4 spp: {mode: (jax, port)}."""
    import mitsuba2_tpu as mi
    kw = dict(width=16, height=16, spp=4, spp_per_pass=4, max_depth=3,
              rr_depth=8)
    out = {}
    def jax_render(mode):
        with flatten_mode(mode):
            sj = mirrored_scene(package("jax"))
        assert sj.has_instances == (mode == "0")
        return np.asarray(mi.render(sj, mi.RenderConfig(**kw), seed=2))
    for mode in ("0", "1"):
        with flatten_mode(mode):
            st = mirrored_scene(package("port"))
        assert st.has_instances == (mode == "0")
        out[mode] = (REFS.get(f"mirrored_{mode}", lambda: jax_render(mode)),
                     mt.render(st, mt.RenderConfig(**kw), seed=2,
                               device="cpu").numpy())
    return out


@pytest.mark.parametrize("mode", ["0", "1"])
def test_mirrored_instance_matches_jax(mirrored_renders, mode):
    """The reference's behaviour on a mirrored instance of a mesh without
    vertex normals, pinned in both modes (ROADMAP.md Queue 3): shared
    ("0"), the local face normal lifted by the inverse transpose points
    outward; flattened ("1"), the normal of the mirrored vertices points
    inward, so the one-sided diffuse blob shades darker. The port follows
    the JAX package in each mode (tolerances as test_render_matches_jax),
    and the two modes differ, in both packages alike."""
    img_j, img_t = mirrored_renders[mode]
    assert img_t.shape == img_j.shape == (16, 16, 3)
    assert np.isfinite(img_t).all() and img_t.mean() > 0
    close = np.isclose(img_t, img_j, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99
    np.testing.assert_allclose(img_t.mean(), img_j.mean(), rtol=1e-3)
    (j0, t0), (j1, t1) = mirrored_renders["0"], mirrored_renders["1"]
    assert j1.mean() < 0.98 * j0.mean() and t1.mean() < 0.98 * t0.mean()


def test_instanced_wrappers_check_and_count(case):
    st = case.st
    o, d, tm = (torch.zeros(8), torch.ones(8), torch.full((8,), np.inf))
    tabs = (st.mxu_node_f, st.mxu_link, st.cluster_feat, st.inst_inv)
    args = (*tabs, o, o, o, d, d, d)
    fuel = st.inst_mxu_fuel + 64
    before = (traverse.inst_cluster_closest_hit.launches,
              traverse.inst_cluster_any_hit.launches)
    t, slot, inst = traverse.inst_cluster_closest_hit(*args, tm,
                                                      st.cluster_k, fuel)
    assert t.shape == (8,) and slot.dtype == inst.dtype == torch.int32
    traverse.inst_cluster_any_hit(*args, tm, st.cluster_k, fuel)
    # CPU tensors go to the twins: no kernel launch is counted
    assert (traverse.inst_cluster_closest_hit.launches,
            traverse.inst_cluster_any_hit.launches) == before
    with pytest.raises(ValueError, match="float32"):
        traverse.inst_cluster_closest_hit(*args, tm.double(), st.cluster_k,
                                          fuel)
    with pytest.raises(ValueError, match="inst_inv"):
        traverse.inst_cluster_any_hit(*tabs[:3], st.inst_inv[:, :12], *args[4:],
                                      tm, st.cluster_k, fuel)


def test_twin_counts_walk_work(case):
    o, d, tm = case.rays["camera"]
    st, stats = case.st, {}
    traverse.inst_closest_hit_plain(
        st.mxu_node_f, st.mxu_link, st.cluster_feat, st.inst_inv,
        *planar(o).__dict__.values(), *planar(d).__dict__.values(),
        torch.from_numpy(tm), st.cluster_k, st.inst_mxu_fuel + 64,
        chunk=500, stats=stats)
    assert stats["node_steps"] >= N_RAYS
    assert 0 < stats["instance_entries"] < stats["node_steps"]
    assert 0 < stats["cluster_visits"] < stats["node_steps"]


# ---------------------------------------------------------------------------
# The CUDA source: emulated on the CPU, and on the card where there is one
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return build_emulation(tmp_path_factory.mktemp("inst_walk_emu"))


def emulate(lib, st, rays, any_hit):
    n = rays[0].shape[0]
    tabs = (st.mxu_node_f, st.mxu_link, st.cluster_feat, st.inst_inv)
    ptrs = [a.data_ptr() for a in tabs + rays]
    dims = (n, st.inst_mxu_fuel + 64, st.cluster_k, None)
    if any_hit:
        occ = torch.empty(n, dtype=torch.bool)
        assert lib.mts_inst_cluster_any_hit(*ptrs, occ.data_ptr(), *dims) == 0
        return occ
    out = (torch.empty(n), torch.empty(n, dtype=torch.int32),
           torch.empty(n, dtype=torch.int32))
    assert lib.mts_inst_cluster_closest_hit(
        *ptrs, *(a.data_ptr() for a in out), *dims) == 0
    return out


def kind_rays(case, kind):
    o, d, tm = case.rays[kind]
    return (*planar(o).__dict__.values(), *planar(d).__dict__.values(),
            torch.from_numpy(tm))


@pytest.mark.parametrize("kind", KINDS)
def test_cuda_source_emulated_matches_twins(case, emulated, kind):
    st, rays = case.st, kind_rays(case, kind)
    tabs = (st.mxu_node_f, st.mxu_link, st.cluster_feat, st.inst_inv)
    fuel = st.inst_mxu_fuel + 64
    t, slot, inst = emulate(emulated, st, rays, False)
    occ = emulate(emulated, st, rays, True)
    t_p, slot_p, inst_p = traverse.inst_closest_hit_plain(
        *tabs, *rays, st.cluster_k, fuel)
    occ_p = traverse.inst_any_hit_plain(*tabs, *rays, st.cluster_k, fuel)
    # the same f32 operations in the same order: bit-equal
    assert torch.equal(slot, slot_p) and torch.equal(inst, inst_p)
    assert torch.equal(t, t_p) and torch.equal(occ, occ_p)


@pytest.mark.parametrize("kind", KINDS)
def test_twin_counts_kernel_work(case, emulated, kind):
    """The walk work the twins count (the bound in chip_smoke.py rests on
    it) equals the work the CUDA source does in the emulation: two float4
    of a node row a step and a third (the centroid) a cluster visit, four
    (an inst_inv row) an entry; five float4 a slot test on the any-hit
    walk, and on the closest-hit walk five a slot once for each group of a
    warp's lanes due at one cluster, whatever instances they are in, and
    every slot tested for each ray of the group (assert_kernel_work)."""
    st, rays = case.st, kind_rays(case, kind)
    tabs = (st.mxu_node_f, st.mxu_link, st.cluster_feat, st.inst_inv)
    for any_hit in (False, True):
        loads = load_counters(emulated, (st.mxu_node_f, st.cluster_feat,
                                         st.inst_inv))
        out = emulate(emulated, st, rays, any_hit)
        stats = {}
        twin = (traverse.inst_any_hit_plain if any_hit
                else traverse.inst_closest_hit_plain)
        twin(*tabs, *rays, st.cluster_k, st.inst_mxu_fuel + 64, chunk=500,
             stats=stats)
        assert_kernel_work(stats, loads, work_counter(emulated).value,
                           bool(out.any()) if any_hit else None,
                           st.cluster_k, traverse.INST_ANY_TILE)
        assert loads[2] == 4 * stats.get("instance_entries", 0)
        assert stats.get("instance_entries", 0) > 0


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_emulated_warps_match_twins(case, emulated, any_hit):
    """The warp-cooperative instanced kernels, emulated warp by warp:
    warp 0 holds 16 copies of a camera ray's last stretch to its hit on
    instance a and 16 of the same stretch moved, in a's local frame, onto
    instance b of the same group (both walk the shared BLAS alike, so the
    warp serves lanes of both instances as one group at each cluster:
    fewer groups than each instance's lanes would need alone); warp 1
    bounce rays (closest hit) or shadow rays (any hit) with every third
    lane dead (t_max 0 or -1); for the any hit, a warp of the pair again
    with every other lane's t_max short of its hit (occluded and
    unoccluded lanes of both instances in one group); and a last warp of
    7 lanes. t, slot and instance, or occ, bit-equal to the twin on every
    lane, dead lanes missing, and the work counted exactly."""
    st = case.st
    tabs = (st.mxu_node_f, st.mxu_link, st.cluster_feat, st.inst_inv)
    fuel = st.inst_mxu_fuel + 64

    def closest(*rays, **kw):
        return traverse.inst_closest_hit_plain(*tabs, *rays, st.cluster_k,
                                               fuel, **kw)

    def twin(*rays, **kw):
        return (traverse.inst_any_hit_plain if any_hit else
                traverse.inst_closest_hit_plain)(*tabs, *rays, st.cluster_k,
                                                 fuel, **kw)
    o, d, tm = case.rays["camera"]
    t, _, inst = (a.numpy() for a in closest(*kind_rays(case, "camera")))
    inv = st.inst_inv.double().numpy()
    root = inv[:, 13]
    a = int(np.flatnonzero(inst > 0)[0])
    ia = int(inst[a])
    ib = int(next(k for k in range(1, len(root))
                  if k != ia and root[k] == root[ia]))
    # the stretch from 0.1 t before the hit to 0.1 t past it, in a's frame
    o_a = o[a] + 0.9 * t[a] * d[a]
    m_a, m_b = inv[ia, :12].reshape(3, 4), inv[ib, :12].reshape(3, 4)
    o_l = m_a[:, :3] @ o_a + m_a[:, 3]
    d_l = m_a[:, :3] @ d[a]
    o_b = np.linalg.solve(m_b[:, :3], o_l - m_b[:, 3])
    d_b = np.linalg.solve(m_b[:, :3], d_l)
    pair = (np.array([o_a, o_b], np.float32).repeat(16, 0),
            np.array([d[a], d_b], np.float32).repeat(16, 0),
            np.full(32, 0.2 * t[a], np.float32))
    kind = "shadow" if any_hit else "bounce"
    bo, bd, btm = (x[:32].copy() for x in case.rays[kind])
    btm[0::3] = np.where(np.arange(32)[0::3] % 2 == 0, 0.0, -1.0)
    parts = [pair, (bo, bd, btm)]
    if any_hit:
        # the hit lies 0.1 t along the stretch: 0.05 t falls short of it
        parts.append(pair[:2] + (np.tile(np.array(
            [0.2 * t[a], 0.05 * t[a]], np.float32), 16),))
    parts.append(tuple(x[:7] for x in case.rays[kind]))
    ro, rd, rtm = (np.concatenate(x) for x in zip(*parts))
    rays = tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in
                 (*ro.T, *rd.T, rtm))
    n = rtm.shape[0]
    assert n % 32 == 7 and (rtm <= 0).sum() == 11

    loads = load_counters(emulated, (st.mxu_node_f, st.cluster_feat,
                                     st.inst_inv))
    out = emulate(emulated, st, rays, any_hit)
    stats = {}
    want = twin(*rays, stats=stats)
    dead = torch.from_numpy(rtm <= 0)
    if any_hit:
        assert torch.equal(out, want)
        assert not out[dead].any() and out[:32].all()
        assert (out[64:96] == torch.arange(32).remainder(2).eq(0)).all()
        live = ~dead[32:64]
        assert out[32:64][live].any() and not out[32:64][live].all()
    else:
        assert all(torch.equal(x, y) for x, y in zip(out, want))
        assert torch.isinf(out[0][dead]).all() and (out[1][dead] == -1).all()
        assert (out[2][:32].reshape(2, 16)
                == torch.tensor([[ia], [ib]])).all()
    assert_kernel_work(stats, loads, work_counter(emulated).value,
                       bool(out.any()) if any_hit else None, st.cluster_k,
                       traverse.INST_ANY_TILE)
    assert loads[2] == 4 * stats["instance_entries"]
    # the pair warp: lanes of instances a and b share each cluster's group
    sw = [{}, {}, {}]
    for s_, lanes in zip(sw, (slice(0, 32), slice(0, 16), slice(16, 32))):
        twin(*(x[lanes] for x in rays), stats=s_)
    assert sw[0]["cluster_groups"] == sw[1]["cluster_groups"] > 0
    assert sw[0]["cluster_groups"] < (sw[1]["cluster_groups"]
                                      + sw[2]["cluster_groups"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("kind", KINDS)
def test_cuda_instanced_kernels_match_twins(case, cuda, kind):
    st = mt.to_device(case.st, cuda)
    tabs = (st.mxu_node_f, st.mxu_link, st.cluster_feat, st.inst_inv)
    rays = tuple(a.to(cuda) for a in kind_rays(case, kind))
    fuel = st.inst_mxu_fuel + 64
    before = traverse.inst_cluster_closest_hit.launches
    t, slot, inst = traverse.inst_cluster_closest_hit(*tabs, *rays,
                                                      st.cluster_k, fuel)
    occ = traverse.inst_cluster_any_hit(*tabs, *rays, st.cluster_k, fuel)
    torch.cuda.synchronize()
    assert traverse.inst_cluster_closest_hit.launches == before + 1
    t_p, slot_p, inst_p = traverse.inst_closest_hit_plain(
        *tabs, *rays, st.cluster_k, fuel)
    occ_p = traverse.inst_any_hit_plain(*tabs, *rays, st.cluster_k, fuel)
    hit = torch.isfinite(t_p)
    assert torch.equal(torch.isfinite(t), hit)
    same = (slot == slot_p) & (inst == inst_p)
    assert same[hit].float().mean() >= 0.999
    torch.testing.assert_close(t[hit], t_p[hit], rtol=1e-5, atol=1e-5)
    # the any hit's warp-cooperative visits keep the twin's result
    assert torch.equal(occ, occ_p)
