"""The dense cluster sweep (K8, MI_MXU_DENSE) and the MI_MXU_LEAVES switch
of the PyTorch port against the JAX package, on mesh_gallery(subdiv=1)
with the four kinds of rays a forward render traces; the K8 source
through the g++ emulation of tests/test_torch_traverse.py, and on the
card in the card-only cases at the end (skipped without a card).

Tolerances:
- the dense twin against the K1 twin, as the JAX package holds its dense
  sweep against its walk (tests/test_traverse_pallas.py): hit masks and
  occlusion equal, prims equal on more than 99.5% of hit lanes, t within
  rtol 1e-5 / atol 1e-6 (bit-equal where the same slot wins: the same
  visit in the same f32 operations);
- against the JAX package's interpret-mode dense sweep, whose plane dots
  run in split bf16: the same masks and prims, t at rtol 1e-3 / atol
  1e-5 unless the port is the closer of the two to the f32 oracle, as
  tests/test_torch_traverse.py holds the cluster walk; against the f32
  oracle (traverse_jnp), t at rtol 1e-5 / atol 1e-5;
- MI_MXU_LEAVES off: the BVH2 walks are f32 in both packages: t at rtol
  1e-5 / atol 1e-5, u/v at atol 1e-4, prims equal on 99% of hit lanes.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.core.geometry import Ray
from mitsuba2_tpu_torch.kernels import traverse
from mitsuba2_tpu_torch.probe_rays import KINDS, probe_rays
from mitsuba2_tpu_torch.scene import scene as scene_mod
from test_torch_instancing import (assert_port_tables, flatten_mode,
                                   jax_fields, recorded_fields)
from test_torch_traverse import (_SHIM, build_emulation, emulate_source,
                                 load_counters, planar)

N_RAYS = 2048
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rays_of(rays, kind, device="cpu"):
    o, d, tm = rays[kind]
    return (*planar(o, device).__dict__.values(),
            *planar(d, device).__dict__.values(),
            torch.from_numpy(tm).to(device))


def jplanar(a):
    import jax.numpy as jnp
    from mitsuba2_tpu.core.vec import Vec3 as JVec3
    return JVec3(*(jnp.asarray(a[:, i]) for i in range(3)))


class Case:
    """mesh_gallery(subdiv=1) in the port, its probe rays and each answer,
    computed once for the module. JAX is imported only for the reference
    answers, so that the card-only cases also run where it is not
    installed (`--noconftest -k cuda`)."""

    def __init__(self):
        self.st = mt.mesh_gallery(subdiv=1, device="cpu")
        self.rays = probe_rays(self.st, N_RAYS, 0, self._closest_np)
        self._memo = {}

    def _closest_np(self, o, d, t_max):
        t, prim, _, _ = traverse.ray_intersect_preliminary(
            self.st, planar(o), planar(d), torch.from_numpy(t_max))
        return t.numpy(), prim.numpy(), None

    def memo(self, key, fn):
        if key not in self._memo:
            self._memo[key] = fn()
        return self._memo[key]

    def sj(self):
        from mitsuba2_tpu.scene import presets as jpresets
        return self.memo("jax_scene", lambda: jpresets.mesh_gallery(subdiv=1))

    def port(self, kind, dense):
        """The entry points' (t, prim, occlusion) with the dense switch
        on or off."""
        def run():
            o, d, tm = self.rays[kind]
            args = (self.st, planar(o), planar(d), torch.from_numpy(tm))
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(traverse, "_MXU_DENSE", "1" if dense else "0")
                t, prim, u, v = traverse.ray_intersect_preliminary(*args)
                occ = traverse.ray_test(*args)
            assert not u.any() and not v.any()
            return t.numpy(), prim.numpy(), occ.numpy()
        return self.memo(("port", kind, dense), run)

    def ref(self, kind, which):
        """The JAX package's answer: its interpret-mode dense sweep
        ("pallas") or its f32 oracle ("jnp")."""
        import jax.numpy as jnp
        from mitsuba2_tpu.kernels import traverse_jnp, traverse_pallas

        def run():
            o, d, tm = self.rays[kind]
            args = (self.sj(), jplanar(o), jplanar(d), jnp.asarray(tm))
            if which == "jnp":
                t, prim, _, _ = traverse_jnp.ray_intersect_preliminary(*args)
                occ = traverse_jnp.ray_test(*args)
            else:
                with pytest.MonkeyPatch.context() as mp:
                    mp.setattr(traverse_pallas, "MXU_LEAVES", True)
                    mp.setattr(traverse_pallas, "_MXU_DENSE", "1")
                    t, prim, _, _ = traverse_pallas.ray_intersect_preliminary(
                        *args, interpret=True)
                    occ = traverse_pallas.ray_test(*args, interpret=True)
            return np.asarray(t), np.asarray(prim), np.asarray(occ)
        return self.memo((which, kind), run)


@pytest.fixture(scope="module")
def case():
    return Case()


# ---------------------------------------------------------------------------
# The table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gallery1", "gallery2", "cornell"])
def test_mxu_ccs_byte_equal(name):
    """mxu_ccs (C, 8) f32, the cluster centroids in cols 0:3, byte-equal
    to the JAX build; on the device with the cluster tables only."""
    from mitsuba2_tpu.scene import presets as jpresets
    make = {"gallery1": ("mesh_gallery", dict(subdiv=1)),
            "gallery2": ("mesh_gallery", dict(subdiv=2)),
            "cornell": ("cornell_box", {})}[name]
    sj = getattr(jpresets, make[0])(**make[1])
    with recorded_fields() as got:
        st = getattr(mt, make[0])(device="cpu", **make[1])
    want = np.asarray(sj.mxu_ccs)
    assert want.dtype == np.float32 and want.shape[1] == 8
    assert got[0]["mxu_ccs"].dtype == want.dtype
    assert np.array_equal(got[0]["mxu_ccs"], want)
    assert not want[:, 3:].any()
    assert_port_tables(jax_fields(sj), got[0], st)
    # one row per cluster: the centroid each cluster's cut node holds
    node = got[0]["mxu_node_f"]
    is_cl = node[:, 6] >= 0
    order = (node[is_cl, 6] // st.cluster_k).astype(int)
    assert np.array_equal(want[order, 0:3], node[is_cl, 8:11])


@pytest.mark.parametrize("name", ["gallery1", "gallery2", "field_shared"])
def test_mxu_ccount(name):
    """mxu_ccount (C,) i32: 1 + each cluster's last slot holding a prim
    (0 for none), uploaded with the cluster tables; every plane row past
    it is zero, so the dense sweep may skip those slots. The scenes
    include one whose last cluster is part-filled."""
    make = {"gallery1": lambda: mt.mesh_gallery(subdiv=1, device="cpu"),
            "gallery2": lambda: mt.mesh_gallery(subdiv=2, device="cpu"),
            "field_shared": lambda: mt.instanced_field(n=6, subdiv=2,
                                                       device="cpu")}[name]
    with flatten_mode("0" if name == "field_shared" else None):
        st = make()
    count = st.mxu_ccount
    assert count is not None and count.dtype == torch.int32
    assert count.is_contiguous() and count.shape == st.mxu_ccs.shape[:1]
    ck = st.cluster_k
    prim = st.cluster_slot_prim.numpy().reshape(-1, ck)
    want = [1 + max(np.nonzero(row >= 0)[0], default=-1) for row in prim]
    assert count.tolist() == want
    rows = st.cluster_feat.reshape(-1, ck, traverse.FEAT_W)
    past = torch.arange(ck)[None, :] >= count[:, None]
    assert past.any() and not rows[past].any()
    if name.startswith("gallery"):
        assert 0 < want[-1] < ck         # the last cluster is part-filled


# ---------------------------------------------------------------------------
# The dense twin (K8)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["walk", "pallas", "jnp"])
@pytest.mark.parametrize("kind", KINDS)
def test_dense_matches(case, kind, which):
    """The dense sweep through the entry points against the K1 twin's
    walk ("walk"), the JAX package's interpret-mode dense sweep
    ("pallas") and its f32 oracle ("jnp")."""
    t, prim, occ = case.port(kind, True)
    t_r, prim_r, occ_r = (case.port(kind, False) if which == "walk"
                          else case.ref(kind, which))
    hit = np.isfinite(t)
    np.testing.assert_array_equal(hit, np.isfinite(t_r))
    assert hit.mean() > 0.1
    np.testing.assert_array_equal(prim[~hit], -1)
    same = prim == prim_r
    assert same[hit].mean() > 0.995
    np.testing.assert_array_equal(occ, occ_r)
    np.testing.assert_array_equal(occ, hit)
    if which == "walk":
        np.testing.assert_array_equal(t[same], t_r[same])
        np.testing.assert_allclose(t[hit], t_r[hit], rtol=1e-5, atol=1e-6)
    elif which == "jnp":
        np.testing.assert_allclose(t[hit], t_r[hit], rtol=1e-5, atol=1e-5)
    else:
        t, t_r, t_o = t[hit], t_r[hit], case.ref(kind, "jnp")[0][hit]
        band = np.isclose(t, t_r, rtol=1e-3, atol=1e-5)
        closer = np.abs(t - t_o) <= np.abs(t_r - t_o)
        assert (band | closer).all()


@pytest.mark.parametrize("max_c", [768, 4])
@pytest.mark.parametrize("mode", ["0", "1", "auto"])
def test_use_dense_agrees_with_jax(case, monkeypatch, mode, max_c):
    """_use_dense under each MI_MXU_DENSE value, with the default cap
    and one under the gallery's 8 clusters; never without mxu_ccs."""
    from mitsuba2_tpu.kernels import traverse_pallas
    for mod in (traverse, traverse_pallas):
        monkeypatch.setattr(mod, "_MXU_DENSE", mode)
        monkeypatch.setattr(mod, "MXU_DENSE_MAX", max_c)
    want = traverse_pallas._use_dense(case.sj())
    assert traverse._use_dense(case.st) == want
    assert want == (mode == "1" or (mode == "auto" and max_c >= 8))
    scene_mod.set_backend("bvh8mxu")
    try:
        k7 = mt.mesh_gallery(subdiv=1, device="cpu")
    finally:
        scene_mod.set_backend("auto")
    assert k7.mxu_ccs is None and not traverse._use_dense(k7)


def test_dense_switch_refuses_other_values():
    env = dict(os.environ, PYTHONPATH=REPO, MI_MXU_DENSE="2")
    proc = subprocess.run(
        [sys.executable, "-c", "import mitsuba2_tpu_torch.kernels.traverse"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "MI_MXU_DENSE" in proc.stderr


def test_dense_routing(case, monkeypatch):
    """Under "1" a flat triangle scene's entry points and its sorted
    dispatch reach K8's wrappers and no walk's; an instanced scene, a
    scene under set_backend("bvh8"), and MXU_LEAVES off, never."""
    monkeypatch.setattr(traverse, "_MXU_DENSE", "1")
    calls = []
    for name in ("dense_closest_hit", "dense_any_hit", "cluster_closest_hit",
                 "cluster_any_hit"):
        fn = getattr(traverse, name)
        monkeypatch.setattr(traverse, name,
                            lambda *a, _n=name, _f=fn: calls.append(_n)
                            or _f(*a))
    o, d, tm = case.rays["bounce"]
    ray = Ray(planar(o), planar(d), torch.from_numpy(tm))
    t_s, p_s, u_s, v_s, _ = scene_mod._preliminary_dispatch(case.st, ray,
                                                            sort=True)
    occ = scene_mod.ray_test(case.st, ray)
    assert calls == ["dense_closest_hit", "dense_any_hit"]
    t, prim, occ_r = case.port("bounce", True)
    assert np.array_equal(t_s.numpy(), t) and np.array_equal(p_s.numpy(),
                                                             prim)
    assert not u_s.any() and not v_s.any()
    assert np.array_equal(occ.numpy(), occ_r)
    calls.clear()
    with flatten_mode("0"):
        field = mt.instanced_field(n=6, subdiv=2, device="cpu")
    assert field.has_instances and field.mxu_ccs is not None
    scene_mod._preliminary_dispatch(field, ray, sort=False)
    scene_mod.set_backend("bvh8")
    try:
        k6 = mt.mesh_gallery(subdiv=1, device="cpu")
        scene_mod._preliminary_dispatch(k6, ray, sort=False)
    finally:
        scene_mod.set_backend("auto")
    monkeypatch.setattr(traverse, "MXU_LEAVES", False)
    k3 = mt.mesh_gallery(subdiv=1, device="cpu")
    scene_mod._preliminary_dispatch(k3, ray, sort=False)
    assert calls == []


def test_dense_twin_counts_and_checks(case):
    st = case.st
    rays = rays_of(case.rays, "shadow")
    tabs = (st.mxu_ccs, st.mxu_ccount, st.cluster_feat)
    stats_c, stats_a = {}, {}
    traverse.dense_closest_hit_plain(*tabs, *rays, st.cluster_k, chunk=700,
                                     stats=stats_c)
    occ = traverse.dense_any_hit_plain(*tabs, *rays, st.cluster_k,
                                       chunk=700, stats=stats_a)
    alive = (rays[6] > 0).numpy()
    live = int(alive.sum())
    n_cl = st.mxu_ccs.shape[0]
    real = int((st.cluster_slot_prim >= 0).sum())
    tested = int(st.mxu_ccount.sum())
    # the kernel's threads with a live ray: DENSE_RAYS rays a thread,
    # lanes b*BLOCK*R + j*BLOCK + t
    span = traverse.BLOCK * traverse.DENSE_RAYS
    lane = np.arange(alive.size)
    threads = np.unique((lane // span * traverse.BLOCK
                         + lane % traverse.BLOCK)[alive]).size
    assert live <= threads * traverse.DENSE_RAYS
    # closest hit: every live lane visits every cluster and tests its
    # slots up to its last real one; a thread with a live ray loads the
    # centroid of every cluster and those slots' rows once
    assert stats_c == {"cluster_visits": live * n_cl,
                       "thread_visits": threads * n_cl,
                       "slot_tests": live * tested,
                       "loaded_slots": threads * tested,
                       "real_slot_tests": live * real}
    # any hit: a lane leaves at its first hit, a thread once all its
    # lanes are done
    assert stats_a["cluster_visits"] < live * n_cl and bool(occ.any())
    # no padding slot is tested: the gallery's clusters hold their prims
    # in their first slots
    assert tested == real
    assert stats_a["real_slot_tests"] == stats_a["slot_tests"]
    assert (stats_a["slot_tests"] / traverse.DENSE_RAYS
            <= stats_a["loaded_slots"] < stats_a["slot_tests"])
    assert stats_a["thread_visits"] <= threads * n_cl
    before = (traverse.dense_closest_hit.launches,
              traverse.dense_any_hit.launches)
    traverse.dense_closest_hit(*tabs, *rays, st.cluster_k)
    traverse.dense_any_hit(*tabs, *rays, st.cluster_k)
    # CPU tensors go to the twins: no kernel launch is counted
    assert before == (traverse.dense_closest_hit.launches,
                      traverse.dense_any_hit.launches)
    with pytest.raises(ValueError, match="mxu_ccs"):
        traverse.dense_closest_hit(st.mxu_ccs[:, :4].contiguous(),
                                   *tabs[1:], *rays, st.cluster_k)
    with pytest.raises(ValueError, match="cluster_feat"):
        traverse.dense_any_hit(st.mxu_ccs[:-1], st.mxu_ccount[:-1],
                               st.cluster_feat, *rays, st.cluster_k)
    with pytest.raises(ValueError, match="float32"):
        traverse.dense_any_hit(*tabs, *rays[:6], rays[6].double(),
                               st.cluster_k)


@pytest.mark.parametrize("what", ["shape", "dtype", "above", "below"])
def test_dense_wrappers_refuse_a_wrong_count(case, what):
    """mxu_ccount must be (C,) int32, each count in [0, CK]."""
    st = case.st
    count = {"shape": st.mxu_ccount[:-1],
             "dtype": st.mxu_ccount.long(),
             "above": st.mxu_ccount.clone().fill_(st.cluster_k + 1),
             "below": st.mxu_ccount - st.mxu_ccount}[what]
    if what == "below":
        count[3] = -1
    rays = rays_of(case.rays, "camera")
    for fn in (traverse.dense_closest_hit, traverse.dense_any_hit):
        with pytest.raises(ValueError, match="mxu_ccount"):
            fn(st.mxu_ccs, count, st.cluster_feat, *rays, st.cluster_k)


def test_render_matches_jax_under_dense(monkeypatch):
    """A 16x16 render of mesh_gallery(subdiv=1) with the dense switch on
    in both packages (JAX: its Pallas backend, the interpret-mode dense
    kernels; the port: the K8 twins), same seed."""
    import jax
    import mitsuba2_tpu as mi
    from mitsuba2_tpu.kernels import traverse_pallas
    from mitsuba2_tpu.scene import presets as jpresets
    from mitsuba2_tpu.scene import scene as jscene
    kw = dict(width=16, height=16, spp=1, spp_per_pass=1, max_depth=3,
              rr_depth=8)
    monkeypatch.setattr(traverse_pallas, "MXU_LEAVES", True)
    monkeypatch.setattr(traverse_pallas, "_MXU_DENSE", "1")
    monkeypatch.setattr(traverse, "_MXU_DENSE", "1")
    sj = jpresets.mesh_gallery(subdiv=1)
    jscene.set_backend("pallas")
    jax.clear_caches()
    try:
        img_j = np.asarray(mi.render(sj, mi.RenderConfig(**kw), seed=3))
    finally:
        jscene.set_backend("auto")
        jax.clear_caches()
    seen = []
    for name in ("dense_closest_hit", "dense_any_hit"):
        fn = getattr(traverse, name)
        monkeypatch.setattr(traverse, name,
                            lambda *a, _f=fn: seen.append(1) or _f(*a))
    img_t = mt.render(mt.mesh_gallery(subdiv=1, device="cpu"),
                      mt.RenderConfig(**kw), seed=3, device="cpu").numpy()
    assert len(seen) == 5              # 3 closest hit, 2 shadow rounds
    assert img_t.shape == img_j.shape == (16, 16, 3)
    assert np.isfinite(img_t).all() and img_t.mean() > 0
    close = np.isclose(img_t, img_j, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99
    np.testing.assert_allclose(img_t.mean(), img_j.mean(), rtol=1e-3)


# ---------------------------------------------------------------------------
# MI_MXU_LEAVES off: the BVH2 walks on triangle scenes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gallery", "field_shared"])
def test_leaves_off_takes_the_bvh2_walks(case, monkeypatch, name):
    """With MXU_LEAVES off in both packages a flat triangle scene takes K3
    and an instanced one K4: the port uploads their tables, its entry
    points give the K3/K4 twins' answers (real u/v) and agree with the
    JAX package's routing under the same switch (interpret-mode K3/K4)."""
    import jax.numpy as jnp
    from mitsuba2_tpu.kernels import traverse_pallas
    from mitsuba2_tpu.scene import presets as jpresets
    monkeypatch.setattr(traverse_pallas, "MXU_LEAVES", False)
    monkeypatch.setattr(traverse, "MXU_LEAVES", False)
    with flatten_mode("0" if name == "field_shared" else None), \
            recorded_fields() as got:
        if name == "gallery":
            sj = jpresets.mesh_gallery(subdiv=1)
            st = mt.mesh_gallery(subdiv=1, device="cpu")
        else:
            sj = jpresets.instanced_field(n=6, subdiv=2)
            st = mt.instanced_field(n=6, subdiv=2, device="cpu")
    assert st.has_instances == (name == "field_shared")
    assert_port_tables(jax_fields(sj), got[0], st)
    assert st.bvh_node is not None and st.mxu_node_f is None
    assert traverse.emits_uv(st, "walk")
    inst = st.has_instances
    closest = (traverse.ray_intersect_instanced if inst
               else traverse.ray_intersect_preliminary)
    test = traverse.ray_test_instanced if inst else traverse.ray_test
    twin_c = (traverse.inst_bvh_closest_hit_plain if inst
              else traverse.bvh_closest_hit_plain)
    twin_a = (traverse.inst_bvh_any_hit_plain if inst
              else traverse.bvh_any_hit_plain)
    jc = (traverse_pallas.ray_intersect_instanced if inst
          else traverse_pallas.ray_intersect_preliminary)
    ja = (traverse_pallas.ray_test_instanced if inst
          else traverse_pallas.ray_test)

    def closest_np(o, d, t_max):
        out = closest(st, planar(o), planar(d), torch.from_numpy(t_max))
        return (out[0].numpy(), out[1].numpy(),
                out[4].numpy() if inst else None)
    rays = probe_rays(st, 512, 1, closest_np)
    # the JAX package's closest hit on bounce rays, its occlusion on
    # shadow rays (interpret-mode K3/K4 walk slowly: one call each)
    for kind in ("bounce", "shadow"):
        o, d, tm = rays[kind]
        args = (st, planar(o), planar(d), torch.from_numpy(tm))
        out = closest(*args)
        occ = test(*args)
        bargs = traverse._bvh_args(*args)
        want = twin_c(*bargs)
        assert all(torch.equal(a, b) for a, b in zip(out, want))
        assert torch.equal(occ, twin_a(*bargs))
        jargs = (sj, jplanar(o), jplanar(d), jnp.asarray(tm))
        if kind == "shadow":
            np.testing.assert_array_equal(
                occ.numpy(), np.asarray(ja(*jargs, interpret=True)))
            continue
        ref = [np.asarray(a) for a in jc(*jargs, interpret=True)]
        t, prim, u, v = (a.numpy() for a in out[:4])
        hit = np.isfinite(t)
        np.testing.assert_array_equal(hit, np.isfinite(ref[0]))
        np.testing.assert_array_equal(occ.numpy(), hit)
        same = prim == ref[1]
        if inst:
            same &= out[4].numpy() == ref[4]
        assert same[hit].mean() > 0.99
        np.testing.assert_allclose(t[hit], ref[0][hit], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(u[same & hit], ref[2][same & hit],
                                   atol=1e-4)
        np.testing.assert_allclose(v[same & hit], ref[3][same & hit],
                                   atol=1e-4)
        assert (u[hit] != 0).any()
    # u/v go through the presort's unsort with the rest
    ray = Ray(planar(o), planar(d), torch.from_numpy(tm))
    sorted_ = scene_mod._preliminary_dispatch(st, ray, sort=True)
    unsorted = scene_mod._preliminary_dispatch(st, ray, sort=False)
    for a, b in zip(sorted_[:4], unsorted[:4]):
        assert torch.equal(a, b)
    # a scene uploaded with the switch on holds no BVH2 tables
    if not inst:
        with pytest.raises(ValueError, match="MXU_LEAVES"):
            scene_mod._preliminary_dispatch(case.st, ray)


# ---------------------------------------------------------------------------
# The CUDA source: emulated on the CPU, and on the card where there is one
# ---------------------------------------------------------------------------

def source_constant(name):
    """The value of `constexpr int NAME = v;` in csrc/cluster_walk.cu."""
    import re
    src = open(traverse._SRC).read()
    return int(re.search(rf"^constexpr int {name} = (\d+);$", src,
                         re.M).group(1))


def test_dense_constants_mirror_the_source():
    """The twins count the kernel's threads with the source's block and
    rays a thread."""
    assert traverse.DENSE_RAYS == source_constant("DENSE_RAYS")
    assert traverse.BLOCK == source_constant("BLOCK")
    src = open(traverse._SRC).read()
    assert traverse.with_constants(src, DENSE_RAYS=1) != src
    with pytest.raises(ValueError, match="NO_SUCH"):
        traverse.with_constants(src, NO_SUCH=1)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return build_emulation(tmp_path_factory.mktemp("dense_emu"))


@pytest.fixture(scope="module")
def emulated_r1(tmp_path_factory):
    """The source built with one ray a thread (DENSE_RAYS = 1, rewritten
    as chip_tiles.py rewrites it), emulated."""
    tmp = tmp_path_factory.mktemp("dense_emu_r1")
    src = tmp / "src"
    src.mkdir()
    csrc = os.path.dirname(traverse._SRC)
    (src / "cluster_walk.cu").write_text(traverse.with_constants(
        open(traverse._SRC).read(), DENSE_RAYS=1))
    for h in traverse.HEADERS:
        (src / os.path.basename(h)).write_text(
            open(os.path.join(csrc, os.path.basename(h))).read())
    lib = emulate_source(tmp, str(src / "cluster_walk.cu"), _SHIM, 14)
    traverse._declare(lib)
    return lib


def run_emulated(lib, st, rays, any_hit):
    """K8's source on `rays` through the emulation: its outputs and its
    loads of mxu_ccs, cluster_feat and mxu_ccount."""
    n = rays[0].shape[0]
    tabs = (st.mxu_ccs, st.mxu_ccount, st.cluster_feat)
    ptrs = [a.data_ptr() for a in tabs + tuple(rays)]
    dims = (n, st.mxu_ccs.shape[0], st.cluster_k, None)
    loads = load_counters(lib, (st.mxu_ccs, st.cluster_feat, st.mxu_ccount))
    if any_hit:
        occ = torch.empty(n, dtype=torch.bool)
        assert lib.mts_dense_any_hit(*ptrs, occ.data_ptr(), *dims) == 0
        return occ, list(loads)
    t = torch.empty(n)
    slot = torch.empty(n, dtype=torch.int32)
    assert lib.mts_dense_closest_hit(*ptrs, t.data_ptr(), slot.data_ptr(),
                                     *dims) == 0
    return (t, slot), list(loads)


def assert_emulated_matches_twins(lib, st, rays, rays_per_thread):
    """Both hits of the emulated source bit-equal to their twins on every
    lane, and its loads as the twins count the threads' work: a thread
    reads a cluster's centroid row and count once a cluster it sweeps,
    and five float4 of plane rows a slot it loads."""
    tabs = (st.mxu_ccs, st.mxu_ccount, st.cluster_feat)
    for any_hit in (False, True):
        got, loads = run_emulated(lib, st, rays, any_hit)
        stats = {}
        twin = (traverse.dense_any_hit_plain if any_hit
                else traverse.dense_closest_hit_plain)
        out = twin(*tabs, *rays, st.cluster_k, stats=stats,
                   rays_per_thread=rays_per_thread)
        if any_hit:
            assert torch.equal(got, out)
        else:
            assert torch.equal(got[0], out[0])
            assert torch.equal(got[1], out[1])
        assert loads[0] == loads[2] == stats["thread_visits"]
        assert loads[1] == 5 * stats["loaded_slots"]


@pytest.mark.parametrize("kind", KINDS)
def test_dense_source_emulated_matches_twins(case, emulated, kind):
    """K8's source, one thread at a time, bit-equal to its twins; its
    loads as the twins count the threads' work."""
    assert_emulated_matches_twins(emulated, case.st,
                                  rays_of(case.rays, kind),
                                  traverse.DENSE_RAYS)


@pytest.mark.parametrize("rays_per_thread", [traverse.DENSE_RAYS, 1])
@pytest.mark.parametrize("kind", KINDS)
def test_dense_source_emulated_tail_and_dead_lanes(case, emulated,
                                                   emulated_r1, kind,
                                                   rays_per_thread):
    """The same at n = 2048 + 37, not a multiple of BLOCK * R (a tail
    block, part of a thread's rays past n), with dead lanes (t_max <= 0)
    amid the live ones, at the source's rays a thread and at one."""
    lib = emulated if rays_per_thread == traverse.DENSE_RAYS else emulated_r1
    rays = [torch.cat([a, a[:37]]) for a in rays_of(case.rays, kind)]
    tm = rays[6]
    tm[[5, 130, 131, 700, 1500, 2050]] = 0.0
    tm[[6, 260, 900, 2080]] = -1.0
    assert rays[0].shape[0] == 2085 and bool((tm > 0).any())
    assert_emulated_matches_twins(lib, case.st, rays, rays_per_thread)


def test_dense_source_emulated_cluster_without_slots(case, emulated):
    """A count of 0 (a cluster without a real slot): the kernel and the
    twins skip its slots and still read its centroid row and count."""
    count = case.st.mxu_ccount.clone()
    count[3] = 0
    st = dataclasses.replace(case.st, mxu_ccount=count)
    assert_emulated_matches_twins(emulated, st, rays_of(case.rays, "random"),
                                  traverse.DENSE_RAYS)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("kind", KINDS)
def test_cuda_dense_matches_twins(case, cuda, kind):
    st = mt.to_device(case.st, cuda)
    rays = rays_of(case.rays, kind, cuda)
    tabs = (st.mxu_ccs, st.mxu_ccount, st.cluster_feat)
    before = traverse.dense_closest_hit.launches
    t, slot = traverse.dense_closest_hit(*tabs, *rays, st.cluster_k)
    occ = traverse.dense_any_hit(*tabs, *rays, st.cluster_k)
    torch.cuda.synchronize()
    assert traverse.dense_closest_hit.launches == before + 1
    t_p, slot_p = traverse.dense_closest_hit_plain(*tabs, *rays,
                                                   st.cluster_k)
    occ_p = traverse.dense_any_hit_plain(*tabs, *rays, st.cluster_k)
    # --fmad=false: the kernel rounds as the twin's separate ops do
    assert torch.equal(t, t_p) and torch.equal(slot, slot_p)
    assert torch.equal(occ, occ_p)
