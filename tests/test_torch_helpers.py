"""The public helpers of the PyTorch port that the JAX package's tests
call, against the JAX package: pcg32.advance (bit-equal to stepping and
to the JAX jump), next_uint32_bounded and sample_tea_64 (bit-equal),
spectrum.cie1931_y, luminance_rgb and srgb_model_mean, spec.slerp,
geometry.quat_slerp, sph_dir, dir_sph, spawn_ray and ray_bbox_slab
(atol 1e-6 on seeded sweeps), interaction.PreliminaryIntersection,
bvh.set_cluster_k (a scene built under a pinned cluster size carries it
and hits the prims the automatic one hits) and scene.set_ray_sort (the
presort forced on or off leaves every hit unchanged).
"""
import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.core import geometry as geo
from mitsuba2_tpu_torch.core import pcg32, spectrum
from mitsuba2_tpu_torch.core.spec import Spec, slerp
from mitsuba2_tpu_torch.core.vec import Vec2, Vec3
from mitsuba2_tpu_torch.core.geometry import Ray
from mitsuba2_tpu_torch.render.interaction import PreliminaryIntersection
from mitsuba2_tpu_torch.scene import bvh as bvh_mod
from mitsuba2_tpu_torch.scene import scene as scene_mod

torch.set_num_threads(1)


def _jax():
    import jax.numpy as jnp
    return jnp


def _lanes(n, seed):
    r = np.random.default_rng(seed).integers(0, 2 ** 32, (4, n),
                                             dtype=np.uint64)
    return r.astype(np.uint32)


@pytest.mark.parametrize("delta", [0, 1, 7, 1000, 2 ** 40 + 3])
def test_advance_bit_equal(delta):
    from mitsuba2_tpu.core import pcg32 as jpcg
    jnp = _jax()
    a = _lanes(64, delta % 97)
    s = pcg32.seed(*(torch.from_numpy(x.astype(np.int64)) for x in a))
    js = jpcg.seed(*(jnp.asarray(x) for x in a))
    adv = pcg32.advance(s, delta)
    jadv = jpcg.advance(js, delta)
    for f in adv._fields:
        np.testing.assert_array_equal(getattr(adv, f).numpy(),
                                      np.asarray(getattr(jadv, f)))
    if delta <= 1000:
        stepped = s
        for _ in range(delta):
            stepped = pcg32._step(stepped)
        for f in adv._fields:
            assert torch.equal(getattr(adv, f), getattr(stepped, f))


def test_bounded_and_tea64_bit_equal():
    from mitsuba2_tpu.core import pcg32 as jpcg
    jnp = _jax()
    a = _lanes(256, 5)
    s = pcg32.seed(*(torch.from_numpy(x.astype(np.int64)) for x in a))
    js = jpcg.seed(*(jnp.asarray(x) for x in a))
    for bound in (1, 7, 1000, 2 ** 31 + 5):
        v, s = pcg32.next_uint32_bounded(s, bound)
        jv, js = jpcg.next_uint32_bounded(js, bound)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        assert (v.numpy() < bound).all()
    hi, lo = pcg32.sample_tea_64(torch.from_numpy(a[0].astype(np.int64)),
                                 torch.from_numpy(a[1].astype(np.int64)))
    jhi, jlo = jpcg.sample_tea_64(jnp.asarray(a[0]), jnp.asarray(a[1]))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))


def test_spectrum_helpers_match_jax():
    from mitsuba2_tpu.core import spectrum as jsp
    jnp = _jax()
    rng = np.random.default_rng(2)
    wl = rng.uniform(340.0, 850.0, 4096).astype(np.float32)
    np.testing.assert_allclose(spectrum.cie1931_y(torch.from_numpy(wl)),
                               np.asarray(jsp.cie1931_y(jnp.asarray(wl))),
                               atol=1e-6)
    rgb = rng.random((512, 3)).astype(np.float32)
    np.testing.assert_allclose(
        spectrum.luminance_rgb(torch.from_numpy(rgb)).numpy(),
        np.asarray(jsp.luminance_rgb(jnp.asarray(rgb))), atol=1e-6)
    coeffs = np.stack([rng.uniform(-1e-4, 1e-4, 64), rng.uniform(-0.1, 0.1, 64),
                       rng.uniform(-5, 5, 64)], -1).astype(np.float32)
    np.testing.assert_allclose(
        spectrum.srgb_model_mean(torch.from_numpy(coeffs)).numpy(),
        np.asarray(jsp.srgb_model_mean(jnp.asarray(coeffs))), atol=1e-6)


def test_slerps_match_jax():
    from mitsuba2_tpu.core import geometry as jgeo
    from mitsuba2_tpu.core import spec as jspec
    jnp = _jax()
    rng = np.random.default_rng(3)
    a, b = rng.random((2, 3, 128)).astype(np.float32)
    t = rng.random(128).astype(np.float32)
    mine = slerp(Spec(tuple(torch.from_numpy(c) for c in a)),
                 Spec(tuple(torch.from_numpy(c) for c in b)),
                 torch.from_numpy(t))
    ref = jspec.slerp(jspec.Spec(tuple(jnp.asarray(c) for c in a)),
                      jspec.Spec(tuple(jnp.asarray(c) for c in b)),
                      jnp.asarray(t))
    for x, y in zip(mine.ch, ref.ch):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-6)
    for q0, q1 in ([[0, 0, 0, 1], [0, 0, np.sin(0.4), np.cos(0.4)]],
                   [[0, 0, 0, 1], [0, 0, 0, -1]],          # d < 0: flipped
                   [[0, 0, 0, 1], [0, 0, 1e-7, 1]]):       # small angle
        q0, q1 = np.asarray(q0, np.float32), np.asarray(q1, np.float32)
        np.testing.assert_allclose(
            geo.quat_slerp(q0, q1, torch.from_numpy(t)).numpy(),
            np.asarray(jgeo.quat_slerp(q0, q1, jnp.asarray(t))), atol=1e-6)
    # halfway between 0 and 90 degrees about z is 45 degrees
    q90 = np.array([0, 0, np.sin(np.pi / 4), np.cos(np.pi / 4)], np.float32)
    q = geo.quat_slerp(np.array([0, 0, 0, 1], np.float32), q90,
                       torch.tensor([0.5])).numpy()[0]
    np.testing.assert_allclose(q, [0, 0, np.sin(np.pi / 8),
                                   np.cos(np.pi / 8)], atol=1e-6)


def test_direction_and_ray_helpers_match_jax():
    from mitsuba2_tpu.core import geometry as jgeo
    from mitsuba2_tpu.core.vec import Vec3 as JVec3
    jnp = _jax()
    rng = np.random.default_rng(4)
    th = rng.uniform(0, np.pi, 1024).astype(np.float32)
    ph = rng.uniform(-np.pi, np.pi, 1024).astype(np.float32)
    v = geo.sph_dir(torch.from_numpy(th), torch.from_numpy(ph))
    jv = jgeo.sph_dir(jnp.asarray(th), jnp.asarray(ph))
    for a in "xyz":
        np.testing.assert_allclose(getattr(v, a).numpy(),
                                   np.asarray(getattr(jv, a)), atol=1e-6)
    t2, p2 = geo.dir_sph(v)
    jt2, jp2 = jgeo.dir_sph(jv)
    np.testing.assert_allclose(t2.numpy(), np.asarray(jt2), atol=2e-6)
    np.testing.assert_allclose(p2.numpy(), np.asarray(jp2), atol=2e-6)
    np.testing.assert_allclose(t2.numpy(), th, atol=1e-3)
    p = rng.normal(size=(3, 256)).astype(np.float32) * 10
    d = rng.normal(size=(3, 256)).astype(np.float32)
    n = rng.normal(size=(3, 256)).astype(np.float32)
    r = geo.spawn_ray(Vec3(*map(torch.from_numpy, p)),
                      Vec3(*map(torch.from_numpy, d)),
                      Vec3(*map(torch.from_numpy, n)))
    jr = jgeo.spawn_ray(JVec3(*map(jnp.asarray, p)),
                        JVec3(*map(jnp.asarray, d)),
                        JVec3(*map(jnp.asarray, n)))
    for a in "xyz":
        np.testing.assert_allclose(getattr(r.o, a).numpy(),
                                   np.asarray(getattr(jr.o, a)), atol=1e-6)
    assert torch.isinf(r.maxt).all()
    o = rng.uniform(-2, 2, (512, 3)).astype(np.float32)
    inv_d = 1.0 / rng.normal(size=(512, 3)).astype(np.float32)
    inv_d[::7, 1] = np.inf
    lo, hi = np.float32([-1, -1, -1]), np.float32([1, 0.5, 1])
    mine = geo.ray_bbox_slab(torch.from_numpy(o), torch.from_numpy(inv_d),
                             torch.from_numpy(lo), torch.from_numpy(hi), 3.0)
    ref = jgeo.ray_bbox_slab(jnp.asarray(o), jnp.asarray(inv_d),
                             jnp.asarray(lo), jnp.asarray(hi), 3.0)
    np.testing.assert_array_equal(mine[0].numpy(), np.asarray(ref[0]))
    for a, b in zip(mine[1:], ref[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def _gallery_rays(scene, n=2048, seed=0):
    rng = np.random.default_rng(seed)
    lo = scene.bvh_min[0].numpy()
    hi = scene.bvh_max[0].numpy()
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return Ray.make(Vec3(*torch.from_numpy(o.T.copy())),
                    Vec3(*torch.from_numpy(d.T.copy())))


def test_set_cluster_k_and_ray_sort():
    auto = mt.mesh_gallery(subdiv=1, device="cpu")
    try:
        bvh_mod.set_cluster_k(64)
        pinned = mt.mesh_gallery(subdiv=1, device="cpu")
    finally:
        bvh_mod.set_cluster_k(128, force=False)
    assert (auto.cluster_k, pinned.cluster_k) == (128, 64)
    with pytest.raises(ValueError):
        bvh_mod.set_cluster_k(36)
    ray = _gallery_rays(auto)
    with torch.inference_mode():
        ref = scene_mod._preliminary_dispatch(auto, ray)
        # the cluster walk's t comes from each cluster's plane rows, whose
        # rounding follows the clustering: the same hits, t within 1e-5
        # (and 1e-6 absolute, near the origin)
        got = scene_mod._preliminary_dispatch(pinned, ray)
        np.testing.assert_array_equal(got[1].numpy(), ref[1].numpy())
        np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(),
                                   rtol=1e-5, atol=1e-6)
        occ = scene_mod.ray_test(auto, ray)
        try:
            for mode in (True, False):
                scene_mod.set_ray_sort(mode)
                got = scene_mod._preliminary_dispatch(auto, ray)
                for a, b in zip(got[:2], ref[:2]):
                    assert torch.equal(a, b)
                assert torch.equal(scene_mod.ray_test(auto, ray), occ)
        finally:
            scene_mod.set_ray_sort("auto")
    with pytest.raises(ValueError):
        scene_mod.set_ray_sort("always")
    pi = PreliminaryIntersection(t=ref[0], prim_index=ref[1],
                                 prim_uv=Vec2(ref[2], ref[3]))
    assert torch.equal(pi.valid, torch.isfinite(ref[0]))
    assert bool(pi.valid.any()) and (ref[1][pi.valid] >= 0).all()


@pytest.mark.parametrize("shape", [(1, 6, 6), (4, 1, 5), (3, 4, 5)])
def test_grid_volume_thin_axes_match_jax(shape):
    """GridVolume.eval on a grid one voxel thick along an axis (the
    smoke_recovery example's (1, 6, 6)) equals the JAX package's, whose
    indexing wraps the thin axis' clamped index -1 to its one plane."""
    import jax.numpy as jnp
    from mitsuba2_tpu.core.vec import Vec3 as JVec3
    from mitsuba2_tpu.render import media as jmedia
    from mitsuba2_tpu_torch.render import media
    rng = np.random.default_rng(8)
    data = rng.random(shape).astype(np.float32)
    lo, hi = np.float32([-2, -2, -0.6]), np.float32([2, 2, 0.6])
    p = rng.uniform(lo - 0.3, hi + 0.3, (4096, 3)).astype(np.float32)
    mine = media.GridVolume(torch.from_numpy(data), torch.from_numpy(lo),
                            torch.from_numpy(hi)).eval(
        Vec3(*torch.from_numpy(p.T.copy())))
    ref = jmedia.GridVolume(jnp.asarray(data), jnp.asarray(lo),
                            jnp.asarray(hi)).eval(JVec3(*jnp.asarray(p.T)))
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=1e-6)
    assert (mine.numpy() > 0).any()
