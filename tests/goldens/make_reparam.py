"""Writes tests/goldens/reparam.npz: the JAX package's references for the
port's reparameterization tests (tests/test_torch_reparam.py).

On chip_smoke.occluder_scene (tests/test_reparam.py's _occluder_scene)
and chip_smoke.shadow_scene (its _shadow_scene, and
examples/occluder_pose_grad.py's scene), at the JAX tests' configs: the
primary-visibility images of render_direct_reparam and of the plain
render at max_depth 1, and the occluder-translation gradients of the mean
image by plain AD, by reparameterized AD and by a central difference
(test_occluder_translation_gradient: eps 0.03;
test_depth2_shadow_boundary_gradient: 24x24, 16 spp, depth 2, eps
0.04); the shadow scene's renders at 16x16, 4 spp, depth 3 with and
without reparam=True and, with it, in spectral mode; the warps of
tests/test_torch_reparam.py's two sites (warp_sites) and the gradient of
sum(det * g) with respect to the occluder's translation for K = 16 and
K = 4; and d(sum p.x)/d(a shift of prim_p0) of ray_intersect_positions
on the Cornell box (tests/test_follow_positions.py's rays). Its grads
compile for a minute or more on a CPU, so the tests read this file. Run
from the repository's root (a few minutes):

    python tests/goldens/make_reparam.py
"""
import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path[:0] = [ROOT, os.path.dirname(HERE)]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
import mitsuba2_tpu as mi  # noqa: E402
from mitsuba2_tpu.core.geometry import Ray  # noqa: E402
from mitsuba2_tpu.core.vec import Vec3  # noqa: E402
from mitsuba2_tpu.diff.reparam import (render_direct_reparam,  # noqa: E402
                                       warp_and_divergence_multi)
from mitsuba2_tpu.render.integrators import render  # noqa: E402
from mitsuba2_tpu.scene import presets as jpresets  # noqa: E402
from mitsuba2_tpu.scene import scene as jscene  # noqa: E402

from test_torch_reparam import (FOLLOW, OCC_CFG, OCC_EPS,  # noqa: E402
                                SHADOW_CFG, SHADOW_EPS, SHADOW_RENDER,
                                WARP_KS, follow_rays, warp_sites)

OUT = os.path.join(HERE, "reparam.npz")


def translated(scene, rows, theta):
    shift = jnp.stack([theta, jnp.zeros_like(theta), jnp.zeros_like(theta)])
    return scene.replace(prim_p0=scene.prim_p0.at[rows].add(shift))


def v3(a):
    return Vec3(*jnp.asarray(np.asarray(a, np.float32).T))


def grads(loss, eps):
    fd = (float(loss(jnp.float32(eps), False))
          - float(loss(jnp.float32(-eps), False))) / (2 * eps)
    plain = float(jax.grad(loss)(jnp.float32(0.0), False))
    rep = float(jax.grad(loss)(jnp.float32(0.0), True))
    return np.float64(fd), np.float64(plain), np.float64(rep)


def main():
    out = {"config": np.asarray(json.dumps(dict(
        occ=OCC_CFG, shadow=SHADOW_CFG, shadow_render=SHADOW_RENDER,
        occ_eps=OCC_EPS, shadow_eps=SHADOW_EPS, warp_ks=WARP_KS,
        follow=FOLLOW)))}

    occ, occ_rows = chip_smoke.occluder_scene(jpresets)
    cfg = mi.RenderConfig(**OCC_CFG)
    out["occ_image_reparam"] = np.asarray(render_direct_reparam(occ, cfg))
    out["occ_image_plain"] = np.asarray(render(occ, cfg))

    def occ_loss(theta, reparam):
        s = translated(occ, occ_rows, theta)
        img = (render_direct_reparam(s, cfg) if reparam
               else render(s, cfg))
        return jnp.mean(img)
    out["occ_fd"], out["occ_plain"], out["occ_reparam"] = grads(occ_loss,
                                                                OCC_EPS)
    print("occluder", out["occ_fd"], out["occ_plain"], out["occ_reparam"],
          flush=True)

    sh, sh_rows = chip_smoke.shadow_scene(jpresets)
    scfg = mi.RenderConfig(**SHADOW_CFG)

    def shadow_loss(theta, reparam):
        s = translated(sh, sh_rows, theta)
        return jnp.mean(render(s, scfg.replace(reparam=reparam)))
    out["shadow_fd"], out["shadow_plain"], out["shadow_reparam"] = grads(
        shadow_loss, SHADOW_EPS)
    print("shadow", out["shadow_fd"], out["shadow_plain"],
          out["shadow_reparam"], flush=True)

    rcfg = mi.RenderConfig(**SHADOW_RENDER)
    out["shadow_image_plain"] = np.asarray(render(sh, rcfg))
    out["shadow_image_reparam"] = np.asarray(
        render(sh, rcfg.replace(reparam=True)))
    out["shadow_image_reparam_spectral"] = np.asarray(
        render(sh, rcfg.replace(reparam=True, color_mode="spectral")))

    sites = [(v3(o), v3(d)) for o, d in warp_sites()]
    gs = [jnp.asarray(g) for g in warp_sites(weights=True)]
    for k in WARP_KS:
        for i, (V, det) in enumerate(
                warp_and_divergence_multi(sh, sites, k)):
            out[f"warp_V{i}_k{k}"] = np.stack(
                [np.asarray(c) for c in (V.x, V.y, V.z)], -1)
            out[f"warp_det{i}_k{k}"] = np.asarray(det)

        def f(theta, k=k):
            s = translated(sh, sh_rows, theta)
            return sum(jnp.sum(det * g) for (_, det), g in zip(
                warp_and_divergence_multi(s, sites, k), gs))
        out[f"warp_grad_k{k}"] = np.float64(jax.grad(f)(jnp.float32(0.0)))
        print("warp", k, out[f"warp_grad_k{k}"], flush=True)

    cb = jpresets.cornell_box()
    o, d = follow_rays(np.asarray(cb.bvh_min)[0], np.asarray(cb.bvh_max)[0],
                       **FOLLOW)
    ray = Ray.make(v3(o), v3(d))

    def px(shift):
        s = cb.replace(prim_p0=cb.prim_p0 + shift[None, :])
        p, _, valid = jscene.ray_intersect_positions(s, ray)
        return jnp.where(valid, p.x, 0.0).sum()
    out["follow_grad"] = np.asarray(jax.grad(px)(jnp.zeros(3, jnp.float32)))
    print("follow", out["follow_grad"], flush=True)
    np.savez_compressed(OUT, **out)
    print("wrote", OUT)


if __name__ == "__main__":
    main()
