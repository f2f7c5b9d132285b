"""Writes tests/goldens/gallery_textured.npz: the JAX package's references
for the port's textured-gallery tests (tests/test_torch_texture.py).

The scene is chip_smoke.gallery_textured at subdiv 1 with a 32 x 32 floor
texture (the others smaller). The file holds its renders at 16x16, 4 spp,
depth 3, seed 0, in rgb and in spectral mode, and its render_l2_grad
against a zero target under the own-rows dispatch
(tests/test_torch_veach.py::_jax_l2_grad), op by op: image, loss and the
gradients of mat_data, emitter_data and tex_data. The JAX package
compiles each render for two to four minutes on a CPU, and its adjoint
for over an hour, more than a test can spend, so the tests read this
file. Run from the repository's root (about 15 minutes):

    python tests/goldens/make_gallery_textured.py
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

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
import mitsuba2_tpu as mi  # noqa: E402
from mitsuba2_tpu.scene import presets as jpresets  # noqa: E402

SUBDIV, RES = 1, 32
RENDER = dict(width=16, height=16, spp=4, spp_per_pass=4, max_depth=3,
              rr_depth=8)
OUT = os.path.join(HERE, "gallery_textured.npz")


def main():
    from test_torch_veach import _jax_l2_grad
    scene = chip_smoke.gallery_textured(jpresets, SUBDIV, RES)
    out = {"config": np.asarray(json.dumps(
        dict(subdiv=SUBDIV, res=RES, render=RENDER, seed=0)))}
    for mode in ("rgb", "spectral"):
        img = mi.render(scene, mi.RenderConfig(**RENDER, color_mode=mode),
                        seed=0)
        out[f"image_{mode}"] = np.asarray(img)
        print(mode, float(np.mean(out[f"image_{mode}"])), flush=True)
    # op by op: XLA's compile of the whole adjoint of this scene runs past
    # an hour on a CPU
    with jax.disable_jit():
        img, loss, grads = _jax_l2_grad(scene, mi.RenderConfig(**RENDER))
    out["grad_image"], out["grad_loss"] = img, np.float32(loss)
    for k, g in grads.items():
        out[f"grad_{k}"] = g
        print(k, g.shape, int(np.isfinite(g).sum()), flush=True)
    np.savez_compressed(OUT, **out)
    print("wrote", OUT)


if __name__ == "__main__":
    main()
