"""Writes tests/goldens/media.npz: the JAX package's references for the
port's medium-gradient tests (tests/test_torch_medium_grad.py).

On tests/test_medium_grad.py's two slab scenes (a homogeneous medium and
a heterogeneous one over a constant grid, built from the JAX package by
chip_smoke.medium_slab) at that test's config and seeds:
render_and_grad of the image mean, its image and its med_data (and
med_grid) gradients. The JAX adjoint compiles for a minute or more on a
CPU, so the tests read this file. Run from the repository's root:

    python tests/goldens/make_media.py
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

import mitsuba2_tpu as mi  # noqa: E402
import chip_smoke  # noqa: E402
from mitsuba2_tpu.diff.adjoint import render_and_grad  # noqa: E402
from mitsuba2_tpu.scene import presets as jpresets  # noqa: E402

from test_torch_medium_grad import CFG, SLABS, slab_kw  # noqa: E402

OUT = os.path.join(HERE, "media.npz")


def main():
    out = {"config": np.asarray(json.dumps(dict(
        cfg=CFG, slabs={k: {a: (b.tolist() if hasattr(b, "tolist") else b)
                            for a, b in v.items()}
                        for k, v in SLABS.items()})))}
    for name, kw in SLABS.items():
        scene = chip_smoke.medium_slab(jpresets, **slab_kw(name))
        img, _, grads = render_and_grad(scene, mi.RenderConfig(**CFG),
                                        jnp.mean, seed=kw["seed"])
        out[f"{name}_image"] = np.asarray(img, np.float32)
        for k in ("med_data", "med_grid"):
            if k in grads:
                out[f"{name}_{k}"] = np.asarray(grads[k], np.float32)
        print(name, {k: float(np.abs(np.asarray(v)).max())
                     for k, v in grads.items()}, flush=True)
    np.savez_compressed(OUT, **out)
    print("wrote", OUT)


if __name__ == "__main__":
    main()
