"""The adjoint: parameter gradients of a render, pass by pass
(counterpart of mitsuba2_tpu/diff/adjoint.py).

The same two-phase schedule as the JAX package's:

1. Phase 1 renders every pass without a tape (inference mode), develops
   the image and takes the loss and dLoss/dImage by autograd on the image
   alone.
2. Phase 2 replays each pass with the same seed under autograd, on fresh
   leaf copies of the diff tables, with the adjoint image dLoss/dImage /
   wsum as the output gradient, and adds up the tables' gradients pass by
   pass: the peak memory is one pass's tape, whatever the spp.

Traversal is detached (scene.ray_test, scene._preliminary_dispatch): a
pass's tape holds its shading alone, so the backward sweep traces no
ray, and gradients flow through shading and emission only, into
`mat_data` and `emitter_data`, on a scene with textures into the atlas'
texels (`tex_data`, through every level of the pyramid, rebuilt from
them), and on a scene with an envmap into its image and scale
(`env_image`, `env_scale`). The JAX package's
config.remat has no
counterpart: checkpointing each bounce's shading kept as much memory as
the tape it replaced (PERF.md).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from ..config import RenderConfig
from ..device import resolve_device
from ..render import film as film_mod
from ..render.integrators import pass_seeds, render_pass
from ..scene.scene import (DIFF_TABLES, ENV_DIFF_TABLES, TEX_DIFF_TABLE,
                           diff_tables, to_device)

# diff tables of the JAX package that come with a later slice
_LATER = ("med_data", "med_grid")


def with_tables(scene, tables: Dict[str, torch.Tensor]):
    """The scene with `tables` (diff_tables' keys) in place of its own.
    New texels rebuild the mip pyramid, so that gradients flow through
    every level. An envmap's importance table and spectral coefficients
    stay as built, as in the JAX package: only its image and scale are
    replaced."""
    later = sorted(set(tables) & set(_LATER))
    if later:
        raise NotImplementedError(
            f"mitsuba2_tpu_torch has no {later} tables yet")
    new = {k: tables[k] for k in DIFF_TABLES}
    if TEX_DIFF_TABLE in tables:
        new["textures"] = scene.textures.with_data(tables[TEX_DIFF_TABLE])
    env = {f: tables[k] for k, f in ENV_DIFF_TABLES.items() if k in tables}
    if env:
        new["envmap"] = dataclasses.replace(scene.envmap, **env)
    return dataclasses.replace(scene, **new)


def render_and_grad(scene, config: RenderConfig,
                    loss_fn: Callable[[torch.Tensor], torch.Tensor],
                    seed: int = None, device=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Render, loss and the loss's gradients with respect to
    diff_tables(scene), on `device` (None = the CUDA device; raises
    without one). Returns (image, loss, grads), grads keyed as
    diff_tables."""
    dev = resolve_device(device)
    scene = to_device(scene, dev)
    if seed is None:
        seed = config.seed
    sppc = min(config.spp_per_pass, config.spp)
    config = config.replace(spp_per_pass=sppc)
    seeds = pass_seeds(seed, (config.spp + sppc - 1) // sppc)

    # ---- phase 1: every pass, no tape ---------------------------------------
    image_sum, wsum = None, 0
    with torch.inference_mode():
        for s in seeds:
            img_p, w_p = render_pass(scene, config, s, dev)
            image_sum = img_p if image_sum is None else image_sum + img_p
            wsum += w_p
        image = film_mod.develop(image_sum, wsum)

    # ---- the adjoint image: dLoss/dImage / wsum (develop's derivative) -----
    image = image.clone().requires_grad_(True)
    with torch.enable_grad():
        loss = loss_fn(image)
        dl_dimage, = torch.autograd.grad(loss, image)
    ct_image = dl_dimage / max(float(wsum), 1e-8)

    # ---- phase 2: each pass replayed under autograd -------------------------
    grads = {k: torch.zeros_like(v) for k, v in diff_tables(scene).items()}
    with torch.enable_grad():
        for s in seeds:
            leaves = {k: v.detach().clone().requires_grad_(True)
                      for k, v in diff_tables(scene).items()}
            img_p, _ = render_pass(with_tables(scene, leaves), config, s, dev)
            torch.autograd.backward(img_p, ct_image)
            for k, v in leaves.items():
                grads[k] += v.grad
    return image.detach(), loss.detach(), grads


def render_l2_grad(scene, config: RenderConfig, target, seed: int = None,
                   device=None):
    """render_and_grad with the L2 loss against `target` (the invert_cbox
    loop's)."""
    return render_and_grad(
        scene, config, lambda img: torch.mean((img - target) ** 2), seed,
        device)
