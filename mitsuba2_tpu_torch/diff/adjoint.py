"""The adjoint: parameter gradients of a render, pass by pass
(counterpart of mitsuba2_tpu/diff/adjoint.py).

The same two-phase schedule as the JAX package's:

1. Phase 1 renders every pass without a tape (inference mode), develops
   the image and takes the loss and dLoss/dImage by autograd on the image
   alone.
2. Phase 2 replays each pass with the same seed under autograd, on fresh
   leaf copies of the diff tables, with the adjoint image dLoss/dImage /
   wsum as the output gradient (wsum per pixel under a wide filter), and
   adds up the tables' gradients pass by pass: the peak memory is one
   pass's tape, whatever the spp. Any sampler and filter: the replay
   draws the same streams.

Traversal is detached (scene.ray_test, scene._preliminary_dispatch): a
pass's tape holds its shading alone, so the backward sweep traces no
ray, and gradients flow through shading and emission only, into
`mat_data` and `emitter_data`, on a scene with textures into the atlas'
texels (`tex_data`, through every level of the pyramid, rebuilt from
them), on a scene with an envmap into its image and scale (`env_image`,
`env_scale`), and on a scene with media into the medium rows
(`med_data`: Beer-Lambert attenuation, the free-flight weights, the
shadow rays' transmittance) and the density grid (`med_grid`, through
delta tracking's differential factor and the transmittance raymarch). The JAX package's
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
from ..scene.scene import (DIFF_TABLES, ENV_DIFF_TABLES, GRID_DIFF_TABLE,
                           MED_DIFF_TABLE, TEX_DIFF_TABLE, diff_tables,
                           to_device, to_float64)


def with_tables(scene, tables: Dict[str, torch.Tensor]):
    """The scene with `tables` (diff_tables' keys) in place of its own.
    New texels rebuild the mip pyramid, so that gradients flow through
    every level. An envmap's importance table and spectral coefficients
    stay as built, as in the JAX package: only its image and scale are
    replaced; so does the majorant's source, the grid, which each flight
    reads anew."""
    new = {k: tables[k] for k in DIFF_TABLES}
    if MED_DIFF_TABLE in tables:
        new["med_data"] = tables[MED_DIFF_TABLE]
    if GRID_DIFF_TABLE in tables:
        new["medium_grid"] = dataclasses.replace(
            scene.medium_grid, data=tables[GRID_DIFF_TABLE])
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
    diff_tables; in float64 under RenderConfig(dtype="float64"), whose
    render differentiates the scene's f64 upcast (scene.to_float64)."""
    dev = resolve_device(device)
    if seed is None:
        seed = config.seed
    sppc = min(config.spp_per_pass, config.spp)
    config = config.replace(spp_per_pass=sppc)
    scene = to_device(scene, dev)
    if config.dtype == "float64":
        scene = to_float64(scene)
    return adjoint_passes(scene, config, loss_fn,
                          pass_seeds(seed, (config.spp + sppc - 1) // sppc),
                          dev)


def adjoint_passes(scene, config: RenderConfig, loss_fn, seeds, dev,
                   lane_offset: int = 0, reduce=None):
    """render_and_grad's two phases over the passes of `seeds`, each a
    render_pass of `config` at `lane_offset`. `reduce`, where given,
    sums a tensor over the ranks in place (dist/sharding.py): the film
    and its weight before the develop, the gradients at the end."""
    # ---- phase 1: every pass, no tape ---------------------------------------
    image_sum, wsum = None, 0
    with torch.inference_mode():
        for s in seeds:
            img_p, w_p = render_pass(scene, config, s, dev, lane_offset)
            image_sum = img_p if image_sum is None else image_sum + img_p
            wsum = wsum + w_p
        if reduce is not None:
            wsum = reduce(torch.as_tensor(wsum, dtype=torch.float32,
                                          device=dev).clone())
            image_sum = reduce(image_sum)
        image = film_mod.develop(image_sum, wsum)

    # ---- the adjoint image: dLoss/dImage / wsum (develop's derivative; the
    # filter's weights do not depend on the tables) --------------------------
    image = image.clone().requires_grad_(True)
    with torch.enable_grad():
        loss = loss_fn(image)
        dl_dimage, = torch.autograd.grad(loss, image)
    ct_image = film_mod.develop(dl_dimage, wsum)

    # ---- phase 2: each pass replayed under autograd -------------------------
    grads = {k: torch.zeros_like(v) for k, v in diff_tables(scene).items()}
    with torch.enable_grad():
        for s in seeds:
            leaves = {k: v.detach().clone().requires_grad_(True)
                      for k, v in diff_tables(scene).items()}
            img_p, _ = render_pass(with_tables(scene, leaves), config, s, dev,
                                   lane_offset)
            torch.autograd.backward(img_p, ct_image)
            for k, v in leaves.items():
                grads[k] += v.grad
    if reduce is not None:
        for g in grads.values():
            reduce(g)
    return image.detach(), loss.detach(), grads


def render_l2_grad(scene, config: RenderConfig, target, seed: int = None,
                   device=None):
    """render_and_grad with the L2 loss against `target` (the invert_cbox
    loop's)."""
    return render_and_grad(
        scene, config, lambda img: torch.mean((img - target) ** 2), seed,
        device)
