"""Rendering over the ranks of a torch.distributed group (counterpart of
dist/sharding.py).

Pure data parallelism, as in the JAX package: every rank holds the whole
scene and renders spp_per_pass / world samples of each pass; two
collectives join them, an all-reduce (sum) of the film and its weight
after each pass, and one of the gradients at the end of the adjoint.
Every rank returns the same image, loss and gradients.

The determinism contract: rank r renders its samples at lane offset
r * spp_per_pass / world * H * W with the pass's seed
(render_pass(lane_offset=...)), so with the independent sampler the
ranks together draw every number one process draws; only the film's
summation order differs (rtol ~1e-5). The forked delta-tracking streams
of volpath are seeded from main-stream draws, so media keep it too. The
stratified and ld samplers stratify over a rank's local spp_per_pass,
as the JAX package's do: there a sharded render equals the JAX
package's render_sharded, not the one-process render.

A mesh with no process group (none initialized) is one rank, and its
all-reduce is the identity; a group of one rank runs each collective.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist

from ..config import RenderConfig
from ..device import resolve_device
from ..diff import adjoint as adjoint_mod
from ..diff import optimizers as opt_mod
from ..render import film as film_mod
from ..render.integrators import _tape, pass_seeds, render_pass
from ..scene.scene import to_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks a render is split over: this process's rank and the
    group's size, the device it renders on, and the process group
    (None: the default group; `grouped` False: no group, one rank)."""
    rank: int
    size: int
    device: torch.device
    group: object = None
    grouped: bool = False


def make_mesh(group=None, device=None) -> Mesh:
    """The mesh of `group` (None = the default group, or one rank
    without a process group) on `device` (None = the CUDA device;
    raises without one)."""
    dev = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        return Mesh(dist.get_rank(group), dist.get_world_size(group), dev,
                    group, True)
    return Mesh(0, 1, dev)


def all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum `t` over the mesh's ranks, in place; returns it."""
    if mesh.grouped:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def _split_config(config: RenderConfig, n: int) -> RenderConfig:
    assert config.spp_per_pass % n == 0, \
        f"spp_per_pass={config.spp_per_pass} not divisible by {n} ranks"
    return config.replace(spp_per_pass=config.spp_per_pass // n)


def _lane_offset(local_cfg: RenderConfig, mesh: Mesh) -> int:
    """This rank's offset into the pass's global lane space."""
    return mesh.rank * local_cfg.spp_per_pass * local_cfg.height \
        * local_cfg.width


def _mesh(mesh):
    return make_mesh() if mesh is None else mesh


def render_pass_sharded(scene, config: RenderConfig, seed, mesh: Mesh = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pass with spp_per_pass split over the mesh: the (H, W, C)
    image sum and the weight sum (a 0-d tensor under the box filter,
    else (H, W)), each summed over the ranks."""
    mesh = _mesh(mesh)
    local = _split_config(config, mesh.size)
    img, w = render_pass(to_device(scene, mesh.device), local, seed,
                         mesh.device, _lane_offset(local, mesh))
    w = torch.as_tensor(w, dtype=torch.float32, device=mesh.device).clone()
    return all_reduce(img, mesh), all_reduce(w, mesh)


def render_sharded(scene, config: RenderConfig, mesh: Mesh = None,
                   seed: int = None) -> torch.Tensor:
    """The whole render, pass by pass, each pass split over the mesh:
    spp_per_pass is clamped to spp and to a multiple of the ranks (at
    least one sample each), as in the JAX package."""
    mesh = _mesh(mesh)
    scene = to_device(scene, mesh.device)
    if seed is None:
        seed = config.seed
    sppc = min(config.spp_per_pass, config.spp)
    sppc = max(mesh.size, (sppc // mesh.size) * mesh.size)
    config = config.replace(spp_per_pass=sppc)
    image = wsum = None
    with _tape(scene):
        for s in pass_seeds(seed, (config.spp + sppc - 1) // sppc):
            img_p, w_p = render_pass_sharded(scene, config, s, mesh)
            image = img_p if image is None else image + img_p
            wsum = w_p if wsum is None else wsum + w_p
    return film_mod.develop(image, wsum)


def render_and_grad_sharded(scene, config: RenderConfig,
                            loss_fn: Callable[[torch.Tensor], torch.Tensor],
                            mesh: Mesh = None, seed: int = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """diff/adjoint.py::render_and_grad over the mesh. Phase 1 renders
    this rank's share of each pass without a tape and sums the film and
    its weight over the ranks, so every rank develops the same image and
    takes the same loss and adjoint image; phase 2 replays this rank's
    share under autograd; one all-reduce sums the gradients. Returns
    (image, loss, grads), grads keyed as diff_tables, the same on every
    rank."""
    mesh = _mesh(mesh)
    if seed is None:
        seed = config.seed
    sppc = min(config.spp_per_pass, config.spp)
    config = config.replace(spp_per_pass=sppc)
    local = _split_config(config, mesh.size)
    return adjoint_mod.adjoint_passes(
        to_device(scene, mesh.device), local, loss_fn,
        pass_seeds(seed, (config.spp + sppc - 1) // sppc), mesh.device,
        _lane_offset(local, mesh), lambda t: all_reduce(t, mesh))


def train_step_sharded(scene, config: RenderConfig, target, seed,
                       mesh: Mesh = None, opt_state=None, lr: float = 0.05):
    """One inverse-rendering step over the mesh: the L2 loss against
    `target`, its gradients with respect to every diff table
    (render_and_grad_sharded) and an Adam step. Returns (new_scene,
    opt_state, loss, image); pass opt_state back in (None starts Adam)."""
    mesh = _mesh(mesh)
    scene = to_device(scene, mesh.device)
    tables = adjoint_mod.diff_tables(scene)
    if opt_state is None:
        opt_state = opt_mod.adam_init(tables)
    target = torch.as_tensor(target, device=mesh.device)
    image, loss, grads = render_and_grad_sharded(
        scene, config, lambda im: torch.mean((im - target) ** 2), mesh, seed)
    new_tables, opt_state = opt_mod.adam_step(tables, grads, opt_state, lr)
    return (adjoint_mod.with_tables(scene, new_tables), opt_state, loss,
            image)
