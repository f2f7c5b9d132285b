"""render_torch: a differentiable render inside a torch autograd graph
(counterpart of mitsuba2_tpu/diff/torch_interop.py).

The JAX package wraps its render in a torch.autograd.Function whose
backward runs the JAX adjoint. The port renders in torch and no kernel
needs a gradient, so this is the render itself under autograd:

    params = {"mat_data": scene.mat_data.clone().requires_grad_(True)}
    img = render_torch(scene, config, params, seed=1)   # (H, W, C)
    torch.nn.functional.mse_loss(img, target).backward()  # params' .grad
"""
from __future__ import annotations

from typing import Dict

import torch

from ..config import RenderConfig
from ..render.integrators import render
from .adjoint import diff_tables, with_tables


def render_torch(scene, config: RenderConfig,
                 params: Dict[str, torch.Tensor], seed: int = None,
                 device=None) -> torch.Tensor:
    """Differentiable render on `device` (None = the CUDA device; raises
    without one). `params`: table name -> tensor for any subset of
    diff_tables(scene)'s keys ("mat_data", "emitter_data", and on a scene
    with an envmap "env_image" and "env_scale"); gradients
    flow to those with requires_grad."""
    valid = set(diff_tables(scene))
    unknown = set(params) - valid
    if unknown:
        raise ValueError(f"unknown param tables {sorted(unknown)}; "
                         f"valid: {sorted(valid)}")
    scene = with_tables(scene, {**diff_tables(scene), **params})
    return render(scene, config, seed, device)
