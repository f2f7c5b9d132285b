"""Differentiable rendering (counterpart of mitsuba2_tpu/diff/): the
pass-level adjoint, the parameter map, the optimizers and the
reparameterized directions of visibility gradients."""
from .params import ParameterMap, traverse, scene_with  # noqa: F401
from .optimizers import SGD, Adam  # noqa: F401
from .adjoint import render_and_grad, render_l2_grad  # noqa: F401
from .reparam import (render_direct_reparam, warp_and_divergence,  # noqa: F401
                      warp_and_divergence_multi, warp_field)
