"""Differentiable rendering (counterpart of mitsuba2_tpu/diff/): the
pass-level adjoint, the parameter map and the optimizers."""
from .params import ParameterMap, traverse, scene_with  # noqa: F401
from .optimizers import SGD, Adam  # noqa: F401
from .adjoint import render_and_grad, render_l2_grad  # noqa: F401
