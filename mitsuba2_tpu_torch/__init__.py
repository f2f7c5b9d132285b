"""mitsuba2_tpu_torch — the PyTorch + CUDA port of mitsuba2_tpu.

A second package beside the JAX one, which stays the reference. It
renders on an NVIDIA H100 through hand-written CUDA traversal kernels
(csrc/cluster_walk.cu) and plain PyTorch around them, in rgb, mono or
spectral mode, participating media through the volumetric path tracer
(render/volpath.py), and differentiates a render with respect to the
scene's material, emitter and medium tables, an envmap's image and scale
and a density grid (diff/: the pass-by-pass adjoint, the parameter map
and the optimizers), and with respect to its geometry, visibility
boundaries included, under RenderConfig(reparam=True) (diff/reparam.py):

    import mitsuba2_tpu_torch as mt
    scene = mt.mesh_gallery(subdiv=4)          # tensors on the CUDA device
    cfg = mt.RenderConfig(width=256, height=256, spp=16, spp_per_pass=16,
                          max_depth=3)
    img = mt.render(scene, cfg)
    image, loss, grads = mt.render_l2_grad(scene, cfg, target=img * 0.5)

Entry points run on CUDA unless the caller passes `device="cpu"`; without
a CUDA device and without that argument they raise. Importing this
package touches no CUDA device and builds no kernel: the kernels are
built with nvcc at their first launch. It imports torch, numpy and the
standard library only, never jax or mitsuba2_tpu.
"""
from .config import RenderConfig
from .convert import scene_from_numpy
from .scene.presets import (cornell_box, furnace, instanced_field,
                             kitchen_sink, mesh_gallery, smoke_box,
                             veach_mis)
from .scene.scene import SceneData, build_scene, to_device
from .render.integrators import render, render_pass
from .diff import (Adam, SGD, render_and_grad, render_l2_grad, scene_with,
                   traverse)

__all__ = ["Adam", "RenderConfig", "SGD", "SceneData", "build_scene",
           "cornell_box", "furnace", "instanced_field", "kitchen_sink",
           "mesh_gallery", "render", "render_and_grad", "render_l2_grad",
           "render_pass", "scene_from_numpy", "scene_with", "smoke_box", "to_device",
           "traverse", "veach_mis"]
