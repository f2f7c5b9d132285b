"""mitsuba2_tpu_torch — the PyTorch + CUDA port of mitsuba2_tpu.

A second package beside the JAX one, which stays the reference. It
renders on an NVIDIA H100 through hand-written CUDA traversal kernels
(csrc/cluster_walk.cu) and plain PyTorch around them, in rgb, mono or
spectral mode, participating media through the volumetric path tracer
(render/volpath.py), polarized light through Mueller calculus
(render/stokes.py: `render_polarized` for the *_polarized variants,
`render_stokes` for the stokes integrator), measured BRDFs among its
materials (render/measured.py, RGL .bsdf files), and differentiates a
render with respect to the
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

A scene file goes through the Mitsuba XML loader, and the command line
renders one (`python -m mitsuba2_tpu_torch scene.xml -o out.pfm`):

    scene, cfg = mt.load_file("scene.xml", spp=16)   # $spp = 16
    mt.write_bitmap("out.pfm", mt.render_any(scene, cfg).cpu().numpy())

`dist/` splits a render, its adjoint and an optimizer step over the
ranks of a torch.distributed group and checkpoints long runs;
`utils/observability.py` reports a render pass by pass.
RenderConfig(dtype="float64") (the `_double` variants) renders in double
precision, `register_bsdf` adds a user BSDF plugin, and
`train_shadow_nif` fits the optional neural shadow oracle a scene can
carry (`SceneData.shadow_nif`).

Entry points run on CUDA unless the caller passes `device="cpu"`; without
a CUDA device and without that argument they raise. Importing this
package touches no CUDA device and builds no kernel: the kernels are
built with nvcc at their first launch. It imports torch, numpy and the
standard library only, never jax or mitsuba2_tpu.
"""
from .config import RenderConfig, parse_variant, variants
from .convert import scene_from_numpy
from .core.geometry import Transform4
from .core.io_bitmap import read as read_bitmap, write as write_bitmap
from .scene import presets, shapes
from .scene.presets import (cornell_box, furnace, instanced_field,
                             kitchen_sink, mesh_gallery, smoke_box,
                             veach_mis)
from .scene.scene import SceneData, build_scene, to_device
from .render.bsdf import register_bsdf
from .render.integrators import (render, render_any, render_aovs,
                                  render_pass, render_with_variance)
from .render.nif import train_shadow_nif
from .render.stokes import render_polarized, render_stokes
from .diff import (Adam, ParameterMap, SGD, render_and_grad, render_l2_grad,
                   scene_with, traverse)
from .diff.adjoint import diff_tables, with_tables
from .dist.sharding import make_mesh, render_sharded

__all__ = ["Adam", "ParameterMap", "RenderConfig", "SGD", "SceneData",
           "Transform4", "build_scene", "cornell_box", "diff_tables",
           "furnace", "instanced_field", "kitchen_sink", "load_dict",
           "load_file", "load_string", "make_mesh", "mesh_gallery",
           "parse_variant", "presets", "read_bitmap", "register_bsdf",
           "render", "render_and_grad", "render_any", "render_aovs",
           "render_l2_grad", "render_pass", "render_polarized",
           "render_sharded", "render_stokes", "render_with_variance",
           "scene_from_numpy", "scene_with", "set_variant", "shapes",
           "smoke_box", "to_device", "train_shadow_nif", "traverse",
           "variant", "variants", "veach_mis", "with_tables",
           "write_bitmap"]

# set_variant / variant: the reference's variant switcher, as the JAX
# package has it: a default applied to the configs the loaders return
_variant = None


def set_variant(name: str) -> None:
    """Select the default variant of scenes loaded from now on
    (mitsuba.set_variant); a _double one renders them in float64."""
    global _variant
    parse_variant(name)  # validate
    _variant = name


def variant():
    """The active default variant string, or None (mitsuba.variant())."""
    return _variant


def _apply_variant(out):
    scene, config = out
    if _variant is not None:
        config = config.replace(**parse_variant(_variant))
    return scene, config


def load_file(path: str, device=None, **params):
    """Parse a scene XML file -> (SceneData on `device`, RenderConfig).
    Keywords substitute `$var` parameters (the CLI's -D); `sensor_index`
    picks a <sensor>. The active set_variant() applies to the config."""
    from .scene import loader
    return _apply_variant(loader.load_file(path, device=device, **params))


def load_string(xml: str, base_dir: str = "", device=None, **params):
    """Parse scene XML text -> (SceneData on `device`, RenderConfig)."""
    from .scene import loader
    return _apply_variant(loader.load_string(xml, base_dir, device=device,
                                             **params))


def load_dict(d: dict, device=None):
    """Build a scene from a nested dict (mitsuba.load_dict) on `device`."""
    from .scene import loader
    return _apply_variant(loader.load_dict(d, device=device))
