"""What the entries share: the program's RenderConfig from a traffic
file, and the benchmark's scene handed to the program's scene build."""
from __future__ import annotations

import types

# the traffic keys that are RenderConfig fields
CONFIG_KEYS = ("width", "height", "spp", "spp_per_pass", "max_depth",
               "rr_depth", "color_mode", "sampler", "rfilter")


def program_api(mt):
    """The program's public entry points the benchmark calls, in one
    namespace: the faults of the benchmark's own tests and controls
    (gpubench/faults.py) are planted in a copy of it."""
    from mitsuba2_tpu_torch.diff.optimizers import adam_init, adam_step
    return types.SimpleNamespace(
        RenderConfig=mt.RenderConfig, build_scene=mt.build_scene,
        mesh=mt.shapes.mesh, render=mt.render,
        render_l2_grad=mt.render_l2_grad, scene_with=mt.scene_with,
        diff_tables=mt.diff_tables, with_tables=mt.with_tables,
        traverse=mt.traverse,
        adam_init=adam_init, adam_step=adam_step)


def render_config(api, traffic: dict):
    return api.RenderConfig(**{k: traffic[k] for k in CONFIG_KEYS})


def program_scene(api, spec: dict, device):
    """mt.build_scene of the benchmark's scene: each shape a mesh with a
    diffuse BSDF, an emitting shape an area emitter, the perspective
    camera."""
    shapes = [api.mesh(
        s["vertices"], s["faces"], normals=s["normals"], uvs=s["uvs"],
        bsdf={"type": "diffuse", "reflectance": s["reflectance"]},
        emitter=(None if s["radiance"] is None
                 else {"type": "area", "radiance": s["radiance"]}),
        id=s["id"]) for s in spec["shapes"]]
    cam = spec["camera"]
    sensor = {"type": "perspective", "to_world": cam["to_world"],
              "fov": cam["fov"]}
    return api.build_scene(shapes, sensor, device=device)
