"""Visibility (boundary) gradients on the PyTorch port
(examples/occluder_pose_grad.py's workflow): translate an occluder whose
shadow is seen only through a second path vertex and recover
d(loss)/d(translation), a derivative that plain autograd reads as zero
(the integrand moves only through the shadow's edge) and that
RenderConfig(reparam=True) recovers (diff/reparam.py).

Run: python examples/torch/occluder_pose_grad.py [--device cuda|cpu]
"""
import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
RESULT = {}


def build_occluder_scene(device):
    """A floor the camera sees, a dark occluder and a small area light
    above it: (scene, the occluder's prim rows)."""
    import numpy as np

    import mitsuba2_tpu_torch as mt
    from mitsuba2_tpu_torch.scene import shapes

    T4 = mt.Transform4
    floor = shapes.rectangle(
        bsdf={"type": "diffuse", "reflectance": [0.8] * 3},
        id="floor").transformed(np.asarray(
            (T4.rotate([1, 0, 0], -90) @ T4.scale([2, 2, 1])).matrix))
    occ = shapes.rectangle(
        bsdf={"type": "diffuse", "reflectance": [0.0] * 3},
        id="occ").transformed(np.asarray(
            (T4.translate([0.6, 1.0, 0]) @ T4.rotate([1, 0, 0], -90)
             @ T4.scale([0.25, 0.25, 1])).matrix))
    light = shapes.rectangle(
        bsdf={"type": "diffuse", "reflectance": [0] * 3},
        emitter={"type": "area", "radiance": [30.0] * 3},
        id="light").transformed(np.asarray(
            (T4.translate([0.25, 2.0, 0]) @ T4.rotate([1, 0, 0], 90)
             @ T4.scale([0.12, 0.12, 1])).matrix))
    cam = T4.look_at(origin=[0.15, 0.55, 0.0], target=[0.25, 0.0, 0.0],
                     up=[0, 0, 1])
    scene = mt.build_scene([occ, floor, light], {
        "type": "perspective", "to_world": np.asarray(cam.matrix),
        "fov": 50.0}, device=device)
    return scene, (scene.prim_shape == 0).nonzero()[:, 0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=24)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    import torch

    import mitsuba2_tpu_torch as mt
    from mitsuba2_tpu_torch.device import device_name, resolve_device
    from mitsuba2_tpu_torch.scene.scene import refresh_mxu_feat

    dev = resolve_device(args.device)
    scene, occ_rows = build_occluder_scene(dev)
    cfg = mt.RenderConfig(width=args.res, height=args.res, spp=args.spp,
                          spp_per_pass=args.spp, max_depth=2)

    def loss(theta, reparam):
        shift = torch.zeros_like(scene.prim_p0)
        shift[occ_rows, 0] = 1.0
        s = dataclasses.replace(scene, prim_p0=scene.prim_p0 + shift * theta)
        # the walk's tables follow the moved vertices
        s = refresh_mxu_feat(s)
        return torch.mean(mt.render(s, cfg.replace(reparam=reparam),
                                    device=dev))

    def grad(reparam):
        theta = torch.zeros((), device=dev, requires_grad=True)
        (g,) = torch.autograd.grad(loss(theta, reparam), theta)
        return float(g)

    t0 = time.time()
    eps = 0.04
    with torch.no_grad():
        fd = (float(loss(torch.tensor(eps, device=dev), False))
              - float(loss(torch.tensor(-eps, device=dev), False))) / (2 * eps)
    ad_plain, ad_rep = grad(False), grad(True)
    print(f"finite differences (truth): {fd:+.4f}")
    print(f"plain AD (detached visibility): {ad_plain:+.4f}  <- misses it")
    print(f"reparameterized AD:            {ad_rep:+.4f}  <- recovers it")
    print(f"in {time.time() - t0:.2f} s on {device_name(dev)}")
    RESULT.update(fd=fd, ad_plain=ad_plain, ad_reparam=ad_rep)
    return fd, ad_plain, ad_rep


if __name__ == "__main__":
    fd, ad_plain, ad_rep = main()
    assert abs(ad_plain) < 0.25 * abs(fd)
    assert 0.4 * abs(fd) < abs(ad_rep) < 2.5 * abs(fd)
    print("ok")
