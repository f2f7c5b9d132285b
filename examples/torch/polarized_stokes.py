"""Polarized rendering on the PyTorch port (examples/polarized_stokes.py's
workflow): the Stokes image of a glass plate near Brewster's angle (the
stokes integrator; the degree of linear polarization peaks at 1 there),
then Malus's law through the full polarized transport: two linear
polarizers rotated against each other attenuate by cos^2(theta).

Run: python examples/torch/polarized_stokes.py [--res 96] [--spp 64]
     [--device cuda|cpu] [--out-dir .]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
RESULT = {}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=96)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--malus-res", type=int, default=24)
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    import mitsuba2_tpu_torch as mt
    from mitsuba2_tpu_torch.device import device_name, resolve_device
    from mitsuba2_tpu_torch.scene import shapes

    dev = resolve_device(args.device)
    T4 = mt.Transform4
    t0 = time.time()
    eta = 1.5
    th = np.arctan(eta)
    cam = T4.look_at(origin=[0, -3.0 * np.sin(th), 3.0 * np.cos(th)],
                     target=[0, 0, 0], up=[0, 0, 1])
    plate = shapes.rectangle(bsdf={"type": "dielectric", "int_ior": eta})
    scene = mt.build_scene(
        [plate], {"type": "perspective", "to_world": np.asarray(cam.matrix),
                  "fov": 25.0},
        emitters=[{"type": "constant", "radiance": [1.0] * 3}], device=dev)
    cfg = mt.RenderConfig(width=args.res, height=args.res, spp=args.spp,
                          spp_per_pass=min(args.spp, 64), polarized=True)
    s = mt.render_stokes(scene, cfg, device=dev)   # (H, W, 4)
    dolp = torch.sqrt(s[..., 1] ** 2 + s[..., 2] ** 2) / torch.clamp_min(
        s[..., 0], 1e-6)
    print(f"S0 mean {float(s[..., 0].mean()):.4f}; degree of linear "
          f"polarization max {float(dolp.max()):.3f} (about 1 at "
          f"Brewster's angle), mean {float(dolp.mean()):.3f}")
    s0 = s[..., 0:1].repeat(1, 1, 3).cpu().numpy()
    mt.write_bitmap(os.path.join(args.out_dir, "brewster_S0.exr"), s0)
    mt.write_bitmap(os.path.join(args.out_dir, "brewster_dolp.exr"),
                    dolp[..., None].repeat(1, 1, 3).cpu().numpy())

    def stack(theta):
        light = shapes.rectangle(
            bsdf={"type": "diffuse", "reflectance": [0, 0, 0]},
            emitter={"type": "area", "radiance": [2, 2, 2]}).transformed(
            np.asarray(T4.translate([0, 0, -1.0]).matrix))
        p1 = shapes.rectangle(bsdf={"type": "polarizer", "theta": 0.0}
                              ).transformed(
            np.asarray(T4.translate([0, 0, -0.4]).matrix))
        p2 = shapes.rectangle(bsdf={"type": "polarizer", "theta": theta}
                              ).transformed(
            np.asarray(T4.translate([0, 0, 0.2]).matrix))
        cam = T4.look_at(origin=[0, 0, 2.0], target=[0, 0, 0], up=[0, 1, 0])
        return mt.build_scene([light, p1, p2], {
            "type": "perspective", "to_world": np.asarray(cam.matrix),
            "fov": 20.0}, device=dev)

    cfgm = mt.RenderConfig(width=args.malus_res, height=args.malus_res,
                           spp=32, spp_per_pass=32, max_depth=6,
                           polarized=True)
    base, ratios = None, []
    for theta in (0.0, 30.0, 60.0, 90.0):
        img = mt.render_polarized(stack(theta), cfgm, device=dev)
        v = float(img[..., 0].mean())
        base = v if base is None else base
        ratios.append(v / base)
        print(f"polarizers at {theta:5.1f} deg: I/I0 = {v / base:.3f} "
              f"(Malus: {np.cos(np.deg2rad(theta)) ** 2:.3f})")
    print(f"in {time.time() - t0:.2f} s on {device_name(dev)}")
    RESULT.update(stokes=s, dolp=dolp, malus=ratios)


if __name__ == "__main__":
    main()
