"""Smoke-density recovery on the PyTorch port (examples/smoke_recovery.py's
workflow): render a target of a box of smoke with a known density blob,
restart the grid at a constant, and recover the blob by Adam through the
differentiable volumetric path tracer (the grid's gradient through the
differential tracking weight and the NEE transmittance).

Run: python examples/torch/smoke_recovery.py [--iterations 60]
     [--device cuda|cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
RESULT = {}
D, H, W = 1, 6, 6


def smoke_scene(density, device):
    """A thin box of smoke of grid `density` (D, H, W) in front of an
    emitting wall."""
    import numpy as np

    import mitsuba2_tpu_torch as mt
    from mitsuba2_tpu_torch.scene import shapes

    T4 = mt.Transform4
    cube = shapes.cube(bsdf={"type": "null"}, id="vol").transformed(
        np.asarray((T4.translate([0, 0, 0])
                    @ T4.scale([2.0, 2.0, 0.6])).matrix))
    cube.interior = {"type": "heterogeneous", "sigma_t": 1.2,
                     "albedo": 0.7, "density": np.asarray(density),
                     "bbox_min": [-2.0, -2.0, -0.6],
                     "bbox_max": [2.0, 2.0, 0.6]}
    wall = shapes.rectangle(
        bsdf={"type": "diffuse", "reflectance": [0, 0, 0]},
        emitter={"type": "area", "radiance": [3.0] * 3},
        id="wall").transformed(np.asarray(T4.translate([0, 0, -2.0]).matrix))
    cam = T4.look_at(origin=[0, 0, 4], target=[0, 0, 0], up=[0, 1, 0])
    return mt.build_scene([cube, wall], {
        "type": "perspective", "to_world": np.asarray(cam.matrix),
        "fov": 35.0}, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=60)
    ap.add_argument("--lr", type=float, default=0.06)
    ap.add_argument("--res", type=int, default=24)
    ap.add_argument("--spp", type=int, default=48)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    import mitsuba2_tpu_torch as mt
    from mitsuba2_tpu_torch.device import device_name, resolve_device
    from mitsuba2_tpu_torch.diff.optimizers import adam_init, adam_step

    dev = resolve_device(args.device)
    cfg = mt.RenderConfig(width=args.res, height=args.res, spp=args.spp,
                          spp_per_pass=args.spp, max_depth=3,
                          integrator="volpath")
    # the truth: a dense blob in an otherwise thin box
    yy, xx = np.meshgrid(np.linspace(-1, 1, H), np.linspace(-1, 1, W),
                         indexing="ij")
    blob = 0.15 + 1.1 * np.exp(-((yy + 0.3) ** 2 + (xx - 0.25) ** 2)
                               / 0.18).astype(np.float32)
    true_grid = np.broadcast_to(blob, (D, H, W)).astype(np.float32)
    target = mt.render(smoke_scene(true_grid, dev), cfg, seed=0, device=dev)
    print(f"target rendered (mean {float(target.mean()):.4f})")

    scene = smoke_scene(np.full((D, H, W), 0.5, np.float32), dev)
    params = {"med_grid": mt.diff_tables(scene)["med_grid"]}
    opt = adam_init(params)
    truth = torch.as_tensor(true_grid, device=dev)
    t0 = time.time()
    for it in range(args.iterations):
        _, loss, grads = mt.render_l2_grad(scene, cfg, target, seed=it,
                                           device=dev)
        lr = args.lr * (0.5 ** (it // 40))   # decay as MC noise takes over
        params, opt = adam_step(params, {"med_grid": grads["med_grid"]},
                                opt, lr)
        params["med_grid"] = torch.clamp_min(params["med_grid"], 0.0)
        scene = mt.with_tables(scene, {**mt.diff_tables(scene), **params})
        if it % 5 == 0 or it == args.iterations - 1:
            err = float((params["med_grid"] - truth).abs().mean())
            print(f"iter {it:3d}  loss {float(loss):.3e}  mean|grid err| "
                  f"{err:.3f}", flush=True)
    final_err = float((params["med_grid"] - truth).abs().mean())
    init_err = float(np.abs(0.5 - true_grid).mean())
    print(f"grid error: {init_err:.3f} (init) -> {final_err:.3f}; "
          f"{args.iterations} steps in {time.time() - t0:.2f} s on "
          f"{device_name(dev)}")
    RESULT.update(init_err=init_err, final_err=final_err,
                  grid=params["med_grid"])
    return init_err, final_err


if __name__ == "__main__":
    init_err, final_err = main()
    assert final_err < 0.8 * init_err, "density recovery did not converge"
    print("ok")
