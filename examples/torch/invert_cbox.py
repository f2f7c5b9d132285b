"""Inverse rendering on the PyTorch port (examples/invert_cbox.py's
workflow): render a target, perturb a wall albedo, recover it by Adam
through the pass-level adjoint (diff/adjoint.py).

Run: python examples/torch/invert_cbox.py [--iterations 30] [--lr 0.05]
     [--device cuda|cpu]
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
    ap.add_argument("--iterations", type=int, default=30)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    import torch

    import mitsuba2_tpu_torch as mt
    from mitsuba2_tpu_torch.device import device_name, resolve_device
    from mitsuba2_tpu_torch.diff.optimizers import adam_init, adam_step

    dev = resolve_device(args.device)
    config = mt.RenderConfig(width=args.res, height=args.res, spp=args.spp,
                             spp_per_pass=args.spp, max_depth=3, rr_depth=99)
    scene_gt = mt.cornell_box(device=dev)
    key = "left.bsdf.reflectance"
    target_value = mt.traverse(scene_gt)[key].clone()
    target = mt.render(scene_gt, config, seed=0, device=dev)
    print(f"optimizing {key!r}; true value {target_value.tolist()}")

    scene = mt.scene_with(scene_gt, {key: torch.full((3,), 0.6)})
    theta = mt.diff_tables(scene)
    state = adam_init(theta)
    t0 = time.time()
    for it in range(args.iterations):
        _, loss, grads = mt.render_l2_grad(scene, config, target,
                                           seed=it + 1, device=dev)
        theta, state = adam_step(theta, grads, state, lr=args.lr)
        scene = mt.with_tables(scene, theta)
        cur = mt.traverse(scene)[key]
        print(f"iter {it:3d} loss {float(loss):.6f} value "
              f"{[round(float(v), 4) for v in cur]}")
    err = float((mt.traverse(scene)[key] - target_value).abs().max())
    print(f"{args.iterations} steps in {time.time() - t0:.2f} s on "
          f"{device_name(dev)}; final abs error {err:.4f}")
    RESULT.update(error=err, loss=float(loss))
    return err


if __name__ == "__main__":
    err = main()
    assert err < 0.08, "optimization did not converge"
