"""Multi-process inverse rendering on the PyTorch port
(examples/multichip_train.py's workflow): each rank renders its share of
every pass's samples, the adjoint's gradients are all-reduced, and Adam
fits the Cornell box's wall albedos to a target render (dist/). A run
of N ranks draws the samples of one process (deterministic lane
offsets), so the result does not depend on N.

Run on one card (world 1):
    python examples/torch/multichip_train.py [--device cuda|cpu]
On N cards (one rank a card, NCCL):
    torchrun --nproc-per-node=N examples/torch/multichip_train.py
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
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: this rank's CUDA device)")
    args = ap.parse_args(argv)
    import mitsuba2_tpu_torch as mt
    from mitsuba2_tpu_torch.device import device_name
    from mitsuba2_tpu_torch.dist import multihost
    from mitsuba2_tpu_torch.dist.sharding import train_step_sharded

    # torchrun's environment makes a group; a bare run has none (world 1)
    multihost.initialize()
    mesh = multihost.pod_mesh(device=args.device)
    log = print if multihost.is_coordinator() else (lambda *a, **k: None)
    log(f"mesh: {mesh.size} rank(s) on {device_name(mesh.device)}")
    cfg = mt.RenderConfig(width=args.res, height=args.res, spp=args.spp,
                          spp_per_pass=args.spp, max_depth=3)
    target_scene = mt.cornell_box(device=mesh.device)
    # another seed than the training's: the target's noise is its own
    target = mt.render_sharded(target_scene, cfg.replace(seed=999), mesh)
    # a gray box: the slots' rgb columns reset, their other columns kept
    t = mt.diff_tables(target_scene)
    md = t["mat_data"].clone()
    md[:, 0:3] = 0.5
    start = mt.with_tables(target_scene, {**t, "mat_data": md})
    scene, opt_state = start, None
    t0 = time.time()
    for step in range(args.steps):
        scene, opt_state, loss, _ = train_step_sharded(
            scene, cfg, target, seed=step, mesh=mesh, opt_state=opt_state,
            lr=0.08)
        if step % 4 == 0 or step == args.steps - 1:
            log(f"step {step:3d}  loss {float(loss):.5f}")
    log(f"{args.steps} sharded adjoint steps in {time.time() - t0:.2f} s on "
        f"{device_name(mesh.device)}")
    truth = mt.diff_tables(target_scene)["mat_data"][:, :3]
    err0 = float((mt.diff_tables(start)["mat_data"][:, :3] - truth)
                 .abs().mean())
    err1 = float((mt.diff_tables(scene)["mat_data"][:, :3] - truth)
                 .abs().mean())
    log(f"albedo error: {err0:.3f} -> {err1:.3f} "
        f"({'recovered' if err1 < 0.3 * err0 else 'improving'})")
    RESULT.update(err0=err0, err1=err1, loss=float(loss))


if __name__ == "__main__":
    main()
