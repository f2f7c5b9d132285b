"""The neural shadow oracle on the PyTorch port
(examples/neural_occlusion.py's workflow): train a small per-scene MLP
against the exact any-hit test (render/nif.py), then render with it; the
shadow queries become dense matrix products, at a measured error. It is
off unless attached:

    scene = dataclasses.replace(scene, shadow_nif=mt.train_shadow_nif(scene))

Run: python examples/torch/neural_occlusion.py [--steps 3000] [--res 64]
     [--spp 64] [--device cuda|cpu] [--out-dir .]
"""
import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
RESULT = {}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--dataset-size", type=int, default=262144)
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    import torch

    import mitsuba2_tpu_torch as mt
    from mitsuba2_tpu_torch.device import device_name, resolve_device
    from mitsuba2_tpu_torch.render.nif import accuracy

    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    scene = mt.cornell_box(device=dev)
    t0 = time.time()
    nif = mt.train_shadow_nif(scene, steps=args.steps,
                              dataset_size=args.dataset_size)
    sync()
    acc = accuracy(nif, scene)
    print(f"trained {args.steps} steps in {time.time() - t0:.2f} s on "
          f"{device_name(dev)}; held-out agreement with the exact test: "
          f"{acc:.1%}")
    cfg = mt.RenderConfig(width=args.res, height=args.res, spp=args.spp,
                          spp_per_pass=min(args.spp, 64), max_depth=4,
                          rr_depth=99)
    t0 = time.time()
    exact = mt.render(scene, cfg, device=dev)
    sync()
    t_exact = time.time() - t0
    t0 = time.time()
    approx = mt.render(dataclasses.replace(scene, shadow_nif=nif), cfg,
                       device=dev)
    sync()
    t_nif = time.time() - t0
    rel = float((approx - exact).abs().mean() / exact.mean())
    print(f"render: exact {t_exact:.2f} s, neural shadows {t_nif:.2f} s, "
          f"relative L1 error {rel:.1%}")
    mt.write_bitmap(os.path.join(args.out_dir, "cbox_nif.exr"),
                    approx.cpu().numpy())
    mt.write_bitmap(os.path.join(args.out_dir, "cbox_nif_diff.exr"),
                    (approx - exact).abs().cpu().numpy())
    print(f"wrote cbox_nif.exr, cbox_nif_diff.exr in {args.out_dir}")
    RESULT.update(accuracy=acc, rel_l1=rel, image=approx)


if __name__ == "__main__":
    main()
