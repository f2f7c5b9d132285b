"""Shared-BLAS instancing on the PyTorch port (examples/instancing_field.py's
workflow): a field of N instances of one displaced blob, its geometry
stored once and walked by the instanced cluster kernels; prints the
memory ratio against the flattened build.

Run: python examples/torch/instancing_field.py [--n 64] [--subdiv 3]
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
    ap.add_argument("--n", type=int, default=64, help="instance count")
    ap.add_argument("--subdiv", type=int, default=3)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--out", default="instanced_field.exr")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    import torch

    import mitsuba2_tpu_torch as mt
    from mitsuba2_tpu_torch.device import device_name, resolve_device

    dev = resolve_device(args.device)
    scene = mt.instanced_field(n=args.n, subdiv=args.subdiv, device=dev)
    blob_tris = 20 * 4 ** args.subdiv
    effective = args.n * blob_tris + 2
    print(f"{args.n} instances x {blob_tris} tris: {scene.n_prims} stored "
          f"prims resolve {effective} effective "
          f"({effective / scene.n_prims:.1f}x; shared BLAS: "
          f"{scene.has_instances})")
    config = mt.RenderConfig(width=args.width, height=args.width,
                             spp=args.spp, spp_per_pass=min(args.spp, 16),
                             max_depth=3)
    t0 = time.time()
    img = mt.render(scene, config, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"rendered {args.width}x{args.width} spp={args.spp} in "
          f"{time.time() - t0:.2f} s on {device_name(dev)}")
    mt.write_bitmap(args.out, img.cpu().numpy())
    print(f"wrote {args.out}")
    RESULT["image"] = img


if __name__ == "__main__":
    main()
