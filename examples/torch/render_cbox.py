"""Forward rendering on the PyTorch port: the Cornell box preset at the
given quality, written as an EXR (examples/render_cbox.py's workflow).

Run: python examples/torch/render_cbox.py [--width 256] [--spp 256]
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
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--spp", type=int, default=256)
    ap.add_argument("--out", default="cbox.exr")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    import torch

    import mitsuba2_tpu_torch as mt
    from mitsuba2_tpu_torch.device import device_name, resolve_device

    dev = resolve_device(args.device)
    scene = mt.cornell_box(device=dev)
    config = mt.RenderConfig(width=args.width, height=args.width,
                             spp=args.spp, spp_per_pass=min(args.spp, 64),
                             max_depth=8, rr_depth=5)
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
