"""Spectral rendering on the PyTorch port (examples/spectral_render.py's
workflow): the Cornell box in spectral mode against its rgb render, and
under a 2856 K blackbody light, which rgb cannot express.

Run: python examples/torch/spectral_render.py [--res 128] [--spp 128]
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
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--spp", type=int, default=128)
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    import mitsuba2_tpu_torch as mt
    from mitsuba2_tpu_torch.device import device_name, resolve_device

    dev = resolve_device(args.device)
    scene = mt.cornell_box(device=dev)
    base = mt.RenderConfig(width=args.res, height=args.res, spp=args.spp,
                           spp_per_pass=min(args.spp, 64), max_depth=4)
    t0 = time.time()
    img_rgb = mt.render(scene, base.replace(color_mode="rgb"), device=dev)
    img_spec = mt.render(scene, base.replace(color_mode="spectral"),
                         device=dev)
    print(f"rgb + spectral renders in {time.time() - t0:.2f} s on "
          f"{device_name(dev)}")
    rel = float((img_spec - img_rgb).abs().mean()
                / max(float(img_rgb.mean()), 1e-9))
    print(f"spectral vs rgb mean |diff| / mean = {rel:.3f} (small: "
          "srgb-upsampled reflectances round-trip)")
    warm = mt.cornell_box(light_radiance={"type": "blackbody",
                                          "temperature": 2856.0,
                                          "scale": 12.0}, device=dev)
    img_warm = mt.render(warm, base.replace(color_mode="spectral"),
                         device=dev)
    r, g, b = img_warm.reshape(-1, 3).mean(0).tolist()
    print(f"blackbody-lit balance r/g/b = {r:.3f}/{g:.3f}/{b:.3f} "
          "(warm: r > g > b)")
    for name, img in (("cbox_spectral.exr", img_spec),
                      ("cbox_tungsten.exr", img_warm)):
        mt.write_bitmap(os.path.join(args.out_dir, name), img.cpu().numpy())
    print(f"wrote cbox_spectral.exr, cbox_tungsten.exr in {args.out_dir}")
    RESULT.update(rgb=img_rgb, spectral=img_spec, warm=img_warm)


if __name__ == "__main__":
    main()
