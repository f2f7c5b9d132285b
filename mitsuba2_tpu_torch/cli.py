"""Command-line renderer: the `mitsuba` binary of the port.

    python -m mitsuba2_tpu_torch scene.xml -o out.pfm -D spp=64 -m rgb

The JAX package's flags: `-o` output (exr/pfm/hdr/png/...; default the
scene's name with .exr), `-D key=value` XML parameter substitution, `-m`
the variant, `-s` samples per pixel, `--sensor` the <sensor> to render,
`-a NAME` an AOV image written beside the output as `_<NAME>.exr`
(repeatable), `-v` verbose; and `--device` (default cuda), the
counterpart of the JAX CLI's JAX_PLATFORMS=cpu: without a CUDA device
and without `--device cpu` it exits non-zero. An aov integrator's AOVs
and the moment integrator's variance are written as sidecars too
(`_<name>.exr`, `_variance.exr`). A `_polarized` variant renders the full
polarized transport (render/stokes.py::render_polarized): the image is
S0 and `_s1.exr`, `_s2.exr`, `_s3.exr` hold the other Stokes components;
the stokes integrator writes its S0 and the same three sidecars. The
`_double` variants raise NotImplementedError by name.
"""
from __future__ import annotations

import argparse
import logging
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="mitsuba2_tpu_torch",
        description="Differentiable renderer on CUDA (Mitsuba 2 rebuild)")
    ap.add_argument("scene", help="scene file (.xml)")
    ap.add_argument("-o", "--output", default=None,
                    help="output image (exr/pfm/png/...; default: scene "
                         "name .exr)")
    ap.add_argument("-D", "--define", action="append", default=[],
                    metavar="key=value", help="XML $parameter substitution")
    ap.add_argument("-m", "--mode", default=None,
                    metavar="{mono,rgb,spectral}[_polarized][_double]",
                    help="variant string, e.g. rgb or spectral")
    ap.add_argument("-s", "--spp", type=int, default=None,
                    help="override samples per pixel")
    ap.add_argument("-a", "--aov", action="append", default=[],
                    help="also write AOV images (depth, sh_normal, ...)")
    ap.add_argument("--sensor", type=int, default=0,
                    help="render the Nth <sensor> of the scene (default 0)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    from .config import parse_variant
    if args.mode is not None:
        try:
            parse_variant(args.mode)
        except ValueError as e:
            ap.error(str(e))

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname).1s %(message)s")
    log = logging.getLogger("mitsuba2_tpu_torch")

    from .device import resolve_device
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.exit(1, f"{ap.prog}: {e} (--device cpu renders on the CPU)\n")

    import torch

    from .core import io_bitmap
    from .kernels import traverse
    from .render.integrators import render_any, render_aovs
    from .render.stokes import render_polarized
    from .scene import loader

    params = {}
    for d in args.define:
        k, _, v = d.partition("=")
        params[k] = v

    t0 = time.time()
    scene, config = loader.load_file(args.scene, sensor_index=args.sensor,
                                     device=device, **params)
    log.info("loaded %s (%d prims) in %.2fs", args.scene, scene.n_prims,
             time.time() - t0)
    if args.mode:
        config = config.replace(**parse_variant(args.mode))
    if args.spp:
        config = config.replace(spp=args.spp,
                                spp_per_pass=min(config.spp_per_pass, args.spp))

    log.info("rendering %dx%d spp=%d depth=%d mode=%s on %s",
             config.width, config.height, config.spp, config.max_depth,
             config.color_mode, device)
    before = traverse.launch_counts()
    t0 = time.time()
    sidecars = {}   # suffix -> image, written beside the main output
    if config.polarized and config.integrator != "stokes":
        # the full polarized transport: S0 the image, S1-S3 beside it
        stokes = render_polarized(scene, config, device=device)
        img = stokes[..., 0]
        sidecars.update({f"s{i}": stokes[..., i] for i in (1, 2, 3)})
    else:
        out_any = render_any(scene, config, device=device)
        if isinstance(out_any, dict):          # aov integrator
            img = out_any.pop("image")
            sidecars.update(out_any)
        elif isinstance(out_any, tuple):       # moment: (mean, variance)
            img, sidecars["variance"] = out_any
        elif config.integrator == "stokes":    # (H, W, 4): S0, S1-S3
            img = out_any[..., 0:1]
            sidecars.update({f"s{i}": out_any[..., i:i + 1]
                             for i in (1, 2, 3)})
        else:
            img = out_any
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    n_rays = config.width * config.height * config.spp * \
        (1 + 2 * (config.max_depth - 1))
    log.info("rendered in %.2fs (%.2f Mrays/s incl. kernel builds)", dt,
             n_rays / dt / 1e6)
    launched = {k: n - before[k] for k, n in traverse.launch_counts().items()
                if n > before[k]}
    log.info("kernel launches: %s", launched)

    out = args.output or (args.scene.rsplit(".", 1)[0] + ".exr")
    io_bitmap.write(out, img.float().cpu().numpy())
    log.info("wrote %s", out)
    for aov in args.aov:
        sidecars[aov] = render_aovs(scene, config, (aov,),
                                    device=device)[aov]
    for suffix, arr in sidecars.items():
        path = out.rsplit(".", 1)[0] + f"_{suffix}.exr"
        io_bitmap.write_exr(path, arr.float().cpu().numpy())
        log.info("wrote %s", path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
