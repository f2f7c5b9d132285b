"""Volumetric rendering on the PyTorch port (examples/volumetric_smoke.py's
workflow): a Gaussian-blob density grid written as a Mitsuba `.vol`
file, loaded back through the XML loader, rendered by the volumetric
path tracer (delta tracking and NEE, render/volpath.py).

Run: python examples/torch/volumetric_smoke.py [--res 128] [--spp 128]
     [--device cuda|cpu]
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
RESULT = {}
# the scene: a null-bounded cube of heterogeneous smoke under an area light
XML = """<scene version="2.0.0">
  <integrator type="volpath"><integer name="max_depth" value="8"/></integrator>
  <sensor type="perspective">
    <float name="fov" value="40"/>
    <transform name="to_world">
      <lookat origin="0 0 3.5" target="0 0 0" up="0 1 0"/>
    </transform>
    <film type="hdrfilm">
      <integer name="width" value="$res"/><integer name="height" value="$res"/>
    </film>
    <sampler type="independent"><integer name="sample_count" value="$spp"/></sampler>
  </sensor>
  <shape type="cube">
    <bsdf type="null"/>
    <medium type="heterogeneous" name="interior">
      <volume name="density" type="gridvolume">
        <string name="filename" value="$vol"/>
      </volume>
      <rgb name="albedo" value="0.9 0.9 0.9"/>
      <float name="scale" value="$scale"/>
      <phase type="hg"><float name="g" value="0.3"/></phase>
    </medium>
  </shape>
  <shape type="rectangle">
    <transform name="to_world">
      <scale value="1.6"/><rotate x="1" angle="90"/><translate y="2.2"/>
    </transform>
    <emitter type="area"><rgb name="radiance" value="6 6 6"/></emitter>
  </shape>
</scene>"""


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--spp", type=int, default=128)
    ap.add_argument("--out", default="smoke.exr")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    import mitsuba2_tpu_torch as mt
    from mitsuba2_tpu_torch.core.io_vol import write_vol
    from mitsuba2_tpu_torch.device import device_name, resolve_device

    dev = resolve_device(args.device)
    # a swirl of three Gaussian blobs
    n = 48
    z, y, x = (np.mgrid[0:n, 0:n, 0:n] / (n - 1)) * 2.0 - 1.0
    d = np.zeros((n, n, n), np.float32)
    for cx, cy, cz, s in ((-0.3, -0.2, 0.0, 8.0), (0.3, 0.1, 0.2, 10.0),
                          (0.0, 0.45, -0.2, 14.0)):
        d += np.exp(-s * ((x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2))
    with tempfile.TemporaryDirectory() as tmp:
        vol = os.path.join(tmp, "smoke.vol")
        write_vol(vol, d, bbox_min=[-1, -1, -1], bbox_max=[1, 1, 1])
        xml_path = os.path.join(tmp, "smoke.xml")
        with open(xml_path, "w") as f:
            f.write(XML)
        scene, config = mt.load_file(xml_path, device=dev, res=str(args.res),
                                     spp=str(args.spp), vol=vol,
                                     scale="6.0")
    t0 = time.time()
    img = mt.render(scene, config, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"rendered {args.res}^2 @ {args.spp}spp in {time.time() - t0:.2f} "
          f"s on {device_name(dev)}; mean {float(img.mean()):.4f}")
    mt.write_bitmap(args.out, img.cpu().numpy())
    print("wrote", args.out)
    RESULT["image"] = img


if __name__ == "__main__":
    main()
