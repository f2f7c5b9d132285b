"""A frame is one image: `mitsuba2_tpu_torch.render` of the cell's scene
at the traffic's sizes, with a fresh seed each frame.

The check draws, from the run's seed, frames of the window and pixels of
each, and has the plain reference (gpubench/reference/) trace every lane
of those pixels from the frame's seed; the number compared is the
relative L1 gap of the program's pixels to the reference's."""
from __future__ import annotations

import torch

from gpubench.reference import pathtracer

from . import common


class Entry:
    metric = "render_mrays_per_s"

    def __init__(self, run):
        self.run = run
        self.t = run.traffic
        self.cfg = common.render_config(run.api, self.t)
        self.images = []   # (frame seed, image) of each window frame

    def _render(self, seed):
        with torch.profiler.record_function("gpubench.render"):
            return self.run.api.render(self.run.scene, self.cfg, seed=seed,
                                       device=self.run.device)

    def setup(self):
        for k in range(self.t["warmup_frames"]):
            self._render(self.run.seed_of("warmup", k))
            self.run.sync()

    def frame(self, k: int):
        seed = self.run.seed_of("frame", k)
        self.images.append((seed, self._render(seed)))

    def trace_extras(self) -> dict:
        return {}

    def release(self):
        self.run.scene = None

    def check(self, dtype=torch.float32):
        """[(name, value, limit)]: the image's relative L1 gap over the
        drawn pixels of the drawn frames."""
        run, t = self.run, self.t
        chk = t["check"]
        gen = torch.Generator().manual_seed(run.seed_of("check", 0))
        n_pix = t["width"] * t["height"]
        picks = torch.randperm(len(self.images), generator=gen)[:chk["frames"]]
        ref = pathtracer.build(run.spec, run.device, dtype)
        num = den = 0.0
        for f in picks.tolist():
            seed, img = self.images[f]
            pix = torch.randperm(n_pix, generator=gen)[:chk["pixels"]]
            pix = pix.to(run.device)
            want = pathtracer.render_pixels(ref, t, seed, pix).float()
            got = img.reshape(-1, 3)[pix].float()
            num += float((got - want).abs().sum())
            den += float(want.abs().sum())
        return [("image_rel_l1", num / max(den, 1e-30),
                 t["limits"]["image_rel_l1"])]
