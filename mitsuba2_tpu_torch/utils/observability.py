"""Per-pass metrics and progress of a render (counterpart of
utils/observability.py).

- `RenderMonitor`: one JSONL record a pass (wall time, Mrays/s, the
  share of lanes still alive after each bounce: what compaction would
  pack, and the time left) and a progress line on stderr, written by the
  coordinator rank alone.
- `render_instrumented`: render() pass by pass through a monitor, with
  a cancel checked between passes (Integrator::cancel): a cancelled
  render returns the passes done so far, developed.
"""
from __future__ import annotations

import json
import sys
import time
from typing import Optional

import torch

from ..config import RenderConfig
from ..device import resolve_device


class RenderMonitor:
    """ProgressReporter and a JSONL metrics sink. `is_host0` None: the
    coordinator rank of the process group (dist.multihost)."""

    def __init__(self, total_passes: int, jsonl_path: Optional[str] = None,
                 stream=None, is_host0: bool = None):
        if is_host0 is None:
            from ..dist.multihost import is_coordinator
            is_host0 = is_coordinator()
        self.total = total_passes
        self.jsonl_path = jsonl_path
        self.stream = stream if stream is not None else sys.stderr
        self.is_host0 = is_host0
        self.t_start = time.perf_counter()
        self.records = []
        self.cancelled = False

    def update(self, pass_idx: int, wall_s: float, rays: int,
               occupancy=None, extra: dict = None):
        done = pass_idx + 1
        elapsed = time.perf_counter() - self.t_start
        eta = elapsed / done * (self.total - done)
        rec = {"pass": pass_idx, "wall_s": round(wall_s, 4),
               "mrays_s": round(rays / max(wall_s, 1e-9) / 1e6, 3),
               "eta_s": round(eta, 3)}
        if occupancy is not None:
            rec["occupancy"] = [round(float(o), 4) for o in occupancy]
        if extra:
            rec.update(extra)
        self.records.append(rec)
        if not self.is_host0:
            return
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        self.stream.write(f"\rrender {done}/{self.total} passes "
                          f"[{rec['mrays_s']:.1f} Mrays/s, eta {eta:.1f}s] ")
        if done == self.total:
            self.stream.write("\n")
        self.stream.flush()


def _pass_with_stats(scene, config: RenderConfig, seed: int, dev):
    """One render pass that also returns the share of live lanes after
    the first hit and after each bounce, (max_depth,). Its own set-up,
    as the JAX package's: the independent sampler, no crop, no aperture,
    shutter or wavelength draw."""
    from ..core.spec import Spec
    from ..kernels import compact as compact_mod
    from ..render import emitters, film as film_mod, sensors
    from ..render import integrators as integ
    from ..render.sampler import Sampler
    from ..scene import scene as scene_mod

    H, W = config.height, config.width
    n = config.spp_per_pass * H * W
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    sampler = Sampler.seed(int(seed) & integ.M32, lane)
    pix = lane % (H * W)
    jitter, sampler = sampler.next_2d()
    uv = sensors.film_uv((pix % W).to(torch.float32),
                         (pix // W).to(torch.float32), jitter, W, H)
    ray = sensors.sample_ray(scene, uv)
    si = scene_mod.ray_intersect(scene, ray, sort=False)
    result = Spec.zeros(n, config.n_channels, dev)
    if not config.hide_emitters:
        result = result + emitters.eval_hit(scene, si, config)
        result = result + emitters.eval_env(
            scene, ray.d, ray.wavelengths, config).masked(~si.valid)
    occupancy = [si.valid.float().mean()]
    carry = (si, si.valid, Spec.ones(n, config.n_channels, dev), result,
             sampler, lane)
    for depth in range(1, config.max_depth):
        carry = integ._path_bounce(scene, config, depth, carry)
        occupancy.append(carry[1].float().mean())
    result = carry[3]
    if config.compact:
        result = compact_mod.unsort(result, carry[5])
    image = torch.zeros((H, W, config.n_image_channels), dtype=torch.float32,
                        device=dev)
    image, wsum = film_mod.accumulate_pass(
        image, film_mod.zero_weight(config, dev), result, jitter, config)
    return image, wsum, torch.stack(occupancy)


def render_instrumented(scene, config: RenderConfig, seed: int = None,
                        jsonl_path: Optional[str] = None,
                        monitor: Optional[RenderMonitor] = None,
                        cancel=None, device=None):
    """render() with per-pass metrics, on `device` (None = the CUDA
    device; raises without one). Returns (image, monitor).

    `cancel`: a zero-argument callable or a threading.Event, checked
    before each pass; once it is true the render stops and returns the
    passes done so far, developed (monitor.cancelled is then True)."""
    from ..render import film as film_mod
    from ..render.integrators import _passes, _tape, pass_seeds
    from ..scene.scene import to_device
    dev = resolve_device(device)
    scene = to_device(scene, dev)
    if seed is None:
        seed = config.seed
    config, n_passes = _passes(config)
    if monitor is None:
        monitor = RenderMonitor(n_passes, jsonl_path=jsonl_path)
    lanes = config.spp_per_pass * config.width * config.height
    rays = lanes * (1 + 2 * (config.max_depth - 1))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    image = wsum = None
    with _tape(scene):
        for p, s in enumerate(pass_seeds(seed, n_passes)):
            if cancel is not None and (
                    cancel.is_set() if hasattr(cancel, "is_set")
                    else cancel()):
                monitor.cancelled = True
                break
            sync()
            t0 = time.perf_counter()
            img_p, w_p, occ = _pass_with_stats(scene, config, s, dev)
            sync()
            monitor.update(p, time.perf_counter() - t0, rays,
                           occupancy=occ.tolist())
            image = img_p if image is None else image + img_p
            wsum = w_p if wsum is None else wsum + w_p
    if image is None:
        raise RuntimeError("render cancelled before the first pass")
    return film_mod.develop(image, wsum), monitor
