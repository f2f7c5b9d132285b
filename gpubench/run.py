#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once and print its result line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the CUDA devices the cell
asks for; without them it exits 2 and prints no result. A run

1. sets up: builds the cell's scene (gpubench/scenes/) with the program's
   `build_scene`, and has the cell's entry (gpubench/entries/) warm up
   every shape the window uses; the first run of a checkout also builds
   the program's CUDA library (into mitsuba2_tpu_torch/_build/);
2. measures a closed loop of frames (an image, or a gradient step), each
   with its own seed and each waited for, until --seconds have passed;
   with --trace 1 the first frames run under torch.profiler;
3. reads the peak memory, frees the program's state, and has the plain
   reference (gpubench/reference/) judge the frames' outputs;
4. refuses to print if JAX or the JAX package was loaded, else prints the
   numbers compared as its last lines on standard error and one JSON
   object as the last line of standard output.

With --trace 0 the metrics are the cell's end-to-end metrics; with
--trace 1 its per-layer metrics (gpubench/metrics/<name>.py), the
device's busy and window seconds, and a breakdown of the traced frames.
The harness's spans of a traced run go to gpubench_out/.
"""
import time

T0 = time.monotonic()

import argparse  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from gpubench import manifest  # noqa: E402

# loaded by the process that prints a result, none of these may be
FORBIDDEN = ("jax", "jaxlib", "flax", "mitsuba2_tpu")
# frames of a traced run that run under the profiler
TRACED_FRAMES = 2


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


class Run:
    """One run's state, as the entries and metric readers see it."""

    def __init__(self, api, torch, device, cell, config, traffic, seed):
        self.api, self.torch, self.device = api, torch, device
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed = int(seed)
        self.spec = self.scene = None

    def seed_of(self, tag: str, k: int) -> int:
        """A 32-bit seed for the k-th draw of kind `tag`, from --seed."""
        h = hashlib.blake2b(f"{self.seed}/{tag}/{k}".encode(), digest_size=4)
        return int.from_bytes(h.digest(), "little")

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    @staticmethod
    def clock() -> float:
        return time.perf_counter()


def run_cell(bench, cell, seed, seconds, trace, device, t0, traffic=None,
             api=None):
    """Set up, measure and check one cell on `device`; returns the result
    dict (without the forbidden-module test, which the caller makes).
    `traffic` and `api` replace the cell's traffic file and the program's
    entry points (the benchmark's own tests)."""
    import torch

    import mitsuba2_tpu_torch as mt
    from gpubench import profile as prof_mod
    from gpubench import raycount
    from gpubench.entries import common

    device = torch.device(device)
    cfg = manifest.config(cell["config"])
    traffic = traffic or manifest.traffic(cell["traffic"])
    e2e, per_layer = manifest.cell_metrics(bench, cell["name"])
    run = Run(api or common.program_api(mt), torch, device, cell, cfg,
              traffic, seed)
    rec = torch.profiler.record_function

    # ---- set-up ------------------------------------------------------------
    tb = time.perf_counter()
    run.spec = manifest.scene_spec(cfg)
    run.scene = common.program_scene(run.api, run.spec, device)
    run.sync()
    scene_build_s = time.perf_counter() - tb
    entry = manifest.entry(traffic["entry"]).Entry(run)
    entry.setup()
    run.sync()
    setup_s = time.monotonic() - t0
    cuda = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    # ---- the window: a closed loop of frames --------------------------------
    spans, tr, frames = [], None, 0

    def one_frame():
        nonlocal frames
        s = time.perf_counter()
        with rec("gpubench.frame"):
            entry.frame(frames)
            run.sync()
        spans.append(["frame", frames, s, time.perf_counter()])
        frames += 1

    w0 = time.perf_counter()
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        with profile(activities=acts) as prof:
            with rec(prof_mod.WINDOW):
                for _ in range(TRACED_FRAMES):
                    one_frame()
    while frames == 0 or time.perf_counter() - w0 < seconds:
        one_frame()
    run.sync()
    window_s = time.perf_counter() - w0
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    rays = raycount.rays_per_frame(traffic)

    metrics = {}
    for m in e2e:
        if m["name"] == "setup_s":
            metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
        elif m["name"] == entry.metric:
            metrics[m["name"]] = {"value": frames * rays / window_s / 1e6,
                                  "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else device.type,
                "kind": (torch.cuda.get_device_name(device) if cuda
                         else device.type),
                "count": 1, "memory_peak_bytes": max(setup_peak,
                                                     window_peak)}
    if trace:
        tr = prof_mod.collect(prof, TRACED_FRAMES)
        extra = entry.trace_extras()
        # what a per-layer metric's reader reads
        ctx = types.SimpleNamespace(
            trace=tr, traffic=traffic, config=cfg, entry=traffic["entry"],
            n_prims=sum(len(s["faces"]) for s in run.spec["shapes"]),
            window_peak_bytes=window_peak, scene_build_s=scene_build_s,
            extra=extra)
        metrics = {}
        for m in per_layer:
            v = manifest.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev_info.update(busy_s=prof_mod.busy_s(tr), window_s=tr.window_s)
        write_spans(cell["name"], seed, spans, tr)

    # ---- the check ---------------------------------------------------------
    entry.release()
    if cuda:
        torch.cuda.empty_cache()
    tc = time.perf_counter()
    checks = entry.check()
    print(f"gpubench: {cell['name']}: set-up {setup_s:.3f} s, window "
          f"{window_s:.3f} s ({frames} frames), check "
          f"{time.perf_counter() - tc:.3f} s", file=sys.stderr)
    correct = all(v == v and v <= lim for _, v, lim in checks)
    # the check judges the window's frames together: a run that is not
    # correct counts each of them failed
    out = {"correct": correct, "attempted": frames,
           "failed": 0 if correct else frames, "metrics": metrics,
           "device": dev_info}
    if trace:
        out["breakdown"] = {"device_ops": prof_mod.top_ops(tr),
                            "idle_gaps": prof_mod.idle_gaps(tr)}
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return out


def write_spans(cell: str, seed: int, spans, tr):
    """The harness's spans of a traced run, to gpubench_out/."""
    out = os.path.join(ROOT, "gpubench_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"{cell}-{seed}-spans.json"), "w") as f:
        json.dump({"frames": spans,
                   "traced_window_ns": list(tr.window),
                   "host_spans": [c for c in tr.cpu
                                  if c[0].startswith("gpubench.")]}, f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = manifest.benchmark()
    cell = manifest.cell(bench, args.workload)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"gpubench: cell {cell['name']} needs {cell['chips']} CUDA "
              f"device(s); {torch.cuda.device_count()} available",
              file=sys.stderr)
        return 2
    out = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                   "cuda:0", T0)
    bad = forbidden_modules()
    if bad:
        print("gpubench: the process loaded " + ", ".join(bad),
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
