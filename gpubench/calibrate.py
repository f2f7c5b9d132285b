#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the chip, in one
process: for each seed the program's numbers against the reference (the
lower reading is their largest), on the first --control seeds the
control's (the reference in bfloat16 in the program's place, one step
below the configuration's float32; the upper reading is their
smallest), and on the first --faults seeds each fault of faults.py
planted under the timed path.

    python3 gpubench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control 3] [--faults 3] [--fault NAME ...] [--frames 2]

Each seed's set-up and frames are a run's (entries/<entry>.py); the
window is its first --frames frames (at least one: a grad cell's check
judges one of them). Prints a JSON line a reading and a
summary last. The benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from gpubench import faults, manifest  # noqa: E402
from gpubench.run import Run  # noqa: E402


def readings(cell, seeds, n_control, n_faults, frames, device, traffic=None,
             only=None):
    """[{"seed", "kind", "checks": {name: value}, "seconds"}], kind one of
    "sound", "control", "fault:<name>"."""
    import torch

    import mitsuba2_tpu_torch as mt
    from gpubench.entries import common
    device = torch.device(device)
    api = common.program_api(mt)
    cfg = manifest.config(cell["config"])
    traffic = traffic or manifest.traffic(cell["traffic"])
    spec = manifest.scene_spec(cfg)
    scene = common.program_scene(api, spec, device)
    Entry = manifest.entry(traffic["entry"]).Entry
    out = []

    def one(seed, kind, api_, dtype=torch.float32, entry=None):
        t0 = time.perf_counter()
        if entry is None:
            run = Run(api_, torch, device, cell, cfg, traffic, seed)
            run.spec, run.scene = spec, scene
            entry = Entry(run)
            entry.setup()
            for k in range(frames):
                entry.frame(k)
            run.sync()
            entry.release()
        try:
            checks = {n: v for n, v, _ in entry.check(dtype)}
        except Exception as e:   # a control that crashes has failed
            checks = {"crashed": repr(e)[:200]}
        rec = {"seed": seed, "kind": kind, "checks": checks,
               "seconds": time.perf_counter() - t0,
               "diag": getattr(entry, "diag", None)}
        print(json.dumps(rec), flush=True)
        out.append(rec)
        return entry

    for i, seed in enumerate(seeds):
        entry = one(seed, "sound", api)
        if i < n_control:
            one(seed, "control", api, torch.bfloat16, entry)
        if i < n_faults:
            for name, plant in faults.FAULTS[traffic["entry"]].items():
                if only is None or name in only:
                    one(seed, "fault:" + name, plant(api))
    return out


def summary(recs):
    """{kind: {check: (min, max)}} over the readings."""
    s = {}
    for r in recs:
        for n, v in r["checks"].items():
            if isinstance(v, float):
                lo, hi = s.setdefault(r["kind"], {}).get(n, (v, v))
                s[r["kind"]][n] = (min(lo, v), max(hi, v))
    return s


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--fault", action="append",
                    help="read only these faults (default: all)")
    args = ap.parse_args(argv)
    if args.frames < 1:
        ap.error("--frames must be at least 1")
    cell = manifest.cell(manifest.benchmark(), args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    recs = readings(cell, seeds, args.control, args.faults, args.frames,
                    "cuda:0", only=args.fault)
    print(json.dumps({"workload": args.workload,
                      "summary": summary(recs)}), flush=True)


if __name__ == "__main__":
    main()
