"""Forward render times of two checkouts of the port, interleaved.

A smoke's median of 3 renders moves by 20-30% from one smoke to the next
(the host sets a render's time), so comparing two checkouts needs more
renders, taken in turns on one card:

    python3 chip_ab.py DIR_A DIR_B [--rounds 2] [--renders 15]

Each round starts one process per checkout, A, B, B, A. A process
imports mitsuba2_tpu_torch from its checkout (whose first use builds the
kernels there) and, for each of the gallery's three walk paths (the
cluster walks, set_backend("bvh8") and set_backend("bvh8mxu")), builds
mesh_gallery(subdiv=4) under that backend and times `--renders` forward
renders at chip_smoke.py's config (256x256, 16 spp, depth 3), each ended
by a synchronize, after a warm-up. Prints the card's `nvidia-smi` name
and power limit, each process's medians, and per path each checkout's
median over all its renders with the range of its processes' medians.
Needs a CUDA device.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

PATHS = {"gallery": "auto", "gallery_bvh8": "bvh8",
         "gallery_bvh8mxu": "bvh8mxu"}
RENDER = dict(width=256, height=256, spp=16, spp_per_pass=16, max_depth=3,
              rr_depth=8)


def child(root, renders):
    """One process: every path's render times (ms), as a JSON line."""
    sys.path.insert(0, root)
    import torch
    import mitsuba2_tpu_torch as mt
    from mitsuba2_tpu_torch.scene import scene as scene_mod
    cfg = mt.RenderConfig(**RENDER)
    out = {}
    for path, backend in PATHS.items():
        scene_mod.set_backend(backend)
        try:
            scene = mt.mesh_gallery(subdiv=4)
            mt.render(scene, cfg, seed=0)
            torch.cuda.synchronize()
            times = []
            for r in range(renders):
                t0 = time.perf_counter()
                mt.render(scene, cfg, seed=r + 1)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        finally:
            scene_mod.set_backend("auto")
        out[path] = times
        del scene
    print(json.dumps(out))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs="*")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--renders", type=int, default=15)
    ap.add_argument("--child")
    args = ap.parse_args()
    if args.child:
        child(os.path.abspath(args.child), args.renders)
        return 0
    if len(args.dirs) != 2:
        ap.error("give two checkouts")
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    a, b = (os.path.abspath(d) for d in args.dirs)
    times = {a: {p: [] for p in PATHS}, b: {p: [] for p in PATHS}}
    meds = {a: {p: [] for p in PATHS}, b: {p: [] for p in PATHS}}
    for rnd in range(args.rounds):
        for d in (a, b, b, a):
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", d,
                 "--renders", str(args.renders)],
                capture_output=True, text=True, cwd=d, timeout=900)
            if res.returncode:
                print(res.stderr[-3000:], file=sys.stderr)
                return 1
            got = json.loads(res.stdout.strip().splitlines()[-1])
            line = []
            for p, ts in got.items():
                times[d][p] += ts
                meds[d][p].append(statistics.median(ts))
                line.append(f"{p} {statistics.median(ts):.1f}")
            print(f"round {rnd} {d}: median ms " + ", ".join(line),
                  flush=True)
    for p in PATHS:
        print(f"{p}: " + "; ".join(
            f"{os.path.basename(d)} median {statistics.median(times[d][p]):.2f}"
            f" ms of {len(times[d][p])} renders (process medians "
            f"{min(meds[d][p]):.1f}-{max(meds[d][p]):.1f})" for d in (a, b)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
