#!/usr/bin/env python3
"""Tile width of the four warp-cooperative cluster walks (K1 and K2, K5's
closest and any hit) on one NVIDIA card.

    python3 chip_tiles.py

csrc/cluster_walk.cu's warp_visit holds TILE_J plane-row slots a lane in
registers (a tile of 32 * TILE_J slots a pass; INST_ANY_TILE_J on K5's
any hit). This builds the source with both widths set to 1, 2 and 4
(copies under mitsuba2_tpu_torch/_build/tiles/,
one nvcc each, started together) and prints each build's ptxas registers
and spills for the four kernels. It then renders mesh_gallery(subdiv=4)
and instanced_field(n=1024, subdiv=4) once at chip_smoke.py's config,
recording each wavefront of the path's closest-hit and any-hit kernels,
and on each wavefront holds every build against the plain twin
(bit-equal on every lane) and times it with chip_smoke.kernel_ms, the
builds in turns (4, 2, 1, 1, 2, 4). Exits non-zero when there is no CUDA
device or a build disagrees.
"""
import ctypes
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import chip_smoke as cs

TILE_JS = (1, 2, 4)
# the source's tile widths, each set to the build's TILE_J
WIDTHS = ("TILE_J", "INST_ANY_TILE_J")
# the four kernels with warp-cooperative visits, as ptxas names them
# (inst_ first: "cluster_any_hit_kernel" ends both any-hit names)
KERNELS = (("inst_cluster_closest_hit", "K5 closest"),
           ("inst_cluster_any_hit", "K5 any"),
           ("cluster_closest_hit", "K1"), ("cluster_any_hit", "K2"))
ORDER = (4, 2, 1, 1, 2, 4)
REPS = 10


def build(native, traverse):
    """Each TILE_J's library, loaded with the wrappers' C signatures."""
    csrc = os.path.dirname(traverse._SRC)
    src = open(traverse._SRC).read()
    lines = [ln for ln in src.splitlines() if any(
        ln.startswith(f"constexpr int {c} = ") for c in WIDTHS)]
    if len(lines) != len(WIDTHS):
        raise SystemExit("chip_tiles: no TILE_J lines in cluster_walk.cu")
    srcs = {}
    for tj in TILE_JS:
        d = os.path.join(native.BUILD_DIR, "tiles", f"tile{tj}")
        os.makedirs(d, exist_ok=True)
        out = src
        for ln in lines:
            out = out.replace(ln, f"{ln.split(' = ')[0]} = {tj};")
        with open(os.path.join(d, "cluster_walk.cu"), "w") as f:
            f.write(out)
        with open(os.path.join(d, "walk.cuh"), "w") as f:
            f.write(open(os.path.join(csrc, "walk.cuh")).read())
        srcs[tj] = (os.path.join(d, "cluster_walk.cu"),
                    (os.path.join(d, "walk.cuh"),))
    cmd = [traverse.nvcc_path()] + traverse.NVCC_FLAGS
    with ThreadPoolExecutor(len(srcs)) as pool:
        jobs = {tj: pool.submit(native.build_library, f"cluster_walk_t{tj}",
                                s, cmd, deps)
                for tj, (s, deps) in srcs.items()}
        libs = {tj: ctypes.CDLL(j.result()) for tj, j in jobs.items()}
    for tj, lib in libs.items():
        traverse._declare(lib)
        rep = (native.BUILD_LOG.get(f"cluster_walk_t{tj}") or "").splitlines()
        for i, ln in enumerate(rep):
            kern = next((k for name, k in KERNELS if "Compiling entry" in ln
                         and f"{name}_kernel" in ln), None)
            if kern is not None:
                info = [x.split("info    :")[-1].strip()
                        for x in rep[i + 1:i + 4]
                        if "registers" in x or "spill" in x]
                print(f"TILE_J={tj} {kern}: {' | '.join(info)}", flush=True)
    return libs


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_tiles: no CUDA device", file=sys.stderr)
        return 1
    import mitsuba2_tpu_torch as mt
    from mitsuba2_tpu_torch import native
    from mitsuba2_tpu_torch.kernels import traverse
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"
    print(card, flush=True)
    t0 = time.perf_counter()
    libs = build(native, traverse)
    print(f"built {len(libs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    dev = torch.device(cs.DEVICE)
    ok = True
    for path, make in (
            ("gallery", lambda: mt.mesh_gallery(subdiv=cs.SUBDIV,
                                                device=dev)),
            ("instanced", lambda: mt.instanced_field(**cs.FIELD,
                                                     device=dev))):
        scene = make()
        ks = cs.kernels_of(scene)
        record = []
        orig, rec = cs._recorders(traverse, record, ks)
        for k, f in rec.items():
            setattr(traverse, k, f)
        try:
            mt.render(scene, mt.RenderConfig(**cs.RENDER), seed=0)
        finally:
            for k, f in orig.items():
                setattr(traverse, k, f)
        torch.cuda.synchronize()
        tabs, extra = ks["tabs"], ks["extra"]
        inst = scene.has_instances
        # the C entries' sizes: (fuel, ck) instanced, (rows, ck) flat
        sizes = ((extra[1], extra[0]) if inst
                 else (scene.mxu_node_f.shape[0], extra[0]))
        means = {(nm, tj): [] for nm in (ks["closest"], ks["any"])
                 for tj in TILE_JS}
        for i, (name, rays) in enumerate(record):
            closest = name == ks["closest"]
            n = rays[0].numel()
            want = ks["closest_plain" if closest else "any_plain"](
                *tabs, *rays, *extra, chunk=ks["chunk"])
            want = want if closest else (want,)

            def run(lib):
                outs = ([torch.empty(n, device=dev)] + [
                    torch.empty(n, dtype=torch.int32, device=dev)
                    for _ in range(2 if inst else 1)] if closest else
                    [torch.empty(n, dtype=torch.bool, device=dev)])
                rc = getattr(lib, f"mts_{name}")(
                    *(a.data_ptr() for a in tabs),
                    *(a.data_ptr() for a in rays),
                    *(a.data_ptr() for a in outs), n, *sizes,
                    torch.cuda.current_stream(dev).cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"launch failed: CUDA error {rc}")
                return outs
            res = {tj: [] for tj in TILE_JS}
            for tj in ORDER:
                got = run(libs[tj])
                torch.cuda.synchronize()
                eq = all(torch.equal(a, b) for a, b in zip(got, want))
                ok &= eq
                res[tj].append(
                    (cs.kernel_ms(torch, lambda: run(libs[tj]), REPS), eq))
            for tj, v in res.items():
                means[name, tj] += [m for m, _ in v]
            print(f"{path} {name} launch {i}: {n} lanes, live "
                  f"{float((rays[6] > 0).float().mean()):.4f}: " + ", ".join(
                      f"TILE_J={tj} {[round(m, 4) for m, _ in v]} ms "
                      f"bit-equal {all(e for _, e in v)}"
                      for tj, v in res.items()), flush=True)
        for name in (ks["closest"], ks["any"]):
            print(f"{path} {name} on {card}: mean ms a launch " + ", ".join(
                f"TILE_J={tj} {sum(v) / len(v):.4f}"
                for (nm, tj), v in means.items() if nm == name), flush=True)
    if not ok:
        print("chip_tiles: a build disagrees with the twin", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
