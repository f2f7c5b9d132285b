#!/usr/bin/env python3
"""Tile width of the six warp-cooperative cluster walks (K1 and K2, K5's
and K7's closest and any hit), rays a thread of the dense sweep (K8) and
the round length of K4's and K6's closest hit, on one NVIDIA card.

    python3 chip_tiles.py [gallery] [instanced] [gallery_bvh8mxu]
                          [gallery_dense] [spheres_instanced]
                          [gallery_bvh8]

csrc/cluster_walk.cu's warp_visit holds TILE_J plane-row slots a lane in
registers (a tile of 32 * TILE_J slots a pass; INST_ANY_TILE_J on K5's
any hit, BVH8C_TILE_J on K7), each thread of dense_sweep tests
DENSE_RAYS rays on each slot's rows it loads, and a lane of K4's (K6's)
closest hit walks up to BVH_ROUND_STEPS (BVH8_ROUND_STEPS) steps a round
before its warp tests the round's leaves (warp_leaf_visit). This builds
the source with the four tile constants set to 1, 2 and 4, and with the
two round lengths set to (1, 4, 8, 16) and (1, 2, 4, 8) (the constants
of a build touch different kernels, so one build serves every sweep;
copies under mitsuba2_tpu_torch/_build/tiles/, one nvcc each, started
together) and prints each build's ptxas registers and spills for the ten
kernels and K3's and K6's any hits. It then renders the named paths (all
six by default) once at chip_smoke.py's config: mesh_gallery(subdiv=4)
(K1, K2), instanced_field(n=1024, subdiv=4) (K5), the gallery under
set_backend("bvh8mxu") (K7), with the dense switch on (K8) and under
set_backend("bvh8") (K6), and chip_smoke's sphere field at n=1024,
shared (K4), recording each wavefront of the path's closest-hit and
any-hit kernels, and on each wavefront holds every build of the path's
constant against the plain twin (bit-equal on every lane) and times it
with chip_smoke.kernel_ms, the builds in turns (largest value first,
then back). Exits non-zero when there is no CUDA device or a build
disagrees.
"""
import ctypes
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import chip_smoke as cs

# the builds: each sets the source's constants to its values
TILE_CONSTANTS = ("TILE_J", "INST_ANY_TILE_J", "BVH8C_TILE_J", "DENSE_RAYS")
ROUNDS = {"BVH_ROUND_STEPS": (1, 4, 8, 16), "BVH8_ROUND_STEPS": (1, 2, 4, 8)}
BUILDS = {**{f"tile{v}": {c: v for c in TILE_CONSTANTS} for v in (1, 2, 4)},
          **{f"round{i}": {c: vs[i] for c, vs in ROUNDS.items()}
             for i in range(4)}}
# the kernels each sweep varies, and the two per-thread any hits, which
# none does (their registers beside the others'), by their names in the
# ptxas report
KERNELS = (("inst_cluster_closest_hit", "K5 closest"),
           ("inst_cluster_any_hit", "K5 any"),
           ("cluster_closest_hit", "K1"), ("cluster_any_hit", "K2"),
           ("bvh8mxu_closest_hit", "K7 closest"),
           ("bvh8mxu_any_hit", "K7 any"),
           ("dense_closest_hit", "K8 closest"), ("dense_any_hit", "K8 any"),
           ("inst_bvh_closest_hit", "K4 closest"),
           ("bvh8_closest_hit", "K6 closest"),
           ("bvh_any_hit", "K3 any"), ("bvh8_any_hit", "K6 any"))
# each path's constant, as the lines name a build
KNOB = {"gallery": "TILE_J", "instanced": "TILE_J",
        "gallery_bvh8mxu": "BVH8C_TILE_J", "gallery_dense": "DENSE_RAYS",
        "spheres_instanced": "BVH_ROUND_STEPS",
        "gallery_bvh8": "BVH8_ROUND_STEPS"}
REPS = 10


def build(native, traverse):
    """Each value's library, loaded with the wrappers' C signatures."""
    csrc = os.path.dirname(traverse._SRC)
    src = open(traverse._SRC).read()
    srcs = {}
    for b, values in BUILDS.items():
        d = os.path.join(native.BUILD_DIR, "tiles", b)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "cluster_walk.cu"), "w") as f:
            f.write(traverse.with_constants(src, **values))
        with open(os.path.join(d, "walk.cuh"), "w") as f:
            f.write(open(os.path.join(csrc, "walk.cuh")).read())
        srcs[b] = (os.path.join(d, "cluster_walk.cu"),
                   (os.path.join(d, "walk.cuh"),))
    cmd = [traverse.nvcc_path()] + traverse.NVCC_FLAGS
    with ThreadPoolExecutor(len(srcs)) as pool:
        jobs = {b: pool.submit(native.build_library, f"cluster_walk_{b}",
                               s, cmd, deps)
                for b, (s, deps) in srcs.items()}
        libs = {b: ctypes.CDLL(j.result()) for b, j in jobs.items()}
    for b, lib in libs.items():
        traverse._declare(lib)
        label = ", ".join(f"{c}={v}" for c, v in BUILDS[b].items())
        rep = (native.BUILD_LOG.get(f"cluster_walk_{b}") or "").splitlines()
        for i, ln in enumerate(rep):
            # the mangled name: its length, then the name
            kern = next((k for name, k in KERNELS if "Compiling entry" in ln
                         and f"{len(name) + 7}{name}_kernel" in ln), None)
            if kern is not None:
                info = [x.split("info    :")[-1].strip()
                        for x in rep[i + 1:i + 4]
                        if "registers" in x or "spill" in x]
                print(f"{b} ({label}) {kern}: {' | '.join(info)}",
                      flush=True)
    return libs


def main(paths):
    import torch
    if not torch.cuda.is_available():
        print("chip_tiles: no CUDA device", file=sys.stderr)
        return 1
    unknown = set(paths) - set(KNOB)
    if unknown:
        print(f"chip_tiles: unknown paths {sorted(unknown)}; one of "
              f"{sorted(KNOB)}", file=sys.stderr)
        return 2
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

    def gallery():
        return mt.mesh_gallery(subdiv=cs.SUBDIV, device=dev)
    make = {"gallery": gallery, "gallery_bvh8mxu": gallery,
            "gallery_dense": gallery, "gallery_bvh8": gallery,
            "instanced": lambda: mt.instanced_field(**cs.FIELD, device=dev),
            "spheres_instanced": lambda: cs.sphere_field(
                mt, device=dev, **cs.SPHERE_FIELDS["spheres_instanced"])}
    ok = True
    for path in paths or KNOB:
        with cs.path_switches(path):
            ok &= sweep(torch, mt, traverse, path, make[path](), libs, card,
                        dev)
    if not ok:
        print("chip_tiles: a build disagrees with the twin", file=sys.stderr)
        return 1
    return 0


def sweep(torch, mt, traverse, path, scene, libs, card, dev):
    """One path's wavefronts, each build against the twin and timed;
    returns whether every build agreed on every lane."""
    knob = KNOB[path]
    # the path's builds by their value of its constant
    builds = dict(sorted((BUILDS[b][knob], lib) for b, lib in libs.items()
                         if knob in BUILDS[b]))
    values = list(builds)
    order = values[::-1] + values
    reps = cs.PATH_REPS.get(path, REPS)
    ks = cs.kernels_of(scene, cs.BACKEND.get(path, "auto"))
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
    # the C entries' sizes: the step cap alone on the BVH2 and BVH8
    # walks over prims (extra: fuel, or stack and fuel), (fuel, ck)
    # instanced and on the BVH8 walk (extra: ck, stack, fuel), (clusters,
    # ck) dense, (rows, ck) on the flat walk
    sizes = ((extra[-1],) if ks["uv"]
             else (extra[1], extra[0]) if inst
             else (extra[2], extra[0]) if path == "gallery_bvh8mxu"
             else (scene.mxu_ccs.shape[0], extra[0]) if path == "gallery_dense"
             else (scene.mxu_node_f.shape[0], extra[0]))
    means = {(nm, v): [] for nm in (ks["closest"], ks["any"])
             for v in values}
    ok = True
    for i, (name, rays) in enumerate(record):
        closest = name == ks["closest"]
        n = rays[0].numel()
        want = ks["closest_plain" if closest else "any_plain"](
            *tabs, *rays, *extra, chunk=ks["chunk"])
        want = want if closest else (want,)
        # the threaded BVH2 walks' C entries take no bvh_pair
        ctabs = tuple(a for a in tabs if a is not scene.bvh_pair
                      or name in traverse.PAIR_WALKS)

        def run(lib):
            # t, slot or prim, (u, v,) (instance,) or the occlusion
            outs = ([torch.empty(n, device=dev),
                     torch.empty(n, dtype=torch.int32, device=dev)]
                    + [torch.empty(n, device=dev)
                       for _ in range(2 * ks["uv"])]
                    + [torch.empty(n, dtype=torch.int32, device=dev)
                       for _ in range(inst)] if closest else
                    [torch.empty(n, dtype=torch.bool, device=dev)])
            rc = getattr(lib, f"mts_{name}")(
                *(a.data_ptr() for a in ctabs),
                *(a.data_ptr() for a in rays),
                *(a.data_ptr() for a in outs), n, *sizes,
                torch.cuda.current_stream(dev).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
            return outs
        res = {v: [] for v in values}
        for v in order:
            got = run(builds[v])
            torch.cuda.synchronize()
            eq = all(torch.equal(a, b) for a, b in zip(got, want))
            ok &= eq
            res[v].append(
                (cs.kernel_ms(torch, lambda: run(builds[v]), reps), eq))
        for v, r in res.items():
            means[name, v] += [m for m, _ in r]
        print(f"{path} {name} launch {i}: {n} lanes, live "
              f"{float((rays[6] > 0).float().mean()):.4f}: " + ", ".join(
                  f"{knob}={v} {[round(m, 4) for m, _ in r]} ms "
                  f"bit-equal {all(e for _, e in r)}"
                  for v, r in res.items()), flush=True)
    for name in (ks["closest"], ks["any"]):
        print(f"{path} {name} on {card}: mean ms a launch " + ", ".join(
            f"{knob}={v} {sum(r) / len(r):.4f}"
            for (nm, v), r in means.items() if nm == name), flush=True)
    return ok


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
