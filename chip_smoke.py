#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mitsuba2_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phase 0  the card, torch, CUDA and nvcc.
Phase 1  builds the CUDA kernels (csrc/cluster_walk.cu, nvcc -> ctypes) and
         the C++ BVH builder from the checkout's sources.
Phase 2  holds each kernel against its plain PyTorch twin on the card, on
         mesh_gallery(subdiv=4) with 65 536 rays of each kind a forward
         render traces (camera, first bounce, shadow, random).
Phase 3  renders mesh_gallery(subdiv=4) at 256x256, 16 spp in one pass,
         max_depth 3 through `mitsuba2_tpu_torch.render` (the main path):
         launch counts, time, Mrays/s, peak memory. Each kernel is then
         timed and held against its twin on the very inputs the main path
         gave it, beside its bound.
Phase 4  small renders on the card against the same renders on the CPU
         (twins and brute force there), the cluster and brute-force paths.
Phase 5  one main-path render under torch.profiler: device time by kernel
         and by kind, and the device's busy share.

Prints the card's `nvidia-smi` name and power limit, a JSON line
{"kernels": [...]} and, last, {"ok": true, "device": {...}}. Exits non-zero
without printing a result when there is no CUDA device or a phase fails.
"""
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and FP32
# outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# FP32 operations of one slot test in csrc/cluster_walk.cu: det (5), the u
# and v numerators (11 each), the t numerator (6), one divide, three
# scalings and u + v (4); comparisons are not counted
FLOPS_PER_SLOT = 38
# one slab test of a cut-tree node: 6 subtractions and 6 multiplications
FLOPS_PER_NODE = 12
# the slice: mesh_gallery(subdiv=4) at bench.py's forward-render config
SUBDIV = 4
RENDER = dict(width=256, height=256, spp=16, spp_per_pass=16, max_depth=3,
              rr_depth=8)
RAYS_PER_PASS = (RENDER["width"] * RENDER["height"] * RENDER["spp_per_pass"]
                 * (1 + 2 * (RENDER["max_depth"] - 1)))   # bench.py's count
N_PROBE = 65536
DEVICE = "cuda:0"
KERNEL_REPS = 20
SRC = "mitsuba2_tpu_torch/csrc/cluster_walk.cu"
REPLACES = {
    "cluster_closest_hit": ("mitsuba2_tpu/kernels/traverse_pallas.py:671",
                            "mitsuba2_tpu/kernels/traverse_pallas.py:877"),
    "cluster_any_hit": ("mitsuba2_tpu/kernels/traverse_pallas.py:755",
                        "mitsuba2_tpu/kernels/traverse_pallas.py:944"),
}
EXPECTED_LAUNCHES = {"cluster_closest_hit": 3, "cluster_any_hit": 2}


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# Phase 0: device
# ---------------------------------------------------------------------------

def phase_device(torch):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    nvcc = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc"
        if os.path.exists("/usr/local/cuda/bin/nvcc") else None)
    log(f"phase 0: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"nvcc {nvcc or 'missing'}")
    check(nvcc is not None, "nvcc not found")
    return card


# ---------------------------------------------------------------------------
# Phase 1: build
# ---------------------------------------------------------------------------

def phase_build():
    from mitsuba2_tpu_torch import native
    from mitsuba2_tpu_torch.kernels import traverse
    t0 = time.perf_counter()
    traverse.load_cuda_library()
    native.build_bvh_native(np.zeros((1, 3), np.float32),
                            np.ones((1, 3), np.float32))
    log(f"phase 1: built {SRC} (route cuda: nvcc {' '.join(traverse.NVCC_FLAGS)}"
        f" -> ctypes) and the C++ BVH builder in "
        f"{time.perf_counter() - t0:.1f} s")
    report = native.BUILD_LOG.get("cluster_walk")
    if report is None:
        log("  ptxas: library found built, no report")
    for ln in (report or "").splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            log(f"  ptxas: {ln.strip()}")


# ---------------------------------------------------------------------------
# Kernel vs twin
# ---------------------------------------------------------------------------

def planar(torch, a, dev):
    return [torch.from_numpy(np.ascontiguousarray(a[:, i])).to(dev)
            for i in range(3)]


def compare(torch, scene, rays):
    """Both kernels and both twins on the same CUDA tensors: agreement,
    the twins' times (ms, CUDA events) and the walk work they counted."""
    from mitsuba2_tpu_torch.kernels import traverse
    tabs = (scene.mxu_node_f, scene.mxu_link, scene.cluster_feat)
    ck = scene.cluster_k
    t_k, slot_k = traverse.cluster_closest_hit(*tabs, *rays, ck)
    occ_k = traverse.cluster_any_hit(*tabs, *rays, ck)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    st_c, st_a = {}, {}
    ev[0].record()
    t_p, slot_p = traverse.closest_hit_plain(*tabs, *rays, ck, chunk=65536,
                                             stats=st_c)
    ev[1].record()
    occ_p = traverse.any_hit_plain(*tabs, *rays, ck, chunk=65536,
                                   stats=st_a)
    ev[2].record()
    torch.cuda.synchronize()
    hit_k, hit_p = torch.isfinite(t_k), torch.isfinite(t_p)
    both = hit_k & hit_p
    same = (slot_k == slot_p) & both
    n_hit = int(hit_p.sum())
    dt = (t_k - t_p).abs()
    tol = 1e-5 * t_p.abs()
    return {
        "hit_equal": bool(torch.equal(hit_k, hit_p)),
        "hit_frac": n_hit / t_p.numel(),
        "slot_agree": int(same.sum()) / max(n_hit, 1),
        "t_ok_same": bool((dt[same] <= tol[same]).all()),
        "t_ok_tie": bool((dt[both & ~same] <= tol[both & ~same]).all()),
        "t_max_abs_err": float(dt[both].max()) if bool(both.any()) else 0.0,
        "occ_agree": float((occ_k == occ_p).float().mean()),
        "occ_max_abs_err": float((occ_k.int() - occ_p.int()).abs().max()),
        "closest_plain_ms": ev[0].elapsed_time(ev[1]),
        "any_plain_ms": ev[1].elapsed_time(ev[2]),
        "closest_stats": st_c, "any_stats": st_a,
    }


def passes(c):
    return (c["hit_equal"] and c["slot_agree"] >= 0.999 and c["t_ok_same"]
            and c["t_ok_tie"] and c["occ_agree"] >= 0.999)


def phase_kernels_vs_twins(torch, mt, dev):
    from mitsuba2_tpu_torch.core.vec import Vec3
    from mitsuba2_tpu_torch.kernels import traverse
    from mitsuba2_tpu_torch.probe_rays import KINDS, probe_rays
    scene = mt.mesh_gallery(subdiv=SUBDIV, device=dev)

    def closest_np(o, d, t_max):
        t, prim, _, _ = traverse.ray_intersect_preliminary(
            scene, Vec3(*planar(torch, o, dev)), Vec3(*planar(torch, d, dev)),
            torch.from_numpy(t_max).to(dev))
        return t.cpu().numpy(), prim.cpu().numpy()

    rays = probe_rays(scene, N_PROBE, 0, closest_np)
    ok = True
    for kind in KINDS:
        o, d, tm = rays[kind]
        args = (planar(torch, o, dev) + planar(torch, d, dev)
                + [torch.from_numpy(tm).to(dev)])
        c = compare(torch, scene, args)
        good = passes(c)
        ok &= good
        log(f"phase 2: {kind:7s} {'ok  ' if good else 'FAIL'} "
            f"hit {c['hit_frac']:.4f} hit-mask-equal {c['hit_equal']} "
            f"prim-agree {c['slot_agree']:.6f} t-max-abs-err "
            f"{c['t_max_abs_err']:.3e} occ-agree {c['occ_agree']:.6f}")
    check(ok, "a kernel disagrees with its twin on the probe rays")
    return scene


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------

def _recorders(traverse, record):
    """Stand-ins for the traversal entry points that keep a copy of each
    call's rays (the kernel wrappers' inputs) and then make the call."""
    orig = {"ray_intersect_preliminary": traverse.ray_intersect_preliminary,
            "ray_test": traverse.ray_test}
    kernel = {"ray_intersect_preliminary": "cluster_closest_hit",
              "ray_test": "cluster_any_hit"}

    def wrap(name):
        def rec(scene, ray_o, ray_d, t_max):
            record.append((kernel[name], [a.clone() for a in (
                ray_o.x, ray_o.y, ray_o.z, ray_d.x, ray_d.y, ray_d.z,
                t_max)]))
            return orig[name](scene, ray_o, ray_d, t_max)
        return rec
    return orig, {k: wrap(k) for k in orig}


def kernel_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def phase_main_path(torch, mt, scene, card):
    from mitsuba2_tpu_torch.kernels import traverse
    cfg = mt.RenderConfig(**RENDER)
    wrappers = {"cluster_closest_hit": traverse.cluster_closest_hit,
                "cluster_any_hit": traverse.cluster_any_hit}

    # warm-up render, recording each kernel call's inputs for the timings
    record = []
    orig, rec = _recorders(traverse, record)
    for k, f in rec.items():
        setattr(traverse, k, f)
    try:
        mt.render(scene, cfg, seed=0)
    finally:
        for k, f in orig.items():
            setattr(traverse, k, f)
    torch.cuda.synchronize()

    times, counts = [], None
    torch.cuda.reset_peak_memory_stats()
    for r in range(3):
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = mt.render(scene, cfg, seed=r)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        run_counts = {k: w.launches for k, w in wrappers.items()}
        counts = counts or run_counts
        check(run_counts == counts, f"launch counts vary: {run_counts}")
        img = img.float()
        check(tuple(img.shape) == (cfg.height, cfg.width, 3),
              f"image shape {tuple(img.shape)}")
        check(bool(torch.isfinite(img).all()), "image has non-finite values")
        mean = float(img.mean())
        check(mean > 0.0, f"image mean {mean}")
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(times)
    log(f"phase 3: render {cfg.width}x{cfg.height}x{cfg.spp}spp depth "
        f"{cfg.max_depth} of mesh_gallery(subdiv={SUBDIV}) on {card}: median "
        f"{med * 1e3:.1f} ms of {[round(t * 1e3, 1) for t in times]}, "
        f"{RAYS_PER_PASS / med / 1e6:.3f} Mrays/s, peak memory "
        f"{peak / 2**20:.0f} MiB, image mean {mean:.6f}")
    log(f"kernels launched per render: {json.dumps(counts)}")
    for k, n in EXPECTED_LAUNCHES.items():
        check(counts[k] > 0, f"{k} was not launched on the main path")
        check(counts[k] == n, f"{k}: {counts[k]} launches, expected {n}")

    # each kernel at the main path's shapes: time, twin, bound
    per = {k: {"ms": [], "plain_ms": [], "bound_ms": [], "err": 0.0,
               "bound_by": []} for k in wrappers}
    ck = scene.cluster_k
    tabs = (scene.mxu_node_f, scene.mxu_link, scene.cluster_feat)
    tabs_bytes = sum(a.numel() * a.element_size() for a in tabs)
    for i, (name, rays) in enumerate(record):
        n = rays[0].numel()
        ms = kernel_ms(torch, lambda: wrappers[name](*tabs, *rays, ck),
                       KERNEL_REPS)
        c = compare(torch, scene, list(rays))
        check(passes(c), f"{name} launch {i} disagrees with its twin: {c}")
        closest = name == "cluster_closest_hit"
        st = c["closest_stats" if closest else "any_stats"]
        # the slot tests this run's rays need: an any-hit lane stops at
        # its first hit, so it tests only part of its last cluster
        ops = (st.get("slot_tests", 0) * FLOPS_PER_SLOT
               + st.get("node_steps", 0) * FLOPS_PER_NODE)
        nbytes = n * 7 * 4 + tabs_bytes + n * (8 if closest else 1)
        t_ops, t_bytes = ops / PEAK_FP32_PER_S, nbytes / PEAK_BYTES_PER_S
        p = per[name]
        p["ms"].append(ms)
        p["plain_ms"].append(c["closest_plain_ms" if closest
                              else "any_plain_ms"])
        p["bound_ms"].append(max(t_ops, t_bytes) * 1e3)
        p["bound_by"].append("operations" if t_ops >= t_bytes else "bytes")
        p["err"] = max(p["err"], c["t_max_abs_err"] if closest
                       else c["occ_max_abs_err"])
        log(f"  {name} launch {i}: {n} lanes, {ms:.3f} ms (kernel), "
            f"{p['plain_ms'][-1]:.1f} ms (twin), bound {p['bound_ms'][-1]:.4f}"
            f" ms by {p['bound_by'][-1]}; {st.get('cluster_visits', 0) / n:.3f}"
            f" cluster visits, {st.get('slot_tests', 0) / n:.2f} slot tests and"
            f" {st.get('node_steps', 0) / n:.2f} node steps per lane; hit {c['hit_frac']:.4f}, occ-agree "
            f"{c['occ_agree']:.6f}")
    rows = []
    for name, p in per.items():
        rows.append({
            "name": name, "route": "cuda", "source": SRC,
            "replaces": REPLACES[name][0], "also_replaces": REPLACES[name][1],
            "launches": counts[name],
            "max_abs_err": p["err"],
            "ms": statistics.fmean(p["ms"]),
            "plain_ms": statistics.fmean(p["plain_ms"]),
            "bound_ms": statistics.fmean(p["bound_ms"]),
            "bound_by": max(set(p["bound_by"]), key=p["bound_by"].count),
            "library_ms": None,
        })
    return rows, med * 1e3


# ---------------------------------------------------------------------------
# Phase 4: small renders on the card against the CPU
# ---------------------------------------------------------------------------

def phase_small_renders(torch, mt, dev):
    cfg = mt.RenderConfig(width=32, height=32, spp=2, spp_per_pass=1,
                          max_depth=3, rr_depth=2)
    for name, mk in (("mesh_gallery(subdiv=1)",
                      lambda d: mt.mesh_gallery(subdiv=1, device=d)),
                     ("cornell_box", lambda d: mt.cornell_box(device=d))):
        img_c = mt.render(mk("cpu"), cfg, seed=5, device="cpu").numpy()
        img_g = mt.render(mk(dev), cfg, seed=5).cpu().numpy()
        close = np.isclose(img_g, img_c, rtol=1e-3, atol=1e-4).all(-1).mean()
        rel = abs(img_g.mean() - img_c.mean()) / img_c.mean()
        good = (np.isfinite(img_g).all() and close >= 0.99 and rel <= 1e-3)
        log(f"phase 4: {name} 32x32 card vs CPU: {close:.4f} of pixels "
            f"within rtol 1e-3/atol 1e-4, mean rel diff {rel:.2e} "
            f"{'ok' if good else 'FAIL'}")
        check(good, f"{name}: the card's render disagrees with the CPU's")


# ---------------------------------------------------------------------------
# Phase 5: where a render's device time goes
# ---------------------------------------------------------------------------

def _category(name):
    low = name.lower()
    if "cluster_" in low:
        return "traversal kernels"
    if "sort" in low or "radix" in low:
        return "presort (torch.sort)"
    if "index" in low or "gather" in low or "scatter" in low:
        return "gathers and scatters"
    return "elementwise and reductions"


def phase_profile(torch, mt, scene, render_ms):
    """One main-path render under torch.profiler: device time by kernel
    and by kind, and the device's busy share of the render's wall time,
    profiled (the profiler's host cost inflates it) and unprofiled
    (`render_ms`, phase 3's median)."""
    from torch.profiler import ProfilerActivity, profile
    cfg = mt.RenderConfig(**RENDER)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mt.render(scene, cfg, seed=11)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # kernel rows only: an operator's row repeats its kernels' time
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
            if us > 0:
                rows.append((us / 1e3, e.count, e.key))
    dev_ms = sum(r[0] for r in rows)
    check(dev_ms > 0, "the profiler shows no device time")
    rows.sort(reverse=True)
    cats = {}
    for ms, n, key in rows:
        c = cats.setdefault(_category(key), [0.0, 0])
        c[0] += ms
        c[1] += n
    log(f"phase 5: profiled render: {dev_ms:.2f} ms of device kernels in "
        f"{sum(r[1] for r in rows)} launches; device busy {dev_ms / wall_ms:.3f}"
        f" of the profiled wall time ({wall_ms:.1f} ms), "
        f"{dev_ms / render_ms:.3f} of phase 3's median ({render_ms:.1f} ms)")
    for c, (ms, n) in sorted(cats.items(), key=lambda kv: -kv[1][0]):
        log(f"  {c}: {ms:.2f} ms ({ms / dev_ms:.3f}) in {n} launches")
    for ms, n, key in rows[:12]:
        log(f"  {ms:8.3f} ms {n:5d}x {key[:90]}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    try:
        card = phase_device(torch)
        import mitsuba2_tpu_torch as mt
        dev = torch.device(DEVICE)
        phase_build()
        scene = phase_kernels_vs_twins(torch, mt, dev)
        rows, render_ms = phase_main_path(torch, mt, scene, card)
        phase_small_renders(torch, mt, dev)
        phase_profile(torch, mt, scene, render_ms)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
