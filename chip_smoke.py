#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mitsuba2_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Seventeen main paths, each a forward render at 256x256 through
`mitsuba2_tpu_torch.render`, 16 spp at max_depth 3 (in one pass but for
veach and veach_spectral) but for config 5's two, in rgb but for
veach_spectral, veach_spectral_bvh2, gallery_spectral and
gallery_lights, which render spectrally:
  gallery    mesh_gallery(subdiv=4), 30 732 triangles: the cluster walk
             (K1 closest hit, K2 any hit);
  instanced  instanced_field(n=1024, subdiv=4), 1 024 shared-BLAS instances
             of one 5 120-triangle blob, 5 242 882 effective triangles: the
             instanced cluster walk (K5 closest hit and any hit);
  spheres    the sphere field (instanced_field's construction with a sphere
             added to the group, built here from the shape API) at n=64,
             subdiv=4: 327 746 prims, 64 of them spheres, which the JAX
             package's policy flattens: the BVH2 walk (K3);
  spheres_instanced  the sphere field at n=1024, subdiv=4: 5 243 906
             effective prims from 5 123 stored, kept shared: the instanced
             BVH2 walk (K4);
  gallery_bvh8     the gallery under set_backend("bvh8"): the BVH8 walk over
             prim leaves (K6);
  gallery_bvh8mxu  the gallery under set_backend("bvh8mxu"): the BVH8 walk
             over cluster leaves (K7);
  gallery_dense    the gallery's scene with the dense switch on
             (traverse._MXU_DENSE = "1", the JAX package's MI_MXU_DENSE=1):
             every cluster against every ray (K8);
  veach      veach_mis() (four rough aluminium plates, four sphere lights,
             16 prims) at bench.py m_veach's sizes, 16 spp in 4 passes of
             4: brute force, as "auto" takes it (no kernel);
  veach_bvh2 the same scene under set_backend("pallas"), one pass: the
             BVH2 walk (K3) on glossy bounce rays;
  gallery_materials  mesh_gallery's room and blobs under the BSDF families
             of config 2 (gallery_materials: conductor, roughconductor,
             dielectric, roughdielectric, plastic, roughplastic), a
             twosided rough aluminium quad seen from behind and a thin
             glass pane: the cluster walk (K1, K2) on refracted rays;
  veach_spectral   veach_mis(envmap=True) (veach's plates and sphere
             lights under a procedural sky with a sun blob: config 3) in
             color_mode="spectral" (four hero wavelengths a lane) at
             bench.py m_veach's sizes, 4 passes of 4: brute force;
  veach_spectral_bvh2  the same scene under set_backend("pallas"), one
             pass: the BVH2 walk (K3) on envmap shadow rays of t_max
             ~1e7;
  gallery_spectral mesh_gallery(subdiv=4) in spectral mode: K1, K2;
  gallery_lights   mesh_gallery's room without its ceiling or area light,
             lit by a point, a spot, a directional light, an untextured
             projector and the procedural sky (gallery_lights), spectral:
             K1, K2 on delta and envmap shadow rays;
  gallery_textured mesh_gallery(subdiv=4)'s room and blobs with config
             4's textures and wrappers (gallery_textured: a 1024 x 1024
             bilinear floor albedo, a textured roughness, a normal map, a
             checkerboard bump map, a textured area light and projector;
             mask, blendbsdf and null blobs), its six textures in one
             atlas padded to 1024 x 1024 with its mip pyramid, the camera
             rays carrying differentials: K1, K2;
  cornell_reparam  config 5 (reparam=True: the camera, NEE and BSDF
             directions warped by K = 16 auxiliary rays each) on
             cornell_box() at bench.py m_reparam's sizes, 16 spp in 4
             passes of 4, depth 4: brute force, the auxiliary rays in
             2M-lane chunks;
  gallery_reparam  config 5 on the gallery's scene, 4 spp in one pass,
             depth 3: K1 on the 4.2M camera-site and 8.4M bounce-site
             auxiliary rays too (6 launches), K2.
Each path sets its switches (the backend, the dense switch, MXU_LEAVES)
before it builds its scene (a scene uploads the tables of the walk it
takes) and resets them after each use.

Phase 0  the card, torch, CUDA and nvcc.
Phase 1  builds the CUDA kernels (csrc/cluster_walk.cu and csrc/probes.cu,
         one nvcc each, started together -> ctypes) and the C++ BVH
         builder from the checkout's sources.
Phase 2  holds each kernel against its plain PyTorch twin on the card, on
         each path's scene with 65 536 rays of each kind a forward render
         traces (camera, first bounce, shadow, random; on the sphere
         fields a quarter of the random rays aim into the spheres); K6
         also on the n=64 sphere field (its sphere branch); every kernel
         bit-equal to its twin on every lane: K8, K1, K2, K5's and K7's
         closest and any hit (warp-cooperative visits), K4's and K6's
         closest hit (warp-wide leaf tests), K3's closest and any hit and
         K4's any hit (the pair walk) and K6's any hit (one thread a
         ray). The paths on one scene share its
         probe rays. Prints the walk work the twins count per lane (K4's
         and K6's closest hit: their warps' leaf passes too) and the
         bound of 1M such lanes.
Phase 3  renders each path: launch counts (set to 0 just before the path's
         renders, read just after), time, Mrays/s, peak memory. Each kernel
         is then timed and held against its twin on the very inputs the
         main path gave it, beside its bound; K6 also on the inputs the
         spheres path gave K3, for a same-ray comparison. Config 5's
         paths print bench.py's counted and all-rays Mrays/s, and their
         image against the plain render of the same seed (held within
         atol 1e-5 on the Cornell box).
Phase 4  small renders on the card against the same renders on the CPU
         (twins and brute force there): the cluster, instanced, BVH2 and
         instanced BVH2 paths and brute force, with and without a sphere,
         the BVH8 walks (K6 with and without a sphere, K7), the dense
         sweep (K8), MXU_LEAVES off (K3 and K4 on triangle scenes), and
         veach_mis() (brute force and K3) and gallery_materials(subdiv=1),
         and in spectral mode veach_mis(envmap=True) (brute force and
         K3), mesh_gallery(subdiv=1) and gallery_lights(subdiv=1), and
         gallery_textured(subdiv=1) with 64 x 64 textures in rgb and in
         spectral mode.
Phase 5  one render of each path under torch.profiler: device time by
         kernel and by kind (the kernels of the texture lookups apart),
         and the device's busy share.
Phase 6  the probes (csrc/probes.cu) at 1M lanes: each configuration
         launched once with the counts at 0, each held bit for bit
         against its twin and timed; their costs per walk step, per row
         and per cluster visit, and from these a model of each K1, K2,
         K5 and K7 launch of phase 3 (steps x step cost + visits x visit
         cost, each term shown) beside its measured time.
Phase 7  the adjoint (mitsuba2_tpu_torch.diff), at bench.py's two adjoint
         configs: gallery (the gallery's scene as above, one 16-spp pass,
         L2 against a zero target: K1 and K2) and cornell (cornell_box(),
         256x256, 64 spp in passes of 16, max_depth 4, rr_depth 8: brute
         force), and at the veach, veach_spectral and gallery_textured
         paths' (brute force, brute force, K1 and K2; veach_spectral's
         gradients also flow to the envmap's image and scale,
         gallery_textured's to the atlas' texels through its pyramid).
         For each: the
         forward render's and render_l2_grad's medians of 3 after a
         warm-up, forward + adjoint Mrays/s (bench.py's count: 2 x rays
         of a pass x passes / time), their ratio, the peak memory of
         render_l2_grad and of one pass and of every pass differentiated
         end to end (the latter held to render_l2_grad's image and
         gradients), each kernel's launches over one render_l2_grad
         (counts at 0 just before) and around each backward sweep (must
         not move); on the gallery one render_l2_grad under
         torch.profiler, the backward sweeps' kernels apart, and so on
         gallery_textured, the texel gathers' backward apart too. Then
         render_l2_grad on small scenes on the card against the CPU
         (veach_mis() and veach_mis(envmap=True) in spectral mode the
         exception: an L2 loss over the pixels where the two renders
         agree, the plates' roughness and the floor's albedo also apart,
         every gradient finite, the envmap's image and scale among
         them; gallery_textured(subdiv=1) with 64 x 64 textures, its
         texels' gradients within 1e-3 of their largest magnitude), and 8
         Adam steps of examples/invert_cbox.py's loop on the card, each at
         one seed (the loss must fall, the albedo's error halve), and 8
         Adam steps on gallery_textured's texels toward its render under
         another floor texture (the loss must fall); then veach_mis()'s
         plate0 roughness gradients (alpha 0.005) on the card, on the CPU
         and by a central difference on the card, printed. Config 5:
         the gallery with its last blob moved and the walk tables
         refreshed (scene.refresh_mxu_feat), K1 and K2 held bit for bit
         against their twins there; the gradient of gallery_reparam's
         image mean with respect to that blob's translation by plain AD,
         reparameterized AD and a central difference on refreshed
         scenes, printed with the backward's peak memory; and the
         occluder scenes of examples/occluder_pose_grad.py and
         tests/test_reparam.py (occluder_scene, shadow_scene): plain AD,
         reparameterized AD and a central difference held to the JAX
         tests' bands, and the card's reparameterized AD to the CPU's.

Prints each phase's wall time, the card's `nvidia-smi` name and power
limit, a JSON line {"kernels": [...]} (one row a kernel: its first path's
numbers, a later path's under "also_on") and, last, {"ok": true,
"device": {...}}. Exits non-zero without printing a result when there is
no CUDA device or a phase fails.
"""
import contextlib
import functools
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
# one slab test of a node: 6 subtractions and 6 multiplications (a BVH8
# walk's fresh visit makes one a non-empty child, and a closest-hit
# advance one more)
FLOPS_PER_NODE = 12
# one instance entry: the 3x4 transform of o (18) and d (15), 3 reciprocals
FLOPS_PER_ENTRY = 36
# one prim test of the BVH2 walks (csrc/cluster_walk.cu::prim_test): a
# triangle by Möller–Trumbore, a sphere by the stable quadratic
FLOPS_PER_TRI = 46
FLOPS_PER_SPHERE = 31
# the walk work the twins count, as printed per lane
WORK_COUNTS = ("node_steps", "fresh_visits", "child_tests", "advances",
               "pushes", "pops", "cluster_visits", "cluster_groups",
               "thread_visits", "loaded_slots", "slot_tests",
               "real_slot_tests", "tri_tests", "sphere_tests",
               "leaf_passes", "instance_entries", "root_tests",
               "pair_rows", "fallback_steps")
# the paths' scenes, rendered at bench.py's forward-render config
SUBDIV = 4
FIELD = dict(n=1024, subdiv=4)
SPHERE_FIELDS = {"spheres": dict(n=64, subdiv=4),
                 "spheres_instanced": dict(n=1024, subdiv=4)}
RENDER = dict(width=256, height=256, spp=16, spp_per_pass=16, max_depth=3,
              rr_depth=8)
# Veach's MIS scene at bench.py m_veach's sizes (:285, :341-355), in rgb:
# 16 spp in 4 passes of 4
VEACH_RENDER = dict(width=256, height=256, spp=16, spp_per_pass=4,
                    max_depth=3, rr_depth=8)
# the paths rendered at another config than RENDER: veach's passes, and
# the spectral paths (veach_spectral: bench.py's veach_spectral_fwd,
# :341-355)
SPECTRAL = dict(color_mode="spectral")
# config 5's paths (reparam=True): bench.py m_reparam's Cornell box (its
# forward config, :357-360 and :370-388: 16 spp in passes of 4, depth 4,
# rr_depth 8, K 16), and the gallery in one pass of 4 spp at depth 3
REPARAM_CORNELL = dict(width=256, height=256, spp=16, spp_per_pass=4,
                       max_depth=4, rr_depth=8, reparam=True,
                       reparam_kaux=16)
REPARAM_GALLERY = dict(width=256, height=256, spp=4, spp_per_pass=4,
                       max_depth=3, rr_depth=8, reparam=True)
PATH_RENDER = {"veach": VEACH_RENDER,
               "veach_spectral": {**VEACH_RENDER, **SPECTRAL},
               "veach_spectral_bvh2": {**RENDER, **SPECTRAL},
               "gallery_spectral": {**RENDER, **SPECTRAL},
               "gallery_lights": {**RENDER, **SPECTRAL},
               "cornell_reparam": REPARAM_CORNELL,
               "gallery_reparam": REPARAM_GALLERY}
# config 5's occluder scenes (occluder_scene, shadow_scene): the JAX
# tests' configs, central-difference steps and bands of |AD| / |FD|
# (tests/test_reparam.py; examples/occluder_pose_grad.py)
OCCLUDER_CHECKS = {
    "occluder_pose_grad": dict(
        render=dict(width=24, height=24, spp=16, spp_per_pass=16,
                    max_depth=2), eps=0.04, band=(0.4, 2.5)),
    "test_reparam occluder": dict(
        render=dict(width=32, height=32, spp=4, spp_per_pass=4,
                    max_depth=1), eps=0.03, band=(0.5, 2.0)),
}
# gallery_reparam's blob move (the last blob, along x): refresh_mxu_feat's
# check and the central difference's step
BLOB_SHIFT, BLOB_EPS = 0.05, 0.02
# gallery_textured's texel optimization, at invert_cbox's size (INVERT)
TEXTURED_TRAIN_STEPS, TEXTURED_TRAIN_LR = 8, 0.05
# veach's plate0 roughness, its central difference's step (the test's,
# tests/test_torch_veach.py), at the test's config
PLATE = dict(name="plate0.bsdf.alpha_u", value=0.005, eps=1e-4)
PLATE_RENDER = dict(width=16, height=16, spp=4, spp_per_pass=4, max_depth=3,
                    rr_depth=99)
N_PROBE = 65536
DEVICE = "cuda:0"
KERNEL_REPS = 20
# bench.py's adjoint configs (m_gallery_adj :318, m_cornell_adj :364)
# and the veach path's config (bench.py's veach render under
# render_l2_grad)
ADJOINT = {"gallery": RENDER,
           "cornell": dict(width=256, height=256, spp=64, spp_per_pass=16,
                           max_depth=4, rr_depth=8),
           "veach": VEACH_RENDER,
           "veach_spectral": PATH_RENDER["veach_spectral"],
           "gallery_textured": RENDER}
# examples/invert_cbox.py's loop, 8 steps
INVERT = dict(width=64, height=64, spp=32, spp_per_pass=32, max_depth=3,
              rr_depth=99)
INVERT_STEPS, INVERT_LR = 8, 0.05
# veach's parameters whose gradients phase 7 holds card against CPU
VEACH_PARAMS = {
    "plates' alpha_u, alpha_v": [f"plate{i}.bsdf.alpha_{a}"
                                 for i in range(4) for a in "uv"],
    "floor's reflectance": ["floor.bsdf.reflectance"]}
# a K8 launch takes a tenth of a second or more, gallery_reparam's K1
# launches of 4.2M and 8.4M auxiliary rays several ms: fewer repetitions
PATH_REPS = {"gallery_dense": 3, "gallery_reparam": 5}
# ~0.1 s of the device's clock: ample for the host to queue KERNEL_REPS
# launches ahead of it
SLEEP_CYCLES = 200_000_000
SRC = "mitsuba2_tpu_torch/csrc/cluster_walk.cu"
PROBE_SRC = "mitsuba2_tpu_torch/csrc/probes.cu"
PALLAS = "mitsuba2_tpu/kernels/traverse_pallas.py"
REPLACES = {
    "cluster_closest_hit": (f"{PALLAS}:671", f"{PALLAS}:877"),
    "cluster_any_hit": (f"{PALLAS}:755", f"{PALLAS}:944"),
    "inst_cluster_closest_hit": (f"{PALLAS}:1746", None),
    "inst_cluster_any_hit": (f"{PALLAS}:1856", None),
    "bvh_closest_hit": (f"{PALLAS}:250", None),
    "bvh_any_hit": (f"{PALLAS}:309", None),
    "inst_bvh_closest_hit": (f"{PALLAS}:1382", None),
    "inst_bvh_any_hit": (f"{PALLAS}:1486", None),
    "bvh8_closest_hit": (f"{PALLAS}:2001", None),
    "bvh8_any_hit": (f"{PALLAS}:2117", None),
    "bvh8mxu_closest_hit": (f"{PALLAS}:2316", None),
    "bvh8mxu_any_hit": (f"{PALLAS}:2433", None),
    "dense_closest_hit": (f"{PALLAS}:1040", None),
    "dense_any_hit": (f"{PALLAS}:1071", None),
}
# the probes (kernels/probes.py) and the TPU probes they replace
PROBE_REPLACES = {
    "walk_step": "benchmarks/probe_walk_latency.py:499",
    "row_load": "benchmarks/probe_mxu_dma.py:98",
    "cluster_visit": "benchmarks/probe_mxu_cost.py:159",
}
# each path's closest-hit and any-hit kernels: 3 and 2 launches a render
# (the camera and two bounce wavefronts, two shadow rounds), 0 of the rest;
# none on veach, whose 16 prims take brute force
PATH_KERNELS = {
    "gallery": ("cluster_closest_hit", "cluster_any_hit"),
    "instanced": ("inst_cluster_closest_hit", "inst_cluster_any_hit"),
    "spheres": ("bvh_closest_hit", "bvh_any_hit"),
    "spheres_instanced": ("inst_bvh_closest_hit", "inst_bvh_any_hit"),
    "gallery_bvh8": ("bvh8_closest_hit", "bvh8_any_hit"),
    "gallery_bvh8mxu": ("bvh8mxu_closest_hit", "bvh8mxu_any_hit"),
    "gallery_dense": ("dense_closest_hit", "dense_any_hit"),
    "veach": (),
    "veach_bvh2": ("bvh_closest_hit", "bvh_any_hit"),
    "gallery_materials": ("cluster_closest_hit", "cluster_any_hit"),
    "veach_spectral": (),
    "veach_spectral_bvh2": ("bvh_closest_hit", "bvh_any_hit"),
    "gallery_spectral": ("cluster_closest_hit", "cluster_any_hit"),
    "gallery_lights": ("cluster_closest_hit", "cluster_any_hit"),
    "gallery_textured": ("cluster_closest_hit", "cluster_any_hit"),
    "cornell_reparam": (),
    "gallery_reparam": ("cluster_closest_hit", "cluster_any_hit"),
}
# the backend each path (and phase 2's extra scene) runs under, the paths
# with the dense switch on, and the path whose scene geometry and probe
# rays each shares
BACKEND = {"gallery_bvh8": "bvh8", "gallery_bvh8mxu": "bvh8mxu",
           "spheres_bvh8": "bvh8", "veach_bvh2": "pallas",
           "veach_spectral_bvh2": "pallas"}
DENSE = {"gallery_dense"}
# the paths phase 5 profiles one pass of: the profiler's host cost is
# ~0.4 ms a launch, and cornell_reparam's renders launch ~240 000 kernels
PROFILE_ONE_PASS = {"cornell_reparam"}
# the kernels held bit-equal to their twins on every lane of phases 2 and
# 3: the warp-cooperative cluster visits, the warp-wide leaf tests, the
# pair walks and K6's any hit: every walk kernel
BIT_EQUAL = {"cluster_closest_hit", "inst_cluster_closest_hit",
             "bvh8mxu_closest_hit", "cluster_any_hit",
             "inst_cluster_any_hit", "bvh8mxu_any_hit",
             "inst_bvh_closest_hit", "bvh8_closest_hit",
             "bvh_closest_hit", "inst_bvh_any_hit", "bvh_any_hit",
             "bvh8_any_hit"}
SAME_SCENE = {"gallery_bvh8": "gallery", "gallery_bvh8mxu": "gallery",
              "spheres_bvh8": "spheres", "gallery_dense": "gallery",
              "gallery_spectral": "gallery", "gallery_reparam": "gallery"}
# the probes' configurations at 1M lanes: P1 over the gallery-sized table
# (L1-resident) and one of the sphere field's BVH2 size (8 MiB, in L2)
PROBE_LANES = 1 << 20
P1_STEPS, P2_STEPS, P3_STEPS = 256, 16, 64
P1_ROWS = (768, 262144)
P3_MODES = {0: "step", 4: "visit4", 1: "visit1"}
PROBE_REPS = 5
EXPECTED_LAUNCHES = {
    path: {k: 3 if k in ks[:1] else 2 if k in ks[1:] else 0
           for k in REPLACES}
    for path, ks in PATH_KERNELS.items()}
# reparam=True adds one closest-hit launch a warp site: the camera's
# auxiliary rays, and each bounce's NEE and BSDF sites' in one
EXPECTED_LAUNCHES["gallery_reparam"]["cluster_closest_hit"] = 6


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
    from concurrent.futures import ThreadPoolExecutor
    from mitsuba2_tpu_torch import native
    from mitsuba2_tpu_torch.kernels import probes, traverse
    t0 = time.perf_counter()
    # one nvcc for each source, all started together
    cmd = [traverse.nvcc_path()] + traverse.NVCC_FLAGS
    with ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(native.build_library, name, src, cmd,
                            traverse.HEADERS)
                for name, src in (("cluster_walk", traverse._SRC),
                                  ("probes", probes._SRC))]
        native.build_bvh_native(np.zeros((1, 3), np.float32),
                                np.ones((1, 3), np.float32))
        for j in jobs:
            j.result()
    traverse.load_cuda_library()
    probes.load_cuda_library()
    log(f"phase 1: built {SRC} and {PROBE_SRC} (route cuda: nvcc "
        f"{' '.join(traverse.NVCC_FLAGS)} -> ctypes) and the C++ BVH "
        f"builder in {time.perf_counter() - t0:.1f} s")
    for name in ("cluster_walk", "probes"):
        report = native.BUILD_LOG.get(name)
        if report is None:
            log(f"  ptxas ({name}): library found built, no report")
        for ln in (report or "").splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                log(f"  ptxas: {ln.strip()}")


# ---------------------------------------------------------------------------
# Kernel vs twin
# ---------------------------------------------------------------------------

def planar(torch, a, dev):
    return [torch.from_numpy(np.ascontiguousarray(a[:, i])).to(dev)
            for i in range(3)]


@contextlib.contextmanager
def switches(backend="auto", dense="0", leaves=True):
    """scene.set_backend(backend), the dense switch (traverse._MXU_DENSE)
    and traverse.MXU_LEAVES inside the block; "auto", "0" and on after
    it."""
    from mitsuba2_tpu_torch.kernels import traverse
    from mitsuba2_tpu_torch.scene import scene as scene_mod
    scene_mod.set_backend(backend)
    traverse._MXU_DENSE, traverse.MXU_LEAVES = dense, leaves
    try:
        yield backend
    finally:
        scene_mod.set_backend("auto")
        traverse._MXU_DENSE, traverse.MXU_LEAVES = "0", True


def path_switches(path):
    """The switches of a main path (or of phase 2's extra scene)."""
    return switches(BACKEND.get(path, "auto"),
                    "1" if path in DENSE else "0")


def kernels_of(scene, backend="auto"):
    """The path's two kernel wrappers, their twins, tables, trailing
    arguments, the positions of the id outputs (slot or prim, instance),
    whether the closest hit emits u/v (outputs 2 and 3) and the twins'
    chunk: the BVH8 walks under set_backend("bvh8" | "bvh8mxu"); else the
    BVH2 walks on a scene holding a sphere (or with MXU_LEAVES off), the
    cluster walks on the others, each instanced on an instanced scene, or
    the dense sweep on a flat one with the dense switch on."""
    import torch
    from mitsuba2_tpu_torch.core.vec import Vec3
    from mitsuba2_tpu_torch.kernels import traverse
    if backend in ("bvh8", "bvh8mxu"):
        # the entry points' own tables and walk bounds (stack, fuel)
        z = torch.zeros(1, device=scene.device)
        k6 = backend == "bvh8"
        args = (traverse._bvh8_args if k6 else traverse._bvh8mxu_args)(
            scene, Vec3(z, z, z), Vec3(z, z, z), z)
        return dict(
            closest=f"{backend}_closest_hit", any=f"{backend}_any_hit",
            closest_plain=getattr(traverse, f"{backend}_closest_hit_plain"),
            any_plain=getattr(traverse, f"{backend}_any_hit_plain"),
            tabs=args[:3], extra=args[10:], ids=(1,), uv=k6,
            chunk=1 << 20 if k6 else 65536)
    if traverse.takes_bvh2(scene.has_spheres):
        # the BVH2 twins walk a whole wavefront as one chunk: their loop
        # runs as long as the longest walk in a chunk
        tabs = (scene.bvh_node, scene.bvh_link, scene.bvh_pair,
                scene.bvh_prim)
        if scene.has_instances:
            return dict(
                closest="inst_bvh_closest_hit", any="inst_bvh_any_hit",
                closest_plain=traverse.inst_bvh_closest_hit_plain,
                any_plain=traverse.inst_bvh_any_hit_plain,
                tabs=tabs + (scene.inst_inv, scene.inst_bvh_root),
                extra=(scene.inst_fuel + 64,), ids=(1, 4), uv=True,
                chunk=1 << 20)
        return dict(
            closest="bvh_closest_hit", any="bvh_any_hit",
            closest_plain=traverse.bvh_closest_hit_plain,
            any_plain=traverse.bvh_any_hit_plain, tabs=tabs,
            extra=(scene.bvh_node.shape[0] + 64,), ids=(1,), uv=True,
            chunk=1 << 20)
    if scene.has_instances:
        return dict(
            closest="inst_cluster_closest_hit", any="inst_cluster_any_hit",
            closest_plain=traverse.inst_closest_hit_plain,
            any_plain=traverse.inst_any_hit_plain,
            tabs=(scene.mxu_node_f, scene.mxu_link, scene.cluster_feat,
                  scene.inst_inv),
            extra=(scene.cluster_k, scene.inst_mxu_fuel + 64), ids=(1, 2),
            uv=False, chunk=65536)
    if traverse._use_dense(scene):
        return dict(
            closest="dense_closest_hit", any="dense_any_hit",
            closest_plain=traverse.dense_closest_hit_plain,
            any_plain=traverse.dense_any_hit_plain,
            tabs=(scene.mxu_ccs, scene.mxu_ccount, scene.cluster_feat),
            extra=(scene.cluster_k,), ids=(1,), uv=False, chunk=1 << 20)
    return dict(
        closest="cluster_closest_hit", any="cluster_any_hit",
        closest_plain=traverse.closest_hit_plain,
        any_plain=traverse.any_hit_plain,
        tabs=(scene.mxu_node_f, scene.mxu_link, scene.cluster_feat),
        extra=(scene.cluster_k,), ids=(1,), uv=False, chunk=65536)


def wrapper(name):
    from mitsuba2_tpu_torch.kernels import traverse
    return getattr(traverse, name)


def compare(torch, ks, rays):
    """Both kernels and both twins on the same CUDA tensors, every lane:
    agreement, the twins' times (ms, CUDA events) and the walk work they
    counted."""
    tabs, extra = ks["tabs"], ks["extra"]
    out_k = wrapper(ks["closest"])(*tabs, *rays, *extra)
    occ_k = wrapper(ks["any"])(*tabs, *rays, *extra)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    st_c, st_a = {}, {}
    ev[0].record()
    out_p = ks["closest_plain"](*tabs, *rays, *extra, chunk=ks["chunk"],
                                stats=st_c)
    ev[1].record()
    occ_p = ks["any_plain"](*tabs, *rays, *extra, chunk=ks["chunk"],
                            stats=st_a)
    ev[2].record()
    torch.cuda.synchronize()
    t_k, t_p = out_k[0], out_p[0]
    hit_k, hit_p = torch.isfinite(t_k), torch.isfinite(t_p)
    both = hit_k & hit_p
    # slot or prim, and on the instanced walks the instance, of the same hit
    same = both
    for i in ks["ids"]:
        same = same & (out_k[i] == out_p[i])
    n_hit = int(hit_p.sum())
    dt = (t_k - t_p).abs()
    tol = 1e-5 * t_p.abs()
    uv_err = 0.0
    if ks["uv"] and bool(same.any()):
        uv_err = max(float((out_k[i] - out_p[i])[same].abs().max())
                     for i in (2, 3))
    outs_k = (out_k if isinstance(out_k, tuple) else (out_k,)) + (occ_k,)
    outs_p = (out_p if isinstance(out_p, tuple) else (out_p,)) + (occ_p,)
    return {
        "bit_equal": all(torch.equal(a, b) for a, b in zip(outs_k, outs_p)),
        "closest_bit_equal": all(torch.equal(a, b) for a, b in
                                 zip(outs_k[:-1], outs_p[:-1])),
        "hit_equal": bool(torch.equal(hit_k, hit_p)),
        "hit_frac": n_hit / t_p.numel(),
        "slot_agree": int(same.sum()) / max(n_hit, 1),
        "t_ok_same": bool((dt[same] <= tol[same]).all()),
        "t_ok_tie": bool((dt[both & ~same] <= tol[both & ~same]).all()),
        "t_max_abs_err": float(dt[both].max()) if bool(both.any()) else 0.0,
        "uv_max_abs_err": uv_err,
        "occ_agree": float((occ_k == occ_p).float().mean()),
        "occ_max_abs_err": float((occ_k.int() - occ_p.int()).abs().max()),
        "closest_plain_ms": ev[0].elapsed_time(ev[1]),
        "any_plain_ms": ev[1].elapsed_time(ev[2]),
        "closest_stats": st_c, "any_stats": st_a,
    }


def passes(c, exact=False, exact_closest=False, exact_any=False):
    """A kernel's agreement with its twin (compare's): within the port's
    limits, every output bit-equal where `exact` (K8), the closest hit's
    (t, slot or prim, u, v, instance) where `exact_closest` and the
    occlusion on every lane where `exact_any` (K1, K2, K5 and K7, whose
    warp-cooperative visits keep the twin's rule, K4's and K6's closest
    hit, whose warp-wide leaf tests keep it, K3's closest and any hit and
    K4's any hit, whose pair walk visits the twin's leaves in its order,
    and K6's any hit, whose walk keeps the twin's state machine))."""
    return (c["hit_equal"] and c["slot_agree"] >= 0.999 and c["t_ok_same"]
            and c["t_ok_tie"] and c["occ_agree"] >= 0.999
            and c["uv_max_abs_err"] <= 1e-5
            and (c["bit_equal"] or not exact)
            and (c["closest_bit_equal"] or not exact_closest)
            and (c["occ_agree"] == 1.0 or not exact_any))


def exactness(path, ks):
    """passes()'s keywords for the kernels `ks` (kernels_of's) on a path
    (or phase 2's extra scene)."""
    return dict(exact=path in DENSE,
                exact_closest=ks["closest"] in BIT_EQUAL,
                exact_any=ks["any"] in BIT_EQUAL)


def sphere_field(mt, n, subdiv, device):
    """presets.instanced_field(n, subdiv) with a sphere in the group (the
    displaced icosphere blob and a 0.3-radius cap above it), built from the
    shape API; the build keeps the JAX package's flatten policy."""
    from mitsuba2_tpu_torch.core.geometry import Transform4 as T4
    from mitsuba2_tpu_torch.scene import presets as P, shapes as sh
    rng = np.random.default_rng(7)
    base_v, faces = P._icosphere(subdiv)
    blob = sh.mesh(P._displace(base_v.copy(), seed=3), faces,
                   bsdf={"type": "diffuse", "reflectance": [0.55, 0.5, 0.4]},
                   id="blob")
    cap = sh.sphere(center=(0, 1.4, 0), radius=0.3,
                    bsdf={"type": "diffuse", "reflectance": [0.8, 0.8, 0.8]},
                    id="cap")
    grp = sh.shapegroup([blob, cap], id="blob_grp")
    side = int(np.ceil(np.sqrt(n)))
    s = [P._quad([-side, 0, -side], [-side, 0, side], [side, 0, side],
                 [side, 0, -side],
                 bsdf={"type": "diffuse", "reflectance": P.WHITE},
                 id="ground")]
    for k in range(n):
        i, j = divmod(k, side)
        t = (T4.translate([2.0 * i - side + 1.0,
                           0.45 + 0.15 * float(rng.uniform()),
                           2.0 * j - side + 1.0])
             @ T4.rotate([0, 1, 0], float(rng.uniform(0, 360)))
             @ T4.scale([0.35 + 0.15 * float(rng.uniform())] * 3))
        s.append(sh.instance(grp, np.asarray(t.matrix), id=f"b{k}"))
    cam = T4.look_at(origin=[0.0, side * 0.8, -side * 1.6],
                     target=[0.0, 0.3, 0.0], up=[0, 1, 0])
    sensor = {"type": "perspective", "to_world": np.asarray(cam.matrix),
              "fov": 55.0}
    return mt.build_scene(
        s, sensor, [{"type": "constant", "radiance": [0.9, 0.95, 1.0]}],
        device=device)


# gallery_materials: each blob of mesh_gallery's grid under one leaf family
# of config 2, by blob index, a twosided rough aluminium quad the camera
# sees from behind and a thin glass pane in front of blob 4
MATERIALS = (
    {"type": "conductor", "material": "Au"},
    {"type": "roughconductor", "material": "Cu", "distribution": "ggx",
     "alpha_u": 0.05, "alpha_v": 0.3},
    {"type": "dielectric", "int_ior": "bk7"},
    {"type": "roughdielectric", "distribution": "beckmann", "alpha": 0.1,
     "int_ior": 1.5},
    {"type": "plastic", "nonlinear": True},
    {"type": "roughplastic", "alpha": 0.2},
)
GALLERY_ALBEDO = ([0.7, 0.3, 0.25], [0.3, 0.55, 0.7], [0.65, 0.6, 0.3],
                  [0.5, 0.5, 0.65], [0.35, 0.6, 0.4], [0.6, 0.4, 0.6])


def gallery_materials(P, subdiv=SUBDIV, **build_kw):
    """mesh_gallery(subdiv)'s room, light and blobs (the same seeds and
    placement) under the materials of config 2, built from the presets
    module `P` of either package (its _quad, _icosphere, _displace,
    shapes, Transform4 and build_scene): 6 x 20 x 4^subdiv + 16
    triangles. The plastics keep their blobs' gallery albedo."""
    X, Y, Z = 3.0, 2.0, 3.0
    white = {"type": "diffuse", "reflectance": P.WHITE}
    s = [
        P._quad([0, 0, 0], [0, 0, Z], [X, 0, Z], [X, 0, 0], bsdf=white,
                id="floor"),
        P._quad([0, Y, 0], [X, Y, 0], [X, Y, Z], [0, Y, Z], bsdf=white,
                id="ceiling"),
        P._quad([0, 0, Z], [0, Y, Z], [X, Y, Z], [X, 0, Z], bsdf=white,
                id="back"),
        P._quad([X, 0, 0], [X, 0, Z], [X, Y, Z], [X, Y, 0],
                bsdf={"type": "diffuse", "reflectance": P.RED}, id="left"),
        P._quad([0, 0, 0], [0, Y, 0], [0, Y, Z], [0, 0, Z],
                bsdf={"type": "diffuse", "reflectance": P.GREEN},
                id="right"),
    ]
    lx0, lx1, lz0, lz1, ly = 1.1, 1.9, 1.2, 1.8, Y - 5e-4
    s.append(P._quad([lx0, ly, lz0], [lx1, ly, lz0], [lx1, ly, lz1],
                     [lx0, ly, lz1], bsdf=white,
                     emitter={"type": "area", "radiance": P.LIGHT},
                     id="light"))
    base_v, faces = P._icosphere(subdiv)
    nx, nz = 3, 2
    k = 0
    for i in range(nx):
        for j in range(nz):
            v = P._displace(base_v.copy(), seed=k)
            cx = (i + 0.5) * X / nx
            cz = (j + 0.75) * Z / (nz + 0.5)
            cy = 0.45 + 0.1 * ((i + j) % 3)
            v = v * 0.34 + np.asarray([cx, cy, cz], np.float32)
            bsdf = dict(MATERIALS[k])
            if "plastic" in bsdf["type"]:
                bsdf["diffuse_reflectance"] = GALLERY_ALBEDO[k]
            s.append(P.shapes.mesh(v, faces, bsdf=bsdf, id=f"blob{k}"))
            k += 1
    # its normal faces the back wall (+z): the camera sees its back
    s.append(P._quad([1.1, 1.05, 2.6], [1.9, 1.05, 2.6], [1.9, 1.6, 2.6],
                     [1.1, 1.6, 2.6], bsdf={"type": "twosided", "bsdf": {
                         "type": "roughconductor", "material": "Al",
                         "alpha": 0.1}}, id="metal"))
    s.append(P._quad([2.9, 0.05, 0.3], [2.1, 0.05, 0.3], [2.1, 1.2, 0.3],
                     [2.9, 1.2, 0.3], bsdf={"type": "thindielectric",
                                            "int_ior": "bk7"}, id="pane"))
    cam = P.Transform4.look_at(origin=[X / 2, 1.0, -2.6],
                               target=[X / 2, 0.8, 1.5], up=[0, 1, 0])
    sensor = {"type": "perspective", "to_world": np.asarray(cam.matrix),
              "fov": 50.0}
    return P.build_scene(s, sensor, **build_kw)


def occluder_scene(P, **build_kw):
    """tests/test_reparam.py's _occluder_scene from the presets module `P`
    of either package: a bright emissive wall at z = 0 and a small dark
    occluder at z = 1.5 whose left edge crosses the view of a camera at
    z = 4 (4 triangles: brute force). Returns (scene, the occluder's prim
    rows as numpy)."""
    T4, sh = P.Transform4, P.shapes
    wall = sh.rectangle(
        bsdf={"type": "diffuse", "reflectance": [0, 0, 0]},
        emitter={"type": "area", "radiance": [2.0] * 3},
        id="wall").transformed(np.asarray(T4.scale([2, 2, 1]).matrix))
    occ = sh.rectangle(
        bsdf={"type": "diffuse", "reflectance": [0.0, 0.0, 0.0]},
        id="occ").transformed(np.asarray(
            (T4.translate([0.6, 0, 1.5]) @ T4.scale([0.5, 0.5, 1])).matrix))
    cam = T4.look_at(origin=[0, 0, 4], target=[0, 0, 0], up=[0, 1, 0])
    scene = P.build_scene([occ, wall], {
        "type": "perspective", "to_world": np.asarray(cam.matrix),
        "fov": 35.0}, **build_kw)
    return scene, _rows_of_shape(scene, 0)


def _rows_of_shape(scene, shape):
    """The prim rows of shape `shape`, as numpy, from either package's
    scene (the port's tables may lie on the card)."""
    a = scene.prim_shape
    a = a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
    return np.nonzero(a == shape)[0]


def shadow_scene(P, **build_kw):
    """examples/occluder_pose_grad.py's build_occluder_scene (and
    tests/test_reparam.py's _shadow_scene) from the presets module `P` of
    either package: a diffuse floor, a small dark occluder at y = 1 and a
    small area light above it; the camera sees the floor alone, so the
    shadow's edge, which moves with the occluder, lies in the NEE and
    BSDF directions of the second path vertex (6 triangles: brute
    force). Returns (scene, the occluder's prim rows as numpy)."""
    T4, sh = P.Transform4, P.shapes
    floor = sh.rectangle(
        bsdf={"type": "diffuse", "reflectance": [0.8] * 3},
        id="floor").transformed(np.asarray(
            (T4.rotate([1, 0, 0], -90) @ T4.scale([2, 2, 1])).matrix))
    occ = sh.rectangle(
        bsdf={"type": "diffuse", "reflectance": [0.0] * 3},
        id="occ").transformed(np.asarray(
            (T4.translate([0.6, 1.0, 0]) @ T4.rotate([1, 0, 0], -90)
             @ T4.scale([0.25, 0.25, 1])).matrix))
    light = sh.rectangle(
        bsdf={"type": "diffuse", "reflectance": [0] * 3},
        emitter={"type": "area", "radiance": [30.0] * 3},
        id="light").transformed(np.asarray(
            (T4.translate([0.25, 2.0, 0]) @ T4.rotate([1, 0, 0], 90)
             @ T4.scale([0.12, 0.12, 1])).matrix))
    cam = T4.look_at(origin=[0.15, 0.55, 0.0], target=[0.25, 0.0, 0.0],
                     up=[0, 0, 1])
    scene = P.build_scene([occ, floor, light], {
        "type": "perspective", "to_world": np.asarray(cam.matrix),
        "fov": 50.0}, **build_kw)
    return scene, _rows_of_shape(scene, 0)


# gallery_lights' emitters: every shapeless kind of config 3 but the
# constant one (a scene holds one environment emitter: the sky)
LIGHTS = (
    {"type": "point", "position": [1.5, 1.6, 1.0],
     "intensity": [2.0, 1.8, 1.5], "id": "point"},
    {"type": "spot", "position": [0.5, 1.9, 0.6], "direction": [0, -1, 0.2],
     "intensity": [6.0, 6.0, 6.0], "cutoff_angle": 25.0, "id": "spot"},
    {"type": "directional", "direction": [0.3, -1.0, 0.4],
     "irradiance": [1.2, 1.1, 1.0], "id": "sun"},
    {"type": "projector", "position": [2.6, 1.5, 0.1],
     "direction": [-0.4, -0.5, 1.0], "irradiance": [3.0, 2.4, 1.8],
     "fov": 40.0, "id": "projector"},
    {"type": "envmap", "scale": 1.0, "id": "sky"},   # + the sky's data
)


def gallery_lights(P, subdiv=SUBDIV, **build_kw):
    """mesh_gallery(subdiv)'s room (without its ceiling and area light)
    and blobs, built from the presets module `P` of either package, lit by
    LIGHTS: a point, a spot, a directional light through the open
    ceiling, an untextured projector and veach_mis(envmap=True)'s sky.
    Its shadow rays toward the sun and the sky run to t_max ~1e7."""
    from mitsuba2_tpu_torch.scene.presets import procedural_sky
    X, Y, Z = 3.0, 2.0, 3.0
    white = {"type": "diffuse", "reflectance": P.WHITE}
    s = [
        P._quad([0, 0, 0], [0, 0, Z], [X, 0, Z], [X, 0, 0], bsdf=white,
                id="floor"),
        P._quad([0, 0, Z], [0, Y, Z], [X, Y, Z], [X, 0, Z], bsdf=white,
                id="back"),
        P._quad([X, 0, 0], [X, 0, Z], [X, Y, Z], [X, Y, 0],
                bsdf={"type": "diffuse", "reflectance": P.RED}, id="left"),
        P._quad([0, 0, 0], [0, Y, 0], [0, Y, Z], [0, 0, Z],
                bsdf={"type": "diffuse", "reflectance": P.GREEN},
                id="right"),
    ]
    base_v, faces = P._icosphere(subdiv)
    for k in range(6):
        i, j = divmod(k, 2)
        v = P._displace(base_v.copy(), seed=k)
        v = v * 0.34 + np.asarray([(i + 0.5) * X / 3,
                                   0.45 + 0.1 * ((i + j) % 3),
                                   (j + 0.75) * Z / 2.5], np.float32)
        s.append(P.shapes.mesh(v, faces, bsdf={
            "type": "diffuse", "reflectance": GALLERY_ALBEDO[k]},
            id=f"blob{k}"))
    cam = P.Transform4.look_at(origin=[X / 2, 1.0, -2.6],
                               target=[X / 2, 0.8, 1.5], up=[0, 1, 0])
    sensor = {"type": "perspective", "to_world": np.asarray(cam.matrix),
              "fov": 50.0}
    lights = [dict(e, data=procedural_sky()) if e["type"] == "envmap"
              else dict(e) for e in LIGHTS]
    return P.build_scene(s, sensor, emitters=lights, **build_kw)


# gallery_textured's texture sizes, as fractions of the floor's
TEX_FLOOR = 1024
TEX_SEED = 17


def gallery_textures(res=TEX_FLOOR, seed=TEX_SEED):
    """gallery_textured's images from `seed`, the floor's res x res and
    the others smaller (res / 4, / 16, / 8): the floor's albedo (8 x 8
    tiles and noise), the back wall's roughness in [0.05, 0.4], the right
    wall's tangent-space normals (of a height field of sines), the light's
    radiance and the projector's slide."""
    rng = np.random.default_rng(seed)
    q = max(res // 4, 2)
    y, x = np.mgrid[0:res, 0:res]
    tile = ((x * 8 // res + y * 8 // res) % 2)[..., None]
    floor = np.where(tile, [0.75, 0.7, 0.6], [0.3, 0.26, 0.22]) \
        + 0.1 * rng.uniform(-1, 1, (res, res, 3))
    alpha = rng.uniform(0.05, 0.4, (q, q))
    # h = 0.2 sin(3x + p0) + 0.1 sin(5x + 2y + p1) + 0.1 sin(4y + p2)
    yq, xq = np.mgrid[0:q, 0:q] / q * 2 * np.pi
    ph = rng.uniform(0, 2 * np.pi, 3)
    w = np.cos(5 * xq + 2 * yq + ph[1])
    dh_dx = 0.6 * np.cos(3 * xq + ph[0]) + 0.5 * w
    dh_dy = 0.2 * w + 0.4 * np.cos(4 * yq + ph[2])
    n = np.stack([-dh_dx, -dh_dy, np.ones_like(xq)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    m = max(res // 16, 2)
    light = np.asarray([18.4, 15.6, 8.0]) * (
        0.6 + 0.8 * rng.uniform(size=(m, m, 1)))
    slide = rng.uniform(0.0, 3.0, (max(res // 8, 2),) * 2 + (3,))
    return {k: np.asarray(v, np.float32) for k, v in dict(
        floor=np.clip(floor, 0.0, 1.0), alpha=alpha, normals=0.5 * (n + 1),
        light=light, slide=slide).items()}


def _scale_uv(s):
    return np.diag([s, s, 1.0]).astype(np.float32)


def gallery_textured(P, subdiv=SUBDIV, res=TEX_FLOOR, **build_kw):
    """mesh_gallery(subdiv)'s room, light and blobs (the same seeds and
    placement), built from the presets module `P` of either package, with
    config 4's textures (gallery_textures(res)) and the wrappers: a
    bilinear albedo on the floor (4 x 4 repeats), a textured roughness on
    the back wall's rough conductor, a normal map over the right wall and
    a checkerboard bump map (8 x 8 repeats) over the left, a textured
    area light and a textured projector aimed at the back wall; blob0
    masked (opacity 0.5) over a rough plastic, blob1 a blend (0.35) of a
    diffuse and a rough conductor, blob2 null, the others diffuse."""
    X, Y, Z = 3.0, 2.0, 3.0
    tx = gallery_textures(res)
    white = {"type": "diffuse", "reflectance": P.WHITE}
    s = [
        P._quad([0, 0, 0], [0, 0, Z], [X, 0, Z], [X, 0, 0], bsdf={
            "type": "diffuse", "reflectance": {
                "type": "bitmap", "data": tx["floor"], "to_uv": _scale_uv(4),
                "id": "floor_albedo"}}, id="floor"),
        P._quad([0, Y, 0], [X, Y, 0], [X, Y, Z], [0, Y, Z], bsdf=white,
                id="ceiling"),
        P._quad([0, 0, Z], [0, Y, Z], [X, Y, Z], [X, 0, Z], bsdf={
            "type": "roughconductor", "material": "Al", "alpha": {
                "type": "bitmap", "data": tx["alpha"],
                "id": "back_roughness"}}, id="back"),
        P._quad([X, 0, 0], [X, 0, Z], [X, Y, Z], [X, Y, 0], bsdf={
            "type": "bumpmap", "scale": 0.5, "bumpmap": {
                "type": "checkerboard", "color0": 0.2, "color1": 0.8,
                "to_uv": _scale_uv(8), "id": "left_height"},
            "bsdf": {"type": "diffuse", "reflectance": P.RED}}, id="left"),
        P._quad([0, 0, 0], [0, Y, 0], [0, Y, Z], [0, 0, Z], bsdf={
            "type": "normalmap", "normalmap": {
                "type": "bitmap", "data": tx["normals"],
                "id": "right_normals"},
            "bsdf": {"type": "diffuse", "reflectance": P.GREEN}},
            id="right"),
    ]
    lx0, lx1, lz0, lz1, ly = 1.1, 1.9, 1.2, 1.8, Y - 5e-4
    s.append(P._quad([lx0, ly, lz0], [lx1, ly, lz0], [lx1, ly, lz1],
                     [lx0, ly, lz1], bsdf=white, emitter={
                         "type": "area", "radiance": {
                             "type": "bitmap", "data": tx["light"],
                             "id": "light_radiance"}}, id="light"))
    blobs = [{"type": "mask", "opacity": 0.5, "bsdf": {
                  "type": "roughplastic", "alpha": 0.2,
                  "diffuse_reflectance": GALLERY_ALBEDO[0]}},
             {"type": "blendbsdf", "weight": 0.35, "bsdfs": [
                 {"type": "diffuse", "reflectance": GALLERY_ALBEDO[1]},
                 {"type": "roughconductor", "material": "Cu",
                  "alpha": 0.15}]},
             {"type": "null"}]
    base_v, faces = P._icosphere(subdiv)
    for k in range(6):
        i, j = divmod(k, 2)
        v = P._displace(base_v.copy(), seed=k)
        v = v * 0.34 + np.asarray([(i + 0.5) * X / 3,
                                   0.45 + 0.1 * ((i + j) % 3),
                                   (j + 0.75) * Z / 2.5], np.float32)
        bsdf = (blobs[k] if k < len(blobs) else
                {"type": "diffuse", "reflectance": GALLERY_ALBEDO[k]})
        s.append(P.shapes.mesh(v, faces, bsdf=bsdf, id=f"blob{k}"))
    cam = P.Transform4.look_at(origin=[X / 2, 1.0, -2.6],
                               target=[X / 2, 0.8, 1.5], up=[0, 1, 0])
    sensor = {"type": "perspective", "to_world": np.asarray(cam.matrix),
              "fov": 50.0}
    projector = {"type": "projector", "position": [1.5, 1.3, 0.3],
                 "direction": [0.0, -0.15, 1.0], "fov": 35.0,
                 "irradiance": {"type": "bitmap", "data": tx["slide"],
                                "id": "slide"}, "id": "projector"}
    return P.build_scene(s, sensor, emitters=[projector], **build_kw)


def phase_kernels_vs_twins(torch, mt, dev):
    """Each path's scene (and the sphere field under "bvh8") and its
    kernels against their twins on probe rays; returns the paths' scenes
    and the extra one."""
    from mitsuba2_tpu_torch.kernels import traverse
    t0 = time.perf_counter()
    scenes = {"gallery": mt.mesh_gallery(subdiv=SUBDIV, device=dev),
              "instanced": mt.instanced_field(**FIELD, device=dev)}
    field = scenes["instanced"]
    check(field.has_instances, "instanced_field was flattened, not shared")
    log(f"phase 2: built mesh_gallery(subdiv={SUBDIV}) and "
        f"instanced_field(n={FIELD['n']}, subdiv={FIELD['subdiv']}) in "
        f"{time.perf_counter() - t0:.1f} s; instanced: {field.n_prims} "
        f"stored prims, {field.inst_inv.shape[0]} instances, walk fuel "
        f"{field.inst_mxu_fuel + 64}")
    for path, kw in SPHERE_FIELDS.items():
        t0 = time.perf_counter()
        scene = scenes[path] = sphere_field(mt, device=dev, **kw)
        check(scene.has_spheres and scene.has_instances == (
            path == "spheres_instanced"), f"{path}: policy took the other "
              "route (flattened or shared)")
        fuel = (scene.inst_fuel if scene.has_instances
                else scene.bvh_node.shape[0]) + 64
        log(f"phase 2: built sphere_field(n={kw['n']}, subdiv="
            f"{kw['subdiv']}) in {time.perf_counter() - t0:.1f} s: "
            f"{'shared BLAS' if scene.has_instances else 'flattened'}, "
            f"{scene.n_prims} stored prims "
            f"({int((scene.prim_type == 1).sum())} spheres), "
            f"{scene.bvh_node.shape[0]} BVH2 rows, walk fuel {fuel}")
    extra = {}
    for name in ("gallery_bvh8", "gallery_bvh8mxu", "spheres_bvh8"):
        t0 = time.perf_counter()
        with path_switches(name) as b:
            scene = (mt.mesh_gallery(subdiv=SUBDIV, device=dev)
                     if name.startswith("gallery") else
                     sphere_field(mt, device=dev, **SPHERE_FIELDS["spheres"]))
            ks = kernels_of(scene, b)
        child = ks["tabs"][0]
        check(not scene.has_instances and scene.has_spheres
              == (name == "spheres_bvh8"), f"{name}: wrong scene")
        (extra if name == "spheres_bvh8" else scenes)[name] = scene
        log(f"phase 2: built {name} under set_backend({b!r}) in "
            f"{time.perf_counter() - t0:.1f} s: {child.shape[0] // 8} BVH8 "
            f"nodes, depth {ks['extra'][-2] - traverse.BVH8_STACK_MARGIN}, "
            f"walk fuel {ks['extra'][-1]}, tables "
            f"{sum(a.numel() * a.element_size() for a in ks['tabs']) / 2**20:.2f}"
            " MiB")
    # the dense switch is read at dispatch, the color mode at render: the
    # gallery's own scene
    gallery = scenes["gallery_dense"] = scenes["gallery"]
    scenes["gallery_spectral"] = gallery
    scenes.update(_material_scenes(mt, dev))
    # config 5: reparam is read at render; the Cornell box takes brute
    # force
    scenes["cornell_reparam"] = mt.cornell_box(device=dev)
    scenes["gallery_reparam"] = gallery
    with path_switches("gallery_dense"):
        ks = kernels_of(gallery)
    check(ks["closest"] == "dense_closest_hit", "the dense switch did not "
          "route the gallery to K8")
    tabs_mib = sum(a.numel() * a.element_size() for a in ks["tabs"]) / 2**20
    log(f"phase 2: gallery_dense: the gallery's scene with the dense switch "
        f"on: {gallery.mxu_ccs.shape[0]} clusters of {gallery.cluster_k} "
        f"slots, {int(gallery.mxu_ccount.sum())} of them up to each "
        f"cluster's last real slot (mxu_ccount), tables {tabs_mib:.2f} MiB")
    ok = True
    probes = {}
    for name, scene in {**scenes, **extra}.items():
        if PATH_KERNELS.get(name, True):
            with path_switches(name):
                ok &= _kernels_vs_twins(torch, name, scene, probes, dev)
    check(ok, "a kernel disagrees with its twin on the probe rays")
    return scenes, extra


def _material_scenes(mt, dev):
    """The paths of config 2's materials: veach_mis() under "auto" (brute
    force) and under "pallas" (the BVH2 walk, K3), and gallery_materials
    at SUBDIV (the cluster walk, K1 and K2); config 3's:
    veach_mis(envmap=True) under "auto" and "pallas", and gallery_lights
    at SUBDIV (K1 and K2); and config 4's gallery_textured at SUBDIV (K1
    and K2)."""
    from mitsuba2_tpu_torch.scene import presets
    veach = functools.partial(mt.veach_mis, device=dev)
    sky = functools.partial(mt.veach_mis, envmap=True, device=dev)
    make = {"veach": veach, "veach_bvh2": veach,
            "gallery_materials": functools.partial(
                gallery_materials, presets, SUBDIV, device=dev),
            "veach_spectral": sky, "veach_spectral_bvh2": sky,
            "gallery_lights": functools.partial(gallery_lights, presets,
                                                SUBDIV, device=dev),
            "gallery_textured": functools.partial(
                gallery_textured, presets, SUBDIV, device=dev)}
    out = {}
    for name in make:
        t0 = time.perf_counter()
        with path_switches(name):
            scene = out[name] = make[name]()
        walk = ("BVH2" if scene.bvh_node is not None else "cluster"
                if scene.mxu_node_f is not None else "brute force")
        log(f"phase 2: built {name} in {time.perf_counter() - t0:.1f} s: "
            f"{scene.n_prims} prims, {len(scene.mat_families)} BSDF "
            f"families {scene.mat_families}, twosided "
            f"{scene.has_twosided}, {walk}")
        check(walk == ("BVH2" if name.endswith("bvh2") else "brute force"
                       if name.startswith("veach") else "cluster"),
              f"{name} took the {walk} walk")
        check((scene.envmap is not None) == (name in (
            "veach_spectral", "veach_spectral_bvh2", "gallery_lights")),
              f"{name}: envmap")
        atlas = scene.textures
        check((atlas is not None) == (name == "gallery_textured"),
              f"{name}: textures")
        if atlas is not None:
            log(f"phase 2: {name}: {atlas.data.shape[0]} textures in an "
                f"atlas of {tuple(atlas.data.shape[1:3])}, "
                f"{atlas.data.numel() * 4 / 2**20:.1f} MiB, and "
                f"{len(atlas.level_shapes)} mip levels, "
                f"{atlas.mips.numel() * 4 / 2**20:.1f} MiB; textured "
                f"slots by family {[(f, sorted(k)) for f, k in scene.family_tex if k]}"
                f", emitter types {scene.emitter_tex}")
    return out


def _kernels_vs_twins(torch, name, scene, probes, dev):
    """Phase 2 for one path (or the extra scene), under its switches;
    `probes` holds each scene's probe rays, made on its first path.
    Returns whether every kernel agreed with its twin (bit for bit:
    BIT_EQUAL, now every walk kernel, K3's and K6's any hits included,
    and K8)."""
    from mitsuba2_tpu_torch.core.vec import Vec3
    from mitsuba2_tpu_torch.kernels import traverse
    from mitsuba2_tpu_torch.probe_rays import KINDS, probe_rays

    def closest_np(o, d, t_max):
        o, d = Vec3(*planar(torch, o, dev)), Vec3(*planar(torch, d, dev))
        t_max = torch.from_numpy(t_max).to(dev)
        if scene.has_instances:
            t, prim, _, _, inst = traverse.ray_intersect_instanced(
                scene, o, d, t_max)
            return (t.cpu().numpy(), prim.cpu().numpy(),
                    inst.cpu().numpy())
        t, prim, _, _ = traverse.ray_intersect_preliminary(
            scene, o, d, t_max)
        return t.cpu().numpy(), prim.cpu().numpy(), None

    # the paths on one scene share the first one's probe rays
    base = SAME_SCENE.get(name, name)
    if base not in probes:
        probes[base] = probe_rays(scene, N_PROBE, 0, closest_np)
    rays = probes[base]
    ks = kernels_of(scene, BACKEND.get(name, "auto"))
    ok = True
    for kind in KINDS:
        o, d, tm = rays[kind]
        args = (planar(torch, o, dev) + planar(torch, d, dev)
                + [torch.from_numpy(tm).to(dev)])
        c = compare(torch, ks, args)
        good = passes(c, **exactness(name, ks))
        ok &= good
        log(f"phase 2: {name:17s} {kind:7s} {'ok  ' if good else 'FAIL'} "
            f"hit {c['hit_frac']:.4f} hit-mask-equal {c['hit_equal']} "
            f"prim-agree {c['slot_agree']:.6f} t-max-abs-err "
            f"{c['t_max_abs_err']:.3e} uv-max-abs-err "
            f"{c['uv_max_abs_err']:.3e} occ-agree {c['occ_agree']:.6f} "
            f"closest bit-equal {c['closest_bit_equal']} all bit-equal "
            f"{c['bit_equal']}")
        for closest in (True, False):
            log(f"  {ks['closest' if closest else 'any']} work: "
                + work_line(c["closest_stats" if closest else
                              "any_stats"], closest, ks, scene, len(tm)))
    return ok


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------

# the traversal entry points, by the kind of kernel they reach
ENTRY_KIND = {"ray_intersect_preliminary": "closest", "ray_test": "any",
              "ray_intersect_instanced": "closest",
              "ray_test_instanced": "any",
              "ray_intersect_bvh8": "closest", "ray_test_bvh8": "any",
              "ray_intersect_bvh8mxu": "closest", "ray_test_bvh8mxu": "any"}


def _recorders(traverse, record, ks):
    """Stand-ins for the traversal entry points that keep a copy of each
    call's rays (the kernel wrappers' inputs) under the name of the
    kernel the scene's entry reaches (`ks`, kernels_of's), then make the
    call."""
    orig = {k: getattr(traverse, k) for k in ENTRY_KIND}

    def wrap(name):
        def rec(scene, ray_o, ray_d, t_max):
            record.append((ks[ENTRY_KIND[name]], [a.clone() for a in (
                ray_o.x, ray_o.y, ray_o.z, ray_d.x, ray_d.y, ray_d.z,
                t_max)]))
            return orig[name](scene, ray_o, ray_d, t_max)
        return rec
    return orig, {k: wrap(k) for k in orig}


def kernel_ms(torch, fn, reps):
    """Device time of one call of `fn`, the mean over `reps` back-to-back
    launches. The device sleeps first while the host queues them all, so
    the events time the kernels and not the wrappers' host cost, which
    would otherwise show between launches of the sub-millisecond BVH2
    walks."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def time_launch(torch, ks, scene, name, rays, reps=KERNEL_REPS):
    """One launch of kernel `name` (of `ks`, kernels_of's) on `rays`: its
    device time over `reps` launches, its agreement with its twin, the
    twin's time, the work the twin counted and the bound of that work."""
    tabs, extra = ks["tabs"], ks["extra"]
    n = rays[0].numel()
    ms = kernel_ms(torch, lambda: wrapper(name)(*tabs, *rays, *extra), reps)
    c = compare(torch, ks, list(rays))
    closest = name == ks["closest"]
    st = c["closest_stats" if closest else "any_stats"]
    live = int((rays[6] > 0).sum())
    bound_ms, bound_by = work_bound(st, closest, ks, scene, n, live)
    return dict(ms=ms, c=c, st=st, n=n, live=live,
                plain_ms=c["closest_plain_ms" if closest else "any_plain_ms"],
                bound_ms=bound_ms, bound_by=bound_by,
                err=c["t_max_abs_err"] if closest else c["occ_max_abs_err"])


def work_bound(st, closest, ks, scene, n, live):
    """The least time (ms, and "operations" or "bytes") of a launch over
    `n` lanes, `live` of them with t_max > 0, that does the work `st` (a
    twin's counts) with the tables of `ks` (kernels_of's)."""
    # the work these rays need: an any-hit lane stops at its first hit, so
    # it tests only part of its last cluster or leaf; a cluster's padding
    # slots and a BVH8 node's empty child slots, which the kernels test
    # too, are not counted; a BVH8 walk slab-tests a node's children at a
    # fresh visit, and one more a closest-hit advance
    slabs = (st.get("node_steps", 0) + st.get("child_tests", 0)
             + (st.get("advances", 0) if closest else 0))
    ops = (st.get("real_slot_tests", 0) * FLOPS_PER_SLOT
           + slabs * FLOPS_PER_NODE
           + st.get("instance_entries", 0) * FLOPS_PER_ENTRY
           + st.get("tri_tests", 0) * FLOPS_PER_TRI
           + st.get("sphere_tests", 0) * FLOPS_PER_SPHERE)
    # t and slot or prim (and u, v where the walk emits them, the instance
    # on the instanced ones) a lane, or the occlusion byte
    out_bytes = (4 * (2 + 2 * ks["uv"] + scene.has_instances)
                 if closest else 1)
    # the tables once; every lane's t_max; o and d (24 bytes) only of a
    # live lane: a kernel thread whose t_max <= 0 reads nothing more. The
    # pair walk's child-pair rows are a copy of what bvh_node and bvh_link
    # hold, which the function needs: not charged
    tabs_bytes = sum(a.numel() * a.element_size() for a in ks["tabs"]
                     if a is not scene.bvh_pair)
    nbytes = 4 * n + 24 * live + tabs_bytes + n * out_bytes
    t_ops, t_bytes = ops / PEAK_FP32_PER_S, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def work_line(st, closest, ks, scene, n):
    """A twin's work counts `st` over `n` rays per lane, and the bound of
    a 1 048 576-lane launch of such rays, all live: what a prediction of
    a kernel's time starts from."""
    lanes = 1 << 20
    ms, by = work_bound({k: v * lanes / n for k, v in st.items()}, closest,
                        ks, scene, lanes, lanes)
    return (", ".join(f"{st[k] / n:.4f} {k.replace('_', ' ')}"
                      for k in WORK_COUNTS if k in st)
            + f"; 1M such lanes: bound {ms:.4f} ms by {by}")


def log_launch(name, i, r):
    c, st, n = r["c"], r["st"], r["n"]
    work = ", ".join(f"{st[k] / n:.4f} {k.replace('_', ' ')}"
                     for k in WORK_COUNTS if k in st)
    log(f"  {name} launch {i}: {n} lanes ({r['live'] / n:.4f} live), "
        f"{r['ms']:.3f} ms (kernel), {r['plain_ms']:.1f} ms (twin, all "
        f"lanes), bound {r['bound_ms']:.4f} ms by {r['bound_by']}; per lane "
        f"{work}; hit {c['hit_frac']:.4f}, prim-agree "
        f"{c['slot_agree']:.6f}, occ-agree {c['occ_agree']:.6f}")


def phase_main_path(torch, mt, path, scene, card, also=None):
    """Renders `path`: warm-up (recording each kernel call's inputs), then
    3 timed renders with every wrapper's count set to 0 before each; then
    each launch of the path's kernels timed and held against its twin (bit
    for bit: BIT_EQUAL and K8), and, with `also` (a scene under "bvh8"),
    K6's on the same inputs. Returns the kernels' rows, the median render
    ms and each kernel's launches (time_launch's records)."""
    from mitsuba2_tpu_torch.kernels import traverse
    cfg = mt.RenderConfig(**PATH_RENDER.get(path, RENDER))
    names = list(EXPECTED_LAUNCHES[path])
    # brute force (veach) reaches no kernel: nothing to record or time
    ks = (kernels_of(scene, BACKEND.get(path, "auto"))
          if PATH_KERNELS[path] else None)

    record = []
    orig, rec = _recorders(traverse, record, ks) if ks else ({}, {})
    for k, f in rec.items():
        setattr(traverse, k, f)
    try:
        mt.render(scene, cfg, seed=0)
    finally:
        for k, f in orig.items():
            setattr(traverse, k, f)
    torch.cuda.synchronize()

    times, counts = [], None
    # every path's scene stays resident: the render's own memory is its
    # peak above what was allocated before it, beside its scene's tables
    scene_bytes = sum(v.numel() * v.element_size()
                      for v in vars(scene).values() if torch.is_tensor(v))
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for r in range(3):
        for k in names:
            wrapper(k).launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = mt.render(scene, cfg, seed=r)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        run_counts = {k: wrapper(k).launches for k in names}
        counts = counts or run_counts
        check(run_counts == counts, f"{path}: launch counts vary: {run_counts}")
        img = img.float()
        check(tuple(img.shape) == (cfg.height, cfg.width, 3),
              f"{path}: image shape {tuple(img.shape)}")
        check(bool(torch.isfinite(img).all()),
              f"{path}: image has non-finite values")
        mean = float(img.mean())
        check(mean > 0.0, f"{path}: image mean {mean}")
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(times)
    n_passes = cfg.spp // cfg.spp_per_pass
    log(f"phase 3: {path}: render {cfg.width}x{cfg.height}x{cfg.spp}spp "
        f"in {n_passes} pass(es), depth {cfg.max_depth} on {card}: median "
        f"{med * 1e3:.1f} ms of {[round(t * 1e3, 1) for t in times]}, "
        f"{rays_per_pass(cfg) * n_passes / med / 1e6:.3f} Mrays/s, peak "
        f"memory "
        f"{peak / 2**20:.0f} MiB of which {resident / 2**20:.0f} MiB "
        f"resident before the render (all paths' scenes): the render's "
        f"working set {(peak - resident) / 2**20:.0f} MiB over its scene's "
        f"{scene_bytes / 2**20:.0f} MiB of tables; image mean {mean:.6f}")
    log(f"kernels launched per render: {json.dumps(counts)}")
    for k, n in EXPECTED_LAUNCHES[path].items():
        check(counts[k] == n, f"{path}: {k}: {counts[k]} launches, "
                              f"expected {n}")
        check(n == 0 or counts[k] > 0, f"{k} was not launched on {path}")

    if ks is None:
        return [], med * 1e3, {}
    # each kernel at the main path's shapes: time, twin, bound
    per = {k: [] for k in (ks["closest"], ks["any"])}
    for i, (name, rays) in enumerate(record):
        check(name in per, f"{path}: {name} was called on the main path")
        r = time_launch(torch, ks, scene, name, rays,
                        PATH_REPS.get(path, KERNEL_REPS))
        check(passes(r["c"], **exactness(path, ks)),
              f"{name} launch {i} disagrees with its twin: {r['c']}")
        per[name].append(r)
        log_launch(name, i, r)
    if also is not None:
        # K6 on the very rays the path gave its own kernels
        k8 = kernels_of(also, "bvh8")
        for i, (name, rays) in enumerate(record):
            name8 = k8["closest" if name == ks["closest"] else "any"]
            r = time_launch(torch, k8, also, name8, rays)
            check(passes(r["c"], **exactness("spheres_bvh8", k8)),
                  f"{name8} on {path}'s launch {i} disagrees with its "
                  f"twin: {r['c']}")
            log_launch(f"{name8} (on {path}'s {name} inputs)", i, r)
    rows = []
    for name, rs in per.items():
        bound_by = [r["bound_by"] for r in rs]
        row = {
            "name": name, "route": "cuda", "source": SRC,
            "replaces": REPLACES[name][0],
            "launches": counts[name],
            "max_abs_err": max(r["err"] for r in rs),
            "ms": statistics.fmean(r["ms"] for r in rs),
            "plain_ms": statistics.fmean(r["plain_ms"] for r in rs),
            "bound_ms": statistics.fmean(r["bound_ms"] for r in rs),
            "bound_by": max(set(bound_by), key=bound_by.count),
            "library_ms": None,
        }
        if REPLACES[name][1]:
            row["also_replaces"] = REPLACES[name][1]
        rows.append(row)
    return rows, med * 1e3, per


def phase_reparam_path(torch, mt, path, scene, card, render_ms):
    """A reparam=True path after phase 3: its rates by bench.py's
    cornell_reparam accounting (:379-387): the rays counted as a plain
    render's, and all rays with the K auxiliary rays of each warp site (1
    camera site + 2 a bounce); then its image at seed 0 against the plain
    render's (reparam=False, the same seed): the primal is unchanged,
    within atol 1e-5 on the Cornell box; the gallery's, whose camera and
    bounce rays take the reparameterized directions' last bits into its
    walk, printed."""
    cfg = mt.RenderConfig(**PATH_RENDER[path])
    passes = cfg.spp // cfg.spp_per_pass
    counted = rays_per_pass(cfg) * passes
    lanes = cfg.width * cfg.height * cfg.spp_per_pass
    aux = lanes * cfg.reparam_kaux * (1 + 2 * (cfg.max_depth - 1)) * passes
    img = mt.render(scene, cfg, seed=0)
    plain = mt.render(scene, cfg.replace(reparam=False), seed=0)
    torch.cuda.synchronize()
    err = (img - plain).abs()
    # what the auxiliary rays cost the forward, which traces them whether
    # or not a gradient is asked (as the JAX package does)
    plain_ms, plain_t = median_ms(torch, lambda r: mt.render(
        scene, cfg.replace(reparam=False), seed=r))
    log(f"phase 3: {path}: {counted / render_ms / 1e3:.3f} Mrays/s counted "
        f"({counted} rays, bench.py's cornell_reparam count), "
        f"{(counted + aux) / render_ms / 1e3:.3f} Mrays/s with the {aux} "
        f"auxiliary rays (K {cfg.reparam_kaux}, its _all_rays count), "
        f"render median {render_ms:.1f} ms on {card}; the same render with "
        f"reparam=False {plain_ms:.1f} ms (median of "
        f"{[round(t, 1) for t in plain_t]}): the warps cost "
        f"{render_ms - plain_ms:.1f} ms a render, "
        f"{render_ms / plain_ms:.2f}x")
    log(f"phase 3: {path}: image against the plain render (seed 0): max "
        f"abs diff {float(err.max()):.3e}, "
        f"{float((err <= 1e-5).all(-1).float().mean()):.6f} of pixels "
        f"within 1e-5, means {float(img.mean()):.6f} and "
        f"{float(plain.mean()):.6f}")
    if path == "cornell_reparam":
        check(float(err.max()) <= 1e-5, f"{path}: the reparameterized image "
              "is not the plain render's")


# ---------------------------------------------------------------------------
# Phase 4: small renders on the card against the CPU
# ---------------------------------------------------------------------------

def _shared(make, device):
    """`make(device)` with shared BLAS forced: the port keeps the JAX
    package's policy, which flattens a scene this small."""
    old = os.environ.get("MI_FLATTEN_INSTANCES")
    os.environ["MI_FLATTEN_INSTANCES"] = "0"
    try:
        scene = make(device)
    finally:
        if old is None:
            del os.environ["MI_FLATTEN_INSTANCES"]
        else:
            os.environ["MI_FLATTEN_INSTANCES"] = old
    check(scene.has_instances, "a small instanced scene was flattened")
    return scene


def phase_small_renders(torch, mt, dev):
    from mitsuba2_tpu_torch.scene import presets
    cfg = mt.RenderConfig(width=32, height=32, spp=2, spp_per_pass=1,
                          max_depth=3, rr_depth=2)
    small_field = functools.partial(sphere_field, mt, 6, 2)
    gallery = functools.partial(mt.mesh_gallery, subdiv=1)
    small_inst = functools.partial(_shared, lambda d_: mt.instanced_field(
        n=6, subdiv=2, device=d_))
    for name, mk, sw in (
            ("mesh_gallery(subdiv=1)", lambda d: gallery(device=d), {}),
            ("instanced_field(n=6, subdiv=2), shared BLAS", small_inst, {}),
            ("cornell_box", lambda d: mt.cornell_box(device=d), {}),
            ("furnace (brute force, a sphere)",
             lambda d: mt.furnace(device=d), {}),
            ("sphere_field(n=6, subdiv=2), flattened (BVH2)", small_field,
             {}),
            ("sphere_field(n=6, subdiv=2), shared BLAS (BVH2)",
             lambda d: _shared(small_field, d), {}),
            ("mesh_gallery(subdiv=1) under bvh8 (K6)",
             lambda d: gallery(device=d), dict(backend="bvh8")),
            ("sphere_field(n=6, subdiv=2), flattened, under bvh8 (K6)",
             small_field, dict(backend="bvh8")),
            ("mesh_gallery(subdiv=1) under bvh8mxu (K7)",
             lambda d: gallery(device=d), dict(backend="bvh8mxu")),
            ("mesh_gallery(subdiv=1), dense sweep (K8)",
             lambda d: gallery(device=d), dict(dense="1")),
            ("mesh_gallery(subdiv=1), MXU_LEAVES off (K3)",
             lambda d: gallery(device=d), dict(leaves=False)),
            ("instanced_field(n=6, subdiv=2), shared BLAS, MXU_LEAVES off "
             "(K4)", small_inst, dict(leaves=False)),
            ("veach_mis() (brute force)",
             lambda d: mt.veach_mis(device=d), {}),
            ("veach_mis() under pallas (K3)",
             lambda d: mt.veach_mis(device=d), dict(backend="pallas")),
            ("gallery_materials(subdiv=1) (K1, K2)",
             lambda d: gallery_materials(presets, 1, device=d), {}),
            ("spectral: veach_mis(envmap=True) (brute force)",
             lambda d: mt.veach_mis(envmap=True, device=d), {}),
            ("spectral: veach_mis(envmap=True) under pallas (K3)",
             lambda d: mt.veach_mis(envmap=True, device=d),
             dict(backend="pallas")),
            ("spectral: mesh_gallery(subdiv=1) (K1, K2)",
             lambda d: gallery(device=d), {}),
            ("spectral: gallery_lights(subdiv=1) (K1, K2)",
             lambda d: gallery_lights(presets, 1, device=d), {}),
            ("gallery_textured(subdiv=1), 64x64 textures (K1, K2)",
             lambda d: gallery_textured(presets, 1, 64, device=d), {}),
            ("spectral: gallery_textured(subdiv=1), 64x64 textures (K1, K2)",
             lambda d: gallery_textured(presets, 1, 64, device=d), {})):
        c = cfg.replace(color_mode="spectral") if name.startswith(
            "spectral") else cfg
        with switches(**sw):
            img_c = mt.render(mk("cpu"), c, seed=5, device="cpu").numpy()
            img_g = mt.render(mk(dev), c, seed=5).cpu().numpy()
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
    if "cluster_" in low or "bvh" in low or "dense_" in low:
        return "traversal kernels"
    if "sort" in low or "radix" in low:
        return "presort (torch.sort)"
    if "index" in low or "gather" in low or "scatter" in low:
        return "gathers and scatters"
    return "elementwise and reductions"


def range_kernels(prof, range_name):
    """{kernel name: [device ms, launches]} of the kernels the CPU ops
    inside the profiler ranges named `range_name` launched."""
    out = {}

    def walk(e):
        for k in getattr(e, "kernels", ()):
            v = out.setdefault(k.name, [0.0, 0])
            v[0] += k.duration / 1e3
            v[1] += 1
        for c in e.cpu_children:
            walk(c)

    for e in prof.events():
        if e.name == range_name and not str(e.device_type).endswith("CUDA"):
            walk(e)
    return out


def phase_profile(torch, mt, path, scene, render_ms):
    """One render of `path` under torch.profiler: device time by kernel
    and by kind (on a scene with textures, the kernels launched inside
    its texture lookups as a kind of their own), and the device's busy
    share of the render's wall time, profiled (the profiler's host cost
    inflates it) and unprofiled (`render_ms`, phase 3's median). A path of
    PROFILE_ONE_PASS profiles one of its passes, which do the same work
    (no Russian roulette before rr_depth), and counts a render as that
    many of them."""
    from mitsuba2_tpu_torch.render.texture import TEXTURE_RANGE
    from torch.profiler import ProfilerActivity, profile
    cfg = mt.RenderConfig(**PATH_RENDER.get(path, RENDER))
    passes = 1
    if path in PROFILE_ONE_PASS:
        check(cfg.rr_depth >= cfg.max_depth, f"{path}: Russian roulette "
              "makes its passes' work differ")
        passes = cfg.spp // cfg.spp_per_pass
        cfg = cfg.replace(spp=cfg.spp_per_pass)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mt.render(scene, cfg, seed=11)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # kernel rows only: an operator's row repeats its kernels' time,
        # and a profiler range's device-side row spans its kernels
        if (str(getattr(e, "device_type", "")).endswith("CUDA")
                and e.key not in RANGES):
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
    if scene.textures is not None:
        tex = range_kernels(prof, TEXTURE_RANGE)
        lookups = cats["texture lookups"] = [0.0, 0]
        for key, (ms, n) in tex.items():
            c = cats[_category(key)]
            c[0] -= ms
            c[1] -= n
            lookups[0] += ms
            lookups[1] += n
        gathers = sum(v[0] for k, v in tex.items()
                      if _category(k) == "gathers and scatters")
        log(f"phase 5: {path}: texture lookups: {lookups[0]:.2f} ms of "
            f"device kernels in {lookups[1]} launches, {gathers:.2f} ms of "
            "them texel gathers" if lookups[1] else
            f"phase 5: {path}: texture lookups: not measured (no kernel "
            "linked to the profiler's texture ranges)")
    launches = sum(r[1] for r in rows)
    if passes > 1:
        log(f"phase 5: {path}: profiled one of its {passes} passes: "
            f"{dev_ms:.2f} ms of device kernels in {launches} launches; a "
            f"render, {passes} such passes: {dev_ms * passes:.2f} ms in "
            f"{launches * passes} launches")
    log(f"phase 5: {path}: profiled render: {dev_ms * passes:.2f} ms of "
        f"device kernels in {launches * passes} launches; device busy "
        f"{dev_ms / wall_ms:.3f} of the profiled wall time ({wall_ms:.1f} ms"
        f"{' a pass' if passes > 1 else ''}), {dev_ms * passes / render_ms:.3f}"
        f" of phase 3's median ({render_ms:.1f} ms)")
    for c, (ms, n) in sorted(cats.items(), key=lambda kv: -kv[1][0]):
        log(f"  {c}: {ms:.2f} ms ({ms / dev_ms:.3f}) in {n} launches")
    for ms, n, key in rows[:12]:
        log(f"  {ms:8.3f} ms {n:5d}x {key[:90]}")


# ---------------------------------------------------------------------------
# Phase 6: the probes, and a model of the cluster walks' times
# ---------------------------------------------------------------------------

# FP32 operations of a P2 row: 16 products, 15 sums and the min
FLOPS_PER_ROW = 32


def _probe_configs(torch, dev):
    """Each probe configuration at PROBE_LANES lanes: its probe, label,
    kernel call, twin call (with a stats dict), steps a lane, and the
    bytes of its tables and of each lane's inputs and outputs."""
    from mitsuba2_tpu_torch.kernels import probes

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    n = PROBE_LANES
    cfgs = []
    for rows in P1_ROWS:
        node, link = (up(a) for a in probes.walk_tables(rows))
        for div in (False, True):
            s, start = (up(a) for a in probes.lanes(n, rows, div))
            for dep in (True, False):
                args = (node, link, s, start, P1_STEPS, dep)
                cfgs.append(dict(
                    probe="walk_step", steps=P1_STEPS,
                    label=f"{'dep' if dep else 'indep'} R={rows} "
                          f"{'divergent' if div else 'coherent'}",
                    run=functools.partial(probes.walk_step, *args),
                    twin=functools.partial(probes.walk_step_plain, *args),
                    tab_bytes=rows * (32 + 64), lane_bytes=16))
    feat, rt = (up(a) for a in probes.row_tables(n))
    for smem in (False, True):
        cfgs.append(dict(
            probe="row_load", steps=P2_STEPS,
            label="smem" if smem else "ldg",
            run=functools.partial(probes.row_load, feat, rt, P2_STEPS, smem),
            twin=functools.partial(probes.row_load_plain, feat, rt,
                                   P2_STEPS),
            tab_bytes=feat.numel() * 4, lane_bytes=4 * probes.ROW_W + 4))
    vis = [up(a) for a in probes.visit_tables()]
    for div in (False, True):
        s, start = (up(a) for a in probes.lanes(n, vis[0].shape[0], div))
        for every in probes.EVERY:
            args = (*vis, s, start, P3_STEPS, every, 128)
            cfgs.append(dict(
                probe="cluster_visit", steps=P3_STEPS,
                label=f"{P3_MODES[every]} "
                      f"{'divergent' if div else 'coherent'}",
                run=functools.partial(probes.cluster_visit, *args),
                twin=functools.partial(probes.cluster_visit_plain, *args),
                tab_bytes=sum(a.numel() * 4 for a in vis), lane_bytes=16))
    return cfgs


def phase_probes(torch, dev, card, launches):
    """Phase 6: every probe configuration launched once with the counts
    at 0 (the probes' main path), then each held against its twin and
    timed; the costs per unit and the model of phase 3's K1, K2, K5 and
    K7 launches (`launches`: phase_main_path's records by path). Returns
    the probes' rows of the kernels line."""
    from mitsuba2_tpu_torch.kernels import probes
    cfgs = _probe_configs(torch, dev)
    wrappers = {k: getattr(probes, k) for k in PROBE_REPLACES}
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    for c in cfgs:
        c["run"]()
    torch.cuda.synchronize()
    counts = {k: w.launches for k, w in wrappers.items()}
    log(f"probes launched: {json.dumps(counts)}")
    for k in wrappers:
        check(counts[k] == sum(c["probe"] == k for c in cfgs),
              f"probe {k}: {counts[k]} launches")
    n = PROBE_LANES
    for c in cfgs:
        out = c["run"]()
        st = {}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        want = c["twin"](stats=st)
        ev[1].record()
        torch.cuda.synchronize()
        out = out if isinstance(out, tuple) else (out,)
        want = want if isinstance(want, tuple) else (want,)
        check(all(torch.equal(a, b) for a, b in zip(out, want)),
              f"probe {c['probe']} {c['label']} disagrees with its twin")
        c["err"] = max(float((a.double() - b.double()).abs().max())
                       for a, b in zip(out, want))
        c["plain_ms"] = ev[0].elapsed_time(ev[1])
        c["ms"] = kernel_ms(torch, c["run"], PROBE_REPS)
        c["st"] = st
        ops = (st.get("slab_tests", 0) * FLOPS_PER_NODE
               + st.get("rows", 0) * FLOPS_PER_ROW
               + st.get("slot_tests", 0) * FLOPS_PER_SLOT)
        t_ops = ops / PEAK_FP32_PER_S
        t_bytes = (c["tab_bytes"] + n * c["lane_bytes"]) / PEAK_BYTES_PER_S
        c["bound_ms"] = max(t_ops, t_bytes) * 1e3
        c["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        per = c["ms"] * 1e9 / (n * c["steps"])
        unit = {"walk_step": "ps a ray-step",
                "row_load": "ps a ray-step of 128 rows",
                "cluster_visit": "ps a ray-step"}[c["probe"]]
        extra = ""
        if c["probe"] == "row_load":
            rows = n * c["steps"] * probes.ROWS
            extra = (f", {c['ms'] * 1e9 / rows:.4f} ps a row a lane, "
                     f"{rows * 64 / (c['ms'] * 1e-3) / 1e12:.2f} TB/s of "
                     "rows into registers")
        if "cluster_visits" in st:
            extra = (f", {st['cluster_visits'] / n:.3f} visits a lane")
        log(f"phase 6: {c['probe']} {c['label']}: {c['ms']:.4f} ms on "
            f"{card} ({per:.3f} {unit}{extra}); twin {c['plain_ms']:.1f} ms, "
            f"equal; bound {c['bound_ms']:.4f} ms by {c['bound_by']}")
    by = {(c["probe"], c["label"]): c for c in cfgs}

    def step_ps(label):
        return by["walk_step", label]["ms"] * 1e9 / (n * P1_STEPS)

    def visit_ps(kind, div):
        """A ray-visit's cost net of the walk step (P3)."""
        d = "divergent" if div else "coherent"
        v, s0 = by["cluster_visit", f"{kind} {d}"], by["cluster_visit",
                                                        f"step {d}"]
        return (v["ms"] - s0["ms"]) * 1e9 / v["st"]["cluster_visits"]

    cost = {"coherent": (step_ps("dep R=768 coherent"),
                         visit_ps("visit1", False)),
            "divergent": (step_ps("dep R=768 divergent"),
                          visit_ps("visit4", True))}
    log(f"phase 6: costs on {card}: a dependent step {cost['coherent'][0]:.3f}"
        f" ps (coherent) to {cost['divergent'][0]:.3f} ps (divergent) a "
        f"ray, {step_ps(f'dep R={P1_ROWS[-1]} divergent'):.3f} ps from "
        f"L2 (R={P1_ROWS[-1]}, divergent), an independent one "
        f"{step_ps('indep R=768 coherent'):.3f} ps; a cluster visit net of "
        f"its step {cost['coherent'][1]:.3f} ps a ray (all threads of a "
        f"warp together, visit1) to {cost['divergent'][1]:.3f} ps "
        f"(threads apart, visit4 divergent); visit1 divergent "
        f"{visit_ps('visit1', True):.3f} ps")
    for path, names in (("gallery", ("cluster_closest_hit",
                                     "cluster_any_hit")),
                        ("instanced", ("inst_cluster_closest_hit",
                                       "inst_cluster_any_hit")),
                        ("gallery_bvh8mxu", ("bvh8mxu_closest_hit",
                                             "bvh8mxu_any_hit"))):
        for name in names:
            for i, r in enumerate(launches.get(path, {}).get(name, [])):
                st, m = r["st"], r["n"]
                steps = st.get("node_steps", 0) + sum(
                    st.get(k, 0) for k in ("fresh_visits", "advances",
                                           "pops"))
                visits = st.get("cluster_visits", 0)
                # each term of the model, in ms: (steps, visits)
                terms = {k: (steps * a * 1e-9, visits * b * 1e-9)
                         for k, (a, b) in cost.items()}
                log(f"phase 6: model {name} launch {i} ({path}): "
                    f"{steps / m:.3f} steps and {visits / m:.4f} visits a "
                    f"lane: " + ", ".join(
                        f"{sum(v):.3f} ms at {k} costs (steps {v[0]:.3f} + "
                        f"visits {v[1]:.3f})" for k, v in terms.items())
                    + f"; measured {r['ms']:.3f} ms")
    rows = []
    for k in PROBE_REPLACES:
        cs = [c for c in cfgs if c["probe"] == k]
        bound_by = [c["bound_by"] for c in cs]
        rows.append({
            "name": f"probe_{k}", "route": "cuda", "source": PROBE_SRC,
            "replaces": PROBE_REPLACES[k], "launches": counts[k],
            "max_abs_err": max(c["err"] for c in cs),
            "ms": statistics.fmean(c["ms"] for c in cs),
            "plain_ms": statistics.fmean(c["plain_ms"] for c in cs),
            "bound_ms": statistics.fmean(c["bound_ms"] for c in cs),
            "bound_by": max(set(bound_by), key=bound_by.count),
            "library_ms": None,
            "modes": [{"mode": c["label"], "ms": c["ms"],
                       "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"]}
                      for c in cs]})
    return rows

# ---------------------------------------------------------------------------
# Phase 7: the adjoint
# ---------------------------------------------------------------------------

BACKWARD_RANGE = "adjoint backward"
# the profiler ranges, whose device-side rows span kernels (not kernels):
# this script's backward sweeps, the port's texture lookups and texel
# gathers' backward (render/texture.py)
RANGES = (BACKWARD_RANGE, "texture lookup", "texel gather backward")


def rays_per_pass(cfg):
    """bench.py's count of a pass's rays (:204-206)."""
    return (cfg.width * cfg.height * cfg.spp_per_pass
            * (1 + 2 * (cfg.max_depth - 1)))


@contextlib.contextmanager
def watch_backward(torch, moved, profile_range=None):
    """Inside the block, each torch.autograd.backward call (the adjoint's
    phase 2 makes one a pass) appends to `moved` the traversal wrappers
    whose launch counts moved during it, the device synchronized before
    and after; with `profile_range`, the call runs inside a
    torch.profiler.record_function range of that name."""
    backward = torch.autograd.backward
    wrappers = {k: wrapper(k) for k in REPLACES}

    def watched(*a, **kw):
        torch.cuda.synchronize()
        before = {k: w.launches for k, w in wrappers.items()}
        with (torch.profiler.record_function(profile_range)
              if profile_range else contextlib.nullcontext()):
            out = backward(*a, **kw)
            torch.cuda.synchronize()
        moved.append({k: w.launches - before[k] for k, w in wrappers.items()
                      if w.launches != before[k]})
        return out

    torch.autograd.backward = watched
    try:
        yield
    finally:
        torch.autograd.backward = backward


def median_ms(torch, fn, reps=3):
    """Median wall ms of `fn(seed)` over `reps` calls (seeds 1..reps),
    each ended by a synchronize, after a warm-up call (seed 0)."""
    fn(0)
    torch.cuda.synchronize()
    times = []
    for r in range(reps):
        t0 = time.perf_counter()
        fn(r + 1)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def _finite(torch, tensors):
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def _adjoint_path(torch, mt, name, scene, card):
    """Forward and render_l2_grad of one adjoint path: times, rates, peak
    memory, launches (none in a backward sweep), and one pass
    differentiated end to end, then every pass (what the pass-by-pass
    replay saves), held to render_l2_grad's image and gradients."""
    from mitsuba2_tpu_torch.diff.adjoint import diff_tables, with_tables
    cfg = mt.RenderConfig(**ADJOINT[name])
    passes = cfg.spp // cfg.spp_per_pass
    rays = rays_per_pass(cfg) * passes
    target = torch.zeros((cfg.height, cfg.width, 3), device=scene.device)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fwd_ms, fwd_t = median_ms(torch, lambda r: mt.render(scene, cfg, seed=r))
    fwd_peak = torch.cuda.max_memory_allocated() - resident
    moved = []
    with watch_backward(torch, moved):
        adj_ms, adj_t = median_ms(torch, lambda r: mt.render_l2_grad(
            scene, cfg, target, seed=r))
        for k in REPLACES:
            wrapper(k).launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        img, loss, grads = mt.render_l2_grad(scene, cfg, target, seed=7)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - resident
        counts = {k: wrapper(k).launches for k in REPLACES}
    check(len(moved) == 5 * passes and not any(moved),
          f"{name}: a backward sweep launched kernels: {moved}")
    check(tuple(img.shape) == (cfg.height, cfg.width, 3) and _finite(
        torch, [img, loss, *grads.values()]) and float(loss) > 0,
          f"{name}: non-finite or empty adjoint outputs")
    check(all(float(g.abs().max()) > 0 for g in grads.values()),
          f"{name}: a gradient table is all zero")
    # phase 1 and phase 2 trace each pass: the camera rays, then a bounce
    # and a shadow ray a bounce
    kernels = PATH_KERNELS.get(name, ())
    want = {k: 0 for k in REPLACES}
    if kernels:
        want[kernels[0]] = 2 * passes * cfg.max_depth
        want[kernels[1]] = 2 * passes * (cfg.max_depth - 1)
    log(f"phase 7: {name}: launches over one render_l2_grad (counts at 0 "
        f"just before): {json.dumps({k: n for k, n in counts.items() if n})}"
        f"; during its {passes} backward sweeps: none")
    check(counts == want, f"{name}: launches {counts}, expected {want}")

    peaks = {}
    for spp in sorted({cfg.spp_per_pass, cfg.spp}):
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in diff_tables(scene).items()}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        img_e = mt.render(with_tables(scene, leaves), cfg.replace(spp=spp),
                          seed=7)
        torch.mean((img_e - target) ** 2).backward()
        torch.cuda.synchronize()
        peaks[spp] = torch.cuda.max_memory_allocated() - base
        check(_finite(torch, [v.grad for v in leaves.values()]),
              f"{name}: non-finite end-to-end gradients")
    # the last is the whole render, seed 7: render_l2_grad's above
    check(torch.equal(img_e.detach(), img),
          f"{name}: the end-to-end render's image is not render_l2_grad's")
    rel = max(float((leaves[k].grad - grads[k]).norm() / grads[k].norm())
              for k in grads)
    check(rel <= 1e-4, f"{name}: end-to-end gradients {rel:.2e} off "
          "render_l2_grad's")
    mib = 2 ** 20
    log(f"phase 7: {name}: {cfg.width}x{cfg.height}x{cfg.spp}spp in "
        f"{passes} pass(es) of {cfg.spp_per_pass}, depth {cfg.max_depth}, "
        f"rr_depth {cfg.rr_depth}, on {card}")
    log(f"phase 7: {name}: forward render median {fwd_ms:.1f} ms of "
        f"{[round(t, 1) for t in fwd_t]}, {rays / fwd_ms / 1e3:.3f} Mrays/s")
    log(f"phase 7: {name}: render_l2_grad median {adj_ms:.1f} ms of "
        f"{[round(t, 1) for t in adj_t]}")
    log(f"phase 7: {name}: forward + adjoint {2 * rays / adj_ms / 1e3:.3f} "
        f"Mrays/s (2 x {rays} rays / render_l2_grad's time)")
    log(f"phase 7: {name}: adjoint / forward time {adj_ms / fwd_ms:.3f}")
    log(f"phase 7: {name}: peak memory over the {resident / mib:.0f} MiB "
        f"resident (scenes): render_l2_grad {peak / mib:.0f} MiB, the "
        f"forward render {fwd_peak / mib:.0f} MiB")
    log(f"phase 7: {name}: differentiated end to end: peak "
        + ", ".join(f"{p / mib:.0f} MiB for {spp // cfg.spp_per_pass} "
                    f"pass(es)" for spp, p in peaks.items())
        + f"; the whole render's image equal to render_l2_grad's, its "
        f"gradients within {rel:.1e} in relative norm")
    return adj_ms


def _adjoint_profile(torch, mt, scene, card, adj_ms, name="gallery"):
    """One render_l2_grad of path `name` under torch.profiler: device
    time by kind, the kernels that ran inside a backward sweep apart; on a
    scene with textures, the texel gathers' backward (index_add_) too."""
    from mitsuba2_tpu_torch.render.texture import TEXEL_BACKWARD_RANGE
    from torch.profiler import ProfilerActivity, profile
    cfg = mt.RenderConfig(**ADJOINT[name])
    target = torch.zeros((cfg.height, cfg.width, 3), device=scene.device)
    torch.cuda.synchronize()
    with watch_backward(torch, [], BACKWARD_RANGE), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mt.render_l2_grad(scene, cfg, target, seed=11)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    windows = [(e.time_range.start, e.time_range.end) for e in events
               if e.name == BACKWARD_RANGE
               and not str(e.device_type).endswith("CUDA")]
    cats = {}
    for e in events:
        if not str(e.device_type).endswith("CUDA") or e.name in RANGES:
            continue
        start = e.time_range.start
        bwd = any(a <= start <= b for a, b in windows)
        c = cats.setdefault(("backward: " if bwd else "")
                            + _category(e.name), [0.0, 0])
        c[0] += e.time_range.elapsed_us() / 1e3
        c[1] += 1
    dev_ms = sum(v[0] for v in cats.values())
    bwd_ms = sum(v[0] for k, v in cats.items() if k.startswith("backward"))
    check(dev_ms > 0 and bwd_ms > 0 and windows,
          "the profiler shows no device time in the backward sweeps")
    if scene.textures is not None:
        tex = range_kernels(prof, TEXEL_BACKWARD_RANGE)
        log(f"phase 7: {name}: texel gathers' backward: "
            f"{sum(v[0] for v in tex.values()):.2f} ms of device kernels in "
            f"{sum(v[1] for v in tex.values())} launches: "
            + ", ".join(f"{k[:40]} {v[0]:.2f} ms x{v[1]}"
                        for k, v in sorted(tex.items(), key=lambda kv:
                                           -kv[1][0])[:4]))
    log(f"phase 7: {name}: profiled render_l2_grad on {card}: {dev_ms:.2f} "
        f"ms of device kernels, {bwd_ms:.2f} of them in the backward sweep; "
        f"device busy {dev_ms / wall_ms:.3f} of the profiled wall time "
        f"({wall_ms:.1f} ms), {dev_ms / adj_ms:.3f} of the median "
        f"({adj_ms:.1f} ms)")
    for c, (ms, n) in sorted(cats.items(), key=lambda kv: -kv[1][0]):
        log(f"  {c}: {ms:.2f} ms ({ms / dev_ms:.3f}) in {n} launches")


def _adjoint_card_vs_cpu(torch, mt, dev):
    """render_l2_grad on small scenes on the card against the CPU (twins
    and brute force there): each gradient table within 1e-3 in relative
    norm, the images within phase 4's limits; then veach_mis(), whose
    comparison is the exception (_veach_card_vs_cpu)."""
    cfg = mt.RenderConfig(width=32, height=32, spp=4, spp_per_pass=2,
                          max_depth=3, rr_depth=8)
    target = torch.zeros((32, 32, 3))
    for name, mk in (
            ("mesh_gallery(subdiv=2)",
             lambda d: mt.mesh_gallery(subdiv=2, device=d)),
            ("cornell_box(boxes=False)",
             lambda d: mt.cornell_box(boxes=False, device=d))):
        img_c, _, g_c = mt.render_l2_grad(mk("cpu"), cfg, target, seed=5,
                                          device="cpu")
        img_g, _, g_g = mt.render_l2_grad(mk(dev), cfg, target.to(dev),
                                          seed=5)
        rel = {k: float((g_g[k].cpu() - g_c[k]).norm() / g_c[k].norm())
               for k in g_c}
        img_g, img_c = img_g.cpu().numpy(), img_c.numpy()
        close = np.isclose(img_g, img_c, rtol=1e-3, atol=1e-4).all(-1).mean()
        mrel = abs(img_g.mean() - img_c.mean()) / img_c.mean()
        good = (np.isfinite(img_g).all() and close >= 0.99 and mrel <= 1e-3
                and max(rel.values()) <= 1e-3)
        log(f"phase 7: {name} 32x32 render_l2_grad card vs CPU: gradients' "
            f"relative norm difference "
            + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
            + f"; {close:.4f} of pixels within rtol 1e-3/atol 1e-4, mean rel "
            f"diff {mrel:.2e} {'ok' if good else 'FAIL'}")
        check(good, f"{name}: the card's gradients disagree with the CPU's")
    _veach_card_vs_cpu(torch, mt, dev, cfg, target, "veach_mis()",
                       mt.veach_mis)
    _veach_card_vs_cpu(torch, mt, dev, cfg.replace(**SPECTRAL), target,
                       "veach_mis(envmap=True), spectral",
                       functools.partial(mt.veach_mis, envmap=True))
    _textured_card_vs_cpu(torch, mt, dev, cfg, target)


def _textured_card_vs_cpu(torch, mt, dev, cfg, target):
    """gallery_textured(subdiv=1) with 64 x 64 textures: render_l2_grad on
    the card against the CPU: the texels' gradients (tex_data) within
    1e-3 of their largest magnitude, the other tables within 1e-3 in
    relative norm, the image within phase 4's limits."""
    from mitsuba2_tpu_torch.scene import presets
    t0 = time.perf_counter()
    make = functools.partial(gallery_textured, presets, 1, 64)
    img_c, _, g_c = mt.render_l2_grad(make(device="cpu"), cfg, target,
                                      seed=5, device="cpu")
    img_g, _, g_g = mt.render_l2_grad(make(device=dev), cfg, target.to(dev),
                                      seed=5)
    g_g = {k: v.cpu() for k, v in g_g.items()}
    tex_err = float((g_g["tex_data"] - g_c["tex_data"]).abs().max()
                    / g_c["tex_data"].abs().max())
    rel = {k: float((g_g[k] - g_c[k]).norm() / g_c[k].norm()) for k in g_c}
    img_g, img_c = img_g.cpu().numpy(), img_c.numpy()
    close = np.isclose(img_g, img_c, rtol=1e-3, atol=1e-4).all(-1).mean()
    mrel = abs(img_g.mean() - img_c.mean()) / img_c.mean()
    good = (np.isfinite(img_g).all() and close >= 0.99 and mrel <= 1e-3
            and tex_err <= 1e-3 and _finite(torch, [*g_g.values()])
            and max(v for k, v in rel.items() if k != "tex_data") <= 1e-3)
    log(f"phase 7: gallery_textured(subdiv=1), 64x64 textures, "
        f"{cfg.width}x{cfg.height} render_l2_grad card vs CPU: tex_data's "
        f"largest difference "
        f"{tex_err:.2e} of its largest magnitude; relative norm difference "
        + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
        + f"; {close:.4f} of pixels within rtol 1e-3/atol 1e-4, mean rel "
        f"diff {mrel:.2e} {'ok' if good else 'FAIL'} "
        f"({time.perf_counter() - t0:.1f} s)")
    check(good, "gallery_textured: the card's gradients disagree with the "
          "CPU's")


def _textured_train(torch, mt, dev, card, scene):
    """Config 4's texture optimization: Adam on gallery_textured's texels
    (tex_data, every texture) from its own floor albedo toward its render
    under another floor texture (each texel's complement, times 0.8),
    every step at one seed; the loss must fall, and the floor's texels
    move toward the other texture."""
    from mitsuba2_tpu_torch.diff.adjoint import diff_tables, with_tables
    from mitsuba2_tpu_torch.diff.optimizers import adam_init, adam_step
    cfg = mt.RenderConfig(**INVERT)
    key = "floor_albedo.data"
    floor = mt.traverse(scene)[key].clone()
    other = (1.0 - floor) * 0.8
    target = mt.render(mt.scene_with(scene, {key: other}), cfg, seed=0)
    theta = {"tex_data": scene.textures.data.detach()}
    state = adam_init(theta)
    losses, t0 = [], time.perf_counter()
    for it in range(TEXTURED_TRAIN_STEPS):
        _, loss, grads = mt.render_and_grad(
            scene, cfg, lambda im: torch.mean((im - target) ** 2), seed=1)
        theta, state = adam_step(theta, {"tex_data": grads["tex_data"]},
                                 state, lr=TEXTURED_TRAIN_LR)
        scene = with_tables(scene, {**diff_tables(scene), **theta})
        losses.append(float(loss))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / TEXTURED_TRAIN_STEPS
    err = [float((floor - other).abs().mean()),
           float((mt.traverse(scene)[key] - other).abs().mean())]
    log(f"phase 7: gallery_textured texture optimization on {card}: "
        f"{TEXTURED_TRAIN_STEPS} Adam steps (lr {TEXTURED_TRAIN_LR}) on "
        f"tex_data {tuple(theta['tex_data'].shape)} at {cfg.width}x"
        f"{cfg.height}x{cfg.spp}spp depth {cfg.max_depth}, {step_ms:.1f} ms "
        "a step: loss " + " ".join(f"{v:.6f}" for v in losses)
        + f"; the floor's mean texel error {err[0]:.4f} -> {err[1]:.4f}")
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          "gallery_textured: the loss did not fall")


def _plate_roughness(torch, mt, dev, card):
    """veach_mis()'s plate0 roughness (alpha 0.005, f32's worst case):
    render_l2_grad's gradient on the card and on the CPU beside a central
    difference on the card (the two images' difference summed in float64
    at one seed, tests/test_torch_veach.py's), printed, not held."""
    cfg = mt.RenderConfig(**PLATE_RENDER)
    name, v0, eps = PLATE["name"], PLATE["value"], PLATE["eps"]
    target = torch.zeros((cfg.height, cfg.width, 3))
    out = {}
    for d in ("cpu", dev):
        scene = mt.veach_mis(device=d)
        row, c0 = {p[0]: p[2:4] for p in scene.param_paths}[name]
        _, _, g = mt.render_l2_grad(scene, cfg, target.to(d), seed=0,
                                    device=d)
        out[str(d)] = float(g["mat_data"][row, c0])
    scene = mt.veach_mis(device=dev)
    with torch.no_grad():
        hi, lo = (mt.render(mt.scene_with(scene, {name: torch.tensor(
            v0 + s, device=dev)}), cfg, seed=0).double() for s in (eps, -eps))
    fd = float((hi * hi - lo * lo).mean()) / (2 * eps)
    card_g, cpu_g = out[str(dev)], out["cpu"]
    log(f"phase 7: veach_mis() {name} = {v0} at {cfg.width}x{cfg.height}x"
        f"{cfg.spp}spp depth {cfg.max_depth}: render_l2_grad's gradient "
        f"{card_g:.6e} on {card}, {cpu_g:.6e} on the CPU (card/CPU "
        f"{card_g / cpu_g:.4f}); central difference (eps {eps}) on the card "
        f"{fd:.6e} (card/fd {card_g / fd:.4f}, CPU/fd {cpu_g / fd:.4f})")
    check(np.isfinite([card_g, cpu_g, fd]).all(),
          f"veach: {name}: a non-finite gradient")


def _veach_card_vs_cpu(torch, mt, dev, cfg, target, label, make):
    """veach_mis() (`make`, with or without the envmap, rendered under
    `cfg`), the exception to _adjoint_card_vs_cpu's comparison: a
    sample off a plate that grazes a small bright light may take the other
    side of it on the card, whose sines and logarithms round otherwise,
    and move its pixel by more than the image's mean (2 of these 1 024
    pixels). So render_and_grad differentiates an L2 loss over the pixels
    on which the card's and the CPU's forward renders agree (phase 4's
    limits: 99% of them within rtol 1e-3 / atol 1e-4), whose mean is held
    within 1e-3: each gradient table, and the plates' roughness and the
    floor's albedo apart, within 1e-3 in relative norm, all finite (with
    the envmap, its image and scale among the tables). Phase 4 holds the
    whole image. render_l2_grad's gradients (every pixel's loss) are
    printed beside them, not held."""
    scene_c, scene_g = make(device="cpu"), make(device=dev)
    img_c, _, f_c = mt.render_l2_grad(scene_c, cfg, target, seed=5,
                                      device="cpu")
    img_g, _, f_g = mt.render_l2_grad(scene_g, cfg, target.to(dev), seed=5)
    img_c, img_g = img_c.numpy(), img_g.cpu().numpy()
    agree = np.isclose(img_g, img_c, rtol=1e-3, atol=1e-4).all(-1)
    mask = torch.from_numpy(agree.astype(np.float32))[..., None]

    def loss(im):
        return torch.mean((im * mask.to(im.device)) ** 2)
    _, _, g_c = mt.render_and_grad(scene_c, cfg, loss, seed=5, device="cpu")
    _, _, g_g = mt.render_and_grad(scene_g, cfg, loss, seed=5)
    rel = {k: float((g_g[k].cpu() - g_c[k]).norm() / g_c[k].norm())
           for k in g_c}
    full = {k: float((f_g[k].cpu() - f_c[k]).norm() / f_c[k].norm())
            for k in f_c}
    from mitsuba2_tpu_torch.render.spectra import SLOT_W
    # the named parameters' entries, each group as one vector; a color's
    # whole spectrum slot, whose RGB columns take rgb mode's gradients and
    # whose coefficient and scale columns spectral mode's
    at = {p[0]: (p[2], p[3], p[3] + SLOT_W if p[5] == "rgb" else p[4])
          for p in scene_c.param_paths}
    for group, names in VEACH_PARAMS.items():
        pick = [(at[n][0], c) for n in names
                for c in range(at[n][1], at[n][2])]
        rows, cols = (torch.tensor(v) for v in zip(*pick))
        a = g_g["mat_data"].cpu()[rows, cols]
        b = g_c["mat_data"][rows, cols]
        check(bool(b.abs().max() > 0), f"{label}: {group}: zero gradient")
        rel[group] = float((a - b).norm() / b.norm())
    mrel = (abs(img_g[agree].mean() - img_c[agree].mean())
            / img_c[agree].mean())
    good = (np.isfinite(img_g).all() and agree.mean() >= 0.99
            and mrel <= 1e-3 and max(rel.values()) <= 1e-3
            and _finite(torch, [*g_g.values(), *g_c.values()]))
    log(f"phase 7: {label} 32x32 render_and_grad card vs CPU: "
        f"{agree.mean():.4f} of pixels within rtol 1e-3/atol 1e-4 (the "
        f"loss's pixels), their mean rel diff {mrel:.2e}; gradients' "
        "relative norm difference "
        + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
        + f" {'ok' if good else 'FAIL'}; every pixel (not held): image mean "
        f"rel diff {abs(img_g.mean() - img_c.mean()) / img_c.mean():.2e}, "
        "render_l2_grad's gradients "
        + ", ".join(f"{k} {v:.2e}" for k, v in full.items()))
    check(good, f"{label}: the card's gradients disagree with the CPU's")


def _adjoint_train(torch, mt, dev, card):
    """examples/invert_cbox.py's loop on the card: Adam on the Cornell
    box's tables from left.bsdf.reflectance = [0.6, 0.6, 0.6] toward the
    render of the true value, every step at one seed, so that the loss
    moves with the albedo alone; the albedo's error must halve."""
    from mitsuba2_tpu_torch.diff.adjoint import diff_tables, with_tables
    from mitsuba2_tpu_torch.diff.optimizers import adam_init, adam_step
    cfg = mt.RenderConfig(**INVERT)
    key = "left.bsdf.reflectance"
    scene_gt = mt.cornell_box(device=dev)
    true = mt.traverse(scene_gt)[key].clone()
    target = mt.render(scene_gt, cfg, seed=0)
    scene = mt.scene_with(scene_gt, {key: torch.full((3,), 0.6, device=dev)})
    theta = {k: v.detach() for k, v in diff_tables(scene).items()}
    state = adam_init(theta)
    losses, t0 = [], time.perf_counter()
    for it in range(INVERT_STEPS):
        _, loss, grads = mt.render_and_grad(
            scene, cfg, lambda im: torch.mean((im - target) ** 2),
            seed=1)
        theta, state = adam_step(theta, grads, state, lr=INVERT_LR)
        scene = with_tables(scene, theta)
        losses.append(float(loss))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / INVERT_STEPS
    value = mt.traverse(scene)[key]
    err = [float((torch.full((3,), 0.6, device=dev) - true).abs().max()),
           float((value - true).abs().max())]
    log(f"phase 7: invert_cbox on {card}: {INVERT_STEPS} Adam steps (lr "
        f"{INVERT_LR}) at {cfg.width}x{cfg.height}x{cfg.spp}spp depth "
        f"{cfg.max_depth}, {step_ms:.1f} ms a step: loss "
        + " ".join(f"{v:.6f}" for v in losses)
        + f"; {key} {[round(float(v), 4) for v in value]} (true "
        f"{[round(float(v), 4) for v in true]}), max abs error {err[0]:.4f} "
        f"-> {err[1]:.4f}")
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          "invert_cbox: the loss did not fall")
    check(err[1] < 0.5 * err[0], "invert_cbox: the albedo's error did not "
          f"halve ({err[0]:.4f} -> {err[1]:.4f})")


def phase_adjoint(torch, mt, dev, card, gallery, veach, veach_spectral,
                  textured, gallery_reparam):
    """Phase 7 (see the module docstring); `gallery`, `veach`,
    `veach_spectral`, `textured`, `gallery_reparam`: phase 2's scenes."""
    def step(what, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"phase 7: {what} took {time.perf_counter() - t0:.1f} s")
        return out

    with path_switches("gallery"):
        adj_ms = step("gallery", _adjoint_path, torch, mt, "gallery",
                      gallery, card)
        _adjoint_profile(torch, mt, gallery, card, adj_ms)
    step("cornell", _adjoint_path, torch, mt, "cornell",
         mt.cornell_box(device=dev), card)
    step("veach", _adjoint_path, torch, mt, "veach", veach, card)
    step("veach_spectral", _adjoint_path, torch, mt, "veach_spectral",
         veach_spectral, card)
    adj_ms = step("gallery_textured", _adjoint_path, torch, mt,
                  "gallery_textured", textured, card)
    step("gallery_textured's profile", _adjoint_profile, torch, mt,
         textured, card, adj_ms, "gallery_textured")
    step("card vs CPU", _adjoint_card_vs_cpu, torch, mt, dev)
    step("invert_cbox", _adjoint_train, torch, mt, dev, card)
    step("the texture optimization", _textured_train, torch, mt, dev, card,
         textured)
    step("plate0's roughness", _plate_roughness, torch, mt, dev, card)
    with path_switches("gallery_reparam"):
        step("gallery_reparam's refresh", _refresh_check, torch, mt, dev,
             gallery_reparam)
        step("gallery_reparam's blob gradient", _blob_gradient, torch, mt,
             card, gallery_reparam)
    for name in OCCLUDER_CHECKS:
        step(name, _occluder_check, torch, mt, dev, card, name)


def _moved(torch, scene, rows, theta):
    """The scene with prim_p0's `rows` (a bool mask) shifted by theta along
    x (tests/test_reparam.py's `_translated`)."""
    import dataclasses
    shift = torch.stack([theta, torch.zeros_like(theta),
                         torch.zeros_like(theta)])
    return dataclasses.replace(
        scene, prim_p0=scene.prim_p0 + rows[:, None] * shift[None])


def _grad(torch, loss):
    """d loss / d theta at 0, and its wall ms; 0 where the loss does not
    depend on theta (no tape: plain AD of a visibility change)."""
    theta = torch.tensor(0.0, device=DEVICE, requires_grad=True)
    t0 = time.perf_counter()
    out = loss(theta)
    g = (torch.autograd.grad(out, theta, allow_unused=True)[0]
         if out.requires_grad else None)
    torch.cuda.synchronize()
    return (0.0 if g is None else float(g),
            (time.perf_counter() - t0) * 1e3)


def _fd(torch, loss, eps):
    """(loss(eps) - loss(-eps)) / (2 eps), no tape, and its wall ms."""
    t0 = time.perf_counter()
    with torch.no_grad():
        hi, lo = (float(loss(torch.tensor(v, device=DEVICE)))
                  for v in (eps, -eps))
    torch.cuda.synchronize()
    return (hi - lo) / (2 * eps), (time.perf_counter() - t0) * 1e3


def _blob_rows(torch, scene):
    """The last blob's prims (mesh_gallery's last shape), a bool mask."""
    return scene.prim_shape == int(scene.prim_shape.max())


def _refresh_check(torch, mt, dev, scene):
    """Moves gallery_reparam's last blob by BLOB_SHIFT along x and
    refreshes the walk tables (scene.refresh_mxu_feat): K1 and K2 on the
    refreshed tables held against their twins, bit for bit, on 65 536
    camera rays; the hits on the blob then move with it, which the stale
    tables miss."""
    from mitsuba2_tpu_torch.core.vec import Vec2
    from mitsuba2_tpu_torch.render import sensors
    from mitsuba2_tpu_torch.scene.scene import refresh_mxu_feat
    rows = _blob_rows(torch, scene)
    moved = _moved(torch, scene, rows, torch.tensor(BLOB_SHIFT, device=dev))
    t0 = time.perf_counter()
    fresh = refresh_mxu_feat(moved)
    torch.cuda.synchronize()
    refresh_ms = (time.perf_counter() - t0) * 1e3
    g = torch.Generator(device=dev).manual_seed(5)
    uv = torch.rand((2, N_PROBE), device=dev, generator=g)
    ray = sensors.sample_ray(fresh, Vec2(uv[0], uv[1]))
    args = [ray.o.x, ray.o.y, ray.o.z, ray.d.x, ray.d.y, ray.d.z, ray.maxt]
    ks = kernels_of(fresh)
    c = compare(torch, ks, args)
    check(passes(c, **exactness("gallery_reparam", ks))
          and c["closest_bit_equal"] and c["occ_agree"] == 1.0,
          f"K1/K2 on the refreshed tables disagree with their twins: {c}")
    t_new = wrapper(ks["closest"])(*ks["tabs"], *args, *ks["extra"])
    t_old = wrapper(ks["closest"])(*kernels_of(moved)["tabs"], *args,
                                   *ks["extra"])
    moved_hits = int((t_new[0] != t_old[0]).sum())
    check(moved_hits > 0, "the refreshed tables find the same hits as the "
          "stale ones")
    log(f"phase 7: gallery_reparam: refresh_mxu_feat after moving blob "
        f"{int(scene.prim_shape.max())} ({int(rows.sum())} prims) by "
        f"{BLOB_SHIFT} along x: {refresh_ms:.2f} ms; K1, K2 on the "
        f"refreshed tables against their twins on {N_PROBE} camera rays: "
        f"closest bit-equal {c['closest_bit_equal']}, occlusion agree "
        f"{c['occ_agree']:.6f}, hit {c['hit_frac']:.4f}; {moved_hits} lanes' "
        "t differ from the stale tables'")


def _blob_gradient(torch, mt, card, scene):
    """d mean(image) / d(the last blob's x) on gallery_reparam at its
    config, three ways: plain AD, reparameterized AD (reparam=True) and a
    central difference (BLOB_EPS) on refreshed scenes, with their times and
    the reparameterized backward's peak memory; printed, each finite."""
    from mitsuba2_tpu_torch.scene.scene import refresh_mxu_feat
    cfg = mt.RenderConfig(**REPARAM_GALLERY)
    rows = _blob_rows(torch, scene)

    def loss(rep):
        return lambda th: mt.render(refresh_mxu_feat(_moved(
            torch, scene, rows, th)), cfg.replace(reparam=rep), seed=0).mean()
    fd, fd_ms = _fd(torch, loss(False), BLOB_EPS)
    plain, plain_ms = _grad(torch, loss(False))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rep, rep_ms = _grad(torch, loss(True))
    peak = torch.cuda.max_memory_allocated() - base
    log(f"phase 7: gallery_reparam: d mean(image) / d(blob "
        f"{int(scene.prim_shape.max())}'s x) at {cfg.width}x{cfg.height}x"
        f"{cfg.spp}spp depth {cfg.max_depth} on {card}: plain AD {plain:.6e} "
        f"({plain_ms:.1f} ms), reparameterized AD {rep:.6e} ({rep_ms:.1f} ms, "
        f"backward peak {peak / 2**20:.0f} MiB over the resident), central "
        f"difference (eps {BLOB_EPS}, refreshed scenes) {fd:.6e} "
        f"({fd_ms:.1f} ms); reparam / fd "
        f"{rep / fd if fd else float('nan'):.4f}, plain / fd "
        f"{plain / fd if fd else float('nan'):.4f}")
    check(np.isfinite([fd, plain, rep]).all() and rep != 0.0,
          "gallery_reparam: a non-finite or zero gradient")


def _occluder_check(torch, mt, dev, card, name):
    """Config 5's occluder-translation gradient on one of its scenes
    (OCCLUDER_CHECKS: examples/occluder_pose_grad.py's, through the path
    integrator with reparam=True; tests/test_reparam.py's, through
    render_direct_reparam) on the card: plain AD, reparameterized AD and a
    central difference, held to the JAX tests' bands (|plain| < 0.25
    |FD|; the reparameterized AD of FD's sign, its size within the band),
    and the reparameterized AD on the card against the CPU's within 1e-3
    relative."""
    from mitsuba2_tpu_torch.diff.reparam import render_direct_reparam
    from mitsuba2_tpu_torch.scene import presets
    from mitsuba2_tpu_torch.scene.scene import refresh_mxu_feat
    spec = OCCLUDER_CHECKS[name]
    direct = spec["render"]["max_depth"] == 1
    make = occluder_scene if direct else shadow_scene
    cfg = mt.RenderConfig(**spec["render"])
    for i, d in enumerate(("cpu", dev)):
        scene, rows = make(presets, device=d)
        mask = torch.zeros(scene.n_prims, dtype=torch.bool, device=d)
        mask[torch.as_tensor(rows, device=d)] = True

        def loss(rep):
            def f(th):
                s = refresh_mxu_feat(_moved(torch, scene, mask, th.to(d)))
                if direct and rep:
                    return render_direct_reparam(s, cfg, device=d).mean()
                return mt.render(s, cfg.replace(reparam=rep),
                                 device=d).mean()
            return f
        if i == 0:
            cpu = _grad(torch, loss(True))[0]
            continue
        fd, fd_ms = _fd(torch, loss(False), spec["eps"])
        plain, plain_ms = _grad(torch, loss(False))
        rep, rep_ms = _grad(torch, loss(True))
    lo, hi = spec["band"]
    rel = abs(rep - cpu) / abs(cpu)
    good = (abs(fd) > 1e-3 and abs(plain) < 0.25 * abs(fd)
            and np.sign(rep) == np.sign(fd)
            and lo * abs(fd) < abs(rep) < hi * abs(fd) and rel <= 1e-3)
    log(f"phase 7: {name} ({cfg.width}x{cfg.height}x{cfg.spp}spp, depth "
        f"{cfg.max_depth}) on {card}: central difference (eps "
        f"{spec['eps']}) {fd:+.6f} ({fd_ms:.1f} ms), plain AD {plain:+.6f} "
        f"({plain_ms:.1f} ms), reparameterized AD {rep:+.6f} ({rep_ms:.1f} "
        f"ms; / fd {rep / fd:.4f}, band {lo}-{hi}); the CPU's "
        f"{cpu:+.6f}, card / CPU relative diff {rel:.2e} "
        f"{'ok' if good else 'FAIL'}")
    check(good, f"{name}: the occluder gradient is outside its bands")


def merge_row(by_name, path, row):
    """One kernel row a kernel: a kernel's first path (its own, the
    earlier slice's) keeps the row's numbers and `launches`; each later
    path that runs it adds its numbers under "also_on", and the row's
    max_abs_err is the largest over them all."""
    first = by_name.setdefault(row["name"], {**row, "path": path})
    if first["path"] == path:
        return
    first.setdefault("also_on", []).append({"path": path, **{
        k: row[k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                            "bound_ms", "bound_by")}})
    first["max_abs_err"] = max(first["max_abs_err"], row["max_abs_err"])


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"phase {phase} took {time.perf_counter() - t0:.1f} s")
        return out

    try:
        card = timed(0, phase_device, torch)
        import mitsuba2_tpu_torch as mt
        dev = torch.device(DEVICE)
        timed(1, phase_build)
        scenes, extra = timed(2, phase_kernels_vs_twins, torch, mt, dev)
        by_name, render_ms, launches = {}, {}, {}
        for path, scene in scenes.items():
            with path_switches(path):
                r, render_ms[path], launches[path] = timed(
                    f"3 ({path})", phase_main_path, torch, mt, path, scene,
                    card, extra["spheres_bvh8"] if path == "spheres" else None)
            for row in r:
                merge_row(by_name, path, row)
            if PATH_RENDER.get(path, {}).get("reparam"):
                timed(f"3 ({path}, reparam)", phase_reparam_path, torch,
                      mt, path, scene, card, render_ms[path])
        rows = list(by_name.values())
        timed(4, phase_small_renders, torch, mt, dev)
        for path, scene in scenes.items():
            with path_switches(path):
                timed(f"5 ({path})", phase_profile, torch, mt, path, scene,
                      render_ms[path])
        rows += timed(6, phase_probes, torch, dev, card, launches)
        timed(7, phase_adjoint, torch, mt, dev, card, scenes["gallery"],
              scenes["veach"], scenes["veach_spectral"],
              scenes["gallery_textured"], scenes["gallery_reparam"])
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
