#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mitsuba2_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Twenty-six main paths, each a forward render at 256x256 through
`mitsuba2_tpu_torch.render` (xml_gallery's and gallery_stokes' through
`render_any`, gallery_polarized's through `render_polarized`), 16 spp at
max_depth 3 (in one pass but for
veach, veach_spectral, smoke_box and kitchen_sink) but for config 5's
two, instanced, gallery_dense and kitchen_sink, in rgb but for
veach_spectral, veach_spectral_bvh2, gallery_spectral and gallery_lights,
which render spectrally:
  gallery    mesh_gallery(subdiv=4), 30 732 triangles: the cluster walk
             (K1 closest hit, K2 any hit);
  instanced  instanced_field(n=1024, subdiv=4), 1 024 shared-BLAS instances
             of one 5 120-triangle blob, 5 242 882 effective triangles: the
             instanced cluster walk (K5 closest hit and any hit), at depth
             2 (3 until the media paths came);
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
             every cluster against every ray (K8), at depth 2;
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
             depth 2 (3 until the media paths came, whose time it gave):
             K1 on the 4.2M camera-site and 8.4M bounce-site auxiliary
             rays too (4 launches), K2 (1);
  smoke_box  participating media (volpath): presets.smoke_box(32), a
             32^3 density grid in a null box over a floor, at bench.py
             m_smoke's config (16 spp in passes of 4, depth 3, rr_depth
             8): delta tracking, brute force (16 prims); it also prints
             the delta-tracking trials a flight;
  smoke_box_bvh2  the same scene under set_backend("pallas") with
             MXU_LEAVES off, 16 spp in one pass: the BVH2 walk (K3) on
             volpath's flight and transmittance rays (15 launches, no
             any hit);
  gallery_fog  mesh_gallery(subdiv=4) with a null cube holding a
             homogeneous medium (sigma_t 1, albedo 0.8, g 0.3) around
             its third blob (gallery_fog), volpath: K1 on the flight and
             transmittance rays (15 launches, no any hit);
  kitchen_sink  presets.kitchen_sink(): the thin-lens camera, an envmap,
             textures, a rough conductor, a dielectric sphere and a
             homogeneous medium, 16 spp in passes of 4, depth 4: brute
             force;
  xml_gallery  mesh_gallery(subdiv=4) written as a Mitsuba XML scene
             (write_gallery_xml: the room's quads as ASCII PLY, the
             blobs as binary PLY, .serialized and OBJ files) and loaded
             by mt.load_file, its tables held to the preset's (the parse
             and mesh reads timed apart from the build): K1, K2; then
             `python -m mitsuba2_tpu_torch gallery.xml -o out.pfm` in a
             subprocess, its wall time and launches, its PFM bit-equal
             to the in-process render and within the limits of phase 4
             of the gallery path's;
  gallery_compact  the gallery with RenderConfig(compact=True): each
             bounce permutes the wavefront (dead lanes last, live lanes
             in Morton order of their hits): K1, K2 on the compacted
             wavefronts; its image at seed 0 against the gallery's
             (rtol 1e-5 / atol 1e-6);
  gallery_polarized  gallery_polarized(): mesh_gallery(subdiv=4)'s room,
             light and blobs under smooth gold, glass, a measured rough
             gold (baked at build), the same as measured_polarized with
             gold's Mueller structure, rough copper and a diffuse blob,
             a polarizer pane at 30 degrees and a quarter-wave retarder
             pane, and a constant sky: render_polarized (the Mueller
             chain of the *_polarized variants, BSDF sampling alone): K1
             3 launches, K2 none;
  gallery_stokes   the same scene under the stokes integrator
             (render_any): K1 on the camera and mirror rays, K2 on one
             NEE round;
  gallery_measured the same scene through mt.render: the measured
             families' sampling and lookups, K1 3, K2 2.
After the paths: the polarized paths' peak memory beside the gallery's,
and `python -m mitsuba2_tpu_torch pol.xml -m rgb_polarized` on a small
file scene (a measured plate read from an RGL .bsdf file, gold and glass
spheres, a polarizer and a retarder): its S0 bit-equal to the
in-process render_polarized, its _s1.._s3 sidecars equal at half float.
The variants phase (VARIANTS) renders eleven more paths through
`render_any` at the same size: the gallery under the direct, depth, aov
(all eight AOVs, a path child) and moment (4 passes of 4) integrators,
the stratified sampler with the gaussian filter and the ld sampler with
lanczos, and the gallery seen by gallery_sensor's orthographic camera,
distant sensor, radiance meter (every lane on one ray), irradiance meter
(a floor patch) and moving camera, whose camera-ray K1 launch and first
K2 launch are held bit-equal to their twins; then `python -m
mitsuba2_tpu_torch moment.xml -a depth -a sh_normal`, its mean and
sidecars equal to the in-process results; phase 4 renders each variant
on the card and the CPU.
Each path sets its switches (the backend, the dense switch, MXU_LEAVES)
before it builds its scene (a scene uploads the tables of the walk it
takes) and resets them after each use.

Phase 0  the card, torch, CUDA and nvcc.
Phase 1  builds the CUDA kernels (csrc/cluster_walk.cu and csrc/probes.cu,
         one nvcc each, started together -> ctypes) and the C++ BVH
         builder and OBJ parser from the checkout's sources.
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
         probe rays, and a path on an earlier path's scene and walk
         (gallery_spectral, gallery_reparam, gallery_stokes,
         gallery_measured) is held there once. Prints the walk work the twins count per lane (K4's
         and K6's closest hit: their warps' leaf passes too) and the
         bound of 1M such lanes.
Phase 3  renders each path: launch counts (set to 0 just before the path's
         renders, read just after), time, Mrays/s, peak memory. Each kernel
         is then timed and held against its twin on the very inputs the
         main path gave it (that kernel's twin alone), beside its bound; K6 also on the inputs the
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
         spectral mode, gallery_fog(subdiv=1), without and with
         reparam=True (the camera ray warped), a slab over a random
         density grid and smoke_box(8) with its floor 1e-3 lower (delta
         tracking without ties); and kitchen_sink and
         smoke_box(8), whose dielectric paths and coplanar null box and
         floor may take another turn where the card rounds otherwise:
         their image means within 1e-3 and SMOKE_TIE_RTOL, the share of
         pixels beyond rtol 1e-3 / atol 1e-4 printed. Then a scene from
         files (write_file_scene: OBJ and PLY meshes, an EXR and a PNG
         bitmap, an EXR envmap, a .vol grid, a disk, a cylinder, a
         flip_normals rectangle; volpath) loaded on the card and the
         CPU: its atlas and envmap tables byte-equal to those of the
         same images as arrays, the two renders to the limits above.
         Then gallery_polarized(subdiv=1) on the card and the CPU:
         render_polarized in rgb and spectral mode, render_stokes and
         the measured render within these limits (every Stokes
         component), and the share of 1M random lanes whose measured
         lookup cells the card rounds otherwise (under 1%).
Phase 5  one render of each path under torch.profiler: device time by
         kernel and by kind (the kernels of the texture lookups apart),
         and the device's busy share (xml_gallery's tables are the
         gallery's: not profiled again).
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
         Media: tests/test_medium_grad.py's slabs (medium_slab; the
         homogeneous one's med_data, the heterogeneous one's med_data
         and med_grid) by render_and_grad on the card against the CPU
         within 1e-3 of the largest entry, sigma_t's against a central
         difference on the card within that test's band (rtol 0.12);
         and one render_l2_grad of smoke_box(32) at 128x128, 4 spp,
         depth 3: its time and peak memory.

Phase 8  several processes and long renders: render_instrumented on the
         gallery (4 passes of 4: a JSONL record a pass, the image
         render()'s, a cancel after two passes the 2-pass image);
         render_sharded over an NCCL group of one rank in this process
         (a FileStore): bit-equal to render(); then two gloo ranks on
         the one card (NCCL refuses two ranks on one device), spawned,
         each building the gallery: render_sharded (524 288 lanes a
         rank; its camera K1 launch and first K2 launch held bit-equal
         to their twins and timed, one rank at a time), within rtol
         2e-5 / atol 2e-5 of render(); render_and_grad_sharded at the
         gallery's adjoint config, its gradients within rtol 5e-4 / atol
         1e-6 of render_l2_grad's; four train steps (the loss falls); an
         optimization checkpointed after 2 of 3 steps and resumed from
         the file, mat_data within rtol 1e-6 / atol 1e-8 of the
         uninterrupted run's; gallery_reparam's config sharded, within
         rtol 1e-4 / atol 1e-5 of one process. Each rank's results
         equal; a failed or hung rank (DIST_TIMEOUT) fails the phase.

Prints each phase's wall time, the card's `nvidia-smi` name and power
limit, a JSON line {"kernels": [...]} (one row a kernel: its first path's
numbers, a later path's under "also_on") and, last, {"ok": true,
"device": {...}}. Exits non-zero without printing a result when there is
no CUDA device or a phase fails.
"""
import contextlib
import dataclasses
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
# rr_depth 8, K 16), and the gallery in one pass of 4 spp at depth 2 (a
# bounce's aux rays, 8.4M lanes, once: the smoke's time limit)
REPARAM_CORNELL = dict(width=256, height=256, spp=16, spp_per_pass=4,
                       max_depth=4, rr_depth=8, reparam=True,
                       reparam_kaux=16)
REPARAM_GALLERY = dict(width=256, height=256, spp=4, spp_per_pass=4,
                       max_depth=2, rr_depth=8, reparam=True)
# participating media: bench.py m_smoke's config (:390-406): smoke_box(32),
# 16 spp in passes of 4, depth 3, rr_depth 8, volpath; kitchen_sink in
# passes of 4 at depth 4 (the golden's depth)
SMOKE_RES = 32
SMOKE_RENDER = dict(width=256, height=256, spp=16, spp_per_pass=4,
                    max_depth=3, rr_depth=8, integrator="volpath")
KITCHEN_RENDER = dict(width=256, height=256, spp=16, spp_per_pass=4,
                      max_depth=4, rr_depth=8)
# gallery_fog's medium, in a null cube of half-extent FOG_HALF about its
# blob FOG_BLOB
FOG = {"type": "homogeneous", "sigma_t": 1.0, "albedo": 0.8, "g": 0.3}
FOG_BLOB, FOG_HALF = 2, 0.5
# tests/test_medium_grad.py's slabs and config: the homogeneous slab's
# sigma_t and seed, the heterogeneous one's and its grid; the central
# difference's step and band
MEDIUM_SLABS = {"homogeneous": dict(sigma=0.6, seed=3),
                "heterogeneous": dict(sigma=0.8, seed=5,
                                      grid=np.full((4, 8, 8), 1.0,
                                                   np.float32))}
MEDIUM_GRAD = dict(width=24, height=24, spp=32, spp_per_pass=32,
                   max_depth=3, integrator="volpath")
MEDIUM_FD_EPS, MEDIUM_FD_RTOL = 0.05, 0.12
# phase 4's tie-free delta-tracked scene: a slab over a random grid
GRID_SLAB = dict(sigma=1.2, albedo=0.7, grid=np.random.default_rng(9).uniform(
    0, 1.5, (4, 6, 6)).astype(np.float32))
# smoke_box's null box and its floor share the plane y = 0: a lane that
# leaves the smoke downward meets both at one t, and an ulp of its origin
# (the card's sines and cosines) decides which it takes. Phase 4 holds its
# card-vs-CPU image mean within this (1e-3 is not met: ROADMAP Queue 3)
SMOKE_TIE_RTOL = 2e-2
# one render_l2_grad of smoke_box(32)
SMOKE_ADJOINT = dict(width=128, height=128, spp=4, spp_per_pass=4,
                     max_depth=3, rr_depth=8, integrator="volpath")
PATH_RENDER = {"veach": VEACH_RENDER,
               "veach_spectral": {**VEACH_RENDER, **SPECTRAL},
               "veach_spectral_bvh2": {**RENDER, **SPECTRAL},
               "gallery_spectral": {**RENDER, **SPECTRAL},
               "gallery_lights": {**RENDER, **SPECTRAL},
               "cornell_reparam": REPARAM_CORNELL,
               "gallery_reparam": REPARAM_GALLERY,
               # depth 2 since the media paths came, whose time they gave
               # (their K5 and K8 twins take seconds a launch)
               "instanced": {**RENDER, "max_depth": 2},
               "gallery_dense": {**RENDER, "max_depth": 2},
               "smoke_box": SMOKE_RENDER,
               "smoke_box_bvh2": {**SMOKE_RENDER, "spp_per_pass": 16},
               "gallery_fog": {**RENDER, "integrator": "volpath"},
               "kitchen_sink": KITCHEN_RENDER,
               "gallery_compact": {**RENDER, "compact": True},
               "gallery_polarized": {**RENDER, "polarized": True},
               "gallery_stokes": {**RENDER, "integrator": "stokes"}}
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
# each path's closest-hit and any-hit kernels: max_depth and max_depth - 1
# launches a render (the camera and a bounce wavefront a bounce, a shadow
# round a bounce: 3 and 2 at depth 3), 0 of the rest;
# none on veach, whose 16 prims take brute force; a volumetric path's
# closest hit alone (its shadow rays measure transmittance)
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
    "smoke_box": (),
    "smoke_box_bvh2": ("bvh_closest_hit",),
    "gallery_fog": ("cluster_closest_hit",),
    "kitchen_sink": (),
    "xml_gallery": ("cluster_closest_hit", "cluster_any_hit"),
    "gallery_compact": ("cluster_closest_hit", "cluster_any_hit"),
    "gallery_polarized": ("cluster_closest_hit", "cluster_any_hit"),
    "gallery_stokes": ("cluster_closest_hit", "cluster_any_hit"),
    "gallery_measured": ("cluster_closest_hit", "cluster_any_hit"),
}
# the paths rendered through another entry point than mt.render (the
# loader's and the CLI's render_any, the polarized transport's
# render_polarized), and the stokes integrator's, whose image is its S0
PATH_ENTRY = {"xml_gallery": "render_any",
              "gallery_polarized": "render_polarized",
              "gallery_stokes": "render_any"}
STOKES_PATHS = {"gallery_stokes"}
# the backend each path (and phase 2's extra scene) runs under, the paths
# with the dense switch on, and the path whose scene geometry and probe
# rays each shares
BACKEND = {"gallery_bvh8": "bvh8", "gallery_bvh8mxu": "bvh8mxu",
           "spheres_bvh8": "bvh8", "veach_bvh2": "pallas",
           "veach_spectral_bvh2": "pallas", "smoke_box_bvh2": "pallas"}
DENSE = {"gallery_dense"}
# the paths with MXU_LEAVES off: the BVH2 walk on a triangle scene
LEAVES_OFF = {"smoke_box_bvh2"}
# the paths phase 5 profiles one pass of: the profiler's host cost is
# ~0.4 ms a launch, and cornell_reparam's renders launch ~240 000 kernels
# (veach's and veach_spectral's 42 000 and 62 000, since PR 21)
PROFILE_ONE_PASS = {"cornell_reparam", "smoke_box", "kitchen_sink",
                    "veach", "veach_spectral"}
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
              "gallery_spectral": "gallery", "gallery_reparam": "gallery",
              "gallery_compact": "gallery",
              "gallery_stokes": "gallery_polarized",
              "gallery_measured": "gallery_polarized"}
# the paths under RenderConfig(compact=True): the gallery's scene and walk
# on permuted wavefronts, whose probe rays phase 2 does not repeat
COMPACT = {"gallery_compact"}
# the probes' configurations at 1M lanes: P1 over the gallery-sized table
# (L1-resident) and one of the sphere field's BVH2 size (8 MiB, in L2)
PROBE_LANES = 1 << 20
P1_STEPS, P2_STEPS, P3_STEPS = 256, 16, 64
P1_ROWS = (768, 262144)
P3_MODES = {0: "step", 4: "visit4", 1: "visit1"}
PROBE_REPS = 5
EXPECTED_LAUNCHES = {
    path: {k: (PATH_RENDER.get(path, RENDER)["max_depth"]
               - (0 if k in ks[:1] else 1)) if k in ks else 0
           for k in REPLACES}
    for path, ks in PATH_KERNELS.items()}
# reparam=True adds one closest-hit launch a warp site: the camera's
# auxiliary rays, and each bounce's NEE and BSDF sites' in one; at depth 2
# one bounce: a closest hit and a shadow ray
EXPECTED_LAUNCHES["gallery_reparam"].update(
    cluster_closest_hit=4, cluster_any_hit=1)
# the polarized transport samples BSDFs alone (no NEE): a closest hit a
# vertex, no any hit; the stokes integrator's camera and mirror rays and
# one NEE shadow ray
EXPECTED_LAUNCHES["gallery_polarized"].update(cluster_any_hit=0)
EXPECTED_LAUNCHES["gallery_stokes"].update(cluster_closest_hit=2,
                                           cluster_any_hit=1)


def volpath_closest_launches(max_depth):
    """A volpath render pass's closest-hit launches: a flight a bounce
    and the trailing one, and each bounce's two shadow rays, whose
    transmittance crosses up to _MAX_NULL = 3 null boundaries, a launch
    a segment."""
    return 7 * (max_depth - 1) + 1


for _path in ("smoke_box_bvh2", "gallery_fog"):
    _cfg = PATH_RENDER[_path]
    EXPECTED_LAUNCHES[_path][PATH_KERNELS[_path][0]] = (
        volpath_closest_launches(_cfg["max_depth"])
        * (_cfg["spp"] // _cfg["spp_per_pass"]))


# phase 8: two gloo ranks on the one card (NCCL refuses two ranks on one
# device), spawned; the limit of their whole run (start, scene build,
# every case), their Adam steps (tests/test_sharding.py's four) and the
# checkpoint's step (2 of 3)
DIST_RANKS = 2
DIST_TIMEOUT = 480
DIST_TRAIN_STEPS, DIST_LR = 4, 0.05
DIST_CKPT_STEP = 2
# render_instrumented on the gallery: 4 passes of 4
INSTRUMENTED = {**RENDER, "spp_per_pass": 4}


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
        # the OBJ parser, built at its first parse: a triangle's
        import tempfile
        with tempfile.NamedTemporaryFile("w", suffix=".obj") as f:
            f.write("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
            f.flush()
            native.parse_obj_native(f.name)
        for j in jobs:
            j.result()
    traverse.load_cuda_library()
    probes.load_cuda_library()
    log(f"phase 1: built {SRC} and {PROBE_SRC} (route cuda: nvcc "
        f"{' '.join(traverse.NVCC_FLAGS)} -> ctypes), the C++ BVH "
        f"builder and OBJ parser in {time.perf_counter() - t0:.1f} s")
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


def switch_values(path):
    """(backend, dense switch, MXU_LEAVES) of a main path (or of phase 2's
    extra scene)."""
    return (BACKEND.get(path, "auto"), "1" if path in DENSE else "0",
            path not in LEAVES_OFF)


def path_switches(path):
    """The switches of a main path (or of phase 2's extra scene)."""
    return switches(*switch_values(path))


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
    # the cluster walks' twins in 1M-lane chunks: 8x faster than in 64k
    # chunks on a 1M-lane K1 launch (0.50 against 4.20 s, 6.6 GiB peak;
    # per-lane arithmetic, so the same outputs)
    return dict(
        closest="cluster_closest_hit", any="cluster_any_hit",
        closest_plain=traverse.closest_hit_plain,
        any_plain=traverse.any_hit_plain,
        tabs=(scene.mxu_node_f, scene.mxu_link, scene.cluster_feat),
        extra=(scene.cluster_k,), ids=(1,), uv=False, chunk=1 << 20)


def wrapper(name):
    from mitsuba2_tpu_torch.kernels import traverse
    return getattr(traverse, name)


def compare(torch, ks, rays):
    """Both kernels and both twins on the same CUDA tensors, every lane:
    compare_one's two records, each kernel's own fields, and bit_equal
    over both kernels' outputs."""
    c = compare_one(torch, ks, ks["closest"], rays)
    a = compare_one(torch, ks, ks["any"], rays)
    return {**c, **{k: a[k] for k in ("occ_agree", "occ_max_abs_err",
                                      "any_plain_ms", "any_stats")},
            "bit_equal": c["bit_equal"] and a["bit_equal"]}


def compare_one(torch, ks, name, rays):
    """Kernel `name` (of `ks`) and its twin alone on the same CUDA
    tensors, every lane: agreement, the twin's time (ms, CUDA events) and
    the walk work it counted; the other kernel's fields vacuous (a
    launch's rays are its own kernel's inputs: the other kernel never
    sees them on the main path)."""
    tabs, extra = ks["tabs"], ks["extra"]
    closest = name == ks["closest"]
    out_k = wrapper(name)(*tabs, *rays, *extra)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    st = {}
    ev[0].record()
    out_p = ks["closest_plain" if closest else "any_plain"](
        *tabs, *rays, *extra, chunk=ks["chunk"], stats=st)
    ev[1].record()
    torch.cuda.synchronize()
    plain_ms = ev[0].elapsed_time(ev[1])
    if not closest:
        agree = float((out_k == out_p).float().mean())
        return {"bit_equal": bool(torch.equal(out_k, out_p)),
                "closest_bit_equal": True, "hit_equal": True,
                "hit_frac": float(out_p.float().mean()), "slot_agree": 1.0,
                "t_ok_same": True, "t_ok_tie": True, "t_max_abs_err": 0.0,
                "uv_max_abs_err": 0.0, "occ_agree": agree,
                "occ_max_abs_err": float((out_k.int()
                                          - out_p.int()).abs().max()),
                "any_plain_ms": plain_ms, "any_stats": st}
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
    equal = all(torch.equal(a, b) for a, b in zip(out_k, out_p))
    return {
        "bit_equal": equal, "closest_bit_equal": equal,
        "hit_equal": bool(torch.equal(hit_k, hit_p)),
        "hit_frac": n_hit / t_p.numel(),
        # a launch whose lanes all miss (a shadow segment no lane still
        # walks) agrees vacuously
        "slot_agree": int(same.sum()) / n_hit if n_hit else 1.0,
        "t_ok_same": bool((dt[same] <= tol[same]).all()),
        "t_ok_tie": bool((dt[both & ~same] <= tol[both & ~same]).all()),
        "t_max_abs_err": float(dt[both].max()) if bool(both.any()) else 0.0,
        "uv_max_abs_err": uv_err, "occ_agree": 1.0, "occ_max_abs_err": 0.0,
        "closest_plain_ms": plain_ms, "closest_stats": st}


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


# gallery_polarized: the gallery's blobs under the polarized and measured
# families, by blob index: a smooth gold conductor, a dielectric, a
# measured capture baked from rough gold (alpha 0.2, the default 32 x 64 x
# 64 grid), the same bake as measured_polarized with gold's Mueller
# structure (green channel's complex IOR), a rough copper conductor and a
# diffuse blob; a polarizer pane at 30 degrees and a quarter-wave retarder
# pane in front of the outer blobs; a constant environment beside the
# area light, which the open front lets BSDF-sampled paths find
ROUGH_AU = {"type": "roughconductor", "material": "Au", "alpha": 0.2}
AU_ETA = complex(0.3749, 2.3857)
POLARIZED_MATERIALS = (
    {"type": "conductor", "material": "Au"},
    {"type": "dielectric", "int_ior": "bk7"},
    {"type": "measured", "bake": ROUGH_AU},
    {"type": "measured_polarized", "bake": ROUGH_AU, "pbake_eta": AU_ETA},
    {"type": "roughconductor", "material": "Cu", "alpha": 0.1},
    {"type": "diffuse", "reflectance": GALLERY_ALBEDO[5]},
)
POLARIZED_PANES = (
    ({"type": "polarizer", "theta": 30.0}, 2.1, 2.9, "polarizer"),
    ({"type": "retarder", "theta": 0.0, "delta": 90.0}, 0.1, 0.9,
     "retarder"),
)
POLARIZED_SKY = {"type": "constant", "radiance": [0.5, 0.5, 0.5]}


def gallery_polarized(P, subdiv=SUBDIV, **build_kw):
    """mesh_gallery(subdiv)'s room, light and blobs (the same seeds and
    placement) under POLARIZED_MATERIALS, the two POLARIZED_PANES and
    POLARIZED_SKY, built from the presets module `P` of either package:
    6 x 20 x 4^subdiv + 16 triangles. The measured tables are baked at
    build time (each package evaluating its own rough gold)."""
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
    for k in range(6):
        i, j = divmod(k, 2)
        v = P._displace(base_v.copy(), seed=k)
        v = v * 0.34 + np.asarray([(i + 0.5) * X / 3,
                                   0.45 + 0.1 * ((i + j) % 3),
                                   (j + 0.75) * Z / 2.5], np.float32)
        s.append(P.shapes.mesh(v, faces, bsdf=dict(POLARIZED_MATERIALS[k]),
                               id=f"blob{k}"))
    for bsdf, x0, x1, name in POLARIZED_PANES:
        s.append(P._quad([x1, 0.05, 0.3], [x0, 0.05, 0.3], [x0, 1.2, 0.3],
                         [x1, 1.2, 0.3], bsdf=dict(bsdf), id=name))
    cam = P.Transform4.look_at(origin=[X / 2, 1.0, -2.6],
                               target=[X / 2, 0.8, 1.5], up=[0, 1, 0])
    sensor = {"type": "perspective", "to_world": np.asarray(cam.matrix),
              "fov": 50.0}
    return P.build_scene(s, sensor, emitters=[dict(POLARIZED_SKY)],
                         **build_kw)


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


def medium_slab(P, sigma=0.6, albedo=0.0, grid=None, **build_kw):
    """tests/test_medium_grad.py's slab, built from the presets module `P`
    of either package: a null cube (half-extents 2, 2, 0.5) holding a
    homogeneous medium of extinction `sigma`, or a heterogeneous one over
    `grid` (D, H, W) spanning the cube, in front of an emissive wall."""
    T = P.Transform4
    cube = P.shapes.cube(bsdf={"type": "null"}, id="vol").transformed(
        np.asarray((T.translate([0, 0, 0]) @ T.scale([2.0, 2.0, 0.5]))
                   .matrix))
    wall = P.shapes.rectangle(
        bsdf={"type": "diffuse", "reflectance": [0, 0, 0]},
        emitter={"type": "area", "radiance": [2.0] * 3},
        id="wall").transformed(np.asarray(T.translate([0, 0, -2.0]).matrix))
    med = {"type": "homogeneous", "sigma_t": sigma, "albedo": albedo}
    if grid is not None:
        med = {"type": "heterogeneous", "sigma_t": sigma,
               "albedo": albedo, "density": grid,
               "bbox_min": [-2.0, -2.0, -0.5], "bbox_max": [2.0, 2.0, 0.5]}
    cube.interior = med
    cam = T.look_at(origin=[0, 0, 4], target=[0, 0, 0], up=[0, 1, 0])
    return P.build_scene([cube, wall],
                         {"type": "perspective",
                          "to_world": np.asarray(cam.matrix), "fov": 25.0},
                         **build_kw)


def smoke_floor_lowered(mt, device, dy=1e-3):
    """smoke_box(8) with its floor (shape 1) moved dy down, off the plane
    of the null box's bottom face: the scene without its tie (brute
    force reads the prim tables as they stand)."""
    import dataclasses
    scene = mt.smoke_box(8, device=device)
    floor = (scene.prim_shape == 1)[:, None] & (
        scene.prim_p0.new_tensor([0.0, 1.0, 0.0]) > 0)
    return dataclasses.replace(scene, prim_p0=scene.prim_p0 - floor * dy)


def gallery_fog(P, subdiv=SUBDIV, **build_kw):
    """mesh_gallery(subdiv)'s room, light and blobs (the same seeds,
    placement and albedos) with a null cube of half-extent FOG_HALF about
    blob FOG_BLOB holding the homogeneous medium FOG, built from the
    presets module `P` of either package: 6 x 20 x 4^subdiv + 24
    triangles."""
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
            c = np.asarray([(i + 0.5) * X / nx, 0.45 + 0.1 * ((i + j) % 3),
                            (j + 0.75) * Z / (nz + 0.5)], np.float32)
            s.append(P.shapes.mesh(
                v * 0.34 + c, faces, bsdf={
                    "type": "diffuse", "reflectance": GALLERY_ALBEDO[k]},
                id=f"blob{k}"))
            if k == FOG_BLOB:
                fog = P.shapes.cube(bsdf={"type": "null"},
                                    id="fog").transformed(np.asarray(
                                        (P.Transform4.translate(c)
                                         @ P.Transform4.scale(
                                             [FOG_HALF] * 3)).matrix))
                fog.interior = dict(FOG)
                s.append(fog)
            k += 1
    cam = P.Transform4.look_at(origin=[X / 2, 1.0, -2.6],
                               target=[X / 2, 0.8, 1.5], up=[0, 1, 0])
    sensor = {"type": "perspective", "to_world": np.asarray(cam.matrix),
              "fov": 50.0}
    return P.build_scene(s, sensor, **build_kw)


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


# ---------------------------------------------------------------------------
# The variants phase's scenes: mesh_gallery's shapes seen by each sensor
# ---------------------------------------------------------------------------

def _rot(axis, deg):
    """A 4x4 rotation (float64) about `axis` by `deg` degrees."""
    x, y, z = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    c, s_ = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
    m = np.eye(4)
    m[:3, :3] = [[c + x * x * (1 - c), x * y * (1 - c) - z * s_,
                  x * z * (1 - c) + y * s_],
                 [y * x * (1 - c) + z * s_, c + y * y * (1 - c),
                  y * z * (1 - c) - x * s_],
                 [z * x * (1 - c) - y * s_, z * y * (1 - c) + x * s_,
                  c + z * z * (1 - c)]]
    return m


def _affine(*mats):
    """The product of 4x4 matrices in float64, as float32 (the same
    sensor whichever package builds it)."""
    out = np.eye(4)
    for m in mats:
        out = out @ np.asarray(m, np.float64)
    return out.astype(np.float32)


def variant_sensor(P, kind, cam):
    """The sensor dict of the variants phase's `kind` around the gallery
    camera's to_world `cam`: an orthographic view of the room 1.6 wide, a
    distant sensor looking down into the room, a radiance meter at a
    blob, an irradiance meter on a 0.6 x 0.6 rectangle 5 cm above the
    floor facing up, and the camera moving over its shutter by 0.15 to
    the right with a 10 degree yaw."""
    look = P.Transform4.look_at
    if kind == "orthographic":
        return {"type": kind,
                "to_world": _affine(cam, np.diag([1.6, 1.6, 1.0, 1.0]))}
    if kind == "distant":
        return {"type": kind, "to_world": np.asarray(look(
            origin=[1.5, 3.0, -0.5], target=[1.5, 0.0, 1.8],
            up=[0, 1, 0]).matrix)}
    if kind == "radiancemeter":
        return {"type": kind, "to_world": np.asarray(look(
            origin=[1.5, 1.0, -1.0], target=[0.5, 0.45, 0.9],
            up=[0, 1, 0]).matrix)}
    if kind == "irradiancemeter":
        shift = np.eye(4)
        shift[:3, 3] = [1.5, 0.05, 0.5]
        return {"type": kind, "to_world": _affine(
            shift, _rot([1, 0, 0], -90.0), np.diag([0.3, 0.3, 1.0, 1.0]))}
    if kind == "motion":
        shift = np.eye(4)
        shift[0, 3] = 0.15
        moved = _affine(shift, cam, _rot([0, 1, 0], 10.0))
        return {"type": "perspective", "to_world": cam, "fov": 50.0,
                "to_world_keys": [(0.0, cam), (1.0, moved)]}
    raise ValueError(kind)


def gallery_sensor(kind, subdiv=SUBDIV, **build_kw):
    """mesh_gallery(subdiv)'s shapes (presets.mesh_gallery_shapes) seen by
    variant_sensor(kind) around the gallery's camera."""
    from mitsuba2_tpu_torch.scene import presets
    s, sensor = presets.mesh_gallery_shapes(subdiv)
    return presets.build_scene(
        s, variant_sensor(presets, kind, np.asarray(sensor["to_world"])),
        **build_kw)


# ---------------------------------------------------------------------------
# Scenes from files: the XML gallery (the path xml_gallery) and phase 4's
# small scene from files
# ---------------------------------------------------------------------------

def _g(*xs):
    """Numbers as Mitsuba XML text, each float32 value exactly (%.9g)."""
    return " ".join("%.9g" % float(np.float32(x)) for x in xs)


def _write_ply(path, verts, faces, uvs=None, ascii=False):
    """A PLY of float32 vertices (and uvs) and triangle faces."""
    names = ["x", "y", "z"] + (["u", "v"] if uvs is not None else [])
    vals = verts if uvs is None else np.concatenate([verts, uvs], -1)
    fmt = "ascii" if ascii else "binary_little_endian"
    hdr = (f"ply\nformat {fmt} 1.0\nelement vertex {len(verts)}\n"
           + "".join(f"property float {n}\n" for n in names)
           + f"element face {len(faces)}\n"
           "property list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(hdr.encode())
        if ascii:
            f.write("".join(_g(*r) + "\n" for r in vals).encode())
            f.write("".join("3 %d %d %d\n" % tuple(r) for r in faces).encode())
        else:
            f.write(np.ascontiguousarray(vals, "<f4").tobytes())
            rows = np.zeros(len(faces), [("n", "u1"), ("i", "<i4", (3,))])
            rows["n"], rows["i"] = 3, faces
            f.write(rows.tobytes())


def write_gallery_xml(d, subdiv=SUBDIV, render=RENDER):
    """mesh_gallery(subdiv) as a Mitsuba scene in directory `d`, its
    scene.xml naming a file a shape: the room's six quads as ASCII PLY,
    the blobs in turn as binary PLY, .serialized and OBJ (every value
    float32 exactly: binary, or %.9g text), its BSDFs and area light
    inline, the camera's matrix with %.9g, and film, sampler and
    integrator blocks of `render`'s width, height, spp, max_depth and
    rr_depth. Loaded, it builds the preset's tables byte for byte.
    Returns the XML's path."""
    from mitsuba2_tpu_torch.scene import mesh_io, presets
    shapes_, sensor = presets.mesh_gallery_shapes(subdiv)
    body = []
    for k, m in enumerate(shapes_):
        kind = ("ply" if m.uvs is not None else
                ("ply", "serialized", "obj")[k % 3])
        name = f"{m.id}.{kind}"
        path = os.path.join(d, name)
        if kind == "obj":
            with open(path, "w") as f:
                f.write("".join("v " + _g(*v) + "\n" for v in m.vertices))
                f.write("".join("f %d %d %d\n" % tuple(r + 1)
                                for r in m.faces))
        elif kind == "serialized":
            mesh_io.save_serialized(path, m, name=m.id)
        else:
            _write_ply(path, m.vertices, m.faces, m.uvs,
                       ascii=m.uvs is not None)
        emitter = ("" if m.emitter is None else
                   f'<emitter type="area"><rgb name="radiance" value="'
                   f'{_g(*m.emitter["radiance"])}"/></emitter>')
        body.append(
            f'<shape type="{kind}" id="{m.id}">'
            f'<string name="filename" value="{name}"/>'
            f'<bsdf type="diffuse"><rgb name="reflectance" value="'
            f'{_g(*m.bsdf["reflectance"])}"/></bsdf>{emitter}</shape>')
    xml = f"""<scene version="2.0.0">
  <integrator type="path">
    <integer name="max_depth" value="{render['max_depth']}"/>
    <integer name="rr_depth" value="{render['rr_depth']}"/>
  </integrator>
  <sensor type="perspective">
    <float name="fov" value="{_g(sensor['fov'])}"/>
    <transform name="to_world">
      <matrix value="{_g(*np.asarray(sensor['to_world']).reshape(-1))}"/>
    </transform>
    <film type="hdrfilm">
      <integer name="width" value="{render['width']}"/>
      <integer name="height" value="{render['height']}"/>
    </film>
    <sampler type="independent">
      <integer name="sample_count" value="{render['spp']}"/>
    </sampler>
  </sensor>
  {chr(10).join('  ' + b for b in body)}
</scene>
"""
    path = os.path.join(d, "gallery.xml")
    with open(path, "w") as f:
        f.write(xml)
    return path


# phase 4's scene from files: its images' seed
FILE_SEED = 21


def write_file_scene(d, medium=True):
    """A small scene from files in directory `d` (scene.xml, $res square
    at $spp spp, 32 and 2 by default): an OBJ floor with uvs and a normal
    under a float EXR bitmap albedo, a binary-PLY blob, a disk under an
    8-bit PNG bitmap (read by the port's own codec), a cylinder, a
    rectangle with flip_normals turning it to the camera, an envmap from
    a half EXR, and with `medium` a null cube holding a heterogeneous
    medium over a .vol density grid (HG, g 0.3; volpath, else path). The
    bitmaps' paths are absolute: the loader resolves an envmap's, a
    mesh's and a grid's file against the scene's directory, not a
    texture's. Returns the XML's path and the arrays the two bitmaps and
    the envmap decode to (the bitmaps linearised, as no `raw` is set)."""
    from mitsuba2_tpu_torch.core import io_bitmap, io_vol
    from mitsuba2_tpu_torch.scene import presets
    rng = np.random.default_rng(FILE_SEED)
    albedo = rng.uniform(0.05, 0.95, (16, 16, 3)).astype(np.float32)
    io_bitmap.write_exr(os.path.join(d, "albedo.exr"), albedo, half=False)
    stripes = np.zeros((8, 8, 3), np.float32)
    stripes[:, ::2] = (0.9, 0.2, 0.1)
    stripes[:, 1::2] = rng.uniform(0.1, 0.9, 3)
    io_bitmap.write(os.path.join(d, "stripes.png"), stripes)
    io_bitmap.write_exr(os.path.join(d, "sky.exr"), rng.uniform(
        0.2, 2.0, (16, 32, 3)).astype(np.float32), half=True)
    io_vol.write_vol(os.path.join(d, "grid.vol"), rng.uniform(
        0.0, 3.0, (6, 6, 6)).astype(np.float32), (0.5, 0.5, -0.5),
        (1.5, 1.5, 0.5))
    with open(os.path.join(d, "floor.obj"), "w") as f:
        f.write("v -3 0 -3\nv 3 0 -3\nv 3 0 3\nv -3 0 3\n"
                "vt 0 0\nvt 2 0\nvt 2 2\nvt 0 2\nvn 0 1 0\n"
                "f 1/1/1 4/4/1 3/3/1 2/2/1\n")
    v, faces = presets._icosphere(1)
    _write_ply(os.path.join(d, "blob.ply"),
               (v * 0.5 + np.float32([-1.0, 0.5, 0.5])).astype(np.float32),
               faces)
    med = ("""
  <shape type="cube">
    <transform name="to_world"><scale value="0.5"/>
      <translate x="1" y="1" z="0"/></transform>
    <bsdf type="null"/>
    <medium type="heterogeneous" name="interior">
      <volume name="density" type="gridvolume">
        <string name="filename" value="grid.vol"/></volume>
      <float name="sigma_t" value="1.5"/>
      <rgb name="albedo" value="0.8 0.7 0.6"/>
      <phase type="hg"><float name="g" value="0.3"/></phase>
    </medium>
  </shape>""" if medium else "")
    xml = f"""<scene version="2.0.0">
  <default name="res" value="32"/>
  <default name="spp" value="2"/>
  <integrator type="{'volpath' if medium else 'path'}">
    <integer name="max_depth" value="3"/></integrator>
  <sensor type="perspective">
    <float name="fov" value="50"/>
    <transform name="to_world">
      <lookat origin="0 2.2 -4" target="0 0.6 0.5" up="0 1 0"/></transform>
    <film type="hdrfilm"><integer name="width" value="$res"/>
      <integer name="height" value="$res"/></film>
    <sampler type="independent">
      <integer name="sample_count" value="$spp"/></sampler>
  </sensor>
  <emitter type="envmap"><string name="filename" value="sky.exr"/></emitter>
  <shape type="obj" id="floor"><string name="filename" value="floor.obj"/>
    <bsdf type="diffuse"><texture name="reflectance" type="bitmap">
      <string name="filename" value="{d}/albedo.exr"/></texture></bsdf>
  </shape>
  <shape type="ply" id="blob"><string name="filename" value="blob.ply"/>
    <bsdf type="roughconductor"><float name="alpha" value="0.2"/></bsdf>
  </shape>
  <shape type="disk" id="disk">
    <transform name="to_world"><scale value="0.6"/>
      <rotate x="1" angle="-120"/><translate x="0.2" y="0.7" z="1.6"/>
    </transform>
    <bsdf type="diffuse"><texture name="reflectance" type="bitmap">
      <string name="filename" value="{d}/stripes.png"/>
      <string name="filter_type" value="nearest"/></texture></bsdf>
  </shape>
  <shape type="cylinder" id="post"><float name="radius" value="0.2"/>
    <transform name="to_world"><rotate x="1" angle="-90"/>
      <translate x="-1.6" y="0" z="1.2"/></transform>
    <bsdf type="diffuse"><rgb name="reflectance" value="0.3 0.6 0.3"/></bsdf>
  </shape>
  <shape type="rectangle" id="wall">
    <boolean name="flip_normals" value="true"/>
    <transform name="to_world"><scale x="3" y="1.5"/>
      <translate y="1.5" z="3"/></transform>
    <bsdf type="diffuse"><rgb name="reflectance" value="0.7 0.7 0.75"/></bsdf>
  </shape>{med}
</scene>
"""
    path = os.path.join(d, "scene.xml")
    with open(path, "w") as f:
        f.write(xml)
    arrays = {"albedo": io_bitmap.srgb_to_linear(albedo),
              "stripes": io_bitmap.srgb_to_linear(io_bitmap.read(
                  os.path.join(d, "stripes.png"))),
              "sky": io_bitmap.read(os.path.join(d, "sky.exr"))}
    return path, arrays


def file_scene_from_arrays(mt, arrays, device):
    """write_file_scene's bitmaps and envmap given as arrays, in its
    texture order: a scene whose atlas and envmap tables the file scene's
    must equal byte for byte."""
    from mitsuba2_tpu_torch.scene import shapes
    quads = [shapes.rectangle(bsdf={"type": "diffuse", "reflectance": {
        "type": "bitmap", "data": arrays[k], **kw}})
        for k, kw in (("albedo", {}), ("stripes", {"filter_type": "nearest"}))]
    return mt.build_scene(quads, {"type": "perspective",
                                  "to_world": np.eye(4), "fov": 50.0},
                          [{"type": "envmap", "data": arrays["sky"]}],
                          device=device)


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
    scenes.update(_media_scenes(mt, dev))
    scenes["gallery_compact"] = gallery
    scenes.update(_polarized_scenes(mt, dev))
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
        if not PATH_KERNELS.get(name, True) or name in COMPACT:
            continue
        base = SAME_SCENE.get(name)
        if scenes.get(base) is scene and switch_values(name) == switch_values(
                base):
            # the same scene, walk and probe rays: the same comparisons
            log(f"phase 2: {name}: {base}'s scene, walk and probe rays, "
                "held there")
            continue
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


def _media_scenes(mt, dev):
    """The participating-media paths' scenes: smoke_box(SMOKE_RES) (brute
    force) and again under its path's switches (the BVH2 walk, K3),
    gallery_fog at SUBDIV (the cluster walk, K1) and kitchen_sink (brute
    force)."""
    from mitsuba2_tpu_torch.scene import presets
    make = {"smoke_box": functools.partial(mt.smoke_box, SMOKE_RES,
                                           device=dev),
            "smoke_box_bvh2": functools.partial(mt.smoke_box, SMOKE_RES,
                                                device=dev),
            "gallery_fog": functools.partial(gallery_fog, presets, SUBDIV,
                                             device=dev),
            "kitchen_sink": functools.partial(mt.kitchen_sink, device=dev)}
    want = {"smoke_box": "brute force", "smoke_box_bvh2": "BVH2",
            "gallery_fog": "cluster", "kitchen_sink": "brute force"}
    out = {}
    for name in make:
        t0 = time.perf_counter()
        with path_switches(name):
            scene = out[name] = make[name]()
        walk = ("BVH2" if scene.bvh_node is not None else "cluster"
                if scene.mxu_node_f is not None else "brute force")
        grid = scene.medium_grid
        log(f"phase 2: built {name} in {time.perf_counter() - t0:.1f} s: "
            f"{scene.n_prims} prims, {scene.med_data.shape[0]} medium "
            f"row(s), density grid "
            f"{tuple(grid.data.shape) if grid is not None else None}, "
            f"sensor {scene.cam_type}, {walk}")
        check(walk == want[name], f"{name} took the {walk} walk")
        check(scene.has_media, f"{name}: no medium")
    return out


def _polarized_scenes(mt, dev):
    """The polarized slice's paths, all on gallery_polarized at SUBDIV
    (the cluster walk: K1, K2): render_polarized, render_any's stokes
    integrator and the plain render of its measured blobs."""
    from mitsuba2_tpu_torch.scene import presets
    t0 = time.perf_counter()
    scene = gallery_polarized(presets, SUBDIV, device=dev)
    md = scene.measured
    log(f"phase 2: built gallery_polarized in {time.perf_counter() - t0:.1f}"
        f" s (two rough-gold bakes on the CPU and gold's Mueller bake): "
        f"{scene.n_prims} prims, BSDF families {scene.mat_families}, "
        f"measured tables {tuple(md.values.shape)} "
        f"({sum(t.numel() * 4 for t in vars(md).values() if t is not None) / 2**20:.1f}"
        f" MiB with the CDFs and the Mueller table), cluster walk "
        f"{scene.mxu_node_f is not None}")
    check(scene.mxu_node_f is not None and md.mueller is not None
          and set(scene.mat_families) >= {13, 14, 15, 16},
          "gallery_polarized: wrong walk or families")
    return {"gallery_polarized": scene, "gallery_stokes": scene,
            "gallery_measured": scene}


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
    device time over `reps` launches, its agreement with its twin
    (compare_one's), the twin's time, the work the twin counted and the
    bound of that work."""
    tabs, extra = ks["tabs"], ks["extra"]
    n = rays[0].numel()
    ms = kernel_ms(torch, lambda: wrapper(name)(*tabs, *rays, *extra), reps)
    c = compare_one(torch, ks, name, list(rays))
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


def path_render(mt, path):
    """The entry point a path renders through."""
    return getattr(mt, PATH_ENTRY.get(path, "render"))


def path_image(path, out):
    """A path's radiance image: S0 of a Stokes image (the stokes
    integrator's one channel, the polarized transport's per channel)."""
    if path in STOKES_PATHS:
        return out[..., 0:1]
    return out[..., 0] if PATH_RENDER.get(path, {}).get("polarized") else out


# each path's peak memory (MiB) over its renders
PEAK_MIB = {}


def phase_main_path(torch, mt, path, scene, card, also=None):
    """Renders `path`: warm-up (recording each kernel call's inputs), then
    3 timed renders with every wrapper's count set to 0 before each; then
    each launch of the path's kernels timed and held against its twin (bit
    for bit: BIT_EQUAL and K8), and, with `also` (a scene under "bvh8"),
    K6's on the same inputs. Returns the kernels' rows, the median render
    ms and each kernel's launches (time_launch's records)."""
    from mitsuba2_tpu_torch.kernels import traverse
    cfg = mt.RenderConfig(**PATH_RENDER.get(path, RENDER))
    render = path_render(mt, path)
    names = list(EXPECTED_LAUNCHES[path])
    # brute force (veach) reaches no kernel: nothing to record or time
    ks = (kernels_of(scene, BACKEND.get(path, "auto"))
          if PATH_KERNELS[path] else None)

    record = []
    orig, rec = _recorders(traverse, record, ks) if ks else ({}, {})
    for k, f in rec.items():
        setattr(traverse, k, f)
    try:
        render(scene, cfg, seed=0)
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
        out = render(scene, cfg, seed=r)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        run_counts = {k: wrapper(k).launches for k in names}
        counts = counts or run_counts
        check(run_counts == counts, f"{path}: launch counts vary: {run_counts}")
        check(bool(torch.isfinite(out).all()),
              f"{path}: image has non-finite values")
        img = path_image(path, out).float()
        check(tuple(img.shape) == (cfg.height, cfg.width,
                                   1 if path in STOKES_PATHS else 3),
              f"{path}: image shape {tuple(img.shape)}")
        mean = float(img.mean())
        check(mean > 0.0, f"{path}: image mean {mean}")
    peak = torch.cuda.max_memory_allocated()
    PEAK_MIB[path] = (peak / 2**20, (peak - resident) / 2**20)
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
    # a volumetric path launches no any-hit kernel
    for name, rs in ((k, v) for k, v in per.items() if v):
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


# the paths whose scene is loaded from a Mitsuba XML file (mt.load_file)
# and rendered through render_any, the loader's and the CLI's entry point
XML_PATHS = {"xml_gallery"}
# the spectral-fit columns of a material or emitter row
# (spectra.pack_color): fitted in float64 from a color as given, so a
# scene file's float32 colors fit otherwise than a preset's literals
FIT_COLS = slice(3, 6)


def load_xml_gallery(torch, mt, gallery, d):
    """xml_gallery's scene: write_gallery_xml into `d`, then mt.load_file
    on the card, the parse and mesh reads timed apart from the build (the
    BVH, the cluster cut, the upload). Its tables are held to the gallery
    preset's: every one byte-equal but for the spectral-fit columns of
    mat_data and emitter_data, and its config to RENDER. Returns the
    scene, its config and the XML's path."""
    from mitsuba2_tpu_torch.scene import loader
    path = write_gallery_xml(d)
    build_s = []
    build = loader.build_scene

    def timed_build(*a, **kw):
        t0 = time.perf_counter()
        out = build(*a, **kw)
        torch.cuda.synchronize()
        build_s.append(time.perf_counter() - t0)
        return out
    loader.build_scene = timed_build
    try:
        t0 = time.perf_counter()
        scene, cfg = mt.load_file(path)
        total = time.perf_counter() - t0
    finally:
        loader.build_scene = build
    check(cfg.replace(spp_per_pass=RENDER["spp_per_pass"])
          == mt.RenderConfig(**RENDER), f"xml_gallery: its config {cfg}")
    same, fit_only = 0, []
    for k, v in vars(gallery).items():
        w = getattr(scene, k)
        if not torch.is_tensor(v):
            check(v == w, f"xml_gallery: {k} {w!r} is not the preset's {v!r}")
        elif torch.equal(v, w):
            same += 1
        else:
            keep = torch.ones(v.shape[-1], dtype=torch.bool, device=v.device)
            keep[FIT_COLS] = False
            check(k in ("mat_data", "emitter_data")
                  and torch.equal(v[:, keep], w[:, keep]),
                  f"xml_gallery: table {k} differs from the preset's")
            fit_only.append(k)
    log(f"phase 3: xml_gallery: loaded {os.path.basename(path)} "
        f"(mesh_gallery(subdiv={SUBDIV}) from {len(os.listdir(d)) - 1} mesh "
        f"files: ASCII PLY, binary PLY, .serialized, OBJ) in {total:.3f} s: "
        f"parse and mesh reads {total - sum(build_s):.3f} s, build "
        f"{sum(build_s):.3f} s; {same} tables byte-equal to the preset's, "
        f"{fit_only} but for their spectral-fit columns {FIT_COLS.start}-"
        f"{FIT_COLS.stop - 1} (fitted in float64 from the file's float32 "
        f"colors)")
    return scene, cfg, path


def phase_cli(torch, mt, xml, scene, cfg, gallery, render_ms):
    """`python -m mitsuba2_tpu_torch` on xml_gallery's file in a
    subprocess on the card: its wall time, its kernel launches (its log
    line; the counts start at 0 in its process) against the path's, and
    its PFM bit-equal to the in-process render of the loaded scene at the
    config's seed; that image against the gallery path's render of the
    same seed (tables equal in rgb mode's columns)."""
    import ast
    out = os.path.join(os.path.dirname(xml), "out.pfm")
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mitsuba2_tpu_torch", xml,
                           "-o", out], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"the CLI failed ({proc.returncode}): {proc.stderr[-3000:]}")
    launched = None
    for line in proc.stderr.splitlines():
        log(f"phase 3: cli: {line}")
        if "kernel launches: " in line:
            launched = ast.literal_eval(line.split("kernel launches: ")[1])
    want = {k: n for k, n in EXPECTED_LAUNCHES["xml_gallery"].items() if n}
    check(launched == want, f"the CLI launched {launched}, expected {want}")
    img_cli = mt.read_bitmap(out)
    img = mt.render_any(scene, cfg).cpu().numpy()
    check(img_cli.shape == img.shape and np.array_equal(img_cli, img),
          "the CLI's image is not the in-process render's bit for bit")
    img_g = mt.render(gallery, mt.RenderConfig(**RENDER),
                      seed=cfg.seed).cpu().numpy()
    close = np.isclose(img, img_g, rtol=1e-3, atol=1e-4).all(-1).mean()
    log(f"phase 3: xml_gallery: the CLI (python -m mitsuba2_tpu_torch "
        f"gallery.xml -o out.pfm, a process of its own: torch import, "
        f"kernel library load, XML load, build, render, PFM write) took "
        f"{wall:.2f} s wall, launches {launched}; its PFM bit-equal to "
        f"load_file + render_any in process; against the gallery path's "
        f"render: {close:.4f} of pixels within rtol 1e-3/atol 1e-4, "
        f"{'bit-equal' if np.array_equal(img, img_g) else 'not bit-equal'}; "
        f"render median {render_ms['xml_gallery']:.1f} ms beside the "
        f"gallery's {render_ms['gallery']:.1f} ms")
    check(close >= 0.99, "xml_gallery's render is not the gallery's")


# ---------------------------------------------------------------------------
# The variants phase: the integrator variants, samplers and filters on the
# gallery, and the gallery seen by the other sensors
# ---------------------------------------------------------------------------

AOV_NAMES = ("depth", "position", "sh_normal", "geo_normal", "uv",
             "prim_index", "shape_index", "albedo")
# path -> (its scene: the gallery, or gallery_sensor's kind; the config's
# fields over RENDER)
VARIANTS = {
    "gallery_direct": ("gallery", dict(integrator="direct")),
    "gallery_depth": ("gallery", dict(integrator="depth")),
    "gallery_aov": ("gallery", dict(integrator="aov", aovs=AOV_NAMES,
                                    aov_child="path")),
    "gallery_moment": ("gallery", dict(integrator="moment",
                                       spp_per_pass=4)),
    "gallery_stratified_gaussian": ("gallery", dict(sampler="stratified",
                                                    rfilter="gaussian")),
    "gallery_ld_lanczos": ("gallery", dict(sampler="ldsampler",
                                           rfilter="lanczos")),
    "gallery_ortho": ("orthographic", {}),
    "gallery_distant": ("distant", {}),
    "gallery_radiancemeter": ("radiancemeter", {}),
    "gallery_irradiancemeter": ("irradiancemeter", {}),
    "gallery_motion": ("motion", {}),
}
# the paths whose camera-ray K1 launch and first K2 launch are held to
# the twins: the wavefronts new to the cluster walks
SENSOR_PATHS = ("gallery_ortho", "gallery_distant", "gallery_radiancemeter",
                "gallery_irradiancemeter", "gallery_motion")
# K1 and K2 launches a render: the path tracer's 3 and 2 at depth 3; direct
# at depth 2; depth's and aov's one first-hit pass (aov's path child
# after it); moment's 4 passes
VARIANT_LAUNCHES = {
    "gallery_direct": (2, 1), "gallery_depth": (1, 0), "gallery_aov": (4, 2),
    "gallery_moment": (12, 8)}


def variant_rays(cfg):
    """The rays a render_any of `cfg` traces: bench.py's count of the path
    tracer's (direct's at depth 2), a first-hit pass for depth, both for
    aov (its pass and its path child)."""
    first = cfg.width * cfg.height * min(cfg.spp_per_pass, cfg.spp)
    if cfg.integrator == "depth":
        return first
    path = rays_per_pass(cfg.replace(
        spp_per_pass=cfg.spp,
        max_depth=2 if cfg.integrator == "direct" else cfg.max_depth))
    return path + (first if cfg.integrator == "aov" else 0)


def _variant_outputs(torch, path, cfg, out):
    """The images of a render_any result, checked: finite, of the
    config's shape, lit; the AOVs non-zero where the first hit is."""
    H, W = cfg.height, cfg.width
    if cfg.integrator == "moment":
        mean, var = out
        # m2 / n - mean^2 in f32: a variance near 0 may round below it
        floor = -1e-6 * float((mean * mean).max())
        check(float(var.min()) >= floor and float(var.max()) > 0,
              f"{path}: variance {float(var.min())}..{float(var.max())}")
        images = {"image": mean, "variance": var}
    elif cfg.integrator == "aov":
        images = dict(out)
    elif cfg.integrator == "depth":
        images = {"depth": out}
    else:
        images = {"image": out}
    from mitsuba2_tpu_torch.render.integrators import AOV_CHANNELS
    for k, v in images.items():
        c = AOV_CHANNELS.get(k) or 3
        check(tuple(v.shape) == (H, W, c), f"{path}: {k} {tuple(v.shape)}")
        check(bool(torch.isfinite(v).all()), f"{path}: {k} not finite")
        check(float(v.abs().max()) > 0, f"{path}: {k} is zero")
    if "image" in images:
        check(float(images["image"].mean()) > 0, f"{path}: image mean 0")
    if "depth" in images:
        hit = images["depth"][..., 0] > 0
        check(float(hit.float().mean()) > 0.5, f"{path}: few first hits")
        for k in ("position", "sh_normal", "geo_normal", "albedo"):
            if k in images:
                nz = images[k].abs().amax(-1) > 0
                check(bool(nz[hit].all()) and not bool(nz[~hit].any()),
                      f"{path}: {k} is not non-zero exactly where it hits")
        if "sh_normal" in images:
            # a pixel's mean of its samples' unit normals: at most 1
            norm = images["sh_normal"][hit].norm(dim=-1)
            check(bool((norm <= 1 + 1e-4).all()) and float(norm.mean())
                  > 0.9, f"{path}: shading normals' norms {norm}")
    return images


def variant_scene(mt, kind, subdiv, device, gallery=None):
    if kind == "gallery":
        return gallery if gallery is not None else mt.mesh_gallery(
            subdiv=subdiv, device=device)
    return gallery_sensor(kind, subdiv, device=device)


def phase_variants(torch, mt, dev, card, gallery):
    """Each VARIANTS path at RENDER's size through render_any: a warm-up
    (recording the traversal calls), then 3 timed renders with the K1 and
    K2 counts set to 0 before each; the launches a render, the median ms
    and Mrays/s; the outputs checked (_variant_outputs); on SENSOR_PATHS
    the camera's K1 launch and the first K2 launch held bit-equal to
    their twins and timed. Returns the kernels' rows by path."""
    from mitsuba2_tpu_torch.kernels import traverse
    rows = {}
    for path, (kind, over) in VARIANTS.items():
        scene = variant_scene(mt, kind, SUBDIV, dev, gallery)
        cfg = mt.RenderConfig(**{**RENDER, **over})
        ks = kernels_of(scene)
        check(ks["closest"] == "cluster_closest_hit",
              f"{path} does not take the cluster walk")
        record = []
        orig, rec = _recorders(traverse, record, ks)
        if path in SENSOR_PATHS:
            for k, f in rec.items():
                setattr(traverse, k, f)
        try:
            mt.render_any(scene, cfg, seed=0)
        finally:
            for k, f in orig.items():
                setattr(traverse, k, f)
        torch.cuda.synchronize()
        times, counts = [], None
        names = (ks["closest"], ks["any"])
        for r in range(3):
            for k in names:
                wrapper(k).launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = mt.render_any(scene, cfg, seed=r)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            run = tuple(wrapper(k).launches for k in names)
            check(counts is None or run == counts,
                  f"{path}: launch counts vary: {run}")
            counts = run
            images = _variant_outputs(torch, path, cfg, out)
        want = VARIANT_LAUNCHES.get(path, (cfg.max_depth, cfg.max_depth - 1))
        check(counts == want, f"{path}: K1, K2 launches {counts}, "
                              f"expected {want}")
        med = statistics.median(times)
        means = {k: round(float(v.float().mean()), 6)
                 for k, v in images.items()}
        log(f"phase 3 (variants): {path}: render_any {cfg.width}x"
            f"{cfg.height}x{cfg.spp}spp ({cfg.spp // min(cfg.spp_per_pass,
                                                         cfg.spp)} pass(es)), "
            f"depth {cfg.max_depth}, {kind} sensor, integrator "
            f"{cfg.integrator}, sampler {cfg.sampler}, filter {cfg.rfilter} "
            f"on {card}: median {med * 1e3:.1f} ms of "
            f"{[round(t * 1e3, 1) for t in times]}, "
            f"{variant_rays(cfg) / med / 1e6:.3f} Mrays/s; K1, K2 launches "
            f"a render {counts}; means {means}")
        if path not in SENSOR_PATHS:
            continue
        firsts = {}
        for name, rays in record:
            firsts.setdefault(name, rays)
        rows[path] = []
        for name in names:
            r = time_launch(torch, ks, scene, name, firsts[name])
            check(r["c"]["bit_equal"], f"{path}: {name}'s first launch is "
                                       f"not bit-equal to its twin: "
                                       f"{r['c']}")
            log_launch(f"{name} ({path}, bit-equal to its twin)", 0, r)
            rows[path].append({
                "name": name, "route": "cuda", "source": SRC,
                "replaces": REPLACES[name][0],
                "launches": counts[names.index(name)],
                "max_abs_err": r["err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None})
        if path == "gallery_radiancemeter":
            o = firsts[names[0]]
            same = all(bool((a == a[0]).all()) for a in o[:6])
            log(f"phase 3 (variants): {path}: the camera launch's "
                f"{o[0].numel()} lanes all along one ray: {same}")
            check(same, f"{path}: the meter's lanes are not one ray")
    return rows


def phase_variants_small(torch, mt, dev):
    """Each VARIANTS path at 32x32 (phase 4's small config, subdiv 1) on
    the card and on the CPU: images (and moment's variance) >= 99% of
    pixels within rtol 1e-3 / atol 1e-4; the AOVs depth, position, uv
    and normals within 1e-5 where both first hits are the same prim, the
    prim ids equal but on exact ties (<= 1% of hit pixels), the shape
    ids and albedo where the prims are equal."""
    base = dict(width=32, height=32, spp=2, spp_per_pass=1, max_depth=3,
                rr_depth=2)
    for path, (kind, over) in VARIANTS.items():
        cfg = mt.RenderConfig(**{**base, **{k: v for k, v in over.items()
                                            if k != "spp_per_pass"}})
        outs = [mt.render_any(variant_scene(mt, kind, 1, d), cfg, seed=5,
                              device=d) for d in ("cpu", dev)]
        im = [_variant_outputs(torch, path, cfg, o) for o in outs]
        im = [{k: v.float().cpu() for k, v in x.items()} for x in im]
        worst = []
        for k in ("image", "variance"):
            if k in im[0]:
                close = torch.isclose(im[1][k], im[0][k], rtol=1e-3,
                                      atol=1e-4).all(-1).float().mean()
                worst.append((k, round(float(close), 4)))
                check(float(close) >= 0.99, f"{path}: {k} card vs CPU: "
                                            f"{float(close):.4f} close")
        if "prim_index" in im[0]:
            hit = (im[0]["depth"][..., 0] > 0) & (im[1]["depth"][..., 0] > 0)
            same = hit & (im[0]["prim_index"][..., 0]
                          == im[1]["prim_index"][..., 0])
            ties = float((hit & ~same).float().sum() / hit.float().sum())
            worst.append(("prim ties", round(ties, 5)))
            check(ties <= 0.01, f"{path}: prims differ on {ties} of hits")
            for k in ("depth", "position", "sh_normal", "geo_normal", "uv",
                      "shape_index", "albedo"):
                ok = bool(torch.isclose(im[1][k][same], im[0][k][same],
                                        rtol=1e-5, atol=1e-5).all())
                err = float((im[1][k] - im[0][k])[same].abs().max())
                worst.append((k, err))
                check(ok, f"{path}: {k} card vs CPU off by {err}")
        elif "depth" in im[0]:
            hit = (im[0]["depth"] > 0) & (im[1]["depth"] > 0)
            err = float((im[1]["depth"] - im[0]["depth"])[hit].abs().max())
            close = float(torch.isclose(im[1]["depth"], im[0]["depth"],
                                        rtol=1e-5, atol=1e-5)[hit].float()
                          .mean())
            worst.append(("depth", err, close))
            check(close >= 0.99, f"{path}: depth card vs CPU: {close}")
        log(f"phase 4 (variants): {path} 32x32 card vs CPU: {worst} ok")


def phase_variants_cli(torch, mt, d):
    """`python -m mitsuba2_tpu_torch moment.xml -a depth -a sh_normal
    --device cuda` on the gallery written as XML with the moment
    integrator: its mean (PFM) bit-equal to the in-process render_any,
    its _variance, _depth and _sh_normal sidecars (half-float EXR) to
    the in-process results rounded to half."""
    src = open(write_gallery_xml(d)).read()
    path = os.path.join(d, "moment.xml")
    with open(path, "w") as f:
        f.write(src.replace('<integrator type="path">',
                            '<integrator type="moment"><integrator '
                            'type="path">').replace(
            '</integrator>', '</integrator></integrator>', 1))
    out = os.path.join(d, "moment.pfm")
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mitsuba2_tpu_torch", path,
                           "-o", out, "-a", "depth", "-a", "sh_normal",
                           "--device", "cuda"], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"the CLI failed ({proc.returncode}): {proc.stderr[-3000:]}")
    scene, cfg = mt.load_file(path)
    check(cfg.integrator == "moment", f"moment.xml loads {cfg.integrator}")
    mean, var = mt.render_any(scene, cfg)
    want = {"variance": var}
    for name in ("depth", "sh_normal"):
        want[name] = mt.render_aovs(scene, cfg, (name,))[name]
    got = mt.read_bitmap(out)
    check(np.array_equal(got, mean.cpu().numpy()),
          "the CLI's moment mean is not the in-process one bit for bit")
    from mitsuba2_tpu_torch.core import io_bitmap
    for name, v in want.items():
        arr = io_bitmap.read(out.rsplit(".", 1)[0] + f"_{name}.exr")
        half = v.float().cpu().numpy().astype(np.float16).astype(np.float32)
        check(np.array_equal(arr.reshape(half.shape), half),
              f"the CLI's _{name}.exr is not the in-process result")
    log(f"phase 3 (variants): cli: python -m mitsuba2_tpu_torch moment.xml "
        f"-a depth -a sh_normal (a process of its own) took {wall:.2f} s "
        f"wall; its mean bit-equal to render_any in process, its "
        f"_variance, _depth and _sh_normal sidecars (half-float EXR) equal "
        f"to the in-process results rounded to half; {cfg.spp} spp in "
        f"{cfg.spp // min(cfg.spp_per_pass, cfg.spp)} pass(es)")


def phase_tracking(torch, mt, path, scene):
    """One more render of a path whose scene holds a density grid, with
    the delta-tracking loop's stats on (render/volpath.py::TRACK_STATS):
    each heterogeneous flight's trip count (the JAX package's while_loop
    count: the most trials a lane of the flight took), the loop's own
    count (it tests for done lanes every 8 trials) and the trials a
    tracked lane took."""
    from mitsuba2_tpu_torch.render import volpath
    cfg = mt.RenderConfig(**PATH_RENDER[path])
    volpath.TRACK_STATS = []
    try:
        mt.render(scene, cfg, seed=0)
        torch.cuda.synchronize()
        stats = volpath.TRACK_STATS
    finally:
        volpath.TRACK_STATS = None
    trips = [st[0] for st in stats]
    loops = [st[3] for st in stats]
    lanes = sum(st[2] for st in stats)
    log(f"phase 3: {path}: delta tracking over {len(stats)} flights "
        f"({cfg.spp // cfg.spp_per_pass} passes of {cfg.max_depth}): trips "
        f"a flight mean {statistics.fmean(trips):.2f}, largest {max(trips)} "
        f"of {volpath._DELTA_STEPS} ({trips}); the loop ran "
        f"{statistics.fmean(loops):.1f} trials a flight (a done test each "
        f"{volpath._DONE_CHECK}); {lanes} tracked lanes, "
        f"{sum(st[1] for st in stats) / max(lanes, 1):.3f} trials a lane")
    check(stats and max(trips) <= volpath._DELTA_STEPS and lanes > 0,
          f"{path}: no lane was delta-tracked")


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


def phase_compact_path(torch, mt, path, scene):
    """A compact=True path after phase 3: its image at seed 0 against the
    same render uncompacted (the gallery path's), within
    tests/test_compact.py's rtol 1e-5 / atol 1e-6: each lane's sampler
    state moves with it, so it draws and decides as it would in place."""
    cfg = mt.RenderConfig(**PATH_RENDER[path])
    img = mt.render(scene, cfg, seed=0)
    plain = mt.render(scene, cfg.replace(compact=False), seed=0)
    torch.cuda.synchronize()
    err = float((img - plain).abs().max())
    log(f"phase 3: {path}: image against the uncompacted render (seed 0): "
        f"max abs diff {err:.3e}, bit-equal {bool(torch.equal(img, plain))}"
        f", means {float(img.mean()):.6f} and {float(plain.mean()):.6f}")
    check(torch.allclose(img, plain, rtol=1e-5, atol=1e-6),
          f"{path}: the compacted image is not the uncompacted one")


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
             lambda d: gallery_textured(presets, 1, 64, device=d), {}),
            ("gallery_fog(subdiv=1), volpath (K1)",
             lambda d: gallery_fog(presets, 1, device=d), {}),
            ("reparam: gallery_fog(subdiv=1), volpath, the camera ray "
             "warped (K1)", lambda d: gallery_fog(presets, 1, device=d), {}),
            ("medium_slab over a random grid, volpath (delta tracking)",
             lambda d: medium_slab(presets, device=d, **GRID_SLAB), {}),
            ("smoke_box(8) with its floor 1e-3 lower (no tie)",
             lambda d: smoke_floor_lowered(mt, d), {})):
        c = cfg.replace(color_mode="spectral") if name.startswith(
            "spectral") else cfg.replace(reparam=True) if name.startswith(
            "reparam") else cfg
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
    # a dielectric path decides by a Fresnel draw, and smoke_box's lanes
    # meet a tie (SMOKE_TIE_RTOL): where the card rounds otherwise a lane
    # may take another path, so these hold the image means
    for name, mk, rtol in (("kitchen_sink, volpath (brute force)",
                            lambda d: mt.kitchen_sink(device=d), 1e-3),
                           ("smoke_box(8), volpath (brute force)",
                            lambda d: mt.smoke_box(8, device=d),
                            SMOKE_TIE_RTOL)):
        c = cfg.replace(integrator="volpath")
        img_c = mt.render(mk("cpu"), c, seed=5, device="cpu").numpy()
        img_g = mt.render(mk(dev), c, seed=5).cpu().numpy()
        close = np.isclose(img_g, img_c, rtol=1e-3, atol=1e-4).all(-1).mean()
        rel = abs(img_g.mean() - img_c.mean()) / img_c.mean()
        good = np.isfinite(img_g).all() and rel <= rtol
        log(f"phase 4: {name} 32x32 card vs CPU: mean rel diff {rel:.2e} "
            f"(limit {rtol:g}) {'ok' if good else 'FAIL'}; {1 - close:.4f} of "
            f"pixels beyond rtol 1e-3/atol 1e-4")
        check(good, f"{name}: the card's image mean is not the CPU's")
    _file_scene(torch, mt, dev)


# phase 4's polarized renders: gallery_polarized(subdiv=1) at phase 4's
# config; the random lanes of the measured lookups' card-vs-CPU cells
POL_SMALL = dict(width=32, height=32, spp=2, spp_per_pass=1, max_depth=3,
                 rr_depth=2)
LOOKUP_LANES = 1 << 20


def phase_polarized_small(torch, mt, dev):
    """gallery_polarized(subdiv=1) at 32x32 on the card and on the CPU:
    render_polarized in rgb and in spectral mode, render_stokes and the
    plain render of its measured blobs, each within phase 4's limits
    (99% of pixels, every channel and Stokes component, within rtol 1e-3
    / atol 1e-4; the S0 means within 1e-3); then the measured lookups'
    cells (measured.lookup_cells) on LOOKUP_LANES random directions on
    both: the share of lanes the card rounds to another cell, printed
    and held under 1%."""
    from mitsuba2_tpu_torch.core.vec import Vec3
    from mitsuba2_tpu_torch.render import measured as measured_mod
    from mitsuba2_tpu_torch.scene import presets
    cfg = mt.RenderConfig(**POL_SMALL)
    scenes = {d: gallery_polarized(presets, 1, device=d) for d in ("cpu", dev)}
    for name, fn, c in (
            ("render_polarized", mt.render_polarized, cfg),
            ("render_polarized, spectral", mt.render_polarized,
             cfg.replace(color_mode="spectral")),
            ("render_stokes", mt.render_stokes, cfg),
            ("render (the measured blobs' scalar transport)", mt.render,
             cfg)):
        out_c = fn(scenes["cpu"], c, seed=5, device="cpu").numpy()
        out_g = fn(scenes[dev], c, seed=5, device=dev).cpu().numpy()
        H, W = out_c.shape[:2]
        close = np.isclose(out_g.reshape(H, W, -1), out_c.reshape(H, W, -1),
                           rtol=1e-3, atol=1e-4).all(-1).mean()
        s0_c = out_c if fn is mt.render else out_c[..., 0]
        s0_g = out_g if fn is mt.render else out_g[..., 0]
        rel = abs(s0_g.mean() - s0_c.mean()) / s0_c.mean()
        good = np.isfinite(out_g).all() and close >= 0.99 and rel <= 1e-3
        log(f"phase 4: gallery_polarized(subdiv=1) {name} 32x32 card vs "
            f"CPU: {close:.4f} of pixels within rtol 1e-3/atol 1e-4 (every "
            f"Stokes component), S0 mean rel diff {rel:.2e} "
            f"{'ok' if good else 'FAIL'}")
        check(good, f"gallery_polarized {name}: the card's render disagrees "
              "with the CPU's")
    rng = np.random.default_rng(31)
    dirs = []
    for _ in range(2):
        w = rng.normal(size=(LOOKUP_LANES, 3))
        w[:, 2] = np.abs(w[:, 2])
        dirs.append((w / np.linalg.norm(w, axis=-1, keepdims=True)).astype(
            np.float32))
    cells = {}
    for d in ("cpu", dev):
        wi, wo = (Vec3(*torch.from_numpy(a).to(d).unbind(1)) for a in dirs)
        cells[d] = measured_mod.lookup_cells(scenes[d].measured, wi,
                                             wo).cpu()
    differ = (cells["cpu"] != cells[dev]).any(1).float().mean().item()
    log(f"phase 4: measured lookups: {differ:.3e} of {LOOKUP_LANES} random "
        "lanes round arccos or arctan2 to another cell on the card than on "
        f"the CPU (limit 1e-2) {'ok' if differ < 1e-2 else 'FAIL'}")
    check(differ < 1e-2, "the card's measured lookups round to other cells")


POLARIZED_XML = """<scene version="2.0.0">
  <integrator type="path"><integer name="max_depth" value="3"/></integrator>
  <sensor type="perspective">
    <transform name="to_world">
      <lookat origin="0,-3.5,2.2" target="0,0,0.3" up="0,0,1"/></transform>
    <float name="fov" value="45"/>
    <film type="hdrfilm"><integer name="width" value="32"/>
      <integer name="height" value="32"/></film>
    <sampler type="independent"><integer name="sample_count" value="4"/>
    </sampler>
  </sensor>
  <shape type="rectangle">
    <transform name="to_world"><scale value="3"/></transform>
    <bsdf type="measured"><string name="filename" value="$capture"/>
      <integer name="n_ti" value="8"/><integer name="n_to" value="16"/>
      <integer name="n_phi" value="16"/></bsdf>
  </shape>
  <shape type="sphere"><point name="center" value="-0.8,0,0.5"/>
    <float name="radius" value="0.45"/>
    <bsdf type="conductor"><string name="material" value="Au"/></bsdf>
  </shape>
  <shape type="sphere"><point name="center" value="0.8,0,0.5"/>
    <float name="radius" value="0.45"/>
    <bsdf type="dielectric"><float name="int_ior" value="1.5"/></bsdf>
  </shape>
  <shape type="rectangle">
    <transform name="to_world"><rotate x="1" angle="70"/>
      <translate value="-0.8,-1.2,0.8"/></transform>
    <bsdf type="polarizer"><float name="theta" value="30"/></bsdf>
  </shape>
  <shape type="rectangle">
    <transform name="to_world"><rotate x="1" angle="70"/>
      <translate value="0.8,-1.2,0.8"/></transform>
    <bsdf type="retarder"><float name="delta" value="90"/></bsdf>
  </shape>
  <emitter type="constant"><rgb name="radiance" value="1,1,1"/></emitter>
</scene>"""


def phase_polarized_cli(torch, mt, d):
    """`python -m mitsuba2_tpu_torch pol.xml -m rgb_polarized --device
    cuda` on a small file scene (a measured plate read from an RGL .bsdf
    file, a gold and a glass sphere, a polarizer and a retarder pane, the
    sky): its S0 (PFM) bit-equal to the in-process render_polarized of
    the loaded scene, its _s1.._s3 sidecars (half-float EXR) to the
    in-process components rounded to half."""
    from mitsuba2_tpu_torch.core import io_bitmap
    from mitsuba2_tpu_torch.render import rgl
    capture = os.path.join(d, "ggx.bsdf")
    rgl.write_rgl_ggx(capture, alpha=0.3, n_ti=8, res=32, res2=32)
    path = os.path.join(d, "pol.xml")
    with open(path, "w") as f:
        f.write(POLARIZED_XML.replace("$capture", capture))
    out = os.path.join(d, "pol.pfm")
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mitsuba2_tpu_torch", path,
                           "-o", out, "-m", "rgb_polarized", "--device",
                           "cuda"], cwd=repo, env=env, capture_output=True,
                          text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"the CLI failed ({proc.returncode}): {proc.stderr[-3000:]}")
    scene, cfg = mt.load_file(path)
    cfg = cfg.replace(**mt.parse_variant("rgb_polarized"))
    stokes = mt.render_polarized(scene, cfg).cpu().numpy()
    check(np.array_equal(mt.read_bitmap(out), stokes[..., 0]),
          "the CLI's S0 is not the in-process render_polarized's bit for bit")
    for i in (1, 2, 3):
        arr = io_bitmap.read(out.rsplit(".", 1)[0] + f"_s{i}.exr")
        half = stokes[..., i].astype(np.float16).astype(np.float32)
        check(np.array_equal(arr.reshape(half.shape), half),
              f"the CLI's _s{i}.exr is not the in-process S{i}")
    dop = float(np.sqrt((stokes[..., 1:] ** 2).sum(-1)).mean()
                / stokes[..., 0].mean())
    log(f"phase 3 (polarized, cli): python -m mitsuba2_tpu_torch pol.xml -m "
        f"rgb_polarized (a process of its own) took {wall:.2f} s wall; its "
        f"S0 bit-equal to render_polarized in process, its _s1.._s3 "
        f"sidecars (half-float EXR) equal to S1-S3 rounded to half; "
        f"{scene.n_prims} prims, families {scene.mat_families}, mean "
        f"polarized share |S1..S3| / S0 {dop:.4f}")


def _tables(obj, prefix=""):
    """An atlas' or envmap's tensors by name, its distribution's too."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_tables(v, f"{prefix}{f.name}."))
        elif hasattr(v, "shape"):
            out[prefix + f.name] = v
    return out


def _file_scene(torch, mt, dev):
    """write_file_scene's scene (an EXR and a PNG bitmap, an EXR envmap, a
    .vol grid, a disk, a cylinder, a flip_normals rectangle) loaded on the
    card and on the CPU: its atlas and envmap tables byte-equal to the
    same images given as arrays on both, and the card's volpath render
    against the CPU's to this phase's limits."""
    import tempfile
    d = tempfile.mkdtemp()
    try:
        path, arrays = write_file_scene(d)
        t0 = time.perf_counter()
        scene_c, cfg = mt.load_file(path, device="cpu")
        scene_g, _ = mt.load_file(path)
        load_s = time.perf_counter() - t0
        ref = file_scene_from_arrays(mt, arrays, "cpu")
        for what in ("textures", "envmap"):
            want = _tables(getattr(ref, what))
            for scene in (scene_c, scene_g):
                got = _tables(getattr(scene, what))
                check(got.keys() == want.keys() and all(
                    got[k].cpu().numpy().tobytes() == v.numpy().tobytes()
                    for k, v in want.items()), f"the file scene's {what} "
                      "tables are not those of its arrays")
        check(scene_c.medium_grid is not None and cfg.integrator == "volpath",
              "the file scene lost its medium")
        img_c = mt.render_any(scene_c, cfg, seed=5, device="cpu").numpy()
        img_g = mt.render_any(scene_g, cfg, seed=5).cpu().numpy()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    close = np.isclose(img_g, img_c, rtol=1e-3, atol=1e-4).all(-1).mean()
    rel = abs(img_g.mean() - img_c.mean()) / img_c.mean()
    good = np.isfinite(img_g).all() and close >= 0.99 and rel <= 1e-3
    log(f"phase 4: scene from files (OBJ, PLY, disk, cylinder, flip_normals; "
        f"EXR and PNG bitmaps, EXR envmap, .vol grid), loaded on the CPU and "
        f"the card in {load_s:.2f} s: atlas ({scene_c.textures.data.shape[0]} "
        f"textures) and envmap tables byte-equal to the arrays' build; "
        f"{cfg.width}x{cfg.height} volpath card vs CPU: {close:.4f} of "
        f"pixels within rtol 1e-3/atol 1e-4, mean rel diff {rel:.2e} "
        f"{'ok' if good else 'FAIL'}")
    check(good, "the file scene's card render disagrees with the CPU's")


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
        path_render(mt, path)(scene, cfg, seed=11)
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
                  textured, gallery_reparam, smoke):
    """Phase 7 (see the module docstring); `gallery`, `veach`,
    `veach_spectral`, `textured`, `gallery_reparam`, `smoke`: phase 2's
    scenes."""
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
    step("the medium gradients", _medium_gradients, torch, mt, dev, card)
    step("smoke_box's render_l2_grad", _smoke_adjoint, torch, mt, card,
         smoke)


def _medium_gradients(torch, mt, dev, card):
    """render_and_grad of tests/test_medium_grad.py's slabs (the image
    mean) on the card and on the CPU: every table's gradient within 1e-3
    of the CPU's largest entry, all finite; on the homogeneous slab the
    summed sigma_t gradient against a central difference on the card
    within that test's band."""
    from mitsuba2_tpu_torch.diff import adjoint
    from mitsuba2_tpu_torch.scene import presets
    cfg = mt.RenderConfig(**MEDIUM_GRAD)
    for name, kw in MEDIUM_SLABS.items():
        build = {k: v for k, v in kw.items() if k != "seed"}
        got = {}
        for d in ("cpu", dev):
            scene = medium_slab(presets, device=d, **build)
            t0 = time.perf_counter()
            img, _, g = mt.render_and_grad(scene, cfg, torch.mean,
                                           seed=kw["seed"], device=d)
            got[str(d)] = ({k: v.cpu() for k, v in g.items()}, img.cpu(),
                           (time.perf_counter() - t0) * 1e3)
        (g_c, img_c, _), (g_g, img_g, ms) = got["cpu"], got[str(dev)]
        check(_finite(torch, list(g_g.values())),
              f"{name} slab: non-finite gradients on the card")
        errs = {k: float((g_g[k] - g_c[k]).abs().max()
                         / g_c[k].abs().max().clamp_min(1e-30))
                for k in ("med_data", "med_grid") if k in g_c}
        log(f"phase 7: {name} slab ({cfg.width}x{cfg.height}x{cfg.spp}spp, "
            f"depth {cfg.max_depth}, volpath): render_and_grad {ms:.1f} ms "
            f"on {card}; card vs CPU: image mean rel diff "
            f"{abs(float(img_g.mean() / img_c.mean()) - 1):.2e}, gradients "
            + ", ".join(f"{k} {e:.2e} of the largest entry"
                        for k, e in errs.items())
            + f"; largest |med_data| {float(g_c['med_data'].abs().max()):.4e}"
            + (f", |med_grid| {float(g_c['med_grid'].abs().max()):.4e}"
               if "med_grid" in g_c else ""))
        check(all(e <= 1e-3 for e in errs.values()),
              f"{name} slab: card gradients {errs} off the CPU's")
        if name != "homogeneous":
            continue
        scene = medium_slab(presets, device=dev, **build)

        def loss_at(ds):
            med = scene.med_data.clone()
            med[0, 0:3] += ds
            s = adjoint.with_tables(scene, {**adjoint.diff_tables(scene),
                                            "med_data": med})
            return float(mt.render(s, cfg, seed=kw["seed"],
                                   device=dev).mean())

        fd = (loss_at(MEDIUM_FD_EPS) - loss_at(-MEDIUM_FD_EPS)) / (
            2 * MEDIUM_FD_EPS)
        ad = float(g_g["med_data"][0, 0:3].sum())
        good = ad < 0 and abs(ad - fd) <= MEDIUM_FD_RTOL * abs(fd)
        log(f"phase 7: {name} slab: d mean / d sigma_t on {card}: AD "
            f"{ad:+.6f}, central difference (eps {MEDIUM_FD_EPS}) "
            f"{fd:+.6f}, |AD / FD - 1| {abs(ad / fd - 1):.4f} (band "
            f"{MEDIUM_FD_RTOL}) {'ok' if good else 'FAIL'}")
        check(good, f"{name} slab: sigma_t's gradient is off its central "
              "difference")


def _smoke_adjoint(torch, mt, card, scene):
    """One render_l2_grad of smoke_box(SMOKE_RES) at SMOKE_ADJOINT (zero
    target): the forward's and render_l2_grad's medians of 3 after a
    warm-up, render_l2_grad's peak memory over the resident scenes,
    every gradient finite and the grid's nonzero."""
    cfg = mt.RenderConfig(**SMOKE_ADJOINT)
    target = torch.zeros((cfg.height, cfg.width, 3), device=scene.device)
    fwd_ms, fwd_t = median_ms(torch, lambda r: mt.render(scene, cfg, seed=r))
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    adj_ms, adj_t = median_ms(torch, lambda r: mt.render_l2_grad(
        scene, cfg, target, seed=r))
    peak = torch.cuda.max_memory_allocated() - resident
    img, loss, grads = mt.render_l2_grad(scene, cfg, target, seed=7)
    check(_finite(torch, [img, loss, *grads.values()])
          and float(grads["med_grid"].abs().max()) > 0,
          "smoke_box: non-finite gradients or a zero grid gradient")
    rays = rays_per_pass(cfg) * (cfg.spp // cfg.spp_per_pass)
    log(f"phase 7: smoke_box({SMOKE_RES}): {cfg.width}x{cfg.height}x"
        f"{cfg.spp}spp, depth {cfg.max_depth}, volpath, on {card}: forward "
        f"median {fwd_ms:.1f} ms of {[round(t, 1) for t in fwd_t]}, "
        f"render_l2_grad median {adj_ms:.1f} ms of "
        f"{[round(t, 1) for t in adj_t]} ({2 * rays / adj_ms / 1e3:.3f} "
        f"Mrays/s forward + adjoint, {adj_ms / fwd_ms:.3f}x the forward), "
        f"peak memory {peak / 2**20:.0f} MiB over the "
        f"{resident / 2**20:.0f} MiB resident; largest |med_grid| "
        f"{float(grads['med_grid'].abs().max()):.4e}, |med_data| "
        f"{float(grads['med_data'].abs().max()):.4e}")


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


# ---------------------------------------------------------------------------
# Phase 8: several processes (dist/) and long renders (utils/observability)
# ---------------------------------------------------------------------------

def _launch_row(name, r, launches):
    """A kernel row of a launch timed by time_launch."""
    return {"name": name, "route": "cuda", "source": SRC,
            "replaces": REPLACES[name][0], "launches": launches,
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None}


def phase_instrumented(torch, mt, gallery, d):
    """render_instrumented on the gallery, 4 passes of 4: a JSONL record a
    pass, the image render()'s within rtol 1e-5 / atol 1e-6, and a cancel
    after two passes the two-pass render's."""
    from mitsuba2_tpu_torch.utils.observability import render_instrumented
    cfg = mt.RenderConfig(**INSTRUMENTED)
    n_passes = cfg.spp // cfg.spp_per_pass
    jsonl = os.path.join(d, "render.jsonl")
    if os.path.exists(jsonl):
        os.remove(jsonl)    # the monitor appends
    img, mon = render_instrumented(gallery, cfg, seed=0, jsonl_path=jsonl)
    recs = [json.loads(ln) for ln in open(jsonl)]
    calls = {"n": 0}

    def cancel():
        calls["n"] += 1
        return calls["n"] > 2

    part, mon2 = render_instrumented(gallery, cfg, seed=0, cancel=cancel)
    ref = mt.render(gallery, cfg, seed=0)
    ref2 = mt.render(gallery, cfg.replace(spp=2 * cfg.spp_per_pass), seed=0)
    torch.cuda.synchronize()
    log(f"phase 8: render_instrumented, the gallery {cfg.width}x"
        f"{cfg.height}, {n_passes} passes of {cfg.spp_per_pass}: "
        f"{len(recs)} JSONL records, Mrays/s a pass "
        f"{[r['mrays_s'] for r in recs]}, live lanes after each bounce "
        f"{recs[-1]['occupancy']}; image against render(): max abs diff "
        f"{float((img - ref).abs().max()):.3e}; cancelled after "
        f"{len(mon2.records)} passes: against the 2-pass render "
        f"{float((part - ref2).abs().max()):.3e}")
    check(len(recs) == n_passes and recs == mon.records,
          "render_instrumented: a JSONL record a pass")
    check(torch.allclose(img, ref, rtol=1e-5, atol=1e-6),
          "render_instrumented: the image is not render()'s")
    check(mon2.cancelled and len(mon2.records) == 2
          and torch.allclose(part, ref2, rtol=1e-5, atol=1e-6),
          "render_instrumented: the cancelled image is not the 2-pass one")


def phase_nccl_one(torch, mt, gallery, d):
    """render_sharded over an NCCL group of one rank, in this process (a
    FileStore): its all-reduces run, as the identity, and its image is
    render()'s bit for bit; its K1, K2 launches a render's."""
    import torch.distributed as tdist
    from mitsuba2_tpu_torch.dist import sharding
    cfg = mt.RenderConfig(**RENDER)
    names = PATH_KERNELS["gallery"]
    tdist.init_process_group(
        "nccl", store=tdist.FileStore(os.path.join(d, "nccl_store"), 1),
        rank=0, world_size=1)
    try:
        mesh = sharding.make_mesh(device=DEVICE)
        check(mesh.grouped and mesh.size == 1
              and tdist.get_backend() == "nccl", f"the NCCL mesh: {mesh}")
        sharding.render_sharded(gallery, cfg, mesh, seed=0)
        for k in names:
            wrapper(k).launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img_s = sharding.render_sharded(gallery, cfg, mesh, seed=0)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = [wrapper(k).launches for k in names]
    finally:
        tdist.destroy_process_group()
    img = mt.render(gallery, cfg, seed=0)
    equal = bool(torch.equal(img_s, img))
    log(f"phase 8: NCCL, world size 1: render_sharded of the gallery "
        f"{ms:.1f} ms, K1, K2 launches {counts}, bit-equal to render(): "
        f"{equal}")
    check(equal, "the NCCL world-1 render is not render()'s")
    check(counts == [EXPECTED_LAUNCHES["gallery"][k] for k in names],
          f"the NCCL world-1 render launched {counts}")


def run_ranks(torch, fn, world, timeout, *args):
    """fn(rank, world, store, out_path, *args) in `world` processes of the
    spawn start method (this one holds CUDA); returns each rank's saved
    results. A rank that fails stops the others, and one still running
    after `timeout` s is killed: either fails the phase."""
    import tempfile
    ctx = torch.multiprocessing.get_context("spawn")
    d = tempfile.mkdtemp(prefix="ranks_")
    try:
        procs = [ctx.Process(target=fn, args=(r, world, f"{d}/store",
                                              f"{d}/out{r}.pt", *args))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while (any(p.is_alive() for p in procs)
               and time.monotonic() < deadline
               and not any(p.exitcode not in (None, 0) for p in procs)):
            time.sleep(0.5)
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        codes = [p.exitcode for p in procs]
        check(not alive and codes == [0] * world,
              f"the ranks exited with {codes}; ranks {alive} were still "
              f"running after {timeout} s or after another rank failed")
        return [torch.load(f"{d}/out{r}.pt", weights_only=False)
                for r in range(world)]
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _dist_rank(rank, world, store, out, ckpt_dir):
    """A gloo rank on the card: the gallery built here; render_sharded
    (timed, its K1, K2 launches counted, its camera K1 launch and first
    K2 launch timed and held against their twins, one rank at a time),
    render_and_grad_sharded, DIST_TRAIN_STEPS train steps, a checkpointed
    optimization resumed from its file, and config 5 sharded. Saves its
    results to `out`."""
    import torch
    import torch.distributed as tdist
    import mitsuba2_tpu_torch as mt
    from mitsuba2_tpu_torch.diff import adjoint as adjoint_mod
    from mitsuba2_tpu_torch.dist import checkpoint, multihost, sharding
    from mitsuba2_tpu_torch.kernels import traverse
    torch.cuda.set_device(0)
    tdist.init_process_group("gloo", store=tdist.FileStore(store, world),
                             rank=rank, world_size=world)
    try:
        dev = torch.device(DEVICE)
        res = {}
        t0 = time.perf_counter()
        gallery = mt.mesh_gallery(subdiv=SUBDIV, device=dev)
        res["build_s"] = time.perf_counter() - t0
        mesh = sharding.make_mesh(device=dev)
        cfg = mt.RenderConfig(**RENDER)
        ks = kernels_of(gallery)
        names = (ks["closest"], ks["any"])
        record = []
        orig, rec = _recorders(traverse, record, ks)
        for k, f in rec.items():
            setattr(traverse, k, f)
        try:
            sharding.render_sharded(gallery, cfg, mesh, seed=0)
        finally:
            for k, f in orig.items():
                setattr(traverse, k, f)
        torch.cuda.synchronize()
        tdist.barrier()
        for k in names:
            wrapper(k).launches = 0
        t0 = time.perf_counter()
        img = sharding.render_sharded(gallery, cfg, mesh, seed=0)
        torch.cuda.synchronize()
        res["render_ms"] = (time.perf_counter() - t0) * 1e3
        res["launches"] = {k: wrapper(k).launches for k in names}
        res["image"] = img.cpu()
        firsts = {}
        for name, rays in record:
            firsts.setdefault(name, rays)
        res["rows"] = []
        for r in range(world):
            if r == rank:   # one rank's kernels on the card at a time
                for name in names:
                    t = time_launch(torch, ks, gallery, name, firsts[name])
                    res["rows"].append({
                        **_launch_row(name, t, res["launches"][name]),
                        "bit_equal": t["c"]["bit_equal"], "lanes": t["n"]})
            torch.cuda.synchronize()
            tdist.barrier()

        zero = torch.zeros((cfg.height, cfg.width, 3), device=dev)
        for _ in range(2):  # the first call starts the backward's kernels
            t0 = time.perf_counter()
            _, loss, grads = sharding.render_and_grad_sharded(
                gallery, cfg, lambda im: torch.mean((im - zero) ** 2), mesh,
                seed=0)
            torch.cuda.synchronize()
            res["adjoint_ms"] = (time.perf_counter() - t0) * 1e3
        res["adjoint"] = (float(loss), {k: v.cpu() for k, v in grads.items()})

        target = mt.render(gallery, cfg, seed=11) * 0.5
        s, opt, losses = gallery, None, []
        t0 = time.perf_counter()
        for i in range(DIST_TRAIN_STEPS):
            s, opt, loss, _ = sharding.train_step_sharded(
                s, cfg, target, i + 1, mesh, opt_state=opt, lr=DIST_LR)
            losses.append(float(loss))
        res["train"] = {"losses": losses, "step": int(opt["step"]),
                        "s": (time.perf_counter() - t0) / DIST_TRAIN_STEPS}

        s, opt = gallery, None
        for i in range(DIST_CKPT_STEP):
            s, opt, _, _ = sharding.train_step_sharded(s, cfg, zero, i, mesh,
                                                       opt_state=opt)
        path = os.path.join(ckpt_dir, "opt.npz")
        state = {"tables": adjoint_mod.diff_tables(s), "opt": opt}
        if multihost.is_coordinator():
            checkpoint.save(path, state, step=DIST_CKPT_STEP)
        tdist.barrier()
        s_a, _, loss_a, _ = sharding.train_step_sharded(
            s, cfg, zero, DIST_CKPT_STEP, mesh, opt_state=opt)
        restored, step, _ = checkpoint.load(path, like=state, device=dev)
        s_c, _, loss_c, _ = sharding.train_step_sharded(
            adjoint_mod.with_tables(gallery, restored["tables"]), cfg, zero,
            DIST_CKPT_STEP, mesh, opt_state=restored["opt"])
        res["resume"] = {"step": step, "mat_a": s_a.mat_data.cpu(),
                         "mat_c": s_c.mat_data.cpu(), "loss_a": float(loss_a),
                         "loss_c": float(loss_c)}

        t0 = time.perf_counter()
        res["reparam"] = sharding.render_sharded(
            gallery, mt.RenderConfig(**REPARAM_GALLERY), mesh, seed=0).cpu()
        torch.cuda.synchronize()
        res["reparam_ms"] = (time.perf_counter() - t0) * 1e3
        torch.save(res, out)
    finally:
        tdist.destroy_process_group()


def phase_dist(torch, mt, card, gallery, d):
    """render_instrumented; NCCL at world size 1 in this process; then
    DIST_RANKS gloo ranks on the one card (_dist_rank), their results
    against this process's: the image within rtol 2e-5 / atol 2e-5 of
    render() (tests/test_sharding.py's pass limits), the gradients within
    rtol 5e-4 / atol 1e-6 of render_l2_grad's, the train steps' loss
    falling, the resumed optimization's mat_data within rtol 1e-6 / atol
    1e-8 of the uninterrupted one's, config 5's image within rtol 1e-4 /
    atol 1e-5 of render()'s; every rank's results equal. Returns the K1,
    K2 rows by rank."""
    from mitsuba2_tpu_torch.diff.adjoint import render_l2_grad
    phase_instrumented(torch, mt, gallery, d)
    phase_nccl_one(torch, mt, gallery, d)
    t0 = time.perf_counter()
    ckpt_dir = os.path.join(d, "ckpt")
    os.makedirs(ckpt_dir, exist_ok=True)
    ranks = run_ranks(torch, _dist_rank, DIST_RANKS, DIST_TIMEOUT, ckpt_dir)
    wall = time.perf_counter() - t0
    cfg = mt.RenderConfig(**RENDER)
    img = mt.render(gallery, cfg, seed=0).cpu()
    zero = torch.zeros((cfg.height, cfg.width, 3), device=DEVICE)
    _, loss, grads = render_l2_grad(gallery, cfg, zero, seed=0)
    reparam = mt.render(gallery, mt.RenderConfig(**REPARAM_GALLERY),
                        seed=0).cpu()
    rows = {}
    for r, res in enumerate(ranks):
        log(f"phase 8: gloo rank {r} of {DIST_RANKS} on {card}: gallery "
            f"built in {res['build_s']:.1f} s; render_sharded "
            f"{cfg.width}x{cfg.height}x{cfg.spp}spp, depth {cfg.max_depth} "
            f"({cfg.spp_per_pass // DIST_RANKS * cfg.width * cfg.height} "
            f"lanes a rank) {res['render_ms']:.1f} ms, launches "
            f"{json.dumps(res['launches'])}; render_and_grad_sharded "
            f"{res['adjoint_ms']:.1f} ms (its second call); a train step "
            f"{res['train']['s'] * 1e3:.1f} ms, losses "
            f"{[round(x, 6) for x in res['train']['losses']]}; config 5 "
            f"{res['reparam_ms']:.1f} ms")
        for row in res["rows"]:
            log(f"  {row['name']} (rank {r}'s first launch, {row['lanes']} "
                f"lanes): {row['ms']:.3f} ms, twin {row['plain_ms']:.1f} ms, "
                f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}, "
                f"bit-equal to its twin {row['bit_equal']}")
            check(row.pop("bit_equal") and row.pop("lanes") > 0,
                  f"rank {r}: {row['name']} disagrees with its twin")
        rows[f"dist_gloo_rank{r}"] = res["rows"]
        check(res["launches"] == {k: EXPECTED_LAUNCHES["gallery"][k]
                                  for k in res["launches"]},
              f"rank {r} launched {res['launches']}")
        for k in ("image", "reparam"):
            check(torch.equal(res[k], ranks[0][k]),
                  f"rank {r}'s {k} is not rank 0's")
    res = ranks[0]
    g_err = {k: float((res["adjoint"][1][k] - grads[k].cpu()).abs().max())
             for k in grads}
    resume = res["resume"]
    losses = res["train"]["losses"]
    log(f"phase 8: the ranks against one process: image max abs diff "
        f"{float((res['image'] - img).abs().max()):.3e}; loss "
        f"{res['adjoint'][0]:.6f} against {float(loss):.6f}, gradients max "
        f"abs diff {g_err}; resumed at step {resume['step']}: mat_data max "
        f"abs diff {float((resume['mat_c'] - resume['mat_a']).abs().max()):.3e}"
        f", losses {resume['loss_c']:.6f}, {resume['loss_a']:.6f}; config 5 "
        f"image max abs diff {float((res['reparam'] - reparam).abs().max()):.3e}"
        f"; the ranks' run {wall:.1f} s")
    check(torch.allclose(res["image"], img, rtol=2e-5, atol=2e-5),
          "the ranks' image is not render()'s")
    check(abs(res["adjoint"][0] - float(loss)) <= 1e-4 * abs(float(loss)),
          "the ranks' loss is not render_l2_grad's")
    for k, g in grads.items():
        check(torch.allclose(res["adjoint"][1][k], g.cpu(), rtol=5e-4,
                             atol=1e-6),
              f"the ranks' {k} gradient is not render_l2_grad's")
    check(res["train"]["step"] == DIST_TRAIN_STEPS and losses[-1] < losses[0],
          f"the sharded train steps' loss did not fall: {losses}")
    check(resume["step"] == DIST_CKPT_STEP and torch.allclose(
        resume["mat_c"], resume["mat_a"], rtol=1e-6, atol=1e-8),
          "the resumed optimization is not the uninterrupted one")
    check(torch.allclose(res["reparam"], reparam, rtol=1e-4, atol=1e-5),
          "config 5 sharded is not the one-process render")
    return rows


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

    import tempfile
    xml_dir = tempfile.mkdtemp()
    try:
        card = timed(0, phase_device, torch)
        import mitsuba2_tpu_torch as mt
        dev = torch.device(DEVICE)
        timed(1, phase_build)
        scenes, extra = timed(2, phase_kernels_vs_twins, torch, mt, dev)
        scenes["xml_gallery"], xml_cfg, xml = timed(
            "3 (xml_gallery, load)", load_xml_gallery, torch, mt,
            scenes["gallery"], xml_dir)
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
            if path in COMPACT:
                timed(f"3 ({path}, image)", phase_compact_path, torch, mt,
                      path, scene)
            if getattr(scene, "medium_grid", None) is not None:
                with path_switches(path):
                    timed(f"3 ({path}, tracking)", phase_tracking, torch, mt,
                          path, scene)
        timed("3 (xml_gallery, cli)", phase_cli, torch, mt, xml,
              scenes["xml_gallery"], xml_cfg, scenes["gallery"], render_ms)
        for path in ("gallery_polarized", "gallery_stokes",
                     "gallery_measured"):
            log(f"phase 3: {path}: peak memory {PEAK_MIB[path][0]:.0f} MiB, "
                f"its renders' working set {PEAK_MIB[path][1]:.0f} MiB, "
                f"beside the gallery's {PEAK_MIB['gallery'][0]:.0f} MiB and "
                f"{PEAK_MIB['gallery'][1]:.0f} MiB; render median "
                f"{render_ms[path]:.1f} ms beside the gallery's "
                f"{render_ms['gallery']:.1f} ms")
        timed("3 (polarized, cli)", phase_polarized_cli, torch, mt, xml_dir)
        t_var = time.perf_counter()
        var_rows = timed("3 (variants)", phase_variants, torch, mt, dev,
                         card, scenes["gallery"])
        for path, rs in var_rows.items():
            for row in rs:
                merge_row(by_name, path, row)
        timed("3 (variants, cli)", phase_variants_cli, torch, mt, xml_dir)
        t_var = time.perf_counter() - t_var
        rows = list(by_name.values())
        timed(4, phase_small_renders, torch, mt, dev)
        timed("4 (polarized)", phase_polarized_small, torch, mt, dev)
        t0 = time.perf_counter()
        timed("4 (variants)", phase_variants_small, torch, mt, dev)
        t_var += time.perf_counter() - t0
        log(f"the variants phase (its phase 3 paths, its cli, its phase 4 "
            f"renders) took {t_var:.1f} s")
        for path, scene in scenes.items():
            if path in XML_PATHS:   # the gallery's tables: profiled there
                continue
            with path_switches(path):
                timed(f"5 ({path})", phase_profile, torch, mt, path, scene,
                      render_ms[path])
        rows += timed(6, phase_probes, torch, dev, card, launches)
        timed(7, phase_adjoint, torch, mt, dev, card, scenes["gallery"],
              scenes["veach"], scenes["veach_spectral"],
              scenes["gallery_textured"], scenes["gallery_reparam"],
              scenes["smoke_box"])
        for path, rs in timed(8, phase_dist, torch, mt, card,
                              scenes["gallery"], xml_dir).items():
            for row in rs:
                merge_row(by_name, path, row)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(xml_dir, ignore_errors=True)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
