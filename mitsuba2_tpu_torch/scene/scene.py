"""Scene: the host build pipeline, the shading record and the traversal
dispatch (counterpart of mitsuba2_tpu/scene/scene.py).

The build half packs meshes, analytic spheres, shared-BLAS instances of
shape groups, the materials of render/bsdf.py, the emitters of
render/emitters.py (area, point, constant, envmap, spot, directional,
projector), the textures their colors name (render/texture.py's atlas),
the shapes' interior media (render/media.py: the medium rows and the one
density grid), the measured BSDFs' tables (render/measured.py, staged in
a list of the build's own) and a perspective or thin-lens camera into
numpy tables byte-equal to the JAX package's `SceneData` fields of the
same names (tests/test_torch_scene.py, tests/test_torch_instancing.py,
tests/test_torch_spheres.py), then uploads them with
`convert.scene_from_numpy`. Anything else a scene can hold raises
naming the feature.

The dispatch half picks, as the JAX package does: brute force for flat
scenes of 192 prims or fewer; above that the cluster walk (or the dense
cluster sweep under MI_MXU_DENSE), or the BVH2 walk when the scene holds
a sphere; for an instanced scene (whatever its size) the instanced
cluster walk, or the instanced BVH2 walk when it holds a sphere; with
MI_MXU_LEAVES=0 the BVH2 walks on every scene (kernels/traverse.py).
`set_backend` forces another choice with the JAX package's names and
errors, the BVH8 walks among them. Wavefronts go through the same coherence presort as the JAX
package's. Every traversal is detached, the geometry tables too; the
shading record's position, and ray_intersect_positions' (the
reparameterization's auxiliary rays), follow prim_p0, prim_e1, prim_e2
and inst_fwd under differentiation, through spectra.gather_columns'
lane gathers. refresh_mxu_feat rebuilds the walk tables derived at
upload after the prim tables are replaced.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.geometry import AnimatedTransform, Frame, Ray
from ..core.math import safe_acos
from ..core.vec import Vec2, Vec3, vwhere
from ..render import bsdf as bsdf_mod
from ..render import emitters as emitters_mod
from ..render import measured as measured_mod
from ..render import media as media_mod
from ..render import spectra as spectra_mod
from ..render import texture as texture_mod
from ..render.interaction import SurfaceInteraction
from ..render.sensors import SENSORS
from ..render.spectra import gather_columns
from . import bvh as bvh_mod
from .shapes import PRIM_SPHERE, PRIM_TRI, Instance, MeshData

# The JAX SceneData fields this slice reads, all byte-equal between the
# two packages' builds; `convert.scene_from_numpy` takes exactly these.
FIELDS = (
    "prim_p0", "prim_e1", "prim_e2", "prim_n0", "prim_n1", "prim_n2",
    "prim_uv0", "prim_uv1", "prim_uv2", "prim_type", "prim_shape",
    "prim_area", "bvh_min", "bvh_max", "bvh_leaf_start", "bvh_leaf_count",
    "bvh_miss", "bvh_hit8", "bvh_miss8", "shape_mat", "shape_emitter",
    "mat_type", "mat_flags", "mat_data", "emitter_type", "emitter_data",
    "emitter_shape", "emitter_prims", "emitter_prim_cdf", "emitter_area",
    "cam_to_world", "cam_fov_x", "cam_data", "mxu_node_f", "mxu_link",
    "cluster_slot_prim", "mxu_feat", "mxu_ccs", "med_type", "med_data",
    "shape_interior")
# ...of which the cluster walks' own, on the device only for a scene that
# takes them (mxu_ccs: the dense sweep's centroids, 32 bytes a cluster,
# held so that the dense switch is read at dispatch; uploaded with
# cluster_feat and mxu_ccount, which convert.py derives), and those read
# at upload alone: packed into the BVH2 walks' tables, or (mxu_feat) into
# cluster_feat
CLUSTER_FIELDS = ("mxu_node_f", "mxu_link", "cluster_slot_prim", "mxu_ccs")
UPLOAD_FIELDS = ("bvh_leaf_start", "bvh_leaf_count", "bvh_miss", "bvh_hit8",
                 "bvh_miss8", "mxu_feat")
# ...and those of an instanced scene (absent, or None, on the others): the
# per-instance transforms and the two walk bounds
INST_FIELDS = ("inst_inv", "inst_fwd", "inst_fuel", "inst_mxu_fuel")
# ...and the tables gradients flow to (diff_tables): these two, on a
# scene with textures the atlas' texels (`tex_data`), on a scene with an
# envmap its image and scale, and on a scene with media the medium rows
# (`med_data`) and the density grid (`med_grid`), under the JAX package's
# names (ENV_DIFF_TABLES, name -> EnvMapData field)
DIFF_TABLES = ("mat_data", "emitter_data")
TEX_DIFF_TABLE = "tex_data"
ENV_DIFF_TABLES = {"env_image": "image", "env_scale": "scale"}
MED_DIFF_TABLE, GRID_DIFF_TABLE = "med_data", "med_grid"
# ...and the BVH8 walks' tables (bvh.collapse_bvh8; None, depth 0, where
# the JAX build skips them: tiny or instanced scenes, a one-cluster cut):
# on the device only for a scene uploaded under set_backend("bvh8") or
# ("bvh8mxu")
BVH8_FIELDS = ("bvh8_child", "bvh8_order", "bvh8_depth", "bvh8c_child",
               "bvh8c_order", "bvh8c_depth")


@dataclasses.dataclass
class SceneData:
    """The scene as tensors on one device, plus static metadata. The walk
    tables are those of the walk the scene takes under the backend in
    force at its upload (kernels/traverse.py: by default the BVH2 walks on
    a scene holding a sphere, the cluster walks on the others; the BVH8
    walks under set_backend("bvh8" | "bvh8mxu")), None for the other walks
    and on a brute-force scene."""
    prim_p0: torch.Tensor    # (P, 3) tri vertex 0 / sphere center, BVH order
    prim_e1: torch.Tensor    # (P, 3) edge 1 / sphere [radius, ±1 flip, 0]
    prim_e2: torch.Tensor    # (P, 3) edge 2 / sphere 0
    prim_n0: torch.Tensor    # (P, 3) per-corner shading normals
    prim_n1: torch.Tensor
    prim_n2: torch.Tensor
    prim_uv0: torch.Tensor   # (P, 2)
    prim_uv1: torch.Tensor
    prim_uv2: torch.Tensor
    prim_type: torch.Tensor  # (P,) i32 PRIM_TRI / PRIM_SPHERE
    prim_shape: torch.Tensor  # (P,) i32
    prim_area: torch.Tensor  # (P,)
    bvh_min: torch.Tensor    # (B, 3) BVH2 node bounds (root = world bounds,
                             # the presort's box; instanced: the stitched
                             # TLAS + BLAS table)
    bvh_max: torch.Tensor
    shape_mat: torch.Tensor      # (S,) i32
    shape_emitter: torch.Tensor  # (S,) i32, -1 = none
    mat_type: torch.Tensor   # (M,) i32
    mat_flags: torch.Tensor  # (M,) i32
    mat_data: torch.Tensor   # (M, MAT_W)
    emitter_type: torch.Tensor      # (E,) i32
    emitter_data: torch.Tensor      # (E, EMIT_W)
    emitter_shape: torch.Tensor     # (E,) i32
    emitter_prims: torch.Tensor     # (E, Fmax) i32, padded -1
    emitter_prim_cdf: torch.Tensor  # (E, Fmax) area cumsum
    emitter_area: torch.Tensor      # (E,)
    cam_to_world: torch.Tensor  # (4, 4)
    cam_fov_x: torch.Tensor     # () degrees
    cam_data: torch.Tensor      # (12,) see build_fields
    cam_weight: torch.Tensor    # () sensor importance (pi for the
                                # irradiance meter, else 1)
    med_type: torch.Tensor      # (Md,) i32 (one zero row without media)
    med_data: torch.Tensor      # (Md, MED_W) render/media.py's rows
    shape_interior: torch.Tensor  # (S,) i32 medium row, -1 = vacuum
    # the cluster walks' tables
    mxu_node_f: Optional[torch.Tensor] = None   # (R, 16) f32 pruned cut tree
    mxu_link: Optional[torch.Tensor] = None     # (R, 16) i32 [hit8 | miss8]
    cluster_slot_prim: Optional[torch.Tensor] = None  # (C*CK,) i32 prim id
                                                      # per slot, -1 pad
    cluster_feat: Optional[torch.Tensor] = None  # (C*CK, 20) f32 slot-major
                                                 # copy of mxu_feat's plane rows
    mxu_ccs: Optional[torch.Tensor] = None   # (C, 8) f32 [centroid.xyz, pad]
                                             # per cluster (the dense sweep)
    mxu_ccount: Optional[torch.Tensor] = None  # (C,) i32 slots up to the
                                               # last real one (the dense
                                               # sweep; convert.slot_counts)
    # the BVH2 walks' tables, packed once at upload (convert.py)
    bvh_node: Optional[torch.Tensor] = None  # (B, 8) f32 [min.xyz, max.xyz,
                                             # leaf_start, leaf_count], the
                                             # last two exact integers
    bvh_link: Optional[torch.Tensor] = None  # (B, 16) i32 [hit8 | miss8]
    bvh_prim: Optional[torch.Tensor] = None  # (P, 12) f32 [p0, e1, e2, type,
                                             # 0, 0]; K6 reads it too
    bvh_pair: Optional[torch.Tensor] = None  # (B, 16) i32 an inner node's
                                             # two children [box, ref, row]
                                             # (convert.bvh_pair_rows; the
                                             # pair walk's)
    # the BVH8 walks' tables (scene/bvh.py::collapse_bvh8), on a scene
    # uploaded under set_backend("bvh8") (K6) or ("bvh8mxu") (K7)
    bvh8_child: Optional[torch.Tensor] = None   # (M*8, 8) f32 [min.xyz,
                                                # max.xyz, kind, count]
    bvh8_order: Optional[torch.Tensor] = None   # (M*8, 8) i32 per octant
    bvh8c_child: Optional[torch.Tensor] = None  # (Mc*8, 16) f32, cluster
                                                # leaves [.., slot base, 0,
                                                # centroid.xyz, pad]
    bvh8c_order: Optional[torch.Tensor] = None  # (Mc*8, 8) i32 per octant
    # instanced scenes: mxu_node_f/mxu_link are then [TLAS | per-group cut
    # trees] (col 7 of a TLAS leaf row = its instance id) and the prim
    # tables hold each group's prims once, in local space.
    # inst_inv (K, 16) f32 [world->local 3x4 | BVH2 BLAS root (the JAX
    # build's, read by no walk here) | cut-tree root | pad]; inst_fwd
    # (K, 16) f32 [local->world 3x4 | cbrt|det| | pad]; inst_bvh_root (K,)
    # i32 each instance's BVH2 BLAS root row (convert.py derives it)
    inst_inv: Optional[torch.Tensor] = None
    inst_fwd: Optional[torch.Tensor] = None
    inst_bvh_root: Optional[torch.Tensor] = None
    # the environment map (render/emitters.py::EnvMapData), None without
    envmap: Optional[emitters_mod.EnvMapData] = None
    # the texture atlas (render/texture.py::TextureAtlas), None without
    textures: Optional[texture_mod.TextureAtlas] = None
    # the heterogeneous media's density grid (render/media.py), None
    # without
    medium_grid: Optional[media_mod.GridVolume] = None
    # the measured BSDFs' tables (render/measured.py), None without
    measured: Optional[measured_mod.MeasuredData] = None
    # a keyframed camera's pose (core/geometry.py), None without
    cam_motion: Optional[AnimatedTransform] = None
    has_media: bool = False     # a shape has an interior medium
    mat_families: Tuple[int, ...] = ()
    family_rows: Tuple[int, ...] = ()   # each family's first material row
    # ((family id, slots), ...): the spectrum slots some row of the family
    # fills with a texture (bsdf.textured_slots), and the emitter types
    # with a textured row: the lookups the shading makes
    family_tex: Tuple = ()
    emitter_tex: Tuple[int, ...] = ()
    # (((wrapper family, child column), leaf families), ...): the families
    # a wrapper's children in that column have (bsdf.wrapper_children)
    wrapper_children: Tuple = ()
    n_emitters: int = 0
    env_emitter: int = -1       # index of the constant emitter or the
                                # envmap, -1 = none
    emitter_kinds: Tuple[int, ...] = ()
    n_shapes: int = 0
    cluster_k: int = 128
    cam_type: str = "perspective"
    has_instances: bool = False
    has_spheres: bool = False   # routes the whole scene to the BVH2 walks
    has_twosided: bool = False  # a material row carries the twosided flag
    inst_fuel: int = 0          # BVH2 two-level walk bound (K4's)
    inst_mxu_fuel: int = 0      # instanced cluster walk bound (K5's)
    bvh8_depth: int = 0         # levels below the BVH8 root (K6's stack)
    bvh8c_depth: int = 0        # the same of the cut tree's (K7's)
    # the differentiable parameters (diff/params.py::traverse): (name,
    # table, row, c0, c1, kind), as the JAX build records them
    param_paths: Tuple = ()

    @property
    def n_prims(self) -> int:
        return self.prim_p0.shape[0]

    @property
    def device(self) -> torch.device:
        return self.prim_p0.device


def to_device(scene: SceneData, device) -> SceneData:
    """The scene with every tensor on `device` (None = the CUDA device;
    raises without one)."""
    from ..device import resolve_device
    dev = resolve_device(device)
    if scene.device == dev:
        return scene
    moved = {f.name: getattr(scene, f.name).to(dev)
             for f in dataclasses.fields(scene)
             if torch.is_tensor(getattr(scene, f.name))}
    if scene.envmap is not None:
        moved["envmap"] = scene.envmap.to(dev)
    if scene.textures is not None:
        moved["textures"] = scene.textures.to(dev)
    if scene.medium_grid is not None:
        moved["medium_grid"] = scene.medium_grid.to(dev)
    if scene.measured is not None:
        moved["measured"] = scene.measured.to(dev)
    if scene.cam_motion is not None:
        moved["cam_motion"] = scene.cam_motion.to(dev)
    return dataclasses.replace(scene, **moved)


def diff_tables(scene) -> dict:
    """The tensors a render's gradients flow to, by the JAX package's
    names: DIFF_TABLES, the atlas' texels, an envmap's image and scale,
    the medium rows and the density grid."""
    out = {k: getattr(scene, k) for k in DIFF_TABLES}
    if scene.textures is not None:
        out[TEX_DIFF_TABLE] = scene.textures.data
    if scene.envmap is not None:
        out.update({k: getattr(scene.envmap, f)
                    for k, f in ENV_DIFF_TABLES.items()})
    if scene.has_media:
        out[MED_DIFF_TABLE] = scene.med_data
        if scene.medium_grid is not None:
            out[GRID_DIFF_TABLE] = scene.medium_grid.data
    return out


# ---------------------------------------------------------------------------
# Host build
# ---------------------------------------------------------------------------

def build_scene(shapes: List[MeshData], sensor: dict, emitters=(),
                device=None) -> SceneData:
    """Pack shapes (meshes and `shapes.Instance` records) + a sensor (+
    shapeless emitters) into a SceneData on `device` (None = the CUDA
    device; raises without one)."""
    from ..convert import scene_from_numpy
    from ..device import resolve_device
    dev = resolve_device(device)
    return scene_from_numpy(build_fields(shapes, sensor, emitters), dev)


def _pick_cluster_k(n_prims: int) -> int:
    """The JAX package's cluster-size policy (CK=256 from 250k prims)."""
    if bvh_mod.CK_FORCED:
        return bvh_mod.CLUSTER_K
    return 256 if n_prims >= 250_000 else bvh_mod.CLUSTER_K


def _prim_count(m) -> int:
    return 1 if m.sphere_center is not None else len(m.faces)


def _should_flatten_instances(inst_records, plain) -> bool:
    """The JAX package's policy for instanced scenes, read from the same
    variables: MI_FLATTEN_INSTANCES=0|1 forces shared BLAS or flattening;
    by default a scene is flattened up to MI_FLATTEN_MAX (4M) effective
    prims and keeps shared BLAS above."""
    mode = os.environ.get("MI_FLATTEN_INSTANCES", "auto").lower()
    if mode in ("0", "false"):
        return False
    if mode in ("1", "true"):
        return True
    cap = int(os.environ.get("MI_FLATTEN_MAX", "4000000"))
    eff = sum(_prim_count(m) for m in plain)
    for rec in inst_records:
        eff += sum(_prim_count(m) for m in rec.group)
    return eff <= cap


def _check_group_shape(sh):
    """What a shapegroup may not hold, whichever side of the flatten cap
    the scene lands on (instance.cpp rejects the same)."""
    if isinstance(sh, Instance):
        raise ValueError("nested instancing is unsupported "
                         "(shapegroup inside shapegroup)")
    if sh.emitter is not None:
        raise ValueError("emitters inside instanced shapegroups are "
                         "unsupported (matches the reference: "
                         "instance.cpp rejects nested emitters)")
    if sh.interior is not None:
        raise ValueError("interior media inside instanced shapegroups "
                         "are unsupported")


def _split_instances(shapes):
    """Instance records and plain shapes -> (shapes in build order,
    records, distinct groups, group index by group identity, first shape
    of each group + the end). Flattened records become plain shapes; the
    groups' shapes follow the plain ones, each group's once."""
    inst_records = [s for s in shapes if isinstance(s, Instance)]
    plain = [s for s in shapes if not isinstance(s, Instance)]
    if inst_records and _should_flatten_instances(inst_records, plain):
        for rec in inst_records:
            for i, m in enumerate(rec.group):
                _check_group_shape(m)
                mi_ = (m.transformed(rec.to_world)
                       if rec.to_world is not None else m.copy())
                mi_.id = f"{rec.id}_g{i}" if rec.id else f"{m.id}_flat{i}"
                plain.append(mi_)
        inst_records = []
    groups, group_of = [], {}
    for rec in inst_records:
        if id(rec.group) not in group_of:
            group_of[id(rec.group)] = len(groups)
            groups.append(rec.group)
    ordered, group_shape0 = list(plain), []
    for grp in groups:
        if len(grp) == 0:
            raise ValueError("instanced shapegroup is empty")
        for sh in grp:
            _check_group_shape(sh)
        group_shape0.append(len(ordered))
        ordered.extend(grp)
    group_shape0.append(len(ordered))
    return ordered, inst_records, group_of, group_shape0


def _refuse_unsupported(shapes, sensor):
    for sh in shapes:
        if not isinstance(sh, MeshData):
            raise TypeError(f"not a shape: {type(sh).__name__}")
    kind = sensor.get("type", "perspective")
    if kind not in SENSORS:
        raise ValueError(f"unknown sensor type {kind!r}")


def _flat_accel(bb_min, bb_max, CK):
    """One BVH over every prim (the BVH2 walk's tree), cut into clusters:
    the cluster walk's cut tree (rows [min, max, slot, pad, centroid
    (filled later), pad])."""
    tree = bvh_mod.build_bvh(bb_min, bb_max)
    oct_hit8, oct_miss8 = bvh_mod.build_octant_links(tree)
    cl_id, cl_starts, cl_counts = bvh_mod.cluster_cut(tree, max_prims=CK)
    cut_min, cut_max, cut_hit8, cut_miss8, cl_id_c = \
        bvh_mod.cut_tree_tables(tree, cl_id, oct_hit8, oct_miss8)
    R = cut_min.shape[0]
    mxu_slot = np.where(cl_id_c >= 0, cl_id_c * CK, -1).astype(np.int32)
    if len(cl_starts) * CK >= (1 << 24):
        raise ValueError("cluster slot ids exceed the f32 exact-integer range")
    slot_prim = np.full(max(len(cl_starts), 1) * CK, -1, np.int32)
    for c, (s0, cnt) in enumerate(zip(cl_starts, cl_counts)):
        slot_prim[c * CK: c * CK + cnt] = np.arange(s0, s0 + cnt)
    # the BVH8 walk's tables, skipped (as in the JAX build) where the
    # BVH2 has 96 rows or fewer
    bvh8 = (bvh_mod.collapse_bvh8(tree) if tree.miss.shape[0] > 96
            else (None, None, 0))
    return dict(
        tree=tree, cl_id=cl_id,
        **dict(zip(("bvh8_child", "bvh8_order", "bvh8_depth"), bvh8)),
        bvh_min=tree.bounds_min, bvh_max=tree.bounds_max,
        bvh_leaf_start=tree.leaf_start, bvh_leaf_count=tree.leaf_count,
        bvh_miss=tree.miss, bvh_hit8=oct_hit8, bvh_miss8=oct_miss8,
        mxu_node_f=np.concatenate(
            [cut_min, cut_max, mxu_slot[:, None].astype(np.float32),
             np.zeros((R, 9), np.float32)], -1),
        mxu_link=np.concatenate(
            [cut_hit8.reshape(R, 8), cut_miss8.reshape(R, 8)], -1),
        slot_prim=slot_prim, row_cluster=cl_id_c, perm=tree.prim_order)


def _instanced_accel(inst_records, group_of, group_shape0, n_shapes, pshape,
                     ptype, bb_min, bb_max, CK):
    """One BLAS per group (the plain shapes form the world group, entered
    as instance 0 with the identity) and a TLAS over the instances' world
    boxes, stitched twice: the BVH2 table (bvh_*, the instanced BVH2
    walk's) and the cluster walk's [TLAS | per-group cut trees]."""
    shape_bounds = np.concatenate([[0], np.cumsum(
        np.bincount(pshape, minlength=n_shapes))]).astype(np.int64)
    n_groups = len(group_shape0) - 1
    g_ranges = [(shape_bounds[group_shape0[g]],
                 shape_bounds[group_shape0[g + 1]]) for g in range(n_groups)]
    world_range = (0, shape_bounds[group_shape0[0]])
    world = world_range[1] > 0
    all_ranges = ([world_range] if world else []) + g_ranges
    blas_list, perm_parts = [], []
    for (pb, pe) in all_ranges:
        if pe == pb:
            raise ValueError("instanced shapegroup has no primitives")
        tree_g = bvh_mod.build_bvh(bb_min[pb:pe], bb_max[pb:pe])
        h8, m8 = bvh_mod.build_octant_links(tree_g)
        blas_list.append((tree_g, h8, m8, int(pb)))
        perm_parts.append(tree_g.prim_order + pb)

    inst_group = [0] if world else []
    inst_mats = [np.eye(4, dtype=np.float32)] if world else []
    goff = 1 if world else 0
    for rec in inst_records:
        inst_group.append(goff + group_of[id(rec.group)])
        inst_mats.append(np.eye(4, dtype=np.float32)
                         if rec.to_world is None else rec.to_world)
    K = len(inst_group)
    ib_min = np.empty((K, 3), np.float32)
    ib_max = np.empty((K, 3), np.float32)
    inst_inv = np.zeros((K, 16), np.float32)
    inst_fwd = np.zeros((K, 16), np.float32)
    for k, (g, M) in enumerate(zip(inst_group, inst_mats)):
        # world box: the group root box's eight corners, moved in f32
        lo = blas_list[g][0].bounds_min[0]
        hi = blas_list[g][0].bounds_max[0]
        corners = np.array([[lo[0] if i & 1 else hi[0],
                             lo[1] if i & 2 else hi[1],
                             lo[2] if i & 4 else hi[2]]
                            for i in range(8)], np.float32)
        wc = corners @ M[:3, :3].T + M[:3, 3]
        ib_min[k], ib_max[k] = wc.min(0), wc.max(0)
        R3 = M[:3, :3]
        det = float(np.linalg.det(R3))
        if abs(det) < 1e-20:
            raise ValueError("singular instance to_world transform")
        inv = np.linalg.inv(M.astype(np.float64))[:3].astype(np.float32)
        pb, pe = all_ranges[g]
        if (ptype[pb:pe] == PRIM_SPHERE).any():
            # analytic spheres stay spheres only under uniform scale
            # (sphere.cpp has the same restriction)
            s = np.cbrt(abs(det))
            if not np.allclose(R3.T @ R3, (s * s) * np.eye(3),
                               rtol=1e-3, atol=1e-5 * s * s):
                raise ValueError(
                    "instanced shapegroups with analytic spheres "
                    "require a uniform-scale rigid transform")
        inst_inv[k, 0:12] = inv.reshape(-1)
        inst_fwd[k, 0:12] = M[:3].reshape(-1)
        inst_fwd[k, 12] = np.cbrt(abs(det))
    tlas = bvh_mod.build_tlas(ib_min, ib_max)
    stitched = bvh_mod.build_two_level(blas_list, inst_group, tlas)
    two = bvh_mod.build_two_level_mxu(blas_list, inst_group, tlas, CK)
    for k in range(K):
        # col 12 indexes the per-instance root array by group id, exactly
        # as the JAX package's build does (byte-equal tables); no walk of
        # the port reads it (convert.py derives each instance's root)
        inst_inv[k, 12] = float(stitched["blas_root"][inst_group[k]])
        inst_inv[k, 13] = float(two["blas_root"][inst_group[k]])
    return dict(
        bvh_min=stitched["node_min"], bvh_max=stitched["node_max"],
        bvh_leaf_start=stitched["leaf_start"],
        bvh_leaf_count=stitched["leaf_count"], bvh_miss=stitched["miss"],
        bvh_hit8=stitched["hit8"], bvh_miss8=stitched["miss8"],
        mxu_node_f=two["node_f"], mxu_link=two["link"],
        slot_prim=two["slot_prim"], row_cluster=two["row_cluster"],
        perm=np.concatenate(perm_parts).astype(np.int32),
        inst_inv=inst_inv, inst_fwd=inst_fwd,
        inst_fuel=int(stitched["fuel"]), inst_mxu_fuel=int(two["fuel"]))


def build_fields(shapes, sensor: dict, emitters=()) -> dict:
    """Host build: shapes (meshes and Instance records) + sensor + shapeless
    emitters -> dict of numpy tables (FIELDS, BVH8_FIELDS, and INST_FIELDS
    for a shared-BLAS scene), `envmap` (an envmap's tables,
    emitters.ENV_FIELDS, or None), `textures` (the atlas' tables,
    texture.TEX_FIELDS, or None), `medium_grid` (the density grid's
    `data`, `bbox_min` and `bbox_max`, or None), `measured` (the measured
    BSDFs' tables, measured.TABLES, or None), `cam_type` and
    `param_paths`, the same arithmetic
    as the JAX package's _build_scene_impl for the features the port
    supports."""
    with spectra_mod.texture_staging() as tex_staging:
        return _build_fields(shapes, sensor, emitters, tex_staging)


def _build_fields(shapes, sensor, emitters, tex_staging) -> dict:
    shapes, inst_records, group_of, group_shape0 = _split_instances(shapes)
    _refuse_unsupported(shapes, sensor)
    mats, mat_key2idx = [], {}
    measured_staging = []   # this build's measured tables, by table id

    def add_material(desc) -> int:
        desc = desc or {"type": "diffuse"}
        key = repr(desc)
        if key not in mat_key2idx:
            mat_key2idx[key] = bsdf_mod.build_material(desc, mats,
                                                       measured_staging)
        return mat_key2idx[key]

    p0s, e1s, e2s, n0s, n1s, n2s, uv0s, uv1s, uv2s = ([] for _ in range(9))
    ptypes, pshapes, pareas = [], [], []
    shape_mat, shape_emitter = [], []
    # (desc, shape index): the shapeless emitters first, as in the JAX build
    emitter_descs = [(e, -1) for e in emitters]
    for s_idx, sh in enumerate(shapes):
        shape_mat.append(add_material(sh.bsdf))
        if sh.emitter is not None:
            shape_emitter.append(len(emitter_descs))
            emitter_descs.append((sh.emitter, s_idx))
        else:
            shape_emitter.append(-1)
        if sh.sphere_center is not None:
            c = np.asarray(sh.sphere_center, np.float32)
            r = float(sh.sphere_radius)
            p0s.append(c[None])
            # e1 = [radius, normal sign (-1 = flip_normals, +1 = out), 0]
            e1s.append(np.array([[r, -1.0 if sh.sphere_flip else 1.0, 0]],
                                np.float32))
            e2s.append(np.zeros((1, 3), np.float32))
            z3, z2 = np.zeros((1, 3), np.float32), np.zeros((1, 2), np.float32)
            n0s.append(z3)
            n1s.append(z3)
            n2s.append(z3)
            uv0s.append(z2)
            uv1s.append(z2)
            uv2s.append(z2)
            ptypes.append(np.array([PRIM_SPHERE], np.int32))
            pshapes.append(np.array([s_idx], np.int32))
            pareas.append(np.array([4.0 * np.pi * r * r], np.float32))
            continue
        v, f = sh.vertices, sh.faces
        if f.shape[0] == 0:
            continue
        a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
        e1, e2 = b - a, c - a
        face_n = np.cross(e1, e2)
        face_area = 0.5 * np.linalg.norm(face_n, axis=-1)
        face_n = face_n / np.maximum(
            np.linalg.norm(face_n, axis=-1, keepdims=True), 1e-20)
        if sh.normals is not None:
            nn0, nn1, nn2 = (sh.normals[f[:, k]] for k in range(3))
        else:
            nn0 = nn1 = nn2 = face_n.astype(np.float32)
        if sh.uvs is not None:
            u0, u1, u2 = (sh.uvs[f[:, k]] for k in range(3))
        else:
            u0 = u1 = u2 = np.zeros((f.shape[0], 2), np.float32)
        p0s.append(a.astype(np.float32))
        e1s.append(e1.astype(np.float32))
        e2s.append(e2.astype(np.float32))
        n0s.append(nn0.astype(np.float32))
        n1s.append(nn1.astype(np.float32))
        n2s.append(nn2.astype(np.float32))
        uv0s.append(u0.astype(np.float32))
        uv1s.append(u1.astype(np.float32))
        uv2s.append(u2.astype(np.float32))
        ptypes.append(np.full(f.shape[0], PRIM_TRI, np.int32))
        pshapes.append(np.full(f.shape[0], s_idx, np.int32))
        pareas.append(face_area.astype(np.float32))

    p0, e1, e2 = (np.concatenate(x) for x in (p0s, e1s, e2s))
    n0, n1, n2 = (np.concatenate(x) for x in (n0s, n1s, n2s))
    uv0, uv1, uv2 = (np.concatenate(x) for x in (uv0s, uv1s, uv2s))
    ptype, pshape = np.concatenate(ptypes), np.concatenate(pshapes)
    parea = np.concatenate(pareas)

    # --- prim AABBs, BVH, cluster cut ------------------------------------
    is_sph = (ptype == PRIM_SPHERE)[:, None]
    r = e1[:, 0:1]
    bb_min = np.where(is_sph, p0 - r,
                      np.minimum(np.minimum(p0, p0 + e1), p0 + e2))
    bb_max = np.where(is_sph, p0 + r,
                      np.maximum(np.maximum(p0, p0 + e1), p0 + e2))
    CK = _pick_cluster_k(p0.shape[0])
    if inst_records:
        acc = _instanced_accel(inst_records, group_of, group_shape0,
                               len(shapes), pshape, ptype, bb_min, bb_max,
                               CK)
    else:
        acc = _flat_accel(bb_min, bb_max, CK)
    mxu_node_f, slot_prim = acc["mxu_node_f"], acc["slot_prim"]
    row_cluster = acc["row_cluster"]
    perm = acc["perm"]
    p0, e1, e2 = p0[perm], e1[perm], e2[perm]
    n0, n1, n2 = n0[perm], n1[perm], n2[perm]
    uv0, uv1, uv2 = uv0[perm], uv1[perm], uv2[perm]
    ptype, pshape, parea = ptype[perm], pshape[perm], parea[perm]

    # --- cluster plane rows (recentred at each cluster's centroid; local
    # space in an instanced scene) ------------------------------------------
    sidx = np.maximum(slot_prim, 0)
    valid = (slot_prim >= 0)[:, None].astype(np.float32)
    cp0, ce1, ce2 = p0[sidx] * valid, e1[sidx] * valid, e2[sidx] * valid
    Sn = slot_prim.shape[0]
    C = Sn // CK
    vcnt = np.maximum(valid.reshape(C, CK).sum(1), 1.0)
    cl_c = (cp0.reshape(C, CK, 3).sum(1) / vcnt[:, None]).astype(np.float32)
    cp0 = cp0 - np.repeat(cl_c, CK, 0) * valid
    cn = np.cross(ce1, ce2)
    fv = np.zeros((C, 4, CK, 16), np.float32)
    fv[:, 0, :, 0:3] = -cn.reshape(C, CK, 3)
    fv[:, 1, :, 0:3] = np.cross(cp0, ce2).reshape(C, CK, 3)
    fv[:, 1, :, 3:6] = ce2.reshape(C, CK, 3)
    fv[:, 2, :, 0:3] = -np.cross(cp0, ce1).reshape(C, CK, 3)
    fv[:, 2, :, 3:6] = -ce1.reshape(C, CK, 3)
    fv[:, 3, :, 6:9] = cn.reshape(C, CK, 3)
    fv[:, 3, :, 9] = -np.sum(cp0 * cn, -1).reshape(C, CK)
    feat = np.ascontiguousarray(fv.reshape(4 * Sn, 16).T)
    is_cl_node = row_cluster >= 0
    mxu_node_f[is_cl_node, 8:11] = cl_c[row_cluster[is_cl_node]]
    mxu_ccs = np.zeros((C, 8), np.float32)
    mxu_ccs[:, 0:3] = cl_c
    # the BVH8 collapse of the cut tree, with cluster leaves (the JAX
    # build's gate: flat, more than 96 BVH2 rows, a root above the cut;
    # built for sphere scenes too, where only the dispatch refuses it)
    bvh8c = (None, None, 0)
    if (not inst_records and acc["tree"].miss.shape[0] > 96
            and acc["cl_id"][0] < 0):
        bvh8c = bvh_mod.collapse_bvh8(acc["tree"], cluster_id=acc["cl_id"],
                                      cluster_c=cl_c, cluster_k=CK)

    # --- emitter tables ----------------------------------------------------
    E = max(len(emitter_descs), 1)
    emitter_rows = np.zeros((E, emitters_mod.EMIT_W), np.float32)
    emitter_types = np.zeros(E, np.int32)
    emitter_shapes = np.full(E, -1, np.int32)
    env_emitter = -1
    envmap = None
    for e_idx, (desc, s_idx) in enumerate(emitter_descs):
        etype, row, aux = emitters_mod.pack_emitter(desc)
        emitter_types[e_idx] = etype
        emitter_rows[e_idx] = row
        emitter_shapes[e_idx] = s_idx
        if etype in (emitters_mod.CONSTANT, emitters_mod.ENVMAP):
            if env_emitter >= 0:
                raise ValueError("only one environment emitter is supported")
            env_emitter = e_idx
        if aux is not None:
            envmap = aux
    prim_lists = []
    for e_idx in range(E):
        s_idx = emitter_descs[e_idx][1] if e_idx < len(emitter_descs) else -1
        prim_lists.append(np.nonzero(pshape == s_idx)[0].astype(np.int32)
                          if s_idx >= 0 else np.zeros(0, np.int32))
    Fmax = max([1] + [len(p) for p in prim_lists])
    emitter_prims = np.full((E, Fmax), -1, np.int32)
    emitter_cdf = np.zeros((E, Fmax), np.float32)
    emitter_area = np.zeros(E, np.float32)
    for e_idx, prims in enumerate(prim_lists):
        if len(prims) == 0:
            continue
        emitter_prims[e_idx, :len(prims)] = prims
        cs = np.cumsum(parea[prims].astype(np.float64))
        emitter_cdf[e_idx, :len(prims)] = cs
        emitter_cdf[e_idx, len(prims):] = cs[-1]
        emitter_area[e_idx] = cs[-1]

    # --- differentiable parameters (mitsuba's traverse() paths): one entry
    # per distinct material row, in shape order, then one per emitter whose
    # type has a parameter -------------------------------------------------
    param_paths = []
    seen_rows = set()
    for s_idx, sh in enumerate(shapes):
        m_idx = shape_mat[s_idx]
        if m_idx in seen_rows:
            continue
        seen_rows.add(m_idx)
        spec = bsdf_mod.FAMILIES[mats[m_idx][0]].param_spec
        for pname, (where, loc) in spec.items():
            slot = where == "slot"
            c0 = loc * bsdf_mod.SLOT_W if slot else loc
            param_paths.append((f"{sh.id or f'shape{s_idx}'}.bsdf.{pname}",
                                "mat_data", m_idx, c0, c0 + (3 if slot else 1),
                                "rgb" if slot else "scalar"))
    for e_idx, (desc, s_idx) in enumerate(emitter_descs):
        pname = emitters_mod.PARAM_NAME.get(int(emitter_types[e_idx]))
        if pname is None:
            continue
        ename = (f"{shapes[s_idx].id or f'shape{s_idx}'}.emitter"
                 if s_idx >= 0 else desc.get("id") or f"emitter{e_idx}")
        param_paths.append((f"{ename}.{pname}", "emitter_data", e_idx, 0, 3,
                            "rgb"))
    for t_idx, tb in enumerate(tex_staging):
        param_paths.append((f"{tb.name or f'texture{t_idx}'}.data",
                            "textures.data", t_idx, -1, -1, "image"))

    # --- media: one row per distinct descriptor (keyed by its repr, as
    # the JAX build keys it), one shared density grid ------------------------
    med_types, med_rows, med_key2idx = [], [], {}
    shape_interior = np.full(max(len(shapes), 1), -1, np.int32)
    medium_grid = None
    for s_idx, sh in enumerate(shapes):
        if sh.interior is None:
            continue
        key = repr(sh.interior)
        if key not in med_key2idx:
            mtype, mrow, grid = media_mod.pack_medium(sh.interior)
            med_key2idx[key] = len(med_rows)
            med_types.append(mtype)
            med_rows.append(mrow)
            if grid is not None:
                if medium_grid is not None:
                    raise ValueError("only one heterogeneous grid supported")
                medium_grid = {"data": grid["density"],
                               "bbox_min": grid["bbox_min"],
                               "bbox_max": grid["bbox_max"]}
        shape_interior[s_idx] = med_key2idx[key]
    if not med_rows:
        med_types, med_rows = [0], [np.zeros(media_mod.MED_W, np.float32)]
    # their parameters (medium.cpp's traverse entries): raw RGB columns
    # ("vec") and scalars, the grid one whole-table entry ("full")
    seen_med = set()
    for s_idx, sh in enumerate(shapes):
        m_row = int(shape_interior[s_idx])
        if m_row < 0 or m_row in seen_med:
            continue
        seen_med.add(m_row)
        mname = f"{sh.id or f'shape{s_idx}'}.interior"
        for pname, c0, c1, kind in (("sigma_t", 0, 3, "vec"),
                                    ("albedo", 3, 6, "vec"),
                                    ("phase_g", 6, 7, "scalar"),
                                    ("scale", 7, 8, "scalar")):
            param_paths.append((f"{mname}.{pname}", "med_data", m_row, c0,
                                c1, kind))
    if medium_grid is not None:
        param_paths.append(("medium.density.data", "medium_grid.data",
                            -1, -1, -1, "full"))

    # --- sensor -------------------------------------------------------------
    cam_motion = None
    if "to_world_keys" in sensor:
        # a keyframed to_world (camera motion blur); the static pose is
        # the first key's
        keys = sensor["to_world_keys"]
        cam_motion = AnimatedTransform.decompose(
            [float(t) for t, _ in keys], [mat for _, mat in keys])
        sensor = dict(sensor, to_world=keys[0][1])
    cam_type = sensor.get("type", "perspective")
    cam_to_world = np.asarray(sensor["to_world"], np.float32).reshape(4, 4)
    cam_data = np.zeros(12, np.float32)
    cam_data[8] = float(sensor.get("near_clip", 0.0))
    cam_data[9] = float(sensor.get("far_clip", np.inf))
    cam_data[10] = float(sensor.get("shutter_open", -np.inf))
    cam_data[11] = float(sensor.get("shutter_close", np.inf))
    if cam_type == "orthographic":
        # the extent from to_world's scale (sensors/orthographic.cpp)
        sx = float(np.linalg.norm(cam_to_world[:3, 0]))
        sy = float(np.linalg.norm(cam_to_world[:3, 1]))
        cam_to_world = cam_to_world.copy()
        cam_to_world[:3, 0] /= max(sx, 1e-20)
        cam_to_world[:3, 1] /= max(sy, 1e-20)
        cam_data[2:4] = [sx, sy]
    else:
        cam_data[0] = float(sensor.get("aperture_radius", 0.0))
        cam_data[1] = float(sensor.get("focus_distance", 1.0))
    # the accel root is the world box in both layouts
    n_min, n_max = acc["bvh_min"], acc["bvh_max"]
    cam_data[4:7] = 0.5 * (n_min[0] + n_max[0])
    cam_data[7] = max(float(np.linalg.norm(n_max[0] - n_min[0])) * 0.5, 1e-3)

    out = dict(
        prim_p0=p0, prim_e1=e1, prim_e2=e2, prim_n0=n0, prim_n1=n1,
        prim_n2=n2, prim_uv0=uv0, prim_uv1=uv1, prim_uv2=uv2,
        prim_type=ptype, prim_shape=pshape, prim_area=parea,
        bvh_min=n_min, bvh_max=n_max,
        **{k: acc[k] for k in ("bvh_leaf_start", "bvh_leaf_count",
                               "bvh_miss", "bvh_hit8", "bvh_miss8")},
        shape_mat=np.asarray(shape_mat, np.int32),
        shape_emitter=np.asarray(shape_emitter, np.int32),
        mat_type=np.asarray([mt[0] for mt in mats], np.int32),
        mat_flags=np.asarray([mt[1] for mt in mats], np.int32),
        mat_data=np.stack([mt[2] for mt in mats]),
        emitter_type=emitter_types, emitter_data=emitter_rows,
        emitter_shape=emitter_shapes, emitter_prims=emitter_prims,
        emitter_prim_cdf=emitter_cdf, emitter_area=emitter_area,
        cam_to_world=cam_to_world,
        cam_fov_x=np.float32(sensor.get("fov", 45.0)),
        cam_data=cam_data, cam_type=cam_type, cam_motion=cam_motion,
        mxu_node_f=mxu_node_f.astype(np.float32),
        mxu_link=acc["mxu_link"].astype(np.int32),
        cluster_slot_prim=slot_prim, mxu_feat=feat, mxu_ccs=mxu_ccs,
        bvh8_child=acc.get("bvh8_child"), bvh8_order=acc.get("bvh8_order"),
        bvh8_depth=acc.get("bvh8_depth", 0),
        **dict(zip(("bvh8c_child", "bvh8c_order", "bvh8c_depth"), bvh8c)),
        med_type=np.asarray(med_types, np.int32),
        med_data=np.stack(med_rows), shape_interior=shape_interior,
        envmap=envmap, textures=texture_mod.pack_atlas(tex_staging),
        medium_grid=medium_grid, param_paths=tuple(param_paths),
        measured=(measured_mod.build_measured(measured_staging)
                  if measured_staging else None))
    if inst_records:
        out.update({k: acc[k] for k in INST_FIELDS})
    return out


# ---------------------------------------------------------------------------
# Shading record (Shape::compute_surface_interaction, triangles)
# ---------------------------------------------------------------------------

# the tables a traversal reads that a loss may move (prim_p0 and inst_fwd
# are what config 5 differentiates): cut from the tape before a traversal
GEOMETRY_TABLES = ("prim_p0", "prim_e1", "prim_e2", "inst_fwd", "inst_inv")


def _norm3(x, y, z):
    inv = 1.0 / torch.sqrt(torch.clamp_min(x * x + y * y + z * z, 1e-30))
    return x * inv, y * inv, z * inv


def _hit_geometry(scene: SceneData, ray: Ray, t, prim, u, v, inst):
    """The hit's prim in world space and its position, as
    compute_surface_interaction and ray_intersect_positions both take
    them: a dict of idx, valid, ptype, the prim's e1/e2 component
    tuples, u, v (the detached exact re-solve where it holds), t_ref, the
    position p, a sphere's unit offset s (None on a sphere-less scene),
    and `iv`, the instances' inverse rows (None unless lifted)."""
    idx = torch.clamp_min(prim, 0).long()
    valid = torch.isfinite(t) & (prim >= 0)
    ptype = scene.prim_type[idx]
    p0x, p0y, p0z = gather_columns(scene.prim_p0, idx, 3)
    e1x, e1y, e1z = gather_columns(scene.prim_e1, idx, 3)
    e2x, e2y, e2z = gather_columns(scene.prim_e2, idx, 3)
    iv = None
    if scene.has_instances and inst is not None:
        iid = torch.clamp_min(inst, 0).long()
        fw = gather_columns(scene.inst_fwd, iid, 13)
        iv = gather_columns(scene.inst_inv, iid, 12)

        def w_point(x, y, z):
            return (fw[0] * x + fw[1] * y + fw[2] * z + fw[3],
                    fw[4] * x + fw[5] * y + fw[6] * z + fw[7],
                    fw[8] * x + fw[9] * y + fw[10] * z + fw[11])

        def w_vec(x, y, z):
            return (fw[0] * x + fw[1] * y + fw[2] * z,
                    fw[4] * x + fw[5] * y + fw[6] * z,
                    fw[8] * x + fw[9] * y + fw[10] * z)

        p0x, p0y, p0z = w_point(p0x, p0y, p0z)   # tri vertex / sphere center
        v1, v2 = w_vec(e1x, e1y, e1z), w_vec(e2x, e2y, e2z)
        if scene.has_spheres:
            # a sphere's e1 = [radius, flip sign, 0]: scale the radius, keep
            # the sign (uniform scale is enforced at build for spheres)
            tri = ptype == PRIM_TRI
            v1 = (torch.where(tri, v1[0], e1x * fw[12]),
                  torch.where(tri, v1[1], e1y), torch.where(tri, v1[2], 0.0))
            v2 = tuple(torch.where(tri, c, 0.0) for c in v2)
        (e1x, e1y, e1z), (e2x, e2y, e2z) = v1, v2

    d, o = ray.d, ray.o
    pvx = d.y * e2z - d.z * e2y
    pvy = d.z * e2x - d.x * e2z
    pvz = d.x * e2y - d.y * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv = torch.where(det.abs() < 1e-18, 0.0, 1.0 / det)
    tvx, tvy, tvz = o.x - p0x, o.y - p0y, o.z - p0z
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    u_x = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    v_x = (d.x * qvx + d.y * qvy + d.z * qvz) * inv
    t_x = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
    if torch.is_grad_enabled():
        # detached, as the JAX package detaches them: the re-solve fixes
        # the primal's precision only, and the hit then follows the
        # geometry at fixed barycentrics (the reparameterization's
        # contract, diff/reparam.py). A ray direction that carries a
        # gradient (a rough lobe's sample) would otherwise send 0 * inf
        # into it through 1 / det where det = 0 (spheres, parallel rays)
        u_x, v_x, t_x = u_x.detach(), v_x.detach(), t_x.detach()
    ok_x = (valid & (ptype == PRIM_TRI) & (inv != 0.0) &
            torch.isfinite(t_x) & (t_x > 0.0))
    u = torch.where(ok_x, u_x, u)
    v = torch.where(ok_x, v_x, v)
    p = Vec3(p0x + e1x * u + e2x * v, p0y + e1y * u + e2y * v,
             p0z + e1z * u + e2z * v)
    s = None
    if scene.has_spheres:
        # sphere (center p0, radius e1.x): the position re-projected onto
        # it (sphere.cpp) along the unit offset s; t clamped on miss
        # lanes, where o + inf * d would give NaN
        t_safe = torch.where(valid, t, 1.0)
        r_sph = torch.clamp_min(e1x, 1e-20)
        s = Vec3(*_norm3(o.x + d.x * t_safe - p0x, o.y + d.y * t_safe - p0y,
                         o.z + d.z * t_safe - p0z))
        p = vwhere(ptype == PRIM_TRI, p, Vec3(p0x + s.x * r_sph,
                                              p0y + s.y * r_sph,
                                              p0z + s.z * r_sph))
    return dict(idx=idx, valid=valid, ptype=ptype, e1=(e1x, e1y, e1z),
                e2=(e2x, e2y, e2z), u=u, v=v,
                t_ref=torch.where(ok_x, t_x, t), p=p, s=s, iv=iv)


def compute_surface_interaction(scene: SceneData, ray: Ray, t, prim, u, v,
                                inst=None) -> SurfaceInteraction:
    """Preliminary hit (t, prim, u, v[, inst]) -> full shading record, with
    the exact f32 Möller–Trumbore re-solve of (u, v, t) for the winning
    triangle (the cluster walks emit u = v = 0). On an instanced scene the
    hit's local-space prim is first lifted to world space by its instance's
    transform: points and edges by inst_fwd, shading normals by the
    inverse transpose (the columns of inst_inv's 3x3), a sphere's center
    as a point and its radius by the uniform scale (inst_fwd col 12). A
    sphere hit is re-projected onto the sphere, its normals flipped where
    e1.y < 0, its uv from the spherical angles. The position is
    ray_intersect_positions' (_hit_geometry)."""
    g = _hit_geometry(scene, ray, t, prim, u, v, inst)
    idx, valid, ptype, iv = g["idx"], g["valid"], g["ptype"], g["iv"]
    (e1x, e1y, e1z), (e2x, e2y, e2z) = g["e1"], g["e2"]
    u, v, t_ref, p = g["u"], g["v"], g["t_ref"], g["p"]
    w = 1.0 - u - v
    ng = Vec3(*_norm3(e1y * e2z - e1z * e2y, e1z * e2x - e1x * e2z,
                      e1x * e2y - e1y * e2x))
    n0x, n0y, n0z = gather_columns(scene.prim_n0, idx, 3)
    n1x, n1y, n1z = gather_columns(scene.prim_n1, idx, 3)
    n2x, n2y, n2z = gather_columns(scene.prim_n2, idx, 3)
    if iv is not None:
        def w_normal(x, y, z):
            return (iv[0] * x + iv[4] * y + iv[8] * z,
                    iv[1] * x + iv[5] * y + iv[9] * z,
                    iv[2] * x + iv[6] * y + iv[10] * z)

        n0x, n0y, n0z = w_normal(n0x, n0y, n0z)
        n1x, n1y, n1z = w_normal(n1x, n1y, n1z)
        n2x, n2y, n2z = w_normal(n2x, n2y, n2z)
    ns = Vec3(*_norm3(n0x * w + n1x * u + n2x * v,
                      n0y * w + n1y * u + n2y * v,
                      n0z * w + n1z * u + n2z * v))
    u0x, u0y = gather_columns(scene.prim_uv0, idx, 2)
    u1x, u1y = gather_columns(scene.prim_uv1, idx, 2)
    u2x, u2y = gather_columns(scene.prim_uv2, idx, 2)
    uv = Vec2(u0x * w + u1x * u + u2x * v, u0y * w + u1y * u + u2y * v)
    if g["s"] is not None:
        sx, sy, sz = g["s"].x, g["s"].y, g["s"].z
        theta = safe_acos(sz)
        phi = torch.atan2(sy, sx)
        phi = torch.where(phi < 0, phi + 2 * math.pi, phi)
        tri = ptype == PRIM_TRI
        # e1.y < 0 marks flip_normals spheres
        sgn = torch.where(e1y < 0, -1.0, 1.0)
        n_s = Vec3(sx * sgn, sy * sgn, sz * sgn)
        ng, ns = vwhere(tri, ng, n_s), vwhere(tri, ns, n_s)
        uv = Vec2(torch.where(tri, uv.x, phi * (0.5 / math.pi)),
                  torch.where(tri, uv.y, theta / math.pi))
    sh_frame = Frame.from_n(ns)
    duv_dx = duv_dy = None
    if getattr(ray, "o_x", None) is not None:
        # the uv footprint (interaction.h::compute_uv_partials): each
        # offset ray meets the tangent plane at p; the position delta goes
        # to barycentric deltas by the normal equations of (e1, e2), then
        # to uv deltas through the triangle's uvs; zero off triangles
        a11 = e1x * e1x + e1y * e1y + e1z * e1z
        a12 = e1x * e2x + e1y * e2y + e1z * e2z
        a22 = e2x * e2x + e2y * e2y + e2z * e2z
        det2 = a11 * a22 - a12 * a12
        inv_det = 1.0 / torch.where(det2.abs() < 1e-20, float("inf"), det2)
        tri_ok = valid & (ptype == PRIM_TRI)

        def plane_delta(o_off: Vec3, d_off: Vec3) -> Vec2:
            denom = d_off.x * ng.x + d_off.y * ng.y + d_off.z * ng.z
            denom = torch.where(denom.abs() < 1e-12, float("inf"), denom)
            tt = ((p.x - o_off.x) * ng.x + (p.y - o_off.y) * ng.y
                  + (p.z - o_off.z) * ng.z) / denom
            dpx = o_off.x + d_off.x * tt - p.x
            dpy = o_off.y + d_off.y * tt - p.y
            dpz = o_off.z + d_off.z * tt - p.z
            b1 = dpx * e1x + dpy * e1y + dpz * e1z
            b2 = dpx * e2x + dpy * e2y + dpz * e2z
            du_b = (a22 * b1 - a12 * b2) * inv_det
            dv_b = (a11 * b2 - a12 * b1) * inv_det
            ok = tri_ok & torch.isfinite(tt)
            return Vec2(
                torch.where(ok, (u1x - u0x) * du_b + (u2x - u0x) * dv_b, 0.0),
                torch.where(ok, (u1y - u0y) * du_b + (u2y - u0y) * dv_b, 0.0))

        duv_dx = plane_delta(ray.o_x, ray.d_x)
        duv_dy = plane_delta(ray.o_y, ray.d_y)
    return SurfaceInteraction(
        valid=valid,
        t=torch.where(valid, t_ref, float("inf")),
        p=p, n=ng, sh_frame=sh_frame, uv=uv,
        wi=sh_frame.to_local(-ray.d),
        shape=torch.where(valid, scene.prim_shape[idx], -1),
        prim_index=torch.where(valid, idx, -1).to(torch.int32),
        wavelengths=ray.wavelengths, tex=scene.textures,
        duv_dx=duv_dx, duv_dy=duv_dy)


# ---------------------------------------------------------------------------
# Traversal dispatch (Scene::ray_intersect / ray_test)
# ---------------------------------------------------------------------------

# The JAX package's backend switch (mitsuba2_tpu/scene/scene.py:1153-1202),
# module state read at every dispatch and at upload. "auto" is brute force
# for small flat scenes and the default walks above; "pallas" and "jnp"
# force the default walks (the JAX names of its TPU and CPU walkers: here
# the CUDA kernels, and their twins on the CPU) whatever the scene's size;
# "brute" forces brute force; "bvh8" and "bvh8mxu" force the BVH8 walks,
# K6 over prim leaves and K7 over cluster leaves (kernels/traverse.py).
BACKENDS = ("auto", "brute", "jnp", "pallas", "bvh8", "bvh8mxu")
_BACKEND = "auto"


def set_backend(name: str) -> None:
    """Force the intersection backend: auto | brute | jnp | pallas | bvh8
    (the BVH8 walk, K6) | bvh8mxu (the BVH8 walk over cluster leaves,
    K7). A scene uploads the tables of the walk the backend in force at
    its upload takes (convert.scene_from_numpy)."""
    global _BACKEND
    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}: one of {BACKENDS}")
    _BACKEND = name


def _walk_for(backend: str, n_prims: int, has_instances: bool,
              has_spheres: bool, has_bvh8: bool, has_bvh8c: bool) -> str:
    """The walk `backend` takes on a scene of this kind: "brute", "walk"
    (the default walks: cluster or BVH2, flat or instanced), "bvh8" or
    "bvh8mxu"; `has_bvh8`/`has_bvh8c`: the scene has K6's/K7's tables.
    Raises the JAX package's ValueErrors where it cannot take a forced
    backend."""
    from ..kernels.brute import takes_brute_force
    if backend in ("brute", "bvh8", "bvh8mxu"):
        if has_instances:
            raise ValueError(f"{backend} backend cannot intersect "
                             "shared-BLAS instanced scenes (prim tables "
                             "are instance-local); use jnp or pallas")
        if backend == "bvh8" and not has_bvh8:
            raise ValueError("bvh8 backend needs BVH8 tables (scene too "
                             "small; brute force covers it; or uploaded "
                             "under another backend)")
        if backend == "bvh8mxu" and has_spheres:
            raise ValueError("bvh8mxu backend is triangle-only "
                             "(spheres have no bilinear plane form); "
                             "use pallas or bvh8")
        if backend == "bvh8mxu" and not has_bvh8c:
            raise ValueError("bvh8mxu backend needs the composed "
                             "cut-tree tables (scene too small, or "
                             "uploaded under another backend)")
        return backend
    if backend == "auto" and takes_brute_force(n_prims, has_instances):
        return "brute"
    return "walk"


def upload_walk(n_prims: int, has_instances: bool, has_spheres: bool,
                has_bvh8: bool, has_bvh8c: bool) -> str:
    """The walk whose tables a scene uploads under the backend in force
    ("brute": none). A backend the scene cannot take uploads the "auto"
    policy's tables, and the dispatch raises on it."""
    kind = (n_prims, has_instances, has_spheres, has_bvh8, has_bvh8c)
    try:
        return _walk_for(_BACKEND, *kind)
    except ValueError:
        return _walk_for("auto", *kind)


def _pick_backend(scene) -> str:
    """The walk of one dispatch (`_walk_for`'s), raising its ValueErrors
    and one where the scene lacks the default walks' tables (it was
    uploaded under another backend, or MXU_LEAVES switch)."""
    walk = _walk_for(_BACKEND, scene.n_prims, scene.has_instances,
                     scene.has_spheres, scene.bvh8_child is not None,
                     scene.bvh8c_child is not None)
    if walk != "walk":
        return walk
    from ..kernels.traverse import takes_bvh2
    bvh2 = takes_bvh2(scene.has_spheres)
    if (scene.bvh_node if bvh2 else scene.mxu_node_f) is None:
        raise ValueError("the scene holds no tables of the default walks "
                         f"({'BVH2' if bvh2 else 'cluster'}): it was uploaded "
                         "under another backend or MXU_LEAVES switch; "
                         "upload it again under this one")
    return "walk"


def _walk_fns(scene, backend):
    """(closest hit, any hit) entry points of a walking backend."""
    from ..kernels import traverse
    if backend == "bvh8":
        return traverse.ray_intersect_bvh8, traverse.ray_test_bvh8
    if backend == "bvh8mxu":
        return traverse.ray_intersect_bvh8mxu, traverse.ray_test_bvh8mxu
    if scene.has_instances:
        return traverse.ray_intersect_instanced, traverse.ray_test_instanced
    return traverse.ray_intersect_preliminary, traverse.ray_test


SORT_MIN_LANES = 16384
SORT_DIRBITS = 9    # direction bucket: 3 bits per axis, as the JAX default


def coherence_key(scene, ray_o: Vec3, ray_d: Vec3, t_max):
    """Presort key (int64 holding uint32): origin Morton cell (major) and a
    direction bucket of SORT_DIRBITS bits; dead lanes (t_max <= 0) get
    0xFFFFFFFF and sort to the back."""
    from ..kernels import compact
    morton = compact.morton3(ray_o, scene.bvh_min[0], scene.bvh_max[0])
    db = SORT_DIRBITS
    b = db // 3
    half = float(1 << (b - 1))
    top = float((1 << b) - 1)

    def qb(c):
        return torch.clamp((c + 1.0) * half, 0.0, top).to(torch.int64)

    dbucket = (qb(ray_d.x) << (2 * b)) | (qb(ray_d.y) << b) | qb(ray_d.z)
    key = ((morton >> db) << db) | dbucket
    return torch.where(t_max <= 0.0, 0xFFFFFFFF, key)


def _presorted(scene, ray_o, ray_d, t_max, fn):
    """Run `fn` on the rays in presort order; returns (outputs, lane) with
    `lane` the original lane of each sorted position."""
    key = coherence_key(scene, ray_o, ray_d, t_max)
    _, lane = torch.sort(key, stable=True)
    o = Vec3(ray_o.x[lane], ray_o.y[lane], ray_o.z[lane])
    d = Vec3(ray_d.x[lane], ray_d.y[lane], ray_d.z[lane])
    return fn(scene, o, d, t_max[lane]), lane


def _unsort(values, lane):
    out = torch.empty_like(values)
    out[lane] = values
    return out


def _detached(ray: Ray) -> Ray:
    """The ray cut from the tape, so that a traversal records nothing
    (outside autograd, the ray itself)."""
    if not torch.is_grad_enabled():
        return ray
    return Ray(o=Vec3(ray.o.x.detach(), ray.o.y.detach(), ray.o.z.detach()),
               d=Vec3(ray.d.x.detach(), ray.d.y.detach(), ray.d.z.detach()),
               maxt=ray.maxt.detach())


def _detached_scene(scene):
    """The scene with its geometry tables cut from the tape where autograd
    records into them, so that a traversal records nothing (else the
    scene itself)."""
    if not torch.is_grad_enabled():
        return scene
    cut = {k: getattr(scene, k).detach() for k in GEOMETRY_TABLES
           if getattr(scene, k) is not None
           and getattr(scene, k).requires_grad}
    return dataclasses.replace(scene, **cut) if cut else scene


def _preliminary_dispatch(scene, ray: Ray, sort=None):
    """Closest-hit query: (t, prim, u, v, inst), inst None except on an
    instanced scene. `sort=None` presorts wavefronts of SORT_MIN_LANES
    lanes or more; False skips it (primary rays). Detached, as every
    traversal: gradients flow through the shading record alone (prim ids
    are integers, and the record re-solves u, v from the tables)."""
    from ..kernels import brute, traverse
    ray, scene = _detached(ray), _detached_scene(scene)
    backend = _pick_backend(scene)
    if backend == "brute":
        return (*brute.ray_intersect_brute(scene, ray.o, ray.d, ray.maxt),
                None)
    fn = _walk_fns(scene, backend)[0]
    n = ray.o.x.shape[0]
    if (n >= SORT_MIN_LANES) if sort is None else sort:
        outs, lane = _presorted(scene, ray.o, ray.d, ray.maxt, fn)
        # walks that emit u = v = 0 need no unsorting of them
        zero_uv = not traverse.emits_uv(scene, backend)
        outs = [a if zero_uv and i in (2, 3) else _unsort(a, lane)
                for i, a in enumerate(outs)]
    else:
        outs = fn(scene, ray.o, ray.d, ray.maxt)
    return tuple(outs) if scene.has_instances else (*outs, None)


def ray_intersect(scene, ray: Ray, sort=None) -> SurfaceInteraction:
    """Scene::ray_intersect — closest hit + shading record."""
    t, prim, u, v, inst = _preliminary_dispatch(scene, ray, sort=sort)
    return compute_surface_interaction(scene, ray, t, prim, u, v, inst)


def ray_intersect_positions(scene, ray: Ray):
    """Closest-hit positions that follow the geometry: (p: Vec3, t,
    valid). The reparameterization's auxiliary rays (diff/reparam.py)
    read the hit position alone: a triangle's point at the detached
    barycentrics of the exact re-solve, a sphere's center plus its radius
    along compute_surface_interaction's unit offset, lifted by inst_fwd on
    an instanced scene, so that p moves with prim_p0, prim_e1, prim_e2
    and inst_fwd under differentiation. p, t and valid are ray_intersect's
    si.p, si.t and si.valid bit for bit (both come from _hit_geometry
    after the same traversal and presort), p in its gradient too; t is
    detached."""
    t, prim, u, v, inst = _preliminary_dispatch(scene, ray)
    g = _hit_geometry(scene, ray, t, prim, u, v, inst)
    t = torch.where(g["valid"], g["t_ref"], float("inf"))
    return g["p"], t.detach(), g["valid"]


def ray_test(scene, ray: Ray) -> torch.Tensor:
    """Scene::ray_test — occlusion within ray.maxt, detached."""
    from ..kernels import brute
    ray, scene = _detached(ray), _detached_scene(scene)
    backend = _pick_backend(scene)
    if backend == "brute":
        return brute.ray_test_brute(scene, ray.o, ray.d, ray.maxt)
    fn = _walk_fns(scene, backend)[1]
    if ray.o.x.shape[0] >= SORT_MIN_LANES:
        occ, lane = _presorted(scene, ray.o, ray.d, ray.maxt, fn)
        return _unsort(occ, lane)
    return fn(scene, ray.o, ray.d, ray.maxt)


# ---------------------------------------------------------------------------
# Derived tables of moved geometry
# ---------------------------------------------------------------------------

def needs_tape(scene) -> bool:
    """Whether a render of `scene` must record autograd's tape: grad is
    enabled and a tensor of the scene requires grad (its geometry and
    instance transforms among them, not only diff_tables')."""
    if not torch.is_grad_enabled():
        return False
    tensors = [v for v in vars(scene).values() if torch.is_tensor(v)]
    return any(t.requires_grad
               for t in tensors + list(diff_tables(scene).values()))


# XLA's CPU compiler sums a long axis in windows of this many elements
# (its tree-reduction rewrite), each window from its first element on,
# then the windows' sums in order
XLA_SUM_WINDOW = 32


def _xla_sum(x):
    """x (C, K, 3) summed over K in the JAX package's order on the CPU:
    each window of XLA_SUM_WINDOW consecutive entries in turn, then the
    windows' sums in turn, so that a refreshed table is byte-equal to the
    JAX package's there."""
    w = min(XLA_SUM_WINDOW, x.shape[1])
    win = x.reshape(x.shape[0], -1, w, x.shape[2])
    acc = win[:, :, 0]
    for j in range(1, w):
        acc = acc + win[:, :, j]
    out = acc[:, 0]
    for b in range(1, acc.shape[1]):
        out = out + acc[:, b]
    return out


def plane_rows(scene):
    """The cluster walks' plane rows of the scene's current prim tables,
    detached, as the JAX package's refresh_mxu_feat computes them:
    (mxu_feat (16, 4*C*CK) in the JAX layout, each cluster's centroid
    (C, 3)). The planes are recentred at the centroid of the cluster's
    real slots' first vertices."""
    sp = scene.cluster_slot_prim
    idx = torch.clamp_min(sp, 0).long()
    valid = (sp >= 0)[:, None].to(torch.float32)
    p0 = scene.prim_p0.detach()[idx] * valid
    e1 = scene.prim_e1.detach()[idx] * valid
    e2 = scene.prim_e2.detach()[idx] * valid
    S, CK = sp.shape[0], scene.cluster_k
    C = S // CK
    vcnt = torch.clamp_min(valid.reshape(C, CK).sum(1), 1.0)
    cl_c = _xla_sum(p0.reshape(C, CK, 3)) / vcnt[:, None]
    p0 = p0 - cl_c.repeat_interleave(CK, 0) * valid
    n = torch.linalg.cross(e1, e2)
    fv = p0.new_zeros((C, 4, CK, 16))
    fv[:, 0, :, 0:3] = (-n).reshape(C, CK, 3)
    fv[:, 1, :, 0:3] = torch.linalg.cross(p0, e2).reshape(C, CK, 3)
    fv[:, 1, :, 3:6] = e2.reshape(C, CK, 3)
    fv[:, 2, :, 0:3] = (-torch.linalg.cross(p0, e1)).reshape(C, CK, 3)
    fv[:, 2, :, 3:6] = (-e1).reshape(C, CK, 3)
    fv[:, 3, :, 6:9] = n.reshape(C, CK, 3)
    fv[:, 3, :, 9] = -(p0 * n).sum(-1).reshape(C, CK)
    return fv.reshape(4 * S, 16).T.contiguous(), cl_c


def refresh_mxu_feat(scene: SceneData) -> SceneData:
    """The walk tables of the scene's current prim tables, detached, on
    its device: call it after replacing prim_p0, prim_e1 or prim_e2 (an
    optimizer step on the geometry), before the scene is rendered on a
    walk, whose tables are derived at upload and do not follow a
    replaced prim table. As the JAX package's refresh_mxu_feat: the plane
    rows recentred at each cluster's new centroid (plane_rows; the walks
    read them slot-major, `cluster_feat`), the centroids in mxu_node_f
    cols 8:11 and mxu_ccs cols 0:3; and, where the scene holds them, the
    tables the JAX package's kernels read live from the prim tables: the
    BVH2 and BVH8 walks' prim rows (`bvh_prim`) and the centroids of the
    cut tree's BVH8 cluster leaves (bvh8c_child cols 8:11, K7's). The
    boxes (BVH bounds and mxu_ccount) stay as built, as in the reference:
    a move that leaves a box culls what it should test. A scene with
    none of these tables (brute force) is returned as it is."""
    from ..convert import prim_rows, slot_major_feat
    new = {}
    if scene.cluster_feat is not None:
        CK = scene.cluster_k
        feat, cl_c = plane_rows(scene)
        new["cluster_feat"] = slot_major_feat(feat, CK)

        def centroids(rows, col):
            slot = rows[:, col].to(torch.int64)
            c = torch.where((slot >= 0)[:, None],
                            cl_c[torch.clamp_min(slot, 0) // CK], 0.0)
            return torch.cat([rows[:, :8], c, rows[:, 11:]], 1)

        if scene.mxu_node_f is not None:
            new["mxu_node_f"] = centroids(scene.mxu_node_f, 6)
        if scene.mxu_ccs is not None:
            new["mxu_ccs"] = torch.cat([cl_c, scene.mxu_ccs[:, 3:]], 1)
        if scene.bvh8c_child is not None:
            # a cluster leaf's kind (col 6) is its slot base, >= 0; an
            # empty or inner child's is negative and keeps its zeros
            new["bvh8c_child"] = torch.where(
                (scene.bvh8c_child[:, 6] >= 0)[:, None],
                centroids(scene.bvh8c_child, 6), scene.bvh8c_child)
    if scene.bvh_prim is not None:
        new["bvh_prim"] = prim_rows({k: getattr(scene, k).detach() for k in (
            "prim_p0", "prim_e1", "prim_e2", "prim_type")})
    return dataclasses.replace(scene, **new) if new else scene
