"""Scene tables from numpy: the port's way of carrying a scene across.

`scene_from_numpy` takes the JAX `SceneData`'s arrays, fetched as numpy
(the keys of scene.FIELDS, and on a shared-BLAS instanced scene those of
scene.INST_FIELDS: two tables and two walk bounds), and returns the
port's scene on `device`. The port's own build goes through it too, so a
converted JAX scene and a scene the port built itself are the same object
for the same inputs. The rest of the static metadata (`has_spheres`
among it) is derived from the tables. Only the tables of the walk the
scene takes under the backend in force (scene.set_backend) go to the
device: by default the BVH2 walks' packed tables (bvh_pair, derived
here, among them) for a scene holding a sphere (or any scene with
traverse.MXU_LEAVES off), the cluster walks' (mxu_ccs, the dense sweep's
centroids, and mxu_ccount, derived here, among them) for the others,
neither for a brute-force scene; under "bvh8" the BVH8 tables and the
packed prim rows (K6), under "bvh8mxu" the cut tree's BVH8 tables and
the cluster plane rows (K7). The BVH8 tables (scene.BVH8_FIELDS) may be
absent from `fields`. `fields["envmap"]` carries an envmap's tables
(emitters.ENV_FIELDS: the image, its importance and alias tables, the
rotation, the scale and the per-texel coefficients), None or absent
without one; `fields["textures"]` the texture atlas' tables
(texture.TEX_FIELDS: the padded texels, `info` and `uvt`), whose mip
pyramid is rebuilt here, on the device; `fields["medium_grid"]` the
heterogeneous media's density grid (`data`, `bbox_min`, `bbox_max`; the
JAX SceneData's GridVolume), None or absent without one;
`fields["cam_type"]` the sensor's type (absent: "perspective"), whose
importance weight (pi for the irradiance meter, else 1) is derived here,
and `fields["cam_motion"]` a keyframed camera's tables
(geometry.ANIM_FIELDS), None or absent without one; `fields["measured"]`
the measured BSDFs' tables (measured.TABLES: `values`, `weights`,
`marg_cdf`, `cond_cdf` and, where a row is measured_polarized,
`mueller`), None or absent without one. A table that names a family the
port does not know raises, and so does a textured slot without the atlas
that holds its texture, or a measured row without the tables.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .core.geometry import AnimatedTransform
from .device import resolve_device
from .kernels import traverse
from .render import bsdf as bsdf_mod
from .render import emitters as emitters_mod
from .render import measured as measured_mod
from .render import media as media_mod
from .render import texture as texture_mod
from .render.spectra import SLOT_TEX_BASE
from .scene.bvh import BLAS_EXIT, LEAF_K
from .scene.scene import (BVH8_FIELDS, CLUSTER_FIELDS, FIELDS, INST_FIELDS,
                          PRIM_SPHERE, UPLOAD_FIELDS, SceneData, upload_walk)


def slot_major_feat(mxu_feat, cluster_k: int):
    """(16, 4*C*CK) transposed, cluster-major plane rows -> (C*CK, 20)
    slot-major rows [det(3) | u(6) | v(6) | t(4) | pad] for the walk: a
    numpy table in, a numpy table out; a tensor in, a tensor on its
    device out (scene.refresh_mxu_feat's)."""
    if isinstance(mxu_feat, np.ndarray):
        return slot_major_feat(torch.from_numpy(np.array(
            mxu_feat, np.float32, order="C")), cluster_k).numpy()
    S = mxu_feat.shape[1] // 4
    C = S // cluster_k
    fv = mxu_feat.T.reshape(C, 4, cluster_k, 16)
    out = mxu_feat.new_zeros((C, cluster_k, traverse.FEAT_W))
    out[..., 0:3] = fv[:, 0, :, 0:3]
    out[..., 3:9] = fv[:, 1, :, 0:6]
    out[..., 9:15] = fv[:, 2, :, 0:6]
    out[..., 15:19] = fv[:, 3, :, 6:10]
    return out.reshape(S, traverse.FEAT_W)


def slot_counts(slot_prim: np.ndarray, cluster_k: int) -> np.ndarray:
    """mxu_ccount, (C,) i32: the span of each cluster's slots that the
    dense sweep tests, 1 + its last slot k with slot_prim[c*CK + k] >= 0,
    or 0 for a cluster with no real slot. The slots after it are padding,
    whose plane rows are all zero and never hit."""
    real = slot_prim.reshape(-1, cluster_k) >= 0
    last = cluster_k - np.argmax(real[:, ::-1], axis=1)
    return np.where(real.any(1), last, 0).astype(np.int32)


def prim_rows(f):
    """The prim rows the BVH2 and BVH8 walks test, (P, 12) f32 [p0, e1,
    e2, type, 0, 0], from the SceneData arrays (numpy) or tensors (a
    tensor on their device: scene.refresh_mxu_feat's)."""
    P = f["prim_p0"].shape[0]
    if torch.is_tensor(f["prim_p0"]):
        return torch.cat([f["prim_p0"], f["prim_e1"], f["prim_e2"],
                          f["prim_type"].to(torch.float32)[:, None],
                          f["prim_p0"].new_zeros((P, 2))], -1)
    prim = np.concatenate([f["prim_p0"], f["prim_e1"], f["prim_e2"],
                           f["prim_type"].astype(np.float32)[:, None],
                           np.zeros((P, 2), np.float32)], -1)
    return prim.astype(np.float32)


def bvh_walk_tables(f: Dict[str, np.ndarray]):
    """The BVH2 walks' tables from the SceneData arrays: node rows (B, 8)
    f32 [min.xyz, max.xyz, leaf_start, leaf_count] (the two integers held
    exactly as floats, as mxu_node_f holds its slot ids), links (B, 16)
    i32 [hit8 | miss8], the child-pair rows (B, 16) i32 (bvh_pair_rows)
    and prim rows (P, 12) f32 (prim_rows)."""
    B, P = f["bvh_min"].shape[0], f["prim_p0"].shape[0]
    if max(P, int(f["bvh_leaf_start"].max())) >= (1 << 24):
        raise ValueError("prim ids exceed the f32 exact-integer range")
    counts = np.stack([f["bvh_leaf_start"], f["bvh_leaf_count"]], -1)
    node = np.concatenate([f["bvh_min"], f["bvh_max"],
                           counts.astype(np.float32)], -1)
    link = np.concatenate([f["bvh_hit8"].reshape(B, 8),
                           f["bvh_miss8"].reshape(B, 8)], -1)
    node, link = node.astype(np.float32), link.astype(np.int32)
    return node, link, bvh_pair_rows(node, link), prim_rows(f)


def bvh_pair_rows(node: np.ndarray, link: np.ndarray) -> np.ndarray:
    """The child-pair rows of the pair walk (K3's both hits, K4's any
    hit) from the BVH2 walks' node rows and links (bvh_walk_tables), (B,
    16) i32, 64 bytes a row: row n of an inner node n holds its two
    children as two records [min.xyz, max.xyz, ref, row]: the child's box,
    the very floats of its node row (as their bits); its reference, its
    row if it is an inner node, else ~(start << 2 | (count - 1)) for a
    leaf of prims or ~(PAIR_INST | id) for a TLAS leaf of instance id;
    and its own row. Record 0 is the child the links enter first for
    octant 0 (hit8), record 1 its sibling (the first child's miss8); bit
    o of the first record's row word, above PAIR_ROW_BITS, is set where
    octant o enters record 1 first. A leaf's row is zero and never read:
    a row id names its pair row, the roots' (row 0, inst_bvh_root)
    included. Raises where a row id, a prim id or an instance id does not
    fit its field, or where a child is not its sibling's partner."""
    PAIR_INST, PAIR_ROW_BITS = traverse.PAIR_INST, traverse.PAIR_ROW_BITS
    B = node.shape[0]
    if B >= (1 << PAIR_ROW_BITS):
        raise ValueError(f"{B} BVH2 rows: the pair rows hold row ids below "
                         f"2^{PAIR_ROW_BITS}")
    start, count = node[:, 6].astype(np.int64), node[:, 7].astype(np.int64)
    if (count > LEAF_K).any() or (start >= PAIR_INST).any():
        raise ValueError("a leaf holds more than LEAF_K prims, or an "
                         "instance id does not fit a pair reference")
    ref = np.where(start < 0, np.arange(B),
                   ~np.where(count > 0, (start << 2) | (count - 1),
                             PAIR_INST | start))
    inner = np.nonzero(start < 0)[0]
    c0 = link[inner, 0].astype(np.int64)
    c1 = link[c0, 8].astype(np.int64)
    first = link[inner, :8].astype(np.int64)
    second = link[first, 8 + np.arange(8)]
    swap = first == c1[:, None]
    if ((c0 < 0) | (c1 < 0)).any() or not (
            (swap | (first == c0[:, None])).all()
            and np.where(swap, second == c0[:, None],
                         second == c1[:, None]).all()):
        raise ValueError("bvh_link: an inner node's children are not a "
                         "pair under every octant")
    mask = (swap.astype(np.int64) << np.arange(8)).sum(1)
    rows = np.zeros((B, 16), np.int32)
    for k, (c, word) in enumerate(((c0, c0 | mask << PAIR_ROW_BITS),
                                   (c1, c1))):
        rows[inner, 8 * k:8 * k + 6] = node[c, 0:6].view(np.int32)
        rows[inner, 8 * k + 6] = ref[c]
        rows[inner, 8 * k + 7] = word.astype(np.uint32).view(np.int32)
    return rows


def instance_bvh_roots(f: Dict[str, np.ndarray], inst_inv: np.ndarray):
    """Each instance's BLAS root row in the stitched BVH2 table, (K,) i32.

    The table is [TLAS | world group's BLAS | each group's BLAS], and the
    cluster walk's table has the same TLAS and the groups in the same
    order, so inst_inv col 13 (the group's cut-tree root, right for every
    instance) ranks the instance's group. A BLAS block ends at its last
    DFS row, the one leaf whose miss link is BLAS_EXIT. inst_inv col 12,
    the JAX build's BVH2 root, is not read: it indexes a per-instance
    array by group id, which is wrong once instances do not bring their
    groups in order (instances of A, A, B give B the root of A)."""
    cut_root = inst_inv[:, 13].astype(np.int64)
    first = int(cut_root.min())                  # = TLAS rows, the first BLAS
    rows = np.arange(f["bvh_miss"].shape[0])
    ends = rows[(rows >= first) & (f["bvh_leaf_count"] > 0)
                & (f["bvh_miss"] == BLAS_EXIT)]
    starts = np.concatenate([[first], ends[:-1] + 1])
    groups = np.unique(cut_root)
    if len(groups) != len(starts):
        raise ValueError("instanced tables: the BVH2 and cluster tables "
                         "hold different numbers of groups")
    return starts[np.searchsorted(groups, cut_root)].astype(np.int32)


def scene_from_numpy(fields: Dict[str, np.ndarray], device=None) -> SceneData:
    """numpy tables (scene.FIELDS) -> SceneData on `device` (None = the
    CUDA device; raises without one)."""
    missing = [k for k in FIELDS if k not in fields]
    if missing:
        raise KeyError(f"scene_from_numpy: missing fields {missing}")
    f = {k: np.asarray(fields[k]) for k in FIELDS}
    # area emitters sit on a shape, the others on none; a shapeless area
    # row is the all-zero padding of an emitter-less scene
    etype, shaped = f["emitter_type"], f["emitter_shape"] >= 0
    pad = ~shaped & (etype == emitters_mod.AREA)
    kinds = (emitters_mod.POINT, emitters_mod.CONSTANT, emitters_mod.ENVMAP,
             emitters_mod.SPOT, emitters_mod.DIRECTIONAL,
             emitters_mod.PROJECTOR)
    if ((etype[shaped] != emitters_mod.AREA).any()
            or not np.isin(etype[~shaped & ~pad], kinds).all()
            or f["emitter_data"][pad].any()):
        raise ValueError("emitter tables: an area emitter without a shape "
                         "or another kind on one")
    n_emitters = int((~pad).sum())
    env = np.nonzero(np.isin(etype[:n_emitters], (emitters_mod.CONSTANT,
                                                  emitters_mod.ENVMAP)))[0]
    envmap = fields.get("envmap")
    if (envmap is not None) != bool((etype[:n_emitters]
                                     == emitters_mod.ENVMAP).any()):
        raise KeyError("scene_from_numpy: an envmap emitter needs its "
                       "tables under 'envmap', and only it")
    grid = fields.get("medium_grid")
    in_use = f["med_type"][np.unique(f["shape_interior"][
        f["shape_interior"] >= 0])]
    if (grid is not None) != bool(
            (in_use == media_mod.MEDIUM_HETEROGENEOUS).any()):
        raise KeyError("scene_from_numpy: a heterogeneous medium needs its "
                       "density grid under 'medium_grid', and only it")
    inst = fields.get("inst_inv") is not None
    if inst:
        missing = [k for k in INST_FIELDS if fields.get(k) is None]
        if missing:
            raise KeyError(f"scene_from_numpy: missing fields {missing}")
    families = tuple(sorted({int(t) for t in f["mat_type"]}))
    for fid in families:
        if fid not in bsdf_mod.FAMILIES:
            raise ValueError(f"mat_type: unknown BSDF family {fid}")
    measured = fields.get("measured")
    if (measured is not None) != bool(
            {bsdf_mod.MEASURED, bsdf_mod.MEASURED_POLARIZED} & set(families)):
        raise KeyError("scene_from_numpy: a measured BSDF needs its tables "
                       "under 'measured', and only it")
    if (bsdf_mod.MEASURED_POLARIZED in families
            and measured.get("mueller") is None):
        raise KeyError("scene_from_numpy: a measured_polarized BSDF needs "
                       "the Mueller tables under measured['mueller']")
    # the kind column of every spectrum slot a row may carry: a material's
    # three color slots and its roughness slot, an emitter's radiance
    kinds = np.concatenate([
        f["mat_data"][:, [7, 15, 23, bsdf_mod.ALPHA_SLOT + 7]].ravel(),
        f["emitter_data"][:n_emitters, 7]])
    tex = fields.get("textures")
    n_tex = 0 if tex is None else np.asarray(tex["data"]).shape[0]
    textured = kinds[kinds >= SLOT_TEX_BASE].astype(np.int64)
    if ((textured - 2) // 2 >= n_tex).any():
        raise KeyError("scene_from_numpy: a textured slot names a texture "
                       "beyond the atlas under 'textures'")
    n_clusters = int((f["mxu_node_f"][:, 6] >= 0).sum())
    cluster_k = f["cluster_slot_prim"].shape[0] // max(n_clusters, 1)
    has_spheres = bool((f["prim_type"] == PRIM_SPHERE).any())
    b8 = {k: fields.get(k) for k in BVH8_FIELDS}
    walk = upload_walk(f["prim_type"].shape[0], inst, has_spheres,
                       b8["bvh8_child"] is not None,
                       b8["bvh8c_child"] is not None)
    dev = resolve_device(device)

    def up(a):
        return torch.from_numpy(np.array(a, order="C")).to(dev)

    tabs = {k: up(f[k]) for k in FIELDS
            if k not in CLUSTER_FIELDS + UPLOAD_FIELDS}
    if walk == "walk" and traverse.takes_bvh2(has_spheres):
        tabs.update(zip(("bvh_node", "bvh_link", "bvh_pair", "bvh_prim"),
                        map(up, bvh_walk_tables(f))))
        if inst:
            tabs["inst_bvh_root"] = up(instance_bvh_roots(
                f, np.asarray(fields["inst_inv"])))
    elif walk == "walk":
        tabs.update({k: up(f[k]) for k in CLUSTER_FIELDS})
        tabs["cluster_feat"] = up(slot_major_feat(f["mxu_feat"], cluster_k))
        tabs["mxu_ccount"] = up(slot_counts(f["cluster_slot_prim"],
                                            cluster_k))
    elif walk == "bvh8":
        tabs.update(bvh8_child=up(b8["bvh8_child"]),
                    bvh8_order=up(b8["bvh8_order"]),
                    bvh_prim=up(prim_rows(f)),
                    bvh8_depth=int(b8["bvh8_depth"]))
    elif walk == "bvh8mxu":
        tabs.update(bvh8c_child=up(b8["bvh8c_child"]),
                    bvh8c_order=up(b8["bvh8c_order"]),
                    cluster_slot_prim=up(f["cluster_slot_prim"]),
                    cluster_feat=up(slot_major_feat(f["mxu_feat"],
                                                    cluster_k)),
                    bvh8c_depth=int(b8["bvh8c_depth"]))
    cam_type = str(fields.get("cam_type", "perspective"))
    # sensor importance: the cosine-sampled irradiance meter's pdf is
    # cos / pi (sensors/irradiancemeter.cpp)
    cam_weight = np.pi if cam_type == "irradiancemeter" else 1.0
    motion = fields.get("cam_motion")
    return SceneData(
        **tabs,
        cam_weight=up(np.float32(cam_weight)),
        cam_motion=(None if motion is None
                    else AnimatedTransform.from_numpy(motion, dev)),
        envmap=(None if envmap is None
                else emitters_mod.envmap_from_numpy(envmap, dev)),
        textures=(None if tex is None
                  else texture_mod.atlas_from_numpy(tex, dev)),
        medium_grid=(None if grid is None else media_mod.GridVolume(
            *(up(np.asarray(grid[k], np.float32))
              for k in ("data", "bbox_min", "bbox_max")))),
        measured=(None if measured is None
                  else measured_mod.measured_from_numpy(measured, dev)),
        has_media=bool(in_use.size),
        inst_inv=up(fields["inst_inv"]) if inst else None,
        inst_fwd=up(fields["inst_fwd"]) if inst else None,
        mat_families=families,
        family_rows=tuple(int(np.argmax(f["mat_type"] == fid))
                          for fid in families),
        family_tex=bsdf_mod.textured_slots(f["mat_type"], f["mat_data"]),
        wrapper_children=bsdf_mod.wrapper_children(f["mat_type"],
                                                   f["mat_data"]),
        emitter_tex=tuple(sorted({int(t) for t, k in zip(
            etype[:n_emitters], f["emitter_data"][:n_emitters, 7])
            if k >= SLOT_TEX_BASE})),
        n_emitters=n_emitters,
        env_emitter=int(env[0]) if env.size else -1,
        emitter_kinds=tuple(sorted({int(t) for t in etype[:n_emitters]})),
        n_shapes=int(f["shape_mat"].shape[0]), cluster_k=cluster_k,
        cam_type=cam_type,
        has_instances=inst, has_spheres=has_spheres,
        has_twosided=bool(
            (f["mat_flags"] & bsdf_mod.F_TWOSIDED_FLAG).any()),
        inst_fuel=int(fields["inst_fuel"]) if inst else 0,
        inst_mxu_fuel=int(fields["inst_mxu_fuel"]) if inst else 0,
        param_paths=tuple(fields.get("param_paths", ())))
