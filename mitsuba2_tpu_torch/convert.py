"""Scene tables from numpy: the port's way of carrying a scene across.

`scene_from_numpy` takes the JAX `SceneData`'s arrays, fetched as numpy
(the keys of scene.FIELDS, and on a shared-BLAS instanced scene those of
scene.INST_FIELDS: two tables and two walk bounds), and returns the
port's scene on `device`. The port's own build goes through it too, so a
converted JAX scene and a scene the port built itself are the same object
for the same inputs. The rest of the static metadata is derived from the
tables; a table that names a feature this slice does not render (spheres,
emitters other than area and constant ones, BSDF families other than
diffuse, twosided BSDFs, textured colors) raises.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .device import resolve_device
from .kernels.traverse import FEAT_W
from .render import bsdf as bsdf_mod
from .render import emitters as emitters_mod
from .render.spectra import SLOT_TEX_BASE
from .scene.scene import FIELDS, INST_FIELDS, PRIM_SPHERE, SceneData


def slot_major_feat(mxu_feat: np.ndarray, cluster_k: int) -> np.ndarray:
    """(16, 4*C*CK) transposed, cluster-major plane rows -> (C*CK, 20)
    slot-major rows [det(3) | u(6) | v(6) | t(4) | pad] for the walk."""
    S = mxu_feat.shape[1] // 4
    C = S // cluster_k
    fv = np.ascontiguousarray(mxu_feat.T).reshape(C, 4, cluster_k, 16)
    out = np.zeros((C, cluster_k, FEAT_W), np.float32)
    out[..., 0:3] = fv[:, 0, :, 0:3]
    out[..., 3:9] = fv[:, 1, :, 0:6]
    out[..., 9:15] = fv[:, 2, :, 0:6]
    out[..., 15:19] = fv[:, 3, :, 6:10]
    return out.reshape(S, FEAT_W)


def scene_from_numpy(fields: Dict[str, np.ndarray], device=None) -> SceneData:
    """numpy tables (scene.FIELDS) -> SceneData on `device` (None = the
    CUDA device; raises without one)."""
    missing = [k for k in FIELDS if k not in fields]
    if missing:
        raise KeyError(f"scene_from_numpy: missing fields {missing}")
    f = {k: np.asarray(fields[k]) for k in FIELDS}
    if (f["prim_type"] == PRIM_SPHERE).any():
        raise NotImplementedError(
            "mitsuba2_tpu_torch does not support analytic spheres yet")
    # area emitters sit on a shape, the constant one on none; a shapeless
    # area row is the all-zero padding of an emitter-less scene
    etype, shaped = f["emitter_type"], f["emitter_shape"] >= 0
    pad = ~shaped & (etype == emitters_mod.AREA)
    if ((etype[shaped] != emitters_mod.AREA).any()
            or (etype[~shaped & ~pad] != emitters_mod.CONSTANT).any()
            or f["emitter_data"][pad].any()):
        raise NotImplementedError(
            "mitsuba2_tpu_torch supports area and constant emitters only")
    n_emitters = int((~pad).sum())
    env = np.nonzero(etype[:n_emitters] == emitters_mod.CONSTANT)[0]
    inst = fields.get("inst_inv") is not None
    if inst:
        missing = [k for k in INST_FIELDS if fields.get(k) is None]
        if missing:
            raise KeyError(f"scene_from_numpy: missing fields {missing}")
    families = tuple(sorted({int(t) for t in f["mat_type"]}))
    for fid in families:
        if fid not in bsdf_mod.FAMILIES:
            raise NotImplementedError(
                f"mitsuba2_tpu_torch does not support BSDF family {fid} yet")
    if (f["mat_flags"] & bsdf_mod.F_TWOSIDED_FLAG).any():
        raise NotImplementedError(
            "mitsuba2_tpu_torch does not support twosided BSDFs yet")
    if ((f["mat_data"][:, 7] >= SLOT_TEX_BASE).any()
            or (f["emitter_data"][:, 7] >= SLOT_TEX_BASE).any()):
        raise NotImplementedError(
            "mitsuba2_tpu_torch does not support textured colors yet")
    n_clusters = int((f["mxu_node_f"][:, 6] >= 0).sum())
    cluster_k = f["cluster_slot_prim"].shape[0] // max(n_clusters, 1)
    dev = resolve_device(device)

    def up(a):
        return torch.from_numpy(np.array(a, order="C")).to(dev)

    return SceneData(
        **{k: up(f[k]) for k in FIELDS},
        cluster_feat=up(slot_major_feat(f["mxu_feat"], cluster_k)),
        inst_inv=up(fields["inst_inv"]) if inst else None,
        inst_fwd=up(fields["inst_fwd"]) if inst else None,
        mat_families=families, n_emitters=n_emitters,
        env_emitter=int(env[0]) if env.size else -1,
        emitter_kinds=tuple(sorted({int(t) for t in etype[:n_emitters]})),
        n_shapes=int(f["shape_mat"].shape[0]), cluster_k=cluster_k,
        has_instances=inst,
        inst_fuel=int(fields["inst_fuel"]) if inst else 0,
        inst_mxu_fuel=int(fields["inst_mxu_fuel"]) if inst else 0)
