"""Procedural shape constructors (host, numpy; counterpart of
scene/shapes.py: triangle meshes and analytic spheres) and shared-BLAS
instances."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


# the prim types of the scene tables (scene.py's prim_type)
PRIM_TRI = 0
PRIM_SPHERE = 1


@dataclasses.dataclass
class MeshData:
    """One shape: a triangle mesh or an analytic sphere, with its scene
    wiring. `interior` exists so a scene naming it can be refused by
    name."""
    vertices: np.ndarray                   # (V, 3) f32
    faces: np.ndarray                      # (F, 3) i32
    normals: Optional[np.ndarray] = None   # (V, 3) f32 vertex normals
    uvs: Optional[np.ndarray] = None       # (V, 2) f32
    # analytic sphere (if not None, vertices/faces are ignored)
    sphere_center: Optional[np.ndarray] = None
    sphere_radius: Optional[float] = None
    sphere_flip: bool = False              # inward-facing normals
    bsdf: Optional[object] = None          # bsdf descriptor (dict)
    emitter: Optional[object] = None       # emitter descriptor (dict) or None
    interior: Optional[object] = None      # interior medium descriptor
    id: str = ""

    def copy(self) -> "MeshData":
        return dataclasses.replace(self)

    def transformed(self, to_world) -> "MeshData":
        """Apply a host 4x4 matrix. A sphere's center moves and its radius
        scales by cbrt|det| of the 3x3 part."""
        mat = np.asarray(to_world, np.float32).reshape(4, 4)
        out = dataclasses.replace(self)
        if self.sphere_center is not None:
            c = mat[:3, :3] @ self.sphere_center + mat[:3, 3]
            scale = np.cbrt(abs(np.linalg.det(mat[:3, :3])))
            out.sphere_center = c.astype(np.float32)
            out.sphere_radius = float(self.sphere_radius * scale)
            return out
        v = self.vertices @ mat[:3, :3].T + mat[:3, 3]
        out.vertices = v.astype(np.float32)
        if self.normals is not None:
            inv_t = np.linalg.inv(mat[:3, :3]).T
            n = self.normals @ inv_t.T
            n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
            out.normals = n.astype(np.float32)
        return out


def rectangle(bsdf=None, emitter=None, id="") -> MeshData:
    """Unit rectangle on z=0 spanning [-1,1]^2, normal +z."""
    v = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    n = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return MeshData(vertices=v, faces=f, normals=n, uvs=uv,
                    bsdf=bsdf, emitter=emitter, id=id)


_CUBE_QUADS = [
    ([(-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1)], (0, 0, 1)),
    ([(-1, -1, -1), (-1, 1, -1), (1, 1, -1), (1, -1, -1)], (0, 0, -1)),
    ([(1, -1, -1), (1, 1, -1), (1, 1, 1), (1, -1, 1)], (1, 0, 0)),
    ([(-1, -1, -1), (-1, -1, 1), (-1, 1, 1), (-1, 1, -1)], (-1, 0, 0)),
    ([(-1, 1, -1), (-1, 1, 1), (1, 1, 1), (1, 1, -1)], (0, 1, 0)),
    ([(-1, -1, -1), (1, -1, -1), (1, -1, 1), (-1, -1, 1)], (0, -1, 0)),
]


def cube(bsdf=None, emitter=None, id="") -> MeshData:
    """Axis-aligned cube [-1,1]^3 with outward normals."""
    verts, faces, normals, uvs = [], [], [], []
    for quad, n in _CUBE_QUADS:
        base = len(verts)
        verts.extend(quad)
        normals.extend([n] * 4)
        uvs.extend([(0, 0), (1, 0), (1, 1), (0, 1)])
        faces.append([base, base + 1, base + 2])
        faces.append([base, base + 2, base + 3])
    return MeshData(vertices=np.asarray(verts, np.float32),
                    faces=np.asarray(faces, np.int32),
                    normals=np.asarray(normals, np.float32),
                    uvs=np.asarray(uvs, np.float32),
                    bsdf=bsdf, emitter=emitter, id=id)


def sphere(center=(0, 0, 0), radius=1.0, bsdf=None, emitter=None,
           id="") -> MeshData:
    """Analytic sphere (shapes/sphere.cpp): closed-form intersection."""
    return MeshData(vertices=np.zeros((0, 3), np.float32),
                    faces=np.zeros((0, 3), np.int32),
                    sphere_center=np.asarray(center, np.float32),
                    sphere_radius=float(radius),
                    bsdf=bsdf, emitter=emitter, id=id)


def mesh(vertices, faces, normals=None, uvs=None, bsdf=None, emitter=None,
         id="") -> MeshData:
    return MeshData(vertices=np.asarray(vertices, np.float32),
                    faces=np.asarray(faces, np.int32),
                    normals=None if normals is None else np.asarray(normals, np.float32),
                    uvs=None if uvs is None else np.asarray(uvs, np.float32),
                    bsdf=bsdf, emitter=emitter, id=id)


@dataclasses.dataclass
class Instance:
    """A shared-BLAS instance of a shapegroup (instance.cpp). The group's
    meshes are stored once, in instance-local space; `build_scene` builds
    one BLAS per distinct group (by identity) and a TLAS over the
    instances' world boxes, and the traversal enters instance space at
    each instance leaf."""
    group: tuple       # MeshData tuple, shared by identity
    to_world: Optional[np.ndarray] = None   # (4, 4) f32, None = identity
    id: str = ""


def shapegroup(shapes, id: str = "") -> tuple:
    """Named collection of shapes for instancing (shapegroup.cpp): the
    handle `instance()` takes; instances of one handle share one BLAS."""
    return tuple(shapes)


def instance(group, to_world=None, id: str = "", flatten: bool = False):
    """Instance a shapegroup under a transform (instance.cpp): a shared
    `Instance` record, or with `flatten=True` the group's meshes
    transformed to world space (a list of MeshData)."""
    if not flatten:
        return Instance(group=tuple(group),
                        to_world=None if to_world is None
                        else np.asarray(to_world, np.float32).reshape(4, 4),
                        id=id)
    out = []
    for i, m in enumerate(group):
        mi_ = m.transformed(to_world) if to_world is not None else m.copy()
        mi_.id = f"{id}_inst{i}" if id else f"{m.id}_inst{i}"
        out.append(mi_)
    return out
