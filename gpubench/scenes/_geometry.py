"""Host geometry of the benchmark's scenes, in numpy float32.

A frozen copy of the arithmetic that places the port's preset geometry
(affine transforms, look-at cameras, quads, cubes, displaced icospheres),
so that the benchmark makes its scenes itself and hands the same arrays
to the program and to the plain reference. A scene is a dict:

    shapes:  [{"id", "vertices" (V, 3) f32, "faces" (F, 3) i32,
               "normals" (V, 3) f32 or None, "uvs" (V, 2) f32 or None,
               "reflectance" [r, g, b], "radiance" [r, g, b] or None}, ...]
    camera:  {"to_world": (4, 4) f32, "fov": horizontal degrees}

Every material is diffuse; a shape with a radiance is an area emitter.
"""
from __future__ import annotations

import numpy as np


def translate(v):
    mat = np.eye(4, dtype=np.float32)
    mat[:3, 3] = np.asarray(v, np.float32)
    return mat


def scale(v):
    v = np.broadcast_to(np.asarray(v, np.float32), (3,))
    return np.diag(np.concatenate([v, [1.0]]).astype(np.float32))


def rotate(axis, angle_deg):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    th = np.deg2rad(float(angle_deg))
    c, s = np.cos(th), np.sin(th)
    x, y, z = axis
    return np.array([
        [c + x * x * (1 - c), x * y * (1 - c) - z * s,
         x * z * (1 - c) + y * s, 0],
        [y * x * (1 - c) + z * s, c + y * y * (1 - c),
         y * z * (1 - c) - x * s, 0],
        [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s,
         c + z * z * (1 - c), 0],
        [0, 0, 0, 1]], dtype=np.float32)


def look_at(origin, target, up):
    """Camera to world: columns left, up, forward, origin."""
    origin = np.asarray(origin, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    dirv = target - origin
    dirv = dirv / np.linalg.norm(dirv)
    left = np.cross(up / np.linalg.norm(up), dirv)
    left = left / np.linalg.norm(left)
    new_up = np.cross(dirv, left)
    mat = np.eye(4, dtype=np.float32)
    mat[:3, 0] = left
    mat[:3, 1] = new_up
    mat[:3, 2] = dirv
    mat[:3, 3] = origin
    return mat


def shape(vertices, faces, reflectance, id, normals=None, uvs=None,
          radiance=None):
    return {"id": id, "vertices": np.asarray(vertices, np.float32),
            "faces": np.asarray(faces, np.int32),
            "normals": None if normals is None else np.asarray(normals,
                                                               np.float32),
            "uvs": None if uvs is None else np.asarray(uvs, np.float32),
            "reflectance": [float(c) for c in reflectance],
            "radiance": None if radiance is None else [float(c)
                                                       for c in radiance]}


_QUAD_UV = [[0, 0], [1, 0], [1, 1], [0, 1]]


def quad(p00, p10, p11, p01, reflectance, id):
    """Two triangles, (0, 1, 2) and (0, 2, 3); the normal follows the
    counter-clockwise winding."""
    return shape([p00, p10, p11, p01], [[0, 1, 2], [0, 2, 3]], reflectance,
                 id, uvs=_QUAD_UV)


def quad_light(p00, p10, p11, p01, reflectance, radiance, id):
    """An emitting quad as two one-triangle emitters, `id`_a and `id`_b:
    the quad's two triangles, each picked with probability 1/2 and
    sampled uniformly, which is the distribution of one two-triangle
    emitter of equal halves. A one-triangle emitter leaves no choice of
    triangle to the program's own ordering of its prims."""
    v = [p00, p10, p11, p01]
    return [shape([v[0], v[1], v[2]], [[0, 1, 2]], reflectance, id + "_a",
                  uvs=[_QUAD_UV[0], _QUAD_UV[1], _QUAD_UV[2]],
                  radiance=radiance),
            shape([v[0], v[2], v[3]], [[0, 1, 2]], reflectance, id + "_b",
                  uvs=[_QUAD_UV[0], _QUAD_UV[2], _QUAD_UV[3]],
                  radiance=radiance)]


_CUBE_QUADS = [
    ([(-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1)], (0, 0, 1)),
    ([(-1, -1, -1), (-1, 1, -1), (1, 1, -1), (1, -1, -1)], (0, 0, -1)),
    ([(1, -1, -1), (1, 1, -1), (1, 1, 1), (1, -1, 1)], (1, 0, 0)),
    ([(-1, -1, -1), (-1, -1, 1), (-1, 1, 1), (-1, 1, -1)], (-1, 0, 0)),
    ([(-1, 1, -1), (-1, 1, 1), (1, 1, 1), (1, 1, -1)], (0, 1, 0)),
    ([(-1, -1, -1), (1, -1, -1), (1, -1, 1), (-1, -1, 1)], (0, -1, 0)),
]


def cube(to_world, reflectance, id):
    """The cube [-1, 1]^3 with outward vertex normals, transformed."""
    verts, faces, normals, uvs = [], [], [], []
    for q, n in _CUBE_QUADS:
        base = len(verts)
        verts.extend(q)
        normals.extend([n] * 4)
        uvs.extend(_QUAD_UV)
        faces.append([base, base + 1, base + 2])
        faces.append([base, base + 2, base + 3])
    verts = np.asarray(verts, np.float32)
    normals = np.asarray(normals, np.float32)
    mat = np.asarray(to_world, np.float32).reshape(4, 4)
    v = (verts @ mat[:3, :3].T + mat[:3, 3]).astype(np.float32)
    inv_t = np.linalg.inv(mat[:3, :3]).T
    n = normals @ inv_t.T
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    return shape(v, faces, reflectance, id, normals=n.astype(np.float32),
                 uvs=uvs)


def icosphere(subdiv: int):
    """Unit icosphere, 20 * 4^subdiv triangles (midpoint subdivision)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.asarray([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.asarray([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(subdiv):
        vlist = list(verts)
        cache = {}

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = 0.5 * (vlist[a] + vlist[b])
                m /= np.linalg.norm(m)
                cache[key] = len(vlist)
                vlist.append(m)
            return cache[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, np.int64)
    return verts.astype(np.float32), faces.astype(np.int32)


def displace(verts, seed: int, amp: float = 0.22):
    """A smooth deterministic radial displacement (a lumpy blob)."""
    x, y, z = verts[:, 0], verts[:, 1], verts[:, 2]
    s = float(seed)
    bump = (np.sin(4.1 * x + 1.3 * s) * np.sin(3.7 * y + 0.7 * s)
            + 0.6 * np.sin(5.3 * z + 2.1 * s) * np.sin(2.9 * x - s)
            + 0.4 * np.sin(7.1 * y + 0.5 * s))
    r = 1.0 + amp * bump / 2.0
    return verts * r[:, None].astype(np.float32)
