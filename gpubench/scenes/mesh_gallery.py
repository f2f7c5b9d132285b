"""The mesh gallery: the port's `presets.mesh_gallery(subdiv, grid)`, a
Cornell-style room holding a grid of displaced icosphere blobs of
20 * 4^subdiv triangles each, the repository's own BVH-bound headline
scene, with its ceiling light as two one-triangle emitters
(_geometry.quad_light).
"""
from __future__ import annotations

import numpy as np

from . import _geometry as g
from .cornell_box import GREEN, LIGHT, RED, WHITE

ALBEDO = [[0.7, 0.3, 0.25], [0.3, 0.55, 0.7], [0.65, 0.6, 0.3],
          [0.5, 0.5, 0.65], [0.35, 0.6, 0.4], [0.6, 0.4, 0.6]]


def build(subdiv: int = 4, grid=(3, 2)) -> dict:
    X, Y, Z = 3.0, 2.0, 3.0
    s = [
        g.quad([0, 0, 0], [0, 0, Z], [X, 0, Z], [X, 0, 0], WHITE, "floor"),
        g.quad([0, Y, 0], [X, Y, 0], [X, Y, Z], [0, Y, Z], WHITE, "ceiling"),
        g.quad([0, 0, Z], [0, Y, Z], [X, Y, Z], [X, 0, Z], WHITE, "back"),
        g.quad([X, 0, 0], [X, 0, Z], [X, Y, Z], [X, Y, 0], RED, "left"),
        g.quad([0, 0, 0], [0, Y, 0], [0, Y, Z], [0, 0, Z], GREEN, "right"),
    ]
    lx0, lx1, lz0, lz1, ly = 1.1, 1.9, 1.2, 1.8, Y - 5e-4
    s += g.quad_light([lx0, ly, lz0], [lx1, ly, lz0], [lx1, ly, lz1],
                      [lx0, ly, lz1], WHITE, LIGHT, "light")
    base_v, faces = g.icosphere(subdiv)
    nx, nz = grid
    k = 0
    for i in range(nx):
        for j in range(nz):
            v = g.displace(base_v.copy(), seed=k)
            cx = (i + 0.5) * X / nx
            cz = (j + 0.75) * Z / (nz + 0.5)
            cy = 0.45 + 0.1 * ((i + j) % 3)
            v = v * 0.34 + np.asarray([cx, cy, cz], np.float32)
            s.append(g.shape(v, faces, ALBEDO[k % 6], f"blob{k}"))
            k += 1
    cam = g.look_at(origin=[X / 2, 1.0, -2.6], target=[X / 2, 0.8, 1.5],
                    up=[0, 1, 0])
    return {"shapes": s, "camera": {"to_world": cam, "fov": 50.0}}
