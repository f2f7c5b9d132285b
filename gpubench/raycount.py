"""The work of a frame, fixed by the traffic's shapes: the counted rays
and the bytes a ray traversal cannot do without. Frozen here, so that no
change to the program moves the yardstick.

Counted rays (bench.py's `_rays_per_pass`): a lane traces its camera
ray, then at each of its max_depth - 1 bounces a shadow ray and a
continuation ray, whether or not it is still alive. A gradient step
counts a pass twice: the render and its adjoint.
"""
from __future__ import annotations

# bytes a lane of a traversal reads and writes: its ray (o, d: six
# float32, t_max: one), and its answer: a closest hit's t, prim, u, v
# (four 32-bit words), an any hit's flag (one byte)
RAY_IN_BYTES = 7 * 4
CLOSEST_OUT_BYTES = 4 * 4
ANY_OUT_BYTES = 1
# a triangle as the walks need it: a vertex and two edges, nine float32
PRIM_BYTES = 9 * 4


def lanes_per_pass(t: dict) -> int:
    return t["width"] * t["height"] * t["spp_per_pass"]


def passes(t: dict) -> int:
    return -(-t["spp"] // t["spp_per_pass"])


def rays_per_pass(t: dict) -> int:
    return lanes_per_pass(t) * (1 + 2 * (t["max_depth"] - 1))


def rays_per_frame(t: dict) -> int:
    """Counted rays of one frame: an image, or a gradient step (twice)."""
    n = rays_per_pass(t) * passes(t)
    return 2 * n if t["entry"] == "grad_step" else n


def traversal_launches(t: dict) -> tuple:
    """(closest-hit, any-hit) traversals of a frame's wavefronts: a pass
    casts max_depth closest-hit and max_depth - 1 any-hit wavefronts; the
    adjoint's replay casts them again."""
    k = passes(t) * (2 if t["entry"] == "grad_step" else 1)
    return k * t["max_depth"], k * (t["max_depth"] - 1)


def walk_bytes(t: dict, n_prims: int) -> int:
    """Bytes a frame's traversals must move at least: each wavefront's
    rays read once and its answers written once, and the scene's
    triangles read once a wavefront."""
    n = lanes_per_pass(t)
    closest, any_ = traversal_launches(t)
    return (closest * (n * (RAY_IN_BYTES + CLOSEST_OUT_BYTES)
                       + n_prims * PRIM_BYTES)
            + any_ * (n * (RAY_IN_BYTES + ANY_OUT_BYTES)
                      + n_prims * PRIM_BYTES))
