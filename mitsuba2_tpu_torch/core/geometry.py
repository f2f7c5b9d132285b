"""Rays, frames and host transforms (counterpart of core/geometry.py)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .vec import Vec3, vdot


def coordinate_system(n: Vec3):
    """Orthonormal basis (s, t) around unit n (Duff et al. 2017)."""
    sign = torch.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n.z)
    b = n.x * n.y * a
    s = Vec3(1.0 + sign * n.x * n.x * a, sign * b, -sign * n.x)
    t = Vec3(b, sign + n.y * n.y * a, -n.y)
    return s, t


@dataclasses.dataclass
class Frame:
    """Shading frame; n is the local +z axis."""
    s: Vec3
    t: Vec3
    n: Vec3

    @staticmethod
    def from_n(n: Vec3) -> "Frame":
        s, t = coordinate_system(n)
        return Frame(s=s, t=t, n=n)

    def to_local(self, v: Vec3) -> Vec3:
        return Vec3(vdot(v, self.s), vdot(v, self.t), vdot(v, self.n))

    def to_world(self, v: Vec3) -> Vec3:
        return Vec3(self.s.x * v.x + self.t.x * v.y + self.n.x * v.z,
                    self.s.y * v.x + self.t.y * v.y + self.n.y * v.z,
                    self.s.z * v.x + self.t.z * v.y + self.n.z * v.z)

    @staticmethod
    def cos_theta(v: Vec3):
        return v.z


@dataclasses.dataclass
class Ray:
    """A wavefront of rays: planar o, d and per-lane maxt; in spectral
    mode the lanes' hero wavelengths too (a Spec4, None otherwise)."""
    o: Vec3
    d: Vec3
    maxt: torch.Tensor
    wavelengths: object = None

    @staticmethod
    def make(o: Vec3, d: Vec3, maxt=None, wavelengths=None) -> "Ray":
        if maxt is None:
            maxt = torch.full_like(d.x, float("inf"))
        return Ray(o=o, d=d, maxt=maxt, wavelengths=wavelengths)


@dataclasses.dataclass
class RayDifferential(Ray):
    """A ray with the two offset rays of its pixel footprint
    (include/mitsuba/core/ray.h::RayDifferential): o_x/d_x through the
    film sample one pixel over in x, o_y/d_y one pixel over in y. The
    shading record derives the uv footprint `duv_dx`/`duv_dy` from them
    (texture filtering)."""
    o_x: Vec3 = None
    o_y: Vec3 = None
    d_x: Vec3 = None
    d_y: Vec3 = None

    def scale_differential(self, amount) -> "RayDifferential":
        """ray.h::scale_differential: the offset rays moved toward the
        main ray (amount 1/sqrt(spp): a sample covers 1/spp of a pixel)."""
        return dataclasses.replace(
            self, o_x=self.o + (self.o_x - self.o) * amount,
            o_y=self.o + (self.o_y - self.o) * amount,
            d_x=self.d + (self.d_x - self.d) * amount,
            d_y=self.d + (self.d_y - self.d) * amount)


class Transform4:
    """Host 4x4 affine transform (numpy f32), used to place preset geometry
    and the camera. Same constructors and conventions as the JAX package's
    Transform4 (mitsuba's look_at: columns are left, up, forward)."""

    def __init__(self, matrix):
        self.matrix = np.asarray(matrix, np.float32).reshape(4, 4)

    @staticmethod
    def translate(v) -> "Transform4":
        mat = np.eye(4, dtype=np.float32)
        mat[:3, 3] = np.asarray(v, np.float32)
        return Transform4(mat)

    @staticmethod
    def scale(v) -> "Transform4":
        v = np.broadcast_to(np.asarray(v, np.float32), (3,))
        return Transform4(np.diag(np.concatenate([v, [1.0]]).astype(np.float32)))

    @staticmethod
    def rotate(axis, angle_deg) -> "Transform4":
        axis = np.asarray(axis, np.float64)
        axis = axis / np.linalg.norm(axis)
        th = np.deg2rad(float(angle_deg))
        c, s = np.cos(th), np.sin(th)
        x, y, z = axis
        R = np.array([
            [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s, 0],
            [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s, 0],
            [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c), 0],
            [0, 0, 0, 1]], dtype=np.float32)
        return Transform4(R)

    @staticmethod
    def look_at(origin, target, up) -> "Transform4":
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
        return Transform4(mat)

    def __matmul__(self, other: "Transform4") -> "Transform4":
        return Transform4(self.matrix @ other.matrix)
