"""Rays, frames and host transforms (counterpart of core/geometry.py)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import math as m
from .vec import Vec3, vdot, vmax_abs


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
    mode the lanes' hero wavelengths too (a Spec4, None otherwise); under
    a keyframed camera the lanes' shutter times (None otherwise)."""
    o: Vec3
    d: Vec3
    maxt: torch.Tensor
    wavelengths: object = None
    time: object = None

    @staticmethod
    def make(o: Vec3, d: Vec3, maxt=None, wavelengths=None,
             time=None) -> "Ray":
        if maxt is None:
            maxt = torch.full_like(d.x, float("inf"))
        return Ray(o=o, d=d, maxt=maxt, wavelengths=wavelengths, time=time)


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


def spawn_ray(p: Vec3, d: Vec3, n: Vec3 = None, maxt=None, wavelengths=None,
              time=None) -> Ray:
    """A ray from p along d, its origin pushed off the surface along the
    geometric normal n where one is given (Interaction::spawn_ray)."""
    o = p
    if n is not None:
        eps = m.mulsign(m.RAY_EPSILON * (1.0 + vmax_abs(p)), vdot(n, d))
        o = p + n * eps
    return Ray.make(o, d, maxt=maxt, wavelengths=wavelengths, time=time)


def ray_bbox_slab(o, inv_d, bb_min, bb_max, maxt):
    """The slab test (BoundingBox::ray_intersect) on (..., 3) tensors that
    broadcast: (hit, tmin, tmax)."""
    t0 = (bb_min - o) * inv_d
    t1 = (bb_max - o) * inv_d
    tmin = torch.minimum(t0, t1).amax(-1)
    tmax = torch.maximum(t0, t1).amin(-1)
    return (tmin <= tmax) & (tmax >= 0.0) & (tmin <= maxt), tmin, tmax


def sph_dir(theta, phi) -> Vec3:
    """Spherical angles -> unit Vec3 (z up)."""
    st, ct = torch.sin(theta), torch.cos(theta)
    return Vec3(st * torch.cos(phi), st * torch.sin(phi), ct)


def dir_sph(v: Vec3):
    """Unit Vec3 -> (theta, phi)."""
    return m.safe_acos(v.z), torch.atan2(v.y, v.x)


class Transform4:
    """Host 4x4 affine transform (numpy f32), used to place preset geometry
    and the camera. Same constructors and conventions as the JAX package's
    Transform4 (mitsuba's look_at: columns are left, up, forward)."""

    def __init__(self, matrix):
        self.matrix = np.asarray(matrix, np.float32).reshape(4, 4)

    @staticmethod
    def from_matrix(mat) -> "Transform4":
        return Transform4(mat)

    @staticmethod
    def identity() -> "Transform4":
        return Transform4(np.eye(4, dtype=np.float32))

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


# ---------------------------------------------------------------------------
# AnimatedTransform (include/mitsuba/core/transform.h::AnimatedTransform)
# ---------------------------------------------------------------------------

def quat_from_matrix(R) -> np.ndarray:
    """3x3 rotation -> quaternion (x, y, z, w), host float64 (Shepperd)."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = np.array([(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                      (R[1, 0] - R[0, 1]) / s, 0.25 * s])
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[3] = (R[k, j] - R[j, k]) / s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
    return q / np.linalg.norm(q)


def quat_slerp(q0, q1, t) -> torch.Tensor:
    """Slerp of two quaternions (4,) at the times t (...,) -> (..., 4),
    in f32 as the JAX package's device slerp."""
    t = torch.as_tensor(t, dtype=torch.float32)
    q0 = torch.as_tensor(q0, dtype=torch.float32, device=t.device)
    q1 = torch.as_tensor(q1, dtype=torch.float32, device=t.device)
    d = (q0 * q1).sum()
    q1 = torch.where(d < 0, -q1, q1)
    theta = torch.acos(torch.clamp(d.abs(), -1.0, 1.0))
    sin_t = torch.sin(theta)
    small = sin_t < 1e-5
    w0 = torch.where(small, 1.0 - t, torch.sin((1 - t) * theta)
                     / torch.clamp_min(sin_t, 1e-9))
    w1 = torch.where(small, t, torch.sin(t * theta)
                     / torch.clamp_min(sin_t, 1e-9))
    q = w0[..., None] * q0 + w1[..., None] * q1
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_rotate(q: torch.Tensor, v: Vec3) -> Vec3:
    """v rotated by the per-lane quaternions q (..., 4):
    v' = v + 2 q_xyz x (q_xyz x v + w v)."""
    qx, qy, qz, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    tx = 2.0 * (qy * v.z - qz * v.y)
    ty = 2.0 * (qz * v.x - qx * v.z)
    tz = 2.0 * (qx * v.y - qy * v.x)
    return Vec3(v.x + qw * tx + (qy * tz - qz * ty),
                v.y + qw * ty + (qz * tx - qx * tz),
                v.z + qw * tz + (qx * ty - qy * tx))


# the host tables of an AnimatedTransform, under the JAX package's names
ANIM_FIELDS = ("times", "trans", "quats", "scales")


@dataclasses.dataclass
class AnimatedTransform:
    """A keyframed affine transform: each key decomposed on the host into
    a translation, a rotation quaternion and a 3x3 scale/shear (polar
    decomposition, transform_compose(M) = T * R * S); a time lerps the
    translation and scale and slerps the rotation between the keys around
    it."""
    times: torch.Tensor   # (K,)
    trans: torch.Tensor   # (K, 3)
    quats: torch.Tensor   # (K, 4) x, y, z, w
    scales: torch.Tensor  # (K, 3, 3)

    @staticmethod
    def decompose(times, matrices) -> dict:
        """The keys' f32 tables (ANIM_FIELDS), as numpy: the JAX
        package's float64 SVD polar decomposition, a proper rotation,
        each quaternion in its predecessor's hemisphere."""
        tr, qu, sc = [], [], []
        for mat in matrices:
            mat = np.asarray(mat, np.float64).reshape(4, 4)
            U, S, Vt = np.linalg.svd(mat[:3, :3])
            R = U @ Vt
            if np.linalg.det(R) < 0:  # keep a proper rotation
                U = U.copy()
                U[:, -1] *= -1
                S = S.copy()
                S[-1] *= -1
                R = U @ Vt
            tr.append(mat[:3, 3])
            qu.append(quat_from_matrix(R))
            sc.append(Vt.T @ np.diag(S) @ Vt)
        for i in range(1, len(qu)):
            if np.dot(qu[i - 1], qu[i]) < 0:
                qu[i] = -qu[i]
        return dict(times=np.asarray(times, np.float32),
                    trans=np.stack(tr).astype(np.float32),
                    quats=np.stack(qu).astype(np.float32),
                    scales=np.stack(sc).astype(np.float32))

    @staticmethod
    def from_numpy(tables: dict, device) -> "AnimatedTransform":
        return AnimatedTransform(**{
            k: torch.from_numpy(np.array(tables[k], np.float32)).to(device)
            for k in ANIM_FIELDS})

    @staticmethod
    def from_keys(times, matrices, device) -> "AnimatedTransform":
        return AnimatedTransform.from_numpy(
            AnimatedTransform.decompose(times, matrices), device)

    def to(self, device) -> "AnimatedTransform":
        return AnimatedTransform(*(getattr(self, k).to(device)
                                   for k in ANIM_FIELDS))

    def interp(self, t: torch.Tensor):
        """Per-lane (translation (..., 3), quaternion (..., 4), scale
        (..., 3, 3)) at the times t (...)."""
        K = self.times.shape[0]
        sh = t.shape
        if K == 1:
            return (self.trans[0].expand(sh + (3,)),
                    self.quats[0].expand(sh + (4,)),
                    self.scales[0].expand(sh + (3, 3)))
        i1 = torch.ones(sh, dtype=torch.int64, device=t.device)
        for k in range(2, K):
            i1 = torch.where(t >= self.times[k - 1], k, i1)
        i0 = i1 - 1
        t0, t1 = self.times[i0], self.times[i1]
        f = torch.clamp((t - t0) / torch.clamp_min(t1 - t0, 1e-9), 0.0, 1.0)
        tr = self.trans[i0] * (1 - f)[..., None] + self.trans[i1] * f[..., None]
        sc = (self.scales[i0] * (1 - f)[..., None, None]
              + self.scales[i1] * f[..., None, None])
        q0, q1 = self.quats[i0], self.quats[i1]
        d = torch.sum(q0 * q1, -1, keepdim=True)
        q1 = torch.where(d < 0, -q1, q1)
        theta = torch.acos(torch.clamp(torch.abs(d[..., 0]), 0.0, 1.0))
        sin_t = torch.sin(theta)
        small = sin_t < 1e-5
        inv = torch.clamp_min(sin_t, 1e-9)
        w0 = torch.where(small, 1 - f, torch.sin((1 - f) * theta) / inv)
        w1 = torch.where(small, f, torch.sin(f * theta) / inv)
        q = w0[..., None] * q0 + w1[..., None] * q1
        q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
        return tr, q, sc

    def apply_vector(self, t, v: Vec3) -> Vec3:
        _, q, sc = self.interp(t)
        return quat_rotate(q, Vec3(
            sc[..., 0, 0] * v.x + sc[..., 0, 1] * v.y + sc[..., 0, 2] * v.z,
            sc[..., 1, 0] * v.x + sc[..., 1, 1] * v.y + sc[..., 1, 2] * v.z,
            sc[..., 2, 0] * v.x + sc[..., 2, 1] * v.y + sc[..., 2, 2] * v.z))

    def apply_point(self, t, p: Vec3) -> Vec3:
        tr = self.interp(t)[0]
        r = self.apply_vector(t, p)
        return Vec3(r.x + tr[..., 0], r.y + tr[..., 1], r.z + tr[..., 2])

    def translation(self, t) -> Vec3:
        tr = self.interp(t)[0]
        return Vec3(tr[..., 0], tr[..., 1], tr[..., 2])
