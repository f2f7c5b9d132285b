"""Perspective camera ray generation (counterpart of render/sensors.py).

Conventions as in the JAX package: `cam_to_world` columns are (left, up,
forward), fov is horizontal, film v runs top to bottom.
"""
from __future__ import annotations

import torch

from ..core.geometry import Ray, RayDifferential
from ..core.vec import Vec2, Vec3, vnormalize


def perspective_ray(scene, uv: Vec2, wavelengths=None) -> Ray:
    """Film uv in [0,1]^2 -> world-space camera rays, carrying the lanes'
    hero wavelengths in spectral mode."""
    tx = torch.tan(torch.deg2rad(scene.cam_fov_x) * 0.5)
    x = (1.0 - 2.0 * uv.x) * tx
    y = (1.0 - 2.0 * uv.y) * tx
    z = torch.ones_like(x)
    mat = scene.cam_to_world
    d = vnormalize(Vec3(mat[0, 0] * x + mat[0, 1] * y + mat[0, 2] * z,
                        mat[1, 0] * x + mat[1, 1] * y + mat[1, 2] * z,
                        mat[2, 0] * x + mat[2, 1] * y + mat[2, 2] * z))
    o = Vec3(mat[0, 3].expand_as(x), mat[1, 3].expand_as(x),
             mat[2, 3].expand_as(x))
    return Ray.make(o, d, wavelengths=wavelengths)


def _apply_clip(scene, ray: Ray) -> Ray:
    """Near/far clip planes (projective_camera.cpp), measured along the
    normalized camera axis."""
    near, far = scene.cam_data[8], scene.cam_data[9]
    fx, fy, fz = (scene.cam_to_world[0, 2], scene.cam_to_world[1, 2],
                  scene.cam_to_world[2, 2])
    fn = torch.sqrt(fx * fx + fy * fy + fz * fz)
    fx, fy, fz = fx / fn, fy / fn, fz / fn
    cos_z = torch.clamp_min(ray.d.x * fx + ray.d.y * fy + ray.d.z * fz, 1e-6)
    near_t = near / cos_z
    o = Vec3(ray.o.x + ray.d.x * near_t, ray.o.y + ray.d.y * near_t,
             ray.o.z + ray.d.z * near_t)
    return Ray(o=o, d=ray.d,
               maxt=torch.minimum(ray.maxt, (far - near) / cos_z),
               wavelengths=ray.wavelengths)


def sample_ray(scene, uv: Vec2, wavelengths=None) -> Ray:
    """Sensor::sample_ray for the perspective camera."""
    if scene.cam_type != "perspective":
        raise NotImplementedError(
            f"mitsuba2_tpu_torch does not support {scene.cam_type!r} "
            "sensors yet")
    return _apply_clip(scene, perspective_ray(scene, uv, wavelengths))


# the sensors whose one-pixel film offset has a footprint (the JAX
# package's list; the port builds the perspective camera alone)
HAS_DIFFERENTIALS = ("perspective", "thinlens", "orthographic")


def sample_ray_differential(scene, uv: Vec2, film_width: int,
                            wavelengths=None) -> RayDifferential:
    """Sensor::sample_ray_differential (sensor.cpp): the main ray and the
    rays through the film samples one pixel over in x and in y; film_uv
    scales both uv axes by 1 / film_width (square pixels)."""
    main = sample_ray(scene, uv, wavelengths)
    duv = 1.0 / film_width
    rx = sample_ray(scene, Vec2(uv.x + duv, uv.y), wavelengths)
    ry = sample_ray(scene, Vec2(uv.x, uv.y + duv), wavelengths)
    return RayDifferential(o=main.o, d=main.d, maxt=main.maxt,
                           wavelengths=main.wavelengths,
                           o_x=rx.o, o_y=ry.o, d_x=rx.d, d_y=ry.d)


def film_uv(x, y, jitter, width: int, height: int,
            crop=(0, 0, None, None)) -> Vec2:
    """Pixel indices + jitter -> uv (u in [0,1], v at the same scale)."""
    jx, jy = jitter
    cx, cy, fw, fh = crop
    fw = fw or width
    fh = fh or height
    u = (x + cx + jx) / fw
    v = (y + cy + jy) / fw * 1.0
    v = v + 0.5 * (1.0 - fh / fw)
    return Vec2(u, v)
