"""Camera ray generation, the perspective and thin-lens cameras
(counterpart of render/sensors.py).

Conventions as in the JAX package: `cam_to_world` columns are (left, up,
forward), fov is horizontal, film v runs top to bottom; cam_data[0:2]
holds the thin lens' aperture radius and focus distance.
"""
from __future__ import annotations

import torch

from ..core import warp
from ..core.geometry import Ray, RayDifferential
from ..core.vec import Vec2, Vec3, vnormalize

# the sensors the port renders
SENSORS = ("perspective", "thinlens")
# the sensors whose rays need a 2D aperture sample: render_pass draws
# u_lens for them after the hero wavelengths (the JAX package's list)
NEEDS_APERTURE_SAMPLE = ("thinlens", "irradiancemeter")


def _film_to_cam_xy(scene, uv: Vec2):
    """Film uv -> direction components on the z = 1 camera plane."""
    tx = torch.tan(torch.deg2rad(scene.cam_fov_x) * 0.5)
    return (1.0 - 2.0 * uv.x) * tx, (1.0 - 2.0 * uv.y) * tx


def perspective_ray(scene, uv: Vec2, wavelengths=None) -> Ray:
    """Film uv in [0,1]^2 -> world-space camera rays, carrying the lanes'
    hero wavelengths in spectral mode."""
    x, y = _film_to_cam_xy(scene, uv)
    z = torch.ones_like(x)
    mat = scene.cam_to_world
    d = vnormalize(Vec3(mat[0, 0] * x + mat[0, 1] * y + mat[0, 2] * z,
                        mat[1, 0] * x + mat[1, 1] * y + mat[1, 2] * z,
                        mat[2, 0] * x + mat[2, 1] * y + mat[2, 2] * z))
    o = Vec3(mat[0, 3].expand_as(x), mat[1, 3].expand_as(x),
             mat[2, 3].expand_as(x))
    return Ray.make(o, d, wavelengths=wavelengths)


def thinlens_ray(scene, uv: Vec2, u_lens, wavelengths=None) -> Ray:
    """Thin-lens camera (sensors/thinlens.cpp): the origin on the
    aperture disk at the lanes' sample u_lens (a (ua, ub) pair), the rays
    through the point of the focus plane the film sample sees."""
    mat = scene.cam_to_world
    aperture, focus = scene.cam_data[0], scene.cam_data[1]
    x, y = _film_to_cam_xy(scene, uv)
    p_focus = Vec3(x * focus, y * focus, focus.expand_as(x))
    lx, ly = warp.square_to_uniform_disk_concentric(*u_lens)
    o_cam = Vec3(lx * aperture, ly * aperture, torch.zeros_like(lx))
    d_cam = vnormalize(p_focus - o_cam)
    d = vnormalize(Vec3(
        mat[0, 0] * d_cam.x + mat[0, 1] * d_cam.y + mat[0, 2] * d_cam.z,
        mat[1, 0] * d_cam.x + mat[1, 1] * d_cam.y + mat[1, 2] * d_cam.z,
        mat[2, 0] * d_cam.x + mat[2, 1] * d_cam.y + mat[2, 2] * d_cam.z))
    o = Vec3(
        mat[0, 0] * o_cam.x + mat[0, 1] * o_cam.y + mat[0, 2] * o_cam.z
        + mat[0, 3],
        mat[1, 0] * o_cam.x + mat[1, 1] * o_cam.y + mat[1, 2] * o_cam.z
        + mat[1, 3],
        mat[2, 0] * o_cam.x + mat[2, 1] * o_cam.y + mat[2, 2] * o_cam.z
        + mat[2, 3])
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


def sample_ray(scene, uv: Vec2, wavelengths=None, u_lens=None) -> Ray:
    """Sensor::sample_ray for the perspective and thin-lens cameras (the
    latter at the aperture sample u_lens)."""
    if scene.cam_type == "perspective":
        return _apply_clip(scene, perspective_ray(scene, uv, wavelengths))
    if scene.cam_type == "thinlens":
        return _apply_clip(scene, thinlens_ray(scene, uv, u_lens,
                                               wavelengths))
    raise NotImplementedError(
        f"mitsuba2_tpu_torch does not support {scene.cam_type!r} "
        "sensors yet")


# the sensors whose one-pixel film offset has a footprint (the JAX
# package's list; the port builds the perspective and thin-lens cameras)
HAS_DIFFERENTIALS = ("perspective", "thinlens", "orthographic")


def sample_ray_differential(scene, uv: Vec2, film_width: int,
                            wavelengths=None, u_lens=None) -> RayDifferential:
    """Sensor::sample_ray_differential (sensor.cpp): the main ray and the
    rays through the film samples one pixel over in x and in y, at the
    same aperture sample; film_uv scales both uv axes by 1 / film_width
    (square pixels)."""
    main = sample_ray(scene, uv, wavelengths, u_lens)
    duv = 1.0 / film_width
    rx = sample_ray(scene, Vec2(uv.x + duv, uv.y), wavelengths, u_lens)
    ry = sample_ray(scene, Vec2(uv.x, uv.y + duv), wavelengths, u_lens)
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
