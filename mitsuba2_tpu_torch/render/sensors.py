"""Camera ray generation (counterpart of render/sensors.py): the
perspective, thin-lens and orthographic cameras, the radiance and
irradiance meters and the distant sensor, and camera motion blur.

Conventions as in the JAX package: `cam_to_world` columns are (left, up,
forward), fov is horizontal, film v runs top to bottom. cam_data holds
[0:2] the thin lens' aperture radius and focus distance, [2:4] the
orthographic extent, [4:8] the scene's bounding sphere (the distant
sensor's), [8:10] the clip planes and [10:12] the shutter interval.
"""
from __future__ import annotations

import torch

from ..core import warp
from ..core.math import promote
from ..core.geometry import Ray, RayDifferential
from ..core.vec import Vec2, Vec3, vnormalize

# the sensors the port renders: all of the JAX package's
SENSORS = ("perspective", "thinlens", "orthographic", "radiancemeter",
           "irradiancemeter", "distant")
# the sensors whose rays need a 2D aperture sample: render_pass draws
# u_lens for them after the hero wavelengths (the JAX package's list)
NEEDS_APERTURE_SAMPLE = ("thinlens", "irradiancemeter")


def _film_to_cam_xy(scene, uv: Vec2):
    """Film uv -> direction components on the z = 1 camera plane."""
    tx = torch.tan(torch.deg2rad(scene.cam_fov_x) * 0.5)
    return (promote(1.0 - 2.0 * uv.x, tx) * tx,
            promote(1.0 - 2.0 * uv.y, tx) * tx)


def _bcast(v: torch.Tensor, like: torch.Tensor) -> Vec3:
    """A 3-vector tensor copied to every lane of `like` (contiguous: the
    traversal kernels take dense ray components)."""
    return Vec3(*(v[i].expand_as(like).contiguous() for i in range(3)))


def _apply(mat, v: Vec3, w: float) -> Vec3:
    """mat (4, 4) applied to v: a point (w = 1) or a vector (w = 0)."""
    v = Vec3(promote(v.x, mat), promote(v.y, mat), promote(v.z, mat))
    out = [mat[r, 0] * v.x + mat[r, 1] * v.y + mat[r, 2] * v.z
           for r in range(3)]
    if w:
        out = [o + mat[r, 3] for r, o in enumerate(out)]
    return Vec3(*out)


def _axis(mat, col: int) -> torch.Tensor:
    """to_world's column `col`, normalized."""
    return mat[:3, col] / torch.linalg.norm(mat[:3, col])


def perspective_ray(scene, uv: Vec2, wavelengths=None, time=None) -> Ray:
    """Film uv in [0,1]^2 -> world-space camera rays, carrying the lanes'
    hero wavelengths in spectral mode. With a keyframed camera
    (scene.cam_motion) and the lanes' shutter times, from the pose at
    each time (camera motion blur)."""
    x, y = _film_to_cam_xy(scene, uv)
    z = torch.ones_like(x)
    if scene.cam_motion is not None and time is not None:
        d = vnormalize(scene.cam_motion.apply_vector(time, Vec3(x, y, z)))
        return Ray.make(scene.cam_motion.translation(time), d,
                        wavelengths=wavelengths, time=time)
    mat = scene.cam_to_world
    d = vnormalize(_apply(mat, Vec3(x, y, z), 0))
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
    d = vnormalize(_apply(mat, vnormalize(p_focus - o_cam), 0))
    return Ray.make(_apply(mat, o_cam, 1), d, wavelengths=wavelengths)


def orthographic_ray(scene, uv: Vec2, wavelengths=None) -> Ray:
    """Orthographic camera (sensors/orthographic.cpp): parallel rays along
    the camera's +z, over the extent cam_data[2:4]."""
    mat = scene.cam_to_world
    x = (1.0 - 2.0 * uv.x) * scene.cam_data[2]
    y = (1.0 - 2.0 * uv.y) * scene.cam_data[3]
    o = _apply(mat, Vec3(x, y, torch.zeros_like(x)), 1)
    return Ray.make(o, _bcast(_axis(mat, 2), x), wavelengths=wavelengths)


def radiancemeter_ray(scene, uv: Vec2, wavelengths=None) -> Ray:
    """Radiance meter (sensors/radiancemeter.cpp): every lane measures the
    radiance along one ray, from to_world's origin along its +z."""
    mat = scene.cam_to_world
    return Ray.make(_bcast(mat[:3, 3], uv.x), _bcast(_axis(mat, 2), uv.x),
                    wavelengths=wavelengths)


def irradiancemeter_ray(scene, uv: Vec2, u_lens, wavelengths=None) -> Ray:
    """Irradiance meter (sensors/irradiancemeter.cpp): the film uv picks a
    point of to_world's unit rectangle and u_lens a cosine-distributed
    direction; the integrator applies the weight pi (scene.cam_weight)."""
    mat = scene.cam_to_world
    o = _apply(mat, Vec3(2.0 * uv.x - 1.0, 2.0 * uv.y - 1.0,
                         torch.zeros_like(uv.x)), 1)
    d = vnormalize(_apply(mat, warp.square_to_cosine_hemisphere(*u_lens), 0))
    return Ray.make(o, d, wavelengths=wavelengths)


def distant_ray(scene, uv: Vec2, wavelengths=None) -> Ray:
    """Distant sensor (sensors/distant.cpp): parallel rays along
    to_world's +z from 2r outside the scene's bounding sphere (centre
    cam_data[4:7], radius cam_data[7]); the film spans its disk."""
    mat = scene.cam_to_world
    c, r = scene.cam_data[4:7], scene.cam_data[7]
    fwd, right, up = _axis(mat, 2), _axis(mat, 0), _axis(mat, 1)
    x = (2.0 * uv.x - 1.0) * r
    y = (2.0 * uv.y - 1.0) * r
    o = Vec3(*(c[i] - fwd[i] * (2.0 * r) + right[i] * x + up[i] * y
               for i in range(3)))
    return Ray.make(o, _bcast(fwd, x), wavelengths=wavelengths)


def _apply_clip(scene, ray: Ray) -> Ray:
    """Near/far clip planes (projective_camera.cpp), measured along the
    normalized camera axis; under a keyframed camera the base pose's
    axis, as in the JAX package."""
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
               wavelengths=ray.wavelengths, time=ray.time)


def sample_ray(scene, uv: Vec2, wavelengths=None, u_lens=None,
               time=None) -> Ray:
    """Sensor::sample_ray, by scene.cam_type: the thin lens and the
    irradiance meter at the aperture sample u_lens, the perspective
    camera under motion at the lanes' shutter times."""
    kind = scene.cam_type
    if kind == "perspective":
        return _apply_clip(scene, perspective_ray(scene, uv, wavelengths,
                                                  time))
    if kind == "thinlens":
        return _apply_clip(scene, thinlens_ray(scene, uv, u_lens,
                                               wavelengths))
    if kind == "orthographic":
        return _apply_clip(scene, orthographic_ray(scene, uv, wavelengths))
    if kind == "radiancemeter":
        return radiancemeter_ray(scene, uv, wavelengths)
    if kind == "irradiancemeter":
        return irradiancemeter_ray(scene, uv, u_lens, wavelengths)
    if kind == "distant":
        return distant_ray(scene, uv, wavelengths)
    raise ValueError(f"unknown sensor type {kind!r}")


# the sensors whose one-pixel film offset has a footprint
HAS_DIFFERENTIALS = ("perspective", "thinlens", "orthographic")


def sample_ray_differential(scene, uv: Vec2, film_width: int,
                            wavelengths=None, u_lens=None,
                            time=None) -> Ray:
    """Sensor::sample_ray_differential (sensor.cpp): the main ray and the
    rays through the film samples one pixel over in x and in y, at the
    same aperture sample and shutter time; film_uv scales both uv axes by
    1 / film_width (square pixels). A sensor without a film footprint
    (the meters, distant) returns the plain ray."""
    main = sample_ray(scene, uv, wavelengths, u_lens, time)
    if scene.cam_type not in HAS_DIFFERENTIALS:
        return main
    duv = 1.0 / film_width
    rx = sample_ray(scene, Vec2(uv.x + duv, uv.y), wavelengths, u_lens, time)
    ry = sample_ray(scene, Vec2(uv.x, uv.y + duv), wavelengths, u_lens, time)
    return RayDifferential(o=main.o, d=main.d, maxt=main.maxt,
                           wavelengths=main.wavelengths, time=main.time,
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
