"""The sensors and camera motion blur of the PyTorch port against the JAX
package: render/sensors.py, core/geometry.py's AnimatedTransform and
the build's camera tables, on chip_smoke.py's variants-phase sensors
around mesh_gallery(subdiv=1) (chip_smoke.gallery_sensor).

Tolerances:
- the scene tables of every sensor and of a keyframed camera: byte-equal
  (cam_to_world, cam_data, cam_weight and the keys' times, translations,
  quaternions and scales among them);
- each sensor's rays (sample_ray, sample_ray_differential) at the same
  uv, aperture sample and shutter time: within 1e-6 (the keyframed
  camera's per-lane slerp takes arccos and sin, which torch and XLA round
  apart by ulps); the irradiance meter's directions within 1e-6 / cos
  theta: its cosine warp lifts the disk point to z = sqrt(1 - r^2), which
  carries r^2's rounding divided by z, and the disk point's sin and cos
  round apart by an ulp;
- AnimatedTransform's interpolation: within 1e-6; tests/test_animated_
  transform.py's cases at theirs;
- 8x8 renders of each sensor's scene against the JAX package's images
  (tests/goldens/test_torch_sensors.npz): every pixel within rtol 1e-4 /
  atol 1e-5.
"""
import numpy as np
import pytest
import torch

import chip_smoke
import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.core.geometry import AnimatedTransform, Transform4
from mitsuba2_tpu_torch.core.vec import Vec2, Vec3
from mitsuba2_tpu_torch.render import sensors
from mitsuba2_tpu_torch.scene import presets as tpresets

from goldens.jax_refs import Refs
from test_torch_instancing import assert_port_tables, jax_fields, \
    recorded_fields

# one intra-op thread: the suite's test processes share the cores
# (pytest-xdist), and torch's OpenMP regions stall when they
# oversubscribe them
torch.set_num_threads(1)

REFS = Refs("test_torch_sensors")
KINDS = ("orthographic", "distant", "radiancemeter", "irradiancemeter",
         "motion")
RENDER = dict(width=8, height=8, spp=4, spp_per_pass=4, max_depth=3,
              rr_depth=2)
N = 512


def _jax_gallery_shapes(subdiv):
    """mesh_gallery(subdiv)'s shapes (the same room, light, seeds and
    placement) and its camera's to_world from the JAX package's presets,
    which build the gallery whole; the port's presets.mesh_gallery_shapes
    counterpart, which test_tables_byte_equal holds it to."""
    from mitsuba2_tpu.scene import presets as P
    X, Y, Z = 3.0, 2.0, 3.0
    white = {"type": "diffuse", "reflectance": P.WHITE}
    s = [
        P._quad([0, 0, 0], [0, 0, Z], [X, 0, Z], [X, 0, 0], bsdf=white,
                id="floor"),
        P._quad([0, Y, 0], [X, Y, 0], [X, Y, Z], [0, Y, Z], bsdf=white,
                id="ceiling"),
        P._quad([0, 0, Z], [0, Y, Z], [X, Y, Z], [X, 0, Z], bsdf=white,
                id="back"),
        P._quad([X, 0, 0], [X, 0, Z], [X, Y, Z], [X, Y, 0],
                bsdf={"type": "diffuse", "reflectance": P.RED}, id="left"),
        P._quad([0, 0, 0], [0, Y, 0], [0, Y, Z], [0, 0, Z],
                bsdf={"type": "diffuse", "reflectance": P.GREEN},
                id="right"),
        P._quad([1.1, Y - 5e-4, 1.2], [1.9, Y - 5e-4, 1.2],
                [1.9, Y - 5e-4, 1.8], [1.1, Y - 5e-4, 1.8], bsdf=white,
                emitter={"type": "area", "radiance": P.LIGHT}, id="light")]
    base_v, faces = P._icosphere(subdiv)
    for k in range(6):
        i, j = divmod(k, 2)
        v = P._displace(base_v.copy(), seed=k)
        v = v * 0.34 + np.asarray([(i + 0.5) * X / 3,
                                   0.45 + 0.1 * ((i + j) % 3),
                                   (j + 0.75) * Z / 2.5], np.float32)
        s.append(P.shapes.mesh(v, faces, bsdf={
            "type": "diffuse", "reflectance": chip_smoke.GALLERY_ALBEDO[k]},
            id=f"blob{k}"))
    cam = P.Transform4.look_at(origin=[X / 2, 1.0, -2.6],
                               target=[X / 2, 0.8, 1.5], up=[0, 1, 0])
    return s, np.asarray(cam.matrix)


def _gallery_scene(kind, port):
    """mesh_gallery(subdiv=1) seen by `kind`: a variants-phase sensor
    (chip_smoke.variant_sensor), the gallery's own perspective camera or a
    thin lens at it; the port's on the CPU, else the JAX package's."""
    from mitsuba2_tpu.scene import presets as jpresets
    if port and kind in KINDS:
        return chip_smoke.gallery_sensor(kind, 1, device="cpu")
    P, kw = (tpresets, {"device": "cpu"}) if port else (jpresets, {})
    if port:
        s, sensor = tpresets.mesh_gallery_shapes(1)
        cam = np.asarray(sensor["to_world"])
    else:
        s, cam = _jax_gallery_shapes(1)
    if kind in KINDS:
        return P.build_scene(s, chip_smoke.variant_sensor(P, kind, cam),
                             **kw)
    sensor = {"type": kind, "to_world": cam, "fov": 50.0}
    if kind == "thinlens":
        sensor.update(aperture_radius=0.05, focus_distance=2.5)
    return P.build_scene(s, sensor, **kw)


@pytest.fixture(scope="module")
def scenes():
    """Each kind's scene from both packages (subdiv 1), the port's tables
    recorded at its build; the gallery's own camera, and a thin lens."""
    out = {}
    for kind in KINDS + ("perspective", "thinlens"):
        with recorded_fields() as got:
            st = _gallery_scene(kind, port=True)
        out[kind] = (_gallery_scene(kind, port=False), st, got[0])
    return out


@pytest.mark.parametrize("kind", KINDS + ("perspective", "thinlens"))
def test_tables_byte_equal(scenes, kind):
    sj, st, fields = scenes[kind]
    assert_port_tables(jax_fields(sj), fields, st)
    assert st.cam_type == sj.cam_type
    assert np.asarray(sj.cam_weight).tobytes() == st.cam_weight.numpy(
        ).tobytes()
    assert (st.cam_motion is None) == (sj.cam_motion is None)
    if kind == "motion":
        for k in ("times", "trans", "quats", "scales"):
            a = np.asarray(getattr(sj.cam_motion, k))
            b = getattr(st.cam_motion, k).numpy()
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    if kind == "orthographic":
        # the extent in cam_data[2:4], to_world's first columns normalized
        assert np.allclose(st.cam_data[2:4].numpy(), 1.6)
        assert np.allclose(np.linalg.norm(st.cam_to_world[:3, :2].numpy(),
                                          axis=0), 1.0)


def _lanes(seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((5, N)).astype(np.float32)


@pytest.mark.parametrize("kind", KINDS + ("perspective", "thinlens"))
def test_rays_match_jax(scenes, kind):
    """sample_ray and sample_ray_differential at the same uv, aperture
    sample and (under motion) shutter time."""
    import jax.numpy as jnp
    from mitsuba2_tpu.core.vec import Vec2 as JVec2
    from mitsuba2_tpu.render import sensors as jsensors
    sj, st, _ = scenes[kind]
    u = _lanes()
    uv_t = Vec2(torch.from_numpy(u[0]), torch.from_numpy(u[1]))
    uv_j = JVec2(jnp.asarray(u[0]), jnp.asarray(u[1]))
    lens_t = (torch.from_numpy(u[2]), torch.from_numpy(u[3]))
    lens_j = (jnp.asarray(u[2]), jnp.asarray(u[3]))
    time = u[4] if kind == "motion" else None
    t_t = None if time is None else torch.from_numpy(time)
    t_j = None if time is None else jnp.asarray(time)
    rt = sensors.sample_ray_differential(st, uv_t, 8, u_lens=lens_t,
                                         time=t_t)
    rj = jsensors.sample_ray_differential(sj, uv_j, lens_j, 8, time=t_j)
    fields = ["o", "d"]
    if kind in sensors.HAS_DIFFERENTIALS or kind == "motion":
        fields += ["o_x", "o_y", "d_x", "d_y"]
    else:
        assert not hasattr(rt, "o_x")
    tol = 1e-6
    if kind == "irradiancemeter":
        from mitsuba2_tpu_torch.core import warp
        cos = warp.square_to_cosine_hemisphere(*lens_t).z.numpy()
        tol = 1e-6 / np.maximum(cos, 1e-3)
    for f in fields:
        for c in "xyz":
            got = getattr(getattr(rt, f), c).numpy()
            want = np.asarray(getattr(getattr(rj, f), c))
            assert (np.abs(got - want) <= tol * np.maximum(1, np.abs(want))
                    ).all(), (f + c, np.abs(got - want).max())
    np.testing.assert_allclose(rt.maxt.numpy(), np.asarray(rj.maxt),
                               rtol=1e-6)
    plain = sensors.sample_ray(st, uv_t, u_lens=lens_t, time=t_t)
    assert torch.equal(plain.d.x, rt.d.x) and torch.equal(plain.o.z, rt.o.z)
    if kind == "radiancemeter":
        # every lane along the one ray
        assert bool((rt.d.x == rt.d.x[0]).all() & (rt.o.y == rt.o.y[0]).all())
    if kind in ("orthographic", "distant"):
        # parallel rays
        assert bool((rt.d.z == rt.d.z[0]).all())
    if kind == "motion":
        assert torch.equal(rt.time, t_t)


def test_motion_pose_at_the_keys(scenes):
    """At t = 0 a keyframed camera's rays are its first key's: the static
    camera's, which a build takes from that key."""
    sj, st, _ = scenes["motion"]
    u = _lanes(1)
    uv = Vec2(torch.from_numpy(u[0]), torch.from_numpy(u[1]))
    moving = sensors.sample_ray(st, uv, time=torch.zeros(N))
    static = sensors.sample_ray(st, uv)
    for f in ("o", "d"):
        for c in "xyz":
            np.testing.assert_allclose(getattr(getattr(moving, f), c),
                                       getattr(getattr(static, f), c),
                                       atol=2e-6)


KEYS = [(Transform4.translate([1, 2, 3]) @ Transform4.rotate([0, 1, 0], 30.0)
         @ Transform4.scale([2.0, 1.0, 0.5])).matrix,
        (Transform4.translate([-1, 0, 2])
         @ Transform4.rotate([1, 1, 0], -50.0)).matrix,
        (Transform4.rotate([0, 0, 1], 170.0)
         @ Transform4.scale([1.0, -1.0, 1.0])).matrix]


def test_animated_transform_matches_jax():
    """Three keys (a scale, a shear-free rotation, a reflection kept a
    proper rotation), times inside, between and outside the keys."""
    import jax.numpy as jnp
    from mitsuba2_tpu.core.geometry import AnimatedTransform as JAT
    from mitsuba2_tpu.core.vec import Vec3 as JVec3
    times = [0.0, 0.4, 1.0]
    aj = JAT.from_keys(times, KEYS)
    at = AnimatedTransform.from_keys(times, KEYS, "cpu")
    for k in ("times", "trans", "quats", "scales"):
        assert np.asarray(getattr(aj, k)).tobytes() == \
            getattr(at, k).numpy().tobytes(), k
    rng = np.random.default_rng(3)
    t = np.concatenate([[-0.5, 0.0, 0.4, 1.0, 1.5],
                        rng.random(200)]).astype(np.float32)
    v = rng.normal(size=(3, t.size)).astype(np.float32)
    for fn in ("apply_vector", "apply_point"):
        got = getattr(at, fn)(torch.from_numpy(t),
                              Vec3(*map(torch.from_numpy, v)))
        want = getattr(aj, fn)(jnp.asarray(t), JVec3(*map(jnp.asarray, v)))
        for c in "xyz":
            np.testing.assert_allclose(getattr(got, c).numpy(),
                                       np.asarray(getattr(want, c)),
                                       rtol=1e-6, atol=1e-6)
    tr_t = at.translation(torch.from_numpy(t))
    tr_j = aj.translation(jnp.asarray(t))
    np.testing.assert_allclose(tr_t.x.numpy(), np.asarray(tr_j.x), atol=1e-6)


def test_decompose_recompose_identity_keys():
    """tests/test_animated_transform.py's case: a key evaluated at its own
    time reproduces the key matrix."""
    at = AnimatedTransform.from_keys([0.0, 1.0], KEYS[:2], "cpu")
    v = np.array([[1.0, 0.3], [0.5, -2.0], [-0.2, 0.9]], np.float32)
    for t, m in ((0.0, KEYS[0]), (1.0, KEYS[1])):
        got = at.apply_point(torch.full((2,), t),
                             Vec3(*map(torch.from_numpy, v)))
        ref = (np.asarray(m) @ np.vstack([v, np.ones(2)]))[:3]
        np.testing.assert_allclose(
            np.stack([got.x, got.y, got.z]), ref, rtol=1e-5, atol=1e-5)


def test_rotation_midpoint_is_slerp():
    m0 = Transform4.rotate([0, 0, 1], 0.0).matrix
    m1 = Transform4.rotate([0, 0, 1], 90.0).matrix
    at = AnimatedTransform.from_keys([0.0, 1.0], [m0, m1], "cpu")
    r = at.apply_vector(torch.tensor([0.5]), Vec3(torch.tensor([1.0]),
                                                  torch.tensor([0.0]),
                                                  torch.tensor([0.0])))
    ang = np.degrees(np.arctan2(float(r.y), float(r.x)))
    np.testing.assert_allclose(ang, 45.0, atol=0.01)
    np.testing.assert_allclose(float(torch.sqrt(r.x ** 2 + r.y ** 2
                                                + r.z ** 2)), 1.0, rtol=1e-5)


def _jax_image(kind):
    import mitsuba2_tpu as mi
    return np.asarray(mi.render(_gallery_scene(kind, port=False),
                                mi.RenderConfig(**RENDER), seed=2))


@pytest.mark.parametrize("kind", KINDS)
def test_render_matches_jax(scenes, kind):
    img_j = REFS.get(f"image_{kind}", lambda: _jax_image(kind))
    img = mt.render(scenes[kind][1], mt.RenderConfig(**RENDER), seed=2,
                    device="cpu").numpy()
    assert img.shape == img_j.shape == (8, 8, 3) and img_j.mean() > 0
    np.testing.assert_allclose(img, img_j, rtol=1e-4, atol=1e-5)
    if kind == "radiancemeter":
        # one ray measured 256 times: every pixel the same estimate's spread
        assert img.std() > 0


def test_meters_read_known_values():
    """tests/test_samplers_sensors.py's meter cases on the port: a
    radiance meter at a diffuse plane under a constant sky reads albedo
    times the radiance; an irradiance meter under it reads pi times it."""
    from mitsuba2_tpu_torch.scene import shapes
    cam = Transform4.look_at(origin=[0, 0, 2], target=[0, 0, 0], up=[0, 1, 0])
    sky = [{"type": "constant", "radiance": [1.0] * 3}]
    sc = mt.build_scene(
        [shapes.rectangle(bsdf={"type": "diffuse", "reflectance": [0.6] * 3})],
        {"type": "radiancemeter", "to_world": np.asarray(cam.matrix)}, sky,
        device="cpu")
    img = mt.render(sc, mt.RenderConfig(width=1, height=1, spp=512,
                                        spp_per_pass=512, max_depth=2,
                                        rr_depth=99), device="cpu")
    np.testing.assert_allclose(float(img.mean()), 0.6, atol=0.02)
    cam = Transform4.look_at(origin=[0, 0, 0], target=[0, 0, 1], up=[0, 1, 0])
    sc = mt.build_scene(
        [shapes.sphere(center=[0, 0, -50], radius=1.0)],
        {"type": "irradiancemeter", "to_world": np.asarray(cam.matrix)},
        [{"type": "constant", "radiance": [2.0] * 3}], device="cpu")
    img = mt.render(sc, mt.RenderConfig(width=2, height=2, spp=1024,
                                        spp_per_pass=256, max_depth=2,
                                        rr_depth=99), device="cpu")
    np.testing.assert_allclose(float(img.mean()), np.pi * 2.0, rtol=0.02)
