"""Built-in scenes (counterpart of scene/presets.py): the Cornell box, the
furnace, Veach's MIS scene, the mesh gallery, the instanced field, the
kitchen sink and the smoke box, built from the same host geometry as the
JAX package's presets so their tables are byte-equal."""
from __future__ import annotations

import numpy as np

from ..core.geometry import Transform4
from . import shapes
from .scene import SceneData, build_scene

WHITE = [0.730, 0.735, 0.729]
RED = [0.611, 0.0555, 0.062]
GREEN = [0.117, 0.449, 0.115]
LIGHT = [18.4, 15.6, 8.0]


def _quad(p00, p10, p11, p01, bsdf=None, emitter=None, id=""):
    """Two-triangle quad; normal follows the CCW winding."""
    v = np.asarray([p00, p10, p11, p01], np.float32)
    f = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return shapes.mesh(v, f, uvs=uv, bsdf=bsdf, emitter=emitter, id=id)


def cornell_box(light_radiance=LIGHT, boxes: bool = True,
                device=None) -> SceneData:
    """Unit Cornell box in [0,1]^3; camera on -z looking +z."""
    white = {"type": "diffuse", "reflectance": WHITE}
    red = {"type": "diffuse", "reflectance": RED}
    green = {"type": "diffuse", "reflectance": GREEN}
    s = [
        _quad([0, 0, 0], [0, 0, 1], [1, 0, 1], [1, 0, 0], bsdf=white, id="floor"),
        _quad([0, 1, 0], [1, 1, 0], [1, 1, 1], [0, 1, 1], bsdf=white, id="ceiling"),
        _quad([0, 0, 1], [0, 1, 1], [1, 1, 1], [1, 0, 1], bsdf=white, id="back"),
        _quad([1, 0, 0], [1, 0, 1], [1, 1, 1], [1, 1, 0], bsdf=red, id="left"),
        _quad([0, 0, 0], [0, 1, 0], [0, 1, 1], [0, 0, 1], bsdf=green, id="right"),
    ]
    lx0, lx1, lz0, lz1, ly = 0.37, 0.63, 0.40, 0.61, 0.9995
    s.append(_quad([lx0, ly, lz0], [lx1, ly, lz0], [lx1, ly, lz1], [lx0, ly, lz1],
                   bsdf=white, emitter={"type": "area", "radiance": light_radiance},
                   id="light"))
    if boxes:
        t_tall = (Transform4.translate([0.66, 0.30, 0.65]) @
                  Transform4.rotate([0, 1, 0], 17.0) @
                  Transform4.scale([0.15, 0.30, 0.15]))
        s.append(shapes.cube(bsdf=white, id="tall_box").transformed(t_tall.matrix))
        t_short = (Transform4.translate([0.33, 0.15, 0.35]) @
                   Transform4.rotate([0, 1, 0], -18.0) @
                   Transform4.scale([0.15, 0.15, 0.15]))
        s.append(shapes.cube(bsdf=white, id="short_box").transformed(t_short.matrix))
    cam = Transform4.look_at(origin=[0.5, 0.5, -1.39], target=[0.5, 0.5, 0.5],
                             up=[0, 1, 0])
    sensor = {"type": "perspective", "to_world": cam.matrix, "fov": 39.5}
    return build_scene(s, sensor, device=device)


def furnace(albedo=0.8, radiance=1.0, device=None) -> SceneData:
    """A diffuse unit sphere under a constant environment: the analytic
    furnace test (one prim, so brute force traverses it)."""
    s = [shapes.sphere(center=(0, 0, 0), radius=1.0,
                       bsdf={"type": "diffuse", "reflectance": [albedo] * 3})]
    cam = Transform4.look_at(origin=[0, 0, -4], target=[0, 0, 0], up=[0, 1, 0])
    sensor = {"type": "perspective", "to_world": np.asarray(cam.matrix),
              "fov": 39.0}
    return build_scene(s, sensor,
                       [{"type": "constant", "radiance": [radiance] * 3}],
                       device=device)


def veach_mis(envmap: bool = False, device=None) -> SceneData:
    """Veach's MIS test scene: four increasingly rough metal plates lit by
    four spherical emitters of decreasing size and increasing radiance.
    BSDF sampling wins on the smooth plates and small lights, NEE on the
    rough plates and large lights; only MIS renders all 16 pairs with low
    variance.

    envmap=True adds a dim procedural sky with a bright sun blob near the
    horizon (BASELINE config 3's area + envmap emitters): its peaked
    distribution makes the envmap's alias-table importance sampling
    matter."""
    plates = []
    alphas = [0.005, 0.02, 0.05, 0.1]
    # plates recede in z and rise in y, tilted to reflect the lights
    for i, a in enumerate(alphas):
        bsdf = {"type": "roughconductor", "material": "Al", "alpha": a}
        t = (Transform4.translate([0.0, -1.6 + 0.45 * i, -2.0 - 0.6 * i]) @
             Transform4.rotate([1, 0, 0], -90 + 25 - 3 * i) @
             Transform4.scale([2.0, 0.25, 1.0]))
        plates.append(shapes.rectangle(bsdf=bsdf, id=f"plate{i}")
                      .transformed(np.asarray(t.matrix)))
    # floor and back wall (diffuse, dim)
    grey = {"type": "diffuse", "reflectance": [0.3, 0.3, 0.3]}
    t_floor = (Transform4.translate([0, -2.0, -3]) @
               Transform4.rotate([1, 0, 0], -90) @
               Transform4.scale([6, 6, 1]))
    plates.append(shapes.rectangle(bsdf=grey, id="floor")
                  .transformed(np.asarray(t_floor.matrix)))
    t_back = Transform4.translate([0, 0, -6]) @ Transform4.scale([6, 6, 1])
    plates.append(shapes.rectangle(bsdf=grey, id="back")
                  .transformed(np.asarray(t_back.matrix)))
    # spherical emitters of equal power: radiance ~ 1 / r^2
    radii = [0.30, 0.12, 0.05, 0.02]
    xs = [-1.5, -0.5, 0.5, 1.5]
    for i, (r, x) in enumerate(zip(radii, xs)):
        L = 2.0 * (radii[0] / r) ** 2
        plates.append(shapes.sphere(
            center=(x, 1.2, -3.0), radius=r,
            bsdf={"type": "diffuse", "reflectance": [0, 0, 0]},
            emitter={"type": "area", "radiance": [L, L, L]},
            id=f"light{i}"))
    cam = Transform4.look_at(origin=[0, 0.3, 3.0], target=[0, -0.6, -2.5],
                             up=[0, 1, 0])
    sensor = {"type": "perspective", "to_world": np.asarray(cam.matrix),
              "fov": 38.0}
    emitters = ([{"type": "envmap", "data": procedural_sky(), "scale": 1.0}]
                if envmap else [])
    return build_scene(plates, sensor, emitters=emitters, device=device)


def procedural_sky() -> np.ndarray:
    """veach_mis(envmap=True)'s sky, (16, 32, 3) f32: a dim gradient and
    a bright sun blob near the horizon, a low mean radiance (the classic
    scene's MIS structure) in a strongly peaked importance table."""
    H, W = 16, 32
    th = (np.arange(H) + 0.5) / H * np.pi
    sky = np.zeros((H, W, 3), np.float32)
    sky[..., 2] = 0.04 + 0.08 * np.cos(th)[:, None]
    sky[..., 0] = 0.02
    sky[..., 1] = 0.03
    sky[4:6, 7:9] = [1.5, 1.3, 0.9]
    return sky


def _icosphere(subdiv: int):
    """Unit icosphere: 20 * 4^subdiv triangles (midpoint subdivision)."""
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


def _displace(verts, seed: int, amp: float = 0.22):
    """Smooth deterministic radial displacement (a lumpy blob)."""
    x, y, z = verts[:, 0], verts[:, 1], verts[:, 2]
    s = float(seed)
    bump = (np.sin(4.1 * x + 1.3 * s) * np.sin(3.7 * y + 0.7 * s)
            + 0.6 * np.sin(5.3 * z + 2.1 * s) * np.sin(2.9 * x - s)
            + 0.4 * np.sin(7.1 * y + 0.5 * s))
    r = 1.0 + amp * bump / 2.0
    return verts * r[:, None].astype(np.float32)


def mesh_gallery(subdiv: int = 4, grid: tuple = (3, 2),
                 device=None) -> SceneData:
    """The BVH-bound scene: a Cornell-style room holding a grid of
    displaced icosphere blobs, 20*4^subdiv triangles each (subdiv=4 with
    the 3x2 grid: 30 720 blob triangles + 12 room triangles)."""
    return build_scene(*mesh_gallery_shapes(subdiv, grid), device=device)


def mesh_gallery_shapes(subdiv: int = 4, grid: tuple = (3, 2)):
    """mesh_gallery's shapes and sensor, before the build."""
    white = {"type": "diffuse", "reflectance": WHITE}
    X, Y, Z = 3.0, 2.0, 3.0
    s = [
        _quad([0, 0, 0], [0, 0, Z], [X, 0, Z], [X, 0, 0], bsdf=white, id="floor"),
        _quad([0, Y, 0], [X, Y, 0], [X, Y, Z], [0, Y, Z], bsdf=white, id="ceiling"),
        _quad([0, 0, Z], [0, Y, Z], [X, Y, Z], [X, 0, Z], bsdf=white, id="back"),
        _quad([X, 0, 0], [X, 0, Z], [X, Y, Z], [X, Y, 0],
              bsdf={"type": "diffuse", "reflectance": RED}, id="left"),
        _quad([0, 0, 0], [0, Y, 0], [0, Y, Z], [0, 0, Z],
              bsdf={"type": "diffuse", "reflectance": GREEN}, id="right"),
    ]
    lx0, lx1, lz0, lz1, ly = 1.1, 1.9, 1.2, 1.8, Y - 5e-4
    s.append(_quad([lx0, ly, lz0], [lx1, ly, lz0], [lx1, ly, lz1],
                   [lx0, ly, lz1], bsdf=white,
                   emitter={"type": "area", "radiance": LIGHT}, id="light"))
    base_v, faces = _icosphere(subdiv)
    albedo = [[0.7, 0.3, 0.25], [0.3, 0.55, 0.7], [0.65, 0.6, 0.3],
              [0.5, 0.5, 0.65], [0.35, 0.6, 0.4], [0.6, 0.4, 0.6]]
    nx, nz = grid
    k = 0
    for i in range(nx):
        for j in range(nz):
            v = _displace(base_v.copy(), seed=k)
            cx = (i + 0.5) * X / nx
            cz = (j + 0.75) * Z / (nz + 0.5)
            cy = 0.45 + 0.1 * ((i + j) % 3)
            v = v * 0.34 + np.asarray([cx, cy, cz], np.float32)
            s.append(shapes.mesh(
                v, faces, bsdf={"type": "diffuse", "reflectance": albedo[k % 6]},
                id=f"blob{k}"))
            k += 1
    cam = Transform4.look_at(origin=[X / 2, 1.0, -2.6],
                             target=[X / 2, 0.8, 1.5], up=[0, 1, 0])
    sensor = {"type": "perspective", "to_world": cam.matrix, "fov": 50.0}
    return s, sensor


def instanced_field(n: int = 64, subdiv: int = 3, flatten: bool = False,
                    device=None) -> SceneData:
    """Shared-BLAS instancing scene: n instances of one displaced-icosphere
    blob (20*4^subdiv triangles, stored once) over a two-triangle ground
    plane, under a constant sky. With the defaults that is 64 * 1 280 =
    81 920 effective blob triangles from 1 282 stored prims; n=1024,
    subdiv=4 resolves 5 242 882 effective triangles from 5 122 stored.
    Whether the build keeps shared BLAS or flattens the instances is the
    JAX package's policy (scene._should_flatten_instances: shared above 4M
    effective prims, or as MI_FLATTEN_INSTANCES forces); flatten=True
    duplicates the transformed prims at the preset instead."""
    rng = np.random.default_rng(7)
    base_v, faces = _icosphere(subdiv)
    v = _displace(base_v.copy(), seed=3)
    grp = shapes.shapegroup([shapes.mesh(
        v, faces, bsdf={"type": "diffuse", "reflectance": [0.55, 0.5, 0.4]},
        id="blob")], id="blob_grp")

    side = int(np.ceil(np.sqrt(n)))
    s = [_quad([-side, 0, -side], [-side, 0, side], [side, 0, side],
               [side, 0, -side], bsdf={"type": "diffuse",
                                       "reflectance": WHITE}, id="ground")]
    for k in range(n):
        i, j = divmod(k, side)
        t = (Transform4.translate([2.0 * i - side + 1.0,
                                   0.45 + 0.15 * float(rng.uniform()),
                                   2.0 * j - side + 1.0])
             @ Transform4.rotate([0, 1, 0], float(rng.uniform(0, 360)))
             @ Transform4.scale([0.35 + 0.15 * float(rng.uniform())] * 3))
        inst = shapes.instance(grp, np.asarray(t.matrix), id=f"b{k}",
                               flatten=flatten)
        if flatten:
            s.extend(inst)
        else:
            s.append(inst)

    cam = Transform4.look_at(origin=[0.0, side * 0.8, -side * 1.6],
                             target=[0.0, 0.3, 0.0], up=[0, 1, 0])
    sensor = {"type": "perspective", "to_world": np.asarray(cam.matrix),
              "fov": 55.0}
    return build_scene(s, sensor,
                       [{"type": "constant", "radiance": [0.9, 0.95, 1.0]}],
                       device=device)


def kitchen_sink(device=None) -> SceneData:
    """Many subsystems in one scene: an envmap (a procedural sky, alias
    sampled), a bitmap-textured diffuse floor, a roughconductor cube with
    a checkerboard roughness texture, a dielectric sphere, a homogeneous
    absorber in a null cube, an area light and a thin-lens camera (depth
    of field). All data procedural (the golden kitchen_sink's scene)."""
    rng = np.random.default_rng(42)

    # procedural sky: horizon-to-zenith gradient and a bright sun blob
    H, W = 32, 64
    th = (np.arange(H) + 0.5) / H * np.pi
    sky = np.zeros((H, W, 3), np.float32)
    sky[..., 2] = 0.3 + 0.5 * np.cos(th)[:, None]
    sky[..., 0] = 0.15 + 0.1 * np.sin(th)[:, None]
    sky[..., 1] = 0.2
    sky[6:9, 10:13] = [6.0, 5.4, 4.2]
    envmap = {"type": "envmap", "data": sky, "scale": 1.0}

    tex = np.zeros((16, 16, 3), np.float32)
    tex[::2, ::2] = [0.7, 0.3, 0.2]
    tex[1::2, 1::2] = [0.7, 0.3, 0.2]
    tex += rng.uniform(0, 0.1, tex.shape).astype(np.float32)
    floor = shapes.rectangle(
        bsdf={"type": "diffuse",
              "reflectance": {"type": "bitmap", "data": tex}}).transformed(
        np.asarray((Transform4.translate([0, -1.0, 0])
                    @ Transform4.rotate([1, 0, 0], -90.0)
                    @ Transform4.scale([4.0, 4.0, 1.0])).matrix))
    metal = shapes.cube(
        bsdf={"type": "roughconductor", "material": "Au",
              "alpha": {"type": "checkerboard", "color0": [0.05] * 3,
                        "color1": [0.4] * 3}}).transformed(
        np.asarray((Transform4.translate([-1.4, -0.5, 0.6])
                    @ Transform4.rotate([0, 1, 0], 25.0)
                    @ Transform4.scale([0.5, 0.5, 0.5])).matrix))
    glass = shapes.sphere(center=(0.0, -0.4, 0.0), radius=0.6,
                          bsdf={"type": "dielectric", "int_ior": 1.5})
    fog = shapes.cube(bsdf={"type": "null"}).transformed(
        np.asarray((Transform4.translate([1.5, -0.55, -0.2])
                    @ Transform4.scale([0.45, 0.45, 0.45])).matrix))
    fog.interior = {"type": "homogeneous", "sigma_t": 1.2, "albedo": 0.6,
                    "g": 0.4}
    light = _quad([0.6, 1.4, -0.9], [1.4, 1.4, -0.9],
                  [1.4, 1.4, -0.1], [0.6, 1.4, -0.1],
                  bsdf={"type": "diffuse", "reflectance": [0, 0, 0]},
                  emitter={"type": "area", "radiance": [9.0, 7.0, 4.0]},
                  id="klight")
    cam = Transform4.look_at(origin=[0.3, 0.4, -3.4], target=[0, -0.4, 0],
                             up=[0, 1, 0])
    sensor = {"type": "thinlens", "to_world": np.asarray(cam.matrix),
              "fov": 42.0, "aperture_radius": 0.06,
              "focus_distance": float(np.linalg.norm([0.3, 0.8, -3.4]))}
    return build_scene([floor, metal, glass, fog, light], sensor,
                       emitters=[envmap], device=device)


def smoke_box(res: int = 32, device=None) -> SceneData:
    """The volumetric scene: a procedural smoke plume (a res^3
    heterogeneous density grid, albedo 0.7, HG g = 0.3) in a null box over
    a diffuse floor, lit by an area light above (bench.py's smoke_volpath
    scene). Procedural turbulence from a fixed seed."""
    rng = np.random.default_rng(7)
    z, y, x = np.meshgrid(np.linspace(-1, 1, res),
                          np.linspace(-1, 1, res),
                          np.linspace(-1, 1, res), indexing="ij")
    h = (z + 1.0) * 0.5                      # 0 at the bottom, 1 at the top
    r2 = x * x + y * y
    core = np.exp(-r2 / (0.08 + 0.35 * h * h))   # a widening column
    noise = np.zeros_like(core)
    for oct_ in range(3):
        k = 2 ** oct_
        n = rng.uniform(-1, 1, (4 * k, 4 * k, 4 * k)).astype(np.float32)
        reps = -(-res // (4 * k))
        n = np.tile(n, (reps, reps, reps))[:res, :res, :res]
        noise += n / (1.6 ** oct_)
    dens = np.clip(core * (0.75 + 0.45 * noise) * (1.0 - 0.55 * h),
                   0.0, None).astype(np.float32)

    box = shapes.cube(bsdf={"type": "null"}, id="smoke").transformed(
        np.asarray((Transform4.translate([0, 0.9, 0])
                    @ Transform4.scale([0.8, 0.9, 0.8])).matrix))
    box.interior = {"type": "heterogeneous", "sigma_t": 4.0,
                    "albedo": 0.7, "g": 0.3, "density": dens,
                    "bbox_min": [-0.8, 0.0, -0.8],
                    "bbox_max": [0.8, 1.8, 0.8]}
    floor = shapes.rectangle(
        bsdf={"type": "diffuse", "reflectance": [0.5] * 3},
        id="floor").transformed(
        np.asarray((Transform4.rotate([1, 0, 0], -90)
                    @ Transform4.scale([3.0, 3.0, 1.0])).matrix))
    light = _quad([-0.5, 2.6, -0.5], [0.5, 2.6, -0.5],
                  [0.5, 2.6, 0.5], [-0.5, 2.6, 0.5],
                  bsdf={"type": "diffuse", "reflectance": [0, 0, 0]},
                  emitter={"type": "area", "radiance": [14.0] * 3},
                  id="slight")
    cam = Transform4.look_at(origin=[0.0, 1.1, -3.2],
                             target=[0.0, 0.9, 0.0], up=[0, 1, 0])
    return build_scene([box, floor, light],
                       {"type": "perspective",
                        "to_world": np.asarray(cam.matrix), "fov": 40.0},
                       device=device)
