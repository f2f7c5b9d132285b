"""The plain reference: its PCG32 against the generator's definition in
Python integers, its BVH against brute force, its scenes against the
port's presets, and its renders and gradients against the port's at
16 x 16 on the CPU; its control in bfloat16 fails every limit there."""
import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from gpubench import manifest
from gpubench.entries import common
from gpubench.reference import accel, pathtracer, pcg32

M64 = (1 << 64) - 1
CELLS = {w["name"]: w for w in manifest.benchmark()["workloads"]}


def _pcg_ints(initstate, initseq, n):
    """PCG32 (O'Neill's pcg32_random_r) in Python integers."""
    inc = ((initseq << 1) | 1) & M64
    state = 0
    mult = 0x5851F42D4C957F2D

    def step(s):
        return (s * mult + inc) & M64
    state = step(state)
    state = (state + initstate) & M64
    state = step(state)
    out = []
    for _ in range(n):
        old = state
        state = step(state)
        xs = (((old >> 18) ^ old) >> 27) & 0xFFFFFFFF
        rot = old >> 59
        out.append(((xs >> rot) | (xs << ((-rot) & 31))) & 0xFFFFFFFF)
    return out


def test_pcg32_matches_integer_definition():
    lanes = torch.tensor([0, 1, 7, 123456, 0xFFFFFFFF])
    rng = pcg32.independent(0xDEADBEEF, lanes)
    got = torch.stack([rng.next_uint32() for _ in range(6)], 1).tolist()
    for lane, row in zip(lanes.tolist(), got):
        a, b = pcg32.tea(torch.tensor(0xDEADBEEF), torch.tensor(lane))
        want = _pcg_ints((int(b) << 32) | int(a), lane, 6)
        assert row == want


def test_bvh_matches_brute_force():
    spec = manifest.scene_spec(manifest.config("mesh_gallery_s4"))
    ref = pathtracer.build(spec, "cpu")
    g = torch.Generator().manual_seed(3)
    n = 4096
    o = torch.rand(n, 3, generator=g) * torch.tensor([3.0, 2.0, 3.0])
    d = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=1)
    tmax = torch.full((n,), float("inf"))
    planar = lambda x: (x[:, 0], x[:, 1], x[:, 2])  # noqa: E731
    t, prim = accel.closest_hit(ref.bvh, ref.tris, planar(o), planar(d), tmax)
    tb, pb = accel.brute_closest_hit(ref.tris, o, d, tmax)
    assert (prim == pb).float().mean() > 0.999
    assert torch.allclose(t[prim == pb], tb[prim == pb])
    occ = accel.any_hit(ref.bvh, ref.tris, planar(o), planar(d), tb * 0.5)
    assert not occ[pb >= 0].any()
    occ = accel.any_hit(ref.bvh, ref.tris, planar(o), planar(d), tb * 1.01)
    assert (occ == (pb >= 0)).all()


@pytest.mark.parametrize("name,preset", [("cornell_box", "cornell_box"),
                                         ("mesh_gallery_s4", "mesh_gallery")])
def test_scene_is_the_presets_geometry(name, preset):
    """The benchmark's scene holds the preset's vertices, faces, normals
    and materials; its light is the preset's quad as two triangles."""
    spec = manifest.scene_spec(manifest.config(name))
    got = {s["id"]: s for s in spec["shapes"]}
    want = mt.presets.__dict__[preset + "_shapes" if preset == "mesh_gallery"
                               else preset]
    if preset == "mesh_gallery":
        shapes, _ = want(subdiv=4)
    else:   # the Cornell box preset builds at once: rebuild its shapes
        import mitsuba2_tpu_torch.scene.presets as pr
        captured = {}
        orig = pr.build_scene
        pr.build_scene = lambda s, *a, **k: captured.setdefault("s", s)
        try:
            pr.cornell_box()
        finally:
            pr.build_scene = orig
        shapes = captured["s"]
    for sh in shapes:
        refl = list(sh.bsdf["reflectance"])
        if sh.emitter is not None:
            a, b = got[sh.id + "_a"], got[sh.id + "_b"]
            v = sh.vertices
            assert np.array_equal(a["vertices"], v[[0, 1, 2]])
            assert np.array_equal(b["vertices"], v[[0, 2, 3]])
            assert a["radiance"] == list(sh.emitter["radiance"])
            continue
        g = got[sh.id]
        assert np.array_equal(g["vertices"], sh.vertices)
        assert np.array_equal(g["faces"], sh.faces)
        assert (g["normals"] is None) == (sh.normals is None)
        if sh.normals is not None:
            assert np.array_equal(g["normals"], sh.normals)
        assert g["reflectance"] == refl


def _small(cell):
    t = dict(manifest.traffic(CELLS[cell]["traffic"]))
    t.update(width=16, height=16, spp=4, spp_per_pass=4)
    return t


@pytest.mark.parametrize("cell", ["gallery-render", "cornell-render"])
def test_render_matches_program_and_control_fails(cell):
    w = CELLS[cell]
    t = _small(cell)
    spec = manifest.scene_spec(manifest.config(w["config"]))
    api = common.program_api(mt)
    scene = common.program_scene(api, spec, "cpu")
    img = mt.render(scene, common.render_config(api, t), seed=77,
                    device="cpu")
    limit = t["limits"]["image_rel_l1"]
    for dtype, ok in ((torch.float32, True), (torch.bfloat16, False)):
        ref = pathtracer.render(pathtracer.build(spec, "cpu", dtype), t, 77)
        gap = float((img - ref.float()).abs().sum() / ref.float().abs().sum())
        assert (gap <= limit) == ok, (dtype, gap)
    pix = torch.tensor([0, 5, 77, 255])
    want = pathtracer.render_pixels(pathtracer.build(spec, "cpu"), t, 77, pix)
    assert torch.allclose(img.reshape(-1, 3)[pix], want, rtol=1e-6,
                          atol=1e-7)


@pytest.mark.parametrize("cell", ["cornell-grad", "gallery-grad"])
def test_gradient_matches_program(cell):
    w = CELLS[cell]
    t = _small(cell)
    spec = manifest.scene_spec(manifest.config(w["config"]))
    api = common.program_api(mt)
    scene = common.program_scene(api, spec, "cpu")
    cfg = common.render_config(api, t)
    target = mt.render(scene, cfg, seed=5, device="cpu")
    sc = mt.scene_with(scene, {t["param"]: torch.full((3,), t["init"])})
    img, loss, grads = mt.render_l2_grad(sc, cfg, target, seed=6,
                                         device="cpu")
    ref = pathtracer.build(spec, "cpu")
    rt = pathtracer.render(ref, t, 5)
    ref = pathtracer.with_reflectance(ref, t["param"].split(".")[0],
                                      [t["init"]] * 3)
    rimg, rloss, rg = pathtracer.l2_grad(ref, t, 6, rt, chunk=300)
    assert torch.allclose(img, rimg, rtol=1e-5, atol=1e-6)
    assert abs(float(loss) - float(rloss)) <= 1e-5 * float(rloss)
    assert torch.allclose(grads["mat_data"][:, :3], rg["reflectance"],
                          rtol=1e-4, atol=1e-7)
    assert not grads["mat_data"][:, 3:].any()
    assert torch.allclose(grads["emitter_data"][:, :3], rg["radiance"],
                          rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("name", ["cornell_box", "mesh_gallery_s4"])
def test_values_by_name_set_every_row(name):
    """The program's parameter names and values, read from its scene,
    set every reference material and emitter row, once each; a name
    left out is refused."""
    spec = manifest.scene_spec(manifest.config(name))
    api = common.program_api(mt)
    scene = common.program_scene(api, spec, "cpu")
    params = api.traverse(scene)
    values = {n: params[n] * 0.5 for n in params.keys()}
    ref = pathtracer.build(spec, "cpu")
    got = pathtracer.with_values(ref, values)
    assert torch.equal(got.reflectance, ref.reflectance * 0.5)
    assert torch.equal(got.radiance, ref.radiance * 0.5)
    short = dict(list(values.items())[1:])
    with pytest.raises(ValueError):
        pathtracer.with_values(ref, short)
