"""Medium gradients of the PyTorch port against the JAX package: d(image)
/ d(med_data) and d(image) / d(med_grid) from render_and_grad on
tests/test_medium_grad.py's slab scenes (chip_smoke.medium_slab: a null
cube holding a homogeneous medium, or a heterogeneous one over a constant
grid, in front of an emissive wall), against the JAX package's gradients
and the port's own central differences.

The JAX package's adjoint of these scenes compiles for a minute or more
on a CPU: tests/goldens/media.npz holds its images and gradients,
written by tests/goldens/make_media.py (rerun it after changing a scene
or a config below).

Tolerances: images within rtol 1e-3 / atol 1e-4 on every pixel; each
gradient table within 1e-3 of its largest JAX entry; sigma_t's gradient
within tests/test_medium_grad.py's band of a central difference (rtol
0.12).
"""
import os

import numpy as np
import pytest
import torch

import chip_smoke
import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.diff import adjoint
from mitsuba2_tpu_torch.scene import presets as tpresets

from test_torch_render import GOLDEN_DIR

# tests/test_medium_grad.py's config, slabs and seeds, and its central
# difference's step and band (chip_smoke's phase 7 holds the card's)
# one intra-op thread: the suite's test processes share the cores
# (pytest-xdist), and torch's OpenMP regions stall when they
# oversubscribe them
torch.set_num_threads(1)

CFG = chip_smoke.MEDIUM_GRAD
SLABS = chip_smoke.MEDIUM_SLABS
FD_EPS, FD_RTOL = chip_smoke.MEDIUM_FD_EPS, chip_smoke.MEDIUM_FD_RTOL


def slab_kw(name):
    return {k: v for k, v in SLABS[name].items() if k != "seed"}


def port_slab(name):
    return chip_smoke.medium_slab(tpresets, device="cpu", **slab_kw(name))


@pytest.fixture(scope="module")
def ref():
    return np.load(os.path.join(GOLDEN_DIR, "media.npz"))


@pytest.fixture(scope="module")
def grads():
    """render_and_grad of each slab: (image, loss, grads) as numpy."""
    out = {}
    for name, kw in SLABS.items():
        img, loss, g = mt.render_and_grad(
            port_slab(name), mt.RenderConfig(**CFG), torch.mean,
            seed=kw["seed"], device="cpu")
        out[name] = (img.numpy(), float(loss),
                     {k: v.numpy() for k, v in g.items()})
    return out


@pytest.mark.parametrize("name", sorted(SLABS))
def test_images_match_jax(grads, ref, name):
    img = grads[name][0]
    assert np.isclose(img, ref[f"{name}_image"], rtol=1e-3, atol=1e-4).all()


@pytest.mark.parametrize("name,table", [("homogeneous", "med_data"),
                                        ("heterogeneous", "med_data"),
                                        ("heterogeneous", "med_grid")])
def test_gradients_match_jax(grads, ref, name, table):
    g, gj = grads[name][2][table], ref[f"{name}_{table}"]
    assert g.shape == gj.shape and np.isfinite(g).all()
    assert np.abs(gj).max() > 0
    np.testing.assert_allclose(g, gj, rtol=0, atol=1e-3 * np.abs(gj).max())


@pytest.mark.parametrize("name", sorted(SLABS))
def test_every_gradient_finite(grads, name):
    g = grads[name][2]
    want = {"mat_data", "emitter_data", "med_data"} | (
        {"med_grid"} if name == "heterogeneous" else set())
    assert set(g) == want
    assert all(np.isfinite(v).all() for v in g.values())


def test_sigma_t_gradient_matches_fd(grads):
    """tests/test_medium_grad.py::test_sigma_t_gradient_matches_fd on the
    port: the summed sigma_t gradient within rtol 0.12 of a central
    difference of the image mean (negative: more extinction, darker)."""
    scene = port_slab("homogeneous")
    cfg = mt.RenderConfig(**CFG)

    def loss_at(ds):
        med = scene.med_data.clone()
        med[0, 0:3] += ds
        s = adjoint.with_tables(scene, {**adjoint.diff_tables(scene),
                                        "med_data": med})
        return float(mt.render(s, cfg, seed=3, device="cpu").mean())

    fd = (loss_at(FD_EPS) - loss_at(-FD_EPS)) / (2 * FD_EPS)
    ad = float(grads["homogeneous"][2]["med_data"][0, 0:3].sum())
    assert abs(fd) > 1e-4 and ad < 0
    np.testing.assert_allclose(ad, fd, rtol=FD_RTOL)


def test_grid_gradient_localized(grads):
    """The voxel gradient is nonzero and larger inside the camera's beam
    than at the slab's far corners (tests/test_medium_grad.py's locality
    check)."""
    g = grads["heterogeneous"][2]["med_grid"]
    assert np.abs(g).max() > 0
    assert np.abs(g[:, 3:5, 3:5]).mean() > np.abs(g[:, [0, -1]][:, :,
                                                               [0, -1]]).mean()


def test_parameter_paths_name_the_medium():
    """traverse names the medium rows and the grid as the JAX package
    does; scene_with applies them (plain columns, a whole-table grid)."""
    hom, het = port_slab("homogeneous"), port_slab("heterogeneous")
    pm = mt.traverse(hom)
    assert {"vol.interior.sigma_t", "vol.interior.albedo",
            "vol.interior.phase_g", "vol.interior.scale"} <= set(pm)
    np.testing.assert_allclose(pm["vol.interior.sigma_t"].numpy(),
                               [0.6] * 3, rtol=1e-6)
    assert float(pm["vol.interior.phase_g"]) == 0.0
    s2 = mt.scene_with(hom, {"vol.interior.sigma_t": torch.full((3,), 0.9)})
    assert torch.equal(s2.med_data[0, 0:3], torch.full((3,), 0.9))
    assert torch.equal(hom.med_data[0, 0:3], torch.full((3,), 0.6))
    pm2 = mt.traverse(het)
    assert pm2["medium.density.data"].shape == (4, 8, 8)
    s3 = pm2.update({"medium.density.data":
                     2.0 * pm2["medium.density.data"]}).scene
    assert float(s3.medium_grid.data.max()) == 2.0
    # differentiable through scene_with, as tests/test_medium_grad.py's
    # traverse case: more extinction, a darker image
    sig = torch.full((3,), 0.6, requires_grad=True)
    img = mt.render(mt.scene_with(hom, {"vol.interior.sigma_t": sig}),
                    mt.RenderConfig(**{**CFG, "spp": 8, "spp_per_pass": 8}),
                    seed=2, device="cpu")
    img.mean().backward()
    assert torch.isfinite(sig.grad).all() and float(sig.grad.sum()) < 0
