"""The sampling warps of the PyTorch port (mitsuba2_tpu_torch/core/warp.py)
against the JAX package's, case for case with tests/test_warp.py.

Each case runs the JAX test's chi^2 check through the port's harness
(chi2.warp_adapter, PlanarDomain and SphericalDomain: 300 000 draws, the
JAX case's bins and quadrature, significance 0.01), then holds the warp
and its pdf to the JAX package's on a seeded sweep of 4 096 samples and
points (atol 1e-6, and rtol 1e-6 on the peaked pdfs: Beckmann's and the
von Mises-Fisher's reach 30 and 16). torch's and XLA's f32 logarithms
differ in the last place on some lanes: a direction's cos theta is held
at atol 1e-6, and its x and y at 1e-6 times the factor by which
sin theta = sqrt(1 - cos^2 theta) magnifies an error of cos theta,
max(1, |cos theta| / sin theta) (near the pole a 1-ulp cos theta moves
sin theta by up to 4e-6). The inverse maps round-trip as in the JAX
tests and match the JAX inverses.
"""
import numpy as np
import pytest
import torch

from mitsuba2_tpu_torch import chi2
from mitsuba2_tpu_torch.core import warp
from mitsuba2_tpu_torch.core.vec import Vec3

torch.set_num_threads(1)

N_SWEEP = 4096


def _jax():
    import jax.numpy as jnp
    from mitsuba2_tpu.core import warp as jwarp
    from mitsuba2_tpu.core.vec import Vec3 as JVec3
    return jnp, jwarp, JVec3


def _np(x):
    if hasattr(x, "x"):
        return np.stack([np.asarray(x.x), np.asarray(x.y), np.asarray(x.z)],
                        -1)
    if isinstance(x, (tuple, list)):
        return np.stack([np.asarray(c) for c in x], -1)
    return np.asarray(x)


def _sweep(seed):
    return np.random.default_rng(seed).random((N_SWEEP, 2)).astype(np.float32)


def _dirs(seed):
    """Unit directions over the sphere, both hemispheres."""
    v = np.random.default_rng(seed).normal(size=(N_SWEEP, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _points(seed, lo=-1.2, hi=1.2):
    r = np.random.default_rng(seed).random((N_SWEEP, 2))
    return (lo + (hi - lo) * r).astype(np.float32)


def assert_warp_matches(name, kw, domain, seed, rtol=0.0):
    """The port's warp `name` and its pdf against the JAX package's on a
    sweep (kw its parameters)."""
    jnp, jwarp, JVec3 = _jax()
    u = _sweep(seed)
    mine = getattr(warp, name)(torch.from_numpy(u[:, 0]),
                               torch.from_numpy(u[:, 1]), **kw)
    ref = _np(getattr(jwarp, name)(jnp.asarray(u), **kw))
    mine = _np(mine)
    if domain == "sphere":
        z = ref[:, 2].astype(np.float64)
        gain = np.maximum(1.0, np.abs(z) / np.sqrt(np.maximum(1 - z * z,
                                                              1e-30)))
        err = np.abs(mine - ref) / np.stack([gain, gain, np.ones_like(z)], 1)
        assert err.max() <= 1e-6, (name, kw, err.max())
    else:
        np.testing.assert_allclose(mine, ref, atol=1e-6, rtol=rtol)
    if domain == "sphere":
        d = _dirs(seed + 1)
        pm = getattr(warp, name + "_pdf")(
            Vec3(*torch.from_numpy(d).unbind(1)), **kw)
        pj = getattr(jwarp, name + "_pdf")(JVec3.from_array(jnp.asarray(d)),
                                           **kw)
    else:
        p = _points(seed + 1, *domain)
        pm = getattr(warp, name + "_pdf")(*torch.from_numpy(p).unbind(1),
                                          **kw)
        pj = getattr(jwarp, name + "_pdf")(jnp.asarray(p), **kw)
    np.testing.assert_allclose(_np(pm), _np(pj), atol=1e-6, rtol=rtol)


def run_spherical(sample, pdf, sample_count=300_000, res=17, ires=8):
    t = chi2.ChiSquareTest(chi2.SphericalDomain(), sample, pdf,
                           sample_count=sample_count, res=res, ires=ires)
    assert t.run(), "\n".join(t.messages)


def run_planar(sample, pdf, bounds=None, sample_count=300_000, res=17):
    t = chi2.ChiSquareTest(chi2.PlanarDomain(bounds), sample, pdf,
                           sample_count=sample_count, res=res)
    assert t.run(), "\n".join(t.messages)


@pytest.mark.parametrize("name", ["uniform_sphere", "uniform_hemisphere",
                                  "cosine_hemisphere"])
def test_spherical_warp(name):
    fn, pdf = (getattr(warp, f"square_to_{name}"),
               getattr(warp, f"square_to_{name}_pdf"))
    run_spherical(*chi2.warp_adapter(fn, pdf))
    assert_warp_matches(f"square_to_{name}", {}, "sphere", 1)


@pytest.mark.parametrize("cutoff", [0.875, 0.5, -0.5])
def test_uniform_cone(cutoff):
    # cutoffs on bin edges (res 16: multiples of 1/8), as the JAX test
    t = chi2.ChiSquareTest(chi2.SphericalDomain(), *chi2.warp_adapter(
        warp.square_to_uniform_cone, warp.square_to_uniform_cone_pdf,
        cos_cutoff=cutoff), sample_count=300_000, res=16)
    assert t.run(), "\n".join(t.messages)
    assert_warp_matches("square_to_uniform_cone", {"cos_cutoff": cutoff},
                        "sphere", 2)


@pytest.mark.parametrize("alpha", [0.1, 0.5, 1.0])
def test_beckmann(alpha):
    run_spherical(*chi2.warp_adapter(warp.square_to_beckmann,
                                     warp.square_to_beckmann_pdf,
                                     alpha=alpha),
                  ires=64 if alpha < 0.3 else 8)
    assert_warp_matches("square_to_beckmann", {"alpha": alpha}, "sphere", 3,
                        rtol=1e-6)


@pytest.mark.parametrize("kappa", [0.5, 10.0, 100.0])
def test_von_mises_fisher(kappa):
    run_spherical(*chi2.warp_adapter(warp.square_to_von_mises_fisher,
                                     warp.square_to_von_mises_fisher_pdf,
                                     kappa=kappa),
                  ires=64 if kappa > 50 else 8)
    assert_warp_matches("square_to_von_mises_fisher", {"kappa": kappa},
                        "sphere", 4, rtol=1e-6)


@pytest.mark.parametrize("name,pdf,bounds", [
    ("uniform_disk", "uniform_disk", None),
    ("uniform_disk_concentric", "uniform_disk", None),
    ("tent", "tent", None),
    ("uniform_triangle", "uniform_triangle", [[0.0, 1.0], [0.0, 1.0]]),
    ("std_normal", "std_normal", [[-4.0, 4.0], [-4.0, 4.0]]),
])
def test_planar_warp(name, pdf, bounds):
    fn = getattr(warp, f"square_to_{name}")
    pdf_fn = getattr(warp, f"square_to_{pdf}_pdf")
    run_planar(*chi2.warp_adapter(fn, pdf_fn),
               bounds=None if bounds is None else np.array(bounds))
    jnp, jwarp, _ = _jax()
    u = _sweep(5)
    np.testing.assert_allclose(
        _np(fn(*torch.from_numpy(u).unbind(1))),
        _np(getattr(jwarp, f"square_to_{name}")(jnp.asarray(u))), atol=1e-6)
    lo, hi = (-1.2, 1.2) if bounds is None else (bounds[0][0] - 0.2,
                                                 bounds[0][1] + 0.2)
    p = _points(6, lo, hi)
    np.testing.assert_allclose(
        _np(pdf_fn(*torch.from_numpy(p).unbind(1))),
        _np(getattr(jwarp, f"square_to_{pdf}_pdf")(jnp.asarray(p))),
        atol=1e-6)


def _roundtrip(seed, forward, inverse, jforward, jinverse):
    jnp = _jax()[0]
    u = np.random.default_rng(seed).random((10_000, 2)).astype(np.float32)
    p = forward(*torch.from_numpy(u).unbind(1))
    u2 = _np(inverse(p))
    np.testing.assert_allclose(u2, u, atol=2e-5)
    np.testing.assert_allclose(u2, _np(jinverse(jforward(jnp.asarray(u)))),
                               atol=1e-6)


def test_concentric_disk_inverse_roundtrip():
    _, jwarp, _ = _jax()
    _roundtrip(0, warp.square_to_uniform_disk_concentric,
               lambda p: warp.uniform_disk_to_square_concentric(*p),
               jwarp.square_to_uniform_disk_concentric,
               jwarp.uniform_disk_to_square_concentric)


def test_cosine_hemisphere_inverse_roundtrip():
    _, jwarp, _ = _jax()
    _roundtrip(1, warp.square_to_cosine_hemisphere,
               warp.cosine_hemisphere_to_square,
               jwarp.square_to_cosine_hemisphere,
               jwarp.cosine_hemisphere_to_square)


def test_uniform_sphere_inverse_matches_jax():
    _, jwarp, _ = _jax()
    _roundtrip(2, warp.square_to_uniform_sphere, warp.uniform_sphere_to_square,
               jwarp.square_to_uniform_sphere, jwarp.uniform_sphere_to_square)


def test_interval_to_tent():
    jnp, jwarp, _ = _jax()
    u = torch.linspace(0.001, 0.999, 1001)
    x = warp.interval_to_tent(u).numpy()
    assert (x >= -1).all() and (x <= 1).all()
    # the tent's CDF at 0 is 0.5
    assert abs(np.interp(0.0, x, u.numpy()) - 0.5) < 1e-3
    np.testing.assert_allclose(
        x, np.asarray(jwarp.interval_to_tent(jnp.asarray(u.numpy()))),
        atol=1e-6)


@pytest.mark.parametrize("abc", [(-1.0, 0.0, 1.0), (0.0, 0.25, 2.0)])
def test_interval_to_nonuniform_tent(abc):
    jnp, jwarp, _ = _jax()
    u = np.random.default_rng(7).random(N_SWEEP).astype(np.float32)
    x = warp.interval_to_nonuniform_tent(torch.from_numpy(u), *abc).numpy()
    a, b, c = abc
    assert (x >= a - 1e-6).all() and (x <= c + 1e-6).all()
    np.testing.assert_allclose(x, np.asarray(jwarp.interval_to_nonuniform_tent(
        jnp.asarray(u), *abc)), atol=1e-6)
    # the tent's mass below its peak is (b - a) / (c - a)
    assert abs((x < b).mean() - (b - a) / (c - a)) < 0.02
