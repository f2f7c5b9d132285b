"""The sampling distributions of the PyTorch port
(mitsuba2_tpu_torch/core/distr.py) against the JAX package's, case for
case with tests/test_distr.py.

Each case runs the JAX test's statistics on the port's distribution,
then holds the port's host tables byte-equal to the JAX build's from the
same weights and its draws to the JAX draws from the same uniforms: the
indices equal on every lane (a zero-weight entry, a flat run of the CDF,
never drawn by either), positions and pdfs within 1e-6 (relative where
a pdf exceeds 1).
"""
import numpy as np
import torch

from mitsuba2_tpu_torch.core import distr
from mitsuba2_tpu_torch.core.vec import Vec2

torch.set_num_threads(1)


def _jdistr():
    import jax.numpy as jnp
    from mitsuba2_tpu.core import distr as jd
    return jnp, jd


def _u(rng, shape):
    return rng.random(shape, dtype=np.float64).astype(np.float32)


def assert_tables_equal(mine: dict, ref):
    """Every host table of the port's build byte-equal to the JAX
    build's field of the same name."""
    for k, v in mine.items():
        r = getattr(ref, k)
        if isinstance(v, tuple):
            assert len(v) == len(r)
            for a, b in zip(v, r):
                assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), k
        elif isinstance(v, int):
            assert v == r, k
        else:
            a, b = np.asarray(v), np.asarray(r)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


def _close(a, b, tol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


def test_discrete_sample_matches_pmf():
    jnp, jd = _jdistr()
    w = np.array([1.0, 3.0, 0.0, 2.0, 4.0])
    assert_tables_equal(distr.DiscreteDistribution.build_numpy(w),
                        jd.DiscreteDistribution.build(w))
    d = distr.DiscreteDistribution.build(w)
    u = _u(np.random.default_rng(0), 200_000)
    idx = d.sample(torch.from_numpy(u)).numpy()
    counts = np.bincount(idx, minlength=5) / idx.size
    np.testing.assert_allclose(counts, w / w.sum(), atol=5e-3)
    assert counts[2] == 0.0
    ref = jd.DiscreteDistribution.build(w)
    np.testing.assert_array_equal(idx, np.asarray(ref.sample(jnp.asarray(u))))
    # on the CDF's steps and their float neighbours, the flat run included
    cdf = np.cumsum(w) / w.sum()
    edges = np.concatenate([cdf, np.nextafter(cdf, 0), np.nextafter(cdf, 2)])
    e = np.clip(edges, 0, 1 - 2 ** -24).astype(np.float32)
    i_m, p_m = d.sample_pmf(torch.from_numpy(e))
    i_j, p_j = ref.sample_pmf(jnp.asarray(e))
    np.testing.assert_array_equal(i_m.numpy(), np.asarray(i_j))
    assert (i_m.numpy() != 2).all()
    _close(p_m, p_j)


def test_discrete_sample_reuse_uniform():
    jnp, jd = _jdistr()
    w = [1.0, 2.0, 5.0]
    d = distr.DiscreteDistribution.build(w)
    u = _u(np.random.default_rng(1), 100_000)
    idx, u2 = d.sample_reuse(torch.from_numpy(u))
    u2 = u2.numpy()
    assert (u2 >= 0).all() and (u2 < 1.0).all()
    h, _ = np.histogram(u2, bins=10, range=(0, 1))
    assert h.std() / h.mean() < 0.05
    j_idx, j_u2 = jd.DiscreteDistribution.build(w).sample_reuse(
        jnp.asarray(u))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    _close(u2, j_u2)


def test_continuous_linear_ramp():
    jnp, jd = _jdistr()
    vals = np.linspace(0, 1, 11)
    assert_tables_equal(distr.ContinuousDistribution.build_numpy(vals, 0.0,
                                                                 1.0),
                        jd.ContinuousDistribution.build(vals, 0.0, 1.0))
    d = distr.ContinuousDistribution.build(vals, 0.0, 1.0)
    u = _u(np.random.default_rng(2), 200_000)
    x = d.sample(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(np.mean(x), 2.0 / 3.0, atol=2e-3)
    np.testing.assert_allclose(
        d.eval_pdf_normalized(torch.tensor([0.5])).numpy(), [1.0], atol=1e-5)
    ref = jd.ContinuousDistribution.build(vals, 0.0, 1.0)
    _close(x, ref.sample(jnp.asarray(u)))
    xs = np.linspace(-0.1, 1.1, 1001).astype(np.float32)
    _close(d.eval_pdf_normalized(torch.from_numpy(xs)),
           ref.eval_pdf_normalized(jnp.asarray(xs)))


def test_irregular_matches_regular():
    jnp, jd = _jdistr()
    nodes = np.array([0.0, 0.25, 0.5, 0.75, 1.0])
    vals = np.array([1.0, 2.0, 3.0, 2.0, 1.0])
    assert_tables_equal(
        distr.IrregularContinuousDistribution.build_numpy(nodes, vals),
        jd.IrregularContinuousDistribution.build(nodes, vals))
    d = distr.IrregularContinuousDistribution.build(nodes, vals)
    r = distr.ContinuousDistribution.build(vals, 0.0, 1.0)
    u = torch.linspace(0.01, 0.99, 101)
    np.testing.assert_allclose(d.sample(u).numpy(), r.sample(u).numpy(),
                               atol=1e-5)
    x = torch.linspace(0.0, 1.0, 101)
    np.testing.assert_allclose(d.eval_pdf(x).numpy(), r.eval_pdf(x).numpy(),
                               atol=1e-5)
    ref = jd.IrregularContinuousDistribution.build(nodes, vals)
    _close(d.sample(u), ref.sample(jnp.asarray(u.numpy())))
    _close(d.eval_pdf(x), ref.eval_pdf(jnp.asarray(x.numpy())))


def test_marginal2d_sample_pdf_consistent():
    jnp, jd = _jdistr()
    rng = np.random.default_rng(3)
    data = rng.random((16, 32)) + 0.1
    M = distr.Marginal2D.build(data)
    u = _u(rng, (100_000, 2))
    pos, pdf = M.sample(Vec2(*torch.from_numpy(u).unbind(1)))
    np.testing.assert_allclose(pdf.numpy(), M.eval_pdf(pos).numpy(),
                               rtol=2e-3)
    p = np.stack([pos.x.numpy(), pos.y.numpy()], -1)
    h, _, _ = np.histogram2d(p[:, 1], p[:, 0], bins=(16, 32),
                             range=[[0, 1], [0, 1]])
    assert np.abs(h / h.sum() - data / data.sum()).max() < 5e-3
    jpos, jpdf = jd.Marginal2D.build(data).sample(jnp.asarray(u))
    _close(p, np.asarray(jpos.to_array()))
    _close(pdf, jpdf)


def test_hierarchical2d_matches_density():
    jnp, jd = _jdistr()
    rng = np.random.default_rng(9)
    data = rng.random((12, 20)) + 0.05
    ref = jd.Hierarchical2D.build(data)
    mine = distr.Hierarchical2D.build_numpy(data)
    assert_tables_equal(mine, ref)
    H2 = distr.Hierarchical2D.from_numpy(mine)
    u = _u(rng, (200_000, 2))
    pos, pdf = H2.sample(Vec2(*torch.from_numpy(u).unbind(1)))
    np.testing.assert_allclose(pdf.numpy(), H2.eval_pdf(pos).numpy(),
                               rtol=1e-4)
    p = np.stack([pos.x.numpy(), pos.y.numpy()], -1)
    assert (p >= 0).all() and (p < 1).all()
    h, _, _ = np.histogram2d(p[:, 1], p[:, 0], bins=(12, 20),
                             range=[[0, 1], [0, 1]])
    assert np.abs(h / h.sum() - data / data.sum()).max() < 5e-3
    jpos, jpdf = ref.sample(jnp.asarray(u))
    _close(p, np.asarray(jpos.to_array()))
    _close(pdf, jpdf)


def test_hierarchical2d_agrees_with_marginal2d():
    rng = np.random.default_rng(10)
    data = rng.random((8, 8)) + 0.1
    H2 = distr.Hierarchical2D.build(data)
    M2 = distr.Marginal2D.build(data)
    u = rng.random((10_000, 2)).astype(np.float32)
    pos_h, pdf_h = H2.sample(Vec2(*torch.from_numpy(u).unbind(1)))
    np.testing.assert_allclose(pdf_h.numpy(), M2.eval_pdf(pos_h).numpy(),
                               rtol=1e-4)


def test_marginal2d_alias_matches_cdf_inversion():
    jnp, jd = _jdistr()
    rng = np.random.default_rng(7)
    data = rng.random((16, 32)) ** 3 + 1e-3
    M_cdf = distr.Marginal2D.build(data)
    M_al = distr.Marginal2D.build(data, alias=True)
    u = rng.random((200_000, 2)).astype(np.float32)
    uv = Vec2(*torch.from_numpy(u).unbind(1))
    pos_a, pdf_a = M_al.sample(uv)
    np.testing.assert_allclose(pdf_a.numpy(), M_al.eval_pdf(pos_a).numpy(),
                               rtol=2e-3)
    pa = np.stack([pos_a.x.numpy(), pos_a.y.numpy()], -1)
    h_a, _, _ = np.histogram2d(pa[:, 1], pa[:, 0], bins=(16, 32),
                               range=[[0, 1], [0, 1]])
    assert np.abs(h_a / h_a.sum() - data / data.sum()).max() < 5e-3
    fx = pa[:, 0] * 32 - np.floor(pa[:, 0] * 32)
    fy = pa[:, 1] * 16 - np.floor(pa[:, 1] * 16)
    assert abs(fx.mean() - 0.5) < 5e-3 and abs(fy.mean() - 0.5) < 5e-3
    pos_c, pdf_c = M_cdf.sample(uv)
    np.testing.assert_allclose(M_al.eval_pdf(pos_c).numpy(), pdf_c.numpy(),
                               rtol=2e-3)
    jpos, jpdf = jd.Marginal2D.build(data, alias=True).sample(jnp.asarray(u))
    _close(pa, np.asarray(jpos.to_array()))
    _close(pdf_a, jpdf)
