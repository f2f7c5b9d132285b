"""The samplers and the QMC helpers of the PyTorch port against the JAX
package: core/qmc.py and render/sampler.py.

Tolerances:
- `_hash3`, `radical_inverse` in every base the ld sampler takes, and
  every sampler's draws over 8 dimensions: bit-equal, on seeded inputs
  that include the uint32 values nearest 2^32 (the products of `_hash3`
  overflow 32 bits there, and torch holds them in int64);
- the JAX package's own sampler properties (tests/test_samplers_sensors.py,
  tests/test_checkpoint_qmc.py) at their tolerances;
- a 16x16 Cornell render under each sampler against the JAX package's
  image: every pixel within rtol 1e-4 / atol 1e-5 (the same streams;
  shading rounds apart by ulps).

What the JAX package compiles (its renders, its compiled draws and
radical inverses) is committed (tests/goldens/test_torch_samplers.npz);
one entry is recomputed live.
"""
import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.core import qmc
from mitsuba2_tpu_torch.render import sampler as ts

from goldens.jax_refs import Refs

# one intra-op thread: the suite's test processes share the cores
# (pytest-xdist), and torch's OpenMP regions stall when they
# oversubscribe them
torch.set_num_threads(1)

REFS = Refs("test_torch_samplers")
KINDS = ("independent", "stratified", "ldsampler", "halton")
CORNELL = dict(width=16, height=16, spp=4, spp_per_pass=2, max_depth=3,
               rr_depth=2)


def _u32_inputs(n=4000, seed=0):
    """Seeded uint32 values, the 64 nearest 2^32 and the first 64."""
    rng = np.random.default_rng(seed)
    v = np.concatenate([rng.integers(0, 2 ** 32, n, dtype=np.uint64),
                        np.arange(2 ** 32 - 64, 2 ** 32, dtype=np.uint64),
                        np.arange(64, dtype=np.uint64)]).astype(np.uint32)
    return v, torch.from_numpy(v.astype(np.int64))


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("b,c", [(0, 0), (7, 2 ** 32 - 1),
                                 (123, 0xDEADBEEF), (2 ** 32 - 1, 5)])
def test_hash3_bit_equal(b, c):
    import jax.numpy as jnp
    from mitsuba2_tpu.render import sampler as js
    v, t = _u32_inputs()
    want = np.asarray(js._hash3(jnp.asarray(v), jnp.uint32(b),
                                jnp.uint32(c)))
    got = ts._hash3(t, b, c)
    assert got.dtype == torch.int64 and int(got.min()) >= 0
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # the host-integer path: the same mix of one value
    assert ts._hash3(int(v[-70]), b, c) == int(want[-70])


@pytest.mark.parametrize("base", ts._LD_PRIMES)
def test_radical_inverse_bit_equal(base):
    """Op by op against the JAX package's eager loop, and fused
    (qmc.fma_f32) against its compiled one, whose multiply-adds XLA:CPU
    contracts into FMAs (the ld sampler's: lax.switch is compiled)."""
    import jax
    import jax.numpy as jnp
    from mitsuba2_tpu.core import qmc as jq
    v, t = _u32_inputs(seed=base)
    eager = np.asarray(jq.radical_inverse(jnp.asarray(v), base))
    compiled = REFS.get(f"radical_inverse_{base}", lambda: np.asarray(
        jax.jit(lambda i: jq.radical_inverse(i, base))(jnp.asarray(v))))
    for fused, want in ((False, eager), (True, compiled)):
        got = qmc.radical_inverse(t, base, fused=fused)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # base 2 reverses the bits unclamped: 2^32 - 1 rounds to 1.0
    assert float(got.max()) <= (1.0 if base == 2 else qmc.ONE_MINUS_EPS)
    if base > 3:
        assert (eager != compiled).any()    # the contraction is real


def _round_f32(fr):
    """The float32 nearest the Fraction `fr` (ties to even)."""
    from fractions import Fraction
    x = np.float32(float(fr))
    cands = (np.nextafter(x, np.float32(-np.inf)), x,
             np.nextafter(x, np.float32(np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - fr),
                                     int(c.view(np.uint32)) & 1))


def test_fma_f32_rounds_once():
    """fma_f32 against the exactly rounded a * b + c, on the digit loop's
    operands: sums that need more than float64's 53 bits, where a double
    rounding would differ."""
    from fractions import Fraction
    rng = np.random.default_rng(1)
    a = rng.integers(0, 101, 3000).astype(np.float32)
    c = rng.random(3000).astype(np.float32)
    for base, k in ((53, 12), (7, 5), (3, 20)):
        b = np.float32(float(base) ** -k)
        got = qmc.fma_f32(torch.from_numpy(a), float(b),
                          torch.from_numpy(c)).numpy()
        want = [_round_f32(Fraction(float(x)) * Fraction(float(b))
                           + Fraction(float(y))) for x, y in zip(a, c)]
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_halton_points_match_jax():
    """halton_points and the JAX package's QMC cases
    (tests/test_checkpoint_qmc.py): the first base-2 and base-3 values,
    the quadrant counts of 1024 points."""
    from mitsuba2_tpu.core import qmc as jq
    pts = qmc.halton_points(1024, 5, device="cpu").numpy()
    np.testing.assert_array_equal(_bits(pts),
                                  _bits(np.asarray(jq.halton_points(1024, 5))))
    np.testing.assert_allclose(
        qmc.radical_inverse_base2(torch.arange(8)).numpy(),
        [0, 0.5, 0.25, 0.75, 0.125, 0.625, 0.375, 0.875], atol=1e-7)
    np.testing.assert_allclose(qmc.radical_inverse(torch.arange(4), 3),
                               [0, 1 / 3, 2 / 3, 1 / 9], atol=1e-6)
    q = (pts[:, 0] > 0.5).astype(int) * 2 + (pts[:, 1] > 0.5).astype(int)
    assert (np.abs(np.bincount(q, minlength=4) - 256) < 30).all()


def _jax_draws(kind, lanes, n_pix, spp, dims):
    """The JAX package's draws of 8 dimensions, next_1d and next_2d in
    turn, compiled as its render pass compiles them; f(seed) -> list. The
    lanes are an argument: as a constant, XLA would fold the draws at
    compile time, where it rounds without FMAs."""
    import jax
    import jax.numpy as jnp
    from mitsuba2_tpu.render import sampler as js

    @jax.jit
    def draws(seed, lanes):
        s = js.make_sampler(kind, seed, lanes, n_pix, spp)
        out = []
        for d in dims:
            u, s = s.next_1d() if d == 1 else s.next_2d()
            out += [u] if d == 1 else list(u)
        return out
    return draws


@pytest.mark.parametrize("kind", KINDS[:3])
def test_draws_bit_equal(kind):
    """8 dimensions through next_1d and next_2d in turn, lanes laid out
    (spp, pixels) as render_pass lays them, lane ids near 2^32 too, at
    three seeds."""
    import jax.numpy as jnp
    n_pix, spp, dims = 48, 8, (1, 2, 2, 1, 2)
    lanes = np.concatenate([np.arange(n_pix * spp),
                            2 ** 32 - 1 - np.arange(n_pix)]).astype(np.uint32)
    def jax_draws():
        draws = _jax_draws(kind, lanes, n_pix, spp, dims)
        return [[np.asarray(a) for a in draws(jnp.uint32(seed),
                                              jnp.asarray(lanes))]
                for seed in (0, 12345, 2 ** 32 - 1)]
    for seed, want in zip((0, 12345, 2 ** 32 - 1),
                          REFS.get(f"draws_{kind}", jax_draws)):
        st = ts.make_sampler(kind, seed,
                             torch.from_numpy(lanes.astype(np.int64)),
                             n_pix, spp)
        got = []
        for d in dims:
            u, st = st.next_1d() if d == 1 else st.next_2d()
            got += [u] if d == 1 else list(u)
        assert len(got) == len(want) == 8
        for b, a in zip(got, want):
            np.testing.assert_array_equal(_bits(b.numpy()), _bits(a))
            assert float(b.min()) >= 0.0 and float(b.max()) < 1.0
        if kind != "independent":
            assert st.dim == 8


def test_halton_is_ldsampler():
    lane = torch.arange(64 * 4)
    a = ts.make_sampler("halton", 9, lane, 64, 4)
    b = ts.make_sampler("ldsampler", 9, lane, 64, 4)
    assert isinstance(a, ts.LDSampler) and (a.dim, a.seed) == (b.dim, b.seed)
    assert torch.equal(a.pix, b.pix) and torch.equal(a.sidx, b.sidx)


@pytest.mark.parametrize("kind", ["stratified", "ldsampler"])
def test_sampler_uniform_marginals(kind):
    """tests/test_samplers_sensors.py's case on the port: each dimension
    stays uniform on [0, 1)."""
    n_pix, spp = 64, 16
    s = ts.make_sampler(kind, 7, torch.arange(n_pix * spp), n_pix, spp)
    for _ in range(3):
        u, s = s.next_1d()
        u = u.numpy()
        assert (u >= 0).all() and (u < 1).all()
        assert abs(u.mean() - 0.5) < 0.02
        assert abs(u.std() - np.sqrt(1 / 12)) < 0.02


def test_stratified_covers_strata():
    """Per (pixel, dimension) every stratum is hit exactly once."""
    n_pix, spp = 8, 16
    s = ts.make_sampler("stratified", 3, torch.arange(n_pix * spp), n_pix,
                        spp)
    for _ in range(3):
        u, s = s.next_1d()
        u = u.numpy().reshape(spp, n_pix)
        for p in range(n_pix):
            np.testing.assert_array_equal(
                np.sort(np.floor(u[:, p] * spp).astype(int)), np.arange(spp))


def _jax_cornell(kind):
    import mitsuba2_tpu as mi
    from mitsuba2_tpu.scene import presets as jpresets
    return np.asarray(mi.render(jpresets.cornell_box(), mi.RenderConfig(
        **CORNELL, sampler=kind), seed=4))


@pytest.mark.parametrize("kind", KINDS)
def test_cornell_render_matches_jax(kind):
    img_j = REFS.get(f"cornell_{kind}", lambda: _jax_cornell(kind))
    img = mt.render(mt.cornell_box(device="cpu"), mt.RenderConfig(
        **CORNELL, sampler=kind), seed=4, device="cpu").numpy()
    assert img.shape == img_j.shape == (16, 16, 3) and img_j.mean() > 0
    np.testing.assert_allclose(img, img_j, rtol=1e-4, atol=1e-5)


def test_golden_is_fresh():
    """The golden's base-3 radical inverse, compiled by the JAX package
    now: a stale golden (new inputs) fails here."""
    import jax
    import jax.numpy as jnp
    from mitsuba2_tpu.core import qmc as jq
    v, _ = _u32_inputs(seed=3)
    np.testing.assert_array_equal(REFS.get("radical_inverse_3"), np.asarray(
        jax.jit(lambda i: jq.radical_inverse(i, 3))(jnp.asarray(v))))


def test_unknown_sampler_refused():
    with pytest.raises(ValueError, match="sobol"):
        mt.RenderConfig(sampler="sobol")
