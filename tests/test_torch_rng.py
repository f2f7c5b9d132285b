"""PCG32 and the independent sampler of the PyTorch port, bit-equal to the
canonical PCG32 and to the JAX package's streams."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba2_tpu.core import pcg32 as jpcg
from mitsuba2_tpu.render import sampler as jsampler
from mitsuba2_tpu_torch.core import pcg32
from mitsuba2_tpu_torch.render import integrators, sampler

M32 = 0xFFFFFFFF
M64 = (1 << 64) - 1
MULT = 0x5851F42D4C957F2D


def ref_stream(initstate, initseq, n):
    """Canonical PCG32 (O'Neill) on Python big ints."""
    inc = ((initseq << 1) | 1) & M64
    state = (0 * MULT + inc) & M64
    state = ((state + initstate) * MULT + inc) & M64
    out = []
    for _ in range(n):
        old = state
        state = (state * MULT + inc) & M64
        xs = (((old >> 18) ^ old) >> 27) & M32
        rot = old >> 59
        out.append(((xs >> rot) | (xs << ((-rot) & 31))) & M32)
    return out


def port_seed(initstates, initseqs):
    t = lambda vals: torch.tensor(vals, dtype=torch.int64)
    return pcg32.seed(t([s >> 32 for s in initstates]),
                      t([s & M32 for s in initstates]),
                      t([s >> 32 for s in initseqs]),
                      t([s & M32 for s in initseqs]))


def test_pcg32_known_answers():
    # pcg32_srandom(42, 54): the first outputs of the PCG reference demo
    s = port_seed([42], [54])
    got = []
    for _ in range(6):
        out, s = pcg32.next_uint32(s)
        got.append(int(out[0]))
    assert got == [0xA15C02B7, 0x7B47F409, 0xBA1D3330, 0x83D2F293,
                   0xBFA4784B, 0xCBED606E]


def test_pcg32_matches_bigint_reference():
    initstates = [0x853C49E6748FEA9B, 42, 0, 0xDEADBEEFCAFEBABE, M64]
    initseqs = [0xDA3E39CB94B95BDB, 54, 1, 0x0123456789ABCDEF, M64]
    s = port_seed(initstates, initseqs)
    refs = [ref_stream(a, b, 100) for a, b in zip(initstates, initseqs)]
    for i in range(100):
        out, s = pcg32.next_uint32(s)
        assert out.tolist() == [r[i] for r in refs]
        assert int(s.state_hi.max()) <= M32 and int(s.state_lo.min()) >= 0


@pytest.mark.parametrize("base_seed", [0, 7, 0x9E3779B1, M32])
def test_seed_lanes_match_jax(base_seed):
    lanes = np.random.default_rng(base_seed & 0xFFFF).integers(
        0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    js = jpcg.seed_lanes(base_seed, jnp.asarray(lanes))
    ts = pcg32.seed_lanes(base_seed, torch.from_numpy(lanes.astype(np.int64)))
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                      b.numpy())


@pytest.mark.parametrize("base_seed", [0, 0xDEADBEEF])
def test_sampler_streams_bit_equal(base_seed):
    """4096 lanes, 1d and 2d draws interleaved: every float bit-equal."""
    lanes = np.arange(4096, dtype=np.uint32) + np.uint32(123)
    js = jsampler.Sampler.seed(base_seed, lane_idx=jnp.asarray(lanes))
    ts = sampler.make_sampler("independent", base_seed,
                              torch.from_numpy(lanes.astype(np.int64)))
    for step in range(12):
        if step % 3 == 0:
            a, js = js.next_1d()
            b, ts = ts.next_1d()
            pairs = [(a, b)]
        else:
            (a1, a2), js = js.next_2d()
            (b1, b2), ts = ts.next_2d()
            pairs = [(a1, b1), (a2, b2)]
        for a, b in pairs:
            np.testing.assert_array_equal(
                np.asarray(a).view(np.uint32), b.numpy().view(np.uint32))


def test_float32_range_and_mean():
    s = pcg32.seed_lanes(3, torch.arange(8192))
    for _ in range(4):
        f, s = pcg32.next_float32(s)
        assert f.dtype == torch.float32
        assert float(f.min()) >= 0.0 and float(f.max()) < 1.0
        assert abs(float(f.mean()) - 0.5) < 0.02


@pytest.mark.parametrize("seed,n_passes", [(0, 1), (5, 4), (M32, 3)])
def test_pass_seeds_match_jax(seed, n_passes):
    """The port's pass seeds are the JAX package's: seed * 0x9E3779B1 + p
    (mod 2^32) for every pass, the one-pass render included."""
    want = np.asarray(jnp.uint32(seed) * jnp.uint32(0x9E3779B1)
                      + jnp.arange(n_passes, dtype=jnp.uint32))
    assert integrators.pass_seeds(seed, n_passes) == want.tolist()


def test_unknown_sampler_raises():
    with pytest.raises(NotImplementedError, match="stratified"):
        sampler.make_sampler("stratified", 0, torch.arange(4))
