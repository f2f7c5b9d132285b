"""Wavefront compaction of the PyTorch port (kernels/compact.py,
RenderConfig(compact=True)) against tests/test_compact.py's cases and
the JAX package's kernels/compact.py.

Each lane carries its own sampler state, which the permutation moves
with it, so a compacted render draws and decides what the uncompacted
one does: the images agree within tests/test_compact.py's rtol 1e-5 /
atol 1e-6 (bit for bit in the port, where every per-lane operation
rounds alike in any order), and with the JAX package's compacted render
(tests/goldens/test_torch_compact.npz) within rtol 1e-4 / atol 1e-5, the
limits of the port's other renders against the JAX package's.
"""
import dataclasses

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.core.vec import Vec3
from mitsuba2_tpu_torch.kernels import compact
from mitsuba2_tpu_torch.render import integrators as ti
from mitsuba2_tpu_torch.render.sampler import make_sampler

from goldens.jax_refs import Refs

torch.set_num_threads(1)

REFS = Refs("test_torch_compact")
# tests/test_compact.py's config
CFG = dict(width=16, height=16, spp=8, spp_per_pass=8, max_depth=4,
           rr_depth=3)


def _points(n=256, seed=4):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1.0, 2.0, (n, 3)).astype(np.float32)
    active = rng.random(n) < 0.6
    return p, active


def _jax_order(p, active):
    import jax.numpy as jnp
    from mitsuba2_tpu.kernels import compact as jcompact
    return np.asarray(jcompact.compaction_order(
        jnp.asarray(active), jnp.asarray(p), jnp.zeros(3), jnp.ones(3)))


def test_morton_orders_locality():
    p = torch.tensor([[0.1, 0.1, 0.1], [0.11, 0.1, 0.1],
                      [0.9, 0.9, 0.9], [0.12, 0.11, 0.1]])
    codes = compact.morton3(Vec3(p[:, 0], p[:, 1], p[:, 2]), torch.zeros(3),
                            torch.ones(3)).tolist()
    # near points get near codes; the far point is far in code space
    assert abs(codes[0] - codes[1]) < abs(codes[0] - codes[2])


def test_unsort_inverts_permutation():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(64, 3)).astype(np.float32))
    perm = torch.as_tensor(rng.permutation(64))
    orig = torch.arange(64)[perm]
    assert torch.equal(compact.unsort(x[perm], orig), x)


def test_compaction_order_matches_jax():
    """Live lanes first in Morton order, dead lanes last, ties in lane
    order: the JAX package's permutation, index for index."""
    p, active = _points()
    perm = compact.compaction_order(
        torch.as_tensor(active), Vec3(*map(torch.as_tensor, p.T)),
        torch.zeros(3), torch.ones(3))
    np.testing.assert_array_equal(perm.numpy(), REFS.get(
        "order", lambda: _jax_order(p, active)))
    assert active[perm.numpy()[:active.sum()]].all()


@pytest.mark.parametrize("kind", ["independent", "stratified", "ldsampler"])
def test_permute_moves_the_sampler_with_its_lane(kind):
    """A permuted sampler draws, lane for lane, the permuted draws: the
    sampler's per-lane state moves with the rest of the carry."""
    lane = torch.arange(64)
    s = make_sampler(kind, 5, lane, 16, 4)
    perm = torch.as_tensor(np.random.default_rng(1).permutation(64))
    u, _ = s.next_1d()
    v, _ = compact.permute(s, perm).next_1d()
    assert torch.equal(v, u[perm])
    assert dataclasses.is_dataclass(compact.permute(s, perm))


def test_compacted_render_matches_uncompacted():
    scene = mt.cornell_box(device="cpu")
    cfg = mt.RenderConfig(**CFG)
    a = mt.render(scene, cfg, device="cpu").numpy()
    b = mt.render(scene, cfg.replace(compact=True), device="cpu").numpy()
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def _jax_compacted():
    import mitsuba2_tpu as mi
    from mitsuba2_tpu.render.integrators import render
    from mitsuba2_tpu.scene.presets import cornell_box
    return np.asarray(render(cornell_box(),
                             mi.RenderConfig(**CFG, compact=True)))


def test_compacted_render_matches_jax():
    """The port's compacted render against the JAX package's, and its
    bounces really permuted (a wavefront of dead and live lanes is not
    in lane order after the first bounce)."""
    scene = mt.cornell_box(device="cpu")
    perms = []
    orig_order = compact.compaction_order

    def spy(*a):
        perms.append(orig_order(*a))
        return perms[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(compact, "compaction_order", spy)
        img = ti.render(scene, mt.RenderConfig(**CFG, compact=True),
                        device="cpu").numpy()
    assert len(perms) == CFG["max_depth"] - 1
    assert any(not torch.equal(p, torch.arange(p.numel())) for p in perms)
    np.testing.assert_allclose(img, REFS.get("render", _jax_compacted),
                               rtol=1e-4, atol=1e-5)


def test_golden_is_fresh():
    p, active = _points()
    stored, live = REFS.fresh("order", lambda: _jax_order(p, active))
    np.testing.assert_array_equal(stored, live)
