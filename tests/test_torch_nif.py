"""The neural shadow oracle of the PyTorch port (render/nif.py) against
the JAX package's.

Inference is exact with carried weights: a ShadowNIF the JAX package
trained on the Cornell box (its arrays committed in
tests/goldens/test_torch_nif.npz, carried by
convert.shadow_nif_from_numpy) answers 65 536 seeded shadow segments as
the JAX nif_ray_test answers them, on every lane but those whose JAX
logit lies within 1e-5 of 0 (counted and printed), and a scene carrying
it routes scene.ray_test through it, before any backend. Training is
statistical, as the two packages draw their segments with different
generators (jax.random, a torch.Generator): a short port training on
the Cornell box (1 000 Adam steps of 4 096 over 32 768 segments, width
64, 6 octaves) reaches the held-out accuracy stated below (> 0.93; the
JAX package's training of the same size reaches 0.96 too), the JAX
package's trained weights agree as well with the port's exact test on
the port's held-out segments, and a depth-3 render through the port's
training stays near the exact one; test_nif.py's full-size
bounds (accuracy > 0.95, relative L1 < 0.2 at 3 000 steps over 131 072
segments, width 128) are held on the card by chip_smoke.py. Training
refuses an instanced scene, as the JAX package's does.
"""
import dataclasses

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.convert import NIF_FIELDS, shadow_nif_from_numpy
from mitsuba2_tpu_torch.core.geometry import Ray
from mitsuba2_tpu_torch.core.vec import Vec3
from mitsuba2_tpu_torch.render import nif as tnif
from mitsuba2_tpu_torch.scene import scene as scene_mod

from goldens.jax_refs import Refs

torch.set_num_threads(1)

REFS = Refs("test_torch_nif")
# the JAX training whose weights the port carries
JAX_TRAIN = dict(steps=1000, dataset_size=32768, width=64, n_freq=6,
                 batch=4096, seed=3)
N_SEG = 65536
# the port's short training, and the accuracy it reaches on the CPU
PORT_TRAIN = dict(steps=1000, dataset_size=32768, width=64, n_freq=6,
                  batch=4096, seed=1)
PORT_ACCURACY = 0.93   # 0.956 reached; the JAX package's 0.962 (seed 3)


def _jax_weights():
    from mitsuba2_tpu.render.nif import train_shadow_nif
    from mitsuba2_tpu.scene.presets import cornell_box
    nif = train_shadow_nif(cornell_box(), **JAX_TRAIN)
    out = {k: np.asarray(getattr(nif, k)) for k in NIF_FIELDS}
    out["n_freq"] = np.int64(nif.n_freq)
    return out


def _segments():
    """N_SEG shadow segments across the Cornell box's volume."""
    rng = np.random.default_rng(11)
    a = rng.uniform([-1, 0, -1], [1, 2, 1], (N_SEG, 3)).astype(np.float32)
    b = rng.uniform([-1, 0, -1], [1, 2, 1], (N_SEG, 3)).astype(np.float32)
    d = b - a
    dist = np.linalg.norm(d, axis=1).astype(np.float32)
    return a, (d / dist[:, None]).astype(np.float32), dist


def _jax_logits(w):
    import jax.numpy as jnp
    from mitsuba2_tpu.core.vec import Vec3 as JVec3
    from mitsuba2_tpu.render import nif as jnif
    nif = jnif.ShadowNIF(**{k: jnp.asarray(w[k]) for k in NIF_FIELDS},
                         n_freq=int(w["n_freq"]))
    a, d, dist = _segments()
    o, dv = JVec3(*jnp.asarray(a.T)), JVec3(*jnp.asarray(d.T))
    t = jnp.minimum(jnp.asarray(dist), 1e6)
    feats = jnif._encode(nif, o.x, o.y, o.z, o.x + dv.x * t,
                         o.y + dv.y * t, o.z + dv.z * t, dv.x, dv.y, dv.z)
    return (np.asarray(jnif._logits(nif, feats)),
            np.asarray(jnif.nif_ray_test(nif, o, dv, jnp.asarray(dist))))


@pytest.fixture(scope="module")
def carried():
    w = REFS.get("jax_weights", _jax_weights)
    return w, shadow_nif_from_numpy(w, device="cpu")


def _port_segments():
    a, d, dist = _segments()
    return (Vec3(*torch.from_numpy(a.T.copy())),
            Vec3(*torch.from_numpy(d.T.copy())), torch.from_numpy(dist))


def test_inference_matches_jax_with_carried_weights(carried):
    w, nif = carried
    logits_j, occ_j = REFS.get("jax_logits", lambda: _jax_logits(w))
    o, d, dist = _port_segments()
    logits = tnif.nif_logits(nif, o, d, dist).numpy()
    occ = tnif.nif_ray_test(nif, o, d, dist).numpy()
    near = np.abs(logits_j) < 1e-5
    differ = occ != occ_j
    print(f"{int(near.sum())} of {N_SEG} lanes within 1e-5 of the "
          f"decision; {int(differ.sum())} lanes differ, largest logit gap "
          f"{np.abs(logits - logits_j).max():.3e}")
    assert not (differ & ~near).any()
    np.testing.assert_allclose(logits, logits_j, atol=1e-4, rtol=1e-4)
    assert 0.0 < occ.mean() < 1.0   # both answers occur


def test_golden_is_fresh(carried):
    w, _ = carried
    stored, live = REFS.fresh("jax_logits", lambda: _jax_logits(w))
    np.testing.assert_array_equal(stored[1], live[1])
    np.testing.assert_allclose(stored[0], live[0], atol=1e-6)


def test_scene_routes_ray_test_through_the_nif(carried):
    _, nif = carried
    scene = mt.cornell_box(device="cpu")
    assert scene.shadow_nif is None
    o, d, dist = _port_segments()
    ray = Ray.make(o, d, maxt=dist)
    exact = scene_mod.ray_test(scene, ray)
    routed = scene_mod.ray_test(dataclasses.replace(scene, shadow_nif=nif),
                                ray)
    assert torch.equal(routed, tnif.nif_ray_test(nif, o, d, dist))
    assert not torch.equal(routed, exact)   # approximate, not the walk
    # a float64 render's segments are rounded to the weights' dtype
    o64 = Vec3(o.x.double(), o.y.double(), o.z.double())
    d64 = Vec3(d.x.double(), d.y.double(), d.z.double())
    assert torch.equal(tnif.nif_ray_test(nif, o64, d64, dist.double()),
                       tnif.nif_ray_test(nif, o, d, dist))
    # the JAX package's training agrees with the port's exact test on the
    # port's held-out NEE segments as it agrees with its own
    acc = tnif.accuracy(nif, scene)
    print(f"carried weights' held-out accuracy: {acc:.4f}")
    assert acc > PORT_ACCURACY


@pytest.fixture(scope="module")
def trained():
    scene = mt.cornell_box(device="cpu")
    return scene, mt.train_shadow_nif(scene, **PORT_TRAIN)


def test_short_training_accuracy(trained):
    scene, nif = trained
    acc = tnif.accuracy(nif, scene)
    print(f"held-out accuracy after {PORT_TRAIN['steps']} steps: {acc:.4f}")
    assert acc > PORT_ACCURACY


def test_render_through_trained_nif_close(trained):
    scene, nif = trained
    cfg = mt.RenderConfig(width=16, height=16, spp=16, spp_per_pass=16,
                          max_depth=3, rr_depth=99)
    exact = mt.render(scene, cfg, device="cpu").numpy()
    approx = mt.render(dataclasses.replace(scene, shadow_nif=nif), cfg,
                       device="cpu").numpy()
    rel = np.abs(approx - exact).mean() / exact.mean()
    print(f"relative L1 {rel:.4f}")
    assert rel < 0.3 and not np.allclose(approx, exact)


def test_training_refuses_instanced_scene():
    import os
    os.environ["MI_FLATTEN_INSTANCES"] = "0"
    try:
        scene = mt.instanced_field(n=4, subdiv=1, device="cpu")
    finally:
        del os.environ["MI_FLATTEN_INSTANCES"]
    assert scene.has_instances
    with pytest.raises(ValueError, match="instance"):
        mt.train_shadow_nif(scene, steps=1, dataset_size=1024)
