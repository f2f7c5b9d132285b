"""Checkpoints and long renders of the PyTorch port
(mitsuba2_tpu_torch/dist/checkpoint.py, utils/observability.py) against
tests/test_checkpoint_qmc.py's cases and the JAX package's files.

- save/load round trip, nested dicts, lists and tuples; a JAX-written
  checkpoint read by the port and a port-written one read by the JAX
  package's `load`, leaf for leaf (the JAX package's dist/checkpoint.py
  is numpy and jax.tree alone: run live);
- CheckpointedRender interrupted after 2 of 4 passes and resumed equals
  the uninterrupted render exactly, and the JAX package's render within
  rtol 1e-4 / atol 1e-5 (tests/goldens/test_torch_checkpoint.npz);
- render_instrumented: one JSONL record a pass, the image render()'s bit
  for bit, a cancel after two passes the two-pass render's, a cancel
  before the first pass the JAX package's error.
"""
import json
import threading

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.dist import checkpoint as ck
from mitsuba2_tpu_torch.render.integrators import pass_seeds, render_pass
from mitsuba2_tpu_torch.utils.observability import (RenderMonitor,
                                                     render_instrumented)

from goldens.jax_refs import Refs

torch.set_num_threads(1)

REFS = Refs("test_torch_checkpoint")
# tests/test_checkpoint_qmc.py's configs
RESUME_CFG = dict(width=8, height=8, spp=16, spp_per_pass=4, max_depth=2)
CANCEL_CFG = dict(width=16, height=16, spp=16, spp_per_pass=4, max_depth=2,
                  rr_depth=99)


def _state(lib):
    """A nested state of each kind of node, in torch or (lib "jax") jnp."""
    if lib == "jax":
        import jax.numpy as jnp
        arr, i32 = jnp.asarray, jnp.int32
    else:
        arr, i32 = torch.as_tensor, torch.int32
    return {"b": (arr(np.zeros(3, np.float32)), arr(np.int32(7))),
            "a": arr(np.arange(5.0, dtype=np.float32)),
            "c": [arr(np.full((2, 2), 0.5, np.float32)),
                  {"z": arr(np.ones(1, np.float32)),
                   "y": arr(np.array([1, 2], np.int32))}]}


# the leaves in the JAX package's order: dict keys sorted, sequences in order
LEAVES = [np.arange(5.0), np.zeros(3), np.int32(7), np.full((2, 2), 0.5),
          np.array([1, 2]), np.ones(1)]


def test_save_load_roundtrip(tmp_path):
    state = _state("torch")
    p = str(tmp_path / "s.npz")
    ck.save(p, state, step=42, meta={"note": "hi"})
    loaded, step, meta = ck.load(p, like=state, device="cpu")
    assert step == 42 and meta["note"] == "hi"
    assert isinstance(loaded["b"], tuple) and isinstance(loaded["c"], list)
    np.testing.assert_array_equal(loaded["a"].numpy(), np.arange(5.0))
    assert int(loaded["b"][1]) == 7 and loaded["b"][1].dtype == torch.int32
    np.testing.assert_array_equal(loaded["c"][1]["y"].numpy(), [1, 2])
    leaves, _, _ = ck.load(p, device="cpu")
    for got, want in zip(leaves, LEAVES, strict=True):
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="6 leaves"):
        ck.load(p, like={"a": state["a"]}, device="cpu")


def test_jax_written_checkpoint_loads_in_the_port(tmp_path):
    from mitsuba2_tpu.dist import checkpoint as jck
    p = str(tmp_path / "jax.npz")
    jck.save(p, _state("jax"), step=3, meta={"by": "jax"})
    leaves, step, meta = ck.load(p, device="cpu")
    assert step == 3 and meta == {"by": "jax"}
    for got, want in zip(leaves, LEAVES, strict=True):
        np.testing.assert_array_equal(got.numpy(), want)
    state, _, _ = ck.load(p, like=_state("torch"), device="cpu")
    assert int(state["b"][1]) == 7 and state["c"][1]["z"].shape == (1,)


def test_port_written_checkpoint_loads_in_jax(tmp_path):
    from mitsuba2_tpu.dist import checkpoint as jck
    p = str(tmp_path / "port.npz")
    ck.save(p, _state("torch"), step=5, meta={"by": "port"})
    leaves, step, meta = jck.load(p)
    assert step == 5 and meta == {"by": "port"}
    for got, want in zip(leaves, LEAVES, strict=True):
        np.testing.assert_array_equal(np.asarray(got), want)
    state, _, _ = jck.load(p, like=_state("jax"))
    assert int(state["b"][1]) == 7


def _jax_render(cfg, seed=None, **scene_kw):
    import mitsuba2_tpu as mi
    from mitsuba2_tpu.render.integrators import render
    from mitsuba2_tpu.scene.presets import cornell_box
    return np.asarray(render(cornell_box(**scene_kw), mi.RenderConfig(**cfg),
                             seed=seed))


def test_checkpointed_render_resumes_exactly(tmp_path):
    """Interrupted after 2 of 4 passes and resumed: render()'s image,
    bit for bit."""
    scene = mt.cornell_box(boxes=False, device="cpu")
    cfg = mt.RenderConfig(**RESUME_CFG)
    seeds = pass_seeds(cfg.seed, 4)
    ref = mt.render(scene, cfg, device="cpu")

    path = str(tmp_path / "film.npz")
    run1 = ck.CheckpointedRender(path, every=1, device="cpu")
    assert run1.resume() == 0
    for p in range(2):  # "crash" after 2 passes
        run1.update(*render_pass(scene, cfg, seeds[p], "cpu"), p)

    run2 = ck.CheckpointedRender(path, every=1, device="cpu")
    start = run2.resume()
    assert start == 2
    for p in range(start, 4):
        run2.update(*render_pass(scene, cfg, seeds[p], "cpu"), p)
    out = run2.develop()
    assert torch.equal(out, ref)
    np.testing.assert_allclose(
        out.numpy(), REFS.get("resume", lambda: _jax_render(
            RESUME_CFG, boxes=False)), rtol=1e-4, atol=1e-5)


def test_render_instrumented_jsonl_and_image(tmp_path):
    scene = mt.cornell_box(device="cpu")
    cfg = mt.RenderConfig(**CANCEL_CFG)
    jsonl = str(tmp_path / "m.jsonl")
    img, mon = render_instrumented(scene, cfg, seed=1, jsonl_path=jsonl,
                                   device="cpu")
    recs = [json.loads(ln) for ln in open(jsonl)]
    assert [r["pass"] for r in recs] == [0, 1, 2, 3] and recs == mon.records
    for r in recs:
        assert r["mrays_s"] > 0 and r["eta_s"] >= 0
        assert len(r["occupancy"]) == cfg.max_depth
        assert 0 < r["occupancy"][-1] <= r["occupancy"][0] <= 1
    assert not mon.cancelled
    assert torch.equal(img, mt.render(scene, cfg, seed=1, device="cpu"))
    np.testing.assert_allclose(
        img.numpy(), REFS.get("instrumented", lambda: _jax_instrumented()),
        rtol=1e-4, atol=1e-5)


def _jax_instrumented():
    import mitsuba2_tpu as mi
    from mitsuba2_tpu.scene.presets import cornell_box
    from mitsuba2_tpu.utils.observability import render_instrumented as jri
    img, _ = jri(cornell_box(), mi.RenderConfig(**CANCEL_CFG), seed=1)
    return np.asarray(img)


def test_render_cancel_partial_image():
    """Integrator::cancel: cancelled after two passes, the image is the
    two-pass render's, close to the full one; cancelled before the first
    pass, an error."""
    scene = mt.cornell_box(device="cpu")
    cfg = mt.RenderConfig(**CANCEL_CFG)
    calls = {"n": 0}

    def cancel():
        calls["n"] += 1
        return calls["n"] > 2  # allow two passes

    img, mon = render_instrumented(scene, cfg, seed=1, cancel=cancel,
                                   device="cpu")
    assert mon.cancelled and len(mon.records) == 2
    assert torch.equal(img, mt.render(scene, cfg.replace(spp=8), seed=1,
                                      device="cpu"))
    full = mt.render(scene, cfg, seed=1, device="cpu")
    assert float((img - full).abs().mean()) < 0.15
    ev = threading.Event()
    ev.set()
    with pytest.raises(RuntimeError, match="cancelled before the first"):
        render_instrumented(scene, cfg, seed=1, cancel=ev, device="cpu")


def test_monitor_writes_on_the_coordinator_alone(tmp_path):
    import io
    out = [str(tmp_path / f"{r}.jsonl") for r in range(2)]
    streams = [io.StringIO(), io.StringIO()]
    for r, host0 in enumerate((True, False)):
        mon = RenderMonitor(2, jsonl_path=out[r], stream=streams[r],
                            is_host0=host0)
        mon.update(0, 0.5, 10**6, occupancy=[1.0, 0.5])
        assert mon.records[0]["mrays_s"] == 2.0
    assert len(open(out[0]).readlines()) == 1 and "1/2" in streams[0].getvalue()
    assert not (tmp_path / "1.jsonl").exists() and not streams[1].getvalue()
    assert RenderMonitor(1).is_host0  # no group: the coordinator


def test_golden_is_fresh():
    stored, live = REFS.fresh("resume", lambda: _jax_render(
        RESUME_CFG, boxes=False))
    np.testing.assert_array_equal(stored, live)
