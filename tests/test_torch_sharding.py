"""The port's multi-process layer (mitsuba2_tpu_torch/dist/sharding.py)
against its one-process renders and against the JAX package's
dist/sharding.py on conftest's 8-device mesh.

The determinism contract (tests/test_sharding.py's): a rank renders its
share of each pass at its lane offset, so the ranks together draw every
number one process draws, and the images and gradients agree to the
film's summation order. Checked three ways:

- in one process, with no group: the passes of N = 1, 2, 4 and 8 ranks'
  lane offsets, summed, equal the whole pass (an offset that a 2-rank
  group would hide shows at 4 or 8);
- two gloo ranks, spawned once for the module (a FileStore under a
  temporary directory), run the cases of tests/test_sharding.py and
  tests/test_sharded_reparam.py at their sizes: the pass, the render,
  the adjoint's gradients, four train steps, a checkpoint resumed, the
  heterogeneous volpath render, the reparameterized render and its
  gradients, and the stratified sampler's render; each rank's results
  are the other's;
- each case against the port's one-process result and the JAX package's
  sharded one (tests/goldens/test_torch_sharding.npz, python
  tests/goldens/make_refs.py test_torch_sharding), at the JAX tests'
  tolerances. The stratified sampler stratifies over a rank's samples,
  so its sharded render is held to the JAX package's sharded render
  alone.
"""
import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.core.geometry import Transform4
from mitsuba2_tpu_torch.diff import adjoint as adjoint_mod
from mitsuba2_tpu_torch.diff import optimizers as opt_mod
from mitsuba2_tpu_torch.dist import checkpoint as ckpt_mod
from mitsuba2_tpu_torch.dist import multihost, sharding
from mitsuba2_tpu_torch.render.integrators import render_pass
from mitsuba2_tpu_torch.scene import shapes as tshapes

from goldens.jax_refs import Refs

# one intra-op thread: the suite's test processes share the cores
# (pytest-xdist), and torch's OpenMP regions stall when they
# oversubscribe them; the spawned ranks import this module too
torch.set_num_threads(1)

REFS = Refs("test_torch_sharding")
# tests/test_sharding.py's config and its seeds; test_sharded_reparam's
CFG = dict(width=32, height=32, spp=16, spp_per_pass=16, max_depth=3)
CFG8 = {**CFG, "spp": 8, "spp_per_pass": 8}
VOL_CFG = {**CFG8, "integrator": "volpath"}
REPARAM_CFG = dict(width=16, height=16, spp=16, spp_per_pass=16,
                   max_depth=2, reparam=True)
REPARAM_GRAD_CFG = dict(width=12, height=12, spp=8, spp_per_pass=8,
                        max_depth=2, reparam=True)
TRAIN_SEEDS = (1, 2, 3, 4)
# the ranks' whole run: their imports, scene builds and every case
RANKS_TIMEOUT = 300


def _target(shape):
    return np.random.default_rng(0).random(shape).astype(np.float32)


def _vol_scene(shapes, build, **kw):
    """tests/test_sharding.py's heterogeneous cube over an emitting
    wall."""
    cube = shapes.cube(bsdf={"type": "null"}, id="vol").transformed(
        np.asarray((Transform4.scale([1.5, 1.5, 0.5])).matrix))
    cube.interior = {"type": "heterogeneous", "sigma_t": 1.0,
                     "albedo": 0.6,
                     "density": np.random.default_rng(5).uniform(
                         0.2, 1.0, (4, 4, 4)).astype(np.float32),
                     "bbox_min": [-1.5, -1.5, -0.5],
                     "bbox_max": [1.5, 1.5, 0.5]}
    wall = shapes.rectangle(
        bsdf={"type": "diffuse", "reflectance": [0.4] * 3},
        emitter={"type": "area", "radiance": [2.0] * 3},
        id="wall").transformed(
        np.asarray(Transform4.translate([0, 0, -2.0]).matrix))
    cam = Transform4.look_at(origin=[0, 0, 4], target=[0, 0, 0],
                             up=[0, 1, 0])
    return build([cube, wall],
                 {"type": "perspective",
                  "to_world": np.asarray(cam.matrix), "fov": 30.0}, **kw)


def _l2(target):
    t = torch.as_tensor(target)
    return lambda img: torch.mean((img - t) ** 2)


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_np(v) for v in x)
    return x.detach().cpu().numpy() if torch.is_tensor(x) else x


# ---------------------------------------------------------------------------
# the cases, run alike by each rank of a group
# ---------------------------------------------------------------------------

def _sharded_cases(mesh, ckpt_dir):
    cornell = mt.cornell_box(device="cpu")
    cfg, cfg8 = mt.RenderConfig(**CFG), mt.RenderConfig(**CFG8)
    out = {"pass": sharding.render_pass_sharded(cornell, cfg, 7, mesh),
           "render": sharding.render_sharded(cornell, cfg, mesh, seed=3),
           "adjoint": sharding.render_and_grad_sharded(
               cornell, cfg8, _l2(_target((32, 32, 3))), mesh, seed=5),
           "stratified": sharding.render_sharded(
               cornell, cfg.replace(sampler="stratified"), mesh, seed=3)}

    # four Adam steps toward half the scene's render
    target = mt.render(cornell, cfg8, seed=11, device="cpu") * 0.5
    s, opt, losses = cornell, None, []
    for i in TRAIN_SEEDS:
        s, opt, loss, _ = sharding.train_step_sharded(s, cfg8, target, i,
                                                      mesh, opt_state=opt)
        losses.append(float(loss))
    out["train"] = {"losses": losses, "step": int(opt["step"]),
                    "mat_data": s.mat_data, "emitter_data": s.emitter_data}

    # three steps toward black, a checkpoint after two: the third step
    # run on, and run again from the checkpoint as a restarted job would
    zero = torch.zeros((32, 32, 3))
    s, opt = cornell, None
    for i in range(2):
        s, opt, _, _ = sharding.train_step_sharded(s, cfg8, zero, i, mesh,
                                                   opt_state=opt)
    path = os.path.join(ckpt_dir, "opt.npz")
    state = {"tables": adjoint_mod.diff_tables(s), "opt": opt}
    if multihost.is_coordinator():
        ckpt_mod.save(path, state, step=2)
    if mesh.grouped:
        torch.distributed.barrier()
    s_a, _, loss_a, _ = sharding.train_step_sharded(s, cfg8, zero, 2, mesh,
                                                    opt_state=opt)
    restored, step, _ = ckpt_mod.load(path, like=state, device="cpu")
    s_c = adjoint_mod.with_tables(cornell, restored["tables"])
    s_c, _, loss_c, _ = sharding.train_step_sharded(
        s_c, cfg8, zero, 2, mesh, opt_state=restored["opt"])
    out["resume"] = {"step": step, "mat_a": s_a.mat_data,
                     "loss_a": float(loss_a), "mat_c": s_c.mat_data,
                     "loss_c": float(loss_c)}

    out["volpath"] = sharding.render_sharded(
        _vol_scene(tshapes, mt.build_scene, device="cpu"),
        mt.RenderConfig(**VOL_CFG), mesh, seed=4)
    out["reparam"] = sharding.render_sharded(
        cornell, mt.RenderConfig(**REPARAM_CFG), mesh, seed=5)
    out["reparam_grads"] = sharding.render_and_grad_sharded(
        cornell, mt.RenderConfig(**REPARAM_GRAD_CFG),
        _l2(np.zeros((12, 12, 3), np.float32)), mesh, seed=3)
    return _np(out)


def _rank_main(rank, world, store, out_path, ckpt_dir):
    """A rank of the module's group: every case, its results saved."""
    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", store=torch.distributed.FileStore(store, world), rank=rank,
        world_size=world)
    try:
        res = _sharded_cases(sharding.make_mesh(device="cpu"), ckpt_dir)
        torch.save(res, out_path)
    finally:
        torch.distributed.destroy_process_group()


def spawn_ranks(d, fn, world, timeout, *args):
    """fn(rank, world, store, out_path, *args) in `world` spawned
    processes, their files in directory `d`; returns each rank's saved
    results. A rank still running after `timeout` s is killed and the
    test fails."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=fn, args=(r, world, f"{d}/store",
                                          f"{d}/out{r}.pt", *args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if hung:
        pytest.fail(f"ranks {hung} still running after {timeout} s")
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"the ranks exited with {codes}"
    return [torch.load(f"{d}/out{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two gloo ranks' results (rank 0's), after checking that both
    ranks returned the same."""
    d = tmp_path_factory.mktemp("ranks")
    r0, r1 = spawn_ranks(d, _rank_main, 2, RANKS_TIMEOUT, str(d))
    _same(r0, r1)
    return r0


def _same(a, b, path="ranks"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}/{i}")
    else:
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.fixture(scope="module")
def cornell():
    return mt.cornell_box(device="cpu")


# ---------------------------------------------------------------------------
# the JAX package's sharded results (recorded)
# ---------------------------------------------------------------------------

def _jax_mesh(n=8):
    import jax
    from mitsuba2_tpu.dist.sharding import make_mesh
    return make_mesh(jax.devices()[:n])


def _jax(key):
    return REFS.get(key, lambda: _JAX[key]())


def _jax_pass():
    import jax.numpy as jnp
    import mitsuba2_tpu as mi
    from mitsuba2_tpu.dist.sharding import render_pass_sharded
    from mitsuba2_tpu.scene.presets import cornell_box
    img, w = render_pass_sharded(cornell_box(), mi.RenderConfig(**CFG),
                                 jnp.uint32(7), _jax_mesh())
    return np.asarray(img), np.asarray(w)


def _jax_render(cfg, seed, scene=None, mesh=None):
    import mitsuba2_tpu as mi
    from mitsuba2_tpu.dist.sharding import render_sharded
    from mitsuba2_tpu.scene.presets import cornell_box
    return np.asarray(render_sharded(
        cornell_box() if scene is None else scene, mi.RenderConfig(**cfg),
        mesh=mesh or _jax_mesh(), seed=seed))


def _jax_grad(cfg, target, seed, mesh=None):
    import jax.numpy as jnp
    import mitsuba2_tpu as mi
    from mitsuba2_tpu.dist.sharding import render_and_grad_sharded
    from mitsuba2_tpu.scene.presets import cornell_box
    t = jnp.asarray(target)
    img, loss, g = render_and_grad_sharded(
        cornell_box(), mi.RenderConfig(**cfg),
        lambda im: jnp.mean((im - t) ** 2), mesh or _jax_mesh(), seed=seed)
    return (np.asarray(img), float(loss),
            {k: np.asarray(v) for k, v in g.items()})


def _jax_train():
    import mitsuba2_tpu as mi
    from mitsuba2_tpu.dist.sharding import train_step_sharded
    from mitsuba2_tpu.render.integrators import render
    from mitsuba2_tpu.scene.presets import cornell_box
    scene, mesh, cfg = cornell_box(), _jax_mesh(), mi.RenderConfig(**CFG8)
    target = render(scene, cfg, seed=11) * 0.5
    s, opt, losses = scene, None, []
    for i in TRAIN_SEEDS:
        s, opt, loss, _ = train_step_sharded(s, cfg, target, i, mesh,
                                             opt_state=opt)
        losses.append(float(loss))
    return {"losses": losses, "mat_data": np.asarray(s.mat_data),
            "emitter_data": np.asarray(s.emitter_data)}


def _jax_resume():
    """The uninterrupted three steps toward black."""
    import jax.numpy as jnp
    import mitsuba2_tpu as mi
    from mitsuba2_tpu.dist.sharding import train_step_sharded
    from mitsuba2_tpu.scene.presets import cornell_box
    s, opt, mesh = cornell_box(), None, _jax_mesh()
    for i in range(3):
        s, opt, loss, _ = train_step_sharded(
            s, mi.RenderConfig(**CFG8), jnp.zeros((32, 32, 3), jnp.float32),
            i, mesh, opt_state=opt)
    return {"mat_data": np.asarray(s.mat_data), "loss": float(loss)}


def _jax_volpath():
    from mitsuba2_tpu.scene import shapes as jshapes
    from mitsuba2_tpu.scene.scene import build_scene
    return _jax_render(VOL_CFG, 4, _vol_scene(jshapes, build_scene))


def _jax_reparam():
    from mitsuba2_tpu.dist.sharding import make_mesh
    return _jax_render(REPARAM_CFG, 5, mesh=make_mesh())


def _jax_reparam_grads():
    from mitsuba2_tpu.dist.sharding import make_mesh
    return _jax_grad(REPARAM_GRAD_CFG, np.zeros((12, 12, 3), np.float32), 3,
                     make_mesh())


_JAX = {"pass": _jax_pass,
        "render": lambda: _jax_render(CFG, 3),
        # two devices, as the port's two ranks: each stratifies over
        # its own share
        "stratified": lambda: _jax_render(
            {**CFG, "sampler": "stratified"}, 3, mesh=_jax_mesh(2)),
        "adjoint": lambda: _jax_grad(CFG8, _target((32, 32, 3)), 5),
        "train": _jax_train, "resume": _jax_resume, "volpath": _jax_volpath,
        "reparam": _jax_reparam, "reparam_grads": _jax_reparam_grads}


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_lane_offsets_sum_to_the_pass(cornell, n):
    """N ranks' passes at their lane offsets, in one process, add up to
    the whole pass (tests/test_sharding.py's pass tolerance)."""
    cfg = mt.RenderConfig(**CFG)
    full, w_full = render_pass(cornell, cfg, 7, "cpu")
    local = cfg.replace(spp_per_pass=cfg.spp_per_pass // n)
    n_local = local.spp_per_pass * local.height * local.width
    img, w = 0, 0
    for r in range(n):
        img_r, w_r = render_pass(cornell, local, 7, "cpu",
                                 lane_offset=r * n_local)
        img, w = img + img_r, w + w_r
    assert w == w_full
    np.testing.assert_allclose(img.numpy(), full.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_render_pass_sharded_matches_single(ranks, cornell):
    img, w = ranks["pass"]
    img_1, w_1 = render_pass(cornell, mt.RenderConfig(**CFG), 7, "cpu")
    img_j, w_j = _jax("pass")
    for ref_img, ref_w in ((img_1.numpy(), w_1), (img_j, w_j)):
        np.testing.assert_allclose(img, ref_img, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(w, ref_w, rtol=2e-5, atol=2e-5)


def test_render_sharded_matches_single(ranks, cornell):
    single = mt.render(cornell, mt.RenderConfig(**CFG), seed=3,
                       device="cpu").numpy()
    for ref in (single, _jax("render")):
        np.testing.assert_allclose(ranks["render"], ref, rtol=2e-4,
                                   atol=2e-5)


def test_stratified_matches_jax_sharded(ranks, cornell):
    """A rank stratifies over its own samples: the JAX package's
    render_sharded over as many devices is the reference, and the
    one-process render is another estimate."""
    np.testing.assert_allclose(ranks["stratified"], _jax("stratified"),
                               rtol=2e-4, atol=2e-5)
    single = mt.render(cornell, mt.RenderConfig(**CFG, sampler="stratified"),
                       seed=3, device="cpu").numpy()
    assert not np.allclose(ranks["stratified"], single, rtol=2e-4,
                           atol=2e-5)


def _grads_close(got, refs, rtol, atol, loss_rtol):
    img, loss, grads = got
    for ref_img, ref_loss, ref_grads in refs:
        np.testing.assert_allclose(img, ref_img, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(loss, ref_loss, rtol=loss_rtol)
        assert set(grads) == set(ref_grads)
        for k in grads:
            np.testing.assert_allclose(grads[k], ref_grads[k], rtol=rtol,
                                       atol=atol, err_msg=k)


def test_sharded_adjoint_grads_match_single(ranks, cornell):
    single = _np(adjoint_mod.render_and_grad(
        cornell, mt.RenderConfig(**CFG8), _l2(_target((32, 32, 3))), seed=5,
        device="cpu"))
    _grads_close(ranks["adjoint"], (single, _jax("adjoint")), 5e-4, 1e-6,
                 1e-4)


def test_train_step_sharded_full_adjoint(ranks, cornell):
    """tests/test_sharding.py's checks, and the losses of the same
    steps in one process and in the JAX package."""
    got = ranks["train"]
    assert got["step"] == len(TRAIN_SEEDS)
    assert got["losses"][-1] < got["losses"][0], got["losses"]
    for k in ("mat_data", "emitter_data"):
        assert np.abs(got[k] - getattr(cornell, k).numpy()).max() > 0, k
    cfg8 = mt.RenderConfig(**CFG8)
    target = mt.render(cornell, cfg8, seed=11, device="cpu") * 0.5
    s, opt, single = cornell, None, []
    for i in TRAIN_SEEDS:
        tables = adjoint_mod.diff_tables(s)
        opt = opt or opt_mod.adam_init(tables)
        _, loss, g = adjoint_mod.render_l2_grad(s, cfg8, target, seed=i,
                                                device="cpu")
        tables, opt = opt_mod.adam_step(tables, g, opt, 0.05)
        s = adjoint_mod.with_tables(s, tables)
        single.append(float(loss))
    for ref in (single, _jax("train")["losses"]):
        np.testing.assert_allclose(got["losses"], ref, rtol=1e-4)


def test_checkpoint_resume_equivalence(ranks):
    """A sharded optimization checkpointed after 2 of 3 steps and resumed
    from the file equals the uninterrupted one (tests/test_sharding.py's
    limits); its loss is the JAX package's."""
    got = ranks["resume"]
    assert got["step"] == 2
    np.testing.assert_allclose(got["mat_c"], got["mat_a"], rtol=1e-6,
                               atol=1e-8)
    np.testing.assert_allclose(got["loss_c"], got["loss_a"], rtol=1e-5)
    np.testing.assert_allclose(got["loss_a"], _jax("resume")["loss"],
                               rtol=1e-4)


def test_sharded_heterogeneous_volpath_matches_single(ranks):
    single = mt.render(_vol_scene(tshapes, mt.build_scene, device="cpu"),
                       mt.RenderConfig(**VOL_CFG), seed=4,
                       device="cpu").numpy()
    for ref in (single, _jax("volpath")):
        np.testing.assert_allclose(ranks["volpath"], ref, rtol=2e-4,
                                   atol=2e-5)


def test_reparam_render_sharded_matches_single(ranks, cornell):
    single = mt.render(cornell, mt.RenderConfig(**REPARAM_CFG), seed=5,
                       device="cpu").numpy()
    for ref in (single, _jax("reparam")):
        np.testing.assert_allclose(ranks["reparam"], ref, rtol=1e-4,
                                   atol=1e-5)


def test_reparam_grads_sharded_match_single(ranks, cornell):
    single = _np(adjoint_mod.render_and_grad(
        cornell, mt.RenderConfig(**REPARAM_GRAD_CFG),
        _l2(np.zeros((12, 12, 3), np.float32)), seed=3, device="cpu"))
    _grads_close(ranks["reparam_grads"], (single, _jax("reparam_grads")),
                 1e-3, 1e-6, 1e-4)


def test_one_rank_without_a_group_is_the_render(cornell):
    """No process group: a mesh of one rank whose all-reduce is the
    identity, and render_sharded is render bit for bit."""
    mesh = sharding.make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.grouped) == (0, 1, False)
    cfg = mt.RenderConfig(**{**CFG, "spp_per_pass": 8})
    assert torch.equal(sharding.render_sharded(cornell, cfg, mesh, seed=3),
                       mt.render(cornell, cfg, seed=3, device="cpu"))
    with pytest.raises(AssertionError, match="not divisible"):
        sharding._split_config(cfg.replace(spp_per_pass=9), 2)


def _jax_offsets():
    """Each device's lane offset on the 8-device mesh, at CFG's split."""
    import jax
    import jax.numpy as jnp
    import mitsuba2_tpu as mi
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from mitsuba2_tpu.dist.sharding import _lane_offset, _split_config
    local = _split_config(mi.RenderConfig(**CFG), 8)
    fn = shard_map(lambda x: x + _lane_offset(local)[None], mesh=_jax_mesh(),
                   in_specs=(P("d"),), out_specs=P("d"), check_vma=False)
    return np.asarray(jax.jit(fn)(jnp.zeros(8, jnp.uint32)))


def test_lane_offsets_are_the_jax_packages():
    """Rank r of 8 starts at the JAX package's device r's offset."""
    local = sharding._split_config(mt.RenderConfig(**CFG), 8)
    got = [sharding._lane_offset(local, sharding.Mesh(r, 8, "cpu"))
           for r in range(8)]
    np.testing.assert_array_equal(got, REFS.get("offsets", _jax_offsets))


def test_golden_is_fresh():
    """The JAX package's lane offsets, recomputed now."""
    stored, live = REFS.fresh("offsets", _jax_offsets)
    np.testing.assert_array_equal(stored, live)
