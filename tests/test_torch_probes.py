"""The probes of the PyTorch port (kernels/probes.py, csrc/probes.cu): the
plain twins against the CUDA source, compiled with g++ through the shim of
tests/test_torch_traverse.py and run one block at a time (one host thread
a CUDA thread, so that the shared-memory probe's barriers hold), and the
row-load twin against the TPU probe's own numpy formula
(benchmarks/probe_mxu_dma.py). The kernels themselves are held against
the twins by the card-only cases at the end (skipped without a card).

Tolerances: the twins and the source agree bit for bit (the same f32
operations in the same order). The TPU probe's numpy formula takes its
dots as a matmul, summed in another order: rtol 1e-5 / atol 1e-5 on sums
of magnitude ~10.
"""
import numpy as np
import pytest
import torch

from mitsuba2_tpu_torch.kernels import probes, traverse
from test_torch_traverse import _SHIM, emulate_source

N = 256          # lanes: two blocks of 128
R = 768          # node rows, the TPU probes' (the gallery's cut tree)
STEPS = 24

# _SHIM with one host thread a CUDA thread of a block, a std::barrier for
# __syncthreads and function statics for __shared__ arrays (the blocks of
# a launch run one after another)
_PROBE_SHIM = _SHIM.replace(
    "static dim3_ blockIdx, threadIdx, blockDim;",
    "static thread_local dim3_ threadIdx;\nstatic dim3_ blockIdx, blockDim;"
).replace("#define EMU_LAUNCH", "#define EMU_LAUNCH_SERIAL") + r"""
#include <barrier>
#include <thread>
#include <vector>
#define __shared__ static
inline std::barrier<>* emu_barrier = nullptr;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
#define EMU_LAUNCH(grid, block, kern, ...) do { \
  for (unsigned b = 0; b < (unsigned)(grid); ++b) { \
    blockIdx.x = b; blockDim.x = block; \
    std::barrier<> bar(block); emu_barrier = &bar; \
    std::vector<std::thread> th; \
    for (unsigned t = 0; t < (unsigned)(block); ++t) \
      th.emplace_back([&, t] { threadIdx.x = t; kern(__VA_ARGS__); }); \
    for (auto& x : th) x.join(); } } while (0)
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    lib = emulate_source(tmp_path_factory.mktemp("probes_emu"), probes._SRC,
                         _PROBE_SHIM, 7, std="c++20")
    probes._declare(lib)
    return lib


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def lanes(n, n_rows, divergent, device="cpu"):
    return [t(a).to(device) for a in probes.lanes(n, n_rows, divergent)]


@pytest.fixture(scope="module")
def walk():
    node, link = probes.walk_tables(R)
    return t(node), t(link)


@pytest.fixture(scope="module")
def visit():
    return tuple(t(a) for a in probes.visit_tables(n_clusters=8,
                                                    cluster_k=32))


@pytest.mark.parametrize("divergent", [False, True])
@pytest.mark.parametrize("dep", [True, False])
def test_walk_step_twin_matches_source(emulated, walk, dep, divergent):
    node, link = walk
    s, start = lanes(N, R, divergent)
    out = (torch.empty(N, dtype=torch.int32),
           torch.empty(N, dtype=torch.int32))
    assert emulated.mts_probe_walk_step(
        *(a.data_ptr() for a in (node, link, s, start, *out)), N, R, STEPS,
        int(dep), None) == 0
    stats = {}
    nd, hits = probes.walk_step_plain(node, link, s, start, STEPS, dep,
                                      stats)
    assert torch.equal(out[0], nd) and torch.equal(out[1], hits)
    assert stats == {"slab_tests": N * STEPS}
    assert 0 < int(hits.sum()) < N * STEPS     # both links are taken
    # one ray and start for every lane walk one path; scrambled lanes
    # walk apart: 32 threads of a warp at some 20 nodes of 768
    if dep:
        assert (len(torch.unique(nd)) > N // 4) == divergent


def test_row_load_twin_matches_source_and_tpu_formula(emulated):
    feat, rt = probes.row_tables(N)
    ft, rtt = t(feat), t(rt)
    steps = 6
    stats = {}
    want = probes.row_load_plain(ft, rtt, steps, stats)
    assert stats == {"rows": N * steps * probes.ROWS}
    for smem in (False, True):
        out = torch.empty(N, dtype=torch.float32)
        assert emulated.mts_probe_row_load(
            ft.data_ptr(), rtt.data_ptr(), out.data_ptr(), N, feat.shape[0],
            steps, int(smem), None) == 0
        assert torch.equal(out, want), smem
    # benchmarks/probe_mxu_dma.py's reference, its dots as a matmul
    ref = np.zeros(N, np.float32)
    for i in range(steps):
        base = (i * probes.ROWS) % feat.shape[0]
        ref += (feat[base:base + probes.ROWS] @ rt).min(0)
    np.testing.assert_allclose(want.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("divergent", [False, True])
@pytest.mark.parametrize("every", probes.EVERY)
def test_cluster_visit_twin_matches_source(emulated, visit, every,
                                           divergent):
    node, link, feat, centroid = visit
    ck = 32
    s, start = lanes(N, node.shape[0], divergent)
    out = (torch.empty(N, dtype=torch.float32),
           torch.empty(N, dtype=torch.int32))
    assert emulated.mts_probe_cluster_visit(
        *(a.data_ptr() for a in (node, link, feat, centroid, s, start,
                                 *out)), N, STEPS, feat.shape[0] // ck, ck,
        every, None) == 0
    stats = {}
    t_best, best = probes.cluster_visit_plain(node, link, feat, centroid, s,
                                              start, STEPS, every, ck, stats)
    assert torch.equal(out[0], t_best) and torch.equal(out[1], best)
    visits = stats.get("cluster_visits", 0)
    assert stats["slab_tests"] == N * STEPS
    assert stats.get("slot_tests", 0) == visits * ck
    if every == 0:
        assert visits == 0 and (best == -1).all()
    elif every == 1:
        assert visits == N * STEPS and (best >= 0).all()
    else:
        assert 0 < visits <= N * STEPS // 4


def test_cluster_visit_matches_the_walks_visit(visit):
    """P3's visit is the cluster walks' own: on one step it gives what the
    K1 twin's visit of the same rows gives the same rays."""
    node, link, feat, centroid = visit
    s, start = lanes(N, node.shape[0], True)
    t_best, best = probes.cluster_visit_plain(node, link, feat, centroid, s,
                                              start, 1, 1, 32)
    ray, _ = probes._probe_ray(s)
    closer, t_c, slot = traverse._cluster_visit(
        traverse._slot_rows(feat, torch.zeros(N, dtype=torch.int64), 32), 0,
        (torch.full((N,), 0.25), torch.full((N,), 0.5),
         torch.full((N,), 0.75)), list(ray), torch.full((N,), probes.FAR),
        32, False, None)
    assert torch.equal(best, torch.where(closer, slot, -1).int())
    assert torch.equal(t_best[closer], t_c[closer])


def test_wrappers_check_and_count(walk, visit):
    node, link = walk
    s, start = lanes(8, R, True)
    before = (probes.walk_step.launches, probes.row_load.launches,
              probes.cluster_visit.launches)
    nd, hits = probes.walk_step(node, link, s, start, 4, True)
    assert nd.shape == hits.shape == (8,) and nd.dtype == torch.int32
    feat, rt = (t(a) for a in probes.row_tables(8))
    assert probes.row_load(feat, rt, 2, True).shape == (8,)
    vn, vl, vf, vc = visit
    tb, sl = probes.cluster_visit(vn, vl, vf, vc, s, start, 4, 1, 32)
    assert tb.dtype == torch.float32 and sl.dtype == torch.int32
    # CPU tensors go to the twins: no kernel launch is counted
    assert before == (probes.walk_step.launches, probes.row_load.launches,
                      probes.cluster_visit.launches)
    with pytest.raises(ValueError, match="link"):
        probes.walk_step(node, link.long(), s, start, 4, True)
    with pytest.raises(ValueError, match="s:"):
        probes.walk_step(node, link, s.double(), start, 4, True)
    with pytest.raises(ValueError, match="start nodes"):
        probes.walk_step(node[:10], link[:10], s, start, 4, True)
    with pytest.raises(ValueError, match="multiple of 128"):
        probes.row_load(feat[:100], rt, 2, False)
    with pytest.raises(ValueError, match="every"):
        probes.cluster_visit(vn, vl, vf, vc, s, start, 4, 2, 32)
    with pytest.raises(ValueError, match="feat"):
        probes.cluster_visit(vn, vl, vf, vc, s, start, 4, 1, 48)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("divergent", [False, True])
def test_cuda_probes_match_twins(walk, visit, cuda, divergent):
    s, start = lanes(4096, R, divergent, cuda)
    node, link = (a.to(cuda) for a in walk)
    for dep in (True, False):
        before = probes.walk_step.launches
        out = probes.walk_step(node, link, s, start, STEPS, dep)
        assert probes.walk_step.launches == before + 1
        want = probes.walk_step_plain(node, link, s, start, STEPS, dep)
        assert all(torch.equal(a, b) for a, b in zip(out, want))
    feat, rt = (t(a).to(cuda) for a in probes.row_tables(4096))
    want = probes.row_load_plain(feat, rt, 6)
    for smem in (False, True):
        assert torch.equal(probes.row_load(feat, rt, 6, smem), want)
    vis = [a.to(cuda) for a in visit]
    for every in probes.EVERY:
        out = probes.cluster_visit(*vis, s, start, STEPS, every, 32)
        want = probes.cluster_visit_plain(*vis, s, start, STEPS, every, 32)
        assert all(torch.equal(a, b) for a, b in zip(out, want))
