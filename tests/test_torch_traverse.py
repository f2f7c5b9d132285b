"""The cluster-walk twins of the PyTorch port against the JAX package's
MXU cluster kernels (interpret-mode Pallas) and its f32 BVH2 oracle
(traverse_jnp), on mesh_gallery(subdiv=1) with the four kinds of rays a
forward render traces. The CUDA kernels themselves are held against the
twins by the card-only cases at the end (skipped without a card) and by
a CPU emulation of their source.

Tolerances:
- Exact cross-cluster ties (a ray through an edge two triangles share)
  may resolve to either prim: hit masks must be equal, prim ids equal on
  more than 99% of hit lanes, and t equal wherever the prims differ.
- vs traverse_jnp (exact f32 Möller–Trumbore): t at rtol 1e-5. The atol
  of 1e-5 covers hits at t near 0 (bounce rays into a concave corner):
  the plane form recovers t as a difference of terms of size |o - c|
  (c = cluster centroid), so its absolute error does not shrink with t.
- vs interpret-mode Pallas: t at rtol 1e-3 / atol 1e-5, as
  tests/test_traverse_pallas.py holds the MXU kernel, since the Pallas
  kernel's plane dots run in split bf16. A lane outside that band passes
  only if the port is the closer of the two to the f32 oracle.

The JAX package's answers are committed (tests/goldens/
test_torch_traverse.npz); one is recomputed live.
"""
import contextlib
import ctypes
import os
import re
import subprocess

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.core.geometry import Ray
from mitsuba2_tpu_torch.core.vec import Vec3
from mitsuba2_tpu_torch.kernels import traverse
from mitsuba2_tpu_torch.probe_rays import KINDS, probe_rays
from mitsuba2_tpu_torch.scene import scene as scene_mod

from goldens.jax_refs import Refs

# one intra-op thread: the suite's test processes share the cores
# (pytest-xdist), and torch's OpenMP regions stall when they
# oversubscribe them
torch.set_num_threads(1)

REFS = Refs("test_torch_traverse")
N_RAYS = 2048


def planar(a, device="cpu"):
    return Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])).to(device)
                  for i in range(3)))


class Case:
    """mesh_gallery(subdiv=1) in the port, the probe rays and every
    reference answer, each computed once for the module. JAX is imported
    only for the reference answers, so that the card-only cases also run
    where JAX is not installed:
    `python -m pytest --noconftest tests/test_torch_traverse.py -k cuda`."""

    def __init__(self):
        self.st = mt.mesh_gallery(subdiv=1, device="cpu")
        self.rays = probe_rays(self.st, N_RAYS, 0, self._closest_np)
        self._memo = {}

    def _closest_np(self, o, d, t_max):
        t, prim, _, _ = traverse.ray_intersect_preliminary(
            self.st, planar(o), planar(d), torch.from_numpy(t_max))
        return t.numpy(), prim.numpy(), None

    def memo(self, key, fn):
        if key not in self._memo:
            self._memo[key] = fn()
        return self._memo[key]

    def port(self, kind):
        def run():
            o, d, tm = self.rays[kind]
            t, prim, u, v = traverse.ray_intersect_preliminary(
                self.st, planar(o), planar(d), torch.from_numpy(tm))
            assert not u.any() and not v.any()
            occ = traverse.ray_test(self.st, planar(o), planar(d),
                                    torch.from_numpy(tm))
            return t.numpy(), prim.numpy(), occ.numpy()
        return self.memo(("port", kind), run)

    def ref(self, kind, which):
        """The JAX package's (t, prim, occlusion): its interpret-mode
        kernels ("pallas") or its f32 oracle ("jnp"), read from
        tests/goldens/test_torch_traverse.npz."""
        def run():
            jnp = pytest.importorskip("jax.numpy")
            from mitsuba2_tpu.core.vec import Vec3 as JVec3
            from mitsuba2_tpu.kernels import traverse_jnp, traverse_pallas
            from mitsuba2_tpu.scene import presets as jpresets
            mod = {"pallas": traverse_pallas, "jnp": traverse_jnp}[which]
            kw = {"interpret": True} if which == "pallas" else {}
            sj = self.memo("jax_scene",
                           lambda: jpresets.mesh_gallery(subdiv=1))

            def jplanar(a):
                return JVec3(*(jnp.asarray(a[:, i]) for i in range(3)))
            o, d, tm = self.rays[kind]
            t, prim, _, _ = mod.ray_intersect_preliminary(
                sj, jplanar(o), jplanar(d), jnp.asarray(tm), **kw)
            occ = mod.ray_test(sj, jplanar(o), jplanar(d), jnp.asarray(tm),
                               **kw)
            return np.asarray(t), np.asarray(prim), np.asarray(occ)
        return self.memo((which, kind), lambda: REFS.get(
            f"{which}_{kind}", run))


@pytest.fixture(scope="module")
def case():
    return Case()


def test_golden_is_fresh(case):
    """The golden's oracle answer on camera rays recomputed now: a stale
    golden (new probe rays, a new scene) fails here."""
    for a, b in zip(case.ref("camera", "jnp"), _live_jnp(case)):
        np.testing.assert_array_equal(a, b)


def _live_jnp(case):
    import jax.numpy as jnp
    from mitsuba2_tpu.core.vec import Vec3 as JVec3
    from mitsuba2_tpu.kernels import traverse_jnp
    from mitsuba2_tpu.scene import presets as jpresets
    sj = jpresets.mesh_gallery(subdiv=1)
    o, d, tm = (jnp.asarray(a) for a in case.rays["camera"])
    args = (sj, JVec3(o[:, 0], o[:, 1], o[:, 2]),
            JVec3(d[:, 0], d[:, 1], d[:, 2]), tm)
    t, prim, _, _ = traverse_jnp.ray_intersect_preliminary(*args)
    return (np.asarray(t), np.asarray(prim),
            np.asarray(traverse_jnp.ray_test(*args)))


@pytest.mark.parametrize("which", ["pallas", "jnp"])
@pytest.mark.parametrize("kind", KINDS)
def test_closest_hit_twin(case, kind, which):
    t, prim, _ = case.port(kind)
    t_r, prim_r, _ = case.ref(kind, which)
    hit = np.isfinite(t)
    np.testing.assert_array_equal(hit, np.isfinite(t_r))
    assert hit.mean() > 0.1
    np.testing.assert_array_equal(prim[~hit], -1)
    same = prim == prim_r
    assert same[hit].mean() > 0.99
    if which == "jnp":
        np.testing.assert_allclose(t[hit], t_r[hit], rtol=1e-5, atol=1e-5)
        return
    t, t_r, t_o = t[hit], t_r[hit], case.ref(kind, "jnp")[0][hit]
    band = np.isclose(t, t_r, rtol=1e-3, atol=1e-5)
    closer = np.abs(t - t_o) <= np.abs(t_r - t_o)
    assert (band | closer).all()


@pytest.mark.parametrize("which", ["pallas", "jnp"])
@pytest.mark.parametrize("kind", KINDS)
def test_any_hit_twin(case, kind, which):
    _, _, occ = case.port(kind)
    _, _, occ_r = case.ref(kind, which)
    np.testing.assert_array_equal(occ, occ_r)
    # occlusion within t_max is a hit of the closest-hit walk within it
    t, _, _ = case.port(kind)
    np.testing.assert_array_equal(occ, np.isfinite(t))


def test_presort_dispatch_matches_unsorted(case):
    """The coherence presort only reorders: closest hits and occlusion
    through the sorted dispatch equal the unsorted walk lane for lane."""
    o, d, tm = case.rays["bounce"]
    tm = tm.copy()
    tm[::7] = 0.0                           # dead lanes sort to the back
    ray = Ray(planar(o), planar(d), torch.from_numpy(tm))
    t_s, p_s, _, _, i_s = scene_mod._preliminary_dispatch(case.st, ray,
                                                          sort=True)
    t_u, p_u, _, _, i_u = scene_mod._preliminary_dispatch(case.st, ray,
                                                          sort=False)
    assert i_s is None and i_u is None
    assert torch.equal(t_s, t_u) and torch.equal(p_s, p_u)
    assert not torch.isfinite(t_s[::7]).any()
    key = scene_mod.coherence_key(case.st, ray.o, ray.d, ray.maxt)
    assert (key[::7] == 0xFFFFFFFF).all() and int(key.min()) >= 0


def test_wrapper_checks_and_counts(case):
    st = case.st
    o, d, tm = (torch.zeros(8), torch.ones(8), torch.full((8,), np.inf))
    args = (st.mxu_node_f, st.mxu_link, st.cluster_feat, o, o, o, d, d, d)
    before = (traverse.cluster_closest_hit.launches,
              traverse.cluster_any_hit.launches)
    t, slot = traverse.cluster_closest_hit(*args, tm, st.cluster_k)
    assert t.shape == (8,) and slot.dtype == torch.int32
    traverse.cluster_any_hit(*args, tm, st.cluster_k)
    # CPU tensors go to the twins: no kernel launch is counted
    assert (traverse.cluster_closest_hit.launches,
            traverse.cluster_any_hit.launches) == before
    with pytest.raises(ValueError, match="float32"):
        traverse.cluster_closest_hit(*args, tm.double(), st.cluster_k)
    with pytest.raises(ValueError, match="mxu_link"):
        traverse.cluster_any_hit(st.mxu_node_f, st.mxu_link.long(),
                                 *args[2:], tm, st.cluster_k)
    with pytest.raises(ValueError, match="cluster_feat"):
        traverse.cluster_any_hit(*args, tm, st.cluster_k + 8)


def test_twin_counts_walk_work(case):
    o, d, tm = case.rays["camera"]
    st, stats = case.st, {}
    traverse.closest_hit_plain(
        st.mxu_node_f, st.mxu_link, st.cluster_feat, *planar(o).__dict__
        .values(), *planar(d).__dict__.values(), torch.from_numpy(tm),
        st.cluster_k, chunk=500, stats=stats)
    assert stats["node_steps"] >= N_RAYS
    assert 0 < stats["cluster_visits"] < stats["node_steps"]


# ---------------------------------------------------------------------------
# The CUDA source: emulated on the CPU, and on the card where there is one
# ---------------------------------------------------------------------------

# Just enough of CUDA to run csrc/cluster_walk.cu's kernels with g++: the
# kernels' indexing, table layouts and walk logic are then checked here,
# against the twins, through the wrapper's C ABI. A launch runs its blocks
# one after another and a block's warps one after another; the 32 threads
# of a warp run as fibers on one host thread (ucontext). A warp intrinsic
# stores the lane's value and yields; once all 32 lanes have stored theirs,
# each lane reads them (two buffers, alternating, so that a lane already at
# its next intrinsic does not overwrite values another still reads). A
# warp whose lanes do not all reach the same intrinsic, or whose mask is
# not the full warp, aborts the run. Threads that use no intrinsic simply
# run to their end one after another. __syncwarp is such an exchange, and
# shared memory a static array: the warps of a launch run one at a time.
_SHIM = r"""
#pragma once
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <ucontext.h>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
#define __shared__ static
struct float4 { float x, y, z, w; };
struct int4 { int x, y, z, w; };
struct int2 { int x, y; };
inline int2 make_int2(int x, int y) { return {x, y}; }
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
struct dim3_ { unsigned x; };
static dim3_ blockIdx, threadIdx, blockDim;
// loads that fall in each of six tables, counted as the kernels make them,
// and the work that no load shows (WORK_COUNT: the slot tests on plane
// rows a lane holds in registers)
extern "C" {
const char* emu_lo[6];
const char* emu_hi[6];
long long emu_loads[6];
long long emu_work;
}
#define WORK_COUNT(n) \
  __atomic_fetch_add(&emu_work, (long long)(n), __ATOMIC_RELAXED)
template <class T> inline T __ldg(const T* p) {
  for (int i = 0; i < 6; ++i)
    if ((const char*)p >= emu_lo[i] && (const char*)p < emu_hi[i])
      __atomic_fetch_add(&emu_loads[i], 1, __ATOMIC_RELAXED);
  return *p;
}
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
inline float __uint_as_float(unsigned i) {
  float f; std::memcpy(&f, &i, 4); return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned i; std::memcpy(&i, &f, 4); return i;
}
inline float fabsf(float x) { return std::fabs(x); }
inline float fminf(float a, float b) { return std::fmin(a, b); }
inline float fmaxf(float a, float b) { return std::fmax(a, b); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
typedef void* cudaStream_t;
typedef int cudaError_t;
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "no error"; }

struct EmuWarp {
  ucontext_t sched, ctx[32];
  char stack[32][1 << 16];
  bool finished[32];
  int buf[32], tag[32];            // per lane: its next buffer, its intrinsic
  unsigned long long val[2][32];
  int cur;                          // the lane running
  std::function<void()> body;
};
static EmuWarp emu_warp;
inline void emu_fail(const char* what) {
  std::fprintf(stderr, "warp emulation: %s\n", what);
  std::abort();
}
inline void emu_lane_main() {
  emu_warp.body();
  emu_warp.finished[emu_warp.cur] = true;
}
// every lane's value of the intrinsic `tag` the calling lane is at
inline const unsigned long long* emu_exchange(unsigned mask, int tag,
                                              unsigned long long v) {
  if (mask != 0xffffffffu) emu_fail("a mask other than the full warp");
  EmuWarp& w = emu_warp;
  const int lane = w.cur, b = w.buf[lane];
  w.val[b][lane] = v;
  w.tag[lane] = tag;
  w.buf[lane] ^= 1;
  swapcontext(&w.ctx[lane], &w.sched);
  return w.val[b];
}
inline unsigned __ballot_sync(unsigned m, bool p) {
  const unsigned long long* v = emu_exchange(m, 1, p);
  unsigned r = 0;
  for (int l = 0; l < 32; ++l) r |= v[l] ? 1u << l : 0u;
  return r;
}
inline bool __any_sync(unsigned m, bool p) {
  const unsigned long long* v = emu_exchange(m, 2, p);
  for (int l = 0; l < 32; ++l)
    if (v[l]) return true;
  return false;
}
inline unsigned __match_any_sync(unsigned m, int x) {
  const unsigned long long* v = emu_exchange(m, 3, (unsigned)x);
  unsigned r = 0;
  for (int l = 0; l < 32; ++l) r |= v[l] == (unsigned)x ? 1u << l : 0u;
  return r;
}
template <class T> inline T __shfl_sync(unsigned m, T x, int src) {
  static_assert(sizeof(T) <= 8, "");
  unsigned long long u = 0;
  std::memcpy(&u, &x, sizeof(T));
  const unsigned long long* v = emu_exchange(m, 4, u);
  T r;
  std::memcpy(&r, &v[src & 31], sizeof(T));
  return r;
}
inline unsigned __reduce_min_sync(unsigned m, unsigned x) {
  const unsigned long long* v = emu_exchange(m, 5, x);
  unsigned r = 0xffffffffu;
  for (int l = 0; l < 32; ++l) r = (unsigned)v[l] < r ? (unsigned)v[l] : r;
  return r;
}
inline void __syncwarp(unsigned m = 0xffffffffu) { emu_exchange(m, 6, 0); }
inline void emu_launch(unsigned grid, unsigned block,
                       std::function<void()> body) {
  EmuWarp& w = emu_warp;
  w.body = body;
  blockDim.x = block;
  for (unsigned b = 0; b < grid; ++b) {
    blockIdx.x = b;
    for (unsigned w0 = 0; w0 < block; w0 += 32) {
      for (int l = 0; l < 32; ++l) {
        getcontext(&w.ctx[l]);
        w.ctx[l].uc_stack.ss_sp = w.stack[l];
        w.ctx[l].uc_stack.ss_size = sizeof w.stack[l];
        w.ctx[l].uc_link = &w.sched;
        makecontext(&w.ctx[l], emu_lane_main, 0);
        w.finished[l] = false;
        w.buf[l] = 0;
      }
      for (;;) {     // each lane on to its next intrinsic, or its end
        int n_done = 0;
        for (int l = 0; l < 32; ++l) {
          if (w.finished[l]) { ++n_done; continue; }
          w.cur = l;
          threadIdx.x = w0 + l;
          swapcontext(&w.sched, &w.ctx[l]);
          n_done += w.finished[l];
        }
        if (n_done == 32) break;
        if (n_done > 0)
          emu_fail("a lane ended while others wait at an intrinsic");
        for (int l = 1; l < 32; ++l)
          if (w.tag[l] != w.tag[0]) emu_fail("lanes at different intrinsics");
      }
    }
  }
}
#define EMU_LAUNCH(grid, block, kern, ...) \
  emu_launch(grid, block, [&] { kern(__VA_ARGS__); })
"""


def emulate_source(tmp_path, src_path, shim, n_launches, std="c++17"):
    """A CUDA source compiled with g++ through `shim` (written as
    cuda_runtime.h), its launches rewritten as EMU_LAUNCH; csrc/ is on the
    include path for the headers the sources share. Returns the loaded
    library."""
    src = open(src_path).read()
    src, n = re.subn(
        r"(\w+_kernel(?:<\w+>)?)<<<grid, BLOCK, 0, \(cudaStream_t\)stream>>>\(",
        r"EMU_LAUNCH(grid, BLOCK, \1, ", src)
    assert n == n_launches
    (tmp_path / "cuda_runtime.h").write_text(shim)
    stem = os.path.splitext(os.path.basename(src_path))[0]
    (tmp_path / f"{stem}.cpp").write_text(src)
    so = tmp_path / f"lib{stem}.so"
    subprocess.run(["g++", "-O1", f"-std={std}", "-shared", "-fPIC",
                    "-pthread", f"-I{tmp_path}",
                    f"-I{os.path.dirname(src_path)}",
                    str(tmp_path / f"{stem}.cpp"), "-o", str(so)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def build_emulation(tmp_path, **constants):
    """csrc/cluster_walk.cu compiled with g++ through _SHIM, loaded with
    the wrappers' C signatures; with `constants`, its `constexpr int`
    lines set to them first (traverse.with_constants)."""
    src = traverse._SRC
    if constants:
        d = tmp_path / "src"
        d.mkdir()
        for h in (src,) + traverse.HEADERS:
            text = open(h).read()
            if h == src:
                text = traverse.with_constants(text, **constants)
            (d / os.path.basename(h)).write_text(text)
        src = str(d / os.path.basename(src))
    lib = emulate_source(tmp_path, src, _SHIM, 14)
    traverse._declare(lib)
    return lib


def load_counters(lib, tables):
    """Point the emulation's load counters at up to six tables; returns
    the (6,) counter array, zeroed. Zeroes the work counter too."""
    lo = (ctypes.c_void_p * 6).in_dll(lib, "emu_lo")
    hi = (ctypes.c_void_p * 6).in_dll(lib, "emu_hi")
    loads = (ctypes.c_longlong * 6).in_dll(lib, "emu_loads")
    for i in range(6):
        a = tables[i] if i < len(tables) else None
        lo[i] = a.data_ptr() if a is not None else 0
        hi[i] = (a.data_ptr() + a.numel() * a.element_size()
                 if a is not None else 0)
        loads[i] = 0
    work_counter(lib).value = 0
    return loads


def work_counter(lib):
    """The emulation's count of the work no load shows (WORK_COUNT in
    csrc/cluster_walk.cu: slot tests on plane rows held in registers, the
    warps' leaf passes, the pair walk's stack pops)."""
    return ctypes.c_longlong.in_dll(lib, "emu_work")


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return build_emulation(tmp_path_factory.mktemp("cluster_walk_emu"))


def test_cuda_source_emulated_matches_twins(case, emulated):
    lib = emulated
    st = case.st
    tabs = (st.mxu_node_f, st.mxu_link, st.cluster_feat)
    for kind in KINDS:
        o, d, tm = case.rays[kind]
        rays = (*planar(o).__dict__.values(), *planar(d).__dict__.values(),
                torch.from_numpy(tm))
        n = tm.shape[0]
        t = torch.empty(n)
        slot = torch.empty(n, dtype=torch.int32)
        occ = torch.empty(n, dtype=torch.bool)
        ptrs = [a.data_ptr() for a in tabs + rays]
        dims = (n, st.mxu_node_f.shape[0], st.cluster_k, None)
        assert lib.mts_cluster_closest_hit(*ptrs, t.data_ptr(),
                                           slot.data_ptr(), *dims) == 0
        assert lib.mts_cluster_any_hit(*ptrs, occ.data_ptr(), *dims) == 0
        t_p, slot_p = traverse.closest_hit_plain(*tabs, *rays, st.cluster_k)
        occ_p = traverse.any_hit_plain(*tabs, *rays, st.cluster_k)
        # the same f32 operations in the same order: bit-equal
        assert torch.equal(slot, slot_p) and torch.equal(occ, occ_p)
        assert torch.equal(t, t_p)


@pytest.mark.parametrize("kind", KINDS)
def test_twin_counts_kernel_work(case, emulated, kind):
    """The walk work the twins count (the kernels' bound in chip_smoke.py
    rests on it) equals the work the kernels' source does, counted in the
    emulation: a node step reads two float4 of its row and a cluster visit
    a third (the centroid). A warp loads a cluster's rows (five float4 a
    slot) once for each group of its lanes due at that cluster in one
    round, and tests each ray of the group on rows held in registers:
    every slot for a closest hit; for an any hit, tile by tile up to the
    tile of the ray's first hit, the group's loads ending with the tile of
    its last ray's first hit."""
    lib, st = emulated, case.st
    tabs = (st.mxu_node_f, st.mxu_link, st.cluster_feat)
    o, d, tm = case.rays[kind]
    rays = (*planar(o).__dict__.values(), *planar(d).__dict__.values(),
            torch.from_numpy(tm))
    n = tm.shape[0]
    ptrs = [a.data_ptr() for a in tabs + rays]
    dims = (n, st.mxu_node_f.shape[0], st.cluster_k, None)
    out = (torch.empty(n), torch.empty(n, dtype=torch.int32))
    occ = torch.empty(n, dtype=torch.bool)
    for any_hit in (False, True):
        loads = load_counters(lib, (st.mxu_node_f, st.cluster_feat))
        if any_hit:
            assert lib.mts_cluster_any_hit(*ptrs, occ.data_ptr(), *dims) == 0
        else:
            assert lib.mts_cluster_closest_hit(
                *ptrs, *(a.data_ptr() for a in out), *dims) == 0
        stats = {}
        twin = traverse.any_hit_plain if any_hit else traverse.closest_hit_plain
        twin(*tabs, *rays, st.cluster_k, chunk=500, stats=stats)
        assert_kernel_work(stats, loads, work_counter(lib).value,
                           bool(occ.any()) if any_hit else None,
                           st.cluster_k)


def assert_kernel_work(stats, loads, work, occluded, cluster_k,
                       tile=traverse.TILE):
    """A cluster walk's counted work (loads of mxu_node_f in loads[0] and
    of cluster_feat in loads[1], slot tests on rows in registers in
    `work`) against its twin's `stats`. `occluded`: None for closest hit;
    for any hit, whether some lane hit, and `tile` the slots a warp tests
    in one pass."""
    visits = stats.get("cluster_visits", 0)
    assert loads[0] == 2 * stats["node_steps"] + visits
    groups = stats.get("cluster_groups", 0)
    assert loads[1] == 5 * stats.get("loaded_slots", 0)
    assert work == stats.get("slot_tests", 0)
    # a group is one lane's visit at the least, a warp's lanes at the most
    assert visits / 32 <= groups <= visits
    assert (groups > 0) == (visits > 0)
    if occluded is None:
        assert stats.get("loaded_slots", 0) == cluster_k * groups
        assert work == visits * cluster_k
        return
    assert stats.get("loaded_slots", 0) <= cluster_k * groups
    assert work <= visits * cluster_k
    # whole tiles: a ray is tested on the slots of each tile up to its hit
    assert work % min(tile, cluster_k) == 0
    assert stats.get("real_slot_tests", 0) <= work
    if occluded:
        # a group whose rays all hit in its first tile loads no other
        assert stats["loaded_slots"] < cluster_k * groups
        assert work < visits * cluster_k


@contextlib.contextmanager
def recorded_visits(results=None):
    """The slot bases of the clusters the twins visit inside the block,
    one (m,) tensor for each batch of visiting lanes, in walk order; each
    batch's visit results are appended to `results` where given."""
    got = []
    visit = traverse._cluster_visit

    def record(f, base, *a, **kw):
        got.append(base.clone())
        res = visit(f, base, *a, **kw)
        if results is not None:
            results.append(res)
        return res
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(traverse, "_cluster_visit", record)
        yield got


def lanes_of(rays, idx):
    """The numpy (o, d, t_max) of probe rays `rays` at lanes `idx`."""
    return tuple(a[np.asarray(idx)] for a in rays)


def torch_rays(o, d, tm):
    return (*planar(o).__dict__.values(), *planar(d).__dict__.values(),
            torch.from_numpy(np.ascontiguousarray(tm)))


def first_visits(twin, rays, pool):
    """Each lane of `pool` walked alone by `twin` (a closest-hit twin
    taking the torch rays): {slot base of its first cluster visit: lane},
    the first lane found for each cluster."""
    first = {}
    for i in pool:
        with recorded_visits() as got:
            twin(*torch_rays(*lanes_of(rays, [i])))
        if got:
            first.setdefault(int(got[0][0]), i)
    return first


def first_any_visits(case, rays, pool):
    """Each lane of `pool` walked alone by the any-hit twin: {lane: (slot
    base, hit, slots tested) of its first cluster visit}, for the lanes
    that visit one."""
    st = case.st
    tabs = (st.mxu_node_f, st.mxu_link, st.cluster_feat)
    first = {}
    for i in pool:
        res = []
        with recorded_visits(res) as got:
            traverse.any_hit_plain(*tabs, *torch_rays(*lanes_of(rays, [i])),
                                   st.cluster_k)
        if got:
            first[i] = (int(got[0][0]), bool(res[0][0][0]),
                        int(res[0][1][0]))
    return first


def nearest_in_cluster(case, o, d, base):
    """The nearest t at which ray (o, d) hits a slot of the cluster at
    slot base `base` (the plane test on the cluster's rows)."""
    st = case.st
    row = st.mxu_node_f[st.mxu_node_f[:, 6] == base][0]
    f = traverse._slot_rows(st.cluster_feat, torch.tensor([base]),
                            st.cluster_k)
    ray = [torch.tensor([float(x)]) for x in (*o, *d)]
    u, v, t, inv = traverse._cluster_planes(f, row[8:11].unbind(0), *ray)
    ok = (inv != 0) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0)
    return float(t[ok].min())


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_emulated_warps_match_twins(case, emulated, any_hit):
    """The warp-cooperative kernels, emulated warp by warp, on lanes laid
    out to exercise them, the results bit-equal to the twin on every lane,
    dead lanes missing, and the work counted exactly. Closest hit: warp 0
    one camera ray 32 times (its lanes due at the same cluster in every
    round), warp 1 random rays first due at as many different clusters as
    256 of them reach (each ray alone, the twin's first visit), warps 2-3
    bounce and shadow rays with every third lane dead (t_max 0 or -1),
    and a last warp of 13 lanes. Any hit: emulated_any_hit_warps."""
    if any_hit:
        emulated_any_hit_warps(case, emulated)
        return
    lib, st = emulated, case.st
    tabs = (st.mxu_node_f, st.mxu_link, st.cluster_feat)

    def twin(*rays, **kw):
        return traverse.closest_hit_plain(*tabs, *rays, st.cluster_k, **kw)
    rnd = case.rays["random"]
    first = first_visits(twin, rnd, range(256))
    assert len(first) >= 6
    spread = list(first.values())
    parts = [lanes_of(rnd, [spread[0]] * 32),
             lanes_of(rnd, [spread[k % len(spread)] for k in range(32)])]
    for kind in ("bounce", "shadow"):
        o, d, tm = lanes_of(case.rays[kind], range(32))
        tm = tm.copy()
        tm[0::3] = np.where(np.arange(32)[0::3] % 2 == 0, 0.0, -1.0)
        parts.append((o, d, tm))
    parts.append(lanes_of(case.rays["camera"], range(13)))
    o, d, tm = (np.concatenate(a) for a in zip(*parts))
    rays = torch_rays(o, d, tm)
    n = tm.shape[0]
    assert n % 32 == 13 and (tm <= 0).sum() == 22

    loads = load_counters(lib, (st.mxu_node_f, st.cluster_feat))
    t = torch.empty(n)
    slot = torch.empty(n, dtype=torch.int32)
    assert lib.mts_cluster_closest_hit(
        *(a.data_ptr() for a in tabs + rays), t.data_ptr(), slot.data_ptr(),
        n, st.mxu_node_f.shape[0], st.cluster_k, None) == 0
    stats = {}
    t_p, slot_p = twin(*rays, stats=stats)
    assert torch.equal(t, t_p) and torch.equal(slot, slot_p)
    dead = torch.from_numpy(tm <= 0)
    assert torch.isinf(t[dead]).all() and (slot[dead] == -1).all()
    assert_kernel_work(stats, loads, work_counter(lib).value, None,
                       st.cluster_k)
    # warp 0 serves its 32 lanes as one group a round; warp 1's first
    # round alone has a group for each of its lanes' first clusters
    for w, groups_at_least in ((0, None), (1, len(first))):
        sw = {}
        twin(*(a[32 * w:32 * (w + 1)] for a in rays), stats=sw)
        if groups_at_least is None:
            assert sw["cluster_groups"] * 32 == sw["cluster_visits"] > 0
        else:
            assert sw["cluster_groups"] >= groups_at_least


def emulated_any_hit_warps(case, emulated):
    """The warp-cooperative any-hit kernel on shadow rays: warp 0 one
    occluded shadow ray 32 times, whose first visit hits in its first
    tile (the group's owners all hit there, so it loads no second tile);
    warp 1 shadow rays first due at as many different clusters as 128 of
    them reach; warp 2 shadow rays, occluded and not, every third lane
    dead; warp 3 that occluded ray 16 times and 16 times with t_max just
    under its nearest hit in that cluster (one group at the cluster: half
    its owners hit in the first tile, half test every tile and walk on);
    and a last warp of 13 lanes."""
    lib, st = emulated, case.st
    tabs = (st.mxu_node_f, st.mxu_link, st.cluster_feat)
    ck, tile = st.cluster_k, min(traverse.TILE, st.cluster_k)

    def twin(*rays, **kw):
        return traverse.any_hit_plain(*tabs, *rays, ck, **kw)
    sh = case.rays["shadow"]
    first = first_any_visits(case, sh, range(128))
    early = [i for i, (_, h, n) in first.items() if h and n == tile]
    assert early and ck > tile
    a = early[0]
    base_a = first[a][0]
    by_cluster = {}
    for i, (b, _, _) in first.items():
        by_cluster.setdefault(b, i)
    spread = list(by_cluster.values())
    assert len(spread) >= 6
    o_a, d_a, tm_a = lanes_of(sh, [a])
    short = np.float32(0.999 * nearest_in_cluster(case, o_a[0], d_a[0],
                                                  base_a))
    assert 0 < short < tm_a[0]
    o, d, tm = lanes_of(sh, range(200, 232))
    tm = tm.copy()
    tm[0::3] = np.where(np.arange(32)[0::3] % 2 == 0, 0.0, -1.0)
    parts = [lanes_of(sh, [a] * 32),
             lanes_of(sh, [spread[k % len(spread)] for k in range(32)]),
             (o, d, tm),
             (o_a.repeat(32, 0), d_a.repeat(32, 0),
              np.repeat(np.array([tm_a[0], short], np.float32), 16)),
             lanes_of(sh, range(300, 313))]
    o, d, tm = (np.concatenate(x) for x in zip(*parts))
    rays = torch_rays(o, d, tm)
    n = tm.shape[0]
    assert n % 32 == 13 and (tm <= 0).sum() == 11

    loads = load_counters(lib, (st.mxu_node_f, st.cluster_feat))
    occ = torch.empty(n, dtype=torch.bool)
    assert lib.mts_cluster_any_hit(
        *(a_.data_ptr() for a_ in tabs + rays), occ.data_ptr(), n,
        st.mxu_node_f.shape[0], ck, None) == 0
    stats = {}
    occ_p = twin(*rays, stats=stats)
    assert torch.equal(occ, occ_p)
    assert not occ[torch.from_numpy(tm <= 0)].any()
    live2 = torch.from_numpy(tm[64:96] > 0)
    assert occ[64:96][live2].any() and not occ[64:96][live2].all()
    assert occ[:32].all() and occ[96:112].all()
    assert_kernel_work(stats, loads, work_counter(lib).value, True, ck)
    sw = []
    for w in range(4):
        sw.append({})
        twin(*(x[32 * w:32 * (w + 1)] for x in rays), stats=sw[w])
    # warp 0: one group, its owners all hit in the first tile
    assert sw[0]["cluster_groups"] == 1 and sw[0]["cluster_visits"] == 32
    assert sw[0]["loaded_slots"] == tile
    assert sw[0]["slot_tests"] == 32 * tile
    # warp 1's first round alone has a group for each lane's first cluster
    assert sw[1]["cluster_groups"] >= len(spread)
    # warp 3: one group at the occluded ray's cluster, which loads every
    # tile: the first 16 owners hit in the first tile and stop, the other
    # 16 test every tile, miss and walk on
    res = []
    with recorded_visits(res) as got:
        twin(*(x[96:128] for x in rays))
    assert (got[0] == base_a).all() and got[0].numel() == 32
    hit, tested = res[0]
    assert hit[:16].all() and not hit[16:].any()
    assert (tested[:16] == tile).all() and (tested[16:] == ck).all()
    assert sw[3]["cluster_visits"] > 32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("kind", KINDS)
def test_cuda_kernels_match_twins(case, cuda, kind):
    st = mt.to_device(case.st, cuda)
    tabs = (st.mxu_node_f, st.mxu_link, st.cluster_feat)
    o, d, tm = case.rays[kind]
    rays = (*planar(o, cuda).__dict__.values(),
            *planar(d, cuda).__dict__.values(),
            torch.from_numpy(tm).to(cuda))
    before = traverse.cluster_closest_hit.launches
    t, slot = traverse.cluster_closest_hit(*tabs, *rays, st.cluster_k)
    occ = traverse.cluster_any_hit(*tabs, *rays, st.cluster_k)
    torch.cuda.synchronize()
    assert traverse.cluster_closest_hit.launches == before + 1
    t_p, slot_p = traverse.closest_hit_plain(*tabs, *rays, st.cluster_k)
    occ_p = traverse.any_hit_plain(*tabs, *rays, st.cluster_k)
    hit = torch.isfinite(t_p)
    assert torch.equal(torch.isfinite(t), hit)
    same = slot == slot_p
    assert same[hit].float().mean() >= 0.999
    torch.testing.assert_close(t[hit], t_p[hit], rtol=1e-5, atol=1e-5)
    # the any hit's warp-cooperative visits keep the twin's result
    assert torch.equal(occ, occ_p)
