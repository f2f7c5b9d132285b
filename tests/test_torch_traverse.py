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
"""
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
        jnp = pytest.importorskip("jax.numpy")
        from mitsuba2_tpu.core.vec import Vec3 as JVec3
        from mitsuba2_tpu.kernels import traverse_jnp, traverse_pallas
        from mitsuba2_tpu.scene import presets as jpresets
        mod = {"pallas": traverse_pallas, "jnp": traverse_jnp}[which]
        kw = {"interpret": True} if which == "pallas" else {}
        sj = self.memo("jax_scene", lambda: jpresets.mesh_gallery(subdiv=1))

        def jplanar(a):
            return JVec3(*(jnp.asarray(a[:, i]) for i in range(3)))

        def run():
            o, d, tm = self.rays[kind]
            t, prim, _, _ = mod.ray_intersect_preliminary(
                sj, jplanar(o), jplanar(d), jnp.asarray(tm), **kw)
            occ = mod.ray_test(sj, jplanar(o), jplanar(d), jnp.asarray(tm),
                               **kw)
            return np.asarray(t), np.asarray(prim), np.asarray(occ)
        return self.memo((which, kind), run)


@pytest.fixture(scope="module")
def case():
    return Case()


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

# Just enough of CUDA to run csrc/cluster_walk.cu's kernels one thread at a
# time with g++: the kernels' indexing, table layouts and walk logic are
# then checked here, against the twins, through the wrapper's C ABI.
_SHIM = r"""
#pragma once
#include <cmath>
#include <cstring>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
struct float4 { float x, y, z, w; };
struct int4 { int x, y, z, w; };
struct dim3_ { unsigned x; };
static dim3_ blockIdx, threadIdx, blockDim;
// loads that fall in each of four tables, counted as the kernels make them
extern "C" {
const char* emu_lo[4];
const char* emu_hi[4];
long long emu_loads[4];
}
template <class T> inline T __ldg(const T* p) {
  for (int i = 0; i < 4; ++i)
    if ((const char*)p >= emu_lo[i] && (const char*)p < emu_hi[i]) ++emu_loads[i];
  return *p;
}
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline float fabsf(float x) { return std::fabs(x); }
inline float fminf(float a, float b) { return std::fmin(a, b); }
inline float fmaxf(float a, float b) { return std::fmax(a, b); }
inline int __ffs(int x) { return __builtin_ffs(x); }
typedef void* cudaStream_t;
typedef int cudaError_t;
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "no error"; }
#define EMU_LAUNCH(grid, block, kern, ...) \
  for (unsigned b = 0; b < (unsigned)(grid); ++b) \
    for (unsigned t = 0; t < (unsigned)(block); ++t) { \
      blockIdx.x = b; threadIdx.x = t; blockDim.x = block; kern(__VA_ARGS__); }
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


def build_emulation(tmp_path):
    """csrc/cluster_walk.cu compiled with g++ through _SHIM, loaded with
    the wrappers' C signatures."""
    lib = emulate_source(tmp_path, traverse._SRC, _SHIM, 14)
    traverse._declare(lib)
    return lib


def load_counters(lib, tables):
    """Point the emulation's load counters at up to four tables; returns
    the (4,) counter array, zeroed."""
    lo = (ctypes.c_void_p * 4).in_dll(lib, "emu_lo")
    hi = (ctypes.c_void_p * 4).in_dll(lib, "emu_hi")
    loads = (ctypes.c_longlong * 4).in_dll(lib, "emu_loads")
    for i in range(4):
        a = tables[i] if i < len(tables) else None
        lo[i] = a.data_ptr() if a is not None else 0
        hi[i] = (a.data_ptr() + a.numel() * a.element_size()
                 if a is not None else 0)
        loads[i] = 0
    return loads


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
    rests on it) equals the loads the kernels' source makes, counted in
    the emulation: a node step reads two float4 of its row and a cluster
    visit a third (the centroid); a slot test reads its five float4 of
    plane rows, and an any-hit thread stops at its first hit."""
    lib, st = emulated, case.st
    tabs = (st.mxu_node_f, st.mxu_link, st.cluster_feat)
    o, d, tm = case.rays[kind]
    rays = (*planar(o).__dict__.values(), *planar(d).__dict__.values(),
            torch.from_numpy(tm))
    n = tm.shape[0]
    loads = load_counters(lib, (st.mxu_node_f, st.cluster_feat))
    ptrs = [a.data_ptr() for a in tabs + rays]
    dims = (n, st.mxu_node_f.shape[0], st.cluster_k, None)
    out = (torch.empty(n), torch.empty(n, dtype=torch.int32))
    occ = torch.empty(n, dtype=torch.bool)
    for any_hit in (False, True):
        loads[0] = loads[1] = 0
        if any_hit:
            assert lib.mts_cluster_any_hit(*ptrs, occ.data_ptr(), *dims) == 0
        else:
            assert lib.mts_cluster_closest_hit(
                *ptrs, *(a.data_ptr() for a in out), *dims) == 0
        stats = {}
        twin = traverse.any_hit_plain if any_hit else traverse.closest_hit_plain
        twin(*tabs, *rays, st.cluster_k, chunk=500, stats=stats)
        visits = stats.get("cluster_visits", 0)
        assert loads[0] == 2 * stats["node_steps"] + visits
        assert loads[1] == 5 * stats.get("slot_tests", 0)
        if not any_hit:
            assert stats.get("slot_tests", 0) == visits * st.cluster_k
        elif bool(occ.any()):
            # lanes that hit stop early: fewer tests than whole clusters
            assert stats["slot_tests"] < visits * st.cluster_k


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
    assert (occ == occ_p).float().mean() >= 0.999
