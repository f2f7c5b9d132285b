// Ray traversal for Hopper (sm_90a): closest hit and any hit, over a
// cluster cut tree or a full BVH2, each flat or under a TLAS of instances.
//
// REPLACES ten kernels of the JAX package,
// mitsuba2_tpu/kernels/traverse_pallas.py:
//   cluster_closest_hit_kernel <- _closest_hit_mxu_kernel (:671) and
//                                 _closest_hit_mxu2_kernel (:877)
//   cluster_any_hit_kernel     <- _any_hit_mxu_kernel (:755) and
//                                 _any_hit_mxu2_kernel (:944)
//   inst_cluster_closest_hit_kernel <- _closest_hit_instmxu_kernel (:1746)
//   inst_cluster_any_hit_kernel     <- _any_hit_instmxu_kernel (:1856)
//   bvh_closest_hit_kernel      <- _closest_hit_kernel (:250)
//   bvh_any_hit_kernel          <- _any_hit_kernel (:309)
//   inst_bvh_closest_hit_kernel <- _closest_hit_inst_kernel (:1382)
//   inst_bvh_any_hit_kernel     <- _any_hit_inst_kernel (:1486)
// mxu and mxu2 compute one function; they differ only in how the TPU
// interleaves two 4096-ray lockstep walks, which has no meaning here. The
// BVH2 walks are described after the cluster walks, below.
//
// WHAT BOUNDS IT on an H100. Per ray the work is the cluster visits its
// walk needs: each visit tests CK = 128 triangle slots, 38 FP32
// operations a slot (four plane dots over the ray features, one divide,
// the scalings), and streams the cluster's 10 KB of plane rows (CK x 20
// floats). The bytes the function must move are only the rays and the
// results (29-36 B a ray) plus the tables once, so the roofline bound is
// the FP32 operations (67 TFLOP/s): on the mesh gallery's wavefronts, 1-1.4
// cluster visits a ray, about 0.1 ms per million rays. The real limiter of
// this first version is latency: data-dependent walks diverge within a
// warp, and each visit's plane rows are read through L1/L2 per thread
// (PERF.md has the measured times beside the bound).
//
// Built with --fmad=false (kernels/traverse.py): every product and sum is
// rounded as the plain PyTorch twin's separate operations round it, so
// kernel and twin agree bit for bit.
//
// DESIGN. One ray per thread, a threaded stackless walk over the pruned
// cut tree: a node row is [min.xyz, max.xyz, slot base, pad, centroid.xyz,
// pad] (mxu_node_f) and its links are [hit8 | miss8] (mxu_link), picked
// by the thread's own direction octant (correctness does not depend on
// the octant; it only orders the walk near-first). At an inner node the
// slab test (tmin < t_best) chooses the hit or the miss link; at a
// cluster node the thread, if its slab hits, tests the cluster's CK slots
// and follows the miss link. The slot test is the Möller–Trumbore
// bilinear form: det, u, v and t numerators are dots of the slot's plane
// rows with the ray features [d, (o-c) x d, o-c, 1], recentred at the
// cluster centroid c. Everything is computed in f32: none of the TPU's
// bf16-split dot modes, lane-group culling, dual walks, block-vote octant
// or DMA scratch is carried over. The coherence presort upstream keeps
// the rays of a warp near each other, so threads of a warp mostly walk
// the same nodes and read the same plane rows (broadcast loads).
// Ties: within a cluster the lowest slot wins an equal t, across clusters
// the first one visited keeps it (strictly closer replaces).
//
// INSTANCED WALK (walk<.., true>): the table is [TLAS | per-group cut
// trees], the groups' clusters in local space. Instancing is one level
// deep, so one saved continuation replaces a stack: at a TLAS instance leaf
// (col 7 = instance id >= 0) whose slab the ray hits, the thread moves its
// ray to instance space (o and the unnormalised d through inst_inv's 3x4,
// so t is kept and t_best stays comparable), recomputes 1/d and the
// octant, saves the leaf's miss link and jumps to the group's cut-tree root
// (inst_inv col 13). A BLAS_EXIT (-2) link pops: back to the saved row with
// the world ray. The winning instance is the one current when t_best last
// strictly improved. The walk is capped at the scene's inst_mxu_fuel + 64
// steps (cut-tree rows are revisited once per instance entered). Each entry
// costs 4 float4 loads and 36 FP32 operations (33 for the transform, 3
// reciprocals); the world ray is kept in registers, so a pop recomputes
// nothing.
//
// C ABI (loaded with ctypes by kernels/traverse.py); each entry point
// launches on the given stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FEAT_W4 = 5;       // float4s per slot in cluster_feat (20 floats)
constexpr int BLOCK = 128;
constexpr int BLAS_EXIT = -2;    // scene/bvh.py: leave an instance's cut tree

struct RayState {
    float ox, oy, oz, dx, dy, dz, ix, iy, iz;
    int oct;
};

__device__ __forceinline__ float safe_inv(float d) {
    float dd = fabsf(d) < 1e-20f ? (d >= 0.0f ? 1e-20f : -1e-20f) : d;
    return 1.0f / dd;
}

__device__ __forceinline__ RayState make_ray(float ox, float oy, float oz,
                                             float dx, float dy, float dz) {
    RayState r;
    r.ox = ox; r.oy = oy; r.oz = oz;
    r.dx = dx; r.dy = dy; r.dz = dz;
    r.ix = safe_inv(dx); r.iy = safe_inv(dy); r.iz = safe_inv(dz);
    r.oct = (dx < 0.0f ? 1 : 0) | (dy < 0.0f ? 2 : 0) | (dz < 0.0f ? 4 : 0);
    return r;
}

__device__ __forceinline__ RayState load_ray(
        const float* ox, const float* oy, const float* oz,
        const float* dx, const float* dy, const float* dz, int i) {
    return make_ray(ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]);
}

// World ray -> instance space through one inst_inv row (m0..m2: the 3x4
// world->local matrix), in traverse_pallas._inst_rays's order of operations
__device__ __forceinline__ RayState to_local(const float4& m0,
                                             const float4& m1,
                                             const float4& m2,
                                             const RayState& w) {
    return make_ray(m0.x * w.ox + m0.y * w.oy + m0.z * w.oz + m0.w,
                    m1.x * w.ox + m1.y * w.oy + m1.z * w.oz + m1.w,
                    m2.x * w.ox + m2.y * w.oy + m2.z * w.oz + m2.w,
                    m0.x * w.dx + m0.y * w.dy + m0.z * w.dz,
                    m1.x * w.dx + m1.y * w.dy + m1.z * w.dz,
                    m2.x * w.dx + m2.y * w.dy + m2.z * w.dz);
}

// Node row: a = (min.x, min.y, min.z, max.x), b = (max.y, max.z, slot, inst)
__device__ __forceinline__ bool slab(const float4& a, const float4& b,
                                     const RayState& r, float t_best) {
    float t0x = (a.x - r.ox) * r.ix, t1x = (a.w - r.ox) * r.ix;
    float t0y = (a.y - r.oy) * r.iy, t1y = (b.x - r.oy) * r.iy;
    float t0z = (a.z - r.oz) * r.iz, t1z = (b.y - r.oz) * r.iz;
    float tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                       fminf(t0z, t1z));
    float tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                       fmaxf(t0z, t1z));
    return (tmin <= tmax) && (tmax > 0.0f) && (tmin < t_best);
}

// One slot's plane test; returns false where the slot cannot hit.
// Slot layout: [det0..2 u0 | u1..u4 | u5 v0..v2 | v3..v5 t0 | t1..t3 pad]
__device__ __forceinline__ bool slot_test(const float4* __restrict__ f,
                                          const RayState& r, float px,
                                          float py, float pz, float mx,
                                          float my, float mz, float* t_out) {
    const float4 f0 = __ldg(f), f1 = __ldg(f + 1), f2 = __ldg(f + 2),
                 f3 = __ldg(f + 3), f4 = __ldg(f + 4);
    float det = f0.x * r.dx + f0.y * r.dy + f0.z * r.dz;
    float unum = f0.w * r.dx + f1.x * r.dy + f1.y * r.dz +
                 f1.z * mx + f1.w * my + f2.x * mz;
    float vnum = f2.y * r.dx + f2.z * r.dy + f2.w * r.dz +
                 f3.x * mx + f3.y * my + f3.z * mz;
    float tnum = f3.w * px + f4.x * py + f4.y * pz + f4.z;
    float inv = fabsf(det) < 1e-12f ? 0.0f : 1.0f / det;
    float u = unum * inv, v = vnum * inv, t = tnum * inv;
    *t_out = t;
    return (inv != 0.0f) && (u >= 0.0f) && (v >= 0.0f) &&
           (u + v <= 1.0f) && (t > 0.0f);
}

// The walk of one ray. INST = false: one cut tree, `world` is the ray
// throughout. INST = true: the instanced walk described above.
template <bool ANY_HIT, bool INST>
__device__ __forceinline__ void walk(
        const float4* __restrict__ node_f, const int* __restrict__ link,
        const float4* __restrict__ feat, const float4* __restrict__ inst_inv,
        const RayState& world, float t_max, int fuel_cap, int ck,
        float* t_best_io, int* best_io, int* inst_io, bool* occ_io) {
    RayState r = world;   // the ray in the current space
    float t_best = t_max;
    int best = -1;
    int binst = -1, cinst = -1, ret = -1;
    int node = 0;
    for (int fuel = 0; node >= 0 && fuel < fuel_cap; ++fuel) {
        const float4 a = __ldg(node_f + 4 * node);
        const float4 b = __ldg(node_f + 4 * node + 1);
        const int slot_base = (int)b.z;
        const bool hit = slab(a, b, r, ANY_HIT ? t_max : t_best);
        const int hit_link = __ldg(link + 16 * node + r.oct);
        const int miss_link = __ldg(link + 16 * node + 8 + r.oct);
        if (slot_base >= 0) {
            if (hit) {
                const float4 c = __ldg(node_f + 4 * node + 2);
                const float px = r.ox - c.x, py = r.oy - c.y, pz = r.oz - c.z;
                const float mx = py * r.dz - pz * r.dy;
                const float my = pz * r.dx - px * r.dz;
                const float mz = px * r.dy - py * r.dx;
                const float4* fs = feat + (size_t)slot_base * FEAT_W4;
                const float tl = ANY_HIT ? t_max : t_best;
                for (int k = 0; k < ck; ++k) {
                    float t;
                    const bool ok = slot_test(fs + k * FEAT_W4, r, px, py, pz,
                                              mx, my, mz, &t);
                    if (ANY_HIT) {
                        if (ok && t <= tl) {
                            *occ_io = true;
                            return;           // stop at the first hit
                        }
                    } else if (ok && t < t_best) {
                        t_best = t;           // t_best <= tl: strict < keeps
                        best = slot_base + k; // the lowest slot on a tie
                        if (INST) binst = cinst;
                    }
                }
            }
            node = miss_link;
        } else if (INST && hit && (int)b.w >= 0) {
            const int iid = (int)b.w;         // enter instance iid
            const float4* m = inst_inv + 4 * (size_t)iid;
            const float4 m0 = __ldg(m), m1 = __ldg(m + 1), m2 = __ldg(m + 2),
                         m3 = __ldg(m + 3);
            r = to_local(m0, m1, m2, world);
            ret = miss_link;
            cinst = iid;
            node = (int)m3.y;                 // col 13: the cut-tree root
        } else {
            node = hit ? hit_link : miss_link;
        }
        if (INST && node == BLAS_EXIT) {      // pop to the TLAS
            node = ret;
            ret = -1;
            cinst = -1;
            r = world;
        }
    }
    if (!ANY_HIT) {
        *t_best_io = best >= 0 ? t_best : __int_as_float(0x7f800000);
        *best_io = best;
        if (INST) *inst_io = best >= 0 ? binst : -1;
    }
}

__global__ void __launch_bounds__(BLOCK)
cluster_closest_hit_kernel(const float4* __restrict__ node_f,
                           const int* __restrict__ link,
                           const float4* __restrict__ feat,
                           const float* __restrict__ ox,
                           const float* __restrict__ oy,
                           const float* __restrict__ oz,
                           const float* __restrict__ dx,
                           const float* __restrict__ dy,
                           const float* __restrict__ dz,
                           const float* __restrict__ tmax,
                           float* __restrict__ t_out,
                           int* __restrict__ slot_out,
                           int n, int n_nodes, int ck) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float tm = tmax[i];
    float t = __int_as_float(0x7f800000);
    int slot = -1;
    if (tm > 0.0f) {  // t_max <= 0 (dead lanes) cannot hit: 0 < t < t_max
        const RayState r = load_ray(ox, oy, oz, dx, dy, dz, i);
        walk<false, false>(node_f, link, feat, nullptr, r, tm, n_nodes + 64,
                           ck, &t, &slot, nullptr, nullptr);
    }
    t_out[i] = t;
    slot_out[i] = slot;
}

__global__ void __launch_bounds__(BLOCK)
cluster_any_hit_kernel(const float4* __restrict__ node_f,
                       const int* __restrict__ link,
                       const float4* __restrict__ feat,
                       const float* __restrict__ ox,
                       const float* __restrict__ oy,
                       const float* __restrict__ oz,
                       const float* __restrict__ dx,
                       const float* __restrict__ dy,
                       const float* __restrict__ dz,
                       const float* __restrict__ tmax,
                       bool* __restrict__ occ_out,
                       int n, int n_nodes, int ck) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float tm = tmax[i];
    bool occ = false;
    if (tm > 0.0f) {
        const RayState r = load_ray(ox, oy, oz, dx, dy, dz, i);
        walk<true, false>(node_f, link, feat, nullptr, r, tm, n_nodes + 64,
                          ck, nullptr, nullptr, nullptr, &occ);
    }
    occ_out[i] = occ;
}

__global__ void __launch_bounds__(BLOCK)
inst_cluster_closest_hit_kernel(const float4* __restrict__ node_f,
                                const int* __restrict__ link,
                                const float4* __restrict__ feat,
                                const float4* __restrict__ inst_inv,
                                const float* __restrict__ ox,
                                const float* __restrict__ oy,
                                const float* __restrict__ oz,
                                const float* __restrict__ dx,
                                const float* __restrict__ dy,
                                const float* __restrict__ dz,
                                const float* __restrict__ tmax,
                                float* __restrict__ t_out,
                                int* __restrict__ slot_out,
                                int* __restrict__ inst_out,
                                int n, int fuel, int ck) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float tm = tmax[i];
    float t = __int_as_float(0x7f800000);
    int slot = -1, inst = -1;
    if (tm > 0.0f) {
        const RayState r = load_ray(ox, oy, oz, dx, dy, dz, i);
        walk<false, true>(node_f, link, feat, inst_inv, r, tm, fuel, ck, &t,
                          &slot, &inst, nullptr);
    }
    t_out[i] = t;
    slot_out[i] = slot;
    inst_out[i] = inst;
}

__global__ void __launch_bounds__(BLOCK)
inst_cluster_any_hit_kernel(const float4* __restrict__ node_f,
                            const int* __restrict__ link,
                            const float4* __restrict__ feat,
                            const float4* __restrict__ inst_inv,
                            const float* __restrict__ ox,
                            const float* __restrict__ oy,
                            const float* __restrict__ oz,
                            const float* __restrict__ dx,
                            const float* __restrict__ dy,
                            const float* __restrict__ dz,
                            const float* __restrict__ tmax,
                            bool* __restrict__ occ_out,
                            int n, int fuel, int ck) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float tm = tmax[i];
    bool occ = false;
    if (tm > 0.0f) {
        const RayState r = load_ray(ox, oy, oz, dx, dy, dz, i);
        walk<true, true>(node_f, link, feat, inst_inv, r, tm, fuel, ck,
                         nullptr, nullptr, nullptr, &occ);
    }
    occ_out[i] = occ;
}

// ---------------------------------------------------------------------------
// BVH2 walks (K3 flat, K4 instanced): the walks of every scene holding an
// analytic sphere, which has no plane form for the cluster slots.
//
// WHAT BOUNDS THEM on an H100. Per ray the work is its node steps (a slab
// test, 12 FP32 operations, over a 32-byte node row) and its prim tests,
// up to LEAF_K = 4 a leaf (46 FP32 operations a triangle, 31 a sphere,
// counted in prim_test below); an instance entry costs 36 as in K5. The
// bytes the function must move are the rays, the results and the tables
// once, so the roofline bound is the FP32 operations, some 0.02-0.1 ms
// for a 1M-lane wavefront. The real limiter of this first version is, as
// for K1/K2/K5, latency: one dependent node-row load a step, and threads
// of a warp that diverge onto different subtrees.
//
// DESIGN. One ray per thread, a stackless threaded walk over the node rows
// [min.xyz, max.x | max.yz, leaf_start, leaf_count] (bvh_node; the two
// integers held exactly as floats) and the links [hit8 | miss8] (bvh_link),
// picked by the thread's own direction octant, taken again after each
// change of space. At a leaf (leaf_count > 0) whose slab the ray hits, the
// thread tests its prims in order: closest hit replaces on a strictly
// smaller t (the lowest prim of a leaf keeps a tie, and across leaves the
// first visited), any hit stops at the first finite t <= t_max; either
// way it then takes the miss link. An inner node takes the hit or the miss
// link. Prim rows are [p0.xyz, e1.x | e1.yz, e2.xy | e2.z, type, 0, 0]
// (bvh_prim): a triangle's vertex and edges, or a sphere's center and
// [radius, ±1, 0]. Closest hit returns the winner's real u/v (0 for a
// sphere). None of the TPU kernels' block vote, block-wide slab culling or
// lax.cond leaf gating is carried over.
//
// INSTANCED (bvh_walk<.., true>): the table is [TLAS | world group's BLAS |
// each group's BLAS]. A TLAS leaf (leaf_start = instance id >= 0,
// leaf_count = 0) whose slab the ray hits moves the world ray to instance
// space as K5 does (d unnormalised, so t stays comparable; a sphere's
// quadratic divides by A = |d|^2), saves the leaf's miss link and jumps to
// the instance's own BLAS root, inst_root[id]. The JAX kernels read the
// root from inst_inv col 12, which the JAX build fills by group id from a
// per-instance array, wrong when instances do not bring their groups in
// order; this walk never reads col 12. BLAS_EXIT pops to the saved row and
// the world ray. The walk is capped at the scene's inst_fuel + 64 steps.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float inf_f() {
    return __int_as_float(0x7f800000);
}

// One prim row against the ray: t (+inf where it misses), and the
// triangle's barycentrics in *u, *v (0 for a sphere). Triangle: Möller–
// Trumbore, 46 FP32 operations (tv 3, pv 9, det 5, the divide, u 6, qv 9,
// v 6, t 6, u + v 1). Sphere: the stable quadratic, 31 (tv 3, A 5, B 6,
// C 7, disc 4, the square root, the three of qq, two divides).
__device__ __forceinline__ float prim_test(const float4* __restrict__ pr,
                                           const RayState& r, float* u_out,
                                           float* v_out) {
    const float4 q0 = __ldg(pr), q1 = __ldg(pr + 1), q2 = __ldg(pr + 2);
    const float tvx = r.ox - q0.x, tvy = r.oy - q0.y, tvz = r.oz - q0.z;
    const float e1x = q0.w, e1y = q1.x, e1z = q1.y;
    *u_out = 0.0f;
    *v_out = 0.0f;
    if (q2.y == 0.0f) {   // triangle (p0, e1, e2)
        const float e2x = q1.z, e2y = q1.w, e2z = q2.x;
        const float pvx = r.dy * e2z - r.dz * e2y;
        const float pvy = r.dz * e2x - r.dx * e2z;
        const float pvz = r.dx * e2y - r.dy * e2x;
        const float det = e1x * pvx + e1y * pvy + e1z * pvz;
        const float inv = fabsf(det) < 1e-12f ? 0.0f : 1.0f / det;
        const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
        const float qvx = tvy * e1z - tvz * e1y;
        const float qvy = tvz * e1x - tvx * e1z;
        const float qvz = tvx * e1y - tvy * e1x;
        const float v = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv;
        const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv;
        if (!((u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t > 0.0f)
              && (inv != 0.0f)))
            return inf_f();
        *u_out = u;
        *v_out = v;
        return t;
    }
    // sphere (center p0, radius e1.x)
    const float A = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
    const float B = 2.0f * (tvx * r.dx + tvy * r.dy + tvz * r.dz);
    const float C = tvx * tvx + tvy * tvy + tvz * tvz - e1x * e1x;
    const float disc = B * B - 4.0f * A * C;
    if (!(disc >= 0.0f)) return inf_f();
    const float sgn = B > 0.0f ? 1.0f : (B < 0.0f ? -1.0f : 0.0f);
    const float qq = -0.5f * (B + sgn * sqrtf(disc));
    const float t0 = fabsf(A) > 1e-20f ? qq / A : inf_f();
    const float t1 = fabsf(qq) > 1e-20f ? C / qq : inf_f();
    const float lo = fminf(t0, t1), hi = fmaxf(t0, t1);
    const float t = lo > 0.0f ? lo : hi;
    return t > 0.0f ? t : inf_f();
}

// The BVH2 walk of one ray. INST = false: one tree, `world` is the ray
// throughout. INST = true: the instanced walk described above.
template <bool ANY_HIT, bool INST>
__device__ __forceinline__ void bvh_walk(
        const float4* __restrict__ node, const int* __restrict__ link,
        const float4* __restrict__ prim, const float4* __restrict__ inst_inv,
        const int* __restrict__ inst_root, const RayState& world,
        float t_max, int fuel_cap, float* t_io, int* prim_io, float* u_io,
        float* v_io, int* inst_io, bool* occ_io) {
    RayState r = world;   // the ray in the current space
    float t_best = t_max, bu = 0.0f, bv = 0.0f;
    int best = -1;
    int binst = -1, cinst = -1, ret = -1;
    int nd = 0;
    for (int fuel = 0; nd >= 0 && fuel < fuel_cap; ++fuel) {
        const float4 a = __ldg(node + 2 * nd);
        const float4 b = __ldg(node + 2 * nd + 1);
        const int leaf_start = (int)b.z, leaf_count = (int)b.w;
        const bool hit = slab(a, b, r, ANY_HIT ? t_max : t_best);
        const int hit_link = __ldg(link + 16 * nd + r.oct);
        const int miss_link = __ldg(link + 16 * nd + 8 + r.oct);
        if (leaf_start >= 0 && leaf_count > 0) {
            if (hit) {
                for (int k = 0; k < leaf_count; ++k) {
                    float u, v;
                    const float t = prim_test(prim + 3 * (leaf_start + k), r,
                                              &u, &v);
                    if (ANY_HIT) {
                        if (t < inf_f() && t <= t_max) {
                            *occ_io = true;
                            return;           // stop at the first hit
                        }
                    } else if (t < t_best) {  // t = +inf where it misses
                        t_best = t;
                        best = leaf_start + k;
                        bu = u;
                        bv = v;
                        if (INST) binst = cinst;
                    }
                }
            }
            nd = miss_link;
        } else if (INST && leaf_start >= 0) {
            if (hit) {                        // enter instance leaf_start
                const float4* m = inst_inv + 4 * (size_t)leaf_start;
                const float4 m0 = __ldg(m), m1 = __ldg(m + 1),
                             m2 = __ldg(m + 2);
                r = to_local(m0, m1, m2, world);
                ret = miss_link;
                cinst = leaf_start;
                nd = __ldg(inst_root + leaf_start);
            } else {
                nd = miss_link;
            }
        } else {
            nd = hit ? hit_link : miss_link;
        }
        if (INST && nd == BLAS_EXIT) {        // pop to the TLAS
            nd = ret;
            ret = -1;
            cinst = -1;
            r = world;
        }
    }
    if (!ANY_HIT) {
        *t_io = best >= 0 ? t_best : inf_f();
        *prim_io = best;
        *u_io = bu;
        *v_io = bv;
        if (INST) *inst_io = best >= 0 ? binst : -1;
    }
}

__global__ void __launch_bounds__(BLOCK)
bvh_closest_hit_kernel(const float4* __restrict__ node,
                       const int* __restrict__ link,
                       const float4* __restrict__ prim,
                       const float* __restrict__ ox,
                       const float* __restrict__ oy,
                       const float* __restrict__ oz,
                       const float* __restrict__ dx,
                       const float* __restrict__ dy,
                       const float* __restrict__ dz,
                       const float* __restrict__ tmax,
                       float* __restrict__ t_out, int* __restrict__ prim_out,
                       float* __restrict__ u_out, float* __restrict__ v_out,
                       int n, int fuel) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float tm = tmax[i];
    float t = inf_f(), u = 0.0f, v = 0.0f;
    int p = -1;
    if (tm > 0.0f) {  // t_max <= 0 (dead lanes) cannot hit: 0 < t < t_max
        const RayState r = load_ray(ox, oy, oz, dx, dy, dz, i);
        bvh_walk<false, false>(node, link, prim, nullptr, nullptr, r, tm,
                               fuel, &t, &p, &u, &v, nullptr, nullptr);
    }
    t_out[i] = t;
    prim_out[i] = p;
    u_out[i] = u;
    v_out[i] = v;
}

__global__ void __launch_bounds__(BLOCK)
bvh_any_hit_kernel(const float4* __restrict__ node,
                   const int* __restrict__ link,
                   const float4* __restrict__ prim,
                   const float* __restrict__ ox,
                   const float* __restrict__ oy,
                   const float* __restrict__ oz,
                   const float* __restrict__ dx,
                   const float* __restrict__ dy,
                   const float* __restrict__ dz,
                   const float* __restrict__ tmax,
                   bool* __restrict__ occ_out, int n, int fuel) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float tm = tmax[i];
    bool occ = false;
    if (tm > 0.0f) {
        const RayState r = load_ray(ox, oy, oz, dx, dy, dz, i);
        bvh_walk<true, false>(node, link, prim, nullptr, nullptr, r, tm, fuel,
                              nullptr, nullptr, nullptr, nullptr, nullptr,
                              &occ);
    }
    occ_out[i] = occ;
}

__global__ void __launch_bounds__(BLOCK)
inst_bvh_closest_hit_kernel(const float4* __restrict__ node,
                            const int* __restrict__ link,
                            const float4* __restrict__ prim,
                            const float4* __restrict__ inst_inv,
                            const int* __restrict__ inst_root,
                            const float* __restrict__ ox,
                            const float* __restrict__ oy,
                            const float* __restrict__ oz,
                            const float* __restrict__ dx,
                            const float* __restrict__ dy,
                            const float* __restrict__ dz,
                            const float* __restrict__ tmax,
                            float* __restrict__ t_out,
                            int* __restrict__ prim_out,
                            float* __restrict__ u_out,
                            float* __restrict__ v_out,
                            int* __restrict__ inst_out, int n, int fuel) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float tm = tmax[i];
    float t = inf_f(), u = 0.0f, v = 0.0f;
    int p = -1, inst = -1;
    if (tm > 0.0f) {
        const RayState r = load_ray(ox, oy, oz, dx, dy, dz, i);
        bvh_walk<false, true>(node, link, prim, inst_inv, inst_root, r, tm,
                              fuel, &t, &p, &u, &v, &inst, nullptr);
    }
    t_out[i] = t;
    prim_out[i] = p;
    u_out[i] = u;
    v_out[i] = v;
    inst_out[i] = inst;
}

__global__ void __launch_bounds__(BLOCK)
inst_bvh_any_hit_kernel(const float4* __restrict__ node,
                        const int* __restrict__ link,
                        const float4* __restrict__ prim,
                        const float4* __restrict__ inst_inv,
                        const int* __restrict__ inst_root,
                        const float* __restrict__ ox,
                        const float* __restrict__ oy,
                        const float* __restrict__ oz,
                        const float* __restrict__ dx,
                        const float* __restrict__ dy,
                        const float* __restrict__ dz,
                        const float* __restrict__ tmax,
                        bool* __restrict__ occ_out, int n, int fuel) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float tm = tmax[i];
    bool occ = false;
    if (tm > 0.0f) {
        const RayState r = load_ray(ox, oy, oz, dx, dy, dz, i);
        bvh_walk<true, true>(node, link, prim, inst_inv, inst_root, r, tm,
                             fuel, nullptr, nullptr, nullptr, nullptr,
                             nullptr, &occ);
    }
    occ_out[i] = occ;
}

}  // namespace

extern "C" {

int mts_cluster_closest_hit(const void* node_f, const void* link,
                            const void* feat, const void* ox, const void* oy,
                            const void* oz, const void* dx, const void* dy,
                            const void* dz, const void* tmax, void* t_out,
                            void* slot_out, int n, int n_nodes, int ck,
                            void* stream) {
    const int grid = (n + BLOCK - 1) / BLOCK;
    cluster_closest_hit_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        (const float4*)node_f, (const int*)link, (const float4*)feat,
        (const float*)ox, (const float*)oy, (const float*)oz,
        (const float*)dx, (const float*)dy, (const float*)dz,
        (const float*)tmax, (float*)t_out, (int*)slot_out, n, n_nodes, ck);
    return (int)cudaGetLastError();
}

int mts_cluster_any_hit(const void* node_f, const void* link, const void* feat,
                        const void* ox, const void* oy, const void* oz,
                        const void* dx, const void* dy, const void* dz,
                        const void* tmax, void* occ_out, int n, int n_nodes,
                        int ck, void* stream) {
    const int grid = (n + BLOCK - 1) / BLOCK;
    cluster_any_hit_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        (const float4*)node_f, (const int*)link, (const float4*)feat,
        (const float*)ox, (const float*)oy, (const float*)oz,
        (const float*)dx, (const float*)dy, (const float*)dz,
        (const float*)tmax, (bool*)occ_out, n, n_nodes, ck);
    return (int)cudaGetLastError();
}

// fuel: the walk's step cap, the scene's inst_mxu_fuel + 64
int mts_inst_cluster_closest_hit(const void* node_f, const void* link,
                                 const void* feat, const void* inst_inv,
                                 const void* ox, const void* oy,
                                 const void* oz, const void* dx,
                                 const void* dy, const void* dz,
                                 const void* tmax, void* t_out,
                                 void* slot_out, void* inst_out, int n,
                                 int fuel, int ck, void* stream) {
    const int grid = (n + BLOCK - 1) / BLOCK;
    inst_cluster_closest_hit_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        (const float4*)node_f, (const int*)link, (const float4*)feat,
        (const float4*)inst_inv, (const float*)ox, (const float*)oy,
        (const float*)oz, (const float*)dx, (const float*)dy,
        (const float*)dz, (const float*)tmax, (float*)t_out, (int*)slot_out,
        (int*)inst_out, n, fuel, ck);
    return (int)cudaGetLastError();
}

int mts_inst_cluster_any_hit(const void* node_f, const void* link,
                             const void* feat, const void* inst_inv,
                             const void* ox, const void* oy, const void* oz,
                             const void* dx, const void* dy, const void* dz,
                             const void* tmax, void* occ_out, int n, int fuel,
                             int ck, void* stream) {
    const int grid = (n + BLOCK - 1) / BLOCK;
    inst_cluster_any_hit_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        (const float4*)node_f, (const int*)link, (const float4*)feat,
        (const float4*)inst_inv, (const float*)ox, (const float*)oy,
        (const float*)oz, (const float*)dx, (const float*)dy,
        (const float*)dz, (const float*)tmax, (bool*)occ_out, n, fuel, ck);
    return (int)cudaGetLastError();
}

// fuel: the walk's step cap, the node count + 64
int mts_bvh_closest_hit(const void* node, const void* link, const void* prim,
                        const void* ox, const void* oy, const void* oz,
                        const void* dx, const void* dy, const void* dz,
                        const void* tmax, void* t_out, void* prim_out,
                        void* u_out, void* v_out, int n, int fuel,
                        void* stream) {
    const int grid = (n + BLOCK - 1) / BLOCK;
    bvh_closest_hit_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        (const float4*)node, (const int*)link, (const float4*)prim,
        (const float*)ox, (const float*)oy, (const float*)oz,
        (const float*)dx, (const float*)dy, (const float*)dz,
        (const float*)tmax, (float*)t_out, (int*)prim_out, (float*)u_out,
        (float*)v_out, n, fuel);
    return (int)cudaGetLastError();
}

int mts_bvh_any_hit(const void* node, const void* link, const void* prim,
                    const void* ox, const void* oy, const void* oz,
                    const void* dx, const void* dy, const void* dz,
                    const void* tmax, void* occ_out, int n, int fuel,
                    void* stream) {
    const int grid = (n + BLOCK - 1) / BLOCK;
    bvh_any_hit_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        (const float4*)node, (const int*)link, (const float4*)prim,
        (const float*)ox, (const float*)oy, (const float*)oz,
        (const float*)dx, (const float*)dy, (const float*)dz,
        (const float*)tmax, (bool*)occ_out, n, fuel);
    return (int)cudaGetLastError();
}

// fuel: the walk's step cap, the scene's inst_fuel + 64
int mts_inst_bvh_closest_hit(const void* node, const void* link,
                             const void* prim, const void* inst_inv,
                             const void* inst_root, const void* ox,
                             const void* oy, const void* oz, const void* dx,
                             const void* dy, const void* dz, const void* tmax,
                             void* t_out, void* prim_out, void* u_out,
                             void* v_out, void* inst_out, int n, int fuel,
                             void* stream) {
    const int grid = (n + BLOCK - 1) / BLOCK;
    inst_bvh_closest_hit_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        (const float4*)node, (const int*)link, (const float4*)prim,
        (const float4*)inst_inv, (const int*)inst_root, (const float*)ox,
        (const float*)oy, (const float*)oz, (const float*)dx,
        (const float*)dy, (const float*)dz, (const float*)tmax,
        (float*)t_out, (int*)prim_out, (float*)u_out, (float*)v_out,
        (int*)inst_out, n, fuel);
    return (int)cudaGetLastError();
}

int mts_inst_bvh_any_hit(const void* node, const void* link, const void* prim,
                         const void* inst_inv, const void* inst_root,
                         const void* ox, const void* oy, const void* oz,
                         const void* dx, const void* dy, const void* dz,
                         const void* tmax, void* occ_out, int n, int fuel,
                         void* stream) {
    const int grid = (n + BLOCK - 1) / BLOCK;
    inst_bvh_any_hit_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        (const float4*)node, (const int*)link, (const float4*)prim,
        (const float4*)inst_inv, (const int*)inst_root, (const float*)ox,
        (const float*)oy, (const float*)oz, (const float*)dx,
        (const float*)dy, (const float*)dz, (const float*)tmax,
        (bool*)occ_out, n, fuel);
    return (int)cudaGetLastError();
}

const char* mts_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
