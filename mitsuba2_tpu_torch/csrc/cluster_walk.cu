// Cluster-walk ray traversal for Hopper (sm_90a): closest hit and any hit,
// over one cut tree or over a TLAS of instances.
//
// REPLACES the six MXU cluster-leaf kernels of the JAX package,
// mitsuba2_tpu/kernels/traverse_pallas.py:
//   cluster_closest_hit_kernel <- _closest_hit_mxu_kernel (:671) and
//                                 _closest_hit_mxu2_kernel (:877)
//   cluster_any_hit_kernel     <- _any_hit_mxu_kernel (:755) and
//                                 _any_hit_mxu2_kernel (:944)
//   inst_cluster_closest_hit_kernel <- _closest_hit_instmxu_kernel (:1746)
//   inst_cluster_any_hit_kernel     <- _any_hit_instmxu_kernel (:1856)
// mxu and mxu2 compute one function; they differ only in how the TPU
// interleaves two 4096-ray lockstep walks, which has no meaning here.
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

const char* mts_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
