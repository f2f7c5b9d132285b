// Ray traversal for Hopper (sm_90a): closest hit and any hit, over a
// cluster cut tree or a full BVH2, each flat or under a TLAS of instances,
// over the BVH8 collapse of either tree (flat), and by a dense sweep of
// every cluster (flat). The helpers they share with the probes
// (probes.cu) are in walk.cuh.
//
// REPLACES sixteen kernels of the JAX package,
// mitsuba2_tpu/kernels/traverse_pallas.py:
//   cluster_closest_hit_kernel <- _closest_hit_mxu_kernel (:671) and
//                                 _closest_hit_mxu2_kernel (:877)
//                                 (warp-cooperative visits, below)
//   cluster_any_hit_kernel     <- _any_hit_mxu_kernel (:755) and
//                                 _any_hit_mxu2_kernel (:944)
//                                 (warp-cooperative visits, below)
//   inst_cluster_closest_hit_kernel <- _closest_hit_instmxu_kernel (:1746)
//                                 (warp-cooperative visits, below)
//   inst_cluster_any_hit_kernel     <- _any_hit_instmxu_kernel (:1856)
//                                 (warp-cooperative visits, below)
//   bvh_closest_hit_kernel      <- _closest_hit_kernel (:250)
//                                 (the pair walk, below)
//   bvh_any_hit_kernel          <- _any_hit_kernel (:309)
//   inst_bvh_closest_hit_kernel <- _closest_hit_inst_kernel (:1382)
//                                 (warp-wide leaf tests, below)
//   inst_bvh_any_hit_kernel     <- _any_hit_inst_kernel (:1486)
//                                 (the pair walk, below)
//   bvh8_closest_hit_kernel     <- _closest_hit_bvh8_kernel (:2001)
//                                 (warp-wide leaf tests, below)
//   bvh8_any_hit_kernel         <- _any_hit_bvh8_kernel (:2117)
//   bvh8mxu_closest_hit_kernel  <- _closest_hit_bvh8mxu_kernel (:2316)
//                                 (warp-cooperative visits, below)
//   bvh8mxu_any_hit_kernel      <- _any_hit_bvh8mxu_kernel (:2433)
//                                 (warp-cooperative visits, below)
//   dense_closest_hit_kernel    <- _closest_hit_mxu_dense_kernel (:1040)
//   dense_any_hit_kernel        <- _any_hit_mxu_dense_kernel (:1071)
// mxu and mxu2 compute one function; they differ only in how the TPU
// interleaves two 4096-ray lockstep walks, which has no meaning here. The
// BVH2 walks are described after the cluster walks, the BVH8 walks after
// them and the dense sweep last, below.
//
// WHAT BOUNDS IT on an H100. Per ray the work is the cluster visits its
// walk needs: each visit tests CK = 128 triangle slots, 38 FP32 operations
// a real slot (four plane dots over the ray features, one divide, the
// scalings), and reads the cluster's 10 KB of plane rows (CK x 20 floats).
// The bytes the function must move are only the rays and the results
// (29-36 B a ray) plus the tables once, so the roofline bound is the FP32
// operations (67 TFLOP/s): on the mesh gallery's wavefronts, 1-1.4 cluster
// visits a ray, about 0.03 ms per million rays for the real slots.
//
// Built with --fmad=false (kernels/traverse.py): every product and sum is
// rounded as the plain PyTorch twin's separate operations round it, so
// kernel and twin agree bit for bit.
//
// THE WALK. A threaded stackless walk over the pruned cut tree: a node
// row is [min.xyz, max.xyz, slot base, pad, centroid.xyz, pad]
// (mxu_node_f) and its links are [hit8 | miss8] (mxu_link), picked by the
// ray's own direction octant (correctness does not depend on the octant;
// it only orders the walk near-first). At an inner node the slab test
// (tmin < t_best) chooses the hit or the miss link; at a cluster node the
// ray, if its slab hits, tests the cluster's CK slots and follows the miss
// link. The slot test is the Möller–Trumbore bilinear form: det, u, v and
// t numerators are dots of the slot's plane rows with the ray features
// [d, (o-c) x d, o-c, 1], recentred at the cluster centroid c. Everything
// is computed in f32: none of the TPU's bf16-split dot modes, lane-group
// culling, dual walks, block-vote octant or DMA scratch is carried over.
// Ties: within a cluster the lowest slot wins an equal t, across clusters
// the first one visited keeps it (strictly closer replaces).
//
// WARP-COOPERATIVE VISITS (K1 and K2, K5's and K7's closest and any hit;
// K7 walks the BVH8 tree, below, to its visits). The first version ran
// one ray per thread, the thread alone looping over a cluster's 128 slots
// when its slab hit: the threads of a warp that missed
// idled through that loop, and threads that wanted different clusters ran
// their loops one after another. The cluster-visit probe (probes.cu, P3)
// put such a visit at 8.8x the cost per ray of one that all 32 threads
// make together, and K1's bounce launches at that divergent cost. Now each
// lane still walks its own ray (cluster_walk), but only up to its next due
// visit (a cluster node whose slab it hits) or the end of its walk; then
// the whole warp serves every due visit together (warp_visit) and the
// lanes walk on, while any lane of the warp is still walking. warp_visit
// groups the lanes that want the same cluster (__match_any_sync on the
// slot base; on K5 a shared BLAS cluster, whatever instance each lane is
// in, since each lane brings its own instance-space ray). For each group
// the 32 lanes load the cluster's plane rows once, coalesced, in 64-slot
// tiles of two slots a lane held in registers (32-slot tiles of one on
// K5's any hit: TILE_J, below); then for each ray of the group the owner
// broadcasts its recentred features and its limit (__shfl_sync), and
// every lane runs the slot test on its slots of the tile. A ray's visit
// then costs CK/32 slot tests on each lane (4 at CK = 128) whatever the
// rest of its warp does. Two slots a lane, not four: 88 and 96 registers
// for K1 and K5 closest hit against 128 and 148, K1 within 2.4% of four's
// time and K5 18% faster (chip_tiles.py, H100 80GB HBM3, 700.00 W;
// PERF.md §6). No lane returns early: lanes past n and dead lanes
// (t_max <= 0) take part with their walk done, and every warp intrinsic
// names the full warp.
//
// CLOSEST HIT (K1, K5). The limit is the owner's t_best; two
// __reduce_min_sync give the smallest t (positive floats order as their
// bits) and the lowest slot holding it, and the owner keeps it if it is
// strictly under its t_best: the serial loop's rule, tile after tile, so
// t, slot and instance are bit-equal to the twin's.
//
// ANY HIT (K2, K5). Shadow rays are mostly unoccluded, so they walk to
// their end and visit as many clusters as bounce rays do: the per-thread
// visit bounded these kernels as it bounded K1. The walk is the closest
// hit's, its slab test against t_max throughout, and a lane's walk ends at
// its first hit. The limit broadcast is the owner's t_max, a slot hits at
// t <= t_max, and one __ballot_sync is the owner's vote: a hit in some
// lane's slots. An owner with a hit leaves the group's later tiles, and a
// group whose owners all hit loads no further tile. The result is an OR
// over the slots of every cluster whose slab the ray hits within t_max,
// up to the same step cap, which no order of the visits changes: occ is
// bit-equal to the twin's on every lane.
//
// INSTANCED WALK (INST = true): the table is [TLAS | per-group cut
// trees], the groups' clusters in local space. Instancing is one level
// deep, so one saved continuation replaces a stack: at a TLAS instance leaf
// (col 7 = instance id >= 0) whose slab the ray hits, the lane moves its
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

#include "walk.cuh"

namespace {

constexpr int BLOCK = 128;
constexpr int BLAS_EXIT = -2;    // scene/bvh.py: leave an instance's cut tree

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

constexpr unsigned FULL_WARP = 0xffffffffu;
// Plane-row slots a lane holds in a tile (a tile: the 32 * TILE_J slots a
// warp tests in one pass). K5's any hit holds one: 0.541 ms a launch
// against 0.582 at two on the instanced field's shadow wavefronts, where
// K2 is the faster at two (0.451 ms against 0.476 at one). K7 holds one:
// 76 registers against 102 at two, besides its BVH8 stack, and 3.760 ms
// a render's five launches on the gallery's wavefronts against 3.799 at
// two and 4.122 at four (chip_tiles.py, H100 80GB HBM3, 700.00 W;
// PERF.md §6).
constexpr int TILE_J = 2;
constexpr int INST_ANY_TILE_J = 1;
constexpr int BVH8C_TILE_J = 1;
// Rays a thread of the dense sweep (K8) tests on each slot's plane rows
// it loads (dense_sweep, below). Two: 70.8 / 47.6 ms a closest / any-hit
// launch on the gallery's wavefronts against 87.4 / 49.5 at one and
// 82.6 / 57.7 at four (40 / 64 / 80-90 registers, four spilling on the
// any hit; chip_tiles.py, H100 80GB HBM3, 700.00 W; PERF.md §6).
constexpr int DENSE_RAYS = 2;
constexpr unsigned NO_HIT = 0xffffffffu;  // above the bits of any finite t

// Work that no table load shows: the slot tests on plane rows held in
// registers. Nothing on the card; the g++ emulation of the tests
// (tests/test_torch_traverse.py) counts it.
#ifndef WORK_COUNT
#define WORK_COUNT(n) ((void)(n))
#endif

// Where a lane's walk stands: its ray in the current space (the world ray,
// or in an instanced walk the ray of the instance `cinst` it is in, with
// the TLAS row `ret` saved to return to), and the next node.
struct Cursor {
    RayState r;
    int node, cinst, ret;
};

// At a BLAS_EXIT link, back to the saved TLAS row and the world ray
template <bool INST>
__device__ __forceinline__ void pop_exit(Cursor& c, const RayState& world) {
    if (INST && c.node == BLAS_EXIT) {
        c.node = c.ret;
        c.ret = -1;
        c.cinst = -1;
        c.r = world;
    }
}

// One node step of a lane's walk at c.node, its slab tested against
// t_lim. At a cluster node whose slab the ray hits a visit is due: returns
// the cluster's slot base and its centroid in *cen, with c.node already on
// the miss link but not yet popped (pop_exit after the visit, which needs
// the instance-space ray). Otherwise moves c on (entering an instance at a
// TLAS instance leaf it hits) and returns -1.
template <bool INST>
__device__ __forceinline__ int node_step(const float4* __restrict__ node_f,
                                         const int* __restrict__ link,
                                         const float4* __restrict__ inst_inv,
                                         const RayState& world, Cursor& c,
                                         float t_lim, float4* cen) {
    const int node = c.node;
    const float4 a = __ldg(node_f + 4 * node);
    const float4 b = __ldg(node_f + 4 * node + 1);
    const int slot_base = (int)b.z;
    const bool hit = slab(a, b, c.r, t_lim);
    const int hit_link = __ldg(link + 16 * node + c.r.oct);
    const int miss_link = __ldg(link + 16 * node + 8 + c.r.oct);
    if (slot_base >= 0) {
        c.node = miss_link;
        if (hit) {
            *cen = __ldg(node_f + 4 * node + 2);
            return slot_base;
        }
    } else if (INST && hit && (int)b.w >= 0) {
        const int iid = (int)b.w;         // enter instance iid
        const float4* m = inst_inv + 4 * (size_t)iid;
        const float4 m0 = __ldg(m), m1 = __ldg(m + 1), m2 = __ldg(m + 2),
                     m3 = __ldg(m + 3);
        c.r = to_local(m0, m1, m2, world);
        c.ret = miss_link;
        c.cinst = iid;
        c.node = (int)m3.y;               // col 13: the cut-tree root
    } else {
        c.node = hit ? hit_link : miss_link;
    }
    pop_exit<INST>(c, world);
    return -1;
}

// The warp serves its due visits: every lane calls it, a lane with a
// visit due with the cluster's slot base `base` (else -1), the centroid c
// and its ray r in the current space. Each group of lanes due at one
// cluster is served in turn: the cluster's rows are loaded once per
// tile of 32 * TJ slots, TJ a lane, and each ray of the group is tested
// against them by all 32 lanes. Closest hit: a slot strictly nearer than
// the lane's *t_best replaces *t_best and *best (the lowest slot keeps a
// tie); returns whether one did. Any hit: *t_best is the lane's t_max and
// stays; returns whether a slot hits at t <= t_max. An owner with a hit
// leaves the group's later tiles, and a group whose owners all hit loads
// no further tile.
template <bool ANY_HIT, int TJ>
__device__ __forceinline__ bool warp_visit(const float4* __restrict__ feat,
                                           const float4& c,
                                           const RayState& r, int base,
                                           int ck, float* t_best,
                                           int* best) {
    const int lane = threadIdx.x & 31;
    // the lane's ray features, recentred at its cluster's centroid
    const float px = r.ox - c.x, py = r.oy - c.y, pz = r.oz - c.z;
    const float mx = py * r.dz - pz * r.dy;
    const float my = pz * r.dx - px * r.dz;
    const float mz = px * r.dy - py * r.dx;
    const unsigned group = __match_any_sync(FULL_WARP, base);
    unsigned due = __ballot_sync(FULL_WARP, base >= 0);
    bool found = false;
    while (due) {
        const int lead = __ffs(due) - 1;
        const unsigned members = __shfl_sync(FULL_WARP, group, lead);
        const int gbase = __shfl_sync(FULL_WARP, base, lead);
        due &= ~members;
        const float4* fs = feat + (size_t)gbase * FEAT_W4;
        // the group's owners still to test: all of them on a closest hit,
        // those without a hit yet on an any hit (warp-uniform)
        unsigned open = members;
        for (int k0 = 0; k0 < ck && open; k0 += 32 * TJ) {
            // this lane's slots of the tile: k0 + 32 j + lane
            float4 f[TJ][FEAT_W4];
#pragma unroll
            for (int j = 0; j < TJ; ++j) {
                const int k = k0 + 32 * j + lane;
                if (k < ck) {
#pragma unroll
                    for (int q = 0; q < FEAT_W4; ++q)
                        f[j][q] = __ldg(fs + (size_t)k * FEAT_W4 + q);
                }
            }
            for (unsigned todo = open; todo; todo &= todo - 1) {
                const int own = __ffs(todo) - 1;
                const float odx = __shfl_sync(FULL_WARP, r.dx, own);
                const float ody = __shfl_sync(FULL_WARP, r.dy, own);
                const float odz = __shfl_sync(FULL_WARP, r.dz, own);
                const float opx = __shfl_sync(FULL_WARP, px, own);
                const float opy = __shfl_sync(FULL_WARP, py, own);
                const float opz = __shfl_sync(FULL_WARP, pz, own);
                const float omx = __shfl_sync(FULL_WARP, mx, own);
                const float omy = __shfl_sync(FULL_WARP, my, own);
                const float omz = __shfl_sync(FULL_WARP, mz, own);
                const float tb = __shfl_sync(FULL_WARP, *t_best, own);
                // closest hit: this lane's nearest slot under tb, the
                // lowest on a tie; any hit: whether one of its slots hits
                unsigned key = NO_HIT;
                int slot = 0;
                bool hit = false;
                int tested = 0;
#pragma unroll
                for (int j = 0; j < TJ; ++j) {
                    const int k = k0 + 32 * j + lane;
                    float t;
                    if (k < ck) {
                        ++tested;
                        const bool ok = slot_planes(
                            f[j][0], f[j][1], f[j][2], f[j][3], f[j][4], odx,
                            ody, odz, opx, opy, opz, omx, omy, omz, &t);
                        if (ANY_HIT) {
                            hit = hit || (ok && t <= tb);
                        } else if (ok && t < tb &&
                                   __float_as_uint(t) < key) {
                            key = __float_as_uint(t);
                            slot = k;
                        }
                    }
                }
                WORK_COUNT(tested);
                if (ANY_HIT) {
                    // the owner's vote: some lane holds a slot it hits
                    if (__ballot_sync(FULL_WARP, hit) != 0u) {
                        open &= ~(1u << own);
                        found = found || lane == own;
                    }
                    continue;
                }
                // t > 0 here, and positive floats order as their bits
                const unsigned kmin = __reduce_min_sync(FULL_WARP, key);
                const unsigned smin = __reduce_min_sync(
                    FULL_WARP, key == kmin ? (unsigned)slot : NO_HIT);
                if (lane == own && kmin != NO_HIT) {
                    *t_best = __uint_as_float(kmin);
                    *best = gbase + (int)smin;
                    found = true;
                }
            }
        }
    }
    return found;
}

// The walk of a lane's ray `world`, warp-synchronous: the lane walks to
// its next due visit or the end of its walk, the warp serves the due
// visits together, and so on while any lane is walking. A lane that is
// not `live` (past n, or t_max <= 0) takes part, its walk done. Closest
// hit: *t_io, *best_io and, instanced, *inst_io. Any hit: the slab test
// stays against t_max (t_best never moves), and a lane's walk ends at its
// first hit, which sets *occ_io.
template <bool ANY_HIT, bool INST>
__device__ __forceinline__ void cluster_walk(
        const float4* __restrict__ node_f, const int* __restrict__ link,
        const float4* __restrict__ feat, const float4* __restrict__ inst_inv,
        const RayState& world, bool live, float t_max, int fuel_cap, int ck,
        float* t_io, int* best_io, int* inst_io, bool* occ_io) {
    Cursor c{world, 0, -1, -1};
    float t_best = t_max;
    int best = -1, binst = -1, fuel = 0;
    bool occ = false;
    bool done = !live || fuel_cap <= 0;
    while (__any_sync(FULL_WARP, !done)) {
        int base = -1;
        float4 cen = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        while (!done && base < 0) {       // to the next due visit
            base = node_step<INST>(node_f, link, inst_inv, world, c, t_best,
                                   &cen);
            ++fuel;
            if (base < 0) done = c.node < 0 || fuel >= fuel_cap;
        }
        if (warp_visit<ANY_HIT, ANY_HIT && INST ? INST_ANY_TILE_J : TILE_J>(
                feat, cen, c.r, base, ck, &t_best, &best)) {
            if (ANY_HIT) occ = true;
            else if (INST) binst = c.cinst;
        }
        if (base >= 0) {                  // the visit's step ends
            pop_exit<INST>(c, world);
            done = occ || c.node < 0 || fuel >= fuel_cap;
        }
    }
    if (ANY_HIT) {
        *occ_io = occ;
        return;
    }
    *t_io = best >= 0 ? t_best : inf_f();
    *best_io = best;
    if (INST) *inst_io = best >= 0 ? binst : -1;
}

// A thread's lane of a cluster-walk kernel: its ray, and whether it is
// live. No lane returns early: lanes past n and dead lanes (t_max <= 0,
// which cannot hit: 0 < t <= t_max) take part in the warp's visits with
// their walk done; only lanes i < n write their results.
__device__ __forceinline__ RayState lane_ray(
        const float* ox, const float* oy, const float* oz, const float* dx,
        const float* dy, const float* dz, const float* tmax, int i, int n,
        float* tm, bool* live) {
    *tm = i < n ? tmax[i] : 0.0f;
    *live = *tm > 0.0f;
    return *live ? load_ray(ox, oy, oz, dx, dy, dz, i)
                 : make_ray(0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f);
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
    float tm;
    bool live;
    const RayState r = lane_ray(ox, oy, oz, dx, dy, dz, tmax, i, n, &tm,
                                &live);
    float t;
    int slot;
    cluster_walk<false, false>(node_f, link, feat, nullptr, r, live, tm,
                               n_nodes + 64, ck, &t, &slot, nullptr,
                               nullptr);
    if (i < n) {
        t_out[i] = t;
        slot_out[i] = slot;
    }
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
    float tm;
    bool live;
    const RayState r = lane_ray(ox, oy, oz, dx, dy, dz, tmax, i, n, &tm,
                                &live);
    bool occ;
    cluster_walk<true, false>(node_f, link, feat, nullptr, r, live, tm,
                              n_nodes + 64, ck, nullptr, nullptr, nullptr,
                              &occ);
    if (i < n) occ_out[i] = occ;
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
    float tm;
    bool live;
    const RayState r = lane_ray(ox, oy, oz, dx, dy, dz, tmax, i, n, &tm,
                                &live);
    float t;
    int slot, inst;
    cluster_walk<false, true>(node_f, link, feat, inst_inv, r, live, tm,
                              fuel, ck, &t, &slot, &inst, nullptr);
    if (i < n) {
        t_out[i] = t;
        slot_out[i] = slot;
        inst_out[i] = inst;
    }
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
    float tm;
    bool live;
    const RayState r = lane_ray(ox, oy, oz, dx, dy, dz, tmax, i, n, &tm,
                                &live);
    bool occ;
    cluster_walk<true, true>(node_f, link, feat, inst_inv, r, live, tm,
                             fuel, ck, nullptr, nullptr, nullptr, &occ);
    if (i < n) occ_out[i] = occ;
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
// once, so the roofline bound is the bytes, 0.005-0.022 ms for a 1M-lane
// wavefront (PERF.md §6). The real limiter is latency: one dependent row
// load a step, and the lanes of a warp, which diverge onto different
// subtrees and reach leaves at different steps.
//
// DESIGN. A ray a lane, with its own direction octant, taken again after
// each change of space. The node rows are [min.xyz, max.x | max.yz,
// leaf_start, leaf_count] (bvh_node; the two integers held exactly as
// floats) and the links [hit8 | miss8] (bvh_link), picked by the octant.
// At a leaf (leaf_count > 0) whose slab the ray hits, its prims are tested
// in order: closest hit replaces on a strictly smaller t (the lowest prim
// of a leaf keeps a tie, and across leaves the first visited), any hit
// stops at the first finite t <= t_max. Prim rows are [p0.xyz, e1.x |
// e1.yz, e2.xy | e2.z, type, 0, 0] (bvh_prim): a triangle's vertex and
// edges, or a sphere's center and [radius, ±1, 0]. Closest hit returns the
// winner's real u/v (0 for a sphere). None of the TPU kernels' block vote,
// block-wide slab culling or lax.cond leaf gating is carried over. Two
// walks visit the same leaves in the same order:
//
// THE THREADED WALK (bvh_steps: the fallback; K4's closest hit in rounds,
// below). Stackless over the links: a step loads a node row and its two
// links, slab-tests the node against t_best (closest hit) or t_max (any
// hit) and takes the hit link (an inner node's first child in the octant's
// order) or the miss link (the next node after its subtree); a leaf tests
// its prims and takes the miss link. A walk that expands E inner nodes
// takes 1 + 2E such steps, half of them to a child whose slab test then
// culls it, and each step's next row waits on that step's loads.
//
// THE PAIR WALK (bvh_pair_walk: K3's both hits and K4's any hit). A stack
// walk over the child-pair rows (bvh_pair, convert.bvh_pair_rows): row n
// of an inner node n holds both children as two records [min.xyz, max.xyz,
// ref, row], each box the very floats of the child's bvh_node row, so the
// slab gives the same tmin and tmax. ref >= 0 is an inner child's row, ~x
// a leaf: x = start << 2 | (count - 1) a prim leaf, x = PAIR_INST | id an
// instance leaf; row is the child's own row, and bits 24-31 of the first
// record's row word say for each octant whether the second record comes
// first (by the links: first = hit8[n], second = miss8[first]). The walk
// tests the root's slab from its node row, then at an inner node loads
// its pair row once (4 float4) and slab-tests both children: both hit,
// it pushes the far one (ref and tmin; the any hit, which never re-culls,
// keeps the row instead) and enters the near one; one hits, it enters
// that one; none, it pops. A leaf it enters runs leaf_visit unchanged,
// then pops. A closest-hit pop re-culls its child with tmin < t_best,
// which is the threaded walk's slab test of that child at that moment
// (tmin <= tmax and tmax > 0 held at the push and do not depend on t_best;
// a child culled at the push under a larger t_best stays culled), so the
// walk reaches the same leaves in the same order with the same t_best at
// each test: t, prim, u, v and the occlusion equal the threaded walk's,
// and the twin's, on every lane. A culled child now costs a slab test in
// its parent's step, not a step of its own. The stack is BVH_PAIR_STACK
// (ref, tmin or row) pairs in local memory; a push that finds it full
// hands the lane to the threaded walk at the child it was entering (its
// row, t_best, ray and, in an instance, the TLAS leaf's miss link as the
// saved continuation), whose miss links
// carry the whole remaining order, the stacked children's included: the
// JAX kernels are stackless and render any depth, so no tree is refused.
// A pass of the loop expands a node and visits or enters the leaf child it
// goes to, or visits or enters a popped leaf; it then pops where it must.
// The loop has one exit and no branch jumps out of it: with `continue`
// and `break` in its branches the lanes of a warp did not reconverge
// until the walk's end, and the first build ran K3's closest hit at
// 0.76 ms a launch against the threaded walk's 0.31. Each pass counts as
// a step of the walk's fuel and stands for distinct steps of the threaded
// walk, so the cap binds no sooner.
//
// WARP-WIDE LEAF TESTS (K4's closest hit, inst_bvh_closest_walk; K6's
// below).
// In the thread-alone walk a step's leaf loop runs max(count) times for
// the few lanes of the warp at a leaf while the others wait: on K4's rays
// a warp made 56.7-68.0 such prim passes where a lane needs 3.6-5.2 prim
// tests (the CPU twins, 4 096 lanes in presort order). Now the walk is
// warp-synchronous in rounds: each lane walks on alone, up to
// BVH_ROUND_STEPS steps, and at a leaf stops and posts it instead of
// testing it; the warp then tests the round's due (ray, prim) pairs
// together, 32 a pass (warp_leaf_visit), and the lanes walk on while any
// lane is walking. A lane's steps, its t_best at each slab test and its
// fuel are the thread-alone walk's, and warp_leaf_visit keeps its rule,
// so t, prim, u, v and the instance are bit-equal to the twin's on every
// lane. No lane returns early: lanes past n and dead lanes (t_max <= 0)
// take part with their walk done. The pop at a BLAS_EXIT link branches
// (pop_branch) where the thread-alone walk selects.
//
// MEASURED (chip_smoke.py, chip_tiles.py; H100 80GB HBM3, 700.00 W;
// PERF.md §6): K4's closest hit took 0.366 ms a launch thread-alone and
// takes 0.348 so, against a bound of 0.0123 (bytes); at 1 / 4 / 8 / 16
// steps a round 0.411 / 0.354 / 0.346 / 0.364. Its warps make 2.7-6.3
// leaf passes on the main path's wavefronts: the steps of the walk, not
// its leaf tests, set its time. The pair walk (chip_smoke.py, parent and
// tree in turns, the same card): K3's closest hit 0.309 ms a launch by
// the threaded walk and 0.274 by the pair walk, K4's any hit 0.345 and
// 0.273, against bounds of 0.0215 and 0.0049 (bytes); a camera lane of
// K3 expands 11.0 pair rows and pops 2.2 entries where the threaded walk
// takes 23.0 steps; no lane's stack fills there (0 fallback steps). K3's
// any hit: 0.296 ms a launch by the threaded walk, 0.245 by the pair walk
// (bound 0.0153).
//
// INSTANCED (bvh_steps<.., true>, bvh_pair_walk<true, true>): the table
// is [TLAS | world group's BLAS | each group's BLAS]. A TLAS leaf
// (leaf_start = instance id >= 0, leaf_count = 0) whose slab the ray hits
// moves the world ray to instance space as K5 does (d unnormalised, so t
// stays comparable; a sphere's quadratic divides by A = |d|^2) and enters
// the instance's own BLAS root, inst_root[id]. The JAX kernels read the
// root from inst_inv col 12, which the JAX build fills by group id from a
// per-instance array, wrong when instances do not bring their groups in
// order; these walks never read col 12. The threaded walk saves the
// leaf's miss link and pops to it, with the world ray, at a BLAS_EXIT
// link. The pair walk marks the stack depth at the entry (its exit
// marker, held in a register, not a slot), tests the BLAS root's slab from
// its node row, and restores the world ray when a pop reaches the mark.
// The walks are capped at the scene's inst_fuel + 64 steps.
// ---------------------------------------------------------------------------

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

// One leaf visit: `count` prims from `first`, tested in order. Any hit:
// true at the first finite t <= t_lim. Closest hit: a prim strictly
// nearer than *t_best replaces *t_best, *best and its u/v (the lowest prim
// of the leaf keeps a tie); returns whether one did.
template <bool ANY_HIT>
__device__ __forceinline__ bool leaf_visit(const float4* __restrict__ prim,
                                           int first, int count,
                                           const RayState& r, float t_lim,
                                           float* t_best, int* best,
                                           float* bu, float* bv) {
    bool closer = false;
    for (int k = 0; k < count; ++k) {
        float u, v;
        const float t = prim_test(prim + 3 * (size_t)(first + k), r, &u, &v);
        if (ANY_HIT) {
            if (t < inf_f() && t <= t_lim) return true;   // the first hit
        } else if (t < *t_best) {     // t = +inf where it misses
            *t_best = t;
            *best = first + k;
            *bu = u;
            *bv = v;
            closer = true;
        }
    }
    return closer;
}

// The most prims a leaf holds (scene/bvh.py::LEAF_K, the BVH build's cap):
// a round's due (ray, prim) pairs in a warp are at most 32 * LEAF_K.
constexpr int LEAF_K = 4;
// The most steps a lane of K4's (K6's) closest hit takes in a round of
// its warp's walk before the warp tests the round's leaves together; it
// stops earlier at a leaf. One step a round adds a vote and three
// convergence points to every step, and unbounded rounds hold a lane at
// its leaf until every lane of the warp has reached one (chip_tiles.py
// sweeps both; PERF.md §6).
constexpr int BVH_ROUND_STEPS = 8;
constexpr int BVH8_ROUND_STEPS = 2;

// The warp's leaf tests of one round, closest hit: every lane calls it, a
// lane with a leaf due with its prims' `first` and `count` (1..LEAF_K,
// else 0) and its ray r in the current space. The due (ray, prim) pairs
// are numbered in lane order, then prim order (a prefix sum from three
// ballots: count > 0 and the two bits of count - 1), and in pass p lane j
// tests pair 32 p + j on its owner's ray (__shfl_sync). Each owner then
// takes its pairs of the pass in prim order: one strictly nearer than
// *t_best replaces *t_best, *best and, from the lane that tested it, *bu
// and *bv, as leaf_visit<false> does. Returns whether one did. A round
// with no due leaf in the warp costs the first ballot.
__device__ __forceinline__ bool warp_leaf_visit(
        const float4* __restrict__ prim, int first, int count,
        const RayState& r, float* t_best, int* best, float* bu, float* bv) {
    const unsigned due = __ballot_sync(FULL_WARP, count > 0);
    if (due == 0u) return false;
    const int lane = threadIdx.x & 31;
    const unsigned c0 =
        __ballot_sync(FULL_WARP, count > 0 && ((count - 1) & 1));
    const unsigned c1 =
        __ballot_sync(FULL_WARP, count > 0 && ((count - 1) & 2));
    const unsigned below = (1u << lane) - 1u;
    const int off = __popc(due & below) + __popc(c0 & below) +
                    2 * __popc(c1 & below);         // the lane's first pair
    const int total = __popc(due) + __popc(c0) + 2 * __popc(c1);
    const int kmax = (c0 & c1) ? 4 : c1 ? 3 : c0 ? 2 : 1;   // largest count
    // each pair's owner lane and its prim's place in the leaf
    __shared__ unsigned char pair_of[BLOCK / 32][32 * LEAF_K];
    unsigned char* pairs = pair_of[threadIdx.x >> 5];
    __syncwarp();                 // the previous round's readers are done
    for (int k = 0; k < count; ++k)
        pairs[off + k] = (unsigned char)(lane | (k << 5));
    __syncwarp();
    bool closer = false;
    for (int p0 = 0; p0 < total; p0 += 32) {
        const int q = p0 + lane;
        const int pk = q < total ? pairs[q] : lane;
        const int own = pk & 31;
        RayState o;               // the owner's ray; prim_test reads o and d
        o.ox = __shfl_sync(FULL_WARP, r.ox, own);
        o.oy = __shfl_sync(FULL_WARP, r.oy, own);
        o.oz = __shfl_sync(FULL_WARP, r.oz, own);
        o.dx = __shfl_sync(FULL_WARP, r.dx, own);
        o.dy = __shfl_sync(FULL_WARP, r.dy, own);
        o.dz = __shfl_sync(FULL_WARP, r.dz, own);
        const int pid = __shfl_sync(FULL_WARP, first, own) + (pk >> 5);
        float t = inf_f(), u = 0.0f, v = 0.0f;
        if (q < total) t = prim_test(prim + 3 * (size_t)pid, o, &u, &v);
        WORK_COUNT(lane == 0);    // one pass of the warp
        // the owner's pairs of this pass, in prim order: the serial rule
        int win = -1;
        for (int k = 0; k < kmax; ++k) {
            const int src = off + k - p0;   // the lane holding pair k
            const float tk = __shfl_sync(FULL_WARP, t, src & 31);
            if (k < count && src >= 0 && src < 32 && tk < *t_best) {
                *t_best = tk;
                *best = first + k;
                win = src;
            }
        }
        const float uw = __shfl_sync(FULL_WARP, u, win & 31);
        const float vw = __shfl_sync(FULL_WARP, v, win & 31);
        if (win >= 0) {
            *bu = uw;
            *bv = vw;
            closer = true;
        }
    }
    return closer;
}

// A BVH2 walk of one ray where it stands: its ray in the current space,
// its best hit, the instance it is in (cinst) and the TLAS row to return
// to (ret), its next node and the steps it has taken.
struct Bvh2Walk {
    RayState r;
    float t_best, bu, bv;
    int best, binst, cinst, ret, nd, fuel;
};

// The threaded BVH2 walk from where `w` stands to its end, its step cap or
// (any hit) its first hit, which returns true. INST = false: one tree,
// `world` is the ray throughout. INST = true: the instanced walk
// described above.
template <bool ANY_HIT, bool INST>
__device__ __forceinline__ bool bvh_steps(
        const float4* __restrict__ node, const int* __restrict__ link,
        const float4* __restrict__ prim, const float4* __restrict__ inst_inv,
        const int* __restrict__ inst_root, const RayState& world,
        float t_max, int fuel_cap, Bvh2Walk& w) {
    for (; w.nd >= 0 && w.fuel < fuel_cap; ++w.fuel) {
        const int nd = w.nd;
        const float4 a = __ldg(node + 2 * nd);
        const float4 b = __ldg(node + 2 * nd + 1);
        const int leaf_start = (int)b.z, leaf_count = (int)b.w;
        const bool hit = slab(a, b, w.r, ANY_HIT ? t_max : w.t_best);
        const int hit_link = __ldg(link + 16 * nd + w.r.oct);
        const int miss_link = __ldg(link + 16 * nd + 8 + w.r.oct);
        if (leaf_start >= 0 && leaf_count > 0) {
            if (hit && leaf_visit<ANY_HIT>(prim, leaf_start, leaf_count, w.r,
                                           t_max, &w.t_best, &w.best, &w.bu,
                                           &w.bv)) {
                if (ANY_HIT) return true;
                if (INST) w.binst = w.cinst;
            }
            w.nd = miss_link;
        } else if (INST && leaf_start >= 0) {
            if (hit) {                        // enter instance leaf_start
                const float4* m = inst_inv + 4 * (size_t)leaf_start;
                const float4 m0 = __ldg(m), m1 = __ldg(m + 1),
                             m2 = __ldg(m + 2);
                w.r = to_local(m0, m1, m2, world);
                w.ret = miss_link;
                w.cinst = leaf_start;
                w.nd = __ldg(inst_root + leaf_start);
            } else {
                w.nd = miss_link;
            }
        } else {
            w.nd = hit ? hit_link : miss_link;
        }
        if (INST && w.nd == BLAS_EXIT) {      // pop to the TLAS
            w.nd = w.ret;
            w.ret = -1;
            w.cinst = -1;
            w.r = world;
        }
    }
    return false;
}

// A walk's outputs: the occlusion, or t (+inf on a miss), prim, u, v and
// the instance of the best hit.
template <bool ANY_HIT, bool INST>
__device__ __forceinline__ void bvh_results(const Bvh2Walk& w, bool occ,
                                            float* t_io, int* prim_io,
                                            float* u_io, float* v_io,
                                            int* inst_io, bool* occ_io) {
    if (ANY_HIT) {
        *occ_io = occ;
    } else {
        *t_io = w.best >= 0 ? w.t_best : inf_f();
        *prim_io = w.best;
        *u_io = w.bu;
        *v_io = w.bv;
        if (INST) *inst_io = w.best >= 0 ? w.binst : -1;
    }
}

// The child-pair rows' encoding (convert.py::bvh_pair_rows): the tag of an
// instance leaf's reference, and the bits of a row id below the octant
// mask.
constexpr int PAIR_INST = 1 << 30;
constexpr int PAIR_ROW_BITS = 24;
// (reference, tmin or row) entries of a pair walk's stack
// (kernels/traverse.py::BVH_PAIR_STACK); a push that finds it full hands
// the lane to the threaded walk
constexpr int BVH_PAIR_STACK = 32;

// slab's test without its limit: whether the ray's line meets the box
// ahead of the origin; the entry distance in *tmin_out, bit for bit
// slab's tmin.
__device__ __forceinline__ bool slab_open(const float4& a, const float4& b,
                                          const RayState& r,
                                          float* tmin_out) {
    float t0x = (a.x - r.ox) * r.ix, t1x = (a.w - r.ox) * r.ix;
    float t0y = (a.y - r.oy) * r.iy, t1y = (b.x - r.oy) * r.iy;
    float t0z = (a.z - r.oz) * r.iz, t1z = (b.y - r.oz) * r.iz;
    float tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                       fminf(t0z, t1z));
    float tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                       fmaxf(t0z, t1z));
    *tmin_out = tmin;
    return (tmin <= tmax) && (tmax > 0.0f);
}

// The pair-row reference of node `row` from its bvh_node row's second half
__device__ __forceinline__ int node_ref(const float4& b, int row) {
    const int start = (int)b.z, count = (int)b.w;
    if (start < 0) return row;
    return ~(count > 0 ? (start << 2) | (count - 1) : PAIR_INST | start);
}

// The pair walk of one ray (described above). The instanced closest hit
// keeps the threaded walk in rounds (inst_bvh_closest_walk), so INST
// comes with ANY_HIT only: its stack keeps rows, which a fallback inside
// an instance needs for the TLAS leaf's miss link.
template <bool ANY_HIT, bool INST>
__device__ __forceinline__ void bvh_pair_walk(
        const float4* __restrict__ node, const int* __restrict__ link,
        const float4* __restrict__ pair, const float4* __restrict__ prim,
        const float4* __restrict__ inst_inv,
        const int* __restrict__ inst_root, const RayState& world,
        float t_max, int fuel_cap, float* t_io, int* prim_io, float* u_io,
        float* v_io, int* inst_io, bool* occ_io) {
    static_assert(ANY_HIT || !INST, "the instanced closest hit walks "
                                    "in rounds");
    Bvh2Walk w{world, t_max, 0.0f, 0.0f, -1, -1, -1, -1, -1, 0};
    int2 stack[BVH_PAIR_STACK];
    int sp = 0, exit_sp = -1, inst_row = -1, cur_row = 0;
    bool occ = false, full = false;
    float tr;
    const float4 ra = __ldg(node), rb = __ldg(node + 1);
    bool go = slab_open(ra, rb, w.r, &tr) && tr < t_max && fuel_cap > 0;
    int cur = node_ref(rb, 0);
    // One exit and no jump out of a branch: every pass ends where the
    // lanes of a warp reconverge, whichever branch each took.
    for (; go; ++w.fuel) {
        bool pop = false;
        if (cur >= 0) {                       // an inner node: its children
            const float4* p = pair + 4 * (size_t)cur;
            const float4 a0 = __ldg(p), b0 = __ldg(p + 1);
            const float4 a1 = __ldg(p + 2), b1 = __ldg(p + 3);
            const float lim = ANY_HIT ? t_max : w.t_best;
            float t0, t1;
            const bool h0 = slab_open(a0, b0, w.r, &t0) && t0 < lim;
            const bool h1 = slab_open(a1, b1, w.r, &t1) && t1 < lim;
            const int word0 = __float_as_int(b0.w);
            const int row0 = word0 & ((1 << PAIR_ROW_BITS) - 1);
            const int row1 = __float_as_int(b1.w);
            // the child entered: the one that hits, or the near one
            const bool in1 =
                h1 && (!h0 || ((word0 >> (PAIR_ROW_BITS + w.r.oct)) & 1));
            if (h0 && h1) {                   // the far one waits
                if (sp == BVH_PAIR_STACK) {
                    w.nd = in1 ? row1 : row0;
                    full = true;
                } else {
                    stack[sp++] = make_int2(
                        __float_as_int(in1 ? b0.z : b1.z),
                        ANY_HIT ? (in1 ? row0 : row1)
                                : __float_as_int(in1 ? t0 : t1));
                }
            }
            cur = __float_as_int(in1 ? b1.z : b0.z);
            if (INST) cur_row = in1 ? row1 : row0;
            pop = !(h0 || h1) || full;
        }
        // a leaf, entered in this pass or reached by a pop or a root test
        if (!pop && cur < 0 && (!INST || !(~cur & PAIR_INST))) {
            const int x = ~cur;
            occ = leaf_visit<ANY_HIT>(prim, x >> 2, (x & 3) + 1, w.r, t_max,
                                      &w.t_best, &w.best, &w.bu, &w.bv) &&
                  ANY_HIT;
            pop = true;
        } else if (INST && !pop && cur < 0) { // an instance leaf: enter it
            const int id = ~cur & (PAIR_INST - 1);
            const float4* m = inst_inv + 4 * (size_t)id;
            const float4 m0 = __ldg(m), m1 = __ldg(m + 1), m2 = __ldg(m + 2);
            w.r = to_local(m0, m1, m2, world);
            inst_row = cur_row;
            exit_sp = sp;
            const int root = __ldg(inst_root + id);
            const float4 a = __ldg(node + 2 * (size_t)root);
            const float4 b = __ldg(node + 2 * (size_t)root + 1);
            pop = !(slab_open(a, b, w.r, &tr) && tr < t_max);
            cur = node_ref(b, root);
            cur_row = root;
        }
        if (pop && !occ && !full) {           // the next child that waits
            pop = false;
            while (!pop && sp > 0) {
                if (INST && sp == exit_sp) {  // the instance is done
                    w.r = world;
                    exit_sp = -1;
                }
                const int2 e = stack[--sp];
                WORK_COUNT(1);
                pop = ANY_HIT || __int_as_float(e.y) < w.t_best;
                cur = e.x;
                if (INST) cur_row = e.y;
            }
            go = pop;
        }
        go = go && !full && !occ && w.fuel + 1 < fuel_cap;
    }
    if (full) {               // on with the threaded walk from the child
        if (INST && exit_sp >= 0)
            w.ret = __ldg(link + 16 * (size_t)inst_row + 8 + world.oct);
        occ = bvh_steps<ANY_HIT, INST>(node, link, prim, inst_inv, inst_root,
                                       world, t_max, fuel_cap, w);
    }
    bvh_results<ANY_HIT, INST>(w, occ, t_io, prim_io, u_io, v_io, inst_io,
                               occ_io);
}

// At a BLAS_EXIT link, back to the saved TLAS row and the world ray, as
// pop_exit does but by a branch: the pop is rare, and as selects it cost
// each step of K4's closest hit ten moves.
__device__ __forceinline__ void pop_branch(Cursor& c, const RayState& world) {
    if (c.node == BLAS_EXIT) {
        asm volatile("" ::: "memory");    // keeps the branch
        c.node = c.ret;
        c.ret = -1;
        c.cinst = -1;
        c.r = world;
    }
}

// The closest-hit instanced BVH2 walk of a lane's ray `world` (K4),
// warp-synchronous in rounds: each walking lane takes up to
// BVH_ROUND_STEPS steps of its own walk (bvh_walk's instanced steps, the
// slab test against t_best), stopping at the step that reaches a leaf
// whose slab it hits; then the warp tests the round's due leaves together
// (warp_leaf_visit), while any lane of the warp is walking. A lane that
// is not `live` (past n, or t_max <= 0) takes part, its walk done. A
// BLAS_EXIT link after a leaf pops once the leaf is tested, which needs
// the instance-space ray. Each lane's steps, its t_best at each slab test
// and its fuel are the serial walk's.
__device__ __forceinline__ void inst_bvh_closest_walk(
        const float4* __restrict__ node, const int* __restrict__ link,
        const float4* __restrict__ prim, const float4* __restrict__ inst_inv,
        const int* __restrict__ inst_root, const RayState& world, bool live,
        float t_max, int fuel_cap, float* t_io, int* prim_io, float* u_io,
        float* v_io, int* inst_io) {
    Cursor c{world, 0, -1, -1};
    float t_best = t_max, bu = 0.0f, bv = 0.0f;
    int best = -1, binst = -1, fuel = 0;
    bool done = !live || fuel_cap <= 0;
    while (__any_sync(FULL_WARP, !done)) {
        int first = 0, count = 0;     // the lane's due leaf
        for (int s = 0; s < BVH_ROUND_STEPS && !done && count == 0; ++s) {
            const int nd = c.node;
            const float4 a = __ldg(node + 2 * nd);
            const float4 b = __ldg(node + 2 * nd + 1);
            const int leaf_start = (int)b.z, leaf_count = (int)b.w;
            const bool hit = slab(a, b, c.r, t_best);
            const int hit_link = __ldg(link + 16 * nd + c.r.oct);
            const int miss_link = __ldg(link + 16 * nd + 8 + c.r.oct);
            if (leaf_start >= 0 && leaf_count > 0) {
                if (hit) {
                    first = leaf_start;
                    count = leaf_count;
                }
                c.node = miss_link;
            } else if (leaf_start >= 0) {
                if (hit) {                    // enter instance leaf_start
                    const float4* m = inst_inv + 4 * (size_t)leaf_start;
                    const float4 m0 = __ldg(m), m1 = __ldg(m + 1),
                                 m2 = __ldg(m + 2);
                    c.r = to_local(m0, m1, m2, world);
                    c.ret = miss_link;
                    c.cinst = leaf_start;
                    c.node = __ldg(inst_root + leaf_start);
                } else {
                    c.node = miss_link;
                }
            } else {
                c.node = hit ? hit_link : miss_link;
            }
            ++fuel;
            if (count == 0) {
                pop_branch(c, world);
                done = c.node < 0 || fuel >= fuel_cap;
            }
        }
        if (warp_leaf_visit(prim, first, count, c.r, &t_best, &best, &bu,
                            &bv))
            binst = c.cinst;
        if (count > 0) {              // the leaf's step ends
            pop_branch(c, world);
            done = c.node < 0 || fuel >= fuel_cap;
        }
    }
    *t_io = best >= 0 ? t_best : inf_f();
    *prim_io = best;
    *u_io = bu;
    *v_io = bv;
    *inst_io = best >= 0 ? binst : -1;
}

__global__ void __launch_bounds__(BLOCK)
bvh_closest_hit_kernel(const float4* __restrict__ node,
                       const int* __restrict__ link,
                       const float4* __restrict__ pair,
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
        bvh_pair_walk<false, false>(node, link, pair, prim, nullptr, nullptr,
                                    r, tm, fuel, &t, &p, &u, &v, nullptr,
                                    nullptr);
    }
    t_out[i] = t;
    prim_out[i] = p;
    u_out[i] = u;
    v_out[i] = v;
}

__global__ void __launch_bounds__(BLOCK)
bvh_any_hit_kernel(const float4* __restrict__ node,
                   const int* __restrict__ link,
                   const float4* __restrict__ pair,
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
        bvh_pair_walk<true, false>(node, link, pair, prim, nullptr, nullptr,
                                   r, tm, fuel, nullptr, nullptr, nullptr,
                                   nullptr, nullptr, &occ);
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
    float tm;
    bool live;
    const RayState r = lane_ray(ox, oy, oz, dx, dy, dz, tmax, i, n, &tm,
                                &live);
    float t, u, v;
    int p, inst;
    inst_bvh_closest_walk(node, link, prim, inst_inv, inst_root, r, live, tm,
                          fuel, &t, &p, &u, &v, &inst);
    if (i < n) {
        t_out[i] = t;
        prim_out[i] = p;
        u_out[i] = u;
        v_out[i] = v;
        inst_out[i] = inst;
    }
}

__global__ void __launch_bounds__(BLOCK)
inst_bvh_any_hit_kernel(const float4* __restrict__ node,
                        const int* __restrict__ link,
                        const float4* __restrict__ pair,
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
        bvh_pair_walk<true, true>(node, link, pair, prim, inst_inv,
                                  inst_root, r, tm, fuel, nullptr, nullptr,
                                  nullptr, nullptr, nullptr, &occ);
    }
    occ_out[i] = occ;
}

// ---------------------------------------------------------------------------
// BVH8 walks (K6 over prim leaves, K7 over cluster leaves), the kernels of
// set_backend("bvh8") and ("bvh8mxu") on flat scenes.
//
// WHAT BOUNDS THEM on an H100. Per ray the work is its fresh node visits
// (8 slab tests of 12 FP32 operations over 8 child rows), its advances (a
// closest-hit advance re-culls the child: one more slab test), and its
// leaf tests: K6 up to LEAF_K = 4 prims a leaf (46 FP32 operations a
// triangle, 31 a sphere, prim_test above), K7 the CK = 128 slots of a
// cluster (38 each, slot_planes; padding slots not charged). The bytes
// the function must move are the rays, the results and the tables once,
// so the roofline bound is a few hundredths of a millisecond for a
// 1M-lane wavefront, by bytes or by operations (K7 on the gallery's
// wavefronts: 0.031 ms a closest-hit, 0.029 an any-hit launch, by
// operations). The real limiter is latency: each step waits on a
// dependent child-row load, and the threads of a warp diverge onto
// different subtrees.
//
// DESIGN. One ray per lane and a stack walk, the JAX kernels' state
// machine one step a loop iteration (K7: bvh8c_step). A fresh visit of node
// `cur` reads the order row order8[cur*8 + octant] (the ray's own octant:
// bit0 dx<0, bit1 dy<0, bit2 dz<0; the JAX kernels' block vote is a TPU
// workaround) and slab-tests every non-empty child in that order, against
// t_best (closest hit) or t_max (any hit): bit j of the mask is the child
// at position j of the order. A step then advances the lowest set bit: it
// clears it and reads that child; closest hit re-culls it against the
// current t_best, any hit does not. An inner child (kind <= -2) is
// descended into, pushing the parent with its remaining mask only if that
// mask is non-zero; a leaf child (kind >= 0) is the step's result. An
// empty mask pops, and an empty stack ends the walk; any hit ends at its
// first hit. The stack is a per-lane array of BVH8_STACK (node << 8 |
// mask) words in local memory; the wrapper refuses a tree whose depth + 2
// exceeds it, so the guard on the push never drops one. The order row is
// kept in one register as eight 4-bit slots (K6's any hit stacks it too,
// beside the word, and a pop loads nothing). The step cap is the JAX
// kernels' fuel (the wrapper's), one a step. Child rows: K6 [min.xyz,
// max.x | max.yz, kind, count] (bvh8_child, two float4s: slab() reads them
// as it reads a BVH2 node), K7 [min.xyz, max.x | max.yz, slot base, 0 |
// centroid.xyz, 0 | pad] (bvh8c_child, four float4s). K6 reads bvh_prim
// as K3 does; K7 reads cluster_feat as K1 does and returns slot ids.
//
// K6's any hit tests a leaf's prims in the thread that reached it, up to
// its first hit (bvh8_any_walk). K6's closest hit tests them with the
// whole warp, as K4's does (bvh8_closest_walk): each lane walks up to
// BVH8_ROUND_STEPS steps a round (a step: a fresh visit and a pop or an
// advance), stopping at a leaf child that survives its re-cull, and
// warp_leaf_visit tests the round's due (ray, prim) pairs, 32 a pass,
// each ray's in prim order under the serial rule (strict <, so the lowest
// prim keeps a tie): t, prim, u and v bit-equal to the twin's. In the
// thread-alone walk a warp made 24.5-61.1 prim passes where a lane needs
// 8.4-8.6 prim tests (the CPU twins, 4 096 lanes in presort order). K6's
// closest hit took 0.388 ms a launch thread-alone on the gallery's
// wavefronts and takes 0.370 so (bound 0.0134); 0.377 / 0.368 / 0.376 /
// 0.401 at 1 / 2 / 4 / 8 steps a round (chip_smoke.py, chip_tiles.py;
// H100 80GB HBM3, 700.00 W; PERF.md §6).
//
// K7 visits its clusters warp-cooperatively, as
// K1 does: each lane walks to its next leaf child (a due visit: the
// cluster at slot base `kind`, recentred at the child's centroid) or the
// end of its walk, then the whole warp serves the due visits (warp_visit,
// BVH8C_TILE_J slots a lane), and the lanes walk on while any lane of the
// warp is walking. A lane's visits keep its walk order and its t_best is
// updated before its next re-cull, and warp_visit keeps K1's tie rule
// (the lowest slot in a cluster, the first cluster visited across
// clusters), so t and slot are bit-equal to the twin's on every lane; the
// any hit is an OR over the same clusters up to the same cap, and occ is
// too. K7 took 3.150 ms a closest-hit and 1.306 an any-hit launch on the
// gallery's wavefronts with a per-thread visit, and takes 0.934 and 0.492
// so, against bounds of 0.031 and 0.029 (chip_smoke.py; H100 80GB HBM3,
// 700.00 W; PERF.md §6). Its warps load and test as K1's do on the same
// rays (as many groups a lane); what it takes over K1, ~0.14 ms a
// closest-hit launch, is its walk, whose lanes branch apart between fresh
// visits (8 child rows each), advances and pops.
// ---------------------------------------------------------------------------

constexpr int BVH8_STACK = 32;   // kernels/traverse.py::BVH8_STACK

// An order row's two int4 as eight 4-bit child slots, position j at bits 4j
__device__ __forceinline__ unsigned perm_slots(const int4& a, const int4& b) {
    return (unsigned)a.x | ((unsigned)a.y << 4) | ((unsigned)a.z << 8) |
           ((unsigned)a.w << 12) | ((unsigned)b.x << 16) |
           ((unsigned)b.y << 20) | ((unsigned)b.z << 24) |
           ((unsigned)b.w << 28);
}

// The order row `row` as eight 4-bit child slots
__device__ __forceinline__ unsigned load_perm(const int4* __restrict__ order,
                                              int row) {
    return perm_slots(__ldg(order + 2 * row), __ldg(order + 2 * row + 1));
}

// Where a lane's BVH8 walk stands: the node `cur` (-1 once the walk is
// over), whether it is still to be visited fresh, its remaining mask and
// order row, and the stack
struct Bvh8Cursor {
    int stack[BVH8_STACK];   // (node << 8) | the node's remaining mask
    int sp = 0, cur = 0, mask = 0;
    bool fresh = true;
    unsigned perm = 0;
};

// One step of a lane's BVH8 walk over cluster leaves (one iteration of
// the loop above), its slab tests against t_lim. Returns the row of the
// leaf child an advance reached (its second float4 in *leaf_b), else
// nullptr.
template <bool ANY_HIT>
__device__ __forceinline__ const float4* bvh8c_step(
        const float4* __restrict__ child, const int4* __restrict__ order,
        const RayState& r, float t_lim, Bvh8Cursor& w, float4* leaf_b) {
    constexpr int ROW = 4;    // float4s a child row
    if (w.fresh) {            // slab-test the 8 children in octant order
        w.perm = load_perm(order, w.cur * 8 + r.oct);
        w.mask = 0;
        for (int j = 0; j < 8; ++j) {
            const float4* c = child + ROW * (size_t)(w.cur * 8 +
                                                     ((w.perm >> (4 * j)) & 7));
            const float4 a = __ldg(c), b = __ldg(c + 1);
            if (slab(a, b, r, t_lim) && b.z != -1.0f) w.mask |= 1 << j;
        }
        w.fresh = false;
    }
    if (w.mask == 0) {        // the node is done: pop, or end the walk
        if (w.sp == 0) {
            w.cur = -1;
            return nullptr;
        }
        const int e = w.stack[--w.sp];
        w.cur = e >> 8;
        w.mask = e & 255;
        w.perm = load_perm(order, w.cur * 8 + r.oct);
        return nullptr;
    }
    const int j = __ffs(w.mask) - 1;        // advance the lowest set bit
    w.mask &= w.mask - 1;
    const float4* c =
        child + ROW * (size_t)(w.cur * 8 + ((w.perm >> (4 * j)) & 7));
    const float4 a = __ldg(c), b = __ldg(c + 1);
    // closest hit re-culls against the t_best improved since the visit
    if (!ANY_HIT && !slab(a, b, r, t_lim)) return nullptr;
    const int kind = (int)b.z;
    if (kind <= -2) {         // descend; keep the parent if children remain
        if (w.mask != 0 && w.sp < BVH8_STACK)
            w.stack[w.sp++] = (w.cur << 8) | w.mask;
        w.cur = -2 - kind;
        w.fresh = true;
        return nullptr;
    }
    *leaf_b = b;
    return c;
}

// The any-hit BVH8 walk of one ray over prim leaves (K6), in its own
// thread: outputs occ. bvh8c_step's state machine, kept inline: through
// bvh8c_step K6 ran 6% slower (chip_smoke.py, H100 80GB HBM3, 700.00 W;
// PERF.md §6). A step waits on at most one table load: a fresh visit
// loads the order row and the eight child rows in storage order
// together, slab-tests them and only then moves each child's result to
// its octant position (bit j of the mask: child perm_j, the very bit the
// perm-indexed loads gave). A pop loads nothing: the stack keeps the
// order row beside the node and its remaining mask. An advance loads its
// child's second float4 (holding the fresh visit's kinds and counts in
// registers or shared memory instead ran slower; PERF.md §6). The loop
// has one exit, its condition: the end of the walk, the fuel cap or the
// first hit. K6's any hit took 0.218 ms a launch on the gallery's shadow
// wavefronts with perm-indexed loads and an order-row load a pop, and
// takes 0.211 so (chip_smoke.py, H100 80GB HBM3, 700.00 W).
__device__ __forceinline__ void bvh8_any_walk(
        const float4* __restrict__ child, const int4* __restrict__ order,
        const float4* __restrict__ leaf, const RayState& r, float t_max,
        int fuel_cap, bool* occ_io) {
    constexpr int ROW = 2;   // float4s a child row
    int2 stack[BVH8_STACK];  // ((node << 8) | remaining mask, order row)
    int sp = 0, cur = 0, mask = 0, fuel = 0;
    unsigned perm = 0;
    bool fresh = true, occ = false, go = fuel_cap > 0;
    while (go) {
        if (fresh) {          // slab-test the 8 children in storage order
            const int4* o = order + 2 * (cur * 8 + r.oct);
            const int4 oa = __ldg(o), ob = __ldg(o + 1);
            const float4* c = child + ROW * (size_t)(cur * 8);
            unsigned hits = 0;                // bit k: child k
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                const float4 a = __ldg(c + ROW * k);
                const float4 b = __ldg(c + ROW * k + 1);
                if (slab(a, b, r, t_max) && b.z != -1.0f) hits |= 1u << k;
            }
            perm = perm_slots(oa, ob);
            mask = 0;         // in octant order: bit j is child perm_j's
#pragma unroll
            for (int j = 0; j < 8; ++j)
                mask |= (int)((hits >> ((perm >> (4 * j)) & 7)) & 1u) << j;
            fresh = false;
        }
        if (mask == 0) {      // the node is done: pop, or end the walk
            if (sp == 0) {
                cur = -1;
            } else {
                const int2 e = stack[--sp];
                cur = e.x >> 8;
                mask = e.x & 255;
                perm = (unsigned)e.y;
            }
        } else {              // advance the lowest set bit
            const int j = __ffs(mask) - 1;
            mask &= mask - 1;
            const float4 b = __ldg(child + ROW * (size_t)(
                cur * 8 + ((perm >> (4 * j)) & 7)) + 1);
            const int kind = (int)b.z;
            if (kind <= -2) { // descend; keep the parent if children remain
                if (mask != 0 && sp < BVH8_STACK)
                    stack[sp++] = make_int2((cur << 8) | mask, (int)perm);
                cur = -2 - kind;
                fresh = true;
            } else {          // a leaf at `kind`: stop at its first hit
                occ = leaf_visit<true>(leaf, kind, (int)b.w, r, t_max,
                                       nullptr, nullptr, nullptr, nullptr);
            }
        }
        ++fuel;
        go = cur >= 0 && !occ && fuel < fuel_cap;
    }
    *occ_io = occ;
}

// The closest-hit BVH8 walk of a lane's ray over prim leaves (K6),
// warp-synchronous in rounds as inst_bvh_closest_walk is: each walking lane
// takes up to BVH8_ROUND_STEPS steps of its own walk (bvh8_any_walk's
// state machine; an advance re-culls its child against t_best), stopping
// at the step that reaches a leaf child; then the warp tests the round's
// due leaves together (warp_leaf_visit), while any lane of the warp is
// walking. A lane that is not `live` takes part, its walk done. Each
// lane's steps, its t_best at each slab test and its fuel are the serial
// walk's.
__device__ __forceinline__ void bvh8_closest_walk(
        const float4* __restrict__ child, const int4* __restrict__ order,
        const float4* __restrict__ leaf, const RayState& r, bool live,
        float t_max, int fuel_cap, float* t_io, int* id_io, float* u_io,
        float* v_io) {
    constexpr int ROW = 2;   // float4s a child row
    float t_best = t_max, bu = 0.0f, bv = 0.0f;
    int best = -1;
    int stack[BVH8_STACK];   // (node << 8) | the node's remaining mask
    int sp = 0, cur = 0, mask = 0, fuel = 0;
    bool fresh = true;
    unsigned perm = 0;
    bool done = !live || fuel_cap <= 0;
    while (__any_sync(FULL_WARP, !done)) {
        int first = 0, count = 0;     // the lane's due leaf
        for (int s = 0; s < BVH8_ROUND_STEPS && !done && count == 0; ++s) {
            if (fresh) {      // slab-test the 8 children in octant order
                perm = load_perm(order, cur * 8 + r.oct);
                mask = 0;
                for (int j = 0; j < 8; ++j) {
                    const float4* c = child + ROW * (size_t)(
                        cur * 8 + ((perm >> (4 * j)) & 7));
                    const float4 a = __ldg(c), b = __ldg(c + 1);
                    if (slab(a, b, r, t_best) && b.z != -1.0f)
                        mask |= 1 << j;
                }
                fresh = false;
            }
            if (mask == 0) {  // the node is done: pop, or end the walk
                if (sp == 0) {
                    cur = -1;
                } else {
                    const int e = stack[--sp];
                    cur = e >> 8;
                    mask = e & 255;
                    perm = load_perm(order, cur * 8 + r.oct);
                }
            } else {          // advance the lowest set bit
                const int j = __ffs(mask) - 1;
                mask &= mask - 1;
                const float4* c =
                    child + ROW * (size_t)(cur * 8 + ((perm >> (4 * j)) & 7));
                const float4 a = __ldg(c), b = __ldg(c + 1);
                // re-cull against the t_best improved since the visit
                if (slab(a, b, r, t_best)) {
                    const int kind = (int)b.z;
                    if (kind <= -2) {   // descend; keep the parent if
                        if (mask != 0 && sp < BVH8_STACK)   // children remain
                            stack[sp++] = (cur << 8) | mask;
                        cur = -2 - kind;
                        fresh = true;
                    } else {            // a leaf at `kind`, up to LEAF_K
                        first = kind;
                        count = (int)b.w;
                    }
                }
            }
            ++fuel;
            done = cur < 0 || fuel >= fuel_cap;
        }
        warp_leaf_visit(leaf, first, count, r, &t_best, &best, &bu, &bv);
    }
    *t_io = best >= 0 ? t_best : inf_f();
    *id_io = best;
    *u_io = bu;
    *v_io = bv;
}

// The BVH8 walk of a lane's ray over cluster leaves (K7), warp-synchronous
// as cluster_walk is: the lane walks to its next leaf child or the end of
// its walk, the warp serves the due visits together, and so on while any
// lane is walking. A lane that is not `live` takes part, its walk done.
// Closest hit: *t_io and *slot_io. Any hit: t_best stays t_max, and a
// lane's walk ends at its first hit, which sets *occ_io. The step that
// reaches a leaf counts once against the fuel, its visit included.
template <bool ANY_HIT>
__device__ __forceinline__ void bvh8c_walk(
        const float4* __restrict__ child, const int4* __restrict__ order,
        const float4* __restrict__ feat, const RayState& r, bool live,
        float t_max, int fuel_cap, int ck, float* t_io, int* slot_io,
        bool* occ_io) {
    float t_best = t_max;
    int best = -1, fuel = 0;
    bool occ = false;
    Bvh8Cursor w;
    bool done = !live || fuel_cap <= 0;
    while (__any_sync(FULL_WARP, !done)) {
        int base = -1;
        float4 cen = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        while (!done && base < 0) {       // to the next due visit
            float4 b;
            const float4* c =
                bvh8c_step<ANY_HIT>(child, order, r, t_best, w, &b);
            ++fuel;
            if (c != nullptr) {
                base = (int)b.z;
                cen = __ldg(c + 2);
            } else {
                done = w.cur < 0 || fuel >= fuel_cap;
            }
        }
        if (warp_visit<ANY_HIT, BVH8C_TILE_J>(feat, cen, r, base, ck,
                                              &t_best, &best) &&
            ANY_HIT)
            occ = true;
        if (base >= 0) done = occ || fuel >= fuel_cap;   // the visit's step
    }
    if (ANY_HIT) {
        *occ_io = occ;
        return;
    }
    *t_io = best >= 0 ? t_best : inf_f();
    *slot_io = best;
}

__global__ void __launch_bounds__(BLOCK)
bvh8_closest_hit_kernel(const float4* __restrict__ child,
                        const int4* __restrict__ order,
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
    float tm;
    bool live;
    const RayState r = lane_ray(ox, oy, oz, dx, dy, dz, tmax, i, n, &tm,
                                &live);
    float t, u, v;
    int p;
    bvh8_closest_walk(child, order, prim, r, live, tm, fuel, &t, &p, &u, &v);
    if (i < n) {
        t_out[i] = t;
        prim_out[i] = p;
        u_out[i] = u;
        v_out[i] = v;
    }
}

__global__ void __launch_bounds__(BLOCK)
bvh8_any_hit_kernel(const float4* __restrict__ child,
                    const int4* __restrict__ order,
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
        bvh8_any_walk(child, order, prim, r, tm, fuel, &occ);
    }
    occ_out[i] = occ;
}

__global__ void __launch_bounds__(BLOCK)
bvh8mxu_closest_hit_kernel(const float4* __restrict__ child,
                           const int4* __restrict__ order,
                           const float4* __restrict__ feat,
                           const float* __restrict__ ox,
                           const float* __restrict__ oy,
                           const float* __restrict__ oz,
                           const float* __restrict__ dx,
                           const float* __restrict__ dy,
                           const float* __restrict__ dz,
                           const float* __restrict__ tmax,
                           float* __restrict__ t_out,
                           int* __restrict__ slot_out, int n, int fuel,
                           int ck) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    float tm;
    bool live;
    const RayState r = lane_ray(ox, oy, oz, dx, dy, dz, tmax, i, n, &tm,
                                &live);
    float t;
    int slot;
    bvh8c_walk<false>(child, order, feat, r, live, tm, fuel, ck, &t, &slot,
                      nullptr);
    if (i < n) {
        t_out[i] = t;
        slot_out[i] = slot;
    }
}

__global__ void __launch_bounds__(BLOCK)
bvh8mxu_any_hit_kernel(const float4* __restrict__ child,
                       const int4* __restrict__ order,
                       const float4* __restrict__ feat,
                       const float* __restrict__ ox,
                       const float* __restrict__ oy,
                       const float* __restrict__ oz,
                       const float* __restrict__ dx,
                       const float* __restrict__ dy,
                       const float* __restrict__ dz,
                       const float* __restrict__ tmax,
                       bool* __restrict__ occ_out, int n, int fuel, int ck) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    float tm;
    bool live;
    const RayState r = lane_ray(ox, oy, oz, dx, dy, dz, tmax, i, n, &tm,
                                &live);
    bool occ;
    bvh8c_walk<true>(child, order, feat, r, live, tm, fuel, ck, nullptr,
                     nullptr, &occ);
    if (i < n) occ_out[i] = occ;
}

// ---------------------------------------------------------------------------
// Dense cluster sweep (K8): the kernels of MI_MXU_DENSE on a flat triangle
// scene. No tree and no slab cull: every ray is tested against every
// cluster c = 0..C-1, its ray recentred at the cluster's centroid
// (mxu_ccs row c, [centroid.xyz, pad | pad]) and the cluster's slots
// below its count (mxu_ccount: 1 + its last real slot) tested with K1's
// slot test. Closest hit: t_best starts at t_max and a slot must be
// strictly nearer to replace it, so the lowest slot of a cluster and the
// first cluster in index order keep a tie; t = +inf and slot = -1 on a
// miss. Any hit: true iff some slot hits at 0 < t <= t_max (the JAX
// kernel exits once its whole block is occluded: the same result).
//
// WHAT BOUNDS IT on an H100. The work is every real slot of the scene for
// every live ray: 38 FP32 operations a slot (slot_planes), about 18.3 ms
// for 1M rays on the mesh gallery's 30 732 triangles at 67 TFLOP/s. The
// bytes are the rays, the results and the tables once (3.7 MB of plane
// rows on the gallery), negligible beside that. The first version, one
// ray a thread through cluster_visit, took 133.5 / 72.2 ms a closest /
// any-hit launch against bounds of 15.0 / 8.3 (PERF.md §6): each
// thread tested all CK slots of every cluster (a third of the gallery's
// slots are padding), and each slot test, ~55 instructions with
// --fmad=false, paid about as many again for its five row loads, their
// addresses and the loop, for one ray.
//
// DESIGN. Each thread sweeps DENSE_RAYS rays (thread t of block b owns
// rays b * BLOCK * DENSE_RAYS + j * BLOCK + t, so loads and stores stay
// coalesced), each with its own features, recentred per cluster as
// cluster_visit recentres them, and its own t_best and slot. For each
// slot below the cluster's count it loads the five float4 of plane rows
// once (every thread sweeps in the same order: one L1 broadcast a warp)
// and runs slot_planes, unchanged, for each of its rays not yet done, in
// ray order, so t and slot are bit-equal to the twin's. Rays past n and
// dead rays (t_max <= 0) start done; nothing relies on where they are.
// An any-hit ray is done at its first hit, and the thread leaves the
// sweep when all its rays are. No shared memory, warp intrinsics or
// tensor cores: the arithmetic is K1's.
//
// MEASURED (chip_tiles.py on the gallery's five wavefronts, H100 80GB
// HBM3, 700.00 W; PERF.md §6): at one ray a thread, skipping the padding
// alone gives 87.4 ms a closest-hit launch, ~3.3 ps a real slot test, as
// the first version spent on each slot; two rays a thread share each row
// load, 70.8 / 47.6 ms against bounds of 15.0 / 8.3; four are slower
// (fewer warps in flight, each ray's divide and test one after another).
// What is left, ~2.7 ps a real slot test at two rays a thread, is mostly
// the slot test's own arithmetic.
// ---------------------------------------------------------------------------

template <bool ANY_HIT>
__device__ __forceinline__ void dense_sweep(
        const float4* __restrict__ ccs, const int* __restrict__ count,
        const float4* __restrict__ feat, const float* __restrict__ ox,
        const float* __restrict__ oy, const float* __restrict__ oz,
        const float* __restrict__ dx, const float* __restrict__ dy,
        const float* __restrict__ dz, const float* __restrict__ tmax,
        float* __restrict__ t_out, int* __restrict__ slot_out,
        bool* __restrict__ occ_out, int n, int n_clusters, int ck) {
    const int first = blockIdx.x * (BLOCK * DENSE_RAYS) + threadIdx.x;
    float rox[DENSE_RAYS], roy[DENSE_RAYS], roz[DENSE_RAYS];
    float rdx[DENSE_RAYS], rdy[DENSE_RAYS], rdz[DENSE_RAYS];
    float t_best[DENSE_RAYS];   // the limit: t_max, and a closest hit's best
    int best[DENSE_RAYS];
    unsigned live = 0;          // bit j: ray j has t_max > 0
#pragma unroll
    for (int j = 0; j < DENSE_RAYS; ++j) {
        const int i = first + j * BLOCK;
        const float tm = i < n ? tmax[i] : 0.0f;
        // t_max <= 0 (dead lanes) cannot hit: 0 < t < t_max
        const bool on = tm > 0.0f;
        live |= on ? 1u << j : 0u;
        rox[j] = on ? ox[i] : 0.0f;
        roy[j] = on ? oy[i] : 0.0f;
        roz[j] = on ? oz[i] : 0.0f;
        rdx[j] = on ? dx[i] : 0.0f;
        rdy[j] = on ? dy[i] : 0.0f;
        rdz[j] = on ? dz[i] : 0.0f;
        t_best[j] = tm;
        best[j] = -1;
    }
    unsigned todo = live;       // bit j: ray j still sweeps
    for (int c = 0; c < n_clusters && todo != 0; ++c) {
        const float4 cen = __ldg(ccs + 2 * c);
        const int cnt = __ldg(count + c);
        const int base = c * ck;
        float px[DENSE_RAYS], py[DENSE_RAYS], pz[DENSE_RAYS];
        float mx[DENSE_RAYS], my[DENSE_RAYS], mz[DENSE_RAYS];
#pragma unroll
        for (int j = 0; j < DENSE_RAYS; ++j) {
            px[j] = rox[j] - cen.x;
            py[j] = roy[j] - cen.y;
            pz[j] = roz[j] - cen.z;
            mx[j] = py[j] * rdz[j] - pz[j] * rdy[j];
            my[j] = pz[j] * rdx[j] - px[j] * rdz[j];
            mz[j] = px[j] * rdy[j] - py[j] * rdx[j];
        }
        const float4* fs = feat + (size_t)base * FEAT_W4;
        for (int k = 0; k < cnt; ++k) {
            const float4* f = fs + k * FEAT_W4;
            const float4 f0 = __ldg(f), f1 = __ldg(f + 1), f2 = __ldg(f + 2),
                         f3 = __ldg(f + 3), f4 = __ldg(f + 4);
#pragma unroll
            for (int j = 0; j < DENSE_RAYS; ++j) {
                if (!(todo >> j & 1u)) continue;
                float t;
                const bool ok = slot_planes(f0, f1, f2, f3, f4, rdx[j],
                                            rdy[j], rdz[j], px[j], py[j],
                                            pz[j], mx[j], my[j], mz[j], &t);
                if (ANY_HIT) {
                    if (ok && t <= t_best[j]) todo &= ~(1u << j);
                } else if (ok && t < t_best[j]) {
                    t_best[j] = t;
                    best[j] = base + k;
                }
            }
            if (ANY_HIT && todo == 0) break;   // every ray occluded
        }
    }
#pragma unroll
    for (int j = 0; j < DENSE_RAYS; ++j) {
        const int i = first + j * BLOCK;
        if (i >= n) break;
        if (ANY_HIT) {
            occ_out[i] = (live & ~todo) >> j & 1u;
        } else {
            t_out[i] = best[j] >= 0 ? t_best[j] : inf_f();
            slot_out[i] = best[j];
        }
    }
}

__global__ void __launch_bounds__(BLOCK)
dense_closest_hit_kernel(const float4* __restrict__ ccs,
                         const int* __restrict__ count,
                         const float4* __restrict__ feat,
                         const float* __restrict__ ox,
                         const float* __restrict__ oy,
                         const float* __restrict__ oz,
                         const float* __restrict__ dx,
                         const float* __restrict__ dy,
                         const float* __restrict__ dz,
                         const float* __restrict__ tmax,
                         float* __restrict__ t_out,
                         int* __restrict__ slot_out, int n, int n_clusters,
                         int ck) {
    dense_sweep<false>(ccs, count, feat, ox, oy, oz, dx, dy, dz, tmax, t_out,
                       slot_out, nullptr, n, n_clusters, ck);
}

__global__ void __launch_bounds__(BLOCK)
dense_any_hit_kernel(const float4* __restrict__ ccs,
                     const int* __restrict__ count,
                     const float4* __restrict__ feat,
                     const float* __restrict__ ox,
                     const float* __restrict__ oy,
                     const float* __restrict__ oz,
                     const float* __restrict__ dx,
                     const float* __restrict__ dy,
                     const float* __restrict__ dz,
                     const float* __restrict__ tmax,
                     bool* __restrict__ occ_out, int n, int n_clusters,
                     int ck) {
    dense_sweep<true>(ccs, count, feat, ox, oy, oz, dx, dy, dz, tmax, nullptr,
                      nullptr, occ_out, n, n_clusters, ck);
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
int mts_bvh_closest_hit(const void* node, const void* link, const void* pair,
                        const void* prim, const void* ox, const void* oy,
                        const void* oz, const void* dx, const void* dy,
                        const void* dz, const void* tmax, void* t_out,
                        void* prim_out, void* u_out, void* v_out, int n,
                        int fuel, void* stream) {
    const int grid = (n + BLOCK - 1) / BLOCK;
    bvh_closest_hit_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        (const float4*)node, (const int*)link, (const float4*)pair,
        (const float4*)prim,
        (const float*)ox, (const float*)oy, (const float*)oz,
        (const float*)dx, (const float*)dy, (const float*)dz,
        (const float*)tmax, (float*)t_out, (int*)prim_out, (float*)u_out,
        (float*)v_out, n, fuel);
    return (int)cudaGetLastError();
}

int mts_bvh_any_hit(const void* node, const void* link, const void* pair,
                    const void* prim, const void* ox, const void* oy,
                    const void* oz, const void* dx, const void* dy,
                    const void* dz, const void* tmax, void* occ_out, int n,
                    int fuel, void* stream) {
    const int grid = (n + BLOCK - 1) / BLOCK;
    bvh_any_hit_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        (const float4*)node, (const int*)link, (const float4*)pair,
        (const float4*)prim,
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

int mts_inst_bvh_any_hit(const void* node, const void* link, const void* pair,
                         const void* prim, const void* inst_inv,
                         const void* inst_root, const void* ox,
                         const void* oy, const void* oz, const void* dx,
                         const void* dy, const void* dz, const void* tmax,
                         void* occ_out, int n, int fuel, void* stream) {
    const int grid = (n + BLOCK - 1) / BLOCK;
    inst_bvh_any_hit_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        (const float4*)node, (const int*)link, (const float4*)pair,
        (const float4*)prim,
        (const float4*)inst_inv, (const int*)inst_root, (const float*)ox,
        (const float*)oy, (const float*)oz, (const float*)dx,
        (const float*)dy, (const float*)dz, (const float*)tmax,
        (bool*)occ_out, n, fuel);
    return (int)cudaGetLastError();
}

// fuel: the walk's step cap, 10 * (BVH8 nodes) + prims + 64
int mts_bvh8_closest_hit(const void* child, const void* order,
                         const void* prim, const void* ox, const void* oy,
                         const void* oz, const void* dx, const void* dy,
                         const void* dz, const void* tmax, void* t_out,
                         void* prim_out, void* u_out, void* v_out, int n,
                         int fuel, void* stream) {
    const int grid = (n + BLOCK - 1) / BLOCK;
    bvh8_closest_hit_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        (const float4*)child, (const int4*)order, (const float4*)prim,
        (const float*)ox, (const float*)oy, (const float*)oz,
        (const float*)dx, (const float*)dy, (const float*)dz,
        (const float*)tmax, (float*)t_out, (int*)prim_out, (float*)u_out,
        (float*)v_out, n, fuel);
    return (int)cudaGetLastError();
}

int mts_bvh8_any_hit(const void* child, const void* order, const void* prim,
                     const void* ox, const void* oy, const void* oz,
                     const void* dx, const void* dy, const void* dz,
                     const void* tmax, void* occ_out, int n, int fuel,
                     void* stream) {
    const int grid = (n + BLOCK - 1) / BLOCK;
    bvh8_any_hit_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        (const float4*)child, (const int4*)order, (const float4*)prim,
        (const float*)ox, (const float*)oy, (const float*)oz,
        (const float*)dx, (const float*)dy, (const float*)dz,
        (const float*)tmax, (bool*)occ_out, n, fuel);
    return (int)cudaGetLastError();
}

// fuel: the walk's step cap, 10 * (BVH8 nodes) + 2 * clusters + 64
int mts_bvh8mxu_closest_hit(const void* child, const void* order,
                            const void* feat, const void* ox, const void* oy,
                            const void* oz, const void* dx, const void* dy,
                            const void* dz, const void* tmax, void* t_out,
                            void* slot_out, int n, int fuel, int ck,
                            void* stream) {
    const int grid = (n + BLOCK - 1) / BLOCK;
    bvh8mxu_closest_hit_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        (const float4*)child, (const int4*)order, (const float4*)feat,
        (const float*)ox, (const float*)oy, (const float*)oz,
        (const float*)dx, (const float*)dy, (const float*)dz,
        (const float*)tmax, (float*)t_out, (int*)slot_out, n, fuel, ck);
    return (int)cudaGetLastError();
}

int mts_bvh8mxu_any_hit(const void* child, const void* order,
                        const void* feat, const void* ox, const void* oy,
                        const void* oz, const void* dx, const void* dy,
                        const void* dz, const void* tmax, void* occ_out,
                        int n, int fuel, int ck, void* stream) {
    const int grid = (n + BLOCK - 1) / BLOCK;
    bvh8mxu_any_hit_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        (const float4*)child, (const int4*)order, (const float4*)feat,
        (const float*)ox, (const float*)oy, (const float*)oz,
        (const float*)dx, (const float*)dy, (const float*)dz,
        (const float*)tmax, (bool*)occ_out, n, fuel, ck);
    return (int)cudaGetLastError();
}

int mts_dense_closest_hit(const void* ccs, const void* count,
                          const void* feat, const void* ox, const void* oy,
                          const void* oz, const void* dx, const void* dy,
                          const void* dz, const void* tmax, void* t_out,
                          void* slot_out, int n, int n_clusters, int ck,
                          void* stream) {
    const int grid = (n + BLOCK * DENSE_RAYS - 1) / (BLOCK * DENSE_RAYS);
    dense_closest_hit_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        (const float4*)ccs, (const int*)count, (const float4*)feat,
        (const float*)ox, (const float*)oy, (const float*)oz,
        (const float*)dx, (const float*)dy, (const float*)dz,
        (const float*)tmax, (float*)t_out, (int*)slot_out, n, n_clusters,
        ck);
    return (int)cudaGetLastError();
}

int mts_dense_any_hit(const void* ccs, const void* count, const void* feat,
                      const void* ox, const void* oy, const void* oz,
                      const void* dx, const void* dy, const void* dz,
                      const void* tmax, void* occ_out, int n, int n_clusters,
                      int ck, void* stream) {
    const int grid = (n + BLOCK * DENSE_RAYS - 1) / (BLOCK * DENSE_RAYS);
    dense_any_hit_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        (const float4*)ccs, (const int*)count, (const float4*)feat,
        (const float*)ox, (const float*)oy, (const float*)oz,
        (const float*)dx, (const float*)dy, (const float*)dz,
        (const float*)tmax, (bool*)occ_out, n, n_clusters, ck);
    return (int)cudaGetLastError();
}

const char* mts_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
