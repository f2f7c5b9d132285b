// Probes for Hopper (sm_90a): three small kernels that time the parts of
// the traversal kernels (cluster_walk.cu) one at a time, so that a kernel's
// time can be modelled as its walk steps times a step's cost plus its
// cluster visits times a visit's cost. Each computes a deterministic
// function of its inputs, held bit for bit against its plain PyTorch twin
// (kernels/probes.py; built with --fmad=false like the walks).
//
// REPLACES the three TPU probes of the JAX package's benchmarks:
//   walk_step_kernel     <- benchmarks/probe_walk_latency.py:499 (`kern`,
//                           modes any1 / noany / ...: the cost of a walk
//                           iteration and of its vector->scalar vote)
//   row_load_kernel      <- benchmarks/probe_mxu_dma.py:98 (`kern_t` /
//                           `kern_pad`: the HBM->VMEM DMA of a cluster's
//                           plane rows)
//   cluster_visit_kernel <- benchmarks/probe_mxu_cost.py:159 (`kern`, modes
//                           step / dma / dot / full / opt and their *1
//                           forms: the cost of a cluster visit)
// Their TPU questions (the block vote's round trip, lane-aligned DMA
// slices, bf16-split MXU passes) have no meaning on this card; each probe
// asks the same question of the port's own kernels instead.
//
// walk_step_kernel (P1). Each thread walks n_steps over node rows
// [min.xyz, max.x | max.yz, pad, pad] (the BVH2 walk's layout) and links
// (R, 16) from its own start node: at each step it slab-tests the current
// row against its own ray (t_best = 1e30) and counts the hits. DEP: the
// next node is link col 0 on a hit, col 8 on a miss: one dependent row
// load a step, as the port's walks do. !DEP: the next node comes from the
// step counter alone, the rows still loaded and tested: the loads no
// longer wait on each other (the H100 form of the TPU probe's `noany`).
// Outputs per lane: the final node and the hit count. BOUND: 12 FP32
// operations a slab test.
//
// row_load_kernel (P2). out[lane] = sum over i < n_steps of the min over
// k < 128 of dot(feat[(i*128 mod S) + k], rt[:, lane]), feat (S, 16), rt
// (16, N): the TPU probe's function. !SMEM: each thread reads the rows
// itself, at warp-uniform addresses (one broadcast a float4), as the
// cluster walks read plane rows. SMEM: the block first stages the step's
// 128 rows (8 KB) in shared memory, then its threads read them there.
// BOUND: 32 FP32 operations a row (16 products, 15 sums, the min).
//
// cluster_visit_kernel (P3). P1's DEP walk, plus a visit of one cluster of
// CK slot-major 20-float plane rows through cluster_visit (the cluster
// walks' first, per-thread visit, below) with a fixed centroid: cluster
// (step mod C). EVERY = 0: no visit (the walk alone); 4: every 4th step
// where the slab hits (the threads of a warp then visit apart); 1: every
// step (all threads together).
// Outputs per lane: t_best (1e30 where nothing was hit) and the slot.
// BOUND: 12 FP32 operations a step, 38 a slot test.
//
// The probes' rays follow the TPU probes' recipe: o = s * 0.001 + (0, 1, 2),
// d = o.x + (0.1, 0.2, 0.3), with s per lane; s and the start node are
// inputs (kernels/probes.py::lanes: one ray and node for all lanes, or
// scrambled ones, so that the threads of a warp walk apart).
//
// C ABI (loaded with ctypes by kernels/probes.py); each entry point launches
// on the given stream, allocates nothing, and returns cudaGetLastError().

#include "walk.cuh"

namespace {

constexpr int BLOCK = 128;
constexpr int ROWS = 128;        // P2: rows a step (the TPU probe's K4)
constexpr float FAR = 1e30f;     // the TPU probes' t_best

// One slot's plane test, its five float4 of plane rows read from f
__device__ __forceinline__ bool slot_test(const float4* __restrict__ f,
                                          const RayState& r, float px,
                                          float py, float pz, float mx,
                                          float my, float mz, float* t_out) {
    return slot_planes(__ldg(f), __ldg(f + 1), __ldg(f + 2), __ldg(f + 3),
                       __ldg(f + 4), r.dx, r.dy, r.dz, px, py, pz, mx, my,
                       mz, t_out);
}

// One thread's closest-hit visit of one cluster (the probes' P3): the CK
// slots from fs, the ray recentred at the cluster centroid c. A slot
// strictly nearer than *t_best replaces *t_best and *best (slot base + k,
// so the lowest slot keeps a tie); returns whether one did.
__device__ __forceinline__ bool cluster_visit(const float4* __restrict__ fs,
                                              const float4& c,
                                              const RayState& r, int base,
                                              int ck, float* t_best,
                                              int* best) {
    const float px = r.ox - c.x, py = r.oy - c.y, pz = r.oz - c.z;
    const float mx = py * r.dz - pz * r.dy;
    const float my = pz * r.dx - px * r.dz;
    const float mz = px * r.dy - py * r.dx;
    bool closer = false;
    for (int k = 0; k < ck; ++k) {
        float t;
        const bool ok = slot_test(fs + k * FEAT_W4, r, px, py, pz, mx, my,
                                  mz, &t);
        if (ok && t < *t_best) {
            *t_best = t;
            *best = base + k;
            closer = true;
        }
    }
    return closer;
}

__device__ __forceinline__ RayState probe_ray(float s) {
    const float ox = s * 0.001f;
    return make_ray(ox, ox + 1.0f, ox + 2.0f, ox + 0.1f, ox + 0.2f,
                    ox + 0.3f);
}

// the !DEP walk's node at step k
__device__ __forceinline__ int indep_node(int k, int n_rows) {
    return (int)(((long long)k * 7919 + 1) % n_rows);
}

template <bool DEP>
__global__ void __launch_bounds__(BLOCK)
walk_step_kernel(const float4* __restrict__ node,
                 const int* __restrict__ link, const float* __restrict__ s,
                 const int* __restrict__ start, int* __restrict__ node_out,
                 int* __restrict__ hits_out, int n, int n_rows, int n_steps) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const RayState r = probe_ray(s[i]);
    int nd = start[i], hits = 0;
    for (int k = 0; k < n_steps; ++k) {
        const float4 a = __ldg(node + 2 * nd), b = __ldg(node + 2 * nd + 1);
        const bool hit = slab(a, b, r, FAR);
        hits += hit ? 1 : 0;
        nd = DEP ? __ldg(link + 16 * nd + (hit ? 0 : 8))
                 : indep_node(k + 1, n_rows);
    }
    node_out[i] = nd;
    hits_out[i] = hits;
}

template <bool SMEM>
__global__ void __launch_bounds__(BLOCK)
row_load_kernel(const float4* __restrict__ feat, const float* __restrict__ rt,
                float* __restrict__ out, int n, int n_rows, int n_steps) {
    __shared__ float4 rows[ROWS * 4];
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = i < n;   // every thread stages rows and syncs
    float r[16];
    for (int j = 0; j < 16; ++j) r[j] = live ? rt[(size_t)j * n + i] : 0.0f;
    float acc = 0.0f;
    for (int st = 0; st < n_steps; ++st) {
        const float4* src = feat + 4 * (size_t)((st * ROWS) % n_rows);
        if (SMEM) {
            __syncthreads();   // the last step's rows are read
            for (int q = threadIdx.x; q < ROWS * 4; q += blockDim.x)
                rows[q] = __ldg(src + q);
            __syncthreads();
        }
        float m = inf_f();
        for (int k = 0; k < ROWS; ++k) {
            float4 f[4];
            for (int q = 0; q < 4; ++q)
                f[q] = SMEM ? rows[4 * k + q] : __ldg(src + 4 * k + q);
            float d = f[0].x * r[0];
            d = d + f[0].y * r[1];
            d = d + f[0].z * r[2];
            d = d + f[0].w * r[3];
            d = d + f[1].x * r[4];
            d = d + f[1].y * r[5];
            d = d + f[1].z * r[6];
            d = d + f[1].w * r[7];
            d = d + f[2].x * r[8];
            d = d + f[2].y * r[9];
            d = d + f[2].z * r[10];
            d = d + f[2].w * r[11];
            d = d + f[3].x * r[12];
            d = d + f[3].y * r[13];
            d = d + f[3].z * r[14];
            d = d + f[3].w * r[15];
            m = fminf(m, d);
        }
        acc = acc + m;
    }
    if (live) out[i] = acc;
}

template <int EVERY>
__global__ void __launch_bounds__(BLOCK)
cluster_visit_kernel(const float4* __restrict__ node,
                     const int* __restrict__ link,
                     const float4* __restrict__ feat,
                     const float4* __restrict__ centroid,
                     const float* __restrict__ s,
                     const int* __restrict__ start, float* __restrict__ t_out,
                     int* __restrict__ best_out, int n, int n_steps,
                     int n_clusters, int ck) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const RayState r = probe_ray(s[i]);
    const float4 c = __ldg(centroid);
    float t_best = FAR;
    int best = -1, nd = start[i];
    for (int k = 0; k < n_steps; ++k) {
        const float4 a = __ldg(node + 2 * nd), b = __ldg(node + 2 * nd + 1);
        const bool hit = slab(a, b, r, FAR);
        const int next = __ldg(link + 16 * nd + (hit ? 0 : 8));
        if (EVERY == 1 || (EVERY == 4 && k % 4 == 0 && hit)) {
            const int base = (k % n_clusters) * ck;
            cluster_visit(feat + (size_t)base * FEAT_W4, c, r, base, ck,
                          &t_best, &best);
        }
        nd = next;
    }
    t_out[i] = t_best;
    best_out[i] = best;
}

}  // namespace

extern "C" {

int mts_probe_walk_step(const void* node, const void* link, const void* s,
                        const void* start, void* node_out, void* hits_out,
                        int n, int n_rows, int n_steps, int dep,
                        void* stream) {
    const int grid = (n + BLOCK - 1) / BLOCK;
    if (dep)
        walk_step_kernel<true><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
            (const float4*)node, (const int*)link, (const float*)s,
            (const int*)start, (int*)node_out, (int*)hits_out, n, n_rows,
            n_steps);
    else
        walk_step_kernel<false><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
            (const float4*)node, (const int*)link, (const float*)s,
            (const int*)start, (int*)node_out, (int*)hits_out, n, n_rows,
            n_steps);
    return (int)cudaGetLastError();
}

int mts_probe_row_load(const void* feat, const void* rt, void* out, int n,
                       int n_rows, int n_steps, int smem, void* stream) {
    const int grid = (n + BLOCK - 1) / BLOCK;
    if (smem)
        row_load_kernel<true><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
            (const float4*)feat, (const float*)rt, (float*)out, n, n_rows,
            n_steps);
    else
        row_load_kernel<false><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
            (const float4*)feat, (const float*)rt, (float*)out, n, n_rows,
            n_steps);
    return (int)cudaGetLastError();
}

// every: 0 (the walk alone), 4 or 1 (see cluster_visit_kernel)
int mts_probe_cluster_visit(const void* node, const void* link,
                            const void* feat, const void* centroid,
                            const void* s, const void* start, void* t_out,
                            void* best_out, int n, int n_steps,
                            int n_clusters, int ck, int every, void* stream) {
    const int grid = (n + BLOCK - 1) / BLOCK;
    const float4* nd = (const float4*)node;
    const int* lk = (const int*)link;
    const float4* ft = (const float4*)feat;
    const float4* cc = (const float4*)centroid;
    const float* sv = (const float*)s;
    const int* st = (const int*)start;
    if (every == 1)
        cluster_visit_kernel<1><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
            nd, lk, ft, cc, sv, st, (float*)t_out, (int*)best_out, n,
            n_steps, n_clusters, ck);
    else if (every == 4)
        cluster_visit_kernel<4><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
            nd, lk, ft, cc, sv, st, (float*)t_out, (int*)best_out, n,
            n_steps, n_clusters, ck);
    else
        cluster_visit_kernel<0><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
            nd, lk, ft, cc, sv, st, (float*)t_out, (int*)best_out, n,
            n_steps, n_clusters, ck);
    return (int)cudaGetLastError();
}

const char* mts_probe_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
