// Device helpers shared by the traversal kernels (cluster_walk.cu) and
// the probes (probes.cu): the ray record, the slab test of a box row and
// the plane test of one cluster slot.
// Each including file gets its own internal copy.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FEAT_W4 = 5;       // float4s per slot in cluster_feat (20 floats)

__device__ __forceinline__ float inf_f() {
    return __int_as_float(0x7f800000);
}

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

// One slot's plane test on its rows f0..f4 (loaded by the caller), the
// ray recentred at the cluster centroid: direction d, p = o - c and
// m = p x d; returns false where the slot cannot hit.
// Slot layout: [det0..2 u0 | u1..u4 | u5 v0..v2 | v3..v5 t0 | t1..t3 pad]
__device__ __forceinline__ bool slot_planes(const float4& f0,
                                            const float4& f1,
                                            const float4& f2,
                                            const float4& f3,
                                            const float4& f4, float dx,
                                            float dy, float dz, float px,
                                            float py, float pz, float mx,
                                            float my, float mz,
                                            float* t_out) {
    float det = f0.x * dx + f0.y * dy + f0.z * dz;
    float unum = f0.w * dx + f1.x * dy + f1.y * dz +
                 f1.z * mx + f1.w * my + f2.x * mz;
    float vnum = f2.y * dx + f2.z * dy + f2.w * dz +
                 f3.x * mx + f3.y * my + f3.z * mz;
    float tnum = f3.w * px + f4.x * py + f4.y * pz + f4.z;
    float inv = fabsf(det) < 1e-12f ? 0.0f : 1.0f / det;
    float u = unum * inv, v = vnum * inv, t = tnum * inv;
    *t_out = t;
    return (inv != 0.0f) && (u >= 0.0f) && (v >= 0.0f) &&
           (u + v <= 1.0f) && (t > 0.0f);
}

}  // namespace
