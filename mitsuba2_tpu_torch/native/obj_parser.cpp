// Fast Wavefront OBJ parser (native component).
//
// TPU-rebuild counterpart of the reference's custom OBJ parser
// (src/shapes/obj.cpp): single pass over the file with pointer-walking
// float/int scanning (no iostream/regex), polygon-fan triangulation,
// negative (relative) indices, and split-vertex deduplication of
// (v, vt, vn) corner triples via a hash map — the same semantics as the
// Python parser in scene/mesh_io.py, ~100x faster on large meshes.
//
// Plain C ABI for ctypes (no pybind11 in this environment). The caller
// copies the returned buffers and releases them with mts_free.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <unordered_map>
#include <vector>

namespace {

struct Key {
    int32_t v, vt, vn;
    bool operator==(const Key& o) const {
        return v == o.v && vt == o.vt && vn == o.vn;
    }
};

struct KeyHash {
    size_t operator()(const Key& k) const {
        uint64_t h = (uint64_t)(uint32_t)k.v;
        h = h * 0x9E3779B97F4A7C15ull ^ (uint64_t)(uint32_t)k.vt;
        h = h * 0x9E3779B97F4A7C15ull ^ (uint64_t)(uint32_t)k.vn;
        h ^= h >> 29;
        return (size_t)h;
    }
};

inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p;
}

inline const char* next_line(const char* p, const char* end) {
    while (p < end && *p != '\n') ++p;
    return p < end ? p + 1 : end;
}

inline float parse_float(const char*& p) {
    char* q;
    float f = strtof(p, &q);
    p = q;
    return f;
}

inline long parse_int(const char*& p) {
    char* q;
    long i = strtol(p, &q, 10);
    p = q;
    return i;
}

}  // namespace

extern "C" {

void mts_free(void* p) { free(p); }

// Returns 0 on success; fills output pointers (malloc'd) + counts.
// has_n / has_uv are 1 iff EVERY face corner carried that attribute.
int64_t mts_parse_obj(const char* path, int flip_tex_v,
                      float** out_v, int64_t* n_v,
                      int32_t** out_f, int64_t* n_f,
                      float** out_n, int32_t* has_n,
                      float** out_uv, int32_t* has_uv) {
    FILE* fh = fopen(path, "rb");
    if (!fh) return -1;
    fseek(fh, 0, SEEK_END);
    long sz = ftell(fh);
    fseek(fh, 0, SEEK_SET);
    std::vector<char> buf((size_t)sz + 1);
    if (sz > 0 && fread(buf.data(), 1, (size_t)sz, fh) != (size_t)sz) {
        fclose(fh);
        return -2;
    }
    fclose(fh);
    buf[(size_t)sz] = '\0';

    std::vector<float> vs, vts, vns;        // raw attribute streams
    std::vector<Key> corners;               // triangulated corner triples
    vs.reserve(1 << 16);
    corners.reserve(1 << 16);

    const char* p = buf.data();
    const char* end = buf.data() + sz;
    bool all_n = true, all_uv = true;

    while (p < end) {
        p = skip_ws(p, end);
        if (p >= end) break;
        char c0 = p[0];
        char c1 = (p + 1 < end) ? p[1] : '\0';
        if (c0 == 'v' && (c1 == ' ' || c1 == '\t')) {
            p += 2;
            float x = parse_float(p), y = parse_float(p), z = parse_float(p);
            vs.push_back(x); vs.push_back(y); vs.push_back(z);
        } else if (c0 == 'v' && c1 == 't') {
            p += 2;
            float u = parse_float(p);
            const char* q = skip_ws(p, end);
            float v = (q < end && *q != '\n') ? parse_float(p) : 0.0f;
            vts.push_back(u); vts.push_back(v);
        } else if (c0 == 'v' && c1 == 'n') {
            p += 2;
            float x = parse_float(p), y = parse_float(p), z = parse_float(p);
            vns.push_back(x); vns.push_back(y); vns.push_back(z);
        } else if (c0 == 'f' && (c1 == ' ' || c1 == '\t')) {
            p += 1;
            Key poly[64];
            int n_corner = 0;
            while (n_corner < 64) {
                p = skip_ws(p, end);
                if (p >= end || *p == '\n' || *p == '#') break;
                long vi = parse_int(p);
                long vti = 0, vni = 0;
                if (p < end && *p == '/') {
                    ++p;
                    if (p < end && *p != '/') vti = parse_int(p);
                    if (p < end && *p == '/') { ++p; vni = parse_int(p); }
                }
                Key k;
                long NV = (long)vs.size() / 3;
                long NT = (long)vts.size() / 2;
                long NN = (long)vns.size() / 3;
                k.v = (int32_t)(vi > 0 ? vi - 1 : NV + vi);
                k.vt = vti ? (int32_t)(vti > 0 ? vti - 1 : NT + vti) : -1;
                k.vn = vni ? (int32_t)(vni > 0 ? vni - 1 : NN + vni) : -1;
                poly[n_corner++] = k;
            }
            for (int k = 1; k + 1 < n_corner; ++k) {  // fan triangulation
                corners.push_back(poly[0]);
                corners.push_back(poly[k]);
                corners.push_back(poly[k + 1]);
                for (int j : {0, k, k + 1}) {
                    if (poly[j].vn < 0) all_n = false;
                    if (poly[j].vt < 0) all_uv = false;
                }
            }
        }
        p = next_line(p, end);
    }

    // split-vertex dedup of (v, vt, vn) triples (obj.cpp behavior)
    std::unordered_map<Key, int32_t, KeyHash> dedup;
    dedup.reserve(corners.size());
    std::vector<float> V, N, UV;
    std::vector<int32_t> F;
    F.reserve(corners.size());
    bool want_n = all_n && !vns.empty();
    bool want_uv = all_uv && !vts.empty();
    for (const Key& k : corners) {
        auto it = dedup.find(k);
        int32_t id;
        if (it == dedup.end()) {
            id = (int32_t)dedup.size();
            dedup.emplace(k, id);
            V.push_back(vs[(size_t)k.v * 3 + 0]);
            V.push_back(vs[(size_t)k.v * 3 + 1]);
            V.push_back(vs[(size_t)k.v * 3 + 2]);
            if (want_n) {
                float nx = vns[(size_t)k.vn * 3 + 0];
                float ny = vns[(size_t)k.vn * 3 + 1];
                float nz = vns[(size_t)k.vn * 3 + 2];
                float len = std::sqrt(nx * nx + ny * ny + nz * nz);
                float inv = len > 1e-20f ? 1.0f / len : 0.0f;
                N.push_back(nx * inv); N.push_back(ny * inv);
                N.push_back(nz * inv);
            }
            if (want_uv) {
                UV.push_back(vts[(size_t)k.vt * 2 + 0]);
                float v = vts[(size_t)k.vt * 2 + 1];
                UV.push_back(flip_tex_v ? 1.0f - v : v);
            }
        } else {
            id = it->second;
        }
        F.push_back(id);
    }

    auto copy_out = [](const auto& vec, auto** out) {
        using T = typename std::remove_reference_t<decltype(vec)>::value_type;
        *out = (T*)malloc(vec.size() * sizeof(T) + 1);
        memcpy(*out, vec.data(), vec.size() * sizeof(T));
    };
    copy_out(V, out_v);
    *n_v = (int64_t)V.size() / 3;
    copy_out(F, out_f);
    *n_f = (int64_t)F.size() / 3;
    *has_n = want_n ? 1 : 0;
    *has_uv = want_uv ? 1 : 0;
    if (want_n) copy_out(N, out_n); else *out_n = nullptr;
    if (want_uv) copy_out(UV, out_uv); else *out_uv = nullptr;
    return 0;
}

}  // extern "C"
