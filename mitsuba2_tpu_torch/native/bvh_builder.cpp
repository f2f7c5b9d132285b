// Native binned-SAH BVH builder.
//
// C++ counterpart of scene/bvh.py (the numpy reference implementation),
// mirroring mitsuba2's native accel-build layer (the reference builds its
// ShapeKDTree with a C++ SAH min-max binning builder in
// include/mitsuba/render/kdtree.h; here the structure is a BVH2 flattened
// in DFS order with miss links — see scene/bvh.py's module docstring for
// the traversal contract).
//
// The algorithm intentionally matches the Python builder decision-for-
// decision (same bins, same SAH sweep, same stable partitioning, same
// median fallbacks) so both produce IDENTICAL arrays — the Python builder
// doubles as the oracle in tests/test_native_bvh.py.
//
// Exported C ABI (ctypes, mitsuba2_tpu_torch/native/__init__.py):
//   int64_t mts_build_bvh(bb_min, bb_max, P,
//                         node_min, node_max, leaf_start, leaf_count,
//                         miss, prim_order)
//   -> node count (caller allocates 2P worst-case node storage)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <numeric>
#include <vector>

namespace {

constexpr int LEAF_K = 4;
constexpr int N_BINS = 16;
constexpr double INF = std::numeric_limits<double>::infinity();

struct V3 {
    double x, y, z;
    V3() : x(INF), y(INF), z(INF) {}
    V3(double a, double b, double c) : x(a), y(b), z(c) {}
};

inline V3 vmin(const V3 &a, const V3 &b) {
    return V3(std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z));
}
inline V3 vmax(const V3 &a, const V3 &b) {
    return V3(std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z));
}
inline double half_area(const V3 &mn, const V3 &mx) {
    double dx = std::max(mx.x - mn.x, 0.0);
    double dy = std::max(mx.y - mn.y, 0.0);
    double dz = std::max(mx.z - mn.z, 0.0);
    return dx * dy + dy * dz + dz * dx;
}

struct Node {
    V3 bb_min, bb_max;
    int64_t left = -1, right = -1;   // temp indices
    int64_t start = -1, count = 0;   // into prim_order (leaves)
};

struct Builder {
    const float *pmin, *pmax;
    std::vector<V3> cent;
    std::vector<Node> nodes;
    std::vector<int64_t> prim_order;

    V3 getmin(int64_t i) const {
        return V3(pmin[3 * i], pmin[3 * i + 1], pmin[3 * i + 2]);
    }
    V3 getmax(int64_t i) const {
        return V3(pmax[3 * i], pmax[3 * i + 1], pmax[3 * i + 2]);
    }
    static double axis_of(const V3 &v, int a) {
        return a == 0 ? v.x : (a == 1 ? v.y : v.z);
    }

    int64_t make_leaf(std::vector<int64_t> &idxs, const V3 &mn, const V3 &mx) {
        Node n;
        n.bb_min = mn;
        n.bb_max = mx;
        n.start = (int64_t)prim_order.size();
        n.count = (int64_t)idxs.size();
        prim_order.insert(prim_order.end(), idxs.begin(), idxs.end());
        nodes.push_back(n);
        return (int64_t)nodes.size() - 1;
    }

    int64_t build(std::vector<int64_t> idxs) {
        V3 mn, mx;
        V3 cmn, cmx(-INF, -INF, -INF);
        cmn = V3();
        mx = V3(-INF, -INF, -INF);
        for (int64_t i : idxs) {
            mn = vmin(mn, getmin(i));
            mx = vmax(mx, getmax(i));
            cmn = vmin(cmn, cent[i]);
            cmx = vmax(cmx, cent[i]);
        }

        bool leaf = (int64_t)idxs.size() <= LEAF_K;
        int axis = 0;
        bool median_fallback = false;
        std::vector<char> go_left;

        if (!leaf) {
            V3 ext(cmx.x - cmn.x, cmx.y - cmn.y, cmx.z - cmn.z);
            axis = 0;  // widest axis: the median-fallback axis
            if (ext.y > axis_of(ext, axis)) axis = 1;
            if (ext.z > axis_of(ext, axis)) axis = 2;
            if (axis_of(ext, axis) <= 1e-12) {
                median_fallback = true;  // all centroids coincide -> forced
            } else {
                // bin + sweep ALL THREE axes (matches bvh.py::sah_split);
                // the global minimum-cost (axis, bin) wins
                double best_cost = INF;
                std::vector<char> best_mask;
                for (int a = 0; a < 3; a++) {
                    double e = axis_of(ext, a);
                    if (e <= 1e-12) continue;
                    double lo = axis_of(cmn, a);
                    double scale = N_BINS * (1.0 - 1e-6) / std::max(e, 1e-30);
                    std::vector<int> bin_of(idxs.size());
                    int64_t counts[N_BINS] = {0};
                    V3 bmin[N_BINS], bmax[N_BINS];
                    for (int b = 0; b < N_BINS; b++)
                        bmax[b] = V3(-INF, -INF, -INF);
                    for (size_t k = 0; k < idxs.size(); k++) {
                        int b = (int)((axis_of(cent[idxs[k]], a) - lo) * scale);
                        b = std::min(b, N_BINS - 1);
                        bin_of[k] = b;
                        counts[b]++;
                        bmin[b] = vmin(bmin[b], getmin(idxs[k]));
                        bmax[b] = vmax(bmax[b], getmax(idxs[k]));
                    }
                    // prefix/suffix sweeps
                    V3 lmin[N_BINS], lmax[N_BINS], rmin[N_BINS], rmax[N_BINS];
                    int64_t lcnt[N_BINS], rcnt[N_BINS];
                    V3 acc_min, acc_max(-INF, -INF, -INF);
                    int64_t acc = 0;
                    for (int b = 0; b < N_BINS; b++) {
                        acc_min = vmin(acc_min, bmin[b]);
                        acc_max = vmax(acc_max, bmax[b]);
                        acc += counts[b];
                        lmin[b] = acc_min; lmax[b] = acc_max; lcnt[b] = acc;
                    }
                    acc_min = V3(); acc_max = V3(-INF, -INF, -INF); acc = 0;
                    for (int b = N_BINS - 1; b >= 0; b--) {
                        acc_min = vmin(acc_min, bmin[b]);
                        acc_max = vmax(acc_max, bmax[b]);
                        acc += counts[b];
                        rmin[b] = acc_min; rmax[b] = acc_max; rcnt[b] = acc;
                    }
                    double a_cost = INF;
                    int a_best = -1;
                    for (int s = 0; s < N_BINS - 1; s++) {
                        if (lcnt[s] == 0 || rcnt[s + 1] == 0) continue;
                        double c =
                            half_area(lmin[s], lmax[s]) * (double)lcnt[s] +
                            half_area(rmin[s + 1], rmax[s + 1]) *
                                (double)rcnt[s + 1];
                        if (c < a_cost) { a_cost = c; a_best = s; }
                    }
                    if (a_best < 0 || a_cost >= best_cost) continue;
                    std::vector<char> mask(idxs.size());
                    size_t nl = 0;
                    for (size_t k = 0; k < idxs.size(); k++) {
                        mask[k] = bin_of[k] <= a_best;
                        nl += mask[k];
                    }
                    if (nl == 0 || nl == idxs.size()) continue;
                    best_cost = a_cost;
                    best_mask.swap(mask);
                }
                if (best_mask.empty())
                    median_fallback = true;
                else
                    go_left.swap(best_mask);
            }
            if (median_fallback) {
                // stable median split on the widest axis (Python fallback)
                std::vector<int64_t> ord(idxs.size());
                std::iota(ord.begin(), ord.end(), 0);
                std::stable_sort(ord.begin(), ord.end(),
                                 [&](int64_t a, int64_t b) {
                                     return axis_of(cent[idxs[a]], axis) <
                                            axis_of(cent[idxs[b]], axis);
                                 });
                go_left.assign(idxs.size(), 0);
                for (size_t k = 0; k < idxs.size() / 2; k++)
                    go_left[ord[k]] = 1;
            }
        }

        if (leaf)
            return make_leaf(idxs, mn, mx);

        int64_t me = (int64_t)nodes.size();
        Node inner;
        inner.bb_min = mn;
        inner.bb_max = mx;
        nodes.push_back(inner);

        std::vector<int64_t> li, ri;
        li.reserve(idxs.size());
        ri.reserve(idxs.size());
        for (size_t k = 0; k < idxs.size(); k++)
            (go_left[k] ? li : ri).push_back(idxs[k]);
        idxs.clear();
        idxs.shrink_to_fit();

        int64_t l = build(std::move(li));
        int64_t r = build(std::move(ri));
        nodes[me].left = l;
        nodes[me].right = r;
        return me;
    }
};

}  // namespace

extern "C" int64_t mts_build_bvh(const float *bb_min, const float *bb_max,
                                 int64_t P, float *node_min, float *node_max,
                                 int32_t *leaf_start, int32_t *leaf_count,
                                 int32_t *miss, int32_t *prim_order) {
    Builder B;
    B.pmin = bb_min;
    B.pmax = bb_max;
    B.cent.resize(P);
    for (int64_t i = 0; i < P; i++)
        B.cent[i] = V3(0.5 * (bb_min[3 * i] + bb_max[3 * i]),
                       0.5 * (bb_min[3 * i + 1] + bb_max[3 * i + 1]),
                       0.5 * (bb_min[3 * i + 2] + bb_max[3 * i + 2]));
    B.nodes.reserve(2 * (size_t)P);
    B.prim_order.reserve(P);

    std::vector<int64_t> all(P);
    std::iota(all.begin(), all.end(), 0);
    int64_t root = B.build(std::move(all));
    (void)root;

    // DFS flatten with miss links (iterative; matches bvh.py's dfs2)
    int64_t n = (int64_t)B.nodes.size();
    std::vector<int64_t> subtree(n, 0), pos_of(n, -1), dfs_order;
    dfs_order.reserve(n);
    {
        // iterative post-computation of DFS positions + subtree sizes
        struct Frame { int64_t node; int state; };
        std::vector<Frame> stack;
        stack.push_back({0, 0});
        while (!stack.empty()) {
            Frame &f = stack.back();
            Node &nd = B.nodes[f.node];
            if (f.state == 0) {
                pos_of[f.node] = (int64_t)dfs_order.size();
                dfs_order.push_back(f.node);
                f.state = 1;
                if (nd.left >= 0) stack.push_back({nd.left, 0});
            } else if (f.state == 1) {
                f.state = 2;
                if (nd.right >= 0) stack.push_back({nd.right, 0});
            } else {
                int64_t my_pos = pos_of[f.node];
                int64_t end = (nd.left >= 0)
                                  ? pos_of[nd.right] + subtree[pos_of[nd.right]]
                                  : my_pos + 1;
                subtree[my_pos] = end - my_pos;
                stack.pop_back();
            }
        }
    }

    for (int64_t p = 0; p < n; p++) {
        const Node &nd = B.nodes[dfs_order[p]];
        node_min[3 * p] = (float)nd.bb_min.x;
        node_min[3 * p + 1] = (float)nd.bb_min.y;
        node_min[3 * p + 2] = (float)nd.bb_min.z;
        node_max[3 * p] = (float)nd.bb_max.x;
        node_max[3 * p + 1] = (float)nd.bb_max.y;
        node_max[3 * p + 2] = (float)nd.bb_max.z;
        leaf_start[p] = nd.left >= 0 ? -1 : (int32_t)nd.start;
        leaf_count[p] = nd.left >= 0 ? 0 : (int32_t)nd.count;
        int64_t nxt = p + subtree[p];
        miss[p] = nxt < n ? (int32_t)nxt : -1;
    }
    for (int64_t i = 0; i < (int64_t)B.prim_order.size(); i++)
        prim_order[i] = (int32_t)B.prim_order[i];
    return n;
}
