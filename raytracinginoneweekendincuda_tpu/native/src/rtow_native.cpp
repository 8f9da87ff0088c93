// Native runtime helpers for the path tracer.
//
// The reference's native layer is CUDA device code plus host C++ (PPM
// serialization in main(), kernel.cu:696-724; BVH construction on device,
// BvhNode.h:50-90).  This build keeps the compute path in XLA/Pallas and
// implements the host-runtime pieces here:
//
//   rtow_write_ppm  — P3 serialization of a uint8 framebuffer (the CUDA
//                     main() writes ints with bottom-up rows; callers here
//                     pass top-down rows, matching ops/render.py output).
//   rtow_build_bvh  — longest-axis median-split BVH build producing the
//                     *threaded* flattened layout of scene/bvh.py
//                     (DFS preorder + escape links; bit-identical to the
//                     Python builder, cross-checked in tests/test_native.py).
//
// Build: python -m raytracinginoneweekendincuda_tpu.native.build
// (g++ -O2 -shared -fPIC; no external dependencies).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <numeric>
#include <string>
#include <vector>

extern "C" {

int rtow_write_ppm(const char* path, const uint8_t* rgb, int w, int h) {
    std::FILE* f = std::fopen(path, "w");
    if (!f) return 1;
    std::fprintf(f, "P3\n%d %d\n255\n", w, h);
    char line[16];
    std::string buf;
    buf.reserve((size_t)w * h * 12);
    for (long i = 0; i < (long)w * h; ++i) {
        const uint8_t* p = rgb + 3 * i;
        int n = std::snprintf(line, sizeof line, "%d %d %d\n", p[0], p[1], p[2]);
        buf.append(line, n);
    }
    size_t written = std::fwrite(buf.data(), 1, buf.size(), f);
    int rc = (written == buf.size()) ? 0 : 2;
    if (std::fclose(f) != 0) rc = 3;
    return rc;
}

namespace {

struct Builder {
    const double* bmin;   // [n,3]
    const double* bmax;   // [n,3]
    const int32_t* prim_ids;
    std::vector<double> nmin, nmax;   // [m,3]
    std::vector<int32_t> prim, escape;

    int emit(const double lo[3], const double hi[3], int32_t p) {
        nmin.insert(nmin.end(), lo, lo + 3);
        nmax.insert(nmax.end(), hi, hi + 3);
        prim.push_back(p);
        escape.push_back(-1);
        return (int)prim.size() - 1;
    }

    // Longest-axis median split (BvhNode.h:50-90); stable sort by bbox min
    // along the split axis matches the reference's insertion sort
    // (BvhNode.h:170-193) and numpy's kind="stable" in scene/bvh.py.
    int rec(std::vector<int>& ids, int lo_i, int hi_i) {
        double lo[3] = {1e300, 1e300, 1e300};
        double hi[3] = {-1e300, -1e300, -1e300};
        for (int k = lo_i; k < hi_i; ++k) {
            const double* a = bmin + 3 * ids[k];
            const double* b = bmax + 3 * ids[k];
            for (int ax = 0; ax < 3; ++ax) {
                lo[ax] = std::min(lo[ax], a[ax]);
                hi[ax] = std::max(hi[ax], b[ax]);
            }
        }
        if (hi_i - lo_i == 1) return emit(lo, hi, prim_ids[ids[lo_i]]);
        int axis = 0;
        double ext = hi[0] - lo[0];
        for (int ax = 1; ax < 3; ++ax)
            if (hi[ax] - lo[ax] > ext) { ext = hi[ax] - lo[ax]; axis = ax; }
        std::stable_sort(ids.begin() + lo_i, ids.begin() + hi_i,
                         [&](int a, int b) {
                             return bmin[3 * a + axis] < bmin[3 * b + axis];
                         });
        int mid = lo_i + (hi_i - lo_i) / 2;
        int me = emit(lo, hi, -1);
        int left = rec(ids, lo_i, mid);
        int right = rec(ids, mid, hi_i);
        escape[left] = right;   // after the left subtree, resume at sibling
        return me;
    }

    void fill(int idx, int after) {
        for (;;) {
            if (prim[idx] >= 0) { escape[idx] = after; return; }
            int left = idx + 1;
            int right = escape[left];
            escape[idx] = after;
            fill(left, right);
            idx = right;            // tail-recurse into the right child
        }
    }
};

}  // namespace

// Outputs must have capacity for 2n-1 nodes.  Returns node count (>=0) or
// a negative error code.
int rtow_build_bvh(const double* bbox_min, const double* bbox_max,
                   const int32_t* prim_ids, int n,
                   double* out_nmin, double* out_nmax,
                   int32_t* out_prim, int32_t* out_escape) {
    if (n < 0) return -1;
    if (n == 0) return 0;
    Builder b;
    b.bmin = bbox_min;
    b.bmax = bbox_max;
    b.prim_ids = prim_ids;
    b.nmin.reserve((size_t)(2 * n - 1) * 3);
    std::vector<int> ids(n);
    std::iota(ids.begin(), ids.end(), 0);
    int root = b.rec(ids, 0, n);
    if (root != 0) return -2;
    int m = (int)b.prim.size();
    b.fill(0, m);
    std::memcpy(out_nmin, b.nmin.data(), sizeof(double) * 3 * m);
    std::memcpy(out_nmax, b.nmax.data(), sizeof(double) * 3 * m);
    std::memcpy(out_prim, b.prim.data(), sizeof(int32_t) * m);
    std::memcpy(out_escape, b.escape.data(), sizeof(int32_t) * m);
    return m;
}

}  // extern "C"
