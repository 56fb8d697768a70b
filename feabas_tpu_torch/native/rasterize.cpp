// Triangle-id rasterizer for mesh-warped rendering (host plane).
//
// Fills a (H, W) int32 map with the id of the triangle covering each pixel
// (-1 outside), optionally arbitrating overlaps by per-triangle weight.
// Replaces the per-triangle numpy loop in feabas_tpu/renderer.py for large
// outputs; exposed through ctypes (see feabas_tpu/native/__init__.py).
//
// Build: g++ -O3 -march=native -shared -fPIC rasterize.cpp -o librasterize.so

#include <cstdint>
#include <cmath>
#include <algorithm>
#include <limits>

extern "C" {

// verts: (NV, 2) float64 world coordinates (already offset)
// tris:  (NT, 3) int32
// weights: per-triangle weight (NT) or nullptr (last-writer-wins)
// out_tid: (H, W) int32 prefilled with -1
// origin: (x0, y0) of pixel (0, 0)
void rasterize_triangles(const double* verts, int64_t nv,
                         const int32_t* tris, int64_t nt,
                         const float* weights,
                         int32_t* out_tid, float* wmap,
                         int64_t H, int64_t W,
                         double x0, double y0) {
    const double eps = 1e-9;
    for (int64_t t = 0; t < nt; ++t) {
        const int32_t i0 = tris[3 * t], i1 = tris[3 * t + 1], i2 = tris[3 * t + 2];
        const double ax = verts[2 * i0] - x0, ay = verts[2 * i0 + 1] - y0;
        const double bx = verts[2 * i1] - x0, by = verts[2 * i1 + 1] - y0;
        const double cx = verts[2 * i2] - x0, cy = verts[2 * i2 + 1] - y0;
        const double den = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
        if (std::fabs(den) < 1e-12) continue;
        const double inv_den = 1.0 / den;
        int64_t px0 = std::max<int64_t>((int64_t)std::floor(std::min({ax, bx, cx})), 0);
        int64_t px1 = std::min<int64_t>((int64_t)std::ceil(std::max({ax, bx, cx})) + 1, W);
        int64_t py0 = std::max<int64_t>((int64_t)std::floor(std::min({ay, by, cy})), 0);
        int64_t py1 = std::min<int64_t>((int64_t)std::ceil(std::max({ay, by, cy})) + 1, H);
        if (px0 >= px1 || py0 >= py1) continue;
        const float wt = weights ? weights[t] : 0.0f;
        for (int64_t y = py0; y < py1; ++y) {
            const double dy = (double)y - ay;
            // barycentric along the row: l1, l2 are affine in x, so compute
            // at row start and increment
            const double dx0 = (double)px0 - ax;
            double l1 = (dx0 * (cy - ay) - dy * (cx - ax)) * inv_den;
            double l2 = ((bx - ax) * dy - (by - ay) * dx0) * inv_den;
            const double dl1 = (cy - ay) * inv_den;
            const double dl2 = -(by - ay) * inv_den;
            int32_t* row = out_tid + y * W;
            float* wrow = wmap ? (wmap + y * W) : nullptr;
            for (int64_t x = px0; x < px1; ++x, l1 += dl1, l2 += dl2) {
                if (l1 >= -eps && l2 >= -eps && (l1 + l2) <= 1.0 + eps) {
                    if (wrow) {
                        if (wt > wrow[x]) { wrow[x] = wt; row[x] = (int32_t)t; }
                    } else {
                        row[x] = (int32_t)t;
                    }
                }
            }
        }
    }
}

// Evaluate per-pixel source coordinates from the tid map and per-triangle
// affines: src = p @ A[t] + b[t]; NaN where tid < 0.
void field_from_tids(const int32_t* tid, int64_t H, int64_t W,
                     const double* A,  // (NT, 2, 2) row-vector convention
                     const double* b,  // (NT, 2)
                     double x0, double y0,
                     float* map_x, float* map_y) {
    const float nanv = std::numeric_limits<float>::quiet_NaN();
    for (int64_t y = 0; y < H; ++y) {
        const double py = y0 + (double)y;
        for (int64_t x = 0; x < W; ++x) {
            const int64_t k = y * W + x;
            const int32_t t = tid[k];
            if (t < 0) { map_x[k] = nanv; map_y[k] = nanv; continue; }
            const double px = x0 + (double)x;
            const double* At = A + 4 * (int64_t)t;
            const double* bt = b + 2 * (int64_t)t;
            map_x[k] = (float)(px * At[0] + py * At[2] + bt[0]);
            map_y[k] = (float)(px * At[1] + py * At[3] + bt[1]);
        }
    }
}

}  // extern "C"
