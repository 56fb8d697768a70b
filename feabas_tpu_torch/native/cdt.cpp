// Constrained-edge enforcement over a Delaunay triangulation
// (host-plane helper).
//
// Replaces the constrained part of the Shewchuk `triangle` wheel the
// reference drives at feabas/mesh.py:296-385. Division of labor: the
// caller builds an (unconstrained) Delaunay triangulation with a robust
// library (scipy/Qhull) and passes triangles; this routine recovers every
// requested segment as an edge with the classical channel method
// (Anglada-style): collect the triangles the segment crosses, remove
// them, and retriangulate the two pseudo-polygons either side of the
// segment with the Delaunay criterion. Outside/hole trimming stays in
// the Python caller.
//
// Triangles are (NT, 3) CCW vertex ids (the caller canonicalizes);
// adjacency is rebuilt internally, so only `tris` is read/written.

#include <cstdint>
#include <cmath>
#include <vector>
#include <unordered_map>
#include <algorithm>

namespace {

struct Mesh {
    const double* pts;
    int32_t* tv;                 // (nt, 3), mutated in place
    int64_t nt;
    int64_t npts;
    // adjacency: edge (directed a->b) -> triangle having that CCW edge
    std::unordered_map<int64_t, int64_t> emap;

    int64_t ekey(int64_t a, int64_t b) const { return a * npts + b; }

    void rebuild_edges() {
        emap.clear();
        emap.reserve(3 * nt);
        for (int64_t t = 0; t < nt; ++t) {
            for (int i = 0; i < 3; ++i) {
                int64_t a = tv[3 * t + i], b = tv[3 * t + (i + 1) % 3];
                emap[ekey(a, b)] = t;
            }
        }
    }

    double px(int64_t i) const { return pts[2 * i]; }
    double py(int64_t i) const { return pts[2 * i + 1]; }

    static double orient(double ax, double ay, double bx, double by,
                         double cx, double cy) {
        return (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
    }
    double orient_i(int64_t a, int64_t b, int64_t c) const {
        return orient(px(a), py(a), px(b), py(b), px(c), py(c));
    }
    bool incircle(int64_t a, int64_t b, int64_t c, int64_t d) const {
        // d strictly inside the circumcircle of (a, b, c), independent of
        // the triple's orientation
        double adx = px(a) - px(d), ady = py(a) - py(d);
        double bdx = px(b) - px(d), bdy = py(b) - py(d);
        double cdx = px(c) - px(d), cdy = py(c) - py(d);
        double ad = adx * adx + ady * ady;
        double bd = bdx * bdx + bdy * bdy;
        double cd = cdx * cdx + cdy * cdy;
        double det = adx * (bdy * cd - bd * cdy)
                   - ady * (bdx * cd - bd * cdx)
                   + ad * (bdx * cdy - bdy * cdx);
        return (orient_i(a, b, c) > 0) ? (det > 0.0) : (det < 0.0);
    }

    bool proper_cross(int64_t a, int64_t b, int64_t c, int64_t d) const {
        double o1 = orient_i(a, b, c);
        double o2 = orient_i(a, b, d);
        double o3 = orient_i(c, d, a);
        double o4 = orient_i(c, d, b);
        double eps = 1e-12;
        return (o1 * o2 < -eps) && (o3 * o4 < -eps);
    }

    bool edge_exists(int64_t a, int64_t b) const {
        return emap.count(ekey(a, b)) || emap.count(ekey(b, a));
    }

    // recursive pseudo-polygon triangulation (Delaunay criterion):
    // chain vertices lie on one side of segment (a, b), ordered a -> b
    void tri_pseudo(int64_t a, int64_t b, const std::vector<int64_t>& chain,
                    std::vector<int64_t>& out) {
        if (chain.empty()) return;
        size_t ci = 0;
        for (size_t i = 1; i < chain.size(); ++i) {
            if (incircle(a, b, chain[ci], chain[i])) ci = i;
        }
        int64_t c = chain[ci];
        std::vector<int64_t> left(chain.begin(), chain.begin() + ci);
        std::vector<int64_t> right(chain.begin() + ci + 1, chain.end());
        tri_pseudo(a, c, left, out);
        out.push_back(a); out.push_back(c); out.push_back(b);
        tri_pseudo(c, b, right, out);
    }

    // enforce one constrained segment; returns true on success
    bool insert_constraint(int64_t a, int64_t b) {
        if (edge_exists(a, b)) return true;
        // find the triangle at `a` whose opposite edge crosses (a, b)
        int64_t t0 = -1;
        int e0 = -1;
        for (int64_t t = 0; t < nt && t0 < 0; ++t) {
            for (int i = 0; i < 3; ++i) {
                if (tv[3 * t + i] != a) continue;
                int64_t u = tv[3 * t + (i + 1) % 3];
                int64_t w = tv[3 * t + (i + 2) % 3];
                if (u == b || w == b) return true;  // already an edge
                if (proper_cross(a, b, u, w)) { t0 = t; e0 = i; break; }
            }
        }
        if (t0 < 0) return false;  // a vertex lies on the segment: give up
        // walk the channel from a to b, collecting crossed triangles and
        // the upper/lower chains (left/right of a->b)
        std::vector<int64_t> channel;
        std::vector<int64_t> upper, lower;
        auto add_side = [&](int64_t v) {
            if (v == a || v == b) return;
            double o = orient_i(a, b, v);
            std::vector<int64_t>& chain = (o > 0) ? upper : lower;
            if (chain.empty() || chain.back() != v) chain.push_back(v);
        };
        int64_t t = t0;
        int64_t u = tv[3 * t0 + (e0 + 1) % 3];
        int64_t w = tv[3 * t0 + (e0 + 2) % 3];
        channel.push_back(t0);
        add_side(u); add_side(w);
        int64_t cross_a = u, cross_b = w;  // current crossed edge (CCW in t)
        for (int64_t guard = 0; guard < nt + 8; ++guard) {
            // neighbor across the crossed edge: triangle with the reversed
            // directed edge
            auto it = emap.find(ekey(cross_b, cross_a));
            if (it == emap.end()) return false;  // hull reached: invalid
            int64_t tn = it->second;
            channel.push_back(tn);
            // apex of tn relative to edge (cross_b, cross_a)
            int64_t apex = -1;
            for (int i = 0; i < 3; ++i) {
                int64_t v = tv[3 * tn + i];
                if (v != cross_a && v != cross_b) { apex = v; break; }
            }
            if (apex == b) break;
            if (apex < 0) return false;
            add_side(apex);
            // segment exits tn through (cross_a, apex) or (apex, cross_b)
            if (proper_cross(a, b, cross_a, apex)) {
                cross_b = apex;                 // new edge (cross_a, apex)
            } else if (proper_cross(a, b, apex, cross_b)) {
                cross_a = apex;
            } else {
                return false;  // touches a vertex: give up
            }
            t = tn;
        }
        // retriangulate the two pseudo-polygons; emit CCW; update the
        // edge map incrementally (only channel triangles changed)
        std::vector<int64_t> newt;
        tri_pseudo(a, b, upper, newt);   // (a, c, b) with c left of a->b
        tri_pseudo(a, b, lower, newt);
        if (newt.size() != 3 * channel.size()) return false;  // safety
        for (int64_t ti : channel) {
            for (int i = 0; i < 3; ++i) {
                emap.erase(ekey(tv[3 * ti + i], tv[3 * ti + (i + 1) % 3]));
            }
        }
        for (size_t k = 0; k < channel.size(); ++k) {
            int64_t A = newt[3 * k], C = newt[3 * k + 1], B = newt[3 * k + 2];
            int64_t ti = channel[k];
            if (orient_i(A, C, B) <= 0) std::swap(C, B);
            tv[3 * ti] = (int32_t)A; tv[3 * ti + 1] = (int32_t)C;
            tv[3 * ti + 2] = (int32_t)B;
            for (int i = 0; i < 3; ++i) {
                emap[ekey(tv[3 * ti + i], tv[3 * ti + (i + 1) % 3])] = ti;
            }
        }
        return edge_exists(a, b);
    }
};

}  // namespace

extern "C" int64_t cdt_enforce(
        const double* pts, int64_t npts,
        int32_t* tris, int32_t* neighbors, int64_t ntris,
        const int32_t* segs, int64_t nsegs) {
    (void)neighbors;  // adjacency is rebuilt internally
    Mesh m;
    m.pts = pts;
    m.tv = tris;
    m.nt = ntris;
    m.npts = npts;
    m.rebuild_edges();
    int64_t ok = 0;
    for (int64_t k = 0; k < nsegs; ++k) {
        int64_t a = segs[2 * k], b = segs[2 * k + 1];
        if (a == b || a < 0 || b < 0 || a >= npts || b >= npts) continue;
        if (m.insert_constraint(a, b)) ++ok;
    }
    return ok;
}
