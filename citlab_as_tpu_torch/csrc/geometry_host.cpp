// Host geometry library of the PyTorch port: the baseline-clustering and
// text-region stages' pairwise loops, baseline normalization and the alpha
// shape, in C++ for the host CPU.
//
// A copy of the entry points of the JAX package's host kernel
// (native/geometry_kernel.cpp) that the port's main path reaches, with
// their helpers, unchanged in arithmetic and loop order:
//   gk_interline_distances / gk_interline_distances_normed
//                          - per-baseline minimum perpendicular distance
//   gk_norm_poly_sizes / gk_norm_poly_dists
//                          - blow_up + thin_out baseline normalization
//   gk_cluster_features    - the fused feature pass of DBSCANBaselines
//   gk_delaunay            - sweep-circle Delaunay triangulation
//   gk_alpha_shape         - alpha shape boundary with the 20 % escalation
//   gk_calc_tols           - the AS measure's tolerance per GT baseline
//   gk_calc_metric         - the AS measure's precision / recall per page
// Built at first use by citlab_as_tpu_torch/ops/kernels/build.py with the
// host C++ compiler and the JAX package's flags (-O3 -march=native -fPIC
// -shared -std=c++17), and loaded with ctypes by
// citlab_as_tpu_torch/geometry/native.py. Results are bit-identical to the
// JAX package's host library on the same host; the numpy plain versions in
// citlab_as_tpu_torch/geometry/{pairwise,polygon,util}.py and
// stages/baseline_clustering.py give the same integers and agree on the
// doubles to the last bits (where the compiler fuses a multiply-add, numpy
// rounds twice).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <unordered_map>
#include <vector>

namespace {

struct Poly {
    std::vector<double> x;
    std::vector<double> y;
    double bb_x0 = 0, bb_y0 = 0, bb_x1 = 0, bb_y1 = 0;  // x, y, x+w, y+h

    void calc_bounds() {
        double minx = x[0], maxx = x[0], miny = y[0], maxy = y[0];
        for (size_t i = 1; i < x.size(); ++i) {
            minx = std::min(minx, x[i]);
            maxx = std::max(maxx, x[i]);
            miny = std::min(miny, y[i]);
            maxy = std::max(maxy, y[i]);
        }
        // width = max-min+1 convention (polygon.py calculate_bounds)
        bb_x0 = minx;
        bb_y0 = miny;
        bb_x1 = minx + (maxx - minx + 1);
        bb_y1 = miny + (maxy - miny + 1);
    }
};

// round_to_nearest_integer (rounding.py:20-31): x%1>=0.5 -> trunc(x)+1
inline long round_half_up(double v) {
    double frac = v - std::floor(v);  // Python x % 1 for divisor 1
    double base = std::trunc(v);
    return (long)(frac >= 0.5 ? base + 1 : base);
}

Poly blow_up(const Poly& p) {
    Poly res;
    size_t n = p.x.size();
    if (n < 2) { res = p; return res; }
    for (size_t i = 1; i < n; ++i) {
        double x1 = p.x[i - 1], y1 = p.y[i - 1];
        double x2 = p.x[i], y2 = p.y[i];
        long diff_x = (long)std::llabs((long long)(x2 - x1));
        long diff_y = (long)std::llabs((long long)(y2 - y1));
        if (std::max(diff_x, diff_y) < 1) {
            if (i == n - 1) { res.x.push_back(x2); res.y.push_back(y2); }
            continue;
        }
        res.x.push_back(x1);
        res.y.push_back(y1);
        if (diff_x >= diff_y) {
            for (long j = 1; j < diff_x; ++j) {
                double xn = x1 < x2 ? x1 + j : x1 - j;
                double yn = (double)round_half_up(y1 + (xn - x1) * (y2 - y1) / (x2 - x1));
                res.x.push_back(xn);
                res.y.push_back(yn);
            }
        } else {
            for (long j = 1; j < diff_y; ++j) {
                double yn = y1 < y2 ? y1 + j : y1 - j;
                double xn = (double)round_half_up(x1 + (yn - y1) * (x2 - x1) / (y2 - y1));
                res.x.push_back(xn);
                res.y.push_back(yn);
            }
        }
        if (i == n - 1) { res.x.push_back(x2); res.y.push_back(y2); }
    }
    return res;
}

Poly thin_out(const Poly& p, long des_dist) {
    if (p.x.size() <= 20) return p;
    Poly res;
    long dist = (long)p.x.size() - 1;
    long des_pts = std::max(20L, dist / des_dist + 1);
    double step = (double)dist / (double)(des_pts - 1);
    for (long i = 0; i < des_pts - 1; ++i) {
        long idx = (long)(i * step);
        res.x.push_back(p.x[idx]);
        res.y.push_back(p.y[idx]);
    }
    res.x.push_back(p.x.back());
    res.y.push_back(p.y.back());
    return res;
}

Poly norm_poly(const Poly& p, long des_dist) {
    // huge-bbox guard (polygon.py:256-259)
    double minx = p.x[0], maxx = p.x[0], miny = p.y[0], maxy = p.y[0];
    for (size_t i = 1; i < p.x.size(); ++i) {
        minx = std::min(minx, p.x[i]);
        maxx = std::max(maxx, p.x[i]);
        miny = std::min(miny, p.y[i]);
        maxy = std::max(maxy, p.y[i]);
    }
    Poly src = p;
    if (maxx - minx + 1 > 100000 || maxy - miny + 1 > 100000) {
        src.x = {0}; src.y = {0};
    }
    Poly out = thin_out(blow_up(src), des_dist);
    out.calc_bounds();
    return out;
}

// calc_reg_line_stats angle (polygon.py:271-319)
double reg_line_angle(const Poly& p) {
    size_t n = p.x.size();
    if (n <= 1) return 0.0;
    double m;
    bool inf_slope = false;
    if (n > 2) {
        double xmax = *std::max_element(p.x.begin(), p.x.end());
        double xmin = *std::min_element(p.x.begin(), p.x.end());
        if (xmax == xmin) {
            inf_slope = true;
            m = 0;
        } else if (xmax - xmin < 2) {
            inf_slope = true;  // calc_line's x-range guard
            m = 0;
        } else {
            // 2x2 normal equations on (x, -y)
            double s1 = (double)n, sx = 0, sxx = 0, sy = 0, sxy = 0;
            for (size_t i = 0; i < n; ++i) {
                double xi = p.x[i], yi = -p.y[i];
                sx += xi; sxx += xi * xi; sy += yi; sxy += xi * yi;
            }
            double det = s1 * sxx - sx * sx;
            if (det < 1e-9) {
                inf_slope = true;
                m = 0;
            } else {
                m = (s1 * sxy - sx * sy) / det;
            }
        }
    } else {
        double x1 = p.x[0], x2 = p.x[1];
        double y1 = -p.y[0], y2 = -p.y[1];
        if (x1 == x2) { inf_slope = true; m = 0; }
        else m = (y2 - y1) / (x2 - x1);
    }
    double angle = inf_slope ? M_PI / 2 : std::atan(m);
    if (angle > -M_PI / 2 && angle <= -M_PI / 4 && p.y.front() > p.y.back())
        angle += M_PI;
    if (angle > -M_PI / 4 && angle <= M_PI / 4 && p.x.front() > p.x.back())
        angle += M_PI;
    if (angle > M_PI / 4 && angle < M_PI / 2 && p.y.front() < p.y.back())
        angle += M_PI;
    if (angle < 0) angle += 2 * M_PI;
    return angle;
}

inline double dist_fast(double px, double py, const Poly& b) {
    double d = 0.0;
    if (px < b.bb_x0) d += b.bb_x0 - px;
    if (px > b.bb_x1) d += px - b.bb_x1;
    if (py < b.bb_y0) d += b.bb_y0 - py;
    if (py > b.bb_y1) d += py - b.bb_y1;
    return d;
}

inline double in_dist(double p1x, double p1y, double p2x, double p2y,
                      double ox, double oy) {
    return (p1x - p2x) * ox + (-p1y + p2y) * oy;
}

inline double off_dist(double p1x, double p1y, double p2x, double p2y,
                       double ox, double oy) {
    return (p1x - p2x) * oy - (-p1y + p2y) * ox;
}

// shared loop nest of interline distances / tolerance calc
std::vector<double> min_perp_dists(const std::vector<Poly>& polys,
                                   double tick, double max_d) {
    size_t n = polys.size();
    std::vector<double> out(n, max_d);
    for (size_t a = 0; a < n; ++a) {
        const Poly& pa = polys[a];
        double angle = reg_line_angle(pa);
        double ox = std::cos(angle), oy = std::sin(angle);
        double dist = max_d;
        double a1x = pa.x.front(), a1y = pa.y.front();
        double a2x = pa.x.back(), a2y = pa.y.back();
        for (size_t ai = 0; ai < pa.x.size(); ++ai) {
            double px = pa.x[ai], py = pa.y[ai];
            for (size_t b = 0; b < n; ++b) {
                if (b == a) continue;
                const Poly& pb = polys[b];
                if (dist_fast(px, py, pb) > dist) continue;  // running skip
                double b1x = pb.x.front(), b1y = pb.y.front();
                double b2x = pb.x.back(), b2y = pb.y.back();
                double d11 = in_dist(a1x, a1y, b1x, b1y, ox, oy);
                double d12 = in_dist(a1x, a1y, b2x, b2y, ox, oy);
                double d21 = in_dist(a2x, a2y, b1x, b1y, ox, oy);
                double d22 = in_dist(a2x, a2y, b2x, b2y, ox, oy);
                if ((d11 < 0 && d12 < 0 && d21 < 0 && d22 < 0) ||
                    (d11 > 0 && d12 > 0 && d21 > 0 && d22 > 0))
                    continue;
                for (size_t bi = 0; bi < pb.x.size(); ++bi) {
                    if (std::fabs(in_dist(px, py, pb.x[bi], pb.y[bi], ox, oy)) <= 2.0 * tick) {
                        double od = std::fabs(off_dist(px, py, pb.x[bi], pb.y[bi], ox, oy));
                        dist = std::min(dist, od);
                    }
                }
            }
        }
        out[a] = dist;
    }
    return out;
}

std::vector<Poly> unpack(const double* coords, const int32_t* offsets,
                         int32_t n_polys) {
    std::vector<Poly> polys(n_polys);
    for (int32_t i = 0; i < n_polys; ++i) {
        int32_t start = offsets[i], end = offsets[i + 1];
        polys[i].x.reserve(end - start);
        polys[i].y.reserve(end - start);
        for (int32_t j = start; j < end; ++j) {
            polys[i].x.push_back(coords[2 * j]);
            polys[i].y.push_back(coords[2 * j + 1]);
        }
        polys[i].calc_bounds();
    }
    return polys;
}

// soft hit count (eval_measure.py:126-175) for all tolerance ticks at once
void count_rel_hits(const Poly& to_count, const Poly& ref,
                    const double* tols, int32_t n_tols, double* out) {
    for (int32_t t = 0; t < n_tols; ++t) out[t] = 0.0;
    // bbox early stop against intersection extents (possibly negative)
    double ix0 = std::max(to_count.bb_x0, ref.bb_x0);
    double iy0 = std::max(to_count.bb_y0, ref.bb_y0);
    double ix1 = std::min(to_count.bb_x1, ref.bb_x1);
    double iy1 = std::min(to_count.bb_y1, ref.bb_y1);
    if (std::min(ix1 - ix0, iy1 - iy0) < -3.0 * tols[n_tols - 1]) return;

    size_t np = to_count.x.size();
    for (size_t i = 0; i < np; ++i) {
        double md = std::numeric_limits<double>::infinity();
        for (size_t j = 0; j < ref.x.size(); ++j) {
            double d = std::fabs(to_count.x[i] - ref.x[j])
                     + std::fabs(to_count.y[i] - ref.y[j]);
            md = std::min(md, d);
        }
        for (int32_t t = 0; t < n_tols; ++t) {
            double tol = tols[t];
            if (md <= tol) out[t] += 1.0;
            else if (md <= 3.0 * tol) out[t] += (3.0 * tol - md) / (2.0 * tol);
        }
    }
    for (int32_t t = 0; t < n_tols; ++t) out[t] /= (double)np;
}

void count_rel_hits_union(const Poly& to_count, const std::vector<Poly>& refs,
                          const double* tols, int32_t n_tols, double* out) {
    for (int32_t t = 0; t < n_tols; ++t) out[t] = 0.0;
    size_t np = to_count.x.size();
    std::vector<double> min_dist(np, std::numeric_limits<double>::infinity());
    bool any = false;
    for (const Poly& ref : refs) {
        double ix0 = std::max(to_count.bb_x0, ref.bb_x0);
        double iy0 = std::max(to_count.bb_y0, ref.bb_y0);
        double ix1 = std::min(to_count.bb_x1, ref.bb_x1);
        double iy1 = std::min(to_count.bb_y1, ref.bb_y1);
        if (std::min(ix1 - ix0, iy1 - iy0) < -3.0 * tols[n_tols - 1]) continue;
        any = true;
        for (size_t i = 0; i < np; ++i) {
            for (size_t j = 0; j < ref.x.size(); ++j) {
                double d = std::fabs(to_count.x[i] - ref.x[j])
                         + std::fabs(to_count.y[i] - ref.y[j]);
                min_dist[i] = std::min(min_dist[i], d);
            }
        }
    }
    if (!any) return;
    for (size_t i = 0; i < np; ++i) {
        for (int32_t t = 0; t < n_tols; ++t) {
            double tol = tols[t];
            if (min_dist[i] <= tol) out[t] += 1.0;
            else if (min_dist[i] <= 3.0 * tol) out[t] += (3.0 * tol - min_dist[i]) / (2.0 * tol);
        }
    }
    for (int32_t t = 0; t < n_tols; ++t) out[t] /= (double)np;
}

std::vector<double> calc_tols_inner(const std::vector<Poly>& normed,
                                    double tick, double max_d, double rel_tol) {
    std::vector<double> d = min_perp_dists(normed, tick, max_d);
    std::vector<double> tols(d.size());
    double sum = 0; int cnt = 0;
    for (size_t i = 0; i < d.size(); ++i) {
        tols[i] = d[i] < max_d ? d[i] : 0.0;
        if (tols[i] != 0) { sum += tols[i]; ++cnt; }
    }
    double mean = cnt ? sum / cnt : max_d;
    for (size_t i = 0; i < tols.size(); ++i) {
        if (tols[i] == 0) tols[i] = mean;
        tols[i] = std::min(tols[i], mean) * rel_tol;
    }
    return tols;
}

}  // namespace

extern "C" {

// coords: [total_points * 2] doubles (x, y interleaved, RAW polygons);
// offsets: [n_polys + 1] point offsets; out: [n_polys]
void gk_interline_distances(const double* coords, const int32_t* offsets,
                            int32_t n_polys, int32_t des_dist, double max_d,
                            double* out) {
    std::vector<Poly> raw = unpack(coords, offsets, n_polys);
    std::vector<Poly> normed(n_polys);
    for (int32_t i = 0; i < n_polys; ++i) normed[i] = norm_poly(raw[i], des_dist);
    std::vector<double> d = min_perp_dists(normed, des_dist, max_d);
    std::memcpy(out, d.data(), n_polys * sizeof(double));
}

// same, but polygons are already normed (matches the numpy-path contract)
void gk_interline_distances_normed(const double* coords, const int32_t* offsets,
                                   int32_t n_polys, int32_t des_dist,
                                   double max_d, double* out) {
    std::vector<Poly> normed = unpack(coords, offsets, n_polys);
    std::vector<double> d = min_perp_dists(normed, des_dist, max_d);
    std::memcpy(out, d.data(), n_polys * sizeof(double));
}

void gk_calc_tols(const double* coords, const int32_t* offsets,
                  int32_t n_polys, int32_t tick_dist, double max_d,
                  double rel_tol, double* out) {
    std::vector<Poly> normed = unpack(coords, offsets, n_polys);
    std::vector<double> tols = calc_tols_inner(normed, tick_dist, max_d, rel_tol);
    std::memcpy(out, tols.data(), n_polys * sizeof(double));
}

// AS measure page metric (java Util.calcMetricForPageBaseLinePolys analog):
// truth/reco given RAW; tols: n_tols tick values, tols[0] < 0 -> dynamic.
// out_precision: [n_tols * n_reco], out_recall: [n_tols * n_truth]
void gk_calc_metric(const double* t_coords, const int32_t* t_offsets, int32_t n_truth,
                    const double* r_coords, const int32_t* r_offsets, int32_t n_reco,
                    const double* tols_in, int32_t n_tols,
                    int32_t tick_dist, double rel_tol,
                    double* out_precision, double* out_recall) {
    std::vector<Poly> truth_raw = unpack(t_coords, t_offsets, n_truth);
    std::vector<Poly> reco_raw = unpack(r_coords, r_offsets, n_reco);
    std::vector<Poly> truth(n_truth), reco(n_reco);
    for (int32_t i = 0; i < n_truth; ++i) truth[i] = norm_poly(truth_raw[i], tick_dist);
    for (int32_t i = 0; i < n_reco; ++i) reco[i] = norm_poly(reco_raw[i], tick_dist);

    // per-truth-line tolerance vectors [n_truth][n_tols]
    std::vector<std::vector<double>> line_tols(n_truth, std::vector<double>(n_tols));
    if (n_tols > 0 && tols_in[0] < 0) {
        std::vector<double> dyn = calc_tols_inner(truth, tick_dist, 250.0, rel_tol);
        for (int32_t i = 0; i < n_truth; ++i)
            for (int32_t t = 0; t < n_tols; ++t) line_tols[i][t] = dyn[i];
    } else {
        for (int32_t i = 0; i < n_truth; ++i)
            for (int32_t t = 0; t < n_tols; ++t) line_tols[i][t] = tols_in[t];
    }

    // precision: greedy alignment over per-pair hit counts
    std::vector<double> hits((size_t)n_tols * n_reco * n_truth, 0.0);
    std::vector<double> tmp(n_tols);
    for (int32_t i = 0; i < n_reco; ++i) {
        for (int32_t j = 0; j < n_truth; ++j) {
            count_rel_hits(reco[i], truth[j], line_tols[j].data(), n_tols, tmp.data());
            for (int32_t t = 0; t < n_tols; ++t)
                hits[(size_t)t * n_reco * n_truth + (size_t)i * n_truth + j] = tmp[t];
        }
    }
    for (int32_t t = 0; t < n_tols; ++t) {
        double* h = &hits[(size_t)t * n_reco * n_truth];
        for (int32_t i = 0; i < n_reco; ++i) out_precision[(size_t)t * n_reco + i] = 0.0;
        while (true) {
            double best = -1.0;
            int32_t bi = 0, bj = 0;
            for (int32_t i = 0; i < n_reco; ++i)
                for (int32_t j = 0; j < n_truth; ++j) {
                    double v = h[(size_t)i * n_truth + j];
                    if (v > best) { best = v; bi = i; bj = j; }
                }
            if (best < 0) break;
            out_precision[(size_t)t * n_reco + bi] = best;
            for (int32_t j = 0; j < n_truth; ++j) h[(size_t)bi * n_truth + j] = -1.0;
            for (int32_t i = 0; i < n_reco; ++i) h[(size_t)i * n_truth + bj] = -1.0;
        }
    }

    // recall: union over reco polygons
    for (int32_t j = 0; j < n_truth; ++j) {
        count_rel_hits_union(truth[j], reco, line_tols[j].data(), n_tols, tmp.data());
        for (int32_t t = 0; t < n_tols; ++t)
            out_recall[(size_t)t * n_truth + j] = tmp[t];
    }
}

}  // extern "C"

// 2-D Delaunay triangulation (sweep-circle, O(n log n)) for the alpha
// shape. The triangle SET equals any valid Delaunay triangulation where it
// is unique; under cocircularity ties are broken by the sweep order, so
// the text-region boundaries follow this triangulation, not qhull's.
//
// Conventions: triangles CCW; hull is a CCW circular list with the
// interior on the left of (v -> next[v]); hull_tri[v] is the halfedge id
// of the directed boundary edge v -> next[v]; halfedge k of triangle t
// is edge (tri[3t+k] -> tri[3t+(k+1)%3]) and halfedges[] pairs reversed
// directed edges (-1 on the boundary).

namespace {

struct Delaunator {
    const double* pts;  // interleaved x,y
    int32_t n;
    std::vector<int32_t> tri;        // 3 vertex ids per triangle
    std::vector<int32_t> half;       // paired halfedge or -1
    std::vector<int32_t> hull_prev, hull_next, hull_tri, hash;
    std::vector<int32_t> stack;
    int32_t hash_size = 0;
    double cx = 0, cy = 0;  // seed circumcenter (sweep origin)

    double x(int32_t i) const { return pts[2 * i]; }
    double y(int32_t i) const { return pts[2 * i + 1]; }

    // > 0 iff (a,b,c) is a counter-clockwise turn
    double orient(int32_t a, int32_t b, int32_t c) const {
        return (x(b) - x(a)) * (y(c) - y(a)) - (y(b) - y(a)) * (x(c) - x(a));
    }

    // p strictly inside the circumcircle of CCW triangle (a,b,c)
    bool in_circle(int32_t a, int32_t b, int32_t c, int32_t p) const {
        double dx = x(a) - x(p), dy = y(a) - y(p);
        double ex = x(b) - x(p), ey = y(b) - y(p);
        double fx = x(c) - x(p), fy = y(c) - y(p);
        double ap = dx * dx + dy * dy;
        double bp = ex * ex + ey * ey;
        double cp = fx * fx + fy * fy;
        return dx * (ey * cp - bp * fy) - dy * (ex * cp - bp * fx)
             + ap * (ex * fy - ey * fx) > 0.0;
    }

    // squared circumradius of (a, b, c); HUGE_VAL when collinear
    double circum_r2(int32_t a, int32_t b, int32_t c) const {
        double dx = x(b) - x(a), dy = y(b) - y(a);
        double ex = x(c) - x(a), ey = y(c) - y(a);
        double bl = dx * dx + dy * dy, cl = ex * ex + ey * ey;
        double det = dx * ey - dy * ex;
        if (det == 0.0) return std::numeric_limits<double>::infinity();
        double d = 0.5 / det;
        double ux = (ey * bl - dy * cl) * d, uy = (dx * cl - ex * bl) * d;
        return ux * ux + uy * uy;
    }

    // monotone pseudo-angle of (dx, dy) in [0, 1)
    static double pseudo_angle(double dx, double dy) {
        double p = dx / (std::fabs(dx) + std::fabs(dy));
        return (dy > 0 ? 3.0 - p : 1.0 + p) / 4.0;
    }

    int32_t hash_key(double px, double py) const {
        int64_t k = (int64_t)std::floor(pseudo_angle(px - cx, py - cy)
                                        * (double)hash_size);
        return (int32_t)(((k % hash_size) + hash_size) % hash_size);
    }

    void link(int32_t a, int32_t b) {
        half[a] = b;
        if (b != -1) half[b] = a;
    }

    // append CCW triangle (i0, i1, i2); edges pair with (a, b, c)
    int32_t add_triangle(int32_t i0, int32_t i1, int32_t i2,
                         int32_t a, int32_t b, int32_t c) {
        int32_t t = (int32_t)tri.size();
        tri.push_back(i0); tri.push_back(i1); tri.push_back(i2);
        half.push_back(-1); half.push_back(-1); half.push_back(-1);
        link(t, a); link(t + 1, b); link(t + 2, c);
        return t;
    }

    // restore the Delaunay condition around halfedge a by edge flips;
    // returns the halfedge that ends up holding the new boundary edge
    // adjacent to the freshly inserted point (see insertion sites)
    int32_t legalize(int32_t a) {
        stack.clear();
        int32_t ar = 0;
        while (true) {
            int32_t b = half[a];
            int32_t a0 = a - a % 3;
            ar = a0 + (a + 2) % 3;
            if (b == -1) {
                if (stack.empty()) break;
                a = stack.back(); stack.pop_back();
                continue;
            }
            int32_t b0 = b - b % 3;
            int32_t al = a0 + (a + 1) % 3;
            int32_t bl = b0 + (b + 2) % 3;
            int32_t p0 = tri[ar];   // third vertex of this triangle
            int32_t pr = tri[a];    // flipped edge: pr -> pl
            int32_t pl = tri[al];
            int32_t p1 = tri[bl];   // third vertex of the adjacent triangle
            if (in_circle(p0, pr, pl, p1)) {
                tri[a] = p1;
                tri[b] = p0;
                int32_t hbl = half[bl];
                int32_t har = half[ar];
                // a relocated boundary edge must keep hull_tri[] valid:
                // p1->pl moves from slot bl to a; p0->pr from ar to b
                if (hbl == -1 && hull_tri[p1] == bl) hull_tri[p1] = a;
                if (har == -1 && hull_tri[p0] == ar) hull_tri[p0] = b;
                link(a, hbl);
                link(b, har);
                link(ar, bl);
                stack.push_back(b0 + (b + 1) % 3);  // re-check pr -> p1
            } else {
                if (stack.empty()) break;
                a = stack.back(); stack.pop_back();
            }
        }
        return ar;
    }

    // returns triangle count, or -1 when no triangulation exists
    int32_t run() {
        if (n < 3) return -1;
        // seed: point nearest the bbox centre, its nearest neighbour, and
        // the third point minimizing the circumradius
        double minx = x(0), maxx = x(0), miny = y(0), maxy = y(0);
        for (int32_t i = 1; i < n; ++i) {
            minx = std::min(minx, x(i)); maxx = std::max(maxx, x(i));
            miny = std::min(miny, y(i)); maxy = std::max(maxy, y(i));
        }
        double bx = (minx + maxx) / 2, by = (miny + maxy) / 2;
        auto dist2 = [&](int32_t i, double qx, double qy) {
            double dx = x(i) - qx, dy = y(i) - qy;
            return dx * dx + dy * dy;
        };
        int32_t i0 = 0;
        for (int32_t i = 1; i < n; ++i)
            if (dist2(i, bx, by) < dist2(i0, bx, by)) i0 = i;
        int32_t i1 = -1;
        double best = std::numeric_limits<double>::infinity();
        for (int32_t i = 0; i < n; ++i) {
            if (i == i0) continue;
            double d = dist2(i, x(i0), y(i0));
            if (d > 0.0 && d < best) { best = d; i1 = i; }
        }
        if (i1 == -1) return -1;  // all points coincident
        int32_t i2 = -1;
        best = std::numeric_limits<double>::infinity();
        for (int32_t i = 0; i < n; ++i) {
            if (i == i0 || i == i1) continue;
            double r = circum_r2(i0, i1, i);
            if (r < best) { best = r; i2 = i; }
        }
        if (i2 == -1 || !std::isfinite(best)) return -1;  // collinear input
        if (orient(i0, i1, i2) < 0) std::swap(i1, i2);

        // sweep origin: seed circumcenter
        {
            double dx = x(i1) - x(i0), dy = y(i1) - y(i0);
            double ex = x(i2) - x(i0), ey = y(i2) - y(i0);
            double bl = dx * dx + dy * dy, cl = ex * ex + ey * ey;
            double d = 0.5 / (dx * ey - dy * ex);
            cx = x(i0) + (ey * bl - dy * cl) * d;
            cy = y(i0) + (dx * cl - ex * bl) * d;
        }
        std::vector<int32_t> ids(n);
        for (int32_t i = 0; i < n; ++i) ids[i] = i;
        std::vector<double> d2(n);
        for (int32_t i = 0; i < n; ++i) d2[i] = dist2(i, cx, cy);
        std::sort(ids.begin(), ids.end(),
                  [&](int32_t a, int32_t b) { return d2[a] < d2[b]; });

        hash_size = (int32_t)std::ceil(std::sqrt((double)n));
        hash.assign(hash_size, -1);
        hull_prev.assign(n, -1);
        hull_next.assign(n, -1);
        hull_tri.assign(n, -1);
        tri.reserve((size_t)6 * n);
        half.reserve((size_t)6 * n);

        int32_t hull_start = i0;
        hull_next[i0] = i1; hull_prev[i1] = i0;
        hull_next[i1] = i2; hull_prev[i2] = i1;
        hull_next[i2] = i0; hull_prev[i0] = i2;
        add_triangle(i0, i1, i2, -1, -1, -1);
        hull_tri[i0] = 0; hull_tri[i1] = 1; hull_tri[i2] = 2;
        hash[hash_key(x(i0), y(i0))] = i0;
        hash[hash_key(x(i1), y(i1))] = i1;
        hash[hash_key(x(i2), y(i2))] = i2;

        double xp = 0, yp = 0;
        for (int32_t k = 0; k < n; ++k) {
            int32_t i = ids[k];
            if (i == i0 || i == i1 || i == i2) continue;
            if (k > 0 && x(i) == xp && y(i) == yp) continue;  // duplicate
            xp = x(i); yp = y(i);

            // visible hull edge: hash bucket, then walk forward
            int32_t start = -1;
            int32_t key = hash_key(x(i), y(i));
            for (int32_t j = 0; j < hash_size; ++j) {
                start = hash[(key + j) % hash_size];
                if (start != -1 && start != hull_next[start]) break;
            }
            if (start == -1) return -1;
            start = hull_prev[start];
            int32_t e = start, q;
            while (q = hull_next[e],
                   !(orient(e, q, i) < 0)) {  // visible = strictly right
                e = q;
                if (e == start) { e = -1; break; }
            }
            if (e == -1) continue;  // coincides with the hull — skip

            int32_t t = add_triangle(e, i, hull_next[e], -1, -1, hull_tri[e]);
            hull_tri[i] = legalize(t + 2);
            hull_tri[e] = t;

            // walk forward, filling visible edges
            int32_t nn = hull_next[e];
            while (q = hull_next[nn], orient(nn, q, i) < 0) {
                t = add_triangle(nn, i, q, hull_tri[i], -1, hull_tri[nn]);
                hull_tri[i] = legalize(t + 2);
                hull_next[nn] = nn;  // detached
                nn = q;
            }
            // walk backward
            if (e == start) {
                while (q = hull_prev[e], orient(q, e, i) < 0) {
                    t = add_triangle(q, i, e, -1, hull_tri[e], hull_tri[q]);
                    legalize(t + 2);
                    hull_tri[q] = t;
                    hull_next[e] = e;  // detached
                    e = q;
                }
            }
            hull_start = e;
            hull_prev[i] = e; hull_next[e] = i;
            hull_prev[nn] = i; hull_next[i] = nn;
            hash[hash_key(x(i), y(i))] = i;
            hash[hash_key(x(e), y(e))] = e;
        }
        (void)hull_start;
        return (int32_t)(tri.size() / 3);
    }
};

}  // namespace

extern "C" {

// points: n interleaved (x, y) doubles; out_tris: caller-allocated space for
// 3 * (2n) int32 vertex ids. Returns the triangle count or -1 on degenerate
// input (n < 3, all points collinear/coincident).
int32_t gk_delaunay(const double* points, int32_t n, int32_t* out_tris) {
    Delaunator d;
    d.pts = points;
    d.n = n;
    int32_t nt = d.run();
    if (nt <= 0) return -1;
    std::memcpy(out_tris, d.tri.data(), sizeof(int32_t) * d.tri.size());
    return nt;
}

// Alpha shape (concave hull) of 2-D points — the native twin of
// geometry/util.py alpha_shape (reference util.py:568-697): sweep-circle
// Delaunay, keep triangles with circumradius < alpha, boundary = edges
// appearing exactly once among kept triangles in first-occurrence scan
// order, walked into one closed circle; on a degenerate boundary (several
// circles / vertex used != 2 times / empty) alpha escalates by 20% and the
// extraction restarts. Identical float64 circumradius math and scan order
// as the Python paths (parity-tested).
//
// out_idx: caller-allocated space for 6n int32 vertex ids. Returns the
// boundary vertex count (circle order, NOT closed), -1 on degenerate
// triangulation, -2 if 64 escalations did not converge (callers fall back).
int32_t gk_alpha_shape(const double* points, int32_t n, double alpha,
                       int32_t* out_idx) {
    Delaunator d;
    d.pts = points;
    d.n = n;
    int32_t nt = d.run();
    if (nt <= 0) return -1;
    const int32_t* tris = d.tri.data();

    std::vector<double> circum_r((size_t)nt);
    for (int32_t t = 0; t < nt; ++t) {
        int32_t i0 = tris[3 * t], i1 = tris[3 * t + 1], i2 = tris[3 * t + 2];
        double x0 = points[2 * i0], y0 = points[2 * i0 + 1];
        double x1 = points[2 * i1], y1 = points[2 * i1 + 1];
        double x2 = points[2 * i2], y2 = points[2 * i2 + 1];
        double a = std::sqrt((x0 - x1) * (x0 - x1) + (y0 - y1) * (y0 - y1));
        double b = std::sqrt((x1 - x2) * (x1 - x2) + (y1 - y2) * (y1 - y2));
        double c = std::sqrt((x2 - x0) * (x2 - x0) + (y2 - y0) * (y2 - y0));
        double sp = (a + b + c) / 2.0;
        double area = std::sqrt(std::max(
            sp * (sp - a) * (sp - b) * (sp - c), 0.0));
        circum_r[t] = a * b * c / (4.0 * (area + 1e-8));
    }

    std::unordered_map<int64_t, int32_t> first;   // canon key -> order slot
    std::vector<std::pair<int32_t, int32_t>> first_dir;
    std::vector<int32_t> count;
    first.reserve((size_t)nt * 3);

    for (int esc = 0; esc < 64; ++esc) {
        first.clear();
        first_dir.clear();
        count.clear();
        for (int32_t t = 0; t < nt; ++t) {
            if (!(circum_r[t] < alpha)) continue;
            int32_t v[4] = {tris[3 * t], tris[3 * t + 1], tris[3 * t + 2],
                            tris[3 * t]};
            for (int e = 0; e < 3; ++e) {
                int32_t u = v[e], w2 = v[e + 1];
                int64_t key = (u < w2) ? (int64_t)u * n + w2
                                       : (int64_t)w2 * n + u;
                auto it = first.find(key);
                if (it == first.end()) {
                    first.emplace(key, (int32_t)first_dir.size());
                    first_dir.emplace_back(u, w2);
                    count.push_back(1);
                } else {
                    count[(size_t)it->second] += 1;
                }
            }
        }
        std::vector<std::pair<int32_t, int32_t>> edges;
        for (size_t i = 0; i < first_dir.size(); ++i)
            if (count[i] == 1) edges.push_back(first_dir[i]);

        bool bad = edges.empty();
        if (!bad) {
            // adjacency in edge scan order; every vertex must end at
            // degree exactly 2 (same escalation triggers as
            // util.py _order_boundary)
            std::unordered_map<int32_t, std::pair<int32_t, int32_t>> adj;
            std::unordered_map<int32_t, int32_t> deg;
            adj.reserve(edges.size() * 2);
            deg.reserve(edges.size() * 2);
            for (auto& e : edges) {
                int32_t d1 = deg[e.first]++;
                int32_t d2 = deg[e.second]++;
                if (d1 >= 2 || d2 >= 2) { bad = true; break; }
                (d1 == 0 ? adj[e.first].first : adj[e.first].second) = e.second;
                (d2 == 0 ? adj[e.second].first : adj[e.second].second) = e.first;
            }
            if (!bad)
                for (auto& kv : deg)
                    if (kv.second != 2) { bad = true; break; }
            if (!bad) {
                int32_t start = edges[0].first;
                int32_t prev = -1, cur = start;
                size_t m = 0;
                out_idx[m++] = start;
                for (;;) {
                    auto& a2 = adj[cur];
                    int32_t nxt = (a2.first != prev) ? a2.first : a2.second;
                    if (nxt == start) break;
                    out_idx[m++] = nxt;
                    prev = cur;
                    cur = nxt;
                    if (m > edges.size()) { bad = true; break; }
                }
                if (!bad && m == edges.size()) return (int32_t)m;
                bad = true;
            }
        }
        alpha += alpha * 0.2;
    }
    return -2;
}

// normalization utility: out buffers sized by the caller via
// gk_norm_poly_sizes
void gk_norm_poly_dists(const double* coords, const int32_t* offsets,
                        int32_t n_polys, int32_t des_dist,
                        double* out_coords, int32_t* out_offsets) {
    int32_t pos = 0;
    out_offsets[0] = 0;
    std::vector<Poly> raw = unpack(coords, offsets, n_polys);
    for (int32_t i = 0; i < n_polys; ++i) {
        Poly np = norm_poly(raw[i], des_dist);
        for (size_t j = 0; j < np.x.size(); ++j) {
            out_coords[2 * pos] = np.x[j];
            out_coords[2 * pos + 1] = np.y[j];
            ++pos;
        }
        out_offsets[i + 1] = pos;
    }
}

int32_t gk_norm_poly_sizes(const double* coords, const int32_t* offsets,
                           int32_t n_polys, int32_t des_dist) {
    int32_t total = 0;
    std::vector<Poly> raw = unpack(coords, offsets, n_polys);
    for (int32_t i = 0; i < n_polys; ++i)
        total += (int32_t)norm_poly(raw[i], des_dist).x.size();
    return total;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused baseline-clustering feature pass.
//
// Everything DBSCANBaselines.__init__ derives from the raw baseline
// polygons in ONE call (stages/baseline_clustering.py:78-111, reference
// dbscan_baselines.py:113-177): (1) normalize + interline distances,
// (2) rescale so the average positive interline distance hits
// ``target_avg`` (float->int TRUNCATION as in get_list_of_scaled_polygons),
// (3) re-normalize + re-measure, (4) emit the final distances plus the
// normed bounding boxes (x, y, w, h; w/h in the max-min+1 convention of
// polygon.calculate_bounds) that the vectorized neighborhood rule consumes.
// The positive average is accumulated left-to-right in f64, matching
// Python's sum() on the same values bit-for-bit.

extern "C" {

void gk_cluster_features(const double* coords, const int32_t* offsets,
                         int32_t n, int32_t des_dist, double max_d,
                         double target_avg,
                         double* out_d /* n */, double* out_bb /* n*4 */) {
    std::vector<Poly> raw = unpack(coords, offsets, n);
    std::vector<Poly> normed(n);
    for (int32_t i = 0; i < n; ++i) normed[i] = norm_poly(raw[i], des_dist);
    std::vector<double> d = min_perp_dists(normed, des_dist, max_d);

    double sum = 0.0;
    int64_t cnt = 0;
    for (double v : d)
        if (v > 0) { sum += v; ++cnt; }

    if (target_avg > 0 && cnt > 0) {
        const double fac = target_avg / (sum / (double)cnt);
        for (int32_t i = 0; i < n; ++i) {
            Poly& p = raw[i];
            for (size_t j = 0; j < p.x.size(); ++j) {
                p.x[j] = std::trunc(fac * p.x[j]);
                p.y[j] = std::trunc(fac * p.y[j]);
            }
            normed[i] = norm_poly(p, des_dist);
        }
        d = min_perp_dists(normed, des_dist, max_d);
    }
    std::memcpy(out_d, d.data(), n * sizeof(double));
    for (int32_t i = 0; i < n; ++i) {
        const Poly& p = normed[i];
        out_bb[4 * i + 0] = p.bb_x0;
        out_bb[4 * i + 1] = p.bb_y0;
        out_bb[4 * i + 2] = p.bb_x1 - p.bb_x0;
        out_bb[4 * i + 3] = p.bb_y1 - p.bb_y0;
    }
}

}  // extern "C"
