// Host image writer of the port: what the ground-truth generators need to
// write the same images as PIL 12.1, bit for bit.
//
// - Drawing on an 8-bit grey canvas, after Pillow's libImaging/Draw.c and
//   _imaging.c: ImageDraw.polygon(xy, fill=ink) (vertices truncated to int,
//   then the scan-line fill of polygon_generic with its corner rules,
//   horizontal edges drawn as spans) and ImageDraw.line(xy, fill=ink,
//   width=w) for w > 1 (vertices truncated to int, every segment a wide-line
//   quad of ImagingDrawWideLine, no joints; a zero-length segment one pixel),
//   width 1 (line8's Bresenham per segment, then the last point),
//   ImageDraw.ellipse (ellipseNew: quarter arcs on a doubled grid joined into
//   horizontal spans, filled or width pixels wide) and ImageDraw.rectangle
//   (ImagingDrawRectangle, filled or width pixels wide); the float
//   coordinates are truncated to int, as _imaging.c does.
// - ImagingResample's reducing or enlarging bilinear resize of an 8-bit
//   grey image (Resample.c): the triangle filter's support scaled by the
//   reduction, coefficients normalised then rounded to 22-bit fixed point,
//   the horizontal pass before the vertical one over the rows it needs.
// - A baseline JPEG of an 8-bit grey image as libjpeg-turbo 3.1 writes it
//   after jpeg_set_defaults (quality 75, the islow forward DCT of
//   jfdctint.c, the reciprocal quantisation of jcdctmgr.c with 16-bit
//   DCT elements, the standard Huffman tables of jcstdhuff.c, no
//   optimisation, no restart markers) behind a JFIF APP0 of version 1.01,
//   density 1:1 with unit 0: the bytes PIL writes for
//   Image.fromarray(grey).save(path) to a .jpg.
//
// Floating-point expressions are written as in Pillow and the library is
// built with -ffp-contract=off, so no multiply-add is fused where Pillow's
// generic x86-64 build does not fuse one. The code keeps no state between
// calls and writes only into the caller's buffers.
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

// ------------------------------------------------------------- drawing

// Pillow's rounding macros (libImaging/ImDraw.h)
#define ROUND_UP(f) ((int)((f) >= 0.0 ? floor((f) + 0.5F) : -floor(fabs(f) + 0.5F)))
#define ROUND_DOWN(f) ((int)((f) >= 0.0 ? ceil((f) - 0.5F) : -ceil(fabs(f) - 0.5F)))
// the same on a float, with C's promotions: fabs() takes a double
#define ROUND_UP_F(f) \
    ((int)((f) >= 0.0 ? floor((double)((f) + 0.5F)) : -floor(fabs((double)(f)) + 0.5)))
#define ROUND_DOWN_F(f) \
    ((int)((f) >= 0.0 ? ceil((double)((f) - 0.5F)) : -ceil(fabs((double)(f)) - 0.5)))

struct Canvas {
    uint8_t* px;
    int xsize, ysize;
};

struct Edge {
    int d;
    int x0, y0;
    int xmin, ymin, xmax, ymax;
    float dx;
};

inline void hline8(const Canvas& im, int x0, int y0, int x1, int ink) {
    if (y0 >= 0 && y0 < im.ysize) {
        if (x0 < 0) {
            x0 = 0;
        } else if (x0 >= im.xsize) {
            return;
        }
        if (x1 < 0) {
            return;
        } else if (x1 >= im.xsize) {
            x1 = im.xsize - 1;
        }
        if (x0 <= x1) std::memset(im.px + (size_t)y0 * im.xsize + x0, ink, x1 - x0 + 1);
    }
}

inline void point8(const Canvas& im, int x, int y, int ink) {
    if (x >= 0 && x < im.xsize && y >= 0 && y < im.ysize)
        im.px[(size_t)y * im.xsize + x] = (uint8_t)ink;
}

inline void add_edge(Edge* e, int x0, int y0, int x1, int y1) {
    if (x0 <= x1) {
        e->xmin = x0, e->xmax = x1;
    } else {
        e->xmin = x1, e->xmax = x0;
    }
    if (y0 <= y1) {
        e->ymin = y0, e->ymax = y1;
    } else {
        e->ymin = y1, e->ymax = y0;
    }
    if (y0 == y1) {
        e->d = 0;
        e->dx = 0.0;
    } else {
        e->dx = ((float)(x1 - x0)) / (y1 - y0);
        e->d = (y0 == e->ymin) ? 1 : -1;
    }
    e->x0 = x0;
    e->y0 = y0;
}

int x_cmp(const void* x0, const void* x1) {
    float diff = *((const float*)x1) - *((const float*)x0);
    if (diff < 0) return 1;
    if (diff > 0) return -1;
    return 0;
}

// polygon_generic of Draw.c for an opaque ink on a grey canvas
void polygon_fill(const Canvas& im, int n, Edge* e, int ink) {
    if (n <= 0) return;
    std::vector<Edge*> edge_table(n);
    int edge_count = 0;
    int ymin = im.ysize - 1;
    int ymax = 0;
    int i, j, k;
    float adjacent_line_x, adjacent_line_x_other_edge;

    for (i = 0; i < n; i++) {
        if (ymin > e[i].ymin) ymin = e[i].ymin;
        if (ymax < e[i].ymax) ymax = e[i].ymax;
        if (e[i].ymin == e[i].ymax) {
            hline8(im, e[i].xmin, e[i].ymin, e[i].xmax, ink);
            continue;
        }
        edge_table[edge_count++] = e + i;
    }
    if (ymin < 0) ymin = 0;
    if (ymax > im.ysize) ymax = im.ysize;

    std::vector<float> xx(edge_count * 2 + 1);
    for (; ymin <= ymax; ymin++) {
        j = 0;
        for (i = 0; i < edge_count; i++) {
            Edge* current = edge_table[i];
            if (ymin >= current->ymin && ymin <= current->ymax) {
                xx[j++] = (ymin - current->y0) * current->dx + current->x0;
                if (ymin == current->ymax && ymin < ymax) {
                    // needed to draw consistent polygons
                    xx[j] = xx[j - 1];
                    j++;
                } else if ((ymin == current->ymin || ymin == current->ymax) &&
                           current->dx != 0) {
                    // connect discontiguous corners: another edge that ends
                    // or starts on this row at the same rounded x, and runs
                    // on into the adjacent row
                    for (k = 0; k < i; k++) {
                        Edge* other_edge = edge_table[k];
                        if ((ymin != other_edge->ymin && ymin != other_edge->ymax) ||
                            other_edge->dx == 0) {
                            continue;
                        }
                        if (roundf(xx[j - 1]) !=
                            roundf((ymin - other_edge->y0) * other_edge->dx + other_edge->x0)) {
                            continue;
                        }
                        // the next row, or the previous one where the
                        // current edge ends here
                        int adjacent = ymin + (ymin == current->ymax ? -1 : 1);
                        if (adjacent < other_edge->ymin || adjacent > other_edge->ymax) continue;
                        adjacent_line_x = (adjacent - current->y0) * current->dx + current->x0;
                        adjacent_line_x_other_edge =
                            (adjacent - other_edge->y0) * other_edge->dx + other_edge->x0;
                        if (xx[j - 1] > adjacent_line_x + 1 &&
                            xx[j - 1] > adjacent_line_x_other_edge + 1) {
                            xx[j - 1] = roundf(fmax((double)adjacent_line_x,
                                                    (double)adjacent_line_x_other_edge)) + 1;
                        } else if (xx[j - 1] < adjacent_line_x - 1 &&
                                   xx[j - 1] < adjacent_line_x_other_edge - 1) {
                            xx[j - 1] = roundf(fmin((double)adjacent_line_x,
                                                    (double)adjacent_line_x_other_edge)) - 1;
                        }
                        break;
                    }
                }
            }
        }
        qsort(xx.data(), j, sizeof(float), x_cmp);
        for (i = 1; i < j; i += 2) {
            int x_start = ROUND_UP_F(xx[i - 1]);
            int x_end = ROUND_DOWN_F(xx[i]);
            if (x_end < x_start) continue;
            hline8(im, x_start, ymin, x_end, ink);
        }
    }
}

// ImagingDrawPolygon(fill=1) on vertices already truncated to int
void draw_polygon(const Canvas& im, int count, const int* xy, int ink) {
    if (count <= 0) return;
    std::vector<Edge> e(count);
    int i, n;
    for (i = n = 0; i < count - 1; i++) {
        int x0 = xy[i * 2], y0 = xy[i * 2 + 1];
        int x1 = xy[i * 2 + 2], y1 = xy[i * 2 + 3];
        if (y0 == y1 && i != 0 && y0 == xy[i * 2 - 1]) {
            // a horizontal line right after another horizontal line
            Edge* last_e = &e[n - 1];
            if (x1 > x0 && x0 > xy[i * 2 - 2]) {
                last_e->xmax = x1;
                continue;
            } else if (x1 < x0 && x0 < xy[i * 2 - 2]) {
                last_e->xmin = x1;
                continue;
            }
        }
        add_edge(&e[n++], x0, y0, x1, y1);
    }
    if (xy[i * 2] != xy[0] || xy[i * 2 + 1] != xy[1])
        add_edge(&e[n++], xy[i * 2], xy[i * 2 + 1], xy[0], xy[1]);
    polygon_fill(im, n, e.data(), ink);
}

// ImagingDrawWideLine
void draw_wide_line(const Canvas& im, int x0, int y0, int x1, int y1, int ink, int width) {
    int dx = x1 - x0;
    int dy = y1 - y0;
    if (dx == 0 && dy == 0) {
        point8(im, x0, y0, ink);
        return;
    }
    double big_hypotenuse = hypot(dx, dy);
    double small_hypotenuse = (width - 1) / 2.0;
    double ratio_max = ROUND_UP(small_hypotenuse) / big_hypotenuse;
    double ratio_min = ROUND_DOWN(small_hypotenuse) / big_hypotenuse;
    int dxmin = ROUND_DOWN(ratio_min * dy);
    int dxmax = ROUND_DOWN(ratio_max * dy);
    int dymin = ROUND_DOWN(ratio_min * dx);
    int dymax = ROUND_DOWN(ratio_max * dx);
    int vertices[4][2] = {{x0 - dxmin, y0 + dymax},
                          {x1 - dxmin, y1 + dymax},
                          {x1 + dxmax, y1 - dymin},
                          {x0 + dxmax, y0 - dymin}};
    Edge e[4];
    for (int q = 0; q < 4; ++q)
        add_edge(e + q, vertices[q][0], vertices[q][1], vertices[(q + 1) % 4][0],
                 vertices[(q + 1) % 4][1]);
    polygon_fill(im, 4, e, ink);
}

// line8 of Draw.c: Bresenham, the end point not drawn
void line8(const Canvas& im, int x0, int y0, int x1, int y1, int ink) {
    int i, n, e;
    int dx, dy;
    int xs, ys;
    dx = x1 - x0;
    if (dx < 0) {
        dx = -dx, xs = -1;
    } else {
        xs = 1;
    }
    dy = y1 - y0;
    if (dy < 0) {
        dy = -dy, ys = -1;
    } else {
        ys = 1;
    }
    if (dx == 0) {
        for (i = 0; i < dy; i++) {
            point8(im, x0, y0, ink);
            y0 += ys;
        }
    } else if (dy == 0) {
        for (i = 0; i < dx; i++) {
            point8(im, x0, y0, ink);
            x0 += xs;
        }
    } else if (dx > dy) {
        n = dx;
        dy += dy;
        e = dy - dx;
        dx += dx;
        for (i = 0; i < n; i++) {
            point8(im, x0, y0, ink);
            if (e >= 0) {
                y0 += ys;
                e -= dx;
            }
            e += dy;
            x0 += xs;
        }
    } else {
        n = dy;
        dx += dx;
        e = dx - dy;
        dy += dy;
        for (i = 0; i < n; i++) {
            point8(im, x0, y0, ink);
            if (e >= 0) {
                x0 += xs;
                e -= dy;
            }
            e += dx;
            y0 += ys;
        }
    }
}

// ImagingDrawRectangle
void draw_rectangle(const Canvas& im, int x0, int y0, int x1, int y1, int ink, int fill,
                    int width) {
    if (y0 > y1) {
        int tmp = y0;
        y0 = y1;
        y1 = tmp;
    }
    if (fill) {
        if (y0 < 0) {
            y0 = 0;
        } else if (y0 >= im.ysize) {
            return;
        }
        if (y1 < 0) {
            return;
        } else if (y1 > im.ysize) {
            y1 = im.ysize;
        }
        for (int y = y0; y <= y1; y++) hline8(im, x0, y, x1, ink);
    } else {
        if (width == 0) width = 1;
        for (int i = 0; i < width; i++) {
            hline8(im, x0, y0 + i, x1, ink);
            hline8(im, x0, y1 - i, x1, ink);
            line8(im, x1 - i, y0 + width, x1 - i, y1 - width + 1, ink);
            line8(im, x0 + i, y0 + width, x0 + i, y1 - width + 1, ink);
        }
    }
}

// ellipseNew of Draw.c: a quarter of an ellipse of thickness 1 on a grid of
// doubled coordinates (0 is the centre), stepped by Bresenham on the
// ellipse equation's deviation ...
struct QuarterState {
    int32_t a, b, cx, cy, ex, ey;
    int64_t a2, b2, a2b2;
    int8_t finished;
};

void quarter_init(QuarterState* s, int32_t a, int32_t b) {
    if (a < 0 || b < 0) {
        s->finished = 1;
    } else {
        s->a = a;
        s->b = b;
        s->cx = a;
        s->cy = b % 2;
        s->ex = a % 2;
        s->ey = b;
        s->a2 = a * a;
        s->b2 = b * b;
        s->a2b2 = s->a2 * s->b2;
        s->finished = 0;
    }
}

int64_t quarter_delta(const QuarterState* s, int64_t x, int64_t y) {
    return llabs(s->a2 * y * y + s->b2 * x * x - s->a2b2);
}

int8_t quarter_next(QuarterState* s, int32_t* ret_x, int32_t* ret_y) {
    if (s->finished) return -1;
    *ret_x = s->cx;
    *ret_y = s->cy;
    if (s->cx == s->ex && s->cy == s->ey) {
        s->finished = 1;
    } else {
        int32_t nx = s->cx;
        int32_t ny = s->cy + 2;
        int64_t ndelta = quarter_delta(s, nx, ny);
        if (nx > 1) {
            int64_t newdelta = quarter_delta(s, s->cx - 2, s->cy + 2);
            if (ndelta > newdelta) {
                nx = s->cx - 2;
                ny = s->cy + 2;
                ndelta = newdelta;
            }
            newdelta = quarter_delta(s, s->cx - 2, s->cy);
            if (ndelta > newdelta) {
                nx = s->cx - 2;
                ny = s->cy;
            }
        }
        s->cx = nx;
        s->cy = ny;
    }
    return 0;
}

// ... and two such quarters (the outer ellipse and the one width pixels
// inside it) joined into the horizontal spans of all four quadrants
struct EllipseState {
    QuarterState st_o, st_i;
    int32_t py, pl, pr;
    int32_t cy[4], cl[4], cr[4];
    int8_t bufcnt;
    int8_t finished;
    int8_t leftmost;
};

void ellipse_init(EllipseState* s, int32_t a, int32_t b, int32_t w) {
    s->bufcnt = 0;
    s->leftmost = a % 2;
    quarter_init(&s->st_o, a, b);
    if (w < 1 || quarter_next(&s->st_o, &s->pr, &s->py) == -1) {
        s->finished = 1;
    } else {
        s->finished = 0;
        quarter_init(&s->st_i, a - 2 * (w - 1), b - 2 * (w - 1));
        s->pl = s->leftmost;
    }
}

int8_t ellipse_next(EllipseState* s, int32_t* ret_x0, int32_t* ret_y, int32_t* ret_x1) {
    if (s->bufcnt == 0) {
        if (s->finished) return -1;
        int32_t y = s->py;
        int32_t l = s->pl;
        int32_t r = s->pr;
        int32_t cx = 0, cy = 0;
        int8_t next_ret;
        while ((next_ret = quarter_next(&s->st_o, &cx, &cy)) != -1 && cy <= y) {
        }
        if (next_ret == -1) {
            s->finished = 1;
        } else {
            s->pr = cx;
            s->py = cy;
        }
        next_ret = quarter_next(&s->st_i, &cx, &cy);
        while (next_ret != -1 && cy <= y) {
            l = cx;
            next_ret = quarter_next(&s->st_i, &cx, &cy);
        }
        s->pl = next_ret == -1 ? s->leftmost : cx;
        if ((l > 0 || l < r) && y > 0) {
            s->cl[s->bufcnt] = l == 0 ? 2 : l;
            s->cy[s->bufcnt] = y;
            s->cr[s->bufcnt] = r;
            ++s->bufcnt;
        }
        if (y > 0) {
            s->cl[s->bufcnt] = -r;
            s->cy[s->bufcnt] = y;
            s->cr[s->bufcnt] = -l;
            ++s->bufcnt;
        }
        if (l > 0 || l < r) {
            s->cl[s->bufcnt] = l == 0 ? 2 : l;
            s->cy[s->bufcnt] = -y;
            s->cr[s->bufcnt] = r;
            ++s->bufcnt;
        }
        s->cl[s->bufcnt] = -r;
        s->cy[s->bufcnt] = -y;
        s->cr[s->bufcnt] = -l;
        ++s->bufcnt;
    }
    --s->bufcnt;
    *ret_x0 = s->cl[s->bufcnt];
    *ret_y = s->cy[s->bufcnt];
    *ret_x1 = s->cr[s->bufcnt];
    return 0;
}

void draw_ellipse(const Canvas& im, int x0, int y0, int x1, int y1, int ink, int fill,
                  int width) {
    int a = x1 - x0;
    int b = y1 - y0;
    if (a < 0 || b < 0) return;
    if (fill) width = a + b;
    EllipseState st;
    ellipse_init(&st, a, b, width);
    int32_t X0, Y, X1;
    while (ellipse_next(&st, &X0, &Y, &X1) != -1)
        hline8(im, x0 + (X0 + a) / 2, y0 + (Y + b) / 2, x0 + (X1 + a) / 2, ink);
}

// ------------------------------------------------------------- resample

const int kPrecisionBits = 32 - 8 - 2;

double bilinear_filter(double x) {
    if (x < 0.0) x = -x;
    if (x < 1.0) return 1.0 - x;
    return 0.0;
}

// precompute_coeffs + normalize_coeffs_8bpc of Resample.c (support 1.0)
int precompute_coeffs(int in_size, float in0, float in1, int out_size,
                      std::vector<int>& bounds, std::vector<int32_t>& kk) {
    double filterscale, scale;
    filterscale = scale = (double)(in1 - in0) / out_size;
    if (filterscale < 1.0) filterscale = 1.0;
    double support = 1.0 * filterscale;
    int ksize = (int)ceil(support) * 2 + 1;
    std::vector<double> pre((size_t)out_size * ksize);
    bounds.assign((size_t)out_size * 2, 0);
    for (int xx = 0; xx < out_size; xx++) {
        double center = in0 + (xx + 0.5) * scale;
        double ww = 0.0;
        double ss = 1.0 / filterscale;
        int xmin = (int)(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = (int)(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        xmax -= xmin;
        double* k = &pre[(size_t)xx * ksize];
        int x;
        for (x = 0; x < xmax; x++) {
            double w = bilinear_filter((x + xmin - center + 0.5) * ss);
            k[x] = w;
            ww += w;
        }
        for (x = 0; x < xmax; x++) {
            if (ww != 0.0) k[x] /= ww;
        }
        for (; x < ksize; x++) k[x] = 0;
        bounds[xx * 2 + 0] = xmin;
        bounds[xx * 2 + 1] = xmax;
    }
    kk.resize(pre.size());
    for (size_t x = 0; x < pre.size(); x++) {
        if (pre[x] < 0) {
            kk[x] = (int)(-0.5 + pre[x] * (1 << kPrecisionBits));
        } else {
            kk[x] = (int)(0.5 + pre[x] * (1 << kPrecisionBits));
        }
    }
    return ksize;
}

inline uint8_t clip8(int in) {
    if (in >= (1 << kPrecisionBits << 8)) return 255;
    if (in <= 0) return 0;
    return (uint8_t)(in >> kPrecisionBits);
}

void resample_bilinear(const uint8_t* in, int w, int h, uint8_t* out, int ow, int oh) {
    std::vector<int> bh, bv;
    std::vector<int32_t> kh, kv;
    bool need_h = ow != w;
    bool need_v = oh != h;
    int ksh = precompute_coeffs(w, 0.0f, (float)w, ow, bh, kh);
    int ksv = precompute_coeffs(h, 0.0f, (float)h, oh, bv, kv);
    int ybox_first = bv[0];
    int ybox_last = bv[oh * 2 - 2] + bv[oh * 2 - 1];

    std::vector<uint8_t> tmp;
    const uint8_t* src = in;
    int src_w = w;
    if (need_h) {
        for (int i = 0; i < oh; i++) bv[i * 2] -= ybox_first;
        int th = ybox_last - ybox_first;
        tmp.resize((size_t)ow * th);
        for (int yy = 0; yy < th; yy++) {
            const uint8_t* row = in + (size_t)(yy + ybox_first) * w;
            for (int xx = 0; xx < ow; xx++) {
                int xmin = bh[xx * 2], xmax = bh[xx * 2 + 1];
                const int32_t* k = &kh[(size_t)xx * ksh];
                int ss0 = 1 << (kPrecisionBits - 1);
                for (int x = 0; x < xmax; x++) ss0 += row[x + xmin] * k[x];
                tmp[(size_t)yy * ow + xx] = clip8(ss0);
            }
        }
        src = tmp.data();
        src_w = ow;
    }
    if (need_v) {
        for (int yy = 0; yy < oh; yy++) {
            int ymin = bv[yy * 2], ymax = bv[yy * 2 + 1];
            const int32_t* k = &kv[(size_t)yy * ksv];
            for (int xx = 0; xx < src_w; xx++) {
                int ss0 = 1 << (kPrecisionBits - 1);
                for (int y = 0; y < ymax; y++)
                    ss0 += src[(size_t)(y + ymin) * src_w + xx] * k[y];
                out[(size_t)yy * ow + xx] = clip8(ss0);
            }
        }
    } else {
        std::memcpy(out, src, (size_t)ow * oh);
    }
}

// ------------------------------------------------------------- JPEG

const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// jcparam.c std_luminance_quant_tbl, in natural order
const unsigned kLumQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};

const uint8_t kDcBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffTable {
    unsigned code[256];
    int size[256];
    // jchuff.c jpeg_make_c_derived_tbl
    HuffTable(const uint8_t* bits, const uint8_t* vals) {
        std::memset(code, 0, sizeof(code));
        std::memset(size, 0, sizeof(size));
        int huffsize[257];
        unsigned huffcode[257];
        int p = 0;
        for (int l = 1; l <= 16; l++)
            for (int i = 1; i <= (int)bits[l]; i++) huffsize[p++] = l;
        huffsize[p] = 0;
        int lastp = p;
        unsigned c = 0;
        int si = huffsize[0];
        p = 0;
        while (huffsize[p]) {
            while (huffsize[p] == si) huffcode[p++] = c++;
            c <<= 1;
            si++;
        }
        for (p = 0; p < lastp; p++) {
            code[vals[p]] = huffcode[p];
            size[vals[p]] = huffsize[p];
        }
    }
};

struct BitWriter {
    std::vector<uint8_t>& out;
    uint32_t buffer = 0;
    int bits = 0;
    explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
    void put(unsigned value, int n) {
        for (int i = n - 1; i >= 0; --i) {
            buffer = (buffer << 1) | ((value >> i) & 1u);
            if (++bits == 8) {
                out.push_back((uint8_t)buffer);
                if (buffer == 0xFF) out.push_back(0);   // byte stuffing
                buffer = 0;
                bits = 0;
            }
        }
    }
    void flush() {   // jchuff.c flush_bits: pad with 1 bits
        if (bits) put(0x7F, 8 - bits);
    }
};

// jfdctint.c jpeg_fdct_islow
void fdct_islow(int32_t* data) {
    const int CONST_BITS = 13, PASS1_BITS = 2;
    const int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                  FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                  FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;
    auto descale = [](int64_t x, int n) -> int32_t {
        return (int32_t)((x + ((int64_t)1 << (n - 1))) >> n);
    };
    for (int pass = 0; pass < 2; ++pass) {
        const int stride = pass == 0 ? 1 : 8;     // element step within a row / column
        const int step = pass == 0 ? 8 : 1;       // step between rows / columns
        for (int ctr = 0; ctr < 8; ++ctr) {
            int32_t* d = data + ctr * step;
            int64_t tmp0 = d[0] + d[7 * stride];
            int64_t tmp7 = d[0] - d[7 * stride];
            int64_t tmp1 = d[1 * stride] + d[6 * stride];
            int64_t tmp6 = d[1 * stride] - d[6 * stride];
            int64_t tmp2 = d[2 * stride] + d[5 * stride];
            int64_t tmp5 = d[2 * stride] - d[5 * stride];
            int64_t tmp3 = d[3 * stride] + d[4 * stride];
            int64_t tmp4 = d[3 * stride] - d[4 * stride];

            int64_t tmp10 = tmp0 + tmp3;
            int64_t tmp13 = tmp0 - tmp3;
            int64_t tmp11 = tmp1 + tmp2;
            int64_t tmp12 = tmp1 - tmp2;

            const int sh = pass == 0 ? CONST_BITS - PASS1_BITS : CONST_BITS + PASS1_BITS;
            if (pass == 0) {
                d[0] = (int32_t)((tmp10 + tmp11) * (1 << PASS1_BITS));
                d[4 * stride] = (int32_t)((tmp10 - tmp11) * (1 << PASS1_BITS));
            } else {
                d[0] = descale(tmp10 + tmp11, PASS1_BITS);
                d[4 * stride] = descale(tmp10 - tmp11, PASS1_BITS);
            }
            int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
            d[2 * stride] = descale(z1 + tmp13 * FIX_0_765366865, sh);
            d[6 * stride] = descale(z1 + tmp12 * -FIX_1_847759065, sh);

            z1 = tmp4 + tmp7;
            int64_t z2 = tmp5 + tmp6;
            int64_t z3 = tmp4 + tmp6;
            int64_t z4 = tmp5 + tmp7;
            int64_t z5 = (z3 + z4) * FIX_1_175875602;

            tmp4 = tmp4 * FIX_0_298631336;
            tmp5 = tmp5 * FIX_2_053119869;
            tmp6 = tmp6 * FIX_3_072711026;
            tmp7 = tmp7 * FIX_1_501321110;
            z1 = z1 * -FIX_0_899976223;
            z2 = z2 * -FIX_2_562915447;
            z3 = z3 * -FIX_1_961570560;
            z4 = z4 * -FIX_0_390180644;

            z3 += z5;
            z4 += z5;

            d[7 * stride] = descale(tmp4 + z1 + z3, sh);
            d[5 * stride] = descale(tmp5 + z2 + z4, sh);
            d[3 * stride] = descale(tmp6 + z2 + z3, sh);
            d[1 * stride] = descale(tmp7 + z1 + z4, sh);
        }
    }
}

// jcdctmgr.c compute_reciprocal for 16-bit DCT elements
struct Divisor {
    uint32_t recip, corr;
    int shift;   // total right shift of the product
};

Divisor compute_reciprocal(uint32_t divisor) {
    int b = 0;
    while ((divisor >> (b + 1)) != 0) ++b;   // flss(divisor) - 1
    int r = 16 + b;
    uint64_t fq = ((uint64_t)1 << r) / divisor;
    uint64_t fr = ((uint64_t)1 << r) % divisor;
    uint32_t c = divisor / 2;
    if (fr == 0) {
        fq >>= 1;
        r--;
    } else if (fr <= (divisor / 2U)) {
        c++;
    } else {
        fq++;
    }
    return Divisor{(uint32_t)(uint16_t)fq, (uint32_t)(uint16_t)c, r};
}

void put_marker_segment(std::vector<uint8_t>& out, uint8_t marker,
                        const std::vector<uint8_t>& body) {
    size_t len = body.size() + 2;
    out.push_back(0xFF);
    out.push_back(marker);
    out.push_back((uint8_t)(len >> 8));
    out.push_back((uint8_t)(len & 0xFF));
    out.insert(out.end(), body.begin(), body.end());
}

void put_dht(std::vector<uint8_t>& out, int index, const uint8_t* bits, const uint8_t* vals) {
    std::vector<uint8_t> body{(uint8_t)index};
    int count = 0;
    for (int l = 1; l <= 16; ++l) {
        body.push_back(bits[l]);
        count += bits[l];
    }
    body.insert(body.end(), vals, vals + count);
    put_marker_segment(out, 0xC4, body);
}

inline int nbits_of(int v) {
    int n = 0;
    while (v) {
        ++n;
        v >>= 1;
    }
    return n;
}

std::vector<uint8_t> jpeg_encode_grey(const uint8_t* img, int w, int h) {
    if (w <= 0 || h <= 0 || w > 65535 || h > 65535)
        throw std::runtime_error("JPEG dimensions must lie in 1..65535");
    // jpeg_set_quality(75) -> linear scale 50 (jcparam.c)
    const int scale = 50;
    unsigned qtbl[64];
    for (int i = 0; i < 64; ++i) {
        long temp = ((long)kLumQuant[i] * scale + 50L) / 100L;
        if (temp <= 0L) temp = 1L;
        if (temp > 255L) temp = 255L;   // force_baseline
        qtbl[i] = (unsigned)temp;
    }
    Divisor div[64];
    for (int i = 0; i < 64; ++i) div[i] = compute_reciprocal(qtbl[i] << 3);

    std::vector<uint8_t> out;
    out.reserve((size_t)w * h / 4 + 1024);
    out.push_back(0xFF);
    out.push_back(0xD8);
    put_marker_segment(out, 0xE0, {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0});
    std::vector<uint8_t> dqt{0};
    for (int i = 0; i < 64; ++i) dqt.push_back((uint8_t)qtbl[kNatural[i]]);
    put_marker_segment(out, 0xDB, dqt);
    put_marker_segment(out, 0xC0,
                       {8, (uint8_t)(h >> 8), (uint8_t)(h & 0xFF), (uint8_t)(w >> 8),
                        (uint8_t)(w & 0xFF), 1, 1, 0x11, 0});
    put_dht(out, 0x00, kDcBits, kDcVals);
    put_dht(out, 0x10, kAcBits, kAcVals);
    put_marker_segment(out, 0xDA, {1, 1, 0x00, 0, 63, 0});

    const HuffTable dc(kDcBits, kDcVals), ac(kAcBits, kAcVals);
    BitWriter bw(out);
    const int bw_blocks = (w + 7) / 8, bh_blocks = (h + 7) / 8;
    int last_dc = 0;
    int32_t block[64];
    int coef[64];
    for (int by = 0; by < bh_blocks; ++by) {
        for (int bx = 0; bx < bw_blocks; ++bx) {
            // edge samples replicate into the padding (jcsample.c
            // expand_right_edge, jcprepct.c expand_bottom_edge)
            for (int y = 0; y < 8; ++y) {
                int sy = std::min(by * 8 + y, h - 1);
                const uint8_t* row = img + (size_t)sy * w;
                for (int x = 0; x < 8; ++x) {
                    int sx = std::min(bx * 8 + x, w - 1);
                    block[y * 8 + x] = (int32_t)row[sx] - 128;
                }
            }
            fdct_islow(block);
            for (int i = 0; i < 64; ++i) {
                int32_t temp = block[i];
                const Divisor& d = div[i];
                if (temp < 0) {
                    uint32_t t = (uint32_t)(uint16_t)(-temp);
                    uint64_t product = (uint64_t)(uint16_t)(t + d.corr) * d.recip;
                    coef[i] = -(int)(int16_t)(product >> d.shift);
                } else {
                    uint32_t t = (uint32_t)(uint16_t)temp;
                    uint64_t product = (uint64_t)(uint16_t)(t + d.corr) * d.recip;
                    coef[i] = (int)(int16_t)(product >> d.shift);
                }
            }
            // jchuff.c encode_one_block
            int temp = coef[0] - last_dc;
            last_dc = coef[0];
            int temp2 = temp;
            if (temp < 0) {
                temp = -temp;
                temp2--;
            }
            int nbits = nbits_of(temp);
            bw.put(dc.code[nbits], dc.size[nbits]);
            if (nbits) bw.put((unsigned)temp2 & ((1u << nbits) - 1), nbits);
            int r = 0;
            for (int k = 1; k < 64; ++k) {
                int v = coef[kNatural[k]];
                if (v == 0) {
                    r++;
                    continue;
                }
                while (r > 15) {
                    bw.put(ac.code[0xF0], ac.size[0xF0]);
                    r -= 16;
                }
                temp = temp2 = v;
                if (temp < 0) {
                    temp = -temp;
                    temp2--;
                }
                nbits = nbits_of(temp);
                int i = (r << 4) + nbits;
                bw.put(ac.code[i], ac.size[i]);
                bw.put((unsigned)temp2 & ((1u << nbits) - 1), nbits);
                r = 0;
            }
            if (r > 0) bw.put(ac.code[0], ac.size[0]);
        }
    }
    bw.flush();
    out.push_back(0xFF);
    out.push_back(0xD9);
    return out;
}

void copy_error(const char* msg, char* err, int32_t errlen) {
    if (err && errlen > 0) {
        std::strncpy(err, msg, (size_t)errlen - 1);
        err[errlen - 1] = 0;
    }
}

}  // namespace

extern "C" {

// ImageDraw.polygon(xy, fill=ink) on an 8-bit canvas of h rows of w bytes;
// xy holds n (x, y) pairs as doubles.
void citlab_draw_polygon(uint8_t* canvas, int32_t w, int32_t h, const double* xy,
                         int32_t n, int32_t ink) {
    if (n < 1) return;
    std::vector<int> ixy((size_t)n * 2);
    for (int i = 0; i < n * 2; ++i) ixy[i] = (int)xy[i];
    draw_polygon(Canvas{canvas, w, h}, n, ixy.data(), ink);
}

// ImageDraw.line(xy, fill=ink, width=width) for width > 1: one wide-line
// quad per segment of the n points.
void citlab_draw_wide_lines(uint8_t* canvas, int32_t w, int32_t h, const double* xy,
                            int32_t n, int32_t ink, int32_t width) {
    const Canvas im{canvas, w, h};
    for (int i = 0; i < n - 1; ++i) {
        const double* p = xy + 2 * i;
        draw_wide_line(im, (int)p[0], (int)p[1], (int)p[2], (int)p[3], ink, width);
    }
}

// ImageDraw.line(xy, fill=ink) (width 1): line8 per segment of the n
// points, then the last point.
void citlab_draw_lines(uint8_t* canvas, int32_t w, int32_t h, const double* xy, int32_t n,
                       int32_t ink) {
    const Canvas im{canvas, w, h};
    for (int i = 0; i < n - 1; ++i) {
        const double* p = xy + 2 * i;
        line8(im, (int)p[0], (int)p[1], (int)p[2], (int)p[3], ink);
    }
    if (n > 1) point8(im, (int)xy[2 * n - 2], (int)xy[2 * n - 1], ink);
}

// ImagingDrawEllipse / ImagingDrawRectangle of the box (x0, y0, x1, y1):
// fill != 0 fills it, else its outline width pixels wide.
void citlab_draw_ellipse(uint8_t* canvas, int32_t w, int32_t h, const double* box,
                         int32_t ink, int32_t fill, int32_t width) {
    draw_ellipse(Canvas{canvas, w, h}, (int)box[0], (int)box[1], (int)box[2], (int)box[3],
                 ink, fill, width);
}

void citlab_draw_rectangle(uint8_t* canvas, int32_t w, int32_t h, const double* box,
                           int32_t ink, int32_t fill, int32_t width) {
    draw_rectangle(Canvas{canvas, w, h}, (int)box[0], (int)box[1], (int)box[2],
                   (int)box[3], ink, fill, width);
}

// Image.resize((ow, oh), Image.BILINEAR) of an 8-bit grey image.
void citlab_resize_bilinear(const uint8_t* in, int32_t w, int32_t h, uint8_t* out,
                            int32_t ow, int32_t oh) {
    resample_bilinear(in, w, h, out, ow, oh);
}

// Baseline JPEG of an 8-bit grey image into out (capacity cap). Returns the
// byte count; -1 with a message in err on a refused image; the negated
// size needed when cap is too small.
int64_t citlab_jpeg_encode_grey(const uint8_t* img, int32_t w, int32_t h, uint8_t* out,
                                int64_t cap, char* err, int32_t errlen) {
    try {
        std::vector<uint8_t> bytes = jpeg_encode_grey(img, w, h);
        if ((int64_t)bytes.size() > cap) return -(int64_t)bytes.size();
        std::memcpy(out, bytes.data(), bytes.size());
        return (int64_t)bytes.size();
    } catch (const std::exception& e) {
        copy_error(e.what(), err, errlen);
        return -1;
    }
}

}  // extern "C"
