// Host image decoder of the port: JPEG and TIFF pages to their samples,
// equal bit for bit to what PIL 12.1 (libjpeg-turbo 3.1, libtiff 4.7)
// gives for Image.open(path) in the file's own mode.
//
// JPEG: baseline and extended sequential or progressive Huffman, 8 bits,
// 1 or 3 components, restart markers, non-interleaved scans, any integral
// sampling factors. The pixel path follows libjpeg-turbo's C code:
// jidctint.c jpeg_idct_islow (JDCT_ISLOW, the default), jdsample.c
// (h2v1 / h2v2 / h1v2 fancy upsampling where the component is wider than 2
// samples, box upsampling otherwise), jdcolor.c ycc_rgb_convert, and
// jdapimin.c default_decompress_parms for the colour space.
//
// TIFF: the first IFD of a classic or BigTIFF file, little- or big-endian,
// strips or tiles, PlanarConfiguration 1 or 2, FillOrder 1 or 2 (libtiff
// reverses the bits of every strip byte); no compression, PackBits, LZW,
// Deflate (inflated by the caller's function), CCITT modified Huffman,
// Group 3 (1-D and 2-D rows after EOLs, as tif_fax3.c syncs them) and
// Group 4, and JPEG (one stream per strip or tile after the JPEGTables
// stream; YCbCr converted to RGB as libjpeg does when libtiff asks for
// JPEGCOLORMODE_RGB); old-style JPEG from its JPEGInterchangeFormat stream and
// YCbCr under the other codecs as libtiff's RGBA interface gives them (the
// chroma of each sampling unit on its pixels, tif_color.c's conversion);
// the horizontal predictor on 8-, 16- and 32-bit samples
// and the floating-point predictor (tif_predict.c fpAcc); 1-, 2-, 4-, 8-,
// 16- and 32-bit samples. The samples come out as stored (native byte
// order; a palette expanded to RGB): which layouts PIL opens, and how it
// reads them, is decided by the caller.
//
// Every variant outside that raises by name (the message says which). The
// code keeps no state between calls and writes only into the caller's
// buffers, so concurrent calls from threads are safe.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct DecodeError : std::runtime_error {
    using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw DecodeError(msg); }

// returns the number of bytes written to dst, or -1
typedef int64_t (*inflate_fn)(const uint8_t* src, int64_t n, uint8_t* dst,
                              int64_t dst_n);

// ------------------------------------------------------------------ JPEG

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
    bool present = false;
    uint8_t vals[256] = {0};
    int32_t maxcode[18] = {0};
    int32_t valoffset[18] = {0};
    uint16_t fast[512] = {0};    // (length << 8) | value for codes of <= 9 bits

    void build(const uint8_t* bits, const uint8_t* values, int nvals) {
        std::memcpy(vals, values, nvals);
        int huffsize[257], huffcode[257];
        int p = 0;
        for (int l = 1; l <= 16; ++l)
            for (int i = 0; i < bits[l]; ++i) huffsize[p++] = l;
        huffsize[p] = 0;
        int code = 0, si = huffsize[0];
        p = 0;
        while (huffsize[p]) {
            while (huffsize[p] == si) huffcode[p++] = code++;
            if (code >= (1 << si)) fail("JPEG: bad Huffman table");
            code <<= 1;
            ++si;
        }
        p = 0;
        for (int l = 1; l <= 16; ++l) {
            if (bits[l]) {
                valoffset[l] = p - huffcode[p];
                p += bits[l];
                maxcode[l] = huffcode[p - 1];
            } else {
                maxcode[l] = -1;
            }
        }
        maxcode[17] = 0x7FFFFFFF;
        std::memset(fast, 0, sizeof(fast));
        p = 0;
        for (int l = 1; l <= 9; ++l)
            for (int i = 0; i < bits[l]; ++i, ++p) {
                int lookbits = huffcode[p] << (9 - l);
                for (int c = 0; c < (1 << (9 - l)); ++c)
                    fast[lookbits + c] = (uint16_t)((l << 8) | vals[p]);
            }
        present = true;
    }
};

// entropy-coded segment reader: removes stuffed zeros and feeds zeros once
// a marker is reached (libjpeg's fill_bit_buffer)
struct BitReader {
    const uint8_t* d;
    size_t n, pos;
    uint64_t buf = 0;
    int cnt = 0;
    bool marker = false;
    bool past_end = false;

    BitReader(const uint8_t* data, size_t size, size_t start)
        : d(data), n(size), pos(start) {}

    void fill() {
        while (cnt <= 56) {
            uint32_t b = 0;
            if (!marker) {
                if (pos >= n) {
                    past_end = true;
                    marker = true;
                } else if (d[pos] == 0xFF) {
                    uint8_t nx = pos + 1 < n ? d[pos + 1] : 0xD9;
                    if (nx == 0) {
                        b = 0xFF;
                        pos += 2;
                    } else {
                        marker = true;
                    }
                } else {
                    b = d[pos++];
                }
            }
            buf |= (uint64_t)b << (56 - cnt);
            cnt += 8;
        }
    }
    int peek(int k) {
        if (cnt < k) fill();
        return (int)(buf >> (64 - k));
    }
    void skip(int k) {
        buf <<= k;
        cnt -= k;
    }
    int bits(int k) {
        if (k == 0) return 0;
        int v = peek(k);
        skip(k);
        return v;
    }
    int bit() { return bits(1); }
    int decode(const Huffman& h) {
        int look = peek(9);
        uint16_t f = h.fast[look];
        if (f) {
            skip(f >> 8);
            return f & 0xFF;
        }
        int code = peek(16);
        int l = 10;
        while (l <= 16 && (code >> (16 - l)) > h.maxcode[l]) ++l;
        if (l > 16) fail("JPEG: corrupt Huffman code");
        skip(l);
        return h.vals[(code >> (16 - l)) + h.valoffset[l]];
    }
};

inline int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int bw = 0, bh = 0;      // blocks per line / column, padded to whole MCUs
    int dw = 0, dh = 0;      // downsampled width / height (real samples)
    int dc_tbl = 0, ac_tbl = 0, dc_pred = 0;
    bool quant_latched = false;
    uint16_t quant[64] = {0};
    int coef_bits[64];
    std::vector<int16_t> coef;
    std::vector<uint8_t> plane;  // bw*8 x bh*8 samples after the IDCT
};

struct Jpeg {
    const uint8_t* d;
    size_t n;
    int width = 0, height = 0, precision = 8;
    int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
    bool progressive = false, frame = false;
    bool jfif = false, adobe = false;
    int adobe_transform = -1;
    int restart_interval = 0;
    int colorspace = -1;   // 0 YCbCr, 1 as coded (no conversion), -1 from the markers
    uint16_t qt[4][64];
    bool qt_present[4] = {false, false, false, false};
    Huffman dc[4], ac[4];
    std::vector<Component> comps;

    Jpeg(const uint8_t* data, size_t size) : d(data), n(size) {}

    int u16(size_t p) const {
        if (p + 2 > n) fail("JPEG: truncated header");
        return (d[p] << 8) | d[p + 1];
    }

    // the marker at pos (skipping fill bytes and garbage); pos moves past it
    int next_marker(size_t& pos) const {
        while (pos < n) {
            if (d[pos] != 0xFF) {
                ++pos;
                continue;
            }
            while (pos < n && d[pos] == 0xFF) ++pos;
            if (pos >= n) break;
            int m = d[pos++];
            if (m != 0) return m;
        }
        fail("JPEG: truncated file (no EOI marker)");
    }

    void read_sof(size_t p, int marker) {
        if (frame) fail("JPEG: more than one frame (hierarchical JPEG)");
        frame = true;
        if (marker == 0xC3) fail("JPEG: lossless JPEG is not supported");
        if (marker >= 0xC5 && marker <= 0xC7)
            fail("JPEG: hierarchical (differential) JPEG is not supported");
        if (marker >= 0xC9)
            fail("JPEG: arithmetic-coded JPEG is not supported");
        progressive = marker == 0xC2;
        if (p + 6 > n) fail("JPEG: truncated SOF");
        precision = d[p];
        if (precision != 8)
            fail("JPEG: " + std::to_string(precision) +
                 "-bit JPEG is not supported (8-bit samples only)");
        height = u16(p + 1);
        width = u16(p + 3);
        int nc = d[p + 5];
        if (height == 0) fail("JPEG: height 0 (DNL marker) is not supported");
        if (width == 0) fail("JPEG: width 0");
        if (nc == 4) fail("JPEG: CMYK/YCCK JPEG (4 components) is not supported");
        if (nc != 1 && nc != 3)
            fail("JPEG: " + std::to_string(nc) + " components are not supported");
        if (p + 6 + 3 * (size_t)nc > n) fail("JPEG: truncated SOF");
        comps.resize(nc);
        for (int i = 0; i < nc; ++i) {
            Component& c = comps[i];
            c.id = d[p + 6 + 3 * i];
            c.h = d[p + 7 + 3 * i] >> 4;
            c.v = d[p + 7 + 3 * i] & 15;
            c.tq = d[p + 8 + 3 * i] & 3;
            if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
                fail("JPEG: bad sampling factors");
            hmax = std::max(hmax, c.h);
            vmax = std::max(vmax, c.v);
        }
        mcux = (width + 8 * hmax - 1) / (8 * hmax);
        mcuy = (height + 8 * vmax - 1) / (8 * vmax);
        for (Component& c : comps) {
            if (hmax % c.h || vmax % c.v)
                fail("JPEG: non-integral sampling factor ratio is not supported");
            c.bw = mcux * c.h;
            c.bh = mcuy * c.v;
            c.dw = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
            c.dh = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
            c.coef.assign((size_t)c.bw * c.bh * 64, 0);
            std::fill(c.coef_bits, c.coef_bits + 64, -1);
        }
    }

    void read_dqt(size_t p, size_t end) {
        while (p < end) {
            int pq = d[p] >> 4, tq = d[p] & 3;
            ++p;
            for (int i = 0; i < 64; ++i) {
                int val;
                if (pq) {
                    val = u16(p);
                    p += 2;
                } else {
                    if (p >= n) fail("JPEG: truncated DQT");
                    val = d[p++];
                }
                qt[tq][kNatural[i]] = (uint16_t)val;
            }
            qt_present[tq] = true;
        }
    }

    void read_dht(size_t p, size_t end) {
        while (p < end) {
            if (p + 17 > n) fail("JPEG: truncated DHT");
            int tc = d[p] >> 4, th = d[p] & 3;
            uint8_t bits[17];
            bits[0] = 0;
            int count = 0;
            for (int l = 1; l <= 16; ++l) {
                bits[l] = d[p + l];
                count += bits[l];
            }
            if (count > 256 || p + 17 + count > n) fail("JPEG: bad DHT");
            (tc ? ac[th] : dc[th]).build(bits, d + p + 17, count);
            p += 17 + count;
        }
    }

    void read_app(size_t p, size_t len, int marker) {
        if (marker == 0xE0 && len >= 5 && std::memcmp(d + p, "JFIF\0", 5) == 0)
            jfif = true;
        if (marker == 0xEE && len >= 12 && std::memcmp(d + p, "Adobe", 5) == 0) {
            adobe = true;
            adobe_transform = d[p + 11];
        }
    }

    // header only: dimensions and output channels
    void parse_header() {
        if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) fail("JPEG: no SOI marker");
        size_t pos = 2;
        while (true) {
            int m = next_marker(pos);
            if (m == 0xD9 || m == 0xDA) fail("JPEG: no frame header before the scan");
            if (m >= 0xD0 && m <= 0xD7) continue;
            int len = u16(pos);
            size_t body = pos + 2, end = pos + len;
            if (end > n) fail("JPEG: truncated marker segment");
            if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
                read_sof(body, m);
                return;
            }
            if (m == 0xCC) fail("JPEG: arithmetic-coded JPEG is not supported");
            pos = end;
        }
    }

    int channels() const { return (int)comps.size() == 1 ? 1 : 3; }

    bool rgb_colorspace() const {
        if (comps.size() != 3) return false;
        if (colorspace >= 0) return colorspace == 1;
        if (jfif) return false;
        if (adobe) return adobe_transform == 0;
        int c0 = comps[0].id, c1 = comps[1].id, c2 = comps[2].id;
        if (c0 == 1 && c1 == 2 && c2 == 3) return false;
        return c0 == 82 && c1 == 71 && c2 == 66;
    }

    // ---- entropy decoding into coefficient arrays
    struct Scan {
        std::vector<int> comp;
        int ss = 0, se = 63, ah = 0, al = 0;
    };

    int16_t* block(Component& c, int row, int col) {
        return &c.coef[((size_t)row * c.bw + col) * 64];
    }

    void decode_block_baseline(BitReader& br, Component& c, int16_t* blk) {
        const Huffman& hd = dc[c.dc_tbl];
        const Huffman& ha = ac[c.ac_tbl];
        int s = br.decode(hd);
        int diff = s ? extend(br.bits(s), s) : 0;
        c.dc_pred += diff;
        blk[0] = (int16_t)c.dc_pred;
        for (int k = 1; k < 64; ++k) {
            int rs = br.decode(ha);
            int r = rs >> 4;
            s = rs & 15;
            if (s) {
                k += r;
                if (k > 63) fail("JPEG: corrupt AC coefficients");
                blk[kNatural[k]] = (int16_t)extend(br.bits(s), s);
            } else {
                if (r != 15) break;
                k += 15;
            }
        }
    }

    void decode_scan(size_t& pos, const Scan& sc) {
        for (int ci : sc.comp) {
            Component& c = comps[ci];
            if (!c.quant_latched) {
                if (!qt_present[c.tq]) fail("JPEG: missing quantization table");
                std::memcpy(c.quant, qt[c.tq], sizeof(c.quant));
                c.quant_latched = true;
            }
            c.dc_pred = 0;
            bool need_dc = !progressive || (sc.ss == 0 && sc.ah == 0);
            bool need_ac = !progressive || sc.ss > 0;
            if (need_dc && !dc[c.dc_tbl].present) fail("JPEG: missing Huffman table");
            if (need_ac && !ac[c.ac_tbl].present) fail("JPEG: missing Huffman table");
        }
        if (progressive) {
            if (sc.ss == 0 && sc.se != 0) fail("JPEG: bad progressive scan");
            if (sc.ss > 0 && sc.comp.size() != 1) fail("JPEG: bad progressive scan");
            for (int ci : sc.comp) {
                Component& c = comps[ci];
                for (int k = sc.ss; k <= sc.se; ++k) c.coef_bits[k] = sc.al;
            }
        }
        BitReader br(d, n, pos);
        int eobrun = 0;
        bool single = sc.comp.size() == 1;
        int units_x, units_y;
        if (single) {
            const Component& c = comps[sc.comp[0]];
            units_x = (c.dw + 7) / 8;
            units_y = (c.dh + 7) / 8;
        } else {
            units_x = mcux;
            units_y = mcuy;
        }
        int64_t total = (int64_t)units_x * units_y;
        int64_t until_restart = restart_interval;
        for (int64_t u = 0; u < total; ++u) {
            if (restart_interval && until_restart == 0) {
                // expect RSTn at the reader's position
                size_t p = br.pos;
                int m = next_marker(p);
                if (m < 0xD0 || m > 0xD7) fail("JPEG: missing restart marker");
                br = BitReader(d, n, p);
                for (int ci : sc.comp) comps[ci].dc_pred = 0;
                eobrun = 0;
                until_restart = restart_interval;
            }
            int ux = (int)(u % units_x), uy = (int)(u / units_x);
            if (single) {
                Component& c = comps[sc.comp[0]];
                decode_unit(br, sc, c, block(c, uy, ux), eobrun);
            } else {
                for (int ci : sc.comp) {
                    Component& c = comps[ci];
                    for (int by = 0; by < c.v; ++by)
                        for (int bx = 0; bx < c.h; ++bx)
                            decode_unit(br, sc, c, block(c, uy * c.v + by, ux * c.h + bx),
                                        eobrun);
                }
            }
            if (restart_interval) --until_restart;
        }
        if (br.past_end) fail("JPEG: truncated file (entropy data runs past its end)");
        pos = br.pos;
    }

    void decode_unit(BitReader& br, const Scan& sc, Component& c, int16_t* blk,
                     int& eobrun) {
        if (!progressive) {
            decode_block_baseline(br, c, blk);
            return;
        }
        if (sc.ss == 0) {                  // DC scans
            if (sc.ah == 0) {
                int s = br.decode(dc[c.dc_tbl]);
                int diff = s ? extend(br.bits(s), s) : 0;
                c.dc_pred += diff;
                blk[0] = (int16_t)(uint16_t)((unsigned)c.dc_pred << sc.al);
            } else if (br.bit()) {
                blk[0] = (int16_t)(blk[0] | (1 << sc.al));
            }
            return;
        }
        const Huffman& ha = ac[c.ac_tbl];
        if (sc.ah == 0) {                  // AC first
            if (eobrun > 0) {
                --eobrun;
                return;
            }
            for (int k = sc.ss; k <= sc.se; ++k) {
                int rs = br.decode(ha);
                int r = rs >> 4, s = rs & 15;
                if (s) {
                    k += r;
                    if (k > 63) fail("JPEG: corrupt AC coefficients");
                    int v = extend(br.bits(s), s);
                    blk[kNatural[k]] = (int16_t)(uint16_t)((unsigned)v << sc.al);
                } else if (r == 15) {
                    k += 15;
                } else {
                    eobrun = 1 << r;
                    if (r) eobrun += br.bits(r);
                    --eobrun;
                    break;
                }
            }
            return;
        }
        // AC refinement (jdphuff.c decode_mcu_AC_refine)
        int p1 = 1 << sc.al, m1 = -1 * (1 << sc.al);
        int k = sc.ss;
        if (eobrun == 0) {
            for (; k <= sc.se; ++k) {
                int rs = br.decode(ha);
                int r = rs >> 4, s = rs & 15;
                if (s) {
                    s = br.bit() ? p1 : m1;
                } else if (r != 15) {
                    eobrun = 1 << r;
                    if (r) eobrun += br.bits(r);
                    break;
                }
                do {
                    int16_t* coef = blk + kNatural[k];
                    if (*coef != 0) {
                        if (br.bit() && (*coef & p1) == 0)
                            *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
                    } else if (--r < 0) {
                        break;
                    }
                    ++k;
                } while (k <= sc.se);
                if (s) blk[kNatural[std::min(k, 79)]] = (int16_t)s;
            }
        }
        if (eobrun > 0) {
            for (; k <= sc.se; ++k) {
                int16_t* coef = blk + kNatural[k];
                if (*coef != 0 && br.bit() && (*coef & p1) == 0)
                    *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
            }
            --eobrun;
        }
    }

    void read_sos(size_t& pos, size_t body, size_t end) {
        if (!frame) fail("JPEG: scan before the frame header");
        Scan sc;
        int ns = d[body];
        if (ns < 1 || ns > 4 || body + 1 + 2 * ns + 3 > end) fail("JPEG: bad SOS");
        for (int i = 0; i < ns; ++i) {
            int cid = d[body + 1 + 2 * i], tbl = d[body + 2 + 2 * i];
            int found = -1;
            for (size_t c = 0; c < comps.size(); ++c)
                if (comps[c].id == cid) found = (int)c;
            if (found < 0) fail("JPEG: scan names an unknown component");
            comps[found].dc_tbl = tbl >> 4 & 3;
            comps[found].ac_tbl = tbl & 3;
            sc.comp.push_back(found);
        }
        size_t q = body + 1 + 2 * ns;
        sc.ss = d[q];
        sc.se = d[q + 1];
        sc.ah = d[q + 2] >> 4;
        sc.al = d[q + 2] & 15;
        if (!progressive) {
            sc.ss = 0;
            sc.se = 63;
            sc.ah = sc.al = 0;
        } else if (sc.se > 63 || sc.ss > sc.se || sc.al > 13) {
            fail("JPEG: bad progressive scan parameters");
        }
        pos = end;
        decode_scan(pos, sc);
    }

    void decode_coefficients() {
        if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) fail("JPEG: no SOI marker");
        size_t pos = 2;
        bool scanned = false;
        while (true) {
            int m = next_marker(pos);
            if (m == 0xD9) break;
            if (m >= 0xD0 && m <= 0xD7) continue;
            if (m == 0x01) continue;
            int len = u16(pos);
            size_t body = pos + 2, end = pos + len;
            if (len < 2 || end > n) fail("JPEG: truncated marker segment");
            if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
                read_sof(body, m);
            } else if (m == 0xC4) {
                read_dht(body, end);
            } else if (m == 0xCC) {
                fail("JPEG: arithmetic-coded JPEG is not supported");
            } else if (m == 0xDB) {
                read_dqt(body, end);
            } else if (m == 0xDD) {
                restart_interval = u16(body);
            } else if (m == 0xDC) {
                fail("JPEG: DNL marker is not supported");
            } else if (m >= 0xE0 && m <= 0xEF) {
                read_app(body, len - 2, m);
            } else if (m == 0xDA) {
                read_sos(pos, body, end);
                scanned = true;
                continue;
            }
            pos = end;
        }
        if (!frame || !scanned) fail("JPEG: no image data");
        if (progressive) {
            // libjpeg smooths the blocks of a progressive image whose first
            // AC coefficients still miss low bits (jdcoefct.c
            // decompress_smooth_data); that path is not ported
            for (const Component& c : comps)
                for (int k = 0; k < 10; ++k)
                    if (c.coef_bits[k] != 0)
                        fail("JPEG: progressive JPEG with unrefined coefficients "
                             "(libjpeg block smoothing) is not supported");
        }
    }

    // ---- jidctint.c jpeg_idct_islow, 8-bit
    static inline uint8_t range_limit(int64_t v) {
        int idx = (int)(v & 1023);
        if (idx < 128) return (uint8_t)(idx + 128);
        if (idx < 512) return 255;
        if (idx < 896) return 0;
        return (uint8_t)(idx - 896);
    }

    static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                           int stride) {
        const int CONST_BITS = 13, PASS1_BITS = 2;
        const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                      F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                      F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
        auto descale = [](int64_t x, int nb) {
            return (x + ((int64_t)1 << (nb - 1))) >> nb;
        };
        int ws[64];
        for (int c = 0; c < 8; ++c) {
            const int16_t* ip = in + c;
            const uint16_t* qp = q + c;
            int* wp = ws + c;
            if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
                ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
                int dcval = (int)((int64_t)ip[0] * qp[0] * (1 << PASS1_BITS));
                for (int r = 0; r < 8; ++r) wp[8 * r] = dcval;
                continue;
            }
            int64_t z2 = (int64_t)ip[16] * qp[16], z3 = (int64_t)ip[48] * qp[48];
            int64_t z1 = (z2 + z3) * F0541;
            int64_t tmp2 = z1 + z3 * (-F1847);
            int64_t tmp3 = z1 + z2 * F0765;
            z2 = (int64_t)ip[0] * qp[0];
            z3 = (int64_t)ip[32] * qp[32];
            int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
            int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
            int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
            int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
            tmp0 = (int64_t)ip[56] * qp[56];
            tmp1 = (int64_t)ip[40] * qp[40];
            tmp2 = (int64_t)ip[24] * qp[24];
            tmp3 = (int64_t)ip[8] * qp[8];
            z1 = tmp0 + tmp3;
            z2 = tmp1 + tmp2;
            z3 = tmp0 + tmp2;
            int64_t z4 = tmp1 + tmp3;
            int64_t z5 = (z3 + z4) * F1175;
            tmp0 *= F0298;
            tmp1 *= F2053;
            tmp2 *= F3072;
            tmp3 *= F1501;
            z1 *= -F0899;
            z2 *= -F2562;
            z3 *= -F1961;
            z4 *= -F0390;
            z3 += z5;
            z4 += z5;
            tmp0 += z1 + z3;
            tmp1 += z2 + z4;
            tmp2 += z2 + z3;
            tmp3 += z1 + z4;
            const int sh = CONST_BITS - PASS1_BITS;
            wp[0] = (int)descale(tmp10 + tmp3, sh);
            wp[56] = (int)descale(tmp10 - tmp3, sh);
            wp[8] = (int)descale(tmp11 + tmp2, sh);
            wp[48] = (int)descale(tmp11 - tmp2, sh);
            wp[16] = (int)descale(tmp12 + tmp1, sh);
            wp[40] = (int)descale(tmp12 - tmp1, sh);
            wp[24] = (int)descale(tmp13 + tmp0, sh);
            wp[32] = (int)descale(tmp13 - tmp0, sh);
        }
        for (int r = 0; r < 8; ++r) {
            const int* wp = ws + 8 * r;
            uint8_t* op = out + (size_t)r * stride;
            if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 &&
                wp[6] == 0 && wp[7] == 0) {
                uint8_t v = range_limit(descale(wp[0], PASS1_BITS + 3));
                for (int c = 0; c < 8; ++c) op[c] = v;
                continue;
            }
            int64_t z2 = wp[2], z3 = wp[6];
            int64_t z1 = (z2 + z3) * F0541;
            int64_t tmp2 = z1 + z3 * (-F1847);
            int64_t tmp3 = z1 + z2 * F0765;
            int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << CONST_BITS);
            int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << CONST_BITS);
            int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
            int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
            tmp0 = wp[7];
            tmp1 = wp[5];
            tmp2 = wp[3];
            tmp3 = wp[1];
            z1 = tmp0 + tmp3;
            z2 = tmp1 + tmp2;
            z3 = tmp0 + tmp2;
            int64_t z4 = tmp1 + tmp3;
            int64_t z5 = (z3 + z4) * F1175;
            tmp0 *= F0298;
            tmp1 *= F2053;
            tmp2 *= F3072;
            tmp3 *= F1501;
            z1 *= -F0899;
            z2 *= -F2562;
            z3 *= -F1961;
            z4 *= -F0390;
            z3 += z5;
            z4 += z5;
            tmp0 += z1 + z3;
            tmp1 += z2 + z4;
            tmp2 += z2 + z3;
            tmp3 += z1 + z4;
            const int sh = CONST_BITS + PASS1_BITS + 3;
            op[0] = range_limit(descale(tmp10 + tmp3, sh));
            op[7] = range_limit(descale(tmp10 - tmp3, sh));
            op[1] = range_limit(descale(tmp11 + tmp2, sh));
            op[6] = range_limit(descale(tmp11 - tmp2, sh));
            op[2] = range_limit(descale(tmp12 + tmp1, sh));
            op[5] = range_limit(descale(tmp12 - tmp1, sh));
            op[3] = range_limit(descale(tmp13 + tmp0, sh));
            op[4] = range_limit(descale(tmp13 - tmp0, sh));
        }
    }

    void inverse_dct() {
        for (Component& c : comps) {
            int stride = c.bw * 8;
            c.plane.assign((size_t)stride * c.bh * 8, 0);
            for (int by = 0; by < c.bh; ++by)
                for (int bx = 0; bx < c.bw; ++bx)
                    idct_islow(block(c, by, bx), c.quant,
                               &c.plane[(size_t)by * 8 * stride + bx * 8], stride);
            std::vector<int16_t>().swap(c.coef);
        }
    }

    // ---- jdsample.c: one component to width x height samples
    std::vector<uint8_t> upsample(const Component& c) const {
        const int stride = c.bw * 8;
        const int W = width, H = height;
        const int he = hmax / c.h, ve = vmax / c.v;
        const uint8_t* in = c.plane.data();
        std::vector<uint8_t> out((size_t)W * H);
        if (he == 1 && ve == 1) {
            for (int y = 0; y < H; ++y)
                std::memcpy(&out[(size_t)y * W], in + (size_t)y * stride, W);
            return out;
        }
        const int dw = c.dw, dh = c.dh;
        std::vector<uint8_t> row((size_t)2 * dw + 2);
        auto put = [&](int y, const uint8_t* r) {
            if (y < H) std::memcpy(&out[(size_t)y * W], r, W);
        };
        if (he == 2 && ve == 1 && dw > 2) {         // h2v1_fancy_upsample
            for (int y = 0; y < H; ++y) {
                const uint8_t* ip = in + (size_t)y * stride;
                uint8_t* op = row.data();
                int inv = ip[0];
                *op++ = (uint8_t)inv;
                *op++ = (uint8_t)((inv * 3 + ip[1] + 2) >> 2);
                for (int x = 1; x < dw - 1; ++x) {
                    inv = ip[x] * 3;
                    *op++ = (uint8_t)((inv + ip[x - 1] + 1) >> 2);
                    *op++ = (uint8_t)((inv + ip[x + 1] + 2) >> 2);
                }
                inv = ip[dw - 1];
                *op++ = (uint8_t)((inv * 3 + ip[dw - 2] + 1) >> 2);
                *op++ = (uint8_t)inv;
                put(y, row.data());
            }
            return out;
        }
        if (he == 1 && ve == 2) {                   // h1v2_fancy_upsample
            for (int r = 0; r < dh; ++r) {
                const uint8_t* i0 = in + (size_t)r * stride;
                for (int v = 0; v < 2; ++v) {
                    int nr = v == 0 ? std::max(r - 1, 0) : std::min(r + 1, dh - 1);
                    const uint8_t* i1 = in + (size_t)nr * stride;
                    int bias = v == 0 ? 1 : 2;
                    for (int x = 0; x < dw; ++x)
                        row[x] = (uint8_t)((i0[x] * 3 + i1[x] + bias) >> 2);
                    put(2 * r + v, row.data());
                }
            }
            return out;
        }
        if (he == 2 && ve == 2 && dw > 2) {         // h2v2_fancy_upsample
            for (int r = 0; r < dh; ++r) {
                const uint8_t* i0 = in + (size_t)r * stride;
                for (int v = 0; v < 2; ++v) {
                    int nr = v == 0 ? std::max(r - 1, 0) : std::min(r + 1, dh - 1);
                    const uint8_t* i1 = in + (size_t)nr * stride;
                    uint8_t* op = row.data();
                    int thiscol = i0[0] * 3 + i1[0];
                    int nextcol = i0[1] * 3 + i1[1];
                    *op++ = (uint8_t)((thiscol * 4 + 8) >> 4);
                    *op++ = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
                    int lastcol = thiscol;
                    thiscol = nextcol;
                    for (int x = 2; x < dw; ++x) {
                        nextcol = i0[x] * 3 + i1[x];
                        *op++ = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
                        *op++ = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
                        lastcol = thiscol;
                        thiscol = nextcol;
                    }
                    *op++ = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
                    *op++ = (uint8_t)((thiscol * 4 + 7) >> 4);
                    put(2 * r + v, row.data());
                }
            }
            return out;
        }
        // box upsampling (h2v1_upsample, h2v2_upsample, int_upsample)
        for (int y = 0; y < H; ++y) {
            const uint8_t* ip = in + (size_t)(y / ve) * stride;
            uint8_t* op = &out[(size_t)y * W];
            for (int x = 0; x < W; ++x) op[x] = ip[x / he];
        }
        return out;
    }

    void to_pixels(uint8_t* dst) const {
        const size_t npix = (size_t)width * height;
        if (comps.size() == 1) {
            std::vector<uint8_t> y = upsample(comps[0]);
            std::memcpy(dst, y.data(), npix);
            return;
        }
        std::vector<uint8_t> p0 = upsample(comps[0]), p1 = upsample(comps[1]),
                             p2 = upsample(comps[2]);
        if (rgb_colorspace()) {
            for (size_t i = 0; i < npix; ++i) {
                dst[3 * i] = p0[i];
                dst[3 * i + 1] = p1[i];
                dst[3 * i + 2] = p2[i];
            }
            return;
        }
        // jdcolor.c build_ycc_rgb_table / ycc_rgb_convert
        const int SCALEBITS = 16;
        const int64_t ONE_HALF = (int64_t)1 << (SCALEBITS - 1);
        auto fix = [](double x) { return (int64_t)(x * (1L << 16) + 0.5); };
        int cr_r[256], cb_b[256];
        int64_t cr_g[256], cb_g[256];
        for (int i = 0, x = -128; i < 256; ++i, ++x) {
            cr_r[i] = (int)((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
            cb_b[i] = (int)((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
            cr_g[i] = -fix(0.71414) * x;
            cb_g[i] = -fix(0.34414) * x + ONE_HALF;
        }
        auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
        for (size_t i = 0; i < npix; ++i) {
            int y = p0[i], cb = p1[i], cr = p2[i];
            dst[3 * i] = clamp(y + cr_r[cr]);
            dst[3 * i + 1] = clamp(y + (int)((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
            dst[3 * i + 2] = clamp(y + cb_b[cb]);
        }
    }
};

// ------------------------------------------------------------------ TIFF

// CCITT run-length codes (T.4 tables 2 and 3)
struct RunTable {
    std::vector<int16_t> run;   // indexed by the next 13 bits
    std::vector<uint8_t> len;
    RunTable() : run(8192, -1), len(8192, 0) {}
    void add(const char* bits, int value) {
        int l = (int)std::strlen(bits), code = 0;
        for (int i = 0; i < l; ++i) code = (code << 1) | (bits[i] - '0');
        int lo = code << (13 - l), hi = (code + 1) << (13 - l);
        for (int i = lo; i < hi; ++i) {
            run[i] = (int16_t)value;
            len[i] = (uint8_t)l;
        }
    }
};

void fill_tables(RunTable& white, RunTable& black) {
    static const char* const kWhiteTerm[64] = {
        "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111",
        "10011", "10100", "00111", "01000", "001000", "000011", "110100", "110101",
        "101010", "101011", "0100111", "0001100", "0001000", "0010111", "0000011",
        "0000100", "0101000", "0101011", "0010011", "0100100", "0011000", "00000010",
        "00000011", "00011010", "00011011", "00010010", "00010011", "00010100",
        "00010101", "00010110", "00010111", "00101000", "00101001", "00101010",
        "00101011", "00101100", "00101101", "00000100", "00000101", "00001010",
        "00001011", "01010010", "01010011", "01010100", "01010101", "00100100",
        "00100101", "01011000", "01011001", "01011010", "01011011", "01001010",
        "01001011", "00110010", "00110011", "00110100"};
    static const char* const kWhiteMakeup[27] = {
        "11011", "10010", "010111", "0110111", "00110110", "00110111", "01100100",
        "01100101", "01101000", "01100111", "011001100", "011001101", "011010010",
        "011010011", "011010100", "011010101", "011010110", "011010111", "011011000",
        "011011001", "011011010", "011011011", "010011000", "010011001", "010011010",
        "011000", "010011011"};
    static const char* const kBlackTerm[64] = {
        "0000110111", "010", "11", "10", "011", "0011", "0010", "00011", "000101",
        "000100", "0000100", "0000101", "0000111", "00000100", "00000111",
        "000011000", "0000010111", "0000011000", "0000001000", "00001100111",
        "00001101000", "00001101100", "00000110111", "00000101000", "00000010111",
        "00000011000", "000011001010", "000011001011", "000011001100",
        "000011001101", "000001101000", "000001101001", "000001101010",
        "000001101011", "000011010010", "000011010011", "000011010100",
        "000011010101", "000011010110", "000011010111", "000001101100",
        "000001101101", "000011011010", "000011011011", "000001010100",
        "000001010101", "000001010110", "000001010111", "000001100100",
        "000001100101", "000001010010", "000001010011", "000000100100",
        "000000110111", "000000111000", "000000100111", "000000101000",
        "000001011000", "000001011001", "000000101011", "000000101100",
        "000001011010", "000001100110", "000001100111"};
    static const char* const kBlackMakeup[27] = {
        "0000001111", "000011001000", "000011001001", "000001011011", "000000110011",
        "000000110100", "000000110101", "0000001101100", "0000001101101",
        "0000001001010", "0000001001011", "0000001001100", "0000001001101",
        "0000001110010", "0000001110011", "0000001110100", "0000001110101",
        "0000001110110", "0000001110111", "0000001010010", "0000001010011",
        "0000001010100", "0000001010101", "0000001011010", "0000001011011",
        "0000001100100", "0000001100101"};
    static const char* const kExtMakeup[13] = {
        "00000001000", "00000001100", "00000001101", "000000010010", "000000010011",
        "000000010100", "000000010101", "000000010110", "000000010111",
        "000000011100", "000000011101", "000000011110", "000000011111"};
    for (int i = 0; i < 64; ++i) {
        white.add(kWhiteTerm[i], i);
        black.add(kBlackTerm[i], i);
    }
    for (int i = 0; i < 27; ++i) {
        white.add(kWhiteMakeup[i], 64 * (i + 1));
        black.add(kBlackMakeup[i], 64 * (i + 1));
    }
    for (int i = 0; i < 13; ++i) {
        white.add(kExtMakeup[i], 1792 + 64 * i);
        black.add(kExtMakeup[i], 1792 + 64 * i);
    }
}

// CCITT modified Huffman, Group 3 (T.4, 1-D and 2-D) and Group 4 (T.6)
// rows, as libtiff's tif_fax3.c decodes them: changing elements of the
// coding line, painted into rows of bits, MSB first, 1 = black.
struct Fax {
    const uint8_t* s;
    size_t nbits, bitpos = 0;
    const RunTable& white;
    const RunTable& black;
    const int W;
    std::vector<int> ref, cur;

    Fax(const uint8_t* src, size_t n, int width, const RunTable& w, const RunTable& b)
        : s(src), nbits(n * 8), white(w), black(b), W(width) {
        ref.assign({W, W, W, W});   // the imaginary all-white line above the first
    }

    int peek(int k) const {
        int v = 0;
        for (int i = 0; i < k; ++i) {
            size_t b = bitpos + i;
            int bit = b < nbits ? (s[b >> 3] >> (7 - (b & 7))) & 1 : 0;
            v = (v << 1) | bit;
        }
        return v;
    }

    int run_length(const RunTable& t) {
        int total = 0;
        while (true) {
            if (bitpos >= nbits) fail("TIFF: CCITT data ends early");
            int look = peek(13);
            int r = t.run[look];
            if (r < 0) fail("TIFF: corrupt CCITT run code");
            bitpos += t.len[look];
            total += r;
            if (r < 64) return total;
        }
    }

    // libtiff's SYNC_EOL: skip to 11 zero bits, then past the zeros and the
    // 1 that end the EOL code (fill bits before an EOL are zeros too)
    void sync_eol() {
        while (true) {
            if (bitpos + 11 > nbits) fail("TIFF: Group 3 data ends early (no EOL)");
            if (peek(11) == 0) break;
            ++bitpos;
        }
        while (true) {
            if (bitpos >= nbits) fail("TIFF: Group 3 data ends early (no EOL)");
            if (peek(1)) break;
            ++bitpos;
        }
        ++bitpos;
    }

    int bit() {
        if (bitpos >= nbits) fail("TIFF: CCITT data ends early");
        int b = peek(1);
        ++bitpos;
        return b;
    }

    void align_byte() { bitpos = (bitpos + 7) & ~(size_t)7; }

    // one row of white and black runs, starting white (EXPAND1D)
    void row_1d() {
        cur.clear();
        int a0 = 0, color = 0;
        while (a0 < W) {
            a0 += run_length(color ? black : white);
            cur.push_back(std::min(a0, W));
            color ^= 1;
        }
    }

    // one row coded against the reference line (EXPAND2D)
    void row_2d() {
        cur.clear();
        int a0 = -1, color = 0;   // 0 white, 1 black
        size_t ib = 0;
        while (a0 < W) {
            // b1: first changing element of the reference line right of
            // a0 whose colour is opposite to a0's
            while (ib > 0 && ref[ib - 1] > a0) --ib;
            while (ref[ib] <= a0 || (int)(ib & 1) != color) ++ib;
            int b1 = ref[ib], b2 = ref[ib + 1];
            if (bitpos >= nbits) fail("TIFF: CCITT data ends early");
            int look = peek(7);
            if (look >> 6 == 1) {                      // V0: 1
                bitpos += 1;
                cur.push_back(b1);
                a0 = b1;
                color ^= 1;
            } else if (look >> 4 == 3 || look >> 4 == 2) {   // VR1 011, VL1 010
                bitpos += 3;
                int a1 = (look >> 4 == 3) ? b1 + 1 : b1 - 1;
                cur.push_back(a1);
                a0 = a1;
                color ^= 1;
            } else if (look >> 4 == 1) {               // H: 001
                bitpos += 3;
                int start = a0 < 0 ? 0 : a0;
                int r1 = run_length(color ? black : white);
                int r2 = run_length(color ? white : black);
                int a1 = start + r1, a2 = a1 + r2;
                cur.push_back(a1);
                cur.push_back(a2);
                a0 = a2;
            } else if (look >> 3 == 1) {               // P: 0001
                bitpos += 4;
                a0 = b2;   // a0..b2 keeps a0's colour: no change to record
            } else if (look >> 1 == 3 || look >> 1 == 2) {   // VR2 000011, VL2 000010
                bitpos += 6;
                int a1 = (look >> 1 == 3) ? b1 + 2 : b1 - 2;
                cur.push_back(a1);
                a0 = a1;
                color ^= 1;
            } else if (look == 3 || look == 2) {       // VR3 0000011, VL3 0000010
                bitpos += 7;
                int a1 = look == 3 ? b1 + 3 : b1 - 3;
                cur.push_back(a1);
                a0 = a1;
                color ^= 1;
            } else {
                if (peek(12) == 1) fail("TIFF: CCITT data ends before the last row");
                fail("TIFF: CCITT extension or uncompressed mode is not supported");
            }
            if (!cur.empty() && cur.back() > W) cur.back() = W;
            if (a0 > W) a0 = W;
        }
    }

    // paints the coding line into `row` and makes it the reference line
    void finish_row(uint8_t* row) {
        const size_t rowbytes = (W + 7) / 8;
        std::memset(row, 0, rowbytes);
        // changes alternate white -> black -> white ...
        for (size_t i = 0; i < cur.size(); i += 2) {
            int x0 = std::min(cur[i], W);
            int x1 = i + 1 < cur.size() ? std::min(cur[i + 1], W) : W;
            for (int x = std::max(x0, 0); x < x1; ++x) row[x >> 3] |= (uint8_t)(0x80 >> (x & 7));
        }
        // the changes of a reference line strictly increase; a repeated
        // position cancels a pair
        ref.clear();
        for (int x : cur) {
            if (!ref.empty() && ref.back() >= x) {
                if (ref.back() == x) {
                    ref.pop_back();
                    continue;
                }
            }
            ref.push_back(x);
        }
        while (!ref.empty() && ref.back() >= W) ref.pop_back();
        for (int i = 0; i < 4; ++i) ref.push_back(W);
    }
};

inline uint8_t reverse_bits(uint8_t b) {
    b = (uint8_t)((b & 0xF0) >> 4 | (b & 0x0F) << 4);
    b = (uint8_t)((b & 0xCC) >> 2 | (b & 0x33) << 2);
    return (uint8_t)((b & 0xAA) >> 1 | (b & 0x55) << 1);
}

struct Tiff {
    const uint8_t* d;
    size_t n;
    bool big_endian = false, bigtiff = false;
    uint32_t width = 0, height = 0, spp = 1, bps = 1, compression = 1, photometric = 0,
             planar = 1, predictor = 1, fillorder = 1, sampleformat = 1,
             rows_per_strip = 0xFFFFFFFF, tile_w = 0, tile_h = 0, t4options = 0,
             t6options = 0;
    bool tiled = false, have_photometric = false, have_spp = false, sf_uniform = true;
    size_t n_sf = 0, jpegtables_at = 0, jpegtables_len = 0, ojpeg_at = 0, ojpeg_len = 0;
    uint32_t ycc_h = 2, ycc_v = 2;   // YCbCrSubsampling (libtiff's default)
    bool custom_ycc = false;         // YCbCrCoefficients or ReferenceBlackWhite not the default
    std::vector<uint64_t> offsets, counts;
    std::vector<uint32_t> colormap, extrasamples, bps_all;

    Tiff(const uint8_t* data, size_t size) : d(data), n(size) {}

    uint64_t rd(size_t p, int size) const {
        if (p + size > n) fail("TIFF: truncated");
        uint64_t v = 0;
        for (int i = 0; i < size; ++i)
            v |= (uint64_t)d[p + i] << (8 * (big_endian ? size - 1 - i : i));
        return v;
    }
    uint32_t rd16(size_t p) const { return (uint32_t)rd(p, 2); }
    uint32_t rd32(size_t p) const { return (uint32_t)rd(p, 4); }

    std::vector<uint64_t> values(size_t entry) const {
        uint32_t type = rd16(entry + 2);
        uint64_t count = bigtiff ? rd(entry + 4, 8) : rd32(entry + 4);
        int size = type == 3 || type == 8 ? 2 : type == 4 || type == 9 || type == 13 ? 4
                 : type == 16 || type == 17 || type == 18 ? 8
                 : (type == 1 || type == 2 || type == 6 || type == 7) ? 1 : 0;
        if (size == 8 && !bigtiff) fail("TIFF: 64-bit tag type in a classic TIFF");
        if (size == 0 || count > n) return {};
        size_t total = (size_t)size * count, inline_room = bigtiff ? 8 : 4;
        size_t at = entry + (bigtiff ? 12 : 8);
        size_t p = total <= inline_room ? at : (size_t)rd(at, bigtiff ? 8 : 4);
        if (p + total > n) fail("TIFF: tag data past the end of the file");
        std::vector<uint64_t> out(count);
        for (uint64_t i = 0; i < count; ++i) out[i] = rd(p + size * i, size);
        return out;
    }

    void parse() {
        if (n < 8) fail("TIFF: truncated header");
        if (d[0] == 'I' && d[1] == 'I') big_endian = false;
        else if (d[0] == 'M' && d[1] == 'M') big_endian = true;
        else fail("TIFF: bad byte-order mark");
        uint32_t version = rd16(2);
        size_t ifd;
        if (version == 43) {
            bigtiff = true;
            if (n < 16 || rd16(4) != 8) fail("TIFF: bad BigTIFF header");
            ifd = (size_t)rd(8, 8);
        } else if (version == 42) {
            ifd = rd32(4);
        } else {
            fail("TIFF: bad version");
        }
        const size_t entry_size = bigtiff ? 20 : 12;
        uint64_t count = bigtiff ? rd(ifd, 8) : rd16(ifd);
        const size_t first = ifd + (bigtiff ? 8 : 2);
        if (count > n / entry_size) fail("TIFF: truncated IFD");
        for (uint64_t i = 0; i < count; ++i) {
            size_t e = first + entry_size * (size_t)i;
            uint32_t tag = rd16(e);
            std::vector<uint64_t> v;
            switch (tag) {
                case 256: case 257: case 258: case 259: case 262: case 266:
                case 273: case 277: case 278: case 279: case 284: case 292: case 293:
                case 317: case 320: case 322: case 323: case 324: case 325:
                case 338: case 339: case 513: case 514: case 530:
                    v = values(e);
                    if (v.empty()) fail("TIFF: empty tag " + std::to_string(tag));
                    break;
                case 529: case 532: {
                    // RATIONALs; only libtiff's defaults are decoded
                    static const double luma[3] = {0.299, 0.587, 0.114};
                    static const double refbw[6] = {0, 255, 128, 255, 128, 255};
                    uint64_t cnt = bigtiff ? rd(e + 4, 8) : rd32(e + 4);
                    size_t want = tag == 529 ? 3 : 6;
                    if (rd16(e + 2) != 5 || cnt != want) {
                        custom_ycc = true;
                        continue;
                    }
                    size_t p = (size_t)rd(e + (bigtiff ? 12 : 8), bigtiff ? 8 : 4);
                    for (size_t k = 0; k < want; ++k) {
                        double num = rd32(p + 8 * k), den = rd32(p + 8 * k + 4);
                        double value = den ? num / den : 0;
                        double expect = tag == 529 ? luma[k] : refbw[k];
                        if ((float)value != (float)expect) custom_ycc = true;
                    }
                    continue;
                }
                case 347: {
                    // JPEGTables: an abbreviated JPEG stream of the tables
                    uint64_t cnt = bigtiff ? rd(e + 4, 8) : rd32(e + 4);
                    size_t at = e + (bigtiff ? 12 : 8);
                    size_t p = cnt <= (bigtiff ? 8u : 4u) ? at : (size_t)rd(at, bigtiff ? 8 : 4);
                    if (p + cnt > n) fail("TIFF: JPEGTables past the end of the file");
                    jpegtables_at = p;
                    jpegtables_len = (size_t)cnt;
                    continue;
                }
                default:
                    continue;
            }
            auto u32 = [](uint64_t x) { return (uint32_t)std::min<uint64_t>(x, 0xFFFFFFFFu); };
            switch (tag) {
                case 256: width = u32(v[0]); break;
                case 257: height = u32(v[0]); break;
                case 258:
                    bps_all.clear();
                    for (uint64_t b : v) bps_all.push_back(u32(b));
                    bps = bps_all[0];
                    break;
                case 259: compression = u32(v[0]); break;
                case 262: photometric = u32(v[0]); have_photometric = true; break;
                case 266: fillorder = u32(v[0]); break;
                case 273: case 324: offsets = v; tiled |= tag == 324; break;
                case 277: spp = u32(v[0]); have_spp = true; break;
                case 278: rows_per_strip = u32(v[0]); break;
                case 279: case 325: counts = v; break;
                case 284: planar = u32(v[0]); break;
                case 292: t4options = u32(v[0]); break;
                case 293: t6options = u32(v[0]); break;
                case 317: predictor = u32(v[0]); break;
                case 320:
                    colormap.clear();
                    for (uint64_t c : v) colormap.push_back(u32(c));
                    break;
                case 322: tile_w = u32(v[0]); break;
                case 323: tile_h = u32(v[0]); break;
                case 513: ojpeg_at = (size_t)v[0]; break;
                case 514: ojpeg_len = (size_t)v[0]; break;
                case 530:
                    ycc_h = u32(v[0]);
                    ycc_v = v.size() > 1 ? u32(v[1]) : ycc_v;
                    break;
                case 338:
                    extrasamples.clear();
                    for (uint64_t x : v) extrasamples.push_back(u32(x));
                    break;
                case 339:
                    sampleformat = u32(v[0]);
                    n_sf = v.size();
                    for (uint64_t x : v) sf_uniform &= x == v[0];
                    break;
            }
        }
        if (!width || !height) fail("TIFF: missing image size");
        if (compression == 6) {   // PIL: old-style JPEG is YCbCr, of 3 samples by default
            photometric = 6;
            have_photometric = true;
            if (!have_spp) spp = 3;
        }
    }

    bool jpeg() const { return compression == 7; }
    // YCbCr that libtiff's RGBA interface converts (PIL reads old-style
    // JPEG and YCbCr under other codecs through it)
    bool ycc_rgba() const { return photometric == 6 && !jpeg(); }
    bool fax() const { return compression == 2 || compression == 3 || compression == 4; }
    bool predicted() const { return compression == 5 || compression == 8 || compression == 32946; }

    // what PIL's Image.open refuses of the header itself
    void check_open() const {
        if (bigtiff && big_endian) fail("TIFF: big-endian BigTIFF is not supported (PIL does not open it)");
    }

    // the codecs' limits, met when the pixels are decoded; which sample
    // layouts PIL opens, and how it reads them, is decided by the caller
    // (utils/image_native.py)
    void check_supported() const {
        check_open();
        for (uint32_t b : bps_all)
            if (b != bps) fail("TIFF: mixed bits per sample");
        if (bps != 1 && bps != 2 && bps != 4 && bps != 8 && bps != 16 && bps != 32)
            fail("TIFF: " + std::to_string(bps) + "-bit samples are not supported "
                 "(1, 2, 4, 8, 16 and 32 bits are)");
        if (planar != 1 && planar != 2)
            fail("TIFF: PlanarConfiguration " + std::to_string(planar));
        if (fillorder != 1 && fillorder != 2) fail("TIFF: FillOrder " + std::to_string(fillorder));
        switch (compression) {
            case 1: case 2: case 3: case 4: case 5: case 7: case 8: case 32946: case 32773: break;
            case 6:
                if (!ojpeg_at || !ojpeg_len)
                    fail("TIFF: old-style JPEG-in-TIFF (compression 6) without "
                         "JPEGInterchangeFormat is not supported");
                break;
            default:
                fail("TIFF: compression " + std::to_string(compression) + " is not supported");
        }
        if (fax() && (bps != 1 || spp != 1))
            fail("TIFF: CCITT compression needs 1-bit samples");
        if (compression == 3 && (t4options & 2))
            fail("TIFF: Group 3 uncompressed mode is not supported");
        if (compression == 4 && (t6options & 2))
            fail("TIFF: Group 4 uncompressed mode is not supported");
        if (jpeg()) {
            if (bps != 8) fail("TIFF: JPEG-in-TIFF with " + std::to_string(bps) + "-bit samples");
            if (planar != 1) fail("TIFF: planar (PlanarConfiguration 2) JPEG-in-TIFF is not supported");
            if (!((photometric <= 1 && spp == 1) || ((photometric == 2 || photometric == 6) && spp == 3)))
                fail("TIFF: JPEG-in-TIFF of photometric interpretation " +
                     std::to_string(photometric) + " with " + std::to_string(spp) + " samples");
        }
        if (predicted() && predictor == 2 && bps != 8 && bps != 16 && bps != 32)
            fail("TIFF: horizontal predictor on " + std::to_string(bps) + "-bit samples is not supported");
        if (predicted() && predictor == 3 && !(bps == 32 && sampleformat == 3))
            fail("TIFF: floating-point predictor on samples that are not 32-bit floats");
        if (predicted() && predictor != 1 && predictor != 2 && predictor != 3)
            fail("TIFF: predictor " + std::to_string(predictor) + " is not supported");
        switch (photometric) {
            case 0: case 1: case 2: break;
            case 3:
                if (spp != 1) fail("TIFF: palette image with several samples per pixel");
                if (bps > 8) fail("TIFF: palette image with " + std::to_string(bps) + "-bit samples");
                if (colormap.size() != 3u << bps) fail("TIFF: palette image without a full ColorMap");
                break;
            case 5: break;
            case 6:
                if (jpeg()) break;
                if (compression == 1)
                    fail("TIFF: uncompressed YCbCr TIFF is not supported (PIL does not read it)");
                if (compression != 6 && compression != 5 && compression != 8 &&
                    compression != 32946 && compression != 32773)
                    fail("TIFF: YCbCr TIFF under compression " + std::to_string(compression) +
                         " is not supported");
                if (bps != 8 || spp != 3 || planar != 1)
                    fail("TIFF: YCbCr TIFF other than 3 x 8-bit contiguous samples");
                if (custom_ycc)
                    fail("TIFF: YCbCr TIFF with its own YCbCrCoefficients or "
                         "ReferenceBlackWhite is not supported");
                // the subsamplings libtiff's RGBA interface has a reader for
                // (tif_getimage.c putcontig8bitYCbCr{44,42,41,22,21,12,11}tile)
                if (compression != 6 &&
                    (predictor != 1 ||
                     !((ycc_h == 4 && (ycc_v == 4 || ycc_v == 2 || ycc_v == 1)) ||
                       ((ycc_h == 2 || ycc_h == 1) && (ycc_v == 2 || ycc_v == 1)))))
                    fail("TIFF: YCbCr subsampling " + std::to_string(ycc_h) + "x" +
                         std::to_string(ycc_v) + " or a predictor is not supported");
                break;
            default:
                fail("TIFF: photometric interpretation " + std::to_string(photometric) +
                     " is not supported");
        }
    }

    // decoded layout: uint8 RGB for a palette or YCbCr image, else
    // spp samples per pixel of 1, 2 or 4 bytes (native byte order)
    int channels() const {
        if (photometric == 3 || photometric == 6) return 3;
        return (int)spp;
    }
    int sample_bytes() const {
        if (photometric == 3 || photometric == 6 || jpeg() || bps <= 8) return 1;
        return (int)bps / 8;
    }

    // ---- decompression of one strip or tile into exactly `want` bytes
    static void packbits(const uint8_t* s, size_t n, uint8_t* o, size_t want) {
        size_t i = 0, k = 0;
        while (i < n && k < want) {
            int c = (int8_t)s[i++];
            if (c >= 0) {
                size_t len = std::min((size_t)c + 1, std::min(n - i, want - k));
                std::memcpy(o + k, s + i, len);
                i += c + 1;
                k += len;
            } else if (c != -128) {
                if (i >= n) break;
                size_t len = std::min((size_t)(1 - c), want - k);
                std::memset(o + k, s[i++], len);
                k += len;
            }
        }
        if (k < want) fail("TIFF: PackBits data ends early");
    }

    static void lzw(const uint8_t* s, size_t n, uint8_t* o, size_t want) {
        if (n >= 2 && s[0] == 0 && (s[1] & 1)) fail("TIFF: old-style LZW is not supported");
        std::vector<int32_t> prefix(4096, -1);
        std::vector<uint8_t> suffix(4096), first(4096);
        std::vector<int32_t> length(4096, 0);
        for (int i = 0; i < 256; ++i) {
            suffix[i] = (uint8_t)i;
            first[i] = (uint8_t)i;
            length[i] = 1;
        }
        size_t bitpos = 0, k = 0;
        int width = 9, next = 258, prev = -1;
        auto read = [&]() -> int {
            if (bitpos + width > n * 8) return 257;
            int v = 0;
            for (int b = 0; b < width; ++b, ++bitpos)
                v = (v << 1) | ((s[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
            return v;
        };
        auto emit = [&](int code) {
            int len = length[code];
            size_t end = k + len;
            for (int c = code, j = len - 1; j >= 0; --j, c = prefix[c])
                if (k + j < want) o[k + j] = suffix[c];
            k = std::min(end, want);
        };
        while (k < want) {
            int code = read();
            if (code == 257) break;
            if (code == 256) {
                width = 9;
                next = 258;
                prev = -1;
                continue;
            }
            if (prev < 0) {
                if (code > 255) fail("TIFF: corrupt LZW data");
                emit(code);
                prev = code;
                continue;
            }
            if (code > next || next >= 4096) fail("TIFF: corrupt LZW data");
            int fc = code < next ? first[code] : first[prev];
            prefix[next] = prev;
            suffix[next] = (uint8_t)fc;
            first[next] = first[prev];
            length[next] = length[prev] + 1;
            ++next;
            emit(code);
            prev = code;
            if (next >= 2047) width = 12;
            else if (next >= 1023) width = 11;
            else if (next >= 511) width = 10;
        }
        if (k < want) fail("TIFF: LZW data ends early");
    }

    // rows of CCITT data into rows of (w + 7) / 8 bytes
    void fax_rows(const uint8_t* s, size_t cnt, uint8_t* o, uint32_t w, uint32_t rows,
                  const RunTable& white, const RunTable& black) const {
        Fax f(s, cnt, (int)w, white, black);
        const size_t rowbytes = (w + 7) / 8;
        for (uint32_t y = 0; y < rows; ++y) {
            if (compression == 2) {          // modified Huffman: byte-aligned 1-D rows
                f.row_1d();
                f.align_byte();
            } else if (compression == 3) {   // Group 3: EOL, then a 1-D or 2-D row
                f.sync_eol();
                bool one_d = !(t4options & 1) || f.bit();
                if (one_d) f.row_1d();
                else f.row_2d();
            } else {
                f.row_2d();
            }
            f.finish_row(o + rowbytes * y);
        }
    }

    // one strip or tile into exactly `want` bytes
    void decompress(const uint8_t* src, size_t cnt, uint8_t* out, size_t want, uint32_t cw,
                    uint32_t rows, inflate_fn inflate, const RunTable& white,
                    const RunTable& black) const {
        switch (compression) {
            case 1:
                if (cnt < want) fail("TIFF: truncated strip or tile");
                std::memcpy(out, src, want);
                break;
            case 32773: packbits(src, cnt, out, want); break;
            case 5: lzw(src, cnt, out, want); break;
            case 8: case 32946: {
                int64_t got = inflate(src, (int64_t)cnt, out, (int64_t)want);
                if (got < 0) fail("TIFF: corrupt Deflate data");
                if ((size_t)got < want) fail("TIFF: Deflate data ends early");
                break;
            }
            case 2: case 3: case 4:
                fax_rows(src, cnt, out, cw, rows, white, black);
                break;
        }
    }

    // libtiff's TIFFYCbCrToRGBInit / TIFFYCbCrtoRGB (tif_color.c) for the
    // default YCbCrCoefficients and ReferenceBlackWhite: 16-bit fixed point
    // from float coefficients
    struct YccToRgb {
        int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256];
        YccToRgb() {
            auto fix = [](float x) { return (int32_t)(x * (1L << 16) + 0.5); };
            const float lr = 0.299f, lg = 0.587f, lb = 0.114f;
            const float f1 = 2 - 2 * lr, f2 = lr * f1 / lg, f3 = 2 - 2 * lb, f4 = lb * f3 / lg;
            const int32_t d1 = fix(f1), d2 = -fix(f2), d3 = fix(f3), d4 = -fix(f4);
            for (int i = 0, x = -128; i < 256; ++i, ++x) {
                cr_r[i] = (d1 * x + (1 << 15)) >> 16;
                cb_b[i] = (d3 * x + (1 << 15)) >> 16;
                cr_g[i] = d2 * x;
                cb_g[i] = d4 * x + (1 << 15);
            }
        }
        void put(int y, int cb, int cr, uint8_t* rgb) const {
            auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
            rgb[0] = clamp(y + cr_r[cr]);
            rgb[1] = clamp(y + ((cb_g[cb] + cr_g[cr]) >> 16));
            rgb[2] = clamp(y + cb_b[cb]);
        }
    };

    // YCbCr under a codec other than JPEG, as libtiff's RGBA interface
    // reads it: strips or tiles of sampling units (the h x v Y samples, Cb,
    // Cr), each unit's chroma on all its pixels
    void decode_ycc_units(uint8_t* dst, inflate_fn inflate) const {
        const uint32_t cw = tiled ? tile_w : width;
        const uint32_t ch = tiled ? tile_h : std::min(rows_per_strip, height);
        if (!cw || !ch) fail("TIFF: bad strip or tile size");
        const uint32_t across = tiled ? (width + cw - 1) / cw : 1;
        const uint32_t down = (height + ch - 1) / ch;
        if (offsets.size() < (size_t)across * down) fail("TIFF: missing strip or tile offsets");
        const uint32_t unit = ycc_h * ycc_v + 2, units_across = (cw + ycc_h - 1) / ycc_h;
        const YccToRgb conv;
        RunTable white, black;
        std::vector<uint8_t> chunk, reversed;
        for (uint32_t ty = 0; ty < down; ++ty)
            for (uint32_t tx = 0; tx < across; ++tx) {
                size_t idx = (size_t)ty * across + tx;
                uint32_t rows = tiled ? ch : std::min(ch, height - ty * ch);
                uint32_t unit_rows = (rows + ycc_v - 1) / ycc_v;
                size_t want = (size_t)unit_rows * units_across * unit;
                size_t off = (size_t)offsets[idx];
                if (off > n) fail("TIFF: strip or tile past the end of the file");
                size_t cnt = std::min(idx < counts.size() ? (size_t)counts[idx] : want, n - off);
                const uint8_t* src = d + off;
                if (fillorder == 2) {
                    reversed.resize(cnt);
                    for (size_t i = 0; i < cnt; ++i) reversed[i] = reverse_bits(src[i]);
                    src = reversed.data();
                }
                chunk.assign(want, 0);
                decompress(src, cnt, chunk.data(), want, cw, rows, inflate, white, black);
                const uint32_t x0 = tx * cw, y0 = ty * ch;
                for (uint32_t uy = 0; uy < unit_rows; ++uy)
                    for (uint32_t ux = 0; ux < units_across; ++ux) {
                        const uint8_t* u = chunk.data() + ((size_t)uy * units_across + ux) * unit;
                        const int cb = u[ycc_h * ycc_v], cr = u[ycc_h * ycc_v + 1];
                        for (uint32_t j = 0; j < ycc_v; ++j)
                            for (uint32_t i = 0; i < ycc_h; ++i) {
                                uint32_t x = x0 + ux * ycc_h + i, y = y0 + uy * ycc_v + j;
                                if (x >= width || y >= height || ux * ycc_h + i >= cw ||
                                    uy * ycc_v + j >= rows)
                                    continue;
                                conv.put(u[j * ycc_h + i], cb, cr, dst + ((size_t)y * width + x) * 3);
                            }
                    }
            }
    }

    // old-style JPEG (compression 6) from its JPEGInterchangeFormat stream,
    // as libtiff's tif_ojpeg.c hands it to the RGBA interface: the
    // components as the inverse DCT leaves them, not upsampled, and each
    // chroma sample on its whole sampling unit
    void decode_ojpeg(uint8_t* dst) const {
        if (ojpeg_at > n || ojpeg_len > n - ojpeg_at)
            fail("TIFF: JPEGInterchangeFormat past the end of the file");
        Jpeg j(d + ojpeg_at, ojpeg_len);
        j.decode_coefficients();
        if (j.comps.size() != 3) fail("TIFF: old-style JPEG-in-TIFF without 3 components");
        const Component &yc = j.comps[0], &cbc = j.comps[1], &crc = j.comps[2];
        if (yc.h != j.hmax || yc.v != j.vmax || cbc.h != 1 || cbc.v != 1 || crc.h != 1 ||
            crc.v != 1)
            fail("TIFF: old-style JPEG-in-TIFF whose chroma is not sampled 1 x 1");
        if ((uint32_t)j.width < width || (uint32_t)j.height < height)
            fail("TIFF: old-style JPEG stream smaller than the image");
        j.inverse_dct();
        const YccToRgb conv;
        const int ys = yc.bw * 8, cs = cbc.bw * 8;
        for (uint32_t y = 0; y < height; ++y)
            for (uint32_t x = 0; x < width; ++x) {
                size_t c = (size_t)(y / yc.v) * cs + x / yc.h;
                conv.put(yc.plane[(size_t)y * ys + x], cbc.plane[c], crc.plane[c],
                         dst + ((size_t)y * width + x) * 3);
            }
    }

    // one JPEG stream (tables from JPEGTables first) -> its pixels, placed
    // at (x0, y0) of the image
    void jpeg_chunk(const uint8_t* src, size_t cnt, uint32_t x0, uint32_t y0, uint8_t* dst) const {
        std::vector<uint8_t> stream;
        if (jpegtables_len >= 4 && cnt >= 2 && src[0] == 0xFF && src[1] == 0xD8) {
            const uint8_t* t = d + jpegtables_at;
            size_t tl = jpegtables_len;
            if (t[tl - 2] == 0xFF && t[tl - 1] == 0xD9) tl -= 2;
            stream.assign(t, t + tl);
            stream.insert(stream.end(), src + 2, src + cnt);
        } else {
            stream.assign(src, src + cnt);
        }
        Jpeg j(stream.data(), stream.size());
        // libtiff: YCbCr is converted to RGB (PIL asks for JPEGCOLORMODE_RGB);
        // any other photometric comes out as coded
        j.colorspace = photometric == 6 ? 0 : 1;
        j.decode_coefficients();
        const int ch = channels();
        if (j.channels() != ch) fail("TIFF: JPEG strip or tile has the wrong number of components");
        if (photometric != 6 && ch == 3 && (j.hmax != 1 || j.vmax != 1))
            fail("TIFF: subsampled JPEG-in-TIFF that is not YCbCr is not supported");
        j.inverse_dct();
        std::vector<uint8_t> px((size_t)j.width * j.height * ch);
        j.to_pixels(px.data());
        uint32_t w_here = std::min((uint32_t)j.width, width - x0);
        uint32_t h_here = std::min((uint32_t)j.height, height - y0);
        for (uint32_t r = 0; r < h_here; ++r)
            std::memcpy(dst + ((size_t)(y0 + r) * width + x0) * ch,
                        px.data() + (size_t)r * j.width * ch, (size_t)w_here * ch);
    }

    void decode(uint8_t* dst, inflate_fn inflate) {
        check_supported();
        if (compression == 6) return decode_ojpeg(dst);
        if (ycc_rgba()) return decode_ycc_units(dst, inflate);
        const uint32_t cw = tiled ? tile_w : width;
        const uint32_t ch = tiled ? tile_h : std::min(rows_per_strip, height);
        if (!cw || !ch) fail("TIFF: bad strip or tile size");
        const uint32_t planes = planar == 2 ? spp : 1, spc = planar == 2 ? 1 : spp;
        const size_t rowbytes = ((size_t)cw * spc * bps + 7) / 8;
        const uint32_t across = tiled ? (width + cw - 1) / cw : 1;
        const uint32_t down = (height + ch - 1) / ch;
        // PIL reads an uncompressed file strip by strip as far as its
        // offsets go and leaves the rest black; libtiff needs them all
        if (compression != 1 && offsets.size() < (size_t)across * down * planes)
            fail("TIFF: missing strip or tile offsets");
        const int sb = sample_bytes();
        RunTable white, black;
        if (fax()) fill_tables(white, black);
        std::vector<uint8_t> chunk, reversed;
        std::vector<uint32_t> row(cw * spc);
        // samples of the whole image (a palette image: its indices)
        std::vector<uint8_t> samples(photometric == 3 ? (size_t)width * height
                                                       : jpeg() ? 0 : (size_t)width * height * spp * sb);
        for (uint32_t plane = 0; plane < planes; ++plane)
            for (uint32_t ty = 0; ty < down; ++ty)
                for (uint32_t tx = 0; tx < across; ++tx) {
                    size_t idx = ((size_t)plane * down + ty) * across + tx;
                    if (idx >= offsets.size()) continue;
                    uint32_t rows = tiled ? ch : std::min(ch, height - ty * ch);
                    size_t want = rowbytes * rows;
                    size_t off = (size_t)offsets[idx];
                    if (off > n) fail("TIFF: strip or tile past the end of the file");
                    size_t cnt = idx < counts.size() ? (size_t)counts[idx] : want;
                    cnt = std::min(cnt, n - off);
                    const uint8_t* src = d + off;
                    if (fillorder == 2) {
                        reversed.resize(cnt);
                        for (size_t i = 0; i < cnt; ++i) reversed[i] = reverse_bits(src[i]);
                        src = reversed.data();
                    }
                    uint32_t x0 = tx * cw, y0 = ty * ch;
                    if (jpeg()) {
                        jpeg_chunk(src, cnt, x0, y0, dst);
                        continue;
                    }
                    chunk.assign(want, 0);
                    decompress(src, cnt, chunk.data(), want, cw, rows, inflate, white, black);
                    uint32_t w_here = std::min(cw, width - x0);
                    const size_t nvals = (size_t)cw * spc;
                    for (uint32_t r = 0; r < rows && y0 + r < height; ++r) {
                        const uint8_t* p = chunk.data() + rowbytes * r;
                        // the row's sample values
                        if (predicted() && predictor == 3) {
                            // libtiff fpAcc: bytes summed along the row, then
                            // un-shuffled from byte planes, most significant first
                            std::vector<uint8_t> b(p, p + rowbytes);
                            for (size_t i = spc; i < rowbytes; ++i) b[i] = (uint8_t)(b[i] + b[i - spc]);
                            for (size_t i = 0; i < nvals; ++i)
                                row[i] = ((uint32_t)b[i] << 24) | ((uint32_t)b[nvals + i] << 16) |
                                         ((uint32_t)b[2 * nvals + i] << 8) | b[3 * nvals + i];
                        } else if (bps >= 8) {
                            for (size_t i = 0; i < nvals; ++i)
                                row[i] = (uint32_t)rd_sample(p + i * (bps / 8));
                            if (predicted() && predictor == 2) {
                                const uint32_t mask = bps == 32 ? 0xFFFFFFFFu : (1u << bps) - 1;
                                for (size_t i = spc; i < nvals; ++i) row[i] = (row[i] + row[i - spc]) & mask;
                            }
                        } else {
                            for (size_t i = 0; i < nvals; ++i) {
                                size_t bit = i * bps;
                                row[i] = (p[bit >> 3] >> (8 - bps - (bit & 7))) & ((1u << bps) - 1);
                            }
                        }
                        // into the image
                        for (uint32_t x = 0; x < w_here; ++x)
                            for (uint32_t c = 0; c < spc; ++c) {
                                uint32_t v = row[(size_t)x * spc + c];
                                size_t at = ((size_t)(y0 + r) * width + x0 + x) *
                                            (photometric == 3 ? 1 : spp) + plane + c;
                                if (sb == 1) samples[at] = (uint8_t)v;
                                else if (sb == 2) { uint16_t h = (uint16_t)v; std::memcpy(&samples[at * 2], &h, 2); }
                                else std::memcpy(&samples[at * 4], &v, 4);
                            }
                    }
                }
        if (jpeg()) return;
        const size_t npix = (size_t)width * height;
        if (photometric == 3) {
            const size_t ncol = (size_t)1 << bps;
            for (size_t i = 0; i < npix; ++i) {
                size_t v = samples[i];
                dst[3 * i] = (uint8_t)(colormap[v] >> 8);
                dst[3 * i + 1] = (uint8_t)(colormap[ncol + v] >> 8);
                dst[3 * i + 2] = (uint8_t)(colormap[2 * ncol + v] >> 8);
            }
            return;
        }
        std::memcpy(dst, samples.data(), samples.size());
    }

    // one 8-, 16- or 32-bit sample in the file's byte order
    uint32_t rd_sample(const uint8_t* p) const {
        if (bps == 8) return p[0];
        uint32_t v = 0;
        const int k = (int)bps / 8;
        for (int i = 0; i < k; ++i) v |= (uint32_t)p[i] << (8 * (big_endian ? k - 1 - i : i));
        return v;
    }
};

int kind_of(const uint8_t* d, size_t n) {
    if (n >= 2 && d[0] == 0xFF && d[1] == 0xD8) return 1;
    if (n >= 4 && ((d[0] == 'I' && d[1] == 'I' && d[2] == 42 && d[3] == 0) ||
                   (d[0] == 'M' && d[1] == 'M' && d[2] == 0 && d[3] == 42) ||
                   (d[0] == 'I' && d[1] == 'I' && d[2] == 43 && d[3] == 0) ||
                   (d[0] == 'M' && d[1] == 'M' && d[2] == 0 && d[3] == 43)))
        return 2;
    return 0;
}

void copy_error(const char* msg, char* err, int32_t errlen) {
    if (err && errlen > 0) {
        std::strncpy(err, msg, errlen - 1);
        err[errlen - 1] = 0;
    }
}

}  // namespace

extern "C" {

// info: [width, height, channels (1 grey, 2 grey + alpha, 3 RGB, 4 RGBA
// or more samples), kind (1 JPEG, 2 TIFF), bytes per sample (1, 2 or 4)]
// and, for a TIFF, the tags that decide PIL's mode: [5] photometric (-1
// absent), [6] compression, [7] planar configuration, [8] fill order,
// [9] big-endian, [10] BigTIFF, [11] samples per pixel (-1 absent),
// [12] count of BitsPerSample values, [13] bits per sample, [14] count of
// SampleFormat values, [15] sample format, [16] 1 if all SampleFormat
// values are equal, [17] count of ExtraSamples, [18..20] the first three
// ExtraSamples, [21] predictor. Read from the headers only; a TIFF that
// PIL opens but cannot decode passes here and raises in
// citlab_image_decode. Returns 0, or 1 with a message in err.
int32_t citlab_image_info(const uint8_t* data, int64_t n, int32_t* info, char* err,
                          int32_t errlen) {
    try {
        std::memset(info, 0, sizeof(int32_t) * 24);
        int kind = kind_of(data, (size_t)n);
        if (kind == 1) {
            Jpeg j(data, (size_t)n);
            j.parse_header();
            info[0] = j.width;
            info[1] = j.height;
            info[2] = j.channels();
            info[4] = 1;
        } else if (kind == 2) {
            Tiff t(data, (size_t)n);
            t.parse();
            t.check_open();
            info[0] = (int32_t)t.width;
            info[1] = (int32_t)t.height;
            info[2] = t.channels();
            info[4] = t.sample_bytes();
            info[5] = t.have_photometric ? (int32_t)t.photometric : -1;
            info[6] = (int32_t)t.compression;
            info[7] = (int32_t)t.planar;
            info[8] = (int32_t)t.fillorder;
            info[9] = t.big_endian;
            info[10] = t.bigtiff;
            info[11] = t.have_spp ? (int32_t)t.spp : -1;
            info[12] = (int32_t)t.bps_all.size();
            info[13] = (int32_t)t.bps;
            info[14] = (int32_t)t.n_sf;
            info[15] = (int32_t)t.sampleformat;
            info[16] = t.sf_uniform;
            info[17] = (int32_t)t.extrasamples.size();
            for (size_t i = 0; i < 3 && i < t.extrasamples.size(); ++i)
                info[18 + i] = (int32_t)t.extrasamples[i];
            info[21] = (int32_t)t.predictor;
        } else {
            fail("not a JPEG or TIFF file");
        }
        info[3] = kind;
        return 0;
    } catch (const std::exception& e) {
        copy_error(e.what(), err, errlen);
        return 1;
    }
}

// decodes into out (height x width x channels bytes, as citlab_image_info
// says). Returns 0, or 1 with a message in err.
int32_t citlab_image_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t out_size,
                            inflate_fn inflate, char* err, int32_t errlen) {
    try {
        int kind = kind_of(data, (size_t)n);
        if (kind == 1) {
            Jpeg j(data, (size_t)n);
            j.decode_coefficients();
            if ((int64_t)j.width * j.height * j.channels() != out_size)
                fail("output buffer size does not match the image");
            j.inverse_dct();
            j.to_pixels(out);
        } else if (kind == 2) {
            Tiff t(data, (size_t)n);
            t.parse();
            t.check_supported();
            if ((int64_t)t.width * t.height * t.channels() * t.sample_bytes() != out_size)
                fail("output buffer size does not match the image");
            t.decode(out, inflate);
        } else {
            fail("not a JPEG or TIFF file");
        }
        return 0;
    } catch (const std::exception& e) {
        copy_error(e.what(), err, errlen);
        return 1;
    }
}

}  // extern "C"
