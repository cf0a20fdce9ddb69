// Host image decoder of the port: JPEG and TIFF pages to their samples,
// equal bit for bit to what PIL 12.1 (libjpeg-turbo 3.1, libtiff 4.7)
// gives for Image.open(path) in the file's own mode, and the RLE and LZW
// stages of PIL's BMP and GIF readers.
//
// JPEG: 8 bits, 1, 3 or 4 components; baseline, extended sequential or
// progressive, Huffman or arithmetic coding (jdarith.c: T.81 annex D, the
// DAC conditioning, statistics reset at restarts), and lossless Huffman
// (jdlossls.c / jddiffct.c: predictors 1-7, the point transform, the
// first-row rule after each restart); restart markers, non-interleaved
// scans, any integral sampling factors. The pixel path follows
// libjpeg-turbo's C code: jidctint.c jpeg_idct_islow (JDCT_ISLOW, the
// default), jdcoefct.c decompress_smooth_data (the 5 x 5 block smoothing
// of a progressive image whose low coefficients are not all known),
// jdsample.c (h2v1 / h2v2 / h1v2 fancy upsampling where the component is
// wider than 2 samples, box upsampling otherwise and for lossless files),
// jdcolor.c ycc_rgb_convert and ycck_cmyk_convert, and jdapimin.c
// default_decompress_parms for the colour space.
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

// T.81 Table D.2 (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS), packed as
// libjpeg's jaricom.c packs it: Qe << 16 | NMPS << 8 | Switch_MPS << 7 | NLPS.
// Entry 113 is the fixed probability 0.5 of T.851 that libjpeg codes sign and
// refinement bits with.
const int32_t kAritab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171};

// the arithmetic decoder of T.81 annex D as jdarith.c runs it: C and A
// registers, a bit counter that starts at -16 (two bytes to fill C), zero
// data once a marker is reached (legal in arithmetic coding), ct = -1 after a
// bad code, which stops the decoding of the scan's MCUs until the next restart
struct ArithDecoder {
    const uint8_t* d;
    size_t n, pos;
    int64_t c = 0, a = 0;
    int ct = -16;
    bool marker = false, past_end = false;

    ArithDecoder(const uint8_t* data, size_t size, size_t start)
        : d(data), n(size), pos(start) {}

    int byte() {
        if (marker) return 0;
        if (pos >= n) {
            past_end = marker = true;
            return 0;
        }
        if (d[pos] != 0xFF) return d[pos++];
        size_t q = pos + 1;
        while (q < n && d[q] == 0xFF) ++q;     // fill bytes
        if (q >= n) {
            past_end = marker = true;
            return 0;
        }
        if (d[q] == 0) {                       // stuffed zero
            pos = q + 1;
            return 0xFF;
        }
        pos = q - 1;                           // left on the marker
        marker = true;
        return 0;
    }

    int decode(uint8_t* st) {
        while (a < 0x8000) {
            if (--ct < 0) {
                c = (c << 8) | byte();
                if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;
            }
            a <<= 1;
        }
        int sv = *st;
        int32_t qe = kAritab[sv & 0x7F];
        const int nl = qe & 0xFF, nm = (qe >> 8) & 0xFF;
        qe >>= 16;
        int64_t temp = a - qe;
        a = temp;
        temp <<= ct;
        if (c >= temp) {
            c -= temp;
            if (a < qe) {
                a = qe;
                *st = (uint8_t)((sv & 0x80) ^ nm);
            } else {
                a = qe;
                *st = (uint8_t)((sv & 0x80) ^ nl);
                sv ^= 0x80;
            }
        } else if (a < 0x8000) {
            if (a < qe) {
                *st = (uint8_t)((sv & 0x80) ^ nl);
                sv ^= 0x80;
            } else {
                *st = (uint8_t)((sv & 0x80) ^ nm);
            }
        }
        return sv >> 7;
    }
};

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int bw = 0, bh = 0;      // blocks (lossless: samples) per line / column, whole MCUs
    int dw = 0, dh = 0;      // downsampled width / height (real samples)
    int dc_tbl = 0, ac_tbl = 0, dc_pred = 0, dc_ctx = 0;
    bool quant_latched = false;
    uint16_t quant[64] = {0};
    int coef_bits[64];
    std::vector<int16_t> coef;
    std::vector<uint8_t> plane;  // samples after the IDCT (lossless: undifferenced)
};

struct Jpeg {
    const uint8_t* d;
    size_t n;
    int width = 0, height = 0, precision = 8;
    int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
    int bs = 8;            // samples per block side (lossless: 1)
    bool progressive = false, arith = false, lossless = false, frame = false;
    bool jfif = false, adobe = false;
    int adobe_transform = -1;
    int restart_interval = 0;
    int colorspace = -1;   // 0 YCbCr (YCCK), 1 as coded (no conversion), -1 from the markers
    uint16_t qt[4][64];
    bool qt_present[4] = {false, false, false, false};
    Huffman dc[4], ac[4];
    // arithmetic conditioning (DAC, defaults L = 0, U = 1, Kx = 5) and the
    // statistics bins of each table (jdarith.c DC_STAT_BINS, AC_STAT_BINS)
    uint8_t dac_L[16], dac_U[16], dac_K[16];
    uint8_t dc_stats[16][64], ac_stats[16][256];
    uint8_t fixed_bin[4] = {113, 0, 0, 0};
    std::vector<Component> comps;

    Jpeg(const uint8_t* data, size_t size) : d(data), n(size) {
        std::fill(dac_L, dac_L + 16, 0);
        std::fill(dac_U, dac_U + 16, 1);
        std::fill(dac_K, dac_K + 16, 5);
    }

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

    // the frame header; PIL's SOF handler refuses other precisions than 8
    // and other layer counts than 1, 3 and 4 when the file is opened, and
    // libjpeg-turbo the other processes when it is decoded
    void read_sof(size_t p, int marker, bool decoding) {
        if (frame) fail("JPEG: more than one frame (hierarchical JPEG)");
        frame = true;
        progressive = marker == 0xC2 || marker == 0xCA;
        arith = marker >= 0xC8;
        lossless = marker == 0xC3 || marker == 0xCB;
        bs = lossless ? 1 : 8;
        if (p + 6 > n) fail("JPEG: truncated SOF");
        precision = d[p];
        if (precision != 8)
            fail("JPEG: " + std::to_string(precision) +
                 "-bit JPEG is not supported (PIL reads 8-bit samples only)");
        height = u16(p + 1);
        width = u16(p + 3);
        int nc = d[p + 5];
        if (height == 0) fail("JPEG: height 0 (DNL marker) is not supported");
        if (width == 0) fail("JPEG: width 0");
        if (nc != 1 && nc != 3 && nc != 4)
            fail("JPEG: " + std::to_string(nc) +
                 "-component JPEG is not supported (PIL reads 1, 3 or 4 components)");
        if (decoding) {
            if ((marker >= 0xC5 && marker <= 0xC7) || marker >= 0xCD)
                fail("JPEG: hierarchical (differential) JPEG is not supported");
            if (marker == 0xCB)
                fail("JPEG: arithmetic-coded lossless JPEG is not supported "
                     "(libjpeg-turbo does not decode it)");
        }
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
        mcux = (width + bs * hmax - 1) / (bs * hmax);
        mcuy = (height + bs * vmax - 1) / (bs * vmax);
        for (Component& c : comps) {
            if (hmax % c.h || vmax % c.v)
                fail("JPEG: non-integral sampling factor ratio is not supported");
            c.bw = mcux * c.h;
            c.bh = mcuy * c.v;
            c.dw = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
            c.dh = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
            if (!decoding) continue;
            if (lossless)
                c.plane.assign((size_t)c.bw * c.bh, 0);
            else
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

    // jdmarker.c get_dac: Tc Tb, then the DC bounds (U << 4 | L) or Kx
    void read_dac(size_t p, size_t end) {
        for (; p + 1 < end; p += 2) {
            int index = d[p], val = d[p + 1];
            if (index >= 32) fail("JPEG: bad DAC table index");
            if (index >= 16) {
                dac_K[index - 16] = (uint8_t)val;
            } else {
                dac_L[index] = (uint8_t)(val & 15);
                dac_U[index] = (uint8_t)(val >> 4);
                if (dac_L[index] > dac_U[index]) fail("JPEG: bad DAC conditioning value");
            }
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

    static bool is_sof(int m) { return m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC; }

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
            if (is_sof(m)) {
                read_sof(body, m, false);
                return;
            }
            pos = end;
        }
    }

    int channels() const { return (int)comps.size(); }

    // jdapimin.c default_decompress_parms (libjpeg-turbo 3: a lossless file
    // without markers whose component ids are not 'R', 'G', 'B' is RGB too)
    bool rgb_colorspace() const {
        if (comps.size() != 3) return false;
        if (colorspace >= 0) return colorspace == 1;
        if (jfif) return false;
        if (adobe) return adobe_transform == 0;
        int c0 = comps[0].id, c1 = comps[1].id, c2 = comps[2].id;
        if (c0 == 82 && c1 == 71 && c2 == 66) return true;
        return lossless;
    }

    // a 4-component file is YCCK under an Adobe marker whose transform is
    // not 0, CMYK otherwise
    bool ycck() const {
        if (comps.size() != 4) return false;
        if (colorspace >= 0) return colorspace == 0;
        return adobe && adobe_transform != 0;
    }

    // ---- entropy decoding into coefficient arrays (lossless: samples)
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

    // the scan's units (MCUs, or the blocks of its one component) in order
    int64_t scan_units(const Scan& sc, int& units_x) const {
        if (sc.comp.size() == 1) {
            const Component& c = comps[sc.comp[0]];
            units_x = (c.dw + 7) / 8;
            return (int64_t)units_x * ((c.dh + 7) / 8);
        }
        units_x = mcux;
        return (int64_t)mcux * mcuy;
    }

    void decode_scan(size_t& pos, const Scan& sc) {
        if (lossless) return decode_scan_lossless(pos, sc);
        for (int ci : sc.comp) {
            Component& c = comps[ci];
            if (!c.quant_latched) {
                if (!qt_present[c.tq]) fail("JPEG: missing quantization table");
                std::memcpy(c.quant, qt[c.tq], sizeof(c.quant));
                c.quant_latched = true;
            }
            c.dc_pred = 0;
            if (arith) continue;
            bool need_dc = !progressive || (sc.ss == 0 && sc.ah == 0);
            bool need_ac = !progressive || sc.ss > 0;
            if (need_dc && (c.dc_tbl > 3 || !dc[c.dc_tbl].present))
                fail("JPEG: missing Huffman table");
            if (need_ac && (c.ac_tbl > 3 || !ac[c.ac_tbl].present))
                fail("JPEG: missing Huffman table");
        }
        if (progressive) {
            // jdphuff.c / jdarith.c start_pass
            bool bad = sc.ss == 0 ? sc.se != 0
                                  : sc.se < sc.ss || sc.se > 63 || sc.comp.size() != 1;
            if (bad || (sc.ah != 0 && sc.al != sc.ah - 1) || sc.al > 13)
                fail("JPEG: bad progressive scan parameters");
            for (int ci : sc.comp) {
                Component& c = comps[ci];
                for (int k = sc.ss; k <= sc.se; ++k) c.coef_bits[k] = sc.al;
            }
        }
        if (arith) return decode_scan_arith(pos, sc);
        BitReader br(d, n, pos);
        int eobrun = 0;
        bool single = sc.comp.size() == 1;
        int units_x;
        const int64_t total = scan_units(sc, units_x);
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

    // ---- arithmetic decoding (jdarith.c, T.81 annex F.2.4 and G.2)

    // Figures F.19-F.24: one DC difference into c.dc_pred (mod 2^16) and
    // the conditioning category c.dc_ctx; false after a bad code
    bool arith_dc(ArithDecoder& ad, Component& c) {
        const int tbl = c.dc_tbl;
        uint8_t* st = dc_stats[tbl] + c.dc_ctx;
        if (ad.decode(st) == 0) {
            c.dc_ctx = 0;
            return true;
        }
        const int sign = ad.decode(st + 1);
        st += 2 + sign;
        int m = ad.decode(st);
        if (m != 0) {
            st = dc_stats[tbl] + 20;
            while (ad.decode(st)) {
                if ((m <<= 1) == 0x8000) {
                    ad.ct = -1;                 // magnitude overflow
                    return false;
                }
                st += 1;
            }
        }
        if (m < ((1 << dac_L[tbl]) >> 1))
            c.dc_ctx = 0;
        else if (m > ((1 << dac_U[tbl]) >> 1))
            c.dc_ctx = 12 + sign * 4;
        else
            c.dc_ctx = 4 + sign * 4;
        int v = m;
        st += 14;
        while (m >>= 1)
            if (ad.decode(st)) v |= m;
        v += 1;
        if (sign) v = -v;
        c.dc_pred = (c.dc_pred + v) & 0xFFFF;
        return true;
    }

    // Figure F.20: the AC coefficients ss..se of one block, scaled by al;
    // false after a bad code
    bool arith_ac(ArithDecoder& ad, int tbl, int16_t* blk, int ss, int se, int al) {
        uint8_t* stats = ac_stats[tbl];
        for (int k = ss; k <= se; ++k) {
            uint8_t* st = stats + 3 * (k - 1);
            if (ad.decode(st)) break;           // EOB
            while (ad.decode(st + 1) == 0) {
                st += 3;
                if (++k > se) {
                    ad.ct = -1;                 // spectral overflow
                    return false;
                }
            }
            const int sign = ad.decode(fixed_bin);
            st += 2;
            int m = ad.decode(st);
            if (m != 0 && ad.decode(st)) {
                m <<= 1;
                st = stats + (k <= dac_K[tbl] ? 189 : 217);
                while (ad.decode(st)) {
                    if ((m <<= 1) == 0x8000) {
                        ad.ct = -1;             // magnitude overflow
                        return false;
                    }
                    st += 1;
                }
            }
            int v = m;
            st += 14;
            while (m >>= 1)
                if (ad.decode(st)) v |= m;
            v += 1;
            if (sign) v = -v;
            blk[kNatural[k]] = (int16_t)(uint16_t)((unsigned)v << al);
        }
        return true;
    }

    // jdarith.c decode_mcu_AC_refine: one more bit of the band's
    // coefficients; false after a bad code
    bool arith_ac_refine(ArithDecoder& ad, int tbl, int16_t* blk, int ss, int se, int al) {
        uint8_t* stats = ac_stats[tbl];
        const int p1 = 1 << al, m1 = -1 * (1 << al);
        int kex = se;                           // end of block of the previous stage
        for (; kex > 0; --kex)
            if (blk[kNatural[kex]]) break;
        for (int k = ss; k <= se; ++k) {
            uint8_t* st = stats + 3 * (k - 1);
            if (k > kex && ad.decode(st)) break;   // EOB
            for (;;) {
                int16_t* coef = blk + kNatural[k];
                if (*coef) {
                    if (ad.decode(st + 2))
                        *coef = (int16_t)(*coef < 0 ? *coef + m1 : *coef + p1);
                    break;
                }
                if (ad.decode(st + 1)) {
                    *coef = (int16_t)(ad.decode(fixed_bin) ? m1 : p1);
                    break;
                }
                st += 3;
                if (++k > se) {
                    ad.ct = -1;                 // spectral overflow
                    return false;
                }
            }
        }
        return true;
    }

    // the statistics of the scan's tables to zero, DC predictions too
    // (jdarith.c start_pass / process_restart)
    void reset_arith(const Scan& sc) {
        for (int ci : sc.comp) {
            Component& c = comps[ci];
            if (!progressive || (sc.ss == 0 && sc.ah == 0)) {
                std::memset(dc_stats[c.dc_tbl], 0, sizeof(dc_stats[0]));
                c.dc_pred = 0;
                c.dc_ctx = 0;
            }
            if (!progressive || sc.ss) std::memset(ac_stats[c.ac_tbl], 0, sizeof(ac_stats[0]));
        }
    }

    // one block of an arithmetic-coded scan; false after a bad code
    bool arith_unit(ArithDecoder& ad, const Scan& sc, Component& c, int16_t* blk) {
        if (!progressive) {
            if (!arith_dc(ad, c)) return false;
            blk[0] = (int16_t)(uint16_t)c.dc_pred;
            return arith_ac(ad, c.ac_tbl, blk, 1, 63, 0);
        }
        if (sc.ss == 0 && sc.ah == 0) {
            if (!arith_dc(ad, c)) return false;
            blk[0] = (int16_t)(uint16_t)((unsigned)c.dc_pred << sc.al);
            return true;
        }
        if (sc.ss == 0) {
            if (ad.decode(fixed_bin)) blk[0] = (int16_t)(blk[0] | (1 << sc.al));
            return true;
        }
        if (sc.ah == 0) return arith_ac(ad, c.ac_tbl, blk, sc.ss, sc.se, sc.al);
        return arith_ac_refine(ad, c.ac_tbl, blk, sc.ss, sc.se, sc.al);
    }

    void decode_scan_arith(size_t& pos, const Scan& sc) {
        const bool dc_refine = progressive && sc.ss == 0 && sc.ah != 0;
        reset_arith(sc);
        ArithDecoder ad(d, n, pos);
        const bool single = sc.comp.size() == 1;
        int units_x;
        const int64_t total = scan_units(sc, units_x);
        int64_t until_restart = restart_interval;
        for (int64_t u = 0; u < total; ++u) {
            if (restart_interval) {
                if (until_restart == 0) {
                    size_t p = ad.pos;
                    int m = next_marker(p);
                    if (m < 0xD0 || m > 0xD7) fail("JPEG: missing restart marker");
                    reset_arith(sc);
                    ad = ArithDecoder(d, n, p);
                    until_restart = restart_interval;
                }
                --until_restart;
            }
            // after a bad code every MCU is skipped (the DC refinement
            // procedure does not check)
            if (ad.ct == -1 && !dc_refine) continue;
            int ux = (int)(u % units_x), uy = (int)(u / units_x);
            if (single) {
                Component& c = comps[sc.comp[0]];
                arith_unit(ad, sc, c, block(c, uy, ux));
                continue;
            }
            bool ok = true;
            for (size_t i = 0; ok && i < sc.comp.size(); ++i) {
                Component& c = comps[sc.comp[i]];
                for (int by = 0; ok && by < c.v; ++by)
                    for (int bx = 0; ok && bx < c.h; ++bx)
                        ok = arith_unit(ad, sc, c, block(c, uy * c.v + by, ux * c.h + bx));
            }
        }
        if (ad.past_end) fail("JPEG: truncated file (entropy data runs past its end)");
        pos = ad.pos;
    }

    // ---- lossless (jdlossls.c, jddiffct.c, jdlhuff.c; T.81 annex H)

    void decode_scan_lossless(size_t& pos, const Scan& sc) {
        const int psv = sc.ss, pt = sc.al;
        if (psv < 1 || psv > 7 || sc.se != 0 || sc.ah != 0 || pt >= precision)
            fail("JPEG: bad lossless scan parameters (predictor " + std::to_string(psv) +
                 ", point transform " + std::to_string(pt) + ")");
        for (int ci : sc.comp) {
            const Component& c = comps[ci];
            if (c.dc_tbl > 3 || !dc[c.dc_tbl].present) fail("JPEG: missing Huffman table");
        }
        const bool single = sc.comp.size() == 1;
        const int mcus_per_row = single ? comps[sc.comp[0]].dw : mcux;
        if (restart_interval % mcus_per_row)
            fail("JPEG: lossless restart interval is not a whole number of MCU rows");
        const int restart_rows = restart_interval / mcus_per_row;
        // the iMCU row's differences and all undifferenced rows of each
        // component of the scan
        std::vector<std::vector<int32_t>> diff(comps.size()), undiff(comps.size());
        std::vector<char> first_row(comps.size(), 1);
        for (int ci : sc.comp) {
            const Component& c = comps[ci];
            diff[ci].assign((size_t)c.v * c.bw, 0);
            undiff[ci].assign((size_t)c.bh * c.bw, 0);
        }
        BitReader br(d, n, pos);
        int rows_to_go = restart_rows;
        for (int imcu = 0; imcu < mcuy; ++imcu) {
            // MCU rows of the iMCU row: one of an interleaved scan, the
            // component's rows of a scan of one component
            const Component& c0 = comps[sc.comp[0]];
            const int mcu_rows = !single ? 1 : imcu < mcuy - 1 ? c0.v : last_rows(c0);
            for (int yoff = 0; yoff < mcu_rows; ++yoff) {
                if (restart_interval && rows_to_go == 0) {
                    size_t p = br.pos;
                    int m = next_marker(p);
                    if (m < 0xD0 || m > 0xD7) fail("JPEG: missing restart marker");
                    br = BitReader(d, n, p);
                    std::fill(first_row.begin(), first_row.end(), 1);
                    rows_to_go = restart_rows;
                }
                for (int mcu = 0; mcu < mcus_per_row; ++mcu) {
                    if (single) {
                        const int ci = sc.comp[0];
                        diff[ci][(size_t)yoff * comps[ci].bw + mcu] = lossless_diff(br, comps[ci]);
                        continue;
                    }
                    for (int ci : sc.comp) {
                        const Component& c = comps[ci];
                        for (int y = 0; y < c.v; ++y)
                            for (int x = 0; x < c.h; ++x)
                                diff[ci][(size_t)y * c.bw + mcu * c.h + x] = lossless_diff(br, c);
                    }
                }
                if (restart_interval) --rows_to_go;
            }
            // undifference and scale the real rows of the iMCU row
            for (int ci : sc.comp) {
                Component& c = comps[ci];
                const int rows = imcu < mcuy - 1 ? c.v : last_rows(c);
                for (int r = 0; r < rows; ++r) {
                    const int y = imcu * c.v + r;
                    const int32_t* df = &diff[ci][(size_t)r * c.bw];
                    int32_t* cur = &undiff[ci][(size_t)y * c.bw];
                    if (first_row[ci]) {
                        int ra = (df[0] + (1 << (precision - pt - 1))) & 0xFFFF;
                        cur[0] = ra;
                        for (int x = 1; x < c.dw; ++x) cur[x] = ra = (df[x] + ra) & 0xFFFF;
                        first_row[ci] = 0;
                    } else {
                        const int32_t* up = cur - c.bw;
                        int rb = up[0], ra = (df[0] + rb) & 0xFFFF, rc;
                        cur[0] = ra;
                        for (int x = 1; x < c.dw; ++x) {
                            rc = rb;
                            rb = up[x];
                            int pred;
                            switch (psv) {
                                case 1: pred = ra; break;
                                case 2: pred = rb; break;
                                case 3: pred = rc; break;
                                case 4: pred = ra + rb - rc; break;
                                case 5: pred = ra + ((rb - rc) >> 1); break;
                                case 6: pred = rb + ((ra - rc) >> 1); break;
                                default: pred = (ra + rb) >> 1; break;
                            }
                            cur[x] = ra = (df[x] + pred) & 0xFFFF;
                        }
                    }
                    uint8_t* out = &c.plane[(size_t)y * c.bw];
                    for (int x = 0; x < c.dw; ++x) out[x] = (uint8_t)(cur[x] << pt);
                }
            }
        }
        if (br.past_end) fail("JPEG: truncated file (entropy data runs past its end)");
        pos = br.pos;
    }

    // rows of a component in the last iMCU row
    int last_rows(const Component& c) const {
        int r = c.dh % c.v;
        return r ? r : c.v;
    }

    // H.2.2: one sample difference (category 16 is 32768, no extra bits)
    int32_t lossless_diff(BitReader& br, const Component& c) {
        int s = br.decode(dc[c.dc_tbl]);
        if (s == 16) return 32768;
        if (s > 16) fail("JPEG: corrupt lossless difference");
        return s ? extend(br.bits(s), s) : 0;
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
            comps[found].dc_tbl = tbl >> 4;
            comps[found].ac_tbl = tbl & 15;
            sc.comp.push_back(found);
        }
        size_t q = body + 1 + 2 * ns;
        sc.ss = d[q];
        sc.se = d[q + 1];
        sc.ah = d[q + 2] >> 4;
        sc.al = d[q + 2] & 15;
        if (!progressive && !lossless) {
            sc.ss = 0;
            sc.se = 63;
            sc.ah = sc.al = 0;
        }
        pos = end;
        decode_scan(pos, sc);
    }

    void decode_scans() {
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
            if (is_sof(m)) {
                read_sof(body, m, true);
            } else if (m == 0xC4) {
                read_dht(body, end);
            } else if (m == 0xCC) {
                read_dac(body, end);
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

    // jdcoefct.c smoothing_ok: libjpeg smooths a progressive image whose
    // first nine AC coefficients are not all known to full precision, if
    // every component has its DC and nonzero quantizers there
    bool smoothing_ok() const {
        if (!progressive) return false;
        bool useful = false;
        for (const Component& c : comps) {
            const uint16_t* q = c.quant;
            if (!c.quant_latched || !q[0] || !q[1] || !q[8] || !q[16] || !q[9] || !q[2] ||
                !q[3] || !q[10] || !q[17] || !q[24])
                return false;
            if (c.coef_bits[0] < 0) return false;
            for (int k = 1; k < 10; ++k)
                if (c.coef_bits[k] != 0) useful = true;
        }
        return useful;
    }

    // jdcoefct.c decompress_smooth_data (libjpeg-turbo >= 2.1): each block's
    // still-unknown low AC coefficients (and, when no AC data came at all,
    // its DC) estimated from the DC values of its 5 x 5 neighbourhood, then
    // the IDCT; the neighbourhood's edges follow libjpeg's indexing, rows by
    // iMCU row and columns by a sliding window
    void smooth_idct(Component& c, uint8_t* plane, int stride) {
        const int wib = (c.dw + 7) / 8, hib = (c.dh + 7) / 8, last_col = wib - 1;
        const int* cb = c.coef_bits;
        bool change_dc = true;
        for (int k = 1; k < 10; ++k) change_dc = change_dc && cb[k] == -1;
        const int64_t Q00 = c.quant[0], Q01 = c.quant[1], Q10 = c.quant[8], Q20 = c.quant[16],
                      Q11 = c.quant[9], Q02 = c.quant[2], Q03 = c.quant[3], Q12 = c.quant[10],
                      Q21 = c.quant[17], Q30 = c.quant[24];
        // the rounded estimate num / (q * 256), clipped below 2^al when al > 0
        auto estimate = [](int64_t num, int64_t q, int al) {
            int64_t pred = ((q << 7) + (num >= 0 ? num : -num)) / (q << 8);
            if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
            return (int16_t)(num >= 0 ? pred : -pred);
        };
        int16_t ws[64];
        for (int imcu = 0; imcu < mcuy; ++imcu) {
            int block_rows = c.v;
            if (imcu == mcuy - 1) {
                block_rows = hib % c.v;
                if (block_rows == 0) block_rows = c.v;
            }
            const int image_block_rows = block_rows * mcuy;
            for (int br = 0; br < block_rows; ++br) {
                const int ibr = imcu * block_rows + br, row = imcu * c.v + br;
                const int prev = ibr > 0 ? row - 1 : row;
                const int pprev = ibr > 1 ? row - 2 : prev;
                const int next = ibr < image_block_rows - 1 ? row + 1 : row;
                const int nnext = ibr < image_block_rows - 2 ? row + 2 : next;
                const int rows[5] = {pprev, prev, row, next, nnext};
                // DC[5 * r + i]: row r of the window, column i (i = 2 the block)
                int DC[25];
                for (int r = 0; r < 5; ++r)
                    for (int i = 0; i < 5; ++i) DC[5 * r + i] = block(c, rows[r], 0)[0];
                for (int col = 0; col <= last_col; ++col) {
                    std::memcpy(ws, block(c, row, col), sizeof(ws));
                    if (col == 0 && col < last_col)
                        for (int r = 0; r < 5; ++r)
                            DC[5 * r + 3] = DC[5 * r + 4] = block(c, rows[r], 1)[0];
                    if (col + 1 < last_col)
                        for (int r = 0; r < 5; ++r) DC[5 * r + 4] = block(c, rows[r], col + 2)[0];
                    const int DC01 = DC[0], DC02 = DC[1], DC03 = DC[2], DC04 = DC[3],
                              DC05 = DC[4], DC06 = DC[5], DC07 = DC[6], DC08 = DC[7],
                              DC09 = DC[8], DC10 = DC[9], DC11 = DC[10], DC12 = DC[11],
                              DC13 = DC[12], DC14 = DC[13], DC15 = DC[14], DC16 = DC[15],
                              DC17 = DC[16], DC18 = DC[17], DC19 = DC[18], DC20 = DC[19],
                              DC21 = DC[20], DC22 = DC[21], DC23 = DC[22], DC24 = DC[23],
                              DC25 = DC[24];
                    int al;
                    if ((al = cb[1]) != 0 && ws[1] == 0)
                        ws[1] = estimate(Q00 * (change_dc
                            ? -DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 +
                              3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 -
                              3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 - DC21 - DC22 +
                              DC24 + DC25
                            : -7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15), Q01, al);
                    if ((al = cb[2]) != 0 && ws[8] == 0)
                        ws[8] = estimate(Q00 * (change_dc
                            ? -DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
                              13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 - 13 * DC17 -
                              38 * DC18 - 13 * DC19 + DC20 + DC21 + 3 * DC22 + 3 * DC23 +
                              3 * DC24 + DC25
                            : -7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23), Q10, al);
                    if ((al = cb[3]) != 0 && ws[16] == 0)
                        ws[16] = estimate(Q00 * (change_dc
                            ? DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 -
                              5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 + DC23
                            : -DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23), Q20, al);
                    if ((al = cb[4]) != 0 && ws[9] == 0)
                        ws[9] = estimate(Q00 * (change_dc
                            ? -DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 +
                              DC21 - DC25
                            : DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 -
                              DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09), Q11, al);
                    if ((al = cb[5]) != 0 && ws[2] == 0)
                        ws[2] = estimate(Q00 * (change_dc
                            ? 2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 +
                              7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19
                            : -DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15), Q02, al);
                    if (change_dc) {
                        if ((al = cb[6]) != 0 && ws[3] == 0)
                            ws[3] = estimate(Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 -
                                                    DC19), Q03, al);
                        if ((al = cb[7]) != 0 && ws[10] == 0)
                            ws[10] = estimate(Q00 * (DC07 - 3 * DC08 + DC09 - DC17 +
                                                     3 * DC18 - DC19), Q12, al);
                        if ((al = cb[8]) != 0 && ws[17] == 0)
                            ws[17] = estimate(Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 +
                                                     DC17 - DC19), Q21, al);
                        if ((al = cb[9]) != 0 && ws[24] == 0)
                            ws[24] = estimate(Q00 * (DC07 + 2 * DC08 + DC09 - DC17 -
                                                     2 * DC18 - DC19), Q30, al);
                        ws[0] = estimate(Q00 * (
                            -2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 -
                            6 * DC06 + 6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 -
                            8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 - 8 * DC15 -
                            6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 -
                            2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25), Q00, 0);
                    }
                    idct_islow(ws, c.quant, plane + (size_t)row * 8 * stride + col * 8, stride);
                    for (int r = 0; r < 5; ++r)        // slide the window one column
                        std::memmove(&DC[5 * r], &DC[5 * r + 1], 4 * sizeof(int));
                }
            }
        }
    }

    void inverse_dct() {
        const bool smooth = smoothing_ok();
        for (Component& c : comps) {
            if (lossless) continue;
            int stride = c.bw * 8;
            c.plane.assign((size_t)stride * c.bh * 8, 0);
            if (smooth) {
                smooth_idct(c, c.plane.data(), stride);
            } else {
                for (int by = 0; by < c.bh; ++by)
                    for (int bx = 0; bx < c.bw; ++bx)
                        idct_islow(block(c, by, bx), c.quant,
                                   &c.plane[(size_t)by * 8 * stride + bx * 8], stride);
            }
            std::vector<int16_t>().swap(c.coef);
        }
    }

    // ---- jdsample.c: one component to width x height samples (fancy
    // upsampling where libjpeg uses it: not for lossless files, whose
    // DCT_scaled_size is 1)
    std::vector<uint8_t> upsample(const Component& c) const {
        const int stride = c.bw * bs;
        const int W = width, H = height;
        const int he = hmax / c.h, ve = vmax / c.v;
        const bool fancy = !lossless;
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
        if (fancy && he == 2 && ve == 1 && dw > 2) {         // h2v1_fancy_upsample
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
        if (fancy && he == 1 && ve == 2) {                   // h1v2_fancy_upsample
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
        if (fancy && he == 2 && ve == 2 && dw > 2) {         // h2v2_fancy_upsample
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

    // pixels as libjpeg gives them to PIL: grey, RGB, or CMYK as stored
    // (PIL inverts it: rawmode "CMYK;I")
    void to_pixels(uint8_t* dst) const {
        const size_t npix = (size_t)width * height;
        const size_t nc = comps.size();
        std::vector<std::vector<uint8_t>> p;
        for (const Component& c : comps) p.push_back(upsample(c));
        if (nc == 1) {
            std::memcpy(dst, p[0].data(), npix);
            return;
        }
        if ((nc == 3 && rgb_colorspace()) || (nc == 4 && !ycck())) {
            for (size_t i = 0; i < npix; ++i)
                for (size_t k = 0; k < nc; ++k) dst[nc * i + k] = p[k][i];
            return;
        }
        // jdcolor.c build_ycc_rgb_table / ycc_rgb_convert; ycck_cmyk_convert
        // inverts the three colours and passes K through
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
        const uint8_t flip = nc == 4 ? 255 : 0;
        for (size_t i = 0; i < npix; ++i) {
            int y = p[0][i], cb = p[1][i], cr = p[2][i];
            uint8_t* o = dst + nc * i;
            o[0] = flip ^ clamp(y + cr_r[cr]);
            o[1] = flip ^ clamp(y + (int)((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
            o[2] = flip ^ clamp(y + cb_b[cb]);
            if (nc == 4) o[3] = p[3][i];
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
            if (!((photometric <= 1 && spp == 1) || ((photometric == 2 || photometric == 6) && spp == 3) ||
                  (photometric == 5 && spp == 4)))
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
        j.decode_scans();
        if (j.comps.size() != 3 || j.lossless)
            fail("TIFF: old-style JPEG-in-TIFF without 3 DCT components");
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
        j.decode_scans();
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

// ------------------------------------------------------------------ BMP, GIF

// PIL's BmpRleDecoder (BmpImagePlugin.py), quirks included: a delta code
// skips two bytes before the two it reads, an absolute run of RLE4 yields
// 2 * (count / 2) samples but advances x by count, the word alignment
// after it goes by the byte's position in the file, and an encoded run is
// cut at the row's end. The samples go to data until it holds
// width * height of them or the codes end.
void bmp_rle(const uint8_t* d, size_t n, size_t pos, bool rle4, int64_t xsize, int64_t ysize,
             std::vector<uint8_t>& data) {
    const size_t dest = (size_t)(xsize * ysize);
    int64_t x = 0;
    while (data.size() < dest) {
        if (pos + 2 > n) break;
        int num = d[pos], byte = d[pos + 1];
        pos += 2;
        if (num) {                                      // encoded run
            if (x + num > xsize) num = (int)std::max<int64_t>(0, xsize - x);
            for (int i = 0; i < num; ++i)
                data.push_back(rle4 ? (uint8_t)(i % 2 ? byte & 15 : byte >> 4) : (uint8_t)byte);
            x += num;
        } else if (byte == 0) {                         // end of line
            while (data.size() % (size_t)xsize) data.push_back(0);
            x = 0;
        } else if (byte == 1) {                         // end of bitmap
            break;
        } else if (byte == 2) {                         // delta
            if (pos + 2 > n) break;
            pos += 2;
            if (pos + 2 > n) fail("BMP: RLE delta runs past the end of the file");
            int right = d[pos], up = d[pos + 1];
            pos += 2;
            data.insert(data.end(), (size_t)(right + up * xsize), 0);
            x = (int64_t)(data.size() % (size_t)xsize);
        } else {                                        // absolute run
            const size_t count = rle4 ? byte / 2 : byte;
            const size_t got = std::min(count, n - pos);
            for (size_t i = 0; i < got; ++i) {
                if (rle4) {
                    data.push_back(d[pos + i] >> 4);
                    data.push_back(d[pos + i] & 15);
                } else {
                    data.push_back(d[pos + i]);
                }
            }
            pos += got;
            if (got < count) break;
            x += byte;
            if (pos % 2) ++pos;
        }
    }
}

// GIF LZW (the variable-length codes of the image data, sub-blocks joined)
// into a w x h frame, rows in interlaced order if asked, as PIL's
// GifDecode.c writes them; stops at the end code, when the frame is full
// or when the data ends. Returns the count of pixels written.
int64_t gif_lzw(const uint8_t* d, size_t n, int bits, int w, int h, bool interlace,
                uint8_t* out) {
    if (bits < 0 || bits > 12) fail("GIF: LZW minimum code size " + std::to_string(bits));
    const int clear = 1 << bits, end = clear + 1;
    std::vector<uint16_t> prefix(4096);
    std::vector<uint8_t> suffix(4096), stack(4097);
    for (int i = 0; i < clear && i < 4096; ++i) suffix[i] = (uint8_t)i;
    int codesize = bits + 1, next = clear + 2, prev = -1, first = 0;
    uint64_t acc = 0;
    int have = 0;
    size_t pos = 0;
    int64_t written = 0;
    const int64_t total = (int64_t)w * h;
    int x = 0, y = 0, step = interlace ? 8 : 1, pass = interlace ? 1 : 0;
    auto put = [&](uint8_t v) {
        if (y < h) out[(size_t)y * w + x] = v;
        ++written;
        if (++x < w) return;
        x = 0;
        y += step;
        while (pass && y >= h) {                    // the next interlace pass
            if (pass == 1) { y = 4; pass = 2; }
            else if (pass == 2) { y = 2; step = 4; pass = 3; }
            else if (pass == 3) { y = 1; step = 2; pass = 4; }
            else break;
        }
    };
    while (written < total) {
        while (have < codesize && pos < n) {
            acc |= (uint64_t)d[pos++] << have;
            have += 8;
        }
        if (have < codesize) break;                 // the data ends
        int code = (int)(acc & ((1u << codesize) - 1));
        acc >>= codesize;
        have -= codesize;
        if (code == clear) {
            codesize = bits + 1;
            next = clear + 2;
            prev = -1;
            continue;
        }
        if (code == end) break;
        int sp = 0, c = code;
        if (prev < 0) {
            if (code >= clear) fail("GIF: corrupt LZW data (first code is not a colour)");
            first = code;
            put((uint8_t)code);
            prev = code;
            continue;
        }
        if (code > next || (code == next && next >= 4096))
            fail("GIF: corrupt LZW data (code beyond the table)");
        if (code == next) {                             // the KwKwK case
            stack[sp++] = (uint8_t)first;
            c = prev;
        }
        while (c >= clear) {
            stack[sp++] = suffix[c];
            c = prefix[c];
        }
        stack[sp++] = (uint8_t)c;
        first = c;
        while (sp > 0 && written < total) put(stack[--sp]);
        if (next < 4096) {
            prefix[next] = (uint16_t)prev;
            suffix[next] = (uint8_t)first;
            if (next == (1 << codesize) - 1 && codesize < 12) ++codesize;
            ++next;
        }
        prev = code;
    }
    return written;
}

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
            j.decode_scans();
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

// PIL's RLE8 (rle4 = 0) or RLE4 decoding of a BMP from data[start:] into out
// (width * height index samples in the order of the file's rows); returns
// how many samples PIL's decoder would have produced (fewer than width *
// height: PIL refuses the file), or -1 with a message in err.
int64_t citlab_bmp_rle(const uint8_t* data, int64_t n, int64_t start, int32_t rle4,
                       int32_t width, int32_t height, uint8_t* out, char* err, int32_t errlen) {
    try {
        std::vector<uint8_t> samples;
        if (width <= 0 || height <= 0) fail("BMP: empty image");
        bmp_rle(data, (size_t)n, (size_t)start, rle4 != 0, width, height, samples);
        const size_t want = (size_t)width * height;
        std::memcpy(out, samples.data(), std::min(want, samples.size()));
        return (int64_t)samples.size();
    } catch (const std::exception& e) {
        copy_error(e.what(), err, errlen);
        return -1;
    }
}

// GIF LZW of one frame's image data (its sub-blocks joined) with the given
// minimum code size into out (width x height, left as it is where the
// data ends early); returns the pixels written, or -1 with a message in err.
int64_t citlab_gif_lzw(const uint8_t* data, int64_t n, int32_t min_code_size, int32_t width,
                       int32_t height, int32_t interlace, uint8_t* out, char* err,
                       int32_t errlen) {
    try {
        return gif_lzw(data, (size_t)n, min_code_size, width, height, interlace != 0, out);
    } catch (const std::exception& e) {
        copy_error(e.what(), err, errlen);
        return -1;
    }
}

}  // extern "C"
