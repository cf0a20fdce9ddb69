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
// default_decompress_parms for the colour space; the inverse DCT is the
// x86 SIMD one PIL's libjpeg-turbo runs. Damaged entropy-coded data is read
// as libjpeg-turbo reads it (see the JPEG section).
//
// TIFF: the first IFD of a classic or BigTIFF file, little- or big-endian,
// strips or tiles, PlanarConfiguration 1 or 2, FillOrder 1 or 2 (libtiff
// reverses the bits of every strip byte); no compression, PackBits, LZW,
// Deflate (inflated by the caller's function), CCITT modified Huffman,
// Group 3 (1-D and 2-D) and Group 4 as libtiff 4.7's tif_fax3.c decodes
// them, damaged rows included, and JPEG (one stream per strip or tile after the JPEGTables
// stream; YCbCr converted to RGB as libjpeg does when libtiff asks for
// JPEGCOLORMODE_RGB); old-style JPEG from its JPEGInterchangeFormat stream and
// YCbCr under the other codecs as libtiff's RGBA interface gives them (the
// chroma of each sampling unit on its pixels, tif_color.c's conversion);
// the horizontal predictor on 8-, 16- and 32-bit samples
// and the floating-point predictor (tif_predict.c fpAcc); 1-, 2-, 4-, 8-,
// 12-, 16- and 32-bit samples. The IFD is read as PIL reads it (an entry
// past the end of the file ends it), and what libtiff needs of it where
// libtiff decodes. The samples come out as stored (native byte
// order; a palette expanded to RGB): which layouts PIL opens, and how it
// reads them, is decided by the caller.
//
// Every variant outside that raises by name (the message says which). The
// code keeps no state between calls and writes only into the caller's
// buffers, so concurrent calls from threads are safe.
#include <algorithm>
#include <cmath>
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
//
// The reading follows libjpeg-turbo 3.1 as PIL drives it: jdmarker.c's
// marker reader (next_marker's skipping of stray bytes, read_restart_marker
// and jpeg_resync_to_restart after a damaged or missing RSTn), jdhuff.c's
// bit buffer (fill to 57 bits, stop at a marker; a code needed past a
// marker takes zero bits and leaves the rest of the segment's MCUs
// untouched: "insufficient data"), jdhuff.c / jdphuff.c / jdlhuff.c
// decoding with its recovery (a Huffman code longer than 16 bits decodes
// as 0 after 17 bits, a run past coefficient 63 lands on the 16 extra
// entries of jpeg_natural_order), and jdarith.c. PIL's source hands libjpeg
// the whole file and suspends at its end, which PIL reports as a truncated
// file, except after the last row of an image of one scan; libtiff's source
// (JPEG-in-TIFF) hands out a fake EOI marker instead.

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// the source ran out where PIL's decoder would suspend for more data
struct Truncated : DecodeError {
    Truncated() : DecodeError("JPEG: truncated file (PIL: image file is truncated)") {}
};

// a Huffman table as DHT defines it (bits, huffval zero-filled) and as
// jdhuff.c's jpeg_make_d_derived_tbl derives it at the start of a scan
struct Huffman {
    bool present = false;
    uint8_t bits[17] = {0};
    uint8_t vals[256] = {0};
    int32_t maxcode[18];
    int32_t valoffset[18];
    uint16_t lookup[256];   // HUFF_LOOKAHEAD = 8: (length << 8) | value, 9 << 8 if longer

    void define(const uint8_t* b, const uint8_t* v, int count) {
        std::memcpy(bits, b, 17);
        std::memset(vals, 0, sizeof(vals));
        std::memcpy(vals, v, count);
        present = true;
    }

    void derive(bool is_dc, bool lossless) {
        int huffsize[257], huffcode[257];
        int p = 0;
        for (int l = 1; l <= 16; ++l) {
            if (p + bits[l] > 256) fail("JPEG: bad Huffman table");
            for (int i = 0; i < bits[l]; ++i) huffsize[p++] = l;
        }
        huffsize[p] = 0;
        const int numsymbols = p;
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
        valoffset[17] = 0;
        maxcode[17] = 0xFFFFF;
        for (int i = 0; i < 256; ++i) lookup[i] = 9 << 8;
        p = 0;
        for (int l = 1; l <= 8; ++l)
            for (int i = 1; i <= bits[l]; ++i, ++p) {
                int lookbits = huffcode[p] << (8 - l);
                for (int c = 1 << (8 - l); c > 0; --c) lookup[lookbits++] = (uint16_t)((l << 8) | vals[p]);
            }
        if (is_dc)
            for (int i = 0; i < numsymbols; ++i)
                if (vals[i] > (lossless ? 16 : 15)) fail("JPEG: bad Huffman table");
    }
};

// jstdhuff.c: the tables of T.81 K.3 that libjpeg-turbo takes for a
// missing table 0 or 1 (Motion-JPEG streams carry none)
void std_huffman(Huffman& h, bool dc, int tbl) {
    static const uint8_t dc_bits[2][17] = {{0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
                                           {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
    static const uint8_t dc_vals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
    static const uint8_t ac_bits[2][17] = {
        {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
        {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
    static const uint8_t ac_vals[2][162] = {
        {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
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
         0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
        {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
         0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
         0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
         0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
         0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
         0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
         0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
         0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
         0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
         0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
         0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
         0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};
    if (dc) h.define(dc_bits[tbl], dc_vals, 12);
    else h.define(ac_bits[tbl], ac_vals[tbl], 162);
}

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

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int bw = 0, bh = 0;      // blocks (lossless: samples) per line / column, whole MCUs
    int dw = 0, dh = 0;      // downsampled width / height (real samples)
    int dc_tbl = 0, ac_tbl = 0, dc_pred = 0, dc_ctx = 0;
    bool quant_latched = false;
    uint16_t quant[64] = {0};
    int coef_bits[64];
    int prev_coef_bits[64] = {0};   // as they stood before the last scan of the component
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

    // the source (jdmarker.c's view of it) and the entropy decoder's state
    size_t pos = 0;
    bool tiff_source = false;   // libtiff's: a fake EOI marker at the end of the data
    int eoi_phase = 0;
    int unread_marker = 0, next_restart_num = 0;
    uint64_t get_buffer = 0;    // jdhuff.c's bit buffer
    int bits_left = 0;
    bool insufficient = false;
    int64_t arith_c = 0, arith_a = 0;   // jdarith.c's registers
    int arith_ct = -16;
    // jdmarker.c input_scan_number, and the last iMCU row an MCU of the
    // last scan began with data (jdcoefct.c last_good_iMCU_row)
    int scans_read = 0, last_good_imcu = 0;

    Jpeg(const uint8_t* data, size_t size) : d(data), n(size) {
        std::fill(dac_L, dac_L + 16, 0);
        std::fill(dac_U, dac_U + 16, 1);
        std::fill(dac_K, dac_K + 16, 5);
    }

    // ---- the source: INPUT_BYTE
    int byte() {
        if (pos < n) return d[pos++];
        if (!tiff_source) throw Truncated();
        return (eoi_phase ^= 1) ? 0xFF : 0xD9;
    }
    int input_u16() {
        int a = byte();
        return (a << 8) | byte();
    }
    // skip_input_data: past the end, PIL's source suspends and libtiff's
    // hands out its fake EOI
    void skip(int64_t k) {
        if (k <= 0) return;
        if ((uint64_t)k > n - std::min(pos, n)) {
            if (!tiff_source) throw Truncated();
            pos = n;
            eoi_phase = 0;
            return;
        }
        pos += (size_t)k;
    }

    // jdmarker.c next_marker: skips anything up to an FF, the FF fill
    // bytes, and FF 00 pairs
    void next_marker() {
        for (;;) {
            int c = byte();
            while (c != 0xFF) c = byte();
            do c = byte(); while (c == 0xFF);
            if (c != 0) {
                unread_marker = c;
                return;
            }
        }
    }

    // jdmarker.c read_restart_marker and jpeg_resync_to_restart
    void read_restart_marker() {
        if (unread_marker == 0) next_marker();
        if (unread_marker == 0xD0 + next_restart_num) {
            unread_marker = 0;
        } else {
            const int desired = next_restart_num;
            for (;;) {
                const int m = unread_marker;
                int action;
                if (m < 0xC0) action = 2;                      // not a valid marker
                else if (m < 0xD0 || m > 0xD7) action = 3;     // a marker that is no RSTn
                else if (m == 0xD0 + ((desired + 1) & 7) || m == 0xD0 + ((desired + 2) & 7))
                    action = 3;                                // one of the next two
                else if (m == 0xD0 + ((desired - 1) & 7) || m == 0xD0 + ((desired - 2) & 7))
                    action = 2;                                // a prior one: scan on
                else
                    action = 1;                                // too far away: discard it
                if (action == 1) {
                    unread_marker = 0;
                    break;
                }
                if (action == 3) break;                        // an empty segment follows
                next_marker();
            }
        }
        next_restart_num = (next_restart_num + 1) & 7;
    }

    // ---- jdhuff.c's bit buffer
    // jpeg_fill_bit_buffer: up to 57 bits, never past a marker; where more
    // bits are needed than are left before the marker, zeros (and the
    // "insufficient data" flag of the segment)
    void fill(int nbits) {
        if (unread_marker == 0) {
            while (bits_left < 57) {
                int c = byte();
                if (c == 0xFF) {
                    do c = byte(); while (c == 0xFF);
                    if (c == 0) {
                        c = 0xFF;
                    } else {
                        unread_marker = c;
                        break;
                    }
                }
                get_buffer = (get_buffer << 8) | (uint64_t)c;
                bits_left += 8;
            }
            if (unread_marker == 0) return;
        }
        if (nbits > bits_left) {
            insufficient = true;
            get_buffer <<= 57 - bits_left;
            bits_left = 57;
        }
    }
    void check(int nbits) {
        if (bits_left < nbits) fill(nbits);
    }
    int get_bits(int k) {
        bits_left -= k;
        return (int)(get_buffer >> bits_left) & ((1 << k) - 1);
    }
    int get_bit() {
        check(1);
        return get_bits(1);
    }
    // HUFF_DECODE and jpeg_huff_decode: a code longer than 16 bits gives 0
    int huff_decode(const Huffman& h) {
        int nb;
        if (bits_left < 8) {
            fill(0);
            if (bits_left < 8) return huff_slow(h, 1);
        }
        const int look = (int)(get_buffer >> (bits_left - 8)) & 0xFF;
        nb = h.lookup[look] >> 8;
        if (nb <= 8) {
            bits_left -= nb;
            return h.lookup[look] & 0xFF;
        }
        return huff_slow(h, nb);
    }
    int huff_slow(const Huffman& h, int l) {
        check(l);
        int32_t code = get_bits(l);
        while (code > h.maxcode[l]) {
            code <<= 1;
            check(1);
            code |= get_bits(1);
            ++l;
        }
        if (l > 16) return 0;
        return h.vals[(code + h.valoffset[l]) & 0xFF];
    }
    // the value of an s-bit difference (HUFF_EXTEND)
    int received(int s) {
        if (!s) return 0;
        check(s);
        return extend(get_bits(s), s);
    }

    // ---- jdarith.c arith_decode: bytes as needed, zeros once a marker is
    // met (legal in arithmetic coding); ct = -1 after a bad code
    int arith_decode(uint8_t* st) {
        while (arith_a < 0x8000) {
            if (--arith_ct < 0) {
                int data = 0;
                if (!unread_marker) {
                    data = byte();
                    if (data == 0xFF) {
                        do data = byte(); while (data == 0xFF);
                        if (data == 0) {
                            data = 0xFF;
                        } else {
                            unread_marker = data;
                            data = 0;
                        }
                    }
                }
                arith_c = (arith_c << 8) | data;
                if ((arith_ct += 8) < 0 && ++arith_ct == 0) arith_a = 0x8000;
            }
            arith_a <<= 1;
        }
        int sv = *st;
        int32_t qe = kAritab[sv & 0x7F];
        const int nl = qe & 0xFF, nm = (qe >> 8) & 0xFF;
        qe >>= 16;
        int64_t temp = arith_a - qe;
        arith_a = temp;
        temp <<= arith_ct;
        if (arith_c >= temp) {
            arith_c -= temp;
            if (arith_a < qe) {
                arith_a = qe;
                *st = (uint8_t)((sv & 0x80) ^ nm);
            } else {
                arith_a = qe;
                *st = (uint8_t)((sv & 0x80) ^ nl);
                sv ^= 0x80;
            }
        } else if (arith_a < 0x8000) {
            if (arith_a < qe) {
                *st = (uint8_t)((sv & 0x80) ^ nl);
                sv ^= 0x80;
            } else {
                *st = (uint8_t)((sv & 0x80) ^ nm);
            }
        }
        return sv >> 7;
    }

    // ---- markers (jdmarker.c read_markers and its get_* readers)
    int u16(size_t p) const {
        if (p + 2 > n) fail("JPEG: truncated header");
        return (d[p] << 8) | d[p + 1];
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
        if (nc != 1 && nc != 3 && nc != 4 && !(tiff_source && nc == 2))
            fail("JPEG: " + std::to_string(nc) +
                 "-component JPEG is not supported (PIL reads 1, 3 or 4 components)");
        if (decoding) {
            if ((marker >= 0xC5 && marker <= 0xC7) || marker >= 0xCD || marker == 0xC8)
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
            c.tq = d[p + 8 + 3 * i];
        }
    }

    // jdinput.c initial_setup (at the first SOS): the sampling factors, the
    // MCU geometry and the buffers
    void initial_setup() {
        if (width > 65500 || height > 65500) fail("JPEG: image too big for libjpeg");
        for (Component& c : comps) {
            if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail("JPEG: bad sampling factors");
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
            if (lossless)
                c.plane.assign((size_t)c.bw * c.bh, 0);
            else
                c.coef.assign((size_t)c.bw * c.bh * 64, 0);
            std::fill(c.coef_bits, c.coef_bits + 64, -1);
        }
    }

    void get_dht() {
        int64_t length = input_u16() - 2;
        while (length > 16) {
            int index = byte();
            uint8_t bits[17];
            bits[0] = 0;
            int count = 0;
            for (int i = 1; i <= 16; ++i) {
                bits[i] = (uint8_t)byte();
                count += bits[i];
            }
            length -= 17;
            if (count > 256 || count > length) fail("JPEG: bad Huffman table");
            uint8_t vals[256];
            for (int i = 0; i < count; ++i) vals[i] = (uint8_t)byte();
            length -= count;
            Huffman* tbl = (index & 0x10) ? ac : dc;
            index &= ~0x10;
            if (index < 0 || index >= 4) fail("JPEG: bad DHT table index");
            tbl[index].define(bits, vals, count);
        }
        if (length != 0) fail("JPEG: bad DHT length");
    }

    void get_dqt() {
        int64_t length = input_u16() - 2;
        while (length > 0) {
            --length;
            int v = byte();
            const int prec = v >> 4, tq = v & 15;
            if (tq >= 4) fail("JPEG: bad DQT table index");
            for (int i = 0; i < 64; ++i) qt[tq][kNatural[i]] = (uint16_t)(prec ? input_u16() : byte());
            qt_present[tq] = true;
            length -= prec ? 128 : 64;
        }
        if (length != 0) fail("JPEG: bad DQT length");
    }

    // jdmarker.c get_dac: Tc Tb, then the DC bounds (U << 4 | L) or Kx
    void get_dac() {
        int64_t length = input_u16() - 2;
        while (length > 0) {
            int index = byte(), val = byte();
            length -= 2;
            if (index >= 32) fail("JPEG: bad DAC table index");
            if (index >= 16) {
                dac_K[index - 16] = (uint8_t)val;
            } else {
                dac_L[index] = (uint8_t)(val & 15);
                dac_U[index] = (uint8_t)(val >> 4);
                if (dac_L[index] > dac_U[index]) fail("JPEG: bad DAC conditioning value");
            }
        }
        if (length != 0) fail("JPEG: bad DAC length");
    }

    // get_interesting_appn: the first 14 bytes of APP0 and APP14 examined
    void get_app(int marker) {
        int64_t length = input_u16() - 2;
        const int64_t take = length >= 14 ? 14 : length > 0 ? length : 0;
        uint8_t b[14];
        for (int64_t i = 0; i < take; ++i) b[i] = (uint8_t)byte();
        length -= take;
        if (marker == 0xE0 && take >= 14 && std::memcmp(b, "JFIF\0", 5) == 0) jfif = true;
        if (marker == 0xEE && take >= 12 && std::memcmp(b, "Adobe", 5) == 0) {
            adobe = true;
            adobe_transform = b[11];
        }
        skip(length);
    }

    void skip_variable() { skip(input_u16() - 2); }

    struct Scan {
        std::vector<int> comp;
        int ss = 0, se = 63, ah = 0, al = 0;
    };

    Scan get_sos() {
        if (!frame) fail("JPEG: scan before the frame header");
        const int length = input_u16();
        const int ns = byte();
        if (length != ns * 2 + 6 || ns < 1 || ns > 4) fail("JPEG: bad SOS");
        Scan sc;
        int cur[4] = {-1, -1, -1, -1};
        for (int i = 0; i < ns; ++i) {
            int cid = byte(), tbl = byte();
            int found = -1;
            for (int ci = 0; ci < (int)comps.size() && ci < 4; ++ci)
                if (comps[ci].id == cid && cur[ci] < 0) {
                    found = ci;
                    break;
                }
            if (found < 0) fail("JPEG: scan names an unknown component");
            // libjpeg-turbo: each component of a scan differs from the ones before
            for (int pi = 0; pi < i; ++pi)
                if (cur[pi] == found) fail("JPEG: a scan names one component twice");
            cur[i] = found;
            comps[found].dc_tbl = tbl >> 4;
            comps[found].ac_tbl = tbl & 15;
            sc.comp.push_back(found);
        }
        sc.ss = byte();
        sc.se = byte();
        int c = byte();
        sc.ah = c >> 4;
        sc.al = c & 15;
        next_restart_num = 0;
        ++scans_read;
        return sc;
    }

    // read_markers: up to the next SOS (returns true, the scan's header
    // read) or EOI (false)
    bool read_markers(Scan& sc) {
        for (;;) {
            if (unread_marker == 0) next_marker();
            const int m = unread_marker;
            if (m == 0xDA) {
                sc = get_sos();
                unread_marker = 0;
                return true;
            }
            if (m == 0xD9) {
                unread_marker = 0;
                return false;
            }
            if (m == 0xD8) {
                fail("JPEG: a second SOI marker");
            } else if (is_sof(m) || m == 0xC8) {
                if (m == 0xC8 || (m >= 0xC5 && m <= 0xC7) || m >= 0xCD)
                    fail("JPEG: hierarchical (differential) JPEG is not supported");
                if (frame) fail("JPEG: more than one frame (hierarchical JPEG)");
                const size_t at = pos;
                const int length = input_u16();
                if (at + length > n) throw Truncated();
                read_sof(at + 2, m, true);
                if (length - 8 != 3 * (int)comps.size()) fail("JPEG: bad SOF length");
                pos = at + length;
            } else if (m == 0xC4) {
                get_dht();
            } else if (m == 0xCC) {
                get_dac();
            } else if (m == 0xDB) {
                get_dqt();
            } else if (m == 0xDD) {
                if (input_u16() != 4) fail("JPEG: bad DRI length");
                restart_interval = input_u16();
            } else if (m == 0xE0 || m == 0xEE) {
                get_app(m);
            } else if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE || m == 0xDC) {
                skip_variable();
            } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
                // parameterless
            } else {
                fail("JPEG: unknown marker 0x" + std::to_string(m) + " (libjpeg refuses it)");
            }
            unread_marker = 0;
        }
    }

    static bool is_sof(int m) { return m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC; }

    // the marker at pos (skipping fill bytes and garbage), for the header
    // that PIL's open reads
    int header_marker(size_t& p) const {
        while (p < n) {
            if (d[p] != 0xFF) {
                ++p;
                continue;
            }
            while (p < n && d[p] == 0xFF) ++p;
            if (p >= n) break;
            int m = d[p++];
            if (m != 0) return m;
        }
        fail("JPEG: truncated file (no frame header)");
    }

    // header only: dimensions and output channels
    void parse_header() {
        if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) fail("JPEG: no SOI marker");
        size_t p = 2;
        while (true) {
            int m = header_marker(p);
            if (m == 0xD9 || m == 0xDA) fail("JPEG: no frame header before the scan");
            if (m >= 0xD0 && m <= 0xD7) continue;
            int len = u16(p);
            size_t body = p + 2, end = p + len;
            if (end > n) fail("JPEG: truncated marker segment");
            if (is_sof(m)) {
                read_sof(body, m, false);
                return;
            }
            p = end;
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
    int16_t* block(Component& c, int row, int col) {
        return &c.coef[((size_t)row * c.bw + col) * 64];
    }

    // the iMCU row of a scan's unit
    int imcu_of(const Scan& sc, int64_t u, int units_x) const {
        const int uy = (int)(u / units_x);
        return sc.comp.size() == 1 ? uy / comps[sc.comp[0]].v : uy;
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

    // jdhuff.c jpeg_make_d_derived_tbl at the start of a scan; the
    // sequential decoder (jinit_huff_decoder) takes the standard table for a
    // missing table 0 or 1, the progressive and lossless ones refuse
    const Huffman& derived(bool is_dc, int tbl) {
        if (tbl > 3) fail("JPEG: missing Huffman table");
        Huffman& h = (is_dc ? dc : ac)[tbl];
        if (!h.present) {
            if (tbl > 1 || progressive || lossless) fail("JPEG: missing Huffman table");
            std_huffman(h, is_dc, tbl);
        }
        h.derive(is_dc, lossless);
        return h;
    }

    void decode_scan(const Scan& sc) {
        if (sc.comp.size() > 1) {     // jdinput.c per_scan_setup
            int blocks = 0;
            for (int ci : sc.comp) blocks += comps[ci].h * comps[ci].v;
            if (blocks > 10) fail("JPEG: too many blocks in an MCU");
        }
        if (lossless) return decode_scan_lossless(sc);
        for (int ci : sc.comp) {      // jdinput.c latch_quant_tables
            Component& c = comps[ci];
            if (!c.quant_latched) {
                if (c.tq > 3 || !qt_present[c.tq]) fail("JPEG: missing quantization table");
                std::memcpy(c.quant, qt[c.tq], sizeof(c.quant));
                c.quant_latched = true;
            }
        }
        if (progressive) {
            // jdphuff.c / jdarith.c start_pass
            bool bad = sc.ss == 0 ? sc.se != 0
                                  : sc.se < sc.ss || sc.se > 63 || sc.comp.size() != 1;
            if (bad || (sc.ah != 0 && sc.al != sc.ah - 1) || sc.al > 13)
                fail("JPEG: bad progressive scan parameters");
            for (int ci : sc.comp) {
                Component& c = comps[ci];
                for (int k = std::min(sc.ss, 1); k <= std::max(sc.se, 9); ++k)
                    c.prev_coef_bits[k] = scans_read > 1 ? c.coef_bits[k] : 0;
                for (int k = sc.ss; k <= sc.se; ++k) c.coef_bits[k] = sc.al;
            }
        }
        if (arith) return decode_scan_arith(sc);
        // the scan's derived tables (jdhuff.c / jdphuff.c start_pass)
        std::vector<const Huffman*> dct(comps.size()), act(comps.size());
        for (int ci : sc.comp) {
            Component& c = comps[ci];
            if (!progressive || (sc.ss == 0 && sc.ah == 0)) dct[ci] = &derived(true, c.dc_tbl);
            if (!progressive) act[ci] = &derived(false, c.ac_tbl);
            else if (sc.ss > 0) act[ci] = &derived(false, c.ac_tbl);
            c.dc_pred = 0;
        }
        bits_left = 0;
        get_buffer = 0;
        insufficient = false;
        int eobrun = 0;
        const bool single = sc.comp.size() == 1;
        int units_x;
        const int64_t total = scan_units(sc, units_x);
        int64_t restarts_to_go = restart_interval;
        for (int64_t u = 0; u < total; ++u) {
            if (!insufficient) last_good_imcu = imcu_of(sc, u, units_x);
            if (restart_interval && restarts_to_go == 0) {
                // jdhuff.c / jdphuff.c process_restart
                bits_left = 0;
                read_restart_marker();
                for (int ci : sc.comp) comps[ci].dc_pred = 0;
                eobrun = 0;
                restarts_to_go = restart_interval;
                if (unread_marker == 0) insufficient = false;
            }
            // an MCU after the data ran into a marker is left as it is
            // (DC refinement reads its zero bits all the same)
            const bool dc_refine = progressive && sc.ss == 0 && sc.ah != 0;
            if (!insufficient || dc_refine) {
                const int ux = (int)(u % units_x), uy = (int)(u / units_x);
                if (single) {
                    Component& c = comps[sc.comp[0]];
                    decode_unit(sc, c, block(c, uy, ux), eobrun, dct[sc.comp[0]],
                                act[sc.comp[0]]);
                } else {
                    for (int ci : sc.comp) {
                        Component& c = comps[ci];
                        for (int by = 0; by < c.v; ++by)
                            for (int bx = 0; bx < c.h; ++bx)
                                decode_unit(sc, c, block(c, uy * c.v + by, ux * c.h + bx), eobrun,
                                            dct[ci], act[ci]);
                    }
                }
            }
            --restarts_to_go;
        }
    }

    void decode_unit(const Scan& sc, Component& c, int16_t* blk, int& eobrun,
                     const Huffman* hd, const Huffman* ha) {
        if (!progressive) {                // jdhuff.c decode_mcu_slow
            c.dc_pred = (int)((unsigned)received(huff_decode(*hd)) + (unsigned)c.dc_pred);
            blk[0] = (int16_t)c.dc_pred;
            for (int k = 1; k < 64; ++k) {
                int rs = huff_decode(*ha);
                int r = rs >> 4, s = rs & 15;
                if (s) {
                    k += r;
                    blk[kNatural[k]] = (int16_t)received(s);
                } else {
                    if (r != 15) break;
                    k += 15;
                }
            }
            return;
        }
        if (sc.ss == 0) {                  // DC scans
            if (sc.ah == 0) {
                const int s = received(huff_decode(*hd));
                const int last = c.dc_pred;
                if ((last >= 0 && s > INT32_MAX - last) || (last < 0 && s < INT32_MIN - last))
                    fail("JPEG: corrupt DC coefficient (libjpeg: bad DCT coefficient)");
                c.dc_pred = last + s;
                blk[0] = (int16_t)(uint16_t)((unsigned)c.dc_pred << sc.al);
            } else if (get_bit()) {
                blk[0] = (int16_t)(blk[0] | (1 << sc.al));
            }
            return;
        }
        if (sc.ah == 0) {                  // AC first
            if (eobrun > 0) {
                --eobrun;
                return;
            }
            for (int k = sc.ss; k <= sc.se; ++k) {
                int rs = huff_decode(*ha);
                int r = rs >> 4, s = rs & 15;
                if (s) {
                    k += r;
                    int v = received(s);
                    blk[kNatural[k]] = (int16_t)(uint16_t)((unsigned)v << sc.al);
                } else if (r == 15) {
                    k += 15;
                } else {
                    eobrun = 1 << r;
                    if (r) {
                        check(r);
                        eobrun += get_bits(r);
                    }
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
                int rs = huff_decode(*ha);
                int r = rs >> 4, s = rs & 15;
                if (s) {
                    s = get_bit() ? p1 : m1;
                } else if (r != 15) {
                    eobrun = 1 << r;
                    if (r) {
                        check(r);
                        eobrun += get_bits(r);
                    }
                    break;
                }
                do {
                    int16_t* coef = blk + kNatural[k];
                    if (*coef != 0) {
                        if (get_bit() && (*coef & p1) == 0)
                            *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
                    } else if (--r < 0) {
                        break;
                    }
                    ++k;
                } while (k <= sc.se);
                if (s) blk[kNatural[k]] = (int16_t)s;
            }
        }
        if (eobrun > 0) {
            for (; k <= sc.se; ++k) {
                int16_t* coef = blk + kNatural[k];
                if (*coef != 0 && get_bit() && (*coef & p1) == 0)
                    *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
            }
            --eobrun;
        }
    }

    // ---- arithmetic decoding (jdarith.c, T.81 annex F.2.4 and G.2)

    // Figures F.19-F.24: one DC difference into c.dc_pred (mod 2^16) and
    // the conditioning category c.dc_ctx; false after a bad code
    bool arith_dc(Component& c) {
        const int tbl = c.dc_tbl;
        uint8_t* st = dc_stats[tbl] + c.dc_ctx;
        if (arith_decode(st) == 0) {
            c.dc_ctx = 0;
            return true;
        }
        const int sign = arith_decode(st + 1);
        st += 2 + sign;
        int m = arith_decode(st);
        if (m != 0) {
            st = dc_stats[tbl] + 20;
            while (arith_decode(st)) {
                if ((m <<= 1) == 0x8000) {
                    arith_ct = -1;              // magnitude overflow
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
            if (arith_decode(st)) v |= m;
        v += 1;
        if (sign) v = -v;
        c.dc_pred = (c.dc_pred + v) & 0xFFFF;
        return true;
    }

    // Figure F.20: the AC coefficients ss..se of one block, scaled by al;
    // false after a bad code
    bool arith_ac(int tbl, int16_t* blk, int ss, int se, int al) {
        uint8_t* stats = ac_stats[tbl];
        for (int k = ss; k <= se; ++k) {
            uint8_t* st = stats + 3 * (k - 1);
            if (arith_decode(st)) break;        // EOB
            while (arith_decode(st + 1) == 0) {
                st += 3;
                if (++k > se) {
                    arith_ct = -1;              // spectral overflow
                    return false;
                }
            }
            const int sign = arith_decode(fixed_bin);
            st += 2;
            int m = arith_decode(st);
            if (m != 0 && arith_decode(st)) {
                m <<= 1;
                st = stats + (k <= dac_K[tbl] ? 189 : 217);
                while (arith_decode(st)) {
                    if ((m <<= 1) == 0x8000) {
                        arith_ct = -1;          // magnitude overflow
                        return false;
                    }
                    st += 1;
                }
            }
            int v = m;
            st += 14;
            while (m >>= 1)
                if (arith_decode(st)) v |= m;
            v += 1;
            if (sign) v = -v;
            blk[kNatural[k]] = (int16_t)(uint16_t)((unsigned)v << al);
        }
        return true;
    }

    // jdarith.c decode_mcu_AC_refine: one more bit of the band's
    // coefficients; false after a bad code
    bool arith_ac_refine(int tbl, int16_t* blk, int ss, int se, int al) {
        uint8_t* stats = ac_stats[tbl];
        const int p1 = 1 << al, m1 = -1 * (1 << al);
        int kex = se;                           // end of block of the previous stage
        for (; kex > 0; --kex)
            if (blk[kNatural[kex]]) break;
        for (int k = ss; k <= se; ++k) {
            uint8_t* st = stats + 3 * (k - 1);
            if (k > kex && arith_decode(st)) break;   // EOB
            for (;;) {
                int16_t* coef = blk + kNatural[k];
                if (*coef) {
                    if (arith_decode(st + 2))
                        *coef = (int16_t)(*coef < 0 ? *coef + m1 : *coef + p1);
                    break;
                }
                if (arith_decode(st + 1)) {
                    *coef = (int16_t)(arith_decode(fixed_bin) ? m1 : p1);
                    break;
                }
                st += 3;
                if (++k > se) {
                    arith_ct = -1;              // spectral overflow
                    return false;
                }
            }
        }
        return true;
    }

    // the statistics of the scan's tables to zero, DC predictions too, and
    // the registers (jdarith.c start_pass / process_restart)
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
        arith_c = 0;
        arith_a = 0;
        arith_ct = -16;
    }

    // one block of an arithmetic-coded scan; false after a bad code
    bool arith_unit(const Scan& sc, Component& c, int16_t* blk) {
        if (!progressive) {
            if (!arith_dc(c)) return false;
            blk[0] = (int16_t)(uint16_t)c.dc_pred;
            return arith_ac(c.ac_tbl, blk, 1, 63, 0);
        }
        if (sc.ss == 0 && sc.ah == 0) {
            if (!arith_dc(c)) return false;
            blk[0] = (int16_t)(uint16_t)((unsigned)c.dc_pred << sc.al);
            return true;
        }
        if (sc.ss == 0) {
            if (arith_decode(fixed_bin)) blk[0] = (int16_t)(blk[0] | (1 << sc.al));
            return true;
        }
        if (sc.ah == 0) return arith_ac(c.ac_tbl, blk, sc.ss, sc.se, sc.al);
        return arith_ac_refine(c.ac_tbl, blk, sc.ss, sc.se, sc.al);
    }

    void decode_scan_arith(const Scan& sc) {
        const bool dc_refine = progressive && sc.ss == 0 && sc.ah != 0;
        reset_arith(sc);
        const bool single = sc.comp.size() == 1;
        int units_x;
        const int64_t total = scan_units(sc, units_x);
        int64_t until_restart = restart_interval;
        for (int64_t u = 0; u < total; ++u) {
            last_good_imcu = imcu_of(sc, u, units_x);
            if (restart_interval) {
                if (until_restart == 0) {
                    read_restart_marker();
                    reset_arith(sc);
                    until_restart = restart_interval;
                }
                --until_restart;
            }
            // after a bad code every MCU is skipped (the DC refinement
            // procedure does not check)
            if (arith_ct == -1 && !dc_refine) continue;
            int ux = (int)(u % units_x), uy = (int)(u / units_x);
            if (single) {
                Component& c = comps[sc.comp[0]];
                arith_unit(sc, c, block(c, uy, ux));
                continue;
            }
            bool ok = true;
            for (size_t i = 0; ok && i < sc.comp.size(); ++i) {
                Component& c = comps[sc.comp[i]];
                for (int by = 0; ok && by < c.v; ++by)
                    for (int bx = 0; ok && bx < c.h; ++bx)
                        ok = arith_unit(sc, c, block(c, uy * c.v + by, ux * c.h + bx));
            }
        }
    }

    // ---- lossless (jdlossls.c, jddiffct.c, jdlhuff.c; T.81 annex H)

    void decode_scan_lossless(const Scan& sc) {
        const int psv = sc.ss, pt = sc.al;
        if (psv < 1 || psv > 7 || sc.se != 0 || sc.ah != 0 || pt >= precision)
            fail("JPEG: bad lossless scan parameters (predictor " + std::to_string(psv) +
                 ", point transform " + std::to_string(pt) + ")");
        std::vector<const Huffman*> dct(comps.size());
        for (int ci : sc.comp) dct[ci] = &derived(true, comps[ci].dc_tbl);
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
        bits_left = 0;
        get_buffer = 0;
        insufficient = false;
        int rows_to_go = restart_rows;
        for (int imcu = 0; imcu < mcuy; ++imcu) {
            // MCU rows of the iMCU row: one of an interleaved scan, the
            // component's rows of a scan of one component
            const Component& c0 = comps[sc.comp[0]];
            const int mcu_rows = !single ? 1 : imcu < mcuy - 1 ? c0.v : last_rows(c0);
            for (int yoff = 0; yoff < mcu_rows; ++yoff) {
                if (restart_interval && rows_to_go == 0) {
                    // jdlhuff.c / jddiffct.c process_restart: the first-row
                    // predictor again
                    bits_left = 0;
                    read_restart_marker();
                    if (unread_marker == 0) insufficient = false;
                    std::fill(first_row.begin(), first_row.end(), 1);
                    rows_to_go = restart_rows;
                }
                if (insufficient) {
                    // jdlhuff.c decode_mcus: zero differences, and the
                    // undifferencer restarted (the first-row predictor)
                    for (int ci : sc.comp) {
                        const Component& c = comps[ci];
                        const int y0 = single ? yoff : 0, y1 = single ? yoff + 1 : c.v;
                        for (int y = y0; y < y1; ++y)
                            std::fill(&diff[ci][(size_t)y * c.bw], &diff[ci][(size_t)y * c.bw] + c.bw, 0);
                    }
                    std::fill(first_row.begin(), first_row.end(), 1);
                } else {
                    for (int mcu = 0; mcu < mcus_per_row; ++mcu) {
                        if (single) {
                            const int ci = sc.comp[0];
                            diff[ci][(size_t)yoff * comps[ci].bw + mcu] = lossless_diff(*dct[ci]);
                            continue;
                        }
                        for (int ci : sc.comp) {
                            const Component& c = comps[ci];
                            for (int y = 0; y < c.v; ++y)
                                for (int x = 0; x < c.h; ++x)
                                    diff[ci][(size_t)y * c.bw + mcu * c.h + x] = lossless_diff(*dct[ci]);
                        }
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
    }

    // rows of a component in the last iMCU row
    int last_rows(const Component& c) const {
        int r = c.dh % c.v;
        return r ? r : c.v;
    }

    // H.2.2: one sample difference (category 16 is 32768, no extra bits)
    int32_t lossless_diff(const Huffman& h) {
        int s = huff_decode(h);
        if (s == 16) return 32768;
        return received(s);
    }

    // PIL's decoding of the file: libjpeg's markers from SOI on, each scan
    // as it comes. A file of one scan is whole once its scan is decoded (a
    // missing EOI after it is no fault); a file of several is read to EOI
    // before any row is output
    void decode_scans() {
        pos = 0;
        if (byte() != 0xFF || byte() != 0xD8) fail("JPEG: no SOI marker");
        bool scanned = false, several = false;
        Scan sc;
        for (;;) {
            bool at_sos;
            try {
                at_sos = read_markers(sc);
            } catch (const Truncated&) {
                if (scanned && !several) return;
                throw;
            } catch (const DecodeError&) {
                // libtiff's JPEGDecode takes the rows of a stream of one scan
                // and ignores what jpeg_finish_decompress then fails on
                if (tiff_source && scanned && !several) return;
                throw;
            }
            if (!at_sos) break;
            if (!scanned) {
                initial_setup();
                // jdcolor.c: the samples of a lossless file are not colour-converted
                if (lossless && ((comps.size() == 3 && !rgb_colorspace()) || ycck()))
                    fail("JPEG: lossless YCbCr or YCCK (libjpeg: unsupported color conversion "
                         "request)");
                several = sc.comp.size() < comps.size() || progressive;
            } else if (!several) {
                fail("JPEG: a second scan in a file of one scan (libjpeg: EOI expected)");
            }
            decode_scan(sc);
            scanned = true;
        }
        if (!scanned) fail("JPEG: no image data");
    }

    // ---- the inverse DCT PIL runs on x86-64: libjpeg-turbo's
    // jsimd_idct_islow_avx2 (jidctint-avx2.asm; the SSE2 version computes
    // the same). It is jidctint.c's algorithm in 16-bit lanes: coefficients
    // dequantized modulo 2^16, sums of two inputs in 16 bits, products and
    // sums in 32 bits, each pass's results saturated to 16 bits and the
    // samples to 8 (where jidctint.c's range-limit table wraps); and a block
    // whose rows 1-7 are all zero takes the DC shortcut in 16 bits. On the
    // coefficients of an undamaged file the two agree.
    static void simd_pass(const int16_t* in, int16_t* out, int shift) {
        auto w16 = [](uint32_t v) { return (uint32_t)(int32_t)(int16_t)(uint16_t)v; };
        auto mul = [](int16_t a, int32_t k) { return (uint32_t)((int32_t)a * k); };
        const uint32_t tmp3 = mul(in[2], 10703) + mul(in[6], 4433);
        const uint32_t tmp2 = mul(in[6], -10704) + mul(in[2], 4433);
        const uint32_t tmp0 = w16((uint32_t)in[0] + (uint32_t)in[4]) * 8192u;
        const uint32_t tmp1 = w16((uint32_t)in[0] - (uint32_t)in[4]) * 8192u;
        const uint32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        const uint32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        const int16_t z3 = (int16_t)(uint16_t)w16((uint32_t)in[7] + (uint32_t)in[3]);
        const int16_t z4 = (int16_t)(uint16_t)w16((uint32_t)in[5] + (uint32_t)in[1]);
        const uint32_t z3p = mul(z3, -6436) + mul(z4, 9633);
        const uint32_t z4p = mul(z4, 6437) + mul(z3, 9633);
        const uint32_t t0 = mul(in[7], -4927) + mul(in[1], -7373) + z3p;
        const uint32_t t1 = mul(in[5], -4176) + mul(in[3], -20995) + z4p;
        const uint32_t t3 = mul(in[7], -7373) + mul(in[1], 4926) + z4p;
        const uint32_t t2 = mul(in[5], -20995) + mul(in[3], 4177) + z3p;
        const uint32_t o[8] = {tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                               tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3};
        for (int i = 0; i < 8; ++i) {
            const int32_t v = (int32_t)(o[i] + (1u << (shift - 1))) >> shift;
            out[i] = (int16_t)std::min(32767, std::max(-32768, v));
        }
    }

    static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
        int16_t ws[64], col[8], res[8];
        bool ac = false;
        for (int i = 8; i < 64; ++i) ac = ac || in[i] != 0;
        if (!ac) {
            for (int c = 0; c < 8; ++c) {
                const int16_t v = (int16_t)(uint16_t)((uint32_t)(uint16_t)in[c] * q[c] << 2);
                for (int r = 0; r < 8; ++r) ws[8 * r + c] = v;
            }
        } else {
            for (int c = 0; c < 8; ++c) {
                for (int k = 0; k < 8; ++k)
                    col[k] = (int16_t)(uint16_t)((uint32_t)(uint16_t)in[8 * k + c] * q[8 * k + c]);
                simd_pass(col, res, 11);
                for (int r = 0; r < 8; ++r) ws[8 * r + c] = res[r];
            }
        }
        for (int r = 0; r < 8; ++r) {
            simd_pass(ws + 8 * r, res, 18);
            uint8_t* op = out + (size_t)r * stride;
            for (int c = 0; c < 8; ++c)
                op[c] = (uint8_t)(std::min(127, std::max(-128, (int)res[c])) + 128);
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
        // the coefficient bits libjpeg latched, and those before the last
        // scan, which hold for the iMCU rows past the last one of that scan
        // that began with data
        int prev[10];
        prev[0] = c.coef_bits[0];
        for (int k = 1; k < 10; ++k) prev[k] = scans_read > 1 ? c.prev_coef_bits[k] : -1;
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
            const int* cb = imcu > last_good_imcu ? prev : c.coef_bits;
            bool change_dc = true;
            for (int k = 1; k < 10; ++k) change_dc = change_dc && cb[k] == -1;
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
        if (!(nc == 3 && !rgb_colorspace()) && !(nc == 4 && ycck())) {
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

// CCITT modified Huffman, Group 3 (T.4, 1-D and 2-D) and Group 4 (T.6) as
// libtiff 4.7's tif_fax3.c decodes a strip, damaged data included: its
// state tables (tif_fax3sm.c, built here from the T.4 codes as mkg3states
// builds them: an invalid code matches an entry of width 0), its bit
// reader (bytes bit-reversed into an accumulator, zeros padded where the
// data ends with bits left), and its row expanders (EXPAND1D, EXPAND2D,
// SYNC_EOL, CLEANUP_RUNS and _TIFFFax3fillruns): a bad code ends the row
// (its runs completed with white) and decoding goes on with the next.
enum FaxState : uint8_t { S_Null = 0, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW,
                          S_TermB, S_MakeUpW, S_MakeUpB, S_MakeUp, S_EOL };

struct FaxEnt {
    uint8_t state = S_Null, width = 0;
    uint32_t param = 0;
};

struct FaxTables {
    FaxEnt main[128], white[4096], black[8192];

    // every index of a (1 << bits)-entry table whose low bits are the
    // code, bit-reversed (the decoder reads codes least significant first)
    static void add(FaxEnt* t, int bits, const char* code, uint8_t state, uint32_t param) {
        const int len = (int)std::strlen(code);
        int rev = 0;
        for (int k = 0; k < len; ++k) rev |= (code[k] - '0') << k;
        for (int idx = rev; idx < (1 << bits); idx += 1 << len) {
            t[idx].state = state;
            t[idx].width = (uint8_t)len;
            t[idx].param = param;
        }
    }

    FaxTables() {
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
        add(white, 12, "00000000000", S_EOL, 0);
        add(black, 13, "00000000000", S_EOL, 0);
        for (int i = 0; i < 64; ++i) {
            add(white, 12, kWhiteTerm[i], S_TermW, i);
            add(black, 13, kBlackTerm[i], S_TermB, i);
        }
        for (int i = 0; i < 27; ++i) {
            add(white, 12, kWhiteMakeup[i], S_MakeUpW, 64 * (i + 1));
            add(black, 13, kBlackMakeup[i], S_MakeUpB, 64 * (i + 1));
        }
        for (int i = 0; i < 13; ++i) {
            add(white, 12, kExtMakeup[i], S_MakeUp, 1792 + 64 * i);
            add(black, 13, kExtMakeup[i], S_MakeUp, 1792 + 64 * i);
        }
        static const struct { const char* code; uint8_t state; uint32_t param; } kMain[] = {
            {"1", S_V0, 0},       {"011", S_VR, 1},   {"000011", S_VR, 2}, {"0000011", S_VR, 3},
            {"010", S_VL, 1},     {"000010", S_VL, 2}, {"0000010", S_VL, 3}, {"0001", S_Pass, 0},
            {"001", S_Horiz, 0},  {"0000001", S_Ext, 0}, {"0000000", S_EOL, 0}};
        for (const auto& m : kMain) add(main, 7, m.code, m.state, m.param);
    }
};

inline uint8_t reverse_bits(uint8_t b);

// one strip of CCITT data (tif_fax3.c Fax3PreDecode, then Fax3DecodeRLE,
// Fax3Decode1D, Fax3Decode2D or Fax4Decode with the whole strip asked for)
struct FaxDecoder {
    enum Kind { RLE, G3_1D, G3_2D, G4 };
    const FaxTables& T;
    const uint8_t* strip;
    const uint8_t* cp;
    const uint8_t* ep;
    bool& noeol;                        // FAXMODE_NOEOL, for the rest of the image
    uint32_t acc = 0;
    int avail = 0, EOLcnt = 0;
    int32_t lastx;
    size_t nruns;
    std::vector<uint32_t>& runs;        // libtiff's run arrays: kept from strip to strip
    uint32_t *curruns, *refruns = nullptr;
    // the row being expanded
    uint32_t *thisrun = nullptr, *pa = nullptr, *pb = nullptr;
    int32_t a0 = 0, RunLength = 0, b1 = 0;
    int rows_done = 0;

    FaxDecoder(const FaxTables& t, const uint8_t* data, size_t n, uint32_t width, bool ref_line,
               bool& no_eol, std::vector<uint32_t>& run_arrays)
        : T(t), strip(data), cp(data), ep(data + n), noeol(no_eol), lastx((int32_t)width),
          runs(run_arrays) {
        nruns = (((size_t)width + 1 + 31) / 32) * 32 * (ref_line ? 2 : 1);
        if (runs.size() != 2 * nruns) runs.assign(2 * nruns, 0);
        curruns = runs.data();
        if (ref_line) {
            refruns = runs.data() + nruns;      // the white line above the first
            refruns[0] = width;
            refruns[1] = 0;
        }
    }

    // NeedBits8 / NeedBits16: false where no bit is left
    bool need8(int n) {
        if (avail < n) {
            if (cp >= ep) {
                if (avail == 0) return false;
                avail = n;
            } else {
                acc |= (uint32_t)reverse_bits(*cp++) << avail;
                avail += 8;
            }
        }
        return true;
    }
    bool need16(int n) {
        if (avail < n) {
            if (cp >= ep) {
                if (avail == 0) return false;
                avail = n;
            } else {
                acc |= (uint32_t)reverse_bits(*cp++) << avail;
                if ((avail += 8) < n) {
                    if (cp >= ep) {
                        avail = n;
                    } else {
                        acc |= (uint32_t)reverse_bits(*cp++) << avail;
                        avail += 8;
                    }
                }
            }
        }
        return true;
    }
    uint32_t get(int n) const { return acc & ((1u << n) - 1); }
    void clr(int n) {
        avail -= n;
        acc >>= n;
    }
    const FaxEnt* lookup(const FaxEnt* tab, int bits) {
        const FaxEnt* e = tab + get(bits);
        clr(e->width);
        return e;
    }

    [[noreturn]] static void overflow() { fail("TIFF: damaged CCITT data (libtiff: buffer overflow)"); }
    void setvalue(int32_t x) {
        if (pa >= thisrun + nruns) overflow();
        *pa++ = (uint32_t)(RunLength + x);
        a0 += x;
        RunLength = 0;
    }
    void cleanup_runs() {
        if (RunLength) setvalue(0);
        if (a0 != lastx) {
            while (a0 > lastx && pa > thisrun) a0 -= (int32_t)*--pa;
            if (a0 < lastx) {
                if (a0 < 0) a0 = 0;
                if ((pa - thisrun) & 1) setvalue(0);
                setvalue(lastx - a0);
            } else if (a0 > lastx) {
                setvalue(lastx);
                setvalue(0);
            }
        }
    }

    // EXPAND1D: false at a premature end of the data (the runs cleaned up)
    bool expand1d() {
        for (;;) {
            for (;;) {
                if (!need16(12)) goto eof;
                const FaxEnt* e = lookup(T.white, 12);
                if (e->state == S_EOL) { EOLcnt = 1; goto done; }
                if (e->state == S_TermW) { setvalue((int32_t)e->param); break; }
                if (e->state == S_MakeUpW || e->state == S_MakeUp) {
                    a0 += (int32_t)e->param;
                    RunLength += (int32_t)e->param;
                    continue;
                }
                goto done;                                      // unexpected code
            }
            if (a0 >= lastx) goto done;
            for (;;) {
                if (!need16(13)) goto eof;
                const FaxEnt* e = lookup(T.black, 13);
                if (e->state == S_EOL) { EOLcnt = 1; goto done; }
                if (e->state == S_TermB) { setvalue((int32_t)e->param); break; }
                if (e->state == S_MakeUpB || e->state == S_MakeUp) {
                    a0 += (int32_t)e->param;
                    RunLength += (int32_t)e->param;
                    continue;
                }
                goto done;
            }
            if (a0 >= lastx) goto done;
            if (*(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;
        }
    eof:
        cleanup_runs();
        return false;
    done:
        cleanup_runs();
        return true;
    }

    void check_b1() {
        if (pa != thisrun)
            while (b1 <= a0 && b1 < lastx) {
                if (pb + 1 >= refruns + nruns) overflow();
                b1 += (int32_t)(pb[0] + pb[1]);
                pb += 2;
            }
    }

    // one run of horizontal mode: false at the end of the data, the state
    // of a bad code in *bad
    bool horiz_run(bool black, bool& bad) {
        for (;;) {
            if (!need16(black ? 13 : 12)) return false;
            const FaxEnt* e = lookup(black ? T.black : T.white, black ? 13 : 12);
            if (e->state == (black ? S_TermB : S_TermW)) {
                setvalue((int32_t)e->param);
                return true;
            }
            if (e->state == (black ? S_MakeUpB : S_MakeUpW) || e->state == S_MakeUp) {
                a0 += (int32_t)e->param;
                RunLength += (int32_t)e->param;
                continue;
            }
            bad = true;
            return true;
        }
    }

    // EXPAND2D: false at a premature end of the data (the runs cleaned up)
    bool expand2d() {
        while (a0 < lastx) {
            if (pa >= thisrun + nruns) overflow();
            if (!need8(7)) goto eof;
            const FaxEnt* e = lookup(T.main, 7);
            switch (e->state) {
                case S_Pass:
                    check_b1();
                    if (pb + 1 >= refruns + nruns) overflow();
                    b1 += (int32_t)*pb++;
                    RunLength += b1 - a0;
                    a0 = b1;
                    b1 += (int32_t)*pb++;
                    break;
                case S_Horiz: {
                    bool bad = false;
                    const bool black_first = (pa - thisrun) & 1;
                    if (!horiz_run(black_first, bad)) goto eof;
                    if (bad) goto eol;
                    if (!horiz_run(!black_first, bad)) goto eof;
                    if (bad) goto eol;
                    check_b1();
                    break;
                }
                case S_V0:
                    check_b1();
                    setvalue(b1 - a0);
                    if (pb >= refruns + nruns) overflow();
                    b1 += (int32_t)*pb++;
                    break;
                case S_VR:
                    check_b1();
                    setvalue(b1 - a0 + (int32_t)e->param);
                    if (pb >= refruns + nruns) overflow();
                    b1 += (int32_t)*pb++;
                    break;
                case S_VL:
                    check_b1();
                    if (b1 < (int32_t)(a0 + e->param)) goto eol;
                    setvalue(b1 - a0 - (int32_t)e->param);
                    b1 -= (int32_t)*--pb;
                    break;
                case S_Ext:
                    *pa++ = (uint32_t)(lastx - a0);
                    goto eol;
                case S_EOL:
                    *pa++ = (uint32_t)(lastx - a0);
                    if (!need8(4)) goto eof;
                    clr(4);
                    EOLcnt = 1;
                    goto eol;
                default:
                    goto eol;
            }
        }
        if (RunLength) {
            if (RunLength + a0 < lastx) {
                if (!need8(1)) goto eof;
                if (!get(1)) goto eol;
                clr(1);
            }
            setvalue(0);
        }
    eol:
        cleanup_runs();
        return true;
    eof:
        cleanup_runs();
        return false;
    }

    // SYNC_EOL: false where the data ends before an EOL; where it ends
    // within the EOL's zeros, libtiff (tryG3WithoutEOL) sets FAXMODE_NOEOL,
    // which holds for the rest of the image, and reads the strip's data
    // again from its start for the current row on, without EOLs
    bool sync_eol() {
        if (noeol) return true;
        if (EOLcnt == 0) {
            for (;;) {
                if (!need16(11)) return false;
                if (get(11) == 0) break;
                clr(1);
            }
        }
        for (;;) {
            if (!need8(8)) {
                noeol = true;
                cp = strip;
                acc = 0;
                avail = 0;
                EOLcnt = 0;
                return true;
            }
            if (get(8)) break;
            clr(8);
        }
        while (get(1) == 0) clr(1);
        clr(1);
        EOLcnt = 0;
        return true;
    }

    // _TIFFFax3fillruns: white runs clear bits, black runs set them
    void fill(uint8_t* buf, uint32_t* rl, uint32_t* erun) {
        if ((erun - rl) & 1) *erun++ = 0;
        uint32_t x = 0;
        for (; rl < erun; rl += 2) {
            for (int k = 0; k < 2; ++k) {
                uint32_t run = rl[k];
                if (x + run > (uint32_t)lastx || run > (uint32_t)lastx)
                    run = rl[k] = (uint32_t)lastx - x;
                for (uint32_t i = 0; i < run; ++i) {
                    const uint32_t px = x + i;
                    if (k) buf[px >> 3] |= (uint8_t)(0x80 >> (px & 7));
                    else buf[px >> 3] &= (uint8_t)~(0x80 >> (px & 7));
                }
                x += rl[k];
            }
        }
    }

    // the strip's rows (rowbytes each) into buf; libtiff's result: 1, or -1
    int decode(Kind kind, uint8_t* buf, uint32_t rows, size_t rowbytes) {
        for (uint32_t y = 0; y < rows; ++y, buf += rowbytes) {
            a0 = 0;
            RunLength = 0;
            thisrun = pa = curruns;
            bool ok = true;
            if (kind == RLE) {
                ok = expand1d();
                fill(buf, thisrun, pa);
                if (!ok) return -1;
                clr(avail - (avail & ~7));              // FAXMODE_BYTEALIGN
            } else if (kind == G3_1D) {
                if (!sync_eol()) {
                    cleanup_runs();
                    fill(buf, thisrun, pa);
                    return -1;
                }
                ok = expand1d();
                fill(buf, thisrun, pa);
                if (!ok) return -1;
            } else if (kind == G3_2D) {
                if (!sync_eol() || !need8(1)) {
                    cleanup_runs();
                    fill(buf, thisrun, pa);
                    return -1;
                }
                const bool is1d = get(1);
                clr(1);
                pb = refruns;
                b1 = (int32_t)*pb++;
                ok = is1d ? expand1d() : expand2d();
                fill(buf, thisrun, pa);
                if (!ok) return -1;
                if (pa < thisrun + nruns) setvalue(0);
                std::swap(curruns, refruns);
            } else {
                pb = refruns;
                b1 = (int32_t)*pb++;
                ok = expand2d();
                if (ok && !EOLcnt) {
                    fill(buf, thisrun, pa);
                    setvalue(0);
                    std::swap(curruns, refruns);
                    ++rows_done;
                    continue;
                }
                // EOFB or the end of the data: the row, and no more
                if (need16(13)) clr(13);
                fill(buf, thisrun, pa);
                rows_done = (int)y + 1;
                return y > 0 ? 1 : -1;
            }
            ++rows_done;
        }
        return 1;
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
    size_t ifd_at = 0;       // where the first IFD is
    bool keep_indices = false;   // decode: a palette image's indices, not its colours
    bool rps_set = false;        // libtiff's view: RowsPerStrip read from the directory
    mutable bool fax_noeol = false;   // libtiff's FAXMODE_NOEOL, once set for an image
    // libtiff's run arrays of the CCITT decoder, allocated once for the
    // image (a damaged row may read entries an earlier strip left there)
    mutable std::vector<uint32_t> fax_runs;
    size_t n_sf = 0, jpegtables_at = 0, jpegtables_len = 0, ojpeg_at = 0, ojpeg_len = 0;
    uint32_t ycc_h = 2, ycc_v = 2;   // YCbCrSubsampling (libtiff's default)
    // YCbCrCoefficients and ReferenceBlackWhite as libtiff reads them (floats;
    // the defaults of a YCbCr image where absent or unreadable)
    float ycc_luma[3] = {0.299f, 0.587f, 0.114f};
    float ycc_refbw[6] = {0.0f, 255.0f, 128.0f, 255.0f, 128.0f, 255.0f};
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

    // PIL's ImageFileDirectory_v2.load of one entry: where its values are
    // and how many bytes they take (0 where PIL skips the tag: a type it has
    // no reader for, no values), or false where they run past the end of the
    // file (PIL stops reading the IFD there)
    bool entry_data(size_t entry, uint32_t& type, uint64_t& count, size_t& at, size_t& size) const {
        type = rd16(entry + 2);
        count = bigtiff ? rd(entry + 4, 8) : rd32(entry + 4);
        static const int kUnit[19] = {0, 1, 1, 2, 4, 8, 1, 1, 2, 4, 8, 4, 8, 4, 0, 0, 8, 0, 0};
        const int unit = type < 19 ? kUnit[type] : 0;
        size = 0;
        at = 0;
        if (unit == 0 || count == 0) return true;
        if (count > n) return false;
        size = (size_t)unit * count;
        const size_t inline_room = bigtiff ? 8 : 4, field = entry + (bigtiff ? 12 : 8);
        at = size <= inline_room ? field : (size_t)rd(field, bigtiff ? 8 : 4);
        return at <= n && size <= n - at;
    }

    // the values of a numeric entry as PIL reads them (signed types sign
    // extended); a tag of another type holds what PIL cannot use as a number
    std::vector<uint64_t> values(uint32_t tag, uint32_t type, uint64_t count, size_t at) const {
        int size;
        bool is_signed = false;
        switch (type) {
            case 1: size = 1; break;
            case 3: size = 2; break;
            case 4: case 13: size = 4; break;
            case 16: size = 8; break;
            case 6: size = 1; is_signed = true; break;
            case 8: size = 2; is_signed = true; break;
            case 9: size = 4; is_signed = true; break;
            default:
                fail("TIFF: tag " + std::to_string(tag) + " of type " + std::to_string(type) +
                     " is no number to PIL");
        }
        std::vector<uint64_t> out(count);
        for (uint64_t i = 0; i < count; ++i) {
            uint64_t v = rd(at + size * i, size);
            if (is_signed && size < 8 && ((v >> (8 * size - 1)) & 1)) v |= ~0ull << (8 * size);
            out[i] = v;
        }
        return out;
    }

    // tif_dirread.c EstimateStripByteCounts for a compressed image without
    // StripByteCounts: every strip the bytes the directory leaves of the
    // file, the last one trimmed to the file's end
    void estimate_counts(size_t first, uint64_t count) {
        const size_t planes = planar == 2 ? spp : 1;
        if (tiled || (planar != 2 && offsets.size() > 1) || (planar == 2 && offsets.size() != spp))
            fail("TIFF: no StripByteCounts (libtiff refuses it)");
        static const int kWidth[19] = {0, 1, 1, 2, 4, 8, 1, 1, 2, 4, 8, 4, 8, 4, 0, 0, 8, 8, 8};
        const size_t entry_size = bigtiff ? 20 : 12, room = bigtiff ? 8 : 4;
        uint64_t space = bigtiff ? 16 + 8 + count * 20 + 8 : 8 + 2 + count * 12 + 4;
        for (uint64_t i = 0; i < count; ++i) {
            const size_t e = first + entry_size * (size_t)i;
            const uint32_t type = rd16(e + 2);
            const uint64_t cnt = bigtiff ? rd(e + 4, 8) : rd32(e + 4);
            const int width = type < 19 ? kWidth[type] : 0;
            if (width == 0) fail("TIFF: a tag of unknown type (libtiff cannot size the directory)");
            const uint64_t size = cnt * width;
            if (size > room) space += size;
        }
        space = n < space ? n : n - space;
        space /= planes;
        counts.assign(offsets.size(), space);
        const uint64_t last = offsets.back();
        if (last + counts.back() > n) counts.back() = last >= n ? 0 : n - last;
    }

    // one IFD entry's value, of the tags the decoder reads
    void take(uint32_t tag, uint32_t type, uint64_t cnt, size_t at, size_t size) {
        std::vector<uint64_t> v;
        switch (tag) {
            case 292: case 293: case 317: case 513: case 514: case 530: {
                // tags only libtiff reads (PIL keeps what it cannot read as a
                // number, and libtiff ignores such an entry)
                const bool number = type == 1 || type == 3 || type == 4 || type == 6 ||
                                    type == 8 || type == 9 || type == 13 || type == 16;
                if (!number) return;
                v = values(tag, type, cnt, at);
                break;
            }
            case 284:
                if (type == 5 || type == 10) {
                    // a rational PlanarConfiguration: PIL compares it with 2
                    const int64_t num = (int64_t)rd32(at), den = (int64_t)rd32(at + 4);
                    planar = den != 0 && (type == 5 ? num == 2 * den
                                                    : (int32_t)num == 2 * (int32_t)den) ? 2 : 1;
                    return;
                }
                v = values(tag, type, cnt, at);
                break;
            case 256: case 257: case 258: case 259: case 262: case 266:
            case 273: case 277: case 278: case 279:
            case 320: case 322: case 323: case 324: case 325:
            case 338: case 339:
                v = values(tag, type, cnt, at);
                break;
            case 529: case 532: {
                // TIFFReadDirEntryFloatArray of exactly 3 or 6 values (a
                // rational as float numerator over float denominator, 0 over
                // 0); another count is ignored
                const size_t want = tag == 529 ? 3 : 6;
                if (cnt != want) return;
                float f[6];
                for (size_t k = 0; k < want; ++k) {
                    switch (type) {
                        case 1: f[k] = d[at + k]; break;
                        case 6: f[k] = (int8_t)d[at + k]; break;
                        case 3: f[k] = (float)rd16(at + 2 * k); break;
                        case 8: f[k] = (float)(int16_t)rd16(at + 2 * k); break;
                        case 4: f[k] = (float)rd32(at + 4 * k); break;
                        case 9: f[k] = (float)(int32_t)rd32(at + 4 * k); break;
                        case 5: case 10: {
                            const uint32_t num = rd32(at + 8 * k), den = rd32(at + 8 * k + 4);
                            f[k] = den == 0 ? 0.0f
                                   : type == 5 ? (float)num / (float)den
                                               : (float)(int32_t)num / (float)(int32_t)den;
                            break;
                        }
                        case 11: {
                            const uint32_t u = rd32(at + 4 * k);
                            std::memcpy(&f[k], &u, 4);
                            break;
                        }
                        case 12: {
                            const uint64_t u = rd(at + 8 * k, 8);
                            double x;
                            std::memcpy(&x, &u, 8);
                            f[k] = x > 3.402823466e38 ? 3.402823466e38f
                                   : x < -3.402823466e38 ? -3.402823466e38f : (float)x;
                            break;
                        }
                        default: return;
                    }
                }
                std::memcpy(tag == 529 ? ycc_luma : ycc_refbw, f, want * sizeof(float));
                return;
            }
            case 347:
                // JPEGTables: an abbreviated JPEG stream of the tables
                jpegtables_at = at;
                jpegtables_len = size;
                return;
            default:
                return;
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

    void parse() {
        if (n < 8) fail("TIFF: truncated header");
        if (d[0] == 'I' && d[1] == 'I') big_endian = false;
        else if (d[0] == 'M' && d[1] == 'M') big_endian = true;
        else fail("TIFF: bad byte-order mark");
        uint32_t version = rd16(2);
        size_t ifd;
        if (version == 43) {
            bigtiff = true;
            if (n < 16) fail("TIFF: bad BigTIFF header");
            ifd = (size_t)rd(8, 8);
        } else if (version == 42) {
            ifd = rd32(4);
        } else {
            fail("TIFF: bad version");
        }
        const size_t entry_size = bigtiff ? 20 : 12;
        if (ifd > n || n - ifd < (bigtiff ? 8u : 2u)) fail("TIFF: truncated IFD (no entry count)");
        uint64_t count = bigtiff ? rd(ifd, 8) : rd16(ifd);
        ifd_at = ifd;
        const size_t first = ifd + (bigtiff ? 8 : 2);
        for (uint64_t i = 0; i < count; ++i) {
            size_t e = first + entry_size * (size_t)i;
            if (e > n || n - e < entry_size) break;     // PIL keeps the entries before
            uint32_t tag = rd16(e), type;
            uint64_t cnt;
            size_t at, size;
            if (!entry_data(e, type, cnt, at, size)) break;   // PIL stops reading the IFD here
            if (!size) continue;    // PIL skips the tag
            take(tag, type, cnt, at, size);
        }
        if (!width || !height) fail("TIFF: missing image size");
        if (compression == 1 && offsets.empty())
            fail("TIFF: no StripOffsets or TileOffsets (PIL: unknown data organization)");
        // PIL's raw decoder reads anything but PlanarConfiguration 2 as contiguous
        if (compression == 1 && planar != 2) planar = 1;
        // PIL's tiles of an uncompressed image: a strip that covers the image
        // is read from the last offset alone; strips taller than the image
        // all cover it, and PIL, reading its tiles in file order, keeps the
        // last (TiffImageFile._setup, ImageFile.load)
        if (compression == 1 && planar == 1 && !tiled && offsets.size() > 1 &&
            rows_per_strip >= height) {
            const uint64_t keep = rows_per_strip == height
                                      ? offsets.back()
                                      : *std::max_element(offsets.begin(), offsets.end());
            offsets.assign(1, keep);
        }
        if (compression == 6) {   // PIL: old-style JPEG is YCbCr, of 3 samples by default
            photometric = 6;
            have_photometric = true;
            if (!have_spp) spp = 3;
        }
    }

    // ---- libtiff's own reading of the directory (tif_dirread.c
    // TIFFReadDirectory and TIFFFetchDirectory, libtiff 4.7). PIL opens a
    // page from its own IFD reader (parse: the last of duplicate tags, the
    // entries before one whose values run past the end of the file) and
    // decodes a compressed one through libtiff, which reads the directory
    // again by its own rules: every entry, the first of duplicate tags, a
    // failure on some tags and a warning on the rest, its guesses for
    // missing tags, strip arrays cut short or padded with zeros. This view
    // decides whether the directory opens, the strips' offsets and counts,
    // and the layout of the rows libtiff hands PIL's unpacker.
    enum { LT_OK, LT_COUNT, LT_TYPE, LT_IO, LT_RANGE };

    // TIFFReadDirEntry{Short,Long,Long8}[Array]: up to `limit` integer values
    // of an entry, converted to unsigned integers no larger than `max`
    int lt_ints(size_t e, uint64_t max, uint64_t limit, std::vector<uint64_t>& out,
                bool one) const {
        const uint32_t type = rd16(e + 2);
        const uint64_t count = bigtiff ? rd(e + 4, 8) : rd32(e + 4);
        if (one && count != 1) return LT_COUNT;
        int unit;
        bool sgn = false;
        switch (type) {
            case 1: unit = 1; break;
            case 6: unit = 1; sgn = true; break;
            case 3: unit = 2; break;
            case 8: unit = 2; sgn = true; break;
            case 4: case 13: unit = 4; break;
            case 9: unit = 4; sgn = true; break;
            case 16: case 18: unit = 8; break;
            case 17: unit = 8; sgn = true; break;
            default: return LT_TYPE;
        }
        if (max <= 0xFFFF && (type == 13 || type == 18)) return LT_TYPE;
        const uint64_t take_n = std::min(count, limit);
        out.clear();
        if (take_n == 0) return LT_OK;
        const size_t room = bigtiff ? 8 : 4;
        size_t at;
        if (take_n > n / unit) return LT_IO;
        // the whole of the values is where libtiff looks for them: inline
        // if all `count` of them fit the entry, else at its offset
        const uint64_t full = count > n ? n + 1 : count * (uint64_t)unit;
        if (full <= room) {
            at = e + (bigtiff ? 12 : 8);
        } else {
            const uint64_t off = rd(e + (bigtiff ? 12 : 8), bigtiff ? 8 : 4);
            if (off > n || take_n * unit > n - off) return LT_IO;
            at = (size_t)off;
        }
        out.resize(take_n);
        for (uint64_t i = 0; i < take_n; ++i) {
            uint64_t v = rd(at + unit * i, unit);
            if (sgn) {
                if (unit < 8 && ((v >> (8 * unit - 1)) & 1)) return LT_RANGE;
                if (unit == 8 && (v >> 63)) return LT_RANGE;
            }
            if (v > max) return LT_RANGE;
            out[i] = v;
        }
        return LT_OK;
    }

    // TIFFReadDirEntryPersampleShort after a count error: the first
    // SamplesPerPixel values, all equal
    int lt_persample(size_t e, uint32_t samples, uint64_t& v) const {
        const uint64_t count = bigtiff ? rd(e + 4, 8) : rd32(e + 4);
        if (count < samples) return LT_COUNT;
        std::vector<uint64_t> vals;
        int err = lt_ints(e, 0xFFFF, samples, vals, false);
        if (err != LT_OK) return err;
        for (uint64_t x : vals)
            if (x != vals[0]) return LT_RANGE;
        v = vals.empty() ? 0 : vals[0];
        return LT_OK;
    }

    // a Short (or Long) of count 1, or per sample where allowed
    int lt_short(size_t e, uint64_t max, uint64_t& v, uint32_t persample = 0) const {
        std::vector<uint64_t> vals;
        int err = lt_ints(e, max, 1, vals, true);
        if (err == LT_COUNT && persample) return lt_persample(e, persample, v);
        if (err == LT_OK) v = vals[0];
        return err;
    }

    Tiff libtiff_view() const {
        Tiff L(d, n);
        L.big_endian = big_endian;
        L.bigtiff = bigtiff;
        const size_t ifd = ifd_at, entry_size = bigtiff ? 20 : 12;
        // TIFFClientOpen: a BigTIFF's offset size is 8, the two bytes after
        // it 0 (PIL's own reader reads neither)
        if (bigtiff && (rd16(4) != 8 || rd16(6) != 0))
            fail("TIFF: a BigTIFF header of another offset size than 8 or unused bytes other "
                 "than 0 (libtiff: Not a TIFF file)");
        // TIFFFetchDirectory (the file is mapped)
        uint64_t count = bigtiff ? rd(ifd, 8) : rd16(ifd);
        if (count > 4096) fail("TIFF: libtiff refuses a directory of more than 4096 entries");
        const size_t first = ifd + (bigtiff ? 8 : 2);
        if (first > n || count * entry_size > n - first)
            fail("TIFF: the IFD runs past the end of the file (libtiff cannot read it)");
        auto bad = [](const std::string& why) {
            fail("TIFF: " + why + " (libtiff's TIFFReadDirectory refuses the directory)");
        };
        // the first of duplicate tags (later ones are ignored)
        std::vector<size_t> entries;
        std::vector<uint32_t> seen;
        for (uint64_t i = 0; i < count; ++i) {
            const size_t e = first + entry_size * (size_t)i;
            const uint32_t tag = rd16(e);
            if (std::find(seen.begin(), seen.end(), tag) != seen.end()) continue;
            seen.push_back(tag);
            entries.push_back(e);
        }
        auto find = [&](uint32_t tag) -> size_t {
            for (size_t e : entries)
                if (rd16(e) == tag) return e;
            return 0;
        };
        auto cnt_of = [&](size_t e) { return bigtiff ? rd(e + 4, 8) : (uint64_t)rd32(e + 4); };
        uint64_t v = 0;
        bool have_width = false, have_height = false, have_tile = false, have_offsets = false,
             have_counts = false, have_bps = false, have_colormap = false;
        size_t offsets_entry = 0, counts_entry = 0;
        // SamplesPerPixel first, then Compression
        if (size_t e = find(277)) {
            if (lt_short(e, 0xFFFF, v) != LT_OK || v == 0) bad("SamplesPerPixel");
            L.spp = (uint32_t)v;
            L.have_spp = true;
        }
        if (size_t e = find(259)) {
            if (lt_short(e, 0xFFFF, v, L.spp) != LT_OK) bad("Compression");
            L.compression = (uint32_t)v;
        }
        auto codec_tag = [&](uint32_t tag) {
            // _TIFFCheckFieldIsValidForCodec: a codec's own tags count only
            // under that codec
            const uint32_t c = L.compression;
            switch (tag) {
                case 317: return c == 5 || c == 8 || c == 32946 || c == 34925 || c == 50000 ||
                                 c == 32909;
                case 292: return c == 3;
                case 293: return c == 4;
                case 326: case 327: case 328: return c == 2 || c == 3 || c == 4;
                case 347: return c == 7;
                case 512: case 513: case 514: case 515: case 517: case 518: case 519: case 520:
                case 521: return c == 6;
                default: return true;
            }
        };
        // the first pass
        for (size_t e : entries) {
            const uint32_t tag = rd16(e);
            switch (tag) {
                case 273: case 324: have_offsets = true; break;
                case 279: case 325: have_counts = true; break;
                case 256: case 257: case 32997: case 322: case 323: case 32998: {
                    if (lt_short(e, 0xFFFFFFFFull, v) != LT_OK) bad("tag " + std::to_string(tag));
                    if (tag == 256) { L.width = (uint32_t)v; have_width = true; }
                    if (tag == 257) { L.height = (uint32_t)v; have_height = true; }
                    if (tag == 322) { L.tile_w = (uint32_t)v; have_tile = true; }
                    if (tag == 323) { L.tile_h = (uint32_t)v; have_tile = true; }
                    break;
                }
                case 284:
                    if (lt_short(e, 0xFFFF, v) != LT_OK || (v != 1 && v != 2)) bad("PlanarConfiguration");
                    L.planar = (uint32_t)v;
                    break;
                case 278:
                    if (lt_short(e, 0xFFFFFFFFull, v) != LT_OK || v == 0) bad("RowsPerStrip");
                    L.rows_per_strip = (uint32_t)v;
                    L.rps_set = true;
                    break;
                case 338: {
                    std::vector<uint64_t> vals;
                    if (lt_ints(e, 0xFFFF, cnt_of(e), vals, false) != LT_OK ||
                        vals.size() > L.spp)
                        bad("ExtraSamples");
                    L.extrasamples.clear();
                    for (uint64_t x : vals) {
                        if (x > 2 && x != 999) bad("ExtraSamples");
                        L.extrasamples.push_back(x == 999 ? 2 : (uint32_t)x);
                    }
                    break;
                }
            }
        }
        // an old-style JPEG "separate" plane of one strip is contiguous
        if (L.compression == 6 && L.planar == 2) {
            const size_t so = find(273), sb = find(279);
            if (so && cnt_of(so) == 1 && sb && cnt_of(sb) == 1) L.planar = 1;
        }
        if (!have_width && !have_height) bad("no ImageWidth or ImageLength");
        L.tiled = have_tile;
        auto howmany = [](uint32_t x, uint32_t y) -> uint32_t {
            return x < 0xFFFFFFFFu - (y - 1) ? (x + y - 1) / y : 0;
        };
        uint64_t nstrips;
        if (L.tiled) {
            const uint32_t dx = L.tile_w, dy = L.tile_h;
            nstrips = (dx == 0 || dy == 0) ? 0
                      : (uint64_t)howmany(L.width, dx) * howmany(L.height, dy);
        } else {
            nstrips = L.rows_per_strip == 0xFFFFFFFFu ? 1 : howmany(L.height, L.rows_per_strip);
        }
        if (L.planar == 2) nstrips *= L.spp;
        if (nstrips == 0 || nstrips > 0xFFFFFFFFull) bad("no strips or tiles");
        if (!have_offsets && !(L.compression == 6 && !L.tiled && nstrips == 1))
            bad("no StripOffsets or TileOffsets");
        // the second pass
        for (size_t e : entries) {
            const uint32_t tag = rd16(e);
            if (tag == 277 || tag == 259 || tag == 256 || tag == 257 || tag == 32997 ||
                tag == 322 || tag == 323 || tag == 32998 || tag == 284 || tag == 278 || tag == 338)
                continue;
            const uint64_t c = cnt_of(e);
            switch (tag) {
                case 258: case 339: case 280: case 281: case 32996:
                    if (lt_short(e, 0xFFFF, v, L.spp) != LT_OK) bad("tag " + std::to_string(tag));
                    if (tag == 258) { L.bps = (uint32_t)v; have_bps = true; }
                    if (tag == 339) {
                        if (v < 1 || v > 6) bad("SampleFormat");
                        L.sampleformat = (uint32_t)v;
                        L.n_sf = 1;
                    }
                    break;
                case 273: case 324: offsets_entry = e; break;
                case 279: case 325: counts_entry = e; break;
                case 320: {
                    // ColorMap: exactly 3 << BitsPerSample values, else ignored
                    std::vector<uint64_t> vals;
                    if (L.bps <= 24 && c == (3ull << L.bps) &&
                        lt_ints(e, 0xFFFF, c, vals, false) == LT_OK) {
                        L.colormap.assign(vals.begin(), vals.end());
                        have_colormap = true;
                    }
                    break;
                }
                default: {
                    // TIFFFetchNormalTag with recovery: a tag it cannot read
                    // is ignored
                    if (!codec_tag(tag)) break;
                    switch (tag) {
                        case 262: case 266: case 317:
                            if (lt_short(e, 0xFFFF, v) != LT_OK) break;
                            if (tag == 262) { L.photometric = (uint32_t)v; L.have_photometric = true; }
                            if (tag == 266 && (v == 1 || v == 2)) L.fillorder = (uint32_t)v;
                            if (tag == 317) L.predictor = (uint32_t)v;
                            break;
                        case 292: case 293: case 513: case 514:
                            if (lt_short(e, 0xFFFFFFFFull, v) != LT_OK) break;
                            if (tag == 292) L.t4options = (uint32_t)v;
                            if (tag == 293) L.t6options = (uint32_t)v;
                            if (tag == 513) L.ojpeg_at = (size_t)v;
                            if (tag == 514) L.ojpeg_len = (size_t)v;
                            break;
                        case 530: {
                            std::vector<uint64_t> vals;
                            if (c != 2 || lt_ints(e, 0xFFFF, 2, vals, false) != LT_OK) break;
                            L.ycc_h = (uint32_t)vals[0];
                            L.ycc_v = (uint32_t)vals[1];
                            break;
                        }
                        case 347: case 529: case 532: {
                            uint32_t ty;
                            uint64_t cn;
                            size_t at, size;
                            if (entry_data(e, ty, cn, at, size) && size) L.take(tag, ty, cn, at, size);
                            break;
                        }
                    }
                }
            }
        }
        // the old-style JPEG guesses
        if (L.compression == 6) {
            if (!L.have_photometric || L.photometric == 2) {
                L.photometric = 6;
                L.have_photometric = true;
            }
            if (!have_bps) L.bps = 8;
            if (!L.have_spp) {
                if (L.photometric == 2 || L.photometric == 6) L.spp = 3;
                else if (L.photometric <= 1) L.spp = 1;
            }
        }
        // a palette image without a (valid) ColorMap
        if (L.have_photometric && L.photometric == 3 && !have_colormap) {
            if (L.bps >= 8 && L.spp == 3) L.photometric = 2;
            else if (L.bps >= 8) L.photometric = 1;
            else bad("a palette image without a ColorMap");
        }
        L.bps_all.assign(1, L.bps);
        // the strips' offsets and counts (TIFFFetchStripThing): the values of
        // the strips the image has, zeros past a short array
        const uint64_t ns = nstrips;
        auto strip_thing = [&](size_t e, std::vector<uint64_t>& out) {
            std::vector<uint64_t> vals;
            if (lt_ints(e, ~0ull, ns, vals, false) != LT_OK)
                fail("TIFF: StripOffsets or StripByteCounts past the end of the file (libtiff "
                     "refuses it)");
            vals.resize(ns, 0);
            out = vals;
        };
        if (offsets_entry) strip_thing(offsets_entry, L.offsets);
        else L.offsets.assign(ns, 0);
        if (counts_entry) strip_thing(counts_entry, L.counts);
        if (L.compression != 6) {
            if (!have_counts) {
                if ((L.planar == 1 && ns > 1) || (L.planar == 2 && ns != L.spp))
                    bad("no StripByteCounts");
                L.estimate_counts(first, count);
            } else if (ns == 1 && !L.tiled && L.offsets[0] != 0 &&
                       (L.counts[0] == 0 ||
                        (L.compression == 1 &&
                         ((L.offsets[0] <= n && L.counts[0] > n - L.offsets[0]) ||
                          L.counts[0] < (uint64_t)L.scanline_bytes() * L.height)))) {
                L.estimate_counts(first, count);    // ByteCountLooksBad
            } else if (L.planar == 1 && ns > 2 && L.compression == 1 && L.counts[0] != L.counts[1] &&
                       L.counts[0] && L.counts[1]) {
                L.estimate_counts(first, count);
            }
        }
        if (L.scanline_bytes() == 0) bad("a scanline of 0 bytes");
        return L;
    }

    // TIFFScanlineSize64 of a contiguous or separate image (not YCbCr)
    uint64_t scanline_bytes() const {
        const uint64_t samples = (uint64_t)width * (planar == 2 ? 1 : spp);
        return (samples * bps + 7) / 8;
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
        if (bps != 1 && bps != 2 && bps != 4 && bps != 8 && bps != 12 && bps != 16 && bps != 32)
            fail("TIFF: " + std::to_string(bps) + "-bit samples are not supported "
                 "(1, 2, 4, 8, 12, 16 and 32 bits are)");
        if (planar != 1 && planar != 2)
            fail("TIFF: PlanarConfiguration " + std::to_string(planar));
        if (fillorder != 1 && fillorder != 2) fail("TIFF: FillOrder " + std::to_string(fillorder));
        switch (compression) {
            case 1: case 2: case 3: case 4: case 5: case 7: case 8: case 32946: case 32773: break;
            case 6: break;
            default:
                fail("TIFF: compression " + std::to_string(compression) + " is not supported");
        }
        if (fax() && (bps != 1 || spp != 1))
            fail("TIFF: CCITT compression needs 1-bit samples");
        if (jpeg()) {
            if (bps != 8) fail("TIFF: JPEG-in-TIFF with " + std::to_string(bps) + "-bit samples");
            if (!((photometric <= 1 && spp <= 2) || (photometric == 2 && (spp == 3 || spp == 4)) ||
                  (photometric == 6 && spp == 3) || (photometric == 5 && spp == 4)))
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
                check_palette();
                break;
            case 5: break;
            case 6:
                // libtiff's RGBA interface has a reader for separate YCbCr
                // planes only where they are not subsampled
                // (putseparate8bitYCbCr11tile)
                if (planar == 2 && (ycc_h != 1 || ycc_v != 1))
                    fail("TIFF: separate YCbCr planes subsampled " + std::to_string(ycc_h) + "x" +
                         std::to_string(ycc_v) + " (libtiff's RGBA interface reads only 1x1)");
                // tif_getimage.c initYCbCrConversion: the RGBA interface
                // refuses coefficients it cannot divide by
                if ((planar == 2 || !jpeg()) &&
                    (std::isnan(ycc_luma[0]) || std::isnan(ycc_luma[1]) || ycc_luma[1] == 0.0f ||
                     std::isnan(ycc_luma[2])))
                    fail("TIFF: YCbCrCoefficients the RGBA interface cannot use (libtiff: Invalid "
                         "values for YCbCrCoefficients tag)");
                if (jpeg()) break;
                if (compression == 1)
                    fail("TIFF: uncompressed YCbCr, which PIL reads with rawmode RGBX, 4 bytes a "
                         "pixel of 3 samples, unconverted: a misreading the port refuses (decided "
                         "divergence)");
                if (compression != 6 && compression != 5 && compression != 8 &&
                    compression != 32946 && compression != 32773)
                    fail("TIFF: YCbCr TIFF under compression " + std::to_string(compression) +
                         " is not supported");
                if (bps != 8 || spp != 3)
                    fail("TIFF: YCbCr TIFF other than 3 x 8-bit samples");
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

    // a palette image as PIL reads it: one index (and an extra sample) of
    // at most 8 bits, and PIL's palette from the whole ColorMap
    void check_palette() const {
        if (spp > 2 || (spp == 2 && (bps != 8 || planar != 1)))
            fail("TIFF: palette image with several samples per pixel");
        if (bps > 8) fail("TIFF: palette image with " + std::to_string(bps) + "-bit samples");
        if (colormap.size() != 3u << bps) fail("TIFF: palette image without a full ColorMap");
    }

    // decoded layout: uint8 RGB for a palette or YCbCr image, else
    // spp samples per pixel of 1, 2 or 4 bytes (native byte order)
    // a palette image with an extra sample comes out as RGB and the sample
    int channels() const {
        if (photometric == 3) return spp == 2 ? 4 : 3;
        if (photometric == 6 && !jpeg()) return 3;
        if (photometric == 6) return planar == 1 ? 3 : (int)spp;
        return (int)spp;
    }
    int sample_bytes() const {
        if (photometric == 3 || (photometric == 6 && planar == 1) || jpeg() || bps <= 8) return 1;
        return bps == 12 ? 2 : (int)bps / 8;
    }

    // ---- decompression of one strip or tile into exactly `want` bytes
    // tif_packbits.c PackBitsDecode: a run cut by the end of the data is
    // dropped; where the data ends first the rest is zeroed and libtiff
    // reports an error (raised here, unless `partial`: the bytes kept)
    static void packbits(const uint8_t* s, size_t n, uint8_t* o, size_t want, bool partial) {
        size_t i = 0, k = 0;
        while (i < n && k < want) {
            int c = (int8_t)s[i++];
            if (c < 0) {
                if (c == -128) continue;
                size_t len = std::min((size_t)(1 - c), want - k);
                if (i >= n) break;
                std::memset(o + k, s[i++], len);
                k += len;
            } else {
                size_t len = std::min((size_t)c + 1, want - k);
                if (n - i < len) break;
                std::memcpy(o + k, s + i, len);
                i += len;
                k += len;
            }
        }
        if (k < want) {
            std::memset(o + k, 0, want - k);
            if (!partial) fail("TIFF: PackBits data ends early");
        }
    }

    // tif_lzw.c LZWDecode: a code not yet in the table, or the data ending
    // first, zeroes the rest and is an error (raised, unless `partial`)
    static void lzw(const uint8_t* s, size_t n, uint8_t* o, size_t want, bool partial) {
        if (n >= 2 && s[0] == 0 && (s[1] & 1)) fail("TIFF: old-style LZW is not supported");
        size_t k = 0;
        auto broken = [&](const char* why) {
            std::memset(o + k, 0, want - k);
            if (!partial) fail(why);
        };
        // libtiff's table holds 5119 entries (codes reach 4095; the rest are
        // registered and never read), and its next free entry starts out as
        // the one a full table leaves (LZWPreDecode): a code other than CLEAR
        // or EOI before the first CLEAR is "not yet in the table"
        const int kTable = 5119;
        std::vector<int32_t> prefix(kTable, -1);
        std::vector<uint8_t> suffix(kTable), first(kTable);
        std::vector<int32_t> length(kTable, 0);
        for (int i = 0; i < 256; ++i) {
            suffix[i] = (uint8_t)i;
            first[i] = (uint8_t)i;
            length[i] = 1;
        }
        size_t bitpos = 0;
        int width = 9, next = 258, prev = -1;
        bool fresh = true;
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
                fresh = false;
                continue;
            }
            if (fresh) return broken("TIFF: LZW data that does not start with a CLEAR code");
            if (prev < 0) {
                if (code > 255) return broken("TIFF: corrupt LZW data");
                emit(code);
                prev = code;
                continue;
            }
            if (code > next || next >= kTable) return broken("TIFF: corrupt LZW data");
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
        if (k < want) broken("TIFF: LZW data ends early");
    }

    // rows of CCITT data into rows of (w + 7) / 8 bytes, as libtiff
    // decodes the strip; a strip libtiff fails on raises, and so does one
    // whose Group 4 data ends rows short of the strip (libtiff then reports
    // success and PIL keeps its buffer's earlier bytes for those rows)
    void fax_rows(const uint8_t* s, size_t cnt, uint8_t* o, uint32_t w, uint32_t rows) const {
        bool failed = false;
        const uint32_t written = fax_decode(s, cnt, o, w, rows, failed);
        if (failed) fail("TIFF: damaged CCITT data (libtiff: premature end of the strip)");
        if (written < rows)
            fail("TIFF: Group 4 data that ends rows short of its strip (PIL's pixels there are its "
                 "buffer's earlier contents: decided divergence, not had from the file)");
    }

    // the CCITT decoder over one strip or tile: the rows it wrote (a row it
    // failed in is filled all the same), `failed` where it returned an error
    uint32_t fax_decode(const uint8_t* s, size_t cnt, uint8_t* o, uint32_t w, uint32_t rows,
                        bool& failed) const {
        static const FaxTables kTables;
        const FaxDecoder::Kind kind = compression == 2 ? FaxDecoder::RLE
                                    : compression == 4 ? FaxDecoder::G4
                                    : (t4options & 1) ? FaxDecoder::G3_2D : FaxDecoder::G3_1D;
        FaxDecoder f(kTables, s, cnt, w, kind == FaxDecoder::G3_2D || kind == FaxDecoder::G4,
                     fax_noeol, fax_runs);
        failed = f.decode(kind, o, rows, (w + 7) / 8) < 0;
        const uint32_t done = (uint32_t)f.rows_done;
        return failed && kind != FaxDecoder::G4 ? std::min(done + 1, rows) : done;
    }

    // one strip or tile into exactly `want` bytes
    // (`partial`: as libtiff leaves a strip it fails on in the buffer of
    // its RGBA interface, which reads on past such a strip)
    void decompress(const uint8_t* src, size_t cnt, uint8_t* out, size_t want, uint32_t cw,
                    uint32_t rows, inflate_fn inflate, bool partial = false) const {
        switch (compression) {
            case 1:
                if (cnt < want) fail("TIFF: truncated strip or tile");
                std::memcpy(out, src, want);
                break;
            case 32773: packbits(src, cnt, out, want, partial); break;
            case 5: lzw(src, cnt, out, want, partial); break;
            case 8: case 32946: {
                // the callback returns -(bytes + 1) after corrupt data
                int64_t got = inflate(src, (int64_t)cnt, out, (int64_t)want);
                if (got < 0 && !partial) fail("TIFF: corrupt Deflate data");
                if (got >= 0 && (size_t)got < want && !partial) fail("TIFF: Deflate data ends early");
                break;
            }
            case 2: case 3: case 4:
                fax_rows(src, cnt, out, cw, rows);
                break;
        }
    }

    // libtiff's TIFFYCbCrToRGBInit / TIFFYCbCrtoRGB (tif_color.c): 16-bit
    // fixed point from the float YCbCrCoefficients, the samples mapped
    // through ReferenceBlackWhite (Code2V, clamped to +-4096)
    struct YccToRgb {
        int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256], y_tab[256];
        YccToRgb(const float* luma, const float* refbw) {
            auto fix = [](float x) { return (int32_t)(x * (1L << 16) + 0.5); };
            auto clamp = [](float f, float lo, float hi) { return f < lo ? lo : f > hi ? hi : f; };
            auto code2v = [](int c, float rb, float rw, float cr) {
                return ((float)(c - (int32_t)rb) * cr) / (rw - rb != 0 ? rw - rb : 1.0f);
            };
            const float lr = luma[0], lg = luma[1], lb = luma[2];
            const float f1 = 2 - 2 * lr, f2 = lr * f1 / lg, f3 = 2 - 2 * lb, f4 = lb * f3 / lg;
            const int32_t d1 = fix(clamp(f1, 0.0f, 2.0f)), d2 = -fix(clamp(f2, 0.0f, 2.0f));
            const int32_t d3 = fix(clamp(f3, 0.0f, 2.0f)), d4 = -fix(clamp(f4, 0.0f, 2.0f));
            for (int i = 0, x = -128; i < 256; ++i, ++x) {
                const int32_t cr = (int32_t)clamp(
                    code2v(x, refbw[4] - 128.0f, refbw[5] - 128.0f, 127), -4096.0f, 4096.0f);
                const int32_t cb = (int32_t)clamp(
                    code2v(x, refbw[2] - 128.0f, refbw[3] - 128.0f, 127), -4096.0f, 4096.0f);
                cr_r[i] = (d1 * cr + (1 << 15)) >> 16;
                cb_b[i] = (d3 * cb + (1 << 15)) >> 16;
                cr_g[i] = d2 * cr;
                cb_g[i] = d4 * cb + (1 << 15);
                y_tab[i] = (int32_t)clamp(code2v(x + 128, refbw[0], refbw[1], 255), -4096.0f,
                                          4096.0f);
            }
        }
        void put(int y, int cb, int cr, uint8_t* rgb) const {
            auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
            const int yy = y_tab[y];
            rgb[0] = clamp(yy + cr_r[cr]);
            rgb[1] = clamp(yy + ((cb_g[cb] + cr_g[cr]) >> 16));
            rgb[2] = clamp(yy + cb_b[cb]);
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
        const uint32_t planes = planar == 2 ? 3 : 1;
        if (offsets.size() < (size_t)across * down * planes)
            fail("TIFF: missing strip or tile offsets");
        // contiguous: sampling units (the h x v Y samples, Cb, Cr); separate
        // planes: unsubsampled samples of each (check_supported)
        const uint32_t unit = planar == 2 ? 1 : ycc_h * ycc_v + 2;
        const uint32_t hs = planar == 2 ? 1 : ycc_h, vs = planar == 2 ? 1 : ycc_v;
        const uint32_t units_across = (cw + hs - 1) / hs;
        const YccToRgb conv(ycc_luma, ycc_refbw);
        std::vector<uint8_t> chunk, reversed;
        // PIL asks the RGBA interface for one strip or row of tiles at a
        // time (TIFFRGBAImageGet, stop on error 0): its buffer, zeroed when
        // allocated, is kept from tile to tile of the row; a strip or tile
        // libtiff fails to decode leaves in it what it got, and only the
        // first plane's strip must be there to be read at all
        for (uint32_t ty = 0; ty < down; ++ty) {
            chunk.clear();
            for (uint32_t tx = 0; tx < across; ++tx) {
                const uint32_t rows = tiled ? ch : std::min(ch, height - ty * ch);
                const uint32_t unit_rows = (rows + vs - 1) / vs;
                const size_t want = (size_t)unit_rows * units_across * unit;
                if (chunk.size() != want * planes) chunk.assign(want * planes, 0);
                for (uint32_t plane = 0; plane < planes; ++plane) {
                    const size_t idx = ((size_t)plane * down + ty) * across + tx;
                    const size_t off = (size_t)offsets[idx];
                    const bool missing = off > n || (idx < counts.size() &&
                                                     (counts[idx] == 0 || counts[idx] > n - off));
                    if (missing) {
                        if (plane == 0)
                            fail("TIFF: a strip or tile past the end of the file (libtiff: read "
                                 "error)");
                        continue;
                    }
                    const size_t cnt = std::min(idx < counts.size() ? (size_t)counts[idx] : want,
                                                n - off);
                    const uint8_t* src = d + off;
                    if (fillorder == 2) {
                        reversed.resize(cnt);
                        for (size_t i = 0; i < cnt; ++i) reversed[i] = reverse_bits(src[i]);
                        src = reversed.data();
                    }
                    decompress(src, cnt, chunk.data() + want * plane, want, cw, rows, inflate, true);
                }
                const uint32_t x0 = tx * cw, y0 = ty * ch;
                for (uint32_t uy = 0; uy < unit_rows; ++uy)
                    for (uint32_t ux = 0; ux < units_across; ++ux) {
                        const size_t at = ((size_t)uy * units_across + ux) * unit;
                        const uint8_t* u = chunk.data() + at;
                        const int cb = planar == 2 ? chunk[want + at] : u[hs * vs];
                        const int cr = planar == 2 ? chunk[2 * want + at] : u[hs * vs + 1];
                        for (uint32_t j = 0; j < vs; ++j)
                            for (uint32_t i = 0; i < hs; ++i) {
                                uint32_t x = x0 + ux * hs + i, y = y0 + uy * vs + j;
                                if (x >= width || y >= height || ux * hs + i >= cw ||
                                    uy * vs + j >= rows)
                                    continue;
                                conv.put(u[j * hs + i], cb, cr, dst + ((size_t)y * width + x) * 3);
                            }
                    }
            }
        }
    }

    // tif_ojpeg.c OJPEGReadHeaderInfoSec: libtiff reads the stream's markers
    // itself, one right after the other, up to SOS (a byte other than FF
    // where a marker belongs ends its reading, and the tables are missing)
    // (false where the stream holds no frame header before a byte other
    // than FF or SOS: libtiff then takes the frame and tables from tags)
    static bool ojpeg_header(const uint8_t* s, size_t len) {
        size_t p = 0;
        bool sof = false;
        auto word = [&](size_t at) -> size_t {
            if (at + 2 > len) fail("TIFF: old-style JPEG stream ends in its header");
            return ((size_t)s[at] << 8) | s[at + 1];
        };
        for (;;) {
            if (p >= len) fail("TIFF: old-style JPEG stream ends in its header");
            if (s[p] != 0xFF && !sof) return false;
            if (s[p] != 0xFF)
                fail("TIFF: old-style JPEG header broken before SOS (libtiff: missing JPEG tables)");
            while (p < len && s[p] == 0xFF) ++p;
            if (p >= len) fail("TIFF: old-style JPEG stream ends in its header");
            const int m = s[p++];
            if (m == 0xD8) continue;
            if (m == 0xDA) return sof;
            sof |= m == 0xC0 || m == 0xC1 || m == 0xC3;
            if (m == 0xFE || (m >= 0xE0 && m <= 0xEF) || m == 0xDD || m == 0xDB || m == 0xC4 ||
                m == 0xC0 || m == 0xC1 || m == 0xC3) {
                const size_t n = word(p);
                if (n < 2) fail("TIFF: corrupt old-style JPEG data (libtiff refuses it)");
                p += n;
                continue;
            }
            fail("TIFF: unknown marker " + std::to_string(m) + " in old-style JPEG data "
                 "(libtiff refuses it)");
        }
    }

    // old-style JPEG (compression 6) from its JPEGInterchangeFormat stream,
    // as libtiff's tif_ojpeg.c hands it to the RGBA interface: the
    // components as the inverse DCT leaves them, not upsampled, and each
    // chroma sample on its whole sampling unit
    void decode_ojpeg(uint8_t* dst) const {
        // tif_ojpeg.c OJPEGReadBufferFill: the JPEGInterchangeFormat bytes
        // (as far as the file goes), then every strip's bytes in turn (a
        // count of 0: to the end of the file; an offset of 0 or past the
        // end: none); a read that finds the file's end stops the stream
        // (OJPEGReadHeaderInfoSec: a JPEGInterchangeFormat past the end of
        // the file is dropped, a length of 0 or past the end runs to the end)
        std::vector<uint8_t> stream;
        if (ojpeg_at && ojpeg_at < n) {
            const size_t len = ojpeg_len && ojpeg_len <= n - ojpeg_at ? ojpeg_len : n - ojpeg_at;
            stream.assign(d + ojpeg_at, d + ojpeg_at + len);
        }
        for (size_t k = 0; k < offsets.size(); ++k) {
            const uint64_t off = offsets[k];
            if (off == 0 || off >= n) continue;
            const uint64_t cnt = k < counts.size() && counts[k] ? counts[k] : n - off;
            stream.insert(stream.end(), d + off, d + off + std::min<uint64_t>(cnt, n - off));
        }
        if (!ojpeg_header(stream.data(), stream.size()))
            fail("TIFF: old-style JPEG-in-TIFF without a JPEG stream behind JPEGInterchangeFormat "
                 "or in its strips (libtiff builds the frame from the JPEGQTables / JPEGDCTables / "
                 "JPEGACTables tags; no oracle file of the layout: decided divergence)");
        Jpeg j(stream.data(), stream.size());
        j.tiff_source = true;
        j.decode_scans();
        if (j.comps.size() != 3 || j.lossless)
            fail("TIFF: old-style JPEG-in-TIFF without 3 DCT components");
        const Component &yc = j.comps[0], &cbc = j.comps[1], &crc = j.comps[2];
        if (yc.h != j.hmax || yc.v != j.vmax || cbc.h != 1 || cbc.v != 1 || crc.h != 1 ||
            crc.v != 1)
            fail("TIFF: old-style JPEG-in-TIFF whose chroma is not sampled 1 x 1");
        if ((uint32_t)j.width < width || (uint32_t)j.height < height)
            fail("TIFF: old-style JPEG stream smaller than the image");
        // OJPEGReadHeaderInfoSecStreamSof
        if (!tiled && (uint32_t)j.width > width)
            fail("TIFF: old-style JPEG stream wider than the image (libtiff refuses it)");
        j.inverse_dct();
        const YccToRgb conv(ycc_luma, ycc_refbw);
        const int ys = yc.bw * 8, cs = cbc.bw * 8;
        for (uint32_t y = 0; y < height; ++y)
            for (uint32_t x = 0; x < width; ++x) {
                size_t c = (size_t)(y / yc.v) * cs + x / yc.h;
                conv.put(yc.plane[(size_t)y * ys + x], cbc.plane[c], crc.plane[c],
                         dst + ((size_t)y * width + x) * 3);
            }
    }

    // one JPEG stream (tables from JPEGTables first) -> its pixels, placed
    // at (x0, y0) of the image (PlanarConfiguration 2: its one component
    // into sample `plane`), with the checks of libtiff's JPEGPreDecode
    void jpeg_chunk(const uint8_t* src, size_t cnt, uint32_t x0, uint32_t y0, uint32_t plane,
                    uint32_t rows, uint8_t* dst) const {
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
        j.tiff_source = true;
        // libtiff: contiguous YCbCr is converted to RGB (PIL asks for
        // JPEGCOLORMODE_RGB); anything else comes out as coded
        const bool to_rgb = photometric == 6 && planar == 1;
        j.colorspace = to_rgb ? 0 : 1;
        j.decode_scans();
        const int ncomp = planar == 1 ? (int)spp : 1;
        if (j.channels() != ncomp)
            fail("TIFF: JPEG strip or tile has the wrong number of components");
        // the strip or tile the stream should fill (a subsampled plane smaller)
        const uint32_t hs = photometric == 6 ? ycc_h : 1, vs = photometric == 6 ? ycc_v : 1;
        uint32_t seg_w = tiled ? tile_w : width, seg_h = tiled ? tile_h : rows;
        if (planar == 2 && plane > 0) {
            if (hs != 1 || vs != 1)
                fail("TIFF: subsampled separate JPEG planes are not supported");
        }
        const uint32_t jw = (uint32_t)j.width, jh = (uint32_t)j.height;
        if (jw < seg_w || jh < seg_h)
            fail("TIFF: a JPEG strip or tile smaller than its strip or tile (PIL's pixels past it "
                 "are uninitialized memory: decided divergence, not had from the file)");
        const bool last_strip_taller = jw == seg_w && jh > seg_h && y0 + seg_h == height && !tiled;
        if (!last_strip_taller && (jw > seg_w || jh > seg_h))
            fail("TIFF: a JPEG strip or tile larger than its strip or tile (libtiff refuses it)");
        if (planar == 1) {
            if (j.comps[0].h != (int)hs || j.comps[0].v != (int)vs)
                fail("TIFF: improper JPEG sampling factors (libtiff refuses them)");
            for (size_t ci = 1; ci < j.comps.size(); ++ci)
                if (j.comps[ci].h != 1 || j.comps[ci].v != 1)
                    fail("TIFF: improper JPEG sampling factors (libtiff refuses them)");
        } else if (j.comps[0].h != 1 || j.comps[0].v != 1) {
            fail("TIFF: improper JPEG sampling factors (libtiff refuses them)");
        }
        j.inverse_dct();
        std::vector<uint8_t> px((size_t)jw * jh * ncomp);
        j.to_pixels(px.data());
        const int ch = channels();
        const uint32_t w_here = std::min(jw, width - x0), h_here = std::min(jh, height - y0);
        for (uint32_t r = 0; r < h_here; ++r) {
            const uint8_t* in = px.data() + (size_t)r * jw * ncomp;
            uint8_t* out = dst + ((size_t)(y0 + r) * width + x0) * ch;
            if (planar == 1) {
                std::memcpy(out, in, (size_t)w_here * ch);
            } else {
                for (uint32_t x = 0; x < w_here; ++x) out[(size_t)x * ch + plane] = in[x];
            }
        }
    }

    // one JPEG strip or tile of the directory, as TIFFFillStrip /
    // TIFFFillTile read it, into the image
    void read_jpeg_chunk(size_t idx, uint32_t x0, uint32_t y0, uint32_t plane, uint32_t rows,
                         uint8_t* dst, std::vector<uint8_t>& reversed) const {
        const size_t off = (size_t)offsets[idx];
        if (off > n) fail("TIFF: strip or tile past the end of the file");
        size_t cnt = idx < counts.size() ? (size_t)counts[idx] : n - off;
        if (idx < counts.size()) {
            if (cnt == 0) fail("TIFF: a strip or tile of 0 bytes (libtiff refuses it)");
            if (cnt > n - off)
                fail("TIFF: a strip or tile runs past the end of the file (libtiff: read error)");
        }
        cnt = std::min(cnt, n - off);
        const uint8_t* src = d + off;
        if (fillorder == 2) {
            reversed.resize(cnt);
            for (size_t i = 0; i < cnt; ++i) reversed[i] = reverse_bits(src[i]);
            src = reversed.data();
        }
        jpeg_chunk(src, cnt, x0, y0, plane, rows, dst);
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
        std::vector<uint8_t> chunk, reversed;
        std::vector<uint32_t> row(cw * spc);
        // samples of the whole image (a palette image: its indices)
        std::vector<uint8_t> samples(jpeg() ? 0 : (size_t)width * height * spp * sb);
        // separate YCbCr JPEG strips go through libtiff's RGBA interface
        // (gtStripSeparate, PIL: stop on error 0): the first strip of the
        // first plane must be read (its buffer is allocated after it), and
        // after that a plane's strip libtiff fails to read or decode leaves
        // the interface's strip buffer as it was, that plane's rows of the
        // strip before (zeros at first)
        const bool rgba_planes = jpeg() && planar == 2 && photometric == 6 && !tiled;
        for (uint32_t plane = 0; plane < planes; ++plane)
            for (uint32_t ty = 0; ty < down; ++ty)
                for (uint32_t tx = 0; tx < across; ++tx) {
                    size_t idx = ((size_t)plane * down + ty) * across + tx;
                    if (idx >= offsets.size()) continue;
                    uint32_t rows = tiled ? ch : std::min(ch, height - ty * ch);
                    if (rgba_planes) {
                        try {
                            read_jpeg_chunk(idx, tx * cw, ty * ch, plane, rows, dst, reversed);
                        } catch (const std::exception&) {
                            if (idx == 0) throw;
                            const int nch = channels();
                            for (uint32_t r = 0; r < rows; ++r)
                                for (uint32_t x = 0; x < width; ++x) {
                                    const size_t at = ((size_t)(ty * ch + r) * width + x) * nch + plane;
                                    dst[at] = ty ? dst[at - (size_t)ch * width * nch] : 0;
                                }
                        }
                        continue;
                    }
                    size_t want = rowbytes * rows;
                    size_t off = (size_t)offsets[idx];
                    if (off > n) fail("TIFF: strip or tile past the end of the file");
                    // PIL's raw decoder reads from the offset on, whatever the
                    // byte count says
                    size_t cnt = idx < counts.size() && compression != 1 ? (size_t)counts[idx] : n - off;
                    if (compression != 1 && idx < counts.size()) {
                        // libtiff's TIFFFillStrip / TIFFFillTile
                        if (cnt == 0) fail("TIFF: a strip or tile of 0 bytes (libtiff refuses it)");
                        if (cnt > n - off)
                            fail("TIFF: a strip or tile runs past the end of the file (libtiff: "
                                 "read error)");
                    }
                    cnt = std::min(cnt, n - off);
                    const uint8_t* src = d + off;
                    if (fillorder == 2) {
                        reversed.resize(cnt);
                        for (size_t i = 0; i < cnt; ++i) reversed[i] = reverse_bits(src[i]);
                        src = reversed.data();
                    }
                    uint32_t x0 = tx * cw, y0 = ty * ch;
                    if (jpeg()) {
                        jpeg_chunk(src, cnt, x0, y0, plane, rows, dst);
                        continue;
                    }
                    if (tiled && fax()) {
                        // TIFFReadEncodedTile takes the CCITT decoders' error
                        // (-1) for success: the rows after the one it failed
                        // in, or after the data's end, keep PIL's tile buffer's
                        // earlier contents, the tile read before
                        if (chunk.size() != want) chunk.assign(want, 0);
                        bool failed = false;
                        if (fax_decode(src, cnt, chunk.data(), cw, rows, failed) < rows &&
                            idx == 0)
                            fail("TIFF: CCITT data that ends rows short of the first tile (PIL's "
                                 "pixels there are its buffer's earlier contents: decided "
                                 "divergence, not had from the file)");
                    } else {
                        chunk.assign(want, 0);
                        decompress(src, cnt, chunk.data(), want, cw, rows, inflate);
                    }
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
                        } else if (bps == 8 || bps == 16 || bps == 32) {
                            for (size_t i = 0; i < nvals; ++i)
                                row[i] = (uint32_t)rd_sample(p + i * (bps / 8));
                            if (predicted() && predictor == 2) {
                                const uint32_t mask = bps == 32 ? 0xFFFFFFFFu : (1u << bps) - 1;
                                for (size_t i = spc; i < nvals; ++i) row[i] = (row[i] + row[i - spc]) & mask;
                            }
                        } else {
                            for (size_t i = 0; i < nvals; ++i) {
                                // samples of 1-12 bits, most significant bit first
                                size_t bit = i * bps;
                                uint32_t two = (uint32_t)p[bit >> 3] << 8;
                                if ((bit >> 3) + 1 < rowbytes) two |= p[(bit >> 3) + 1];
                                row[i] = (two >> (16 - bps - (bit & 7))) & ((1u << bps) - 1);
                            }
                        }
                        // into the image
                        for (uint32_t x = 0; x < w_here; ++x)
                            for (uint32_t c = 0; c < spc; ++c) {
                                uint32_t v = row[(size_t)x * spc + c];
                                size_t at = ((size_t)(y0 + r) * width + x0 + x) * spp + plane + c;
                                if (sb == 1) samples[at] = (uint8_t)v;
                                else if (sb == 2) { uint16_t h = (uint16_t)v; std::memcpy(&samples[at * 2], &h, 2); }
                                else std::memcpy(&samples[at * 4], &v, 4);
                            }
                    }
                }
        const size_t npix = (size_t)width * height;
        if (jpeg()) {
            // separate YCbCr JPEG planes: PIL reads them through libtiff's
            // RGBA interface, which converts them (putseparate8bitYCbCr11tile)
            if (photometric == 6 && planar == 2) {
                const YccToRgb conv(ycc_luma, ycc_refbw);
                for (size_t i = 0; i < npix; ++i) {
                    uint8_t* px = dst + 3 * i;
                    conv.put(px[0], px[1], px[2], px);
                }
            }
            return;
        }

        if (photometric == 3 && !keep_indices) {
            const size_t ncol = (size_t)1 << bps, ch = channels();
            for (size_t i = 0; i < npix; ++i) {
                size_t v = samples[spp * i];
                dst[ch * i] = (uint8_t)(colormap[v] >> 8);
                dst[ch * i + 1] = (uint8_t)(colormap[ncol + v] >> 8);
                dst[ch * i + 2] = (uint8_t)(colormap[2 * ncol + v] >> 8);
                if (spp == 2) dst[ch * i + 3] = samples[spp * i + 1];
            }
            return;
        }
        std::memcpy(dst, samples.data(), samples.size());
    }

    // whether libtiff, reading the directory its own way, hands PIL rows of
    // the layout PIL's IFD reader expects (then the samples are decoded
    // directly)
    bool same_layout(const Tiff& L) const {
        // libtiff's RGBA interface hands PIL RGBA pixels whatever the
        // layout, which PIL's YCbCr rawmode ("RGBX") reads
        if (L.compression == 6 || L.ycc_rgba())
            return (compression == 6 || photometric == 6) && spp == 3 && bps == 8 &&
                   !(jpeg() && planar == 1);
        return L.spp == spp && L.bps == bps && L.planar == planar &&
               (L.photometric == 3) == (photometric == 3) && L.ycc_rgba() == ycc_rgba() &&
               L.jpeg() == jpeg() && (L.compression == 6) == (compression == 6) &&
               (!jpeg() || (L.photometric == 6) == (photometric == 6));
    }

    // bytes of one row of the buffer PIL's TiffDecode.c reads libtiff's data
    // into: RGBA pixels from the RGBA interface (YCbCr under another codec
    // than JPEG, old-style JPEG), the pixels libjpeg gives, or a scanline
    // (TIFFScanlineSize); 0 for a layout read otherwise (tiles, separate
    // planes)
    uint64_t pil_row_bytes() const {
        if (compression == 6 || ycc_rgba()) return (uint64_t)width * 4;
        if (tiled || planar == 2) return 0;
        if (jpeg()) return (uint64_t)width * channels();
        return scanline_bytes();
    }

    // TiffDecode.c _decodeStrip: the rows per strip PIL steps by (the tag's,
    // unless absent or 2^32 - 1: the image's height; -1 where the value
    // reads negative as an int, which PIL refuses) and TIFFStripSize
    int64_t pil_rows_per_strip() const {
        if (!rps_set || rows_per_strip == 0xFFFFFFFFu) return height;
        return rows_per_strip >= 0x80000000u ? -1 : (int64_t)rows_per_strip;
    }
    uint64_t strip_bytes() const {
        return scanline_bytes() * std::min(rows_per_strip, height);
    }

    // the rows of that buffer (height x pil_row_bytes()), for PIL's unpacker
    // to read the start of each as its own layout
    void decode_rows(uint8_t* dst, inflate_fn inflate) {
        const uint64_t rb = pil_row_bytes();
        keep_indices = true;
        const int ch = photometric == 3 ? (int)spp : channels(), sb = photometric == 3 ? 1 : sample_bytes();
        std::vector<uint8_t> px((size_t)width * height * ch * sb);
        decode(px.data(), inflate);
        const size_t row_px = (size_t)width * ch * sb;
        for (uint32_t y = 0; y < height; ++y) {
            const uint8_t* in = px.data() + row_px * y;
            uint8_t* out = dst + rb * y;
            if (compression == 6 || ycc_rgba()) {
                for (uint32_t x = 0; x < width; ++x) {
                    std::memcpy(out + 4 * x, in + 3 * x, 3);
                    out[4 * x + 3] = 255;
                }
            } else if (jpeg() || bps == 8 || bps == 16 || bps == 32) {
                std::memcpy(out, in, std::min<uint64_t>(rb, row_px));
            } else {
                // packed samples, most significant bit first
                std::memset(out, 0, rb);
                const size_t nvals = (size_t)width * spp;
                for (size_t i = 0; i < nvals; ++i) {
                    uint32_t val = sb == 1 ? in[i] : (uint32_t)(in[2 * i] | in[2 * i + 1] << 8);
                    for (uint32_t b = 0; b < bps; ++b) {
                        const size_t bit = i * bps + b;
                        if ((val >> (bps - 1 - b)) & 1) out[bit >> 3] |= (uint8_t)(0x80 >> (bit & 7));
                    }
                }
            }
        }
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
// GifDecode.c writes them; stops when the frame is full, when the data
// ends, or at an end code whose bits end past the first `end_skip` bytes
// (PIL's decoder returns at an end code, and goes on with the codes after
// it when its reader has more of the file to hand it). Returns the count
// of pixels written.
int64_t gif_lzw(const uint8_t* d, size_t n, int bits, int w, int h, bool interlace,
                size_t end_skip, uint8_t* out) {
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
        if (code == end) {
            if (pos <= end_skip) continue;
            break;
        }
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
        std::memset(info, 0, sizeof(int32_t) * 32);
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
            // a side past 2^31 - 1 is reported as 2^31 - 1: past PIL's
            // decompression-bomb limit all the same (utils/io.py refuses it)
            info[0] = (int32_t)std::min<uint32_t>(t.width, INT32_MAX);
            info[1] = (int32_t)std::min<uint32_t>(t.height, INT32_MAX);
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
            // [22] how libtiff's reading of the directory relates to PIL's
            // (0 the same layout, 1 other rows for PIL's unpacker, [23]
            // bytes each; 2 libtiff refuses the directory or the layout);
            // [24] libtiff's BitsPerSample; for other rows in strips, [25]
            // TIFFStripSize and [26] the rows per strip PIL steps by
            // (-1: PIL refuses them), [27] 1 for RGBA rows
            if (t.compression != 1) {
                try {
                    Tiff L = t.libtiff_view();
                    info[24] = (int32_t)L.bps;
                    if (L.width != t.width || L.height != t.height) {
                        info[22] = 2;
                    } else if (!t.same_layout(L)) {
                        const uint64_t rb = L.pil_row_bytes();
                        info[22] = rb && rb < INT32_MAX ? 1 : 2;
                        info[23] = (int32_t)std::min<uint64_t>(rb, INT32_MAX);
                        info[25] = (int32_t)std::min<uint64_t>(L.strip_bytes(), INT32_MAX);
                        info[26] = (int32_t)std::max<int64_t>(L.pil_rows_per_strip(), -1);
                        info[27] = L.compression == 6 || L.ycc_rgba();
                    }
                } catch (const std::exception&) {
                    info[22] = 2;
                }
            }
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
            if (t.compression == 1) {
                // PIL reads uncompressed strips itself
                t.check_supported();
                if ((int64_t)t.width * t.height * t.channels() * t.sample_bytes() != out_size)
                    fail("output buffer size does not match the image");
                t.decode(out, inflate);
            } else {
                // libtiff decodes what its own reading of the directory says
                t.check_open();
                if (t.photometric == 3) t.check_palette();
                Tiff L = t.libtiff_view();
                if (L.width != t.width || L.height != t.height)
                    fail("TIFF: libtiff reads an image of " + std::to_string(L.width) + " x " +
                         std::to_string(L.height) + " where PIL's IFD reader reads " +
                         std::to_string(t.width) + " x " + std::to_string(t.height) +
                         " (PIL: inconsistent image, decoder error)");
                if (L.photometric == 3 && t.photometric == 3) L.colormap = t.colormap;
                L.check_supported();
                // TiffDecode.c _decodeTile: PIL's tile of its rows (its bits
                // per pixel) must hold TIFFTileSize
                const uint64_t bits = L.planar == 2 ? L.bps : (uint64_t)L.spp * L.bps;
                if (L.tiled && L.compression != 6 && !L.ycc_rgba() &&
                    ((uint64_t)L.tile_h * bits + 7) / 8 * L.tile_w <
                        (uint64_t)L.tile_h * (((uint64_t)L.tile_w * (L.planar == 2 ? 1 : L.spp) *
                                               L.bps + 7) / 8))
                    fail("TIFF: a tile of " + std::to_string(L.tile_w) + " x " +
                         std::to_string(L.tile_h) + " holds more bytes than PIL's tile buffer "
                         "(PIL: decoder error)");
                if (!L.tiled && L.compression != 6 && !L.ycc_rgba() && L.pil_rows_per_strip() < 0)
                    fail("TIFF: RowsPerStrip " + std::to_string(L.rows_per_strip) +
                         " reads negative in PIL's decoder (PIL: decoder error)");
                if (t.same_layout(L)) {
                    if ((int64_t)t.width * t.height * t.channels() * t.sample_bytes() != out_size)
                        fail("output buffer size does not match the image");
                    L.decode(out, inflate);
                } else {
                    if ((int64_t)L.pil_row_bytes() * L.height != out_size)
                        fail("output buffer size does not match libtiff's rows");
                    L.decode_rows(out, inflate);
                }
            }
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
// data ends early); an end code read from the first end_skip bytes does
// not stop it. Returns the pixels written, or -1 with a message in err.
int64_t citlab_gif_lzw(const uint8_t* data, int64_t n, int32_t min_code_size, int32_t width,
                       int32_t height, int32_t interlace, int64_t end_skip, uint8_t* out,
                       char* err, int32_t errlen) {
    try {
        return gif_lzw(data, (size_t)n, min_code_size, width, height, interlace != 0,
                       (size_t)std::max<int64_t>(end_skip, 0), out);
    } catch (const std::exception& e) {
        copy_error(e.what(), err, errlen);
        return -1;
    }
}

}  // extern "C"
