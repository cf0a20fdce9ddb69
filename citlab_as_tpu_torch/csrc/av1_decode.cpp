// AV1 intra-frame decoder: the shown key frame (or intra-only frame) of an
// AVIF image item, decoded to 8-, 10- or 12-bit planes as dav1d 1.5.1
// decodes it, and libavif 1.3.0's conversion of such planes to 8-bit RGB.
//
// It covers the OBU layer (temporal delimiter, sequence header reduced or
// full, frame header / frame / tile group OBUs), uniform and explicit tile
// layouts, quantizer parameters with U/V delta q and quantizer matrices,
// segmentation, delta q and delta loop filter, the multi-symbol arithmetic
// decoder with CDF adaptation, the intra block syntax (partition, segment id,
// skip, CDEF index, y / uv modes with angle deltas, CfL alphas, palette with
// its colour cache and colour index map, filter intra, transform size and
// type, coefficients), IntraBC (the reference DV stack of an intra frame, the
// DV read and the copy with AV1's bilinear chroma filter), every intra
// predictor with the edge filter and upsampling, the inverse transforms
// (DCT 4-64, ADST 4-16, flipped ADST, identity, WHT), and the in-loop
// filters: deblocking, CDEF, superres upscaling and loop restoration
// (Wiener and self-guided), then film grain synthesis on the output frame as
// dav1d applies it. The constant tables are generated into av1_tables.h by
// scripts/make_av1_tables.py.
//
// The flow follows the AV1 specification's decoding process; the names of
// its syntax elements and variables are kept where they help.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

#include "av1_tables.h"

namespace {

struct DecodeError : std::runtime_error {
    using std::runtime_error::runtime_error;
};

// a frame this intra-frame decoder cannot follow (inter, hidden, or shown
// from the reference buffer): an error for the image's frame, the end of
// what it checks in the data after that frame
struct Unfollowed : DecodeError {
    using DecodeError::DecodeError;
};

[[noreturn]] void fail(const std::string& msg) { throw DecodeError(msg); }

inline int clip3(int lo, int hi, int v) { return v < lo ? lo : (v > hi ? hi : v); }
inline int round2(int x, int n) { return n == 0 ? x : (x + (1 << (n - 1))) >> n; }
inline int64_t round2l(int64_t x, int n) { return n == 0 ? x : (x + (int64_t(1) << (n - 1))) >> n; }
inline int round2signed(int x, int n) { return x >= 0 ? round2(x, n) : -round2(-x, n); }
inline int floor_log2(uint32_t x) { int s = 0; while (x > 1) { x >>= 1; s++; } return s; }
inline int ceil_log2(int x) {
    int i = 0;
    while ((1 << i) < x) i++;
    return i;
}

// ---------------------------------------------------------------- bit reader
struct BitReader {
    const uint8_t* data;
    size_t size;
    size_t pos = 0;  // in bits
    BitReader(const uint8_t* d, size_t n) : data(d), size(n) {}
    int bit() {
        if ((pos >> 3) >= size) fail("header runs past the end of its OBU");
        int b = (data[pos >> 3] >> (7 - (pos & 7))) & 1;
        pos++;
        return b;
    }
    uint32_t f(int n) {
        uint32_t x = 0;
        for (int i = 0; i < n; i++) x = (x << 1) | bit();
        return x;
    }
    int su(int n) { int v = int(f(n)); int m = 1 << (n - 1); return (v & m) ? v - 2 * m : v; }
    uint32_t ns(uint32_t n) {
        int w = 0; uint32_t x = n; while (x) { w++; x >>= 1; }
        uint32_t m = (1u << w) - n;
        uint32_t v = f(w - 1);
        if (v < m) return v;
        return (v << 1) - m + bit();
    }
    uint32_t uvlc() {
        int lz = 0;
        while (!bit()) { lz++; if (lz >= 32) return 0xffffffffu; }
        if (lz >= 32) return 0xffffffffu;
        return f(lz) + (1u << lz) - 1;
    }
    void byte_align() { pos = (pos + 7) & ~size_t(7); }
};

// ------------------------------------------------------ the symbol decoder
// The specification's init_symbol / read_symbol / exit_symbol, fed from the
// tile's bytes; past the end of the tile it reads zero bits, as dav1d does.
struct SymbolDecoder {
    const uint8_t* data = nullptr;
    size_t size = 0;
    size_t bitpos = 0;
    int64_t max_bits = 0;
    uint32_t value = 0, range = 0;
    bool adapt = true;

    uint32_t read_bits(int n) {  // n <= 16; zeros past the end
        if (n == 0) return 0;
        size_t byte = bitpos >> 3;
        uint32_t window = 0;
        for (int k = 0; k < 3; k++)
            window = (window << 8) | (byte + k < size ? data[byte + k] : 0);
        uint32_t x = (window >> (24 - int(bitpos & 7) - n)) & ((1u << n) - 1);
        bitpos += size_t(n);
        return x;
    }
    void init(const uint8_t* d, size_t n, bool disable_update) {
        data = d; size = n; bitpos = 0;
        int num_bits = int(std::min<size_t>(n * 8, 15));
        uint32_t buf = read_bits(num_bits);
        uint32_t padded = buf << (15 - num_bits);
        value = ((1u << 15) - 1) ^ padded;
        range = 1u << 15;
        max_bits = int64_t(8) * n - 15;
        adapt = !disable_update;
    }
    void renorm(uint32_t new_range, uint32_t new_value) {
        int bits = 15 - floor_log2(new_range);
        range = new_range << bits;
        int num_bits = int(std::min<int64_t>(bits, std::max<int64_t>(0, max_bits)));
        uint32_t new_data = read_bits(num_bits);
        uint32_t padded = new_data << (bits - num_bits);
        value = padded ^ (((new_value + 1) << bits) - 1);
        max_bits -= bits;
    }
    // cdf: n - 1 values of 32768 - cdf, then 0, then the adaptation count
    int symbol(uint16_t* cdf, int n) {
        uint32_t cur = range, prev;
        int sym = -1;
        do {
            sym++;
            prev = cur;
            uint32_t fv = cdf[sym];
            cur = ((range >> 8) * (fv >> 6) >> 1) + 4 * uint32_t(n - sym - 1);
        } while (value < cur);
        renorm(prev - cur, value - cur);
        if (adapt) {
            int count = cdf[n];
            int rate = 3 + (count > 15) + (count > 31) + std::min(floor_log2(n), 2);
            for (int i = 0; i < n - 1; i++) {
                if (i < sym) cdf[i] += (32768 - cdf[i]) >> rate;
                else cdf[i] -= cdf[i] >> rate;
            }
            cdf[n] = uint16_t(count + (count < 32));
        }
        return sym;
    }
    // a bool with P(1) = f / 32768, not adapted
    int boolean(uint32_t f) {
        uint32_t cur = ((range >> 8) * (f >> 6) >> 1) + 4;
        if (value < cur) { renorm(cur, value); return 1; }
        renorm(range - cur, value - cur);
        return 0;
    }
    int literal(int n) {
        int x = 0;
        for (int i = 0; i < n; i++) x = 2 * x + boolean(16384);
        return x;
    }
    int ns(int n) {
        int w = floor_log2(uint32_t(n)) + 1;
        int m = (1 << w) - n;
        int v = literal(w - 1);
        if (v < m) return v;
        return (v << 1) - m + literal(1);
    }
};

// ------------------------------------------------------------ size tables
enum { BLOCK_4X4, BLOCK_4X8, BLOCK_8X4, BLOCK_8X8, BLOCK_8X16, BLOCK_16X8, BLOCK_16X16,
       BLOCK_16X32, BLOCK_32X16, BLOCK_32X32, BLOCK_32X64, BLOCK_64X32, BLOCK_64X64,
       BLOCK_64X128, BLOCK_128X64, BLOCK_128X128, BLOCK_4X16, BLOCK_16X4, BLOCK_8X32,
       BLOCK_32X8, BLOCK_16X64, BLOCK_64X16, BLOCK_SIZES, BLOCK_INVALID = -1 };
const int bw_log2[BLOCK_SIZES] = {0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 0, 2, 1, 3, 2, 4};
const int bh_log2[BLOCK_SIZES] = {0, 1, 0, 1, 2, 1, 2, 3, 2, 3, 4, 3, 4, 5, 4, 5, 2, 0, 3, 1, 4, 2};
inline int bw4(int b) { return 1 << bw_log2[b]; }
inline int bh4(int b) { return 1 << bh_log2[b]; }

int block_of(int wl, int hl) {  // log2 of the size in 4-pixel units
    for (int b = 0; b < BLOCK_SIZES; b++) if (bw_log2[b] == wl && bh_log2[b] == hl) return b;
    return BLOCK_INVALID;
}

enum { TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64, TX_4X8, TX_8X4, TX_8X16, TX_16X8,
       TX_16X32, TX_32X16, TX_32X64, TX_64X32, TX_4X16, TX_16X4, TX_8X32, TX_32X8, TX_16X64,
       TX_64X16, TX_SIZES_ALL };
const int txw_log2[TX_SIZES_ALL] = {2, 3, 4, 5, 6, 2, 3, 3, 4, 4, 5, 5, 6, 2, 4, 3, 5, 4, 6};
const int txh_log2[TX_SIZES_ALL] = {2, 3, 4, 5, 6, 3, 2, 4, 3, 5, 4, 6, 5, 4, 2, 5, 3, 6, 4};
inline int txw(int t) { return 1 << txw_log2[t]; }
inline int txh(int t) { return 1 << txh_log2[t]; }
int tx_of(int wl, int hl) {
    for (int t = 0; t < TX_SIZES_ALL; t++) if (txw_log2[t] == wl && txh_log2[t] == hl) return t;
    return -1;
}
inline int tx_sqr(int t) {
    int l = std::min(txw_log2[t], txh_log2[t]);
    return tx_of(l, l);
}
inline int tx_sqr_up(int t) {
    int l = std::max(txw_log2[t], txh_log2[t]);
    return tx_of(l, l);
}
const int split_tx[TX_SIZES_ALL] = {TX_4X4, TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_4X4, TX_4X4,
                                    TX_8X8, TX_8X8, TX_16X16, TX_16X16, TX_32X32, TX_32X32,
                                    TX_4X8, TX_8X4, TX_8X16, TX_16X8, TX_16X32, TX_32X16};
int max_tx_rect(int b) {
    return tx_of(std::min(bw_log2[b] + 2, 6), std::min(bh_log2[b] + 2, 6));
}
int adjusted_tx(int t) { return tx_of(std::min(txw_log2[t], 5), std::min(txh_log2[t], 5)); }

enum { DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED, D203_PRED,
       D67_PRED, SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED, UV_CFL_PRED };
const int mode_to_angle[13] = {0, 90, 180, 45, 135, 113, 157, 203, 67, 0, 0, 0, 0};
inline bool is_directional(int m) { return m >= V_PRED && m <= D67_PRED; }
const int intra_mode_context[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};

enum { DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST, FLIPADST_FLIPADST,
       ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST,
       H_FLIPADST };
// mode_to_txfm: the transform type implied by an intra mode (and CfL)
const int mode_to_txfm[14] = {DCT_DCT, ADST_DCT, DCT_ADST, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST,
                              DCT_ADST, ADST_DCT, ADST_ADST, ADST_DCT, DCT_ADST, ADST_ADST,
                              DCT_DCT};
const int tx_intra_inv_set1[7] = {IDTX, DCT_DCT, V_DCT, H_DCT, ADST_ADST, ADST_DCT, DCT_ADST};
const int tx_intra_inv_set2[5] = {IDTX, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST};
// the symbol order of dav1d's dav1d_tx_types_per_set
const int tx_inter_inv_set1[16] = {IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST, H_FLIPADST,
                                   DCT_DCT, ADST_DCT, DCT_ADST, FLIPADST_DCT, DCT_FLIPADST,
                                   ADST_ADST, FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST};
const int tx_inter_inv_set2[12] = {IDTX, V_DCT, H_DCT, DCT_DCT, ADST_DCT, DCT_ADST, FLIPADST_DCT,
                                   DCT_FLIPADST, ADST_ADST, FLIPADST_FLIPADST, ADST_FLIPADST,
                                   FLIPADST_ADST};
const int tx_inter_inv_set3[2] = {IDTX, DCT_DCT};
enum { TX_SET_DCTONLY, TX_SET_INTRA_1, TX_SET_INTRA_2, TX_SET_INTER_1, TX_SET_INTER_2,
       TX_SET_INTER_3 };
enum { TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT };
inline int tx_class(int t) {
    if (t == V_DCT || t == V_ADST || t == V_FLIPADST) return TX_CLASS_VERT;
    if (t == H_DCT || t == H_ADST || t == H_FLIPADST) return TX_CLASS_HORIZ;
    return TX_CLASS_2D;
}
bool tx_in_set(int set, int t) {
    const int* list; int n;
    switch (set) {
        case TX_SET_DCTONLY: return t == DCT_DCT;
        case TX_SET_INTRA_1: list = tx_intra_inv_set1; n = 7; break;
        case TX_SET_INTRA_2: list = tx_intra_inv_set2; n = 5; break;
        case TX_SET_INTER_1: list = tx_inter_inv_set1; n = 16; break;
        case TX_SET_INTER_2: list = tx_inter_inv_set2; n = 12; break;
        default: list = tx_inter_inv_set3; n = 2; break;
    }
    for (int i = 0; i < n; i++) if (list[i] == t) return true;
    return false;
}

// scans in the specification's layout (row-major positions)
struct Scans {
    std::vector<uint16_t> deflt[TX_SIZES_ALL], mrow[TX_SIZES_ALL], mcol[TX_SIZES_ALL];
    Scans() {
        for (int t = 0; t < TX_SIZES_ALL; t++) {
            int a = adjusted_tx(t);
            int w = txw(a), h = txh(a);
            auto& d = deflt[t];
            for (int s = 0; s < w + h - 1; s++) {
                std::vector<uint16_t> cells;
                for (int r = 0; r < h; r++) {
                    int c = s - r;
                    if (c >= 0 && c < w) cells.push_back(uint16_t(r * w + c));
                }
                bool rev;
                if (w == h) rev = (s % 2 == 0);   // zig-zag
                else rev = w > h;                   // diagonal
                if (rev) std::reverse(cells.begin(), cells.end());
                d.insert(d.end(), cells.begin(), cells.end());
            }
            for (int i = 0; i < w * h; i++) mrow[t].push_back(uint16_t(i));
            for (int c = 0; c < w; c++)
                for (int r = 0; r < h; r++) mcol[t].push_back(uint16_t(r * w + c));
        }
    }
};
const Scans& scans() { static Scans s; return s; }

// ------------------------------------------------------------ CDF context
struct MvCdf {
    uint16_t joints[5];
    uint16_t classes[2][12];
    uint16_t class0[2][3];
    uint16_t bits[2][10][3];
    uint16_t sign[2][3];
};
struct CdfContext {
    uint16_t kf_y_mode[5][5][14];
    uint16_t uv_mode[2][13][15];
    uint16_t angle_delta[8][8];
    uint16_t partition[20][11];
    uint16_t cfl_alpha[6][17];
    uint16_t use_filter_intra[22][3];
    uint16_t eob_pt_16[2][2][6], eob_pt_32[2][2][7], eob_pt_64[2][2][8], eob_pt_128[2][2][9],
        eob_pt_256[2][2][10], eob_pt_512[2][2][11], eob_pt_1024[2][2][12];
    uint16_t coeff_base_eob[5][2][4][4];
    uint16_t coeff_base[5][2][42][5];
    uint16_t coeff_br[5][2][21][5];
    uint16_t dc_sign[2][3][3];
    uint16_t eob_extra[5][2][9][3];
    uint16_t txb_skip[5][13][3];
    uint16_t inter_tx_set1[2][17], inter_tx_set2[13], inter_tx_set3[4][3];
    uint16_t txfm_split[21][3];
    uint16_t intra_tx_set1[2][13][8], intra_tx_set2[3][13][6];
    uint16_t cfl_sign[9], filter_intra_mode[6], segment_id[3][9];
    uint16_t palette_size[2][7][8], palette_color[2][7][5][9];
    uint16_t tx_depth[4][3][4], delta_q[5], delta_lf[5][5], skip[3][3];
    uint16_t palette_y_mode[7][3][3], palette_uv_mode[2][3], intrabc[3];
    uint16_t restoration_type[4], use_wiener[3], use_sgrproj[3];
    MvCdf mv;

    void init(int base_q_idx) {
        using namespace av1t;
        int q = base_q_idx <= 20 ? 0 : base_q_idx <= 60 ? 1 : base_q_idx <= 120 ? 2 : 3;
#define CP(dst, src) static_assert(sizeof(dst) == sizeof(src), #dst); memcpy(dst, src, sizeof(dst))
        CP(kf_y_mode, kf_y_mode_cdf); CP(uv_mode, uv_mode_cdf); CP(angle_delta, angle_delta_cdf);
        CP(partition, partition_cdf); CP(cfl_alpha, cfl_alpha_cdf);
        CP(use_filter_intra, use_filter_intra_cdf);
        CP(eob_pt_16, eob_pt_16_cdf[q]); CP(eob_pt_32, eob_pt_32_cdf[q]);
        CP(eob_pt_64, eob_pt_64_cdf[q]); CP(eob_pt_128, eob_pt_128_cdf[q]);
        CP(eob_pt_256, eob_pt_256_cdf[q]); CP(eob_pt_512, eob_pt_512_cdf[q]);
        CP(eob_pt_1024, eob_pt_1024_cdf[q]);
        CP(coeff_base_eob, coeff_base_eob_cdf[q]); CP(coeff_base, coeff_base_cdf[q]);
        CP(coeff_br, coeff_br_cdf[q]); CP(dc_sign, dc_sign_cdf[q]);
        CP(eob_extra, eob_extra_cdf[q]); CP(txb_skip, txb_skip_cdf[q]);
        CP(inter_tx_set1, inter_tx_set1_cdf); CP(inter_tx_set2, inter_tx_set2_cdf[0]);
        CP(inter_tx_set3, inter_tx_set3_cdf); CP(txfm_split, txfm_split_cdf);
        CP(intra_tx_set1, intra_tx_set1_cdf); CP(intra_tx_set2, intra_tx_set2_cdf);
        CP(cfl_sign, cfl_sign_cdf[0]); CP(filter_intra_mode, filter_intra_mode_cdf[0]);
        CP(segment_id, segment_id_cdf); CP(palette_size, palette_size_cdf);
        CP(palette_color, palette_color_cdf); CP(tx_depth, tx_depth_cdf);
        CP(delta_q, delta_q_cdf[0]); CP(delta_lf, delta_lf_cdf); CP(skip, skip_cdf);
        CP(palette_y_mode, palette_y_mode_cdf); CP(palette_uv_mode, palette_uv_mode_cdf);
        CP(intrabc, intrabc_cdf[0]);
        CP(restoration_type, restoration_type_cdf[0]); CP(use_wiener, use_wiener_cdf[0]);
        CP(use_sgrproj, use_sgrproj_cdf[0]);
        CP(mv.joints, mv_joints_cdf);
        for (int c = 0; c < 2; c++) {
            CP(mv.classes[c], mv_classes_cdf); CP(mv.class0[c], mv_class0_cdf);
            CP(mv.bits[c], mv_bits_cdf); CP(mv.sign[c], mv_sign_cdf);
        }
#undef CP
    }
};

// ------------------------------------------------------------ headers
struct SequenceHeader {
    int profile = 0, still_picture = 0, reduced = 0;
    int timing_info_present = 0, decoder_model_info_present = 0, equal_picture_interval = 0;
    int buffer_delay_length = 0, buffer_removal_time_length = 0, frame_presentation_time_length = 0;
    int op_cnt = 1;
    int op_idc[32] = {0}, decoder_model_present_for_op[32] = {0};
    int frame_width_bits = 0, frame_height_bits = 0, max_w = 0, max_h = 0;
    int frame_id_numbers_present = 0, delta_frame_id_length = 0, additional_frame_id_length = 0;
    int sb128 = 0, enable_filter_intra = 0, enable_intra_edge_filter = 0;
    int enable_order_hint = 0, order_hint_bits = 0;
    int seq_force_screen_content_tools = 2, seq_force_integer_mv = 2;
    int enable_superres = 0, enable_cdef = 0, enable_restoration = 0;
    int bit_depth = 8, mono = 0, color_description_present = 0;
    int color_primaries = 2, transfer = 2, matrix = 2, color_range = 0;
    int ss_x = 1, ss_y = 1, chroma_sample_position = 0, separate_uv_delta_q = 0;
    int film_grain_params_present = 0;
    int num_planes() const { return mono ? 1 : 3; }
};

void parse_sequence_header(BitReader& b, SequenceHeader& s) {
    s.profile = b.f(3);
    if (s.profile > 2) fail("sequence header: seq_profile " + std::to_string(s.profile));
    s.still_picture = b.f(1);
    s.reduced = b.f(1);
    if (s.reduced && !s.still_picture)
        fail("sequence header: reduced header of a non-still picture");
    if (s.reduced) {
        s.op_cnt = 1; s.op_idc[0] = 0;
        b.f(5);  // seq_level_idx
    } else {
        s.timing_info_present = b.f(1);
        if (s.timing_info_present) {
            b.f(32); b.f(32);
            s.equal_picture_interval = b.f(1);
            if (s.equal_picture_interval) {
                if (b.uvlc() == 0xffffffffu) fail("sequence header: num_ticks_per_picture");
            }
            s.decoder_model_info_present = b.f(1);
            if (s.decoder_model_info_present) {
                s.buffer_delay_length = b.f(5) + 1;
                b.f(32);
                s.buffer_removal_time_length = b.f(5) + 1;
                s.frame_presentation_time_length = b.f(5) + 1;
            }
        }
        int initial_display_delay_present = b.f(1);
        s.op_cnt = b.f(5) + 1;
        for (int i = 0; i < s.op_cnt; i++) {
            s.op_idc[i] = b.f(12);
            if (s.op_idc[i] && (!(s.op_idc[i] & 0xff) || !(s.op_idc[i] & 0xf00)))
                fail("sequence header: operating_point_idc without a temporal or spatial layer");
            int level = b.f(5);
            if (level > 7) b.f(1);
            if (s.decoder_model_info_present) {
                s.decoder_model_present_for_op[i] = b.f(1);
                if (s.decoder_model_present_for_op[i]) {
                    b.f(s.buffer_delay_length); b.f(s.buffer_delay_length); b.f(1);
                }
            }
            if (initial_display_delay_present) {
                if (b.f(1)) b.f(4);
            }
        }
    }
    s.frame_width_bits = b.f(4) + 1;
    s.frame_height_bits = b.f(4) + 1;
    s.max_w = b.f(s.frame_width_bits) + 1;
    s.max_h = b.f(s.frame_height_bits) + 1;
    if (!s.reduced) s.frame_id_numbers_present = b.f(1);
    if (s.frame_id_numbers_present) {
        s.delta_frame_id_length = b.f(4) + 2;
        s.additional_frame_id_length = b.f(3) + 1;
    }
    s.sb128 = b.f(1);
    s.enable_filter_intra = b.f(1);
    s.enable_intra_edge_filter = b.f(1);
    if (!s.reduced) {
        b.f(1); b.f(1); b.f(1); b.f(1);  // interintra, masked compound, warped, dual filter
        s.enable_order_hint = b.f(1);
        if (s.enable_order_hint) { b.f(1); b.f(1); }  // jnt_comp, ref_frame_mvs
        if (b.f(1)) s.seq_force_screen_content_tools = 2;
        else s.seq_force_screen_content_tools = b.f(1);
        if (s.seq_force_screen_content_tools > 0) {
            if (b.f(1)) s.seq_force_integer_mv = 2;
            else s.seq_force_integer_mv = b.f(1);
        } else {
            s.seq_force_integer_mv = 2;
        }
        if (s.enable_order_hint) s.order_hint_bits = b.f(3) + 1;
    }
    s.enable_superres = b.f(1);
    s.enable_cdef = b.f(1);
    s.enable_restoration = b.f(1);
    // colour config
    int high_bitdepth = b.f(1);
    if (s.profile == 2 && high_bitdepth) s.bit_depth = b.f(1) ? 12 : 10;
    else s.bit_depth = high_bitdepth ? 10 : 8;
    s.mono = s.profile == 1 ? 0 : b.f(1);
    s.color_description_present = b.f(1);
    if (s.color_description_present) {
        s.color_primaries = b.f(8); s.transfer = b.f(8); s.matrix = b.f(8);
    }
    if (s.mono) {
        s.color_range = b.f(1);
        s.ss_x = s.ss_y = 1;
        s.separate_uv_delta_q = 0;
    } else if (s.color_primaries == 1 && s.transfer == 13 && s.matrix == 0) {
        s.color_range = 1;
        s.ss_x = s.ss_y = 0;
        if (!(s.profile == 1 || (s.profile == 2 && s.bit_depth == 12)))
            fail("sequence header: sRGB colour in a profile without 4:4:4");
        s.separate_uv_delta_q = b.f(1);
    } else {
        s.color_range = b.f(1);
        if (s.profile == 0) { s.ss_x = s.ss_y = 1; }
        else if (s.profile == 1) { s.ss_x = s.ss_y = 0; }
        else {
            if (s.bit_depth == 12) {
                s.ss_x = b.f(1);
                s.ss_y = s.ss_x ? b.f(1) : 0;
            } else {
                s.ss_x = 1; s.ss_y = 0;
            }
        }
        if (s.ss_x && s.ss_y) s.chroma_sample_position = b.f(2);
        s.separate_uv_delta_q = b.f(1);
    }
    s.film_grain_params_present = b.f(1);
    b.f(1);  // dav1d reads the trailing one bit: the header must not fill its OBU
}

// film_grain_params(), in dav1d's Dav1dFilmGrainData form (the AR
// coefficients and multipliers less 128, the offsets less 256)
struct FilmGrainParams {
    int apply = 0;
    unsigned seed = 0;
    int num_y_points = 0;
    uint8_t y_points[14][2] = {};
    int chroma_scaling_from_luma = 0;
    int num_uv_points[2] = {0, 0};
    uint8_t uv_points[2][10][2] = {};
    int scaling_shift = 8, ar_coeff_lag = 0;
    int8_t ar_coeffs_y[24] = {};
    int8_t ar_coeffs_uv[2][25] = {};
    int ar_coeff_shift = 6, grain_scale_shift = 0;
    int uv_mult[2] = {0, 0}, uv_luma_mult[2] = {0, 0}, uv_offset[2] = {0, 0};
    int overlap_flag = 0, clip_to_restricted_range = 0;
    // dav1d's has_grain: whether dav1d_apply_grain changes the picture
    bool has_grain() const {
        return num_y_points || num_uv_points[0] || num_uv_points[1] ||
               (clip_to_restricted_range && chroma_scaling_from_luma);
    }
};

// film_grain_params() of a shown (or showable) intra frame, whose
// update_grain is 1; dav1d's refusals of a malformed one
void parse_film_grain(BitReader& b, const SequenceHeader& s, FilmGrainParams& g) {
    g = FilmGrainParams();
    g.apply = b.f(1);
    if (!g.apply) return;
    g.seed = b.f(16);
    g.num_y_points = b.f(4);
    if (g.num_y_points > 14) fail("AV1 film grain: more than 14 luma scaling points");
    for (int i = 0; i < g.num_y_points; i++) {
        g.y_points[i][0] = uint8_t(b.f(8));
        if (i && g.y_points[i - 1][0] >= g.y_points[i][0])
            fail("AV1 film grain: luma scaling points out of order");
        g.y_points[i][1] = uint8_t(b.f(8));
    }
    g.chroma_scaling_from_luma = s.mono ? 0 : b.f(1);
    if (!(s.mono || g.chroma_scaling_from_luma || (s.ss_x && s.ss_y && !g.num_y_points))) {
        for (int pl = 0; pl < 2; pl++) {
            g.num_uv_points[pl] = b.f(4);
            if (g.num_uv_points[pl] > 10)
                fail("AV1 film grain: more than 10 chroma scaling points");
            for (int i = 0; i < g.num_uv_points[pl]; i++) {
                g.uv_points[pl][i][0] = uint8_t(b.f(8));
                if (i && g.uv_points[pl][i - 1][0] >= g.uv_points[pl][i][0])
                    fail("AV1 film grain: chroma scaling points out of order");
                g.uv_points[pl][i][1] = uint8_t(b.f(8));
            }
        }
    }
    if (s.ss_x && s.ss_y && !g.num_uv_points[0] != !g.num_uv_points[1])
        fail("AV1 film grain: 4:2:0 with scaling points for one chroma plane only");
    g.scaling_shift = b.f(2) + 8;
    g.ar_coeff_lag = b.f(2);
    int num_pos_luma = 2 * g.ar_coeff_lag * (g.ar_coeff_lag + 1);
    if (g.num_y_points)
        for (int i = 0; i < num_pos_luma; i++) g.ar_coeffs_y[i] = int8_t(int(b.f(8)) - 128);
    for (int pl = 0; pl < 2; pl++)
        if (g.num_uv_points[pl] || g.chroma_scaling_from_luma) {
            int n = num_pos_luma + (g.num_y_points ? 1 : 0);
            for (int i = 0; i < n; i++) g.ar_coeffs_uv[pl][i] = int8_t(int(b.f(8)) - 128);
        }
    g.ar_coeff_shift = b.f(2) + 6;
    g.grain_scale_shift = b.f(2);
    for (int pl = 0; pl < 2; pl++)
        if (g.num_uv_points[pl]) {
            g.uv_mult[pl] = int(b.f(8)) - 128;
            g.uv_luma_mult[pl] = int(b.f(8)) - 128;
            g.uv_offset[pl] = int(b.f(9)) - 256;
        }
    g.overlap_flag = b.f(1);
    g.clip_to_restricted_range = b.f(1);
}

enum { RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE };

const int seg_feature_bits[8] = {8, 6, 6, 6, 6, 3, 0, 0};
const int seg_feature_signed[8] = {1, 1, 1, 1, 1, 0, 0, 0};
const int seg_feature_max[8] = {255, 63, 63, 63, 63, 7, 0, 0};
enum { SEG_LVL_ALT_Q = 0, SEG_LVL_ALT_LF_Y_V = 1, SEG_LVL_REF_FRAME = 5, SEG_LVL_SKIP = 6 };

struct FrameHeader {
    int frame_type = 0, show_frame = 1, showable_frame = 0, error_resilient = 1;
    int disable_cdf_update = 0, allow_screen_content_tools = 0, force_integer_mv = 0;
    int frame_size_override = 0;
    int width = 0, height = 0, upscaled_width = 0, mi_cols = 0, mi_rows = 0;
    int superres_denom = 8;  // SUPERRES_NUM: no superres
    int allow_intrabc = 0;
    int disable_frame_end_update_cdf = 1;
    // tiles
    int tile_cols = 1, tile_rows = 1, tile_cols_log2 = 0, tile_rows_log2 = 0;
    std::vector<int> mi_col_starts, mi_row_starts;
    int context_update_tile_id = 0, tile_size_bytes = 4;
    // quantizer
    int base_q_idx = 0, dq_y_dc = 0, dq_u_dc = 0, dq_u_ac = 0, dq_v_dc = 0, dq_v_ac = 0;
    int using_qmatrix = 0, qm_y = 15, qm_u = 15, qm_v = 15;
    // segmentation
    int seg_enabled = 0;
    int feature_enabled[8][8] = {{0}}, feature_data[8][8] = {{0}};
    int seg_id_pre_skip = 0, last_active_seg_id = 0;
    // deltas
    int delta_q_present = 0, delta_q_res = 0, delta_lf_present = 0, delta_lf_res = 0,
        delta_lf_multi = 0;
    int coded_lossless = 0, all_lossless = 0;
    int lossless[8] = {0};
    int seg_qm_level[3][8];
    // loop filter
    int lf_level[4] = {0}, lf_sharpness = 0, lf_delta_enabled = 0;
    int lf_ref_deltas[8] = {1, 0, 0, 0, -1, 0, -1, -1}, lf_mode_deltas[2] = {0, 0};
    // cdef
    int cdef_damping = 3, cdef_bits = 0;
    int cdef_y_pri[8] = {0}, cdef_y_sec[8] = {0}, cdef_uv_pri[8] = {0}, cdef_uv_sec[8] = {0};
    bool cdef_on = false;  // a strength is not zero
    // loop restoration: FrameRestorationType per plane (RESTORE_*) and
    // LoopRestorationSize
    int lr_type[3] = {0, 0, 0}, lr_unit_size[3] = {0, 0, 0};
    bool uses_lr = false;
    int tx_mode_select = 0, only_4x4 = 0, reduced_tx_set = 0;
    FilmGrainParams grain;
};

int tile_log2(int blk, int target) { int k = 0; while ((blk << k) < target) k++; return k; }

int read_delta_q(BitReader& b) { return b.f(1) ? b.su(7) : 0; }

int get_qindex(const FrameHeader& h, int ignore_delta, int seg, int current_q) {
    if (h.seg_enabled && h.feature_enabled[seg][SEG_LVL_ALT_Q]) {
        int data = h.feature_data[seg][SEG_LVL_ALT_Q];
        int q = h.base_q_idx + data;
        if (!ignore_delta && h.delta_q_present) q = current_q + data;
        return clip3(0, 255, q);
    }
    if (!ignore_delta && h.delta_q_present) return current_q;
    return h.base_q_idx;
}

// The uncompressed header of a shown key frame or intra-only frame; any other
// frame is refused. Returns after the header's last bit.
void parse_frame_header(BitReader& b, const SequenceHeader& s, FrameHeader& h, int temporal_id,
                        int spatial_id) {
    if (s.reduced) {
        h.frame_type = 0; h.show_frame = 1; h.showable_frame = 0; h.error_resilient = 1;
    } else {
        if (b.f(1)) throw Unfollowed("AV1 show_existing_frame (the item holds no frame to show)");
        h.frame_type = b.f(2);
        h.show_frame = b.f(1);
        if (h.frame_type == 1 || h.frame_type == 3)
            throw Unfollowed("AV1 inter frame: its first shown frame needs inter prediction, "
                             "which this intra-frame decoder does not do");
        if (h.show_frame && s.decoder_model_info_present && !s.equal_picture_interval)
            b.f(s.frame_presentation_time_length);
        h.showable_frame = h.show_frame ? h.frame_type != 0 : b.f(1);
        if (h.frame_type == 0 && h.show_frame) h.error_resilient = 1;
        else h.error_resilient = b.f(1);
    }
    if (!h.show_frame)
        throw Unfollowed("AV1 frame that is not shown: the first shown frame after it needs "
                         "inter prediction, which this intra-frame decoder does not do");
    h.disable_cdf_update = b.f(1);
    if (s.seq_force_screen_content_tools == 2) h.allow_screen_content_tools = b.f(1);
    else h.allow_screen_content_tools = s.seq_force_screen_content_tools;
    if (h.allow_screen_content_tools) {
        if (s.seq_force_integer_mv == 2) h.force_integer_mv = b.f(1);
        else h.force_integer_mv = s.seq_force_integer_mv;
    }
    h.force_integer_mv = 1;  // an intra frame
    if (s.frame_id_numbers_present)
        b.f(s.additional_frame_id_length + s.delta_frame_id_length);
    if (s.reduced) h.frame_size_override = 0;
    else h.frame_size_override = b.f(1);
    b.f(s.order_hint_bits);
    // primary_ref_frame is none for an intra frame
    if (s.decoder_model_info_present) {
        if (b.f(1)) {
            for (int op = 0; op < s.op_cnt; op++) {
                if (s.decoder_model_present_for_op[op]) {
                    int idc = s.op_idc[op];
                    int in_t = (idc >> temporal_id) & 1, in_s = (idc >> (spatial_id + 8)) & 1;
                    if (idc == 0 || (in_t && in_s)) b.f(s.buffer_removal_time_length);
                }
            }
        }
    }
    int refresh = 0xff;
    if (!(h.frame_type == 0 && h.show_frame)) refresh = b.f(8);
    if (refresh != 0xff && h.error_resilient && s.enable_order_hint)
        for (int i = 0; i < 8; i++) b.f(s.order_hint_bits);
    // frame_size
    if (h.frame_size_override) {
        h.width = b.f(s.frame_width_bits) + 1;
        h.height = b.f(s.frame_height_bits) + 1;
    } else {
        h.width = s.max_w; h.height = s.max_h;
    }
    // superres_params: the frame is coded at the downscaled width, as dav1d
    // computes it (at least 16 pixels, or the whole width below that)
    h.upscaled_width = h.width;
    if (s.enable_superres && b.f(1)) {
        h.superres_denom = int(b.f(3)) + 9;
        h.width = std::max((h.upscaled_width * 8 + (h.superres_denom >> 1)) / h.superres_denom,
                           std::min(16, h.upscaled_width));
    }
    // dav1d's frame_size_limit, which libavif sets to its image size limit
    if (int64_t(h.upscaled_width) * h.height > int64_t(16384) * 16384)
        fail("AV1 frame of " + std::to_string(h.upscaled_width) + " x " +
             std::to_string(h.height) + " past dav1d's frame size limit");
    h.mi_cols = 2 * ((h.width + 7) >> 3);
    h.mi_rows = 2 * ((h.height + 7) >> 3);
    if (b.f(1)) { b.f(16); b.f(16); }  // render size
    if (h.allow_screen_content_tools && h.upscaled_width == h.width) h.allow_intrabc = b.f(1);
    if (s.reduced || h.disable_cdf_update) h.disable_frame_end_update_cdf = 1;
    else h.disable_frame_end_update_cdf = b.f(1);
    // tile info
    int sb_cols = s.sb128 ? (h.mi_cols + 31) >> 5 : (h.mi_cols + 15) >> 4;
    int sb_rows = s.sb128 ? (h.mi_rows + 31) >> 5 : (h.mi_rows + 15) >> 4;
    int sb_shift = s.sb128 ? 5 : 4;
    int sb_size = sb_shift + 2;
    int max_tile_width_sb = 4096 >> sb_size;
    int max_tile_area_sb = (4096 * 2304) >> (2 * sb_size);
    int min_log2_tile_cols = tile_log2(max_tile_width_sb, sb_cols);
    int max_log2_tile_cols = tile_log2(1, std::min(sb_cols, 64));
    int max_log2_tile_rows = tile_log2(1, std::min(sb_rows, 64));
    int min_log2_tiles =
        std::max(min_log2_tile_cols, tile_log2(max_tile_area_sb, sb_rows * sb_cols));
    h.mi_col_starts.clear(); h.mi_row_starts.clear();
    if (b.f(1)) {  // uniform
        h.tile_cols_log2 = min_log2_tile_cols;
        while (h.tile_cols_log2 < max_log2_tile_cols && b.f(1)) h.tile_cols_log2++;
        int tw = (sb_cols + (1 << h.tile_cols_log2) - 1) >> h.tile_cols_log2;
        for (int start = 0; start < sb_cols; start += tw)
            h.mi_col_starts.push_back(start << sb_shift);
        h.mi_col_starts.push_back(h.mi_cols);
        h.tile_cols = int(h.mi_col_starts.size()) - 1;
        int min_log2_tile_rows = std::max(min_log2_tiles - h.tile_cols_log2, 0);
        h.tile_rows_log2 = min_log2_tile_rows;
        while (h.tile_rows_log2 < max_log2_tile_rows && b.f(1)) h.tile_rows_log2++;
        int th = (sb_rows + (1 << h.tile_rows_log2) - 1) >> h.tile_rows_log2;
        for (int start = 0; start < sb_rows; start += th)
            h.mi_row_starts.push_back(start << sb_shift);
        h.mi_row_starts.push_back(h.mi_rows);
        h.tile_rows = int(h.mi_row_starts.size()) - 1;
    } else {
        int widest = 0, start = 0;
        while (start < sb_cols) {
            h.mi_col_starts.push_back(start << sb_shift);
            int max_w = std::min(sb_cols - start, max_tile_width_sb);
            int size = int(b.ns(max_w)) + 1;
            widest = std::max(size, widest);
            start += size;
        }
        h.mi_col_starts.push_back(h.mi_cols);
        h.tile_cols = int(h.mi_col_starts.size()) - 1;
        h.tile_cols_log2 = tile_log2(1, h.tile_cols);
        int area = (sb_rows * sb_cols) >> (min_log2_tiles > 0 ? min_log2_tiles + 1 : 0);
        int max_th = std::max(area / widest, 1);
        start = 0;
        while (start < sb_rows) {
            h.mi_row_starts.push_back(start << sb_shift);
            int max_h = std::min(sb_rows - start, max_th);
            start += int(b.ns(max_h)) + 1;
        }
        h.mi_row_starts.push_back(h.mi_rows);
        h.tile_rows = int(h.mi_row_starts.size()) - 1;
        h.tile_rows_log2 = tile_log2(1, h.tile_rows);
    }
    if (h.tile_cols > 64 || h.tile_rows > 64)
        fail("AV1 tile info: more than 64 tile columns or rows");
    if (h.tile_cols_log2 > 0 || h.tile_rows_log2 > 0) {
        h.context_update_tile_id = b.f(h.tile_rows_log2 + h.tile_cols_log2);
        if (h.context_update_tile_id >= h.tile_cols * h.tile_rows)
            fail("AV1 tile info: context_update_tile_id past the last tile");
        h.tile_size_bytes = b.f(2) + 1;
    }
    // quantization params
    h.base_q_idx = b.f(8);
    h.dq_y_dc = read_delta_q(b);
    if (s.num_planes() > 1) {
        int diff_uv = s.separate_uv_delta_q ? b.f(1) : 0;
        h.dq_u_dc = read_delta_q(b); h.dq_u_ac = read_delta_q(b);
        if (diff_uv) { h.dq_v_dc = read_delta_q(b); h.dq_v_ac = read_delta_q(b); }
        else { h.dq_v_dc = h.dq_u_dc; h.dq_v_ac = h.dq_u_ac; }
    }
    h.using_qmatrix = b.f(1);
    if (h.using_qmatrix) {
        h.qm_y = b.f(4); h.qm_u = b.f(4);
        h.qm_v = s.separate_uv_delta_q ? b.f(4) : h.qm_u;
    }
    // segmentation params (primary_ref_frame is none)
    h.seg_enabled = b.f(1);
    if (h.seg_enabled) {
        for (int i = 0; i < 8; i++) {
            for (int j = 0; j < 8; j++) {
                int v = 0;
                h.feature_enabled[i][j] = b.f(1);
                if (h.feature_enabled[i][j]) {
                    int bits = seg_feature_bits[j], lim = seg_feature_max[j];
                    if (seg_feature_signed[j]) v = clip3(-lim, lim, b.su(1 + bits));
                    else v = clip3(0, lim, int(b.f(bits)));
                }
                h.feature_data[i][j] = v;
            }
        }
    }
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++)
            if (h.feature_enabled[i][j]) {
                h.last_active_seg_id = i;
                if (j >= SEG_LVL_REF_FRAME) h.seg_id_pre_skip = 1;
            }
    // delta q / lf
    if (h.base_q_idx > 0) h.delta_q_present = b.f(1);
    if (h.delta_q_present) h.delta_q_res = b.f(2);
    if (h.delta_q_present) {
        if (!h.allow_intrabc) h.delta_lf_present = b.f(1);
        if (h.delta_lf_present) { h.delta_lf_res = b.f(2); h.delta_lf_multi = b.f(1); }
    }
    h.coded_lossless = 1;
    for (int seg = 0; seg < 8; seg++) {
        int q = get_qindex(h, 1, seg, h.base_q_idx);
        h.lossless[seg] = q == 0 && h.dq_y_dc == 0 && h.dq_u_ac == 0 && h.dq_u_dc == 0 &&
                          h.dq_v_ac == 0 && h.dq_v_dc == 0;
        if (!h.lossless[seg]) h.coded_lossless = 0;
        bool flat = !h.using_qmatrix || h.lossless[seg];
        h.seg_qm_level[0][seg] = flat ? 15 : h.qm_y;
        h.seg_qm_level[1][seg] = flat ? 15 : h.qm_u;
        h.seg_qm_level[2][seg] = flat ? 15 : h.qm_v;
    }
    h.all_lossless = h.coded_lossless && h.width == h.upscaled_width;
    // loop filter params
    if (!(h.coded_lossless || h.allow_intrabc)) {
        h.lf_level[0] = b.f(6); h.lf_level[1] = b.f(6);
        if (s.num_planes() > 1 && (h.lf_level[0] || h.lf_level[1])) {
            h.lf_level[2] = b.f(6); h.lf_level[3] = b.f(6);
        }
        h.lf_sharpness = b.f(3);
        h.lf_delta_enabled = b.f(1);
        if (h.lf_delta_enabled) {
            if (b.f(1)) {
                for (int i = 0; i < 8; i++) if (b.f(1)) h.lf_ref_deltas[i] = b.su(7);
                for (int i = 0; i < 2; i++) if (b.f(1)) h.lf_mode_deltas[i] = b.su(7);
            }
        }
    }
    // cdef params
    if (!(h.coded_lossless || h.allow_intrabc || !s.enable_cdef)) {
        h.cdef_damping = b.f(2) + 3;
        h.cdef_bits = b.f(2);
        bool any = false;
        for (int i = 0; i < (1 << h.cdef_bits); i++) {
            h.cdef_y_pri[i] = b.f(4); h.cdef_y_sec[i] = b.f(2);
            if (h.cdef_y_sec[i] == 3) h.cdef_y_sec[i]++;
            if (s.num_planes() > 1) {
                h.cdef_uv_pri[i] = b.f(4); h.cdef_uv_sec[i] = b.f(2);
                if (h.cdef_uv_sec[i] == 3) h.cdef_uv_sec[i]++;
            }
            any = any || h.cdef_y_pri[i] || h.cdef_y_sec[i] || h.cdef_uv_pri[i] || h.cdef_uv_sec[i];
        }
        h.cdef_on = any;
    }
    // loop restoration params: lr_type remapped to NONE, SWITCHABLE, WIENER,
    // SGRPROJ
    if (!(h.all_lossless || h.allow_intrabc || !s.enable_restoration)) {
        static const int remap_lr_type[4] = {RESTORE_NONE, RESTORE_SWITCHABLE, RESTORE_WIENER,
                                             RESTORE_SGRPROJ};
        bool chroma = false;
        for (int i = 0; i < s.num_planes(); i++) {
            h.lr_type[i] = remap_lr_type[b.f(2)];
            if (h.lr_type[i] != RESTORE_NONE) { h.uses_lr = true; chroma = chroma || i > 0; }
        }
        if (h.uses_lr) {
            int shift = b.f(1);
            if (s.sb128) shift++;
            else if (shift) shift += b.f(1);
            h.lr_unit_size[0] = 256 >> (2 - shift);
            int uv_shift = (s.ss_x && s.ss_y && chroma) ? b.f(1) : 0;
            h.lr_unit_size[1] = h.lr_unit_size[2] = h.lr_unit_size[0] >> uv_shift;
        }
    }
    // tx mode
    if (h.coded_lossless) h.only_4x4 = 1;
    else h.tx_mode_select = b.f(1);
    // reference_select, skip_mode, warped motion: absent in an intra frame
    h.reduced_tx_set = b.f(1);
    // global motion params: absent in an intra frame
    if (s.film_grain_params_present && (h.show_frame || h.showable_frame))
        parse_film_grain(b, s, h.grain);
}

// ------------------------------------------------------ inverse transforms
inline int brev(int n, int x) {  // x's n low bits reversed
    int r = 0;
    for (int i = 0; i < n; i++, x >>= 1) r = (r << 1) | (x & 1);
    return r;
}
inline int cospi_at(int a) { return a == 64 ? 0 : av1t::cospi[a]; }
inline int cos128(int angle) {
    int a = angle & 255;
    if (a <= 64) return cospi_at(a);
    if (a <= 128) return -cospi_at(128 - a);
    if (a <= 192) return -cospi_at(a - 128);
    return cospi_at(256 - a);
}
inline int sin128(int angle) { return cos128(angle - 64); }

struct Tx1D {
    int32_t T[64];
    int lo, hi;  // the clamp of the Hadamard outputs
    void B(int a, int b, int angle, int flip) {
        int64_t x = int64_t(T[a]) * cos128(angle) - int64_t(T[b]) * sin128(angle);
        int64_t y = int64_t(T[a]) * sin128(angle) + int64_t(T[b]) * cos128(angle);
        T[a] = int32_t(round2l(x, 12));
        T[b] = int32_t(round2l(y, 12));
        if (flip) std::swap(T[a], T[b]);
    }
    void H(int a, int b, int f) {
        if (f) std::swap(a, b);
        int32_t x = T[a], y = T[b];
        T[a] = clip3(lo, hi, x + y);
        T[b] = clip3(lo, hi, x - y);
    }
    void dct(int n) {
        int n0 = 1 << n;
        int32_t c[64];
        memcpy(c, T, sizeof(int32_t) * n0);
        for (int i = 0; i < n0; i++) T[i] = c[brev(n, i)];
        if (n == 6) for (int i = 0; i < 16; i++) B(32 + i, 63 - i, 63 - 4 * brev(4, i), 0);
        if (n >= 5) for (int i = 0; i < 8; i++) B(16 + i, 31 - i, 6 + (brev(3, 7 - i) << 3), 0);
        if (n == 6) for (int i = 0; i < 16; i++) H(32 + i * 2, 33 + i * 2, i & 1);
        if (n >= 4) for (int i = 0; i < 4; i++) B(8 + i, 15 - i, 12 + (brev(2, 3 - i) << 4), 0);
        if (n >= 5) for (int i = 0; i < 8; i++) H(16 + 2 * i, 17 + 2 * i, i & 1);
        if (n == 6) for (int i = 0; i < 4; i++) for (int j = 0; j < 2; j++)
            B(62 - i * 4 - j, 33 + i * 4 + j, 60 - 16 * brev(2, i) + 64 * j, 1);
        if (n >= 3) for (int i = 0; i < 2; i++) B(4 + i, 7 - i, 56 - 32 * i, 0);
        if (n >= 4) for (int i = 0; i < 4; i++) H(8 + 2 * i, 9 + 2 * i, i & 1);
        if (n >= 5) for (int i = 0; i < 2; i++) for (int j = 0; j < 2; j++)
            B(30 - 4 * i - j, 17 + 4 * i + j, 24 + (j << 6) + ((1 - i) << 5), 1);
        if (n == 6) for (int i = 0; i < 8; i++) for (int j = 0; j < 2; j++)
            H(32 + i * 4 + j, 35 + i * 4 - j, i & 1);
        for (int i = 0; i < 2; i++) B(2 * i, 2 * i + 1, 32 + 16 * i, 1 - i);
        if (n >= 3) for (int i = 0; i < 2; i++) H(4 + 2 * i, 5 + 2 * i, i);
        if (n >= 4) for (int i = 0; i < 2; i++) B(14 - i, 9 + i, 48 + 64 * i, 1);
        if (n >= 5) for (int i = 0; i < 4; i++) for (int j = 0; j < 2; j++)
            H(16 + 4 * i + j, 19 + 4 * i - j, i & 1);
        if (n == 6) for (int i = 0; i < 2; i++) for (int j = 0; j < 4; j++)
            B(61 - i * 8 - j, 34 + i * 8 + j, 56 - i * 32 + (j >> 1) * 64, 1);
        for (int i = 0; i < 2; i++) H(i, 3 - i, 0);
        if (n >= 3) B(6, 5, 32, 1);
        if (n >= 4) for (int i = 0; i < 2; i++) for (int j = 0; j < 2; j++)
            H(8 + 4 * i + j, 11 + 4 * i - j, i);
        if (n >= 5) for (int i = 0; i < 4; i++) B(29 - i, 18 + i, 48 + (i >> 1) * 64, 1);
        if (n == 6) for (int i = 0; i < 4; i++) for (int j = 0; j < 4; j++)
            H(32 + 8 * i + j, 39 + 8 * i - j, i & 1);
        if (n >= 3) for (int i = 0; i < 4; i++) H(i, 7 - i, 0);
        if (n >= 4) for (int i = 0; i < 2; i++) B(13 - i, 10 + i, 32, 1);
        if (n >= 5) for (int i = 0; i < 2; i++) for (int j = 0; j < 4; j++)
            H(16 + i * 8 + j, 23 + i * 8 - j, i);
        if (n == 6) for (int i = 0; i < 8; i++) B(59 - i, 36 + i, i < 4 ? 48 : 112, 1);
        if (n >= 4) for (int i = 0; i < 8; i++) H(i, 15 - i, 0);
        if (n >= 5) for (int i = 0; i < 4; i++) B(27 - i, 20 + i, 32, 1);
        if (n == 6) for (int i = 0; i < 8; i++) { H(32 + i, 47 - i, 0); H(48 + i, 63 - i, 1); }
        if (n >= 5) for (int i = 0; i < 16; i++) H(i, 31 - i, 0);
        if (n == 6) for (int i = 0; i < 8; i++) B(55 - i, 40 + i, 32, 1);
        if (n == 6) for (int i = 0; i < 32; i++) H(i, 63 - i, 0);
    }
    void adst4() {
        const int64_t s1 = 1321, s2 = 2482, s3 = 3344, s4 = 3803;
        int64_t x0 = T[0], x1 = T[1], x2 = T[2], x3 = T[3];
        int64_t a0 = s1 * x0, a1 = s2 * x0, a2 = s3 * x1, a3 = s4 * x2, a4 = s1 * x2, a5 = s2 * x3,
                a6 = s4 * x3;
        int64_t a7 = x0 - x2;
        int64_t b7 = a7 + x3;
        a0 = a0 + a3;
        a1 = a1 - a4;
        a3 = a2;
        a2 = s3 * b7;
        a0 = a0 + a5;
        a1 = a1 - a6;
        int64_t y0 = a0 + a3, y1 = a1 + a3, y2 = a2, y3 = a0 + a1;
        y3 = y3 - a3;
        T[0] = int32_t(round2l(y0, 12)); T[1] = int32_t(round2l(y1, 12));
        T[2] = int32_t(round2l(y2, 12)); T[3] = int32_t(round2l(y3, 12));
    }
    void adst_in_perm(int n) {
        int n0 = 1 << n;
        int32_t c[16];
        memcpy(c, T, sizeof(int32_t) * n0);
        for (int i = 0; i < n0; i++) T[i] = c[(i & 1) ? i - 1 : n0 - i - 1];
    }
    void adst_out_perm(int n) {
        int n0 = 1 << n;
        int32_t c[16];
        memcpy(c, T, sizeof(int32_t) * n0);
        if (n == 3) {
            static const int idx[8] = {0, 4, 6, 2, 3, 7, 5, 1};
            for (int i = 0; i < 8; i++) T[i] = (i & 1) ? -c[idx[i]] : c[idx[i]];
        } else {
            static const int idx[16] = {0, 8, 12, 4, 6, 14, 10, 2, 3, 11, 15, 7, 5, 13, 9, 1};
            for (int i = 0; i < 16; i++) T[i] = (i & 1) ? -c[idx[i]] : c[idx[i]];
        }
    }
    void adst8() {
        adst_in_perm(3);
        for (int i = 0; i < 4; i++) B(2 * i, 2 * i + 1, 60 - 16 * i, 1);
        for (int i = 0; i < 4; i++) H(i, 4 + i, 0);
        for (int i = 0; i < 2; i++) B(4 + 3 * i, 5 + i, 48 - 32 * i, 1);
        for (int i = 0; i < 2; i++) for (int j = 0; j < 2; j++) H(4 * j + i, 2 + 4 * j + i, 0);
        for (int i = 0; i < 2; i++) B(2 + 4 * i, 3 + 4 * i, 32, 1);
        adst_out_perm(3);
    }
    void adst16() {
        adst_in_perm(4);
        for (int i = 0; i < 8; i++) B(2 * i, 2 * i + 1, 62 - 8 * i, 1);
        for (int i = 0; i < 8; i++) H(i, 8 + i, 0);
        for (int i = 0; i < 2; i++) {
            B(8 + 2 * i, 9 + 2 * i, 56 - 32 * i, 1);
            B(13 + 2 * i, 12 + 2 * i, 8 + 32 * i, 1);
        }
        for (int i = 0; i < 4; i++) for (int j = 0; j < 2; j++) H(8 * j + i, 4 + 8 * j + i, 0);
        for (int i = 0; i < 2; i++)
            for (int j = 0; j < 2; j++) B(4 + 8 * j + 3 * i, 5 + 8 * j + i, 48 - 32 * i, 1);
        for (int i = 0; i < 2; i++) for (int j = 0; j < 4; j++) H(4 * j + i, 2 + 4 * j + i, 0);
        for (int i = 0; i < 4; i++) B(2 + 4 * i, 3 + 4 * i, 32, 1);
        adst_out_perm(4);
    }
    void identity(int n) {
        int n0 = 1 << n;
        for (int i = 0; i < n0; i++) {
            if (n == 2) T[i] = int32_t(round2l(int64_t(T[i]) * 5793, 12));
            else if (n == 3) T[i] = T[i] * 2;
            else if (n == 4) T[i] = int32_t(round2l(int64_t(T[i]) * 11586, 12));
            else T[i] = T[i] * 4;
        }
    }
    void wht(int shift) {
        int32_t a = T[0] >> shift, c = T[1] >> shift, d = T[2] >> shift, b = T[3] >> shift;
        a += c; d -= b;
        int32_t e = (a - d) >> 1;
        b = e - b; c = e - c;
        a -= b; d += c;
        T[0] = a; T[1] = b; T[2] = c; T[3] = d;
    }
    // kind: 0 DCT, 1 ADST, 2 flipped ADST (the ADST here, flipped by the caller), 3 identity
    void run(int kind, int n) {
        if (kind == 0) dct(n);
        else if (kind == 3) identity(n);
        else if (n == 2) adst4();
        else if (n == 3) adst8();
        else adst16();
    }
};

const int transform_row_shift[TX_SIZES_ALL] = {0, 1, 2, 2, 2, 0, 0, 1, 1, 1,
                                               1, 1, 1, 1, 1, 2, 2, 2, 2};
// the row (horizontal) and column (vertical) 1-D kinds of each transform type
const int row_kind[16] = {0, 0, 1, 1, 0, 2, 2, 2, 1, 3, 3, 0, 3, 1, 3, 2};
const int col_kind[16] = {0, 1, 0, 1, 2, 0, 2, 1, 2, 3, 0, 3, 1, 3, 2, 3};

// dequant: row-major [min(h,32)][min(w,32)]; residual: [h][w]
void inverse_transform_2d(const int32_t* dequant, int tx, int type, bool lossless, int bd,
                          int32_t* residual) {
    int lw = txw_log2[tx], lh = txh_log2[tx];
    int w = 1 << lw, h = 1 << lh;
    int tw = std::min(32, w), th = std::min(32, h);
    int row_shift = lossless ? 0 : transform_row_shift[tx];
    int col_shift = lossless ? 0 : 4;
    int row_clamp = bd + 8, col_clamp = std::max(bd + 6, 16);
    Tx1D t;
    bool flip_lr = row_kind[type] == 2, flip_ud = col_kind[type] == 2;
    int col_lo = -(1 << (col_clamp - 1)), col_hi = (1 << (col_clamp - 1)) - 1;
    for (int i = 0; i < h; i++) {
        int32_t* out = residual + i * w;
        if (i >= th) { memset(out, 0, sizeof(int32_t) * w); continue; }
        for (int j = 0; j < w; j++) t.T[j] = j < tw ? dequant[i * tw + j] : 0;
        if (std::abs(lw - lh) == 1)
            for (int j = 0; j < w; j++) t.T[j] = int32_t(round2l(int64_t(t.T[j]) * 2896, 12));
        if (lossless) {
            t.wht(2);
        } else {
            int lo = -(1 << (bd + 7)), hi = (1 << (bd + 7)) - 1;
            for (int j = 0; j < w; j++) t.T[j] = clip3(lo, hi, t.T[j]);
            t.lo = -(1 << (row_clamp - 1)); t.hi = (1 << (row_clamp - 1)) - 1;
            t.run(row_kind[type], lw);
        }
        for (int j = 0; j < w; j++) {
            int v = round2(t.T[flip_lr ? w - 1 - j : j], row_shift);
            out[j] = lossless ? v : clip3(col_lo, col_hi, v);
        }
    }
    for (int j = 0; j < w; j++) {
        for (int i = 0; i < h; i++) t.T[i] = residual[i * w + j];
        if (lossless) t.wht(0);
        else { t.lo = col_lo; t.hi = col_hi; t.run(col_kind[type], lh); }
        for (int i = 0; i < h; i++)
            residual[i * w + j] = round2(t.T[flip_ud ? h - 1 - i : i], col_shift);
    }
}

// ------------------------------------------------------------ the decoder
const int palette_color_context[9] = {-1, -1, 0, -1, -1, 4, 3, 2, 1};
const int palette_hash_mult[3] = {1, 2, 2};
const int coeff_base_pos_ctx_offset[3] = {26, 31, 36};
const int sig_ref_diff_offset[3][5][2] = {
    {{0, 1}, {1, 0}, {1, 1}, {0, 2}, {2, 0}},
    {{0, 1}, {1, 0}, {0, 2}, {0, 3}, {0, 4}},
    {{0, 1}, {1, 0}, {2, 0}, {3, 0}, {4, 0}}};
const int mag_ref_offset[3][3][2] = {
    {{0, 1}, {1, 0}, {1, 1}}, {{0, 1}, {1, 0}, {0, 2}}, {{0, 1}, {1, 0}, {2, 0}}};
const int intra_edge_kernel[3][5] = {{0, 4, 8, 4, 0}, {0, 5, 6, 5, 0}, {2, 4, 4, 4, 2}};
const int filter_intra_mode_to_intra_dir[5] = {DC_PRED, V_PRED, H_PRED, D157_PRED, DC_PRED};
// quantizer matrix offsets of the adjusted transform sizes
int qm_offset(int tx) {
    static const int off[TX_SIZES_ALL] = {0, 16, 80, 336, 336, 1360, 1392, 1424, 1552, 1680, 2192,
                                          1680 + 0, 2192 + 0, 2704, 2768, 2832, 3088, 1680, 2192};
    // 32x64 -> 32x32, 64x32 -> 32x32, 16x64 -> 16x32, 64x16 -> 32x16
    if (tx == TX_32X64 || tx == TX_64X32) return 336;
    return off[tx];
}

// samples of every bit depth are held in 16 bits
struct Plane {
    std::vector<uint16_t> px;
    int stride = 0, w = 0, h = 0;  // allocated size
    uint16_t* row(int y) { return px.data() + size_t(y) * stride; }
    uint16_t& at(int x, int y) { return px[size_t(y) * stride + x]; }
    const uint16_t& at(int x, int y) const { return px[size_t(y) * stride + x]; }
};

struct Decoder {
    const SequenceHeader& s;
    const FrameHeader& h;
    Plane planes[3];
    int num_planes, ssx, ssy, bd;
    // per 4x4 luma position
    int mis, mirows_alloc, micols_alloc;
    std::vector<uint8_t> mi_size, y_mode, uv_mode, is_inter, skip_map,
        inter_tx_size, seg_ids, pal_size[2], decoded, tx_types;
    std::vector<uint16_t> pal_colors[2];
    std::vector<int8_t> delta_lfs;
    std::vector<int32_t> mvs;
    std::vector<uint8_t> lf_tx_size[3];
    std::vector<int8_t> cdef_idx;
    // tile state
    CdfContext cdf;
    SymbolDecoder sd;
    int mi_row_start = 0, mi_row_end = 0, mi_col_start = 0, mi_col_end = 0;
    std::vector<uint8_t> above_level[3], above_dc[3], left_level[3], left_dc[3];
    int current_q = 0, delta_lf[4] = {0};
    bool read_deltas = false;
    // BlockDecoded of the current superblock, offset by one
    uint8_t block_decoded[3][35][35];
    // block state
    int mi_row = 0, mi_col = 0, bsize = 0, has_chroma = 0;
    bool avail_u = false, avail_l = false, avail_u_chroma = false, avail_l_chroma = false;
    int segment_id = 0, skip = 0, lossless = 0, use_intrabc = 0, inter = 0;
    int ymode = 0, uvmode = 0, angle_delta_y = 0, angle_delta_uv = 0;
    int cfl_alpha_u = 0, cfl_alpha_v = 0, use_filter_intra = 0, filter_intra_mode = 0;
    int palette_size_y = 0, palette_size_uv = 0;
    uint16_t palette_colors[3][8];
    uint8_t color_map_y[64 * 64], color_map_uv[64 * 64];
    int color_order[8];
    int tx_size = 0;
    int mv[2] = {0, 0};
    int max_luma_w = 0, max_luma_h = 0;
    // loop restoration units (LrType, LrWiener, LrSgrSet, LrSgrXqd) of each
    // plane, and the references of the tile being read
    struct LrUnit {
        uint8_t type = RESTORE_NONE, sgr_set = 0;
        int8_t wiener[2][3] = {{0}};
        int16_t xqd[2] = {0, 0};
    };
    std::vector<LrUnit> lr_units[3];
    int lr_rows[3] = {0, 0, 0}, lr_cols[3] = {0, 0, 0};
    int ref_wiener[3][2][3], ref_sgr_xqd[3][2];
    // counts of the tools the frame used
    int n_intrabc = 0, n_palette = 0, n_filter_intra = 0, n_cfl = 0, n_cdef = 0, n_wiener = 0,
        n_sgrproj = 0;
    // coefficients
    int32_t quant[1024];
    int32_t dequant_buf[1024];
    int32_t resid[64 * 64];
    int fi_pred[64][64];     // filter intra's recursive prediction
    int cfl_buf[64 * 64];    // CfL's luma, 3 fractional bits
    int plane_tx_type = 0;

    Decoder(const SequenceHeader& seq, const FrameHeader& fh) : s(seq), h(fh) {
        num_planes = s.num_planes();
        ssx = s.ss_x; ssy = s.ss_y; bd = s.bit_depth;
        int aw = ((h.mi_cols * 4 + 127) & ~127) + 160, ah = ((h.mi_rows * 4 + 127) & ~127) + 160;
        for (int p = 0; p < num_planes; p++) {
            int sx = p ? ssx : 0, sy = p ? ssy : 0;
            planes[p].w = aw >> sx; planes[p].h = ah >> sy;
            planes[p].stride = planes[p].w;
            planes[p].px.assign(size_t(planes[p].w) * planes[p].h, 0);
        }
        micols_alloc = h.mi_cols + 40; mirows_alloc = h.mi_rows + 40;
        mis = micols_alloc;
        size_t n = size_t(mis) * mirows_alloc;
        mi_size.assign(n, 0); y_mode.assign(n, 0); uv_mode.assign(n, 0); is_inter.assign(n, 0);
        skip_map.assign(n, 0); inter_tx_size.assign(n, 0);
        seg_ids.assign(n, 0); decoded.assign(n, 0); tx_types.assign(n, 0);
        for (int i = 0; i < 2; i++) { pal_size[i].assign(n, 0); pal_colors[i].assign(n * 8, 0); }
        delta_lfs.assign(n * 4, 0);
        mvs.assign(n * 2, 0);
        for (int p = 0; p < 3; p++) lf_tx_size[p].assign(n, 0);
        cdef_idx.assign(n, -1);
        for (int p = 0; p < 3; p++) {
            above_level[p].assign(micols_alloc, 0); above_dc[p].assign(micols_alloc, 0);
            left_level[p].assign(mirows_alloc, 0); left_dc[p].assign(mirows_alloc, 0);
        }
        for (int p = 0; p < num_planes; p++) {
            if (h.lr_type[p] == RESTORE_NONE) continue;
            int sx = p ? ssx : 0, sy = p ? ssy : 0;
            lr_rows[p] = count_units(h.lr_unit_size[p], (h.height + sy) >> sy);
            lr_cols[p] = count_units(h.lr_unit_size[p], (h.upscaled_width + sx) >> sx);
            lr_units[p].assign(size_t(lr_rows[p]) * lr_cols[p], LrUnit());
        }
    }
    static int count_units(int unit_size, int frame_size) {
        return std::max((frame_size + (unit_size >> 1)) / unit_size, 1);
    }
    size_t mi(int r, int c) const { return size_t(r) * mis + c; }
    bool is_inside(int r, int c) const {
        return c >= mi_col_start && c < mi_col_end && r >= mi_row_start && r < mi_row_end;
    }
    int sym(uint16_t* cdf, int n) { return sd.symbol(cdf, n); }
    int lit(int n) { return sd.literal(n); }

    // ---- tile
    void decode_tile(const uint8_t* data, size_t size, int tile_row, int tile_col) {
        mi_row_start = h.mi_row_starts[tile_row]; mi_row_end = h.mi_row_starts[tile_row + 1];
        mi_col_start = h.mi_col_starts[tile_col]; mi_col_end = h.mi_col_starts[tile_col + 1];
        current_q = h.base_q_idx;
        cdf.init(h.base_q_idx);
        sd.init(data, size, h.disable_cdf_update);
        for (int p = 0; p < 3; p++) {
            for (int i = mi_col_start; i < std::min(mi_col_end + 32, micols_alloc); i++) {
                above_level[p][i] = 0; above_dc[p][i] = 0;
            }
        }
        for (int i = 0; i < 4; i++) delta_lf[i] = 0;
        static const int wiener_taps_mid[3] = {3, -7, 15}, sgrproj_xqd_mid[2] = {-32, 31};
        for (int p = 0; p < 3; p++)
            for (int pass = 0; pass < 2; pass++) {
                ref_sgr_xqd[p][pass] = sgrproj_xqd_mid[pass];
                for (int i = 0; i < 3; i++) ref_wiener[p][pass][i] = wiener_taps_mid[i];
            }
        int sb4 = s.sb128 ? 32 : 16;
        int sb_size = s.sb128 ? BLOCK_128X128 : BLOCK_64X64;
        for (int r = mi_row_start; r < mi_row_end; r += sb4) {
            for (int p = 0; p < 3; p++)
                for (int i = 0; i < mirows_alloc; i++) { left_level[p][i] = 0; left_dc[p][i] = 0; }
            for (int c = mi_col_start; c < mi_col_end; c += sb4) {
                read_deltas = h.delta_q_present;
                clear_cdef(r, c);
                clear_block_decoded_flags(r, c, sb4);
                read_lr(r, c, sb_size);
                decode_partition(r, c, sb_size);
            }
            // dav1d errors out on a symbol decoder that read 15 or more bits
            // past the end of the tile
            if (sd.max_bits < -14)
                fail("AV1 tile data ends before its last symbol (dav1d: overread)");
        }
    }
    void clear_cdef(int r, int c) {
        cdef_idx[mi(r, c)] = -1;
        if (s.sb128) {
            cdef_idx[mi(r, c + 16)] = -1; cdef_idx[mi(r + 16, c)] = -1;
            cdef_idx[mi(r + 16, c + 16)] = -1;
        }
    }
    void clear_block_decoded_flags(int r, int c, int sb4) {
        for (int p = 0; p < num_planes; p++) {
            int sx = p ? ssx : 0, sy = p ? ssy : 0;
            int sbw4 = (mi_col_end - c) >> sx, sbh4 = (mi_row_end - r) >> sy;
            for (int y = -1; y <= (sb4 >> sy); y++)
                for (int x = -1; x <= (sb4 >> sx); x++) {
                    uint8_t v;
                    if (y < 0 && x < sbw4) v = 1;
                    else if (x < 0 && y < sbh4) v = 1;
                    else v = 0;
                    block_decoded[p][y + 1][x + 1] = v;
                }
            block_decoded[p][(sb4 >> sy) + 1][0] = 0;
        }
    }

    // ---- loop restoration units (read before each superblock's partition)
    void read_lr(int r, int c, int b) {
        if (h.allow_intrabc) return;
        int w = bw4(b), hh = bh4(b);
        for (int p = 0; p < num_planes; p++) {
            if (h.lr_type[p] == RESTORE_NONE) continue;
            int sx = p ? ssx : 0, sy = p ? ssy : 0;
            int unit = h.lr_unit_size[p];
            int row_start = (r * (4 >> sy) + unit - 1) / unit;
            int row_end = std::min(lr_rows[p], ((r + hh) * (4 >> sy) + unit - 1) / unit);
            // under superres the units count columns of the upscaled frame
            int num = (4 >> sx) * h.superres_denom, den = unit * 8;
            int col_start = (c * num + den - 1) / den;
            int col_end = std::min(lr_cols[p], ((c + w) * num + den - 1) / den);
            for (int ur = row_start; ur < row_end; ur++)
                for (int uc = col_start; uc < col_end; uc++) read_lr_unit(p, ur, uc);
        }
    }
    int decode_subexp_bool(int num_syms, int k) {
        int i = 0, mk = 0;
        while (true) {
            int b2 = i ? k + i - 1 : k;
            int a = 1 << b2;
            if (num_syms <= mk + 3 * a) return sd.ns(num_syms - mk) + mk;
            if (!lit(1)) return lit(b2) + mk;
            i++;
            mk += a;
        }
    }
    static int inverse_recenter(int r, int v) {
        if (v > 2 * r) return v;
        if (v & 1) return r - ((v + 1) >> 1);
        return r + (v >> 1);
    }
    // decode_signed_subexp_with_ref_bool
    int subexp_with_ref(int low, int high, int k, int r) {
        int mx = high - low;
        r -= low;
        int v = decode_subexp_bool(mx, k);
        v = (r << 1) <= mx ? inverse_recenter(r, v) : mx - 1 - inverse_recenter(mx - 1 - r, v);
        return v + low;
    }
    void read_lr_unit(int p, int unit_row, int unit_col) {
        static const int wiener_min[3] = {-5, -23, -17}, wiener_max[3] = {10, 8, 46},
                         wiener_k[3] = {1, 2, 3};
        static const int xqd_min[2] = {-96, -32}, xqd_max[2] = {31, 95};
        LrUnit& u = lr_units[p][size_t(unit_row) * lr_cols[p] + unit_col];
        int type;
        if (h.lr_type[p] == RESTORE_WIENER)
            type = sym(cdf.use_wiener, 2) ? RESTORE_WIENER : RESTORE_NONE;
        else if (h.lr_type[p] == RESTORE_SGRPROJ)
            type = sym(cdf.use_sgrproj, 2) ? RESTORE_SGRPROJ : RESTORE_NONE;
        else
            type = sym(cdf.restoration_type, 3);
        u.type = uint8_t(type);
        if (type == RESTORE_WIENER) {
            n_wiener++;
            for (int pass = 0; pass < 2; pass++) {
                int first = p ? 1 : 0;
                u.wiener[pass][0] = 0;
                for (int j = first; j < 3; j++) {
                    int v = subexp_with_ref(wiener_min[j], wiener_max[j] + 1, wiener_k[j],
                                            ref_wiener[p][pass][j]);
                    u.wiener[pass][j] = int8_t(v);
                    ref_wiener[p][pass][j] = v;
                }
            }
        } else if (type == RESTORE_SGRPROJ) {
            n_sgrproj++;
            u.sgr_set = uint8_t(lit(4));
            for (int i = 0; i < 2; i++) {
                int v;
                if (av1t::sgr_params[u.sgr_set][i]) {
                    v = subexp_with_ref(xqd_min[i], xqd_max[i] + 1, 4, ref_sgr_xqd[p][i]);
                } else {
                    v = 0;
                    if (i == 1) v = clip3(xqd_min[1], xqd_max[1], 128 - ref_sgr_xqd[p][0]);
                }
                u.xqd[i] = int16_t(v);
                ref_sgr_xqd[p][i] = v;
            }
        }
    }

    // ---- partition
    void decode_partition(int r, int c, int b) {
        if (r >= h.mi_rows || c >= h.mi_cols) return;
        bool au = is_inside(r - 1, c), al = is_inside(r, c - 1);
        int n4 = bw4(b), half = n4 >> 1, quarter = half >> 1;
        bool has_rows = (r + half) < h.mi_rows, has_cols = (c + half) < h.mi_cols;
        int partition;
        if (b < BLOCK_8X8) {
            partition = 0;
        } else {
            int bsl = bw_log2[b];
            int above = au && bw_log2[mi_size[mi(r - 1, c)]] < bsl;
            int left = al && bh_log2[mi_size[mi(r, c - 1)]] < bsl;
            int ctx = left * 2 + above;
            uint16_t* pc = cdf.partition[(bsl - 1) * 4 + ctx];
            int nsym = bsl == 1 ? 4 : (bsl == 5 ? 8 : 10);
            auto p = [&](int k) -> int {  // probability of symbol k in 1/32768
                int hi = k == 0 ? 32768 : pc[k - 1];
                int lo = k == nsym - 1 ? 0 : pc[k];
                return hi - lo;
            };
            if (has_rows && has_cols) {
                partition = sym(pc, nsym);
            } else if (has_cols) {
                // split_or_horz: the partitions that divide the top half
                int psum = p(2) + p(3) + p(4) + p(6) + p(7) + (b != BLOCK_128X128 ? p(9) : 0);
                if (nsym == 4) psum = p(2) + p(3);
                partition = sd.boolean(uint32_t(psum)) ? 3 : 1;
            } else if (has_rows) {
                // split_or_vert: the partitions that divide the left half
                int psum = p(1) + p(3) + p(4) + p(5) + p(6) + (b != BLOCK_128X128 ? p(8) : 0);
                if (nsym == 4) psum = p(1) + p(3);
                partition = sd.boolean(uint32_t(psum)) ? 3 : 2;
            } else {
                partition = 3;
            }
        }
        int wl = bw_log2[b], hl = bh_log2[b];
        int sub;
        switch (partition) {
            case 0: sub = b; break;
            case 1: case 4: case 5: sub = block_of(wl, hl - 1); break;
            case 2: case 6: case 7: sub = block_of(wl - 1, hl); break;
            case 3: sub = block_of(wl - 1, hl - 1); break;
            case 8: sub = block_of(wl, hl - 2); break;
            default: sub = block_of(wl - 2, hl); break;
        }
        int split = block_of(wl - 1, hl - 1);
        switch (partition) {
            case 0: decode_block(r, c, sub); break;
            case 1: decode_block(r, c, sub); if (has_rows) decode_block(r + half, c, sub); break;
            case 2: decode_block(r, c, sub); if (has_cols) decode_block(r, c + half, sub); break;
            case 3:
                decode_partition(r, c, sub); decode_partition(r, c + half, sub);
                decode_partition(r + half, c, sub); decode_partition(r + half, c + half, sub);
                break;
            case 4:
                decode_block(r, c, split); decode_block(r, c + half, split);
                decode_block(r + half, c, sub); break;
            case 5:
                decode_block(r, c, sub); decode_block(r + half, c, split);
                decode_block(r + half, c + half, split); break;
            case 6:
                decode_block(r, c, split); decode_block(r + half, c, split);
                decode_block(r, c + half, sub); break;
            case 7:
                decode_block(r, c, sub); decode_block(r, c + half, split);
                decode_block(r + half, c + half, split); break;
            case 8:
                for (int i = 0; i < 4; i++)
                    if (i < 3 || r + quarter * 3 < h.mi_rows) decode_block(r + quarter * i, c, sub);
                break;
            default:
                for (int i = 0; i < 4; i++)
                    if (i < 3 || c + quarter * 3 < h.mi_cols) decode_block(r, c + quarter * i, sub);
                break;
        }
    }

    // ---- block
    void decode_block(int r, int c, int b) {
        mi_row = r; mi_col = c; bsize = b;
        int w4 = bw4(b), h4 = bh4(b);
        if (b == BLOCK_INVALID) fail("AV1 partition: invalid block size");
        if (num_planes > 1) {
            int pb = plane_residual_size(b, 1);
            if (pb == BLOCK_INVALID) fail("AV1 block size invalid for the chroma subsampling");
        }
        if (h4 == 1 && ssy && (mi_row & 1) == 0) has_chroma = 0;
        else if (w4 == 1 && ssx && (mi_col & 1) == 0) has_chroma = 0;
        else has_chroma = num_planes > 1;
        avail_u = is_inside(r - 1, c);
        avail_l = is_inside(r, c - 1);
        avail_u_chroma = avail_u; avail_l_chroma = avail_l;
        if (has_chroma) {
            if (ssy && h4 == 1) avail_u_chroma = is_inside(r - 2, c);
            if (ssx && w4 == 1) avail_l_chroma = is_inside(r, c - 2);
        } else {
            avail_u_chroma = avail_l_chroma = false;
        }
        intra_frame_mode_info();
        palette_tokens();
        read_block_tx_size();
        if (skip) reset_block_context(w4, h4);
        for (int y = 0; y < h4; y++) {
            if (r + y >= mirows_alloc) break;
            for (int x = 0; x < w4; x++) {
                if (c + x >= micols_alloc) break;
                size_t k = mi(r + y, c + x);
                y_mode[k] = uint8_t(ymode); uv_mode[k] = uint8_t(uvmode);
                is_inter[k] = uint8_t(inter); skip_map[k] = uint8_t(skip);
                mi_size[k] = uint8_t(b);
                seg_ids[k] = uint8_t(segment_id);
                pal_size[0][k] = uint8_t(palette_size_y); pal_size[1][k] = uint8_t(palette_size_uv);
                for (int i = 0; i < 8; i++) {
                    pal_colors[0][k * 8 + i] = palette_colors[0][i];
                    pal_colors[1][k * 8 + i] = palette_colors[1][i];
                }
                for (int i = 0; i < 4; i++) delta_lfs[k * 4 + i] = int8_t(delta_lf[i]);
                mvs[k * 2] = mv[0]; mvs[k * 2 + 1] = mv[1];
            }
        }
        n_intrabc += use_intrabc;
        n_palette += palette_size_y > 0 || palette_size_uv > 0;
        n_filter_intra += use_filter_intra;
        n_cfl += !inter && has_chroma && uvmode == UV_CFL_PRED;
        compute_prediction();
        residual();
        for (int y = 0; y < h4; y++) {
            if (r + y >= mirows_alloc) break;
            for (int x = 0; x < w4; x++) {
                if (c + x >= micols_alloc) break;
                decoded[mi(r + y, c + x)] = 1;
            }
        }
    }
    int plane_residual_size(int b, int p) const {
        // libaom's ss_size_lookup: [block][ss_x][ss_y]
        static const int8_t ss[BLOCK_SIZES][2][2] = {
            {{BLOCK_4X4, BLOCK_4X4}, {BLOCK_4X4, BLOCK_4X4}},
            {{BLOCK_4X8, BLOCK_4X4}, {BLOCK_INVALID, BLOCK_4X4}},
            {{BLOCK_8X4, BLOCK_INVALID}, {BLOCK_4X4, BLOCK_4X4}},
            {{BLOCK_8X8, BLOCK_8X4}, {BLOCK_4X8, BLOCK_4X4}},
            {{BLOCK_8X16, BLOCK_8X8}, {BLOCK_INVALID, BLOCK_4X8}},
            {{BLOCK_16X8, BLOCK_INVALID}, {BLOCK_8X8, BLOCK_8X4}},
            {{BLOCK_16X16, BLOCK_16X8}, {BLOCK_8X16, BLOCK_8X8}},
            {{BLOCK_16X32, BLOCK_16X16}, {BLOCK_INVALID, BLOCK_8X16}},
            {{BLOCK_32X16, BLOCK_INVALID}, {BLOCK_16X16, BLOCK_16X8}},
            {{BLOCK_32X32, BLOCK_32X16}, {BLOCK_16X32, BLOCK_16X16}},
            {{BLOCK_32X64, BLOCK_32X32}, {BLOCK_INVALID, BLOCK_16X32}},
            {{BLOCK_64X32, BLOCK_INVALID}, {BLOCK_32X32, BLOCK_32X16}},
            {{BLOCK_64X64, BLOCK_64X32}, {BLOCK_32X64, BLOCK_32X32}},
            {{BLOCK_64X128, BLOCK_64X64}, {BLOCK_INVALID, BLOCK_32X64}},
            {{BLOCK_128X64, BLOCK_INVALID}, {BLOCK_64X64, BLOCK_64X32}},
            {{BLOCK_128X128, BLOCK_128X64}, {BLOCK_64X128, BLOCK_64X64}},
            {{BLOCK_4X16, BLOCK_4X8}, {BLOCK_INVALID, BLOCK_4X8}},
            {{BLOCK_16X4, BLOCK_INVALID}, {BLOCK_8X4, BLOCK_8X4}},
            {{BLOCK_8X32, BLOCK_8X16}, {BLOCK_INVALID, BLOCK_4X16}},
            {{BLOCK_32X8, BLOCK_INVALID}, {BLOCK_16X8, BLOCK_16X4}},
            {{BLOCK_16X64, BLOCK_16X32}, {BLOCK_INVALID, BLOCK_8X32}},
            {{BLOCK_64X16, BLOCK_INVALID}, {BLOCK_32X16, BLOCK_32X8}}};
        return p ? ss[b][ssx][ssy] : b;
    }
    void reset_block_context(int w4, int h4) {
        for (int p = 0; p < 1 + 2 * has_chroma; p++) {
            int sx = p ? ssx : 0, sy = p ? ssy : 0;
            for (int i = mi_col >> sx; i < ((mi_col + w4 - 1) >> sx) + 1; i++)
                if (i < micols_alloc) { above_level[p][i] = 0; above_dc[p][i] = 0; }
            for (int i = mi_row >> sy; i < ((mi_row + h4 - 1) >> sy) + 1; i++)
                if (i < mirows_alloc) { left_level[p][i] = 0; left_dc[p][i] = 0; }
        }
    }

    // ---- mode info
    void intra_frame_mode_info() {
        skip = 0;
        if (h.seg_id_pre_skip) intra_segment_id();
        read_skip();
        if (!h.seg_id_pre_skip) intra_segment_id();
        read_cdef();
        read_delta_qindex();
        read_delta_lf();
        read_deltas = false;
        use_intrabc = h.allow_intrabc ? sym(cdf.intrabc, 2) : 0;
        palette_size_y = palette_size_uv = 0;
        use_filter_intra = 0;
        angle_delta_y = angle_delta_uv = 0;
        cfl_alpha_u = cfl_alpha_v = 0;
        mv[0] = mv[1] = 0;
        if (use_intrabc) {
            inter = 1;
            ymode = DC_PRED; uvmode = DC_PRED;
            read_intrabc_mv();
        } else {
            inter = 0;
            int above = intra_mode_context[avail_u ? y_mode[mi(mi_row - 1, mi_col)] : DC_PRED];
            int left = intra_mode_context[avail_l ? y_mode[mi(mi_row, mi_col - 1)] : DC_PRED];
            ymode = sym(cdf.kf_y_mode[above][left], 13);
            if (bsize >= BLOCK_8X8 && is_directional(ymode))
                angle_delta_y = sym(cdf.angle_delta[ymode - V_PRED], 7) - 3;
            uvmode = DC_PRED;
            if (has_chroma) {
                bool cfl_allowed;
                if (lossless && plane_residual_size(bsize, 1) == BLOCK_4X4) cfl_allowed = true;
                else if (!lossless && std::max(bw4(bsize), bh4(bsize)) <= 8) cfl_allowed = true;
                else cfl_allowed = false;
                uvmode = sym(cdf.uv_mode[cfl_allowed][ymode], cfl_allowed ? 14 : 13);
                if (uvmode == UV_CFL_PRED) read_cfl_alphas();
                if (bsize >= BLOCK_8X8 && is_directional(uvmode))
                    angle_delta_uv = sym(cdf.angle_delta[uvmode - V_PRED], 7) - 3;
            }
            if (bsize >= BLOCK_8X8 && bw4(bsize) <= 16 && bh4(bsize) <= 16 &&
                h.allow_screen_content_tools)
                palette_mode_info();
            filter_intra_mode_info();
        }
    }
    void intra_segment_id() {
        if (h.seg_enabled) read_segment_id();
        else segment_id = 0;
        lossless = h.lossless[segment_id];
    }
    void read_segment_id() {
        int prev_ul = -1, prev_u = -1, prev_l = -1;
        if (avail_u && avail_l) prev_ul = seg_ids[mi(mi_row - 1, mi_col - 1)];
        if (avail_u) prev_u = seg_ids[mi(mi_row - 1, mi_col)];
        if (avail_l) prev_l = seg_ids[mi(mi_row, mi_col - 1)];
        int pred;
        if (prev_u == -1) pred = prev_l == -1 ? 0 : prev_l;
        else if (prev_l == -1) pred = prev_u;
        else pred = prev_ul == prev_u ? prev_u : prev_l;
        if (skip) { segment_id = pred; return; }
        int ctx;
        if (prev_ul < 0) ctx = 0;
        else if (prev_ul == prev_u && prev_ul == prev_l) ctx = 2;
        else if (prev_ul == prev_u || prev_ul == prev_l || prev_u == prev_l) ctx = 1;
        else ctx = 0;
        int v = sym(cdf.segment_id[ctx], 8);
        int max = h.last_active_seg_id + 1;
        segment_id = clip3(0, h.last_active_seg_id, neg_deinterleave(v, pred, max));
    }
    static int neg_deinterleave(int diff, int ref, int max) {
        if (!ref) return diff;
        if (ref >= max - 1) return max - diff - 1;
        if (2 * ref < max) {
            if (diff <= 2 * ref) return (diff & 1) ? ref + ((diff + 1) >> 1) : ref - (diff >> 1);
            return diff;
        }
        if (diff <= 2 * (max - ref - 1))
            return (diff & 1) ? ref + ((diff + 1) >> 1) : ref - (diff >> 1);
        return max - (diff + 1);
    }
    void read_skip() {
        if (h.seg_id_pre_skip && h.seg_enabled && h.feature_enabled[segment_id][SEG_LVL_SKIP]) {
            skip = 1;
            return;
        }
        int ctx = 0;
        if (avail_u) ctx += skip_map[mi(mi_row - 1, mi_col)];
        if (avail_l) ctx += skip_map[mi(mi_row, mi_col - 1)];
        skip = sym(cdf.skip[ctx], 2);
    }
    void read_cdef() {
        if (skip || h.coded_lossless || !s.enable_cdef || h.allow_intrabc) return;
        int r = mi_row & ~15, c = mi_col & ~15;
        if (cdef_idx[mi(r, c)] == -1) {
            int v = lit(h.cdef_bits);
            int w4 = bw4(bsize), h4 = bh4(bsize);
            for (int y = r; y < r + h4; y += 16)
                for (int x = c; x < c + w4; x += 16)
                    if (y < mirows_alloc && x < micols_alloc) cdef_idx[mi(y, x)] = int8_t(v);
        }
    }
    void read_delta_qindex() {
        int sb = s.sb128 ? BLOCK_128X128 : BLOCK_64X64;
        if (bsize == sb && skip) return;
        if (read_deltas) {
            int abs = sym(cdf.delta_q, 4);
            if (abs == 3) {
                int rem = lit(3) + 1;
                abs = lit(rem) + (1 << rem) + 1;
            }
            if (abs) {
                int sign = lit(1);
                int reduced = sign ? -abs : abs;
                current_q = clip3(1, 255, current_q + reduced * (1 << h.delta_q_res));
            }
        }
    }
    void read_delta_lf() {
        int sb = s.sb128 ? BLOCK_128X128 : BLOCK_64X64;
        if (bsize == sb && skip) return;
        if (read_deltas && h.delta_lf_present) {
            int count = 1;
            if (h.delta_lf_multi) count = num_planes > 1 ? 4 : 2;
            for (int i = 0; i < count; i++) {
                uint16_t* c = cdf.delta_lf[h.delta_lf_multi ? i + 1 : 0];
                int abs = sym(c, 4);
                if (abs == 3) {
                    int n = lit(3) + 1;
                    abs = lit(n) + (1 << n) + 1;
                }
                if (abs) {
                    int sign = lit(1);
                    int reduced = sign ? -abs : abs;
                    delta_lf[i] = clip3(-63, 63, delta_lf[i] + reduced * (1 << h.delta_lf_res));
                }
            }
        }
    }
    void read_cfl_alphas() {
        int signs = sym(cdf.cfl_sign, 8);
        int sign_u = (signs + 1) / 3, sign_v = (signs + 1) % 3;
        if (sign_u) {
            int ctx = (sign_u - 1) * 3 + sign_v;
            cfl_alpha_u = 1 + sym(cdf.cfl_alpha[ctx], 16);
            if (sign_u == 1) cfl_alpha_u = -cfl_alpha_u;
        }
        if (sign_v) {
            int ctx = (sign_v - 1) * 3 + sign_u;
            cfl_alpha_v = 1 + sym(cdf.cfl_alpha[ctx], 16);
            if (sign_v == 1) cfl_alpha_v = -cfl_alpha_v;
        }
    }
    void filter_intra_mode_info() {
        use_filter_intra = 0;
        if (s.enable_filter_intra && ymode == DC_PRED && palette_size_y == 0 &&
            std::max(bw4(bsize), bh4(bsize)) <= 8) {
            use_filter_intra = sym(cdf.use_filter_intra[bsize], 2);
            if (use_filter_intra) filter_intra_mode = sym(cdf.filter_intra_mode, 5);
        }
    }

    // ---- palette
    int get_palette_cache(int p, uint16_t* cache) {
        int above_n = 0, left_n = 0;
        if ((mi_row * 4) % 64 && avail_u) above_n = pal_size[p][mi(mi_row - 1, mi_col)];
        if (avail_l) left_n = pal_size[p][mi(mi_row, mi_col - 1)];
        const uint16_t* ac = &pal_colors[p][mi(mi_row - 1 < 0 ? 0 : mi_row - 1, mi_col) * 8];
        const uint16_t* lc = &pal_colors[p][mi(mi_row, mi_col - 1 < 0 ? 0 : mi_col - 1) * 8];
        int ai = 0, li = 0, n = 0;
        while (ai < above_n && li < left_n) {
            int a = ac[ai], l = lc[li];
            if (l < a) {
                if (n == 0 || l != cache[n - 1]) cache[n++] = uint16_t(l);
                li++;
            } else {
                if (n == 0 || a != cache[n - 1]) cache[n++] = uint16_t(a);
                ai++;
                if (l == a) li++;
            }
        }
        for (; ai < above_n; ai++)
            if (n == 0 || ac[ai] != cache[n - 1]) cache[n++] = ac[ai];
        for (; li < left_n; li++)
            if (n == 0 || lc[li] != cache[n - 1]) cache[n++] = lc[li];
        return n;
    }
    void palette_mode_info() {
        int bsize_ctx = bw_log2[bsize] + bh_log2[bsize] - 2;
        int maxv = (1 << bd) - 1;
        uint16_t cache[16];
        if (ymode == DC_PRED) {
            int ctx = 0;
            if (avail_u && pal_size[0][mi(mi_row - 1, mi_col)] > 0) ctx++;
            if (avail_l && pal_size[0][mi(mi_row, mi_col - 1)] > 0) ctx++;
            if (sym(cdf.palette_y_mode[bsize_ctx][ctx], 2)) {
                palette_size_y = sym(cdf.palette_size[0][bsize_ctx], 7) + 2;
                int cn = get_palette_cache(0, cache);
                int idx = 0;
                uint16_t* pc = palette_colors[0];
                for (int i = 0; i < cn && idx < palette_size_y; i++)
                    if (lit(1)) pc[idx++] = cache[i];
                if (idx < palette_size_y) { pc[idx++] = uint16_t(lit(bd)); }
                int bits = 0;
                if (idx < palette_size_y) bits = bd - 3 + lit(2);
                while (idx < palette_size_y) {
                    int delta = lit(bits) + 1;
                    pc[idx] = uint16_t(clip3(0, maxv, pc[idx - 1] + delta));
                    int range = (1 << bd) - pc[idx] - 1;
                    bits = std::min(bits, ceil_log2(range));
                    idx++;
                }
                std::sort(pc, pc + palette_size_y);
            }
        }
        if (has_chroma && uvmode == DC_PRED) {
            int ctx = palette_size_y > 0 ? 1 : 0;
            if (sym(cdf.palette_uv_mode[ctx], 2)) {
                palette_size_uv = sym(cdf.palette_size[1][bsize_ctx], 7) + 2;
                int cn = get_palette_cache(1, cache);
                int idx = 0;
                uint16_t* pu = palette_colors[1];
                for (int i = 0; i < cn && idx < palette_size_uv; i++)
                    if (lit(1)) pu[idx++] = cache[i];
                if (idx < palette_size_uv) { pu[idx++] = uint16_t(lit(bd)); }
                int bits = 0;
                if (idx < palette_size_uv) bits = bd - 3 + lit(2);
                while (idx < palette_size_uv) {
                    int delta = lit(bits);
                    pu[idx] = uint16_t(clip3(0, maxv, pu[idx - 1] + delta));
                    int range = (1 << bd) - pu[idx];
                    idx++;
                    bits = std::min(bits, ceil_log2(range));
                }
                std::sort(pu, pu + palette_size_uv);
                uint16_t* pv = palette_colors[2];
                if (lit(1)) {
                    int min_bits = bd - 4;
                    int max_val = 1 << bd;
                    int vbits = min_bits + lit(2);
                    pv[0] = uint16_t(lit(bd));
                    for (int i = 1; i < palette_size_uv; i++) {
                        int delta = lit(vbits);
                        if (delta && lit(1)) delta = -delta;
                        int val = pv[i - 1] + delta;
                        if (val < 0) val += max_val;
                        if (val >= max_val) val -= max_val;
                        pv[i] = uint16_t(clip3(0, maxv, val));
                    }
                } else {
                    for (int i = 0; i < palette_size_uv; i++) pv[i] = uint16_t(lit(bd));
                }
            }
        }
    }
    int palette_color_context_of(const uint8_t* map, int stride, int r, int c, int n) {
        int scores[8] = {0};
        for (int i = 0; i < 8; i++) color_order[i] = i;
        if (c > 0) scores[map[r * stride + c - 1]] += 2;
        if (r > 0 && c > 0) scores[map[(r - 1) * stride + c - 1]] += 1;
        if (r > 0) scores[map[(r - 1) * stride + c]] += 2;
        for (int i = 0; i < 3; i++) {
            int max_score = scores[i], max_idx = i;
            for (int j = i + 1; j < n; j++)
                if (scores[j] > max_score) { max_score = scores[j]; max_idx = j; }
            if (max_idx != i) {
                max_score = scores[max_idx];
                int max_order = color_order[max_idx];
                for (int k = max_idx; k > i; k--) {
                    scores[k] = scores[k - 1];
                    color_order[k] = color_order[k - 1];
                }
                scores[i] = max_score; color_order[i] = max_order;
            }
        }
        int hash = 0;
        for (int i = 0; i < 3; i++) hash += scores[i] * palette_hash_mult[i];
        return palette_color_context[hash];
    }
    void read_color_map(uint8_t* map, int n, int bw, int bh, int onw, int onh, int plane_type) {
        // the map's stride is bw
        map[0] = uint8_t(sd.ns(n));
        for (int i = 1; i < onh + onw - 1; i++) {
            for (int j = std::min(i, onw - 1); j >= std::max(0, i - onh + 1); j--) {
                int ctx = palette_color_context_of(map, bw, i - j, j, n);
                int v = sym(cdf.palette_color[plane_type][n - 2][ctx], n);
                map[(i - j) * bw + j] = uint8_t(color_order[v]);
            }
        }
        for (int i = 0; i < onh; i++)
            for (int j = onw; j < bw; j++) map[i * bw + j] = map[i * bw + onw - 1];
        for (int i = onh; i < bh; i++)
            for (int j = 0; j < bw; j++) map[i * bw + j] = map[(onh - 1) * bw + j];
    }
    void palette_tokens() {
        int bw = bw4(bsize) * 4, bh = bh4(bsize) * 4;
        int onh = std::min(bh, (h.mi_rows - mi_row) * 4);
        int onw = std::min(bw, (h.mi_cols - mi_col) * 4);
        if (palette_size_y) read_color_map(color_map_y, palette_size_y, bw, bh, onw, onh, 0);
        if (palette_size_uv) {
            bw >>= ssx; bh >>= ssy; onw >>= ssx; onh >>= ssy;
            if (bw < 4) { bw += 2; onw += 2; }
            if (bh < 4) { bh += 2; onh += 2; }
            read_color_map(color_map_uv, palette_size_uv, bw, bh, onw, onh, 1);
        }
    }

    // ---- transform size
    int above_tx_width(int row, int col) {
        if (row == mi_row) {
            if (!avail_u) return 64;
            size_t k = mi(row - 1, col);
            if (skip_map[k] && is_inter[k]) return bw4(mi_size[k]) * 4;
        }
        return txw(inter_tx_size[mi(row - 1, col)]);
    }
    int left_tx_height(int row, int col) {
        if (col == mi_col) {
            if (!avail_l) return 64;
            size_t k = mi(row, col - 1);
            if (skip_map[k] && is_inter[k]) return bh4(mi_size[k]) * 4;
        }
        return txh(inter_tx_size[mi(row, col - 1)]);
    }
    void read_block_tx_size() {
        int w4 = bw4(bsize), h4 = bh4(bsize);
        if (h.tx_mode_select && bsize > BLOCK_4X4 && inter && !skip && !lossless) {
            int maxtx = max_tx_rect(bsize);
            int tw4 = txw(maxtx) / 4, th4 = txh(maxtx) / 4;
            for (int row = mi_row; row < mi_row + h4; row += th4)
                for (int col = mi_col; col < mi_col + w4; col += tw4)
                    read_var_tx_size(row, col, maxtx, 0);
        } else {
            read_tx_size(!skip || !inter);
            for (int row = mi_row; row < std::min(mi_row + h4, mirows_alloc); row++)
                for (int col = mi_col; col < std::min(mi_col + w4, micols_alloc); col++)
                    inter_tx_size[mi(row, col)] = uint8_t(tx_size);
        }
    }
    void read_var_tx_size(int row, int col, int tx, int depth) {
        if (row >= h.mi_rows || col >= h.mi_cols) return;
        int split = 0;
        if (!(tx == TX_4X4 || depth == 2)) {
            int above = above_tx_width(row, col) < txw(tx);
            int left = left_tx_height(row, col) < txh(tx);
            int size = std::min(64, std::max(bw4(bsize), bh4(bsize)) * 4);
            int maxsz = tx_of(floor_log2(size), floor_log2(size));
            int ctx = (tx_sqr_up(tx) != maxsz) * 3 + (4 - maxsz) * 6 + above + left;
            split = sym(cdf.txfm_split[ctx], 2);
        }
        int w4 = txw(tx) / 4, h4 = txh(tx) / 4;
        if (split) {
            int sub = split_tx[tx];
            int sw = txw(sub) / 4, sh = txh(sub) / 4;
            for (int i = 0; i < h4; i += sh)
                for (int j = 0; j < w4; j += sw) read_var_tx_size(row + i, col + j, sub, depth + 1);
        } else {
            for (int i = 0; i < h4; i++)
                for (int j = 0; j < w4; j++)
                    if (row + i < mirows_alloc && col + j < micols_alloc)
                        inter_tx_size[mi(row + i, col + j)] = uint8_t(tx);
            tx_size = tx;
        }
    }
    void read_tx_size(bool allow_select) {
        if (lossless) { tx_size = TX_4X4; return; }
        int maxrect = max_tx_rect(bsize);
        tx_size = maxrect;
        if (bsize > BLOCK_4X4 && allow_select && h.tx_mode_select) {
            int cat = std::max(txw_log2[maxrect], txh_log2[maxrect]) - 2;  // 1..4
            int aw, lh;
            if (avail_u && is_inter[mi(mi_row - 1, mi_col)])
                aw = bw4(mi_size[mi(mi_row - 1, mi_col)]) * 4;
            else if (avail_u) aw = above_tx_width(mi_row, mi_col);
            else aw = 0;
            if (avail_l && is_inter[mi(mi_row, mi_col - 1)])
                lh = bh4(mi_size[mi(mi_row, mi_col - 1)]) * 4;
            else if (avail_l) lh = left_tx_height(mi_row, mi_col);
            else lh = 0;
            int ctx = (aw >= txw(maxrect)) + (lh >= txh(maxrect));
            int depth = sym(cdf.tx_depth[cat - 1][ctx], cat == 1 ? 2 : 3);
            for (int i = 0; i < depth; i++) tx_size = split_tx[tx_size];
        }
    }

    // ---- IntraBC
    int stack_mv[8][2], stack_weight[8], num_mv = 0;
    void add_candidate(int r, int c, int weight) {
        size_t k = mi(r, c);
        if (!is_inter[k]) return;
        int cand[2] = {mvs[k * 2], mvs[k * 2 + 1]};
        for (int i = 0; i < 2; i++) {
            int a = std::abs(cand[i]), ai = (a + 3) >> 3;
            cand[i] = cand[i] > 0 ? ai << 3 : -(ai << 3);
        }
        int idx;
        for (idx = 0; idx < num_mv; idx++)
            if (stack_mv[idx][0] == cand[0] && stack_mv[idx][1] == cand[1]) break;
        if (idx < num_mv) stack_weight[idx] += weight;
        else if (num_mv < 8) {
            stack_mv[num_mv][0] = cand[0]; stack_mv[num_mv][1] = cand[1];
            stack_weight[num_mv] = weight; num_mv++;
        }
    }
    void scan_row(int delta_row) {
        int w4 = bw4(bsize);
        int end4 = std::min(std::min(w4, h.mi_cols - mi_col), 16);
        int delta_col = 0;
        bool step16 = w4 >= 16;
        if (std::abs(delta_row) > 1) { delta_row += mi_row & 1; delta_col = 1 - (mi_col & 1); }
        for (int i = 0; i < end4;) {
            int r = mi_row + delta_row, c = mi_col + delta_col + i;
            if (!is_inside(r, c)) break;
            int len = std::min(w4, bw4(mi_size[mi(r, c)]));
            if (std::abs(delta_row) > 1) len = std::max(2, len);
            if (step16) len = std::max(4, len);
            add_candidate(r, c, len * 2);
            i += len;
        }
    }
    void scan_col(int delta_col) {
        int h4 = bh4(bsize);
        int end4 = std::min(std::min(h4, h.mi_rows - mi_row), 16);
        int delta_row = 0;
        bool step16 = h4 >= 16;
        if (std::abs(delta_col) > 1) { delta_row = 1 - (mi_row & 1); delta_col += mi_col & 1; }
        for (int i = 0; i < end4;) {
            int r = mi_row + delta_row + i, c = mi_col + delta_col;
            if (!is_inside(r, c)) break;
            int len = std::min(h4, bh4(mi_size[mi(r, c)]));
            if (std::abs(delta_col) > 1) len = std::max(2, len);
            if (step16) len = std::max(4, len);
            add_candidate(r, c, len * 2);
            i += len;
        }
    }
    void scan_point(int dr, int dc) {
        int r = mi_row + dr, c = mi_col + dc;
        if (is_inside(r, c) && decoded[mi(r, c)]) add_candidate(r, c, 4);
    }
    void sort_stack(int start, int end) {
        while (end > start) {
            int new_end = start;
            for (int idx = start + 1; idx < end; idx++) {
                if (stack_weight[idx - 1] < stack_weight[idx]) {
                    std::swap(stack_weight[idx - 1], stack_weight[idx]);
                    std::swap(stack_mv[idx - 1][0], stack_mv[idx][0]);
                    std::swap(stack_mv[idx - 1][1], stack_mv[idx][1]);
                    new_end = idx;
                }
            }
            end = new_end;
        }
    }
    int read_mv_component(int comp) {
        MvCdf& m = cdf.mv;
        int sign = sym(m.sign[comp], 2);
        int cls = sym(m.classes[comp], 11);
        int mag;
        if (cls == 0) {
            int b = sym(m.class0[comp], 2);
            mag = ((b << 3) | (3 << 1) | 1) + 1;
        } else {
            int d = 0;
            for (int i = 0; i < cls; i++) d |= sym(m.bits[comp][i], 2) << i;
            mag = (2 << (cls + 2)) + ((d << 3) | (3 << 1) | 1) + 1;
        }
        return sign ? -mag : mag;
    }
    void read_intrabc_mv() {
        int w4 = bw4(bsize), h4 = bh4(bsize);
        num_mv = 0;
        for (int i = 0; i < 8; i++) { stack_mv[i][0] = stack_mv[i][1] = 0; stack_weight[i] = 0; }
        scan_row(-1);
        scan_col(-1);
        if (std::max(w4, h4) <= 16) scan_point(-1, w4);
        int num_nearest = num_mv;
        for (int i = 0; i < num_nearest; i++) stack_weight[i] += 640;
        scan_point(-1, -1);
        scan_row(-3);
        scan_col(-3);
        if (h4 > 1) scan_row(-5);
        if (w4 > 1) scan_col(-5);
        sort_stack(0, num_nearest);
        sort_stack(num_nearest, num_mv);
        for (int i = 0; i < num_mv; i++) {
            int top = -(mi_row * 4 * 8), bottom = (h.mi_rows - h4 - mi_row) * 4 * 8;
            int left = -(mi_col * 4 * 8), right = (h.mi_cols - w4 - mi_col) * 4 * 8;
            int br = 128 + h4 * 4 * 8, bc = 128 + w4 * 4 * 8;
            stack_mv[i][0] = clip3(top - br, bottom + br, stack_mv[i][0]);
            stack_mv[i][1] = clip3(left - bc, right + bc, stack_mv[i][1]);
        }
        int pred[2] = {stack_mv[0][0], stack_mv[0][1]};
        if (pred[0] == 0 && pred[1] == 0) { pred[0] = stack_mv[1][0]; pred[1] = stack_mv[1][1]; }
        if (pred[0] == 0 && pred[1] == 0) {
            int sb4 = s.sb128 ? 32 : 16;
            if (mi_row - sb4 < mi_row_start) { pred[0] = 0; pred[1] = -(sb4 * 4 + 256) * 8; }
            else { pred[0] = -(sb4 * 4 * 8); pred[1] = 0; }
        }
        // dav1d rounds the reference DV to whole pixels
        pred[0] = (pred[0] >> 3) * 8; pred[1] = (pred[1] >> 3) * 8;
        int joint = sym(cdf.mv.joints, 4);
        if (joint & 2) pred[0] += read_mv_component(0);
        if (joint & 1) pred[1] += read_mv_component(1);
        // dav1d keeps the DV inside the decoded part of the tile
        int border_left = mi_col_start * 4, border_top = mi_row_start * 4;
        if (has_chroma) {
            if (w4 < 2 && ssx) border_left += 4;
            if (h4 < 2 && ssy) border_top += 4;
        }
        int src_left = mi_col * 4 + (pred[1] >> 3), src_top = mi_row * 4 + (pred[0] >> 3);
        int src_right = src_left + w4 * 4, src_bottom = src_top + h4 * 4;
        int border_right = ((mi_col_end + (w4 - 1)) & ~(w4 - 1)) * 4;
        if (src_left < border_left) { src_right += border_left - src_left; src_left = border_left; }
        else if (src_right > border_right) {
            src_left -= src_right - border_right;
            src_right = border_right;
        }
        if (src_top < border_top) { src_bottom += border_top - src_top; src_top = border_top; }
        int sbs = s.sb128 ? 5 : 4;
        int sbx = (mi_col >> sbs) << (sbs + 2), sby = (mi_row >> sbs) << (sbs + 2);
        int sb_size = 1 << (sbs + 2);
        if (src_bottom > sby && src_right > sbx) {
            if (src_top - border_top >= src_bottom - sby) {
                src_top -= src_bottom - sby; src_bottom = sby;
            } else if (src_left - border_left >= src_right - sbx) {
                src_left -= src_right - sbx; src_right = sbx;
            }
        }
        if (src_bottom > sby + sb_size) {
            src_top -= src_bottom - (sby + sb_size);
            src_bottom = sby + sb_size;
        }
        if (src_bottom > sby && src_right > sbx)
            fail("AV1 IntraBC vector into the current superblock");
        mv[1] = (src_left - mi_col * 4) * 8;
        mv[0] = (src_top - mi_row * 4) * 8;
    }
    void predict_intrabc(int p) {
        int pb = plane_residual_size(bsize, p);
        int sx = p ? ssx : 0, sy = p ? ssy : 0;
        int w = bw4(pb) * 4, hh = bh4(pb) * 4;
        int x = (mi_col >> sx) * 4, y = (mi_row >> sy) * 4;
        // the current frame is read to its 8-pixel-aligned size, as dav1d reads it
        int last_x = ((h.mi_cols * 4) >> sx) - 1, last_y = ((h.mi_rows * 4) >> sy) - 1;
        int start_x = ((x << 4) + ((2 * mv[1]) >> sx)) * 64 + 32;
        int start_y = ((y << 4) + ((2 * mv[0]) >> sy)) * 64 + 32;
        Plane& pl = planes[p];
        // the specification's InterRound0 / InterRound1 of a single prediction
        int round0 = bd == 12 ? 5 : 3, round1 = bd == 12 ? 9 : 11;
        int ih = hh + 7;
        std::vector<int32_t> inter_buf(size_t(ih) * w);
        for (int r = 0; r < ih; r++) {
            int ry = clip3(0, last_y, (start_y >> 10) + r - 3);
            for (int c = 0; c < w; c++) {
                int px = start_x + 1024 * c;
                int f = (px >> 6) & 15;
                int x0 = clip3(0, last_x, (px >> 10)), x1 = clip3(0, last_x, (px >> 10) + 1);
                int sum = (128 - 8 * f) * pl.at(x0, ry) + 8 * f * pl.at(x1, ry);
                inter_buf[size_t(r) * w + c] = round2(sum, round0);
            }
        }
        std::vector<uint16_t> out(size_t(w) * hh);
        for (int r = 0; r < hh; r++) {
            int py = (start_y & 1023) + 1024 * r;
            int f = (py >> 6) & 15;
            int base = (py >> 10) + 3;
            for (int c = 0; c < w; c++) {
                int sum = (128 - 8 * f) * inter_buf[size_t(base) * w + c] +
                          8 * f * inter_buf[size_t(base + 1) * w + c];
                out[size_t(r) * w + c] = uint16_t(clip3(0, (1 << bd) - 1, round2(sum, round1)));
            }
        }
        for (int r = 0; r < hh; r++)
            memcpy(&pl.at(x, y + r), &out[size_t(r) * w], w * sizeof(uint16_t));
    }
    void compute_prediction() {
        if (!use_intrabc) return;
        for (int p = 0; p < 1 + 2 * has_chroma; p++) predict_intrabc(p);
    }

    // ---- residual
    int get_tx_size(int p, int tx) {
        if (p == 0) return tx;
        int uv = max_tx_rect(plane_residual_size(bsize, p));
        if (txw(uv) == 64 || txh(uv) == 64) {
            if (txw(uv) == 16) return TX_16X32;
            if (txh(uv) == 16) return TX_32X16;
            return TX_32X32;
        }
        return uv;
    }
    void residual() {
        int wchunks = std::max(1, bw4(bsize) >> 4), hchunks = std::max(1, bh4(bsize) >> 4);
        int size_chunk = (wchunks > 1 || hchunks > 1) ? BLOCK_64X64 : bsize;
        for (int cy = 0; cy < hchunks; cy++) {
            for (int cx = 0; cx < wchunks; cx++) {
                int mrow = mi_row + (cy << 4), mcol = mi_col + (cx << 4);
                for (int p = 0; p < 1 + 2 * has_chroma; p++) {
                    int tx = lossless ? TX_4X4 : get_tx_size(p, tx_size);
                    int stepx = txw(tx) >> 2, stepy = txh(tx) >> 2;
                    int psz = plane_residual_size(size_chunk, p);
                    int n4w = bw4(psz), n4h = bh4(psz);
                    int sx = p ? ssx : 0, sy = p ? ssy : 0;
                    int base_x = (mcol >> sx) * 4, base_y = (mrow >> sy) * 4;
                    if (inter && !lossless && !p) {
                        transform_tree(base_x, base_y, n4w * 4, n4h * 4);
                    } else {
                        int bxb = (mi_col >> sx) * 4, byb = (mi_row >> sy) * 4;
                        for (int y = 0; y < n4h; y += stepy)
                            for (int x = 0; x < n4w; x += stepx)
                                transform_block(p, bxb, byb, tx, x + ((cx << 4) >> sx),
                                                y + ((cy << 4) >> sy));
                    }
                }
            }
        }
    }
    void transform_tree(int sx0, int sy0, int w, int hh) {
        int maxx = h.mi_cols * 4, maxy = h.mi_rows * 4;
        if (sx0 >= maxx || sy0 >= maxy) return;
        int row = sy0 >> 2, col = sx0 >> 2;
        int tx = inter_tx_size[mi(row, col)];
        int tw = txw(tx), th = txh(tx);
        if (w <= tw && hh <= th) {
            transform_block(0, sx0, sy0, tx, 0, 0);
        } else if (w > hh) {
            transform_tree(sx0, sy0, w / 2, hh); transform_tree(sx0 + w / 2, sy0, w / 2, hh);
        } else if (w < hh) {
            transform_tree(sx0, sy0, w, hh / 2); transform_tree(sx0, sy0 + hh / 2, w, hh / 2);
        } else {
            transform_tree(sx0, sy0, w / 2, hh / 2);
            transform_tree(sx0 + w / 2, sy0, w / 2, hh / 2);
            transform_tree(sx0, sy0 + hh / 2, w / 2, hh / 2);
            transform_tree(sx0 + w / 2, sy0 + hh / 2, w / 2, hh / 2);
        }
    }
    void transform_block(int p, int base_x, int base_y, int tx, int x, int y) {
        int start_x = base_x + 4 * x, start_y = base_y + 4 * y;
        int sx = p ? ssx : 0, sy = p ? ssy : 0;
        int row = (start_y << sy) >> 2, col = (start_x << sx) >> 2;
        int sb_mask = s.sb128 ? 31 : 15;
        int sub_row = row & sb_mask, sub_col = col & sb_mask;
        int stepx = txw(tx) >> 2, stepy = txh(tx) >> 2;
        int maxx = h.mi_cols * 4 - 1, maxy = h.mi_rows * 4 - 1;
        if (start_x >= (maxx >> sx) + 1 || start_y >= (maxy >> sy) + 1) return;
        if (!inter) {
            if ((p == 0 && palette_size_y) || (p != 0 && palette_size_uv)) {
                predict_palette(p, start_x, start_y, x, y, tx);
            } else {
                bool is_cfl = p > 0 && uvmode == UV_CFL_PRED;
                int mode = p == 0 ? ymode : (is_cfl ? DC_PRED : uvmode);
                int have_left = (p == 0 ? avail_l : avail_l_chroma) || x > 0;
                int have_above = (p == 0 ? avail_u : avail_u_chroma) || y > 0;
                // block_decoded is offset by one row and column
                int have_ar = block_decoded[p][sub_row >> sy][(sub_col >> sx) + stepx + 1];
                int have_bl = block_decoded[p][(sub_row >> sy) + stepy + 1][sub_col >> sx];
                predict_intra(p, start_x, start_y, have_left, have_above, have_ar, have_bl, mode,
                              txw_log2[tx], txh_log2[tx]);
                if (is_cfl) predict_cfl(p, start_x, start_y, tx);
            }
            if (p == 0) { max_luma_w = start_x + stepx * 4; max_luma_h = start_y + stepy * 4; }
        }
        if (!skip) {
            int eob = coeffs(start_x, start_y, p, tx);
            if (eob > 0) reconstruct(p, start_x, start_y, tx);
        }
        for (int i = 0; i < stepy; i++)
            for (int j = 0; j < stepx; j++) {
                int rr = (row >> sy) + i, cc = (col >> sx) + j;
                if (rr < mirows_alloc && cc < micols_alloc) lf_tx_size[p][mi(rr, cc)] = uint8_t(tx);
                int br = (sub_row >> sy) + i + 1, bc = (sub_col >> sx) + j + 1;
                if (br < 35 && bc < 35) block_decoded[p][br][bc] = 1;
            }
    }

    // ---- coefficients
    int get_tx_set(int tx) {
        int sqr = tx_sqr(tx), sqr_up = tx_sqr_up(tx);
        if (sqr_up > TX_32X32) return TX_SET_DCTONLY;
        if (inter) {
            if (h.reduced_tx_set || sqr_up == TX_32X32) return TX_SET_INTER_3;
            if (sqr == TX_16X16) return TX_SET_INTER_2;
            return TX_SET_INTER_1;
        }
        if (sqr_up == TX_32X32) return TX_SET_DCTONLY;
        if (h.reduced_tx_set) return TX_SET_INTRA_2;
        if (sqr == TX_16X16) return TX_SET_INTRA_2;
        return TX_SET_INTRA_1;
    }
    void transform_type(int x4, int y4, int tx) {
        int set = get_tx_set(tx);
        int q = h.seg_enabled ? get_qindex(h, 1, segment_id, current_q) : h.base_q_idx;
        int type = DCT_DCT;
        if (set > 0 && q > 0) {
            int sqr = tx_sqr(tx);
            if (inter) {
                if (set == TX_SET_INTER_1)
                    type = tx_inter_inv_set1[sym(cdf.inter_tx_set1[sqr], 16)];
                else if (set == TX_SET_INTER_2)
                    type = tx_inter_inv_set2[sym(cdf.inter_tx_set2, 12)];
                else type = tx_inter_inv_set3[sym(cdf.inter_tx_set3[sqr], 2)];
            } else {
                int dir = use_filter_intra ? filter_intra_mode_to_intra_dir[filter_intra_mode]
                                           : ymode;
                if (set == TX_SET_INTRA_1)
                    type = tx_intra_inv_set1[sym(cdf.intra_tx_set1[sqr][dir], 7)];
                else type = tx_intra_inv_set2[sym(cdf.intra_tx_set2[sqr][dir], 5)];
            }
        }
        for (int i = 0; i < (txw(tx) >> 2); i++)
            for (int j = 0; j < (txh(tx) >> 2); j++)
                if (y4 + j < mirows_alloc && x4 + i < micols_alloc)
                    tx_types[mi(y4 + j, x4 + i)] = uint8_t(type);
    }
    int compute_tx_type(int p, int tx, int bx, int by) {
        if (lossless || tx_sqr_up(tx) > TX_32X32) return DCT_DCT;
        int set = get_tx_set(tx);
        if (p == 0) return tx_types[mi(by, bx)];
        int t;
        if (inter) {
            int x4 = std::max(mi_col, bx << ssx), y4 = std::max(mi_row, by << ssy);
            t = tx_types[mi(y4, x4)];
        } else {
            t = mode_to_txfm[uvmode];
        }
        return tx_in_set(set, t) ? t : DCT_DCT;
    }
    int coeffs(int start_x, int start_y, int p, int tx) {
        int x4 = start_x >> 2, y4 = start_y >> 2, w4 = txw(tx) >> 2, h4 = txh(tx) >> 2;
        int tx_ctx = (tx_sqr(tx) + tx_sqr_up(tx) + 1) >> 1;
        int ptype = p > 0;
        int seg_eob = (tx == TX_16X64 || tx == TX_64X16) ? 512 : std::min(1024, txw(tx) * txh(tx));
        for (int c = 0; c < seg_eob; c++) quant[c] = 0;
        int eob = 0, cul_level = 0, dc_category = 0;
        int maxx4 = h.mi_cols, maxy4 = h.mi_rows;
        if (p > 0) { maxx4 >>= ssx; maxy4 >>= ssy; }
        // all_zero context
        int ctx;
        int w = txw(tx), hh = txh(tx);
        if (p == 0) {
            int top = 0, left = 0;
            for (int k = 0; k < w4; k++)
                if (x4 + k < maxx4) top = std::max(top, int(above_level[p][x4 + k]));
            for (int k = 0; k < h4; k++)
                if (y4 + k < maxy4) left = std::max(left, int(left_level[p][y4 + k]));
            top = std::min(top, 255); left = std::min(left, 255);
            int bs = plane_residual_size(bsize, p);
            if (bw4(bs) * 4 == w && bh4(bs) * 4 == hh) ctx = 0;
            else if (top == 0 && left == 0) ctx = 1;
            else if (top == 0 || left == 0) ctx = 2 + (std::max(top, left) > 3);
            else if (std::max(top, left) <= 3) ctx = 4;
            else if (std::min(top, left) <= 3) ctx = 5;
            else ctx = 6;
        } else {
            int above = 0, left = 0;
            for (int i = 0; i < w4; i++)
                if (x4 + i < maxx4) above |= above_level[p][x4 + i] | above_dc[p][x4 + i];
            for (int i = 0; i < h4; i++)
                if (y4 + i < maxy4) left |= left_level[p][y4 + i] | left_dc[p][y4 + i];
            ctx = (above != 0) + (left != 0) + 7;
            int bs = plane_residual_size(bsize, p);
            if (bw4(bs) * bh4(bs) * 16 > w * hh) ctx += 3;
        }
        int all_zero = sym(cdf.txb_skip[tx_ctx][ctx], 2);
        if (all_zero) {
            if (p == 0)
                for (int i = 0; i < w4; i++)
                    for (int j = 0; j < h4; j++)
                        if (y4 + j < mirows_alloc && x4 + i < micols_alloc)
                            tx_types[mi(y4 + j, x4 + i)] = DCT_DCT;
        } else {
            if (p == 0) transform_type(x4, y4, tx);
            plane_tx_type = compute_tx_type(p, tx, x4, y4);
            int cls = tx_class(plane_tx_type);
            const std::vector<uint16_t>* scan;
            // 64-point transforms take the 32 x 32 coded area's default scan; a 1-D
            // class reads rows (vertical) or columns (horizontal) in order
            if (tx_sqr_up(tx) == TX_64X64 || tx == TX_16X64 || tx == TX_64X16 || cls == TX_CLASS_2D)
                scan = &scans().deflt[tx];
            else if (cls == TX_CLASS_VERT)
                scan = &scans().mrow[tx];
            else
                scan = &scans().mcol[tx];
            const uint16_t* sc = scan->data();
            int eob_multisize = std::min(txw_log2[tx], 5) + std::min(txh_log2[tx], 5) - 4;
            int ectx = cls == TX_CLASS_2D ? 0 : 1;
            int eob_pt;
            switch (eob_multisize) {
                case 0: eob_pt = sym(cdf.eob_pt_16[ptype][ectx], 5); break;
                case 1: eob_pt = sym(cdf.eob_pt_32[ptype][ectx], 6); break;
                case 2: eob_pt = sym(cdf.eob_pt_64[ptype][ectx], 7); break;
                case 3: eob_pt = sym(cdf.eob_pt_128[ptype][ectx], 8); break;
                case 4: eob_pt = sym(cdf.eob_pt_256[ptype][ectx], 9); break;
                case 5: eob_pt = sym(cdf.eob_pt_512[ptype][0], 10); break;
                default: eob_pt = sym(cdf.eob_pt_1024[ptype][0], 11); break;
            }
            eob_pt += 1;
            eob = eob_pt < 2 ? eob_pt : ((1 << (eob_pt - 2)) + 1);
            int eob_shift = eob_pt - 3;
            if (eob_shift >= 0) {
                if (sym(cdf.eob_extra[tx_ctx][ptype][eob_pt - 3], 2)) eob += 1 << eob_shift;
                for (int i = 1; i < std::max(0, eob_pt - 2); i++) {
                    eob_shift = std::max(0, eob_pt - 2) - 1 - i;
                    if (lit(1)) eob += 1 << eob_shift;
                }
            }
            int adj = adjusted_tx(tx);
            int bwl = txw_log2[adj], txh_a = txh(adj), txw_a = 1 << bwl;
            int area = txh_a << bwl;
            // the offsets follow the transform's own shape (32x64 is tall), not
            // the coded 32x32
            const uint8_t* lo_off =
                av1t::lo_ctx_offsets[txw(tx) == txh(tx) ? 0 : (txw(tx) > txh(tx) ? 1 : 2)][0];
            for (int c = eob - 1; c >= 0; c--) {
                int pos = sc[c];
                int level;
                if (c == eob - 1) {
                    int bctx = c == 0 ? 0 : (c <= area / 8 ? 1 : (c <= area / 4 ? 2 : 3));
                    level = sym(cdf.coeff_base_eob[tx_ctx][ptype][bctx], 3) + 1;
                } else {
                    int row = pos >> bwl, col = pos - (row << bwl);
                    int mag = 0;
                    for (int idx = 0; idx < 5; idx++) {
                        int rr = row + sig_ref_diff_offset[cls][idx][0];
                        int cc = col + sig_ref_diff_offset[cls][idx][1];
                        if (rr < txh_a && cc < txw_a)
                            mag += std::min(std::abs(quant[(rr << bwl) + cc]), 3);
                    }
                    int bctx = std::min((mag + 1) >> 1, 4);
                    if (cls == TX_CLASS_2D) {
                        if (row == 0 && col == 0) bctx = 0;
                        else bctx += lo_off[std::min(row, 4) * 5 + std::min(col, 4)];
                    } else {
                        int idx = cls == TX_CLASS_VERT ? row : col;
                        bctx += coeff_base_pos_ctx_offset[std::min(idx, 2)];
                    }
                    level = sym(cdf.coeff_base[tx_ctx][ptype][bctx], 4);
                }
                if (level > 2) {
                    int row = pos >> bwl, col = pos - (row << bwl);
                    int mag = 0;
                    for (int idx = 0; idx < 3; idx++) {
                        int rr = row + mag_ref_offset[cls][idx][0];
                        int cc = col + mag_ref_offset[cls][idx][1];
                        if (rr < txh_a && cc < txw_a) mag += std::min(quant[(rr << bwl) + cc], 15);
                    }
                    mag = std::min((mag + 1) >> 1, 6);
                    int bctx;
                    if (pos == 0) bctx = mag;
                    else if (cls == TX_CLASS_2D) bctx = (row < 2 && col < 2) ? mag + 7 : mag + 14;
                    else if (cls == TX_CLASS_HORIZ) bctx = col == 0 ? mag + 7 : mag + 14;
                    else bctx = row == 0 ? mag + 7 : mag + 14;
                    for (int idx = 0; idx < 4; idx++) {
                        int br = sym(cdf.coeff_br[std::min(tx_ctx, 3)][ptype][bctx], 4);
                        level += br;
                        if (br < 3) break;
                    }
                }
                quant[pos] = level;
            }
            for (int c = 0; c < eob; c++) {
                int pos = sc[c];
                int sign = 0;
                if (quant[pos] != 0) {
                    if (c == 0) {
                        int dsign = 0;
                        for (int k = 0; k < w4; k++)
                            if (x4 + k < maxx4) {
                                int sg = above_dc[p][x4 + k];
                                if (sg == 1) dsign--; else if (sg == 2) dsign++;
                            }
                        for (int k = 0; k < h4; k++)
                            if (y4 + k < maxy4) {
                                int sg = left_dc[p][y4 + k];
                                if (sg == 1) dsign--; else if (sg == 2) dsign++;
                            }
                        int dctx = dsign < 0 ? 1 : (dsign > 0 ? 2 : 0);
                        sign = sym(cdf.dc_sign[ptype][dctx], 2);
                    } else {
                        sign = lit(1);
                    }
                }
                if (quant[pos] > 14) {
                    // dav1d's read_golomb: at most 32 leading zeros
                    int len = 0;
                    while (!lit(1) && len < 32) len++;
                    uint32_t x = 1;
                    while (len--) x = (x << 1) | uint32_t(lit(1));
                    quant[pos] = int32_t((x + 14) & 0xFFFFF);
                }
                if (pos == 0 && quant[pos] > 0) dc_category = sign ? 1 : 2;
                quant[pos] &= 0xFFFFF;
                cul_level += quant[pos];
                if (sign) quant[pos] = -quant[pos];
            }
            cul_level = std::min(63, cul_level);
        }
        for (int i = 0; i < w4 && x4 + i < micols_alloc; i++) {
            above_level[p][x4 + i] = uint8_t(cul_level);
            above_dc[p][x4 + i] = uint8_t(dc_category);
        }
        for (int i = 0; i < h4 && y4 + i < mirows_alloc; i++) {
            left_level[p][y4 + i] = uint8_t(cul_level);
            left_dc[p][y4 + i] = uint8_t(dc_category);
        }
        return eob;
    }

    // ---- reconstruction
    int dc_q(int p) {
        int q = get_qindex(h, 0, segment_id, current_q);
        int d = p == 0 ? h.dq_y_dc : (p == 1 ? h.dq_u_dc : h.dq_v_dc);
        return av1t::dc_qlookup[(bd - 8) >> 1][clip3(0, 255, q + d)];
    }
    int ac_q(int p) {
        int q = get_qindex(h, 0, segment_id, current_q);
        int d = p == 0 ? 0 : (p == 1 ? h.dq_u_ac : h.dq_v_ac);
        return av1t::ac_qlookup[(bd - 8) >> 1][clip3(0, 255, q + d)];
    }
    void reconstruct(int p, int x, int y, int tx) {
        int pels = txw(tx) * txh(tx);
        int dq_shift = (pels > 256) + (pels > 1024);
        int w = txw(tx), hh = txh(tx);
        int tw = std::min(32, w), th = std::min(32, hh);
        int qm_level = (lossless || !h.using_qmatrix) ? 15 : h.seg_qm_level[p][segment_id];
        bool use_qm = qm_level < 15 && plane_tx_type < IDTX;
        const uint8_t* qm = use_qm ? &av1t::qm_iwt[qm_level][p > 0][qm_offset(tx)] : nullptr;
        int dcq = dc_q(p), acq = ac_q(p);
        int maxv = (1 << (7 + bd)) - 1, minv = -(1 << (7 + bd));
        for (int i = 0; i < th; i++)
            for (int j = 0; j < tw; j++) {
                int k = i * tw + j;
                int q = (i == 0 && j == 0) ? dcq : acq;
                // the matrices are stored column by column
                if (qm) q = round2(q * qm[j * th + i], 5);
                int32_t c = quant[k];
                int64_t a = std::abs(int64_t(c));
                int64_t dq = ((a * q) & 0xFFFFFF) >> dq_shift;
                if (c < 0) dq = -dq;
                dequant_buf[k] = int32_t(std::max<int64_t>(minv, std::min<int64_t>(maxv, dq)));
            }
        inverse_transform_2d(dequant_buf, tx, plane_tx_type, lossless, bd, resid);
        Plane& pl = planes[p];
        int pmax = (1 << bd) - 1;
        for (int i = 0; i < hh; i++) {
            uint16_t* row = pl.row(y + i) + x;
            for (int j = 0; j < w; j++)
                row[j] = uint16_t(clip3(0, pmax, row[j] + resid[i * w + j]));
        }
    }

    // ---- intra prediction
    int filter_type(int p) {
        bool above_sm = false, left_sm = false;
        auto smooth = [&](int r, int c) {
            int m = p == 0 ? y_mode[mi(r, c)] : uv_mode[mi(r, c)];
            return m == SMOOTH_PRED || m == SMOOTH_V_PRED || m == SMOOTH_H_PRED;
        };
        if (p == 0 ? avail_u : avail_u_chroma) {
            int r = mi_row - 1, c = mi_col;
            if (p > 0) { if (ssx && !(mi_col & 1)) c++; if (ssy && (mi_row & 1)) r--; }
            above_sm = smooth(r, c);
        }
        if (p == 0 ? avail_l : avail_l_chroma) {
            int r = mi_row, c = mi_col - 1;
            if (p > 0) { if (ssx && (mi_col & 1)) c--; if (ssy && !(mi_row & 1)) r++; }
            left_sm = smooth(r, c);
        }
        return above_sm || left_sm;
    }
    static int edge_filter_strength(int w, int hh, int type, int delta) {
        int d = std::abs(delta), wh = w + hh;
        if (type == 0) {
            if (wh <= 8) { if (d >= 56) return 1; }
            else if (wh <= 16) { if (d >= 40) return 1; }
            else if (wh <= 24) return d >= 32 ? 3 : (d >= 16 ? 2 : (d >= 8 ? 1 : 0));
            else if (wh <= 32) { if (d >= 32) return 3; if (d >= 4) return 2; return 1; }
            else return 3;
        } else {
            if (wh <= 8) { if (d >= 64) return 2; if (d >= 40) return 1; }
            else if (wh <= 16) { if (d >= 48) return 2; if (d >= 20) return 1; }
            else if (wh <= 24) { if (d >= 4) return 3; }
            else return 3;
        }
        return 0;
    }
    static int use_upsample(int w, int hh, int type, int delta) {
        int d = std::abs(delta), wh = w + hh;
        if (d <= 0 || d >= 40) return 0;
        return type ? wh <= 8 : wh <= 16;
    }
    // edge: pointer to element 0 (element -1 is valid)
    static void edge_filter(int* edge, int sz, int strength) {
        if (!strength) return;
        int buf[300];
        for (int i = 0; i < sz; i++) buf[i] = edge[i - 1];
        for (int i = 1; i < sz; i++) {
            int sum = 0;
            for (int j = 0; j < 5; j++) {
                int k = clip3(0, sz - 1, i - 2 + j);
                sum += intra_edge_kernel[strength - 1][j] * buf[k];
            }
            edge[i - 1] = (sum + 8) >> 4;
        }
    }
    void edge_upsample(int* buf, int num_px) {
        int dup[300];
        int pmax = (1 << bd) - 1;
        dup[0] = buf[-1];
        for (int i = -1; i < num_px; i++) dup[i + 2] = buf[i];
        dup[num_px + 2] = buf[num_px - 1];
        buf[-2] = dup[0];
        for (int i = 0; i < num_px; i++) {
            int sum = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3];
            sum = clip3(0, pmax, round2(sum, 4));
            buf[2 * i - 1] = sum;
            buf[2 * i] = dup[i + 2];
        }
    }
    void predict_intra(int p, int x, int y, int have_left, int have_above, int have_ar, int have_bl,
                       int mode, int lw, int lh) {
        Plane& pl = planes[p];
        int w = 1 << lw, hh = 1 << lh;
        int sx = p ? ssx : 0, sy = p ? ssy : 0;
        int maxx = (h.mi_cols * 4 - 1) >> sx, maxy = (h.mi_rows * 4 - 1) >> sy;
        int above_buf[300], left_buf[300];
        int* above = above_buf + 16;  // index -16 .. valid
        int* left = left_buf + 16;
        int n = w + hh;
        int half = 1 << (bd - 1);
        if (!have_above && have_left) { for (int i = 0; i < n; i++) above[i] = pl.at(x - 1, y); }
        else if (!have_above && !have_left) { for (int i = 0; i < n; i++) above[i] = half - 1; }
        else {
            int limit = std::min(maxx, x + (have_ar ? 2 * w : w) - 1);
            for (int i = 0; i < n; i++) above[i] = pl.at(std::min(limit, x + i), y - 1);
        }
        if (!have_left && have_above) { for (int i = 0; i < n; i++) left[i] = pl.at(x, y - 1); }
        else if (!have_left && !have_above) { for (int i = 0; i < n; i++) left[i] = half + 1; }
        else {
            int limit = std::min(maxy, y + (have_bl ? 2 * hh : hh) - 1);
            for (int i = 0; i < n; i++) left[i] = pl.at(x - 1, std::min(limit, y + i));
        }
        if (have_above && have_left) above[-1] = pl.at(x - 1, y - 1);
        else if (have_above) above[-1] = pl.at(x, y - 1);
        else if (have_left) above[-1] = pl.at(x - 1, y);
        else above[-1] = half;
        left[-1] = above[-1];
        int pmax = (1 << bd) - 1;
        auto put = [&](int i, int j, int v) { pl.at(x + j, y + i) = uint16_t(v); };
        if (p == 0 && use_filter_intra) {
            int w4 = w >> 2, h2 = hh >> 1;
            for (int i2 = 0; i2 < h2; i2++)
                for (int j4 = 0; j4 < w4; j4++) {
                    int pv[7];
                    for (int i = 0; i < 7; i++) {
                        if (i < 5) {
                            if (i2 == 0) pv[i] = above[(j4 << 2) + i - 1];
                            else if (j4 == 0 && i == 0) pv[i] = left[(i2 << 1) - 1];
                            else pv[i] = fi_pred[(i2 << 1) - 1][(j4 << 2) + i - 1];
                        } else {
                            if (j4 == 0) pv[i] = left[(i2 << 1) + i - 5];
                            else pv[i] = fi_pred[(i2 << 1) + i - 5][(j4 << 2) - 1];
                        }
                    }
                    for (int i = 0; i < 8; i++) {
                        int pr = 0;
                        for (int j = 0; j < 7; j++)
                            pr += av1t::filter_intra_taps[filter_intra_mode][i][j] * pv[j];
                        fi_pred[(i2 << 1) + (i >> 2)][(j4 << 2) + (i & 3)] =
                            clip3(0, pmax, round2signed(pr, 4));
                    }
                }
            for (int i = 0; i < hh; i++) for (int j = 0; j < w; j++) put(i, j, fi_pred[i][j]);
            return;
        }
        if (is_directional(mode)) {
            int angle_delta = p == 0 ? angle_delta_y : angle_delta_uv;
            int pangle = mode_to_angle[mode] + angle_delta * 3;
            int up_above = 0, up_left = 0;
            if (s.enable_intra_edge_filter) {
                if (pangle != 90 && pangle != 180) {
                    if (pangle > 90 && pangle < 180 && (w + hh) >= 24) {
                        int v = round2(left[0] * 5 + above[-1] * 6 + above[0] * 5, 4);
                        left[-1] = above[-1] = v;
                    }
                    int ft = filter_type(p);
                    if (have_above) {
                        int st = edge_filter_strength(w, hh, ft, pangle - 90);
                        int num = std::min(w, maxx - x + 1) + (pangle < 90 ? hh : 0) + 1;
                        edge_filter(above, num, st);
                    }
                    if (have_left) {
                        int st = edge_filter_strength(w, hh, ft, pangle - 180);
                        int num = std::min(hh, maxy - y + 1) + (pangle > 180 ? w : 0) + 1;
                        edge_filter(left, num, st);
                    }
                }
                int ft = filter_type(p);
                up_above = use_upsample(w, hh, ft, pangle - 90);
                if (up_above) edge_upsample(above, w + (pangle < 90 ? hh : 0));
                up_left = use_upsample(w, hh, ft, pangle - 180);
                if (up_left) edge_upsample(left, hh + (pangle > 180 ? w : 0));
            }
            int dx = 0, dy = 0;
            if (pangle < 90) dx = av1t::dr_intra_derivative[pangle];
            else if (pangle > 90 && pangle < 180) dx = av1t::dr_intra_derivative[180 - pangle];
            if (pangle > 90 && pangle < 180) dy = av1t::dr_intra_derivative[pangle - 90];
            else if (pangle > 180) dy = av1t::dr_intra_derivative[270 - pangle];
            for (int i = 0; i < hh; i++)
                for (int j = 0; j < w; j++) {
                    int v;
                    if (pangle == 90) v = above[j];
                    else if (pangle == 180) v = left[i];
                    else if (pangle < 90) {
                        int idx = (i + 1) * dx;
                        int base = (idx >> (6 - up_above)) + (j << up_above);
                        int shift = ((idx << up_above) >> 1) & 0x1F;
                        int max_base = (w + hh - 1) << up_above;
                        if (base < max_base)
                            v = round2(above[base] * (32 - shift) + above[base + 1] * shift, 5);
                        else v = above[max_base];
                    } else if (pangle < 180) {
                        int idx = (j << 6) - (i + 1) * dx;
                        int base = idx >> (6 - up_above);
                        if (base >= -(1 << up_above)) {
                            int shift = ((idx * (1 << up_above)) >> 1) & 0x1F;
                            v = round2(above[base] * (32 - shift) + above[base + 1] * shift, 5);
                        } else {
                            idx = (i << 6) - (j + 1) * dy;
                            base = idx >> (6 - up_left);
                            int shift = ((idx * (1 << up_left)) >> 1) & 0x1F;
                            v = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
                        }
                    } else {
                        int idx = (j + 1) * dy;
                        int base = (idx >> (6 - up_left)) + (i << up_left);
                        int shift = ((idx << up_left) >> 1) & 0x1F;
                        int max_base = (w + hh - 1) << up_left;
                        if (base < max_base)
                            v = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
                        else v = left[max_base];
                    }
                    put(i, j, v);
                }
            return;
        }
        if (mode == SMOOTH_PRED || mode == SMOOTH_V_PRED || mode == SMOOTH_H_PRED) {
            const uint8_t* wx = &av1t::smooth_weights[w - 4];
            const uint8_t* wy = &av1t::smooth_weights[hh - 4];
            for (int i = 0; i < hh; i++)
                for (int j = 0; j < w; j++) {
                    int v;
                    if (mode == SMOOTH_PRED)
                        v = round2(wy[i] * above[j] + (256 - wy[i]) * left[hh - 1] +
                                   wx[j] * left[i] + (256 - wx[j]) * above[w - 1], 9);
                    else if (mode == SMOOTH_V_PRED)
                        v = round2(wy[i] * above[j] + (256 - wy[i]) * left[hh - 1], 8);
                    else
                        v = round2(wx[j] * left[i] + (256 - wx[j]) * above[w - 1], 8);
                    put(i, j, v);
                }
            return;
        }
        if (mode == DC_PRED) {
            int avg;
            if (have_left && have_above) {
                int sum = 0;
                for (int k = 0; k < hh; k++) sum += left[k];
                for (int k = 0; k < w; k++) sum += above[k];
                avg = (sum + ((w + hh) >> 1)) / (w + hh);
            } else if (have_left) {
                int sum = 0;
                for (int k = 0; k < hh; k++) sum += left[k];
                avg = (sum + (hh >> 1)) >> lh;
            } else if (have_above) {
                int sum = 0;
                for (int k = 0; k < w; k++) sum += above[k];
                avg = (sum + (w >> 1)) >> lw;
            } else {
                avg = half;
            }
            for (int i = 0; i < hh; i++) for (int j = 0; j < w; j++) put(i, j, avg);
            return;
        }
        // PAETH
        for (int i = 0; i < hh; i++)
            for (int j = 0; j < w; j++) {
                int base = above[j] + left[i] - above[-1];
                int pl_ = std::abs(base - left[i]), pt = std::abs(base - above[j]),
                    ptl = std::abs(base - above[-1]);
                int v;
                if (pl_ <= pt && pl_ <= ptl) v = left[i];
                else if (pt <= ptl) v = above[j];
                else v = above[-1];
                put(i, j, v);
            }
    }
    void predict_palette(int p, int sx0, int sy0, int x, int y, int tx) {
        int w = txw(tx), hh = txh(tx);
        const uint16_t* pal = palette_colors[p];
        const uint8_t* map = p == 0 ? color_map_y : color_map_uv;
        int bw = bw4(bsize) * 4;
        if (p > 0) { bw >>= ssx; if (bw < 4) bw += 2; }
        Plane& pl = planes[p];
        for (int i = 0; i < hh; i++)
            for (int j = 0; j < w; j++)
                pl.at(sx0 + j, sy0 + i) = pal[map[(y * 4 + i) * bw + x * 4 + j]];
    }
    void predict_cfl(int p, int sx0, int sy0, int tx) {
        int w = txw(tx), hh = txh(tx);
        int alpha = p == 1 ? cfl_alpha_u : cfl_alpha_v;
        Plane& luma = planes[0];
        Plane& pl = planes[p];
        int valid_w = std::max(1, (max_luma_w - (sx0 << ssx)) >> ssx);
        int valid_h = std::max(1, (max_luma_h - (sy0 << ssy)) >> ssy);
        int64_t sum = 0;
        for (int i = 0; i < hh; i++) {
            int li = std::min(i, valid_h - 1);
            int ly = (sy0 + li) << ssy;
            for (int j = 0; j < w; j++) {
                int lj = std::min(j, valid_w - 1);
                int lx = (sx0 + lj) << ssx;
                int t = 0;
                for (int dy = 0; dy <= ssy; dy++)
                    for (int dx = 0; dx <= ssx; dx++) t += luma.at(lx + dx, ly + dy);
                int v = t << (3 - ssx - ssy);
                cfl_buf[i * w + j] = v;
                sum += v;
            }
        }
        int avg = int(round2l(sum, txw_log2[tx] + txh_log2[tx]));
        int pmax = (1 << bd) - 1;
        for (int i = 0; i < hh; i++)
            for (int j = 0; j < w; j++) {
                int dc = pl.at(sx0 + j, sy0 + i);
                int scaled = round2signed(alpha * (cfl_buf[i * w + j] - avg), 6);
                pl.at(sx0 + j, sy0 + i) = uint16_t(clip3(0, pmax, dc + scaled));
            }
    }

    // ---- deblocking
    void loop_filter() {
        if (h.allow_intrabc || h.coded_lossless) return;
        if (!(h.lf_level[0] || h.lf_level[1])) return;
        for (int p = 0; p < num_planes; p++) {
            if (p == 0 || h.lf_level[1 + p]) {
                for (int pass = 0; pass < 2; pass++) {
                    int rstep = p == 0 ? 1 : (1 << ssy), cstep = p == 0 ? 1 : (1 << ssx);
                    for (int r = 0; r < h.mi_rows; r += rstep)
                        for (int c = 0; c < h.mi_cols; c += cstep) edge_loop_filter(p, pass, r, c);
                }
            }
        }
    }
    int filter_level(int row, int col, int p, int pass) {
        size_t k = mi(row, col);
        int seg = seg_ids[k];
        int dlf = h.delta_lf_multi ? delta_lfs[k * 4 + (p == 0 ? pass : p + 1)] : delta_lfs[k * 4];
        int i = p == 0 ? pass : p + 1;
        int base = clip3(0, 63, dlf + h.lf_level[i]);
        int lvl = base;
        int feature = SEG_LVL_ALT_LF_Y_V + i;
        if (h.seg_enabled && h.feature_enabled[seg][feature])
            lvl = clip3(0, 63, h.feature_data[seg][feature] + lvl);
        if (h.lf_delta_enabled) {
            int nshift = lvl >> 5;
            lvl = lvl + (h.lf_ref_deltas[0] * (1 << nshift));
            lvl = clip3(0, 63, lvl);
        }
        return lvl;
    }
    void edge_loop_filter(int p, int pass, int row, int col) {
        int sx = p ? ssx : 0, sy = p ? ssy : 0;
        int dx = pass == 0, dy = pass == 1;
        int x = col * 4, y = row * 4;
        row |= sy; col |= sx;
        bool on_screen;
        if (x >= h.width) on_screen = false;
        else if (y >= h.height) on_screen = false;
        else if (pass == 0 && x == 0) on_screen = false;
        else if (pass == 1 && y == 0) on_screen = false;
        else on_screen = true;
        if (!on_screen) return;
        int xp = x >> sx, yp = y >> sy;
        int prev_row = row - (dy << sy), prev_col = col - (dx << sx);
        int msz = mi_size[mi(row, col)];
        int tx = lf_tx_size[p][mi(row >> sy, col >> sx)];
        int psz = plane_residual_size(msz, p);
        int sk = skip_map[mi(row, col)], intra = !is_inter[mi(row, col)];
        int prev_tx = lf_tx_size[p][mi(prev_row >> sy, prev_col >> sx)];
        bool block_edge = pass == 0 ? xp % (bw4(psz) * 4) == 0 : yp % (bh4(psz) * 4) == 0;
        bool tx_edge = pass == 0 ? xp % txw(tx) == 0 : yp % txh(tx) == 0;
        bool apply = tx_edge && (block_edge || !sk || intra);
        int base_size = pass == 0 ? std::min(txw(prev_tx), txw(tx))
                                  : std::min(txh(prev_tx), txh(tx));
        int filter_size = p == 0 ? std::min(16, base_size) : std::min(8, base_size);
        int lvl = filter_level(row, col, p, pass);
        if (lvl == 0) lvl = filter_level(prev_row, prev_col, p, pass);
        int shift = h.lf_sharpness > 4 ? 2 : (h.lf_sharpness > 0 ? 1 : 0);
        int limit = h.lf_sharpness > 0 ? clip3(1, 9 - h.lf_sharpness, lvl >> shift)
                                       : std::max(1, lvl >> shift);
        int blimit = 2 * (lvl + 2) + limit;
        int thresh = lvl >> 4;
        if (!apply || lvl == 0) return;
        for (int i = 0; i < 4; i++)
            sample_filter(p, xp + dy * i, yp + dx * i, limit, blimit, thresh, dx, dy, filter_size);
    }
    void sample_filter(int p, int x, int y, int limit, int blimit, int thresh, int dx, int dy,
                       int filter_size) {
        Plane& pl = planes[p];
        auto S = [&](int k) -> uint16_t& { return pl.at(x + dx * k, y + dy * k); };  // k<0: p side
        int q0 = S(0), q1 = S(1), q2 = S(2), q3 = S(3);
        int p0 = S(-1), p1 = S(-2), p2 = S(-3), p3 = S(-4);
        int sh = bd - 8;
        int hev = (std::abs(p1 - p0) > (thresh << sh)) || (std::abs(q1 - q0) > (thresh << sh));
        int filter_len;
        if (filter_size == 4) filter_len = 4;
        else if (p != 0) filter_len = 6;
        else if (filter_size == 8) filter_len = 8;
        else filter_len = 16;
        int lim = limit << sh, blim = blimit << sh;
        int mask = 0;
        mask |= std::abs(p1 - p0) > lim;
        mask |= std::abs(q1 - q0) > lim;
        mask |= std::abs(p0 - q0) * 2 + std::abs(p1 - q1) / 2 > blim;
        if (filter_len >= 6) { mask |= std::abs(p2 - p1) > lim; mask |= std::abs(q2 - q1) > lim; }
        if (filter_len >= 8) { mask |= std::abs(p3 - p2) > lim; mask |= std::abs(q3 - q2) > lim; }
        if (mask) return;
        int one = 1 << sh;
        bool flat = false, flat2 = false;
        if (filter_size >= 8) {
            int f = 0;
            f |= std::abs(p1 - p0) > one; f |= std::abs(q1 - q0) > one;
            f |= std::abs(p2 - p0) > one; f |= std::abs(q2 - q0) > one;
            if (filter_len >= 8) { f |= std::abs(p3 - p0) > one; f |= std::abs(q3 - q0) > one; }
            flat = !f;
        }
        if (filter_size >= 16) {
            int q4 = S(4), q5 = S(5), q6 = S(6), p4 = S(-5), p5 = S(-6), p6 = S(-7);
            int f = 0;
            f |= std::abs(p6 - p0) > one; f |= std::abs(q6 - q0) > one;
            f |= std::abs(p5 - p0) > one; f |= std::abs(q5 - q0) > one;
            f |= std::abs(p4 - p0) > one; f |= std::abs(q4 - q0) > one;
            flat2 = !f;
        }
        if (filter_size == 4 || !flat) {
            // narrow filter
            int lo = -(1 << (bd - 1)), hi = (1 << (bd - 1)) - 1;
            int off = 0x80 << sh;
            int ps1 = p1 - off, ps0 = p0 - off, qs0 = q0 - off, qs1 = q1 - off;
            int filter = hev ? clip3(lo, hi, ps1 - qs1) : 0;
            filter = clip3(lo, hi, filter + 3 * (qs0 - ps0));
            int f1 = clip3(lo, hi, filter + 4) >> 3;
            int f2 = clip3(lo, hi, filter + 3) >> 3;
            S(0) = uint16_t(clip3(lo, hi, qs0 - f1) + off);
            S(-1) = uint16_t(clip3(lo, hi, ps0 + f2) + off);
            if (!hev) {
                filter = round2(f1, 1);
                S(1) = uint16_t(clip3(lo, hi, qs1 - filter) + off);
                S(-2) = uint16_t(clip3(lo, hi, ps1 + filter) + off);
            }
        } else {
            int log2size = (filter_size == 8 || !flat2) ? 3 : 4;
            int n;
            if (log2size == 4) n = 6;
            else if (p == 0) n = 3;
            else n = 2;
            int n2 = (log2size == 3 && p == 0) ? 0 : 1;
            int vals[16], out[16];
            for (int k = -(n + 1); k <= n; k++) vals[k + 8] = S(k);
            for (int i = -n; i < n; i++) {
                int t = 0;
                for (int j = -n; j <= n; j++) {
                    int pp = clip3(-(n + 1), n, i + j);
                    int tap = std::abs(j) <= n2 ? 2 : 1;
                    t += vals[pp + 8] * tap;
                }
                out[i + 8] = round2(t, log2size);
            }
            for (int i = -n; i < n; i++) S(i) = uint16_t(out[i + 8]);
        }
    }

    // ---- CDEF (specification 7.15): each 8 x 8 block that is not all skip,
    // in a 64 x 64 unit whose cdef_idx is not -1, filtered from the
    // deblocked planes into dst (a copy of them)
    void cdef(Plane* dst) {
        for (int r = 0; r < h.mi_rows; r += 2)
            for (int c = 0; c < h.mi_cols; c += 2) {
                int idx = cdef_idx[mi(r & ~15, c & ~15)];
                if (idx == -1) continue;
                if (skip_map[mi(r, c)] && skip_map[mi(r + 1, c)] && skip_map[mi(r, c + 1)] &&
                    skip_map[mi(r + 1, c + 1)])
                    continue;
                cdef_block(r, c, idx, dst);
            }
    }
    void cdef_block(int r, int c, int idx, Plane* dst) {
        // Cdef_Uv_Dir[ss_x][ss_y]: 4:2:2 chroma turns the luma direction
        static const int uv_dir[2][2][8] = {{{0, 1, 2, 3, 4, 5, 6, 7}, {1, 2, 2, 2, 3, 4, 6, 0}},
                                            {{7, 0, 2, 4, 5, 6, 6, 6}, {0, 1, 2, 3, 4, 5, 6, 7}}};
        int shift = bd - 8;
        int64_t var = 0;
        int ydir = cdef_direction(r, c, var);
        int pri = h.cdef_y_pri[idx] << shift, sec = h.cdef_y_sec[idx] << shift;
        int dir = pri == 0 ? 0 : ydir;
        int var_str = (var >> 6) ? std::min(floor_log2(uint32_t(var >> 6)), 12) : 0;
        pri = var ? (pri * (4 + var_str) + 8) >> 4 : 0;
        n_cdef += pri || sec || h.cdef_uv_pri[idx] || h.cdef_uv_sec[idx];
        cdef_filter(0, r, c, pri, sec, h.cdef_damping + shift, dir, dst);
        if (num_planes == 1) return;
        pri = h.cdef_uv_pri[idx] << shift;
        sec = h.cdef_uv_sec[idx] << shift;
        dir = pri == 0 ? 0 : uv_dir[ssx][ssy][ydir];
        cdef_filter(1, r, c, pri, sec, h.cdef_damping + shift - 1, dir, dst);
        cdef_filter(2, r, c, pri, sec, h.cdef_damping + shift - 1, dir, dst);
    }
    int cdef_direction(int r, int c, int64_t& var) {
        static const int div_table[9] = {0, 840, 420, 280, 210, 168, 140, 120, 105};
        int64_t cost[8] = {0};
        int partial[8][15] = {{0}};
        int x0 = c * 4, y0 = r * 4;
        for (int i = 0; i < 8; i++)
            for (int j = 0; j < 8; j++) {
                int x = (planes[0].at(x0 + j, y0 + i) >> (bd - 8)) - 128;
                partial[0][i + j] += x;
                partial[1][i + j / 2] += x;
                partial[2][i] += x;
                partial[3][3 + i - j / 2] += x;
                partial[4][7 + i - j] += x;
                partial[5][3 - i / 2 + j] += x;
                partial[6][j] += x;
                partial[7][i / 2 + j] += x;
            }
        auto sq = [](int v) { return int64_t(v) * v; };
        for (int i = 0; i < 8; i++) { cost[2] += sq(partial[2][i]); cost[6] += sq(partial[6][i]); }
        cost[2] *= div_table[8];
        cost[6] *= div_table[8];
        for (int i = 0; i < 7; i++) {
            cost[0] += (sq(partial[0][i]) + sq(partial[0][14 - i])) * div_table[i + 1];
            cost[4] += (sq(partial[4][i]) + sq(partial[4][14 - i])) * div_table[i + 1];
        }
        cost[0] += sq(partial[0][7]) * div_table[8];
        cost[4] += sq(partial[4][7]) * div_table[8];
        for (int i = 1; i < 8; i += 2) {
            for (int j = 0; j < 5; j++) cost[i] += sq(partial[i][3 + j]);
            cost[i] *= div_table[8];
            for (int j = 0; j < 3; j++)
                cost[i] += (sq(partial[i][j]) + sq(partial[i][10 - j])) * div_table[2 * j + 2];
        }
        int64_t best = 0;
        int ydir = 0;
        for (int i = 0; i < 8; i++)
            if (cost[i] > best) { best = cost[i]; ydir = i; }
        var = (best - cost[(ydir + 4) & 7]) >> 10;
        return ydir;
    }
    // constrain() with its damping shift, Max(0, damping - FloorLog2(threshold)),
    // worked out once per block
    static int constrain(int diff, int threshold, int shift) {
        // a threshold of 0 gives 0: Min(|diff|, Max(0, -(|diff| >> shift)))
        int a = std::abs(diff);
        int val = std::min(a, std::max(0, threshold - (a >> shift)));
        return diff < 0 ? -val : val;
    }
    void cdef_filter(int p, int r, int c, int pri, int sec, int damping, int dir, Plane* dst) {
        static const int pri_taps[2][2] = {{4, 2}, {3, 3}}, sec_taps[2] = {2, 1};
        if (!pri && !sec) return;  // the sum is 0: dst keeps the copy
        int sx = p ? ssx : 0, sy = p ? ssy : 0;
        int x0 = (c * 4) >> sx, y0 = (r * 4) >> sy;
        int w = 8 >> sx, hh = 8 >> sy;
        // CdefAvailable: inside the frame's 4 x 4 blocks (MiRows x MiCols);
        // the taps reach 2 samples out
        int avail_w = (h.mi_cols * 4) >> sx, avail_h = (h.mi_rows * 4) >> sy;
        bool inner = x0 >= 2 && y0 >= 2 && x0 + w + 2 <= avail_w && y0 + hh + 2 <= avail_h;
        const Plane& src = planes[p];
        int tap_set = (pri >> (bd - 8)) & 1;
        int pri_shift = pri ? std::max(0, damping - floor_log2(uint32_t(pri))) : 0;
        int sec_shift = sec ? std::max(0, damping - floor_log2(uint32_t(sec))) : 0;
        // the taps: k, direction (primary, then the two secondary ones)
        const int dirs[3] = {dir, (dir + 6) & 7, (dir + 2) & 7};
        int dy[2][3], dx[2][3], weight[2][3], strength[3] = {pri, sec, sec},
            shift[3] = {pri_shift, sec_shift, sec_shift};
        ptrdiff_t off[2][3];
        for (int k = 0; k < 2; k++)
            for (int t = 0; t < 3; t++) {
                dy[k][t] = av1t::cdef_directions[dirs[t]][k][0];
                dx[k][t] = av1t::cdef_directions[dirs[t]][k][1];
                off[k][t] = ptrdiff_t(dy[k][t]) * src.stride + dx[k][t];
                weight[k][t] = t == 0 ? pri_taps[tap_set][k] : sec_taps[k];
            }
        for (int i = 0; i < hh; i++) {
            const uint16_t* row = &src.at(x0, y0 + i);
            int sum[8] = {0}, mx[8], mn[8];
            for (int j = 0; j < w; j++) mx[j] = mn[j] = row[j];
            for (int k = 0; k < 2; k++)
                for (int t = 0; t < 3; t++)
                    for (int sign = -1; sign <= 1; sign += 2) {
                        const uint16_t* q = row + sign * off[k][t];
                        const int wt = weight[k][t], st = strength[t], sh = shift[t];
                        // a row of taps at once: all inside the frame, or each checked
                        int j0 = 0, j1 = w;
                        if (!inner) {
                            int yy = y0 + i + sign * dy[k][t];
                            if (yy < 0 || yy >= avail_h) continue;
                            j0 = std::max(0, -(x0 + sign * dx[k][t]));
                            j1 = std::min(w, avail_w - (x0 + sign * dx[k][t]));
                        }
                        for (int j = j0; j < j1; j++) {
                            int v = q[j];
                            sum[j] += wt * constrain(v - row[j], st, sh);
                            mx[j] = std::max(mx[j], v);
                            mn[j] = std::min(mn[j], v);
                        }
                    }
            uint16_t* out = &dst[p].at(x0, y0 + i);
            for (int j = 0; j < w; j++)
                out[j] = uint16_t(clip3(mn[j], mx[j], row[j] + ((8 + sum[j] - (sum[j] < 0)) >> 4)));
        }
    }

    // ---- superres (specification 7.16): each plane's rows upscaled with the
    // 8-tap filter, stepping as dav1d steps (initialSubpelX with its
    // SUPERRES_EXTRA_BITS error term), clamped to the 8-aligned decoded width
    void upscale(const Plane* src, Plane* dst) {
        int pmax = (1 << bd) - 1;
        for (int p = 0; p < num_planes; p++) {
            int sx = p ? ssx : 0, sy = p ? ssy : 0;
            int down_w = (h.width + sx) >> sx, up_w = (h.upscaled_width + sx) >> sx;
            int ph = (h.height + sy) >> sy;
            int step = ((down_w << 14) + (up_w >> 1)) / up_w;
            int err = up_w * step - (down_w << 14);
            int x0 = ((-((up_w - down_w) << 13) + (up_w >> 1)) / up_w + 128 - err / 2) & 0x3fff;
            int src_w = (4 * h.mi_cols + sx) >> sx;
            Plane& d = dst[p];
            d.w = d.stride = up_w;
            d.h = ph;
            d.px.assign(size_t(up_w) * ph, 0);
            for (int y = 0; y < ph; y++) {
                int mx = x0, src_x = -1;
                for (int x = 0; x < up_w; x++) {
                    const int8_t* f = av1t::upscale_filter[mx >> 8];
                    int sum = 0;
                    for (int k = 0; k < 8; k++)
                        sum += f[k] * src[p].at(clip3(0, src_w - 1, src_x + k - 3), y);
                    d.at(x, y) = uint16_t(clip3(0, pmax, (sum + 64) >> 7));
                    mx += step;
                    src_x += mx >> 14;
                    mx &= 0x3fff;
                }
            }
        }
    }

    // ---- loop restoration (specification 7.17), stripe by stripe: the
    // rows of a 64-row stripe (8 rows up, shifted by ss_y) are read from the
    // upscaled CDEF output, the two rows above and below it from the
    // upscaled deblocked frame (cur), each clamped to the plane
    void loop_restoration(const Plane* cur, const Plane* cdef_out, Plane* dst) {
        for (int p = 0; p < num_planes; p++) {
            if (h.lr_type[p] == RESTORE_NONE) continue;
            int sx = p ? ssx : 0, sy = p ? ssy : 0;
            int unit = h.lr_unit_size[p];
            int end_x = ((h.upscaled_width + sx) >> sx) - 1, end_y = ((h.height + sy) >> sy) - 1;
            int pw = end_x + 1;
            const int m = 4;  // the buffer's margin: 3 rows / columns and one more
            int bw = pw + 2 * m;
            std::vector<int32_t> buf;
            for (int k = 0;; k++) {
                int start = (-8 + 64 * k) >> sy, stop = start + (64 >> sy) - 1;
                if (start > end_y) break;
                int ys = std::max(0, start), ye = std::min(end_y, stop);
                if (ys > ye) continue;
                int rows = ye - ys + 1 + 2 * m;
                buf.assign(size_t(rows) * bw, 0);
                for (int r = 0; r < rows; r++) {
                    int y = clip3(0, end_y, ys - m + r);
                    const Plane* from = cdef_out;
                    if (y < start) { y = std::max(start - 2, y); from = cur; }
                    else if (y > stop) { y = std::min(stop + 2, y); from = cur; }
                    for (int c = 0; c < bw; c++)
                        buf[size_t(r) * bw + c] = from[p].at(clip3(0, end_x, c - m), y);
                }
                int unit_row = std::min(lr_rows[p] - 1, ((64 * k) >> sy) / unit);
                for (int uc = 0; uc < lr_cols[p]; uc++) {
                    // the last unit takes the rest of the plane
                    int xs = uc * unit;
                    int xe = uc == lr_cols[p] - 1 ? end_x : std::min(end_x, xs + unit - 1);
                    if (xs > xe) continue;
                    const LrUnit& u = lr_units[p][size_t(unit_row) * lr_cols[p] + uc];
                    const int32_t* origin = &buf[size_t(m) * bw + m + xs];
                    if (u.type == RESTORE_WIENER)
                        wiener(u, origin, bw, xe - xs + 1, ye - ys + 1, dst[p], xs, ys);
                    else if (u.type == RESTORE_SGRPROJ)
                        self_guided(u, origin, bw, xe - xs + 1, ye - ys + 1, dst[p], xs, ys);
                }
            }
        }
    }
    // src: the rectangle's first sample in a buffer of stride bw with 4
    // samples of margin on every side
    void wiener(const LrUnit& u, const int32_t* src, int bw, int w, int hh, Plane& dst, int x,
                int y) {
        int round0 = bd == 12 ? 5 : 3, round1 = bd == 12 ? 9 : 11;
        int offset = 1 << (bd + 7 - round0 - 1), limit = (1 << (bd + 1 + 7 - round0)) - 1;
        int vf[7], hf[7];
        for (int pass = 0; pass < 2; pass++) {
            int* f = pass ? hf : vf;
            f[3] = 128;
            for (int i = 0; i < 3; i++) {
                int c = u.wiener[pass][i];
                f[i] = f[6 - i] = c;
                f[3] -= 2 * c;
            }
        }
        std::vector<int32_t> inter(size_t(hh + 6) * w);
        for (int r = 0; r < hh + 6; r++)
            for (int c = 0; c < w; c++) {
                const int32_t* s = src + ptrdiff_t(r - 3) * bw + c - 3;
                int sum = 0;
                for (int t = 0; t < 7; t++) sum += hf[t] * s[t];
                inter[size_t(r) * w + c] = clip3(-offset, limit - offset, round2(sum, round0));
            }
        int pmax = (1 << bd) - 1;
        for (int r = 0; r < hh; r++)
            for (int c = 0; c < w; c++) {
                int64_t sum = 0;
                for (int t = 0; t < 7; t++) sum += int64_t(vf[t]) * inter[size_t(r + t) * w + c];
                dst.at(x + c, y + r) = uint16_t(clip3(0, pmax, int(round2l(sum, round1))));
            }
    }
    void self_guided(const LrUnit& u, const int32_t* src, int bw, int w, int hh, Plane& dst, int x,
                     int y) {
        std::vector<int32_t> f0, f1;
        int s0 = av1t::sgr_params[u.sgr_set][0], s1 = av1t::sgr_params[u.sgr_set][1];
        if (s0) box_filter(src, bw, w, hh, 2, s0, f0);
        if (s1) box_filter(src, bw, w, hh, 1, s1, f1);
        int w0 = u.xqd[0], w1 = u.xqd[1], w2 = 128 - w0 - w1;
        int pmax = (1 << bd) - 1;
        for (int i = 0; i < hh; i++)
            for (int j = 0; j < w; j++) {
                int64_t px = int64_t(src[ptrdiff_t(i) * bw + j]) << 4;
                int64_t v = w1 * px;
                v += w0 * (s0 ? int64_t(f0[size_t(i) * w + j]) : px);
                v += w2 * (s1 ? int64_t(f1[size_t(i) * w + j]) : px);
                dst.at(x + j, y + i) = uint16_t(clip3(0, pmax, int(round2l(v, 11))));
            }
    }
    void box_filter(const int32_t* src, int bw, int w, int hh, int r, int s,
                    std::vector<int32_t>& out) {
        int n = (2 * r + 1) * (2 * r + 1);
        int one_over_n = ((1 << 12) + (n >> 1)) / n;
        int aw = w + 2;
        std::vector<int32_t> A(size_t(hh + 2) * aw), B(size_t(hh + 2) * aw);
        for (int i = -1; i < hh + 1; i++)
            for (int j = -1; j < w + 1; j++) {
                int64_t a = 0, b = 0;
                for (int dy = -r; dy <= r; dy++) {
                    const int32_t* row = src + ptrdiff_t(i + dy) * bw + j;
                    for (int dx = -r; dx <= r; dx++) {
                        int64_t c = row[dx];
                        a += c * c;
                        b += c;
                    }
                }
                a = round2l(a, 2 * (bd - 8));
                int64_t d = round2l(b, bd - 8);
                int64_t p = std::max<int64_t>(0, a * n - d * d);
                int64_t z = round2l(p * s, 20);
                int a2;
                if (z >= 255) a2 = 256;
                else if (z == 0) a2 = 1;
                else a2 = int(((z << 8) + (z / 2)) / (z + 1));
                int64_t b2 = int64_t(256 - a2) * b * one_over_n;
                A[size_t(i + 1) * aw + j + 1] = a2;
                B[size_t(i + 1) * aw + j + 1] = int32_t(round2l(b2, 12));
            }
        out.assign(size_t(w) * hh, 0);
        for (int i = 0; i < hh; i++) {
            int shift = (r == 2 && (i & 1)) ? 4 : 5;
            for (int j = 0; j < w; j++) {
                int64_t a = 0, b = 0;
                for (int dy = -1; dy <= 1; dy++)
                    for (int dx = -1; dx <= 1; dx++) {
                        int weight;
                        if (r == 2) weight = ((i + dy) & 1) ? (dx == 0 ? 6 : 5) : 0;
                        else weight = (dx == 0 || dy == 0) ? 4 : 3;
                        size_t k = size_t(i + 1 + dy) * aw + j + 1 + dx;
                        a += weight * A[k];
                        b += weight * B[k];
                    }
                int64_t v = a * src[ptrdiff_t(i) * bw + j] + b;
                out[size_t(i) * w + j] = int32_t(round2l(v, 8 + shift - 4));
            }
        }
    }
};

// ------------------------------------------------------------ film grain
// dav1d 1.5.1's film grain synthesis (fg_apply_tmpl.c, filmgrain_tmpl.c),
// which libavif leaves on: the 16-bit LFSR, the 73 x 82 luma and the
// subsampled chroma grain templates with their auto-regression, the scaling
// look-up (interpolated between its points, and again between the 8-bit
// steps above 8 bits), 32-row stripes with a random offset per 32 x 32 block,
// the blending of the overlapped block edges and the clipping to the full or
// restricted range. Chroma reads the luma before grain; an odd width under
// horizontal subsampling repeats the last luma column.
namespace fg {

const int GRAIN_W = 82, GRAIN_H = 73, SUB_GRAIN_W = 44, SUB_GRAIN_H = 38, BLOCK = 32;
typedef int16_t Lut[GRAIN_H + 1][GRAIN_W];

inline int random_number(int bits, unsigned& state) {
    int r = int(state);
    unsigned bit = ((r >> 0) ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1;
    state = (unsigned(r) >> 1) | (bit << 15);
    return int(state >> (16 - bits)) & ((1 << bits) - 1);
}

inline int rnd2(int x, int shift) { return (x + ((1 << shift) >> 1)) >> shift; }

void generate_y(Lut buf, const FilmGrainParams& d, int bd) {
    unsigned seed = d.seed;
    int shift = 12 - bd + d.grain_scale_shift;
    int grain_max = (128 << (bd - 8)) - 1, grain_min = -(128 << (bd - 8));
    for (int y = 0; y < GRAIN_H; y++)
        for (int x = 0; x < GRAIN_W; x++)
            buf[y][x] = int16_t(rnd2(av1t::gaussian_sequence[random_number(11, seed)], shift));
    int lag = d.ar_coeff_lag;
    for (int y = 3; y < GRAIN_H; y++)
        for (int x = 3; x < GRAIN_W - 3; x++) {
            const int8_t* coeff = d.ar_coeffs_y;
            int sum = 0;
            for (int dy = -lag; dy <= 0; dy++)
                for (int dx = -lag; dx <= lag; dx++) {
                    if (!dx && !dy) break;
                    sum += *coeff++ * buf[y + dy][x + dx];
                }
            buf[y][x] = int16_t(clip3(grain_min, grain_max, buf[y][x] + rnd2(sum, d.ar_coeff_shift)));
        }
}

void generate_uv(Lut buf, const Lut buf_y, const FilmGrainParams& d, int uv, int subx, int suby,
                 int bd) {
    unsigned seed = d.seed ^ (uv ? 0x49d8 : 0xb524);
    int shift = 12 - bd + d.grain_scale_shift;
    int grain_max = (128 << (bd - 8)) - 1, grain_min = -(128 << (bd - 8));
    int cw = subx ? SUB_GRAIN_W : GRAIN_W, ch = suby ? SUB_GRAIN_H : GRAIN_H;
    for (int y = 0; y < ch; y++)
        for (int x = 0; x < cw; x++)
            buf[y][x] = int16_t(rnd2(av1t::gaussian_sequence[random_number(11, seed)], shift));
    int lag = d.ar_coeff_lag;
    for (int y = 3; y < ch; y++)
        for (int x = 3; x < cw - 3; x++) {
            const int8_t* coeff = d.ar_coeffs_uv[uv];
            int sum = 0;
            for (int dy = -lag; dy <= 0; dy++)
                for (int dx = -lag; dx <= lag; dx++) {
                    if (!dx && !dy) {
                        // the current sample: the co-located luma grain
                        if (!d.num_y_points) break;
                        int luma = 0;
                        int lx = ((x - 3) << subx) + 3, ly = ((y - 3) << suby) + 3;
                        for (int i = 0; i <= suby; i++)
                            for (int j = 0; j <= subx; j++) luma += buf_y[ly + i][lx + j];
                        sum += rnd2(luma, subx + suby) * *coeff;
                        break;
                    }
                    sum += *coeff++ * buf[y + dy][x + dx];
                }
            buf[y][x] = int16_t(clip3(grain_min, grain_max, buf[y][x] + rnd2(sum, d.ar_coeff_shift)));
        }
}

// the scaling function over every sample value (256 at 8 bits, 1 << bd above)
void generate_scaling(int bd, const uint8_t points[][2], int num, uint8_t* scaling) {
    int shift_x = bd - 8, size = 1 << bd;
    if (num == 0) { memset(scaling, 0, size); return; }
    memset(scaling, points[0][1], size_t(points[0][0]) << shift_x);
    for (int i = 0; i < num - 1; i++) {
        int bx = points[i][0], by = points[i][1], ex = points[i + 1][0], ey = points[i + 1][1];
        int dx = ex - bx, dy = ey - by;
        int delta = dy * ((0x10000 + (dx >> 1)) / dx);
        for (int x = 0, dd = 0x8000; x < dx; x++) {
            scaling[(bx + x) << shift_x] = uint8_t(by + (dd >> 16));
            dd += delta;
        }
    }
    int n = points[num - 1][0] << shift_x;
    memset(scaling + n, points[num - 1][1], size_t(size - n));
    if (bd == 8) return;
    int pad = 1 << shift_x, rnd = pad >> 1;
    for (int i = 0; i < num - 1; i++) {
        int bx = points[i][0] << shift_x, ex = points[i + 1][0] << shift_x;
        for (int x = 0; x < ex - bx; x += pad) {
            int range = scaling[bx + x + pad] - scaling[bx + x];
            for (int k = 1, r = rnd; k < pad; k++) {
                r += range;
                scaling[bx + x + k] = uint8_t(scaling[bx + x] + (r >> shift_x));
            }
        }
    }
}

inline int sample_lut(const Lut lut, const int offsets[2][2], int subx, int suby, int bx, int by,
                      int x, int y) {
    int randval = offsets[bx][by];
    int offx = 3 + (2 >> subx) * (3 + (randval >> 4));
    int offy = 3 + (2 >> suby) * (3 + (randval & 0xF));
    return lut[offy + y + (BLOCK >> suby) * by][offx + x + (BLOCK >> subx) * bx];
}

// One 32-row stripe of a plane: luma (luma == nullptr) or chroma plane uv
// (the luma plane before grain beside it). Planes are packed, pw wide.
void apply_stripe(const FilmGrainParams& d, int bd, const uint8_t* scaling, const Lut lut,
                  uint16_t* dst, const uint16_t* src, int pw, int bh, int row, int sx, int sy,
                  const uint16_t* luma, int luma_w, int uv, int is_id) {
    int rows = 1 + (d.overlap_flag && row > 0);
    int grain_max = (128 << (bd - 8)) - 1, grain_min = -(128 << (bd - 8));
    int bitdepth_max = (1 << bd) - 1;
    int min_value = 0, max_value = bitdepth_max;
    if (d.clip_to_restricted_range) {
        min_value = 16 << (bd - 8);
        max_value = (luma && !is_id ? 240 : 235) << (bd - 8);
    }
    unsigned seed[2];
    for (int i = 0; i < rows; i++) {
        seed[i] = d.seed;
        seed[i] ^= unsigned(((row - i) * 37 + 178) & 0xFF) << 8;
        seed[i] ^= unsigned(((row - i) * 173 + 105) & 0xFF);
    }
    int offsets[2][2] = {{0, 0}, {0, 0}};
    static const int wl[2][2] = {{27, 17}, {17, 27}};
    static const int wc[2][2][2] = {{{27, 17}, {17, 27}}, {{23, 22}, {0, 0}}};
    const int(*wx)[2] = luma ? wc[sx] : wl;
    const int(*wy)[2] = luma ? wc[sy] : wl;
    auto add = [&](int x, int y, int grain) {
        const uint16_t* s = src + size_t(y) * pw + x;
        int val = *s;
        if (luma) {
            int lx = x << sx;
            const uint16_t* l = luma + size_t(y << sy) * luma_w;
            int avg = l[lx];
            if (sx) avg = (avg + l[std::min(lx + 1, luma_w - 1)] + 1) >> 1;
            val = avg;
            if (!d.chroma_scaling_from_luma) {
                int combined = avg * d.uv_luma_mult[uv] + *s * d.uv_mult[uv];
                val = clip3(0, bitdepth_max, (combined >> 6) + d.uv_offset[uv] * (1 << (bd - 8)));
            }
        }
        int noise = rnd2(scaling[val] * grain, d.scaling_shift);
        dst[size_t(y) * pw + x] = uint16_t(clip3(min_value, max_value, *s + noise));
    };
    int step = BLOCK >> sx;
    for (int bx = 0; bx < pw; bx += step) {
        int bw = std::min(step, pw - bx);
        if (d.overlap_flag && bx)
            for (int i = 0; i < rows; i++) offsets[1][i] = offsets[0][i];
        for (int i = 0; i < rows; i++) offsets[0][i] = random_number(8, seed[i]);
        int ystart = d.overlap_flag && row ? std::min(2 >> sy, bh) : 0;
        int xstart = d.overlap_flag && bx ? std::min(2 >> sx, bw) : 0;
        auto blend = [&](int old, int cur, const int* w) {
            return clip3(grain_min, grain_max, rnd2(old * w[0] + cur * w[1], 5));
        };
        for (int y = ystart; y < bh; y++) {
            for (int x = xstart; x < bw; x++)
                add(bx + x, y, sample_lut(lut, offsets, sx, sy, 0, 0, x, y));
            for (int x = 0; x < xstart; x++) {
                int grain = sample_lut(lut, offsets, sx, sy, 0, 0, x, y);
                int old = sample_lut(lut, offsets, sx, sy, 1, 0, x, y);
                add(bx + x, y, blend(old, grain, wx[x]));
            }
        }
        for (int y = 0; y < ystart; y++) {
            for (int x = xstart; x < bw; x++) {
                int grain = sample_lut(lut, offsets, sx, sy, 0, 0, x, y);
                int old = sample_lut(lut, offsets, sx, sy, 0, 1, x, y);
                add(bx + x, y, blend(old, grain, wy[y]));
            }
            for (int x = 0; x < xstart; x++) {
                int top = sample_lut(lut, offsets, sx, sy, 0, 1, x, y);
                int old = sample_lut(lut, offsets, sx, sy, 1, 1, x, y);
                top = blend(old, top, wx[x]);
                int grain = sample_lut(lut, offsets, sx, sy, 0, 0, x, y);
                old = sample_lut(lut, offsets, sx, sy, 1, 0, x, y);
                grain = blend(old, grain, wx[x]);
                add(bx + x, y, blend(top, grain, wy[y]));
            }
        }
    }
}

// dav1d_apply_grain on packed planes (w x h luma, chroma of the layout), in
// place; is_id: the sequence header's matrix is the identity
void apply(const FilmGrainParams& d, int bd, int mono, int ssx, int ssy, int is_id, int w, int h,
           uint16_t* const planes[3]) {
    if (!d.has_grain()) return;
    static thread_local Lut lut[3];
    static thread_local uint8_t scaling[3][4096];
    generate_y(lut[0], d, bd);
    for (int pl = 0; pl < 2 && !mono; pl++)
        if (d.num_uv_points[pl] || d.chroma_scaling_from_luma)
            generate_uv(lut[1 + pl], lut[0], d, pl, ssx, ssy, bd);
    if (d.num_y_points || d.chroma_scaling_from_luma)
        generate_scaling(bd, d.y_points, d.num_y_points, scaling[0]);
    for (int pl = 0; pl < 2; pl++)
        if (d.num_uv_points[pl])
            generate_scaling(bd, d.uv_points[pl], d.num_uv_points[pl], scaling[1 + pl]);
    bool chroma = !mono && (d.num_uv_points[0] || d.num_uv_points[1] || d.chroma_scaling_from_luma);
    std::vector<uint16_t> luma;  // chroma reads the luma before grain
    if (chroma) luma.assign(planes[0], planes[0] + size_t(w) * h);
    int cw = (w + ssx) >> ssx;
    for (int row = 0; row * BLOCK < h; row++) {
        int bh = std::min(h - row * BLOCK, BLOCK);
        if (d.num_y_points) {
            uint16_t* p = planes[0] + size_t(row) * BLOCK * w;
            apply_stripe(d, bd, scaling[0], lut[0], p, p, w, bh, row, 0, 0, nullptr, 0, 0, is_id);
        }
        if (!chroma) continue;
        int cbh = (bh + ssy) >> ssy;
        size_t off = size_t(row) * (BLOCK >> ssy) * cw;
        const uint16_t* l = luma.data() + size_t(row) * BLOCK * w;
        for (int pl = 0; pl < 2; pl++) {
            if (!d.chroma_scaling_from_luma && !d.num_uv_points[pl]) continue;
            uint16_t* p = planes[1 + pl] + off;
            apply_stripe(d, bd, scaling[d.chroma_scaling_from_luma ? 0 : 1 + pl], lut[1 + pl], p,
                         p, cw, cbh, row, ssx, ssy, l, w, pl, is_id);
        }
    }
}

}  // namespace fg

// ------------------------------------------------------------ rescaling
// libavif's avifImageScaleWithLimit, which rescales a decoded frame to its
// item's ispe (or its track's tkhd) size: libyuv's ScalePlane (8 bits) or
// ScalePlane_12 (above) with kFilterBox on each plane. The routes are
// libyuv's: the filter reduced by ScaleFilterReduce, then a copy, the
// vertical-only path, the 3/4, 1/2, 3/8 and 1/4 downscales, the box filter,
// the exact 2x upscales, the bilinear up- and downscales and point sampling,
// with libyuv's 16.16 stepping. At 8 bits the horizontal filter is the SSSE3
// row (ScaleFilterCols_SSSE3: 7-bit fractions), which libyuv runs on x86.
namespace yuvscale {

enum Filter { NONE = 0, LINEAR = 1, BILINEAR = 2, BOX = 3 };

int reduce(int sw, int sh, int dw, int dh, int f) {
    if (f == BOX && (dw * 2 >= sw || dh * 2 >= sh)) f = BILINEAR;
    if (f == BILINEAR) {
        if (sh == 1) f = LINEAR;
        if (dh == sh || dh * 3 == sh) f = LINEAR;
        if (sw == 1) f = NONE;
    }
    if (f == LINEAR && (sw == 1 || dw == sw || dw * 3 == sw)) f = NONE;
    return f;
}

inline int fixed_div(int num, int div) { return int((int64_t(num) << 16) / div); }
inline int fixed_div1(int num, int div) {
    return int(((int64_t(num) << 16) - 0x00010001) / (div - 1));
}
inline int centerstart(int dx, int s) { return dx < 0 ? -((-dx >> 1) + s) : ((dx >> 1) + s); }

void slope(int sw, int sh, int dw, int dh, int f, int& x, int& y, int& dx, int& dy) {
    if (dw == 1 && sw >= 32768) dw = sw;
    if (dh == 1 && sh >= 32768) dh = sh;
    if (f == BOX) {
        dx = fixed_div(sw, dw); dy = fixed_div(sh, dh); x = 0; y = 0;
    } else if (f == BILINEAR || f == LINEAR) {
        if (dw <= sw) { dx = fixed_div(sw, dw); x = centerstart(dx, -32768); }
        else if (sw > 1 && dw > 1) { dx = fixed_div1(sw, dw); x = 0; }
        if (f == LINEAR) {
            dy = fixed_div(sh, dh); y = dy >> 1;
        } else if (dh <= sh) {
            dy = fixed_div(sh, dh); y = centerstart(dy, -32768);
        } else if (sh > 1 && dh > 1) {
            dy = fixed_div1(sh, dh); y = 0;
        }
    } else {
        dx = fixed_div(sw, dw); dy = fixed_div(sh, dh);
        x = centerstart(dx, 0); y = centerstart(dy, 0);
    }
}

template <typename T>
struct Scaler {
    const T* src; int sw, sh; ptrdiff_t ss;  // source plane and its stride
    T* dst; int dw, dh; ptrdiff_t ds;
    bool simd7;  // libyuv's SSSE3 horizontal filter (8 bits)

    const T* srow(int y) const { return src + ptrdiff_t(y) * ss; }
    T* drow(int y) const { return dst + ptrdiff_t(y) * ds; }

    static void interpolate_row(T* d, const T* s, ptrdiff_t stride, int width, int f) {
        if (f == 0) { memcpy(d, s, size_t(width) * sizeof(T)); return; }
        for (int x = 0; x < width; x++)
            d[x] = T((s[x] * (256 - f) + s[x + stride] * f + 128) >> 8);
    }
    // ScaleFilterCols (the SSSE3 row at 8 bits); s holds w samples
    void filter_cols(T* d, const T* s, int w, int n, int x, int dx) const {
        for (int j = 0; j < n; j++, x += dx) {
            int xi = x >> 16;
            int a = s[xi], b = s[std::min(xi + 1, w - 1)];
            if (simd7) {
                int f = (x >> 9) & 0x7f;
                d[j] = T((a * (128 - f) + b * f + 64) >> 7);
            } else {
                d[j] = T(a + int((int64_t(x & 0xffff) * (b - a) + 0x8000) >> 16));
            }
        }
    }
    static void cols(T* d, const T* s, int n, int x, int dx) {
        for (int j = 0; j < n; j++, x += dx) d[j] = s[x >> 16];
    }

    void vertical(int f) {
        int y = 0, dy = 0;
        if (dh <= sh) { dy = fixed_div(sh, dh); y = centerstart(dy, -32768); }
        else if (sh > 1 && dh > 1) dy = fixed_div1(sh, dh);
        int max_y = sh > 1 ? ((sh - 1) << 16) - 1 : 0;
        for (int j = 0; j < dh; j++, y += dy) {
            if (y > max_y) y = max_y;
            interpolate_row(drow(j), srow(y >> 16), ss, dw, f ? (y >> 8) & 255 : 0);
        }
    }
    void down2(int f) {
        for (int j = 0; j < dh; j++) {
            const T* s = srow(2 * j); const T* t = f == BILINEAR || f == BOX ? srow(2 * j + 1) : s;
            T* d = drow(j);
            for (int x = 0; x < dw; x++) {
                if (f == NONE) d[x] = srow(2 * j + 1)[2 * x + 1];
                else if (f == LINEAR) d[x] = T((s[2 * x] + s[2 * x + 1] + 1) >> 1);
                else d[x] = T((s[2 * x] + s[2 * x + 1] + t[2 * x] + t[2 * x + 1] + 2) >> 2);
            }
        }
    }
    void down4(int f) {
        for (int j = 0; j < dh; j++) {
            T* d = drow(j);
            for (int x = 0; x < dw; x++) {
                if (!f) { d[x] = srow(4 * j + 2)[4 * x + 2]; continue; }
                int sum = 0;
                for (int r = 0; r < 4; r++)
                    for (int c = 0; c < 4; c++) sum += srow(4 * j + r)[4 * x + c];
                d[x] = T((sum + 8) >> 4);
            }
        }
    }
    // ScaleRowDown34_0_Box (3 : 1 rows) and _1_Box (1 : 1); t = s + stride.
    // At 8 bits libyuv's SSSE3 rows (the rows blended first, by pavgb: once
    // for 1 : 1, twice for 3 : 1) make the first n - n % 24 outputs.
    void down34_row(T* d, const T* s, ptrdiff_t stride, int n, bool one, bool filter) const {
        const T* t = s + stride;
        int simd_n = simd7 ? n - n % 24 : 0;
        for (int x = 0; x < n; x += 3, s += 4, t += 4) {
            if (!filter) { d[x] = s[0]; d[x + 1] = s[1]; d[x + 2] = s[3]; continue; }
            if (x < simd_n) {
                int v[4];
                for (int k = 0; k < 4; k++) {
                    int m = (s[k] + t[k] + 1) >> 1;
                    v[k] = one ? m : (s[k] + m + 1) >> 1;
                }
                d[x] = T((v[0] * 3 + v[1] + 2) >> 2);
                d[x + 1] = T((v[1] * 2 + v[2] * 2 + 2) >> 2);
                d[x + 2] = T((v[2] + v[3] * 3 + 2) >> 2);
                continue;
            }
            int a0 = (s[0] * 3 + s[1] + 2) >> 2, a1 = (s[1] + s[2] + 1) >> 1,
                a2 = (s[2] + s[3] * 3 + 2) >> 2;
            int b0 = (t[0] * 3 + t[1] + 2) >> 2, b1 = (t[1] + t[2] + 1) >> 1,
                b2 = (t[2] + t[3] * 3 + 2) >> 2;
            if (one) {
                d[x] = T((a0 + b0 + 1) >> 1); d[x + 1] = T((a1 + b1 + 1) >> 1);
                d[x + 2] = T((a2 + b2 + 1) >> 1);
            } else {
                d[x] = T((a0 * 3 + b0 + 2) >> 2); d[x + 1] = T((a1 * 3 + b1 + 2) >> 2);
                d[x + 2] = T((a2 * 3 + b2 + 2) >> 2);
            }
        }
    }
    void down34(int f) {
        ptrdiff_t fs = f == LINEAR ? 0 : ss;
        const T* s = src;
        int y = 0;
        for (; y < dh - 2; y += 3) {
            down34_row(drow(y), s, fs, dw, false, f);
            s += ss;
            down34_row(drow(y + 1), s, fs, dw, true, f);
            s += ss;
            down34_row(drow(y + 2), s + ss, -fs, dw, false, f);
            s += 2 * ss;
        }
        if (dh % 3 == 2) {
            down34_row(drow(y), s, fs, dw, false, f);
            s += ss;
            down34_row(drow(y + 1), s, 0, dw, true, f);
        } else if (dh % 3 == 1) {
            down34_row(drow(y), s, 0, dw, false, f);
        }
    }
    // ScaleRowDown38_3_Box (three rows) and _2_Box (two). At 8 bits libyuv's
    // SSSE3 _2_Box (the two rows blended first, by pavgb) makes the first
    // n - n % 6 outputs.
    void down38_row(T* d, const T* s, ptrdiff_t stride, int n, int rows, bool filter) const {
        int simd_n = simd7 && rows == 2 ? n - n % 6 : 0;
        for (int x = 0; x < n; x += 3, s += 8) {
            if (!filter) { d[x] = s[0]; d[x + 1] = s[3]; d[x + 2] = s[6]; continue; }
            if (x < simd_n) {
                int v[8];
                for (int k = 0; k < 8; k++) v[k] = (s[k] + s[k + stride] + 1) >> 1;
                d[x] = T((v[0] + v[1] + v[2]) * (65536 / 3) >> 16);
                d[x + 1] = T((v[3] + v[4] + v[5]) * (65536 / 3) >> 16);
                d[x + 2] = T((v[6] + v[7]) * (65536 / 2) >> 16);
                continue;
            }
            uint32_t a = 0, b = 0, c = 0;
            for (int r = 0; r < rows; r++) {
                const T* p = s + r * stride;
                a += p[0] + p[1] + p[2]; b += p[3] + p[4] + p[5]; c += p[6] + p[7];
            }
            uint32_t k3 = rows == 3 ? 65536 / 9 : 65536 / 6, k2 = rows == 3 ? 65536 / 6 : 65536 / 4;
            d[x] = T(a * k3 >> 16); d[x + 1] = T(b * k3 >> 16); d[x + 2] = T(c * k2 >> 16);
        }
    }
    void down38(int f) {
        ptrdiff_t fs = f == LINEAR ? 0 : ss;
        const T* s = src;
        int y = 0;
        for (; y < dh - 2; y += 3) {
            down38_row(drow(y), s, fs, dw, 3, f); s += 3 * ss;
            down38_row(drow(y + 1), s, fs, dw, 3, f); s += 3 * ss;
            down38_row(drow(y + 2), s, fs, dw, 2, f); s += 2 * ss;
        }
        if (dh % 3 == 2) {
            down38_row(drow(y), s, fs, dw, 3, f); s += 3 * ss;
            down38_row(drow(y + 1), s, 0, dw, 3, f);
        } else if (dh % 3 == 1) {
            down38_row(drow(y), s, 0, dw, 3, f);
        }
    }
    void box() {
        int x = 0, y = 0, dx = 0, dy = 0;
        slope(sw, sh, dw, dh, BOX, x, y, dx, dy);
        const int max_y = sh << 16;
        std::vector<uint32_t> row(static_cast<size_t>(sw));
        for (int j = 0; j < dh; j++) {
            int iy = y >> 16;
            y += dy;
            if (y > max_y) y = max_y;
            int boxheight = std::max(1, (y >> 16) - iy);
            std::fill(row.begin(), row.end(), 0u);
            for (int k = 0; k < boxheight; k++) {
                const T* s = srow(iy + k);
                for (int i = 0; i < sw; i++) row[i] += s[i];
            }
            T* d = drow(j);
            auto sum = [&](int at, int n) {
                uint32_t v = 0;
                for (int i = 0; i < n; i++) v += row[at + i];
                return v;
            };
            if (dx & 0xffff) {  // ScaleAddCols2
                int minw = dx >> 16;
                int tbl[2] = {65536 / (std::max(1, minw) * boxheight),
                              65536 / (std::max(1, minw + 1) * boxheight)};
                int xx = x;
                for (int i = 0; i < dw; i++) {
                    int ix = xx >> 16;
                    xx += dx;
                    int bw = std::max(1, (xx >> 16) - ix);
                    d[i] = T(sum(ix, bw) * uint32_t(tbl[bw - minw]) >> 16);
                }
            } else {  // ScaleAddCols1 (ScaleAddCols0 at 8 bits for one column: the same)
                int bw = std::max(1, dx >> 16);
                uint32_t scale = uint32_t(65536 / (bw * boxheight));
                int xx = x >> 16;
                for (int i = 0; i < dw; i++, xx += bw) d[i] = T(sum(xx, bw) * scale >> 16);
            }
        }
    }
    static T lin(int a, int b) { return T((a * 3 + b + 2) >> 2); }
    void up2_linear_row(T* d, const T* s) const {
        d[0] = s[0];
        int work = (dw - 1) & ~1;
        for (int x = 0; x < work / 2; x++) {
            d[1 + 2 * x] = lin(s[x], s[x + 1]);
            d[2 + 2 * x] = lin(s[x + 1], s[x]);
        }
        d[dw - 1] = s[(dw - 1) / 2];
    }
    void up2_linear() {
        if (dh == 1) { up2_linear_row(drow(0), srow((sh - 1) / 2)); return; }
        int dy = fixed_div(sh - 1, dh - 1), y = (1 << 15) - 1;
        for (int i = 0; i < dh; i++, y += dy) up2_linear_row(drow(i), srow(y >> 16));
    }
    // ScaleRowUp2_Bilinear_Any: rows s, t to rows d, e (the same row when
    // the strides are 0)
    void up2_bilinear_rows(const T* s, const T* t, T* d, T* e) const {
        int a0 = (3 * s[0] + t[0] + 2) >> 2, b0 = (s[0] + 3 * t[0] + 2) >> 2;
        int work = (dw - 1) & ~1;
        std::vector<T> dd(static_cast<size_t>(dw)), ee(static_cast<size_t>(dw));
        dd[0] = T(a0); ee[0] = T(b0);
        for (int x = 0; x < work / 2; x++) {
            int s0 = s[x], s1 = s[x + 1], t0 = t[x], t1 = t[x + 1];
            dd[1 + 2 * x] = T((s0 * 9 + s1 * 3 + t0 * 3 + t1 + 8) >> 4);
            dd[2 + 2 * x] = T((s0 * 3 + s1 * 9 + t0 + t1 * 3 + 8) >> 4);
            ee[1 + 2 * x] = T((s0 * 3 + s1 + t0 * 9 + t1 * 3 + 8) >> 4);
            ee[2 + 2 * x] = T((s0 + s1 * 3 + t0 * 3 + t1 * 9 + 8) >> 4);
        }
        int k = (dw - 1) / 2;
        dd[dw - 1] = T((3 * s[k] + t[k] + 2) >> 2);
        ee[dw - 1] = T((s[k] + 3 * t[k] + 2) >> 2);
        memcpy(d, dd.data(), size_t(dw) * sizeof(T));
        if (e) memcpy(e, ee.data(), size_t(dw) * sizeof(T));
    }
    void up2_bilinear() {
        up2_bilinear_rows(srow(0), srow(0), drow(0), nullptr);
        int y = 1;
        for (int r = 0; r < sh - 1; r++, y += 2)
            up2_bilinear_rows(srow(r), srow(r + 1), drow(y), drow(y + 1));
        if (!(dh & 1)) up2_bilinear_rows(srow(sh - 1), srow(sh - 1), drow(y), nullptr);
    }
    void bilinear_up(int f) {
        int x = 0, y = 0, dx = 0, dy = 0;
        slope(sw, sh, dw, dh, f, x, y, dx, dy);
        const int max_y = (sh - 1) << 16;
        std::vector<T> rows(static_cast<size_t>(2 * dw));
        auto fcols = [&](T* d, const T* s) {
            if (f) filter_cols(d, s, sw, dw, x, dx);
            else if (sw * 2 == dw && x < 0x8000)
                for (int j = 0; j < dw; j++) d[j] = s[j >> 1];
            else cols(d, s, dw, x, dx);
        };
        if (y > max_y) y = max_y;
        int yi = y >> 16, lasty = yi;
        const T* s = srow(yi);
        T* rowptr = rows.data();
        ptrdiff_t rowstride = dw;
        fcols(rowptr, s);
        if (sh > 1) s += ss;
        fcols(rowptr + rowstride, s);
        if (sh > 2) s += ss;
        for (int j = 0; j < dh; j++, y += dy) {
            yi = y >> 16;
            if (yi != lasty) {
                if (y > max_y) { y = max_y; yi = y >> 16; s = srow(yi); }
                if (yi != lasty) {
                    fcols(rowptr, s);
                    rowptr += rowstride;
                    rowstride = -rowstride;
                    lasty = yi;
                    if (y + 65536 < max_y) s += ss;
                }
            }
            interpolate_row(drow(j), rowptr, rowstride, dw, f == LINEAR ? 0 : (y >> 8) & 255);
        }
    }
    void bilinear_down(int f) {
        int x = 0, y = 0, dx = 0, dy = 0;
        slope(sw, sh, dw, dh, f, x, y, dx, dy);
        const int max_y = (sh - 1) << 16;
        std::vector<T> row(static_cast<size_t>(sw));
        if (y > max_y) y = max_y;
        for (int j = 0; j < dh; j++) {
            const T* s = srow(y >> 16);
            if (f == LINEAR) {
                filter_cols(drow(j), s, sw, dw, x, dx);
            } else {
                interpolate_row(row.data(), s, ss, sw, (y >> 8) & 255);
                filter_cols(drow(j), row.data(), sw, dw, x, dx);
            }
            y += dy;
            if (y > max_y) y = max_y;
        }
    }
    void simple() {
        int x = 0, y = 0, dx = 0, dy = 0;
        slope(sw, sh, dw, dh, NONE, x, y, dx, dy);
        for (int i = 0; i < dh; i++, y += dy) {
            const T* s = srow(y >> 16);
            if (sw * 2 == dw && x < 0x8000)
                for (int j = 0; j < dw; j++) drow(i)[j] = s[j >> 1];
            else cols(drow(i), s, dw, x, dx);
        }
    }
    // libyuv's ScalePlane / ScalePlane_16 with kFilterBox
    void run() {
        int f = reduce(sw, sh, dw, dh, BOX);
        if (dw == sw && dh == sh) {
            for (int y = 0; y < dh; y++) memcpy(drow(y), srow(y), size_t(dw) * sizeof(T));
            return;
        }
        if (dw == sw && f != BOX) { vertical(f); return; }
        if (dw <= sw && dh <= sh) {
            if (4 * dw == 3 * sw && 4 * dh == 3 * sh) { down34(f); return; }
            if (2 * dw == sw && 2 * dh == sh) { down2(f); return; }
            if (8 * dw == 3 * sw && 8 * dh == 3 * sh) { down38(f); return; }
            if (4 * dw == sw && 4 * dh == sh && (f == BOX || f == NONE)) { down4(f); return; }
        }
        if (f == BOX && dh * 2 < sh) { box(); return; }
        if ((dw + 1) / 2 == sw && f == LINEAR) { up2_linear(); return; }
        if ((dh + 1) / 2 == sh && (dw + 1) / 2 == sw && (f == BILINEAR || f == BOX)) {
            up2_bilinear();
            return;
        }
        if (f && dh > sh) { bilinear_up(f); return; }
        if (f) { bilinear_down(f); return; }
        simple();
    }
};

}  // namespace yuvscale

// ------------------------------------------------------------ OBU layer
struct Result {
    int w = 0, h = 0, mono = 0, ssx = 0, ssy = 0, bit_depth = 8;
    int matrix = 2, range = 0, primaries = 2, transfer = 2;
    int allow_intrabc = 0, n_intrabc = 0, n_palette = 0, n_filter_intra = 0, n_cfl = 0,
        deblocked = 0, coded_w = 0, superres_denom = 8, n_cdef = 0, n_wiener = 0, n_sgrproj = 0,
        lr_types = 0;
    // film grain: applied, luma points, chroma points (4 bits each), and
    // ar_coeff_lag | overlap << 2 | chroma_scaling_from_luma << 3 | clip << 4
    int grain[4] = {0, 0, 0, 0};
    // the last sequence header parsed: its payload's offset and length
    int seq_off = -1, seq_len = 0;
    std::vector<uint16_t> planes[3];
};

uint64_t read_leb128(const uint8_t* p, size_t n, size_t& pos) {
    uint64_t v = 0;
    for (int i = 0; i < 8; i++) {
        if (pos >= n) fail("OBU size runs past the end of the data");
        uint8_t b = p[pos++];
        v |= uint64_t(b & 0x7f) << (7 * i);
        if (!(b & 0x80)) return v;
    }
    fail("OBU size: leb128 longer than 8 bytes");
}

// The frame is decoded only where it is cap_w x cap_h (the item's ispe):
// libavif rescales a frame of another size, so no plane of it is needed.
void decode_obus(const uint8_t* data, size_t size, Result& res, int cap_w, int cap_h,
                 const uint8_t* carry, size_t carry_len) {
    SequenceHeader seq;
    FrameHeader fh;
    auto header_info = [&]() {
        res.w = fh.upscaled_width; res.h = fh.height;
        res.mono = seq.mono; res.ssx = seq.ss_x; res.ssy = seq.ss_y; res.bit_depth = seq.bit_depth;
        res.matrix = seq.matrix; res.range = seq.color_range;
        res.primaries = seq.color_primaries; res.transfer = seq.transfer;
        res.allow_intrabc = fh.allow_intrabc;
    };
    // one tile group of frame f into d; true once the frame's last tile is in
    auto tile_group = [](Decoder& d, const FrameHeader& f, const uint8_t* obu, size_t osz,
                         int& next_tile) {
        BitReader b(obu, osz);
        int num_tiles = f.tile_cols * f.tile_rows;
        int tg_start = 0, tg_end = num_tiles - 1;
        if (num_tiles > 1 && b.f(1)) {
            int bits = f.tile_cols_log2 + f.tile_rows_log2;
            tg_start = b.f(bits); tg_end = b.f(bits);
        }
        if (tg_start != next_tile || tg_end < tg_start || tg_end >= num_tiles)
            fail("AV1 tile group: tiles out of order");
        b.byte_align();
        size_t p2 = b.pos >> 3;
        for (int t = tg_start; t <= tg_end; t++) {
            size_t tsize;
            if (t == tg_end) {
                tsize = osz - p2;
            } else {
                if (p2 + f.tile_size_bytes > osz)
                    fail("AV1 tile size past the end of the tile group");
                uint32_t v = 0;
                for (int i = 0; i < f.tile_size_bytes; i++) v |= uint32_t(obu[p2 + i]) << (8 * i);
                p2 += f.tile_size_bytes;
                tsize = size_t(v) + 1;
                if (tsize > osz - p2) fail("AV1 tile size past the end of the tile group");
            }
            if (p2 > osz) fail("AV1 tile past the end of the tile group");
            d.decode_tile(obu + p2, tsize, t / f.tile_cols, t % f.tile_cols);
            p2 += tsize;
        }
        next_tile = tg_end + 1;
        return next_tile == num_tiles;
    };
    // dav1d decodes the data to its end: the frames after the image's are
    // decoded and dropped, their errors failing the image, as far as they
    // are intra frames
    SequenceHeader later_seq;
    FrameHeader later_fh;
    std::unique_ptr<Decoder> later;
    int later_tile = 0;
    bool have_seq = false, have_frame_header = false, done = false;
    if (carry_len) {
        // the sequence header a decoder instance kept from its last item
        // (libavif decodes a grid's tiles with one dav1d instance)
        BitReader b(carry, carry_len);
        parse_sequence_header(b, seq);
        have_seq = true;
    }
    std::unique_ptr<Decoder> dec;
    int next_tile = 0;
    size_t pos = 0;
    // after the frame, dav1d (as libavif drains it) still parses the OBUs
    // that follow: a malformed one fails the image
    while (pos < size) {
        uint8_t hdr = data[pos++];  // dav1d ignores the forbidden bit unless strict
        int type = (hdr >> 3) & 15;
        int ext = (hdr >> 2) & 1, has_size = (hdr >> 1) & 1;
        int temporal_id = 0, spatial_id = 0;
        if (ext) {
            if (pos >= size) fail("OBU extension header past the end of the data");
            temporal_id = data[pos] >> 5; spatial_id = (data[pos] >> 3) & 3;
            pos++;
        }
        uint64_t obu_size;
        if (has_size) obu_size = read_leb128(data, size, pos);
        else obu_size = size - pos;
        if (obu_size > size - pos) fail("OBU size runs past the end of the data");
        const uint8_t* obu = data + pos;
        size_t osz = size_t(obu_size);
        pos += osz;
        if (done) {
            if (type == 5) {
                size_t p = 0;
                read_leb128(obu, osz, p);
            }
            if (type == 1) {
                BitReader b(obu, osz);
                SequenceHeader s2;
                parse_sequence_header(b, s2);
                later_seq = s2;
                res.seq_off = obu - data; res.seq_len = int(osz);
            } else if (type == 3 || type == 6 || (type == 7 && !later)) {
                BitReader b(obu, osz);
                later_fh = FrameHeader();
                try {
                    parse_frame_header(b, later_seq, later_fh, temporal_id, spatial_id);
                } catch (const Unfollowed&) {
                    break;
                }
                later.reset(new Decoder(later_seq, later_fh));
                later_tile = 0;
                if (type == 6) {
                    b.byte_align();
                    size_t off = b.pos >> 3;
                    if (off > osz) fail("AV1 frame OBU shorter than its header");
                    if (tile_group(*later, later_fh, obu + off, osz - off, later_tile))
                        later.reset();
                }
            } else if (type == 4) {
                if (!later) fail("AV1 tile group after the frame's last tile");
                if (tile_group(*later, later_fh, obu, osz, later_tile)) later.reset();
            }
            continue;
        }
        // an OBU outside the operating point's layers is dropped (operating point 0)
        if (ext && have_seq && type != 1 && type != 2) {
            int idc = seq.op_idc[0];
            if (idc && (!((idc >> temporal_id) & 1) || !((idc >> (spatial_id + 8)) & 1))) continue;
        }
        switch (type) {
            case 1: {  // sequence header
                BitReader b(obu, osz);
                SequenceHeader s2;
                parse_sequence_header(b, s2);
                seq = s2;
                have_seq = true;
                res.seq_off = obu - data; res.seq_len = int(osz);
                break;
            }
            case 2: break;  // temporal delimiter
            case 7:  // redundant frame header: dav1d reads it only without a frame header
                if (have_frame_header) break;
                // fallthrough
            case 3:  // frame header
            case 6: {  // frame
                if (!have_seq) fail("AV1 frame header before its sequence header");
                BitReader b(obu, osz);
                fh = FrameHeader();
                parse_frame_header(b, seq, fh, temporal_id, spatial_id);
                have_frame_header = true;
                if (fh.upscaled_width != cap_w || fh.height != cap_h) {
                    header_info();
                    return;
                }
                dec.reset(new Decoder(seq, fh));
                next_tile = 0;
                if (type != 6) break;  // a frame header OBU (or a redundant one) holds no tiles
                b.byte_align();
                size_t off = b.pos >> 3;
                if (off > osz) fail("AV1 frame OBU shorter than its header");
                // fall through to the tile group in the rest of the OBU
                obu += off; osz -= off;
            }
            // fallthrough
            case 4: {  // tile group
                if (!dec) fail("AV1 tile group without a frame header");
                if (tile_group(*dec, fh, obu, osz, next_tile)) {
                    done = true;
                    later_seq = seq;
                }
                break;
            }
            case 5: {  // metadata: dav1d fails where its type cannot be read
                size_t p = 0;
                read_leb128(obu, osz, p);
                break;
            }
            default: break;  // tile list, padding, reserved: skipped
        }
    }
    if (!have_seq) fail("AV1 data without a sequence header");
    if (!done) fail("AV1 data ends before the frame's last tile");
    // the in-loop filters: deblocking in place, CDEF into a copy, both
    // frames upscaled under superres, loop restoration from both
    dec->loop_filter();
    int np = seq.num_planes();
    Plane cdef_out[3], up_cur[3], up_cdef[3], restored[3];
    const Plane* out = dec->planes;
    if (fh.cdef_on) {
        for (int p = 0; p < np; p++) cdef_out[p] = dec->planes[p];
        dec->cdef(cdef_out);
        out = cdef_out;
    }
    const Plane* cur = dec->planes;
    if (fh.width != fh.upscaled_width) {
        dec->upscale(dec->planes, up_cur);
        cur = up_cur;
        if (out != dec->planes) dec->upscale(out, up_cdef);
        out = out != dec->planes ? up_cdef : up_cur;
    }
    if (fh.uses_lr) {
        for (int p = 0; p < np; p++) restored[p] = out[p];
        dec->loop_restoration(cur, out, restored);
        out = restored;
    }
    header_info();
    res.n_intrabc = dec->n_intrabc;
    res.n_palette = dec->n_palette;
    res.n_filter_intra = dec->n_filter_intra;
    res.n_cfl = dec->n_cfl;
    res.deblocked = !fh.allow_intrabc && !fh.coded_lossless && (fh.lf_level[0] || fh.lf_level[1]);
    res.coded_w = fh.width;
    res.superres_denom = fh.superres_denom;
    res.n_cdef = dec->n_cdef;
    res.n_wiener = dec->n_wiener;
    res.n_sgrproj = dec->n_sgrproj;
    res.lr_types = fh.lr_type[0] | fh.lr_type[1] << 2 | fh.lr_type[2] << 4;
    for (int p = 0; p < np; p++) {
        int sx = p ? seq.ss_x : 0, sy = p ? seq.ss_y : 0;
        int pw = (res.w + sx) >> sx, ph = (res.h + sy) >> sy;
        res.planes[p].resize(size_t(pw) * ph);
        for (int y = 0; y < ph; y++)
            memcpy(&res.planes[p][size_t(y) * pw], &out[p].at(0, y), pw * sizeof(uint16_t));
    }
    // film grain on the output frame, as dav1d applies it by default
    const FilmGrainParams& g = fh.grain;
    res.grain[0] = g.apply && g.has_grain();
    res.grain[1] = g.num_y_points;
    res.grain[2] = g.num_uv_points[0] | g.num_uv_points[1] << 4;
    res.grain[3] = g.ar_coeff_lag | g.overlap_flag << 2 | g.chroma_scaling_from_luma << 3 |
                   g.clip_to_restricted_range << 4;
    if (g.apply) {
        uint16_t* pl[3] = {res.planes[0].data(), np > 1 ? res.planes[1].data() : nullptr,
                           np > 1 ? res.planes[2].data() : nullptr};
        fg::apply(g, seq.bit_depth, seq.mono, seq.ss_x, seq.ss_y, seq.matrix == 0, res.w, res.h,
                  pl);
    }
}

template <typename T>
void copy_plane(const std::vector<uint16_t>& src, void* dst) {
    T* d = static_cast<T*>(dst);
    for (size_t i = 0; i < src.size(); i++) d[i] = T(src[i]);
}

}  // namespace

extern "C" {

// dav1d_apply_grain on packed planes (uint16 at every depth; y w x h, u and
// v of the layout, null in monochrome), in place. p: the parameters as
// Dav1dFilmGrainData holds them, in ints: seed, num_y_points, 14 luma
// points (value, scaling), chroma_scaling_from_luma, num_uv_points[2],
// 2 x 10 chroma points, scaling_shift, ar_coeff_lag, ar_coeffs_y[24],
// ar_coeffs_uv[2][25], ar_coeff_shift, grain_scale_shift, uv_mult[2],
// uv_luma_mult[2], uv_offset[2], overlap_flag, clip_to_restricted_range.
void citlab_av1_apply_grain(uint16_t* y, uint16_t* u, uint16_t* v, int32_t w, int32_t h,
                            int32_t depth, int32_t mono, int32_t ssx, int32_t ssy, int32_t is_id,
                            const int32_t* p) {
    FilmGrainParams g;
    g.apply = 1;
    g.seed = unsigned(*p++);
    g.num_y_points = *p++;
    for (int i = 0; i < 14; i++) { g.y_points[i][0] = uint8_t(*p++); g.y_points[i][1] = uint8_t(*p++); }
    g.chroma_scaling_from_luma = *p++;
    g.num_uv_points[0] = *p++; g.num_uv_points[1] = *p++;
    for (int pl = 0; pl < 2; pl++)
        for (int i = 0; i < 10; i++) {
            g.uv_points[pl][i][0] = uint8_t(*p++); g.uv_points[pl][i][1] = uint8_t(*p++);
        }
    g.scaling_shift = *p++; g.ar_coeff_lag = *p++;
    for (int i = 0; i < 24; i++) g.ar_coeffs_y[i] = int8_t(*p++);
    for (int pl = 0; pl < 2; pl++)
        for (int i = 0; i < 25; i++) g.ar_coeffs_uv[pl][i] = int8_t(*p++);
    g.ar_coeff_shift = *p++; g.grain_scale_shift = *p++;
    for (int* f : {g.uv_mult, g.uv_luma_mult, g.uv_offset}) { f[0] = *p++; f[1] = *p++; }
    g.overlap_flag = *p++; g.clip_to_restricted_range = *p++;
    uint16_t* pl[3] = {y, u, v};
    fg::apply(g, depth, mono, ssx, ssy, is_id, w, h, pl);
}

// libyuv's ScalePlane (depth 8, uint8 samples) or ScalePlane_12 (uint16)
// with kFilterBox, as avifImageScaleWithLimit calls it on each plane:
// a packed sw x sh plane to a packed dw x dh one.
void citlab_avif_scale_plane(const void* src, int32_t sw, int32_t sh, void* dst, int32_t dw,
                             int32_t dh, int32_t depth) {
    if (depth > 8) {
        yuvscale::Scaler<uint16_t>{static_cast<const uint16_t*>(src), sw, sh, sw,
                                   static_cast<uint16_t*>(dst), dw, dh, dw, false}.run();
    } else {
        yuvscale::Scaler<uint8_t>{static_cast<const uint8_t*>(src), sw, sh, sw,
                                  static_cast<uint8_t*>(dst), dw, dh, dw, true}.run();
    }
}

// Decodes an AV1 bitstream (the OBUs of an AVIF item). info[0..25]: width,
// height, monochrome, ss_x, ss_y, bit depth, matrix, range, primaries,
// transfer, then allow_intrabc and the number of blocks that used IntraBC,
// palette, filter intra and CfL, whether the frame was deblocked, the coded
// (downscaled) width, the superres denominator (8: none), the number of
// 8 x 8 blocks CDEF filtered, of Wiener and of self-guided restoration
// units, and the frame's restoration type of each plane (2 bits each, plane
// 0 lowest: 0 none, 1 Wiener, 2 self-guided, 3 switchable), then the film
// grain: whether it changed the frame, the luma points, the chroma points
// (Cb | Cr << 4) and ar_coeff_lag | overlap << 2 | chroma_scaling_from_luma
// << 3 | clip_to_restricted_range << 4, then the offset and length in data
// of the last sequence header payload parsed (-1, 0: none). carry (null, or
// carry_len bytes): a sequence header payload that holds until the data
// brings its own, as a dav1d instance keeps it from the item it decoded
// before. The frame is
// decoded, and its planes written where the pointers are not null, only
// where it is cap_w x cap_h (the item's ispe): y (w*h)
// and, unless monochrome, u and v (((w+ss_x)>>ss_x) * ((h+ss_y)>>ss_y)
// each, at most w*h), one byte a sample at 8 bits and two (uint16) above;
// otherwise only the headers are read and info[0..10] filled. 0 on
// success, -1 with a message in err.
int citlab_av1_decode(const uint8_t* data, int64_t size, int32_t* info, void* y, void* u,
                      void* v, int32_t cap_w, int32_t cap_h, char* err, int32_t errlen,
                      const uint8_t* carry, int64_t carry_len) {
    try {
        Result r;
        decode_obus(data, size_t(size), r, cap_w, cap_h, carry, size_t(carry_len));
        int vals[28] = {r.w, r.h, r.mono, r.ssx, r.ssy, r.bit_depth, r.matrix, r.range,
                        r.primaries, r.transfer, r.allow_intrabc, r.n_intrabc, r.n_palette,
                        r.n_filter_intra, r.n_cfl, r.deblocked, r.coded_w, r.superres_denom,
                        r.n_cdef, r.n_wiener, r.n_sgrproj, r.lr_types, r.grain[0], r.grain[1],
                        r.grain[2], r.grain[3], r.seq_off, r.seq_len};
        for (int i = 0; i < 28; i++) info[i] = vals[i];
        if (r.w != cap_w || r.h != cap_h) return 0;
        void* dst[3] = {y, u, v};
        for (int p = 0; p < (r.mono ? 1 : 3); p++) {
            if (!dst[p]) continue;
            if (r.bit_depth > 8) copy_plane<uint16_t>(r.planes[p], dst[p]);
            else copy_plane<uint8_t>(r.planes[p], dst[p]);
        }
        return 0;
    } catch (const std::exception& e) {
        snprintf(err, size_t(errlen), "%s", e.what());
        return -1;
    }
}

// libavif 1.3.0's avifImageYUVToRGB to 8-bit RGB as PIL's decoder calls it
// (AVIF_CHROMA_UPSAMPLING_AUTOMATIC), through libyuv where libavif finds
// libyuv constants: libyuv's fixed-point conversion with the 6-bit
// coefficients of kYuv<...>Constants (yg, yb, ub, ug, vg, vr in coef).
// Planes are uint8 at depth 8, uint16 above; u == nullptr is monochrome
// (I400: the chroma terms vanish). mode 0: the samples shifted to 8 bits
// first (libyuv's Convert16To8Plane, as libavif does for 3-byte RGB), then
// libyuv's bilinear 2x chroma upsampling (3:1 taps, the first output the
// first sample, horizontally the last output the sample (w - 1) / 2) and the
// 8-bit conversion; mode 1: the upsampling at the samples' depth, then
// libyuv's 10/12-bit conversion (I010/I210/I410ToARGBMatrixFilter: luma
// widened to 16 bits by repeating its top bits, chroma shifted to 8 bits);
// mode 2: as 1 with each chroma sample repeated (I012ToARGBMatrix).
// rgb: h x w x 3.
void citlab_yuv_to_rgb(const void* y, const void* u, const void* v, int32_t w, int32_t h,
                       int32_t ssx, int32_t ssy, int32_t depth, int32_t mode, const int32_t* coef,
                       uint8_t* rgb) {
    int cw = (w + ssx) >> ssx, ch = (h + ssy) >> ssy;
    int yg = coef[0], yb = coef[1], ub = coef[2], ug = coef[3], vg = coef[4], vr = coef[5];
    int sh = depth - 8;
    auto sample = [&](const void* p, size_t i) -> int {
        int x = depth > 8 ? static_cast<const uint16_t*>(p)[i] : static_cast<const uint8_t*>(p)[i];
        return mode == 0 ? std::min(255, x >> sh) : x;
    };
    int out_sh = mode == 0 ? 0 : sh;                     // chroma to 8 bits after upsampling
    bool nearest = mode == 2;
    // per output column: the two chroma columns and the weight of the first
    std::vector<int> xa(w), xb(w), xw(w);
    for (int j = 0; j < w; j++) {
        if (!ssx || nearest) { xa[j] = xb[j] = j >> ssx; xw[j] = 4; continue; }
        int k = j == 0 ? 0 : (j - 1) >> 1;
        xa[j] = k; xb[j] = std::min(k + 1, cw - 1);
        xw[j] = (j % 2 == 1 || j == 0) ? 3 : 1;
        if (j == 0) xb[j] = 0;
        if (j == w - 1) xa[j] = xb[j] = (w - 1) / 2;
    }
    std::vector<int> hu0(w), hv0(w), hu1(w), hv1(w);
    auto hrow = [&](int r, std::vector<int>& ou, std::vector<int>& ov) {
        size_t base = size_t(r) * cw;
        for (int j = 0; j < w; j++) {
            ou[j] = sample(u, base + xa[j]) * xw[j] + sample(u, base + xb[j]) * (4 - xw[j]);
            ov[j] = sample(v, base + xa[j]) * xw[j] + sample(v, base + xb[j]) * (4 - xw[j]);
        }
    };
    for (int i = 0; i < h; i++) {
        int ra = 0, rb = 0, rw = 4;
        if (!ssy || nearest) { ra = rb = i >> ssy; }
        else {
            int k = i == 0 ? 0 : (i - 1) >> 1;
            ra = k; rb = std::min(k + 1, ch - 1);
            rw = (i % 2 == 1 || i == 0) ? 3 : 1;
            if (i == 0) rb = 0;
        }
        if (u) { hrow(ra, hu0, hv0); hrow(rb, hu1, hv1); }
        uint8_t* out = rgb + size_t(i) * w * 3;
        for (int j = 0; j < w; j++) {
            int du = 0, dv = 0;
            if (u) {
                int uu = (hu0[j] * rw + hu1[j] * (4 - rw) + 8) >> 4;
                int vv = (hv0[j] * rw + hv1[j] * (4 - rw) + 8) >> 4;
                du = std::min(255, uu >> out_sh) - 128;
                dv = std::min(255, vv >> out_sh) - 128;
            }
            uint32_t yy = uint32_t(sample(y, size_t(i) * w + j)), y32;
            if (mode == 0 || depth == 8) y32 = yy * 0x0101u;
            else y32 = (yy << (16 - depth)) | (yy >> (2 * depth - 16));
            int y1 = int((y32 * uint32_t(yg)) >> 16) + yb;
            out[3 * j] = uint8_t(clip3(0, 255, (y1 + vr * dv) >> 6));
            out[3 * j + 1] = uint8_t(clip3(0, 255, (y1 - ug * du - vg * dv) >> 6));
            out[3 * j + 2] = uint8_t(clip3(0, 255, (y1 + ub * du) >> 6));
        }
    }
}

// libavif's Kr and Kb of matrix coefficients 12 (chromaticity-derived
// non-constant luminance), from the colour primaries' float table as
// avifColorPrimariesGetValues gives it (BT.709's for unknown primaries),
// in libavif's float arithmetic (H.273 equations 32 to 37). kr_kb: 2 floats.
void citlab_avif_derived_kr_kb(int32_t primaries, float* kr_kb) {
    static const struct { int id; float p[8]; } table[] = {
        {1, {0.64f, 0.33f, 0.30f, 0.60f, 0.15f, 0.06f, 0.3127f, 0.3290f}},
        {4, {0.67f, 0.33f, 0.21f, 0.71f, 0.14f, 0.08f, 0.310f, 0.316f}},
        {5, {0.64f, 0.33f, 0.29f, 0.60f, 0.15f, 0.06f, 0.3127f, 0.3290f}},
        {6, {0.630f, 0.340f, 0.310f, 0.595f, 0.155f, 0.070f, 0.3127f, 0.3290f}},
        {7, {0.630f, 0.340f, 0.310f, 0.595f, 0.155f, 0.070f, 0.3127f, 0.3290f}},
        {8, {0.681f, 0.319f, 0.243f, 0.692f, 0.145f, 0.049f, 0.310f, 0.316f}},
        {9, {0.708f, 0.292f, 0.170f, 0.797f, 0.131f, 0.046f, 0.3127f, 0.3290f}},
        {10, {1.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.3333f, 0.3333f}},
        {11, {0.680f, 0.320f, 0.265f, 0.690f, 0.150f, 0.060f, 0.314f, 0.351f}},
        {12, {0.680f, 0.320f, 0.265f, 0.690f, 0.150f, 0.060f, 0.3127f, 0.3290f}},
        {22, {0.630f, 0.340f, 0.295f, 0.605f, 0.155f, 0.077f, 0.3127f, 0.3290f}}};
    const float* p = table[0].p;
    for (const auto& t : table)
        if (t.id == primaries) p = t.p;
    const float rX = p[0], rY = p[1], gX = p[2], gY = p[3], bX = p[4], bY = p[5], wX = p[6],
                wY = p[7];
    const float rZ = 1.0f - (rX + rY), gZ = 1.0f - (gX + gY), bZ = 1.0f - (bX + bY),
                wZ = 1.0f - (wX + wY);
    const float den = wY * (rX * (gY * bZ - bY * gZ) + gX * (bY * rZ - rY * bZ) +
                            bX * (rY * gZ - gY * rZ));
    kr_kb[0] = (rY * (wX * (gY * bZ - bY * gZ) + wY * (bX * gZ - gX * bZ) +
                      wZ * (gX * bY - bX * gY))) / den;
    kr_kb[1] = (bY * (wX * (rY * gZ - gY * rZ) + wY * (gX * rZ - rX * gZ) +
                      wZ * (rX * gY - gX * rY))) / den;
}

// libavif's own conversion (avifImageYUVAnyToRGBAnySlow and its 4:4:4 and
// 4:0:0 fast paths, which compute the same): each sample through the unorm
// float tables of its range, chroma bilinear (9/16, 3/16, 3/16, 1/16 of the
// nearest, the adjacent column, the adjacent row and the diagonal sample;
// 4:2:2 vertically not at all), then kind 0 the Kr / Kb matrix, 1 the
// identity (G = Y, B = U, R = V), 2 YCgCo, 3 YCgCo-Re; each channel clamped to [0, 1]
// and stored as (uint8)(0.5 + 255 x). Planes as in citlab_yuv_to_rgb; the
// float arithmetic is libavif's, operation by operation (built with
// -ffp-contract=off).
void citlab_yuv_to_rgb_float(const void* y, const void* u, const void* v, int32_t w, int32_t h,
                             int32_t ssx, int32_t ssy, int32_t depth, int32_t full, int32_t kind,
                             float kr, float kb, const void* alpha, uint8_t* rgb) {
    const int maxc = (1 << depth) - 1;
    const float bias_y = full ? 0.0f : float(16 << (depth - 8));
    const float range_y = full ? float(maxc) : float(219 << (depth - 8));
    const float bias_uv = float(1 << (depth - 1));
    const float range_uv = full ? float(maxc) : float(224 << (depth - 8));
    std::vector<float> tab_y(size_t(maxc) + 1), tab_uv(size_t(maxc) + 1);
    for (int cp = 0; cp <= maxc; cp++) {
        tab_y[cp] = (float(cp) - bias_y) / range_y;
        tab_uv[cp] = kind == 1 ? tab_y[cp] : (float(cp) - bias_uv) / range_uv;
    }
    const float kg = 1.0f - kr - kb;
    const int cw = (w + ssx) >> ssx;
    auto at = [&](const void* p, size_t i) -> int {
        int x = depth > 8 ? static_cast<const uint16_t*>(p)[i] : static_cast<const uint8_t*>(p)[i];
        return std::min(x, maxc);
    };
    const bool sub = ssx || ssy;
    for (int j = 0; j < h; j++) {
        uint8_t* out = rgb + size_t(j) * w * 3;
        const int uvj = j >> ssy;
        int adj_row = 0;
        if (!(j == 0 || (j == h - 1 && j % 2 != 0) || (ssx && !ssy)))
            adj_row = j % 2 != 0 ? cw : -cw;
        for (int i = 0; i < w; i++) {
            const float Y = tab_y[at(y, size_t(j) * w + i)];
            float R, G, B;
            if (!u) {
                R = G = B = Y;
            } else {
                const int uvi = i >> ssx;
                const size_t c0 = size_t(uvj) * cw + uvi;
                float Cb, Cr;
                if (!sub) {
                    Cb = tab_uv[at(u, c0)];
                    Cr = tab_uv[at(v, c0)];
                } else {
                    int adj_col = 0;
                    if (!(i == 0 || (i == w - 1 && i % 2 != 0))) adj_col = i % 2 != 0 ? 1 : -1;
                    const size_t c10 = c0 + adj_col, c01 = c0 + adj_row;
                    const size_t c11 = c0 + adj_col + adj_row;
                    auto bilinear = [&](const void* p) {
                        return (tab_uv[at(p, c0)] * (9.0f / 16.0f)) +
                               (tab_uv[at(p, c10)] * (3.0f / 16.0f)) +
                               (tab_uv[at(p, c01)] * (3.0f / 16.0f)) +
                               (tab_uv[at(p, c11)] * (1.0f / 16.0f));
                    };
                    Cb = bilinear(u);
                    Cr = bilinear(v);
                }
                if (kind == 1) {
                    G = Y; B = Cb; R = Cr;
                } else if (kind == 3) {
                    // YCgCo-Re (H.273 equations 62 to 65): 10-bit YUV to 8-bit RGB
                    const int yy = at(y, size_t(j) * w + i);
                    const int cg = int(std::floor(Cb * float(maxc) + 0.5f));
                    const int co = int(std::floor(Cr * float(maxc) + 0.5f));
                    const int t = yy - (cg >> 1);
                    const int g = clip3(0, 255, t + cg), b = clip3(0, 255, t - (co >> 1));
                    G = float(g) / 255.0f;
                    B = float(b) / 255.0f;
                    R = float(clip3(0, 255, b + co)) / 255.0f;
                } else if (kind == 2) {
                    const float t = Y - Cb;
                    G = Y + Cb; B = t - Cr; R = t + Cr;
                } else {
                    R = Y + (2 * (1 - kr)) * Cr;
                    B = Y + (2 * (1 - kb)) * Cb;
                    G = Y - ((2 * ((kr * (1 - kr) * Cr) + (kb * (1 - kb) * Cb))) / kg);
                }
            }
            float c[3] = {R, G, B};
            for (int k = 0; k < 3; k++) c[k] = c[k] < 0.0f ? 0.0f : (c[k] > 1.0f ? 1.0f : c[k]);
            if (alpha) {
                // libavif's slow path divides by a premultiplying alpha here
                const float A = float(at(alpha, size_t(j) * w + i)) / float(maxc);
                for (int k = 0; k < 3; k++) {
                    if (A == 0.0f) c[k] = 0.0f;
                    else if (A < 1.0f) c[k] = std::min(c[k] / A, 1.0f);
                }
            }
            for (int k = 0; k < 3; k++) out[3 * i + k] = uint8_t(0.5f + (c[k] * 255.0f));
        }
    }
}

}  // extern "C"
