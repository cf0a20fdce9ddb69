// Host decoder of the block-compressed texture formats BC1-BC7 (S3TC / DXT1,
// DXT3, DXT5, RGTC, BPTC), as PIL 12.1 decodes them for DDS and FTEX
// (libImaging/BcnDecode.c) and as its BLP plugin decodes DXT1 / DXT3 / DXT5
// in Python (BlpImagePlugin.decode_dxt*), written from the formats'
// specifications and held to PIL's pixels by tests/test_torch_formats_textures.py
// and scripts/fuzz_textures.py:
//
//   BC1  two 5:6:5 endpoints widened by bit replication and two colours
//        between them (integer thirds), or, where c0 <= c1, their mean and
//        transparent black
//   BC2  BC1's colours (always four) and 4-bit alpha widened to 8 bits
//   BC3  BC1's colours and an interpolated alpha channel: 8 values (sevenths)
//        or, where a0 <= a1, 6 (fifths) with 0 and 255
//   BC4  one such channel (grey)
//   BC5  two such channels (red, green; blue 0), signed in BC5S: each
//        endpoint plus 128, and blue 128
//   BC6H HDR colour, 14 modes of one or two subsets, endpoints delta-coded
//        and sign-extended (PIL: the sums of a signed block's deltas are
//        not extended again), unquantized and interpolated in 16 bits, then
//        taken as half floats, clamped to [0, 1] and scaled to 8 bits
//   BC7  8 modes of one to three subsets, partition tables, per-endpoint
//        and per-subset p-bits, separate alpha indices with the index
//        selection bit, and the channel rotation
//
// Blocks come in rows of ceil(width / 4); a block past the image's right or
// bottom edge writes only its pixels inside. Every read is bounds-checked;
// data that ends before the last block is a truncated file (PIL: "image
// file is truncated"), and nothing is returned then. The tables below are
// the BC6H and BC7 specifications' (D3D11 functional specification, BC6H
// header layouts and BC7 partition and anchor tables).
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// BC7 partitions of two subsets: bit n is the subset of pixel n
const uint16_t kPart2[64] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80,
    0xc800, 0xffec, 0xfe80, 0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000,
    0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310, 0x3100, 0x8cce,
    0x088c, 0x3110, 0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c,
    0xaaaa, 0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696, 0xa55a,
    0x73ce, 0x13c8, 0x324c, 0x3bdc, 0x6996, 0xc33c, 0x9966, 0x0660,
    0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c, 0x39c6, 0x639c,
    0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22,
};

// BC7 partitions of three subsets: bits 2n and 2n + 1 are the subset of pixel n
const uint32_t kPart3[64] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050,
    0x5555a0a0, 0x5a5a5050, 0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090,
    0x94949494, 0xa4a4a4a4, 0xa9a59450, 0x2a0a4250, 0xa5945040, 0x0a425054,
    0xa5a5a500, 0x55a0a0a0, 0xa8a85454, 0x6a6a4040, 0xa4a45000, 0x1a1a0500,
    0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400, 0xa08585a0, 0xaa821414,
    0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050, 0x24242424,
    0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50, 0x500aa550, 0xaaaa4444,
    0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600,
    0xaa444444, 0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580,
    0xaa141414, 0x96960000, 0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000,
    0x40804080, 0xa9a8a9a8, 0xaaaaaa44, 0x2a4a5254,
};

// anchor pixels: of the second subset of two, of the second and the third
// subset of three (their index has one bit less)
const uint8_t kAnchor2[64] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 2, 8, 2, 2, 8, 8, 15, 2, 8, 2, 2, 8, 8, 2, 2,
    15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6,
    6, 2, 6, 8, 15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15,
};

const uint8_t kAnchor3b[64] = {
    3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3,
    3, 3, 8, 15, 3, 3, 6, 10, 5, 8, 8, 6, 8, 5, 15, 15,
    8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5, 15, 15, 15, 15,
    3, 15, 5, 5, 5, 8, 5, 10, 5, 10, 8, 13, 15, 12, 3, 3,
};

const uint8_t kAnchor3c[64] = {
    15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8,
    15, 8, 15, 3, 15, 8, 15, 8, 3, 15, 6, 10, 15, 15, 10, 8,
    15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15, 3, 6, 6, 8,
    15, 3, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3, 15, 15, 8,
};

// BC6H: for each of the 14 modes, where each header bit after the mode
// goes: (endpoint value << 4) | bit, endpoint values r0 g0 b0 r1 g1 b1 r2
// g2 b2 r3 g3 b3 (the bits of the two-subset modes' 72 or 75, the
// one-subset modes' 60)
const uint8_t kBc6Bits[14][75] = {
    {116, 132, 180, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21,
     22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52,
     164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83,
     84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179},
    {117, 164, 165, 0, 1, 2, 3, 4, 5, 6, 176, 177, 132, 16, 17, 18, 19, 20, 21,
     22, 133, 178, 116, 32, 33, 34, 35, 36, 37, 38, 179, 181, 180, 48, 49, 50, 51, 52,
     53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163, 80, 81, 82, 83,
     84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145, 146, 147, 148, 149},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24,
     25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 10, 112, 113,
     114, 115, 64, 65, 66, 67, 26, 176, 160, 161, 162, 163, 80, 81, 82, 83, 42, 177, 128,
     129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24,
     25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 10, 164, 112, 113,
     114, 115, 64, 65, 66, 67, 68, 26, 160, 161, 162, 163, 80, 81, 82, 83, 42, 177, 128,
     129, 130, 131, 96, 97, 98, 99, 176, 178, 144, 145, 146, 147, 116, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24,
     25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 10, 132, 112, 113,
     114, 115, 64, 65, 66, 67, 26, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 42, 128,
     129, 130, 131, 96, 97, 98, 99, 177, 178, 144, 145, 146, 147, 180, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 132, 16, 17, 18, 19, 20, 21, 22, 23, 24,
     116, 32, 33, 34, 35, 36, 37, 38, 39, 40, 180, 48, 49, 50, 51, 52, 164, 112, 113,
     114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128,
     129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 164, 132, 16, 17, 18, 19, 20, 21, 22, 23, 178,
     116, 32, 33, 34, 35, 36, 37, 38, 39, 179, 180, 48, 49, 50, 51, 52, 53, 112, 113,
     114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128,
     129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145, 146, 147, 148, 149, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 176, 132, 16, 17, 18, 19, 20, 21, 22, 23, 117,
     116, 32, 33, 34, 35, 36, 37, 38, 39, 165, 180, 48, 49, 50, 51, 52, 164, 112, 113,
     114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128,
     129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 177, 132, 16, 17, 18, 19, 20, 21, 22, 23, 133,
     116, 32, 33, 34, 35, 36, 37, 38, 39, 181, 180, 48, 49, 50, 51, 52, 164, 112, 113,
     114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 85, 128,
     129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 164, 176, 177, 132, 16, 17, 18, 19, 20, 21, 117, 133, 178,
     116, 32, 33, 34, 35, 36, 37, 165, 179, 181, 180, 48, 49, 50, 51, 52, 53, 112, 113,
     114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163, 80, 81, 82, 83, 84, 85, 128,
     129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145, 146, 147, 148, 149, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24,
     25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55,
     56, 57, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 80, 81, 82, 83, 84, 85, 86,
     87, 88, 89, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24,
     25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55,
     56, 10, 64, 65, 66, 67, 68, 69, 70, 71, 72, 26, 80, 81, 82, 83, 84, 85, 86,
     87, 88, 42, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24,
     25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55,
     11, 10, 64, 65, 66, 67, 68, 69, 70, 71, 27, 26, 80, 81, 82, 83, 84, 85, 86,
     87, 43, 42, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24,
     25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 15, 14, 13, 12,
     11, 10, 64, 65, 66, 67, 31, 30, 29, 28, 27, 26, 80, 81, 82, 83, 47, 46, 45,
     44, 43, 42, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
};

const uint8_t kW2[4] = {0, 21, 43, 64};
const uint8_t kW3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const uint8_t kW4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

const uint8_t* weights(int bits) { return bits == 2 ? kW2 : bits == 3 ? kW3 : kW4; }

struct Rgba {
    uint8_t r, g, b, a;
};

inline int get_bit(const uint8_t* s, int bit) { return (s[bit >> 3] >> (bit & 7)) & 1; }

// up to 8 bits from bit `bit` on, least significant first (a read that
// passes the block's last byte sees 0)
inline int get_bits(const uint8_t* s, int bit, int count) {
    if (!count) return 0;
    const int by = bit >> 3;
    bit &= 7;
    int x = s[by];
    if (bit + count > 8 && by + 1 < 16) x |= s[by + 1] << 8;
    return (x >> bit) & ((1 << count) - 1);
}

Rgba rgb565(uint16_t x) {
    Rgba c;
    int r = (x & 0xf800) >> 8, g = (x & 0x7e0) >> 3, b = (x & 0x1f) << 3;
    c.r = (uint8_t)(r | r >> 5);
    c.g = (uint8_t)(g | g >> 6);
    c.b = (uint8_t)(b | b >> 5);
    c.a = 255;
    return c;
}

// the colour half of BC1, BC2 and BC3 (the last two always in four colours)
void bc1_colours(Rgba* out, const uint8_t* s, bool four) {
    const uint16_t c0 = (uint16_t)(s[0] | s[1] << 8), c1 = (uint16_t)(s[2] | s[3] << 8);
    const uint32_t lut = (uint32_t)s[4] | (uint32_t)s[5] << 8 | (uint32_t)s[6] << 16 |
                         (uint32_t)s[7] << 24;
    Rgba p[4];
    p[0] = rgb565(c0);
    p[1] = rgb565(c1);
    const int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b, r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
    if (c0 > c1 || four) {
        p[2] = {(uint8_t)((2 * r0 + r1) / 3), (uint8_t)((2 * g0 + g1) / 3),
                (uint8_t)((2 * b0 + b1) / 3), 255};
        p[3] = {(uint8_t)((r0 + 2 * r1) / 3), (uint8_t)((g0 + 2 * g1) / 3),
                (uint8_t)((b0 + 2 * b1) / 3), 255};
    } else {
        p[2] = {(uint8_t)((r0 + r1) / 2), (uint8_t)((g0 + g1) / 2), (uint8_t)((b0 + b1) / 2), 255};
        p[3] = {0, 0, 0, 0};
    }
    for (int i = 0; i < 16; ++i) out[i] = p[(lut >> (2 * i)) & 3];
}

// an interpolated channel (BC3 alpha, BC4, BC5) into byte `at` of each of
// the 16 pixels `stride` bytes apart
void bc3_channel(uint8_t* out, int stride, int at, const uint8_t* s, bool sign) {
    int a0 = s[0], a1 = s[1];
    if (sign) {
        a0 = (int8_t)s[0] + 128;
        a1 = (int8_t)s[1] + 128;
    }
    const uint32_t lut1 = (uint32_t)s[2] | (uint32_t)s[3] << 8 | (uint32_t)s[4] << 16;
    const uint32_t lut2 = (uint32_t)s[5] | (uint32_t)s[6] << 8 | (uint32_t)s[7] << 16;
    uint8_t a[8];
    a[0] = (uint8_t)a0;
    a[1] = (uint8_t)a1;
    if (a0 > a1) {
        for (int k = 1; k <= 6; ++k) a[k + 1] = (uint8_t)(((7 - k) * a0 + k * a1) / 7);
    } else {
        for (int k = 1; k <= 4; ++k) a[k + 1] = (uint8_t)(((5 - k) * a0 + k * a1) / 5);
        a[6] = 0;
        a[7] = 255;
    }
    for (int i = 0; i < 8; ++i) out[stride * i + at] = a[(lut1 >> (3 * i)) & 7];
    for (int i = 0; i < 8; ++i) out[stride * (8 + i) + at] = a[(lut2 >> (3 * i)) & 7];
}

int subset_of(int ns, int partition, int i) {
    if (ns == 2) return (kPart2[partition] >> i) & 1;
    if (ns == 3) return (kPart3[partition] >> (2 * i)) & 3;
    return 0;
}

// ---- BC7
struct Bc7Mode {
    uint8_t ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};
const Bc7Mode kBc7[8] = {{3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
                         {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
                         {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
                         {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

inline uint8_t widen(uint8_t v, int bits) {
    v = (uint8_t)(v << (8 - bits));
    return (uint8_t)(v | (v >> bits));
}

void bc7_block(Rgba* col, const uint8_t* s) {
    int bit = 0;
    if (!s[0]) {        // no mode bit: opaque black
        for (int i = 0; i < 16; ++i) col[i] = {0, 0, 0, 255};
        return;
    }
    while (!(s[0] & (1 << bit))) ++bit;
    const Bc7Mode& m = kBc7[bit];
    ++bit;
    int cb = m.cb, ab = m.ab;
    const uint8_t* cw = weights(m.ib);
    const uint8_t* aw = weights(ab && m.ib2 ? m.ib2 : m.ib);
    auto load = [&](int count) {
        int v = get_bits(s, bit, count);
        bit += count;
        return v;
    };
    const int partition = load(m.pb), rotation = load(m.rb), index_sel = load(m.isb);
    const int numep = m.ns * 2;
    Rgba ep[6];
    for (int i = 0; i < numep; ++i) ep[i].r = (uint8_t)load(cb);
    for (int i = 0; i < numep; ++i) ep[i].g = (uint8_t)load(cb);
    for (int i = 0; i < numep; ++i) ep[i].b = (uint8_t)load(cb);
    for (int i = 0; i < numep; ++i) ep[i].a = ab ? (uint8_t)load(ab) : 255;
    auto pbit = [&](Rgba& e, int v, bool alpha) {
        e.r = (uint8_t)(e.r << 1 | v);
        e.g = (uint8_t)(e.g << 1 | v);
        e.b = (uint8_t)(e.b << 1 | v);
        if (alpha) e.a = (uint8_t)(e.a << 1 | v);
    };
    if (m.epb) {        // one p-bit per endpoint
        ++cb;
        if (ab) ++ab;
        for (int i = 0; i < numep; ++i) pbit(ep[i], load(1), ab != 0);
    }
    if (m.spb) {        // one p-bit per subset
        ++cb;
        if (ab) ++ab;
        for (int i = 0; i < numep; i += 2) {
            const int v = load(1);
            pbit(ep[i], v, ab != 0);
            pbit(ep[i + 1], v, ab != 0);
        }
    }
    for (int i = 0; i < numep; ++i) {
        ep[i].r = widen(ep[i].r, cb);
        ep[i].g = widen(ep[i].g, cb);
        ep[i].b = widen(ep[i].b, cb);
        if (ab) ep[i].a = widen(ep[i].a, ab);
    }
    int cbit = bit, abit = cbit + 16 * m.ib - m.ns;
    for (int i = 0; i < 16; ++i) {
        const int sub = subset_of(m.ns, partition, i);
        int ib = m.ib;
        if (i == 0) --ib;
        else if (m.ns == 2 && i == kAnchor2[partition]) --ib;
        else if (m.ns == 3 && ((sub == 1 && i == kAnchor3b[partition]) ||
                               (sub == 2 && i == kAnchor3c[partition])))
            --ib;
        const int i0 = get_bits(s, cbit, ib);
        cbit += ib;
        int sc, sa;
        if (ab && m.ib2) {
            const int ib2 = i == 0 ? m.ib2 - 1 : m.ib2;
            const int i1 = get_bits(s, abit, ib2);
            abit += ib2;
            sc = index_sel ? aw[i1] : cw[i0];
            sa = index_sel ? cw[i0] : aw[i1];
        } else {
            sc = sa = cw[i0];
        }
        const Rgba& e0 = ep[2 * sub];
        const Rgba& e1 = ep[2 * sub + 1];
        Rgba& c = col[i];
        c.r = (uint8_t)(((64 - sc) * e0.r + sc * e1.r + 32) >> 6);
        c.g = (uint8_t)(((64 - sc) * e0.g + sc * e1.g + 32) >> 6);
        c.b = (uint8_t)(((64 - sc) * e0.b + sc * e1.b + 32) >> 6);
        c.a = (uint8_t)(((64 - sa) * e0.a + sa * e1.a + 32) >> 6);
        uint8_t t;
        switch (rotation) {
            case 1: t = c.r; c.r = c.a; c.a = t; break;
            case 2: t = c.g; c.g = c.a; c.a = t; break;
            case 3: t = c.b; c.b = c.a; c.a = t; break;
        }
    }
}

// ---- BC6H
struct Bc6Mode {
    uint8_t ns, tr, pb, epb[4];
};
const Bc6Mode kBc6[14] = {{2, 1, 5, {10, 5, 5, 5}}, {2, 1, 5, {7, 6, 6, 6}},
                          {2, 1, 5, {11, 5, 4, 4}}, {2, 1, 5, {11, 4, 5, 4}},
                          {2, 1, 5, {11, 4, 4, 5}}, {2, 1, 5, {9, 5, 5, 5}},
                          {2, 1, 5, {8, 6, 5, 5}},  {2, 1, 5, {8, 5, 6, 5}},
                          {2, 1, 5, {8, 5, 5, 6}},  {2, 0, 5, {6, 6, 6, 6}},
                          {1, 0, 0, {10, 10, 10, 10}}, {1, 1, 0, {11, 9, 9, 9}},
                          {1, 1, 0, {12, 8, 8, 8}},  {1, 1, 0, {16, 4, 4, 4}}};

inline void sign_extend(uint16_t& v, int prec) {
    int x = v;
    if (x & (1 << (prec - 1))) x |= (int)(~0u << prec);
    v = (uint16_t)x;
}

int unquantize(uint16_t v, int bits, bool sign) {
    if (!sign) {
        int x = v;
        if (bits >= 15) return x;
        if (!x) return 0;
        if (x == (1 << bits) - 1) return 0xffff;
        return ((x << 15) + 0x4000) >> (bits - 1);
    }
    int x = (int16_t)v;
    if (bits >= 16) return x;
    bool neg = false;
    if (x < 0) {
        neg = true;
        x = -x;
    }
    if (x) x = x >= (1 << (bits - 1)) - 1 ? 0x7fff : ((x << 15) + 0x4000) >> (bits - 1);
    return neg ? -x : x;
}

float half_to_float(uint16_t h) {
    union {
        uint32_t u;
        float f;
    } o, m;
    m.u = 0x77800000;
    o.u = (uint32_t)(h & 0x7fff) << 13;
    o.f *= m.f;
    m.u = 0x47800000;
    if (o.f >= m.f) o.u |= 255u << 23;
    o.u |= (uint32_t)(h & 0x8000) << 16;
    return o.f;
}

float finalize(int v, bool sign) {
    if (sign) {
        if (v < 0) return half_to_float((uint16_t)(0x8000 | (((-v) * 31) / 32)));
        return half_to_float((uint16_t)((v * 31) / 32));
    }
    return half_to_float((uint16_t)((v * 31) / 64));
}

inline uint8_t clamp8(float x) {
    if (x < 0.0f) return 0;
    if (x > 1.0f) return 255;
    return (uint8_t)(x * 255.0f);
}

void bc6_block(Rgba* col, const uint8_t* s, bool sign) {
    int mode = s[0] & 0x1f, bit = 5, epbits = 75, ib = 3;
    if ((mode & 3) == 0 || (mode & 3) == 1) {
        mode &= 3;
        bit = 2;
    } else if ((mode & 3) == 2) {
        mode = 2 + (mode >> 2);
        epbits = 72;
    } else {
        mode = 10 + (mode >> 2);
        epbits = 60;
        ib = 4;
    }
    if (mode >= 14) {       // a reserved mode: black
        std::memset(col, 0, 16 * sizeof(Rgba));
        return;
    }
    const Bc6Mode& m = kBc6[mode];
    const uint8_t* cw = weights(ib);
    const int numep = m.ns == 2 ? 12 : 6;
    uint16_t ep[12] = {0};
    for (int i = 0; i < epbits; ++i) {
        const int di = kBc6Bits[mode][i];
        ep[di >> 4] |= (uint16_t)(get_bit(s, bit + i) << (di & 15));
    }
    bit += epbits;
    const int partition = get_bits(s, bit, m.pb);
    bit += m.pb;
    const int mask = (1 << m.epb[0]) - 1;
    if (sign)
        for (int k = 0; k < 3; ++k) sign_extend(ep[k], m.epb[0]);
    if (sign || m.tr)
        for (int i = 3; i < numep; i += 3)
            for (int k = 0; k < 3; ++k) sign_extend(ep[i + k], m.epb[1 + k]);
    // deltas added to the base endpoint, masked to its precision; PIL does
    // not sign-extend the sums of a signed block again (its output, not the
    // specification, decides)
    if (m.tr)
        for (int i = 3; i < numep; ++i) ep[i] = (uint16_t)((ep[i] + ep[i % 3]) & mask);
    int u[12];
    for (int i = 0; i < numep; ++i) u[i] = unquantize(ep[i], m.epb[0], sign);
    for (int i = 0; i < 16; ++i) {
        const int sub = subset_of(m.ns, partition, i) * 6;
        int b = ib;
        if (i == 0 || (m.ns == 2 && i == kAnchor2[partition])) --b;
        const int i0 = get_bits(s, bit, b);
        bit += b;
        const int w = cw[i0], t = 64 - w;
        const int r = (u[sub] * t + u[sub + 3] * w) >> 6;
        const int g = (u[sub + 1] * t + u[sub + 4] * w) >> 6;
        const int bl = (u[sub + 2] * t + u[sub + 5] * w) >> 6;
        col[i].r = clamp8(finalize(r, sign));
        col[i].g = clamp8(finalize(g, sign));
        col[i].b = clamp8(finalize(bl, sign));
        col[i].a = 255;
    }
}

}  // namespace

extern "C" {

// BcnDecode.c: `kind` 1-7 (BC1 ... BC7), `sign` for BC5S and BC6H signed;
// width x height pixels of 4 bytes (RGBA; RGB with the fourth byte unused
// for BC5 and BC6H), or of 1 byte for BC4. Returns the bytes the blocks
// took, or -1 where the data ends before the last block.
int64_t citlab_bcn_decode(const uint8_t* data, int64_t n, int32_t kind, int32_t sign,
                          int32_t width, int32_t height, uint8_t* out) {
    if (kind < 1 || kind > 7 || width <= 0 || height <= 0) return -3;
    const int64_t bw = (width + 3) / 4, bh = (height + 3) / 4;
    const int64_t size = (kind == 1 || kind == 4) ? 8 : 16;
    if (n < bw * bh * size) return -1;
    const int px = kind == 4 ? 1 : 4;
    Rgba col[16];
    uint8_t lum[16];
    for (int64_t by = 0; by < bh; ++by)
        for (int64_t bx = 0; bx < bw; ++bx) {
            const uint8_t* s = data + (by * bw + bx) * size;
            uint8_t* src = reinterpret_cast<uint8_t*>(col);
            switch (kind) {
                case 1: bc1_colours(col, s, false); break;
                case 2:
                    bc1_colours(col, s + 8, true);
                    for (int i = 0; i < 16; ++i) {
                        const int v = (s[i >> 1] >> (4 * (i & 1))) & 15;
                        col[i].a = (uint8_t)(v << 4 | v);
                    }
                    break;
                case 3:
                    bc1_colours(col, s + 8, true);
                    bc3_channel(src, 4, 3, s, false);
                    break;
                case 4:
                    std::memset(lum, 0, sizeof lum);
                    bc3_channel(lum, 1, 0, s, false);
                    src = lum;
                    break;
                case 5:
                    std::memset(col, sign ? 128 : 0, sizeof col);
                    bc3_channel(src, 4, 0, s, sign != 0);
                    bc3_channel(src, 4, 1, s + 8, sign != 0);
                    break;
                case 6: bc6_block(col, s, sign != 0); break;
                case 7: bc7_block(col, s); break;
            }
            for (int j = 0; j < 4; ++j) {
                const int64_t y = by * 4 + j;
                if (y >= height) break;
                for (int i = 0; i < 4; ++i) {
                    const int64_t x = bx * 4 + i;
                    if (x >= width) break;
                    std::memcpy(out + (y * width + x) * px, src + (j * 4 + i) * px, px);
                }
            }
        }
    return bw * bh * size;
}

// BlpImagePlugin.decode_dxt1 / decode_dxt3 / decode_dxt5 (kind 1, 3, 5):
// rows of ceil(width / 4) blocks, each block row giving 4 rows of
// 4 * ceil(width / 4) pixels of 3 bytes (DXT1 without alpha) or 4, in
// order; 5:6:5 endpoints widened by a shift alone, DXT3 and DXT5 in four
// colours always. Returns the bytes written, or -1 where a block row is cut
// short (PIL: "Truncated File Read").
int64_t citlab_blp_dxt_decode(const uint8_t* data, int64_t n, int32_t kind, int32_t alpha,
                              int32_t width, int32_t height, uint8_t* out) {
    if ((kind != 1 && kind != 3 && kind != 5) || width <= 0 || height <= 0) return -3;
    const int64_t bw = (width + 3) / 4, bh = (height + 3) / 4;
    const int64_t size = kind == 1 ? 8 : 16, line = bw * size;
    const int ch = kind == 1 && !alpha ? 3 : 4;
    if (n < bh * line) return -1;
    const int64_t row_px = bw * 4;
    for (int64_t by = 0; by < bh; ++by)
        for (int64_t bx = 0; bx < bw; ++bx) {
            const uint8_t* s = data + by * line + bx * size;
            const uint8_t* c = kind == 1 ? s : s + 8;
            const int c0 = c[0] | c[1] << 8, c1 = c[2] | c[3] << 8;
            const uint32_t code = (uint32_t)c[4] | (uint32_t)c[5] << 8 | (uint32_t)c[6] << 16 |
                                  (uint32_t)c[7] << 24;
            const int r0 = ((c0 >> 11) & 31) << 3, g0 = ((c0 >> 5) & 63) << 2, b0 = (c0 & 31) << 3;
            const int r1 = ((c1 >> 11) & 31) << 3, g1 = ((c1 >> 5) & 63) << 2, b1 = (c1 & 31) << 3;
            uint64_t acode = 0;
            for (int k = 0; k < 6; ++k) acode |= (uint64_t)s[2 + k] << (8 * k);
            for (int j = 0; j < 4; ++j)
                for (int i = 0; i < 4; ++i) {
                    const int k = 4 * j + i, cc = (code >> (2 * k)) & 3;
                    int r, g, b, a = 255;
                    if (cc == 0) { r = r0; g = g0; b = b0; }
                    else if (cc == 1) { r = r1; g = g1; b = b1; }
                    else if (kind == 1 && c0 <= c1) {
                        if (cc == 2) { r = (r0 + r1) / 2; g = (g0 + g1) / 2; b = (b0 + b1) / 2; }
                        else { r = g = b = a = 0; }
                    } else if (cc == 2) {
                        r = (2 * r0 + r1) / 3; g = (2 * g0 + g1) / 3; b = (2 * b0 + b1) / 3;
                    } else {
                        r = (2 * r1 + r0) / 3; g = (2 * g1 + g0) / 3; b = (2 * b1 + b0) / 3;
                    }
                    if (kind == 3) {
                        const int v = (s[k >> 1] >> (4 * (i & 1))) & 15;
                        a = v * 17;
                    } else if (kind == 5) {
                        const int a0 = s[0], a1 = s[1], q = (int)((acode >> (3 * k)) & 7);
                        if (q == 0) a = a0;
                        else if (q == 1) a = a1;
                        else if (a0 > a1) a = ((8 - q) * a0 + (q - 1) * a1) / 7;
                        else if (q == 6) a = 0;
                        else if (q == 7) a = 255;
                        else a = ((6 - q) * a0 + (q - 1) * a1) / 5;
                    }
                    uint8_t* o = out + ((by * 4 + j) * row_px + bx * 4 + i) * ch;
                    o[0] = (uint8_t)r;
                    o[1] = (uint8_t)g;
                    o[2] = (uint8_t)b;
                    if (ch == 4) o[3] = (uint8_t)a;
                }
        }
    return bh * 4 * row_px * ch;
}

}  // extern "C"
