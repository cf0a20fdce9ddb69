// WebP decoder of the port: every file that PIL 12.1 opens (through libwebp
// 1.6.0's WebPAnimDecoder), decoded to the same RGBA canvas, byte for byte.
//
// - Container (RIFF "WEBP"): the simple formats ("VP8 ", "VP8L") and the
//   extended one ("VP8X": ICCP / EXIF / XMP / unknown chunks skipped, an
//   ALPH chunk before a VP8 frame, animations: ANIM and the first ANMF, at
//   its offset on a zero canvas). The checks are libwebp's demuxer's and
//   WebPGetFeatures's, so that a file PIL refuses is refused here.
// - VP8 key frames (RFC 6386): the boolean decoder with libwebp's 56-bit
//   window (its end-of-data rule included), segments, both loop filters,
//   1-8 token partitions, dequantisation, intra prediction with libwebp's
//   edge samples, the inverse WHT and DCT; then libwebp's "fancy" 4:2:0
//   upsampler and its 14-bit fixed-point Y'CbCr -> RGB conversion.
// - ALPH: raw or VP8L-compressed alpha, filter methods 0-3 undone.
// - VP8L (RFC 9649): prefix codes (simple and normal), the meta prefix
//   image, the colour cache, LZ77 references through the distance map, the
//   predictor, cross-colour, subtract-green and colour-indexing transforms.
//
// Every read is bounds-checked and every malformed stream fails with a
// message: a caller never sees a partial image.
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

struct Fail {
  std::string msg;
};

[[noreturn]] void fail(const char* fmt, ...) __attribute__((format(printf, 1, 2)));
[[noreturn]] void fail(const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof(buf), fmt, ap);
  va_end(ap);
  throw Fail{std::string("WebP: ") + buf};
}

inline uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t le24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }
inline uint32_t le32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24);
}
inline bool tag_is(const uint8_t* p, const char* t) { return memcmp(p, t, 4) == 0; }
// a chunk tag for a message: printable ASCII, anything else as '?'
std::string tag_str(const uint8_t* p) {
  std::string s(4, '?');
  for (int i = 0; i < 4; ++i)
    if (p[i] >= 0x20 && p[i] < 0x7f) s[i] = (char)p[i];
  return s;
}

constexpr uint32_t kMaxChunkPayload = ~0u - 8 - 1;
constexpr uint64_t kMaxImageArea = 1ull << 32;

// VP8X feature flags
constexpr uint32_t kAnimationFlag = 0x02, kXmpFlag = 0x04, kExifFlag = 0x08,
                   kAlphaFlag = 0x10, kIccpFlag = 0x20;
constexpr uint32_t kAllValidFlags =
    kAlphaFlag | kAnimationFlag | kIccpFlag | kExifFlag | kXmpFlag;

// ------------------------------------------------------------------ tables
static const uint8_t kBModesProba[10 * 10 * 9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};
static const uint8_t kCoeffsUpdateProba[4 * 8 * 3 * 11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
static const uint8_t kCoeffsProba0[4 * 8 * 3 * 11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
static const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

const uint8_t kDcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  10,  11,  12,  13,  14,  15,  16,  17,  17,
    18,  19,  20,  20,  21,  21,  22,  22,  23,  23,  24,  25,  25,  26,  27,  28,
    29,  30,  31,  32,  33,  34,  35,  36,  37,  37,  38,  39,  40,  41,  42,  43,
    44,  45,  46,  46,  47,  48,  49,  50,  51,  52,  53,  54,  55,  56,  57,  58,
    59,  60,  61,  62,  63,  64,  65,  66,  67,  68,  69,  70,  71,  72,  73,  74,
    75,  76,  76,  77,  78,  79,  80,  81,  82,  83,  84,  85,  86,  87,  88,  89,
    91,  93,  95,  96,  98,  100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157};
const uint16_t kAcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  11,  12,  13,  14,  15,  16,  17,  18,  19,
    20,  21,  22,  23,  24,  25,  26,  27,  28,  29,  30,  31,  32,  33,  34,  35,
    36,  37,  38,  39,  40,  41,  42,  43,  44,  45,  46,  47,  48,  49,  50,  51,
    52,  53,  54,  55,  56,  57,  58,  60,  62,  64,  66,  68,  70,  72,  74,  76,
    78,  80,  82,  84,  86,  88,  90,  92,  94,  96,  98,  100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284};

// ------------------------------------------------------------------ VP8

// libwebp's boolean decoder on a 64-bit host (56 bits loaded at a time):
// the point at which it flags the end of the data decides which damaged
// streams fail, so it is copied as it is.
struct BoolDecoder {
  uint64_t value = 0;
  uint32_t range = 255 - 1;  // range minus one, in [127, 254]
  int bits = -8;             // bits left beyond the 8-bit window
  const uint8_t* buf = nullptr;
  const uint8_t* buf_end = nullptr;
  const uint8_t* buf_max = nullptr;
  int eof = 0;

  void init(const uint8_t* start, size_t size) {
    range = 255 - 1;
    value = 0;
    bits = -8;
    eof = 0;
    buf = start;
    buf_end = start + size;
    buf_max = size >= 8 ? start + size - 8 + 1 : start;
    load_new_bytes();
  }
  void load_final_bytes() {
    if (buf < buf_end) {
      bits += 8;
      value = (uint64_t)(*buf++) | (value << 8);
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = 1;
    } else {
      bits = 0;
    }
  }
  void load_new_bytes() {
    if (buf < buf_max) {
      uint64_t in;
      memcpy(&in, buf, 8);
      buf += 7;
      value = (__builtin_bswap64(in) >> 8) | (value << 56);
      bits += 56;
    } else {
      load_final_bytes();
    }
  }
  int get_bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load_new_bytes();
    const int pos = bits;
    const uint32_t split = (r * (uint32_t)prob) >> 8;
    const uint32_t v = (uint32_t)(value >> pos);
    const int bit = v > split;
    if (bit) {
      r -= split;
      value -= (uint64_t)(split + 1) << pos;
    } else {
      r = split + 1;
    }
    const int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  uint32_t get_value(int n) {
    uint32_t v = 0;
    while (n-- > 0) v |= (uint32_t)get_bit(0x80) << n;
    return v;
  }
  int get_signed_value(int n) {
    const int v = (int)get_value(n);
    return get_bit(0x80) ? -v : v;
  }
  int get() { return (int)get_value(1); }
};

constexpr int BPS = 32;  // stride of the reconstruction work buffer
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;

enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED,
       B_VL_PRED, B_HD_PRED, B_HU_PRED, NUM_BMODES,
       DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED, TM_PRED = B_TM_PRED,
       B_DC_PRED_NOTOP = 4, B_DC_PRED_NOLEFT = 5, B_DC_PRED_NOTOPLEFT = 6 };

inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : (uint8_t)v; }
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // [-1020, 1020]
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // [-112, 112]
inline int absi(int v) { return v < 0 ? -v : v; }

#define AVG3(a, b, c) ((uint8_t)(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) (((a) + (b) + 1) >> 1)
#define DST(x, y) dst[(x) + (y) * BPS]

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// a transform's output (eight times the residual) added to a predicted sample
inline uint8_t add_residual(uint8_t p, int v) { return clip8(p + (v >> 3)); }
inline int16_t wrap16(int v) { return (int16_t)(uint16_t)v; }
inline int16_t mulhi16(int16_t a, int k) { return (int16_t)(((int32_t)a * k) >> 16); }

// The inverse DCTs of a 4x4 block, added to its prediction, as libwebp's
// x86 build dispatches them: blocks with coefficients past the third in
// zigzag order go through its SSE2 transform, whose sums wrap in 16-bit
// lanes; blocks of three or of one coefficient through the C versions, in
// 32 bits. They agree wherever the coefficients stay in range, which only a
// damaged stream breaks.
void transform_full(const int16_t* in, uint8_t* dst) {
  // x * 35468 >> 16 is mulhi(x, 35468 - 65536) + x, and x * 85627 >> 16
  // is mulhi(x, 20091) + x
  auto cd = [](int16_t x1, int16_t x3, int16_t* c, int16_t* d) {
    *c = wrap16(wrap16(x1 - x3) + wrap16(mulhi16(x1, -30068) - mulhi16(x3, 20091)));
    *d = wrap16(wrap16(x1 + x3) + wrap16(mulhi16(x1, 20091) + mulhi16(x3, -30068)));
  };
  int16_t C[16];
  for (int i = 0; i < 4; ++i) {
    const int16_t a = wrap16(in[i] + in[8 + i]), b = wrap16(in[i] - in[8 + i]);
    int16_t c, d;
    cd(in[4 + i], in[12 + i], &c, &d);
    C[4 * i + 0] = wrap16(a + d);
    C[4 * i + 1] = wrap16(b + c);
    C[4 * i + 2] = wrap16(b - c);
    C[4 * i + 3] = wrap16(a - d);
  }
  for (int j = 0; j < 4; ++j) {
    const int16_t dc = wrap16(C[j] + 4);
    const int16_t a = wrap16(dc + C[8 + j]), b = wrap16(dc - C[8 + j]);
    int16_t c, d;
    cd(C[4 + j], C[12 + j], &c, &d);
    uint8_t* row = dst + j * BPS;
    row[0] = clip8(row[0] + (wrap16(a + d) >> 3));
    row[1] = clip8(row[1] + (wrap16(b + c) >> 3));
    row[2] = clip8(row[2] + (wrap16(b - c) >> 3));
    row[3] = clip8(row[3] + (wrap16(a - d) >> 3));
  }
}

void transform_ac3(const int16_t* in, uint8_t* dst) {
  const int a = in[0] + 4;
  const int c4 = mul2(in[4]), d4 = mul1(in[4]);
  const int c1 = mul2(in[1]), d1 = mul1(in[1]);
  const int dcs[4] = {a + d4, a + c4, a - c4, a - d4};
  for (int y = 0; y < 4; ++y) {
    uint8_t* row = dst + y * BPS;
    row[0] = add_residual(row[0], dcs[y] + d1);
    row[1] = add_residual(row[1], dcs[y] + c1);
    row[2] = add_residual(row[2], dcs[y] - c1);
    row[3] = add_residual(row[3], dcs[y] - d1);
  }
}

void transform_dc(const int16_t* in, uint8_t* dst) {
  const int dc = in[0] + 4;
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x) dst[x + y * BPS] = add_residual(dst[x + y * BPS], dc);
}

// one luma block by its 2-bit code: 3 full, 2 three coefficients, 1 DC only
void do_transform(uint32_t code, const int16_t* in, uint8_t* dst) {
  if (code == 3) transform_full(in, dst);
  else if (code == 2) transform_ac3(in, dst);
  else if (code == 1) transform_dc(in, dst);
}

// the four blocks of one chroma plane: all full if any has an AC
// coefficient, else all DC
void do_uv_transform(uint32_t bits, const int16_t* in, uint8_t* dst) {
  if (!(bits & 0xff)) return;
  for (int n = 0; n < 4; ++n) {
    uint8_t* d = dst + (n & 1) * 4 + (n >> 1) * 4 * BPS;
    if (bits & 0xaa) transform_full(in + n * 16, d);
    else transform_dc(in + n * 16, d);
  }
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

// ---- intra predictors (dst points into the work buffer)

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + l - tl);
    dst += BPS;
  }
}

void fill(uint8_t* dst, int v, int size) {
  for (int j = 0; j < size; ++j) memset(dst + j * BPS, v, size);
}

void pred_luma16(int mode, uint8_t* dst) {
  switch (mode) {
    case B_DC_PRED: {
      int dc = 16;
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      fill(dst, dc >> 5, 16);
      break;
    }
    case B_TM_PRED: true_motion(dst, 16); break;
    case B_VE_PRED:
      for (int j = 0; j < 16; ++j) memcpy(dst + j * BPS, dst - BPS, 16);
      break;
    case B_HE_PRED:
      for (int j = 0; j < 16; ++j) memset(dst + j * BPS, dst[j * BPS - 1], 16);
      break;
    case B_DC_PRED_NOTOP: {
      int dc = 8;
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS];
      fill(dst, dc >> 4, 16);
      break;
    }
    case B_DC_PRED_NOLEFT: {
      int dc = 8;
      for (int i = 0; i < 16; ++i) dc += dst[i - BPS];
      fill(dst, dc >> 4, 16);
      break;
    }
    default: fill(dst, 0x80, 16); break;
  }
}

void pred_chroma8(int mode, uint8_t* dst) {
  switch (mode) {
    case B_DC_PRED: {
      int dc = 8;
      for (int i = 0; i < 8; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, dc >> 4, 8);
      break;
    }
    case B_TM_PRED: true_motion(dst, 8); break;
    case B_VE_PRED:
      for (int j = 0; j < 8; ++j) memcpy(dst + j * BPS, dst - BPS, 8);
      break;
    case B_HE_PRED:
      for (int j = 0; j < 8; ++j) memset(dst + j * BPS, dst[j * BPS - 1], 8);
      break;
    case B_DC_PRED_NOTOP: {
      int dc = 4;
      for (int i = 0; i < 8; ++i) dc += dst[-1 + i * BPS];
      fill(dst, dc >> 3, 8);
      break;
    }
    case B_DC_PRED_NOLEFT: {
      int dc = 4;
      for (int i = 0; i < 8; ++i) dc += dst[i - BPS];
      fill(dst, dc >> 3, 8);
      break;
    }
    default: fill(dst, 0x80, 8); break;
  }
}

void pred_luma4(int mode, uint8_t* dst) {
  const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
            L = dst[-1 + 3 * BPS], X = dst[-1 - BPS];
  const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS],
            E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
  switch (mode) {
    case B_DC_PRED: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, dc >> 3, 4);
      break;
    }
    case B_TM_PRED: true_motion(dst, 4); break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {AVG3(X, A, B), AVG3(A, B, C), AVG3(B, C, D), AVG3(C, D, E)};
      for (int j = 0; j < 4; ++j) memcpy(dst + j * BPS, vals, 4);
      break;
    }
    case B_HE_PRED:
      memset(dst + 0 * BPS, AVG3(X, I, J), 4);
      memset(dst + 1 * BPS, AVG3(I, J, K), 4);
      memset(dst + 2 * BPS, AVG3(J, K, L), 4);
      memset(dst + 3 * BPS, AVG3(K, L, L), 4);
      break;
    case B_RD_PRED:
      DST(0, 3) = AVG3(J, K, L);
      DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
      DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
      DST(3, 0) = AVG3(D, C, B);
      break;
    case B_VR_PRED:
      DST(0, 0) = DST(1, 2) = AVG2(X, A);
      DST(1, 0) = DST(2, 2) = AVG2(A, B);
      DST(2, 0) = DST(3, 2) = AVG2(B, C);
      DST(3, 0) = AVG2(C, D);
      DST(0, 3) = AVG3(K, J, I);
      DST(0, 2) = AVG3(J, I, X);
      DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
      DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
      DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
      DST(3, 1) = AVG3(B, C, D);
      break;
    case B_LD_PRED:
      DST(0, 0) = AVG3(A, B, C);
      DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
      DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
      DST(3, 3) = AVG3(G, H, H);
      break;
    case B_VL_PRED:
      DST(0, 0) = AVG2(A, B);
      DST(1, 0) = DST(0, 2) = AVG2(B, C);
      DST(2, 0) = DST(1, 2) = AVG2(C, D);
      DST(3, 0) = DST(2, 2) = AVG2(D, E);
      DST(0, 1) = AVG3(A, B, C);
      DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
      DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
      DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
      DST(3, 2) = AVG3(E, F, G);
      DST(3, 3) = AVG3(F, G, H);
      break;
    case B_HD_PRED:
      DST(0, 0) = DST(2, 1) = AVG2(I, X);
      DST(0, 1) = DST(2, 2) = AVG2(J, I);
      DST(0, 2) = DST(2, 3) = AVG2(K, J);
      DST(0, 3) = AVG2(L, K);
      DST(3, 0) = AVG3(A, B, C);
      DST(2, 0) = AVG3(X, A, B);
      DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
      DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
      DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
      DST(1, 3) = AVG3(L, K, J);
      break;
    default:  // B_HU_PRED
      DST(0, 0) = AVG2(I, J);
      DST(2, 0) = DST(0, 1) = AVG2(J, K);
      DST(2, 1) = DST(0, 2) = AVG2(K, L);
      DST(1, 0) = AVG3(I, J, K);
      DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
      DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
  }
}

// ---- loop filters (libwebp's dsp/dec.c)

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return absi(p1 - p0) > thresh || absi(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * absi(p0 - q0) + absi(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * absi(p0 - q0) + absi(p1 - q1) > t) return false;
  return absi(p3 - p2) <= it && absi(p2 - p1) <= it && absi(p1 - p0) <= it &&
         absi(q3 - q2) <= it && absi(q2 - q1) <= it && absi(q1 - q0) <= it;
}

void simple_filter16(uint8_t* p, int step, int vstep, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i)
    if (needs_filter(p + i * vstep, step, thresh2)) do_filter2(p + i * vstep, step);
}

void filter_loop26(uint8_t* p, int hstride, int vstride, int size, int thresh,
                   int ithresh, int hev_thresh) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) do_filter2(p, hstride);
      else do_filter6(p, hstride);
    }
    p += vstride;
  }
}

void filter_loop24(uint8_t* p, int hstride, int vstride, int size, int thresh,
                   int ithresh, int hev_thresh) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) do_filter2(p, hstride);
      else do_filter4(p, hstride);
    }
    p += vstride;
  }
}

struct FInfo {
  int limit = 0;   // 0: no filtering
  int ilevel = 0;
  int inner = 0;
  int hev_thresh = 0;
};

struct MBData {
  int16_t coeffs[384];
  uint8_t is_i4x4;
  uint8_t imodes[16];
  uint8_t uvmode;
  uint8_t segment;
  uint8_t skip;
  uint32_t non_zero_y;
  uint32_t non_zero_uv;
};

struct QuantMatrix {
  int y1[2], y2[2], uv[2];
};

struct VP8Image {
  int width = 0, height = 0;
  std::vector<uint8_t> y, u, v;  // cropped planes: width x height, (w+1)/2 x (h+1)/2
};

class VP8Decoder {
 public:
  VP8Image decode(const uint8_t* data, size_t size);

 private:
  BoolDecoder br_;
  BoolDecoder parts_[8];
  int num_parts_minus_one_ = 0;
  int mb_w_ = 0, mb_h_ = 0;
  // segment header
  int use_segment_ = 0, update_map_ = 0, absolute_delta_ = 1;
  int8_t quantizer_[4] = {0, 0, 0, 0}, filter_strength_[4] = {0, 0, 0, 0};
  uint8_t segments_proba_[3] = {255, 255, 255};
  // filter header
  int simple_ = 0, level_ = 0, sharpness_ = 0, use_lf_delta_ = 0;
  int ref_lf_delta_[4] = {0, 0, 0, 0}, mode_lf_delta_[4] = {0, 0, 0, 0};
  int filter_type_ = 0;
  FInfo fstrengths_[4][2];
  QuantMatrix dqm_[4];
  uint8_t proba_[4][8][3][11];
  int use_skip_proba_ = 0, skip_p_ = 0;

  void parse_segment_header();
  void parse_filter_header();
  void parse_partitions(const uint8_t* buf, size_t size);
  void parse_quant();
  void parse_proba();
  void precompute_filter_strengths();
  void parse_intra_mode(uint8_t* top, uint8_t* left, MBData* block);
  int get_large_value(BoolDecoder& br, const uint8_t* p);
  int get_coeffs(BoolDecoder& br, int type, int ctx, const int* dq, int n, int16_t* out);
  int parse_residuals(BoolDecoder& br, MBData* block, uint8_t* top_nz, uint8_t* top_nz_dc,
                      uint8_t* left_nz, uint8_t* left_nz_dc);
};

void VP8Decoder::parse_segment_header() {
  use_segment_ = br_.get();
  if (use_segment_) {
    update_map_ = br_.get();
    if (br_.get()) {
      absolute_delta_ = br_.get();
      for (int s = 0; s < 4; ++s) quantizer_[s] = br_.get() ? br_.get_signed_value(7) : 0;
      for (int s = 0; s < 4; ++s)
        filter_strength_[s] = br_.get() ? br_.get_signed_value(6) : 0;
    }
    if (update_map_)
      for (int s = 0; s < 3; ++s) segments_proba_[s] = br_.get() ? br_.get_value(8) : 255u;
  } else {
    update_map_ = 0;
  }
  if (br_.eof) fail("VP8: cannot parse the segment header");
}

void VP8Decoder::parse_filter_header() {
  simple_ = br_.get();
  level_ = br_.get_value(6);
  sharpness_ = br_.get_value(3);
  use_lf_delta_ = br_.get();
  if (use_lf_delta_) {
    if (br_.get()) {
      for (int i = 0; i < 4; ++i)
        if (br_.get()) ref_lf_delta_[i] = br_.get_signed_value(6);
      for (int i = 0; i < 4; ++i)
        if (br_.get()) mode_lf_delta_[i] = br_.get_signed_value(6);
    }
  }
  filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
  if (br_.eof) fail("VP8: cannot parse the filter header");
}

void VP8Decoder::parse_partitions(const uint8_t* buf, size_t size) {
  const uint8_t* sz = buf;
  const uint8_t* buf_end = buf + size;
  num_parts_minus_one_ = (1 << br_.get_value(2)) - 1;
  const size_t last_part = num_parts_minus_one_;
  if (size < 3 * last_part) fail("VP8: truncated partition sizes");
  const uint8_t* part_start = buf + last_part * 3;
  size_t size_left = size - last_part * 3;
  for (size_t p = 0; p < last_part; ++p) {
    size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
    if (psize > size_left) psize = size_left;
    parts_[p].init(part_start, psize);
    part_start += psize;
    size_left -= psize;
    sz += 3;
  }
  parts_[last_part].init(part_start, size_left);
  if (part_start >= buf_end) fail("VP8: the last token partition is empty");
}

void VP8Decoder::parse_quant() {
  const int base_q0 = br_.get_value(7);
  const int dqy1_dc = br_.get() ? br_.get_signed_value(4) : 0;
  const int dqy2_dc = br_.get() ? br_.get_signed_value(4) : 0;
  const int dqy2_ac = br_.get() ? br_.get_signed_value(4) : 0;
  const int dquv_dc = br_.get() ? br_.get_signed_value(4) : 0;
  const int dquv_ac = br_.get() ? br_.get_signed_value(4) : 0;
  auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
  for (int i = 0; i < 4; ++i) {
    int q;
    if (use_segment_) {
      q = quantizer_[i];
      if (!absolute_delta_) q += base_q0;
    } else {
      if (i > 0) {
        dqm_[i] = dqm_[0];
        continue;
      }
      q = base_q0;
    }
    QuantMatrix& m = dqm_[i];
    m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
    m.y1[1] = kAcTable[clip(q + 0, 127)];
    m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
    // x * 155 / 100 == (x * 101581) >> 16 for every x in [0, 284]
    m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
    m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
  }
}

void VP8Decoder::parse_proba() {
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p) {
          const int i = ((t * 8 + b) * 3 + c) * 11 + p;
          proba_[t][b][c][p] = br_.get_bit(kCoeffsUpdateProba[i]) ? br_.get_value(8)
                                                                 : kCoeffsProba0[i];
        }
  use_skip_proba_ = br_.get();
  if (use_skip_proba_) skip_p_ = br_.get_value(8);
}

void VP8Decoder::precompute_filter_strengths() {
  if (filter_type_ == 0) return;
  for (int s = 0; s < 4; ++s) {
    int base_level;
    if (use_segment_) {
      base_level = filter_strength_[s];
      if (!absolute_delta_) base_level += level_;
    } else {
      base_level = level_;
    }
    for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
      FInfo& info = fstrengths_[s][i4x4];
      int level = base_level;
      if (use_lf_delta_) {
        level += ref_lf_delta_[0];
        if (i4x4) level += mode_lf_delta_[0];
      }
      level = level < 0 ? 0 : level > 63 ? 63 : level;
      if (level > 0) {
        int ilevel = level;
        if (sharpness_ > 0) {
          ilevel >>= sharpness_ > 4 ? 2 : 1;
          if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
        }
        if (ilevel < 1) ilevel = 1;
        info.ilevel = ilevel;
        info.limit = 2 * level + ilevel;
        info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
      } else {
        info.limit = 0;
      }
      info.inner = i4x4;
    }
  }
}

void VP8Decoder::parse_intra_mode(uint8_t* top, uint8_t* left, MBData* block) {
  BoolDecoder& br = br_;
  if (update_map_) {
    block->segment = !br.get_bit(segments_proba_[0]) ? br.get_bit(segments_proba_[1])
                                                     : br.get_bit(segments_proba_[2]) + 2;
  } else {
    block->segment = 0;
  }
  block->skip = use_skip_proba_ ? br.get_bit(skip_p_) : 0;
  block->is_i4x4 = !br.get_bit(145);
  if (!block->is_i4x4) {
    const int ymode = br.get_bit(156) ? (br.get_bit(128) ? TM_PRED : H_PRED)
                                      : (br.get_bit(163) ? V_PRED : DC_PRED);
    block->imodes[0] = ymode;
    memset(top, ymode, 4);
    memset(left, ymode, 4);
  } else {
    uint8_t* modes = block->imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* const prob = kBModesProba + (top[x] * 10 + ymode) * 9;
        ymode = !br.get_bit(prob[0])   ? B_DC_PRED
                : !br.get_bit(prob[1]) ? B_TM_PRED
                : !br.get_bit(prob[2]) ? B_VE_PRED
                : !br.get_bit(prob[3])
                    ? (!br.get_bit(prob[4]) ? B_HE_PRED
                                            : (!br.get_bit(prob[5]) ? B_RD_PRED : B_VR_PRED))
                    : (!br.get_bit(prob[6])
                           ? B_LD_PRED
                           : (!br.get_bit(prob[7])
                                  ? B_VL_PRED
                                  : (!br.get_bit(prob[8]) ? B_HD_PRED : B_HU_PRED)));
        top[x] = ymode;
      }
      memcpy(modes, top, 4);
      modes += 4;
      left[y] = ymode;
    }
  }
  block->uvmode = !br.get_bit(142)   ? DC_PRED
                  : !br.get_bit(114) ? V_PRED
                  : br.get_bit(183)  ? TM_PRED
                                     : H_PRED;
}

int VP8Decoder::get_large_value(BoolDecoder& br, const uint8_t* p) {
  int v;
  if (!br.get_bit(p[3])) {
    if (!br.get_bit(p[4])) v = 2;
    else v = 3 + br.get_bit(p[5]);
  } else {
    if (!br.get_bit(p[6])) {
      if (!br.get_bit(p[7])) {
        v = 5 + br.get_bit(159);
      } else {
        v = 7 + 2 * br.get_bit(165);
        v += br.get_bit(145);
      }
    } else {
      const int bit1 = br.get_bit(p[8]);
      const int bit0 = br.get_bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.get_bit(*tab);
      v += 3 + (8 << cat);
    }
  }
  return v;
}

// the tokens of one 4x4 block from position n on, dequantised into out (in
// raster order); returns the position after the last token read
int VP8Decoder::get_coeffs(BoolDecoder& br, int type, int ctx, const int* dq, int n,
                           int16_t* out) {
  const uint8_t* p = proba_[type][kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.get_bit(p[0])) return n;
    while (!br.get_bit(p[1])) {
      p = proba_[type][kBands[++n]][0];
      if (n == 16) return 16;
    }
    const uint8_t(*p_ctx)[11] = proba_[type][kBands[n + 1]];
    int v;
    if (!br.get_bit(p[2])) {
      v = 1;
      p = p_ctx[1];
    } else {
      v = get_large_value(br, p);
      p = p_ctx[2];
    }
    const int s = br.get_bit(0x80) ? -v : v;
    out[kZigzag[n]] = (int16_t)(s * dq[n > 0]);
  }
  return 16;
}

inline uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= nz > 3 ? 3 : nz > 1 ? 2 : dc_nz;
  return nz_coeffs;
}

int VP8Decoder::parse_residuals(BoolDecoder& br, MBData* block, uint8_t* top_nz,
                                uint8_t* top_nz_dc, uint8_t* left_nz, uint8_t* left_nz_dc) {
  const QuantMatrix& q = dqm_[block->segment];
  int16_t* dst = block->coeffs;
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  int first, ac_type;
  memset(dst, 0, 384 * sizeof(*dst));
  if (!block->is_i4x4) {
    int16_t dc[16] = {0};
    const int ctx = *top_nz_dc + *left_nz_dc;
    const int nz = get_coeffs(br, 1, ctx, q.y2, 0, dc);
    *top_nz_dc = *left_nz_dc = (nz > 0);
    if (nz > 1) {
      transform_wht(dc, dst);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 16 * 16; i += 16) dst[i] = (int16_t)dc0;
    }
    first = 1;
    ac_type = 0;
  } else {
    first = 0;
    ac_type = 3;
  }
  uint8_t tnz = *top_nz & 0x0f;
  uint8_t lnz = *left_nz & 0x0f;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    uint32_t nz_coeffs = 0;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + (tnz & 1);
      const int nz = get_coeffs(br, ac_type, ctx, q.y1, first, dst);
      l = (nz > first);
      tnz = (tnz >> 1) | (l << 7);
      nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
      dst += 16;
    }
    tnz >>= 4;
    lnz = (lnz >> 1) | (l << 7);
    non_zero_y = (non_zero_y << 8) | nz_coeffs;
  }
  uint32_t out_t_nz = tnz;
  uint32_t out_l_nz = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nz_coeffs = 0;
    tnz = *top_nz >> (4 + ch);
    lnz = *left_nz >> (4 + ch);
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(br, 2, ctx, q.uv, 0, dst);
        l = (nz > 0);
        tnz = (tnz >> 1) | (l << 3);
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 2;
      lnz = (lnz >> 1) | (l << 5);
    }
    non_zero_uv |= nz_coeffs << (4 * ch);
    out_t_nz |= (tnz << 4) << ch;
    out_l_nz |= (lnz & 0xf0) << ch;
  }
  *top_nz = (uint8_t)out_t_nz;
  *left_nz = (uint8_t)out_l_nz;
  block->non_zero_y = non_zero_y;
  block->non_zero_uv = non_zero_uv;
  return !(non_zero_y | non_zero_uv);
}

VP8Image VP8Decoder::decode(const uint8_t* data, size_t size) {
  // the frame tag and the key frame header (VP8GetInfo, VP8GetHeaders)
  if (size < 10) fail("VP8: truncated frame header");
  const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
  const int key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7;
  const int show = (bits >> 4) & 1;
  const uint32_t partition_length = bits >> 5;
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a)
    fail("VP8: bad start code (not a VP8 key frame)");
  if (!key_frame) fail("VP8: not a key frame");
  if (profile > 3) fail("VP8: profile %d does not exist", profile);
  if (!show) fail("VP8: frame not displayable");
  const int width = ((data[7] << 8) | data[6]) & 0x3fff;   // the scale bits are ignored
  const int height = ((data[9] << 8) | data[8]) & 0x3fff;
  if (width == 0 || height == 0) fail("VP8: frame of %d x %d pixels", width, height);
  const uint8_t* buf = data + 10;
  size_t buf_size = size - 10;
  mb_w_ = (width + 15) >> 4;
  mb_h_ = (height + 15) >> 4;
  if (partition_length > buf_size) fail("VP8: bad first partition length");
  br_.init(buf, partition_length);
  buf += partition_length;
  buf_size -= partition_length;
  br_.get();  // colour space
  br_.get();  // clamping type
  parse_segment_header();
  parse_filter_header();
  parse_partitions(buf, buf_size);
  parse_quant();
  br_.get();  // update_proba, ignored
  parse_proba();
  precompute_filter_strengths();

  // parse and reconstruct, one macroblock row at a time
  const int yw = mb_w_ * 16, uvw = mb_w_ * 8;
  std::vector<uint8_t> ybuf((size_t)yw * mb_h_ * 16), ubuf((size_t)uvw * mb_h_ * 8),
      vbuf((size_t)uvw * mb_h_ * 8);
  std::vector<FInfo> finfo((size_t)mb_w_ * mb_h_);
  std::vector<MBData> mbs(mb_w_);
  std::vector<uint8_t> intra_t(4 * mb_w_, B_DC_PRED);
  uint8_t intra_l[4];
  std::vector<uint8_t> top_nz(mb_w_, 0), top_nz_dc(mb_w_, 0);
  std::vector<uint8_t> top_y(16 * mb_w_), top_u(8 * mb_w_), top_v(8 * mb_w_);
  uint8_t yuv_b[YUV_SIZE + 64];
  memset(yuv_b, 0, sizeof(yuv_b));
  uint8_t* const y_dst = yuv_b + Y_OFF;
  uint8_t* const u_dst = yuv_b + U_OFF;
  uint8_t* const v_dst = yuv_b + V_OFF;
  static const int kScan[16] = {0 + 0 * BPS,  4 + 0 * BPS,  8 + 0 * BPS,  12 + 0 * BPS,
                                0 + 4 * BPS,  4 + 4 * BPS,  8 + 4 * BPS,  12 + 4 * BPS,
                                0 + 8 * BPS,  4 + 8 * BPS,  8 + 8 * BPS,  12 + 8 * BPS,
                                0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};
  for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
    BoolDecoder& token_br = parts_[mb_y & num_parts_minus_one_];
    memset(intra_l, B_DC_PRED, 4);
    for (int mb_x = 0; mb_x < mb_w_; ++mb_x) parse_intra_mode(&intra_t[4 * mb_x], intra_l, &mbs[mb_x]);
    if (br_.eof) fail("VP8: premature end of the first partition");
    uint8_t left_nz = 0, left_nz_dc = 0;
    for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
      MBData* block = &mbs[mb_x];
      int skip = use_skip_proba_ ? block->skip : 0;
      if (!skip) {
        skip = parse_residuals(token_br, block, &top_nz[mb_x], &top_nz_dc[mb_x], &left_nz,
                               &left_nz_dc);
      } else {
        left_nz = top_nz[mb_x] = 0;
        if (!block->is_i4x4) left_nz_dc = top_nz_dc[mb_x] = 0;
        block->non_zero_y = 0;
        block->non_zero_uv = 0;
        memset(block->coeffs, 0, sizeof(block->coeffs));
      }
      if (filter_type_ > 0) {
        FInfo& f = finfo[(size_t)mb_y * mb_w_ + mb_x];
        f = fstrengths_[block->segment][block->is_i4x4];
        f.inner |= !skip;
      }
      if (token_br.eof) fail("VP8: premature end of the token partition");
    }

    // reconstruction (libwebp's ReconstructRow and its edge samples)
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) {
      u_dst[j * BPS - 1] = 129;
      v_dst[j * BPS - 1] = 129;
    }
    if (mb_y > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
      memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      memset(u_dst - BPS - 1, 127, 8 + 1);
      memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
      const MBData* block = &mbs[mb_x];
      if (mb_x > 0) {
        for (int j = -1; j < 16; ++j) memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
        for (int j = -1; j < 8; ++j) {
          memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
          memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
        }
      }
      uint8_t* ty = &top_y[16 * mb_x];
      uint8_t* tu = &top_u[8 * mb_x];
      uint8_t* tv = &top_v[8 * mb_x];
      const int16_t* coeffs = block->coeffs;
      if (mb_y > 0) {
        memcpy(y_dst - BPS, ty, 16);
        memcpy(u_dst - BPS, tu, 8);
        memcpy(v_dst - BPS, tv, 8);
      }
      if (block->is_i4x4) {
        uint8_t* const top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w_ - 1) memset(top_right, ty[15], 4);
          else memcpy(top_right, &top_y[16 * (mb_x + 1)], 4);
        }
        for (int r = 1; r <= 3; ++r) memcpy(top_right + 4 * r * BPS, top_right, 4);
        uint32_t bits = block->non_zero_y;
        for (int n = 0; n < 16; ++n, bits <<= 2) {
          uint8_t* const dst = y_dst + kScan[n];
          pred_luma4(block->imodes[n], dst);
          do_transform(bits >> 30, coeffs + n * 16, dst);
        }
      } else {
        int mode = block->imodes[0];
        if (mode == B_DC_PRED)
          mode = mb_x == 0 ? (mb_y == 0 ? B_DC_PRED_NOTOPLEFT : B_DC_PRED_NOLEFT)
                           : (mb_y == 0 ? B_DC_PRED_NOTOP : B_DC_PRED);
        pred_luma16(mode, y_dst);
        uint32_t bits = block->non_zero_y;
        if (bits)
          for (int n = 0; n < 16; ++n, bits <<= 2)
            do_transform(bits >> 30, coeffs + n * 16, y_dst + kScan[n]);
      }
      {
        int mode = block->uvmode;
        if (mode == B_DC_PRED)
          mode = mb_x == 0 ? (mb_y == 0 ? B_DC_PRED_NOTOPLEFT : B_DC_PRED_NOLEFT)
                           : (mb_y == 0 ? B_DC_PRED_NOTOP : B_DC_PRED);
        pred_chroma8(mode, u_dst);
        pred_chroma8(mode, v_dst);
        do_uv_transform(block->non_zero_uv, coeffs + 16 * 16, u_dst);
        do_uv_transform(block->non_zero_uv >> 8, coeffs + 20 * 16, v_dst);
      }
      if (mb_y < mb_h_ - 1) {
        memcpy(ty, y_dst + 15 * BPS, 16);
        memcpy(tu, u_dst + 7 * BPS, 8);
        memcpy(tv, v_dst + 7 * BPS, 8);
      }
      for (int j = 0; j < 16; ++j)
        memcpy(&ybuf[(size_t)(mb_y * 16 + j) * yw + mb_x * 16], y_dst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        memcpy(&ubuf[(size_t)(mb_y * 8 + j) * uvw + mb_x * 8], u_dst + j * BPS, 8);
        memcpy(&vbuf[(size_t)(mb_y * 8 + j) * uvw + mb_x * 8], v_dst + j * BPS, 8);
      }
    }
  }

  // the loop filter, macroblock by macroblock in raster order (libwebp's
  // DoFilter; intra prediction above used the unfiltered samples)
  if (filter_type_ > 0) {
    for (int mb_y = 0; mb_y < mb_h_; ++mb_y)
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        const FInfo& f = finfo[(size_t)mb_y * mb_w_ + mb_x];
        const int limit = f.limit;
        if (limit == 0) continue;
        uint8_t* yp = &ybuf[(size_t)mb_y * 16 * yw + mb_x * 16];
        if (filter_type_ == 1) {
          if (mb_x > 0) simple_filter16(yp, 1, yw, limit + 4);
          if (f.inner)
            for (int k = 1; k <= 3; ++k) simple_filter16(yp + 4 * k, 1, yw, limit);
          if (mb_y > 0) simple_filter16(yp, yw, 1, limit + 4);
          if (f.inner)
            for (int k = 1; k <= 3; ++k) simple_filter16(yp + 4 * k * yw, yw, 1, limit);
        } else {
          uint8_t* up = &ubuf[(size_t)mb_y * 8 * uvw + mb_x * 8];
          uint8_t* vp = &vbuf[(size_t)mb_y * 8 * uvw + mb_x * 8];
          const int il = f.ilevel, ht = f.hev_thresh;
          if (mb_x > 0) {
            filter_loop26(yp, 1, yw, 16, limit + 4, il, ht);
            filter_loop26(up, 1, uvw, 8, limit + 4, il, ht);
            filter_loop26(vp, 1, uvw, 8, limit + 4, il, ht);
          }
          if (f.inner) {
            for (int k = 1; k <= 3; ++k) filter_loop24(yp + 4 * k, 1, yw, 16, limit, il, ht);
            filter_loop24(up + 4, 1, uvw, 8, limit, il, ht);
            filter_loop24(vp + 4, 1, uvw, 8, limit, il, ht);
          }
          if (mb_y > 0) {
            filter_loop26(yp, yw, 1, 16, limit + 4, il, ht);
            filter_loop26(up, uvw, 1, 8, limit + 4, il, ht);
            filter_loop26(vp, uvw, 1, 8, limit + 4, il, ht);
          }
          if (f.inner) {
            for (int k = 1; k <= 3; ++k)
              filter_loop24(yp + 4 * k * yw, yw, 1, 16, limit, il, ht);
            filter_loop24(up + 4 * uvw, uvw, 1, 8, limit, il, ht);
            filter_loop24(vp + 4 * uvw, uvw, 1, 8, limit, il, ht);
          }
        }
      }
  }

  VP8Image img;
  img.width = width;
  img.height = height;
  const int cw = (width + 1) / 2, ch = (height + 1) / 2;
  img.y.resize((size_t)width * height);
  img.u.resize((size_t)cw * ch);
  img.v.resize((size_t)cw * ch);
  for (int j = 0; j < height; ++j) memcpy(&img.y[(size_t)j * width], &ybuf[(size_t)j * yw], width);
  for (int j = 0; j < ch; ++j) {
    memcpy(&img.u[(size_t)j * cw], &ubuf[(size_t)j * uvw], cw);
    memcpy(&img.v[(size_t)j * cw], &vbuf[(size_t)j * uvw], cw);
  }
  return img;
}

// ---- Y'CbCr -> RGB (libwebp's yuv.h: 14-bit coefficients, 6 fraction bits)

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) {
  return ((v & ~16383) == 0) ? (uint8_t)(v >> 6) : (v < 0) ? 0 : 255;
}
inline void yuv_to_rgba(int y, int u, int v, uint8_t* rgba) {
  rgba[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgba[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgba[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
  rgba[3] = 0xff;
}

// libwebp's "fancy" upsampler (UpsampleRgbaLinePair): two output rows from
// the chroma rows above and below them, weights 9-3-3-1
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u,
                   const uint8_t* top_v, const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  const int last_pixel_pair = (len - 1) >> 1;
  int tl_u = top_u[0], tl_v = top_v[0], l_u = cur_u[0], l_v = cur_v[0];
  yuv_to_rgba(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst);
  if (bottom_y)
    yuv_to_rgba(bottom_y[0], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2, bottom_dst);
  for (int x = 1; x <= last_pixel_pair; ++x) {
    const int t_u = top_u[x], t_v = top_v[x], u = cur_u[x], v = cur_v[x];
    const int avg_u = tl_u + t_u + l_u + u + 8, avg_v = tl_v + t_v + l_v + v + 8;
    const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int d03_u = (avg_u + 2 * (tl_u + u)) >> 3, d03_v = (avg_v + 2 * (tl_v + v)) >> 3;
    yuv_to_rgba(top_y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1,
                top_dst + (2 * x - 1) * 4);
    yuv_to_rgba(top_y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, top_dst + 2 * x * 4);
    if (bottom_y) {
      yuv_to_rgba(bottom_y[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1,
                  bottom_dst + (2 * x - 1) * 4);
      yuv_to_rgba(bottom_y[2 * x], (d12_u + u) >> 1, (d12_v + v) >> 1, bottom_dst + 2 * x * 4);
    }
    tl_u = t_u;
    tl_v = t_v;
    l_u = u;
    l_v = v;
  }
  if (!(len & 1)) {
    yuv_to_rgba(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2,
                top_dst + (len - 1) * 4);
    if (bottom_y)
      yuv_to_rgba(bottom_y[len - 1], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2,
                  bottom_dst + (len - 1) * 4);
  }
}

// the whole frame through the upsampler, rows paired as libwebp's
// EmitFancyRGB pairs them: row 0 alone, then (1, 2), (3, 4), ..., and the
// last row alone when the height is even
void emit_fancy_rgba(const VP8Image& img, uint8_t* dst, size_t stride) {
  const int w = img.width, h = img.height, cw = (w + 1) / 2;
  const uint8_t* Y = img.y.data();
  const uint8_t* U = img.u.data();
  const uint8_t* V = img.v.data();
  upsample_pair(Y, nullptr, U, V, U, V, dst, nullptr, w);
  int y = 1;
  for (; y + 1 < h; y += 2) {
    const int c = (y + 1) / 2;
    upsample_pair(Y + (size_t)y * w, Y + (size_t)(y + 1) * w, U + (size_t)(c - 1) * cw,
                  V + (size_t)(c - 1) * cw, U + (size_t)c * cw, V + (size_t)c * cw,
                  dst + y * stride, dst + (y + 1) * stride, w);
  }
  if (!(h & 1)) {
    const int c = (h - 1) / 2;
    upsample_pair(Y + (size_t)(h - 1) * w, nullptr, U + (size_t)c * cw, V + (size_t)c * cw,
                  U + (size_t)c * cw, V + (size_t)c * cw, dst + (h - 1) * stride, nullptr, w);
  }
}

// ------------------------------------------------------------------ VP8L

// libwebp's VP8L bit reader, reduced to its observable rule: bits are read
// least significant first, reading past the data yields zeros, and the
// stream is broken (the decode fails) once more bits were consumed than
// 8 * max(size, 8).
struct LBitReader {
  const uint8_t* data = nullptr;
  size_t len = 0;
  uint64_t pos = 0;    // bits consumed
  uint64_t limit = 0;  // bits that may be consumed

  void init(const uint8_t* d, size_t n) {
    data = d;
    len = n;
    pos = 0;
    limit = 8 * (uint64_t)(n > 8 ? n : 8);
  }
  // the next 32 bits (zeros past the end), not consumed
  uint32_t peek() const {
    const size_t byte = pos >> 3;
    uint64_t v = 0;
    if (byte + 8 <= len) {
      memcpy(&v, data + byte, 8);
    } else {
      for (size_t i = 0; i < 8 && byte + i < len; ++i) v |= (uint64_t)data[byte + i] << (8 * i);
    }
    return (uint32_t)(v >> (pos & 7));
  }
  void skip(int n) {
    pos += n;
    if (pos > limit) fail("VP8L: the stream ends early");
  }
  uint32_t read(int n) {
    const uint32_t v = n ? peek() & ((1u << n) - 1) : 0;
    skip(n);
    return v;
  }
};

// one canonical prefix code: a root table of 8 bits and second-level
// tables for longer codes; a code of one symbol reads no bits
struct HuffTable {
  struct Entry {
    uint16_t value;
    uint8_t bits;  // code length, or 8 + the second-level table's bits
  };
  std::vector<Entry> t;
  static constexpr int kRoot = 8;

  int read(LBitReader& br) const {
    uint32_t v = br.peek();
    const Entry* e = &t[v & 255];
    if (e->bits > kRoot) {
      const int nb = e->bits - kRoot;
      e = &t[e->value + ((v >> kRoot) & ((1u << nb) - 1))];
      br.skip(kRoot + e->bits);
    } else {
      br.skip(e->bits);
    }
    return e->value;
  }
};

// lengths -> table; false where libwebp's VP8LBuildHuffmanTable fails (no
// symbol, or an incomplete or over-subscribed code)
bool build_huffman(const int* lengths, int n, HuffTable* out) {
  int count[16] = {0};
  int nonzero = 0, single = -1;
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > 15) return false;
    ++count[lengths[s]];
    if (lengths[s] > 0) {
      ++nonzero;
      single = s;
    }
  }
  if (nonzero == 0) return false;
  if (nonzero == 1) {
    if (out) out->t.assign(256, HuffTable::Entry{(uint16_t)single, 0});
    return true;
  }
  int64_t open = 1;
  for (int len = 1; len <= 15; ++len) {
    open = 2 * open - count[len];
    if (open < 0) return false;
  }
  if (open != 0) return false;
  if (!out) return true;
  // canonical codes, assigned by length then symbol, read bit-reversed
  int next_code[16];
  int code = 0;
  count[0] = 0;
  for (int len = 1; len <= 15; ++len) {
    code = (code + count[len - 1]) << 1;
    next_code[len] = code;
  }
  auto reverse = [](int c, int len) {
    int r = 0;
    for (int i = 0; i < len; ++i) r |= ((c >> i) & 1) << (len - 1 - i);
    return r;
  };
  std::vector<HuffTable::Entry>& t = out->t;
  t.assign(256, HuffTable::Entry{0, 0});
  // the longest code under each root prefix sizes its second-level table
  std::vector<int> sub_bits(256, 0);
  std::vector<int> codes(n, 0);
  for (int s = 0; s < n; ++s) {
    const int len = lengths[s];
    if (!len) continue;
    codes[s] = reverse(next_code[len]++, len);
    if (len > 8) {
      const int root = codes[s] & 255;
      if (len - 8 > sub_bits[root]) sub_bits[root] = len - 8;
    }
  }
  for (int root = 0; root < 256; ++root)
    if (sub_bits[root]) {
      t[root].value = (uint16_t)t.size();
      t[root].bits = (uint8_t)(8 + sub_bits[root]);
      t.resize(t.size() + ((size_t)1 << sub_bits[root]), HuffTable::Entry{0, 0});
    }
  for (int s = 0; s < n; ++s) {
    const int len = lengths[s];
    if (!len) continue;
    const int c = codes[s];
    if (len <= 8) {
      for (int k = c; k < 256; k += 1 << len) t[k] = HuffTable::Entry{(uint16_t)s, (uint8_t)len};
    } else {
      const int root = c & 255, nb = sub_bits[root];
      const size_t base = t[root].value;
      for (int k = c >> 8; k < (1 << nb); k += 1 << (len - 8))
        t[base + k] = HuffTable::Entry{(uint16_t)s, (uint8_t)(len - 8)};
    }
  }
  return true;
}

const int kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                      7,  8,  9, 10, 11, 12, 13, 14, 15};
const int kAlphabetSize[5] = {256 + 24, 256, 256, 256, 40};
enum { GREEN = 0, RED = 1, BLUE = 2, ALPHA = 3, DIST = 4 };
enum { PREDICTOR_TRANSFORM = 0, CROSS_COLOR_TRANSFORM = 1, SUBTRACT_GREEN_TRANSFORM = 2,
       COLOR_INDEXING_TRANSFORM = 3 };

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

struct HTreeGroup {
  HuffTable codes[5];
};

struct LTransform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

class VP8LDecoder {
 public:
  // a VP8L bitstream (with its 5-byte header): ARGB pixels, width x height
  std::vector<uint32_t> decode_image(const uint8_t* data, size_t size, int* width, int* height);
  // the header-less stream of an ALPH chunk: the green channel, w x h
  std::vector<uint32_t> decode_alpha(const uint8_t* data, size_t size, int w, int h);

 private:
  LBitReader br_;
  std::vector<LTransform> transforms_;
  uint32_t seen_ = 0;

  std::vector<uint32_t> decode_level0(int w, int h);
  std::vector<uint32_t> decode_stream(int xsize, int ysize, bool level0);
  void read_transform(int* xsize, int ysize);
  void read_code(int alphabet, std::vector<int>& lengths, HuffTable* out);
  void read_code_lengths(const int* clc, int num_symbols, std::vector<int>& lengths);
  void apply_inverse_transforms(std::vector<uint32_t>& px, int height);
};

void VP8LDecoder::read_code_lengths(const int* clc, int num_symbols, std::vector<int>& lengths) {
  HuffTable table;
  if (!build_huffman(clc, 19, &table)) fail("VP8L: invalid code-length code");
  int max_symbol;
  if (br_.read(1)) {
    const int length_nbits = 2 + 2 * br_.read(3);
    max_symbol = 2 + br_.read(length_nbits);
    if (max_symbol > num_symbols) fail("VP8L: code length count past the alphabet");
  } else {
    max_symbol = num_symbols;
  }
  int symbol = 0, prev_code_len = 8;
  while (symbol < num_symbols) {
    if (max_symbol-- == 0) break;
    const int code_len = table.read(br_);
    if (code_len < 16) {
      lengths[symbol++] = code_len;
      if (code_len != 0) prev_code_len = code_len;
    } else {
      static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
      const int slot = code_len - 16;
      int repeat = br_.read(kExtra[slot]) + kOffset[slot];
      if (symbol + repeat > num_symbols) fail("VP8L: code length repeat past the alphabet");
      const int length = code_len == 16 ? prev_code_len : 0;
      while (repeat-- > 0) lengths[symbol++] = length;
    }
  }
}

void VP8LDecoder::read_code(int alphabet, std::vector<int>& lengths, HuffTable* out) {
  std::fill(lengths.begin(), lengths.end(), 0);
  if (br_.read(1)) {  // simple code: one or two symbols of length 1
    const int num_symbols = br_.read(1) + 1;
    const int first_symbol_len_code = br_.read(1);
    int symbol = br_.read(first_symbol_len_code == 0 ? 1 : 8);
    lengths[symbol] = 1;
    if (num_symbols == 2) {
      symbol = br_.read(8);
      lengths[symbol] = 1;
    }
  } else {
    int clc[19] = {0};
    const int num_codes = br_.read(4) + 4;
    for (int i = 0; i < num_codes; ++i) clc[kCodeLengthCodeOrder[i]] = br_.read(3);
    read_code_lengths(clc, alphabet, lengths);
  }
  if (!build_huffman(lengths.data(), alphabet, out)) fail("VP8L: invalid prefix code");
}

void VP8LDecoder::read_transform(int* xsize, int ysize) {
  const int type = br_.read(2);
  if (seen_ & (1u << type)) fail("VP8L: transform %d appears twice", type);
  seen_ |= 1u << type;
  LTransform t;
  t.type = type;
  t.xsize = *xsize;
  t.ysize = ysize;
  switch (type) {
    case PREDICTOR_TRANSFORM:
    case CROSS_COLOR_TRANSFORM:
      t.bits = br_.read(3) + 2;
      t.data = decode_stream(subsample(t.xsize, t.bits), subsample(t.ysize, t.bits), false);
      break;
    case COLOR_INDEXING_TRANSFORM: {
      const int num_colors = br_.read(8) + 1;
      const int bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
      *xsize = subsample(t.xsize, bits);
      t.bits = bits;
      std::vector<uint32_t> pal = decode_stream(num_colors, 1, false);
      // the palette is delta-coded; entries past it are transparent black
      const int final_num_colors = 1 << (8 >> bits);
      t.data.assign(final_num_colors, 0);
      uint8_t* nd = (uint8_t*)t.data.data();
      const uint8_t* od = (const uint8_t*)pal.data();
      memcpy(nd, od, 4);
      for (int i = 4; i < 4 * num_colors; ++i) nd[i] = (uint8_t)(od[i] + nd[i - 4]);
      break;
    }
    default:  // SUBTRACT_GREEN_TRANSFORM
      break;
  }
  transforms_.push_back(std::move(t));
}

std::vector<uint32_t> VP8LDecoder::decode_stream(int xsize, int ysize, bool level0) {
  int txs = xsize;
  if (level0)
    while (br_.read(1)) read_transform(&txs, ysize);
  int cc_bits = 0;
  if (br_.read(1)) {
    cc_bits = br_.read(4);
    if (cc_bits < 1 || cc_bits > 11) fail("VP8L: colour cache of %d bits", cc_bits);
  }
  // the meta prefix codes
  int meta_bits = 0, num_groups = 1;
  std::vector<uint32_t> meta;
  std::vector<int> mapping;
  int num_groups_max = 1;
  if (level0 && br_.read(1)) {
    meta_bits = br_.read(3) + 2;
    const int hx = subsample(txs, meta_bits), hy = subsample(ysize, meta_bits);
    meta = decode_stream(hx, hy, false);
    for (uint32_t& m : meta) {
      m = (m >> 8) & 0xffff;
      if ((int)m >= num_groups_max) num_groups_max = m + 1;
    }
    if (num_groups_max > 1000 || (int64_t)num_groups_max > (int64_t)txs * ysize) {
      // only the groups the image uses are kept; the others are read
      mapping.assign(num_groups_max, -1);
      num_groups = 0;
      for (uint32_t& m : meta) {
        if (mapping[m] == -1) mapping[m] = num_groups++;
        m = mapping[m];
      }
    } else {
      num_groups = num_groups_max;
    }
  }
  std::vector<HTreeGroup> groups(num_groups);
  std::vector<int> lengths(256 + 24 + (cc_bits > 0 ? 1 << cc_bits : 0) + 256);
  for (int i = 0; i < num_groups_max; ++i) {
    const bool keep = mapping.empty() || mapping[i] != -1;
    HTreeGroup* g = keep ? &groups[mapping.empty() ? i : mapping[i]] : nullptr;
    for (int j = 0; j < 5; ++j) {
      int alphabet = kAlphabetSize[j];
      if (j == 0 && cc_bits > 0) alphabet += 1 << cc_bits;
      read_code(alphabet, lengths, g ? &g->codes[j] : nullptr);
    }
  }

  // the entropy-coded pixels
  const int width = txs, height = ysize;
  const size_t total = (size_t)width * height;
  std::vector<uint32_t> px(total);
  const int cache_size = cc_bits > 0 ? 1 << cc_bits : 0;
  std::vector<uint32_t> cache(cache_size, 0);
  const int cache_shift = 32 - cc_bits;
  const int mask = meta_bits == 0 ? ~0 : (1 << meta_bits) - 1;
  const int meta_xsize = subsample(width, meta_bits);
  auto group_at = [&](int x, int y) -> const HTreeGroup& {
    if (meta_bits == 0) return groups[0];
    return groups[meta[(size_t)meta_xsize * (y >> meta_bits) + (x >> meta_bits)]];
  };
  auto cache_insert = [&](uint32_t argb) {
    if (cache_size) cache[(0x1e35a7bdu * argb) >> cache_shift] = argb;
  };
  auto copy_value = [&](int symbol) -> int {  // lengths and distances
    if (symbol < 4) return symbol + 1;
    const int extra_bits = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra_bits;
    return offset + br_.read(extra_bits) + 1;
  };
  size_t pos = 0;
  int col = 0, row = 0;
  const HTreeGroup* g = total ? &group_at(0, 0) : nullptr;
  while (pos < total) {
    if ((col & mask) == 0) g = &group_at(col, row);
    const int code = g->codes[GREEN].read(br_);
    if (code < 256) {
      const int red = g->codes[RED].read(br_);
      const int blue = g->codes[BLUE].read(br_);
      const int alpha = g->codes[ALPHA].read(br_);
      const uint32_t argb = ((uint32_t)alpha << 24) | (red << 16) | (code << 8) | blue;
      px[pos++] = argb;
      cache_insert(argb);
      if (++col >= width) {
        col = 0;
        ++row;
      }
    } else if (code < 256 + 24) {
      const int length = copy_value(code - 256);
      const int dist_symbol = g->codes[DIST].read(br_);
      const int dist_code = copy_value(dist_symbol);
      int dist;
      if (dist_code > 120) {
        dist = dist_code - 120;
      } else {
        const int d = kCodeToPlane[dist_code - 1];
        dist = (d >> 4) * width + (8 - (d & 0xf));
        if (dist < 1) dist = 1;
      }
      if (pos < (size_t)dist || total - pos < (size_t)length)
        fail("VP8L: backward reference outside the image");
      for (int i = 0; i < length; ++i) {
        px[pos] = px[pos - dist];
        cache_insert(px[pos]);
        ++pos;
      }
      col += length;
      while (col >= width) {
        col -= width;
        ++row;
      }
      if (pos < total) g = &group_at(col, row);
    } else if (code < 256 + 24 + cache_size) {
      const uint32_t argb = cache[code - 256 - 24];
      px[pos++] = argb;
      cache_insert(argb);
      if (++col >= width) {
        col = 0;
        ++row;
      }
    } else {
      fail("VP8L: symbol %d outside the alphabet", code);
    }
  }
  return px;
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a0, uint32_t a1) {
  return (((a0 ^ a1) & 0xfefefefeu) >> 1) + (a0 & a1);
}
inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }
inline uint32_t clamped_add_subtract_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (c0 >> s) & 0xff, b = (c1 >> s) & 0xff, c = (c2 >> s) & 0xff;
    out |= clip255((uint32_t)(a + b - c)) << s;
  }
  return out;
}
inline uint32_t clamped_add_subtract_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (ave >> s) & 0xff, b = (c2 >> s) & 0xff;
    out |= clip255((uint32_t)(a + (a - b) / 2)) << s;
  }
  return out;
}
inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {
  int pa_minus_pb = 0;
  for (int s = 0; s < 32; s += 8) {
    const int pa = (a >> s) & 0xff, pb = (b >> s) & 0xff, pc = (c >> s) & 0xff;
    pa_minus_pb += absi(pb - pc) - absi(pa - pc);
  }
  return pa_minus_pb <= 0 ? a : b;
}

// predictor `mode` for the pixel at out[0], `top` pointing at the pixel
// above it (top[1] of a row's last pixel is the row's first pixel)
inline uint32_t predict(int mode, const uint32_t* out, const uint32_t* top) {
  const uint32_t L = out[-1];
  switch (mode) {
    case 1: return L;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(L, top[1]), top[0]);
    case 6: return average2(L, top[-1]);
    case 7: return average2(L, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(L, top[-1]), average2(top[0], top[1]));
    case 11: return select_pred(top[0], L, top[-1]);
    case 12: return clamped_add_subtract_full(L, top[0], top[-1]);
    case 13: return clamped_add_subtract_half(L, top[0], top[-1]);
    default: return 0xff000000u;  // 0, and 14 and 15 as libwebp reads them
  }
}

void VP8LDecoder::apply_inverse_transforms(std::vector<uint32_t>& px, int height) {
  for (int n = (int)transforms_.size() - 1; n >= 0; --n) {
    const LTransform& t = transforms_[n];
    const int w = t.xsize;
    switch (t.type) {
      case SUBTRACT_GREEN_TRANSFORM:
        for (uint32_t& p : px) {
          const uint32_t green = (p >> 8) & 0xff;
          uint32_t rb = p & 0x00ff00ffu;
          rb += (green << 16) | green;
          p = (p & 0xff00ff00u) | (rb & 0x00ff00ffu);
        }
        break;
      case PREDICTOR_TRANSFORM: {
        std::vector<uint32_t> out((size_t)w * height);
        const int tiles_per_row = subsample(w, t.bits);
        for (int y = 0; y < height; ++y) {
          const uint32_t* in = &px[(size_t)y * w];
          uint32_t* o = &out[(size_t)y * w];
          if (y == 0) {
            o[0] = add_pixels(in[0], 0xff000000u);
            for (int x = 1; x < w; ++x) o[x] = add_pixels(in[x], o[x - 1]);
            continue;
          }
          o[0] = add_pixels(in[0], o[-w]);
          const uint32_t* modes = &t.data[(size_t)(y >> t.bits) * tiles_per_row];
          for (int x = 1; x < w; ++x) {
            const int mode = (modes[x >> t.bits] >> 8) & 0xf;
            o[x] = add_pixels(in[x], predict(mode, o + x, o + x - w));
          }
        }
        px.swap(out);
        break;
      }
      case CROSS_COLOR_TRANSFORM: {
        const int tiles_per_row = subsample(w, t.bits);
        for (int y = 0; y < height; ++y) {
          uint32_t* row = &px[(size_t)y * w];
          const uint32_t* codes = &t.data[(size_t)(y >> t.bits) * tiles_per_row];
          for (int x = 0; x < w; ++x) {
            const uint32_t cc = codes[x >> t.bits];
            const int8_t green_to_red = (int8_t)(cc & 0xff);
            const int8_t green_to_blue = (int8_t)((cc >> 8) & 0xff);
            const int8_t red_to_blue = (int8_t)((cc >> 16) & 0xff);
            const uint32_t argb = row[x];
            const int8_t green = (int8_t)(argb >> 8);
            int new_red = (argb >> 16) & 0xff;
            int new_blue = argb & 0xff;
            new_red += ((int)green_to_red * green) >> 5;
            new_red &= 0xff;
            new_blue += ((int)green_to_blue * green) >> 5;
            new_blue += ((int)red_to_blue * (int8_t)new_red) >> 5;
            new_blue &= 0xff;
            row[x] = (argb & 0xff00ff00u) | (new_red << 16) | new_blue;
          }
        }
        break;
      }
      default: {  // COLOR_INDEXING_TRANSFORM
        const int in_w = subsample(w, t.bits);
        std::vector<uint32_t> out((size_t)w * height);
        const int bits_per_pixel = 8 >> t.bits;
        const int count_mask = (1 << t.bits) - 1;
        const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
        for (int y = 0; y < height; ++y) {
          const uint32_t* in = &px[(size_t)y * in_w];
          uint32_t* o = &out[(size_t)y * w];
          uint32_t packed = 0;
          for (int x = 0; x < w; ++x) {
            if ((x & count_mask) == 0) packed = (*in++ >> 8) & 0xff;
            o[x] = t.data[packed & bit_mask];
            packed >>= bits_per_pixel;
          }
        }
        px.swap(out);
        break;
      }
    }
  }
}

std::vector<uint32_t> VP8LDecoder::decode_level0(int w, int h) {
  std::vector<uint32_t> px = decode_stream(w, h, true);
  apply_inverse_transforms(px, h);
  return px;
}

std::vector<uint32_t> VP8LDecoder::decode_image(const uint8_t* data, size_t size, int* width,
                                                int* height) {
  if (size < 5 || data[0] != 0x2f || (data[4] >> 5) != 0)
    fail("VP8L: bad signature or version");
  br_.init(data, size);
  br_.read(8);
  *width = br_.read(14) + 1;
  *height = br_.read(14) + 1;
  br_.read(1);  // alpha hint
  if (br_.read(3) != 0) fail("VP8L: version is not 0");
  return decode_level0(*width, *height);
}

std::vector<uint32_t> VP8LDecoder::decode_alpha(const uint8_t* data, size_t size, int w, int h) {
  br_.init(data, size);
  return decode_level0(w, h);
}

// ------------------------------------------------------------------ ALPH

inline uint8_t gradient_predictor(uint8_t a, uint8_t b, uint8_t c) {
  const int g = a + b - c;
  return ((g & ~0xff) == 0) ? (uint8_t)g : (g < 0) ? 0 : 255;
}

// libwebp's WebPUnfilters (dsp/filters.c): prev is the row above (null for
// the first row, which is predicted from its left neighbour, 0 first)
void unfilter_row(int filter, const uint8_t* prev, const uint8_t* in, uint8_t* out, int w) {
  if (filter == 0) {
    if (out != in) memmove(out, in, w);
  } else if (filter == 1 || prev == nullptr) {
    uint8_t pred = (filter == 1 && prev) ? prev[0] : 0;
    for (int i = 0; i < w; ++i) {
      out[i] = (uint8_t)(pred + in[i]);
      pred = out[i];
    }
  } else if (filter == 2) {
    for (int i = 0; i < w; ++i) out[i] = (uint8_t)(prev[i] + in[i]);
  } else {
    uint8_t top = prev[0], top_left = top, left = top;
    for (int i = 0; i < w; ++i) {
      top = prev[i];
      left = (uint8_t)(in[i] + gradient_predictor(left, top, top_left));
      top_left = top;
      out[i] = left;
    }
  }
}

std::vector<uint8_t> decode_alph(const uint8_t* data, size_t size, int w, int h) {
  if (size <= 1) fail("ALPH: empty chunk");
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3;
  const int pre_processing = (data[0] >> 4) & 3, reserved = (data[0] >> 6) & 3;
  if (method > 1 || pre_processing > 1 || reserved != 0)
    fail("ALPH: header byte 0x%02x is not valid", data[0]);
  const size_t n = (size_t)w * h;
  std::vector<uint8_t> deltas(n);
  if (method == 0) {
    if (size - 1 < n) fail("ALPH: raw alpha shorter than the frame");
    memcpy(deltas.data(), data + 1, n);
  } else {
    VP8LDecoder dec;
    std::vector<uint32_t> argb = dec.decode_alpha(data + 1, size - 1, w, h);
    for (size_t i = 0; i < n; ++i) deltas[i] = (uint8_t)(argb[i] >> 8);
  }
  std::vector<uint8_t> alpha(n);
  for (int y = 0; y < h; ++y)
    unfilter_row(filter, y ? &alpha[(size_t)(y - 1) * w] : nullptr, &deltas[(size_t)y * w],
                 &alpha[(size_t)y * w], w);
  return alpha;
}

// ------------------------------------------------------------------ container

struct Frame {
  int x_off = 0, y_off = 0, width = 0, height = 0;
  int frame_num = 0;
  bool complete = false;
  bool vp8l_alpha_bit = false;  // the VP8L header's alpha hint
  bool had_alph = false;        // an ALPH chunk before the image, kept or not
  size_t alpha_off = 0, alpha_chunk = 0;  // ALPH chunk: header offset, 8 + padded payload
  size_t img_off = 0, img_chunk = 0;      // VP8 / VP8L chunk likewise
  bool lossless = false;
};

struct Canvas {
  int width = 0, height = 0;
  uint32_t flags = 0;
  bool rgba = false;  // PIL's mode: "RGBA", else "RGB"
  Frame first;
};

// WebPGetFeatures of one "VP8 " / "VP8L" chunk (header included): the
// frame's size and its alpha bit; fails where libwebp does
void chunk_features(const uint8_t* d, size_t n, Frame* f) {
  const uint32_t size = le32(d + 4);
  const uint8_t* p = d + 8;
  const size_t avail = n - 8;
  if (tag_is(d, "VP8 ")) {
    if (avail < 10) fail("VP8: truncated frame header");
    if (p[3] != 0x9d || p[4] != 0x01 || p[5] != 0x2a)
      fail("VP8: bad start code (not a VP8 key frame)");
    const uint32_t bits = p[0] | (p[1] << 8) | (p[2] << 16);
    const int w = ((p[7] << 8) | p[6]) & 0x3fff, h = ((p[9] << 8) | p[8]) & 0x3fff;
    if (bits & 1) fail("VP8: not a key frame");
    if (((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) || (bits >> 5) >= size)
      fail("VP8: bad frame tag");
    if (w == 0 || h == 0) fail("VP8: frame of %d x %d pixels", w, h);
    f->width = w;
    f->height = h;
    f->lossless = false;
  } else {
    if (avail < 5) fail("VP8L: truncated header");
    if (p[0] != 0x2f || (p[4] >> 5) != 0) fail("VP8L: bad signature or version");
    const uint32_t bits = le32(p + 1);
    f->width = (bits & 0x3fff) + 1;
    f->height = ((bits >> 14) & 0x3fff) + 1;
    f->vp8l_alpha_bit = (bits >> 28) & 1;
    f->lossless = true;
  }
}

struct Demux {
  const uint8_t* d;
  size_t end;    // the end of the RIFF chunk (the data's end)
  size_t pos;
  Canvas c;
  bool is_ext = false, have_frame = false;
  int num_frames = 0;

  size_t avail() const { return end - pos; }

  // StoreFrame: the ALPH and image chunks of one frame, from pos on
  void store_frame(int frame_num, uint32_t min_size, Frame* f) {
    if (avail() < 8 || avail() < min_size) fail("truncated frame");
    int alpha_chunks = 0, image_chunks = 0;
    bool done = false;
    do {
      const size_t chunk_start = pos;
      const uint8_t* h = d + pos;
      const uint32_t payload = le32(h + 4);
      pos += 8;
      if (payload > kMaxChunkPayload) fail("chunk size past the limit");
      const uint32_t padded = payload + (payload & 1);
      if (padded > avail()) fail("chunk '%s' runs past the end of the file", tag_str(h).c_str());
      const size_t chunk_size = 8 + (size_t)padded;
      const bool is_image = tag_is(h, "VP8 ") || tag_is(h, "VP8L");
      if (tag_is(h, "VP8L") && alpha_chunks > 0) fail("ALPH chunk before a VP8L frame");
      if (tag_is(h, "ALPH") && alpha_chunks == 0) {
        ++alpha_chunks;
        f->alpha_off = chunk_start;
        f->alpha_chunk = chunk_size;
        f->frame_num = frame_num;
        pos += padded;
      } else if (is_image && image_chunks == 0) {
        chunk_features(h, chunk_size, f);
        ++image_chunks;
        f->img_off = chunk_start;
        f->img_chunk = chunk_size;
        f->frame_num = frame_num;
        f->complete = true;
        pos += padded;
      } else {
        pos -= 8;
        done = true;
      }
      if (pos == end) done = true;
      else if (avail() < 8) fail("truncated chunk header");
    } while (!done);
  }

  void parse_single_image() {
    if (have_frame) fail("a second image in a still file");
    if (avail() < 8) fail("truncated chunk header");
    Frame f;
    store_frame(1, 0, &f);
    f.had_alph = f.alpha_chunk != 0 && f.alpha_off < f.img_off;
    if (!(c.flags & kAlphaFlag) && f.alpha_chunk) {  // no alpha flag: ALPH dropped
      f.alpha_off = f.alpha_chunk = 0;
    }
    if (!is_ext) {
      c.width = f.width;
      c.height = f.height;
    }
    c.first = f;
    have_frame = true;
    num_frames = 1;
  }

  void parse_animation_frame(uint32_t chunk_size_padded) {
    const bool is_animation = c.flags & kAnimationFlag;
    if (16 > avail() || chunk_size_padded < 16) fail("ANMF chunk too short");
    const uint32_t anmf_payload = chunk_size_padded - 16;
    Frame f;
    const uint8_t* h = d + pos;
    f.x_off = 2 * (int)le24(h);
    f.y_off = 2 * (int)le24(h + 3);
    f.width = 1 + (int)le24(h + 6);
    f.height = 1 + (int)le24(h + 9);
    pos += 16;
    if ((uint64_t)f.width * f.height >= kMaxImageArea) fail("ANMF frame too large");
    const size_t start = pos;
    store_frame(num_frames + 1, anmf_payload, &f);
    if (pos - start > anmf_payload) fail("ANMF frame data past its chunk");
    if (is_animation && f.frame_num > 0) {
      check_frame(f, true);
      if (!have_frame) c.first = f;
      have_frame = true;
      ++num_frames;
    }
  }

  void parse_vp8x() {
    is_ext = true;
    pos += 4;
    uint32_t vp8x_size = le32(d + pos);
    pos += 4;
    if (vp8x_size > kMaxChunkPayload || vp8x_size < 10) fail("VP8X chunk of %u bytes", vp8x_size);
    if (vp8x_size != 10) fail("VP8X chunk of %u bytes (WebPGetFeatures wants 10)", vp8x_size);
    vp8x_size += vp8x_size & 1;
    if (vp8x_size > avail()) fail("VP8X chunk runs past the end of the file");
    c.flags = d[pos];
    c.width = 1 + (int)le24(d + pos + 4);
    c.height = 1 + (int)le24(d + pos + 7);
    if ((uint64_t)c.width * c.height >= kMaxImageArea) fail("canvas too large");
    pos += vp8x_size;
    if (avail() < 8) fail("no chunk after VP8X");
    const bool is_animation = c.flags & kAnimationFlag;
    int anim_chunks = 0;
    while (true) {
      const size_t chunk_start = pos;
      const uint8_t* h = d + pos;
      const uint32_t chunk_size = le32(h + 4);
      pos += 8;
      if (chunk_size > kMaxChunkPayload) fail("chunk size past the limit");
      const uint32_t padded = chunk_size + (chunk_size & 1);
      if (padded > avail()) fail("chunk '%s' runs past the end of the file", tag_str(h).c_str());
      if (tag_is(h, "VP8X")) {
        fail("a second VP8X chunk");
      } else if (tag_is(h, "ALPH") || tag_is(h, "VP8 ") || tag_is(h, "VP8L")) {
        if (anim_chunks > 0 || is_animation) fail("an image chunk outside ANMF in an animation");
        pos = chunk_start;
        parse_single_image();
      } else if (tag_is(h, "ANIM")) {
        if (padded < 6) fail("ANIM chunk too short");
        ++anim_chunks;
        pos += padded;
      } else if (tag_is(h, "ANMF")) {
        if (anim_chunks == 0) fail("ANMF before ANIM");
        parse_animation_frame(padded);
      } else {  // ICCP, EXIF, XMP and unknown chunks
        pos += padded;
      }
      if (pos == end) break;
      if (avail() < 8) fail("truncated chunk header");
    }
    // IsValidExtendedFormat
    if (!have_frame) fail("no frame");
    if (c.flags & ~kAllValidFlags) fail("reserved VP8X flags set (0x%02x)", c.flags);
    if (!is_animation) check_frame(c.first, false);
  }

  // IsValidExtendedFormat's checks of one frame
  void check_frame(const Frame& f, bool animation) const {
    if (!f.complete) fail("a frame without an image chunk");
    if (f.alpha_chunk && f.alpha_off > f.img_off) fail("ALPH after the image chunk");
    if (f.width <= 0 || f.height <= 0) fail("frame without a size");
    if (!animation) {
      if (f.x_off != 0 || f.y_off != 0 || f.width != c.width || f.height != c.height)
        fail("canvas of %d x %d holds a frame of %d x %d", c.width, c.height, f.width,
             f.height);
    } else if (f.x_off + f.width > c.width || f.y_off + f.height > c.height) {
      fail("frame outside the canvas");
    }
  }
};

// the file's canvas: libwebp's WebPDemux and WebPGetFeatures checks
Canvas parse(const uint8_t* d, size_t n) {
  if (n < 20) fail("truncated file (%zu bytes)", n);
  if (!tag_is(d, "RIFF") || !tag_is(d + 8, "WEBP")) fail("RIFF, not WebP");
  const uint32_t riff_size = le32(d + 4);
  if (riff_size < 12 || riff_size > kMaxChunkPayload) fail("RIFF size %u is not valid", riff_size);
  const size_t riff_end = (size_t)riff_size + 8;
  if (n < riff_end)
    fail("truncated file (the RIFF chunk holds %zu bytes, the file %zu)", riff_end, n);
  Demux dm{d, riff_end, 12, Canvas{}};
  if (tag_is(d + 12, "VP8 ") || tag_is(d + 12, "VP8L")) {
    dm.parse_single_image();
  } else if (tag_is(d + 12, "VP8X")) {
    dm.parse_vp8x();
  } else {
    fail("first chunk '%s' is not VP8, VP8L or VP8X", tag_str(d + 12).c_str());
  }
  // PIL's mode is WebPGetFeatures's has_alpha: the VP8X flag (for a still
  // image also an ALPH chunk before the frame, even one the demuxer drops),
  // overridden by the alpha hint of a VP8L frame
  const Frame& f = dm.c.first;
  if (dm.is_ext && (dm.c.flags & kAnimationFlag)) dm.c.rgba = dm.c.flags & kAlphaFlag;
  else if (f.lossless) dm.c.rgba = f.vp8l_alpha_bit;
  else dm.c.rgba = dm.is_ext && ((dm.c.flags & kAlphaFlag) || f.had_alph);
  return dm.c;
}

// the first frame on its zero canvas, RGBA (WebPAnimDecoderGetNext)
void decode_canvas(const uint8_t* d, const Canvas& c, uint8_t* out) {
  const Frame& f = c.first;
  const size_t stride = (size_t)c.width * 4;
  memset(out, 0, stride * c.height);
  uint8_t* dst = out + (size_t)f.y_off * stride + (size_t)f.x_off * 4;
  const uint8_t* payload = d + f.img_off + 8;
  const size_t payload_size = f.img_chunk - 8;  // padded, as libwebp hands it on
  if (f.lossless) {
    VP8LDecoder dec;
    int w = 0, h = 0;
    std::vector<uint32_t> argb = dec.decode_image(payload, payload_size, &w, &h);
    if (w != f.width || h != f.height) fail("VP8L size changed");
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const uint32_t p = argb[(size_t)y * w + x];
        uint8_t* o = dst + y * stride + x * 4;
        o[0] = (p >> 16) & 0xff;
        o[1] = (p >> 8) & 0xff;
        o[2] = p & 0xff;
        o[3] = p >> 24;
      }
    return;
  }
  VP8Decoder dec;
  const VP8Image img = dec.decode(payload, payload_size);
  if (img.width != f.width || img.height != f.height) fail("VP8 size changed");
  std::vector<uint8_t> alpha;
  if (f.alpha_chunk)
    alpha = decode_alph(d + f.alpha_off + 8, le32(d + f.alpha_off + 4), img.width, img.height);
  emit_fancy_rgba(img, dst, stride);
  if (!alpha.empty())
    for (int y = 0; y < img.height; ++y)
      for (int x = 0; x < img.width; ++x) dst[y * stride + x * 4 + 3] = alpha[(size_t)y * img.width + x];
}

void set_err(const std::string& msg, char* err, int errlen) {
  if (err && errlen > 0) {
    strncpy(err, msg.c_str(), errlen - 1);
    err[errlen - 1] = 0;
  }
}

}  // namespace

extern "C" {

// out[0..2]: canvas width, height, channels of PIL's mode (4 for "RGBA", 3
// for "RGB"). 0 on success; -1 with a message in err.
int citlab_webp_info(const uint8_t* data, int64_t n, int32_t* out, char* err, int errlen) {
  try {
    const Canvas c = parse(data, (size_t)n);
    out[0] = c.width;
    out[1] = c.height;
    out[2] = c.rgba ? 4 : 3;
    return 0;
  } catch (const Fail& e) {
    set_err(e.msg, err, errlen);
  } catch (const std::bad_alloc&) {
    set_err("WebP: out of memory", err, errlen);
  }
  return -1;
}

// the first frame on its canvas as RGBA, height x width x 4 bytes at out
int citlab_webp_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t out_n, char* err,
                       int errlen) {
  try {
    const Canvas c = parse(data, (size_t)n);
    if ((int64_t)c.width * c.height * 4 != out_n) fail("output buffer of the wrong size");
    decode_canvas(data, c, out);
    return 0;
  } catch (const Fail& e) {
    set_err(e.msg, err, errlen);
  } catch (const std::bad_alloc&) {
    set_err("WebP: out of memory", err, errlen);
  }
  return -1;
}

}  // extern "C"
