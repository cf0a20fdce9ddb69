// JPEG 2000 decoder of the port: every JP2, JPX and raw J2K file that PIL
// 12.1 opens, decoded to the image PIL gives, byte for byte. PIL reads these
// files with OpenJPEG 2.5.4 (opj_read_tile_header / opj_decode_tile_data,
// strict mode, no reduction, every layer) and unpacks each tile with the
// converters of Pillow's Jpeg2KDecode.c; this file does what both do.
//
// - Container: Pillow's own header parse (Jpeg2KImagePlugin.py: the mode
//   from SIZ's Csiz or the ihdr box, "CMYK" from colr enumcs 12, "P" / "PA"
//   from a pclr box, its palette as ImagePalette.getcolor builds it), and
//   OpenJPEG's box reader (jP, ftyp, jp2h with ihdr / colr / bpcc / pclr /
//   cmap / cdef, jp2c, the boxes after the codestream), with their checks.
//   Only colr's enumerated colour space reaches the pixels: OpenJPEG's tile
//   interface applies no pclr, cmap or cdef box.
// - Codestream: SIZ, COD / COC, QCD / QCC, RGN, POC, PPM / PPT, TLM, PLM /
//   PLT, CRG, COM, SOT / SOD across tile-parts, EOC and unknown markers, read
//   as j2k.c reads them (the same order of checks, so that the same files
//   fail); tiles decode in the order OpenJPEG completes them.
// - Tier 2: the five progression orders and POC through OpenJPEG's packet
//   iterator, tag trees, pass counts, Lblock, segment lengths, SOP / EPH,
//   PPM / PPT headers; a segment longer than its data fails (strict mode).
// - Tier 1: the MQ decoder (its end-of-segment 0xFF 0xFF marker included),
//   the significance, refinement and cleanup passes with every code-block
//   style bit (bypass, reset, termall, vertically causal, predictable
//   termination, segmentation symbols).
// - Reconstruction as OpenJPEG computes it: ROI max-shift, the reversible
//   halving or the float dequantisation (step from the QCD / QCC mantissa
//   and exponent, OpenJPEG's 2/K gain convention), the 5/3 integer and 9/7
//   float lifting in OpenJPEG's order of operations, RCT / ICT, the DC level
//   shift with lrintf and the clamp; then the tile buffer as
//   opj_tcd_update_tile_data packs it and Pillow's unpacker (shift of each
//   component's precision to 8 or 16 bits, signed offsets, subsampled
//   components, sYCC through Pillow's YCbCr tables).
// - Output: PIL's convert("L") / convert("RGB") of the "L", "I;16", "LA",
//   "RGB", "RGBA", "CMYK", "P" or "PA" image.
//
// Features no oracle file can be written for here (high-throughput
// code-blocks, Part 2 multi-component transforms) fail by name. Every read
// is bounds-checked and every malformed stream fails with a message: a
// caller never sees a partial image. Build with -ffp-contract=off: OpenJPEG's
// float code is never fused.
#include <algorithm>
#include <cmath>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
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
  throw Fail{std::string("JPEG 2000: ") + buf};
}

inline uint32_t be16(const uint8_t* p) { return (uint32_t)p[0] << 8 | p[1]; }
inline uint32_t be32(const uint8_t* p) {
  return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 | p[3];
}
inline uint32_t ceildiv(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a + b - 1) / b); }
inline uint32_t ceildiv64(uint32_t a, uint64_t b) { return (uint32_t)(((uint64_t)a + b - 1) / b); }
inline int32_t int_ceildivpow2(int32_t a, int32_t b) {
  return (int32_t)(((int64_t)a + ((int64_t)1 << b) - 1) >> b);
}
inline int32_t int64_ceildivpow2(int64_t a, int32_t b) {
  return (int32_t)((a + ((int64_t)1 << b) - 1) >> b);
}
inline int32_t int_floordivpow2(int32_t a, int32_t b) { return a >> b; }
inline uint32_t uint_adds(uint32_t a, uint32_t b) {
  uint64_t s = (uint64_t)a + b;
  return s > 0xffffffffu ? 0xffffffffu : (uint32_t)s;
}
inline float as_float(int32_t v) {
  float f;
  memcpy(&f, &v, 4);
  return f;
}
inline int32_t as_int(float f) {
  int32_t v;
  memcpy(&v, &f, 4);
  return v;
}

// ------------------------------------------------------------------ stream
// OpenJPEG's opj_stream over the whole file (Pillow hands it the file and
// its length): reads and skips return what they got, never more.
struct Stream {
  const uint8_t* d;
  uint64_t n, pos = 0;
  uint64_t left() const { return pos < n ? n - pos : 0; }
  uint32_t read(uint8_t* out, uint32_t k) {
    uint32_t got = (uint32_t)(left() < k ? left() : k);
    if (got) memcpy(out, d + pos, got);
    pos += got;
    return got;
  }
  int64_t skip(uint64_t k) {
    if (pos + k > n) {
      int64_t r = (int64_t)left();
      pos = n;
      return r ? r : -1;
    }
    pos += k;
    return (int64_t)k;
  }
};

// ------------------------------------------------------------------ Pillow's header parse

enum Mode { M_L, M_I16, M_LA, M_RGB, M_RGBA, M_CMYK, M_P, M_PA };
const char* kModeNames[] = {"L", "I;16", "LA", "RGB", "RGBA", "CMYK", "P", "PA"};

struct PilHeader {
  bool jp2 = false;
  int64_t w = 0, h = 0;
  int mode = M_L;
  // the palette's bytes as ImagePalette.getcolor leaves them, in entries
  // of pal_len bytes (3 for an "RGB" palette, 4 for "RGBA")
  std::vector<uint8_t> palette;
  uint32_t pal_len = 3;
};

// Pillow's BoxReader over a byte range (a Python file: a seek may pass the
// end, and a read there comes back short)
struct PyBoxReader {
  const uint8_t* d;
  uint64_t n, pos = 0;
  bool has_length;
  int64_t length;
  int64_t remaining = -1;
  bool can_read(uint64_t k) const {
    if (has_length && (int64_t)(pos + k) > length) return false;
    if (remaining >= 0) return (int64_t)k <= remaining;
    return true;
  }
  const uint8_t* read_bytes(uint64_t k) {
    if (!can_read(k)) fail("the JP2 header has not enough data in a box (PIL refuses it)");
    if (pos > n || n - pos < k) fail("the JP2 header is truncated (PIL refuses it)");
    const uint8_t* p = d + pos;
    pos += k;
    if (remaining > 0) remaining -= (int64_t)k;
    return p;
  }
  bool has_next_box() const { return has_length ? (int64_t)pos + remaining < length : true; }
  uint32_t next_box_type() {
    if (remaining > 0) pos += (uint64_t)remaining;
    remaining = -1;
    const uint8_t* p = read_bytes(8);
    uint64_t lbox = be32(p);
    uint32_t tbox = be32(p + 4);
    uint64_t hlen = 8;
    if (lbox == 1) {
      const uint8_t* q = read_bytes(8);
      lbox = (uint64_t)be32(q) << 32 | be32(q + 4);
      hlen = 16;
    }
    if (lbox < hlen || !can_read(lbox - hlen))
      fail("a JP2 box has an invalid header length (PIL refuses it)");
    remaining = (int64_t)(lbox - hlen);
    return tbox;
  }
  PyBoxReader read_boxes() {
    int64_t size = remaining;
    const uint8_t* p = read_bytes((uint64_t)size);
    return PyBoxReader{p, (uint64_t)size, 0, true, size};
  }
};

constexpr uint32_t box(const char* s) {
  return (uint32_t)(uint8_t)s[0] << 24 | (uint32_t)(uint8_t)s[1] << 16 |
         (uint32_t)(uint8_t)s[2] << 8 | (uint8_t)s[3];
}

const uint8_t kJp2Sig[12] = {0, 0, 0, 0x0c, 'j', 'P', ' ', ' ', 0x0d, 0x0a, 0x87, 0x0a};

// Jpeg2KImageFile._parse_comment: walks the main header's markers; its
// reads can fail, which fails PIL's open
void pil_parse_comment(const uint8_t* d, uint64_t n, uint64_t pos) {
  for (;;) {
    if (pos >= n) return;
    if (n - pos < 2) fail("the main header ends inside a marker (PIL refuses it)");
    uint8_t typ = d[pos + 1];
    pos += 2;
    if (typ == 0x90 || typ == 0xd9) return;
    if (pos > n || n - pos < 2) fail("the main header ends inside a marker (PIL refuses it)");
    uint32_t length = be16(d + pos);
    pos += 2;
    if (typ == 0x64) return;
    int64_t np = (int64_t)pos + (int64_t)length - 2;
    if (np < 0) fail("a marker length points before the file (PIL refuses it)");
    pos = (uint64_t)np;
  }
}

PilHeader pil_header(const uint8_t* d, uint64_t n) {
  PilHeader ph;
  if (n >= 4 && be32(d) == 0xff4fff51) {
    // _parse_codestream
    if (n < 6) fail("the SIZ marker is truncated (PIL refuses it)");
    uint32_t lsiz = be16(d + 4);
    uint64_t avail = n - 4;
    uint64_t want = lsiz >= 2 ? lsiz : avail;   // fp.read(negative) reads everything
    uint64_t sizlen = want < avail ? want : avail;
    const uint8_t* siz = d + 4;
    if (sizlen < 38) fail("the SIZ marker is truncated (PIL refuses it)");
    uint32_t xsiz = be32(siz + 4), ysiz = be32(siz + 8), xo = be32(siz + 12),
             yo = be32(siz + 16);
    uint32_t csiz = be16(siz + 36);
    ph.w = (int64_t)xsiz - xo;
    ph.h = (int64_t)ysiz - yo;
    if (csiz == 1) {
      if (sizlen < 39) fail("the SIZ marker is truncated (PIL refuses it)");
      ph.mode = (siz[38] & 0x7f) + 1 > 8 ? M_I16 : M_L;
    } else if (csiz == 2) {
      ph.mode = M_LA;
    } else if (csiz == 3) {
      ph.mode = M_RGB;
    } else if (csiz == 4) {
      ph.mode = M_RGBA;
    } else {
      fail("a codestream of %u components (PIL opens 1 to 4)", csiz);
    }
    pil_parse_comment(d, n, 4 + sizlen);
    return ph;
  }
  if (n < 12 || memcmp(d, kJp2Sig, 12) != 0) fail("not a JPEG 2000 file");
  ph.jp2 = true;
  PyBoxReader top{d, n, 12, false, -1};
  bool found = false;
  PyBoxReader header{nullptr, 0, 0, true, 0};
  while (top.has_next_box()) {
    uint32_t t = top.next_box_type();
    if (t == box("jp2h")) {
      header = top.read_boxes();
      found = true;
      break;
    } else if (t == box("ftyp")) {
      top.read_bytes(4);
    }
  }
  if (!found) fail("no JP2 header box (PIL refuses it)");
  bool have_size = false, have_mode = false;
  int nc = -1;
  while (header.has_next_box()) {
    uint32_t t = header.next_box_type();
    if (t == box("ihdr")) {
      const uint8_t* p = header.read_bytes(11);
      ph.h = be32(p);
      ph.w = be32(p + 4);
      nc = (int)be16(p + 8);
      uint32_t bpc = p[10];
      have_size = true;
      if (nc == 1 && (bpc & 0x7f) > 8) {
        ph.mode = M_I16;
        have_mode = true;
      } else if (nc >= 1 && nc <= 4) {
        ph.mode = nc == 1 ? M_L : nc == 2 ? M_LA : nc == 3 ? M_RGB : M_RGBA;
        have_mode = true;
      }
    } else if (t == box("colr") && nc == 4) {
      const uint8_t* p = header.read_bytes(7);
      if (p[0] == 1 && be32(p + 3) == 12) ph.mode = M_CMYK;
    } else if (t == box("pclr") && have_mode && (ph.mode == M_L || ph.mode == M_LA)) {
      const uint8_t* p = header.read_bytes(3);
      uint32_t ne = be16(p), npc = p[2];
      const uint8_t* depths = header.read_bytes(npc);
      uint32_t maxd = 0;
      for (uint32_t i = 0; i < npc; ++i) maxd = depths[i] > maxd ? depths[i] : maxd;
      if (maxd <= 8) {
        // ImagePalette("RGBA" for 4 columns, else "RGB").getcolor of each
        // entry in turn: a new colour goes to index len(palette) // pal_len,
        // written over the bytes there or appended
        ph.pal_len = npc == 4 ? 4 : 3;
        std::vector<uint8_t>& pal = ph.palette;
        std::map<std::vector<uint8_t>, int> seen;
        for (uint32_t i = 0; i < ne; ++i) {
          const uint8_t* e = header.read_bytes(npc);
          std::vector<uint8_t> c(e, e + npc);
          if (seen.count(c)) continue;
          size_t index = pal.size() / ph.pal_len;
          if (index >= 256) fail("a pclr box of more than 256 colours (PIL refuses it)");
          seen[c] = (int)index;
          size_t at = index * ph.pal_len;
          if (at < pal.size()) {
            std::vector<uint8_t> rest;
            if (at + ph.pal_len < pal.size()) rest.assign(pal.begin() + at + ph.pal_len, pal.end());
            pal.resize(at);
            pal.insert(pal.end(), c.begin(), c.end());
            pal.insert(pal.end(), rest.begin(), rest.end());
          } else {
            pal.insert(pal.end(), c.begin(), c.end());
          }
        }
        ph.mode = ph.mode == M_L ? M_P : M_PA;
      }
    } else if (t == box("res ")) {
      PyBoxReader res = header.read_boxes();
      while (res.has_next_box()) {
        if (res.next_box_type() == box("resc")) {
          res.read_bytes(10);
          break;
        }
      }
    }
  }
  if (!have_size || !have_mode) fail("the JP2 header is malformed (PIL refuses it)");
  // the comment of a codestream box right after the header
  uint64_t at = header.d - d + header.n;   // the end of jp2h's contents
  if (at <= n && n - at >= 12 && memcmp(d + at + 4, "jp2c\xff\x4f\xff\x51", 8) == 0) {
    if (n - at < 14) fail("the SIZ marker is truncated (PIL refuses it)");
    uint32_t length = be16(d + at + 12);
    pil_parse_comment(d, n, at + 12 + length);
  }
  return ph;
}

// ImageFile's check of the size (Image.open's decompression-bomb check is
// utils/io.py's, on the size this library reports)
void pil_size_checks(const PilHeader& ph) {
  if (ph.w <= 0 || ph.h <= 0) fail("an image of zero or negative size (PIL refuses it)");
}

// ------------------------------------------------------------------ codestream parameters

enum Prog { LRCP = 0, RLCP, RPCL, PCRL, CPRL, PROG_UNKNOWN = -1 };
constexpr uint32_t kMaxRes = 33, kMaxBands = 3 * kMaxRes - 2;
enum : uint32_t {
  CBLK_LAZY = 1, CBLK_RESET = 2, CBLK_TERMALL = 4, CBLK_VSC = 8, CBLK_PTERM = 16,
  CBLK_SEGSYM = 32, CBLK_HT = 64, CBLK_HTMIXED = 128
};

struct StepSize {
  int32_t expn = 0, mant = 0;
};

struct TCCP {
  uint32_t csty = 0, numres = 0, cblkw = 0, cblkh = 0, cblksty = 0, qmfbid = 0;
  uint32_t prcw[kMaxRes] = {}, prch[kMaxRes] = {};
  uint32_t qntsty = 0, numgbits = 0;
  StepSize steps[kMaxBands];
  uint32_t roishift = 0;
  int32_t dc_shift = 0;
};

struct Poc {
  uint32_t resno0 = 0, compno0 = 0, layno1 = 0, resno1 = 0, compno1 = 0;
  int prg = 0;
};

struct TCP {
  uint32_t csty = 0;
  int prg = 0;
  uint32_t numlayers = 0, mct = 0;
  std::vector<TCCP> tccps;
  bool cod = false, POC = false;
  std::vector<Poc> pocs;
  bool ppt = false;
  std::map<uint32_t, std::vector<uint8_t>> ppt_markers;
  std::vector<uint8_t> ppt_data;
  uint32_t ppt_pos = 0, ppt_len = 0;
  std::vector<uint8_t> data;
  bool has_data = false;
  int32_t cur_tp = -1;
  uint32_t nb_tp = 0;
};

struct ImgComp {
  uint32_t dx = 1, dy = 1, prec = 0;
  bool sgnd = false;
  uint32_t resno_decoded = 0;
};

enum : uint32_t {
  ST_MHSOC = 1, ST_MHSIZ = 2, ST_MH = 4, ST_TPHSOT = 8, ST_TPH = 16, ST_NEOC = 64,
  ST_DATA = 128, ST_EOC = 256
};

enum : uint32_t {
  MS_SOC = 0xff4f, MS_SOT = 0xff90, MS_SOD = 0xff93, MS_EOC = 0xffd9, MS_CAP = 0xff50,
  MS_SIZ = 0xff51, MS_COD = 0xff52, MS_COC = 0xff53, MS_CPF = 0xff59, MS_RGN = 0xff5e,
  MS_QCD = 0xff5c, MS_QCC = 0xff5d, MS_POC = 0xff5f, MS_TLM = 0xff55, MS_PLM = 0xff57,
  MS_PLT = 0xff58, MS_PPM = 0xff60, MS_PPT = 0xff61, MS_SOP = 0xff91, MS_EPH = 0xff92,
  MS_CRG = 0xff63, MS_COM = 0xff64, MS_CBD = 0xff78, MS_MCC = 0xff75, MS_MCT = 0xff74,
  MS_MCO = 0xff77
};

// the states in which OpenJPEG's table lets each marker appear (0: not
// known, handled as an unknown marker)
uint32_t marker_states(uint32_t m, bool* known) {
  *known = true;
  switch (m) {
    case MS_SOT: return ST_MH | ST_TPHSOT;
    case MS_COD: case MS_COC: case MS_RGN: case MS_QCD: case MS_QCC: case MS_POC:
    case MS_COM: case MS_MCT: case MS_MCC: case MS_MCO:
      return ST_MH | ST_TPH;
    case MS_SIZ: return ST_MHSIZ;
    case MS_TLM: case MS_PLM: case MS_PPM: case MS_CRG: case MS_CBD: case MS_CAP:
    case MS_CPF:
      return ST_MH;
    case MS_PLT: case MS_PPT: return ST_TPH;
    case MS_SOP: return 0;
    default:
      *known = false;
      return ST_MH | ST_TPH;
  }
}

struct J2K {
  // image
  uint32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0, numcomps = 0;
  std::vector<ImgComp> comps;
  int color_space = 0;   // OPJ_CLRSPC_*: -1 unknown, 0 unspecified, 1 sRGB, 2 grey, 3 sYCC, 4 eYCC, 5 CMYK
  // tiling
  uint32_t tx0 = 0, ty0 = 0, tdx = 0, tdy = 0, tw = 0, th = 0;
  uint32_t ihdr_w = 0, ihdr_h = 0;
  TCP def;
  std::vector<TCP> tcps;
  // PPM
  bool ppm = false;
  std::map<uint32_t, std::vector<uint8_t>> ppm_markers;
  std::vector<uint8_t> ppm_data;
  uint32_t ppm_pos = 0, ppm_len = 0;
  // decoder state
  uint32_t state = ST_MHSOC;
  uint32_t cur_tile = 0;
  bool can_decode = false, last_tile_part = false, tp_correction_checked = false;
  uint32_t tp_correction = 0;
  uint32_t sot_length = 0;
  TCP& tcp_for_state() { return state == ST_TPH ? tcps[cur_tile] : def; }
};

// ------------------------------------------------------------------ marker segments

void read_siz(J2K& j, const uint8_t* p, uint32_t size) {
  if (size < 36) fail("the SIZ marker is malformed");
  uint32_t rem = size - 36;
  if (rem % 3) fail("the SIZ marker is malformed");
  uint32_t nb = rem / 3;
  j.x1 = be32(p + 2);
  j.y1 = be32(p + 6);
  j.x0 = be32(p + 10);
  j.y0 = be32(p + 14);
  j.tdx = be32(p + 18);
  j.tdy = be32(p + 22);
  j.tx0 = be32(p + 26);
  j.ty0 = be32(p + 30);
  uint32_t csiz = be16(p + 34);
  if (csiz >= 16385 || csiz == 0) fail("the SIZ marker's Csiz is illegal");
  j.numcomps = csiz;
  if (nb != csiz) fail("the SIZ marker's component count disagrees with its length");
  if (j.x0 >= j.x1 || j.y0 >= j.y1) fail("an image of zero or negative size");
  if (j.tdx == 0 || j.tdy == 0) fail("a tile of zero size");
  uint32_t tx1 = uint_adds(j.tx0, j.tdx), ty1 = uint_adds(j.ty0, j.tdy);
  if (j.tx0 > j.x0 || j.ty0 > j.y0 || tx1 <= j.x0 || ty1 <= j.y0)
    fail("an illegal tile offset");
  uint32_t siz_w = j.x1 - j.x0, siz_h = j.y1 - j.y0;
  if (j.ihdr_w > 0 && j.ihdr_h > 0 && (j.ihdr_w != siz_w || j.ihdr_h != siz_h))
    fail("the ihdr box's size is not the codestream's");
  j.comps.assign(csiz, ImgComp());
  for (uint32_t i = 0; i < csiz; ++i) {
    const uint8_t* c = p + 36 + 3 * i;
    ImgComp& ic = j.comps[i];
    ic.prec = (c[0] & 0x7f) + 1;
    ic.sgnd = c[0] >> 7;
    ic.dx = c[1];
    ic.dy = c[2];
    if (ic.dx < 1 || ic.dy < 1) fail("a component subsampling factor of 0");
    if (ic.prec > 31) fail("a component precision of %u bits (OpenJPEG reads 1 to 31)", ic.prec);
  }
  j.tw = ceildiv(j.x1 - j.tx0, j.tdx);
  j.th = ceildiv(j.y1 - j.ty0, j.tdy);
  if (j.tw == 0 || j.th == 0 || j.tw > 65535 / j.th) fail("an invalid number of tiles");
  j.def = TCP();
  j.def.tccps.assign(csiz, TCCP());
  j.tcps.assign((size_t)j.tw * j.th, TCP());
  for (uint32_t i = 0; i < csiz; ++i)
    j.def.tccps[i].dc_shift = j.comps[i].sgnd ? 0 : (int32_t)(1u << (j.comps[i].prec - 1));
  j.state = ST_MH;
}

void read_spcod_spcoc(J2K& j, uint32_t compno, const uint8_t*& p, uint32_t& size) {
  TCCP& tc = j.tcp_for_state().tccps[compno];
  if (size < 5) fail("an SPcod / SPcoc element is truncated");
  tc.numres = p[0] + 1u;
  if (tc.numres > kMaxRes) fail("%u resolution levels (at most 33)", tc.numres);
  tc.cblkw = p[1] + 2u;
  tc.cblkh = p[2] + 2u;
  if (tc.cblkw > 10 || tc.cblkh > 10 || tc.cblkw + tc.cblkh > 12)
    fail("an invalid code-block size");
  tc.cblksty = p[3];
  if (tc.cblksty & CBLK_HTMIXED) fail("mixed high-throughput code-blocks (OpenJPEG refuses them)");
  if (tc.cblksty & CBLK_HT)
    fail("JPEG 2000 with high-throughput code-blocks (Part 15): no oracle file");
  tc.qmfbid = p[4];
  if (tc.qmfbid > 1) fail("an invalid wavelet transformation %u", tc.qmfbid);
  p += 5;
  size -= 5;
  if (tc.csty & 1) {
    if (size < tc.numres) fail("an SPcod / SPcoc element is truncated");
    for (uint32_t i = 0; i < tc.numres; ++i) {
      uint32_t t = p[i];
      if (i != 0 && ((t & 0xf) == 0 || (t >> 4) == 0)) fail("an invalid precinct size");
      tc.prcw[i] = t & 0xf;
      tc.prch[i] = t >> 4;
    }
    p += tc.numres;
    size -= tc.numres;
  } else {
    for (uint32_t i = 0; i < tc.numres; ++i) tc.prcw[i] = tc.prch[i] = 15;
  }
}

void read_cod(J2K& j, const uint8_t* p, uint32_t size) {
  TCP& t = j.tcp_for_state();
  if (t.cod) fail("more than one COD marker in a header");
  t.cod = true;
  if (size < 5) fail("the COD marker is truncated");
  t.csty = p[0];
  if (t.csty & ~7u) fail("an unknown Scod value in the COD marker");
  t.prg = p[1];
  if (t.prg > CPRL) t.prg = PROG_UNKNOWN;
  t.numlayers = be16(p + 2);
  if (t.numlayers < 1) fail("a COD marker with 0 layers");
  t.mct = p[4];
  if (t.mct > 1) fail("an invalid multiple component transformation");
  p += 5;
  size -= 5;
  for (uint32_t i = 0; i < j.numcomps; ++i) t.tccps[i].csty = t.csty & 1;
  read_spcod_spcoc(j, 0, p, size);
  if (size != 0) fail("the COD marker has trailing bytes");
  const TCCP& r = t.tccps[0];
  for (uint32_t i = 1; i < j.numcomps; ++i) {
    TCCP& c = t.tccps[i];
    c.numres = r.numres;
    c.cblkw = r.cblkw;
    c.cblkh = r.cblkh;
    c.cblksty = r.cblksty;
    c.qmfbid = r.qmfbid;
    memcpy(c.prcw, r.prcw, sizeof(c.prcw));
    memcpy(c.prch, r.prch, sizeof(c.prch));
  }
}

void read_coc(J2K& j, const uint8_t* p, uint32_t size) {
  TCP& t = j.tcp_for_state();
  uint32_t room = j.numcomps <= 256 ? 1 : 2;
  if (size < room + 1) fail("the COC marker is truncated");
  size -= room + 1;
  uint32_t compno = room == 1 ? p[0] : be16(p);
  p += room;
  if (compno >= j.numcomps) fail("a COC marker for component %u", compno);
  t.tccps[compno].csty = p[0];
  ++p;
  read_spcod_spcoc(j, compno, p, size);
  if (size != 0) fail("the COC marker has trailing bytes");
}

void read_sqcd_sqcc(J2K& j, uint32_t compno, const uint8_t*& p, uint32_t& size) {
  TCCP& tc = j.tcp_for_state().tccps[compno];
  if (size < 1) fail("an SQcd / SQcc element is truncated");
  size -= 1;
  uint32_t t = p[0];
  ++p;
  tc.qntsty = t & 0x1f;
  tc.numgbits = t >> 5;
  uint32_t nb;
  if (tc.qntsty == 1) nb = 1;
  else nb = tc.qntsty == 0 ? size : size / 2;
  if (tc.qntsty == 0) {
    for (uint32_t b = 0; b < nb; ++b) {
      if (b < kMaxBands) {
        tc.steps[b].expn = p[b] >> 3;
        tc.steps[b].mant = 0;
      }
    }
    p += nb;
    size -= nb;
  } else {
    if (size < 2 * nb) fail("an SQcd / SQcc element is truncated");
    for (uint32_t b = 0; b < nb; ++b) {
      uint32_t v = be16(p + 2 * b);
      if (b < kMaxBands) {
        tc.steps[b].expn = (int32_t)(v >> 11);
        tc.steps[b].mant = (int32_t)(v & 0x7ff);
      }
    }
    p += 2 * nb;
    size -= 2 * nb;
  }
  if (tc.qntsty == 1) {
    for (uint32_t b = 1; b < kMaxBands; ++b) {
      int32_t e = tc.steps[0].expn - (int32_t)((b - 1) / 3);
      tc.steps[b].expn = e > 0 ? e : 0;
      tc.steps[b].mant = tc.steps[0].mant;
    }
  }
}

void read_qcd(J2K& j, const uint8_t* p, uint32_t size) {
  read_sqcd_sqcc(j, 0, p, size);
  if (size != 0) fail("the QCD marker has trailing bytes");
  TCP& t = j.tcp_for_state();
  const TCCP& r = t.tccps[0];
  for (uint32_t i = 1; i < j.numcomps; ++i) {
    TCCP& c = t.tccps[i];
    c.qntsty = r.qntsty;
    c.numgbits = r.numgbits;
    memcpy(c.steps, r.steps, sizeof(c.steps));
  }
}

void read_qcc(J2K& j, const uint8_t* p, uint32_t size) {
  uint32_t compno;
  if (j.numcomps <= 256) {
    if (size < 1) fail("the QCC marker is truncated");
    compno = p[0];
    ++p;
    --size;
  } else {
    if (size < 2) fail("the QCC marker is truncated");
    compno = be16(p);
    p += 2;
    size -= 2;
  }
  if (compno >= j.numcomps) fail("a QCC marker for component %u", compno);
  read_sqcd_sqcc(j, compno, p, size);
  if (size != 0) fail("the QCC marker has trailing bytes");
}

void read_rgn(J2K& j, const uint8_t* p, uint32_t size) {
  uint32_t room = j.numcomps <= 256 ? 1 : 2;
  if (size != 2 + room) fail("the RGN marker is malformed");
  uint32_t compno = room == 1 ? p[0] : be16(p);
  if (compno >= j.numcomps) fail("an RGN marker for component %u", compno);
  j.tcp_for_state().tccps[compno].roishift = p[room + 1];
}

void read_poc(J2K& j, const uint8_t* p, uint32_t size) {
  TCP& t = j.tcp_for_state();
  uint32_t room = j.numcomps <= 256 ? 1 : 2;
  uint32_t chunk = 5 + 2 * room;
  uint32_t nb = size / chunk;
  if (size % chunk || nb == 0) fail("the POC marker is malformed");
  uint32_t old = t.POC ? (uint32_t)t.pocs.size() : 0;
  uint32_t total = nb + old;
  if (total >= 32) fail("too many progression order changes");
  t.pocs.resize(total);
  for (uint32_t i = old; i < total; ++i) {
    Poc& c = t.pocs[i];
    c.resno0 = p[0];
    ++p;
    c.compno0 = room == 1 ? p[0] : be16(p);
    p += room;
    c.layno1 = be16(p);
    c.layno1 = c.layno1 < t.numlayers ? c.layno1 : t.numlayers;
    p += 2;
    c.resno1 = p[0];
    ++p;
    c.compno1 = room == 1 ? p[0] : be16(p);
    p += room;
    c.prg = p[0];
    ++p;
    c.compno1 = c.compno1 < j.numcomps ? c.compno1 : j.numcomps;
  }
  t.POC = true;
}

void read_ppm(J2K& j, const uint8_t* p, uint32_t size) {
  if (size < 2) fail("the PPM marker is truncated");
  j.ppm = true;
  uint32_t z = p[0];
  if (j.ppm_markers.count(z)) fail("PPM marker %u read twice", z);
  j.ppm_markers[z] = std::vector<uint8_t>(p + 1, p + size);
}

void read_ppt(J2K& j, const uint8_t* p, uint32_t size) {
  if (size < 2) fail("the PPT marker is truncated");
  if (j.ppm) fail("a PPT marker after a PPM marker");
  TCP& t = j.tcps[j.cur_tile];
  t.ppt = true;
  uint32_t z = p[0];
  if (t.ppt_markers.count(z)) fail("PPT marker %u read twice", z);
  t.ppt_markers[z] = std::vector<uint8_t>(p + 1, p + size);
}

void read_tlm(J2K& j, const uint8_t* p, uint32_t size) {
  (void)j;
  if (size < 2) fail("the TLM marker is truncated");
  uint32_t stlm = p[1];
  uint32_t st = (stlm >> 4) & 3, sp = (stlm >> 6) & 1;
  if (st == 3) fail("the TLM marker's ST is 3");
  uint32_t quot = st + (sp ? 4 : 2);
  if ((size - 2) % quot) fail("the TLM marker is malformed");
}

void read_plm(J2K& j, const uint8_t* p, uint32_t size) {
  (void)j;
  (void)p;
  if (size < 1) fail("the PLM marker is truncated");
}

void read_plt(J2K& j, const uint8_t* p, uint32_t size) {
  (void)j;
  if (size < 1) fail("the PLT marker is truncated");
  uint32_t len = 0;
  for (uint32_t i = 1; i < size; ++i) {
    uint32_t t = p[i];
    len |= t & 0x7f;
    if (t & 0x80) len <<= 7;
    else len = 0;
  }
  if (len != 0) fail("the PLT marker is malformed");
}

void read_crg(J2K& j, const uint8_t* p, uint32_t size) {
  (void)p;
  if (size != j.numcomps * 4) fail("the CRG marker is malformed");
}

// the main-header and tile-part-header marker handlers
void handle_marker(J2K& j, uint32_t m, const uint8_t* p, uint32_t size) {
  switch (m) {
    case MS_SIZ: read_siz(j, p, size); break;
    case MS_COD: read_cod(j, p, size); break;
    case MS_COC: read_coc(j, p, size); break;
    case MS_QCD: read_qcd(j, p, size); break;
    case MS_QCC: read_qcc(j, p, size); break;
    case MS_RGN: read_rgn(j, p, size); break;
    case MS_POC: read_poc(j, p, size); break;
    case MS_PPM: read_ppm(j, p, size); break;
    case MS_PPT: read_ppt(j, p, size); break;
    case MS_TLM: read_tlm(j, p, size); break;
    case MS_PLM: read_plm(j, p, size); break;
    case MS_PLT: read_plt(j, p, size); break;
    case MS_CRG: read_crg(j, p, size); break;
    case MS_COM: break;
    case MS_MCT: case MS_MCC: case MS_MCO: case MS_CBD:
      fail("JPEG 2000 with a Part 2 multi-component transform (marker 0x%04X): no oracle file",
           m);
    case MS_CAP: case MS_CPF:
      fail("JPEG 2000 with high-throughput code-blocks (Part 15, marker 0x%04X): no oracle "
           "file", m);
    default: fail("marker 0x%04X has no handler", m);
  }
}

// opj_j2k_read_unk: skip 2 bytes at a time to the next known marker
uint32_t read_unk(J2K& j, Stream& s) {
  uint8_t b[2];
  for (;;) {
    if (s.read(b, 2) != 2) fail("the stream is too short");
    uint32_t m = be16(b);
    if (m >= 0xff00) {
      bool known;
      uint32_t st = marker_states(m, &known);
      if (!(j.state & st)) fail("marker 0x%04X is not compliant with its position", m);
      if (known) return m;
    }
  }
}

void read_main_header(J2K& j, Stream& s) {
  uint8_t b[2];
  if (s.read(b, 2) != 2 || be16(b) != MS_SOC) fail("the codestream does not start with SOC");
  j.state = ST_MHSIZ;
  if (s.read(b, 2) != 2) fail("the stream is too short");
  uint32_t m = be16(b);
  bool has_siz = false, has_cod = false, has_qcd = false;
  std::vector<uint8_t> buf;
  while (m != MS_SOT) {
    if (m < 0xff00) fail("a marker was expected (0xFF--) instead of 0x%04X", m);
    bool known;
    uint32_t st = marker_states(m, &known);
    if (!known) {
      m = read_unk(j, s);
      if (m == MS_SOT) break;
      st = marker_states(m, &known);
    }
    if (m == MS_SIZ) has_siz = true;
    if (m == MS_COD) has_cod = true;
    if (m == MS_QCD) has_qcd = true;
    if (!(j.state & st)) fail("marker 0x%04X is not compliant with its position", m);
    if (s.read(b, 2) != 2) fail("the stream is too short");
    uint32_t size = be16(b);
    if (size < 2) fail("an invalid marker size");
    size -= 2;
    buf.resize(size);
    if (s.read(buf.data(), size) != size) fail("the stream is too short");
    handle_marker(j, m, buf.data(), size);
    if (s.read(b, 2) != 2) fail("the stream is too short");
    m = be16(b);
  }
  if (!has_siz) fail("no SIZ marker in the main header");
  if (!has_cod) fail("no COD marker in the main header");
  if (!has_qcd) fail("no QCD marker in the main header");
  // opj_j2k_merge_ppm: the Nppm lengths dropped, the headers concatenated
  if (j.ppm) {
    uint32_t remaining = 0;
    for (auto& kv : j.ppm_markers) {
      const std::vector<uint8_t>& v = kv.second;
      uint32_t size = (uint32_t)v.size(), at = 0;
      if (remaining >= size) {
        j.ppm_data.insert(j.ppm_data.end(), v.begin(), v.end());
        remaining -= size;
        continue;
      }
      j.ppm_data.insert(j.ppm_data.end(), v.begin(), v.begin() + remaining);
      at = remaining;
      remaining = 0;
      while (at < size) {
        if (size - at < 4) fail("not enough bytes to read Nppm");
        uint32_t nppm = be32(v.data() + at);
        at += 4;
        if (size - at >= nppm) {
          j.ppm_data.insert(j.ppm_data.end(), v.begin() + at, v.begin() + at + nppm);
          at += nppm;
        } else {
          j.ppm_data.insert(j.ppm_data.end(), v.begin() + at, v.end());
          remaining = nppm - (size - at);
          at = size;
        }
      }
    }
    if (remaining) fail("corrupted PPM markers");
    j.ppm_len = (uint32_t)j.ppm_data.size();
  }
  // opj_j2k_copy_default_tcp_and_create_tcd
  for (TCP& t : j.tcps) {
    t = j.def;
    t.cod = false;
    t.ppt = false;
    t.ppt_markers.clear();
    t.cur_tp = -1;
  }
  j.state = ST_TPHSOT;
}

void read_sot(J2K& j, const uint8_t* p, uint32_t size) {
  if (size != 8) fail("the SOT marker is malformed");
  uint32_t tile = be16(p), tot = be32(p + 2), part = p[6], nparts = p[7];
  if (tile >= j.tw * j.th) fail("an invalid tile number %u", tile);
  TCP& t = j.tcps[tile];
  if (tot != 0 && tot < 14) {
    if (tot != 12) fail("an invalid Psot %u", tot);
  }
  if (t.cur_tp + 1 != (int32_t)part) fail("tile-part %u of tile %u is out of order", part, tile);
  ++t.cur_tp;
  j.last_tile_part = false;
  if (!tot) j.last_tile_part = true;
  if (nparts != 0) {
    nparts += j.tp_correction;
    if (t.nb_tp && part >= t.nb_tp) fail("TPsot %u is not below the tile's TNsot", part);
    if (part >= nparts) fail("TPsot %u is not below TNsot %u", part, nparts);
    t.nb_tp = nparts;
  }
  if (t.nb_tp && t.nb_tp == part + 1) j.can_decode = true;
  if (!j.last_tile_part) j.sot_length = tot - 12;
  else j.sot_length = 0;
  j.state = ST_TPH;
  j.cur_tile = tile;
}

void read_sod(J2K& j, Stream& s) {
  TCP& t = j.tcps[j.cur_tile];
  if (j.last_tile_part) {
    j.sot_length = (uint32_t)(s.left() - 2);
  } else if (j.sot_length >= 2) {
    j.sot_length -= 2;
  }
  if (j.sot_length) {
    if (j.sot_length > s.left()) fail("a tile-part runs past the end of the stream");
  }
  size_t at = t.data.size();
  t.data.resize(at + j.sot_length);
  uint32_t got = s.read(t.data.data() + at, j.sot_length);
  t.data.resize(at + got);
  if (j.sot_length) t.has_data = true;
  j.state = got != j.sot_length ? ST_NEOC : ST_TPHSOT;
}

// opj_j2k_need_nb_tile_parts_correction (TPsot == TNsot, issue 254)
bool need_tp_correction(Stream& s, uint32_t tile) {
  uint64_t back = s.pos;
  uint8_t b[10];
  bool need = false;
  for (;;) {
    if (s.read(b, 2) != 2 || be16(b) != MS_SOT) {
      s.pos = back;
      return false;
    }
    if (s.read(b, 2) != 2) fail("the stream is too short");
    if (be16(b) != 10) fail("an inconsistent SOT marker size");
    if (s.read(b, 8) != 8) fail("the stream is too short");
    uint32_t t = be16(b), tot = be32(b + 2), part = b[6], nparts = b[7];
    if (t == tile) {
      need = part == nparts;
      break;
    }
    if (tot < 14) {
      s.pos = back;
      return false;
    }
    if (s.skip(tot - 12) != (int64_t)(tot - 12)) {
      s.pos = back;
      return false;
    }
  }
  s.pos = back;
  return need;
}

// opj_j2k_read_tile_header: false when no tile is left to decode
bool read_tile_header(J2K& j, Stream& s) {
  uint32_t m = MS_SOT;
  uint32_t nb_tiles = j.tw * j.th;
  uint8_t b[2];
  std::vector<uint8_t> buf;
  if (j.state == ST_EOC) m = MS_EOC;
  else if (j.state != ST_TPHSOT) fail("the decoder is in an unexpected state");
  while (!j.can_decode && m != MS_EOC) {
    while (m != MS_SOD) {
      if (s.left() == 0) {
        j.state = ST_NEOC;
        break;
      }
      if (s.read(b, 2) != 2) fail("the stream is too short");
      uint32_t size = be16(b);
      if (size < 2) fail("an inconsistent marker size");
      if (m == 0x8080 && s.left() == 0) {
        j.state = ST_NEOC;
        break;
      }
      if ((j.state & ST_TPH) && j.sot_length != 0) {
        if (j.sot_length < size + 2) fail("Psot is less than a marker's size");
        j.sot_length -= size + 2;
      }
      size -= 2;
      bool known;
      uint32_t st = marker_states(m, &known);
      if (!(j.state & st)) fail("marker 0x%04X is not compliant with its position", m);
      buf.resize(size);
      if (s.read(buf.data(), size) != size) fail("the stream is too short");
      if (!known) fail("marker 0x%04X has no handler", m);
      if (m == MS_SOT) read_sot(j, buf.data(), size);
      else handle_marker(j, m, buf.data(), size);
      if (s.read(b, 2) != 2) fail("the stream is too short");
      m = be16(b);
    }
    if (s.left() == 0 && j.state == ST_NEOC) break;
    read_sod(j, s);
    if (j.can_decode && !j.tp_correction_checked) {
      j.tp_correction_checked = true;
      if (need_tp_correction(s, j.cur_tile)) {
        j.can_decode = false;
        j.tp_correction = 1;
        for (TCP& t : j.tcps)
          if (t.nb_tp != 0) t.nb_tp += 1;
      }
    }
    if (!j.can_decode) {
      if (s.read(b, 2) != 2) {
        if (j.cur_tile + 1 == nb_tiles) {
          uint32_t t;
          for (t = 0; t < nb_tiles; ++t)
            if (j.tcps[t].cur_tp == 0 && j.tcps[t].nb_tp == 0) break;
          if (t < nb_tiles) {
            j.cur_tile = t;
            m = MS_EOC;
            j.state = ST_EOC;
            break;
          }
        }
        fail("the stream is too short");
      }
      m = be16(b);
    }
  }
  if (m == MS_EOC && j.state != ST_EOC) {
    j.cur_tile = 0;
    j.state = ST_EOC;
  }
  if (!j.can_decode) {
    while (j.cur_tile < nb_tiles && !j.tcps[j.cur_tile].has_data) ++j.cur_tile;
    if (j.cur_tile == nb_tiles) return false;
  }
  // opj_j2k_merge_ppt
  TCP& t = j.tcps[j.cur_tile];
  if (t.ppt) {
    t.ppt_data.clear();
    for (auto& kv : t.ppt_markers)
      t.ppt_data.insert(t.ppt_data.end(), kv.second.begin(), kv.second.end());
    t.ppt_markers.clear();
    t.ppt_pos = 0;
    t.ppt_len = (uint32_t)t.ppt_data.size();
  }
  j.state |= ST_DATA;
  return true;
}

// ------------------------------------------------------------------ tile structures

struct Seg {
  uint32_t len = 0, numpasses = 0, real_num_passes = 0, maxpasses = 0, numnewpasses = 0,
           newlen = 0;
};

struct CBlk {
  int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  uint32_t numbps = 0, numlenbits = 0, numnewpasses = 0, numsegs = 0, real_num_segs = 0;
  std::vector<Seg> segs;
  std::vector<uint8_t> data;
};

struct TagTree {
  struct Node {
    int32_t parent, value, low;
  };
  std::vector<Node> nodes;
  void build(uint32_t w, uint32_t h) {
    nodes.clear();
    std::vector<uint32_t> lw, lh;
    uint32_t cw = w, ch = h, n;
    do {
      n = cw * ch;
      lw.push_back(cw);
      lh.push_back(ch);
      cw = (cw + 1) / 2;
      ch = (ch + 1) / 2;
    } while (n > 1);
    uint32_t total = 0;
    std::vector<uint32_t> base;
    for (size_t l = 0; l < lw.size(); ++l) {
      base.push_back(total);
      total += lw[l] * lh[l];
    }
    if (total == 0) return;
    nodes.assign(total, Node{-1, 999, 0});
    for (size_t l = 0; l + 1 < lw.size(); ++l)
      for (uint32_t y = 0; y < lh[l]; ++y)
        for (uint32_t x = 0; x < lw[l]; ++x)
          nodes[base[l] + y * lw[l] + x].parent =
              (int32_t)(base[l + 1] + (y / 2) * lw[l + 1] + x / 2);
  }
  void reset() {
    for (Node& nd : nodes) {
      nd.value = 999;
      nd.low = 0;
    }
  }
};

struct Prc {
  int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  uint32_t cw = 0, ch = 0;
  std::vector<CBlk> cblks;
  TagTree incl, imsb;
};

struct Band {
  uint32_t bandno = 0;
  int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  float stepsize = 0;
  int32_t numbps = 0;
  std::vector<Prc> prcs;
  bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};

struct Res {
  int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  uint32_t pw = 0, ph = 0, numbands = 0;
  Band bands[3];
};

struct TileComp {
  int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  uint32_t numres = 0;
  std::vector<Res> res;
  std::vector<int32_t> data;   // ints (5/3) or float bits (9/7)
};

struct Tile {
  int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  std::vector<TileComp> comps;
};

// opj_tcd_init_tile for decoding
void init_tile(J2K& j, uint32_t tileno, Tile& tile) {
  const TCP& tcp = j.tcps[tileno];
  uint32_t p = tileno % j.tw, q = tileno / j.tw;
  uint32_t ltx0 = j.tx0 + p * j.tdx, lty0 = j.ty0 + q * j.tdy;
  tile.x0 = (int32_t)(ltx0 > j.x0 ? ltx0 : j.x0);
  uint32_t tx1 = uint_adds(ltx0, j.tdx);
  tile.x1 = (int32_t)(tx1 < j.x1 ? tx1 : j.x1);
  if (tile.x0 < 0 || tile.x1 <= tile.x0) fail("unsupported tile X coordinates");
  tile.y0 = (int32_t)(lty0 > j.y0 ? lty0 : j.y0);
  uint32_t ty1 = uint_adds(lty0, j.tdy);
  tile.y1 = (int32_t)(ty1 < j.y1 ? ty1 : j.y1);
  if (tile.y0 < 0 || tile.y1 <= tile.y0) fail("unsupported tile Y coordinates");
  if (tcp.tccps[0].numres == 0) fail("a tile without resolution levels");
  tile.comps.assign(j.numcomps, TileComp());
  for (uint32_t c = 0; c < j.numcomps; ++c) {
    ImgComp& ic = j.comps[c];
    const TCCP& tc = tcp.tccps[c];
    TileComp& t = tile.comps[c];
    ic.resno_decoded = 0;
    t.x0 = (int32_t)ceildiv((uint32_t)tile.x0, ic.dx);
    t.y0 = (int32_t)ceildiv((uint32_t)tile.y0, ic.dy);
    t.x1 = (int32_t)ceildiv((uint32_t)tile.x1, ic.dx);
    t.y1 = (int32_t)ceildiv((uint32_t)tile.y1, ic.dy);
    t.numres = tc.numres;
    if (t.numres == 0) fail("a tile-component without resolution levels");
    t.res.assign(t.numres, Res());
    uint64_t area = (uint64_t)(t.x1 - t.x0) * (uint64_t)(t.y1 - t.y0);
    if (area > ((uint64_t)1 << 31)) fail("a tile of %llu samples", (unsigned long long)area);
    uint32_t band_idx = 0;
    for (uint32_t r = 0; r < t.numres; ++r) {
      Res& R = t.res[r];
      int32_t lev = (int32_t)(t.numres - r - 1);
      R.x0 = int_ceildivpow2(t.x0, lev);
      R.y0 = int_ceildivpow2(t.y0, lev);
      R.x1 = int_ceildivpow2(t.x1, lev);
      R.y1 = int_ceildivpow2(t.y1, lev);
      uint32_t pdx = tc.prcw[r], pdy = tc.prch[r];
      int32_t tlx = int_floordivpow2(R.x0, (int32_t)pdx) << pdx;
      int32_t tly = int_floordivpow2(R.y0, (int32_t)pdy) << pdy;
      uint64_t brx = (uint64_t)(uint32_t)int_ceildivpow2(R.x1, (int32_t)pdx) << pdx;
      uint64_t bry = (uint64_t)(uint32_t)int_ceildivpow2(R.y1, (int32_t)pdy) << pdy;
      if (brx > 0x7fffffff || bry > 0x7fffffff) fail("an integer overflow in the precinct grid");
      R.pw = R.x0 == R.x1 ? 0 : (uint32_t)(((int32_t)brx - tlx) >> pdx);
      R.ph = R.y0 == R.y1 ? 0 : (uint32_t)(((int32_t)bry - tly) >> pdy);
      uint64_t nprec = (uint64_t)R.pw * R.ph;
      if (nprec > ((uint64_t)1 << 24)) fail("%llu precincts in a resolution",
                                            (unsigned long long)nprec);
      int32_t cbgx, cbgy;
      uint32_t cbgw, cbgh;
      if (r == 0) {
        cbgx = tlx;
        cbgy = tly;
        cbgw = pdx;
        cbgh = pdy;
        R.numbands = 1;
      } else {
        cbgx = int_ceildivpow2(tlx, 1);
        cbgy = int_ceildivpow2(tly, 1);
        cbgw = pdx - 1;
        cbgh = pdy - 1;
        R.numbands = 3;
      }
      uint32_t cbw = tc.cblkw < cbgw ? tc.cblkw : cbgw;
      uint32_t cbh = tc.cblkh < cbgh ? tc.cblkh : cbgh;
      for (uint32_t bi = 0; bi < R.numbands; ++bi, ++band_idx) {
        Band& B = R.bands[bi];
        if (r == 0) {
          B.bandno = 0;
          B.x0 = int_ceildivpow2(t.x0, lev);
          B.y0 = int_ceildivpow2(t.y0, lev);
          B.x1 = int_ceildivpow2(t.x1, lev);
          B.y1 = int_ceildivpow2(t.y1, lev);
        } else {
          B.bandno = bi + 1;
          int64_t x0b = B.bandno & 1, y0b = B.bandno >> 1;
          B.x0 = int64_ceildivpow2(t.x0 - (x0b << lev), lev + 1);
          B.y0 = int64_ceildivpow2(t.y0 - (y0b << lev), lev + 1);
          B.x1 = int64_ceildivpow2(t.x1 - (x0b << lev), lev + 1);
          B.y1 = int64_ceildivpow2(t.y1 - (y0b << lev), lev + 1);
        }
        const StepSize& ss = tc.steps[band_idx < kMaxBands ? band_idx : kMaxBands - 1];
        int32_t log2_gain = tc.qmfbid == 0 ? 0 : B.bandno == 0 ? 0 : B.bandno == 3 ? 2 : 1;
        int32_t Rb = (int32_t)j.comps[c].prec + log2_gain;
        B.stepsize = (float)((1.0 + ss.mant / 2048.0) * std::pow(2.0, (int32_t)(Rb - ss.expn)));
        B.numbps = ss.expn + (int32_t)tc.numgbits - 1;
        B.prcs.assign((size_t)nprec, Prc());
        for (uint32_t pn = 0; pn < nprec; ++pn) {
          Prc& P = B.prcs[pn];
          int32_t cx = cbgx + (int32_t)(pn % R.pw) * (1 << cbgw);
          int32_t cy = cbgy + (int32_t)(pn / R.pw) * (1 << cbgh);
          int32_t cxe = cx + (1 << cbgw), cye = cy + (1 << cbgh);
          P.x0 = cx > B.x0 ? cx : B.x0;
          P.y0 = cy > B.y0 ? cy : B.y0;
          P.x1 = cxe < B.x1 ? cxe : B.x1;
          P.y1 = cye < B.y1 ? cye : B.y1;
          int32_t tcx = int_floordivpow2(P.x0, (int32_t)cbw) << cbw;
          int32_t tcy = int_floordivpow2(P.y0, (int32_t)cbh) << cbh;
          int32_t bcx = int_ceildivpow2(P.x1, (int32_t)cbw) << cbw;
          int32_t bcy = int_ceildivpow2(P.y1, (int32_t)cbh) << cbh;
          P.cw = (uint32_t)((bcx - tcx) >> cbw);
          P.ch = (uint32_t)((bcy - tcy) >> cbh);
          uint64_t ncb = (uint64_t)P.cw * P.ch;
          if (ncb > ((uint64_t)1 << 24)) fail("%llu code-blocks in a precinct",
                                              (unsigned long long)ncb);
          P.cblks.assign((size_t)ncb, CBlk());
          for (uint32_t k = 0; k < ncb; ++k) {
            CBlk& cb = P.cblks[k];
            int32_t bx = tcx + (int32_t)(k % P.cw) * (1 << cbw);
            int32_t by = tcy + (int32_t)(k / P.cw) * (1 << cbh);
            int32_t bxe = bx + (1 << cbw), bye = by + (1 << cbh);
            cb.x0 = bx > P.x0 ? bx : P.x0;
            cb.y0 = by > P.y0 ? by : P.y0;
            cb.x1 = bxe < P.x1 ? bxe : P.x1;
            cb.y1 = bye < P.y1 ? bye : P.y1;
          }
          P.incl.build(P.cw, P.ch);
          P.imsb.build(P.cw, P.ch);
        }
      }
    }
    t.data.assign((size_t)area, 0);
  }
}

// ------------------------------------------------------------------ tier 2

struct Bio {
  const uint8_t *start, *bp, *end;
  uint32_t buf = 0, ct = 0;
  Bio(const uint8_t* p, uint32_t len) : start(p), bp(p), end(p + len) {}
  bool bytein() {
    buf = (buf << 8) & 0xffff;
    ct = buf == 0xff00 ? 7 : 8;
    if (bp >= end) return false;
    buf |= *bp++;
    return true;
  }
  uint32_t getbit() {
    if (ct == 0) bytein();
    --ct;
    return (buf >> ct) & 1;
  }
  uint32_t read(uint32_t n) {
    uint32_t v = 0;
    for (uint32_t i = n - 1; i < n; --i) v |= getbit() << i;
    return v;
  }
  bool inalign() {
    ct = 0;
    if ((buf & 0xff) == 0xff) return bytein();
    return true;
  }
  uint32_t numbytes() const { return (uint32_t)(bp - start); }
};

uint32_t tgt_decode(Bio& bio, TagTree& tree, uint32_t leaf, int32_t threshold) {
  int32_t stk[32];
  int n = 0;
  int32_t node = (int32_t)leaf;
  while (tree.nodes[node].parent >= 0) {
    stk[n++] = node;
    node = tree.nodes[node].parent;
  }
  int32_t low = 0;
  for (;;) {
    TagTree::Node& nd = tree.nodes[node];
    if (low > nd.low) nd.low = low;
    else low = nd.low;
    while (low < threshold && low < nd.value) {
      if (bio.read(1)) nd.value = low;
      else ++low;
    }
    nd.low = low;
    if (n == 0) break;
    node = stk[--n];
  }
  return tree.nodes[node].value < threshold ? 1 : 0;
}

uint32_t getnumpasses(Bio& bio) {
  uint32_t n;
  if (!bio.read(1)) return 1;
  if (!bio.read(1)) return 2;
  if ((n = bio.read(2)) != 3) return 3 + n;
  if ((n = bio.read(5)) != 31) return 6 + n;
  return 37 + bio.read(7);
}

uint32_t floorlog2(uint32_t a) {
  uint32_t l = 0;
  while (a > 1) {
    a >>= 1;
    ++l;
  }
  return l;
}

void init_seg(CBlk& cb, uint32_t index, uint32_t cblksty, bool first) {
  if (cb.segs.size() < index + 1) cb.segs.resize(index + 1);
  Seg& s = cb.segs[index];
  s = Seg();
  if (cblksty & CBLK_TERMALL) {
    s.maxpasses = 1;
  } else if (cblksty & CBLK_LAZY) {
    if (first) s.maxpasses = 10;
    else s.maxpasses = (cb.segs[index - 1].maxpasses == 1 || cb.segs[index - 1].maxpasses == 10)
                           ? 2 : 1;
  } else {
    s.maxpasses = 109;
  }
}

struct PacketPos {
  uint32_t layno, resno, compno, precno;
};

// opj_t2_read_packet_header + opj_t2_read_packet_data; returns the bytes
// the packet took of the tile's data
uint32_t decode_packet(J2K& j, TCP& tcp, Tile& tile, const PacketPos& pp, const uint8_t* src,
                       uint32_t max_len) {
  Res& res = tile.comps[pp.compno].res[pp.resno];
  uint32_t cblksty = tcp.tccps[pp.compno].cblksty;
  if (pp.layno == 0) {
    for (uint32_t b = 0; b < res.numbands; ++b) {
      Band& B = res.bands[b];
      if (B.empty()) continue;
      if (pp.precno >= B.prcs.size()) fail("an invalid precinct");
      Prc& P = B.prcs[pp.precno];
      P.incl.reset();
      P.imsb.reset();
      for (CBlk& cb : P.cblks) {
        cb.numsegs = 0;
        cb.real_num_segs = 0;
      }
    }
  }
  const uint8_t* cur = src;
  if (tcp.csty & 2) {   // SOP
    if (max_len >= 6 && cur[0] == 0xff && cur[1] == 0x91) cur += 6;
  }
  const uint8_t* hdr_start;
  uint32_t* mod_len;
  uint32_t remaining_len;
  uint32_t* hdr_pos = nullptr;
  if (j.ppm) {
    hdr_start = j.ppm_data.data() + j.ppm_pos;
    mod_len = &j.ppm_len;
    hdr_pos = &j.ppm_pos;
  } else if (tcp.ppt) {
    hdr_start = tcp.ppt_data.data() + tcp.ppt_pos;
    mod_len = &tcp.ppt_len;
    hdr_pos = &tcp.ppt_pos;
  } else {
    hdr_start = cur;
    remaining_len = (uint32_t)(src + max_len - cur);
    mod_len = &remaining_len;
  }
  Bio bio(hdr_start, *mod_len);
  const uint8_t* hdr = hdr_start;
  bool present = bio.read(1);
  if (present) {
    for (uint32_t b = 0; b < res.numbands; ++b) {
      Band& B = res.bands[b];
      if (B.empty()) continue;
      Prc& P = B.prcs[pp.precno];
      for (uint32_t k = 0; k < P.cblks.size(); ++k) {
        CBlk& cb = P.cblks[k];
        uint32_t included;
        if (!cb.numsegs) included = tgt_decode(bio, P.incl, k, (int32_t)(pp.layno + 1));
        else included = bio.read(1);
        if (!included) {
          cb.numnewpasses = 0;
          continue;
        }
        if (!cb.numsegs) {
          uint32_t i = 0;
          while (!tgt_decode(bio, P.imsb, k, (int32_t)i)) ++i;
          cb.numbps = (uint32_t)B.numbps + 1 - i;
          cb.numlenbits = 3;
        }
        cb.numnewpasses = getnumpasses(bio);
        uint32_t inc = 0;
        while (bio.read(1)) ++inc;
        cb.numlenbits += inc;
        uint32_t segno = 0;
        if (!cb.numsegs) {
          init_seg(cb, 0, cblksty, true);
        } else {
          segno = cb.numsegs - 1;
          if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
            ++segno;
            init_seg(cb, segno, cblksty, false);
          }
        }
        int32_t n = (int32_t)cb.numnewpasses;
        do {
          Seg& s = cb.segs[segno];
          int32_t room = (int32_t)(s.maxpasses - s.numpasses);
          s.numnewpasses = (uint32_t)(room < n ? room : n);
          uint32_t bits = cb.numlenbits + floorlog2(s.numnewpasses);
          if (bits > 32) fail("a segment length of %u bits", bits);
          s.newlen = bio.read(bits);
          n -= (int32_t)s.numnewpasses;
          if (n > 0) {
            ++segno;
            init_seg(cb, segno, cblksty, false);
          }
        } while (n > 0);
      }
    }
    if (!bio.inalign()) fail("a packet header ends inside a stuffed byte");
  } else {
    bio.inalign();
  }
  hdr += bio.numbytes();
  if (tcp.csty & 4) {   // EPH
    // OpenJPEG's strict mode (PIL's) fails where the marker is missing
    if (*mod_len - (uint32_t)(hdr - hdr_start) < 2 || hdr[0] != 0xff || hdr[1] != 0x92)
      fail("a packet header without its EPH marker");
    hdr += 2;
  }
  uint32_t hlen = (uint32_t)(hdr - hdr_start);
  *mod_len -= hlen;
  if (hdr_pos) *hdr_pos += hlen;
  else cur += hlen;
  if (!present) return (uint32_t)(cur - src);
  // the packet body
  uint32_t body_max = max_len - (uint32_t)(cur - src);
  const uint8_t* body = cur;
  const uint8_t* dat = body;
  for (uint32_t b = 0; b < res.numbands; ++b) {
    Band& B = res.bands[b];
    if (B.empty()) continue;
    Prc& P = B.prcs[pp.precno];
    for (CBlk& cb : P.cblks) {
      if (!cb.numnewpasses) continue;
      uint32_t si;
      if (!cb.numsegs) {
        si = 0;
        ++cb.numsegs;
      } else {
        si = cb.numsegs - 1;
        if (cb.segs[si].numpasses == cb.segs[si].maxpasses) {
          ++si;
          ++cb.numsegs;
        }
      }
      do {
        if (si >= cb.segs.size()) fail("a code-block segment out of range");
        Seg& s = cb.segs[si];
        if ((uint64_t)(dat - body) + s.newlen > body_max)
          fail("a code-block segment runs past its packet's data");
        cb.data.insert(cb.data.end(), dat, dat + s.newlen);
        dat += s.newlen;
        s.len += s.newlen;
        s.numpasses += s.numnewpasses;
        cb.numnewpasses -= s.numnewpasses;
        s.real_num_passes = s.numpasses;
        if (cb.numnewpasses > 0) {
          ++si;
          ++cb.numsegs;
        }
      } while (cb.numnewpasses > 0);
      cb.real_num_segs = cb.numsegs;
    }
  }
  return (uint32_t)(cur - src) + (uint32_t)(dat - body);
}

// OpenJPEG's packet iterator (pi.c), one packet at a time
struct PiComp {
  uint32_t dx, dy, numres;
  std::vector<uint32_t> pdx, pdy, pw, ph;
};

template <class F>
void for_each_packet(J2K& j, const TCP& tcp, const Tile& tile, F&& fn) {
  uint32_t nc = j.numcomps;
  std::vector<PiComp> comps(nc);
  uint32_t max_res = 0, max_prec = 0;
  for (uint32_t c = 0; c < nc; ++c) {
    PiComp& pc = comps[c];
    const TCCP& tc = tcp.tccps[c];
    pc.dx = j.comps[c].dx;
    pc.dy = j.comps[c].dy;
    pc.numres = tc.numres;
    if (tc.numres > max_res) max_res = tc.numres;
    uint32_t tcx0 = ceildiv((uint32_t)tile.x0, pc.dx), tcy0 = ceildiv((uint32_t)tile.y0, pc.dy);
    uint32_t tcx1 = ceildiv((uint32_t)tile.x1, pc.dx), tcy1 = ceildiv((uint32_t)tile.y1, pc.dy);
    for (uint32_t r = 0; r < tc.numres; ++r) {
      uint32_t lev = tc.numres - 1 - r;
      uint32_t pdx = tc.prcw[r], pdy = tc.prch[r];
      uint32_t rx0 = (uint32_t)int_ceildivpow2((int32_t)tcx0, (int32_t)lev);
      uint32_t ry0 = (uint32_t)int_ceildivpow2((int32_t)tcy0, (int32_t)lev);
      uint32_t rx1 = (uint32_t)int_ceildivpow2((int32_t)tcx1, (int32_t)lev);
      uint32_t ry1 = (uint32_t)int_ceildivpow2((int32_t)tcy1, (int32_t)lev);
      uint32_t px0 = (rx0 >> pdx) << pdx, py0 = (ry0 >> pdy) << pdy;
      uint32_t px1 = (uint32_t)(((uint64_t)rx1 + (1u << pdx) - 1) >> pdx) << pdx;
      uint32_t py1 = (uint32_t)(((uint64_t)ry1 + (1u << pdy) - 1) >> pdy) << pdy;
      uint32_t pw = rx0 == rx1 ? 0 : (px1 - px0) >> pdx;
      uint32_t ph = ry0 == ry1 ? 0 : (py1 - py0) >> pdy;
      pc.pdx.push_back(pdx);
      pc.pdy.push_back(pdy);
      pc.pw.push_back(pw);
      pc.ph.push_back(ph);
      if ((uint64_t)pw * ph > max_prec) max_prec = pw * ph;
    }
  }
  uint64_t step_p = 1, step_c = (uint64_t)max_prec * step_p, step_r = (uint64_t)nc * step_c,
           step_l = (uint64_t)max_res * step_r;
  uint64_t include_size = ((uint64_t)tcp.numlayers + 1) * step_l;
  if (include_size > ((uint64_t)1 << 28)) fail("too many packets in a tile");
  std::vector<uint8_t> include((size_t)include_size, 0);
  uint32_t tx0 = (uint32_t)tile.x0, ty0 = (uint32_t)tile.y0, tx1 = (uint32_t)tile.x1,
           ty1 = (uint32_t)tile.y1;
  uint32_t npocs = tcp.POC ? (uint32_t)tcp.pocs.size() : 1;
  for (uint32_t pino = 0; pino < npocs; ++pino) {
    Poc poc;
    if (tcp.POC) {
      const Poc& src = tcp.pocs[pino];
      poc = src;
      poc.layno1 = src.layno1 < tcp.numlayers ? src.layno1 : tcp.numlayers;
    } else {
      poc.prg = tcp.prg;
      poc.resno0 = 0;
      poc.compno0 = 0;
      poc.resno1 = max_res;
      poc.compno1 = nc;
      poc.layno1 = tcp.numlayers;
    }
    if (poc.prg == PROG_UNKNOWN) fail("an unknown progression order");
    if (poc.compno0 >= nc || poc.compno1 >= nc + 1) continue;
    // returns false to end this progression (OpenJPEG's "invalid access")
    auto visit = [&](uint32_t l, uint32_t r, uint32_t c, uint32_t p) -> bool {
      uint64_t index = l * step_l + r * step_r + c * step_c + p * step_p;
      if (index >= include_size) return false;
      if (!include[index]) {
        include[index] = 1;
        fn(PacketPos{l, r, c, p});
      }
      return true;
    };
    auto pos_dxdy = [&](uint32_t c0, uint32_t c1, uint32_t& dx, uint32_t& dy) {
      dx = dy = 0;
      for (uint32_t c = c0; c < c1; ++c) {
        const PiComp& pc = comps[c];
        for (uint32_t r = 0; r < pc.numres; ++r) {
          uint32_t sx = pc.pdx[r] + pc.numres - 1 - r, sy = pc.pdy[r] + pc.numres - 1 - r;
          if (sx < 32 && pc.dx <= 0xffffffffu / (1u << sx)) {
            uint32_t v = pc.dx * (1u << sx);
            dx = !dx ? v : (dx < v ? dx : v);
          }
          if (sy < 32 && pc.dy <= 0xffffffffu / (1u << sy)) {
            uint32_t v = pc.dy * (1u << sy);
            dy = !dy ? v : (dy < v ? dy : v);
          }
        }
      }
    };
    // the precinct of (x, y) at (c, r), or -1 when the position is none of its
    auto prec_at = [&](uint32_t c, uint32_t r, uint32_t x, uint32_t y) -> int64_t {
      const PiComp& pc = comps[c];
      uint32_t lev = pc.numres - 1 - r;
      if ((uint32_t)(((uint64_t)pc.dx << lev) >> lev) != pc.dx ||
          (uint32_t)(((uint64_t)pc.dy << lev) >> lev) != pc.dy)
        return -1;
      uint32_t trx0 = ceildiv64(tx0, (uint64_t)pc.dx << lev);
      uint32_t try0 = ceildiv64(ty0, (uint64_t)pc.dy << lev);
      uint32_t trx1 = ceildiv64(tx1, (uint64_t)pc.dx << lev);
      uint32_t try1 = ceildiv64(ty1, (uint64_t)pc.dy << lev);
      uint32_t rpx = pc.pdx[r] + lev, rpy = pc.pdy[r] + lev;
      if (rpx >= 64 || rpy >= 64 ||
          (uint32_t)(((uint64_t)pc.dx << rpx) >> rpx) != pc.dx ||
          (uint32_t)(((uint64_t)pc.dy << rpy) >> rpy) != pc.dy)
        return -1;
      if (!(((uint64_t)y % ((uint64_t)pc.dy << rpy) == 0) ||
            (y == ty0 && (((uint64_t)try0 << lev) % ((uint64_t)1 << rpy)))))
        return -1;
      if (!(((uint64_t)x % ((uint64_t)pc.dx << rpx) == 0) ||
            (x == tx0 && (((uint64_t)trx0 << lev) % ((uint64_t)1 << rpx)))))
        return -1;
      if (pc.pw[r] == 0 || pc.ph[r] == 0) return -1;
      if (trx0 == trx1 || try0 == try1) return -1;
      uint32_t prci = (ceildiv64(x, (uint64_t)pc.dx << lev) >> pc.pdx[r]) - (trx0 >> pc.pdx[r]);
      uint32_t prcj = (ceildiv64(y, (uint64_t)pc.dy << lev) >> pc.pdy[r]) - (try0 >> pc.pdy[r]);
      return (int64_t)prci + (int64_t)prcj * pc.pw[r];
    };
    switch (poc.prg) {
      case LRCP:
        for (uint32_t l = 0; l < poc.layno1; ++l)
          for (uint32_t r = poc.resno0; r < poc.resno1; ++r)
            for (uint32_t c = poc.compno0; c < poc.compno1; ++c) {
              if (r >= comps[c].numres) continue;
              uint32_t np = comps[c].pw[r] * comps[c].ph[r];
              for (uint32_t p = 0; p < np; ++p)
                if (!visit(l, r, c, p)) goto next_poc;
            }
        break;
      case RLCP:
        for (uint32_t r = poc.resno0; r < poc.resno1; ++r)
          for (uint32_t l = 0; l < poc.layno1; ++l)
            for (uint32_t c = poc.compno0; c < poc.compno1; ++c) {
              if (r >= comps[c].numres) continue;
              uint32_t np = comps[c].pw[r] * comps[c].ph[r];
              for (uint32_t p = 0; p < np; ++p)
                if (!visit(l, r, c, p)) goto next_poc;
            }
        break;
      case RPCL: {
        uint32_t dx, dy;
        pos_dxdy(0, nc, dx, dy);
        if (dx == 0 || dy == 0) break;
        for (uint32_t r = poc.resno0; r < poc.resno1; ++r)
          for (uint32_t y = ty0; y < ty1; y += dy - (y % dy))
            for (uint32_t x = tx0; x < tx1; x += dx - (x % dx))
              for (uint32_t c = poc.compno0; c < poc.compno1; ++c) {
                if (r >= comps[c].numres) continue;
                int64_t p = prec_at(c, r, x, y);
                if (p < 0) continue;
                for (uint32_t l = 0; l < poc.layno1; ++l)
                  if (!visit(l, r, c, (uint32_t)p)) goto next_poc;
              }
        break;
      }
      case PCRL: {
        uint32_t dx, dy;
        pos_dxdy(0, nc, dx, dy);
        if (dx == 0 || dy == 0) break;
        for (uint32_t y = ty0; y < ty1; y += dy - (y % dy))
          for (uint32_t x = tx0; x < tx1; x += dx - (x % dx))
            for (uint32_t c = poc.compno0; c < poc.compno1; ++c) {
              uint32_t rend = poc.resno1 < comps[c].numres ? poc.resno1 : comps[c].numres;
              for (uint32_t r = poc.resno0; r < rend; ++r) {
                int64_t p = prec_at(c, r, x, y);
                if (p < 0) continue;
                for (uint32_t l = 0; l < poc.layno1; ++l)
                  if (!visit(l, r, c, (uint32_t)p)) goto next_poc;
              }
            }
        break;
      }
      case CPRL:
        for (uint32_t c = poc.compno0; c < poc.compno1; ++c) {
          uint32_t dx, dy;
          pos_dxdy(c, c + 1, dx, dy);
          if (dx == 0 || dy == 0) goto next_poc;
          uint32_t rend = poc.resno1 < comps[c].numres ? poc.resno1 : comps[c].numres;
          for (uint32_t y = ty0; y < ty1; y += dy - (y % dy))
            for (uint32_t x = tx0; x < tx1; x += dx - (x % dx))
              for (uint32_t r = poc.resno0; r < rend; ++r) {
                int64_t p = prec_at(c, r, x, y);
                if (p < 0) continue;
                for (uint32_t l = 0; l < poc.layno1; ++l)
                  if (!visit(l, r, c, (uint32_t)p)) goto next_poc;
              }
        }
        break;
      default:
        break;
    }
  next_poc:;
  }
}

// ------------------------------------------------------------------ tier 1

struct MQState {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};

const MQState kMQ[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},   {0x0AC1, 4, 12, 0},
    {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},
    {0x4801, 9, 14, 0},  {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1}, {0x5401, 16, 14, 0},
    {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0},
    {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0}, {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0},
    {0x08A1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0},
    {0x0005, 45, 42, 0}, {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

enum { CTX_ZC = 0, CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18, NUM_CTX = 19 };

// the MQ decoder (and the raw one of the bypass mode) over one segment,
// which ends in the artificial 0xFF 0xFF marker OpenJPEG writes there
struct MQ {
  std::vector<uint8_t> buf;
  const uint8_t* bp = nullptr;
  uint32_t a = 0, c = 0, ct = 0;
  uint8_t st[NUM_CTX], mps[NUM_CTX];
  void reset_states() {
    memset(st, 0, sizeof(st));
    memset(mps, 0, sizeof(mps));
    st[CTX_UNI] = 46;
    st[CTX_AGG] = 3;
    st[CTX_ZC] = 4;
  }
  void load(const uint8_t* data, uint32_t len) {
    buf.assign(data, data + len);
    buf.push_back(0xff);
    buf.push_back(0xff);
    bp = buf.data();
  }
  void bytein() {
    uint32_t lc = bp[1];
    if (bp[0] == 0xff) {
      if (lc > 0x8f) {
        c += 0xff00;
        ct = 8;
      } else {
        ++bp;
        c += lc << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += lc << 8;
      ct = 8;
    }
  }
  void init(const uint8_t* data, uint32_t len) {
    load(data, len);
    c = len == 0 ? 0xffu << 16 : (uint32_t)bp[0] << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void raw_init(const uint8_t* data, uint32_t len) {
    load(data, len);
    c = 0;
    ct = 0;
  }
  inline void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (a < 0x8000);
  }
  inline uint32_t decode(int cx) {
    uint8_t& s = st[cx];
    const MQState& q = kMQ[s];
    uint32_t d;
    a -= q.qe;
    if ((c >> 16) < q.qe) {
      if (a < q.qe) {
        a = q.qe;
        d = mps[cx];
        s = q.nmps;
      } else {
        a = q.qe;
        d = 1 - mps[cx];
        if (q.sw) mps[cx] = (uint8_t)(1 - mps[cx]);
        s = q.nlps;
      }
      renorm();
    } else {
      c -= (uint32_t)q.qe << 16;
      if ((a & 0x8000) == 0) {
        if (a < q.qe) {
          d = 1 - mps[cx];
          if (q.sw) mps[cx] = (uint8_t)(1 - mps[cx]);
          s = q.nlps;
        } else {
          d = mps[cx];
          s = q.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
  inline uint32_t raw_decode() {
    if (ct == 0) {
      if (c == 0xff) {
        if (*bp > 0x8f) {
          c = 0xff;
          ct = 8;
        } else {
          c = *bp;
          ++bp;
          ct = 7;
        }
      } else {
        c = *bp;
        ++bp;
        ct = 8;
      }
    }
    --ct;
    return (c >> ct) & 1;
  }
};

// zero-coding contexts (Table D.1) by band, h, v, d
uint8_t kZC[4][3][3][5];
// sign contexts (Table D.3) by H + 1, V + 1: context and XOR bit
const uint8_t kSCctx[3][3] = {{13, 12, 11}, {10, 9, 10}, {11, 12, 13}};
const uint8_t kSCxor[3][3] = {{1, 1, 1}, {1, 0, 0}, {0, 0, 0}};

void init_zc() {
  for (int o = 0; o < 4; ++o)
    for (int h0 = 0; h0 < 3; ++h0)
      for (int v0 = 0; v0 < 3; ++v0)
        for (int d = 0; d < 5; ++d) {
          int h = h0, v = v0, n;
          if (o == 1) {   // HL: the vertical neighbours lead
            h = v0;
            v = h0;
          }
          if (o != 3) {
            if (!h) n = !v ? (!d ? 0 : d == 1 ? 1 : 2) : v == 1 ? 3 : 4;
            else if (h == 1) n = !v ? (!d ? 5 : 6) : 7;
            else n = 8;
          } else {
            int hv = h + v;
            if (!d) n = !hv ? 0 : hv == 1 ? 1 : 2;
            else if (d == 1) n = !hv ? 3 : hv == 1 ? 4 : 5;
            else if (d == 2) n = !hv ? 6 : 7;
            else n = 8;
          }
          kZC[o][h0][v0][d] = (uint8_t)(CTX_ZC + n);
        }
}

struct T1 {
  enum : uint8_t { SIG = 1, NEG = 2, PI = 4, MU = 8 };
  uint32_t w = 0, h = 0, stride = 0;
  std::vector<int32_t> data;
  std::vector<uint8_t> f;
  MQ mq;
  bool vsc = false;
  int orient = 0;

  inline bool south(uint32_t y) const { return !(vsc && (y & 3) == 3); }
  inline int zc(uint32_t i, uint32_t y) const {
    const uint8_t* p = &f[i];
    int hh = (p[-1] & SIG) + (p[1] & SIG);
    int vv = p[-(int)stride] & SIG;
    int dd = (p[-(int)stride - 1] & SIG) + (p[-(int)stride + 1] & SIG);
    if (south(y)) {
      vv += p[stride] & SIG;
      dd += (p[stride - 1] & SIG) + (p[stride + 1] & SIG);
    }
    return kZC[orient][hh][vv][dd];
  }
  inline bool any_neighbour(uint32_t i, uint32_t y) const {
    const uint8_t* p = &f[i];
    int s = (p[-1] | p[1] | p[-(int)stride] | p[-(int)stride - 1] | p[-(int)stride + 1]) & SIG;
    if (south(y)) s |= (p[stride] | p[stride - 1] | p[stride + 1]) & SIG;
    return s != 0;
  }
  static inline int contrib(uint8_t v) { return (v & SIG) ? ((v & NEG) ? -1 : 1) : 0; }
  inline uint32_t sign(uint32_t i, uint32_t y, int* x) const {
    int hs = contrib(f[i - 1]) + contrib(f[i + 1]);
    int vs = contrib(f[i - stride]) + (south(y) ? contrib(f[i + stride]) : 0);
    hs = hs < -1 ? -1 : hs > 1 ? 1 : hs;
    vs = vs < -1 ? -1 : vs > 1 ? 1 : vs;
    *x = kSCxor[hs + 1][vs + 1];
    return kSCctx[hs + 1][vs + 1];
  }
  inline void set_sig(uint32_t i, uint32_t x, uint32_t y, uint32_t neg, int32_t oneplushalf) {
    data[y * w + x] = neg ? -oneplushalf : oneplushalf;
    f[i] |= SIG | (neg ? NEG : 0);
  }

  void sigpass(int32_t bpno, bool raw) {
    int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
    for (uint32_t y0 = 0; y0 < h; y0 += 4)
      for (uint32_t x = 0; x < w; ++x)
        for (uint32_t y = y0; y < y0 + 4 && y < h; ++y) {
          uint32_t i = (y + 1) * stride + x + 1;
          if ((f[i] & (SIG | PI)) || !any_neighbour(i, y)) continue;
          if (raw) {
            if (mq.raw_decode()) set_sig(i, x, y, mq.raw_decode(), oneplushalf);
          } else if (mq.decode(zc(i, y))) {
            int xr;
            int cx = (int)sign(i, y, &xr);
            set_sig(i, x, y, mq.decode(cx) ^ (uint32_t)xr, oneplushalf);
          }
          f[i] |= PI;
        }
  }

  void refpass(int32_t bpno, bool raw) {
    int32_t one = 1 << bpno, poshalf = one >> 1;
    for (uint32_t y0 = 0; y0 < h; y0 += 4)
      for (uint32_t x = 0; x < w; ++x)
        for (uint32_t y = y0; y < y0 + 4 && y < h; ++y) {
          uint32_t i = (y + 1) * stride + x + 1;
          if ((f[i] & (SIG | PI)) != SIG) continue;
          uint32_t v;
          if (raw) {
            v = mq.raw_decode();
          } else {
            int cx = (f[i] & MU) ? CTX_MAG + 2 : any_neighbour(i, y) ? CTX_MAG + 1 : CTX_MAG;
            v = mq.decode(cx);
          }
          int32_t& d = data[y * w + x];
          d += (v ^ (uint32_t)(d < 0)) ? poshalf : -poshalf;
          f[i] |= MU;
        }
  }

  void clnpass(int32_t bpno, bool segsym) {
    int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
    for (uint32_t y0 = 0; y0 < h; y0 += 4)
      for (uint32_t x = 0; x < w; ++x) {
        uint32_t k = y0;
        if (y0 + 3 < h) {
          bool run = true;
          for (uint32_t y = y0; y < y0 + 4 && run; ++y) {
            uint32_t i = (y + 1) * stride + x + 1;
            if ((f[i] & (SIG | PI)) || any_neighbour(i, y)) run = false;
          }
          if (run) {
            if (!mq.decode(CTX_AGG)) {
              continue;   // all four stay insignificant
            }
            uint32_t pos = mq.decode(CTX_UNI) << 1;
            pos |= mq.decode(CTX_UNI);
            uint32_t y = y0 + pos, i = (y + 1) * stride + x + 1;
            int xr;
            int cx = (int)sign(i, y, &xr);
            set_sig(i, x, y, mq.decode(cx) ^ (uint32_t)xr, oneplushalf);
            k = y + 1;
          }
        }
        for (uint32_t y = k; y < y0 + 4 && y < h; ++y) {
          uint32_t i = (y + 1) * stride + x + 1;
          if (f[i] & (SIG | PI)) continue;
          if (mq.decode(zc(i, y))) {
            int xr;
            int cx = (int)sign(i, y, &xr);
            set_sig(i, x, y, mq.decode(cx) ^ (uint32_t)xr, oneplushalf);
          }
        }
        for (uint32_t y = y0; y < y0 + 4 && y < h; ++y)
          f[(y + 1) * stride + x + 1] &= (uint8_t)~PI;
      }
    if (segsym) {
      for (int n = 0; n < 4; ++n) mq.decode(CTX_UNI);
    }
  }

  // opj_t1_decode_cblk: false where OpenJPEG's fails
  bool decode(const CBlk& cb, uint32_t bandno, uint32_t roishift, uint32_t cblksty) {
    w = (uint32_t)(cb.x1 - cb.x0);
    h = (uint32_t)(cb.y1 - cb.y0);
    stride = w + 2;
    data.assign((size_t)w * h, 0);
    f.assign((size_t)stride * (h + 2), 0);
    orient = (int)bandno;
    vsc = (cblksty & CBLK_VSC) != 0;
    int32_t bpno_plus_one = (int32_t)(roishift + cb.numbps);
    if (bpno_plus_one >= 31) return false;
    uint32_t passtype = 2;
    mq.reset_states();
    uint32_t idx = 0;
    for (uint32_t segno = 0; segno < cb.real_num_segs; ++segno) {
      const Seg& seg = cb.segs[segno];
      bool raw = bpno_plus_one <= (int32_t)cb.numbps - 4 && passtype < 2 &&
                 (cblksty & CBLK_LAZY);
      if ((uint64_t)idx + seg.len > cb.data.size())
        fail("code-block segments longer than their data");
      if (raw) mq.raw_init(cb.data.data() + idx, seg.len);
      else mq.init(cb.data.data() + idx, seg.len);
      idx += seg.len;
      for (uint32_t passno = 0; passno < seg.real_num_passes && bpno_plus_one >= 1; ++passno) {
        switch (passtype) {
          case 0: sigpass(bpno_plus_one, raw); break;
          case 1: refpass(bpno_plus_one, raw); break;
          case 2: clnpass(bpno_plus_one, (cblksty & CBLK_SEGSYM) != 0); break;
        }
        if ((cblksty & CBLK_RESET) && !raw) mq.reset_states();
        if (++passtype == 3) {
          passtype = 0;
          --bpno_plus_one;
        }
      }
    }
    return true;
  }
};

// opj_t1_decode_cblks for one tile-component: every code-block decoded,
// ROI-shifted, dequantised and written into the tile-component's buffer
void t1_decode(const TCCP& tc, TileComp& t) {
  T1 t1;
  uint32_t tile_w = (uint32_t)(t.x1 - t.x0);
  for (uint32_t r = 0; r < t.numres; ++r) {
    Res& R = t.res[r];
    for (uint32_t b = 0; b < R.numbands; ++b) {
      Band& B = R.bands[b];
      for (Prc& P : B.prcs)
        for (CBlk& cb : P.cblks) {
          if (!t1.decode(cb, B.bandno, tc.roishift, tc.cblksty))
            fail("a code-block of %u bit-planes (OpenJPEG decodes at most 30)",
                 tc.roishift + cb.numbps);
          uint32_t x = (uint32_t)(cb.x0 - B.x0), y = (uint32_t)(cb.y0 - B.y0);
          if (B.bandno & 1) x += (uint32_t)(t.res[r - 1].x1 - t.res[r - 1].x0);
          if (B.bandno & 2) y += (uint32_t)(t.res[r - 1].y1 - t.res[r - 1].y0);
          uint32_t cw = t1.w, ch = t1.h;
          int32_t* d = t1.data.data();
          if (tc.roishift) {
            if (tc.roishift >= 31) {
              std::fill(t1.data.begin(), t1.data.end(), 0);
            } else {
              int32_t thresh = 1 << tc.roishift;
              for (size_t k = 0; k < (size_t)cw * ch; ++k) {
                int32_t v = d[k];
                int32_t mag = v < 0 ? -v : v;
                if (mag >= thresh) {
                  mag >>= tc.roishift;
                  d[k] = v < 0 ? -mag : mag;
                }
              }
            }
          }
          if (cw == 0 || ch == 0) continue;
          int32_t* out = t.data.data() + (size_t)y * tile_w + x;
          if (tc.qmfbid == 1) {
            for (uint32_t yy = 0; yy < ch; ++yy)
              for (uint32_t xx = 0; xx < cw; ++xx)
                out[(size_t)yy * tile_w + xx] = d[yy * cw + xx] / 2;
          } else {
            const float step = 0.5f * B.stepsize;
            for (uint32_t yy = 0; yy < ch; ++yy)
              for (uint32_t xx = 0; xx < cw; ++xx)
                out[(size_t)yy * tile_w + xx] = as_int((float)d[yy * cw + xx] * step);
          }
        }
    }
  }
}

// ------------------------------------------------------------------ wavelets

// 1-D inverse 5/3 of one line: ``v`` holds the sn low samples then the dn
// high ones; the line starts at an even (cas 0) or odd (cas 1) coordinate
void idwt53_1d(int32_t* v, size_t stride, int32_t sn, int32_t dn, int32_t cas,
               std::vector<int32_t>& x) {
  int32_t len = sn + dn;
  if (len <= 0) return;
  if (len == 1) {
    if (cas) v[0] /= 2;
    return;
  }
  x.resize((size_t)len);
  for (int32_t i = 0; i < sn; ++i) x[(size_t)(cas + 2 * i)] = v[(size_t)i * stride];
  for (int32_t i = 0; i < dn; ++i) x[(size_t)(1 - cas + 2 * i)] = v[(size_t)(sn + i) * stride];
  // symmetric extension about the first and last samples
  auto at = [&](int32_t k) -> int32_t {
    while (k < 0 || k >= len) {
      if (k < 0) k = -k;
      if (k >= len) k = 2 * (len - 1) - k;
    }
    return x[(size_t)k];
  };
  // local position k is low-pass where (k + cas) is even
  for (int32_t k = cas; k < len; k += 2) x[(size_t)k] -= (at(k - 1) + at(k + 1) + 2) >> 2;
  for (int32_t k = 1 - cas; k < len; k += 2) x[(size_t)k] += (at(k - 1) + at(k + 1)) >> 1;
  for (int32_t k = 0; k < len; ++k) v[(size_t)k * stride] = x[(size_t)k];
}

// the lifting steps' multipliers as OpenJPEG adds them (the standard's
// alpha to delta, negated), K, and OpenJPEG's 2/K for the high-pass band
const float kAlpha = 1.586134342f, kBeta = 0.052980118f, kGamma = -0.882911075f,
            kDelta = -0.443506852f, kK = 1.230174105f, kTwoInvK = 1.625732422f;

// opj_v8dwt_decode_step2 on one line: elements l and w index the
// interleaved array
void dwt97_step2(float* wv, int32_t l, int32_t w, int32_t end, int32_t m, float c) {
  int32_t imax = end < m ? end : m;
  int32_t fl = l, fw = w;
  for (int32_t i = 0; i < imax; ++i) {
    wv[fw - 1] = wv[fw - 1] + ((wv[fl] + wv[fw]) * c);
    fl = fw;
    fw += 2;
  }
  if (m < end) {
    c += c;
    wv[fw - 1] = wv[fw - 1] + wv[fl] * c;
  }
}

void idwt97_1d(float* wv, int32_t sn, int32_t dn, int32_t cas) {
  int32_t a, b;
  if (cas == 0) {
    if (!(dn > 0 || sn > 1)) return;
    a = 0;
    b = 1;
  } else {
    if (!(sn > 0 || dn > 1)) return;
    a = 1;
    b = 0;
  }
  for (int32_t i = 0; i < sn; ++i) wv[a + 2 * i] = wv[a + 2 * i] * kK;
  for (int32_t i = 0; i < dn; ++i) wv[b + 2 * i] = wv[b + 2 * i] * kTwoInvK;
  int32_t m1 = sn < dn - a ? sn : dn - a, m2 = dn < sn - b ? dn : sn - b;
  dwt97_step2(wv, b, a + 1, sn, m1, kDelta);
  dwt97_step2(wv, a, b + 1, dn, m2, kGamma);
  dwt97_step2(wv, b, a + 1, sn, m1, kBeta);
  dwt97_step2(wv, a, b + 1, dn, m2, kAlpha);
}

void idwt97_line(int32_t* v, size_t stride, int32_t sn, int32_t dn, int32_t cas,
                 std::vector<float>& x) {
  int32_t len = sn + dn;
  if (len <= 0) return;
  x.assign((size_t)len + 2, 0.f);
  for (int32_t i = 0; i < sn; ++i) x[(size_t)(cas + 2 * i)] = as_float(v[(size_t)i * stride]);
  for (int32_t i = 0; i < dn; ++i)
    x[(size_t)(1 - cas + 2 * i)] = as_float(v[(size_t)(sn + i) * stride]);
  idwt97_1d(x.data(), sn, dn, cas);
  for (int32_t k = 0; k < len; ++k) v[(size_t)k * stride] = as_int(x[(size_t)k]);
}

void dwt_decode(TileComp& t, uint32_t numres, bool real) {
  uint32_t w = (uint32_t)(t.res[t.numres - 1].x1 - t.res[t.numres - 1].x0);
  if (numres <= 1 || w == 0) return;
  const Res* tr = &t.res[0];
  int32_t rw = tr->x1 - tr->x0, rh = tr->y1 - tr->y0;
  std::vector<int32_t> xi;
  std::vector<float> xf;
  for (uint32_t r = 1; r < numres; ++r) {
    ++tr;
    int32_t hsn = rw, vsn = rh;
    rw = tr->x1 - tr->x0;
    rh = tr->y1 - tr->y0;
    int32_t hcas = tr->x0 % 2, vcas = tr->y0 % 2;
    for (int32_t y = 0; y < rh; ++y) {
      int32_t* row = t.data.data() + (size_t)y * w;
      if (real) idwt97_line(row, 1, hsn, rw - hsn, hcas, xf);
      else idwt53_1d(row, 1, hsn, rw - hsn, hcas, xi);
    }
    for (int32_t x = 0; x < rw; ++x) {
      int32_t* col = t.data.data() + x;
      if (real) idwt97_line(col, w, vsn, rh - vsn, vcas, xf);
      else idwt53_1d(col, w, vsn, rh - vsn, vcas, xi);
    }
  }
}

// ------------------------------------------------------------------ tile decode

// opj_tcd_decode_tile (T2, T1, DWT, MCT, DC shift), then
// opj_tcd_update_tile_data's packed buffer: returns its bytes
std::vector<uint8_t> decode_tile(J2K& j, uint32_t tileno, Tile& tile) {
  TCP& tcp = j.tcps[tileno];
  const std::vector<uint8_t>& src = tcp.data;
  // tier 2
  uint32_t pos = 0, max_len = (uint32_t)src.size();
  for_each_packet(j, tcp, tile, [&](const PacketPos& pp) {
    uint32_t n = decode_packet(j, tcp, tile, pp, src.data() + pos, max_len);
    ImgComp& ic = j.comps[pp.compno];
    if (pp.resno > ic.resno_decoded) ic.resno_decoded = pp.resno;
    pos += n;
    max_len -= n;
  });
  // tier 1 and the wavelets
  for (uint32_t c = 0; c < j.numcomps; ++c) t1_decode(tcp.tccps[c], tile.comps[c]);
  for (uint32_t c = 0; c < j.numcomps; ++c)
    dwt_decode(tile.comps[c], j.comps[c].resno_decoded + 1, tcp.tccps[c].qmfbid == 0);
  // the multiple component transform
  if (tcp.mct) {
    TileComp* tc = tile.comps.data();
    const Res& r0 = tc[0].res[tc[0].numres - 1];
    size_t samples = (size_t)(r0.x1 - r0.x0) * (size_t)(r0.y1 - r0.y0);
    if (j.numcomps >= 3) {
      if (tc[0].numres != tc[1].numres || tc[0].numres != tc[2].numres)
        fail("the MCT's tile-components have different dimensions");
      const Res& r1 = tc[1].res[tc[0].numres - 1];
      const Res& r2 = tc[2].res[tc[0].numres - 1];
      if (r0.x1 - r0.x0 != r1.x1 - r1.x0 || r0.y1 - r0.y0 != r1.y1 - r1.y0 ||
          r0.x1 - r0.x0 != r2.x1 - r2.x0 || r0.y1 - r0.y0 != r2.y1 - r2.y0)
        fail("the MCT's tile-components have different dimensions");
      int32_t *c0 = tc[0].data.data(), *c1 = tc[1].data.data(), *c2 = tc[2].data.data();
      if (tcp.tccps[0].qmfbid == 1) {
        for (size_t i = 0; i < samples; ++i) {
          int32_t y = c0[i], u = c1[i], v = c2[i];
          int32_t g = y - ((u + v) >> 2);
          c0[i] = v + g;
          c1[i] = g;
          c2[i] = u + g;
        }
      } else {
        for (size_t i = 0; i < samples; ++i) {
          float y = as_float(c0[i]), u = as_float(c1[i]), v = as_float(c2[i]);
          float r = y + (v * 1.402f);
          float g = y - (u * 0.34413f) - (v * 0.71414f);
          float b = y + (u * 1.772f);
          c0[i] = as_int(r);
          c1[i] = as_int(g);
          c2[i] = as_int(b);
        }
      }
    }
  }
  // the DC level shift and the clamp, then the packed tile buffer
  std::vector<uint8_t> out;
  for (uint32_t c = 0; c < j.numcomps; ++c) {
    TileComp& t = tile.comps[c];
    const ImgComp& ic = j.comps[c];
    const TCCP& tc = tcp.tccps[c];
    const Res& res = t.res[ic.resno_decoded];
    uint32_t rw = (uint32_t)(res.x1 - res.x0), rh = (uint32_t)(res.y1 - res.y0);
    uint32_t full_w = (uint32_t)(t.res[t.numres - 1].x1 - t.res[t.numres - 1].x0);
    int32_t lo, hi;
    if (ic.sgnd) {
      lo = -(1 << (ic.prec - 1));
      hi = (1 << (ic.prec - 1)) - 1;
    } else {
      lo = 0;
      hi = (int32_t)((1u << ic.prec) - 1);
    }
    uint32_t csiz = ic.prec >> 3;
    if (ic.prec & 7) ++csiz;
    if (csiz == 3) csiz = 4;
    size_t at = out.size();
    out.resize(at + (size_t)csiz * rw * rh);
    uint8_t* o = out.data() + at;
    for (uint32_t y = 0; y < rh; ++y)
      for (uint32_t x = 0; x < rw; ++x) {
        int32_t v = t.data[(size_t)y * full_w + x];
        int32_t s;
        if (tc.qmfbid == 1) {
          int32_t sum = (int32_t)((uint32_t)v + (uint32_t)tc.dc_shift);
          s = sum < lo ? lo : sum > hi ? hi : sum;
        } else {
          float fv = as_float(v);
          if (fv > 2147483648.f) {
            s = hi;
          } else if (fv < -2147483648.f) {
            s = lo;
          } else {
            int64_t iv = std::isnan(fv) ? INT64_MIN : (int64_t)lrintf(fv);
            int64_t sum = iv == INT64_MIN ? iv : iv + tc.dc_shift;
            s = (int32_t)(sum < lo ? lo : sum > hi ? hi : sum);
          }
        }
        uint32_t u = (uint32_t)s;
        for (uint32_t k = 0; k < csiz; ++k) *o++ = (uint8_t)(u >> (8 * k));
      }
  }
  return out;
}

// ------------------------------------------------------------------ Pillow's unpackers

struct PilImage {
  int mode;
  uint32_t w, h;
  std::vector<uint8_t> px;   // 1 (L, P), 2 (I;16) or 4 bytes a pixel
  uint32_t bpp;
};

int R_Cr[256], G_Cb[256], G_Cr[256], B_Cb[256];

void init_ycc() {
  for (int i = 0; i < 256; ++i) {
    R_Cr[i] = (int)(1.402 * (i - 128) * 64 + 0.5);
    G_Cb[i] = (int)(-0.34414 * (i - 128) * 64 + 0.5);
    G_Cr[i] = (int)(-0.71414 * (i - 128) * 64 + 0.5);
    B_Cb[i] = (int)(1.772 * (i - 128) * 64 + 0.5);
  }
}

inline uint8_t clip8(int v) { return v <= 0 ? 0 : v >= 255 ? 255 : (uint8_t)v; }

// the Jpeg2KDecode.c unpackers for one tile from Pillow's tile buffer
// ``buf``, whose bytes past OpenJPEG's are zeros or a larger earlier
// tile's (Pillow's row arithmetic never reads past it: checked all the same)
void unpack_tile(const J2K& j, const Tile& tile, const std::vector<uint8_t>& buf, int unpacker,
                 PilImage& im) {
  uint32_t x0 = (uint32_t)tile.x0 - j.x0, y0 = (uint32_t)tile.y0 - j.y0;
  uint32_t w = (uint32_t)(tile.x1 - tile.x0), h = (uint32_t)(tile.y1 - tile.y0);
  uint32_t nc = unpacker == 0 ? 1 : unpacker == 1 ? 2 : unpacker == 2 || unpacker == 4 ? 3 : 4;
  int shifts[4], offsets[4];
  uint32_t csiz[4], dx[4], dy[4];
  size_t cstart[4];
  size_t at = 0;
  uint32_t target = im.mode == M_I16 ? 16 : 8;
  for (uint32_t n = 0; n < nc; ++n) {
    const ImgComp& ic = j.comps[n];
    shifts[n] = (int)target - (int)ic.prec;
    offsets[n] = ic.sgnd ? 1 << (ic.prec - 1) : 0;
    csiz[n] = (ic.prec + 7) >> 3;
    if (csiz[n] == 3) csiz[n] = 4;
    if (shifts[n] < 0) offsets[n] += 1 << (-shifts[n] - 1);
    dx[n] = unpacker >= 2 ? ic.dx : 1;
    dy[n] = unpacker >= 2 ? ic.dy : 1;
    cstart[n] = at;
    at += (size_t)csiz[n] * (w / dx[n]) * (h / dy[n]);
  }
  auto word = [&](uint32_t n, size_t idx) -> uint32_t {
    size_t off = cstart[n] + idx * csiz[n];
    if (off + csiz[n] > buf.size())
      fail("a read past PIL's tile buffer");
    uint32_t v = 0;
    for (uint32_t k = 0; k < csiz[n]; ++k) v |= (uint32_t)buf[off + k] << (8 * k);
    return v;
  };
  auto shift = [&](uint32_t n, uint32_t v) -> uint32_t {
    uint32_t x = (uint32_t)offsets[n] + v;
    return shifts[n] < 0 ? x >> -shifts[n] : x << shifts[n];
  };
  for (uint32_t y = 0; y < h; ++y) {
    uint8_t* row = im.px.data() + ((size_t)(y0 + y) * im.w + x0) * im.bpp;
    if (unpacker == 0) {   // j2ku_gray_l / j2ku_gray_i
      for (uint32_t x = 0; x < w; ++x) {
        uint32_t v = shift(0, word(0, (size_t)y * w + x));
        if (im.bpp == 2) {
          row[2 * x] = (uint8_t)v;
          row[2 * x + 1] = (uint8_t)(v >> 8);
        } else {
          row[x] = (uint8_t)v;
        }
      }
    } else if (unpacker == 1) {   // j2ku_graya_la: the alpha plane after w * h samples
      size_t astart = (size_t)csiz[0] * w * h;
      for (uint32_t x = 0; x < w; ++x) {
        uint8_t l = (uint8_t)shift(0, word(0, (size_t)y * w + x));
        size_t off = astart + ((size_t)y * w + x) * csiz[1];
        if (off + csiz[1] > buf.size())
          fail("a read past PIL's tile buffer");
        uint32_t av = 0;
        for (uint32_t k = 0; k < csiz[1]; ++k) av |= (uint32_t)buf[off + k] << (8 * k);
        row[4 * x] = row[4 * x + 1] = row[4 * x + 2] = l;
        row[4 * x + 3] = (uint8_t)shift(1, av);
      }
    } else {   // j2ku_srgb_rgb, j2ku_sycc_rgb, j2ku_srgba_rgba, j2ku_sycca_rgba
      for (uint32_t x = 0; x < w; ++x) {
        for (uint32_t n = 0; n < nc; ++n)
          row[4 * x + n] = (uint8_t)shift(
              n, word(n, (size_t)(y / dy[n]) * (w / dx[n]) + x / dx[n]));
        if (nc == 3) row[4 * x + 3] = 0xff;
      }
      if (unpacker == 4 || unpacker == 5) {   // ImagingConvertYCbCr2RGB
        for (uint32_t x = 0; x < w; ++x) {
          uint8_t* p = row + 4 * x;
          int yy = p[0], cb = p[1], cr = p[2];
          p[0] = clip8(yy + (R_Cr[cr] >> 6));
          p[1] = clip8(yy + ((G_Cb[cb] + G_Cr[cr]) >> 6));
          p[2] = clip8(yy + (B_Cb[cb] >> 6));
        }
      }
    }
  }
}

// ------------------------------------------------------------------ JP2 boxes (OpenJPEG)

struct Jp2 {
  uint32_t state = 0;   // 1 signature, 2 file type, 4 header, 8 codestream
  bool has_ihdr = false, has_jp2h = false, has_colr = false, has_pclr = false,
       has_cmap = false, has_cdef = false;
  uint32_t enumcs = 0, nc = 0, npc = 0;
};

void jp2_sub_box(Jp2& jp, J2K& j, uint32_t type, const uint8_t* p, uint32_t size) {
  if (type == box("ihdr")) {
    if (jp.has_ihdr) return;
    if (size != 14) fail("a bad image header box");
    uint32_t h = be32(p), w = be32(p + 4), nc = be16(p + 8);
    if (nc - 1u >= 16384u) fail("an invalid number of components in the ihdr box");
    jp.nc = nc;
    j.ihdr_w = w;
    j.ihdr_h = h;
    jp.has_ihdr = true;
  } else if (type == box("colr")) {
    if (size < 3) fail("a bad colr box");
    if (jp.has_colr) return;
    uint32_t meth = p[0];
    if (meth == 1) {
      if (size < 7) fail("a bad colr box");
      jp.enumcs = be32(p + 3);
      jp.has_colr = true;
    } else if (meth == 2) {
      if (size < 3) fail("a bad colr box");
      jp.has_colr = true;
    }
  } else if (type == box("bpcc")) {
    if (size != jp.nc) fail("a bad bpcc box");
  } else if (type == box("pclr")) {
    if (jp.has_pclr) fail("a second pclr box");
    if (size < 3) fail("a bad pclr box");
    uint32_t ne = be16(p), npc = p[2];
    if (ne == 0 || ne > 1024 || npc == 0) fail("an invalid pclr box");
    uint64_t need = 3 + npc;
    if (size < need) fail("a bad pclr box");
    uint64_t bytes = 0;
    for (uint32_t i = 0; i < npc; ++i) {
      uint32_t b = ((p[3 + i] & 0x7f) + 1 + 7) / 8;
      bytes += b > 4 ? 4 : b;
    }
    if (size < need + bytes * ne) fail("a bad pclr box");
    jp.has_pclr = true;
    jp.npc = npc;
  } else if (type == box("cmap")) {
    if (!jp.has_pclr) fail("a cmap box before the pclr box");
    if (jp.has_cmap) fail("a second cmap box");
    if (size < jp.npc * 4) fail("a bad cmap box");
    jp.has_cmap = true;
  } else if (type == box("cdef")) {
    if (jp.has_cdef) fail("a second cdef box");
    jp.has_cdef = true;
    if (size < 2) fail("a bad cdef box");
    uint32_t n = be16(p);
    if (n == 0) fail("a cdef box of no channels");
    if (size < 2 + (uint64_t)n * 6) fail("a bad cdef box");
  }
}

bool jp2_is_sub(uint32_t t) {
  return t == box("ihdr") || t == box("colr") || t == box("bpcc") || t == box("pclr") ||
         t == box("cmap") || t == box("cdef");
}

void jp2_read_jp2h(Jp2& jp, J2K& j, const uint8_t* p, uint32_t size) {
  if ((jp.state & 2) != 2) fail("the jp2h box comes before the file type box");
  bool has_ihdr = false;
  while (size > 0) {
    if (size < 8) fail("a truncated box in the JP2 header box");
    uint32_t len = be32(p), type = be32(p + 4), hlen = 8;
    if (len == 1) {
      if (size < 16) fail("a truncated box in the JP2 header box");
      if (be32(p + 8) != 0) fail("a box longer than 2^32 bytes");
      len = be32(p + 12);
      hlen = 16;
    } else if (len == 0) {
      fail("a box of undefined size in the JP2 header box");
    }
    if (len < hlen) fail("a box shorter than its header in the JP2 header box");
    if (len > size) fail("a box past the end of the JP2 header box");
    if (jp2_is_sub(type)) jp2_sub_box(jp, j, type, p + hlen, len - hlen);
    if (type == box("ihdr")) has_ihdr = true;
    p += len;
    size -= len;
  }
  if (!has_ihdr) fail("a JP2 header box without an ihdr box");
  jp.state |= 4;
  jp.has_jp2h = true;
}

// opj_jp2_read_header_procedure: reads boxes up to the codestream (or, after
// it, to the end of the file); a box header it cannot read (short, or
// longer than 2^32 bytes) ends the reading there without an error
void jp2_read_boxes(Jp2& jp, J2K& j, Stream& s) {
  uint8_t hdr[16];
  std::vector<uint8_t> buf;
  for (;;) {
    uint32_t got = s.read(hdr, 8);
    if (got != 8) return;
    uint32_t len = be32(hdr), type = be32(hdr + 4), nread = 8;
    if (len == 0) {
      uint64_t left = s.left();
      if (left > 0xffffffffull - 8) return;
      len = (uint32_t)left + 8;
    } else if (len == 1) {
      if (s.read(hdr + 8, 8) != 8) return;
      nread = 16;
      if (be32(hdr + 8) != 0) return;
      len = be32(hdr + 12);
    }
    if (type == box("jp2c")) {
      if (jp.state & 4) {
        jp.state |= 8;
        return;
      }
      fail("a codestream box before the JP2 header box");
    }
    if (len < nread) fail("an invalid box size");
    uint32_t size = len - nread;
    bool top = type == box("jP  ") || type == box("ftyp") || type == box("jp2h");
    bool sub = jp2_is_sub(type);
    if (top || sub) {
      if (!top) {
        if (!(jp.state & 4)) {
          if (s.skip(size) != (int64_t)size) fail("a box past the end of the file");
          continue;
        }
      }
      if (size > s.left()) fail("a box past the end of the file");
      buf.resize(size);
      s.read(buf.data(), size);
      const uint8_t* p = buf.data();
      if (type == box("jP  ")) {
        if (jp.state != 0) fail("the signature box is not the first box");
        if (size != 4) fail("a bad signature box");
        if (be32(p) != 0x0d0a870a) fail("a bad signature box");
        jp.state |= 1;
      } else if (type == box("ftyp")) {
        if (jp.state != 1) fail("the file type box is not the second box");
        if (size < 8 || (size - 8) % 4) fail("a bad file type box");
        jp.state |= 2;
      } else if (type == box("jp2h")) {
        jp2_read_jp2h(jp, j, p, size);
      } else {
        jp2_sub_box(jp, j, type, p, size);
      }
    } else {
      if (!(jp.state & 1)) fail("the first box is not the signature box");
      if (!(jp.state & 2)) fail("the second box is not the file type box");
      if (s.skip(size) != (int64_t)size) {
        if (jp.state & 8) return;
        fail("a box past the end of the file");
      }
    }
  }
}

// ------------------------------------------------------------------ the whole decode

struct Decoded {
  PilHeader ph;
  PilImage im;
};

// Pillow's unpacker for (mode, colour space, components): -1 when none
// (0 gray_l / gray_i, 1 graya_la, 2 srgb_rgb, 3 srgba_rgba, 4 sycc_rgb,
// 5 sycca_rgba)
int find_unpacker(int mode, int cs, uint32_t nc, bool subsampling) {
  struct U {
    int mode, cs;
    uint32_t nc;
    bool sub;
    int un;
  };
  static const U table[] = {
      {M_L, 2, 1, false, 0},    {M_P, 1, 1, false, 0},     {M_PA, 1, 2, false, 1},
      {M_I16, 2, 1, false, 0},  {M_LA, 2, 2, false, 1},    {M_RGB, 1, 3, true, 2},
      {M_RGB, 3, 3, true, 4},   {M_RGB, 1, 4, true, 2},    {M_RGB, 3, 4, true, 4},
      {M_RGBA, 1, 3, true, 2},  {M_RGBA, 3, 3, true, 4},   {M_RGBA, 1, 4, true, 3},
      {M_RGBA, 3, 4, true, 5},  {M_CMYK, 5, 4, true, 3},
  };
  for (const U& u : table)
    if (u.mode == mode && u.cs == cs && u.nc == nc && (u.sub || !subsampling)) return u.un;
  return -1;
}

Decoded decode_all(const uint8_t* d, uint64_t n) {
  Decoded out;
  out.ph = pil_header(d, n);
  pil_size_checks(out.ph);
  J2K j;
  Stream s{d, n};
  Jp2 jp;
  if (out.ph.jp2) {
    jp2_read_boxes(jp, j, s);
    if (!jp.has_jp2h) fail("no JP2 header box");
    if (!jp.has_ihdr) fail("no ihdr box");
  }
  read_main_header(j, s);
  if (out.ph.jp2) {
    uint32_t e = jp.enumcs;
    j.color_space = e == 16 ? 1 : e == 17 ? 2 : e == 18 ? 3 : e == 24 ? 4 : e == 12 ? 5 : -1;
  }
  if (j.numcomps < 1 || j.numcomps > 4)
    fail("a JPEG 2000 image of %u components (PIL unpacks 1 to 4)", j.numcomps);
  auto full = [&](uint32_t c) { return j.comps[c].dx == 1 && j.comps[c].dy == 1; };
  bool subsampling = false;
  for (uint32_t c = 0; c < j.numcomps; ++c) subsampling |= !full(c);
  // an unspecified colour space (a raw codestream; a JP2 file without an
  // enumerated one that OpenJPEG knows): grey for 1 or 2 components, else
  // sRGB, or sYCC where the first component is whole and the second or
  // third is subsampled (settled against PIL)
  int cs = j.color_space;
  if (cs <= 0) {
    cs = j.numcomps <= 2 ? 2 : 1;
    if (j.numcomps >= 3 && full(0) && (!full(1) || !full(2))) cs = 3;
  }
  int un = find_unpacker(out.ph.mode, cs, j.numcomps, subsampling);
  if (un < 0)
    fail("PIL has no unpacker for a \"%s\" image of %u components in this colour space",
         kModeNames[out.ph.mode], j.numcomps);
  PilImage& im = out.im;
  im.mode = out.ph.mode;
  im.w = (uint32_t)out.ph.w;
  im.h = (uint32_t)out.ph.h;
  im.bpp = im.mode == M_L || im.mode == M_P ? 1 : im.mode == M_I16 ? 2 : 4;
  im.px.assign((size_t)im.w * im.h * im.bpp, 0);
  std::vector<uint8_t> pilbuf;   // Pillow's tile buffer
  for (;;) {
    if (!read_tile_header(j, s)) break;
    Tile tile;
    uint32_t tileno = j.cur_tile;
    init_tile(j, tileno, tile);
    uint32_t tx0 = (uint32_t)tile.x0, ty0 = (uint32_t)tile.y0;
    if (tx0 >= (uint32_t)tile.x1 || ty0 >= (uint32_t)tile.y1 || tx0 < j.x0 || ty0 < j.y0 ||
        (int64_t)(tile.x1 - j.x0) > out.ph.w || (int64_t)(tile.y1 - j.y0) > out.ph.h)
      fail("a tile outside the image");
    // opj_j2k_decode_tile
    if (!j.tcps[tileno].has_data) fail("a tile without data");
    std::vector<uint8_t> buf = decode_tile(j, tileno, tile);
    size_t tile_bytes = 0;
    for (uint32_t c = 0; c < j.numcomps; ++c) {
      uint32_t cs = (j.comps[c].prec + 7) >> 3;
      tile_bytes += (cs == 3 ? 4 : cs) * (size_t)(tile.x1 - tile.x0) * (size_t)(tile.y1 - tile.y0);
    }
    // Pillow's tile buffer: grown (realloc) to the larger of that and
    // OpenJPEG's size, the tile's share of it zeroed before every tile, the
    // rest kept from a larger earlier tile
    size_t need = std::max(tile_bytes, buf.size());
    if (pilbuf.size() < need) pilbuf.resize(need);
    std::fill(pilbuf.begin(), pilbuf.begin() + need, 0);
    std::copy(buf.begin(), buf.end(), pilbuf.begin());
    TCP& tcp = j.tcps[tileno];
    tcp.data.clear();
    tcp.data.shrink_to_fit();
    tcp.has_data = false;
    j.can_decode = false;
    j.state &= ~ST_DATA;
    unpack_tile(j, tile, pilbuf, un, im);
    if (!(s.left() == 0 && j.state == ST_NEOC) && j.state != ST_EOC) {
      uint8_t b[2];
      if (s.read(b, 2) != 2) fail("the stream is too short");
      uint32_t m = be16(b);
      if (m == MS_EOC) {
        j.cur_tile = 0;
        j.state = ST_EOC;
      } else if (m != MS_SOT) {
        if (s.left() == 0) {
          j.state = ST_NEOC;
        } else {
          fail("the stream is too short");
        }
      }
    }
  }
  if (out.ph.jp2) jp2_read_boxes(jp, j, s);   // opj_jp2_end_decompress
  return out;
}

// PIL's convert("L") / convert("RGB") of the decoded image into ``dst``
void to_mode(const Decoded& dec, bool rgb, uint8_t* dst) {
  const PilImage& im = dec.im;
  size_t npx = (size_t)im.w * im.h;
  auto put = [&](size_t i, uint8_t r, uint8_t g, uint8_t b) {
    if (rgb) {
      dst[3 * i] = r;
      dst[3 * i + 1] = g;
      dst[3 * i + 2] = b;
    } else {
      dst[i] = (uint8_t)((r * 19595u + g * 38470u + b * 7471u + 0x8000u) >> 16);
    }
  };
  auto grey = [&](size_t i, uint8_t v) {
    if (rgb) dst[3 * i] = dst[3 * i + 1] = dst[3 * i + 2] = v;
    else dst[i] = v;
  };
  for (size_t i = 0; i < npx; ++i) {
    const uint8_t* p = im.px.data() + i * im.bpp;
    switch (im.mode) {
      case M_L: grey(i, p[0]); break;
      case M_I16: {
        uint32_t v = p[0] | (uint32_t)p[1] << 8;
        grey(i, v > 255 ? 255 : (uint8_t)v);
        break;
      }
      case M_LA: grey(i, p[0]); break;
      case M_RGB: case M_RGBA: put(i, p[0], p[1], p[2]); break;
      case M_CMYK: {
        uint8_t rgbv[3];
        for (int k = 0; k < 3; ++k) {
          int t = (255 - p[k]) * (255 - p[3]) + 128;
          rgbv[k] = (uint8_t)(((t >> 8) + t) >> 8);
        }
        put(i, rgbv[0], rgbv[1], rgbv[2]);
        break;
      }
      case M_P: case M_PA: {
        uint32_t idx = p[0];
        uint32_t ncol = (uint32_t)(dec.ph.palette.size() / dec.ph.pal_len);
        if (idx < ncol) {
          const uint8_t* e = dec.ph.palette.data() + idx * dec.ph.pal_len;
          put(i, e[0], e[1], e[2]);
        } else {
          put(i, 0, 0, 0);   // past the palette: black, as PIL pads it
        }
        break;
      }
    }
  }
}

void copy_err(const std::string& msg, char* err, int errlen) {
  if (err && errlen > 0) {
    snprintf(err, (size_t)errlen, "%s", msg.c_str());
  }
}

struct Init {
  Init() {
    init_zc();
    init_ycc();
  }
} g_init;

}  // namespace

extern "C" {

// out: width, height, PIL's mode index (L, I;16, LA, RGB, RGBA, CMYK, P, PA)
int citlab_j2k_info(const uint8_t* data, int64_t n, int32_t* out, char* err, int errlen) {
  try {
    PilHeader ph = pil_header(data, (uint64_t)n);
    pil_size_checks(ph);
    // a side past 2^31 - 1 is reported as 2^31 - 1: past the bomb limit all the same
    out[0] = (int32_t)std::min<int64_t>(ph.w, INT32_MAX);
    out[1] = (int32_t)std::min<int64_t>(ph.h, INT32_MAX);
    out[2] = ph.mode;
    return 0;
  } catch (const Fail& f) {
    copy_err(f.msg, err, errlen);
  } catch (const std::bad_alloc&) {
    copy_err("JPEG 2000: out of memory", err, errlen);
  }
  return 1;
}

// PIL's convert("RGB") (rgb != 0, [H, W, 3]) or convert("L") ([H, W]) of the image
int citlab_j2k_decode(const uint8_t* data, int64_t n, int32_t rgb, uint8_t* out, int64_t out_n,
                      char* err, int errlen) {
  try {
    Decoded dec = decode_all(data, (uint64_t)n);
    size_t need = (size_t)dec.im.w * dec.im.h * (rgb ? 3 : 1);
    if ((int64_t)need != out_n) fail("output buffer of %lld bytes, %zu needed",
                                     (long long)out_n, need);
    to_mode(dec, rgb != 0, out);
    return 0;
  } catch (const Fail& f) {
    copy_err(f.msg, err, errlen);
  } catch (const std::bad_alloc&) {
    copy_err("JPEG 2000: out of memory", err, errlen);
  }
  return 1;
}

}  // extern "C"
