// Host decoder of Zstandard frames (RFC 8878), for the values of the JAX
// package's orbax checkpoints (tensorstore's OCDBT nodes, manifests and zarr
// chunks are zstd frames), and CRC-32C for the checksum that closes every
// OCDBT manifest and b-tree node. Written from the RFC and held to libzstd
// 1.5 (through the `zstandard` package) by tests/test_torch_zstd.py:
//
//   frames     zstd frames and skippable frames, one after another; the
//              frame header's window descriptor, content size and XXH64
//              content checksum (checked where the header flags it); no
//              dictionary is loaded, so a frame that names one is refused
//   blocks     raw, RLE and compressed blocks
//   literals   raw, RLE, Huffman-compressed and treeless (the previous
//              Huffman table of the frame), one or four streams; Huffman
//              weights given directly or FSE-compressed
//   sequences  predefined, RLE, FSE-compressed and repeat modes for the
//              literal-length, offset and match-length codes; repeat
//              offsets; matches that overlap their own output
//
// The checks libzstd makes are made here too (a reserved bit, a window
// past 2^31 bytes, a block past the frame's block size, a bit stream not
// consumed exactly, an offset before the frame's start, a content size or
// checksum that disagrees), so a damaged frame raises here where libzstd
// refuses it. Nothing is returned then: the output is all the frames or an
// error naming the fault.
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Fail {
  std::string msg;
};

[[noreturn]] void fail(const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw Fail{std::string("zstd: ") + buf};
}

inline uint32_t rd16(const uint8_t* p) { return p[0] | (uint32_t(p[1]) << 8); }
inline uint32_t rd24(const uint8_t* p) { return rd16(p) | (uint32_t(p[2]) << 16); }
inline uint32_t rd32(const uint8_t* p) { return rd16(p) | (rd16(p + 2) << 16); }
inline uint64_t rd64(const uint8_t* p) { return rd32(p) | (uint64_t(rd32(p + 4)) << 32); }
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }  // v > 0

// ------------------------------------------------------------------ XXH64

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xmerge(uint64_t acc, uint64_t v) { return (acc ^ xround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += n;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t(rd32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ------------------------------------------------------------------ bits

// A bit stream read backwards (Huffman streams, FSE streams): the last
// byte's highest set bit marks its end; bits before the start read as 0,
// and `pos` below 0 counts the bits read past it.
struct BackBits {
  const uint8_t* p = nullptr;
  size_t n = 0;
  int64_t pos = 0;  // bits [0, pos) are unread

  void init(const uint8_t* data, size_t size, const char* what) {
    if (size == 0) fail("%s: empty bit stream", what);
    if (data[size - 1] == 0) fail("%s: bit stream ends in a zero byte", what);
    p = data;
    n = size;
    pos = int64_t(size) * 8 - 8 + highbit(data[size - 1]);
  }
  uint64_t window(int64_t lo, int nb) const {  // bits [lo, lo + nb), lo >= 0, nb <= 56
    size_t byte = size_t(lo >> 3);
    uint64_t v = 0;
    if (byte + 8 <= n) {
      memcpy(&v, p + byte, 8);
    } else {
      for (size_t i = byte; i < n; ++i) v |= uint64_t(p[i]) << (8 * (i - byte));
    }
    return (v >> (lo & 7)) & ((uint64_t(1) << nb) - 1);
  }
  uint64_t peek(int nb) const {
    if (nb == 0 || pos <= 0) return 0;
    int64_t lo = pos - nb;
    if (lo >= 0) return window(lo, nb);
    return window(0, int(pos)) << (-lo);
  }
  uint64_t read(int nb) {
    uint64_t v = peek(nb);
    pos -= nb;
    return v;
  }
  bool overflow() const { return pos < 0; }
};

// ------------------------------------------------------------------ FSE

struct FseCell {
  uint32_t base;   // symbol (FSE) or the code's baseline (sequences)
  uint16_t next;   // next state before the low bits are added
  uint8_t nbits;   // bits of the state update
  uint8_t extra;   // extra bits of the code's value (sequences)
};

struct Fse {
  int log = 0;
  std::vector<FseCell> cells;
};

// Normalized counts of an FSE table description (RFC 8878 4.1.1), read
// forward; bits past `n` read as 0 and the description must end inside.
// Returns the bytes read.
size_t read_ncount(const uint8_t* src, size_t n, int max_symbol, int max_log,
                   std::vector<int>& norm, int& log, const char* what) {
  auto bits = [&](size_t at, int nb) -> uint32_t {
    uint32_t v = 0;
    for (int i = 0; i < nb; ++i) {
      size_t b = at + i;
      if ((b >> 3) < n && ((src[b >> 3] >> (b & 7)) & 1)) v |= 1u << i;
    }
    return v;
  };
  size_t bit = 0;
  int nb = int(bits(0, 4)) + 5;
  bit = 4;
  if (nb > 15) fail("%s: FSE accuracy log %d past 15", what, nb);
  log = nb;
  int remaining = (1 << nb) + 1;
  int threshold = 1 << nb;
  nb++;
  norm.assign(size_t(max_symbol) + 1, 0);
  int sym = 0;
  bool previous0 = false;
  for (;;) {
    if (previous0) {
      int n0 = sym;
      while (bits(bit, 2) == 3) {
        n0 += 3;
        bit += 2;
      }
      n0 += int(bits(bit, 2));
      bit += 2;
      if (n0 > max_symbol) fail("%s: FSE table describes symbols past %d", what, max_symbol);
      sym = n0;
    }
    int max = (2 * threshold - 1) - remaining;
    int count;
    if (int(bits(bit, nb - 1)) < max) {
      count = int(bits(bit, nb - 1));
      bit += nb - 1;
    } else {
      count = int(bits(bit, nb));
      if (count >= threshold) count -= max;
      bit += nb;
    }
    count--;
    remaining -= count < 0 ? -count : count;
    norm[size_t(sym++)] = count;
    previous0 = count == 0;
    if (remaining < threshold) {
      if (remaining <= 1) break;
      nb = highbit(uint32_t(remaining)) + 1;
      threshold = 1 << (nb - 1);
    }
    if (sym > max_symbol) break;
  }
  if (remaining != 1) fail("%s: FSE probabilities do not sum to the table size", what);
  size_t used = (bit + 7) >> 3;
  if (used > n) fail("%s: FSE table description runs past its data", what);
  norm.resize(size_t(sym));
  if (log > max_log) fail("%s: FSE accuracy log %d past %d", what, log, max_log);
  return used;
}

// The decoding table of normalized counts (RFC 8878 4.1.1: the symbol
// spread, low-probability symbols at the top); `base` / `extra` map a
// symbol to its baseline and extra bits (identity for plain FSE).
void build_fse(Fse& t, const std::vector<int>& norm, int log, const uint32_t* base,
               const uint8_t* extra) {
  const uint32_t size = 1u << log;
  t.log = log;
  t.cells.assign(size, FseCell{0, 0, 0, 0});
  std::vector<uint32_t> sym_of(size, 0);
  std::vector<uint32_t> next(norm.size(), 0);
  uint32_t high = size - 1;
  for (size_t s = 0; s < norm.size(); ++s) {
    if (norm[s] == -1) {
      sym_of[high--] = uint32_t(s);
      next[s] = 1;
    } else {
      next[s] = uint32_t(norm[s]);
    }
  }
  const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  uint32_t pos = 0;
  for (size_t s = 0; s < norm.size(); ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      sym_of[pos] = uint32_t(s);
      do {
        pos = (pos + step) & mask;
      } while (pos > high);
    }
  }
  if (pos != 0) fail("FSE table: symbol spread does not close");
  for (uint32_t u = 0; u < size; ++u) {
    const uint32_t s = sym_of[u];
    const uint32_t ns = next[s]++;
    FseCell& c = t.cells[u];
    c.nbits = uint8_t(log - highbit(ns));
    c.next = uint16_t((ns << c.nbits) - size);
    c.base = base ? base[s] : s;
    c.extra = extra ? extra[s] : 0;
  }
}

void build_rle(Fse& t, uint32_t base, uint8_t extra) {
  t.log = 0;
  t.cells.assign(1, FseCell{base, 0, 0, extra});
}

// ------------------------------------------------------------------ Huffman

struct Huffman {
  int max_bits = 0;
  std::vector<uint8_t> sym, len;  // by max_bits-bit prefix
  bool x2 = false;                // libzstd's double-symbol table (see select_x2)
};

// Huffman weights (RFC 8878 4.2.1) -> decoding table; returns the bytes of
// the tree description.
size_t read_huffman(Huffman& h, const uint8_t* src, size_t n) {
  if (n == 0) fail("Huffman tree: no description");
  uint8_t w[256];
  size_t nw, used;
  const int hb = src[0];
  if (hb >= 128) {
    nw = size_t(hb - 127);
    used = (nw + 1) / 2 + 1;
    if (used > n) fail("Huffman tree: direct weights run past the literals");
    if (nw >= 256) fail("Huffman tree: %zu weights", nw);
    for (size_t i = 0; i < nw; i += 2) {
      w[i] = src[1 + i / 2] >> 4;
      if (i + 1 < nw) w[i + 1] = src[1 + i / 2] & 15;
    }
  } else {
    used = size_t(hb) + 1;
    if (used > n) fail("Huffman tree: FSE weights run past the literals");
    std::vector<int> norm;
    int log;
    const size_t hs = read_ncount(src + 1, size_t(hb), 255, 6, norm, log, "Huffman weights");
    Fse t;
    build_fse(t, norm, log, nullptr, nullptr);
    BackBits bs;
    bs.init(src + 1 + hs, size_t(hb) - hs, "Huffman weights");
    uint32_t s1 = uint32_t(bs.read(log)), s2 = uint32_t(bs.read(log));
    nw = 0;
    auto emit = [&](uint32_t& s) {
      const FseCell& c = t.cells[s];
      w[nw++] = uint8_t(c.base);
      s = c.next + uint32_t(bs.read(c.nbits));
    };
    for (;;) {
      if (nw > 253) fail("Huffman tree: more than 255 weights");
      emit(s1);
      if (bs.overflow()) {
        w[nw++] = uint8_t(t.cells[s2].base);
        break;
      }
      if (nw > 253) fail("Huffman tree: more than 255 weights");
      emit(s2);
      if (bs.overflow()) {
        w[nw++] = uint8_t(t.cells[s1].base);
        break;
      }
    }
  }
  uint32_t total = 0, rank1 = 0;
  for (size_t i = 0; i < nw; ++i) {
    if (w[i] > 12) fail("Huffman tree: weight %d past 12", w[i]);
    total += (1u << w[i]) >> 1;
  }
  if (total == 0) fail("Huffman tree: all weights zero");
  const int bits = highbit(total) + 1;
  if (bits > 12) fail("Huffman tree: codes of %d bits", bits);
  const uint32_t rest = (1u << bits) - total;
  if (rest != (1u << highbit(rest))) fail("Huffman tree: weights do not close the code");
  w[nw++] = uint8_t(highbit(rest) + 1);
  for (size_t i = 0; i < nw; ++i) rank1 += w[i] == 1;
  if (rank1 < 2 || (rank1 & 1)) fail("Huffman tree: odd count of weight-1 symbols");
  h.max_bits = bits;
  h.sym.assign(size_t(1) << bits, 0);
  h.len.assign(size_t(1) << bits, 0);
  size_t at = 0;
  for (int weight = 1; weight <= bits; ++weight) {
    for (size_t s = 0; s < nw; ++s) {
      if (w[s] != weight) continue;
      const size_t span = size_t(1) << (weight - 1);
      memset(&h.sym[at], int(s), span);
      memset(&h.len[at], bits + 1 - weight, span);
      at += span;
    }
  }
  return used;
}

void huffman_stream(const Huffman& h, const uint8_t* src, size_t n, uint8_t* out, size_t count) {
  BackBits bs;
  bs.init(src, n, "Huffman literals");
  const int mb = h.max_bits;
  for (size_t i = 0; i < count; ++i) {
    const uint32_t v = uint32_t(bs.peek(mb));
    out[i] = h.sym[v];
    bs.pos -= h.len[v];
  }
  if (bs.pos != 0) fail("Huffman literals: stream not consumed exactly");
}

// libzstd decodes four Huffman streams with one of two tables: one symbol
// per lookup ("X1") or up to two ("X2": a lookup of 11 bits gives a second
// symbol where its whole code fits in the bits after the first's). A
// table read with its tree for four streams is the one HUF_selectDecoder's
// timing model picks from the literals' sizes; one read for a single
// stream is X1; treeless literals reuse the last table. Both give the same
// symbols; they differ in how far their fast loops run before the check
// below, and a damaged stream can fail one and pass the other.
const uint32_t kAlgoTime[16][2][2] = {
    {{0, 0}, {1, 1}},       {{0, 0}, {1, 1}},       {{150, 216}, {381, 119}},
    {{170, 205}, {514, 112}}, {{177, 199}, {539, 110}}, {{197, 194}, {644, 107}},
    {{221, 192}, {735, 107}}, {{256, 189}, {881, 106}}, {{359, 188}, {1167, 109}},
    {{582, 187}, {1570, 114}}, {{688, 187}, {1712, 122}}, {{825, 186}, {1965, 136}},
    {{976, 185}, {2131, 150}}, {{1180, 186}, {2070, 175}}, {{1377, 185}, {1731, 202}},
    {{1412, 185}, {1695, 202}}};

bool select_x2(size_t dst, size_t csrc) {
  const uint32_t q = csrc >= dst ? 15 : uint32_t(csrc * 16 / dst);
  const uint32_t d256 = uint32_t(dst >> 8);
  const uint32_t t0 = kAlgoTime[q][0][0] + kAlgoTime[q][0][1] * d256;
  uint32_t t1 = kAlgoTime[q][1][0] + kAlgoTime[q][1][1] * d256;
  t1 += t1 >> 5;
  return t1 < t0;
}

// Four Huffman streams as libzstd's fast decoder reads them where every
// stream has at least 8 bytes and the codes at most 11 bits: each stream is
// read on into the bytes before it (down to the jump table), a last byte of
// 0 carries no end mark, and a stream need not end where its data ends. The
// one check is that of the fast loop, which refuses a stream read 8 bytes
// or more past its start when the loop stops. The loop runs in batches:
// as many rounds (5 lookups per stream each) as the first stream has 7
// bytes for before the jump table's start and the segments have room for
// (5 symbols a round for X1 in the last segment, 10 for X2 in every one);
// an X2 batch ends when the last stream has written 5 symbols per round of
// it. It stops when a batch would be empty, or where a stream's read
// position falls below the one before it. The rest of each segment is read
// as libzstd's plain decoder reads it on, without a check.
void huffman_4x_fast(const Huffman& h, bool x2, const uint8_t* q, const size_t lens[4],
                     uint8_t* out, size_t size) {
  const size_t seg = (size + 3) / 4;
  size_t start[4], end[4], stop[4];
  start[0] = 6;
  for (int i = 0; i < 4; ++i) {
    if (i) start[i] = end[i - 1];
    end[i] = start[i] + lens[i];
    stop[i] = i < 3 ? size_t(i + 1) * seg : size;
  }
  BackBits bs[4];
  size_t op[4];
  for (int i = 0; i < 4; ++i) {
    bs[i].p = q;
    bs[i].n = end[i];
    const uint8_t last = q[end[i] - 1];
    bs[i].pos = int64_t(end[i]) * 8 - (last ? 8 - highbit(last) : 0);
    op[i] = size_t(i) * seg;
  }
  const int mb = h.max_bits;
  auto ip = [&](int i) -> int64_t {  // start of the 8 bytes the fast loop holds
    const int64_t consumed = int64_t(end[i]) * 8 - bs[i].pos;
    return int64_t(end[i]) - 8 - consumed / 8;
  };
  // one lookup of the 11 bits w: the symbols it gives and the bits it takes
  auto lookup = [&](uint32_t w, uint8_t* o, int& nsym) -> int {
    const uint32_t v = w >> (11 - mb);
    o[0] = h.sym[v];
    const int l1 = h.len[v];
    nsym = 1;
    if (!x2) return l1;
    const uint32_t v2 = ((w << l1) & 0x7FF) >> (11 - mb);
    const int l2 = h.len[v2];
    if (l2 > 11 - l1) return l1;
    o[1] = h.sym[v2];
    nsym = 2;
    return l1 + l2;
  };
  auto fast = [&](int i) {
    uint8_t two[2];
    int n;
    bs[i].pos -= lookup(uint32_t(bs[i].peek(11)), two, n);
    for (int k = 0; k < n; ++k) out[op[i]++] = two[k];
  };
  for (;;) {
    const int64_t ip0 = ip(0);
    size_t iters = ip0 > 0 ? size_t(ip0) / 7 : 0;
    for (int i = x2 ? 0 : 3; i < 4; ++i) {
      const size_t room = (stop[i] - op[i]) / (x2 ? 10 : 5);
      iters = room < iters ? room : iters;
    }
    if (iters == 0) break;
    if (ip(1) < ip(0) || ip(2) < ip(1) || ip(3) < ip(2)) break;
    const size_t olimit = op[3] + 5 * iters;
    do {
      for (int k = 0; k < 5; ++k)
        for (int i = 0; i < 4; ++i) fast(i);
    } while (op[3] < olimit);
  }
  for (int i = 0; i < 4; ++i) {
    const int64_t at = ip(i);
    if (at < int64_t(start[i]) - 8) fail("Huffman literals: stream %d read past its start", i);
    // the plain decoder: lookups from 64 held bits, refilled while the 8
    // bytes lie past the jump table's start, then without refills, the held
    // bits wrapping around
    int64_t ptr = at;
    uint32_t used = uint32_t(at * 8 + 64 - bs[i].pos);
    uint64_t c = rd64(q + ptr);
    auto refill = [&]() -> bool {  // true: BIT_DStream_unfinished
      if (used > 64) return false;
      if (ptr >= 8) {
        ptr -= used >> 3;
        used &= 7;
        c = rd64(q + ptr);
        return true;
      }
      if (ptr == 0) return false;
      int64_t nb = used >> 3;
      bool more = true;
      if (ptr - nb < 0) {
        nb = ptr;
        more = false;
      }
      ptr -= nb;
      used -= uint32_t(nb * 8);
      c = rd64(q + ptr);
      return more;
    };
    auto sym = [&]() {
      uint8_t two[2];
      int n;
      used += lookup(uint32_t((c << (used & 63)) >> 53), two, n);
      for (int k = 0; k < n; ++k) out[op[i]++] = two[k];
    };
    const size_t e = stop[i];
    if (!x2) {
      if (e - op[i] > 3) {
        while (refill() && op[i] + 3 < e)
          for (int k = 0; k < 4; ++k) sym();
      } else {
        refill();
      }
      while (op[i] < e) sym();
      continue;
    }
    if (e - op[i] >= 8) {
      while (refill() && op[i] + 9 < e)
        for (int k = 0; k < 5; ++k) sym();
    } else {
      refill();
    }
    if (e - op[i] >= 2) {
      while (refill() && op[i] + 2 <= e) sym();
      while (op[i] + 2 <= e) sym();
    }
    if (op[i] < e) {  // the last symbol: the first of its lookup
      uint8_t two[2];
      int n;
      const int bits = lookup(uint32_t((c << (used & 63)) >> 53), two, n);
      out[op[i]++] = two[0];
      used = n == 1 ? used + bits : (used < 64 ? (used + bits > 64 ? 64 : used + bits) : used);
    }
  }
}

// ------------------------------------------------------------------ tables

const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLExtra[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  1,  1,
                              1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,   7,   8,   9,   10,   11,   12,   13,   14,    15,   16,
                              17, 18, 19, 20,  21,  22,  23,  24,   25,   26,   27,   28,    29,   30,
                              31, 32, 33, 34,  35,  37,  39,  41,   43,   47,   51,   59,    67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLExtra[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                              0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                              2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
uint32_t kOFBase[32];
uint8_t kOFExtra[32];

const int kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                            2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct Defaults {
  Fse ll, ml, of;
  Defaults() {
    for (int i = 0; i < 32; ++i) {
      kOFBase[i] = 1u << i;
      kOFExtra[i] = uint8_t(i);
    }
    build_fse(ll, std::vector<int>(kLLDefault, kLLDefault + 36), 6, kLLBase, kLLExtra);
    build_fse(ml, std::vector<int>(kMLDefault, kMLDefault + 53), 6, kMLBase, kMLExtra);
    build_fse(of, std::vector<int>(kOFDefault, kOFDefault + 29), 5, kOFBase, kOFExtra);
  }
};

const Defaults& defaults() {
  static const Defaults d;
  return d;
}

// ------------------------------------------------------------------ frames

struct FrameState {
  size_t block_max = 0;
  Huffman huf;
  bool have_huf = false;
  Fse ll, ml, of;
  bool have_seq = false;
  uint32_t rep[3] = {1, 4, 8};
};

// one sequence table (mode 0-3) of a sequences section; returns bytes read
size_t seq_table(Fse& t, int mode, const uint8_t* p, size_t n, int max_symbol, int max_log,
                 const Fse& def, const uint32_t* base, const uint8_t* extra, bool have,
                 const char* what) {
  switch (mode) {
    case 0:
      t = def;
      return 0;
    case 1:
      if (n == 0) fail("%s: RLE symbol missing", what);
      if (p[0] > max_symbol) fail("%s: RLE symbol %d past %d", what, p[0], max_symbol);
      build_rle(t, base[p[0]], extra[p[0]]);
      return 1;
    case 2: {
      std::vector<int> norm;
      int log;
      const size_t used = read_ncount(p, n, max_symbol, max_log, norm, log, what);
      build_fse(t, norm, log, base, extra);
      return used;
    }
    default:
      if (!have) fail("%s: repeat mode without a previous table", what);
      return 0;
  }
}

void compressed_block(FrameState& fs, const uint8_t* p, size_t n, std::vector<uint8_t>& out,
                      size_t frame_start, uint64_t room) {
  if (n > fs.block_max) fail("compressed block of %zu bytes past the block size %zu", n, fs.block_max);
  if (n < 2) fail("compressed block too short");
  // ---- literals section
  const int ltype = p[0] & 3, lfmt = (p[0] >> 2) & 3;
  std::vector<uint8_t> lit;
  size_t lused;
  const size_t lit_cap = size_t(room < fs.block_max ? room : fs.block_max);
  if (ltype == 0 || ltype == 1) {
    size_t hs, size;
    if (lfmt == 1) {
      hs = 2;
      size = rd16(p) >> 4;
    } else if (lfmt == 3) {
      hs = 3;
      if (n < (ltype == 0 ? 3u : 4u)) fail("literals header past the block");
      size = rd24(p) >> 4;
    } else {
      hs = 1;
      size = p[0] >> 3;
    }
    if (ltype == 1 && hs == 2 && n < 3) fail("literals header past the block");
    if (size > fs.block_max) fail("%zu literals past the block size", size);
    if (size > lit_cap) fail("%zu literals past the frame's content size", size);
    if (ltype == 0) {
      if (hs + size > n) fail("raw literals past the block");
      lit.assign(p + hs, p + hs + size);
      lused = hs + size;
    } else {
      lit.assign(size, p[hs]);
      lused = hs + 1;
    }
  } else {
    if (ltype == 3 && !fs.have_huf) fail("treeless literals without a previous Huffman table");
    if (n < 5) fail("compressed literals header past the block");
    const uint32_t h = rd32(p);
    size_t hs, size, csize;
    bool single = false;
    if (lfmt <= 1) {
      single = lfmt == 0;
      hs = 3;
      size = (h >> 4) & 0x3FF;
      csize = (h >> 14) & 0x3FF;
    } else if (lfmt == 2) {
      hs = 4;
      size = (h >> 4) & 0x3FFF;
      csize = h >> 18;
    } else {
      hs = 5;
      size = (h >> 4) & 0x3FFFF;
      csize = (h >> 22) + (size_t(p[4]) << 10);
    }
    if (size > fs.block_max) fail("%zu literals past the block size", size);
    if (!single && size < 6) fail("%zu literals in four streams", size);
    if (csize + hs > n) fail("compressed literals past the block");
    if (size > lit_cap) fail("%zu literals past the frame's content size", size);
    const uint8_t* q = p + hs;
    size_t qn = csize;
    if (ltype == 2) {
      if (qn == 0) fail("compressed literals: empty");
      Huffman h2;
      const size_t ts = read_huffman(h2, q, qn);
      if (ts >= qn) fail("Huffman tree fills the literals");
      h2.x2 = !single && select_x2(size, csize);
      fs.huf = std::move(h2);
      fs.have_huf = true;
      q += ts;
      qn -= ts;
    }
    lit.resize(size);
    if (single) {
      huffman_stream(fs.huf, q, qn, lit.data(), size);
    } else {
      if (qn < 10) fail("four Huffman streams in %zu bytes", qn);
      const size_t l1 = rd16(q), l2 = rd16(q + 2), l3 = rd16(q + 4);
      if (l1 + l2 + l3 + 6 > qn) fail("Huffman jump table past the literals");
      const size_t l4 = qn - 6 - l1 - l2 - l3;
      const size_t seg = (size + 3) / 4;
      if (3 * seg > size) fail("Huffman streams: %zu literals in four streams", size);
      const size_t lens[4] = {l1, l2, l3, l4};
      if (fs.huf.max_bits <= 11 && l1 >= 8 && l2 >= 8 && l3 >= 8 && l4 >= 8 && 3 * seg < size) {
        huffman_4x_fast(fs.huf, fs.huf.x2, q, lens, lit.data(), size);
      } else {
        const uint8_t* s = q + 6;
        huffman_stream(fs.huf, s, l1, lit.data(), seg);
        huffman_stream(fs.huf, s + l1, l2, lit.data() + seg, seg);
        huffman_stream(fs.huf, s + l1 + l2, l3, lit.data() + 2 * seg, seg);
        huffman_stream(fs.huf, s + l1 + l2 + l3, l4, lit.data() + 3 * seg, size - 3 * seg);
      }
    }
    lused = hs + csize;
  }
  // ---- sequences section
  const uint8_t* s = p + lused;
  const uint8_t* send = p + n;
  if (s >= send) fail("sequences section missing");
  size_t nseq = *s++;
  if (nseq > 0x7F) {
    if (nseq == 0xFF) {
      if (s + 2 > send) fail("sequence count past the block");
      nseq = rd16(s) + 0x7F00;
      s += 2;
    } else {
      if (s >= send) fail("sequence count past the block");
      nseq = ((nseq - 0x80) << 8) + *s++;
    }
  }
  const size_t block_start = out.size();
  size_t lp = 0;
  if (nseq == 0) {
    if (s != send) fail("data after an empty sequences section");
  } else {
    if (s >= send) fail("sequence modes past the block");
    const uint8_t modes = *s++;
    if (modes & 3) fail("reserved bits of the sequence modes set");
    const Defaults& d = defaults();
    s += seq_table(fs.ll, modes >> 6, s, size_t(send - s), 35, 9, d.ll, kLLBase, kLLExtra,
                   fs.have_seq, "literal lengths");
    s += seq_table(fs.of, (modes >> 4) & 3, s, size_t(send - s), 31, 8, d.of, kOFBase, kOFExtra,
                   fs.have_seq, "offsets");
    s += seq_table(fs.ml, (modes >> 2) & 3, s, size_t(send - s), 52, 9, d.ml, kMLBase, kMLExtra,
                   fs.have_seq, "match lengths");
    fs.have_seq = true;
    BackBits bs;
    bs.init(s, size_t(send - s), "sequences");
    uint32_t sll = uint32_t(bs.read(fs.ll.log));
    uint32_t sof = uint32_t(bs.read(fs.of.log));
    uint32_t sml = uint32_t(bs.read(fs.ml.log));
    uint32_t rep[3] = {fs.rep[0], fs.rep[1], fs.rep[2]};
    for (size_t i = 0; i < nseq; ++i) {
      const FseCell& cll = fs.ll.cells[sll];
      const FseCell& cof = fs.of.cells[sof];
      const FseCell& cml = fs.ml.cells[sml];
      const uint64_t ofv = uint64_t(cof.base) + bs.read(cof.extra);
      const uint64_t ml = cml.base + bs.read(cml.extra);
      const uint64_t ll = cll.base + bs.read(cll.extra);
      uint64_t offset;
      if (ofv > 3) {
        offset = ofv - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = uint32_t(offset);
      } else {
        const uint64_t idx = ofv - 1 + (ll == 0);
        if (idx == 0) {
          offset = rep[0];
        } else {
          offset = idx == 3 ? uint64_t(rep[0]) - 1 : rep[idx];
          if (offset == 0) fail("repeat offset of 0");
          if (idx != 1) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = uint32_t(offset);
        }
      }
      if (ll > lit.size() - lp) fail("sequence takes literals past the literals section");
      if (ll + ml > room - (out.size() - block_start)) fail("sequence past the frame's content size");
      out.insert(out.end(), lit.begin() + long(lp), lit.begin() + long(lp + ll));
      lp += ll;
      const size_t have = out.size() - frame_start;
      if (offset > have) fail("match offset %llu before the frame's start", (unsigned long long)offset);
      size_t from = out.size() - size_t(offset);
      const size_t at = out.size();
      out.resize(at + ml);
      uint8_t* o = out.data();
      if (offset >= ml) {
        memcpy(o + at, o + from, ml);
      } else {
        for (size_t k = 0; k < ml; ++k) o[at + k] = o[from + k];
      }
      if (i + 1 < nseq) {
        sll = cll.next + uint32_t(bs.read(cll.nbits));
        sml = cml.next + uint32_t(bs.read(cml.nbits));
        sof = cof.next + uint32_t(bs.read(cof.nbits));
      }
    }
    if (bs.pos != 0) fail("sequences: bit stream not consumed exactly");
    fs.rep[0] = rep[0];
    fs.rep[1] = rep[1];
    fs.rep[2] = rep[2];
  }
  const size_t last = lit.size() - lp;
  if (last > room - (out.size() - block_start)) fail("literals past the frame's content size");
  out.insert(out.end(), lit.begin() + long(lp), lit.end());
}

// one zstd frame at p[0..n); returns the bytes it takes
size_t frame(const uint8_t* p, size_t n, std::vector<uint8_t>& out) {
  if (n < 5) fail("frame header truncated");
  const uint8_t fhd = p[4];
  const int fcs_flag = fhd >> 6, did_flag = fhd & 3;
  const bool single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1;
  if (fhd & 8) fail("reserved bit of the frame header set");
  const size_t did_size[4] = {0, 1, 2, 4};
  const size_t fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : (size_t(1) << fcs_flag);
  const size_t hs = 5 + (single ? 0 : 1) + did_size[did_flag] + fcs_size;
  if (n < hs) fail("frame header truncated");
  size_t at = 5;
  uint64_t window = 0;
  if (!single) {
    const int wl = (p[at] >> 3) + 10;
    if (wl > 31) fail("window of 2^%d bytes", wl);
    window = uint64_t(1) << wl;
    window += (window >> 3) * (p[at] & 7);
    at++;
  }
  uint32_t dict = 0;
  for (size_t i = 0; i < did_size[did_flag]; ++i) dict |= uint32_t(p[at + i]) << (8 * i);
  at += did_size[did_flag];
  if (dict != 0) fail("frame needs dictionary %u (none is loaded)", dict);
  bool has_size = fcs_size > 0;
  uint64_t content = 0;
  if (fcs_size == 1) content = p[at];
  if (fcs_size == 2) content = rd16(p + at) + 256;
  if (fcs_size == 4) content = rd32(p + at);
  if (fcs_size == 8) content = rd64(p + at);
  at += fcs_size;
  if (single) window = content;
  if (!has_size && window > (uint64_t(1) << 27)) fail("window of %llu bytes past 2^27 in a frame of unknown size", (unsigned long long)window);
  FrameState fs;
  fs.block_max = size_t(window < (128u << 10) ? window : (128u << 10));
  const size_t frame_start = out.size();
  const uint64_t room_total = has_size ? content : ~uint64_t(0);
  if (has_size && content < (uint64_t(1) << 31)) out.reserve(out.size() + size_t(content));
  for (;;) {
    if (at + 3 > n) fail("block header truncated");
    const uint32_t bh = rd24(p + at);
    at += 3;
    const bool last = bh & 1;
    const int type = (bh >> 1) & 3;
    const size_t size = bh >> 3;
    const uint64_t room = room_total - (out.size() - frame_start);
    if (type == 3) fail("reserved block type");
    // a frame that does not give its size is decoded as a stream is, in a
    // window: each block's content fits the block size
    if (!has_size && size > fs.block_max) fail("block of %zu bytes past the block size %zu", size, fs.block_max);
    const size_t before = out.size();
    if (type == 1) {
      if (at + 1 > n) fail("RLE block truncated");
      if (size > room) fail("block past the frame's content size");
      out.insert(out.end(), size, p[at]);
      at += 1;
    } else {
      if (size > n - at) fail("block of %zu bytes past the input", size);
      if (type == 0) {
        if (size > room) fail("block past the frame's content size");
        out.insert(out.end(), p + at, p + at + size);
      } else {
        compressed_block(fs, p + at, size, out, frame_start, room);
      }
      at += size;
    }
    if (!has_size && out.size() - before > fs.block_max) fail("block content past the block size %zu", fs.block_max);
    if (last) break;
  }
  const size_t produced = out.size() - frame_start;
  if (has_size && produced != content) fail("frame holds %zu bytes, its header says %llu", produced, (unsigned long long)content);
  if (checksum) {
    if (at + 4 > n) fail("content checksum truncated");
    const uint32_t want = rd32(p + at);
    const uint32_t got = uint32_t(xxh64(out.data() + frame_start, produced));
    if (want != got) fail("content checksum %08x, the content's %08x", want, got);
    at += 4;
  }
  return at;
}

std::vector<uint8_t> decompress(const uint8_t* p, size_t n) {
  if (n == 0) fail("no frame");
  std::vector<uint8_t> out;
  size_t at = 0;
  while (at < n) {
    if (n - at < 4) fail("%zu bytes after the last frame", n - at);
    const uint32_t magic = rd32(p + at);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (n - at < 8) fail("skippable frame header truncated");
      const uint64_t size = rd32(p + at + 4);
      if (size > n - at - 8) fail("skippable frame past the input");
      at += 8 + size_t(size);
    } else if (magic == 0xFD2FB528u) {
      at += frame(p + at, n - at, out);
    } else {
      fail("bad magic %08x at byte %zu", magic, at);
    }
  }
  return out;
}

// ------------------------------------------------------------------ CRC-32C

uint32_t crc_table[8][256];

struct CrcInit {
  CrcInit() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      crc_table[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int t = 1; t < 8; ++t)
        crc_table[t][i] = (crc_table[t - 1][i] >> 8) ^ crc_table[0][crc_table[t - 1][i] & 0xFF];
  }
} crc_init;

uint32_t crc32c(const uint8_t* p, size_t n) {  // slicing by 8
  uint32_t c = 0xFFFFFFFFu;
  for (; n >= 8; p += 8, n -= 8) {
    const uint64_t v = rd64(p) ^ c;
    c = crc_table[7][v & 0xFF] ^ crc_table[6][(v >> 8) & 0xFF] ^ crc_table[5][(v >> 16) & 0xFF] ^
        crc_table[4][(v >> 24) & 0xFF] ^ crc_table[3][(v >> 32) & 0xFF] ^
        crc_table[2][(v >> 40) & 0xFF] ^ crc_table[1][(v >> 48) & 0xFF] ^ crc_table[0][v >> 56];
  }
  for (; n > 0; ++p, --n) c = (c >> 8) ^ crc_table[0][(c ^ *p) & 0xFF];
  return ~c;
}

void set_err(const std::string& msg, char* err, int errlen) {
  if (err && errlen > 0) {
    strncpy(err, msg.c_str(), size_t(errlen) - 1);
    err[errlen - 1] = 0;
  }
}

}  // namespace

extern "C" {

// Decode every frame of data[0..n); *out (free with citlab_zstd_free) and
// *out_len are the content. 0 on success; -1 with a message in err.
int citlab_zstd_decompress(const uint8_t* data, int64_t n, uint8_t** out, int64_t* out_len,
                           char* err, int errlen) {
  *out = nullptr;
  *out_len = 0;
  try {
    std::vector<uint8_t> v = decompress(data, size_t(n));
    uint8_t* buf = static_cast<uint8_t*>(malloc(v.size() ? v.size() : 1));
    if (!buf) throw std::bad_alloc();
    if (!v.empty()) memcpy(buf, v.data(), v.size());
    *out = buf;
    *out_len = int64_t(v.size());
    return 0;
  } catch (const Fail& e) {
    set_err(e.msg, err, errlen);
  } catch (const std::bad_alloc&) {
    set_err("zstd: out of memory", err, errlen);
  } catch (const std::length_error&) {
    set_err("zstd: output too large", err, errlen);
  }
  return -1;
}

void citlab_zstd_free(uint8_t* p) { free(p); }

uint32_t citlab_crc32c(const uint8_t* data, int64_t n) { return crc32c(data, size_t(n)); }

}  // extern "C"
