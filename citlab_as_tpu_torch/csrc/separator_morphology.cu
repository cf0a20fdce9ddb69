// K2: fused separator-mask morphology over a batch of CC-cleaned 0/255 pages.
//
// Replaces the Pallas TPU kernel
// citlab_as_tpu/ops/pallas/separator_morphology.py (fused_separator_masks,
// body _make_kernel, _masked_open, _window_1d). Per page [H, W]:
//   vertical   = open(x, 1 x v_k)                  (erode then dilate down columns)
//   horizontal = open(x, h_k x 1)                  (along rows)
//   horizontal = open(clip(horizontal - vertical, 0, 255), noise_k x 1)
// with cv2's rules: anchor k//2 (window [i - k//2, i - k//2 + k - 1]); erosion
// treats positions outside the image as +inf, dilation as -inf.
//
// What bounds it on an H100: a few bit operations per pixel, so bytes (the
// page read once, two masks written); at 4 x 1500 x 1065 uint8 that is a few
// microseconds, about what one launch costs, so the design is about doing
// everything in ONE launch with no serial per-pixel loop:
//   - bits, not bytes: values are exactly 0 or 255, so a block turns its
//     tile of x into a bit-plane in shared memory (one 32-bit word = 32
//     neighbouring columns of a row, bit j = column 32*word + j) and every
//     window min/max is an AND/OR of words: along a column the words of
//     neighbouring rows, along a row funnel-shifted words (the neighbouring
//     word supplies the bits that cross a word border). One instruction
//     treats 32 pixels; a window of k is k independent word operations.
//   - one launch: a block owns TR x TC output pixels, loads x for the tile
//     plus 2*(v_k - 1) halo rows and ceil(halo / 32) halo words on each side
//     (halo = 2*(h_k - 1) + 2*(noise_k - 1) columns, from the kernel sizes at
//     launch, so no fixed-halo limit), and runs the whole chain on it. The
//     vertical mask is never written to device memory as an intermediate.
//   - the cv2 border rule lives in two places only: bits outside the image
//     are ones in every plane an erosion reads (x and the subtract result)
//     and every erosion result is cleared outside the image before the
//     dilation reads it. Words outside the block's span read as zero; what
//     that spoils stays inside the halo.
//   - 256 threads a block; device memory is touched in aligned 16-byte
//     pieces. Rows of an odd width start at any alignment: a load takes the
//     whole piece anyway (it may reach into the neighbouring row) and masks
//     the bits it wants. For the stores, the border between two blocks'
//     columns moves, row by row, to the next 16-byte boundary (the halo is
//     that much wider), so only an image row's first and last piece go
//     element by element.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TR = 64;            // output rows per block
constexpr int TC = 256;           // output columns per block
constexpr int TCW = TC / 32;      // ... in words
constexpr int NTHREADS = 256;
constexpr int MAX_SMEM = 227 * 1024;

struct Geometry {
  int H, W;
  int av, bv;          // vertical window [i - av, i + bv]
  int a1, b1, a2, b2;  // horizontal windows of h_k and noise_k
  int lw;              // halo words left of the tile
  int nw;              // words per span row: lw + TCW + halo words right (the halo
                       // plus the pixels a shifted row reaches past the tile)
  int nr;              // rows of x held: TR + 2 * (av + bv)
};

// bits of global word gw (columns 32*gw .. 32*gw + 31) that lie in the image
__device__ __forceinline__ uint32_t col_mask(int gw, int W) {
  const int lo = gw * 32;
  if (lo < 0 || lo >= W) return 0u;
  const int n = W - lo;
  return n >= 32 ? 0xFFFFFFFFu : ((1u << n) - 1u);
}

__device__ __forceinline__ uint32_t span_word(const uint32_t* row, int q, int nw) {
  return (q >= 0 && q < nw) ? row[q] : 0u;
}

// word wi of the window [i - a, i + b] along a row: AND (erosion) or OR
// (dilation) of the row shifted by every d in [-a, b]
template <bool IS_AND>
__device__ __forceinline__ uint32_t row_window(const uint32_t* row, int wi, int nw,
                                               int a, int b) {
  uint32_t acc = IS_AND ? 0xFFFFFFFFu : 0u;
  int d = -a;
  while (d <= b) {
    const int q = wi + (d >> 5);                 // floor(d / 32)
    const uint32_t lo = span_word(row, q, nw);
    const uint32_t hi = span_word(row, q + 1, nw);
    const int last = min(b, (d | 31));           // last d with the same floor
#pragma unroll 4
    for (; d <= last; ++d) {
      const uint32_t v = __funnelshift_r(lo, hi, d & 31);
      acc = IS_AND ? (acc & v) : (acc | v);
    }
  }
  return acc;
}

// word wi of the window [r - a, r + b] down a column of words
template <bool IS_AND>
__device__ __forceinline__ uint32_t col_window(const uint32_t* plane, int r, int wi,
                                               int nw, int a, int b) {
  uint32_t acc = IS_AND ? 0xFFFFFFFFu : 0u;
  const uint32_t* p = plane + (r - a) * nw + wi;
#pragma unroll 4
  for (int d = 0; d <= a + b; ++d) {
    const uint32_t v = p[d * nw];
    acc = IS_AND ? (acc & v) : (acc | v);
  }
  return acc;
}

template <typename T> struct Piece;            // one aligned 16-byte piece
template <> struct Piece<uint8_t> {
  static constexpr int N = 16;
  static __device__ __forceinline__ uint32_t bits(const uint8_t* p) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    return nib4(v.x) | (nib4(v.y) << 4) | (nib4(v.z) << 8) | (nib4(v.w) << 12);
  }
  // 4 bytes -> 4 bits (byte j nonzero -> bit j): 0/1 per byte, then one
  // multiply gathers bits 0, 8, 16, 24 into bits 24..27 (no carries meet)
  static __device__ __forceinline__ uint32_t nib4(uint32_t w) {
    return (((__vcmpne4(w, 0u) & 0x01010101u) * 0x01020408u) >> 24) & 15u;
  }
  // 4 bits -> 4 bytes of 0 or 255: the multiply spreads bit j to bit 8 j
  static __device__ __forceinline__ uint32_t expand4(uint32_t nib) {
    return ((nib * 0x00204081u) & 0x01010101u) * 0xFFu;
  }
  static __device__ __forceinline__ void store(uint8_t* p, uint32_t bits) {
    *reinterpret_cast<uint4*>(p) = make_uint4(expand4(bits & 15u), expand4((bits >> 4) & 15u),
                                              expand4((bits >> 8) & 15u), expand4((bits >> 12) & 15u));
  }
  // elements [first, last) of the piece only: a row's head (first == 0) or
  // tail (last == 16) leaves in at most four aligned stores of 8, 4, 2, 1 bytes
  static __device__ __forceinline__ void store_part(uint8_t* p, uint32_t bits, int first,
                                                    int last) {
    if (first == 0) {
      int o = 0;
      if (last & 8) {
        *reinterpret_cast<uint2*>(p) = make_uint2(expand4(bits & 15u), expand4((bits >> 4) & 15u));
        o = 8;
      }
      if (last & 4) { *reinterpret_cast<uint32_t*>(p + o) = expand4((bits >> o) & 15u); o += 4; }
      if (last & 2) {
        *reinterpret_cast<uint16_t*>(p + o) = (uint16_t)expand4((bits >> o) & 3u);
        o += 2;
      }
      if (last & 1) p[o] = (bits >> o) & 1u ? 255 : 0;
    } else if (last == 16) {
      int o = first;
      if (o & 1) { p[o] = (bits >> o) & 1u ? 255 : 0; o += 1; }
      if (o & 2) {
        *reinterpret_cast<uint16_t*>(p + o) = (uint16_t)expand4((bits >> o) & 3u);
        o += 2;
      }
      if (o & 4) { *reinterpret_cast<uint32_t*>(p + o) = expand4((bits >> o) & 15u); o += 4; }
      if (o & 8)
        *reinterpret_cast<uint2*>(p + 8) = make_uint2(expand4((bits >> 8) & 15u),
                                                      expand4((bits >> 12) & 15u));
    } else {
      for (int e = first; e < last; ++e) p[e] = (bits >> e) & 1u ? 255 : 0;
    }
  }
};
template <> struct Piece<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ uint32_t bits(const float* p) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    return (v.x != 0.f ? 1u : 0u) | (v.y != 0.f ? 2u : 0u) | (v.z != 0.f ? 4u : 0u)
         | (v.w != 0.f ? 8u : 0u);
  }
  static __device__ __forceinline__ void store(float* p, uint32_t bits) {
    *reinterpret_cast<float4*>(p) = make_float4(bits & 1u ? 255.f : 0.f, bits & 2u ? 255.f : 0.f,
                                                bits & 4u ? 255.f : 0.f, bits & 8u ? 255.f : 0.f);
  }
  static __device__ __forceinline__ void store_part(float* p, uint32_t bits, int first,
                                                    int last) {
    for (int e = first; e < last; ++e) p[e] = (bits >> e) & 1u ? 255.f : 0.f;
  }
};

// elements by which p lies past a 16-byte boundary
template <typename T>
__device__ __forceinline__ int misalign(const T* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) & 15u) / sizeof(T));
}

// (row, column) of a flat index that advances by `stride` over rows of `n`
// items, without a division per step
struct Walk {
  int r, c, n, dr, dc;
  __device__ __forceinline__ Walk(int start, int n_, int stride)
      : r(start / n_), c(start % n_), n(n_), dr(stride / n_), dc(stride % n_) {}
  __device__ __forceinline__ void next() {
    r += dr; c += dc;
    if (c >= n) { c -= n; ++r; }
  }
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
separator_morphology_kernel(const T* __restrict__ x, T* __restrict__ hout,
                            T* __restrict__ vout, Geometry g) {
  extern __shared__ uint32_t smem[];
  constexpr int N = Piece<T>::N;
  const int nw = g.nw, nr = g.nr;
  uint32_t* X = smem;                 // [nr][nw] x, ones outside the image
  uint32_t* EV = X + nr * nw;         // [nr][nw] vertical erosion
  uint32_t* PA = EV + nr * nw;        // [TR][nw] h_k erosion, later noise_k erosion
  uint32_t* PB = PA + TR * nw;        // [TR][nw] subtract result, later horizontal
  uint32_t* PV = PB + TR * nw;        // [TR][nw] vertical
  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * TR;               // first output row
  const int c0 = blockIdx.x * TC;               // first output column
  const int w0 = c0 / 32 - g.lw;                // global word of span word 0
  const int top = r0 - 2 * g.av;                // global row of plane row 0
  const size_t img = (size_t)blockIdx.z * g.H * g.W;
  const T* x_end = x + (size_t)gridDim.z * g.H * g.W;

  // ---- x -> bit-plane. Fill first (ones outside the image), then OR the
  // loaded bits in, four pieces in flight per thread.
  for (Walk w(tid, nw, NTHREADS); w.r < nr; w.next()) {
    const int gy = top + w.r;
    X[w.r * nw + w.c] = (gy >= 0 && gy < g.H) ? ~col_mask(w0 + w.c, g.W) : 0xFFFFFFFFu;
  }
  __syncthreads();
  {
    const int cs = max(0, w0 * 32), ce = min(g.W, (w0 + nw) * 32);
    Walk w(tid, (nw * 32) / N + 1, NTHREADS);
    while (w.r < nr) {
      uint32_t bits[4];
      int at[4];                                         // bit position in X, -1: none
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        at[u] = -1;
        const int gy = top + w.r;
        if (w.r < nr && gy >= 0 && gy < g.H) {
          const T* row = x + img + (size_t)gy * g.W;
          const int lo = cs - misalign(row + cs) + w.c * N;   // first column of the piece
          if (lo < ce) {
            // the aligned piece may reach past the span's columns, into the
            // neighbouring row too: load it whole wherever the tensor has
            // it, then keep the bits of columns [cs, ce)
            const T* p = row + lo;
            uint32_t v;
            if (p >= x && p + N <= x_end) {
              v = Piece<T>::bits(p);
            } else {                                    // first or last piece of the tensor
              v = 0;
#pragma unroll
              for (int e = 0; e < N; ++e)
                if (p + e >= x && p + e < x_end) v |= (p[e] != T(0) ? 1u : 0u) << e;
            }
            v &= ((1u << min(ce - lo, N)) - 1u) & ~((1u << max(cs - lo, 0)) - 1u);
            int pos = lo - w0 * 32;
            if (pos < 0) { v >>= -pos; pos = 0; }
            bits[u] = v;
            at[u] = w.r * nw * 32 + pos;
          }
        }
        w.next();
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (at[u] < 0 || bits[u] == 0) continue;
        const int word = at[u] >> 5, sh = at[u] & 31;
        atomicOr(&X[word], bits[u] << sh);
        // a piece that crosses a word border never sits in a row's last word
        if (sh + N > 32 && (bits[u] >> (32 - sh))) atomicOr(&X[word + 1], bits[u] >> (32 - sh));
      }
    }
  }
  __syncthreads();

  // ---- erosions of x: down the columns (v_k) on every row that has its
  // window in the plane, along the rows (h_k) on the tile's rows
  for (Walk w(tid, nw, NTHREADS); w.r < nr - g.av - g.bv; w.next()) {
    const int rb = g.av + w.r;
    const int gy = top + rb;
    const uint32_t inside = (gy >= 0 && gy < g.H) ? col_mask(w0 + w.c, g.W) : 0u;
    EV[rb * nw + w.c] = col_window<true>(X, rb, w.c, nw, g.av, g.bv) & inside;
  }
  for (Walk w(tid, nw, NTHREADS); w.r < TR; w.next()) {
    const uint32_t inside = r0 + w.r < g.H ? col_mask(w0 + w.c, g.W) : 0u;
    PA[w.r * nw + w.c] =
        row_window<true>(X + (w.r + 2 * g.av) * nw, w.c, nw, g.a1, g.b1) & inside;
  }
  __syncthreads();

  // ---- both dilations and the subtract; ones outside the image again for
  // the noise_k erosion
  for (Walk w(tid, nw, NTHREADS); w.r < TR; w.next()) {
    const uint32_t inside = r0 + w.r < g.H ? col_mask(w0 + w.c, g.W) : 0u;
    const uint32_t v = col_window<false>(EV, w.r + 2 * g.av, w.c, nw, g.av, g.bv);
    const uint32_t h = row_window<false>(PA + w.r * nw, w.c, nw, g.a1, g.b1);
    PV[w.r * nw + w.c] = v;
    PB[w.r * nw + w.c] = (h & ~v) | ~inside;
  }
  __syncthreads();
  for (Walk w(tid, nw, NTHREADS); w.r < TR; w.next()) {
    const uint32_t inside = r0 + w.r < g.H ? col_mask(w0 + w.c, g.W) : 0u;
    PA[w.r * nw + w.c] = row_window<true>(PB + w.r * nw, w.c, nw, g.a2, g.b2) & inside;
  }
  __syncthreads();
  for (int i = tid; i < TR * (TCW + 1); i += NTHREADS) {   // + the word a shifted row reaches
    const int t = i / (TCW + 1), wi = g.lw + i % (TCW + 1);
    PB[t * nw + wi] = row_window<false>(PA + t * nw, wi, nw, g.a2, g.b2);
  }
  __syncthreads();

  // ---- bits -> 0/255, both masks (rows 0 .. TR-1 horizontal, then vertical).
  // A row of an odd width starts at any alignment, so in each row the
  // border between two blocks' columns moves right to the next 16-byte
  // boundary: every piece is then whole, but for a row's first and last.
  for (Walk w(tid, TC / N + 2, NTHREADS); w.r < 2 * TR; w.next()) {
    const int which = w.r >= TR, t = w.r - which * TR;
    const int gy = r0 + t;
    if (gy >= g.H) continue;
    T* row = (which ? vout : hout) + img + (size_t)gy * g.W;
    const uint32_t* plane = (which ? PV : PB) + t * nw;
    const int shift = (N - misalign(row + c0)) % N;
    const int cs = blockIdx.x == 0 ? 0 : min(c0 + shift, g.W);
    const int ce = min(g.W, c0 + TC + shift);
    const int lo = cs - misalign(row + cs) + w.c * N;
    if (lo >= ce) continue;
    // the piece's 16 bits from bit position lo - w0 * 32 of the span row
    // (negative only left of an image row's start, where no bit is wanted)
    const int pos = lo - w0 * 32;
    const uint32_t bits = __funnelshift_r(span_word(plane, pos >> 5, nw),
                                          span_word(plane, (pos >> 5) + 1, nw), pos & 31);
    if (lo >= cs && lo + N <= ce) Piece<T>::store(row + lo, bits);
    else Piece<T>::store_part(row + lo, bits, max(cs - lo, 0), min(ce - lo, N));
  }
}

template <typename T>
int launch_typed(const void* x, void* h, void* v, int B, int H, int W,
                 int hk, int vk, int nk, cudaStream_t stream) {
  Geometry g;
  g.H = H; g.W = W;
  g.av = vk / 2; g.bv = vk - 1 - g.av;
  g.a1 = hk / 2; g.b1 = hk - 1 - g.a1;
  g.a2 = nk / 2; g.b2 = nk - 1 - g.a2;
  g.lw = (2 * (g.a1 + g.a2) + 31) / 32;
  g.nw = g.lw + TCW + (2 * (g.b1 + g.b2) + Piece<T>::N - 1 + 31) / 32;
  g.nr = TR + 2 * (g.av + g.bv);
  const size_t smem = sizeof(uint32_t) * ((size_t)2 * g.nr + 3 * TR) * g.nw;
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        separator_morphology_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + TC - 1) / TC, (H + TR - 1) / TR, B);
  separator_morphology_kernel<T><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(h), static_cast<T*>(v), g);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 2 = uint8. x, h, v are [B, H, W], contiguous.
// Returns the cudaError_t of the launch.
extern "C" int citlab_separator_morphology(const void* x, void* h, void* v,
                                           int B, int H, int W, int h_k, int v_k,
                                           int noise_k, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || h_k < 1 || v_k < 1 || noise_k < 1 || B > 65535
      || (H + TR - 1) / TR > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_typed<float>(x, h, v, B, H, W, h_k, v_k, noise_k, s);
  if (dtype == 2) return launch_typed<uint8_t>(x, h, v, B, H, W, h_k, v_k, noise_k, s);
  return (int)cudaErrorInvalidValue;
}

// Name of a cudaError_t returned by an entry point of this library.
extern "C" const char* citlab_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
