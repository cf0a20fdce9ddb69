// K1: exact SAME 3x3 stride-1 convolution, NHWC, + bias + optional ReLU.
//
// Replaces the Pallas TPU kernel citlab_as_tpu/ops/pallas/conv3x3.py
// (conv3x3_mxu, body _conv_kernel, weight packing _pack_weights), which the
// ARU-Net routes its low-channel 3x3 convs through (Cout in {8, 16, 32},
// Cin >= 8). The TPU design packs P = 128/Cout output columns per lane row
// and pre-slices six views of the input because Mosaic cannot regroup lanes;
// none of that is carried over.
//
// What bounds it on an H100: per pixel a conv does 2*9*Cin*Cout operations
// against (Cin + Cout) values moved, 36 to 96 operations per byte in bf16 at
// the ARU-Net's pairs (8->8 .. 64->32). That is below the bf16 tensor-core
// ridge (~295 op/B): on the tensor cores the bound is bytes, on the CUDA
// cores (67 TFLOP/s f32, ridge ~20 op/B) it would be operations. So:
//
// bf16 (the main path): an implicit GEMM on the tensor cores. M = the output
// pixels of a tile, N = Cout, K = 9 * Cin, never materialised: the nine taps
// are nine shifted views of one halo tile in shared memory.
//   - mma.sync.m16n8k16 (bf16 in, f32 accumulate), fragments by ldmatrix. An
//     M fragment is 16 neighbouring pixels of an output row; a warp owns one
//     row of the tile, MF M fragments x Cout/8 N fragments of accumulators
//     (64 registers at most). Cin = 8 fills half a k16 step, so it takes
//     mma.sync.m16n8k8 (one tap = one k step). mma.sync is enough because N is
//     8..32 and the kernel is bytes-bound; wgmma's 64-row tiles buy nothing
//     here. Tile rows are 64 pixels (MF = 4) where two such blocks fit in an
//     SM's shared memory, else 32; the k steps per tap are a compile-time
//     constant at the ARU-Net's widths (Cin 16, 32, 64), so that one step's
//     ldmatrix is scheduled under another's mma.
//   - weights come packed [tap][Cout][Cin (+ pad)] (ops/kernels/conv3x3.py::
//     pack_weights, once per weight tensor) and stay in shared memory for the
//     life of the block; a B fragment is one ldmatrix, no transpose.
//   - the (8+2) x (TW+2) halo tile is bf16, brought in by cp.async in
//     16-byte pieces; SAME padding (and channels past Cin) is cp.async's
//     zero-fill form (src-size 0), in load_tile and nowhere else. Two stages:
//     blocks are persistent (grid = what fits on the card, at most the number
//     of tiles) and tile n+1 loads while tile n multiplies.
//   - a pixel's pitch in shared memory is an odd number of 16-byte pieces
//     (Cin*2 + 16 bytes), so the 8 rows of an ldmatrix fall on distinct banks.
//   - epilogue: bias and ReLU on the f32 accumulators, one rounding to bf16,
//     then through a warp-private strip of shared memory so that a warp's
//     output row (TW * Cout * 2 contiguous bytes in NHWC) leaves in 16-byte
//     stores, neighbouring lanes on neighbouring addresses.
//
// f32 (the parity path): held to 1e-4 against a full-f32 reference, which
// TF32 mma does not meet, so it stays on the CUDA cores with f32 FMAs. It
// shares the packed weights, the cp.async loads (double-buffered over chunks
// of 8 input channels) and the 16-byte stores.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TH = 8;            // output rows per tile (bf16: one per warp)
constexpr int IN_H = TH + 2;
constexpr int NT = 256;          // threads of the bf16 kernel
constexpr int MAX_SMEM = 227 * 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; src_bytes = 0 writes 16 zero bytes instead
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x1(uint32_t& r0, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];\n"
               : "=r"(r0) : "r"(addr));
}
__device__ __forceinline__ void mma_k16(float (&c)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_k8(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

struct Shape {
  int B, H, W, Cin;
  int cinp;      // channels per pixel in shared memory (Cin rounded up)
  int pitch;     // bytes per pixel in shared memory = bytes per packed weight row
  int tiles_x, tiles_y, ntiles;
  int relu;
};

// ------------------------------------------------------------------ bf16

// The halo tile of `tile` into one stage. The only place that knows the
// border: a piece outside the image, or past Cin, is zero-filled.
template <int IN_W>
__device__ __forceinline__ void load_tile(const bf16* __restrict__ x, unsigned char* stage,
                                          int tile, const Shape& s) {
  const int per_img = s.tiles_x * s.tiles_y;
  const int b = tile / per_img;
  const int rem = tile - b * per_img;
  const int oy0 = (rem / s.tiles_x) * TH;
  const int ox0 = (rem % s.tiles_x) * (IN_W - 2);
  const bf16* xb = x + (size_t)b * s.H * s.W * s.Cin;
  if ((s.Cin & 7) == 0) {
    const int npc = s.cinp >> 3;                      // 16-byte pieces per pixel
    const uint32_t base = smem_u32(stage);
    for (int i = threadIdx.x; i < IN_H * IN_W * npc; i += NT) {
      const int piece = i % npc, pix = i / npc;
      const int gy = oy0 - 1 + pix / IN_W, gx = ox0 - 1 + pix % IN_W;
      const bool ok = gy >= 0 && gy < s.H && gx >= 0 && gx < s.W && piece * 8 < s.Cin;
      const bf16* src = ok ? xb + ((size_t)gy * s.W + gx) * s.Cin + piece * 8 : x;
      cp_async16(base + pix * s.pitch + piece * 16, src, ok ? 16 : 0);
    }
  } else {                                            // pixels not 16-byte aligned
    for (int i = threadIdx.x; i < IN_H * IN_W * s.cinp; i += NT) {
      const int ch = i % s.cinp, pix = i / s.cinp;
      const int gy = oy0 - 1 + pix / IN_W, gx = ox0 - 1 + pix % IN_W;
      const bool ok = gy >= 0 && gy < s.H && gx >= 0 && gx < s.W && ch < s.Cin;
      *reinterpret_cast<bf16*>(stage + pix * s.pitch + ch * 2) =
          ok ? xb[((size_t)gy * s.W + gx) * s.Cin + ch] : __float2bfloat16(0.f);
    }
  }
}

// COUT: 8, 16, 32. MF: M fragments (16 pixels) per warp, TW = 16 * MF.
// KC: k16 steps per tap (cinp / 16) as a constant, so that the compiler can
// schedule one step's ldmatrix under another's mma; 0: read from cinp at run
// time; -1: Cin == 8, one m16n8k8 per tap instead.
template <int COUT, int MF, int KC>
__global__ void __launch_bounds__(NT)
conv3x3_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wpk,
                   const bf16* __restrict__ bias, bf16* __restrict__ y, Shape s) {
  constexpr int TW = 16 * MF;
  constexpr int IN_W = TW + 2;
  constexpr int NF = COUT / 8;
  constexpr int OPITCH = 16 * (NF | 1);     // bytes per pixel in the output strip
  constexpr bool K8 = KC < 0;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* s_w = smem;                                 // [9][COUT][pitch]
  unsigned char* s_out = s_w + 9 * COUT * s.pitch;           // [8 warps][TW][OPITCH]
  unsigned char* s_in = s_out + TH * TW * OPITCH;            // 2 x [IN_H][IN_W][pitch]
  const int stage_bytes = IN_H * IN_W * s.pitch;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // weights (a flat copy: the packed tensor has the shared-memory layout)
  // and the first tile form the first cp.async group
  {
    const uint32_t base = smem_u32(s_w);
    const unsigned char* src = reinterpret_cast<const unsigned char*>(wpk);
    for (int i = tid; i < 9 * COUT * (s.pitch >> 4); i += NT)
      cp_async16(base + i * 16, src + (size_t)i * 16, 16);
  }
  int tile = blockIdx.x;
  int cur = 0;
  if (tile < s.ntiles) load_tile<IN_W>(x, s_in, tile, s);
  cp_async_commit();

  float bv[NF][2];
#pragma unroll
  for (int n = 0; n < NF; ++n) {
    bv[n][0] = __bfloat162float(bias[n * 8 + 2 * t]);
    bv[n][1] = __bfloat162float(bias[n * 8 + 2 * t + 1]);
  }

  // per-lane byte offsets of the ldmatrix row addresses
  uint32_t a_lane, b_lane;
  if constexpr (K8) {
    a_lane = lane * 16;                                  // 32 pixels = 2 M fragments
    b_lane = (lane % COUT) * s.pitch;                    // matrix n = lane / 8
  } else {
    a_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * s.pitch + (lane >> 4) * 16;
    b_lane = (NF == 1 ? (lane & 7) : ((lane >> 4) * 8 + (lane & 7))) * s.pitch
           + ((lane >> 3) & 1) * 16;
  }
  const uint32_t w_addr = smem_u32(s_w) + b_lane;
  unsigned char* strip = s_out + warp * TW * OPITCH;
  const int per_img = s.tiles_x * s.tiles_y;

  for (; tile < s.ntiles; tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (next < s.ntiles) load_tile<IN_W>(x, s_in + (cur ^ 1) * stage_bytes, next, s);
    cp_async_commit();
    cp_async_wait<1>();          // everything but the newest group has landed
    __syncthreads();

    float acc[MF][NF][4];
#pragma unroll
    for (int m = 0; m < MF; ++m)
#pragma unroll
      for (int n = 0; n < NF; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

    const uint32_t in_addr = smem_u32(s_in + cur * stage_bytes) + a_lane;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const uint32_t a_tap = in_addr + ((warp + ky) * IN_W + kx) * s.pitch;
        const uint32_t b_tap = w_addr + (ky * 3 + kx) * COUT * s.pitch;
        if constexpr (K8) {
          uint32_t b[4];
          if constexpr (NF == 4) ldsm_x4(b[0], b[1], b[2], b[3], b_tap);
          else if constexpr (NF == 2) ldsm_x2(b[0], b[1], b_tap);
          else ldsm_x1(b[0], b_tap);
#pragma unroll
          for (int mp = 0; mp < MF / 2; ++mp) {
            uint32_t a[4];
            ldsm_x4(a[0], a[1], a[2], a[3], a_tap + mp * 32 * 16);
#pragma unroll
            for (int n = 0; n < NF; ++n) {
              mma_k8(acc[2 * mp][n], a[0], a[1], b[n]);
              mma_k8(acc[2 * mp + 1][n], a[2], a[3], b[n]);
            }
          }
        } else {
          const int ksteps = KC > 0 ? KC : (s.cinp >> 4);
#pragma unroll
          for (int kc = 0; kc < ksteps; ++kc) {
            uint32_t b[NF][2];
            if constexpr (NF == 1) {
              ldsm_x2(b[0][0], b[0][1], b_tap + kc * 32);
            } else {
#pragma unroll
              for (int j = 0; j < NF / 2; ++j)
                ldsm_x4(b[2 * j][0], b[2 * j][1], b[2 * j + 1][0], b[2 * j + 1][1],
                        b_tap + j * 16 * s.pitch + kc * 32);
            }
#pragma unroll
            for (int m = 0; m < MF; ++m) {
              uint32_t a[4];
              ldsm_x4(a[0], a[1], a[2], a[3], a_tap + m * 16 * s.pitch + kc * 32);
#pragma unroll
              for (int n = 0; n < NF; ++n) mma_k16(acc[m][n], a, b[n]);
            }
          }
        }
      }
    }

    // epilogue: accumulator (row g / g+8, cols 2t, 2t+1 of each 16 x 8
    // fragment) -> the warp's strip -> 16-byte stores
#pragma unroll
    for (int m = 0; m < MF; ++m) {
#pragma unroll
      for (int n = 0; n < NF; ++n) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float v0 = acc[m][n][2 * half] + bv[n][0];
          float v1 = acc[m][n][2 * half + 1] + bv[n][1];
          if (s.relu) { v0 = fmaxf(v0, 0.f); v1 = fmaxf(v1, 0.f); }
          *reinterpret_cast<__nv_bfloat162*>(
              strip + (m * 16 + g + 8 * half) * OPITCH + n * 16 + t * 4) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    __syncwarp();
    {
      const int b = tile / per_img;
      const int rem = tile - b * per_img;
      const int oy = (rem / s.tiles_x) * TH + warp;
      const int ox0 = (rem % s.tiles_x) * TW;
      if (oy < s.H) {
        unsigned char* yrow = reinterpret_cast<unsigned char*>(
            y + (((size_t)b * s.H + oy) * s.W + ox0) * COUT);
        for (int j = lane; j < TW * NF; j += 32) {
          const int pix = j / NF, part = j % NF;
          if (ox0 + pix < s.W)
            *reinterpret_cast<uint4*>(yrow + (size_t)j * 16) =
                *reinterpret_cast<const uint4*>(strip + pix * OPITCH + part * 16);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage before it is refilled
    cur ^= 1;
  }
  cp_async_wait<0>();
}

constexpr int MAX_DEVICES = 64;

int sm_count(int dev) {
  static int n[MAX_DEVICES] = {};
  if (n[dev] == 0) cudaDeviceGetAttribute(&n[dev], cudaDevAttrMultiProcessorCount, dev);
  return n[dev];
}

// dynamic shared memory of conv3x3_mma_kernel: weights, output strips, 2 stages
size_t mma_smem(int cout, int mf, int pitch) {
  const int tw = 16 * mf, opitch = 16 * ((cout / 8) | 1);
  return (size_t)9 * cout * pitch + (size_t)TH * tw * opitch
       + (size_t)2 * IN_H * (tw + 2) * pitch;
}

template <int COUT, int MF, int KC>
int launch_mma(const void* x, const void* wpk, const void* bias, void* y, Shape s,
               cudaStream_t stream) {
  constexpr int TW = 16 * MF;
  auto kern = conv3x3_mma_kernel<COUT, MF, KC>;
  s.tiles_x = (s.W + TW - 1) / TW;
  s.tiles_y = (s.H + TH - 1) / TH;
  const long long ntiles = (long long)s.tiles_x * s.tiles_y * s.B;
  if (ntiles > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  s.ntiles = (int)ntiles;
  const size_t smem = mma_smem(COUT, MF, s.pitch);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  // the attribute and the occupancy depend on (device, kernel, smem) only:
  // ask once per size. (Racing callers at worst ask twice, or run with the
  // other size's grid, which any grid size of a persistent kernel survives.)
  static size_t allowed[MAX_DEVICES] = {}, asked[MAX_DEVICES] = {};
  static int blocks_per_sm[MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= MAX_DEVICES)
    return (int)cudaErrorInvalidDevice;
  if (smem > allowed[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed[dev] = smem;
  }
  if (smem != asked[dev]) {
    int n = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, NT, smem);
    if (e != cudaSuccess) return (int)e;
    if (n < 1) return (int)cudaErrorLaunchOutOfResources;
    blocks_per_sm[dev] = n;
    asked[dev] = smem;
  }
  const long long fit = (long long)blocks_per_sm[dev] * sm_count(dev);
  const int grid = (int)(ntiles < fit ? ntiles : fit);
  kern<<<grid, NT, smem, stream>>>(static_cast<const bf16*>(x), static_cast<const bf16*>(wpk),
                                   static_cast<const bf16*>(bias), static_cast<bf16*>(y), s);
  return (int)cudaGetLastError();
}

template <int COUT>
int launch_bf16(const void* x, const void* wpk, const void* bias, void* y, const Shape& s,
                cudaStream_t stream) {
  if (s.Cin == 8) {
    if (s.cinp != 8 || s.pitch != 16) return (int)cudaErrorInvalidValue;
    return launch_mma<COUT, 4, -1>(x, wpk, bias, y, s, stream);
  }
  if (s.cinp % 16 != 0 || s.cinp < s.Cin || s.pitch != 16 * ((s.cinp / 8) | 1))
    return (int)cudaErrorInvalidValue;
  // 64-pixel tile rows (4 M fragments a warp, each B fragment used 4 times)
  // when two blocks of them fit in an SM's shared memory (228 KB, 1 KB of it
  // reserved per block); else 32-pixel rows, so that more than one block's
  // 8 warps hide each other's barriers and epilogues
  const bool wide = 2 * (mma_smem(COUT, 4, s.pitch) + 1024) <= 228 * 1024;
  switch (s.cinp) {      // the ARU-Net's widths get their k steps unrolled
    case 16:
      return wide ? launch_mma<COUT, 4, 1>(x, wpk, bias, y, s, stream)
                  : launch_mma<COUT, 2, 1>(x, wpk, bias, y, s, stream);
    case 32: return launch_mma<COUT, 2, 2>(x, wpk, bias, y, s, stream);
    case 64: return launch_mma<COUT, 2, 4>(x, wpk, bias, y, s, stream);
  }
  return wide ? launch_mma<COUT, 4, 0>(x, wpk, bias, y, s, stream)
              : launch_mma<COUT, 2, 0>(x, wpk, bias, y, s, stream);
}

// ------------------------------------------------------------------- f32

constexpr int F_TW = 32;              // output columns per block
constexpr int F_IN_W = F_TW + 2;
constexpr int F_NT = 128;             // 8 rows x 16 threads, 2 pixels each
constexpr int F_CK = 8;               // input channels per stage
constexpr int F_PP = 12;              // floats per pixel in shared memory (8 + pad)

template <int COUT>
__device__ __forceinline__ void load_chunk_f32(const float* __restrict__ xb,
                                               const float* __restrict__ wpk, float* stage,
                                               int chunk, int oy0, int ox0, const Shape& s) {
  float* s_w = stage + IN_H * F_IN_W * F_PP;
  const int c0 = chunk * F_CK;
  if ((s.Cin & 3) == 0) {
    const uint32_t base = smem_u32(stage);
    for (int i = threadIdx.x; i < IN_H * F_IN_W * 2; i += F_NT) {
      const int piece = i & 1, pix = i >> 1;
      const int gy = oy0 - 1 + pix / F_IN_W, gx = ox0 - 1 + pix % F_IN_W;
      const int ch = c0 + piece * 4;
      const bool ok = gy >= 0 && gy < s.H && gx >= 0 && gx < s.W && ch < s.Cin;
      const float* src = ok ? xb + ((size_t)gy * s.W + gx) * s.Cin + ch : xb;
      cp_async16(base + (pix * F_PP + piece * 4) * 4, src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < IN_H * F_IN_W * F_CK; i += F_NT) {
      const int ci = i % F_CK, pix = i / F_CK;
      const int gy = oy0 - 1 + pix / F_IN_W, gx = ox0 - 1 + pix % F_IN_W;
      const bool ok = gy >= 0 && gy < s.H && gx >= 0 && gx < s.W && c0 + ci < s.Cin;
      stage[pix * F_PP + ci] = ok ? xb[((size_t)gy * s.W + gx) * s.Cin + c0 + ci] : 0.f;
    }
  }
  const uint32_t wbase = smem_u32(s_w);
  for (int i = threadIdx.x; i < 9 * COUT * 2; i += F_NT) {
    const int piece = i & 1, row = i >> 1;
    cp_async16(wbase + (row * F_CK + piece * 4) * 4,
               wpk + (size_t)row * s.cinp + c0 + piece * 4, 16);
  }
}

template <int COUT>
__global__ void __launch_bounds__(F_NT)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ wpk,
                   const float* __restrict__ bias, float* __restrict__ y, Shape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int STAGE = IN_H * F_IN_W * F_PP + 9 * COUT * F_CK;    // floats
  float* stages = reinterpret_cast<float*>(smem);
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * TH, ox0 = blockIdx.x * F_TW;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* xb = x + (size_t)b * s.H * s.W * s.Cin;

  float acc0[COUT], acc1[COUT];
#pragma unroll
  for (int co = 0; co < COUT; ++co) { acc0[co] = 0.f; acc1[co] = 0.f; }

  const int nchunks = s.cinp / F_CK;
  load_chunk_f32<COUT>(xb, wpk, stages, 0, oy0, ox0, s);
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks)
      load_chunk_f32<COUT>(xb, wpk, stages + ((c + 1) & 1) * STAGE, c + 1, oy0, ox0, s);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* s_in = stages + (c & 1) * STAGE;
    const float* s_w = s_in + IN_H * F_IN_W * F_PP;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float4* p0 = reinterpret_cast<const float4*>(
            s_in + ((ty + ky) * F_IN_W + tx + kx) * F_PP);
        const float4* p1 = reinterpret_cast<const float4*>(
            s_in + ((ty + ky) * F_IN_W + tx + 16 + kx) * F_PP);
        const float4 a0l = p0[0], a0h = p0[1], a1l = p1[0], a1h = p1[1];
        const float4* wv = reinterpret_cast<const float4*>(s_w + (ky * 3 + kx) * COUT * F_CK);
#pragma unroll
        for (int co = 0; co < COUT; ++co) {
          const float4 wl = wv[2 * co], wh = wv[2 * co + 1];
          float v0 = acc0[co], v1 = acc1[co];
          v0 = fmaf(a0l.x, wl.x, v0); v0 = fmaf(a0l.y, wl.y, v0);
          v0 = fmaf(a0l.z, wl.z, v0); v0 = fmaf(a0l.w, wl.w, v0);
          v0 = fmaf(a0h.x, wh.x, v0); v0 = fmaf(a0h.y, wh.y, v0);
          v0 = fmaf(a0h.z, wh.z, v0); v0 = fmaf(a0h.w, wh.w, v0);
          v1 = fmaf(a1l.x, wl.x, v1); v1 = fmaf(a1l.y, wl.y, v1);
          v1 = fmaf(a1l.z, wl.z, v1); v1 = fmaf(a1l.w, wl.w, v1);
          v1 = fmaf(a1h.x, wh.x, v1); v1 = fmaf(a1h.y, wh.y, v1);
          v1 = fmaf(a1h.z, wh.z, v1); v1 = fmaf(a1h.w, wh.w, v1);
          acc0[co] = v0; acc1[co] = v1;
        }
      }
    }
    __syncthreads();
  }

  const int oy = oy0 + ty;
  if (oy >= s.H) return;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int ox = ox0 + tx + 16 * p;
    if (ox >= s.W) continue;
    float4* yp = reinterpret_cast<float4*>(y + (((size_t)b * s.H + oy) * s.W + ox) * COUT);
#pragma unroll
    for (int q = 0; q < COUT / 4; ++q) {
      float4 v;
      v.x = (p ? acc1[4 * q + 0] : acc0[4 * q + 0]) + bias[4 * q + 0];
      v.y = (p ? acc1[4 * q + 1] : acc0[4 * q + 1]) + bias[4 * q + 1];
      v.z = (p ? acc1[4 * q + 2] : acc0[4 * q + 2]) + bias[4 * q + 2];
      v.w = (p ? acc1[4 * q + 3] : acc0[4 * q + 3]) + bias[4 * q + 3];
      if (s.relu) {
        v.x = fmaxf(v.x, 0.f); v.y = fmaxf(v.y, 0.f);
        v.z = fmaxf(v.z, 0.f); v.w = fmaxf(v.w, 0.f);
      }
      yp[q] = v;
    }
  }
}

template <int COUT>
int launch_f32(const void* x, const void* wpk, const void* bias, void* y, Shape s,
               cudaStream_t stream) {
  if (s.cinp % F_CK != 0 || s.cinp < s.Cin || s.pitch != s.cinp * 4)
    return (int)cudaErrorInvalidValue;
  auto kern = conv3x3_f32_kernel<COUT>;
  s.tiles_x = (s.W + F_TW - 1) / F_TW;
  s.tiles_y = (s.H + TH - 1) / TH;
  if (s.tiles_y > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 2 * (IN_H * F_IN_W * F_PP + 9 * COUT * F_CK);
  static bool allowed[MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= MAX_DEVICES)
    return (int)cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed[dev] = true;
  }
  const dim3 grid(s.tiles_x, s.tiles_y, s.B);
  kern<<<grid, F_NT, smem, stream>>>(static_cast<const float*>(x),
                                     static_cast<const float*>(wpk),
                                     static_cast<const float*>(bias), static_cast<float*>(y), s);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, H, W, Cin] and y [B, H, W, Cout] NHWC, contiguous, 16-byte aligned;
// wpk the packed weights [9][Cout][pitch bytes] of pack_weights (channels
// padded with zeros to cinp); dtype 0 = float32, 1 = bfloat16. Returns the
// cudaError_t of the launch.
extern "C" int citlab_conv3x3(const void* x, const void* wpk, const void* bias,
                              void* y, int B, int H, int W, int Cin, int Cout,
                              int cinp, int pitch, int relu, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  Shape s;
  s.B = B; s.H = H; s.W = W; s.Cin = Cin; s.cinp = cinp; s.pitch = pitch;
  s.tiles_x = s.tiles_y = s.ntiles = 0;
  s.relu = relu;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (Cout) {
      case 8: return launch_bf16<8>(x, wpk, bias, y, s, st);
      case 16: return launch_bf16<16>(x, wpk, bias, y, s, st);
      case 32: return launch_bf16<32>(x, wpk, bias, y, s, st);
    }
  } else if (dtype == 0) {
    switch (Cout) {
      case 8: return launch_f32<8>(x, wpk, bias, y, s, st);
      case 16: return launch_f32<16>(x, wpk, bias, y, s, st);
      case 32: return launch_f32<32>(x, wpk, bias, y, s, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// Name of a cudaError_t returned by an entry point of this library.
extern "C" const char* citlab_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
