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
// ridge (~295 op/B), so with tensor cores the bound is bytes; on the CUDA
// cores (67 TFLOP/s f32, ridge ~20 op/B) it is bound by operations. This
// first kernel is the simple direct form on the CUDA cores (f32 FMA, f32
// accumulation), so it sits well above the bytes bound:
//   - a block computes an 8 x 32 tile of output pixels x all Cout;
//   - the (8+2) x (32+2) input halo is staged in shared memory as f32, in
//     chunks of 8 input channels, together with the chunk's 9 x 8 x Cout
//     weights, so every input value is read once from device memory per
//     block and reused 9*Cout times from shared memory;
//   - each thread owns 2 output pixels x Cout accumulators in registers;
//     one float4 weight load (a warp-wide broadcast) feeds 8 FMAs;
//   - the shared-memory row pitch is 48 floats (16 mod 32 banks), so the two
//     rows a warp reads fall on disjoint banks.
// Bias and ReLU are fused into the epilogue; the output is rounded once to
// the input dtype. wgmma / TMA are left for a later, faster version.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;          // output rows per block
constexpr int TW = 32;         // output cols per block
constexpr int CK = 8;          // input channels per shared-memory chunk
constexpr int NTHREADS = 128;  // 8 rows x 16 threads, 2 pixels each
constexpr int IN_H = TH + 2;
constexpr int IN_W = TW + 2;
constexpr int SROW = 48;       // >= IN_W and 16 mod 32: conflict-free rows

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int COUT>
__global__ void __launch_bounds__(NTHREADS)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const T* __restrict__ bias, T* __restrict__ y,
               int H, int W, int Cin, int relu) {
  __shared__ float s_in[CK][IN_H][SROW];
  __shared__ __align__(16) float s_w[9][CK][COUT];

  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * TH;
  const int ox0 = blockIdx.x * TW;
  const int t = threadIdx.x;
  const int ty = t / 16;
  const int tx = t % 16;

  float acc0[COUT], acc1[COUT];
#pragma unroll
  for (int co = 0; co < COUT; ++co) { acc0[co] = 0.f; acc1[co] = 0.f; }

  const T* xb = x + (size_t)b * H * W * Cin;
  for (int c0 = 0; c0 < Cin; c0 += CK) {
    // input halo tile, channel-fastest so consecutive threads read
    // consecutive addresses; zero outside the image (SAME padding)
    for (int i = t; i < IN_H * IN_W * CK; i += NTHREADS) {
      const int ci = i % CK;
      const int p = i / CK;
      const int c = p % IN_W;
      const int r = p / IN_W;
      const int gy = oy0 - 1 + r, gx = ox0 - 1 + c, gc = c0 + ci;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && gc < Cin)
        v = to_f(xb[((size_t)gy * W + gx) * Cin + gc]);
      s_in[ci][r][c] = v;
    }
    // weights are OIHW: w[co][ci][ky][kx] -> s_w[ky*3+kx][ci][co]
    for (int i = t; i < 9 * CK * COUT; i += NTHREADS) {
      const int co = i % COUT;
      const int q = i / COUT;
      const int ci = q % CK;
      const int tap = q / CK;
      const int gc = c0 + ci;
      s_w[tap][ci][co] = gc < Cin ? to_f(w[((size_t)co * Cin + gc) * 9 + tap]) : 0.f;
    }
    __syncthreads();

    for (int ci = 0; ci < CK; ++ci) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float a0 = s_in[ci][ty + ky][tx + kx];
          const float a1 = s_in[ci][ty + ky][tx + 16 + kx];
          const float4* wv = reinterpret_cast<const float4*>(&s_w[ky * 3 + kx][ci][0]);
#pragma unroll
          for (int q = 0; q < COUT / 4; ++q) {
            const float4 w4 = wv[q];
            acc0[4 * q + 0] = fmaf(a0, w4.x, acc0[4 * q + 0]);
            acc0[4 * q + 1] = fmaf(a0, w4.y, acc0[4 * q + 1]);
            acc0[4 * q + 2] = fmaf(a0, w4.z, acc0[4 * q + 2]);
            acc0[4 * q + 3] = fmaf(a0, w4.w, acc0[4 * q + 3]);
            acc1[4 * q + 0] = fmaf(a1, w4.x, acc1[4 * q + 0]);
            acc1[4 * q + 1] = fmaf(a1, w4.y, acc1[4 * q + 1]);
            acc1[4 * q + 2] = fmaf(a1, w4.z, acc1[4 * q + 2]);
            acc1[4 * q + 3] = fmaf(a1, w4.w, acc1[4 * q + 3]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int oy = oy0 + ty;
  if (oy >= H) return;
  const int oxs[2] = {ox0 + tx, ox0 + tx + 16};
#pragma unroll
  for (int pix = 0; pix < 2; ++pix) {
    const int ox = oxs[pix];
    if (ox >= W) continue;
    T* yp = y + (((size_t)b * H + oy) * W + ox) * COUT;
#pragma unroll
    for (int co = 0; co < COUT; ++co) {
      float v = (pix == 0 ? acc0[co] : acc1[co]) + to_f(bias[co]);
      if (relu) v = fmaxf(v, 0.f);
      yp[co] = from_f<T>(v);
    }
  }
}

template <typename T>
int launch_typed(const void* x, const void* w, const void* bias, void* y,
                 int B, int H, int W, int Cin, int Cout, int relu,
                 cudaStream_t stream) {
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* bp = static_cast<const T*>(bias);
  T* yp = static_cast<T*>(y);
  switch (Cout) {
    case 8:  conv3x3_kernel<T, 8><<<grid, NTHREADS, 0, stream>>>(xp, wp, bp, yp, H, W, Cin, relu); break;
    case 16: conv3x3_kernel<T, 16><<<grid, NTHREADS, 0, stream>>>(xp, wp, bp, yp, H, W, Cin, relu); break;
    case 32: conv3x3_kernel<T, 32><<<grid, NTHREADS, 0, stream>>>(xp, wp, bp, yp, H, W, Cin, relu); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int citlab_conv3x3(const void* x, const void* w, const void* bias,
                              void* y, int B, int H, int W, int Cin, int Cout,
                              int relu, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || B > 65535 || (H + TH - 1) / TH > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_typed<float>(x, w, bias, y, B, H, W, Cin, Cout, relu, s);
  if (dtype == 1) return launch_typed<__nv_bfloat16>(x, w, bias, y, B, H, W, Cin, Cout, relu, s);
  return (int)cudaErrorInvalidValue;
}
