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
// What bounds it on an H100: the work is a few integer compares per pixel
// and pass, so it is bound by bytes (one read of the page, one read of the
// vertical mask, two writes, 1 byte each in uint8). The TPU kernel kept a
// full-height stripe of H x (128 + 2*64) f32 in VMEM (~1.5 MB at H = 1536);
// a block here has at most 227 KB of shared memory, and a fixed 64-column
// halo capped h_k + noise_k. This design instead:
//   - works on binary masks (values are exactly 0 or 255, so every window
//     min/max is an AND/OR), and streams each window in O(1) state per
//     thread: an erosion at j is 1 iff the last zero seen lies before the
//     window start, a dilation at i is 1 iff the last eroded 1 lies inside
//     its window. No ring buffer, no doubling passes, no window-size loop;
//   - launch 1 (vertical open): one thread per (column, 64-row segment),
//     reading its column segment + 2*(v_k - 1) halo rows straight from
//     device memory (neighbouring threads = neighbouring columns, so the
//     loads and stores coalesce);
//   - launch 2 (horizontal open -> subtract -> noise open): a block stages
//     64 rows x (128 + halo) columns of the page and of the vertical mask in
//     shared memory as bytes (coalesced), one thread then streams one row
//     through all four windows, and the 64 x 128 result is stored back
//     coalesced. The halo, 2*(h_k - 1) + 2*(noise_k - 1) columns, is derived
//     from the kernel sizes at launch, so there is no fixed-halo limit.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int NEG = INT_MIN / 2;   // "no such position seen yet"
constexpr int V_THREADS = 128;     // columns per vertical block
constexpr int V_SEG = 64;          // rows per vertical thread
constexpr int H_ROWS = 64;         // rows per horizontal block, one thread each
constexpr int H_SEG = 128;         // output columns per horizontal block
constexpr int H_OPITCH = H_SEG + 4;  // 33 words: rows fall on distinct banks
constexpr int MAX_SMEM = 227 * 1024;

template <typename T>
__global__ void __launch_bounds__(V_THREADS)
vertical_open_kernel(const T* __restrict__ x, T* __restrict__ v, int H, int W, int k) {
  const int col = blockIdx.x * V_THREADS + threadIdx.x;
  if (col >= W) return;
  const int lo = blockIdx.y * V_SEG;
  const int hi = min(H, lo + V_SEG);
  const int a = k / 2, bt = k - 1 - a;
  const size_t base = (size_t)blockIdx.z * H * W + col;
  const T* xc = x + base;
  T* vc = v + base;
  int last_zero = NEG, last_one = NEG;
  // t: row of x consumed; j = t - bt: erosion output; i = j - bt: dilation output
  for (int t = lo - 2 * a; t < hi + 2 * bt; ++t) {
    if (t >= 0 && t < H && xc[(size_t)t * W] == T(0)) last_zero = t;
    const int j = t - bt;
    if (j >= 0 && j < H && last_zero < j - a) last_one = j;
    const int i = j - bt;
    if (i >= lo && i < hi) vc[(size_t)i * W] = (last_one >= i - a) ? T(255) : T(0);
  }
}

template <typename T>
__global__ void __launch_bounds__(H_ROWS)
horizontal_open_kernel(const T* __restrict__ x, const T* __restrict__ v,
                       T* __restrict__ h, int H, int W, int k1, int k2, int pitch) {
  extern __shared__ uint8_t smem[];
  uint8_t* sx = smem;
  uint8_t* sv = sx + H_ROWS * pitch;
  uint8_t* so = sv + H_ROWS * pitch;
  const int a1 = k1 / 2, b1 = k1 - 1 - a1;
  const int a2 = k2 / 2, b2 = k2 - 1 - a2;
  const int L = 2 * (a1 + a2), R = 2 * (b1 + b2);
  const int span = H_SEG + L + R;
  const int r0 = blockIdx.y * H_ROWS;
  const int c0 = blockIdx.x * H_SEG;
  const int left = c0 - L;
  const size_t img = (size_t)blockIdx.z * H * W;

  for (int idx = threadIdx.x; idx < H_ROWS * span; idx += H_ROWS) {
    const int r = idx / span, c = idx % span;
    const int gy = r0 + r, gx = left + c;
    uint8_t xv = 1, vv = 0;
    if (gy < H && gx >= 0 && gx < W) {
      const size_t o = img + (size_t)gy * W + gx;
      xv = x[o] != T(0);
      vv = v[o] != T(0);
    }
    sx[r * pitch + c] = xv;
    sv[r * pitch + c] = vv;
  }
  __syncthreads();

  const int r = threadIdx.x;
  const int cend = min(W, c0 + H_SEG);
  if (r0 + r < H) {
    const uint8_t* rx = sx + r * pitch;
    const uint8_t* rv = sv + r * pitch;
    uint8_t* ro = so + r * H_OPITCH;
    int lz_x = NEG, lo_e1 = NEG, lz_s = NEG, lo_e2 = NEG;
    // t: x column consumed; j1/i1: h_k erosion/dilation; the subtract at i1;
    // j2/i2: noise_k erosion/dilation
    for (int t = left; t < cend + R; ++t) {
      if (t >= 0 && t < W && !rx[t - left]) lz_x = t;
      const int j1 = t - b1;
      if (j1 >= 0 && j1 < W && lz_x < j1 - a1) lo_e1 = j1;
      const int i1 = j1 - b1;
      if (i1 >= left && i1 >= 0 && i1 < W) {
        const bool s = (lo_e1 >= i1 - a1) && !rv[i1 - left];
        if (!s) lz_s = i1;
      }
      const int j2 = i1 - b2;
      if (j2 >= 0 && j2 < W && lz_s < j2 - a2) lo_e2 = j2;
      const int i2 = j2 - b2;
      if (i2 >= c0 && i2 < cend) ro[i2 - c0] = lo_e2 >= i2 - a2;
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < H_ROWS * H_SEG; idx += H_ROWS) {
    const int rr = idx / H_SEG, c = idx % H_SEG;
    const int gy = r0 + rr, gx = c0 + c;
    if (gy < H && gx < W)
      h[img + (size_t)gy * W + gx] = so[rr * H_OPITCH + c] ? T(255) : T(0);
  }
}

template <typename T>
int launch_typed(const void* x, void* h, void* v, int B, int H, int W,
                 int hk, int vk, int nk, cudaStream_t stream) {
  const int L = 2 * (hk / 2 + nk / 2);
  const int R = 2 * ((hk - 1 - hk / 2) + (nk - 1 - nk / 2));
  const int span = H_SEG + L + R;
  const int pitch = ((span + 3) / 8) * 8 + 4;   // pitch/4 odd: conflict-free rows
  const size_t smem = (size_t)H_ROWS * (2 * pitch + H_OPITCH);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        horizontal_open_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const T* xp = static_cast<const T*>(x);
  T* vp = static_cast<T*>(v);
  const dim3 vgrid((W + V_THREADS - 1) / V_THREADS, (H + V_SEG - 1) / V_SEG, B);
  vertical_open_kernel<T><<<vgrid, V_THREADS, 0, stream>>>(xp, vp, H, W, vk);
  const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess) return (int)e1;
  const dim3 hgrid((W + H_SEG - 1) / H_SEG, (H + H_ROWS - 1) / H_ROWS, B);
  horizontal_open_kernel<T><<<hgrid, H_ROWS, smem, stream>>>(
      xp, vp, static_cast<T*>(h), H, W, hk, nk, pitch);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 2 = uint8. x, h, v are [B, H, W], contiguous.
// Returns the cudaError_t of the launches.
extern "C" int citlab_separator_morphology(const void* x, void* h, void* v,
                                           int B, int H, int W, int h_k, int v_k,
                                           int noise_k, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || h_k < 1 || v_k < 1 || noise_k < 1 || B > 65535
      || (H + V_SEG - 1) / V_SEG > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_typed<float>(x, h, v, B, H, W, h_k, v_k, noise_k, s);
  if (dtype == 2) return launch_typed<uint8_t>(x, h, v, B, H, W, h_k, v_k, noise_k, s);
  return (int)cudaErrorInvalidValue;
}
