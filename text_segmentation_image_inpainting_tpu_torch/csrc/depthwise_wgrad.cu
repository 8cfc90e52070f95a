// The weight gradient of a stride-1 depthwise convolution for Hopper, NHWC.
//
//   dW[ki, kj, c] = sum_{n, oh, ow} x[n, oh + ki*d - p, ow + kj*d - p, c] * dy[n, oh, ow, c]
//
// with p = d*(k-1)/2 (torch-'same' padding), x zero outside the image, an
// f32 sum, and x and dy in bf16 or f32.
//
// K6 `dw_wgrad_tiles` + `dw_wgrad_sum` replace the TPU kernel `_kernel` /
// `depthwise_wgrad` (text_segmentation_image_inpainting_tpu/ops/pallas/
// depthwise_wgrad.py), the weight gradient of every stride-1 depthwise conv
// of the MobileNetV2 encoder with C >= 128.
//
// What bounds it is bytes: each of x and dy must be read once, and there
// are 2*k*k FLOP per dy element (at the segmenter's 14 layers, 512^2 pages,
// batch 8, bf16: about 956 MB against 4.3 GFLOP). So the k*k taps must not
// re-read x from device memory. The TPU kernel streams x rows once with a
// halo through VMEM after padding x in HBM; here nothing is padded in device
// memory. A CTA owns 32 channels (one per lane, so every warp load of one
// pixel is 64 or 128 contiguous bytes) and a 16 x 32 tile of output pixels
// of one image. It stages the x tile with its halo of p pixels in shared
// memory once, writing zeros where the halo leaves the image (the edges are
// masked, not padded), then each of its 8 warps walks its rows of the tile:
// one dy load per pixel, k*k taps from shared memory into k*k f32
// registers per thread. The warps' sums are added in shared memory in a
// fixed order and written as the CTA's partial (k*k, 32) row; a second
// kernel adds the partials of all tiles, again in a fixed order. There are
// no atomics, so the result is the same on every run. Consecutive CTAs
// are neighbouring tiles of one channel block, so most halo re-reads hit
// L2. wgmma, TMA and a tuned tile are left for later work.
//
// Plain C interface (loaded with ctypes); the launcher returns
// cudaGetLastError() right after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TC = 32;            // channels per CTA, one per lane
constexpr int NY = 8;             // warps per CTA
constexpr int TH = 16, TW = 32;   // output pixels per CTA
constexpr size_t MAX_SMEM = 232448;

constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.0f; }
template <> __device__ __forceinline__ bf16 zero_of<bf16>() { return __float2bfloat16(0.0f); }

// One CTA: channels [blockIdx.y*32, +32) of the output tile blockIdx.x
// (image n, rows [oh0, oh0+16), columns [ow0, ow0+32)) -> partial[tile][tap][c].
template <typename T, int K>
__global__ void __launch_bounds__(TC * NY)
dw_wgrad_tiles(const T* __restrict__ x, const T* __restrict__ dy, float* __restrict__ partial,
               int h, int w, int c, int d, int tiles_h, int tiles_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);  // [(TH + 2p) * (TW + 2p) pixels][TC]
  const int p = d * (K - 1) / 2;
  const int pw = TW + 2 * p, ph = TH + 2 * p;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tile = blockIdx.x;
  const int cc = blockIdx.y * TC + tx;
  const bool live = cc < c;
  const int n = tile / (tiles_h * tiles_w);
  const int rem = tile - n * tiles_h * tiles_w;
  const int oh0 = (rem / tiles_w) * TH, ow0 = (rem % tiles_w) * TW;
  const size_t img = (size_t)n * h * w;

  // x rows [oh0 - p, oh0 + TH + p), columns [ow0 - p, ow0 + TW + p); zero
  // outside the image and past the last channel
  for (int r = ty; r < ph; r += NY) {
    const int ih = oh0 - p + r;
    const bool row_in = live && ih >= 0 && ih < h;
    const T* src = x + (img + (size_t)(row_in ? ih : 0) * w) * c + (live ? cc : 0);
    T* dst = xs + (size_t)r * pw * TC + tx;
#pragma unroll 4
    for (int s = 0; s < pw; ++s) {
      const int iw = ow0 - p + s;
      T v = zero_of<T>();
      if (row_in && iw >= 0 && iw < w) v = src[(size_t)iw * c];
      dst[s * TC] = v;
    }
  }
  __syncthreads();

  float acc[K * K];
#pragma unroll
  for (int i = 0; i < K * K; ++i) acc[i] = 0.0f;
  if (live) {
    const int cols = min(TW, w - ow0);
    for (int r = ty; r < TH && oh0 + r < h; r += NY) {
      const T* g_row = dy + (img + (size_t)(oh0 + r) * w + ow0) * c + cc;
      const T* x_row = xs + (size_t)r * pw * TC + tx;
#pragma unroll 4
      for (int s = 0; s < cols; ++s) {
        const float g = to_f32(g_row[(size_t)s * c]);
        const T* xt = x_row + s * TC;
#pragma unroll
        for (int ki = 0; ki < K; ++ki)
#pragma unroll
          for (int kj = 0; kj < K; ++kj)
            acc[ki * K + kj] = fmaf(to_f32(xt[(ki * pw + kj) * d * TC]), g, acc[ki * K + kj]);
      }
    }
  }

  __syncthreads();  // the x tile is dead: its space takes the warps' sums
  float* red = reinterpret_cast<float*>(smem);  // [NY][K*K][TC]
#pragma unroll
  for (int i = 0; i < K * K; ++i) red[(ty * K * K + i) * TC + tx] = acc[i];
  __syncthreads();
  if (live) {
    for (int i = ty; i < K * K; i += NY) {
      float s = 0.0f;
#pragma unroll
      for (int y = 0; y < NY; ++y) s += red[(y * K * K + i) * TC + tx];
      partial[((size_t)tile * K * K + i) * c + cc] = s;
    }
  }
}

// dw[i] = sum over tiles of partial[tile][i], i = tap*C + c: warp y adds
// tiles y, y + NY, ...; then the NY sums are added in order.
__global__ void __launch_bounds__(TC * NY)
dw_wgrad_sum(const float* __restrict__ partial, float* __restrict__ dw, int tiles, int taps_c) {
  __shared__ float red[NY][TC];
  const int i = blockIdx.x * TC + threadIdx.x;
  float s = 0.0f;
  if (i < taps_c) {
#pragma unroll 4
    for (int t = threadIdx.y; t < tiles; t += NY) s += partial[(size_t)t * taps_c + i];
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && i < taps_c) {
    float total = 0.0f;
#pragma unroll
    for (int y = 0; y < NY; ++y) total += red[y][threadIdx.x];
    dw[i] = total;
  }
}

template <typename T, int K>
cudaError_t launch(const void* x, const void* dy, float* partial, float* dw, int n, int h, int w,
                   int c, int d, cudaStream_t stream) {
  const int p = d * (K - 1) / 2;
  const size_t tile_bytes = (size_t)(TH + 2 * p) * (TW + 2 * p) * TC * sizeof(T);
  const size_t red_bytes = (size_t)NY * K * K * TC * sizeof(float);
  const size_t smem = tile_bytes > red_bytes ? tile_bytes : red_bytes;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const int tiles_h = cdiv(h, TH), tiles_w = cdiv(w, TW);
  const long long tiles = (long long)n * tiles_h * tiles_w;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (c == 0) return cudaSuccess;
  if (tiles == 0) return cudaMemsetAsync(dw, 0, sizeof(float) * K * K * c, stream);
  cudaError_t e = cudaFuncSetAttribute(dw_wgrad_tiles<T, K>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)tiles, (unsigned)cdiv(c, TC));
  dw_wgrad_tiles<T, K><<<grid, dim3(TC, NY), smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), partial, h, w, c, d, tiles_h, tiles_w);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int taps_c = K * K * c;
  dw_wgrad_sum<<<cdiv(taps_c, TC), dim3(TC, NY), 0, stream>>>(partial, dw, (int)tiles, taps_c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k(const void* x, const void* dy, float* partial, float* dw, int n, int h,
                     int w, int c, int k, int d, cudaStream_t stream) {
  switch (k) {
    case 1: return launch<T, 1>(x, dy, partial, dw, n, h, w, c, d, stream);
    case 3: return launch<T, 3>(x, dy, partial, dw, n, h, w, c, d, stream);
    case 5: return launch<T, 5>(x, dy, partial, dw, n, h, w, c, d, stream);
    case 7: return launch<T, 7>(x, dy, partial, dw, n, h, w, c, d, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Floats of scratch K6 needs for the per-tile partial sums.
long long tsii_dw_wgrad_scratch(int n, int h, int w, int c, int k) {
  return (long long)n * cdiv(h, TH) * cdiv(w, TW) * k * k * c;
}

// K6. x, dy (n, h, w, c) bf16 (is_bf16 = 1) or f32, contiguous; partial
// (tsii_dw_wgrad_scratch floats) f32 -> dw (k, k, 1, c) f32. k in {1, 3, 5, 7}.
int tsii_dw_wgrad(const void* x, const void* dy, void* partial, void* dw, int n, int h, int w,
                  int c, int k, int d, int is_bf16, void* stream) {
  if (d < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(partial);
  float* dwf = static_cast<float*>(dw);
  const cudaError_t e = is_bf16 ? launch_k<bf16>(x, dy, pf, dwf, n, h, w, c, k, d, s)
                                : launch_k<float>(x, dy, pf, dwf, n, h, w, c, k, d, s);
  return (int)e;
}

}  // extern "C"
