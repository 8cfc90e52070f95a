// The depthwise k x k convolution of NHWC activations for Hopper: every
// depthwise forward of the segmenters, and, with its taps flipped, every
// stride-1 depthwise data gradient.
//
//   y[n, oh, ow, c] = sum_{i, j} x[n, oh*s - ph + i*d, ow*s - pw + j*d, c] * w[c, tap(i, j)]
//
// with x zero outside the image, tap(i, j) = i*k + j (or k*k - 1 - that
// with `flip`), an f32 sum and one rounding to x's dtype (bf16 or f32).
// The weight is read as (C, 1, k, k) in f32 or bf16 and rounded to x's
// dtype first, as ``weight.to(x.dtype)`` would. At stride 1 with torch's
// symmetric "same" padding p = d(k-1)/2, the data gradient of such a conv
// is the same conv of dy with the taps flipped and padding d(k-1) - p.
//
// Replaces no TPU kernel: the JAX package leaves its depthwise convs to
// XLA (``ops/conv.py::conv2d`` with ``feature_group_count``), as the port
// left them to cuDNN's grouped direct kernel and its dgrad until this
// kernel. It was added because those were the port's layer furthest from
// its bound (PERF.md): at batch 8, 512^2 pages, the 38 depthwise convs of
// the Xception segmenter move about 4 GB forward in bf16, 1.2 ms at the
// card's 3.35 TB/s, where cuDNN took 28 ms.
//
// What bounds it is bytes: k*k FMA per output element against one element
// read and one written. So the design reads x from device memory about
// once and keeps the FMA and conversions off the critical path:
//
//  * A CTA owns a tile: one image, a band of TH output rows, a strip of TW
//    output columns and a block of CV 16-byte channel vectors (8 bf16 or 4
//    f32 channels each). Its input, with the halo (d(k-1) rows and columns
//    more, the tile twice as tall and wide at stride 2), arrives in shared
//    memory by one TMA copy of a 4-D tensor map over NHWC x, whose zero
//    fill outside the tensor is the padding: no bounds test sits in the
//    inner loop. Neighbouring tiles run side by side, so the halo comes
//    mostly from L2.
//  * The grid is persistent, MIN_CTAS CTAs an SM, each walking tiles
//    blockIdx.x, + gridDim.x, ... with two tile buffers: the copy of the
//    tile after next is issued as soon as a tile is summed, so the loads
//    overlap the sums of this CTA and of its neighbour on the SM.
//  * A thread owns CPT = 4 channels of the block (their k*k taps stay in
//    f32 registers for the tile: 36 at k 3, with 16 sums, under the cap of
//    128 that two CTAs an SM leave; 8 bf16 channels a thread, a whole
//    16-byte vector, spilled) and sums runs of R = 4 output pixels of one
//    row, `ostep` columns apart so that the k taps of neighbouring outputs
//    of a run share input columns (ostep * s = Q * d): it loads each input
//    column of a run once per tap row, widens it to f32, and adds it into
//    every output of the run that reads it, (R-1)Q + k loads a tap row for
//    R outputs in place of R*k. Each output is written once, by one 8-byte
//    (bf16) or 16-byte (f32) store; a warp's stores cover whole 128-byte
//    lines of a pixel where the block is 8 vectors.
//  * dx: `flip` reverses the tap index as the taps are loaded; no flipped
//    weight is made.
//
// The tiling (CV, TH, TW) and the grid come from
// ``ops/kernels/depthwise_conv.py::dw_plan``, which tests hold against the
// constants here. Plain C interface (loaded with ctypes); the launcher
// returns cudaGetLastError() right after its launch. It allocates nothing
// and does not synchronise.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;            // DW_THREADS: threads per CTA
constexpr int MIN_CTAS = 2;        // DW_CTAS_PER_SM: CTAs an SM, registers capped for it
constexpr int NBUF = 2;            // tile buffers a CTA cycles through
constexpr int VEC_BYTES = 16;      // DW_VEC_BYTES: bytes of a channel vector
constexpr int ALIGN = 128;         // TMA destinations start on 128 bytes
constexpr int MAX_BOX = 256;       // DW_MAX_BOX: most elements of a TMA box along a dimension
constexpr int BUF_BYTES = 57344;   // DW_BUF_BYTES: most bytes of one staged tile (56 KiB)
constexpr int MAX_CV = 8;          // DW_MAX_CV: most channel vectors of a tile

__host__ __device__ constexpr int up128(int b) { return (b + ALIGN - 1) / ALIGN * ALIGN; }

constexpr int CPT = 4;             // DW_CPT: channels a thread owns
constexpr int RUN = 4;             // DW_RUN: outputs of a thread's run

struct DwArgs {
  int c, ho, wo;          // channels, output rows and columns
  int s, d, ph, pw;       // stride, dilation, padding before the first row and column
  int cv, th, tw;         // channel vectors, output rows and columns of a tile
  int in_rows, in_cols;   // the staged tile's input rows and columns
  int ostep;              // output columns between the outputs of a run
  int tiles_w, tiles_h, cblocks, ntiles;
  int buf;                // bytes between the two tile buffers
  int box_bytes;          // bytes one tile's copy brings
  int w_bf16, flip;
};

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One TMA box of a 4-D map, coordinates innermost first, onto `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// A thread's CPT channels at a shared address, widened to f32 (bf16 ->
// f32 is a shift of the bits into the high half).
template <typename T>
__device__ __forceinline__ void load_cpt(const unsigned char* p, float (&f)[CPT]) {
  if constexpr (sizeof(T) == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    f[0] = __uint_as_float(v.x << 16);
    f[1] = __uint_as_float(v.x & 0xffff0000u);
    f[2] = __uint_as_float(v.y << 16);
    f[3] = __uint_as_float(v.y & 0xffff0000u);
  } else {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
}

// A thread's CPT outputs, rounded once to T, as one 8- or 16-byte store.
template <typename T>
__device__ __forceinline__ void store_cpt(T* dst, const float (&f)[CPT]) {
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(f[0], f[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(f[2], f[3]);
    *reinterpret_cast<uint2*>(dst) = make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                                                *reinterpret_cast<const uint32_t*>(&b));
  } else {
    *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
  }
}

// The persistent tile walk. Tile t: columns fastest, then rows, channel
// blocks, images. Q = ostep * s / d input columns between a run's outputs.
template <typename T, int K, int Q>
__global__ void __launch_bounds__(NT, MIN_CTAS)
dw_conv(const __grid_constant__ CUtensorMap tmx, const void* __restrict__ wgt, T* __restrict__ y,
        const DwArgs a) {
  constexpr int VEC = VEC_BYTES / (int)sizeof(T);
  constexpr int KK = K * K;
  constexpr int R = RUN;
  constexpr int LB = CPT * (int)sizeof(T);  // bytes of a thread's channels
  constexpr int NCOL = (R - 1) * Q + K;     // input columns a run reads in a tap row

  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[NBUF];
  unsigned char* smem = smem_raw + ((ALIGN - (smem_u32(smem_raw) & (ALIGN - 1))) & (ALIGN - 1));
  const int t = threadIdx.x;
  const int pix = a.cv * VEC_BYTES;  // bytes of a staged pixel
  const int tpp = pix / LB;          // threads of a pixel
  const int sub = t % tpp, pl = t / tpp, lanes = NT / tpp;
  const int runs_row = a.tw / R, nruns = a.th * runs_row;
  const int colstep = a.d * pix, rowstep = a.d * a.in_cols * pix;

  auto issue = [&](int tile, int b) {
    const int tx = tile % a.tiles_w;
    int r = tile / a.tiles_w;
    const int ty = r % a.tiles_h;
    r /= a.tiles_h;
    const int cb = r % a.cblocks, n = r / a.cblocks;
    mbar_expect_tx(&bars[b], (uint32_t)a.box_bytes);
    tma_load_4d(smem + (size_t)b * a.buf, &tmx, &bars[b], cb * a.cv * VEC,
                tx * a.tw * a.s - a.pw, ty * a.th * a.s - a.ph, n);
  };

  if (t == 0) {
    for (int b = 0; b < NBUF; ++b) mbar_init(&bars[b], 1);
    mbar_init_fence();
    for (int b = 0; b < NBUF; ++b)
      if (blockIdx.x + b * gridDim.x < (unsigned)a.ntiles) issue(blockIdx.x + b * gridDim.x, b);
  }
  __syncthreads();

  float wt[KK][CPT];
  int tap_cb = -1;
  int it = 0;
#pragma unroll 1
  for (int tile = blockIdx.x; tile < a.ntiles; tile += gridDim.x, ++it) {
    const int b = it % NBUF;
    const int tx = tile % a.tiles_w;
    int r = tile / a.tiles_w;
    const int ty = r % a.tiles_h;
    r /= a.tiles_h;
    const int cb = r % a.cblocks, n = r / a.cblocks;
    const int c0 = cb * a.cv * VEC + sub * CPT;  // this thread's first channel
    const bool live = c0 < a.c;
    if (cb != tap_cb) {  // the taps of this thread's channels, rounded to T
      tap_cb = cb;
#pragma unroll
      for (int v = 0; v < CPT; ++v) {
#pragma unroll
        for (int q = 0; q < KK; ++q) {
          const size_t at = (size_t)(c0 + v) * KK + (a.flip ? KK - 1 - q : q);
          float f = 0.0f;
          if (live)
            f = a.w_bf16 ? __bfloat162float(static_cast<const bf16*>(wgt)[at])
                         : static_cast<const float*>(wgt)[at];
          if constexpr (sizeof(T) == 2) f = __bfloat162float(__float2bfloat16(f));
          wt[q][v] = f;
        }
      }
    }
    mbar_wait(&bars[b], (it / NBUF) & 1);
    if (live) {
      const unsigned char* tbuf = smem + (size_t)b * a.buf + sub * LB;
      const int oh0 = ty * a.th, ow0 = tx * a.tw;
#pragma unroll 1
      for (int run = pl; run < nruns; run += lanes) {
        const int orow = run / runs_row, rr = run - orow * runs_row;
        const int e = rr % a.ostep;
        const int ocol = (rr - e) * R + e;  // the run's first output column in the tile
        float acc[R][CPT];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int v = 0; v < CPT; ++v) acc[i][v] = 0.0f;
        const unsigned char* base = tbuf + ((size_t)orow * a.s * a.in_cols + (size_t)ocol * a.s) * pix;
#pragma unroll
        for (int ki = 0; ki < K; ++ki) {
          const unsigned char* row = base + ki * rowstep;
#pragma unroll
          for (int m = 0; m < NCOL; ++m) {
            float xv[CPT];
            load_cpt<T>(row + m * colstep, xv);
#pragma unroll
            for (int i = 0; i < R; ++i) {
              const int kj = m - i * Q;
              if (kj >= 0 && kj < K) {
#pragma unroll
                for (int v = 0; v < CPT; ++v) acc[i][v] = fmaf(xv[v], wt[ki * K + kj][v], acc[i][v]);
              }
            }
          }
        }
        const int oh = oh0 + orow;
        if (oh < a.ho) {
          T* out = y + ((size_t)n * a.ho + oh) * a.wo * a.c + c0;
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const int ow = ow0 + ocol + i * a.ostep;
            if (ow < a.wo) store_cpt<T>(out + (size_t)ow * a.c, acc[i]);
          }
        }
      }
    }
    __syncthreads();  // every thread is done with buffer b
    if (t == 0) {
      const int next = tile + NBUF * gridDim.x;
      if (next < a.ntiles) issue(next, b);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once at run time (the library links no libcuda)
EncodeTiled encode_tiled() {
  static std::atomic<EncodeTiled> fn{nullptr};
  EncodeTiled f = fn.load();
  if (f == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return nullptr;
    f = reinterpret_cast<EncodeTiled>(ptr);
    fn.store(f);
  }
  return f;
}

template <typename T, int K, int Q>
cudaError_t launch(const void* x, const void* w, void* y, int n, int h, int wd, const DwArgs& a,
                   int ctas, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  constexpr int VEC = VEC_BYTES / (int)sizeof(T);
  const cuuint64_t e = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)a.c, (cuuint64_t)wd, (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t strides[3] = {a.c * e, (cuuint64_t)wd * a.c * e, (cuuint64_t)h * wd * a.c * e};
  const cuuint32_t box[4] = {(cuuint32_t)(a.cv * VEC), (cuuint32_t)a.in_cols,
                             (cuuint32_t)a.in_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  const CUresult r = encode(&map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                            4, const_cast<void*>(x), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  const int smem = ALIGN + NBUF * a.buf;
  static std::atomic<int> smem_set{0};  // the largest opt-in made for this instance
  if (smem > smem_set.load()) {
    const cudaError_t err = cudaFuncSetAttribute(dw_conv<T, K, Q>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set.store(smem);
  }
  dw_conv<T, K, Q><<<ctas, NT, smem, stream>>>(map, w, static_cast<T*>(y), a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* x, const void* w, void* y, int n, int h, int wd, int k, int q,
                     const DwArgs& a, int ctas, cudaStream_t s) {
  if (k == 3 && q == 1) return launch<T, 3, 1>(x, w, y, n, h, wd, a, ctas, s);
  if (k == 3 && q == 2) return launch<T, 3, 2>(x, w, y, n, h, wd, a, ctas, s);
  return cudaErrorInvalidValue;
}

int gcd_int(int a, int b) { return b == 0 ? a : gcd_int(b, a % b); }

}  // namespace

extern "C" {

// x (n, h, wd, c) bf16 (is_bf16 = 1) or f32, contiguous, 16-byte aligned,
// c * elem a multiple of 16; w (c, 1, k, k) f32 or bf16 (w_bf16 = 1); y
// (n, ho, wo, c) in x's dtype. k 3; s 1 or 2; d >= 1; (ph, pw) the zero
// rows and columns before the first; cv, th, tw and ctas from
// ops/kernels/depthwise_conv.py::dw_plan.
int tsii_dw_conv(const void* x, const void* w, void* y, int n, int h, int wd, int c, int ho,
                 int wo, int k, int s, int d, int ph, int pw, int is_bf16, int w_bf16, int flip,
                 int cv, int th, int tw, int ctas, void* stream) {
  if (n < 1 || h < 1 || wd < 1 || c < 1 || ho < 1 || wo < 1 || d < 1 || (s != 1 && s != 2) ||
      ph < 0 || pw < 0 || cv < 1 || cv > MAX_CV || th < 1 || tw < 1 || ctas < 1)
    return (int)cudaErrorInvalidValue;
  const int elem = is_bf16 ? 2 : 4, vec = VEC_BYTES / elem;
  if (c % vec != 0 || ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16))
    return (int)cudaErrorInvalidValue;
  const int g = gcd_int(s, d);
  DwArgs a;
  a.c = c; a.ho = ho; a.wo = wo; a.s = s; a.d = d; a.ph = ph; a.pw = pw;
  a.cv = cv; a.th = th; a.tw = tw; a.w_bf16 = w_bf16 ? 1 : 0; a.flip = flip ? 1 : 0;
  a.ostep = d / g;
  const int q = s / g;
  if (tw % (RUN * a.ostep) != 0) return (int)cudaErrorInvalidValue;
  const long long in_rows = (long long)(th - 1) * s + (long long)(k - 1) * d + 1;
  const long long in_cols = (long long)(tw - 1) * s + (long long)(k - 1) * d + 1;
  if (in_rows > MAX_BOX || in_cols > MAX_BOX || cv * vec > MAX_BOX)
    return (int)cudaErrorInvalidValue;
  a.in_rows = (int)in_rows; a.in_cols = (int)in_cols;
  const long long box = in_rows * in_cols * cv * VEC_BYTES;
  if (box > BUF_BYTES) return (int)cudaErrorInvalidValue;
  a.box_bytes = (int)box;
  a.buf = up128(a.box_bytes);
  a.tiles_w = (wo + tw - 1) / tw;
  a.tiles_h = (ho + th - 1) / th;
  a.cblocks = (c / vec + cv - 1) / cv;
  const long long tiles = (long long)n * a.cblocks * a.tiles_h * a.tiles_w;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  a.ntiles = (int)tiles;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = is_bf16 ? launch_t<bf16>(x, w, y, n, h, wd, k, q, a, ctas, st)
                                : launch_t<float>(x, w, y, n, h, wd, k, q, a, ctas, st);
  return (int)e;
}

}  // extern "C"
