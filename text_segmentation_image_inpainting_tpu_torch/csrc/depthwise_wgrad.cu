// The weight gradient of a stride-1 depthwise convolution for Hopper, NHWC.
//
//   dW[ki, kj, c] = sum_{n, oh, ow} x[n, oh + ki*d - p, ow + kj*d - p, c] * dy[n, oh, ow, c]
//
// with p = d*(k-1)/2 (torch-'same' padding), x zero outside the image, an
// f32 sum, and x and dy in bf16 or f32. dW is written as (C, k*k) f32.
//
// K6 `dw_wgrad_band` replaces the TPU kernel `_kernel` / `depthwise_wgrad`
// (text_segmentation_image_inpainting_tpu/ops/pallas/depthwise_wgrad.py),
// the weight gradient of every stride-1 depthwise conv of the MobileNetV2
// encoder with C >= 128.
//
// What bounds it is bytes: x and dy are each read once and there are 2*k*k
// FLOP per dy element (the segmenter's 14 layers at 512^2 pages, batch 8,
// bf16: about 956 MB against 4.3 GFLOP). On CUDA cores those FLOP are not
// free, though: 9 FMA per element at k 3, plus the widening of bf16 to
// f32 and the shared-memory loads, come to about half the byte bound. So
// the design keeps both the bytes and the instructions per element down:
//
//  * A CTA owns one image, one block of channels (PB = 64 bytes of each
//    pixel, 32 bf16 or 16 f32 channels: at batch 8, 128-byte blocks gave
//    too few CTAs to fill the card, and no gain where they did), a band of `rows` output rows and a strip of `tw` columns
//    (the whole row on the segmenter's maps). It walks down its band G rows
//    at a time with its x rows in a shared-memory ring, so inside a band
//    each x row comes from device memory once; only the 2p rows at a band's
//    edges are read twice (mostly from L2: neighbouring bands run side by
//    side).
//  * Each row arrives by one TMA copy (a 4-D tensor map over NHWC x or dy),
//    PRE steps ahead of the step being summed, onto an mbarrier per step;
//    the lane 0s of the warps share a step's copies, so that no warp is
//    held long from its sums; the map's out-of-bounds fill is the zero padding of rows,
//    columns and channels outside the tensor, so there is no edge code.
//    Where a pixel's channels are not 16-byte aligned (C * sizeof(T) % 16
//    != 0, which TMA cannot address) all threads fill the same ring with
//    plain loads and stores instead.
//  * A lane owns CPT adjacent channels of one output row and walks a
//    segment of its columns of one residue class mod d, so that the k x k
//    window of x moves by one column a step: it keeps the window in
//    registers (rotated by unrolling, not moved) and loads k new x pixels
//    and one dy pixel per output pixel, not k*k + 1. Its k*k*CPT f32 sums
//    stay in registers over the whole band.
//  * One launch, deterministic: the lanes of a warp that share channels are
//    added by a fixed xor butterfly, the warps in a fixed order, and the
//    CTA writes its (k*k, channel block) partial to its own slot. The last
//    CTA of a channel block (a ticket counter, reset by that CTA) adds the
//    slots in slot order and writes dW. No float atomics, so every run
//    gives the same bits. The launcher allocates nothing and does not
//    synchronise: the workspace (slots, tickets) is the caller's.
//
// Plain C interface (loaded with ctypes); the launcher returns
// cudaGetLastError() right after its launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <atomic>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;           // threads per CTA
constexpr int NWARPS = NT / 32;
constexpr int MIN_CTAS = 2;       // CTAs per SM the registers are capped for (128 a thread)
constexpr int G = 4;              // output rows summed per step
constexpr int PRE = 1;            // steps in flight ahead of the step being summed
constexpr int NBAR = PRE + 1;     // mbarriers, one per step in the ring
constexpr int MAX_BOX = 256;      // most pixels of one TMA row
constexpr int ALIGN = 128;        // TMA destinations start on 128 bytes
constexpr int PB = 64;            // bytes of a pixel's channel block, the one a CTA owns
constexpr int MAX_SMEM = 232448 - 64;  // dynamic shared bytes a block can use, beside the barriers

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int up128(int b) { return (b + ALIGN - 1) / ALIGN * ALIGN; }

// channels per lane: the k*k*CPT sums and the k*k*CPT window stay in
// registers (72 f32 at k 3, 100 at k 5, 98 at k 7)
template <int K>
__host__ __device__ constexpr int cpt() { return K <= 3 ? 4 : K == 5 ? 2 : 1; }

// Shared bytes of the rings: x (2p + G(PRE+1) rows of tw+2p pixels) and dy
// (G(PRE+1) rows of tw pixels), PB bytes a pixel, each row on 128 bytes.
__host__ __device__ constexpr int ring_bytes(int p, int tw) {
  return (2 * p + G * (PRE + 1)) * up128((tw + 2 * p) * PB) + G * (PRE + 1) * up128(tw * PB);
}

// The warps' sums after the walk: NWARPS x k*k x PB/elem f32.
__host__ __device__ constexpr int red_bytes(int kk, int elem) {
  return NWARPS * kk * (PB / elem) * 4;
}

// Dynamic shared bytes of a CTA: 128 for the alignment, then the rings or
// the warps' sums, whichever is larger.
__host__ __device__ constexpr int smem_bytes(int kk, int p, int tw, int elem) {
  return ALIGN + (ring_bytes(p, tw) > red_bytes(kk, elem) ? ring_bytes(p, tw) : red_bytes(kk, elem));
}

template <typename T> struct Bits;
template <> struct Bits<bf16> { using type = unsigned short; };
template <> struct Bits<float> { using type = unsigned int; };

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

// CPT channels of T at a shared address, widened to f32 (bf16 -> f32 is a
// shift of the bits into the high half).
template <typename T, int CPT>
__device__ __forceinline__ void load_vec(const unsigned char* p, float (&f)[CPT]) {
  if constexpr (sizeof(T) == 2 && CPT == 1) {
    f[0] = __uint_as_float((uint32_t)*reinterpret_cast<const unsigned short*>(p) << 16);
  } else {
    constexpr int WORDS = CPT * (int)sizeof(T) / 4;
    uint32_t u[WORDS];
    if constexpr (WORDS == 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      u[0] = v.x; u[1] = v.y; u[2] = v.z; u[3] = v.w;
    } else if constexpr (WORDS == 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      u[0] = v.x; u[1] = v.y;
    } else {
      u[0] = *reinterpret_cast<const uint32_t*>(p);
    }
#pragma unroll
    for (int i = 0; i < WORDS; ++i) {
      if constexpr (sizeof(T) == 2) {
        f[2 * i] = __uint_as_float(u[i] << 16);
        f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
      } else {
        f[i] = __uint_as_float(u[i]);
      }
    }
  }
}

// One CTA: image n, channels [cb*CB, +CB), output rows [h0, h0+rows) and
// columns [w0, w0+tw) -> partial[cb][slot][tap][CB]; the last CTA of the
// channel block also writes dw[c][tap] for its channels. `tma` 0: the rings
// are filled by plain loads (x, dy), else by TMA (tmx, tmg).
template <typename T, int K>
__global__ void __launch_bounds__(NT, MIN_CTAS)
dw_wgrad_band(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmg,
              const T* __restrict__ x, const T* __restrict__ dy, float* __restrict__ partial,
              unsigned* __restrict__ tickets, float* __restrict__ dw, int h, int w, int c, int d,
              int rows, int bands, int tw, int strips, int tma) {
  constexpr int KK = K * K;
  constexpr int CB = PB / (int)sizeof(T);  // channels per CTA
  constexpr int CPT = cpt<K>();            // channels per lane
  constexpr int TPC = CB / CPT;            // lanes per pixel
  constexpr int NPX = NT / TPC;            // pixel lanes
  constexpr int LPR = NPX / G;             // pixel lanes per output row of a step
  static_assert(TPC <= 32 && (TPC & (TPC - 1)) == 0, "lanes of one pixel must share a warp");
  static_assert(LPR >= 1 && NPX % G == 0, "every row of a step needs its lanes");
  using U = typename Bits<T>::type;

  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[NBAR];
  unsigned char* smem = smem_raw + ((ALIGN - (smem_u32(smem_raw) & (ALIGN - 1))) & (ALIGN - 1));
  const int p = d * (K - 1) / 2;
  const int nxs = 2 * p + G * (PRE + 1), ngs = G * (PRE + 1);  // ring rows
  const int xsb = up128((tw + 2 * p) * PB), gsb = up128(tw * PB);  // bytes of a ring row
  const int t = threadIdx.x;
  const int slot = blockIdx.x, cb = blockIdx.y;
  const int strip = slot % strips, nb = slot / strips;
  const int n = nb / bands, band = nb - n * bands;
  const int h0 = band * rows, nrows = min(rows, h - h0);
  const int w0 = strip * tw, nw = min(tw, w - w0);
  const int c0 = cb * CB;
  const int steps = cdiv(nrows, G);
  unsigned char* xs = smem;  // x ring row rr % nxs holds image row h0 - p + rr, columns from w0 - p
  unsigned char* gs = smem + (size_t)nxs * xsb;  // dy ring row j % ngs holds image row h0 + j

  if (tma && t == 0) {
    for (int b = 0; b < NBAR; ++b) mbar_init(&bars[b], NWARPS);  // lane 0 of each warp arrives
    mbar_init_fence();
  }
  __syncthreads();

  // plain fill of one ring row: columns [col0, col0 + ncols) of image row
  // ih, zero outside the image and past the last channel
  const T* ximg = x + (size_t)n * h * w * c;
  const T* gimg = dy + (size_t)n * h * w * c;
  auto stage = [&](unsigned char* dst, const T* img, int ih, int col0, int ncols) {
    const bool row_in = ih >= 0 && ih < h;
    const U* src = reinterpret_cast<const U*>(img) + (size_t)(row_in ? ih : 0) * w * c;
    for (int i = t; i < ncols * CB; i += NT) {
      const int j = i / CB, cl = i - j * CB;
      const int iw = col0 + j, cc = c0 + cl;
      const bool ok = row_in && iw >= 0 && iw < w && cc < c;
      reinterpret_cast<U*>(dst + j * PB)[cl] = ok ? src[(size_t)iw * c + cc] : U(0);
    }
  };
  // step s: dy rows [sG, min(sG + G, nrows)) and the x rows they newly need
  // (all of rows [0, G + 2p) at s = 0)
  auto issue = [&](int s) {
    if (s >= steps) return;
    const int j0 = s * G, j1 = min(j0 + G, nrows);
    const int lo = s == 0 ? 0 : j0 + 2 * p, hi = j1 - 1 + 2 * p;
    if (tma) {
      // lane 0 of warp y loads rows y, y + NWARPS, ... of the step's x rows
      // then dy rows, and arrives with their bytes (none for a warp without)
      if (t % 32 == 0) {
        uint64_t* bar = &bars[s % NBAR];
        const int nx = hi - lo + 1, total = nx + j1 - j0;
        uint32_t bytes = 0;
        for (int i = t / 32; i < total; i += NWARPS) bytes += (i < nx ? tw + 2 * p : tw) * PB;
        mbar_expect_tx(bar, bytes);
        for (int i = t / 32; i < total; i += NWARPS) {
          if (i < nx)
            tma_load_4d(xs + (size_t)((lo + i) % nxs) * xsb, &tmx, bar, c0, w0 - p, h0 - p + lo + i, n);
          else
            tma_load_4d(gs + (size_t)((j0 + i - nx) % ngs) * gsb, &tmg, bar, c0, w0, h0 + j0 + i - nx, n);
        }
      }
    } else {
      for (int rr = lo; rr <= hi; ++rr)
        stage(xs + (size_t)(rr % nxs) * xsb, ximg, h0 - p + rr, w0 - p, nw + 2 * p);
      for (int j = j0; j < j1; ++j) stage(gs + (size_t)(j % ngs) * gsb, gimg, h0 + j, w0, nw);
    }
  };

#pragma unroll 1
  for (int s = 0; s < PRE; ++s) issue(s);

  float acc[KK][CPT];
#pragma unroll
  for (int i = 0; i < KK; ++i)
#pragma unroll
    for (int v = 0; v < CPT; ++v) acc[i][v] = 0.0f;
  const int q = t % TPC, pl = t / TPC;
  const int gr = pl / LPR, li = pl % LPR;  // this lane's row of a step, its place in the row
  const bool live = c0 + q * CPT < c;
  const int lane_off = q * CPT * (int)sizeof(T);
  // a row's columns by residue class mod d, cut into segments of `seg`
  // columns; segment sg is class sg / spc, columns from (sg % spc) * seg
  const int m = cdiv(nw, d);                 // columns of the longest class
  const int seg = cdiv(m, max(1, LPR / d));  // LPR / d lanes share a class
  const int spc = cdiv(m, seg), nseg = d * spc;

#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    __syncthreads();  // step s - 1 is summed: its ring rows and barrier are free
    issue(s + PRE);
    if (tma) mbar_wait(&bars[s % NBAR], (s / NBAR) & 1);
    const int ro = s * G + gr;
    if (!live || ro >= nrows) continue;
    const unsigned char* g = gs + (size_t)(ro % ngs) * gsb + lane_off;
    const unsigned char* xr[K];
#pragma unroll
    for (int ki = 0; ki < K; ++ki) xr[ki] = xs + (size_t)((ro + ki * d) % nxs) * xsb + lane_off;
#pragma unroll 1
    for (int sg = li; sg < nseg; sg += LPR) {
      const int r = sg / spc, jc = (sg % spc) * seg;
      const int len = min(seg, cdiv(nw - r, d) - jc);
      if (len <= 0) continue;       // a class with fewer columns than the longest
      const int col0 = r + jc * d;  // the segment's first output column
      // win[ki][e % K] holds x row ki at the segment's column e (ring
      // column col0 + e*d); the first K - 1 columns before the walk
      float win[K][K][CPT];
#pragma unroll
      for (int ki = 0; ki < K; ++ki)
#pragma unroll
        for (int kj = 0; kj < K - 1; ++kj) load_vec<T, CPT>(xr[ki] + (col0 + kj * d) * PB, win[ki][kj]);
#pragma unroll 1
      for (int jb = 0; jb < len; jb += K) {
#pragma unroll
        for (int jj = 0; jj < K; ++jj) {
          if (jb + jj >= len) break;
          const int col = col0 + (jb + jj) * d;
#pragma unroll
          for (int ki = 0; ki < K; ++ki)
            load_vec<T, CPT>(xr[ki] + (col + (K - 1) * d) * PB, win[ki][(jj + K - 1) % K]);
          float gv[CPT];
          load_vec<T, CPT>(g + col * PB, gv);
#pragma unroll
          for (int ki = 0; ki < K; ++ki)
#pragma unroll
            for (int kj = 0; kj < K; ++kj)
#pragma unroll
              for (int v = 0; v < CPT; ++v)
                acc[ki * K + kj][v] = fmaf(win[ki][(jj + kj) % K][v], gv[v], acc[ki * K + kj][v]);
        }
      }
    }
  }
  __syncthreads();  // the rings are dead: their space takes the warps' sums

  // the lanes of a warp that hold the same channels, by a fixed butterfly
#pragma unroll
  for (int off = TPC; off < 32; off <<= 1)
#pragma unroll
    for (int i = 0; i < KK; ++i)
#pragma unroll
      for (int v = 0; v < CPT; ++v) acc[i][v] += __shfl_xor_sync(0xffffffffu, acc[i][v], off);
  float* red = reinterpret_cast<float*>(smem);  // [NWARPS][KK][CB]
  const int warp = t / 32, lane = t % 32;
  if (lane < TPC) {
#pragma unroll
    for (int i = 0; i < KK; ++i)
#pragma unroll
      for (int v = 0; v < CPT; ++v) red[(warp * KK + i) * CB + q * CPT + v] = acc[i][v];
  }
  __syncthreads();
  const int slots = gridDim.x;
  float* mine = partial + ((size_t)cb * slots + slot) * KK * CB;
  for (int i = t; i < KK * CB; i += NT) {
    float s = 0.0f;
#pragma unroll
    for (int y = 0; y < NWARPS; ++y) s += red[y * KK * CB + i];
    mine[i] = s;
  }

  // the last CTA of this channel block adds the slots in slot order. Thread
  // 0's acquire-release ticket publishes the CTA's slot (its writes are
  // ordered before it by the barrier) and, in the last CTA, makes every
  // other CTA's slot visible to the threads after the next barrier.
  __syncthreads();  // the slot is written and the warps' sums read: the flag may take their space
  unsigned& last = *reinterpret_cast<unsigned*>(smem);
  if (t == 0) {
    unsigned prev;
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;\n"
                 : "=r"(prev)
                 : "l"(tickets + cb)
                 : "memory");
    last = prev == (unsigned)slots - 1u;
  }
  __syncthreads();
  if (!last) return;
  const float* all = partial + (size_t)cb * slots * KK * CB;
  for (int i = t; i < KK * CB; i += NT) {
    const int tap = i / CB, cc = c0 + i % CB;
    if (cc >= c) continue;
    float s = 0.0f;
    int sl = 0;
    for (; sl + 32 <= slots; sl += 32) {  // 32 loads in flight, added in order
      float v[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) v[j] = __ldcg(all + (size_t)(sl + j) * KK * CB + i);
#pragma unroll
      for (int j = 0; j < 32; ++j) s += v[j];
    }
    float v[32];
#pragma unroll
    for (int j = 0; j < 32; ++j)
      v[j] = sl + j < slots ? __ldcg(all + (size_t)(sl + j) * KK * CB + i) : 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      if (sl + j < slots) s += v[j];
    dw[(size_t)cc * KK + tap] = s;
  }
  if (t == 0) tickets[cb] = 0u;  // ready for the next launch on this stream
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

// The 4-D map (c, w, h, n) of an NHWC tensor whose boxes are one row of
// `box_w` pixels of `box_c` channels; reads outside the tensor give zeros.
cudaError_t row_map(CUtensorMap* map, const void* base, bool bf, int n, int h, int w, int c,
                    int box_c, int box_w) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t e = bf ? 2 : 4;
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t strides[3] = {c * e, (cuuint64_t)w * c * e, (cuuint64_t)h * w * c * e};
  const cuuint32_t box[4] = {(cuuint32_t)box_c, (cuuint32_t)box_w, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, bf ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                            4, const_cast<void*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int K>
cudaError_t launch(const void* x, const void* dy, float* partial, unsigned* tickets, float* dw,
                   int n, int h, int w, int c, int d, int rows, int tw, cudaStream_t stream) {
  constexpr int CB = PB / (int)sizeof(T);
  if (d > 4096 || rows < 1 || tw < 1 || tw > w) return cudaErrorInvalidValue;
  const int p = d * (K - 1) / 2;
  if (tw + 2 * p > MAX_BOX) return cudaErrorInvalidValue;
  const int smem = smem_bytes(K * K, p, tw, (int)sizeof(T));
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const int bands = cdiv(h, rows), strips = cdiv(w, tw);
  const long long slots = (long long)n * bands * strips;
  if (slots > 0x7fffffffLL || cdiv(c, CB) > 65535) return cudaErrorInvalidValue;
  static std::atomic<int> smem_set{0};  // the largest opt-in made for this instance
  if (smem > smem_set.load()) {
    const cudaError_t e = cudaFuncSetAttribute(dw_wgrad_band<T, K>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set.store(smem);
  }
  // TMA needs 16-byte aligned rows: pixel strides and base addresses
  const int tma = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy)) % 16 == 0) &&
                  ((size_t)c * sizeof(T)) % 16 == 0;
  CUtensorMap tmx, tmg;
  memset(&tmx, 0, sizeof(tmx));
  memset(&tmg, 0, sizeof(tmg));
  if (tma) {
    const bool bf = sizeof(T) == 2;
    cudaError_t e = row_map(&tmx, x, bf, n, h, w, c, CB, tw + 2 * p);
    if (e == cudaSuccess) e = row_map(&tmg, dy, bf, n, h, w, c, CB, tw);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)slots, (unsigned)cdiv(c, CB));
  dw_wgrad_band<T, K><<<grid, NT, smem, stream>>>(
      tmx, tmg, static_cast<const T*>(x), static_cast<const T*>(dy), partial, tickets, dw, h, w, c,
      d, rows, bands, tw, strips, tma);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k(const void* x, const void* dy, float* partial, unsigned* tickets, float* dw,
                     int n, int h, int w, int c, int k, int d, int rows, int tw, cudaStream_t s) {
  switch (k) {
    case 1: return launch<T, 1>(x, dy, partial, tickets, dw, n, h, w, c, d, rows, tw, s);
    case 3: return launch<T, 3>(x, dy, partial, tickets, dw, n, h, w, c, d, rows, tw, s);
    case 5: return launch<T, 5>(x, dy, partial, tickets, dw, n, h, w, c, d, rows, tw, s);
    case 7: return launch<T, 7>(x, dy, partial, tickets, dw, n, h, w, c, d, rows, tw, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The general form, for the rest of JAX's scope (any odd k, any d >= 1):
// the windows the template is not built for (k other than 1, 3, 5, 7) and
// the dilations whose halo leaves no strip a 256-pixel TMA row or the rings
// (k6_plan). Its FLOP are what bound it: 2 k*k per dy element against x and
// dy read once (at k 9 on a 128^2 map, 81 FMA per 4 bytes of bf16), so the
// design keeps the FMA pipe fed from shared memory:
//
//  * A CTA owns one image, 16 channels (GEN_CH), a band of output rows, a
//    strip of columns, a group of tap rows and a group of tiles of tap
//    columns (ops/kernels/depthwise_wgrad.py::k6_gen_plan). The x rows its
//    tap rows read for the band are one run; it streams the rows of that
//    run that some tap row uses, and the band's dy rows, through
//    shared-memory rings a step of G rows ahead (TMA boxes of at most 256
//    pixels where the pixels are 16-byte aligned, else plain loads), as
//    dw_wgrad_band does. Only the image's own columns are staged.
//  * Only the taps that reach the image are computed: rows and columns of
//    taps whose shift |o| * d is W (or H) or more are never walked, and
//    their dW is +0. A tap row whose x row lies outside the image is
//    skipped for that output row.
//  * A lane owns GEN_CPT adjacent channels and a tile of TJ adjacent tap
//    columns of one tap row (tiles of a row overlap where TJ does not divide
//    the row; a tap belongs to its first tile). It walks a segment of output
//    columns of one residue class mod d, so that its window of TJ x pixels
//    moves by one column a step: one new x vector, one dy vector and TJ *
//    GEN_CPT FMA per output column, in f32 on widened values (bf16 products
//    are exact in f32). Window slots outside the image read a zero pixel.
//  * Deterministic and short f32 chains, no float atomics: a lane adds a
//    segment (at most GEN_SEG columns) into a fresh sum, then that into its
//    total; the lanes of one tile are added by a fixed pairwise tree in
//    shared memory; each CTA writes its slot of partials, and
//    dw_wgrad_gen_fold adds the slots in blocks of `fold`, in order. Taps
//    outside the image come out +0 there.
constexpr int GEN_CH = 16;                 // channels of a CTA's block, in both dtypes
constexpr int GEN_CPT = 4;                 // channels per lane
constexpr int GEN_TPC = GEN_CH / GEN_CPT;  // lanes per pixel lane
constexpr int GEN_NPX = NT / GEN_TPC;      // pixel lanes of a CTA
constexpr int GEN_TJ = 8;                  // widest tile of tap columns (instances 1..GEN_TJ)
constexpr int GEN_SEG = 64;                // most columns a lane walks into one sum
constexpr int GEN_ZERO = 128;              // bytes of zeros for window slots outside the image
constexpr int GEN_MAX_D = 1 << 24;         // the largest dilation the launcher takes

// the general form's geometry (k6_gen_plan has the same in Python)
struct GenArgs {
  int n, h, w, c, d;
  int kri, krj, kc, ntj;  // tap rows and columns reaching the image: |o| <= kri, krj; kc = 2krj+1
  int kg, ngr, ntg, ngc;  // tap rows a row group, row groups; tiles a column group, column groups
  int rows, bands, tw, strips;
  int bwx, bwg;           // pixels of one TMA box of x and of dy
  int xrow, grow, nxr;    // bytes of an x and a dy ring row; x ring rows
  int ntap;               // (2 kri + 1) * kc: the partials' taps
  int tma;
};

__host__ __device__ inline int ceil_div(int a, int b) {  // b > 0, any a
  return a >= 0 ? (a + b - 1) / b : -((-a) / b);
}

template <typename T, int TJ>
__global__ void __launch_bounds__(NT, MIN_CTAS)
dw_wgrad_gen_tiles(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmg,
                   const T* __restrict__ x, const T* __restrict__ dy, float* __restrict__ part,
                   const GenArgs a) {
  constexpr int PBT = GEN_CH * (int)sizeof(T);  // bytes of a pixel's channel block
  constexpr int NGR = G * (PRE + 1);             // dy ring rows
  constexpr int SK = ALIGN / PBT;                // pixels of one 128-byte line
  using U = typename Bits<T>::type;
  // ring row s starts skew(s) pixels into its line, so that lanes reading
  // the same column of rows 1 or 2 apart hit other banks
  auto skew = [](int s) { return (s + s / SK) % SK; };

  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[NBAR];
  unsigned char* smem = smem_raw + ((ALIGN - (smem_u32(smem_raw) & (ALIGN - 1))) & (ALIGN - 1));
  unsigned char* xs = smem + GEN_ZERO;              // x ring: rel row r in row r % nxr
  unsigned char* gs = xs + (size_t)a.nxr * a.xrow;  // dy ring: band row j in row j % NGR
  const int t = threadIdx.x;
  const int slot = blockIdx.x, cb = blockIdx.y;
  const int rg = blockIdx.z % a.ngr, cg = blockIdx.z / a.ngr;
  const int strip = slot % a.strips, nb = slot / a.strips;
  const int n = nb / a.bands, band = nb - n * a.bands;
  const int h = a.h, w = a.w, d = a.d;
  const int h0 = band * a.rows, nrows = min(a.rows, h - h0);
  const int w0 = strip * a.tw, nw = min(a.tw, w - w0);
  const int c0 = cb * GEN_CH;
  const int steps = cdiv(nrows, G);
  // tap rows o in [ri0, ri0 + kgc), tiles [tg0, tg0 + ntc); a tile's first
  // tap column, as an index into the kc columns reaching the image
  const int ri0 = -a.kri + rg * a.kg, kgc = min(a.kg, a.kri + 1 - ri0);
  const int tg0 = cg * a.ntg, ntc = min(a.ntg, a.ntj - tg0);
  auto tile_start = [&](int ti) { return min(ti * TJ, a.kc - TJ); };
  const int span = (kgc - 1) * d;  // x rows between the group's first and last tap row
  const int xr0 = h0 + ri0 * d;    // image row of rel row 0 of the run
  // the image's columns the CTA's taps read for its strip
  const int xc0 = max(0, w0 + (tile_start(tg0) - a.krj) * d);
  const int xc1 = min(w, w0 + nw - 1 + (tile_start(tg0 + ntc - 1) + TJ - 1 - a.krj) * d + 1);
  const int nxc = max(0, xc1 - xc0);
  const int nbx = nxc > 0 ? cdiv(nxc + SK - 1, a.bwx) : 0, nbg = cdiv(nw + SK - 1, a.bwg);

  if (t < GEN_ZERO / 4) reinterpret_cast<uint32_t*>(smem)[t] = 0u;
  if (a.tma && t == 0) {
    for (int b = 0; b < NBAR; ++b) mbar_init(&bars[b], NWARPS);  // lane 0 of each warp arrives
    mbar_init_fence();
  }
  __syncthreads();

  const T* ximg = x + (size_t)n * h * w * a.c;
  const T* gimg = dy + (size_t)n * h * w * a.c;
  // plain fill of one ring row: columns [col0, col0 + ncols) of image row
  // ih, zero past the last channel
  auto stage = [&](unsigned char* dst, const T* img, int ih, int col0, int ncols) {
    const U* src = reinterpret_cast<const U*>(img) + (size_t)ih * w * a.c;
    for (int i = t; i < ncols * GEN_CH; i += NT) {
      const int j = i / GEN_CH, cl = i - j * GEN_CH;
      const int cc = c0 + cl;
      reinterpret_cast<U*>(dst + j * PBT)[cl] =
          cc < a.c ? src[(size_t)(col0 + j) * a.c + cc] : U(0);
    }
  };
  // rel row r of the run is staged if it lies in the image and a tap row
  // of the group reads it for a row of the band
  auto wanted = [&](int r) {
    const int ih = xr0 + r;
    if (ih < 0 || ih >= h) return false;
    const int i = min(kgc - 1, r / d);
    return r - i * d < nrows;
  };
  // step s: dy rows [sG, min(sG + G, nrows)) and the rel x rows they newly
  // need (all of [0, G + span) at s = 0)
  auto issue = [&](int s) {
    if (s >= steps) return;
    const int j0 = s * G, j1 = min(j0 + G, nrows);
    const int lo = s == 0 ? 0 : j0 + span, hi = j1 - 1 + span;
    if (a.tma) {
      // lane 0 of warp y takes copies y, y + NWARPS, ... of the step's x
      // boxes then dy boxes, and arrives with their bytes (none for a warp without)
      if (t % 32 == 0) {
        uint64_t* bar = &bars[s % NBAR];
        const int y = t / 32;
        uint32_t bytes = 0;
        int i = 0;
        for (int r = lo; r <= hi; ++r)
          if (wanted(r))
            for (int b = 0; b < nbx; ++b, ++i)
              if (i % NWARPS == y) bytes += a.bwx * PBT;
        for (int j = j0; j < j1; ++j)
          for (int b = 0; b < nbg; ++b, ++i)
            if (i % NWARPS == y) bytes += a.bwg * PBT;
        mbar_expect_tx(bar, bytes);
        i = 0;
        for (int r = lo; r <= hi; ++r)
          if (wanted(r))
            for (int b = 0; b < nbx; ++b, ++i)
              if (i % NWARPS == y)
                tma_load_4d(xs + (size_t)(r % a.nxr) * a.xrow + (size_t)b * a.bwx * PBT, &tmx, bar,
                            c0, xc0 - skew(r % a.nxr) + b * a.bwx, xr0 + r, n);
        for (int j = j0; j < j1; ++j)
          for (int b = 0; b < nbg; ++b, ++i)
            if (i % NWARPS == y)
              tma_load_4d(gs + (size_t)(j % NGR) * a.grow + (size_t)b * a.bwg * PBT, &tmg, bar, c0,
                          w0 - skew(j % NGR) + b * a.bwg, h0 + j, n);
      }
    } else {
      for (int r = lo; r <= hi; ++r)
        if (wanted(r))
          stage(xs + (size_t)(r % a.nxr) * a.xrow + skew(r % a.nxr) * PBT, ximg, xr0 + r, xc0, nxc);
      for (int j = j0; j < j1; ++j)
        stage(gs + (size_t)(j % NGR) * a.grow + skew(j % NGR) * PBT, gimg, h0 + j, w0, nw);
    }
  };

#pragma unroll 1
  for (int s = 0; s < PRE; ++s) issue(s);

  // this lane: channels [c0 + q*CPT, +CPT), item (tap row, tile) pl % ni,
  // the sub-th of the item's lpi lanes
  const int ni = kgc * ntc;
  const int q = t % GEN_TPC, pl = t / GEN_TPC;
  const int item = pl % ni, sub = pl / ni, lpi = (GEN_NPX - item + ni - 1) / ni;
  const int ri = ri0 + item / ntc, ti = tg0 + item % ntc;
  const int ot = tile_start(ti) - a.krj;  // slot 0's tap column offset
  const bool live = c0 + q * GEN_CPT < a.c;
  const int lane_off = q * GEN_CPT * (int)sizeof(T);
  const unsigned char* zero = smem + lane_off;
  // a row's output columns by residue class mod d (the classes holding a
  // column), each cut into spc segments of seg columns (odd where a class
  // has several, so that lanes on neighbouring segments hit other banks);
  // unit u of a step is (row u / nseg, segment u % nseg)
  const int lpi_min = GEN_NPX / ni;
  const int ncls = min(d, nw), m = cdiv(nw, d);
  const int spc = max(max(1, cdiv(lpi_min, G * ncls)), cdiv(m, GEN_SEG));
  const int seg = cdiv(m, spc) + (spc > 1 && cdiv(m, spc) % 2 == 0);
  const int nseg = ncls * spc, units = G * nseg;

  float tot[TJ][GEN_CPT];
#pragma unroll
  for (int i = 0; i < TJ; ++i)
#pragma unroll
    for (int v = 0; v < GEN_CPT; ++v) tot[i][v] = 0.0f;

#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    __syncthreads();  // step s - 1 is summed: its ring rows and barrier are free
    issue(s + PRE);
    if (a.tma) mbar_wait(&bars[s % NBAR], (s / NBAR) & 1);
    if (!live) continue;
#pragma unroll 1
    for (int u = sub; u < units; u += lpi) {
      const int g = u / nseg, sg = u - g * nseg;
      const int ro = s * G + g;
      if (ro >= nrows) break;  // units run by row
      const int xr = h0 + ro + ri * d;
      if (xr < 0 || xr >= h) continue;  // this tap row's x row is outside the image
      const int r = sg / spc, jc = (sg - r * spc) * seg;
      const int len = min(seg, cdiv(nw - r, d) - jc);
      const int ow0 = w0 + r + jc * d;  // the segment's first output column
      // the columns at which some slot of the tile lies inside the image
      const int ja = max(0, ceil_div(-(ow0 + (ot + TJ - 1) * d), d));
      const int jb = min(len, ceil_div(w - ow0 - ot * d, d));
      if (ja >= jb) continue;
      const int xslot = (ro + (ri - ri0) * d) % a.nxr, gslot = ro % NGR;
      const unsigned char* xrow =
          xs + (size_t)xslot * a.xrow + (skew(xslot) - xc0) * PBT + lane_off;
      const unsigned char* gp =
          gs + (size_t)gslot * a.grow + (skew(gslot) + ow0 - w0 + ja * d) * PBT + lane_off;
      // window slot t at step i holds x column cx0 + (i + t) d: entry e in win[e % TJ]
      const int cx0 = ow0 + (ja + ot) * d;
      auto xat = [&](int e) {
        const int cx = cx0 + e * d;
        return (unsigned)cx < (unsigned)w ? xrow + cx * PBT : zero;
      };
      float win[TJ][GEN_CPT], acc[TJ][GEN_CPT];
#pragma unroll
      for (int i = 0; i < TJ; ++i)
#pragma unroll
        for (int v = 0; v < GEN_CPT; ++v) acc[i][v] = 0.0f;
#pragma unroll
      for (int e = 0; e < TJ - 1; ++e) load_vec<T, GEN_CPT>(xat(e), win[e]);
      const int len2 = jb - ja;
#pragma unroll 1
      for (int ib = 0; ib < len2; ib += TJ) {
#pragma unroll
        for (int ii = 0; ii < TJ; ++ii) {
          if (ib + ii >= len2) break;
          load_vec<T, GEN_CPT>(xat(ib + ii + TJ - 1), win[(ii + TJ - 1) % TJ]);
          float gv[GEN_CPT];
          load_vec<T, GEN_CPT>(gp, gv);
          gp += d * PBT;
#pragma unroll
          for (int tt = 0; tt < TJ; ++tt)
#pragma unroll
            for (int v = 0; v < GEN_CPT; ++v)
              acc[tt][v] = fmaf(win[(ii + tt) % TJ][v], gv[v], acc[tt][v]);
        }
      }
#pragma unroll
      for (int i = 0; i < TJ; ++i)
#pragma unroll
        for (int v = 0; v < GEN_CPT; ++v) tot[i][v] += acc[i][v];
    }
  }
  __syncthreads();  // the rings are dead: their space takes the lanes' sums

  // the lanes of one item, by a fixed pairwise tree: lane sub adds lane
  // sub + st at level st where sub % 2st == 0
  float* red = reinterpret_cast<float*>(xs);  // [GEN_NPX][TJ][GEN_CH]
#pragma unroll
  for (int i = 0; i < TJ; ++i)
#pragma unroll
    for (int v = 0; v < GEN_CPT; ++v) red[(pl * TJ + i) * GEN_CH + q * GEN_CPT + v] = tot[i][v];
  __syncthreads();
  const int lpi_max = cdiv(GEN_NPX, ni);
  for (int st = 1; st < lpi_max; st <<= 1) {
    for (int i = t; i < GEN_NPX * TJ * GEN_CH; i += NT) {
      const int p = i / (TJ * GEN_CH), sb = p / ni;
      if (sb % (2 * st) == 0 && p + st * ni < GEN_NPX) red[i] += red[i + st * ni * TJ * GEN_CH];
    }
    __syncthreads();
  }
  // the CTA's slot: part[cb][slot][tap][GEN_CH], the taps this CTA owns
  float* mine = part + ((size_t)cb * gridDim.x + slot) * a.ntap * GEN_CH;
  for (int i = t; i < ni * TJ * GEN_CH; i += NT) {
    const int it = i / (TJ * GEN_CH), tt = (i / GEN_CH) % TJ, ch = i % GEN_CH;
    const int tile = tg0 + it % ntc, cj = tile_start(tile) + tt;
    if (cj < tile * TJ) continue;  // the previous tile's tap
    const int tap = (ri0 + it / ntc + a.kri) * a.kc + cj;
    mine[(size_t)tap * GEN_CH + ch] = red[i];
  }
}

// dW (c, k*k) from the slots: for each (tap, channel) the sum of its slots
// in blocks of `fold`, in order; +0 for a tap outside the image.
__global__ void __launch_bounds__(NT) dw_wgrad_gen_fold(const float* __restrict__ part,
                                                        float* __restrict__ dw, int c, int k,
                                                        int kri, int krj, int slots, int fold) {
  const long long e = (long long)blockIdx.x * NT + threadIdx.x;
  const int kk = k * k;
  if (e >= (long long)kk * c) return;
  const int tap = (int)(e / c), ch = (int)(e - (long long)tap * c);  // channels fastest
  const int hk = (k - 1) / 2, oi = tap / k - hk, oj = tap % k - hk;
  float s = 0.0f;
  if (abs(oi) <= kri && abs(oj) <= krj) {
    const int kc = 2 * krj + 1, ntap = (2 * kri + 1) * kc;
    const size_t stride = (size_t)ntap * GEN_CH;
    const float* p = part + ((size_t)(ch / GEN_CH) * slots * ntap + (oi + kri) * kc + oj + krj) *
                                GEN_CH + ch % GEN_CH;
    for (int b0 = 0; b0 < slots; b0 += fold) {
      float blk = 0.0f;
      const int b1 = min(b0 + fold, slots);
      for (int sl = b0; sl < b1; ++sl) blk += __ldg(p + (size_t)sl * stride);
      s += blk;
    }
  }
  dw[(size_t)ch * kk + tap] = s;
}

// The general form's shared memory: 128 bytes of alignment, the zero
// pixel, then the rings or the lanes' sums after them, whichever is larger.
struct GenGeom {
  int kri, krj, kc, ntj, nxc, bwx, bwg, xrow, grow;
  long long nxr, smem;
};

GenGeom gen_geom(int h, int w, int k, int d, int tj, int ntg, int kg, int tw, int elem) {
  GenGeom g;
  const int hk = (k - 1) / 2;
  g.kri = min(hk, (h - 1) / d);
  g.krj = min(hk, (w - 1) / d);
  g.kc = 2 * g.krj + 1;
  g.ntj = cdiv(g.kc, tj);
  const int span = min(g.kc, ntg * tj);  // tap columns a column group reaches over
  g.nxc = (int)std::min<long long>(w, tw + (long long)(span - 1) * d);
  const int pb = GEN_CH * elem, sk = ALIGN / pb;  // a row's skew takes up to sk - 1 pixels
  g.bwx = min(MAX_BOX, g.nxc + sk - 1);
  g.bwg = min(MAX_BOX, tw + sk - 1);
  g.xrow = up128(cdiv(g.nxc + sk - 1, g.bwx) * g.bwx * pb);
  g.grow = up128(cdiv(tw + sk - 1, g.bwg) * g.bwg * pb);
  g.nxr = (long long)(kg - 1) * d + G * (PRE + 1);
  const long long ring = g.nxr * g.xrow + (long long)G * (PRE + 1) * g.grow;
  const long long red = (long long)GEN_NPX * tj * GEN_CH * 4;
  g.smem = ALIGN + GEN_ZERO + (ring > red ? ring : red);
  return g;
}

template <typename T, int TJ>
cudaError_t launch_gen_t(const void* x, const void* dy, float* part, const GenArgs& a, int smem,
                         unsigned slots, unsigned cblocks, unsigned groups, cudaStream_t s) {
  static std::atomic<int> smem_set{0};  // the largest opt-in made for this instance
  if (smem > smem_set.load()) {
    const cudaError_t e = cudaFuncSetAttribute(dw_wgrad_gen_tiles<T, TJ>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set.store(smem);
  }
  CUtensorMap tmx, tmg;
  memset(&tmx, 0, sizeof(tmx));
  memset(&tmg, 0, sizeof(tmg));
  if (a.tma) {
    const bool bf = sizeof(T) == 2;
    cudaError_t e = row_map(&tmx, x, bf, a.n, a.h, a.w, a.c, GEN_CH, a.bwx);
    if (e == cudaSuccess) e = row_map(&tmg, dy, bf, a.n, a.h, a.w, a.c, GEN_CH, a.bwg);
    if (e != cudaSuccess) return e;
  }
  dw_wgrad_gen_tiles<T, TJ><<<dim3(slots, cblocks, groups), NT, smem, s>>>(
      tmx, tmg, static_cast<const T*>(x), static_cast<const T*>(dy), part, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gen_tj(int tj, const void* x, const void* dy, float* part, const GenArgs& a,
                          int smem, unsigned slots, unsigned cblocks, unsigned groups,
                          cudaStream_t s) {
  switch (tj) {
    case 1: return launch_gen_t<T, 1>(x, dy, part, a, smem, slots, cblocks, groups, s);
    case 2: return launch_gen_t<T, 2>(x, dy, part, a, smem, slots, cblocks, groups, s);
    case 3: return launch_gen_t<T, 3>(x, dy, part, a, smem, slots, cblocks, groups, s);
    case 4: return launch_gen_t<T, 4>(x, dy, part, a, smem, slots, cblocks, groups, s);
    case 5: return launch_gen_t<T, 5>(x, dy, part, a, smem, slots, cblocks, groups, s);
    case 6: return launch_gen_t<T, 6>(x, dy, part, a, smem, slots, cblocks, groups, s);
    case 7: return launch_gen_t<T, 7>(x, dy, part, a, smem, slots, cblocks, groups, s);
    case 8: return launch_gen_t<T, 8>(x, dy, part, a, smem, slots, cblocks, groups, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// K6. x, dy (n, h, w, c) bf16 (is_bf16 = 1) or f32, contiguous -> dw (c, k*k)
// f32. k in {1, 3, 5, 7}; rows and tw from the plan
// (ops/kernels/depthwise_wgrad.py::k6_plan). With cb = PB / elem channels
// a block, partial holds cdiv(c, cb) * n * cdiv(h, rows) * cdiv(w, tw) *
// k * k * cb floats; tickets cdiv(c, cb) zeros, left zero by the launch.
int tsii_dw_wgrad(const void* x, const void* dy, void* partial, void* tickets, void* dw, int n,
                  int h, int w, int c, int k, int d, int is_bf16, int rows, int tw, void* stream) {
  if (d < 1 || n < 0 || h < 0 || w < 0 || c < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 0) return (int)cudaSuccess;
  if ((long long)n * h * w == 0)
    return (int)cudaMemsetAsync(dw, 0, sizeof(float) * (size_t)k * k * c, s);
  float* pf = static_cast<float*>(partial);
  unsigned* tk = static_cast<unsigned*>(tickets);
  float* dwf = static_cast<float*>(dw);
  const cudaError_t e = is_bf16 ? launch_k<bf16>(x, dy, pf, tk, dwf, n, h, w, c, k, d, rows, tw, s)
                                : launch_k<float>(x, dy, pf, tk, dwf, n, h, w, c, k, d, rows, tw, s);
  return (int)e;
}

// K6's general form (k odd, any d >= 1): x, dy (n, h, w, c) bf16 or f32,
// contiguous -> dw (c, k*k) f32. tj, ntg, kg, rows, tw and fold from
// ops/kernels/depthwise_wgrad.py::k6_gen_plan; partial holds cdiv(c, 16) *
// n * cdiv(h, rows) * cdiv(w, tw) * (2 kri + 1) * (2 krj + 1) * 16 floats
// (kri = min((k-1)/2, (h-1)/d), krj the same with w). Two kernels on `stream`.
int tsii_dw_wgrad_gen(const void* x, const void* dy, void* partial, void* dw, int n, int h, int w,
                      int c, int k, int d, int is_bf16, int tj, int ntg, int kg, int rows, int tw,
                      int fold, void* stream) {
  if (d < 1 || d > GEN_MAX_D || k < 1 || k % 2 == 0 || n < 0 || h < 0 || w < 0 || c < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 0) return (int)cudaSuccess;
  if ((long long)n * h * w == 0)
    return (int)cudaMemsetAsync(dw, 0, sizeof(float) * (size_t)k * k * c, s);
  const int elem = is_bf16 ? 2 : 4;
  if (tj < 1 || tj > GEN_TJ || ntg < 1 || kg < 1 || rows < 1 || tw < 1 || tw > w || fold < 1)
    return (int)cudaErrorInvalidValue;
  const GenGeom g = gen_geom(h, w, k, d, tj, ntg, kg, tw, elem);
  if (tj > g.kc || ntg > g.ntj || kg > 2 * g.kri + 1 || kg * ntg > GEN_NPX || g.smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  GenArgs a;
  a.n = n; a.h = h; a.w = w; a.c = c; a.d = d;
  a.kri = g.kri; a.krj = g.krj; a.kc = g.kc; a.ntj = g.ntj;
  a.kg = kg; a.ngr = cdiv(2 * g.kri + 1, kg); a.ntg = ntg; a.ngc = cdiv(g.ntj, ntg);
  a.rows = rows; a.bands = cdiv(h, rows); a.tw = tw; a.strips = cdiv(w, tw);
  a.bwx = g.bwx; a.bwg = g.bwg; a.xrow = g.xrow; a.grow = g.grow; a.nxr = (int)g.nxr;
  a.ntap = (2 * g.kri + 1) * g.kc;
  // TMA needs 16-byte aligned rows: pixel strides and base addresses
  a.tma = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy)) % 16 == 0) &&
          ((size_t)c * elem) % 16 == 0;
  const long long slots = (long long)n * a.bands * a.strips;
  const int cblocks = cdiv(c, GEN_CH), groups = a.ngr * a.ngc;
  if (slots > 0x7fffffffLL || cblocks > 65535 || groups > 65535) return (int)cudaErrorInvalidValue;
  float* pf = static_cast<float*>(partial);
  cudaError_t e = is_bf16 ? launch_gen_tj<bf16>(tj, x, dy, pf, a, (int)g.smem, (unsigned)slots,
                                                cblocks, groups, s)
                          : launch_gen_tj<float>(tj, x, dy, pf, a, (int)g.smem, (unsigned)slots,
                                                 cblocks, groups, s);
  if (e != cudaSuccess) return (int)e;
  const long long items = (long long)k * k * c;
  dw_wgrad_gen_fold<<<(unsigned)((items + NT - 1) / NT), NT, 0, s>>>(
      pf, static_cast<float*>(dw), c, k, g.kri, g.krj, (int)slots, fold);
  return (int)cudaGetLastError();
}

}  // extern "C"
