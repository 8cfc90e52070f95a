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

// The general form, for the rest of JAX's scope (any odd k, any equal
// dilation): the windows the template is not built for (k other than 1, 3,
// 5, 7) and the dilations whose halo leaves no strip a 256-pixel TMA row or
// the rings (k6_plan). A thread per (tap, channel) and chunk of output
// pixels sums x * dy in f32 over its chunk and writes the chunk's row of
// partials, (tap, channel); dw_wgrad_gen_sum adds the rows in chunk order
// into dW (c, k*k). No shared memory and no atomics: two launches give the
// same bits. Correct and simple, not tuned.
__device__ __forceinline__ float as_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float as_f32(float v) { return v; }

template <typename T>
__global__ void __launch_bounds__(NT) dw_wgrad_gen(const T* __restrict__ x,
                                                   const T* __restrict__ dy, float* partial, int n,
                                                   int h, int w, int c, int k, int d, int chunks) {
  const int e = blockIdx.x * NT + threadIdx.x;
  const int tap = e / c, ch = e - tap * c;
  if (tap >= k * k) return;
  const int p = d * (k - 1) / 2;
  const int oy = (tap / k) * d - p, ox = (tap % k) * d - p;
  const long long P = (long long)n * h * w;
  const long long b = blockIdx.y * P / chunks, end = (blockIdx.y + 1) * P / chunks;
  int ow = (int)(b % w), oh = (int)(b / w % h), nn = (int)(b / w / h);
  float acc = 0.f;
  for (long long pix = b; pix < end; ++pix) {
    const int ih = oh + oy, iw = ow + ox;
    if (ih >= 0 && ih < h && iw >= 0 && iw < w)
      acc = fmaf(as_f32(x[(((size_t)nn * h + ih) * w + iw) * c + ch]), as_f32(dy[pix * c + ch]),
                 acc);
    if (++ow == w) {
      ow = 0;
      if (++oh == h) oh = 0, ++nn;
    }
  }
  partial[(size_t)blockIdx.y * k * k * c + e] = acc;
}

__global__ void __launch_bounds__(NT) dw_wgrad_gen_sum(const float* __restrict__ partial,
                                                       float* __restrict__ dw, int chunks, int kk,
                                                       int c) {
  const int e = blockIdx.x * NT + threadIdx.x;
  const int tap = e / c, ch = e - tap * c;
  if (tap >= kk) return;
  float s = 0.f;
  for (int z = 0; z < chunks; ++z) s += partial[(size_t)z * kk * c + e];
  dw[(size_t)ch * kk + tap] = s;
}

template <typename T>
cudaError_t launch_gen(const void* x, const void* dy, float* partial, float* dw, int n, int h,
                       int w, int c, int k, int d, int chunks, cudaStream_t s) {
  const long long items = (long long)k * k * c;
  if (chunks < 1 || chunks > 65535 || items >= (1ll << 31) - NT) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((items + NT - 1) / NT);
  dw_wgrad_gen<T><<<dim3(blocks, (unsigned)chunks), NT, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), partial, n, h, w, c, k, d, chunks);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dw_wgrad_gen_sum<<<blocks, NT, 0, s>>>(partial, dw, chunks, k * k, c);
  return cudaGetLastError();
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

// K6's general form (k odd, any d >= 1): partial holds chunks * k*k * c
// floats (ops/kernels/depthwise_wgrad.py::k6_plan gives chunks); dw (c,
// k*k) f32. Two kernels on `stream`.
int tsii_dw_wgrad_gen(const void* x, const void* dy, void* partial, void* dw, int n, int h, int w,
                      int c, int k, int d, int is_bf16, int chunks, void* stream) {
  if (d < 1 || k < 1 || k % 2 == 0 || n < 0 || h < 0 || w < 0 || c < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 0) return (int)cudaSuccess;
  if ((long long)n * h * w == 0)
    return (int)cudaMemsetAsync(dw, 0, sizeof(float) * (size_t)k * k * c, s);
  float* pf = static_cast<float*>(partial);
  float* dwf = static_cast<float*>(dw);
  return (int)(is_bf16 ? launch_gen<bf16>(x, dy, pf, dwf, n, h, w, c, k, d, chunks, s)
                       : launch_gen<float>(x, dy, pf, dwf, n, h, w, c, k, d, chunks, s));
}

}  // extern "C"
