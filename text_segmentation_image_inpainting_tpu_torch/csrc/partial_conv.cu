// Fused partial convolution (Liu et al. 2018) for Hopper, NHWC, bf16 in/out.
//
//   acc  = sum_taps sum_c (x[c] * M_g(c)) * W[tap, c, o]          (f32)
//   msum = sum_taps sum_g size_g * M_g                             (f32, exact)
//   y    = msum > 0 ? acc * (k*k*Cin / max(msum, 1)) + b : 0       (one cast)
//   M'   = msum > 0
//
// K1 `pconv_k1` (and its halo form `pconv_k1_halo`) replaces the TPU
// kernel `_kernel` / `_pallas_forward`
// (text_segmentation_image_inpainting_tpu/ops/pallas/partial_conv_kernel.py)
// for stride 1, dilation 1, square k and Cout >= 8: the U-Net decoder levels.
// It is an implicit GEMM, M = output pixels, N = Cout, K = k*k*Cin, bound
// by the tensor cores at every decoder level (2*P*Cout*9*Cin FLOP against
// a few MB moved: 116 GFLOP at dec3..dec1, 1.2 GFLOP at dec7). A K step is
// one tap x 64 channels, so every pixel's slice of x is one 128-byte row
// and every weight slice one 128-byte row per output channel: both
// operands are K-major tiles in shared memory with the 128-byte swizzle
// that `wgmma` reads without bank conflicts. On the card what bounds it is
// the operand traffic from L2 into shared memory (the im2col gather reads
// each x row once per tap), so the tiles are as large as the registers
// allow and the halo form gathers a window row once for its three taps.
//
//   - A CTA owns BM (128, or 256 with two m64 tiles per warpgroup) output
//     pixels x BN (64, 128 or 256) output channels. Warpgroups 0 and 1 are
//     consumers: they run `wgmma.mma_async` m64nBNk16 with f32
//     accumulators in registers (setmaxnreg 224). Warpgroup 2 is the
//     producer (setmaxnreg 56): it keeps a ring of shared stages (as many
//     as fit in 200 KB, 3..8) filled with 16-byte `cp.async` copies (the
//     im2col gather of x and the weight tile), each stage handed over by
//     an mbarrier that the copies themselves complete
//     (`cp.async.mbarrier.arrive.noinc`) and handed back by an mbarrier
//     the consumers arrive on once the `wgmma` that read it has retired.
//   - The mask: a tap whose group mask is 0, or that lies outside the
//     image, is zero-filled by the copy itself (src-size 0), so x*M
//     never exists anywhere. This is exact for binary masks, which is
//     every mask the U-Net makes (hole masks, M' of the level below); a
//     mask value other than 0 takes x as it is. It also gives 0 where
//     x*0 would be NaN for an infinite x. The prologue reads each pixel's
//     window of the mask once: msum, and one bit per (tap, group) that
//     the producer tests instead of reading the mask at every K step.
//   - The halo form (3x3 windows, same-size maps of a width that is a
//     multiple of 64: dec2 and dec1): a K step is one window row x 64
//     channels; the tile's input rows with one pixel of halo are gathered
//     once and the three taps read them at offsets of 0, 1 and 2 rows of
//     128 bytes (the hardware swizzles by address, so a descriptor may
//     start at any row). A third of the plain form's gathered bytes.
//   - Split K, for launches whose tile grid does not fill the 132 SMs
//     (the deep levels dec7..dec4: 4..128 tiles of 144 K steps): the
//     wrapper picks the tile and `splits` (a pure function of the shape
//     in ops/kernels/partial_conv.py::k1_plan, by a cost model of waves x
//     steps x stage bytes) and CTA z takes K steps
//     [z*steps/splits, (z+1)*steps/splits). Each writes its f32 partial
//     tile to a workspace; `pconv_k1_reduce` adds the partials in split
//     order, counts msum and applies the epilogue. No atomics: two
//     launches give the same bits.
//   - The epilogue (no split) scales by the prologue's per-pixel factor,
//     adds the bias, zeroes empty windows and rounds once to bf16.
//
// The wrapper lays x out so that every 8-channel chunk lies in one mask
// group (a copy only when a group size is not a multiple of 8) and the
// weights as (k*k, Cout_p, Cin_p), zero padded, in every call.
//
// K2 `pconv_k2` replaces `_kernel_small_cout` / `_pallas_forward_small_cout`
// (same file) for Cout <= 7: the U-Net's RGB head (67 -> 3 at full
// resolution), bound by reading its input from device memory (at the head
// 8 x 512^2 x 67 bf16 = 281 MB). It is a GEMM with N padded to 8 on
// `mma.sync`; `pconv_k2_bwd` is its backward and `pconv_k3_prep`,
// `pconv_k3_mask` and `pconv_colsum` are K3, the backward of K1, around
// two library products (the custom VJP `_bwd` of the same file). Their
// notes stand at their sections below.
//
// Both kernels count the window's mask taps per group in f32 and weight
// them by the group sizes afterwards, so msum is an exact integer: a
// weighted count rounded in bf16 skews the renormalisation.
// The TPU kernels' packing ([x | mask | 0-pad] lanes, flat-tap wrap-around
// columns, K2's transposed layout) exists for Mosaic and is not ported.
//
// Plain C interface (loaded with ctypes); each launcher returns
// cudaGetLastError() right after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

struct Params {
  const __nv_bfloat16* x;     // K1: (N, H, W, cin_x); K2: (N, H, W, Cin)
  const __nv_bfloat16* mask;  // (N, H, W, G)
  const __nv_bfloat16* w;     // K1: (k*k, Cout_p, Cin_p); K2: (blocks, k*k, 8, cb); its backward: (blocks * cb, kj)
  const float* bias;          // (Cout_p) or nullptr
  __nv_bfloat16* y;           // (N, Hout, Wout, Cout)
  __nv_bfloat16* mask_out;    // (N, Hout, Wout, 1)
  float* partial;             // K1 with splits > 1: (splits, P, Cout_p); K3: per-CTA partial sums
  int n, h, w_in, cin, g, size0, size1;  // cin and group sizes as the layer has them
  int hout, wout, cout, cin_p, cout_p, k, ph, pw;  // ph, pw: zero padding of H and of W
  int cin_x, gb, splits;  // K1: x's channel count, group 1's first channel in x
  // K2, its backward and K3
  const __nv_bfloat16* gout;  // the cotangent of y, (N, Hout, Wout, Cout)
  __nv_bfloat16* dx;          // (N, H, W, Cin)
  size_t x_bytes;             // the size of x
  int cb, nblk, kj;           // channels per block, blocks, k*k*Cout padded to 16
  int need_dx, need_dw, need_db;
  const int* groups;          // G > 2: the group table (below), else nullptr
};

// More than two mask groups: `groups` is an int32 table in device memory,
// [0, G) the group sizes, [G, 2G + 1) each group's first channel in the
// layer (the last entry Cin) and [2G + 1, 3G + 2) each group's first
// channel in K1's x (multiples of 8; the last entry cin_x)
// (ops/kernels/partial_conv.py::group_table). One or two groups travel in
// size0 and size1 instead, and the table is nullptr.
__device__ __forceinline__ int group_of(const int* starts, int g, int c) {
  int i = 0;
  while (i + 1 < g && c >= __ldg(starts + i + 1)) ++i;
  return i;
}

// sum over the window's taps and the groups of size_g * M_g, in f32 (G > 2;
// exact for binary masks, as the two-group count below).
template <typename M>
__device__ __forceinline__ float window_sum_groups(const M* mask, const int* sizes, int g, int h,
                                                   int w_in, int k, int ph, int pw, int n, int oh,
                                                   int ow) {
  float msum = 0.f;
  for (int dy = 0; dy < k; ++dy) {
    const int ih = oh + dy - ph;
    if (ih < 0 || ih >= h) continue;
    for (int dx = 0; dx < k; ++dx) {
      const int iw = ow + dx - pw;
      if (iw < 0 || iw >= w_in) continue;
      const M* m = mask + ((size_t)(n * h + ih) * w_in + iw) * g;
      for (int gi = 0; gi < g; ++gi)
        msum = __fadd_rn(msum, __fmul_rn((float)__ldg(sizes + gi), to_f32(m[gi])));
    }
  }
  return msum;
}

__device__ __forceinline__ const __nv_bfloat16* mask_at(const Params& p, int n, int ih, int iw) {
  return p.mask + ((size_t)(n * p.h + ih) * p.w_in + iw) * p.g;
}

// Weighted window count of valid taps: raw per-group counts in f32, then
// one weighting by the group sizes (exact for binary masks). Also the tap
// bits: bit 2 tap + g set when tap `tap` lies in the image and its group-g
// mask is not 0 (taps below 16).
__device__ __forceinline__ float window_scan(const Params& p, int n, int oh, int ow,
                                             unsigned& bits) {
  if (p.g > 2)  // no tap bits: K1 reads the mask itself at G > 2
    return window_sum_groups(p.mask, p.groups, p.g, p.h, p.w_in, p.k, p.ph, p.pw, n, oh, ow);
  const unsigned short* mbits = reinterpret_cast<const unsigned short*>(p.mask);
  float c0 = 0.f, c1 = 0.f;
  for (int dy = 0; dy < p.k; ++dy) {
    const int ih = oh + dy - p.ph;
    if (ih < 0 || ih >= p.h) continue;
    for (int dx = 0; dx < p.k; ++dx) {
      const int iw = ow + dx - p.pw;
      if (iw < 0 || iw >= p.w_in) continue;
      const int tap = dy * p.k + dx;
      const unsigned short* m = mbits + ((size_t)(n * p.h + ih) * p.w_in + iw) * p.g;
      const unsigned short m0 = m[0], m1 = p.g == 2 ? m[1] : 0;
      c0 += __bfloat162float(__ushort_as_bfloat16(m0));
      c1 += __bfloat162float(__ushort_as_bfloat16(m1));
      if (tap < 16) bits |= ((m0 & 0x7fff) ? 1u : 0u) << (2 * tap) | ((m1 & 0x7fff) ? 2u : 0u) << (2 * tap);
    }
  }
  return __fadd_rn(__fmul_rn((float)p.size0, c0), __fmul_rn((float)p.size1, c1));
}

// y = valid ? acc * scale + b : 0, rounded once; no FMA contraction so the
// result matches the plain version's separate multiply and add.
__device__ __forceinline__ float epilogue(float acc, float scale, float b) {
  return scale > 0.f ? __fadd_rn(__fmul_rn(acc, scale), b) : 0.f;
}

// ---------------------------------------------------------------- K1 ----

constexpr int K1_BK = 64;                  // channels per K step: 128-byte rows
constexpr int K1_CONSUMERS = 256;          // warpgroups 0 and 1
constexpr int K1_PRODUCERS = 128;          // warpgroup 2
constexpr int K1_THREADS = K1_CONSUMERS + K1_PRODUCERS;
constexpr int K1_RING = 200 * 1024;        // shared bytes for the ring of stages

// A CTA tile: 2 consumer warpgroups x MT m64 row tiles = BM pixels, BN channels.
template <int BN, int MT>
struct K1Tile {
  static constexpr int BM = 128 * MT;
  static constexpr int A_BYTES = BM * K1_BK * 2;
  static constexpr int STAGE = A_BYTES + BN * K1_BK * 2;
  static constexpr int STAGES = K1_RING / STAGE < 8 ? K1_RING / STAGE : 8;
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + slack to align the ring to 1024
};

// K1's epilogue for one consumer warpgroup. Accumulator layout of
// m64nBN: register 4 j + 2 h + e holds row 16 warp + lane / 4 + 8 h,
// column 8 j + 2 (lane % 4) + e. Without split K: scale, bias, zero in
// empty windows, one cast to bf16; with it: the f32 partial tile.
template <int BN, int MT>
__device__ __forceinline__ void k1_store(const Params& p, float (&acc)[MT][BN / 2],
                                         const float* s_scale, long long m0, int n0, int wg,
                                         int tid) {
  const long long P = (long long)p.n * p.hout * p.wout;
  const bool split = p.splits > 1;
  const int lane = tid & 31, warp = (tid & 127) >> 5;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = (MT * m + wg) * 64 + warp * 16 + (lane >> 2) + 8 * h;
      const long long pix = m0 + row;
      if (pix >= P) continue;
      const float scale = s_scale[row];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + j * 8 + (lane & 3) * 2;
        const float v0 = acc[m][4 * j + 2 * h], v1 = acc[m][4 * j + 2 * h + 1];
        if (split) {
          if (col < p.cout_p)
            *reinterpret_cast<float2*>(p.partial + ((size_t)blockIdx.z * P + pix) * p.cout_p +
                                       col) = make_float2(v0, v1);
          continue;
        }
        if (col >= p.cout) continue;
        const float b0 = p.bias ? p.bias[col] : 0.f, b1 = p.bias ? p.bias[col + 1] : 0.f;
        __nv_bfloat16* dst = p.y + pix * p.cout + col;
        const __nv_bfloat16 y0 = __float2bfloat16(epilogue(v0, scale, b0));
        const __nv_bfloat16 y1 = __float2bfloat16(epilogue(v1, scale, b1));
        if ((p.cout & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __halves2bfloat162(y0, y1);
        } else {
          dst[0] = y0;
          if (col + 1 < p.cout) dst[1] = y1;
        }
      }
    }
  }
}

template <int BN, int MT>
__global__ void __launch_bounds__(K1_THREADS, 1) pconv_k1(const Params p) {
  using T = K1Tile<BN, MT>;
  constexpr int BM = T::BM, SB = T::STAGE, ST = T::STAGES;
  extern __shared__ uint8_t k1_smem_raw[];
  // per output pixel: (x's pixel index of the window's centre, oh, ow,
  // bit 2 tap + g set when tap `tap` lies in the image and its group-g mask
  // is not 0); oh far out of range for pixels past P
  __shared__ int4 s_row[BM];
  __shared__ float s_scale[BM];
  __shared__ __align__(8) uint64_t full_bar[ST], empty_bar[ST];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(k1_smem_raw) + 1023) & ~(uintptr_t)1023);

  const int tid = threadIdx.x;
  const long long P = (long long)p.n * p.hout * p.wout;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int chunks = p.cin_p / K1_BK;
  const int steps = p.k * p.k * chunks;
  const int s_begin = (int)((long long)blockIdx.z * steps / p.splits);
  const int s_end = (int)((long long)(blockIdx.z + 1) * steps / p.splits);
  const bool split = p.splits > 1;
  const bool tap_bits = p.g <= 2 && p.k * p.k * 2 <= 32;  // else the producer reads the mask
  const unsigned short* mbits = reinterpret_cast<const unsigned short*>(p.mask);

  // Prologue: each pixel's coordinates and tap bits; without split K also
  // its renormalisation (the first Cout tile writes M').
  for (int r = tid; r < BM; r += K1_THREADS) {
    const long long pix = m0 + r;
    int4 row = make_int4(0, -(1 << 29), 0, 0);
    float scale = -1.f;  // <= 0 marks an empty window
    if (pix < P) {
      const int ow = (int)(pix % p.wout);
      const long long t = pix / p.wout;
      const int oh = (int)(t % p.hout);
      const int nn = (int)(t / p.hout);
      unsigned bits = 0;
      const float msum = window_scan(p, nn, oh, ow, bits);
      row = make_int4((nn * p.h + oh) * p.w_in + ow, oh, ow, (int)bits);
      if (!split) {
        const bool valid = msum > 0.f;
        if (valid) scale = (float)(p.k * p.k * p.cin) / fmaxf(msum, 1.f);
        if (blockIdx.y == 0) p.mask_out[pix] = __float2bfloat16(valid ? 1.f : 0.f);
      }
    }
    s_row[r] = row;
    s_scale[r] = scale;
  }
  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full_bar[i], K1_PRODUCERS);
      mbar_init(&empty_bar[i], K1_CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    // ---- producer: thread t copies 16-byte chunk t % 8 of rows t / 8 + 16 j
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int t = tid - K1_CONSUMERS, c = t & 7, r0 = t >> 3;
    const uint32_t dst0 = sw128(r0, c);  // rows r0 + 16 j: + 2048 j, the same swizzle
    for (int s = s_begin, i = 0; s < s_end; ++s, ++i) {
      const int stage = i % ST;
      if (i >= ST) mbar_wait(&empty_bar[stage], (i / ST - 1) & 1);
      const int tap = s / chunks, cb = s - tap * chunks;
      const int dy = tap / p.k, dx = tap - dy * p.k;
      const int toff = (dy - p.ph) * p.w_in + (dx - p.pw);  // the tap's pixel offset in x
      const int ch = cb * K1_BK + c * 8;
      const bool ch_ok = ch < p.cin_x;
      const int grp = p.g > 2 ? group_of(p.groups + 2 * p.g + 1, p.g, ch)
                              : (p.g == 2 && ch >= p.gb) ? 1 : 0;
      const unsigned bit = tap_bits ? 1u << (2 * tap + grp) : 0u;
      const __nv_bfloat16* xs = p.x + ch;
      const uint32_t a = smem_u32(ring + stage * SB) + dst0;
      const uint32_t b = a + T::A_BYTES;
#pragma unroll 8
      for (int j = 0; j < BM / 16; ++j) {
        const int4 ri = s_row[r0 + 16 * j];
        bool take;
        if (tap_bits) {
          take = ch_ok && ((unsigned)ri.w & bit);
        } else {
          const int ih = ri.y + dy - p.ph, iw = ri.z + dx - p.pw;
          take = ch_ok && ih >= 0 && ih < p.h && iw >= 0 && iw < p.w_in &&
                 (__ldg(mbits + (size_t)(ri.x + toff) * p.g + grp) & 0x7fff);
        }
        cp_async16(a + 2048 * j, take ? (const void*)(xs + (size_t)(ri.x + toff) * p.cin_x) : p.x,
                   take ? 16 : 0);
      }
      const __nv_bfloat16* wrow =
          p.w + ((size_t)tap * p.cout_p + n0 + r0) * p.cin_p + cb * K1_BK + c * 8;
#pragma unroll 4
      for (int j = 0; j < BN / 16; ++j) {
        const bool take = n0 + r0 + 16 * j < p.cout_p;
        cp_async16(b + 2048 * j, take ? (const void*)(wrow + (size_t)16 * j * p.cin_p) : p.w,
                   take ? 16 : 0);
      }
      cp_async_arrive(&full_bar[stage]);
    }
    cp_async_wait_all();
  } else {
    // ---- consumers: warpgroup wg multiplies pixel rows 64 (MT m + wg) + 0..63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    float acc[MT][BN / 2];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[m][i] = 0.f;
    for (int s = s_begin, i = 0; s < s_end; ++s, ++i) {
      const int stage = i % ST;
      mbar_wait(&full_bar[stage], (i / ST) & 1);
      // the copies wrote through the generic proxy; wgmma reads through the async one
      fence_proxy_async();
      const uint32_t a = smem_u32(ring + stage * SB);
      const uint32_t b = a + T::A_BYTES;
#pragma unroll
      for (int m = 0; m < MT; ++m) fence_acc(acc[m]);
      wgmma_fence();
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int kk = 0; kk < K1_BK / 16; ++kk)  // 32 bytes along K per k16 slice
          wgmma_m64k16(acc[m], desc_sw128(a + (MT * m + wg) * 64 * 128 + kk * 32),
                       desc_sw128(b + kk * 32));
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products have retired: free its stage
#pragma unroll
      for (int m = 0; m < MT; ++m) fence_acc(acc[m]);
      if (i > 0) mbar_arrive(&empty_bar[(i - 1) % ST]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < MT; ++m) fence_acc(acc[m]);

    k1_store<BN, MT>(p, acc, s_scale, m0, n0, wg, tid);
  }
}

// Split K's second pass: one thread per pixel and 4 channels adds the
// partials in split order, then as K1's epilogue; the first 4 channels'
// thread writes M'.
__global__ void pconv_k1_reduce(const Params p) {
  const long long P = (long long)p.n * p.hout * p.wout;
  const int q = p.cout_p / 4;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= P * q) return;
  const long long pix = idx / q;
  const int c4 = (int)(idx - pix * q) * 4;
  float4 s = *reinterpret_cast<const float4*>(p.partial + pix * p.cout_p + c4);
  for (int z = 1; z < p.splits; ++z) {
    const float4 v = *reinterpret_cast<const float4*>(p.partial + ((size_t)z * P + pix) * p.cout_p + c4);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  const int ow = (int)(pix % p.wout);
  const long long t = pix / p.wout;
  unsigned bits = 0;
  const float msum = window_scan(p, (int)(t / p.hout), (int)(t % p.hout), ow, bits);
  const bool valid = msum > 0.f;
  const float scale = valid ? (float)(p.k * p.k * p.cin) / fmaxf(msum, 1.f) : -1.f;
  if (c4 == 0) p.mask_out[pix] = __float2bfloat16(valid ? 1.f : 0.f);
  const float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int col = c4 + e;
    if (col < p.cout)
      p.y[pix * p.cout + col] = __float2bfloat16(epilogue(v[e], scale, p.bias ? p.bias[col] : 0.f));
  }
}

template <int BN, int MT>
cudaError_t launch_k1(const Params& p, cudaStream_t stream) {
  using T = K1Tile<BN, MT>;
  cudaError_t e = cudaFuncSetAttribute(pconv_k1<BN, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       T::SMEM);
  if (e != cudaSuccess) return e;
  const long long P = (long long)p.n * p.hout * p.wout;
  const dim3 grid((unsigned)((P + T::BM - 1) / T::BM), (unsigned)((p.cout_p + BN - 1) / BN),
                  (unsigned)p.splits);
  pconv_k1<BN, MT><<<grid, K1_THREADS, T::SMEM, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return e;
  const long long items = P * (p.cout_p / 4);
  pconv_k1_reduce<<<(unsigned)((items + 255) / 256), 256, 0, stream>>>(p);
  return cudaGetLastError();
}

// The halo form of K1, for 3x3 windows whose output width is 64 or a
// multiple of 128 (dec2 and dec1 of the U-Net, with padding (1, 1), or
// (0, 1) on an H shard that carries its neighbours' rows). A tile of BM
// pixels (128, or 256 with two m64 tiles per consumer warpgroup) is one
// image row segment or whole rows, and each m64 tile lies in one row. A K step is
// one window row dy x 64 channels: the producer gathers the tile's input
// rows for dy with one pixel of halo on either side, (rows) x (width + 2)
// pixels, once, and the three taps dx = 0, 1, 2 read it at pixel offsets
// 0, 1, 2 (a wgmma descriptor may start at any 128-byte row). That is a
// third of the gathered A bytes of the plain form. The halo pixels outside
// the image or whose group mask is 0 are zero-filled, as there.
template <int BN, int MT>
struct K1Halo {
  static constexpr int BM = 128 * MT;
  // halo pixels: at most BM + 4 (two rows of width 64: 2 x 66), rounded up to 8
  static constexpr int A_ROWS = BM + 8;
  static constexpr int A_BYTES = A_ROWS * 128;
  static constexpr int STAGE = A_BYTES + 3 * BN * K1_BK * 2;
  static constexpr int STAGES = K1_RING / STAGE < 8 ? K1_RING / STAGE : 8;
  static constexpr int SMEM = STAGES * STAGE + 1024;
};

template <int BN, int MT>
__global__ void __launch_bounds__(K1_THREADS, 1) pconv_k1_halo(const Params p) {
  using T = K1Halo<BN, MT>;
  constexpr int BM = T::BM, SB = T::STAGE, ST = T::STAGES, AR = T::A_ROWS;
  extern __shared__ uint8_t k1_smem_raw[];
  __shared__ float s_scale[BM];
  __shared__ int s_pix[AR];          // x's pixel index of halo pixel q for dy = 0
  __shared__ uint8_t s_ok[3][AR];    // bit g: in the image and the group-g mask not 0
  __shared__ __align__(8) uint64_t full_bar[ST], empty_bar[ST];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(k1_smem_raw) + 1023) & ~(uintptr_t)1023);

  const int tid = threadIdx.x;
  const long long P = (long long)p.n * p.hout * p.wout;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int wt = p.wout < BM ? p.wout : BM;  // tile width
  const int pitch = wt + 2;                  // halo pixels per tile row
  const int halo = (BM / wt) * pitch;
  const int ow0 = (int)(m0 % p.wout);
  const int oh0 = (int)((m0 / p.wout) % p.hout);
  const int img = (int)(m0 / ((long long)p.wout * p.hout));
  const int chunks = p.cin_p / K1_BK;
  const int steps = 3 * chunks;
  const int s_begin = (int)((long long)blockIdx.z * steps / p.splits);
  const int s_end = (int)((long long)(blockIdx.z + 1) * steps / p.splits);
  const unsigned short* mbits = reinterpret_cast<const unsigned short*>(p.mask);

  // Prologue: the renormalisation of each output pixel (without split K;
  // the first Cout tile writes M'), and each halo pixel's index and flags.
  for (int r = tid; r < BM; r += K1_THREADS) {
    const long long pix = m0 + r;
    float scale = -1.f;
    if (pix < P && p.splits == 1) {
      const int ow = (int)(pix % p.wout);
      const long long t = pix / p.wout;
      unsigned bits = 0;
      const float msum = window_scan(p, (int)(t / p.hout), (int)(t % p.hout), ow, bits);
      const bool valid = msum > 0.f;
      if (valid) scale = (float)(9 * p.cin) / fmaxf(msum, 1.f);
      if (blockIdx.y == 0) p.mask_out[pix] = __float2bfloat16(valid ? 1.f : 0.f);
    }
    s_scale[r] = scale;
  }
  for (int e = tid; e < 3 * AR; e += K1_THREADS) {
    const int dy = e / AR, q = e - dy * AR;
    const int r = q / pitch, col = q - r * pitch;
    const int ih = oh0 + r + dy - p.ph, iw = ow0 + col - p.pw;
    uint8_t ok = 0;
    if (q < halo && ih >= 0 && ih < p.h && iw >= 0 && iw < p.w_in) {
      const unsigned short* m = mbits + ((size_t)(img * p.h + ih) * p.w_in + iw) * p.g;
      ok = ((m[0] & 0x7fff) ? 1 : 0) | ((p.g == 2 && (m[1] & 0x7fff)) ? 2 : 0);
    }
    s_ok[dy][q] = ok;
    if (dy == 0) s_pix[q] = (img * p.h + oh0 + r - p.ph) * p.w_in + ow0 + col - p.pw;
  }
  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full_bar[i], K1_PRODUCERS);
      mbar_init(&empty_bar[i], K1_CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    // ---- producer: thread t copies 16-byte chunk t % 8 of halo pixels and
    // weight rows t / 8 + 16 j
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int t = tid - K1_CONSUMERS, c = t & 7, q0 = t >> 3;
    const uint32_t dst0 = sw128(q0, c);  // rows q0 + 16 j: + 2048 j, the same swizzle
    for (int s = s_begin, i = 0; s < s_end; ++s, ++i) {
      const int stage = i % ST;
      if (i >= ST) mbar_wait(&empty_bar[stage], (i / ST - 1) & 1);
      const int dy = s / chunks, cb = s - dy * chunks;
      const int ch = cb * K1_BK + c * 8;
      const bool ch_ok = ch < p.cin_x;
      const int gbit = (p.g == 2 && ch >= p.gb) ? 2 : 1;
      const int drow = dy * p.w_in;  // halo row r of step dy is input row oh0 + r + dy - ph
      const uint32_t a = smem_u32(ring + stage * SB) + dst0;
      const uint32_t b = a + T::A_BYTES;
#pragma unroll
      for (int j = 0; j < (AR + 15) / 16; ++j) {
        const int q = q0 + 16 * j;
        if (q >= halo) break;
        const bool take = ch_ok && (s_ok[dy][q] & gbit);
        cp_async16(a + 2048 * j,
                   take ? (const void*)(p.x + (size_t)(s_pix[q] + drow) * p.cin_x + ch) : p.x,
                   take ? 16 : 0);
      }
#pragma unroll 4
      for (int j = 0; j < 3 * BN / 16; ++j) {
        const int row = q0 + 16 * j, dx = row / BN, o = n0 + row - dx * BN;
        const bool take = o < p.cout_p;
        const __nv_bfloat16* src =
            p.w + ((size_t)(dy * 3 + dx) * p.cout_p + o) * p.cin_p + cb * K1_BK + c * 8;
        cp_async16(b + 2048 * j, take ? (const void*)src : p.w, take ? 16 : 0);
      }
      cp_async_arrive(&full_bar[stage]);
    }
    cp_async_wait_all();
  } else {
    // ---- consumers: m64 tile MT m + wg (pixels 64 (MT m + wg) + 0..63 of
    // the tile) starts at halo pixel arow[m] for the tap dx = 0
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    int arow[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int first = 64 * (MT * m + wg);
      arow[m] = first / wt * pitch + first % wt;
    }
    float acc[MT][BN / 2];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[m][i] = 0.f;
    for (int s = s_begin, i = 0; s < s_end; ++s, ++i) {
      const int stage = i % ST;
      mbar_wait(&full_bar[stage], (i / ST) & 1);
      fence_proxy_async();
      const uint32_t a = smem_u32(ring + stage * SB);
      const uint32_t b = a + T::A_BYTES;
#pragma unroll
      for (int m = 0; m < MT; ++m) fence_acc(acc[m]);
      wgmma_fence();
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int kk = 0; kk < K1_BK / 16; ++kk)
            wgmma_m64k16(acc[m], desc_sw128(a + (arow[m] + dx) * 128 + kk * 32),
                         desc_sw128(b + dx * BN * 128 + kk * 32));
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int m = 0; m < MT; ++m) fence_acc(acc[m]);
      if (i > 0) mbar_arrive(&empty_bar[(i - 1) % ST]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < MT; ++m) fence_acc(acc[m]);
    k1_store<BN, MT>(p, acc, s_scale, m0, n0, wg, tid);
  }
}

template <int BN, int MT>
cudaError_t launch_k1_halo(const Params& p, cudaStream_t stream) {
  using T = K1Halo<BN, MT>;
  cudaError_t e = cudaFuncSetAttribute(pconv_k1_halo<BN, MT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return e;
  const long long P = (long long)p.n * p.hout * p.wout;
  const dim3 grid((unsigned)(P / T::BM), (unsigned)((p.cout_p + BN - 1) / BN), (unsigned)p.splits);
  pconv_k1_halo<BN, MT><<<grid, K1_THREADS, T::SMEM, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return e;
  const long long items = P * (p.cout_p / 4);
  pconv_k1_reduce<<<(unsigned)((items + 255) / 256), 256, 0, stream>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------------- K2 and its backward ----
//
// K2 `pconv_k2` (Cout <= 7, the RGB head) is a GEMM with M = pixels,
// N = Cout padded to 8 and K = taps x channels on `mma.sync.m16n8k16`
// (bf16 in, f32 accumulate): 24 GFLOP padded at the head, a twentieth of
// a millisecond of tensor time, so what bounds it is reading x (281 MB).
// `wgmma` is not used: its smallest tile is m64n8 with B from shared
// memory and both operands in the swizzled layouts, which 134-byte pixels
// cannot be copied into; `mma.sync` reads its A rows with `ldmatrix` at
// any 16-byte-aligned pitch. A CTA owns K2_TH x K2_TW output pixels, one
// m16 row tile per warp, and walks Cin in blocks of `cb` channels (one
// block at the head: 67 padded to 80):
//   - staging: a pixel is Cin * 2 bytes, so pixels are only 2-byte
//     aligned. Each halo pixel's slice of the block is copied with 16-byte
//     `cp.async` from the 16-byte boundary at or below its first byte into
//     its own slot of shared memory (`k2_stage`); pixels outside the image
//     are not read;
//   - re-laying: a second pass (`k2_relay`) writes each pixel's channels as
//     one row of the K-major operand, x * M_g rounded to bf16 as the plain
//     version rounds it, exactly 0 where the mask is 0 (whatever x holds)
//     or the pixel lies outside the image, and 0 in the K padding. A
//     thread shifts one 16-byte chunk of a row out of two aligned 16-byte
//     reads of the slot; a slot and a row have the same size, and the
//     forward re-lays in place. The row pitch is cb + 8 elements, an odd
//     number of 16-byte chunks, so the eight rows of an `ldmatrix` fall
//     into different banks;
//   - the product: a tap is a pixel offset into the halo. The weights
//     arrive as (blocks, taps, 8, cb) bf16, zero padded, and stay in shared
//     memory for the block; a B fragment is two 4-byte loads;
//   - msum, scale, bias, zero and M' as K1: raw per-group counts weighted
//     once, no FMA contraction. y rows are gathered in shared memory and
//     written with 16-byte stores where the row allows.
// A tile is 49 KB of shared memory at the head, so three or four CTAs share
// an SM and one's copies fly under another's products. On the card the
// kernel is held by the instructions it issues per tile (the staging's
// address arithmetic, the re-lay, the B fragments' loads), not yet by its
// bytes: tools/k2_phase_clocks.py reads the cycles of each phase.
//
// `pconv_k2_bwd` is the head's whole backward (dx, dW, db) in one kernel.
// A CTA owns K2_TH x K2_TW pixels of x, and persistent CTAs walk the
// tiles. With D[q, j] = dacc[q - tap + (ph, pw), o] for j = tap * Cout + o (the
// scaled cotangent, bf16, gathered from a halo of g that the tile scales
// itself by the forward's window count, so `valid` is M' bit for bit):
//   dx[q, c] = M(q, c) * sum_j D[q, j] * W[j, c]      (A = D, B = W)
//   dW[j, c] = sum_q D[q, j] * (x * M)[q, c]          (A = D^T, B = x * M)
// both on `mma.sync`, D^T and x * M read with `ldmatrix.trans`. x is read
// once (staged and re-laid as in the forward, without a halo), g once
// plus its halo, dx written once. Each warp keeps its part of dW in
// registers over all its tiles; the CTA adds its warps' parts in a fixed
// order and writes one partial, and `pconv_colsum` adds the CTAs'
// partials in a fixed order: no atomics, two launches give the same bits.
// The same holds for db. Cin above one block and k * k * Cout above 32 run
// as further passes over the tiles (correct, not fast; the head has one).

constexpr int K2_TH = 8;               // tile rows
constexpr int K2_TW = 16;              // tile columns: one m16 row tile per tile row
constexpr int K2_PIX = K2_TH * K2_TW;  // pixels per tile
constexpr int K2_THREADS = 256;        // 8 warps, one per tile row
constexpr int K2_NPAD = 8;             // Cout padded to the mma's N
constexpr int K2_CB_MAX = 80;          // most channels per block, a multiple of 16
constexpr int K2_OPAD = 8;             // operand row padding, elements
constexpr int K2_JB = 32;              // dW rows (tap, o) per pass: two m16 tiles

__host__ __device__ constexpr int k2_align16(int bytes) { return (bytes + 15) / 16 * 16; }
// bytes of a pixel's slot: cb channels and up to 14 bytes before the first;
// also an operand row's, (cb + K2_OPAD) * 2
__host__ __device__ constexpr int k2_raw_slot(int cb) { return k2_align16(cb * 2 + 14); }

struct K2Smem {
  int raw, op, ws, d, da, mreg, joff, gpix, mk, scale, ys, total;
};

// The forward's dynamic shared memory: byte offsets of its parts.
__host__ __device__ inline K2Smem k2_fwd_smem(int k, int cb) {
  const int npx = (K2_TH + k - 1) * (K2_TW + k - 1);
  K2Smem s = {};
  int o = 0;
  s.raw = o;                                                    // staged slices, re-laid in
  s.op = o;    o += npx * k2_raw_slot(cb);                      // place into the operand rows
  s.ws = o;    o += k * k * K2_NPAD * (cb + K2_OPAD) * 2;       // the block's weights
  s.gpix = o;  o += k2_align16(npx * 4);                        // x's pixel index, -1 outside
  s.mk = o;    o += k2_align16(npx * 8);                        // the two mask groups
  s.scale = o; o += K2_PIX * 4;
  s.ys = o;    o += K2_PIX * K2_NPAD * 2;
  s.total = o;
  return s;
}

// The backward's: `raw` and `op` are also the staging of dx and the
// warps' dW parts at the end of a pass.
__host__ __device__ inline K2Smem k2_bwd_smem(int k, int cb, int kj) {
  const int npx = (K2_TH + k - 1) * (K2_TW + k - 1);
  K2Smem s = {};
  int o = 0;
  s.raw = o;  o += K2_PIX * k2_raw_slot(cb);
  s.op = o;   o += K2_PIX * (cb + K2_OPAD) * 2;
  s.d = o;    o += K2_PIX * (kj + K2_OPAD) * 2;                 // D rows
  s.ws = o;   o += cb * (kj + K2_OPAD) * 2;                     // W as (c, j)
  s.da = o;   o += npx * K2_NPAD * 4;                           // dacc over the halo
  s.mreg = o; o += (K2_TH + 2 * k - 2) * (K2_TW + 2 * k - 2) * 8;  // masks, k - 1 around the tile
  s.joff = o; o += k2_align16(kj * 4);
  s.gpix = o; o += K2_PIX * 4;
  s.mk = o;   o += K2_PIX * 8;
  s.total = o;
  return s;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// D(16 x 8, f32) += A(16 x 16, bf16, row) * B(16 x 8, bf16, col). Lane l
// holds A rows l / 4 and + 8, k 2 (l % 4) + {0, 1} and + 8 (a[0..3]: row,
// row + 8, then k + 8); B k 2 (l % 4) + {0, 1} (b0) and + 8 (b1) of column
// l / 4; D rows l / 4 (d[0], d[1]) and + 8 (d[2], d[3]), columns
// 2 (l % 4) + {0, 1}.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x * m as the plain version rounds it; exactly 0 where the mask is 0.
__device__ __forceinline__ __nv_bfloat16 masked(__nv_bfloat16 x, float m) {
  return m != 0.f ? __float2bfloat16(__bfloat162float(x) * m) : __float2bfloat16(0.f);
}
__device__ __forceinline__ float masked(float x, float m) { return m != 0.f ? x * m : 0.f; }

// Element conversions of the kernels that come in bf16 and f32 forms.
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

// window_scan's count for masks of element type T: f32 masks are counted
// the same way, raw per-group counts first, then one weighting.
template <typename T>
__device__ __forceinline__ float window_count(const Params& p, int n, int oh, int ow) {
  if constexpr (sizeof(T) == 2) {
    unsigned bits = 0;
    return window_scan(p, n, oh, ow, bits);
  } else {
    const float* mask = reinterpret_cast<const float*>(p.mask);
    if (p.g > 2)
      return window_sum_groups(mask, p.groups, p.g, p.h, p.w_in, p.k, p.ph, p.pw, n, oh, ow);
    float c0 = 0.f, c1 = 0.f;
    for (int dy = 0; dy < p.k; ++dy) {
      const int ih = oh + dy - p.ph;
      if (ih < 0 || ih >= p.h) continue;
      for (int dx = 0; dx < p.k; ++dx) {
        const int iw = ow + dx - p.pw;
        if (iw < 0 || iw >= p.w_in) continue;
        const float* m = mask + ((size_t)(n * p.h + ih) * p.w_in + iw) * p.g;
        c0 += m[0];
        if (p.g == 2) c1 += m[1];
      }
    }
    return __fadd_rn(__fmul_rn((float)p.size0, c0), __fmul_rn((float)p.size1, c1));
  }
}

// Copies channels [cb0, cb0 + nb) of every listed pixel (s_gpix >= 0) into
// the pixel's slot: 16-byte chunks from the 16-byte boundary at or below
// the slice's first byte (x itself starts on 16 bytes), the last one cut at
// the end of x.
__device__ __forceinline__ void k2_stage(const Params& p, int cb0, int nb, const int* s_gpix,
                                         int npx, uint32_t raw, int raws, int tid) {
  const uint8_t* xb = reinterpret_cast<const uint8_t*>(p.x);
  const int cpp = raws / 16;
  for (int i = tid; i < npx * cpp; i += K2_THREADS) {
    const int hp = i / cpp, j = i - hp * cpp;
    const int gp = s_gpix[hp];
    if (gp < 0) continue;
    const size_t first = ((size_t)gp * p.cin + cb0) * 2;
    const size_t src = (first & ~(size_t)15) + 16 * j;
    if (src >= first + (size_t)nb * 2) continue;
    const size_t left = p.x_bytes - src;
    cp_async16(raw + hp * raws + 16 * j, xb + src, left < 16 ? (int)left : 16);
  }
}

// The staged slices as operand rows: row hp holds x * M_g of the block's
// channels, zero from nb to cb and for a pixel outside the image. cb / 8
// lanes take a pixel (three pixels per warp at the head), one 16-byte chunk
// of its row each: bytes [phase,
// phase + 16) of two aligned 16-byte reads of the slot, the word picked by
// two levels of selects and the 2-byte phase taken out with funnel shifts.
// A chunk in one mask group is four packed bf16 products (x and M are
// bf16, so the packed product rounds as the plain version's f32 product
// does); one that straddles the groups goes element by element. `op` may
// be `raw` (a row and a slot have the same size): every lane of the warp
// has read before any of them writes.
__device__ __forceinline__ void k2_relay(const Params& p, int cb0, int nb, const int* s_gpix,
                                         const float2* s_mk, int npx, const uint8_t* raw,
                                         uint8_t* op, int tid) {
  const int lane = tid & 31, raws = k2_raw_slot(p.cb);
  const int nch = p.cb / 8, ppw = 32 / nch;   // chunks per row, pixels per warp and step
  const int pl = lane / nch, sub = lane - pl * nch;
  const int ch0 = sub * 8;  // this lane's first channel of the block
  for (int h0 = (tid >> 5) * ppw; h0 < npx; h0 += K2_THREADS / 32 * ppw) {
    const int hp = h0 + pl;
    const bool act = pl < ppw && hp < npx;
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    const int gp = act ? s_gpix[hp] : -1;
    if (gp >= 0 && ch0 < nb) {
      const float2 mk = s_mk[hp];
      const int phase = (int)((((size_t)gp * p.cin + cb0) * 2) & 15);
      const uint4* s4 = reinterpret_cast<const uint4*>(raw + hp * raws) + sub;
      const uint4 lo = s4[0], hi = s4[1];
      const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      uint32_t t[6], u[5], v[4];
#pragma unroll
      for (int e = 0; e < 6; ++e) t[e] = (phase & 8) ? w[e + 2] : w[e];
#pragma unroll
      for (int e = 0; e < 5; ++e) u[e] = (phase & 4) ? t[e + 1] : t[e];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = __funnelshift_r(u[e], u[e + 1], (phase & 2) * 8);
      uint32_t r[4];
      const int first = cb0 + ch0;
      if (first + 8 <= p.size0 || first >= p.size0) {
        const float m = first < p.size0 ? mk.x : mk.y;
        const __nv_bfloat162 mm = __float2bfloat162_rn(m);
        const uint32_t keep = m != 0.f ? 0xffffffffu : 0u;  // exactly 0 under a hole
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 pr = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&v[e]), mm);
          const int ch = ch0 + 2 * e;
          const uint32_t in = ch + 1 < nb ? 0xffffffffu : ch < nb ? 0x0000ffffu : 0u;
          r[e] = *reinterpret_cast<const uint32_t*>(&pr) & keep & in;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ch = ch0 + 2 * e;
          const float m0 = cb0 + ch < p.size0 ? mk.x : mk.y, m1 = cb0 + ch + 1 < p.size0 ? mk.x : mk.y;
          const float f0 = __uint_as_float(v[e] << 16), f1 = __uint_as_float(v[e] & 0xffff0000u);
          const __nv_bfloat16 zero = __float2bfloat16(0.f);
          const __nv_bfloat16 r0 = (ch < nb && m0 != 0.f) ? __float2bfloat16(f0 * m0) : zero;
          const __nv_bfloat16 r1 = (ch + 1 < nb && m1 != 0.f) ? __float2bfloat16(f1 * m1) : zero;
          r[e] = (uint32_t)__bfloat16_as_ushort(r0) | ((uint32_t)__bfloat16_as_ushort(r1) << 16);
        }
      }
      out = make_uint4(r[0], r[1], r[2], r[3]);
    }
    __syncwarp();
    if (act) *reinterpret_cast<uint4*>(op + hp * raws + sub * 16) = out;
  }
}

// NKB: k16 steps of a channel block, cb = 16 NKB.
template <int NKB>
__global__ void __launch_bounds__(K2_THREADS, 3) pconv_k2(const Params p) {
  extern __shared__ __align__(16) uint8_t k2_smem[];
  constexpr int cb = 16 * NKB;
  const int k = p.k, taps = k * k;
  const int hw = K2_TW + k - 1, npx = (K2_TH + k - 1) * hw;
  constexpr int pitch = cb + K2_OPAD, raws = k2_raw_slot(cb);
  const K2Smem L = k2_fwd_smem(k, cb);
  uint8_t* raw = k2_smem + L.raw;  // and the operand rows, after `k2_relay`
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(k2_smem + L.ws);
  int* s_gpix = reinterpret_cast<int*>(k2_smem + L.gpix);
  float2* s_mk = reinterpret_cast<float2*>(k2_smem + L.mk);
  float* s_scale = reinterpret_cast<float*>(k2_smem + L.scale);
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(k2_smem + L.ys);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.z, oh0 = blockIdx.y * K2_TH, ow0 = blockIdx.x * K2_TW;

  // the halo's pixels and masks (0 outside the image)
  for (int i = tid; i < npx; i += K2_THREADS) {
    const int hr = i / hw, hc = i - hr * hw;
    const int ih = oh0 - p.ph + hr, iw = ow0 - p.pw + hc;
    int gp = -1;
    float2 mk = make_float2(0.f, 0.f);
    if (ih >= 0 && ih < p.h && iw >= 0 && iw < p.w_in) {
      gp = (n * p.h + ih) * p.w_in + iw;
      const __nv_bfloat16* m = p.mask + (size_t)gp * p.g;
      mk.x = __bfloat162float(m[0]);
      if (p.g == 2) mk.y = __bfloat162float(m[1]);
    }
    s_gpix[i] = gp;
    s_mk[i] = mk;
  }
  __syncthreads();
  if (tid < K2_PIX) {
    // raw per-group tap counts, weighted once by the group sizes
    const int r = tid / K2_TW, c = tid % K2_TW;
    float c0 = 0.f, c1 = 0.f;
    for (int dy = 0; dy < k; ++dy)
      for (int dx = 0; dx < k; ++dx) {
        const float2 mk = s_mk[(r + dy) * hw + c + dx];
        c0 += mk.x;
        c1 += mk.y;
      }
    const float msum = __fadd_rn(__fmul_rn((float)p.size0, c0), __fmul_rn((float)p.size1, c1));
    const bool valid = msum > 0.f;
    s_scale[tid] = valid ? (float)(taps * p.cin) / fmaxf(msum, 1.f) : -1.f;
    const int oh = oh0 + r, ow = ow0 + c;
    if (oh < p.hout && ow < p.wout)
      p.mask_out[((size_t)n * p.hout + oh) * p.wout + ow] = __float2bfloat16(valid ? 1.f : 0.f);
  }

  // two accumulators, so that consecutive products do not wait on each other
  float acc0[4] = {0.f, 0.f, 0.f, 0.f}, acc1[4] = {0.f, 0.f, 0.f, 0.f};
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lcol = (lane >> 4) * 8;
  const uint32_t op_u = smem_u32(raw), ws_u = smem_u32(ws);
  const uint32_t* ws32 = reinterpret_cast<const uint32_t*>(ws);
  constexpr int pw = pitch / 2, wch = cb / 8;
  for (int b = 0; b < p.nblk; ++b) {
    const int cb0 = b * cb, nb = min(cb, p.cin - cb0);
    k2_stage(p, cb0, nb, s_gpix, npx, smem_u32(raw), raws, tid);
    const __nv_bfloat16* wsrc = p.w + (size_t)b * taps * K2_NPAD * cb;
    for (int i = tid; i < taps * K2_NPAD * wch; i += K2_THREADS) {
      const int row = i / wch, j = i - row * wch;
      cp_async16(ws_u + (row * pitch + j * 8) * 2, wsrc + row * cb + j * 8, 16);
    }
    cp_async_wait_all();
    __syncthreads();
    k2_relay(p, cb0, nb, s_gpix, s_mk, npx, raw, raw, tid);
    __syncthreads();
    for (int dy = 0; dy < k; ++dy)
      for (int dx = 0; dx < k; ++dx) {
        const uint32_t a0 = op_u + (((warp + dy) * hw + dx + lrow) * pitch + lcol) * 2;
        const uint32_t* wt = ws32 + ((dy * k + dx) * K2_NPAD + (lane >> 2)) * pw + (lane & 3);
        uint32_t a[NKB][4];
#pragma unroll
        for (int kb = 0; kb < NKB; ++kb) ldmatrix_x4(a[kb], a0 + kb * 32);
#pragma unroll
        for (int kb = 0; kb < NKB; ++kb) {
          if (kb & 1)
            mma_bf16(acc1, a[kb], wt[kb * 8], wt[kb * 8 + 4]);
          else
            mma_bf16(acc0, a[kb], wt[kb * 8], wt[kb * 8 + 4]);
        }
      }
    __syncthreads();  // the next block overwrites the slots, the rows and the weights
  }

  // epilogue into the tile's y rows, then whole rows to y
  const int o0 = (lane & 3) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = warp * K2_TW + (lane >> 2) + 8 * h;
    const float scale = s_scale[q];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int o = o0 + e;
      if (o < p.cout)
        ys[q * p.cout + o] = __float2bfloat16(
            epilogue(acc0[2 * h + e] + acc1[2 * h + e], scale, p.bias ? p.bias[o] : 0.f));
    }
  }
  __syncthreads();
  const int oh = oh0 + warp;
  if (oh >= p.hout || ow0 >= p.wout) return;
  const int ne = min(K2_TW, p.wout - ow0) * p.cout;  // the row's elements
  __nv_bfloat16* dst = p.y + ((size_t)(n * p.hout + oh) * p.wout + ow0) * p.cout;
  const __nv_bfloat16* src = ys + warp * K2_TW * p.cout;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0 && ne % 8 == 0 &&
      (warp * K2_TW * p.cout) % 8 == 0) {
    for (int i = lane; i < ne / 8; i += 32)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  } else {
    for (int i = lane; i < ne; i += 32) dst[i] = src[i];
  }
}

template <int NKB>
cudaError_t launch_k2(const Params& p, cudaStream_t stream) {
  const int smem = k2_fwd_smem(p.k, p.cb).total;
  cudaError_t e =
      cudaFuncSetAttribute(pconv_k2<NKB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((p.wout + K2_TW - 1) / K2_TW), (unsigned)((p.hout + K2_TH - 1) / K2_TH),
                  (unsigned)p.n);
  pconv_k2<NKB><<<grid, K2_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// The head's backward. Persistent: CTA b takes tiles b, b + grid, ... of
// the (max(H, Hout), max(W, Wout)) plane of each image; pass (cbi, jb)
// covers channel block cbi and dW rows [32 jb, 32 jb + 32). dx comes from
// the passes with jb = 0, db from the first pass.
__global__ void __launch_bounds__(K2_THREADS, 2) pconv_k2_bwd(const Params p) {
  extern __shared__ __align__(16) uint8_t k2_smem[];
  const int k = p.k, cb = p.cb, kj = p.kj, co = p.cout;
  const int hw = K2_TW + k - 1, npxh = (K2_TH + k - 1) * hw;
  const int pitch = cb + K2_OPAD, dpitch = kj + K2_OPAD, raws = k2_raw_slot(cb);
  const K2Smem L = k2_bwd_smem(k, cb, kj);
  uint8_t* raw = k2_smem + L.raw;
  __nv_bfloat16* op = reinterpret_cast<__nv_bfloat16*>(k2_smem + L.op);
  __nv_bfloat16* sd = reinterpret_cast<__nv_bfloat16*>(k2_smem + L.d);
  __nv_bfloat16* wd = reinterpret_cast<__nv_bfloat16*>(k2_smem + L.ws);
  float* s_da = reinterpret_cast<float*>(k2_smem + L.da);
  float2* s_mreg = reinterpret_cast<float2*>(k2_smem + L.mreg);
  int* s_joff = reinterpret_cast<int*>(k2_smem + L.joff);
  int* s_gpix = reinterpret_cast<int*>(k2_smem + L.gpix);
  float2* s_mk = reinterpret_cast<float2*>(k2_smem + L.mk);
  __nv_bfloat16* dxs = reinterpret_cast<__nv_bfloat16*>(raw);  // dx of the tile, (pixel, nb)
  float* red = reinterpret_cast<float*>(raw);                  // the warps' dW parts, db

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hh = max(p.h, p.hout), ww = max(p.w_in, p.wout);
  const int tx_n = (ww + K2_TW - 1) / K2_TW, ty_n = (hh + K2_TH - 1) / K2_TH;
  const int tiles = p.n * ty_n * tx_n;
  const int cw = p.nblk * cb;                       // columns of a dW partial
  float* part = p.partial + (size_t)blockIdx.x * ((size_t)kj * cw + K2_NPAD);
  const float kkc = (float)(k * k * p.cin);
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lcol = (lane >> 4) * 8;
  const uint32_t sd_u = smem_u32(sd), op_u = smem_u32(op);
  const uint32_t* wd32 = reinterpret_cast<const uint32_t*>(wd);
  const int dpw = dpitch / 2, nkk = kj / 16;
  const int mw = K2_TW + 2 * k - 2, mreg_n = (K2_TH + 2 * k - 2) * mw, jn = k * k * co;

  // j = tap * Cout + o reads dacc of the halo pixel (k - 1 - dy, k - 1 - dx)
  // past the tile pixel's own: its offset in s_da, -1 in the padding of j
  for (int j = tid; j < kj; j += K2_THREADS) {
    int off = -1;
    if (j < jn) {
      const int tap = j / co, o = j - tap * co, dy = tap / k, dx = tap - dy * k;
      off = ((k - 1 - dy) * hw + (k - 1 - dx)) * K2_NPAD + o;
    }
    s_joff[j] = off;
  }
  // the padding of j in the D rows stays 0 over all tiles
  for (int i = tid; i < K2_PIX * (kj - jn); i += K2_THREADS)
    sd[(i / (kj - jn)) * dpitch + jn + i % (kj - jn)] = __float2bfloat16(0.f);
  float db[K2_NPAD];
#pragma unroll
  for (int o = 0; o < K2_NPAD; ++o) db[o] = 0.f;

  const int njb = (kj + K2_JB - 1) / K2_JB;
  for (int pass = 0; pass < p.nblk * njb; ++pass) {
    const int cbi = pass / njb, jb = pass - cbi * njb;
    const int cb0 = cbi * cb, nb = min(cb, p.cin - cb0);
    const bool do_dx = p.need_dx && jb == 0, do_db = p.need_db && pass == 0;
    __syncthreads();  // the last pass has been written out
    // W of this channel block as (c, j) rows
    {
      const __nv_bfloat16* wsrc = p.w + (size_t)cb0 * kj;
      const int wch = kj / 8;
      for (int i = tid; i < cb * wch; i += K2_THREADS) {
        const int row = i / wch, j = i - row * wch;
        cp_async16(smem_u32(wd) + (row * dpitch + j * 8) * 2, wsrc + (size_t)row * kj + j * 8, 16);
      }
    }
    float accw[K2_CB_MAX / 8][4];
#pragma unroll
    for (int i = 0; i < K2_CB_MAX / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) accw[i][e] = 0.f;
    const int mt = warp & 1, pg = warp >> 1;   // this warp's dW row tile and pixel rows pg, pg + 4
    const int j0 = jb * K2_JB + mt * 16;

    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int tx = tile % tx_n, ty = (tile / tx_n) % ty_n, n = tile / (tx_n * ty_n);
      const int ih0 = ty * K2_TH, iw0 = tx * K2_TW;
      __syncthreads();  // the last tile's buffers are free
      if (tid < K2_PIX) {
        const int ih = ih0 + tid / K2_TW, iw = iw0 + tid % K2_TW;
        int gp = -1;
        float2 mk = make_float2(0.f, 0.f);
        if (ih < p.h && iw < p.w_in) {
          gp = (n * p.h + ih) * p.w_in + iw;
          const __nv_bfloat16* m = p.mask + (size_t)gp * p.g;
          mk.x = __bfloat162float(m[0]);
          if (p.g == 2) mk.y = __bfloat162float(m[1]);
        }
        s_gpix[tid] = gp;
        s_mk[tid] = mk;
      }
      // the masks of the tile and k - 1 pixels around it: every window of
      // the halo's output pixels (0 outside the image)
      for (int i = tid; i < mreg_n; i += K2_THREADS) {
        const int mr = i / mw, mc = i - mr * mw;
        const int ih = ih0 - (k - 1) + mr, iw = iw0 - (k - 1) + mc;
        float2 mk = make_float2(0.f, 0.f);
        if (ih >= 0 && ih < p.h && iw >= 0 && iw < p.w_in) {
          const __nv_bfloat16* m = mask_at(p, n, ih, iw);
          mk.x = __bfloat162float(m[0]);
          if (p.g == 2) mk.y = __bfloat162float(m[1]);
        }
        s_mreg[i] = mk;
      }
      __syncthreads();
      // dacc over the halo of output pixels: the tile's own and k - 1 before
      for (int i = tid; i < npxh; i += K2_THREADS) {
        const int hr = i / hw, hc = i - hr * hw;
        const int oh = ih0 + p.ph - (k - 1) + hr, ow = iw0 + p.pw - (k - 1) + hc;
        float da[K2_NPAD];
#pragma unroll
        for (int o = 0; o < K2_NPAD; ++o) da[o] = 0.f;
        if (oh >= 0 && oh < p.hout && ow >= 0 && ow < p.wout) {
          // raw per-group tap counts, weighted once by the group sizes: tap
          // (dy, dx) of this pixel's window is (hr + dy, hc + dx) of the masks
          float c0 = 0.f, c1 = 0.f;
          for (int dy = 0; dy < k; ++dy)
            for (int dx = 0; dx < k; ++dx) {
              const float2 mk = s_mreg[(hr + dy) * mw + hc + dx];
              c0 += mk.x;
              c1 += mk.y;
            }
          const float msum =
              __fadd_rn(__fmul_rn((float)p.size0, c0), __fmul_rn((float)p.size1, c1));
          const bool valid = msum > 0.f;
          const float scale = valid ? kkc / fmaxf(msum, 1.f) : 0.f;
          const __nv_bfloat16* g = p.gout + ((size_t)(n * p.hout + oh) * p.wout + ow) * co;
          const bool own = do_db && valid && oh >= ih0 && oh < ih0 + K2_TH && ow >= iw0 &&
                           ow < iw0 + K2_TW;
#pragma unroll
          for (int o = 0; o < K2_NPAD; ++o)
            if (o < co) {
              const float gv = __bfloat162float(g[o]);
              if (valid) da[o] = __bfloat162float(__float2bfloat16(gv * scale));
              if (own) db[o] += gv;
            }
        }
#pragma unroll
        for (int o = 0; o < K2_NPAD; ++o) s_da[i * K2_NPAD + o] = da[o];
      }
      __syncthreads();
      k2_stage(p, cb0, nb, s_gpix, K2_PIX, smem_u32(raw), raws, tid);
      // D rows, while the copies fly
#pragma unroll 4
      for (int i = tid; i < K2_PIX * jn; i += K2_THREADS) {
        const int q = i / jn, j = i - q * jn;
        sd[q * dpitch + j] = __float2bfloat16(
            s_da[((q / K2_TW) * hw + q % K2_TW) * K2_NPAD + s_joff[j]]);
      }
      cp_async_wait_all();
      __syncthreads();
      k2_relay(p, cb0, nb, s_gpix, s_mk, K2_PIX, raw, reinterpret_cast<uint8_t*>(op), tid);
      __syncthreads();  // the slots are free: dx is staged over them

      if (do_dx) {
        // warp = tile row: dx[q, c] = M * sum_j D[q, j] W[j, c], 16 channels
        // (two independent chains of products) at a time
        const uint32_t a0 = sd_u + ((warp * K2_TW + lrow) * dpitch + lcol) * 2;
        const float2 mkq[2] = {s_mk[warp * K2_TW + (lane >> 2)],
                               s_mk[warp * K2_TW + (lane >> 2) + 8]};
        for (int nt = 0; nt < cb / 8; nt += 2) {
          float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          const uint32_t* wt = wd32 + (nt * 8 + (lane >> 2)) * dpw + (lane & 3);
          for (int kk = 0; kk < nkk; ++kk) {
            uint32_t a[4];
            ldmatrix_x4(a, a0 + kk * 32);
            mma_bf16(acc[0], a, wt[kk * 8], wt[kk * 8 + 4]);
            mma_bf16(acc[1], a, wt[8 * dpw + kk * 8], wt[8 * dpw + kk * 8 + 4]);
          }
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int q = warp * K2_TW + (lane >> 2) + 8 * h;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int ch = (nt + t) * 8 + (lane & 3) * 2 + e;
                if (ch < nb)
                  dxs[q * nb + ch] = masked(__float2bfloat16(acc[t][2 * h + e]),
                                            cb0 + ch < p.size0 ? mkq[h].x : mkq[h].y);
              }
            }
        }
      }
      if (p.need_dw && j0 < kj) {
        // dW[j, c] += sum_q D[q, j] (x * M)[q, c] over tile rows pg and pg + 4
        const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int q0 = (pg + 4 * s) * K2_TW;
          uint32_t a[4];
          ldmatrix_x4_trans(a, sd_u + ((q0 + rr + (mi >= 2 ? 8 : 0)) * dpitch + j0 +
                                       ((mi & 1) ? 8 : 0)) * 2);
          const uint32_t b0 = op_u + ((q0 + rr + ((mi & 1) ? 8 : 0)) * pitch + (mi >= 2 ? 8 : 0)) * 2;
#pragma unroll
          for (int np = 0; np < K2_CB_MAX / 16; ++np)
            if (np * 16 < cb) {
              uint32_t bb[4];
              ldmatrix_x4_trans(bb, b0 + np * 32);
              mma_bf16(accw[2 * np], a, bb[0], bb[1]);
              mma_bf16(accw[2 * np + 1], a, bb[2], bb[3]);
            }
        }
      }
      __syncthreads();
      if (do_dx) {
        // the tile's dx rows to device memory: this block's channels of each pixel
        if (nb == p.cin) {
          const int ih = ih0 + warp;
          if (ih < p.h && iw0 < p.w_in) {
            const int ne = min(K2_TW, p.w_in - iw0) * nb;
            const size_t first = ((size_t)(n * p.h + ih) * p.w_in + iw0) * nb;
            __nv_bfloat16* dst = p.dx + first;
            const __nv_bfloat16* src = dxs + warp * K2_TW * nb;
            if ((first & 1) == 0 && (ne & 1) == 0 && ((warp * K2_TW * nb) & 1) == 0) {
              for (int i = lane; i < ne / 2; i += 32)
                reinterpret_cast<uint32_t*>(dst)[i] = reinterpret_cast<const uint32_t*>(src)[i];
            } else {
              for (int i = lane; i < ne; i += 32) dst[i] = src[i];
            }
          }
        } else {
          for (int q = warp; q < K2_PIX; q += K2_THREADS / 32) {
            const int gp = s_gpix[q];
            if (gp < 0) continue;
            for (int ch = lane; ch < nb; ch += 32)
              p.dx[(size_t)gp * p.cin + cb0 + ch] = dxs[q * nb + ch];
          }
        }
      }
    }

    // this pass's dW: the four pixel groups' parts added in order
    __syncthreads();
    if (p.need_dw) {
      if (j0 < kj) {
#pragma unroll
        for (int nt = 0; nt < K2_CB_MAX / 8; ++nt)
          if (nt * 8 < cb) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = mt * 16 + (lane >> 2) + (e >= 2 ? 8 : 0);
              const int col = nt * 8 + (lane & 3) * 2 + (e & 1);
              red[(pg * K2_JB + row) * cb + col] = accw[nt][e];
            }
          }
      }
      __syncthreads();
      for (int row = warp; row < K2_JB; row += K2_THREADS / 32) {
        const int j = jb * K2_JB + row;
        if (j >= kj) break;
        for (int col = lane; col < cb; col += 32) {
          float s = red[row * cb + col];
          for (int g = 1; g < 4; ++g) s += red[(g * K2_JB + row) * cb + col];
          part[(size_t)j * cw + cb0 + col] = s;
        }
      }
    }
    if (do_db) {
      __syncthreads();
#pragma unroll
      for (int o = 0; o < K2_NPAD; ++o) red[tid * K2_NPAD + o] = db[o];
      __syncthreads();
      if (tid < K2_NPAD) {
        float s = 0.f;
        for (int t = 0; t < K2_THREADS; ++t) s += red[t * K2_NPAD + tid];
        part[(size_t)kj * cw + tid] = s;
      }
    }
  }
}

cudaError_t launch_k2_bwd(const Params& p, int grid, cudaStream_t stream) {
  const int smem = k2_bwd_smem(p.k, p.cb, p.kj).total;
  cudaError_t e =
      cudaFuncSetAttribute(pconv_k2_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  pconv_k2_bwd<<<grid, K2_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- K3 ----
//
// K3 is the backward of K1/K2, the counterpart of the custom VJP `_bwd`
// (partial_conv_kernel.py): dacc = bf16(g * scale), dx = conv_transpose(dacc,
// W) * M, dW = corr(x * M, dacc), db = sum g * valid. At the K1 layers the
// two large products are library calls, as JAX leaves them to XLA; what
// surrounds them is these kernels, each one pass over its tensor, bound by
// bytes. `pconv_k3_prep` counts each output pixel's window with
// `window_scan` (the forward's arithmetic, so `valid` is M' bit for bit),
// writes dacc channels-last as the products read it and sums db per CTA;
// `pconv_k3_mask` multiplies a channels-last tensor by its pixels' group
// masks (x for the dW product; dx in place on the product's output);
// `pconv_colsum` adds per-CTA partials in a fixed order. At Cout <= 7 the
// whole backward is `pconv_k2_bwd` above.

constexpr int K3_THREADS = 256;
constexpr int K3_PIX = 128;  // pixels per tile of pconv_k3_prep

// T the element type (bf16, or f32 for the f32 form); VEC channels per
// thread and access: 16 bytes' worth where Cout is a multiple of it, else 1.
template <typename T, int VEC>
__global__ void __launch_bounds__(K3_THREADS) pconv_k3_prep(const Params p) {
  __shared__ float s_scale[K3_PIX];
  __shared__ float s_red[K3_THREADS * VEC];
  const T* gout = reinterpret_cast<const T*>(p.gout);
  T* dacc = reinterpret_cast<T*>(p.y);
  const int tid = threadIdx.x;
  const long long P = (long long)p.n * p.hout * p.wout;
  const long long tiles = (P + K3_PIX - 1) / K3_PIX;
  const int cpp = p.cout / VEC;                               // chunks per pixel
  const int cw = cpp < K3_THREADS ? cpp : K3_THREADS;         // chunks taken at once
  const int lanes = K3_THREADS / cw;                          // pixels taken at once
  const int pl0 = tid / cw, ci = tid - pl0 * cw;
  const float kkc = (float)(p.k * p.k * p.cin);
  for (int cbk = 0; cbk < cpp; cbk += cw) {
    const int c = cbk + ci;
    const bool act = pl0 < lanes && c < cpp;
    float db[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) db[e] = 0.f;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      __syncthreads();
      if (tid < K3_PIX) {
        const long long pix = tile * K3_PIX + tid;
        float scale = 0.f;  // 0 marks an empty window
        if (pix < P) {
          const int ow = (int)(pix % p.wout);
          const long long t = pix / p.wout;
          const float msum = window_count<T>(p, (int)(t / p.hout), (int)(t % p.hout), ow);
          if (msum > 0.f) scale = kkc / fmaxf(msum, 1.f);
        }
        s_scale[tid] = scale;
      }
      __syncthreads();
      if (!act) continue;
      for (int pl = pl0; pl < K3_PIX; pl += lanes) {
        const long long pix = tile * K3_PIX + pl;
        if (pix >= P) break;
        const float scale = s_scale[pl];
        const size_t at = (size_t)pix * p.cout + (size_t)c * VEC;
        if constexpr (VEC > 1) {
          const uint4 v = *reinterpret_cast<const uint4*>(gout + at);
          const T* gv = reinterpret_cast<const T*>(&v);
          uint4 out;
          T* ov = reinterpret_cast<T*>(&out);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float f = to_f32(gv[e]);
            ov[e] = from_f32<T>(scale > 0.f ? f * scale : 0.f);
            if (scale > 0.f) db[e] += f;
          }
          *reinterpret_cast<uint4*>(dacc + at) = out;
        } else {
          const float f = to_f32(gout[at]);
          dacc[at] = from_f32<T>(scale > 0.f ? f * scale : 0.f);
          if (scale > 0.f) db[0] += f;
        }
      }
    }
    if (p.need_db) {
      // the CTA's db: its pixel lanes' sums added in order
      __syncthreads();
#pragma unroll
      for (int e = 0; e < VEC; ++e) s_red[tid * VEC + e] = db[e];
      __syncthreads();
      if (tid < cw && cbk + tid < cpp) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float s = 0.f;
          for (int l = 0; l < lanes; ++l) s += s_red[(l * cw + tid) * VEC + e];
          p.partial[(size_t)blockIdx.x * p.cout + (size_t)(cbk + tid) * VEC + e] = s;
        }
      }
    }
  }
}

// out = x * M, the group picked by the channel: P pixels of C channels.
// In place when out == x.
template <typename T, int VEC>
__global__ void __launch_bounds__(K3_THREADS) pconv_k3_mask(const T* x, const T* mask, T* out,
                                                            unsigned items, int c, int g,
                                                            int size0, const int* groups) {
  const unsigned cpp = (unsigned)(c / VEC);
  for (unsigned i = blockIdx.x * K3_THREADS + threadIdx.x; i < items;
       i += gridDim.x * K3_THREADS) {
    const unsigned pix = i / cpp;
    const int ch = (int)(i - pix * cpp) * VEC;
    const float m0 = to_f32(mask[(size_t)pix * g]);
    const float m1 = g == 2 ? to_f32(mask[(size_t)pix * g + 1]) : m0;
    const size_t at = (size_t)pix * c + ch;
    if constexpr (VEC > 1) {
      uint4 v = *reinterpret_cast<const uint4*>(x + at);
      T* e = reinterpret_cast<T*>(&v);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        e[j] = masked(e[j], g > 2 ? to_f32(mask[(size_t)pix * g + group_of(groups + g, g, ch + j)])
                                  : ch + j < size0 ? m0 : m1);
      *reinterpret_cast<uint4*>(out + at) = v;
    } else {
      out[at] = masked(x[at], g > 2 ? to_f32(mask[(size_t)pix * g + group_of(groups + g, g, ch)])
                                    : ch < size0 ? m0 : m1);
    }
  }
}

// ------------------------------------------------------- the f32 form ----
//
// K1 and K2 in f32, for x.dtype float32 (JAX's Pallas kernels take x's
// dtype as it comes, with f32 accumulators): SIMT FFMA with f32
// accumulation, no TF32 and no bf16 anywhere. K1F (Cout >= 8) is
// `pconv_k1f` below; K2F (Cout <= 7) and its backward are here.
//
// K2F v2, `pconv_k2f<COUT, K>` (v1, `pconv_f32<1, 1>`, padded Cout to 8,
// gathered 8-channel chunks of the window element by element between two
// barriers and gave a thread one pixel). It replaces `_kernel_small_cout` /
// `_pallas_forward_small_cout` (partial_conv_kernel.py) for an f32 x. At
// the U-Net's head (8 x 512^2 x 67 -> 3) reading x bounds it: 562 MB, 0.17
// ms at 3.35 TB/s, against 0.11 ms for its 3.8 G FFMA at the f32 peak.
//   - A CTA of 256 threads owns a strip of K2F_TW = 96 output columns of
//     one image over a band of `rb` output rows (`k2f_plan` picks the band
//     so that the grid fills whole waves of K2F_CTAS CTAs an SM). It walks
//     the band's rb + k - 1 input rows through a ring of K2F_RING shared
//     stages. A stage holds the strip's input row as x lays it out, whole
//     pixels of all Cin channels, and its pixels' masks (`k2f_fill`): a
//     67-channel pixel is 268 bytes, only 4-byte aligned, so the row is
//     copied in 16-byte `cp.async` words of x from the one that holds its
//     first byte, cutting pixels anywhere, and keeps a phase of 0..3
//     floats in front. Two rows' copies are in flight while a row's sums
//     run.
//   - Lane l owns output pixels 3l .. 3l + 2 of the strip and all COUT
//     outputs of each; warp w owns input channels [Cin w / 8, Cin (w + 1) /
//     8). Per input channel a thread reads its k + 2 window pixels (lanes
//     3 Cin floats apart, odd at Cin 67: no bank conflict), multiplies
//     each by its group's mask as it leaves shared memory (`masked`: 0 in
//     a hole, whatever x holds there), and adds it into every output row
//     the input row reaches: 9 k^2 COUT FFMA from registers per k + 2
//     shared reads and the channel's k^2 COUT weights (float4 broadcasts).
//   - Once an output row has seen its last input row, the warps' sums meet
//     in shared memory and are added in warp order; the epilogue is the
//     bf16 kernels' (k*k*Cin / max(msum, 1), the bias, 0 in empty windows,
//     M'), stored as one contiguous run of y. msum is `window_count`'s sum
//     in its order, taken from a shared ring of the last k input rows'
//     masks (a count from device memory, 18 dependent loads a pixel,
//     stalled every row's barrier). Each sum runs over the input rows,
//     then the warp's channels, then the row's taps, in order: two
//     launches give the same bits.
//   - `pconv_f32_relay` re-lays W (OIHW) as (k*k, Cin, Cout) in the
//     launch (`f32_weight_relayout` in ops/kernels/partial_conv.py is its
//     plain version); each CTA stages it as (Cin, k*k*COUT padded to 4).
//
// Its backward, `pconv_k2f_bwd<COUT, K>`, after `pconv_k3_prep` has
// written dacc = g * scale * valid and db: dx = conv_transpose(dacc, W) *
// M and dW = corr(x * M, dacc) in one pass over the input (v1 was two
// kernels: one whose lanes stored pixels 268 bytes apart, one with 8
// accumulators for 3 outputs that re-staged x * M element by element). It
// reads x (562 MB at the head) and writes dx (562 MB): bytes bound it
// (0.35 ms with dacc and the mask; its 7.6 G FFMA take 0.23 ms).
//   - A CTA owns a strip of nseg * 32 input columns of one image over a
//     band of `rb` input rows; thread t owns input channel t % Cin of a
//     segment of 32 columns (t / Cin), so a warp's lanes are consecutive
//     channels of one pixel: their x reads are consecutive words and their
//     dx stores one contiguous run. The x rows come through the forward's
//     stages (`k2f_fill`, no halo: x is only read where dx is written), the
//     dacc rows (k - 1 more, with a halo of k - 1 columns, COUT padded to
//     4 a column) through a ring of their own.
//   - A thread keeps its channel's k^2 COUT weights and k^2 COUT dW sums
//     in registers, and slides a k x k x COUT window of dacc along its
//     segment: per pixel k new columns (float4 broadcasts, shared by the
//     warp), one x and one mask read, then k^2 COUT FFMA for dx (k blocked
//     chains, one a window row, added in order) and k^2 COUT for dW.
//   - dW: each thread's sums run over the band's rows, then its segment's
//     pixels, in order; the segments meet in shared memory, added in order,
//     as CTA b's row of f32 partials, which `pconv_colsum` adds in a fixed
//     order: two launches give the same bits. `pconv_f32_relay` re-lays W
//     as (k*k, Cout, Cin) in the launch.
//
// Both are built for COUT 1..7; K2F for k 1, 3, 5, 7 (`K2F_KS` in
// ops/kernels/partial_conv.py), its backward for k 1 and 3 (`K2F_BWD_KS`):
// from k 5 the general backward is the faster (2.3x at k 5, 13x at k 7 at
// the head's 67 -> 3 on 8 pages of 512^2, tools/gen_forms.py).

constexpr int K2F_R = 3;             // output pixels a thread owns along a row
constexpr int K2F_THREADS = 256;     // 8 warps, each a slice of the input channels
constexpr int K2F_TW = 32 * K2F_R;   // output columns of a strip
constexpr int K2F_RING = 3;          // input rows in the ring
constexpr int K2F_CTAS = 2;          // resident CTAs an SM
constexpr int HB_SEG = 32;           // input columns of a backward thread's segment
constexpr int HB_NSEG = 8;           // most segments of a backward strip
constexpr int HB_THREADS = 256;      // most threads of a backward CTA
constexpr int HB_RING = 3;           // x rows in the backward's ring

// Floats of the x part of a stage of `pixels` pixels: a phase of up to 3
// floats in front, the last 16-byte copy up to 3 floats past.
__host__ __device__ inline int k2f_row_floats(int pixels, int cin) {
  return (pixels * cin + 6 + 3) / 4 * 4;
}
// Floats of a stage: the x row, then 2 mask floats a pixel.
__host__ __device__ inline int k2f_stage_floats(int pixels, int cin) {
  return (k2f_row_floats(pixels, cin) + 2 * pixels + 3) / 4 * 4;
}
inline size_t k2f_smem_bytes(int cin, int cout, int k) {
  const int wpc = (k * k * cout + 3) / 4 * 4;
  return (size_t)(K2F_RING * k2f_stage_floats(K2F_TW + k - 1, cin) + cin * wpc +
                  8 * K2F_TW * cout + 2 * k * (K2F_TW + k - 1)) * 4;
}
// The ring (x rows and masks; HB_RING + k - 1 dacc rows) or, once the band
// is done, the segments' dW sums, whichever is larger.
inline size_t k2f_bwd_smem_bytes(int cin, int cout, int k, int nseg) {
  const int tw = nseg * HB_SEG;
  const size_t ring = (size_t)HB_RING * k2f_stage_floats(tw, cin) +
                      (size_t)(HB_RING + k - 1) * (tw + k - 1) * ((cout + 3) / 4 * 4);
  const size_t red = (size_t)nseg * k * k * cout * cin;
  return (ring > red ? ring : red) * 4;
}

// W (Cout, Cin, k, k) -> K2F's (k*k, Cin, Cout) (bwd 0) or the backward's
// (k*k, Cout, Cin) (bwd 1).
__global__ void pconv_f32_relay(const float* __restrict__ w, float* __restrict__ out, int cout,
                                int cin, int kk, int bwd) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cout * cin * kk) return;
  const int tap = i % kk, r = i / kk, c = r % cin, o = r / cin;
  out[bwd ? ((size_t)tap * cout + o) * cin + c : ((size_t)tap * cin + c) * cout + o] = w[i];
}

// Pixel iw of an input row lands at (iw - iw0) * Cin + c + phase of its
// stage, where phase = ((row's pixel iw0) * Cin) mod 4.
__device__ __forceinline__ int k2f_phase(int n, int h, int w_in, int cin, int ih, int iw0) {
  return (int)((((long long)n * h + ih) * w_in + iw0) * cin & 3);
}

// Copies pixels [iw0, iw0 + np) of input row ih of image n into `stage`:
// with `copy_x`, x's 16-byte words from the one that holds the first
// in-image pixel's first byte to the one that holds the last one's last
// (the last cut at x's end), so that pixel iw channel c lands at (iw - iw0)
// * Cin + c + phase; then the pixels' G masks at rowf + 2 (iw - iw0) + g,
// zero outside the image. A pixel outside the image keeps what the stage
// held: its mask is 0, and `masked` gives 0 whatever x holds.
__device__ __forceinline__ void k2f_fill(const float* x, const float* mask, long long x_floats,
                                         int n, int h, int w_in, int cin, int g, int ih, int iw0,
                                         int np, float* stage, int rowf, bool copy_x, int tid,
                                         int nth) {
  const long long rp = ((long long)n * h + ih) * w_in;  // the row's pixel 0 in x
  const int a = max(iw0, 0), e = min(iw0 + np, w_in);
  if (copy_x && a < e) {
    const long long al = ((rp + iw0) * cin) & ~3ll;  // x's float at the stage's float 0
    const long long q0 = ((rp + a) * cin) & ~3ll, q1 = ((rp + e) * cin + 3) & ~3ll;
    for (long long q = q0 + 4ll * tid; q < q1; q += 4ll * nth) {
      const long long left = x_floats - q;
      cp_async16(smem_u32(stage + (q - al)), x + q, left >= 4 ? 16 : (int)left * 4);
    }
  }
  float* ms = stage + rowf;
  for (int i = tid; i < np * g; i += nth) {
    const int j = i / g, gg = i - j * g, iw = iw0 + j;
    const bool in = iw >= 0 && iw < w_in;
    cp_async4(smem_u32(ms + 2 * j + gg), in ? mask + (rp + iw) * g + gg : mask, in ? 4 : 0);
  }
}

struct K2fParams {
  const float* x;      // (N, H, W, Cin), 16-byte aligned
  const float* mask;   // (N, H, W, G)
  const float* w;      // (k*k, Cin, Cout), re-laid in the launch
  const float* bias;   // (Cout) or nullptr
  float* y;            // (N, Hout, Wout, Cout)
  float* mask_out;     // (N, Hout, Wout, 1)
  long long x_floats;  // N * H * W * Cin
  int n, h, w_in, cin, g, size0, size1, hout, wout, cout, k, ph, pw, rb;
};

// One input row's channels [ca, cb) into the K output rows it reaches:
// acc[d] is output row ih + ph - (K - 1) + d. xb: the thread's first window
// pixel in the stage; mv: its window pixels' masks for these channels.
template <int COUT, int K>
__device__ __forceinline__ void k2f_row(float (&acc)[K][K2F_R][COUT], const float* xb,
                                        const float* ws, const float (&mv)[K2F_R + K - 1],
                                        int ca, int cb, int cin) {
  constexpr int NW = K2F_R + K - 1, WPC = (K * K * COUT + 3) / 4 * 4;
  for (int c = ca; c < cb; ++c) {
    float xv[NW], w[WPC];
#pragma unroll
    for (int i = 0; i < NW; ++i) xv[i] = masked(xb[i * cin + c], mv[i]);
#pragma unroll
    for (int v = 0; v < WPC / 4; ++v) {
      const float4 t = reinterpret_cast<const float4*>(ws + c * WPC)[v];
      w[4 * v] = t.x; w[4 * v + 1] = t.y; w[4 * v + 2] = t.z; w[4 * v + 3] = t.w;
    }
#pragma unroll
    for (int dy = 0; dy < K; ++dy)
#pragma unroll
      for (int dx = 0; dx < K; ++dx)
#pragma unroll
        for (int j = 0; j < K2F_R; ++j)
#pragma unroll
          for (int o = 0; o < COUT; ++o)
            acc[K - 1 - dy][j][o] =
                fmaf(xv[j + dx], w[(dy * K + dx) * COUT + o], acc[K - 1 - dy][j][o]);
  }
}

template <int COUT, int K>
__global__ void __launch_bounds__(K2F_THREADS, K2F_CTAS) pconv_k2f(const K2fParams p) {
  constexpr int R = K2F_R, TW = K2F_TW, NW = R + K - 1, NP = TW + K - 1;
  constexpr int WPC = (K * K * COUT + 3) / 4 * 4;
  extern __shared__ __align__(16) float k2f_smem[];
  const int cin = p.cin, rowf = k2f_row_floats(NP, cin), stage = k2f_stage_floats(NP, cin);
  float* ws = k2f_smem + K2F_RING * stage;  // [Cin][WPC]
  float* red = ws + cin * WPC;               // [8][TW * COUT]: the warps' sums of a row
  float* mring = red + 8 * TW * COUT;        // [K][NP][2]: the last K input rows' masks
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int strips = (p.wout + TW - 1) / TW, bands = (p.hout + p.rb - 1) / p.rb;
  const int strip = blockIdx.x % strips, band = blockIdx.x / strips % bands;
  const int n = blockIdx.x / strips / bands;
  const int ow0 = strip * TW, oh0 = band * p.rb, oh1 = min(oh0 + p.rb, p.hout);
  const int iw0 = ow0 - p.pw, ih0 = oh0 - p.ph, rows = oh1 - oh0 + K - 1;
  auto fill = [&](int r) {
    const int ih = ih0 + r;
    if (ih >= 0 && ih < p.h)
      k2f_fill(p.x, p.mask, p.x_floats, n, p.h, p.w_in, cin, p.g, ih, iw0, NP,
               k2f_smem + r % K2F_RING * stage, rowf, true, tid, K2F_THREADS);
  };
#pragma unroll
  for (int r = 0; r < K2F_RING - 1; ++r) {
    if (r < rows) fill(r);
    cp_async_commit();
  }
  for (int i = tid; i < cin * K * K * COUT; i += K2F_THREADS) {
    const int o = i % COUT, r = i / COUT, c = r % cin, tap = r / cin;
    ws[c * WPC + tap * COUT + o] = p.w[i];
  }
  const int c_lo = warp * cin / 8, c_hi = (warp + 1) * cin / 8;
  const int c_mid = min(max(p.size0, c_lo), c_hi);  // group 1 from channel size0
  const float kkc = (float)(K * K * cin);
  float acc[K][R][COUT];
#pragma unroll
  for (int d = 0; d < K; ++d)
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
      for (int o = 0; o < COUT; ++o) acc[d][j][o] = 0.f;
  for (int r = 0; r < rows; ++r) {
    cp_async_wait<K2F_RING - 2>();  // this thread's copies of row r have landed
    __syncthreads();                // everyone's; and row r - 1's stage is read
    if (r + K2F_RING - 1 < rows) fill(r + K2F_RING - 1);
    cp_async_commit();
    const int ih = ih0 + r;
    const bool in = ih >= 0 && ih < p.h;
    const float* st = k2f_smem + r % K2F_RING * stage;
    for (int i = tid; i < 2 * NP; i += K2F_THREADS)  // 0 for a row outside the image
      mring[r % K * 2 * NP + i] = in ? st[rowf + i] : 0.f;
    if (in) {  // a row outside the image adds nothing
      const float* xb = st + lane * R * cin + k2f_phase(n, p.h, p.w_in, cin, ih, iw0);
      const float* mb = st + rowf + lane * R * 2;
      float m0[NW], m1[NW];
#pragma unroll
      for (int i = 0; i < NW; ++i) {
        m0[i] = mb[2 * i];
        m1[i] = mb[2 * i + 1];
      }
      k2f_row<COUT, K>(acc, xb, ws, m0, c_lo, c_mid, cin);
      k2f_row<COUT, K>(acc, xb, ws, m1, c_mid, c_hi, cin);
    }
    const int oh = ih + p.ph - (K - 1);  // the output row this input row completes
    if (oh >= oh0) {
#pragma unroll
      for (int j = 0; j < R; ++j)
#pragma unroll
        for (int o = 0; o < COUT; ++o) red[(warp * TW + lane * R + j) * COUT + o] = acc[0][j][o];
      __syncthreads();
      const size_t pix0 = ((size_t)n * p.hout + oh) * p.wout + ow0;
      const int ne = min(TW, p.wout - ow0) * COUT;
      for (int e = tid; e < ne; e += K2F_THREADS) {
        float s = red[e];
#pragma unroll
        for (int wp = 1; wp < 8; ++wp) s += red[wp * TW * COUT + e];
        // window_count's sums in its order, from the ring (0 outside the image)
        const int jp = e / COUT, o = e - jp * COUT;
        float c0 = 0.f, c1 = 0.f;
#pragma unroll
        for (int dy = 0; dy < K; ++dy) {
          const float* mr = mring + (r + 1 + dy) % K * 2 * NP + 2 * jp;
#pragma unroll
          for (int dx = 0; dx < K; ++dx) {
            c0 += mr[2 * dx];
            if (p.g == 2) c1 += mr[2 * dx + 1];
          }
        }
        const float msum = __fadd_rn(__fmul_rn((float)p.size0, c0), __fmul_rn((float)p.size1, c1));
        const float scale = msum > 0.f ? kkc / fmaxf(msum, 1.f) : 0.f;
        p.y[pix0 * COUT + e] = epilogue(s, scale, p.bias ? p.bias[o] : 0.f);
        if (o == 0) p.mask_out[pix0 + jp] = msum > 0.f ? 1.f : 0.f;
      }
    }
#pragma unroll
    for (int d = 0; d < K; ++d)  // the next input row starts one output row further down
#pragma unroll
      for (int j = 0; j < R; ++j)
#pragma unroll
        for (int o = 0; o < COUT; ++o) acc[d][j][o] = d + 1 < K ? acc[d + 1][j][o] : 0.f;
  }
  cp_async_wait<0>();
}

template <int COUT, int K>
cudaError_t launch_k2f(const K2fParams& p, cudaStream_t s) {
  const size_t smem = k2f_smem_bytes(p.cin, COUT, K);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(pconv_k2f<COUT, K>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long grid = (long long)p.n * ((p.hout + p.rb - 1) / p.rb) *
                         ((p.wout + K2F_TW - 1) / K2F_TW);
  if (grid >= (1ll << 31)) return cudaErrorInvalidValue;
  pconv_k2f<COUT, K><<<(unsigned)grid, K2F_THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

struct K2fBwdParams {
  const float* dacc;   // (N, Hout, Wout, Cout): g * scale * valid
  const float* x;      // (N, H, W, Cin), 16-byte aligned
  const float* mask;   // (N, H, W, G)
  const float* w;      // (k*k, Cout, Cin), re-laid in the launch
  float* dx;           // (N, H, W, Cin) when need_dx
  float* part;         // (grid, k*k*Cout*Cin) when need_dw: CTA b's dW as (tap, o, c)
  long long x_floats;  // N * H * W * Cin
  int n, h, w_in, cin, g, size0, hout, wout, cout, k, ph, pw, rb, nseg, need_dx, need_dw;
};

// COUT floats of a padded dacc column.
template <int COUT>
__device__ __forceinline__ void load_cout(float (&d)[COUT], const float* src) {
#pragma unroll
  for (int v = 0; v < (COUT + 3) / 4; ++v) {
    const float4 t = reinterpret_cast<const float4*>(src)[v];
    const float e[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * v + i < COUT) d[4 * v + i] = e[i];
  }
}

template <int COUT, int K>
__global__ void __launch_bounds__(HB_THREADS, K2F_CTAS) pconv_k2f_bwd(const K2fBwdParams p) {
  constexpr int CP = (COUT + 3) / 4 * 4, KKC = K * K * COUT, SD = HB_RING + K - 1;
  constexpr int UNROLL = KKC <= 27 ? HB_SEG : 1;  // a segment's pixels, for small windows
  extern __shared__ __align__(16) float hb_smem[];
  const int cin = p.cin, tw = p.nseg * HB_SEG, nth = blockDim.x, tid = threadIdx.x;
  const int rowf = k2f_row_floats(tw, cin), stage = k2f_stage_floats(tw, cin);
  const int dpitch = (tw + K - 1) * CP;         // floats of a dacc row
  float* drows = hb_smem + HB_RING * stage;     // [SD][tw + K - 1][CP]
  const int c = tid % cin, seg = tid / cin;
  const int strips = (p.w_in + tw - 1) / tw, bands = (p.h + p.rb - 1) / p.rb;
  const int strip = blockIdx.x % strips, band = blockIdx.x / strips % bands;
  const int n = blockIdx.x / strips / bands;
  const int iw0 = strip * tw, ih0 = band * p.rb, rows = min(p.rb, p.h - ih0);
  // dacc row a, column q of the ring: output (dh0 + a, dw0 + q)
  const int dh0 = ih0 + p.ph - (K - 1), dw0 = iw0 + p.pw - (K - 1);
  auto fill_dacc = [&](int a) {
    float* dst = drows + a % SD * dpitch;
    const int oh = dh0 + a;
    const bool row_in = oh >= 0 && oh < p.hout;
    for (int i = tid; i < (tw + K - 1) * COUT; i += nth) {
      const int qc = i / COUT, o = i - qc * COUT, ow = dw0 + qc;
      const bool in = row_in && ow >= 0 && ow < p.wout;
      cp_async4(smem_u32(dst + qc * CP + o),
                in ? p.dacc + (((size_t)n * p.hout + oh) * p.wout + ow) * COUT + o : p.dacc,
                in ? 4 : 0);
    }
  };
  auto fill = [&](int r) {  // input row r of the band, and the dacc row it is the last to need
    k2f_fill(p.x, p.mask, p.x_floats, n, p.h, p.w_in, cin, p.g, ih0 + r, iw0, tw,
             hb_smem + r % HB_RING * stage, rowf, p.need_dw != 0, tid, nth);
    fill_dacc(r + K - 1);
  };
  for (int a = 0; a < K - 1; ++a) fill_dacc(a);
#pragma unroll
  for (int r = 0; r < HB_RING - 1; ++r) {
    if (r < rows) fill(r);
    cp_async_commit();
  }
  const bool act = seg < p.nseg;
  const int sa = seg * HB_SEG, sb = act ? min(sa + HB_SEG, p.w_in - iw0) : sa;
  const int gsel = p.g == 2 && c >= p.size0 ? 1 : 0;
  float wr[KKC], acc[KKC];
#pragma unroll
  for (int t = 0; t < KKC; ++t) {
    wr[t] = act && p.need_dx ? p.w[(size_t)t * cin + c] : 0.f;
    acc[t] = 0.f;
  }
  for (int r = 0; r < rows; ++r) {
    cp_async_wait<HB_RING - 2>();
    __syncthreads();
    if (r + HB_RING - 1 < rows) fill(r + HB_RING - 1);
    cp_async_commit();
    if (sa >= sb) continue;
    const int ih = ih0 + r;
    const float* st = hb_smem + r % HB_RING * stage;
    const float* xr = st + k2f_phase(n, p.h, p.w_in, cin, ih, iw0) + c;  // pixel j: xr[j * Cin]
    const float* mr = st + rowf + gsel;                                  // pixel j: mr[2 j]
    const float* dr[K];  // window row dy: output row ih + ph - dy
#pragma unroll
    for (int dy = 0; dy < K; ++dy) dr[dy] = drows + (r + K - 1 - dy) % SD * dpitch;
    float d[K][K][COUT];  // d[dy][dx]: output (ih + ph - dy, iw + pw - dx), column j + K - 1 - dx
#pragma unroll
    for (int dy = 0; dy < K; ++dy)
#pragma unroll
      for (int dx = 1; dx < K; ++dx) load_cout<COUT>(d[dy][dx], dr[dy] + (sa + K - 1 - dx) * CP);
    float* dxp =
        p.need_dx ? p.dx + (((size_t)n * p.h + ih) * p.w_in + iw0) * cin + c : nullptr;
#pragma unroll UNROLL
    for (int u = 0; u < HB_SEG; ++u) {
      const int j = sa + u;
      if (j >= sb) break;
#pragma unroll
      for (int dy = 0; dy < K; ++dy) load_cout<COUT>(d[dy][0], dr[dy] + (j + K - 1) * CP);
      const float m = mr[2 * j];
      if (p.need_dx) {
        float t = 0.f;
#pragma unroll
        for (int dy = 0; dy < K; ++dy) {
          float s = 0.f;
#pragma unroll
          for (int dx = 0; dx < K; ++dx)
#pragma unroll
            for (int o = 0; o < COUT; ++o) s = fmaf(d[dy][dx][o], wr[(dy * K + dx) * COUT + o], s);
          t = dy == 0 ? s : t + s;
        }
        dxp[(size_t)j * cin] = masked(t, m);
      }
      if (p.need_dw) {
        const float xm = masked(xr[j * cin], m);
#pragma unroll
        for (int dy = 0; dy < K; ++dy)
#pragma unroll
          for (int dx = 0; dx < K; ++dx)
#pragma unroll
            for (int o = 0; o < COUT; ++o)
              acc[(dy * K + dx) * COUT + o] = fmaf(xm, d[dy][dx][o], acc[(dy * K + dx) * COUT + o]);
      }
#pragma unroll
      for (int dy = 0; dy < K; ++dy)  // one column on: each window column moves a tap right
#pragma unroll
        for (int dx = K - 1; dx > 0; --dx)
#pragma unroll
          for (int o = 0; o < COUT; ++o) d[dy][dx][o] = d[dy][dx - 1][o];
    }
  }
  cp_async_wait<0>();
  if (!p.need_dw) return;
  __syncthreads();  // the ring is free: the segments' sums, then CTA b's row of partials
  float* red = hb_smem;  // [nseg][KKC][Cin]
  if (act)
#pragma unroll
    for (int t = 0; t < KKC; ++t) red[((size_t)seg * KKC + t) * cin + c] = acc[t];
  __syncthreads();
  const int len = KKC * cin;
  for (int i = tid; i < len; i += nth) {
    float s = red[i];
    for (int sg = 1; sg < p.nseg; ++sg) s += red[(size_t)sg * len + i];
    p.part[(size_t)blockIdx.x * len + i] = s;
  }
}

template <int COUT, int K>
cudaError_t launch_k2f_bwd(const K2fBwdParams& p, cudaStream_t s) {
  const size_t smem = k2f_bwd_smem_bytes(p.cin, COUT, K, p.nseg);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(pconv_k2f_bwd<COUT, K>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int tw = p.nseg * HB_SEG, threads = (p.nseg * p.cin + 31) / 32 * 32;
  const long long grid = (long long)p.n * ((p.h + p.rb - 1) / p.rb) * ((p.w_in + tw - 1) / tw);
  if (grid >= (1ll << 31)) return cudaErrorInvalidValue;
  pconv_k2f_bwd<COUT, K><<<(unsigned)grid, threads, smem, s>>>(p);
  return cudaGetLastError();
}

// Dispatch on (COUT, K) over the built instances: CALL(C, K) for each.
#define TSII_K2F_COUT(C, CALL) \
  case C * 8 + 1: CALL(C, 1) case C * 8 + 3: CALL(C, 3) case C * 8 + 5: CALL(C, 5) \
  case C * 8 + 7: CALL(C, 7)
#define TSII_K2F_SWITCH(cout, k, CALL)                                                \
  switch ((cout) * 8 + (k)) {                                                          \
    TSII_K2F_COUT(1, CALL) TSII_K2F_COUT(2, CALL) TSII_K2F_COUT(3, CALL)               \
    TSII_K2F_COUT(4, CALL) TSII_K2F_COUT(5, CALL) TSII_K2F_COUT(6, CALL)               \
    TSII_K2F_COUT(7, CALL)                                                             \
    default: return (int)cudaErrorInvalidValue;                                        \
  }
// The backward's windows: k 1 and 3.
#define TSII_K2F_BWD_COUT(C, CALL) case C * 8 + 1: CALL(C, 1) case C * 8 + 3: CALL(C, 3)
#define TSII_K2F_BWD_SWITCH(cout, k, CALL)                                            \
  switch ((cout) * 8 + (k)) {                                                          \
    TSII_K2F_BWD_COUT(1, CALL) TSII_K2F_BWD_COUT(2, CALL) TSII_K2F_BWD_COUT(3, CALL)   \
    TSII_K2F_BWD_COUT(4, CALL) TSII_K2F_BWD_COUT(5, CALL) TSII_K2F_BWD_COUT(6, CALL)   \
    TSII_K2F_BWD_COUT(7, CALL)                                                         \
    default: return (int)cudaErrorInvalidValue;                                        \
  }

// K1F v2, the f32 form at Cout >= 8 (v1 was `pconv_f32<8, 4>`: 4 pixels x
// 8 channels a thread, chunks of 8 channels staged by scalar loads between
// two __syncthreads, a grid of tiles x Cout blocks x N that left the card
// idle at the deep levels). An implicit GEMM on FFMA: M = output pixels
// (flat over N, Hout, Wout), N = Cout, K = (tap, input channel), bound by
// the f32 FFMA rate at every U-Net level (425 GFLOP at dec4..dec1).
//   - `pconv_k1f_weights` re-lays W as (k*k, Cin_p, Cout_p) in the launch
//     (a tiled transpose), and `pconv_f32_mask` writes x * M once (f32;
//     `masked`, so a hole is exactly 0) with a border of zeros as wide as
//     the padding and zero channels up to Cin_p, so the GEMM's gather is
//     plain copies with no bounds: a tap is a constant offset from each
//     pixel's window origin.
//   - `pconv_k1f<BM, BN>`: a CTA of 256 threads owns BM output pixels x BN
//     output channels ((128, 128), or (256, 64) at Cout <= 64), two CTAs an
//     SM. A K step is one tap x 16 input channels. A ring of 4 stages,
//     filled three steps ahead: the step's x * M gathered channel-major
//     ([channel][pixel]: 4-byte cp.async copies that transpose NHWC, a
//     warp's copy 4 pixels x 32 contiguous bytes) through a table of the
//     tile's window origins built once, and the step's weights (16-byte
//     copies of the re-laid (k*k, Cin_p, Cout_p), zero padded, so no
//     bounds). One __syncthreads a step publishes a stage and frees the one
//     before.
//   - A register-blocked outer product: a thread owns 8 pixels x 8 output
//     channels, 64 sums; per input channel it reads two float4s of x * M (4
//     pixels each, BM / 2 apart) and two of W (4 channels each, BN / 2
//     apart) for 64 FFMA. A warp is 4 pixel groups x 8 channel groups, so
//     each read is one shared wavefront.
//   - Split K where the tile grid is smaller than the card
//     (ops/kernels/partial_conv.py::k1f_plan, a pure function of the
//     shape: dec7..dec5 of the U-Net): CTA z takes K steps [z * steps /
//     splits, (z + 1) * steps / splits) and writes its raw f32 sums to a
//     workspace; `pconv_k1f_reduce` adds them in split order and applies
//     the epilogue. No atomics: two launches give the same bits.
//   - Each output's sum runs over its K steps in order (tap-major, then
//     the chunk's 16 channels), one FFMA chain per CTA; the epilogue is
//     v1's (`window_count<float>`, k*k*Cin / max(msum, 1), the bias, 0 in
//     empty windows, M').

constexpr int K1F_THREADS = 256;
constexpr int K1F_CTAS = 2;    // resident CTAs an SM
constexpr int K1F_CK = 16;     // input channels per K step
constexpr int K1F_STAGES = 4;

template <int BM, int BN>
struct K1fTile {
  static constexpr int PG = BM / 8, CG = BN / 8;  // pixel and channel groups
  static constexpr int WC = CG / 8;               // warps across the channel groups
  static constexpr int XP = BM + 4;               // floats a staged channel: 4 mod 32
  static constexpr int XS = K1F_CK * XP;
  static constexpr int STAGE = XS + K1F_CK * BN;
  static constexpr int SMEM = K1F_STAGES * STAGE * 4 + BM * 8;  // + the pixel table
  static_assert(PG * CG == K1F_THREADS && PG % 4 == 0 && CG % 8 == 0, "8 x 8 a thread");
};
static_assert(K1fTile<128, 128>::SMEM * K1F_CTAS <= 226 * 1024, "two CTAs an SM");
static_assert(K1fTile<256, 64>::SMEM * K1F_CTAS <= 226 * 1024, "two CTAs an SM");

struct K1fParams {
  const float* xm;    // x * M: (N, H + 2 ph, W + 2 pw, Cin_p), zero border and channels
  const float* mask;  // (N, H, W, G)
  const float* w;     // (k*k, Cin_p, Cout_p), zero padded
  const float* bias;  // (Cout) or nullptr
  float* y;           // (N, Hout, Wout, Cout)
  float* mask_out;    // (N, Hout, Wout, 1)
  float* partial;     // splits > 1: (splits, P, Cout_p)
  int n, h, w_in, cin, g, size0, size1, hout, wout, cout, k, ph, pw, cin_p, cout_p, splits;
  const int* groups;  // G > 2: the group table, else nullptr
};

// The part of `Params` that window_count reads.
__device__ __forceinline__ Params k1f_count_params(const K1fParams& p) {
  Params q;
  q.mask = reinterpret_cast<const __nv_bfloat16*>(p.mask);
  q.h = p.h; q.w_in = p.w_in; q.g = p.g; q.size0 = p.size0; q.size1 = p.size1;
  q.k = p.k; q.ph = p.ph; q.pw = p.pw; q.groups = p.groups;
  return q;
}

// The GEMM's weights from the layer's OIHW weights: wk[(tap * Cin_p + c) *
// Cout_p + o] = w[(o * Cin + c) * k*k + tap], a tiled transpose of w as a
// (Cout, Cin * k*k) matrix through shared memory, both sides coalesced
// (ops/kernels/partial_conv.py::k1f_weight_relayout is its plain version).
// The padding (c >= Cin, o >= Cout) keeps what the caller put there.
__global__ void pconv_k1f_weights(const float* __restrict__ w, float* __restrict__ wk, int cout,
                                  int cin, int kk, int cin_p, int cout_p) {
  __shared__ float tile[32][33];
  const int jn = cin * kk, j0 = blockIdx.x * 32, o0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int r = ty; r < 32; r += 8) {
    const int o = o0 + r, j = j0 + tx;
    tile[r][tx] = o < cout && j < jn ? w[(size_t)o * jn + j] : 0.f;
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {
    const int j = j0 + r, o = o0 + tx, c = j / kk;
    if (j < jn && o < cout) wk[((size_t)(j - c * kk) * cin_p + c) * cout_p + o] = tile[tx][r];
  }
}

// xm = x * M (as `masked`) with a border of zeros and zero channels past
// Cin: (N, H + 2 ph, W + 2 pw, Cin_p), so the GEMM's gather needs no bounds.
// One thread per padded pixel and 4 channels.
__global__ void pconv_f32_mask(const K1fParams p, const float* __restrict__ x,
                               float* __restrict__ xm) {
  const int hp = p.h + 2 * p.ph, wp = p.w_in + 2 * p.pw, q4 = p.cin_p / 4;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)p.n * hp * wp * q4) return;
  const long long pix = idx / q4;
  const int c = (int)(idx - pix * q4) * 4;
  const int col = (int)(pix % wp), row = (int)(pix / wp % hp);
  const int n = (int)(pix / ((long long)wp * hp));
  const int ih = row - p.ph, iw = col - p.pw;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (ih >= 0 && ih < p.h && iw >= 0 && iw < p.w_in) {
    const size_t ip = ((size_t)n * p.h + ih) * p.w_in + iw;
    const float m0 = p.mask[ip * p.g], m1 = p.g == 2 ? p.mask[ip * p.g + 1] : m0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (c + e >= p.cin) continue;
      const float m = p.g > 2 ? p.mask[ip * p.g + group_of(p.groups + p.g, p.g, c + e)]
                              : c + e < p.size0 ? m0 : m1;
      v[e] = masked(x[ip * p.cin + c + e], m);
    }
  }
  *reinterpret_cast<float4*>(xm + pix * p.cin_p + c) = make_float4(v[0], v[1], v[2], v[3]);
}

template <int BM, int BN>
__device__ __forceinline__ void k1f_fill(const K1fParams& p, float* stage, const int2* tbl,
                                          int step, int co0, int tid) {
  using T = K1fTile<BM, BN>;
  static_assert(K1F_CK == 16, "a thread copies channels (tid % 8) and 8 + (tid % 8)");
  const int nck = p.cin_p / K1F_CK, tap = step / nck, c0 = (step - tap * nck) * K1F_CK;
  const int dy = tap / p.k, dx = tap - dy * p.k;
  const int off = dy * (p.w_in + 2 * p.pw) + dx;  // the tap's offset in xm's padded pixels
  const uint32_t xs = smem_u32(stage), ws = smem_u32(stage + T::XS);
  const int cl = tid & 7;
#pragma unroll
  for (int j = 0; j < BM / 32; ++j) {
    const int pix = j * 32 + (tid >> 3);
    const int2 t = tbl[pix];  // (xm pixel of the window's tap 0, in the grid)
    const float* src = p.xm + ((long long)t.x + off) * p.cin_p + c0 + cl;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      cp_async4(xs + (uint32_t)((hh * 8 + cl) * T::XP + pix) * 4, t.y ? src + 8 * hh : p.xm,
                t.y ? 4 : 0);
  }
  for (int i = tid; i < K1F_CK * BN / 4; i += K1F_THREADS) {
    const int cc = i / (BN / 4), q4 = i - cc * (BN / 4);
    cp_async16(ws + (uint32_t)i * 16,
               p.w + ((size_t)tap * p.cin_p + c0 + cc) * p.cout_p + co0 + 4 * q4, 16);
  }
}

template <int BM, int BN>
__global__ void __launch_bounds__(K1F_THREADS, K1F_CTAS) pconv_k1f(const K1fParams p) {
  using T = K1fTile<BM, BN>;
  extern __shared__ __align__(16) float k1f_smem[];
  int2* tbl = reinterpret_cast<int2*>(k1f_smem + K1F_STAGES * T::STAGE);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pg = warp / T::WC * 4 + lane / 8, cg = warp % T::WC * 8 + lane % 8;
  const long long P = (long long)p.n * p.hout * p.wout, m0 = (long long)blockIdx.x * BM;
  const int co0 = blockIdx.y * BN, z = blockIdx.z;
  const int steps = p.k * p.k * (p.cin_p / K1F_CK);
  const int sb = (int)((long long)z * steps / p.splits);  // k1_split_ranges
  const int ns = (int)((long long)(z + 1) * steps / p.splits) - sb;
  for (int i = tid; i < BM; i += K1F_THREADS) {  // each pixel's window origin in xm
    const long long pix = m0 + i;
    int2 t = make_int2(0, 0);
    if (pix < P) {
      const long long hw = (long long)p.hout * p.wout;
      const int n = (int)(pix / hw), r = (int)(pix - n * hw);
      t = make_int2((n * (p.h + 2 * p.ph) + r / p.wout) * (p.w_in + 2 * p.pw) + r % p.wout, 1);
    }
    tbl[i] = t;
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < K1F_STAGES - 1; ++s) {
    if (s < ns) k1f_fill<BM, BN>(p, k1f_smem + s * T::STAGE, tbl, sb + s, co0, tid);
    cp_async_commit();
  }
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 1
  for (int s = 0; s < ns; ++s) {
    const int nx = s + K1F_STAGES - 1;
    cp_async_wait<K1F_STAGES - 2>();  // this thread's copies of step s have landed
    __syncthreads();                  // everyone's; and step s - 1's stage is read
    if (nx < ns)
      k1f_fill<BM, BN>(p, k1f_smem + nx % K1F_STAGES * T::STAGE, tbl, sb + nx, co0, tid);
    cp_async_commit();
    const float* xs = k1f_smem + s % K1F_STAGES * T::STAGE + 4 * pg;
    const float* ws = k1f_smem + s % K1F_STAGES * T::STAGE + T::XS + 4 * cg;
#pragma unroll
    for (int cc = 0; cc < K1F_CK; ++cc) {
      const float4 xa = *reinterpret_cast<const float4*>(xs + cc * T::XP);
      const float4 xb = *reinterpret_cast<const float4*>(xs + cc * T::XP + BM / 2);
      const float4 wa = *reinterpret_cast<const float4*>(ws + cc * BN);
      const float4 wb = *reinterpret_cast<const float4*>(ws + cc * BN + BN / 2);
      const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  // pixel i of the thread: 4 pg + i (i < 4), BM / 2 + 4 pg + i - 4; channel j likewise
  const Params q = k1f_count_params(p);
  const float kkc = (float)(p.k * p.k * p.cin);
  const bool vec = p.cout % 4 == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long pix = m0 + (i >> 2) * (BM / 2) + 4 * pg + (i & 3);
    if (pix >= P) continue;
    if (p.splits > 1) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float4*>(p.partial + ((size_t)z * P + pix) * p.cout_p + co0 +
                                   hh * (BN / 2) + 4 * cg) =
            make_float4(acc[i][4 * hh], acc[i][4 * hh + 1], acc[i][4 * hh + 2], acc[i][4 * hh + 3]);
      continue;
    }
    const long long hw = (long long)p.hout * p.wout;
    const int n = (int)(pix / hw), r = (int)(pix - n * hw);
    const float msum = window_count<float>(q, n, r / p.wout, r % p.wout);
    const float scale = msum > 0.f ? kkc / fmaxf(msum, 1.f) : 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int o = co0 + hh * (BN / 2) + 4 * cg;
      if (o >= p.cout) continue;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = epilogue(acc[i][4 * hh + e], scale, p.bias && o + e < p.cout ? p.bias[o + e] : 0.f);
      float* dst = p.y + (size_t)pix * p.cout + o;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (o + e < p.cout) dst[e] = v[e];
      }
    }
    if (blockIdx.y == 0 && cg == 0) p.mask_out[pix] = msum > 0.f ? 1.f : 0.f;
  }
}

// Split K's second pass: one thread per pixel and 4 channels adds the
// partials in split order, then K1F's epilogue; the first 4 channels'
// thread writes M'.
__global__ void pconv_k1f_reduce(const K1fParams p) {
  const long long P = (long long)p.n * p.hout * p.wout;
  const int q4 = p.cout_p / 4;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= P * q4) return;
  const long long pix = idx / q4;
  const int c4 = (int)(idx - pix * q4) * 4;
  if (c4 >= p.cout) return;
  float4 s = *reinterpret_cast<const float4*>(p.partial + pix * p.cout_p + c4);
  for (int z = 1; z < p.splits; ++z) {
    const float4 v = *reinterpret_cast<const float4*>(p.partial + ((size_t)z * P + pix) * p.cout_p + c4);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  const long long hw = (long long)p.hout * p.wout;
  const int n = (int)(pix / hw), r = (int)(pix - n * hw);
  const float msum = window_count<float>(k1f_count_params(p), n, r / p.wout, r % p.wout);
  const float scale = msum > 0.f ? (float)(p.k * p.k * p.cin) / fmaxf(msum, 1.f) : 0.f;
  if (c4 == 0) p.mask_out[pix] = msum > 0.f ? 1.f : 0.f;
  const float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (c4 + e < p.cout)
      p.y[pix * p.cout + c4 + e] = epilogue(v[e], scale, p.bias ? p.bias[c4 + e] : 0.f);
}

template <int BM, int BN>
cudaError_t launch_k1f(const K1fParams& p, cudaStream_t stream) {
  using T = K1fTile<BM, BN>;
  cudaError_t e = cudaFuncSetAttribute(pconv_k1f<BM, BN>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return e;
  const long long P = (long long)p.n * p.hout * p.wout;
  const dim3 grid((unsigned)((P + BM - 1) / BM), (unsigned)(p.cout_p / BN), (unsigned)p.splits);
  pconv_k1f<BM, BN><<<grid, K1F_THREADS, T::SMEM, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return e;
  const long long items = P * (p.cout_p / 4);
  pconv_k1f_reduce<<<(unsigned)((items + 255) / 256), 256, 0, stream>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------------------- general forms ----
//
// K2 and K2F (Cout <= 7) and their backwards take, in their templated
// forms above, k in {1, 3, 5, 7} (K2: while its tile fits in shared
// memory), one or two mask groups, K2F up to the input channels its ring
// holds and K2's backward padding up to k - 1: every layer of the U-Net.
// JAX's Pallas kernels take every stride-1 square window at any Cin, any
// padding and any number of groups (partial_conv_kernel.py:532-539), so
// the rest of that scope runs these general forms, in bf16 or f32 as x
// comes; so do K2 and its backward from k 6, and K2F's backward past k 3,
// where the general forms are the faster (`K2_GEN_K`, `K2F_BWD_KS` in
// ops/kernels/partial_conv.py). The same function as the templated forms:
// acc = sum_taps (x * M_g) W in f32, msum = sum_taps sum_g size_g M_g, K2's
// epilogue, M' = msum > 0; dx = conv_transpose(dacc, W) * M and dW =
// corr(x * M, dacc) after `pconv_k3_prep`. At the head's 67 -> 3 on 8 pages of 512^2 every
// one of them is bound by operations (k = 11: 102 GFLOP forward, 1.5 ms
// of FFMA or 0.1 ms of bf16 tensor core), so each keeps its operands in
// shared memory and re-reads them from registers.
//
//  * Shared staging. `pconv_gen_relay` writes x * M once to device memory
//    as 16-byte units of V = 16 / sizeof(T) channels, (N, H, units, W)
//    (`masked`: 0 in a hole whatever x holds, 0 past Cin), and dacc the
//    same way without a mask. At odd Cin no pixel of x starts on 16 bytes;
//    a unit row of this layout is one contiguous, aligned span, so every
//    kernel streams whole row spans of units with 16-byte `cp.async`
//    copies (src-size 0 outside the image: any padding) through a ring of
//    GEN_D + rows-in-use shared slots, one commit group per row, and a
//    step waits for exactly its rows (`cp.async.wait_group GEN_D`).
//    `pconv_gen_rowsum` writes each input row's weighted mask sums over
//    the k columns of every output column (dx, then the groups, in
//    order); the forward adds k of them per pixel (dy in order), so msum
//    and M' are the same in every launch and exact for binary masks.
//  * The K loop walks (run of taps, channel block, tap row): a step is
//    one tap row dy of one block of units, and its rows are the tile's
//    rows shifted by dy, so consecutive steps share all but one row and a
//    row is staged once per block (rows of the tile + k - 1). Each step's
//    weights ride with its last row. Shared memory is bounded for every
//    k and Cin (a run holds at most GEN_RUN / GM_RUN taps, a block as many
//    units as the plan gives: `gen_plan` in ops/kernels/partial_conv.py).
//  * `pconv_gen_fwd_bf16` (bf16, `mma.sync` m16n8k16, f32 sums): per
//    input pixel q of the tile's row, Z[(dx, o)][q] = sum_dy sum_c W[dy,
//    dx, c, o] x[q + (dy, 0)][c], M = a run's taps x Cout (<= 48: three
//    m16 tiles), N = input pixels, K = channels. A is the weights (16-byte
//    rows of 8 channels a (tap, output) row, `ldmatrix`), B is x as staged
//    (`ldmatrix` of 8 pixels x 8 channels): every x value is read once a
//    step, not once a tap, and no operand is re-laid. Warps split the
//    tile's input pixels (4 rows x 2 halves of 64 columns), so no sum
//    crosses warps; after a run y[p][o] += sum_dx Z[dx, o][p + dx] through
//    shared memory, dx in order.
//  * `pconv_gen_fwd_f32<CO>` (f32, FFMA, no TF32): warp t owns output row
//    t of the tile and lane l pixels 5l .. 5l + 4 with all CO outputs in
//    registers. Per unit (4 channels) and GEN_L taps it loads the 8
//    window units once (LDS.128, conflict-free at an odd run of 5) and
//    slides them over the taps; the weights are float4 broadcasts.
//  * dx: in bf16 `pconv_gen_dx_bf16` on `mma.sync`, D = 16 input pixels x
//    8 channels, a k16 step two taps x the 8 outputs (Cout padded to 8),
//    each quarter of A an `ldmatrix` of the staged dacc row at its own
//    tap's shifted columns, B the weights; in f32 `pconv_gen_dx_f32<CO>`,
//    the forward's SIMT tile over input pixels and 8 input channels. Both
//    are convs of the staged dacc units with the flipped weights (taps
//    reversed within a run, so the window slides as in the forward),
//    rounded once, times the channel's group mask.
//  * dW: a CTA takes one tap row dy, a segment of (row, 64-column strip)
//    items and a group of taps and channels, and walks the segment's rows:
//    in bf16 `pconv_gen_dw_bf16` on `mma.sync` (M = a tap pair x 8 outputs,
//    N = 8 channels, K = 16 pixels; A = dacc^T and B = x * M both by
//    `ldmatrix.trans`), in f32 `pconv_gen_dw_f32<CO>` with a thread on a run
//    of LW taps, a 4-channel sub-chunk and a run of the strip's columns,
//    LW x CO x 4 sums in registers. The pixel groups of a CTA add in order
//    in shared memory, the CTA writes the segment's row of f32 partials
//    (tap, o, c), and `pconv_colsum` adds the rows in order. No atomics
//    anywhere: two launches give the same bits.

constexpr int GEN_THREADS = 256;
constexpr int GEN_COUT = K2_NPAD - 1;  // Cout <= 7
constexpr int GEN_D = 2;                // rows in flight past the ones a step reads
constexpr int GEN_TH = 8;               // SIMT tile: rows (a warp each)
constexpr int GEN_R = 5;                // pixels a lane: odd, so LDS.128 does not conflict
constexpr int GEN_TW = 32 * GEN_R;      // SIMT tile: columns
constexpr int GEN_L = 4;                // taps a window slides over
constexpr int GEN_RUN = 64;             // SIMT: most taps a run
constexpr int GM_TH = 4;                // mma tile: rows (two warps each)
constexpr int GM_NPX = 64;              // mma tile: input columns a row
constexpr int GM_MT = 3;                // mma: m16 tiles of (tap, output) rows
constexpr int GM_RUN = 16;              // mma: most taps a run
constexpr int GM_ZS = GM_NPX + 8;       // Z's row pitch in floats: float2 stores do not conflict
constexpr int GM_YPT = (GM_TH * GM_NPX * GEN_COUT + GEN_THREADS - 1) / GEN_THREADS;
constexpr int GW_TW = 64;               // dW: columns of a segment

struct GenParams {
  const uint4* xm;     // x * M as units: (N, H, xu, W)
  const uint4* dm;     // dacc as units: (N, Hout, du, Wout)
  const void* wk;      // the re-laid weights (see each kernel)
  const float* bias;   // (Cout) or nullptr
  const float* rsum;   // forward: (N, H, Wout) weighted mask sums over k columns
  const void* mask;    // dx: (N, H, W, G)
  const int* groups;   // the group table
  void* y;             // forward: y (N, Hout, Wout, Cout); dx: dx (N, H, W, Cin)
  void* mask_out;      // (N, Hout, Wout, 1)
  float* part;         // dW: (segs, k*k*Cout*Cin) f32
  int n, h, w, cin, g, hout, wout, cout, k, ph, pw;
  int xu, du;          // units of x and of dacc a pixel
  int cbu, run;        // units a block, taps a run
  int rb, rg, scg, npg;  // dW: band rows, runs and sub-chunks of a CTA, pixel groups
};

// dW: taps a thread's run, LW * CO <= 16 (its sums: LW x CO x 4 floats).
__host__ __device__ constexpr int gen_dw_taps(int co) { return co <= 2 ? 8 : co <= 4 ? 4 : 2; }

// Shared bytes of each kernel, as ops/kernels/partial_conv.py::gen_plan
// computes them.
__host__ __device__ inline int gen_fwd_f32_smem(int cbu, int run, int cout) {
  return ((GEN_TH + GEN_D) * cbu * (GEN_TW + run) + (GEN_D + 1) * cbu * run * cout) * 16;
}
__host__ __device__ inline int gen_fwd_bf16_smem(int cbu) {
  const int ring = ((GM_TH + GEN_D) * cbu * GM_NPX + (GEN_D + 1) * cbu * GM_MT * 16) * 16;
  const int z = GM_TH * GM_MT * 16 * GM_ZS * 4;
  return ring > z ? ring : z;
}
__host__ __device__ inline int gen_dx_f32_smem(int du, int run, int cout) {
  return ((GEN_TH + GEN_D) * du * (GEN_TW + run) + (GEN_D + 1) * run * cout * 2) * 16;
}
__host__ __device__ inline int gen_dw_f32_smem(int du, int cout, int rg, int scg, int npg) {
  const int lw = gen_dw_taps(cout);
  const int xun = scg;  // x units a row: scg sub-chunks of 4 channels, one unit each
  const int ring = (1 + GEN_D) * (xun * (GW_TW + 1) + du * (GW_TW + rg * lw)) * 16;
  const int red = (npg - 1) * rg * scg * lw * cout * 16;
  return ring > red ? ring : red;
}

// x * M (with a mask) or a plain copy as units: dst[(row, u, col)] holds
// channels uV .. uV + V - 1 of src's pixel (row, col), 0 past c. A CTA
// takes GR_PIX consecutive pixels (of any rows) and `ub` units: each
// pixel's slice of src comes in 16-byte loads from the 16-byte word that
// holds its first byte (the words of consecutive pixels are consecutive
// when the block has all the channels) into a shared slot of an odd
// number of 4-byte words, and threads over (unit, pixel), pixel fastest,
// read their elements without bank conflicts and write whole units: both
// sides are coalesced.
constexpr int GR_PIX = 64;
constexpr int GR_SMEM = 48 * 1024;  // a relay CTA's shared bytes at most

__host__ __device__ inline int gen_relay_ub(int units) {
  const int most = (GR_SMEM / GR_PIX / 4 - 1) / 4 - 2;
  return units < most ? units : most;
}

template <typename T>
__global__ void __launch_bounds__(256) pconv_gen_relay(const T* __restrict__ src,
                                                       const T* __restrict__ mask,
                                                       const int* __restrict__ starts,
                                                       uint4* __restrict__ dst, long long pixels,
                                                       int cols, int c, int g, int units) {
  constexpr int V = 16 / sizeof(T), E = sizeof(T);
  extern __shared__ __align__(16) uint32_t relay_smem[];
  const int tid = threadIdx.x, ub = gen_relay_ub(units), slotw = ub + 2, sw = 4 * slotw + 1;
  const long long p0 = (long long)blockIdx.x * GR_PIX;
  const int np = (int)min((long long)GR_PIX, pixels - p0);
  const int u0 = blockIdx.y * ub, nu = min(ub, units - u0);
  const int c0 = u0 * V, c1 = min(c, (u0 + nu) * V);
  const char* sb = reinterpret_cast<const char*>(src);
  const long long nbytes = pixels * c * E;
  for (int i = tid; i < np * slotw; i += 256) {
    const int pp = i / slotw, j = i - pp * slotw;
    const long long first = ((p0 + pp) * c + c0) * E, last = ((p0 + pp) * c + c1) * E;
    const long long wb = (first & ~15ll) + 16ll * j;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (wb < last) {
      if (wb + 16 <= nbytes) {
        v = __ldg(reinterpret_cast<const uint4*>(sb + wb));
      } else {  // the tensor's last word, cut at its end
        char* d = reinterpret_cast<char*>(&v);
        for (int b = 0; b < 16 && wb + b < nbytes; ++b) d[b] = sb[wb + b];
      }
    }
    uint32_t* sl = relay_smem + pp * sw + 4 * j;
    sl[0] = v.x;
    sl[1] = v.y;
    sl[2] = v.z;
    sl[3] = v.w;
  }
  __syncthreads();
  for (int i = tid; i < nu * np; i += 256) {
    const int uu = i / np, pp = i - uu * np;
    const long long pix = p0 + pp;
    const char* sl = reinterpret_cast<const char*>(relay_smem + pp * sw) +
                     (int)(((pix * c + c0) * E) & 15) + uu * V * E;
    uint4 out;
    T* e = reinterpret_cast<T*>(&out);
    const int cu = c0 + uu * V;
    int gi = mask ? group_of(starts, g, min(cu, c - 1)) : 0;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int ch = cu + j;
      T v = from_f32<T>(0.f);
      if (ch < c) {
        v = *reinterpret_cast<const T*>(sl + j * E);
        if (mask) {
          while (gi + 1 < g && ch >= __ldg(starts + gi + 1)) ++gi;
          v = masked(v, to_f32(mask[pix * g + gi]));
        }
      }
      e[j] = v;
    }
    const long long row = pix / cols;
    dst[(row * units + u0 + uu) * cols + (pix - row * cols)] = out;
  }
}

// rs[(row, ow)] = sum over dx of the column ow + dx - pw (inside the
// image) of sum_g size_g M_g, in that order.
template <typename T>
__global__ void __launch_bounds__(256) pconv_gen_rowsum(const T* __restrict__ mask,
                                                        const int* __restrict__ sizes,
                                                        float* __restrict__ rs, long long rows,
                                                        int w_in, int g, int wout, int k, int pw) {
  const long long total = rows * wout;
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < total;
       i += (long long)gridDim.x * 256) {
    const int ow = (int)(i % wout);
    const long long row = i / wout;
    float s = 0.f;
    for (int dx = 0; dx < k; ++dx) {
      const int iw = ow + dx - pw;
      if (iw < 0 || iw >= w_in) continue;
      const T* m = mask + (row * w_in + iw) * g;
      for (int gg = 0; gg < g; ++gg)
        s = __fadd_rn(s, __fmul_rn((float)__ldg(sizes + gg), to_f32(m[gg])));
    }
    rs[i] = s;
  }
}

// Copies units [u0, u0 + nu) of row r of image n of a unit tensor (N,
// rows, units, cols), columns [c0, c0 + np), to dst as [unit][column] with
// units `pitch` columns apart (np when 0); zeros outside the tensor
// (src-size 0).
__device__ __forceinline__ void gen_stage_row(const uint4* src, int n, int rows, int units,
                                              int cols, int r, int u0, int nu, int c0, int np,
                                              uint4* dst, int tid, int nth, int pitch = 0) {
  const bool rin = r >= 0 && r < rows;
  const uint4* base = src + ((size_t)n * rows + (rin ? r : 0)) * units * cols;
  if (pitch == 0) pitch = np;
  for (int i = tid; i < nu * np; i += nth) {
    const int jj = i / np, p = i - jj * np, c = c0 + p, u = u0 + jj;
    const bool in = rin && c >= 0 && c < cols && u < units;
    cp_async16(smem_u32(dst + jj * pitch + p), in ? base + (size_t)u * cols + c : src, in ? 16 : 0);
  }
}

// msum of output pixel (n, oh, ow): the k row sums of its window, in order.
__device__ __forceinline__ float gen_msum(const GenParams& p, int n, int oh, int ow) {
  float msum = 0.f;
  for (int dy = 0; dy < p.k; ++dy) {
    const int ih = oh + dy - p.ph;
    if (ih >= 0 && ih < p.h) msum = __fadd_rn(msum, p.rsum[((size_t)n * p.h + ih) * p.wout + ow]);
  }
  return msum;
}

// The epilogue of output pixel (n, oh, ow): y (COUT values) and M'.
template <typename T>
__device__ __forceinline__ void gen_store(const GenParams& p, int n, int oh, int ow, int o,
                                          float acc, float msum) {
  const size_t pix = ((size_t)n * p.hout + oh) * p.wout + ow;
  const float scale = msum > 0.f ? (float)(p.k * p.k * p.cin) / fmaxf(msum, 1.f) : -1.f;
  static_cast<T*>(p.y)[pix * p.cout + o] =
      from_f32<T>(epilogue(acc, scale, p.bias ? p.bias[o] : 0.f));
  if (o == 0) static_cast<T*>(p.mask_out)[pix] = from_f32<T>(msum > 0.f ? 1.f : 0.f);
}

// The forward in f32. W as (k, xu, runs * run, CO) units of 4 f32 channels
// (tap row, unit, tap, output), zero past k and Cin.
template <int CO>
__global__ void __launch_bounds__(GEN_THREADS) pconv_gen_fwd_f32(const GenParams p) {
  extern __shared__ __align__(16) uint4 gen_smem[];
  constexpr int S = GEN_TH + GEN_D;
  const int run = p.run, npx = GEN_TW + run, rowu = p.cbu * npx, wu = p.cbu * run * CO;
  uint4* rows = gen_smem;
  uint4* wts = rows + S * rowu;
  const float4* wk = static_cast<const float4*>(p.wk);
  const int tid = threadIdx.x, lane = tid & 31, t = tid >> 5;
  const int ow0 = blockIdx.x * GEN_TW, oh0 = blockIdx.y * GEN_TH, n = blockIdx.z;
  const int nblk = (p.xu + p.cbu - 1) / p.cbu, per = GEN_TH + p.k - 1;
  const int nrun = (p.k + run - 1) / run;
  float acc[GEN_R][CO];
#pragma unroll
  for (int i = 0; i < GEN_R; ++i)
#pragma unroll
    for (int o = 0; o < CO; ++o) acc[i][o] = 0.f;
  for (int rho = 0; rho < nrun; ++rho) {
    const int dx0 = rho * run, rl = (min(run, p.k - dx0) + GEN_L - 1) / GEN_L * GEN_L;
    const int items = nblk * per, steps = nblk * p.k;
    auto fill = [&](int u) {
      const int b = u / per, r = u - b * per, u0 = b * p.cbu, nu = min(p.cbu, p.xu - u0);
      gen_stage_row(p.xm, n, p.h, p.xu, p.w, oh0 - p.ph + r, u0, nu, ow0 - p.pw + dx0, npx,
                    rows + (u % S) * rowu, tid, GEN_THREADS);
      if (r >= GEN_TH - 1) {  // the weights of step (b, dy = r - GEN_TH + 1)
        const int dy = r - (GEN_TH - 1);
        uint4* ws = wts + ((b * p.k + dy) % (GEN_D + 1)) * wu;
        const uint4* src = reinterpret_cast<const uint4*>(wk);
        for (int i = tid; i < nu * run * CO; i += GEN_THREADS) {
          const int jj = i / (run * CO), e = i - jj * run * CO;
          cp_async16(smem_u32(ws + i),
                     src + (((size_t)dy * p.xu + u0 + jj) * nrun * run + dx0) * CO + e, 16);
        }
      }
    };
    int queued = 0;
    for (int s = 0; s < steps; ++s) {
      const int b = s / p.k, dy = s - b * p.k, hi = b * per + dy + GEN_TH - 1;
      __syncthreads();  // the rows step s - 1 read and s does not may be refilled
      for (; queued <= hi + GEN_D; ++queued) {
        if (queued < items) fill(queued);
        cp_async_commit();
      }
      cp_async_wait<GEN_D>();  // this thread's copies of rows up to hi have landed
      __syncthreads();         // and everyone's
      const int nu = min(p.cbu, p.xu - b * p.cbu);
      const float4* xr = reinterpret_cast<const float4*>(rows + ((b * per + t + dy) % S) * rowu) +
                         lane * GEN_R;
      const float4* wr = reinterpret_cast<const float4*>(wts + (s % (GEN_D + 1)) * wu);
      for (int jj = 0; jj < nu; ++jj, xr += npx, wr += run * CO) {
        for (int d0 = 0; d0 < rl; d0 += GEN_L) {
          float4 xv[GEN_R + GEN_L - 1];
#pragma unroll
          for (int i = 0; i < GEN_R + GEN_L - 1; ++i) xv[i] = xr[d0 + i];
#pragma unroll
          for (int l = 0; l < GEN_L; ++l) {
            float4 wv[CO];
#pragma unroll
            for (int o = 0; o < CO; ++o) wv[o] = wr[(d0 + l) * CO + o];
#pragma unroll
            for (int i = 0; i < GEN_R; ++i)
#pragma unroll
              for (int o = 0; o < CO; ++o) {
                float a = acc[i][o];
                a = fmaf(xv[i + l].x, wv[o].x, a);
                a = fmaf(xv[i + l].y, wv[o].y, a);
                a = fmaf(xv[i + l].z, wv[o].z, a);
                acc[i][o] = fmaf(xv[i + l].w, wv[o].w, a);
              }
          }
        }
      }
    }
    cp_async_wait<0>();
  }
  const int oh = oh0 + t;
  if (oh >= p.hout) return;
#pragma unroll
  for (int i = 0; i < GEN_R; ++i) {
    const int ow = ow0 + lane * GEN_R + i;
    if (ow >= p.wout) break;
    const float msum = gen_msum(p, n, oh, ow);
#pragma unroll
    for (int o = 0; o < CO; ++o) gen_store<float>(p, n, oh, ow, o, acc[i][o], msum);
  }
}

// The forward in bf16. W as (k, xu, k, Cout) units of 8 bf16 channels
// (tap row, unit, tap, output). p.run: taps a run, run * Cout <= 48.
__global__ void __launch_bounds__(GEN_THREADS, 2) pconv_gen_fwd_bf16(const GenParams p) {
  extern __shared__ __align__(16) uint4 gen_smem[];
  constexpr int S = GM_TH + GEN_D, MR = GM_MT * 16;
  const int cbu = p.cbu, rowu = cbu * GM_NPX, wu = cbu * MR;
  uint4* rows = gen_smem;
  uint4* wts = rows + S * rowu;
  float* zs = reinterpret_cast<float*>(gen_smem);  // [GM_TH][MR][GM_ZS] after a run's steps
  const uint4* wk = static_cast<const uint4*>(p.wk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, t = warp >> 1, half = warp & 1;
  const int L = p.run, tw = GM_NPX - L + 1, cout = p.cout;
  const int ow0 = blockIdx.x * tw, oh0 = blockIdx.y * GM_TH, n = blockIdx.z;
  const int xu2 = (p.xu + 1) & ~1;  // whole k16 steps
  const int nblk = (xu2 + cbu - 1) / cbu, per = GM_TH + p.k - 1, nrun = (p.k + L - 1) / L;
  const int nout = GM_TH * tw * cout;
  float yacc[GM_YPT];
#pragma unroll
  for (int i = 0; i < GM_YPT; ++i) yacc[i] = 0.f;
  for (int rho = 0; rho < nrun; ++rho) {
    const int dx0 = rho * L, rl = min(L, p.k - dx0), mrows = rl * cout;
    const int mtn = (mrows + 15) / 16;
    const int items = nblk * per, steps = nblk * p.k;
    auto fill = [&](int u) {
      const int b = u / per, r = u - b * per, u0 = b * cbu, nu = min(cbu, xu2 - u0);
      gen_stage_row(p.xm, n, p.h, p.xu, p.w, oh0 - p.ph + r, u0, nu, ow0 - p.pw + dx0, GM_NPX,
                    rows + (u % S) * rowu, tid, GEN_THREADS);
      if (r >= GM_TH - 1) {  // the weights of step (b, dy): rows (tap - dx0, o) of each unit
        const int dy = r - (GM_TH - 1);
        uint4* ws = wts + ((b * p.k + dy) % (GEN_D + 1)) * wu;
        for (int i = tid; i < nu * MR; i += GEN_THREADS) {
          const int jj = i / MR, m = i - jj * MR, uu = u0 + jj;
          const bool in = m < mrows && uu < p.xu;
          cp_async16(smem_u32(ws + i),
                     in ? wk + (((size_t)dy * p.xu + uu) * p.k + dx0) * cout + m : wk, in ? 16 : 0);
        }
      }
    };
    float acc[GM_MT][4][4];
#pragma unroll
    for (int mt = 0; mt < GM_MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    int queued = 0;
    for (int s = 0; s < steps; ++s) {
      const int b = s / p.k, dy = s - b * p.k, hi = b * per + dy + GM_TH - 1;
      __syncthreads();
      for (; queued <= hi + GEN_D; ++queued) {
        if (queued < items) fill(queued);
        cp_async_commit();
      }
      cp_async_wait<GEN_D>();
      __syncthreads();
      const int nks = min(cbu, xu2 - b * cbu) / 2;
      const uint32_t xs = smem_u32(rows + ((b * per + t + dy) % S) * rowu);
      const uint32_t ws = smem_u32(wts + (s % (GEN_D + 1)) * wu);
      for (int ks = 0; ks < nks; ++ks) {
        uint32_t a[GM_MT][4];
#pragma unroll
        for (int mt = 0; mt < GM_MT; ++mt)
          if (mt < mtn)
            ldmatrix_x4(a[mt], ws + ((2 * ks + (lane >> 4)) * MR + mt * 16 + (lane & 15)) * 16);
#pragma unroll
        for (int nt2 = 0; nt2 < 2; ++nt2) {
          uint32_t bb[4];
          ldmatrix_x4(bb, xs + ((2 * ks + ((lane >> 3) & 1)) * GM_NPX + half * 32 + nt2 * 16 +
                                (lane >> 4) * 8 + (lane & 7)) * 16);
#pragma unroll
          for (int mt = 0; mt < GM_MT; ++mt)
            if (mt < mtn) {
              mma_bf16(acc[mt][2 * nt2], a[mt], bb[0], bb[1]);
              mma_bf16(acc[mt][2 * nt2 + 1], a[mt], bb[2], bb[3]);
            }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free: Z goes there
#pragma unroll
    for (int mt = 0; mt < GM_MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int m = mt * 16 + (lane >> 2), q = half * 32 + nt * 8 + 2 * (lane & 3);
        float* z = zs + (t * MR + m) * GM_ZS + q;
        *reinterpret_cast<float2*>(z) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<float2*>(z + 8 * GM_ZS) = make_float2(acc[mt][nt][2], acc[mt][nt][3]);
      }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < GM_YPT; ++i) {  // y[p][o] += sum over the run's taps of Z[(dx, o)][p + dx]
      const int e = tid + GEN_THREADS * i;
      if (e >= nout) break;
      const int o = e % cout, pc = e / cout % tw, tr = e / cout / tw;
      const float* z = zs + (tr * MR + o) * GM_ZS + pc;
      float sacc = 0.f;
      for (int dl = 0; dl < rl; ++dl) sacc += z[dl * (cout * GM_ZS + 1)];
      yacc[i] += sacc;
    }
    __syncthreads();  // before the next run's copies overwrite Z
  }
#pragma unroll
  for (int i = 0; i < GM_YPT; ++i) {
    const int e = tid + GEN_THREADS * i;
    if (e >= nout) break;
    const int o = e % cout, pc = e / cout % tw, tr = e / cout / tw;
    const int oh = oh0 + tr, ow = ow0 + pc;
    if (oh < p.hout && ow < p.wout)
      gen_store<__nv_bfloat16>(p, n, oh, ow, o, yacc[i], gen_msum(p, n, oh, ow));
  }
}

__device__ __forceinline__ float gen_comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// dx in f32: a CTA of GEN_TH input rows x GEN_TW input columns x 8 input
// channels. W as (k, ceil(Cin / 8), runs * run, CO, 8) f32, (tap row,
// channel block, run * run + r, o, c) with tap dx = run * run + run - 1 - r
// (reversed within a run), zero past k and Cin.
template <int CO>
__global__ void __launch_bounds__(GEN_THREADS) pconv_gen_dx_f32(const GenParams p) {
  extern __shared__ __align__(16) uint4 gen_smem[];
  constexpr int S = GEN_TH + GEN_D, NSC = (CO + 3) / 4;
  const int run = p.run, npx = GEN_TW + run, rowu = p.du * npx, wu = run * CO * 2;
  uint4* rows = gen_smem;
  uint4* wts = rows + S * rowu;
  const int tid = threadIdx.x, lane = tid & 31, t = tid >> 5;
  const int nct = (p.cin + 7) / 8, cb = blockIdx.x % nct;
  const int iw0 = blockIdx.x / nct * GEN_TW, ih0 = blockIdx.y * GEN_TH, n = blockIdx.z;
  const int per = GEN_TH + p.k - 1, nrun = (p.k + run - 1) / run;
  const uint4* wk = static_cast<const uint4*>(p.wk);
  float acc[GEN_R][8];
#pragma unroll
  for (int i = 0; i < GEN_R; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
  for (int rho = 0; rho < nrun; ++rho) {
    const int oc0 = iw0 + p.pw - rho * run - run + 1;  // dacc column of slot column 0
    // step j = k - 1 - dy reads dacc rows ih0 + ph - (k - 1) + t + j
    auto fill = [&](int r) {
      gen_stage_row(p.dm, n, p.hout, p.du, p.wout, ih0 + p.ph - (p.k - 1) + r, 0, p.du, oc0, npx,
                    rows + (r % S) * rowu, tid, GEN_THREADS);
      if (r >= GEN_TH - 1) {
        const int j = r - (GEN_TH - 1), dy = p.k - 1 - j;
        uint4* ws = wts + (j % (GEN_D + 1)) * wu;
        const uint4* src = wk + (((size_t)dy * nct + cb) * nrun * run + rho * run) * CO * 2;
        for (int i = tid; i < wu; i += GEN_THREADS) cp_async16(smem_u32(ws + i), src + i, 16);
      }
    };
    int queued = 0;
    for (int j = 0; j < p.k; ++j) {
      const int hi = j + GEN_TH - 1;
      __syncthreads();
      for (; queued <= hi + GEN_D; ++queued) {
        if (queued < per) fill(queued);
        cp_async_commit();
      }
      cp_async_wait<GEN_D>();
      __syncthreads();
      const float4* dr = reinterpret_cast<const float4*>(rows + ((t + j) % S) * rowu);
      const float4* wr = reinterpret_cast<const float4*>(wts + (j % (GEN_D + 1)) * wu);
#pragma unroll
      for (int sc = 0; sc < NSC; ++sc)
        for (int d0 = 0; d0 < run; d0 += GEN_L) {
          float4 dv[GEN_R + GEN_L - 1];
#pragma unroll
          for (int i = 0; i < GEN_R + GEN_L - 1; ++i)
            dv[i] = dr[sc * npx + lane * GEN_R + d0 + i];
#pragma unroll
          for (int l = 0; l < GEN_L; ++l)
#pragma unroll
            for (int oo = 0; oo < 4; ++oo) {
              const int o = sc * 4 + oo;
              if (o >= CO) break;
              const float4 w0 = wr[((d0 + l) * CO + o) * 2], w1 = wr[((d0 + l) * CO + o) * 2 + 1];
#pragma unroll
              for (int i = 0; i < GEN_R; ++i) {
                const float v = gen_comp(dv[i + l], oo);
                acc[i][0] = fmaf(v, w0.x, acc[i][0]);
                acc[i][1] = fmaf(v, w0.y, acc[i][1]);
                acc[i][2] = fmaf(v, w0.z, acc[i][2]);
                acc[i][3] = fmaf(v, w0.w, acc[i][3]);
                acc[i][4] = fmaf(v, w1.x, acc[i][4]);
                acc[i][5] = fmaf(v, w1.y, acc[i][5]);
                acc[i][6] = fmaf(v, w1.z, acc[i][6]);
                acc[i][7] = fmaf(v, w1.w, acc[i][7]);
              }
            }
        }
    }
    cp_async_wait<0>();
  }
  const int ih = ih0 + t;
  if (ih >= p.h) return;
  const float* mask = static_cast<const float*>(p.mask);
  float* dx = static_cast<float*>(p.y);
  int gi[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) gi[e] = group_of(p.groups + p.g, p.g, min(cb * 8 + e, p.cin - 1));
#pragma unroll
  for (int i = 0; i < GEN_R; ++i) {
    const int iw = iw0 + lane * GEN_R + i;
    if (iw >= p.w) break;
    const size_t pix = ((size_t)n * p.h + ih) * p.w + iw;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = cb * 8 + e;
      if (c < p.cin) dx[pix * p.cin + c] = masked(acc[i][e], mask[pix * p.g + gi[e]]);
    }
  }
}

// dW in f32: one CTA per (segment, group of (runs, sub-chunks), tap row
// dy), dy fastest, so the k CTAs that read a segment's rows run together
// and find them in L2. A thread
// owns run rho of LW taps, sub-chunk sc of 4 channels (one unit) and pixel
// group pg of the segment's 64 columns.
template <int CO>
__global__ void __launch_bounds__(GEN_THREADS) pconv_gen_dw_f32(const GenParams p) {
  extern __shared__ __align__(16) uint4 gen_smem[];
  constexpr int S = 1 + GEN_D, LW = gen_dw_taps(CO), NSC = (CO + 3) / 4;
  const int tid = threadIdx.x, dy = blockIdx.x % p.k;
  const int nrw = (p.k + LW - 1) / LW, c4 = (p.cin + 3) / 4, rgn = (nrw + p.rg - 1) / p.rg;
  const int ngr = rgn * ((c4 + p.scg - 1) / p.scg), grp = blockIdx.x / p.k % ngr;
  const int rho0 = grp % rgn * p.rg, sc0 = grp / rgn * p.scg;
  const int nr = min(p.rg, nrw - rho0), nsc = min(p.scg, c4 - sc0);
  const int my_sc = tid % p.scg, my_r = tid / p.scg % p.rg, pg = tid / (p.scg * p.rg);
  const bool act = pg < p.npg && my_sc < nsc && my_r < nr;
  // segment seg: items [it0, it0 + nrows) of the (row, 64-column strip) pairs of all images
  const int strips = (p.w + GW_TW - 1) / GW_TW, seg = blockIdx.x / p.k / ngr;
  const int it0 = seg * p.rb, nrows = min(p.rb, p.n * p.h * strips - it0);  // below 2^31
  const int xun = p.scg;  // x units of a row: the group's sub-chunks
  constexpr int XP = GW_TW + 1;  // x's unit pitch: lanes on neighbouring units, other banks
  const int npxd = GW_TW + p.rg * LW, slot = xun * XP + p.du * npxd;
  const int rho = rho0 + my_r, off = (rho0 + nr - rho) * LW - 1;
  const int gw = GW_TW / p.npg, q_lo = pg * gw;
  // item r: image n, row ih, strip columns from iw0; dacc columns from oc0
  auto where = [&](int r, int& n, int& ih, int& iw0, int& oc0) {
    const int gi = it0 + r, row = gi / strips;
    iw0 = (gi - row * strips) * GW_TW;
    n = row / p.h;
    ih = row - n * p.h;
    oc0 = iw0 + p.pw - (rho0 + nr) * LW + 1;
  };
  auto fill = [&](int r) {
    int n, ih, iw0, oc0;
    where(r, n, ih, iw0, oc0);
    uint4* st = gen_smem + (r % S) * slot;
    gen_stage_row(p.xm, n, p.h, p.xu, p.w, ih, sc0, nsc, iw0, GW_TW, st, tid, GEN_THREADS, XP);
    gen_stage_row(p.dm, n, p.hout, p.du, p.wout, ih + p.ph - dy, 0, p.du, oc0, npxd,
                  st + xun * XP, tid, GEN_THREADS);
  };
  float4 acc[LW][CO];
#pragma unroll
  for (int l = 0; l < LW; ++l)
#pragma unroll
    for (int o = 0; o < CO; ++o) acc[l][o] = make_float4(0.f, 0.f, 0.f, 0.f);
  int queued = 0;
  for (int r = 0; r < nrows; ++r) {
    __syncthreads();
    for (; queued <= r + GEN_D; ++queued) {
      if (queued < nrows) fill(queued);
      cp_async_commit();
    }
    cp_async_wait<GEN_D>();
    __syncthreads();
    int n, ih, iw0, oc0;
    where(r, n, ih, iw0, oc0);
    const int oh = ih + p.ph - dy;
    if (!act || oh < 0 || oh >= p.hout) continue;  // a dacc row outside adds nothing
    const uint4* st = gen_smem + (r % S) * slot;
    const uint4* dr = st + xun * XP;
    for (int q0 = q_lo; q0 < q_lo + gw && iw0 + q0 < p.w; q0 += LW) {
      float4 xv[LW];
#pragma unroll
      for (int i = 0; i < LW; ++i) xv[i] = reinterpret_cast<const float4*>(st)[my_sc * XP + q0 + i];
      float4 dv[2 * LW - 1][NSC];
#pragma unroll
      for (int j = 0; j < 2 * LW - 1; ++j)
#pragma unroll
        for (int sc = 0; sc < NSC; ++sc)
          dv[j][sc] = reinterpret_cast<const float4*>(dr)[sc * npxd + q0 + off - (LW - 1) + j];
#pragma unroll
      for (int l = 0; l < LW; ++l)
#pragma unroll
        for (int o = 0; o < CO; ++o)
#pragma unroll
          for (int i = 0; i < LW; ++i) {
            const float d = gen_comp(dv[i - l + LW - 1][o / 4], o % 4);
            acc[l][o].x = fmaf(xv[i].x, d, acc[l][o].x);
            acc[l][o].y = fmaf(xv[i].y, d, acc[l][o].y);
            acc[l][o].z = fmaf(xv[i].z, d, acc[l][o].z);
            acc[l][o].w = fmaf(xv[i].w, d, acc[l][o].w);
          }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the pixel groups' sums go there
  float4* red = reinterpret_cast<float4*>(gen_smem);
  const int it = my_r * p.scg + my_sc, nit = p.rg * p.scg;
  if (act && pg > 0)
#pragma unroll
    for (int l = 0; l < LW; ++l)
#pragma unroll
      for (int o = 0; o < CO; ++o) red[((pg - 1) * nit + it) * LW * CO + l * CO + o] = acc[l][o];
  __syncthreads();
  if (!act || pg > 0) return;
  for (int q = 1; q < p.npg; ++q)
#pragma unroll
    for (int l = 0; l < LW; ++l)
#pragma unroll
      for (int o = 0; o < CO; ++o) {
        const float4 v = red[((q - 1) * nit + it) * LW * CO + l * CO + o];
        acc[l][o].x += v.x;
        acc[l][o].y += v.y;
        acc[l][o].z += v.z;
        acc[l][o].w += v.w;
      }
  float* row = p.part + (size_t)seg * p.k * p.k * CO * p.cin;
#pragma unroll
  for (int l = 0; l < LW; ++l) {
    const int dx = rho * LW + l;
    if (dx >= p.k) break;
#pragma unroll
    for (int o = 0; o < CO; ++o)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = (sc0 + my_sc) * 4 + e;
        if (c < p.cin) row[((size_t)(dy * p.k + dx) * CO + o) * p.cin + c] = gen_comp(acc[l][o], e);
      }
  }
}

// dx in bf16 on `mma.sync`: D[q][c] (16 input pixels x 8 channels) +=
// A[q][(tap pair, o)] B[(tap pair, o)][c]: a k16 step is two taps x the 8
// outputs (Cout padded to 8), each 8 x 8 quarter of A an `ldmatrix` of the
// staged dacc row at its own tap's shifted columns. A CTA: GM_TH input rows
// x GM_NPX columns (two warps a row, two m16 tiles each) x GX_CB channels.
// W as (k, channel blocks, runs * run, GX_CB, 8) bf16: (tap row, block,
// run * run + r, c, o) holds tap dx = run * run + run - 1 - r, zero past k,
// Cin and Cout. y is staged in shared memory and leaves in whole rows.
constexpr int GX_CB = 80;    // channels a block: ten n8 tiles
constexpr int GX_RUN = 16;   // most taps a run (even: pairs)
constexpr int GX_YP = GX_CB + 8;  // the staged dx's pixel pitch, elements

__host__ __device__ inline int gen_dx_bf16_smem(int run) {
  const int ring = ((GM_TH + GEN_D) * (GM_NPX + run) + (GEN_D + 1) * run * GX_CB) * 16;
  const int ys = GM_TH * GM_NPX * GX_YP * 2;
  return ring > ys ? ring : ys;
}

__global__ void __launch_bounds__(GEN_THREADS, 2) pconv_gen_dx_bf16(const GenParams p) {
  extern __shared__ __align__(16) uint4 gen_smem[];
  constexpr int S = GM_TH + GEN_D;
  const int run = p.run, npx = GM_NPX + run, wu = run * GX_CB;
  uint4* rows = gen_smem;
  uint4* wts = rows + S * npx;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, t = warp >> 1, half = warp & 1;
  const int ncb = (p.cin + GX_CB - 1) / GX_CB, cb = blockIdx.x % ncb;
  const int iw0 = blockIdx.x / ncb * GM_NPX, ih0 = blockIdx.y * GM_TH, n = blockIdx.z;
  const int ntn = (min(GX_CB, p.cin - cb * GX_CB) + 7) / 8;  // n8 tiles with channels
  const int per = GM_TH + p.k - 1, nrun = (p.k + run - 1) / run;
  const uint4* wk = static_cast<const uint4*>(p.wk);
  float acc[2][GX_CB / 8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < GX_CB / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  for (int rho = 0; rho < nrun; ++rho) {
    const int oc0 = iw0 + p.pw - rho * run - run + 1;  // dacc column of slot column 0
    auto fill = [&](int r) {
      gen_stage_row(p.dm, n, p.hout, 1, p.wout, ih0 + p.ph - (p.k - 1) + r, 0, 1, oc0, npx,
                    rows + (r % S) * npx, tid, GEN_THREADS);
      if (r >= GM_TH - 1) {
        const int j = r - (GM_TH - 1), dy = p.k - 1 - j;
        uint4* ws = wts + (j % (GEN_D + 1)) * wu;
        const uint4* src = wk + (((size_t)dy * ncb + cb) * nrun * run + rho * run) * GX_CB;
        for (int i = tid; i < wu; i += GEN_THREADS) cp_async16(smem_u32(ws + i), src + i, 16);
      }
    };
    int queued = 0;
    for (int j = 0; j < p.k; ++j) {
      const int hi = j + GM_TH - 1;
      __syncthreads();
      for (; queued <= hi + GEN_D; ++queued) {
        if (queued < per) fill(queued);
        cp_async_commit();
      }
      cp_async_wait<GEN_D>();
      __syncthreads();
      const uint32_t dr = smem_u32(rows + ((t + j) % S) * npx);
      const uint32_t ws = smem_u32(wts + (j % (GEN_D + 1)) * wu);
      for (int d = 0; d < run; d += 2) {  // taps d and d + 1 of the run, reversed
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldmatrix_x4(a[mt], dr + (half * 32 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8 + d +
                                   (lane >> 4)) * 16);
#pragma unroll
        for (int nt2 = 0; nt2 < GX_CB / 16; ++nt2) {
          if (2 * nt2 >= ntn) break;
          uint32_t bb[4];
          ldmatrix_x4(bb, ws + ((d + ((lane >> 3) & 1)) * GX_CB + (2 * nt2 + (lane >> 4)) * 8 +
                                (lane & 7)) * 16);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(acc[mt][2 * nt2], a[mt], bb[0], bb[1]);
            mma_bf16(acc[mt][2 * nt2 + 1], a[mt], bb[2], bb[3]);
          }
        }
      }
    }
    cp_async_wait<0>();
  }
  __syncthreads();  // the ring is free: dx rows, rounded once, go there
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(gen_smem);  // [GM_TH][GM_NPX][GX_YP]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < GX_CB / 8; ++nt)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int q = half * 32 + mt * 16 + (lane >> 2) + 8 * h2, c = nt * 8 + 2 * (lane & 3);
        *reinterpret_cast<__nv_bfloat162*>(ys + (t * GM_NPX + q) * GX_YP + c) =
            __floats2bfloat162_rn(acc[mt][nt][2 * h2], acc[mt][nt][2 * h2 + 1]);
      }
  __syncthreads();
  const __nv_bfloat16* mask = static_cast<const __nv_bfloat16*>(p.mask);
  __nv_bfloat16* dx = static_cast<__nv_bfloat16*>(p.y);
  const int c0 = cb * GX_CB, nc = min(GX_CB, p.cin - c0), cols = min(GM_NPX, p.w - iw0);
  for (int i = tid; i < GM_TH * cols * nc; i += GEN_THREADS) {
    const int c = i % nc, q = i / nc % cols, tr = i / nc / cols, ih = ih0 + tr;
    if (ih >= p.h) break;
    const size_t pix = ((size_t)n * p.h + ih) * p.w + iw0 + q;
    const float m = to_f32(mask[pix * p.g + group_of(p.groups + p.g, p.g, c0 + c)]);
    dx[pix * p.cin + c0 + c] = masked(ys[(tr * GM_NPX + q) * GX_YP + c], m);
  }
}

// dW in bf16 on `mma.sync`: D[(tap pair, o)][c] += A[(tap pair, o)][q]
// B[q][c] over 16 input pixels q a k16 step, A = dacc^T and B = x * M both
// read with `ldmatrix.trans` from the staged rows, each quarter of A at its
// own tap's shifted columns. One CTA per (segment, group of tap pairs and
// a GX_CB-channel block, tap row dy), dy fastest, so the k CTAs that read
// a segment's rows run together and find them in L2: it walks the
// segment's (row, 64-column strip) items for its dy; warp w takes tap pair
// w % np of its group (GD_PAIRS at most) and pixel group w / np of each
// item's four k16 steps, with all ten n8 tiles of the block. The pixel
// groups add in order in shared memory.
constexpr int GD_PAIRS = 8;  // tap pairs of a CTA

__host__ __device__ inline int gen_dw_bf16_smem(int np) {
  const int npg = GEN_THREADS / 32 / np;
  const int ring = (1 + GEN_D) * ((GX_CB / 8) * GW_TW + GW_TW + 2 * GD_PAIRS) * 16;
  const int red = (npg - 1) * np * 32 * (GX_CB / 8) * 4 * 4;
  return ring > red ? ring : red;
}

__global__ void __launch_bounds__(GEN_THREADS, 2) pconv_gen_dw_bf16(const GenParams p) {
  extern __shared__ __align__(16) uint4 gen_smem[];
  constexpr int S = 1 + GEN_D, XU = GX_CB / 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, dy = blockIdx.x % p.k;
  const int pairs = (p.k + 1) / 2, pgn = (pairs + GD_PAIRS - 1) / GD_PAIRS;
  const int ngr = pgn * ((p.cin + GX_CB - 1) / GX_CB), grp = blockIdx.x / p.k % ngr;
  const int pr0 = grp % pgn * GD_PAIRS, cb = grp / pgn;
  const int np = min(GD_PAIRS, pairs - pr0);     // pairs of this CTA
  const int npg = GEN_THREADS / 32 / np;          // pixel groups
  const int pr = pr0 + warp % np, pg = warp / np;
  const bool act = pg < npg;
  const int u0 = cb * XU, ntn = (min(GX_CB, p.cin - cb * GX_CB) + 7) / 8;
  const int strips = (p.w + GW_TW - 1) / GW_TW, seg = blockIdx.x / p.k / ngr;
  const int it0 = seg * p.rb, nrows = min(p.rb, p.n * p.h * strips - it0);  // below 2^31
  const int npxd = GW_TW + 2 * np, slot = XU * GW_TW + npxd;
  // the CTA's taps are 2 pr0 .. 2 (pr0 + np) - 1; dacc slot column of input
  // column q at tap dx: q + 2 (pr0 + np) - 1 - dx
  auto where = [&](int r, int& n, int& ih, int& iw0) {
    const int gi = it0 + r, row = gi / strips;
    iw0 = (gi - row * strips) * GW_TW;
    n = row / p.h;
    ih = row - n * p.h;
  };
  auto fill = [&](int r) {
    int n, ih, iw0;
    where(r, n, ih, iw0);
    uint4* st = gen_smem + (r % S) * slot;
    gen_stage_row(p.xm, n, p.h, p.xu, p.w, ih, u0, XU, iw0, GW_TW, st, tid, GEN_THREADS);
    gen_stage_row(p.dm, n, p.hout, 1, p.wout, ih + p.ph - dy, 0, 1,
                  iw0 + p.pw - 2 * (pr0 + np) + 1, npxd, st + XU * GW_TW, tid, GEN_THREADS);
  };
  float acc[XU][4];
#pragma unroll
  for (int nt = 0; nt < XU; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  const int dxa = 2 * pr, tapoff = 2 * (pr0 + np) - 1 - dxa;  // slot column of q at tap dxa
  int queued = 0;
  for (int r = 0; r < nrows; ++r) {
    __syncthreads();
    for (; queued <= r + GEN_D; ++queued) {
      if (queued < nrows) fill(queued);
      cp_async_commit();
    }
    cp_async_wait<GEN_D>();
    __syncthreads();
    int n, ih, iw0;
    where(r, n, ih, iw0);
    const int oh = ih + p.ph - dy;
    if (!act || oh < 0 || oh >= p.hout) continue;
    const uint32_t xs = smem_u32(gen_smem + (r % S) * slot), ds = xs + XU * GW_TW * 16;
    for (int ks = pg; ks < GW_TW / 16; ks += npg) {
      if (iw0 + ks * 16 >= p.w) break;
      uint32_t a[4];
      ldmatrix_x4_trans(a, ds + (ks * 16 + (lane & 7) + (lane >> 4) * 8 + tapoff -
                                 ((lane >> 3) & 1)) * 16);
#pragma unroll
      for (int nt2 = 0; nt2 < XU / 2; ++nt2) {
        if (2 * nt2 >= ntn) break;
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, xs + ((2 * nt2 + (lane >> 4)) * GW_TW + ks * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * 16);
        mma_bf16(acc[2 * nt2], a, bb[0], bb[1]);
        mma_bf16(acc[2 * nt2 + 1], a, bb[2], bb[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the pixel groups' sums go there
  float4* red = reinterpret_cast<float4*>(gen_smem);
  const int slotr = (warp % np) * 32 + lane;
  if (act && pg > 0)
#pragma unroll
    for (int nt = 0; nt < XU; ++nt)
      red[((pg - 1) * np * 32 + slotr) * XU + nt] =
          make_float4(acc[nt][0], acc[nt][1], acc[nt][2], acc[nt][3]);
  __syncthreads();
  if (!act || pg > 0) return;
  for (int q = 1; q < npg; ++q)
#pragma unroll
    for (int nt = 0; nt < XU; ++nt) {
      const float4 v = red[((q - 1) * np * 32 + slotr) * XU + nt];
      acc[nt][0] += v.x;
      acc[nt][1] += v.y;
      acc[nt][2] += v.z;
      acc[nt][3] += v.w;
    }
  float* row = p.part + (size_t)seg * p.k * p.k * p.cout * p.cin;
#pragma unroll
  for (int nt = 0; nt < XU; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = (lane >> 2) + 8 * (e >> 1), o = m & 7, dx = dxa + (m >> 3);
      const int c = cb * GX_CB + nt * 8 + 2 * (lane & 3) + (e & 1);
      if (o < p.cout && dx < p.k && c < p.cin)
        row[((size_t)(dy * p.k + dx) * p.cout + o) * p.cin + c] = acc[nt][e];
    }
}

template <typename T>
cudaError_t gen_relay(const T* src, const T* mask, const int* starts, uint4* dst, long long rows,
                      int cols, int c, int g, int units, cudaStream_t s) {
  if (reinterpret_cast<uintptr_t>(src) & 15) return cudaErrorMisalignedAddress;
  const long long pixels = rows * cols;
  const int ub = gen_relay_ub(units);
  const dim3 grid((unsigned)((pixels + GR_PIX - 1) / GR_PIX), (unsigned)((units + ub - 1) / ub));
  pconv_gen_relay<T><<<grid, 256, GR_PIX * (4 * ub + 9) * 4, s>>>(src, mask, starts, dst, pixels,
                                                                 cols, c, g, units);
  return cudaGetLastError();
}

template <typename K>
cudaError_t gen_launch(K kernel, dim3 grid, int smem, const GenParams& p, cudaStream_t s) {
  if (smem > 227 * 1024 || grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, GEN_THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gen_fwd(const GenParams& p, const T* x, const T* mask, cudaStream_t s) {
  cudaError_t e = gen_relay<T>(x, mask, p.groups + p.g, const_cast<uint4*>(p.xm),
                               (long long)p.n * p.h, p.w, p.cin, p.g, p.xu, s);
  if (e != cudaSuccess) return e;
  const long long total = (long long)p.n * p.h * p.wout, blocks = (total + 255) / 256;
  pconv_gen_rowsum<T><<<(unsigned)(blocks < 8192 ? blocks : 8192), 256, 0, s>>>(
      mask, p.groups, const_cast<float*>(p.rsum), (long long)p.n * p.h, p.w, p.g, p.wout, p.k,
      p.pw);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if constexpr (sizeof(T) == 2) {
    const dim3 grid((unsigned)((p.wout + GM_NPX - p.run) / (GM_NPX - p.run + 1)),
                    (unsigned)((p.hout + GM_TH - 1) / GM_TH), (unsigned)p.n);
    return gen_launch(pconv_gen_fwd_bf16, grid, gen_fwd_bf16_smem(p.cbu), p, s);
  } else {
    const dim3 grid((unsigned)((p.wout + GEN_TW - 1) / GEN_TW),
                    (unsigned)((p.hout + GEN_TH - 1) / GEN_TH), (unsigned)p.n);
    const int smem = gen_fwd_f32_smem(p.cbu, p.run, p.cout);
    switch (p.cout) {
#define GEN_FWD(CO) \
  case CO: return gen_launch(pconv_gen_fwd_f32<CO>, grid, smem, p, s);
      GEN_FWD(1) GEN_FWD(2) GEN_FWD(3) GEN_FWD(4) GEN_FWD(5) GEN_FWD(6) GEN_FWD(7)
#undef GEN_FWD
      default: return cudaErrorInvalidValue;
    }
  }
}

template <typename T>
cudaError_t launch_gen_bwd(const GenParams& p, const T* dacc, const T* x, const T* mask,
                           int dx_run, bool need_dx, bool need_dw, int segs, cudaStream_t s) {
  cudaError_t e = gen_relay<T>(dacc, nullptr, nullptr, const_cast<uint4*>(p.dm),
                               (long long)p.n * p.hout, p.wout, p.cout, 1, p.du, s);
  if (e != cudaSuccess) return e;
  if (need_dx) {
    GenParams q = p;
    q.run = dx_run;
    if constexpr (sizeof(T) == 2) {
      const dim3 grid((unsigned)((p.w + GM_NPX - 1) / GM_NPX * ((p.cin + GX_CB - 1) / GX_CB)),
                      (unsigned)((p.h + GM_TH - 1) / GM_TH), (unsigned)p.n);
      e = gen_launch(pconv_gen_dx_bf16, grid, gen_dx_bf16_smem(dx_run), q, s);
    } else {
      const dim3 grid((unsigned)((p.w + GEN_TW - 1) / GEN_TW * ((p.cin + 7) / 8)),
                      (unsigned)((p.h + GEN_TH - 1) / GEN_TH), (unsigned)p.n);
      const int smem = gen_dx_f32_smem(p.du, dx_run, p.cout);
      switch (p.cout) {
#define GEN_DX(CO) \
  case CO: e = gen_launch(pconv_gen_dx_f32<CO>, grid, smem, q, s); break;
        GEN_DX(1) GEN_DX(2) GEN_DX(3) GEN_DX(4) GEN_DX(5) GEN_DX(6) GEN_DX(7)
#undef GEN_DX
        default: return cudaErrorInvalidValue;
      }
    }
    if (e != cudaSuccess) return e;
  }
  if (need_dw) {
    if ((long long)p.n * p.h * ((p.w + GW_TW - 1) / GW_TW) >= (1ll << 31))
      return cudaErrorInvalidValue;  // dW's (row, strip) items are counted in 32 bits
    e = gen_relay<T>(x, mask, p.groups + p.g, const_cast<uint4*>(p.xm), (long long)p.n * p.h,
                     p.w, p.cin, p.g, p.xu, s);
    if (e != cudaSuccess) return e;
    if constexpr (sizeof(T) == 2) {
      const int pairs = (p.k + 1) / 2, np = pairs < GD_PAIRS ? pairs : GD_PAIRS;
      const long long ctas = (long long)segs * p.k * ((pairs + GD_PAIRS - 1) / GD_PAIRS) *
                             ((p.cin + GX_CB - 1) / GX_CB);
      if (ctas >= (1ll << 31)) return cudaErrorInvalidValue;
      return gen_launch(pconv_gen_dw_bf16, dim3((unsigned)ctas), gen_dw_bf16_smem(np), p, s);
    } else {
      const int lw = gen_dw_taps(p.cout), nrw = (p.k + lw - 1) / lw;
      const int groups = (nrw + p.rg - 1) / p.rg * (((p.cin + 3) / 4 + p.scg - 1) / p.scg);
      const long long ctas = (long long)segs * groups * p.k;
      if (ctas >= (1ll << 31)) return cudaErrorInvalidValue;
      const dim3 grid((unsigned)ctas);
      const int smem = gen_dw_f32_smem(p.du, p.cout, p.rg, p.scg, p.npg);
      switch (p.cout) {
#define GEN_DW(CO) \
  case CO: e = gen_launch(pconv_gen_dw_f32<CO>, grid, smem, p, s); break;
        GEN_DW(1) GEN_DW(2) GEN_DW(3) GEN_DW(4) GEN_DW(5) GEN_DW(6) GEN_DW(7)
#undef GEN_DW
        default: return cudaErrorInvalidValue;
      }
    }
  }
  return e;
}

// out[c] = sum over r of part[r, c], rows added in a fixed order: thread
// (x, y) adds rows y, y + 8, ... of column x, then the 8 sums in order.
__global__ void __launch_bounds__(256) pconv_colsum(const float* part, float* out, int rows,
                                                    int len) {
  __shared__ float s[8][32];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float v = 0.f;
  if (col < len)
    for (int r = threadIdx.y; r < rows; r += 8) v += part[(size_t)r * len + col];
  s[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && col < len) {
    float t = s[0][threadIdx.x];
    for (int y = 1; y < 8; ++y) t += s[y][threadIdx.x];
    out[col] = t;
  }
}

Params make_params(const void* x, const void* mask, const void* w, const void* bias, void* y,
                   void* mask_out, int n, int h, int w_in, int cin, int g, int size0, int size1,
                   int hout, int wout, int cout, int cin_p, int cout_p, int k, int ph, int pw);

template <typename T>
int launch_k3_prep(const void* gout, const void* mask, void* dacc, void* partial, int n, int h,
                   int w_in, int cin, int g, int size0, int size1, int hout, int wout, int cout,
                   int k, int ph, int pw, int grid, int need_db, const void* groups,
                   void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  Params p = make_params(nullptr, mask, nullptr, nullptr, dacc, nullptr, n, h, w_in, cin, g, size0,
                         size1, hout, wout, cout, cin, cout, k, ph, pw);
  p.groups = static_cast<const int*>(groups);
  p.gout = static_cast<const __nv_bfloat16*>(gout);
  p.partial = static_cast<float*>(partial);
  p.need_db = need_db;
  if (grid < 1 || (need_db && partial == nullptr) || g < 1 || (g > 2 && groups == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = cout % VEC == 0 && !((reinterpret_cast<uintptr_t>(gout) |
                                         reinterpret_cast<uintptr_t>(dacc)) & 15);
  if (vec)
    pconv_k3_prep<T, VEC><<<grid, K3_THREADS, 0, s>>>(p);
  else
    pconv_k3_prep<T, 1><<<grid, K3_THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k3_mask(const void* x, const void* mask, void* out, long long pixels, int c, int g,
                   int size0, const void* groups, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = c % VEC == 0 && !((reinterpret_cast<uintptr_t>(x) |
                                      reinterpret_cast<uintptr_t>(out)) & 15);
  const long long items = pixels * (vec ? c / VEC : c);
  if (items <= 0 || items >= (1ll << 31) || g < 1 || (g > 2 && groups == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto* gt = static_cast<const int*>(groups);
  const unsigned grid = (unsigned)((items + K3_THREADS - 1) / K3_THREADS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const T*>(x);
  const auto* mp = static_cast<const T*>(mask);
  auto* op = static_cast<T*>(out);
  if (vec)
    pconv_k3_mask<T, VEC><<<grid, K3_THREADS, 0, s>>>(xp, mp, op, (unsigned)items, c, g, size0, gt);
  else
    pconv_k3_mask<T, 1><<<grid, K3_THREADS, 0, s>>>(xp, mp, op, (unsigned)items, c, g, size0, gt);
  return (int)cudaGetLastError();
}

Params make_params(const void* x, const void* mask, const void* w, const void* bias, void* y,
                   void* mask_out, int n, int h, int w_in, int cin, int g, int size0, int size1,
                   int hout, int wout, int cout, int cin_p, int cout_p, int k, int ph, int pw) {
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.mask = static_cast<const __nv_bfloat16*>(mask);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.mask_out = static_cast<__nv_bfloat16*>(mask_out);
  p.partial = nullptr;
  p.n = n; p.h = h; p.w_in = w_in; p.cin = cin; p.g = g; p.size0 = size0; p.size1 = size1;
  p.hout = hout; p.wout = wout; p.cout = cout; p.cin_p = cin_p; p.cout_p = cout_p;
  p.k = k; p.ph = ph; p.pw = pw;
  p.cin_x = cin; p.gb = size0; p.splits = 1;
  p.gout = nullptr; p.dx = nullptr;
  p.x_bytes = (size_t)n * h * w_in * cin * sizeof(__nv_bfloat16);
  p.cb = 0; p.nblk = 0; p.kj = 0;
  p.need_dx = p.need_dw = p.need_db = 0;
  p.groups = nullptr;
  return p;
}

}  // namespace

extern "C" {

// K1. x: (n, h, w_in, cin_x) bf16, 16-byte aligned, cin_x % 8 == 0, group 1
// from channel gb (gb % 8 == 0); w: (k*k, cout_p, cin_p) bf16 with
// cin_p % 64 == 0, cout_p % 8 == 0, zero where x has no channel; bias:
// (cout_p) f32 or NULL; partial: (splits, n*hout*wout, cout_p) f32 when
// splits > 1; (bm, bn) in {128} x {64, 128, 256} or {256} x {64, 128};
// ph, pw: the zero padding of H and of W; halo: the halo form (k 3, an output
// width that is a multiple of 64 and of bm or a divisor of it, Hout*Wout a
// multiple of bm;
// (bm, bn) in {(128, 64), (128, 128), (256, 64)}). cin, size0, size1: the layer's own
// channel counts (for the renormalisation); groups: the group table at g > 2
// (not in the halo form), else NULL.
int tsii_pconv_k1(const void* x, const void* mask, const void* w, const void* bias, void* y,
                  void* mask_out, void* partial, int n, int h, int w_in, int cin, int g,
                  int size0, int size1, int hout, int wout, int cout, int cin_x, int gb,
                  int cin_p, int cout_p, int k, int ph, int pw, int splits, int bm, int bn,
                  int halo, const void* groups, void* stream) {
  Params p = make_params(x, mask, w, bias, y, mask_out, n, h, w_in, cin, g, size0, size1, hout,
                         wout, cout, cin_p, cout_p, k, ph, pw);
  p.groups = static_cast<const int*>(groups);
  p.partial = static_cast<float*>(partial);
  p.cin_x = cin_x;
  p.gb = gb;
  p.splits = splits;
  if (cin_x % 8 || gb % 8 || cin_p % K1_BK || cout_p % 8 || splits < 1 ||
      splits > k * k * (cin_p / K1_BK) || (splits > 1 && partial == nullptr) || g < 1 ||
      (g > 2 && (groups == nullptr || halo)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (halo) {
    // every m64 tile in one image row, no tile across two images
    const bool fits = k == 3 && wout % 64 == 0 && (wout % bm == 0 || bm % wout == 0) &&
                      ((long long)hout * wout) % bm == 0;
    if (!fits) return (int)cudaErrorInvalidValue;
    switch (bm * 1000 + bn) {
      case 128064: return (int)launch_k1_halo<64, 1>(p, s);
      case 128128: return (int)launch_k1_halo<128, 1>(p, s);
      case 256064: return (int)launch_k1_halo<64, 2>(p, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (bm * 1000 + bn) {
    case 128064: return (int)launch_k1<64, 1>(p, s);
    case 128128: return (int)launch_k1<128, 1>(p, s);
    case 128256: return (int)launch_k1<256, 1>(p, s);
    case 256064: return (int)launch_k1<64, 2>(p, s);
    case 256128: return (int)launch_k1<128, 2>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Whether K2's geometry is one the kernels take: cb a multiple of 16 up to
// K2_CB_MAX, and for the backward kj a multiple of 16.
static bool k2_geometry_ok(int cout, int cb, int nblk, int cin, int kj) {
  return cout >= 1 && cout < K2_NPAD && cb >= 16 && cb <= K2_CB_MAX && cb % 16 == 0 &&
         nblk >= 1 && (long long)nblk * cb >= cin && kj % 16 == 0;
}

// K2. x: 16-byte aligned; w: (nblk, k*k, 8, cb) bf16, zero where there is
// no channel or output; 1 <= cout <= 7; bias: (cout) f32 or NULL.
int tsii_pconv_k2(const void* x, const void* mask, const void* w, const void* bias, void* y,
                  void* mask_out, int n, int h, int w_in, int cin, int g, int size0, int size1,
                  int hout, int wout, int cout, int k, int ph, int pw, int cb, int nblk,
                  void* stream) {
  Params p = make_params(x, mask, w, bias, y, mask_out, n, h, w_in, cin, g, size0, size1, hout,
                         wout, cout, cin, cout, k, ph, pw);
  p.cb = cb;
  p.nblk = nblk;
  if (!k2_geometry_ok(cout, cb, nblk, cin, 0) || g < 1 || g > 2 ||
      (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(w) & 15))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cb / 16) {
    case 1: return (int)launch_k2<1>(p, s);
    case 2: return (int)launch_k2<2>(p, s);
    case 3: return (int)launch_k2<3>(p, s);
    case 4: return (int)launch_k2<4>(p, s);
    default: return (int)launch_k2<K2_CB_MAX / 16>(p, s);
  }
}

// K2's backward. gout: (n, hout, wout, cout) bf16; w: (nblk * cb, kj) bf16,
// row c column tap * cout + o, zero elsewhere; dx: (n, h, w_in, cin) bf16 or
// NULL; partial: (grid, kj * nblk * cb + 8) f32, each CTA's dW as (kj,
// nblk * cb) and then its db.
int tsii_pconv_k2_bwd(const void* gout, const void* x, const void* mask, const void* w, void* dx,
                      void* partial, int n, int h, int w_in, int cin, int g, int size0,
                      int size1, int hout, int wout, int cout, int k, int ph, int pw, int cb,
                      int nblk, int kj, int grid, int need_dx, int need_dw, int need_db, void* stream) {
  Params p = make_params(x, mask, w, nullptr, nullptr, nullptr, n, h, w_in, cin, g, size0, size1,
                         hout, wout, cout, cin, cout, k, ph, pw);
  p.gout = static_cast<const __nv_bfloat16*>(gout);
  p.dx = static_cast<__nv_bfloat16*>(dx);
  p.partial = static_cast<float*>(partial);
  p.cb = cb;
  p.nblk = nblk;
  p.kj = kj;
  p.need_dx = need_dx && dx != nullptr;
  p.need_dw = need_dw;
  p.need_db = need_db;
  if (!k2_geometry_ok(cout, cb, nblk, cin, kj) || kj < k * k * cout || grid < 1 || g < 1 || g > 2 ||
      partial == nullptr || (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(w) & 15))
    return (int)cudaErrorInvalidValue;
  return (int)launch_k2_bwd(p, grid, static_cast<cudaStream_t>(stream));
}

// K3's first pass. gout, dacc: (n, hout, wout, cout) bf16 (f32 in the
// _f32 form); partial: (grid, cout) f32 when need_db. cin, size0, size1, k,
// ph, pw: the layer's own (for the window count).
int tsii_pconv_k3_prep(const void* gout, const void* mask, void* dacc, void* partial, int n, int h,
                       int w_in, int cin, int g, int size0, int size1, int hout, int wout,
                       int cout, int k, int ph, int pw, int grid, int need_db, const void* groups,
                       void* stream) {
  return launch_k3_prep<__nv_bfloat16>(gout, mask, dacc, partial, n, h, w_in, cin, g, size0,
                                       size1, hout, wout, cout, k, ph, pw, grid, need_db, groups,
                                       stream);
}
int tsii_pconv_k3_prep_f32(const void* gout, const void* mask, void* dacc, void* partial, int n,
                           int h, int w_in, int cin, int g, int size0, int size1, int hout,
                           int wout, int cout, int k, int ph, int pw, int grid, int need_db,
                           const void* groups, void* stream) {
  return launch_k3_prep<float>(gout, mask, dacc, partial, n, h, w_in, cin, g, size0, size1, hout,
                               wout, cout, k, ph, pw, grid, need_db, groups, stream);
}

// out = x * M over `pixels` pixels of c channels (out may be x); bf16, or
// f32 in the _f32 form. groups: the group table at g > 2, else NULL.
int tsii_pconv_k3_mask(const void* x, const void* mask, void* out, long long pixels, int c, int g,
                       int size0, const void* groups, void* stream) {
  return launch_k3_mask<__nv_bfloat16>(x, mask, out, pixels, c, g, size0, groups, stream);
}
int tsii_pconv_k3_mask_f32(const void* x, const void* mask, void* out, long long pixels, int c,
                           int g, int size0, const void* groups, void* stream) {
  return launch_k3_mask<float>(x, mask, out, pixels, c, g, size0, groups, stream);
}

// K2F's backward (Cout <= 7, k 1, 3, 5 or 7), after pconv_k3_prep: dacc (n,
// hout, wout, cout) f32; x (n, h, w_in, cin) f32, 16-byte aligned; mask (n,
// h, w_in, g) f32; w (cout, cin, k, k) f32; dx (n, h, w_in, cin) f32 and wk
// (k*k, cout, cin) f32 scratch for the re-laid weights when need_dx; part
// (grid, k*k*cout*cin) f32 when need_dw, row b CTA b's dW as (tap, o, c),
// for pconv_colsum. rb: input rows of a CTA's band, nseg: 32-column
// segments of its strip (k2f_bwd_plan); grid = n * ceil(h / rb) * ceil(w_in
// / (32 nseg)). One or two kernels on `stream`.
int tsii_pconv_k2f_bwd(const void* dacc, const void* x, const void* mask, const void* w, void* dx,
                       void* part, void* wk, int n, int h, int w_in, int cin, int g, int size0,
                       int hout, int wout, int cout, int k, int ph, int pw, int rb, int nseg,
                       int need_dx, int need_dw, void* stream) {
  K2fBwdParams p;
  p.dacc = static_cast<const float*>(dacc);
  p.x = static_cast<const float*>(x);
  p.mask = static_cast<const float*>(mask);
  p.w = static_cast<const float*>(wk);
  p.dx = static_cast<float*>(dx);
  p.part = static_cast<float*>(part);
  p.x_floats = (long long)n * h * w_in * cin;
  p.n = n; p.h = h; p.w_in = w_in; p.cin = cin; p.g = g; p.size0 = size0;
  p.hout = hout; p.wout = wout; p.cout = cout; p.k = k; p.ph = ph; p.pw = pw;
  p.rb = rb; p.nseg = nseg; p.need_dx = need_dx; p.need_dw = need_dw;
  if (n < 1 || h < 1 || w_in < 1 || cin < 1 || (g != 1 && g != 2) || hout < 1 || wout < 1 ||
      rb < 1 || nseg < 1 || nseg > HB_NSEG || nseg * cin > HB_THREADS || !(need_dx || need_dw) ||
      (need_dx && (dx == nullptr || wk == nullptr)) || (need_dw && part == nullptr) ||
      (reinterpret_cast<uintptr_t>(x) & 15))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (need_dx) {
    const int items = cout * cin * k * k;
    pconv_f32_relay<<<(items + 255) / 256, 256, 0, s>>>(static_cast<const float*>(w),
                                                        static_cast<float*>(wk), cout, cin,
                                                        k * k, 1);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
#define K2F_CALL(C, K) return (int)launch_k2f_bwd<C, K>(p, s);
  TSII_K2F_BWD_SWITCH(cout, k, K2F_CALL)
#undef K2F_CALL
}

// K1F: K1's f32 form at Cout >= 8. x: (n, h, w_in, cin) f32; mask: (n, h,
// w_in, g) f32; w: (cout, cin, k, k) f32; bias: (cout) f32 or NULL; y: (n,
// hout, wout, cout) f32; mask_out: (n, hout, wout, 1) f32; scratch: xm (n,
// h + 2 ph, w_in + 2 pw, cin_p) f32, partial (splits, P, cout_p) f32 when
// splits > 1 (else NULL), wk (k*k, cin_p, cout_p) f32, zero past cin and
// cout where they are padded. (bm, bn) (128, 128) or (256, 64), splits as
// ops/kernels/partial_conv.py::k1f_plan gives them; groups: the group table
// at g > 2, else NULL. Three or four kernels on `stream`; returns the first
// error.
int tsii_pconv_k1f(const void* x, const void* mask, const void* w, const void* bias, void* y,
                   void* mask_out, void* xm, void* partial, void* wk, int n, int h, int w_in,
                   int cin, int g, int size0, int size1, int hout, int wout, int cout, int k,
                   int ph, int pw, int cin_p, int cout_p, int bm, int bn, int splits,
                   const void* groups, void* stream) {
  K1fParams p;
  p.groups = static_cast<const int*>(groups);
  p.xm = static_cast<const float*>(xm);
  p.mask = static_cast<const float*>(mask);
  p.w = static_cast<const float*>(wk);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<float*>(y);
  p.mask_out = static_cast<float*>(mask_out);
  p.partial = static_cast<float*>(partial);
  p.n = n; p.h = h; p.w_in = w_in; p.cin = cin; p.g = g; p.size0 = size0; p.size1 = size1;
  p.hout = hout; p.wout = wout; p.cout = cout; p.k = k; p.ph = ph; p.pw = pw;
  p.cin_p = cin_p; p.cout_p = cout_p; p.splits = splits;
  const bool tile = (bm == 128 && bn == 128) || (bm == 256 && bn == 64);
  const long long steps = (long long)k * k * (cin_p / K1F_CK);
  if (n < 1 || cin < 1 || cout < 8 || k < 1 || hout < 1 || wout < 1 || g < 1 ||
      (g > 2 && groups == nullptr) ||
      !tile || cin_p < cin || cin_p % K1F_CK != 0 || cout_p < cout || cout_p % bn != 0 ||
      cout_p / bn > 65535 || splits < 1 || splits > 65535 || splits > steps ||
      (splits > 1) != (partial != nullptr) ||
      (long long)n * (h + 2 * ph) * (w_in + 2 * pw) >= (1ll << 31) ||
      steps >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  pconv_k1f_weights<<<dim3((unsigned)((cin * k * k + 31) / 32), (unsigned)((cout + 31) / 32)),
                      dim3(32, 8), 0, s>>>(static_cast<const float*>(w), static_cast<float*>(wk),
                                           cout, cin, k * k, cin_p, cout_p);
  const long long items = (long long)n * (h + 2 * ph) * (w_in + 2 * pw) * (cin_p / 4);
  pconv_f32_mask<<<(unsigned)((items + 255) / 256), 256, 0, s>>>(p, static_cast<const float*>(x),
                                                                 static_cast<float*>(xm));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)(bm == 128 ? launch_k1f<128, 128>(p, s) : launch_k1f<256, 64>(p, s));
}

// Resident CTAs an SM of pconv_k1f<bm, 16384 / bm> (the occupancy
// calculator's answer), or a negative CUDA error.
int tsii_k1f_occupancy(int bm) {
  int n = 0;
  cudaError_t e = cudaErrorInvalidValue;
  if (bm == 128) {
    e = cudaFuncSetAttribute(pconv_k1f<128, 128>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             K1fTile<128, 128>::SMEM);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, pconv_k1f<128, 128>, K1F_THREADS,
                                                        K1fTile<128, 128>::SMEM);
  } else if (bm == 256) {
    e = cudaFuncSetAttribute(pconv_k1f<256, 64>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             K1fTile<256, 64>::SMEM);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, pconv_k1f<256, 64>, K1F_THREADS,
                                                        K1fTile<256, 64>::SMEM);
  }
  return e == cudaSuccess ? n : -(int)e;
}

// K2F: K2's f32 form (Cout <= 7, k 1, 3, 5 or 7). x: (n, h, w_in, cin) f32,
// 16-byte aligned; mask: (n, h, w_in, g) f32; w: (cout, cin, k, k) f32;
// bias: (cout) f32 or NULL; y: (n, hout, wout, cout) f32; mask_out: (n,
// hout, wout, 1) f32; wk: (k*k, cin, cout) f32 scratch for the re-laid
// weights; rb: output rows of a CTA's band (k2f_plan). Two kernels on
// `stream`.
int tsii_pconv_k2f(const void* x, const void* mask, const void* w, const void* bias, void* y,
                   void* mask_out, void* wk, int n, int h, int w_in, int cin, int g, int size0,
                   int size1, int hout, int wout, int cout, int k, int ph, int pw, int rb,
                   void* stream) {
  K2fParams p;
  p.x = static_cast<const float*>(x);
  p.mask = static_cast<const float*>(mask);
  p.w = static_cast<const float*>(wk);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<float*>(y);
  p.mask_out = static_cast<float*>(mask_out);
  p.x_floats = (long long)n * h * w_in * cin;
  p.n = n; p.h = h; p.w_in = w_in; p.cin = cin; p.g = g; p.size0 = size0; p.size1 = size1;
  p.hout = hout; p.wout = wout; p.cout = cout; p.k = k; p.ph = ph; p.pw = pw; p.rb = rb;
  if (n < 1 || h < 1 || w_in < 1 || cin < 1 || (g != 1 && g != 2) || hout < 1 || wout < 1 ||
      rb < 1 || (reinterpret_cast<uintptr_t>(x) & 15))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int items = cout * cin * k * k;
  pconv_f32_relay<<<(items + 255) / 256, 256, 0, s>>>(static_cast<const float*>(w),
                                                      static_cast<float*>(wk), cout, cin, k * k,
                                                      0);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
#define K2F_CALL(C, K) return (int)launch_k2f<C, K>(p, s);
  TSII_K2F_SWITCH(cout, k, K2F_CALL)
#undef K2F_CALL
}

// Resident CTAs an SM of K2F (bwd 0) or of its backward (bwd 1, nseg
// segments) at Cout 3, k 3 and cin input channels, the U-Net's head (the
// occupancy calculator's answer), or a negative CUDA error.
int tsii_k2f_occupancy(int bwd, int cin, int nseg) {
  int n = 0;
  cudaError_t e;
  if (!bwd) {
    const size_t smem = k2f_smem_bytes(cin, 3, 3);
    e = cudaFuncSetAttribute(pconv_k2f<3, 3>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, pconv_k2f<3, 3>, K2F_THREADS, smem);
  } else {
    const size_t smem = k2f_bwd_smem_bytes(cin, 3, 3, nseg);
    e = cudaFuncSetAttribute(pconv_k2f_bwd<3, 3>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, pconv_k2f_bwd<3, 3>,
                                                        (nseg * cin + 31) / 32 * 32, smem);
  }
  return e == cudaSuccess ? n : -(int)e;
}

// The general forms of K2 and K2F (Cout <= 7) and of their backwards, in
// bf16 (is_f32 = 0) or f32. x, mask: (n, h, w_in, cin), (n, h, w_in, g);
// groups: the group table (any g >= 1); V = 16 / element size.
// Forward: wk the re-laid weights (pconv_gen_fwd_f32 / _bf16), bias (cout)
// f32 or NULL, y (n, hout, wout, cout), mask_out (n, hout, wout, 1); xm a
// scratch of n * h * ceil(cin / V) * w_in 16-byte units, rsum one of
// n * h * wout f32; cbu, run: `gen_plan`'s block and run.
int tsii_pconv_gen_fwd(const void* x, const void* mask, const void* wk, const void* bias, void* y,
                       void* mask_out, const void* groups, void* xm, void* rsum, int n, int h,
                       int w_in, int cin, int g, int hout, int wout, int cout, int k, int ph, int pw,
                       int is_f32, int cbu, int run, void* stream) {
  const int v = is_f32 ? 4 : 8, xu = (cin + v - 1) / v;
  GenParams p{static_cast<const uint4*>(xm), nullptr, wk, static_cast<const float*>(bias),
              static_cast<const float*>(rsum), mask, static_cast<const int*>(groups), y, mask_out,
              nullptr, n, h, w_in, cin, g, hout, wout, cout, k, ph, pw, xu, 0, cbu, run, 0, 0, 0, 0};
  const bool plan_ok = is_f32 ? cbu >= 1 && cbu <= xu && run % GEN_L == 0 && run >= GEN_L &&
                                    run <= GEN_RUN
                              : cbu >= 2 && cbu % 2 == 0 && run >= 1 && run <= GM_RUN &&
                                    run * cout <= GM_MT * 16;
  if (n < 1 || h < 1 || w_in < 1 || cin < 1 || g < 1 || groups == nullptr || cout < 1 ||
      cout > GEN_COUT || k < 1 || hout < 1 || wout < 1 || ph < 0 || pw < 0 || !plan_ok ||
      xm == nullptr || rsum == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_f32 ? launch_gen_fwd<float>(p, static_cast<const float*>(x),
                                              static_cast<const float*>(mask), s)
                      : launch_gen_fwd<__nv_bfloat16>(p, static_cast<const __nv_bfloat16*>(x),
                                                      static_cast<const __nv_bfloat16*>(mask), s));
}

// Backward, after pconv_k3_prep: dacc (n, hout, wout, cout); dm a scratch
// of n * hout * ceil(cout / V) * wout units. need_dx: wk the re-laid
// weights of pconv_gen_dx_bf16 / _f32, dx (n, h, w_in, cin), dx_run its run. need_dw:
// xm a scratch as the forward's, part (segs, k*k*cout*cin) f32 for
// pconv_colsum, rb, rg, scg, npg: `gen_plan`'s segments and groups.
int tsii_pconv_gen_bwd(const void* dacc, const void* x, const void* mask, const void* wk, void* dx,
                       void* part, const void* groups, void* xm, void* dm, int n, int h, int w_in,
                       int cin, int g, int hout, int wout, int cout, int k, int ph, int pw,
                       int is_f32, int need_dx, int need_dw, int dx_run, int rb, int rg, int scg,
                       int npg, int segs, void* stream) {
  const int v = is_f32 ? 4 : 8;
  GenParams p{static_cast<const uint4*>(xm), static_cast<const uint4*>(dm), wk, nullptr, nullptr,
              mask, static_cast<const int*>(groups), dx, nullptr, static_cast<float*>(part),
              n, h, w_in, cin, g, hout, wout, cout, k, ph, pw, (cin + v - 1) / v,
              (cout + v - 1) / v, 0, 0, rb, rg, scg, npg};
  if (n < 1 || h < 1 || w_in < 1 || cin < 1 || g < 1 || groups == nullptr || cout < 1 ||
      cout > GEN_COUT || k < 1 || hout < 1 || wout < 1 || ph < 0 || pw < 0 ||
      !(need_dx || need_dw) || dm == nullptr ||
      (need_dx && (dx == nullptr || wk == nullptr ||
                   (is_f32 ? dx_run < GEN_L || dx_run % GEN_L != 0 || dx_run > GEN_RUN
                           : dx_run < 2 || dx_run % 2 != 0 || dx_run > GX_RUN))) ||
      (need_dw && (part == nullptr || xm == nullptr || rb < 1 || rg < 1 || scg < 1 ||
                   !(npg == 1 || npg == 2 || npg == 4 || npg == 8) || npg * rg * scg > GEN_THREADS ||
                   segs < 1)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_f32 ? launch_gen_bwd<float>(p, static_cast<const float*>(dacc),
                                              static_cast<const float*>(x),
                                              static_cast<const float*>(mask), dx_run, need_dx,
                                              need_dw, segs, s)
                      : launch_gen_bwd<__nv_bfloat16>(
                            p, static_cast<const __nv_bfloat16*>(dacc),
                            static_cast<const __nv_bfloat16*>(x),
                            static_cast<const __nv_bfloat16*>(mask), dx_run, need_dx, need_dw,
                            segs, s));
}

// out[c] = sum_r part[r, c], f32, in a fixed order.
int tsii_pconv_colsum(const void* part, void* out, int rows, int len, void* stream) {
  if (rows < 1 || len < 1) return (int)cudaErrorInvalidValue;
  pconv_colsum<<<(unsigned)((len + 31) / 32), dim3(32, 8), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(out), rows, len);
  return (int)cudaGetLastError();
}

const char* tsii_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
