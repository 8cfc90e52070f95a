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

struct Params {
  const __nv_bfloat16* x;     // K1: (N, H, W, cin_x); K2: (N, H, W, Cin)
  const __nv_bfloat16* mask;  // (N, H, W, G), G in {1, 2}
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
};

__device__ __forceinline__ const __nv_bfloat16* mask_at(const Params& p, int n, int ih, int iw) {
  return p.mask + ((size_t)(n * p.h + ih) * p.w_in + iw) * p.g;
}

// Weighted window count of valid taps: raw per-group counts in f32, then
// one weighting by the group sizes (exact for binary masks). Also the tap
// bits: bit 2 tap + g set when tap `tap` lies in the image and its group-g
// mask is not 0 (taps below 16).
__device__ __forceinline__ float window_scan(const Params& p, int n, int oh, int ow,
                                             unsigned& bits) {
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
  const bool tap_bits = p.k * p.k * 2 <= 32;  // else the producer reads the mask itself
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
      const int grp = (p.g == 2 && ch >= p.gb) ? 1 : 0;
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
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
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
                                                            int size0) {
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
      for (int j = 0; j < VEC; ++j) e[j] = masked(e[j], ch + j < size0 ? m0 : m1);
      *reinterpret_cast<uint4*>(out + at) = v;
    } else {
      out[at] = masked(x[at], ch < size0 ? m0 : m1);
    }
  }
}

// ------------------------------------------------------- the f32 form ----
//
// K1 and K2 in f32, for x.dtype float32 (JAX's Pallas kernels take x's
// dtype as it comes, with f32 accumulators): SIMT FFMA with f32
// accumulation, no TF32 and no bf16 anywhere. K1F (Cout >= 8) is
// `pconv_k1f` below. K2F (Cout <= 7) is `pconv_f32<1, 1>`, a direct
// convolution: a CTA of 256 threads owns a tile of TH x 16 output pixels
// of one image and 8 * CG output channels; each thread PPT pixels (rows of
// the tile, NPT pixel threads apart) x 8 channels. Per chunk of `ck` input channels
// the tile's input window with its halo is staged in shared memory as
// x * M (zero outside the image and past Cin), channel-major so that a
// warp's pixel threads read consecutive words, and the chunk's weights as
// (tap, channel, 8 * CG); the sums run chunk by chunk, tap by tap, channel
// by channel: a fixed order, so two launches give the same bits. The
// epilogue counts each pixel's window (`window_count<float>`), scales,
// adds the bias and zeroes empty windows, as the bf16 kernels do.

struct F32Params {
  const float* x;      // (N, H, W, Cin)
  const float* mask;   // (N, H, W, G)
  const float* w;      // (k*k, Cin, Cout)
  const float* bias;   // (Cout) or nullptr
  float* y;            // (N, Hout, Wout, Cout)
  float* mask_out;     // (N, Hout, Wout, 1)
  int n, h, w_in, cin, g, size0, size1, hout, wout, cout, k, ph, pw, ck;
};

constexpr int F32_THREADS = 256;
constexpr int F32_TW = 16;  // output columns of a tile

template <int CG, int PPT>
struct F32Tile {
  static constexpr int NPT = F32_THREADS / CG;  // pixel threads
  static constexpr int TH = NPT * PPT / F32_TW;  // output rows of a tile
  static constexpr int COT = 8 * CG;             // output channels of a CTA
};

// Shared floats of one chunk's input window, padded to 16 bytes.
__host__ __device__ inline int f32_window(int th, int k) {
  return ((th + k - 1) * (F32_TW + k - 1) + 3) / 4 * 4;
}

template <int CG, int PPT>
__global__ void __launch_bounds__(F32_THREADS) pconv_f32(const F32Params p) {
  using Tile = F32Tile<CG, PPT>;
  extern __shared__ __align__(16) float f32_smem[];
  const int ck = p.ck, kk = p.k * p.k;
  const int ww = F32_TW + p.k - 1, win = f32_window(Tile::TH, p.k);
  float* xs = f32_smem;            // [ck][window]
  float* ws = f32_smem + ck * win;  // [k*k][ck][COT]
  const int tiles_w = (p.wout + F32_TW - 1) / F32_TW;
  const int oh0 = (int)(blockIdx.x / tiles_w) * Tile::TH;
  const int ow0 = (int)(blockIdx.x % tiles_w) * F32_TW;
  const int co0 = blockIdx.y * Tile::COT, n = blockIdx.z;
  const int tid = threadIdx.x, pt = tid % Tile::NPT, cg = tid / Tile::NPT;
  int prow[PPT], pcol[PPT];
  float acc[PPT][8];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    prow[j] = (pt + j * Tile::NPT) / F32_TW;
    pcol[j] = (pt + j * Tile::NPT) % F32_TW;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[j][e] = 0.f;
  }
  const int wrows = Tile::TH + p.k - 1;
  for (int c0 = 0; c0 < p.cin; c0 += ck) {
    __syncthreads();
    for (int i = tid; i < ck * wrows * ww; i += F32_THREADS) {
      const int cc = i % ck, r = i / ck, ty = r / ww, tx = r % ww;
      const int ih = oh0 + ty - p.ph, iw = ow0 + tx - p.pw, c = c0 + cc;
      float v = 0.f;
      if (c < p.cin && ih >= 0 && ih < p.h && iw >= 0 && iw < p.w_in) {
        const size_t pix = ((size_t)n * p.h + ih) * p.w_in + iw;
        v = masked(p.x[pix * p.cin + c], p.mask[pix * p.g + (c < p.size0 ? 0 : 1)]);
      }
      xs[cc * win + r] = v;
    }
    for (int i = tid; i < kk * ck * Tile::COT; i += F32_THREADS) {
      const int co = i % Tile::COT, r = i / Tile::COT, cc = r % ck, tap = r / ck;
      const int c = c0 + cc, o = co0 + co;
      ws[i] = (c < p.cin && o < p.cout) ? p.w[((size_t)tap * p.cin + c) * p.cout + o] : 0.f;
    }
    __syncthreads();
    for (int tap = 0; tap < kk; ++tap) {
      const int dy = tap / p.k, dx = tap - dy * p.k;
      for (int cc = 0; cc < ck; ++cc) {
        const float* wv = ws + (tap * ck + cc) * Tile::COT + cg * 8;
        const float4 wa = *reinterpret_cast<const float4*>(wv);
        const float4 wb = *reinterpret_cast<const float4*>(wv + 4);
        const float* xr = xs + cc * win;
#pragma unroll
        for (int j = 0; j < PPT; ++j) {
          const float xv = xr[(prow[j] + dy) * ww + pcol[j] + dx];
          acc[j][0] = fmaf(xv, wa.x, acc[j][0]);
          acc[j][1] = fmaf(xv, wa.y, acc[j][1]);
          acc[j][2] = fmaf(xv, wa.z, acc[j][2]);
          acc[j][3] = fmaf(xv, wa.w, acc[j][3]);
          acc[j][4] = fmaf(xv, wb.x, acc[j][4]);
          acc[j][5] = fmaf(xv, wb.y, acc[j][5]);
          acc[j][6] = fmaf(xv, wb.z, acc[j][6]);
          acc[j][7] = fmaf(xv, wb.w, acc[j][7]);
        }
      }
    }
  }
  Params q;  // window_count's view of the geometry
  q.mask = reinterpret_cast<const __nv_bfloat16*>(p.mask);
  q.h = p.h; q.w_in = p.w_in; q.g = p.g; q.size0 = p.size0; q.size1 = p.size1;
  q.k = p.k; q.ph = p.ph; q.pw = p.pw;
  const float kkc = (float)(kk * p.cin);
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int oh = oh0 + prow[j], ow = ow0 + pcol[j];
    if (oh >= p.hout || ow >= p.wout) continue;
    const float msum = window_count<float>(q, n, oh, ow);
    const float scale = msum > 0.f ? kkc / fmaxf(msum, 1.f) : 0.f;
    const size_t pix = ((size_t)n * p.hout + oh) * p.wout + ow;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int o = co0 + cg * 8 + e;
      if (o < p.cout) p.y[pix * p.cout + o] = epilogue(acc[j][e], scale, p.bias ? p.bias[o] : 0.f);
    }
    if (blockIdx.y == 0 && cg == 0) p.mask_out[pix] = msum > 0.f ? 1.f : 0.f;
  }
}

template <int CG, int PPT>
cudaError_t launch_f32(F32Params p, cudaStream_t stream) {
  using Tile = F32Tile<CG, PPT>;
  const int kk = p.k * p.k, win = f32_window(Tile::TH, p.k);
  int ck = 8;  // input channels per staged chunk: as many of 8, 4, 2, 1 as fit
  while (ck > 1 && (size_t)ck * (win + kk * Tile::COT) * sizeof(float) > 200 * 1024) ck /= 2;
  const size_t smem = (size_t)ck * (win + kk * Tile::COT) * sizeof(float);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  p.ck = ck;
  cudaError_t e = cudaFuncSetAttribute(pconv_f32<CG, PPT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long tiles = (long long)((p.hout + Tile::TH - 1) / Tile::TH) *
                          ((p.wout + F32_TW - 1) / F32_TW);
  const int cot = (p.cout + Tile::COT - 1) / Tile::COT;
  if (tiles >= (1ll << 31) || cot > 65535 || p.n > 65535) return cudaErrorInvalidValue;
  pconv_f32<CG, PPT><<<dim3((unsigned)tiles, cot, p.n), F32_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
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
};

// The part of `Params` that window_count reads.
__device__ __forceinline__ Params k1f_count_params(const K1fParams& p) {
  Params q;
  q.mask = reinterpret_cast<const __nv_bfloat16*>(p.mask);
  q.h = p.h; q.w_in = p.w_in; q.g = p.g; q.size0 = p.size0; q.size1 = p.size1;
  q.k = p.k; q.ph = p.ph; q.pw = p.pw;
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
    for (int e = 0; e < 4; ++e)
      if (c + e < p.cin) v[e] = masked(x[ip * p.cin + c + e], c + e < p.size0 ? m0 : m1);
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

// The f32 form of K2's backward (Cout <= 7), after `pconv_k3_prep` has
// written dacc = g * scale (f32) and db. Two SIMT kernels, FFMA in f32:
//   - `pconv_f32_bwd_dx`: dx = conv_transpose(dacc, W) * M. A CTA owns 16 x
//     16 input pixels of one image, a thread one pixel: the tile's window
//     of dacc (k - 1 rows and columns more, 8 slots a pixel) and a chunk of
//     16 input channels of the weights are staged in shared memory; for
//     each tap and output channel a thread reads its dacc value once and
//     adds it times the chunk's 16 weights (a broadcast) into 16 sums.
//   - `pconv_f32_bwd_dw`: dW = corr(x * M, dacc). A thread owns one (input
//     channel, tap) pair of a chunk of 256 / k^2 channels (at most 32) and all Cout
//     outputs; a CTA walks the 16 x 16 output tiles b, b + grid, ... of the
//     batch, staging each tile's x * M window and dacc, and writes its
//     sums as row b of the f32 partials, which `pconv_colsum` adds in a
//     fixed order: two launches give the same bits.

struct F32Bwd {
  const float* dacc;  // (N, Hout, Wout, Cout)
  const float* x;     // (N, H, W, Cin)
  const float* mask;  // (N, H, W, G)
  const float* w;     // (k*k, Cout, Cin)
  float* dx;          // (N, H, W, Cin)
  float* part;        // (grid, k*k*Cout*Cin): row b = CTA b's dW as (tap, o, c)
  int n, h, w_in, cin, g, size0, hout, wout, cout, k, ph, pw;
};

constexpr int F32B_T = 16;   // tile edge, pixels
constexpr int F32B_CC = 16;  // input channels of a dx chunk
constexpr int F32B_O = 8;    // dacc slots a pixel (Cout <= 7)

// Input channels of a dW chunk: a thread per (channel, tap), at most 32.
__host__ __device__ inline int f32b_channels(int kk) { return 256 / kk < 32 ? 256 / kk : 32; }

__global__ void __launch_bounds__(256) pconv_f32_bwd_dx(const F32Bwd p) {
  extern __shared__ __align__(16) float f32b_smem[];
  const int k = p.k, kk = k * k, tid = threadIdx.x;
  const int ww = F32B_T + k - 1;
  float* ds = f32b_smem;                 // [ww * ww][8]: the tile's dacc window
  float* ws = f32b_smem + ww * ww * F32B_O;  // [kk][8][CC]: a chunk of the weights
  const int tiles_w = (p.w_in + F32B_T - 1) / F32B_T;
  const int ih0 = (int)(blockIdx.x / tiles_w) * F32B_T, iw0 = (int)(blockIdx.x % tiles_w) * F32B_T;
  const int n = blockIdx.z;
  // input pixel (ih, iw) takes output (ih - dy + ph, iw - dx + pw) at tap (dy, dx)
  const int oh0 = ih0 + p.ph - (k - 1), ow0 = iw0 + p.pw - (k - 1);
  for (int i = tid; i < ww * ww * F32B_O; i += 256) {
    const int o = i % F32B_O, r = i / F32B_O, oh = oh0 + r / ww, ow = ow0 + r % ww;
    ds[i] = (o < p.cout && oh >= 0 && oh < p.hout && ow >= 0 && ow < p.wout)
                ? p.dacc[(((size_t)n * p.hout + oh) * p.wout + ow) * p.cout + o] : 0.f;
  }
  const int ty = tid / F32B_T, tx = tid % F32B_T, ih = ih0 + ty, iw = iw0 + tx;
  const bool in = ih < p.h && iw < p.w_in;
  const size_t pix = ((size_t)n * p.h + ih) * p.w_in + iw;
  const float m0 = in ? p.mask[pix * p.g] : 0.f;
  const float m1 = in && p.g == 2 ? p.mask[pix * p.g + 1] : m0;
  for (int c0 = 0; c0 < p.cin; c0 += F32B_CC) {
    __syncthreads();
    for (int i = tid; i < kk * F32B_O * F32B_CC; i += 256) {
      const int cc = i % F32B_CC, r = i / F32B_CC, o = r % F32B_O, tap = r / F32B_O;
      const int c = c0 + cc;
      ws[i] = (o < p.cout && c < p.cin) ? p.w[((size_t)tap * p.cout + o) * p.cin + c] : 0.f;
    }
    __syncthreads();
    float acc[F32B_CC];
#pragma unroll
    for (int cc = 0; cc < F32B_CC; ++cc) acc[cc] = 0.f;
    for (int tap = 0; tap < kk; ++tap) {
      const int dy = tap / k, dx = tap - dy * k;
      const float* d = ds + ((ty + k - 1 - dy) * ww + (tx + k - 1 - dx)) * F32B_O;
      for (int o = 0; o < p.cout; ++o) {
        const float dv = d[o];
        const float* wv = ws + (tap * F32B_O + o) * F32B_CC;
#pragma unroll
        for (int cc = 0; cc < F32B_CC; ++cc) acc[cc] = fmaf(dv, wv[cc], acc[cc]);
      }
    }
    if (in) {
#pragma unroll
      for (int cc = 0; cc < F32B_CC; ++cc) {
        const int c = c0 + cc;
        if (c < p.cin) p.dx[pix * p.cin + c] = masked(acc[cc], c < p.size0 ? m0 : m1);
      }
    }
  }
}

__global__ void __launch_bounds__(256) pconv_f32_bwd_dw(const F32Bwd p) {
  extern __shared__ __align__(16) float f32b_smem[];
  const int k = p.k, kk = k * k, tid = threadIdx.x;
  const int ccw = f32b_channels(kk), ww = F32B_T + k - 1, win = ww * ww;
  float* xs = f32b_smem;                       // [ccw][win]: x * M of the tile's window
  float* ds = f32b_smem + ccw * win;           // [256][8]: the tile's dacc
  const int c0 = blockIdx.y * ccw, my_c = tid / kk, tap = tid - my_c * kk;
  const bool act = my_c < ccw && c0 + my_c < p.cin;
  const int dy = tap / k, dx = tap - dy * k;
  const int tiles_w = (p.wout + F32B_T - 1) / F32B_T, tiles_h = (p.hout + F32B_T - 1) / F32B_T;
  const long long tiles = (long long)p.n * tiles_h * tiles_w;
  float acc[F32B_O];
#pragma unroll
  for (int o = 0; o < F32B_O; ++o) acc[o] = 0.f;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int n = (int)(t / (tiles_h * tiles_w)), r0 = (int)(t % (tiles_h * tiles_w));
    const int oh0 = (r0 / tiles_w) * F32B_T, ow0 = (r0 % tiles_w) * F32B_T;
    __syncthreads();
    for (int i = tid; i < ccw * win; i += 256) {
      const int cc = i % ccw, r = i / ccw, c = c0 + cc;
      const int ih = oh0 - p.ph + r / ww, iw = ow0 - p.pw + r % ww;
      float v = 0.f;
      if (c < p.cin && ih >= 0 && ih < p.h && iw >= 0 && iw < p.w_in) {
        const size_t pix = ((size_t)n * p.h + ih) * p.w_in + iw;
        v = masked(p.x[pix * p.cin + c], p.mask[pix * p.g + (c < p.size0 ? 0 : 1)]);
      }
      xs[cc * win + r] = v;
    }
    for (int i = tid; i < F32B_T * F32B_T * F32B_O; i += 256) {
      const int o = i % F32B_O, q = i / F32B_O;
      const int oh = oh0 + q / F32B_T, ow = ow0 + q % F32B_T;
      ds[i] = (o < p.cout && oh < p.hout && ow < p.wout)
                  ? p.dacc[(((size_t)n * p.hout + oh) * p.wout + ow) * p.cout + o] : 0.f;
    }
    __syncthreads();
    if (!act) continue;
    const float* xr = xs + my_c * win + dy * ww + dx;
    for (int py = 0; py < F32B_T; ++py) {
      for (int px = 0; px < F32B_T; ++px) {
        const float xv = xr[py * ww + px];
        const float* d = ds + (py * F32B_T + px) * F32B_O;
#pragma unroll
        for (int o = 0; o < F32B_O; ++o) acc[o] = fmaf(xv, d[o], acc[o]);
      }
    }
  }
  if (act) {
    const size_t row = (size_t)blockIdx.x * kk * p.cout * p.cin;
    for (int o = 0; o < p.cout; ++o)
      p.part[row + ((size_t)tap * p.cout + o) * p.cin + c0 + my_c] = acc[o];
  }
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
                   int k, int ph, int pw, int grid, int need_db, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  Params p = make_params(nullptr, mask, nullptr, nullptr, dacc, nullptr, n, h, w_in, cin, g, size0,
                         size1, hout, wout, cout, cin, cout, k, ph, pw);
  p.gout = static_cast<const __nv_bfloat16*>(gout);
  p.partial = static_cast<float*>(partial);
  p.need_db = need_db;
  if (grid < 1 || (need_db && partial == nullptr)) return (int)cudaErrorInvalidValue;
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
                   int size0, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = c % VEC == 0 && !((reinterpret_cast<uintptr_t>(x) |
                                      reinterpret_cast<uintptr_t>(out)) & 15);
  const long long items = pixels * (vec ? c / VEC : c);
  if (items <= 0 || items >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((items + K3_THREADS - 1) / K3_THREADS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const T*>(x);
  const auto* mp = static_cast<const T*>(mask);
  auto* op = static_cast<T*>(out);
  if (vec)
    pconv_k3_mask<T, VEC><<<grid, K3_THREADS, 0, s>>>(xp, mp, op, (unsigned)items, c, g, size0);
  else
    pconv_k3_mask<T, 1><<<grid, K3_THREADS, 0, s>>>(xp, mp, op, (unsigned)items, c, g, size0);
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
// channel counts (for the renormalisation).
int tsii_pconv_k1(const void* x, const void* mask, const void* w, const void* bias, void* y,
                  void* mask_out, void* partial, int n, int h, int w_in, int cin, int g,
                  int size0, int size1, int hout, int wout, int cout, int cin_x, int gb,
                  int cin_p, int cout_p, int k, int ph, int pw, int splits, int bm, int bn,
                  int halo, void* stream) {
  Params p = make_params(x, mask, w, bias, y, mask_out, n, h, w_in, cin, g, size0, size1, hout,
                         wout, cout, cin_p, cout_p, k, ph, pw);
  p.partial = static_cast<float*>(partial);
  p.cin_x = cin_x;
  p.gb = gb;
  p.splits = splits;
  if (cin_x % 8 || gb % 8 || cin_p % K1_BK || cout_p % 8 || splits < 1 ||
      splits > k * k * (cin_p / K1_BK) || (splits > 1 && partial == nullptr))
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
  if (!k2_geometry_ok(cout, cb, nblk, cin, 0) || (reinterpret_cast<uintptr_t>(x) & 15) ||
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
  if (!k2_geometry_ok(cout, cb, nblk, cin, kj) || kj < k * k * cout || grid < 1 ||
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
                       int cout, int k, int ph, int pw, int grid, int need_db, void* stream) {
  return launch_k3_prep<__nv_bfloat16>(gout, mask, dacc, partial, n, h, w_in, cin, g, size0,
                                       size1, hout, wout, cout, k, ph, pw, grid, need_db, stream);
}
int tsii_pconv_k3_prep_f32(const void* gout, const void* mask, void* dacc, void* partial, int n,
                           int h, int w_in, int cin, int g, int size0, int size1, int hout,
                           int wout, int cout, int k, int ph, int pw, int grid, int need_db,
                           void* stream) {
  return launch_k3_prep<float>(gout, mask, dacc, partial, n, h, w_in, cin, g, size0, size1, hout,
                               wout, cout, k, ph, pw, grid, need_db, stream);
}

// out = x * M over `pixels` pixels of c channels (out may be x); bf16, or
// f32 in the _f32 form.
int tsii_pconv_k3_mask(const void* x, const void* mask, void* out, long long pixels, int c, int g,
                       int size0, void* stream) {
  return launch_k3_mask<__nv_bfloat16>(x, mask, out, pixels, c, g, size0, stream);
}
int tsii_pconv_k3_mask_f32(const void* x, const void* mask, void* out, long long pixels, int c,
                           int g, int size0, void* stream) {
  return launch_k3_mask<float>(x, mask, out, pixels, c, g, size0, stream);
}

// K2's backward in f32 (Cout <= 7), after pconv_k3_prep: dacc (n, hout, wout,
// cout) f32; x (n, h, w_in, cin) f32; mask (n, h, w_in, g) f32; w (k*k, cout,
// cin) f32; dx (n, h, w_in, cin) f32 when need_dx; part (grid, k*k*cout*cin)
// f32 when need_dw, row b CTA b's dW as (tap, o, c), for pconv_colsum.
int tsii_pconv_k2_bwd_f32(const void* dacc, const void* x, const void* mask, const void* w,
                          void* dx, void* part, int n, int h, int w_in, int cin, int g, int size0,
                          int hout, int wout, int cout, int k, int ph, int pw, int grid,
                          int need_dx, int need_dw, void* stream) {
  F32Bwd p;
  p.dacc = static_cast<const float*>(dacc);
  p.x = static_cast<const float*>(x);
  p.mask = static_cast<const float*>(mask);
  p.w = static_cast<const float*>(w);
  p.dx = static_cast<float*>(dx);
  p.part = static_cast<float*>(part);
  p.n = n; p.h = h; p.w_in = w_in; p.cin = cin; p.g = g; p.size0 = size0;
  p.hout = hout; p.wout = wout; p.cout = cout; p.k = k; p.ph = ph; p.pw = pw;
  const int kk = k * k, ww = F32B_T + k - 1;
  if (cout < 1 || cout >= F32B_O || k < 1 || kk > 256 || n > 65535 || grid < 1 ||
      (need_dx && dx == nullptr) || (need_dw && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  if (need_dx) {
    const size_t smem = (size_t)(ww * ww * F32B_O + kk * F32B_O * F32B_CC) * sizeof(float);
    e = cudaFuncSetAttribute(pconv_f32_bwd_dx, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)cudaGetLastError();
    const unsigned tiles = (unsigned)(((h + F32B_T - 1) / F32B_T) * ((w_in + F32B_T - 1) / F32B_T));
    pconv_f32_bwd_dx<<<dim3(tiles, 1, n), 256, smem, s>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (need_dw) {
    const int ccw = f32b_channels(kk);
    const size_t smem = (size_t)(ccw * ww * ww + F32B_T * F32B_T * F32B_O) * sizeof(float);
    e = cudaFuncSetAttribute(pconv_f32_bwd_dw, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)cudaGetLastError();
    pconv_f32_bwd_dw<<<dim3(grid, (cin + ccw - 1) / ccw), 256, smem, s>>>(p);
    e = cudaGetLastError();
  }
  return (int)e;
}

// K1F: K1's f32 form at Cout >= 8. x: (n, h, w_in, cin) f32; mask: (n, h,
// w_in, g) f32; w: (cout, cin, k, k) f32; bias: (cout) f32 or NULL; y: (n,
// hout, wout, cout) f32; mask_out: (n, hout, wout, 1) f32; scratch: xm (n,
// h + 2 ph, w_in + 2 pw, cin_p) f32, partial (splits, P, cout_p) f32 when
// splits > 1 (else NULL), wk (k*k, cin_p, cout_p) f32, zero past cin and
// cout where they are padded. (bm, bn) (128, 128) or (256, 64), splits as
// ops/kernels/partial_conv.py::k1f_plan gives them. Three or four kernels
// on `stream`; returns the first error.
int tsii_pconv_k1f(const void* x, const void* mask, const void* w, const void* bias, void* y,
                   void* mask_out, void* xm, void* partial, void* wk, int n, int h, int w_in,
                   int cin, int g, int size0, int size1, int hout, int wout, int cout, int k,
                   int ph, int pw, int cin_p, int cout_p, int bm, int bn, int splits,
                   void* stream) {
  K1fParams p;
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
  if (n < 1 || cin < 1 || cout < 8 || k < 1 || hout < 1 || wout < 1 || (g != 1 && g != 2) ||
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

// K2F: K2's f32 form (Cout <= 8). x: (n, h, w_in, cin) f32; mask: (n, h, w_in, g) f32;
// w: (k*k, cin, cout) f32; bias: (cout) f32 or NULL; y: (n, hout, wout, cout)
// f32; mask_out: (n, hout, wout, 1) f32.
int tsii_pconv_f32(const void* x, const void* mask, const void* w, const void* bias, void* y,
                   void* mask_out, int n, int h, int w_in, int cin, int g, int size0, int size1,
                   int hout, int wout, int cout, int k, int ph, int pw, void* stream) {
  F32Params p;
  p.x = static_cast<const float*>(x);
  p.mask = static_cast<const float*>(mask);
  p.w = static_cast<const float*>(w);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<float*>(y);
  p.mask_out = static_cast<float*>(mask_out);
  p.n = n; p.h = h; p.w_in = w_in; p.cin = cin; p.g = g; p.size0 = size0; p.size1 = size1;
  p.hout = hout; p.wout = wout; p.cout = cout; p.k = k; p.ph = ph; p.pw = pw; p.ck = 1;
  if (n < 1 || cin < 1 || cout < 1 || cout > 8 || k < 1 || hout < 1 || wout < 1 ||
      (g != 1 && g != 2))
    return (int)cudaErrorInvalidValue;
  return (int)launch_f32<1, 1>(p, static_cast<cudaStream_t>(stream));
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
