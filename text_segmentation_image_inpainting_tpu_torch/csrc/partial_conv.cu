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
// resolution). An N = 3 GEMM cannot feed the tensor cores; the layer is
// bound by reading its input from device memory (at the head 8 x 512^2 x 67
// bf16 = 281 MB, read once plus the halo of each tile). A CTA owns
// 4 x 32 output pixels, one per thread, and walks Cin in chunks of 32
// channels: the (4+k-1) x (32+k-1) input halo of a chunk is loaded with
// neighbouring threads on neighbouring channels (coalesced), multiplied by
// its group's mask (a hole is not read at all) and kept in shared memory
// as f32 with a padded pixel stride, so the per-pixel tap loops read it
// without bank conflicts; the weight chunk sits beside it. Each thread
// keeps its Cout sums in f32 registers.
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
  const __nv_bfloat16* w;     // K1: (k*k, Cout_p, Cin_p); K2: (k*k, Cin, Cout)
  const float* bias;          // (Cout_p) or nullptr
  __nv_bfloat16* y;           // (N, Hout, Wout, Cout)
  __nv_bfloat16* mask_out;    // (N, Hout, Wout, 1)
  float* partial;             // K1 with splits > 1: (splits, P, Cout_p)
  int n, h, w_in, cin, g, size0, size1;  // cin and group sizes as the layer has them
  int hout, wout, cout, cin_p, cout_p, k, pad;
  int cin_x, gb, splits;  // K1: x's channel count, group 1's first channel in x
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
    const int ih = oh + dy - p.pad;
    if (ih < 0 || ih >= p.h) continue;
    for (int dx = 0; dx < p.k; ++dx) {
      const int iw = ow + dx - p.pad;
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
      const int toff = (dy - p.pad) * p.w_in + (dx - p.pad);  // the tap's pixel offset in x
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
          const int ih = ri.y + dy - p.pad, iw = ri.z + dx - p.pad;
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

// The halo form of K1, for 3x3 windows over same-size maps whose width is
// 64 or a multiple of 128 (dec2 and dec1 of the U-Net). A tile of BM
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
    const int ih = oh0 + r + dy - 1, iw = ow0 + col - 1;
    uint8_t ok = 0;
    if (q < halo && ih >= 0 && ih < p.h && iw >= 0 && iw < p.w_in) {
      const unsigned short* m = mbits + ((size_t)(img * p.h + ih) * p.w_in + iw) * p.g;
      ok = ((m[0] & 0x7fff) ? 1 : 0) | ((p.g == 2 && (m[1] & 0x7fff)) ? 2 : 0);
    }
    s_ok[dy][q] = ok;
    if (dy == 0) s_pix[q] = (img * p.h + oh0 + r - 1) * p.w_in + ow0 + col - 1;
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
      const int drow = dy * p.w_in;  // halo row r of step dy is input row oh0 + r + dy - 1
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

// ---------------------------------------------------------------- K2 ----

constexpr int K2_TH = 4;                  // output rows per CTA
constexpr int K2_TW = 32;                 // output columns per CTA: one warp per row
constexpr int K2_THREADS = K2_TH * K2_TW;  // one output pixel per thread
constexpr int K2_CK = 32;                 // input channels staged per step
constexpr int K2_LD = K2_CK + 1;          // padded pixel stride: column reads hit 32 banks

// Dynamic shared memory of K2: the masked input halo (f32), the weight
// chunk (f32) and the halo's two mask groups.
inline size_t k2_smem_bytes(int k, int cout) {
  const int tpix = (K2_TH + k - 1) * (K2_TW + k - 1);
  return sizeof(float) * ((size_t)tpix * K2_LD + (size_t)k * k * K2_CK * cout + 2 * tpix);
}

template <int COUT>
__global__ void __launch_bounds__(K2_THREADS) pconv_k2(Params p) {
  extern __shared__ float smem[];
  const int k = p.k;
  const int tiw = K2_TW + k - 1, tpix = (K2_TH + k - 1) * tiw;
  float* xs = smem;                         // (tpix, K2_LD) masked x, one channel chunk
  float* ws = xs + tpix * K2_LD;            // (k*k, K2_CK, COUT) weight chunk
  float* ms = ws + k * k * K2_CK * COUT;    // (tpix, 2) mask groups, 0 outside the image

  const int tid = threadIdx.x, tx = tid % K2_TW, ty = tid / K2_TW;
  const int n = blockIdx.z;
  const int oh = blockIdx.y * K2_TH + ty, ow = blockIdx.x * K2_TW + tx;
  const int ih0 = blockIdx.y * K2_TH - p.pad, iw0 = blockIdx.x * K2_TW - p.pad;

  for (int i = tid; i < tpix; i += K2_THREADS) {
    const int ih = ih0 + i / tiw, iw = iw0 + i % tiw;
    float m0 = 0.f, m1 = 0.f;
    if (ih >= 0 && ih < p.h && iw >= 0 && iw < p.w_in) {
      const __nv_bfloat16* m = mask_at(p, n, ih, iw);
      m0 = __bfloat162float(m[0]);
      if (p.g == 2) m1 = __bfloat162float(m[1]);
    }
    ms[2 * i] = m0;
    ms[2 * i + 1] = m1;
  }
  __syncthreads();

  // raw per-group tap counts, weighted once by the group sizes
  float c0 = 0.f, c1 = 0.f;
  for (int dy = 0; dy < k; ++dy)
    for (int dx = 0; dx < k; ++dx) {
      const int i = (ty + dy) * tiw + tx + dx;
      c0 += ms[2 * i];
      c1 += ms[2 * i + 1];
    }

  float acc[COUT];
#pragma unroll
  for (int o = 0; o < COUT; ++o) acc[o] = 0.f;

  for (int cb = 0; cb < p.cin; cb += K2_CK) {
    const int cn = min(K2_CK, p.cin - cb);  // the last chunk may be short
    __syncthreads();                        // the previous chunk has been consumed
    // neighbouring threads take neighbouring channels of one pixel
    for (int i = tid; i < tpix * cn; i += K2_THREADS) {
      const int pix = i / cn, c = i % cn, ch = cb + c;
      const float mv = ms[2 * pix + (ch < p.size0 ? 0 : 1)];  // 0 outside the image
      float v = 0.f;
      if (mv != 0.f) {
        const int ih = ih0 + pix / tiw, iw = iw0 + pix % tiw;
        const float xv = __bfloat162float(p.x[((size_t)(n * p.h + ih) * p.w_in + iw) * p.cin + ch]);
        v = __bfloat162float(__float2bfloat16(xv * mv));  // x*M rounded as the plain version does
      }
      xs[pix * K2_LD + c] = v;
    }
    for (int i = tid; i < k * k * cn * COUT; i += K2_THREADS) {
      const int tap = i / (cn * COUT), r = i % (cn * COUT);
      ws[tap * K2_CK * COUT + r] = __bfloat162float(p.w[((size_t)tap * p.cin + cb) * COUT + r]);
    }
    __syncthreads();
    for (int dy = 0; dy < k; ++dy)
      for (int dx = 0; dx < k; ++dx) {
        const float* xp = xs + ((ty + dy) * tiw + tx + dx) * K2_LD;
        const float* wp = ws + (dy * k + dx) * K2_CK * COUT;
#pragma unroll 8
        for (int c = 0; c < cn; ++c) {
          const float xv = xp[c];
#pragma unroll
          for (int o = 0; o < COUT; ++o) acc[o] = fmaf(xv, wp[c * COUT + o], acc[o]);
        }
      }
  }

  if (oh >= p.hout || ow >= p.wout) return;
  const float msum = __fadd_rn(__fmul_rn((float)p.size0, c0), __fmul_rn((float)p.size1, c1));
  const bool valid = msum > 0.f;
  const float scale = valid ? (float)(k * k * p.cin) / fmaxf(msum, 1.f) : -1.f;
  const size_t pix = ((size_t)n * p.hout + oh) * p.wout + ow;
#pragma unroll
  for (int o = 0; o < COUT; ++o)
    p.y[pix * COUT + o] = __float2bfloat16(epilogue(acc[o], scale, p.bias ? p.bias[o] : 0.f));
  p.mask_out[pix] = __float2bfloat16(valid ? 1.f : 0.f);
}

template <int COUT>
cudaError_t launch_k2(const Params& p, cudaStream_t stream) {
  const size_t smem = k2_smem_bytes(p.k, COUT);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pconv_k2<COUT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)((p.wout + K2_TW - 1) / K2_TW), (unsigned)((p.hout + K2_TH - 1) / K2_TH),
                  (unsigned)p.n);
  pconv_k2<COUT><<<grid, K2_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

Params make_params(const void* x, const void* mask, const void* w, const void* bias, void* y,
                   void* mask_out, int n, int h, int w_in, int cin, int g, int size0, int size1,
                   int hout, int wout, int cout, int cin_p, int cout_p, int k, int pad) {
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
  p.k = k; p.pad = pad;
  p.cin_x = cin; p.gb = size0; p.splits = 1;
  return p;
}

}  // namespace

extern "C" {

// K1. x: (n, h, w_in, cin_x) bf16, 16-byte aligned, cin_x % 8 == 0, group 1
// from channel gb (gb % 8 == 0); w: (k*k, cout_p, cin_p) bf16 with
// cin_p % 64 == 0, cout_p % 8 == 0, zero where x has no channel; bias:
// (cout_p) f32 or NULL; partial: (splits, n*hout*wout, cout_p) f32 when
// splits > 1; (bm, bn) in {128} x {64, 128, 256} or {256} x {64, 128};
// halo: the halo form (k 3, pad 1, same-size maps of a width that is a
// multiple of 64 and of bm or a divisor of it, H*W a multiple of bm;
// (bm, bn) in {(128, 64), (128, 128), (256, 64)}). cin, size0, size1: the layer's own
// channel counts (for the renormalisation).
int tsii_pconv_k1(const void* x, const void* mask, const void* w, const void* bias, void* y,
                  void* mask_out, void* partial, int n, int h, int w_in, int cin, int g,
                  int size0, int size1, int hout, int wout, int cout, int cin_x, int gb,
                  int cin_p, int cout_p, int k, int pad, int splits, int bm, int bn, int halo,
                  void* stream) {
  Params p = make_params(x, mask, w, bias, y, mask_out, n, h, w_in, cin, g, size0, size1, hout,
                         wout, cout, cin_p, cout_p, k, pad);
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
    const bool fits = k == 3 && pad == 1 && hout == h && wout == w_in && w_in % 64 == 0 &&
                      (w_in % bm == 0 || bm % w_in == 0) && ((long long)h * w_in) % bm == 0;
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

// K2. w: (k*k, cin, cout) bf16, 1 <= cout <= 7; bias: (cout) f32 or NULL.
int tsii_pconv_k2(const void* x, const void* mask, const void* w, const void* bias, void* y,
                  void* mask_out, int n, int h, int w_in, int cin, int g, int size0, int size1,
                  int hout, int wout, int cout, int k, int pad, void* stream) {
  const Params p = make_params(x, mask, w, bias, y, mask_out, n, h, w_in, cin, g, size0, size1,
                               hout, wout, cout, cin, cout, k, pad);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cout) {
    case 1: return (int)launch_k2<1>(p, s);
    case 2: return (int)launch_k2<2>(p, s);
    case 3: return (int)launch_k2<3>(p, s);
    case 4: return (int)launch_k2<4>(p, s);
    case 5: return (int)launch_k2<5>(p, s);
    case 6: return (int)launch_k2<6>(p, s);
    case 7: return (int)launch_k2<7>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* tsii_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
