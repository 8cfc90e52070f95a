// Fused partial convolution (Liu et al. 2018) for Hopper, NHWC, bf16 in/out.
//
//   acc  = sum_taps sum_c (x[c] * M_g(c)) * W[tap, c, o]          (f32)
//   msum = sum_taps sum_g size_g * M_g                             (f32, exact)
//   y    = msum > 0 ? acc * (k*k*Cin / max(msum, 1)) + b : 0       (one cast)
//   M'   = msum > 0
//
// K1 `pconv_k1` replaces the TPU kernel `_kernel` / `_pallas_forward`
// (text_segmentation_image_inpainting_tpu/ops/pallas/partial_conv_kernel.py)
// for stride 1, dilation 1, square k and Cout >= 8: the U-Net decoder levels.
// It is an implicit GEMM: M = output pixels, N = Cout, K = k*k*Cin. A CTA
// owns 128 pixels x BN output channels and walks the taps and 32-channel
// chunks of Cin. The prologue of every K step gathers the shifted x tile
// into shared memory already multiplied by its group's mask, so x*M never
// reaches device memory; the products run on the tensor cores through
// nvcuda::wmma (bf16 in, f32 accumulate). At the decoder's shapes
// (Cin 192..1024, Cout 64..512) the arithmetic intensity is far above the
// card's ~295 FLOP/byte, so the bound is on-chip: each 32-channel K step
// waits on its own global->shared gather between two block barriers. The
// design hides part of that latency by loading step s+1 into registers
// while step s multiplies. At the deepest levels (4^2..16^2 pixels per
// image) the grid has only 4..64 CTAs, each walking all k*k*Cin/32 steps,
// so there the bound is the serial K loop. Split K, multi-stage cp.async
// or TMA loads, wgmma and warp specialisation are left for later work.
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
// cudaGetLastError() right after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

struct Params {
  const __nv_bfloat16* x;     // (N, H, W, Cin)
  const __nv_bfloat16* mask;  // (N, H, W, G), G in {1, 2}
  const __nv_bfloat16* w;     // K1: (k*k, Cin_p, Cout_p); K2: (k*k, Cin, Cout)
  const float* bias;          // (Cout_p) or nullptr
  __nv_bfloat16* y;           // (N, Hout, Wout, Cout)
  __nv_bfloat16* mask_out;    // (N, Hout, Wout, 1)
  int n, h, w_in, cin, g, size0, size1;
  int hout, wout, cout, cin_p, cout_p, k, pad;
  int vec_ok;  // Cin % 8 == 0 and x 16-byte aligned: 8-channel vector loads
};

__device__ __forceinline__ const __nv_bfloat16* mask_at(const Params& p, int n, int ih, int iw) {
  return p.mask + ((size_t)(n * p.h + ih) * p.w_in + iw) * p.g;
}

// Weighted window count of valid taps: raw per-group counts in f32, then
// one weighting by the group sizes (exact for binary masks).
__device__ __forceinline__ float window_mask_sum(const Params& p, int n, int oh, int ow) {
  float c0 = 0.f, c1 = 0.f;
  for (int dy = 0; dy < p.k; ++dy) {
    const int ih = oh + dy - p.pad;
    if (ih < 0 || ih >= p.h) continue;
    for (int dx = 0; dx < p.k; ++dx) {
      const int iw = ow + dx - p.pad;
      if (iw < 0 || iw >= p.w_in) continue;
      const __nv_bfloat16* m = mask_at(p, n, ih, iw);
      c0 += __bfloat162float(m[0]);
      if (p.g == 2) c1 += __bfloat162float(m[1]);
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

constexpr int BM = 128;       // output pixels per CTA
constexpr int BK = 32;        // input channels per K step
constexpr int THREADS = 256;  // 8 warps: 4 along M x 2 along N
constexpr int A_LD = BK + 8;  // padded shared row, bf16 elements
constexpr int C_LD = 20;      // per-warp f32 staging row

union Vec8 {
  uint4 u;
  __nv_bfloat16 h[8];
};

template <int BN>
__global__ void __launch_bounds__(THREADS) pconv_k1(Params p) {
  constexpr int WN = BN / 2;   // warp tile columns
  constexpr int FN = WN / 16;  // accumulator fragments along N per warp
  constexpr int FM = 2;        // 32 rows per warp
  constexpr int B_LD = BN + 8;
  constexpr int B_VECS = BK * BN / 8 / THREADS;  // 8-wide vectors per thread

  __shared__ __align__(128) __nv_bfloat16 As[BM][A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK][B_LD];
  __shared__ __align__(128) float Cs[THREADS / 32][16][C_LD];
  __shared__ float s_scale[BM];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const long long P = (long long)p.n * p.hout * p.wout;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const float winsize = (float)(p.k * p.k * p.cin);

  // Per-pixel renormalisation; the first Cout tile also writes M'.
  if (tid < BM) {
    const long long pix = m0 + tid;
    float scale = -1.f;  // <= 0 marks an empty window
    if (pix < P) {
      const int ow = (int)(pix % p.wout);
      const long long t = pix / p.wout;
      const int oh = (int)(t % p.hout);
      const int nn = (int)(t / p.hout);
      const float msum = window_mask_sum(p, nn, oh, ow);
      const bool valid = msum > 0.f;
      if (valid) scale = winsize / fmaxf(msum, 1.f);
      if (blockIdx.y == 0) p.mask_out[pix] = __float2bfloat16(valid ? 1.f : 0.f);
    }
    s_scale[tid] = scale;
  }

  // This thread's two A-tile vectors: pixel rows r and r + 64, channel
  // sub-vector cv (8 channels).
  const int cv = tid & 3;
  int a_n[2], a_oh[2], a_ow[2];
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const long long pix = m0 + (tid >> 2) + 64 * v;
    if (pix < P) {
      a_ow[v] = (int)(pix % p.wout);
      const long long t = pix / p.wout;
      a_oh[v] = (int)(t % p.hout);
      a_n[v] = (int)(t / p.hout);
    } else {
      a_n[v] = -1;
      a_oh[v] = a_ow[v] = 0;
    }
  }

  const int chunks = p.cin_p / BK;
  const int steps = p.k * p.k * chunks;
  uint4 a_reg[2];
  uint4 b_reg[B_VECS];

  auto load_step = [&](int s) {
    const int tap = s / chunks;
    const int c0 = (s - tap * chunks) * BK;
    const int dy = tap / p.k, dx = tap - dy * p.k;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      Vec8 val;
      val.u = make_uint4(0u, 0u, 0u, 0u);
      const int ih = a_oh[v] + dy - p.pad, iw = a_ow[v] + dx - p.pad;
      const int c = c0 + cv * 8;
      if (a_n[v] >= 0 && ih >= 0 && ih < p.h && iw >= 0 && iw < p.w_in && c < p.cin) {
        const __nv_bfloat16* m = mask_at(p, a_n[v], ih, iw);
        const float m0v = __bfloat162float(m[0]);
        const float m1v = p.g == 2 ? __bfloat162float(m[1]) : m0v;
        const __nv_bfloat16* src = p.x + ((size_t)(a_n[v] * p.h + ih) * p.w_in + iw) * p.cin + c;
        if (p.vec_ok) {
          val.u = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (c + j < p.cin) val.h[j] = src[j];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float mv = (c + j < p.size0) ? m0v : m1v;
          val.h[j] = __float2bfloat16(__bfloat162float(val.h[j]) * mv);
        }
      }
      a_reg[v] = val.u;
    }
#pragma unroll
    for (int v = 0; v < B_VECS; ++v) {
      const int i = tid + v * THREADS;
      const int row = i / (BN / 8), col = n0 + (i % (BN / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (col < p.cout_p)
        val = __ldg(reinterpret_cast<const uint4*>(
            p.w + ((size_t)tap * p.cin_p + c0 + row) * p.cout_p + col));
      b_reg[v] = val;
    }
  };

  auto store_step = [&]() {
#pragma unroll
    for (int v = 0; v < 2; ++v)
      *reinterpret_cast<uint4*>(&As[(tid >> 2) + 64 * v][cv * 8]) = a_reg[v];
#pragma unroll
    for (int v = 0; v < B_VECS; ++v) {
      const int i = tid + v * THREADS;
      *reinterpret_cast<uint4*>(&Bs[i / (BN / 8)][(i % (BN / 8)) * 8]) = b_reg[v];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load_step(0);
  for (int s = 0; s < steps; ++s) {
    store_step();
    __syncthreads();
    if (s + 1 < steps) load_step(s + 1);  // in flight while the tensor cores run
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i) wmma::load_matrix_sync(af[i], &As[wm * 32 + i * 16][kk], A_LD);
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::load_matrix_sync(bf[j], &Bs[kk][wn * WN + j * 16], B_LD);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: stage each 16x16 fragment per warp, then 8 channels per lane.
  float* cs = &Cs[warp][0][0];
  const int row = lane >> 1, colh = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], C_LD, wmma::mem_row_major);
      __syncwarp();
      const int r = wm * 32 + i * 16 + row;
      const long long pix = m0 + r;
      const int col = n0 + wn * WN + j * 16 + colh;
      if (pix < P && col < p.cout) {
        const float scale = s_scale[r];
        Vec8 out;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float b = p.bias ? p.bias[col + e] : 0.f;
          out.h[e] = __float2bfloat16(epilogue(cs[row * C_LD + colh + e], scale, b));
        }
        __nv_bfloat16* dst = p.y + pix * p.cout + col;
        if ((p.cout & 7) == 0) {
          *reinterpret_cast<uint4*>(dst) = out.u;
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (col + e < p.cout) dst[e] = out.h[e];
        }
      }
      __syncwarp();
    }
  }
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
                   int hout, int wout, int cout, int cin_p, int cout_p, int k, int pad,
                   int vec_ok) {
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.mask = static_cast<const __nv_bfloat16*>(mask);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.mask_out = static_cast<__nv_bfloat16*>(mask_out);
  p.n = n; p.h = h; p.w_in = w_in; p.cin = cin; p.g = g; p.size0 = size0; p.size1 = size1;
  p.hout = hout; p.wout = wout; p.cout = cout; p.cin_p = cin_p; p.cout_p = cout_p;
  p.k = k; p.pad = pad; p.vec_ok = vec_ok;
  return p;
}

}  // namespace

extern "C" {

// K1. w: (k*k, cin_p, cout_p) bf16 with cin_p % 32 == 0, cout_p % 8 == 0,
// zero outside (cin, cout); bias: (cout_p) f32 or NULL.
int tsii_pconv_k1(const void* x, const void* mask, const void* w, const void* bias, void* y,
                  void* mask_out, int n, int h, int w_in, int cin, int g, int size0, int size1,
                  int hout, int wout, int cout, int cin_p, int cout_p, int k, int pad, int vec_ok,
                  void* stream) {
  const Params p = make_params(x, mask, w, bias, y, mask_out, n, h, w_in, cin, g, size0, size1,
                               hout, wout, cout, cin_p, cout_p, k, pad, vec_ok);
  const long long P = (long long)n * hout * wout;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cout <= 64) {
    const dim3 grid((unsigned)((P + BM - 1) / BM), (unsigned)((cout + 63) / 64));
    pconv_k1<64><<<grid, THREADS, 0, s>>>(p);
  } else {
    const dim3 grid((unsigned)((P + BM - 1) / BM), (unsigned)((cout + 127) / 128));
    pconv_k1<128><<<grid, THREADS, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}

// K2. w: (k*k, cin, cout) bf16, 1 <= cout <= 7; bias: (cout) f32 or NULL.
int tsii_pconv_k2(const void* x, const void* mask, const void* w, const void* bias, void* y,
                  void* mask_out, int n, int h, int w_in, int cin, int g, int size0, int size1,
                  int hout, int wout, int cout, int k, int pad, void* stream) {
  const Params p = make_params(x, mask, w, bias, y, mask_out, n, h, w_in, cin, g, size0, size1,
                               hout, wout, cout, cin, cout, k, pad, 0);
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
