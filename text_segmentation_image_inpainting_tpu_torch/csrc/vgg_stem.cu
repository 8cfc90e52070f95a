// The frozen VGG16 stem (torchvision features[0:5]: conv0 3->64, relu,
// conv1 64->64, relu, 2x2 max pool) for Hopper, NHWC, bf16 in.
//
// K4 `stem_dx` replaces the TPU kernel `_kernel` / `stem_dx_packed`
// (text_segmentation_image_inpainting_tpu/ops/pallas/vgg_stem_bwd.py).
// It computes only dx of the stem, for weights that are frozen:
//
//   a0  = relu(conv0(x) + b0)                      recomputed, halo +-3
//   z1  = conv1(a0) + b1                           recomputed, halo +-2
//   gz1 = g routed to the FIRST max of relu(z1) in each 2x2 window
//         (row-major order), and only where z1 > 0
//   gz0 = dgrad_conv1(gz1), only where a0 > 0      halo +-1
//   dx  = dgrad_conv0(gz0)                         f32 out
//
// A CTA owns a 16x16 tile of dx and keeps every 64-channel tensor of the
// chain in shared memory: x is read once (plus a 4-pixel halo), g once,
// dx written once. The bound is the two 64->64 products per tile, which
// run on the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate,
// operands from shared memory through ldmatrix), 16 warps per CTA; with
// the halos they do 1.75x and 1.56x the useful work of a 16x16 tile.
// conv0 (K = 27, padded to 32, as an im2col product) and the last dgrad
// (N = 3, padded to 8) run on the tensor cores as well: on the CUDA
// cores they took about 40% of the kernel.
//
// Layout: every 64-channel buffer is a flat list of pixels with one pitch
// P = tile width + 6 (a0's width) and a pixel stride of 72 bf16 (144 B:
// each ldmatrix row is 16-B aligned and 8 rows fall in 8 different bank
// groups). A 3x3 tap is then a constant offset in the flat list, so one
// m16 fragment is 16 consecutive pixels; the 2 columns past each row's
// end are computed and ignored. gz1 overwrites z1 and gz0 overwrites a0 in
// place, which keeps the tile within the 227 KB of shared memory. The
// weights of conv1 sit in shared memory once, as [tap][out][in]: the
// forward product reads them with ldmatrix, the dgrad with ldmatrix.trans.
// The TPU kernel's row-pair lane packing exists for Mosaic and is not
// ported.
//
// K5 `stem_pool` replaces `_kernel` / `stem_pool_packed`
// (text_segmentation_image_inpainting_tpu/ops/pallas/vgg_stem.py):
// maxpool2(relu(conv1(relu(z0)) + b1)) from z0 (pre-relu conv0 output),
// with K4's conv1 product and the pool in shared memory; only the pooled
// quarter is written.
//
// Plain C interface (loaded with ctypes); each launcher returns
// cudaGetLastError() right after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int C = 64;           // stem width
constexpr int LDS = 72;         // shared pixel stride in bf16 (144 B)
constexpr int THREADS = 512;    // 16 warps: one CTA per SM (shared memory), so
                                // the warps of one CTA hide the latency
constexpr int WARPS = THREADS / 32;

constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

// K4 tile: 16x16 dx pixels.
constexpr int DX_TH = 16, DX_TW = 16;
constexpr int DX_P = DX_TW + 6;                              // a0's width
constexpr int DX_Z1_FRAGS = cdiv((DX_TH + 4) * DX_P, 16);    // z1 rows [-2, TH+2)
constexpr int DX_GZ0_FRAGS = cdiv((DX_TH + 2) * DX_P, 16);   // gz0 rows [-1, TH+1)
constexpr int DX_A0_FRAGS = cdiv((DX_TH + 6) * DX_P, 16);    // a0 rows [-3, TH+3)
constexpr int DX_DX_FRAGS = cdiv(DX_TH * DX_P, 16);          // dx rows [0, TH)
constexpr int DX_Z1_PIX = DX_Z1_FRAGS * 16;
constexpr int DX_A0_PIX = cmax(DX_A0_FRAGS * 16, DX_Z1_PIX + 2 * DX_P + 2);
constexpr int DX_XR = DX_TH + 8, DX_XC = DX_TW + 8;          // x rows [-4, TH+4)
// conv0 as a product: im2col rows of K = 27 taps x channels, padded to 32
constexpr int XK = 32, XLD = 40;  // 80 B rows: 16-B aligned, 8 rows in 8 bank groups
static_assert(DX_GZ0_FRAGS * 16 + 2 * DX_P + 2 <= DX_Z1_PIX, "dgrad reads past z1");
static_assert(DX_DX_FRAGS * 16 + 4 * DX_P + 4 <= DX_A0_PIX, "the last dgrad reads past gz0");
static_assert(DX_TH % 2 == 0 && DX_TW % 2 == 0, "tiles must keep the 2x2 pool windows whole");

constexpr size_t DX_A0_BYTES = (size_t)DX_A0_PIX * LDS * 2;
constexpr size_t DX_Z1_BYTES = (size_t)DX_Z1_PIX * LDS * 2;
constexpr size_t W1_BYTES = (size_t)9 * C * LDS * 2;
// scratch that lives in z1's buffer before conv1 (im2col of x, conv0's
// weights) and after the conv1 dgrad (the last dgrad's weights)
constexpr size_t XCOL_BYTES = (size_t)DX_A0_FRAGS * 16 * XLD * 2;
constexpr size_t W0C_BYTES = (size_t)C * XLD * 2;
constexpr size_t W0D_BYTES = (size_t)9 * 8 * LDS * 2;
static_assert(XCOL_BYTES + W0C_BYTES <= DX_Z1_BYTES && W0D_BYTES <= DX_Z1_BYTES,
              "conv0's scratch must fit in z1's buffer");
constexpr size_t DX_SMEM = DX_A0_BYTES + DX_Z1_BYTES + W1_BYTES + 2 * C * 4 +
                           (size_t)DX_XR * DX_XC * 3 * 2;
static_assert(DX_SMEM <= 232448, "K4 tile exceeds the 227 KB of shared memory");

// K5 tile: 16x16 z1 pixels, 8x8 pooled.
constexpr int PL_TH = 16, PL_TW = 16;
constexpr int PL_P = PL_TW + 2;
constexpr int PL_Z1_FRAGS = cdiv(PL_TH * PL_P, 16);
constexpr int PL_Z1_PIX = PL_Z1_FRAGS * 16;
constexpr int PL_A0_PIX = cmax((PL_TH + 2) * PL_P, PL_Z1_PIX + 2 * PL_P + 2);
constexpr size_t PL_A0_BYTES = (size_t)PL_A0_PIX * LDS * 2;
constexpr size_t PL_Z1_BYTES = (size_t)PL_Z1_PIX * LDS * 2;
constexpr size_t PL_SMEM = PL_A0_BYTES + PL_Z1_BYTES + W1_BYTES + C * 4;
static_assert(PL_SMEM <= 232448, "K5 tile exceeds the 227 KB of shared memory");

struct StemParams {
  const bf16* x;      // K4: (M, H, W, 3) normalised image; K5: z0 (M, H, W, 64)
  const bf16* g;      // K4: (M, H/2, W/2, 64) cotangent of the pool output
  const bf16* w0;     // K4: (64 out, 27) conv0 weight, k = (ky*3 + kx)*3 + in
  const float* b0;    // (64) f32 of the bf16-rounded bias
  const bf16* w1;     // (9 taps, 64 out, 64 in)
  const float* b1;    // (64)
  float* dx;          // K4: (M, H, W, 3)
  bf16* pooled;       // K5: (M, H/2, W/2, 64)
  int h, w;
};

union Vec8 {
  uint4 u;
  bf16 h[8];
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// conv1 weights (9, 64 out, 64 in) -> shared [tap*64 + out][in], pitch LDS.
__device__ __forceinline__ void stage_w1(const bf16* w1, bf16* w1s) {
  for (int i = threadIdx.x; i < 9 * C * (C / 8); i += THREADS) {
    const int row = i >> 3, c8 = (i & 7) * 8;
    *reinterpret_cast<uint4*>(w1s + row * LDS + c8) =
        __ldg(reinterpret_cast<const uint4*>(w1 + row * C + c8));
  }
}

// The 3x3 64->64 product over a flat pixel list, on the tensor cores.
//   forward (DGRAD false): out[f] = sum_t src[f + ky*P + kx] . W1[:, :, t]^T
//   dgrad   (DGRAD true):  out[f] = sum_t src[f + (2-ky)*P + (2-kx)] . W1[:, :, t]
// for f in [0, 16*frags). A warp takes a unit of 16 pixels x 64 channels
// (one A fragment feeds 8 independent mma) and hands each finished pair
// (row, col), (row, col + 1) to `epi`.
template <bool DGRAD, typename Epi>
__device__ __forceinline__ void conv1_product(const bf16* src, const bf16* w1s, int pitch,
                                              int frags, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mat = lane >> 3, mrow = lane & 7;  // ldmatrix: which 8x8 matrix, which row
  for (int u = warp; u < frags; u += WARPS) {
    const int f0 = u * 16;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 1
    for (int t = 0; t < 9; ++t) {
      const int ky = t / 3, kx = t - 3 * (t / 3);
      const int off = DGRAD ? (2 - ky) * pitch + (2 - kx) : ky * pitch + kx;
      const bf16* arow = src + (f0 + off + (lane & 15)) * LDS + (lane >> 4) * 8;
      const bf16* wt = w1s + t * C * LDS;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t a[4];
        ldsm_x4(a, arow + kc * 16);
#pragma unroll
        for (int nb = 0; nb < 8; nb += 2) {
          uint32_t b[4];
          // matrix `mat`: output block nb + (mat >> 1), K half (mat & 1)
          if (DGRAD) {  // B[k = out][n = in], stored k-major: transpose on load
            ldsm_x4_trans(b, wt + (kc * 16 + (mat & 1) * 8 + mrow) * LDS + (nb + (mat >> 1)) * 8);
          } else {      // B[k = in][n = out], stored n-major
            ldsm_x4(b, wt + ((nb + (mat >> 1)) * 8 + mrow) * LDS + kc * 16 + (mat & 1) * 8);
          }
          mma_bf16(acc[nb], a, b[0], b[1]);
          mma_bf16(acc[nb + 1], a, b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const int col = nb * 8 + (lane & 3) * 2;
      epi(f0 + (lane >> 2), col, acc[nb][0], acc[nb][1]);
      epi(f0 + (lane >> 2) + 8, col, acc[nb][2], acc[nb][3]);
    }
  }
}

// ---------------------------------------------------------------- K4 ----

__global__ void __launch_bounds__(THREADS, 1) stem_dx_kernel(StemParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* a0 = reinterpret_cast<bf16*>(smem);                          // a0, then gz0
  bf16* z1 = reinterpret_cast<bf16*>(smem + DX_A0_BYTES);            // z1, then gz1
  bf16* w1s = reinterpret_cast<bf16*>(smem + DX_A0_BYTES + DX_Z1_BYTES);
  float* b0s = reinterpret_cast<float*>(smem + DX_A0_BYTES + DX_Z1_BYTES + W1_BYTES);
  float* b1s = b0s + C;
  bf16* xs = reinterpret_cast<bf16*>(b1s + C);                       // (XR, XC, 3)
  bf16* xcol = z1;                                                   // (A0 frags*16, XLD)
  bf16* w0c = z1 + DX_A0_FRAGS * 16 * XLD;                           // (64 out, XLD)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mat = lane >> 3, mrow = lane & 7;
  const int n = blockIdx.z;
  const int ty0 = blockIdx.y * DX_TH, tx0 = blockIdx.x * DX_TW;
  const int h2 = p.h / 2, w2 = p.w / 2;
  const bf16 zero = __float2bfloat16(0.f);

  // 1. weights, biases, the x tile (zero outside the image)
  stage_w1(p.w1, w1s);
  for (int i = tid; i < C * XK; i += THREADS) {
    const int o = i / XK, k = i % XK;
    w0c[o * XLD + k] = k < 27 ? p.w0[o * 27 + k] : zero;
  }
  if (tid < C) {
    b0s[tid] = p.b0[tid];
    b1s[tid] = p.b1[tid];
  }
  for (int i = tid; i < DX_XR * DX_XC; i += THREADS) {
    const int ih = ty0 - 4 + i / DX_XC, iw = tx0 - 4 + i % DX_XC;
    const bool in = ih >= 0 && ih < p.h && iw >= 0 && iw < p.w;
    const bf16* src = p.x + ((size_t)(n * p.h + ih) * p.w + iw) * 3;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) xs[i * 3 + ch] = in ? src[ch] : zero;
  }
  __syncthreads();

  // 2. a0 = relu(conv0(x) + b0) over rows/cols [-3, T+3), 0 outside the
  //    image and past the tile: an im2col product on the tensor cores
  for (int i = tid; i < DX_A0_FRAGS * 16 * XK; i += THREADS) {
    const int pix = i / XK, k = i % XK, t = k / 3;
    const int r = pix / DX_P, c = pix % DX_P;
    xcol[pix * XLD + k] = k < 27 && r < DX_TH + 6
        ? xs[((r + t / 3) * DX_XC + c + t % 3) * 3 + k % 3] : zero;
  }
  __syncthreads();
  for (int u = warp; u < DX_A0_FRAGS; u += WARPS) {
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int kc = 0; kc < XK / 16; ++kc) {
      uint32_t a[4];
      ldsm_x4(a, xcol + (u * 16 + (lane & 15)) * XLD + kc * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nb = 0; nb < 8; nb += 2) {
        uint32_t b[4];
        ldsm_x4(b, w0c + ((nb + (mat >> 1)) * 8 + mrow) * XLD + kc * 16 + (mat & 1) * 8);
        mma_bf16(acc[nb], a, b[0], b[1]);
        mma_bf16(acc[nb + 1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pix = u * 16 + (lane >> 2) + half * 8;
      const int r = pix / DX_P, c = pix % DX_P;
      const int ih = ty0 - 3 + r, iw = tx0 - 3 + c;
      const bool in = r < DX_TH + 6 && ih >= 0 && ih < p.h && iw >= 0 && iw < p.w;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int col = nb * 8 + (lane & 3) * 2;
        *reinterpret_cast<__nv_bfloat162*>(a0 + pix * LDS + col) = __floats2bfloat162_rn(
            in ? fmaxf(acc[nb][2 * half] + b0s[col], 0.f) : 0.f,
            in ? fmaxf(acc[nb][2 * half + 1] + b0s[col + 1], 0.f) : 0.f);
      }
    }
  }
  __syncthreads();

  // 3. z1 = conv1(a0) + b1 over rows/cols [-2, T+2)
  conv1_product<false>(a0, w1s, DX_P, DX_Z1_FRAGS, [&](int row, int col, float v0, float v1) {
    *reinterpret_cast<__nv_bfloat162*>(z1 + row * LDS + col) =
        __floats2bfloat162_rn(v0 + b1s[col], v1 + b1s[col + 1]);
  });
  __syncthreads();

  // 4. pool gradient, in place: each window's g goes to its first maximum
  //    of relu(z1) in row-major order, and only where z1 > 0
  constexpr int WR = (DX_TH + 4) / 2, WC = (DX_TW + 4) / 2;
  for (int i = tid; i < WR * WC * 8; i += THREADS) {
    const int win = i >> 3, c0 = (i & 7) * 8;
    const int wr = win / WC, wc = win % WC;
    const int py = ty0 / 2 - 1 + wr, px = tx0 / 2 - 1 + wc;
    Vec8 gv;
    gv.u = make_uint4(0u, 0u, 0u, 0u);
    if (py >= 0 && py < h2 && px >= 0 && px < w2)
      gv.u = __ldg(reinterpret_cast<const uint4*>(p.g + ((size_t)(n * h2 + py) * w2 + px) * C + c0));
    bf16* q[4];
    q[0] = z1 + (2 * wr * DX_P + 2 * wc) * LDS + c0;
    q[1] = q[0] + LDS;
    q[2] = q[0] + DX_P * LDS;
    q[3] = q[2] + LDS;
    Vec8 v[4], o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k].u = *reinterpret_cast<const uint4*>(q[k]);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float a[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) a[k] = fmaxf(__bfloat162float(v[k].h[e]), 0.f);
      const float m = fmaxf(fmaxf(a[0], a[1]), fmaxf(a[2], a[3]));
      // m == 0: the first max has z1 <= 0, so nothing passes
      const int sel = m <= 0.f ? 4 : a[0] == m ? 0 : a[1] == m ? 1 : a[2] == m ? 2 : 3;
#pragma unroll
      for (int k = 0; k < 4; ++k) o[k].h[e] = sel == k ? gv.h[e] : zero;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) *reinterpret_cast<uint4*>(q[k]) = o[k].u;
  }
  __syncthreads();

  // 5. gz0 = dgrad_conv1(gz1) over rows/cols [-1, T+1), where a0 > 0;
  //    written over a0 at the same pixel
  conv1_product<true>(z1, w1s, DX_P, DX_GZ0_FRAGS, [&](int row, int col, float v0, float v1) {
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(a0 + (row + 2 * DX_P + 2) * LDS + col);
    const __nv_bfloat162 act = *dst;
    *dst = __floats2bfloat162_rn(__bfloat162float(act.x) > 0.f ? v0 : 0.f,
                                 __bfloat162float(act.y) > 0.f ? v1 : 0.f);
  });
  __syncthreads();

  // 6. dx = dgrad_conv0(gz0) = sum_t gz0[f + (4-ky)*P + (4-kx)] . W0[:, :, t]
  //    on the tensor cores, N = 3 output channels padded to 8; the
  //    weights, as [tap][out channel][in], go where z1 was
  bf16* w0d = z1;
  for (int i = tid; i < 9 * 8 * C; i += THREADS) {
    const int t = i / (8 * C), ch = (i / C) % 8, o = i % C;
    w0d[(t * 8 + ch) * LDS + o] = ch < 3 ? p.w0[o * 27 + t * 3 + ch] : zero;
  }
  __syncthreads();
  for (int u = warp; u < DX_DX_FRAGS; u += WARPS) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
    for (int t = 0; t < 9; ++t) {
      const int off = (4 - t / 3) * DX_P + (4 - t % 3);
      const bf16* arow = a0 + (u * 16 + off + (lane & 15)) * LDS + (lane >> 4) * 8;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t a[4], b[4];
        ldsm_x4(a, arow + kc * 16);
        // matrices 0/1: the K halves of the one output block (2/3 repeat them)
        ldsm_x4(b, w0d + (t * 8 + mrow) * LDS + kc * 16 + (mat & 1) * 8);
        mma_bf16(acc, a, b[0], b[1]);
      }
    }
    const int ch = (lane & 3) * 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pix = u * 16 + (lane >> 2) + half * 8;
      const int i = pix / DX_P, j = pix % DX_P;
      const int ih = ty0 + i, iw = tx0 + j;
      if (ch >= 3 || j >= DX_TW || ih >= p.h || iw >= p.w) continue;
      float* out = p.dx + ((size_t)(n * p.h + ih) * p.w + iw) * 3 + ch;
      out[0] = acc[2 * half];
      if (ch + 1 < 3) out[1] = acc[2 * half + 1];
    }
  }
}

// ---------------------------------------------------------------- K5 ----

__global__ void __launch_bounds__(THREADS, 1) stem_pool_kernel(StemParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* a0 = reinterpret_cast<bf16*>(smem);
  bf16* z1 = reinterpret_cast<bf16*>(smem + PL_A0_BYTES);
  bf16* w1s = reinterpret_cast<bf16*>(smem + PL_A0_BYTES + PL_Z1_BYTES);
  float* b1s = reinterpret_cast<float*>(smem + PL_A0_BYTES + PL_Z1_BYTES + W1_BYTES);

  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int ty0 = blockIdx.y * PL_TH, tx0 = blockIdx.x * PL_TW;
  const int h2 = p.h / 2, w2 = p.w / 2;

  // 1. weights, bias, a0 = relu(z0) over rows/cols [-1, T+1), 0 outside
  stage_w1(p.w1, w1s);
  if (tid < C) b1s[tid] = p.b1[tid];
  const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.f, 0.f);
  for (int i = tid; i < PL_A0_PIX * 8; i += THREADS) {
    const int pix = i >> 3, c0 = (i & 7) * 8;
    const int r = pix / PL_P, c = pix % PL_P;
    const int ih = ty0 - 1 + r, iw = tx0 - 1 + c;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < PL_TH + 2 && ih >= 0 && ih < p.h && iw >= 0 && iw < p.w) {
      v = __ldg(reinterpret_cast<const uint4*>(p.x + ((size_t)(n * p.h + ih) * p.w + iw) * C + c0));
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) h[e] = __hmax2(h[e], zero2);
    }
    *reinterpret_cast<uint4*>(a0 + pix * LDS + c0) = v;
  }
  __syncthreads();

  // 2. z1 = conv1(a0) + b1 over the tile
  conv1_product<false>(a0, w1s, PL_P, PL_Z1_FRAGS, [&](int row, int col, float v0, float v1) {
    *reinterpret_cast<__nv_bfloat162*>(z1 + row * LDS + col) =
        __floats2bfloat162_rn(v0 + b1s[col], v1 + b1s[col + 1]);
  });
  __syncthreads();

  // 3. relu + 2x2 max pool; only the pooled quarter leaves the chip
  for (int i = tid; i < (PL_TH / 2) * (PL_TW / 2) * 8; i += THREADS) {
    const int win = i >> 3, c0 = (i & 7) * 8;
    const int wr = win / (PL_TW / 2), wc = win % (PL_TW / 2);
    const int py = ty0 / 2 + wr, px = tx0 / 2 + wc;
    if (py >= h2 || px >= w2) continue;
    const bf16* q = z1 + (2 * wr * PL_P + 2 * wc) * LDS + c0;
    uint4 v[4];
    v[0] = *reinterpret_cast<const uint4*>(q);
    v[1] = *reinterpret_cast<const uint4*>(q + LDS);
    v[2] = *reinterpret_cast<const uint4*>(q + PL_P * LDS);
    v[3] = *reinterpret_cast<const uint4*>(q + (PL_P + 1) * LDS);
    uint4 out;
    const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(v);
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[e] = __hmax2(__hmax2(__hmax2(a[e], a[4 + e]), __hmax2(a[8 + e], a[12 + e])), zero2);
    *reinterpret_cast<uint4*>(p.pooled + ((size_t)(n * h2 + py) * w2 + px) * C + c0) = out;
  }
}

StemParams make_params(const void* x, const void* g, const void* w0, const void* b0,
                       const void* w1, const void* b1, void* dx, void* pooled, int h, int w) {
  StemParams p;
  p.x = static_cast<const bf16*>(x);
  p.g = static_cast<const bf16*>(g);
  p.w0 = static_cast<const bf16*>(w0);
  p.b0 = static_cast<const float*>(b0);
  p.w1 = static_cast<const bf16*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.dx = static_cast<float*>(dx);
  p.pooled = static_cast<bf16*>(pooled);
  p.h = h;
  p.w = w;
  return p;
}

}  // namespace

extern "C" {

// K4. x (m, h, w, 3) bf16, g (m, h/2, w/2, 64) bf16, w0 (64 out, 27) bf16,
// b0/b1 (64) f32, w1 (9, 64 out, 64 in) bf16 -> dx (m, h, w, 3) f32.
// h and w even.
int tsii_stem_dx(const void* x, const void* g, const void* w0, const void* b0, const void* w1,
                 const void* b1, void* dx, int m, int h, int w, void* stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      stem_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DX_SMEM);
  if (e != cudaSuccess) return (int)e;
  const StemParams p = make_params(x, g, w0, b0, w1, b1, dx, nullptr, h, w);
  const dim3 grid((unsigned)cdiv(w, DX_TW), (unsigned)cdiv(h, DX_TH), (unsigned)m);
  stem_dx_kernel<<<grid, THREADS, DX_SMEM, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// K5. z0 (m, h, w, 64) bf16, w1 (9, 64 out, 64 in) bf16, b1 (64) f32
// -> pooled (m, h/2, w/2, 64) bf16. h and w even.
int tsii_stem_pool(const void* z0, const void* w1, const void* b1, void* pooled, int m, int h,
                   int w, void* stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      stem_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)PL_SMEM);
  if (e != cudaSuccess) return (int)e;
  const StemParams p = make_params(z0, nullptr, nullptr, nullptr, w1, b1, nullptr, pooled, h, w);
  const dim3 grid((unsigned)cdiv(w, PL_TW), (unsigned)cdiv(h, PL_TH), (unsigned)m);
  stem_pool_kernel<<<grid, THREADS, PL_SMEM, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
