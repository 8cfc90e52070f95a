// The frozen VGG16 stem (torchvision features[0:5]: conv0 3->64, relu,
// conv1 64->64, relu, 2x2 max pool) for Hopper, NHWC, bf16 in (K4, K5)
// or f32 in (K4F, K5F).
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
// K5 `stem_pool` replaces `_kernel` / `stem_pool_packed`
// (text_segmentation_image_inpainting_tpu/ops/pallas/vgg_stem.py):
// maxpool2(relu(conv1(relu(z0)) + b1)) from z0 (pre-relu conv0 output),
// rounded once (f32 sum plus bias); only the pooled quarter is written.
// Relu passes nothing at exactly 0. H and W are even; tiles at the
// bottom and right edge are partial.
//
// What bounds both is conv1's 3x3 64->64 product (K4: its forward and
// its dgrad, with halos of 1.75x and 1.56x the useful work of a 16x16
// tile; K5: its forward, 1.125x). The design:
//
//   - Persistent CTAs, one per SM: the wrapper launches min(SMs, tiles)
//     CTAs (ops/kernels/vgg_stem.py::stem_grid) and CTA b walks tiles b,
//     b + grid, ... over (image, tile row, tile column), column fastest.
//     Each CTA stages conv1's weights (and K4 conv0's) in shared memory
//     once, with 16-byte cp.async, not once per tile.
//   - Warpgroups 0 and 1 compute (setmaxnreg 216 or 200), warpgroup 2 is
//     the producer: it loads the next tile's input while the consumers
//     work, handed over by an mbarrier each way per buffer. K5: z0's 18x18
//     pixel rows through the producer's registers (relu applied there)
//     into the third of three buffers. K4: x (24x24x3, 6-byte pixels)
//     through registers once the im2col is done with the last one, g
//     (10x10x64) by cp.async once the pool gradient is.
//   - Every 64-channel buffer is a flat list of pixels with one pitch P
//     (the tile width plus the halo), one 128-byte row per pixel, with
//     the 128-byte swizzle. A 3x3 tap is then a constant row offset
//     (ky*P + kx forward, (2-ky)*P + (2-kx) for the dgrad): the columns
//     past each row's end are computed and ignored.
//   - conv1 runs on `wgmma` m64nNk16: A = one tap's weights, 64 output
//     channels x 64 input channels, K-major as (9, 64 out, 64 in) is
//     stored; B = N pixel rows from the tap's offset; the accumulator is
//     (channel x pixel). The dgrad contracts over the output channel and
//     reads the same weight copy as an MN-major A (the transpose bit).
//     Each consumer warpgroup takes half the pixel rows: K5 2 x 144, K4's
//     forward 2 x 224 and its dgrad 2 x 200. The epilogue stores z1 (or
//     gz0 where a0 > 0) back to pixel rows with stmatrix.trans.
//   - K5 issues the next tile's products into a second accumulator before
//     this tile's epilogue and pool, and writes z1 into the input buffer
//     its products have just read (rows the other warpgroup does not read).
//   - K4's two small products run on `wgmma` too: conv0 with K = 27 taps
//     x channels and a column of ones that multiplies the bias, padded to
//     32 (an im2col built one pixel row per thread, all zero outside the
//     image, so the epilogue is a relu alone; 64-byte rows with the
//     64-byte swizzle; A = [W0 | b0], m64n248), and the last
//     dgrad as Q = W0^T gz0 (A = W0 transposed, its 27 (tap, channel) rows
//     padded to 64; B = gz0's rows, each read once; m64n200) followed by a
//     9-tap gather of Q per dx pixel. The pool gradient takes two channels
//     at a time as 16-bit integers.
//
// Shared bytes read per tile by the conv1 products: K5 72 wgmma x (2 KB
// of A + 144 x 32 B of B) = 0.48 MB (v1, 16 pixels x all 64 channels of B
// per warp: 1.66 MB); K4 72 x (2 KB + 224 x 32 B) + 72 x (2 KB + 200 x
// 32 B) = 1.27 MB (v1: 4.9 MB). Shared memory per CTA (PL_SMEM, DX_SMEM):
// K5 200,960 B (weights 73,728, three input buffers of 41,984, bias 256,
// 1 KB to align); K4 224,384 B (conv1's weights 73,728, conv0's 4,096 and
// their transpose 8,192, a0/gz0 63,488, z1/gz1 57,344, x 3,456, g 12,800,
// conv1's bias 256, 1 KB). K4's tile stays
// 16x16: a 16x32 tile needs about 278 KB. In K4 gz1 overwrites z1 and gz0
// overwrites a0 in place; z1's buffer holds the im2col of x before conv1
// and Q after the conv1 dgrad. The TPU kernel's row-pair lane packing
// exists for Mosaic and is not ported.
//
// K4F and K5F are the f32 forms, for a float32 trunk: see "the f32 form"
// below.
//
// Plain C interface (loaded with ctypes); each launcher returns
// cudaGetLastError() right after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int C = 64;            // stem width: one 128-byte row per pixel
constexpr int CONSUMERS = 256;   // warpgroups 0 and 1
constexpr int PRODUCERS = 128;   // warpgroup 2
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int CWARPS = CONSUMERS / 32;
constexpr int ROW = 128;         // bytes per pixel row
constexpr int W1_BYTES = 9 * C * ROW;  // (9 taps, 64 out) rows of 64 in: 73,728
constexpr int TAP_BYTES = C * ROW;     // one tap's weights: 8 KB, 1024-aligned

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int up8(int a) { return (a + 7) / 8 * 8; }

// K4 tile: 16x16 dx pixels. a0 rows/cols [-3, T+3) with pitch P = T + 6.
constexpr int DX_TH = 16, DX_TW = 16;
constexpr int DX_P = DX_TW + 6;
constexpr int DX_Z1_N = 224;     // z1 pixels per consumer warpgroup (rows [-2, T+2))
constexpr int DX_GZ0_N = 200;    // gz0 pixels per consumer warpgroup (rows [-1, T+1))
constexpr int DX_C0_N = 248;     // a0 pixels per consumer warpgroup (rows [-3, T+3), then 0)
constexpr int DX_Z1_ROWS = 2 * DX_Z1_N;
constexpr int DX_A0_ROWS = 2 * DX_C0_N;  // conv0 writes every row, zero past the halo
constexpr int DX_XR = DX_TH + 8, DX_XC = DX_TW + 8;         // x rows [-4, TH+4)
constexpr int DX_X_BYTES = DX_XR * DX_XC * 3 * 2;
constexpr int DX_GR = DX_TH / 2 + 2, DX_GC = DX_TW / 2 + 2;  // g windows [-1, T/2+1)
constexpr int DX_G_BYTES = DX_GR * DX_GC * ROW;
// conv0 as a product: im2col rows of K = 27 taps x channels, padded to 32
// (64-byte rows with the 64-byte swizzle)
constexpr int XK = 32, XROW = XK * 2;
constexpr int Q_LD = 2 * DX_GZ0_N + 24;  // Q's row pitch in f32: = 8 (mod 32), float2 stores
                                         // of 4 rows x 4 pairs hit 32 banks
static_assert(DX_Z1_ROWS >= (DX_TH + 4 - 1) * DX_P + DX_TW + 4, "z1 must cover the pool windows");
static_assert(2 * DX_GZ0_N >= (DX_TH + 2 - 1) * DX_P + DX_TW + 2, "gz0 must cover dx's taps");
static_assert(2 * DX_GZ0_N + 2 * DX_P + 2 <= DX_Z1_ROWS, "the conv1 dgrad reads past z1");
static_assert((DX_TH - 1) * DX_P + DX_TW - 1 + 2 * DX_P + 2 < 2 * DX_GZ0_N,
              "the last dgrad reads past gz0");
static_assert(DX_A0_ROWS >= (DX_TH + 6) * DX_P, "a0 must cover rows/cols [-3, T+3)");
static_assert(DX_Z1_ROWS + 2 * DX_P + 2 <= DX_A0_ROWS, "conv1 reads past a0");
static_assert(DX_TH % 2 == 0 && DX_TW % 2 == 0, "tiles must keep the 2x2 pool windows whole");
static_assert(DX_Z1_N % 8 == 0 && DX_GZ0_N % 8 == 0 && DX_C0_N % 8 == 0 && DX_Z1_N <= 256 &&
              DX_GZ0_N <= 256 && DX_C0_N <= 256, "wgmma N is a multiple of 8 up to 256");

constexpr int DX_A0_BYTES = DX_A0_ROWS * ROW;
constexpr int DX_Z1_BYTES = DX_Z1_ROWS * ROW;
constexpr int XCOL_BYTES = DX_A0_ROWS * XROW;
constexpr int W0C_BYTES = C * XROW;  // conv0's weights: 64 out rows of 32 k
constexpr int W0T_BYTES = C * ROW;   // W0 transposed: 64 rows (27 (tap, channel) used) of 64 out
constexpr int Q_BYTES = 27 * Q_LD * 4;
static_assert(XCOL_BYTES <= DX_Z1_BYTES && Q_BYTES <= DX_Z1_BYTES,
              "the im2col of x and Q must fit in z1's buffer");
static_assert(DX_X_BYTES % 16 == 0 && W0T_BYTES % 1024 == 0 && W0C_BYTES % 1024 == 0,
              "aligned buffers");
// + 1024: slack to align the tiles to 1024 bytes (the swizzle's period)
constexpr int DX_SMEM = 1024 + W1_BYTES + W0T_BYTES + W0C_BYTES + DX_A0_BYTES + DX_Z1_BYTES +
                        DX_X_BYTES + DX_G_BYTES + C * 4;
static_assert(DX_SMEM <= 232448, "K4 exceeds the 227 KB of shared memory");

// K5 tile: 16x16 z1 pixels, 8x8 pooled. a0 rows/cols [-1, T+1), P = T + 2.
constexpr int PL_TH = 16, PL_TW = 16;
constexpr int PL_P = PL_TW + 2;
constexpr int PL_N = PL_TH / 2 * PL_P;   // z1 pixels per consumer warpgroup: 8 tile rows
constexpr int PL_IN_ROWS = (PL_TH + 2) * PL_P;
constexpr int PL_A0_ROWS = up8(cmax(PL_IN_ROWS, 2 * PL_N + 2 * PL_P + 2));
constexpr int PL_A0_BYTES = PL_A0_ROWS * ROW;
constexpr int PL_STAGES = 3;  // input buffers: one multiplied, one issued early, one loading
// Each warpgroup writes its z1 into the input buffer its products have
// just read, at rows the other warpgroup's products do not read:
// warpgroup 0 reads rows [0, N + 2P + 2), warpgroup 1 [N, 2N + 2P + 2).
constexpr int PL_Z1_ROW1 = PL_N + 2 * PL_P + 2;
static_assert(PL_Z1_ROW1 + PL_N <= PL_A0_ROWS, "warpgroup 1's z1 must fit in the input buffer");
static_assert(PL_N % 8 == 0 && PL_N <= 256, "wgmma N is a multiple of 8 up to 256");
static_assert(PL_TH % 4 == 0 && PL_TW % 2 == 0, "each warpgroup pools whole windows");
constexpr int PL_SMEM = 1024 + W1_BYTES + PL_STAGES * PL_A0_BYTES + C * 4;
static_assert(PL_SMEM <= 232448, "K5 exceeds the 227 KB of shared memory");
static_assert(W1_BYTES % 1024 == 0 && DX_A0_BYTES % 1024 == 0 && PL_A0_BYTES % 1024 == 0,
              "the swizzled tiles must start on 1024 bytes");

struct StemParams {
  const bf16* x;      // K4: (M, H, W, 3) normalised image; K5: z0 (M, H, W, 64)
  const bf16* g;      // K4: (M, H/2, W/2, 64) cotangent of the pool output
  const bf16* w0;     // K4: (64 out, 27) conv0 weight, k = (ky*3 + kx)*3 + in
  const float* b0;    // (64) f32 of the bf16-rounded bias
  const bf16* w1;     // (9 taps, 64 out, 64 in)
  const float* b1;    // (64)
  float* dx;          // K4: (M, H, W, 3)
  bf16* pooled;       // K5: (M, H/2, W/2, 64)
  int m, h, w;
};

// Which tile of the persistent walk: (image, first row, first column).
struct Tile {
  int n, y0, x0;
};

__device__ __forceinline__ Tile tile_at(int t, int h, int w, int th, int tw) {
  const int tx = cdiv(w, tw), ty = cdiv(h, th);
  Tile r;
  r.x0 = (t % tx) * tw;
  r.y0 = (t / tx % ty) * th;
  r.n = t / (tx * ty);
  return r;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~(uintptr_t)1023);
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Four 8x8 bf16 matrices to shared memory, transposed: lanes 8i..8i+7
// give the row addresses of matrix i, register i holds this lane's
// fragment of it (row lane / 4, columns 2 (lane % 4) and + 1), and a
// fragment row becomes a memory column. ldsm_x4_trans is its inverse.
__device__ __forceinline__ void stsm_x4_trans(uint32_t a, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1,%2,%3,%4};\n"
               ::"r"(a), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]) : "memory");
}

// The first two matrices only (lanes 0..15 give the addresses).
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

__device__ __forceinline__ void stsm_x2_trans(uint32_t a, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x2.trans.shared.b16 [%0], {%1,%2};\n"
               ::"r"(a), "r"(r[0]), "r"(r[1]) : "memory");
}

// Two floats rounded to a bf16 pair, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Once per CTA, every thread: conv1's weights (9, 64 out, 64 in) into
// swizzled rows [tap*64 + out] of 64 in, and its bias. Returns after the
// copies have landed and are visible to wgmma.
__device__ __forceinline__ void stage_weights(const StemParams& p, uint8_t* w1s, float* b1s) {
  const uint32_t dst = smem_u32(w1s);
  for (int i = threadIdx.x; i < 9 * C * 8; i += THREADS)
    cp_async16(dst + sw128(i >> 3, i & 7), p.w1 + (size_t)i * 8, 16);
  if (threadIdx.x < C) b1s[threadIdx.x] = p.b1[threadIdx.x];
  cp_async_wait_all();
  fence_proxy_async();
}

// A consumer warpgroup's accumulator (channel x pixel, 2 R pixels) to
// pixel rows [row0, row0 + 2 R) of a 128-byte-swizzled buffer with
// stmatrix.trans: 8 pixels x 8 channels per matrix, four matrices (two
// 8-pixel blocks x this thread's two channel rows ch0 and ch0 + 8) per
// instruction. The pair of values at channel ch0 + 8 h and pixel rows f,
// f + 1 is stored as fn(h, f, v0, v1, old), a bf16 pair; with LOAD, `old`
// is the pair already there.
template <bool LOAD, int R, typename Fn>
__device__ __forceinline__ void store_acc(const float (&acc)[R], uint32_t buf, int row0, Fn fn) {
  constexpr int J = R / 4;  // blocks of 8 pixels
  const int lane = threadIdx.x & 31, cw = (threadIdx.x >> 5) & 3;
  const int i = lane >> 3, k = lane & 7;  // the matrix and row this lane addresses
#pragma unroll
  for (int j = 0; j < J; j += 2) {
    const uint32_t addr = buf + sw128(row0 + 8 * (j + (i >> 1)) + k, 2 * cw + (i & 1));
    uint32_t r[4], old[4] = {0u, 0u, 0u, 0u};
    if constexpr (LOAD) {
      if (j + 1 < J) ldsm_x4_trans(old, addr);
      else ldsm_x2_trans(old, addr);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int jj = j + (m >> 1), h = m & 1;
      if (jj >= J) break;
      r[m] = fn(h, row0 + 8 * jj + 2 * (lane & 3), acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1],
                old[m]);
    }
    if (j + 1 < J) stsm_x4_trans(addr, r);
    else stsm_x2_trans(addr, r);
  }
}

// The f32 accumulator registers as wgmma leaves them: zeroed, then fenced.
template <int R>
__device__ __forceinline__ void wgmma_begin(float (&acc)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  fence_acc(acc);
  wgmma_fence();
}

// Commit, wait for every product in flight, and hand the registers back.
template <int R>
__device__ __forceinline__ void wgmma_end(float (&acc)[R]) {
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
}

// conv1 over pixel rows [n0, n0 + N) of this consumer warpgroup, on wgmma:
//   forward (DGRAD false): D[o][f] = sum_t W1[t][o][:] . src[f + ky*P + kx][:]
//   dgrad   (DGRAD true):  D[i][f] = sum_t W1[t][:][i] . src[f + (2-ky)*P + (2-kx)][:]
// Issued as one commit group. The descriptors are built once and
// advanced by the start address (in 16-byte units), one tap per
// iteration: unrolled, the 72 descriptors of the chain would be hoisted
// into registers and spill.
template <bool DGRAD, int R>
__device__ __forceinline__ void conv1_issue(float (&acc)[R], uint32_t w1, uint32_t src, int pitch,
                                            int n0) {
  const uint64_t da = DGRAD ? desc_sw128_mn(w1) : desc_sw128(w1);
  const uint64_t db = desc_sw128(src + n0 * ROW);
  wgmma_begin(acc);
#pragma unroll 1
  for (int t = 0; t < 9; ++t) {
    const int ky = t / 3, kx = t - 3 * ky;
    const int off = DGRAD ? (2 - ky) * pitch + (2 - kx) : ky * pitch + kx;
    const uint64_t a = da + t * (TAP_BYTES >> 4), b = db + off * (ROW >> 4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // K = the output channel (dgrad): 16 weight rows per k16 slice; K =
      // the input channel (forward): 32 bytes of every weight row
      wgmma_m64k16<DGRAD ? 1 : 0>(acc, a + (DGRAD ? kk * 16 * ROW : kk * 32) / 16, b + kk * 2);
    }
  }
  wgmma_commit();
}

// conv1_issue, then wait: returns with the products retired (the source
// may be overwritten).
template <bool DGRAD, int R>
__device__ __forceinline__ void conv1_wgmma(float (&acc)[R], uint32_t w1, uint32_t src, int pitch,
                                            int n0) {
  conv1_issue<DGRAD>(acc, w1, src, pitch, n0);
  wgmma_wait<0>();
  fence_acc(acc);
}

// ---------------------------------------------------------------- K4 ----

struct DxSmem {  // K4's shared buffers (byte pointers into the dynamic block)
  uint8_t *w1, *w0t, *w0c, *a0, *z1, *x, *g;
  float* b1;
  uint64_t* bar;  // x full, x empty, g full, g empty
};

// K4's consumers: warpgroups 0 and 1 (the 8 warps cw), one tile at a time.
__device__ __forceinline__ void stem_dx_consumers(const StemParams& p, const DxSmem& sm, int tiles) {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n");
  const int tid = threadIdx.x, wg = tid >> 7, cw = tid >> 5, lane = tid & 31;
  const uint32_t w1a = smem_u32(sm.w1), w0ta = smem_u32(sm.w0t), w0ca = smem_u32(sm.w0c);
  const uint32_t a0a = smem_u32(sm.a0), z1a = smem_u32(sm.z1);
  const uint16_t* xs = reinterpret_cast<const uint16_t*>(sm.x);
  // this thread's accumulator rows (channels ch0, ch0 + 8)
  const int ch0 = 16 * (cw & 3) + (lane >> 2);
  const float bias1[2] = {sm.b1[ch0], sm.b1[ch0 + 8]};

  for (int tile = blockIdx.x, i = 0; tile < tiles; tile += gridDim.x, ++i) {
    const Tile tl = tile_at(tile, p.h, p.w, DX_TH, DX_TW);

    // 1. the im2col of x, one pixel row per thread: k = ky*9 + kx*3 + in
    //    lies at xs[(r + ky)*XC*3 + c*3 + kx*3 + in]; k = 27 is 1 (times
    //    W0's column 27, the bias); a row outside the image or past the
    //    halo is 0, so that a0 = relu(row . W0) is 0 there
    mbar_wait(&sm.bar[0], i & 1);
    for (int pix = tid; pix < DX_A0_ROWS; pix += CONSUMERS) {
      const int r = pix / DX_P, c = pix - r * DX_P, ih = tl.y0 - 3 + r, iw = tl.x0 - 3 + c;
      uint32_t w[XK / 2];
#pragma unroll
      for (int q = 0; q < XK / 2; ++q) w[q] = 0u;
      if (r < DX_TH + 6 && ih >= 0 && ih < p.h && iw >= 0 && iw < p.w) {
        const uint16_t* src = xs + (r * DX_XC + c) * 3;
#pragma unroll
        for (int k = 0; k < 27; ++k)
          w[k >> 1] |= (uint32_t)src[(k / 9) * DX_XC * 3 + k % 9] << (16 * (k & 1));
        w[27 >> 1] |= (uint32_t)0x3F80u << 16;  // bf16 1.0 at k = 27
      }
#pragma unroll
      for (int q = 0; q < XK / 8; ++q)
        *reinterpret_cast<uint4*>(sm.z1 + sw64(pix, q)) =
            make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
    }
    fence_proxy_async();
    mbar_arrive(&sm.bar[1]);  // x may be refilled
    named_sync(1, CONSUMERS);

    // 2. a0 = relu(conv0(x) + b0) over rows/cols [-3, T+3), 0 outside the
    //    image and past the tile: the im2col product on wgmma (K 32)
    {
      float acc[DX_C0_N / 2];
      wgmma_begin(acc);
      const uint64_t da = desc_sw64(w0ca), db = desc_sw64(z1a + wg * DX_C0_N * XROW);
#pragma unroll
      for (int kk = 0; kk < XK / 16; ++kk) wgmma_m64k16<0>(acc, da + kk * 2, db + kk * 2);
      wgmma_end(acc);
      store_acc<false>(acc, a0a, wg * DX_C0_N, [](int, int, float v0, float v1, uint32_t) {
        return pack_bf16(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      });
    }
    fence_proxy_async();
    named_sync(1, CONSUMERS);

    // 3. z1 = conv1(a0) + b1 over rows/cols [-2, T+2), on wgmma
    {
      float acc[DX_Z1_N / 2];
      conv1_wgmma<false>(acc, w1a, a0a, DX_P, wg * DX_Z1_N);
      store_acc<false>(acc, z1a, wg * DX_Z1_N, [&](int h, int, float v0, float v1, uint32_t) {
        return pack_bf16(v0 + bias1[h], v1 + bias1[h]);
      });
    }
    mbar_wait(&sm.bar[2], i & 1);
    named_sync(1, CONSUMERS);

    // 4. pool gradient, in place: each window's g goes to its first maximum
    //    of relu(z1) in row-major order, and only where z1 > 0. Two
    //    channels at a time as 16-bit integers: a bf16 > 0 compares as its
    //    bits do, and relu maps negative values and -0 to 0
    for (int e = tid; e < DX_GR * DX_GC * 8; e += CONSUMERS) {
      const int win = e >> 3, c = e & 7;
      const int wr = win / DX_GC, wc = win - wr * DX_GC;
      const uint4 gv = *reinterpret_cast<const uint4*>(sm.g + e * 16);
      const int q0 = 2 * wr * DX_P + 2 * wc;
      const int q[4] = {q0, q0 + 1, q0 + DX_P, q0 + DX_P + 1};
      uint4 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = *reinterpret_cast<const uint4*>(sm.z1 + sw128(q[k], c));
      const uint32_t* g32 = reinterpret_cast<const uint32_t*>(&gv);
      uint32_t o[4][4];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const uint32_t a[4] = {reinterpret_cast<const uint32_t*>(&v[0])[w],
                               reinterpret_cast<const uint32_t*>(&v[1])[w],
                               reinterpret_cast<const uint32_t*>(&v[2])[w],
                               reinterpret_cast<const uint32_t*>(&v[3])[w]};
        const uint32_t mx = __vimax3_s16x2_relu(a[0], a[1], __vimax_s16x2_relu(a[2], a[3]));
        const uint32_t pos = __vcmpgts2(mx, 0u);
        const uint32_t s0 = __vcmpeq2(a[0], mx) & pos;
        const uint32_t s1 = __vcmpeq2(a[1], mx) & pos & ~s0;
        const uint32_t s2 = __vcmpeq2(a[2], mx) & pos & ~(s0 | s1);
        const uint32_t s3 = pos & ~(s0 | s1 | s2);
        o[0][w] = g32[w] & s0;
        o[1][w] = g32[w] & s1;
        o[2][w] = g32[w] & s2;
        o[3][w] = g32[w] & s3;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        *reinterpret_cast<uint4*>(sm.z1 + sw128(q[k], c)) = make_uint4(o[k][0], o[k][1], o[k][2], o[k][3]);
    }
    fence_proxy_async();
    mbar_arrive(&sm.bar[3]);  // g may be refilled
    named_sync(1, CONSUMERS);

    // 5. gz0 = dgrad_conv1(gz1) over rows/cols [-1, T+1), where a0 > 0;
    //    written over a0 at the same pixel, 2 rows and 2 columns in
    {
      float acc[DX_GZ0_N / 2];
      conv1_wgmma<true>(acc, w1a, z1a, DX_P, wg * DX_GZ0_N);
      store_acc<true>(acc, a0a, wg * DX_GZ0_N + 2 * DX_P + 2,
                      [](int, int, float v0, float v1, uint32_t old) {
                        const __nv_bfloat162 o = *reinterpret_cast<const __nv_bfloat162*>(&old);
                        return pack_bf16(__low2float(o) > 0.f ? v0 : 0.f,
                                         __high2float(o) > 0.f ? v1 : 0.f);
                      });
    }
    named_sync(1, CONSUMERS);

    // 6. dx = dgrad_conv0(gz0), in two steps. A product on wgmma reads each
    //    gz0 row once: Q[n][g] = sum_o W0[o][n] gz0[g][o] for the 27 (tap,
    //    channel) rows n = 3 t + ch of W0's transpose (padded to 64), f32,
    //    in z1's buffer; then dx[d][ch] = sum_t Q[3 t + ch][d + (2-ky)*P + (2-kx)]
    {
      float acc[DX_GZ0_N / 2];
      wgmma_begin(acc);
      const uint64_t da = desc_sw128(w0ta);
      const uint64_t db = desc_sw128(a0a + (wg * DX_GZ0_N + 2 * DX_P + 2) * ROW);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_m64k16<0>(acc, da + kk * 2, db + kk * 2);
      wgmma_end(acc);
      float* q = reinterpret_cast<float*>(sm.z1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = ch0 + 8 * h;
        if (n >= 27) continue;
#pragma unroll
        for (int j = 0; j < DX_GZ0_N / 8; ++j)
          *reinterpret_cast<float2*>(q + n * Q_LD + wg * DX_GZ0_N + 8 * j + 2 * (lane & 3)) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    named_sync(1, CONSUMERS);
    {
      const float* q = reinterpret_cast<const float*>(sm.z1);
      const int r = tid / DX_TW, c = tid % DX_TW, ih = tl.y0 + r, iw = tl.x0 + c;
      static_assert(DX_TH * DX_TW == CONSUMERS, "one dx pixel per consumer thread");
      if (ih < p.h && iw < p.w) {
        const int d = r * DX_P + c;
        float s[3] = {0.f, 0.f, 0.f};
#pragma unroll
        for (int t = 0; t < 9; ++t)
#pragma unroll
          for (int ch = 0; ch < 3; ++ch)
            s[ch] += q[(3 * t + ch) * Q_LD + d + (2 - t / 3) * DX_P + (2 - t % 3)];
        float* out = p.dx + ((size_t)(tl.n * p.h + ih) * p.w + iw) * 3;
        out[0] = s[0];
        out[1] = s[1];
        out[2] = s[2];
      }
    }
    named_sync(1, CONSUMERS);  // z1's buffer and a0 are rewritten by the next tile
  }
}

__global__ void __launch_bounds__(THREADS, 1) stem_dx_kernel(StemParams p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar[4];
  DxSmem sm;
  sm.w1 = align1024(smem_raw);
  sm.w0t = sm.w1 + W1_BYTES;       // W0 transposed, (27 used of 64) rows of 64 out
  sm.w0c = sm.w0t + W0T_BYTES;     // W0 as (64 out) rows of 32 k, 64-byte swizzle
  sm.a0 = sm.w0c + W0C_BYTES;      // a0, then gz0
  sm.z1 = sm.a0 + DX_A0_BYTES;     // the im2col of x; z1, then gz1; Q
  sm.x = sm.z1 + DX_Z1_BYTES;      // (XR, XC, 3) bf16
  sm.g = sm.x + DX_X_BYTES;        // (GR x GC windows, 64) bf16
  sm.b1 = reinterpret_cast<float*>(sm.g + DX_G_BYTES);
  sm.bar = bar;

  const int tid = threadIdx.x;
  const int tiles = p.m * cdiv(p.h, DX_TH) * cdiv(p.w, DX_TW);
  const bf16 zero = __float2bfloat16(0.f);

  stage_weights(p, sm.w1, sm.b1);
  for (int e = tid; e < C * XK; e += THREADS) {  // w0c[o][k] = W0[o][k], w0c[o][27] = b0[o]
    const int o = e / XK, k = e % XK;
    *reinterpret_cast<bf16*>(sm.w0c + sw64(o, k >> 3) + (k & 7) * 2) =
        k < 27 ? p.w0[o * 27 + k] : k == 27 ? __float2bfloat16(p.b0[o]) : zero;
  }
  for (int e = tid; e < C * C; e += THREADS) {  // w0t[n][o] = W0[o][n]
    const int n = e / C, o = e % C;
    *reinterpret_cast<bf16*>(sm.w0t + sw128(n, o >> 3) + (o & 7) * 2) = n < 27 ? p.w0[o * 27 + n] : zero;
  }
  fence_proxy_async();
  if (tid == 0) {
    for (int k = 0; k < 4; ++k) mbar_init(&bar[k], k % 2 ? CONSUMERS : PRODUCERS);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer: the next tile's x (through registers, as 4-byte words:
    // its pixels are 6 bytes, a tile row starts 4-byte aligned for an even
    // W, and no word straddles the image's edge, 3 x an even number of
    // pixels in) as soon as the consumers' im2col is done with it, and its
    // g (cp.async) as soon as their pool gradient is
    asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n");
    const int t = tid - CONSUMERS;
    constexpr int XRW = DX_XC * 3 / 2, XN = DX_XR * XRW, XPER = cdiv(XN, PRODUCERS);
    const int h2 = p.h / 2, w2 = p.w / 2;
    uint32_t* xs = reinterpret_cast<uint32_t*>(sm.x);
    const uint32_t* xg = reinterpret_cast<const uint32_t*>(p.x);
    for (int tile = blockIdx.x, i = 0; tile < tiles; tile += gridDim.x, ++i) {
      const Tile tl = tile_at(tile, p.h, p.w, DX_TH, DX_TW);
      uint32_t v[XPER];  // all loads in flight before the first store
#pragma unroll
      for (int j = 0; j < XPER; ++j) {
        const int e = t + j * PRODUCERS, r = e / XRW, wi = e - r * XRW;
        const int ih = tl.y0 - 4 + r, iw = tl.x0 - 4 + 2 * wi / 3;
        const bool in = e < XN && ih >= 0 && ih < p.h && iw >= 0 && iw < p.w;
        v[j] = in ? __ldg(xg + (((size_t)(tl.n * p.h + ih) * p.w + tl.x0 - 4) * 3 + 2 * wi) / 2) : 0u;
      }
      if (i > 0) mbar_wait(&bar[1], (i - 1) & 1);
#pragma unroll
      for (int j = 0; j < XPER; ++j)
        if (t + j * PRODUCERS < XN) xs[t + j * PRODUCERS] = v[j];
      mbar_arrive(&bar[0]);
      if (i > 0) mbar_wait(&bar[3], (i - 1) & 1);
      const uint32_t gdst = smem_u32(sm.g);
      for (int e = t; e < DX_GR * DX_GC * 8; e += PRODUCERS) {
        const int win = e >> 3, c8 = (e & 7) * 8;
        const int py = tl.y0 / 2 - 1 + win / DX_GC, px = tl.x0 / 2 - 1 + win % DX_GC;
        const bool in = py >= 0 && py < h2 && px >= 0 && px < w2;
        cp_async16(gdst + e * 16, in ? p.g + ((size_t)(tl.n * h2 + py) * w2 + px) * C + c8 : p.g,
                   in ? 16 : 0);
      }
      cp_async_wait_all();
      mbar_arrive(&bar[2]);
    }
  } else {
    stem_dx_consumers(p, sm, tiles);
  }
}

// ---------------------------------------------------------------- K5 ----

// K5's consumers: warpgroup wg takes tile rows [8 wg, 8 wg + 8): its z1
// pixels, then its 4 rows of pool windows. The products of the next tile
// are issued before this tile's epilogue and pool, into the other of two
// accumulators, so that the tensor cores keep working through them.
__device__ __forceinline__ void stem_pool_consumers(const StemParams& p, uint8_t* w1s, uint8_t* in,
                                                    const float* b1s, uint64_t* full_bar,
                                                    uint64_t* empty_bar, int tiles) {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n");
  const int h2 = p.h / 2, w2 = p.w / 2;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, cw = tid >> 5, lane = tid & 31;
  const uint32_t w1a = smem_u32(w1s);
  const int z1row = wg ? PL_Z1_ROW1 : 0;
  const int ch0 = 16 * (cw & 3) + (lane >> 2);  // this thread's accumulator rows: ch0, ch0 + 8
  const float bias[2] = {b1s[ch0], b1s[ch0 + 8]};
  const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.f, 0.f);
  const int count = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;

  // the products of this CTA's tile i, into acc
  auto issue = [&](float (&acc)[PL_N / 2], int i) {
    mbar_wait(&full_bar[i % PL_STAGES], (i / PL_STAGES) & 1);
    fence_proxy_async();
    conv1_issue<false>(acc, w1a, smem_u32(in + i % PL_STAGES * PL_A0_BYTES), PL_P, wg * PL_N);
  };
  // tile i's z1 from acc (its products retired), then relu + 2x2 max pool;
  // only the pooled quarter leaves the chip
  auto finish = [&](const float (&acc)[PL_N / 2], int i) {
    uint8_t* z1 = in + i % PL_STAGES * PL_A0_BYTES;
    const Tile tl = tile_at(blockIdx.x + i * gridDim.x, p.h, p.w, PL_TH, PL_TW);
    store_acc<false>(acc, smem_u32(z1), z1row, [&](int h, int, float v0, float v1, uint32_t) {
      return pack_bf16(v0 + bias[h], v1 + bias[h]);
    });
    named_sync(1 + wg, 128);
    for (int e = wt; e < (PL_TH / 4) * (PL_TW / 2) * 8; e += 128) {
      const int win = e >> 3, c = e & 7;
      const int wr = win / (PL_TW / 2), wc = win % (PL_TW / 2);
      const int py = tl.y0 / 2 + wg * (PL_TH / 4) + wr, px = tl.x0 / 2 + wc;
      if (py >= h2 || px >= w2) continue;
      const int q0 = z1row + 2 * wr * PL_P + 2 * wc;
      uint4 v[4];
      v[0] = *reinterpret_cast<const uint4*>(z1 + sw128(q0, c));
      v[1] = *reinterpret_cast<const uint4*>(z1 + sw128(q0 + 1, c));
      v[2] = *reinterpret_cast<const uint4*>(z1 + sw128(q0 + PL_P, c));
      v[3] = *reinterpret_cast<const uint4*>(z1 + sw128(q0 + PL_P + 1, c));
      uint4 out;
      const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(v);
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        o[k] = __hmax2(__hmax2(__hmax2(a[k], a[4 + k]), __hmax2(a[8 + k], a[12 + k])), zero2);
      *reinterpret_cast<uint4*>(p.pooled + ((size_t)(tl.n * h2 + py) * w2 + px) * C + c * 8) = out;
    }
    mbar_arrive(&empty_bar[i % PL_STAGES]);  // the buffer may be refilled
  };

  float acc0[PL_N / 2], acc1[PL_N / 2];
  issue(acc0, 0);
  for (int i = 0; i < count; i += 2) {
    if (i + 1 < count) {
      issue(acc1, i + 1);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_acc(acc0);
    finish(acc0, i);
    if (i + 1 == count) break;
    if (i + 2 < count) {
      issue(acc0, i + 2);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_acc(acc1);
    finish(acc1, i + 1);
  }
}

__global__ void __launch_bounds__(THREADS, 1) stem_pool_kernel(StemParams p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[PL_STAGES], empty_bar[PL_STAGES];
  uint8_t* w1s = align1024(smem_raw);
  uint8_t* in = w1s + W1_BYTES;  // PL_STAGES x a0 = relu(z0), rows/cols [-1, T+1), then z1
  float* b1s = reinterpret_cast<float*>(in + PL_STAGES * PL_A0_BYTES);

  const int tid = threadIdx.x;
  const int tiles = p.m * cdiv(p.h, PL_TH) * cdiv(p.w, PL_TW);

  // The rows of a buffer past the halo are read only for the ignored
  // columns, which depend on nothing else: they are never cleared.
  stage_weights(p, w1s, b1s);
  if (tid == 0) {
    for (int b = 0; b < PL_STAGES; ++b) {
      mbar_init(&full_bar[b], PRODUCERS);
      mbar_init(&empty_bar[b], CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer: thread t loads 16-byte chunk t % 8 of pixel rows
    // t / 8 + 16 j into registers, in three batches with two in flight, and
    // stores their relu once the buffer is free
    asm volatile("setmaxnreg.dec.sync.aligned.u32 104;\n");
    const int t = tid - CONSUMERS, c = t & 7;
    constexpr int STEP = PRODUCERS / 8, BATCH = 7, BATCHES = cdiv(PL_IN_ROWS, STEP * BATCH);
    const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.f, 0.f);
    for (int tile = blockIdx.x, i = 0; tile < tiles; tile += gridDim.x, ++i) {
      const int b = i % PL_STAGES;
      const Tile tl = tile_at(tile, p.h, p.w, PL_TH, PL_TW);
      uint8_t* buf = in + b * PL_A0_BYTES;
      auto load = [&](uint4 (&v)[BATCH], int k) {
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
          const int r = (t >> 3) + (k * BATCH + j) * STEP;
          const int ih = tl.y0 - 1 + r / PL_P, iw = tl.x0 - 1 + r % PL_P;
          const bool ok = r < PL_IN_ROWS && ih >= 0 && ih < p.h && iw >= 0 && iw < p.w;
          v[j] = ok ? __ldg(reinterpret_cast<const uint4*>(
                          p.x + ((size_t)(tl.n * p.h + ih) * p.w + iw) * C + c * 8))
                    : make_uint4(0u, 0u, 0u, 0u);
        }
      };
      auto store = [&](uint4 (&v)[BATCH], int k) {
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
          const int r = (t >> 3) + (k * BATCH + j) * STEP;
          if (r >= PL_IN_ROWS) break;
          __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&v[j]);
#pragma unroll
          for (int e = 0; e < 4; ++e) hv[e] = __hmax2(hv[e], zero2);
          *reinterpret_cast<uint4*>(buf + sw128(r, c)) = v[j];
        }
      };
      uint4 v[2][BATCH];
      load(v[0], 0);
#pragma unroll
      for (int k = 0; k < BATCHES; ++k) {
        if (k + 1 < BATCHES) load(v[(k + 1) & 1], k + 1);
        if (k == 0 && i >= PL_STAGES) mbar_wait(&empty_bar[b], (i / PL_STAGES + 1) & 1);
        store(v[k & 1], k);
      }
      fence_proxy_async();
      mbar_arrive(&full_bar[b]);
    }
  } else {
    stem_pool_consumers(p, w1s, in, b1s, full_bar, empty_bar, tiles);
  }
}

StemParams make_params(const void* x, const void* g, const void* w0, const void* b0,
                       const void* w1, const void* b1, void* dx, void* pooled, int m, int h,
                       int w) {
  StemParams p;
  p.x = static_cast<const bf16*>(x);
  p.g = static_cast<const bf16*>(g);
  p.w0 = static_cast<const bf16*>(w0);
  p.b0 = static_cast<const float*>(b0);
  p.w1 = static_cast<const bf16*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.dx = static_cast<float*>(dx);
  p.pooled = static_cast<bf16*>(pooled);
  p.m = m;
  p.h = h;
  p.w = w;
  return p;
}

// ------------------------------------------------------- the f32 form ----
//
// K4F and K5F: the same functions for a float32 trunk (JAX's Pallas
// kernels take the trunk's dtype as it comes, f32 included), in f32 with
// f32 accumulation: plain SIMT FFMA, no TF32 and no bf16 anywhere, every
// sum in a fixed order, so two launches give the same bits.
//
// What bounds both is conv1's 3x3 64->64 product at the f32 FFMA rate
// (67 TFLOP/s on an H100 SXM). In f32, conv1's weights alone (147,456 B)
// and a 16x16 tile's a0 and z1 with their halos (226 KB) each fill a CTA's
// shared memory, so K4F does not keep its intermediates on chip as K4
// does: it runs as four passes, two scratch tensors of f32 in device
// memory between them (the wrapper allocates them; 2 x 1.07 GB at 16
// pages of 512^2, what autograd of the plain stem keeps as well), each
// laid out as 64 planes a page, (M, 64, H, sf_pitch(W)), so that a row
// piece of 4 columns is one aligned 16-byte copy or store:
//
//   1. stem_f32_conv0            a0  = relu(conv0(x) + b0)
//   2. stem_f32_conv1<GRAD>      gz1 = g routed to the first max of
//                                      relu(conv1(a0) + b1) in each 2x2
//                                      window, only where that is > 0
//   3. stem_f32_conv1<DGRAD>     gz0 = dgrad_conv1(gz1) where a0 > 0,
//                                      written over a0 (each element is
//                                      read and written by one thread)
//   4. stem_f32_dx               dx  = dgrad_conv0(gz0)
//
// K5F is the conv1 kernel with the pool as its epilogue (POOL), relu
// applied to z0 as it is read: nothing but the pooled quarter is written.
//
// stem_f32_conv1 (v2; v1 staged each 16-channel chunk synchronously, one
// CTA of 8 warps an SM in DGRAD, a CTA per tile):
//   - Persistent CTAs, two an SM (16 warps in every mode: a thread holds
//     at most 64 sums and 128 registers): the launcher starts min(tiles,
//     2 x SMs) CTAs and CTA b walks tiles b, b + grid, ... over (page,
//     tile row, tile column), column fastest.
//   - A ring of 3 stages, each one chunk of 8 input channels: the tile's
//     input window, channel-major, zero outside the page (GRAD, DGRAD:
//     16-byte cp.async copies of the planes' row pieces, cut at the page's
//     edge by the source size; POOL: 4-byte copies that turn K5F's NHWC
//     z0 channel-major as they land), and the chunk's weights (9 taps x 8
//     channels x 64 outputs, 16-byte copies). A stage is filled two chunks
//     ahead, across tile ends, so the copies run under the FFMAs; one
//     __syncthreads a chunk both publishes a stage and frees the one read
//     before it.
//   - Register-blocked outer products: a thread owns 2 x 4 output pixels x
//     8 output channels (GRAD, POOL: tile 16 x 16) or x 4 (DGRAD, tile 8 x
//     16). Per input channel it loads its window's 4 rows x 6 columns once
//     (a float and a float4 and a float a row) and runs the 9 taps on them
//     with the taps' weights as float4s: 30 shared loads for 576 FFMA (21
//     for 288 in DGRAD). A warp is 8 pixel groups x 4 channel groups, so
//     each load is one shared wavefront: rows of 24 floats put a warp's 8
//     windows on distinct banks, and each channel's window starts 4 banks
//     after the last one, so a 4-byte copy's 8 channels x 4 pixels land on
//     32 banks.
//   - The weights are staged per chunk and tile, not once per CTA: 147 KB
//     of resident f32 weights leave room for one CTA an SM, while
//     restaging reads 147 KB of L2 a tile (about 0.4 TB/s over the card at
//     the FFMA rate). tools/f32_variants.py measures what the restaging
//     (and the window's) costs.
//
// The two dgrads sum in blocks, as a library's blocked product does: the
// conv1 dgrad each chunk's 72 terms (8 channels x 9 taps) apart, then the
// 8 chunk sums; conv0's each tap's 64, then the 9 tap sums. One chain of
// 576 FFMA per value was 2.4x as far from the f64 truth as cuDNN's f32
// dgrad on a 16x16 page (3.7e-7 relative L2 against 1.5e-7, H100); blocks
// of 144 terms gave 1.0-1.1x on the card. The forward products
// feed only the pool and its routing and stay one chain per value.

struct StemF32 {
  const float* in;    // z0 (m, h, w, 64) (POOL); a0 (GRAD) or gz1 (DGRAD), planes
  const float* wt;    // (9 taps, 64 in, 64 out) of this product
  const float* bias;  // (64): POOL and GRAD
  const float* g;     // GRAD: (m, h/2, w/2, 64)
  float* out;         // POOL: pooled (m, h/2, w/2, 64); GRAD: gz1; DGRAD: a0 in,
                      // gz0 out; planes (m, 64, h, sf_pitch(w))
  int m, h, w;
};

enum { SF_POOL = 0, SF_GRAD = 1, SF_DGRAD = 2 };

constexpr int SF_THREADS = 256;
constexpr int SF_CTAS = 2;         // resident CTAs an SM: 16 warps
constexpr int SF_CK = 8;           // input channels per stage
constexpr int SF_NCH = C / SF_CK;  // stages per tile
constexpr int SF_STAGES = 3;
constexpr int SF_TW = 16;          // output columns of a tile
constexpr int SF_RP = 24;          // floats per staged window row (18 used)

template <int MODE>
struct SfTile {
  static constexpr int CO = MODE == SF_DGRAD ? 4 : 8;  // output channels of a thread
  static constexpr int CG = C / CO;                     // channel groups: 8 or 16
  static constexpr int PG = SF_THREADS / CG;            // pixel groups of 2 x 4: 32 or 16
  static constexpr int TH = PG / (SF_TW / 4) * 2;       // tile rows: 16 or 8
  static constexpr int WR = TH + 2;                     // window rows
  static constexpr int WIN = (WR * SF_RP + 28) / 32 * 32 + 4;  // floats a channel, 4 mod 32
  static constexpr int XS = SF_CK * WIN;                // floats of a stage's window
  static constexpr int STAGE = XS + 9 * SF_CK * C;      // and of its weights
  static constexpr int SMEM = SF_STAGES * STAGE * 4;    // bytes: 98,688 or 80,256
};
static_assert(SfTile<SF_GRAD>::SMEM * SF_CTAS <= 226 * 1024, "two CTAs an SM");
static_assert(SfTile<SF_GRAD>::WIN >= SfTile<SF_GRAD>::WR * SF_RP, "window fits");
static_assert(SfTile<SF_DGRAD>::WIN >= SfTile<SF_DGRAD>::WR * SF_RP, "window fits");

// Output channel of a thread's e-th sum: channel group cg's float4 (and,
// with 8, the same float4 of the upper 32 channels).
template <int CO>
__device__ __forceinline__ int sf_co(int cg, int e) {
  return CO == 8 ? (e >> 2) * 32 + 4 * cg + (e & 3) : 4 * cg + e;
}

// Row pitch of the passes' own (m, 64, h, pitch) planes: w rounded up to
// 4 floats, so a row piece of 4 columns is one aligned float4.
__host__ __device__ __forceinline__ int sf_pitch(int w) { return (w + 3) & ~3; }

template <int MODE>
__device__ __forceinline__ void sf_tile(const StemF32& p, int tile, int& n, int& oh0, int& ow0) {
  const int tw = cdiv(p.w, SF_TW), per = cdiv(p.h, SfTile<MODE>::TH) * tw;
  n = tile / per;
  const int t = tile - n * per;
  oh0 = t / tw * SfTile<MODE>::TH;
  ow0 = t % tw * SF_TW;
}

// Copies chunk c0 .. c0 + 7 of `tile`'s window and weights into `stage`.
template <int MODE>
__device__ __forceinline__ void sf_fill(const StemF32& p, float* stage, int tile, int c0,
                                         int tid) {
  using T = SfTile<MODE>;
  int n, oh0, ow0;
  sf_tile<MODE>(p, tile, n, oh0, ow0);
  const uint32_t xs = smem_u32(stage), ws = smem_u32(stage + T::XS);
  // window rows oh0 - 1 .. oh0 + TH; row columns ow0 - 4 .. ow0 + 19, of
  // which ow0 - 1 .. ow0 + 16 are read; zero outside the page (conv1's padding)
  if (MODE == SF_POOL) {  // z0, NHWC: 4-byte copies, channel-major as they land
    for (int i = tid; i < T::WR * (SF_TW + 2) * SF_CK; i += SF_THREADS) {
      const int c = i % SF_CK, pix = i / SF_CK;
      const int r = pix / (SF_TW + 2), col = pix % (SF_TW + 2);
      const int ih = oh0 + r - 1, iw = ow0 + col - 1;
      const bool in = ih >= 0 && ih < p.h && iw >= 0 && iw < p.w;
      const float* src = in ? p.in + ((size_t)(n * p.h + ih) * p.w + iw) * C + c0 + c : p.in;
      cp_async4(xs + (uint32_t)(c * T::WIN + r * SF_RP + col + 3) * 4, src, in ? 4 : 0);
    }
  } else {  // a0 or gz1, the passes' own planes: 16-byte copies of row pieces; a
            // thread copies one piece (window row r, 4 columns q) of CPT channels
    constexpr int PIECES = T::WR * (SF_RP / 4), CPT = SF_CK / (SF_THREADS / PIECES);
    static_assert(SF_CK % (SF_THREADS / PIECES) == 0, "whole channel groups");
    if (tid < PIECES * (SF_CK / CPT)) {
      const int q = tid % (SF_RP / 4), r = tid / (SF_RP / 4) % T::WR, c = tid / PIECES * CPT;
      const int ih = oh0 + r - 1, col = ow0 - 4 + 4 * q, wp = sf_pitch(p.w);
      const int bytes = ih >= 0 && ih < p.h && col >= 0 && col < p.w ? 4 * min(4, p.w - col) : 0;
      const float* src = p.in + ((size_t)(n * C + c0 + c) * p.h + ih) * wp + col;
      const uint32_t dst = xs + (uint32_t)(c * T::WIN + r * SF_RP + 4 * q) * 4;
#pragma unroll
      for (int k = 0; k < CPT; ++k)
        cp_async16(dst + k * T::WIN * 4, bytes ? src + (size_t)k * p.h * wp : p.in, bytes);
    }
  }
  // the chunk's rows (tap, c0 + cc) of the (9, 64, 64) weights: copy i is
  // 16 bytes at tap i / 128, float (i % 128) * 4 of the chunk's 8 rows
  static_assert(SF_CK * C / 4 == 128, "a chunk's tap is 128 copies");
  const float* wt = p.wt + c0 * C;
  for (int i = tid; i < 9 * SF_CK * C / 4; i += SF_THREADS)
    cp_async16(ws + (uint32_t)i * 16, wt + (i >> 7) * (C * C) + (i & 127) * 4, 16);
}

// acc[i][j][e] += the stage's 8 channels x 9 taps for the thread's pixel
// (2 rp + i, 4 cq + j) of the tile and output channel sf_co(cg, e), in
// (channel, tap) order.
template <int MODE>
__device__ __forceinline__ void sf_compute(const float* stage, int rp, int cq, int cg,
                                           float (&acc)[2][4][SfTile<MODE>::CO]) {
  using T = SfTile<MODE>;
  const float* ws = stage + T::XS;
#pragma unroll 1
  for (int cc = 0; cc < SF_CK; ++cc) {
    const float* xr = stage + cc * T::WIN + 2 * rp * SF_RP + 4 * cq;
    float xv[4][6];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(xr + r * SF_RP + 4);
      xv[r][0] = xr[r * SF_RP + 3];
      xv[r][1] = a.x;
      xv[r][2] = a.y;
      xv[r][3] = a.z;
      xv[r][4] = a.w;
      xv[r][5] = xr[r * SF_RP + 8];
      if (MODE == SF_POOL) {  // K5F's input is relu(z0)
#pragma unroll
        for (int j = 0; j < 6; ++j) xv[r][j] = fmaxf(xv[r][j], 0.f);
      }
    }
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const float* wr = ws + (tap * SF_CK + cc) * C + 4 * cg;
      float wv[T::CO];
#pragma unroll
      for (int h = 0; h < T::CO / 4; ++h) {
        const float4 t = *reinterpret_cast<const float4*>(wr + 32 * h);
        wv[4 * h] = t.x;
        wv[4 * h + 1] = t.y;
        wv[4 * h + 2] = t.z;
        wv[4 * h + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float v = xv[i + tap / 3][j + tap % 3];
#pragma unroll
          for (int e = 0; e < T::CO; ++e) acc[i][j][e] = fmaf(v, wv[e], acc[i][j][e]);
        }
    }
  }
}

// The tile's outputs from the thread's sums s (POOL, GRAD: acc; DGRAD:
// the chunk sums' total). GRAD and DGRAD write the passes' own planes: a
// float4 is 4 columns of one row of one channel.
template <int MODE>
__device__ __forceinline__ void sf_epilogue(const StemF32& p, int tile, int rp, int cq, int cg,
                                            float (&s)[2][4][SfTile<MODE>::CO]) {
  constexpr int CO = SfTile<MODE>::CO;
  int n, oh0, ow0;
  sf_tile<MODE>(p, tile, n, oh0, ow0);
  const int oh = oh0 + 2 * rp, ow = ow0 + 4 * cq;  // h and w are even: whole pairs
  if (oh >= p.h || ow >= p.w) return;
  const size_t wp = sf_pitch(p.w);
  if (MODE == SF_DGRAD) {  // gz0 = the sums where a0 > 0, over a0
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < CO; ++e) {
        float4* a = reinterpret_cast<float4*>(
            p.out + ((size_t)(n * C + sf_co<CO>(cg, e)) * p.h + oh + i) * wp + ow);
        const float4 a0 = *a;
        *a = make_float4(a0.x > 0.f ? s[i][0][e] : 0.f, a0.y > 0.f ? s[i][1][e] : 0.f,
                         a0.z > 0.f ? s[i][2][e] : 0.f, a0.w > 0.f ? s[i][3][e] : 0.f);
      }
    return;
  }
#pragma unroll
  for (int v = 0; v < 2; ++v) {  // the thread's two 2x2 pool windows
    const int wc = ow + 2 * v;
    const size_t win = ((size_t)(n * (p.h / 2) + oh / 2) * (p.w / 2) + wc / 2) * C;
#pragma unroll
    for (int h = 0; h < CO / 4; ++h) {
      const int co = sf_co<CO>(cg, 4 * h);
      float z[4][4];  // [q = row-major place in the window][channel]
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float b = __ldg(p.bias + co + e);
#pragma unroll
        for (int q = 0; q < 4; ++q) z[q][e] = s[q >> 1][2 * v + (q & 1)][4 * h + e] + b;
      }
      if (MODE == SF_POOL) {
        if (wc >= p.w) continue;
        float mx[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e] = fmaxf(fmaxf(fmaxf(z[0][e], 0.f), fmaxf(z[1][e], 0.f)),
                        fmaxf(fmaxf(z[2][e], 0.f), fmaxf(z[3][e], 0.f)));
        *reinterpret_cast<float4*>(p.out + win + co) = make_float4(mx[0], mx[1], mx[2], mx[3]);
        continue;
      }
      // GRAD: the window's cotangent to its first maximum of relu(z),
      // row-major, where z > 0 there; written over the window's sums
      float gv[4] = {0.f, 0.f, 0.f, 0.f};
      if (wc < p.w) {
        const float4 gt = __ldg(reinterpret_cast<const float4*>(p.g + win + co));
        gv[0] = gt.x;
        gv[1] = gt.y;
        gv[2] = gt.z;
        gv[3] = gt.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int best = 0;
        float top = fmaxf(z[0][e], 0.f);
#pragma unroll
        for (int q = 1; q < 4; ++q) {
          const float t = fmaxf(z[q][e], 0.f);
          if (t > top) {
            top = t;
            best = q;
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          s[q >> 1][2 * v + (q & 1)][4 * h + e] = (q == best && z[q][e] > 0.f) ? gv[e] : 0.f;
      }
    }
  }
  if (MODE == SF_GRAD) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < CO; ++e)
        *reinterpret_cast<float4*>(
            p.out + ((size_t)(n * C + sf_co<CO>(cg, e)) * p.h + oh + i) * wp + ow) =
            make_float4(s[i][0][e], s[i][1][e], s[i][2][e], s[i][3][e]);
  }
}

template <int MODE>
__global__ void __launch_bounds__(SF_THREADS, SF_CTAS) stem_f32_conv1(const StemF32 p) {
  using T = SfTile<MODE>;
  extern __shared__ __align__(16) float sf_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // a warp: 8 pixel groups x 4 channel groups
  const int pg = warp % (T::PG / 8) * 8 + lane / 4, cg = warp / (T::PG / 8) * 4 + lane % 4;
  const int rp = pg / (SF_TW / 4), cq = pg % (SF_TW / 4);
  const int grid = (int)gridDim.x, b = (int)blockIdx.x;
  const int tiles = p.m * cdiv(p.h, T::TH) * cdiv(p.w, SF_TW);
  const int steps = (tiles - b + grid - 1) / grid * SF_NCH;  // stage s: tile b + s / NCH * grid
#pragma unroll
  for (int s = 0; s < SF_STAGES - 1; ++s) {
    if (s < steps)
      sf_fill<MODE>(p, sf_smem + s * T::STAGE, b + s / SF_NCH * grid, s % SF_NCH * SF_CK, tid);
    cp_async_commit();
  }
  float acc[2][4][T::CO], tot[2][4][T::CO];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < T::CO; ++e) acc[i][j][e] = tot[i][j][e] = 0.f;
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    const int nx = s + SF_STAGES - 1;
    cp_async_wait<SF_STAGES - 2>();  // this thread's copies of stage s have landed
    __syncthreads();                 // everyone's; and stage s - 1 is read
    if (nx < steps)
      sf_fill<MODE>(p, sf_smem + nx % SF_STAGES * T::STAGE, b + nx / SF_NCH * grid,
                     nx % SF_NCH * SF_CK, tid);
    cp_async_commit();
    sf_compute<MODE>(sf_smem + s % SF_STAGES * T::STAGE, rp, cq, cg, acc);
    if (MODE == SF_DGRAD) {  // the chunk's block sum into the total
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < T::CO; ++e) {
            tot[i][j][e] += acc[i][j][e];
            acc[i][j][e] = 0.f;
          }
    }
    if (s % SF_NCH == SF_NCH - 1) {
      if constexpr (MODE == SF_DGRAD)
        sf_epilogue<MODE>(p, b + s / SF_NCH * grid, rp, cq, cg, tot);
      else
        sf_epilogue<MODE>(p, b + s / SF_NCH * grid, rp, cq, cg, acc);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < T::CO; ++e) acc[i][j][e] = tot[i][j][e] = 0.f;
    }
  }
  cp_async_wait<0>();
}

constexpr int SF_PIX_THREADS = 256;  // stem_f32_conv0: one pixel a thread

// Pass 1: a0 = relu(conv0(x) + b0), one pixel x 64 channels a thread, the
// 27 products of each channel in (ky, kx, input channel) order, written
// as (m, 64, h, pitch) planes (v1 wrote NHWC rows of 256 bytes a thread).
__global__ void __launch_bounds__(SF_PIX_THREADS, 2) stem_f32_conv0(const float* __restrict__ x,
                                                                 const float* __restrict__ w0,
                                                                 const float* __restrict__ b0,
                                                                 float* __restrict__ a0, int m,
                                                                 int h, int w) {
  __shared__ __align__(16) float ws[27 * C];  // [k][out]
  for (int i = threadIdx.x; i < 27 * C; i += SF_PIX_THREADS) ws[i % 27 * C + i / 27] = w0[i];
  __syncthreads();
  const size_t pix = (size_t)blockIdx.x * SF_PIX_THREADS + threadIdx.x;
  if (pix >= (size_t)m * h * w) return;
  const int ox = (int)(pix % w), oy = (int)(pix / w % h);
  const size_t n = pix / ((size_t)w * h);
  float xv[27];  // the pixel's window, loaded before any product
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const int iy = oy + t / 3 - 1, ix = ox + t % 3 - 1;
    const bool in = iy >= 0 && iy < h && ix >= 0 && ix < w;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      xv[3 * t + c] = in ? __ldg(x + ((n * h + iy) * w + ix) * 3 + c) : 0.f;
  }
  float acc[C];
#pragma unroll
  for (int o = 0; o < C; ++o) acc[o] = 0.f;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = xv[3 * t + c];
      const float4* wv = reinterpret_cast<const float4*>(ws + (t * 3 + c) * C);
#pragma unroll
      for (int j = 0; j < C / 4; ++j) {
        const float4 q = wv[j];
        acc[4 * j] = fmaf(v, q.x, acc[4 * j]);
        acc[4 * j + 1] = fmaf(v, q.y, acc[4 * j + 1]);
        acc[4 * j + 2] = fmaf(v, q.z, acc[4 * j + 2]);
        acc[4 * j + 3] = fmaf(v, q.w, acc[4 * j + 3]);
      }
    }
  }
  const size_t plane = (size_t)h * sf_pitch(w);  // a warp's stores: one row piece
  float* out = a0 + n * C * plane + (size_t)oy * sf_pitch(w) + ox;
#pragma unroll
  for (int o = 0; o < C; ++o) out[o * plane] = fmaxf(acc[o] + __ldg(b0 + o), 0.f);
}

// Pass 4 (v2; v1 ran one pixel a thread on 9 x 256-byte NHWC reads of
// gz0 through L1): dx = dgrad_conv0(gz0) for an 8 x 32 tile a CTA, two
// CTAs an SM. The tile's window of gz0's planes (64 channels x 10 rows x
// columns ow0 - 4 .. ow0 + 35) is copied into shared memory once by
// 16-byte cp.async (zero outside the page), and the weights as a float4
// (w0[o, 0..2] at the tap) per (tap, o). A thread owns one pixel, a warp
// one row: dx[p, c] = sum over taps (ky, kx) of the sum over o of
// gz0[p + (1 - ky, 1 - kx), o] * w0[o, c, ky, kx], each tap's 64 terms in
// o order, then the tap sums in tap order. Its bound is reading gz0 once
// (0.32 ms at 16 pages of 512^2).
constexpr int DXF_TH = 8, DXF_TW = 32;  // output tile
constexpr int DXF_THREADS = DXF_TH * DXF_TW;
constexpr int DXF_WR = DXF_TH + 2;      // window rows
constexpr int DXF_RP = DXF_TW + 8;      // floats a window row: columns ow0 - 4 .. ow0 + 35
constexpr int DXF_SMEM = (C * DXF_WR * DXF_RP + 9 * C * 4) * 4;  // 111,616 bytes
static_assert(2 * (DXF_SMEM + 1024) <= 228 * 1024, "two CTAs an SM");

__global__ void __launch_bounds__(DXF_THREADS, 2) stem_f32_dx(const float* __restrict__ gz0,
                                                              const float* __restrict__ w0,
                                                              float* __restrict__ dx, int m,
                                                              int h, int w) {
  extern __shared__ __align__(16) float dxf_smem[];
  const float* gs = dxf_smem;  // [channel][window row][DXF_RP]
  float4* ws = reinterpret_cast<float4*>(dxf_smem + C * DXF_WR * DXF_RP);  // [tap][o]
  const int tw = cdiv(w, DXF_TW), per = cdiv(h, DXF_TH) * tw;
  const int n = (int)blockIdx.x / per, t = (int)blockIdx.x % per;
  const int oh0 = t / tw * DXF_TH, ow0 = t % tw * DXF_TW;
  const int tid = threadIdx.x, wp = sf_pitch(w);
  const uint32_t gsa = smem_u32(dxf_smem);
  for (int i = tid; i < C * DXF_WR * (DXF_RP / 4); i += DXF_THREADS) {
    const int q = i % (DXF_RP / 4), r = i / (DXF_RP / 4) % DXF_WR, c = i / (DXF_RP / 4 * DXF_WR);
    const int ih = oh0 + r - 1, col = ow0 - 4 + 4 * q;
    const int bytes = ih >= 0 && ih < h && col >= 0 && col < w ? 4 * min(4, w - col) : 0;
    const float* src = bytes ? gz0 + ((size_t)(n * C + c) * h + ih) * wp + col : gz0;
    cp_async16(gsa + (uint32_t)i * 16, src, bytes);
  }
  cp_async_commit();
  for (int i = tid; i < 9 * C; i += DXF_THREADS) {
    const float* r = w0 + (i % C) * 27 + i / C * 3;  // w0 rows (64 out, 27): k = tap * 3 + in
    ws[i] = make_float4(r[0], r[1], r[2], 0.f);
  }
  cp_async_wait<0>();
  __syncthreads();
  const int r = tid / DXF_TW, c = tid % DXF_TW;
  float d0 = 0.f, d1 = 0.f, d2 = 0.f;
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const float* gp = gs + (r + 2 - tap / 3) * DXF_RP + c + 5 - tap % 3;
    const float4* wt = ws + tap * C;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
#pragma unroll 16
    for (int o = 0; o < C; ++o) {
      const float g = gp[o * DXF_WR * DXF_RP];
      const float4 u = wt[o];
      a0 = fmaf(g, u.x, a0);
      a1 = fmaf(g, u.y, a1);
      a2 = fmaf(g, u.z, a2);
    }
    d0 += a0;
    d1 += a1;
    d2 += a2;
  }
  const int py = oh0 + r, px = ow0 + c;
  if (py >= h || px >= w) return;
  float* o = dx + ((size_t)(n * h + py) * w + px) * 3;
  o[0] = d0;
  o[1] = d1;
  o[2] = d2;
}

// The f32 passes' weights from the stem's OIHW weights, in one launch:
// wbuf = [w1f (9 taps, 64 in, 64 out): conv1 forward | w1b (9, 64, 64):
// its dgrad, w1b[t][a][b] = w1[a][b][8 - t] | w0t (64 out, 27), k = tap * 3
// + in]. ops/kernels/vgg_stem.py's _f32_conv1_taps and _w0_rows are its
// plain version.
constexpr int SF_WBUF = 2 * 9 * C * C + C * 27;  // floats

__global__ void stem_f32_weights(const float* __restrict__ w0, const float* __restrict__ w1,
                                 float* __restrict__ wbuf, int with_dgrad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < 9 * C * C) {  // w1f[t][in][out] = w1[out][in][t]
    const int t = i / (C * C), ci = i / C % C, co = i % C;
    wbuf[i] = w1[(co * C + ci) * 9 + t];
  } else if (i < 2 * 9 * C * C) {
    if (!with_dgrad) return;
    const int j = i - 9 * C * C, t = j / (C * C), a = j / C % C, b = j % C;
    wbuf[i] = w1[(a * C + b) * 9 + 8 - t];
  } else if (i < SF_WBUF) {  // w0t[o][t * 3 + in] = w0[o][in][t]
    if (!with_dgrad) return;
    const int j = i - 2 * 9 * C * C, o = j / 27, t = j % 27 / 3, ci = j % 3;
    wbuf[i] = w0[(o * 3 + ci) * 9 + t];
  }
}

template <int MODE>
cudaError_t launch_f32_conv1(const StemF32& p, int sms, cudaStream_t stream) {
  using T = SfTile<MODE>;
  const cudaError_t e = cudaFuncSetAttribute(stem_f32_conv1<MODE>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return e;
  const long long tiles = (long long)p.m * cdiv(p.h, T::TH) * cdiv(p.w, SF_TW);
  const long long grid = tiles < (long long)SF_CTAS * sms ? tiles : (long long)SF_CTAS * sms;
  stem_f32_conv1<MODE><<<(unsigned)grid, SF_THREADS, T::SMEM, stream>>>(p);
  return cudaGetLastError();
}

bool f32_geometry_ok(int m, int h, int w, int sms) {
  return m >= 1 && m <= 65535 && h >= 2 && w >= 2 && h % 2 == 0 && w % 2 == 0 && sms >= 1 &&
         (long long)m * cdiv(h, 8) * cdiv(w, SF_TW) * SF_NCH < (1ll << 31) &&
         (long long)m * h * w / SF_PIX_THREADS < (1ll << 31);
}

unsigned pix_blocks(int m, int h, int w) {
  return (unsigned)(((long long)m * h * w + SF_PIX_THREADS - 1) / SF_PIX_THREADS);
}

}  // namespace

extern "C" {

// K4. x (m, h, w, 3) bf16, g (m, h/2, w/2, 64) bf16, w0 (64 out, 27) bf16,
// b0/b1 (64) f32, w1 (9, 64 out, 64 in) bf16, 16-byte aligned -> dx (m, h,
// w, 3) f32. h and w even; grid: persistent CTAs, 1 <= grid <= tiles.
int tsii_stem_dx(const void* x, const void* g, const void* w0, const void* b0, const void* w1,
                 const void* b1, void* dx, int m, int h, int w, int grid, void* stream) {
  if (grid < 1 || grid > m * cdiv(h, DX_TH) * cdiv(w, DX_TW)) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      stem_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DX_SMEM);
  if (e != cudaSuccess) return (int)e;
  const StemParams p = make_params(x, g, w0, b0, w1, b1, dx, nullptr, m, h, w);
  stem_dx_kernel<<<grid, THREADS, DX_SMEM, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// K5. z0 (m, h, w, 64) bf16, w1 (9, 64 out, 64 in) bf16, b1 (64) f32
// -> pooled (m, h/2, w/2, 64) bf16. h and w even; grid as for K4.
int tsii_stem_pool(const void* z0, const void* w1, const void* b1, void* pooled, int m, int h,
                   int w, int grid, void* stream) {
  if (grid < 1 || grid > m * cdiv(h, PL_TH) * cdiv(w, PL_TW)) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      stem_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PL_SMEM);
  if (e != cudaSuccess) return (int)e;
  const StemParams p = make_params(z0, nullptr, nullptr, nullptr, w1, b1, nullptr, pooled, m, h, w);
  stem_pool_kernel<<<grid, THREADS, PL_SMEM, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// K4F. x (m, h, w, 3) f32, g (m, h/2, w/2, 64) f32, w0 (64, 3, 3, 3) and w1
// (64, 64, 3, 3) f32 as the stem holds them (OIHW), b0/b1 (64) f32;
// scratch wbuf (SF_WBUF floats: the passes' re-laid weights), a0 and gz1
// (m, 64, h, sf_pitch(w)) f32 -> dx (m, h, w, 3) f32. h and w even;
// 16-byte aligned; sms: the card's SMs (the conv1 passes' persistent
// grids). Five kernels on `stream`, in order; returns the first error.
int tsii_stem_dx_f32(const void* x, const void* g, const void* w0, const void* b0,
                     const void* w1, const void* b1, void* wbuf, void* a0, void* gz1, void* dx,
                     int m, int h, int w, int sms, void* stream) {
  if (!f32_geometry_ok(m, h, w, sms)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wb = static_cast<float*>(wbuf);
  const float *w1f = wb, *w1b = wb + 9 * C * C, *w0t = wb + 2 * 9 * C * C;
  stem_f32_weights<<<cdiv(SF_WBUF, 256), 256, 0, s>>>(static_cast<const float*>(w0),
                                                      static_cast<const float*>(w1), wb, 1);
  stem_f32_conv0<<<pix_blocks(m, h, w), SF_PIX_THREADS, 0, s>>>(
      static_cast<const float*>(x), w0t, static_cast<const float*>(b0), static_cast<float*>(a0),
      m, h, w);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  StemF32 p{static_cast<const float*>(a0), w1f, static_cast<const float*>(b1),
            static_cast<const float*>(g), static_cast<float*>(gz1), m, h, w};
  if ((e = launch_f32_conv1<SF_GRAD>(p, sms, s)) != cudaSuccess) return (int)e;
  p.in = static_cast<const float*>(gz1);
  p.wt = w1b;
  p.bias = nullptr;
  p.g = nullptr;
  p.out = static_cast<float*>(a0);
  if ((e = launch_f32_conv1<SF_DGRAD>(p, sms, s)) != cudaSuccess) return (int)e;
  if ((e = cudaFuncSetAttribute(stem_f32_dx, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                DXF_SMEM)) != cudaSuccess)
    return (int)e;
  stem_f32_dx<<<(unsigned)(m * cdiv(h, DXF_TH) * cdiv(w, DXF_TW)), DXF_THREADS, DXF_SMEM, s>>>(
      static_cast<const float*>(a0), w0t, static_cast<float*>(dx), m, h, w);
  return (int)cudaGetLastError();
}

// K5F. z0 (m, h, w, 64) f32, w1 (64, 64, 3, 3) f32, b1 (64) f32, scratch
// wbuf (9 * 64 * 64 floats) -> pooled (m, h/2, w/2, 64) f32. h and w even;
// 16-byte aligned; sms as for K4F.
int tsii_stem_pool_f32(const void* z0, const void* w1, const void* b1, void* wbuf, void* pooled,
                       int m, int h, int w, int sms, void* stream) {
  if (!f32_geometry_ok(m, h, w, sms)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  stem_f32_weights<<<cdiv(9 * C * C, 256), 256, 0, s>>>(nullptr, static_cast<const float*>(w1),
                                                        static_cast<float*>(wbuf), 0);
  const StemF32 p{static_cast<const float*>(z0), static_cast<const float*>(wbuf),
                  static_cast<const float*>(b1), nullptr, static_cast<float*>(pooled), m, h, w};
  return (int)launch_f32_conv1<SF_POOL>(p, sms, s);
}

// Resident CTAs an SM of K4F/K5F's kernels, as the occupancy calculator
// gives them: which 0 POOL, 1 GRAD, 2 DGRAD (conv1), 3 the dx pass.
int tsii_stem_f32_occupancy(int which) {
  int n = 0;
  cudaError_t e = cudaSuccess;
  switch (which) {
    case 0:
      e = cudaFuncSetAttribute(stem_f32_conv1<SF_POOL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SfTile<SF_POOL>::SMEM);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, stem_f32_conv1<SF_POOL>, SF_THREADS,
                                                          SfTile<SF_POOL>::SMEM);
      break;
    case 1:
      e = cudaFuncSetAttribute(stem_f32_conv1<SF_GRAD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SfTile<SF_GRAD>::SMEM);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, stem_f32_conv1<SF_GRAD>, SF_THREADS,
                                                          SfTile<SF_GRAD>::SMEM);
      break;
    case 2:
      e = cudaFuncSetAttribute(stem_f32_conv1<SF_DGRAD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SfTile<SF_DGRAD>::SMEM);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, stem_f32_conv1<SF_DGRAD>,
                                                          SF_THREADS, SfTile<SF_DGRAD>::SMEM);
      break;
    case 3:
      e = cudaFuncSetAttribute(stem_f32_dx, cudaFuncAttributeMaxDynamicSharedMemorySize, DXF_SMEM);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, stem_f32_dx, DXF_THREADS,
                                                          DXF_SMEM);
      break;
    default:
      return -1;
  }
  return e == cudaSuccess ? n : -(int)e;
}

}  // extern "C"
