// BatchNorm's glue for Hopper: the batch statistics, the normalisation, the
// activation after it and the cast, forward and backward, on NHWC
// activations seen as (rows, C), C contiguous, in bf16 or f32, with f32
// statistics and affine (flax's arithmetic, which the eager chain of
// ops/kernels/batchnorm.py::batchnorm_plain spells out):
//
//   mean = E[x], var = max(E[x^2] - mean^2, 0), rstd = rsqrt(var + eps)
//   z = (x - mean) * (rstd * w) + b,  y = act(cast(z))   act: none, relu, relu6, leaky 0.2
//
// Four kernels: bn_stats (the sums of x and x^2), bn_apply (y; in eval and
// frozen mode the only launch, on the running statistics), bn_bwd_reduce
// (the sums of g and g * (x - mean), g the cotangent of z) and bn_bwd_dx
// (dx = scale * (g - Sum g / M - xhat * Sum g xhat / M), or scale * g on
// the running statistics).
//
// Replaces no TPU kernel: the JAX package leaves flax's BatchNorm to XLA,
// which fuses the glue itself; PyTorch's eager chain ran some 8 generic
// kernels forward (f32 copies of x among them), autograd's chain of the
// same backward and the activation apart.
//
// What bounds it is bytes. The function needs 10 bytes an element in bf16
// training (x read and y written forward, dy and x read and dx written
// backward) and 4 in eval; these two passes each way move 16 in training:
// the forward reads x twice (the sums, then the normalisation), the
// backward dy and x twice. At 3.35 TB/s Xception's training step (2.3 G
// elements through BatchNorm) needs 6.9 ms at 10 bytes, 11 ms at 16. The
// design moves each byte once per pass and keeps every other quantity per
// channel:
//
//  * A CTA owns an equal share of the rows (row block b of nb: rows
//    [b * rows / nb, (b + 1) * rows / nb)) and a block of `cvb` channel
//    vectors (16 bytes of a row each: 8 bf16 or 4 f32 channels, or 1 where
//    C is not a multiple).
//    Its threads are `lanes` x `cvb`: thread (lane, j) walks rows lane,
//    lane + lanes, ... of its range at channel vector j (bn_apply from the
//    range's end down), BN_UNROLL rows in flight, so that neighbouring
//    threads read neighbouring 16 bytes and a warp's loads cover whole
//    rows of the block. The reducing kernels and bn_bwd_dx are held to 64
//    registers, two CTAs an SM: the grid is one wave of them.
//  * A lane keeps its channels' constants (mean, scale, bias) and its sums
//    in registers; the sums of a CTA's lanes are added by a fixed-order
//    tree in shared memory and written to the CTA's own slot. The last CTA
//    of a channel block (a ticket counter, reset by that CTA) adds the
//    slots in row-block order. No float atomics, so every run gives the
//    same bits. ops/kernels/batchnorm.py::bn_plan narrows the channel
//    blocks where C is wide, so that the fold, which one SM does, reads
//    at most BN_FOLD_BYTES.
//  * bn_stats writes the means of x and x^2; each CTA of bn_apply turns them
//    into mean, rstd and scale for its channels, so the data-parallel sum
//    of the two means over the ranks fits between the two launches, and its
//    first row block also writes the vectors the backward keeps and moves
//    the running statistics (momentum 0.1, the biased variance).
//  * The backward recomputes z from x, so the forward keeps x in its own
//    dtype and 4 vectors of C floats, nothing per element in f32.
//
// z is formed as the eager chain's three f32 tensor ops round it (no fused
// multiply-add) and the activation acts on z cast to x's dtype, as it acts
// on BatchNorm's output there; its backward masks by that value and, for
// the leaky slope, rounds dy * 0.2 to x's dtype as autograd does.
//
// Plain C interface (loaded with ctypes); each launcher returns
// cudaGetLastError() right after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BN_THREADS = 512;  // the most threads of a CTA (lanes * cvb)
constexpr int BN_UNROLL = 4;     // rows a lane has in flight reading one tensor
constexpr int BN_UNROLL2 = 2;    // the same reading two (dy and x)
// CTAs an SM the reducing kernels and bn_bwd_dx are held to (64 registers)
constexpr int BN_MIN_CTAS = 2;

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_RELU6 = 2, ACT_LEAKY = 3 };
constexpr float LEAKY_SLOPE = 0.2f;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// a Pack moved as one 16-, 4- or 2-byte word
template <int BYTES>
struct Word;
template <>
struct Word<16> {
  using type = uint4;
};
template <>
struct Word<4> {
  using type = uint32_t;
};
template <>
struct Word<2> {
  using type = uint16_t;
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> ld(const Pack<T, VEC>* p) {
  using W = typename Word<sizeof(Pack<T, VEC>)>::type;
  Pack<T, VEC> out;
  *reinterpret_cast<W*>(&out) = *reinterpret_cast<const W*>(p);
  return out;
}

template <typename T, int VEC>
__device__ __forceinline__ void st(Pack<T, VEC>* p, const Pack<T, VEC>& v) {
  using W = typename Word<sizeof(Pack<T, VEC>)>::type;
  *reinterpret_cast<W*>(p) = *reinterpret_cast<const W*>(&v);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T (the cast to x's dtype) and back to f32
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// (x - mean) * scale + bias, each step rounded on its own
__device__ __forceinline__ float bn_z(float x, float mean, float scale, float bias) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mean), scale), bias);
}

// y = act(z cast to T), as a value of T
template <typename T, int ACT>
__device__ __forceinline__ float bn_act(float z) {
  const float y = round_to<T>(z);
  if (ACT == ACT_RELU) return y <= 0.f ? 0.f : y;
  if (ACT == ACT_RELU6) return y < 0.f ? 0.f : (y > 6.f ? 6.f : y);
  if (ACT == ACT_LEAKY) return y > 0.f ? y : round_to<T>(y * LEAKY_SLOPE);
  return y;
}

// the cotangent of z from dy: the activation's backward in T, then the cast's
template <typename T, int ACT>
__device__ __forceinline__ float bn_dact(float dy, float z) {
  if (ACT == ACT_NONE) return dy;
  const float y = round_to<T>(z);
  if (ACT == ACT_RELU) return y <= 0.f ? 0.f : dy;
  if (ACT == ACT_RELU6) return (y >= 0.f && y <= 6.f) ? dy : 0.f;
  return y > 0.f ? dy : round_to<T>(dy * LEAKY_SLOPE);
}

// Where thread (lane, j) of a CTA works: its channel vector and row range.
struct Place {
  int lane, j, cv, cv_all;
  int64_t r0, r1;
};

template <int VEC>
__device__ __forceinline__ Place place(int rows, int c, int cvb) {
  Place p;
  p.lane = threadIdx.x / cvb;
  p.j = threadIdx.x - p.lane * cvb;
  p.cv_all = c / VEC;
  p.cv = blockIdx.y * cvb + p.j;
  p.r0 = (int64_t)blockIdx.x * rows / gridDim.x;
  p.r1 = (int64_t)(blockIdx.x + 1) * rows / gridDim.x;
  return p;
}

// The CTA's sums of two per-channel quantities: every thread stores its
// VEC pairs, then a fixed-order tree over the lanes (lanes [h, n) add into
// [0, n - h), h = ceil(n / 2)) leaves them in lane 0's row. sm: [2][lanes][cvb * VEC].
template <int VEC>
__device__ __forceinline__ void lane_tree(const float (&a)[VEC], const float (&b)[VEC], float* sm,
                                          int lanes, int cvb, const Place& p) {
  const int width = cvb * VEC;
  float* sa = sm + p.lane * width + p.j * VEC;
  float* sb = sm + (lanes + p.lane) * width + p.j * VEC;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    sa[e] = a[e];
    sb[e] = b[e];
  }
  __syncthreads();
  for (int n = lanes; n > 1;) {
    const int h = (n + 1) / 2;
    if (p.lane < n - h) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        sa[e] += sa[h * width + e];
        sb[e] += sb[h * width + e];
      }
    }
    __syncthreads();
    n = h;
  }
}

// Writes the CTA's sums (lane 0's row of sm) to its slot of part
// ([2][row blocks][c]); then the last CTA of the channel block to finish
// adds the slots in row-block order and hands each channel's two sums to
// out(ch, a, b). Thread 0's acquire-release ticket publishes the CTA's slot
// (its writes are ordered before it by the barrier) and, in the last CTA,
// makes every other slot visible to the threads after the next barrier.
template <int VEC, typename Out>
__device__ __forceinline__ void fold_last(float* sm, float* part, unsigned* tickets, int c,
                                          int lanes, int cvb, const Place& p, Out out) {
  const int width = cvb * VEC, nb = gridDim.x;
  const int64_t plane = (int64_t)nb * c;
  if (p.lane == 0 && p.cv < p.cv_all) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int64_t at = (int64_t)blockIdx.x * c + p.cv * VEC + e;
      part[at] = sm[p.j * VEC + e];
      part[plane + at] = sm[lanes * width + p.j * VEC + e];
    }
    __threadfence();
  }
  __shared__ unsigned last;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned prev;
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;\n"
                 : "=r"(prev)
                 : "l"(tickets + blockIdx.y)
                 : "memory");
    last = prev == (unsigned)nb - 1u;
  }
  __syncthreads();
  if (!last) return;
  // fln lanes per channel each add every fln-th slot, then their sums are
  // added in lane order
  const int nt = blockDim.x, t = threadIdx.x;
  const int ch0 = blockIdx.y * width, nch = min(width, c - ch0);
  const int fln = nt >= nch ? nt / nch : 1;
  for (int i = t; i < fln * nch; i += nt) {
    const int fl = i / nch, k = i - fl * nch;
    float a = 0.f, b = 0.f;
    int rb = fl;
    for (; rb + 3 * fln < nb; rb += 4 * fln) {  // 8 loads in flight, added in order
      float va[4], vb[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int64_t at = (int64_t)(rb + u * fln) * c + ch0 + k;
        va[u] = __ldcg(part + at);
        vb[u] = __ldcg(part + plane + at);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        a += va[u];
        b += vb[u];
      }
    }
    for (; rb < nb; rb += fln) {
      const int64_t at = (int64_t)rb * c + ch0 + k;
      a += __ldcg(part + at);
      b += __ldcg(part + plane + at);
    }
    sm[i] = a;
    sm[fln * nch + i] = b;
  }
  __syncthreads();
  for (int k = t; k < nch; k += nt) {
    float a = 0.f, b = 0.f;
    for (int fl = 0; fl < fln; ++fl) {
      a += sm[fl * nch + k];
      b += sm[(fln + fl) * nch + k];
    }
    out(ch0 + k, a, b);
  }
  if (t == 0) tickets[blockIdx.y] = 0u;  // ready for the next launch on this stream
}

// stats[0:c] = E[x], stats[c:2c] = E[x^2] over the rows (f32 sums).
template <typename T, int VEC>
__global__ void __launch_bounds__(BN_THREADS, BN_MIN_CTAS) bn_stats(const T* __restrict__ x,
                                                       float* __restrict__ part,
                                                       unsigned* __restrict__ tickets,
                                                       float* __restrict__ stats, int rows, int c,
                                                       int cvb, int lanes) {
  extern __shared__ float sm[];
  const Place p = place<VEC>(rows, c, cvb);
  float s[VEC], q[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) s[e] = q[e] = 0.f;
  if (p.cv < p.cv_all) {
    const Pack<T, VEC>* px = reinterpret_cast<const Pack<T, VEC>*>(x) + p.cv;
    const int64_t step = (int64_t)lanes * p.cv_all;
    int64_t r = p.r0 + p.lane;
    for (; r + (int64_t)(BN_UNROLL - 1) * lanes < p.r1; r += (int64_t)BN_UNROLL * lanes) {
      Pack<T, VEC> v[BN_UNROLL];
#pragma unroll
      for (int u = 0; u < BN_UNROLL; ++u) v[u] = ld(px + r * p.cv_all + u * step);
#pragma unroll
      for (int u = 0; u < BN_UNROLL; ++u)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float f = to_f(v[u].v[e]);
          s[e] += f;
          q[e] = fmaf(f, f, q[e]);
        }
    }
    for (; r < p.r1; r += lanes) {
      const Pack<T, VEC> v = ld(px + r * p.cv_all);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = to_f(v.v[e]);
        s[e] += f;
        q[e] = fmaf(f, f, q[e]);
      }
    }
  }
  lane_tree<VEC>(s, q, sm, lanes, cvb, p);
  const float m = (float)rows;
  fold_last<VEC>(sm, part, tickets, c, lanes, cvb, p, [&](int ch, float a, float b) {
    stats[ch] = a / m;
    stats[c + ch] = b / m;
  });
}

// y = act(cast(z)). With stats (the batch's E[x], E[x^2], each summed over
// `world` ranks) the CTA derives mean and variance from them and its first
// row block moves the running statistics and num_batches_tracked; without,
// it normalises by the running statistics. saved (4 x c: mean, rstd,
// scale, 1 where the variance was not clamped) is written by the first row
// block where given.
template <typename T, int VEC, int ACT>
__global__ void __launch_bounds__(BN_THREADS) bn_apply(
    const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ stats,
    float* __restrict__ rmean, float* __restrict__ rvar, const float* __restrict__ w,
    const float* __restrict__ b, float* __restrict__ saved, long long* __restrict__ nbt, int rows,
    int c, int cvb, int lanes, float eps, float momentum, float keep, float world) {
  const Place p = place<VEC>(rows, c, cvb);
  if (p.cv >= p.cv_all) return;
  const bool first = blockIdx.x == 0 && p.lane == 0;
  float m[VEC], sc[VEC], bi[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int ch = p.cv * VEC + e;
    float mean, var, kept = 1.f;
    if (stats != nullptr) {
      mean = stats[ch] / world;
      const float raw = __fsub_rn(stats[c + ch] / world, __fmul_rn(mean, mean));
      var = fmaxf(raw, 0.f);
      kept = raw >= 0.f ? 1.f : 0.f;
    } else {
      mean = rmean[ch];
      var = rvar[ch];
    }
    const float rstd = rsqrtf(__fadd_rn(var, eps));
    m[e] = mean;
    sc[e] = __fmul_rn(rstd, w[ch]);
    bi[e] = b[ch];
    if (first) {
      if (saved != nullptr) {
        saved[ch] = mean;
        saved[c + ch] = rstd;
        saved[2 * c + ch] = sc[e];
        saved[3 * c + ch] = kept;
      }
      if (stats != nullptr) {
        rmean[ch] = __fadd_rn(__fmul_rn(rmean[ch], keep), __fmul_rn(momentum, mean));
        rvar[ch] = __fadd_rn(__fmul_rn(rvar[ch], keep), __fmul_rn(momentum, var));
      }
    }
  }
  if (stats != nullptr && nbt != nullptr && blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)
    *nbt += 1;
  // rows r1 - 1 - lane, - lanes, ...: from the last down, since the rows
  // bn_stats read last are the likeliest still in L2 (1-6% faster than up)
  const int64_t step = -(int64_t)lanes * p.cv_all;
  const Pack<T, VEC>* px =
      reinterpret_cast<const Pack<T, VEC>*>(x) + p.cv + (p.r1 - 1 - p.lane) * p.cv_all;
  Pack<T, VEC>* py = reinterpret_cast<Pack<T, VEC>*>(y) +
                     (px - reinterpret_cast<const Pack<T, VEC>*>(x));
  int64_t i = p.lane;
  const int64_t n = p.r1 - p.r0;
  for (; i + (int64_t)(BN_UNROLL - 1) * lanes < n; i += (int64_t)BN_UNROLL * lanes) {
    Pack<T, VEC> v[BN_UNROLL];
#pragma unroll
    for (int u = 0; u < BN_UNROLL; ++u) v[u] = ld(px + u * step);
#pragma unroll
    for (int u = 0; u < BN_UNROLL; ++u) {
      Pack<T, VEC> o;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        o.v[e] = from_f<T>(bn_act<T, ACT>(bn_z(to_f(v[u].v[e]), m[e], sc[e], bi[e])));
      st(py + u * step, o);
    }
    px += BN_UNROLL * step;
    py += BN_UNROLL * step;
  }
  for (; i < n; i += lanes, px += step, py += step) {
    const Pack<T, VEC> v = ld(px);
    Pack<T, VEC> o;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      o.v[e] = from_f<T>(bn_act<T, ACT>(bn_z(to_f(v.v[e]), m[e], sc[e], bi[e])));
    st(py, o);
  }
}

// red[0:c] = Sum g, red[c:2c] = Sum g * xhat, g the cotangent of z.
template <typename T, int VEC, int ACT>
__global__ void __launch_bounds__(BN_THREADS, BN_MIN_CTAS) bn_bwd_reduce(
    const T* __restrict__ dy, const T* __restrict__ x, const float* __restrict__ saved,
    const float* __restrict__ b, float* __restrict__ part, unsigned* __restrict__ tickets,
    float* __restrict__ red, int rows, int c, int cvb, int lanes) {
  extern __shared__ float sm[];
  const Place p = place<VEC>(rows, c, cvb);
  float sg[VEC], sx[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) sg[e] = sx[e] = 0.f;
  if (p.cv < p.cv_all) {
    float m[VEC], sc[VEC], bi[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int ch = p.cv * VEC + e;
      m[e] = saved[ch];
      sc[e] = saved[2 * c + ch];
      bi[e] = b[ch];
    }
    const Pack<T, VEC>* pd = reinterpret_cast<const Pack<T, VEC>*>(dy) + p.cv;
    const Pack<T, VEC>* px = reinterpret_cast<const Pack<T, VEC>*>(x) + p.cv;
    const int64_t step = (int64_t)lanes * p.cv_all;
    int64_t r = p.r0 + p.lane;
    for (; r + (int64_t)(BN_UNROLL2 - 1) * lanes < p.r1; r += (int64_t)BN_UNROLL2 * lanes) {
      Pack<T, VEC> vd[BN_UNROLL2], vx[BN_UNROLL2];
#pragma unroll
      for (int u = 0; u < BN_UNROLL2; ++u) {
        vd[u] = ld(pd + r * p.cv_all + u * step);
        vx[u] = ld(px + r * p.cv_all + u * step);
      }
#pragma unroll
      for (int u = 0; u < BN_UNROLL2; ++u)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xf = to_f(vx[u].v[e]);
          const float g = bn_dact<T, ACT>(to_f(vd[u].v[e]), bn_z(xf, m[e], sc[e], bi[e]));
          sg[e] += g;
          sx[e] = fmaf(g, __fsub_rn(xf, m[e]), sx[e]);
        }
    }
    for (; r < p.r1; r += lanes) {
      const Pack<T, VEC> vd = ld(pd + r * p.cv_all), vx = ld(px + r * p.cv_all);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xf = to_f(vx.v[e]);
        const float g = bn_dact<T, ACT>(to_f(vd.v[e]), bn_z(xf, m[e], sc[e], bi[e]));
        sg[e] += g;
        sx[e] = fmaf(g, __fsub_rn(xf, m[e]), sx[e]);
      }
    }
  }
  lane_tree<VEC>(sg, sx, sm, lanes, cvb, p);
  fold_last<VEC>(sm, part, tickets, c, lanes, cvb, p, [&](int ch, float a, float s) {
    red[ch] = a;
    red[c + ch] = s * saved[c + ch];
  });
}

// dx = scale * (g - Sum g * inv_m - (x - mean) * rstd * Sum g xhat * inv_m),
// the last term only where the variance was not clamped; scale * g where
// sums is null (the running statistics).
template <typename T, int VEC, int ACT>
__global__ void __launch_bounds__(BN_THREADS, BN_MIN_CTAS) bn_bwd_dx(
    const T* __restrict__ dy, const T* __restrict__ x, const float* __restrict__ saved,
    const float* __restrict__ b, const float* __restrict__ sums, T* __restrict__ dx, int rows,
    int c, int cvb, int lanes, float inv_m) {
  const Place p = place<VEC>(rows, c, cvb);
  if (p.cv >= p.cv_all) return;
  float m[VEC], sc[VEC], bi[VEC], ga[VEC], gb[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int ch = p.cv * VEC + e;
    m[e] = saved[ch];
    sc[e] = saved[2 * c + ch];
    bi[e] = b[ch];
    ga[e] = sums != nullptr ? sums[ch] * inv_m : 0.f;
    gb[e] = sums != nullptr ? saved[3 * c + ch] * saved[c + ch] * (sums[c + ch] * inv_m) : 0.f;
  }
  const int64_t step = (int64_t)lanes * p.cv_all, first = p.cv + (p.r0 + p.lane) * p.cv_all;
  const Pack<T, VEC>* pd = reinterpret_cast<const Pack<T, VEC>*>(dy) + first;
  const Pack<T, VEC>* px = reinterpret_cast<const Pack<T, VEC>*>(x) + first;
  Pack<T, VEC>* po = reinterpret_cast<Pack<T, VEC>*>(dx) + first;
  int64_t i = p.lane;
  const int64_t n = p.r1 - p.r0;
  for (; i + (int64_t)(BN_UNROLL2 - 1) * lanes < n; i += (int64_t)BN_UNROLL2 * lanes) {
    Pack<T, VEC> vd[BN_UNROLL2], vx[BN_UNROLL2];
#pragma unroll
    for (int u = 0; u < BN_UNROLL2; ++u) {
      vd[u] = ld(pd + u * step);
      vx[u] = ld(px + u * step);
    }
#pragma unroll
    for (int u = 0; u < BN_UNROLL2; ++u) {
      Pack<T, VEC> o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xf = to_f(vx[u].v[e]);
        const float g = bn_dact<T, ACT>(to_f(vd[u].v[e]), bn_z(xf, m[e], sc[e], bi[e]));
        o.v[e] = from_f<T>(sc[e] * (g - ga[e] - (xf - m[e]) * gb[e]));
      }
      st(po + u * step, o);
    }
    pd += BN_UNROLL2 * step;
    px += BN_UNROLL2 * step;
    po += BN_UNROLL2 * step;
  }
  for (; i < n; i += lanes, pd += step, px += step, po += step) {
    const Pack<T, VEC> vd = ld(pd), vx = ld(px);
    Pack<T, VEC> o;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float xf = to_f(vx.v[e]);
      const float g = bn_dact<T, ACT>(to_f(vd.v[e]), bn_z(xf, m[e], sc[e], bi[e]));
      o.v[e] = from_f<T>(sc[e] * (g - ga[e] - (xf - m[e]) * gb[e]));
    }
    st(po, o);
  }
}

struct Geometry {
  int rows, c, cvb, lanes, row_blocks, cblocks;
  dim3 grid() const { return dim3(row_blocks, cblocks); }
  int threads() const { return lanes * cvb; }
};

// The sums' shared memory: [2][lanes][cvb * VEC] floats (the fold reuses it).
template <int VEC>
size_t sums_smem(const Geometry& g) {
  return 2 * sizeof(float) * (size_t)g.threads() * VEC;
}

bool valid(const Geometry& g, int vec) {
  return g.rows > 0 && g.c > 0 && g.c % vec == 0 && g.cvb > 0 && g.lanes > 0 &&
         g.threads() <= BN_THREADS && g.row_blocks > 0 && g.row_blocks <= g.rows &&
         g.cblocks > 0 && (int64_t)g.cblocks * g.cvb * vec >= g.c;
}

// Calls f with the template arguments (T, VEC) that is_bf16 and vec name:
// the 16-byte vector of T or one element.
template <typename F>
cudaError_t by_type(int is_bf16, int vec, F f) {
  if (is_bf16) {
    if (vec == 8) return f(__nv_bfloat16(), std::integral_constant<int, 8>());
    if (vec == 1) return f(__nv_bfloat16(), std::integral_constant<int, 1>());
  } else {
    if (vec == 4) return f(float(), std::integral_constant<int, 4>());
    if (vec == 1) return f(float(), std::integral_constant<int, 1>());
  }
  return cudaErrorInvalidValue;
}

template <typename F>
cudaError_t by_act(int act, F f) {
  switch (act) {
    case ACT_NONE: return f(std::integral_constant<int, ACT_NONE>());
    case ACT_RELU: return f(std::integral_constant<int, ACT_RELU>());
    case ACT_RELU6: return f(std::integral_constant<int, ACT_RELU6>());
    case ACT_LEAKY: return f(std::integral_constant<int, ACT_LEAKY>());
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Geometry arguments of every launcher (ops/kernels/batchnorm.py::bn_plan):
// rows, c, is_bf16, vec (16 bytes of T or 1), cvb, lanes, row_blocks,
// cblocks. Tensors are contiguous (rows, c) in T; parameters, statistics
// and vectors f32. part holds 2 * row_blocks * c floats, tickets cblocks
// zeros, left zero by the launch.

int tsii_bn_stats(const void* x, void* part, void* tickets, void* stats, int rows, int c,
                  int is_bf16, int vec, int cvb, int lanes, int row_blocks, int cblocks,
                  void* stream) {
  const Geometry g{rows, c, cvb, lanes, row_blocks, cblocks};
  if (!valid(g, vec)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_type(is_bf16, vec, [&](auto t, auto v) {
    using T = decltype(t);
    constexpr int VEC = decltype(v)::value;
    bn_stats<T, VEC><<<g.grid(), g.threads(), sums_smem<VEC>(g), s>>>(
        static_cast<const T*>(x), static_cast<float*>(part), static_cast<unsigned*>(tickets),
        static_cast<float*>(stats), rows, c, cvb, lanes);
    return cudaGetLastError();
  });
}

// stats null: the running statistics normalise (eval, frozen) and stay;
// saved and nbt may be null.
int tsii_bn_apply(const void* x, void* y, const void* stats, void* rmean, void* rvar,
                  const void* w, const void* b, void* saved, void* nbt, int rows, int c,
                  int is_bf16, int vec, int cvb, int lanes, int row_blocks, int cblocks,
                  int act, float eps, float momentum, float keep, float world, void* stream) {
  const Geometry g{rows, c, cvb, lanes, row_blocks, cblocks};
  if (!valid(g, vec)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_type(is_bf16, vec, [&](auto t, auto v) {
    using T = decltype(t);
    constexpr int VEC = decltype(v)::value;
    return by_act(act, [&](auto a) {
      bn_apply<T, VEC, decltype(a)::value><<<g.grid(), g.threads(), 0, s>>>(
          static_cast<const T*>(x), static_cast<T*>(y), static_cast<const float*>(stats),
          static_cast<float*>(rmean), static_cast<float*>(rvar), static_cast<const float*>(w),
          static_cast<const float*>(b), static_cast<float*>(saved), static_cast<long long*>(nbt),
          rows, c, cvb, lanes, eps, momentum, keep, world);
      return cudaGetLastError();
    });
  });
}

int tsii_bn_bwd_reduce(const void* dy, const void* x, const void* saved, const void* b,
                       void* part, void* tickets, void* red, int rows, int c, int is_bf16, int vec,
                       int cvb, int lanes, int row_blocks, int cblocks, int act,
                       void* stream) {
  const Geometry g{rows, c, cvb, lanes, row_blocks, cblocks};
  if (!valid(g, vec)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_type(is_bf16, vec, [&](auto t, auto v) {
    using T = decltype(t);
    constexpr int VEC = decltype(v)::value;
    return by_act(act, [&](auto a) {
      bn_bwd_reduce<T, VEC, decltype(a)::value><<<g.grid(), g.threads(), sums_smem<VEC>(g), s>>>(
          static_cast<const T*>(dy), static_cast<const T*>(x), static_cast<const float*>(saved),
          static_cast<const float*>(b), static_cast<float*>(part), static_cast<unsigned*>(tickets),
          static_cast<float*>(red), rows, c, cvb, lanes);
      return cudaGetLastError();
    });
  });
}

// sums null: dx = scale * g (the running statistics).
int tsii_bn_bwd_dx(const void* dy, const void* x, const void* saved, const void* b,
                   const void* sums, void* dx, int rows, int c, int is_bf16, int vec, int cvb,
                   int lanes, int row_blocks, int cblocks, int act, float inv_m,
                   void* stream) {
  const Geometry g{rows, c, cvb, lanes, row_blocks, cblocks};
  if (!valid(g, vec)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_type(is_bf16, vec, [&](auto t, auto v) {
    using T = decltype(t);
    constexpr int VEC = decltype(v)::value;
    return by_act(act, [&](auto a) {
      bn_bwd_dx<T, VEC, decltype(a)::value><<<g.grid(), g.threads(), 0, s>>>(
          static_cast<const T*>(dy), static_cast<const T*>(x), static_cast<const float*>(saved),
          static_cast<const float*>(b), static_cast<const float*>(sums), static_cast<T*>(dx), rows,
          c, cvb, lanes, inv_m);
      return cudaGetLastError();
    });
  });
}

}  // extern "C"
