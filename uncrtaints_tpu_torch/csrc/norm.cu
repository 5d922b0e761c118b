// Norm2d on the card (kernel family K6): batch, group and instance norm over
// NHWC maps, with the affine and the GELU or ReLU that follows fused in, and
// their backward.
//
// x is [F * P, C] rows (NHWC flattened): F frames of P rows each. The batch
// norm takes one frame of all rows (F = 1); the group and instance norms one
// frame a map, G groups of C / G channels (instance: G = C). A "slot" is a
// (frame, channel) pair: coef and off [F, C] in x's dtype.
//
//   forward   statistics: per (frame, group) fp32 sums of x and x^2
//             (norm_part_kernel + the fixed-order second pass of common.cuh);
//             [the caller's collective over the sums, under a mesh]
//             norm_finalize_kernel: m = s / n, var = max(q / n - m^2, 0),
//             r = rsqrt(var + 1e-5) and each slot's coef / off, rounded to
//             x's dtype as the eager formula rounds them;
//             norm_apply_kernel: y = act(x * coef + off) (form 0; instance
//             norm: act((x - off) * coef), form 1), product and sum each
//             rounded to x's dtype, the activation in fp32 rounded once.
//   backward  g' = g * act'(pre), the pre-activation recomputed from x, coef
//             and off (no map is saved but x);
//             per-slot fp32 sums of g' and g' * x (norm_part_kernel<BWD>,
//             the second pass with one group a channel);
//             norm_bwd_finalize_kernel: the chain through coef, off, rsqrt,
//             the clamp and the moments, per (frame, group): dx = g' * coef
//             + A * x + B with A, B a slot, and dweight, dbias;
//             [the caller's collective over A and B, under a mesh]
//             norm_dx_kernel: dx, rounded once.
//
// Replaces: no Pallas kernel. On the TPU the JAX package's norms
// (uncrtaints_tpu/models/layers.py:Norm2d, _moments_f32) are plain XLA ops
// that XLA fuses: the cast into the reductions (no fp32 copy of x), the
// affine and the activation into one pass, their autodiff into the
// neighbours. Here that fusion is written by hand.
//
// Bound: device memory. The passes above read x twice (statistics, apply)
// and write y once; the backward reads g and x twice (sums, dx) and writes
// dx. What the design does about it:
// - every element moves as part of a 16-byte vector where C and the
//   pointers allow (8 bf16 or 4 fp32 channels a thread), converted to fp32
//   in registers: no fp32 copy of x and no pre-activation map is written;
// - the sums run in a grid sized to the card (about 4 blocks an SM, the
//   caller's choice of blocks a frame), a thread walking rows with four
//   (backward two) loads in flight, so the passes stream at the copy rate;
// - deterministic, no atomics: a block adds its row lanes in lane order in
//   shared memory into one partial row, the second pass adds the partials
//   in a fixed order (common.cuh:group_stats_kernel), so two runs give the
//   same bits;
// - the small per-slot math (a thread a slot, a warp a group) is one launch
//   each way, so a norm is four launches forward and four backward.
// Channel counts or pointers that rule out 16-byte vectors take the scalar
// instantiation (one channel a thread) of the same kernels.
//
// One pass (group and instance norms, no collective): a frame's statistics
// need only that frame's rows, and a slab of whole groups of one frame fits
// the card's shared memory. norm_apply_kernel_onchip and
// norm_dx_kernel_onchip do the whole forward or backward in one cooperative
// launch of one block an SM: x (and g) cross device memory once, y (dx) is
// written once. The grid walks the slabs in waves (K slabs a wave, each over
// bps blocks). A block copies its rows of the wave's slab into shared memory
// (cp.async, 16 bytes a copy) and adds its per-channel sums in lane order
// (a warp's rows folded by a shuffle tree first); it writes its per-group
// (backward: per-channel) partial; a grid barrier; every block of the slab
// adds the slab's partials in the same fixed order (same bits in every
// block, no atomics), derives coef / off (backward: A, B) exactly as the
// finalize kernels do, and applies them to its rows from shared memory. As
// the apply frees a row's slot it copies the next wave's row into it and
// adds that row's sums a few rows later, once the copy has landed: the next
// wave's reads and sums overlap this wave's writes, and only the block's
// reduction, the barrier and the per-slot math lie between two waves (about
// 5 us on an H100; ops/norm.py:onchip_plan takes one pass only where the
// waves are long enough to pay for that). The backward keeps g' = g *
// act'(pre) in fp32 in g's slot once its sums are taken, so dx does not
// recompute the activation's derivative. The partials alternate between two
// buffers by wave, so one barrier a wave suffices. The backward's dweight
// and dbias add the per-slot sums over the frames in order after one last
// barrier.
//
// The group-norm MBConv's eval chain (K6's statistics -> K3 -> K4 -> K3 ->
// K6's apply) takes the passes above one by one, and one more of this
// family: gelu_pool_part_kernel, the squeeze-and-excitation's pooled sum of
// gelu(gn2(h2)), read-only, its per-block partials added by common.cuh's
// channel_sum_kernel in a fixed order.
#include <initializer_list>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cgrp = cooperative_groups;


namespace {

constexpr int NORM_THREADS = 256;
constexpr float NORM_EPS = 1e-5f;
constexpr float GELU_ALPHA = 0.70710678118654752f;  // 1 / sqrt(2)
constexpr float GELU_BETA = 0.39894228040143268f;   // 1 / sqrt(2 pi)

// kBatchF32: the batch norm of the L-TAE / UNet3D form (flax's BatchNorm:
// the affine ((x - m) * r) * w + b in fp32, rounded once; form 2)
enum NormKind : int { kBatch = 0, kGroup = 1, kInstance = 2, kBatchF32 = 3 };
enum NormAct : int { kActNone = 0, kActGelu = 1, kActRelu = 2, kActLeaky = 3 };
constexpr float LEAKY_SLOPE = 0.01f;  // UNet3D's LeakyReLU

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// a value rounded to T and back, as an eager op on T-tensors rounds
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f32(from_f32<T>(v));
}

// the pre-activation of one element, rounded as the eager formula: form 0
// x * coef + off, form 1 (x - off) * coef, each operation rounded to T;
// form 2 ((x - off) * coef) * w + b in fp32 (coef = r, off = m), rounded once
template <typename T>
__device__ __forceinline__ float pre_act(float x, float c, float o, int form, float w, float b) {
  if (form == 0) return rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(x, c)), o));
  if (form == 1) return rnd<T>(__fmul_rn(rnd<T>(__fsub_rn(x, o)), c));
  return rnd<T>(__fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, o), c), w), b));
}

template <int ACT>
__device__ __forceinline__ float act_f(float v) {
  if constexpr (ACT == kActGelu) return gelu_exact(v);
  if constexpr (ACT == kActRelu) return v < 0.0f ? 0.0f : v;
  if constexpr (ACT == kActLeaky) return v > 0.0f ? v : v * LEAKY_SLOPE;
  return v;
}

// d act / d pre at pre (torch's GeluBackward and threshold_backward)
template <int ACT>
__device__ __forceinline__ float act_grad(float v) {
  if constexpr (ACT == kActGelu) {
    const float cdf = 0.5f * (1.0f + erff(v * GELU_ALPHA));
    const float pdf = expf(-0.5f * v * v) * GELU_BETA;
    return cdf + v * pdf;
  }
  if constexpr (ACT == kActRelu) return v > 0.0f ? 1.0f : 0.0f;
  if constexpr (ACT == kActLeaky) return v > 0.0f ? 1.0f : LEAKY_SLOPE;
  return 1.0f;
}

// element c of a per-channel vector (weight, bias, their gradients) kept in
// fp32 or bf16 (the train step hands the parameters in the compute dtype)
__device__ __forceinline__ float wload(const void* p, int code, int c) {
  return code == kBFloat16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[c])
                           : static_cast<const float*>(p)[c];
}
__device__ __forceinline__ void wstore(void* p, int code, int c, float v) {
  if (code == kBFloat16)
    static_cast<__nv_bfloat16*>(p)[c] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[c] = v;
}

// Form 2's per-channel weight and bias (w, b in wcode's dtype); forms 0 and
// 1 fold theirs into coef / off and read none.
struct Affine {
  const void* w;
  const void* b;
  int wcode;
};

template <int VEC>
__device__ __forceinline__ void load_wb(const Affine& a, int form, int c0, float* w, float* b) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    w[k] = form == 2 ? wload(a.w, a.wcode, c0 + k) : 1.0f;
    b[k] = form == 2 ? wload(a.b, a.wcode, c0 + k) : 0.0f;
  }
}

// Pass 1 of the sums. Forward (BWD false): per channel, sum x and x^2 over
// the block's rows. Backward: sum g' and g' * x. Block blockIdx.x covers rows
// [j * rows_per_block, ...) of frame f = blockIdx.x / bpf (j = blockIdx.x %
// bpf), channel slab blockIdx.y of up to 256 vectors; a thread takes VEC
// channels of every RL-th row. Writes part[k][blockIdx.x][C] for k = 0, 1
// (the second array starts at part + nblk * C).
template <typename T, typename S, int VEC, bool BWD, int ACT>
__global__ void __launch_bounds__(NORM_THREADS)
    norm_part_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                     const S* __restrict__ coef, const S* __restrict__ off, int form, Affine aff,
                     long long P, int C, int bpf, long long rows_per_block,
                     float* __restrict__ part, long long nblk) {
  __shared__ float sh[2][NORM_THREADS * VEC];
  const int cvec = C / VEC;
  const int cl = min(cvec, NORM_THREADS), RL = NORM_THREADS / cl;
  const int tid = threadIdx.x, lane = tid % cl, rl = tid / cl;
  const int chunk = blockIdx.y * cl + lane;
  const bool active = rl < RL && chunk < cvec;
  const int f = blockIdx.x / bpf, j = blockIdx.x % bpf;
  const long long fr0 = static_cast<long long>(f) * P;
  const long long r0 = fr0 + j * rows_per_block;
  const long long r1 = min(r0 + rows_per_block, fr0 + P);
  const int c0 = chunk * VEC;

  float s[VEC], q[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) s[k] = q[k] = 0.0f;
  if (active) {
    if constexpr (!BWD) {
      constexpr int U = 4;
      long long r = r0 + rl;
      for (; r + (U - 1) * RL < r1; r += U * RL) {
        float v[U][VEC];
#pragma unroll
        for (int u = 0; u < U; ++u) load_f32<T, VEC>(x + (r + u * RL) * C + c0, v[u]);
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            s[k] += v[u][k];
            q[k] = fmaf(v[u][k], v[u][k], q[k]);
          }
      }
      for (; r < r1; r += RL) {
        float v[VEC];
        load_f32<T, VEC>(x + r * C + c0, v);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          s[k] += v[k];
          q[k] = fmaf(v[k], v[k], q[k]);
        }
      }
    } else {
      float cf[VEC], of[VEC], wv[VEC], bv[VEC];
      load_f32<S, VEC>(coef + static_cast<long long>(f) * C + c0, cf);
      load_f32<S, VEC>(off + static_cast<long long>(f) * C + c0, of);
      load_wb<VEC>(aff, form, c0, wv, bv);
      constexpr int U = 2;
      long long r = r0 + rl;
      for (; r + (U - 1) * RL < r1; r += U * RL) {
        float xv[U][VEC], gv[U][VEC];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          load_f32<T, VEC>(x + (r + u * RL) * C + c0, xv[u]);
          load_f32<T, VEC>(gy + (r + u * RL) * C + c0, gv[u]);
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            const float gp =
                gv[u][k] * act_grad<ACT>(pre_act<T>(xv[u][k], cf[k], of[k], form, wv[k], bv[k]));
            s[k] += gp;
            q[k] = fmaf(gp, xv[u][k], q[k]);
          }
      }
      for (; r < r1; r += RL) {
        float xv[VEC], gv[VEC];
        load_f32<T, VEC>(x + r * C + c0, xv);
        load_f32<T, VEC>(gy + r * C + c0, gv);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float gp =
              gv[k] * act_grad<ACT>(pre_act<T>(xv[k], cf[k], of[k], form, wv[k], bv[k]));
          s[k] += gp;
          q[k] = fmaf(gp, xv[k], q[k]);
        }
      }
    }
  }
  // the row lanes in lane order: lane layout [RL][cl * VEC]
  const int width = cl * VEC;
  if (rl < RL) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      sh[0][rl * width + lane * VEC + k] = s[k];
      sh[1][rl * width + lane * VEC + k] = q[k];
    }
  }
  __syncthreads();
  for (int cc = tid; cc < width; cc += NORM_THREADS) {
    const int c = blockIdx.y * width + cc;
    if (c >= C) continue;
    float ts = 0.0f, tq = 0.0f;
    for (int l = 0; l < RL; ++l) {
      ts += sh[0][l * width + cc];
      tq += sh[1][l * width + cc];
    }
    part[static_cast<long long>(blockIdx.x) * C + c] = ts;
    part[nblk * C + static_cast<long long>(blockIdx.x) * C + c] = tq;
  }
}

// The forward's per-slot math, a thread a slot (f, c) of group g = c / (C /
// G): sums [2][F][G] (s, then q), n = *count_dev when given, else count_host.
// mvn [3 * F * G + 1]: the mean, the clamped variance, the variance before
// the clamp (its sign is the clamp's gradient mask), then n.
template <typename T>
__global__ void norm_finalize_kernel(const float* __restrict__ sums,
                                     const float* __restrict__ count_dev, float count_host,
                                     const void* __restrict__ w, const void* __restrict__ b,
                                     int wcode, int kind, int F, int G, int C,
                                     T* __restrict__ coef,
                                     T* __restrict__ off, float* __restrict__ mvn) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(F) * C) return;
  const int f = static_cast<int>(i / C), c = static_cast<int>(i % C);
  const int cg = C / G, g = c / cg;
  const long long FG = static_cast<long long>(F) * G, fg = static_cast<long long>(f) * G + g;
  const float n = count_dev ? *count_dev : count_host;
  const float m = __fdiv_rn(sums[fg], n);
  const float raw = __fsub_rn(__fdiv_rn(sums[FG + fg], n), __fmul_rn(m, m));
  const float v = fmaxf(raw, 0.0f);
  const float r = rsqrtf(__fadd_rn(v, NORM_EPS));
  float cf, of;
  if (kind == kInstance || kind == kBatchF32) {  // (x - m) * r (* w + b, by the apply)
    cf = r;
    of = m;
  } else if (kind == kBatch) {  // r * w, b - m * r * w
    const float wc = wload(w, wcode, c);
    cf = __fmul_rn(r, wc);
    of = __fsub_rn(wload(b, wcode, c), __fmul_rn(__fmul_rn(m, r), wc));
  } else {  // r * w, b - m * (r * w)
    cf = __fmul_rn(r, wload(w, wcode, c));
    of = __fsub_rn(wload(b, wcode, c), __fmul_rn(m, cf));
  }
  coef[i] = from_f32<T>(cf);
  off[i] = from_f32<T>(of);
  if (c % cg == 0) {
    mvn[fg] = m;
    mvn[FG + fg] = v;
    mvn[2 * FG + fg] = raw;
  }
  if (i == 0) mvn[3 * FG] = n;
}

// y = act(pre), pre as pre_act; a thread VEC channels of one row at a time
// (grid-stride), coef / off of the row's frame f = row / P
template <typename T, typename S, int VEC, int ACT>
__global__ void __launch_bounds__(NORM_THREADS)
    norm_apply_kernel(const T* __restrict__ x, const S* __restrict__ coef,
                      const S* __restrict__ off, Affine aff, T* __restrict__ y, long long nvec,
                      int C, long long P, int form) {
  const int cvec = C / VEC;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < nvec;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = i / cvec;
    const int c0 = static_cast<int>(i - r * cvec) * VEC;
    const long long sb = (r / P) * C + c0;
    float xv[VEC], cf[VEC], of[VEC], wv[VEC], bv[VEC], out[VEC];
    load_f32<T, VEC>(x + r * C + c0, xv);
    load_f32<S, VEC>(coef + sb, cf);
    load_f32<S, VEC>(off + sb, of);
    load_wb<VEC>(aff, form, c0, wv, bv);
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      out[k] = act_f<ACT>(pre_act<T>(xv[k], cf[k], of[k], form, wv[k], bv[k]));
    store_from_f32<T, VEC>(y + r * C + c0, out);
  }
}

// The backward's per-group math. Blocks [0, F * G): one warp a group (f, g)
// adds its channels' terms in a fixed order and writes the group's A and B
// to each of its slots, ab [2][F][C]. Blocks from F * G on: a thread a
// channel c adds dweight and dbias over the frames in order (w null: none).
// S [2][F][C]: the slots' sums of g' and g' * x.
template <typename T>
__global__ void norm_bwd_finalize_kernel(const float* __restrict__ S, const float* __restrict__ mvn,
                                         const void* __restrict__ w, int wcode,
                                         const T* __restrict__ coef, const T* __restrict__ off,
                                         int kind, int F, int G, int C, float* __restrict__ ab,
                                         void* __restrict__ dw, void* __restrict__ db) {
  const int cg = C / G;
  const long long FC = static_cast<long long>(F) * C, FG = static_cast<long long>(F) * G;
  const float n = mvn[3 * FG];
  if (blockIdx.x < FG) {
    const int f = blockIdx.x / G, g = blockIdx.x % G;
    const long long fg = blockIdx.x;
    const float m = mvn[fg], v = mvn[FG + fg], raw = mvn[2 * FG + fg];
    const float r = rsqrtf(__fadd_rn(v, NORM_EPS));
    float dr = 0.0f, dm = 0.0f;
    for (int k = threadIdx.x; k < cg; k += 32) {
      const int c = g * cg + k;
      const long long slot = static_cast<long long>(f) * C + c;
      const float s1 = S[slot], s2 = S[FC + slot];
      if (kind == kInstance) {  // y = (x - m_T) * r_T
        const float mt = to_f32(off[slot]), rt = to_f32(coef[slot]);
        dr += s2 - mt * s1;
        dm -= rt * s1;
      } else {
        const float wc = wload(w, wcode, c);
        dr += wc * (s2 - m * s1);
        dm -= r * wc * s1;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      dr += __shfl_down_sync(0xffffffffu, dr, o);
      dm += __shfl_down_sync(0xffffffffu, dm, o);
    }
    dr = __shfl_sync(0xffffffffu, dr, 0);
    dm = __shfl_sync(0xffffffffu, dm, 0);
    // rsqrt, the clamp (its gradient passes where q / n - m^2 >= 0), the
    // moments m = s / n and E[x^2] = q / n
    const float dv = raw >= 0.0f ? dr * -0.5f * r * r * r : 0.0f;
    const float A = 2.0f * dv / n, B = (dm - 2.0f * m * dv) / n;
    for (int k = threadIdx.x; k < cg; k += 32) {
      const long long slot = static_cast<long long>(f) * C + g * cg + k;
      ab[slot] = A;
      ab[FC + slot] = B;
    }
    return;
  }
  if (w == nullptr) return;
  const int c = (blockIdx.x - static_cast<int>(FG)) * 32 + threadIdx.x;
  if (c >= C) return;
  const int g = c / cg;
  float sw = 0.0f, sb = 0.0f;
  for (int f = 0; f < F; ++f) {
    const long long fg = static_cast<long long>(f) * G + g;
    const long long slot = static_cast<long long>(f) * C + c;
    const float m = mvn[fg], r = rsqrtf(__fadd_rn(mvn[FG + fg], NORM_EPS));
    const float s1 = S[slot], s2 = S[FC + slot];
    sw += r * (s2 - m * s1);
    sb += s1;
  }
  wstore(dw, wcode, c, sw);
  wstore(db, wcode, c, sb);
}

// dx = g' * coef + A * x + B (A, B of the slot; ab null: 0), rounded once;
// form 2's multiplier of g' is r * w
template <typename T, typename S, int VEC, int ACT>
__global__ void __launch_bounds__(NORM_THREADS)
    norm_dx_kernel(const T* __restrict__ gy, const T* __restrict__ x, const S* __restrict__ coef,
                   const S* __restrict__ off, Affine aff, const float* __restrict__ ab,
                   long long FC, T* __restrict__ dx, long long nvec, int C, long long P,
                   int form) {
  const int cvec = C / VEC;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < nvec;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = i / cvec;
    const int c0 = static_cast<int>(i - r * cvec) * VEC;
    const long long sb = (r / P) * C + c0;
    float xv[VEC], gv[VEC], cf[VEC], of[VEC], wv[VEC], bv[VEC], out[VEC];
    load_f32<T, VEC>(x + r * C + c0, xv);
    load_f32<T, VEC>(gy + r * C + c0, gv);
    load_f32<S, VEC>(coef + sb, cf);
    load_f32<S, VEC>(off + sb, of);
    load_wb<VEC>(aff, form, c0, wv, bv);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float gp = gv[k] * act_grad<ACT>(pre_act<T>(xv[k], cf[k], of[k], form, wv[k], bv[k]));
      float d = gp * (form == 2 ? cf[k] * wv[k] : cf[k]);
      if (ab != nullptr) d += fmaf(ab[sb + k], xv[k], ab[FC + sb + k]);
      out[k] = d;
    }
    store_from_f32<T, VEC>(dx + r * C + c0, out);
  }
}

// ------------------------------------------------ the one-pass kernels --

constexpr int OC_THREADS = 512;
constexpr int OC_WARPS = OC_THREADS / 32;
// rows a thread has in flight while it applies (the forward's x; the
// backward's g and x, two copies a row, take half as many)
constexpr int ONCHIP_LAG = 8;

// The wave plan of the one-pass kernels (ops/norm.py:onchip_plan chooses it):
// F frames of P rows, C channels in G groups; a slab is W channels (whole
// groups) of one frame's rows; a wave holds K slabs, each spread over bps
// blocks of rpb rows (the last block of a slab fewer); the grid is K * bps
// blocks, one an SM.
struct OnchipPlan {
  long long F, P, rpb;
  int C, G, W, K, bps;
};

// A block's dynamic shared memory: its rows [rpb][W] (elem bytes an element:
// the forward's x; the backward's x and, beside it, g' in fp32), then fp32
// scratch: the row lanes' sums [OC_RED], their chunk sums [OC_THREADS], two
// per-channel arrays [W]. ops/norm.py:_onchip_smem_bytes is the same sum.
constexpr int OC_RED = OC_THREADS * 8;
__host__ __device__ inline long long onchip_data_bytes(long long rpb, int W, int elem) {
  return (rpb * W * elem + 15) / 16 * 16;
}
__host__ __device__ inline long long onchip_smem_bytes(long long rpb, int W, int elem) {
  return onchip_data_bytes(rpb, W, elem) + 4LL * (OC_RED + OC_THREADS + 2 * W);
}

// every lane gets the same bits (a + b == b + a at each level of the tree)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[c], c < W: the block's total of channel c over its row lanes, in a
// fixed order. Row lane rl, lane `lane` holds v[k] of channel lane * VEC + k;
// red [RL][W] holds them, then OC_THREADS / W threads a channel add strided
// chunks of lanes into red2, then one thread a channel adds the chunks.
template <int VEC>
__device__ void lane_totals(const float* v, bool active, int rl, int lane, int RL, int W,
                            float* red, float* red2, float* out) {
  __syncthreads();
  if (active)
#pragma unroll
    for (int k = 0; k < VEC; ++k) red[rl * W + lane * VEC + k] = v[k];
  __syncthreads();
  const int H = OC_THREADS / W, tid = threadIdx.x;
  if (tid < H * W) {
    const int c = tid % W, h = tid / W;
    float t = 0.0f;
    for (int l = h; l < RL; l += H) t += red[l * W + c];
    red2[h * W + c] = t;
  }
  __syncthreads();
  if (tid < W) {
    float t = 0.0f;
    for (int h = 0; h < H; ++h) t += red2[h * W + tid];
    out[tid] = t;
  }
}

// outa[c], outb[c], c < W: the block's totals of a and b (a thread's VEC
// channels, as lane_totals) in a fixed order, then a barrier. Where a row's
// cvec lanes divide a warp, each warp first folds its rows with a shuffle
// tree and one row a warp goes through shared memory; a and b are changed.
template <int VEC>
__device__ void channel_totals(float* a, float* b, bool active, int rl, int lane, int cvec,
                               int RL, int W, float* red, float* red2, float* outa,
                               float* outb) {
  if (32 % cvec) {
    lane_totals<VEC>(a, active, rl, lane, RL, W, red, red2, outa);
    lane_totals<VEC>(b, active, rl, lane, RL, W, red, red2, outb);
    __syncthreads();
    return;
  }
  for (int o = cvec; o < 32; o <<= 1)
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      a[k] += __shfl_xor_sync(0xffffffffu, a[k], o);
      b[k] += __shfl_xor_sync(0xffffffffu, b[k], o);
    }
  const int tid = threadIdx.x, warp = tid >> 5;
  const bool first = (tid & 31) < cvec, both = 2 * OC_WARPS * W <= OC_RED;
  float* rb = both ? red + OC_WARPS * W : red;
  __syncthreads();
  if (first)
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      red[warp * W + lane * VEC + k] = a[k];
      if (both) rb[warp * W + lane * VEC + k] = b[k];
    }
  __syncthreads();
  for (int c = tid; c < (both ? 2 * W : W); c += OC_THREADS) {
    const float* src = c < W ? red + c : rb + (c - W);
    float t = 0.0f;
    for (int w = 0; w < OC_WARPS; ++w) t += src[w * W];
    (c < W ? outa[c] : outb[c - W]) = t;
  }
  if (!both) {
    __syncthreads();
    if (first)
#pragma unroll
      for (int k = 0; k < VEC; ++k) rb[warp * W + lane * VEC + k] = b[k];
    __syncthreads();
    for (int c = tid; c < W; c += OC_THREADS) {
      float t = 0.0f;
      for (int w = 0; w < OC_WARPS; ++w) t += rb[w * W + c];
      outb[c] = t;
    }
  }
  __syncthreads();
}

// 16 bytes of VEC values rounded to T, stored with the streaming hint (read
// by the next layer, never by this kernel again)
template <typename T, int VEC>
__device__ __forceinline__ void store_stream(T* p, const float* v) {
  static_assert(VEC * sizeof(T) == 16, "one 16-byte vector");
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int j = 0; j < VEC; ++j) e[j] = from_f32<T>(v[j]);
  __stcs(reinterpret_cast<uint4*>(p), u);
}

// Where block blockIdx.x works in wave wv: whether it has a slab (a wave
// past the last has none), the slab's frame and first channel, the block's
// first row and row count.
struct OnchipSlot {
  bool has;
  long long f, r0, nrows;
  int c0;
};

__device__ __forceinline__ OnchipSlot onchip_slot(const OnchipPlan& pl, long long wv) {
  const int ngr = pl.C / pl.W, si = blockIdx.x / pl.bps, piece = blockIdx.x % pl.bps;
  const long long slab = wv * pl.K + si;
  OnchipSlot o;
  o.has = slab < pl.F * ngr;
  o.f = o.has ? slab / ngr : 0;
  o.c0 = o.has ? static_cast<int>(slab % ngr) * pl.W : 0;
  o.r0 = static_cast<long long>(piece) * pl.rpb;
  o.nrows = o.has ? max(0LL, min(pl.rpb, pl.P - o.r0)) : 0;
  return o;
}

// the element offset of the block's first row of its slab, at channel c
__device__ __forceinline__ long long onchip_base(const OnchipPlan& pl, const OnchipSlot& o,
                                                 int c) {
  return (o.f * pl.P + o.r0) * pl.C + o.c0 + c;
}

// The whole forward of a group (kind 1, form 0) or instance norm (kind 2,
// form 1) in one pass; coef, off, mvn as norm_finalize_kernel writes them
// (the first block of each slab writes its slab's), y = act(pre). part
// [2][K * bps][gr][2] fp32 scratch (gr = W / (C / G) groups a slab).
template <typename T, int ACT>
__global__ void __launch_bounds__(OC_THREADS, 1)
    norm_apply_kernel_onchip(const T* __restrict__ x, const void* __restrict__ w,
                             const void* __restrict__ b, int wcode, int kind, OnchipPlan pl,
                             float count, float* __restrict__ part, T* __restrict__ coef,
                             T* __restrict__ off, float* __restrict__ mvn, T* __restrict__ y) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = pl.W, C = pl.C, cvec = W / VEC, RL = OC_THREADS / cvec;
  const int tid = threadIdx.x, lane = tid % cvec, rl = tid / cvec;
  const bool active = rl < RL;
  const int cg = C / pl.G, gr = W / cg, warp = tid >> 5, wl = tid & 31;
  const int si = blockIdx.x / pl.bps, piece = blockIdx.x % pl.bps;
  const int form = kind == kInstance ? 1 : 0;
  T* buf = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem + onchip_data_bytes(pl.rpb, W, sizeof(T)));
  float* red2 = red + OC_RED;
  float* ca = red2 + OC_THREADS;  // the sums of x, then coef
  float* cb = ca + W;             // the sums of x^2, then off
  const long long FG = pl.F * pl.G;
  const long long nwave = (pl.F * (C / W) + pl.K - 1) / pl.K;
  cgrp::grid_group grid = cgrp::this_grid();
  // a thread's rows of its slab are r = rl + i * RL (rows(n) of them below
  // n), each in its own slot of buf: slot(r)
  auto rows = [&](long long n) { return n > rl ? (n - rl + RL - 1) / RL : 0LL; };
  auto slot = [&](long long r) { return buf + (r * cvec + lane) * VEC; };
  float s[VEC], q[VEC];  // the sums of x and x^2 of the thread's rows on chip
  auto add_row = [&](long long r) {
    float v[VEC];
    load_f32<T, VEC>(slot(r), v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      s[k] += v[k];
      q[k] = fmaf(v[k], v[k], q[k]);
    }
  };
#pragma unroll
  for (int k = 0; k < VEC; ++k) s[k] = q[k] = 0.0f;
  OnchipSlot o = onchip_slot(pl, 0);
  const long long first = active ? rows(o.nrows) : 0;
  for (long long i = 0; i < first; ++i)
    cp_async16(slot(rl + i * RL), x + onchip_base(pl, o, lane * VEC) + (rl + i * RL) * C, true);
  cp_async_commit();
  cp_async_wait<0>();
  for (long long i = 0; i < first; ++i) add_row(rl + i * RL);
  for (long long wv = 0; wv < nwave; ++wv) {
    float* pbuf = part + (wv & 1) * (2LL * pl.K * pl.bps * gr);
    const long long base = onchip_base(pl, o, lane * VEC);
    const OnchipSlot nx = onchip_slot(pl, wv + 1);
    const long long nbase = onchip_base(pl, nx, lane * VEC);
    channel_totals<VEC>(s, q, active, rl, lane, cvec, RL, W, red, red2, ca, cb);
    for (int j = warp; j < gr; j += OC_WARPS) {  // the block's sums a group
      float ts = 0.0f, tq = 0.0f;
      for (int k = wl; k < cg; k += 32) {
        ts += ca[j * cg + k];
        tq += cb[j * cg + k];
      }
      ts = warp_sum(ts);
      tq = warp_sum(tq);
      if (wl == 0) {
        pbuf[(static_cast<long long>(blockIdx.x) * gr + j) * 2] = ts;
        pbuf[(static_cast<long long>(blockIdx.x) * gr + j) * 2 + 1] = tq;
      }
    }
    // the slab's weight and bias into red2 (free until the next wave's
    // totals) while the barrier waits
    const bool pre = kind != kInstance && 2 * W <= OC_THREADS;
    if (pre && tid < W) {
      red2[tid] = wload(w, wcode, o.c0 + tid);
      red2[W + tid] = wload(b, wcode, o.c0 + tid);
    }
    grid.sync();
    if (o.has) {  // the slab's sums over its blocks, then coef / off
      const float* ps = pbuf + static_cast<long long>(si) * pl.bps * gr * 2;
      for (int j = warp; j < gr; j += OC_WARPS) {
        float ts = 0.0f, tq = 0.0f;
        for (int p = wl; p < pl.bps; p += 32) {
          ts += ps[(static_cast<long long>(p) * gr + j) * 2];
          tq += ps[(static_cast<long long>(p) * gr + j) * 2 + 1];
        }
        ts = warp_sum(ts);
        tq = warp_sum(tq);
        const float m = __fdiv_rn(ts, count);
        const float raw = __fsub_rn(__fdiv_rn(tq, count), __fmul_rn(m, m));
        const float v = fmaxf(raw, 0.0f);
        const float rr = rsqrtf(__fadd_rn(v, NORM_EPS));
        const long long fg = o.f * pl.G + o.c0 / cg + j;
        if (piece == 0 && wl == 0) {
          mvn[fg] = m;
          mvn[FG + fg] = v;
          mvn[2 * FG + fg] = raw;
        }
        for (int k = wl; k < cg; k += 32) {
          const int c = o.c0 + j * cg + k;
          float cf, of;
          if (kind == kInstance) {
            cf = rr;
            of = m;
          } else {
            cf = __fmul_rn(rr, pre ? red2[j * cg + k] : wload(w, wcode, c));
            of = __fsub_rn(pre ? red2[W + j * cg + k] : wload(b, wcode, c), __fmul_rn(m, cf));
          }
          const T ct = from_f32<T>(cf), ot = from_f32<T>(of);
          ca[j * cg + k] = to_f32(ct);
          cb[j * cg + k] = to_f32(ot);
          if (piece == 0) {
            coef[o.f * C + c] = ct;
            off[o.f * C + c] = ot;
          }
        }
      }
    }
    __syncthreads();
    // y from the rows on chip. Each row's slot, once read, takes the next
    // wave's row (a thread's slots are its own), whose sums are added LAG
    // rows later, once its copy has landed: the next wave's reads and sums
    // overlap this wave's writes.
#pragma unroll
    for (int k = 0; k < VEC; ++k) s[k] = q[k] = 0.0f;
    const long long mine = o.has && active ? rows(o.nrows) : 0;
    const long long next = active ? rows(nx.nrows) : 0;
    long long i = 0;
    if (mine > 0) {
      float cf[VEC], of[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        cf[k] = ca[lane * VEC + k];
        of[k] = cb[lane * VEC + k];
      }
      for (; i < mine; ++i) {
        const long long r = rl + i * RL;
        float v[VEC], out[VEC];
        load_f32<T, VEC>(slot(r), v);
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          out[k] = act_f<ACT>(pre_act<T>(v[k], cf[k], of[k], form, 1.0f, 0.0f));
        store_stream<T, VEC>(y + base + r * C, out);
        if (i < next) cp_async16(slot(r), x + nbase + r * C, true);
        cp_async_commit();
        const long long j = i - ONCHIP_LAG;
        if (j >= 0 && j < next) {
          cp_async_wait<ONCHIP_LAG>();
          add_row(rl + j * RL);
        }
      }
    }
    long long done = i > ONCHIP_LAG ? (i - ONCHIP_LAG < next ? i - ONCHIP_LAG : next) : 0;
    for (; i < next; ++i) cp_async16(slot(rl + i * RL), x + nbase + (rl + i * RL) * C, true);
    cp_async_commit();
    cp_async_wait<0>();
    for (; done < next; ++done) add_row(rl + done * RL);
    o = nx;
    // channel_totals' first barrier keeps ca / cb until every thread of the
    // block has read them
  }
  if (blockIdx.x == 0 && tid == 0) mvn[3 * FG] = count;
}

// The whole backward of a group or instance norm in one pass: from g, x and
// the forward's coef, off, mvn, dx (as norm_dx_kernel) and, for group norm,
// dweight / dbias (as norm_bwd_finalize_kernel). part [2][K * bps][W][2]
// and S [2][F][C] fp32 scratch (the slots' sums of g' and g' * x).
template <typename T, int ACT>
__global__ void __launch_bounds__(OC_THREADS, 1)
    norm_dx_kernel_onchip(const T* __restrict__ gy, const T* __restrict__ x,
                          const void* __restrict__ w, int wcode, const T* __restrict__ coef,
                          const T* __restrict__ off, const float* __restrict__ mvn, int kind,
                          OnchipPlan pl, float* __restrict__ part, float* __restrict__ S,
                          void* __restrict__ dw, void* __restrict__ db, T* __restrict__ dx) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = pl.W, C = pl.C, cvec = W / VEC, RL = OC_THREADS / cvec;
  const int tid = threadIdx.x, lane = tid % cvec, rl = tid / cvec;
  const bool active = rl < RL;
  const int cg = C / pl.G, gr = W / cg, warp = tid >> 5, wl = tid & 31;
  const int si = blockIdx.x / pl.bps, piece = blockIdx.x % pl.bps;
  const int form = kind == kInstance ? 1 : 0;
  T* xb = reinterpret_cast<T*>(smem);  // x, then g' in fp32 in g's slots
  float* gb = reinterpret_cast<float*>(smem + pl.rpb * W * sizeof(T));
  float* red = reinterpret_cast<float*>(smem + onchip_data_bytes(pl.rpb, W, sizeof(T) + 4));
  float* red2 = red + OC_RED;
  float* ca = red2 + OC_THREADS;  // the slots' sums of g', then A
  float* cb = ca + W;             // of g' * x, then B
  const long long FG = pl.F * pl.G, FC = pl.F * C;
  const float n = mvn[3 * FG];
  const long long nwave = (pl.F * (C / W) + pl.K - 1) / pl.K;
  cgrp::grid_group grid = cgrp::this_grid();
  constexpr int LAG = ONCHIP_LAG / 2;
  auto rows = [&](long long n) { return n > rl ? (n - rl + RL - 1) / RL : 0LL; };
  auto xs = [&](long long r) { return xb + (r * cvec + lane) * VEC; };
  auto gs = [&](long long r) { return gb + (r * cvec + lane) * VEC; };
  // row r of the slab at element `at`: g's 16 bytes at the front of its slot
  auto fetch = [&](long long r, long long at) {
    cp_async16(xs(r), x + at + r * C, true);
    cp_async16(gs(r), gy + at + r * C, true);
  };
  // the slots' coef / off of the thread's lanes, and its sums of g' and
  // g' * x over its rows on chip
  float cf[VEC], of[VEC], s1[VEC], s2[VEC];
  // g' = g * act'(pre) of row r added to the sums and kept in its slot
  auto add_row = [&](long long r, const float* c, const float* o_) {
    float xv[VEC], gv[VEC];
    load_f32<T, VEC>(xs(r), xv);
    load_f32<T, VEC>(reinterpret_cast<const T*>(gs(r)), gv);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      gv[k] *= act_grad<ACT>(pre_act<T>(xv[k], c[k], o_[k], form, 1.0f, 0.0f));
      s1[k] += gv[k];
      s2[k] = fmaf(gv[k], xv[k], s2[k]);
    }
#pragma unroll
    for (int k = 0; k < VEC; k += 4)
      *reinterpret_cast<float4*>(gs(r) + k) = make_float4(gv[k], gv[k + 1], gv[k + 2], gv[k + 3]);
  };
#pragma unroll
  for (int k = 0; k < VEC; ++k) s1[k] = s2[k] = 0.0f;
  OnchipSlot o = onchip_slot(pl, 0);
  const long long first = active ? rows(o.nrows) : 0;
  for (long long i = 0; i < first; ++i) fetch(rl + i * RL, onchip_base(pl, o, lane * VEC));
  cp_async_commit();
  load_f32<T, VEC>(coef + o.f * C + o.c0 + lane * VEC, cf);
  load_f32<T, VEC>(off + o.f * C + o.c0 + lane * VEC, of);
  cp_async_wait<0>();
  for (long long i = 0; i < first; ++i) add_row(rl + i * RL, cf, of);
  for (long long wv = 0; wv < nwave; ++wv) {
    float* pbuf = part + (wv & 1) * (2LL * pl.K * pl.bps * W);
    const long long base = onchip_base(pl, o, lane * VEC);
    const OnchipSlot nx = onchip_slot(pl, wv + 1);
    const long long nbase = onchip_base(pl, nx, lane * VEC);
    channel_totals<VEC>(s1, s2, active, rl, lane, cvec, RL, W, red, red2, ca, cb);
    if (tid < W) {
      pbuf[(static_cast<long long>(blockIdx.x) * W + tid) * 2] = ca[tid];
      pbuf[(static_cast<long long>(blockIdx.x) * W + tid) * 2 + 1] = cb[tid];
    }
    // what the per-group chain reads besides the sums, into red2 while the
    // barrier waits: a channel's weight (instance: coef, off), a group's
    // mean, variance and variance before the clamp
    const bool pre = 2 * W + 3 * gr <= OC_THREADS;
    if (pre) {
      for (int c = tid; c < W; c += OC_THREADS) {
        const long long slot = o.f * C + o.c0 + c;
        if (kind == kInstance) {
          red2[c] = to_f32(coef[slot]);
          red2[W + c] = to_f32(off[slot]);
        } else {
          red2[c] = wload(w, wcode, o.c0 + c);
        }
      }
      for (int j = tid; j < gr; j += OC_THREADS) {
        const long long fg = o.f * pl.G + o.c0 / cg + j;
        red2[2 * W + j] = mvn[fg];
        red2[2 * W + gr + j] = mvn[FG + fg];
        red2[2 * W + 2 * gr + j] = mvn[2 * FG + fg];
      }
    }
    grid.sync();
    if (o.has) {  // the slots' sums over the slab's blocks, then A, B
      // OC_THREADS / W threads a channel add strided blocks, then one adds
      // their sums: a fixed order
      const float* ps = pbuf + static_cast<long long>(si) * pl.bps * W * 2;
      const int H = OC_THREADS / W;
      if (tid < H * W) {
        const int c = tid % W, h = tid / W;
        float t1 = 0.0f, t2 = 0.0f;
#pragma unroll 16
        for (int p = h; p < pl.bps; p += H) {
          t1 += ps[(static_cast<long long>(p) * W + c) * 2];
          t2 += ps[(static_cast<long long>(p) * W + c) * 2 + 1];
        }
        red[h * W + c] = t1;
        red[OC_THREADS + h * W + c] = t2;
      }
      __syncthreads();
      if (tid < W) {
        float t1 = 0.0f, t2 = 0.0f;
        for (int h = 0; h < H; ++h) {
          t1 += red[h * W + tid];
          t2 += red[OC_THREADS + h * W + tid];
        }
        ca[tid] = t1;
        cb[tid] = t2;
        if (piece == 0) {
          S[o.f * C + o.c0 + tid] = t1;
          S[FC + o.f * C + o.c0 + tid] = t2;
        }
      }
      __syncthreads();
      for (int j = warp; j < gr; j += OC_WARPS) {
        const long long fg = o.f * pl.G + o.c0 / cg + j;
        const float m = pre ? red2[2 * W + j] : mvn[fg];
        const float v = pre ? red2[2 * W + gr + j] : mvn[FG + fg];
        const float raw = pre ? red2[2 * W + 2 * gr + j] : mvn[2 * FG + fg];
        const float rr = rsqrtf(__fadd_rn(v, NORM_EPS));
        float dr = 0.0f, dm = 0.0f;
        for (int k = wl; k < cg; k += 32) {
          const int c = j * cg + k;
          const float t1 = ca[c], t2 = cb[c];
          if (kind == kInstance) {  // y = (x - m_T) * r_T
            const long long slot = o.f * C + o.c0 + c;
            const float mt = pre ? red2[W + c] : to_f32(off[slot]);
            const float rt = pre ? red2[c] : to_f32(coef[slot]);
            dr += t2 - mt * t1;
            dm -= rt * t1;
          } else {
            const float wc = pre ? red2[c] : wload(w, wcode, o.c0 + c);
            dr += wc * (t2 - m * t1);
            dm -= rr * wc * t1;
          }
        }
        dr = warp_sum(dr);
        dm = warp_sum(dm);
        const float dv = raw >= 0.0f ? dr * -0.5f * rr * rr * rr : 0.0f;
        const float A = 2.0f * dv / n, B = (dm - 2.0f * m * dv) / n;
        __syncwarp();
        for (int k = wl; k < cg; k += 32) {
          ca[j * cg + k] = A;
          cb[j * cg + k] = B;
        }
      }
    }
    __syncthreads();
    // dx from the rows on chip; the next wave's rows into the freed slots,
    // their sums added LAG rows later (as the forward)
    float cn[VEC], on[VEC];  // the next slab's coef / off
    load_f32<T, VEC>(coef + nx.f * C + nx.c0 + lane * VEC, cn);
    load_f32<T, VEC>(off + nx.f * C + nx.c0 + lane * VEC, on);
#pragma unroll
    for (int k = 0; k < VEC; ++k) s1[k] = s2[k] = 0.0f;
    const long long mine = o.has && active ? rows(o.nrows) : 0;
    const long long next = active ? rows(nx.nrows) : 0;
    long long i = 0;
    if (mine > 0) {
      float A[VEC], B[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        A[k] = ca[lane * VEC + k];
        B[k] = cb[lane * VEC + k];
      }
      for (; i < mine; ++i) {
        const long long r = rl + i * RL;
        float xv[VEC], out[VEC];
        load_f32<T, VEC>(xs(r), xv);
        const float* gp = gs(r);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          float d = gp[k] * cf[k];
          d += fmaf(A[k], xv[k], B[k]);
          out[k] = d;
        }
        store_stream<T, VEC>(dx + base + r * C, out);
        if (i < next) fetch(r, nbase);
        cp_async_commit();
        const long long j = i - LAG;
        if (j >= 0 && j < next) {
          cp_async_wait<LAG>();
          add_row(rl + j * RL, cn, on);
        }
      }
    }
    long long done = i > LAG ? (i - LAG < next ? i - LAG : next) : 0;
    for (; i < next; ++i) fetch(rl + i * RL, nbase);
    cp_async_commit();
    cp_async_wait<0>();
    for (; done < next; ++done) add_row(rl + done * RL, cn, on);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      cf[k] = cn[k];
      of[k] = on[k];
    }
    o = nx;
  }
  if (dw == nullptr) return;
  grid.sync();  // every slab's S is written
  constexpr int U = 8;
  for (int c = blockIdx.x * OC_THREADS + tid; c < C; c += gridDim.x * OC_THREADS) {
    const int g = c / cg;
    float sw = 0.0f, sb = 0.0f;
    for (long long f0 = 0; f0 < pl.F; f0 += U) {  // U frames' loads in flight, added in order
      float mu[U], vu[U], a1[U], a2[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long f = f0 + u < pl.F ? f0 + u : f0;
        const long long fg = f * pl.G + g;
        mu[u] = mvn[fg];
        vu[u] = mvn[FG + fg];
        a1[u] = S[f * C + c];
        a2[u] = S[FC + f * C + c];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (f0 + u < pl.F) {
          const float r = rsqrtf(__fadd_rn(vu[u], NORM_EPS));
          sw += r * (a2[u] - mu[u] * a1[u]);
          sb += a1[u];
        }
      }
    }
    wstore(dw, wcode, c, sw);
    wstore(db, wcode, c, sb);
  }
}

// The squeeze-and-excitation's pooled sum of the group-norm MBConv's eval
// chain (models/blocks.py: MBConv._fused_group_body), pass 1: per channel,
// the sum over the block's rows of gelu(((x - m) * r) * scale + bias), m and
// r the (frame, group) mean and rsqrt(var + eps) of the row's frame, each
// operation rounded as K3's prologue rounds it (csrc/norm_gelu_matmul.cu),
// so the gate sees the values the GEMM reads. The grid and the row lanes are
// norm_part_kernel's; a block adds its row lanes in lane order into one
// partial row, part [F * bpf][C]. The second pass is common.cuh's
// channel_sum_kernel: a fixed order, no atomics.
template <typename T, int VEC>
__global__ void __launch_bounds__(NORM_THREADS)
    gelu_pool_part_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                          const float* __restrict__ coef, const float* __restrict__ scale,
                          const float* __restrict__ bias, long long P, int C, int G, int bpf,
                          long long rows_per_block, float* __restrict__ part) {
  __shared__ float sh[NORM_THREADS * VEC];
  const int cvec = C / VEC;
  const int cl = min(cvec, NORM_THREADS), RL = NORM_THREADS / cl;
  const int tid = threadIdx.x, lane = tid % cl, rl = tid / cl;
  const int chunk = blockIdx.y * cl + lane;
  const bool active = rl < RL && chunk < cvec;
  const int f = blockIdx.x / bpf, j = blockIdx.x % bpf;
  const long long fr0 = static_cast<long long>(f) * P;
  const long long r0 = fr0 + j * rows_per_block;
  const long long r1 = min(r0 + rows_per_block, fr0 + P);
  const int c0 = chunk * VEC;

  float s[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) s[k] = 0.0f;
  if (active) {
    float m[VEC], r[VEC], sc[VEC], bi[VEC];
    const int cg = C / G;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const long long fg = static_cast<long long>(f) * G + (c0 + k) / cg;
      m[k] = mean[fg];
      r[k] = coef[fg];
      sc[k] = scale[c0 + k];
      bi[k] = bias[c0 + k];
    }
    constexpr int U = 4;
    long long row = r0 + rl;
    for (; row + (U - 1) * RL < r1; row += U * RL) {
      float v[U][VEC];
#pragma unroll
      for (int u = 0; u < U; ++u) load_f32<T, VEC>(x + (row + u * RL) * C + c0, v[u]);
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          s[k] += gelu_exact(
              __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[u][k], m[k]), r[k]), sc[k]), bi[k]));
    }
    for (; row < r1; row += RL) {
      float v[VEC];
      load_f32<T, VEC>(x + row * C + c0, v);
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        s[k] += gelu_exact(
            __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[k], m[k]), r[k]), sc[k]), bi[k]));
    }
  }
  // the row lanes in lane order: lane layout [RL][cl * VEC]
  const int width = cl * VEC;
  if (rl < RL) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) sh[rl * width + lane * VEC + k] = s[k];
  }
  __syncthreads();
  for (int cc = tid; cc < width; cc += NORM_THREADS) {
    const int c = blockIdx.y * width + cc;
    if (c >= C) continue;
    float t = 0.0f;
    for (int l = 0; l < RL; ++l) t += sh[l * width + cc];
    part[static_cast<long long>(blockIdx.x) * C + c] = t;
  }
}

// ----------------------------------------------------------- launches --
//
// The slot arrays coef / off are in x's dtype T for forms 0 and 1 and in
// fp32 for form 2 (S below).

template <typename T>
constexpr int vec_of() {
  return 16 / static_cast<int>(sizeof(T));
}

bool vec_ok(int C, int vec, std::initializer_list<const void*> ptrs) {
  if (C % vec) return false;
  for (const void* p : ptrs)
    if (p != nullptr && !aligned16(p)) return false;
  return true;
}

template <typename T, typename S, int VEC, bool BWD, int ACT>
void launch_part(const void* x, const void* g, const void* coef, const void* off, int form,
                 Affine aff, long long F, long long P, int C, int bpf, float* part,
                 cudaStream_t s) {
  const int cvec = C / VEC, cl = cvec < NORM_THREADS ? cvec : NORM_THREADS;
  const dim3 grid(static_cast<unsigned>(F * bpf), static_cast<unsigned>((cvec + cl - 1) / cl));
  norm_part_kernel<T, S, VEC, BWD, ACT><<<grid, NORM_THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const S*>(coef),
      static_cast<const S*>(off), form, aff, P, C, bpf, (P + bpf - 1) / bpf, part, F * bpf);
}

template <typename T, typename S, bool BWD, int ACT>
void launch_part_vec(const void* x, const void* g, const void* coef, const void* off, int form,
                     Affine aff, long long F, long long P, int C, int bpf, float* part,
                     cudaStream_t s) {
  if (vec_ok(C, vec_of<T>(), {x, g, coef, off}))
    launch_part<T, S, vec_of<T>(), BWD, ACT>(x, g, coef, off, form, aff, F, P, C, bpf, part, s);
  else
    launch_part<T, S, 1, BWD, ACT>(x, g, coef, off, form, aff, F, P, C, bpf, part, s);
}

template <typename T, bool BWD, int ACT>
void launch_part_any(const void* x, const void* g, const void* coef, const void* off, int form,
                     Affine aff, long long F, long long P, int C, int bpf, float* part,
                     cudaStream_t s) {
  if (form == 2)
    launch_part_vec<T, float, BWD, ACT>(x, g, coef, off, form, aff, F, P, C, bpf, part, s);
  else
    launch_part_vec<T, T, BWD, ACT>(x, g, coef, off, form, aff, F, P, C, bpf, part, s);
}

unsigned grid_for(long long nvec) {
  const long long cap = 8LL * sm_count();
  const long long want = (nvec + NORM_THREADS - 1) / NORM_THREADS;
  return static_cast<unsigned>(want < cap ? (want > 0 ? want : 1) : cap);
}

template <typename T, typename S, int ACT>
void launch_apply_s(const void* x, const void* coef, const void* off, Affine aff, void* y,
                    long long F, long long P, int C, int form, cudaStream_t s) {
  const long long R = F * P;
  if (vec_ok(C, vec_of<T>(), {x, coef, off, y})) {
    constexpr int V = vec_of<T>();
    const long long nvec = R * (C / V);
    norm_apply_kernel<T, S, V, ACT><<<grid_for(nvec), NORM_THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<const S*>(coef), static_cast<const S*>(off), aff,
        static_cast<T*>(y), nvec, C, P, form);
  } else {
    const long long nvec = R * C;
    norm_apply_kernel<T, S, 1, ACT><<<grid_for(nvec), NORM_THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<const S*>(coef), static_cast<const S*>(off), aff,
        static_cast<T*>(y), nvec, C, P, form);
  }
}

template <typename T, typename S, int ACT>
void launch_dx_s(const void* g, const void* x, const void* coef, const void* off, Affine aff,
                 const float* ab, void* dx, long long F, long long P, int C, int form,
                 cudaStream_t s) {
  const long long R = F * P, FC = F * C;
  // ab [2][F][C] fp32: a slot's 4 floats are 16-byte aligned when C % 4 == 0
  if (vec_ok(C, vec_of<T>(), {g, x, coef, off, dx, ab})) {
    constexpr int V = vec_of<T>();
    const long long nvec = R * (C / V);
    norm_dx_kernel<T, S, V, ACT><<<grid_for(nvec), NORM_THREADS, 0, s>>>(
        static_cast<const T*>(g), static_cast<const T*>(x), static_cast<const S*>(coef),
        static_cast<const S*>(off), aff, ab, FC, static_cast<T*>(dx), nvec, C, P, form);
  } else {
    const long long nvec = R * C;
    norm_dx_kernel<T, S, 1, ACT><<<grid_for(nvec), NORM_THREADS, 0, s>>>(
        static_cast<const T*>(g), static_cast<const T*>(x), static_cast<const S*>(coef),
        static_cast<const S*>(off), aff, ab, FC, static_cast<T*>(dx), nvec, C, P, form);
  }
}

// dispatch a runtime act code to the template
template <template <typename, int> class L, typename T, typename... A>
int with_act(int act, A... args) {
  if (act == kActNone) return L<T, kActNone>::run(args...);
  if (act == kActGelu) return L<T, kActGelu>::run(args...);
  if (act == kActRelu) return L<T, kActRelu>::run(args...);
  if (act == kActLeaky) return L<T, kActLeaky>::run(args...);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int ACT>
struct ApplyL {
  static int run(const void* x, const void* coef, const void* off, Affine aff, void* y,
                 long long F, long long P, int C, int form, cudaStream_t s) {
    if (form == 2)
      launch_apply_s<T, float, ACT>(x, coef, off, aff, y, F, P, C, form, s);
    else
      launch_apply_s<T, T, ACT>(x, coef, off, aff, y, F, P, C, form, s);
    return 0;
  }
};

template <typename T, int ACT>
struct PartBwdL {
  static int run(const void* g, const void* x, const void* coef, const void* off, int form,
                 Affine aff, long long F, long long P, int C, int bpf, float* part,
                 cudaStream_t s) {
    launch_part_any<T, true, ACT>(x, g, coef, off, form, aff, F, P, C, bpf, part, s);
    return 0;
  }
};

template <typename T, int ACT>
struct DxL {
  static int run(const void* g, const void* x, const void* coef, const void* off, Affine aff,
                 const float* ab, void* dx, long long F, long long P, int C, int form,
                 cudaStream_t s) {
    if (form == 2)
      launch_dx_s<T, float, ACT>(g, x, coef, off, aff, ab, dx, F, P, C, form, s);
    else
      launch_dx_s<T, T, ACT>(g, x, coef, off, aff, ab, dx, F, P, C, form, s);
    return 0;
  }
};

bool shape_ok(long long F, long long P, int C, int G) {
  return F > 0 && P > 0 && C > 0 && G > 0 && C % G == 0 && F * P <= (1LL << 40) &&
         F * G <= (1LL << 31) - 1;
}

const int kBad = static_cast<int>(cudaErrorInvalidValue);

bool form_ok(int form, const void* w, const void* b) {
  return form == 0 || form == 1 || (form == 2 && w != nullptr && b != nullptr);
}

int run_stats(const void* x, int dtype, long long F, long long P, int C, int G, int bpf,
              float* part, float* sums, cudaStream_t s) {
  if (!shape_ok(F, P, C, G) || bpf <= 0) return kBad;
  const Affine none{nullptr, nullptr, 0};
  if (dtype == kBFloat16)
    launch_part_any<__nv_bfloat16, false, kActNone>(x, nullptr, nullptr, nullptr, 0, none, F, P,
                                                     C, bpf, part, s);
  else if (dtype == kFloat32)
    launch_part_any<float, false, kActNone>(x, nullptr, nullptr, nullptr, 0, none, F, P, C, bpf,
                                            part, s);
  else
    return kBad;
  const long long nblk = F * bpf;
  group_stats_kernel<NORM_THREADS><<<static_cast<unsigned>(F * G), NORM_THREADS, 0, s>>>(
      part, part + nblk * C, sums, sums + F * G, bpf, C, G);
  return static_cast<int>(cudaGetLastError());
}

// cdtype: the dtype of coef / off (x's; fp32 for kBatchF32)
int run_finalize(const float* sums, const float* count_dev, float count_host, const void* w,
                 const void* b, int wcode, int kind, long long F, int G, int C, int cdtype,
                 void* coef, void* off, float* mvn, cudaStream_t s) {
  if (!shape_ok(F, 1, C, G) || kind < kBatch || kind > kBatchF32 ||
      (kind != kInstance && (w == nullptr || b == nullptr)))
    return kBad;
  const unsigned blocks = static_cast<unsigned>((F * C + NORM_THREADS - 1) / NORM_THREADS);
  if (cdtype == kBFloat16)
    norm_finalize_kernel<__nv_bfloat16><<<blocks, NORM_THREADS, 0, s>>>(
        sums, count_dev, count_host, w, b, wcode, kind, static_cast<int>(F), G, C,
        static_cast<__nv_bfloat16*>(coef), static_cast<__nv_bfloat16*>(off), mvn);
  else if (cdtype == kFloat32)
    norm_finalize_kernel<float><<<blocks, NORM_THREADS, 0, s>>>(
        sums, count_dev, count_host, w, b, wcode, kind, static_cast<int>(F), G, C,
        static_cast<float*>(coef), static_cast<float*>(off), mvn);
  else
    return kBad;
  return static_cast<int>(cudaGetLastError());
}

int run_apply(const void* x, const void* coef, const void* off, Affine aff, void* y, int dtype,
              long long F, long long P, int C, int form, int act, cudaStream_t s) {
  if (!shape_ok(F, P, C, 1) || !form_ok(form, aff.w, aff.b)) return kBad;
  int err;
  if (dtype == kBFloat16)
    err = with_act<ApplyL, __nv_bfloat16>(act, x, coef, off, aff, y, F, P, C, form, s);
  else if (dtype == kFloat32)
    err = with_act<ApplyL, float>(act, x, coef, off, aff, y, F, P, C, form, s);
  else
    return kBad;
  return err ? err : static_cast<int>(cudaGetLastError());
}

int run_bwd_stats(const void* g, const void* x, const void* coef, const void* off, Affine aff,
                  int dtype, long long F, long long P, int C, int form, int act, int bpf,
                  float* part, float* S, cudaStream_t s) {
  if (!shape_ok(F, P, C, C) || bpf <= 0 || !form_ok(form, aff.w, aff.b)) return kBad;
  int err;
  if (dtype == kBFloat16)
    err = with_act<PartBwdL, __nv_bfloat16>(act, g, x, coef, off, form, aff, F, P, C, bpf, part,
                                            s);
  else if (dtype == kFloat32)
    err = with_act<PartBwdL, float>(act, g, x, coef, off, form, aff, F, P, C, bpf, part, s);
  else
    return kBad;
  if (err) return err;
  const long long nblk = F * bpf;
  group_stats_kernel<NORM_THREADS><<<static_cast<unsigned>(F * C), NORM_THREADS, 0, s>>>(
      part, part + nblk * C, S, S + F * C, bpf, C, C);
  return static_cast<int>(cudaGetLastError());
}

int run_bwd_finalize(const float* S, const float* mvn, const void* w, int wcode, const void* coef,
                     const void* off, int kind, long long F, int G, int C, int cdtype, float* ab,
                     void* dw, void* db, cudaStream_t s) {
  if (!shape_ok(F, 1, C, G) || kind < kBatch || kind > kBatchF32 ||
      (kind != kInstance && (w == nullptr || dw == nullptr || db == nullptr)))
    return kBad;
  const unsigned blocks =
      static_cast<unsigned>(F * G + (kind == kInstance ? 0 : (C + 31) / 32));
  const void* wk = kind == kInstance ? nullptr : w;
  if (cdtype == kBFloat16)
    norm_bwd_finalize_kernel<__nv_bfloat16><<<blocks, 32, 0, s>>>(
        S, mvn, wk, wcode, static_cast<const __nv_bfloat16*>(coef),
        static_cast<const __nv_bfloat16*>(off), kind, static_cast<int>(F), G, C, ab, dw, db);
  else if (cdtype == kFloat32)
    norm_bwd_finalize_kernel<float><<<blocks, 32, 0, s>>>(
        S, mvn, wk, wcode, static_cast<const float*>(coef), static_cast<const float*>(off), kind,
        static_cast<int>(F), G, C, ab, dw, db);
  else
    return kBad;
  return static_cast<int>(cudaGetLastError());
}

int run_dx(const void* g, const void* x, const void* coef, const void* off, Affine aff,
           const float* ab, void* dx, int dtype, long long F, long long P, int C, int form,
           int act, cudaStream_t s) {
  if (!shape_ok(F, P, C, 1) || !form_ok(form, aff.w, aff.b)) return kBad;
  int err;
  if (dtype == kBFloat16)
    err = with_act<DxL, __nv_bfloat16>(act, g, x, coef, off, aff, ab, dx, F, P, C, form, s);
  else if (dtype == kFloat32)
    err = with_act<DxL, float>(act, g, x, coef, off, aff, ab, dx, F, P, C, form, s);
  else
    return kBad;
  return err ? err : static_cast<int>(cudaGetLastError());
}

template <typename T>
void launch_gelu_pool(const void* x, long long F, long long P, int C, int G, const float* mean,
                      const float* coef, const float* scale, const float* bias, int bpf,
                      float* part, float* out, cudaStream_t s) {
  const long long rpb = (P + bpf - 1) / bpf;
  if (vec_ok(C, vec_of<T>(), {x})) {
    constexpr int V = vec_of<T>();
    const int cvec = C / V, cl = cvec < NORM_THREADS ? cvec : NORM_THREADS;
    const dim3 grid(static_cast<unsigned>(F * bpf), static_cast<unsigned>((cvec + cl - 1) / cl));
    gelu_pool_part_kernel<T, V><<<grid, NORM_THREADS, 0, s>>>(
        static_cast<const T*>(x), mean, coef, scale, bias, P, C, G, bpf, rpb, part);
  } else {
    const int cl = C < NORM_THREADS ? C : NORM_THREADS;
    const dim3 grid(static_cast<unsigned>(F * bpf), static_cast<unsigned>((C + cl - 1) / cl));
    gelu_pool_part_kernel<T, 1><<<grid, NORM_THREADS, 0, s>>>(
        static_cast<const T*>(x), mean, coef, scale, bias, P, C, G, bpf, rpb, part);
  }
  channel_sum_kernel<512><<<static_cast<unsigned>(F * ((C + 31) / 32)), 512, 0, s>>>(
      part, out, bpf, C);
}

int run_gelu_pool(const void* x, int dtype, long long F, long long P, int C, int G,
                  const float* mean, const float* coef, const float* scale, const float* bias,
                  int bpf, float* part, float* out, cudaStream_t s) {
  if (!shape_ok(F, P, C, G) || bpf <= 0 || F * bpf > (1LL << 31) - 1 || !mean || !coef ||
      !scale || !bias || !part || !out)
    return kBad;
  if (dtype == kBFloat16)
    launch_gelu_pool<__nv_bfloat16>(x, F, P, C, G, mean, coef, scale, bias, bpf, part, out, s);
  else if (dtype == kFloat32)
    launch_gelu_pool<float>(x, F, P, C, G, mean, coef, scale, bias, bpf, part, out, s);
  else
    return kBad;
  return static_cast<int>(cudaGetLastError());
}

// The one-pass launches: the plan checked against the kernels' assumptions
// (whole groups a slab, 16-byte row pieces, a channel a thread in the
// reductions, every row covered), then one cooperative launch of K * bps
// blocks; the runtime refuses a grid that cannot be resident at once.
template <typename T>
bool onchip_plan_ok(const OnchipPlan& pl, int elem, std::initializer_list<const void*> ptrs) {
  constexpr int VEC = 16 / sizeof(T);
  if (pl.F <= 0 || pl.P <= 0 || pl.C <= 0 || pl.G <= 0 || pl.W <= 0 || pl.K <= 0 ||
      pl.bps <= 0 || pl.rpb <= 0 || pl.C % pl.G || pl.C % pl.W || pl.W % (pl.C / pl.G) ||
      pl.W % VEC || pl.W > OC_THREADS || pl.rpb * pl.bps < pl.P ||
      pl.F * pl.P > (1LL << 40) || pl.F * pl.G > (1LL << 31) - 1)
    return false;
  for (const void* p : ptrs)
    if (p == nullptr || !aligned16(p)) return false;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return onchip_smem_bytes(pl.rpb, pl.W, elem) <= optin;
}

template <typename Kern>
int launch_cooperative(Kern kern, const OnchipPlan& pl, long long smem, void** args,
                       cudaStream_t s) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                    dim3(static_cast<unsigned>(pl.K * pl.bps)), dim3(OC_THREADS),
                                    args, static_cast<size_t>(smem), s);
  return static_cast<int>(err);
}

template <typename T, int ACT>
struct OnchipFwdL {
  static int run(const void* x, const void* w, const void* b, int wcode, int kind, OnchipPlan pl,
                 float count, float* part, void* coef, void* off, float* mvn, void* y,
                 cudaStream_t s) {
    const T* xp = static_cast<const T*>(x);
    T* cp = static_cast<T*>(coef);
    T* op = static_cast<T*>(off);
    T* yp = static_cast<T*>(y);
    void* args[] = {&xp, &w, &b, &wcode, &kind, &pl, &count, &part, &cp, &op, &mvn, &yp};
    return launch_cooperative(norm_apply_kernel_onchip<T, ACT>, pl,
                              onchip_smem_bytes(pl.rpb, pl.W, sizeof(T)), args, s);
  }
};

template <typename T, int ACT>
struct OnchipBwdL {
  static int run(const void* g, const void* x, const void* w, int wcode, const void* coef,
                 const void* off, const float* mvn, int kind, OnchipPlan pl, float* part,
                 float* S, void* dw, void* db, void* dx, cudaStream_t s) {
    const T* gp = static_cast<const T*>(g);
    const T* xp = static_cast<const T*>(x);
    const T* cp = static_cast<const T*>(coef);
    const T* op = static_cast<const T*>(off);
    T* dxp = static_cast<T*>(dx);
    void* args[] = {&gp, &xp, &w, &wcode, &cp, &op, &mvn, &kind, &pl, &part, &S, &dw, &db, &dxp};
    return launch_cooperative(norm_dx_kernel_onchip<T, ACT>, pl,
                              onchip_smem_bytes(pl.rpb, pl.W, sizeof(T) + 4), args, s);
  }
};

int run_onchip_forward(const void* x, const void* w, const void* b, int wcode, int kind,
                       int dtype, const OnchipPlan& pl, int act, float count, float* part,
                       void* coef, void* off, float* mvn, void* y, cudaStream_t s) {
  if ((kind != kGroup && kind != kInstance) || (kind == kGroup && (w == nullptr || b == nullptr)))
    return kBad;
  const std::initializer_list<const void*> ptrs{x, coef, off, y};
  int err;
  if (dtype == kBFloat16)
    err = onchip_plan_ok<__nv_bfloat16>(pl, 2, ptrs)
              ? with_act<OnchipFwdL, __nv_bfloat16>(act, x, w, b, wcode, kind, pl, count, part,
                                                    coef, off, mvn, y, s)
              : kBad;
  else if (dtype == kFloat32)
    err = onchip_plan_ok<float>(pl, 4, ptrs)
              ? with_act<OnchipFwdL, float>(act, x, w, b, wcode, kind, pl, count, part, coef, off,
                                            mvn, y, s)
              : kBad;
  else
    return kBad;
  return err ? err : static_cast<int>(cudaGetLastError());
}

int run_onchip_backward(const void* g, const void* x, const void* w, int wcode, const void* coef,
                        const void* off, const float* mvn, int kind, int dtype,
                        const OnchipPlan& pl, int act, float* part, float* S, void* dw, void* db,
                        void* dx, cudaStream_t s) {
  if ((kind != kGroup && kind != kInstance) ||
      (kind == kGroup && (w == nullptr || dw == nullptr || db == nullptr)))
    return kBad;
  const std::initializer_list<const void*> ptrs{g, x, coef, off, dx};
  void* dwk = kind == kInstance ? nullptr : dw;
  int err;
  if (dtype == kBFloat16)
    err = onchip_plan_ok<__nv_bfloat16>(pl, 6, ptrs)
              ? with_act<OnchipBwdL, __nv_bfloat16>(act, g, x, w, wcode, coef, off, mvn, kind,
                                                    pl, part, S, dwk, db, dx, s)
              : kBad;
  else if (dtype == kFloat32)
    err = onchip_plan_ok<float>(pl, 8, ptrs)
              ? with_act<OnchipBwdL, float>(act, g, x, w, wcode, coef, off, mvn, kind, pl, part,
                                            S, dwk, db, dx, s)
              : kBad;
  else
    return kBad;
  return err ? err : static_cast<int>(cudaGetLastError());
}

}  // namespace

// The passes one by one, for a caller that runs a collective between them
// (a mesh). x, g, y, dx [F * P][C] in the dtype `dtype`; coef, off [F][C] in
// x's dtype for forms 0 (x * coef + off) and 1 (instance norm, (x - off) *
// coef), in fp32 for form 2 (kind 3: ((x - off) * coef) * w + b, coef = r,
// off = m); w, b, dw, db [C] in `wcode`'s dtype (fp32 or bf16); kind 0
// batch (one frame of all rows), 1 group, 2 instance (G = C), 3 batch with
// the fp32 affine; act 0 none, 1 GELU, 2 ReLU, 3 LeakyReLU(0.01).

// Statistics: part [2][F * bpf][C] fp32 scratch, sums [2][F][G] fp32 (the sum
// of x, then of x^2, per frame and group). bpf: blocks a frame (the caller
// sizes part by it).
extern "C" int uncr_norm_stats(const void* x, int dtype, long long F, long long P, int C, int G,
                               int bpf, float* part, float* sums, void* stream) {
  return run_stats(x, dtype, F, P, C, G, bpf, part, sums, static_cast<cudaStream_t>(stream));
}

// The per-slot coef / off [F][C] (in cdtype) and mvn [3 F G + 1] from the
// sums; the count n is *count_dev when given, else count_host.
extern "C" int uncr_norm_finalize(const float* sums, const float* count_dev, float count_host,
                                  const void* w, const void* b, int wcode, int kind, long long F,
                                  int G, int C, int cdtype, void* coef, void* off, float* mvn,
                                  void* stream) {
  return run_finalize(sums, count_dev, count_host, w, b, wcode, kind, F, G, C, cdtype, coef, off,
                      mvn, static_cast<cudaStream_t>(stream));
}

// y = act(pre) with the coef / off of each row's frame
extern "C" int uncr_norm_apply(const void* x, const void* coef, const void* off, const void* w,
                               const void* b, int wcode, void* y, int dtype, long long F,
                               long long P, int C, int form, int act, void* stream) {
  return run_apply(x, coef, off, Affine{w, b, wcode}, y, dtype, F, P, C, form, act,
                   static_cast<cudaStream_t>(stream));
}

// The backward's sums: S [2][F][C] fp32, the sums of g' and of g' * x per
// slot over the frame's rows; part [2][F * bpf][C] scratch.
extern "C" int uncr_norm_bwd_stats(const void* g, const void* x, const void* coef,
                                   const void* off, const void* w, const void* b, int wcode,
                                   int dtype, long long F, long long P, int C, int form, int act,
                                   int bpf, float* part, float* S, void* stream) {
  return run_bwd_stats(g, x, coef, off, Affine{w, b, wcode}, dtype, F, P, C, form, act, bpf,
                       part, S, static_cast<cudaStream_t>(stream));
}

// From S, mvn (the forward's) and w (null for instance norm): ab [2][F][C]
// (A, then B of dx = g' * coef + A * x + B) fp32 and dw, db [C].
extern "C" int uncr_norm_bwd_finalize(const float* S, const float* mvn, const void* w, int wcode,
                                      const void* coef, const void* off, int kind, long long F,
                                      int G, int C, int cdtype, float* ab, void* dw, void* db,
                                      void* stream) {
  return run_bwd_finalize(S, mvn, w, wcode, coef, off, kind, F, G, C, cdtype, ab, dw, db,
                          static_cast<cudaStream_t>(stream));
}

// dx = g' * coef + A * x + B, A and B from ab [2][F][C] (null: 0)
extern "C" int uncr_norm_dx(const void* g, const void* x, const void* coef, const void* off,
                            const void* w, const void* b, int wcode, const float* ab, void* dx,
                            int dtype, long long F, long long P, int C, int form, int act,
                            void* stream) {
  return run_dx(g, x, coef, off, Affine{w, b, wcode}, ab, dx, dtype, F, P, C, form, act,
                static_cast<cudaStream_t>(stream));
}

// The whole forward in one call where no collective sits between its passes
// (one process): the statistics, the per-slot math and the apply. scratch
// holds part [2][F * bpf][C] and then sums [2][F][G].
extern "C" int uncr_norm_forward(const void* x, const void* w, const void* b, int wcode,
                                 int kind, int dtype, long long F, long long P, int C, int G,
                                 int bpf, int form, int act, float count, float* scratch,
                                 void* coef, void* off, float* mvn, void* y, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cdtype = kind == kBatchF32 ? kFloat32 : dtype;
  float* sums = scratch + 2 * F * bpf * C;
  int err = run_stats(x, dtype, F, P, C, G, bpf, scratch, sums, s);
  if (!err)
    err = run_finalize(sums, nullptr, count, w, b, wcode, kind, F, G, C, cdtype, coef, off, mvn,
                       s);
  return err ? err
             : run_apply(x, coef, off, Affine{w, b, wcode}, y, dtype, F, P, C, form, act, s);
}

// The whole backward in one call (one process): scratch holds part [2][F *
// bpf][C], S [2][F][C] and ab [2][F][C].
extern "C" int uncr_norm_backward(const void* g, const void* x, const void* w, const void* b,
                                  int wcode, const void* coef, const void* off, const float* mvn,
                                  int kind, int dtype, long long F, long long P, int C, int G,
                                  int bpf, int form, int act, float* scratch, void* dw, void* db,
                                  void* dx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cdtype = kind == kBatchF32 ? kFloat32 : dtype;
  const Affine aff{w, b, wcode};
  float* S = scratch + 2 * F * bpf * C;
  float* ab = S + 2 * F * C;
  int err = run_bwd_stats(g, x, coef, off, aff, dtype, F, P, C, form, act, bpf, scratch, S, s);
  if (!err)
    err = run_bwd_finalize(S, mvn, w, wcode, coef, off, kind, F, G, C, cdtype, ab, dw, db, s);
  return err ? err : run_dx(g, x, coef, off, aff, ab, dx, dtype, F, P, C, form, act, s);
}

// The whole forward of a group or instance norm in one pass (one process, the
// slab of whole groups on chip): the plan (W channels a slab, K slabs a wave,
// bps blocks a slab of rpb rows each) from ops/norm.py:onchip_plan; part
// [2][K * bps][W / (C / G)][2] fp32 scratch; coef, off, mvn, y as
// uncr_norm_forward gives them.
extern "C" int uncr_norm_forward_onchip(const void* x, const void* w, const void* b, int wcode,
                                        int kind, int dtype, long long F, long long P, int C,
                                        int G, int W, int K, int bps, long long rpb, int act,
                                        float count, float* part, void* coef, void* off,
                                        float* mvn, void* y, void* stream) {
  const OnchipPlan pl{F, P, rpb, C, G, W, K, bps};
  return run_onchip_forward(x, w, b, wcode, kind, dtype, pl, act, count, part, coef, off, mvn, y,
                            static_cast<cudaStream_t>(stream));
}

// Its backward in one pass: part [2][K * bps][W][2] and S [2][F][C] fp32
// scratch; dw, db, dx as uncr_norm_backward gives them.
extern "C" int uncr_norm_backward_onchip(const void* g, const void* x, const void* w, int wcode,
                                         const void* coef, const void* off, const float* mvn,
                                         int kind, int dtype, long long F, long long P, int C,
                                         int G, int W, int K, int bps, long long rpb, int act,
                                         float* part, float* S, void* dw, void* db, void* dx,
                                         void* stream) {
  const OnchipPlan pl{F, P, rpb, C, G, W, K, bps};
  return run_onchip_backward(g, x, w, wcode, coef, off, mvn, kind, dtype, pl, act, part, S, dw,
                             db, dx, static_cast<cudaStream_t>(stream));
}

// The squeeze-and-excitation's pooled sum of the group-norm MBConv's eval
// chain: out [F][C] fp32, per frame and channel the sum over the frame's P
// rows of x of gelu(((x - m) * r) * scale + bias); mean and coef [F][G] fp32
// (each group's mean and rsqrt(var + eps)), scale and bias [C] fp32; part
// [F * bpf][C] fp32 scratch (bpf: blocks a frame).
extern "C" int uncr_norm_gelu_pool(const void* x, int dtype, long long F, long long P, int C,
                                   int G, const float* mean, const float* coef,
                                   const float* scale, const float* bias, int bpf, float* part,
                                   float* out, void* stream) {
  return run_gelu_pool(x, dtype, F, P, C, G, mean, coef, scale, bias, bpf, part, out,
                       static_cast<cudaStream_t>(stream));
}

// The current device's SM count and the shared memory a block may opt into
// (what ops/norm.py:onchip_plan sizes the waves by)
extern "C" int uncr_device_limits(int* out) {
  int dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&out[1], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(cudaGetLastError());
}
