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
// Bound: device memory. The forward reads x twice (statistics, apply) and
// writes y once; the backward reads g and x twice (sums, dx) and writes dx.
// What the design does about it:
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
#include <initializer_list>

#include "common.cuh"

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
