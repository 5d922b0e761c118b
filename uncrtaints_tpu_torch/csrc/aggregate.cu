// att_group temporal aggregation (kernel K1): forward and backward.
//
//   out[b,p,c] = sum_t attn[b,t,p, c / (C/heads)] * x[b,t,p,c]
//
// and, for the output gradient g[b,p,c],
//
//   dx[b,t,p,c]    = attn[b,t,p, c / (C/heads)] * g[b,p,c]
//   dattn[b,t,p,h] = sum_{c in head h} x[b,t,p,c] * g[b,p,c]
//
// x [B,T,P,C] and attn [B,T,P,heads] in one dtype (bf16 or fp32); products
// and the sum over T in fp32, one cast to the output dtype at the end.
//
// Replaces: uncrtaints_tpu/ops/pallas_aggregate.py att_group_aggregate
// (forward kernel _mk_kernel / _fwd_call). The TPU kernel expands the head
// weights to channels with a 0/1 selection matmul to dodge a Mosaic lane
// relayout; a GPU thread indexes the head directly, so that trick is gone.
//
// Bound: device memory. Per output element the kernel reads T elements of x
// and T head weights and writes one element: about 1 FLOP per 2 bytes, far
// below the card's ~295 FLOP/byte balance point. The design therefore only
// moves bytes well: one thread owns one (b, pixel, 16-byte group of
// channels), reads x once with 128-bit loads (neighbouring threads on
// neighbouring addresses), keeps the T-sum in registers, and writes once.
// The pixel's head weights (heads * 2 bytes) are shared by the C/VEC
// threads of that pixel and come from L1.
//
// Backward replaces _bwd_call / _mk_bwd_kernel of the same file (the TPU
// kernel's head contraction is the transposed 0/1 selection matmul). It is
// bound by device memory too: it reads x and g and writes dx (each T * C
// elements per pixel) and dattn. One thread owns one (b, pixel, head): it
// walks t, reads the head's C/heads channels of x and g as 16-byte vectors
// where the head's width allows (neighbouring threads, neighbouring heads:
// neighbouring addresses), writes dx and the head's dot product in the same
// pass. g is read once from device memory; its T re-reads hit the cache.
#include "common.cuh"

namespace {

template <typename T, int VEC>
__global__ void att_group_kernel(const T* __restrict__ x, const T* __restrict__ attn,
                                 T* __restrict__ out, int B, int T_, long long rows,
                                 int C, int heads) {
  const int cg = C / heads;
  const int nvec = C / VEC;
  const long long total = static_cast<long long>(B) * rows * nvec;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c0 = static_cast<int>(i % nvec) * VEC;
    const long long bp = i / nvec;  // b * rows + pixel
    const long long b = bp / rows, pix = bp % rows;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
    for (int t = 0; t < T_; ++t) {
      const long long frame = (b * T_ + t) * rows + pix;
      float xv[VEC];
      load_f32<T, VEC>(x + frame * C + c0, xv);
      const T* a = attn + frame * heads;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        // no FMA contraction: the same roundings as the plain version's
        // product-then-sum
        acc[j] = __fadd_rn(acc[j], __fmul_rn(to_f32(a[(c0 + j) / cg]), xv[j]));
    }
    store_from_f32<T, VEC>(out + bp * C + c0, acc);
  }
}

template <typename T, int VEC>
void launch(const void* x, const void* attn, void* out, int B, int T_, long long rows, int C,
            int heads, cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * rows * (C / VEC);
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < (1LL << 20) ? want : (1LL << 20));
  att_group_kernel<T, VEC><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(attn), static_cast<T*>(out), B, T_, rows,
      C, heads);
}

template <typename T, int VEC>
__global__ void att_group_bwd_kernel(const T* __restrict__ x, const T* __restrict__ attn,
                                     const T* __restrict__ g, T* __restrict__ dx,
                                     T* __restrict__ da, int B, int T_, long long rows, int C,
                                     int heads) {
  const int cg = C / heads;
  const long long total = static_cast<long long>(B) * rows * heads;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int h = static_cast<int>(i % heads);
    const long long bp = i / heads;  // b * rows + pixel
    const long long b = bp / rows, pix = bp % rows;
    const T* gp = g + bp * C + h * cg;
    for (int t = 0; t < T_; ++t) {
      const long long frame = (b * T_ + t) * rows + pix;
      const float a = to_f32(attn[frame * heads + h]);
      const long long off = frame * C + h * cg;
      float s = 0.0f;
      for (int k = 0; k < cg; k += VEC) {
        float gv[VEC], xv[VEC], dv[VEC];
        load_f32<T, VEC>(gp + k, gv);
        load_f32<T, VEC>(x + off + k, xv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          dv[j] = __fmul_rn(a, gv[j]);
          s = __fadd_rn(s, __fmul_rn(xv[j], gv[j]));
        }
        store_from_f32<T, VEC>(dx + off + k, dv);
      }
      da[frame * heads + h] = from_f32<T>(s);
    }
  }
}

template <typename T, int VEC>
void launch_bwd(const void* x, const void* attn, const void* g, void* dx, void* da, int B,
                int T_, long long rows, int C, int heads, cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * rows * heads;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < (1LL << 20) ? want : (1LL << 20));
  att_group_bwd_kernel<T, VEC><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(attn), static_cast<const T*>(g),
      static_cast<T*>(dx), static_cast<T*>(da), B, T_, rows, C, heads);
}

}  // namespace

// x [B,T,rows,C], attn [B,T,rows,heads], out [B,rows,C], all contiguous, in
// the dtype given by `dtype`; C % heads == 0 (checked by the wrapper).
extern "C" int uncr_att_group_aggregate(const void* x, const void* attn, void* out, int B,
                                        int T, long long rows, int C, int heads, int dtype,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec_ok = aligned16(x) && aligned16(out);
  if (dtype == kBFloat16) {
    if (vec_ok && C % 8 == 0)
      launch<__nv_bfloat16, 8>(x, attn, out, B, T, rows, C, heads, s);
    else
      launch<__nv_bfloat16, 1>(x, attn, out, B, T, rows, C, heads, s);
  } else if (dtype == kFloat32) {
    if (vec_ok && C % 4 == 0)
      launch<float, 4>(x, attn, out, B, T, rows, C, heads, s);
    else
      launch<float, 1>(x, attn, out, B, T, rows, C, heads, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x [B,T,rows,C], attn [B,T,rows,heads], g [B,rows,C] -> dx [B,T,rows,C],
// dattn [B,T,rows,heads]; all contiguous in the dtype given by `dtype`,
// C % heads == 0 (checked by the wrapper).
extern "C" int uncr_att_group_aggregate_bwd(const void* x, const void* attn, const void* g,
                                            void* dx, void* dattn, int B, int T, long long rows,
                                            int C, int heads, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cg = C / heads;
  // a head's channels move as 16-byte vectors when its width in bytes is a
  // multiple of 16 and the tensors are 16-byte aligned
  const bool vec_ok = aligned16(x) && aligned16(g) && aligned16(dx);
  if (dtype == kBFloat16) {
    if (vec_ok && cg % 8 == 0)
      launch_bwd<__nv_bfloat16, 8>(x, attn, g, dx, dattn, B, T, rows, C, heads, s);
    else
      launch_bwd<__nv_bfloat16, 1>(x, attn, g, dx, dattn, B, T, rows, C, heads, s);
  } else if (dtype == kFloat32) {
    if (vec_ok && cg % 4 == 0)
      launch_bwd<float, 4>(x, attn, g, dx, dattn, B, T, rows, C, heads, s);
    else
      launch_bwd<float, 1>(x, attn, g, dx, dattn, B, T, rows, C, heads, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
