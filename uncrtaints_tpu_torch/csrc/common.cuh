// Helpers shared by the port's kernels: dtype codes, 16-byte vector loads
// and stores with fp32 conversion, raw vectors, the depthwise geometry, and
// the exact (erf) GELU.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// dtype codes passed from the Python wrappers
enum UncrDtype : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
// round to nearest even, as torch's .to(torch.bfloat16)
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC consecutive elements -> fp32. When VEC * sizeof(T) is a multiple of
// 16 bytes (and p is 16-byte aligned, which the callers check) the elements
// move as 128-bit words; otherwise one by one.
template <typename T, int VEC>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, float* out) {
  if constexpr ((VEC * sizeof(T)) % 16 == 0) {
    constexpr int PER = 16 / sizeof(T);
#pragma unroll
    for (int q = 0; q < VEC / PER; ++q) {
      uint4 u = reinterpret_cast<const uint4*>(p)[q];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < PER; ++j) out[q * PER + j] = to_f32(e[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) out[j] = to_f32(p[j]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_from_f32(T* __restrict__ p, const float* v) {
  if constexpr ((VEC * sizeof(T)) % 16 == 0) {
    constexpr int PER = 16 / sizeof(T);
#pragma unroll
    for (int q = 0; q < VEC / PER; ++q) {
      uint4 u;
      T* e = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int j = 0; j < PER; ++j) e[j] = from_f32<T>(v[q * PER + j]);
      reinterpret_cast<uint4*>(p)[q] = u;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = from_f32<T>(v[j]);
  }
}

// VEC consecutive elements kept in their storage type (half the registers of
// an fp32 copy for bf16). VEC * sizeof(T) is 2, 4, 8 or 16 bytes, so a load
// or store of a whole RawVec is one instruction when p is aligned to its
// size (the callers check).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) RawVec {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ RawVec<T, VEC> load_raw(const T* __restrict__ p) {
  return *reinterpret_cast<const RawVec<T, VEC>*>(p);
}

template <typename T, int VEC>
__device__ __forceinline__ RawVec<T, VEC> zero_raw() {
  RawVec<T, VEC> r;
#pragma unroll
  for (int j = 0; j < VEC; ++j) r.v[j] = from_f32<T>(0.0f);
  return r;
}

// Geometry of a stride-1 depthwise correlation over NHWC maps: input
// [N,H,W,C], output [N,Ho,Wo,C], top/left zero pads pt/pl.
struct DwGeo {
  int N, H, W, C, Ho, Wo, pt, pl;
};

// the VEC channels at (n, r, s, ch) of the input, zeros outside it (the
// zero padding as a bounds check, no padded copy)
template <typename T, int VEC>
__device__ __forceinline__ RawVec<T, VEC> dw_load_or_zero(const T* __restrict__ x,
                                                          const DwGeo& g, int n, int r, int s,
                                                          int ch) {
  if (r < 0 || r >= g.H || s < 0 || s >= g.W) return zero_raw<T, VEC>();
  return load_raw<T, VEC>(x + ((static_cast<long long>(n) * g.H + r) * g.W + s) * g.C + ch);
}

// exact GELU in the operation order of torch's and jax.nn.gelu's erf form
__device__ __forceinline__ float gelu_exact(float v) {
  return v * 0.5f * (1.0f + erff(v * 0.70710678118654752f));
}

__host__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__host__ __forceinline__ bool aligned_to(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1u)) == 0;
}
