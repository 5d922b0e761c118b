// Helpers shared by the port's kernels: dtype codes, 16-byte vector loads
// and stores with fp32 conversion, raw vectors, the depthwise geometry and
// border modes, the exact (erf) GELU, cp.async copies, and the second passes of the per-group
// output statistics and of the per-channel pooled sum.
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

// Border modes of the depthwise kernels K5 and K2 (the codes the Python
// wrappers pass): zero pads; torch's reflect pad of one pixel around a 3x3
// kernel, taken as mirrored indices on the unpadded input; and, for K5 only,
// the adjoint of that reflect correlation (the input gradient with the pad's
// fold inside).
enum DwMode : int { kZeros = 0, kReflect = 1, kReflectAdjoint = 2 };

// Geometry of a stride-1 depthwise correlation over NHWC maps: input
// [N,H,W,C], output [N,Ho,Wo,C], top/left pads pt/pl (zeros, or mirrored
// pixels in kReflect, where pt = pl = 1 and Ho = H, Wo = W). In kReflect a
// map may be one band of rows of a taller scene: then `top` and `bot`
// ([N,W,C], the input's dtype) are the rows just above and below it, read
// for rows -1 and H instead of the mirrored rows; a null one mirrors (the
// scene's own edge). Columns always mirror.
struct DwGeo {
  int N, H, W, C, Ho, Wo, pt, pl, mode;
  const void* top;
  const void* bot;
};

// the halo row that stands for row r of a band of H rows (top for -1, bot
// for H), or null where r is read from the band itself or mirrored
__device__ __forceinline__ const void* dw_halo_row(int r, int H, const void* top,
                                                   const void* bot) {
  return r == -1 ? top : (r == H ? bot : nullptr);
}

// torch's reflect index for a pad of one (-1 -> 1, n -> n-2), clamped into
// [0, n) so that rows past a ragged tile still name a valid row
__device__ __forceinline__ int dw_mirror(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * n - 2 - i : i;
  return min(max(i, 0), n - 1);
}

// the VEC channels at (n, r, s, ch) of the input: in kReflect the halo row's
// pixel (rows -1 and H of a band) or the mirrored pixel, else zeros outside the map (the padding as an index rule or a
// bounds check, no padded copy)
template <typename T, int VEC>
__device__ __forceinline__ RawVec<T, VEC> dw_load(const T* __restrict__ x, const DwGeo& g, int n,
                                                  int r, int s, int ch) {
  if (g.mode == kReflect) {
    s = dw_mirror(s, g.W);
    const T* halo = static_cast<const T*>(dw_halo_row(r, g.H, g.top, g.bot));
    if (halo) return load_raw<T, VEC>(halo + (static_cast<long long>(n) * g.W + s) * g.C + ch);
    r = dw_mirror(r, g.H);
  } else if (r < 0 || r >= g.H || s < 0 || s >= g.W) {
    return zero_raw<T, VEC>();
  }
  return load_raw<T, VEC>(x + ((static_cast<long long>(n) * g.H + r) * g.W + s) * g.C + ch);
}

// exact GELU in the operation order of torch's and jax.nn.gelu's erf form
__device__ __forceinline__ float gelu_exact(float v) {
  return v * 0.5f * (1.0f + erff(v * 0.70710678118654752f));
}

// 16 bytes from device to shared memory without passing registers; with
// valid false nothing is read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most PENDING of this thread's committed groups are in flight
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Last pass of the per-(frame, group) output statistics of K3 and K4. Given
// per-channel partial sums psum/psq [N * blocks_per_frame, C], one block per
// (frame n, group g) adds the frame's partials over the group's channels in
// a fixed order (a strided walk, then shuffle trees), so two runs give the
// same bits: no atomics. (launch_group_stats below first brings the rows of
// a frame down to one.)
// A template so that a source that does not launch it compiles nothing; in
// an unnamed namespace so that each source that does gets its own copy.
namespace {
template <int THREADS>
__global__ void group_stats_kernel(const float* __restrict__ psum, const float* __restrict__ psq,
                                   float* __restrict__ sum, float* __restrict__ sumsq,
                                   int blocks_per_frame, int C, int groups) {
  const int n = blockIdx.x / groups, g = blockIdx.x % groups;
  const int cg = C / groups;
  const long long total = static_cast<long long>(blocks_per_frame) * cg;
  float s = 0.0f, q = 0.0f;
  for (long long i = threadIdx.x; i < total; i += THREADS) {
    const long long idx =
        (static_cast<long long>(n) * blocks_per_frame + i / cg) * C + g * cg + i % cg;
    s += psum[idx];
    q += psq[idx];
  }
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
    q += __shfl_down_sync(0xffffffffu, q, off);
  }
  __shared__ float ws[THREADS / 32], wq[THREADS / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    ws[warp] = s;
    wq[warp] = q;
  }
  __syncthreads();
  if (warp == 0) {
    s = lane < THREADS / 32 ? ws[lane] : 0.0f;
    q = lane < THREADS / 32 ? wq[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, off);
      q += __shfl_down_sync(0xffffffffu, q, off);
    }
    if (lane == 0) {
      sum[blockIdx.x] = s;
      sumsq[blockIdx.x] = q;
    }
  }
}

// The per-channel sibling of group_stats_kernel, for K4's pooled sum:
// out[n, c] = the sum over frame n's partial rows of part[row, c], part
// [N * rows_per_frame, C]. A block takes 32 channels of one frame; its
// THREADS / 32 row lanes walk the rows with that stride and are added in a
// fixed order, so two runs give the same bits.
template <int THREADS>
__global__ void channel_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                                   int rows_per_frame, int C) {
  constexpr int LANES = THREADS / 32;
  __shared__ float sh[LANES][32];
  const int cblocks = (C + 31) / 32;
  const int n = blockIdx.x / cblocks, c = (blockIdx.x % cblocks) * 32 + (threadIdx.x & 31);
  const int lane = threadIdx.x >> 5;
  float s = 0.0f;
  if (c < C)
    for (int r = lane; r < rows_per_frame; r += LANES)
      s += part[(static_cast<long long>(n) * rows_per_frame + r) * C + c];
  sh[lane][threadIdx.x & 31] = s;
  __syncthreads();
  if (lane == 0 && c < C) {
    float t = 0.0f;
#pragma unroll
    for (int l = 0; l < LANES; ++l) t += sh[l][threadIdx.x];
    out[static_cast<long long>(n) * C + c] = t;
  }
}

// Both second passes of the statistics, launched behind the kernel that
// wrote the partial rows: first the rows of each frame are added per
// channel (many blocks, coalesced), then each (frame, group) adds its
// channels. psum and psq hold N more rows than the N * rows_per_frame
// partial rows; the per-channel sums go there. (A template for the same
// reason as the kernels: only a source that calls it compiles them.)
template <int THREADS = 256>
void launch_group_stats(float* psum, float* psq, float* sum, float* sumsq, int N,
                               int rows_per_frame, int C, int groups, cudaStream_t s) {
  const long long tail = static_cast<long long>(N) * rows_per_frame * C;
  const int blocks = N * ((C + 31) / 32);
  channel_sum_kernel<512><<<blocks, 512, 0, s>>>(psum, psum + tail, rows_per_frame, C);
  channel_sum_kernel<512><<<blocks, 512, 0, s>>>(psq, psq + tail, rows_per_frame, C);
  group_stats_kernel<THREADS><<<N * groups, THREADS, 0, s>>>(psum + tail, psq + tail, sum, sumsq,
                                                             1, C, groups);
}
}  // namespace

__host__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__host__ __forceinline__ bool aligned_to(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1u)) == 0;
}
