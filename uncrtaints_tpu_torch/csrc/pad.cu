// Reflect pad of an NHWC map and its adjoint (kernel K7), for the convolutions
// that take a padded tensor (models/layers.py:Conv2d: every reflect conv that
// K5 and K2 do not fold, e.g. U-TAE's dense convs and the eval encoder's
// depthwise 3x3).
//
//   forward   x [N,H,W,C] -> y [N,H+2p,W+2p,C], y[n,r,s] = x[n,m(r-p),m(s-p)]
//             with torch's reflect index m (-i for i < 0, 2L-2-i for i >= L:
//             the edge is not repeated, corners mirror on both axes)
//   adjoint   g [N,H+2p,W+2p,C] -> gx [N,H,W,C], gx[n,i,j] = the sum of the
//             g[n,r,s] with m(r-p) = i and m(s-p) = j: per axis the padded
//             position i+p and up to two mirrored ones (p-i for 1 <= i <= p,
//             2L-2-i+p for L-1-p <= i <= L-2). Each row source's column
//             terms are summed first (primary, left, right), then the row
//             sources (primary, top, bottom), in fp32, rounded once: the
//             order of the plain version in ops/pad.py, so fp32 agrees to
//             the bit. A gather: every gx element is written once, no
//             atomics, no zero-fill, the same bits every run.
//
// Replaces: no Pallas kernel. On the TPU the JAX package's jnp.pad is fused
// by XLA into the convolution that reads it (its strip-reflect options are
// TPU workarounds and are not ported). Here ATen's channels-last
// reflection_pad3d and its backward ran at about a tenth of the card's
// memory bandwidth and were the largest device cost of the U-TAE train step
// and the paper recipe's eval request.
//
// Bound: device memory, (|x| + |y|) / 3.35 TB/s each way: a copy. What the
// design does about it:
// - one block writes one output row (the adjoint: one gx row). A row is
//   (W+2p)*C contiguous elements and its interior, columns p to p+W-1, is
//   the mirrored input row itself shifted by p*C: loads and stores of
//   neighbouring threads touch neighbouring addresses, and only the 2p halo
//   pixels of a row compute a mirrored column (one integer division). The
//   adjoint sums the interior of its 1 to 3 source rows in one loop and its
//   2p+2 halo columns (up to 3 sources a row each) in another, so the long
//   loop keeps few registers;
// - elements move as vectors of the widest of 16, 8, 4 or 2 bytes that
//   divides C*sizeof(T) and the pointers (16 bytes for every padded map of
//   the paper recipe and U-TAE; 2 bytes for 15 bf16 channels);
// - each thread keeps about 64 bytes of loads in flight before it stores
//   (UNROLL vectors), enough to cover the memory latency.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kInFlightBytes = 64;

// torch's reflect index of i in [-p, n+p) for a pad p < n
__device__ __forceinline__ int reflect_index(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// y row (n, r) from x row (n, m(r-p)). Rows of y: N*(H+2p), one a block.
// Offsets are in vectors of VEC elements; CV = C / VEC vectors a pixel.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) reflect_pad_nhwc_kernel(
    const T* __restrict__ x, T* __restrict__ y, int H, int W, int CV, int p) {
  using V = RawVec<T, VEC>;
  constexpr int UNROLL = kInFlightBytes / sizeof(V);
  const int H2 = H + 2 * p, W2 = W + 2 * p;
  const int n = blockIdx.x / H2, r = blockIdx.x - n * H2;
  const V* src = reinterpret_cast<const V*>(x) +
                 (static_cast<long long>(n) * H + reflect_index(r - p, H)) * W * CV;
  V* dst = reinterpret_cast<V*>(y) + static_cast<long long>(blockIdx.x) * W2 * CV;
  const int row = W2 * CV, lo = p * CV, hi = (p + W) * CV;
  for (int base = threadIdx.x; base < row; base += kThreads * UNROLL) {
    V v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int e = base + u * kThreads;
      if (e < row) {
        int s = e - lo;  // the interior: the input row shifted by p pixels
        if (e < lo || e >= hi) {
          const int px = e / CV;
          s = reflect_index(px - p, W) * CV + (e - px * CV);
        }
        v[u] = src[s];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int e = base + u * kThreads;
      if (e < row) dst[e] = v[u];
    }
  }
}

// the padded positions of a length-n axis whose reflect index is i: i+p
// always, p-i where 1 <= i <= p (the low mirror), 2n-2-i+p where
// n-1-p <= i <= n-2 (the high mirror)
__device__ __forceinline__ bool low_mirror(int i, int p) { return i >= 1 && i <= p; }
__device__ __forceinline__ bool high_mirror(int i, int n, int p) {
  return i >= n - 1 - p && i <= n - 2;
}

// the fp32 sum of VEC channels at the column offsets `cols` (those whose
// flag is set; the first always is) of row `row`, in that order
template <typename T, int VEC>
__device__ __forceinline__ void column_sum(const RawVec<T, VEC>* row, const int* cols,
                                           const bool* has, float* rs) {
  const RawVec<T, VEC> v = row[cols[0]];
#pragma unroll
  for (int j = 0; j < VEC; ++j) rs[j] = to_f32(v.v[j]);
#pragma unroll
  for (int q = 1; q < 3; ++q) {
    if (!has[q]) continue;
    const RawVec<T, VEC> w = row[cols[q]];
#pragma unroll
    for (int j = 0; j < VEC; ++j) rs[j] += to_f32(w.v[j]);
  }
}

// gx row (n, i) from the 1 to 3 rows of g that mirror onto it. Rows of gx:
// N*H, one a block. A row source's column terms are summed first (i+p, the
// low, the high mirror), then the row sources in the same order, in fp32.
// The interior columns (one source each, most of a row) take a loop that
// keeps UNROLL vectors of each row source in flight; the 2p+2 halo columns
// a loop of their own.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) reflect_pad_adjoint_nhwc_kernel(
    const T* __restrict__ g, T* __restrict__ gx, int H, int W, int CV, int p) {
  using V = RawVec<T, VEC>;
  constexpr int UNROLL = kInFlightBytes / sizeof(V) < 8 ? kInFlightBytes / sizeof(V) : 8;
  const int H2 = H + 2 * p, W2 = W + 2 * p;
  const int n = blockIdx.x / H, i = blockIdx.x - n * H;
  const bool has_row[3] = {true, low_mirror(i, p), high_mirror(i, H, p)};
  const int row_pos[3] = {i + p, p - i, 2 * H - 2 - i + p};
  const V* rows[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    rows[k] = reinterpret_cast<const V*>(g) +
              (static_cast<long long>(n) * H2 + (has_row[k] ? row_pos[k] : i + p)) * W2 * CV;
  V* dst = reinterpret_cast<V*>(gx) + static_cast<long long>(blockIdx.x) * W * CV;
  // the interior columns j of gx, p < j < W-1-p: vector offsets [lo, hi)
  const int row = W * CV, lo = (p + 1) * CV, hi = max((W - 1 - p) * CV, lo);
  const int shift = p * CV;
  for (int base = lo + threadIdx.x; base < hi; base += kThreads * UNROLL) {
    V v[3][UNROLL];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (!has_row[k]) continue;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int e = base + u * kThreads;
        if (e < hi) v[k][u] = rows[k][e + shift];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int e = base + u * kThreads;
      if (e >= hi) continue;
      V out;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float acc = to_f32(v[0][u].v[j]);
        if (has_row[1]) acc += to_f32(v[1][u].v[j]);
        if (has_row[2]) acc += to_f32(v[2][u].v[j]);
        out.v[j] = from_f32<T>(acc);
      }
      dst[e] = out;
    }
  }
  // the halo columns: offsets [0, lo) and [hi, row), each up to three
  // column sources a row source
  const int n_halo = lo + (row - hi);
  for (int h = threadIdx.x; h < n_halo; h += kThreads) {
    const int e = h < lo ? h : hi + (h - lo);
    const int j = e / CV, c = e - j * CV;
    const bool has_col[3] = {true, low_mirror(j, p), high_mirror(j, W, p)};
    const int cols[3] = {(j + p) * CV + c, (p - j) * CV + c, (2 * W - 2 - j + p) * CV + c};
    float acc[VEC], rs[VEC];
    column_sum<T, VEC>(rows[0], cols, has_col, acc);
#pragma unroll
    for (int k = 1; k < 3; ++k) {
      if (!has_row[k]) continue;
      column_sum<T, VEC>(rows[k], cols, has_col, rs);
#pragma unroll
      for (int jj = 0; jj < VEC; ++jj) acc[jj] += rs[jj];
    }
    V out;
#pragma unroll
    for (int jj = 0; jj < VEC; ++jj) out.v[jj] = from_f32<T>(acc[jj]);
    dst[e] = out;
  }
}

// the widest vector (16, 8, 4 or 2 bytes, at least one element) that divides
// a pixel's bytes and both pointers' alignment
int vector_bytes(int C, int elem, const void* a, const void* b) {
  const unsigned long long addr =
      reinterpret_cast<unsigned long long>(a) | reinterpret_cast<unsigned long long>(b);
  int v = 16;
  while (v > elem && ((C * elem) % v != 0 || addr % v != 0)) v /= 2;
  return v;
}

template <typename T, int VEC>
void launch(bool adjoint, const void* in, void* out, int N, int H, int W, int C, int p,
            cudaStream_t s) {
  const int CV = C / VEC;
  if (adjoint)
    reflect_pad_adjoint_nhwc_kernel<T, VEC><<<N * H, kThreads, 0, s>>>(
        static_cast<const T*>(in), static_cast<T*>(out), H, W, CV, p);
  else
    reflect_pad_nhwc_kernel<T, VEC><<<N * (H + 2 * p), kThreads, 0, s>>>(
        static_cast<const T*>(in), static_cast<T*>(out), H, W, CV, p);
}

template <typename T>
void dispatch(bool adjoint, const void* in, void* out, int N, int H, int W, int C, int p,
              cudaStream_t s) {
  constexpr int E = sizeof(T);
  switch (vector_bytes(C, E, in, out)) {
    case 16: launch<T, 16 / E>(adjoint, in, out, N, H, W, C, p, s); break;
    case 8: launch<T, 8 / E>(adjoint, in, out, N, H, W, C, p, s); break;
    case 4: launch<T, 4 / E>(adjoint, in, out, N, H, W, C, p, s); break;
    default: launch<T, 1>(adjoint, in, out, N, H, W, C, p, s); break;
  }
}

int run(bool adjoint, const void* in, void* out, int N, int H, int W, int C, int p, int dtype,
        void* stream) {
  if (p < 1 || p >= H || p >= W || N < 1 || C < 1 || (dtype != kBFloat16 && dtype != kFloat32))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    dispatch<__nv_bfloat16>(adjoint, in, out, N, H, W, C, p, s);
  else
    dispatch<float>(adjoint, in, out, N, H, W, C, p, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [N,H,W,C] -> y [N,H+2p,W+2p,C], both contiguous in `dtype` (kBFloat16 or
// kFloat32); 1 <= p < min(H, W).
extern "C" int uncr_reflect_pad_nhwc(const void* x, void* y, int N, int H, int W, int C, int p,
                                     int dtype, void* stream) {
  return run(false, x, y, N, H, W, C, p, dtype, stream);
}

// g [N,H+2p,W+2p,C] -> gx [N,H,W,C] (H, W the unpadded sizes), the adjoint of
// uncr_reflect_pad_nhwc; the same conditions.
extern "C" int uncr_reflect_pad_adjoint_nhwc(const void* g, void* gx, int N, int H, int W, int C,
                                             int p, int dtype, void* stream) {
  return run(true, g, gx, N, H, W, C, p, dtype, stream);
}
