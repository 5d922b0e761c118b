// Depthwise-convolution weight gradient for all taps (kernel K2).
//
//   gw[c, dy, dx] = sum_{n,h,w} xpad[n, h+dy, w+dx, c] * g[n, h, w, c]
//   xpad[n, r, s, c] = x[n, r-pt, s-pl, c] inside x, 0 outside
//
// x [N,H,W,C] (the primal conv's input) and g [N,Ho,Wo,C] (its output
// gradient) NHWC in one dtype (bf16 or fp32); gw [C,kh,kw] fp32 (the port's
// depthwise weight layout [C,1,kh,kw]). Products and sums in fp32.
//
// Replaces: uncrtaints_tpu/ops/pallas_dwgrad.py dw_kernel_grad (_mk_kernel).
// The TPU kernel DMAs a row window of a padded copy of x per grid step and
// writes one partial per step, summed afterwards by XLA; here the pad is a
// bounds check and both passes are kernels.
//
// Bound: device memory. The gradient needs one read of x and of g (0.8 GB in
// bf16 at the encoder's [12,258,258,256]) for kh*kw multiply-adds per
// element of g. Pass 1: a thread owns one (16-byte or 8-byte channel vector)
// and walks segments of WSEG columns of g rows with a kh x kw window of x
// vectors in registers (kh new loads and one g load per position), keeping
// kh*kw*VEC fp32 sums in registers. The block's 8 lanes add their sums in a
// fixed order in shared memory and write one partial [kh*kw, C] per block.
// Pass 2 adds the partials of all blocks per (c, tap) in a fixed order. No
// atomics: the result does not depend on the schedule.
#include "common.cuh"

namespace {

constexpr int WSEG = 32;        // g columns per work item
constexpr int TX = 32, TY = 8;  // block: 32 channel vectors x 8 lanes
constexpr int MAX_BLOCKS = 256; // pass-1 blocks along the pixels (partials)

// part [gridDim.x, KH*KW, C]: the block's sums over its work items
template <typename T, int VEC, int KH, int KW>
__global__ void __launch_bounds__(TX * TY)
    dw_grad_partial_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                           float* __restrict__ part, DwGeo g) {
  __shared__ float red[KH * KW][TY][TX * VEC];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ch = blockIdx.y * TX * VEC + tx * VEC;
  const bool active = ch < g.C;
  float acc[KH * KW][VEC];
#pragma unroll
  for (int t = 0; t < KH * KW; ++t)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[t][j] = 0.0f;

  const int nseg = (g.Wo + WSEG - 1) / WSEG;
  const long long items = static_cast<long long>(g.N) * g.Ho * nseg;
  for (long long item = static_cast<long long>(blockIdx.x) * TY + ty; active && item < items;
       item += static_cast<long long>(gridDim.x) * TY) {
    const int seg = static_cast<int>(item % nseg);
    const long long rest = item / nseg;
    const int ho = static_cast<int>(rest % g.Ho), n = static_cast<int>(rest / g.Ho);
    const int w0 = seg * WSEG, w1 = min(w0 + WSEG, g.Wo);
    RawVec<T, VEC> win[KH][KW];
#pragma unroll
    for (int dy = 0; dy < KH; ++dy)
#pragma unroll
      for (int dx = 0; dx + 1 < KW; ++dx)
        win[dy][dx + 1] = dw_load_or_zero<T, VEC>(x, g, n, ho + dy - g.pt, w0 + dx - g.pl, ch);
    const T* gp = gy + ((static_cast<long long>(n) * g.Ho + ho) * g.Wo + w0) * g.C + ch;
    for (int wo = w0; wo < w1; ++wo, gp += g.C) {
#pragma unroll
      for (int dy = 0; dy < KH; ++dy) {
#pragma unroll
        for (int dx = 0; dx + 1 < KW; ++dx) win[dy][dx] = win[dy][dx + 1];
        win[dy][KW - 1] = dw_load_or_zero<T, VEC>(x, g, n, ho + dy - g.pt, wo + KW - 1 - g.pl, ch);
      }
      const RawVec<T, VEC> gv = load_raw<T, VEC>(gp);
#pragma unroll
      for (int dy = 0; dy < KH; ++dy)
#pragma unroll
        for (int dx = 0; dx < KW; ++dx)
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            acc[dy * KW + dx][j] += to_f32(win[dy][dx].v[j]) * to_f32(gv.v[j]);
    }
  }

  // the block's 8 lanes, added in lane order
#pragma unroll
  for (int t = 0; t < KH * KW; ++t)
#pragma unroll
    for (int j = 0; j < VEC; ++j) red[t][ty][tx * VEC + j] = acc[t][j];
  __syncthreads();
  if (!active) return;
  for (int t = ty; t < KH * KW; t += TY) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int l = 0; l < TY; ++l) s += red[t][l][tx * VEC + j];
      part[(static_cast<long long>(blockIdx.x) * KH * KW + t) * g.C + ch + j] = s;
    }
  }
}

// gw[c, t] = sum over the nb partials, in partial order; one thread per
// (t, c), eight interleaved sums for memory-level parallelism
__global__ void dw_grad_reduce_kernel(const float* __restrict__ part, float* __restrict__ gw,
                                      int nb, int taps, int C) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= taps * C) return;
  const int t = i / C, c = i % C;
  const long long stride = static_cast<long long>(taps) * C;
  float s[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = 0.0f;
  int b = 0;
  for (; b + 8 <= nb; b += 8)
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] += part[(b + k) * stride + i];
  for (; b < nb; ++b) s[0] += part[b * stride + i];
  float tot = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) tot += s[k];
  gw[static_cast<long long>(c) * taps + t] = tot;
}

// pass-1 blocks along the pixels: one lane per work item up to MAX_BLOCKS
int partial_blocks(int N, int Ho, int Wo) {
  const long long items = static_cast<long long>(N) * Ho * ((Wo + WSEG - 1) / WSEG);
  const long long want = (items + TY - 1) / TY;
  return static_cast<int>(want < MAX_BLOCKS ? want : MAX_BLOCKS);
}

template <typename T, int VEC, int KH, int KW>
int launch(const void* x, const void* gy, float* part, float* gw, const DwGeo& g,
           cudaStream_t stream) {
  const int nb = partial_blocks(g.N, g.Ho, g.Wo);
  const dim3 grid(static_cast<unsigned>(nb), static_cast<unsigned>((g.C / VEC + TX - 1) / TX));
  dw_grad_partial_kernel<T, VEC, KH, KW><<<grid, dim3(TX, TY), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gy), part, g);
  const int n = KH * KW * g.C;
  dw_grad_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part, gw, nb, KH * KW, g.C);
  return nb;
}

template <typename T, int VEC>
int dispatch(int kh, int kw, const void* x, const void* gy, float* part, float* gw,
             const DwGeo& g, cudaStream_t s) {
#define UNCR_DW_CASE(KH, KW) \
  if (kh == KH && kw == KW) return launch<T, VEC, KH, KW>(x, gy, part, gw, g, s);
  UNCR_DW_CASE(3, 3)
  UNCR_DW_CASE(1, 3)
  UNCR_DW_CASE(3, 1)
#undef UNCR_DW_CASE
  return 0;
}

}  // namespace

// The number of pass-1 blocks (rows of the partial scratch) for these
// sizes: the wrapper allocates part as [uncr_dw_kernel_grad_blocks(...),
// kh*kw, C] fp32.
extern "C" int uncr_dw_kernel_grad_blocks(int N, int Ho, int Wo) {
  return partial_blocks(N, Ho, Wo);
}

// x [N,H,W,C], g [N,Ho,Wo,C] (Ho = H+pt+pb-kh+1, Wo = W+pl+pr-kw+1), both
// contiguous in the dtype given by `dtype`; part fp32 scratch as above; gw
// [C,kh*kw] fp32. kh x kw is one of 3x3, 1x3, 3x1.
extern "C" int uncr_dw_kernel_grad(const void* x, const void* g, float* part, float* gw, int N,
                                   int H, int W, int C, int kh, int kw, int pt, int pb, int pl,
                                   int pr, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DwGeo geo{N, H, W, C, H + pt + pb - kh + 1, W + pl + pr - kw + 1, pt, pl};
  // 8-byte bf16 / 16-byte fp32 channel vectors where C and the pointers
  // allow (4 channels: 4*kh*kw fp32 sums per thread), else one by one
  int nb;
  if (dtype == kBFloat16)
    nb = aligned_to(x, 8) && aligned_to(g, 8) && C % 4 == 0
             ? dispatch<__nv_bfloat16, 4>(kh, kw, x, g, part, gw, geo, s)
             : dispatch<__nv_bfloat16, 1>(kh, kw, x, g, part, gw, geo, s);
  else if (dtype == kFloat32)
    nb = aligned16(x) && aligned16(g) && C % 4 == 0
             ? dispatch<float, 4>(kh, kw, x, g, part, gw, geo, s)
             : dispatch<float, 1>(kh, kw, x, g, part, gw, geo, s);
  else
    nb = 0;
  if (nb == 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
