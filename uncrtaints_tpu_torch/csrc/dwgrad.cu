// Depthwise-convolution weight gradient for all taps (kernel K2).
//
//   gw[c, dy, dx] = sum_{n,h,w} xb[n, h+dy-pt, w+dx-pl, c] * g[n, h, w, c]
//   zeros:   xb = x inside the map, 0 outside (any pads, 3x3 / 1x3 / 3x1)
//   reflect: xb[n,r,s,c] = x[n, m(r), m(s), c], m(-1) = 1, m(L) = L-2
//            (torch's reflect pad of one around a 3x3 kernel, on the
//            unpadded x)
//
// x [N,H,W,C] (the primal conv's input) and g [N,Ho,Wo,C] (its output
// gradient) NHWC in one dtype (bf16 or fp32); gw [C,kh,kw] fp32 (the port's
// depthwise weight layout [C,1,kh,kw]). Products and sums in fp32.
//
// Replaces: uncrtaints_tpu/ops/pallas_dwgrad.py dw_kernel_grad (_mk_kernel),
// and in reflect mode the weight gradient of uncrtaints_tpu/models/layers.py
// _dw_reflect3x3 (one pass over the unpadded x; the 12 ring-correction
// reduces of the TPU form are the mirrored loads here). The TPU kernel DMAs a
// row window of a padded copy of x per grid step and writes one partial per
// step, summed afterwards by XLA; here the pad is an index rule on the copy
// and both passes are kernels.
//
// Bound: device memory. The gradient needs one read of x and of g (805 MB in
// bf16 at [12,256,256,256], 0.240 ms at 3.35 TB/s, without a pad ring)
// against 9 multiply-adds per element of g. What the design does about it
// (dw_grad_tile_kernel, 3x3 with 16-byte channel vectors; the ring and the
// patch walk are described in dwtile.cuh):
// - each x row is read once per item, not three times: a band of 4 rows of g
//   takes its 6 rows of x from a shared-memory ring; the next band's 4 rows
//   of x and of g are copied with cp.async (16 bytes a lane) while this band
//   is summed, 33 KB a block in flight behind the arithmetic;
// - a thread keeps its 9 x 4 fp32 sums in registers over all its items and
//   converts every x and g value once per band (1.5 x 1.5 and 1 times per
//   element), one fmaf per tap;
// - a persistent grid sized to the card (SM count x resident blocks, asked
//   of the device, split over the channel tiles) strides over the items, so
//   the encoder and the decoder shape both end in whole waves; the scratch
//   of partial sums follows the grid (uncr_dw_kernel_grad_blocks);
// - deterministic, no atomics: the block's column lanes are added in lane
//   order in shared memory into one partial [9, C] per block, and a second
//   kernel adds the blocks' partials per (c, tap) in block order. The
//   assignment of items to blocks is fixed, so two runs give the same bits.
//
// Everything else (1x3, 3x1, channel counts or pointers that rule out
// 16-byte vectors) runs dw_grad_direct_kernel: a kh x kw register window
// walking 32 columns of one row of g, 8 lanes a block, 256 blocks a channel
// tile.
#include "dwtile.cuh"

namespace {

// ---------------------------------------------------------------- tiled --

// part [gridDim.x, 9, C]: the block's sums over its items, channel tile
// blockIdx.y
template <typename T>
__global__ void __launch_bounds__(DW_THREADS, DW_MINB)
    dw_grad_tile_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                        float* __restrict__ part, DwGeo g, int nchunk, int nstrip,
                        long long items) {
  using P = DwPatch<T>;
  constexpr int CV = P::CV, PCW = P::PCW;
  constexpr int XRING = DW_XSLOTS * DW_XCOLS * DW_PIX;
  extern __shared__ __align__(16) unsigned char ring[];
  unsigned char* gring = ring + XRING;
  const int tc = threadIdx.x % P::TC, lane = threadIdx.x / P::TC;
  const int c0 = blockIdx.y * P::CB;
  const bool reflect = g.mode == kReflect;
  float acc[9][CV];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int e = 0; e < CV; ++e) acc[t][e] = 0.0f;

  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int strip = static_cast<int>(item % nstrip);
    const long long rest = item / nstrip;
    const int chunk = static_cast<int>(rest % nchunk), n = static_cast<int>(rest / nchunk);
    const int ho0 = chunk * DW_ROWS, wo0 = strip * DW_WT;
    const int nbands = (min(DW_ROWS, g.Ho - ho0) + DW_R - 1) / DW_R;
    const int row0 = ho0 - g.pt, col0 = wo0 - g.pl;

    // band k needs tile rows [k R, k R + R + 2) of x and [k R, k R + R) of g;
    // g outside [Ho, Wo) is zero-filled, so a ragged edge adds nothing
    auto stage = [&](int k) {
      if (k < nbands) {
        dw_stage_rows<T, DW_XCOLS, DW_XSLOTS>(ring, x, reflect, n, g.H, g.W, g.C, row0, col0, c0,
                                              k == 0 ? 0 : k * DW_R + 2, (k + 1) * DW_R + 2);
        dw_stage_rows<T, DW_WT, DW_GSLOTS>(gring, gy, false, n, g.Ho, g.Wo, g.C, ho0, wo0, c0,
                                           k * DW_R, (k + 1) * DW_R);
      }
      cp_async_commit();
    };
#pragma unroll
    for (int k = 0; k < DW_AHEAD; ++k) stage(k);
    for (int b = 0; b < nbands; ++b) {
      stage(b + DW_AHEAD);
      cp_async_wait<DW_AHEAD>();  // all but the bands just started: this band is here
      __syncthreads();

      const unsigned char* xrows[DW_R + 2];
      const unsigned char* grows[DW_R];
#pragma unroll
      for (int j = 0; j < DW_R + 2; ++j)
        xrows[j] = ring + (((b * DW_R + j) % DW_XSLOTS) * DW_XCOLS + lane * PCW) * DW_PIX +
                   tc * CV * sizeof(T);
#pragma unroll
      for (int r = 0; r < DW_R; ++r)
        grows[r] = gring + (((b * DW_R + r) % DW_GSLOTS) * DW_WT + lane * PCW) * DW_PIX +
                   tc * CV * sizeof(T);
      float gv[PCW][DW_R][CV];
#pragma unroll
      for (int ci = 0; ci < PCW + 2; ++ci) {
        float xv[DW_R + 2][CV];
#pragma unroll
        for (int j = 0; j < DW_R + 2; ++j) {
          const RawVec<T, CV> raw =
              *reinterpret_cast<const RawVec<T, CV>*>(xrows[j] + ci * DW_PIX);
#pragma unroll
          for (int e = 0; e < CV; ++e) xv[j][e] = to_f32(raw.v[e]);
        }
        if (ci < PCW) {
#pragma unroll
          for (int r = 0; r < DW_R; ++r) {
            const RawVec<T, CV> raw =
                *reinterpret_cast<const RawVec<T, CV>*>(grows[r] + ci * DW_PIX);
#pragma unroll
            for (int e = 0; e < CV; ++e) gv[ci][r][e] = to_f32(raw.v[e]);
          }
        }
        // x column ci is tap dx of g column ci - dx
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int cg = ci - dx;
          if (cg < 0 || cg >= PCW) continue;
#pragma unroll
          for (int r = 0; r < DW_R; ++r)
#pragma unroll
            for (int dy = 0; dy < 3; ++dy)
#pragma unroll
              for (int e = 0; e < CV; ++e)
                acc[dy * 3 + dx][e] = fmaf(xv[r + dy][e], gv[cg][r][e], acc[dy * 3 + dx][e]);
        }
      }
      __syncthreads();  // the next band's copies overwrite rows read here
    }
  }

  // the block's column lanes, added in lane order (the ring is free now)
  float* red = reinterpret_cast<float*>(ring);  // [LANES][9][CB]
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int e = 0; e < CV; ++e) red[(lane * 9 + t) * P::CB + tc * CV + e] = acc[t][e];
  __syncthreads();
  for (int i = threadIdx.x; i < 9 * P::CB; i += DW_THREADS) {
    const int t = i / P::CB, c = i % P::CB;
    if (c0 + c >= g.C) continue;
    float s = 0.0f;
#pragma unroll
    for (int l = 0; l < P::LANES; ++l) s += red[(l * 9 + t) * P::CB + c];
    part[(static_cast<long long>(blockIdx.x) * 9 + t) * g.C + c0 + c] = s;
  }
}

constexpr size_t GRAD_SMEM =
    static_cast<size_t>(DW_XSLOTS * DW_XCOLS + DW_GSLOTS * DW_WT) * DW_PIX;

// blocks along the items for the tiled pass: the card's resident blocks
// split over the channel tiles
template <typename T>
int tile_blocks(int N, int Ho, int Wo, int C) {
  const int ncb = (C + DwPatch<T>::CB - 1) / DwPatch<T>::CB;
  const long long items = static_cast<long long>(N) * ((Ho + DW_ROWS - 1) / DW_ROWS) *
                          ((Wo + DW_WT - 1) / DW_WT);
  const int fit = dw_resident_blocks(dw_grad_tile_kernel<T>, GRAD_SMEM, items * ncb) / ncb;
  return fit > 0 ? fit : 1;
}

// --------------------------------------------------------------- direct --

constexpr int WSEG = 32;         // g columns per work item
constexpr int TX = 32, TY = 8;   // block: 32 channel vectors x 8 lanes
constexpr int MAX_BLOCKS = 256;  // direct pass-1 blocks along the pixels

// part [gridDim.x, KH*KW, C]: the block's sums over its work items
template <typename T, int VEC, int KH, int KW>
__global__ void __launch_bounds__(TX * TY)
    dw_grad_direct_kernel(const T* __restrict__ x, const T* __restrict__ gy,
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
        win[dy][dx + 1] = dw_load<T, VEC>(x, g, n, ho + dy - g.pt, w0 + dx - g.pl, ch);
    const T* gp = gy + ((static_cast<long long>(n) * g.Ho + ho) * g.Wo + w0) * g.C + ch;
    for (int wo = w0; wo < w1; ++wo, gp += g.C) {
#pragma unroll
      for (int dy = 0; dy < KH; ++dy) {
#pragma unroll
        for (int dx = 0; dx + 1 < KW; ++dx) win[dy][dx] = win[dy][dx + 1];
        win[dy][KW - 1] = dw_load<T, VEC>(x, g, n, ho + dy - g.pt, wo + KW - 1 - g.pl, ch);
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

// direct pass-1 blocks along the pixels: one lane per work item up to
// MAX_BLOCKS
int direct_blocks(int N, int Ho, int Wo) {
  const long long items = static_cast<long long>(N) * Ho * ((Wo + WSEG - 1) / WSEG);
  const long long want = (items + TY - 1) / TY;
  return static_cast<int>(want < MAX_BLOCKS ? want : MAX_BLOCKS);
}

template <typename T, int VEC, int KH, int KW>
void launch_direct(const void* x, const void* gy, float* part, int nb, const DwGeo& g,
                   cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(nb), static_cast<unsigned>((g.C / VEC + TX - 1) / TX));
  dw_grad_direct_kernel<T, VEC, KH, KW><<<grid, dim3(TX, TY), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gy), part, g);
}

// --------------------------------------------------------- second pass --

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

// 3x3 with 16-byte channel vectors goes to the tiles
bool tiled(int kh, int kw, int C, int dtype, bool aligned) {
  return kh == 3 && kw == 3 && aligned && C % (dtype == kBFloat16 ? 8 : 4) == 0;
}

int pass1_blocks(int N, int Ho, int Wo, int C, int kh, int kw, int dtype, bool aligned) {
  if (!tiled(kh, kw, C, dtype, aligned)) return direct_blocks(N, Ho, Wo);
  return dtype == kBFloat16 ? tile_blocks<__nv_bfloat16>(N, Ho, Wo, C)
                            : tile_blocks<float>(N, Ho, Wo, C);
}

template <typename T>
void launch_tiles(const void* x, const void* gy, float* part, int nb, const DwGeo& g,
                  cudaStream_t stream) {
  const int nchunk = (g.Ho + DW_ROWS - 1) / DW_ROWS, nstrip = (g.Wo + DW_WT - 1) / DW_WT;
  const int ncb = (g.C + DwPatch<T>::CB - 1) / DwPatch<T>::CB;
  const long long items = static_cast<long long>(g.N) * nchunk * nstrip;
  dw_grad_tile_kernel<T><<<dim3(nb, ncb), DW_THREADS, GRAD_SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gy), part, g, nchunk, nstrip, items);
}

// the direct kernel with 8-byte bf16 / 16-byte fp32 vectors of 4 channels
// where C and the pointers allow, else one by one
template <typename T>
bool launch_direct_any(int kh, int kw, bool vec4, const void* x, const void* gy, float* part,
                       int nb, const DwGeo& g, cudaStream_t s) {
#define UNCR_DW_CASE(KH, KW)                                               \
  if (kh == KH && kw == KW) {                                              \
    vec4 ? launch_direct<T, 4, KH, KW>(x, gy, part, nb, g, s)              \
         : launch_direct<T, 1, KH, KW>(x, gy, part, nb, g, s);             \
    return true;                                                           \
  }
  UNCR_DW_CASE(3, 3)
  UNCR_DW_CASE(1, 3)
  UNCR_DW_CASE(3, 1)
#undef UNCR_DW_CASE
  return false;
}

}  // namespace

// The number of pass-1 blocks along the items (rows of the partial scratch)
// for these sizes: the wrapper allocates part as
// [uncr_dw_kernel_grad_blocks(...), kh*kw, C] fp32. `aligned` says whether x
// and g are 16-byte aligned.
extern "C" int uncr_dw_kernel_grad_blocks(int N, int Ho, int Wo, int C, int kh, int kw, int dtype,
                                          int aligned) {
  return pass1_blocks(N, Ho, Wo, C, kh, kw, dtype, aligned != 0);
}

// x [N,H,W,C], g [N,Ho,Wo,C] (Ho = H+pt+pb-kh+1, Wo = W+pl+pr-kw+1), both
// contiguous in the dtype given by `dtype`; part fp32 scratch as above; gw
// [C,kh*kw] fp32. kh x kw is one of 3x3, 1x3, 3x1; mode is kZeros or
// kReflect (3x3, pads of 1, H, W >= 2), else cudaErrorInvalidValue.
extern "C" int uncr_dw_kernel_grad(const void* x, const void* g, float* part, float* gw, int N,
                                   int H, int W, int C, int kh, int kw, int pt, int pb, int pl,
                                   int pr, int mode, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode != kZeros && mode != kReflect) return static_cast<int>(cudaErrorInvalidValue);
  if (mode == kReflect &&
      !(kh == 3 && kw == 3 && pt == 1 && pb == 1 && pl == 1 && pr == 1 && H >= 2 && W >= 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != kBFloat16 && dtype != kFloat32) return static_cast<int>(cudaErrorInvalidValue);
  const DwGeo geo{N, H, W, C, H + pt + pb - kh + 1, W + pl + pr - kw + 1, pt, pl, mode};
  const bool aligned = aligned16(x) && aligned16(g);
  const int nb = pass1_blocks(N, geo.Ho, geo.Wo, C, kh, kw, dtype, aligned);
  if (tiled(kh, kw, C, dtype, aligned)) {
    if (dtype == kBFloat16)
      launch_tiles<__nv_bfloat16>(x, g, part, nb, geo, s);
    else
      launch_tiles<float>(x, g, part, nb, geo, s);
  } else {
    const bool vec4 = C % 4 == 0 && aligned;
    const bool ok = dtype == kBFloat16
                        ? launch_direct_any<__nv_bfloat16>(kh, kw, vec4, x, g, part, nb, geo, s)
                        : launch_direct_any<float>(kh, kw, vec4, x, g, part, nb, geo, s);
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n = kh * kw * C;
  dw_grad_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(part, gw, nb, kh * kw, C);
  return static_cast<int>(cudaGetLastError());
}
