// Depthwise stride-1 correlation (kernel K5) with three border rules.
//
//   zeros:    out[n,ho,wo,c] = sum_{dy,dx} xz[n, ho+dy-pt, wo+dx-pl, c] * w[c,dy,dx]
//             xz = x inside the map, 0 outside (any pads, 3x3 / 1x3 / 3x1)
//   reflect:  out[n,h,w,c]   = sum_{dy,dx} x[n, m(h+dy-1), m(w+dx-1), c] * w[c,dy,dx]
//             m(-1) = 1, m(L) = L-2: torch's reflect pad of one, 3x3 only
//   reflect adjoint (the input gradient of `reflect`, its pad's fold inside):
//             out[n,r,s,c]   = sum g[n,h,w,c] * w[c,dy,dx] over all (h,dy) with
//             m(h+dy-1) = r and all (w,dx) with m(w+dx-1) = s
//
// x (or g) [N,H,W,C] and out [N,Ho,Wo,C] NHWC in one dtype (bf16 or fp32), w
// the port's depthwise weight [C,1,kh,kw] in the same dtype. Sums in fp32,
// rounded once to the output dtype.
//
// Replaces: uncrtaints_tpu/ops/pallas_dwconv.py dw_stencil (_mk_kernel), and
// for the two reflect rules the fused VJP of uncrtaints_tpu/models/layers.py
// _dw_reflect3x3 (no padded copy of x, the pad's adjoint folded into the
// input gradient). The TPU kernel DMAs a row-tile window of a padded copy
// into VMEM and shifts it there; nothing of that is carried over.
//
// Bound: device memory. One input and one output element per 9 multiply-adds
// (805 MB at [12,256,256,256] bf16, 0.240 ms at 3.35 TB/s, against 3.6 GFLOP,
// 0.054 ms of the fp32 rate). What the design does about it (dw_tile_kernel,
// 3x3 with 16-byte channel vectors; the ring and the patch walk are described
// in dwtile.cuh):
// - each input row is read once per item: a band of 4 output rows takes its 6
//   input rows from a shared-memory ring, and the next band's 4 new rows are
//   copied with cp.async (16 bytes a lane) while this band is summed, so 17 KB
//   a block are in flight behind the arithmetic;
// - few instructions per output: the nine weights of a thread's 4 channels
//   sit in registers, every input is converted to fp32 once per 2.25 uses
//   and each tap is one fused multiply-add (fmaf). The sum runs dx-major,
//   dy-minor with one rounding per tap, so against the plain shift-add
//   version (dy-major, product and sum rounded apart) the result differs in
//   the last fp32 bits: within one bf16 ulp of the largest output after the
//   final rounding, 1e-6 of it in fp32;
// - the border without a padded copy: zero fill or mirrored source pixel on
//   the copy into the ring; the adjoint is the zero-pad stencil on g with the
//   flipped kernel, and the pixels the pad's ring folds onto (rows and
//   columns 1 and H-2 / W-2, 4/H of them) are then summed in full, folded
//   terms included, by dw_adjoint_frame_kernel and written again, so the hot
//   loop has no border case. It writes [N,H,W,C] directly;
// - a persistent grid of as many blocks as the card holds (SM count x
//   resident blocks, asked of the device) strides over the items.
// Stores are 8 bytes a lane in bf16: 4 channels a thread keep the weights
// and sums in registers, and 16 lanes write one pixel's 128 bytes together
// (8 channels a thread, 16-byte stores, measured 4% slower on an H100). The
// tile sizes are among the fastest of those tools/tune_dw_h100.py timed.
//
// Everything else (1x3, 3x1, channel counts or pointers that rule out
// 16-byte vectors) runs dw_direct_kernel: one output row and 32 columns a
// thread with a kh x kw register window, the taps in the plain version's
// order with __fmul_rn / __fadd_rn, so bit-equal to it in zeros and reflect.
#include "dwtile.cuh"

namespace {

// ---------------------------------------------------------------- tiled --

template <typename T>
__global__ void __launch_bounds__(DW_THREADS, DW_MINB)
    dw_tile_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, DwGeo g,
                   int nchunk, int nstrip, int ncb, long long items) {
  using P = DwPatch<T>;
  constexpr int CV = P::CV, PCW = P::PCW;
  extern __shared__ __align__(16) unsigned char ring[];
  const int tc = threadIdx.x % P::TC, lane = threadIdx.x / P::TC;
  const bool reflect = g.mode == kReflect, adjoint = g.mode == kReflectAdjoint;

  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    // channel tiles fastest: neighbouring blocks read neighbouring bytes
    const int cb = static_cast<int>(item % ncb);
    long long rest = item / ncb;
    const int strip = static_cast<int>(rest % nstrip);
    rest /= nstrip;
    const int chunk = static_cast<int>(rest % nchunk), n = static_cast<int>(rest / nchunk);
    const int c0 = cb * P::CB, ch = c0 + tc * CV;
    const int ho0 = chunk * DW_ROWS, wo0 = strip * DW_WT;
    const int nbands = (min(DW_ROWS, g.Ho - ho0) + DW_R - 1) / DW_R;
    const int row0 = ho0 - g.pt, col0 = wo0 - g.pl;

    float wr[3][3][CV];  // the adjoint correlates with the flipped kernel
#pragma unroll
    for (int t = 0; t < 9; ++t)
#pragma unroll
      for (int e = 0; e < CV; ++e)
        wr[t / 3][t % 3][e] =
            ch + e < g.C
                ? to_f32(w[static_cast<long long>(ch + e) * 9 + (adjoint ? 8 - t : t)])
                : 0.0f;

    // band k needs tile rows [k R, k R + R + 2); its new rows are the last R
    auto stage = [&](int k) {
      if (k < nbands)
        dw_stage_rows<T, DW_XCOLS, DW_XSLOTS>(ring, x, reflect, n, g.H, g.W, g.C, row0, col0, c0,
                                              k == 0 ? 0 : k * DW_R + 2, (k + 1) * DW_R + 2);
      cp_async_commit();
    };
#pragma unroll
    for (int k = 0; k < DW_AHEAD; ++k) stage(k);
    for (int b = 0; b < nbands; ++b) {
      stage(b + DW_AHEAD);
      cp_async_wait<DW_AHEAD>();  // all but the bands just started: this band is here
      __syncthreads();

      const unsigned char* rows[DW_R + 2];
#pragma unroll
      for (int j = 0; j < DW_R + 2; ++j)
        rows[j] = ring + (((b * DW_R + j) % DW_XSLOTS) * DW_XCOLS + lane * PCW) * DW_PIX +
                  tc * CV * sizeof(T);
      float acc[PCW][DW_R][CV];
#pragma unroll
      for (int co = 0; co < PCW; ++co)
#pragma unroll
        for (int r = 0; r < DW_R; ++r)
#pragma unroll
          for (int e = 0; e < CV; ++e) acc[co][r][e] = 0.0f;
#pragma unroll
      for (int ci = 0; ci < PCW + 2; ++ci) {
        float xv[DW_R + 2][CV];
#pragma unroll
        for (int j = 0; j < DW_R + 2; ++j) {
          const RawVec<T, CV> raw =
              *reinterpret_cast<const RawVec<T, CV>*>(rows[j] + ci * DW_PIX);
#pragma unroll
          for (int e = 0; e < CV; ++e) xv[j][e] = to_f32(raw.v[e]);
        }
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int co = ci - dx;
          if (co < 0 || co >= PCW) continue;
#pragma unroll
          for (int r = 0; r < DW_R; ++r)
#pragma unroll
            for (int dy = 0; dy < 3; ++dy)
#pragma unroll
              for (int e = 0; e < CV; ++e)
                acc[co][r][e] = fmaf(xv[r + dy][e], wr[dy][dx][e], acc[co][r][e]);
        }
        if (ci < 2) continue;
        const int co = ci - 2, wo = wo0 + lane * PCW + co;  // this column has its nine taps
        if (wo >= g.Wo || ch >= g.C) continue;
#pragma unroll
        for (int r = 0; r < DW_R; ++r) {
          const int ho = ho0 + b * DW_R + r;
          if (ho >= g.Ho) continue;
          RawVec<T, CV> o;
#pragma unroll
          for (int e = 0; e < CV; ++e) o.v[e] = from_f32<T>(acc[co][r][e]);
          *reinterpret_cast<RawVec<T, CV>*>(
              out + ((static_cast<long long>(n) * g.Ho + ho) * g.Wo + wo) * g.C + ch) = o;
        }
      }
      __syncthreads();  // the next band's copies overwrite rows read here
    }
  }
}

template <typename T>
void launch_tiles(const void* x, const void* w, void* out, const DwGeo& g, cudaStream_t stream) {
  const int nchunk = (g.Ho + DW_ROWS - 1) / DW_ROWS, nstrip = (g.Wo + DW_WT - 1) / DW_WT;
  const int ncb = (g.C + DwPatch<T>::CB - 1) / DwPatch<T>::CB;
  const long long items = static_cast<long long>(g.N) * nchunk * nstrip * ncb;
  constexpr size_t smem = static_cast<size_t>(DW_XSLOTS) * DW_XCOLS * DW_PIX;
  const int blocks = dw_resident_blocks(dw_tile_kernel<T>, smem, items);
  dw_tile_kernel<T><<<blocks, DW_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), g, nchunk, nstrip,
      ncb, items);
}

// --------------------------------------------------------------- direct --

constexpr int WSEG = 32;        // output columns per thread
constexpr int TX = 32, TY = 8;  // block: 32 channel vectors x 8 segment lanes

template <typename T, int VEC, int KH, int KW>
__global__ void __launch_bounds__(TX * TY)
    dw_direct_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                     DwGeo g) {
  __shared__ float ws[KH * KW][TX * VEC];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c0 = blockIdx.y * TX * VEC;
  const bool adjoint = g.mode == kReflectAdjoint;  // the flipped kernel
  for (int i = ty * TX + tx; i < KH * KW * TX * VEC; i += TX * TY) {
    const int tap = i / (TX * VEC), cl = i % (TX * VEC);
    const int src_tap = adjoint ? KH * KW - 1 - tap : tap;
    ws[tap][cl] =
        c0 + cl < g.C ? to_f32(w[static_cast<long long>(c0 + cl) * KH * KW + src_tap]) : 0.0f;
  }
  __syncthreads();
  const int ch = c0 + tx * VEC;
  if (ch >= g.C) return;

  const int nseg = (g.Wo + WSEG - 1) / WSEG;
  const long long items = static_cast<long long>(g.N) * g.Ho * nseg;
  for (long long item = static_cast<long long>(blockIdx.x) * TY + ty; item < items;
       item += static_cast<long long>(gridDim.x) * TY) {
    const int seg = static_cast<int>(item % nseg);
    const long long rest = item / nseg;
    const int ho = static_cast<int>(rest % g.Ho), n = static_cast<int>(rest / g.Ho);
    const int w0 = seg * WSEG, w1 = min(w0 + WSEG, g.Wo);
    RawVec<T, VEC> win[KH][KW];
    // preload window columns 1..KW-1 for the first output (column w0 - pl)
#pragma unroll
    for (int dy = 0; dy < KH; ++dy)
#pragma unroll
      for (int dx = 0; dx + 1 < KW; ++dx)
        win[dy][dx + 1] = dw_load<T, VEC>(x, g, n, ho + dy - g.pt, w0 + dx - g.pl, ch);
    T* o = out + ((static_cast<long long>(n) * g.Ho + ho) * g.Wo + w0) * g.C + ch;
    for (int wo = w0; wo < w1; ++wo, o += g.C) {
#pragma unroll
      for (int dy = 0; dy < KH; ++dy) {
#pragma unroll
        for (int dx = 0; dx + 1 < KW; ++dx) win[dy][dx] = win[dy][dx + 1];
        win[dy][KW - 1] = dw_load<T, VEC>(x, g, n, ho + dy - g.pt, wo + KW - 1 - g.pl, ch);
      }
      float acc[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
#pragma unroll
      for (int dy = 0; dy < KH; ++dy)
#pragma unroll
        for (int dx = 0; dx < KW; ++dx)
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            acc[j] = __fadd_rn(acc[j], __fmul_rn(to_f32(win[dy][dx].v[j]),
                                                 ws[dy * KW + dx][tx * VEC + j]));
      store_from_f32<T, VEC>(o, acc);
    }
  }
}

template <typename T, int VEC, int KH, int KW>
void launch_direct(const void* x, const void* w, void* out, const DwGeo& g,
                   cudaStream_t stream) {
  const int nseg = (g.Wo + WSEG - 1) / WSEG;
  const long long lanes = static_cast<long long>(g.N) * g.Ho * nseg;
  const long long want = (lanes + TY - 1) / TY;
  const dim3 grid(static_cast<unsigned>(want < 65535 ? want : 65535),
                  static_cast<unsigned>((g.C / VEC + TX - 1) / TX));
  dw_direct_kernel<T, VEC, KH, KW><<<grid, dim3(TX, TY), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), g);
}

// ---------------------------------------- the adjoint's folded frame --

// The folded reflect adjoint at the pixels where the pad's ring lands: rows
// 1 and H-2 and columns 1 and W-2. With m the reflect index, gx[r,s] sums
// g[h,w] * k[dy,dx] over all (h, dy) with m(h+dy-1) = r and all (w, dx) with
// m(w+dx-1) = s. Per axis those are the pairs h = r+1-dy inside the map (the
// zero-pad stencil with the flipped kernel has exactly them) and the folded
// pairs (0, 0) for r = 1 and (H-1, 2) for r = H-2. The stencil kernels write
// every pixel from the first kind alone; this kernel, launched after them,
// sums all pairs in fp32 for the 2W + 2H frame pixels of each map (4/H of
// the pixels) and writes them again, rounded once. A pixel where a frame row
// crosses a frame column is written twice with the same value. One thread
// per (pixel, VEC channels). g [N,H,W,C], w [C,9] the primal kernel.
template <typename T, int VEC>
__global__ void dw_adjoint_frame_kernel(const T* __restrict__ g, const T* __restrict__ w,
                                        T* __restrict__ out, int N, int H, int W, int C) {
  const int cvecs = C / VEC, frame = 2 * W + 2 * H;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(N) * frame * cvecs) return;
  const int ch = static_cast<int>(i % cvecs) * VEC;
  const int f = static_cast<int>(i / cvecs % frame), n = static_cast<int>(i / cvecs / frame);
  int r, s;
  if (f < W) r = 1, s = f;
  else if (f < 2 * W) r = H - 2, s = f - W;
  else if (f < 2 * W + H) r = f - 2 * W, s = 1;
  else r = f - 2 * W - H, s = W - 2;

  int rh[5], rd[5], cw[5], cd[5], nr = 0, nc = 0;
  for (int d = 0; d < 3; ++d) {
    if (r + 1 - d >= 0 && r + 1 - d < H) rh[nr] = r + 1 - d, rd[nr++] = d;
    if (s + 1 - d >= 0 && s + 1 - d < W) cw[nc] = s + 1 - d, cd[nc++] = d;
  }
  if (r == 1) rh[nr] = 0, rd[nr++] = 0;
  if (r == H - 2) rh[nr] = H - 1, rd[nr++] = 2;
  if (s == 1) cw[nc] = 0, cd[nc++] = 0;
  if (s == W - 2) cw[nc] = W - 1, cd[nc++] = 2;
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
  for (int a = 0; a < nr; ++a)
    for (int b = 0; b < nc; ++b) {
      const RawVec<T, VEC> gv =
          load_raw<T, VEC>(g + ((static_cast<long long>(n) * H + rh[a]) * W + cw[b]) * C + ch);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[e] = fmaf(to_f32(gv.v[e]),
                      to_f32(w[static_cast<long long>(ch + e) * 9 + rd[a] * 3 + cd[b]]), acc[e]);
    }
  RawVec<T, VEC> o;
#pragma unroll
  for (int e = 0; e < VEC; ++e) o.v[e] = from_f32<T>(acc[e]);
  *reinterpret_cast<RawVec<T, VEC>*>(
      out + ((static_cast<long long>(n) * H + r) * W + s) * C + ch) = o;
}

template <typename T, int VEC>
void launch_frame(const void* g, const void* w, void* out, const DwGeo& geo, cudaStream_t s) {
  const long long threads =
      static_cast<long long>(geo.N) * (2 * geo.W + 2 * geo.H) * (geo.C / VEC);
  dw_adjoint_frame_kernel<T, VEC><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(w), static_cast<T*>(out), geo.N, geo.H,
      geo.W, geo.C);
}

// 3x3 with 16-byte vectors goes to the tiles, the rest to the direct kernel
template <typename T, int VEC>
bool dispatch(int kh, int kw, bool vec_ok, const void* x, const void* w, void* out,
              const DwGeo& g, cudaStream_t s) {
  if (kh == 3 && kw == 3) {
    if (vec_ok)
      launch_tiles<T>(x, w, out, g, s);
    else
      launch_direct<T, 1, 3, 3>(x, w, out, g, s);
    if (g.mode == kReflectAdjoint)
      vec_ok ? launch_frame<T, VEC>(x, w, out, g, s) : launch_frame<T, 1>(x, w, out, g, s);
    return true;
  }
  if (g.mode != kZeros) return false;
  if (kh == 1 && kw == 3) {
    vec_ok ? launch_direct<T, VEC, 1, 3>(x, w, out, g, s)
           : launch_direct<T, 1, 1, 3>(x, w, out, g, s);
    return true;
  }
  if (kh == 3 && kw == 1) {
    vec_ok ? launch_direct<T, VEC, 3, 1>(x, w, out, g, s)
           : launch_direct<T, 1, 3, 1>(x, w, out, g, s);
    return true;
  }
  return false;
}

}  // namespace

// x [N,H,W,C], w [C,kh*kw], out [N,Ho,Wo,C] with Ho = H+pt+pb-kh+1 and
// Wo = W+pl+pr-kw+1; all contiguous in the dtype given by `dtype`. kh x kw
// is one of 3x3, 1x3, 3x1. mode is a DwMode: kReflect and kReflectAdjoint
// need a 3x3 kernel, pads of 1 and H, W >= 2 (else cudaErrorInvalidValue);
// in kReflectAdjoint x is the output gradient and w the primal kernel.
extern "C" int uncr_dw_stencil(const void* x, const void* w, void* out, int N, int H, int W,
                               int C, int kh, int kw, int pt, int pb, int pl, int pr, int mode,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode != kZeros && mode != kReflect && mode != kReflectAdjoint)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode != kZeros &&
      !(kh == 3 && kw == 3 && pt == 1 && pb == 1 && pl == 1 && pr == 1 && H >= 2 && W >= 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const DwGeo g{N, H, W, C, H + pt + pb - kh + 1, W + pl + pr - kw + 1, pt, pl, mode};
  // 16-byte channel vectors where C and the pointers allow, else one by one
  const bool aligned = aligned16(x) && aligned16(out);
  bool ok;
  if (dtype == kBFloat16)
    ok = dispatch<__nv_bfloat16, 8>(kh, kw, aligned && C % 8 == 0, x, w, out, g, s);
  else if (dtype == kFloat32)
    ok = dispatch<float, 4>(kh, kw, aligned && C % 4 == 0, x, w, out, g, s);
  else
    ok = false;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
