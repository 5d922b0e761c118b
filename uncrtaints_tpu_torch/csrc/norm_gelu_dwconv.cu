// Fused normalise -> exact GELU -> depthwise 3x3 with reflect borders
// (kernel K4), with optional per-group statistics of the output and an
// optional per-channel pooled sum of a second activation of it.
//
//   h[n,r,s,c]   = gelu(((x[n,r,s,c] - mean[n,g(c)]) * coef[n,g(c)]) * scale[c] + bias[c])
//   out[n,y,x,c] = sum_{dx} sum_{dy} h[n, refl(y+dy-1), refl(x+dx-1), c] * w[dy,dx,c]
//   refl(-1) = 1, refl(H) = H-2 (columns alike);  out is cast to x's dtype
//   (halo mode: x is a band of a taller scene and rows -1, H are the raw
//   rows of its neighbours where given, normalised and activated alike)
//   sum/sumsq[n,g] over the frame's pixels and group g's channels of the
//   rounded output q                                       (when psum is given)
//   pool[n,c]    = sum over the frame's pixels of gelu(q * pscale[c] + pbias[c])
//                                                          (when pscale is given)
//
// x and out [N,H,W,C] NHWC in one dtype (bf16 or fp32); everything else fp32.
// The taps are summed in fp32 in the order dx-major, dy-minor, one fused
// multiply-add each (fmaf): against the plain version, which rounds each
// product and each sum apart, the result differs in the last fp32 bits, so
// after the cast by at most one bf16 ulp of the largest output (1e-5 of it in
// fp32). Built with -DUNCR_NGD_FMA=0 a tap is __fmul_rn / __fadd_rn and the
// output bit-equal to the plain version; that costs 8-12% (0.334 against
// 0.298 ms with the pooled sum, 0.236 against 0.219 ms without, on an H100 at
// 700 W: tools/tune_mbconv_h100.py times both).
//
// Replaces: uncrtaints_tpu/ops/pallas_mbconv.py norm_gelu_dwconv3x3 (kernel
// B, _mk_kernel_b), and with the pooled sum the reduction that
// uncrtaints_tpu/models/blocks.py leaves to XLA between the depthwise conv
// and the second GEMM (the SE mean of gelu(bn2(h2))). The TPU version gathers
// row slabs with a halo and a padded column axis on the XLA side, pads the
// weights to 16 rows, rolls sublanes per dx and sums the groups by a 0/1
// selection matmul: all Mosaic workarounds, none carried over.
//
// Bound: by the roofline, bytes. The map is read and written once (268 MB at
// [4,256,256,256] bf16: 0.080 ms at 3.35 TB/s), and the arithmetic the
// function needs (two exact GELUs of 20 FLOP, two affines and nine
// multiply-adds an output) is 0.065 ms at the fp32 peak. On chip the exact
// GELU holds the kernel back: compiled it is 32 instructions with its selects
// and compares (tools/tune_mbconv_h100.py lists them from the SASS), and the
// rate at which the SMs dispatch them is the limit. The design therefore
// activates each input once. The earlier kernel walked columns in registers
// and activated every input
// (2+2)/2 x 66/64 = 2.06 times per output; this one activates (32+2)/32 x
// (32+2)/32 = 1.13 times (the halo of an item), and with the pooled sum
// spends one more GELU per output, only when asked:
// - a persistent grid (SM count x resident blocks, asked of the device) works
//   through items of 32 rows x 32 columns x 128 bytes of channels (64 in
//   bf16, 32 in fp32), channel tiles fastest;
// - raw input rows reach shared memory ahead of the arithmetic: cp.async, 16
//   bytes a lane, straight from device memory, the mirrored source pixel for
//   the reflect border (dw_stage_rows of dwtile.cuh), one band of 4 rows
//   ahead of the band being worked on;
// - when a band's rows have landed the block applies prologue + GELU once per
//   staged element and keeps the result in fp32 in a second ring (the plain
//   version keeps h in fp32; a bf16 ring would be another function). A
//   thread always meets the same 8 channels there, so their four prologue
//   terms sit in registers for the pass, and the two 16-byte stores of a
//   chunk are ordered so that eight lanes hit 32 different banks (with the
//   terms fetched per element from shared memory, eight lanes on one bank,
//   this pass alone took 0.31 ms);
// - the stencil reads activated values only: a thread sums 4 rows x 2
//   columns x 4 channels from 6 x 4 vector loads, the nine weights of its
//   channels in registers, and stores 8 bytes a lane in bf16 (16 lanes write
//   one pixel's 128 bytes together);
// - shared memory a block, bf16: raw ring 6 x 34 x 128 B = 26 KB, activated
//   ring 6 x 34 x 64 x 4 B = 51 KB, the item's prologue terms 1 KB, the
//   reduction scratch 12 KB: 89.5 KB, so an SM holds two blocks of 256
//   threads (16 warps), one activating while the other sums.
//
// Statistics and the pooled sum need no atomics: a thread sums its own
// rounded outputs over the item, the block adds its column lanes in a fixed
// order in shared memory into one partial row per item ([N * items per frame,
// C], every entry written once), and channel_sum_kernel, then for the
// statistics group_stats_kernel (common.cuh), reduce the rows in a fixed
// order. Two runs give the same bits.
#include "dwtile.cuh"

// the one build switch: 0 makes a tap a product and a sum rounded apart
#ifndef UNCR_NGD_FMA
#define UNCR_NGD_FMA 1
#endif

namespace {

constexpr int THREADS = 256;               // threads of a block
constexpr int R = 4;                       // output rows per band
constexpr int WT = 32;                     // output columns per item
constexpr int ROWS = 32;                   // output rows per item (8 bands)
constexpr int AHEAD = 1;                   // bands copied ahead of the one worked on
constexpr int MIN_BLOCKS = 2;              // resident blocks the register count must allow
constexpr int XCOLS = WT + 2;              // tile columns with the halo
constexpr int RAW_SLOTS = AHEAD * R + 2;   // raw rows copied and not yet activated
constexpr int ACT_SLOTS = R + 2;           // activated rows of one band
static_assert(ROWS % R == 0, "an item is a whole number of bands");
static_assert(AHEAD >= 1 && THREADS % DW_CPP == 0, "staging layout");

// how a block's threads split a band's stencil: TC threads across the tile's
// channels, LANES across its columns, PCW columns per thread
template <typename T>
struct Patch {
  static constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  static constexpr int CB = DW_CPP * EPC;     // channels per tile
  static constexpr int CV = 4;                 // channels a thread sums
  static constexpr int TC = CB / CV;
  static constexpr int LANES = THREADS / TC;
  static constexpr int PCW = WT / LANES;
  static_assert(THREADS % TC == 0 && WT % LANES == 0 && PCW >= 1, "patch layout");
  static constexpr size_t RAW_BYTES = static_cast<size_t>(RAW_SLOTS) * XCOLS * DW_PIX;
  static constexpr size_t ACT_BYTES = static_cast<size_t>(ACT_SLOTS) * XCOLS * CB * sizeof(float);
  static constexpr size_t PAR_BYTES = static_cast<size_t>(CB) * sizeof(float4);
  static constexpr size_t RED_BYTES = static_cast<size_t>(3) * LANES * CB * sizeof(float);
  static constexpr size_t SMEM = RAW_BYTES + ACT_BYTES + PAR_BYTES + RED_BYTES;
};

struct Args {
  const void* x;
  const float* mean;
  const float* coef;
  const float* scale;
  const float* bias;
  const float* w;  // [9, C]: tap dy*3+dx
  void* out;
  float* psum;  // [N * nchunk * nstrip, C] per-item partials (STATS)
  float* psq;
  const float* pscale;  // [C] (POOL)
  const float* pbias;
  float* ppool;  // [N * nchunk * nstrip, C] per-item partials (POOL)
  int H, W, C, groups_in;
  int nchunk, nstrip, ncb;  // items per frame: row chunks, column strips, channel tiles
  long long items;
  const void* top;  // halo mode: raw rows above / below the band [N,W,C], or null
  const void* bot;
};

__device__ __forceinline__ float tap(float h, float w, float acc) {
#if UNCR_NGD_FMA
  return fmaf(h, w, acc);
#else
  return __fadd_rn(acc, __fmul_rn(h, w));
#endif
}

template <typename T, bool STATS, bool POOL>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) ngd_tile_kernel(Args a) {
  using P = Patch<T>;
  constexpr int EPC = P::EPC, CB = P::CB, CV = P::CV, PCW = P::PCW, LANES = P::LANES;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* raw = smem;
  float* act = reinterpret_cast<float*>(smem + P::RAW_BYTES);
  float* par = reinterpret_cast<float*>(smem + P::RAW_BYTES + P::ACT_BYTES);  // [4][CB]
  float* red = reinterpret_cast<float*>(smem + P::RAW_BYTES + P::ACT_BYTES + P::PAR_BYTES);
  const int tid = threadIdx.x;
  const int tc = tid % P::TC, lane = tid / P::TC;
  const int cq = tid % DW_CPP;  // the 16-byte chunk of a pixel this thread activates
  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
  const int cg_in = a.C / a.groups_in;

  for (long long item = blockIdx.x; item < a.items; item += gridDim.x) {
    // channel tiles fastest: neighbouring blocks read neighbouring bytes
    const int cb = static_cast<int>(item % a.ncb);
    long long rest = item / a.ncb;
    const int strip = static_cast<int>(rest % a.nstrip);
    rest /= a.nstrip;
    const int chunk = static_cast<int>(rest % a.nchunk), n = static_cast<int>(rest / a.nchunk);
    const int c0 = cb * CB, ch = c0 + tc * CV;
    const int ho0 = chunk * ROWS, wo0 = strip * WT;
    const int nbands = (min(ROWS, a.H - ho0) + R - 1) / R;

    // the four prologue terms of the tile's channels (read by the
    // activation pass after the next barrier; the pass of the item before
    // ended behind a barrier every thread has passed)
    for (int c = tid; c < CB; c += THREADS) {
      const bool ok = c0 + c < a.C;
      const int g = ok ? (c0 + c) / cg_in : 0;
      par[0 * CB + c] = ok ? a.mean[n * a.groups_in + g] : 0.0f;
      par[1 * CB + c] = ok ? a.coef[n * a.groups_in + g] : 0.0f;
      par[2 * CB + c] = ok ? a.scale[c0 + c] : 0.0f;
      par[3 * CB + c] = ok ? a.bias[c0 + c] : 0.0f;
    }
    float wr[3][3][CV], psc[CV], pbi[CV], s_acc[CV], q_acc[CV], p_acc[CV];
#pragma unroll
    for (int e = 0; e < CV; ++e) {
      const bool ok = ch + e < a.C;
#pragma unroll
      for (int t = 0; t < 9; ++t) wr[t / 3][t % 3][e] = ok ? a.w[t * a.C + ch + e] : 0.0f;
      psc[e] = POOL && ok ? a.pscale[ch + e] : 0.0f;
      pbi[e] = POOL && ok ? a.pbias[ch + e] : 0.0f;
      s_acc[e] = q_acc[e] = p_acc[e] = 0.0f;
    }

    // band k works on tile rows [k R, k R + R + 2); its new rows are the last R
    auto stage = [&](int k) {
      if (k < nbands)
        dw_stage_rows<T, XCOLS, RAW_SLOTS, THREADS>(raw, x, true, n, a.H, a.W, a.C, ho0 - 1,
                                                    wo0 - 1, c0, k == 0 ? 0 : k * R + 2,
                                                    (k + 1) * R + 2, a.top, a.bot);
      cp_async_commit();
    };
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) stage(k);

    for (int b = 0; b < nbands; ++b) {
      cp_async_wait<AHEAD - 1>();  // this band's rows are here
      __syncthreads();             // ... for every thread; the band before is summed

      // prologue + GELU, once per staged element: raw ring -> fp32 ring
      const int t0 = b == 0 ? 0 : b * R + 2, t1 = (b + 1) * R + 2;
      constexpr int PER_ROW = XCOLS * DW_CPP;
      // (a thread's chunks all hold the same EPC channels: THREADS and the
      // chunks of a row are multiples of DW_CPP; their terms go to registers
      // for the length of the pass)
      float4 term4[4][EPC / 4];  // mean, coef, scale, bias of the thread's channels
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int e = 0; e < EPC / 4; ++e)
          term4[k][e] = *reinterpret_cast<const float4*>(par + k * CB + cq * EPC + 4 * e);
      const float(*term)[EPC] = reinterpret_cast<const float(*)[EPC]>(term4);
      for (int i = tid; i < (t1 - t0) * PER_ROW; i += THREADS) {
        const int t = t0 + i / PER_ROW, p = (i % PER_ROW) / DW_CPP;
        const RawVec<T, EPC> v = *reinterpret_cast<const RawVec<T, EPC>*>(
            raw + ((t % RAW_SLOTS) * XCOLS + p) * DW_PIX + cq * 16);
        float4 h[EPC / 4];
#pragma unroll
        for (int e = 0; e < EPC; ++e)
          reinterpret_cast<float*>(h)[e] = gelu_exact(__fadd_rn(
              __fmul_rn(__fmul_rn(__fsub_rn(to_f32(v.v[e]), term[0][e]), term[1][e]), term[2][e]),
              term[3][e]));
        float4* dst =
            reinterpret_cast<float4*>(act + ((t % ACT_SLOTS) * XCOLS + p) * CB + cq * EPC);
        if (EPC == 8) {
          // two 16-byte stores 32 bytes apart: lanes 4..7 of each eight write
          // their upper half first, so the eight hit 32 different banks
          const int up = (tid >> 2) & 1;
          dst[up] = up ? h[EPC / 4 - 1] : h[0];
          dst[up ^ 1] = up ? h[0] : h[EPC / 4 - 1];
        } else {
          dst[0] = h[0];
        }
      }
      __syncthreads();  // the band is activated; its raw rows are free
      stage(b + AHEAD);

      const float* rows[R + 2];
#pragma unroll
      for (int j = 0; j < R + 2; ++j)
        rows[j] = act + (((b * R + j) % ACT_SLOTS) * XCOLS + lane * PCW) * CB + tc * CV;
      float acc[PCW][R][CV];
#pragma unroll
      for (int co = 0; co < PCW; ++co)
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int e = 0; e < CV; ++e) acc[co][r][e] = 0.0f;
#pragma unroll
      for (int ci = 0; ci < PCW + 2; ++ci) {
        RawVec<float, CV> xv[R + 2];
#pragma unroll
        for (int j = 0; j < R + 2; ++j)
          xv[j] = *reinterpret_cast<const RawVec<float, CV>*>(rows[j] + ci * CB);
        // output column co takes its dx = 0 taps from input column co, then
        // dx = 1 from co + 1, then dx = 2: dx-major, dy-minor
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int co = ci - dx;
          if (co < 0 || co >= PCW) continue;
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int dy = 0; dy < 3; ++dy)
#pragma unroll
              for (int e = 0; e < CV; ++e)
                acc[co][r][e] = tap(xv[r + dy].v[e], wr[dy][dx][e], acc[co][r][e]);
        }
        if (ci < 2) continue;
        const int co = ci - 2, wo = wo0 + lane * PCW + co;  // this column has its nine taps
        if (wo >= a.W || ch >= a.C) continue;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int ho = ho0 + b * R + r;
          if (ho >= a.H) continue;
          RawVec<T, CV> o;
#pragma unroll
          for (int e = 0; e < CV; ++e) {
            o.v[e] = from_f32<T>(acc[co][r][e]);
            const float q = to_f32(o.v[e]);  // statistics of the rounded output
            if (STATS) {
              s_acc[e] += q;
              q_acc[e] += q * q;
            }
            if (POOL) p_acc[e] += gelu_exact(__fadd_rn(__fmul_rn(q, psc[e]), pbi[e]));
          }
          *reinterpret_cast<RawVec<T, CV>*>(
              out + ((static_cast<long long>(n) * a.H + ho) * a.W + wo) * a.C + ch) = o;
        }
      }
    }

    if (STATS || POOL) {
      // the item's partial row: the column lanes in a fixed order
#pragma unroll
      for (int e = 0; e < CV; ++e) {
        red[(0 * LANES + lane) * CB + tc * CV + e] = s_acc[e];
        red[(1 * LANES + lane) * CB + tc * CV + e] = q_acc[e];
        red[(2 * LANES + lane) * CB + tc * CV + e] = p_acc[e];
      }
      __syncthreads();
      const long long prow =
          (static_cast<long long>(n) * a.nchunk + chunk) * a.nstrip + strip;
      for (int c = tid; c < CB; c += THREADS) {
        if (c0 + c >= a.C) continue;
        float s = 0.0f, q = 0.0f, p = 0.0f;
        for (int l = 0; l < LANES; ++l) {
          s += red[(0 * LANES + l) * CB + c];
          q += red[(1 * LANES + l) * CB + c];
          p += red[(2 * LANES + l) * CB + c];
        }
        if (STATS) {
          a.psum[prow * a.C + c0 + c] = s;
          a.psq[prow * a.C + c0 + c] = q;
        }
        if (POOL) a.ppool[prow * a.C + c0 + c] = p;
      }
      // the scratch is written again only at the end of the next item,
      // behind that item's barriers
    }
  }
}

template <typename T, bool STATS, bool POOL>
void launch_tiles(const Args& a, cudaStream_t s) {
  constexpr size_t smem = Patch<T>::SMEM;
  const int blocks = dw_resident_blocks(ngd_tile_kernel<T, STATS, POOL>, smem, a.items, THREADS);
  ngd_tile_kernel<T, STATS, POOL><<<blocks, THREADS, smem, s>>>(a);
}

template <typename T>
void launch(Args a, int N, cudaStream_t s) {
  a.nchunk = (a.H + ROWS - 1) / ROWS;
  a.nstrip = (a.W + WT - 1) / WT;
  a.ncb = (a.C + Patch<T>::CB - 1) / Patch<T>::CB;
  a.items = static_cast<long long>(N) * a.nchunk * a.nstrip * a.ncb;
  const bool stats = a.psum != nullptr, pool = a.pscale != nullptr;
  if (stats && pool)
    launch_tiles<T, true, true>(a, s);
  else if (stats)
    launch_tiles<T, true, false>(a, s);
  else if (pool)
    launch_tiles<T, false, true>(a, s);
  else
    launch_tiles<T, false, false>(a, s);
}

}  // namespace

// rows of the per-item partials a frame of H x W needs (the wrapper
// allocates psum, psq and ppool as [N * this, C])
extern "C" int uncr_ngd_blocks(int H, int W) {
  return ((H + ROWS - 1) / ROWS) * ((W + WT - 1) / WT);
}

namespace {

int run(const void* x, int dtype, const float* mean, const float* coef, int groups_in,
        const float* scale, const float* bias, const float* w9, void* out, int N, int H, int W,
        int C, float* psum, float* psq, float* sum, float* sumsq, int groups_out,
        const float* pscale, const float* pbias, float* ppool, float* pool, const void* top,
        const void* bot, cudaStream_t s) {
  Args a{x, mean, coef, scale, bias, w9, out, psum, psq, pscale, pbias, ppool,
         H, W,    C,    groups_in, 0, 0, 0, 0, top, bot};
  if (dtype == kBFloat16 && C % 8 == 0)
    launch<__nv_bfloat16>(a, N, s);
  else if (dtype == kFloat32 && C % 4 == 0)
    launch<float>(a, N, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = uncr_ngd_blocks(H, W);
  if (psum) launch_group_stats(psum, psq, sum, sumsq, N, rows, C, groups_out, s);
  if (pscale)
    channel_sum_kernel<512><<<N * ((C + 31) / 32), 512, 0, s>>>(ppool, pool, rows, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x and out [N,H,W,C] (dtype, contiguous, 16-byte aligned; C a multiple of
// the 16-byte vector: 8 in bf16, 4 in fp32; H, W >= 2), mean/coef
// [N,groups_in], scale/bias [C], w9 [9,C] (tap dy*3+dx); all fp32 unless
// stated. Statistics: psum/psq [N * uncr_ngd_blocks(H, W) + N, C] scratch
// (the partial rows, then N rows for the second pass) and sum/sumsq
// [N,groups_out], or a null psum for none. Pooled sum: pscale/pbias
// [C], ppool scratch like psum and pool [N,C], or a null pscale for none.
// The wrapper checks the shapes.
extern "C" int uncr_norm_gelu_dwconv3x3(const void* x, int dtype, const float* mean,
                                        const float* coef, int groups_in, const float* scale,
                                        const float* bias, const float* w9, void* out, int N,
                                        int H, int W, int C, float* psum, float* psq, float* sum,
                                        float* sumsq, int groups_out, const float* pscale,
                                        const float* pbias, float* ppool, float* pool,
                                        void* stream) {
  return run(x, dtype, mean, coef, groups_in, scale, bias, w9, out, N, H, W, C, psum, psq, sum,
             sumsq, groups_out, pscale, pbias, ppool, pool, nullptr, nullptr,
             static_cast<cudaStream_t>(stream));
}

// The halo mode: x is one band of rows of a taller scene, and top / bot
// [N,W,C] (x's dtype, contiguous, 16-byte aligned) are the raw input rows
// just above and below it, or null at the scene's edge (mirrored as above).
// The kernel normalises and activates them exactly like its own rows; the
// statistics and the pooled sum cover the band's own output rows only, so
// they are this band's partial sums. Otherwise as uncr_norm_gelu_dwconv3x3.
extern "C" int uncr_norm_gelu_dwconv3x3_halo(
    const void* x, const void* top, const void* bot, int dtype, const float* mean,
    const float* coef, int groups_in, const float* scale, const float* bias, const float* w9,
    void* out, int N, int H, int W, int C, float* psum, float* psq, float* sum, float* sumsq,
    int groups_out, const float* pscale, const float* pbias, float* ppool, float* pool,
    void* stream) {
  if ((top && !aligned16(top)) || (bot && !aligned16(bot)))
    return static_cast<int>(cudaErrorInvalidValue);
  return run(x, dtype, mean, coef, groups_in, scale, bias, w9, out, N, H, W, C, psum, psq, sum,
             sumsq, groups_out, pscale, pbias, ppool, pool, top, bot,
             static_cast<cudaStream_t>(stream));
}
