// Fused normalise -> GELU -> SE scale -> pointwise GEMM -> affine -> GELU
// (kernel K3), with optional per-group output statistics.
//
//   h[r,c]   = ((x[r,c] - mean[n,g(c)]) * coef[n,g(c)]) * scale[c] + bias[c]
//   h        = gelu(h)            if do_gelu
//   h        = h * se[n,c]        if se
//   o[r,:]   = bf16(h[r,:]) @ w   (bf16 products, fp32 accumulation)
//   o        = o * oscale + obias if oscale;  o = gelu(o) if out_gelu
//   out      = cast(o) to x's dtype;  n = r / P (the frame of row r)
//   sum/sumsq[n,g] over the frame's rows and group g's columns of the
//   rounded output, when psum is given
//
// Replaces: uncrtaints_tpu/ops/pallas_mbconv.py norm_gelu_matmul (kernel A,
// _mk_kernel_a). The TPU kernel's 0/1 selection matmul for the group sums is
// a Mosaic layout trick and is not carried over; the TPU's A&S erf
// approximation is replaced by the exact erff.
//
// Bound: at the decoder shapes (M = 262144 rows, K x N = 128 x 256 or
// 256 x 128) a row costs 2*K*N FLOP for 2*(K+N) bytes of bf16 in and out,
// K*N/(K+N) = 85 FLOP/byte: below the H100's bf16 balance point (~295), so
// device memory bounds it by the roofline (201 MB, 0.060 ms at 3.35 TB/s).
// On chip the prologue's erff on every A element (M*K = 67 M at 256 -> 128)
// is the largest instruction cost and comes close to that bound.
//
// Two kernels, both written here:
//
// ngm_wg_kernel, for bf16 x with C and C2 in {128, 256} (C * C2 <= 32768)
// and whole 8-channel chunks per input group: the decoder shapes.
// - A persistent grid, one block of four warpgroups (512 threads) an SM.
//   Each warpgroup walks 64-row tiles of its own (a tile never straddles
//   frames) with its own ring of x tiles and its own named barrier: the four
//   drift apart, so while one runs its prologue (bound by the GELU's instructions) the
//   others' loads, MMAs and stores go on. (Two warpgroups with deeper rings
//   leave the prologue's GELU unhidden and were slower.)
// - BN is the whole C2: x is read, and its prologue computed, once.
// - The whole weight sits in shared memory for the life of the block, K-major
//   in the 128-byte swizzle wgmma reads (transposed from [C, C2] on the way
//   in, once per block).
// - A warpgroup's ring (2 stages of 16 KB at C = 128, 1 of 32 KB at C = 256;
//   with the 64 KB weight and the scratch 227 KB and 210 KB of the 227 KB a
//   block may ask for) is filled with cp.async, 16 bytes a lane, each chunk
//   straight to its swizzled place. A stage is refilled as soon as the MMAs
//   that read it are done, so the copy flies during the epilogue and, with
//   two stages, the whole next tile.
// - The prologue runs in place: a thread reads the 16-byte chunks it copied
//   itself, applies the prologue with the _rn roundings, rounds to bf16 and
//   writes the chunk back where it was, so the tile becomes wgmma's A operand
//   without another buffer, and a thread's eight channels, hence its scale,
//   bias and SE terms, are the same for every row: they stay in registers.
//   (wgmma can take A from registers, but in that fragment layout a thread
//   meets 4 scattered columns per step of K and would fetch their terms per
//   element; the shared-memory route costs one 16-byte store per load, far
//   inside the SM's shared-memory rate.)
// - wgmma.mma_async m64n128k16, bf16 in, fp32 accumulators in registers (64 a
//   thread, which lets four warpgroups fit the register file), A and B by
//   descriptor; at C2 = 256 the output is multiplied in two column parts from
//   the same A tile.
// - The epilogue runs on the accumulator registers (affine with _rn, exact
//   GELU, one cast); the four lanes of a quad exchange their bf16 pairs by
//   shuffles so that each writes 16 contiguous bytes and a quad 64: whole
//   sectors, no shared-memory staging.
// - Statistics: per-column sums of the rounded output, over a warp's 16 rows
//   by shuffles, over the warpgroup's four warps in shared memory in a fixed
//   order, one partial row per 64-row tile.
//
// ngm_kernel, for everything else the wrapper admits (C % 32, C2 % 16, fp32
// x): a single-stage tiled WMMA (bf16 16x16x16, fp32 accumulate), 128x128
// block tiles, K in steps of 32, 8 warps of 32x64, one partial row per
// 128-row block.
//
// Statistics need no atomics: launch_group_stats (common.cuh) reduces the
// partial rows per channel, then per (frame, group), in a fixed order.
#include "common.cuh"
#include "wgmma.cuh"

#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128, BN = 128, BK = 32, THREADS = 256;
constexpr int A_LD = BK + 8, B_LD = BN + 8;  // padded rows, multiples of 8 (WMMA ldm)
constexpr int WARPS_M = 4, WARPS_N = 2;      // each warp: 32 rows x 64 columns
constexpr int FM = 2, FN = 4;                // 16x16 fragments per warp

struct Args {
  const void* x;
  const float* mean;
  const float* coef;
  const float* scale;
  const float* bias;
  const __nv_bfloat16* w;
  const float* se;      // [N, C] or null
  const float* oscale;  // [C2] or null (then obias is unused)
  const float* obias;
  void* out;
  float* psum;  // [M / rows per tile, C2] partials or null (no statistics)
  float* psq;
  long long P;
  int C, C2, groups_in, do_gelu, out_gelu;
};

template <typename T>
__global__ void __launch_bounds__(THREADS) ngm_kernel(Args a) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * B_LD];
  __shared__ __align__(128) float Cs[THREADS / 32][16 * 16];
  __shared__ float col_s[WARPS_M][BN], col_q[WARPS_M][BN];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const int col0 = blockIdx.y * BN;
  const long long n = row0 / a.P;  // P % BM == 0: the whole tile is one frame
  const int cg_in = a.C / a.groups_in;
  const T* x = static_cast<const T*>(a.x);
  const float* mean_n = a.mean + n * a.groups_in;
  const float* coef_n = a.coef + n * a.groups_in;
  const float* se_n = a.se ? a.se + n * a.C : nullptr;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < a.C; k0 += BK) {
    // A tile [BM, BK]: load x, apply the prologue in fp32, round to bf16.
    // The _rn intrinsics keep the plain version's roundings (no FMA).
    for (int v = tid; v < BM * BK / 8; v += THREADS) {
      const int r = v / (BK / 8), c = k0 + (v % (BK / 8)) * 8;
      float h[8];
      load_f32<T, 8>(x + (row0 + r) * a.C + c, h);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cc = c + j, g = cc / cg_in;
        float u = __fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(h[j], mean_n[g]), coef_n[g]), a.scale[cc]), a.bias[cc]);
        if (a.do_gelu) u = gelu_exact(u);
        if (se_n) u = __fmul_rn(u, se_n[cc]);
        h[j] = u;
      }
      store_from_f32<__nv_bfloat16, 8>(As + r * A_LD + (c - k0), h);
    }
    // B tile [BK, BN] of w [C, C2]; columns past C2 are zero (C2 % 16 == 0,
    // so an 8-wide vector is wholly inside or outside)
    for (int v = tid; v < BK * BN / 8; v += THREADS) {
      const int r = v / (BN / 8), cv = (v % (BN / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (col0 + cv < a.C2)
        val = *reinterpret_cast<const uint4*>(a.w + static_cast<long long>(k0 + r) * a.C2 + col0 + cv);
      *reinterpret_cast<uint4*>(Bs + r * B_LD + cv) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(af[i], As + (wm * 32 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bf[j], Bs + kk * B_LD + wn * 64 + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: fragment -> per-warp shared scratch -> affine, GELU, cast,
  // store; lane owns column (lane % 16) and rows lane/16 + 2e
  T* out = static_cast<T*>(a.out);
  float* cs = Cs[warp];
  const int lc = lane & 15, lr = lane >> 4;
  float s_acc[FN], q_acc[FN];
#pragma unroll
  for (int j = 0; j < FN; ++j) {
    s_acc[j] = 0.0f;
    q_acc[j] = 0.0f;
    const int col = col0 + wn * 64 + j * 16 + lc;
    const bool col_ok = col < a.C2;  // uniform over the warp (C2 % 16 == 0)
    float osc = 1.0f, obi = 0.0f;
    if (col_ok && a.oscale) {
      osc = a.oscale[col];
      obi = a.obias[col];
    }
#pragma unroll
    for (int i = 0; i < FM; ++i) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      if (col_ok) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int r = lr + 2 * e;
          float v = cs[r * 16 + lc];
          if (a.oscale) v = __fadd_rn(__fmul_rn(v, osc), obi);
          if (a.out_gelu) v = gelu_exact(v);
          const T o = from_f32<T>(v);
          out[(row0 + wm * 32 + i * 16 + r) * a.C2 + col] = o;
          const float q = to_f32(o);  // statistics of the rounded output
          s_acc[j] += q;
          q_acc[j] += q * q;
        }
      }
      __syncwarp();
    }
  }

  if (a.psum) {  // uniform over the block
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      s_acc[j] += __shfl_xor_sync(0xffffffffu, s_acc[j], 16);
      q_acc[j] += __shfl_xor_sync(0xffffffffu, q_acc[j], 16);
      if (lane < 16) {
        col_s[wm][wn * 64 + j * 16 + lane] = s_acc[j];
        col_q[wm][wn * 64 + j * 16 + lane] = q_acc[j];
      }
    }
    __syncthreads();
    if (tid < BN && col0 + tid < a.C2) {
      float s = 0.0f, q = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS_M; ++w) {
        s += col_s[w][tid];
        q += col_q[w][tid];
      }
      const long long idx = static_cast<long long>(blockIdx.x) * a.C2 + col0 + tid;
      a.psum[idx] = s;
      a.psq[idx] = q;
    }
  }
}


// ------------------------------------------------- the wgmma kernel --

// A block is four warpgroups. A warpgroup's ring of x tiles has two stages at
// C = 128 and one at C = 256 (what fits beside the weight), and the output is
// multiplied in column parts of 128 (two m64n128 passes over the same A tile
// at C2 = 256, 64 accumulators a thread).
constexpr int WG_THREADS = 128, WG_BM = 64, WGS = 4, NP = 128;

template <int K, int N>
struct WgLayout {
  static constexpr int STAGES = K == 128 ? 2 : 1;       // x tiles in a warpgroup's ring
  static constexpr int W_BYTES = K * N * 2;             // the weight, K-major panels of 64
  static constexpr int STAGE_BYTES = WG_BM * K * 2;     // one raw / normalised x tile
  static constexpr int PANEL_BYTES = WG_BM * 128;       // 64 rows x 64 elements of it
  static constexpr int A_OFF = W_BYTES;
  static constexpr int TAB_OFF = A_OFF + WGS * STAGES * STAGE_BYTES;  // oscale, obias [N]
  static constexpr int RED_OFF = TAB_OFF + 2 * N * 4;   // per warpgroup: sums [2][4][N]
  static constexpr int SMEM = RED_OFF + WGS * 2 * 4 * N * 4 + 1024;  // + alignment slack
  static_assert(SMEM <= 232448, "a block may ask for 227 KB of shared memory");
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 4 x 4 transpose of 32-bit words across the four lanes of a quad: lane q
// gives a[k] (its piece of block k) and ends with the pieces of block q from
// lanes 0..3 in a[0..3]
__device__ __forceinline__ void quad_transpose(uint32_t (&a)[4], int q) {
  uint32_t t0 = (q & 1) ? a[0] : a[1], t1 = (q & 1) ? a[2] : a[3];
  t0 = __shfl_xor_sync(0xffffffffu, t0, 1);
  t1 = __shfl_xor_sync(0xffffffffu, t1, 1);
  if (q & 1) {
    a[0] = t0;
    a[2] = t1;
  } else {
    a[1] = t0;
    a[3] = t1;
  }
  t0 = (q & 2) ? a[0] : a[2];
  t1 = (q & 2) ? a[1] : a[3];
  t0 = __shfl_xor_sync(0xffffffffu, t0, 2);
  t1 = __shfl_xor_sync(0xffffffffu, t1, 2);
  if (q & 2) {
    a[0] = t0;
    a[1] = t1;
  } else {
    a[2] = t0;
    a[3] = t1;
  }
}

template <int K, int N>
__global__ void __launch_bounds__(WG_THREADS * WGS, 1) ngm_wg_kernel(Args a, long long tiles) {
  using L = WgLayout<K, N>;
  constexpr int STAGES = L::STAGES, NSPLIT = N / NP;
  constexpr int CPR = K / 8;             // 16-byte chunks per row of x
  constexpr int RPP = WG_THREADS / CPR;  // rows a warpgroup copies per pass
  constexpr int PASSES = WG_BM / RPP;
  static_assert(N % NP == 0, "whole column parts of m64n128k16");
  extern __shared__ unsigned char smem_raw[];
  // wgmma's swizzled tiles start on 1024-byte boundaries
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* Bs = smem;
  float* osc_s = reinterpret_cast<float*>(smem + L::TAB_OFF);
  float* obi_s = osc_s + N;

  const int tid = threadIdx.x, wg = tid / WG_THREADS, t = tid % WG_THREADS;
  const int warp = t >> 5, lane = t & 31;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);

  // the weight [K, N] -> Bs[n][k], K-major panels of 64 in the 128-byte
  // swizzle: a thread gathers the 8 k of one chunk for one n
  {
    const unsigned short* w = reinterpret_cast<const unsigned short*>(a.w);
    for (int idx = tid; idx < N * CPR; idx += WG_THREADS * WGS) {
      const int n = idx % N, kc = idx / N;
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t lo = __ldg(w + static_cast<long long>(kc * 8 + 2 * e) * N + n);
        const uint32_t hi = __ldg(w + static_cast<long long>(kc * 8 + 2 * e + 1) * N + n);
        v[e] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(Bs + (kc / 8) * (N * 128) + swizzle128(n, kc % 8)) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
    for (int c = tid; c < N; c += WG_THREADS * WGS) {
      osc_s[c] = a.oscale ? a.oscale[c] : 1.0f;
      obi_s[c] = a.oscale ? a.obias[c] : 0.0f;
    }
    fence_proxy_async();
    __syncthreads();
  }

  unsigned char* As = smem + L::A_OFF + wg * STAGES * L::STAGE_BYTES;
  float* red = reinterpret_cast<float*>(smem + L::RED_OFF) + wg * 2 * 4 * N;
  const int bar = 1 + wg;

  // this thread's chunk column: the same 8 channels in every row it touches
  const int cc = t % CPR, rr = t / CPR;
  const int ch = cc * 8, g_in = ch / (K / a.groups_in);
  float sc[8], bi[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    sc[e] = a.scale[ch + e];
    bi[e] = a.bias[ch + e];
  }
  const uint64_t desc_b = wgmma_desc_k128(static_cast<uint32_t>(__cvta_generic_to_shared(Bs)));

  // tiles of this warpgroup: wgi, wgi + stride, ...
  const long long wgi = static_cast<long long>(blockIdx.x) * WGS + wg;
  const long long stride = static_cast<long long>(gridDim.x) * WGS;
  const int nt = wgi < tiles ? static_cast<int>((tiles - wgi + stride - 1) / stride) : 0;

  auto chunk_at = [&](int stage, int r) {
    return As + stage * L::STAGE_BYTES + (cc / 8) * L::PANEL_BYTES + swizzle128(r, cc % 8);
  };
  auto start_copy = [&](int it) {
    if (it < nt) {
      const long long row0 = (wgi + it * stride) * WG_BM;
#pragma unroll
      for (int i = 0; i < PASSES; ++i) {
        const int r = rr + i * RPP;
        cp_async16(chunk_at(it % STAGES, r), x + (row0 + r) * K + ch, true);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int it = 0; it < STAGES; ++it) start_copy(it);

  float acc[NP / 2];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) acc[i] = 0.0f;
  for (int it = 0; it < nt; ++it) {
    const int stage = it % STAGES;
    const long long row0 = (wgi + it * stride) * WG_BM;
    const long long n = row0 / a.P;
    const float mean = a.mean[n * a.groups_in + g_in], coef = a.coef[n * a.groups_in + g_in];
    float se[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) se[e] = a.se ? a.se[n * K + ch + e] : 1.0f;

    cp_async_wait<STAGES - 1>();  // this thread's chunks of tile `it` are here
    // the prologue, in place on the chunks this thread copied. The _rn
    // intrinsics keep the plain version's roundings (no FMA).
#pragma unroll 2
    for (int i = 0; i < PASSES; ++i) {
      uint4* p = reinterpret_cast<uint4*>(chunk_at(stage, rr + i * RPP));
      uint4 u = *p;
      const __nv_bfloat16* e8 = reinterpret_cast<const __nv_bfloat16*>(&u);
      float h[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float v = __fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(__bfloat162float(e8[e]), mean), coef), sc[e]), bi[e]);
        if (a.do_gelu) v = gelu_exact(v);
        if (a.se) v = __fmul_rn(v, se[e]);
        h[e] = v;
      }
      *p = make_uint4(pack_bf16x2(h[0], h[1]), pack_bf16x2(h[2], h[3]), pack_bf16x2(h[4], h[5]),
                      pack_bf16x2(h[6], h[7]));
    }
    fence_proxy_async();
    named_barrier(bar, WG_THREADS);  // every thread's chunks are normalised

    const uint64_t desc_a = wgmma_desc_k128(
        static_cast<uint32_t>(__cvta_generic_to_shared(As + stage * L::STAGE_BYTES)));
    const int q = lane & 3, r0 = warp * 16 + (lane >> 2);
    __nv_bfloat16* orow = out + (row0 + r0) * N;
#pragma unroll
    for (int part = 0; part < NSPLIT; ++part) {
      // rows of Bs are output columns: part `part` starts NP rows down
#pragma unroll
      for (int i = 0; i < NP / 2; ++i) wgmma_fence_operand(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < K / 16; ++k16) {
        const uint64_t da = desc_a + (((k16 / 4) * L::PANEL_BYTES + (k16 % 4) * 32) >> 4);
        const uint64_t db =
            desc_b + (((k16 / 4) * (N * 128) + part * (NP * 128) + (k16 % 4) * 32) >> 4);
        wgmma_m64n128k16(acc, da, db, k16 != 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < NP / 2; ++i) wgmma_fence_operand(acc[i]);
      if (part == NSPLIT - 1) {
        // every warp's MMAs have read the tile: its stage is refilled while
        // the epilogue and the next tiles' work go on
        named_barrier(bar, WG_THREADS);
        start_copy(it + STAGES);
      }

      // epilogue on the accumulators: rows r0 and r0 + 8, columns 8j + 2q + {0, 1}
#pragma unroll
      for (int m = 0; m < NP / 32; ++m) {
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = m * 4 + jj, col = part * NP + j * 8 + 2 * q;
          float v0 = acc[4 * j], v1 = acc[4 * j + 1], v2 = acc[4 * j + 2], v3 = acc[4 * j + 3];
          if (a.oscale) {
            const float2 os = *reinterpret_cast<const float2*>(osc_s + col);
            const float2 ob = *reinterpret_cast<const float2*>(obi_s + col);
            v0 = __fadd_rn(__fmul_rn(v0, os.x), ob.x);
            v1 = __fadd_rn(__fmul_rn(v1, os.y), ob.y);
            v2 = __fadd_rn(__fmul_rn(v2, os.x), ob.x);
            v3 = __fadd_rn(__fmul_rn(v3, os.y), ob.y);
          }
          if (a.out_gelu) {
            v0 = gelu_exact(v0);
            v1 = gelu_exact(v1);
            v2 = gelu_exact(v2);
            v3 = gelu_exact(v3);
          }
          const __nv_bfloat162 top = __floats2bfloat162_rn(v0, v1);
          const __nv_bfloat162 bot = __floats2bfloat162_rn(v2, v3);
          lo[jj] = *reinterpret_cast<const uint32_t*>(&top);
          hi[jj] = *reinterpret_cast<const uint32_t*>(&bot);
          if (a.psum) {  // uniform; statistics of the rounded output
            const float2 ft = __bfloat1622float2(top), fb = __bfloat1622float2(bot);
            float s0 = ft.x + fb.x, s1 = ft.y + fb.y;
            float q0 = ft.x * ft.x + fb.x * fb.x, q1 = ft.y * ft.y + fb.y * fb.y;
#pragma unroll
            for (int off = 4; off < 32; off <<= 1) {  // the warp's 8 row lanes
              s0 += __shfl_xor_sync(0xffffffffu, s0, off);
              s1 += __shfl_xor_sync(0xffffffffu, s1, off);
              q0 += __shfl_xor_sync(0xffffffffu, q0, off);
              q1 += __shfl_xor_sync(0xffffffffu, q1, off);
            }
            if (lane < 4) {
              red[(0 * 4 + warp) * N + col] = s0;
              red[(0 * 4 + warp) * N + col + 1] = s1;
              red[(1 * 4 + warp) * N + col] = q0;
              red[(1 * 4 + warp) * N + col + 1] = q1;
            }
          }
        }
        // lane q takes 8 columns of both rows: 16 bytes each, a quad 64
        quad_transpose(lo, q);
        quad_transpose(hi, q);
        __nv_bfloat16* o = orow + part * NP + m * 32 + q * 8;
        *reinterpret_cast<uint4*>(o) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        *reinterpret_cast<uint4*>(o + 8 * N) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      }
    }
    if (a.psum) {
      named_barrier(bar, WG_THREADS);
      const long long prow = wgi + it * stride;  // one partial row per 64-row tile
      for (int c = t; c < N; c += WG_THREADS) {
        float s = 0.0f, sq = 0.0f;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          s += red[(0 * 4 + w) * N + c];
          sq += red[(1 * 4 + w) * N + c];
        }
        a.psum[prow * N + c] = s;
        a.psq[prow * N + c] = sq;
      }
      // red is written again behind the next tile's barriers
    }
  }
}

template <int K, int N>
int launch_wg(const Args& a, int N_frames, cudaStream_t s) {
  using L = WgLayout<K, N>;
  const long long tiles = static_cast<long long>(N_frames) * a.P / WG_BM;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(ngm_wg_kernel<K, N>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  const long long want = (tiles + WGS - 1) / WGS;
  const int blocks = static_cast<int>(want < sms ? want : sms);
  ngm_wg_kernel<K, N><<<blocks, WG_THREADS * WGS, L::SMEM, s>>>(a, tiles);
  return WG_BM;
}

// the wgmma kernel takes bf16 x, C and C2 of 128 or 256 (not both 256: the
// weight and the ring must fit in shared memory) and input groups of whole
// 8-channel chunks
bool wg_takes(int dtype, int C, int C2, int groups_in) {
  return dtype == kBFloat16 && (C == 128 || C == 256) && (C2 == 128 || C2 == 256) &&
         C * C2 <= 32768 && (C / groups_in) % 8 == 0;
}

}  // namespace

// rows of x behind one partial row of the statistics: 64 where the wgmma
// kernel runs, else 128 (the wrapper allocates psum and psq as [N*P/this, C2]
// and counts which kernel it launched)
extern "C" int uncr_ngm_tile_rows(int dtype, int C, int C2, int groups_in) {
  return wg_takes(dtype, C, C2, groups_in) ? WG_BM : BM;
}

// x [N,P,C] (dtype), mean/coef [N,groups_in], scale/bias [C], w [C,C2] bf16,
// se [N,C] or null, oscale/obias [C2] or null, out [N,P,C2] (dtype). All
// contiguous fp32 unless stated. The wrapper checks P % 128 == 0,
// C % 32 == 0, C2 % 16 == 0, the group divisibility and 16-byte alignment.
// psum/psq are [N*P/uncr_ngm_tile_rows(...) + N, C2] scratch (the partial
// rows, then N rows for the second pass), sum/sumsq [N,groups_out]; pass null
// psum to skip the statistics.
extern "C" int uncr_norm_gelu_matmul(const void* x, int dtype, const float* mean,
                                     const float* coef, int groups_in, const float* scale,
                                     const float* bias, const void* w, const float* se,
                                     const float* oscale, const float* obias, int do_gelu,
                                     int out_gelu, void* out, int N, long long P, int C, int C2,
                                     float* psum, float* psq, float* sum, float* sumsq,
                                     int groups_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{x,      mean, coef, scale, bias, static_cast<const __nv_bfloat16*>(w),
         se,     oscale, obias, out,  psum, psq, P, C, C2, groups_in, do_gelu, out_gelu};
  int tile_rows = BM;
  if (wg_takes(dtype, C, C2, groups_in)) {
    if (C == 128 && C2 == 256)
      tile_rows = launch_wg<128, 256>(a, N, s);
    else if (C == 256 && C2 == 128)
      tile_rows = launch_wg<256, 128>(a, N, s);
    else
      tile_rows = launch_wg<128, 128>(a, N, s);
  } else {
    const dim3 grid(static_cast<unsigned>(static_cast<long long>(N) * P / BM),
                    static_cast<unsigned>((C2 + BN - 1) / BN));
    if (dtype == kBFloat16)
      ngm_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(a);
    else if (dtype == kFloat32)
      ngm_kernel<float><<<grid, THREADS, 0, s>>>(a);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (psum)
    launch_group_stats(psum, psq, sum, sumsq, N, static_cast<int>(P / tile_rows), C2, groups_out,
                       s);
  return static_cast<int>(cudaGetLastError());
}
