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
// device memory bounds a well-fed kernel, and the prologue's erff on every A
// element (M*K per call) is the largest ALU cost. The design keeps the
// normalised activation out of device memory: the prologue is applied while
// A is staged into shared memory, and the epilogue runs on the fp32
// accumulators before the one store. The GEMM is a simple single-stage
// tiled WMMA (bf16 16x16x16, fp32 accumulate): 128x128 block tiles, K in
// steps of 32, 8 warps of 32x64. wgmma/TMA pipelining is later work.
//
// Statistics need no atomics: each block writes per-column partial sums of
// its 128 rows, and a second small kernel reduces them per (frame, group).
#include "common.cuh"

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
  float* psum;  // [M/BM, C2] partials or null (no statistics)
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

// one block per (frame n, group g): reduce the frame's row-block partials
// over the group's columns
__global__ void ngm_stats_kernel(const float* __restrict__ psum, const float* __restrict__ psq,
                                 float* __restrict__ sum, float* __restrict__ sumsq,
                                 int blocks_per_frame, int C2, int groups_out) {
  const int n = blockIdx.x / groups_out, g = blockIdx.x % groups_out;
  const int cg = C2 / groups_out;
  const long long total = static_cast<long long>(blocks_per_frame) * cg;
  float s = 0.0f, q = 0.0f;
  for (long long i = threadIdx.x; i < total; i += blockDim.x) {
    const long long idx =
        (static_cast<long long>(n) * blocks_per_frame + i / cg) * C2 + g * cg + i % cg;
    s += psum[idx];
    q += psq[idx];
  }
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
    q += __shfl_down_sync(0xffffffffu, q, off);
  }
  __shared__ float ws[32], wq[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    ws[warp] = s;
    wq[warp] = q;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    s = lane < nw ? ws[lane] : 0.0f;
    q = lane < nw ? wq[lane] : 0.0f;
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

}  // namespace

// x [N,P,C] (dtype), mean/coef [N,groups_in], scale/bias [C], w [C,C2] bf16,
// se [N,C] or null, oscale/obias [C2] or null, out [N,P,C2] (dtype). All
// contiguous fp32 unless stated. The wrapper checks P % 128 == 0,
// C % 32 == 0, C2 % 16 == 0, the group divisibility and 16-byte alignment.
// psum/psq are [N*P/128, C2] scratch, sum/sumsq [N,groups_out]; pass null
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
  const dim3 grid(static_cast<unsigned>(static_cast<long long>(N) * P / BM),
                  static_cast<unsigned>((C2 + BN - 1) / BN));
  if (dtype == kBFloat16)
    ngm_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(a);
  else if (dtype == kFloat32)
    ngm_kernel<float><<<grid, THREADS, 0, s>>>(a);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (psum)
    ngm_stats_kernel<<<N * groups_out, 256, 0, s>>>(psum, psq, sum, sumsq,
                                                     static_cast<int>(P / BM), C2, groups_out);
  return static_cast<int>(cudaGetLastError());
}
