// Fused normalise -> exact GELU -> depthwise 3x3 with reflect borders
// (kernel K4), with per-group statistics of the output.
//
//   h[n,r,s,c]   = gelu(((x[n,r,s,c] - mean[n,g(c)]) * coef[n,g(c)]) * scale[c] + bias[c])
//   out[n,y,x,c] = sum_{dx} sum_{dy} h[n, refl(y+dy-1), refl(x+dx-1), c] * w[dy,dx,c]
//   refl(-1) = 1, refl(H) = H-2 (columns alike);  out is cast to x's dtype
//   sum/sumsq[n,g] over the frame's pixels and group g's channels of the
//   rounded output
//
// x and out [N,H,W,C] NHWC in one dtype (bf16 or fp32); everything else fp32.
// The taps are summed in fp32 in the order dx-major, dy-minor, each product
// and each sum rounded once (__fmul_rn / __fadd_rn, no FMA contraction): the
// roundings of the plain version, which are the JAX kernel's.
//
// Replaces: uncrtaints_tpu/ops/pallas_mbconv.py norm_gelu_dwconv3x3 (kernel
// B, _mk_kernel_b). The TPU version gathers row slabs with a halo and a
// padded column axis on the XLA side, pads the weights to 16 rows, rolls
// sublanes per dx and sums the groups by a 0/1 selection matmul: all Mosaic
// workarounds, none carried over. Here the reflect border is a mirrored index
// on the load (no padded copy, no gather) and the prologue is applied as each
// element is loaded.
//
// Bound: device memory by the roofline (one read and one write of the map,
// 268 MB at [4,256,256,256] bf16, against 9 multiply-adds per element), but
// the exact GELU (erff) on every loaded element is the largest cost on chip,
// so the design loads, and activates, each input as few times as its
// registers allow: a thread owns VEC channels (one 16-byte vector), TR = 2
// output rows and a segment of WSEG = 64 output columns. It walks the
// segment's input columns once; per input column it loads TR+2 vectors,
// activates them, and adds their products into the accumulators of the three
// output columns they reach (dx = 0 of the next column, 1 of this one, 2 of
// the previous, which is then complete and stored): exactly the dx-major,
// dy-minor order. Each input is so activated (TR+2)/TR times by row and
// 66/64 by column; four rows a thread spill registers at VEC = 8.
// Neighbouring threads own neighbouring channel vectors, so a warp's loads
// and stores are contiguous. The nine weights and the four prologue terms of
// a thread's channels live in registers.
//
// Statistics need no atomics: a thread sums its own rounded outputs, the
// block's TY thread rows are added in a fixed order in shared memory into
// per-block, per-channel partials, and group_stats_kernel (common.cuh)
// reduces them per (frame, group). Two runs give the same bits.
#include "common.cuh"

namespace {

constexpr int TX = 32, TY = 8;  // block: 32 channel vectors x 8 work items
constexpr int TR = 2;           // output rows per thread
constexpr int WSEG = 64;        // output columns per thread

struct Args {
  const void* x;
  const float* mean;
  const float* coef;
  const float* scale;
  const float* bias;
  const float* w;  // [9, C]: tap dy*3+dx
  void* out;
  float* psum;  // [N * gridDim.x, C] per-block partials
  float* psq;
  int H, W, C, groups_in;
  int nseg, nrb;  // column segments per row, row blocks
};

template <typename T, int VEC>
__global__ void __launch_bounds__(TX * TY) ngd_kernel(Args a) {
  __shared__ float red_s[TY][VEC * TX], red_q[TY][VEC * TX];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int n = blockIdx.z;
  const int ch = (blockIdx.y * TX + tx) * VEC;
  const int item = blockIdx.x * TY + ty;
  float s_acc[VEC], q_acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) s_acc[e] = q_acc[e] = 0.0f;

  if (ch < a.C && item < a.nrb * a.nseg) {
    float wr[9][VEC], pm[VEC], pc[VEC], ps[VEC], pb[VEC];
    const int cg_in = a.C / a.groups_in;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int g = (ch + e) / cg_in;
      pm[e] = a.mean[n * a.groups_in + g];
      pc[e] = a.coef[n * a.groups_in + g];
      ps[e] = a.scale[ch + e];
      pb[e] = a.bias[ch + e];
#pragma unroll
      for (int t = 0; t < 9; ++t) wr[t][e] = a.w[t * a.C + ch + e];
    }
    const int r0 = (item / a.nseg) * TR;
    const int w0 = (item % a.nseg) * WSEG, w1 = min(w0 + WSEG, a.W);
    const T* x = static_cast<const T*>(a.x);
    T* out = static_cast<T*>(a.out);
    const T* rows[TR + 2];
#pragma unroll
    for (int j = 0; j < TR + 2; ++j)
      rows[j] = x + (static_cast<long long>(n) * a.H + dw_mirror(r0 - 1 + j, a.H)) * a.W * a.C + ch;

    // accumulators of output columns ci+1 (A), ci (B), ci-1 (C)
    float accA[TR][VEC], accB[TR][VEC], accC[TR][VEC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int e = 0; e < VEC; ++e) accB[i][e] = accC[i][e] = 0.0f;

    for (int ci = w0 - 1; ci <= w1; ++ci) {
      const long long off = static_cast<long long>(dw_mirror(ci, a.W)) * a.C;
      RawVec<T, VEC> raw[TR + 2];
#pragma unroll
      for (int j = 0; j < TR + 2; ++j) raw[j] = load_raw<T, VEC>(rows[j] + off);
      float h[TR + 2][VEC];
#pragma unroll
      for (int j = 0; j < TR + 2; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          h[j][e] = gelu_exact(__fadd_rn(
              __fmul_rn(__fmul_rn(__fsub_rn(to_f32(raw[j].v[e]), pm[e]), pc[e]), ps[e]), pb[e]));
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float v = 0.0f;
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            v = __fadd_rn(v, __fmul_rn(h[i + dy][e], wr[dy * 3 + 0][e]));
            accB[i][e] = __fadd_rn(accB[i][e], __fmul_rn(h[i + dy][e], wr[dy * 3 + 1][e]));
            accC[i][e] = __fadd_rn(accC[i][e], __fmul_rn(h[i + dy][e], wr[dy * 3 + 2][e]));
          }
          accA[i][e] = v;
        }
      if (ci > w0) {  // output column ci-1 has its nine taps
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          if (r0 + i < a.H) {
            RawVec<T, VEC> o;
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              o.v[e] = from_f32<T>(accC[i][e]);
              const float q = to_f32(o.v[e]);  // statistics of the rounded output
              s_acc[e] += q;
              q_acc[e] += q * q;
            }
            *reinterpret_cast<RawVec<T, VEC>*>(
                out + ((static_cast<long long>(n) * a.H + r0 + i) * a.W + ci - 1) * a.C + ch) = o;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          accC[i][e] = accB[i][e];
          accB[i][e] = accA[i][e];
        }
    }
  }

  // per-block partials: the TY thread rows in a fixed order
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    red_s[ty][e * TX + tx] = s_acc[e];
    red_q[ty][e * TX + tx] = q_acc[e];
  }
  __syncthreads();
  for (int v = ty * TX + tx; v < VEC * TX; v += TX * TY) {
    const int c = (blockIdx.y * TX + v % TX) * VEC + v / TX;
    if (c >= a.C) continue;
    float s = 0.0f, q = 0.0f;
#pragma unroll
    for (int y = 0; y < TY; ++y) {
      s += red_s[y][v];
      q += red_q[y][v];
    }
    const long long idx =
        (static_cast<long long>(n) * gridDim.x + blockIdx.x) * a.C + c;
    a.psum[idx] = s;
    a.psq[idx] = q;
  }
}

template <typename T, int VEC>
void launch(Args a, int N, cudaStream_t s) {
  a.nseg = (a.W + WSEG - 1) / WSEG;
  a.nrb = (a.H + TR - 1) / TR;
  const dim3 grid(static_cast<unsigned>((a.nrb * a.nseg + TY - 1) / TY),
                  static_cast<unsigned>((a.C / VEC + TX - 1) / TX), static_cast<unsigned>(N));
  ngd_kernel<T, VEC><<<grid, dim3(TX, TY), 0, s>>>(a);
}

}  // namespace

// rows of the per-block partials a frame of H x W needs (the wrapper
// allocates psum and psq as [N * this, C])
extern "C" int uncr_ngd_blocks(int H, int W) {
  return (((H + TR - 1) / TR) * ((W + WSEG - 1) / WSEG) + TY - 1) / TY;
}

// x and out [N,H,W,C] (dtype, contiguous, 16-byte aligned; C a multiple of
// the 16-byte vector: 8 in bf16, 4 in fp32; H, W >= 2; N <= 65535),
// mean/coef [N,groups_in], scale/bias [C], w9 [9,C] (tap dy*3+dx), psum/psq
// [N * uncr_ngd_blocks(H, W), C] scratch, sum/sumsq [N,groups_out]; all fp32
// unless stated. The wrapper checks the shapes.
extern "C" int uncr_norm_gelu_dwconv3x3(const void* x, int dtype, const float* mean,
                                        const float* coef, int groups_in, const float* scale,
                                        const float* bias, const float* w9, void* out, int N,
                                        int H, int W, int C, float* psum, float* psq, float* sum,
                                        float* sumsq, int groups_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{x, mean, coef, scale, bias, w9, out, psum, psq, H, W, C, groups_in, 0, 0};
  if (dtype == kBFloat16 && C % 8 == 0)
    launch<__nv_bfloat16, 8>(a, N, s);
  else if (dtype == kFloat32 && C % 4 == 0)
    launch<float, 4>(a, N, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  group_stats_kernel<256><<<N * groups_out, 256, 0, s>>>(psum, psq, sum, sumsq,
                                                         uncr_ngd_blocks(H, W), C, groups_out);
  return static_cast<int>(cudaGetLastError());
}
