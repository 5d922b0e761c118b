// Depthwise stride-1 correlation with zero padding (kernel K5).
//
//   out[n,ho,wo,c] = sum_{dy,dx} xpad[n, ho+dy, wo+dx, c] * w[c, dy, dx]
//   xpad[n, r, s, c] = x[n, r-pt, s-pl, c] inside x, 0 outside
//
// x [N,H,W,C] and out [N,Ho,Wo,C] NHWC in one dtype (bf16 or fp32), w the
// port's depthwise weight [C,1,kh,kw] in the same dtype. The taps are summed
// in fp32 in the order dy-major, dx-minor, each product and each sum rounded
// once (__fmul_rn / __fadd_rn, no FMA contraction), and the result is rounded
// once to the output dtype: the roundings of the plain shift-add version.
//
// Replaces: uncrtaints_tpu/ops/pallas_dwconv.py dw_stencil (_mk_kernel). The
// TPU kernel DMAs a row-tile window of a padded copy of x into VMEM and
// shifts it in VMEM; here the zero pad is a bounds check on each load (no
// padded copy), and the window lives in registers.
//
// Bound: device memory. Per output element the kernel needs one input and
// one output element (2 * 2 bytes in bf16) against kh*kw multiply-adds; at
// the train step's shapes ([12,258,258,256] -> [12,256,256,256] bf16, 0.8 GB
// moved) that is far below the card's ~295 FLOP/byte. So the design only
// reads each input once from device memory and keeps the kh*kw-fold reuse
// on chip: a thread owns one (n, output row, 16-byte channel vector) and a
// segment of WSEG output columns; it walks the segment with a kh x kw
// window of input vectors in registers, loading kh new vectors per output
// (one per window row). Neighbouring threads own neighbouring channel
// vectors, so a warp's loads are contiguous. The fp32 weights of the block's
// channels sit in shared memory.
#include "common.cuh"

namespace {

constexpr int WSEG = 32;        // output columns per thread
constexpr int TX = 32, TY = 8;  // block: 32 channel vectors x 8 segment lanes

template <typename T, int VEC, int KH, int KW>
__global__ void __launch_bounds__(TX * TY)
    dw_stencil_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                      DwGeo g) {
  __shared__ float ws[KH * KW][TX * VEC];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c0 = blockIdx.y * TX * VEC;
  for (int i = ty * TX + tx; i < KH * KW * TX * VEC; i += TX * TY) {
    const int tap = i / (TX * VEC), cl = i % (TX * VEC);
    ws[tap][cl] = c0 + cl < g.C ? to_f32(w[static_cast<long long>(c0 + cl) * KH * KW + tap]) : 0.0f;
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
        win[dy][dx + 1] = dw_load_or_zero<T, VEC>(x, g, n, ho + dy - g.pt, w0 + dx - g.pl, ch);
    T* o = out + ((static_cast<long long>(n) * g.Ho + ho) * g.Wo + w0) * g.C + ch;
    for (int wo = w0; wo < w1; ++wo, o += g.C) {
#pragma unroll
      for (int dy = 0; dy < KH; ++dy) {
#pragma unroll
        for (int dx = 0; dx + 1 < KW; ++dx) win[dy][dx] = win[dy][dx + 1];
        win[dy][KW - 1] = dw_load_or_zero<T, VEC>(x, g, n, ho + dy - g.pt, wo + KW - 1 - g.pl, ch);
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
void launch(const void* x, const void* w, void* out, const DwGeo& g, cudaStream_t stream) {
  const int nseg = (g.Wo + WSEG - 1) / WSEG;
  const long long lanes = static_cast<long long>(g.N) * g.Ho * nseg;
  const long long want = (lanes + TY - 1) / TY;
  const dim3 grid(static_cast<unsigned>(want < 65535 ? want : 65535),
                  static_cast<unsigned>((g.C / VEC + TX - 1) / TX));
  dw_stencil_kernel<T, VEC, KH, KW><<<grid, dim3(TX, TY), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), g);
}

template <typename T, int VEC>
bool dispatch(int kh, int kw, const void* x, const void* w, void* out, const DwGeo& g,
              cudaStream_t s) {
#define UNCR_DW_CASE(KH, KW)                                   \
  if (kh == KH && kw == KW) {                                  \
    launch<T, VEC, KH, KW>(x, w, out, g, s);                   \
    return true;                                               \
  }
  UNCR_DW_CASE(3, 3)
  UNCR_DW_CASE(1, 3)
  UNCR_DW_CASE(3, 1)
#undef UNCR_DW_CASE
  return false;
}

}  // namespace

// x [N,H,W,C], w [C,kh*kw], out [N,Ho,Wo,C] with Ho = H+pt+pb-kh+1 and
// Wo = W+pl+pr-kw+1; all contiguous in the dtype given by `dtype`. kh x kw
// is one of 3x3, 1x3, 3x1 (else cudaErrorInvalidValue).
extern "C" int uncr_dw_stencil(const void* x, const void* w, void* out, int N, int H, int W,
                               int C, int kh, int kw, int pt, int pb, int pl, int pr, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DwGeo g{N, H, W, C, H + pt + pb - kh + 1, W + pl + pr - kw + 1, pt, pl};
  // 16-byte channel vectors where C and the pointers allow, else one by one
  const bool vec_ok = aligned16(x) && aligned16(out);
  bool ok;
  if (dtype == kBFloat16)
    ok = vec_ok && C % 8 == 0 ? dispatch<__nv_bfloat16, 8>(kh, kw, x, w, out, g, s)
                              : dispatch<__nv_bfloat16, 1>(kh, kw, x, w, out, g, s);
  else if (dtype == kFloat32)
    ok = vec_ok && C % 4 == 0 ? dispatch<float, 4>(kh, kw, x, w, out, g, s)
                              : dispatch<float, 1>(kh, kw, x, w, out, g, s);
  else
    ok = false;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
