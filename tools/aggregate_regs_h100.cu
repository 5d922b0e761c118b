// K1 (forward and backward) in the other design measured against the
// port's (csrc/aggregate.cu, bulk copies into shared memory): every frame's
// loads in flight in registers. Built only by tools/tune_aggregate_h100.py,
// which times it beside the port's kernels; the port never builds or loads
// it. The function and its roundings are the port's.
//
// Forward: a thread owns NV = 2 16-byte vectors of channels (neighbouring threads on
// neighbouring vectors) and issues the 16-byte loads of up to kFrames frames
// of both (__ldcs, x is read once) before its first add; the head width CG
// is a template parameter, so a vector's head weight is one scalar load a
// frame (VEC / CG where a vector spans several heads) and no index needs a
// division; the CTAs are persistent (the SMs x the CTAs an SM holds, the
// samples in gridDim.y).
// Backward: a thread owns one 16-byte vector, reads g once, issues the x
// loads of up to kFrames frames before it uses them and writes T dx vectors
// as 16-byte stores; dattn is summed per head in the thread and across the
// lanes of a head with __shfl_xor_sync, then one store a head (or one store
// of the heads a vector spans).
//
// The C entry points are the port's; they take C a whole number of 16-byte
// vectors, x, g, dx and out on 16 bytes and head widths 4, 8, 16 and 32,
// and return cudaErrorInvalidValue for anything else.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = 4;  // frames whose loads a thread issues before it adds

// 16 bytes of x, read once: evict first from L1 and L2
template <typename T>
__device__ __forceinline__ uint4 load_stream(const T* p) {
  return __ldcs(reinterpret_cast<const uint4*>(p));
}

template <typename T>
__device__ __forceinline__ float lane_f32(const uint4& u, int j) {
  return to_f32(reinterpret_cast<const T*>(&u)[j]);
}

// The head weights of one vector of VEC channels in one frame, at head
// width CG: one weight where the vector lies in one head (CG a multiple of
// VEC), else the VEC / CG weights of the heads it spans.
template <typename T, int CG>
struct HeadWeights {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int N = CG >= VEC ? 1 : VEC / CG;
  float w[N];
  // the weights of the vector whose first element is element e of the
  // frame (attn points at the frame's first weight)
  __device__ __forceinline__ void load(const T* __restrict__ attn, long long e) {
    const T* p = attn + static_cast<unsigned long long>(e) / CG;
#pragma unroll
    for (int q = 0; q < N; ++q) w[q] = to_f32(p[q]);
  }
  __device__ __forceinline__ float of_lane(int j) const { return w[CG >= VEC ? 0 : j / CG]; }
};

// the resident CTAs of a kernel over all SMs (its occupancy is asked once)
template <typename K>
int resident_ctas(K kernel, int& per_sm) {
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    per_sm = per_sm > 0 ? per_sm : 1;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms * per_sm;
}

// persistent grid: gridDim.y walks the samples, gridDim.x the work items of
// one sample; together about `resident` CTAs
dim3 persistent_grid(int resident, int B, long long items_per_b) {
  const int gy = B < 65535 ? B : 65535;
  long long gx = resident / gy;
  gx = gx < 1 ? 1 : gx;
  gx = gx < items_per_b ? gx : items_per_b;
  return dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
}

// ---- forward, 16-byte vectors, head width CG
// fvec: vectors of x in one frame (P * C / VEC); fatt: weights in one frame
// (P * heads)
template <typename T, int CG>
__global__ void __launch_bounds__(kThreads)
    att_group_vec_kernel(const T* __restrict__ x, const T* __restrict__ attn,
                         T* __restrict__ out, int B, int T_, long long fvec, long long fatt) {
  constexpr int VEC = 16 / sizeof(T), NV = 2;
  constexpr long long kTile = NV * kThreads;
  const long long step = static_cast<long long>(gridDim.x) * kTile;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    for (long long base = blockIdx.x * kTile; base < fvec; base += step) {
      long long v[NV];
      bool ok[NV];
      float acc[NV][VEC];
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        v[n] = base + n * kThreads + threadIdx.x;
        ok[n] = v[n] < fvec;
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[n][j] = 0.0f;
      }
      for (int t0 = 0; t0 < T_; t0 += kFrames) {
        uint4 raw[kFrames][NV];
        HeadWeights<T, CG> w[kFrames][NV];
        // every load of the chunk before the first add
#pragma unroll
        for (int k = 0; k < kFrames; ++k) {
          const long long fr = static_cast<long long>(b) * T_ + t0 + k;
#pragma unroll
          for (int n = 0; n < NV; ++n)
            if (t0 + k < T_ && ok[n]) {
              raw[k][n] = load_stream(x + (fr * fvec + v[n]) * VEC);
              w[k][n].load(attn + fr * fatt, v[n] * VEC);
            }
        }
        // no FMA contraction: the same roundings as the plain version's
        // product-then-sum, in t order
#pragma unroll
        for (int k = 0; k < kFrames; ++k)
#pragma unroll
          for (int n = 0; n < NV; ++n)
            if (t0 + k < T_ && ok[n])
#pragma unroll
              for (int j = 0; j < VEC; ++j)
                acc[n][j] = __fadd_rn(acc[n][j],
                                      __fmul_rn(w[k][n].of_lane(j), lane_f32<T>(raw[k][n], j)));
      }
#pragma unroll
      for (int n = 0; n < NV; ++n)
        if (ok[n]) store_from_f32<T, VEC>(out + (static_cast<long long>(b) * fvec + v[n]) * VEC,
                                          acc[n]);
    }
  }
}

template <typename T, int CG>
void launch_vec(const void* x, const void* attn, void* out, int B, int T_, long long rows,
                int C, int heads, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  static int per_sm = 0;
  const long long fvec = rows * (C / VEC);
  const int resident = resident_ctas(att_group_vec_kernel<T, CG>, per_sm);
  const dim3 grid = persistent_grid(resident, B, (fvec + 2 * kThreads - 1) / (2 * kThreads));
  att_group_vec_kernel<T, CG><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(attn), static_cast<T*>(out), B, T_, fvec,
      rows * heads);
}

// ---- backward, one 16-byte vector a thread, head width CG
template <typename T, int CG>
__global__ void __launch_bounds__(kThreads)
    att_group_bwd_vec_kernel(const T* __restrict__ x, const T* __restrict__ attn,
                             const T* __restrict__ g, T* __restrict__ dx, T* __restrict__ da,
                             int B, int T_, long long fvec, long long fatt) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int LANES = CG > VEC ? CG / VEC : 1;  // lanes that share a head
  constexpr int HV = CG < VEC ? VEC / CG : 1;     // heads a vector spans
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    // base is the same for every thread of the CTA, so every lane of a warp
    // runs the same iterations and takes part in the shuffles
    for (long long base = blockIdx.x * static_cast<long long>(kThreads); base < fvec;
         base += step) {
      const long long v = base + threadIdx.x;
      const bool ok = v < fvec;
      float gv[VEC];
      if (ok) {
        const uint4 graw = load_stream(g + (static_cast<long long>(b) * fvec + v) * VEC);
#pragma unroll
        for (int j = 0; j < VEC; ++j) gv[j] = lane_f32<T>(graw, j);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) gv[j] = 0.0f;
      }
      for (int t0 = 0; t0 < T_; t0 += kFrames) {
        uint4 raw[kFrames];
        HeadWeights<T, CG> w[kFrames];
#pragma unroll
        for (int k = 0; k < kFrames; ++k) {
          const long long fr = static_cast<long long>(b) * T_ + t0 + k;
          if (t0 + k < T_ && ok) {
            raw[k] = load_stream(x + (fr * fvec + v) * VEC);
            w[k].load(attn + fr * fatt, v * VEC);
          } else {
            raw[k] = make_uint4(0u, 0u, 0u, 0u);
            w[k] = HeadWeights<T, CG>{};
          }
        }
#pragma unroll
        for (int k = 0; k < kFrames; ++k) {
          if (t0 + k >= T_) break;  // the same for every lane
          const long long fr = static_cast<long long>(b) * T_ + t0 + k;
          float dv[VEC], s[HV];
#pragma unroll
          for (int q = 0; q < HV; ++q) s[q] = 0.0f;
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            dv[j] = __fmul_rn(w[k].of_lane(j), gv[j]);
            const int q = CG < VEC ? j / CG : 0;
            s[q] = __fadd_rn(s[q], __fmul_rn(lane_f32<T>(raw[k], j), gv[j]));
          }
          // a head over several lanes: a butterfly over them (each lane
          // adds the same two values in either order: the same bits)
#pragma unroll
          for (int o = 1; o < LANES; o <<= 1)
            s[0] = __fadd_rn(s[0], __shfl_xor_sync(0xffffffffu, s[0], o));
          if (ok) {
            store_from_f32<T, VEC>(dx + (fr * fvec + v) * VEC, dv);
            if (LANES == 1 || (threadIdx.x & (LANES - 1)) == 0) {
              RawVec<T, HV> r;
#pragma unroll
              for (int q = 0; q < HV; ++q) r.v[q] = from_f32<T>(s[q]);
              *reinterpret_cast<RawVec<T, HV>*>(da + fr * fatt + v * VEC / CG) = r;
            }
          }
        }
      }
    }
  }
}

template <typename T, int CG>
void launch_bwd_vec(const void* x, const void* attn, const void* g, void* dx, void* da, int B,
                    int T_, long long rows, int C, int heads, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  static int per_sm = 0;
  const long long fvec = rows * (C / VEC);
  const int resident = resident_ctas(att_group_bwd_vec_kernel<T, CG>, per_sm);
  const dim3 grid = persistent_grid(resident, B, (fvec + kThreads - 1) / kThreads);
  att_group_bwd_vec_kernel<T, CG><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(attn), static_cast<const T*>(g),
      static_cast<T*>(dx), static_cast<T*>(da), B, T_, fvec, rows * heads);
}

template <typename T>
int aggregate_regs_bwd(const void* x, const void* attn, const void* g, void* dx, void* da, int B,
                       int T_, long long rows, int C, int heads, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const int cg = C / heads;
  const unsigned da_bytes = sizeof(T) * (cg < VEC ? VEC / cg : 1);
  if (!(aligned16(x) && aligned16(g) && aligned16(dx) && C % VEC == 0 &&
        aligned_to(da, da_bytes)))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (cg) {
    case 4: launch_bwd_vec<T, 4>(x, attn, g, dx, da, B, T_, rows, C, heads, s); break;
    case 8: launch_bwd_vec<T, 8>(x, attn, g, dx, da, B, T_, rows, C, heads, s); break;
    case 16: launch_bwd_vec<T, 16>(x, attn, g, dx, da, B, T_, rows, C, heads, s); break;
    case 32: launch_bwd_vec<T, 32>(x, attn, g, dx, da, B, T_, rows, C, heads, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int aggregate_regs(const void* x, const void* attn, void* out, int B, int T_, long long rows,
                   int C, int heads, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  if (!(aligned16(x) && aligned16(out) && C % VEC == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (C / heads) {
    case 4: launch_vec<T, 4>(x, attn, out, B, T_, rows, C, heads, s); break;
    case 8: launch_vec<T, 8>(x, attn, out, B, T_, rows, C, heads, s); break;
    case 16: launch_vec<T, 16>(x, attn, out, B, T_, rows, C, heads, s); break;
    case 32: launch_vec<T, 32>(x, attn, out, B, T_, rows, C, heads, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int uncr_att_group_aggregate(const void* x, const void* attn, void* out, int B,
                                        int T, long long rows, int C, int heads, int dtype,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return aggregate_regs<__nv_bfloat16>(x, attn, out, B, T, rows, C, heads, s);
  if (dtype == kFloat32) return aggregate_regs<float>(x, attn, out, B, T, rows, C, heads, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int uncr_att_group_aggregate_bwd(const void* x, const void* attn, const void* g,
                                            void* dx, void* dattn, int B, int T, long long rows,
                                            int C, int heads, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return aggregate_regs_bwd<__nv_bfloat16>(x, attn, g, dx, dattn, B, T, rows, C, heads, s);
  if (dtype == kFloat32)
    return aggregate_regs_bwd<float>(x, attn, g, dx, dattn, B, T, rows, C, heads, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
