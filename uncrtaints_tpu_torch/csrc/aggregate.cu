// att_group temporal aggregation (kernel K1): forward and backward.
//
//   out[b,p,c] = sum_t attn[b,t,p, c / (C/heads)] * x[b,t,p,c]
//
// and, for the output gradient g[b,p,c],
//
//   dx[b,t,p,c]    = attn[b,t,p, c / (C/heads)] * g[b,p,c]
//   dattn[b,t,p,h] = sum_{c in head h} x[b,t,p,c] * g[b,p,c]
//
// x [B,T,P,C] and attn [B,T,P,heads] in one dtype (bf16 or fp32); products
// and the sum over T in fp32, one cast to the output dtype at the end.
//
// Replaces: uncrtaints_tpu/ops/pallas_aggregate.py att_group_aggregate
// (forward kernel _mk_kernel / _fwd_call) and _bwd_call / _mk_bwd_kernel
// (backward). The TPU kernels expand the head weights to channels with a 0/1
// selection matmul (and contract dattn with its transpose) to dodge a Mosaic
// lane relayout; a GPU thread reads the head weight directly, so that trick
// is gone.
//
// Bound: device memory. Per output element the forward reads T elements of
// x and T head weights and writes one element: about 1 FLOP per 2 bytes, far
// below the card's ~295 FLOP/byte balance point. The backward reads x and g
// and writes dx (each T * C elements a pixel) and dattn. So the kernels only
// have to keep enough bytes in flight, and spend few instructions a byte:
//
// - Both directions (att_group_bulk_kernel, BWD false / true) walk tiles
//   of pixels of one sample. In each frame t a tile's x is one contiguous
//   run of tile * C elements and its attn one of tile * heads (and in the
//   backward its g one run of tile * C); one thread issues each run as a 1-D
//   bulk copy (cp.async.bulk ... mbarrier::complete_tx::bytes, the TMA's
//   form without a tensor map) into a ring of kStages shared-memory stages
//   with one mbarrier each, so every frame of a tile is requested at once
//   and the copies of the next tiles are in flight while a tile is worked
//   on. The CTAs are persistent (as many as the SMs hold) and walk the
//   tiles. The threads read 16-byte vectors from shared memory and work in
//   registers: the forward sums over t and stores 16 bytes; the backward
//   stores T dx vectors of 16 bytes and sums dattn per head in the thread
//   (CG <= VEC) and across the CG / VEC lanes of a head with
//   __shfl_xor_sync (CG > VEC), then stores it once a head, or once for the
//   VEC / CG heads of a vector. (The other design, every frame's loads in
//   flight in registers, is tools/aggregate_regs_h100.cu;
//   tools/tune_aggregate_h100.py times the two.)
// - In both the head width CG is a template parameter for the widths 4, 8,
//   16 and 32 channels a head: a vector's head weight is one scalar a frame
//   (VEC / CG where a vector spans several heads) and its index a shift; the
//   only divisions are one a tile, for its sample and first pixel.
//
// Any other head width, a C that is not a whole number of 16-byte vectors,
// pointers off 16 bytes, attn runs that a bulk copy cannot move and T
// frames of 8 pixels that overfill a stage run the generic
// kernels at the end (one thread per vector or element of a pixel in the
// forward, per (pixel, head) in the backward, runtime indices). All keep
// the same roundings: products through __fmul_rn and the sum over t through
// __fadd_rn in t order, so the forward equals the plain version's fp32 sum;
// dx is one product; only dattn's sum over a head's channels may run in
// another order.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

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

// ---- bulk copies of each frame's run of a pixel tile
// The ring's depth and the bytes a stage holds at most. The port builds the
// defaults; tools/tune_aggregate_h100.py --sweep builds and times others.
#ifndef UNCR_K1_STAGES
#define UNCR_K1_STAGES 3
#endif
#ifndef UNCR_K1_STAGE_KB
#define UNCR_K1_STAGE_KB 32
#endif
constexpr int kStages = UNCR_K1_STAGES;
constexpr int kStageBudget = UNCR_K1_STAGE_KB * 1024;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// bytes (a multiple of 16, both addresses on 16 bytes) from device to shared
// memory; the copy's completion counts against the mbarrier's transactions
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The bulk-copy kernels, forward and (BWD) backward. A CTA walks tiles of
// `tile` pixels of one sample. Its stage holds, from the stage's start (in
// elements of T): the tile's T frames of x (tile * C each), in the backward
// the tile's g (tile * C), then the T runs of attn (tile * heads each);
// every run starts on 16 bytes, and stages are stage_bytes apart.
template <typename T, int CG, bool BWD>
__global__ void __launch_bounds__(kThreads)
    att_group_bulk_kernel(const T* __restrict__ x, const T* __restrict__ attn,
                          const T* __restrict__ g, T* __restrict__ out, T* __restrict__ dx,
                          T* __restrict__ da, int B, int T_, long long rows, int C, int heads,
                          int tile, unsigned stage_bytes) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int LANES = CG > VEC ? CG / VEC : 1;  // backward: lanes that share a head
  constexpr int HV = CG < VEC ? VEC / CG : 1;     // backward: heads a vector spans
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages];
  const long long per_b = (rows + tile - 1) / tile;
  const long long ntiles = B * per_b;
  const int nvec = C / VEC;
  const size_t attn_at = (static_cast<size_t>(T_) + BWD) * tile * C;  // elements

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0: request every run of tile tl into stage s
  auto issue = [&](long long tl, int s) {
    const long long b = tl / per_b, p0 = (tl % per_b) * tile;
    const long long n = rows - p0 < tile ? rows - p0 : tile;
    const unsigned xb = static_cast<unsigned>(n * C * sizeof(T));
    const unsigned ab = static_cast<unsigned>(n * heads * sizeof(T));
    T* st = reinterpret_cast<T*>(smem + static_cast<size_t>(s) * stage_bytes);
    // the stage's previous contents were read through the generic proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(&full[s], static_cast<unsigned>(T_) * (xb + ab) + (BWD ? xb : 0u));
    for (int k = 0; k < T_; ++k) {
      const long long fr = b * T_ + k;
      bulk_copy(st + static_cast<size_t>(k) * tile * C, x + (fr * rows + p0) * C, xb, &full[s]);
      bulk_copy(st + attn_at + static_cast<size_t>(k) * tile * heads,
                attn + (fr * rows + p0) * heads, ab, &full[s]);
    }
    if (BWD)
      bulk_copy(st + static_cast<size_t>(T_) * tile * C, g + (b * rows + p0) * C, xb, &full[s]);
  };

  if (threadIdx.x == 0)
    for (int s = 0; s < kStages; ++s) {
      const long long tl = blockIdx.x + static_cast<long long>(s) * gridDim.x;
      if (tl < ntiles) issue(tl, s);
    }

  int it = 0;
  for (long long tl = blockIdx.x; tl < ntiles; tl += gridDim.x, ++it) {
    const int s = it % kStages;
    mbar_wait(&full[s], static_cast<unsigned>((it / kStages) & 1));
    const long long b = tl / per_b, p0 = (tl % per_b) * tile;
    const int nv = static_cast<int>(rows - p0 < tile ? rows - p0 : tile) * nvec;
    const T* xs = reinterpret_cast<const T*>(smem + static_cast<size_t>(s) * stage_bytes);
    const T* as = xs + attn_at;
    auto x_of = [&](int k, int e) {
      return *reinterpret_cast<const uint4*>(xs + static_cast<size_t>(k) * tile * C + e);
    };
    if constexpr (!BWD) {
      T* o = out + (b * rows + p0) * C;
      for (int v = threadIdx.x; v < nv; v += kThreads) {
        const int e = v * VEC;  // element of the tile's run
        float acc[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
        for (int k = 0; k < T_; ++k) {
          const uint4 u = x_of(k, e);
          HeadWeights<T, CG> w;
          w.load(as + static_cast<size_t>(k) * tile * heads, e);
          // no FMA contraction: the same roundings as the plain version's
          // product-then-sum, in t order
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            acc[j] = __fadd_rn(acc[j], __fmul_rn(w.of_lane(j), lane_f32<T>(u, j)));
        }
        store_from_f32<T, VEC>(o + e, acc);
      }
    } else {
      const T* gs = xs + static_cast<size_t>(T_) * tile * C;
      // the same trips for every thread: the shuffles need every lane
      for (int v0 = 0; v0 < nv; v0 += kThreads) {
        const int v = v0 + threadIdx.x, e = v * VEC;
        const bool ok = v < nv;
        const uint4 graw = ok ? *reinterpret_cast<const uint4*>(gs + e) : make_uint4(0, 0, 0, 0);
        float gv[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) gv[j] = lane_f32<T>(graw, j);
        for (int k = 0; k < T_; ++k) {
          const uint4 u = ok ? x_of(k, e) : make_uint4(0, 0, 0, 0);
          HeadWeights<T, CG> w{};
          if (ok) w.load(as + static_cast<size_t>(k) * tile * heads, e);
          float dv[VEC], sh[HV];
#pragma unroll
          for (int q = 0; q < HV; ++q) sh[q] = 0.0f;
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            dv[j] = __fmul_rn(w.of_lane(j), gv[j]);
            const int q = CG < VEC ? j / CG : 0;
            sh[q] = __fadd_rn(sh[q], __fmul_rn(lane_f32<T>(u, j), gv[j]));
          }
          // a head over several lanes: a butterfly over them (each lane
          // adds the same two values in either order: the same bits)
#pragma unroll
          for (int o = 1; o < LANES; o <<= 1)
            sh[0] = __fadd_rn(sh[0], __shfl_xor_sync(0xffffffffu, sh[0], o));
          if (ok) {
            const long long fr = (b * T_ + k) * rows + p0;  // the tile's first pixel in frame k
            store_from_f32<T, VEC>(dx + fr * C + e, dv);
            if (LANES == 1 || (threadIdx.x & (LANES - 1)) == 0) {
              RawVec<T, HV> r;
#pragma unroll
              for (int q = 0; q < HV; ++q) r.v[q] = from_f32<T>(sh[q]);
              *reinterpret_cast<RawVec<T, HV>*>(da + fr * heads + e / CG) = r;
            }
          }
        }
      }
    }
    __syncthreads();  // every thread is done with stage s
    if (threadIdx.x == 0) {
      const long long next = tl + static_cast<long long>(kStages) * gridDim.x;
      if (next < ntiles) issue(next, s);
    }
  }
}

// The tile and stage size of the bulk-copy kernels for a shape: the largest
// power-of-two tile (at most 128 pixels) whose runs fit the stage budget,
// or tile 0 where a bulk copy cannot move the runs (it moves multiples of
// 16 bytes between 16-byte addresses: every run of attn, a whole tile's,
// the ragged last one's and a frame's, must be one) or 8 pixels overfill
// a stage.
struct BulkPlan {
  int tile;
  unsigned stage_bytes;
};

template <typename T>
BulkPlan bulk_plan(int T_, long long rows, int C, int heads, bool bwd) {
  const long long per_pixel =
      ((static_cast<long long>(T_) + bwd) * C + static_cast<long long>(T_) * heads) * sizeof(T);
  int tile = 128;
  while (tile > 8 && tile * per_pixel > kStageBudget) tile /= 2;
  const long long ab = static_cast<long long>(heads) * sizeof(T);
  if (tile * per_pixel > kStageBudget || (tile * ab) % 16 || ((rows % tile) * ab) % 16 ||
      (rows * ab) % 16)
    return {0, 0};
  return {tile, static_cast<unsigned>((tile * per_pixel + 127) / 128 * 128)};
}

template <typename T, int CG, bool BWD>
void launch_bulk(const BulkPlan& p, const void* x, const void* attn, const void* g, void* out,
                 void* dx, void* da, int B, int T_, long long rows, int C, int heads,
                 cudaStream_t stream) {
  const auto kernel = att_group_bulk_kernel<T, CG, BWD>;
  const int smem = kStages * static_cast<int>(p.stage_bytes);
  static int smem_set = 0, per_sm = 0;  // asked once for each stage size
  if (smem != smem_set) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    per_sm = per_sm > 0 ? per_sm : 1;
    smem_set = smem;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long ntiles = B * ((rows + p.tile - 1) / p.tile);
  const long long resident = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(ntiles < resident ? ntiles : resident);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(attn), static_cast<const T*>(g),
      static_cast<T*>(out), static_cast<T*>(dx), static_cast<T*>(da), B, T_, rows, C, heads,
      p.tile, p.stage_bytes);
}

// Launches the bulk-copy kernel where it takes the shape (a head width of
// 4, 8, 16 or 32 and a plan); false where it does not. The caller has
// checked the alignment of the pointers.
template <typename T, bool BWD>
bool bulk(const void* x, const void* attn, const void* g, void* out, void* dx, void* da, int B,
          int T_, long long rows, int C, int heads, cudaStream_t s) {
  const BulkPlan p = bulk_plan<T>(T_, rows, C, heads, BWD);
  if (p.tile == 0) return false;
  switch (C / heads) {
    case 4: launch_bulk<T, 4, BWD>(p, x, attn, g, out, dx, da, B, T_, rows, C, heads, s); break;
    case 8: launch_bulk<T, 8, BWD>(p, x, attn, g, out, dx, da, B, T_, rows, C, heads, s); break;
    case 16: launch_bulk<T, 16, BWD>(p, x, attn, g, out, dx, da, B, T_, rows, C, heads, s); break;
    case 32: launch_bulk<T, 32, BWD>(p, x, attn, g, out, dx, da, B, T_, rows, C, heads, s); break;
    default: return false;
  }
  return true;
}

// ---- the generic kernels: any head width, any alignment. One thread owns
// one (b, pixel, group of VEC channels) in the forward and one (b, pixel,
// head) in the backward, over a grid-stride loop; VEC is 16 bytes where C
// (the backward: the head width) allows and the pointers are aligned, else 1.
template <typename T, int VEC>
__global__ void att_group_kernel(const T* __restrict__ x, const T* __restrict__ attn,
                                 T* __restrict__ out, int B, int T_, long long rows,
                                 int C, int heads) {
  const int cg = C / heads;
  const int nvec = C / VEC;
  const long long total = static_cast<long long>(B) * rows * nvec;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c0 = static_cast<int>(i % nvec) * VEC;
    const long long bp = i / nvec;  // b * rows + pixel
    const long long b = bp / rows, pix = bp % rows;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
    for (int t = 0; t < T_; ++t) {
      const long long frame = (b * T_ + t) * rows + pix;
      float xv[VEC];
      load_f32<T, VEC>(x + frame * C + c0, xv);
      const T* a = attn + frame * heads;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        acc[j] = __fadd_rn(acc[j], __fmul_rn(to_f32(a[(c0 + j) / cg]), xv[j]));
    }
    store_from_f32<T, VEC>(out + bp * C + c0, acc);
  }
}

template <typename T, int VEC>
void launch(const void* x, const void* attn, void* out, int B, int T_, long long rows, int C,
            int heads, cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * rows * (C / VEC);
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < (1LL << 20) ? want : (1LL << 20));
  att_group_kernel<T, VEC><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(attn), static_cast<T*>(out), B, T_, rows,
      C, heads);
}

template <typename T, int VEC>
__global__ void att_group_bwd_kernel(const T* __restrict__ x, const T* __restrict__ attn,
                                     const T* __restrict__ g, T* __restrict__ dx,
                                     T* __restrict__ da, int B, int T_, long long rows, int C,
                                     int heads) {
  const int cg = C / heads;
  const long long total = static_cast<long long>(B) * rows * heads;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int h = static_cast<int>(i % heads);
    const long long bp = i / heads;  // b * rows + pixel
    const long long b = bp / rows, pix = bp % rows;
    const T* gp = g + bp * C + h * cg;
    for (int t = 0; t < T_; ++t) {
      const long long frame = (b * T_ + t) * rows + pix;
      const float a = to_f32(attn[frame * heads + h]);
      const long long off = frame * C + h * cg;
      float s = 0.0f;
      for (int k = 0; k < cg; k += VEC) {
        float gv[VEC], xv[VEC], dv[VEC];
        load_f32<T, VEC>(gp + k, gv);
        load_f32<T, VEC>(x + off + k, xv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          dv[j] = __fmul_rn(a, gv[j]);
          s = __fadd_rn(s, __fmul_rn(xv[j], gv[j]));
        }
        store_from_f32<T, VEC>(dx + off + k, dv);
      }
      da[frame * heads + h] = from_f32<T>(s);
    }
  }
}

template <typename T, int VEC>
void launch_bwd(const void* x, const void* attn, const void* g, void* dx, void* da, int B,
                int T_, long long rows, int C, int heads, cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * rows * heads;
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < (1LL << 20) ? want : (1LL << 20));
  att_group_bwd_kernel<T, VEC><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(attn), static_cast<const T*>(g),
      static_cast<T*>(dx), static_cast<T*>(da), B, T_, rows, C, heads);
}

template <typename T>
void aggregate(const void* x, const void* attn, void* out, int B, int T_, long long rows, int C,
               int heads, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec_ok = aligned16(x) && aligned16(out) && C % VEC == 0;
  if (vec_ok && aligned16(attn) &&
      bulk<T, false>(x, attn, nullptr, out, nullptr, nullptr, B, T_, rows, C, heads, s))
    return;
  if (vec_ok)
    launch<T, VEC>(x, attn, out, B, T_, rows, C, heads, s);
  else
    launch<T, 1>(x, attn, out, B, T_, rows, C, heads, s);
}

template <typename T>
void aggregate_bwd(const void* x, const void* attn, const void* g, void* dx, void* da, int B,
                   int T_, long long rows, int C, int heads, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const int cg = C / heads;
  const bool vec_ok = aligned16(x) && aligned16(g) && aligned16(dx) && C % VEC == 0;
  // where a vector spans VEC / cg heads they leave as one store
  const unsigned da_bytes = sizeof(T) * (cg < VEC ? VEC / cg : 1);
  if (vec_ok && aligned16(attn) && aligned_to(da, da_bytes) &&
      bulk<T, true>(x, attn, g, nullptr, dx, da, B, T_, rows, C, heads, s))
    return;
  // a head's channels move as 16-byte vectors when its width in bytes is a
  // multiple of 16 and the tensors are 16-byte aligned
  if (vec_ok && cg % VEC == 0)
    launch_bwd<T, VEC>(x, attn, g, dx, da, B, T_, rows, C, heads, s);
  else
    launch_bwd<T, 1>(x, attn, g, dx, da, B, T_, rows, C, heads, s);
}

}  // namespace

// x [B,T,rows,C], attn [B,T,rows,heads], out [B,rows,C], all contiguous, in
// the dtype given by `dtype`; C % heads == 0 (checked by the wrapper).
extern "C" int uncr_att_group_aggregate(const void* x, const void* attn, void* out, int B,
                                        int T, long long rows, int C, int heads, int dtype,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    aggregate<__nv_bfloat16>(x, attn, out, B, T, rows, C, heads, s);
  else if (dtype == kFloat32)
    aggregate<float>(x, attn, out, B, T, rows, C, heads, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// x [B,T,rows,C], attn [B,T,rows,heads], g [B,rows,C] -> dx [B,T,rows,C],
// dattn [B,T,rows,heads]; all contiguous in the dtype given by `dtype`,
// C % heads == 0 (checked by the wrapper).
extern "C" int uncr_att_group_aggregate_bwd(const void* x, const void* attn, const void* g,
                                            void* dx, void* dattn, int B, int T, long long rows,
                                            int C, int heads, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    aggregate_bwd<__nv_bfloat16>(x, attn, g, dx, dattn, B, T, rows, C, heads, s);
  else if (dtype == kFloat32)
    aggregate_bwd<float>(x, attn, g, dx, dattn, B, T, rows, C, heads, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
