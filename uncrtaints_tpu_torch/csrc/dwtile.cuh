// The shared-memory row ring of the tiled depthwise kernels (K5 in
// dwconv.cu, K2 in dwgrad.cu): tile sizes, cp.async staging with the border
// rule on the copy, the per-thread patch layout and the grid size.
//
// A block works through items of DW_ROWS output rows x DW_WT output columns
// x 128 bytes of channels (64 in bf16, 32 in fp32) of one frame. It walks an
// item downwards in bands of DW_R rows. The input rows a band needs (DW_R + 2
// with the 3x3 halo, DW_WT + 2 columns) live in a ring of row slabs in shared
// memory; the DW_R new rows of the next band are copied (cp.async, 16 bytes a
// lane, straight from device memory into shared memory) while the block sums
// the current band, so every input row is read once per item and the copies
// of one band are in flight during the arithmetic of the band before. The
// border costs nothing extra: a pixel outside the map is a zero fill of the
// copy (zero pads) or the copy of the mirrored pixel (reflect).
//
// A thread sums a patch of DW_R rows x PCW columns x CV channels. It walks
// the patch's PCW + 2 input columns once: per column it reads DW_R + 2
// vectors from the ring, converts them to fp32 once, and multiplies them
// into the sums of the up to three patch columns they reach, so a value is
// converted 1.5 x 1.5 times per output instead of nine, and the weights (or
// the sums, for K2) stay in registers.
#pragma once

#include "common.cuh"

// The sizes below can be set on the compiler's command line
// (-DUNCR_DW_ROWS=32 ...): tools/tune_dw_h100.py builds and times variants.
#ifndef UNCR_DW_THREADS
#define UNCR_DW_THREADS 128
#endif
#ifndef UNCR_DW_R
#define UNCR_DW_R 4
#endif
#ifndef UNCR_DW_WT
#define UNCR_DW_WT 32
#endif
#ifndef UNCR_DW_ROWS
#define UNCR_DW_ROWS 16
#endif
#ifndef UNCR_DW_AHEAD
#define UNCR_DW_AHEAD 1
#endif
#ifndef UNCR_DW_MINB
#define UNCR_DW_MINB 1
#endif
constexpr int DW_AHEAD = UNCR_DW_AHEAD;      // bands copied ahead of the one summed
constexpr int DW_MINB = UNCR_DW_MINB;        // resident blocks the registers must allow
constexpr int DW_THREADS = UNCR_DW_THREADS;  // threads of a block
constexpr int DW_R = UNCR_DW_R;              // output rows per band
constexpr int DW_WT = UNCR_DW_WT;            // output columns per item
constexpr int DW_ROWS = UNCR_DW_ROWS;        // output rows per item (4 bands)
static_assert(DW_ROWS % DW_R == 0, "an item is a whole number of bands");
constexpr int DW_CPP = 8;                  // 16-byte chunks per pixel of a tile
constexpr int DW_PIX = DW_CPP * 16;        // bytes per pixel of a tile
constexpr int DW_XCOLS = DW_WT + 2;        // tile columns with the halo
constexpr int DW_XSLOTS = (DW_AHEAD + 1) * DW_R + 2;  // ring slots for rows with halo
constexpr int DW_GSLOTS = (DW_AHEAD + 1) * DW_R;      // ring slots for rows without
#ifndef UNCR_DW_CV
#define UNCR_DW_CV 4
#endif

// how a block's threads split a band: TC threads across the tile's channels,
// LANES groups across its columns, PCW columns per thread
template <typename T>
struct DwPatch {
  static constexpr int EPC = 16 / sizeof(T);       // elements per 16-byte chunk
  static constexpr int CB = DW_CPP * EPC;          // channels per tile
  // channels per thread, at most one 16-byte vector of them
  static constexpr int CV = UNCR_DW_CV < EPC ? UNCR_DW_CV : EPC;
  static constexpr int TC = CB / CV;
  static constexpr int LANES = DW_THREADS / TC;
  static constexpr int PCW = DW_WT / LANES;
  static_assert(DW_THREADS % TC == 0 && DW_WT % LANES == 0, "patch layout");
};

// Start the copies of tile rows [t0, t1) into a ring of SLOTS row slabs of
// COLS pixels. Tile row t, column p is the pixel (row0 + t, col0 + p) of
// frame n of src [N,H,W,C], channels c0 .. c0 + CB. With reflect the pixel
// is mirrored into the map; otherwise a pixel outside it (and a channel
// chunk past C) is zero-filled. All THREADS threads of the block call it.
template <typename T, int COLS, int SLOTS, int THREADS = DW_THREADS>
__device__ __forceinline__ void dw_stage_rows(unsigned char* ring, const T* __restrict__ src,
                                              bool reflect, int n, int H, int W, int C, int row0,
                                              int col0, int c0, int t0, int t1) {
  constexpr int EPC = 16 / sizeof(T);
  constexpr int PER_ROW = COLS * DW_CPP;
  const int total = (t1 - t0) * PER_ROW;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int t = t0 + i / PER_ROW, rem = i % PER_ROW;
    const int p = rem / DW_CPP, q = rem % DW_CPP;
    int r = row0 + t, s = col0 + p;
    const int ch = c0 + q * EPC;
    bool ok = ch < C;
    if (reflect) {
      r = dw_mirror(r, H);
      s = dw_mirror(s, W);
    } else {
      ok = ok && r >= 0 && r < H && s >= 0 && s < W;
    }
    const T* from = ok ? src + ((static_cast<long long>(n) * H + r) * W + s) * C + ch : src;
    cp_async16(ring + ((t % SLOTS) * COLS + p) * DW_PIX + q * 16, from, ok);
  }
}

// blocks of a persistent grid: as many as the card holds at once (SM count
// x resident blocks of this kernel at `threads` a block), asked of the
// device, never more than there are items
template <typename Kernel>
int dw_resident_blocks(Kernel kernel, size_t smem, long long items, int threads = DW_THREADS) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  const long long fit = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  return static_cast<int>(fit < items ? fit : (items > 0 ? items : 1));
}
