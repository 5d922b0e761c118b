// Host slab writers of the input pipeline: one pass from a CHW frame
// straight into a row [H, W, dstC] of a batch slab, at a channel offset (the
// caller passes dst already offset), so batch assembly needs no stack,
// concatenate or astype pass. Port of uncrtaints_tpu/native/preprocess.cpp
// (its slab writers and its layout-only transpose).
//
// The uint16 digital numbers of Sentinel-2 go through a 65536-entry lookup
// table built in Python (uncrtaints_tpu_torch/native/__init__.py): exact to
// the numpy radiometry, bf16 entries rounded to nearest even by torch, so
// the LUT paths do no float arithmetic here. float32 -> bf16 rounds to
// nearest even in f32_to_bf16.
//
// A plain shared library with a C interface (no Python header), built with
// g++ -O3 at first use and bound with ctypes, which releases the interpreter
// lock for the call: the loader's threads write their frames in parallel
// while the main thread launches the step. No OpenMP inside (the JAX
// package's copy has it): the loader's threads are the parallelism, and a
// toolchain without libgomp builds it too.

#include <cstdint>
#include <cstddef>

// Pixel-blocked transpose: for each block of BP pixels, stream each
// channel's contiguous segment once and write the interleaved HWC block.
template <typename SrcT, typename DstT, typename Op>
static inline void chw_to_hwc_slab(const SrcT* src, DstT* dst,
                                   int64_t C, int64_t HW, int64_t dstC,
                                   Op op) {
    constexpr int64_t BP = 256;
    for (int64_t p0 = 0; p0 < HW; p0 += BP) {
        const int64_t n = (p0 + BP <= HW) ? BP : (HW - p0);
        for (int64_t c = 0; c < C; ++c) {
            const SrcT* in = src + c * HW + p0;
            DstT* out = dst + p0 * dstC + c;
            for (int64_t i = 0; i < n; ++i) out[i * dstC] = op(in[i]);
        }
    }
}

static inline uint16_t f32_to_bf16(float f) {
    uint32_t x;
    __builtin_memcpy(&x, &f, 4);
    // round to nearest even (inputs are pre-sanitized; no NaN handling)
    x += 0x7fffu + ((x >> 16) & 1u);
    return (uint16_t)(x >> 16);
}

extern "C" {

void f32_chw_to_hwc(const float* src, float* dst,
                    int64_t C, int64_t H, int64_t W) {
    chw_to_hwc_slab(src, dst, C, H * W, C, [](float v) { return v; });
}

void u16_lut_chw_to_hwc_slab_f32(const uint16_t* src, const float* lut,
                                 float* dst, int64_t C, int64_t H,
                                 int64_t W, int64_t dstC) {
    chw_to_hwc_slab(src, dst, C, H * W, dstC,
                    [lut](uint16_t v) { return lut[v]; });
}

void u16_lut_chw_to_hwc_slab_u16(const uint16_t* src, const uint16_t* lut,
                                 uint16_t* dst, int64_t C, int64_t H,
                                 int64_t W, int64_t dstC) {
    chw_to_hwc_slab(src, dst, C, H * W, dstC,
                    [lut](uint16_t v) { return lut[v]; });
}

void f32_chw_to_hwc_slab_f32(const float* src, float* dst, int64_t C,
                             int64_t H, int64_t W, int64_t dstC) {
    chw_to_hwc_slab(src, dst, C, H * W, dstC, [](float v) { return v; });
}

// Raw-DN shipping: uint16 digital numbers go into a uint16 slab untouched;
// the radiometry runs on the device (train/engine.py:_prepare_xy).
void u16_chw_to_hwc_slab_u16(const uint16_t* src, uint16_t* dst, int64_t C,
                             int64_t H, int64_t W, int64_t dstC) {
    chw_to_hwc_slab(src, dst, C, H * W, dstC, [](uint16_t v) { return v; });
}

void f32_chw_to_hwc_slab_bf16(const float* src, uint16_t* dst, int64_t C,
                              int64_t H, int64_t W, int64_t dstC) {
    chw_to_hwc_slab(src, dst, C, H * W, dstC,
                    [](float v) { return f32_to_bf16(v); });
}

}  // extern "C"
