// Shared helpers for the cvsteer_tpu_torch Hopper kernels.
//
// Every C entry point takes raw device pointers and the CUDA stream from
// PyTorch (ctypes passes both as void*), launches on that stream, never
// synchronises, allocates nothing, and returns cudaGetLastError() so the
// Python wrapper can raise on a launch the CUDA runtime refused.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define CVS_EXPORT extern "C" __attribute__((visibility("default")))

// BORDER_REFLECT_101 index map (gfedcb|abcdefgh|gfedcba) that keeps
// reflecting, so it is valid for any offset: numpy/jnp.pad 'reflect'
// semantics, which stay defined where the pad reaches past the whole
// dimension (tiny pyramid levels). The pattern is periodic with period
// 2(n-1); n == 1 maps everything to 0.
__device__ __forceinline__ int reflect101(int i, int n) {
    if (n == 1) return 0;
    const int period = 2 * (n - 1);
    if (i < -period || i >= period) i %= period;  // one reflection needs no division
    if (i < 0) i += period;
    return i < n ? i : period - i;
}

__host__ __device__ __forceinline__ int ceil_div(int a, int b) {
    return (a + b - 1) / b;
}

// ---------------------------------------------------------------------------
// Separable banks: the sum order
//
// Kernels A, C, E and F share one sum-order contract with their plain
// versions (ops/sepconv.py::filter_bank_plain, ops/cuda_frontend.py): a row
// pass, then a column pass, each summing its taps in order from t = 0 with
// one rounding per operation (the library builds with --fmad=false).
// strip_pass below writes that order for A, C and E (bank_core.cuh);
// strip_pass_flip writes its transpose for F (filter_bank_adj.cu).
// ---------------------------------------------------------------------------

constexpr int kBankMaxK = 11;
constexpr int kBankMaxT = 17;

// ---------------------------------------------------------------------------
// Kernel F's taps: passed by value, one bank per launch
// ---------------------------------------------------------------------------

// The taps of one bank, passed by value as a kernel parameter: the hardware
// keeps it in the constant bank and broadcasts it to a warp, and each launch
// carries its own taps, so banks with different taps never share a symbol.
struct SepTaps {
    float x[kBankMaxK][kBankMaxT];
    float y[kBankMaxK][kBankMaxT];
};

// Host side: the [k, t] row-major tap arrays into a SepTaps.
inline SepTaps pack_taps(const float* xtaps, const float* ytaps, int k, int t) {
    SepTaps taps = {};
    for (int i = 0; i < k; ++i) {
        for (int j = 0; j < t; ++j) {
            taps.x[i][j] = xtaps[i * t + j];
            taps.y[i][j] = ytaps[i * t + j];
        }
    }
    return taps;
}

// ---------------------------------------------------------------------------
// Register-blocked passes (kernels A, C and E)
//
// The bank's sum order (taps ascending from t = 0, the first product not
// added to zero), with a thread computing a strip of P outputs from a window
// of P + T - 1 staged values that it reads from shared memory once into
// registers: each staged value is read once per strip and filter instead of
// once per tap. T is a compile-time constant so the window stays in
// registers.
// ---------------------------------------------------------------------------

// P consecutive outputs of the correlation with taps[0..T) from the window
// win[0 .. P + T - 1): out[p] = sum_t taps[t] win[p + t].
template <int T, int P>
__device__ __forceinline__ void strip_pass(const float (&win)[P + T - 1], const float* taps,
                                           float (&out)[P]) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
        float a = win[p] * taps[0];
#pragma unroll
        for (int t = 1; t < T; ++t) a = a + win[p + t] * taps[t];
        out[p] = a;
    }
}

// The transposed twin of strip_pass (kernel F, the bank's adjoint): P
// consecutive outputs of the correlation with the flipped taps,
// out[p] = sum_t taps[t] win[p + T - 1 - t], taps ascending from t = 0 —
// the order of the plain adjoint's shift-and-accumulate.
template <int T, int P>
__device__ __forceinline__ void strip_pass_flip(const float (&win)[P + T - 1], const float* taps,
                                                float (&out)[P]) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
        float a = win[p + T - 1] * taps[0];
#pragma unroll
        for (int t = 1; t < T; ++t) a = a + win[p + T - 1 - t] * taps[t];
        out[p] = a;
    }
}

// Stage rows [y_org, y_org + th) x columns [x_org, x_org + tw) of one plane
// into a shared buffer of row stride ld, REFLECT_101 outside the plane: one
// warp per row, its lanes along the row, so the row's reflected index is
// computed once and the loads are coalesced; no division per element.
__device__ __forceinline__ void stage_reflect(float* __restrict__ dst, int ld,
                                              const float* __restrict__ src, int h, int w,
                                              int y_org, int x_org, int th, int tw) {
    const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
    for (int ty = threadIdx.x >> 5; ty < th; ty += warps) {
        const int gy = y_org + ty;
        const float* row = src + (size_t)((unsigned)gy < (unsigned)h ? gy : reflect101(gy, h)) * w;
        float* out = dst + ty * ld;
        for (int tx = lane; tx < tw; tx += 32) {
            const int gx = x_org + tx;
            out[tx] = row[(unsigned)gx < (unsigned)w ? gx : reflect101(gx, w)];
        }
    }
}

// stage_reflect with every load of a thread issued before its first store
// (kernel B). kCoherent reads through L2 only (ld.global.cg), never the
// read-only path: for a plane that other blocks of the same launch wrote.
// The region is at most TH x TW (th <= TH, tw <= TW, known when compiled),
// so a thread's ceil(TH / WARPS) x ceil(TW / 32) loads unroll into registers
// and are in flight together, instead of one load's latency per element.
template <int TH, int TW, int WARPS, bool kCoherent = false>
__device__ __forceinline__ void stage_reflect_batch(float* __restrict__ dst, int ld,
                                                    const float* __restrict__ src, int h, int w,
                                                    int y_org, int x_org, int th, int tw) {
    constexpr int kRows = (TH + WARPS - 1) / WARPS, kCols = (TW + 31) / 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float v[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        const int ty = warp + r * WARPS, gy = y_org + ty;
        const float* row = src + (size_t)((unsigned)gy < (unsigned)h ? gy : reflect101(gy, h)) * w;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
            const int tx = lane + 32 * c, gx = x_org + tx;
            if (ty < th && tx < tw) {
                const float* p = row + ((unsigned)gx < (unsigned)w ? gx : reflect101(gx, w));
                v[r][c] = kCoherent ? __ldcg(p) : *p;
            }
        }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        const int ty = warp + r * WARPS;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
            const int tx = lane + 32 * c;
            if (ty < th && tx < tw) dst[ty * ld + tx] = v[r][c];
        }
    }
}

// 4-byte cp.async from device to shared memory; with valid false it reads
// nothing (src-size 0) and zero-fills the destination — the zero extension
// of kernel F's gradient planes. src must still be a mapped address.
__device__ __forceinline__ void cp_async_zfill4(float* dst, const float* src, bool valid) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(valid ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A release-acquire fence at device scope (fence.acq_rel.gpu): lighter than
// __threadfence's sequentially consistent one, and enough to publish a
// block's stores before an atomic ticket and to read what others published.
__device__ __forceinline__ void fence_acq_rel_gpu() {
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

// Lets `kernel` take `bytes` of dynamic shared memory (above 48 KB the
// runtime asks for it); `granted` is the caller's per-kernel record.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel* kernel, size_t bytes, size_t& granted) {
    if (bytes <= granted) return cudaSuccess;
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e == cudaSuccess) granted = bytes;
    return e;
}

// ---------------------------------------------------------------------------
// The G2 feature tail (kernels C and E′)
//
// From the 7 G2/H2 basis responses of one pixel: the corner score
// c1 - |(c2, c3)| and the half-angle orientation (ct, st) without any
// transcendental. The expressions and their order are those of the plain
// version (ops/cuda_frontend.py::g2_feature_maps_plain, the reference's
// _g2_feature_maps_reference_xla), one rounding per operation.
// ---------------------------------------------------------------------------

struct G2Features {
    float score, ct, st;
};

__device__ __forceinline__ G2Features g2_feature_tail(const float (&b)[7]) {
    const float g2a = b[0], g2b = b[1], g2c = b[2];
    const float h2a = b[3], h2b = b[4], h2c = b[5], h2d = b[6];
    const float c1 = 0.5f * (g2b * g2b) + 0.25f * (g2a * g2c)
                     + 0.375f * (g2a * g2a + g2c * g2c)
                     + 0.3125f * (h2a * h2a + h2d * h2d)
                     + 0.5625f * (h2b * h2b + h2c * h2c)
                     + 0.375f * (h2a * h2c + h2b * h2d);
    const float c2 = 0.5f * (g2a * g2a - g2c * g2c)
                     + 0.46875f * (h2a * h2a - h2d * h2d)
                     + 0.28125f * (h2b * h2b - h2c * h2c)
                     + 0.1875f * (h2a * h2c - h2b * h2d);
    const float c3 = -(g2a * g2b) - g2b * g2c - 0.9375f * (h2c * h2d + h2a * h2b)
                     - 1.6875f * h2b * h2c - 0.1875f * h2a * h2d;
    const float rho = sqrtf(c2 * c2 + c3 * c3);
    const float inv_rho = rho > 0.0f ? 1.0f / rho : 0.0f;
    const float cos2t = rho > 0.0f ? c2 * inv_rho : 1.0f;
    const float ct = sqrtf(fmaxf(0.5f * (1.0f + cos2t), 0.0f));
    const float st_mag = sqrtf(fmaxf(0.5f * (1.0f - cos2t), 0.0f));
    return {c1 - rho, ct, c3 >= 0.0f ? st_mag : -st_mag};
}
