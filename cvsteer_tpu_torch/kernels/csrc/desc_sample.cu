// Kernel D: bilinear descriptor sampling for every pyramid level of a frame
// in one launch: each level's basis [B, C, H_l, W_l] at the coordinates
// ys/xs [B, K, S] of its keypoints (the K keypoints are the levels'
// keypoints one after the other) -> samples [B, K, S, C].
//
// Replaces: cvsteer_tpu/ops/pallas_desc.py::bilinear_sample_patch_dma
// (sample_patches_pallas, _desc_patch_kernel). The TPU kernel copied a
// 32x384-lane bf16 window per keypoint into VMEM and interpolated with an
// MXU product against hat-weight masks, a shape that served the TPU's DMA
// tiling. Here every corner is an fp32 read, with coordinates clipped to
// the image as the TPU wrapper clips them: at least as accurate as the
// TPU's bf16 class. Plain version: ops/cuda_desc.py::sample_patches_plain.
//
// What bounds it on the card: latency. At the main path's 5 levels x 256
// keypoints x 16 samples x 7 channels it reads 4 x 143k corner values
// (2.3 MB counted per corner, far less as distinct bytes) and writes
// 573 KB; the time goes to dependent loads (the coordinates, then the
// corners) and, launched per level, to five launches that each fill less
// than one wave of the 132 SMs.
//
// What the design does about it: one launch per frame over all levels'
// keypoints (1,280 at the main path's shapes, in 320 blocks), levels found
// from a table of pointers and keypoint offsets passed by value. A warp
// takes one keypoint: its lanes load the S coordinates at once, clip them,
// and reduce the bounding box of the corners (the 4x4 grid at spacing 3
// spans at most 15x15 pixels); the warp then copies that window of all C
// channels into shared memory with cp.async (16-byte copies where the rows
// are 16-byte aligned, 4-byte ones elsewhere) in coalesced rows, and
// interpolates from shared memory, writing the keypoint's S x C outputs
// contiguously. A cloud whose window would not fit the warp's buffer reads
// its corners from device memory directly: any coordinates stay right.
//
// Channels: the G2/H2 basis has C = 7, the G4/H4 basis C = 11 (the TPU ran
// the same Pallas kernel with 16 lanes a sample for it). The window buffer
// is dynamic shared memory sized by C, 15 rows x 24 columns x C floats a
// warp rounded up to 128 floats (40 KB a block at C = 7, 62 KB at C = 11,
// above the 48 KB default, so the launch opts in), so both bases' 15x15
// clouds stage; C is at most kMaxC.
//
// Bits: the corner expressions and their order are the plain version's
// (one rounding per operation, --fmad=false).
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxLevels = 16;
constexpr int kMaxS = 64;
constexpr int kMaxC = 16;
// floats of window per warp: 15 rows x 24 columns x C, rounded up to 128
constexpr int window_floats(int c) { return (15 * 24 * c + 127) / 128 * 128; }

struct DescLevels {
    const float* basis[kMaxLevels];
    int h[kMaxLevels], w[kMaxLevels];
    int first_kp[kMaxLevels + 1];  // level l holds keypoints [first_kp[l], first_kp[l + 1])
    int n_levels;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
desc_sample_kernel(const __grid_constant__ DescLevels L, const float* __restrict__ ys,
                   const float* __restrict__ xs, float* __restrict__ out, int B, int C, int K,
                   int S, int per_warp) {
    extern __shared__ __align__(16) float window[];  // kWarps x per_warp floats
    __shared__ int corner_y[kWarps][kMaxS], corner_x[kWarps][kMaxS];
    __shared__ float weight_y[kWarps][kMaxS], weight_x[kWarps][kMaxS];

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long q = (long long)blockIdx.x * kWarps + warp;  // keypoint over B*K
    if (q >= (long long)B * K) return;  // the whole warp: no block-wide sync below
    const int b = (int)(q / K), k = (int)(q - (long long)b * K);
    int l = 0;
    while (l + 1 < L.n_levels && k >= L.first_kp[l + 1]) ++l;
    const int H = L.h[l], W = L.w[l];
    const size_t plane = (size_t)H * W;
    const float* base = L.basis[l] + (size_t)b * C * plane;

    // 1. the samples' clipped coordinates and weights, and the corners' box
    int ylo = H, yhi = -1, xlo = W, xhi = -1;
    for (int s = lane; s < S; s += 32) {
        float y = ys[q * S + s];
        float x = xs[q * S + s];
        y = fminf(fmaxf(y, 0.0f), (float)(H - 1));
        x = fminf(fmaxf(x, 0.0f), (float)(W - 1));
        const float fy = floorf(y), fx = floorf(x);
        const int y0 = (int)fy, x0 = (int)fx;
        corner_y[warp][s] = y0;
        corner_x[warp][s] = x0;
        weight_y[warp][s] = y - fy;
        weight_x[warp][s] = x - fx;
        ylo = min(ylo, y0);
        yhi = max(yhi, min(y0 + 1, H - 1));
        xlo = min(xlo, x0);
        xhi = max(xhi, min(x0 + 1, W - 1));
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
        ylo = min(ylo, __shfl_xor_sync(0xffffffffu, ylo, m));
        yhi = max(yhi, __shfl_xor_sync(0xffffffffu, yhi, m));
        xlo = min(xlo, __shfl_xor_sync(0xffffffffu, xlo, m));
        xhi = max(xhi, __shfl_xor_sync(0xffffffffu, xhi, m));
    }

    // 2. stage the box of all C channels: rows of 16-byte copies where every
    // row starts 16-byte aligned (W % 4 == 0 and an aligned plane), else
    // rows of 4-byte copies
    const bool vec = (W % 4) == 0 && (reinterpret_cast<uintptr_t>(base) & 15) == 0;
    const int xa = vec ? (xlo & ~3) : xlo;
    const int wd = vec ? ((xhi + 4) & ~3) - xa : xhi + 1 - xa;  // window row width
    const int ht = yhi - ylo + 1;
    const bool staged = ht * wd * C <= per_warp;
    float* win = window + warp * per_warp;
    if (staged) {
        const int per_row = vec ? wd / 4 : wd;
        const int n = C * ht * per_row;
        for (int i = lane; i < n; i += 32) {
            const int row = i / per_row, j = i - row * per_row;  // row over (c, y)
            const int c = row / ht, y = row - c * ht;
            const float* src = base + c * plane + (size_t)(ylo + y) * W + xa;
            float* dst = win + row * wd;
            if (vec) {
                cp_async16(dst + 4 * j, src + 4 * j);
            } else {
                cp_async4(dst + j, src + j);
            }
        }
        cp_async_wait_all();
    }
    __syncwarp();

    // 3. interpolate: output j = s * C + c of the keypoint, contiguous
    float* o = out + q * S * C;
    for (int j = lane; j < S * C; j += 32) {
        const int s = j / C, c = j - s * C;
        const int y0 = corner_y[warp][s], x0 = corner_x[warp][s];
        const int y1 = min(y0 + 1, H - 1), x1 = min(x0 + 1, W - 1);
        const float wy = weight_y[warp][s], wx = weight_x[warp][s];
        float v00, v01, v10, v11;
        if (staged) {
            const float* p = win + c * ht * wd;
            v00 = p[(y0 - ylo) * wd + x0 - xa];
            v01 = p[(y0 - ylo) * wd + x1 - xa];
            v10 = p[(y1 - ylo) * wd + x0 - xa];
            v11 = p[(y1 - ylo) * wd + x1 - xa];
        } else {
            const float* p = base + c * plane;
            v00 = p[(size_t)y0 * W + x0];
            v01 = p[(size_t)y0 * W + x1];
            v10 = p[(size_t)y1 * W + x0];
            v11 = p[(size_t)y1 * W + x1];
        }
        const float top = v00 * (1.0f - wx) + v01 * wx;
        const float bot = v10 * (1.0f - wx) + v11 * wx;
        o[j] = top * (1.0f - wy) + bot * wy;
    }
}

}  // namespace

// bases: [n_levels] device pointers, each level's basis [b, c, h_l, w_l];
// hw: [n_levels, 2] (h, w); counts: [n_levels] keypoints per level, which
// sum to k; ys, xs: [b, k, s]; out: [b, k, s, c].
CVS_EXPORT int cvs_desc_sample(const long long* bases, const int* hw, const int* counts,
                               int n_levels, const float* ys, const float* xs, float* out, int b,
                               int c, int k, int s, void* stream) {
    if (n_levels < 1 || n_levels > kMaxLevels || b < 1 || c < 1 || c > kMaxC || k < 1 || s < 1 ||
        s > kMaxS) {
        return (int)cudaErrorInvalidValue;
    }
    DescLevels L = {};
    L.n_levels = n_levels;
    int first = 0;
    for (int l = 0; l < n_levels; ++l) {
        L.basis[l] = (const float*)bases[l];
        L.h[l] = hw[2 * l];
        L.w[l] = hw[2 * l + 1];
        if (L.h[l] < 1 || L.w[l] < 1 || counts[l] < 0) return (int)cudaErrorInvalidValue;
        L.first_kp[l] = first;
        first += counts[l];
    }
    if (first != k) return (int)cudaErrorInvalidValue;
    L.first_kp[n_levels] = first;
    const long long n_kp = (long long)b * k;
    const unsigned blocks = (unsigned)((n_kp + kWarps - 1) / kWarps);
    static size_t granted = 48 * 1024;
    const int per_warp = window_floats(c);
    const size_t bytes = sizeof(float) * kWarps * per_warp;
    const cudaError_t e = allow_smem(desc_sample_kernel, bytes, granted);
    if (e != cudaSuccess) return (int)e;
    desc_sample_kernel<<<blocks, kThreads, bytes, (cudaStream_t)stream>>>(L, ys, xs, out, b, c, k,
                                                                         s, per_warp);
    return (int)cudaGetLastError();
}
