// Kernel B: one Gaussian pyramid step, [N, H, W] -> [N, ceil(H/2), ceil(W/2)].
//
// Replaces: cvsteer_tpu/ops/pallas_frontend.py::pyr_down_pallas
// (_pyr_down_kernel). Semantics of cv2.pyrDown: the separable binomial
// blur [1, 4, 6, 4, 1] / 16 with BORDER_REFLECT_101, keeping even rows and
// columns. The TPU kernel only took 8-aligned heights and 128-aligned
// widths (the rest of the pyramid fell back to the bank + a strided
// slice); this one takes every shape, so every level uses it on the card.
//
// What bounds it on the card: memory traffic — 4 bytes read per input
// pixel, 1 byte written per input pixel, ~5 flops per input pixel.
//
// What the design does about it: each block stages the (2*16+3) x (2*32+3)
// input patch of a 16x32 output tile in shared memory once (reflected
// indices computed at load, nothing padded in device memory), blurs only
// the even columns in the row pass and only the even rows in the column
// pass (the decimation costs nothing), and writes the output once. The
// sums run in the order of the plain version (row pass, then column pass,
// taps in order), so with separately rounded multiply-adds the result is
// the plain version's to the bit.
#include "common.cuh"

namespace {

constexpr int kTileW = 32;  // output tile
constexpr int kTileH = 16;
constexpr int kInW = 2 * kTileW + 3;
constexpr int kInH = 2 * kTileH + 3;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pyr_down_kernel(const float* __restrict__ in, float* __restrict__ out,
                int h, int w, int ho, int wo) {
    __shared__ float tile[kInH][kInW];
    __shared__ float rows[kInH][kTileW];
    const float taps[5] = {0.0625f, 0.25f, 0.375f, 0.25f, 0.0625f};

    const int ox0 = blockIdx.x * kTileW;
    const int oy0 = blockIdx.y * kTileH;
    const int img = blockIdx.z;
    const int tid = threadIdx.x;
    const float* src = in + (size_t)img * h * w;
    const int sy0 = 2 * oy0 - 2;
    const int sx0 = 2 * ox0 - 2;

    for (int i = tid; i < kInH * kInW; i += kThreads) {
        const int ty = i / kInW, tx = i % kInW;
        tile[ty][tx] = src[(size_t)reflect101(sy0 + ty, h) * w + reflect101(sx0 + tx, w)];
    }
    __syncthreads();
    for (int i = tid; i < kInH * kTileW; i += kThreads) {
        const int ty = i / kTileW, j = i % kTileW;
        float acc = tile[ty][2 * j] * taps[0];
        for (int v = 1; v < 5; ++v) acc = acc + tile[ty][2 * j + v] * taps[v];
        rows[ty][j] = acc;
    }
    __syncthreads();
    float* dst = out + (size_t)img * ho * wo;
    for (int i = tid; i < kTileH * kTileW; i += kThreads) {
        const int oy = i / kTileW, ox = i % kTileW;
        const int gy = oy0 + oy, gx = ox0 + ox;
        if (gy < ho && gx < wo) {
            float acc = rows[2 * oy][ox] * taps[0];
            for (int u = 1; u < 5; ++u) acc = acc + rows[2 * oy + u][ox] * taps[u];
            dst[(size_t)gy * wo + gx] = acc;
        }
    }
}

}  // namespace

CVS_EXPORT int cvs_pyr_down(const float* in, float* out, int n, int h, int w, void* stream) {
    if (n < 1 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
    const int ho = ceil_div(h, 2), wo = ceil_div(w, 2);
    dim3 grid(ceil_div(wo, kTileW), ceil_div(ho, kTileH), n);
    pyr_down_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(in, out, h, w, ho, wo);
    return (int)cudaGetLastError();
}
