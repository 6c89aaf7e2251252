// Kernel A: separable filter bank, image [N, H, W] -> basis [N, K, H, W].
//
// Replaces: cvsteer_tpu/ops/pallas_frontend.py::filter_bank_pallas
// (_bank_kernel) and ::bank_tiled_pallas (_bank_tiled_kernel). The TPU
// pair split whole-tile from row-tiled only to fit its VMEM budget; one
// tiled kernel serves every size here.
//
// Contract: cross-correlation, BORDER_REFLECT_101 (repeated reflection, so
// levels narrower than the pad stay defined), fp32 arithmetic; K <= 11
// filters of T <= 13 taps (G2/H2: K=7, T=9; blur5: K=1, T=5).
//
// What bounds it on the card: memory traffic. At 480x640 with the G2 bank
// it reads 1.2 MB and writes K x 1.2 = 8.6 MB, against 2*K*T = 126 flops
// per output pixel — about 4 flops per byte, far under the H100's ~20
// fp32 flops per byte of HBM bandwidth.
//
// What the design does about it: each block stages one 32x64 output tile
// plus its reflected halo in shared memory ONCE and runs all K filters
// from there (row pass into a shared row buffer, then the column pass), so
// the image is read from device memory once per tile and every output
// element is written exactly once, in coalesced rows. The taps travel as a
// by-value kernel parameter, which the hardware keeps in the constant bank
// and broadcasts to all threads of a warp; each launch carries its own
// taps, so banks with different taps never share a symbol.
#include "common.cuh"

namespace {

constexpr int kMaxK = 11;
constexpr int kMaxT = 13;
constexpr int kMaxR = (kMaxT - 1) / 2;
constexpr int kTileW = 64;
constexpr int kTileH = 32;
constexpr int kThreads = 256;

struct BankTaps {
    float x[kMaxK][kMaxT];
    float y[kMaxK][kMaxT];
};

__global__ void __launch_bounds__(kThreads)
filter_bank_kernel(const float* __restrict__ in, float* __restrict__ out,
                   int h, int w, int K, int T, const BankTaps taps) {
    __shared__ float tile[kTileH + 2 * kMaxR][kTileW + 2 * kMaxR];
    __shared__ float rows[kTileH + 2 * kMaxR][kTileW];

    const int r = (T - 1) / 2;
    const int x0 = blockIdx.x * kTileW;
    const int y0 = blockIdx.y * kTileH;
    const int img = blockIdx.z;
    const int tid = threadIdx.x;
    const float* src = in + (size_t)img * h * w;
    const int th = kTileH + 2 * r;
    const int tw = kTileW + 2 * r;

    for (int i = tid; i < th * tw; i += kThreads) {
        const int ty = i / tw, tx = i - (i / tw) * tw;
        const int gy = reflect101(y0 - r + ty, h);
        const int gx = reflect101(x0 - r + tx, w);
        tile[ty][tx] = src[(size_t)gy * w + gx];
    }
    __syncthreads();

    const size_t plane = (size_t)h * w;
    for (int k = 0; k < K; ++k) {
        // row pass over every staged row (the column pass needs the halo)
        for (int i = tid; i < th * kTileW; i += kThreads) {
            const int ty = i / kTileW, tx = i % kTileW;
            float acc = tile[ty][tx] * taps.x[k][0];
            for (int t = 1; t < T; ++t) acc = acc + tile[ty][tx + t] * taps.x[k][t];
            rows[ty][tx] = acc;
        }
        __syncthreads();
        float* dst = out + ((size_t)img * K + k) * plane;
        for (int i = tid; i < kTileH * kTileW; i += kThreads) {
            const int oy = i / kTileW, ox = i % kTileW;
            const int gy = y0 + oy, gx = x0 + ox;
            if (gy < h && gx < w) {
                float acc = rows[oy][ox] * taps.y[k][0];
                for (int t = 1; t < T; ++t) acc = acc + rows[oy + t][ox] * taps.y[k][t];
                dst[(size_t)gy * w + gx] = acc;
            }
        }
        __syncthreads();  // rows[] is rewritten by the next filter
    }
}

}  // namespace

CVS_EXPORT int cvs_filter_bank(const float* in, float* out, int n, int h, int w,
                               int k, int t, const float* xtaps, const float* ytaps,
                               void* stream) {
    if (k < 1 || k > kMaxK || t < 1 || t > kMaxT || (t % 2) == 0 || n < 1 ||
        h < 1 || w < 1) {
        return (int)cudaErrorInvalidValue;
    }
    BankTaps taps = {};
    for (int i = 0; i < k; ++i) {
        for (int j = 0; j < t; ++j) {
            taps.x[i][j] = xtaps[i * t + j];
            taps.y[i][j] = ytaps[i * t + j];
        }
    }
    dim3 grid(ceil_div(w, kTileW), ceil_div(h, kTileH), n);
    filter_bank_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(in, out, h, w, k, t, taps);
    return (int)cudaGetLastError();
}

CVS_EXPORT const char* cvs_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
