// Kernel A: separable filter bank, image [N, H, W] -> basis [N, K, H, W].
//
// Replaces: cvsteer_tpu/ops/pallas_frontend.py::filter_bank_pallas
// (_bank_kernel) and ::bank_tiled_pallas (_bank_tiled_kernel). The TPU
// pair split whole-tile from row-tiled only to fit its VMEM budget; one
// tiled kernel serves every size here.
//
// Contract: cross-correlation, BORDER_REFLECT_101 (repeated reflection, so
// levels narrower than the pad stay defined), fp32 arithmetic; K <= 11
// filters of T = 2R + 1 <= 13 taps (G2/H2: K=7, R=4; G4/H4: K=11, R=6;
// blur5: K=1, R=2). Plain version: ops/sepconv.py::filter_bank_plain, which
// it equals bit for bit.
//
// What bounds it on the card: memory traffic. At 480x640 with the G2 bank
// it reads 1.2 MB and writes K x 1.2 = 8.6 MB, against ~250 flops per
// output pixel in the plain version's sum order — about 4 flops per byte,
// under the H100's ~20 fp32 flops per byte of HBM bandwidth; on the small
// pyramid levels, the latency of one block.
//
// What the design does about it: bank_core.cuh. Each block stages its
// 16x32 tile plus the reflected halo once, runs the row passes of the
// bank's distinct x-tap vectors (6 of 7 for G2, 10 of 11 for G4) in one
// stage from register windows, then walks (filter, strip, column) at run
// time: each 8-row column strip of one filter is computed in registers and
// stored straight to the output, a warp's lanes on 32 neighbouring columns,
// so every output is written once, coalesced. Two barriers per tile. The
// small tile gives the small pyramid levels (down to 30x40, one 32x64
// tile) several blocks, and a 480x640 level 600 tiles at 4 blocks per SM.
#include "bank_core.cuh"

namespace {

constexpr int kMaxR = 6;
// The tile and the row-strip width (kernels/tile_sweep.py builds others with
// -D to measure them; PERF.md has its table).
#ifndef CVS_A_TILE_H
#define CVS_A_TILE_H 16
#endif
#ifndef CVS_A_TILE_W
#define CVS_A_TILE_W 32
#endif
#ifndef CVS_A_ROW_STRIP
#define CVS_A_ROW_STRIP 4
#endif
constexpr int kTileH = CVS_A_TILE_H;
constexpr int kTileW = CVS_A_TILE_W;
constexpr int kRowStrip = CVS_A_ROW_STRIP;  // row pass: outputs per thread, along a row
constexpr int kColStrip = 8;  // column pass: outputs per thread, down a column

template <int R>
__global__ void __launch_bounds__(kBankThreads, 2)
filter_bank_kernel(const float* __restrict__ in, float* __restrict__ out, int h, int w,
                   const __grid_constant__ SepBank bank) {
    extern __shared__ __align__(16) float smem[];
    const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
    const size_t plane = (size_t)h * w;
    bank_rows<R, kTileH, kTileW, kRowStrip>(smem, in + blockIdx.z * plane, h, w, y0, x0, bank);

    // one column strip of one filter per step: (filter, strip row, column)
    constexpr int kStrips = (kTileH / kColStrip) * kTileW;  // of one filter
    for (int i = threadIdx.x; i < bank.k * kStrips; i += kBankThreads) {
        const int k = i / kStrips, j = i - k * kStrips;
        const int r0 = (j / kTileW) * kColStrip, c = j % kTileW;
        const int gy = y0 + r0, gx = x0 + c;
        if (gy >= h || gx >= w) continue;
        float o[kColStrip];
        column_strip<R, kTileH, kTileW, kColStrip>(smem, bank, k, r0, c, o);
        float* p = out + ((size_t)blockIdx.z * bank.k + k) * plane + (size_t)gy * w + gx;
#pragma unroll
        for (int q = 0; q < kColStrip; ++q) {
            if (gy + q < h) p[(size_t)q * w] = o[q];
        }
    }
}

template <int R>
int launch(const float* in, float* out, int n, int h, int w, const SepBank& bank,
           cudaStream_t stream) {
    static size_t granted = 48 * 1024;
    const size_t bytes = BankTile<R, kTileH, kTileW>::bytes(bank.n_rows);
    const cudaError_t e = allow_smem(filter_bank_kernel<R>, bytes, granted);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(ceil_div(w, kTileW), ceil_div(h, kTileH), n);
    filter_bank_kernel<R><<<grid, kBankThreads, bytes, stream>>>(in, out, h, w, bank);
    return (int)cudaGetLastError();
}

}  // namespace

CVS_EXPORT int cvs_filter_bank(const float* in, float* out, int n, int h, int w,
                               int k, int t, const float* xtaps, const float* ytaps,
                               void* stream) {
    if (k < 1 || k > kBankMaxK || t < 1 || t > 2 * kMaxR + 1 || (t % 2) == 0 || n < 1 ||
        h < 1 || w < 1) {
        return (int)cudaErrorInvalidValue;
    }
    const SepBank bank = make_bank(xtaps, ytaps, k, t);
    cudaStream_t s = (cudaStream_t)stream;
    switch ((t - 1) / 2) {
        case 0: return launch<0>(in, out, n, h, w, bank, s);
        case 1: return launch<1>(in, out, n, h, w, bank, s);
        case 2: return launch<2>(in, out, n, h, w, bank, s);
        case 3: return launch<3>(in, out, n, h, w, bank, s);
        case 4: return launch<4>(in, out, n, h, w, bank, s);
        case 5: return launch<5>(in, out, n, h, w, bank, s);
        default: return launch<6>(in, out, n, h, w, bank, s);
    }
}

CVS_EXPORT const char* cvs_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
