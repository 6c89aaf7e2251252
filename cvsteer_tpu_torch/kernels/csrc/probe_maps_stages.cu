// Kernel S: kernel E's template (maps.cuh on bank_core.cuh) cut at each
// stage, image [N, H, W] -> three fp32 maps [N, H, W] per stage, to see
// where E's time goes without a hardware profiler.
//
// Replaces: scripts/profile_v2_stages.py::stage_kernel (build, the
// pallas_call at :149) and scripts/profile_frontend.py::_stage_kernel
// (make_variant, :159), the TPU's stage isolation of its maps kernel. Each
// stage keeps E's grid, tile and output traffic (three fp32 maps) and does
// one more part of E's work than the one before:
//   load   stage the tile (stage_reflect) and write (x, 2x, 3x);
//   row    + the row passes (bank_rows); "v2" writes the sums of the bf16
//          hi and lo parts of the 7 filters' row-pass values at the pixel
//          and their sum, "frontend" the row-pass values of filters 0-2
//          (the row buffers hold every filter's anyway);
//   col    + the column strips: v2 (sum of the basis, g2a - g2b,
//          g2c - h2a), frontend (g2a, g2b, h2a);
//   coeff  + the energy's second harmonic: (c2, c3, c2 + c3) or (c2, c3, g2a);
//   full   + the steering: v2 the sqrt-free tail in the scripts' form (no
//          reuse of g2a +- g2c), frontend the sqrt / cos / sin tail of
//          profile_frontend.py:119-134.
// The G2/H2 bank at width 4 only (T = 9), as the scripts ran it. Plain
// version: ops/cuda_probes.py::maps_stage_plain, bit for bit.
//
// What bounds it on the card: every stage writes three fp32 maps and reads
// the image, 16 bytes a pixel (0.0200 ms for 16x512x512 at 3.35 TB/s); from
// the row stage on, the arithmetic of kernel E (maps.cuh).
//
// What the design does about it: nothing of its own. The stages are E's
// code, cut, so the differences between them are the costs of E's parts.
#include "probe_tails.cuh"

namespace {

constexpr int R = 4;
// kernel E's tile, column strips and row strips (g2_maps.cu)
constexpr int kTH = 32, kTW = 32, kSH = 4, kSW = 8;

enum Stage { kLoad = 0, kRow = 1, kCol = 2, kCoeff = 3, kFull = 4 };

template <int Stage, int Out>
struct StageTail {
    static constexpr int K = 7, TH = kTH, TW = kTW, SH = kSH, SW = kSW;
    using Params = NoParams;

    __device__ static void apply(const float (&b)[K], const Params&, float (&out)[3]) {
        if (Stage == kCol) {
            col_outputs<Out>(b, out);
        } else if (Stage == kCoeff) {
            coeff_outputs<Out>(b, out);
        } else {
            float c2, c3;
            g2_harmonic(b, c2, c3);
            if (Out == kOutV2) {
                g2_steer_maps(b, c2, c3, out);
            } else {
                g2_sqrt_maps(b, c2, c3, out);
            }
        }
    }
};

// The load and row stages: E's staging (and row passes), then per pixel
// the staged value or the row-pass values at its row and column.
template <int Stage, int Out>
__global__ void __launch_bounds__(kBankThreads, 2)
stage_rows_kernel(const float* __restrict__ in, float* __restrict__ m0, float* __restrict__ m1,
                  float* __restrict__ m2, int h, int w, const __grid_constant__ SepBank bank) {
    using L = BankTile<R, kTH, kTW>;
    extern __shared__ __align__(16) float smem[];
    const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kTH;
    const size_t plane = (size_t)h * w;
    const float* image = in + blockIdx.z * plane;
    if (Stage == kLoad) {
        const int n_y = min(L::ih, h - y0 + 2 * R);
        stage_reflect(smem, L::iw, image, h, w, y0 - R, x0 - R, n_y, min(kTW, w - x0) + 2 * R);
        __syncthreads();
    } else {
        bank_rows<R, kTH, kTW, kSW>(smem, image, h, w, y0, x0, bank);
    }
    const float* rows = smem + L::rows_at;
    for (int i = threadIdx.x; i < kTH * kTW; i += kBankThreads) {
        const int r = i / kTW, c = i % kTW;
        const int gy = y0 + r, gx = x0 + c;
        if (gy >= h || gx >= w) continue;
        float out[3];
        if (Stage == kLoad) {
            const float x = smem[(r + R) * L::iw + c + R];
            out[0] = x;
            out[1] = 2.0f * x;
            out[2] = 3.0f * x;
        } else if (Out == kOutV2) {
            float hi[7], lo[7];
#pragma unroll
            for (int k = 0; k < 7; ++k) {
                bf16_split(rows[(bank.row_of[k] * L::ih + r + R) * L::rs + c], hi[k], lo[k]);
            }
            row_split_outputs(hi, lo, out);
        } else {
#pragma unroll
            for (int k = 0; k < 3; ++k) out[k] = rows[(bank.row_of[k] * L::ih + r + R) * L::rs + c];
        }
        const size_t o = blockIdx.z * plane + (size_t)gy * w + gx;
        m0[o] = out[0];
        m1[o] = out[1];
        m2[o] = out[2];
    }
}

template <int Stage, int Out>
int launch_rows(const float* in, void* m0, void* m1, void* m2, int n, int h, int w,
                const SepBank& bank, cudaStream_t stream) {
    static size_t granted = 48 * 1024;
    using L = BankTile<R, kTH, kTW>;
    const size_t bytes = Stage == kLoad ? sizeof(float) * L::rows_at : L::bytes(bank.n_rows);
    const cudaError_t e = allow_smem(stage_rows_kernel<Stage, Out>, bytes, granted);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(ceil_div(w, kTW), ceil_div(h, kTH), n);
    stage_rows_kernel<Stage, Out><<<grid, kBankThreads, bytes, stream>>>(
        in, (float*)m0, (float*)m1, (float*)m2, h, w, bank);
    return (int)cudaGetLastError();
}

template <int Out>
int launch_stage(int stage, const float* in, void* m0, void* m1, void* m2, int n, int h, int w,
                 const SepBank& bank, cudaStream_t s) {
    switch (stage) {
        case kLoad: return launch_rows<kLoad, Out>(in, m0, m1, m2, n, h, w, bank, s);
        case kRow: return launch_rows<kRow, Out>(in, m0, m1, m2, n, h, w, bank, s);
        case kCol:
            return launch_r<R, StageTail<kCol, Out>, float>(in, m0, m1, m2, n, h, w, bank,
                                                            NoParams{}, s);
        case kCoeff:
            return launch_r<R, StageTail<kCoeff, Out>, float>(in, m0, m1, m2, n, h, w, bank,
                                                              NoParams{}, s);
        default:
            return launch_r<R, StageTail<kFull, Out>, float>(in, m0, m1, m2, n, h, w, bank,
                                                             NoParams{}, s);
    }
}

}  // namespace

// stage: 0 load, 1 row, 2 col, 3 coeff, 4 full; outputs: 0 v2, 1 frontend.
CVS_EXPORT int cvs_probe_stages(const float* in, void* m0, void* m1, void* m2, int n, int h,
                                int w, int t, const float* xtaps, const float* ytaps, int stage,
                                int outputs, void* stream) {
    if (t != 2 * R + 1 || n < 1 || h < 1 || w < 1 || stage < kLoad || stage > kFull ||
        (outputs != kOutV2 && outputs != kOutFrontend)) {
        return (int)cudaErrorInvalidValue;
    }
    const SepBank bank = make_bank(xtaps, ytaps, 7, t);
    cudaStream_t s = (cudaStream_t)stream;
    if (outputs == kOutV2) return launch_stage<kOutV2>(stage, in, m0, m1, m2, n, h, w, bank, s);
    return launch_stage<kOutFrontend>(stage, in, m0, m1, m2, n, h, w, bank, s);
}
