// Kernel M: the matrix-unit variants of kernel E's maps on the tensor cores,
// image [N, H, W] -> three fp32 maps [N, H, W], the G2/H2 bank at width 4
// (T = 9), stages row / col / coeff / full with the "v2" outputs of
// kernel S (probe_maps_stages.cu); full is the sqrt / cos / sin steering.
//
// Replaces: scripts/profile_variants.py::_kernel_presplit (build, the
// pallas_call at :261) and ::_kernel_rowmxu (:304), and the bf16x1 column
// pass of scripts/profile_frontend.py (Precision.DEFAULT, :244): the TPU ran
// its column pass, and in rowmxu its row pass, on the matrix unit. Here:
//   column pass  the banded product basis_k = C_k rows_k, C_k [TH, TH + 2R]
//                with C_k[i, i + t] = y_k[t], bf16 operands, fp32 sums, by
//                mma.sync m16n8k16: bf16x3 (C_hi R_hi + C_hi R_lo +
//                C_lo R_hi, the presplit / Precision.HIGHEST scheme; R_hi,
//                R_lo the bf16 split of the fp32 row-pass values, made once
//                when the row pass stores them) or bf16x1 (C_hi R_hi, the
//                DEFAULT precision);
//   row pass     fp32 on the CUDA cores (kernel E's strip_pass), or
//                "rowmxu": the taps [n_rows, T] split hi/lo against the
//                shifted image rows rounded to bf16 (exact for u8-valued
//                images), two mma.sync products, fp32 sums.
// Plain version: ops/cuda_probes.py::maps_mma_plain, the same splits and
// products in fp32 through torch.matmul. The tensor cores sum in an order
// of their own, so the two agree to rounding, not to the bit.
//
// What bounds it on the card: the bytes (three fp32 maps and the image, 16
// bytes a pixel: 0.0200 ms for 16x512x512); the banded product is 9 live
// taps in rows of 16 (m16n8k16 over a 64 + 16 row window, two k-steps per
// 16 outputs): 16 x 16 x 8 x 2 flops per mma, 6 mma per filter for
// bf16x3 (21 for the G2 bank's 7 filters per 16x8 outputs), far under the
// tensor cores' 989 TFLOP/s.
//
// What the design does about it: a 64x32 tile (the scripts' tile height)
// staged once with stage_reflect; the row pass writes the bf16 hi and lo
// rows of each distinct x-tap vector to shared memory (row stride of 40
// bf16, so a warp's B-fragment loads fall on distinct banks), zeros on the
// 8 rows under the window that the last k-step reads; a warp then takes a
// 16x8 block of outputs, runs all 7 filters' products into 7 x 4 fp32
// accumulators, and applies the stage's tail to its 4 pixels. The band
// matrix is Toeplitz, so each lane builds its A fragments from the taps.
// No wgmma, TMA or pipelining: a first kernel that is right.
#include <stdint.h>

#include "probe_tails.cuh"

namespace {

constexpr int R = 4, T = 2 * R + 1, K = 7;
constexpr int kTH = 64, kTW = 32, kSW = 8;
constexpr int kIH = kTH + 2 * R;        // staged rows (the outputs' window)
constexpr int kIHP = kTH + 16;          // rows the last 16-deep k-step reads
constexpr int kIW = (kTW + 2 * R) | 1;  // staged row stride (floats)
constexpr int kRS = kTW + 8;            // row-buffer stride (bf16)
constexpr int kThreads = 256, kWarps = kThreads / 32;

enum Stage { kRow = 0, kCol = 1, kCoeff = 2, kFull = 3 };

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo16, __nv_bfloat16 hi16) {
    return (uint32_t)__bfloat16_as_ushort(lo16) | ((uint32_t)__bfloat16_as_ushort(hi16) << 16);
}

__device__ __forceinline__ uint32_t pack_f(float a, float b) {
    return pack(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
}

// d += a b: a 16x16 (row-major), b 16x8 (column-major), bf16; d fp32.
// Fragments (lane = 4 g + q): a[0] (row g, cols 2q, 2q+1), a[1] (row g+8),
// a[2] (row g, cols 2q+8, 2q+9), a[3] (row g+8, cols 2q+8, 2q+9); b0 (rows
// 2q, 2q+1, col g), b1 (rows 2q+8, 2q+9); d[0..1] (row g, cols 2q, 2q+1),
// d[2..3] (row g+8). The lower 16 bits hold the lower index.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float tap(const float* taps, int t) {
    return t >= 0 && t < T ? taps[t] : 0.0f;
}

// The hi (part 0) or lo (part 1) bf16 of v.
__device__ __forceinline__ float part(float v, int which) {
    float hi, lo;
    bf16_split(v, hi, lo);
    return which ? lo : hi;
}

struct Smem {
    float* stage;          // [kIH][kIW] fp32 image window
    __nv_bfloat16* hi;     // [n_rows][kIHP][kRS] row passes, bf16 hi
    __nv_bfloat16* lo;     // the lo parts
};

__device__ __forceinline__ void put_row(const Smem& s, int d, int y, int c, float v) {
    float hi, lo;
    bf16_split(v, hi, lo);
    s.hi[(d * kIHP + y) * kRS + c] = __float2bfloat16_rn(hi);
    s.lo[(d * kIHP + y) * kRS + c] = __float2bfloat16_rn(lo);
}

// fp32 row pass on the CUDA cores: strips of kSW outputs a row (kernel E's
// strip_pass), every distinct x-tap vector; rows under the window get zeros.
__device__ void rows_fp32(const Smem& s, const SepBank& bank) {
    constexpr int kStrips = kTW / kSW;
    for (int i = threadIdx.x; i < kIHP * kStrips; i += kThreads) {
        const int strip = i / kIHP, y = i - strip * kIHP;
        const int c0 = strip * kSW;
        if (y >= kIH) {
            for (int d = 0; d < bank.n_rows; ++d) {
#pragma unroll
                for (int p = 0; p < kSW; ++p) put_row(s, d, y, c0 + p, 0.0f);
            }
            continue;
        }
        float win[kSW + T - 1];
        const float* src = s.stage + y * kIW + c0;
#pragma unroll
        for (int j = 0; j < kSW + T - 1; ++j) win[j] = src[j];
        for (int d = 0; d < bank.n_rows; ++d) {
            float out[kSW];
            strip_pass<T, kSW>(win, bank.x[d], out);
#pragma unroll
            for (int p = 0; p < kSW; ++p) put_row(s, d, y, c0 + p, out[p]);
        }
    }
}

// rowmxu: rows[d, y, c0 + n] = sum_t (x_hi[d, t] + x_lo[d, t]) bf16(img[y, c0 + n + t]),
// one 16x8 product per (row, 8 columns): A = the taps (distinct x-tap vectors
// as rows, taps as columns, zero beyond), B = the shifted image.
__device__ void rows_mma(const Smem& s, const SepBank& bank) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, q = lane & 3;
    const float* x0 = g < bank.n_rows ? bank.x[g] : nullptr;
    const float* x8 = g + 8 < bank.n_rows ? bank.x[g + 8] : nullptr;
    auto xt = [&](const float* taps, int t) { return taps ? tap(taps, t) : 0.0f; };
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int w = 0; w < 2; ++w) {
        const int t0 = 2 * q + 8 * w;
        ahi[2 * w] = pack_f(part(xt(x0, t0), 0), part(xt(x0, t0 + 1), 0));
        ahi[2 * w + 1] = pack_f(part(xt(x8, t0), 0), part(xt(x8, t0 + 1), 0));
        alo[2 * w] = pack_f(part(xt(x0, t0), 1), part(xt(x0, t0 + 1), 1));
        alo[2 * w + 1] = pack_f(part(xt(x8, t0), 1), part(xt(x8, t0 + 1), 1));
    }
    constexpr int kBlocks = kTW / 8;
    for (int task = warp; task < kIH * kBlocks; task += kWarps) {
        const int y = task / kBlocks, c0 = (task - y * kBlocks) * 8;
        const float* src = s.stage + y * kIW + c0 + g;
        const uint32_t b0 = pack_f(src[2 * q], src[2 * q + 1]);
        const uint32_t b1 = pack_f(q == 0 ? src[8] : 0.0f, 0.0f);  // t = 8 + 2q + {0, 1} < T
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16(acc, ahi, b0, b1);
        mma_bf16(acc, alo, b0, b1);
        if (g < bank.n_rows) {
            put_row(s, g, y, c0 + 2 * q, acc[0]);
            put_row(s, g, y, c0 + 2 * q + 1, acc[1]);
        }
        if (g + 8 < bank.n_rows) {
            put_row(s, g + 8, y, c0 + 2 * q, acc[2]);
            put_row(s, g + 8, y, c0 + 2 * q + 1, acc[3]);
        }
    }
    for (int i = threadIdx.x; i < bank.n_rows * (kIHP - kIH) * kTW; i += kThreads) {
        const int d = i / ((kIHP - kIH) * kTW), j = i - d * (kIHP - kIH) * kTW;
        put_row(s, d, kIH + j / kTW, j % kTW, 0.0f);
    }
}

// A fragments of the band of y taps for the k-step at offset 16 * step:
// A[m][kk] = y[16 step + kk - m].
__device__ __forceinline__ void band_fragments(const float* y, int step, int which, int g, int q,
                                               uint32_t (&a)[4]) {
    const int base = 16 * step + 2 * q - g;
    a[0] = pack_f(part(tap(y, base), which), part(tap(y, base + 1), which));
    a[1] = pack_f(part(tap(y, base - 8), which), part(tap(y, base - 7), which));
    a[2] = pack_f(part(tap(y, base + 8), which), part(tap(y, base + 9), which));
    a[3] = pack_f(part(tap(y, base), which), part(tap(y, base + 1), which));
}

__device__ __forceinline__ void b_fragments(const __nv_bfloat16* rows, int q, uint32_t& b0,
                                            uint32_t& b1) {
    b0 = pack(rows[(2 * q) * kRS], rows[(2 * q + 1) * kRS]);
    b1 = pack(rows[(2 * q + 8) * kRS], rows[(2 * q + 9) * kRS]);
}

template <int Stage, bool RowMma, bool X3>
__global__ void __launch_bounds__(kThreads, 2)
mma_maps_kernel(const float* __restrict__ in, float* __restrict__ m0, float* __restrict__ m1,
                float* __restrict__ m2, int h, int w, const __grid_constant__ SepBank bank) {
    extern __shared__ __align__(16) float smem[];
    Smem s;
    s.stage = smem;
    s.hi = reinterpret_cast<__nv_bfloat16*>(smem + kIH * kIW);
    s.lo = s.hi + bank.n_rows * kIHP * kRS;
    const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kTH;
    const size_t plane = (size_t)h * w;
    // the whole window, reflected wherever it leaves the plane: every value
    // a product reads is finite
    stage_reflect(s.stage, kIW, in + blockIdx.z * plane, h, w, y0 - R, x0 - R, kIH, kTW + 2 * R);
    __syncthreads();
    if (RowMma) {
        rows_mma(s, bank);
    } else {
        rows_fp32(s, bank);
    }
    __syncthreads();

    const size_t o = blockIdx.z * plane;
    if (Stage == kRow) {
        for (int i = threadIdx.x; i < kTH * kTW; i += kThreads) {
            const int r = i / kTW, c = i % kTW;
            const int gy = y0 + r, gx = x0 + c;
            if (gy >= h || gx >= w) continue;
            float hi[7], lo[7];
#pragma unroll
            for (int k = 0; k < 7; ++k) {
                const int at = (bank.row_of[k] * kIHP + r + R) * kRS + c;
                hi[k] = __bfloat162float(s.hi[at]);
                lo[k] = __bfloat162float(s.lo[at]);
            }
            float out[3];
            row_split_outputs(hi, lo, out);
            const size_t op = o + (size_t)gy * w + gx;
            m0[op] = out[0];
            m1[op] = out[1];
            m2[op] = out[2];
        }
        return;
    }

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, q = lane & 3;
    constexpr int kMB = kTH / 16, kNB = kTW / 8;
    for (int task = warp; task < kMB * kNB; task += kWarps) {
        const int i0 = (task / kNB) * 16, c0 = (task % kNB) * 8;
        float acc[K][4];
#pragma unroll
        for (int k = 0; k < K; ++k) {
            acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.0f;
#pragma unroll
            for (int step = 0; step < 2; ++step) {
                const int at = (bank.row_of[k] * kIHP + i0 + 16 * step) * kRS + c0 + g;
                uint32_t ahi[4], bh0, bh1;
                band_fragments(bank.y[k], step, 0, g, q, ahi);
                b_fragments(s.hi + at, q, bh0, bh1);
                mma_bf16(acc[k], ahi, bh0, bh1);
                if (X3) {
                    uint32_t alo[4], bl0, bl1;
                    band_fragments(bank.y[k], step, 1, g, q, alo);
                    b_fragments(s.lo + at, q, bl0, bl1);
                    mma_bf16(acc[k], ahi, bl0, bl1);
                    mma_bf16(acc[k], alo, bh0, bh1);
                }
            }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int gy = y0 + i0 + g + 8 * (e >> 1), gx = x0 + c0 + 2 * q + (e & 1);
            if (gy >= h || gx >= w) continue;
            float b[7], out[3];
#pragma unroll
            for (int k = 0; k < K; ++k) b[k] = acc[k][e];
            if (Stage == kCol) {
                col_outputs<kOutV2>(b, out);
            } else if (Stage == kCoeff) {
                coeff_outputs<kOutV2>(b, out);
            } else {
                float c2, c3;
                g2_harmonic(b, c2, c3);
                g2_sqrt_maps(b, c2, c3, out);
            }
            const size_t op = o + (size_t)gy * w + gx;
            m0[op] = out[0];
            m1[op] = out[1];
            m2[op] = out[2];
        }
    }
}

template <int Stage, bool RowMma, bool X3>
int launch(const float* in, void* m0, void* m1, void* m2, int n, int h, int w,
           const SepBank& bank, cudaStream_t stream) {
    static size_t granted = 48 * 1024;
    const size_t bytes = sizeof(float) * kIH * kIW + 2 * sizeof(__nv_bfloat16) * bank.n_rows * kIHP * kRS;
    const cudaError_t e = allow_smem(mma_maps_kernel<Stage, RowMma, X3>, bytes, granted);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(ceil_div(w, kTW), ceil_div(h, kTH), n);
    mma_maps_kernel<Stage, RowMma, X3><<<grid, kThreads, bytes, stream>>>(
        in, (float*)m0, (float*)m1, (float*)m2, h, w, bank);
    return (int)cudaGetLastError();
}

}  // namespace

// stage: 0 row, 1 col, 2 coeff, 3 full; row_mma: the rowmxu row pass;
// x3: bf16x3 (else bf16x1) column pass. Instantiated: the fp32 row pass
// with bf16x3 at every stage, bf16x1 at col and full, rowmxu (bf16x3) at
// col and full; other combinations return cudaErrorInvalidValue.
CVS_EXPORT int cvs_probe_mma(const float* in, void* m0, void* m1, void* m2, int n, int h, int w,
                             int t, const float* xtaps, const float* ytaps, int stage,
                             int row_mma, int x3, void* stream) {
    if (t != T || n < 1 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
    const SepBank bank = make_bank(xtaps, ytaps, K, t);
    cudaStream_t s = (cudaStream_t)stream;
    if (!row_mma && x3) {
        switch (stage) {
            case kRow: return launch<kRow, false, true>(in, m0, m1, m2, n, h, w, bank, s);
            case kCol: return launch<kCol, false, true>(in, m0, m1, m2, n, h, w, bank, s);
            case kCoeff: return launch<kCoeff, false, true>(in, m0, m1, m2, n, h, w, bank, s);
            case kFull: return launch<kFull, false, true>(in, m0, m1, m2, n, h, w, bank, s);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    if (stage == kCol) {
        if (!row_mma) return launch<kCol, false, false>(in, m0, m1, m2, n, h, w, bank, s);
        if (x3) return launch<kCol, true, true>(in, m0, m1, m2, n, h, w, bank, s);
    }
    if (stage == kFull) {
        if (!row_mma) return launch<kFull, false, false>(in, m0, m1, m2, n, h, w, bank, s);
        if (x3) return launch<kFull, true, true>(in, m0, m1, m2, n, h, w, bank, s);
    }
    return (int)cudaErrorInvalidValue;
}
