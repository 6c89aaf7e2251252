// Kernel E's template: image [N, H, W] -> three maps [N, H, W], the bank's
// responses never leaving registers. Three tails instantiate it, one
// source each (built in parallel):
//   g2_maps.cu          E   G2/H2 (K = 7): (edges, lines_dark, lines_bright),
//                           float32 or bfloat16;
//   g4_maps.cu          E4  G4/H4 (K = 11): the same maps;
//   g2_feature_maps.cu  E′  G2/H2: (score, ct, st), float32.
//
// Replaces: cvsteer_tpu/ops/pallas_frontend.py::g2_maps_tiled_pallas
// (_g2_maps_tiled_kernel), modes "maps", "g4maps" and "features".
//
// Contract: the separable bank of kernel A (cross-correlation, REFLECT_101
// that keeps reflecting, fp32; T = 2R + 1 <= 17 taps), then the tail, each
// bit-equal under --fmad=false to its plain version in
// ops/cuda_frontend.py (g2_maps_plain, g4_maps_plain, and
// g2_feature_maps_plain of filter_bank_plain).
//
// What bounds it on the card: arithmetic. Per pixel it reads 4 bytes and
// writes 6 (bf16) or 12 (fp32); the least work the function needs
// (chip_smoke.py::bank_flops, mirrored taps folded) is 219 flops for G2 and
// 518 for G4. The plain version's sum order forbids that fold and rounds
// every multiply and add apart, so the card runs ~320 (G2) and ~780 (G4)
// single fp32 instructions per pixel, the halo rows' row passes included.
//
// What the design does about it: the bank core (bank_core.cuh) — one
// staged tile, one row-pass stage over the distinct x-tap vectors from
// register windows, one barrier — then each thread takes a strip of SH
// outputs down one column, computes all K column passes of the strip into
// registers (K x SH responses) and runs the tail there pixel by pixel,
// storing three maps per pixel, a warp on 32 neighbouring columns. The tile
// and the strip height are the tail's (Tail::TH, TW, SH): kernels/
// tile_sweep.py measures the choices. No bf16x3 MXU split, lane roll or
// 128-wide wrap block: those served the TPU's matrix unit and lane layout.
//
// A tail is a struct with K, TH, TW, SH (column-strip height), SW (row-strip
// width), a Params type passed by value with each launch, and
//   __device__ static void apply(const float (&b)[K], const Params&, float (&out)[3]).
#pragma once

#include <cuda_bf16.h>

#include "bank_core.cuh"

constexpr int kMapsMaxR = (kBankMaxT - 1) / 2;  // 8

struct NoParams {};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// edges = h^2 / |(g, h)|, dark = g^2 / |(g, h)| where g > 0, bright the same
// where g < 0; 1.0f / sqrtf(x) as the plain version's 1.0 / torch.sqrt(x).
__device__ __forceinline__ void maps_out(float gv, float gsq, float hsq, float (&out)[3]) {
    const float mag2 = gsq + hsq;
    const float inv_mag = mag2 > 0.0f ? 1.0f / sqrtf(mag2) : 0.0f;
    const float gsq_over_mag = gsq * inv_mag;
    out[0] = hsq * inv_mag;
    out[1] = gv > 0.0f ? gsq_over_mag : 0.0f;
    out[2] = gv < 0.0f ? gsq_over_mag : 0.0f;
}

// (u, v) = (cos 2t, sin 2t) = (c2, c3) / rho, with (1, 0) where c2 = c3 = 0.
__device__ __forceinline__ void unit_harmonic(float c2, float c3, float& u, float& v) {
    const float s2 = c2 * c2 + c3 * c3;
    const float inv_rho = s2 > 0.0f ? 1.0f / sqrtf(s2) : 0.0f;
    u = s2 > 0.0f ? c2 * inv_rho : 1.0f;
    v = c3 * inv_rho;
}

// The G2 energy's second harmonic (c2, c3) from Freeman & Adelson's table,
// b = (g2a, g2b, g2c, h2a, h2b, h2c, h2d), with s = g2a + g2c and
// d = g2a - g2c shared (kernel E's form).
__device__ __forceinline__ void g2_harmonic_sd(const float (&b)[7], float& c2, float& c3) {
    const float g2a = b[0], g2b = b[1], g2c = b[2];
    const float h2a = b[3], h2b = b[4], h2c = b[5], h2d = b[6];
    const float s_gd = g2a + g2c;
    const float d_gd = g2a - g2c;
    c2 = 0.5f * (s_gd * d_gd)
         + 0.46875f * (h2a * h2a - h2d * h2d)
         + 0.28125f * (h2b * h2b - h2c * h2c)
         + 0.1875f * (h2a * h2c - h2b * h2d);
    c3 = -(g2b * s_gd) - 0.9375f * (h2c * h2d + h2a * h2b)
         - 1.6875f * h2b * h2c - 0.1875f * h2a * h2d;
}

// The sqrt-free G2/H2 steering from (c2, c3): the steered even response g
// and the square of the odd one h^2 are polynomials in (u, v); then maps_out.
__device__ __forceinline__ void g2_steer_maps(const float (&b)[7], float c2, float c3,
                                              float (&out)[3]) {
    const float g2a = b[0], g2b = b[1], g2c = b[2];
    const float h2a = b[3], h2b = b[4], h2c = b[5], h2d = b[6];
    float u, v;
    unit_harmonic(c2, c3, u, v);
    const float g2v = 0.5f * ((g2a + g2c) + u * (g2a - g2c)) - v * g2b;
    const float P = 0.5f * ((h2a + 3.0f * h2c) + u * (h2a - 3.0f * h2c));
    const float Q = 0.5f * ((3.0f * h2b + h2d) + u * (3.0f * h2b - h2d));
    const float PP = P * P, QQ = Q * Q;
    const float h2sq = fmaxf(0.5f * ((PP + QQ) + u * (PP - QQ)) - v * (P * Q), 0.0f);
    maps_out(g2v, g2v * g2v, h2sq, out);
}

template <int R, class Tail, typename OutT>
__global__ void __launch_bounds__(kBankThreads, 2)
maps_kernel(const float* __restrict__ in, OutT* __restrict__ m0, OutT* __restrict__ m1,
            OutT* __restrict__ m2, int h, int w, const __grid_constant__ SepBank bank,
            const __grid_constant__ typename Tail::Params params) {
    constexpr int K = Tail::K, TH = Tail::TH, TW = Tail::TW, P = Tail::SH;
    extern __shared__ __align__(16) float smem[];
    const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
    const size_t plane = (size_t)h * w;
    bank_rows<R, TH, TW, Tail::SW>(smem, in + blockIdx.z * plane, h, w, y0, x0, bank);

    for (int i = threadIdx.x; i < (TH / P) * TW; i += kBankThreads) {
        const int r0 = (i / TW) * P, c = i % TW;
        const int gy = y0 + r0, gx = x0 + c;
        if (gy >= h || gx >= w) continue;
        float b[K][P];
#pragma unroll
        for (int k = 0; k < K; ++k) column_strip<R, TH, TW, P>(smem, bank, k, r0, c, b[k]);
        const size_t o = blockIdx.z * plane + (size_t)gy * w + gx;
#pragma unroll
        for (int p = 0; p < P; ++p) {
            if (gy + p >= h) break;
            float px[K];
#pragma unroll
            for (int k = 0; k < K; ++k) px[k] = b[k][p];
            float out[3];
            Tail::apply(px, params, out);
            const size_t op = o + (size_t)p * w;
            store(m0 + op, out[0]);
            store(m1 + op, out[1]);
            store(m2 + op, out[2]);
        }
    }
}

template <int R, class Tail, typename OutT>
int launch_r(const float* in, void* m0, void* m1, void* m2, int n, int h, int w,
             const SepBank& bank, const typename Tail::Params& params, cudaStream_t stream) {
    static size_t granted = 48 * 1024;
    const size_t bytes = BankTile<R, Tail::TH, Tail::TW>::bytes(bank.n_rows);
    const cudaError_t e = allow_smem(maps_kernel<R, Tail, OutT>, bytes, granted);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(ceil_div(w, Tail::TW), ceil_div(h, Tail::TH), n);
    maps_kernel<R, Tail, OutT><<<grid, kBankThreads, bytes, stream>>>(
        in, (OutT*)m0, (OutT*)m1, (OutT*)m2, h, w, bank, params);
    return (int)cudaGetLastError();
}

// One launch of the maps kernel for `tail` with the [Tail::K, t] bank.
template <class Tail, typename OutT>
int launch_maps(const float* in, void* m0, void* m1, void* m2, int n, int h, int w, int t,
                const float* xtaps, const float* ytaps, const typename Tail::Params& params,
                void* stream) {
    if (t < 1 || t > 2 * kMapsMaxR + 1 || (t % 2) == 0 || n < 1 || h < 1 || w < 1) {
        return (int)cudaErrorInvalidValue;
    }
    const SepBank bank = make_bank(xtaps, ytaps, Tail::K, t);
    cudaStream_t s = (cudaStream_t)stream;
    switch ((t - 1) / 2) {
        case 0: return launch_r<0, Tail, OutT>(in, m0, m1, m2, n, h, w, bank, params, s);
        case 1: return launch_r<1, Tail, OutT>(in, m0, m1, m2, n, h, w, bank, params, s);
        case 2: return launch_r<2, Tail, OutT>(in, m0, m1, m2, n, h, w, bank, params, s);
        case 3: return launch_r<3, Tail, OutT>(in, m0, m1, m2, n, h, w, bank, params, s);
        case 4: return launch_r<4, Tail, OutT>(in, m0, m1, m2, n, h, w, bank, params, s);
        case 5: return launch_r<5, Tail, OutT>(in, m0, m1, m2, n, h, w, bank, params, s);
        case 6: return launch_r<6, Tail, OutT>(in, m0, m1, m2, n, h, w, bank, params, s);
        case 7: return launch_r<7, Tail, OutT>(in, m0, m1, m2, n, h, w, bank, params, s);
        default: return launch_r<8, Tail, OutT>(in, m0, m1, m2, n, h, w, bank, params, s);
    }
}
