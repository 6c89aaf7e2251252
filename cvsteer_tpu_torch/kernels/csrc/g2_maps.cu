// Kernel E: fused output maps, image [N, H, W] -> (edges, lines_dark,
// lines_bright) [N, H, W] in float32 or bfloat16, for the G2/H2 pair
// (K = 7 filters) and the G4/H4 pair (K = 11); and E′, the same bank with
// the G2 feature tail: image -> (score, ct, st) [N, H, W] in float32.
//
// Replaces: cvsteer_tpu/ops/pallas_frontend.py::g2_maps_tiled_pallas
// (_g2_maps_tiled_kernel), mode "maps" (g2_maps_pallas), mode "g4maps"
// (g4_maps_pallas) and mode "features" (g2_feature_maps_pallas). Plain
// version: ops/cuda_frontend.py::g2_maps_plain / g4_maps_plain, and
// g2_feature_maps_plain of filter_bank_plain for E′.
//
// Contract: the separable bank of kernel A (cross-correlation, REFLECT_101
// that keeps reflecting, so images narrower than the taps stay defined;
// fp32), then the sqrt-free steering tail of the TPU kernel: the energy's
// second harmonic (c2, c3) — G2 from Freeman & Adelson's table, G4 from the
// reference's list of 33 products of the symmetrized quadratic tables —
// gives (u, v) = (cos 2t, sin 2t) with u = 1, v = 0 where c2 = c3 = 0; the
// steered even response g and the square of the odd one h^2 are
// polynomials in u, v; edges = h^2 / |(g, h)|, dark = g^2 / |(g, h)| where
// g > 0, bright the same where g < 0. E′'s tail is common.cuh's
// g2_feature_tail, kernel C's.
//
// What bounds it on the card: arithmetic about as much as memory. Per
// pixel it reads 4 bytes and writes 6 (bf16) or 12 (fp32); the least work
// the function needs (chip_smoke.py::bank_flops: one row pass per distinct
// x-tap vector, mirrored taps folded, then the tail) is 219 flops for G2
// and 518 for G4 — 22-52 flops per byte with bf16 maps against the H100's
// ~20 fp32 flops per byte of HBM bandwidth.
//
// What the design does about it: the TPU kernel's contract of one image
// read and three map writes, with the basis never in device memory. Each
// block stages a 32x64 output tile plus its reflected halo in shared memory
// once, runs the row pass of one filter at a time into a shared row buffer,
// and each thread keeps the column-pass results of all K filters for its 8
// pixels (one column, 8 rows) in registers — 88 floats for G4 — where the
// tail runs. Staging, passes and taps are kernel A's (common.cuh); this
// first version runs every filter's passes in full, without the folds the
// bound counts. The G4 product list has its indices compiled in (so the
// basis values stay in registers) and its weights passed by value with each
// launch. No bf16x3 MXU split, lane roll or 128-wide wrap block: those
// served the TPU's matrix unit and lane layout.
//
// Bits: built with --fmad=false, summing in the plain version's order (row
// pass then column pass, taps in order, products in the reference's order)
// and with 1.0f / sqrtf(x) where the plain version has 1.0 / torch.sqrt(x),
// so kernel and plain version round the same operations the same way.
#include <cuda_bf16.h>

#include <utility>

#include "common.cuh"

namespace {

constexpr int kG2K = 7;
constexpr int kG4K = 11;
constexpr int kMaxT = kBankMaxT;
constexpr int kMaxR = (kMaxT - 1) / 2;
constexpr int kTileW = 64;
constexpr int kThreads = 256;
constexpr int kRowsPerThread = 8;
constexpr int kTileH = kRowsPerThread * (kThreads / kTileW);  // 32

// The G4 second-harmonic products, in the order of the reference's list
// (pallas_frontend._g4_quad_terms; ops/cuda_frontend.py::g4_live_terms):
// term n adds w_n b_i b_j to c2 (slot 0) or c3 (slot 1) — every term of the
// list has exactly one weight the reference keeps (|w| > 1e-7). The host
// entry checks the list it is handed against these indices.
struct G4Term {
    int i, j, slot;
};
constexpr int kG4Terms = 33;

__host__ __device__ constexpr G4Term g4_term(int n) {
    constexpr G4Term terms[kG4Terms] = {
        {0, 0, 0}, {0, 1, 1}, {0, 2, 0}, {0, 3, 1}, {1, 1, 0}, {1, 2, 1}, {1, 4, 1},
        {2, 3, 1}, {2, 4, 0}, {3, 3, 0}, {3, 4, 1}, {4, 4, 0}, {5, 5, 0}, {5, 6, 1},
        {5, 7, 0}, {5, 8, 1}, {5, 9, 0}, {5, 10, 1}, {6, 6, 0}, {6, 7, 1}, {6, 8, 0},
        {6, 9, 1}, {6, 10, 0}, {7, 7, 0}, {7, 8, 1}, {7, 9, 0}, {7, 10, 1}, {8, 8, 0},
        {8, 9, 1}, {8, 10, 0}, {9, 9, 0}, {9, 10, 1}, {10, 10, 0},
    };
    return terms[n];
}

struct G4Weights {
    float w[kG4Terms];
};

struct Maps {
    float edges, dark, bright;
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ Maps maps_out(float gv, float gsq, float hsq) {
    const float mag2 = gsq + hsq;
    const float inv_mag = mag2 > 0.0f ? 1.0f / sqrtf(mag2) : 0.0f;
    const float gsq_over_mag = gsq * inv_mag;
    return {hsq * inv_mag, gv > 0.0f ? gsq_over_mag : 0.0f, gv < 0.0f ? gsq_over_mag : 0.0f};
}

__device__ __forceinline__ void unit_harmonic(float c2, float c3, float& u, float& v) {
    const float s2 = c2 * c2 + c3 * c3;
    const float inv_rho = s2 > 0.0f ? 1.0f / sqrtf(s2) : 0.0f;
    u = s2 > 0.0f ? c2 * inv_rho : 1.0f;
    v = c3 * inv_rho;
}

__device__ __forceinline__ Maps g2_tail(const float (&b)[kG2K]) {
    const float g2a = b[0], g2b = b[1], g2c = b[2];
    const float h2a = b[3], h2b = b[4], h2c = b[5], h2d = b[6];
    const float s_gd = g2a + g2c;
    const float d_gd = g2a - g2c;
    const float c2 = 0.5f * (s_gd * d_gd)
                     + 0.46875f * (h2a * h2a - h2d * h2d)
                     + 0.28125f * (h2b * h2b - h2c * h2c)
                     + 0.1875f * (h2a * h2c - h2b * h2d);
    const float c3 = -(g2b * s_gd) - 0.9375f * (h2c * h2d + h2a * h2b)
                     - 1.6875f * h2b * h2c - 0.1875f * h2a * h2d;
    float u, v;
    unit_harmonic(c2, c3, u, v);
    const float g2v = 0.5f * (s_gd + u * d_gd) - v * g2b;
    const float P = 0.5f * ((h2a + 3.0f * h2c) + u * (h2a - 3.0f * h2c));
    const float Q = 0.5f * ((3.0f * h2b + h2d) + u * (3.0f * h2b - h2d));
    const float PP = P * P, QQ = Q * Q;
    const float h2sq = fmaxf(0.5f * ((PP + QQ) + u * (PP - QQ)) - v * (P * Q), 0.0f);
    return maps_out(g2v, g2v * g2v, h2sq);
}

template <int N>
__device__ __forceinline__ void g4_add_term(const float (&b)[kG4K], const G4Weights& q, float& c2,
                                            float& c3) {
    constexpr G4Term t = g4_term(N);
    float& c = t.slot == 0 ? c2 : c3;
    c = c + (b[t.i] * b[t.j]) * q.w[N];
}

template <int... N>
__device__ __forceinline__ void g4_quad(const float (&b)[kG4K], const G4Weights& q, float& c2,
                                        float& c3, std::integer_sequence<int, N...>) {
    (g4_add_term<N>(b, q, c2, c3), ...);  // in list order: a comma fold runs left to right
}

__device__ __forceinline__ Maps g4_tail(const float (&b)[kG4K], const G4Weights& q) {
    float c2 = 0.0f, c3 = 0.0f;
    g4_quad(b, q, c2, c3, std::make_integer_sequence<int, kG4Terms>{});
    float u, v;
    unit_harmonic(c2, c3, u, v);
    const float cc = 0.5f * (1.0f + u);
    const float ss = 0.5f * (1.0f - u);
    const float cc2 = cc * cc, ss2 = ss * ss, cs = cc * ss;
    const float g4v = cc2 * b[0] + 6.0f * cs * b[2] + ss2 * b[4]
                      - 2.0f * v * (cc * b[1] + ss * b[3]);
    const float P = cc2 * b[5] + 10.0f * cs * b[7] + 5.0f * ss2 * b[9];
    const float Q = 5.0f * cc2 * b[6] + 10.0f * cs * b[8] + ss2 * b[10];
    const float PP = P * P, QQ = Q * Q;
    const float h4sq = fmaxf(0.5f * ((PP + QQ) + u * (PP - QQ)) - v * (P * Q), 0.0f);
    return maps_out(g4v, g4v * g4v, h4sq);
}

// kFeatures: E′, whose three outputs are (score, ct, st) instead of
// (edges, dark, bright).
template <int K, typename OutT, bool kFeatures = false>
__global__ void __launch_bounds__(kThreads)
maps_kernel(const float* __restrict__ in, OutT* __restrict__ edges, OutT* __restrict__ dark,
            OutT* __restrict__ bright, int h, int w, int T, const SepTaps taps,
            const G4Weights q) {
    __shared__ float tile[kTileH + 2 * kMaxR][kTileW + 2 * kMaxR];
    __shared__ float rows[kTileH + 2 * kMaxR][kTileW];

    const int r = (T - 1) / 2;
    const int x0 = blockIdx.x * kTileW;
    const int y0 = blockIdx.y * kTileH;
    const size_t plane = (size_t)h * w;
    const int th = kTileH + 2 * r;

    stage_tile<true>(tile, in + blockIdx.z * plane, h, w, y0 - r, x0 - r, th, kTileW + 2 * r);
    __syncthreads();

    // this thread's pixels: column tx, rows ty0 .. ty0 + 7 of the tile
    const int tx = threadIdx.x % kTileW;
    const int ty0 = (threadIdx.x / kTileW) * kRowsPerThread;
    float acc[K][kRowsPerThread];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        row_pass<false>(tile, rows, taps, k, T, th);
        __syncthreads();
#pragma unroll
        for (int p = 0; p < kRowsPerThread; ++p) acc[k][p] = col_at<false>(rows, taps, k, T, ty0 + p, tx);
        __syncthreads();  // rows[] is rewritten by the next filter
    }

    const int gx = x0 + tx;
    if (gx >= w) return;
    const size_t base = (size_t)blockIdx.z * plane + gx;
#pragma unroll
    for (int p = 0; p < kRowsPerThread; ++p) {
        const int gy = y0 + ty0 + p;
        if (gy < h) {
            float b[K];
#pragma unroll
            for (int k = 0; k < K; ++k) b[k] = acc[k][p];
            const size_t o = base + (size_t)gy * w;
            if constexpr (kFeatures) {
                const G2Features f = g2_feature_tail(b);
                store(edges + o, f.score);
                store(dark + o, f.ct);
                store(bright + o, f.st);
            } else {
                Maps m;
                if constexpr (K == kG4K) {
                    m = g4_tail(b, q);
                } else {
                    m = g2_tail(b);
                }
                store(edges + o, m.edges);
                store(dark + o, m.dark);
                store(bright + o, m.bright);
            }
        }
    }
}

template <int K, bool kFeatures = false>
int launch_maps(const float* in, void* e, void* d, void* b, int n, int h, int w, int t,
                const float* xtaps, const float* ytaps, const G4Weights& q, int bf16,
                void* stream) {
    if (t < 1 || t > kMaxT || (t % 2) == 0 || n < 1 || h < 1 || w < 1) {
        return (int)cudaErrorInvalidValue;
    }
    const SepTaps taps = pack_taps(xtaps, ytaps, K, t);
    dim3 grid(ceil_div(w, kTileW), ceil_div(h, kTileH), n);
    cudaStream_t s = (cudaStream_t)stream;
    if constexpr (kFeatures) {
        maps_kernel<K, float, true><<<grid, kThreads, 0, s>>>(in, (float*)e, (float*)d, (float*)b,
                                                              h, w, t, taps, q);
    } else if (bf16) {
        using T = __nv_bfloat16;
        maps_kernel<K, T><<<grid, kThreads, 0, s>>>(in, (T*)e, (T*)d, (T*)b, h, w, t, taps, q);
    } else {
        maps_kernel<K, float><<<grid, kThreads, 0, s>>>(in, (float*)e, (float*)d, (float*)b,
                                                        h, w, t, taps, q);
    }
    return (int)cudaGetLastError();
}

}  // namespace

CVS_EXPORT int cvs_maps_g2(const float* in, void* edges, void* dark, void* bright, int n,
                           int h, int w, int t, const float* xtaps, const float* ytaps,
                           int bf16, void* stream) {
    return launch_maps<kG2K>(in, edges, dark, bright, n, h, w, t, xtaps, ytaps, G4Weights{},
                             bf16, stream);
}

// E′: score, ct and st in float32.
CVS_EXPORT int cvs_features_g2(const float* in, float* score, float* ct, float* st, int n, int h,
                               int w, int t, const float* xtaps, const float* ytaps,
                               void* stream) {
    return launch_maps<kG2K, true>(in, score, ct, st, n, h, w, t, xtaps, ytaps, G4Weights{}, 0,
                                   stream);
}

// terms: [n_terms, 3] int32 (i, j, slot) and [n_terms] float32 weights, the
// list of ops/cuda_frontend.py::g4_live_terms; it must be kernel E's list.
CVS_EXPORT int cvs_maps_g4(const float* in, void* edges, void* dark, void* bright, int n,
                           int h, int w, int t, const float* xtaps, const float* ytaps,
                           const int* terms, const float* weights, int n_terms, int bf16,
                           void* stream) {
    if (n_terms != kG4Terms || terms == nullptr || weights == nullptr) {
        return (int)cudaErrorInvalidValue;
    }
    G4Weights q;
    for (int i = 0; i < kG4Terms; ++i) {
        const G4Term term = g4_term(i);
        if (terms[3 * i] != term.i || terms[3 * i + 1] != term.j || terms[3 * i + 2] != term.slot) {
            return (int)cudaErrorInvalidValue;
        }
        q.w[i] = weights[i];
    }
    return launch_maps<kG4K>(in, edges, dark, bright, n, h, w, t, xtaps, ytaps, q, bf16, stream);
}
