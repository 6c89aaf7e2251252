// Kernel E4, G4/H4 instantiation of the maps template (maps.cuh): image
// [N, H, W] -> (edges, lines_dark, lines_bright) [N, H, W] in float32 or
// bfloat16, from the 11-filter bank.
//
// Replaces: cvsteer_tpu/ops/pallas_frontend.py::g2_maps_tiled_pallas mode
// "g4maps" (g4_maps_pallas). Plain version: ops/cuda_frontend.py::
// g4_maps_plain.
//
// The tail: the energy's second harmonic (c2, c3) from the reference's list
// of 33 products of the symmetrized quadratic tables, (u, v) = (cos 2t,
// sin 2t), the half-angle powers, the steered G4 response and the square of
// the steered H4 one, then maps_out. The product list has its indices
// compiled in, so the 11 responses stay in registers, and its weights pass
// by value with each launch.
//
// Registers: a thread holds 11 responses for each pixel of its column strip
// (44 at the default 4-row strip) while the tail runs; kernels/tile_sweep.py
// measures the tile and strip heights against spills and occupancy.
#include <utility>

#include "maps.cuh"

namespace {

// The tile, the column-strip height and the row-strip width (kernels/
// tile_sweep.py builds others with -D to measure them; PERF.md has its table).
// 64x32 keeps two blocks per SM (the 10 G4 row buffers take 114 KB) with
// less halo than 32x32; a 32x64 tile takes 128 KB, one block per SM.
#ifndef CVS_E4_TILE_H
#define CVS_E4_TILE_H 64
#endif
#ifndef CVS_E4_TILE_W
#define CVS_E4_TILE_W 32
#endif
#ifndef CVS_E4_ROW_STRIP
#define CVS_E4_ROW_STRIP 4
#endif
#ifndef CVS_E4_STRIP_H
#define CVS_E4_STRIP_H 4
#endif

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

template <int N>
__device__ __forceinline__ void g4_add_term(const float (&b)[11], const G4Weights& q, float& c2,
                                            float& c3) {
    constexpr G4Term t = g4_term(N);
    float& c = t.slot == 0 ? c2 : c3;
    c = c + (b[t.i] * b[t.j]) * q.w[N];
}

template <int... N>
__device__ __forceinline__ void g4_quad(const float (&b)[11], const G4Weights& q, float& c2,
                                        float& c3, std::integer_sequence<int, N...>) {
    (g4_add_term<N>(b, q, c2, c3), ...);  // in list order: a comma fold runs left to right
}

struct G4MapsTail {
    static constexpr int K = 11, TH = CVS_E4_TILE_H, TW = CVS_E4_TILE_W, SH = CVS_E4_STRIP_H;
    static constexpr int SW = CVS_E4_ROW_STRIP;
    using Params = G4Weights;

    __device__ static void apply(const float (&b)[K], const Params& q, float (&out)[3]) {
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
        maps_out(g4v, g4v * g4v, h4sq, out);
    }
};

}  // namespace

// terms: [n_terms, 3] int32 (i, j, slot) and [n_terms] float32 weights, the
// list of ops/cuda_frontend.py::g4_live_terms; it must be kernel E4's list.
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
    if (bf16) {
        return launch_maps<G4MapsTail, __nv_bfloat16>(in, edges, dark, bright, n, h, w, t, xtaps,
                                                      ytaps, q, stream);
    }
    return launch_maps<G4MapsTail, float>(in, edges, dark, bright, n, h, w, t, xtaps, ytaps, q,
                                          stream);
}
