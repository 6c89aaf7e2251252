// Kernel E, G2/H2 instantiation of the maps template (maps.cuh): image
// [N, H, W] -> (edges, lines_dark, lines_bright) [N, H, W] in float32 or
// bfloat16.
//
// Replaces: cvsteer_tpu/ops/pallas_frontend.py::g2_maps_tiled_pallas mode
// "maps" (g2_maps_pallas). Plain version: ops/cuda_frontend.py::
// g2_maps_plain.
//
// The tail is the TPU kernel's sqrt-free steering: the energy's second
// harmonic (c2, c3) from Freeman & Adelson's table gives (u, v) = (cos 2t,
// sin 2t); the steered even response g and the square of the odd one h^2
// are polynomials in u, v; then maps_out. Every expression is the plain
// version's, in its order, one rounding per operation.
#include "maps.cuh"

namespace {

// The tile, the column-strip height and the row-strip width (kernels/
// tile_sweep.py builds others with -D to measure them; PERF.md has its table).
#ifndef CVS_E_TILE_H
#define CVS_E_TILE_H 32
#endif
#ifndef CVS_E_TILE_W
#define CVS_E_TILE_W 32
#endif
#ifndef CVS_E_ROW_STRIP
#define CVS_E_ROW_STRIP 8
#endif
#ifndef CVS_E_STRIP_H
#define CVS_E_STRIP_H 4
#endif

struct G2MapsTail {
    static constexpr int K = 7, TH = CVS_E_TILE_H, TW = CVS_E_TILE_W, SH = CVS_E_STRIP_H,
                         SW = CVS_E_ROW_STRIP;
    using Params = NoParams;

    __device__ static void apply(const float (&b)[K], const Params&, float (&out)[3]) {
        float c2, c3;
        g2_harmonic_sd(b, c2, c3);
        g2_steer_maps(b, c2, c3, out);
    }
};

}  // namespace

CVS_EXPORT int cvs_maps_g2(const float* in, void* edges, void* dark, void* bright, int n,
                           int h, int w, int t, const float* xtaps, const float* ytaps,
                           int bf16, void* stream) {
    if (bf16) {
        return launch_maps<G2MapsTail, __nv_bfloat16>(in, edges, dark, bright, n, h, w, t, xtaps,
                                                      ytaps, NoParams{}, stream);
    }
    return launch_maps<G2MapsTail, float>(in, edges, dark, bright, n, h, w, t, xtaps, ytaps,
                                          NoParams{}, stream);
}
