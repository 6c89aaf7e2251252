// Kernel E′, the G2 feature tail on the maps template (maps.cuh): image
// [N, H, W] -> (score, ct, st) [N, H, W] float32, the corner score
// c1 - |(c2, c3)| and the half-angle orientation.
//
// Replaces: cvsteer_tpu/ops/pallas_frontend.py::g2_maps_tiled_pallas mode
// "features" (g2_feature_maps_pallas). Plain version: ops/cuda_frontend.py::
// g2_feature_maps_plain of ops/sepconv.py::filter_bank_plain. The tail is
// common.cuh's g2_feature_tail, kernel C′'s.
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

struct G2FeatureTail {
    static constexpr int K = 7, TH = CVS_E_TILE_H, TW = CVS_E_TILE_W, SH = CVS_E_STRIP_H,
                         SW = CVS_E_ROW_STRIP;
    using Params = NoParams;

    __device__ static void apply(const float (&b)[K], const Params&, float (&out)[3]) {
        const G2Features f = g2_feature_tail(b);
        out[0] = f.score;
        out[1] = f.ct;
        out[2] = f.st;
    }
};

}  // namespace

CVS_EXPORT int cvs_features_g2(const float* in, float* score, float* ct, float* st, int n, int h,
                               int w, int t, const float* xtaps, const float* ytaps,
                               void* stream) {
    return launch_maps<G2FeatureTail, float>(in, score, ct, st, n, h, w, t, xtaps, ytaps,
                                             NoParams{}, stream);
}
