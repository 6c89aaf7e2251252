// Kernel C: the detector maps of every pyramid level of a frame in one
// launch (g2_features_full, g2_features_levels).
//
// Replaces: cvsteer_tpu/ops/pallas_frontend.py::g2_features_full_pallas
// (_g2_features_full_kernel); the contract is the reference's
// _g2_features_full_reference_xla, and the plain version
// ops/cuda_frontend.py::g2_features_full_plain. From the image of one level
// it produces, per pixel:
//   basis   the 7 G2/H2 responses (kernel A's bank: cross-correlation,
//           REFLECT_101 that keeps reflecting, fp32);
//   ct, st  the half-angle orientation of the G2 feature tail (common.cuh);
//   dy, dx  quadratic subpixel offsets of the corner score c1 - |(c2, c3)|,
//           zero on the outer 1-pixel frame;
//   p3      the centred 3x3 max of the score masked by NMS over a
//           (2r+1)^2 window (outside the image counts as -inf), the
//           threshold and the border >= r + 1, with each survivor's
//           (y%3)*3 + x%3 offset in the low 4 mantissa bits of its score
//           (int32 view) and P3_SENTINEL where masked; p3[1::3, 1::3] is
//           then the 3x3-cell max table.
//
// What bounds it on the card: memory traffic. Per pixel it reads the image
// (4 B) and writes the basis (28 B) and five maps (20 B); at the 5-level
// 480x640 pyramid that is 21 MB per frame. The arithmetic (the 7-filter
// bank, ~70 flops of tail, the NMS window) is ~280 flops per pixel,
// recomputed on each tile's halo.
//
// What the design does about it: one launch walks a table of tiles that
// covers every level of the frame (levels and their pointers pass by value
// in a struct), so the small levels share the launch and the SMs with the
// large ones. A block stages its 32x64 tile of the image once, with a halo
// of r + nms + 1 pixels, and keeps everything else in shared memory and
// registers: the row passes of the distinct x-tap vectors (the G2/H2 bank
// has 6 of 7), the column passes with the 7 responses of a pixel in
// registers, where the feature tail runs, the score of the tile plus its
// (nms + 1) ring, and the packed NMS map. The basis is written once, for
// the tile's interior (the descriptors sample it); the score and the packed
// map never touch device memory. Each thread computes a strip of 8 outputs
// per pass from a window of registers (common.cuh strip_pass), and the
// block syncs once per stage. The TPU kernel fused the same stages into one
// pass per level; here one pass serves the whole pyramid.
//
// Bits: built with --fmad=false, the bank summing taps in order from t = 0
// as the plain version does, the tail in the plain version's expressions:
// kernel and plain version agree to the bit.
#include "common.cuh"

namespace {

constexpr float kSentinel = -0x1.fep+127f;  // -255 * 2^120 (P3_SENTINEL)
// The tile; kernels/tile_sweep.py builds other shapes with -D to measure them.
#ifndef CVS_C_TILE_H
#define CVS_C_TILE_H 32
#endif
#ifndef CVS_C_TILE_W
#define CVS_C_TILE_W 64
#endif
constexpr int kTileW = CVS_C_TILE_W;
constexpr int kTileH = CVS_C_TILE_H;
constexpr int kMaxNms = 4;
constexpr int kMaxLevels = 16;
constexpr int kK = 7;         // the G2/H2 bank
constexpr int kStripW = 8;    // row pass: outputs per thread, along a row
constexpr int kStripH = 8;    // column pass: outputs per thread, down a column
constexpr int kThreads = 256;

struct Level {
    const float* image;
    float *basis, *p3, *dy, *dx, *ct, *st;
    int h, w, tiles_x, tiles_per_image;
};

struct Levels {
    Level lv[kMaxLevels];
    int first_tile[kMaxLevels + 1];
    int n_levels;
};

// The bank by value: the x taps of each distinct row pass, the y taps of
// each filter, and the row pass each filter's column pass reads.
struct Bank {
    float x[kK][kBankMaxT];
    float y[kK][kBankMaxT];
    int row_of[kK];
    int n_rows;
};

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

// Shared-memory layout of one block, the same on host and device. The
// image and row buffers have odd row strides: the row pass's neighbouring
// threads work on neighbouring rows, so odd strides keep their loads and
// stores on distinct banks.
struct Layout {
    int hs;        // score ring: nms + 1
    int sh, sw;    // score region: the tile plus the ring
    int swr, shc;  // score region rounded up to whole strips
    int ih, iw;    // staged image rows, row stride
    int rs;        // row-buffer stride
    int image, rows, score;  // offsets in floats
    int floats;

    __host__ __device__ Layout(int nms, int R, int n_rows) {
        hs = nms + 1;
        sh = kTileH + 2 * hs;
        sw = kTileW + 2 * hs;
        swr = round_up(sw, kStripW);
        shc = round_up(sh, kStripH);
        ih = shc + 2 * R;
        iw = (swr + 2 * R) | 1;
        rs = swr | 1;
        image = 0;
        rows = image + ih * iw;
        score = rows + n_rows * ih * rs;
        floats = score + sh * sw;
    }
};

template <int R>
__global__ void __launch_bounds__(kThreads, 2)
g2_features_kernel(const __grid_constant__ Levels L, const __grid_constant__ Bank bank, int nms,
                   float threshold) {
    constexpr int T = 2 * R + 1;
    extern __shared__ __align__(16) float smem[];
    const Layout lay(nms, R, bank.n_rows);
    float* img = smem + lay.image;
    float* rows = smem + lay.rows;
    float* s = smem + lay.score;
    float* packed = smem + lay.image;  // the image is dead by the select stage
    const int tid = threadIdx.x;
    const float ninf = -INFINITY;

    // this block's level, image and tile
    int l = 0;
    while (l + 1 < L.n_levels && (int)blockIdx.x >= L.first_tile[l + 1]) ++l;
    const Level& lv = L.lv[l];
    const int h = lv.h, w = lv.w;
    const int local = blockIdx.x - L.first_tile[l];
    const int n_img = local / lv.tiles_per_image;
    const int t_img = local - n_img * lv.tiles_per_image;
    const int ty = t_img / lv.tiles_x;
    const int y0 = ty * kTileH, x0 = (t_img - ty * lv.tiles_x) * kTileW;
    const size_t plane = (size_t)h * w;
    const int hs = lay.hs;

    // 1. stage the image: the score region plus the bank's radius
    stage_reflect(img, lay.iw, lv.image + n_img * plane, h, w, y0 - hs - R, x0 - hs - R, lay.ih,
                  lay.iw);
    __syncthreads();

    // 2. row passes, one per distinct x-tap vector: rows[d][y][0 .. swr)
    {
        const int strips = lay.swr / kStripW;
        for (int i = tid; i < lay.ih * strips; i += kThreads) {
            const int strip = i / lay.ih, y = i - strip * lay.ih;
            const int c0 = strip * kStripW;
            float win[kStripW + T - 1];
            const float* src = img + y * lay.iw + c0;
#pragma unroll
            for (int j = 0; j < kStripW + T - 1; ++j) win[j] = src[j];
            for (int d = 0; d < bank.n_rows; ++d) {
                float out[kStripW];
                strip_pass<T, kStripW>(win, bank.x[d], out);
                float* dst = rows + (d * lay.ih + y) * lay.rs + c0;
#pragma unroll
                for (int p = 0; p < kStripW; ++p) dst[p] = out[p];
            }
        }
    }
    __syncthreads();

    // 3. column passes of the 7 filters for a strip of one column, the
    // feature tail in registers; the score of the region to shared memory,
    // the basis, ct and st of the tile's interior to device memory
    {
        const int strips = lay.shc / kStripH;
        for (int i = tid; i < strips * lay.sw; i += kThreads) {
            const int strip = i / lay.sw, c = i - strip * lay.sw;
            const int r0 = strip * kStripH;
            float b[kK][kStripH];
#pragma unroll
            for (int k = 0; k < kK; ++k) {
                float win[kStripH + T - 1];
                const float* src = rows + (bank.row_of[k] * lay.ih + r0) * lay.rs + c;
#pragma unroll
                for (int j = 0; j < kStripH + T - 1; ++j) win[j] = src[j * lay.rs];
                strip_pass<T, kStripH>(win, bank.y[k], b[k]);
            }
            const int gx = x0 - hs + c;
            const bool col_in = gx >= 0 && gx < w;
            const bool col_tile = c >= hs && c < hs + kTileW;
#pragma unroll
            for (int p = 0; p < kStripH; ++p) {
                const int sy = r0 + p;
                if (sy >= lay.sh) break;
                const int gy = y0 - hs + sy;
                float score = ninf;  // outside the image: the NMS pad
                if (col_in && gy >= 0 && gy < h) {
                    float px[kK];
#pragma unroll
                    for (int k = 0; k < kK; ++k) px[k] = b[k][p];
                    const G2Features f = g2_feature_tail(px);
                    score = f.score;
                    if (col_tile && sy >= hs && sy < hs + kTileH) {
                        const size_t o = n_img * plane + (size_t)gy * w + gx;
                        float* bs = lv.basis + n_img * kK * plane + (size_t)gy * w + gx;
#pragma unroll
                        for (int k = 0; k < kK; ++k) bs[k * plane] = px[k];
                        lv.ct[o] = f.ct;
                        lv.st[o] = f.st;
                    }
                }
                s[sy * lay.sw + c] = score;
            }
        }
    }
    __syncthreads();

    // 4. the packed NMS map over the tile plus a 1-pixel ring (the pool's
    // window)
    const int border = nms + 1;
    constexpr int PW = kTileW + 2;
    for (int i = tid; i < (kTileH + 2) * PW; i += kThreads) {
        const int py = i / PW, px = i - (i / PW) * PW;
        const int gy = y0 - 1 + py, gx = x0 - 1 + px;
        float v = ninf;  // outside the image: the pooling pad
        if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
            const float* sc = s + (py - 1 + hs) * lay.sw + (px - 1 + hs);
            float mx = ninf;
            for (int dy = -nms; dy <= nms; ++dy)
                for (int dx = -nms; dx <= nms; ++dx) mx = fmaxf(mx, sc[dy * lay.sw + dx]);
            const bool keep = (*sc >= mx) && (*sc > threshold) && gy >= border &&
                              gy < h - border && gx >= border && gx < w - border;
            if (keep) {
                const int obits = (gy % 3) * 3 + gx % 3;
                v = __int_as_float((__float_as_int(*sc) & ~15) | obits);
            } else {
                v = kSentinel;
            }
        }
        packed[i] = v;
    }
    __syncthreads();

    // 5. the 3x3 pool and the subpixel offsets of the tile
    for (int i = tid; i < kTileH * kTileW; i += kThreads) {
        const int oy = i / kTileW, ox = i - (i / kTileW) * kTileW;
        const int gy = y0 + oy, gx = x0 + ox;
        if (gy >= h || gx >= w) continue;
        float m = ninf;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) m = fmaxf(m, packed[(oy + dy) * PW + ox + dx]);
        const size_t o = n_img * plane + (size_t)gy * w + gx;
        lv.p3[o] = m;

        float dyv = 0.0f, dxv = 0.0f;
        if (gy >= 1 && gy < h - 1 && gx >= 1 && gx < w - 1) {
            const float* sc = s + (oy + hs) * lay.sw + ox + hs;
            const float c = sc[0];
            const float up = sc[-lay.sw], down = sc[lay.sw];
            const float left = sc[-1], right = sc[1];
            const float den_y = up - 2.0f * c + down;
            const float den_x = left - 2.0f * c + right;
            dyv = fabsf(den_y) > 1e-12f ? 0.5f * (up - down) / den_y : 0.0f;
            dxv = fabsf(den_x) > 1e-12f ? 0.5f * (left - right) / den_x : 0.0f;
            dyv = fminf(fmaxf(dyv, -0.5f), 0.5f);
            dxv = fminf(fmaxf(dxv, -0.5f), 0.5f);
        }
        lv.dy[o] = dyv;
        lv.dx[o] = dxv;
    }
}

template <int R>
int launch(const Levels& L, const Bank& bank, int nms, float threshold, int blocks,
           cudaStream_t stream) {
    const size_t bytes = sizeof(float) * Layout(nms, R, bank.n_rows).floats;
    static size_t granted = 48 * 1024;  // per instantiation: what the runtime allows so far
    if (bytes > granted) {
        const cudaError_t e = cudaFuncSetAttribute(
            g2_features_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (e != cudaSuccess) return (int)e;
        granted = bytes;
    }
    g2_features_kernel<R><<<blocks, kThreads, bytes, stream>>>(L, bank, nms, threshold);
    return (int)cudaGetLastError();
}

}  // namespace

// ptrs: [n_levels, 7] device pointers (image, basis, p3, dy, dx, ct, st) per
// level; hw: [n_levels, 2] (h, w); every level holds n images. xtaps/ytaps:
// the [7, t] bank (host).
CVS_EXPORT int cvs_g2_features(const long long* ptrs, const int* hw, int n_levels, int n, int t,
                               const float* xtaps, const float* ytaps, float threshold,
                               int nms_radius, void* stream) {
    if (n_levels < 1 || n_levels > kMaxLevels || n < 1 || t < 3 || t > 13 || (t % 2) == 0 ||
        nms_radius < 1 || nms_radius > kMaxNms) {
        return (int)cudaErrorInvalidValue;
    }
    Levels L = {};
    L.n_levels = n_levels;
    int tiles = 0;
    for (int l = 0; l < n_levels; ++l) {
        const long long* p = ptrs + 7 * l;
        Level& lv = L.lv[l];
        lv.image = (const float*)p[0];
        lv.basis = (float*)p[1];
        lv.p3 = (float*)p[2];
        lv.dy = (float*)p[3];
        lv.dx = (float*)p[4];
        lv.ct = (float*)p[5];
        lv.st = (float*)p[6];
        lv.h = hw[2 * l];
        lv.w = hw[2 * l + 1];
        if (lv.h < 1 || lv.w < 1) return (int)cudaErrorInvalidValue;
        lv.tiles_x = ceil_div(lv.w, kTileW);
        lv.tiles_per_image = lv.tiles_x * ceil_div(lv.h, kTileH);
        L.first_tile[l] = tiles;
        tiles += n * lv.tiles_per_image;
    }
    L.first_tile[n_levels] = tiles;

    // the row passes: one per x-tap vector not bit-equal to an earlier one
    Bank bank = {};
    for (int k = 0; k < kK; ++k) {
        int d = 0;
        while (d < bank.n_rows) {
            bool same = true;
            for (int j = 0; j < t; ++j) same &= bank.x[d][j] == xtaps[k * t + j];
            if (same) break;
            ++d;
        }
        if (d == bank.n_rows) {
            for (int j = 0; j < t; ++j) bank.x[d][j] = xtaps[k * t + j];
            ++bank.n_rows;
        }
        bank.row_of[k] = d;
        for (int j = 0; j < t; ++j) bank.y[k][j] = ytaps[k * t + j];
    }

    cudaStream_t s = (cudaStream_t)stream;
    switch ((t - 1) / 2) {
        case 1: return launch<1>(L, bank, nms_radius, threshold, tiles, s);
        case 2: return launch<2>(L, bank, nms_radius, threshold, tiles, s);
        case 3: return launch<3>(L, bank, nms_radius, threshold, tiles, s);
        case 4: return launch<4>(L, bank, nms_radius, threshold, tiles, s);
        case 5: return launch<5>(L, bank, nms_radius, threshold, tiles, s);
        default: return launch<6>(L, bank, nms_radius, threshold, tiles, s);
    }
}
