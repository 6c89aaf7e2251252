// Kernel F: adjoint of the separable bank (the backward of kernel A),
// grad [N, K, H, W] -> grad_image [N, H, W], in one launch.
//
// Replaces: the backward of cvsteer_tpu/ops/pallas_frontend.py::
// filter_bank_pallas_diff (custom VJP whose backward was XLA's VJP of
// filter_bank_xla). Plain version: ops/cuda_frontend.py::
// filter_bank_adjoint_plain.
//
// Contract: with r = (T - 1) / 2 and the REFLECT_101-padded image
// P[y][x] = img[reflect(y)][reflect(x)] for y in [-r, H + r), the forward is
// out_k[y][x] = sum_v yt_k[v] sum_u xt_k[u] P[y - r + v][x - r + u], so
//   gP[y][x] = sum_k sum_v yt_k[v] row_k[y + r - v][x],
//   row_k[y][x] = sum_u xt_k[u] g_k[y][x + r - u]
// over the zero-extended gradient (row_k is 0 on rows outside the image),
// and grad_image[a][b] sums gP over every padded position whose reflect is
// (a, b): first the rows' fold, then the columns', each summing the lower
// pad in ascending position, then the interior, then the upper pad. The
// periodic reflect map keeps the fold right where the pad exceeds the
// dimension (1x1, 2x2, 3x5 pyramid levels).
//
// What bounds it on the card: memory traffic. It reads K x 4 bytes and
// writes 4 per pixel, against 2 K (2T - 1) flops per pixel in the plain
// order — about 6 flops per byte for G2, under the card's ~20 per byte.
//
// What the design does about it: a block owns a TH x TW tile of grad_image
// and computes gP on it, plus, where a pad folds into the tile, on the tile
// extended by r toward that border (corners included). Per filter k:
//   - the gradient plane's patch arrives in a two-plane ring in shared
//     memory by cp.async, the 4-byte form zero-filling outside the plane,
//     so filter k + 1's patch loads while filter k's passes run;
//   - the transposed row pass (strip_pass_flip: register windows, flipped
//     taps, T a template constant) into one of two row buffers;
//   - the transposed column pass, each thread on the same column strips for
//     every filter, summing over K in registers in filter order.
// Filter k's row pass and filter k - 1's column pass share one phase, so a
// block passes one barrier per filter. Interior tiles store gP as it is
// (0 + gP: the plain fold adds it to 0); border tiles write gP to shared
// memory and fold it there before their one store. No buffer in device
// memory.
//
// Bits: --fmad=false, taps in order, K summed in order and each fold summed
// in ascending padded position — the plain version's order, to the bit.
#include "common.cuh"

namespace {

// The tile and the strips (kernels/tile_sweep.py builds others with -D;
// PERF.md has its table).
#ifndef CVS_F_TILE_H
#define CVS_F_TILE_H 16
#endif
#ifndef CVS_F_TILE_W
#define CVS_F_TILE_W 64
#endif
#ifndef CVS_F_ROW_STRIP
#define CVS_F_ROW_STRIP 8
#endif
#ifndef CVS_F_COL_STRIP
#define CVS_F_COL_STRIP 4
#endif
#ifndef CVS_F_MIN_BLOCKS
#define CVS_F_MIN_BLOCKS 3  // blocks per SM the registers must allow
#endif

constexpr int kMaxR = 6;
constexpr int kThreads = 256;
constexpr int kTileH = CVS_F_TILE_H;
constexpr int kTileW = CVS_F_TILE_W;
constexpr int kRowStrip = CVS_F_ROW_STRIP;  // row pass: outputs per thread, along a row
constexpr int kColStrip = CVS_F_COL_STRIP;  // column pass: outputs per thread, down a column
// A pad folds into the first and last tiles only (or, where a level is
// narrower than the pad, into its one tile).
static_assert(kTileH > kMaxR && kTileW > kMaxR, "tiles must be wider than the pad");

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

// Shared-memory layout for radius R, in floats: two gradient planes (the
// cp.async ring), then two row buffers. The border tiles reuse them for gP
// (in plane 0) and the rows' fold (in row buffer 0).
template <int R>
struct AdjLayout {
    static constexpr int T = 2 * R + 1;
    // the largest gP region: a tile extended by r at both ends, and by r
    // more where the level is up to r longer than one tile
    static constexpr int gh = kTileH + 3 * R;
    static constexpr int gw = kTileW + 3 * R;
    static constexpr int rows_h = round_up(gh, kColStrip) + 2 * R;  // row-pass rows
    static constexpr int rows_w = round_up(gw, kRowStrip);
    static constexpr int rows_ld = rows_w | 1;
    static constexpr int plane_ld = (rows_w + 2 * R) | 1;  // staged columns
    static constexpr int plane = rows_h * plane_ld;
    static constexpr int rows_at = 2 * plane;
    static constexpr int rows = rows_h * rows_ld;  // one of the two row buffers
    static constexpr int gp_ld = gw | 1;
    static constexpr int max_strips = (gh + kColStrip - 1) / kColStrip * gw;
    static constexpr int strips_per_thread = (max_strips + kThreads - 1) / kThreads;
    static constexpr size_t bytes = sizeof(float) * (size_t)(rows_at + 2 * rows);
    static_assert(gh * gp_ld <= plane && kTileH * gp_ld <= rows, "fold buffers");
};

template <int R>
__global__ void __launch_bounds__(kThreads, CVS_F_MIN_BLOCKS)
adj_kernel(const float* __restrict__ g, float* __restrict__ out, int h, int w, int K,
           const __grid_constant__ SepTaps taps) {
    using L = AdjLayout<R>;
    constexpr int T = L::T;
    extern __shared__ __align__(16) float smem[];
    __shared__ int refl_y[2 * R + 1], refl_x[2 * R + 1];

    // the tile and the gP region [p0, p1) x [q0, q1) it needs
    const int y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;
    const int y1 = min(y0 + kTileH, h), x1 = min(x0 + kTileW, w);
    const int p0 = y0 <= R ? -R : y0, p1 = y1 + R >= h ? h + R : y1;
    const int q0 = x0 <= R ? -R : x0, q1 = x1 + R >= w ? w + R : x1;
    const int nh = p1 - p0, nw = q1 - q0;
    const bool border = p0 != y0 || p1 != y1 || q0 != x0 || q1 != x1;
    const int col_strips = ceil_div(nh, kColStrip);
    const int n_rows = col_strips * kColStrip + 2 * R;  // row-pass rows from p0 - R
    const int row_strips = ceil_div(nw, kRowStrip);
    const int n_cols = row_strips * kRowStrip + 2 * R;  // staged columns from q0 - R
    const size_t plane = (size_t)h * w;
    const float* gimg = g + (size_t)blockIdx.z * K * plane;

    // gradient rows [p0 - R, p0 - R + n_rows) x columns [q0 - R, q0 - R + n_cols)
    // of filter k into ring plane k & 1, zero outside the plane
    auto stage = [&](int k) {
        const float* src = gimg + (size_t)k * plane;
        float* dst = smem + (k & 1) * L::plane;
        const int lane = threadIdx.x & 31;
        for (int ty = threadIdx.x >> 5; ty < n_rows; ty += kThreads / 32) {
            const int gy = p0 - R + ty;
            const bool in_y = (unsigned)gy < (unsigned)h;
            for (int tx = lane; tx < n_cols; tx += 32) {
                const int gx = q0 - R + tx;
                const bool in = in_y && (unsigned)gx < (unsigned)w;
                cp_async_zfill4(dst + ty * L::plane_ld + tx, in ? src + (size_t)gy * w + gx : src,
                                in);
            }
        }
        cp_async_commit();
    };

    // transposed row pass of filter k over the row-pass rows, into row
    // buffer k & 1; rows outside the plane are 0, as the plain version pads them
    auto row_pass = [&](int k) {
        float xk[T];
#pragma unroll
        for (int t = 0; t < T; ++t) xk[t] = taps.x[k][t];
        const float* gs = smem + (k & 1) * L::plane;
        float* const rows = smem + L::rows_at + (k & 1) * L::rows;
        for (int i = threadIdx.x; i < n_rows * row_strips; i += kThreads) {
            const int s = i / n_rows, y = i - s * n_rows;  // neighbouring threads, neighbouring rows
            const int c0 = s * kRowStrip;
            float o[kRowStrip];
            if ((unsigned)(p0 - R + y) < (unsigned)h) {
                float win[kRowStrip + T - 1];
                const float* src = gs + y * L::plane_ld + c0;
#pragma unroll
                for (int j = 0; j < kRowStrip + T - 1; ++j) win[j] = src[j];
                strip_pass_flip<T, kRowStrip>(win, xk, o);
            } else {
#pragma unroll
                for (int p = 0; p < kRowStrip; ++p) o[p] = 0.0f;
            }
            float* dst = rows + y * L::rows_ld + c0;
#pragma unroll
            for (int p = 0; p < kRowStrip; ++p) dst[p] = o[p];
        }
    };
    // transposed column pass of filter k from row buffer k & 1: the same
    // strips for every filter, summed over K in registers in filter order
    float acc[L::strips_per_thread][kColStrip];
    auto col_pass = [&](int k) {
        float yk[T];
#pragma unroll
        for (int t = 0; t < T; ++t) yk[t] = taps.y[k][t];
        const float* const rows = smem + L::rows_at + (k & 1) * L::rows;
#pragma unroll
        for (int q = 0; q < L::strips_per_thread; ++q) {
            const int i = threadIdx.x + q * kThreads;
            if (i >= col_strips * nw) break;
            const int s = i / nw, c = i - s * nw;  // a warp's lanes on neighbouring columns
            float win[kColStrip + T - 1];
            const float* src = rows + s * kColStrip * L::rows_ld + c;
#pragma unroll
            for (int j = 0; j < kColStrip + T - 1; ++j) win[j] = src[j * L::rows_ld];
            float o[kColStrip];
            strip_pass_flip<T, kColStrip>(win, yk, o);
#pragma unroll
            for (int p = 0; p < kColStrip; ++p) acc[q][p] = k == 0 ? o[p] : acc[q][p] + o[p];
        }
    };

    // one barrier per filter: phase k runs filter k's row pass and filter
    // k - 1's column pass while filter k + 1's plane loads
    stage(0);
    for (int k = 0; k <= K; ++k) {
        if (k < K) cp_async_wait<0>();  // plane k, the one group in flight
        __syncthreads();  // plane k has landed; phase k - 1 is done everywhere
        if (k + 1 < K) stage(k + 1);  // its plane was last read in phase k - 1
        if (k < K) row_pass(k);
        if (k > 0) col_pass(k - 1);
    }

    float* const img_out = out + (size_t)blockIdx.z * plane;
    if (!border) {  // no pad folds here: 0 + gP
#pragma unroll
        for (int q = 0; q < L::strips_per_thread; ++q) {
            const int i = threadIdx.x + q * kThreads;
            if (i >= col_strips * nw) break;
            const int s = i / nw, c = i - s * nw;
#pragma unroll
            for (int p = 0; p < kColStrip; ++p) {
                const int y = p0 + s * kColStrip + p;
                if (y < p1) img_out[(size_t)y * w + q0 + c] = 0.0f + acc[q][p];
            }
        }
        return;
    }

    // border tile: gP into shared memory, then the rows' fold, then the columns'
    __syncthreads();  // every thread is done with the ring and the row buffer
    float* const gp = smem;
#pragma unroll
    for (int q = 0; q < L::strips_per_thread; ++q) {
        const int i = threadIdx.x + q * kThreads;
        if (i >= col_strips * nw) break;
        const int s = i / nw, c = i - s * nw;
#pragma unroll
        for (int p = 0; p < kColStrip; ++p) {
            const int r = s * kColStrip + p;
            if (r < nh) gp[r * L::gp_ld + c] = acc[q][p];
        }
    }
    // where each pad position reflects to: j < R the lower pad -R + j, then
    // the upper pad n + j - R
    if ((int)threadIdx.x < 2 * R) {
        const int j = threadIdx.x;
        refl_y[j] = reflect101(j < R ? j - R : h + j - R, h);
        refl_x[j] = reflect101(j < R ? j - R : w + j - R, w);
    }
    __syncthreads();
    // the rows' fold: rf[a - y0][x - q0] for the tile's rows a, every gP column x
    float* const rf = smem + L::rows_at;
    const int th = y1 - y0;
    for (int i = threadIdx.x; i < th * nw; i += kThreads) {
        const int ar = i / nw, c = i - ar * nw;
        const int a = y0 + ar;
        const float* col = gp + c;
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < R; ++j) {
            if (refl_y[j] == a) s = s + col[(j - R - p0) * L::gp_ld];
        }
        s = s + col[(a - p0) * L::gp_ld];
#pragma unroll
        for (int j = R; j < 2 * R; ++j) {
            if (refl_y[j] == a) s = s + col[(h + j - R - p0) * L::gp_ld];
        }
        rf[ar * L::gp_ld + c] = s;
    }
    __syncthreads();
    // the columns' fold, and the tile's one store
    const int tw = x1 - x0;
    for (int i = threadIdx.x; i < th * tw; i += kThreads) {
        const int ar = i / tw, bc = i - ar * tw;
        const int b = x0 + bc;
        const float* row = rf + ar * L::gp_ld - q0;
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < R; ++j) {
            if (refl_x[j] == b) s = s + row[j - R];
        }
        s = s + row[b];
#pragma unroll
        for (int j = R; j < 2 * R; ++j) {
            if (refl_x[j] == b) s = s + row[w + j - R];
        }
        img_out[(size_t)(y0 + ar) * w + b] = s;
    }
}

template <int R>
int launch(const float* grad, float* out, int n, int h, int w, int k, const SepTaps& taps,
           cudaStream_t stream) {
    static size_t granted = 48 * 1024;
    const cudaError_t e = allow_smem(adj_kernel<R>, AdjLayout<R>::bytes, granted);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(ceil_div(w, kTileW), ceil_div(h, kTileH), n);
    adj_kernel<R><<<grid, kThreads, AdjLayout<R>::bytes, stream>>>(grad, out, h, w, k, taps);
    return (int)cudaGetLastError();
}

}  // namespace

CVS_EXPORT int cvs_filter_bank_adj(const float* grad, float* out, int n, int h, int w, int k,
                                   int t, const float* xtaps, const float* ytaps, void* stream) {
    if (k < 1 || k > kBankMaxK || t < 1 || t > 2 * kMaxR + 1 || (t % 2) == 0 || n < 1 ||
        n > 65535 || h < 1 || w < 1) {
        return (int)cudaErrorInvalidValue;
    }
    const SepTaps taps = pack_taps(xtaps, ytaps, k, t);
    cudaStream_t s = (cudaStream_t)stream;
    switch ((t - 1) / 2) {
        case 0: return launch<0>(grad, out, n, h, w, k, taps, s);
        case 1: return launch<1>(grad, out, n, h, w, k, taps, s);
        case 2: return launch<2>(grad, out, n, h, w, k, taps, s);
        case 3: return launch<3>(grad, out, n, h, w, k, taps, s);
        case 4: return launch<4>(grad, out, n, h, w, k, taps, s);
        case 5: return launch<5>(grad, out, n, h, w, k, taps, s);
        default: return launch<6>(grad, out, n, h, w, k, taps, s);
    }
}
