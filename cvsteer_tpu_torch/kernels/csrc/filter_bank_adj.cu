// Kernel F: adjoint of the separable bank (the backward of kernel A),
// grad [N, K, H, W] -> grad_image [N, H, W].
//
// Replaces: the backward of cvsteer_tpu/ops/pallas_frontend.py::
// filter_bank_pallas_diff (custom VJP whose backward was XLA's VJP of
// filter_bank_xla). Plain version: ops/cuda_frontend.py::
// filter_bank_adjoint_plain.
//
// Contract: with R = T - 1 and the REFLECT_101-padded image P[i][j] =
// img[reflect(i - r)][reflect(j - r)], the forward is out_k[y][x] =
// sum_v yt_k[v] sum_u xt_k[u] P[y + v][x + u], so
//   gP[i][j] = sum_k sum_v yt_k[v] sum_u xt_k[u] g_k[i - v][j - u]
// over the zero-extended gradient (launch 1, into an [N, H + R, W + R]
// buffer), and grad_image[a][b] sums gP over every padded position whose
// reflect is (a, b) (launch 2). The fold walks the pad through the same
// periodic reflect map as the forward, so it stays right where the pad
// exceeds the dimension (1x1 and 2x2 pyramid levels).
//
// What bounds it on the card: memory traffic, as for kernel A: it reads
// K x 4 bytes and writes 4 per pixel (plus the padded buffer's round trip)
// against 2 K (2T - 1) flops per pixel — about 6 flops per byte for G2.
//
// What the design does about it: launch 1 has kernel A's shape and uses
// its helpers (common.cuh: zero-extended staging, the flipped row and
// column passes) — each block stages one filter's 32x64 gradient tile
// plus its halo in shared memory, runs the transposed row pass into a
// shared row buffer and the transposed column pass from there, and keeps the running sum over K for
// its 8 pixels in registers, so each padded output is written once.
// Launch 2 reads the padded buffer, which is 1 + 2R/H larger than the
// image, once per contribution.
//
// Bits: --fmad=false, taps in order, K summed in order and each fold
// summed in ascending padded position — the plain version's order.
#include "common.cuh"

namespace {

constexpr int kMaxT = 13;
constexpr int kMaxR2 = kMaxT - 1;
constexpr int kTileW = 64;
constexpr int kThreads = 256;
constexpr int kRowsPerThread = 8;
constexpr int kTileH = kRowsPerThread * (kThreads / kTileW);  // 32

__global__ void __launch_bounds__(kThreads)
adj_corr_kernel(const float* __restrict__ g, float* __restrict__ gp, int h, int w, int K,
                int T, const SepTaps taps) {
    __shared__ float gs[kTileH + kMaxR2][kTileW + kMaxR2];
    __shared__ float rows[kTileH + kMaxR2][kTileW];

    const int R = T - 1;
    const int hp = h + R, wp = w + R;
    const int j0 = blockIdx.x * kTileW;
    const int i0 = blockIdx.y * kTileH;
    const int img = blockIdx.z;
    const int th = kTileH + R;
    const int tx = threadIdx.x % kTileW;
    const int ty0 = (threadIdx.x / kTileW) * kRowsPerThread;
    const size_t plane = (size_t)h * w;

    float total[kRowsPerThread];
    for (int k = 0; k < K; ++k) {
        // gradient rows i0 - R .. i0 + 31, cols j0 - R .. j0 + 63, zero outside
        stage_tile<false>(gs, g + ((size_t)img * K + k) * plane, h, w, i0 - R, j0 - R, th,
                          kTileW + R);
        __syncthreads();
        // transposed row pass: row[y][j] = sum_u xt[u] g[y][j - u]
        row_pass<true>(gs, rows, taps, k, T, th);
        __syncthreads();
        // transposed column pass: col[i][j] = sum_v yt[v] row[i - v][j]
#pragma unroll
        for (int p = 0; p < kRowsPerThread; ++p) {
            const float a = col_at<true>(rows, taps, k, T, ty0 + p, tx);
            total[p] = k == 0 ? a : total[p] + a;
        }
        __syncthreads();  // gs[] and rows[] are rewritten by the next filter
    }

    const int j = j0 + tx;
    if (j >= wp) return;
    float* dst = gp + (size_t)img * hp * wp + j;
#pragma unroll
    for (int p = 0; p < kRowsPerThread; ++p) {
        const int i = i0 + ty0 + p;
        if (i < hp) dst[(size_t)i * wp] = total[p];
    }
}

// Sum of src[(y + r) * wp + col] over y in [-r, h + r) with reflect(y) == a,
// y ascending.
__device__ __forceinline__ float fold_rows(const float* src, int col, int a, int h, int r,
                                           int wp) {
    float s = 0.0f;
    for (int y = -r; y < 0; ++y) {
        if (reflect101(y, h) == a) s = s + src[(size_t)(y + r) * wp + col];
    }
    s = s + src[(size_t)(a + r) * wp + col];
    for (int y = h; y < h + r; ++y) {
        if (reflect101(y, h) == a) s = s + src[(size_t)(y + r) * wp + col];
    }
    return s;
}

__global__ void __launch_bounds__(kThreads)
adj_fold_kernel(const float* __restrict__ gp, float* __restrict__ out, int n, int h, int w,
                int r) {
    const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (idx >= (long long)n * h * w) return;
    const int img = (int)(idx / ((long long)h * w));
    const int rem = (int)(idx - (long long)img * h * w);
    const int a = rem / w, b = rem - (rem / w) * w;
    const int wp = w + 2 * r;
    const float* src = gp + (size_t)img * (h + 2 * r) * wp;
    float s = 0.0f;
    for (int x = -r; x < 0; ++x) {
        if (reflect101(x, w) == b) s = s + fold_rows(src, x + r, a, h, r, wp);
    }
    s = s + fold_rows(src, b + r, a, h, r, wp);
    for (int x = w; x < w + r; ++x) {
        if (reflect101(x, w) == b) s = s + fold_rows(src, x + r, a, h, r, wp);
    }
    out[idx] = s;
}

}  // namespace

CVS_EXPORT int cvs_filter_bank_adj(const float* grad, float* scratch, float* out, int n,
                                   int h, int w, int k, int t, const float* xtaps,
                                   const float* ytaps, void* stream) {
    if (k < 1 || k > kBankMaxK || t < 1 || t > kMaxT || (t % 2) == 0 || n < 1 || h < 1 ||
        w < 1) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = (cudaStream_t)stream;
    const int R = t - 1;
    dim3 grid(ceil_div(w + R, kTileW), ceil_div(h + R, kTileH), n);
    adj_corr_kernel<<<grid, kThreads, 0, s>>>(grad, scratch, h, w, k, t,
                                               pack_taps(xtaps, ytaps, k, t));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long total = (long long)n * h * w;
    adj_fold_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        scratch, out, n, h, w, R / 2);
    return (int)cudaGetLastError();
}
