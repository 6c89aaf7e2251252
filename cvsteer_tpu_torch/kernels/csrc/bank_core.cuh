// The separable-bank core of kernels A (filter_bank.cu) and E (g2_maps.cu,
// g4_maps.cu, g2_feature_maps.cu: the maps template), built from kernel
// C′'s pieces in common.cuh (stage_reflect, strip_pass).
//
// A block computes the bank's responses on one TH x TW output tile:
//   1. stage the tile plus its R-pixel REFLECT_101 halo once (stage_reflect:
//      a warp per row, coalesced, no division per element);
//   2. one row-pass stage: a thread takes a strip of SW outputs along one
//      staged row, reads its window of SW + T - 1 values into registers once
//      and runs from it the row pass of every bit-distinct x-tap vector into
//      a shared row buffer; one barrier;
//   3. column strips (column_strip): a thread takes P outputs down one column
//      of the tile, reads the window of P + T - 1 row-pass values of a filter
//      into registers, and the P responses stay in registers for the
//      kernel's tail — kernel A stores them, kernel E steers them.
// T = 2R + 1 is a template constant, so every window and strip is unrolled
// into registers. Two barriers per tile, whatever the number of filters.
//
// The distinct x-tap vectors and the map from each filter to the row pass
// its column pass reads are computed on the host (make_bank), by bits, and
// pass by value with each launch (__grid_constant__).
//
// The image and row buffers have odd row strides: in the row stage
// neighbouring threads work on neighbouring rows, so odd strides keep their
// loads and stores on distinct banks; in the column stage a warp's lanes
// read 32 neighbouring columns of one row.
//
// Sums run in common.cuh's order (taps ascending from t = 0, the first
// product not added to zero, row pass then column pass), so under
// --fmad=false the responses are bit-equal to ops/sepconv.py::
// filter_bank_plain. That order rules out folding mirrored taps.
#pragma once

#include <string.h>

#include "common.cuh"

constexpr int kBankThreads = 256;

// The bank by value: the x taps of each distinct row pass, the y taps of
// each filter, and the row pass each filter's column pass reads.
struct SepBank {
    float x[kBankMaxK][kBankMaxT];
    float y[kBankMaxK][kBankMaxT];
    int row_of[kBankMaxK];
    int n_rows;  // distinct x-tap vectors
    int k;       // filters
};

// Host side: the [k, t] row-major tap arrays into a SepBank. Two x-tap
// vectors share a row pass only when they are equal bit for bit.
inline SepBank make_bank(const float* xtaps, const float* ytaps, int k, int t) {
    SepBank bank = {};
    bank.k = k;
    const size_t row = sizeof(float) * t;
    for (int i = 0; i < k; ++i) {
        const float* xi = xtaps + i * t;
        int d = 0;
        while (d < bank.n_rows && memcmp(bank.x[d], xi, row) != 0) ++d;
        if (d == bank.n_rows) {
            memcpy(bank.x[d], xi, row);
            ++bank.n_rows;
        }
        bank.row_of[i] = d;
        memcpy(bank.y[i], ytaps + i * t, row);
    }
    return bank;
}

// Shared-memory layout of one tile: the staged image (ih x iw), then one
// row buffer (ih x rs) per distinct x-tap vector.
template <int R, int TH, int TW>
struct BankTile {
    static constexpr int T = 2 * R + 1;
    static constexpr int ih = TH + 2 * R;        // staged rows = row-pass rows
    static constexpr int iw = (TW + 2 * R) | 1;  // staged row stride
    static constexpr int rs = TW | 1;            // row-buffer stride
    static constexpr int rows_at = ih * iw;      // first row buffer, in floats

    static constexpr size_t bytes(int n_rows) {
        return sizeof(float) * (size_t)(rows_at + n_rows * ih * rs);
    }
};

// Stage 2 over the staged rows [y_lo, n_y), ending in a barrier: the row
// pass of every distinct x-tap vector, n_strips strips of SW outputs a row.
template <int R, int TH, int TW, int SW>
__device__ __forceinline__ void bank_row_pass(float* smem, int y_lo, int n_y, int n_strips,
                                              const SepBank& bank) {
    using L = BankTile<R, TH, TW>;
    constexpr int T = L::T;
    const int rows_y = n_y - y_lo;
    float* rows = smem + L::rows_at;
    for (int i = threadIdx.x; i < rows_y * n_strips; i += kBankThreads) {
        const int strip = i / rows_y, y = y_lo + i - strip * rows_y;
        const int c0 = strip * SW;
        float win[SW + T - 1];
        const float* src = smem + y * L::iw + c0;
#pragma unroll
        for (int j = 0; j < SW + T - 1; ++j) win[j] = src[j];
        for (int d = 0; d < bank.n_rows; ++d) {
            float out[SW];
            strip_pass<T, SW>(win, bank.x[d], out);
            float* dst = rows + (d * L::ih + y) * L::rs + c0;
#pragma unroll
            for (int p = 0; p < SW; ++p) dst[p] = out[p];
        }
    }
    __syncthreads();
}

// Stages 1 and 2 for the tile at (y0, x0) of one h x w plane, both ending in
// a barrier. Rows and strips that no output of the plane reads (the tile's
// part beyond the bottom and right edges) are neither staged nor passed.
template <int R, int TH, int TW, int SW>
__device__ __forceinline__ void bank_rows(float* smem, const float* __restrict__ image, int h,
                                          int w, int y0, int x0, const SepBank& bank) {
    using L = BankTile<R, TH, TW>;
    static_assert(TW % SW == 0, "row strips must tile the width");
    const int n_y = min(L::ih, h - y0 + 2 * R);
    const int n_strips = ceil_div(min(TW, w - x0), SW);
    stage_reflect(smem, L::iw, image, h, w, y0 - R, x0 - R, n_y, n_strips * SW + 2 * R);
    __syncthreads();
    bank_row_pass<R, TH, TW, SW>(smem, 0, n_y, n_strips, bank);
}

// Stage 3 for filter k: the responses at tile rows r0 .. r0 + P - 1 of tile
// column c. Rows past the plane's bottom edge read row-pass values that were
// not computed; their outputs are never stored.
template <int R, int TH, int TW, int P>
__device__ __forceinline__ void column_strip(const float* smem, const SepBank& bank, int k, int r0,
                                             int c, float (&out)[P]) {
    using L = BankTile<R, TH, TW>;
    constexpr int T = L::T;
    static_assert(TH % P == 0, "column strips must tile the height");
    float win[P + T - 1];
    const float* src = smem + L::rows_at + (bank.row_of[k] * L::ih + r0) * L::rs + c;
#pragma unroll
    for (int j = 0; j < P + T - 1; ++j) win[j] = src[j * L::rs];
    strip_pass<T, P>(win, bank.y[k], out);
}
