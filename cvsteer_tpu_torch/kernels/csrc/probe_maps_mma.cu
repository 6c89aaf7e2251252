// Kernel M: the matrix-unit variants of kernel E's maps on the tensor cores,
// image [N, H, W] -> three fp32 maps [N, H, W], the G2/H2 bank at width 4
// (T = 9), stages row / col / coeff / full with the "v2" outputs of
// kernel S (probe_maps_stages.cu); full is the sqrt / cos / sin steering.
//
// Replaces: scripts/profile_variants.py::_kernel_presplit (build, the
// pallas_call at :261) and ::_kernel_rowmxu (:304), and the bf16x1 column
// pass of scripts/profile_frontend.py (Precision.DEFAULT, :244): the TPU ran
// its column pass, and in rowmxu its row pass, on the matrix unit. Here:
//   column pass  the banded product basis_k = C_k rows_k on a 64 x TW tile,
//                C_k [64, 80] with C_k[i, i + t] = y_k[t] (zero past
//                column 71), rows_k [80, TW] the row passes of the tile's 72
//                staged rows and 8 zero rows: bf16 operands, fp32 sums, by
//                wgmma m64nNk16 (Hopper's warpgroup product), five k-steps:
//                bf16x3 (C_hi R_hi + C_hi R_lo + C_lo R_hi, the presplit /
//                Precision.HIGHEST scheme; R_hi, R_lo the bf16 split of the
//                fp32 row-pass values, made once when the row pass stores
//                them) or bf16x1 (C_hi R_hi, the DEFAULT precision);
//   row pass     fp32 on the CUDA cores in the plain order (strip_pass), or
//                "rowmxu": the taps [n_rows, T] split hi/lo against the
//                shifted image rows rounded to bf16 (exact for u8-valued
//                images), two mma.sync m16n8k16 products, fp32 sums.
// Plain version: ops/cuda_probes.py::maps_mma_plain, the same splits and
// products in fp32 through torch.matmul. The tensor cores sum in an order
// of their own, so the two agree to rounding, not to the bit; the row stage
// is bit-equal.
//
// What bounds it on the card: the bytes (three fp32 maps and the image, 16
// bytes a pixel: 0.0200 ms for 16x512x512). The banded products are far
// under the tensor cores' 989 TFLOP/s; the CUDA cores' row pass (6 distinct
// x-tap vectors, 17 operations an output, the hi/lo split) and tail are the
// work that remains.
//
// The design (wgmma.cuh for the product's layouts):
//   - persistent blocks of two warpgroups (256 threads) walk the 64 x TW
//     tiles (TW = CVS_M_TILE_W, 64 by default: the x-halo is 8 / 72 of the
//     row pass, against 8 / 40 at a width of 32);
//   - staging overlaps the math: at the top of a tile every thread issues
//     the cp.async copies of the NEXT tile's 72 x (TW + 8) window into the
//     other of two stage buffers (16-byte copies for a tile inside an
//     aligned image, 4-byte copies at stage_reflect's reflected addresses
//     elsewhere), then works on this tile while they land;
//   - the row pass writes the bf16 hi and lo values of each distinct x-tap
//     vector straight into wgmma's canonical MN-major layout (no swizzle:
//     8 x 8 core matrices of 128 contiguous bytes, K-adjacent ones TW / 8
//     core matrices apart): a thread takes 8 outputs along x at one row and
//     stores each part as one 16-byte row of a core matrix, a quarter-warp
//     on 8 consecutive rows of one core matrix, so no two stores of an
//     instruction share a bank; rows 72..79 are zeroed once per block;
//   - the column pass: warpgroup g takes columns g TW / 2 .. of the tile
//     (N = TW / 2), its 7 filters' accumulators (7 N / 2 fp32 registers a
//     thread) stay in registers through the tail. A is C_k from registers:
//     C_k is Toeplitz and banded, so warp w of a warpgroup (rows 16 w ..)
//     meets it only in k-steps w and w + 1, with the same two fragments for
//     every warp; those fragments, hi and lo, are built once per block into
//     shared memory and each filter loads its four with one 16-byte load
//     each; the other k-steps take zeros. B is rows_k through a descriptor;
//   - the tail runs on the accumulators and stores three maps.
#include <stdint.h>

#include "probe_tails.cuh"
#include "wgmma.cuh"

#ifndef CVS_M_TILE_W
#define CVS_M_TILE_W 64
#endif

namespace {

constexpr int R = 4, T = 2 * R + 1, K = 7;
constexpr int kTH = 64;                 // tile rows: wgmma's M
constexpr int kTW = CVS_M_TILE_W;       // tile columns: two warpgroups of N
constexpr int kN = kTW / 2;
constexpr int kIH = kTH + 2 * R;        // staged rows (the outputs' window)
constexpr int kKP = 80;                 // K of the column product: 5 k-steps of 16
constexpr int kIW = kTW + 2 * R;        // staged columns
constexpr int kLd = kTW + 12;           // stage row stride (floats): 16-byte rows, an odd
                                        // number of 16-byte units apart
constexpr int kSW = 8;                  // row-pass strip: 8 outputs, one core-matrix row
constexpr int kCols = kTW / 8;          // core matrices along N of a row plane
constexpr int kCore = 128;              // bytes of a core matrix
constexpr int kLBO = kCols * kCore;     // K-adjacent core matrices
constexpr int kSBO = kCore;             // N-adjacent core matrices
constexpr int kPlane = kKP / 8 * kLBO;  // bytes of one (x-tap vector, part) plane
constexpr int kThreads = 256, kWarps = kThreads / 32;
static_assert(kTW % 16 == 0 && kN >= 16 && kN <= 40, "CVS_M_TILE_W: 32, 48, 64 or 80");
static_assert(kIH <= kKP && kKP % 16 == 0, "the band needs 72 of the 80 rows");

enum Stage { kRow = 0, kCol = 1, kCoeff = 2, kFull = 3 };

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo16, __nv_bfloat16 hi16) {
    return (uint32_t)__bfloat16_as_ushort(lo16) | ((uint32_t)__bfloat16_as_ushort(hi16) << 16);
}

__device__ __forceinline__ uint32_t pack_f(float a, float b) {
    return pack(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
}

// d += a b: a 16x16 (row-major), b 16x8 (column-major), bf16; d fp32
// (mma.sync, rowmxu's row pass). Fragments (lane = 4 g + q): a[0] (row g,
// cols 2q, 2q+1), a[1] (row g+8), a[2] (row g, cols 2q+8, 2q+9), a[3] (row
// g+8, cols 2q+8, 2q+9); b0 (rows 2q, 2q+1, col g), b1 (rows 2q+8, 2q+9);
// d[0..1] (row g, cols 2q, 2q+1), d[2..3] (row g+8).
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

// Byte offset of row-pass value (y, x) in a plane: core matrix (y / 8, x / 8),
// its row y % 8, element x % 8.
__device__ __forceinline__ int row_at(int y, int x) {
    return (y >> 3) * kLBO + (x >> 3) * kSBO + (y & 7) * 16 + (x & 7) * 2;
}

struct Smem {
    unsigned char* rows;  // [n_rows][2 parts][kPlane] row passes, bf16 hi / lo
    float* stage;         // [2][kIH][kLd] fp32 image windows
    uint4* frags;         // [K][2 parts][2 patterns][32 lanes] band fragments
    __device__ unsigned char* plane(int d, int which) const { return rows + (2 * d + which) * kPlane; }
};

__host__ __device__ constexpr size_t smem_bytes(int n_rows) {
    return (size_t)n_rows * 2 * kPlane + sizeof(float) * 2 * kIH * kLd + sizeof(uint4) * K * 2 * 2 * 32;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// The 72 x (TW + 8) window of the tile at (y0, x0), REFLECT_101 outside the
// plane, into dst, by cp.async (committed by the caller).
__device__ void stage_async(float* dst, const float* __restrict__ plane, int h, int w, int y0,
                            int x0) {
    const int ys = y0 - R, xs = x0 - R;
    const bool inside = ys >= 0 && ys + kIH <= h && xs >= 0 && xs + kIW <= w && (w & 3) == 0
                        && ((uintptr_t)plane & 15) == 0;
    if (inside) {
        constexpr int kChunks = kIW / 4;
        for (int i = threadIdx.x; i < kIH * kChunks; i += kThreads) {
            const int r = i / kChunks, c = 4 * (i - r * kChunks);
            cp_async16(dst + r * kLd + c, plane + (size_t)(ys + r) * w + xs + c);
        }
        return;
    }
    for (int i = threadIdx.x; i < kIH * kIW; i += kThreads) {
        const int r = i / kIW, c = i - r * kIW;
        const int gy = ys + r, gx = xs + c;
        const int sy = (unsigned)gy < (unsigned)h ? gy : reflect101(gy, h);
        const int sx = (unsigned)gx < (unsigned)w ? gx : reflect101(gx, w);
        cp_async_zfill4(dst + r * kLd + c, plane + (size_t)sy * w + sx, true);
    }
}

// Both parts of eight row-pass values as two 16-byte core-matrix rows.
template <bool kLo>
__device__ __forceinline__ void put_strip(const Smem& s, int d, int y, int x0, const float (&v)[kSW]) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
        float h0, l0, h1, l1;
        bf16_split(v[2 * p], h0, l0);
        bf16_split(v[2 * p + 1], h1, l1);
        hi[p] = pack_f(h0, h1);
        lo[p] = pack_f(l0, l1);
    }
    const int at = row_at(y, x0);
    *reinterpret_cast<uint4*>(s.plane(d, 0) + at) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    if (kLo) *reinterpret_cast<uint4*>(s.plane(d, 1) + at) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
}

// fp32 row pass on the CUDA cores: a thread takes a strip of kSW outputs of
// one staged row (its window of kSW + T - 1 values read once, four 16-byte
// loads) and runs every distinct x-tap vector over it in the plain order.
// Consecutive threads take consecutive rows of one strip.
template <bool kLo>
__device__ void rows_fp32(const Smem& s, const float* stage, const SepBank& bank) {
    for (int i = threadIdx.x; i < kIH * kCols; i += kThreads) {
        const int strip = i / kIH, y = i - strip * kIH;
        float win[kSW + T - 1];  // 16 staged values: four 16-byte loads
        const float4* src = reinterpret_cast<const float4*>(stage + y * kLd + strip * kSW);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float4 v = src[j];
            win[4 * j] = v.x;
            win[4 * j + 1] = v.y;
            win[4 * j + 2] = v.z;
            win[4 * j + 3] = v.w;
        }
#pragma unroll
        for (int d = 0; d < K; ++d) {  // unrolled: the taps are constant-bank operands
            if (d >= bank.n_rows) break;
            float out[kSW];
            strip_pass<T, kSW>(win, bank.x[d], out);
            put_strip<kLo>(s, d, y, strip * kSW, out);
        }
    }
}

// Both parts of the row-pass values (y, c) and (y, c + 1), c even: one
// 4-byte store a part.
__device__ __forceinline__ void put_pair(const Smem& s, int d, int y, int c, float v0, float v1) {
    float h0, l0, h1, l1;
    bf16_split(v0, h0, l0);
    bf16_split(v1, h1, l1);
    const int at = row_at(y, c);
    *reinterpret_cast<uint32_t*>(s.plane(d, 0) + at) = pack_f(h0, h1);
    *reinterpret_cast<uint32_t*>(s.plane(d, 1) + at) = pack_f(l0, l1);
}

// rowmxu: rows[d, y, c0 + n] = sum_t (x_hi[d, t] + x_lo[d, t]) bf16(img[y, c0 + n + t]),
// one mma.sync 16x8 product per (row, 8 columns): A = the taps (distinct
// x-tap vectors as rows, taps as columns, zero beyond), B = the shifted image.
__device__ void rows_mma(const Smem& s, const float* stage, const SepBank& bank) {
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
    static_assert(kIH * kCols % kWarps == 0, "rowmxu: whole rounds of tasks");
#pragma unroll 4
    for (int j = 0; j < kIH * kCols / kWarps; ++j) {  // a known trip count: products overlap
        const int task = warp + j * kWarps;
        const int y = task / kCols, c0 = (task - y * kCols) * 8;
        const float* src = stage + y * kLd + c0 + g;
        const uint32_t b0 = pack_f(src[2 * q], src[2 * q + 1]);
        const uint32_t b1 = pack_f(q == 0 ? src[8] : 0.0f, 0.0f);  // t = 8 + 2q + {0, 1} < T
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16(acc, ahi, b0, b1);
        mma_bf16(acc, alo, b0, b1);
        if (g < bank.n_rows) put_pair(s, g, y, c0 + 2 * q, acc[0], acc[1]);
        if (g + 8 < bank.n_rows) put_pair(s, g + 8, y, c0 + 2 * q, acc[2], acc[3]);
    }
}

// A fragments of the band of y taps for the k-step `step` k-steps past the
// warp's own (0 or 1): A[m][kk] = y[16 step + kk - m].
__device__ __forceinline__ void band_fragments(const float* y, int step, int which, int g, int q,
                                               uint32_t (&a)[4]) {
    const int base = 16 * step + 2 * q - g;
    a[0] = pack_f(part(tap(y, base), which), part(tap(y, base + 1), which));
    a[1] = pack_f(part(tap(y, base - 8), which), part(tap(y, base - 7), which));
    a[2] = pack_f(part(tap(y, base + 8), which), part(tap(y, base + 9), which));
    a[3] = pack_f(part(tap(y, base), which), part(tap(y, base + 1), which));
}

__device__ __forceinline__ const uint4& frag(const Smem& s, int k, int which, int step, int lane) {
    return s.frags[((k * 2 + which) * 2 + step) * 32 + lane];
}

// The A registers of k-step `ks` for warp `wl` of its warpgroup: f0 at its
// own k-step, f1 at the next, zeros elsewhere.
__device__ __forceinline__ void select_a(uint32_t (&a)[4], const uint4& f0, const uint4& f1, int ks,
                                         int wl) {
    const bool own = ks == wl, next = ks == wl + 1;
    a[0] = own ? f0.x : next ? f1.x : 0u;
    a[1] = own ? f0.y : next ? f1.y : 0u;
    a[2] = own ? f0.z : next ? f1.z : 0u;
    a[3] = own ? f0.w : next ? f1.w : 0u;
    asm volatile("" : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]));
}

// The column products of this warpgroup's 64 x N block, all 7 filters, into
// acc: one commit group a filter, each filter's A registers selected before
// its fence; the products run asynchronously until the final wait.
template <bool X3>
__device__ __forceinline__ void column_products(const Smem& s, const SepBank& bank, int wg, int wl,
                                                int lane, float (&acc)[K][kN / 2]) {
    constexpr int kSteps = kKP / 16;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const uint4 h0 = frag(s, k, 0, 0, lane), h1 = frag(s, k, 0, 1, lane);
        uint32_t ahi[kSteps][4], alo[kSteps][4];
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) select_a(ahi[ks], h0, h1, ks, wl);
        if (X3) {
            const uint4 l0 = frag(s, k, 1, 0, lane), l1 = frag(s, k, 1, 1, lane);
#pragma unroll
            for (int ks = 0; ks < kSteps; ++ks) select_a(alo[ks], l0, l1, ks, wl);
        }
        const unsigned char* bh = s.plane(bank.row_of[k], 0) + wg * (kN / 8) * kSBO;
        const unsigned char* bl = s.plane(bank.row_of[k], 1) + wg * (kN / 8) * kSBO;
        wgmma_hold(acc[k]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
            const uint64_t dh = wgmma_desc(bh + 2 * ks * kLBO, kLBO, kSBO);
            wgmma_bf16<kN, 1>(acc[k], ahi[ks], dh, ks > 0);
            if (X3) {
                wgmma_bf16<kN, 1>(acc[k], ahi[ks], wgmma_desc(bl + 2 * ks * kLBO, kLBO, kSBO), 1);
                wgmma_bf16<kN, 1>(acc[k], alo[ks], dh, 1);
            }
        }
        wgmma_commit();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int k = 0; k < K; ++k) wgmma_hold(acc[k]);
}

template <int Stage, bool RowMma, bool X3>
__global__ void __launch_bounds__(kThreads, 1)
mma_maps_kernel(const float* __restrict__ in, float* __restrict__ m0, float* __restrict__ m1,
                float* __restrict__ m2, int n, int h, int w, const __grid_constant__ SepBank bank) {
    constexpr bool kLo = X3 || Stage == kRow || RowMma;
    extern __shared__ __align__(128) unsigned char smem[];
    Smem s;
    s.rows = smem;
    s.stage = reinterpret_cast<float*>(smem + (size_t)bank.n_rows * 2 * kPlane);
    s.frags = reinterpret_cast<uint4*>(s.stage + 2 * kIH * kLd);
    const int tiles_x = ceil_div(w, kTW), tiles_y = ceil_div(h, kTH);
    const int per_plane = tiles_x * tiles_y, n_tiles = n * per_plane;
    const size_t plane = (size_t)h * w;
    auto origin = [&](int t, int& z, int& y0, int& x0) {
        z = t / per_plane;
        const int r = t - z * per_plane;
        y0 = (r / tiles_x) * kTH;
        x0 = (r - (r / tiles_x) * tiles_x) * kTW;
    };

    int tile = blockIdx.x;
    {
        int z, y0, x0;
        origin(tile, z, y0, x0);
        stage_async(s.stage, in + z * plane, h, w, y0, x0);
        cp_async_commit();
    }
    // rows 72..79 of every plane: zeros under the band's last k-step
    for (int i = threadIdx.x; i < bank.n_rows * 2 * kCols * 8; i += kThreads) {
        const int p = i / (kCols * 8), j = i - p * (kCols * 8);
        *reinterpret_cast<uint4*>(smem + p * kPlane + (kIH / 8) * kLBO + j * 16) = make_uint4(0, 0, 0, 0);
    }
    if (Stage != kRow) {
        for (int i = threadIdx.x; i < K * 2 * 2 * 32; i += kThreads) {
            const int lane = i & 31, step = (i >> 5) & 1, which = (i >> 6) & 1, k = i >> 7;
            uint32_t a[4];
            band_fragments(bank.y[k], step, which, lane >> 2, lane & 3, a);
            s.frags[i] = make_uint4(a[0], a[1], a[2], a[3]);
        }
    }

    const int lane = threadIdx.x & 31, wg = threadIdx.x >> 7, wl = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, q = lane & 3;
    for (int it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
        const float* stage = s.stage + (it & 1) * kIH * kLd;
        const int next = tile + gridDim.x;
        if (next < n_tiles) {
            int z, y0, x0;
            origin(next, z, y0, x0);
            stage_async(s.stage + ((it + 1) & 1) * kIH * kLd, in + z * plane, h, w, y0, x0);
        }
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();  // this tile's window has landed; last tile's products and stores are done
        if (RowMma) {
            rows_mma(s, stage, bank);
        } else {
            rows_fp32<kLo>(s, stage, bank);
        }
        fence_proxy_async();
        __syncthreads();  // the row planes are written and visible to the tensor cores

        int z, y0, x0;
        origin(tile, z, y0, x0);
        const size_t o = z * plane;
        if (Stage == kRow) {
            for (int i = threadIdx.x; i < kTH * kTW; i += kThreads) {
                const int r = i / kTW, c = i - r * kTW;
                const int gy = y0 + r, gx = x0 + c;
                if (gy >= h || gx >= w) continue;
                const int at = row_at(r + R, c);
                float hi[7], lo[7];
#pragma unroll
                for (int k = 0; k < 7; ++k) {
                    hi[k] = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(s.plane(bank.row_of[k], 0) + at));
                    lo[k] = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(s.plane(bank.row_of[k], 1) + at));
                }
                float out[3];
                row_split_outputs(hi, lo, out);
                const size_t op = o + (size_t)gy * w + gx;
                m0[op] = out[0];
                m1[op] = out[1];
                m2[op] = out[2];
            }
            continue;
        }

        float acc[K][kN / 2];
#pragma unroll
        for (int k = 0; k < K; ++k) {
#pragma unroll
            for (int e = 0; e < kN / 2; ++e) acc[k][e] = 0.0f;
        }
        column_products<X3>(s, bank, wg, wl, lane, acc);
#pragma unroll
        for (int e = 0; e < kN / 2; ++e) {
            const int gy = y0 + 16 * wl + g + 8 * ((e & 3) >> 1);
            const int gx = x0 + wg * kN + 8 * (e >> 2) + 2 * q + (e & 1);
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
    cp_async_wait<0>();
}

// The blocks of one launch: every tile once, at most as many blocks as the
// card holds at once.
template <int Stage, bool RowMma, bool X3>
cudaError_t launch_shape(int n_rows, size_t& bytes, int& blocks_per_sm, int& sms) {
    static size_t granted = 48 * 1024;
    bytes = smem_bytes(n_rows);
    cudaError_t e = allow_smem(mma_maps_kernel<Stage, RowMma, X3>, bytes, granted);
    int dev = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) {
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, mma_maps_kernel<Stage, RowMma, X3>,
                                                          kThreads, bytes);
    }
    return e;
}

template <int Stage, bool RowMma, bool X3>
int launch(const float* in, void* m0, void* m1, void* m2, int n, int h, int w,
           const SepBank& bank, cudaStream_t stream) {
    size_t bytes;
    int per_sm = 0, sms = 0;
    const cudaError_t e = launch_shape<Stage, RowMma, X3>(bank.n_rows, bytes, per_sm, sms);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const long long tiles = (long long)n * ceil_div(h, kTH) * ceil_div(w, kTW);
    if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
    const int grid = (int)(tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm);
    mma_maps_kernel<Stage, RowMma, X3><<<grid, kThreads, bytes, stream>>>(
        in, (float*)m0, (float*)m1, (float*)m2, n, h, w, bank);
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

// The launch shape of the full bf16x3 instantiation for a bank of n_rows
// distinct x-tap vectors: dynamic shared bytes a block, threads a block,
// blocks an SM holds (kernels/tile_sweep.py --kernel m).
CVS_EXPORT int cvs_probe_mma_config(int n_rows, int* smem_bytes_out, int* threads, int* blocks_per_sm) {
    size_t bytes;
    int sms = 0;
    const cudaError_t e = launch_shape<kFull, false, true>(n_rows, bytes, *blocks_per_sm, sms);
    *smem_bytes_out = (int)bytes;
    *threads = kThreads;
    return (int)e;
}
