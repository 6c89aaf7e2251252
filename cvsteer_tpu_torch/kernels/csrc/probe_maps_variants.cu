// Kernel V: CUDA-core variants of kernel E's maps, image [N, H, W] ->
// (edges, lines_dark, lines_bright) fp32 [N, H, W], on E's template
// (maps.cuh, bank_core.cuh) with the G2/H2 bank at width 4 (T = 9).
//
// Replaces: scripts/probe_r3_variants.py::make_kernel (the pallas_call at
// :188) and scripts/profile_variants.py::build's _kernel_baseline and
// _kernel_factored (:304): the TPU's design variants of its maps kernel,
// here on the CUDA cores:
//   tails   base       c2, c3 without reuse, sqrt-free steering (r3 "");
//           sd         kernel E's tail exactly (r3 "sd"; g2_maps.cu);
//           tail16     base with the steering chains in bf16 (r3 "tail16");
//           sd_tail16  sd's c2, c3 with tail16's chains (r3 "sd+tail16");
//           sqrt       the sqrt / cos / sin steering (profile_variants
//                      "baseline": _maps_from_basis);
//           factored   c2, c3 by the harmonic factorization, then sqrt's
//                      steering (profile_variants "factored");
//   carry   one block walks a column of tiles top to bottom and keeps the
//           2R overlap rows of the row passes from the tile above, staging
//           and passing only the tile's TH new rows (r3 "carry": the TPU
//           carried them across its sequential grid; here a loop inside the
//           block takes the grid's place). Tile heights 32, 64, 96 and 128
//           (the scripts'); all fit in shared memory at E's width of 32
//           (130 KB at 128 rows, one block per SM).
// Plain version: ops/cuda_probes.py::maps_variant_plain, bit for bit (the
// carried rows are the rows a fresh tile would compute, by the same sums).
//
// What bounds it on the card: arithmetic, as kernel E (maps.cuh).
//
// What the design does about it: E's design; the variants are the
// measurement.
#include "probe_tails.cuh"

namespace {

constexpr int R = 4;
constexpr int kTW = 32, kSH = 4, kSW = 8;

enum Tail { kBase = 0, kSd = 1, kTail16 = 2, kSdTail16 = 3, kSqrt = 4, kFactored = 5 };

template <int Kind, int TH_>
struct VariantTail {
    static constexpr int K = 7, TH = TH_, TW = kTW, SH = kSH, SW = kSW;
    using Params = NoParams;

    __device__ static void apply(const float (&b)[K], const Params&, float (&out)[3]) {
        float c2, c3;
        if (Kind == kSd || Kind == kSdTail16) {
            g2_harmonic_sd(b, c2, c3);
        } else if (Kind == kFactored) {
            g2_harmonic_factored(b, c2, c3);
        } else {
            g2_harmonic(b, c2, c3);
        }
        if (Kind == kTail16 || Kind == kSdTail16) {
            g2_tail16_maps(b, c2, c3, out);
        } else if (Kind == kSqrt || Kind == kFactored) {
            g2_sqrt_maps(b, c2, c3, out);
        } else {
            g2_steer_maps(b, c2, c3, out);
        }
    }
};

// carry: a block walks one column of tiles, top to bottom.
template <class Tl>
__global__ void __launch_bounds__(kBankThreads, 2)
carry_kernel(const float* __restrict__ in, float* __restrict__ m0, float* __restrict__ m1,
             float* __restrict__ m2, int h, int w, const __grid_constant__ SepBank bank) {
    constexpr int TH = Tl::TH, TW = Tl::TW, P = Tl::SH, SW = Tl::SW;
    using L = BankTile<R, TH, TW>;
    extern __shared__ __align__(16) float smem[];
    const int x0 = blockIdx.x * TW;
    const size_t plane = (size_t)h * w;
    const float* image = in + blockIdx.z * plane;
    const int n_tiles = ceil_div(h, TH);
    const int n_strips = ceil_div(min(TW, w - x0), SW);
    const int width = n_strips * SW;
    float* rows = smem + L::rows_at;

    for (int t = 0; t < n_tiles; ++t) {
        const int y0 = t * TH;
        if (t == 0) {
            bank_rows<R, TH, TW, SW>(smem, image, h, w, y0, x0, bank);
        } else {
            // the tile above passed rows [TH, TH + 2R) of its window, which
            // are rows [0, 2R) of this one
            for (int i = threadIdx.x; i < bank.n_rows * 2 * R * width; i += kBankThreads) {
                const int d = i / (2 * R * width), j = i - d * 2 * R * width;
                const int y = j / width, c = j - y * width;
                rows[(d * L::ih + y) * L::rs + c] = rows[(d * L::ih + TH + y) * L::rs + c];
            }
            const int n_y = min(L::ih, h - y0 + 2 * R);
            stage_reflect(smem + 2 * R * L::iw, L::iw, image, h, w, y0 + R, x0 - R, n_y - 2 * R,
                          width + 2 * R);
            __syncthreads();
            bank_row_pass<R, TH, TW, SW>(smem, 2 * R, n_y, n_strips, bank);
        }
        for (int i = threadIdx.x; i < (TH / P) * TW; i += kBankThreads) {
            const int r0 = (i / TW) * P, c = i % TW;
            const int gy = y0 + r0, gx = x0 + c;
            if (gy >= h || gx >= w) continue;
            float b[7][P];
#pragma unroll
            for (int k = 0; k < 7; ++k) column_strip<R, TH, TW, P>(smem, bank, k, r0, c, b[k]);
            const size_t o = blockIdx.z * plane + (size_t)gy * w + gx;
#pragma unroll
            for (int p = 0; p < P; ++p) {
                if (gy + p >= h) break;
                float px[7];
#pragma unroll
                for (int k = 0; k < 7; ++k) px[k] = b[k][p];
                float out[3];
                Tl::apply(px, NoParams{}, out);
                const size_t op = o + (size_t)p * w;
                m0[op] = out[0];
                m1[op] = out[1];
                m2[op] = out[2];
            }
        }
        __syncthreads();  // the next tile overwrites the row buffers
    }
}

template <class Tl>
int launch_carry(const float* in, void* m0, void* m1, void* m2, int n, int h, int w,
                 const SepBank& bank, cudaStream_t stream) {
    static size_t granted = 48 * 1024;
    const size_t bytes = BankTile<R, Tl::TH, Tl::TW>::bytes(bank.n_rows);
    const cudaError_t e = allow_smem(carry_kernel<Tl>, bytes, granted);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(ceil_div(w, Tl::TW), 1, n);
    carry_kernel<Tl><<<grid, kBankThreads, bytes, stream>>>(in, (float*)m0, (float*)m1,
                                                            (float*)m2, h, w, bank);
    return (int)cudaGetLastError();
}

template <int Kind, int TH>
int launch_variant(const float* in, void* m0, void* m1, void* m2, int n, int h, int w,
                   const SepBank& bank, cudaStream_t s) {
    return launch_r<R, VariantTail<Kind, TH>, float>(in, m0, m1, m2, n, h, w, bank, NoParams{},
                                                     s);
}

}  // namespace

// tail: 0 base, 1 sd, 2 tail16, 3 sd_tail16, 4 sqrt, 5 factored. Without
// carry every tail runs at tile height 64; with carry, base at 64 and
// sd_tail16 at 32, 64, 96 and 128 (the scripts' cases). Other
// combinations return cudaErrorInvalidValue.
CVS_EXPORT int cvs_probe_variants(const float* in, void* m0, void* m1, void* m2, int n, int h,
                                  int w, int t, const float* xtaps, const float* ytaps, int tail,
                                  int carry, int tile_h, void* stream) {
    if (t != 2 * R + 1 || n < 1 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
    const SepBank bank = make_bank(xtaps, ytaps, 7, t);
    cudaStream_t s = (cudaStream_t)stream;
    if (!carry && tile_h == 64) {
        switch (tail) {
            case kBase: return launch_variant<kBase, 64>(in, m0, m1, m2, n, h, w, bank, s);
            case kSd: return launch_variant<kSd, 64>(in, m0, m1, m2, n, h, w, bank, s);
            case kTail16: return launch_variant<kTail16, 64>(in, m0, m1, m2, n, h, w, bank, s);
            case kSdTail16:
                return launch_variant<kSdTail16, 64>(in, m0, m1, m2, n, h, w, bank, s);
            case kSqrt: return launch_variant<kSqrt, 64>(in, m0, m1, m2, n, h, w, bank, s);
            case kFactored:
                return launch_variant<kFactored, 64>(in, m0, m1, m2, n, h, w, bank, s);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    if (carry && tail == kBase && tile_h == 64) {
        return launch_carry<VariantTail<kBase, 64>>(in, m0, m1, m2, n, h, w, bank, s);
    }
    if (carry && tail == kSdTail16) {
        switch (tile_h) {
            case 32:
                return launch_carry<VariantTail<kSdTail16, 32>>(in, m0, m1, m2, n, h, w, bank, s);
            case 64:
                return launch_carry<VariantTail<kSdTail16, 64>>(in, m0, m1, m2, n, h, w, bank, s);
            case 96:
                return launch_carry<VariantTail<kSdTail16, 96>>(in, m0, m1, m2, n, h, w, bank, s);
            case 128:
                return launch_carry<VariantTail<kSdTail16, 128>>(in, m0, m1, m2, n, h, w, bank, s);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    return (int)cudaErrorInvalidValue;
}
