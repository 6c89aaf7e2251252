// Kernel G: the gathers of the descriptor stage's rate probe.
//   rows     out[i] = tbl[idx[i]], tbl [n_tbl, row_bytes], idx [m] int32
//            clamped to [0, n_tbl) (jnp's gather clamps the same way);
//   patches  out[k] = img[y_k : y_k + ph, x_k : x_k + pw], img [h, w],
//            the starts clamped so the window fits (lax.dynamic_slice's
//            rule).
// Both move bytes only, so they equal their plain versions bit for bit
// (ops/cuda_probes.py::gather_rows_plain, gather_patches_plain).
//
// Replaces: scripts/probe_dma_gather.py::dma_gather_rows (the pallas_call
// at :72) and ::dma_gather_patches (:117). The TPU kernels kept 16 one-row
// (or one-patch) DMAs in flight on a ring of semaphores. Hopper has no
// per-row DMA engine to count; what sets a gather's rate is the bytes in
// flight.
//
// What bounds it on the card: bytes. At the script's shapes: 65,536 rows
// of 32 B (a 9.8 MB table) move 4.46 MB counting the indices, 1.33 us at
// 3.35 TB/s; 8,192 rows of 512 B (19.7 MB) 8.4 MB, 2.5 us; 2,048 patches
// of 16 x 512 B from a 4.9 MB image 33.6 MB, 10.0 us. The tables fit in the
// 50 MB L2, so a repeated call reads them from there.
//
// What the design does about it: neighbouring threads copy neighbouring
// 16-byte pieces of the output (a 32 B row is two lanes), each thread
// keeping four loads in flight before its stores, so the stores are
// coalesced and 128 bytes a thread are in flight; rows whose size or
// address is not a multiple of 16 bytes move in the largest piece that
// divides them. Patches: one block per patch, 128 threads over its 16 rows
// of 512 B, 16-byte pieces where the patch's start column allows them. No
// shared-memory staging: a copy needs none.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kInFlight = 4;  // pieces per thread, loaded before they are stored
constexpr int kPatchThreads = 128;

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ tbl, const int* __restrict__ idx, V* __restrict__ out,
                   int n_tbl, long long n_pieces, int row_pieces) {
    const long long first = (long long)blockIdx.x * kThreads * kInFlight + threadIdx.x;
    V v[kInFlight];
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
        const long long p = first + (long long)j * kThreads;
        if (p < n_pieces) {
            const long long i = p / row_pieces;
            int r = idx[i];
            r = r < 0 ? 0 : (r >= n_tbl ? n_tbl - 1 : r);
            v[j] = tbl[(long long)r * row_pieces + (p - i * row_pieces)];
        }
    }
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
        const long long p = first + (long long)j * kThreads;
        if (p < n_pieces) out[p] = v[j];
    }
}

template <typename V>
int launch_rows(const void* tbl, const int* idx, void* out, int n_tbl, int m, int row_bytes,
                cudaStream_t stream) {
    const int row_pieces = row_bytes / (int)sizeof(V);
    const long long n_pieces = (long long)m * row_pieces;
    const long long per_block = (long long)kThreads * kInFlight;
    const unsigned blocks = (unsigned)((n_pieces + per_block - 1) / per_block);
    gather_rows_kernel<V><<<blocks, kThreads, 0, stream>>>((const V*)tbl, idx, (V*)out, n_tbl,
                                                           n_pieces, row_pieces);
    return (int)cudaGetLastError();
}

// One patch of elements E per block; 16-byte pieces where the patch's rows
// start on 16 bytes (vec: the image's and output's rows allow it).
template <typename E>
__global__ void __launch_bounds__(kPatchThreads)
gather_patches_kernel(const E* __restrict__ img, const int* __restrict__ ys,
                      const int* __restrict__ xs, E* __restrict__ out, int h, int w, int ph,
                      int pw, int vec) {
    const int k = blockIdx.x;
    const int y = min(max(ys[k], 0), h - ph), x = min(max(xs[k], 0), w - pw);
    const E* src = img + (size_t)y * w + x;
    E* dst = out + (size_t)k * ph * pw;
    constexpr int kPer = 16 / (int)sizeof(E);
    if (vec && (x % kPer) == 0) {
        const int row_pieces = pw / kPer;
        for (int p = threadIdx.x; p < ph * row_pieces; p += kPatchThreads) {
            const int r = p / row_pieces, c = p - r * row_pieces;
            reinterpret_cast<uint4*>(dst + (size_t)r * pw)[c] =
                reinterpret_cast<const uint4*>(src + (size_t)r * w)[c];
        }
    } else {
        for (int p = threadIdx.x; p < ph * pw; p += kPatchThreads) {
            const int r = p / pw, c = p - r * pw;
            dst[p] = src[(size_t)r * w + c];
        }
    }
}

template <typename E>
int launch_patches(const void* img, const int* ys, const int* xs, void* out, int k, int h, int w,
                   int ph, int pw, int vec, cudaStream_t stream) {
    gather_patches_kernel<E><<<k, kPatchThreads, 0, stream>>>(
        (const E*)img, ys, xs, (E*)out, h, w, ph, pw, vec);
    return (int)cudaGetLastError();
}

bool aligned(const void* p, int bytes) { return ((uintptr_t)p % bytes) == 0; }

}  // namespace

// rows of row_bytes bytes; the copy piece is the largest of 16, 8, 4, 2, 1
// bytes that divides the row and both base addresses.
CVS_EXPORT int cvs_gather_rows(const void* tbl, const int* idx, void* out, int n_tbl, int m,
                               int row_bytes, void* stream) {
    if (n_tbl < 1 || m < 1 || row_bytes < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    for (int piece = 16; piece > 1; piece /= 2) {
        if (row_bytes % piece != 0 || !aligned(tbl, piece) || !aligned(out, piece)) continue;
        switch (piece) {
            case 16: return launch_rows<uint4>(tbl, idx, out, n_tbl, m, row_bytes, s);
            case 8: return launch_rows<uint2>(tbl, idx, out, n_tbl, m, row_bytes, s);
            case 4: return launch_rows<uint32_t>(tbl, idx, out, n_tbl, m, row_bytes, s);
            default: return launch_rows<uint16_t>(tbl, idx, out, n_tbl, m, row_bytes, s);
        }
    }
    return launch_rows<uint8_t>(tbl, idx, out, n_tbl, m, row_bytes, s);
}

// img [h, w] of elem_bytes (1, 2 or 4) elements, k patches of ph x pw.
CVS_EXPORT int cvs_gather_patches(const void* img, const int* ys, const int* xs, void* out, int k,
                                  int h, int w, int ph, int pw, int elem_bytes, void* stream) {
    if (k < 1 || ph < 1 || pw < 1 || ph > h || pw > w) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int vec = (pw * elem_bytes) % 16 == 0 && (w * elem_bytes) % 16 == 0 &&
                    aligned(img, 16) && aligned(out, 16);
    switch (elem_bytes) {
        case 1: return launch_patches<uint8_t>(img, ys, xs, out, k, h, w, ph, pw, vec, s);
        case 2: return launch_patches<uint16_t>(img, ys, xs, out, k, h, w, ph, pw, vec, s);
        case 4: return launch_patches<uint32_t>(img, ys, xs, out, k, h, w, ph, pw, vec, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
