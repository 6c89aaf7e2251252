// Hopper's warpgroup matrix product (wgmma) in raw PTX, for kernel M
// (probe_maps_mma.cu): bf16 operands, fp32 sums, A in registers, B in shared
// memory behind a matrix descriptor. sm_90a only.
//
// A warpgroup is 4 consecutive warps (threads 128 g .. 128 g + 127). One
// wgmma.mma_async m64nNk16 computes D[64 x N] += A[64 x 16] B[16 x N]:
//   A  registers, four .b32 a thread: warp w of the group holds rows
//      16 w .. 16 w + 15 in mma.sync m16n8k16's A layout (lane = 4 g + q:
//      a[0] row g, columns 2q, 2q + 1; a[1] row g + 8; a[2] row g, columns
//      2q + 8, 2q + 9; a[3] row g + 8, columns 2q + 8, 2q + 9; the lower 16
//      bits hold the lower column);
//   B  shared memory, MN-major (imm-trans-b = 1: N contiguous), no swizzle:
//      8 x 8 core matrices of 128 contiguous bytes, row r of a core matrix
//      (K index 8 i + r) holding 8 consecutive N elements; the descriptor's
//      leading byte offset steps one core matrix along K, its stride byte
//      offset one along N;
//   D  N / 2 fp32 registers a thread: d[4 j + e] is row 16 w + g + 8 (e >> 1),
//      column 8 j + 2q + (e & 1).
// The product is asynchronous: wgmma_fence() before the first product that
// reads registers other instructions wrote, wgmma_commit() to close a group,
// wgmma_wait<n>() until at most n groups are in flight. Shared memory that
// threads wrote must be published to the tensor cores' (async) proxy with
// fence_proxy_async() before the barrier that precedes the products.
#pragma once

#include <stdint.h>

// A no-swizzle matrix descriptor: start address, leading byte offset (K
// direction) and stride byte offset (N direction), each in 16-byte units;
// base offset 0, layout type 0 (interleave: no swizzle).
__device__ __forceinline__ uint64_t wgmma_desc(const void* smem, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
    const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem);
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16)
           | ((uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Threads' generic-proxy writes to shared memory, made visible to the async
// proxy that wgmma reads B through.
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving register accesses across a product in
// flight (the registers are the product's until wgmma_wait returns).
template <int M>
__device__ __forceinline__ void wgmma_hold(float (&d)[M]) {
#pragma unroll
    for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += a b (scale_d 1) or d = a b (scale_d 0): m64nNk16, bf16 in, fp32 out,
// A from registers, B through desc (TransB 1: MN-major, 0: K-major).
template <int N, int TransB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
    static_assert(N == 16 || N == 24 || N == 32 || N == 40, "wgmma_bf16: N in 16, 24, 32, 40");
    if constexpr (N == 16) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
              "+f"(d[7])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(TransB));
    } else if constexpr (N == 24) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, %16, p, 1, "
            "1, %18;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
              "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(TransB));
    } else if constexpr (N == 32) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
            "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
              "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
              "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(TransB));
    } else {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
            "%18, %19}, {%20, %21, %22, %23}, %24, p, 1, 1, %26;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
              "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
              "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
              "+f"(d[19])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(TransB));
    }
}
