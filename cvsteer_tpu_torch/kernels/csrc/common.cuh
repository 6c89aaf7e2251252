// Shared helpers for the cvsteer_tpu_torch Hopper kernels.
//
// Every C entry point takes raw device pointers and the CUDA stream from
// PyTorch (ctypes passes both as void*), launches on that stream, never
// synchronises, allocates nothing, and returns cudaGetLastError() so the
// Python wrapper can raise on a launch the CUDA runtime refused.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define CVS_EXPORT extern "C" __attribute__((visibility("default")))

// BORDER_REFLECT_101 index map (gfedcb|abcdefgh|gfedcba) that keeps
// reflecting, so it is valid for any offset: numpy/jnp.pad 'reflect'
// semantics, which stay defined where the pad reaches past the whole
// dimension (tiny pyramid levels). The pattern is periodic with period
// 2(n-1); n == 1 maps everything to 0.
__device__ __forceinline__ int reflect101(int i, int n) {
    if (n == 1) return 0;
    const int period = 2 * (n - 1);
    i %= period;
    if (i < 0) i += period;
    return i < n ? i : period - i;
}

__host__ __device__ __forceinline__ int ceil_div(int a, int b) {
    return (a + b - 1) / b;
}
