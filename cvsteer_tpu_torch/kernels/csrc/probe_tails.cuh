// The tails of the probe kernels S, V and M (probe_maps_stages.cu,
// probe_maps_variants.cu, probe_maps_mma.cu): functions of the 7 G2/H2 basis
// responses of one pixel, b = (g2a, g2b, g2c, h2a, h2b, h2c, h2d), that
// write three fp32 outputs. Each is the expression of its plain version in
// ops/cuda_probes.py, in its order, one rounding per operation
// (--fmad=false); each bf16 operation of tail16 is an fp32 operation
// rounded to bf16, as PyTorch's bf16 arithmetic is.
//
// They are the H100 counterparts of the algebra the reference's probes in
// scripts/ timed on the TPU:
//   g2_harmonic        c2, c3 without reuse (every script's default form);
//   g2_harmonic_sd     (maps.cuh) kernel E's form, s = g2a + g2c reused;
//   g2_harmonic_factored  profile_variants.py::_kernel_factored;
//   g2_steer_maps      (maps.cuh) the sqrt-free steering of kernel E;
//   g2_sqrt_maps       profile_variants.py::_maps_from_coeffs, the sqrt /
//                      cos / sin steering (profile_frontend.py:119-134);
//   g2_tail16_maps     probe_r3_variants.py's bf16 steering chains.
#pragma once

#include <cuda_bf16.h>

#include "maps.cuh"

// Output conventions of the stage probes (profile_v2_stages.py "v2",
// profile_frontend.py "frontend").
enum ProbeOutputs { kOutV2 = 0, kOutFrontend = 1 };

__device__ __forceinline__ float bf16_round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// (hi, lo) with hi = bf16(x) and lo = bf16(x - hi): the bf16x3 split.
__device__ __forceinline__ void bf16_split(float x, float& hi, float& lo) {
    hi = bf16_round(x);
    lo = bf16_round(x - hi);
}

__device__ __forceinline__ void g2_harmonic(const float (&b)[7], float& c2, float& c3) {
    const float g2a = b[0], g2b = b[1], g2c = b[2];
    const float h2a = b[3], h2b = b[4], h2c = b[5], h2d = b[6];
    c2 = 0.5f * (g2a * g2a - g2c * g2c)
         + 0.46875f * (h2a * h2a - h2d * h2d)
         + 0.28125f * (h2b * h2b - h2c * h2c)
         + 0.1875f * (h2a * h2c - h2b * h2d);
    c3 = -(g2a * g2b) - g2b * g2c - 0.9375f * (h2c * h2d + h2a * h2b)
         - 1.6875f * h2b * h2c - 0.1875f * h2a * h2d;
}

// G2(t) = A + X cos 2t - Y sin 2t, H2(t) = P cos t + Q sin t + R cos 3t +
// S sin 3t: c2 = 2AX + (P^2 - Q^2)/2 + PR + QS, c3 = -2AY + PQ + PS - QR.
__device__ __forceinline__ void g2_harmonic_factored(const float (&b)[7], float& c2,
                                                     float& c3) {
    const float g2a = b[0], g2b = b[1], g2c = b[2];
    const float h2a = b[3], h2b = b[4], h2c = b[5], h2d = b[6];
    const float A = 0.5f * (g2a + g2c);
    const float X = 0.5f * (g2a - g2c);
    const float Y = g2b;
    const float P = 0.75f * (h2a + h2c);
    const float Q = -0.75f * (h2b + h2d);
    const float Rc = 0.25f * h2a - 0.75f * h2c;
    const float S = 0.25f * h2d - 0.75f * h2b;
    c2 = 2.0f * A * X + 0.5f * (P - Q) * (P + Q) + P * Rc + Q * S;
    c3 = -2.0f * A * Y + P * Q + P * S - Q * Rc;
}

__device__ __forceinline__ void g2_sqrt_maps(const float (&b)[7], float c2, float c3,
                                             float (&out)[3]) {
    const float g2a = b[0], g2b = b[1], g2c = b[2];
    const float h2a = b[3], h2b = b[4], h2c = b[5], h2d = b[6];
    const float rho = sqrtf(c2 * c2 + c3 * c3);
    const float inv_rho = rho > 0.0f ? 1.0f / rho : 0.0f;
    const float cos2t = rho > 0.0f ? c2 * inv_rho : 1.0f;
    const float ct = sqrtf(fmaxf(0.5f * (1.0f + cos2t), 0.0f));
    const float st_mag = sqrtf(fmaxf(0.5f * (1.0f - cos2t), 0.0f));
    const float st = c3 >= 0.0f ? st_mag : -st_mag;
    const float ct2 = ct * ct, st2 = st * st;
    const float ct3 = ct2 * ct, st3 = st2 * st;
    const float g2v = ct2 * g2a - 2.0f * ct * st * g2b + st2 * g2c;
    const float h2v = ct3 * h2a - 3.0f * ct2 * st * h2b + 3.0f * ct * st2 * h2c - st3 * h2d;
    maps_out(g2v, g2v * g2v, h2v * h2v, out);
}

// The sqrt-free steering with its multiply/add chains in bf16; (u, v) and
// everything after the chains stay fp32.
__device__ __forceinline__ void g2_tail16_maps(const float (&b)[7], float c2, float c3,
                                               float (&out)[3]) {
    const float g2a = b[0], g2b = b[1], g2c = b[2];
    float u, v;
    unit_harmonic(c2, c3, u, v);
    const float ub = bf16_round(u), vb = bf16_round(v), g2bb = bf16_round(g2b);
    const float h2ab = bf16_round(b[3]), h2bb = bf16_round(b[4]);
    const float h2cb = bf16_round(b[5]), h2db = bf16_round(b[6]);
    const float sb = bf16_round(g2a + g2c), db = bf16_round(g2a - g2c);
    const float g2v = bf16_round(bf16_round(0.5f * bf16_round(sb + bf16_round(ub * db)))
                                 - bf16_round(vb * g2bb));
    const float h3c = bf16_round(3.0f * h2cb), h3b = bf16_round(3.0f * h2bb);
    const float P = bf16_round(0.5f * bf16_round(bf16_round(h2ab + h3c)
                                                 + bf16_round(ub * bf16_round(h2ab - h3c))));
    const float Q = bf16_round(0.5f * bf16_round(bf16_round(h3b + h2db)
                                                 + bf16_round(ub * bf16_round(h3b - h2db))));
    const float PP = bf16_round(P * P), QQ = bf16_round(Q * Q);
    const float h2sq_b = bf16_round(
        bf16_round(0.5f * bf16_round(bf16_round(PP + QQ) + bf16_round(ub * bf16_round(PP - QQ))))
        - bf16_round(vb * bf16_round(P * Q)));
    const float g2sq_b = bf16_round(g2v * g2v);
    maps_out(g2v, g2sq_b, fmaxf(h2sq_b, 0.0f), out);
}

// The column stage's outputs: v2 (sum of the 7 responses, g2a - g2b,
// g2c - h2a), frontend (g2a, g2b, h2a).
template <int Out>
__device__ __forceinline__ void col_outputs(const float (&b)[7], float (&out)[3]) {
    if (Out == kOutV2) {
        float s = b[0];
#pragma unroll
        for (int k = 1; k < 7; ++k) s = s + b[k];
        out[0] = s;
        out[1] = b[0] - b[1];
        out[2] = b[2] - b[3];
    } else {
        out[0] = b[0];
        out[1] = b[1];
        out[2] = b[3];
    }
}

// The coefficient stage's outputs: v2 (c2, c3, c2 + c3), frontend (c2, c3, g2a).
template <int Out>
__device__ __forceinline__ void coeff_outputs(const float (&b)[7], float (&out)[3]) {
    float c2, c3;
    g2_harmonic(b, c2, c3);
    out[0] = c2;
    out[1] = c3;
    out[2] = Out == kOutV2 ? c2 + c3 : b[0];
}

// The row stage's v2 outputs from the 7 filters' row-pass values at a pixel:
// (sum of the bf16 hi parts, sum of the lo parts, their sum).
__device__ __forceinline__ void row_split_outputs(const float (&hi)[7], const float (&lo)[7],
                                                  float (&out)[3]) {
    float th = hi[0], tl = lo[0];
#pragma unroll
    for (int k = 1; k < 7; ++k) {
        th = th + hi[k];
        tl = tl + lo[k];
    }
    out[0] = th;
    out[1] = tl;
    out[2] = th + tl;
}
