// Kernel C: the per-level detector maps (g2_features_full).
//
// Replaces: cvsteer_tpu/ops/pallas_frontend.py::g2_features_full_pallas
// (_g2_features_full_kernel); the contract is the reference's
// _g2_features_full_reference_xla. From the 7 G2/H2 basis maps of one
// pyramid level (kernel A, filter_bank.cu) it produces:
//   pass 1 (cvs_g2_maps):   corner score c1 - |(c2, c3)|, and the
//                           half-angle orientation (ct, st) without any
//                           transcendental;
//   pass 2 (cvs_g2_select): per-pixel subpixel offsets dy/dx (1-px zero
//                           frame), NMS over a (2r+1)^2 window where
//                           outside the image counts as -inf, threshold,
//                           border >= r + 1, the (y%3)*3 + x%3 offset packed
//                           into the low 4 mantissa bits of each survivor's
//                           score (int32 view), P3_SENTINEL where masked,
//                           and the centered 3x3 max of that packed map
//                           (p3), so p3[1::3, 1::3] is the cell-max table.
//
// What bounds it on the card: memory traffic. At 480x640 pass 1 reads the
// 8.6 MB basis and writes 3.7 MB; pass 2 reads 1.2 MB and writes 3.7 MB;
// both do a few dozen flops per pixel.
//
// What the design does about it: pass 1 is one thread per pixel with all
// 7 basis reads coalesced and no intermediate map in device memory except
// the score. Pass 2 stages a 16x32 score tile with a (r+1)-pixel halo in
// shared memory once, builds the packed map for the tile plus a 1-pixel
// ring in shared memory, and pools from there — the NMS result and the
// packed map never touch device memory. The TPU kernel fused the basis
// into the same pass to save its HBM round trip; here the basis must be
// written anyway (descriptors sample it), and kernel A writes it once.
#include "common.cuh"

namespace {

constexpr float kSentinel = -0x1.fep+127f;  // -255 * 2^120 (P3_SENTINEL)
constexpr int kTileW = 32;
constexpr int kTileH = 16;
constexpr int kMaxNms = 4;
constexpr int kHalo = kMaxNms + 2;  // NMS radius + 1 pooling ring + margin
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
g2_maps_kernel(const float* __restrict__ basis, float* __restrict__ score,
               float* __restrict__ ct_out, float* __restrict__ st_out, int n, int hw) {
    const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (idx >= (long long)n * hw) return;
    const long long img = idx / hw;
    const long long p = idx - img * hw;
    const float* b = basis + img * 7 * hw + p;
    const float g2a = b[0], g2b = b[hw], g2c = b[2 * (long long)hw];
    const float h2a = b[3 * (long long)hw], h2b = b[4 * (long long)hw];
    const float h2c = b[5 * (long long)hw], h2d = b[6 * (long long)hw];
    // Same expressions, same order as the plain version (one rounding per
    // operation: built with --fmad=false).
    const float c1 = 0.5f * (g2b * g2b) + 0.25f * (g2a * g2c)
                     + 0.375f * (g2a * g2a + g2c * g2c)
                     + 0.3125f * (h2a * h2a + h2d * h2d)
                     + 0.5625f * (h2b * h2b + h2c * h2c)
                     + 0.375f * (h2a * h2c + h2b * h2d);
    const float c2 = 0.5f * (g2a * g2a - g2c * g2c)
                     + 0.46875f * (h2a * h2a - h2d * h2d)
                     + 0.28125f * (h2b * h2b - h2c * h2c)
                     + 0.1875f * (h2a * h2c - h2b * h2d);
    const float c3 = -(g2a * g2b) - g2b * g2c - 0.9375f * (h2c * h2d + h2a * h2b)
                     - 1.6875f * h2b * h2c - 0.1875f * h2a * h2d;
    const float rho = sqrtf(c2 * c2 + c3 * c3);
    const float inv_rho = rho > 0.0f ? 1.0f / rho : 0.0f;
    const float cos2t = rho > 0.0f ? c2 * inv_rho : 1.0f;
    const float ct = sqrtf(fmaxf(0.5f * (1.0f + cos2t), 0.0f));
    const float st_mag = sqrtf(fmaxf(0.5f * (1.0f - cos2t), 0.0f));
    score[idx] = c1 - rho;
    ct_out[idx] = ct;
    st_out[idx] = c3 >= 0.0f ? st_mag : -st_mag;
}

__global__ void __launch_bounds__(kThreads)
g2_select_kernel(const float* __restrict__ score, float* __restrict__ p3,
                 float* __restrict__ dy_out, float* __restrict__ dx_out,
                 int h, int w, float threshold, int nms) {
    __shared__ float s[kTileH + 2 * kHalo][kTileW + 2 * kHalo];
    __shared__ float packed[kTileH + 2][kTileW + 2];

    const int x0 = blockIdx.x * kTileW;
    const int y0 = blockIdx.y * kTileH;
    const int img = blockIdx.z;
    const int tid = threadIdx.x;
    const float* src = score + (size_t)img * h * w;
    const int halo = nms + 1;
    const int sh = kTileH + 2 * halo, sw = kTileW + 2 * halo;
    const float ninf = -INFINITY;

    for (int i = tid; i < sh * sw; i += kThreads) {
        const int ty = i / sw, tx = i % sw;
        const int gy = y0 - halo + ty, gx = x0 - halo + tx;
        s[ty][tx] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                        ? src[(size_t)gy * w + gx] : ninf;
    }
    __syncthreads();

    // packed map over the tile plus a 1-pixel ring (the pooling window)
    const int border = nms + 1;
    for (int i = tid; i < (kTileH + 2) * (kTileW + 2); i += kThreads) {
        const int py = i / (kTileW + 2), px = i % (kTileW + 2);
        const int gy = y0 - 1 + py, gx = x0 - 1 + px;
        float v = ninf;  // outside the image: the pooling pad
        if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
            const int cy = py - 1 + halo, cx = px - 1 + halo;  // in s[][]
            const float sc = s[cy][cx];
            float mx = ninf;
            for (int dy = -nms; dy <= nms; ++dy)
                for (int dx = -nms; dx <= nms; ++dx)
                    mx = fmaxf(mx, s[cy + dy][cx + dx]);
            const bool keep = (sc >= mx) && (sc > threshold) && gy >= border &&
                              gy < h - border && gx >= border && gx < w - border;
            if (keep) {
                const int obits = (gy % 3) * 3 + gx % 3;
                v = __int_as_float((__float_as_int(sc) & ~15) | obits);
            } else {
                v = kSentinel;
            }
        }
        packed[py][px] = v;
    }
    __syncthreads();

    for (int i = tid; i < kTileH * kTileW; i += kThreads) {
        const int oy = i / kTileW, ox = i % kTileW;
        const int gy = y0 + oy, gx = x0 + ox;
        if (gy >= h || gx >= w) continue;
        float m = ninf;
        for (int dy = 0; dy < 3; ++dy)
            for (int dx = 0; dx < 3; ++dx) m = fmaxf(m, packed[oy + dy][ox + dx]);
        const size_t o = (size_t)img * h * w + (size_t)gy * w + gx;
        p3[o] = m;

        float dyv = 0.0f, dxv = 0.0f;
        if (gy >= 1 && gy < h - 1 && gx >= 1 && gx < w - 1) {
            const int cy = oy + halo, cx = ox + halo;
            const float c = s[cy][cx];
            const float up = s[cy - 1][cx], down = s[cy + 1][cx];
            const float left = s[cy][cx - 1], right = s[cy][cx + 1];
            const float den_y = up - 2.0f * c + down;
            const float den_x = left - 2.0f * c + right;
            dyv = fabsf(den_y) > 1e-12f ? 0.5f * (up - down) / den_y : 0.0f;
            dxv = fabsf(den_x) > 1e-12f ? 0.5f * (left - right) / den_x : 0.0f;
            dyv = fminf(fmaxf(dyv, -0.5f), 0.5f);
            dxv = fminf(fmaxf(dxv, -0.5f), 0.5f);
        }
        dy_out[o] = dyv;
        dx_out[o] = dxv;
    }
}

}  // namespace

CVS_EXPORT int cvs_g2_maps(const float* basis, float* score, float* ct, float* st,
                           int n, int h, int w, void* stream) {
    if (n < 1 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
    const long long total = (long long)n * h * w;
    const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
    g2_maps_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(basis, score, ct, st, n, h * w);
    return (int)cudaGetLastError();
}

CVS_EXPORT int cvs_g2_select(const float* score, float* p3, float* dy, float* dx,
                             int n, int h, int w, float threshold, int nms_radius,
                             void* stream) {
    if (n < 1 || h < 1 || w < 1 || nms_radius < 1 || nms_radius > kMaxNms)
        return (int)cudaErrorInvalidValue;
    dim3 grid(ceil_div(w, kTileW), ceil_div(h, kTileH), n);
    g2_select_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(score, p3, dy, dx, h, w,
                                                                  threshold, nms_radius);
    return (int)cudaGetLastError();
}
