// Kernel D: bilinear descriptor sampling, basis [B, C, H, W] at
// coordinates ys/xs [B, K, S] -> samples [B, K, S, C].
//
// Replaces: cvsteer_tpu/ops/pallas_desc.py::bilinear_sample_patch_dma
// (sample_patches_pallas, _desc_patch_kernel). The TPU kernel copied a
// 32x384-lane bf16 window per keypoint into VMEM and interpolated with an
// MXU matmul against hat-weight masks; that window exists only because of
// the TPU's DMA tiling. Here every sample reads its four corners straight
// from the fp32 basis, clipping coordinates to the image as the TPU
// wrapper does — at least as accurate as the TPU's bf16 class.
//
// What bounds it on the card: memory latency of scattered reads. At the
// main path's 5 levels x 256 keypoints x 16 samples x 7 channels the
// kernel gathers 4 x 143k floats (2.3 MB) and writes 573 KB, touching only
// a few percent of the 10 MB basis; the cost is the number of dependent
// cache-line fetches, not bandwidth.
//
// What the design does about it: one block per group of keypoints and one
// thread per (keypoint, sample, channel), so the 16 samples of a keypoint
// lie within a ~15 px neighbourhood and the 4 corners of neighbouring
// threads share L1/L2 lines; output writes are contiguous per block.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;

__global__ void desc_sample_kernel(const float* __restrict__ basis,
                                   const float* __restrict__ ys,
                                   const float* __restrict__ xs,
                                   float* __restrict__ out, int B, int C, int H, int W,
                                   int K, int S, int kpb) {
    const int per = S * C;
    const int kp_local = threadIdx.x / per;
    const int rem = threadIdx.x - kp_local * per;
    const int s = rem / C;
    const int c = rem - s * C;
    const long long kp = (long long)blockIdx.x * kpb + kp_local;  // over B*K
    if (kp_local >= kpb || kp >= (long long)B * K) return;
    const long long b = kp / K;

    float y = ys[kp * S + s];
    float x = xs[kp * S + s];
    y = fminf(fmaxf(y, 0.0f), (float)(H - 1));
    x = fminf(fmaxf(x, 0.0f), (float)(W - 1));
    const float fy = floorf(y), fx = floorf(x);
    const int y0 = (int)fy, x0 = (int)fx;
    const int y1 = min(y0 + 1, H - 1), x1 = min(x0 + 1, W - 1);
    const float wy = y - fy, wx = x - fx;

    const float* plane = basis + (b * C + c) * (long long)H * W;
    const float v00 = plane[(long long)y0 * W + x0];
    const float v01 = plane[(long long)y0 * W + x1];
    const float v10 = plane[(long long)y1 * W + x0];
    const float v11 = plane[(long long)y1 * W + x1];
    const float top = v00 * (1.0f - wx) + v01 * wx;
    const float bot = v10 * (1.0f - wx) + v11 * wx;
    out[(kp * S + s) * C + c] = top * (1.0f - wy) + bot * wy;
}

}  // namespace

CVS_EXPORT int cvs_desc_sample(const float* basis, const float* ys, const float* xs,
                               float* out, int b, int c, int h, int w, int k, int s,
                               void* stream) {
    if (b < 1 || c < 1 || h < 1 || w < 1 || k < 1 || s < 1 || s * c > kMaxThreads)
        return (int)cudaErrorInvalidValue;
    const int kpb = kMaxThreads / (s * c);
    const long long n_kp = (long long)b * k;
    const unsigned blocks = (unsigned)((n_kp + kpb - 1) / kpb);
    desc_sample_kernel<<<blocks, kpb * s * c, 0, (cudaStream_t)stream>>>(
        basis, ys, xs, out, b, c, h, w, k, s, kpb);
    return (int)cudaGetLastError();
}
