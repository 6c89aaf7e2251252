// Window bundle adjustment on the card: the two kernels of one
// Levenberg-Marquardt iteration of slam/ba.py::bundle_adjust, each launched
// once for all B problems of a batch (the fleet's streams).
//
// Replaces no TPU kernel: the reference left BA to XLA. On the card the
// plain version (slam/ba.py's einsums and matmuls, ~15 cuBLAS calls an
// iteration) ran as ~190 tiny GEMM launches a solve: 6x2 by 2x3 blocks in
// 32x32x8 tiles (0.4 % of each tile's multiplies used), and the long-K
// products (H_cc over 8,192 columns, the Schur product over 12,288) in one
// small wave of the 132 SMs. Plain version: slam/ba.py (_normal_equations,
// reduced_system, back_substitute, apply_updates, cost), which the CPU and
// float64 keep; wrapper ops/cuda_ba.py.
//
// What bounds it on the card: operations. At the fleet's shape (B 16
// problems of C 8 cameras by L 4,096 landmark columns) an iteration is
// ~0.9 GFLOP of Schur products (48x48 per column summed over the columns)
// and reads ~10 MB; in float32 outside the tensor cores that is ~14 us,
// the bytes ~3 us.
//
// Kernel 1, ba_schur_kernel (linearize and reduce). A block takes `sub`
// sub-chunks of `lb` landmark columns of one problem and one 48x48 tile
// (8 cameras by 8) of the reduced camera matrix S. A thread takes one
// observation (camera c, column l) of a sub-chunk: it projects the point,
// forms the residual, the Huber IRLS weight w and sqrt(w) J_c (2x6),
// sqrt(w) J_l (2x3) in registers, and stages its H_ll terms; a thread per
// column sums them over the cameras in camera order and inverts H_ll +
// lambda I in _inv3's closed form (determinant guard 1e-12). Each
// observation then stages W_cl = J_c^T J_l and W_cl H_ll^-1 into shared
// memory, and the block's threads add the tile's product over the
// sub-chunk's 3 lb columns into 3x3 outputs each, in registers across the
// sub-chunks. Blocks on the diagonal tiles also sum each camera's H_cc,
// -J_c^T r and W_cl H_ll^-1 b_l over the columns. Every block writes its
// partial sums to workspace and takes a ticket; the last block of a problem
// sums the partials in chunk order and writes S (negated), bs_lm, H_cc, b_c:
// what reduced_system has before the damping and the gauge. The tile (0, 0)
// blocks also write each column's H_ll^-1 and b_l for kernel 2.
//
// Kernel 2, ba_update_kernel (update and cost). From the solved camera steps
// dx [B, C, 6]: every block forms the new poses (exp_so3(dx_w free) R,
// t + dx_v free) in shared memory; per sub-chunk a thread per observation
// forms J_l^T J_c dx_c at the old state, a thread per column sums them in
// camera order and back-substitutes dX = H_ll^-1 (b_l - sum), and a thread
// per observation adds w |r|^2 of the new point in the new pose. Partial
// costs are summed per block in a fixed tree, then by the last block of the
// problem in chunk order. Without dx (a null pointer) it is the cost of the
// state as it is: bundle_adjust's initial cost.
//
// No float atomics: every sum runs in a fixed order, so a graph replay
// equals the eager run bit for bit. The workspace and the tickets (B zeroed
// ints a launch) come from the wrapper.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // one observation a thread
constexpr int kMaxLb = 32;     // landmark columns a sub-chunk
constexpr int kTileCams = 8;   // cameras on each side of an S tile
constexpr int kTileRows = 6 * kTileCams;
constexpr int kLd = kTileRows + 1;  // staged row of A and W, padded against bank conflicts
constexpr int kMt = kTileRows / 16;  // each thread's kMt x kMt outputs of the tile
constexpr int kCamSums = 33;  // a camera's H_cc upper triangle (21), -J_c^T r (6), W H^-1 b_l (6)
constexpr int kLm = 12;       // a column's H_ll^-1 (9) and b_l (3)
constexpr int kStage = kMaxLb * 3 * kLd;  // floats of one of A and W

static_assert(kTileRows % 16 == 0, "a tile side is a whole number of 16-thread rows");
static_assert(kThreads * kCamSums <= 2 * kStage, "the camera sums stage in A and W");
static_assert(kThreads * 9 <= kStage, "the H_ll terms stage in A");

// One observation's sqrt(w)-weighted Jacobians and residual.
struct Obs {
    float jc[2][6];
    float jl[2][3];
    float r[2];
};

// Projection of X by the camera (R, t): slam/ba.py::_project and _weights.
// Returns the camera-frame point q = R X, the guarded depth z, the residual
// r and the weight w (mask, positive depth, Huber).
__device__ __forceinline__ void project(const float* R, const float* t, const float* X,
                                        float uv0, float uv1, float m, float huber, float q[3],
                                        float& z, float& u0, float& u1, float& r0, float& r1,
                                        float& w) {
    for (int i = 0; i < 3; ++i) q[i] = R[3 * i] * X[0] + R[3 * i + 1] * X[1] + R[3 * i + 2] * X[2];
    const float p0 = q[0] + t[0], p1 = q[1] + t[1], p2 = q[2] + t[2];
    z = fabsf(p2) > 1e-9f ? p2 : 1e-9f;
    u0 = p0 / z;
    u1 = p1 / z;
    r0 = u0 - uv0;
    r1 = u1 - uv1;
    w = m * (z > 1e-6f ? 1.0f : 0.0f);
    if (huber > 0.0f) {
        const float rn = sqrtf(r0 * r0 + r1 * r1);
        w = w * fminf(huber / fmaxf(rn, 1e-12f), 1.0f);
    }
}

// slam/ba.py::_jacobians with sqrt(w) on both factors (_normal_equations).
__device__ __forceinline__ void linearize(const float* R, const float* t, const float* X,
                                          float uv0, float uv1, float m, float huber, Obs& o) {
    float q[3], z, u0, u1, r0, r1, w;
    project(R, t, X, uv0, uv1, m, huber, q, z, u0, u1, r0, r1, w);
    const float sw = sqrtf(w);
    const float iz = 1.0f / z;
    const float a0 = -u0 * iz, a1 = -u1 * iz;  // du/dp = [[iz, 0, a0], [0, iz, a1]]
    // du/dp @ -hat(q), then du/dp (dp/dv = I)
    const float jc[2][6] = {
        {a0 * q[1], iz * q[2] - a0 * q[0], -(iz * q[1]), iz, 0.0f, a0},
        {a1 * q[1] - iz * q[2], -(a1 * q[0]), iz * q[0], 0.0f, iz, a1},
    };
    for (int a = 0; a < 2; ++a)
        for (int i = 0; i < 6; ++i) o.jc[a][i] = jc[a][i] * sw;
    for (int j = 0; j < 3; ++j) {  // du/dp @ R
        o.jl[0][j] = (iz * R[j] + a0 * R[6 + j]) * sw;
        o.jl[1][j] = (iz * R[3 + j] + a1 * R[6 + j]) * sw;
    }
    o.r[0] = r0 * sw;
    o.r[1] = r1 * sw;
}

// slam/ba.py::_inv3 of the symmetric H (upper triangle h[0..5]: 00 01 02 11
// 12 22) damped by lam, row-major into inv[9].
__device__ __forceinline__ void inv3(const float* h, float lam, float* inv) {
    const float a = h[0] + lam, b = h[1], c = h[2];
    const float d = h[1], e = h[3] + lam, f = h[4];
    const float g = h[2], hh = h[4], i = h[5] + lam;
    const float A = e * i - f * hh, B = c * hh - b * i, Cc = b * f - c * e;
    const float D = f * g - d * i, E = a * i - c * g, F = c * d - a * f;
    const float G = d * hh - e * g, H = b * g - a * hh, I = a * e - b * d;
    const float det = a * A + b * D + c * G;
    const float s = 1.0f / (fabsf(det) > 1e-12f ? det : 1e-12f);
    const float m[9] = {A, B, Cc, D, E, F, G, H, I};
    for (int k = 0; k < 9; ++k) inv[k] = m[k] * s;
}

// The (i, j) of the v-th entry of a 6x6 upper triangle, rows in order.
__device__ __forceinline__ void upper_ij(int v, int& i, int& j) {
    i = 0;
    while (v >= 6 - i) {
        v -= 6 - i;
        ++i;
    }
    j = i + v;
}

// The last block of problem b to finish: a device-scope fence, then a
// ticket (the pattern of kernel B's, pyr_down.cu).
__device__ __forceinline__ bool last_of_problem(int* tickets, int b, int blocks, int* flag) {
    __syncthreads();
    if (threadIdx.x == 0) {
        fence_acq_rel_gpu();
        *flag = atomicAdd(tickets + b, 1) == blocks - 1;
        if (*flag) fence_acq_rel_gpu();
    }
    __syncthreads();
    return *flag;
}

__global__ void __launch_bounds__(kThreads)
ba_schur_kernel(const float* __restrict__ R, const float* __restrict__ T,
                const float* __restrict__ X, const float* __restrict__ uv,
                const float* __restrict__ mask, const float* __restrict__ lam, float huber,
                float* __restrict__ S, float* __restrict__ bs, float* __restrict__ Hcc,
                float* __restrict__ bc, float* __restrict__ lm, float* part, int* tickets, int C,
                int L, int lb, int sub) {
    // A | W; the H_ll terms and the camera sums alias it
    __shared__ __align__(16) float stage[2 * kStage];
    __shared__ float col[kMaxLb * 15];                  // per column: H_ll^-1, b_l, H_ll^-1 b_l
    __shared__ int last_block;
    float* const sA = stage;
    float* const sW = stage + kStage;

    const int b = blockIdx.z, chunk = blockIdx.x;
    const int nt = ceil_div(C, kTileCams), ti = blockIdx.y / nt, tj = blockIdx.y % nt;
    const bool diag = ti == tj;
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int c = tid / lb, ll = tid % lb;  // this thread's observation
    const bool has_obs = tid < C * lb;
    const bool in_i = has_obs && c / kTileCams == ti, in_j = has_obs && c / kTileCams == tj;
    const int slot = (c % kTileCams) * 6;
    const float lamb = lam[b];
    const float* Rc = R + ((size_t)b * C + c) * 9;
    const float* Tc = T + ((size_t)b * C + c) * 3;
    const float* Xb = X + (size_t)b * L * 3;
    const size_t obs_row = ((size_t)b * C + c) * L;

    float acc[kMt][kMt] = {};
    float cs[kCamSums] = {};
    for (int s = 0; s < sub; ++s) {
        const int l0 = (chunk * sub + s) * lb;
        if (l0 >= L) break;
        const int nl = min(lb, L - l0);
        const bool live = has_obs && ll < nl;
        const int l = l0 + ll;
        Obs o = {};
        if (live)
            linearize(Rc, Tc, Xb + (size_t)l * 3, uv[(obs_row + l) * 2],
                      uv[(obs_row + l) * 2 + 1], mask[obs_row + l], huber, o);
        if (has_obs) {  // this observation's J_l^T J_l (upper) and -J_l^T r
            float* h = stage + tid * 9;
            int v = 0;
            for (int k = 0; k < 3; ++k)
                for (int m = k; m < 3; ++m)
                    h[v++] = o.jl[0][k] * o.jl[0][m] + o.jl[1][k] * o.jl[1][m];
            for (int k = 0; k < 3; ++k) h[6 + k] = -(o.jl[0][k] * o.r[0] + o.jl[1][k] * o.r[1]);
        }
        __syncthreads();
        if (tid < nl) {  // the column: H_ll and b_l summed over the cameras in order
            float h[9];
            for (int v = 0; v < 9; ++v) h[v] = stage[tid * 9 + v];
            for (int cc = 1; cc < C; ++cc)
                for (int v = 0; v < 9; ++v) h[v] += stage[(cc * lb + tid) * 9 + v];
            float* m = col + tid * 15;
            inv3(h, lamb, m);
            for (int k = 0; k < 3; ++k) m[9 + k] = h[6 + k];
            for (int k = 0; k < 3; ++k)
                m[12 + k] = m[3 * k] * h[6] + m[3 * k + 1] * h[7] + m[3 * k + 2] * h[8];
            if (blockIdx.y == 0) {
                float* out = lm + ((size_t)b * L + l0 + tid) * kLm;
                for (int v = 0; v < kLm; ++v) out[v] = m[v];
            }
        }
        __syncthreads();
        if (live && (in_i || in_j)) {
            float W[6][3];
            for (int i = 0; i < 6; ++i)
                for (int k = 0; k < 3; ++k)
                    W[i][k] = o.jc[0][i] * o.jl[0][k] + o.jc[1][i] * o.jl[1][k];
            if (in_j)
                for (int k = 0; k < 3; ++k)
                    for (int i = 0; i < 6; ++i) sW[(ll * 3 + k) * kLd + slot + i] = W[i][k];
            if (in_i) {
                const float* m = col + ll * 15;
                for (int k = 0; k < 3; ++k)
                    for (int i = 0; i < 6; ++i)
                        sA[(ll * 3 + k) * kLd + slot + i] =
                            W[i][0] * m[k] + W[i][1] * m[3 + k] + W[i][2] * m[6 + k];
                if (diag) {
                    int v = 0;
                    for (int i = 0; i < 6; ++i)
                        for (int j = i; j < 6; ++j, ++v)
                            cs[v] = fmaf(o.jc[1][i], o.jc[1][j],
                                         fmaf(o.jc[0][i], o.jc[0][j], cs[v]));
                    for (int i = 0; i < 6; ++i) {
                        cs[21 + i] -= o.jc[0][i] * o.r[0] + o.jc[1][i] * o.r[1];
                        cs[27 + i] += W[i][0] * m[12] + W[i][1] * m[13] + W[i][2] * m[14];
                    }
                }
            }
        }
        __syncthreads();
        for (int k = 0; k < 3 * nl; ++k) {  // the tile's product over the sub-chunk's columns
            float a[kMt], w[kMt];
            for (int i = 0; i < kMt; ++i) a[i] = sA[k * kLd + ty + 16 * i];
            for (int j = 0; j < kMt; ++j) w[j] = sW[k * kLd + tx + 16 * j];
            for (int i = 0; i < kMt; ++i)
                for (int j = 0; j < kMt; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
        }
        __syncthreads();
    }

    // this block's partial sums: the tile of S, then (diagonal tiles) the
    // camera sums of the tile's cameras, each summed over their columns in order
    const int n6 = 6 * C, P = n6 * n6 + kCamSums * C;
    float* pb = part + ((size_t)b * gridDim.x + chunk) * P;
    for (int i = 0; i < kMt; ++i)
        for (int j = 0; j < kMt; ++j) {
            const int row = ti * kTileRows + ty + 16 * i, cl = tj * kTileRows + tx + 16 * j;
            if (row < n6 && cl < n6) pb[row * n6 + cl] = acc[i][j];
        }
    if (diag) {
        if (has_obs)
            for (int v = 0; v < kCamSums; ++v) stage[tid * kCamSums + v] = cs[v];
        __syncthreads();
        const int c0 = ti * kTileCams, nc = min(kTileCams, C - c0);
        for (int e = tid; e < nc * kCamSums; e += kThreads) {
            const int cc = c0 + e / kCamSums, v = e % kCamSums;
            float sum = stage[cc * lb * kCamSums + v];
            for (int q = 1; q < lb; ++q) sum += stage[(cc * lb + q) * kCamSums + v];
            pb[n6 * n6 + cc * kCamSums + v] = sum;
        }
    }
    if (!last_of_problem(tickets, b, gridDim.x * gridDim.y, &last_block)) return;

    // the last block: every partial of problem b summed in chunk order
    const float* pr = part + (size_t)b * gridDim.x * P;
    const int nch = gridDim.x;
    for (int e = tid; e < P; e += kThreads) {
        float sum = __ldcg(pr + e);
#pragma unroll 8
        for (int ch = 1; ch < nch; ++ch) sum += __ldcg(pr + (size_t)ch * P + e);
        if (e < n6 * n6) {
            S[(size_t)b * n6 * n6 + e] = -sum;
            continue;
        }
        const int cc = (e - n6 * n6) / kCamSums, v = (e - n6 * n6) % kCamSums;
        if (v < 21) {
            int i, j;
            upper_ij(v, i, j);
            float* H = Hcc + ((size_t)b * C + cc) * 36;
            H[i * 6 + j] = sum;
            H[j * 6 + i] = sum;
        } else if (v < 27) {
            bc[((size_t)b * C + cc) * 6 + v - 21] = sum;
        } else {
            bs[((size_t)b * C + cc) * 6 + v - 27] = sum;
        }
    }
}

// slam/se3.py::exp_so3 (Rodrigues with its Taylor branch) of w, times R0.
__device__ __forceinline__ void exp_so3_times(const float w[3], const float* R0, float* out) {
    const float th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
    const bool small = th2 < 1e-8f;
    const float th2s = small ? 1.0f : th2;
    const float th = sqrtf(th2s);
    const float a = small ? 1.0f - th2 / 6.0f : sinf(th) / th;
    const float bb = small ? 0.5f - th2 / 24.0f : (1.0f - cosf(th)) / th2s;
    const float Wm[9] = {0.0f, -w[2], w[1], w[2], 0.0f, -w[0], -w[1], w[0], 0.0f};
    float E[9];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            const float ww =
                Wm[3 * i] * Wm[j] + Wm[3 * i + 1] * Wm[3 + j] + Wm[3 * i + 2] * Wm[6 + j];
            E[3 * i + j] = ((i == j ? 1.0f : 0.0f) + a * Wm[3 * i + j]) + bb * ww;
        }
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            out[3 * i + j] = E[3 * i] * R0[j] + E[3 * i + 1] * R0[3 + j] + E[3 * i + 2] * R0[6 + j];
}

__global__ void __launch_bounds__(kThreads)
ba_update_kernel(const float* __restrict__ R, const float* __restrict__ T,
                 const float* __restrict__ X, const float* __restrict__ uv,
                 const float* __restrict__ mask, float huber, const float* __restrict__ dx,
                 const uint8_t* __restrict__ fixed, const float* __restrict__ lm,
                 float* __restrict__ Rn, float* __restrict__ Tn, float* __restrict__ Xn,
                 float* __restrict__ cost, float* part, int* tickets, int C, int L, int lb,
                 int sub) {
    extern __shared__ float pose[];  // [C][12]: the new R (9) and t (3) of each camera
    __shared__ float sg[kThreads * 3];
    __shared__ float sx[kMaxLb * 3];
    __shared__ float warp_sum[kThreads / 32];
    __shared__ int last_block;

    const int b = blockIdx.y, chunk = blockIdx.x, tid = threadIdx.x;
    for (int cc = tid; cc < C; cc += kThreads) {
        const float* R0 = R + ((size_t)b * C + cc) * 9;
        const float* t0 = T + ((size_t)b * C + cc) * 3;
        float* p = pose + cc * 12;
        if (dx == nullptr) {
            for (int k = 0; k < 9; ++k) p[k] = R0[k];
            for (int k = 0; k < 3; ++k) p[9 + k] = t0[k];
            continue;
        }
        const float* d = dx + ((size_t)b * C + cc) * 6;
        const float f = fixed[(size_t)b * C + cc] ? 0.0f : 1.0f;
        const float w[3] = {d[0] * f, d[1] * f, d[2] * f};
        exp_so3_times(w, R0, p);
        for (int k = 0; k < 3; ++k) p[9 + k] = t0[k] + d[3 + k] * f;
        if (chunk == 0) {
            for (int k = 0; k < 9; ++k) Rn[((size_t)b * C + cc) * 9 + k] = p[k];
            for (int k = 0; k < 3; ++k) Tn[((size_t)b * C + cc) * 3 + k] = p[9 + k];
        }
    }
    __syncthreads();

    const int c = tid / lb, ll = tid % lb;
    const bool has_obs = tid < C * lb;
    const float* Xb = X + (size_t)b * L * 3;
    const size_t obs_row = ((size_t)b * C + c) * L;
    float acc = 0.0f;
    for (int s = 0; s < sub; ++s) {
        const int l0 = (chunk * sub + s) * lb;
        if (l0 >= L) break;
        const int nl = min(lb, L - l0);
        const bool live = has_obs && ll < nl;
        const int l = l0 + ll;
        if (dx != nullptr) {
            if (has_obs) {  // J_l^T J_c dx_c of this observation, at the old state
                float g[3] = {0.0f, 0.0f, 0.0f};
                if (live) {
                    Obs o;
                    linearize(R + ((size_t)b * C + c) * 9, T + ((size_t)b * C + c) * 3,
                              Xb + (size_t)l * 3, uv[(obs_row + l) * 2], uv[(obs_row + l) * 2 + 1],
                              mask[obs_row + l], huber, o);
                    const float* d = dx + ((size_t)b * C + c) * 6;
                    float v0 = 0.0f, v1 = 0.0f;
                    for (int i = 0; i < 6; ++i) {
                        v0 = fmaf(o.jc[0][i], d[i], v0);
                        v1 = fmaf(o.jc[1][i], d[i], v1);
                    }
                    for (int k = 0; k < 3; ++k) g[k] = o.jl[0][k] * v0 + o.jl[1][k] * v1;
                }
                for (int k = 0; k < 3; ++k) sg[tid * 3 + k] = g[k];
            }
            __syncthreads();
            if (tid < nl) {  // the column's back-substitution
                float gs[3] = {sg[tid * 3], sg[tid * 3 + 1], sg[tid * 3 + 2]};
                for (int cc = 1; cc < C; ++cc)
                    for (int k = 0; k < 3; ++k) gs[k] += sg[(cc * lb + tid) * 3 + k];
                const float* m = lm + ((size_t)b * L + l0 + tid) * kLm;
                const float rhs[3] = {m[9] - gs[0], m[10] - gs[1], m[11] - gs[2]};
                float* xo = Xn + ((size_t)b * L + l0 + tid) * 3;
                for (int k = 0; k < 3; ++k) {
                    const float dX =
                        m[3 * k] * rhs[0] + m[3 * k + 1] * rhs[1] + m[3 * k + 2] * rhs[2];
                    sx[tid * 3 + k] = xo[k] = Xb[(size_t)(l0 + tid) * 3 + k] + dX;
                }
            }
        } else if (tid < nl) {
            for (int k = 0; k < 3; ++k) sx[tid * 3 + k] = Xb[(size_t)(l0 + tid) * 3 + k];
        }
        __syncthreads();
        if (live) {  // this observation's robust cost at the new state
            const float* p = pose + c * 12;
            float q[3], z, u0, u1, r0, r1, w;
            project(p, p + 9, sx + ll * 3, uv[(obs_row + l) * 2], uv[(obs_row + l) * 2 + 1],
                    mask[obs_row + l], huber, q, z, u0, u1, r0, r1, w);
            acc += w * (r0 * r0 + r1 * r1);
        }
        __syncthreads();
    }

    // the block's sum in a fixed tree, then the problem's in chunk order
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (tid % 32 == 0) warp_sum[tid / 32] = acc;
    __syncthreads();
    if (tid == 0) {
        float s = warp_sum[0];
        for (int k = 1; k < kThreads / 32; ++k) s += warp_sum[k];
        part[(size_t)b * gridDim.x + chunk] = s;
    }
    if (!last_of_problem(tickets, b, gridDim.x, &last_block)) return;
    if (tid == 0) {
        const float* pr = part + (size_t)b * gridDim.x;
        float s = __ldcg(pr);
        for (int ch = 1; ch < (int)gridDim.x; ++ch) s += __ldcg(pr + ch);
        cost[b] = 0.5f * s;
    }
}

}  // namespace

// Kernel 1 over B problems. R [B, C, 3, 3], t [B, C, 3], X [B, L, 3], uv
// [B, C, L, 2], mask [B, C, L] float32, lam [B]; out: S [B, 6C, 6C] (the
// Schur term -W H^-1 W^T), bs [B, C, 6], Hcc [B, C, 6, 6], bc [B, C, 6], lm
// [B, L, 12]; part: B * nchunk * (36 C^2 + 33 C) floats; tickets: B zeroed
// ints. The launch: nchunk blocks of `sub` sub-chunks of `lb` <= 32 columns,
// lb * C <= 256 (ops/cuda_ba.py::launch_shape).
CVS_EXPORT int cvs_ba_schur(const float* R, const float* t, const float* X, const float* uv,
                            const float* mask, const float* lam, float huber, float* S,
                            float* bs, float* Hcc, float* bc, float* lm, float* part,
                            int* tickets, int B, int C, int L, int lb, int sub, int nchunk,
                            void* stream) {
    if (lb < 1 || lb > kMaxLb || lb * C > kThreads) return (int)cudaErrorInvalidValue;
    const int nt = ceil_div(C, kTileCams);
    const dim3 grid(nchunk, nt * nt, B);
    ba_schur_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        R, t, X, uv, mask, lam, huber, S, bs, Hcc, bc, lm, part, tickets, C, L, lb, sub);
    return (int)cudaGetLastError();
}

// Kernel 2 over B problems: the inputs of kernel 1 (without lam), then dx
// [B, C, 6], fixed [B, C] bool, lm [B, L, 12] (kernel 1's); out: Rn, Tn, Xn
// shaped as R, t, X, and cost [B]; part: B * nchunk floats; tickets: B
// zeroed ints. dx == nullptr: the cost of (R, t, X) alone (fixed, lm, Rn,
// Tn, Xn unused).
CVS_EXPORT int cvs_ba_update(const float* R, const float* t, const float* X, const float* uv,
                             const float* mask, float huber, const float* dx,
                             const uint8_t* fixed, const float* lm, float* Rn, float* Tn,
                             float* Xn, float* cost, float* part, int* tickets, int B, int C,
                             int L, int lb, int sub, int nchunk, void* stream) {
    if (lb < 1 || lb > kMaxLb || lb * C > kThreads) return (int)cudaErrorInvalidValue;
    static size_t granted = 48 * 1024;
    const size_t bytes = sizeof(float) * 12 * (size_t)C;
    const cudaError_t e = allow_smem(ba_update_kernel, bytes, granted);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(nchunk, B);
    ba_update_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
        R, t, X, uv, mask, huber, dx, fixed, lm, Rn, Tn, Xn, cost, part, tickets, C, L, lb, sub);
    return (int)cudaGetLastError();
}
