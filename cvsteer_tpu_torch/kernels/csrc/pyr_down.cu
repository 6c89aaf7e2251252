// Kernel B: the Gaussian pyramid of a batch of images in one launch,
// [N, H, W] -> levels 1 .. L-1, level l being [N, ceil(H / 2^l), ceil(W / 2^l)].
//
// Replaces: cvsteer_tpu/ops/pallas_frontend.py::pyr_down_pallas
// (_pyr_down_kernel), which the reference calls once per pyramid step.
// Semantics of cv2.pyrDown per step: the separable binomial blur
// [1, 4, 6, 4, 1] / 16 with BORDER_REFLECT_101, keeping even rows and
// columns. The TPU kernel only took 8-aligned heights and 128-aligned
// widths; this one takes every shape.
//
// What bounds it on the card: not its bytes (level 0 read once and levels
// 1.. written once: 1.6 MB for a 480x640 frame, 0.5 us at 3.35 TB/s) but
// latency: each step depends on the one before, and the steps below level 1
// are a few thousand outputs, too few to fill 132 SMs.
//
// The depth a block builds itself: CVS_B_LEVELS = 4 covers the 5-level
// pyramid of the VO front-end, so its launch takes no ticket. On the card
// the last block's tail cost more than recomputing a fourth level's halo in
// every block (PERF.md, kernels/tile_sweep.py --kernel b); the tail serves
// deeper pyramids.
//
// What the design does about it: one launch for all levels.
//   1. Every block owns a tile of level M = min(L - 1, CVS_B_LEVELS) and its
//      part of levels 1 .. M - 1 (its tile times 2^(M - m)). It stages the
//      level-0 patch that the tile needs, REFLECT_101 outside the image
//      (stage_reflect_batch: a warp per row, coalesced, no division per
//      element, and all of a thread's loads in flight together),
//      and computes levels 1 .. M in shared memory, each over the region the
//      next level reads: the block recomputes its neighbours' halo instead
//      of waiting for it. Where a region reaches past the level's edge, its
//      positions there take the value at their reflected position, which
//      the block computed itself. Each block stores only what it owns.
//   2. If L - 1 > M, each block then takes a ticket from a per-image counter
//      (a device-scope fence, then atomicAdd). The block that draws the last ticket
//      of its image builds levels M + 1 .. L - 1 alone, tile by tile, from
//      the levels just written, read through L2 (ld.global.cg: the
//      read-only path may hold lines stale within a launch), and sets the
//      counter back to 0. The next launch on the stream starts after this
//      one ends, so it finds the counter at 0 without a memset; the wrapper
//      keeps one counter buffer per device and stream.
// Each pass runs from register windows: a thread takes a strip of P
// decimated outputs and reads the 2P + 3 values they need once. The row pass
// blurs only the even columns and the column pass only the even rows.
//
// Bits: every output is computed by the operations of the plain version
// (ops/cuda_frontend.py::pyr_down_plain: row pass, then column pass, taps in
// order, one rounding each under --fmad=false) from the same inputs, so each
// level is the composed plain pyramid's to the bit, recomputed halo included.
#include "common.cuh"

namespace {

// The tile of a block at level CVS_B_LEVELS (kernels/tile_sweep.py builds
// other shapes with -D; PERF.md has its table). With fewer levels the tile
// doubles per level, so one pyramid step has a 16x32 tile. A 2x4 tile of
// level 4 owns 32x64 pixels of level 0 and reads a 77x109 patch of it.
#ifndef CVS_B_TILE_H
#define CVS_B_TILE_H 2
#endif
#ifndef CVS_B_TILE_W
#define CVS_B_TILE_W 4
#endif
#ifndef CVS_B_LEVELS
#define CVS_B_LEVELS 4
#endif

constexpr int kThreads = 256;
constexpr int kMaxM = CVS_B_LEVELS;  // levels a block builds from its level-0 patch
constexpr int kRowStrip = 4;         // row pass: decimated outputs per thread, along a row
constexpr int kColStrip = 2;         // column pass: outputs per thread, down a column
constexpr int kTailH = 32;            // the tail's output tile
constexpr int kTailW = 48;
static_assert(kMaxM >= 1 && kMaxM <= 4, "a block builds levels 1 .. CVS_B_LEVELS <= 4");

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }
__host__ __device__ constexpr int odd(int a) { return a | 1; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Extent of the region `down` levels below a region of n positions: each
// step reads 2 before and 2 after the even positions of the one above.
__host__ __device__ constexpr int region(int n, int down) {
    for (int i = 0; i < down; ++i) n = 2 * n + 3;
    return n;
}

// Shared memory of a block that builds levels 1 .. M, in floats: two level
// buffers (A holds levels 0, 2, ..., B levels 1, 3, ...) and the row-pass
// buffer; the tail reuses the same memory for its staged input and row pass.
template <int M>
struct PyrLayout {
    static constexpr int th = CVS_B_TILE_H << (kMaxM - M);  // level-M tile
    static constexpr int tw = CVS_B_TILE_W << (kMaxM - M);
    __host__ __device__ static constexpr int rh(int m) { return region(th, M - m); }
    __host__ __device__ static constexpr int rw(int m) { return region(tw, M - m); }
    // row stride of level m - 1 as the row pass of level m reads it: the
    // last strip reads up to 2 round_up(rw(m), P) + 2 (past the region:
    // values only outputs past the region use)
    __host__ __device__ static constexpr int src_ld(int m) {
        return odd(2 * round_up(rw(m), kRowStrip) + 3);
    }
    // the row-pass buffer of level m: its column strips read up to row
    // 2 round_up(rh(m), P) + 2
    __host__ __device__ static constexpr int rows_h(int m) { return 2 * round_up(rh(m), kColStrip) + 3; }
    __host__ __device__ static constexpr int rows_ld(int m) { return odd(round_up(rw(m), kRowStrip)); }
    __host__ __device__ static constexpr int level_size(int m) {  // level m - 1 as level m reads it
        return rh(m - 1) * src_ld(m);
    }
    __host__ __device__ static constexpr int max_a(int m) {  // levels 0, 2, ... (sources of 1, 3, ...)
        return m > M ? 0 : cmax(level_size(m), max_a(m + 2));
    }
    __host__ __device__ static constexpr int max_rows(int m) {
        return m > M ? 0 : cmax(rows_h(m) * rows_ld(m), max_rows(m + 1));
    }
    static constexpr int a_size = max_a(1);
    static constexpr int b_size = M >= 2 ? max_a(2) : 0;
    static constexpr int rows_at = a_size + b_size;
    static constexpr int main_floats = rows_at + max_rows(1);
    // the tail: (2 kTailH + 3) x (2 kTailW + 3) staged, its row pass after it
    static constexpr int tail_ld = odd(2 * round_up(kTailW, kRowStrip) + 3);
    static constexpr int tail_rows_at = (2 * round_up(kTailH, kColStrip) + 3) * tail_ld;
    static constexpr int tail_floats =
        tail_rows_at + (2 * round_up(kTailH, kColStrip) + 3) * odd(round_up(kTailW, kRowStrip));
    static constexpr size_t bytes(bool tail) {
        return sizeof(float) * (size_t)(tail ? cmax(main_floats, tail_floats) : main_floats);
    }
};

// Where a step's outputs go: the region in shared memory (when the next
// level reads it) and the part of it that this block owns in the level's
// plane in device memory.
struct LevelOut {
    float* smem;          // the region, row stride ld; null for the last level built
    int ld;
    float* plane;         // the level's plane of this image
    int w;                // its width
    int y0, x0;           // the region's origin, in the level's coordinates
    int cy0, cy1, cx0, cx1;  // the owned part, clipped to the level
};

// The row pass of a step: for each of the n_y rows of the source region
// (row stride src_ld), the blur at its even columns 0, 2, .., 2 (nw - 1)
// relative to the region's origin + 2 — the nw outputs' columns — into rows.
__device__ __forceinline__ void pyr_row_pass(const float* src, int src_ld, int n_y, int nw,
                                             float* rows, int rows_ld) {
    const float taps[5] = {0.0625f, 0.25f, 0.375f, 0.25f, 0.0625f};
    const int n_strips = ceil_div(nw, kRowStrip);
    for (int i = threadIdx.x; i < n_y * n_strips; i += kThreads) {
        const int s = i / n_y, y = i - s * n_y;  // neighbouring threads, neighbouring rows
        const int j0 = s * kRowStrip;
        const float* p = src + y * src_ld + 2 * j0;
        float win[2 * kRowStrip + 3];
#pragma unroll
        for (int t = 0; t < 2 * kRowStrip + 3; ++t) win[t] = p[t];
        float* dst = rows + y * rows_ld + j0;
#pragma unroll
        for (int q = 0; q < kRowStrip; ++q) {
            float a = win[2 * q] * taps[0];
#pragma unroll
            for (int t = 1; t < 5; ++t) a = a + win[2 * q + t] * taps[t];
            dst[q] = a;
        }
    }
}

// The column pass of a step: the nh x nw outputs from the row-pass rows
// (each output row i reads rows 2i .. 2i + 4), to `out`.
__device__ __forceinline__ void pyr_col_pass(const float* rows, int rows_ld, int nh, int nw,
                                             const LevelOut& out) {
    const float taps[5] = {0.0625f, 0.25f, 0.375f, 0.25f, 0.0625f};
    const int n_strips = ceil_div(nh, kColStrip);
    for (int i = threadIdx.x; i < n_strips * nw; i += kThreads) {
        const int s = i / nw, j = i - s * nw;  // a warp's lanes on neighbouring columns
        const int i0 = s * kColStrip;
        float win[2 * kColStrip + 3];
#pragma unroll
        for (int t = 0; t < 2 * kColStrip + 3; ++t) win[t] = rows[(2 * i0 + t) * rows_ld + j];
        const int gx = out.x0 + j;
        const bool own_x = gx >= out.cx0 && gx < out.cx1;
#pragma unroll
        for (int q = 0; q < kColStrip; ++q) {
            float a = win[2 * q] * taps[0];
#pragma unroll
            for (int t = 1; t < 5; ++t) a = a + win[2 * q + t] * taps[t];
            const int r = i0 + q;
            if (r >= nh) break;
            if (out.smem) out.smem[r * out.ld + j] = a;
            const int gy = out.y0 + r;
            if (own_x && gy >= out.cy0 && gy < out.cy1) out.plane[(size_t)gy * out.w + gx] = a;
        }
    }
}

// The positions of an rh x rw region at (y0, x0) that lie outside the h x w
// level take the value at their reflected position. Every position that an
// output of the plane reads reflects into the region, onto a position the
// block computed; the others (read only by outputs past the plane) are
// clamped into the region and their values never used.
__device__ __forceinline__ void fill_reflect(float* buf, int ld, int rh, int rw, int y0, int x0,
                                             int h, int w) {
    if (y0 >= 0 && x0 >= 0 && y0 + rh <= h && x0 + rw <= w) return;
    const int lane = threadIdx.x & 31;
    for (int ty = threadIdx.x >> 5; ty < rh; ty += kThreads / 32) {
        const int gy = y0 + ty;
        const bool out_y = (unsigned)gy >= (unsigned)h;
        const int sy = min(max(reflect101(gy, h) - y0, 0), rh - 1);
        for (int tx = lane; tx < rw; tx += 32) {
            const int gx = x0 + tx;
            if (out_y || (unsigned)gx >= (unsigned)w) {
                const int sx = min(max(reflect101(gx, w) - x0, 0), rw - 1);
                buf[ty * ld + tx] = buf[sy * ld + sx];
            }
        }
    }
}

// Height (or width) of level m of a dimension of n.
__device__ __forceinline__ int level_dim(int n, int m) { return ((n - 1) >> m) + 1; }

// Where level m's region of a block that builds levels 1 .. M starts,
// relative to its owned part: halo positions before it (2^(M - m + 1) - 2).
template <int M, int m>
struct Org {
    static constexpr int scale = 1 << (M - m);  // the level-M tile, scaled to level m
    static constexpr int halo = 2 * scale - 2;
};

// Levels m .. M of the block's pyramid from level m - 1's region in shared
// memory (buffer A for odd m, B for even m), every size known when compiled.
template <int M, int m>
__device__ __forceinline__ void build_level(float* smem, float* out, int n, int h, int w) {
    using L = PyrLayout<M>;
    constexpr int scale = Org<M, m>::scale, halo = Org<M, m>::halo;
    constexpr int src_rows = L::rh(m - 1), rh = L::rh(m), rw = L::rw(m);
    constexpr int src_ld = L::src_ld(m), rows_ld = L::rows_ld(m);
    constexpr int dst_ld = m < M ? L::src_ld(m + 1) : 0;
    float* const src = smem + ((m & 1) ? 0 : L::a_size);
    float* const dst = m < M ? smem + ((m & 1) ? L::a_size : 0) : nullptr;
    float* const rows = smem + L::rows_at;
    const int img = blockIdx.z;
    const int hl = level_dim(h, m), wl = level_dim(w, m);
    size_t off = 0;
#pragma unroll
    for (int l = 1; l < m; ++l) off += (size_t)n * level_dim(h, l) * level_dim(w, l);

    pyr_row_pass(src, src_ld, src_rows, rw, rows, rows_ld);
    __syncthreads();
    // the owned part: the level-M tile scaled to level m
    const int cy0 = (int)blockIdx.y * L::th * scale, cx0 = (int)blockIdx.x * L::tw * scale;
    const LevelOut o = {dst, dst_ld, out + off + (size_t)img * hl * wl, wl, cy0 - halo, cx0 - halo,
                        cy0, min(cy0 + L::th * scale, hl), cx0, min(cx0 + L::tw * scale, wl)};
    pyr_col_pass(rows, rows_ld, rh, rw, o);
    __syncthreads();
    if constexpr (m < M) {
        fill_reflect(dst, dst_ld, rh, rw, cy0 - halo, cx0 - halo, hl, wl);
        __syncthreads();
        build_level<M, m + 1>(smem, out, n, h, w);
    }
}

template <int M, bool kTail>
__global__ void __launch_bounds__(kThreads)
pyr_down_kernel(const float* __restrict__ in, float* out, int* tickets, int n, int h, int w,
                int levels) {
    using L = PyrLayout<M>;
    extern __shared__ __align__(16) float smem[];
    __shared__ int last_block;
    const int img = blockIdx.z;

    // level 0's region, into buffer A
    constexpr int scale0 = Org<M, 0>::scale, halo0 = Org<M, 0>::halo;
    stage_reflect_batch<L::rh(0), L::rw(0), kThreads / 32>(
        smem, L::src_ld(1), in + (size_t)img * h * w, h, w, (int)blockIdx.y * L::th * scale0 - halo0,
        (int)blockIdx.x * L::tw * scale0 - halo0, L::rh(0), L::rw(0));
    __syncthreads();
    build_level<M, 1>(smem, out, n, h, w);
    if (!kTail) return;

    // the ticket: the last block of this image to finish builds the rest.
    // The barrier orders the block's stores before thread 0's fence, which
    // is cumulative, so they are visible on the device before its ticket
    // (the pattern of a cooperative grid barrier); the last block's fence
    // orders its reads after every other block's ticket.
    __syncthreads();
    if (threadIdx.x == 0) {
        fence_acq_rel_gpu();
        const int ticket = atomicAdd(tickets + img, 1);
        last_block = ticket == (int)(gridDim.x * gridDim.y) - 1;
        if (last_block) {
            atomicExch(tickets + img, 0);
            fence_acq_rel_gpu();
        }
    }
    __syncthreads();
    if (!last_block) return;

    int hs = level_dim(h, M), ws = level_dim(w, M);
    size_t off = 0;
    for (int m = 1; m <= M; ++m) off += (size_t)n * level_dim(h, m) * level_dim(w, m);
    const float* src = out + off - (size_t)(n - img) * hs * ws;
    float* const tail_rows = smem + L::tail_rows_at;
    for (int l = M + 1; l < levels; ++l) {
        const int hd = ceil_div(hs, 2), wd = ceil_div(ws, 2);
        float* dst = out + off + (size_t)img * hd * wd;
        off += (size_t)n * hd * wd;
        for (int y0 = 0; y0 < hd; y0 += kTailH) {
            for (int x0 = 0; x0 < wd; x0 += kTailW) {
                const int nh = min(kTailH, hd - y0), nw = min(kTailW, wd - x0);
                stage_reflect_batch<2 * kTailH + 3, 2 * kTailW + 3, kThreads / 32, true>(
                    smem, L::tail_ld, src, hs, ws, 2 * y0 - 2, 2 * x0 - 2, 2 * nh + 3, 2 * nw + 3);
                __syncthreads();
                pyr_row_pass(smem, L::tail_ld, 2 * nh + 3, nw, tail_rows,
                             odd(round_up(kTailW, kRowStrip)));
                __syncthreads();
                const LevelOut o = {nullptr, 0, dst, wd, y0, x0, y0, y0 + nh, x0, x0 + nw};
                pyr_col_pass(tail_rows, odd(round_up(kTailW, kRowStrip)), nh, nw, o);
                __syncthreads();  // the staging buffer is rewritten; dst is read next level
            }
        }
        src = dst;
        hs = hd;
        ws = wd;
    }
}

template <int M, bool kTail>
int launch(const float* in, float* out, int* tickets, int n, int h, int w, int levels,
           cudaStream_t stream) {
    using L = PyrLayout<M>;
    static size_t granted = 48 * 1024;
    const size_t bytes = L::bytes(kTail);
    const cudaError_t e = allow_smem(pyr_down_kernel<M, kTail>, bytes, granted);
    if (e != cudaSuccess) return (int)e;
    int hm = h, wm = w;
    for (int m = 0; m < M; ++m) {
        hm = ceil_div(hm, 2);
        wm = ceil_div(wm, 2);
    }
    dim3 grid(ceil_div(wm, L::tw), ceil_div(hm, L::th), n);
    pyr_down_kernel<M, kTail><<<grid, kThreads, bytes, stream>>>(in, out, tickets, n, h, w,
                                                                 levels);
    return (int)cudaGetLastError();
}

}  // namespace

// Levels 1 .. levels - 1 of the pyramid of in [n, h, w], one after another in
// out (level l: [n, ceil(h / 2^l), ceil(w / 2^l)]). tickets: n zeroed ints
// that the launch leaves zeroed (read only when levels - 1 > CVS_B_LEVELS).
CVS_EXPORT int cvs_pyr_down_levels(const float* in, float* out, int* tickets, int n, int h,
                                   int w, int levels, void* stream) {
    if (n < 1 || n > 65535 || h < 1 || w < 1 || levels < 2) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int m = levels - 1 < kMaxM ? levels - 1 : kMaxM;
    if (levels - 1 > kMaxM) {
        if (tickets == nullptr) return (int)cudaErrorInvalidValue;
        return launch<kMaxM, true>(in, out, tickets, n, h, w, levels, s);
    }
    switch (m) {
#if CVS_B_LEVELS >= 4
        case 4: return launch<4, false>(in, out, tickets, n, h, w, levels, s);
#endif
#if CVS_B_LEVELS >= 3
        case 3: return launch<3, false>(in, out, tickets, n, h, w, levels, s);
#endif
#if CVS_B_LEVELS >= 2
        case 2: return launch<2, false>(in, out, tickets, n, h, w, levels, s);
#endif
        default: return launch<1, false>(in, out, tickets, n, h, w, levels, s);
    }
}
