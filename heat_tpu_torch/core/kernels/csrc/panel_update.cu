// chol_panel_fused: the lower Cholesky factor L of a row-major (n, n)
// float32 matrix A (only its lower triangle is read), right-looking by
// panels of 32 columns: factor the diagonal block unblocked, forward-
// substitute the panel below it, subtract the panel's product with itself
// from the trailing lower triangle. The upper triangle of L is exactly
// zero. A pivot that is not positive gives NaN from its square root, and
// the NaN reaches every later column, as in the plain version.
//
// Replaces heat_tpu/core/kernels/panel_update.py::_chol_kernel with its
// _chol_unblocked and _panel_solve (the Pallas TPU kernel driven by
// _chol_call / cholesky_blocked).
//
// Bound on an H100: operations in principle (n^3 / 3 flops against 2 n^2
// 4 bytes), but at n <= 1024 the work is a chain of dependent steps, so
// latency rules. The design:
//
// * One cooperative launch per call (cudaLaunchCooperativeKernel, every
//   block co-resident): the kernel walks all panels itself, with a grid
//   barrier (cooperative_groups' grid.sync) between phases. The working
//   copy is the output L in device memory; at 4 MiB it stays in the 50 MB
//   L2. A's lower triangle is copied into L (the upper one zeroed) first.
// * Look-ahead, one grid barrier per panel: in phase p a few solver blocks
//   make panel p + 1 while all the others subtract panel p's product from
//   the trailing lower triangle past panel p + 1. In a solver block, warps
//   4-7 apply panel p to the 32 x 32 diagonal block of panel p + 1; warps
//   0-3 each hold 32 rows of the panel (a row per lane), apply panel p to
//   them, then each factors the updated block itself in registers (lane i
//   holds row i; fully unrolled, no block barrier) in lockstep with the
//   forward substitution of its rows: each finished column goes to the
//   rows at once, with no hand-off between warps. The next pivot is
//   updated and its square root taken before the rest of a column's
//   update. Block 0 writes the factored block out in the next phase, when
//   no block reads it. P + 1 grid barriers for P panels (33 at n = 1024),
//   where a barrier between factor and trailing update would need 2 P - 1.
// * Trailing update: 64 x 64 tiles, in a fixed static schedule over the
//   non-solver blocks, subtract the panel's product (4 x 4 register tiles,
//   the 32-deep panel slices staged transposed in shared memory).
// * Panel rows move between L and registers through per-warp 32 x 32
//   shared tiles (a warp reads or writes one row's 128 bytes at a time):
//   a row per thread read directly would touch 32 rows per load. Every
//   staging step issues all its loads before its first store, so the L2
//   latency is paid once per step, not once per load; the products of
//   panel p run 4 or 8 independent sums at a time.
// * L is written by one block and read by another after a barrier, so it
//   is read only through L2 (__ldcg) and written with __stcg: never through
//   the non-coherent L1 path. (cp.async's 4-byte form would go through L1,
//   and its 16-byte form cannot transpose the panel, so the staging uses
//   plain L2 loads.)
// * Unfused __fsqrt_rn / __fdiv_rn / __fsub_rn(__fmul_rn) in the diagonal
//   factor, in the order of _chol_unblocked; __fdiv_rn and right-looking fmaf updates in the
//   solve; each panel's product is summed in full before it is
//   subtracted, as in the plain version. A ragged last panel is padded
//   with an identity block in registers, which adds only exact zeros. No
//   atomics: the result is the same bits every run.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBs = 32;                 // panel width: one warp
constexpr int kThreads = 256;
constexpr int kSolveWarps = 4;          // warps that factor the block and solve panel rows, a row per lane
constexpr int kSolveRows = kSolveWarps * 32;
constexpr int kTT = 64;                 // trailing tile edge, 16 x 16 threads of 4 x 4 outputs
constexpr int kLd = kBs + 1;            // row tiles: odd stride, lane-per-row reads hit distinct banks
constexpr int kLd4 = kBs + 4;           // sD, sA: float4 rows; lane-per-row float4 reads hit distinct banks
constexpr int kTile = kBs * kLd;
// shared buffer: a solver block's sD, sA, two row tiles and a column per solving
// warp, or a trailing block's two transposed 32 x 64 panel slices
constexpr int kBufFloats = 2 * kBs * kLd4 + 2 * kSolveWarps * kTile + kSolveWarps * kBs;
static_assert(2 * kBs * (kTT + 4) <= kBufFloats, "trailing slices fit the shared buffer");

__device__ __forceinline__ void named_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
    asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__global__ void __launch_bounds__(kThreads)
chol_persistent(const float* __restrict__ a, float* L, int n) {
    cg::grid_group grid = cg::this_grid();
    __shared__ float lkk[kBs][kBs + 1];
    __shared__ __align__(16) float buf[kBufFloats];
    const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
    const int blocks = gridDim.x, b = blockIdx.x;
    const long long nn = static_cast<long long>(n) * n;
    for (long long e = static_cast<long long>(b) * kThreads + t; e < nn; e += static_cast<long long>(blocks) * kThreads) {
        const long long i = e / n, j = e - i * n;
        __stcg(L + e, j <= i ? __ldg(a + e) : 0.f);
    }
    grid.sync();
    // Phase p (from -1): the solver blocks update the diagonal block and the
    // rows of panel p + 1 by panel p, factor the block and solve the rows;
    // the other blocks subtract panel p's product from the trailing lower
    // triangle past panel p + 1 (look-ahead: one grid barrier per panel).
    for (int p = -1;; ++p) {
        const int off = p * kBs, off1 = off + kBs;  // panel p, panel p + 1
        if (p >= 0 && b == 0) {
            // the factored block of panel p, held since the last phase; no block reads it now
            const int nb = n - off < kBs ? n - off : kBs;
            for (int e = t; e < kBs * kBs; e += kThreads) {
                const int i = e >> 5, c = e & 31;
                if (i < nb && c <= i) __stcg(L + static_cast<long long>(off + i) * n + off + c, lkk[i][c]);
            }
            __syncthreads();  // lkk is refilled below
        }
        if (off1 >= n) break;
        const int nb1 = n - off1 < kBs ? n - off1 : kBs;
        const int below1 = n - off1 - nb1;
        const int solvers = below1 > 0 ? (below1 + kSolveRows - 1) / kSolveRows : 1;
        const bool pre = p >= 0;
        if (b < solvers) {
            // Warps 4-7 stage the block (sA) and panel p beside it (sD) and apply panel p
            // to the block; warps 0-3 each hold 32 panel rows, one per lane, apply panel
            // p to them, then each factors the block itself in lockstep with its rows'
            // substitution. Named barriers: 1 among warps 4-7, 2 hands the updated block
            // and 3 hands sD from warps 4-7 to warps 0-3.
            float* sD = buf;                // [32][kLd4] L[off1 + i][off + k]: panel p beside the block
            float* sA = buf + kBs * kLd4;   // [32][kLd4] the block, updated by panel p in place
            if (warp >= kSolveWarps) {
                const int u = t - kSolveRows;  // 0..127: 8 entries of each array
                float vd[8], va[8];
#pragma unroll
                for (int q = 0; q < 8; ++q) {
                    const int e = u + q * kSolveRows, i = e >> 5, c = e & 31;
                    const long long row = static_cast<long long>(off1 + i) * n;
                    vd[q] = pre && i < nb1 ? __ldcg(L + row + off + c) : 0.f;
                    va[q] = i < nb1 && c <= i ? __ldcg(L + row + off1 + c) : 0.f;
                }
#pragma unroll
                for (int q = 0; q < 8; ++q) {
                    const int e = u + q * kSolveRows, i = e >> 5, c = e & 31;
                    sD[i * kLd4 + c] = vd[q];
                    sA[i * kLd4 + c] = va[q];
                }
                named_arrive(3, kThreads);
                if (pre) {
                    named_sync(1, kSolveRows);
                    // warp w updates columns [8 (w - 4), 8 (w - 4) + 8) of every row (lane = row):
                    // panel p's product summed in full, then subtracted
                    const int c0 = (warp - kSolveWarps) * 8;
                    float acc[8];
#pragma unroll
                    for (int c = 0; c < 8; ++c) acc[c] = 0.f;
#pragma unroll
                    for (int k4 = 0; k4 < kBs / 4; ++k4) {
                        const float4 di = *reinterpret_cast<const float4*>(sD + lane * kLd4 + 4 * k4);
#pragma unroll
                        for (int c = 0; c < 8; ++c) {
                            const float4 dc = *reinterpret_cast<const float4*>(sD + (c0 + c) * kLd4 + 4 * k4);
                            acc[c] = fmaf(di.w, dc.w, fmaf(di.z, dc.z, fmaf(di.y, dc.y, fmaf(di.x, dc.x, acc[c]))));
                        }
                    }
#pragma unroll
                    for (int c = 0; c < 8; ++c) sA[lane * kLd4 + c0 + c] = __fsub_rn(sA[lane * kLd4 + c0 + c], acc[c]);
                }
                named_arrive(2, kThreads);
            } else {
                float* tile0 = buf + 2 * kBs * kLd4 + 2 * warp * kTile;
                float* tile1 = tile0 + kTile;
                float* col = buf + 2 * kBs * kLd4 + 2 * kSolveWarps * kTile + warp * kBs;
                const long long r0 = off1 + nb1 + static_cast<long long>(b) * kSolveRows + warp * 32;
                {
                    // rows past n (never stored) solve ones, not zeros: a zero numerator would
                    // take the division's slow path
                    float v0[kBs], v1[kBs];
#pragma unroll
                    for (int i = 0; i < kBs; ++i) {
                        const long long row = (r0 + i) * n;
                        v0[i] = r0 + i >= n ? 1.f : lane < nb1 ? __ldcg(L + row + off1 + lane) : 0.f;
                        v1[i] = pre && r0 + i < n ? __ldcg(L + row + off + lane) : 0.f;
                    }
#pragma unroll
                    for (int i = 0; i < kBs; ++i) {
                        tile0[i * kLd + lane] = v0[i];
                        tile1[i * kLd + lane] = v1[i];
                    }
                }
                __syncwarp();
                float x[kBs];
#pragma unroll
                for (int c = 0; c < kBs; ++c) x[c] = tile0[lane * kLd + c];
                named_sync(3, kThreads);  // sD in
                if (pre) {
                    // the row's part of panel p's product, summed in full, then subtracted;
                    // four independent sums at a time
#pragma unroll
                    for (int c0 = 0; c0 < kBs; c0 += 4) {
                        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
                        for (int k4 = 0; k4 < kBs / 4; ++k4) {
                            const float l0 = tile1[lane * kLd + 4 * k4], l1 = tile1[lane * kLd + 4 * k4 + 1];
                            const float l2 = tile1[lane * kLd + 4 * k4 + 2], l3 = tile1[lane * kLd + 4 * k4 + 3];
#pragma unroll
                            for (int c = 0; c < 4; ++c) {
                                const float4 dc = *reinterpret_cast<const float4*>(sD + (c0 + c) * kLd4 + 4 * k4);
                                acc[c] = fmaf(l3, dc.w, fmaf(l2, dc.z, fmaf(l1, dc.y, fmaf(l0, dc.x, acc[c]))));
                            }
                        }
#pragma unroll
                        for (int c = 0; c < 4; ++c) x[c0 + c] = __fsub_rn(x[c0 + c], acc[c]);
                    }
                }
                named_sync(2, kThreads);  // the updated block in
                float r[kBs];
                // rows and columns past nb1: an identity block, which adds only exact zeros
#pragma unroll
                for (int c = 0; c < kBs; ++c)
                    r[c] = lane < nb1 ? (c <= lane ? sA[lane * kLd4 + c] : 0.f) : (c == lane ? 1.f : 0.f);
                // Unblocked factor as heat_tpu's _chol_unblocked (square root of the pivot,
                // divide the column below it, rank-1 update of the rest), each column applied
                // to the panel row at once (X Lkk^T = P, right-looking). The next pivot is
                // updated and its square root taken before the rest of the column's update,
                // which reaches the lanes through `col`.
                float d = __fsqrt_rn(__shfl_sync(0xffffffffu, r[0], 0));
#pragma unroll
                for (int j = 0; j < kBs; ++j) {
                    // lanes on and above the pivot divide d by itself: a zero numerator would
                    // take the division's slow path, and their entries keep d or their value
                    const float q = __fdiv_rn(lane > j ? r[j] : d, d);
                    r[j] = lane > j ? q : (lane == j ? d : r[j]);
                    x[j] = __fdiv_rn(x[j], d);
                    if (j + 1 < kBs) {
                        const float l1 = __shfl_sync(0xffffffffu, r[j], j + 1);  // L[j + 1][j]
                        if (j + 1 <= lane) r[j + 1] = __fsub_rn(r[j + 1], __fmul_rn(r[j], l1));
                        const float dn = __fsqrt_rn(__shfl_sync(0xffffffffu, r[j + 1], j + 1));
                        x[j + 1] = fmaf(-x[j], l1, x[j + 1]);
                        if (j + 2 < kBs) {
                            col[lane] = r[j];
                            __syncwarp();
#pragma unroll
                            for (int c = j + 2; c < kBs; ++c) {
                                const float lc = col[c];  // L[c][j]
                                if (c <= lane) r[c] = __fsub_rn(r[c], __fmul_rn(r[j], lc));
                                x[c] = fmaf(-x[j], lc, x[c]);
                            }
                            __syncwarp();
                        }
                        d = dn;
                    }
                }
                if (b == 0 && warp == 0)  // block 0 writes it to L in the next phase
#pragma unroll
                    for (int c = 0; c < kBs; ++c) lkk[lane][c] = c <= lane ? r[c] : 0.f;
#pragma unroll
                for (int c = 0; c < kBs; ++c) tile0[lane * kLd + c] = x[c];
                __syncwarp();
#pragma unroll
                for (int i = 0; i < kBs; ++i)
                    if (r0 + i < n && lane < nb1) __stcg(L + (r0 + i) * n + off1 + lane, tile0[i * kLd + lane]);
            }
        }
        // trailing update by panel p: 64 x 64 tiles of the lower triangle from off + 64 on,
        // in a static schedule over the blocks that do not solve (over all of them if none is left)
        const int t0 = off + 2 * kBs;
        if (pre && t0 < n) {
            float* as = buf;                // [kBs][kTT + 4]: panel p of the tile's rows, transposed
            float* bs = buf + kBs * (kTT + 4);
            const int first = blocks > solvers ? solvers : 0;
            const int nt = (n - t0 + kTT - 1) / kTT;
            const int ntiles = nt * (nt + 1) / 2;
            const int tx = t & 15, ty = t >> 4;
            for (int tile = b - first; b >= first && tile < ntiles; tile += blocks - first) {
                int ti = static_cast<int>((sqrtf(8.f * tile + 1.f) - 1.f) * 0.5f);
                while (ti * (ti + 1) / 2 > tile) --ti;
                while ((ti + 1) * (ti + 2) / 2 <= tile) ++ti;
                const int tj = tile - ti * (ti + 1) / 2;
                const int ra = t0 + ti * kTT, rb = t0 + tj * kTT;
                float va[kTT * kBs / kThreads], vb[kTT * kBs / kThreads];
#pragma unroll
                for (int q = 0; q < kTT * kBs / kThreads; ++q) {
                    const int e = t + q * kThreads, rr = e >> 5, kk = e & 31;
                    va[q] = ra + rr < n ? __ldcg(L + static_cast<long long>(ra + rr) * n + off + kk) : 0.f;
                    vb[q] = rb + rr < n ? __ldcg(L + static_cast<long long>(rb + rr) * n + off + kk) : 0.f;
                }
                __syncthreads();  // the previous tile (or a solve) is done with buf
#pragma unroll
                for (int q = 0; q < kTT * kBs / kThreads; ++q) {
                    const int e = t + q * kThreads, rr = e >> 5, kk = e & 31;
                    as[kk * (kTT + 4) + rr] = va[q];
                    bs[kk * (kTT + 4) + rr] = vb[q];
                }
                __syncthreads();
                float old[4][4];  // the tile's entries of L, loaded while the product runs
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const int gi = ra + ty * 4 + i, gj = rb + tx * 4 + j;
                        old[i][j] = gi < n && gj <= gi ? __ldcg(L + static_cast<long long>(gi) * n + gj) : 0.f;
                    }
                float acc[4][4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll
                for (int kk = 0; kk < kBs; ++kk) {
                    const float4 av4 = *reinterpret_cast<const float4*>(as + kk * (kTT + 4) + ty * 4);
                    const float4 bv4 = *reinterpret_cast<const float4*>(bs + kk * (kTT + 4) + tx * 4);
                    const float av[4] = {av4.x, av4.y, av4.z, av4.w}, bv[4] = {bv4.x, bv4.y, bv4.z, bv4.w};
#pragma unroll
                    for (int i = 0; i < 4; ++i)
#pragma unroll
                        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
                }
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const int gi = ra + ty * 4 + i, gj = rb + tx * 4 + j;
                        if (gi < n && gj <= gi) __stcg(L + static_cast<long long>(gi) * n + gj, __fsub_rn(old[i][j], acc[i][j]));
                    }
            }
        }
        grid.sync();
    }
}

}  // namespace

// How many blocks of the kernel fit one SM at once on card `device`
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or a negative CUDA
// error code.
extern "C" int chol_blocks_per_sm(int device) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return -static_cast<int>(err);
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chol_persistent, kThreads, 0);
    return err == cudaSuccess ? per_sm : -static_cast<int>(err);
}

// a: (n, n) float32 row-major on the card (lower triangle read). L: (n, n)
// float32, the output and the working copy. blocks: the cooperative grid,
// at most chol_blocks_per_sm x the SM count. One launch on card `device`,
// on `stream`; returns its CUDA error (0 on success; a refused cooperative
// launch is an error), or cudaErrorInvalidValue for arguments outside the
// limits.
extern "C" int chol_panel_fused(const void* a, void* L, int n, int blocks, int device, void* stream) {
    if (n < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const float* ap = static_cast<const float*>(a);
    float* lp = static_cast<float*>(L);
    void* args[] = {&ap, &lp, &n};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(chol_persistent), dim3(blocks), dim3(kThreads),
                                      args, 0, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
