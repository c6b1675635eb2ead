// chol_panel_fused: the lower Cholesky factor L of a row-major (n, n)
// float32 matrix A (only its lower triangle is read), right-looking by
// panels of bs columns: factor the bs x bs diagonal block unblocked,
// forward-substitute the panel below it, subtract the panel's product
// with itself from the trailing lower triangle. The upper triangle of L is
// exactly zero. A pivot that is not positive gives NaN from its square
// root, and the NaN reaches every later column, as in the plain version.
//
// Replaces heat_tpu/core/kernels/panel_update.py::_chol_kernel with its
// _chol_unblocked and _panel_solve (the Pallas TPU kernel driven by
// _chol_call / cholesky_blocked).
//
// Bound on an H100: operations in principle (n^3 / 3 flops against 2 n^2
// 4 bytes), but at n <= 1024 the work is a chain of dependent steps, so
// latency rules. The design:
//
// * The TPU kernel keeps the whole matrix in VMEM across a sequential
//   grid of panels. 4 MiB at n = 1024 fits no SM, so the working copy
//   lives in device memory (it is the output L) and every panel is three
//   kernels on the stream, which orders them:
//   (a) chol_diag: one block factors the diagonal block in shared memory,
//       column by column (sqrt, divide, rank-1 update of the lower part),
//       with unfused IEEE operations in the order of _chol_unblocked;
//   (b) chol_panel: one warp per row below the block solves X Lkk^T = P by
//       forward substitution, Lkk in shared memory, each dot product
//       reduced across the warp;
//   (c) chol_trailing: 64 x 64 tiles of the trailing lower triangle
//       subtract Lm Lm^T (4 x 4 register tiles, 16-column shared chunks);
//       tiles above the diagonal exit at once.
//   One more kernel first copies A's lower triangle into L and zeroes the
//   upper one, so no pass at the end is needed. A call enqueues
//   1 + 3 P - 2 kernels for P panels (23 at n = 1024, bs = 128).
// * A ragged last panel is handled by bounds, not by identity padding;
//   the padding rows would add only exact zeros, so the factor is the same.
// * No atomics: the result is the same bits every run.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxBs = 128;
constexpr int kDiagThreads = 512;
constexpr int kPanelWarps = 16;  // rows per chol_panel block, one per warp
constexpr int kTT = 64;          // trailing tile edge
constexpr int kTK = 16;          // trailing k chunk
constexpr int kTThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kCopyThreads = 256;

__global__ void __launch_bounds__(kCopyThreads)
chol_copy_lower(const float* __restrict__ a, float* __restrict__ L, int n) {
    const long long nn = static_cast<long long>(n) * n;
    for (long long e = static_cast<long long>(blockIdx.x) * kCopyThreads + threadIdx.x; e < nn;
         e += static_cast<long long>(gridDim.x) * kCopyThreads) {
        const long long i = e / n, j = e - i * n;
        L[e] = j <= i ? a[e] : 0.f;
    }
}

__global__ void __launch_bounds__(kDiagThreads)
chol_diag(float* __restrict__ L, int n, int off, int nb) {
    extern __shared__ float s[];  // [nb][nb + 1], lower triangle used
    const int ld = nb + 1;
    const int t = threadIdx.x;
    for (int e = t; e < nb * nb; e += kDiagThreads) {
        const int i = e / nb, j = e - i * nb;
        if (j <= i) s[i * ld + j] = L[static_cast<long long>(off + i) * n + off + j];
    }
    for (int j = 0; j < nb; ++j) {
        __syncthreads();
        const float d = __fsqrt_rn(s[j * ld + j]);
        for (int i = j + 1 + t; i < nb; i += kDiagThreads) s[i * ld + j] = __fdiv_rn(s[i * ld + j], d);
        __syncthreads();  // every read of s[j][j] above is done
        if (t == 0) s[j * ld + j] = d;
        const int w = nb - j - 1;
        for (int e = t; e < w * w; e += kDiagThreads) {
            const int ii = e / w, cc = e - ii * w;
            if (cc <= ii) {
                const int i = j + 1 + ii, c = j + 1 + cc;
                s[i * ld + c] = __fsub_rn(s[i * ld + c], __fmul_rn(s[i * ld + j], s[c * ld + j]));
            }
        }
    }
    __syncthreads();
    for (int e = t; e < nb * nb; e += kDiagThreads) {
        const int i = e / nb, j = e - i * nb;
        if (j <= i) L[static_cast<long long>(off + i) * n + off + j] = s[i * ld + j];
    }
}

__global__ void __launch_bounds__(kPanelWarps * 32)
chol_panel(float* __restrict__ L, int n, int off, int nb) {
    extern __shared__ float s[];
    const int ld = nb + 1;
    float* lkk = s;              // [nb][nb + 1], the factored diagonal block
    float* xs = s + nb * ld;     // [kPanelWarps][nb], one row per warp
    const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
    for (int e = t; e < nb * nb; e += kPanelWarps * 32) {
        const int i = e / nb, j = e - i * nb;
        if (j <= i) lkk[i * ld + j] = L[static_cast<long long>(off + i) * n + off + j];
    }
    const long long r = off + nb + static_cast<long long>(blockIdx.x) * kPanelWarps + warp;
    float* xr = xs + warp * nb;
    if (r < n)
        for (int c = lane; c < nb; c += 32) xr[c] = L[r * n + off + c];
    __syncthreads();
    if (r >= n) return;  // whole warps leave; no block barrier follows
    for (int j = 0; j < nb; ++j) {
        float acc = 0.f;
        for (int c = lane; c < j; c += 32) acc = fmaf(xr[c], lkk[j * ld + c], acc);
        // xor butterfly: every lane ends with the same bits
        for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        const float v = __fdiv_rn(__fsub_rn(xr[j], acc), lkk[j * ld + j]);
        __syncwarp();
        if (lane == 0) xr[j] = v;
        __syncwarp();
    }
    for (int c = lane; c < nb; c += 32) L[r * n + off + c] = xr[c];
}

__global__ void __launch_bounds__(kTThreads)
chol_trailing(float* __restrict__ L, int n, int off, int nb) {
    const int ti = blockIdx.y, tj = blockIdx.x;
    if (tj > ti) return;  // upper tiles: nothing to do
    __shared__ __align__(16) float as[kTK][kTT + 4];
    __shared__ __align__(16) float bs[kTK][kTT + 4];
    const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
    const int t0 = off + nb;
    const int ra = t0 + ti * kTT, rb = t0 + tj * kTT;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < nb; k0 += kTK) {
        for (int e = t; e < kTT * kTK; e += kTThreads) {
            const int rr = e / kTK, kk = e - rr * kTK;
            const bool kin = k0 + kk < nb;
            as[kk][rr] = kin && ra + rr < n ? L[static_cast<long long>(ra + rr) * n + off + k0 + kk] : 0.f;
            bs[kk][rr] = kin && rb + rr < n ? L[static_cast<long long>(rb + rr) * n + off + k0 + kk] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kTK; ++kk) {
            const float4 a = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
            const float4 b = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
            const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int gi = ra + ty * 4 + i;
        if (gi >= n) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int gj = rb + tx * 4 + j;
            if (gj <= gi) {
                float* p = L + static_cast<long long>(gi) * n + gj;
                *p = __fsub_rn(*p, acc[i][j]);
            }
        }
    }
}

}  // namespace

// a: (n, n) float32 row-major on the card (lower triangle read). L: (n, n)
// float32, the output and the working copy. bs: panel width, 1..128.
// Launches on card `device`, on `stream`; returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for arguments outside the limits.
extern "C" int chol_panel_fused(const void* a, void* L, int n, int bs, int device, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n < 1 || bs < 1 || bs > kMaxBs) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int diag_smem = static_cast<int>(sizeof(float)) * kMaxBs * (kMaxBs + 1);
    const int panel_smem = diag_smem + static_cast<int>(sizeof(float)) * kPanelWarps * kMaxBs;
    err = cudaFuncSetAttribute(chol_diag, cudaFuncAttributeMaxDynamicSharedMemorySize, diag_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(chol_panel, cudaFuncAttributeMaxDynamicSharedMemorySize, panel_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    float* l = static_cast<float*>(L);
    const long long nn = static_cast<long long>(n) * n;
    const int copy_blocks = static_cast<int>((nn + kCopyThreads - 1) / kCopyThreads < 4096
                                                 ? (nn + kCopyThreads - 1) / kCopyThreads
                                                 : 4096);
    chol_copy_lower<<<copy_blocks, kCopyThreads, 0, s>>>(static_cast<const float*>(a), l, n);
    for (int off = 0; off < n; off += bs) {
        const int nb = n - off < bs ? n - off : bs;
        chol_diag<<<1, kDiagThreads, sizeof(float) * nb * (nb + 1), s>>>(l, n, off, nb);
        const int below = n - off - nb;
        if (below <= 0) break;
        chol_panel<<<(below + kPanelWarps - 1) / kPanelWarps, kPanelWarps * 32,
                     sizeof(float) * (nb * (nb + 1) + kPanelWarps * nb), s>>>(l, n, off, nb);
        const int nt = (below + kTT - 1) / kTT;
        chol_trailing<<<dim3(nt, nt), kTThreads, 0, s>>>(l, n, off, nb);
    }
    return static_cast<int>(cudaGetLastError());
}
