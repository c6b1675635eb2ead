// topk_distance: for every query row of a row-major (n, f) float32 buffer
// x, the k nearest rows of a row-major (m, f) float32 buffer y, as
// (squared distance, global row index of y) pairs in ascending
// lexicographic order, without ever writing the (n, m) distance matrix.
// d2 = max((|x|^2 + |y|^2) - 2 x.y, 0), the order of heat_tpu's
// _quadratic_expand; ties go to the lower index.
//
// Replaces heat_tpu/core/kernels/topk_distance.py::_knn_kernel with its
// _merge_topk (the Pallas TPU kernel driven by _knn_local /
// nearest_neighbors).
//
// Bound on an H100: operations. 2 n m f flops against (n + m) f 4 bytes
// read and n k 8 bytes written; at the main path's n = 2^13, f = 32 that is
// about 500 flops per byte, far above the card's float32 balance point.
// The design:
//
// * The TPU kernel walks y-tiles on a sequential grid and carries the
//   running top-k in its output block. Blocks on Hopper run in no order,
//   so the y range is cut into nseg segments instead: block (q, s) owns
//   128 query rows (one per thread) and walks segment s of y, keeping each
//   row's top-k list in shared memory. A second kernel (knn_merge) merges
//   the nseg sorted lists of every row, comparing (d, idx)
//   lexicographically. No atomics: results are the same bits every run.
// * Each y-tile (64 rows) is staged into shared memory with coalesced
//   loads, transposed so that a thread reads 8 y rows of one column as two
//   float4 broadcasts; the thread's query row sits in shared memory at an
//   odd stride (no bank conflicts). Each thread keeps 8 dot products in
//   registers (8 FMAs per 3 shared loads), on the CUDA cores in float32:
//   no TF32, no tensor cores.
// * Any f: columns are staged in chunks of 32; with more than one chunk
//   the partial dot products wait in shared memory between chunks. |y|^2
//   is summed from the staged chunks, |x|^2 once per block.
// * A candidate enters a row's list only if it is lexicographically below
//   the current k-th entry; the list is kept sorted by insertion. k is at
//   most 64 (MAX_K in topk_distance.py).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // query rows per block, one per thread
constexpr int kYT = 64;        // y rows per staged tile
constexpr int kFC = 32;        // columns per staged chunk
constexpr int kGroup = 8;      // y rows per register group
constexpr int kYld = kYT + 4;  // transposed tile row stride: float4 aligned
constexpr int kMaxK = 64;
constexpr int kMaxSeg = 64;
constexpr int kIntMax = 0x7fffffff;
constexpr int kMergeThreads = 128;
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ bool lex_less(float d, int i, float d2, int i2) {
    return d < d2 || (d == d2 && i < i2);
}

size_t partial_smem(int f, int k) {
    const int fc = f < kFC ? f : kFC;
    const int nchunks = (f + kFC - 1) / kFC;
    const size_t floats = static_cast<size_t>(fc) * kYld + kYT +
                          (nchunks > 1 ? static_cast<size_t>(kYT) * kThreads : 0) +
                          static_cast<size_t>(kThreads) * (fc | 1) + static_cast<size_t>(kThreads) * k;
    return sizeof(float) * floats + sizeof(int) * static_cast<size_t>(kThreads) * k;
}

__global__ void __launch_bounds__(kThreads)
knn_partial(const float* __restrict__ x, const float* __restrict__ y, int n, long long m, int f, int k,
            long long seg_len, float* __restrict__ part_d, int* __restrict__ part_i) {
    extern __shared__ float4 smem4[];
    const float kInf = __int_as_float(0x7f800000);
    const int fc = f < kFC ? f : kFC;
    const int ldx = fc | 1;  // odd stride: row-per-thread reads hit distinct banks
    const int nchunks = (f + kFC - 1) / kFC;
    float* ysT = reinterpret_cast<float*>(smem4);  // [fc][kYld], first: 16-byte aligned
    float* y2s = ysT + fc * kYld;                  // [kYT]
    float* dots = y2s + kYT;                       // [kYT][kThreads], only with nchunks > 1
    float* xs = dots + (nchunks > 1 ? kYT * kThreads : 0);  // [kThreads][ldx]
    float* topd = xs + kThreads * ldx;             // [k][kThreads]
    int* topi = reinterpret_cast<int*>(topd + kThreads * k);

    const int t = threadIdx.x;
    const long long r0 = static_cast<long long>(blockIdx.x) * kThreads;
    const long long row = r0 + t;
    const bool live = row < n;
    const long long j_begin = static_cast<long long>(blockIdx.y) * seg_len;
    const long long j_end = j_begin + seg_len < m ? j_begin + seg_len : m;

    float x2 = 0.f;
    if (live) {
        const float* xr = x + row * f;
        for (int c = 0; c < f; ++c) x2 = fmaf(xr[c], xr[c], x2);
    }
    for (int p = 0; p < k; ++p) {
        topd[p * kThreads + t] = kInf;
        topi[p * kThreads + t] = kIntMax;
    }
    float thr_d = kInf;
    int thr_i = kIntMax;

    // rows of this block's queries, columns [c0, c0 + w), coalesced
    auto stage_x = [&](int c0, int w) {
        for (int e = t; e < kThreads * w; e += kThreads) {
            const int r = e / w, c = e - r * w;
            xs[r * ldx + c] = r0 + r < n ? __ldg(x + (r0 + r) * f + c0 + c) : 0.f;
        }
    };
    if (nchunks == 1) stage_x(0, fc);

    const float* xr = xs + t * ldx;
    for (long long j0 = j_begin; j0 < j_end; j0 += kYT) {
        const int rows = static_cast<int>(j_end - j0 < kYT ? j_end - j0 : kYT);
        for (int ci = 0; ci < nchunks; ++ci) {
            const int c0 = ci * kFC;
            const int w = f - c0 < kFC ? f - c0 : kFC;
            __syncthreads();  // the previous chunk's readers are done with xs / ysT / y2s
            if (nchunks > 1) stage_x(c0, w);
            for (int e = t; e < kYT * w; e += kThreads) {
                const int r = e / w, c = e - r * w;
                ysT[c * kYld + r] = r < rows ? __ldg(y + (j0 + r) * f + c0 + c) : 0.f;
            }
            __syncthreads();
            if (t < kYT) {
                float s2 = ci == 0 ? 0.f : y2s[t];
                for (int c = 0; c < w; ++c) {
                    const float v = ysT[c * kYld + t];
                    s2 = fmaf(v, v, s2);
                }
                y2s[t] = s2;
            }
            __syncthreads();
            const bool last = ci + 1 == nchunks;
            for (int g = 0; g < rows; g += kGroup) {
                float acc[kGroup];
#pragma unroll
                for (int u = 0; u < kGroup; ++u) acc[u] = ci == 0 ? 0.f : dots[(g + u) * kThreads + t];
                for (int c = 0; c < w; ++c) {
                    const float xv = xr[c];
                    const float4* yp = reinterpret_cast<const float4*>(ysT + c * kYld + g);
                    const float4 a = yp[0], b = yp[1];
                    acc[0] = fmaf(xv, a.x, acc[0]);
                    acc[1] = fmaf(xv, a.y, acc[1]);
                    acc[2] = fmaf(xv, a.z, acc[2]);
                    acc[3] = fmaf(xv, a.w, acc[3]);
                    acc[4] = fmaf(xv, b.x, acc[4]);
                    acc[5] = fmaf(xv, b.y, acc[5]);
                    acc[6] = fmaf(xv, b.z, acc[6]);
                    acc[7] = fmaf(xv, b.w, acc[7]);
                }
                if (!last) {
#pragma unroll
                    for (int u = 0; u < kGroup; ++u) dots[(g + u) * kThreads + t] = acc[u];
                    continue;
                }
                if (!live) continue;
#pragma unroll
                for (int u = 0; u < kGroup; ++u) {
                    if (g + u >= rows) break;
                    // (x2 + y2) - 2 xy in that order, unfused, as heat_tpu's _quadratic_expand
                    float d = __fsub_rn(__fadd_rn(x2, y2s[g + u]), __fmul_rn(2.f, acc[u]));
                    d = d < 0.f ? 0.f : d;  // clamp at 0; a NaN stays NaN
                    const int j = static_cast<int>(j0 + g + u);
                    if (!lex_less(d, j, thr_d, thr_i)) continue;
                    int p = k - 1;
                    while (p > 0) {
                        const float pd = topd[(p - 1) * kThreads + t];
                        const int pi = topi[(p - 1) * kThreads + t];
                        if (!lex_less(d, j, pd, pi)) break;
                        topd[p * kThreads + t] = pd;
                        topi[p * kThreads + t] = pi;
                        --p;
                    }
                    topd[p * kThreads + t] = d;
                    topi[p * kThreads + t] = j;
                    thr_d = topd[(k - 1) * kThreads + t];
                    thr_i = topi[(k - 1) * kThreads + t];
                }
            }
        }
    }
    if (live) {
        const long long o = (static_cast<long long>(blockIdx.y) * n + row) * k;
        for (int p = 0; p < k; ++p) {
            part_d[o + p] = topd[p * kThreads + t];
            part_i[o + p] = topi[p * kThreads + t];
        }
    }
}

// One thread per query row: k rounds of picking the lexicographically
// smallest head among the row's nseg sorted lists.
__global__ void __launch_bounds__(kMergeThreads)
knn_merge(const float* __restrict__ part_d, const int* __restrict__ part_i, int n, int k, int nseg,
          float* __restrict__ out_d, int* __restrict__ out_i) {
    const long long row = static_cast<long long>(blockIdx.x) * kMergeThreads + threadIdx.x;
    if (row >= n) return;
    int head[kMaxSeg];
    for (int s = 0; s < nseg; ++s) head[s] = 0;
    for (int p = 0; p < k; ++p) {
        int best = -1;
        float bd = 0.f;
        int bi = 0;
        for (int s = 0; s < nseg; ++s) {
            if (head[s] >= k) continue;
            const long long o = (static_cast<long long>(s) * n + row) * k + head[s];
            const float d = part_d[o];
            const int i = part_i[o];
            if (best < 0 || lex_less(d, i, bd, bi)) {
                best = s;
                bd = d;
                bi = i;
            }
        }
        ++head[best];
        out_d[row * k + p] = bd;
        out_i[row * k + p] = bi;
    }
}

}  // namespace

// x: (n, f) and y: (m, f) float32 row-major on the card. Scratch: part_d
// (nseg, n, k) float32 and part_i (nseg, n, k) int32, where segment s
// covers y rows [s seg_len, (s + 1) seg_len). Outputs: out_d (n, k)
// float32 ascending, out_i (n, k) int32. Launches on card `device`, on
// `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for arguments outside the limits above.
extern "C" int topk_distance(const void* x, const void* y, int n, long long m, int f, int k, int nseg,
                             long long seg_len, void* part_d, void* part_i, void* out_d, void* out_i,
                             int device, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n < 1 || m < 1 || m > kIntMax || f < 1 || k < 1 || k > kMaxK || k > m || nseg < 1 ||
        nseg > kMaxSeg || seg_len < 1 || static_cast<long long>(nseg) * seg_len < m)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = partial_smem(f, k);
    if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(knn_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((n + kThreads - 1) / kThreads, nseg);
    knn_partial<<<grid, kThreads, smem, s>>>(static_cast<const float*>(x), static_cast<const float*>(y), n, m, f,
                                             k, seg_len, static_cast<float*>(part_d), static_cast<int*>(part_i));
    knn_merge<<<(n + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0, s>>>(
        static_cast<const float*>(part_d), static_cast<const int*>(part_i), n, k, nseg, static_cast<float*>(out_d),
        static_cast<int*>(out_i));
    return static_cast<int>(cudaGetLastError());
}
