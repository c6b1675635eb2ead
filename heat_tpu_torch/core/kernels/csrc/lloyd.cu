// lloyd_fused: one Lloyd assignment pass over a row-major (n, f) float32
// buffer against k centers: per-row int32 labels (argmin of
// d2 = max(|x|^2 + |c|^2 - 2 x.c, 0), ties to the lower index), and over
// the rows below n_valid the per-cluster sums (k, f), counts (k) and the
// inertia (sum of the minimum d2).
//
// Replaces heat_tpu/core/kernels/lloyd.py::_lloyd_kernel (the Pallas TPU
// kernel driven by _lloyd_call / lloyd_local); its contract is that of
// heat_tpu/cluster/kmeans.py::_assign_stats.
//
// Bound on an H100: bytes. It reads x once (4 n f bytes) and writes 4 n
// bytes of labels; the 2 n k f flops of the distances take less time at
// the card's float32 rate for the k, f it serves. The design:
//
// * The (k, f) centers live in shared memory, transposed and zero-padded
//   to a multiple of 8 centers, so each thread reads them as float4
//   broadcasts. Limits: f <= 128 and k * f <= 8192 (the wrapper raises
//   above them), which keep a block's shared memory under 227 KB.
// * No MXU padding: centers are not padded to 128 rows nor f to 128 lanes.
// * Pass 1 (lloyd_partial): each block owns a contiguous range of rows and
//   walks it in tiles of 256 rows. A tile is staged into shared memory with
//   coalesced loads (neighbouring threads read neighbouring floats). Each
//   thread then computes one row's distances in float32 on the CUDA cores
//   (no TF32, no tensor cores), in 8-center register chunks, and the
//   argmin. Per-cluster sums accumulate in G private copies in shared
//   memory, each (copy, cluster, column) owned by exactly one thread and
//   fed rows in a fixed order, so there are no atomics. Rows at or past
//   n_valid are left out of sums, counts and inertia; their labels are
//   still written. The block writes partials (nblocks, k, f),
//   (nblocks, k) and (nblocks,).
// * Pass 2 (lloyd_reduce) adds the partials in a fixed order in float64.
//
// No float atomics anywhere: centroids are bit-identical from run to run.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads per block; also rows per tile
constexpr int kTile = 256;
constexpr int kChunk = 8;         // centers per register chunk
constexpr int kMaxF = 128;
constexpr int kMaxKF = 8192;
constexpr int kMaxPriv = 8192;    // floats of private sum copies per block
constexpr size_t kMaxSmem = 232448;

struct Geometry {
    int kp, ld, G;
    size_t smem;
};

Geometry geometry(int f, int k) {
    Geometry g;
    g.kp = (k + kChunk - 1) / kChunk * kChunk;
    g.ld = f | 1;  // odd row stride: row-per-thread reads hit distinct banks
    const int R = kThreads / f;
    const int cap = kMaxPriv / (k * f);
    g.G = cap < 1 ? 1 : (cap < R ? cap : R);
    g.smem = sizeof(double) * kThreads +
             sizeof(float) * (static_cast<size_t>(kTile) * g.ld + static_cast<size_t>(f) * g.kp + g.kp +
                              static_cast<size_t>(g.G) * k * f) +
             sizeof(int) * (kTile + static_cast<size_t>(g.G) * k);
    return g;
}

__global__ void __launch_bounds__(kThreads)
lloyd_partial(const float* __restrict__ x, const float* __restrict__ centers, long long n,
              long long n_valid, int f, int k, int kp, int ld, int G, long long rows_per_block,
              int* __restrict__ labels, float* __restrict__ part_sums, int* __restrict__ part_counts,
              double* __restrict__ part_inertia) {
    extern __shared__ double smem[];
    double* red = smem;
    float* xs = reinterpret_cast<float*>(red + kThreads);
    float* csT = xs + kTile * ld;
    float* c2 = csT + f * kp;
    float* priv = c2 + kp;
    int* lab = reinterpret_cast<int*>(priv + G * k * f);
    int* cpriv = lab + kTile;

    const int t = threadIdx.x;
    for (int i = t; i < f * kp; i += kThreads) {
        const int c = i / kp, j = i - c * kp;
        csT[i] = j < k ? centers[j * f + c] : 0.f;
    }
    for (int i = t; i < G * k * f; i += kThreads) priv[i] = 0.f;
    for (int i = t; i < G * k; i += kThreads) cpriv[i] = 0;
    __syncthreads();
    for (int j = t; j < kp; j += kThreads) {
        float s = 0.f;
        for (int c = 0; c < f; ++c) {
            const float v = csT[c * kp + j];
            s = fmaf(v, v, s);
        }
        c2[j] = s;
    }
    __syncthreads();

    const int R = kThreads / f;       // rows staged per step
    const int sg = t / f;             // staging / accumulation group
    const int sc = t - sg * f;        // column
    const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
    const long long r1 = r0 + rows_per_block < n ? r0 + rows_per_block : n;
    double inertia = 0.0;

    for (long long base = r0; base < r1; base += kTile) {
        const int rows = static_cast<int>(r1 - base < kTile ? r1 - base : kTile);
        const long long nv = n_valid - base;
        const int rows_valid = nv <= 0 ? 0 : (nv < rows ? static_cast<int>(nv) : rows);
        if (sg < R) {
            const float* src = x + base * f;
            for (int rr = sg; rr < rows; rr += R) xs[rr * ld + sc] = __ldg(src + static_cast<long long>(rr) * f + sc);
        }
        __syncthreads();
        if (t < rows) {
            const float* xr = xs + t * ld;
            float x2 = 0.f;
            for (int c = 0; c < f; ++c) x2 = fmaf(xr[c], xr[c], x2);
            float best = __int_as_float(0x7f800000);  // +inf
            int bj = 0;
            for (int j0 = 0; j0 < kp; j0 += kChunk) {
                float acc[kChunk];
#pragma unroll
                for (int u = 0; u < kChunk; ++u) acc[u] = 0.f;
                for (int c = 0; c < f; ++c) {
                    const float xv = xr[c];
                    const float4* cp = reinterpret_cast<const float4*>(csT + c * kp + j0);
                    const float4 a = cp[0], b = cp[1];
                    acc[0] = fmaf(xv, a.x, acc[0]);
                    acc[1] = fmaf(xv, a.y, acc[1]);
                    acc[2] = fmaf(xv, a.z, acc[2]);
                    acc[3] = fmaf(xv, a.w, acc[3]);
                    acc[4] = fmaf(xv, b.x, acc[4]);
                    acc[5] = fmaf(xv, b.y, acc[5]);
                    acc[6] = fmaf(xv, b.z, acc[6]);
                    acc[7] = fmaf(xv, b.w, acc[7]);
                }
#pragma unroll
                for (int u = 0; u < kChunk; ++u) {
                    const int j = j0 + u;
                    if (j < k) {
                        // (x2 + c2) - 2 xc in that order, unfused, as heat_tpu's _quadratic_expand
                        float d = __fsub_rn(__fadd_rn(x2, c2[j]), __fmul_rn(2.f, acc[u]));
                        d = fmaxf(d, 0.f);
                        if (d < best) {  // strict: ties keep the lower index
                            best = d;
                            bj = j;
                        }
                    }
                }
            }
            lab[t] = bj;
            labels[base + t] = bj;
            if (t < rows_valid) inertia += static_cast<double>(best);
        }
        __syncthreads();
        if (sg < G) {
            float* pg = priv + sg * k * f;
            for (int rr = sg; rr < rows_valid; rr += G) {
                const int j = lab[rr];
                pg[j * f + sc] += xs[rr * ld + sc];
                if (sc == 0) cpriv[sg * k + j] += 1;
            }
        }
        __syncthreads();
    }

    const long long b = blockIdx.x;
    const int kf = k * f;
    for (int i = t; i < kf; i += kThreads) {
        float s = 0.f;
        for (int gg = 0; gg < G; ++gg) s += priv[gg * kf + i];
        part_sums[b * kf + i] = s;
    }
    for (int j = t; j < k; j += kThreads) {
        int s = 0;
        for (int gg = 0; gg < G; ++gg) s += cpriv[gg * k + j];
        part_counts[b * k + j] = s;
    }
    red[t] = inertia;
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s >>= 1) {
        if (t < s) red[t] += red[t + s];
        __syncthreads();
    }
    if (t == 0) part_inertia[b] = red[0];
}

// Output i < k f: sums; k f <= i < k f + k: counts; i == k f + k: inertia.
// Lane = output, warp w adds blocks w, w + 8, ...; the 8 warp sums are then
// added in warp order.
__global__ void __launch_bounds__(kThreads)
lloyd_reduce(const float* __restrict__ part_sums, const int* __restrict__ part_counts,
             const double* __restrict__ part_inertia, int nblocks, int k, int f,
             float* __restrict__ sums, float* __restrict__ counts, float* __restrict__ inertia) {
    __shared__ double red[kThreads / 32][32];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int kf = k * f;
    const int i = blockIdx.x * 32 + lane;
    const int total = kf + k + 1;
    double s = 0.0;
    if (i < total) {
        for (int b = w; b < nblocks; b += kThreads / 32) {
            const long long bb = b;
            if (i < kf)
                s += static_cast<double>(part_sums[bb * kf + i]);
            else if (i < kf + k)
                s += static_cast<double>(part_counts[bb * k + (i - kf)]);
            else
                s += part_inertia[bb];
        }
    }
    red[w][lane] = s;
    __syncthreads();
    if (w == 0 && i < total) {
        double a = 0.0;
        for (int ww = 0; ww < kThreads / 32; ++ww) a += red[ww][lane];
        if (i < kf)
            sums[i] = static_cast<float>(a);
        else if (i < kf + k)
            counts[i - kf] = static_cast<float>(a);
        else
            inertia[0] = static_cast<float>(a);
    }
}

}  // namespace

// x: (n, f) and centers: (k, f) float32 row-major on the card. Scratch:
// part_sums (nblocks, k, f) float32, part_counts (nblocks, k) int32,
// part_inertia (nblocks,) float64. Outputs: labels (n,) int32, sums (k, f),
// counts (k,), inertia (1,) float32. Launches on card `device`, on
// `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a shape outside the limits above.
extern "C" int lloyd_fused(const void* x, const void* centers, long long n, int f, int k,
                           long long n_valid, int nblocks, void* labels, void* part_sums,
                           void* part_counts, void* part_inertia, void* sums, void* counts,
                           void* inertia, int device, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n < 1 || f < 1 || f > kMaxF || k < 1 || static_cast<long long>(k) * f > kMaxKF || nblocks < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const Geometry g = geometry(f, k);
    if (g.smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(lloyd_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(g.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long nv = n_valid < 0 ? 0 : (n_valid < n ? n_valid : n);
    long long rows_per_block = (n + nblocks - 1) / nblocks;
    rows_per_block = (rows_per_block + kTile - 1) / kTile * kTile;
    lloyd_partial<<<nblocks, kThreads, g.smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(centers), n, nv, f, k, g.kp, g.ld, g.G,
        rows_per_block, static_cast<int*>(labels), static_cast<float*>(part_sums),
        static_cast<int*>(part_counts), static_cast<double*>(part_inertia));
    const int total = k * f + k + 1;
    lloyd_reduce<<<(total + 31) / 32, kThreads, 0, s>>>(
        static_cast<const float*>(part_sums), static_cast<const int*>(part_counts),
        static_cast<const double*>(part_inertia), nblocks, k, f, static_cast<float*>(sums),
        static_cast<float*>(counts), static_cast<float*>(inertia));
    return static_cast<int>(cudaGetLastError());
}
