// moments_onepass: per-column (count, mean, M2) of a row-major (n, f)
// float32 buffer in one read, rows at index >= n_valid excluded.
//
// Replaces heat_tpu/core/kernels/moments.py::_moments_kernel (the Pallas
// TPU kernel driven by _moments_call / moments_local).
//
// Bound on an H100: bytes. The function reads n_valid * f * 4 bytes once and
// does O(n f) arithmetic, so its floor is that read at the card's memory
// rate. The design keeps to one read and keeps every load coalesced:
//
// * Pass 1 (moments_partial): each block owns a contiguous range of rows.
//   Its 256 threads cover R = 256 / cw rows of cw columns at a time, so
//   neighbouring threads read neighbouring floats of the row-major buffer,
//   for narrow rows (f = 32, 18, 1) as for wide ones (column tiles of 256
//   via blockIdx.y). Each thread accumulates shifted sums
//   s1 = sum(x - x0), s2 = sum((x - x0)^2) in float64 (x0 = the column's
//   first row; the variance is shift-invariant). The R thread-rows of a
//   column are summed in a fixed order and the block writes its partial
//   (count, mean, M2) to scratch of shape (nblocks, f).
// * Pass 2 (moments_merge): one block per column Chan-merges the partials
//   in a fixed order (strided per thread, then a fixed tree), in float64.
//
// No float atomics: the result is the same on every run. Counts are
// integers throughout; n_valid is an integer (a float32 compare is wrong
// past 2^24 rows). Rows at or past n_valid are never read.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void chan_merge(long long& na, double& ma, double& m2a,
                                           long long nb, double mb, double m2b) {
    if (nb == 0) return;
    if (na == 0) {
        na = nb;
        ma = mb;
        m2a = m2b;
        return;
    }
    const double n = static_cast<double>(na + nb);
    const double delta = mb - ma;
    ma = ma + delta * (static_cast<double>(nb) / n);
    m2a = m2a + m2b + delta * delta * (static_cast<double>(na) * static_cast<double>(nb) / n);
    na += nb;
}

__global__ void __launch_bounds__(kThreads)
moments_partial(const float* __restrict__ x, long long n_eff, int f, int cw, long long rows_per_block,
                long long* __restrict__ part_cnt, double* __restrict__ part_mean,
                double* __restrict__ part_m2) {
    __shared__ double sh1[kThreads];
    __shared__ double sh2[kThreads];
    const int t = threadIdx.x;
    const int R = kThreads / cw;  // rows covered per step
    const int g = t / cw;         // this thread's row within a step
    const int c = blockIdx.y * cw + (t - g * cw);
    const bool active = g < R && c < f;
    const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
    const long long r1 = r0 + rows_per_block < n_eff ? r0 + rows_per_block : n_eff;

    double s1 = 0.0, s2 = 0.0;
    if (active) {
        const double shift = static_cast<double>(__ldg(x + c));
        long long r = r0 + g;
        const long long step = R;
        for (; r + 7 * step < r1; r += 8 * step) {
            float v[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) v[u] = __ldg(x + (r + u * step) * f + c);
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                const double d = static_cast<double>(v[u]) - shift;
                s1 += d;
                s2 += d * d;
            }
        }
        for (; r < r1; r += step) {
            const double d = static_cast<double>(__ldg(x + r * f + c)) - shift;
            s1 += d;
            s2 += d * d;
        }
        sh1[t] = s1;
        sh2[t] = s2;
    }
    __syncthreads();
    if (active && g == 0) {
        for (int gg = 1; gg < R; ++gg) {
            s1 += sh1[gg * cw + t];
            s2 += sh2[gg * cw + t];
        }
        const long long cnt = r1 > r0 ? r1 - r0 : 0;
        const long long b = blockIdx.x;
        double mean = 0.0, m2 = 0.0;
        if (cnt > 0) {
            const double dn = static_cast<double>(cnt);
            mean = static_cast<double>(__ldg(x + c)) + s1 / dn;
            m2 = s2 - s1 * s1 / dn;
            m2 = m2 > 0.0 ? m2 : 0.0;
        }
        part_mean[b * f + c] = mean;
        part_m2[b * f + c] = m2;
        if (c == 0) part_cnt[b] = cnt;
    }
}

__global__ void __launch_bounds__(kThreads)
moments_merge(const long long* __restrict__ part_cnt, const double* __restrict__ part_mean,
              const double* __restrict__ part_m2, int nblocks, int f,
              float* __restrict__ cnt_out, float* __restrict__ mean_out, float* __restrict__ m2_out) {
    __shared__ long long shn[kThreads];
    __shared__ double shm[kThreads];
    __shared__ double shq[kThreads];
    const int t = threadIdx.x;
    const int c = blockIdx.x;
    long long n = 0;
    double m = 0.0, q = 0.0;
    for (int b = t; b < nblocks; b += kThreads)
        chan_merge(n, m, q, part_cnt[b], part_mean[static_cast<long long>(b) * f + c],
                   part_m2[static_cast<long long>(b) * f + c]);
    shn[t] = n;
    shm[t] = m;
    shq[t] = q;
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s >>= 1) {
        if (t < s) {
            long long na = shn[t];
            double ma = shm[t], qa = shq[t];
            chan_merge(na, ma, qa, shn[t + s], shm[t + s], shq[t + s]);
            shn[t] = na;
            shm[t] = ma;
            shq[t] = qa;
        }
        __syncthreads();
    }
    if (t == 0) {
        mean_out[c] = static_cast<float>(shm[0]);
        m2_out[c] = static_cast<float>(shq[0]);
        if (c == 0) cnt_out[0] = static_cast<float>(shn[0]);
    }
}

}  // namespace

// x: (n, f) float32 row-major on the card. Scratch: part_cnt (nblocks,)
// int64, part_mean and part_m2 (nblocks, f) float64. Outputs: cnt_out (1,),
// mean_out (f,), m2_out (f,) float32. Launches on card `device`, on
// `stream`; returns cudaGetLastError() (0 on success).
extern "C" int moments_onepass(const void* x, long long n, int f, long long n_valid, int nblocks,
                               void* part_cnt, void* part_mean, void* part_m2,
                               void* cnt_out, void* mean_out, void* m2_out, int device,
                               void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n < 0 || f < 1 || nblocks < 1) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long n_eff = n_valid < 0 ? 0 : (n_valid < n ? n_valid : n);
    if (n_eff == 0) {
        cudaMemsetAsync(cnt_out, 0, sizeof(float), s);
        cudaMemsetAsync(mean_out, 0, sizeof(float) * f, s);
        cudaMemsetAsync(m2_out, 0, sizeof(float) * f, s);
        return static_cast<int>(cudaGetLastError());
    }
    const int cw = f < kThreads ? f : kThreads;
    const long long rows_per_block = (n_eff + nblocks - 1) / nblocks;
    const dim3 grid(nblocks, (f + cw - 1) / cw);
    moments_partial<<<grid, kThreads, 0, s>>>(static_cast<const float*>(x), n_eff, f, cw, rows_per_block,
                                              static_cast<long long*>(part_cnt),
                                              static_cast<double*>(part_mean),
                                              static_cast<double*>(part_m2));
    moments_merge<<<f, kThreads, 0, s>>>(static_cast<const long long*>(part_cnt),
                                         static_cast<const double*>(part_mean),
                                         static_cast<const double*>(part_m2), nblocks, f,
                                         static_cast<float*>(cnt_out), static_cast<float*>(mean_out),
                                         static_cast<float*>(m2_out));
    return static_cast<int>(cudaGetLastError());
}
