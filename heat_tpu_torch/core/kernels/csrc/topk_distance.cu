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
// * Three kernels on the stream: row_norms (|x|^2 and |y|^2, one thread
//   per row, a sequential fmaf chain), knn_partial, knn_merge.
// * The TPU kernel walks y-tiles on a sequential grid and carries the
//   running top-k in its output block. Blocks on Hopper run in no order,
//   so the y range is cut into nseg segments: block (q, s) owns 128 query
//   rows (4 warps of 32) and walks segment s of y; knn_merge then merges
//   the nseg sorted lists of every row, comparing (d, idx)
//   lexicographically. No atomics: results are the same bits every run.
// * x.y in float32 on the CUDA cores, register-tiled: a warp owns 32
//   query rows and each thread 4 of them x 16 y rows of the tile (64
//   sums), reading 4 columns of each operand per shared-memory load: 256
//   FMAs per 20 loads. The block's query rows sit in
//   shared memory for the whole segment when f <= 32; with f > 32, K is
//   walked in 32-column chunks, both operands staged per chunk and padded
//   with zeros, which is exact. (Three TF32 tensor-core products, 3xTF32,
//   moved the kNN path's distances outside the float32 tolerances at
//   2^13 x 2^22 x 32 on the card, so the product stays in float32.)
// * y arrives in 64-row x 32-column tiles through a ring of three shared-
//   memory stages filled by cp.async: tile i + 1 and i + 2 load while tile
//   i is multiplied. 16-byte copies when f is a multiple of 4 (rows are
//   then 16-byte aligned), 4-byte copies otherwise: the same kernel, a
//   template variant. Rows are padded to 36 floats, so a warp's float4
//   reads of either operand hit distinct banks. Each tile's |y|^2 rides
//   along in the same stage.
// * A threshold filter per candidate: the accumulator becomes d2
//   (one add and one fma) and is compared with its row's current k-th
//   distance, kept in shared memory; only where a lane of the warp has a
//   candidate at or below it does the warp clamp and compare (d, idx)
//   exactly. Only the rare candidate that passes is queued, per row, in
//   shared memory (slots allocated by a prefix sum over the 4 lanes that
//   share a row: no atomics); the row's owning lane merges the queue into
//   its sorted list after every 32 candidates and refreshes the threshold.
//   A stale threshold only admits candidates that the insertion then
//   rejects, so the list is the same set in the same order.
// * Any k <= m: for k <= 64 (kMaxSmemK, MAX_K in topk_distance.py) each
//   row's list lives in shared memory; above it, in the (nseg, n, k)
//   scratch that knn_merge reads anyway (the threshold stays in shared
//   memory), another template variant.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;  // 128 query rows per block, 32 per warp
constexpr int kYT = 64;                // y rows per staged tile: 8 n8 fragments
constexpr int kKC = 32;                // columns per staged chunk: 4 k8 steps
constexpr int kLd = kKC + 4;           // padded tile row stride
constexpr int kStages = 3;
constexpr int kQ = 32;                 // queue slots per row: one half-tile of candidates
constexpr int kWarpFloats = 3 * 32 + 2 * kQ * 32;  // thr_d, thr_i, qcnt, q_d, q_i
constexpr int kMaxSmemK = 64;
constexpr int kMaxSeg = 64;
constexpr int kIntMax = 0x7fffffff;
constexpr int kNormThreads = 256;
constexpr int kMergeThreads = 128;
constexpr int kMaxSmem = 232448;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ bool lex_less(float d, int i, float d2, int i2) {
    return d < d2 || (d == d2 && i < i2);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

int partial_smem(int k) {
    const int lists = k <= kMaxSmemK ? kWarps * 2 * k * 32 : 0;
    return static_cast<int>(sizeof(float)) * (kStages * (kYT * kLd + kYT) + kThreads * kLd + kWarps * kWarpFloats + lists);
}

// out[r] = |row r|^2 for the n rows of x, then the m rows of y
__global__ void __launch_bounds__(kNormThreads)
row_norms(const float* __restrict__ x, int n, const float* __restrict__ y, long long m, int f,
          float* __restrict__ out) {
    const long long r = static_cast<long long>(blockIdx.x) * kNormThreads + threadIdx.x;
    if (r >= n + m) return;
    const float* v = r < n ? x + r * f : y + (r - n) * f;
    float s = 0.f;
    for (int c = 0; c < f; ++c) s = fmaf(__ldg(v + c), __ldg(v + c), s);
    out[r] = s;
}

template <bool kVec16, bool kGlobalList>
__global__ void __launch_bounds__(kThreads, 2)
knn_partial(const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ norms, int n,
            long long m, int f, int k, long long seg_len, float* __restrict__ part_d, int* __restrict__ part_i) {
    extern __shared__ float4 smem4[];
    const float kInf = __int_as_float(0x7f800000), kNaN = __int_as_float(0x7fffffff);
    const int t = threadIdx.x, warp = t >> 5, lane = t & 31, g = lane >> 2, tq = lane & 3;
    float* ys = reinterpret_cast<float*>(smem4);  // [kStages][kYT][kLd]
    float* y2s = ys + kStages * kYT * kLd;         // [kStages][kYT]: |y|^2 of the tile's rows, NaN past the segment
    float* xs = y2s + kStages * kYT;               // [kThreads][kLd]: the block's query rows, one 32-column chunk
    float* wbase = xs + kThreads * kLd + warp * kWarpFloats;
    float* thr_d = wbase;                                   // [32]
    int* thr_i = reinterpret_cast<int*>(wbase + 32);        // [32]
    int* qcnt = reinterpret_cast<int*>(wbase + 64);         // [32]
    float* q_d = wbase + 96;                                // [kQ][32]
    int* q_i = reinterpret_cast<int*>(wbase + 96 + kQ * 32);  // [kQ][32]

    const long long wrow0 = static_cast<long long>(blockIdx.x) * kThreads + warp * 32;
    const long long seg = blockIdx.y;
    const long long j_begin = seg * seg_len;
    const long long j_end = j_begin + seg_len < m ? j_begin + seg_len : m;
    const float* y2g = norms + n;

    // ---- the owning lane's sorted list: row wrow0 + lane
    const long long orow = wrow0 + lane;
    const bool olive = orow < n;
    float* lst_d;
    int* lst_i;
    int lstride;
    if (kGlobalList) {
        const long long o = (seg * n + (olive ? orow : 0)) * k;
        lst_d = part_d + o;
        lst_i = part_i + o;
        lstride = 1;
    } else {
        float* lbase = xs + kThreads * kLd + kWarps * kWarpFloats + warp * 2 * k * 32;
        lst_d = lbase + lane;
        lst_i = reinterpret_cast<int*>(lbase + k * 32) + lane;
        lstride = 32;
    }
    int olen = 0;
    if (olive || !kGlobalList)
        for (int p = 0; p < k; ++p) {
            lst_d[p * lstride] = kInf;
            lst_i[p * lstride] = kIntMax;
        }
    thr_d[lane] = olive ? kInf : -1.f;  // a dead row admits nothing: every d >= 0 or NaN
    thr_i[lane] = kIntMax;
    qcnt[lane] = 0;

    // ---- this lane's accumulator rows: r = mt * 16 + h * 8 + g
    float x2r[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const long long r = wrow0 + mt * 16 + h * 8 + g;
            x2r[mt][h] = r < n ? __ldg(norms + r) : 0.f;
        }
    const long long r0 = static_cast<long long>(blockIdx.x) * kThreads;
    auto stage_x = [&](int c0) {  // all loads first, then the stores
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float v[kKC / 2];
#pragma unroll
            for (int q = 0; q < kKC / 2; ++q) {
                const int e = t + (h * kKC / 2 + q) * kThreads, r = e >> 5, c = c0 + (e & 31);
                v[q] = r0 + r < n && c < f ? __ldg(x + (r0 + r) * f + c) : 0.f;
            }
#pragma unroll
            for (int q = 0; q < kKC / 2; ++q) {
                const int e = t + (h * kKC / 2 + q) * kThreads;
                xs[(e >> 5) * kLd + (e & 31)] = v[q];
            }
        }
    };
    const int nchunks = (f + kKC - 1) / kKC;
    if (nchunks == 1) stage_x(0);

    const long long ntile = (j_end - j_begin + kYT - 1) / kYT;
    const long long units = ntile * nchunks;
    auto issue = [&](long long u) {
        const long long jt = j_begin + (u / nchunks) * kYT;
        const int c0 = static_cast<int>(u % nchunks) * kKC;
        float* dst = ys + static_cast<int>(u % kStages) * kYT * kLd;
        if (c0 + kKC >= f && t < kYT) {  // with the tile's last chunk: the rows' |y|^2 for the epilogue
            float* y2d = y2s + static_cast<int>(u % kStages) * kYT + t;
            if (jt + t < j_end)
                cp_async4(y2d, y2g + jt + t, 4);
            else
                *y2d = kNaN;
        }
        if (kVec16) {
            for (int e = t; e < kYT * (kKC / 4); e += kThreads) {
                const int r = e >> 3, c = c0 + (e & 7) * 4;
                const bool ok = jt + r < j_end && c < f;
                cp_async16(dst + r * kLd + (e & 7) * 4, ok ? y + (jt + r) * f + c : y, ok ? 16 : 0);
            }
        } else {
            for (int e = t; e < kYT * kKC; e += kThreads) {
                const int r = e >> 5, c = c0 + (e & 31);
                const bool ok = jt + r < j_end && c < f;
                cp_async4(dst + r * kLd + (e & 31), ok ? y + (jt + r) * f + c : y, ok ? 4 : 0);
            }
        }
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < units) issue(s);
        cp_async_commit();
    }

    // acc[mt][nt][e]: query row mt * 16 + (e >> 1) * 8 + g of the warp's 32, y row
    // nt * 8 + 2 tq + (e & 1) of the tile
    float acc[2][8][4];
    for (long long u = 0; u < units; ++u) {
        cp_async_wait<kStages - 2>();
        __syncthreads();  // unit u is in for every thread; unit u - 1's stage is free
        if (u + kStages - 1 < units) issue(u + kStages - 1);
        cp_async_commit();
        const int ch = static_cast<int>(u % nchunks);
        if (ch == 0) {
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int nt = 0; nt < 8; ++nt)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
        }
        if (nchunks > 1) {
            stage_x(ch * kKC);
            __syncthreads();
        }
        // float32 dot products on the CUDA cores: this thread's 4 query rows x 16 y rows,
        // k in order, 4 columns per shared-memory read of each operand
        const float* yb = ys + static_cast<int>(u % kStages) * kYT * kLd;
        const float* xw = xs + warp * 32 * kLd;
#pragma unroll
        for (int k4 = 0; k4 < kKC / 4; ++k4) {
            float4 xv[2][2];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    xv[mt][h] = *reinterpret_cast<const float4*>(xw + (mt * 16 + h * 8 + g) * kLd + 4 * k4);
#pragma unroll
            for (int nt = 0; nt < 8; ++nt)
#pragma unroll
                for (int b = 0; b < 2; ++b) {
                    const float4 yv = *reinterpret_cast<const float4*>(yb + (nt * 8 + 2 * tq + b) * kLd + 4 * k4);
#pragma unroll
                    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                        for (int h = 0; h < 2; ++h) {
                            float& a = acc[mt][nt][h * 2 + b];
                            a = fmaf(xv[mt][h].x, yv.x, a);
                            a = fmaf(xv[mt][h].y, yv.y, a);
                            a = fmaf(xv[mt][h].z, yv.z, a);
                            a = fmaf(xv[mt][h].w, yv.w, a);
                        }
                }
        }
        if (ch + 1 < nchunks) continue;

        // ---- epilogue: d2, threshold filter, queue, merge; two halves of 32 candidates
        const long long jt = j_begin + (u / nchunks) * kYT;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            float td[2][2];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h) td[mt][h] = thr_d[mt * 16 + h * 8 + g];
            // fast filter: d = (x2 + y2) - 2 xy in that order, as heat_tpu's _quadratic_expand
            // (2 xy is exact, so the fma rounds once, like the unfused subtract), before the
            // clamp; d <= the row's k-th distance admits a superset of what the list takes.
            // Rows of y past the segment have a NaN |y|^2, which admits nothing.
            bool maybe = false;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const float2 y2p = *reinterpret_cast<const float2*>(
                    y2s + static_cast<int>(u % kStages) * kYT + (half * 4 + q) * 8 + 2 * tq);
                const float y2v[2] = {y2p.x, y2p.y};
#pragma unroll
                for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const float d = fmaf(-2.f, acc[mt][half * 4 + q][e], __fadd_rn(x2r[mt][e >> 1], y2v[e & 1]));
                        acc[mt][half * 4 + q][e] = d;
                        maybe |= d <= td[mt][e >> 1];
                    }
            }
            if (!__any_sync(0xffffffffu, maybe)) continue;
            // exact test of the warp's candidates: clamp at 0 (a NaN stays NaN), then (d, idx) below
            // the row's k-th entry
            unsigned bits[2][2];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int ti = thr_i[mt * 16 + h * 8 + g];
                    bits[mt][h] = 0u;
#pragma unroll
                    for (int q = 0; q < 4; ++q)
#pragma unroll
                        for (int b = 0; b < 2; ++b) {
                            float& d = acc[mt][half * 4 + q][h * 2 + b];
                            d = d < 0.f ? 0.f : d;
                            const long long j = jt + (half * 4 + q) * 8 + 2 * tq + b;
                            if (j < j_end && lex_less(d, static_cast<int>(j), td[mt][h], ti))
                                bits[mt][h] |= 1u << (q * 2 + b);
                        }
                }
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    // slots of the 4 lanes that share row r: an exclusive prefix sum over the quad
                    const int cnt = __popc(bits[mt][h]);
                    int incl = cnt;
                    int v = __shfl_up_sync(0xffffffffu, incl, 1, 4);
                    if (tq >= 1) incl += v;
                    v = __shfl_up_sync(0xffffffffu, incl, 2, 4);
                    if (tq >= 2) incl += v;
                    const int total = __shfl_sync(0xffffffffu, incl, 3, 4);
                    const int r = mt * 16 + h * 8 + g;
                    int pos = incl - cnt;
#pragma unroll
                    for (int q = 0; q < 4; ++q)
#pragma unroll
                        for (int b = 0; b < 2; ++b)
                            if (bits[mt][h] >> (q * 2 + b) & 1u) {
                                q_d[pos * 32 + r] = acc[mt][half * 4 + q][h * 2 + b];
                                q_i[pos * 32 + r] = static_cast<int>(jt + (half * 4 + q) * 8 + 2 * tq + b);
                                ++pos;
                            }
                    if (tq == 0) qcnt[r] = total;
                }
            __syncwarp();
            // the owning lane merges its row's queue into its sorted list
            const int cnt = qcnt[lane];
            for (int e = 0; e < cnt; ++e) {
                const float d = q_d[e * 32 + lane];
                const int j = q_i[e * 32 + lane];
                if (!lex_less(d, j, lst_d[(k - 1) * lstride], lst_i[(k - 1) * lstride])) continue;
                int p = olen < k - 1 ? olen : k - 1;
                while (p > 0) {
                    const float pd = lst_d[(p - 1) * lstride];
                    const int pi = lst_i[(p - 1) * lstride];
                    if (!lex_less(d, j, pd, pi)) break;
                    lst_d[p * lstride] = pd;
                    lst_i[p * lstride] = pi;
                    --p;
                }
                lst_d[p * lstride] = d;
                lst_i[p * lstride] = j;
                if (olen < k) ++olen;
            }
            if (cnt > 0) {
                thr_d[lane] = lst_d[(k - 1) * lstride];
                thr_i[lane] = lst_i[(k - 1) * lstride];
                qcnt[lane] = 0;
            }
            __syncwarp();
        }
    }
    cp_async_wait<0>();
    if (!kGlobalList && olive) {
        const long long o = (seg * n + orow) * k;
        for (int p = 0; p < k; ++p) {
            part_d[o + p] = lst_d[p * lstride];
            part_i[o + p] = lst_i[p * lstride];
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

using PartialFn = void (*)(const float*, const float*, const float*, int, long long, int, int, long long, float*,
                           int*);

// the variants: 16-byte copies when f % 4 == 0, lists in the scratch when k > kMaxSmemK
const PartialFn kPartial[4] = {knn_partial<false, false>, knn_partial<false, true>, knn_partial<true, false>,
                               knn_partial<true, true>};

int partial_variant(int f, int k) { return (f % 4 == 0 ? 2 : 0) + (k > kMaxSmemK ? 1 : 0); }

// the variant's shared-memory limit, raised once per process and card
cudaError_t prepare(int v, int device) {
    static bool done[4][kMaxDevices];
    const bool known = device >= 0 && device < kMaxDevices;
    if (known && done[v][device]) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kPartial[v]),
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess && known) done[v][device] = true;
    return err;
}

}  // namespace

// Blocks of knn_partial that fit one SM at once for these f and k on card
// `device`, or a negative CUDA error code.
extern "C" int topk_blocks_per_sm(int f, int k, int device) {
    if (f < 1 || k < 1) return -static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return -static_cast<int>(err);
    const int v = partial_variant(f, k);
    err = prepare(v, device);
    if (err != cudaSuccess) return -static_cast<int>(err);
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, reinterpret_cast<const void*>(kPartial[v]), kThreads,
                                                        partial_smem(k));
    return err == cudaSuccess ? per_sm : -static_cast<int>(err);
}

// x: (n, f) and y: (m, f) float32 row-major on the card. Scratch: norms
// (n + m) float32, part_d (nseg, n, k) float32 and part_i (nseg, n, k)
// int32, where segment s covers y rows [s seg_len, (s + 1) seg_len).
// Outputs: out_d (n, k) float32 ascending, out_i (n, k) int32. Launches on
// card `device`, on `stream`; returns cudaGetLastError() (0 on success),
// or cudaErrorInvalidValue for arguments outside the limits above.
extern "C" int topk_distance(const void* x, const void* y, int n, long long m, int f, int k, int nseg,
                             long long seg_len, void* norms, void* part_d, void* part_i, void* out_d, void* out_i,
                             int device, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n < 1 || m < 1 || m > kIntMax || f < 1 || k < 1 || k > m || nseg < 1 || nseg > kMaxSeg || seg_len < 1 ||
        seg_len % kYT != 0 || static_cast<long long>(nseg) * seg_len < m)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int v = partial_variant(f, k);
    err = prepare(v, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const float* xp = static_cast<const float*>(x);
    const float* yp = static_cast<const float*>(y);
    float* np = static_cast<float*>(norms);
    const long long rows = n + m;
    row_norms<<<static_cast<unsigned>((rows + kNormThreads - 1) / kNormThreads), kNormThreads, 0, s>>>(xp, n, yp, m,
                                                                                                       f, np);
    const dim3 grid((n + kThreads - 1) / kThreads, nseg);
    float* pd = static_cast<float*>(part_d);
    int* pi = static_cast<int*>(part_i);
    void* args[] = {&xp, &yp, &np, &n, &m, &f, &k, &seg_len, &pd, &pi};
    err = cudaLaunchKernel(reinterpret_cast<const void*>(kPartial[v]), grid, dim3(kThreads), args,
                           static_cast<size_t>(partial_smem(k)), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    knn_merge<<<(n + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0, s>>>(
        pd, pi, n, k, nseg, static_cast<float*>(out_d),
        static_cast<int*>(out_i));
    return static_cast<int>(cudaGetLastError());
}
