// lloyd_fused: one Lloyd assignment pass over a row-major (n, f) float32
// buffer against k centers: per-row int32 labels (argmin of
// d2 = max(|x|^2 + |c|^2 - 2 x.c, 0), ties to the lower index), and over
// the rows below n_valid the per-cluster sums (k, f), counts (k) and the
// inertia (sum of the minimum d2).
//
// Replaces heat_tpu/core/kernels/lloyd.py::_lloyd_kernel (the Pallas TPU
// kernel driven by _lloyd_call / lloyd_local); its contract is that of
// heat_tpu/cluster/kmeans.py::_assign_stats. Like the TPU kernel, it takes
// any f >= 1 and k >= 1, by one of two routes (lloyd_route in lloyd.py
// chooses, from the same shared-memory count as geometry() below):
//
// Bound on an H100: bytes. It reads x once (4 n f bytes) and writes 4 n
// bytes of labels; the 2 n k f flops of the distances take less time at
// the card's float32 rate for the k, f the resident route serves.
//
// The resident route (lloyd_fused), for shapes whose centers, row ring and
// private sums fit one block's 227 KB of shared memory:
//
// * One wave of blocks: the grid is the SM count times the blocks of this
//   kernel one SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
//   lloyd_blocks_per_sm). Each block owns a contiguous run of whole tiles
//   of kTile rows (a balanced share of all tiles).
// * Rows reach shared memory through a ring of kStages stages filled by
//   cp.async: tiles i + 1 .. i + kStages - 1 load while tile i is worked
//   on, two block barriers per tile. 16-byte cp.async.cg copies when f is a
//   multiple of 4 and x is 16-byte aligned, 4-byte copies otherwise. Rows
//   are staged with a stride of f + 4 floats when f % 4 == 0 (a row-per-
//   thread float4 read hits distinct banks: 4 (t + c) mod 32 at f = 32),
//   else an odd stride f | 1 with scalar reads.
// * The (k, f) centers live in shared memory, transposed and zero-padded
//   to a multiple of 8 centers, so each thread reads them as float4
//   broadcasts. No MXU padding: no 128-row centers, no 128-lane f.
// * Each thread computes one row's distances in float32 on the CUDA cores
//   (no TF32, no tensor cores), in 8-center register chunks, summing over
//   the columns in order, and the argmin. Per-cluster sums accumulate in G
//   private copies in shared memory, each (copy, cluster, column) owned by
//   exactly one thread and fed rows in a fixed order, so there are no
//   atomics; a thread reads the labels and values of 8 rows before it adds
//   them, so its chain of dependent shared-memory reads is one per row.
//   Counts are taken right after the argmin: the lanes of a warp with the
//   same label (__match_any_sync) elect one, which adds their number to its
//   warp's count in shared memory. Rows at or past n_valid are left out of
//   sums, counts and inertia; their labels are still written. The block writes partials (nblocks, k, f),
//   (nblocks, k) and (nblocks,).
//
// The general route (lloyd_general), for every other shape; simple, not
// fast: three kernels.
//
// * lloyd_assign: a block owns kAssignRows rows, one per thread. Centers
//   stream through shared memory in chunks of kKC centers x kFC columns,
//   the rows' columns beside them; each thread keeps its row's kKC partial
//   dots in registers across the column chunks, then updates its running
//   (best, label) in increasing center order with the strict <. The sums
//   over the columns run in the same order as on the resident route, so
//   both routes give the same labels. Writes labels and each row's
//   minimum d2.
// * lloyd_scatter: a block owns a contiguous range of the valid rows and a
//   (k, f) slice of the part_sums scratch in device memory; each thread
//   owns columns and walks the block's rows in order, adding x[row, c] to
//   part_sums[b, label[row], c]; thread 0 also counts and adds the minimum
//   d2 in float64. No atomics.
//
// Both routes end in lloyd_reduce, which adds the partials in a fixed
// order in float64. No float atomics anywhere: centroids are bit-identical
// from run to run.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef LLOYD_TILE
#define LLOYD_TILE 128
#endif
#ifndef LLOYD_STAGES
#define LLOYD_STAGES 3
#endif

namespace {

constexpr int kTile = LLOYD_TILE;  // rows per tile; also threads per block, one row each
constexpr int kThreads = kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = LLOYD_STAGES;
static_assert(kTile % 32 == 0 && kTile >= 32 && kTile <= 1024, "a tile is whole warps");
static_assert(kStages >= 2, "a ring needs two stages");
constexpr int kChunk = 8;          // centers per register chunk
constexpr int kBatch = 8;          // rows whose label and value are read ahead in the accumulation
constexpr int kMaxPriv = 8192;     // floats of private sum copies per block
constexpr long long kMaxSmem = 232448;
constexpr int kMaxDevices = 64;
constexpr int kAssignRows = 128;   // lloyd_assign: rows (and threads) per block
constexpr int kFC = 32;            // lloyd_assign: columns per staged chunk
constexpr int kKC = 32;            // lloyd_assign: centers per register chunk
constexpr int kScatterThreads = 256;
constexpr int kReduceThreads = 256;

struct Geometry {
    int kp, ld, G;
    long long smem;  // bytes of dynamic shared memory
    bool fits;       // the resident route takes this shape
};

// The resident route's layout; lloyd.py's resident_smem computes the same bytes.
Geometry geometry(int f, int k) {
    Geometry g;
    g.kp = (k + kChunk - 1) / kChunk * kChunk;
    g.ld = f % 4 == 0 ? f + 4 : (f | 1);
    const long long kf = static_cast<long long>(k) * f;
    const long long R = kThreads / f;
    const long long cap = kMaxPriv / kf;
    g.G = static_cast<int>(cap < R ? (cap < 1 ? 1 : cap) : (R < 1 ? 1 : R));
    g.smem = static_cast<long long>(sizeof(double)) * kThreads +
             static_cast<long long>(sizeof(float)) *
                 (static_cast<long long>(kStages) * kTile * g.ld + static_cast<long long>(f) * g.kp + g.kp +
                  g.G * kf) +
             static_cast<long long>(sizeof(int)) * (kTile + static_cast<long long>(kWarps) * k);
    g.fits = f <= kThreads && g.smem <= kMaxSmem;
    return g;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// A thread's walk over a tile's copies: copy q = t, t + kThreads, ... of
// `per_row` copies a row lands at (row, col) of the stage; the step is
// constant, so row and col advance without a division per copy.
struct CopyWalk {
    int r0, c0, dr, dc;
};

__device__ __forceinline__ CopyWalk copy_walk(int t, int per_row) {
    CopyWalk w;
    w.r0 = t / per_row;
    w.c0 = t - w.r0 * per_row;
    w.dr = kThreads / per_row;
    w.dc = kThreads - w.dr * per_row;
    return w;
}

// Start the cp.async copies of one tile of `rows` rows (contiguous in x
// from `src`) into the stage `dst` of row stride ld.
template <bool kCopy16>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int rows, int f, int ld,
                                          int t, const CopyWalk& w) {
    constexpr int kW = kCopy16 ? 4 : 1;  // floats per copy
    const int per_row = f / kW;
    const int copies = rows * per_row;
    int r = w.r0, c = w.c0;
    for (int q = t; q < copies; q += kThreads) {
        if (kCopy16)
            cp_async16(dst + r * ld + c * kW, src + static_cast<long long>(q) * kW);
        else
            cp_async4(dst + r * ld + c, src + q);
        r += w.dr;
        c += w.dc;
        if (c >= per_row) {
            c -= per_row;
            ++r;
        }
    }
}

template <bool kVec, bool kCopy16>
__global__ void __launch_bounds__(kThreads)
lloyd_partial(const float* __restrict__ x, const float* __restrict__ centers, long long n, long long n_valid,
              int f, int k, int kp, int ld, int G, long long ntiles, int* __restrict__ labels,
              float* __restrict__ part_sums, int* __restrict__ part_counts, double* __restrict__ part_inertia) {
    extern __shared__ double smem[];
    double* red = smem;
    float* ring = reinterpret_cast<float*>(red + kThreads);  // [kStages][kTile][ld]
    float* csT = ring + kStages * kTile * ld;
    float* c2 = csT + f * kp;
    float* priv = c2 + kp;
    int* lab = reinterpret_cast<int*>(priv + G * k * f);
    int* wcnt = lab + kTile;  // [kWarps][k]: each warp's counts

    const int t = threadIdx.x;
    const long long b = blockIdx.x, nb = gridDim.x;
    const long long tile0 = b * ntiles / nb, tile1 = (b + 1) * ntiles / nb;  // this block's run of tiles
    const CopyWalk walk = copy_walk(t, kCopy16 ? f / 4 : f);
    const int stage_floats = kTile * ld;
    auto tile_rows = [&](long long tile) {
        const long long left = n - tile * kTile;
        return static_cast<int>(left < kTile ? left : kTile);
    };

    // the first kStages - 1 tiles start loading before anything else
    for (int s = 0; s < kStages - 1; ++s) {
        const long long tile = tile0 + s;
        if (tile < tile1)
            load_tile<kCopy16>(ring + s * stage_floats, x + tile * kTile * f, tile_rows(tile), f, ld, t, walk);
        cp_async_commit();
    }

    for (int i = t; i < f * kp; i += kThreads) {
        const int c = i / kp, j = i - c * kp;
        csT[i] = j < k ? centers[j * f + c] : 0.f;
    }
    for (int i = t; i < G * k * f; i += kThreads) priv[i] = 0.f;
    for (int i = t; i < kWarps * k; i += kThreads) wcnt[i] = 0;
    __syncthreads();
    for (int j = t; j < kp; j += kThreads) {
        float s = 0.f;
        for (int c = 0; c < f; ++c) {
            const float v = csT[c * kp + j];
            s = fmaf(v, v, s);
        }
        c2[j] = s;
    }

    const int sg = t / f;       // accumulation group: private copy sg
    const int sc = t - sg * f;  // column
    double inertia = 0.0;
    int st = 0;                 // ring stage of the current tile
    int st_next = kStages - 1;  // ring stage of the tile kStages - 1 ahead

    for (long long tile = tile0; tile < tile1; ++tile) {
        const long long base = tile * kTile;
        const int rows = tile_rows(tile);
        const long long nv = n_valid - base;
        const int rows_valid = nv <= 0 ? 0 : (nv < rows ? static_cast<int>(nv) : rows);
        cp_async_wait<kStages - 2>();  // this thread's copies of this tile have landed
        __syncthreads();               // everyone's have; the last tile's stage and lab are free
        {
            const long long ahead = tile + kStages - 1;
            if (ahead < tile1)
                load_tile<kCopy16>(ring + st_next * stage_floats, x + ahead * kTile * f, tile_rows(ahead), f, ld,
                                   t, walk);
            cp_async_commit();  // one group per tile, empty past the end
        }
        const float* xs = ring + st * stage_floats;
        int bj = 0;
        if (t < rows) {
            const float* xr = xs + t * ld;
            float x2 = 0.f;
            if (kVec) {
                for (int c = 0; c < f; c += 4) {
                    const float4 v = *reinterpret_cast<const float4*>(xr + c);
                    x2 = fmaf(v.x, v.x, x2);
                    x2 = fmaf(v.y, v.y, x2);
                    x2 = fmaf(v.z, v.z, x2);
                    x2 = fmaf(v.w, v.w, x2);
                }
            } else {
                for (int c = 0; c < f; ++c) x2 = fmaf(xr[c], xr[c], x2);
            }
            float best = __int_as_float(0x7f800000);  // +inf
            for (int j0 = 0; j0 < kp; j0 += kChunk) {
                float acc[kChunk];
#pragma unroll
                for (int u = 0; u < kChunk; ++u) acc[u] = 0.f;
                auto column = [&](float xv, int c) {
                    const float4* cp = reinterpret_cast<const float4*>(csT + c * kp + j0);
                    const float4 a = cp[0], bb = cp[1];
                    acc[0] = fmaf(xv, a.x, acc[0]);
                    acc[1] = fmaf(xv, a.y, acc[1]);
                    acc[2] = fmaf(xv, a.z, acc[2]);
                    acc[3] = fmaf(xv, a.w, acc[3]);
                    acc[4] = fmaf(xv, bb.x, acc[4]);
                    acc[5] = fmaf(xv, bb.y, acc[5]);
                    acc[6] = fmaf(xv, bb.z, acc[6]);
                    acc[7] = fmaf(xv, bb.w, acc[7]);
                };
                if (kVec) {
                    for (int c = 0; c < f; c += 4) {
                        const float4 v = *reinterpret_cast<const float4*>(xr + c);
                        column(v.x, c);
                        column(v.y, c + 1);
                        column(v.z, c + 2);
                        column(v.w, c + 3);
                    }
                } else {
                    for (int c = 0; c < f; ++c) column(xr[c], c);
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
        {
            // counts: the lanes of a warp that share a label elect one, which adds them to
            // its warp's count (integers: the order cannot change the result)
            const bool counted = t < rows_valid;
            const unsigned same = __match_any_sync(0xffffffffu, counted ? bj : -1);
            if (counted && (t & 31) == __ffs(same) - 1) wcnt[(t >> 5) * k + bj] += __popc(same);
        }
        __syncthreads();
        if (sg < G) {
            // rows sg, sg + G, ... in order; the labels and values of kBatch rows are read
            // first, so only the read-add-write of the private sum waits on shared memory
            float* pg = priv + sg * k * f;
            for (int r0 = sg; r0 < rows_valid; r0 += kBatch * G) {
                int jj[kBatch];
                float vv[kBatch];
#pragma unroll
                for (int u = 0; u < kBatch; ++u) {
                    const int rr = r0 + u * G;
                    jj[u] = rr < rows_valid ? lab[rr] : -1;
                    vv[u] = rr < rows_valid ? xs[rr * ld + sc] : 0.f;
                }
#pragma unroll
                for (int u = 0; u < kBatch; ++u)
                    if (jj[u] >= 0) pg[jj[u] * f + sc] += vv[u];
            }
        }
        st = st + 1 == kStages ? 0 : st + 1;
        st_next = st_next + 1 == kStages ? 0 : st_next + 1;
    }
    cp_async_wait<0>();
    __syncthreads();

    const int kf = k * f;
    for (int i = t; i < kf; i += kThreads) {
        float s = 0.f;
        for (int gg = 0; gg < G; ++gg) s += priv[gg * kf + i];
        part_sums[b * kf + i] = s;
    }
    for (int j = t; j < k; j += kThreads) {
        int s = 0;
        for (int w = 0; w < kWarps; ++w) s += wcnt[w * k + j];
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

// General route, pass 1: labels and each row's minimum d2.
__global__ void __launch_bounds__(kAssignRows)
lloyd_assign(const float* __restrict__ x, const float* __restrict__ centers, long long n, int f, int k,
             int* __restrict__ labels, float* __restrict__ mind) {
    __shared__ float xs[kAssignRows][kFC + 1];  // odd stride: row-per-thread reads hit distinct banks
    __shared__ __align__(16) float cs[kFC][kKC];  // transposed center chunk: cs[c][u] = centers[j0 + u][c0 + c]
    __shared__ float c2s[kKC];
    const int t = threadIdx.x;
    const long long row0 = static_cast<long long>(blockIdx.x) * kAssignRows;
    const long long row = row0 + t;
    const int rows = static_cast<int>(n - row0 < kAssignRows ? n - row0 : kAssignRows);
    float x2 = 0.f;
    float best = __int_as_float(0x7f800000);  // +inf
    int bj = 0;
    for (int j0 = 0; j0 < k; j0 += kKC) {
        float acc[kKC];
#pragma unroll
        for (int u = 0; u < kKC; ++u) acc[u] = 0.f;
        float c2acc = 0.f;  // thread t < kKC: |center j0 + t|^2
        for (int c0 = 0; c0 < f; c0 += kFC) {
            const int fc = f - c0 < kFC ? f - c0 : kFC;
            for (int i = t; i < kAssignRows * kFC; i += kAssignRows) {
                const int r = i / kFC, c = i - r * kFC;
                xs[r][c] = r < rows && c < fc ? x[(row0 + r) * f + c0 + c] : 0.f;
            }
            for (int i = t; i < kKC * kFC; i += kAssignRows) {
                const int u = i / kFC, c = i - u * kFC;
                cs[c][u] = j0 + u < k && c < fc ? centers[static_cast<long long>(j0 + u) * f + c0 + c] : 0.f;
            }
            __syncthreads();
            if (t < kKC)
                for (int c = 0; c < fc; ++c) c2acc = fmaf(cs[c][t], cs[c][t], c2acc);
            for (int c = 0; c < fc; ++c) {
                const float xv = xs[t][c];
                if (j0 == 0) x2 = fmaf(xv, xv, x2);
                const float4* cp = reinterpret_cast<const float4*>(cs[c]);
#pragma unroll
                for (int q = 0; q < kKC / 4; ++q) {
                    const float4 a = cp[q];
                    acc[4 * q] = fmaf(xv, a.x, acc[4 * q]);
                    acc[4 * q + 1] = fmaf(xv, a.y, acc[4 * q + 1]);
                    acc[4 * q + 2] = fmaf(xv, a.z, acc[4 * q + 2]);
                    acc[4 * q + 3] = fmaf(xv, a.w, acc[4 * q + 3]);
                }
            }
            __syncthreads();
        }
        if (t < kKC) c2s[t] = c2acc;
        __syncthreads();
#pragma unroll
        for (int u = 0; u < kKC; ++u) {
            if (j0 + u < k) {
                // (x2 + c2) - 2 xc in that order, unfused, as on the resident route
                float d = __fsub_rn(__fadd_rn(x2, c2s[u]), __fmul_rn(2.f, acc[u]));
                d = fmaxf(d, 0.f);
                if (d < best) {  // strict, centers in increasing order: ties keep the lower index
                    best = d;
                    bj = j0 + u;
                }
            }
        }
    }
    if (row < n) {
        labels[row] = bj;
        mind[row] = best;
    }
}

// General route, pass 2: block b adds the valid rows [b nv / nb, (b + 1) nv / nb)
// into its (k, f) slice of part_sums, its k counts and its inertia.
__global__ void __launch_bounds__(kScatterThreads)
lloyd_scatter(const float* __restrict__ x, const int* __restrict__ labels, const float* __restrict__ mind,
              long long n_valid, int f, int k, float* __restrict__ part_sums, int* __restrict__ part_counts,
              double* __restrict__ part_inertia) {
    const int t = threadIdx.x;
    const long long b = blockIdx.x, nb = gridDim.x;
    const long long r0 = b * n_valid / nb, r1 = (b + 1) * n_valid / nb;
    const long long kf = static_cast<long long>(k) * f;
    float* ps = part_sums + b * kf;
    int* pc = part_counts + b * k;
    for (int c = t; c < f; c += kScatterThreads)  // each thread zeroes the entries it owns
        for (int j = 0; j < k; ++j) ps[static_cast<long long>(j) * f + c] = 0.f;
    if (t == 0)
        for (int j = 0; j < k; ++j) pc[j] = 0;
    double inertia = 0.0;
    for (long long r = r0; r < r1; ++r) {
        const int j = labels[r];
        const float* xr = x + r * f;
        float* pj = ps + static_cast<long long>(j) * f;
        for (int c = t; c < f; c += kScatterThreads) pj[c] += xr[c];
        if (t == 0) {
            pc[j] += 1;
            inertia += static_cast<double>(mind[r]);
        }
    }
    if (t == 0) part_inertia[b] = inertia;
}

// Output i < k f: sums; k f <= i < k f + k: counts; i == k f + k: inertia.
// Lane = output, warp w adds blocks w, w + 8, ...; the 8 warp sums are then
// added in warp order.
__global__ void __launch_bounds__(kReduceThreads)
lloyd_reduce(const float* __restrict__ part_sums, const int* __restrict__ part_counts,
             const double* __restrict__ part_inertia, int nblocks, int k, int f,
             float* __restrict__ sums, float* __restrict__ counts, float* __restrict__ inertia) {
    __shared__ double red[kReduceThreads / 32][32];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const long long kf = static_cast<long long>(k) * f;
    const long long i = static_cast<long long>(blockIdx.x) * 32 + lane;
    const long long total = kf + k + 1;
    double s = 0.0;
    if (i < total) {
        for (int b = w; b < nblocks; b += kReduceThreads / 32) {
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
        for (int ww = 0; ww < kReduceThreads / 32; ++ww) a += red[ww][lane];
        if (i < kf)
            sums[i] = static_cast<float>(a);
        else if (i < kf + k)
            counts[i - kf] = static_cast<float>(a);
        else
            inertia[0] = static_cast<float>(a);
    }
}

using PartialFn = void (*)(const float*, const float*, long long, long long, int, int, int, int, int, long long,
                           int*, float*, int*, double*);
// variants: 0 float4 rows + 16-byte copies, 1 float4 rows + 4-byte copies, 2 scalar rows + 4-byte copies
const PartialFn kPartial[3] = {lloyd_partial<true, true>, lloyd_partial<true, false>, lloyd_partial<false, false>};

int partial_variant(int f, bool aligned16) { return f % 4 != 0 ? 2 : (aligned16 ? 0 : 1); }

// Raise the variant's dynamic shared-memory limit to the card's most, once
// per card and variant.
cudaError_t prepare(int v, int device) {
    static bool done[3][kMaxDevices];
    const bool known = device >= 0 && device < kMaxDevices;
    if (known && done[v][device]) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kPartial[v]),
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(kMaxSmem));
    if (err == cudaSuccess && known) done[v][device] = true;
    return err;
}

cudaError_t launch_reduce(const void* part_sums, const void* part_counts, const void* part_inertia, int nblocks,
                          int k, int f, void* sums, void* counts, void* inertia, cudaStream_t s) {
    const long long total = static_cast<long long>(k) * f + k + 1;
    lloyd_reduce<<<static_cast<unsigned>((total + 31) / 32), kReduceThreads, 0, s>>>(
        static_cast<const float*>(part_sums), static_cast<const int*>(part_counts),
        static_cast<const double*>(part_inertia), nblocks, k, f, static_cast<float*>(sums),
        static_cast<float*>(counts), static_cast<float*>(inertia));
    return cudaGetLastError();
}

}  // namespace

// Bytes of shared memory the resident route needs for these f and k, or
// -1 when it does not take them (f above the tile's threads, or more than
// the card's 227 KB).
extern "C" long long lloyd_resident_smem(int f, int k) {
    if (f < 1 || k < 1) return -1;
    const Geometry g = geometry(f, k);
    return g.fits ? g.smem : -1;
}

// Rows per tile and ring stages of the resident route, as built.
extern "C" int lloyd_tile() { return kTile; }
extern "C" int lloyd_stages() { return kStages; }

// Blocks of the resident route's kernel that fit one SM at once for these
// f, k and alignment on card `device`, or a negative CUDA error code.
extern "C" int lloyd_blocks_per_sm(int f, int k, int aligned16, int device) {
    if (f < 1 || k < 1) return -static_cast<int>(cudaErrorInvalidValue);
    const Geometry g = geometry(f, k);
    if (!g.fits) return -static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return -static_cast<int>(err);
    const int v = partial_variant(f, aligned16 != 0);
    err = prepare(v, device);
    if (err != cudaSuccess) return -static_cast<int>(err);
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, reinterpret_cast<const void*>(kPartial[v]),
                                                        kThreads, static_cast<size_t>(g.smem));
    return err == cudaSuccess ? per_sm : -static_cast<int>(err);
}

// The resident route. x: (n, f) and centers: (k, f) float32 row-major on
// the card. Scratch: part_sums (nblocks, k, f) float32, part_counts
// (nblocks, k) int32, part_inertia (nblocks,) float64. Outputs: labels (n,)
// int32, sums (k, f), counts (k,), inertia (1,) float32. Launches on card
// `device`, on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a shape this route does not take.
extern "C" int lloyd_fused(const void* x, const void* centers, long long n, int f, int k,
                           long long n_valid, int nblocks, void* labels, void* part_sums,
                           void* part_counts, void* part_inertia, void* sums, void* counts,
                           void* inertia, int device, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n < 1 || f < 1 || k < 1 || nblocks < 1) return static_cast<int>(cudaErrorInvalidValue);
    const Geometry g = geometry(f, k);
    if (!g.fits) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int v = partial_variant(f, reinterpret_cast<uintptr_t>(x) % 16 == 0);
    err = prepare(v, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    long long nv = n_valid < 0 ? 0 : (n_valid < n ? n_valid : n);
    long long ntiles = (n + kTile - 1) / kTile;
    const float* xp = static_cast<const float*>(x);
    const float* cp = static_cast<const float*>(centers);
    int* lp = static_cast<int*>(labels);
    float* ps = static_cast<float*>(part_sums);
    int* pc = static_cast<int*>(part_counts);
    double* pi = static_cast<double*>(part_inertia);
    int kp = g.kp, ld = g.ld, G = g.G;
    void* args[] = {&xp, &cp, &n, &nv, &f, &k, &kp, &ld, &G, &ntiles, &lp, &ps, &pc, &pi};
    err = cudaLaunchKernel(reinterpret_cast<const void*>(kPartial[v]), dim3(nblocks), dim3(kThreads), args,
                           static_cast<size_t>(g.smem), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(launch_reduce(part_sums, part_counts, part_inertia, nblocks, k, f, sums, counts,
                                          inertia, s));
}

// The general route, for any f >= 1 and k >= 1. As lloyd_fused, with one
// more scratch: mind (n,) float32, each row's minimum d2; nblocks is the
// number of lloyd_scatter blocks (each with its own (k, f) slice).
extern "C" int lloyd_general(const void* x, const void* centers, long long n, int f, int k,
                             long long n_valid, int nblocks, void* labels, void* mind, void* part_sums,
                             void* part_counts, void* part_inertia, void* sums, void* counts, void* inertia,
                             int device, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n < 1 || f < 1 || k < 1 || nblocks < 1) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long nv = n_valid < 0 ? 0 : (n_valid < n ? n_valid : n);
    lloyd_assign<<<static_cast<unsigned>((n + kAssignRows - 1) / kAssignRows), kAssignRows, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(centers), n, f, k, static_cast<int*>(labels),
        static_cast<float*>(mind));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    lloyd_scatter<<<nblocks, kScatterThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int*>(labels), static_cast<const float*>(mind), nv, f, k,
        static_cast<float*>(part_sums), static_cast<int*>(part_counts), static_cast<double*>(part_inertia));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(launch_reduce(part_sums, part_counts, part_inertia, nblocks, k, f, sums, counts,
                                          inertia, s));
}
