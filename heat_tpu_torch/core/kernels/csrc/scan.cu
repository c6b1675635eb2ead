// scan_axis: the inclusive add or mul scan along one axis of a contiguous
// tensor, viewed as (outer, n, inner), for cumsum/cumprod.
//
// Replaces no Pallas kernel. heat_tpu computes cumsum/cumprod as one
// jnp.cumsum/jnp.cumprod inside XLA (heat_tpu/core/_operations.py:644,
// _cum_op). torch's own scan along any axis but the innermost gives one
// thread a whole column (ATen's tensor_kernel_scan_outer_dim), which at
// (2^24, 32) along axis 0 is one block of 32 threads walking 2^24 dependent
// steps.
//
// Bound on an H100: bytes. The function reads the input once and writes the
// output once (1.2821 ms at 2^24 x 32 float32); this design reads it twice.
//
// Design: reduce-then-scan, deterministic. The axis is cut into T tiles of
// R rows; a block owns one tile of one outer index and up to 32 lane groups
// of the inner columns (a lane group is VEC adjacent columns moved as one
// 16-byte load, or 1 column). Its 256 threads are lx lane groups x
// sy = 256 / lx segments; a step of the tile is sy * K rows, thread
// (segment s, lane group l) holding the K rows s*K .. s*K+K-1 of the step in
// registers (with inner == 1 those K rows are adjacent elements, moved as
// one pack).
//
// * Pass 1 (sc_totals): each thread folds its rows of the tile, then the
//   block folds its segments (a warp-shuffle tree, then the 8 warps in
//   order) into the tile's total.
// * Pass 2 (sc_scan, exclusive, on the (outer, T, inner) totals): the same
//   scan kernel as pass 3, one tile holding every total: each tile's
//   exclusive prefix, starting from a carry (the fold of earlier ranks'
//   totals, for a split axis) or the identity.
// * Pass 3 (sc_scan): each step scans its K rows in registers, scans the
//   segments across the warp (shuffles) and the warps (shared memory), and
//   writes carry + tile prefix + warps before + segments before + its rows;
//   the step's total is added to the running carry.
//
// Every fold has a fixed order that depends only on the shape (no atomics,
// no look-back whose order depends on which block published first), so one
// input gives the same bits on every run. A decoupled look-back would read
// the input once, but its fold order depends on timing; reduce-then-scan
// pays one more read for that. When T == 1 pass 1 and pass 2 are skipped.
// The totals step is exposed: a split-axis scan folds the ranks' totals
// between pass 1 and pass 2 and feeds the rank's exclusive prefix in as the
// carry, so no pass over the result combines it afterwards.
//
// sc_rows: rows of the innermost axis shorter than the block's step (inner
// == 1, small n, many rows): one thread scans a whole row, the block's rows
// staged through shared memory so that every load and store is coalesced.
//
// Types: float32, float64, int32, int64 accumulate in their own type
// (integers wrap, in unsigned arithmetic); bool is read as bytes and
// accumulates in int64. Float sums and products round every step on its own
// (__fadd_rn and its kin: never contracted).
#include <cuda_runtime.h>
#include <stdint.h>

#define SC_THREADS 256
#define SC_WARPS (SC_THREADS / 32)
#define SC_K 4            // rows a thread holds a step
#define SC_MAX_LANES 128  // lane groups x VEC a block: 32 x 4

enum ScOp { SC_ADD = 0, SC_MUL = 1 };
enum ScDtype { SC_F32 = 0, SC_F64 = 1, SC_I32 = 2, SC_I64 = 3, SC_BOOL = 4 };
enum ScMode { SC_COL1 = 0, SC_COLV = 1, SC_ROWPACK = 2 };
enum ScStage { SC_TOTALS = 0, SC_SCAN = 1, SC_EXCL = 2, SC_ROW_TOTALS = 3, SC_ROW_SCAN = 4 };

struct ScGeom {
    long long outer, n, inner;  // the (outer, n, inner) view of the input, in elements
    long long rows;             // R: rows of a tile, a multiple of sy * SC_K
    long long tiles;            // T = ceil(n / R)
    int lx;                     // lane groups a block (a power of two, 1..32); sy = SC_THREADS / lx segments
    int groups;                 // lane groups of a row: inner / VEC
    int chunks;                 // ceil(groups / lx)
    int pad;
};

// combine and identity; integers wrap
template <typename T, int OP>
struct Comb;
template <int OP>
struct Comb<float, OP> {
    static __device__ __forceinline__ float f(float a, float b) { return OP == SC_ADD ? __fadd_rn(a, b) : __fmul_rn(a, b); }
    static __device__ __forceinline__ float id() { return OP == SC_ADD ? 0.0f : 1.0f; }
};
template <int OP>
struct Comb<double, OP> {
    static __device__ __forceinline__ double f(double a, double b) { return OP == SC_ADD ? __dadd_rn(a, b) : __dmul_rn(a, b); }
    static __device__ __forceinline__ double id() { return OP == SC_ADD ? 0.0 : 1.0; }
};
template <int OP>
struct Comb<int, OP> {
    static __device__ __forceinline__ int f(int a, int b) {
        const unsigned ua = static_cast<unsigned>(a), ub = static_cast<unsigned>(b);
        return static_cast<int>(OP == SC_ADD ? ua + ub : ua * ub);
    }
    static __device__ __forceinline__ int id() { return OP == SC_ADD ? 0 : 1; }
};
template <int OP>
struct Comb<long long, OP> {
    static __device__ __forceinline__ long long f(long long a, long long b) {
        const unsigned long long ua = static_cast<unsigned long long>(a), ub = static_cast<unsigned long long>(b);
        return static_cast<long long>(OP == SC_ADD ? ua + ub : ua * ub);
    }
    static __device__ __forceinline__ long long id() { return OP == SC_ADD ? 0LL : 1LL; }
};

template <typename Tacc, typename Tin>
__device__ __forceinline__ Tacc sc_cvt(Tin v) { return static_cast<Tacc>(v); }
template <>
__device__ __forceinline__ long long sc_cvt<long long, unsigned char>(unsigned char v) { return v ? 1LL : 0LL; }

template <typename T, int N>
struct alignas(sizeof(T) * N) ScPack {
    T v[N];
};

// N adjacent elements at p, moved in packs of at most 16 bytes (p aligned to a pack)
template <typename T, int N>
__device__ __forceinline__ void sc_load_n(const T* p, T (&v)[N]) {
    constexpr int P = (16 / static_cast<int>(sizeof(T))) < N ? (16 / static_cast<int>(sizeof(T))) : N;
#pragma unroll
    for (int i = 0; i < N; i += P) {
        const ScPack<T, P> q = *reinterpret_cast<const ScPack<T, P>*>(p + i);
#pragma unroll
        for (int j = 0; j < P; ++j) v[i + j] = q.v[j];
    }
}

template <typename T, int N>
__device__ __forceinline__ void sc_store_n(T* p, const T (&v)[N]) {
    constexpr int P = (16 / static_cast<int>(sizeof(T))) < N ? (16 / static_cast<int>(sizeof(T))) : N;
#pragma unroll
    for (int i = 0; i < N; i += P) {
        ScPack<T, P> q;
#pragma unroll
        for (int j = 0; j < P; ++j) q.v[j] = v[i + j];
        *reinterpret_cast<ScPack<T, P>*>(p + i) = q;
    }
}

// the block's place: tile, lane chunk and outer index of blockIdx.x; the thread's lane group and segment
struct ScPlace {
    long long tile, o, c0, j0, j_end;
    int lxi, seg, lane, warp;
    bool live;
};

template <int VEC>
__device__ __forceinline__ ScPlace sc_place(const ScGeom& g) {
    ScPlace p;
    const long long b = blockIdx.x;
    p.tile = b % g.tiles;
    const long long rest = b / g.tiles;
    const int chunk = static_cast<int>(rest % g.chunks);
    p.o = rest / g.chunks;
    const int tid = threadIdx.x;
    p.lxi = tid & (g.lx - 1);
    p.seg = tid / g.lx;
    p.lane = tid & 31;
    p.warp = tid >> 5;
    const int gi = chunk * g.lx + p.lxi;
    p.live = gi < g.groups;
    p.c0 = static_cast<long long>(gi) * VEC;
    p.j0 = p.tile * g.rows;
    p.j_end = p.j0 + g.rows < g.n ? p.j0 + g.rows : g.n;
    return p;
}

// the K rows jf .. jf+K-1 of the thread's lane group (the identity past j_end or off the row)
template <typename Tin, typename Tacc, int MODE, int VEC>
__device__ __forceinline__ void sc_load(const Tin* __restrict__ in, const ScGeom& g, const ScPlace& p, long long jf,
                                        Tacc idv, Tacc (&vals)[SC_K][VEC]) {
    if (MODE == SC_ROWPACK) {  // inner == 1: K adjacent elements
        const long long off = p.o * g.n + jf;
        if (p.live && jf + SC_K <= p.j_end) {
            Tin t[SC_K];
            sc_load_n<Tin, SC_K>(in + off, t);
#pragma unroll
            for (int k = 0; k < SC_K; ++k) vals[k][0] = sc_cvt<Tacc>(t[k]);
        } else {
#pragma unroll
            for (int k = 0; k < SC_K; ++k) vals[k][0] = (p.live && jf + k < p.j_end) ? sc_cvt<Tacc>(in[off + k]) : idv;
        }
        return;
    }
#pragma unroll
    for (int k = 0; k < SC_K; ++k) {
        const long long j = jf + k;
        if (p.live && j < p.j_end) {
            Tin t[VEC];
            sc_load_n<Tin, VEC>(in + ((p.o * g.n + j) * g.inner + p.c0), t);
#pragma unroll
            for (int v = 0; v < VEC; ++v) vals[k][v] = sc_cvt<Tacc>(t[v]);
        } else {
#pragma unroll
            for (int v = 0; v < VEC; ++v) vals[k][v] = idv;
        }
    }
}

template <typename Tacc, int MODE, int VEC>
__device__ __forceinline__ void sc_store(Tacc* __restrict__ out, const ScGeom& g, const ScPlace& p, long long jf,
                                         const Tacc (&res)[SC_K][VEC]) {
    if (!p.live) return;
    if (MODE == SC_ROWPACK) {
        const long long off = p.o * g.n + jf;
        if (jf + SC_K <= p.j_end) {
            Tacc t[SC_K];
#pragma unroll
            for (int k = 0; k < SC_K; ++k) t[k] = res[k][0];
            sc_store_n<Tacc, SC_K>(out + off, t);
        } else {
#pragma unroll
            for (int k = 0; k < SC_K; ++k)
                if (jf + k < p.j_end) out[off + k] = res[k][0];
        }
        return;
    }
#pragma unroll
    for (int k = 0; k < SC_K; ++k) {
        const long long j = jf + k;
        if (j < p.j_end) sc_store_n<Tacc, VEC>(out + ((p.o * g.n + j) * g.inner + p.c0), res[k]);
    }
}

// Pass 1: the tile's total of each column, to totals (outer, T, inner)
template <typename Tin, typename Tacc, int OP, int MODE, int VEC>
__global__ void __launch_bounds__(SC_THREADS) sc_totals(const Tin* __restrict__ in, Tacc* __restrict__ totals,
                                                        const ScGeom g) {
    using C = Comb<Tacc, OP>;
    __shared__ Tacc wt[SC_WARPS][SC_MAX_LANES];
    const Tacc idv = C::id();
    const ScPlace p = sc_place<VEC>(g);
    const long long step = static_cast<long long>(SC_THREADS / g.lx) * SC_K;
    Tacc acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = idv;
    for (long long base = p.j0; base < p.j_end; base += step) {
        Tacc vals[SC_K][VEC];
        sc_load<Tin, Tacc, MODE, VEC>(in, g, p, base + static_cast<long long>(p.seg) * SC_K, idv, vals);
#pragma unroll
        for (int k = 0; k < SC_K; ++k)
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[v] = C::f(acc[v], vals[k][v]);
    }
    // the warp's segments: a fixed shuffle tree onto its first segment
    for (int off = 16; off >= g.lx; off >>= 1) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
            const Tacc t = __shfl_down_sync(0xffffffffu, acc[v], off);
            acc[v] = C::f(acc[v], t);
        }
    }
    if (p.lane < g.lx) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) wt[p.warp][p.lxi * VEC + v] = acc[v];
    }
    __syncthreads();
    if (threadIdx.x < g.lx && p.live) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
            Tacc t = idv;
            for (int w = 0; w < SC_WARPS; ++w) t = C::f(t, wt[w][p.lxi * VEC + v]);
            totals[(p.o * g.tiles + p.tile) * g.inner + p.c0 + v] = t;
        }
    }
}

// Pass 3 (and, EXCL, pass 2): the tile's scan from its prefix (prefix (outer, T, inner), or the identity)
template <typename Tin, typename Tacc, int OP, int MODE, int VEC, bool EXCL>
__global__ void __launch_bounds__(SC_THREADS) sc_scan(const Tin* __restrict__ in, Tacc* __restrict__ out,
                                                      const Tacc* __restrict__ prefix, const ScGeom g) {
    using C = Comb<Tacc, OP>;
    __shared__ Tacc wt[2][SC_WARPS][SC_MAX_LANES];
    const Tacc idv = C::id();
    const ScPlace p = sc_place<VEC>(g);
    const int sy = SC_THREADS / g.lx;
    const long long step = static_cast<long long>(sy) * SC_K;
    Tacc running[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v)
        running[v] = (prefix != nullptr && p.live) ? prefix[(p.o * g.tiles + p.tile) * g.inner + p.c0 + v] : idv;
    int buf = 0;
    for (long long base = p.j0; base < p.j_end; base += step) {
        const long long jf = base + static_cast<long long>(p.seg) * SC_K;
        Tacc vals[SC_K][VEC];
        sc_load<Tin, Tacc, MODE, VEC>(in, g, p, jf, idv, vals);
        // the K rows, in order
#pragma unroll
        for (int k = 1; k < SC_K; ++k)
#pragma unroll
            for (int v = 0; v < VEC; ++v) vals[k][v] = C::f(vals[k - 1][v], vals[k][v]);
        // the warp's segments (lanes lx apart): inclusive, then exclusive by one more shuffle
        Tacc inc[VEC], exc[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) inc[v] = vals[SC_K - 1][v];
        for (int off = g.lx; off < 32; off <<= 1) {
#pragma unroll
            for (int v = 0; v < VEC; ++v) {
                const Tacc t = __shfl_up_sync(0xffffffffu, inc[v], off);
                if (p.lane >= off) inc[v] = C::f(t, inc[v]);
            }
        }
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
            const Tacc t = __shfl_up_sync(0xffffffffu, inc[v], g.lx & 31);
            exc[v] = (g.lx < 32 && p.lane >= g.lx) ? t : idv;
        }
        if (p.lane >= 32 - g.lx) {
#pragma unroll
            for (int v = 0; v < VEC; ++v) wt[buf][p.warp][p.lxi * VEC + v] = inc[v];
        }
        __syncthreads();
        // the warps before this one, and all of them, folded in order
        Tacc before[VEC], total[VEC], pre[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) before[v] = total[v] = idv;
        for (int w = 0; w < SC_WARPS; ++w) {
            if (w == p.warp) {
#pragma unroll
                for (int v = 0; v < VEC; ++v) before[v] = total[v];
            }
#pragma unroll
            for (int v = 0; v < VEC; ++v) total[v] = C::f(total[v], wt[buf][w][p.lxi * VEC + v]);
        }
#pragma unroll
        for (int v = 0; v < VEC; ++v) pre[v] = C::f(C::f(running[v], before[v]), exc[v]);
        Tacc res[SC_K][VEC];
#pragma unroll
        for (int k = 0; k < SC_K; ++k)
#pragma unroll
            for (int v = 0; v < VEC; ++v)
                res[k][v] = EXCL ? (k == 0 ? pre[v] : C::f(pre[v], vals[k - 1][v])) : C::f(pre[v], vals[k][v]);
        sc_store<Tacc, MODE, VEC>(out, g, p, jf, res);
#pragma unroll
        for (int v = 0; v < VEC; ++v) running[v] = C::f(running[v], total[v]);
        buf ^= 1;  // the next step writes the other buffer: one barrier a step
    }
}

// Short rows of the innermost axis: a thread scans (or folds, TOTAL) a whole row of n elements. A block's 256
// rows pass through shared memory in chunks of SC_ROW_COLS columns: the block loads a chunk with neighbouring
// threads on neighbouring elements (the rows of a chunk lie SC_ROW_COLS apart at most, so every load and store
// is coalesced), each thread scans its row of the chunk from shared memory (a padded stride: no bank
// conflicts), and the block stores the chunk back the same way.
template <typename Tin, typename Tacc, int OP, bool TOTAL>
__global__ void __launch_bounds__(SC_THREADS) sc_rows(const Tin* __restrict__ in, Tacc* __restrict__ out,
                                                      const Tacc* __restrict__ prefix, long long outer, long long n) {
    using C = Comb<Tacc, OP>;
    constexpr int CW = sizeof(Tacc) == 8 ? 16 : 32;  // columns a chunk: 32 KiB of shared memory either way
    constexpr int STRIDE = CW + 1;
    __shared__ Tacc tile[SC_THREADS * STRIDE];
    const long long o0 = static_cast<long long>(blockIdx.x) * SC_THREADS;
    const int rows = static_cast<int>(outer - o0 < SC_THREADS ? outer - o0 : SC_THREADS);
    const int tid = threadIdx.x;
    Tacc run = (!TOTAL && prefix != nullptr && tid < rows) ? prefix[o0 + tid] : C::id();
    for (long long c0 = 0; c0 < n; c0 += CW) {
        const int cw = static_cast<int>(n - c0 < CW ? n - c0 : CW);
        const int cells = rows * cw;
        for (int l = tid; l < cells; l += SC_THREADS) {
            const int r = cw == CW ? l / CW : l / cw;
            const int c = l - r * cw;
            tile[r * STRIDE + c] = sc_cvt<Tacc>(in[(o0 + r) * n + c0 + c]);
        }
        __syncthreads();
        if (tid < rows) {
            Tacc* row = tile + tid * STRIDE;
            for (int c = 0; c < cw; ++c) {
                run = C::f(run, row[c]);
                row[c] = run;
            }
        }
        __syncthreads();
        if (!TOTAL) {
            for (int l = tid; l < cells; l += SC_THREADS) {
                const int r = cw == CW ? l / CW : l / cw;
                const int c = l - r * cw;
                out[(o0 + r) * n + c0 + c] = tile[r * STRIDE + c];
            }
            __syncthreads();  // the next chunk's loads overwrite the tile
        }
    }
    if (TOTAL && tid < rows) out[o0 + tid] = run;
}

template <typename Tin, typename Tacc, int OP>
static void sc_dispatch(int stage, int mode, const void* in, void* out, const void* prefix, const ScGeom& g,
                        long long blocks, cudaStream_t s) {
    constexpr int W = sizeof(Tin) == 8 ? 2 : 4;  // columns a 16-byte (bool: 4-byte) load of the input holds
    const Tin* x = static_cast<const Tin*>(in);
    Tacc* y = static_cast<Tacc*>(out);
    const Tacc* pre = static_cast<const Tacc*>(prefix);
    const dim3 grid(static_cast<unsigned>(blocks));
    switch (stage) {
        case SC_TOTALS:
            if (mode == SC_COLV) sc_totals<Tin, Tacc, OP, SC_COLV, W><<<grid, SC_THREADS, 0, s>>>(x, y, g);
            else if (mode == SC_ROWPACK) sc_totals<Tin, Tacc, OP, SC_ROWPACK, 1><<<grid, SC_THREADS, 0, s>>>(x, y, g);
            else sc_totals<Tin, Tacc, OP, SC_COL1, 1><<<grid, SC_THREADS, 0, s>>>(x, y, g);
            break;
        case SC_SCAN:
            if (mode == SC_COLV) sc_scan<Tin, Tacc, OP, SC_COLV, W, false><<<grid, SC_THREADS, 0, s>>>(x, y, pre, g);
            else if (mode == SC_ROWPACK) sc_scan<Tin, Tacc, OP, SC_ROWPACK, 1, false><<<grid, SC_THREADS, 0, s>>>(x, y, pre, g);
            else sc_scan<Tin, Tacc, OP, SC_COL1, 1, false><<<grid, SC_THREADS, 0, s>>>(x, y, pre, g);
            break;
        case SC_EXCL:  // on the totals, whose type is Tacc
            sc_scan<Tacc, Tacc, OP, SC_COL1, 1, true><<<grid, SC_THREADS, 0, s>>>(static_cast<const Tacc*>(in), y, pre, g);
            break;
        case SC_ROW_TOTALS:
            sc_rows<Tin, Tacc, OP, true><<<grid, SC_THREADS, 0, s>>>(x, y, nullptr, g.outer, g.n);
            break;
        default:  // SC_ROW_SCAN
            sc_rows<Tin, Tacc, OP, false><<<grid, SC_THREADS, 0, s>>>(x, y, pre, g.outer, g.n);
            break;
    }
}

template <typename Tin, typename Tacc>
static void sc_dispatch_op(int op, int stage, int mode, const void* in, void* out, const void* prefix,
                           const ScGeom& g, long long blocks, cudaStream_t s) {
    if (op == SC_ADD) sc_dispatch<Tin, Tacc, SC_ADD>(stage, mode, in, out, prefix, g, blocks, s);
    else sc_dispatch<Tin, Tacc, SC_MUL>(stage, mode, in, out, prefix, g, blocks, s);
}

// One stage of a scan (ScStage) on the input type `dtype` (ScDtype; SC_EXCL takes the accumulation type):
// `in`, `out` and `prefix` (or null) as the stage reads them, the geometry, `blocks` the grid. Returns
// cudaGetLastError() (0 on success).
extern "C" int scan_axis_stage(int stage, int dtype, int op, int mode, const void* in, void* out, const void* prefix,
                               const ScGeom* geom, long long blocks, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (blocks <= 0 || blocks > 0x7fffffffLL || geom->lx < 1 || geom->lx > 32 || (geom->lx & (geom->lx - 1)) != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const ScGeom g = *geom;
    switch (dtype) {
        case SC_F32: sc_dispatch_op<float, float>(op, stage, mode, in, out, prefix, g, blocks, s); break;
        case SC_F64: sc_dispatch_op<double, double>(op, stage, mode, in, out, prefix, g, blocks, s); break;
        case SC_I32: sc_dispatch_op<int, int>(op, stage, mode, in, out, prefix, g, blocks, s); break;
        case SC_I64: sc_dispatch_op<long long, long long>(op, stage, mode, in, out, prefix, g, blocks, s); break;
        case SC_BOOL: sc_dispatch_op<unsigned char, long long>(op, stage, mode, in, out, prefix, g, blocks, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

// sizeof(ScGeom), for the binding's layout check
extern "C" long long scan_axis_geom_bytes() { return static_cast<long long>(sizeof(ScGeom)); }
