// lazy_fused: one kernel that runs every fused elementwise segment of the
// lazy layer (heat_tpu_torch/core/lazy/evaluate.py) by interpreting the
// segment's plan. One build serves every chain: nothing is compiled per
// signature.
//
// Replaces no Pallas kernel. heat_tpu runs a captured chain as one fused
// XLA program (heat_tpu/core/lazy/evaluate.py:_build_program); in torch
// eager each op of the chain is a pass over memory. Here a segment is one
// pass. Bound on an H100: bytes (each input read once, each output written
// once; a summed output writes only its partials).
//
// Design for Hopper:
// - The plan is the kernel's __grid_constant__ parameter. The loops over
//   inputs (LF_MAX_IN), instructions (LF_MAX_INSTR) and outputs
//   (LF_MAX_OUT) are unrolled, each ending at a uniform `if (k >= n) break`,
//   so every field the interpreter reads is a constant-bank operand: no
//   runtime-indexed parameter load, no stack frame.
// - A block of T threads works on tiles of TILE = T x V consecutive
//   elements (64 x 16 on a float register file, 128 x 4 on a double one).
//   Element v * T + t of a tile belongs to thread t in every slot, so a
//   thread reads and writes only its own column (no bank conflicts, no
//   barrier between instructions), and each instruction is decoded once
//   for the thread's V elements. The previous instruction's result stays in
//   registers; a result read later than by the next instruction is kept in
//   a register-file slot in shared memory. On a float file the commonest
//   form, an op on the previous result and the immediate, runs in place
//   (lf_inplace: no operand copied); the last result reaches its outputs
//   or its sum straight from registers.
// - Shared memory (offsets from the binding): mbarriers; per input a ring
//   of `stages` (2-4) tiles in the input's own type (float32, float64 or
//   bool bytes: an instruction converts where it reads, so a float and a
//   double file both stay exact); the kept slots (TILE values of the
//   register type each); per output one or two staging tiles in its type;
//   for a sum, one double a thread.
// - Routes of an input (the binding chooses them; chip_smoke.py prints them
//   on its `[design] lazy_fused` lines):
//     bulk     flat at the segment's shape and 16-byte aligned: thread 0
//              copies each whole tile with cp.async.bulk into its ring slot,
//              completing on that stage's mbarrier; the later stages' copies
//              stay in flight while the warps interpret the current tile.
//     tile     its value depends on the element's index modulo a period
//              dividing TILE (a broadcast row, one element): its tile is the
//              same for every tile and is filled once per block.
//     flat     flat but unaligned: per-thread loads of element e.
//     strided  any other view: per-thread loads at the offset of e's
//              coordinates, found with dividers precomputed on the host
//              (multiply-high and shift, as torch's IntDivider), no % or /.
//   A tile's per-thread loads are issued for all its inputs before any
//   instruction runs. The tail tile (n not a multiple of TILE) is read and
//   written by per-thread accesses.
// - Outputs: converted to their type into a staging tile, fence.proxy.async,
//   a barrier, then thread 0 copies the tile out with cp.async.bulk (shared
//   to global); with two staging tiles that copy overlaps the next tile.
// - Grid: persistent, blocks per SM from cudaOccupancyMaxActive-
//   BlocksPerMultiprocessor at the plan's shared memory, times the SMs.
//
// Shared-memory budget (LF_MAX_SMEM = 232,448 bytes a block may opt into):
//   float file: TILE 1024 (64 threads x 16). The largest file, 8 + 32 float
//     slots (163,840 bytes), and two staging tiles of 8 float inputs (65,536)
//     take 229,376. As laid out, the most a plan takes is 2 stages x 8 float
//     inputs (65,536) + 32 kept slots (131,072) + 8 float outputs x 1
//     staging tile (32,768) + barriers = 229,440.
//   double file: TILE 512 (128 threads x 4). 28 double slots (114,688) and
//     two staging tiles of 8 double inputs (65,536) take 180,224; as laid
//     out at most 2 x 8 x 4,096 + 27 x 4,096 + 8 x 4,096 + barriers = 208,960.
//
// Exactness: heat_tpu's contract is that order-specified chains equal eager
// execution bit for bit. Each op rounds once, in its own precision, as
// torch's separate kernels round it: products, sums, differences and
// quotients go through __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn (and the
// __d*_rn forms), which nvcc never contracts into an fma, and the math
// functions are the ones torch's CUDA kernels call (expf, logf, sqrtf,
// powf, fabsf and their double forms). The register file is float when
// every op, input and output of the segment is float32 (or bool), else
// double; a float32 op rounds its operands to float first, as torch's
// .to(float32) does, and its immediate is rounded to float. Comparisons
// write 1 or 0.
//
// A terminal sum (plan mode LF_SUM_*): where a segment's one stored output is
// read only by a sum or a mean, the segment sums it in the same pass and
// never writes it: each value, rounded to the output's type, is added into a
// double in a fixed order (a thread keeps LF_SUMS chains, element v of a step
// adding to chain v % LF_SUMS, folded in order at the end). Over every axis, or over the leading axis of a
// segment whose kept inner extent divides T ("tiles"), it runs on
// the same tiles and routes as a stored segment: thread t's lane is
// t % inner, and a block writes one partial a lane. Otherwise ("lanes") each
// block takes lanes (positions of the kept axes) and a chunk of the summed
// axis, every input by per-thread loads, and writes one partial a lane and
// chunk. A second kernel folds the partials in order and rounds once. No
// float atomics, so a segment gives the same bits on every run.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define LF_MAX_DIMS 4
#define LF_MAX_IN 8
#define LF_MAX_OUT 8
#define LF_MAX_INSTR 32
#define LF_MAX_SLOTS64 28
#define LF_MAX_STAGES 4
#define LF_MAX_SMEM 232448
#define LF_BARRIER_BYTES 64
#define LF_T32 64   // threads a block on a float register file
#define LF_V32 16  // elements a thread holds in a step
#define LF_T64 128  // on a double one
#define LF_V64 4
#define LF_FOLD_THREADS 256
#define LF_SUMS 4  // independent double chains of a thread's terminal sum

static_assert(LF_MAX_STAGES * 8 <= LF_BARRIER_BYTES, "mbarriers");
// the budget as the header states it: the largest file and two staging tiles of LF_MAX_IN inputs
static_assert((LF_MAX_IN + LF_MAX_INSTR) * LF_T32 * LF_V32 * 4 + 2 * LF_MAX_IN * LF_T32 * LF_V32 * 4 <= LF_MAX_SMEM,
              "float file");
static_assert(LF_MAX_SLOTS64 * LF_T64 * LF_V64 * 8 + 2 * LF_MAX_IN * LF_T64 * LF_V64 * 8 <= LF_MAX_SMEM, "double file");
// and as laid out: 2 stages of every input, every instruction kept, one staging tile an output
static_assert(LF_BARRIER_BYTES + (2 * LF_MAX_IN + LF_MAX_INSTR + LF_MAX_OUT) * LF_T32 * LF_V32 * 4 <= LF_MAX_SMEM,
              "float layout");
static_assert(LF_BARRIER_BYTES + (2 * LF_MAX_IN + LF_MAX_SLOTS64 - 1 + LF_MAX_OUT) * LF_T64 * LF_V64 * 8 +
              LF_T64 * 8 <= LF_MAX_SMEM, "double layout");

enum LfDtype { LF_F32 = 0, LF_F64 = 1, LF_BOOL = 2 };

enum LfOp {
    LF_ADD = 0, LF_SUB = 1, LF_MUL = 2, LF_DIV = 3, LF_POW = 4,
    LF_NEG = 5, LF_ABS = 6, LF_EXP = 7, LF_LOG = 8, LF_SQRT = 9,
    LF_GT = 10, LF_GE = 11, LF_LT = 12, LF_LE = 13, LF_EQ = 14, LF_NE = 15,
};

enum LfRoute { LF_BULK = 0, LF_TILE = 1, LF_FLAT = 2, LF_STRIDED = 3 };

// where an operand or an output reads its values: an immediate, the previous result (registers), or shared
// memory of a type (an input's staged tile, a kept slot of the register file)
enum LfKind { LF_K_IMM = 0, LF_K_ACC = 1, LF_K_F32 = 2, LF_K_F64 = 3, LF_K_U8 = 4 };

enum LfMode { LF_STORE = 0, LF_SUM_TILES = 1, LF_SUM_LANES = 2 };

struct LfSrc {
    int kind;
    int off;    // shared-memory byte offset of thread 0's element 0 at stage 0
    int stage;  // bytes between two stages (0: the same tile at every stage)
};

struct LfDiv {  // i / d == (umulhi(i, magic) + i) >> shift, for i below 2^31 (2^63 with 64-bit indices)
    unsigned long long magic;
    int shift;
    int pad;
};

struct LfInput {
    const void* ptr;
    long long stride[LF_MAX_DIMS];  // in elements, at the segment's shape (0 on broadcast axes)
    int dtype;
    int route;
    int off;    // its stage 0 in shared memory
    int stage;  // bytes between its stages (0 on the tile route)
};

struct LfOutput {
    void* ptr;
    LfSrc src;
    int dtype;
    int off;    // its staging tile in shared memory
    int stage;  // bytes between its two staging tiles (0: one)
    int pad;
};

struct LfInstr {
    double imm;
    int op;
    int f64;
    LfSrc a;
    LfSrc b;
    int keep;  // its kept slot's byte offset in shared memory, or -1
    int inplace;  // 1: on a float file, an op on the previous result and the immediate (lf_inplace)
};

struct LfPlan {
    long long shape[LF_MAX_DIMS];  // leading dims padded with 1
    LfDiv div[LF_MAX_DIMS];        // of each extent
    long long n;
    long long tiles;  // ceil(n / TILE)
    int n_in;
    int n_out;
    int n_instr;
    int mode;
    int stages;
    int out_bufs;
    int bulk_bytes;  // a tile's bytes over every bulk input (0: none)
    int idx64;       // 64-bit dividers (some offset reaches 2^31)
    int inner;       // LF_SUM_TILES: lanes (thread t sums lane t % inner)
    int red_off;     // LF_SUM_*: one double a thread in shared memory
    LfInput in[LF_MAX_IN];
    LfOutput out[LF_MAX_OUT];
    LfInstr ins[LF_MAX_INSTR];
};

// LF_SUM_LANES: the segment's shape viewed as (outer, r, inner), r the summed axis
struct LfReduce {
    long long outer, r, inner;
    long long rows;        // positions of r a block sums (a multiple of ty * V)
    long long chunks;      // blocks along r: ceil(r / rows)
    long long lane_tiles;  // blocks across inner: ceil(inner / tx)
    int tx, ty;            // a block's lanes (inner positions) and row groups, tx * ty <= T
    int rows_mode;         // inner == 1 and r short: a thread sums a whole row (outer / T blocks)
    int pad;
};

template <typename R>
struct LfReg;
template <>
struct LfReg<float> {
    static constexpr int T = LF_T32;
    static constexpr int V = LF_V32;
    static constexpr int MIN_BLOCKS = 8;  // at most 128 registers a thread
};
template <>
struct LfReg<double> {
    static constexpr int T = LF_T64;
    static constexpr int V = LF_V64;
    static constexpr int MIN_BLOCKS = 2;  // at most 255
};

// ---------------------------------------------------------------- Hopper's asynchronous copies (PTX)
__device__ __forceinline__ unsigned lf_sptr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void lf_mbar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(lf_sptr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void lf_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void lf_fence_async() {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void lf_expect(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(lf_sptr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void lf_mbar_wait(uint64_t* bar, unsigned parity) {
    asm volatile(
        "{\n\t.reg .pred P1;\n"
        "LF_WAIT:\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
        "@P1 bra LF_DONE;\n\t"
        "bra LF_WAIT;\n"
        "LF_DONE:\n\t}" ::"r"(lf_sptr(bar)),
        "r"(parity)
        : "memory");
}
__device__ __forceinline__ void lf_load_bulk(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                     lf_sptr(dst)),
                 "l"(src), "r"(bytes), "r"(lf_sptr(bar))
                 : "memory");
}
__device__ __forceinline__ void lf_store_bulk(void* dst, const void* src, unsigned bytes) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst), "r"(lf_sptr(src)),
                 "r"(bytes)
                 : "memory");
}
__device__ __forceinline__ void lf_commit() { asm volatile("cp.async.bulk.commit_group;" ::: "memory"); }
__device__ __forceinline__ void lf_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory"); }
__device__ __forceinline__ void lf_wait_all() { asm volatile("cp.async.bulk.wait_group 0;" ::: "memory"); }

__device__ __forceinline__ int lf_size(int dtype) { return dtype == LF_F64 ? 8 : dtype == LF_F32 ? 4 : 1; }

// ---------------------------------------------------------------- the interpreter
#define LF_EACH(EXPR)                               \
    _Pragma("unroll") for (int v = 0; v < V; ++v) { \
        const T x = a[v], y = b[v];                 \
        (void)y;                                    \
        o[v] = (EXPR);                              \
    }                                               \
    break;

// the large math functions (pow, log; and exp in double) one element at a time, the arrays rotated by one each
// turn, so that each instruction's copy holds one inlined copy of the function instead of V
#define LF_ROLL(EXPR)                                       \
    _Pragma("unroll 1") for (int i = 0; i < V; ++i) {       \
        const T x = a[0], y = b[0];                         \
        (void)y;                                            \
        const T r = (EXPR);                                 \
        _Pragma("unroll") for (int v = 0; v + 1 < V; ++v) { \
            a[v] = a[v + 1];                                \
            b[v] = b[v + 1];                                \
            o[v] = o[v + 1];                                \
        }                                                   \
        o[V - 1] = r;                                       \
    }                                                       \
    break;

// one instruction on V elements: the opcode is decoded once for all of them
template <int V>
__device__ __forceinline__ void lf_apply32(int op, float (&a)[V], float (&b)[V], float (&o)[V]) {
    using T = float;
    switch (op) {
        case LF_ADD: LF_EACH(__fadd_rn(x, y))
        case LF_SUB: LF_EACH(__fsub_rn(x, y))
        case LF_MUL: LF_EACH(__fmul_rn(x, y))
        case LF_DIV: LF_EACH(__fdiv_rn(x, y))
        case LF_POW: LF_ROLL(powf(x, y))
        case LF_NEG: LF_EACH(-x)
        case LF_ABS: LF_EACH(fabsf(x))
        case LF_EXP: LF_EACH(expf(x))
        case LF_LOG: LF_ROLL(logf(x))
        case LF_SQRT: LF_EACH(sqrtf(x))
        case LF_GT: LF_EACH(x > y ? 1.0f : 0.0f)
        case LF_GE: LF_EACH(x >= y ? 1.0f : 0.0f)
        case LF_LT: LF_EACH(x < y ? 1.0f : 0.0f)
        case LF_LE: LF_EACH(x <= y ? 1.0f : 0.0f)
        case LF_EQ: LF_EACH(x == y ? 1.0f : 0.0f)
        default: LF_EACH(x != y ? 1.0f : 0.0f)
    }
}

template <int V>
__device__ __forceinline__ void lf_apply64(int op, double (&a)[V], double (&b)[V], double (&o)[V]) {
    using T = double;
    switch (op) {
        case LF_ADD: LF_EACH(__dadd_rn(x, y))
        case LF_SUB: LF_EACH(__dsub_rn(x, y))
        case LF_MUL: LF_EACH(__dmul_rn(x, y))
        case LF_DIV: LF_EACH(__ddiv_rn(x, y))
        case LF_POW: LF_ROLL(pow(x, y))
        case LF_NEG: LF_EACH(-x)
        case LF_ABS: LF_EACH(fabs(x))
        case LF_EXP: LF_ROLL(exp(x))
        case LF_LOG: LF_ROLL(log(x))
        case LF_SQRT: LF_EACH(sqrt(x))
        case LF_GT: LF_EACH(x > y ? 1.0 : 0.0)
        case LF_GE: LF_EACH(x >= y ? 1.0 : 0.0)
        case LF_LT: LF_EACH(x < y ? 1.0 : 0.0)
        case LF_LE: LF_EACH(x <= y ? 1.0 : 0.0)
        case LF_EQ: LF_EACH(x == y ? 1.0 : 0.0)
        default: LF_EACH(x != y ? 1.0 : 0.0)
    }
}

// an operand's (or an output's) V values of thread t at stage s, in type T
template <int TH, typename T, typename R, int V>
__device__ __forceinline__ void lf_fetch(const LfSrc& src, double imm, const R (&acc)[V], const unsigned char* sm,
                                         int t, int s, T (&x)[V]) {
    switch (src.kind) {
        case LF_K_ACC:
#pragma unroll
            for (int v = 0; v < V; ++v) x[v] = static_cast<T>(acc[v]);
            break;
        case LF_K_F32: {
            const float* p = reinterpret_cast<const float*>(sm + src.off + s * src.stage) + t;
#pragma unroll
            for (int v = 0; v < V; ++v) x[v] = static_cast<T>(p[v * TH]);
            break;
        }
        case LF_K_F64: {
            const double* p = reinterpret_cast<const double*>(sm + src.off + s * src.stage) + t;
#pragma unroll
            for (int v = 0; v < V; ++v) x[v] = static_cast<T>(p[v * TH]);
            break;
        }
        case LF_K_U8: {
            const unsigned char* p = sm + src.off + s * src.stage + t;
#pragma unroll
            for (int v = 0; v < V; ++v) x[v] = p[v * TH] ? T(1) : T(0);
            break;
        }
        default: {
            const T c = static_cast<T>(imm);
#pragma unroll
            for (int v = 0; v < V; ++v) x[v] = c;
        }
    }
}

// on a float register file, the commonest form: an op on the previous result and the immediate (add, sub, mul,
// div, or neg, abs, exp) in place, no operand copied
template <int V>
__device__ __forceinline__ void lf_inplace(int op, float c, float (&acc)[V]) {
    switch (op) {
        case LF_ADD:
#pragma unroll
            for (int v = 0; v < V; ++v) acc[v] = __fadd_rn(acc[v], c);
            break;
        case LF_SUB:
#pragma unroll
            for (int v = 0; v < V; ++v) acc[v] = __fsub_rn(acc[v], c);
            break;
        case LF_MUL:
#pragma unroll
            for (int v = 0; v < V; ++v) acc[v] = __fmul_rn(acc[v], c);
            break;
        case LF_DIV:
#pragma unroll
            for (int v = 0; v < V; ++v) acc[v] = __fdiv_rn(acc[v], c);
            break;
        case LF_NEG:
#pragma unroll
            for (int v = 0; v < V; ++v) acc[v] = -acc[v];
            break;
        case LF_ABS:
#pragma unroll
            for (int v = 0; v < V; ++v) acc[v] = fabsf(acc[v]);
            break;
        default:
#pragma unroll
            for (int v = 0; v < V; ++v) acc[v] = expf(acc[v]);
    }
}

// instruction K on thread t's V elements, then the next ones: a template recursion rather than a loop, so that
// every copy reads its instruction's fields as constant-bank operands; the last result stays in acc
template <int TH, typename R, int V, int K>
__device__ __forceinline__ void lf_run(const LfPlan& p, unsigned char* sm, int t, int s, R (&acc)[V]) {
    if constexpr (K < LF_MAX_INSTR) {
        if (K >= p.n_instr) return;
        const LfInstr& q = p.ins[K];
        if constexpr (sizeof(R) == 8) {  // (the double file has no in-place path: it would spill at 255 registers)
            if (q.f64) {
                double a[V], b[V], o[V];
                lf_fetch<TH>(q.a, q.imm, acc, sm, t, s, a);
                lf_fetch<TH>(q.b, q.imm, acc, sm, t, s, b);
                lf_apply64<V>(q.op, a, b, o);
#pragma unroll
                for (int v = 0; v < V; ++v) acc[v] = o[v];
            } else {
                float a[V], b[V], o[V];
                lf_fetch<TH>(q.a, q.imm, acc, sm, t, s, a);
                lf_fetch<TH>(q.b, q.imm, acc, sm, t, s, b);
                lf_apply32<V>(q.op, a, b, o);
#pragma unroll
                for (int v = 0; v < V; ++v) acc[v] = static_cast<R>(o[v]);
            }
        } else if (q.inplace) {
            lf_inplace<V>(q.op, static_cast<float>(q.imm), acc);
        } else {
            float a[V], b[V], o[V];
            lf_fetch<TH>(q.a, q.imm, acc, sm, t, s, a);
            lf_fetch<TH>(q.b, q.imm, acc, sm, t, s, b);
            lf_apply32<V>(q.op, a, b, o);
#pragma unroll
            for (int v = 0; v < V; ++v) acc[v] = o[v];
        }
        if (q.keep >= 0) {
            R* d = reinterpret_cast<R*>(sm + q.keep) + t;
#pragma unroll
            for (int v = 0; v < V; ++v) d[v * TH] = acc[v];
        }
        lf_run<TH, R, V, K + 1>(p, sm, t, s, acc);
    }
}

// ---------------------------------------------------------------- per-thread loads
// the offset of element e of a strided input: its coordinates by the dividers, innermost first
__device__ __forceinline__ long long lf_offset(const LfPlan& p, const LfInput& in, long long e) {
    if (p.idx64) {
        unsigned long long rem = static_cast<unsigned long long>(e);
        long long off = 0;
#pragma unroll
        for (int d = LF_MAX_DIMS - 1; d > 0; --d) {
            if (p.shape[d] == 1) continue;
            const unsigned long long q = (__umul64hi(rem, p.div[d].magic) + rem) >> p.div[d].shift;
            off += static_cast<long long>(rem - q * static_cast<unsigned long long>(p.shape[d])) * in.stride[d];
            rem = q;
        }
        return off + static_cast<long long>(rem) * in.stride[0];
    }
    unsigned rem = static_cast<unsigned>(e);
    int off = 0;
#pragma unroll
    for (int d = LF_MAX_DIMS - 1; d > 0; --d) {
        if (p.shape[d] == 1) continue;
        const unsigned q = (__umulhi(rem, static_cast<unsigned>(p.div[d].magic)) + rem) >> p.div[d].shift;
        off += static_cast<int>(rem - q * static_cast<unsigned>(p.shape[d])) * static_cast<int>(in.stride[d]);
        rem = q;
    }
    return off + static_cast<int>(rem) * static_cast<int>(in.stride[0]);
}

// thread t's elements e0 + v * de (those with v < nv; the others read element 0) of every input whose route is
// in `routes` (a bit mask), into its slot at stage s: all loads of an input are issued before its stores
template <int TH, int V>
__device__ __forceinline__ void lf_fill(const LfPlan& p, unsigned char* sm, int t, int s, long long e0, long long de,
                                        int nv, unsigned routes) {
#pragma unroll
    for (int k = 0; k < LF_MAX_IN; ++k) {
        if (k >= p.n_in) break;
        const LfInput& in = p.in[k];
        if (!((routes >> in.route) & 1u)) continue;
        const bool flat = in.route == LF_BULK || in.route == LF_FLAT;
        long long off[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
            const long long e = e0 + v * de;
            off[v] = v >= nv ? 0 : flat ? e : lf_offset(p, in, e);
        }
        unsigned char* base = sm + in.off + s * in.stage;
        if (in.dtype == LF_F32) {
            const float* g = static_cast<const float*>(in.ptr);
            float x[V];
#pragma unroll
            for (int v = 0; v < V; ++v) x[v] = __ldg(g + off[v]);
#pragma unroll
            for (int v = 0; v < V; ++v) reinterpret_cast<float*>(base)[t + v * TH] = x[v];
        } else if (in.dtype == LF_F64) {
            const double* g = static_cast<const double*>(in.ptr);
            double x[V];
#pragma unroll
            for (int v = 0; v < V; ++v) x[v] = __ldg(g + off[v]);
#pragma unroll
            for (int v = 0; v < V; ++v) reinterpret_cast<double*>(base)[t + v * TH] = x[v];
        } else {
            const unsigned char* g = static_cast<const unsigned char*>(in.ptr);
            unsigned char x[V];
#pragma unroll
            for (int v = 0; v < V; ++v) x[v] = __ldg(g + off[v]);
#pragma unroll
            for (int v = 0; v < V; ++v) base[t + v * TH] = x[v];
        }
    }
}

// thread 0: the bulk copies of the tile at element `base` into stage s, completing on its mbarrier
template <int TILE>
__device__ __forceinline__ void lf_issue(const LfPlan& p, unsigned char* sm, uint64_t* bar, int s, long long base) {
    lf_expect(bar, static_cast<unsigned>(p.bulk_bytes));
#pragma unroll
    for (int k = 0; k < LF_MAX_IN; ++k) {
        if (k >= p.n_in) break;
        const LfInput& in = p.in[k];
        if (in.route != LF_BULK) continue;
        const int size = lf_size(in.dtype);
        lf_load_bulk(sm + in.off + s * in.stage, static_cast<const unsigned char*>(in.ptr) + base * size,
                     static_cast<unsigned>(TILE * size), bar);
    }
}

// output o's V values x of thread t: into its staging tile (buffer ob), or straight to memory at elements
// e0 + v * TH, v < nv (the tail tile)
template <int TH, typename R, int V>
__device__ __forceinline__ void lf_put(const LfOutput& o, const R (&x)[V], unsigned char* sm, int t, bool staged, int ob,
                                       long long e0, int nv) {
    if (o.dtype == LF_F32) {
        float* d = staged ? reinterpret_cast<float*>(sm + o.off + ob * o.stage) + t : static_cast<float*>(o.ptr) + e0;
#pragma unroll
        for (int v = 0; v < V; ++v)
            if (staged || v < nv) d[v * TH] = static_cast<float>(x[v]);
    } else if (o.dtype == LF_F64) {
        double* d = staged ? reinterpret_cast<double*>(sm + o.off + ob * o.stage) + t : static_cast<double*>(o.ptr) + e0;
#pragma unroll
        for (int v = 0; v < V; ++v)
            if (staged || v < nv) d[v * TH] = static_cast<double>(x[v]);
    } else {
        unsigned char* d = staged ? sm + o.off + ob * o.stage + t : static_cast<unsigned char*>(o.ptr) + e0;
#pragma unroll
        for (int v = 0; v < V; ++v)
            if (staged || v < nv) d[v * TH] = x[v] != R(0) ? 1 : 0;
    }
}

// the outputs of thread t's V elements (the last result straight from registers)
template <int TH, typename R, int V>
__device__ __forceinline__ void lf_outputs(const LfPlan& p, unsigned char* sm, int t, int s, const R (&acc)[V],
                                           bool staged, int ob, long long e0, int nv) {
#pragma unroll
    for (int k = 0; k < LF_MAX_OUT; ++k) {
        if (k >= p.n_out) break;
        const LfOutput& o = p.out[k];
        if (o.src.kind == LF_K_ACC) {
            lf_put<TH, R, V>(o, acc, sm, t, staged, ob, e0, nv);
        } else {
            R x[V];
            lf_fetch<TH>(o.src, 0.0, acc, sm, t, s, x);
            lf_put<TH, R, V>(o, x, sm, t, staged, ob, e0, nv);
        }
    }
}

// a summed output's values of thread t's elements v < nv, rounded to its type, onto chain v % LF_SUMS
template <typename R, int V>
__device__ __forceinline__ void lf_add_terms(const LfOutput& o, const R (&x)[V], int nv, double (&sums)[LF_SUMS]) {
#pragma unroll
    for (int v = 0; v < V; ++v)
        if (v < nv)
            sums[v % LF_SUMS] +=
                o.dtype == LF_F32 ? static_cast<double>(static_cast<float>(x[v])) : static_cast<double>(x[v]);
}

// ---------------------------------------------------------------- the kernel
// One kernel for every mode. Step `it` of a block covers thread t's elements e0 + v * de, v < nv:
//   LF_STORE / LF_SUM_TILES: tile blockIdx.x + it * gridDim.x (e0 = its start + t, de = TH);
//   LF_SUM_LANES, rows mode: V positions of thread t's row (de = 1);
//   LF_SUM_LANES: V positions of r, ty apart, in lane c (de = ty * inner).
template <typename R>
__global__ void __launch_bounds__(LfReg<R>::T, LfReg<R>::MIN_BLOCKS)
    lazy_fused_kernel(const __grid_constant__ LfPlan p, const __grid_constant__ LfReduce q,
                      double* __restrict__ partial) {
    constexpr int TH = LfReg<R>::T;
    constexpr int V = LfReg<R>::V;
    constexpr int TILE = TH * V;
    extern __shared__ __align__(128) unsigned char sm[];
    uint64_t* const bars = reinterpret_cast<uint64_t*>(sm);
    const int t = threadIdx.x;
    const bool tiles = p.mode != LF_SUM_LANES;
    const bool bulk = tiles && p.bulk_bytes > 0;
    const long long grid = gridDim.x;
    unsigned fill_full = (1u << LF_FLAT) | (1u << LF_STRIDED);
    long long nsteps, lane_e0 = 0, lane_de = 1, j0 = 0, j1 = 0;
    int lane_ok = 1, ty = 0, tx = 0;
    long long c = 0, oo = 0, ch = 0;
    if (tiles) {
        // the tile route's inputs: the same tile for every tile, once per block (element v * TH + t)
        const long long left = p.n - t;
        lf_fill<TH, V>(p, sm, t, 0, t, TH,
                   left <= 0 ? 0 : left >= TILE ? V : static_cast<int>((left + TH - 1) / TH),
                   1u << LF_TILE);
        if (bulk && t == 0) {
            for (int s = 0; s < p.stages; ++s) lf_mbar_init(bars + s, 1);
            lf_fence_init();
            lf_fence_async();
        }
        __syncthreads();
        if (bulk && t == 0) {
            for (int s = 0; s < p.stages; ++s) {
                const long long ti = blockIdx.x + s * grid;
                if ((ti + 1) * TILE <= p.n) lf_issue<TILE>(p, sm, bars + s, s, ti * TILE);
            }
        }
        nsteps = (p.tiles - blockIdx.x + grid - 1) / grid;
    } else if (q.rows_mode) {
        const long long row = static_cast<long long>(blockIdx.x) * TH + t;
        lane_ok = row < q.outer;
        lane_e0 = row * q.r;
        nsteps = (q.r + V - 1) / V;
        fill_full = ~0u;
    } else {
        const long long b = blockIdx.x;
        const long long lt = b % q.lane_tiles;
        const long long rest = b / q.lane_tiles;
        oo = rest % q.outer;
        ch = rest / q.outer;
        tx = t % q.tx;
        ty = t / q.tx;
        c = lt * q.tx + tx;
        lane_ok = ty < q.ty && c < q.inner;
        j0 = ch * q.rows;
        j1 = j0 + q.rows < q.r ? j0 + q.rows : q.r;
        lane_de = static_cast<long long>(q.ty) * q.inner;
        nsteps = (j1 - j0 + static_cast<long long>(q.ty) * V - 1) / (static_cast<long long>(q.ty) * V);
        fill_full = ~0u;
    }
    // a sum's terms in LF_SUMS chains (element v adds to chain v % LF_SUMS), folded in a fixed order at the end
    double sums[LF_SUMS];
#pragma unroll
    for (int k = 0; k < LF_SUMS; ++k) sums[k] = 0.0;
    R acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = R(0);
    int s = 0;            // this step's stage of the rings
    unsigned parity = 0;  // the phase of its mbarrier
    for (long long it = 0; it < nsteps; ++it) {
        long long e0, de;
        int nv;
        bool full = false;
        if (tiles) {
            const long long base = (blockIdx.x + it * grid) * TILE;
            full = base + TILE <= p.n;
            e0 = base + t;
            de = TH;
            const long long left = p.n - e0;
            nv = full ? V : left <= 0 ? 0 : (static_cast<int>(left) + TH - 1) / TH;
        } else if (q.rows_mode) {
            const long long j = it * V;
            e0 = lane_e0 + j;
            de = 1;
            nv = !lane_ok ? 0 : static_cast<int>(q.r - j < V ? q.r - j : V);
        } else {
            const long long j = j0 + it * static_cast<long long>(q.ty) * V + ty;
            e0 = (oo * q.r + j) * q.inner + c;
            de = lane_de;
            const long long left = j1 - j;
            nv = !lane_ok || left <= 0                       ? 0
                 : left >= static_cast<long long>(q.ty) * V ? V
                                                             : (static_cast<int>(left) + q.ty - 1) / q.ty;
        }
        // per-thread loads: the gathered routes (every route but the tile one in the tail tile and the lanes)
        lf_fill<TH, V>(p, sm, t, s, e0, de, nv, full ? fill_full : fill_full | (1u << LF_BULK));
        if (full && bulk) lf_mbar_wait(bars + s, parity);
        lf_run<TH, R, V, 0>(p, sm, t, s, acc);
        if (p.mode == LF_STORE) {
            if (full) {
                const int ob = static_cast<int>(it & 1);
                if (p.out_bufs == 1) {  // the last tile's copy out has read its staging tile
                    if (t == 0) lf_wait_read();
                    __syncthreads();
                }
                lf_outputs<TH, R, V>(p, sm, t, s, acc, true, ob, 0, V);
                lf_fence_async();
                if (p.out_bufs == 2 && t == 0) lf_wait_read();  // the copy out of two tiles ago has read buffer ob^1
                __syncthreads();
                if (t == 0) {
                    const long long base = e0 - t;
#pragma unroll
                    for (int k = 0; k < LF_MAX_OUT; ++k) {
                        if (k >= p.n_out) break;
                        const LfOutput& o = p.out[k];
                        const int size = lf_size(o.dtype);
                        lf_store_bulk(static_cast<unsigned char*>(o.ptr) + base * size, sm + o.off + ob * o.stage,
                                      static_cast<unsigned>(TILE * size));
                    }
                    lf_commit();
                    const long long next = base + p.stages * grid * TILE;
                    if (bulk && next + TILE <= p.n) lf_issue<TILE>(p, sm, bars + s, s, next);
                }
            } else {
                lf_outputs<TH, R, V>(p, sm, t, s, acc, false, 0, e0, nv);
            }
        } else {
            const LfOutput& o = p.out[0];
            if (o.src.kind == LF_K_ACC) {
                lf_add_terms<R, V>(o, acc, nv, sums);
            } else {
                R x[V];
                lf_fetch<TH>(o.src, 0.0, acc, sm, t, s, x);
                lf_add_terms<R, V>(o, x, nv, sums);
            }
            if (full && bulk) {
                __syncthreads();  // every thread has read stage s
                const long long next = e0 - t + p.stages * grid * TILE;
                if (t == 0 && next + TILE <= p.n) lf_issue<TILE>(p, sm, bars + s, s, next);
            }
        }
        if (++s == p.stages) {
            s = 0;
            parity ^= 1u;
        }
    }
    if (p.mode == LF_STORE) {
        if (t == 0) lf_wait_all();
        return;
    }
    double sum = 0.0;
#pragma unroll
    for (int k = 0; k < LF_SUMS; ++k) sum += sums[k];
    if (!tiles && q.rows_mode) {
        if (lane_ok) partial[static_cast<long long>(blockIdx.x) * TH + t] = sum;
        return;
    }
    double* red = reinterpret_cast<double*>(sm + p.red_off);
    red[t] = sum;
    __syncthreads();
    if (tiles) {  // one partial a lane: thread t's lane is t % inner, folded in thread order
        if (t < p.inner) {
            double s = 0.0;
            for (int u = t; u < TH; u += p.inner) s += red[u];
            partial[static_cast<long long>(blockIdx.x) * p.inner + t] = s;
        }
    } else if (ty == 0 && c < q.inner) {  // one partial a lane and chunk, folded in row-group order
        double s = 0.0;
        for (int y = 0; y < q.ty; ++y) s += red[y * q.tx + tx];
        partial[(ch * q.outer + oo) * q.inner + c] = s;
    }
}

// The partials (chunks, lanes) folded in chunk order, rounded once to the output's type
__global__ void __launch_bounds__(LF_FOLD_THREADS) lazy_reduce_fold(const double* __restrict__ partial, void* result,
                                                                    int f32, long long lanes, long long chunks) {
    const long long l = static_cast<long long>(blockIdx.x) * LF_FOLD_THREADS + threadIdx.x;
    if (l >= lanes) return;
    double s = 0.0;
    for (long long ch = 0; ch < chunks; ++ch) s += partial[ch * lanes + l];
    if (f32) static_cast<float*>(result)[l] = static_cast<float>(s);
    else static_cast<double*>(result)[l] = s;
}

// ---------------------------------------------------------------- the C interface
static void* lf_kernel(int reg64) {
    return reg64 ? reinterpret_cast<void*>(lazy_fused_kernel<double>)
                 : reinterpret_cast<void*>(lazy_fused_kernel<float>);
}

// the kernels take up to LF_MAX_SMEM bytes of dynamic shared memory (set once a device)
static cudaError_t lf_attributes(int device) {
    static bool done[64] = {};
    if (device >= 0 && device < 64 && done[device]) return cudaSuccess;
    for (int r = 0; r < 2; ++r) {
        cudaError_t err = cudaFuncSetAttribute(lf_kernel(r), cudaFuncAttributeMaxDynamicSharedMemorySize, LF_MAX_SMEM);
        if (err != cudaSuccess) return err;
    }
    if (device >= 0 && device < 64) done[device] = true;
    return cudaSuccess;
}

// Blocks of the kernel (double registers where reg64) an SM holds at `smem` bytes of dynamic shared memory;
// a negative CUDA error where the query fails.
extern "C" int lazy_fused_occupancy(int reg64, int smem, int device) {
    cudaError_t err = cudaSetDevice(device);
    if (err == cudaSuccess) err = lf_attributes(device);
    int blocks = 0;
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, lf_kernel(reg64),
                                                                                 reg64 ? LF_T64 : LF_T32,
                                                                                 static_cast<size_t>(smem));
    return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Launch one segment. `plan` is the binding's cached plan; `ptrs` the inputs' then the outputs' pointers and
// `imms` the instructions' immediates of this call, copied into the kernel's parameter. A summed segment
// (plan->mode != LF_STORE) writes its partials into `partial` and then folds `chunks` of `lanes` into `result`
// (a second launch). Returns cudaGetLastError() (0 on success).
extern "C" int lazy_fused(const LfPlan* plan, const void* const* ptrs, const double* imms, const LfReduce* red,
                          int reg64, int grid, int smem, double* partial, void* result, long long lanes,
                          long long chunks, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err == cudaSuccess) err = lf_attributes(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (plan->n_in < 1 || plan->n_in > LF_MAX_IN || plan->n_out < 1 || plan->n_out > LF_MAX_OUT ||
        plan->n_instr > LF_MAX_INSTR || plan->stages < 1 || plan->stages > LF_MAX_STAGES || grid <= 0 ||
        smem > LF_MAX_SMEM || (reg64 && plan->n_in + plan->n_instr > LF_MAX_SLOTS64) ||
        (plan->mode != LF_STORE && (plan->n_out != 1 || plan->out[0].dtype == LF_BOOL))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    LfPlan p = *plan;
    for (int k = 0; k < p.n_in; ++k) p.in[k].ptr = ptrs[k];
    for (int k = 0; k < p.n_out; ++k) p.out[k].ptr = const_cast<void*>(ptrs[p.n_in + k]);
    for (int k = 0; k < p.n_instr; ++k) p.ins[k].imm = imms[k];
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (reg64) lazy_fused_kernel<double><<<grid, LF_T64, smem, s>>>(p, *red, partial);
    else lazy_fused_kernel<float><<<grid, LF_T32, smem, s>>>(p, *red, partial);
    err = cudaGetLastError();
    if (err != cudaSuccess || plan->mode == LF_STORE) return static_cast<int>(err);
    lazy_reduce_fold<<<static_cast<unsigned>((lanes + LF_FOLD_THREADS - 1) / LF_FOLD_THREADS), LF_FOLD_THREADS, 0,
                       s>>>(partial, result, plan->out[0].dtype == LF_F32, lanes, chunks);
    return static_cast<int>(cudaGetLastError());
}

// The layout the binding must match: sizeof(LfPlan), sizeof(LfReduce), threads a block and elements a thread a
// step (float, then double file), the most double slots, the most shared memory, the barriers' bytes, the most
// stages
extern "C" void lazy_fused_layout(long long* out) {
    out[0] = sizeof(LfPlan);
    out[1] = sizeof(LfReduce);
    out[2] = LF_T32;
    out[3] = LF_V32;
    out[4] = LF_T64;
    out[5] = LF_V64;
    out[6] = LF_MAX_SLOTS64;
    out[7] = LF_MAX_SMEM;
    out[8] = LF_BARRIER_BYTES;
    out[9] = LF_MAX_STAGES;
}
