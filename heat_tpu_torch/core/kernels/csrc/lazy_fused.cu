// lazy_fused: one kernel that runs every fused elementwise segment of the
// lazy layer (heat_tpu_torch/core/lazy/evaluate.py) by interpreting the
// segment's plan.
//
// Replaces no Pallas kernel. heat_tpu runs a captured chain as one fused
// XLA program (heat_tpu/core/lazy/evaluate.py:_build_program); in torch
// eager each op of the chain is a pass over memory. Here a segment is one
// pass: each thread takes LF_V elements a step of a grid-stride loop, loads
// every input of the segment at each of them (through the input's
// broadcast strides: stride 0 along a broadcast axis, up to 4 dimensions,
// or the flat index where the input is contiguous at the segment's shape),
// runs the plan's instructions on a register file in shared memory (no bank
// conflicts, and dynamic slot numbers cost no local-memory traffic), each
// instruction decoded once for the LF_V elements, and stores each output.
// The plan is the same for every thread, so the opcode switch never
// diverges, and one build serves every chain: nothing is compiled per
// signature.
//
// Plan: inputs occupy slots 0..n_in-1; instruction k writes slot dst from
// slot a (or the immediate where a < 0) and slot b (or the immediate where
// b < 0); `f64` picks the precision the op rounds in. Comparisons write 1
// or 0. Outputs copy a slot to memory in their own type. The previous
// instruction's result stays in registers: an operand that is that result
// reads it there, and a result only the next instruction reads is never
// stored to shared memory (the binding sets these flags from the plan).
//
// Exactness: heat_tpu's contract is that order-specified chains equal eager
// execution bit for bit. Each op rounds once, in its own precision, as
// torch's separate kernels round it: products, sums, differences and
// quotients go through __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn (and the
// __d*_rn forms), which nvcc never contracts into an fma, and the math
// functions are the ones torch's CUDA kernels call (expf, logf, sqrtf,
// powf, fabsf and their double forms). The register file is float when
// every op, input and output of the segment is float32 (or bool), else
// double; a float32 op then rounds its operands to float first, as
// torch's .to(float32) does.
//
// Bound on an H100: bytes (each input read once, each output written once).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define LF_MAX_DIMS 4
#define LF_MAX_IN 8
#define LF_MAX_OUT 8
#define LF_MAX_INSTR 32
#define LF_THREADS 256
#define LF_V 4  // elements a thread takes a step
// The register file takes LF_V x LF_THREADS registers a slot (inputs and
// instructions). A double file of LF_MAX_IN + LF_MAX_INSTR slots would
// outgrow the 227 KiB of shared memory an H100 block may opt into, so a
// segment on double registers holds at most LF_MAX_SLOTS64 slots (the
// planner cuts float64 segments there).
#define LF_MAX_SMEM 232448
#define LF_MAX_SLOTS64 28
static_assert(LF_MAX_SLOTS64 * LF_V * LF_THREADS * sizeof(double) <= LF_MAX_SMEM, "double register file");
static_assert((LF_MAX_IN + LF_MAX_INSTR) * LF_V * LF_THREADS * sizeof(float) <= LF_MAX_SMEM, "float register file");

enum LfDtype { LF_F32 = 0, LF_F64 = 1, LF_BOOL = 2 };

enum LfOp {
    LF_ADD = 0, LF_SUB = 1, LF_MUL = 2, LF_DIV = 3, LF_POW = 4,
    LF_NEG = 5, LF_ABS = 6, LF_EXP = 7, LF_LOG = 8, LF_SQRT = 9,
    LF_GT = 10, LF_GE = 11, LF_LT = 12, LF_LE = 13, LF_EQ = 14, LF_NE = 15,
};

struct LfInput {
    const void* ptr;
    long long stride[LF_MAX_DIMS];  // in elements, at the segment's shape (0 on broadcast axes)
    int dtype;
    int flat;  // 1: contiguous at the segment's shape, element i at offset i; 2: one element (every stride 0)
};

struct LfOutput {
    void* ptr;
    int slot;
    int dtype;
};

struct LfInstr {
    double imm;
    int op;
    int dst;
    int a;
    int b;
    int f64;
    int flags;  // LF_A_ACC / LF_B_ACC: the operand is the previous result; LF_KEEP: store the result to its slot
};

enum LfFlags { LF_A_ACC = 1, LF_B_ACC = 2, LF_KEEP = 4 };

struct LfPlan {
    long long shape[LF_MAX_DIMS];  // leading dims padded with 1
    long long n;
    int n_in;
    int n_out;
    int n_instr;
    int pad;  // 1 where some input is strided: the element's coordinates are needed
    LfInput in[LF_MAX_IN];
    LfOutput out[LF_MAX_OUT];
    LfInstr ins[LF_MAX_INSTR];
};

template <typename R>
__device__ __forceinline__ R lf_load(const LfInput& in, long long off) {
    switch (in.dtype) {
        case LF_F32: return static_cast<R>(__ldg(static_cast<const float*>(in.ptr) + off));
        case LF_F64: return static_cast<R>(__ldg(static_cast<const double*>(in.ptr) + off));
        default: return __ldg(static_cast<const unsigned char*>(in.ptr) + off) ? R(1) : R(0);
    }
}

#define LF_EACH(EXPR)                             \
    _Pragma("unroll") for (int v = 0; v < V; ++v) { \
        const T x = a[v], y = b[v];               \
        (void)y;                                  \
        o[v] = (EXPR);                            \
    }                                             \
    break;

// one instruction on V elements: the opcode is decoded once for all of them
template <int V>
__device__ __forceinline__ void lf_apply32(int op, const float* a, const float* b, float* o) {
    using T = float;
    switch (op) {
        case LF_ADD: LF_EACH(__fadd_rn(x, y))
        case LF_SUB: LF_EACH(__fsub_rn(x, y))
        case LF_MUL: LF_EACH(__fmul_rn(x, y))
        case LF_DIV: LF_EACH(__fdiv_rn(x, y))
        case LF_POW: LF_EACH(powf(x, y))
        case LF_NEG: LF_EACH(-x)
        case LF_ABS: LF_EACH(fabsf(x))
        case LF_EXP: LF_EACH(expf(x))
        case LF_LOG: LF_EACH(logf(x))
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
__device__ __forceinline__ void lf_apply64(int op, const double* a, const double* b, double* o) {
    using T = double;
    switch (op) {
        case LF_ADD: LF_EACH(__dadd_rn(x, y))
        case LF_SUB: LF_EACH(__dsub_rn(x, y))
        case LF_MUL: LF_EACH(__dmul_rn(x, y))
        case LF_DIV: LF_EACH(__ddiv_rn(x, y))
        case LF_POW: LF_EACH(pow(x, y))
        case LF_NEG: LF_EACH(-x)
        case LF_ABS: LF_EACH(fabs(x))
        case LF_EXP: LF_EACH(exp(x))
        case LF_LOG: LF_EACH(log(x))
        case LF_SQRT: LF_EACH(sqrt(x))
        case LF_GT: LF_EACH(x > y ? 1.0 : 0.0)
        case LF_GE: LF_EACH(x >= y ? 1.0 : 0.0)
        case LF_LT: LF_EACH(x < y ? 1.0 : 0.0)
        case LF_LE: LF_EACH(x <= y ? 1.0 : 0.0)
        case LF_EQ: LF_EACH(x == y ? 1.0 : 0.0)
        default: LF_EACH(x != y ? 1.0 : 0.0)
    }
}

// R: the register type; I: the index type (32-bit where every offset fits); VEC: every input is float32 and
// flat, one element, or strided with an innermost stride of 0 or 1 (then every other stride a multiple of 4),
// every output float32, pointers 16-byte aligned, n and the innermost extent multiples of 4. Each thread takes
// LF_V elements a step: LF_THREADS apart (coalesced for each of them), or with VEC 4 consecutive ones moved as
// one float4. Their loads are in flight together, and every instruction is decoded once for all LF_V. Slot s
// of element v of thread t lies at ((s * LF_V + v) * LF_THREADS + t) in shared memory.
template <typename R, typename I, bool VEC>
__global__ void __launch_bounds__(LF_THREADS) lazy_fused_kernel(const LfPlan p) {
    constexpr int V = LF_V;
    extern __shared__ unsigned char lf_smem[];
    R* const r = reinterpret_cast<R*>(lf_smem) + threadIdx.x;
    const I n = static_cast<I>(p.n);
    const I tile = static_cast<I>(LF_THREADS) * V;
    for (I base = static_cast<I>(blockIdx.x) * tile; base < n; base += static_cast<I>(gridDim.x) * tile) {
        I idx[V];
        I coord[LF_MAX_DIMS][V];
        bool live[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
            idx[v] = VEC ? base + static_cast<I>(threadIdx.x) * V + v : base + static_cast<I>(v) * LF_THREADS + threadIdx.x;
            live[v] = idx[v] < n;
        }
        if (p.pad) {  // some input is strided: this step's coordinates, once for every input (VEC: of the quad)
#pragma unroll
            for (int v = 0; v < (VEC ? 1 : V); ++v) {
                I rem = idx[v];
#pragma unroll
                for (int d = LF_MAX_DIMS - 1; d >= 0; --d) {
                    const I ext = static_cast<I>(p.shape[d]);
                    if (ext == 1) {
                        coord[d][v] = 0;
                    } else {
                        coord[d][v] = rem % ext;
                        rem /= ext;
                    }
                }
            }
        }
        for (int k = 0; k < p.n_in; ++k) {
            const LfInput in = p.in[k];
            R* const slot = r + k * V * LF_THREADS;
            if (in.flat == 2) {
                const R val = lf_load<R>(in, 0);
#pragma unroll
                for (int v = 0; v < V; ++v) slot[v * LF_THREADS] = val;
            } else if (VEC) {
                // flat: the quad's float4; strided: the quad lies in one innermost row, its offset from the
                // quad's coordinates: a float4 where the row is contiguous, one element where it broadcasts
                float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
                if (live[0]) {
                    if (in.flat) {
                        q = __ldg(static_cast<const float4*>(in.ptr) + (idx[0] >> 2));
                    } else {
                        I off = 0;
#pragma unroll
                        for (int d = 0; d < LF_MAX_DIMS; ++d) off += coord[d][0] * static_cast<I>(in.stride[d]);
                        if (in.stride[LF_MAX_DIMS - 1]) {
                            q = __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(in.ptr) + off));
                        } else {
                            const float e = __ldg(static_cast<const float*>(in.ptr) + off);
                            q = make_float4(e, e, e, e);
                        }
                    }
                }
                slot[0] = q.x;
                slot[LF_THREADS] = q.y;
                slot[2 * LF_THREADS] = q.z;
                slot[3 * LF_THREADS] = q.w;
            } else {
                I off[V];
#pragma unroll
                for (int v = 0; v < V; ++v) {
                    off[v] = idx[v];
                    if (!in.flat) {
                        off[v] = 0;
#pragma unroll
                        for (int d = 0; d < LF_MAX_DIMS; ++d) off[v] += coord[d][v] * static_cast<I>(in.stride[d]);
                    }
                    if (!live[v]) off[v] = 0;
                }
                switch (in.dtype) {  // decoded once for the LF_V elements
                    case LF_F32: {
                        const float* ptr = static_cast<const float*>(in.ptr);
#pragma unroll
                        for (int v = 0; v < V; ++v) slot[v * LF_THREADS] = static_cast<R>(__ldg(ptr + off[v]));
                        break;
                    }
                    case LF_F64: {
                        const double* ptr = static_cast<const double*>(in.ptr);
#pragma unroll
                        for (int v = 0; v < V; ++v) slot[v * LF_THREADS] = static_cast<R>(__ldg(ptr + off[v]));
                        break;
                    }
                    default: {
                        const unsigned char* ptr = static_cast<const unsigned char*>(in.ptr);
#pragma unroll
                        for (int v = 0; v < V; ++v) slot[v * LF_THREADS] = __ldg(ptr + off[v]) ? R(1) : R(0);
                        break;
                    }
                }
            }
        }
        R acc[V];  // the previous instruction's result, kept in registers
        for (int k = 0; k < p.n_instr; ++k) {
            const LfInstr q = p.ins[k];
            if (q.f64) {
                double a[V], b[V], o[V];
#pragma unroll
                for (int v = 0; v < V; ++v) {
                    a[v] = (q.flags & LF_A_ACC) ? static_cast<double>(acc[v])
                           : q.a >= 0 ? static_cast<double>(r[(q.a * V + v) * LF_THREADS]) : q.imm;
                    b[v] = (q.flags & LF_B_ACC) ? static_cast<double>(acc[v])
                           : q.b >= 0 ? static_cast<double>(r[(q.b * V + v) * LF_THREADS]) : q.imm;
                }
                lf_apply64<V>(q.op, a, b, o);
#pragma unroll
                for (int v = 0; v < V; ++v) acc[v] = static_cast<R>(o[v]);
            } else {
                float a[V], b[V], o[V];
#pragma unroll
                for (int v = 0; v < V; ++v) {
                    a[v] = (q.flags & LF_A_ACC) ? static_cast<float>(acc[v])
                           : q.a >= 0 ? static_cast<float>(r[(q.a * V + v) * LF_THREADS]) : static_cast<float>(q.imm);
                    b[v] = (q.flags & LF_B_ACC) ? static_cast<float>(acc[v])
                           : q.b >= 0 ? static_cast<float>(r[(q.b * V + v) * LF_THREADS]) : static_cast<float>(q.imm);
                }
                lf_apply32<V>(q.op, a, b, o);
#pragma unroll
                for (int v = 0; v < V; ++v) acc[v] = static_cast<R>(o[v]);
            }
            if (q.flags & LF_KEEP) {
#pragma unroll
                for (int v = 0; v < V; ++v) r[(q.dst * V + v) * LF_THREADS] = acc[v];
            }
        }
        for (int k = 0; k < p.n_out; ++k) {
            const LfOutput o = p.out[k];
            const R* const slot = r + o.slot * V * LF_THREADS;
            if (VEC) {
                if (live[0]) {
                    const float4 q = make_float4(static_cast<float>(slot[0]), static_cast<float>(slot[LF_THREADS]),
                                                 static_cast<float>(slot[2 * LF_THREADS]),
                                                 static_cast<float>(slot[3 * LF_THREADS]));
                    static_cast<float4*>(o.ptr)[idx[0] >> 2] = q;
                }
                continue;
            }
            switch (o.dtype) {  // decoded once for the LF_V elements
                case LF_F32:
#pragma unroll
                    for (int v = 0; v < V; ++v)
                        if (live[v]) static_cast<float*>(o.ptr)[idx[v]] = static_cast<float>(slot[v * LF_THREADS]);
                    break;
                case LF_F64:
#pragma unroll
                    for (int v = 0; v < V; ++v)
                        if (live[v]) static_cast<double*>(o.ptr)[idx[v]] = static_cast<double>(slot[v * LF_THREADS]);
                    break;
                default:
#pragma unroll
                    for (int v = 0; v < V; ++v)
                        if (live[v]) static_cast<unsigned char*>(o.ptr)[idx[v]] = slot[v * LF_THREADS] != R(0) ? 1 : 0;
                    break;
            }
        }
    }
}

template <typename R, typename I, bool VEC>
static cudaError_t lf_launch(const LfPlan& plan, int slots, int blocks, cudaStream_t s) {
    const size_t smem = static_cast<size_t>(slots) * LF_V * LF_THREADS * sizeof(R);
    cudaError_t err = cudaFuncSetAttribute(lazy_fused_kernel<R, I, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    lazy_fused_kernel<R, I, VEC><<<blocks, LF_THREADS, smem, s>>>(plan);
    return cudaSuccess;
}

// Launch one segment: `plan` is the host copy (passed by value as the kernel
// argument), `reg64` picks double registers, `idx64` 64-bit indexing, `vec`
// float4 moves (see lazy_fused_kernel), `blocks` the grid. Returns cudaGetLastError() (0 on success).
extern "C" int lazy_fused(const LfPlan* plan, int reg64, int idx64, int vec, int blocks, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (plan->n_in > LF_MAX_IN || plan->n_out > LF_MAX_OUT || plan->n_instr > LF_MAX_INSTR) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int slots = plan->n_in + plan->n_instr;
    if (reg64 && slots > LF_MAX_SLOTS64) return static_cast<int>(cudaErrorInvalidValue);
    if (reg64) {
        if (idx64) err = lf_launch<double, long long, false>(*plan, slots, blocks, s);
        else err = lf_launch<double, unsigned int, false>(*plan, slots, blocks, s);
    } else if (vec) {
        if (idx64) err = lf_launch<float, long long, true>(*plan, slots, blocks, s);
        else err = lf_launch<float, unsigned int, true>(*plan, slots, blocks, s);
    } else {
        if (idx64) err = lf_launch<float, long long, false>(*plan, slots, blocks, s);
        else err = lf_launch<float, unsigned int, false>(*plan, slots, blocks, s);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

// sizeof(LfPlan), for the binding's layout check
extern "C" long long lazy_fused_plan_bytes() { return static_cast<long long>(sizeof(LfPlan)); }

// The most slots a segment on double registers may hold, for the binding's check
extern "C" int lazy_fused_max_slots64() { return LF_MAX_SLOTS64; }
