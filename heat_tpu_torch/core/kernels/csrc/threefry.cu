// threefry_bits: counter-based random bits, threefry-2x32 (20 rounds), at
// the global flat indices of one rank's chunk of a draw, and optionally
// their conversion to uniform or normal floats, in one pass.
//
// Replaces no Pallas kernel. heat_tpu draws through jax.random with
// jax_threefry_partitionable on (heat_tpu/core/random.py:29, :79-84), which
// XLA fuses into one pass on the TPU; in torch eager the same arithmetic
// would be about a hundred passes over int64 temporaries. The bits are
// jax's: element i of a draw of key (k0, k1) is threefry2x32(k, (i >> 32,
// i & 0xFFFFFFFF)) = (x0, x1), whose 32-bit bits are x0 ^ x1 and 64-bit
// bits (x0 << 32) | x1.
//
// Bound on an H100: bytes written in principle (nothing is read), but the
// 20 rounds are ~70 dependent 32-bit integer operations per element, so
// the integer pipes bind first. One element per thread per step of a
// grid-stride loop: neighbouring threads write neighbouring words.
//
// Layout: element (o, t) of the rank's chunk, o < rows, t < cols, stored at
// o * cols + t, has global index base + o * row_stride + t. A chunk of a
// draw split along its leading axis is one row; a chunk of a draw split
// along another axis is one row per index of the axes before it.
//
// The uniform kinds follow jax's _uniform: mantissa bits under an exponent
// of 0 give f in [1, 2), then u = max(lo, (f - 1) * scale + lo), with the
// product and the sum rounded separately (__fmul_rn / __fadd_rn are never
// contracted into an fma), as XLA computes them. The normal kinds follow
// jax's _normal_real: sqrt(2) * erfinv(u), with XLA's erfinv (Giles'
// polynomials in w = -log1p(-u^2), the coefficients of threefry.py's
// _ERFINV32 / _ERFINV64), each product and sum rounded on its own as the
// plain version's torch operations round them.
//
// The 16-bit kinds follow jax's _uniform for float16 and bfloat16: float16
// draws 16-bit words (the low half of x0 ^ x1) and takes their top 10 bits
// as the mantissa; bfloat16 draws 8-bit words (the low byte; jax widens
// the word where the mantissa has fewer than 8 bits) and takes their top 7.
// Every operation after that is rounded to the 16-bit type, as XLA rounds
// it: each is computed in float32 and rounded once, which is the IEEE
// 16-bit result because float32's 24 bits are at least 2p + 2 for p = 11
// and p = 8. A 16-bit normal is round(round(erfinv32(u)) * round(sqrt 2)).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

enum Kind {
    kBits32 = 0, kBits64 = 1, kUniform32 = 2, kUniform64 = 3, kNormal32 = 4, kNormal64 = 5,
    kUniform16 = 6, kNormal16 = 7, kUniformBf16 = 8, kNormalBf16 = 9
};

__constant__ float kErfinv32Lt5[9] = {2.81022636e-08f, 3.43273939e-07f, -3.5233877e-06f, -4.39150654e-06f,
                                      0.00021858087f, -0.00125372503f, -0.00417768164f, 0.246640727f, 1.50140941f};
__constant__ float kErfinv32Ge5[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f, -0.00367342844f,
                                      0.00573950773f, -0.0076224613f, 0.00943887047f, 1.00167406f, 2.83297682f};
__constant__ double kErfinv64Lt625[23] = {
    -3.6444120640178196996e-21, -1.685059138182016589e-19, 1.2858480715256400167e-18, 1.115787767802518096e-17,
    -1.333171662854620906e-16,  2.0972767875968561637e-17, 6.6376381343583238325e-15, -4.0545662729752068639e-14,
    -8.1519341976054721522e-14, 2.6335093153082322977e-12, -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09,   -4.1126339803469836976e-09, -2.9070369957882005086e-08, 4.2347877827932403518e-07,
    -1.3654692000834678645e-06, -1.3882523362786468719e-05, 0.0001867342080340571352, -0.00074070253416626697512,
    -0.0060336708714301490533,  0.24015818242558961693, 1.6536545626831027356};
__constant__ double kErfinv64Lt16[19] = {
    2.2137376921775787049e-09,  9.0756561938885390979e-08, -2.7517406297064545428e-07, 1.8239629214389227755e-08,
    1.5027403968909827627e-06,  -4.013867526981545969e-06, 2.9234449089955446044e-06,  1.2475304481671778723e-05,
    -4.7318229009055733981e-05, 6.8284851459573175448e-05, 2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703,  -0.0016882755560235047313, 0.0024914420961078508066,  -0.0037512085075692412107,
    0.005370914553590063617,    1.0052589676941592334,     3.0838856104922207635};
__constant__ double kErfinv64Ge16[17] = {
    -2.7109920616438573243e-11, -2.5556418169965252055e-10, 1.5076572693500548083e-09, -3.7894654401267369937e-09,
    7.6157012080783393804e-09,  -1.4960026627149240478e-08, 2.9147953450901080826e-08, -6.7711997758452339498e-08,
    2.2900482228026654717e-07,  -9.9298272942317002539e-07, 4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05,  -0.00021503011930044477347, -0.00013871931833623122026, 1.0103004648645343977,
    4.8499064014085844221};

__device__ __forceinline__ float horner32(const float* c, int n, float t) {
    float q = c[0];
    for (int i = 1; i < n; ++i) q = __fadd_rn(__fmul_rn(q, t), c[i]);
    return q;
}

__device__ __forceinline__ double horner64(const double* c, int n, double t) {
    double q = c[0];
    for (int i = 1; i < n; ++i) q = __dadd_rn(__dmul_rn(q, t), c[i]);
    return q;
}

// erfinv(u) for |u| < 1, float32
__device__ __forceinline__ float erfinv32(float u) {
    const float w = -log1pf(-__fmul_rn(u, u));
    const float p = w < 5.0f ? horner32(kErfinv32Lt5, 9, __fsub_rn(w, 2.5f))
                             : horner32(kErfinv32Ge5, 9, __fsub_rn(__fsqrt_rn(w), 3.0f));
    return __fmul_rn(p, u);
}

// sqrt(2) * erfinv(u) for |u| < 1
__device__ __forceinline__ float normal32(float u) { return __fmul_rn(erfinv32(u), 1.41421356f); }

// x rounded to float16 (HALF) or bfloat16, as a float
template <bool HALF>
__device__ __forceinline__ float round16(float x) {
    return HALF ? __half2float(__float2half_rn(x)) : __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ double normal64(double u) {
    const double w = -log1p(-__dmul_rn(u, u));
    double p;
    if (w < 6.25) {
        p = horner64(kErfinv64Lt625, 23, __dsub_rn(w, 3.125));
    } else if (w < 16.0) {
        p = horner64(kErfinv64Lt16, 19, __dsub_rn(__dsqrt_rn(w), 3.25));
    } else {
        p = horner64(kErfinv64Ge16, 17, __dsub_rn(__dsqrt_rn(w), 5.0));
    }
    return __dmul_rn(__dmul_rn(p, u), 1.4142135623730951);
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
    const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
    x0 += k0;
    x1 += k1;
#define TF_ROUND(r) \
    x0 += x1;       \
    x1 = rotl(x1, r); \
    x1 ^= x0;
#define TF_FOUR_A TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_FOUR_B TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
    TF_FOUR_A x0 += k1; x1 += k2 + 1u;
    TF_FOUR_B x0 += k2; x1 += k0 + 2u;
    TF_FOUR_A x0 += k0; x1 += k1 + 3u;
    TF_FOUR_B x0 += k1; x1 += k2 + 4u;
    TF_FOUR_A x0 += k2; x1 += k0 + 5u;
#undef TF_FOUR_B
#undef TF_FOUR_A
#undef TF_ROUND
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
threefry_kernel(void* __restrict__ out, uint32_t k0, uint32_t k1, long long base, long long row_stride,
                long long rows, long long cols, double lo, double scale) {
    const long long n = rows * cols;
    const long long step = (long long)gridDim.x * kThreads;
    for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n; e += step) {
        long long idx = base + e;
        if (rows > 1) {
            const long long o = e / cols;
            idx = base + o * row_stride + (e - o * cols);
        }
        uint32_t x0 = (uint32_t)((unsigned long long)idx >> 32);
        uint32_t x1 = (uint32_t)((unsigned long long)idx & 0xFFFFFFFFull);
        threefry2x32(k0, k1, x0, x1);
        if (KIND == kBits32) {
            static_cast<uint32_t*>(out)[e] = x0 ^ x1;
        } else if (KIND == kBits64) {
            static_cast<unsigned long long*>(out)[e] = ((unsigned long long)x0 << 32) | x1;
        } else if (KIND == kUniform32 || KIND == kNormal32) {
            const float f = __uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u) - 1.0f;
            const float lo_f = (float)lo;
            const float u = fmaxf(lo_f, __fadd_rn(__fmul_rn(f, (float)scale), lo_f));
            static_cast<float*>(out)[e] = KIND == kUniform32 ? u : normal32(u);
        } else if (KIND == kUniform16 || KIND == kNormal16 || KIND == kUniformBf16 || KIND == kNormalBf16) {
            constexpr bool kHalf = KIND == kUniform16 || KIND == kNormal16;
            const uint32_t b = x0 ^ x1;
            const float f = kHalf ? __half2float(__ushort_as_half((unsigned short)(((b & 0xFFFFu) >> 6) | 0x3C00u))) - 1.0f
                                  : __bfloat162float(__ushort_as_bfloat16((unsigned short)(((b & 0xFFu) >> 1) | 0x3F80u))) -
                                        1.0f;
            const float lo_f = (float)lo;
            float r = fmaxf(lo_f, round16<kHalf>(__fadd_rn(round16<kHalf>(__fmul_rn(f, (float)scale)), lo_f)));
            if (KIND == kNormal16 || KIND == kNormalBf16) {
                r = round16<kHalf>(__fmul_rn(round16<kHalf>(erfinv32(r)), round16<kHalf>(1.41421356f)));
            }
            static_cast<unsigned short*>(out)[e] =
                kHalf ? __half_as_ushort(__float2half_rn(r)) : __bfloat16_as_ushort(__float2bfloat16_rn(r));
        } else {
            const unsigned long long b = ((unsigned long long)x0 << 32) | x1;
            const double f = __longlong_as_double((long long)((b >> 12) | 0x3FF0000000000000ull)) - 1.0;
            const double u = fmax(lo, __dadd_rn(__dmul_rn(f, scale), lo));
            static_cast<double*>(out)[e] = KIND == kUniform64 ? u : normal64(u);
        }
    }
}

}  // namespace

// Fill out (rows * cols elements of the kind's type: uint32, uint64, float,
// double, float16 or bfloat16) on `stream` with `blocks` blocks of kThreads threads. Returns the
// launch's CUDA error code (0 on success).
extern "C" int threefry_fill(void* out, int kind, unsigned int k0, unsigned int k1, long long base,
                             long long row_stride, long long rows, long long cols, double lo, double scale,
                             int blocks, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (kind) {
        case kBits32:
            threefry_kernel<kBits32><<<blocks, kThreads, 0, s>>>(out, k0, k1, base, row_stride, rows, cols, lo, scale);
            break;
        case kBits64:
            threefry_kernel<kBits64><<<blocks, kThreads, 0, s>>>(out, k0, k1, base, row_stride, rows, cols, lo, scale);
            break;
        case kUniform32:
            threefry_kernel<kUniform32><<<blocks, kThreads, 0, s>>>(out, k0, k1, base, row_stride, rows, cols, lo,
                                                                     scale);
            break;
        case kUniform64:
            threefry_kernel<kUniform64><<<blocks, kThreads, 0, s>>>(out, k0, k1, base, row_stride, rows, cols, lo,
                                                                     scale);
            break;
        case kNormal32:
            threefry_kernel<kNormal32><<<blocks, kThreads, 0, s>>>(out, k0, k1, base, row_stride, rows, cols, lo,
                                                                    scale);
            break;
        case kNormal64:
            threefry_kernel<kNormal64><<<blocks, kThreads, 0, s>>>(out, k0, k1, base, row_stride, rows, cols, lo,
                                                                    scale);
            break;
#define TF_LAUNCH16(K) \
        case K:          \
            threefry_kernel<K><<<blocks, kThreads, 0, s>>>(out, k0, k1, base, row_stride, rows, cols, lo, scale); \
            break;
        TF_LAUNCH16(kUniform16)
        TF_LAUNCH16(kNormal16)
        TF_LAUNCH16(kUniformBf16)
        TF_LAUNCH16(kNormalBf16)
#undef TF_LAUNCH16
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
