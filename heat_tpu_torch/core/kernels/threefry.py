"""Threefry-2x32 random bits at global indices: the counter-based generator
behind ``heat_tpu_torch.random``, with jax's partitionable bit layout.

- :func:`threefry2x32` — the 20-round hash on a key ``(k0, k1)`` and a
  counter ``(x0, x1)``; the same code runs on python ints (key derivation,
  scalar draws) and on int64 tensors holding 32-bit words (the plain
  version).
- :func:`threefry_bits` — the wrapper. It fills one rank's chunk of a draw:
  element ``(o, t)`` of a ``rows x cols`` chunk has the global flat index
  ``base + o * row_stride + t`` (:func:`chunk_layout`), and its bits are
  those of that index alone, so a chunk is computed without the rest of the
  draw. On a CUDA device it launches ``csrc/threefry.cu``, which also turns
  the bits into uniform floats in the same pass; on the CPU it runs
  :func:`threefry_plain`. It never falls back: a CUDA device gets the
  kernel or an error.
- :func:`threefry_plain` — the plain version: the same arithmetic in torch
  int64 operations, masked to 32 bits, in blocks of at most 2^22 elements.

Kinds: ``"bits32"`` (int32 tensor holding the uint32 bits ``x0 ^ x1``),
``"bits64"`` (int64 tensor holding the uint64 bits ``(x0 << 32) | x1``),
``"uniform32"`` / ``"uniform64"`` (``u = max(lo, (f - 1) * scale + lo)``
with ``f`` in [1, 2) from the top 23 / 52 bits, as jax's ``_uniform``),
``"normal32"`` / ``"normal64"`` (``sqrt(2) * erfinv(u)`` of that ``u``, as
jax's ``_normal_real``, with XLA's erfinv: Giles' polynomials in
``w = -log1p(-u^2)``, :func:`_erf_inv`), and the 16-bit kinds
``"uniform16"`` / ``"normal16"`` (float16) and ``"uniformbf16"`` /
``"normalbf16"`` (bfloat16). jax draws narrower words for these: float16
takes the low 16 bits of ``x0 ^ x1`` and its top 10 as the mantissa;
bfloat16 takes only the low 8 bits (jax's ``_uniform`` draws 8-bit words
where the mantissa has fewer than 8 bits) and their top 7. Every
operation after that rounds to the 16-bit type, as XLA computes them:
``u = max(lo, round(round(f * scale) + lo))``, and a normal is
``round(round(erfinv(u)) * round(sqrt(2)))`` with the float32 erfinv
(XLA's 16-bit erf_inv is the float32 one, rounded once). A float32
product or sum of two 16-bit values rounded once to 16 bits is the
IEEE 16-bit result (float32's 24 bits are at least 2p + 2 for p = 11 and
p = 8), so the plain version and the kernel compute in float32 and round
after each operation.

This is not a port of a TPU kernel: XLA fuses threefry into one pass on
the TPU. Bound on the card: the bytes written (3.35 TB/s), though the
integer rounds (~70 operations per element) bind first.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ._dispatch import count_launch, register_kernel

__all__ = ["THREEFRY_KERNEL", "chunk_layout", "threefry2x32", "threefry_bits", "threefry_plain"]

THREEFRY_KERNEL = register_kernel(
    "threefry_bits",
    comparator="threefry_plain (plain torch int64 threefry-2x32 in blocks of 2^22, the same float conversion)",
    roofline="bytes written (nothing read); ~70 integer operations per element bind first",
    replaces="none: jax.random threefry-2x32 (partitionable), fused by XLA — heat_tpu/core/random.py:79",
)

KINDS = {"bits32": (0, torch.int32), "bits64": (1, torch.int64), "uniform32": (2, torch.float32),
         "uniform64": (3, torch.float64), "normal32": (4, torch.float32), "normal64": (5, torch.float64),
         "uniform16": (6, torch.float16), "normal16": (7, torch.float16), "uniformbf16": (8, torch.bfloat16),
         "normalbf16": (9, torch.bfloat16)}
# 16-bit kinds: (type, mask of the word jax draws, shift of its mantissa bits, bits of 1.0)
_HALF = {"16": (torch.float16, 0xFFFF, 6, 0x3C00), "bf16": (torch.bfloat16, 0xFF, 1, 0x3F80)}
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_BLOCK = 1 << 22  # elements per block of the plain version
_THREADS = 256  # threads per block of csrc/threefry.cu
_lib = None

Layout = Tuple[int, int, int, int]  # (base, row_stride, rows, cols)


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds: the key ``(k0, k1)`` (python ints) and
    the counter words ``(x0, x1)`` (python ints, or int64 tensors of values
    below 2^32) to the output words ``(y0, y1)``."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def chunk_layout(shape, split, offset: int, length: int) -> Layout:
    """``(base, row_stride, rows, cols)`` of the chunk ``[offset, offset +
    length)`` along axis ``split`` of a draw of ``shape`` (the whole draw
    when ``split`` is None): its elements in row-major order are rows of
    ``cols`` consecutive global flat indices, ``row_stride`` apart."""
    shape = tuple(int(s) for s in shape)
    if split is None:
        return 0, 0, 1, int(np.prod(shape, dtype=np.int64))
    inner = int(np.prod(shape[split + 1 :], dtype=np.int64))
    outer = int(np.prod(shape[:split], dtype=np.int64))
    return offset * inner, shape[split] * inner, outer, length * inner


# XLA's erf_inv (M. Giles, "Approximating the erfinv function", GPU Computing Gems, 2011): Horner
# coefficients, highest degree first, of a polynomial in a shifted w or sqrt(w); the float32 version has
# two branches (w < 5 and above), the float64 version three (w < 6.25, w < 16 and above). csrc/threefry.cu
# holds the same numbers.
_ERFINV32 = (
    (5.0, 2.5, (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087, -0.00125372503,
                -0.00417768164, 0.246640727, 1.50140941)),
    (None, 3.0, (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)),
)
_ERFINV64 = (
    (6.25, 3.125, (-3.6444120640178196996e-21, -1.685059138182016589e-19, 1.2858480715256400167e-18,
                   1.115787767802518096e-17, -1.333171662854620906e-16, 2.0972767875968561637e-17,
                   6.6376381343583238325e-15, -4.0545662729752068639e-14, -8.1519341976054721522e-14,
                   2.6335093153082322977e-12, -1.2975133253453532498e-11, -5.4154120542946279317e-11,
                   1.051212273321532285e-09, -4.1126339803469836976e-09, -2.9070369957882005086e-08,
                   4.2347877827932403518e-07, -1.3654692000834678645e-06, -1.3882523362786468719e-05,
                   0.0001867342080340571352, -0.00074070253416626697512, -0.0060336708714301490533,
                   0.24015818242558961693, 1.6536545626831027356)),
    (16.0, 3.25, (2.2137376921775787049e-09, 9.0756561938885390979e-08, -2.7517406297064545428e-07,
                  1.8239629214389227755e-08, 1.5027403968909827627e-06, -4.013867526981545969e-06,
                  2.9234449089955446044e-06, 1.2475304481671778723e-05, -4.7318229009055733981e-05,
                  6.8284851459573175448e-05, 2.4031110387097893999e-05, -0.0003550375203628474796,
                  0.00095328937973738049703, -0.0016882755560235047313, 0.0024914420961078508066,
                  -0.0037512085075692412107, 0.005370914553590063617, 1.0052589676941592334,
                  3.0838856104922207635)),
    (None, 5.0, (-2.7109920616438573243e-11, -2.5556418169965252055e-10, 1.5076572693500548083e-09,
                 -3.7894654401267369937e-09, 7.6157012080783393804e-09, -1.4960026627149240478e-08,
                 2.9147953450901080826e-08, -6.7711997758452339498e-08, 2.2900482228026654717e-07,
                 -9.9298272942317002539e-07, 4.5260625972231537039e-06, -1.9681778105531670567e-05,
                 7.5995277030017761139e-05, -0.00021503011930044477347, -0.00013871931833623122026,
                 1.0103004648645343977, 4.8499064014085844221)),
)


def _erf_inv(u: torch.Tensor) -> torch.Tensor:
    """XLA's ``erf_inv`` for |u| < 1 in torch operations: with
    ``w = -log1p(-u^2)``, branch b's polynomial in ``w - shift`` (first
    branch) or ``sqrt(w) - shift`` (the others), times ``u``. It differs
    from XLA's result in the last bits, mostly where the two ``log1p``
    round differently."""
    w = -torch.log1p(-(u * u))
    sw = torch.sqrt(w)
    branches = _ERFINV32 if u.dtype == torch.float32 else _ERFINV64
    p = None
    for b, (below, shift, coeffs) in reversed(list(enumerate(branches))):
        t = (w if b == 0 else sw) - shift
        q = torch.full_like(u, coeffs[0])
        for c in coeffs[1:]:
            q = q * t + c
        p = q if p is None else torch.where(w < below, q, p)
    return p * u


def _convert(x0: torch.Tensor, x1: torch.Tensor, kind: str, lo: float, scale: float) -> torch.Tensor:
    if kind == "bits32":
        b = x0 ^ x1
        return torch.where(b >= 1 << 31, b - (1 << 32), b).to(torch.int32)
    # (x0 << 32) | x1 as an int64 bit pattern: x0 - 2^32 where its top bit is set, times 2^32, cannot overflow
    if kind == "bits64":
        return torch.where(x0 >= 1 << 31, x0 - (1 << 32), x0) * (1 << 32) | x1
    half = _HALF.get(kind[6:] if kind.startswith("normal") else kind[7:])
    if half is not None:
        return _convert16(x0 ^ x1, kind, half, lo, scale)
    if kind.endswith("32"):
        f = ((((x0 ^ x1) >> 9) | 0x3F800000).to(torch.int32)).view(torch.float32) - 1.0
    else:
        f = ((x0 << 20) | (x1 >> 12) | 0x3FF0000000000000).view(torch.float64) - 1.0
    u = torch.clamp(f * scale + lo, min=lo)
    if kind.startswith("uniform"):
        return u
    return _erf_inv(u) * float(np.sqrt(2).astype(np.float32 if kind == "normal32" else np.float64))


def _convert16(b: torch.Tensor, kind: str, half, lo: float, scale: float) -> torch.Tensor:
    """The 16-bit kinds of :func:`_convert` from the 32-bit words ``b``:
    float32 arithmetic rounded to the 16-bit type after each operation."""
    dt, mask, shift, one = half

    def rnd(t):
        return t.to(dt).to(torch.float32)

    f = ((((b & mask) >> shift) | one).to(torch.int16)).view(dt).to(torch.float32) - 1.0  # exact
    lo_t = torch.tensor(lo, dtype=torch.float32)
    u = torch.maximum(lo_t, rnd(rnd(f * scale) + lo_t))
    if kind.startswith("normal"):
        u = rnd(rnd(_erf_inv(u)) * rnd(torch.tensor(float(np.sqrt(2)), dtype=torch.float32)))
    return u.to(dt)


def threefry_plain(key, layout: Layout, kind: str, device=None, lo: float = 0.0, scale: float = 1.0) -> torch.Tensor:
    """The plain version of :func:`threefry_bits`: the chunk's
    ``rows * cols`` values (flat) on ``device``, computed in blocks of at
    most 2^22 elements."""
    base, row_stride, rows, cols = layout
    n = rows * cols
    out = torch.empty(n, dtype=KINDS[kind][1], device=device)
    k0, k1 = int(key[0]), int(key[1])
    for e0 in range(0, n, _BLOCK):
        e = torch.arange(e0, min(e0 + _BLOCK, n), dtype=torch.int64, device=device)
        o = torch.div(e, cols, rounding_mode="floor")
        idx = base + o * row_stride + (e - o * cols)
        y0, y1 = threefry2x32(k0, k1, idx >> 32, idx & _M32)
        out[e0 : e0 + e.numel()] = _convert(y0, y1, kind, lo, scale)
    return out


def _library():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("threefry")
        p, i32, u32, i64, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_longlong, ctypes.c_double
        lib.threefry_fill.argtypes = [p, i32, u32, u32, i64, i64, i64, i64, f64, f64, i32, p]
        lib.threefry_fill.restype = ctypes.c_int
        _lib = lib
    return _lib


def _threefry_cuda(key, layout: Layout, kind: str, device: torch.device, lo: float, scale: float) -> torch.Tensor:
    base, row_stride, rows, cols = layout
    n = rows * cols
    out = torch.empty(n, dtype=KINDS[kind][1], device=device)
    if n == 0:
        return out
    index = device.index if device.index is not None else torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    blocks = int(min(-(-n // _THREADS), sms * 32))
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _library().threefry_fill(out.data_ptr(), KINDS[kind][0], int(key[0]), int(key[1]), base, row_stride, rows,
                                   cols, float(lo), float(scale), blocks, stream)
    if err != 0:
        raise RuntimeError(f"threefry_bits kernel launch failed with CUDA error {err}")
    count_launch(THREEFRY_KERNEL)
    return out


def threefry_bits(key, layout: Layout, kind: str, device, lo: float = 0.0, scale: float = 1.0) -> torch.Tensor:
    """One rank's chunk of a draw of key ``(k0, k1)``, flat, on ``device``:
    the kernel on a CUDA device, :func:`threefry_plain` on the CPU. ``lo``
    and ``scale`` are the uniform kinds' offset and width, exact in their
    float type."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {sorted(KINDS)}, got {kind!r}")
    device = torch.device(device)
    if device.type == "cuda":
        return _threefry_cuda(key, layout, kind, device, lo, scale)
    if device.type != "cpu":
        raise ValueError(f"threefry_bits supports CUDA and CPU devices, got {device}")
    return threefry_plain(key, layout, kind, device, lo, scale)
