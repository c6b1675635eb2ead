"""Arithmetic operations (counterpart of ``heat_tpu/core/arithmetics.py``).

Binary ops ride :func:`._operations._binary_op` (promotion, broadcast and
split propagation); ``sum``/``prod``/``nansum``/``nanprod`` ride
:func:`._operations._reduce_op`, ``cumsum``/``cumprod``
:func:`._operations._cum_op`, whose scans are the ``scan_axis`` kernel's
(:mod:`.kernels.scan`). Result types follow ``heat_tpu``, which takes
them from ``jnp``: ``hypot``/``copysign`` compute integers in float, and
``cumsum``/``cumprod`` keep integer types (bool accumulates in int64).
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from . import types
from ._operations import _binary_op, _cum_op, _local_op, _over_axes, _real_only, _reduce_op
from .dndarray import DNDarray
from .kernels.scan import scan_axis
from .stride_tricks import sanitize_axis

__all__ = [
    "add",
    "bitwise_and",
    "bitwise_not",
    "bitwise_or",
    "bitwise_xor",
    "copysign",
    "cumprod",
    "cumproduct",
    "cumsum",
    "diff",
    "div",
    "divide",
    "floor_divide",
    "floordiv",
    "fmod",
    "hypot",
    "invert",
    "left_shift",
    "mod",
    "mul",
    "multiply",
    "nanprod",
    "nansum",
    "neg",
    "negative",
    "pos",
    "positive",
    "pow",
    "power",
    "prod",
    "remainder",
    "right_shift",
    "sub",
    "subtract",
    "sum",
]


def add(t1, t2, out=None, where=True) -> DNDarray:
    """Elementwise addition."""
    return _binary_op(torch.add, t1, t2, out=out, where=where)


def sub(t1, t2, out=None, where=True) -> DNDarray:
    """Elementwise subtraction."""
    return _binary_op(torch.sub, t1, t2, out=out, where=where)


subtract = sub


def mul(t1, t2, out=None, where=True) -> DNDarray:
    """Elementwise multiplication."""
    return _binary_op(torch.mul, t1, t2, out=out, where=where)


multiply = mul


def _true_divide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # integers divide in float as jnp does: int64 in float64, smaller ones in float32
    return torch.true_divide(_inexact(a), _inexact(b))


def div(t1, t2, out=None, where=True) -> DNDarray:
    """Elementwise true division."""
    return _binary_op(_true_divide, t1, t2, out=out, where=where)


divide = div


def floordiv(t1, t2) -> DNDarray:
    """Elementwise floor division (rounds toward minus infinity)."""
    return _binary_op(_real_only(torch.floor_divide, "floor_divide"), t1, t2)


floor_divide = floordiv


def mod(t1, t2) -> DNDarray:
    """Elementwise python-style modulo (the sign of the divisor)."""
    return _binary_op(_real_only(torch.remainder, "mod"), t1, t2)


remainder = mod


def fmod(t1, t2) -> DNDarray:
    """Elementwise C-style remainder (the sign of the dividend)."""
    return _binary_op(_real_only(torch.fmod, "fmod"), t1, t2)


def _inexact(t: torch.Tensor) -> torch.Tensor:
    # jnp computes these in float: int64 in float64, smaller types in float32
    if t.is_floating_point() or t.is_complex():
        return t
    return t.to(torch.float64 if t.dtype == torch.int64 else torch.float32)


def _hypot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.hypot(_inexact(a), _inexact(b))


def _copysign(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.copysign(_inexact(a), _inexact(b))


def hypot(t1, t2) -> DNDarray:
    """Elementwise ``sqrt(t1**2 + t2**2)``."""
    return _binary_op(_real_only(_hypot, "hypot", ValueError), t1, t2)


def copysign(t1, t2) -> DNDarray:
    """Magnitude of ``t1`` with the sign of ``t2``."""
    return _binary_op(_real_only(_copysign, "copysign"), t1, t2)


def pow(t1, t2, out=None, where=True) -> DNDarray:
    """Elementwise exponentiation. An integer base with a negative integer
    scalar exponent raises ``TypeError``, as in ``heat_tpu``."""
    if (
        isinstance(t2, (builtins.int, np.integer))
        and not isinstance(t2, builtins.bool)
        and t2 < 0
        and types.heat_type_is_exact(types.result_type(t1, t2))
    ):
        raise TypeError(f"Integers cannot be raised to negative powers, got exponent {t2}")
    return _binary_op(torch.pow, t1, t2, out=out, where=where)


power = pow


def neg(a, out=None) -> DNDarray:
    """Elementwise negation."""
    if isinstance(a, DNDarray) and a.dtype is types.bool:
        raise TypeError("neg does not accept dtype bool")
    return _local_op(torch.neg, a, out=out, no_cast=True)


negative = neg


def pos(a, out=None) -> DNDarray:
    """Elementwise unary plus: a copy."""
    return _local_op(torch.clone, a, out=out, no_cast=True)


positive = pos


def _check_int_or_bool(*operands) -> None:
    for t in operands:
        if isinstance(t, DNDarray) and not types.heat_type_is_exact(t.dtype):
            raise TypeError(f"Operation not supported for float types, got {t.dtype}")
        if isinstance(t, (builtins.float, complex)):
            raise TypeError("Operation not supported for float scalars")


def bitwise_and(t1, t2) -> DNDarray:
    """Elementwise AND of integer or boolean arrays."""
    _check_int_or_bool(t1, t2)
    return _binary_op(torch.bitwise_and, t1, t2)


def bitwise_or(t1, t2) -> DNDarray:
    """Elementwise OR of integer or boolean arrays."""
    _check_int_or_bool(t1, t2)
    return _binary_op(torch.bitwise_or, t1, t2)


def bitwise_xor(t1, t2) -> DNDarray:
    """Elementwise XOR of integer or boolean arrays."""
    _check_int_or_bool(t1, t2)
    return _binary_op(torch.bitwise_xor, t1, t2)


def invert(a, out=None) -> DNDarray:
    """Elementwise bitwise NOT (logical NOT for bool)."""
    _check_int_or_bool(a)
    return _local_op(torch.bitwise_not, a, out=out, no_cast=True)


bitwise_not = invert


def _int32_if_bool(a: torch.Tensor, b: torch.Tensor):
    # jnp shifts bool operands as int32
    if a.dtype == torch.bool:
        return a.to(torch.int32), b.to(torch.int32)
    return a, b


def _left_shift(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.bitwise_left_shift(*_int32_if_bool(a, b))


def _right_shift(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.bitwise_right_shift(*_int32_if_bool(a, b))


def left_shift(t1, t2) -> DNDarray:
    """Elementwise ``t1 << t2`` of integer or boolean arrays."""
    _check_int_or_bool(t1, t2)
    return _binary_op(_left_shift, t1, t2)


def right_shift(t1, t2) -> DNDarray:
    """Elementwise ``t1 >> t2`` of integer or boolean arrays."""
    _check_int_or_bool(t1, t2)
    return _binary_op(_right_shift, t1, t2)


def _cumsum(t: torch.Tensor, axis: int) -> torch.Tensor:
    return scan_axis(t, axis, "add")


def _cumprod(t: torch.Tensor, axis: int) -> torch.Tensor:
    return scan_axis(t, axis, "mul")


# the scan each op runs: _cum_op's split-axis route calls the kernel's two steps with it
_cumsum.scan_op = "add"
_cumprod.scan_op = "mul"


def cumsum(a: DNDarray, axis: int, dtype=None, out=None) -> DNDarray:
    """Cumulative sum along ``axis``."""
    return _cum_op(_cumsum, a, axis, out=out, dtype=dtype)


def cumprod(a: DNDarray, axis: int, dtype=None, out=None) -> DNDarray:
    """Cumulative product along ``axis``."""
    return _cum_op(_cumprod, a, axis, out=out, dtype=dtype)


cumproduct = cumprod


def diff(a: DNDarray, n: int = 1, axis: int = -1, prepend=None, append=None) -> DNDarray:
    """The n-th discrete difference along ``axis``; a scalar ``prepend`` or
    ``append`` is broadcast to one slice along ``axis``. Along a non-split
    axis every rank differences its chunk. Along the split axis the
    operands are joined first (``concatenate``, which keeps the ceil-div
    layout), and each rank fetches the rows of its result chunk plus the
    ``n`` rows after them from the ranks that hold them (one ``alltoall``:
    the halo, and the rows the shorter result's layout shifts), never the
    whole array."""
    if n == 0:
        return a
    if n < 0:
        raise ValueError(f"diff requires that n be a positive number, got {n}")
    axis = sanitize_axis(a.shape, axis)
    tt = types._weak_result_type(a, *(v for v in (prepend, append) if v is not None)).torch_type()
    comm = a.comm

    def _edge(v):
        if v is None:
            return None
        t = v._logical() if isinstance(v, DNDarray) else torch.as_tensor(v, device=a.larray.device)
        if t.ndim == 0:
            shape = list(a.shape)
            shape[axis] = 1
            t = t.expand(shape)
        return t.to(tt)

    if a.split is None or not comm.is_distributed() or axis != a.split:
        chunk = list(comm.chunk(a.gshape, a.split)[2])
        chunk[axis] = slice(None)

        def _local_edge(v):
            t = _edge(v)
            return None if t is None else t[tuple(chunk)]

        result = torch.diff(a.larray.to(tt), n=n, dim=axis, prepend=_local_edge(prepend), append=_local_edge(append))
        gshape = list(a.gshape)
        gshape[axis] = result.shape[axis]
        return DNDarray(result, gshape=tuple(gshape), dtype=types.canonical_heat_type(result.dtype), split=a.split,
                        device=a.device, comm=comm)
    from . import manipulations
    from ._movement import take_intervals

    parts = [DNDarray(e, dtype=types.canonical_heat_type(tt), split=None, device=a.device, comm=comm)
             for e in (_edge(prepend),) if e is not None]
    parts.append(a.astype(types.canonical_heat_type(tt)))
    parts += [DNDarray(e, dtype=types.canonical_heat_type(tt), split=None, device=a.device, comm=comm)
              for e in (_edge(append),) if e is not None]
    full = manipulations.concatenate(parts, axis=axis) if len(parts) > 1 else parts[0]
    gshape = list(full.gshape)
    gshape[axis] = max(0, gshape[axis] - n)

    def want(r):
        lo, sh, _ = comm.chunk(tuple(gshape), axis, rank=r)
        return [(lo, lo + sh[axis] + n)] if sh[axis] else []

    got = take_intervals(full.larray, full.gshape, axis, want, comm)
    if got:
        result = torch.diff(got[0], n=n, dim=axis)
    else:
        shape = list(full.lshape)
        shape[axis] = 0
        result = full.larray.new_empty(shape)
    return DNDarray(result, gshape=tuple(gshape), dtype=types.canonical_heat_type(result.dtype), split=a.split,
                    device=a.device, comm=comm)


def _int_to_int64(x: DNDarray):
    # sum/prod accumulate bool and small ints in int64 (torch semantics); half types keep their own
    if types.heat_type_is_exact(x.dtype) and x.dtype is not types.int64:
        return types.int64
    if x.dtype in (types.float16, types.bfloat16):
        return x.dtype
    return None


def _sum(t: torch.Tensor, axis, keepdims: bool) -> torch.Tensor:
    if t.dtype in (torch.float16, torch.bfloat16):
        # half data accumulates in float32, across ranks too; the caller rounds the result once
        return _over_axes(lambda u, **kw: torch.sum(u, dtype=torch.float32, **kw), t, axis, keepdims)
    return _over_axes(torch.sum, t, axis, keepdims)


def _prod(t: torch.Tensor, axis, keepdims: bool) -> torch.Tensor:
    if axis is None:
        r = torch.prod(t)
        return r.reshape((1,) * t.ndim) if keepdims else r
    for a in sorted((axis,) if isinstance(axis, builtins.int) else axis, reverse=True):
        t = torch.prod(t, dim=a, keepdim=keepdims)
    return t


def _nansum(t: torch.Tensor, axis, keepdims: bool) -> torch.Tensor:
    if not t.is_floating_point():
        return _sum(t, axis, keepdims)
    return _over_axes(torch.nansum, t, axis, keepdims)


def _nanprod(t: torch.Tensor, axis, keepdims: bool) -> torch.Tensor:
    if t.is_floating_point():
        t = torch.where(torch.isnan(t), torch.ones((), dtype=t.dtype, device=t.device), t)
    return _prod(t, axis, keepdims)


def _merge_keepdim(keepdim, keepdims) -> bool:
    return builtins.bool(keepdim) if keepdim is not None else builtins.bool(keepdims)


def sum(a: DNDarray, axis=None, out=None, keepdim=None, keepdims=None) -> DNDarray:
    """Sum over axis."""
    return _reduce_op(
        _sum, a, axis=axis, out=out, keepdims=_merge_keepdim(keepdim, keepdims), out_dtype=_int_to_int64(a)
    )


def prod(a: DNDarray, axis=None, out=None, keepdim=None, keepdims=None) -> DNDarray:
    """Product over axis."""
    return _reduce_op(
        _prod, a, axis=axis, out=out, keepdims=_merge_keepdim(keepdim, keepdims), out_dtype=_int_to_int64(a)
    )


def nansum(a: DNDarray, axis=None, out=None, keepdim=None, keepdims=None) -> DNDarray:
    """Sum over axis, NaNs counted as zero."""
    return _reduce_op(_nansum, a, axis=axis, out=out, keepdims=_merge_keepdim(keepdim, keepdims))


def nanprod(a: DNDarray, axis=None, out=None, keepdim=None, keepdims=None) -> DNDarray:
    """Product over axis, NaNs counted as one."""
    return _reduce_op(_nanprod, a, axis=axis, out=out, keepdims=_merge_keepdim(keepdim, keepdims))
