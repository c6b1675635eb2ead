"""Arithmetic operations (counterpart of ``heat_tpu/core/arithmetics.py``).

Binary ops ride :func:`._operations._binary_op` (promotion, broadcast and
split propagation); ``sum``/``prod`` ride :func:`._operations._reduce_op`.
"""
from __future__ import annotations

import torch

from . import types
from ._operations import _binary_op, _local_op, _reduce_op
from .dndarray import DNDarray

__all__ = [
    "add",
    "div",
    "mul",
    "neg",
    "pow",
    "prod",
    "sub",
    "sum",
]


def add(t1, t2, out=None, where=True) -> DNDarray:
    """Elementwise addition."""
    return _binary_op(torch.add, t1, t2, out=out, where=where)


def sub(t1, t2, out=None, where=True) -> DNDarray:
    """Elementwise subtraction."""
    return _binary_op(torch.sub, t1, t2, out=out, where=where)


def mul(t1, t2, out=None, where=True) -> DNDarray:
    """Elementwise multiplication."""
    return _binary_op(torch.mul, t1, t2, out=out, where=where)


def div(t1, t2, out=None, where=True) -> DNDarray:
    """Elementwise true division."""
    return _binary_op(torch.true_divide, t1, t2, out=out, where=where)


def pow(t1, t2, out=None, where=True) -> DNDarray:
    """Elementwise exponentiation."""
    return _binary_op(torch.pow, t1, t2, out=out, where=where)


def neg(a, out=None) -> DNDarray:
    """Elementwise negation."""
    return _local_op(torch.neg, a, out=out, no_cast=True)


def _int_to_int64(x: DNDarray):
    # sum/prod accumulate bool and small ints in int64 (torch semantics)
    if types.heat_type_is_exact(x.dtype) and x.dtype is not types.int64:
        return types.int64
    return None


def _sum(t: torch.Tensor, axis, keepdims: bool) -> torch.Tensor:
    if axis is None:
        r = torch.sum(t)
        return r.reshape((1,) * t.ndim) if keepdims else r
    return torch.sum(t, dim=axis, keepdim=keepdims)


def _prod(t: torch.Tensor, axis, keepdims: bool) -> torch.Tensor:
    if axis is None:
        r = torch.prod(t)
        return r.reshape((1,) * t.ndim) if keepdims else r
    for a in sorted((axis,) if isinstance(axis, int) else axis, reverse=True):
        t = torch.prod(t, dim=a, keepdim=keepdims)
    return t


def _merge_keepdim(keepdim, keepdims) -> bool:
    return bool(keepdim) if keepdim is not None else bool(keepdims)


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
