"""Logical operations (counterpart of ``heat_tpu/core/logical.py``).

``all``/``any`` reduce over :func:`._operations._reduce_op` to bool;
``isclose``/``allclose`` keep ``heat_tpu``'s defaults (``rtol=1e-05``,
``atol=1e-08``) and, as ``jnp`` does, compare integers in float64.
"""
from __future__ import annotations

import torch

from . import types
from ._operations import _binary_op, _local_op, _over_axes, _real_only, _reduce_op
from .dndarray import DNDarray

__all__ = [
    "all",
    "allclose",
    "any",
    "isclose",
    "isfinite",
    "isinf",
    "isnan",
    "isneginf",
    "isposinf",
    "logical_and",
    "logical_not",
    "logical_or",
    "logical_xor",
    "signbit",
]


def _all(t: torch.Tensor, axis, keepdims: bool) -> torch.Tensor:
    return _over_axes(torch.all, t, axis, keepdims)


def _any(t: torch.Tensor, axis, keepdims: bool) -> torch.Tensor:
    return _over_axes(torch.any, t, axis, keepdims)


def all(x, axis=None, out=None, keepdim=False, keepdims=None) -> DNDarray:
    """Whether every element along ``axis`` is truthy."""
    return _reduce_op(_all, x, axis=axis, out=out, keepdims=bool(keepdim or keepdims), out_dtype=types.bool)


def any(x, axis=None, out=None, keepdim=False, keepdims=None) -> DNDarray:
    """Whether any element along ``axis`` is truthy."""
    return _reduce_op(_any, x, axis=axis, out=out, keepdims=bool(keepdim or keepdims), out_dtype=types.bool)


def _close(a: torch.Tensor, b: torch.Tensor, rtol: float, atol: float, equal_nan: bool) -> torch.Tensor:
    if not a.is_floating_point():
        a, b = a.to(torch.float64), b.to(torch.float64)
    return torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)


def isclose(x, y, rtol: float = 1e-05, atol: float = 1e-08, equal_nan: bool = False) -> DNDarray:
    """Elementwise ``|x - y| <= atol + rtol * |y|``."""
    return _binary_op(_close, x, y, fn_kwargs={"rtol": rtol, "atol": atol, "equal_nan": equal_nan})


def allclose(x, y, rtol: float = 1e-05, atol: float = 1e-08, equal_nan: bool = False) -> bool:
    """Whether every element pair is close, as one python bool."""
    return bool(_reduce_op(_all, isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)))


def isfinite(x) -> DNDarray:
    """Elementwise test for finite values."""
    return _local_op(torch.isfinite, x, no_cast=True, out_dtype=types.bool)


def isinf(x) -> DNDarray:
    """Elementwise test for infinities."""
    return _local_op(torch.isinf, x, no_cast=True, out_dtype=types.bool)


def isnan(x) -> DNDarray:
    """Elementwise test for NaN."""
    return _local_op(torch.isnan, x, no_cast=True, out_dtype=types.bool)


def isneginf(x, out=None) -> DNDarray:
    """Elementwise test for minus infinity."""
    return _local_op(_real_only(torch.isneginf, "isneginf", ValueError), x, out=out, no_cast=True,
                     out_dtype=types.bool)


def isposinf(x, out=None) -> DNDarray:
    """Elementwise test for plus infinity."""
    return _local_op(_real_only(torch.isposinf, "isposinf", ValueError), x, out=out, no_cast=True,
                     out_dtype=types.bool)


def _as_bool(t):
    if isinstance(t, DNDarray) and t.dtype is not types.bool:
        return t.astype(types.bool)
    return t


def logical_and(x, y) -> DNDarray:
    """Elementwise logical AND."""
    return _binary_op(torch.logical_and, _as_bool(x), _as_bool(y))


def logical_not(x, out=None) -> DNDarray:
    """Elementwise logical NOT."""
    return _local_op(torch.logical_not, x, out=out, no_cast=True, out_dtype=types.bool)


def logical_or(x, y) -> DNDarray:
    """Elementwise logical OR."""
    return _binary_op(torch.logical_or, _as_bool(x), _as_bool(y))


def logical_xor(x, y) -> DNDarray:
    """Elementwise logical XOR."""
    return _binary_op(torch.logical_xor, x, y)


def signbit(x, out=None) -> DNDarray:
    """Elementwise test for a set sign bit (true for -0.0)."""
    return _local_op(_real_only(torch.signbit, "signbit", ValueError), x, out=out, no_cast=True,
                     out_dtype=types.bool)
