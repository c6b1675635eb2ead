"""Exponential and logarithmic functions (counterpart of
``heat_tpu/core/exponential.py``).

Elementwise and split-preserving over :func:`._operations._local_op`;
integer input computes in float, except in ``square``, which keeps it.
"""
from __future__ import annotations

import torch

from ._operations import _binary_op, _local_op, _real_only
from .dndarray import DNDarray

__all__ = [
    "cbrt",
    "exp",
    "exp2",
    "expm1",
    "log",
    "log10",
    "log1p",
    "log2",
    "logaddexp",
    "logaddexp2",
    "rsqrt",
    "sqrt",
    "square",
]


def exp(x, out=None) -> DNDarray:
    """Elementwise e**x."""
    return _local_op(torch.exp, x, out=out)


def expm1(x, out=None) -> DNDarray:
    """Elementwise e**x - 1."""
    return _local_op(torch.expm1, x, out=out)


def exp2(x, out=None) -> DNDarray:
    """Elementwise 2**x."""
    return _local_op(torch.exp2, x, out=out)


def log(x, out=None) -> DNDarray:
    """Elementwise natural logarithm."""
    return _local_op(torch.log, x, out=out)


def log2(x, out=None) -> DNDarray:
    """Elementwise base-2 logarithm."""
    return _local_op(torch.log2, x, out=out)


def log10(x, out=None) -> DNDarray:
    """Elementwise base-10 logarithm."""
    return _local_op(torch.log10, x, out=out)


def log1p(x, out=None) -> DNDarray:
    """Elementwise log(1 + x)."""
    return _local_op(torch.log1p, x, out=out)


def _in_float(fn):
    """``fn`` of two tensors, integer or bool ones taken in float first."""
    from .arithmetics import _inexact

    return lambda a, b: fn(_inexact(a), _inexact(b))


def logaddexp(x1, x2, out=None) -> DNDarray:
    """Elementwise log(exp(x1) + exp(x2))."""
    return _binary_op(_in_float(torch.logaddexp), x1, x2, out=out)


def logaddexp2(x1, x2, out=None) -> DNDarray:
    """Elementwise log2(2**x1 + 2**x2)."""
    return _binary_op(_in_float(torch.logaddexp2), x1, x2, out=out)


def sqrt(x, out=None) -> DNDarray:
    """Elementwise square root."""
    return _local_op(torch.sqrt, x, out=out)


def rsqrt(x, out=None) -> DNDarray:
    """Elementwise 1 / sqrt(x)."""
    return _local_op(torch.rsqrt, x, out=out)


def _square(t: torch.Tensor) -> torch.Tensor:
    # jnp squares bool in int32
    return torch.square(t.to(torch.int32) if t.dtype == torch.bool else t)


def square(x, out=None) -> DNDarray:
    """Elementwise x**2; integer types are kept."""
    return _local_op(_square, x, out=out, no_cast=True)


def _cbrt(t: torch.Tensor) -> torch.Tensor:
    return torch.sign(t) * torch.abs(t).pow(1.0 / 3.0)


def cbrt(x, out=None) -> DNDarray:
    """Elementwise real cube root."""
    return _local_op(_real_only(_cbrt, "cbrt"), x, out=out)
