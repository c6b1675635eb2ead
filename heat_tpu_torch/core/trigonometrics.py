"""Trigonometric and hyperbolic functions (counterpart of
``heat_tpu/core/trigonometrics.py``).

Elementwise and split-preserving over :func:`._operations._local_op`;
integer input computes in float.
"""
from __future__ import annotations

import math

import torch

from . import types
from ._operations import _binary_op, _local_op
from .arithmetics import _inexact
from .dndarray import DNDarray

__all__ = [
    "acos",
    "acosh",
    "arccos",
    "arccosh",
    "arcsin",
    "arcsinh",
    "arctan",
    "arctan2",
    "arctanh",
    "asin",
    "asinh",
    "atan",
    "atan2",
    "atanh",
    "cos",
    "cosh",
    "deg2rad",
    "degrees",
    "rad2deg",
    "radians",
    "sin",
    "sinc",
    "sinh",
    "tan",
    "tanh",
]


def acos(x, out=None) -> DNDarray:
    """Elementwise arccosine."""
    return _local_op(torch.acos, x, out=out)


arccos = acos


def acosh(x, out=None) -> DNDarray:
    """Elementwise inverse hyperbolic cosine."""
    return _local_op(torch.acosh, x, out=out)


arccosh = acosh


def asin(x, out=None) -> DNDarray:
    """Elementwise arcsine."""
    return _local_op(torch.asin, x, out=out)


arcsin = asin


def asinh(x, out=None) -> DNDarray:
    """Elementwise inverse hyperbolic sine."""
    return _local_op(torch.asinh, x, out=out)


arcsinh = asinh


def atan(x, out=None) -> DNDarray:
    """Elementwise arctangent."""
    return _local_op(torch.atan, x, out=out)


arctan = atan


def atanh(x, out=None) -> DNDarray:
    """Elementwise inverse hyperbolic tangent."""
    return _local_op(torch.atanh, x, out=out)


arctanh = atanh


def _atan2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.atan2(_inexact(a), _inexact(b))


def atan2(x1, x2) -> DNDarray:
    """Elementwise arctangent of x1 / x2 in the right quadrant."""
    res = _binary_op(_atan2, x1, x2)
    if types.heat_type_is_exact(res.dtype):
        res = res.astype(types.float32)
    return res


arctan2 = atan2


def cos(x, out=None) -> DNDarray:
    """Elementwise cosine."""
    return _local_op(torch.cos, x, out=out)


def cosh(x, out=None) -> DNDarray:
    """Elementwise hyperbolic cosine."""
    return _local_op(torch.cosh, x, out=out)


def deg2rad(x, out=None) -> DNDarray:
    """Degrees to radians."""
    return _local_op(lambda t: t * (math.pi / 180.0) if t.is_complex() else torch.deg2rad(t), x, out=out)


radians = deg2rad


def rad2deg(x, out=None) -> DNDarray:
    """Radians to degrees."""
    return _local_op(lambda t: t * (180.0 / math.pi) if t.is_complex() else torch.rad2deg(t), x, out=out)


degrees = rad2deg


def sin(x, out=None) -> DNDarray:
    """Elementwise sine."""
    return _local_op(torch.sin, x, out=out)


def sinc(x, out=None) -> DNDarray:
    """Elementwise normalized sinc, sin(pi x) / (pi x)."""
    return _local_op(torch.sinc, x, out=out)


def sinh(x, out=None) -> DNDarray:
    """Elementwise hyperbolic sine."""
    return _local_op(torch.sinh, x, out=out)


def tan(x, out=None) -> DNDarray:
    """Elementwise tangent."""
    return _local_op(torch.tan, x, out=out)


def tanh(x, out=None) -> DNDarray:
    """Elementwise hyperbolic tangent."""
    return _local_op(torch.tanh, x, out=out)
