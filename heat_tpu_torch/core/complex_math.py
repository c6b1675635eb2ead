"""Complex number operations (counterpart of ``heat_tpu/core/complex_math.py``).

Elementwise and split-preserving. ``angle`` and ``imag`` of real input
keep its type as jnp does (``angle`` of an integer array is float64 there,
in 64-bit mode); ``real`` of a real array returns the array itself.
"""
from __future__ import annotations

import math

import torch

from . import types
from ._operations import _local_op
from .dndarray import DNDarray

__all__ = ["angle", "conj", "conjugate", "imag", "real"]


def _angle(t: torch.Tensor, deg: bool) -> torch.Tensor:
    if not (t.is_complex() or t.is_floating_point()):
        t = t.to(torch.float64)  # jnp takes integers to its default float
    a = torch.angle(t)
    return a * (180.0 / math.pi) if deg else a


def angle(x, deg: bool = False, out=None) -> DNDarray:
    """The phase angle of each element, in radians or (``deg``) degrees."""
    return _local_op(lambda t: _angle(t, deg), x, out=out, no_cast=True)


def conjugate(x, out=None) -> DNDarray:
    """The complex conjugate of each element (real input: a copy)."""
    return _local_op(lambda t: torch.conj(t).resolve_conj() if t.is_complex() else t.clone(), x, out=out, no_cast=True)


conj = conjugate


def imag(x, out=None) -> DNDarray:
    """The imaginary part (zeros of the input's type for real input)."""
    return _local_op(lambda t: t.imag.clone() if t.is_complex() else torch.zeros_like(t), x, out=out, no_cast=True)


def real(x, out=None) -> DNDarray:
    """The real part; a real array is returned as it is."""
    if isinstance(x, DNDarray) and not types.heat_type_is_complexfloating(x.dtype):
        return x
    return _local_op(lambda t: t.real.clone(), x, out=out, no_cast=True)
