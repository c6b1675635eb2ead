"""Rounding, sign and clipping (counterpart of ``heat_tpu/core/rounding.py``).

``abs``, ``clip``, ``sign``, ``sgn`` and ``nan_to_num`` keep integer types;
``ceil``/``floor``/``trunc``/``round``/``fabs``/``modf`` compute integer
input in float, as ``heat_tpu`` does. Complex input: ``abs`` is real,
``round`` rounds both parts, ``sign`` is the sign of the real part and
``sgn`` is ``z / |z|``; ``ceil``/``floor``/``trunc``/``fabs`` raise
``TypeError``.
"""
from __future__ import annotations

import torch

from . import types
from ._operations import _local_operand, _local_op, _real_only, _write_out
from .dndarray import DNDarray

__all__ = [
    "abs",
    "absolute",
    "ceil",
    "clip",
    "fabs",
    "floor",
    "modf",
    "nan_to_num",
    "round",
    "sgn",
    "sign",
    "trunc",
]


def _abs(t: torch.Tensor) -> torch.Tensor:
    return t.clone() if t.dtype == torch.bool else torch.abs(t)


def abs(x, out=None, dtype=None) -> DNDarray:
    """Elementwise absolute value, cast to ``dtype`` if given."""
    if dtype is not None:
        dtype = types.canonical_heat_type(dtype)
    res = _local_op(_abs, x, out=None if dtype else out, no_cast=True)
    if dtype is not None:
        res = res.astype(dtype)
        if out is not None:
            return _write_out(out, res)
    return res


absolute = abs


def fabs(x, out=None) -> DNDarray:
    """Elementwise absolute value in float."""
    return _local_op(_real_only(torch.abs, "fabs"), x, out=out)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, out=None) -> DNDarray:
    """NaN to ``nan``, infinities to ``posinf``/``neginf`` (default: the
    type's largest finite values)."""
    return _local_op(torch.nan_to_num, x, out=out, no_cast=True, nan=nan, posinf=posinf, neginf=neginf)


def ceil(x, out=None) -> DNDarray:
    """Elementwise ceiling."""
    return _local_op(_real_only(torch.ceil, "ceil"), x, out=out)


def floor(x, out=None) -> DNDarray:
    """Elementwise floor."""
    return _local_op(_real_only(torch.floor, "floor"), x, out=out)


def trunc(x, out=None) -> DNDarray:
    """Elementwise rounding toward zero."""
    return _local_op(_real_only(torch.trunc, "trunc"), x, out=out)


def clip(x, min=None, max=None, out=None, *, a_min=None, a_max=None) -> DNDarray:
    """Clamp values to [min, max] (numpy's ``a_min``/``a_max`` also accepted).
    The result type is ``jnp.clip``'s: a python float bound makes integer
    input float64."""
    lo = a_min if a_min is not None else min
    hi = a_max if a_max is not None else max
    if lo is None and hi is None:
        raise ValueError("either min or max must be set")
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
    tt = types._weak_result_type(x, *(b for b in (lo, hi) if b is not None)).torch_type()

    def bound(b):
        if b is None:
            return None
        if isinstance(b, DNDarray):
            return _local_operand(b, x.gshape, x.split).to(tt)
        return torch.as_tensor(b, device=x._raw.device).to(tt)  # _raw: larray would rebalance a ragged x

    return _local_op(lambda t: torch.clamp(t.to(tt), bound(lo), bound(hi)), x, out=out, no_cast=True)


def modf(x, out=None):
    """Fractional and integral parts, both with the sign of ``x``."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
    frac = _local_op(torch.frac, x)
    integ = _local_op(torch.trunc, x)
    if out is not None:
        if not isinstance(out, tuple) or len(out) != 2:
            raise TypeError("out must be a 2-tuple of DNDarrays")
        return _write_out(out[0], frac), _write_out(out[1], integ)
    return frac, integ


def _round(t: torch.Tensor, decimals: int = 0) -> torch.Tensor:
    if t.is_complex():
        return torch.complex(torch.round(t.real, decimals=decimals), torch.round(t.imag, decimals=decimals))
    return torch.round(t, decimals=decimals)


def round(x, decimals: int = 0, out=None, dtype=None) -> DNDarray:
    """Round half to even to ``decimals`` decimals, cast to ``dtype`` if given."""
    if dtype is not None:
        dtype = types.canonical_heat_type(dtype)
    res = _local_op(_round, x, out=out, decimals=decimals)
    if dtype is not None:
        res = res.astype(dtype)
    return res


def sign(x, out=None) -> DNDarray:
    """Elementwise sign: -1, 0 or 1 (NaN for NaN)."""
    if isinstance(x, DNDarray) and x.dtype is types.bool:
        raise TypeError("sign does not accept dtype bool")
    return _local_op(_sign, x, out=out, no_cast=True)


def _sign(t: torch.Tensor) -> torch.Tensor:
    return torch.sign(t.real).to(t.dtype) if t.is_complex() else torch.sign(t)


def sgn(x, out=None) -> DNDarray:
    """Elementwise sign; for complex input ``z / |z|`` (0 where z is 0)."""
    if isinstance(x, DNDarray) and x.dtype is types.bool:
        raise TypeError("sgn does not accept dtype bool")
    return _local_op(lambda t: torch.sgn(t) if t.is_complex() else torch.sign(t), x, out=out, no_cast=True)
