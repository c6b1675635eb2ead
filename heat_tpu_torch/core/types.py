"""Heat-compatible dtype hierarchy backed by ``torch.dtype``.

Counterpart of ``heat_tpu/core/types.py``: ``datatype`` -> ``bool``/``number``
-> integer/floating leaves. Each leaf is a *class* (never instantiated) that
maps onto a ``torch.dtype``. This slice of the port carries the five types
its path uses (``bool``, ``int32``, ``int64``, ``float32``, ``float64``) and
the reference's "intuitive" promotion table restricted to them.
"""
from __future__ import annotations

import builtins
from typing import Type

import numpy as np
import torch

__all__ = [
    "datatype",
    "generic",
    "number",
    "integer",
    "signedinteger",
    "inexact",
    "floating",
    "bool",
    "bool_",
    "int32",
    "int",
    "int64",
    "long",
    "float32",
    "float",
    "float64",
    "double",
    "canonical_heat_type",
    "heat_type_is_exact",
    "promote_types",
    "result_type",
]


class datatype:
    """Base class of the heat type hierarchy."""

    _torch_type: torch.dtype = None
    _np_type = None

    @classmethod
    def torch_type(cls) -> torch.dtype:
        """The ``torch.dtype`` this heat type maps to."""
        return cls._torch_type

    @classmethod
    def numpy_type(cls):
        """The numpy scalar type this heat type maps to."""
        return cls._np_type


class generic(datatype):
    pass


class bool(generic):
    _torch_type = torch.bool
    _np_type = np.bool_


class number(generic):
    pass


class integer(number):
    pass


class signedinteger(integer):
    pass


class inexact(number):
    pass


class floating(inexact):
    pass


class int32(signedinteger):
    _torch_type = torch.int32
    _np_type = np.int32


class int64(signedinteger):
    _torch_type = torch.int64
    _np_type = np.int64


class float32(floating):
    _torch_type = torch.float32
    _np_type = np.float32


class float64(floating):
    _torch_type = torch.float64
    _np_type = np.float64


bool_ = bool
int = int32
long = int64
float = float32
double = float64

_HEAT_TYPES = [bool, int32, int64, float32, float64]
_TORCH_TO_HEAT = {t._torch_type: t for t in _HEAT_TYPES}
_NP_TO_HEAT = {np.dtype(t._np_type): t for t in _HEAT_TYPES}

_EXTRA_CANONICAL = {
    builtins.bool: bool,
    # the TYPE `int` maps to int32 and `float` to float32, like heat_tpu
    builtins.int: int32,
    builtins.float: float32,
    "bool": bool,
    "int32": int32,
    "i4": int32,
    "int": int32,
    "int64": int64,
    "i8": int64,
    "long": int64,
    "float32": float32,
    "f4": float32,
    "float": float32,
    "float64": float64,
    "f8": float64,
    "double": float64,
}


def canonical_heat_type(a_type) -> Type[datatype]:
    """Canonicalize a type-like object (heat type, ``torch.dtype``, numpy
    dtype, python builtin or string) into a heat type class."""
    if isinstance(a_type, type) and issubclass(a_type, datatype):
        if a_type._torch_type is None:
            raise TypeError(f"abstract heat type {a_type.__name__!r} cannot be used as a concrete dtype")
        return a_type
    if isinstance(a_type, torch.dtype):
        try:
            return _TORCH_TO_HEAT[a_type]
        except KeyError:
            raise TypeError(f"data type {a_type!r} not supported by this slice of the port") from None
    try:
        if a_type in _EXTRA_CANONICAL:
            return _EXTRA_CANONICAL[a_type]
    except TypeError:
        pass
    try:
        return _NP_TO_HEAT[np.dtype(a_type)]
    except (TypeError, KeyError):
        raise TypeError(f"data type {a_type!r} not understood") from None


def heat_type_is_exact(ht_dtype) -> builtins.bool:
    """True for integer/bool heat types."""
    return issubclass(canonical_heat_type(ht_dtype), (integer, bool))


# Promotion (heat_tpu ``types.py:492-537``): the first type in _ORDER that
# both operands cast to under the "intuitive" rule, which is "safe" plus the
# same-width int32 -> float32 cast (so int32 + float32 -> float32, where
# numpy would widen to float64).
_ORDER = [bool, int32, int64, float32, float64]
_T, _F = True, False
_INTUITIVE = [
    # bool i32 i64 f32 f64
    [_T, _T, _T, _T, _T],  # bool
    [_F, _T, _T, _T, _T],  # int32
    [_F, _F, _T, _F, _T],  # int64
    [_F, _F, _F, _T, _T],  # float32
    [_F, _F, _F, _F, _T],  # float64
]
_PROMOTE = [
    [next(_ORDER[t] for t in range(5) if _INTUITIVE[i][t] and _INTUITIVE[j][t]) for j in range(5)]
    for i in range(5)
]


def promote_types(type1, type2) -> Type[datatype]:
    """Bit-width-preserving common type (``int32 + float32 -> float32``)."""
    t1 = canonical_heat_type(type1)
    t2 = canonical_heat_type(type2)
    return _PROMOTE[_ORDER.index(t1)][_ORDER.index(t2)]


def result_type(*operands) -> Type[datatype]:
    """Promotion with operand precedence (heat_tpu ``types.py:383-432``):
    arrays > types > scalar arrays > python scalars; within one kind the
    higher-precedence operand's type wins outright."""

    def classify(arg):
        # (heat type, precedence): 0 array, 1 type, 2 scalar array, 3 scalar
        if isinstance(arg, type) and issubclass(arg, datatype):
            return canonical_heat_type(arg), 1
        if isinstance(arg, (builtins.bool, builtins.int, builtins.float)) and not isinstance(arg, np.generic):
            return canonical_heat_type(type(arg)), 3
        dt = getattr(arg, "dtype", None)
        if dt is not None and not isinstance(arg, np.dtype):
            t = dt if isinstance(dt, type) and issubclass(dt, datatype) else canonical_heat_type(dt)
            return t, 0 if len(getattr(arg, "shape", ())) > 0 else 2
        if isinstance(arg, (list, tuple)):
            a = np.asarray(arg)
            t = float32 if a.dtype == np.float64 else canonical_heat_type(a.dtype)
            return t, 0 if a.ndim > 0 else 2
        return canonical_heat_type(arg), 1

    def merge(a, b):
        (t1, p1), (t2, p2) = a, b
        if t1 is t2:
            return t1, min(p1, p2)
        if p1 == p2:
            return promote_types(t1, t2), p1
        for parent in (bool, integer, floating):
            if issubclass(t1, parent) and issubclass(t2, parent):
                return (t1, min(p1, p2)) if p1 < p2 else (t2, min(p1, p2))
        # different kinds: the higher kind wins regardless of precedence
        return (t2, min(p1, p2)) if _ORDER.index(t1) < _ORDER.index(t2) else (t1, min(p1, p2))

    if not operands:
        raise TypeError("result_type requires at least one operand")
    acc = classify(operands[0])
    for op in operands[1:]:
        acc = merge(acc, classify(op))
    return acc[0]


# jnp's lattice over this slice's types, used where heat_tpu hands operands to
# jnp unconverted (``where``, ``clip``, ``diff``, ``dot``, ``outer``): any
# integer with float32 gives float32, and a python scalar is weakly typed.
_KIND = {bool: 0, int32: 1, int64: 1, float32: 2, float64: 2}
_WEAK_DEFAULT = (bool, int64, float64)  # a weak scalar's type when it wins (64-bit mode)


def _weak_result_type(*operands) -> Type[datatype]:
    """The type jnp gives to an op on ``operands`` (DNDarrays, tensors, numpy
    or python scalars): arrays promote along jnp's lattice; a python scalar
    takes the arrays' type unless its kind (bool < int < float) is higher,
    then the 64-bit type of its kind."""
    strong, weak = None, -1
    for arg in operands:
        if isinstance(arg, (builtins.bool, builtins.int, builtins.float)) and not isinstance(arg, np.generic):
            weak = max(weak, _KIND[canonical_heat_type(type(arg))])
            continue
        dt = getattr(arg, "dtype", None)
        t = dt if isinstance(dt, type) and issubclass(dt, datatype) else canonical_heat_type(dt)
        if strong is None or strong is t:
            strong = t
        elif _KIND[strong] == _KIND[t]:
            strong = strong if _ORDER.index(strong) > _ORDER.index(t) else t
        else:
            strong = strong if _KIND[strong] > _KIND[t] else t
    if strong is None:
        return _WEAK_DEFAULT[weak]
    return strong if weak <= _KIND[strong] else _WEAK_DEFAULT[weak]
