"""Heat-compatible dtype hierarchy backed by ``torch.dtype``.

Counterpart of ``heat_tpu/core/types.py``: ``datatype`` -> ``bool``/``number``
-> integer/floating/complex leaves. Each leaf is a *class* (never
instantiated) that maps onto a ``torch.dtype``. The twelve concrete types
are ``heat_tpu``'s: bool, uint8, int8, int16, int32, int64, float16,
bfloat16, float32, float64, complex64 and complex128.

Promotion is the reference's "intuitive" table over the ten tabled types
(float16/bfloat16 sit outside it and promote as float32, except with
themselves; the two half formats together widen to float32).
:func:`_weak_result_type` is jnp's lattice, for the places where
``heat_tpu`` hands operands to jnp unconverted.

numpy has no bfloat16 of its own, so :attr:`bfloat16.numpy_type` is None;
a numpy array whose ``dtype.name`` is ``"bfloat16"`` (as ``ml_dtypes``
makes them) is recognised by that name, without importing ``ml_dtypes``.
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
    "unsignedinteger",
    "inexact",
    "floating",
    "complexfloating",
    "flexible",
    "bool",
    "bool_",
    "uint8",
    "ubyte",
    "int8",
    "byte",
    "int16",
    "short",
    "int32",
    "int",
    "int_",
    "int64",
    "long",
    "float16",
    "half",
    "bfloat16",
    "float32",
    "float",
    "float_",
    "float64",
    "double",
    "complex64",
    "cfloat",
    "csingle",
    "complex128",
    "cdouble",
    "complex",
    "canonical_heat_type",
    "heat_type_of",
    "heat_type_is_exact",
    "heat_type_is_inexact",
    "heat_type_is_complexfloating",
    "issubdtype",
    "iscomplex",
    "isreal",
    "promote_types",
    "result_type",
    "can_cast",
    "finfo",
    "iinfo",
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
        """The numpy scalar type this heat type maps to (None for bfloat16,
        which numpy lacks)."""
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


class unsignedinteger(integer):
    pass


class inexact(number):
    pass


class floating(inexact):
    pass


class complexfloating(inexact):
    pass


class flexible(generic):
    pass


class uint8(unsignedinteger):
    _torch_type = torch.uint8
    _np_type = np.uint8


class int8(signedinteger):
    _torch_type = torch.int8
    _np_type = np.int8


class int16(signedinteger):
    _torch_type = torch.int16
    _np_type = np.int16


class int32(signedinteger):
    _torch_type = torch.int32
    _np_type = np.int32


class int64(signedinteger):
    _torch_type = torch.int64
    _np_type = np.int64


class float16(floating):
    _torch_type = torch.float16
    _np_type = np.float16


class bfloat16(floating):
    _torch_type = torch.bfloat16
    _np_type = None


class float32(floating):
    _torch_type = torch.float32
    _np_type = np.float32


class float64(floating):
    _torch_type = torch.float64
    _np_type = np.float64


class complex64(complexfloating):
    _torch_type = torch.complex64
    _np_type = np.complex64


class complex128(complexfloating):
    _torch_type = torch.complex128
    _np_type = np.complex128


bool_ = bool
ubyte = uint8
byte = int8
short = int16
int = int32
int_ = int32
long = int64
half = float16
float = float32
float_ = float32
double = float64
cfloat = complex64
csingle = complex64
cdouble = complex128
# the abstract class; as a dtype argument it means complex64, as the builtin does
complex = complexfloating

_HEAT_TYPES = [bool, uint8, int8, int16, int32, int64, float16, bfloat16, float32, float64, complex64, complex128]
_TORCH_TO_HEAT = {t._torch_type: t for t in _HEAT_TYPES}
_NP_TO_HEAT = {np.dtype(t._np_type): t for t in _HEAT_TYPES if t._np_type is not None}

_EXTRA_CANONICAL = {
    builtins.bool: bool,
    # the TYPE `int` maps to int32 and `float` to float32, like heat_tpu
    builtins.int: int32,
    builtins.float: float32,
    builtins.complex: complex64,
    complexfloating: complex64,
    "bool": bool,
    "b1": bool,
    "uint8": uint8,
    "u1": uint8,
    "int8": int8,
    "i1": int8,
    "int16": int16,
    "i2": int16,
    "int32": int32,
    "i4": int32,
    "int": int32,
    "int64": int64,
    "i8": int64,
    "long": int64,
    "float16": float16,
    "f2": float16,
    "half": float16,
    "bfloat16": bfloat16,
    "float32": float32,
    "f4": float32,
    "float": float32,
    "float64": float64,
    "f8": float64,
    "double": float64,
    "complex64": complex64,
    "c8": complex64,
    "complex128": complex128,
    "c16": complex128,
}


def _is_numpy_bfloat16(dtype) -> builtins.bool:
    """A numpy dtype named ``bfloat16`` (``ml_dtypes``'), recognised by name."""
    return isinstance(dtype, np.dtype) and dtype.name == "bfloat16"


def canonical_heat_type(a_type) -> Type[datatype]:
    """Canonicalize a type-like object (heat type, ``torch.dtype``, numpy
    dtype, python builtin or string) into a heat type class."""
    if isinstance(a_type, type) and issubclass(a_type, datatype):
        if a_type._torch_type is None:
            if a_type in _EXTRA_CANONICAL:
                return _EXTRA_CANONICAL[a_type]
            raise TypeError(f"abstract heat type {a_type.__name__!r} cannot be used as a concrete dtype")
        return a_type
    if isinstance(a_type, torch.dtype):
        try:
            return _TORCH_TO_HEAT[a_type]
        except KeyError:
            raise TypeError(f"data type {a_type!r} not understood") from None
    try:
        if a_type in _EXTRA_CANONICAL:
            return _EXTRA_CANONICAL[a_type]
    except TypeError:
        pass
    try:
        dt = np.dtype(a_type)
    except TypeError:
        raise TypeError(f"data type {a_type!r} not understood") from None
    if _is_numpy_bfloat16(dt):
        return bfloat16
    try:
        return _NP_TO_HEAT[dt]
    except KeyError:
        raise TypeError(f"data type {a_type!r} not understood") from None


def heat_type_of(obj) -> Type[datatype]:
    """The heat type of an array-like object or python scalar (scalars by
    their type: int -> int32, float -> float32, complex -> complex64)."""
    dtype = getattr(obj, "dtype", None)
    if dtype is not None:
        if isinstance(dtype, type) and issubclass(dtype, datatype):
            return dtype
        return canonical_heat_type(dtype)
    if isinstance(obj, (builtins.bool, np.bool_)):
        return bool
    if isinstance(obj, (builtins.int, np.integer)):
        return int32
    if isinstance(obj, (builtins.float, np.floating)):
        return float32
    if isinstance(obj, (builtins.complex, np.complexfloating)):
        return complex64
    if isinstance(obj, (list, tuple)):
        return canonical_heat_type(np.asarray(obj).dtype)
    raise TypeError(f"cannot determine heat type of {type(obj)}")


def heat_type_is_exact(ht_dtype) -> builtins.bool:
    """True for integer/bool heat types."""
    return issubclass(canonical_heat_type(ht_dtype), (integer, bool))


def heat_type_is_inexact(ht_dtype) -> builtins.bool:
    """True for floating/complex heat types."""
    return issubclass(canonical_heat_type(ht_dtype), inexact)


def heat_type_is_complexfloating(ht_dtype) -> builtins.bool:
    """True for complex heat types."""
    return issubclass(canonical_heat_type(ht_dtype), complexfloating)


def issubdtype(arg1, arg2) -> builtins.bool:
    """``np.issubdtype`` over the heat hierarchy."""
    if not (isinstance(arg1, type) and issubclass(arg1, datatype)):
        arg1 = canonical_heat_type(arg1)
    if isinstance(arg2, type) and issubclass(arg2, datatype):
        return issubclass(arg1, arg2)
    return issubclass(arg1, canonical_heat_type(arg2))


def iscomplex(x):
    """Elementwise: the imaginary part is nonzero (all False for real input)."""
    from ._operations import _local_op

    def local(t):
        return t.imag != 0 if t.is_complex() else torch.zeros(t.shape, dtype=torch.bool, device=t.device)

    return _local_op(local, x, out_dtype=bool, no_cast=True)


def isreal(x):
    """Elementwise: the imaginary part is zero (all True for real input)."""
    from ._operations import _local_op

    def local(t):
        return t.imag == 0 if t.is_complex() else torch.ones(t.shape, dtype=torch.bool, device=t.device)

    return _local_op(local, x, out_dtype=bool, no_cast=True)


# ---------------------------------------------------------------------------
# Promotion and casts (heat_tpu ``types.py:369-538``): the first type in
# _ORDER that both operands cast to under the "intuitive" rule, which is
# "safe" plus the same-width int32 -> float32/complex64 casts (so
# int32 + float32 -> float32, where numpy would widen to float64).
_ORDER = [bool, uint8, int8, int16, int32, int64, float32, float64, complex64, complex128]
_T, _F = True, False
_SAFE_CAST = [
    # bool u8  i8  i16 i32 i64 f32 f64 c64 c128
    [_T, _T, _T, _T, _T, _T, _T, _T, _T, _T],  # bool
    [_F, _T, _F, _T, _T, _T, _T, _T, _T, _T],  # uint8
    [_F, _F, _T, _T, _T, _T, _T, _T, _T, _T],  # int8
    [_F, _F, _F, _T, _T, _T, _T, _T, _T, _T],  # int16
    [_F, _F, _F, _F, _T, _T, _F, _T, _F, _T],  # int32
    [_F, _F, _F, _F, _F, _T, _F, _T, _F, _T],  # int64
    [_F, _F, _F, _F, _F, _F, _T, _T, _T, _T],  # float32
    [_F, _F, _F, _F, _F, _F, _F, _T, _F, _T],  # float64
    [_F, _F, _F, _F, _F, _F, _F, _F, _T, _T],  # complex64
    [_F, _F, _F, _F, _F, _F, _F, _F, _F, _T],  # complex128
]
_INTUITIVE_CAST = [row[:] for row in _SAFE_CAST]
_INTUITIVE_CAST[4][6] = _INTUITIVE_CAST[4][8] = True  # int32 -> float32 / complex64
_PROMOTE = [
    [next(_ORDER[t] for t in range(len(_ORDER)) if _INTUITIVE_CAST[i][t] and _INTUITIVE_CAST[j][t])
     for j in range(len(_ORDER))]
    for i in range(len(_ORDER))
]
_HALVES = (float16, bfloat16)


def _type_code(t) -> builtins.int:
    """``t``'s row in the tables; the half formats promote as float32."""
    t = canonical_heat_type(t)
    return _ORDER.index(float32 if t in _HALVES else t)


def promote_types(type1, type2) -> Type[datatype]:
    """Bit-width-preserving common type (``int32 + float32 -> float32``)."""
    t1 = canonical_heat_type(type1)
    t2 = canonical_heat_type(type2)
    if t1 is t2:
        return t1
    if t1 in _HALVES and t2 in _HALVES:
        return float32
    return _PROMOTE[_type_code(t1)][_type_code(t2)]


def result_type(*operands) -> Type[datatype]:
    """Promotion with operand precedence (heat_tpu ``types.py:383-432``):
    arrays > types > scalar arrays > python scalars; within one kind the
    higher-precedence operand's type wins outright."""

    def classify(arg):
        # (heat type, precedence): 0 array, 1 type, 2 scalar array, 3 scalar
        if isinstance(arg, type) and issubclass(arg, datatype):
            try:
                return canonical_heat_type(arg), 1
            except TypeError:
                return arg, 1  # an abstract class; merge() resolves it by kind
        if isinstance(arg, (builtins.bool, builtins.int, builtins.float, builtins.complex)) \
                and not isinstance(arg, np.generic):
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
        for parent in (bool, integer, floating, complexfloating):
            if issubclass(t1, parent) and issubclass(t2, parent):
                return (t1, min(p1, p2)) if p1 < p2 else (t2, min(p1, p2))
        # different kinds: the higher kind wins regardless of precedence
        return (t2, min(p1, p2)) if _type_code(t1) < _type_code(t2) else (t1, min(p1, p2))

    if not operands:
        raise TypeError("result_type requires at least one operand")
    acc = classify(operands[0])
    for op in operands[1:]:
        acc = merge(acc, classify(op))
    return acc[0]


def can_cast(from_, to, casting: str = "intuitive") -> builtins.bool:
    """Whether a cast is allowed under ``casting``: ``"no"``, ``"safe"``,
    ``"same_kind"``, ``"unsafe"`` or ``"intuitive"`` (safe plus the
    same-width int32 -> float32). Python scalars resolve to their heat type
    (:func:`heat_type_of`): the answer is type-based, never value-based."""
    to_t = canonical_heat_type(to)
    if isinstance(from_, (builtins.bool, builtins.int, builtins.float, builtins.complex)) \
            and not isinstance(from_, np.generic):
        from_ = heat_type_of(from_)
    if hasattr(from_, "dtype") and not isinstance(from_, np.dtype):
        d = from_.dtype
        from_t = d if isinstance(d, type) and issubclass(d, datatype) else canonical_heat_type(d)
    else:
        from_t = canonical_heat_type(from_)
    if casting == "no":
        return from_t is to_t
    if casting == "unsafe":
        return True
    if from_t in _HALVES or to_t in _HALVES:
        if from_t is to_t:
            return True
        widening = from_t in _HALVES and to_t in (float32, float64, complex64, complex128)
        if casting in ("safe", "intuitive"):
            return widening
        if casting == "same_kind":
            return issubclass(from_t, inexact) and issubclass(to_t, inexact) or widening
        raise ValueError(f"unknown casting rule {casting!r}")
    i, j = _type_code(from_t), _type_code(to_t)
    if casting == "safe":
        return _SAFE_CAST[i][j]
    if casting == "intuitive":
        return _INTUITIVE_CAST[i][j]
    if casting == "same_kind":
        return _SAFE_CAST[i][j] or builtins.bool(
            np.can_cast(np.dtype(from_t._np_type), np.dtype(to_t._np_type), casting="same_kind"))
    raise ValueError(f"unknown casting rule {casting!r}")


class finfo:
    """Machine limits of a floating or complex type (a complex type gives its
    parts' limits): ``bits``, ``eps``, ``max``, ``min``, ``tiny``."""

    def __new__(cls, dtype):
        h = canonical_heat_type(dtype)
        if not issubclass(h, inexact):
            raise TypeError(f"data type {dtype} not inexact")
        part = {complex64: torch.float32, complex128: torch.float64}.get(h, h._torch_type)
        info = torch.finfo(part)
        self = super().__new__(cls)
        self.bits = info.bits
        self.eps = builtins.float(info.eps)
        self.max = builtins.float(info.max)
        self.min = builtins.float(info.min)
        self.tiny = builtins.float(info.tiny)
        return self


class iinfo:
    """Machine limits of an integer type (bool: 8 bits, 0 and 1)."""

    def __new__(cls, dtype):
        h = canonical_heat_type(dtype)
        if not issubclass(h, (integer, bool)):
            raise TypeError(f"data type {dtype} not an integer type")
        self = super().__new__(cls)
        if h is bool:
            self.bits, self.max, self.min = 8, 1, 0
            return self
        info = torch.iinfo(h._torch_type)
        self.bits = info.bits
        self.max = builtins.int(info.max)
        self.min = builtins.int(info.min)
        return self


# jnp's lattice, used where heat_tpu hands operands to jnp unconverted
# (``where``, ``clip``, ``diff``, ``dot``, ``outer``, ``convolve``'s local
# step): any integer with a float gives the float, the two half formats give
# float32, and a python scalar is weakly typed.
_JNP_LATTICE = """
    b1  u1  i1  i2  i4  i8  f2  bf  f4  f8  c8  c16
    u1  u1  i2  i2  i4  i8  f2  bf  f4  f8  c8  c16
    i1  i2  i1  i2  i4  i8  f2  bf  f4  f8  c8  c16
    i2  i2  i2  i2  i4  i8  f2  bf  f4  f8  c8  c16
    i4  i4  i4  i4  i4  i8  f2  bf  f4  f8  c8  c16
    i8  i8  i8  i8  i8  i8  f2  bf  f4  f8  c8  c16
    f2  f2  f2  f2  f2  f2  f2  f4  f4  f8  c8  c16
    bf  bf  bf  bf  bf  bf  f4  bf  f4  f8  c8  c16
    f4  f4  f4  f4  f4  f4  f4  f4  f4  f8  c8  c16
    f8  f8  f8  f8  f8  f8  f8  f8  f8  f8  c16 c16
    c8  c8  c8  c8  c8  c8  c8  c8  c8  c16 c8  c16
    c16 c16 c16 c16 c16 c16 c16 c16 c16 c16 c16 c16
"""  # rows and columns in _HEAT_TYPES' order: jnp.promote_types of the two
_CODE = dict(_EXTRA_CANONICAL, bf=bfloat16)
_JNP_PROMOTE = {
    (a, b): _CODE[code]
    for a, row in zip(_HEAT_TYPES, _JNP_LATTICE.split("\n")[1:-1])
    for b, code in zip(_HEAT_TYPES, row.split())
}


def _kind(t) -> builtins.int:
    """0 bool, 1 integer, 2 floating, 3 complex."""
    return 0 if t is bool else 1 if issubclass(t, integer) else 2 if issubclass(t, floating) else 3


def _weak_result_type(*operands) -> Type[datatype]:
    """The type jnp gives to an op on ``operands`` (DNDarrays, tensors, numpy
    or python scalars, in 64-bit mode): arrays promote along jnp's lattice; a
    python scalar takes the arrays' type unless its kind (bool < int < float
    < complex) is higher, then the 64-bit type of its kind, or the complex
    type of a float array's width."""
    strong, weak = None, -1
    for arg in operands:
        if isinstance(arg, (builtins.bool, builtins.int, builtins.float, builtins.complex)) \
                and not isinstance(arg, np.generic):
            weak = max(weak, _kind(canonical_heat_type(type(arg))))
            continue
        dt = getattr(arg, "dtype", None)
        t = dt if isinstance(dt, type) and issubclass(dt, datatype) else canonical_heat_type(dt)
        strong = t if strong is None else _JNP_PROMOTE[(strong, t)]
    if strong is None:
        return (bool, int64, float64, complex128)[weak]
    if weak <= _kind(strong):
        return strong
    if weak == 3 and _kind(strong) == 2:
        return complex128 if strong is float64 else complex64
    return (bool, int64, float64, complex128)[weak]
