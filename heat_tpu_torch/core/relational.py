"""Relational operations (counterpart of ``heat_tpu/core/relational.py``).

Each comparison goes over :func:`._operations._binary_op` (promotion,
broadcast and split rules) and gives a bool DNDarray; ``equal`` gives one
python bool. Complex numbers order lexicographically, as in ``heat_tpu``
(jnp): by the real part, then by the imaginary part.
"""
from __future__ import annotations

import torch

from ._operations import _binary_op, _reduce_op
from .dndarray import DNDarray
from .logical import _all

__all__ = [
    "eq",
    "equal",
    "ge",
    "greater",
    "greater_equal",
    "gt",
    "le",
    "less",
    "less_equal",
    "lt",
    "ne",
    "not_equal",
]


def eq(x, y) -> DNDarray:
    """Elementwise ``x == y``."""
    return _binary_op(torch.eq, x, y)


def equal(x, y) -> bool:
    """Whether ``x`` and ``y`` have broadcastable shapes and equal elements."""
    try:
        res = _binary_op(torch.eq, x, y)
    except ValueError:
        return False
    return bool(_reduce_op(_all, res))


def _ordered(strict, op):
    """The comparison ``op``, lexicographic on complex tensors: ``strict``
    on the real parts, or equal real parts and ``op`` on the imaginary ones."""

    def run(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if not a.is_complex():
            return op(a, b)
        return strict(a.real, b.real) | (a.real == b.real) & op(a.imag, b.imag)

    run._cache_stable = True  # built once per comparison at import: the lazy layer may key plans by it
    return run


_LT, _LE = _ordered(torch.lt, torch.lt), _ordered(torch.lt, torch.le)
_GT, _GE = _ordered(torch.gt, torch.gt), _ordered(torch.gt, torch.ge)


def ge(x, y) -> DNDarray:
    """Elementwise ``x >= y``."""
    return _binary_op(_GE, x, y)


greater_equal = ge


def gt(x, y) -> DNDarray:
    """Elementwise ``x > y``."""
    return _binary_op(_GT, x, y)


greater = gt


def le(x, y) -> DNDarray:
    """Elementwise ``x <= y``."""
    return _binary_op(_LE, x, y)


less_equal = le


def lt(x, y) -> DNDarray:
    """Elementwise ``x < y``."""
    return _binary_op(_LT, x, y)


less = lt


def ne(x, y) -> DNDarray:
    """Elementwise ``x != y``."""
    return _binary_op(torch.ne, x, y)


not_equal = ne
