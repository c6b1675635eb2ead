"""Relational operations (counterpart of ``heat_tpu/core/relational.py``).

Each comparison goes over :func:`._operations._binary_op` (promotion,
broadcast and split rules) and gives a bool DNDarray; ``equal`` gives one
python bool.
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


def ge(x, y) -> DNDarray:
    """Elementwise ``x >= y``."""
    return _binary_op(torch.ge, x, y)


greater_equal = ge


def gt(x, y) -> DNDarray:
    """Elementwise ``x > y``."""
    return _binary_op(torch.gt, x, y)


greater = gt


def le(x, y) -> DNDarray:
    """Elementwise ``x <= y``."""
    return _binary_op(torch.le, x, y)


less_equal = le


def lt(x, y) -> DNDarray:
    """Elementwise ``x < y``."""
    return _binary_op(torch.lt, x, y)


less = lt


def ne(x, y) -> DNDarray:
    """Elementwise ``x != y``."""
    return _binary_op(torch.ne, x, y)


not_equal = ne
