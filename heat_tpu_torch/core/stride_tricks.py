"""Shape/axis sanitation helpers (counterpart of ``heat_tpu/core/stride_tricks.py``)."""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np

__all__ = ["broadcast_shape", "broadcast_shapes", "sanitize_axis", "sanitize_shape", "sanitize_slice"]


def broadcast_shape(shape_a: Tuple[int, ...], shape_b: Tuple[int, ...]) -> Tuple[int, ...]:
    """NumPy-broadcast two shapes, raising ValueError on mismatch."""
    try:
        return tuple(np.broadcast_shapes(tuple(shape_a), tuple(shape_b)))
    except ValueError:
        raise ValueError(
            f"operands could not be broadcast, input shapes {tuple(shape_a)} {tuple(shape_b)}"
        ) from None


def broadcast_shapes(*shapes) -> Tuple[int, ...]:
    """NumPy-broadcast any number of shapes, raising ValueError on mismatch."""
    try:
        return tuple(np.broadcast_shapes(*[tuple(s) for s in shapes]))
    except ValueError:
        raise ValueError(f"operands could not be broadcast, input shapes {shapes}") from None


def sanitize_axis(
    shape: Tuple[int, ...], axis: Union[int, Tuple[int, ...], None]
) -> Union[int, Tuple[int, ...], None]:
    """Normalize a (possibly negative / tuple) axis against ``shape``."""
    if axis is None:
        return None
    ndim = len(shape)
    if isinstance(axis, (list, tuple)):
        axes = tuple(sanitize_axis(shape, a) for a in axis)
        if len(set(axes)) != len(axes):
            raise ValueError("duplicate value in axis")
        return axes
    if not isinstance(axis, (int, np.integer)):
        raise TypeError(f"axis must be None or int or tuple of ints, got {type(axis)}")
    axis = int(axis)
    if ndim == 0:
        if axis in (0, -1):
            return 0
        raise ValueError(f"axis {axis} out of bounds for 0-dimensional array")
    if axis < 0:
        axis += ndim
    if not 0 <= axis < ndim:
        raise ValueError(f"axis {axis - ndim if axis >= ndim else axis} out of bounds for {ndim}-dimensional array")
    return axis


def sanitize_shape(shape, lval: int = 0) -> Tuple[int, ...]:
    """Normalize a shape argument to a tuple of non-negative ints."""
    if isinstance(shape, (int, np.integer)):
        shape = (int(shape),)
    out = []
    for dim in tuple(shape):
        if not isinstance(dim, (int, np.integer)):
            raise TypeError(f"expected sequence object with length >= 0 or a single integer, got {type(dim)}")
        dim = int(dim)
        if dim < lval:
            raise ValueError(f"negative dimensions are not allowed, got {dim}")
        out.append(dim)
    return tuple(out)


def sanitize_slice(sl: slice, max_dim: int) -> slice:
    """``sl`` with concrete non-negative start, stop and step for an axis of
    extent ``max_dim``."""
    if not isinstance(sl, slice):
        raise TypeError("This function is only for slices!")
    return slice(*sl.indices(max_dim))
