"""Memory helpers (counterpart of ``heat_tpu/core/memory.py``)."""
from __future__ import annotations

from .dndarray import DNDarray

__all__ = ["copy", "sanitize_memory_layout"]


def copy(x: DNDarray) -> DNDarray:
    """A deep copy: a new tensor with the same values and metadata, in the
    same layout (a ragged array's copy is ragged alike)."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"input needs to be a DNDarray, but was {type(x)}")
    if x.lcounts is not None:
        return DNDarray._from_ragged(x._raw.clone(), x.gshape, x.dtype, x.split, x.lcounts, x.device, x.comm)
    return DNDarray(x.larray.clone(), gshape=x.gshape, dtype=x.dtype, split=x.split, device=x.device, comm=x.comm)


def sanitize_memory_layout(x, order: str = "C"):
    """Accept ``order`` ``"C"`` or ``"F"``; arrays are always C-ordered."""
    if order not in ("C", "F"):
        raise ValueError(f"order must be 'C' or 'F', got {order}")
    return x
