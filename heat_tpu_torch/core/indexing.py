"""``where`` and ``nonzero`` (counterpart of ``heat_tpu/core/indexing.py``)."""
from __future__ import annotations

import torch

from . import types
from .dndarray import DNDarray

__all__ = ["nonzero", "where"]


def nonzero(x: DNDarray) -> DNDarray:
    """Coordinates of the nonzero elements as one (n, ndim) int64 array (1-D
    for 1-D input), split 0 if ``x`` is split. Its length is known only
    after the device has counted: this synchronizes with the host, as
    ``heat_tpu``'s does."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
    result = torch.nonzero(x.larray)
    if x.ndim == 1:
        result = result.reshape(-1)
    return DNDarray(result, dtype=types.int64, split=0 if x.split is not None else None, device=x.device, comm=x.comm)


def where(cond: DNDarray, x=None, y=None) -> DNDarray:
    """``x`` where ``cond`` holds, else ``y``; ``nonzero(cond)`` when both
    are omitted. The result type is ``jnp.where``'s (a python scalar is
    weakly typed), its split ``cond``'s, else ``x``'s."""
    if x is None and y is None:
        return nonzero(cond)
    if x is None or y is None:
        raise TypeError("either both or neither of x and y should be given")
    dtype = types._weak_result_type(x, y)
    tt, dev = dtype.torch_type(), cond.larray.device
    xs, ys = (v.larray if isinstance(v, DNDarray) else torch.as_tensor(v, device=dev) for v in (x, y))
    result = torch.where(cond.larray.to(torch.bool), xs.to(tt), ys.to(tt))
    split = cond.split
    if isinstance(x, DNDarray) and x.split is not None and split is None:
        split = x.split
    return DNDarray(
        result, dtype=dtype, split=split if result.ndim == cond.ndim else None, device=cond.device, comm=cond.comm
    )
