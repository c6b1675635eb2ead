"""``where`` and ``nonzero`` (counterpart of ``heat_tpu/core/indexing.py``)."""
from __future__ import annotations

import torch

from . import types
from ._operations import _local_operand
from .dndarray import DNDarray
from .stride_tricks import broadcast_shape

__all__ = ["nonzero", "where"]


def nonzero(x: DNDarray) -> DNDarray:
    """Coordinates of the nonzero elements as one (n, ndim) int64 array (1-D
    for 1-D input), split 0 if ``x`` is split, in row-major order. Its
    length is known only after the device has counted: this synchronizes
    with the host, as ``heat_tpu``'s does. Across ranks each rank finds its
    chunk's coordinates, shifts them to global ones and the lists are
    gathered (``allgather``); each rank keeps its ceil-div chunk of them."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
    result = torch.nonzero(x.larray)
    comm = x.comm
    if x.split is not None and comm.is_distributed():
        result[:, x.split] += comm.chunk(x.gshape, x.split)[0]
        result = comm.allgather(result, 0)
        if x.split != 0 and result.shape[0]:  # rank order is row-major order only along axis 0
            flat = torch.zeros(result.shape[0], dtype=torch.int64, device=result.device)
            for d, n in enumerate(x.gshape):
                flat = flat * n + result[:, d]
            result = result[torch.argsort(flat)]
        gshape = tuple(result.shape)
        result = result[comm.chunk(gshape, 0)[2]]
    else:
        gshape = tuple(result.shape)
    if x.ndim == 1:
        result = result.reshape(-1)
        gshape = gshape[:1]
    return DNDarray(result, gshape=gshape, dtype=types.int64, split=0 if x.split is not None else None,
                    device=x.device, comm=comm)


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
    split = cond.split
    if isinstance(x, DNDarray) and x.split is not None and split is None:
        split = x.split
    shape = broadcast_shape(cond.gshape, broadcast_shape(*(v.gshape if isinstance(v, DNDarray) else () for v in (x, y))))
    split = split if len(shape) == cond.ndim else None
    c, xs, ys = (
        _local_operand(v, shape, split) if isinstance(v, DNDarray) else torch.as_tensor(v, device=dev)
        for v in (cond, x, y)
    )
    result = torch.where(c.to(torch.bool), xs.to(tt), ys.to(tt))
    return DNDarray(result, gshape=shape, dtype=dtype, split=split, device=cond.device, comm=cond.comm)
