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
    chunk's coordinates, one ``allgather`` of the ranks' counts and their
    exclusive scan give every coordinate its slot in the result, and one
    ``alltoall`` sends it to the rank that owns that slot
    (:func:`heat_tpu_torch.parallel.dscan.nonzero_scan`). A ragged array is
    scanned where its rows lie, offset by the ragged displacements."""
    from ..parallel.dscan import nonzero_scan

    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
    comm = x.comm
    if x.split is not None and comm.is_distributed():
        ragged = x.counts_displs() if x.lcounts is not None else None
        result, total = nonzero_scan(x._raw, x.gshape, x.split, comm, ragged=ragged)
        gshape = (total, x.ndim)
    else:
        result = torch.nonzero(x.larray)
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
