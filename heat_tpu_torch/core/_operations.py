"""Generic operation machinery (counterpart of ``heat_tpu/core/_operations.py``).

What ``heat_tpu`` keeps here is the semantic layer around each op: heat type
promotion, broadcasting with split-axis compatibility and propagation,
reduction split bookkeeping and ``out=`` rewriting. The same rules apply
here over torch tensors, on each rank's chunk:

- a binary op runs on the chunks; a replicated operand is sliced to this
  rank's chunk along the split axis of the broadcast result (unless its
  extent there is 1), and a split operand with extent 1 on that axis is
  gathered first;
- a reduction over the split axis reduces each chunk (keeping the reduced
  dimensions), gathers the ranks' partial results (``allgather``) and
  reduces them again with the same function, skipping the ranks whose
  chunk is empty — so every rank holds the same bits, and NaN and
  empty-chunk rules are those of the local function;
- a cumulative op along the split axis adds (or multiplies by) the
  exclusive prefix of the ranks' totals.

A ragged array (:mod:`.dndarray`) computes in place, as in ``heat_tpu``
(``heat_tpu/core/_operations.py:116-268``): every rule above reads each
rank's rows and the layout's counts, so a reduction of the rows held, the
exclusive prefix of the ragged counts and an empty rank's neutral value
come out of the same code; the result keeps the layout wherever the split
axis survives. A binary op takes the first ragged operand's layout: an
operand in another layout (ragged or ceil-div) is aligned into it with one
``ragged_move``, a replicated one is sliced to this rank's rows. Ops that
change the shape of their input, and the ``out=``/``where=`` forms,
rebalance first (they read ``larray``).

Inside an open ``ht.lazy()`` scope each dispatcher first offers its call to
the lazy layer (``_capture``, installed by :mod:`.lazy`), which records it
or declines; a declined call runs here as always.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from . import _hooks, types
from .dndarray import DNDarray
from .stride_tricks import broadcast_shape, sanitize_axis

__all__ = ["_binary_op", "_cum_op", "_local_op", "_local_operand", "_real_only", "_reduce_op"]

# the lazy layer's capture module (heat_tpu_torch.core.lazy.capture), set when it is imported
_capture = None


def _as_dndarray(x, device=None, comm=None) -> DNDarray:
    from . import factories

    if isinstance(x, DNDarray):
        return x
    if _hooks.in_trace_safe():
        device = "cpu"  # a layout probe: a CPU scalar meets meta tensors, a card's would not
    return factories.array(x, device=device, comm=comm)


def _out_split_after_broadcast(ndim_out: int, operand: DNDarray) -> Optional[int]:
    """Where an operand's split axis lands in the broadcast output."""
    if operand.split is None:
        return None
    return operand.split + (ndim_out - operand.ndim)


def _local_operand(x: DNDarray, out_shape, out_split: Optional[int]) -> torch.Tensor:
    """``x``'s tensor as it meets this rank's chunk of a broadcast result of
    ``out_shape`` split along ``out_split``."""
    if not x.comm.is_distributed():
        return x.larray
    if out_split is None:
        return x._logical()
    ax = out_split - (len(out_shape) - x.ndim)
    if ax < 0 or x.gshape[ax] == 1:
        return x._logical()  # broadcast along the split axis: the whole operand
    if x.split == ax:
        return x.larray
    return x.larray[x.comm.chunk(out_shape, out_split)[2][len(out_shape) - x.ndim :]]


def _real_only(operation: Callable, name: str, error=TypeError) -> Callable:
    """``operation`` refusing complex tensors with ``error``, as ``heat_tpu``
    (jnp) refuses them where complex numbers have no order or no meaning."""

    def run(*tensors, **kwargs):
        if any(isinstance(t, torch.Tensor) and t.is_complex() for t in tensors):
            raise error(f"{name} does not support complex-valued inputs")
        return operation(*tensors, **kwargs)

    return run


def _ragged_operand(op: DNDarray, out_shape, j: int, lcounts, comm) -> Optional[torch.Tensor]:
    """``op``'s tensor as it meets this rank's rows of a result of
    ``out_shape`` in the ragged layout ``lcounts`` along ``j``: its own
    rows where it is in that layout, one ``ragged_move`` where it is split
    along ``j`` in another, this rank's rows of a replicated operand, the
    whole of an operand that broadcasts along ``j``; None where it needs the
    ceil-div route."""
    from ..parallel.flatmove import ragged_move

    jo = j - (len(out_shape) - op.ndim)
    if jo < 0 or op.gshape[jo] == 1:
        return op._logical()
    if op.gshape[jo] != out_shape[j]:
        return None
    # lcounts is replicated metadata: every rank takes the same branch, so all reach the same ragged_move
    if op.lcounts is not None:
        if op.split != jo:
            return None
        return op._raw if op.lcounts == tuple(lcounts) else ragged_move(op._raw, jo, op.lcounts, lcounts, comm)
    if op.split == jo:
        return ragged_move(op._raw, jo, comm.counts_displs_shape(op.gshape, jo)[0], lcounts, comm)
    if op.split is not None:
        return None
    start = sum(lcounts[: comm.rank])
    return op._logical().narrow(jo, start, lcounts[comm.rank])


def _ragged_binary(operation: Callable, a: DNDarray, b: DNDarray, out_shape, j: int, tt, device, comm,
                   fn_kwargs) -> Optional[DNDarray]:
    """A binary op computed in the first ragged operand's layout, or None
    where the pair takes the ceil-div route (the ragged operand broadcasts
    along the split axis)."""
    target = a if a.lcounts is not None else b
    jt = j - (len(out_shape) - target.ndim)
    if jt < 0 or target.gshape[jt] != out_shape[j]:
        return None
    lcounts = target.lcounts
    la = _ragged_operand(a, out_shape, j, lcounts, comm)
    lb = _ragged_operand(b, out_shape, j, lcounts, comm) if la is not None else None
    if lb is None:
        return None
    result = operation(la.to(tt), lb.to(tt), **fn_kwargs)
    return DNDarray._from_ragged(result, out_shape, types.canonical_heat_type(result.dtype), j, lcounts, device, comm)


def _binary_op(
    operation: Callable,
    t1,
    t2,
    out: Optional[DNDarray] = None,
    where=True,
    fn_kwargs: Optional[dict] = None,
) -> DNDarray:
    """Apply a binary torch op with heat promotion/broadcast/split rules."""
    if _capture is not None and _capture.active():
        res = _capture.binary(operation, t1, t2, out, where, fn_kwargs)
        if res is not NotImplemented:
            return res
    fn_kwargs = fn_kwargs or {}
    if not isinstance(t1, DNDarray) and not isinstance(t2, DNDarray):
        raise TypeError(
            f"Only DNDarrays and numeric scalars are supported, but input was {type(t1)}, {type(t2)}"
        )
    anchor = t1 if isinstance(t1, DNDarray) else t2
    device, comm = anchor.device, anchor.comm
    if isinstance(t1, DNDarray) and isinstance(t2, DNDarray):
        if t1.comm != t2.comm:
            raise ValueError("operands live on different communicators")
        if t1.device != t2.device:
            raise ValueError(f"operands live on different devices: {t1.device} and {t2.device}")
    promoted = types.result_type(t1, t2)
    a = _as_dndarray(t1, device, comm)
    b = _as_dndarray(t2, device, comm)
    out_shape = broadcast_shape(a.shape, b.shape)
    ndim_out = len(out_shape)
    sa = _out_split_after_broadcast(ndim_out, a)
    sb = _out_split_after_broadcast(ndim_out, b)
    if sa is not None and sb is not None and sa != sb:
        raise ValueError(f"DNDarrays must have the same split axes, found {a.split} and {b.split}")
    out_split = sa if sa is not None else sb
    tt = promoted.torch_type()
    if out is None and where is True and out_split is not None and (a.lcounts is not None or b.lcounts is not None):
        res = _ragged_binary(operation, a, b, out_shape, out_split, tt, device, comm, fn_kwargs)
        if res is not None:
            # graftflow: F004 - _ragged_binary declines on replicated layout metadata only
            return res
    la, lb = (_local_operand(v, out_shape, out_split).to(tt) for v in (a, b))
    result = operation(la, lb, **fn_kwargs)
    _, lshape, slices = comm.chunk(out_shape, out_split)
    if tuple(result.shape) != lshape:  # both operands whole along a split axis of extent 1
        result = result[slices]
    if where is not True:
        mask = _local_operand(_as_dndarray(where, device, comm), out_shape, out_split).to(torch.bool)
        base = out.larray.to(result.dtype) if out is not None else torch.zeros_like(result)
        result = torch.where(mask, result, base)
    res = DNDarray(
        result, gshape=out_shape, dtype=types.canonical_heat_type(result.dtype), split=out_split,
        device=device, comm=comm,
    )
    if out is not None:
        return _write_out(out, res)
    return res


def _local_op(
    operation: Callable,
    x: DNDarray,
    out: Optional[DNDarray] = None,
    no_cast: bool = False,
    out_dtype=None,
    **kwargs,
) -> DNDarray:
    """Elementwise op; split and layout are inherited (a ragged array
    computes in place; an op that changes the shape rebalances it first).
    Float-promoting math functions (``no_cast=False``) compute integer
    input in float (float32, or float64 for int64); float and complex input
    keeps its type."""
    if _capture is not None and _capture.active():
        res = _capture.local(operation, x, out, no_cast, out_dtype, kwargs)
        if res is not NotImplemented:
            return res
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
    arr = x._raw
    if not no_cast and out_dtype is None and not (arr.is_floating_point() or arr.is_complex()):
        arr = arr.to(types.promote_types(x.dtype, types.float32).torch_type())
    result = operation(arr, **kwargs)
    dtype = out_dtype if out_dtype is not None else types.canonical_heat_type(result.dtype)
    if x.lcounts is not None:
        if tuple(result.shape) != tuple(arr.shape):
            x.balance_()
            return _local_op(operation, x, out=out, no_cast=no_cast, out_dtype=out_dtype, **kwargs)
        res = DNDarray._from_ragged(result.to(dtype.torch_type()), x.gshape, dtype, x.split, x.lcounts, x.device,
                                    x.comm)
    else:
        res = DNDarray(result.to(dtype.torch_type()), gshape=x.gshape, dtype=dtype, split=x.split, device=x.device,
                       comm=x.comm)
    if out is not None:
        return _write_out(out, res)
    return res


def _reduce_op(
    operation: Callable,
    x: DNDarray,
    axis=None,
    out: Optional[DNDarray] = None,
    keepdims: bool = False,
    out_dtype=None,
    **kwargs,
) -> DNDarray:
    """Reduction along ``axis``. ``operation(tensor, axis, keepdims,
    **kwargs)`` receives the sanitized axis (None, int or tuple). A ragged
    array reduces the rows each rank holds; where the split axis survives,
    the result keeps the layout."""
    if _capture is not None and _capture.active():
        res = _capture.reduce(operation, x, axis, out, keepdims, out_dtype, kwargs)
        if res is not NotImplemented:
            return res
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
    axis = sanitize_axis(x.shape, axis)
    comm, split = x.comm, x.split
    axes = tuple(range(x.ndim)) if axis is None else ((axis,) if isinstance(axis, int) else tuple(axis))
    raw = x._raw
    if split is not None and split in axes and comm.is_distributed():
        local = raw
        if local.shape[split] == 0:
            # an empty chunk: a stand-in of one row gives the partial's shape and type; it is skipped below
            local = local.new_zeros(tuple(1 if d == split else s for d, s in enumerate(local.shape)))
        partial = operation(local, axis, True, **kwargs)
        result = _gather_partials(operation, x, partial, lambda: operation(raw, axis, True, **kwargs), **kwargs)
        if not keepdims:
            result = result.reshape(_reduced_shape(x.gshape, axis, False))
    else:
        result = operation(raw, axis, keepdims, **kwargs)
    dtype = out_dtype if out_dtype is not None else types.canonical_heat_type(result.dtype)
    res = _like_layout(x, result.to(dtype.torch_type()), _reduced_shape(x.gshape, axis, keepdims), dtype,
                       _reduced_split(split, axis, x.ndim, keepdims))
    if out is not None:
        return _write_out(out, res)
    return res


def _gather_partials(operation: Callable, x: DNDarray, partial: torch.Tensor, empty: Callable, **kwargs):
    """The reduction across ranks of ``partial``, this rank's chunk of ``x``
    reduced over the split axis (among others) with the reduced axes kept:
    one ``allgather``, then ``operation`` over the partials of the ranks
    whose chunk has rows, in rank order (every rank holds the same bits);
    ``empty()`` where no rank has any."""
    comm = x.comm
    parts = comm.allgather(partial.unsqueeze(0), 0, [1] * comm.size)
    keep = [r for r, n in enumerate(x.lshape_map[:, x.split]) if n > 0]
    return operation(parts[keep], 0, False, **kwargs) if keep else empty()


def _like_layout(x: DNDarray, t: torch.Tensor, gshape, dtype, split: Optional[int]) -> DNDarray:
    """The result ``t`` (this rank's part, of global ``gshape``, split along
    ``split``) of an op over ``x`` that keeps ``x``'s split axis as
    ``split``: in ``x``'s ragged layout where ``x`` has one, else ceil-div."""
    if x.lcounts is not None and split is not None:
        return DNDarray._from_ragged(t, gshape, dtype, split, x.lcounts, x.device, x.comm)
    return DNDarray(t, gshape=gshape, dtype=dtype, split=split, device=x.device, comm=x.comm)


def _over_axes(fn: Callable, t: torch.Tensor, axis, keepdims: bool) -> torch.Tensor:
    """``fn(t)`` over every axis when ``axis`` is None, else
    ``fn(t, dim=axis, keepdim=keepdims)`` (an int or a tuple of axes)."""
    if axis is None:
        r = fn(t)
        return r.reshape((1,) * t.ndim) if keepdims else r
    return fn(t, dim=axis, keepdim=keepdims)


def _cum_op(operation: Callable, x: DNDarray, axis, out: Optional[DNDarray] = None, dtype=None) -> DNDarray:
    """Cumulative op along one axis (``operation(tensor, axis)``, whose
    ``scan_op`` names its scan, ``"add"`` or ``"mul"``); split and shape are
    inherited. Along the split axis each rank runs the scan in two steps:
    its chunk's total, gathered from every rank, then the scan with the
    exclusive prefix of the earlier ranks' totals (folded by the same op in
    rank order, by the ragged counts of a ragged array, which keeps its
    layout) as its carry."""
    if _capture is not None and _capture.active():
        res = _capture.cum(operation, x, axis, out, dtype)
        if res is not NotImplemented:
            return res
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
    axis = sanitize_axis(x.shape, axis)
    if axis is None:
        raise NotImplementedError("cumulative ops require an explicit axis")
    arr = x._raw
    if dtype is not None:
        arr = arr.to(types.canonical_heat_type(dtype).torch_type())
    comm = x.comm
    if axis == x.split and comm.is_distributed():
        from .kernels.scan import scan_begin, scan_finish

        state = scan_begin(arr, axis, operation.scan_op)
        totals = comm.allgather(state.total, axis, [1] * comm.size)
        fold = torch.add if operation.scan_op == "add" else torch.mul
        carry = None
        for r, m in enumerate(x.lshape_map[:, axis]):
            if r < comm.rank and m > 0:
                t = totals.narrow(axis, r, 1)
                carry = t if carry is None else fold(carry, t)
        result = scan_finish(state, carry)
    else:
        result = operation(arr, axis)
    res = _like_layout(x, result, x.gshape, types.canonical_heat_type(result.dtype), x.split)
    if out is not None:
        return _write_out(out, res)
    return res


def _reduced_shape(gshape, axis, keepdims: bool) -> Tuple[int, ...]:
    """Logical shape after reducing ``axis``."""
    if axis is None:
        axes = tuple(range(len(gshape)))
    else:
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
    if keepdims:
        return tuple(1 if i in axes else s for i, s in enumerate(gshape))
    return tuple(s for i, s in enumerate(gshape) if i not in axes)


def _reduced_split(split: Optional[int], axis, ndim: int, keepdims: bool) -> Optional[int]:
    """Output split of a reduction (``heat_tpu/core/_operations.py:627-641``)."""
    if split is None or axis is None:
        return None
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    if split in axes:
        return None
    if keepdims:
        return split
    return split - sum(1 for a in axes if a < split)


def _write_out(out: DNDarray, result: DNDarray) -> DNDarray:
    """Rewrite ``out`` in place with ``result`` (out= semantics)."""
    if tuple(out.shape) != tuple(result.shape):
        raise ValueError(f"output shape {out.shape} does not match result shape {result.shape}")
    if out.split != result.split:
        result = result.resplit(out.split)
    out.larray.copy_(result.larray.to(out.larray.dtype))
    return out
