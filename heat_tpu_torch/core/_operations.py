"""Generic operation machinery (counterpart of ``heat_tpu/core/_operations.py``).

What ``heat_tpu`` keeps here is the semantic layer around each op: heat type
promotion, broadcasting with split-axis compatibility and propagation,
reduction split bookkeeping and ``out=`` rewriting. The same rules apply
here over torch tensors. At world size 1 there is no padding to align or
mask, so operands are used as they are.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from . import types
from .dndarray import DNDarray
from .stride_tricks import broadcast_shape, sanitize_axis

__all__ = ["_binary_op", "_local_op", "_reduce_op"]


def _as_dndarray(x, device=None, comm=None) -> DNDarray:
    from . import factories

    if isinstance(x, DNDarray):
        return x
    return factories.array(x, device=device, comm=comm)


def _out_split_after_broadcast(ndim_out: int, operand: DNDarray) -> Optional[int]:
    """Where an operand's split axis lands in the broadcast output."""
    if operand.split is None:
        return None
    return operand.split + (ndim_out - operand.ndim)


def _binary_op(
    operation: Callable,
    t1,
    t2,
    out: Optional[DNDarray] = None,
    where=True,
    fn_kwargs: Optional[dict] = None,
) -> DNDarray:
    """Apply a binary torch op with heat promotion/broadcast/split rules."""
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
    result = operation(a.larray.to(tt), b.larray.to(tt), **fn_kwargs)
    if where is not True:
        mask = _as_dndarray(where, device, comm).larray.to(torch.bool)
        base = out.larray.to(result.dtype) if out is not None else torch.zeros_like(result)
        result = torch.where(mask, result, base)
    res = DNDarray(result, dtype=types.canonical_heat_type(result.dtype), split=out_split, device=device, comm=comm)
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
    """Elementwise op; split is inherited. Float-promoting math functions
    (``no_cast=False``) compute integer input in float."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
    arr = x.larray
    if not no_cast and out_dtype is None and not arr.is_floating_point():
        arr = arr.to(types.promote_types(x.dtype, types.float32).torch_type())
    result = operation(arr, **kwargs)
    dtype = out_dtype if out_dtype is not None else types.canonical_heat_type(result.dtype)
    res = DNDarray(
        result.to(dtype.torch_type()),
        dtype=dtype,
        split=x.split if result.ndim == x.ndim else None,
        device=x.device,
        comm=x.comm,
    )
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
    **kwargs)`` receives the sanitized axis (None, int or tuple)."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
    axis = sanitize_axis(x.shape, axis)
    result = operation(x.larray, axis, keepdims, **kwargs)
    dtype = out_dtype if out_dtype is not None else types.canonical_heat_type(result.dtype)
    res = DNDarray(
        result.to(dtype.torch_type()),
        dtype=dtype,
        split=_reduced_split(x.split, axis, x.ndim, keepdims),
        device=x.device,
        comm=x.comm,
    )
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
    out.larray.copy_(result.larray.to(out.larray.dtype))
    return out
