"""Input, output and distribution checks (counterpart of
``heat_tpu/core/sanitation.py``).

The shape and axis helpers (``sanitize_axis``, ``sanitize_shape``,
``sanitize_slice``, ``broadcast_shape``, ``broadcast_shapes``) live in
:mod:`.stride_tricks`, as in ``heat_tpu``; they are re-exported here so
either import path works.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import types
from .dndarray import DNDarray
from .stride_tricks import broadcast_shape, broadcast_shapes, sanitize_axis, sanitize_shape, sanitize_slice

__all__ = [
    "broadcast_shape",
    "broadcast_shapes",
    "sanitize_axis",
    "sanitize_distribution",
    "sanitize_in",
    "sanitize_in_tensor",
    "sanitize_infinity",
    "sanitize_lshape",
    "sanitize_out",
    "sanitize_sequence",
    "sanitize_shape",
    "sanitize_slice",
    "sanitize_split",
    "scalar_to_1d",
    "validate_layout",
]


def sanitize_in(x) -> None:
    """Require a DNDarray."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"input needs to be a DNDarray, but was {type(x)}")


def sanitize_in_tensor(x) -> None:
    """Require a ``torch.Tensor`` (the port's local array type)."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"input needs to be a torch.Tensor, but was {type(x)}")


def sanitize_infinity(x: DNDarray):
    """The largest value of ``x``'s dtype: the integer maximum, or inf."""
    if types.heat_type_is_exact(x.dtype):
        return torch.iinfo(x.dtype.torch_type()).max if x.dtype is not types.bool else True
    return float("inf")


def sanitize_out(out, output_shape, output_split, output_device, output_comm=None) -> None:
    """Check an ``out=`` array's type, shape and split."""
    if not isinstance(out, DNDarray):
        raise TypeError(f"expected out to be None or a DNDarray, but was {type(out)}")
    if tuple(out.shape) != tuple(output_shape):
        raise ValueError(f"Expecting output buffer of shape {tuple(output_shape)}, got {out.shape}")
    if out.split != output_split:
        raise ValueError(f"Expecting output buffer with split {output_split}, got {out.split}")


def sanitize_distribution(*args: DNDarray, target: DNDarray, diff_map=None):
    """The arguments split as ``target`` (a resplit where an argument of the
    same rank is split otherwise)."""
    out = []
    for arg in args:
        if not isinstance(arg, DNDarray):
            raise TypeError(f"expected DNDarray, got {type(arg)}")
        out.append(arg.resplit(target.split) if arg.split != target.split and arg.ndim == target.ndim else arg)
    return out[0] if len(out) == 1 else tuple(out)


def sanitize_sequence(seq) -> list:
    """A list from a list, tuple or DNDarray."""
    if isinstance(seq, list):
        return seq
    if isinstance(seq, tuple):
        return list(seq)
    if isinstance(seq, DNDarray):
        return seq.tolist()
    raise TypeError(f"seq must be a list, tuple or DNDarray, got {type(seq)}")


def sanitize_lshape(array: DNDarray, tensor) -> None:
    """Check that ``tensor`` has the shape of ``array``'s chunk on this rank."""
    if tuple(tensor.shape) != tuple(array.lshape):
        raise ValueError(f"local tensor shape {tuple(tensor.shape)} does not match lshape {array.lshape}")


def sanitize_split(shape, split) -> Optional[int]:
    """``split`` checked (and a negative one normalized) against ``shape``."""
    return sanitize_axis(tuple(int(s) for s in shape), split)


def validate_layout(gshape, split, lshape_map, comm) -> None:
    """Check that ``lshape_map`` has one row per rank and one column per
    dimension, that its split column sums to the split extent and that
    every other column equals the global extent; ValueError names the
    first violation."""
    gshape = tuple(int(s) for s in gshape)
    split = sanitize_split(gshape, split)
    lmap = np.asarray(lshape_map)
    if lmap.shape != (comm.size, len(gshape)):
        raise ValueError(f"lshape_map shape {lmap.shape} does not match (size, ndim) = ({comm.size}, {len(gshape)})")
    for d in range(len(gshape)):
        if split is not None and d == split:
            total = int(lmap[:, d].sum())
            if total != gshape[d]:
                raise ValueError(f"split-dim {d} shard extents {lmap[:, d].tolist()} sum to {total}, "
                                 f"but gshape[{d}] = {gshape[d]}")
        else:
            bad = [int(v) for v in lmap[:, d] if int(v) != gshape[d]]
            if bad:
                raise ValueError(f"non-split dim {d}: shard extents {lmap[:, d].tolist()} "
                                 f"disagree with gshape[{d}] = {gshape[d]}")


def scalar_to_1d(x: DNDarray) -> DNDarray:
    """A 0-d DNDarray as a 1-element 1-D one; other arrays unchanged."""
    if x.ndim != 0:
        return x
    return DNDarray(x.larray.reshape(1), dtype=x.dtype, split=None, device=x.device, comm=x.comm)
