"""Linear algebra basics (counterpart of ``heat_tpu/core/linalg/basics.py``).

At world size 1 a product is one ``torch.matmul`` of the local tensors;
what this module keeps from ``heat_tpu`` is the shape check and the rule
for the result's split axis.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import types
from ..dndarray import DNDarray

__all__ = ["matmul", "transpose"]


def _matmul_gshape(sa: Tuple[int, ...], sb: Tuple[int, ...]) -> Tuple[int, ...]:
    """numpy's matmul result shape (1-D promotion, batch broadcast)."""
    a1, b1 = len(sa) == 1, len(sb) == 1
    ea = (1,) + tuple(sa) if a1 else tuple(sa)
    eb = tuple(sb) + (1,) if b1 else tuple(sb)
    if ea[-1] != eb[-2]:
        raise ValueError(f"matmul: contraction mismatch {sa} x {sb}")
    batch = np.broadcast_shapes(ea[:-2], eb[:-2])
    core = () if a1 and b1 else (eb[-1],) if a1 else (ea[-2],) if b1 else (ea[-2], eb[-1])
    return tuple(batch) + core


def _matmul_out_split(a: DNDarray, b: DNDarray, out_ndim: int) -> Optional[int]:
    """Result split: a row-split ``a`` gives row-split rows, a column-split
    ``b`` column-split columns, a split batch dimension of ``a`` stays
    split; a split contracted dimension gives a replicated result."""
    if a.ndim >= 2 and a.split == a.ndim - 2:
        return out_ndim - 2
    if b.ndim >= 2 and b.split == b.ndim - 1:
        return out_ndim - 1
    if a.split is not None and a.ndim >= 2 and a.split < a.ndim - 2:
        return a.split
    return None


def matmul(a: DNDarray, b: DNDarray, allow_resplit: bool = False) -> DNDarray:
    """Matrix product of two DNDarrays, with numpy's shape rules.
    ``allow_resplit`` is accepted for ``heat_tpu``'s signature."""
    if not isinstance(a, DNDarray) or not isinstance(b, DNDarray):
        raise TypeError("both operands must be DNDarrays")
    if a.ndim == 0 or b.ndim == 0:
        raise ValueError("matmul: operands must have ndim >= 1")
    promoted = types.promote_types(a.dtype, b.dtype)
    tt = promoted.torch_type()
    out_gshape = _matmul_gshape(a.gshape, b.gshape)
    result = torch.matmul(a._logical().to(tt), b._logical().to(tt))
    if result.ndim == 0:
        return DNDarray(result, dtype=promoted, split=None, device=a.device, comm=a.comm)
    split = _matmul_out_split(a, b, result.ndim)
    if split is not None:
        split %= len(out_gshape)
    return DNDarray(result, gshape=out_gshape, dtype=promoted, split=split, device=a.device, comm=a.comm)


def transpose(a: DNDarray, axes: Optional[List[int]] = None) -> DNDarray:
    """Permute dimensions (a view; no data moves). The split axis moves
    with its dimension."""
    if not isinstance(a, DNDarray):
        raise TypeError(f"a must be a DNDarray, got {type(a)}")
    if axes is None:
        axes = tuple(reversed(range(a.ndim)))
    else:
        axes = tuple(int(ax) % a.ndim if a.ndim else int(ax) for ax in axes)
        if len(axes) != a.ndim or sorted(axes) != list(range(a.ndim)):
            raise ValueError("axes do not match tensor shape")
    result = a.larray.permute(*axes)
    split = axes.index(a.split) if a.split is not None else None
    return DNDarray(result, dtype=a.dtype, split=split, device=a.device, comm=a.comm)
