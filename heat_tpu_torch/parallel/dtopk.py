"""Top-k along the split axis with O(P·k) traffic (counterpart of
``heat_tpu/parallel/dtopk.py``).

Each rank takes its local top ``k' = min(k, chunk)`` by a stable sort of
order keys (:func:`local_topk`), one ``allgather`` brings the P·k'
candidates and their global indices to every rank, and a second stable
sort of the candidates, gathered in rank order, keeps the first k: ties go
to the lower global index at both stages, as ``lax.top_k`` breaks them.

The order is ``heat_tpu``'s: ``largest`` puts NaN first and then
decreasing values, the smallest values come in increasing order with NaN
last (``lax.top_k`` of the negated array, in which NaN turns negative).
On one device ``lax.top_k`` orders floats totally, -0.0 below +0.0
(``total_order``); along a split axis ``heat_tpu`` sorts with
``lax.sort``, to which the two zeros are equal.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ._keys import order_keys

__all__ = ["distributed_topk", "local_topk"]


def _keys(t: torch.Tensor, largest: bool, total_order: bool) -> torch.Tensor:
    return order_keys(t, descending=largest, signed_zeros=total_order)


def local_topk(t: torch.Tensor, k: int, axis: int, largest: bool = True, total_order: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the first ``k`` along ``axis`` in the order
    above (indices local, int64)."""
    idx = torch.sort(_keys(t, largest, total_order), dim=axis, stable=True)[1].narrow(axis, 0, k)
    return torch.take_along_dim(t, idx, dim=axis), idx


def distributed_topk(local: torch.Tensor, gshape, axis: int, k: int, comm, largest: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top ``k`` along ``axis`` of an array of ``gshape`` split along
    ``axis`` (``local`` its ceil-div chunk), and their int64 global
    indices, the same on every rank."""
    n = int(gshape[axis])
    if k > n:
        raise ValueError(f"selected index k={k} out of range for dimension of size {n}")
    off, lshape, _ = comm.chunk(gshape, axis)
    kp = min(k, lshape[axis])
    cv, ci = local_topk(local, kp, axis, largest, total_order=False)
    ci = ci + off
    counts = [min(k, int(c)) for c in comm.lshape_map(gshape, axis)[:, axis]]
    gv = comm.allgather(cv, axis, counts)
    gi = comm.allgather(ci, axis, counts)
    sel = torch.sort(_keys(gv, largest, False), dim=axis, stable=True)[1].narrow(axis, 0, k)
    return torch.take_along_dim(gv, sel, dim=axis), torch.take_along_dim(gi, sel, dim=axis)
