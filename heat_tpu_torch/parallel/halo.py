"""Halo exchange along the split axis (counterpart of ``heat_tpu/parallel/halo.py``).

``heat_tpu`` runs a pair of ``ppermute`` inside ``shard_map``; the port runs
SPMD as :meth:`DNDarray.get_halo` does: every rank sends its block's head
to the previous rank and its tail to the next, two ``comm.ring_shift``
calls, and gets back its own extended block ``(halo_prev, block,
halo_next)``. The exchange is cyclic like ``heat_tpu``'s: rank 0's
``halo_prev`` is the last rank's tail. A split extent the ranks do not
divide is tail-padded with zeros first, so the end halos hold zeros where
the padding reaches them, as in ``heat_tpu``'s pad-and-trim.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.communication import SPLIT_AXIS, TorchCommunication, sanitize_comm
from ..core.dndarray import DNDarray

__all__ = ["exchange", "halo_exchange"]


def exchange(block: torch.Tensor, halo_size: int, comm: Optional[TorchCommunication] = None,
             axis_name: str = SPLIT_AXIS) -> Tuple[torch.Tensor, torch.Tensor]:
    """(halo_prev, halo_next) of this rank's ``block`` (axis 0): the last
    ``halo_size`` rows of the previous rank's block and the first
    ``halo_size`` of the next one's, cyclically. Every rank calls it with a
    block of the same shape."""
    comm = sanitize_comm(comm)
    halo_prev = comm.ring_shift(block[-halo_size:], -1)  # my tail goes to the next rank
    halo_next = comm.ring_shift(block[:halo_size], 1)  # my head goes to the previous rank
    return halo_prev, halo_next


def halo_exchange(x: DNDarray, halo_size: int, comm: Optional[TorchCommunication] = None,
                  axis_name: str = SPLIT_AXIS) -> DNDarray:
    """Every rank's block of ``x`` along axis 0 with its halos attached: a
    (P, ceil(N/P) + 2 halo_size, ...) array split along 0, whose rank-r
    slice is rank r's zero-padded ceil-div block between its neighbours'
    halos (``heat_tpu``'s array)."""
    comm = sanitize_comm(comm if comm is not None else x.comm)
    if x.split != 0:
        x = x.resplit(0)
    p, n = comm.size, x.gshape[0]
    block = -(-n // p) if n else 0
    local = x.larray
    if local.shape[0] < block:
        local = torch.cat([local, local.new_zeros((block - local.shape[0],) + tuple(local.shape[1:]))])
    prev, nxt = exchange(local, halo_size, comm, axis_name)
    ext = torch.cat([prev, local, nxt])[None]
    return DNDarray(ext, gshape=(p,) + tuple(ext.shape[1:]), dtype=x.dtype, split=0, device=x.device, comm=comm)
