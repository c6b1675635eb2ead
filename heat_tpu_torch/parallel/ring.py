"""Ring pipelines (counterpart of ``heat_tpu/parallel/ring.py``).

Each rank keeps its stationary block of ``x``, a block of ``y`` rotates
around the ring (``comm.ring_shift``: every rank sends to rank - 1 and
receives from rank + 1, as ``heat_tpu``'s ``ppermute`` does), and a tile
is computed per step: after step i a rank holds the block of rank
``(rank + i) % P``. ``P - 1`` rotations visit every block; peak memory is
one block of each plus the output row block. The port's
``spatial.cdist(..., use_ring=True)`` is this pattern with the distance as
the tile.

``x`` and ``y`` are DNDarrays split along axis 0 (then the result is a
DNDarray split along 0) or this rank's blocks as tensors (then the
result is this rank's block).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.communication import SPLIT_AXIS, TorchCommunication, sanitize_comm
from ..core.dndarray import DNDarray

__all__ = ["ring_map", "ring_reduce"]


def _blocks(x, y, comm, name: str):
    """This rank's blocks of ``x`` and ``y``, whose axis-0 extents the ranks
    must divide (every rank rotates blocks of one shape)."""
    p = comm.size
    if isinstance(x, DNDarray) or isinstance(y, DNDarray):
        if not (isinstance(x, DNDarray) and isinstance(y, DNDarray)):
            raise TypeError(f"{name} takes two DNDarrays or two tensors")
        if x.gshape[0] % p or y.gshape[0] % p:
            raise ValueError(
                f"{name} requires axis-0 sizes divisible by the mesh ({x.gshape[0]}, {y.gshape[0]} vs {p})"
            )
        return (x if x.split == 0 else x.resplit(0)).larray, (y if y.split == 0 else y.resplit(0)).larray
    return x, y


def _wrap(t: torch.Tensor, like, comm) -> object:
    """``t`` as a DNDarray split along 0 when the inputs were DNDarrays."""
    if not isinstance(like, DNDarray):
        return t
    return DNDarray(t, gshape=(t.shape[0] * comm.size,) + tuple(t.shape[1:]), split=0, device=like.device, comm=comm)


def ring_map(tile_fn: Callable, x, y, comm: Optional[TorchCommunication] = None, axis_name: str = SPLIT_AXIS):
    """All (x block, y block) tiles with a rotating ``y``: ``tile_fn(x_block,
    y_block)`` gives an (mx, ny, ...) tile; the result is the (M, N, ...)
    array of the tiles, split along axis 0."""
    comm = sanitize_comm(comm if comm is not None else getattr(x, "comm", None))
    xb, yb = _blocks(x, y, comm, "ring_map")
    p, me, n_local = comm.size, comm.rank, yb.shape[0]
    out, yblk = None, yb
    for i in range(p):
        tile = tile_fn(xb, yblk)
        if out is None:
            out = tile.new_zeros((xb.shape[0], n_local * p) + tuple(tile.shape[2:]))
        src = (me + i) % p  # the owner of the block held now
        out[:, src * n_local : (src + 1) * n_local] = tile
        if i < p - 1:
            yblk = comm.ring_shift(yblk)
    return _wrap(out, x, comm)


def ring_reduce(tile_fn: Callable, combine_fn: Callable, init: Callable, x, y,
                comm: Optional[TorchCommunication] = None, axis_name: str = SPLIT_AXIS):
    """Fold every tile into a running state instead of keeping the (M, N)
    product: ``state = combine_fn(state, tile_fn(x_block, y_block))`` from
    ``init(x_block)``; the ranks' states, stacked along axis 0."""
    comm = sanitize_comm(comm if comm is not None else getattr(x, "comm", None))
    xb, yb = _blocks(x, y, comm, "ring_reduce")
    state, yblk = init(xb), yb
    for i in range(comm.size):
        state = combine_fn(state, tile_fn(xb, yblk))
        if i < comm.size - 1:
            yblk = comm.ring_shift(yblk)
    return _wrap(state, x, comm)
