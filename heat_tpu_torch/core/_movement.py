"""Data movement along the split axis (counterpart of ``heat_tpu/core/_movement.py``).

``heat_tpu`` compiles each movement into one padded-buffer program that
XLA partitions. The port states the behaviour instead: every movement is
a set of global row intervals that each rank needs along one axis, and
:func:`fetch` brings each rank exactly those rows from the ranks that
hold them, in one ``alltoall`` (nothing moves at world size 1, and a rank
sends only rows another rank asked for). Everything the ranks need to
know about the wanted intervals follows from shapes, so every rank
computes every other rank's request and no request is sent.

On top of it:

- :func:`reshape_rows`: a reshape of a split-0 array into a split-0
  array, a redistribution by global flat offsets;
- :func:`take_intervals`: the rows ``[lo, hi)`` pieces of an array in the
  ceil-div layout, for ``roll``, ``flip``, ``pad``, ``unfold``,
  ``concatenate``, ``diff`` and the strided ``__getitem__``.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["ceil_div_layout", "fetch", "reshape_rows", "runs", "take_intervals", "take_rows"]

Interval = Tuple[int, int]


def ceil_div_layout(n: int, comm) -> Tuple[List[int], List[int]]:
    """``(starts, counts)`` of the ranks' ceil-div chunks of an axis of
    extent ``n``."""
    counts, displs, _ = comm.counts_displs_shape((n,), 0)
    return list(displs), list(counts)


def fetch(
    local: torch.Tensor,
    axis: int,
    starts: Sequence[int],
    counts: Sequence[int],
    wants: Callable[[int], List[Interval]],
    comm,
) -> List[torch.Tensor]:
    """The rows of each interval ``wants(comm.rank)`` along ``axis``.

    ``local`` holds the global rows ``[starts[me], starts[me] + counts[me])``
    of an array whose ranks hold contiguous, disjoint row ranges;
    ``wants(r)`` lists the global ``(lo, hi)`` row intervals rank r needs,
    and gives the same answer on every rank. Returns one tensor per
    interval of this rank, in order. One ``alltoall`` carries exactly the
    rows asked for."""
    me = comm.rank
    s0, c0 = int(starts[me]), int(counts[me])
    mine = [(int(lo), int(hi)) for lo, hi in wants(me)]
    if not comm.is_distributed():
        return [local.narrow(axis, lo - s0, hi - lo) for lo, hi in mine]
    src = local
    empty = src.narrow(axis, 0, 0)
    blocks = []
    for r in range(comm.size):
        pieces = []
        for lo, hi in wants(r):
            a, b = max(int(lo), s0), min(int(hi), s0 + c0)
            if b > a:
                pieces.append(src.narrow(axis, a - s0, b - a))
        blocks.append(torch.cat(pieces, dim=axis) if pieces else empty)
    sizes, shapes = [], []
    for q in range(comm.size):
        sq, cq = int(starts[q]), int(counts[q])
        lens = [max(0, min(hi, sq + cq) - max(lo, sq)) for lo, hi in mine]
        sizes.append(lens)
        shape = list(src.shape)
        shape[axis] = sum(lens)
        shapes.append(tuple(shape))
    parts = comm.alltoall(blocks, shapes)
    pieces = [torch.split(parts[q], sizes[q], dim=axis) if mine else () for q in range(comm.size)]
    order = sorted(range(comm.size), key=lambda q: int(starts[q]))
    out = []
    for i in range(len(mine)):
        segs = [pieces[q][i] for q in order if sizes[q][i] > 0]
        t = torch.cat(segs, dim=axis) if segs else empty
        out.append(t)
    return out


def take_intervals(local: torch.Tensor, gshape, axis: int, wants: Callable[[int], List[Interval]], comm) -> List[torch.Tensor]:
    """:func:`fetch` from an array of ``gshape`` in the ceil-div layout
    along ``axis``."""
    starts, counts = ceil_div_layout(int(gshape[axis]), comm)
    return fetch(local, axis, starts, counts, wants, comm)


def runs(idx) -> List[Interval]:
    """The distinct values of the integer array ``idx`` as sorted runs of
    consecutive integers, ``(lo, hi)``."""
    u = np.unique(np.asarray(idx, dtype=np.int64))
    if not u.size:
        return []
    cut = np.nonzero(np.diff(u) != 1)[0] + 1
    return [(int(r[0]), int(r[-1]) + 1) for r in np.split(u, cut)]


def take_rows(local: torch.Tensor, gshape, axis: int, rows: Callable[[int], np.ndarray], comm) -> torch.Tensor:
    """The rows ``rows(comm.rank)`` (global indices along ``axis``, any
    order, repeats allowed) of an array of ``gshape`` in the ceil-div
    layout; ``rows(r)`` gives every rank's wanted rows on every rank. The
    runs of distinct rows are fetched (:func:`fetch`), then indexed."""
    mine = np.asarray(rows(comm.rank), dtype=np.int64)
    got = take_intervals(local, gshape, axis, lambda r: runs(rows(r)), comm)
    if not got:
        shape = list(local.shape)
        shape[axis] = 0
        return local.new_empty(shape)
    held = torch.cat(got, dim=axis)
    base = np.concatenate([np.arange(lo, hi) for lo, hi in runs(mine)])
    pos = torch.as_tensor(np.searchsorted(base, mine), device=local.device)
    return held.index_select(axis, pos)


def reshape_rows(local: torch.Tensor, gshape, shape, comm) -> torch.Tensor:
    """This rank's split-0 chunk of the array of ``gshape`` (split 0,
    ceil-div; ``local`` its chunk) reshaped to ``shape``: the C-order
    flat offsets of the rows each rank needs, fetched by one ``alltoall``."""
    rs_in = int(np.prod(gshape[1:], dtype=np.int64))
    rs_out = int(np.prod(shape[1:], dtype=np.int64))
    starts, counts = ceil_div_layout(int(gshape[0]), comm)
    out_starts, out_counts = ceil_div_layout(int(shape[0]), comm)
    flat = local.reshape(-1)
    got = fetch(
        flat, 0, [s * rs_in for s in starts], [c * rs_in for c in counts],
        lambda r: [(out_starts[r] * rs_out, (out_starts[r] + out_counts[r]) * rs_out)], comm,
    )[0]
    return got.reshape((out_counts[comm.rank],) + tuple(shape[1:]))
