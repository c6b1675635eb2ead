"""Interval and bucket exchanges along the split axis (counterpart of
``heat_tpu/parallel/flatmove.py``).

A redistribution between two partitions of an axis into contiguous
intervals, rank order preserved, moves the overlaps of the two partitions:
rank r holds rows ``[A_r, A_r + L_r)`` and needs ``[B_r, B_r + M_r)``. Each
nonempty overlap is an :class:`Edge` ``(src, dst, src_off, dst_off,
length)``. :func:`flat_schedule` lists them and colors them into rounds in
which every rank sends and receives at most once; :func:`bucket_schedule`
does the same for a bucketed exchange (``matrix[r][d]`` rows from r to d,
the shuffle's Alltoallv). Both are pure numpy and give ``heat_tpu``'s edges
and rounds.

``heat_tpu`` runs each round as one ``ppermute`` of a fixed-size piece over
padded buffers. The port runs on this rank's tensor and needs no rounds:
a self-edge is a local copy, and every other edge of this rank is one send
or one receive of exactly its rows, all posted as one batch of the port's
``comm.exchange`` (an edge of no rows posts nothing). So each row crosses
the wire once, and what a rank receives (``RECEIVED``) is exactly the rows
it lacks. Every rank calls each move with the same counts (they are
replicated metadata), so the batches match.

- :func:`ragged_move`: this rank's rows of one partition of the split axis
  into another (``redistribute_``, ``balance_``, the alignment of two
  ragged operands);
- :func:`bucket_move`: a bucketed exchange;
- :func:`strided_take`: ``[start:stop:step]`` along the split axis of an
  array in the ceil-div layout, as the selection's ceil-div chunk;
- :func:`reshape_via_flatmove`: a split-0 array reshaped to another
  split-0 shape, by C-order flat offsets.

``MOVE_STATS`` counts every move as ``heat_tpu`` does: ``ragged_moves`` per
dispatch, ``bucket_moves`` as a sub-count, and ``tree_merges`` /
``tree_merge_rounds`` for :func:`heat_tpu_torch.core.communication.tree_merge`.
Each move runs through the fault point ``collective.<label>`` and the
guarded call ``flatmove.<label>`` of :mod:`heat_tpu_torch.core._hooks`.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..core import _hooks

__all__ = [
    "Edge",
    "MOVE_STATS",
    "bucket_move",
    "bucket_schedule",
    "flat_schedule",
    "ragged_move",
    "reshape_via_flatmove",
    "strided_take",
]

# Running count of dispatched exchanges (see the module's docstring).
MOVE_STATS = {
    "ragged_moves": 0,
    "bucket_moves": 0,
    "tree_merges": 0,
    "tree_merge_rounds": 0,
}


class Edge(NamedTuple):
    src: int
    dst: int
    src_off: int  # offset inside the source's local block
    dst_off: int  # offset inside the destination's local block
    length: int


def flat_schedule(in_counts: Sequence[int], out_counts: Sequence[int]) -> Tuple[List[Edge], List[List[Edge]]]:
    """(self_edges, rounds): the overlaps of two interval partitions with
    the same total, colored into rounds of at most one send and one receive
    per rank."""
    p = len(in_counts)
    a = np.concatenate([[0], np.cumsum(in_counts)])
    b = np.concatenate([[0], np.cumsum(out_counts)])
    if a[-1] != b[-1]:
        raise ValueError(f"count sums differ: {a[-1]} vs {b[-1]}")
    edges: List[Edge] = []
    d = 0
    for r in range(p):
        if in_counts[r] == 0:
            continue
        while d < p and b[d + 1] <= a[r]:
            d += 1
        dd = d
        while dd < p and b[dd] < a[r + 1]:
            lo = max(int(a[r]), int(b[dd]))
            hi = min(int(a[r + 1]), int(b[dd + 1]))
            if hi > lo:
                edges.append(Edge(r, dd, lo - int(a[r]), lo - int(b[dd]), hi - lo))
            dd += 1
    return _color(edges)


def _color(edges: List[Edge]) -> Tuple[List[Edge], List[List[Edge]]]:
    """Split the self-edges off and greedily color the rest: in one color
    every rank is at most once a source and once a destination."""
    self_edges = [e for e in edges if e.src == e.dst]
    rest = [e for e in edges if e.src != e.dst]
    src_used: dict = {}
    dst_used: dict = {}
    colored: dict = {}
    for e in rest:
        c = 0
        while c in src_used.get(e.src, ()) or c in dst_used.get(e.dst, ()):
            c += 1
        src_used.setdefault(e.src, set()).add(c)
        dst_used.setdefault(e.dst, set()).add(c)
        colored.setdefault(c, []).append(e)
    return self_edges, [colored[c] for c in sorted(colored)]


def bucket_schedule(matrix: Sequence[Sequence[int]]) -> Tuple[List[Edge], List[List[Edge]]]:
    """(self_edges, rounds) of a bucketed exchange: ``matrix[r][d]`` rows go
    from r to d; on r the outgoing buckets lie destination-major from offset
    0, on d the incoming ones land source-major from offset 0."""
    m = np.asarray(matrix, dtype=np.int64)
    if m.ndim != 2 or m.shape[0] != m.shape[1]:
        raise ValueError(f"bucket matrix must be square, got shape {m.shape}")
    if (m < 0).any():
        raise ValueError("bucket matrix has negative counts")
    p = m.shape[0]
    src_off = np.concatenate([np.zeros((p, 1), np.int64), np.cumsum(m, axis=1)], axis=1)
    dst_off = np.concatenate([np.zeros((1, p), np.int64), np.cumsum(m, axis=0)], axis=0)
    edges = [
        Edge(r, d, int(src_off[r, d]), int(dst_off[r, d]), int(m[r, d]))
        for r in range(p)
        for d in range(p)
        if m[r, d] > 0
    ]
    return _color(edges)


def _bounded_exchange(label: str, fn, shape):
    """Run one exchange ``fn()`` through the fault point
    ``collective.<label>`` and the guarded call ``flatmove.<label>``."""

    def dispatch():
        _hooks.fault_point(f"collective.{label}", shape=tuple(shape))
        return fn()

    return _hooks.guarded_call(f"flatmove.{label}", dispatch)


def _exchange(rows: torch.Tensor, edges: Tuple[List[Edge], List[List[Edge]]], n_out: int, label: str,
              comm) -> torch.Tensor:
    """Apply a schedule to this rank's rows (axis 0 of ``rows``): the
    (``n_out``, ...) block this rank ends with. Self-edges copy locally;
    the other edges of this rank go as one batch of ``comm.exchange``."""
    self_edges, rounds = edges
    me = comm.rank
    out = rows.new_empty((n_out,) + tuple(rows.shape[1:]))
    for e in self_edges:
        if e.src == me:
            out[e.dst_off : e.dst_off + e.length] = rows[e.src_off : e.src_off + e.length]
    remote = [e for rnd in rounds for e in rnd]
    sends = {e.dst: rows[e.src_off : e.src_off + e.length] for e in remote if e.src == me}
    recvs = {e.src: (e.length,) + tuple(rows.shape[1:]) for e in remote if e.dst == me}
    got = comm.exchange(f"flatmove.{label}", sends, recvs, rows) if (sends or recvs) else {}
    for e in remote:
        if e.dst == me:
            out[e.dst_off : e.dst_off + e.length] = got[e.src]
    return out


def _along(local: torch.Tensor, split: int, edges, n_out: int, label: str, comm) -> torch.Tensor:
    """:func:`_exchange` of whole hyperplanes along ``split``."""
    rows = local.movedim(split, 0)
    return _exchange(rows, edges, n_out, label, comm).movedim(0, split).contiguous()


def ragged_move(local: torch.Tensor, split: int, in_counts: Sequence[int], out_counts: Sequence[int],
                comm) -> torch.Tensor:
    """This rank's rows along ``split`` after moving an array whose rank r
    holds ``in_counts[r]`` of them (``local`` this rank's) into the
    partition ``out_counts`` (any counts, zero included, the same total):
    the (``out_counts[rank]``, ...) block. Every rank calls it with the same
    counts. Counted once in ``MOVE_STATS["ragged_moves"]``."""
    in_counts = tuple(int(c) for c in in_counts)
    out_counts = tuple(int(c) for c in out_counts)
    if len(in_counts) != comm.size or len(out_counts) != comm.size:
        raise ValueError(f"count maps must have length {comm.size}")
    if local.shape[split] != in_counts[comm.rank]:
        raise ValueError(f"rank {comm.rank} holds {local.shape[split]} rows, the map says {in_counts[comm.rank]}")
    edges = flat_schedule(in_counts, out_counts)
    MOVE_STATS["ragged_moves"] += 1
    return _bounded_exchange("ragged", lambda: _along(local, split, edges, out_counts[comm.rank], "ragged", comm),
                             local.shape)


# graftflow: DRIFT - its exchange runs inside a lambda handed to _bounded_exchange
def bucket_move(local: torch.Tensor, split: int, matrix: Sequence[Sequence[int]], comm) -> torch.Tensor:
    """One bucketed exchange: this rank's outgoing rows lie along ``split``
    destination-major from offset 0 (``matrix[rank][d]`` rows for rank d,
    in rank order); returns the incoming rows, source-major, all
    ``sum(matrix[r][rank] for r)`` of them. Counted in ``MOVE_STATS`` as a
    ragged move and a bucket move."""
    m = tuple(tuple(int(c) for c in row) for row in matrix)
    p = comm.size
    if len(m) != p or any(len(row) != p for row in m):
        raise ValueError(f"bucket matrix must be {p}x{p}")
    if sum(m[comm.rank]) > local.shape[split]:
        raise ValueError("a source's outgoing rows exceed its block size")
    edges = bucket_schedule(m)
    n_out = sum(row[comm.rank] for row in m)
    MOVE_STATS["ragged_moves"] += 1
    MOVE_STATS["bucket_moves"] += 1
    return _bounded_exchange("bucket", lambda: _along(local, split, edges, n_out, "bucket", comm), local.shape)


def _t_interval(lo: int, hi: int, start: int, step: int, m: int) -> Tuple[int, int]:
    """The indices t in [0, m) with lo <= start + step*t < hi, as (t0, t1), step > 0."""
    t0 = max(0, -(-(lo - start) // step))
    t1 = min(m, (hi - 1 - start) // step + 1) if hi > start else 0
    return t0, max(t0, t1)


def strided_take(local: torch.Tensor, split: int, n_logical: int, start: int, stop: int, step: int,
                 comm) -> Tuple[torch.Tensor, int]:
    """``[start:stop:step]`` (``step > 0``) along ``split`` of an array of
    extent ``n_logical`` there, in the ceil-div layout (``local`` this
    rank's chunk): ``(this rank's ceil-div chunk of the selection, m)``
    with ``m`` the selection's extent. Each rank compacts its selected rows,
    then one exchange moves them to their chunks."""
    if step <= 0:
        raise ValueError("strided_take requires step > 0")
    p = comm.size
    m = len(range(start, stop, step))
    counts, displs, _ = comm.counts_displs_shape((n_logical,), 0)
    in_counts, offs = [], []
    for r in range(p):
        lo, hi = displs[r], displs[r] + counts[r]
        t0, t1 = _t_interval(lo, hi, start, step, m) if hi > lo else (0, 0)
        in_counts.append(t1 - t0)
        offs.append(start + step * t0 - lo if t1 > t0 else 0)
    me = comm.rank
    rows = local.movedim(split, 0)
    compact = rows[offs[me] : offs[me] + step * in_counts[me] : step] if in_counts[me] else rows[:0]
    out_counts = comm.counts_displs_shape((m,), 0)[0]
    edges = flat_schedule(in_counts, out_counts)
    out = _bounded_exchange("strided", lambda: _exchange(compact, edges, out_counts[me], "strided", comm),
                            local.shape)
    return out.movedim(0, split).contiguous(), m


def reshape_via_flatmove(local: torch.Tensor, gshape, out_shape, comm) -> torch.Tensor:
    """This rank's ceil-div chunk (split 0) of the array of ``gshape``
    (split 0, ``local`` its chunk) reshaped to ``out_shape``: the exchange
    of C-order flat offsets, each element sent once."""
    gshape, out_shape = tuple(int(s) for s in gshape), tuple(int(s) for s in out_shape)
    if int(np.prod(gshape, dtype=np.int64)) != int(np.prod(out_shape, dtype=np.int64)):
        raise ValueError(f"cannot reshape {gshape} into {out_shape}")
    in_inner = int(np.prod(gshape[1:], dtype=np.int64))
    out_inner = int(np.prod(out_shape[1:], dtype=np.int64))
    in_counts = [c * in_inner for c in comm.counts_displs_shape(gshape, 0)[0]]
    out_rows = comm.counts_displs_shape(out_shape, 0)[0]
    edges = flat_schedule(in_counts, [c * out_inner for c in out_rows])
    me = comm.rank
    out = _bounded_exchange("reshape", lambda: _exchange(local.reshape(-1), edges, out_rows[me] * out_inner,
                                                         "reshape", comm), local.shape)
    return out.reshape((out_rows[me],) + out_shape[1:])
