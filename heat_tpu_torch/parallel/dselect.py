"""Exact order statistics without gathering the data: sorted segments and
a bisection of the key space.

Each wanted order statistic is a rank ``r`` in the sorted values of one
column of one segment (a column of the array, or of the rows of one
cluster). Each rank sorts the order-preserving keys of
:func:`._keys.radix_keys` within every segment and column of its own
rows. On one rank the statistic is then the key at position ``r``. Across
ranks the key is found bit by bit from the top: a candidate key is kept
where fewer than ``r + 1`` keys of the segment, over all ranks, lie below
it, which every rank counts in its sorted keys by ``searchsorted`` and one
``allreduce`` of ``T·S·m`` counts sums — 32 rounds for 32-bit keys, 64
for 64-bit ones, whatever the number of rows. The result is the value a
sort of all the rows would put at rank ``r``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ._keys import from_radix_keys, radix_keys

__all__ = ["select_values"]

_I64_MIN = torch.iinfo(torch.int64).min
_BLOCK = 1 << 27  # keys sorted at once: bounds the int64 sort's temporaries at 1 GiB each


def _sorted_segments(x: torch.Tensor, seg: Optional[torch.Tensor], s_n: int, flip: int):
    """The rows of ``x`` grouped by segment: per segment its radix keys
    (xor ``flip``, so that int64's signed order is their unsigned order)
    sorted within each column, as an ``(m, n_s)`` tensor (one sorted row per
    column), sorted a block of columns at a time."""
    n, m = x.shape
    if seg is None:
        groups = [x]
    else:
        order = torch.sort(seg, stable=True).indices
        counts = torch.bincount(seg, minlength=s_n).tolist()
        xs = x[order]
        groups = list(torch.split(xs, counts))
    out = []
    for g in groups:
        cols = max(1, _BLOCK // max(g.shape[0], 1))
        parts = [torch.sort(radix_keys(g[:, c0 : c0 + cols])[0] ^ flip, dim=0).values.T for c0 in range(0, m, cols)]
        out.append(torch.cat(parts).contiguous() if parts else torch.zeros((m, 0), dtype=torch.int64, device=x.device))
    return out


def select_values(
    x: torch.Tensor, targets: torch.Tensor, seg: Optional[torch.Tensor] = None, comm=None
) -> torch.Tensor:
    """The values at ranks ``targets`` (int64, ``(T, S, m)``) of the columns
    of ``x`` (``(n, m)``, this rank's rows) within each segment; ``seg``
    (``(n,)``, values in ``[0, S)``) gives each row's segment (every row is
    segment 0 when omitted). Ranks count over the rows of every rank of
    ``comm``. The values come in ``x``'s dtype, ``+0.0`` for a zero and NaN
    past the last number; a target outside its segment's count gives an
    unspecified value."""
    t_n, s_n, m = targets.shape
    dev = x.device
    bits = 64 if x.element_size() == 8 else 32
    # 64-bit keys order as unsigned integers: with the sign bit flipped, int64's signed order is theirs
    flip = _I64_MIN if bits == 64 else 0
    targets = targets.to(device=dev, dtype=torch.int64)
    sorted_segs = _sorted_segments(x, None if seg is None else seg.to(torch.int64), s_n, flip)
    if comm is None or not comm.is_distributed():
        keys = torch.zeros((t_n, s_n, m), dtype=torch.int64, device=dev)
        for s, srt in enumerate(sorted_segs):
            if srt.shape[1]:
                at = targets[:, s, :].clamp(0, srt.shape[1] - 1).T  # (m, T)
                keys[:, s, :] = torch.gather(srt, 1, at).T ^ flip
        return from_radix_keys(keys, x.dtype)
    prefix = torch.zeros((t_n, s_n, m), dtype=torch.int64, device=dev)
    for b in range(bits - 1, -1, -1):
        cand = prefix | (_I64_MIN if b == 63 else 1 << b)
        below = torch.zeros_like(cand)
        for s, srt in enumerate(sorted_segs):
            if srt.shape[1]:
                below[:, s, :] = torch.searchsorted(srt, (cand[:, s, :] ^ flip).T.contiguous()).T
        below = comm.allreduce(below)
        prefix = torch.where(below <= targets, cand, prefix)
    return from_radix_keys(prefix, x.dtype)
