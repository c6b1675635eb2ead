"""Count-Min sketch with a top-k candidate list: heavy hitters
(counterpart of ``heat_tpu/stream/sketch/countmin.py``).

The state is a ``(depth, width)`` count table and ``K`` candidate values
(``+inf`` where empty). Each fold adds every element of the chunk to one
counter per hash row (the HLL sketch's murmur3 finalizer with a seed per
row), then re-selects the candidates: the old ones and the chunk's
values, sorted and deduplicated, scored by their Count-Min estimate (the
minimum over the rows), and the ``K`` best kept — ties to the smaller
value, as ``lax.top_k`` keeps the lower index. The counters are int64, so
they stay exact past 2^24 (``heat_tpu`` counts in float32); estimates are
returned as float32, as ``heat_tpu`` returns them.

Estimates never undercount and overcount by more than ``e N / width``
with probability at most ``exp(-depth)`` (:attr:`CountMinTopK.eps` is
``e / width``). Across ranks a split chunk's counter increments are
summed by one ``allreduce``, and each rank's re-selected candidates are
gathered (one ``allgather`` of ``P K`` values) and re-selected once more
against the summed table, so every rank keeps the same list.
"""
from __future__ import annotations

import math

import torch

from ...core.dndarray import DNDarray
from ..estimators import _StreamingBase
from .hll import _hash_u32

__all__ = ["CountMinTopK", "merge_states"]

# one independent hash row per depth; odd constants from splitmix64 steps
_SEEDS = (0x9E3779B9, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1, 0xD3A2646C, 0xFD7046C5, 0xB55A4F09)


def _row_index(v: torch.Tensor, j: int, width: int) -> torch.Tensor:
    return _hash_u32(v, seed=_SEEDS[j % len(_SEEDS)]) % width


def _lookup(table: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The conservative estimate: the minimum over the hash rows."""
    depth, width = table.shape
    est = None
    for j in range(depth):
        e = table[j, _row_index(v, j, width)]
        est = e if est is None else torch.minimum(est, e)
    return est


def _top(score: torch.Tensor, K: int):
    """``lax.top_k``: the K largest scores, ties to the lower index."""
    order = torch.sort(score, descending=True, stable=True).indices[:K]
    return score[order], order


def _reselect(table: torch.Tensor, pool: torch.Tensor, K: int) -> torch.Tensor:
    """The ``K`` best-scoring distinct finite values of ``pool`` (``+inf`` pad)."""
    # XLA compares subnormals as zero: they sort and deduplicate with the zeros (the first one kept)
    key = torch.where(pool.abs() < torch.finfo(pool.dtype).tiny, torch.zeros_like(pool), pool)
    key, order = torch.sort(key, stable=True)
    s = pool[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=s.device), key[1:] != key[:-1]])
    score = torch.where(first & torch.isfinite(s), _lookup(table, s).to(torch.float64), float("-inf"))
    top, ti = _top(score, K)
    return torch.where(torch.isfinite(top), s[ti], torch.full_like(s[ti], float("inf")))


def merge_states(a, b):
    """The associative combine of two CM states ``(n, table, cands)``:
    tables add, the candidates compete again against the sum."""
    na, ta, ca = a
    nb, tb, cb = b
    table = ta + tb
    return na + nb, table, _reselect(table, torch.cat([ca, cb]), ca.shape[0])


class CountMinTopK(_StreamingBase):
    """Streaming heavy hitters over the elements of chunks.

    Parameters
    ----------
    width : int
        Counters per hash row (default 2048): the overcount bound
        :attr:`eps` is ``e / width``.
    depth : int
        Independent hash rows, at most 8 (default 4): failure probability
        ``exp(-depth)``.
    k : int
        Candidates kept for :meth:`topk` (default 64).
    """

    _COMBINE = staticmethod(merge_states)

    def __init__(self, width: int = 2048, depth: int = 4, k: int = 64):
        super().__init__()
        if width < 16:
            raise ValueError(f"width must be >= 16, got {width}")
        if not 1 <= depth <= len(_SEEDS):
            raise ValueError(f"depth must be in [1, {len(_SEEDS)}], got {depth}")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.width = int(width)
        self.depth = int(depth)
        self.k = int(k)
        self._cols = None
        self._table = None
        self._cands = None

    def update(self, chunk: DNDarray) -> "CountMinTopK":
        xa, across, comm = self._capture(chunk)
        if self._table is None:
            self._cols = xa.shape[1]
            self._table = torch.zeros((self.depth, self.width), dtype=torch.int64, device=xa.device)
            self._cands = torch.full((self.k,), float("inf"), dtype=xa.dtype, device=xa.device)
        v = xa.reshape(-1)
        add = torch.zeros_like(self._table)
        for j in range(self.depth):
            add[j] = torch.bincount(_row_index(v, j, self.width), minlength=self.width)
        if across:
            # graftflow: F008 - runs on the consumer's thread; the prefetch thread moves host chunks only
            add = comm.allreduce(add)
        self._table = self._table + add
        cands = _reselect(self._table, torch.cat([self._cands, v]), self.k)
        if across:
            # graftflow: F008 - runs on the consumer's thread; the prefetch thread moves host chunks only
            cands = _reselect(self._table, comm.allgather(cands, 0, [self.k] * comm.size), self.k)
        self._cands = cands
        self._n += int(chunk.gshape[0])
        return self

    def merge(self, other: "CountMinTopK") -> "CountMinTopK":
        """Fold ``other``'s table and candidates into this one."""
        if (self.width, self.depth, self.k) != (other.width, other.depth, other.k):
            raise ValueError("cannot merge Count-Min sketches with different geometry")
        self._require_data()
        other._require_data()
        self._set_state(merge_states(self._state(), other._state()))
        return self

    def _state(self):
        return torch.tensor(self._n, dtype=torch.int64, device=self._table.device), self._table, self._cands

    def _set_state(self, state):
        n, self._table, self._cands = state
        self._n = int(n)

    @property
    def items(self) -> int:
        """Elements folded in (rows times columns)."""
        return self._n * (self._cols or 1)

    @property
    def eps(self) -> float:
        """The fractional overcount bound: an estimate exceeds the true
        count by more than ``eps * items`` with probability at most
        ``exp(-depth)``."""
        return math.e / self.width

    def estimate(self, value) -> float:
        """The conservative (never low) count estimate of one value."""
        self._require_data()
        return float(_lookup(self._table, torch.as_tensor([value], dtype=self._cands.dtype,
                                                          device=self._cands.device))[0])

    def topk(self, k=None):
        """The top-``k`` candidates and their estimated counts (float32),
        by descending count: a ``(values, counts)`` DNDarray pair, padded
        with ``+inf``/0 past the distinct values seen."""
        self._require_data()
        k = self.k if k is None else int(k)
        if not 1 <= k <= self.k:
            raise ValueError(f"k must be in [1, {self.k}], got {k}")
        finite = torch.isfinite(self._cands)
        counts = torch.where(finite, _lookup(self._table, self._cands).to(torch.float64), float("-inf"))
        top, ti = _top(counts, k)
        vals = torch.where(torch.isfinite(top), self._cands[ti], torch.full_like(self._cands[ti], float("inf")))
        return self._wrap(vals), self._wrap(torch.clamp(top, min=0.0).to(torch.float32))
