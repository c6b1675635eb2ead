"""Streaming groupby: per-key aggregation over chunks in bounded memory
(counterpart of ``heat_tpu/stream/groupby.py``).

The frame groupby (:mod:`heat_tpu_torch.frame`) moves rows so that each
rank owns its keys; a streaming groupby never sees all rows at once, so it
folds every chunk into a table of at most ``capacity`` (key, raw
associative statistics) rows: the sum, sum of squares, count, minimum and
maximum, all associative and commutative, as ``StreamingMoments``' state.
Mean and std are derived at :meth:`StreamingGroupBy.result` from those
pieces with the frame groupby's planning, so a chunked fold and an
in-memory ``Frame.groupby(...).agg(...)`` agree on the same data.

``heat_tpu`` folds each chunk into one replicated table inside a global
program. Here each rank folds its own rows of every chunk into a table of
its own, with no collective per chunk (a replicated chunk is divided into
the ranks' ceil-div chunks, so each row is folded once): a fold is a stable
sort of the table's rows and the chunk's by key and a reduction of each
run (:mod:`heat_tpu_torch.frame._shuffle`'s deterministic run
reductions). :meth:`StreamingGroupBy.result` combines the ranks' tables,
padded to ``capacity`` slots, with one
:func:`~heat_tpu_torch.core.communication.tree_merge` (log2 P rounds), so
every rank ends with the same table. :meth:`StreamingGroupBy.merge`
combines two estimators on this rank.

More than ``capacity`` distinct keys set the overflow flag, which is
judged at ``result()`` on the merged table: a rank's keys are a subset of
all keys, so it overflows exactly when the replicated table of
``heat_tpu`` would. Raise ``capacity``, or use the frame groupby when the
number of keys has no bound.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..core.communication import tree_merge
from ..core.dndarray import DNDarray
from ..frame._shuffle import _jnp_float_dtype, _max_key, _reduce_stats, _runs, _sort_by_key, _sortable

__all__ = ["StreamingGroupBy"]

_AGGS = ("sum", "mean", "min", "max", "count", "std")
# each raw statistic's combiner in a fold
_COMBINE = {"count": "sum", "sum": "sum", "fsum": "sum", "fsumsq": "sum", "min": "min", "max": "max"}


def _neutral(kind: str, dtype: torch.dtype):
    if kind in ("count", "sum", "fsum", "fsumsq"):
        return 0
    if dtype.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    if dtype == torch.bool:
        return kind == "min"
    info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min


def _fold(kinds, cap: int, keys_a, stats_a, keys_b, stats_b):
    """Table ``a`` then rows ``b`` (each a keys tensor and one tensor per
    statistic, rows of raw statistics), sorted by key and each run of equal
    keys reduced: (keys, stats, number of groups before the cut to
    ``cap``)."""
    sk, ss = _sort_by_key(torch.cat([keys_a, keys_b]), [torch.cat([a, b]) for a, b in zip(stats_a, stats_b)])
    starts, lengths = _runs(sk)
    g = int(lengths.shape[0])
    keep = slice(0, min(g, cap))
    keys = sk[starts + lengths - 1][keep]
    stats = tuple(s[keep] for s in _reduce_stats([_COMBINE[k] for k in kinds], ss, starts, lengths))
    return keys, stats, g


class StreamingGroupBy:
    """Single-pass per-key aggregation with a bounded number of groups.

    ``aggs`` names the aggregations (of sum, mean, min, max, count, std);
    ``capacity`` bounds the distinct keys the table holds.
    ``update(keys, values)`` folds one chunk (1-D key and value DNDarrays
    of one length; ``values`` may be left out when only ``count`` is
    asked); ``merge(other)`` combines two estimators; ``result()`` returns
    ``{"key": ..., agg: ...}`` as replicated DNDarrays sorted by key.
    """

    def __init__(self, aggs: Sequence[str] = ("sum",), capacity: int = 4096):
        aggs = (aggs,) if isinstance(aggs, str) else tuple(aggs)
        if not aggs:
            raise ValueError("need at least one aggregation")
        for a in aggs:
            if a not in _AGGS:
                raise ValueError(f"unknown agg {a!r}; choose from {_AGGS}")
        if capacity < 1:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.aggs = aggs
        self.capacity = int(capacity)
        kinds = ["count"]  # group sizes are always carried
        for a in aggs:
            for k in {"sum": ["sum"], "min": ["min"], "max": ["max"], "mean": ["fsum"],
                      "std": ["fsum", "fsumsq"], "count": []}[a]:
                if k not in kinds:
                    kinds.append(k)
        self._kinds = tuple(kinds)
        self._n = 0
        self._keys = None  # this rank's table: its distinct keys, sorted
        self._stats = None
        self._ov = False  # this rank's overflow flag
        self._vdtype = None
        self._device = None
        self._comm = None

    @property
    def n(self) -> int:
        """Rows folded in so far."""
        return self._n

    def _stat_dtype(self, kind: str) -> torch.dtype:
        if kind == "count":
            return torch.int32
        if kind in ("fsum", "fsumsq"):
            return _jnp_float_dtype(self._vdtype)
        return self._vdtype

    def _start(self, key_dtype, vdtype, device, comm):
        self._vdtype = vdtype
        self._device = device
        self._comm = comm
        dev = device.torch_device
        self._keys = torch.empty(0, dtype=key_dtype, device=dev)
        self._stats = tuple(torch.empty(0, dtype=self._stat_dtype(k), device=dev) for k in self._kinds)

    # ---------------------------------------------------------------- folds
    @staticmethod
    def _rows(keys: DNDarray, values: Optional[DNDarray]):
        """This rank's rows of the chunk: its rows of a split chunk (the two
        columns brought into one layout), its ceil-div chunk of a replicated
        one."""
        if keys.split == 0 and (values is None or values.split == 0):
            if values is not None and (keys.lcounts != values.lcounts):
                return keys.larray, values.larray
            return keys._raw, None if values is None else values._raw
        comm = keys.comm
        _, _, sl = comm.chunk(keys.gshape, 0)
        kb = keys.larray if keys.split == 0 else keys._raw[sl]
        vb = None if values is None else (values.larray if values.split == 0 else values._raw[sl])
        return kb, vb

    def update(self, keys: DNDarray, values: Optional[DNDarray] = None):
        """Fold one chunk. ``keys`` is a 1-D DNDarray; ``values`` a 1-D
        DNDarray of the same length (needed unless only counting)."""
        if not isinstance(keys, DNDarray):
            raise TypeError(f"keys must be a DNDarray, got {type(keys)}")
        if any(k != "count" for k in self._kinds) and values is None:
            raise ValueError(f"aggs {self.aggs} need a values column")
        if values is not None and (not isinstance(values, DNDarray) or values.gshape != keys.gshape):
            raise ValueError("values must be a DNDarray with the keys' shape")
        if keys.ndim != 1:
            raise ValueError(f"keys must be 1-D, got {keys.ndim}-D")
        kb, vb = self._rows(keys, values)
        if vb is None:
            vb = torch.zeros(kb.shape, dtype=torch.float32, device=kb.device)
        if self._keys is None:
            self._start(kb.dtype, vb.dtype, keys.device, keys.comm)
        rows = []
        for kind, st in zip(self._kinds, self._stats):
            if kind == "count":
                rows.append(torch.ones(kb.shape, dtype=st.dtype, device=kb.device))
            elif kind == "fsumsq":
                v = vb.to(st.dtype)
                rows.append(v * v)
            else:
                rows.append(vb.to(st.dtype))
        self._keys, self._stats, g = _fold(self._kinds, self.capacity, self._keys, self._stats, kb, rows)
        self._ov = self._ov or g > self.capacity
        self._n += int(keys.gshape[0])
        return self

    def merge(self, other: "StreamingGroupBy") -> "StreamingGroupBy":
        """Fold ``other``'s table into this one (on this rank)."""
        if (self.aggs, self.capacity) != (other.aggs, other.capacity):
            raise ValueError("cannot merge groupbys with different aggs/capacity")
        self._require_data()
        other._require_data()
        self._keys, self._stats, g = _fold(self._kinds, self.capacity, self._keys, self._stats, other._keys,
                                           other._stats)
        self._ov = self._ov or other._ov or g > self.capacity
        self._n += other._n
        return self

    # ------------------------------------------------------- across ranks
    def _padded(self, keys, stats, ov: bool):
        """A table in ``capacity`` slots (empty slots hold the largest key and
        each statistic's neutral value), with its group count and overflow
        flag: the state ``tree_merge`` moves."""
        cap, g = self.capacity, int(keys.shape[0])
        dev = keys.device
        full = torch.full((cap,), _max_key(keys.dtype), dtype=_sortable(keys).dtype, device=dev).to(keys.dtype)
        full[:g] = keys
        slots = []
        for kind, s in zip(self._kinds, stats):
            t = torch.full((cap,), _neutral(kind, s.dtype), dtype=s.dtype, device=dev)
            t[:g] = s
            slots.append(t)
        return full, torch.tensor([g, int(ov)], dtype=torch.int64, device=dev), tuple(slots)

    def _combine(self, a, b):
        """The ``tree_merge`` combine of two padded tables, ``a`` the lower
        rank's."""
        ga, oa = (int(v) for v in a[1].tolist())
        gb, ob = (int(v) for v in b[1].tolist())
        keys, stats, g = _fold(self._kinds, self.capacity, a[0][:ga], [s[:ga] for s in a[2]], b[0][:gb],
                               [s[:gb] for s in b[2]])
        return self._padded(keys, stats, bool(oa or ob or g > self.capacity))

    def _merged(self):
        """(keys, stats, overflow) of every rank's table merged, the same on
        every rank: one ``tree_merge`` above one rank."""
        comm = self._comm
        if comm.size == 1:
            return self._keys, self._stats, self._ov
        state = self._padded(self._keys, self._stats, self._ov)
        keys, meta, stats = tree_merge(state, self._combine, label="collective.groupby_merge", comm=comm)
        g, ov = (int(v) for v in meta.tolist())
        return keys[:g], tuple(s[:g] for s in stats), bool(ov)

    # -------------------------------------------------------------- results
    def _require_data(self):
        if self._n == 0:
            raise RuntimeError("no chunks folded in yet (call update first)")

    def result(self) -> Dict[str, DNDarray]:
        """``{"key", *aggs}`` as replicated DNDarrays sorted by key, every
        rank's table merged. Raises on every rank if the merged table
        overflowed its capacity. ``std`` takes ddof = 1, as
        ``Frame.groupby().std()`` (NaN for a group of one row)."""
        self._require_data()
        keys, stats, ov = self._merged()
        if ov:
            raise RuntimeError(
                f"StreamingGroupBy exceeded capacity={self.capacity} distinct "
                "keys; raise capacity or use heat_tpu.frame for unbounded keys"
            )
        slot = dict(zip(self._kinds, stats))
        cnt = slot["count"]
        cnt1 = torch.clamp(cnt, min=1)
        fin = {"key": keys}
        for a in self.aggs:
            if a in ("sum", "count", "min", "max"):
                fin[a] = slot[a]
            elif a == "mean":
                fin[a] = slot["fsum"] / cnt1
            else:
                mean = slot["fsum"] / cnt1
                # heat_tpu divides the int32 counts in float32
                var = (slot["fsumsq"] / cnt1 - mean * mean) * (cnt.to(torch.float32) / (cnt - 1).to(torch.float32))
                fin[a] = torch.sqrt(torch.clamp(var, min=0.0) + 0.0)  # -0.0 becomes 0.0, as jnp.clip gives it
        return {name: DNDarray(t, split=None, device=self._device, comm=self._comm) for name, t in fin.items()}
