""":class:`Frame`: named split-0 columns with relational verbs
(counterpart of ``heat_tpu/frame/frame.py``).

Not a dataframe library: a Frame is a dict of equal-length 1-D columns,
all split along axis 0 in ONE layout (every rank holds the same number of
rows of each column), with the verbs the shuffle makes cheap:
``groupby(...).agg(...)``, ``value_counts``, ``join`` and ``filter``. Each
verb is a local reduction per rank, one bounded exchange per operand and a
local merge (:mod:`._shuffle`), or no exchange at all for ``filter``. The
results are ragged but co-aligned; columns of differing layouts are
rebalanced to the ceil-div map at construction, so one counts vector holds
for the whole frame.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np

from ..core import factories, types
from ..core.dndarray import DNDarray
from ._shuffle import compact_rows, hash_join, shard_counts

__all__ = ["Frame"]


class Frame:
    """Named, equal-length split-0 columns in one layout.

    Takes DNDarrays (1-D, split 0) or anything ``heat_tpu_torch.array``
    takes (converted with ``split=0``). Columns of differing layouts are
    rebalanced to the ceil-div map.
    """

    def __init__(self, columns: Mapping[str, object]):
        if not columns:
            raise ValueError("Frame needs at least one column")
        cols: Dict[str, DNDarray] = {}
        n = None
        for name, col in columns.items():
            if not isinstance(col, DNDarray):
                col = factories.array(col, split=0)
            if col.ndim != 1:
                raise ValueError(f"column {name!r} must be 1-D, got {col.ndim}-D")
            if col.split != 0:
                raise ValueError(f"column {name!r} must be split along axis 0 (got split={col.split})")
            if n is None:
                n = col.gshape[0]
            elif col.gshape[0] != n:
                raise ValueError(f"column {name!r} has {col.gshape[0]} rows, expected {n}")
            cols[str(name)] = col
        if len({shard_counts(c) for c in cols.values()}) > 1:
            for c in cols.values():
                c.balance_()
        self._cols = cols

    @classmethod
    def _wrap(cls, cols: Dict[str, DNDarray]) -> "Frame":
        """Adopt columns already in one layout, unchecked."""
        out = cls.__new__(cls)
        out._cols = dict(cols)
        return out

    # ------------------------------------------------------------- container
    @property
    def columns(self) -> Tuple[str, ...]:
        return tuple(self._cols)

    @property
    def n_rows(self) -> int:
        return next(iter(self._cols.values())).gshape[0]

    @property
    def comm(self):
        return next(iter(self._cols.values())).comm

    def _counts(self) -> Tuple[int, ...]:
        return shard_counts(next(iter(self._cols.values())))

    def __getitem__(self, name: str) -> DNDarray:
        return self._cols[name]

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def __len__(self) -> int:
        return self.n_rows

    def __repr__(self) -> str:
        return f"Frame(columns={list(self._cols)}, n_rows={self.n_rows})"

    def to_dict(self) -> Dict[str, np.ndarray]:
        """Every column as a host numpy array of its global rows (gathered)."""
        return {name: c.numpy() for name, c in self._cols.items()}

    # ----------------------------------------------------------------- verbs
    def groupby(self, key: str, mode: str = "range"):
        """Group the rows by a key column. ``mode="range"`` (default) gives
        the groups in global key order by elected splitters; ``"hash"`` only
        brings equal keys together."""
        from .groupby import FrameGroupBy

        if key not in self._cols:
            raise KeyError(f"no column {key!r} in {list(self._cols)}")
        return FrameGroupBy(self, key, mode)

    def value_counts(self, key: str, mode: str = "range") -> "Frame":
        """The rows of each distinct key: ``groupby(key).count()``, its count
        column named ``"count"``."""
        return self.groupby(key, mode=mode).count()

    def filter(self, mask) -> "Frame":
        """The rows where ``mask`` is True: each rank keeps its own rows, in
        order, into a ragged layout; no exchange. ``mask`` is a boolean
        split-0 DNDarray (or anything ``array`` takes)."""
        if not isinstance(mask, DNDarray):
            mask = factories.array(mask, split=0)
        if mask.ndim != 1 or mask.gshape[0] != self.n_rows:
            raise ValueError(f"mask must be 1-D with {self.n_rows} rows, got shape {mask.gshape}")
        if mask.dtype is not types.bool:
            raise TypeError(f"mask must be boolean, got {mask.dtype}")
        if mask.split != 0:
            mask = mask.resplit(0)
        if shard_counts(mask) != self._counts():
            mask.balance_()
            for c in self._cols.values():
                c.balance_()
        names = list(self._cols)
        bufs, gvec = compact_rows(mask._raw, [self._cols[n]._raw for n in names], self.comm)
        kept = sum(gvec)
        dev = next(iter(self._cols.values())).device
        return Frame._wrap({
            n: DNDarray._from_ragged(b, (kept,), self._cols[n].dtype, 0, gvec, device=dev, comm=self.comm)
            for n, b in zip(names, bufs)
        })

    def join(self, other: "Frame", on: str, how: str = "inner", rsuffix: str = "_r", mode: str = "range") -> "Frame":
        """Join on a key column both frames have; the right keys must be
        unique (m:1: a repeated right key raises). Both sides are partitioned
        by one shared splitter election, each moves one bounded exchange per
        column, and each rank joins its rows. ``how="left"`` keeps every left
        row and gives NaN where no right row matches (the right columns
        become float)."""
        if on not in self._cols or on not in other._cols:
            raise KeyError(f"join key {on!r} must exist in both frames")
        lk, rk = self._cols[on], other._cols[on]
        if lk.dtype is not rk.dtype:
            raise TypeError(f"join key dtypes differ: {lk.dtype} vs {rk.dtype}")
        l_names = [n for n in self._cols if n != on]
        r_names = [n for n in other._cols if n != on]
        out_names = [on] + l_names
        for n in r_names:
            name = n if n not in self._cols else f"{n}{rsuffix}"
            if name in out_names:
                raise ValueError(f"column name collision on {name!r} after rsuffix")
            out_names.append(name)
        bufs, gvec, dup = hash_join(lk, [self._cols[n]._raw for n in l_names], rk,
                                    [other._cols[n]._raw for n in r_names], how=how, mode=mode)
        if dup:
            raise ValueError("join requires unique keys on the right side (m:1); aggregate the right frame first")
        n_out = sum(gvec)
        return Frame._wrap({
            name: DNDarray._from_ragged(b, (n_out,), None, 0, gvec, device=lk.device,
                                    comm=self.comm)
            for name, b in zip(out_names, bufs)
        })
