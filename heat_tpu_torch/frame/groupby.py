"""``Frame.groupby(...)``: aggregation planning over the shuffle
(counterpart of ``heat_tpu/frame/groupby.py``).

The planner turns the asked aggregations (sum, mean, min, max, count,
std) into the smallest set of *raw* associative statistics the shuffle
must carry: a mean needs a float sum and the group count, a std also a
float sum of squares, and a statistic two aggregations share is carried
once. One shuffle carries them all (one bucket move per statistic plus
one for the keys); the derived aggregations are then plain DNDarray
arithmetic on the co-aligned results.

Types (``heat_tpu``'s): a sum keeps the value type (bool sums as int32,
integer sums wrap); mean and std come from sums in
``numpy.promote_types(value type, float32)``; count is int32; min and max
keep the value type. ``std`` is ``sqrt(max(0, (S2 / n - mean^2) * n / (n
- ddof)))``.

``quantile`` is the one aggregation that is not associative in bounded
memory, so it does not ride the shuffle: each rank groups its own rows,
folds each group's values into one KLL sketch per (key, column) (one
grouped fold per column, every group at once, over a (G, rows, 1) tensor
built with one scatter), and ONE ``tree_merge`` combines the per-key
sketches across the ranks. The answer lies within the KLL rank-error
bound, ``(3 + ceil(log2 P)) / (2k)`` of each group's row count.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.dndarray import DNDarray
from ._shuffle import _sortable, groupby_reduce

__all__ = ["FrameGroupBy", "AGGS"]

AGGS = ("sum", "mean", "min", "max", "count", "std")

AggSpec = Union[str, Sequence[str], Mapping[str, Union[str, Sequence[str]]]]

# numpy stand-ins of torch's types for numpy's promotion rules (bfloat16
# promotes with float32 as float16 does)
_NP_OF = {
    torch.bool: np.bool_, torch.uint8: np.uint8, torch.int8: np.int8, torch.int16: np.int16,
    torch.int32: np.int32, torch.int64: np.int64, torch.float16: np.float16, torch.bfloat16: np.float16,
    torch.float32: np.float32, torch.float64: np.float64,
}
_TORCH_OF = {np.dtype(v): k for k, v in _NP_OF.items() if k is not torch.bfloat16}


def _sum_dtype(vdt: torch.dtype) -> torch.dtype:
    return torch.int32 if vdt == torch.bool else vdt


def _float_dtype(vdt: torch.dtype) -> torch.dtype:
    return _TORCH_OF[np.promote_types(_NP_OF[vdt], np.float32)]


def _grouped_kll_combine(a, b):
    """Each column's grouped KLL combine: the ``tree_merge`` operand of
    :meth:`FrameGroupBy.quantile`."""
    from ..stream.sketch.kll import grouped_merge_states

    return tuple(grouped_merge_states(x, y) for x, y in zip(a, b))


class FrameGroupBy:
    """A deferred groupby: (frame, key, partition mode) until an
    aggregation names the statistics to carry."""

    def __init__(self, frame, key: str, mode: str = "range"):
        self._frame = frame
        self._key = key
        self._mode = mode

    def agg(self, spec: AggSpec, ddof: int = 1):
        """Aggregate the value columns per distinct key.

        ``spec`` is one aggregation name (for every non-key column), a list
        of them, or a ``{column: agg | [aggs]}`` mapping. Returns a
        :class:`Frame` whose first column is the key (in global order in
        range mode); a value column keeps its name under one aggregation and
        gains ``_<agg>`` under several; ``count`` needs no value column and
        is named ``"count"`` when asked by name.
        """
        frame, key = self._frame, self._key
        value_cols = [n for n in frame.columns if n != key]
        requests: List[Tuple[str, str]] = []
        if isinstance(spec, str):
            spec = [spec]
        if isinstance(spec, Mapping):
            for col, aggs in spec.items():
                if col not in frame.columns or col == key:
                    raise KeyError(f"cannot aggregate column {col!r}")
                for a in [aggs] if isinstance(aggs, str) else list(aggs):
                    requests.append((col, a))
        else:
            for a in list(spec):
                if a == "count":
                    requests.append((key, "count"))
                else:
                    requests.extend((c, a) for c in value_cols)
        if not requests:
            raise ValueError("empty aggregation spec")
        for col, a in requests:
            if a not in AGGS:
                raise ValueError(f"unknown agg {a!r}; choose from {AGGS}")
        mult: Dict[str, int] = {}
        for col, _ in requests:
            mult[col] = mult.get(col, 0) + 1

        # ---- the raw associative statistics, each once
        used_cols = sorted({c for c, a in requests if a != "count"}, key=frame.columns.index)
        ci = {c: i for i, c in enumerate(used_cols)}
        vdts = {c: frame[c]._raw.dtype for c in used_cols}
        raw: Dict[Tuple[str, int, torch.dtype], int] = {}

        def need(kind: str, col: str):
            if kind == "count":
                k = ("count", 0, torch.int32)
            elif kind in ("min", "max"):
                k = (kind, ci[col], vdts[col])
            elif kind == "sum":
                k = ("sum", ci[col], _sum_dtype(vdts[col]))
            elif kind == "fsum":
                k = ("sum", ci[col], _float_dtype(vdts[col]))
            else:  # fsumsq
                k = ("sumsq", ci[col], _float_dtype(vdts[col]))
            raw.setdefault(k, len(raw))
            return k

        plan = []
        for col, a in requests:
            if a == "count":
                slots = [need("count", col)]
            elif a in ("sum", "min", "max"):
                slots = [need(a, col)]
            elif a == "mean":
                slots = [need("fsum", col), need("count", col)]
            else:  # std
                slots = [need("fsum", col), need("fsumsq", col), need("count", col)]
            name = "count" if a == "count" and col == key else (f"{col}_{a}" if mult[col] > 1 else col)
            plan.append((name, a, slots))

        # ---- one shuffle carries every raw statistic
        stats = tuple(sorted(raw, key=raw.get))
        mkeys, reduced, _ = groupby_reduce(frame[key], [frame[c]._raw for c in used_cols], stats, mode=self._mode)
        slot = dict(zip(stats, reduced))

        # ---- the asked aggregations from the raw statistics
        out: Dict[str, DNDarray] = {key: mkeys}
        for name, a, slots in plan:
            if name in out:
                raise ValueError(f"duplicate output column {name!r}")
            if a in ("sum", "min", "max", "count"):
                out[name] = slot[slots[0]]
            elif a == "mean":
                out[name] = slot[slots[0]] / slot[slots[1]]
            else:  # std
                fsum, fsumsq, cnt = (slot[s] for s in slots)
                mean = fsum / cnt
                var = (fsumsq / cnt - mean * mean) * (cnt / (cnt - ddof))
                out[name] = (var.clip(0.0, None) + 0.0).sqrt()  # + 0.0: -0.0 becomes 0.0, as jnp.clip gives it
        from .frame import Frame

        return Frame._wrap(out)

    # ------------------------------------------------- approximate quantile
    def quantile(self, q: float = 0.5, k: int = 256, levels: int = 8):
        """The approximate per-group quantile of every value column, without
        a shuffle (see the module's docstring). ``q`` is a fraction in [0, 1];
        ``k``/``levels`` size the per-group KLL sketches. Returns a
        :class:`Frame` keyed by the sorted distinct keys, one column per value
        column, the same on every rank."""
        q = float(q)
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be a fraction in [0, 1], got {q}")
        frame, key = self._frame, self._key
        value_cols = [n for n in frame.columns if n != key]
        if not value_cols:
            raise ValueError("quantile needs at least one value column")
        from ..core import factories
        from ..core.communication import ragged_process_allgather, tree_merge
        from ..stream.sketch import kll

        comm = frame.comm
        keys_local = frame[key]._raw
        dev = keys_local.device
        # ---- the union of every rank's distinct keys (one ragged allgather)
        uniq_local = torch.unique(keys_local).cpu().numpy()
        union = np.unique(np.concatenate(ragged_process_allgather(uniq_local, comm=comm)))
        G = union.size
        # ---- this rank's rows grouped by key: one scatter into (G, rows, 1)
        order = torch.sort(_sortable(keys_local), stable=True).indices
        sk = keys_local[order]
        union_t = _sortable(torch.from_numpy(union).to(dev))
        gidx = torch.searchsorted(union_t, _sortable(sk).contiguous(), right=False)
        if sk.dtype.is_floating_point:  # the union holds one NaN, after every number (np.unique)
            gidx = torch.where(torch.isnan(sk), torch.full_like(gidx, G - 1), gidx)
        counts = torch.bincount(gidx, minlength=G)
        starts = torch.cumsum(counts, 0) - counts
        pos = torch.arange(sk.shape[0], device=dev) - starts[gidx]
        lmax = max(int(counts.max()) if G else 0, 1)
        counts32 = counts.to(torch.int32)
        state = []
        for c in value_cols:
            rows = frame[c]._raw[order].to(torch.float32)
            padded = torch.zeros((G, lmax, 1), dtype=torch.float32, device=dev)
            padded[gidx, pos, 0] = rows
            v0 = torch.full((G, levels, k), float("inf"), dtype=torch.float32, device=dev)
            vals, wts = kll._grouped_fold(padded, counts32, v0, torch.zeros_like(v0))
            state.append((counts32, torch.ones(G, dtype=torch.int32, device=dev), vals, wts))
        merged = tree_merge(tuple(state), _grouped_kll_combine, label="collective.groupby_quantile", comm=comm)

        # ---- every group's quantile, the same on every rank
        qs = torch.tensor([q], dtype=torch.float32, device=dev)
        out = {key: union}
        # graftflow: F003 - the value columns are the frame's, the same on every rank
        for c, (_, _, vals, wts) in zip(value_cols, merged):
            out[c] = kll._grouped_quantile(vals, wts, qs)[:, 0].cpu().numpy()
        from .frame import Frame

        return Frame({name: factories.array(col, split=0, device=frame[key].device, comm=comm)
                      for name, col in out.items()})

    # -------------------------------------------------------- conveniences
    def sum(self):
        return self.agg("sum")

    def mean(self):
        return self.agg("mean")

    def min(self):
        return self.agg("min")

    def max(self):
        return self.agg("max")

    def std(self, ddof: int = 1):
        return self.agg("std", ddof=ddof)

    def count(self):
        return self.agg("count")
