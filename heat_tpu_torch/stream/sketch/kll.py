"""KLL-style mergeable quantile sketch: single-pass streaming percentiles
(counterpart of ``heat_tpu/stream/sketch/kll.py``).

The state is a fixed ``(levels, k)`` pair of value and weight planes
(``+inf`` and 0 where empty), as ``heat_tpu`` keeps it. Each fold sorts the
chunk once, summarizes it to ``k`` equi-weight items (the item covering
each target rank ``(i + 0.5) W / k``: ``+-W/(2k)`` of rank), and carries
that run up the levels: per level the run merges in; if the merged level
holds more than ``k`` items it empties and its compressed run carries on,
else the level keeps it. A carry past the top level compresses into it.
The cascade follows a binary counter over folds, so an item takes part in
at most ``log2(folds)`` compactions, and :attr:`KLLSketch.eps` is the
conservative fractional-rank bound

    eps = (2 + extra + min(levels, bit_length(folds)) + spills) / (2k)

Across ranks a split chunk is summarized on each rank to ``k`` items of
its local weight, the ranks' summaries are gathered (one ``allgather`` of
``P * k`` items) and summarized once more to ``k`` items before the
cascade, so every rank folds the same run; that second summary is the
``extra`` term (1 once such a fold has happened, else 0).

:func:`merge_states` is the associative combine behind :meth:`merge` and
:meth:`merge_processes`; :func:`grouped_merge_states` is the same over a
leading axis of one sketch per key (``Frame.groupby(...).quantile``).
"""
from __future__ import annotations

import torch

from ...core.dndarray import DNDarray
from ..estimators import _StreamingBase

__all__ = ["KLLSketch", "merge_states"]


def _empty(k: int, dtype, device):
    return torch.full((k,), float("inf"), dtype=dtype, device=device), torch.zeros(k, dtype=dtype, device=device)


def _merge_runs(v1, w1, v2, w2):
    """Two sorted weighted runs (``+inf`` padded) merged into one."""
    v = torch.cat([v1, v2])
    w = torch.cat([w1, w2])
    order = torch.sort(v, stable=True).indices
    return v[order], w[order]


def _compress(v, w, k: int):
    """A sorted weighted run recompressed to ``k`` items of equal weight:
    the item covering each target rank ``(i + 0.5) W / k``."""
    W = w.sum()
    cum = torch.cumsum(w, dim=0)
    t = (torch.arange(k, dtype=v.dtype, device=v.device) + 0.5) * (W / k)
    idx = torch.clamp(torch.searchsorted(cum, t, right=False), 0, v.shape[0] - 1)
    empty = W <= 0
    return (torch.where(empty, torch.full_like(t, float("inf")), v[idx]),
            torch.where(empty, torch.zeros_like(t), (W / k).expand(k)))


def _level(v, w, k: int):
    """One level after a merge: ``(kept values, kept weights, carry)``:
    the level keeps a run of at most ``k`` items, else empties and its
    compressed run carries on."""
    if int((w > 0).sum()) > k:
        ev, ew = _empty(k, v.dtype, v.device)
        return ev, ew, _compress(v, w, k)
    return v[:k], w[:k], None


def _cascade(vals, wts, cv, cw):
    """The run ``(cv, cw)`` carried up the level stack."""
    H, k = vals.shape
    out_v, out_w = [], []
    carry = (cv, cw)
    for level in range(H):
        if carry is None:
            out_v.append(vals[level])
            out_w.append(wts[level])
            continue
        mv, mw = _merge_runs(vals[level], wts[level], *carry)
        lv, lw, carry = _level(mv, mw, k)
        out_v.append(lv)
        out_w.append(lw)
    return _spill(out_v, out_w, carry, k)


def _spill(out_v, out_w, carry, k: int):
    """The level stack with a carry past the top level force-compacted into it."""
    if carry is not None:
        mv, mw = _merge_runs(out_v[-1], out_w[-1], *carry)
        if int((mw > 0).sum()) > k:
            out_v[-1], out_w[-1] = _compress(mv, mw, k)
        else:
            out_v[-1], out_w[-1] = mv[:k], mw[:k]
    return torch.stack(out_v), torch.stack(out_w)


def _summary(x: torch.Tensor, k: int):
    """The ``k``-item equi-weight summary of a chunk's values."""
    xs = torch.sort(x).values
    return _compress(xs, torch.ones_like(xs), k)


def merge_states(a, b):
    """The associative combine of two KLL states ``(n, folds, vals,
    wts)``, ``a`` the lower rank's: each of ``b``'s levels enters ``a``'s
    stack as a carry at its own level."""
    na, fa, va, wa = a
    nb, fb, vb, wb = b
    H, k = va.shape
    out_v, out_w = [], []
    carry = None
    for level in range(H):
        iv, iw = (vb[level], wb[level]) if carry is None else _merge_runs(vb[level], wb[level], *carry)
        mv, mw = _merge_runs(va[level], wa[level], iv, iw)
        lv, lw, carry = _level(mv, mw, k)
        out_v.append(lv)
        out_w.append(lw)
    return (na + nb, fa + fb) + _spill(out_v, out_w, carry, k)


def _quantile(vals, wts, qs):
    """Weighted midpoint-interpolated quantiles at fractions ``qs``."""
    v = vals.reshape(-1)
    w = wts.reshape(-1)
    order = torch.sort(v, stable=True).indices
    v, w = v[order], w[order]
    has = w > 0
    vmax = torch.where(has, v, float("-inf")).max()
    vmin = torch.where(has, v, float("inf")).min()
    v = torch.clamp(torch.where(has, v, vmax), vmin, vmax)
    W = w.sum()
    cmid = torch.cumsum(w, dim=0) - 0.5 * w
    t = qs.to(v.dtype) * W
    i = torch.clamp(torch.searchsorted(cmid, t, right=False), 1, v.shape[0] - 1)
    lo, hi = cmid[i - 1], cmid[i]
    g = torch.clamp((t - lo) / torch.clamp(hi - lo, min=torch.finfo(v.dtype).tiny), 0.0, 1.0)
    return torch.where(t <= cmid[0], v[0], v[i - 1] + g * (v[i] - v[i - 1]))


# ------------------------------------------------ grouped sketches (one per key)
# ``Frame.groupby(...).quantile`` keeps one sketch per distinct key: the same
# state on a leading group axis, (G, levels, k). Each group takes its own
# branch of every compaction, so the cascade computes both outcomes for all
# groups and selects per group with a mask, as ``heat_tpu``'s vmapped fold.
def _g_merge_runs(v1, w1, v2, w2):
    """:func:`_merge_runs` of (G, ...) runs, group by group."""
    v = torch.cat([v1, v2], dim=-1)
    w = torch.cat([w1, w2], dim=-1)
    order = torch.sort(v, dim=-1, stable=True).indices
    return torch.gather(v, -1, order), torch.gather(w, -1, order)


def _g_compress(v, w, k: int):
    """:func:`_compress` of (G, L) runs to (G, k)."""
    W = w.sum(dim=-1)
    cum = torch.cumsum(w, dim=-1)
    t = (torch.arange(k, dtype=v.dtype, device=v.device) + 0.5) * (W / k)[:, None]
    idx = torch.clamp(torch.searchsorted(cum, t.contiguous(), right=False), 0, v.shape[-1] - 1)
    empty = (W <= 0)[:, None]
    return (torch.where(empty, torch.full_like(t, float("inf")), torch.gather(v, -1, idx)),
            torch.where(empty, torch.zeros_like(t), (W / k)[:, None].expand(-1, k)))


def _g_level(mv, mw, k: int):
    """One level after a merge, per group: (kept values, kept weights,
    carried values, carried weights); a group whose merged run holds more
    than ``k`` items empties the level and carries its compressed run."""
    over = ((mw > 0).sum(dim=-1) > k)[:, None]
    cv, cw = _g_compress(mv, mw, k)
    inf, zero = torch.full_like(cv, float("inf")), torch.zeros_like(cw)
    return (torch.where(over, inf, mv[:, :k]), torch.where(over, zero, mw[:, :k]),
            torch.where(over, cv, inf), torch.where(over, cw, zero))


def _g_top(out_v, out_w, cv, cw, k: int):
    """The stacks (G, levels, k) with the carry past the top level
    force-compacted into it."""
    mv, mw = _g_merge_runs(out_v[-1], out_w[-1], cv, cw)
    over = ((mw > 0).sum(dim=-1) > k)[:, None]
    comp_v, comp_w = _g_compress(mv, mw, k)
    out_v[-1] = torch.where(over, comp_v, mv[:, :k])
    out_w[-1] = torch.where(over, comp_w, mw[:, :k])
    return torch.stack(out_v, dim=1), torch.stack(out_w, dim=1)


def _grouped_fold(xa, n_valid, vals, wts):
    """One fold of every group's rows: ``xa`` (G, rows, 1) with group g's
    first ``n_valid[g]`` rows valid, into the (G, levels, k) stacks."""
    G, H, k = vals.shape
    rows = xa.reshape(G, -1)
    valid = torch.arange(rows.shape[1], device=rows.device)[None, :] < n_valid.to(rows.device)[:, None]
    xs = torch.sort(torch.where(valid, rows, float("inf")), dim=-1).values
    ws = valid.to(rows.dtype)  # the valid rows sort first: the weights need no permutation
    cv, cw = _g_compress(xs, ws, k)
    out_v, out_w = [], []
    for level in range(H):
        lv, lw, cv, cw = _g_level(*_g_merge_runs(vals[:, level], wts[:, level], cv, cw), k)
        out_v.append(lv)
        out_w.append(lw)
    return _g_top(out_v, out_w, cv, cw, k)


def grouped_merge_states(a, b):
    """:func:`merge_states` over a leading group axis: states ``(n (G,),
    folds (G,), vals (G, levels, k), wts (G, levels, k))``, ``a`` the lower
    rank's; the combine of ``Frame.groupby(...).quantile``'s
    ``tree_merge``."""
    na, fa, va, wa = a
    nb, fb, vb, wb = b
    G, H, k = va.shape
    cv, cw = (t.expand(G, k) for t in _empty(k, va.dtype, va.device))
    out_v, out_w = [], []
    for level in range(H):
        iv, iw = _g_merge_runs(vb[:, level], wb[:, level], cv, cw)
        lv, lw, cv, cw = _g_level(*_g_merge_runs(va[:, level], wa[:, level], iv, iw), k)
        out_v.append(lv)
        out_w.append(lw)
    return (na + nb, fa + fb) + _g_top(out_v, out_w, cv, cw, k)


def _grouped_quantile(vals, wts, qs):
    """:func:`_quantile` of every group's stacks: (G, len(qs))."""
    G = vals.shape[0]
    v = vals.reshape(G, -1)
    w = wts.reshape(G, -1)
    order = torch.sort(v, dim=-1, stable=True).indices
    v, w = torch.gather(v, -1, order), torch.gather(w, -1, order)
    has = w > 0
    vmax = torch.where(has, v, float("-inf")).max(dim=-1, keepdim=True).values
    vmin = torch.where(has, v, float("inf")).min(dim=-1, keepdim=True).values
    v = torch.minimum(torch.maximum(torch.where(has, v, vmax), vmin), vmax)
    W = w.sum(dim=-1, keepdim=True)
    cmid = torch.cumsum(w, dim=-1) - 0.5 * w
    t = (qs.to(v.dtype)[None, :] * W).contiguous()
    i = torch.clamp(torch.searchsorted(cmid, t, right=False), 1, v.shape[-1] - 1)
    lo, hi = torch.gather(cmid, -1, i - 1), torch.gather(cmid, -1, i)
    g = torch.clamp((t - lo) / torch.clamp(hi - lo, min=torch.finfo(v.dtype).tiny), 0.0, 1.0)
    vl, vh = torch.gather(v, -1, i - 1), torch.gather(v, -1, i)
    return torch.where(t <= cmid[:, :1], v[:, :1], vl + g * (vh - vl))


class KLLSketch(_StreamingBase):
    """Streaming approximate percentiles over ``ChunkIterator`` chunks.

    Every chunk is flattened (``axis=None``, as the in-memory
    ``percentile``); :meth:`percentile`/:meth:`median` answer within the
    :attr:`eps` fractional-rank bound of the exact result.

    Parameters
    ----------
    k : int
        Items per level (default 256): the rank error scales as 1/k, the
        state as ``2 * levels * k`` values.
    levels : int
        Height of the level stack (default 12): folds past
        ``2**(levels - 1)`` chunks start force-compacting the top level,
        which :attr:`eps` counts.
    """

    _COMBINE = staticmethod(merge_states)

    def __init__(self, k: int = 256, levels: int = 12):
        super().__init__()
        if k < 8:
            raise ValueError(f"k must be >= 8, got {k}")
        if levels < 2:
            raise ValueError(f"levels must be >= 2, got {levels}")
        self.k = int(k)
        self.levels = int(levels)
        self._folds = 0
        self._extra = 0
        self._vals = None
        self._wts = None

    def update(self, chunk: DNDarray) -> "KLLSketch":
        xa, across, comm = self._capture(chunk)
        if self._vals is None:
            self._vals, self._wts = (t.expand(self.levels, self.k).clone() for t in _empty(self.k, xa.dtype,
                                                                                             xa.device))
        x = xa.reshape(-1)
        if across:
            sv, sw = _summary(x, self.k) if x.numel() else _empty(self.k, xa.dtype, xa.device)
            # graftflow: F008 - runs on the consumer's thread; the prefetch thread moves host chunks only
            gathered = comm.allgather(torch.stack([sv, sw]).unsqueeze(0), 0, [1] * comm.size)
            order = torch.sort(gathered[:, 0].reshape(-1), stable=True).indices
            sv, sw = _compress(gathered[:, 0].reshape(-1)[order], gathered[:, 1].reshape(-1)[order], self.k)
            self._extra = 1
        else:
            sv, sw = _summary(x, self.k)
        self._vals, self._wts = _cascade(self._vals, self._wts, sv, sw)
        self._n += int(chunk.gshape[0])
        self._folds += 1
        return self

    def merge(self, other: "KLLSketch") -> "KLLSketch":
        """Fold ``other``'s state into this one."""
        if (self.k, self.levels) != (other.k, other.levels):
            raise ValueError("cannot merge KLL sketches with different geometry")
        self._require_data()
        other._require_data()
        self._extra = max(self._extra, other._extra)
        self._set_state(merge_states(self._state(), other._state()))
        return self

    def _state(self):
        dev = self._vals.device
        return (torch.tensor(self._n, dtype=torch.int64, device=dev),
                torch.tensor(self._folds, dtype=torch.int64, device=dev), self._vals, self._wts)

    def _set_state(self, state):
        n, folds, self._vals, self._wts = state
        self._n = int(n)
        self._folds = int(folds)

    @property
    def eps(self) -> float:
        """The fractional-rank error bound at the current fold count."""
        folds = max(1, self._folds)
        levels_used = min(self.levels, folds.bit_length())
        spills = folds >> (self.levels - 1)
        return (2 + self._extra + levels_used + spills) / (2.0 * self.k)

    def percentile(self, q) -> DNDarray:
        """Approximate q-th percentile(s), ``q`` in [0, 100] (a scalar or 1-D)."""
        self._require_data()
        qs = torch.as_tensor(q, dtype=torch.float32, device=self._vals.device) / 100.0
        return self._wrap(_quantile(self._vals, self._wts, qs))

    def median(self) -> DNDarray:
        """Approximate median (``percentile(50)``)."""
        return self.percentile(50.0)
