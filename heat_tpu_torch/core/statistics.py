"""Statistics: ``mean``, ``var`` and ``std``, the extrema ``min``/
``max``/``argmin``/``argmax``/``minimum``/``maximum``/``nanmin``/``nanmax``,
the order statistics ``percentile``/``median``, ``nanmean``, ``average``,
``cov``, ``skew``, ``kurtosis`` and the histograms ``histc``/``histogram``/
``bincount``/``bucketize``/``digitize`` (counterpart of
``heat_tpu/core/statistics.py``).

The order statistics follow ``heat_tpu``'s ``_sorted_percentile``: numpy's
index arithmetic (q/100 in float64, cast to the array's float type, times
n - 1 in that type), the five interpolations, q-dims first, NaN in a line
making every q NaN. Along the split axis of a distributed array the order
statistics come from the exact selection of
:mod:`heat_tpu_torch.parallel.dselect` (each rank's sorted keys and one
small ``allreduce`` per key bit); elsewhere from a local sort. The moments, histograms and counts
reduce each rank's chunk and add the partial results with one
``allreduce``; none of these functions gathers a split array along its
split axis.

The extrema reduce over :func:`._operations._reduce_op` with module-level
callables. NaN wins in ``min``/``max``/``argmin``/``argmax``/``minimum``/
``maximum`` and is skipped by ``nanmin``/``nanmax`` (NaN only where a
whole slice is NaN); ``arg*`` give int64 and the first index of a tie.

All three finalize from one (count, mean, M2) panel per buffer and axis,
computed in one read and memoized, so ``ht.mean(x)`` followed by
``ht.std(x)`` reads ``x`` once:

- float32 1-D and 2-D buffers along axis 0 or ``None`` go through the
  ``moments_onepass`` kernel wrapper (:func:`kernels.moments_local`) on a
  card, or its plain version on the CPU; ``axis=None`` merges the
  per-column moments with :func:`_panel_cols_merge`;
- other float panels (float64, ``axis=1``) use a plain shifted-sums
  program, as ``heat_tpu`` uses its XLA program there;
- integer inputs, >2-D inputs and tuple axes reduce directly;
- float16 and bfloat16 reduce directly in float32, and the result takes
  the input's type; complex input reduces its real and imaginary parts
  directly (the mean is complex, the variance the parts' sum, real). None
  of them reaches the kernel, as in ``heat_tpu``, which sends only
  float32 to ``moments_onepass``.

The memo key is the tensor's identity *and* its ``_version``: torch
tensors are mutable, so an in-place update (``x.larray.add_(1)``) bumps the
version and the next call recomputes instead of serving stale moments.

Across ranks each rank computes its chunk's moments (a rank with an empty
chunk contributes (0, 0, 0) and launches nothing), and
:func:`kernels.moments_sharded` combines them by Chan's formulas. A ragged
array takes the same route on the rows each rank holds: ``heat_tpu``
declines its panel there and takes a masked reduction, the port runs
``moments_onepass`` on each rank's rows and merges; the results agree
within the merge's rounding, and the moments keep the layout where the
split axis survives. The
extrema reduce as every ``_reduce_op`` does; ``argmin``/``argmax`` over
the split axis gather each rank's best value and its global index and keep
the lowest index among the best.
"""
from __future__ import annotations

import builtins
import weakref
from typing import Tuple

import numpy as np
import torch

from . import _hooks, _operations, factories, types
from ._operations import (
    _binary_op, _like_layout, _local_operand, _over_axes, _reduce_op, _reduced_shape, _reduced_split, _write_out,
)
from .dndarray import DNDarray
from .kernels import MOMENTS_KERNEL, chunk_moments, dispatch_mode, moments_local, moments_sharded, record_dispatch
from .stride_tricks import sanitize_axis

__all__ = [
    "argmax",
    "argmin",
    "average",
    "bincount",
    "bucketize",
    "cov",
    "digitize",
    "histc",
    "histogram",
    "kurtosis",
    "max",
    "maximum",
    "mean",
    "median",
    "min",
    "minimum",
    "nanmax",
    "nanmean",
    "nanmin",
    "percentile",
    "skew",
    "std",
    "var",
]

# id(tensor) -> [weakref, _version, requested mode, {axis_key: stats}, {axis_key: mode}].
# Keyed by id(); the weakref's death callback drops the slot, so a recycled
# id never aliases a dead tensor, and the identity check below guards the rest.
_PANELS: dict = {}
_PANELS_CAP = 32  # entries are tiny (scalars + one (f,) row)


def _axis_key(axis_s) -> str:
    return "all" if axis_s is None else str(axis_s)


def _float_type(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.dtype in (torch.float64, torch.int64) else torch.float32


def _panel_program(arr: torch.Tensor, axis_s):
    """One-read shifted-sums moments of a 1-D/2-D buffer along ``axis_s``
    (plain torch; ``s1 = Σ(x−x₀)``, ``s2 = Σ(x−x₀)²``)."""
    x = arr.to(_float_type(arr))
    shift = x[(0,) * x.ndim]
    xs = x - shift
    if axis_s is None:
        c = float(x.numel())
        s1, s2 = xs.sum(), (xs * xs).sum()
    else:
        c = float(x.shape[axis_s])
        s1, s2 = xs.sum(dim=axis_s), (xs * xs).sum(dim=axis_s)
    return c, shift + s1 / c, torch.clamp(s2 - s1 * s1 / c, min=0.0)


def _panel_cols_merge(cnt: float, mean: torch.Tensor, m2: torch.Tensor):
    """Chan-merge equal-count per-column moments into the whole-buffer
    moments: counts add, the grand mean is the column-mean average, and M2
    gains the between-column ``n·(mean_c − gmean)²`` term."""
    gmean = mean.mean()
    dm = mean - gmean
    return cnt * mean.shape[0], gmean, m2.sum() + cnt * (dm * dm).sum()


def _panel_kernel_stats(arr: torch.Tensor, mode: str) -> dict:
    """Axis-0 and whole-buffer moments of a float32 1-D/2-D buffer in one
    read: the kernel wrapper for mode ``"cuda"``, the plain version for
    ``"torch"``."""
    buf = arr if arr.ndim == 2 else arr.reshape(-1, 1)
    n = buf.shape[0]
    _, mean_, m2 = moments_local(buf, n) if mode == "cuda" else chunk_moments(buf, n)
    cnt = float(n)  # exact on the host; the kernel's float32 count rounds past 2^24
    if arr.ndim == 2:
        return {"0": (cnt, mean_, m2), "all": _panel_cols_merge(cnt, mean_, m2)}
    # axis 0 of a 1-D array is the whole buffer: serve both keys
    t = (cnt, mean_[0], m2[0])
    return {"all": t, "0": t}


def _panel_entries(arr: torch.Tensor, axis_s, req_mode: str):
    """``(mode, {axis_key: stats})`` computed in one read: the kernel's
    layout (float32, axis 0 or None) through :func:`_panel_kernel_stats`,
    anything else through the plain program on the tensor's device."""
    if arr.dtype == torch.float32 and (arr.ndim == 1 or axis_s in (None, 0)):
        return req_mode, _panel_kernel_stats(arr, req_mode)
    return "torch", {_axis_key(axis_s): _panel_program(arr, axis_s)}


def _moments_panel(x: DNDarray, axis_s):
    """(count, mean, M2) of ``x`` along ``axis_s`` from the memoized panel,
    or None when the panel declines (int dtypes, >2-D, tuple axes, empty, an
    open lazy scope, a layout probe)."""
    if _operations._capture is not None and _operations._capture.active():
        return None  # a lazy scope: the moment's capture point must see the call
    if _hooks.in_trace_safe():
        return None
    if x.ndim not in (1, 2) or 0 in tuple(x.gshape):
        return None
    if axis_s is not None and not isinstance(axis_s, int):
        return None
    arr = x._raw
    if arr.dtype not in (torch.float32, torch.float64):
        return None
    if arr.numel() == 0:  # an empty chunk of a non-empty array: nothing to read, nothing to launch
        z = torch.zeros(_reduced_shape(arr.shape, axis_s, False), dtype=_float_type(arr), device=arr.device)
        return 0.0, z, z
    req_mode = dispatch_mode(MOMENTS_KERNEL, arr)
    akey = _axis_key(axis_s)
    if arr.is_inference():
        # inference tensors keep no version counter, so an in-place update
        # could not be seen: compute without memoizing
        mode, entries = _panel_entries(arr, axis_s, req_mode)
        record_dispatch(MOMENTS_KERNEL, mode)
        return entries[akey]
    bid = id(arr)
    ent = _PANELS.get(bid)
    if ent is not None and (ent[0]() is not arr or ent[1] != arr._version or ent[2] != req_mode):
        _PANELS.pop(bid, None)
        ent = None
    if ent is not None and akey in ent[3]:
        # memo hit: no data read; report the mode that computed it
        record_dispatch(MOMENTS_KERNEL, ent[4][akey])
        return ent[3][akey]
    mode, entries = _panel_entries(arr, axis_s, req_mode)
    record_dispatch(MOMENTS_KERNEL, mode)
    if ent is None:
        if len(_PANELS) >= _PANELS_CAP:
            _PANELS.pop(next(iter(_PANELS)))  # FIFO bound
        ent = [weakref.ref(arr, lambda _, bid=bid: _PANELS.pop(bid, None)), arr._version, req_mode, {}, {}]
        _PANELS[bid] = ent
    ent[3].update(entries)
    for key in entries:
        ent[4][key] = mode
    return ent[3][akey]


def _wrap_moment(x: DNDarray, axis_s, result: torch.Tensor) -> DNDarray:
    """Wrap a finalized moment with the reduced split and shape."""
    result = torch.as_tensor(result)
    return _like_layout(x, result.reshape(_reduced_shape(x.lshape, axis_s, False)),
                        _reduced_shape(x.gshape, axis_s, False), types.canonical_heat_type(result.dtype),
                        _reduced_split(x.split, axis_s, x.ndim, False))


def _direct_moments(x: DNDarray, axis_s, where=None):
    """(count, mean, M2) by a direct two-pass reduction over the logical
    tensor, with an optional boolean ``where`` mask broadcast to ``x``
    (which the caller has rebalanced)."""
    t = x._raw.to(_float_type(x._raw))
    dims = tuple(range(t.ndim)) if axis_s is None else ((axis_s,) if isinstance(axis_s, int) else tuple(axis_s))
    if where is None:
        w = torch.ones_like(t)
    else:
        if not isinstance(where, DNDarray):
            where = factories.array(where, device=x.device, comm=x.comm)
        wt = _local_operand(where, x.gshape, x.split)
        w = torch.broadcast_to(wt.to(device=t.device, dtype=torch.bool), t.shape).to(t.dtype)
    c = w.sum(dim=dims)
    mean_ = (t * w).sum(dim=dims) / c
    d = (t - mean_.reshape([1 if i in dims else s for i, s in enumerate(t.shape)])) * w
    return c, mean_, (d * d).sum(dim=dims)


def _moments(x: DNDarray, axis, where):
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
    axis_s = sanitize_axis(x.shape, axis)
    axes = range(x.ndim) if axis_s is None else ((axis_s,) if isinstance(axis_s, int) else axis_s)
    across = x.split is not None and x.split in axes and x.comm.is_distributed()
    if where is not None:
        x.balance_()  # the mask meets the ceil-div chunks
    if x.dtype in (types.complex64, types.complex128):
        # |z - m|^2 = (re - m_re)^2 + (im - m_im)^2: the parts' moments, on the direct route
        parts = []
        # graftflow: F003 - two parts on every rank
        for part in (x._raw.real, x._raw.imag):
            p = _like_layout(x, part, x.gshape, types.canonical_heat_type(part.dtype), x.split)
            stats = _direct_moments(p, axis_s, where)
            parts.append(moments_sharded(*stats, x.comm) if across else stats)
        (c, m_re, m2_re), (_, m_im, m2_im) = parts
        return axis_s, (c, torch.complex(m_re, m_im), m2_re + m2_im)
    stats = None if where is not None else _moments_panel(x, axis_s)
    # graftflow: F001 - the panel declines on replicated metadata only (ndim, gshape, axis, dtype, an open scope)
    if stats is None:
        # where= masks cannot key the memo: they decline to a direct reduction
        stats = _direct_moments(x, axis_s, where)
    if across:
        stats = moments_sharded(*stats, x.comm)
    return axis_s, stats


def _moment_type(x: DNDarray, result: torch.Tensor) -> torch.Tensor:
    """A moment in ``heat_tpu``'s type: a half-precision input's own."""
    return result.to(x._raw.dtype) if x._raw.dtype in (torch.float16, torch.bfloat16) else result


def mean(x: DNDarray, axis=None, where=None) -> DNDarray:
    """Arithmetic mean along ``axis``. A following ``std``/``var`` on the
    same tensor reuses the memoized moments and reads no data."""
    if _operations._capture is not None and _operations._capture.active():
        res = _operations._capture.moment(mean, x, axis, None, where)
        if res is not NotImplemented:
            return res
    axis_s, (_, m, _) = _moments(x, axis, where)
    return _wrap_moment(x, axis_s, _moment_type(x, m))


def var(x: DNDarray, axis=None, ddof: int = 0, where=None) -> DNDarray:
    """Variance along ``axis`` with ``ddof`` delta degrees of freedom."""
    if _operations._capture is not None and _operations._capture.active():
        res = _operations._capture.moment(var, x, axis, ddof, where)
        if res is not NotImplemented:
            return res
    axis_s, (c, _, m2) = _moments(x, axis, where)
    return _wrap_moment(x, axis_s, _moment_type(x, (m2 / (c - ddof)).to(m2.dtype)))


def std(x: DNDarray, axis=None, ddof: int = 0, where=None) -> DNDarray:
    """Standard deviation along ``axis`` with ``ddof`` delta degrees of freedom."""
    if _operations._capture is not None and _operations._capture.active():
        res = _operations._capture.moment(std, x, axis, ddof, where)
        if res is not NotImplemented:
            return res
    axis_s, (c, _, m2) = _moments(x, axis, where)
    return _wrap_moment(x, axis_s, _moment_type(x, torch.sqrt(m2 / (c - ddof)).to(m2.dtype)))


# ----------------------------------------------------------------- extrema
def _lex_extreme(t: torch.Tensor, axis, keepdims: bool, largest: bool) -> torch.Tensor:
    """The lexicographic maximum (``largest``) or minimum of a complex
    tensor: the extreme real part, then the extreme imaginary part among
    the elements that have it."""
    red = torch.amax if largest else torch.amin
    re = _over_axes(red, t.real, axis, True)
    fill = float("-inf") if largest else float("inf")
    im = _over_axes(red, torch.where(t.real == re, t.imag, fill), axis, True)
    out = torch.complex(re, im)
    return out if keepdims else out.reshape(_reduced_shape(t.shape, axis, False))


def _max(t: torch.Tensor, axis, keepdims: bool) -> torch.Tensor:
    if t.is_complex():
        return _lex_extreme(t, axis, keepdims, True)
    return _over_axes(torch.amax, t, axis, keepdims)


def _min(t: torch.Tensor, axis, keepdims: bool) -> torch.Tensor:
    if t.is_complex():
        return _lex_extreme(t, axis, keepdims, False)
    return _over_axes(torch.amin, t, axis, keepdims)


def _nan_skipping(reduce, fill: float):
    """``reduce`` with NaN replaced by ``fill`` (the reduction's identity);
    NaN again where every element of a slice was NaN."""

    def run(t: torch.Tensor, axis, keepdims: bool) -> torch.Tensor:
        if not t.is_floating_point():
            return reduce(t, axis, keepdims)  # integers hold no NaN; complex NaN is not skipped
        nan = torch.isnan(t)
        r = reduce(t.masked_fill(nan, fill), axis, keepdims)
        return r.masked_fill(_over_axes(torch.all, nan, axis, keepdims), float("nan"))

    return run


_NANMAX = _nan_skipping(_max, float("-inf"))
_NANMIN = _nan_skipping(_min, float("inf"))


def max(x: DNDarray, axis=None, out=None, keepdim=None, keepdims=None) -> DNDarray:
    """Maximum along ``axis``; NaN wins."""
    return _reduce_op(_max, x, axis=axis, out=out, keepdims=bool(keepdim or keepdims))


def min(x: DNDarray, axis=None, out=None, keepdim=None, keepdims=None) -> DNDarray:
    """Minimum along ``axis``; NaN wins."""
    return _reduce_op(_min, x, axis=axis, out=out, keepdims=bool(keepdim or keepdims))


def nanmax(x: DNDarray, axis=None, out=None, keepdim=None, keepdims=None) -> DNDarray:
    """Maximum along ``axis``, NaNs skipped."""
    return _reduce_op(_NANMAX, x, axis=axis, out=out, keepdims=bool(keepdim or keepdims))


def nanmin(x: DNDarray, axis=None, out=None, keepdim=None, keepdims=None) -> DNDarray:
    """Minimum along ``axis``, NaNs skipped."""
    return _reduce_op(_NANMIN, x, axis=axis, out=out, keepdims=bool(keepdim or keepdims))


def _maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    from .relational import _GE

    return torch.where(_GE(a, b), a, b) if a.is_complex() else torch.maximum(a, b)


def _minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    from .relational import _LE

    return torch.where(_LE(a, b), a, b) if a.is_complex() else torch.minimum(a, b)


def maximum(x1, x2, out=None) -> DNDarray:
    """Elementwise maximum; NaN wins; complex numbers order lexicographically."""
    return _binary_op(_maximum, x1, x2, out=out)


def minimum(x1, x2, out=None) -> DNDarray:
    """Elementwise minimum; NaN wins; complex numbers order lexicographically."""
    return _binary_op(_minimum, x1, x2, out=out)


def _arg_reduce(op, x: DNDarray, axis, out) -> DNDarray:
    # offered for lazy capture before the tensor read below forces a pending operand
    if _operations._capture is not None and _operations._capture.active():
        res = _operations._capture.argreduce(op, x, axis, out)
        if res is not NotImplemented:
            return res
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
    axis = sanitize_axis(x.shape, axis)
    if axis is not None and not isinstance(axis, int):
        raise TypeError(f"axis must be None or an int, got {axis}")
    arr = x.larray
    if arr.dtype == torch.bool:
        arr = arr.to(torch.uint8)
    if arr.is_complex():
        raise TypeError(f"{op.__name__} does not accept complex input, as heat_tpu does not")
    comm, split = x.comm, x.split
    if split is not None and axis in (None, split) and comm.is_distributed():
        result = _arg_across_ranks(op, x, arr, axis)
    else:
        result = op(arr, dim=axis)
    res = DNDarray(
        result.to(torch.int64),
        gshape=_reduced_shape(x.gshape, axis, False),
        dtype=types.int64,
        split=_reduced_split(split, axis, x.ndim, False),
        device=x.device,
        comm=comm,
    )
    if out is not None:
        return _write_out(out, res)
    return res


def _arg_across_ranks(op, x: DNDarray, arr: torch.Tensor, axis) -> torch.Tensor:
    """``op`` (``torch.argmin``/``argmax``) over the split axis or the whole
    array: each rank's best value and its global index are gathered, the
    best of those wins, NaN first, and the lowest index among equals."""
    comm, split = x.comm, x.split
    offset, lshape, _ = comm.chunk(x.gshape, split)
    if lshape[split] == 0:  # a stand-in row; this rank's candidate is dropped below
        arr = arr.new_zeros(tuple(1 if d == split else s for d, s in enumerate(arr.shape)))
        offset = 0
    if axis is None:
        i = int(op(arr))
        val = arr.reshape(-1)[i]
        coords = list(np.unravel_index(i, tuple(arr.shape)))
        coords[split] += offset
        gidx = torch.tensor(int(np.ravel_multi_index(coords, x.gshape)), device=arr.device)
    else:
        idx = op(arr, dim=axis, keepdim=True)
        val = torch.take_along_dim(arr, idx, dim=axis).squeeze(axis)
        gidx = idx.squeeze(axis) + offset
    keep = [r for r, n in enumerate(x.lshape_map[:, split]) if n > 0]
    vals = comm.allgather(val.unsqueeze(0), 0, [1] * comm.size)[keep]
    idxs = comm.allgather(gidx.unsqueeze(0), 0, [1] * comm.size)[keep]
    best = torch.take_along_dim(vals, op(vals, dim=0, keepdim=True), dim=0)
    tie = (vals == best) | (torch.isnan(vals) & torch.isnan(best)) if vals.is_floating_point() else vals == best
    return torch.where(tie, idxs, torch.full_like(idxs, torch.iinfo(torch.int64).max)).amin(dim=0)


def argmax(x: DNDarray, axis=None, out=None, **kwargs) -> DNDarray:
    """Index of the maximum along ``axis`` (of the flattened array if None)."""
    return _arg_reduce(torch.argmax, x, axis, out)


def argmin(x: DNDarray, axis=None, out=None, **kwargs) -> DNDarray:
    """Index of the minimum along ``axis`` (of the flattened array if None)."""
    return _arg_reduce(torch.argmin, x, axis, out)


# --------------------------------------------------------- order statistics
def _is_stream(x) -> bool:
    from ..stream.chunked import ChunkIterator

    return isinstance(x, ChunkIterator)


def _streaming_percentile(chunks, q_host: np.ndarray, axis, kd: bool) -> DNDarray:
    """One pass of a ``ChunkIterator`` through a KLL sketch: approximate
    percentiles of all its elements, within the sketch's ``eps`` of rank
    (``heat_tpu``'s streaming route)."""
    if axis is not None:
        raise ValueError(
            "streaming percentile/median folds all elements (axis=None "
            f"semantics); per-axis reduction is not supported, got axis={axis}"
        )
    if kd:
        raise ValueError("keepdim is not supported on the streaming path")
    from ..stream.sketch import KLLSketch

    sk = KLLSketch()
    for chunk in chunks:
        sk.update(chunk)
    return sk.percentile(q_host.tolist())


def _reject_stream(x, name: str) -> None:
    if not isinstance(x, DNDarray):
        raise TypeError(
            f"{name} expects a DNDarray (exact, in-memory) or a heat_tpu_torch.stream.ChunkIterator "
            f"(single-pass approximate KLL sketch path), got {type(x).__name__}"
        )
    if types.heat_type_is_complexfloating(x.dtype):
        raise ValueError(f"{name} does not support complex input: complex numbers have no order to rank by")


def _inexact(dtype: torch.dtype) -> torch.dtype:
    """The float type order statistics compute in: float64 for float64
    input, float32 for everything else (``heat_tpu``'s rule)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _ranked_values(x: DNDarray, ax: int, ranks) -> torch.Tensor:
    """The values at ``ranks`` (host ints) of ``x`` sorted along ``ax``, as
    a tensor ``(len(ranks),) + the other dimensions`` of this rank's chunk
    (whole along ``ax``). Along the split axis of a distributed array they
    come from the selection of :mod:`heat_tpu_torch.parallel.dselect` (one
    small ``allreduce`` per key bit, no gather); else from a local sort."""
    from ..parallel.dselect import select_values

    t = x.larray
    ranks_t = torch.as_tensor(np.asarray(ranks, dtype=np.int64), device=t.device)
    if x.split == ax and x.comm.is_distributed():
        moved = t.movedim(ax, 0)
        rest = tuple(moved.shape[1:])
        cols = moved.reshape(moved.shape[0], int(np.prod(rest, dtype=np.int64)))
        targets = ranks_t.reshape(-1, 1, 1).expand(-1, 1, cols.shape[1]).contiguous()
        return select_values(cols, targets, comm=x.comm).reshape((len(ranks),) + rest)
    srt = torch.sort(t, dim=ax)[0]
    return srt.index_select(ax, ranks_t).movedim(ax, 0)


def _any_nan(x: DNDarray, ax: int) -> torch.Tensor:
    """Whether each line along ``ax`` holds a NaN (this rank's other
    dimensions); across ranks an ``allreduce`` where ``ax`` is split."""
    nan = torch.isnan(x.larray).any(dim=ax) if x.larray.is_floating_point() else \
        torch.zeros(_reduced_shape(x.lshape, ax, False), dtype=torch.bool, device=x.larray.device)
    if x.split == ax and x.comm.is_distributed():
        nan = x.comm.allreduce(nan.to(torch.int32), "max").to(torch.bool)
    return nan


def _gather_axis(t: torch.Tensor, x: DNDarray, ax: int, lead: int) -> torch.Tensor:
    """A result computed on this rank's chunk, whole: gathered along the
    result axis of ``x``'s split axis where that is not the reduced ``ax``
    (``lead`` result axes come first)."""
    if x.split is None or x.split == ax or not x.comm.is_distributed():
        return t
    rax = lead + x.split - (1 if x.split > ax else 0)
    return x.comm.allgather(t, rax, x.lshape_map[:, x.split])


def _sorted_percentile(x: DNDarray, q_host: np.ndarray, axis_s, method: str, kd: bool) -> torch.Tensor:
    """``heat_tpu``'s ``_sorted_percentile`` (numpy's index arithmetic): q/100
    in float64, cast to the array's float type (float64 for integers),
    times n - 1 in that type; the order statistics at the floor and ceiling
    of that position; q-dims first; NaN in a line makes every q NaN."""
    from . import manipulations

    if axis_s is None and x.ndim > 1:
        xs, ax = manipulations.flatten(x), 0
    else:
        xs, ax = x, (0 if axis_s is None else axis_s)
    n = xs.gshape[ax]
    ct = _inexact(xs.larray.dtype)
    idx_t = (np.float64 if ct == torch.float64 else np.float32) if xs.larray.is_floating_point() else np.float64
    np_ct = np.float64 if ct == torch.float64 else np.float32
    pos = (q_host.astype(np.float64) / 100.0).astype(idx_t) * idx_t(n - 1)
    lo_i = np.clip(np.floor(pos).astype(np.int64), 0, n - 1)
    hi_i = np.clip(np.ceil(pos).astype(np.int64), 0, n - 1)
    near_i = np.clip(np.round(pos).astype(np.int64), 0, n - 1)
    wanted = {"lower": [lo_i], "higher": [hi_i], "nearest": [near_i]}.get(method, [lo_i, hi_i])
    ranks = np.unique(np.concatenate([w.reshape(-1) for w in wanted]))
    vals = _ranked_values(xs, ax, ranks.tolist()).to(ct)
    dev = vals.device

    def take(i):
        at = torch.as_tensor(np.searchsorted(ranks, i.reshape(-1)), device=dev)
        return vals.index_select(0, at).reshape(q_host.shape + tuple(vals.shape[1:]))

    if method in ("lower", "higher", "nearest"):
        res = take(wanted[0])
    else:
        vlo, vhi = take(lo_i), take(hi_i)
        if method == "midpoint":
            res = (vlo + vhi) / 2
        else:
            w = torch.as_tensor((pos - np.floor(pos)).astype(np_ct), device=dev)
            res = vlo + w.reshape(q_host.shape + (1,) * (vals.ndim - 1)) * (vhi - vlo)
    qn = q_host.ndim
    nan = _any_nan(xs, ax)
    res = torch.where(nan.reshape((1,) * qn + tuple(nan.shape)), torch.full_like(res, float("nan")), res)
    res = _gather_axis(res, xs, ax, qn)
    if kd:
        res = res.reshape(q_host.shape + (1,) * x.ndim) if axis_s is None else res.unsqueeze(qn + ax)
    return res


def _tuple_axis_view(x: DNDarray, axes) -> Tuple[DNDarray, tuple]:
    """``x`` gathered with ``axes`` moved last and merged into one, as a
    replicated array, and the keepdims shape (``jnp.quantile``'s layout)."""
    t = x._logical()
    keep = [d for d in range(x.ndim) if d not in axes]
    moved = t.permute(keep + list(axes)).reshape([x.gshape[d] for d in keep] + [-1])
    keepdim = tuple(1 if d in axes else s for d, s in enumerate(x.gshape))
    return DNDarray(moved.contiguous(), dtype=x.dtype, split=None, device=x.device, comm=x.comm), keepdim


def percentile(x: DNDarray, q, axis=None, out=None, interpolation: str = "linear", keepdim: bool = False,
               keepdims=None) -> DNDarray:
    """The q-th percentiles along ``axis`` (``linear``, ``lower``,
    ``higher``, ``midpoint`` or ``nearest``), with numpy's index
    arithmetic, q-dims first, replicated. Along the split axis the order
    statistics come from the selection of :mod:`heat_tpu_torch.parallel.dselect`,
    never from a gathered array."""
    kd = bool(keepdim or keepdims)
    # graftlint: G004 - the percentiles themselves are read once, to size the selection
    q_host = np.asarray(q.numpy() if isinstance(q, DNDarray) else q)
    if q_host.size and not np.all((q_host >= 0) & (q_host <= 100)):
        raise ValueError("percentiles must be in the range [0, 100]")
    if _is_stream(x):
        res = _streaming_percentile(x, q_host, axis, kd)
        return _write_out(out, res) if out is not None else res
    _reject_stream(x, "percentile")
    axis_s = sanitize_axis(x.shape, axis)
    method = {"lower": "lower", "higher": "higher", "midpoint": "midpoint", "nearest": "nearest",
              "linear": "linear"}[interpolation]
    if axis_s is None or isinstance(axis_s, int):
        result = _sorted_percentile(x, q_host, axis_s, method, kd)
    else:
        result = _quantile_tuple(x, q_host / 100.0, axis_s, method, kd)
    res = DNDarray(result, dtype=types.canonical_heat_type(result.dtype), split=None, device=x.device, comm=x.comm)
    return _write_out(out, res) if out is not None else res


def _quantile_tuple(x: DNDarray, q: np.ndarray, axes, method: str, kd: bool) -> torch.Tensor:
    """``jnp.quantile`` over several axes (the gathered array, as
    ``heat_tpu`` computes it): q in float64, positions q·(n - 1), the
    linear rule as ``low·(1 - w) + high·w``."""
    view, keepdim = _tuple_axis_view(x, axes)
    t = view.larray.to(_inexact(view.larray.dtype))
    n = t.shape[-1]
    nan = torch.isnan(t).any(dim=-1)
    srt = torch.sort(t, dim=-1)[0]
    pos = q.astype(np.float64) * (n - 1)
    lo, hi = np.clip(np.floor(pos), 0, n - 1).astype(np.int64), np.clip(np.ceil(pos), 0, n - 1).astype(np.int64)
    hw = pos - np.floor(pos)

    def take(i):
        return srt.index_select(-1, torch.as_tensor(i.reshape(-1), device=t.device)).movedim(-1, 0).reshape(
            q.shape + tuple(srt.shape[:-1]))

    vlo, vhi = take(lo), take(hi)
    shape_w = q.shape + (1,) * (srt.ndim - 1)
    if method == "linear":
        res = (vlo.double() * torch.as_tensor(1 - hw).reshape(shape_w) + vhi.double() * torch.as_tensor(hw).reshape(shape_w)).to(t.dtype)
    elif method == "lower":
        res = vlo
    elif method == "higher":
        res = vhi
    elif method == "nearest":
        res = torch.where(torch.as_tensor(hw <= 0.5).reshape(shape_w), vlo, vhi)
    else:
        res = (vlo + vhi) * 0.5
    res = torch.where(nan.reshape((1,) * q.ndim + tuple(nan.shape)), torch.full_like(res, float("nan")), res)
    if kd:
        res = res.reshape(q.shape + keepdim)
    return res


def median(x: DNDarray, axis=None, keepdim: bool = False, keepdims=None) -> DNDarray:
    """The median along ``axis``: the middle order statistic, or the
    midpoint of the two middle ones (NaN where a line holds NaN). Along
    the split axis of a distributed array it is ``heat_tpu``'s 50th
    percentile there (linear rule, replicated; the selection, no
    gather); elsewhere ``jnp.median``'s midpoint, split as a reduction."""
    kd = bool(keepdim or keepdims)
    if _is_stream(x):
        return _streaming_percentile(x, np.asarray(50.0), axis, kd)
    _reject_stream(x, "median")
    axis_s = sanitize_axis(x.shape, axis)
    if x.split is not None and x.comm.is_distributed() and (axis_s is None or axis_s == x.split):
        result = _sorted_percentile(x, np.asarray(50.0), axis_s, "linear", kd)
        return DNDarray(result, dtype=types.canonical_heat_type(result.dtype), split=None, device=x.device,
                        comm=x.comm)
    if axis_s is None or isinstance(axis_s, tuple):
        # jnp.median ravels (or merges the axes into a last one) and keeps the result replicated
        axes = tuple(range(x.ndim)) if axis_s is None else axis_s
        view, keepdim_shape = _tuple_axis_view(x, axes)
        res = _moment_type(x, _midpoint_median(view.larray.to(_inexact(view.larray.dtype)), -1))
        if kd:
            res = res.reshape(keepdim_shape)
        return DNDarray(res, dtype=types.canonical_heat_type(res.dtype), split=None, device=x.device, comm=x.comm)
    t = x.larray.to(_inexact(x.larray.dtype))
    res = _moment_type(x, _midpoint_median(t, axis_s))
    if kd:
        res = res.unsqueeze(axis_s)
    split = _reduced_split(x.split, axis_s, x.ndim, kd)
    return DNDarray(res, gshape=_reduced_shape(x.gshape, axis_s, kd), dtype=types.canonical_heat_type(res.dtype),
                    split=split, device=x.device, comm=x.comm)


def _midpoint_median(t: torch.Tensor, ax: int) -> torch.Tensor:
    """``jnp.median`` along ``ax`` of a local tensor: ``(lo + hi) * 0.5`` of
    the middle order statistics, NaN where the line holds NaN."""
    n = t.shape[ax]
    pos = np.asarray(0.5, dtype=np.float64 if t.dtype == torch.float64 else np.float32) * (n - 1)
    top = builtins.max(n - 1, 0)
    lo, hi = int(np.clip(np.floor(pos), 0, top)), int(np.clip(np.ceil(pos), 0, top))
    srt = torch.sort(t, dim=ax)[0]
    res = (srt.select(ax, lo) + srt.select(ax, hi)) * 0.5
    nan = torch.isnan(t).any(dim=ax)
    return torch.where(nan, torch.full_like(res, float("nan")), res)


# ------------------------------------------------------------ more moments
def _sum_over(t: torch.Tensor, x: DNDarray, axis_s, keepdim: bool = False) -> torch.Tensor:
    """The sum of this rank's tensor ``t`` (shaped like ``x``'s chunk) over
    ``axis_s``, completed by an ``allreduce`` where the split axis is
    reduced."""
    dims = tuple(range(t.ndim)) if axis_s is None else ((axis_s,) if isinstance(axis_s, int) else tuple(axis_s))
    s = t.sum(dim=dims, keepdim=keepdim) if dims else t
    if x.split is not None and x.split in dims and x.comm.is_distributed():
        s = x.comm.allreduce(s)
    return s


def _count_over(x: DNDarray, axis_s) -> int:
    dims = tuple(range(x.ndim)) if axis_s is None else ((axis_s,) if isinstance(axis_s, int) else tuple(axis_s))
    return int(np.prod([x.gshape[d] for d in dims], dtype=np.int64))


def _wrap_reduced(x: DNDarray, axis_s, t: torch.Tensor, keepdims: bool = False) -> DNDarray:
    return DNDarray(t, gshape=_reduced_shape(x.gshape, axis_s, keepdims), dtype=types.canonical_heat_type(t.dtype),
                    split=_reduced_split(x.split, axis_s, x.ndim, keepdims), device=x.device, comm=x.comm)


def nanmean(x: DNDarray, axis=None, out=None, keepdim=None, keepdims=None) -> DNDarray:
    """The mean along ``axis`` of the elements that are not NaN (NaN where
    a line has none): local sums and counts, one ``allreduce`` each where
    the split axis is reduced."""
    kd = bool(keepdim or keepdims)
    axis_s = sanitize_axis(x.shape, axis)
    t = x.larray.to(_inexact(x.larray.dtype))
    nan = torch.isnan(t)
    s = _sum_over(torch.where(nan, torch.zeros_like(t), t), x, axis_s, kd)
    c = _sum_over((~nan).to(t.dtype), x, axis_s, kd)
    res = _wrap_reduced(x, axis_s, s / c, kd)
    return _write_out(out, res) if out is not None else res


def average(x: DNDarray, axis=None, weights=None, returned: bool = False):
    """The weighted mean along ``axis`` (``mean`` without weights, through
    the ``moments_onepass`` kernel on a card); weights summing to zero
    raise ``ZeroDivisionError``. Across ranks: local partial sums, one
    ``allreduce``."""
    from . import factories

    if weights is None:
        result = mean(x, axis)
        if returned:
            n = x.size if axis is None else _count_over(x, sanitize_axis(x.shape, axis))
            return result, factories.full_like(result, float(n))
        return result
    x.balance_()  # the weights meet the ceil-div chunks
    axis_s = sanitize_axis(x.shape, axis)
    if isinstance(weights, DNDarray):
        wt = weights
    else:
        wt = factories.array(np.asarray(weights), device=x.device, comm=x.comm)
    wdt = types.promote_types(types.promote_types(x.dtype, wt.dtype), types.float32)
    tt = wdt.torch_type()
    if wt.ndim != x.ndim:
        if axis_s is None or isinstance(axis_s, tuple):
            raise TypeError("Axis must be specified when shapes of x and weights differ.")
        shape = [1] * x.ndim
        shape[axis_s] = -1
        w_whole = wt._logical().reshape(shape)
        w_loc = w_whole[x.comm.chunk(x.gshape, x.split)[2]] if x.split == axis_s and x.comm.is_distributed() else w_whole
    else:
        w_loc = _local_operand(wt, x.gshape, x.split)
    w_loc = torch.broadcast_to(w_loc.to(tt), x.lshape)
    wsum = _sum_over(w_loc, x, axis_s)
    if not isinstance(weights, DNDarray) and isinstance(axis_s, (int, type(None))):
        wnp = np.asarray(weights, dtype=np.float64).reshape(tuple(w_whole.shape) if wt.ndim != x.ndim else wt.gshape)
        if axis_s is None:
            zero = bool(wnp.sum() == 0)
        elif wnp.shape[axis_s] == x.gshape[axis_s]:
            zero = bool(np.any(wnp.sum(axis=axis_s) == 0))
        else:
            zero = bool(np.any(wnp == 0))
    else:
        # graftlint: G004 - a zero weight sum raises ZeroDivisionError, as in heat_tpu: one read a call
        zero = bool((wsum == 0).any())
    if zero:
        raise ZeroDivisionError("Weights sum to zero, can't be normalized")
    res_t = _sum_over(x.larray.to(tt) * w_loc, x, axis_s) / wsum
    res = _wrap_reduced(x, axis_s, res_t)
    if returned:
        return res, _wrap_reduced(x, axis_s, torch.broadcast_to(wsum, res_t.shape).clone())
    return res


def _central_moments(x: DNDarray, axis_s, powers):
    """n, and the central moments mean((x - mu)^p) for each p, along
    ``axis_s`` in ``x``'s float type (float32 for integers): two passes,
    each a local sum and an ``allreduce`` where the split axis is
    reduced."""
    t = x.larray.to(_inexact(x.larray.dtype))
    n = _count_over(x, axis_s)
    mu = _sum_over(t, x, axis_s, True) / n
    d = t - mu
    return n, [_sum_over(d ** p, x, axis_s) / n for p in powers]


def skew(x: DNDarray, axis=None, unbiased: bool = True) -> DNDarray:
    """The skewness along ``axis``; ``unbiased`` applies the Fisher-Pearson
    sample correction (in float64, as ``heat_tpu``'s ``np.sqrt`` factor)."""
    axis_s = sanitize_axis(x.shape, axis)
    n, (m2, m3) = _central_moments(x, axis_s, (2, 3))
    g1 = m3 / (m2 ** 1.5)
    if unbiased and n > 2:
        g1 = g1.double() * float(np.sqrt(n * (n - 1))) / (n - 2)
    return _wrap_reduced(x, axis_s, g1)


def kurtosis(x: DNDarray, axis=None, unbiased: bool = True, Fischer: bool = True) -> DNDarray:
    """The kurtosis along ``axis``; ``unbiased`` applies the sample-size
    correction, ``Fischer`` subtracts 3."""
    axis_s = sanitize_axis(x.shape, axis)
    n, (m2, m4) = _central_moments(x, axis_s, (2, 4))
    g2 = m4 / (m2 ** 2)
    if unbiased and n > 3:
        g2 = ((n - 1) / ((n - 2) * (n - 3))) * ((n + 1) * g2 - 3 * (n - 1)) + 3
    if Fischer:
        g2 = g2 - 3
    return _wrap_reduced(x, axis_s, g2)


def cov(m: DNDarray, y=None, rowvar: bool = True, bias: bool = False, ddof=None) -> DNDarray:
    """The covariance matrix of the variables (rows, or columns without
    ``rowvar``), split 0 where ``m`` is split. Across ranks the
    observations are split (a resplit where the variables were), the mean
    and the Gram matrix of the centred chunk are local sums, each followed
    by one ``allreduce``; the (V, V) result is never gathered."""
    if ddof is None:
        ddof = 0 if bias else 1

    def observations(a: DNDarray):
        """(this rank's observations x variables, the number of observations,
        whether the observations are split)."""
        if a.ndim == 1:
            return a.larray.reshape(-1, 1), a.gshape[0], a.split is not None
        if rowvar or a.gshape[0] == 1:
            # variables are rows: observations run along axis 1
            src = a.resplit(1) if a.split == 0 and a.comm.is_distributed() else a
            return src.larray.T, a.gshape[1], src.split == 1
        src = a.resplit(0) if a.split == 1 and a.comm.is_distributed() else a
        return src.larray, a.gshape[0], src.split == 0

    obs, n_obs, split_obs = observations(m)
    parts = [obs]
    if y is not None:
        y_obs, _, y_split = observations(y)
        if y_split != split_obs:
            raise ValueError("m and y must be split alike along the observations")
        parts.append(y_obs)
    x = torch.cat(parts, dim=1)
    x = x.to(_inexact(x.dtype))
    comm = m.comm
    distributed = split_obs and comm.is_distributed()
    s = x.sum(dim=0, keepdim=True)
    avg = (comm.allreduce(s) if distributed else s) / n_obs
    xc = x - avg
    g = xc.T @ xc
    g = comm.allreduce(g) if distributed else g
    result = (g / (n_obs - ddof)).squeeze()
    split = 0 if m.split is not None and result.ndim > 1 else None
    t = result[comm.chunk(tuple(result.shape), split)[2]] if split is not None else result
    return DNDarray(t, gshape=tuple(result.shape), dtype=types.canonical_heat_type(t.dtype), split=split,
                    device=m.device, comm=comm)


# --------------------------------------------------------------- histograms
def _linspace32(lo: torch.Tensor, hi: torch.Tensor, num: int, dtype: torch.dtype) -> torch.Tensor:
    """``jnp.linspace(lo, hi, num, dtype=dtype)`` (endpoint): ``lo·(1 - s) +
    hi·s`` with ``s = iota / (num - 1)``, every step in ``dtype``."""
    div = num - 1
    step = torch.arange(div, dtype=dtype, device=lo.device) / torch.tensor(div, dtype=dtype, device=lo.device)
    return torch.cat([lo * (1 - step) + hi * step, hi.reshape(1)])


def _minmax(x: DNDarray) -> Tuple[torch.Tensor, torch.Tensor]:
    return min(x).larray, max(x).larray


def _hist_counts(x: DNDarray, edges: torch.Tensor, weights=None) -> torch.Tensor:
    """``jnp.histogram``'s counts of this rank's chunk against ``edges``
    (right-closed last bin; values outside and NaN dropped), summed over
    the ranks by one ``allreduce``."""
    t = x.larray.reshape(-1).to(edges.dtype).contiguous()
    idx = torch.searchsorted(edges, t, right=True)
    idx = torch.where(t == edges[-1], torch.full_like(idx, edges.numel() - 1), idx)
    idx = torch.where(torch.isnan(t), torch.full_like(idx, edges.numel()), idx)
    w = torch.ones_like(t) if weights is None else _local_operand(weights, x.gshape, x.split).reshape(-1).to(edges.dtype)
    counts = torch.zeros(edges.numel() + 1, dtype=edges.dtype, device=t.device).index_add_(0, idx, w)[1:-1]
    if x.split is not None and x.comm.is_distributed():
        counts = x.comm.allreduce(counts)
    return counts


def histogram(a: DNDarray, bins: int = 10, range=None, normed=None, weights=None, density=None):
    """numpy's ``histogram`` (``jnp.histogram``): ``bins`` equal bins over
    ``range`` (default: the data's min and max; a range of width 0 widens
    by 0.5 either side), counts in the data's float type. Each rank counts
    its chunk; one ``allreduce`` adds the counts."""
    ft = _inexact(a.larray.dtype)
    if np.ndim(bins) == 1:
        edges = torch.as_tensor(np.asarray(bins), device=a.larray.device).to(ft)
    else:
        if range is None:
            lo, hi = (v.to(ft) for v in _minmax(a))
        else:
            lo, hi = (torch.tensor(v, device=a.larray.device).to(ft) for v in range)
        if bool(hi == lo):
            lo, hi = lo - 0.5, hi + 0.5
        edges = _linspace32(lo, hi, int(bins) + 1, ft)
    counts = _hist_counts(a, edges, weights)
    if density:
        counts = counts / torch.diff(edges) / counts.sum()
    return (DNDarray(counts, split=None, device=a.device, comm=a.comm),
            DNDarray(edges, split=None, device=a.device, comm=a.comm))


def histc(input: DNDarray, bins: int = 100, min: float = 0.0, max: float = 0.0, out=None) -> DNDarray:
    """torch's ``histc`` with ``heat_tpu``'s bin edges: ``jnp.histogram``
    over ``(min, max)``, or the data's extrema when both are 0, cast to the
    input's dtype."""
    lo, hi = float(min), float(max)
    if lo == 0.0 and hi == 0.0:
        lo, hi = (float(v) for v in _minmax(input))
    counts, _ = histogram(input, bins=bins, range=(lo, hi))
    res = DNDarray(counts.larray.to(input.dtype.torch_type()), dtype=input.dtype, split=None, device=input.device,
                   comm=input.comm)
    return _write_out(out, res) if out is not None else res


def bincount(x: DNDarray, weights=None, minlength: int = 0) -> DNDarray:
    """The number of occurrences (or summed weights) of each value of a
    non-negative integer array, replicated: the global maximum by one
    ``allreduce``, each rank's counts, one ``allreduce`` of them."""
    t = x.larray.reshape(-1).to(torch.int64)
    top = t.max() if t.numel() else torch.tensor(-1, device=t.device)
    if x.split is not None and x.comm.is_distributed():
        top = x.comm.allreduce(top.reshape(1), "max").reshape(())
    length = builtins.max(int(top) + 1, int(minlength))
    w = None
    if weights is not None:
        w = (weights if isinstance(weights, DNDarray) else factories.array(weights, device=x.device, comm=x.comm))
        w = _local_operand(w, x.gshape, x.split).reshape(-1)
    counts = torch.bincount(t, weights=w, minlength=length)
    if w is not None:
        counts = counts.to(types.promote_types(types.canonical_heat_type(w.dtype), types.float32).torch_type())
    if x.split is not None and x.comm.is_distributed():
        counts = x.comm.allreduce(counts)
    return DNDarray(counts, split=None, device=x.device, comm=x.comm)


def bucketize(input: DNDarray, boundaries, out_int32: bool = False, right: bool = False, out=None) -> DNDarray:
    """torch's ``bucketize``: the index of each value's bucket among the
    sorted ``boundaries`` (the first ``b[i] >= x``, or ``> x`` with
    ``right``); elementwise on each rank's chunk."""
    b = boundaries._logical() if isinstance(boundaries, DNDarray) else torch.as_tensor(np.asarray(boundaries))
    t = input.larray
    b = b.to(device=t.device, dtype=torch.promote_types(b.dtype, t.dtype))
    idx_type = types.int32 if out_int32 else types.int64
    r = torch.searchsorted(b, t.to(b.dtype).contiguous(), right=right).to(idx_type.torch_type())
    res = DNDarray(r, gshape=input.gshape, dtype=idx_type, split=input.split, device=input.device, comm=input.comm)
    return _write_out(out, res) if out is not None else res


def digitize(x: DNDarray, bins, right: bool = False) -> DNDarray:
    """numpy's ``digitize``: the index of the bin of each value (increasing
    or decreasing ``bins``); elementwise on each rank's chunk."""
    b = bins._logical() if isinstance(bins, DNDarray) else torch.as_tensor(np.asarray(bins))
    t = x.larray
    b = b.to(device=t.device, dtype=torch.promote_types(b.dtype, t.dtype))
    tv = t.to(b.dtype).contiguous()
    if b.numel() > 1 and bool(b[-1] < b[0]):
        r = b.numel() - torch.searchsorted(torch.flip(b, (0,)), tv, right=not right)
    else:
        r = torch.searchsorted(b, tv, right=not right)
    return DNDarray(r.to(torch.int64), gshape=x.gshape, dtype=types.int64, split=x.split, device=x.device, comm=x.comm)
