"""Statistics: ``mean``, ``var`` and ``std``, and the extrema ``min``/
``max``/``argmin``/``argmax``/``minimum``/``maximum``/``nanmin``/``nanmax``
(counterpart of ``heat_tpu/core/statistics.py:62-112, 280-345, 400-410,
540-760``).

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
- integer inputs, >2-D inputs and tuple axes reduce directly.

The memo key is the tensor's identity *and* its ``_version``: torch
tensors are mutable, so an in-place update (``x.larray.add_(1)``) bumps the
version and the next call recomputes instead of serving stale moments.

Across ranks each rank computes its chunk's moments (a rank with an empty
chunk contributes (0, 0, 0) and launches nothing), and
:func:`kernels.moments_sharded` combines them by Chan's formulas. The
extrema reduce as every ``_reduce_op`` does; ``argmin``/``argmax`` over
the split axis gather each rank's best value and its global index and keep
the lowest index among the best.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

from . import factories, types
from ._operations import _binary_op, _local_operand, _over_axes, _reduce_op, _reduced_shape, _reduced_split, _write_out
from .dndarray import DNDarray
from .kernels import MOMENTS_KERNEL, chunk_moments, dispatch_mode, moments_local, moments_sharded, record_dispatch
from .stride_tricks import sanitize_axis

__all__ = [
    "argmax",
    "argmin",
    "max",
    "maximum",
    "mean",
    "min",
    "minimum",
    "nanmax",
    "nanmin",
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
    or None when the panel declines (int dtypes, >2-D, tuple axes, empty)."""
    if x.ndim not in (1, 2) or 0 in tuple(x.gshape):
        return None
    if axis_s is not None and not isinstance(axis_s, int):
        return None
    arr = x.larray
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
    out_shape = _reduced_shape(x.gshape, axis_s, False)
    return DNDarray(
        result.reshape(_reduced_shape(x.lshape, axis_s, False)),
        gshape=out_shape,
        dtype=types.canonical_heat_type(result.dtype),
        split=_reduced_split(x.split, axis_s, x.ndim, False),
        device=x.device,
        comm=x.comm,
    )


def _direct_moments(x: DNDarray, axis_s, where=None):
    """(count, mean, M2) by a direct two-pass reduction over the logical
    tensor, with an optional boolean ``where`` mask broadcast to ``x``."""
    t = x.larray.to(_float_type(x.larray))
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
    stats = None if where is not None else _moments_panel(x, axis_s)
    if stats is None:
        # where= masks cannot key the memo: they decline to a direct reduction
        stats = _direct_moments(x, axis_s, where)
    axes = range(x.ndim) if axis_s is None else ((axis_s,) if isinstance(axis_s, int) else axis_s)
    if x.split is not None and x.split in axes and x.comm.is_distributed():
        stats = moments_sharded(*stats, x.comm)
    return axis_s, stats


def mean(x: DNDarray, axis=None, where=None) -> DNDarray:
    """Arithmetic mean along ``axis``. A following ``std``/``var`` on the
    same tensor reuses the memoized moments and reads no data."""
    axis_s, (_, m, _) = _moments(x, axis, where)
    return _wrap_moment(x, axis_s, m)


def var(x: DNDarray, axis=None, ddof: int = 0, where=None) -> DNDarray:
    """Variance along ``axis`` with ``ddof`` delta degrees of freedom."""
    axis_s, (c, _, m2) = _moments(x, axis, where)
    return _wrap_moment(x, axis_s, (m2 / (c - ddof)).to(m2.dtype))


def std(x: DNDarray, axis=None, ddof: int = 0, where=None) -> DNDarray:
    """Standard deviation along ``axis`` with ``ddof`` delta degrees of freedom."""
    axis_s, (c, _, m2) = _moments(x, axis, where)
    return _wrap_moment(x, axis_s, torch.sqrt(m2 / (c - ddof)).to(m2.dtype))


# ----------------------------------------------------------------- extrema
def _max(t: torch.Tensor, axis, keepdims: bool) -> torch.Tensor:
    return _over_axes(torch.amax, t, axis, keepdims)


def _min(t: torch.Tensor, axis, keepdims: bool) -> torch.Tensor:
    return _over_axes(torch.amin, t, axis, keepdims)


def _nan_skipping(reduce, fill: float):
    """``reduce`` with NaN replaced by ``fill`` (the reduction's identity);
    NaN again where every element of a slice was NaN."""

    def run(t: torch.Tensor, axis, keepdims: bool) -> torch.Tensor:
        if not t.is_floating_point():
            return reduce(t, axis, keepdims)
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


def maximum(x1, x2, out=None) -> DNDarray:
    """Elementwise maximum; NaN wins."""
    return _binary_op(torch.maximum, x1, x2, out=out)


def minimum(x1, x2, out=None) -> DNDarray:
    """Elementwise minimum; NaN wins."""
    return _binary_op(torch.minimum, x1, x2, out=out)


def _arg_reduce(op, x: DNDarray, axis, out) -> DNDarray:
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
    axis = sanitize_axis(x.shape, axis)
    if axis is not None and not isinstance(axis, int):
        raise TypeError(f"axis must be None or an int, got {axis}")
    arr = x.larray
    if arr.dtype == torch.bool:
        arr = arr.to(torch.uint8)
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
