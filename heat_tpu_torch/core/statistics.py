"""Statistics: ``mean``, ``var`` and ``std`` (counterpart of
``heat_tpu/core/statistics.py:319-332, 540-760``).

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
"""
from __future__ import annotations

import weakref

import torch

from . import types
from ._operations import _reduced_shape, _reduced_split
from .dndarray import DNDarray
from .kernels import MOMENTS_KERNEL, chunk_moments, dispatch_mode, moments_local, record_dispatch
from .stride_tricks import sanitize_axis

__all__ = ["mean", "std", "var"]

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
        result.reshape(out_shape),
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
        wt = where.larray if isinstance(where, DNDarray) else torch.as_tensor(where, device=t.device)
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
    return axis_s, stats


def mean(x: DNDarray, axis=None, where=None) -> DNDarray:
    """Arithmetic mean along ``axis``. A following ``std``/``var`` on the
    same tensor reuses the memoized moments and reads no data."""
    axis_s, (_, m, _) = _moments(x, axis, where)
    return _wrap_moment(x, axis_s, m)


def var(x: DNDarray, axis=None, ddof: int = 0, where=None) -> DNDarray:
    """Variance along ``axis`` with ``ddof`` delta degrees of freedom."""
    axis_s, (c, _, m2) = _moments(x, axis, where)
    return _wrap_moment(x, axis_s, m2 / (c - ddof))


def std(x: DNDarray, axis=None, ddof: int = 0, where=None) -> DNDarray:
    """Standard deviation along ``axis`` with ``ddof`` delta degrees of freedom."""
    axis_s, (c, _, m2) = _moments(x, axis, where)
    return _wrap_moment(x, axis_s, torch.sqrt(m2 / (c - ddof)))
