"""Shape and data manipulations (counterpart of ``heat_tpu/core/manipulations.py``).

Results follow ``heat_tpu``'s values, dtypes and split rules, and every
result is in the ceil-div layout. Across ranks the data moves as little
as the operation needs:

- along a non-split axis (``flip``, ``roll``, ``pad``, ``unfold``,
  ``concatenate``, ``sort``, ``topk``, ``squeeze``, ``expand_dims``, the
  axis permutations) each rank works on its own chunk;
- along the split axis, ``flip``, ``roll``, ``pad``, ``unfold`` and
  ``concatenate`` fetch exactly the rows each rank's result chunk needs
  (:mod:`._movement`, one ``alltoall``), and ``reshape`` redistributes by
  global flat offsets (one ``alltoall`` from split 0 to split 0);
- ``sort``, ``topk`` and ``unique`` along the split axis run the
  algorithms of :mod:`heat_tpu_torch.parallel` (sample sort, P·k
  candidates, per-rank candidates);
- ``diag``/``diagonal``, ``repeat`` and ``tile`` gather the array, as
  ``heat_tpu`` does, and keep this rank's chunk of the result.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import types
from ._movement import take_intervals, take_rows
from .dndarray import DNDarray
from .stride_tricks import broadcast_shapes, sanitize_axis, sanitize_shape

__all__ = [
    "balance",
    "broadcast_arrays",
    "broadcast_to",
    "column_stack",
    "concatenate",
    "diag",
    "diagonal",
    "dsplit",
    "expand_dims",
    "flatten",
    "flip",
    "fliplr",
    "flipud",
    "hsplit",
    "hstack",
    "moveaxis",
    "pad",
    "ravel",
    "redistribute",
    "repeat",
    "reshape",
    "resplit",
    "roll",
    "rot90",
    "row_stack",
    "shape",
    "sort",
    "split",
    "squeeze",
    "stack",
    "swapaxes",
    "tile",
    "topk",
    "unfold",
    "unique",
    "vsplit",
    "vstack",
]


def _as_dnd(a) -> DNDarray:
    from . import factories

    return a if isinstance(a, DNDarray) else factories.array(a)


def _whole(result: torch.Tensor, like: DNDarray, split: Optional[int], dtype=None) -> DNDarray:
    """A result every rank computed whole, as a DNDarray holding this rank's
    chunk of it along ``split``."""
    comm = like.comm
    split = None if result.ndim == 0 else split
    t = result[comm.chunk(tuple(result.shape), split)[2]] if split is not None else result
    dtype = types.canonical_heat_type(result.dtype) if dtype is None else dtype
    return DNDarray(t, gshape=tuple(result.shape), dtype=dtype, split=split, device=like.device, comm=comm)


def _local(t: torch.Tensor, like: DNDarray, gshape, split, dtype=None) -> DNDarray:
    """A DNDarray from this rank's chunk ``t`` of a result of ``gshape``."""
    dtype = like.dtype if dtype is None else dtype
    return DNDarray(t, gshape=tuple(gshape), dtype=dtype, split=split, device=like.device, comm=like.comm)


def _along_split(a: DNDarray, axis: int) -> bool:
    return a.split == axis and a.comm.is_distributed()


def _write(out: DNDarray, res: DNDarray) -> DNDarray:
    from ._operations import _write_out

    return _write_out(out, res)


# ------------------------------------------------------------------ layout
def balance(array: DNDarray, copy: bool = False) -> DNDarray:
    """``array`` rebalanced into the ceil-div layout in place (a ragged
    array moves once; a balanced one is left as it is), or a copy of it,
    rebalanced, with ``copy``."""
    out = array.copy() if copy else array
    return out.balance_()


def redistribute(arr: DNDarray, lshape_map=None, target_map=None) -> DNDarray:
    """A copy of ``arr`` moved into the layout ``target_map``
    (:meth:`DNDarray.redistribute_`); ``arr`` keeps its own."""
    out = arr.copy()
    return out.redistribute_(lshape_map=lshape_map, target_map=target_map)


def resplit(arr: DNDarray, axis: Optional[int] = None) -> DNDarray:
    """A copy of ``arr`` split along ``axis``."""
    return arr.resplit(axis)


def shape(a: DNDarray) -> Tuple[int, ...]:
    """The global shape of ``a``."""
    return a.shape


# --------------------------------------------------------------- broadcast
def broadcast_to(x: DNDarray, shape) -> DNDarray:
    """``x`` broadcast to ``shape``; the split axis moves with its dimension."""
    shape = sanitize_shape(shape)
    broadcast_shapes(x.shape, shape)
    if len(shape) < x.ndim or tuple(np.broadcast_shapes(x.shape, shape)) != shape:
        raise ValueError(f"cannot broadcast an array of shape {x.shape} to {shape}")
    split = x.split + (len(shape) - x.ndim) if x.split is not None else None
    if split is not None and x.comm.is_distributed() and x.gshape[x.split] != shape[split]:
        return _whole(torch.broadcast_to(x._logical(), shape), x, split, x.dtype)
    lshape = x.comm.chunk(shape, split)[1]
    return _local(torch.broadcast_to(x.larray, lshape), x, shape, split)


def broadcast_arrays(*arrays: DNDarray) -> List[DNDarray]:
    """The arrays broadcast against each other."""
    target = broadcast_shapes(*[a.shape for a in arrays])
    return [broadcast_to(a, target) for a in arrays]


# ----------------------------------------------------------------- reshape
def reshape(a: DNDarray, *shape, new_split: Optional[int] = None, **kwargs) -> DNDarray:
    """``a`` with a new shape (C order). The result's split is ``new_split``,
    by default ``a``'s where the new shape has that axis, else 0 (None for
    a replicated ``a``). A split-0 array reshapes into a split-0 array by
    one ``alltoall`` of the rows each rank's chunk needs (flat offsets);
    another split goes through split 0 (``resplit``)."""
    if not isinstance(a, DNDarray):
        raise TypeError(f"'a' must be a DNDarray, currently {type(a)}")
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        shape = tuple(shape[0])
    shape = list(shape)
    neg = [i for i, s in enumerate(shape) if s == -1]
    if len(neg) > 1:
        raise ValueError("can only specify one unknown dimension")
    if neg:
        known = int(np.prod([s for s in shape if s != -1])) or 1
        shape[neg[0]] = a.size // known
    shape = sanitize_shape(shape)
    if int(np.prod(shape)) != a.size:
        raise ValueError(f"cannot reshape array of size {a.size} into shape {tuple(shape)}")
    if new_split is None:
        new_split = a.split if a.split is not None and a.split < len(shape) else (0 if a.split is not None else None)
    new_split = sanitize_axis(shape, new_split) if len(shape) else None
    comm = a.comm
    if a.split is None or not comm.is_distributed():
        t = a.larray.reshape(shape)
        if new_split is not None and comm.is_distributed():
            t = t[comm.chunk(shape, new_split)[2]]
        return _local(t, a, shape, new_split)
    if new_split is None or len(shape) == 0 or a.ndim == 0:
        return _local(a._logical().reshape(shape), a, shape, None)
    from ._movement import reshape_rows

    src = a if a.split == 0 else a.resplit(0)
    res = _local(reshape_rows(src.larray, src.gshape, shape, comm), a, shape, 0)
    return res if new_split == 0 else res.resplit_(new_split)


def flatten(a: DNDarray) -> DNDarray:
    """``a`` as a 1-D array (split 0 where ``a`` is split)."""
    return reshape(a, (a.size,))


def ravel(a: DNDarray) -> DNDarray:
    """``a`` as a 1-D array; the same as :func:`flatten`."""
    return flatten(a)


def expand_dims(a: DNDarray, axis: int) -> DNDarray:
    """A new axis of extent 1 at ``axis``."""
    axis = sanitize_axis(a.shape + (1,), axis)
    split = a.split
    if split is not None and axis <= split:
        split += 1
    gshape = a.gshape[:axis] + (1,) + a.gshape[axis:]
    return _local(a.larray.unsqueeze(axis), a, gshape, split)


def squeeze(x: DNDarray, axis=None) -> DNDarray:
    """``x`` without its axes of extent 1 (``axis``: only those, each of
    which must have extent 1). Squeezing the split axis replicates."""
    if axis is not None:
        axis = sanitize_axis(x.shape, axis)
        axes = (axis,) if isinstance(axis, int) else axis
        for ax in axes:
            if x.shape[ax] != 1:
                raise ValueError(f"cannot select an axis to squeeze out which has size not equal to one, got axis {ax}")
    else:
        axes = tuple(i for i, s in enumerate(x.shape) if s == 1)
    gshape = tuple(s for i, s in enumerate(x.gshape) if i not in axes)
    split = x.split
    if split is not None and split in axes:
        return _local(x._logical().reshape(gshape), x, gshape, None)
    if split is not None:
        split -= sum(1 for ax in axes if ax < split)
    t = x.larray.squeeze(tuple(axes)) if axes else x.larray
    return _local(t, x, gshape, split)


def moveaxis(x: DNDarray, source, destination) -> DNDarray:
    """``x`` with the axes ``source`` moved to ``destination``."""
    from .linalg import transpose

    if isinstance(source, (int, np.integer)):
        source = (source,)
    if isinstance(destination, (int, np.integer)):
        destination = (destination,)
    source = [sanitize_axis(x.shape, int(s)) for s in source]
    destination = [sanitize_axis(x.shape, int(d)) for d in destination]
    if len(source) != len(destination):
        raise ValueError("source and destination arguments must have the same number of elements")
    order = [n for n in range(x.ndim) if n not in source]
    for dest, src in sorted(zip(destination, source)):
        order.insert(dest, src)
    return transpose(x, order)


def swapaxes(x: DNDarray, axis1: int, axis2: int) -> DNDarray:
    """``x`` with two axes swapped."""
    from .linalg import transpose

    order = list(range(x.ndim))
    axis1 = sanitize_axis(x.shape, axis1)
    axis2 = sanitize_axis(x.shape, axis2)
    order[axis1], order[axis2] = order[axis2], order[axis1]
    return transpose(x, order)


# ------------------------------------------------------------ concatenation
def concatenate(arrays: Sequence[DNDarray], axis: int = 0) -> DNDarray:
    """The arrays joined along ``axis`` (their dtypes promoted). The split
    operands must share one split axis, which the result keeps. Along the
    split axis each rank fetches the rows of its result chunk from the
    operands' owners (one ``alltoall`` per split operand); along another
    axis every rank joins its chunks."""
    if len(arrays) < 2:
        if len(arrays) == 1:
            return arrays[0]
        raise ValueError("concatenate requires at least one array")
    for a in arrays:
        if not isinstance(a, DNDarray):
            raise TypeError(f"all inputs must be DNDarrays, found {type(a)}")
    axis = sanitize_axis(arrays[0].shape, axis)
    first = arrays[0].shape
    for a in arrays[1:]:
        if a.ndim != len(first) or any(d != axis and a.shape[d] != first[d] for d in range(a.ndim)):
            raise ValueError(f"all input array dimensions except axis {axis} must match exactly: {first} vs {a.shape}")
    splits = {a.split for a in arrays if a.split is not None}
    if len(splits) > 1:
        raise RuntimeError(f"DNDarrays given have differing split axes, found {splits}")
    out_split = splits.pop() if splits else None
    promoted = arrays[0].dtype
    for a in arrays[1:]:
        promoted = types.promote_types(promoted, a.dtype)
    tt = promoted.torch_type()
    out_shape = list(first)
    out_shape[axis] = sum(a.shape[axis] for a in arrays)
    like, comm = arrays[0], arrays[0].comm
    if out_split is None or not comm.is_distributed():
        t = torch.cat([a.larray.to(tt) for a in arrays], dim=axis)
        return _local(t, like, out_shape, out_split, promoted)
    if axis != out_split:
        parts = [a.larray if a.split is not None else a.larray[comm.chunk(a.gshape, out_split)[2]] for a in arrays]
        return _local(torch.cat([p.to(tt) for p in parts], dim=axis), like, out_shape, out_split, promoted)
    lo, lshape, _ = comm.chunk(out_shape, axis)
    pieces, o = [], 0
    for a in arrays:
        n_a = a.gshape[axis]

        def want(r, o=o, n_a=n_a):
            r_lo, r_sh, _ = comm.chunk(out_shape, axis, rank=r)
            b, e = max(r_lo, o), min(r_lo + r_sh[axis], o + n_a)
            return [(b - o, e - o)] if e > b else []

        if a.split is None:
            got = [a.larray.narrow(axis, b, e - b) for b, e in want(comm.rank)]
        else:
            got = take_intervals(a.larray, a.gshape, axis, want, comm)
        pieces += [g.to(tt) for g in got]
        o += n_a
    empty = torch.empty(lshape, dtype=tt, device=like.larray.device)
    return _local(torch.cat(pieces, dim=axis) if pieces else empty, like, out_shape, axis, promoted)


def hstack(arrays: Sequence[DNDarray]) -> DNDarray:
    """The arrays joined along axis 1 (axis 0 for 1-D arrays)."""
    dnd = [_as_dnd(a) for a in arrays]
    return concatenate(dnd, axis=0 if dnd[0].ndim == 1 else 1)


def vstack(arrays: Sequence[DNDarray]) -> DNDarray:
    """The arrays joined along axis 0, 1-D arrays as rows."""
    dnd = [_as_dnd(a) for a in arrays]
    dnd = [a if a.ndim > 1 else reshape(a, (1, a.shape[0])) for a in dnd]
    return concatenate(dnd, axis=0)


row_stack = vstack


def column_stack(arrays: Sequence[DNDarray]) -> DNDarray:
    """1-D arrays as columns, with the 2-D arrays, joined along axis 1;
    split as the first split 2-D operand, else 0 where any is split."""
    dnd = [_as_dnd(a) for a in arrays]
    split = next((a.split for a in dnd if a.split is not None and a.ndim > 1), None)
    if split is None and any(a.split is not None for a in dnd):
        split = 0
    cols = [a if a.ndim > 1 else reshape(a, (a.shape[0], 1)) for a in dnd]
    if {c.split for c in cols if c.split is not None} <= {split}:
        return concatenate(cols, axis=1)
    t = torch.cat([c._logical().to(types.result_type(*dnd).torch_type()) for c in cols], dim=1)
    return _whole(t, dnd[0], split)


def stack(arrays: Sequence[DNDarray], axis: int = 0, out=None) -> DNDarray:
    """The arrays (of one shape) joined along a new axis ``axis``."""
    dnd = [_as_dnd(a) for a in arrays]
    if len({a.shape for a in dnd}) != 1:
        raise ValueError(f"all input arrays must have the same shape, got {[a.shape for a in dnd]}")
    axis_n = sanitize_axis(dnd[0].shape + (1,), axis)
    res = concatenate([expand_dims(a, axis_n) for a in dnd], axis=axis_n) if len(dnd) > 1 else expand_dims(dnd[0], axis_n)
    return _write(out, res) if out is not None else res


def _split_bounds(n: int, indices_or_sections) -> List[Tuple[int, int]]:
    if isinstance(indices_or_sections, DNDarray):
        indices_or_sections = indices_or_sections.tolist()
    if isinstance(indices_or_sections, (list, tuple, np.ndarray, torch.Tensor)):
        cuts = [int(i) for i in np.asarray(indices_or_sections, dtype=np.int64).reshape(-1)]
        edges = [0] + cuts + [n]
        return [slice(edges[i], edges[i + 1]).indices(n)[:2] for i in range(len(edges) - 1)]
    sections = int(indices_or_sections)
    if sections <= 0:
        raise ValueError("number sections must be larger than 0.")
    if n % sections:
        raise ValueError("array split does not result in an equal division")
    step = n // sections
    return [(i * step, (i + 1) * step) for i in range(sections)]


def split(x: DNDarray, indices_or_sections, axis: int = 0) -> List[DNDarray]:
    """``x`` cut along ``axis`` into equal sections or at the given
    indices; each part keeps ``x``'s split (a slice of the split axis
    rebalances it)."""
    axis = sanitize_axis(x.shape, axis)
    parts = []
    for b, e in _split_bounds(x.shape[axis], indices_or_sections):
        key = (slice(None),) * axis + (slice(b, max(b, e)),)
        parts.append(x[key])
    return parts


def hsplit(x: DNDarray, indices_or_sections) -> List[DNDarray]:
    """:func:`split` along axis 1 (axis 0 for 1-D arrays)."""
    return split(x, indices_or_sections, 0 if x.ndim < 2 else 1)


def vsplit(x: DNDarray, indices_or_sections) -> List[DNDarray]:
    """:func:`split` along axis 0."""
    return split(x, indices_or_sections, 0)


def dsplit(x: DNDarray, indices_or_sections) -> List[DNDarray]:
    """:func:`split` along axis 2."""
    return split(x, indices_or_sections, axis=2)


# -------------------------------------------------------- reorder elements
def flip(a: DNDarray, axis=None) -> DNDarray:
    """``a`` with the order of its elements along ``axis`` (all axes when
    None) reversed. Along the split axis each rank fetches the mirror image
    of its chunk's rows."""
    axes = tuple(range(a.ndim)) if axis is None else sanitize_axis(a.shape, axis)
    axes = (axes,) if isinstance(axes, int) else tuple(axes)
    t = a.larray
    local = [ax for ax in axes if not _along_split(a, ax)]
    if local:
        t = torch.flip(t, local)
    if len(local) != len(axes):
        ax, comm, n = a.split, a.comm, a.gshape[a.split]

        def want(r):
            lo, sh, _ = comm.chunk(a.gshape, ax, rank=r)
            return [(n - lo - sh[ax], n - lo)]

        t = torch.flip(take_intervals(t, a.gshape, ax, want, comm)[0], (ax,))
    return _local(t, a, a.gshape, a.split)


def fliplr(a: DNDarray) -> DNDarray:
    """:func:`flip` along axis 1."""
    return flip(a, 1)


def flipud(a: DNDarray) -> DNDarray:
    """:func:`flip` along axis 0."""
    return flip(a, 0)


def roll(x: DNDarray, shift, axis=None) -> DNDarray:
    """``x`` shifted circularly by ``shift`` along ``axis`` (the flattened
    array when None). Along the split axis each rank fetches the (at most
    two) source intervals of its chunk."""
    if axis is None:
        total = int(np.sum(np.asarray(shift, dtype=np.int64)))
        return reshape(roll(flatten(x), total, 0), x.gshape, new_split=x.split)
    shifts = np.broadcast_arrays(np.asarray(shift, dtype=np.int64), np.asarray(axis, dtype=np.int64))
    per_axis = {}
    for s, ax in zip(shifts[0].reshape(-1).tolist(), shifts[1].reshape(-1).tolist()):
        ax = sanitize_axis(x.shape, int(ax))
        per_axis[ax] = per_axis.get(ax, 0) + int(s)
    t = x.larray
    for ax, s in per_axis.items():
        n = x.gshape[ax]
        if n == 0:
            continue
        s %= n
        if not _along_split(x, ax):
            t = torch.roll(t, s, ax)
            continue
        comm = x.comm

        def want(r, ax=ax, s=s, n=n):
            lo, sh, _ = comm.chunk(x.gshape, ax, rank=r)
            j0, m = (lo - s) % n, sh[ax]
            return [(j0, j0 + m)] if j0 + m <= n else [(j0, n), (0, j0 + m - n)]

        got = take_intervals(t, x.gshape, ax, want, comm)  # every rank joins the exchange, an empty chunk too
        t = torch.cat(got, dim=ax) if got else t
    return _local(t, x, x.gshape, x.split)


def rot90(m: DNDarray, k: int = 1, axes=(0, 1)) -> DNDarray:
    """``m`` rotated by 90 degrees ``k`` times in the plane of ``axes``
    (from the first axis towards the second): flips and a transpose."""
    from .linalg import transpose

    axes = tuple(axes)
    if len(axes) != 2:
        raise ValueError("len(axes) must be 2.")
    a0, a1 = sanitize_axis(m.shape, axes[0]), sanitize_axis(m.shape, axes[1])
    if a0 == a1:
        raise ValueError("Axes must be different.")
    k %= 4
    if k == 0:
        return m.copy()
    if k == 2:
        return flip(flip(m, a0), a1)
    order = list(range(m.ndim))
    order[a0], order[a1] = order[a1], order[a0]
    if k == 1:
        return transpose(flip(m, a1), order)
    return flip(transpose(m, order), a1)


def _pad_map(i: np.ndarray, n: int, before: int, mode: str) -> np.ndarray:
    """The source index along one axis of each padded index ``i`` (numpy's
    modes)."""
    j = i - before
    if mode == "edge":
        return np.clip(j, 0, n - 1)
    if mode == "wrap":
        return j % n
    if mode == "reflect":
        if n == 1:
            return np.zeros_like(j)
        j = j % (2 * (n - 1))
        return np.where(j < n, j, 2 * (n - 1) - j)
    if mode == "symmetric":
        j = j % (2 * n)
        return np.where(j < n, j, 2 * n - 1 - j)
    raise NotImplementedError(f"pad mode {mode!r} is not supported")


def _data_rows(comm, out_shape, ax: int, b: int, n: int):
    """For a pad of ``b`` rows before ``n`` data rows along ``ax``: the data
    rows (in the input's coordinates) of each rank's result chunk."""

    def want(r):
        lo, sh, _ = comm.chunk(out_shape, ax, rank=r)
        s, f = max(lo, b), min(lo + sh[ax], b + n)
        return [(s - b, f - b)] if f > s else []

    return want


_FILL_MODES = ("linear_ramp", "maximum", "mean", "median", "minimum", "empty")


def _axis_stat(t: torch.Tensor, gshape, split, ax: int, mode: str, like: DNDarray) -> torch.Tensor:
    """numpy's pad statistic of ``t`` (this rank's chunk of an array of
    ``gshape``) along the whole axis ``ax``, with ``ax`` kept as one row:
    locally off the split axis; along it from the ranks' partial results
    (one ``allgather``), and the port's exact ``median``. Integer results
    round half to even, as numpy's ``np.around``."""
    from . import arithmetics, statistics

    if mode == "median" and t.is_complex():
        raise ValueError("pad mode 'median' does not support complex input: complex numbers have no order")
    if mode == "mean" and not (t.is_floating_point() or t.is_complex()) or mode == "median":
        work = t.to(torch.float64)
    elif t.dtype in (torch.float16, torch.bfloat16):
        work = t.to(torch.float32)  # jnp's mean and median of half types accumulate in float32
    else:
        work = t
    if split == ax and like.comm.is_distributed():
        d = DNDarray(work, gshape=gshape, split=split, device=like.device, comm=like.comm)
        if mode == "mean":
            stat = arithmetics.sum(d, axis=ax, keepdims=True).larray / gshape[ax]
        else:
            fn = {"maximum": statistics.max, "minimum": statistics.min, "median": statistics.median}[mode]
            stat = fn(d, axis=ax, keepdims=True).larray
    elif mode == "mean":
        stat = work.sum(dim=ax, keepdim=True) / gshape[ax]
    elif mode == "median":
        shape = list(work.shape)
        shape[ax] = 1
        # an empty chunk (a rank past the end of the split axis) has no median to take: its rows are none
        stat = torch.quantile(work, 0.5, dim=ax, keepdim=True) if work.numel() else work.new_zeros(shape)
    else:
        stat = (statistics._max if mode == "maximum" else statistics._min)(work, ax, True)
    if not (t.is_floating_point() or t.is_complex()) and mode in ("mean", "median"):
        stat = torch.round(stat)
    return stat.to(t.dtype)


def _ramp(edge: torch.Tensor, ax: int, width: int, rising: bool) -> torch.Tensor:
    """numpy's linear ramp of ``width`` rows along ``ax`` between 0 and the
    edge row: ``edge * k / width`` for k = 0 .. width - 1 (rising, before
    the data) or k = width - 1 .. 0 (after it), floored for integers."""
    wide = torch.complex128 if edge.is_complex() else torch.float64
    k = torch.arange(width, dtype=torch.float64, device=edge.device)
    if not rising:
        k = k.flip(0)
    shape = [1] * edge.ndim
    shape[ax] = width
    out = edge.to(wide) * (k / width).reshape(shape)
    if not (edge.is_floating_point() or edge.is_complex()):
        out = torch.floor(out)
    return out.to(edge.dtype)


def _fill_blocks(t: torch.Tensor, gshape, split, ax: int, b: int, e: int, mode: str, like: DNDarray):
    """The ``b`` rows before and the ``e`` rows after the data along ``ax``
    for one of :data:`_FILL_MODES`, whole along ``ax``."""
    shape_b, shape_e = list(t.shape), list(t.shape)
    shape_b[ax], shape_e[ax] = b, e
    if mode == "empty":
        return t.new_zeros(shape_b), t.new_zeros(shape_e)
    if mode == "linear_ramp":
        n = gshape[ax]
        if split == ax and like.comm.is_distributed():
            edges = take_rows(t, gshape, ax, lambda r: np.array([0, n - 1]), like.comm)
        else:
            edges = t.index_select(ax, torch.tensor([0, n - 1], device=t.device))
        first, last = edges.narrow(ax, 0, 1), edges.narrow(ax, 1, 1)
        return _ramp(first, ax, b, True), _ramp(last, ax, e, False)
    stat = _axis_stat(t, gshape, split, ax, mode, like)
    return stat.expand(shape_b), stat.expand(shape_e)


def pad(array: DNDarray, pad_width, mode: str = "constant", constant_values=0) -> DNDarray:
    """``array`` padded by ``pad_width`` (numpy's forms; a flat pair pads
    the last axis) with ``constant_values``, by the ``edge``, ``wrap``,
    ``reflect`` or ``symmetric`` rule, or with numpy's ``linear_ramp``
    (to 0), ``maximum``, ``mean``, ``median`` or ``minimum`` of the whole
    axis, or ``empty`` (zeros, as jnp gives). Axes pad in order, as numpy
    pads them. Along the split axis each rank fetches the rows its result
    chunk reads; the statistics come from the ranks' partial results and
    the ramps from the two edge rows."""
    if isinstance(pad_width, (int, np.integer)):
        np_pad = [(int(pad_width), int(pad_width))] * array.ndim
    else:
        pw = list(pad_width)
        if len(pw) and isinstance(pw[0], (int, np.integer)):
            if len(pw) != 2:
                raise ValueError("pad_width as flat sequence must have length 2")
            np_pad = [(0, 0)] * (array.ndim - 1) + [tuple(pw)]
        else:
            np_pad = [tuple(p) for p in pw]
            if len(np_pad) < array.ndim:
                np_pad = [(0, 0)] * (array.ndim - len(np_pad)) + np_pad
    np_pad = [tuple(int(v) for v in p) for p in np_pad]
    if len(np_pad) == 1 and array.ndim > 1:
        np_pad = np_pad * array.ndim
    out_shape = tuple(n + b + e for n, (b, e) in zip(array.gshape, np_pad))
    comm, split = array.comm, array.split
    if mode == "constant" and not np.isscalar(constant_values):
        # per-axis constants: numpy pads axis by axis, so the corners take the later axes' values
        cv = np.broadcast_to(np.asarray(constant_values), (array.ndim, 2))
        t = array._logical()
        for ax, (b, e) in enumerate(np_pad):
            shape_b = list(t.shape)
            shape_b[ax] = b
            shape_e = list(t.shape)
            shape_e[ax] = e
            t = torch.cat([torch.full(shape_b, float(cv[ax, 0]), dtype=t.dtype, device=t.device), t,
                           torch.full(shape_e, float(cv[ax, 1]), dtype=t.dtype, device=t.device)], dim=ax)
        return _whole(t, array, split, array.dtype)
    t = array.larray
    lo_out = comm.chunk(out_shape, split)[0] if split is not None else 0
    for ax, (b, e) in enumerate(np_pad):
        if b == 0 and e == 0:
            continue
        n = array.gshape[ax]
        distributed = _along_split(array, ax)
        if mode == "constant":
            if distributed:
                got = take_intervals(t, array.gshape, ax, _data_rows(comm, out_shape, ax, b, n), comm)
                m = comm.chunk(out_shape, ax)[1][ax]
                shape_o = list(t.shape)
                shape_o[ax] = m
                res = torch.full(shape_o, constant_values, dtype=t.dtype, device=t.device)
                if got:
                    start = max(lo_out, b) - lo_out
                    res.narrow(ax, start, got[0].shape[ax]).copy_(got[0])
                t = res
            else:
                shape_b = list(t.shape)
                shape_b[ax] = b
                shape_e = list(t.shape)
                shape_e[ax] = e
                t = torch.cat([torch.full(shape_b, constant_values, dtype=t.dtype, device=t.device), t,
                               torch.full(shape_e, constant_values, dtype=t.dtype, device=t.device)], dim=ax)
            continue
        if n == 0:
            raise ValueError(f"can't extend empty axis {ax} using modes other than 'constant'")
        if mode in _FILL_MODES:
            gshape_t = tuple(out_shape[d] if d < ax else array.gshape[d] for d in range(array.ndim))
            before, after = _fill_blocks(t, gshape_t, split, ax, b, e, mode, array)
            if distributed:
                lo, sh, _ = comm.chunk(out_shape, ax)
                m = sh[ax]
                got = take_intervals(t, gshape_t, ax, _data_rows(comm, out_shape, ax, b, n), comm)
                pieces = []
                if lo < b:
                    pieces.append(before.narrow(ax, lo, min(lo + m, b) - lo))
                pieces += got
                if lo + m > b + n:
                    start = max(lo, b + n) - (b + n)
                    pieces.append(after.narrow(ax, start, lo + m - (b + n) - start))
                t = torch.cat(pieces, dim=ax) if pieces else before.narrow(ax, 0, 0)
            else:
                t = torch.cat([before, t, after], dim=ax)
            continue
        if distributed:
            def src_rows(r, ax=ax, b=b, n=n):
                lo, sh, _ = comm.chunk(out_shape, ax, rank=r)
                return _pad_map(np.arange(lo, lo + sh[ax]), n, b, mode)

            t = take_rows(t, array.gshape, ax, src_rows, comm)
        else:
            idx = _pad_map(np.arange(n + b + e), n, b, mode)
            t = t.index_select(ax, torch.as_tensor(idx, device=t.device))
    return _local(t, array, out_shape, split)


def unfold(a: DNDarray, axis: int, size: int, step: int = 1) -> DNDarray:
    """The windows of ``size`` elements every ``step`` along ``axis``, as
    ``torch.Tensor.unfold``: the window index replaces ``axis`` and the
    window's elements form a new last axis. Along the split axis each rank
    fetches the rows its windows cover."""
    axis = sanitize_axis(a.shape, axis)
    if size < 1 or step < 1:
        raise ValueError(f"size and step must be >= 1, got {size}, {step}")
    length = a.shape[axis]
    if size > length:
        raise ValueError(f"size {size} exceeds dimension {length}")
    n_windows = (length - size) // step + 1
    gshape = tuple(n_windows if d == axis else s for d, s in enumerate(a.gshape)) + (size,)
    t = a.larray
    if _along_split(a, axis):
        comm = a.comm

        def want(r):
            lo, sh, _ = comm.chunk(gshape, axis, rank=r)
            return [(lo * step, (lo + sh[axis] - 1) * step + size)] if sh[axis] else []

        got = take_intervals(t, a.gshape, axis, want, comm)
        if not got:
            shape_o = list(t.shape)
            shape_o[axis] = 0
            # graftflow: F004 - t.unfold below is the tensor's method, no collective
            return _local(t.new_empty(shape_o + [size]), a, gshape, a.split)
        t = got[0]
    return _local(t.unfold(axis, size, step), a, gshape, a.split)


# ------------------------------------------------------- gathered results
def diag(a: DNDarray, offset: int = 0) -> DNDarray:
    """The matrix with ``a`` (1-D) on diagonal ``offset``, or the diagonal
    of a matrix."""
    if a.ndim == 1:
        return _whole(torch.diag(a._logical(), offset), a, a.split, a.dtype)
    return diagonal(a, offset=offset)


def diagonal(a: DNDarray, offset: int = 0, dim1: int = 0, dim2: int = 1) -> DNDarray:
    """Diagonal ``offset`` of the planes ``(dim1, dim2)``, as a new last
    axis; split along it where ``a`` was split along ``dim1`` or ``dim2``."""
    dim1, dim2 = sanitize_axis(a.shape, dim1), sanitize_axis(a.shape, dim2)
    if dim1 == dim2:
        raise ValueError("dim1 and dim2 need to be different")
    result = torch.diagonal(a._logical(), offset=offset, dim1=dim1, dim2=dim2)
    if a.split is None:
        split = None
    elif a.split in (dim1, dim2):
        split = result.ndim - 1
    else:
        split = a.split - sum(1 for d in (dim1, dim2) if d < a.split)
    return _whole(result, a, split, a.dtype)


def repeat(a: DNDarray, repeats, axis: Optional[int] = None) -> DNDarray:
    """Each element repeated ``repeats`` times (an int, or one count per
    element along ``axis``; the flattened array when ``axis`` is None)."""
    if isinstance(repeats, DNDarray):
        if not (types.heat_type_is_exact(repeats.dtype)):
            raise TypeError(f"invalid dtype for repeats: {repeats.dtype.__name__}, must be integer")
        if repeats.ndim != 1:
            raise ValueError(f"repeats must be a 1d-object or integer, but was {repeats.ndim}-dimensional")
        if repeats.gshape[0] == 0:
            raise ValueError("repeats must contain data")
        repeats = repeats._logical().to(torch.int64)
    elif isinstance(repeats, (list, tuple, np.ndarray)):
        if isinstance(repeats, np.ndarray):
            if not np.can_cast(repeats.dtype, np.int64):
                raise TypeError(f"all components of repeats must be integers, got {repeats.dtype}")
            arr = repeats
        else:
            if not all(isinstance(r, int) for r in repeats):
                raise TypeError("all components of repeats must be integers")
            try:
                arr = np.asarray(repeats, dtype=np.int64)
            except OverflowError:
                raise TypeError("all components of repeats must be integers representable as int64") from None
        if arr.size == 0:
            raise ValueError("repeats must contain data")
        if arr.ndim != 1:
            raise ValueError(f"repeats must be a 1d-object or integer, but was {arr.ndim}-dimensional")
        repeats = torch.as_tensor(arr.astype(np.int64, copy=False))
    t = a._logical()
    if isinstance(repeats, torch.Tensor):
        repeats = repeats.to(t.device)
        if repeats.numel() == 1:
            repeats = int(repeats.reshape(()).item())
    if axis is None:
        result = torch.repeat_interleave(t.reshape(-1), repeats)
        split = 0 if a.split is not None else None
    else:
        axis = sanitize_axis(a.shape, axis)
        result = torch.repeat_interleave(t, repeats, dim=axis)
        split = a.split
    return _whole(result, a, split, a.dtype)


def tile(x: DNDarray, reps) -> DNDarray:
    """``x`` repeated ``reps`` times along each axis (numpy's ``tile``)."""
    if isinstance(reps, DNDarray):
        reps = reps.tolist()
    reps = (int(reps),) if isinstance(reps, (int, np.integer)) else tuple(int(r) for r in reps)
    result = torch.tile(x._logical(), reps)
    split = x.split + (result.ndim - x.ndim) if x.split is not None else None
    return _whole(result, x, split, x.dtype)


# ------------------------------------------------ sort, top-k and unique
def sort(a: DNDarray, axis: int = -1, descending: bool = False, out=None):
    """``(values, indices)`` of ``a`` sorted along ``axis``, equal values in
    their original order; ``descending`` puts NaN first. Indices are int64
    positions along ``axis``. Along the split axis the sort runs across
    ranks (:func:`heat_tpu_torch.parallel.distributed_sort`)."""
    from ..parallel.dsort import distributed_sort, local_sort

    axis = sanitize_axis(a.shape, axis)
    if _along_split(a, axis):
        vals, idx = distributed_sort(a.larray, a.gshape, axis, a.comm, descending)
    else:
        vals, idx = local_sort(a.larray, axis, descending)
    res_v = _local(vals, a, a.gshape, a.split)
    res_i = _local(idx, a, a.gshape, a.split, types.int64)
    if out is not None:
        _write(out, res_v)
        return out, res_i
    return res_v, res_i


def topk(a: DNDarray, k: int, dim: int = -1, largest: bool = True, sorted: bool = True, out=None):
    """``(values, indices)`` of the ``k`` largest (or smallest) elements
    along ``dim``, ordered, ties to the lower index; NaN counts as the
    largest (and comes last among the smallest). Along the split axis each
    rank sends only its k candidates
    (:func:`heat_tpu_torch.parallel.distributed_topk`)."""
    from ..parallel.dtopk import distributed_topk, local_topk

    dim = sanitize_axis(a.shape, dim)
    if k > a.shape[dim]:
        raise ValueError(f"selected index k={k} out of range for dimension of size {a.shape[dim]}")
    gshape = tuple(k if d == dim else s for d, s in enumerate(a.gshape))
    if _along_split(a, dim):
        values, indices = distributed_topk(a.larray, a.gshape, dim, k, a.comm, largest=largest)
        res_v, res_i = _whole(values, a, a.split, a.dtype), _whole(indices, a, a.split, types.int64)
    else:
        values, indices = local_topk(a.larray, k, dim, largest, total_order=True)
        res_v, res_i = _local(values, a, gshape, a.split), _local(indices, a, gshape, a.split, types.int64)
    if out is not None:
        _write(out[0], res_v)
        _write(out[1], res_i)
        return out
    return res_v, res_i


def unique(a: DNDarray, sorted: bool = False, return_inverse: bool = False, axis: Optional[int] = None):
    """The sorted distinct elements of ``a`` (of its slices along ``axis``),
    split 0 where ``a`` is split; with ``return_inverse`` also each
    element's index in them (replicated). Across ranks each rank
    deduplicates its chunk and only the candidates are gathered
    (:func:`heat_tpu_torch.parallel.dscan.unique_merge`); the inverse is a
    ``searchsorted`` of each chunk against the merged table."""
    from ..parallel.dscan import local_unique, unique_merge

    comm = a.comm
    split = 0 if a.split is not None else None
    distributed = a.split is not None and comm.is_distributed()
    if axis is None:
        vals = unique_merge(a.larray, comm) if distributed else local_unique(a.larray)
        res = _whole(vals, a, split, a.dtype)
        if not return_inverse:
            return res
        inv = torch.searchsorted(vals, a.larray.contiguous())
        if distributed:
            inv = comm.allgather(inv, a.split, a.lshape_map[:, a.split])
        return res, DNDarray(inv.to(torch.int64), gshape=a.gshape, dtype=types.int64, split=None,
                             device=a.device, comm=comm)
    axis = sanitize_axis(a.shape, axis)
    if distributed and axis == a.split and not return_inverse:
        cands = torch.unique(a.larray, sorted=True, dim=axis) if a.lshape[axis] else a.larray
        merged = comm.allgather(cands, axis)
        return _whole(torch.unique(merged, sorted=True, dim=axis), a, split, a.dtype)
    out = torch.unique(a._logical(), sorted=True, return_inverse=return_inverse, dim=axis)
    if not return_inverse:
        return _whole(out, a, split, a.dtype)
    vals, inv = out
    return _whole(vals, a, split, a.dtype), DNDarray(inv.to(torch.int64), dtype=types.int64, split=None,
                                                     device=a.device, comm=comm)
