"""Array factories (counterpart of ``heat_tpu/core/factories.py``).

Every factory creates its tensor directly on the target device (default:
the first CUDA card; ``device="cpu"`` for the CPU), and each rank builds
only its own chunk of a split array.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from . import devices, types
from .communication import TorchCommunication, sanitize_comm
from .devices import Device
from .dndarray import DNDarray, _host_tensor, _redistribute
from .stride_tricks import sanitize_axis, sanitize_shape

__all__ = [
    "arange",
    "array",
    "asarray",
    "empty",
    "empty_like",
    "eye",
    "full",
    "full_like",
    "linspace",
    "logspace",
    "meshgrid",
    "ones",
    "ones_like",
    "zeros",
    "zeros_like",
]


def array(
    obj,
    dtype=None,
    copy: bool = True,
    ndmin: int = 0,
    split: Optional[int] = None,
    is_split: Optional[int] = None,
    device: Optional[Union[str, Device]] = None,
    comm: Optional[TorchCommunication] = None,
) -> DNDarray:
    """The main constructor.

    ``split=k``: every rank passes the same global ``obj`` and keeps its
    chunk along axis ``k``. ``is_split=k``: ``obj`` is this rank's shard;
    the global array is the rank-ordered concatenation of the shards along
    ``k`` (their other dimensions must agree), rebalanced to the ceil-div
    layout, as ``heat_tpu`` assembles it."""
    if split is not None and is_split is not None:
        raise ValueError(f"split and is_split are mutually exclusive, got {split}, {is_split}")
    comm = sanitize_comm(comm)
    device = devices.sanitize_device(device)
    if isinstance(obj, DNDarray):
        if dtype is None:
            dtype = obj.dtype
        data = obj._logical()
    else:
        data = obj
    if dtype is not None:
        dtype = types.canonical_heat_type(dtype)
    chunked = False
    if isinstance(data, torch.Tensor):
        t = data.to(device=device.torch_device)
        if copy and t is data:
            t = t.clone()
        while t.ndim < ndmin:
            t = t.unsqueeze(0)
        gshape = tuple(t.shape)
    else:
        a = np.asarray(data)
        if a.dtype == np.float64 and dtype is None and not isinstance(data, np.ndarray):
            # python floats default to float32, like heat_tpu and torch (python complex stays complex128)
            a = a.astype(np.float32)
        if dtype is None:
            types.canonical_heat_type(a.dtype)  # raises for a type heat does not have
        elif a.dtype not in types._NP_TO_HEAT and not types._is_numpy_bfloat16(a.dtype):
            a = a.astype(dtype.numpy_type() or np.float32)
        a = a.reshape((1,) * (ndmin - a.ndim) + a.shape)
        gshape = a.shape
        if split is not None:  # only this rank's chunk goes to the device
            a = a[comm.chunk(gshape, sanitize_axis(gshape, split))[2]]
            chunked = True
        t = _host_tensor(a).to(device=device.torch_device)
    if dtype is not None:
        t = t.to(dtype.torch_type())
    if is_split is not None:
        split = sanitize_axis(gshape, is_split)
        if comm.is_distributed():
            shapes = comm.allgather(torch.tensor([gshape], dtype=torch.int64, device=comm.device()), 0, [1] * comm.size)
            shapes = shapes.cpu().numpy()
            for d in range(len(gshape)):
                if d != split and len(set(shapes[:, d].tolist())) != 1:
                    raise ValueError(f"local shards disagree on non-split dim {d}: {sorted(set(shapes[:, d].tolist()))}")
            counts = shapes[:, split].tolist()
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).tolist()
            gshape = tuple(int(sum(counts)) if d == split else s for d, s in enumerate(gshape))
            t = _redistribute(t, split, starts, counts, gshape, comm)
    elif split is not None and not chunked and comm.is_distributed():
        t = t[comm.chunk(gshape, sanitize_axis(gshape, split))[2]].clone()
    return DNDarray(t, gshape=gshape, dtype=dtype, split=split, device=device, comm=comm)


def _build(shape, dtype, split, device, comm, fill) -> DNDarray:
    """A DNDarray whose rank builds its chunk with ``fill(lshape, torch
    dtype, torch device, offset)``."""
    shape = sanitize_shape(shape)
    dtype = types.canonical_heat_type(dtype)
    device = devices.sanitize_device(device)
    comm = sanitize_comm(comm)
    split = sanitize_axis(shape, split)
    offset, lshape, _ = comm.chunk(shape, split)
    t = fill(lshape, dtype.torch_type(), device.torch_device, offset)
    return DNDarray(t, gshape=shape, dtype=dtype, split=split, device=device, comm=comm)


def zeros(shape, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    return _build(shape, dtype, split, device, comm, lambda s, d, dev, _: torch.zeros(s, dtype=d, device=dev))


def ones(shape, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    return _build(shape, dtype, split, device, comm, lambda s, d, dev, _: torch.ones(s, dtype=d, device=dev))


def empty(shape, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Uninitialized memory (``torch.empty``)."""
    return _build(shape, dtype, split, device, comm, lambda s, d, dev, _: torch.empty(s, dtype=d, device=dev))


def full(shape, fill_value, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """dtype defaults to float32; it is never inferred from the fill value."""
    dtype = types.float32 if dtype is None else dtype
    if isinstance(fill_value, np.ndarray) and fill_value.ndim == 0:
        fill_value = fill_value.item()
    return _build(
        shape, dtype, split, device, comm,
        lambda s, d, dev, _: torch.full(s, fill_value, dtype=d, device=dev),
    )


def eye(shape, dtype=types.float32, split=None, device=None, comm=None, order="C") -> DNDarray:
    """Ones on the main diagonal, zeros elsewhere. ``shape`` is n (square)
    or (n,) or (n, m)."""
    if order != "C":
        raise NotImplementedError("only C-order memory layout is supported")
    if isinstance(shape, (int, np.integer)):
        n, m = int(shape), int(shape)
    else:
        shape = tuple(shape)
        n, m = (int(shape[0]), int(shape[0])) if len(shape) == 1 else (int(shape[0]), int(shape[1]))
    split = sanitize_axis((n, m), split)

    def fill(s, d, dev, offset):
        # the chunk's rows and columns in global coordinates; ones where they meet
        rows = torch.arange(s[0], device=dev) + (offset if split == 0 else 0)
        cols = torch.arange(s[1], device=dev) + (offset if split == 1 else 0)
        return (rows[:, None] == cols[None, :]).to(d)

    return _build((n, m), dtype, split, device, comm, fill)


def _like_meta(a: DNDarray, dtype, split, device, comm):
    return (
        a.shape,
        dtype if dtype is not None else a.dtype,
        split if split is not None else a.split,
        device if device is not None else a.device,
        comm if comm is not None else a.comm,
    )


def zeros_like(a, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    return zeros(*_like_meta(a, dtype, split, device, comm))


def ones_like(a, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    return ones(*_like_meta(a, dtype, split, device, comm))


def empty_like(a, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    return empty(*_like_meta(a, dtype, split, device, comm))


def full_like(a, fill_value, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    # dtype does not inherit a.dtype: full()'s float32 default applies
    shape, _, split_, device_, comm_ = _like_meta(a, dtype, split, device, comm)
    return full(shape, fill_value, dtype=dtype, split=split_, device=device_, comm=comm_)


def arange(*args, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """Evenly spaced values in ``[start, stop)``; int arguments give int32."""
    if len(args) == 1:
        start, stop, step = 0, args[0], 1
    elif len(args) == 2:
        start, stop, step = args[0], args[1], 1
    elif len(args) == 3:
        start, stop, step = args
    else:
        raise TypeError(f"function takes 1 to 3 positional arguments but {len(args)} were given")
    if dtype is None:
        ints = all(isinstance(a, (int, np.integer)) for a in (start, stop, step))
        dtype = types.int32 if ints else types.float32
    n = int(max(0, -(-(stop - start) // step))) if step != 0 else 0
    return _build(
        (n,), dtype, split, device, comm,
        lambda s, d, dev, offset: (
            start + step * (offset + torch.arange(s[0], dtype=torch.float64 if d.is_floating_point else torch.int64, device=dev))
        ).to(d),
    )


def asarray(obj, dtype=None, copy=None, order="C", is_split=None, device=None) -> DNDarray:
    """``obj`` as a DNDarray: ``obj`` itself where it is one of that dtype,
    else :func:`array` (``is_split``: ``obj`` is this rank's shard)."""
    if order is not None and order not in ("C", "K", "A"):
        raise NotImplementedError("only C-order memory layout is supported")
    if isinstance(obj, DNDarray) and is_split is None and (dtype is None or obj.dtype == types.canonical_heat_type(dtype)):
        return obj
    return array(obj, dtype=dtype, is_split=is_split, device=device)


def _is_f32(v) -> bool:
    return (isinstance(v, np.ndarray) or isinstance(v, np.generic)) and v.dtype == np.float32


def linspace(start, stop, num: int = 50, endpoint: bool = True, retstep: bool = False, dtype=None, split=None,
             device=None, comm=None):
    """``num`` evenly spaced values from ``start`` to ``stop`` (included with
    ``endpoint``), as ``jnp.linspace`` computes them: ``start·(1 - s) +
    stop·s`` with ``s = i / div``, in float64 for python numbers, then cast
    to ``dtype`` (float32 by default). Each rank computes its chunk."""
    num = int(num)
    if num < 0:
        raise ValueError(f"Number of samples, {num}, must be non-negative.")
    dtype = types.canonical_heat_type(dtype) if dtype is not None else types.float32
    ct = torch.float32 if _is_f32(start) and _is_f32(stop) else torch.float64
    div = (num - 1) if endpoint else num

    def fill(s, d, dev, offset):
        i = torch.arange(offset, offset + s[0], device=dev)
        a, b = torch.tensor(float(start), dtype=ct, device=dev), torch.tensor(float(stop), dtype=ct, device=dev)
        if num == 1:
            return a.expand(s[0]).to(d)
        step = i.to(ct) / torch.tensor(div, dtype=ct, device=dev)
        out = a * (1 - step) + b * step
        if endpoint:
            out = torch.where(i == div, b, out)
        return out.to(d)

    res = _build((num,), dtype, split, device, comm, fill)
    if retstep:
        return res, (stop - start) / max(1, div)
    return res


def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """``base`` to the powers :func:`linspace` gives."""
    from . import arithmetics

    y = linspace(start, stop, num=num, endpoint=endpoint, split=split, device=device, comm=comm)
    res = arithmetics.pow(float(base), y)
    return res.astype(dtype) if dtype is not None else res


def meshgrid(*arrays, indexing: str = "xy"):
    """Coordinate grids of the 1-D ``arrays`` (``"xy"`` or ``"ij"``
    indexing); split along the grid axis of the first split input."""
    if indexing not in ("xy", "ij"):
        raise ValueError(f"indexing must be 'xy' or 'ij', got {indexing}")
    dnd = [a if isinstance(a, DNDarray) else array(a) for a in arrays]
    if not dnd:
        return []
    comm, device = dnd[0].comm, dnd[0].device
    grids = torch.meshgrid(*[a._logical() for a in dnd], indexing=indexing)
    out_split = None
    for i, a in enumerate(dnd):
        if a.split is not None:
            out_split = (1 - i) if indexing == "xy" and i < 2 and len(dnd) >= 2 else i
            break
    out = []
    for g in grids:
        t = g[comm.chunk(tuple(g.shape), out_split)[2]] if out_split is not None else g
        out.append(DNDarray(t.clone(), gshape=tuple(g.shape), split=out_split, device=device, comm=comm))
    return out
