"""Array factories (counterpart of ``heat_tpu/core/factories.py``).

Every factory creates its tensor directly on the target device (default:
the first CUDA card; ``device="cpu"`` for the CPU).
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from . import devices, types
from .communication import TorchCommunication, sanitize_comm
from .devices import Device
from .dndarray import DNDarray
from .stride_tricks import sanitize_axis, sanitize_shape

__all__ = [
    "arange",
    "array",
    "empty",
    "empty_like",
    "full",
    "full_like",
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
    """The main constructor. ``split=k`` marks axis ``k`` as the split axis;
    ``is_split=k`` declares ``obj`` to be this process's shard, which at
    world size 1 is the whole array."""
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
    if isinstance(data, torch.Tensor):
        t = data.to(device=device.torch_device)
        if copy and t is data:
            t = t.clone()
    else:
        a = np.asarray(data)
        if a.dtype == np.float64 and dtype is None and not isinstance(data, np.ndarray):
            # python floats default to float32, like heat_tpu and torch
            a = a.astype(np.float32)
        if dtype is None:
            types.canonical_heat_type(a.dtype)  # raises for types outside this slice
        elif a.dtype not in types._NP_TO_HEAT:
            a = a.astype(dtype.numpy_type())
        t = torch.from_numpy(np.array(a, copy=True)).to(device=device.torch_device)
    if dtype is not None:
        t = t.to(dtype.torch_type())
    while t.ndim < ndmin:
        t = t.unsqueeze(0)
    if is_split is not None:
        split = is_split
    return DNDarray(t, dtype=dtype, split=split, device=device, comm=comm)


def _build(shape, dtype, split, device, comm, fill) -> DNDarray:
    shape = sanitize_shape(shape)
    dtype = types.canonical_heat_type(dtype)
    device = devices.sanitize_device(device)
    t = fill(shape, dtype.torch_type(), device.torch_device)
    return DNDarray(t, dtype=dtype, split=sanitize_axis(shape, split), device=device, comm=sanitize_comm(comm))


def zeros(shape, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    return _build(shape, dtype, split, device, comm, lambda s, d, dev: torch.zeros(s, dtype=d, device=dev))


def ones(shape, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    return _build(shape, dtype, split, device, comm, lambda s, d, dev: torch.ones(s, dtype=d, device=dev))


def empty(shape, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Uninitialized memory (``torch.empty``)."""
    return _build(shape, dtype, split, device, comm, lambda s, d, dev: torch.empty(s, dtype=d, device=dev))


def full(shape, fill_value, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """dtype defaults to float32; it is never inferred from the fill value."""
    dtype = types.float32 if dtype is None else dtype
    if isinstance(fill_value, np.ndarray) and fill_value.ndim == 0:
        fill_value = fill_value.item()
    return _build(
        shape, dtype, split, device, comm,
        lambda s, d, dev: torch.full(s, fill_value, dtype=d, device=dev),
    )


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
        lambda s, d, dev: (
            start + step * torch.arange(s[0], dtype=torch.float64 if d.is_floating_point else torch.int64, device=dev)
        ).to(d),
    )
