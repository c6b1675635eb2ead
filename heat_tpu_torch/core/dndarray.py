"""DNDarray — a distributed n-dimensional array over a ``torch.Tensor``.

Counterpart of ``heat_tpu/core/dndarray.py``. In ``heat_tpu`` a DNDarray
wraps a global ``jax.Array`` sharded over a mesh, padded along the split
axis to a multiple of the mesh size. This slice of the port runs at world
size 1: the tensor *is* the whole array, ``split`` is metadata that
propagates through operations exactly as in ``heat_tpu``, and there is no
padding, so ``larray`` and :meth:`_logical` are the same tensor.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import devices, types
from .communication import TorchCommunication, sanitize_comm
from .devices import Device
from .stride_tricks import sanitize_axis

__all__ = ["DNDarray"]


def _to_tensor(array, dtype, device: Device) -> torch.Tensor:
    """``array`` as a tensor of heat type ``dtype`` (or inferred) on ``device``."""
    tdev = device.torch_device
    if isinstance(array, torch.Tensor):
        t = array
    else:
        a = np.asarray(array)
        if dtype is None and a.dtype not in types._NP_TO_HEAT:
            raise TypeError(f"data type {a.dtype} not supported by this slice of the port")
        t = torch.from_numpy(np.array(a, order="C", copy=True))  # host data is copied, never aliased
    tt = None if dtype is None else dtype.torch_type()
    return t.to(device=tdev, dtype=tt)


class DNDarray:
    """Distributed N-dimensional array.

    Parameters
    ----------
    array : torch.Tensor or array-like
        The global data. A tensor keeps its device unless ``device`` is
        given; other inputs go to ``device`` (default: the global default
        device, a CUDA card).
    gshape : tuple, optional
        Global shape; must equal the tensor's shape at world size 1.
    dtype : heat type, optional
        Inferred from ``array`` if omitted.
    split : int or None
        Axis that would be sharded across cards, or None for replication.
    device, comm : placement metadata.
    """

    def __init__(
        self,
        array,
        gshape: Optional[Tuple[int, ...]] = None,
        dtype=None,
        split: Optional[int] = None,
        device: Optional[Device] = None,
        comm: Optional[TorchCommunication] = None,
    ):
        self.__comm = sanitize_comm(comm)
        if device is None and isinstance(array, torch.Tensor):
            device = devices.sanitize_device(array.device)
        self.__device = devices.sanitize_device(device)
        if dtype is not None:
            dtype = types.canonical_heat_type(dtype)
        tensor = _to_tensor(array, dtype, self.__device)
        if dtype is None:
            dtype = types.canonical_heat_type(tensor.dtype)
        gshape = tuple(tensor.shape) if gshape is None else tuple(int(s) for s in gshape)
        if gshape != tuple(tensor.shape):
            raise ValueError(f"gshape {gshape} does not match the tensor's shape {tuple(tensor.shape)}")
        if tensor.ndim == 0:
            split = None
        self.__split = sanitize_axis(gshape, split)
        self.__dtype = dtype
        self.__array = tensor

    # ------------------------------------------------------------------ meta
    @property
    def larray(self) -> torch.Tensor:
        """The underlying tensor (at world size 1: the whole array)."""
        return self.__array

    def _logical(self) -> torch.Tensor:
        """The exact logical array (no padding exists at world size 1)."""
        return self.__array

    @property
    def comm(self) -> TorchCommunication:
        return self.__comm

    @property
    def device(self) -> Device:
        return self.__device

    @property
    def dtype(self):
        return self.__dtype

    @property
    def split(self) -> Optional[int]:
        return self.__split

    @property
    def gshape(self) -> Tuple[int, ...]:
        return tuple(self.__array.shape)

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.gshape

    @property
    def lshape(self) -> Tuple[int, ...]:
        """Shape of this process's shard (the ceil-div chunk of its rank)."""
        return self.__comm.chunk(self.gshape, self.__split)[1]

    @property
    def lshape_map(self) -> np.ndarray:
        """(size, ndim) map of every shard's shape — computed, not communicated."""
        return self.__comm.lshape_map(self.gshape, self.__split)

    @property
    def ndim(self) -> int:
        return self.__array.ndim

    @property
    def size(self) -> int:
        return int(self.__array.numel())

    # ----------------------------------------------------------- conversion
    def resplit(self, axis: Optional[int] = None) -> "DNDarray":
        """A copy with split axis ``axis`` (metadata only at world size 1)."""
        return DNDarray(
            self.__array.clone(), dtype=self.__dtype, split=sanitize_axis(self.gshape, axis),
            device=self.__device, comm=self.__comm,
        )

    def astype(self, dtype, copy: bool = True) -> "DNDarray":
        """Cast to ``dtype``; ``copy=False`` casts in place of this object."""
        dtype = types.canonical_heat_type(dtype)
        casted = self.__array.to(dtype.torch_type())
        if not copy:
            self.__array = casted
            self.__dtype = dtype
            return self
        if casted is self.__array:
            casted = casted.clone()
        return DNDarray(casted, dtype=dtype, split=self.__split, device=self.__device, comm=self.__comm)

    def numpy(self) -> np.ndarray:
        """The global array as a numpy array on the host."""
        return self.__array.detach().cpu().numpy()

    def item(self):
        """The single element as a python scalar."""
        if self.size != 1:
            raise ValueError("only one-element DNDarrays can be converted to Python scalars")
        return self.__array.item()

    # ------------------------------------------------------------- indexing
    def __getitem__(self, key) -> "DNDarray":
        """Basic indexing with ints, slices and ``...``. The split axis
        survives a slice and shifts left past dimensions removed by ints; an
        int on the split axis itself makes the result unsplit."""
        if isinstance(key, DNDarray) or not isinstance(key, tuple):
            key = (key,)
        if any(k is Ellipsis for k in key):
            i = key.index(Ellipsis)
            fill = self.ndim - (len(key) - 1)
            key = key[:i] + (slice(None),) * fill + key[i + 1 :]
        if len(key) > self.ndim:
            raise IndexError(f"too many indices for DNDarray: {self.ndim}-dimensional, {len(key)} indexed")
        for k in key:
            if not isinstance(k, (int, np.integer, slice)):
                raise NotImplementedError(
                    f"index of type {type(k).__name__} is not supported in this slice of the port"
                )
        split = self.__split
        if split is not None and split < len(key):
            if isinstance(key[split], (int, np.integer)):
                split = None
        if split is not None:
            split -= sum(1 for k in key[:split] if isinstance(k, (int, np.integer)))
        result = self.__array[tuple(int(k) if isinstance(k, np.integer) else k for k in key)]
        return DNDarray(result, dtype=self.__dtype, split=split, device=self.__device, comm=self.__comm)

    # ----------------------------------------------------------- arithmetic
    def __add__(self, other):
        from . import arithmetics

        return arithmetics.add(self, other)

    def __radd__(self, other):
        from . import arithmetics

        return arithmetics.add(other, self)

    def __sub__(self, other):
        from . import arithmetics

        return arithmetics.sub(self, other)

    def __rsub__(self, other):
        from . import arithmetics

        return arithmetics.sub(other, self)

    def __mul__(self, other):
        from . import arithmetics

        return arithmetics.mul(self, other)

    def __rmul__(self, other):
        from . import arithmetics

        return arithmetics.mul(other, self)

    def __truediv__(self, other):
        from . import arithmetics

        return arithmetics.div(self, other)

    def __rtruediv__(self, other):
        from . import arithmetics

        return arithmetics.div(other, self)

    def __pow__(self, other):
        from . import arithmetics

        return arithmetics.pow(self, other)

    def __rpow__(self, other):
        from . import arithmetics

        return arithmetics.pow(other, self)

    def __neg__(self):
        from . import arithmetics

        return arithmetics.neg(self)

    def __pos__(self):
        return self

    # In-place forms rebind this object to the result's tensor, as heat_tpu
    # does (promotion may change the dtype). The previous tensor is left
    # untouched, so views of it handed out earlier keep their values.
    def __iadd__(self, other):
        return self.__set_from(self + other)

    def __isub__(self, other):
        return self.__set_from(self - other)

    def __imul__(self, other):
        return self.__set_from(self * other)

    def __itruediv__(self, other):
        return self.__set_from(self / other)

    def __set_from(self, result: "DNDarray") -> "DNDarray":
        self.__array = result.larray
        self.__dtype = result.dtype
        self.__split = result.split
        return self

    def __repr__(self) -> str:
        return (
            f"DNDarray({self.numpy()!r}, dtype=ht.{self.__dtype.__name__}, "
            f"device={self.__device}, split={self.__split})"
        )

    __str__ = __repr__
