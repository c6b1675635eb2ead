"""DNDarray — a distributed n-dimensional array over ``torch.Tensor`` shards.

Counterpart of ``heat_tpu/core/dndarray.py``. ``heat_tpu`` wraps one global
``jax.Array`` sharded over a mesh; the port follows Heat's own SPMD model
instead: every process (rank) holds its own tensor, ``larray``, which is
its ceil-div chunk of the global array along ``split`` (the whole array
when ``split`` is None). Chunks are always in that layout — the layout of
``heat_tpu``'s padded shards, so ``lshape_map`` reads the same in both
packages, and the last ranks may hold nothing. ``numpy()``, ``item()``,
``tolist()`` and ``repr`` give the global value on every rank.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

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


def _redistribute(
    local: torch.Tensor, axis: int, starts: Sequence[int], counts: Sequence[int], gshape, comm
) -> torch.Tensor:
    """This rank's ceil-div chunk along ``axis`` of an array of ``gshape``
    whose rank r now holds the rows ``[starts[r], starts[r] + counts[r])``
    (contiguous, any lengths): one ``alltoall``, nothing where the layout is
    already the ceil-div one."""
    p, me = comm.size, comm.rank
    target = [comm.chunk(gshape, axis, rank=q) for q in range(p)]
    if all(int(starts[q]) == target[q][0] and int(counts[q]) == target[q][1][axis] for q in range(p)):
        return local
    s0 = int(starts[me])
    blocks = []
    for q in range(p):
        lo, hi = target[q][0], target[q][0] + target[q][1][axis]
        a, b = max(lo, s0), min(hi, s0 + int(counts[me]))
        blocks.append(local.narrow(axis, a - s0, b - a) if b > a else local.narrow(axis, 0, 0))
    lo, hi = target[me][0], target[me][0] + target[me][1][axis]
    shapes = []
    for q in range(p):
        a, b = max(lo, int(starts[q])), min(hi, int(starts[q]) + int(counts[q]))
        shape = list(gshape)
        shape[axis] = max(0, b - a)
        shapes.append(tuple(shape))
    parts = comm.alltoall(blocks, shapes)
    order = sorted(range(p), key=lambda q: int(starts[q]))
    return torch.cat([parts[q] for q in order], dim=axis)


class DNDarray:
    """Distributed N-dimensional array.

    Parameters
    ----------
    array : torch.Tensor or array-like
        This rank's data: its ceil-div chunk of the global array along
        ``split`` (the whole array when ``split`` is None or the world has
        size 1). A tensor keeps its device unless ``device`` is given;
        other inputs go to ``device`` (default: the global default device,
        a CUDA card).
    gshape : tuple, optional
        Global shape. Required for a split array at world size > 1; else
        the tensor's shape.
    dtype : heat type, optional
        Inferred from ``array`` if omitted.
    split : int or None
        Axis along which the array is sharded across ranks, or None for
        replication.
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
        if tensor.ndim == 0:
            split = None
        if gshape is None:
            if split is not None and self.__comm.is_distributed():
                raise ValueError(
                    "a split DNDarray at world size > 1 needs its gshape; "
                    "factories.array(local, is_split=axis) assembles one from per-rank shards"
                )
            gshape = tuple(tensor.shape)
        gshape = tuple(int(s) for s in gshape)
        self.__split = sanitize_axis(gshape, split)
        lshape = self.__comm.chunk(gshape, self.__split)[1]
        if tuple(tensor.shape) != lshape:
            raise ValueError(
                f"local tensor of shape {tuple(tensor.shape)} is not rank {self.__comm.rank}'s chunk {lshape} "
                f"of gshape {gshape} split along {self.__split}"
            )
        self.__gshape = gshape
        self.__dtype = dtype
        self.__array = tensor

    # ------------------------------------------------------------------ meta
    @property
    def larray(self) -> torch.Tensor:
        """This rank's tensor: its chunk of the global array."""
        return self.__array

    def _logical(self) -> torch.Tensor:
        """The whole global array on this rank: ``larray`` where the array is
        replicated or the world has size 1, else an ``allgather``."""
        if self.__split is None or not self.__comm.is_distributed():
            return self.__array
        counts = self.lshape_map[:, self.__split]
        return self.__comm.allgather(self.__array, self.__split, counts=counts)

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
        return self.__gshape

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.__gshape

    @property
    def T(self) -> "DNDarray":
        """The transpose; the split axis moves with its dimension."""
        from .linalg import transpose

        return transpose(self)

    @property
    def lshape(self) -> Tuple[int, ...]:
        """Shape of this rank's chunk."""
        return tuple(self.__array.shape)

    @property
    def lshape_map(self) -> np.ndarray:
        """(size, ndim) map of every rank's chunk shape — computed, not
        communicated."""
        return self.__comm.lshape_map(self.__gshape, self.__split)

    @property
    def ndim(self) -> int:
        return len(self.__gshape)

    @property
    def size(self) -> int:
        return int(np.prod(self.__gshape, dtype=np.int64))

    def is_balanced(self, force_check: bool = False) -> bool:
        """Whether the chunks are in the ceil-div layout: always, in the port
        (every operation that changes extents rebalances, as ``balance_``
        would)."""
        return True

    def balance_(self) -> "DNDarray":
        """Bring the chunks into the ceil-div layout; they always are, so
        this returns ``self``."""
        return self

    # ----------------------------------------------------------- conversion
    def __resplit_tensor(self, axis: Optional[int]) -> torch.Tensor:
        """This rank's tensor of the array split along ``axis``: a local
        slice (None -> a), an ``allgather`` (a -> None) or an ``alltoall``
        (a -> b)."""
        src, comm, t = self.__split, self.__comm, self.__array
        if axis == src or not comm.is_distributed():
            return t
        if axis is None:
            return self._logical()
        if src is None:
            return t[comm.chunk(self.__gshape, axis)[2]].clone()
        lmap = self.lshape_map
        blocks = []
        for q in range(comm.size):
            off, lsh, _ = comm.chunk(self.__gshape, axis, rank=q)
            blocks.append(t.narrow(axis, off, lsh[axis]))
        mine = comm.chunk(self.__gshape, axis)[1][axis]
        shapes = []
        for q in range(comm.size):
            shape = list(self.__gshape)
            shape[src] = int(lmap[q, src])
            shape[axis] = mine
            shapes.append(tuple(shape))
        return torch.cat(comm.alltoall(blocks, shapes), dim=src)

    def resplit(self, axis: Optional[int] = None) -> "DNDarray":
        """A copy split along ``axis``."""
        axis = sanitize_axis(self.__gshape, axis)
        t = self.__resplit_tensor(axis)
        if t is self.__array:
            t = t.clone()
        return DNDarray(t, gshape=self.__gshape, dtype=self.__dtype, split=axis, device=self.__device, comm=self.__comm)

    def resplit_(self, axis: Optional[int] = None) -> "DNDarray":
        """Split this array along ``axis`` in place."""
        axis = sanitize_axis(self.__gshape, axis)
        self.__array = self.__resplit_tensor(axis)
        self.__split = axis
        return self

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
        return DNDarray(casted, gshape=self.__gshape, dtype=dtype, split=self.__split, device=self.__device, comm=self.__comm)

    def numpy(self) -> np.ndarray:
        """The global array as a numpy array on the host, on every rank."""
        return self._logical().detach().cpu().numpy()

    def item(self):
        """The single element as a python scalar."""
        if self.size != 1:
            raise ValueError("only one-element DNDarrays can be converted to Python scalars")
        return self._logical().item()

    def tolist(self, keepsplit: bool = False) -> list:
        """The global array as nested python lists."""
        return self.numpy().tolist()

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        out = self.numpy()
        return out.astype(dtype) if dtype is not None else out

    def __cast(self, cast_function):
        if self.size == 1:
            return cast_function(self._logical().reshape(()).item())
        raise TypeError("only size-1 arrays can be converted to Python scalars")

    def __bool__(self) -> bool:
        return self.__cast(bool)

    def __int__(self) -> int:
        return self.__cast(int)

    def __float__(self) -> float:
        return self.__cast(float)

    def __complex__(self) -> complex:
        return self.__cast(complex)

    def __len__(self) -> int:
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.__gshape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # ------------------------------------------------------------- indexing
    def __getitem__(self, key) -> "DNDarray":
        """Basic indexing with ints, slices and ``...``. The split axis
        survives a slice and shifts left past dimensions removed by ints; an
        int on the split axis itself makes the result unsplit.

        Across ranks: an int on the split axis is broadcast by the rank
        that owns it; a slice of the split axis keeps each rank's share and
        rebalances it to the ceil-div layout (one ``alltoall``); every other
        index is local."""
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
        key = key + (slice(None),) * (self.ndim - len(key))
        gkey, gshape = [], []
        for k, n in zip(key, self.__gshape):
            if isinstance(k, slice):
                start, stop, step = k.indices(n)
                if step <= 0:
                    raise ValueError("step must be greater than zero")
                gkey.append(slice(start, stop, step))
                gshape.append(len(range(start, stop, step)))
            else:
                i = int(k)
                if not -n <= i < n:
                    raise IndexError(f"index {i} is out of bounds for axis with size {n}")
                gkey.append(i % n)
        split = self.__split
        if split is not None and isinstance(gkey[split], int):
            out_split = None
        elif split is not None:
            out_split = split - sum(1 for k in gkey[:split] if isinstance(k, int))
        else:
            out_split = None
        meta = dict(dtype=self.__dtype, device=self.__device, comm=self.__comm)
        comm = self.__comm
        if split is None or not comm.is_distributed():
            return DNDarray(self.__array[tuple(gkey)], gshape=tuple(gshape), split=out_split, **meta)
        off, lshape, _ = comm.chunk(self.__gshape, split)
        if out_split is None:
            # an int on the split axis: its owner broadcasts the result
            i = gkey[split]
            block = -(-self.__gshape[split] // comm.size)
            owner = i // block
            lkey = list(gkey)
            if comm.rank == owner:
                lkey[split] = i - off
                buf = self.__array[tuple(lkey)].contiguous()
            else:
                buf = torch.empty(tuple(gshape), dtype=self.__array.dtype, device=self.__array.device)
            return DNDarray(comm.bcast(buf, owner), gshape=tuple(gshape), split=None, **meta)
        # a slice of the split axis: each rank keeps its share, then rebalances
        start, stop, step = gkey[split].start, gkey[split].stop, gkey[split].step
        length = len(range(start, stop, step))
        starts, counts = [], []
        for r in range(comm.size):
            o, ls, _ = comm.chunk(self.__gshape, split, rank=r)
            j0 = min(length, max(0, -(-(o - start) // step)))
            j1 = min(length, max(0, -(-(o + ls[split] - start) // step)))
            starts.append(j0)
            counts.append(max(0, j1 - j0))
        lkey = list(gkey)
        j0 = starts[comm.rank]
        first = start + j0 * step - off
        lkey[split] = slice(first, first + counts[comm.rank] * step, step) if counts[comm.rank] else slice(0, 0)
        local = self.__array[tuple(lkey)]
        local = _redistribute(local, out_split, starts, counts, tuple(gshape), comm)
        return DNDarray(local, gshape=tuple(gshape), split=out_split, **meta)

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

    def __matmul__(self, other):
        from .linalg import matmul

        return matmul(self, other)

    def __neg__(self):
        from . import arithmetics

        return arithmetics.neg(self)

    def __pos__(self):
        from . import arithmetics

        return arithmetics.pos(self)

    def __abs__(self):
        from . import rounding

        return rounding.abs(self)

    def __floordiv__(self, other):
        from . import arithmetics

        return arithmetics.floordiv(self, other)

    def __rfloordiv__(self, other):
        from . import arithmetics

        return arithmetics.floordiv(other, self)

    def __mod__(self, other):
        from . import arithmetics

        return arithmetics.mod(self, other)

    def __rmod__(self, other):
        from . import arithmetics

        return arithmetics.mod(other, self)

    def __invert__(self):
        from . import arithmetics

        return arithmetics.invert(self)

    def __and__(self, other):
        from . import arithmetics

        return arithmetics.bitwise_and(self, other)

    def __or__(self, other):
        from . import arithmetics

        return arithmetics.bitwise_or(self, other)

    def __xor__(self, other):
        from . import arithmetics

        return arithmetics.bitwise_xor(self, other)

    def __lshift__(self, other):
        from . import arithmetics

        return arithmetics.left_shift(self, other)

    def __rshift__(self, other):
        from . import arithmetics

        return arithmetics.right_shift(self, other)

    # --------------------------------------------------------- relational
    def __eq__(self, other):
        from . import relational

        return relational.eq(self, other)

    def __ne__(self, other):
        from . import relational

        return relational.ne(self, other)

    def __lt__(self, other):
        from . import relational

        return relational.lt(self, other)

    def __le__(self, other):
        from . import relational

        return relational.le(self, other)

    def __gt__(self, other):
        from . import relational

        return relational.gt(self, other)

    def __ge__(self, other):
        from . import relational

        return relational.ge(self, other)

    # == is elementwise, so a DNDarray cannot be a set member or a dict key
    __hash__ = None

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
        self.__gshape = result.gshape
        self.__dtype = result.dtype
        self.__split = result.split
        return self

    # ----------------------------------------------------------- methods
    def sum(self, axis=None, out=None, keepdims=False):
        from . import arithmetics

        return arithmetics.sum(self, axis=axis, out=out, keepdims=keepdims)

    def prod(self, axis=None, out=None, keepdims=False):
        from . import arithmetics

        return arithmetics.prod(self, axis=axis, out=out, keepdims=keepdims)

    def cumsum(self, axis):
        from . import arithmetics

        return arithmetics.cumsum(self, axis)

    def cumprod(self, axis):
        from . import arithmetics

        return arithmetics.cumprod(self, axis)

    def mean(self, axis=None):
        from . import statistics

        return statistics.mean(self, axis)

    def std(self, axis=None, ddof=0):
        from . import statistics

        return statistics.std(self, axis, ddof=ddof)

    def var(self, axis=None, ddof=0):
        from . import statistics

        return statistics.var(self, axis, ddof=ddof)

    def min(self, axis=None, out=None, keepdims=None):
        from . import statistics

        return statistics.min(self, axis=axis, out=out, keepdims=keepdims)

    def max(self, axis=None, out=None, keepdims=None):
        from . import statistics

        return statistics.max(self, axis=axis, out=out, keepdims=keepdims)

    def argmin(self, axis=None, out=None):
        from . import statistics

        return statistics.argmin(self, axis=axis, out=out)

    def argmax(self, axis=None, out=None):
        from . import statistics

        return statistics.argmax(self, axis=axis, out=out)

    def all(self, axis=None, out=None, keepdims=False):
        from . import logical

        return logical.all(self, axis=axis, out=out, keepdims=keepdims)

    def any(self, axis=None, out=None, keepdims=False):
        from . import logical

        return logical.any(self, axis=axis, out=out, keepdims=keepdims)

    def isclose(self, other, rtol=1e-05, atol=1e-08, equal_nan=False):
        from . import logical

        return logical.isclose(self, other, rtol=rtol, atol=atol, equal_nan=equal_nan)

    def transpose(self, axes=None):
        from .linalg import transpose

        return transpose(self, axes)

    def copy(self):
        from . import memory

        return memory.copy(self)

    def nonzero(self):
        from . import indexing

        return indexing.nonzero(self)

    def abs(self, out=None, dtype=None):
        from . import rounding

        return rounding.abs(self, out=out, dtype=dtype)

    def ceil(self, out=None):
        from . import rounding

        return rounding.ceil(self, out)

    def floor(self, out=None):
        from . import rounding

        return rounding.floor(self, out)

    def round(self, decimals=0, out=None, dtype=None):
        from . import rounding

        return rounding.round(self, decimals, out, dtype)

    def trunc(self, out=None):
        from . import rounding

        return rounding.trunc(self, out)

    def clip(self, a_min, a_max, out=None):
        from . import rounding

        return rounding.clip(self, a_min, a_max, out)

    def exp(self, out=None):
        from . import exponential

        return exponential.exp(self, out)

    def log(self, out=None):
        from . import exponential

        return exponential.log(self, out)

    def sqrt(self, out=None):
        from . import exponential

        return exponential.sqrt(self, out)

    def sin(self, out=None):
        from . import trigonometrics

        return trigonometrics.sin(self, out)

    def cos(self, out=None):
        from . import trigonometrics

        return trigonometrics.cos(self, out)

    def tan(self, out=None):
        from . import trigonometrics

        return trigonometrics.tan(self, out)

    def tanh(self, out=None):
        from . import trigonometrics

        return trigonometrics.tanh(self, out)

    def tril(self, k=0):
        from .linalg import tril

        return tril(self, k)

    def triu(self, k=0):
        from .linalg import triu

        return triu(self, k)

    def __repr__(self) -> str:
        return (
            f"DNDarray({self.numpy()!r}, dtype=ht.{self.__dtype.__name__}, "
            f"device={self.__device}, split={self.__split})"
        )

    __str__ = __repr__
