"""DNDarray — a distributed n-dimensional array over ``torch.Tensor`` shards.

Counterpart of ``heat_tpu/core/dndarray.py``. ``heat_tpu`` wraps one global
``jax.Array`` sharded over a mesh; the port follows Heat's own SPMD model
instead: every process (rank) holds its own tensor of the global array
along ``split`` (the whole array when ``split`` is None). ``numpy()``,
``item()``, ``tolist()`` and ``repr`` give the global value on every rank.

Layouts. An array is in the ceil-div layout (rank r holds the rows of
``comm.chunk``, the layout of ``heat_tpu``'s padded shards, so the last
ranks may hold nothing) unless ``redistribute_`` gave it another partition
of its split extent: then it is *ragged*, and rank r holds exactly
``lcounts[r]`` rows (any number, zero included; no padding, no mask, as in
Heat). ``lshape_map``, ``counts_displs``, ``local_shards``, ``lcounts``,
``balanced`` and ``numpy()`` reflect the map. Elementwise operations,
reductions, cumulative operations, ``nonzero``, ``copy`` and ``astype``
compute on a ragged array in place (:mod:`._operations`); every other
consumer reads :attr:`larray`, which first rebalances the array into the
ceil-div layout in place (``balance_``: one move, counted in
``LAYOUT_STATS["rebalances"]``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _hooks, devices, types
from .communication import TorchCommunication, sanitize_comm
from .devices import Device
from .stride_tricks import sanitize_axis

__all__ = ["DNDarray", "LAYOUT_STATS", "LocalIndex"]

# Rebalances of a ragged array into the ceil-div layout that balance_ carried
# out (a call on a balanced array counts nothing), as heat_tpu counts them.
LAYOUT_STATS = {"rebalances": 0}


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor holding a copy of the numpy array ``a``, of its type. A
    numpy bfloat16 array (``ml_dtypes``', known by its dtype's name) moves
    its bits through an int16 view."""
    if types._is_numpy_bfloat16(a.dtype):
        return torch.from_numpy(np.array(a, order="C", copy=True).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, order="C", copy=True))  # host data is copied, never aliased


def _to_tensor(array, dtype, device: Device) -> torch.Tensor:
    """``array`` as a tensor of heat type ``dtype`` (or inferred) on ``device``."""
    tdev = device.torch_device
    if isinstance(array, torch.Tensor):
        t = array
    else:
        a = np.asarray(array)
        if dtype is None:
            types.canonical_heat_type(a.dtype)  # raises for a type heat does not have
        t = _host_tensor(a)
    tt = None if dtype is None else dtype.torch_type()
    if t.is_meta:  # a layout probe of the lazy layer: meta tensors stay meta
        return t.to(dtype=tt)
    return t.to(device=tdev, dtype=tt)


class LocalIndex:
    """Indexing of this rank's tensor (``DNDarray.lloc``/``loc``): the key
    applies to ``larray``, and the result is a tensor."""

    def __init__(self, obj: torch.Tensor):
        self.obj = obj

    def __getitem__(self, key):
        return self.obj[key]


def _redistribute(
    local: torch.Tensor, axis: int, starts: Sequence[int], counts: Sequence[int], gshape, comm
) -> torch.Tensor:
    """This rank's ceil-div chunk along ``axis`` of an array of ``gshape``
    whose rank r now holds the rows ``[starts[r], starts[r] + counts[r])``
    (contiguous, any lengths): one ``alltoall`` (:func:`._movement.fetch`),
    nothing where the layout is already the ceil-div one."""
    from ._movement import ceil_div_layout, fetch

    t_starts, t_counts = ceil_div_layout(int(gshape[axis]), comm)
    if all(int(starts[q]) == t_starts[q] and int(counts[q]) == t_counts[q] for q in range(comm.size)):
        return local
    return fetch(local, axis, starts, counts, lambda r: [(t_starts[r], t_starts[r] + t_counts[r])], comm)[0]


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
        self.__lcounts = None

    @classmethod
    def _from_ragged(cls, tensor: torch.Tensor, gshape, dtype, split: int, lcounts, device=None,
                     comm=None) -> "DNDarray":
        """An array whose rank r holds exactly ``lcounts[r]`` rows along
        ``split`` (``tensor`` is this rank's), ``heat_tpu``'s ``_from_ragged``.
        ``lcounts`` must partition the split extent. The array stays ragged
        until rebalanced, even where ``lcounts`` is the ceil-div map, as
        ``heat_tpu``'s ``_from_ragged`` leaves every result of the shuffle,
        and computations on a ragged array keep its layout."""
        comm = sanitize_comm(comm)
        gshape = tuple(int(s) for s in gshape)
        lcounts = tuple(int(c) for c in lcounts)
        if len(lcounts) != comm.size or sum(lcounts) != gshape[split] or min(lcounts, default=0) < 0:
            raise ValueError(f"lcounts {lcounts} do not partition extent {gshape[split]} over {comm.size} shards")
        want = list(gshape)
        want[split] = lcounts[comm.rank]
        if tuple(tensor.shape) != tuple(want):
            raise ValueError(f"local tensor of shape {tuple(tensor.shape)} is not rank {comm.rank}'s {tuple(want)} "
                             f"of gshape {gshape} in the layout {lcounts} along {split}")
        out = cls.__new__(cls)
        out.__comm = comm
        out.__device = devices.sanitize_device(device if device is not None else tensor.device)
        out.__dtype = types.canonical_heat_type(dtype if dtype is not None else tensor.dtype)
        out.__split = split
        out.__gshape = gshape
        tdev = None if tensor.is_meta else out.__device.torch_device
        out.__array = tensor.to(device=tdev, dtype=out.__dtype.torch_type())
        out.__lcounts = lcounts
        return out

    # ------------------------------------------------------------------ meta
    @property
    def larray(self) -> torch.Tensor:
        """This rank's tensor: its chunk of the global array in the ceil-div
        layout. A ragged array is rebalanced in place first (``balance_``):
        every consumer that needs the ceil-div chunks (products, ``resplit``,
        indexing, I/O, the estimators) reads this."""
        if self.__lcounts is not None:
            self.balance_()
        return self.__array

    @property
    def _raw(self) -> torch.Tensor:
        """This rank's tensor as it lies, ragged or not: for the operations
        that compute in any layout. Everything else reads :attr:`larray`."""
        return self.__array

    def _logical(self) -> torch.Tensor:
        """The whole global array on this rank: the tensor where the array
        is replicated or the world has size 1, else an ``allgather`` of the
        ranks' rows as they lie (a ragged array is not rebalanced)."""
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
        communicated; a ragged array's counts along the split axis."""
        if self.__lcounts is not None:
            out = np.tile(np.asarray(self.__gshape, dtype=np.int64), (self.__comm.size, 1))
            out[:, self.__split] = self.__lcounts
            return out
        return self.__comm.lshape_map(self.__gshape, self.__split)

    @property
    def ndim(self) -> int:
        return len(self.__gshape)

    @property
    def size(self) -> int:
        return int(np.prod(self.__gshape, dtype=np.int64))

    def is_balanced(self, force_check: bool = False) -> bool:
        """Whether the chunks are in the ceil-div layout: False only after a
        ``redistribute_`` to another partition of the split extent."""
        return self.__lcounts is None

    def balance_(self) -> "DNDarray":
        """Rebalance a ragged array into the ceil-div layout in place: one
        move (:func:`heat_tpu_torch.parallel.flatmove.ragged_move`), counted
        in ``LAYOUT_STATS["rebalances"]``. A balanced array is left as it is
        and nothing is counted."""
        if self.__lcounts is not None:
            _hooks.trace_barrier("balance_")
            LAYOUT_STATS["rebalances"] += 1
            self._ragged_redistribute(self.__comm.counts_displs_shape(self.__gshape, self.__split)[0])
        return self

    def health_check(self, check_values: bool = False) -> "DNDarray":
        """Check this array's distributed invariants (this rank's tensor has
        its row of ``lshape_map`` as shape, ``lshape_map`` partitions the
        split extent, the tensor's type is the annotation's);
        ``check_values=True`` also scans the values for NaN/Inf. Raises
        :class:`heat_tpu_torch.resilience.ValidationError` naming every
        violation; returns ``self`` when healthy."""
        from ..resilience.validate import validate

        return validate(self, check_values=check_values)

    @property
    def balanced(self) -> bool:
        """Whether the chunks are in the ceil-div layout."""
        return self.__lcounts is None

    @property
    def lcounts(self) -> Optional[Tuple[int, ...]]:
        """Every rank's rows along the split axis when the array is ragged,
        else None. Replicated metadata: the same tuple on every rank."""
        return self.__lcounts

    def create_lshape_map(self, force_check: bool = False) -> np.ndarray:
        """The ``lshape_map`` (computed from the layout, never communicated)."""
        return self.lshape_map

    @property
    def pshape(self) -> Tuple[int, ...]:
        """``heat_tpu``'s padded buffer shape: the split extent rounded up to
        the ranks' ceil-div block (a ragged array's largest count) times the
        number of ranks."""
        if self.__split is None:
            return self.__gshape
        shape = list(self.__gshape)
        if self.__lcounts is not None:
            shape[self.__split] = max(1, max(self.__lcounts)) * self.__comm.size
        else:
            shape[self.__split] = -(-shape[self.__split] // self.__comm.size) * self.__comm.size
        return tuple(shape)

    @property
    def padded(self) -> bool:
        """Whether ``heat_tpu``'s buffer of this array would carry padding
        along the split axis (a ragged array's always does)."""
        return self.__lcounts is not None or self.pshape != self.__gshape

    @property
    def local_shards(self) -> list:
        """This rank's shards: its one chunk."""
        return [self.__array]

    def counts_displs(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """Every rank's row count and offset along the split axis."""
        if self.__split is None:
            raise ValueError("Non-distributed DNDarray. Cannot calculate counts and displacements.")
        counts = self.lshape_map[:, self.__split]
        displs = np.concatenate([[0], np.cumsum(counts)[:-1]])
        return tuple(int(c) for c in counts), tuple(int(d) for d in displs)

    def is_distributed(self) -> bool:
        """Whether the data is split over more than one rank."""
        return self.__split is not None and self.__comm.is_distributed()

    @property
    def gnumel(self) -> int:
        return self.size

    @property
    def lnumel(self) -> int:
        return int(np.prod(self.lshape, dtype=np.int64))

    @property
    def nbytes(self) -> int:
        return self.size * self.__array.element_size()

    @property
    def gnbytes(self) -> int:
        return self.nbytes

    @property
    def lnbytes(self) -> int:
        return self.lnumel * self.__array.element_size()

    @property
    def stride(self) -> Tuple[int, ...]:
        """Element strides of the C-contiguous global array."""
        strides, acc = [], 1
        for dim in reversed(self.__gshape):
            strides.append(acc)
            acc *= dim
        return tuple(reversed(strides))

    @property
    def strides(self) -> Tuple[int, ...]:
        """Byte strides of the C-contiguous global array, numpy-style."""
        item = self.__array.element_size()
        return tuple(s * item for s in self.stride)

    @property
    def real(self) -> "DNDarray":
        from . import complex_math

        return complex_math.real(self)

    @property
    def imag(self) -> "DNDarray":
        from . import complex_math

        return complex_math.imag(self)

    @property
    def loc(self) -> LocalIndex:
        return LocalIndex(self.larray)

    @property
    def lloc(self) -> LocalIndex:
        """Indexing of this rank's tensor (``larray``)."""
        return LocalIndex(self.larray)

    def cpu(self) -> "DNDarray":
        """A copy of the whole array on the host: split None, on the CPU
        device, on every rank."""
        return DNDarray(self._logical().detach().cpu().clone(), gshape=self.__gshape, dtype=self.__dtype, split=None,
                        device=devices.cpu, comm=self.__comm)

    def fill_diagonal(self, value) -> "DNDarray":
        """Write ``value`` on the main diagonal of a 2-D array, in place of
        this object (each rank writes the part of the diagonal its chunk
        holds)."""
        if self.ndim != 2:
            raise ValueError("input array must be 2D")
        n = min(self.__gshape)
        new = self.larray.clone()
        off = self.__comm.chunk(self.__gshape, self.__split)[0]
        lo = off if self.__split is not None else 0
        hi = min(n, lo + (self.lshape[self.__split] if self.__split is not None else n))
        idx = torch.arange(max(lo, 0), max(hi, lo), device=new.device)
        if idx.numel():
            rows = idx - off if self.__split == 0 else idx
            cols = idx - off if self.__split == 1 else idx
            new[rows, cols] = torch.as_tensor(value, device=new.device).to(new.dtype)
        self.__array = new
        return self

    # --------------------------------------------------------------- halos
    def get_halo(self, halo_size: int) -> None:
        """Fetch the split-axis halos of width ``halo_size``: afterwards
        ``halo_prev`` holds the last ``halo_size`` rows of the previous
        rank's chunk and ``halo_next`` the first ``halo_size`` rows of the
        next rank's. As in ``heat_tpu``, a boundary where either side holds
        fewer than ``halo_size`` rows carries no halo (that side gets None).
        Every rank calls it: one batch of at most two sends and two
        receives per rank, counted as ``"halo"`` in ``COLLECTIVES``. The
        halos are those of the values at the time of the call."""
        if not isinstance(halo_size, int) or halo_size < 0:
            raise (TypeError if not isinstance(halo_size, int) else ValueError)(
                f"halo_size needs to be a non-negative int, got {halo_size}"
            )
        self.__halo_size = halo_size
        self.__halos = (None, None)
        split, comm = self.__split, self.__comm
        if halo_size == 0 or split is None or not comm.is_distributed():
            return
        counts = self.lshape_map[:, split]
        me, t = comm.rank, self.__array

        def carries(b: int) -> bool:  # the boundary between ranks b - 1 and b
            return 0 < b < comm.size and counts[b - 1] >= halo_size and counts[b] >= halo_size

        shape = list(t.shape)
        shape[split] = halo_size
        sends, recvs = {}, {}
        if carries(me):
            sends[me - 1] = t.narrow(split, 0, halo_size)
            recvs[me - 1] = tuple(shape)
        if carries(me + 1):
            sends[me + 1] = t.narrow(split, t.shape[split] - halo_size, halo_size)
            recvs[me + 1] = tuple(shape)
        got = comm.exchange("halo", sends, recvs, t)
        self.__halos = (got.get(me - 1), got.get(me + 1))

    @property
    def halo_size(self) -> int:
        return getattr(self, "_DNDarray__halo_size", 0)

    @property
    def halo_prev(self) -> Optional[torch.Tensor]:
        """The rows received from the previous rank by :meth:`get_halo`, or None."""
        return getattr(self, "_DNDarray__halos", (None, None))[0]

    @property
    def halo_next(self) -> Optional[torch.Tensor]:
        """The rows received from the next rank by :meth:`get_halo`, or None."""
        return getattr(self, "_DNDarray__halos", (None, None))[1]

    def array_with_halos(self) -> torch.Tensor:
        """This rank's chunk with its halos on either side along the split
        axis: ``cat(halo_prev, larray, halo_next)``."""
        parts = [h for h in (self.halo_prev, self.__array, self.halo_next) if h is not None]
        return torch.cat(parts, dim=self.__split) if len(parts) > 1 else self.__array

    # ----------------------------------------------------------- conversion
    def __resplit_tensor(self, axis: Optional[int]) -> torch.Tensor:
        """This rank's tensor of the array split along ``axis``: a local
        slice (None -> a), an ``allgather`` (a -> None) or an ``alltoall``
        (a -> b). A ragged array is rebalanced first."""
        t = self.larray
        src, comm = self.__split, self.__comm
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
        """A copy split along ``axis``, in the ceil-div layout (a ragged
        array is rebalanced in place first, as in ``heat_tpu``)."""
        axis = sanitize_axis(self.__gshape, axis)
        t = self.__resplit_tensor(axis)
        if t is self.__array:
            t = t.clone()
        return DNDarray(t, gshape=self.__gshape, dtype=self.__dtype, split=axis, device=self.__device, comm=self.__comm)

    def resplit_(self, axis: Optional[int] = None) -> "DNDarray":
        """Split this array along ``axis`` in place; the split it has already
        leaves it as it is (a ragged layout too)."""
        axis = sanitize_axis(self.__gshape, axis)
        if axis == self.__split:
            return self
        self.__array = self.__resplit_tensor(axis)
        self.__split = axis
        return self

    def astype(self, dtype, copy: bool = True) -> "DNDarray":
        """Cast to ``dtype``; ``copy=False`` casts in place of this object.
        The layout is kept: a ragged array casts its rows where they lie."""
        dtype = types.canonical_heat_type(dtype)
        casted = self.__array.to(dtype.torch_type())
        if not copy:
            self.__array = casted
            self.__dtype = dtype
            return self
        if casted is self.__array:
            casted = casted.clone()
        if self.__lcounts is not None:
            return DNDarray._from_ragged(casted, self.__gshape, dtype, self.__split, self.__lcounts, self.__device,
                                         self.__comm)
        return DNDarray(casted, gshape=self.__gshape, dtype=dtype, split=self.__split, device=self.__device, comm=self.__comm)

    def numpy(self) -> np.ndarray:
        """The global array as a numpy array on the host, on every rank. numpy
        has no bfloat16, so a bfloat16 array comes back as float32, which
        holds every bfloat16 value exactly. A ragged array is gathered as it
        lies and keeps its layout (``heat_tpu`` rebalances it first).
        Reported to the observers as ``"host.gather"``."""
        _hooks.observe("host.gather", shape=self.__gshape)
        t = self._logical().detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def item(self):
        """The single element as a python scalar (``"host.item"``)."""
        _hooks.observe("host.item")
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
            _hooks.observe("host.scalar")
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
    def __normalize_key(self, key) -> tuple:
        """``key`` as a tuple with ``...`` expanded: array-likes become
        tensors on this array's device, DNDarrays stay themselves."""
        if not isinstance(key, tuple):
            key = (key,)

        def conv(k):
            if isinstance(k, DNDarray) or k is None or k is Ellipsis or isinstance(k, (slice, bool, np.bool_)):
                return k
            if isinstance(k, (int, np.integer)):
                return int(k)
            if isinstance(k, (list, np.ndarray, torch.Tensor)):
                return torch.as_tensor(np.asarray(k) if isinstance(k, list) else k).to(self.__array.device)
            raise TypeError(f"index of type {type(k).__name__} is not supported")

        key = tuple(conv(k) for k in key)

        def consumed(k):
            if k is None or k is Ellipsis or isinstance(k, (bool, np.bool_)):
                return 0
            if isinstance(k, DNDarray) and k.dtype is types.bool or isinstance(k, torch.Tensor) and k.dtype == torch.bool:
                return k.ndim
            return 1

        n_spec = sum(consumed(k) for k in key)
        ells = [i for i, k in enumerate(key) if k is Ellipsis]
        if len(ells) > 1:
            raise IndexError("an index can only have a single ellipsis ('...')")
        if ells:
            i = ells[0]
            key = key[:i] + (slice(None),) * (self.ndim - n_spec) + key[i + 1 :]
            n_spec = self.ndim
        if n_spec > self.ndim:
            raise IndexError(f"too many indices for DNDarray: {self.ndim}-dimensional, {n_spec} indexed")
        return key

    @staticmethod
    def __is_basic(key) -> bool:
        return all(isinstance(k, (int, slice)) and not isinstance(k, bool) for k in key)

    def __getitem__(self, key) -> "DNDarray":
        """Indexing with ints, slices (any step), ``...``, ``None``, bool
        masks and integer arrays, with ``heat_tpu``'s split rules: the split
        axis survives a slice and shifts past dimensions removed by ints; an
        int on the split axis replicates the result; an advanced index on
        the split axis makes it split 0.

        Across ranks: an int on the split axis is broadcast by the rank that
        owns it; a slice of the split axis keeps each rank's share and
        rebalances it to the ceil-div layout (one ``alltoall``), a negative
        step then fetches the mirror image; a bool mask of a split-0 array's
        shape selects on every rank and rebalances; an integer array on
        split axis 0 fetches the rows it names; other keys index the
        gathered array. A ragged array is rebalanced first."""
        self.balance_()
        if isinstance(key, DNDarray) and key.ndim == 2 and self.ndim > 1 and key.gshape[1] == self.ndim \
                and types.heat_type_is_exact(key.dtype) and key.dtype is not types.bool:
            # a coordinate list, as nonzero gives it: one row per element
            coords = key._logical()
            return self.__advanced(tuple(coords[:, d] for d in range(self.ndim)), 0 if self.__split is not None else None)
        key = self.__normalize_key(key)
        if self.__is_basic(key):
            return self.__basic_getitem(key)
        if len(key) == 1 and isinstance(key[0], DNDarray) and key[0].dtype is types.bool \
                and key[0].gshape == self.__gshape and self.__split == 0 and self.__comm.is_distributed():
            return self.__mask_getitem(key[0])
        key = tuple(k._logical() if isinstance(k, DNDarray) else k for k in key)
        rows = self.__split_rows_key(key)
        if rows is not None:
            return self.__take_split_rows(rows)
        return self.__advanced(key, self.__advanced_split(key))

    def __advanced_split(self, key) -> Optional[int]:
        """The result's split for an advanced key (``heat_tpu``'s rule)."""
        split = self.__split
        if split is None:
            return None
        in_dim = out_dim = 0
        out_split = None
        for k in key:
            if k is None or isinstance(k, (bool, np.bool_)):
                out_dim += 1
                continue
            if in_dim == split:
                if isinstance(k, slice):
                    out_split = out_dim
                elif not isinstance(k, int):
                    out_split = 0
                in_dim += 1
                out_dim += 0 if isinstance(k, int) else 1
                continue
            if isinstance(k, int):
                in_dim += 1
            elif isinstance(k, slice):
                in_dim += 1
                out_dim += 1
            else:
                in_dim += k.ndim if k.dtype == torch.bool else 1
                out_dim += 1
        if in_dim <= split and out_split is None:
            out_split = out_dim + (split - in_dim)
        return out_split

    def __advanced(self, key, out_split) -> "DNDarray":
        """Any key on the gathered array; this rank keeps its chunk."""
        dim = 0
        for k in key:
            if isinstance(k, int):
                n = self.__gshape[dim]
                if not -n <= k < n:
                    raise IndexError(f"index {k} is out of bounds for axis {dim} with size {n}")
            if k is not None and not isinstance(k, (bool, np.bool_)):
                dim += k.ndim if isinstance(k, torch.Tensor) and k.dtype == torch.bool else 1
        result = self._logical()[key]
        if result.ndim == 0:
            out_split = None
        comm = self.__comm
        t = result[comm.chunk(tuple(result.shape), out_split)[2]] if out_split is not None else result
        return DNDarray(t, gshape=tuple(result.shape), dtype=self.__dtype, split=out_split, device=self.__device,
                        comm=comm)

    def __split_rows_key(self, key):
        """The global rows (numpy, non-negative) of a key that is one 1-D
        integer array on split axis 0 followed by full slices, or None."""
        if self.__split != 0 or not self.__comm.is_distributed():
            return None
        first = key[0]
        if not isinstance(first, torch.Tensor) or first.dtype == torch.bool or first.ndim != 1:
            return None
        if any(not (isinstance(k, slice) and k == slice(None)) for k in key[1:]):
            return None
        n = self.__gshape[0]
        rows = first.to(torch.int64).cpu().numpy()
        if rows.size and (rows.min() < -n or rows.max() >= n):
            raise IndexError(f"index out of bounds for axis 0 with size {n}")
        return np.where(rows < 0, rows + n, rows)

    def __take_split_rows(self, rows: np.ndarray) -> "DNDarray":
        """An integer array on split axis 0: each rank fetches the rows of its
        result chunk (split 0)."""
        from ._movement import take_rows

        comm = self.__comm
        gshape = (rows.size,) + self.__gshape[1:]

        def want(r):
            lo, sh, _ = comm.chunk(gshape, 0, rank=r)
            return rows[lo : lo + sh[0]]

        t = take_rows(self.__array, self.__gshape, 0, want, comm)
        return DNDarray(t, gshape=gshape, dtype=self.__dtype, split=0, device=self.__device, comm=comm)

    def __mask_getitem(self, mask: "DNDarray") -> "DNDarray":
        """A bool mask of a split-0 array's shape: every rank selects from its
        chunk (row-major order is rank order), then the selection is
        rebalanced (one ``alltoall``)."""
        comm = self.__comm
        m = mask.larray if mask.split == 0 else mask.resplit(0).larray
        sel = self.__array[m]
        counts = comm.allgather(torch.tensor([sel.numel()], dtype=torch.int64, device=comm.device()), 0,
                                [1] * comm.size).tolist()
        starts = [sum(counts[:q]) for q in range(comm.size)]
        gshape = (sum(counts),)
        return DNDarray(_redistribute(sel, 0, starts, counts, gshape, comm), gshape=gshape, dtype=self.__dtype,
                        split=0, device=self.__device, comm=comm)

    def __basic_key(self, key):
        """``(global key, selection shape, reversed selection axes)``: every
        slice with a positive step (a negative one selects the same elements
        in reverse, so its selection axis is listed) and every int
        non-negative."""
        key = key + (slice(None),) * (self.ndim - len(key))
        gkey, shape, rev = [], [], []
        for d, (k, n) in enumerate(zip(key, self.__gshape)):
            if isinstance(k, slice):
                start, stop, step = k.indices(n)
                m = len(range(start, stop, step))
                if step < 0:
                    rev.append(len(shape))
                    start, stop, step = (start + step * (m - 1), start + 1, -step) if m else (0, 0, 1)
                gkey.append(slice(start, stop, step))
                shape.append(m)
            else:
                i = int(k)
                if not -n <= i < n:
                    raise IndexError(f"index {i} is out of bounds for axis {d} with size {n}")
                gkey.append(i % n)
        return gkey, shape, rev

    def __basic_getitem(self, key) -> "DNDarray":
        """Ints and slices (any step)."""
        gkey, gshape, flips = self.__basic_key(key)
        res = self.__positive_getitem(gkey, gshape)
        if flips:
            from .manipulations import flip

            res = flip(res, tuple(flips))
        return res

    def __positive_getitem(self, gkey, gshape) -> "DNDarray":
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
        off = comm.chunk(self.__gshape, split)[0]
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
        starts, counts, lkey = self.__slice_shares(gkey)
        local = self.__array[tuple(lkey)]
        local = _redistribute(local, out_split, starts, counts, tuple(gshape), comm)
        return DNDarray(local, gshape=tuple(gshape), split=out_split, **meta)

    def __slice_shares(self, gkey):
        """For a positive-step slice of the split axis: where each rank's
        selected rows start in the selection, how many there are, and this
        rank's local key."""
        comm, split = self.__comm, self.__split
        start, stop, step = gkey[split].start, gkey[split].stop, gkey[split].step
        length = len(range(start, stop, step))
        starts, counts = [], []
        for r in range(comm.size):
            o, ls, _ = comm.chunk(self.__gshape, split, rank=r)
            j0 = min(length, max(0, -(-(o - start) // step)))
            j1 = min(length, max(0, -(-(o + ls[split] - start) // step)))
            starts.append(j0)
            counts.append(max(0, j1 - j0))
        off = comm.chunk(self.__gshape, split)[0]
        lkey = list(gkey)
        j0 = starts[comm.rank]
        first = start + j0 * step - off
        lkey[split] = slice(first, first + counts[comm.rank] * step, step) if counts[comm.rank] else slice(0, 0)
        return starts, counts, lkey

    def __setitem__(self, key, value) -> None:
        """Write ``value`` (broadcast to the selection, cast to this array's
        dtype) where ``key`` selects. As in ``heat_tpu`` the array's tensor
        is replaced, never written in place, so arrays handed out earlier
        keep their values.

        Across ranks: with ints and slices (any step) each rank writes the
        rows of its chunk, taking its part of a replicated value locally and
        of a split value by fetching it (one ``alltoall``); a bool mask of
        the array's shape writes on every rank: a scalar locally, a 1-D
        value of one entry per selected element by the exclusive scan of the
        ranks' counts; an integer array on split axis 0 writes on the owners
        of its rows; other keys write into the gathered array. A ragged
        array is rebalanced first."""
        self.balance_()
        if isinstance(key, DNDarray) and key.dtype is types.bool and key.gshape == self.__gshape:
            return self.__mask_setitem(key, value)
        nkey = self.__normalize_key(key)
        if self.__is_basic(nkey):
            return self.__basic_setitem(nkey, value)
        nkey = tuple(k._logical() if isinstance(k, DNDarray) else k for k in nkey)
        comm = self.__comm
        rows = self.__split_rows_key(nkey)
        if rows is not None:
            vals = torch.broadcast_to(self.__value_tensor(value), (rows.size,) + self.__gshape[1:])
            off, lshape, _ = comm.chunk(self.__gshape, 0)
            mine = np.nonzero((rows >= off) & (rows < off + lshape[0]))[0]
            new = self.__array.clone()
            if mine.size:
                at = torch.as_tensor(mine, device=new.device)
                new[torch.as_tensor(rows[mine] - off, device=new.device)] = vals[at]
            self.__array = new
            return
        whole = self._logical().clone()
        whole[nkey] = self.__value_tensor(value)
        if self.__split is not None and comm.is_distributed():
            whole = whole[comm.chunk(self.__gshape, self.__split)[2]].clone()
        self.__array = whole

    def __value_tensor(self, value) -> torch.Tensor:
        """``value`` whole on every rank, in this array's dtype and device."""
        tt, dev = self.__dtype.torch_type(), self.__array.device
        if isinstance(value, DNDarray):
            return value._logical().to(device=dev, dtype=tt)
        return torch.as_tensor(np.asarray(value) if isinstance(value, list) else value, device=dev).to(tt)

    def __mask_setitem(self, mask: "DNDarray", value) -> None:
        comm, split = self.__comm, self.__split
        if mask.split != split:
            mask = mask.resplit(split)
        m = mask.larray
        tt = self.__dtype.torch_type()
        if isinstance(value, DNDarray) and value.ndim == 0 or not isinstance(value, DNDarray) and np.ndim(value) == 0:
            self.__array = torch.where(m, self.__value_tensor(value), self.__array)
            return
        if split not in (None, 0) and comm.is_distributed():
            # row-major order interleaves the ranks: write into the gathered array
            whole = self._logical().clone()
            whole[mask._logical()] = self.__value_tensor(value)
            self.__array = whole[comm.chunk(self.__gshape, split)[2]].clone()
            return
        if split is None or not comm.is_distributed():
            vals = self.__value_tensor(value)
        else:
            count = int(m.sum())
            counts = comm.allgather(torch.tensor([count], dtype=torch.int64, device=comm.device()), 0,
                                    [1] * comm.size).tolist()
            starts = [sum(counts[:q]) for q in range(comm.size)]
            if isinstance(value, DNDarray) and value.split == 0 and value.ndim == 1:
                from ._movement import take_intervals

                vals = take_intervals(value.larray, value.gshape, 0,
                                      lambda r: [(starts[r], starts[r] + counts[r])], comm)[0].to(tt)
            else:
                full = self.__value_tensor(value)
                vals = full[starts[comm.rank] : starts[comm.rank] + count] if full.ndim == 1 and \
                    full.shape[0] == sum(counts) else full
        new = self.__array.clone()
        new[m] = vals
        self.__array = new

    def __basic_setitem(self, key, value) -> None:
        gkey, sel_shape, rev = self.__basic_key(key)
        comm, split = self.__comm, self.__split
        if split is None or not comm.is_distributed():
            vals, lkey = torch.broadcast_to(self.__value_tensor(value), tuple(sel_shape)), gkey
        elif isinstance(gkey[split], int):
            off, lshape, _ = comm.chunk(self.__gshape, split)
            whole = self.__value_tensor(value)  # a split DNDarray value is gathered by every rank
            if not off <= gkey[split] < off + lshape[split]:
                return  # another rank owns the row
            vals = torch.broadcast_to(whole, tuple(sel_shape))
            lkey = list(gkey)
            lkey[split] -= off
        else:
            # the selection's axis that meets the split axis
            vsplit = split - sum(1 for k in gkey[:split] if isinstance(k, int))
            starts, counts, lkey = self.__slice_shares(gkey)
            vals = self.__value_part(value, tuple(sel_shape), vsplit, starts, counts, vsplit in rev)
        if rev:
            vals = torch.flip(vals, rev)
        new = self.__array.clone()
        new[tuple(lkey)] = vals
        self.__array = new

    def __value_part(self, value, sel_shape, vsplit: int, starts, counts, reverse: bool) -> torch.Tensor:
        """This rank's rows along ``vsplit`` of ``value`` broadcast to
        ``sel_shape``, in the order of the positive-step selection (counted
        from the other end where ``reverse``): fetched from a value split
        along that axis, else sliced from the whole value."""
        comm = self.__comm
        m = sel_shape[vsplit]

        def rows(r):
            a = m - starts[r] - counts[r] if reverse else starts[r]
            return a, a + counts[r]

        lead = len(sel_shape) - (value.ndim if isinstance(value, DNDarray) else np.ndim(value))
        if isinstance(value, DNDarray) and value.split is not None and value.split + lead == vsplit \
                and value.gshape[value.split] == m:
            from ._movement import take_intervals

            got = take_intervals(value.larray, value.gshape, value.split, lambda r: [rows(r)], comm)[0]
            shape = list(sel_shape)
            shape[vsplit] = counts[comm.rank]
            return torch.broadcast_to(got.to(self.__dtype.torch_type()), shape)
        a, b = rows(comm.rank)
        return torch.broadcast_to(self.__value_tensor(value), sel_shape).narrow(vsplit, a, b - a)

    # ---------------------------------------------------------- manipulations
    def reshape(self, *shape, new_split=None) -> "DNDarray":
        from . import manipulations

        return manipulations.reshape(self, *shape, new_split=new_split)

    def flatten(self) -> "DNDarray":
        from . import manipulations

        return manipulations.flatten(self)

    def ravel(self) -> "DNDarray":
        from . import manipulations

        return manipulations.ravel(self)

    def squeeze(self, axis=None) -> "DNDarray":
        from . import manipulations

        return manipulations.squeeze(self, axis)

    def expand_dims(self, axis: int) -> "DNDarray":
        from . import manipulations

        return manipulations.expand_dims(self, axis)

    def flip(self, axis=None) -> "DNDarray":
        from . import manipulations

        return manipulations.flip(self, axis)

    def unique(self, sorted: bool = False, return_inverse: bool = False, axis=None):
        from . import manipulations

        return manipulations.unique(self, sorted=sorted, return_inverse=return_inverse, axis=axis)

    def redistribute_(self, lshape_map=None, target_map=None) -> "DNDarray":
        """Move the rows into the layout ``target_map``, a (size, ndim) map of
        every rank's shape, in place (``heat_tpu``'s rules and messages):

        - the current map: nothing moves;
        - any other partition of the split extent (skewed, empty ranks): one
          move (:func:`heat_tpu_torch.parallel.flatmove.ragged_move`); the
          array is ragged afterwards unless the map is the ceil-div one;
        - the ceil-div map of another split axis: ``resplit_``.

        ``lshape_map``, where given, must describe the current layout."""
        current = self.lshape_map
        if lshape_map is not None:
            given = np.asarray(lshape_map)
            if given.shape != current.shape or not np.array_equal(given, current):
                raise ValueError(
                    f"lshape_map {given.tolist()} does not describe this array's current layout {current.tolist()}"
                )
        if target_map is None:
            return self
        target = np.asarray(target_map)
        size, ndim = self.__comm.size, self.ndim
        if target.shape != (size, ndim):
            raise ValueError(f"target_map must have shape {(size, ndim)}, got {target.shape}")
        if (target < 0).any():
            raise ValueError("target_map entries must be non-negative")
        if np.array_equal(target, current):
            return self
        split = self.__split
        if split is not None:
            counts = target[:, split]
            if all((target[:, k] == self.__gshape[k]).all() for k in range(ndim) if k != split) \
                    and int(counts.sum()) == self.__gshape[split]:
                return self._ragged_redistribute(tuple(int(c) for c in counts))
        for axis in ([split] if split is not None else []) + [k for k in range(ndim) if k != split]:
            if np.array_equal(target, self.__comm.lshape_map(self.__gshape, axis)):
                return self.resplit_(axis)
        raise ValueError(
            "target_map neither partitions the split extent nor matches the canonical layout of any split axis"
        )

    def _ragged_redistribute(self, counts: Tuple[int, ...]) -> "DNDarray":
        """Move the rows along the split axis, in place, so that rank r holds
        ``counts[r]`` of them: one ``ragged_move``, nothing where the layout
        is already that one. Every rank calls it with the same counts."""
        from ..parallel.flatmove import ragged_move

        split = self.__split
        counts = tuple(int(c) for c in counts)
        current = tuple(int(c) for c in self.lshape_map[:, split])
        if counts == current:
            return self
        self.__array = ragged_move(self.__array, split, current, counts, self.__comm)
        canonical = self.__comm.counts_displs_shape(self.__gshape, split)[0]
        self.__lcounts = None if counts == tuple(canonical) else counts
        return self

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
        self.__array = result._raw
        self.__lcounts = result.lcounts
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
        from . import printing

        return printing.__str__(self)

    __str__ = __repr__
