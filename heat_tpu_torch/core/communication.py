"""Communication bookkeeping (counterpart of ``heat_tpu/core/communication.py``).

This slice of the port runs on one card, so its communicator has world
size 1. It keeps the interface the rest of the package speaks — ``size``,
``rank``, the ceil-div ``chunk`` partition, ``counts_displs_shape`` and
``lshape_map`` — with the same arithmetic as ``heat_tpu``, so that a split
array's metadata reads the same in both packages. A world size above 1
(``torch.distributed`` over NCCL) is the multi-card slice of the port.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = [
    "Communication",
    "TorchCommunication",
    "WORLD",
    "get_comm",
    "use_comm",
    "sanitize_comm",
]


class Communication:
    """Base class for communication backends."""

    @staticmethod
    def is_distributed() -> bool:
        raise NotImplementedError()

    def chunk(self, shape, split, rank=None) -> Tuple[int, Tuple[int, ...], Tuple[slice, ...]]:
        raise NotImplementedError()


class TorchCommunication(Communication):
    """A single-process communicator.

    Parameters
    ----------
    size : int
        World size. Only 1 is supported in this slice.
    """

    def __init__(self, size: int = 1):
        if int(size) != 1:
            raise NotImplementedError(
                "heat_tpu_torch runs at world size 1; split arrays over several cards "
                "(torch.distributed over NCCL) are the port's multi-card slice"
            )
        self._size = 1

    @property
    def size(self) -> int:
        return self._size

    @property
    def rank(self) -> int:
        return 0

    def is_distributed(self) -> bool:
        return self.size > 1

    def chunk(
        self, shape, split: Optional[int], rank: Optional[int] = None
    ) -> Tuple[int, Tuple[int, ...], Tuple[slice, ...]]:
        """The shard of ``shape`` owned by ``rank`` along ``split``:
        ``(offset, local_shape, slices)`` in the ceil-div layout."""
        shape = tuple(int(s) for s in shape)
        if split is None:
            return 0, shape, tuple(slice(0, s) for s in shape)
        rank = self.rank if rank is None else rank
        n = shape[split]
        block = -(-n // self.size) if n else 0
        start = min(rank * block, n)
        end = min(start + block, n)
        lshape = list(shape)
        lshape[split] = end - start
        slices = tuple(slice(start, end) if i == split else slice(0, s) for i, s in enumerate(shape))
        return start, tuple(lshape), slices

    def counts_displs_shape(self, shape, split: int):
        """Per-rank counts/displacements along ``split``."""
        shape = tuple(int(s) for s in shape)
        n = shape[split]
        block = -(-n // self.size) if n else 0
        counts, displs = [], []
        for r in range(self.size):
            start = min(r * block, n)
            counts.append(min(start + block, n) - start)
            displs.append(start)
        output_shape = list(shape)
        output_shape[split] = block
        return tuple(counts), tuple(displs), tuple(output_shape)

    def lshape_map(self, shape, split: Optional[int]) -> np.ndarray:
        """(size, ndim) array of every shard's local shape."""
        shape = tuple(int(s) for s in shape)
        out = np.empty((self.size, len(shape)), dtype=np.int64)
        for r in range(self.size):
            out[r] = self.chunk(shape, split, rank=r)[1] if len(shape) else ()
        return out

    def __repr__(self) -> str:
        return f"TorchCommunication(size={self.size})"

    def __eq__(self, other) -> bool:
        return isinstance(other, TorchCommunication) and self.size == other.size

    def __hash__(self):
        return hash((TorchCommunication, self.size))


WORLD = TorchCommunication()

_default_comm = WORLD


def get_comm() -> TorchCommunication:
    """The current default communicator."""
    return _default_comm


def use_comm(comm: Optional[TorchCommunication] = None) -> None:
    """Set the default communicator."""
    global _default_comm
    if comm is None:
        comm = WORLD
    if not isinstance(comm, Communication):
        raise TypeError(f"expected a Communication object, got {type(comm)}")
    _default_comm = comm


def sanitize_comm(comm) -> TorchCommunication:
    """Default-or-validate a communicator."""
    if comm is None:
        return get_comm()
    if not isinstance(comm, Communication):
        raise TypeError(f"expected a Communication object, got {type(comm)}")
    return comm
