"""Tiles of a distributed array (counterpart of ``heat_tpu/core/tiling.py``).

- :class:`SplitTiles`: world-size tiles in every dimension, their global
  ends, extents and owners (ownership follows the split axis);
- :class:`SquareDiagTiles`: the square tiles along the diagonal of a 2-D
  array, their global starts and their count per rank; the blocked
  factorizations read its geometry through :func:`factor_block_edge`, the
  panel width of the distributed ``cholesky`` and ``solve_triangular``.

Both are tile views: ``tiles[key]`` (an int or a slice of tile indices per
dimension) is the tile's global slab as a host numpy array, fetched through
the array's ``__getitem__`` (only the tile's rows move, then they are
gathered), and ``tiles[key] = value`` writes through the array's
``__setitem__``. Each access costs one collective step, so a loop over many
tiles should batch its writes into one setitem. The geometry is that of the
ceil-div layout; a ragged array is rebalanced by the first access.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .dndarray import DNDarray

__all__ = ["SplitTiles", "SquareDiagTiles", "factor_block_edge"]


def factor_block_edge(arr: DNDarray, tiles_per_proc: int, mi: int) -> int:
    """Panel width of the blocked factorizations over a row-split ``arr``
    with ``mi`` rows per rank (the ceil-div chunk): the ``SquareDiagTiles``
    row-tile edge for ``tiles_per_proc``, snapped down to the largest
    divisor of ``mi``, so that a panel never straddles two ranks."""
    mi = max(1, int(mi))
    if tiles_per_proc <= 1 or mi <= 1:
        return mi
    ri = SquareDiagTiles(arr, tiles_per_proc).row_indices
    edge = ri[1] - ri[0] if len(ri) > 1 else mi
    edge = max(1, min(int(edge), mi))
    while mi % edge:
        edge -= 1
    return edge


def _tile_range(ends, k) -> slice:
    """The global slice covered by tile ``k`` (an int, or a slice of tile
    indices with step 1) of a dimension whose tiles end at ``ends``."""
    n_tiles = len(ends)
    if isinstance(k, slice):
        if k.step not in (None, 1):
            raise IndexError("tile views cover contiguous tile ranges; slice step must be 1")
        idxs = range(*k.indices(n_tiles))
        if len(idxs) == 0:
            return slice(0, 0)
        start = 0 if idxs[0] == 0 else int(ends[idxs[0] - 1])
        return slice(start, int(ends[idxs[-1]]))
    k = int(k)
    if k < 0:
        k += n_tiles
    if not 0 <= k < n_tiles:
        raise IndexError(f"tile index {k} out of range for {n_tiles} tiles")
    return slice(0 if k == 0 else int(ends[k - 1]), int(ends[k]))


class SplitTiles:
    """World-size tiles in every dimension: ``tile_ends_g[d]`` holds the
    global end of each tile along dimension d (the ceil-div blocks),
    ``tile_locations`` the rank owning each tile (the rank of its block
    along the split axis; rank 0 for a replicated array)."""

    def __init__(self, arr: DNDarray):
        if not isinstance(arr, DNDarray):
            raise TypeError(f"arr must be a DNDarray, got {type(arr)}")
        self.__arr = arr
        size = arr.comm.size
        ends = []
        for length in arr.gshape:
            block = -(-length // size) if length else 0
            ends.append(np.minimum((np.arange(size) + 1) * block, length))
        self.__tile_ends_g = np.stack(ends) if ends else np.zeros((0, size), dtype=np.int64)
        locs = np.zeros((size,) * arr.ndim, dtype=np.int64)
        if arr.split is not None:
            reshape = [1] * arr.ndim
            reshape[arr.split] = size
            locs = locs + np.arange(size).reshape(reshape)
        self.__tile_locations = locs

    @property
    def arr(self) -> DNDarray:
        return self.__arr

    @property
    def tile_ends_g(self) -> np.ndarray:
        """(ndim, size) global end indices of the tiles."""
        return self.__tile_ends_g

    @property
    def tile_locations(self) -> np.ndarray:
        """The size^ndim map of each tile's owner."""
        return self.__tile_locations

    @property
    def tile_dimensions(self) -> np.ndarray:
        """(ndim, size) tile extents."""
        starts = np.zeros_like(self.__tile_ends_g)
        starts[:, 1:] = self.__tile_ends_g[:, :-1]
        return self.__tile_ends_g - starts

    def _tile_slices(self, key) -> Tuple[slice, ...]:
        key = key if isinstance(key, tuple) else (key,)
        return tuple(_tile_range(self.__tile_ends_g[dim], k) for dim, k in enumerate(key))

    def __getitem__(self, key) -> Optional[np.ndarray]:
        """The global slab of tile ``key``, on the host, on every rank."""
        return self.__arr[self._tile_slices(key)].numpy()

    def __setitem__(self, key, value) -> None:
        """Write ``value`` into tile ``key`` through the array's setitem."""
        self.__arr[self._tile_slices(key)] = value


class SquareDiagTiles:
    """Square tiles along the diagonal of a 2-D array: the tile edge is the
    ceil-div block of the split axis cut into ``tiles_per_proc`` parts;
    tiles belong to ranks along the split axis only."""

    def __init__(self, arr: DNDarray, tiles_per_proc: int = 1):
        if not isinstance(arr, DNDarray):
            raise TypeError(f"arr must be a DNDarray, got {type(arr)}")
        if arr.ndim != 2:
            raise ValueError("arr must be 2D")
        if tiles_per_proc < 1:
            raise ValueError("tiles_per_proc must be >= 1")
        self.__arr = arr
        size = arr.comm.size
        m, n = arr.gshape
        split = arr.split if arr.split is not None else 0
        block = -(-arr.gshape[split] // size)
        tile = max(1, -(-block // tiles_per_proc))
        self.__row_inds = list(range(0, m, tile))
        self.__col_inds = list(range(0, n, tile))
        self.__tile_rows = len(self.__row_inds)
        self.__tile_cols = len(self.__col_inds)
        if split == 0:
            per = -(-self.__tile_rows // size)
            self.__tile_rows_per_process = [max(0, min(per, self.__tile_rows - r * per)) for r in range(size)]
            self.__tile_columns_per_process = [self.__tile_cols] * size
        else:
            per = -(-self.__tile_cols // size)
            self.__tile_columns_per_process = [max(0, min(per, self.__tile_cols - r * per)) for r in range(size)]
            self.__tile_rows_per_process = [self.__tile_rows] * size

    @property
    def arr(self) -> DNDarray:
        return self.__arr

    @property
    def row_indices(self) -> List[int]:
        return self.__row_inds

    @property
    def col_indices(self) -> List[int]:
        return self.__col_inds

    @property
    def tile_columns(self) -> int:
        return self.__tile_cols

    @property
    def tile_rows(self) -> int:
        return self.__tile_rows

    @property
    def tile_columns_per_process(self) -> List[int]:
        return self.__tile_columns_per_process

    @property
    def tile_rows_per_process(self) -> List[int]:
        return self.__tile_rows_per_process

    def _tile_slices(self, key) -> Tuple[slice, slice]:
        key = key if isinstance(key, tuple) else (key,)
        row, col = (key + (slice(None),))[:2] if len(key) < 2 else key
        r_ends = np.asarray(self.__row_inds[1:] + [self.__arr.gshape[0]])
        c_ends = np.asarray(self.__col_inds[1:] + [self.__arr.gshape[1]])
        return _tile_range(r_ends, row), _tile_range(c_ends, col)

    def __getitem__(self, key) -> Optional[np.ndarray]:
        """The global slab of tile ``(row, col)`` (an int or a slice of tile
        indices each), on the host, on every rank."""
        return self.__arr[self._tile_slices(key)].numpy()

    def __setitem__(self, key, value) -> None:
        """Write ``value`` into tile ``(row, col)`` through the array's setitem."""
        self.__arr[self._tile_slices(key)] = value
