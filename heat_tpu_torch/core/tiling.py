"""Tile geometry (counterpart of ``heat_tpu/core/tiling.py``).

Only the geometry the blocked factorizations read: :class:`SquareDiagTiles`
(the square tiles along the diagonal of a 2-D array, their global starts
and their count per rank) and :func:`factor_block_edge`, the panel width of
the distributed ``cholesky`` and ``solve_triangular``. ``heat_tpu``'s tile
views (``__getitem__``/``__setitem__``) and ``SplitTiles`` are not ported.
"""
from __future__ import annotations

from typing import List

from .dndarray import DNDarray

__all__ = ["SquareDiagTiles", "factor_block_edge"]


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
