"""Chunked sources: row blocks of a file or an array as DNDarrays
(counterpart of ``heat_tpu/stream/chunked.py``).

:class:`ChunkIterator` walks a dataset ``chunk_rows`` rows at a time and
yields each window as a DNDarray split along ``split``. Each window goes
through two halves, kept apart:

- the host half, :meth:`ChunkIterator.iter_raw`: read (and parse) the
  window into a numpy array. numpy and file reads only — no CUDA call and
  no collective — so a :class:`~.prefetch.Prefetcher`'s producer thread
  may run it;
- the device half, :meth:`ChunkIterator._stage`: the host-to-card copy
  and the split, on the consumer's thread, which issues every CUDA call
  and collective of the program.

With ``split=0`` over more than one rank each rank reads only its own
ceil-div rows of each window (a row window of the file, so the ranks
share the reading); with another split, or replicated, every rank reads
the whole window and keeps its part at staging.

Sources: a path (``.h5``/``.hdf5``, ``.nc``/``.nc4``/``.netcdf``, ``.csv``)
read by row windows through :mod:`heat_tpu_torch.core.io`'s readers (the
classic netCDF reader reads only the window's bytes), or an in-memory
array (numpy, a nested sequence, or a DNDarray, gathered once).

Every chunk has ``chunk_rows`` rows but a single shorter tail, and the
iterator is re-iterable (each ``iter()`` starts again from row 0), as
multi-epoch consumers such as ``StreamingKMeans.fit`` need.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..core import _hooks, io as _io, types
from ..core.communication import sanitize_comm
from ..core.dndarray import DNDarray
from ..core.stride_tricks import sanitize_axis

__all__ = ["ChunkIterator"]

_H5 = (".h5", ".hdf5")
_NC = (".nc", ".nc4", ".netcdf")


def _csv_count_rows(path: str, header_lines: int, encoding: str) -> int:
    """Number of non-blank data rows: one scan of the lines, no parse."""
    n = 0
    with open(path, "r", encoding=encoding) as fh:
        for i, line in enumerate(fh):
            if i >= header_lines and line.strip():
                n += 1
    return n


class ChunkIterator:
    """Iterate a dataset as ``chunk_rows``-row DNDarray blocks.

    Parameters
    ----------
    source : str | array-like | DNDarray
        A file path (HDF5, netCDF or CSV by extension) or an in-memory
        array, 1-D or 2-D, chunked along axis 0.
    chunk_rows : int
        Rows per chunk (the last chunk may be shorter).
    dataset : str, optional
        The HDF5 dataset or netCDF variable (required for those formats).
    split : int or None
        Split axis of the yielded DNDarrays (default 0).
    dtype, device, comm :
        Of the yielded DNDarrays (the device defaults to the CUDA card).
    header_lines, sep, encoding :
        CSV options, as :func:`heat_tpu_torch.load_csv` takes them.
    """

    def __init__(self, source, chunk_rows: int, *, dataset: Optional[str] = None, split: Optional[int] = 0,
                 dtype=types.float32, device=None, comm=None, header_lines: int = 0, sep: str = ",",
                 encoding: str = "utf-8"):
        if chunk_rows < 1:
            raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
        self.chunk_rows = int(chunk_rows)
        self.split = split
        self.dtype = types.canonical_heat_type(dtype)
        self.device = device
        self.comm = comm
        self._comm = sanitize_comm(comm)
        # rank and size fixed here: the host half does arithmetic with them and never asks torch.distributed
        self._rank, self._size = self._comm.rank, self._comm.size
        self._csv_opts = (int(header_lines), sep, encoding)
        self._path = None
        self._dataset = dataset
        self._array = None
        self._nc3 = None
        if isinstance(source, str):
            if not os.path.exists(source):
                raise FileNotFoundError(f"no such file: {source!r}")
            ext = os.path.splitext(source)[-1].strip().lower()
            if ext in _H5 + _NC and dataset is None:
                raise ValueError("dataset= is required for HDF5/netCDF sources")
            if ext not in _H5 + _NC + (".csv",):
                raise ValueError(f"Unsupported file extension {ext}")
            self._path = source
            self._ext = ext
            self.n_rows = self._probe_rows()
        else:
            if isinstance(source, DNDarray):
                source = source.numpy()
            self._array = np.asarray(source)
            if self._array.ndim == 0:
                raise ValueError("source must have at least one dimension")
            self.n_rows = int(self._array.shape[0])
        # split 0 over several ranks: each rank reads only its rows of a window
        self._local_rows = self._size > 1 and self.split == 0

    # ------------------------------------------------------------ probing
    def _classic(self):
        """The classic netCDF reader of the file, or None for a netCDF-4 file."""
        if self._nc3 is None:
            from ..core._netcdf3 import NetCDF3File, is_classic_netcdf

            self._nc3 = NetCDF3File(self._path) if is_classic_netcdf(self._path) else False
        return self._nc3 or None

    def _probe_rows(self) -> int:
        if self._ext in _H5:
            with _io._h5_read_open(self._path) as handle:
                return int(handle[self._dataset].shape[0])
        if self._ext == ".csv":
            header_lines, _, encoding = self._csv_opts
            return _csv_count_rows(self._path, header_lines, encoding)
        if self._classic() is not None:
            return int(self._classic().shape(self._dataset)[0])
        with _io._h5_read_open(self._path) as handle:
            return int(handle[self._dataset].shape[0])

    # ---------------------------------------------------------- iteration
    def __len__(self) -> int:
        """Number of chunks in one pass."""
        return -(-self.n_rows // self.chunk_rows)

    def _read_raw(self, start: int, stop: int) -> np.ndarray:
        """Rows ``[start, stop)`` as a host numpy array: file reads and numpy
        only (the half a prefetch thread runs)."""
        if self._array is not None:
            return np.asarray(self._array[start:stop])
        if self._ext in _H5:
            with _io._h5_read_open(self._path) as handle:
                return np.asarray(handle[self._dataset][start:stop])
        if self._ext == ".csv":
            header_lines, sep, encoding = self._csv_opts
            # load_csv's windowed route: loadtxt's skiprows/max_rows, Heat's float() parse where loadtxt refuses
            return _io._csv_python(self._path, header_lines, sep, encoding, np.dtype(np.float64), start=start,
                                   max_rows=stop - start)
        if self._classic() is not None:
            return self._classic().read(self._dataset, start, stop)
        with _io._h5_read_open(self._path) as handle:
            return np.asarray(handle[self._dataset][start:stop])

    def _windows(self):
        """``(window rows, raw)`` per chunk, in order: the host half. With
        split 0 over several ranks ``raw`` holds this rank's rows only."""
        for start in range(0, self.n_rows, self.chunk_rows):
            stop = min(start + self.chunk_rows, self.n_rows)
            lo, hi = start, stop
            if self._local_rows:
                n = stop - start
                block = -(-n // self._size)
                lo = start + min(self._rank * block, n)
                hi = start + min(self._rank * block + block, n)
            # converted to the chunk's host type here, so the prefetch thread does the byte swap of a netCDF file
            yield stop - start, np.ascontiguousarray(self._read_raw(lo, hi), dtype=_io._np_type(self.dtype))

    def iter_raw(self):
        """The host pass: each window as a numpy array, in order, with no
        device call (this rank's rows of it where the chunks are split 0
        over several ranks)."""
        for _, raw in self._windows():
            yield raw

    def _stage(self, window) -> DNDarray:
        """The device half: one window ``(rows, raw)`` as a DNDarray (the
        host-to-card copy and the split), counted in ``STREAM_STATS``. Runs
        on the consumer's thread."""
        n, raw = window
        gshape = (n,) + tuple(raw.shape[1:])
        split = sanitize_axis(gshape, self.split) if self.split is not None else None
        if split is not None and self._size > 1 and not self._local_rows:
            raw = raw[self._comm.chunk(gshape, split)[2]]
        chunk = _io._wrap(raw, gshape, self.dtype, split, self.device, self._comm)
        nbytes = int(np.prod(gshape, dtype=np.int64)) * chunk.larray.element_size()
        _hooks.observe("stream.chunk", rows=n, nbytes=nbytes)
        return chunk

    def __iter__(self):
        for window in self._windows():
            yield self._stage(window)
