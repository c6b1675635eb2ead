"""File I/O: HDF5, netCDF and CSV (counterpart of ``heat_tpu/core/io.py``).

Every rank opens the file itself (a shared file system, or the same file
on every host). A split load reads only this rank's rows: an h5py
hyperslab, the byte range of a classic netCDF row window
(:class:`._netcdf3.NetCDF3File`), or, for a CSV, the rows whose first byte
lies in this rank's byte range, parsed by the native parser
(:mod:`heat_tpu_torch.native`) and moved to their ceil-div owners in one
``alltoall``. Loaded arrays go to the default device (a CUDA card) unless
the caller asks for the CPU.

``start``/``stop`` select a row window ``[start, stop)`` along axis 0
before the split (Python slice rules; the CSV loader takes no negative
bounds): only the window's rows are read. ``stream.ChunkIterator`` reads
its chunks through these windows.

Saves are atomic: the bytes go to a temp file beside ``path`` and one
``os.replace`` commits it. Across ranks every rank writes its own rows
into the same temp file in rank order, each behind a barrier (nothing is
gathered to one rank), and rank 0 commits once every rank has succeeded;
a failure on any rank raises on every rank and leaves ``path`` as it was.
The fault points ``io.open`` and ``io.commit`` (:mod:`._hooks`) fire as
in ``heat_tpu``, and ``load``/``save`` take a ``retry=``
:class:`._retry.RetryPolicy`.

CSV loads record their parser in ``KERNEL_STATS``: ``csv.native`` or
``csv.python`` (``heat_tpu``'s Python route, taken where ``heat_tpu`` takes
it: a windowed read, a separator of more than one character, another
encoding, or a file the native parser refuses).
"""
from __future__ import annotations

import contextlib
import io as _io_module
import os
import shutil
from typing import Optional

import numpy as np
import torch

from . import _hooks, devices, types
from ._atomic import atomic_write, tmp_path_for
from ._retry import NO_RETRY, RetryPolicy
from .communication import sanitize_comm
from .dndarray import DNDarray
from .kernels._dispatch import record_route
from .stride_tricks import sanitize_axis

try:
    import h5py

    _HAS_HDF5 = True
except ImportError:
    _HAS_HDF5 = False

_HDF5_EXTENSIONS = (".h5", ".hdf5")
_NETCDF_EXTENSIONS = (".nc", ".nc4", ".netcdf")
_CSV_EXTENSION = ".csv"
_RANGE_ENCODINGS = ("utf-8", "ascii", "latin-1")  # encodings whose newline is the byte 0x0A

__all__ = [
    "load",
    "load_csv",
    "load_hdf5",
    "load_netcdf",
    "save",
    "save_csv",
    "save_hdf5",
    "save_netcdf",
    "supports_hdf5",
    "supports_netcdf",
]


def _row_window(n_rows: int, start: Optional[int], stop: Optional[int]) -> tuple:
    """An axis-0 row window clamped to ``[0, n_rows]`` with Python slice
    rules (None ends, negatives count from the end), the same for every
    loader."""
    r0, r1, _ = slice(start, stop).indices(int(n_rows))
    return r0, max(r0, r1)


def _np_type(dtype):
    """The numpy type a file's values are converted to before they become
    ``dtype``: its own, or float64 for bfloat16 (numpy has none; one
    rounding from float64 to bfloat16 follows on the tensor)."""
    return np.dtype(dtype.numpy_type() or np.float64)


def _wrap(arr: np.ndarray, gshape, dtype, split, device, comm) -> DNDarray:
    """A DNDarray of this rank's rows ``arr`` (the whole array where
    ``split`` is None or the world has one rank)."""
    arr = np.ascontiguousarray(arr, dtype=_np_type(dtype))
    t = torch.from_numpy(arr) if arr.flags.writeable else torch.from_numpy(arr.copy())
    device = devices.sanitize_device(device)
    return DNDarray(t.to(device.torch_device, dtype.torch_type()), gshape=tuple(gshape), dtype=dtype, split=split,
                    device=device, comm=comm)


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy (bfloat16 as float32, which holds it exactly)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _flags(flag: bool, comm) -> np.ndarray:
    """Every rank's ``flag`` (0 or 1), in rank order, on every rank."""
    t = torch.tensor([1 if flag else 0], dtype=torch.int64, device=comm.device())
    return comm.allgather(t, 0, [1] * comm.size).cpu().numpy()


def _check_path_visible(path: str, comm) -> None:
    """Raise on every rank alike: ``FileNotFoundError`` where no rank sees
    ``path``, ``OSError`` where only some do (a rank that went on would
    wait at the next collective for ranks that had left)."""
    visible = os.path.exists(path)
    if comm.size > 1:
        seen = _flags(visible, comm)
        if not seen.any():
            raise FileNotFoundError(f"no such file: {path!r} (missing on all {seen.size} ranks)")
        if not seen.all():
            raise OSError(
                f"{path!r} is visible on rank(s) {np.nonzero(seen)[0].tolist()} but missing on "
                f"{np.nonzero(seen == 0)[0].tolist()}: every rank must see the same path"
            )
    elif not visible:
        raise FileNotFoundError(f"no such file: {path!r}")


def _rank_ordered_save(path: str, comm, first, append=None) -> None:
    """``first(tmp)`` on rank 0, then ``append(tmp)`` on ranks 1, 2, ... in
    turn (each behind a barrier) into one temp file beside ``path``; rank 0
    commits it with ``os.replace`` once every rank has succeeded. A failure
    on any rank raises on every rank and removes the temp file; ``path``
    keeps what it held. With one rank this is :func:`._atomic.atomic_write`."""
    if comm.size == 1:
        with atomic_write(path) as tmp:
            first(tmp)
        return
    tmp = tmp_path_for(path, suffix="ranks")  # the same name on every rank
    err = None
    try:
        _hooks.fault_point("io.open", path=path)
    except BaseException as e:  # noqa: BLE001 - raised after the other ranks have heard of it
        err = e
    for r in range(comm.size):
        if comm.rank == r and err is None:
            try:
                if r == 0:
                    first(tmp)
                elif append is not None:
                    append(tmp)
            except BaseException as e:  # noqa: BLE001 - every rank must still reach the barrier
                err = e
        comm.barrier()
    failed = _flags(err is not None, comm)
    if not failed.any() and comm.rank == 0:
        try:
            _hooks.fault_point("io.commit", path=path, tmp_path=tmp)
            os.replace(tmp, path)
        except BaseException as e:  # noqa: BLE001
            err = e
    if (err is not None or failed.any()) and comm.rank == 0:
        with contextlib.suppress(OSError):
            os.remove(tmp)
    committed = _flags(err is not None, comm)
    if err is not None:
        raise err
    if failed.any() or committed.any():
        raise OSError(f"save of {path!r} failed on rank(s) {np.nonzero(failed | committed)[0].tolist()}")


def _rows_to_write(data: DNDarray):
    """``(rows, first_row)``: what this rank writes of ``data``. A split
    array is written by its ranks' axis-0 chunks (split along another
    axis, it is resplit to 0 first); a replicated one by rank 0 alone
    (``rows`` None elsewhere)."""
    comm = data.comm
    if comm.size == 1 or data.split is None or data.ndim == 0:
        return (_host(data.larray) if comm.rank == 0 else None), 0
    if data.split != 0:
        data = data.resplit(0)
    return _host(data.larray), comm.chunk(data.gshape, 0)[0]


def supports_hdf5() -> bool:
    """Whether h5py is installed."""
    return _HAS_HDF5


def supports_netcdf() -> bool:
    """Whether netCDF-4 files can be read and written: through h5py, for
    the netCDF-4/HDF5 data model. Classic (CDF-1/CDF-2) files go through
    the port's own reader and writer and need nothing installed."""
    return _HAS_HDF5


def load(path: str, *args, retry: Optional[RetryPolicy] = None, **kwargs) -> DNDarray:
    """Load by file extension (``.h5``/``.hdf5``, ``.nc``/``.nc4``/
    ``.netcdf``, ``.csv``). A missing file raises ``FileNotFoundError`` on
    every rank before anything is read; ``retry`` reruns the whole read on
    a transient ``OSError``/``TimeoutError``."""
    if not isinstance(path, str):
        raise TypeError(f"Expected path to be str, but was {type(path)}")
    _check_path_visible(path, sanitize_comm(kwargs.get("comm")))
    extension = os.path.splitext(path)[-1].strip().lower()
    if extension in _HDF5_EXTENSIONS:
        backend = load_hdf5
    elif extension in _NETCDF_EXTENSIONS:
        backend = load_netcdf
    elif extension == _CSV_EXTENSION:
        backend = load_csv
    else:
        raise ValueError(f"Unsupported file extension {extension}")

    def attempt():
        _hooks.fault_point("io.open", path=path)
        return backend(path, *args, **kwargs)

    return (retry or NO_RETRY).call(attempt, label=f"load({path!r})")


def _h5_read_open(path: str):
    """Open an HDF5 file read-only without the HDF5 file lock: every rank
    (and a prefetch thread) may hold a read handle at once, and no reader
    races a writer, since every save commits by rename."""
    try:
        return h5py.File(path, "r", locking=False)
    except TypeError:  # an h5py without the argument
        return h5py.File(path, "r")


def load_hdf5(path: str, dataset: str, dtype=types.float32, split: Optional[int] = None, device=None, comm=None,
              start: Optional[int] = None, stop: Optional[int] = None) -> DNDarray:
    """Load an HDF5 dataset; a split load reads only this rank's chunk of
    the ``[start, stop)`` row window (a hyperslab)."""
    if not _HAS_HDF5:
        raise ImportError("h5py is required for HDF5 support")
    if not isinstance(path, str):
        raise TypeError(f"path must be str, not {type(path)}")
    if not isinstance(dataset, str):
        raise TypeError(f"dataset must be str, not {type(dataset)}")
    comm = sanitize_comm(comm)
    dtype = types.canonical_heat_type(dtype)
    with _h5_read_open(path) as handle:
        data = handle[dataset]
        fshape = tuple(data.shape)
        if not fshape:
            return _wrap(np.asarray(data[()]), (), dtype, None, device, comm)
        r0, r1 = _row_window(fshape[0], start, stop)
        gshape = (r1 - r0,) + fshape[1:]
        if split is not None:
            split = sanitize_axis(gshape, split)
        if split is None or comm.size == 1:
            return _wrap(np.asarray(data[r0:r1]), gshape, dtype, split, device, comm)
        _, _, slices = comm.chunk(gshape, split)
        rows = slices[0]
        local = np.asarray(data[(slice(r0 + rows.start, r0 + rows.stop),) + tuple(slices[1:])])
    return _wrap(local, gshape, dtype, split, device, comm)


def save_hdf5(data: DNDarray, path: str, dataset: str, mode: str = "w", **kwargs) -> None:
    """Save to HDF5, atomically; across ranks each rank writes its own
    rows in rank order. A mode other than ``"w"`` extends a copy of the
    existing file."""
    if not _HAS_HDF5:
        raise ImportError("h5py is required for HDF5 support")
    if not isinstance(data, DNDarray):
        raise TypeError(f"data must be a DNDarray, not {type(data)}")
    if not isinstance(path, str):
        raise TypeError(f"path must be str, not {type(path)}")
    rows, off = _rows_to_write(data)
    np_dtype = np.dtype(data.dtype.numpy_type() or np.float32)

    def put(handle):
        if rows is None:
            return
        dset = handle[dataset]
        if data.ndim == 0:
            dset[()] = rows
        else:
            dset[off : off + rows.shape[0]] = rows

    def first(tmp):
        if mode != "w" and os.path.exists(path):
            shutil.copy2(path, tmp)  # other modes extend a copy
        with h5py.File(tmp, "a" if mode != "w" and os.path.exists(tmp) else "w") as handle:
            handle.create_dataset(dataset, shape=tuple(data.gshape), dtype=np_dtype, **kwargs)
            put(handle)

    def append(tmp):
        with h5py.File(tmp, "a") as handle:
            put(handle)

    _rank_ordered_save(path, data.comm, first, append if rows is not None else None)


def _is_classic_netcdf(path: str) -> bool:
    from ._netcdf3 import is_classic_netcdf

    try:
        return is_classic_netcdf(path)
    except OSError:
        return False


def load_netcdf(path: str, variable: str, dtype=types.float32, split=None, device=None, comm=None,
                start: Optional[int] = None, stop: Optional[int] = None) -> DNDarray:
    """Load a netCDF variable: a classic (CDF-1/CDF-2) file through the
    port's own reader, a netCDF-4 file (an HDF5 file) through h5py. A
    split load reads only this rank's rows of the ``[start, stop)``
    window."""
    comm = sanitize_comm(comm)
    dtype = types.canonical_heat_type(dtype)
    if _is_classic_netcdf(path):
        return _load_netcdf3(path, variable, dtype, split, device, comm, start, stop)
    if not _HAS_HDF5:
        raise ImportError("netCDF-4 files need h5py installed")
    with _h5_read_open(path) as probe:
        if variable not in probe:
            raise KeyError(f"variable {variable!r} not found in {path}")
        # a pure netCDF dimension is a dimension scale whose NAME attribute says so
        name_attr = probe[variable].attrs.get("NAME", b"")
        if isinstance(name_attr, bytes) and name_attr.startswith(b"This is a netCDF dimension but not a netCDF variable"):
            raise KeyError(f"{variable!r} is a dimension, not a data variable")
    return load_hdf5(path, variable, dtype=dtype, split=split, device=device, comm=comm, start=start, stop=stop)


def _load_netcdf3(path, variable, dtype, split, device, comm, start=None, stop=None) -> DNDarray:
    """A classic file through :class:`._netcdf3.NetCDF3File`: rows are
    contiguous, so a split-0 rank reads one byte range, and a split along
    another axis reads row stripes of about 4 MiB and keeps its columns."""
    from ._netcdf3 import NetCDF3File

    reader = NetCDF3File(path)
    if variable not in reader.vars:
        raise KeyError(f"variable {variable!r} not found in {path}")
    fshape = reader.shape(variable)
    if not fshape:
        return _wrap(np.asarray(reader.read(variable)), (), dtype, None, device, comm)
    w0, w1 = _row_window(fshape[0], start, stop)
    gshape = (w1 - w0,) + tuple(fshape[1:])
    if split is not None:
        split = sanitize_axis(gshape, split)
    if split is None or comm.size == 1:
        return _wrap(reader.read(variable, w0, w1), gshape, dtype, split, device, comm)
    _, lshape, slices = comm.chunk(gshape, split)
    if split == 0:
        local = reader.read(variable, w0 + slices[0].start, w0 + slices[0].stop)
    else:
        row_bytes = max(1, int(np.prod(gshape[1:], dtype=np.int64)) * reader.vars[variable].dtype.itemsize)
        stripe = max(1, (4 << 20) // row_bytes)
        local = np.empty(lshape, dtype=reader.vars[variable].dtype.newbyteorder("="))
        for s in range(0, gshape[0], stripe):
            e = min(s + stripe, gshape[0])
            local[s:e] = reader.read(variable, w0 + s, w0 + e)[(slice(None),) + tuple(slices[1:])]
    return _wrap(local, gshape, dtype, split, device, comm)


def save_netcdf(data: DNDarray, path: str, variable: str, mode: str = "w", format: str = "NETCDF4",
                **kwargs) -> None:
    """Save to netCDF. A ``format`` starting with ``"NETCDF3"`` writes a
    classic file through the port's own writer — CDF-2 (64-bit offsets)
    for ``"NETCDF3_64BIT"``, else CDF-1 — and any other format a
    netCDF-4-model HDF5 file through h5py (the variable with a dimension
    scale per axis). Across ranks each rank writes its own rows in rank
    order; the save is atomic."""
    if not isinstance(data, DNDarray):
        raise TypeError(f"data must be a DNDarray, not {type(data)}")
    if format.upper().startswith("NETCDF3"):
        if mode != "w":
            raise ValueError("classic netCDF-3 save supports mode='w' only")
        _save_netcdf3(data, path, variable, 2 if "64BIT" in format.upper() else 1)
        return
    if not _HAS_HDF5:
        raise ImportError("netCDF-4 files need h5py installed")
    if mode not in ("w", "a", "r+"):
        raise ValueError(f"unsupported mode {mode!r}")
    rows, off = _rows_to_write(data)

    def put(handle):
        if rows is not None:
            if data.ndim == 0:
                handle[variable][()] = rows
            else:
                handle[variable][off : off + rows.shape[0]] = rows

    def first(tmp):
        if mode != "w" and os.path.exists(path):
            shutil.copy2(path, tmp)
        with h5py.File(tmp, "a" if mode != "w" and os.path.exists(tmp) else "w") as handle:
            handle.create_dataset(variable, shape=tuple(data.gshape), dtype=np.dtype(data.dtype.numpy_type() or
                                                                                     np.float32), **kwargs)
            _attach_netcdf_scales(handle, variable, data.gshape)
            put(handle)

    def append(tmp):
        with h5py.File(tmp, "a") as handle:
            put(handle)

    _rank_ordered_save(path, data.comm, first, append if rows is not None else None)


def _save_netcdf3(data: DNDarray, path: str, variable: str, version: int) -> None:
    from ._netcdf3 import netcdf3_header

    rows, off = _rows_to_write(data)
    dtype = np.dtype(data.dtype.numpy_type() or np.float32)
    head, be_dtype, nbytes = netcdf3_header(variable, tuple(data.gshape), dtype, version)
    row_bytes = int(np.prod(data.gshape[1:], dtype=np.int64)) * be_dtype.itemsize if data.ndim else 0

    def put(f):
        if rows is not None:
            f.seek(len(head) + off * row_bytes)
            np.asarray(rows).astype(be_dtype, copy=False).tofile(f)

    def first(tmp):
        with open(tmp, "wb") as f:
            f.write(head)
            f.truncate(len(head) + nbytes + (-nbytes) % 4)  # the whole file, zero-padded to 4 bytes
            put(f)

    def append(tmp):
        with open(tmp, "r+b") as f:
            put(f)

    _rank_ordered_save(path, data.comm, first, append if rows is not None else None)


def _attach_netcdf_scales(handle, variable: str, gshape) -> None:
    """Register a dataset per axis as an HDF5 dimension scale of
    ``variable``: the on-disk structure of the netCDF-4 data model."""
    var = handle[variable]
    for i, n_i in enumerate(gshape):
        dname = f"dim_{i}_{variable}" if f"dim_{i}" in handle else f"dim_{i}"
        scale = handle.create_dataset(dname, shape=(n_i,), dtype=np.float32)
        scale.make_scale(dname)
        scale.attrs["NAME"] = np.bytes_(b"This is a netCDF dimension but not a netCDF variable. %10d" % n_i)
        var.dims[i].attach_scale(scale)


def _py_csv_range(path, offset, length, header_lines, sep, encoding):
    """The rows the byte range ``[offset, offset + length)`` owns, parsed
    in Python (``heat_tpu``'s route where the native parser refuses them)."""
    with open(path, "rb") as f:
        for _ in range(header_lines):
            if not f.readline():
                break
        data_start = f.tell()
        f.seek(0, os.SEEK_END)
        fsize = f.tell()
        lo = max(offset, data_start)
        hi = min(offset + length, fsize) if length >= 0 else fsize
        if lo > data_start:
            f.seek(lo - 1)  # a line that starts before lo belongs to the previous range
            f.readline()
        else:
            f.seek(data_start)
        chunks = []
        while f.tell() < hi:
            line = f.readline()
            if not line:
                break
            chunks.append(line)
    text = b"".join(chunks).decode(encoding)
    if not text.strip():
        return np.empty((0, 0), dtype=np.float64)
    return np.loadtxt(_io_module.StringIO(text), delimiter=sep, dtype=np.float64, ndmin=2)


def _float_fields_parse(path, header_lines, sep, encoding, np_dtype, start=0, max_rows=None):
    """Heat's own row parse: ``line.split(sep)`` and ``float()`` per field,
    on the non-blank data rows ``[start, start + max_rows)``."""
    with open(path, "r", encoding=encoding) as f:
        lines = f.read().splitlines()[header_lines:]
    data_lines = [line for line in lines if line.strip()]
    stop = None if max_rows is None else start + max_rows
    rows = [[float(field) for field in line.split(sep)] for line in data_lines[start:stop]]
    return np.array(rows, dtype=np.float64, ndmin=2).astype(np_dtype)


def _csv_python(path, header_lines, sep, encoding, np_dtype, start=0, max_rows=None):
    """``heat_tpu``'s Python route: ``loadtxt``, and Heat's per-field
    ``float()`` for what ``loadtxt`` refuses or a separator of more than
    one character."""
    record_route("csv", "python")
    if len(sep) == 1:
        try:
            return np.loadtxt(path, delimiter=sep, skiprows=header_lines + start, dtype=np.float64,
                              encoding=encoding, ndmin=2, max_rows=max_rows).astype(np_dtype)
        except ValueError:
            pass
    return _float_fields_parse(path, header_lines, sep, encoding, np_dtype, start=start, max_rows=max_rows)


def load_csv(path: str, header_lines: int = 0, sep: str = ",", dtype=types.float32, encoding: str = "utf-8",
             split: Optional[int] = None, device=None, comm=None, start: Optional[int] = None,
             stop: Optional[int] = None) -> DNDarray:
    """Load a numeric CSV file. With ``split=0`` across ranks each rank
    parses only the rows whose first byte lies in its share of the file's
    bytes (the native parser) and one ``alltoall`` moves rows to their
    ceil-div owners. Otherwise the native parser reads the whole file.

    ``start``/``stop`` select the data rows ``[start, stop)`` (counted
    after ``header_lines``, blank lines skipped; no negative bounds, as the
    row count is unknown without a scan); a windowed read takes the Python
    route, which parses only the window."""
    if not isinstance(path, str):
        raise TypeError(f"path must be str, not {type(path)}")
    if not isinstance(sep, str):
        raise TypeError(f"separator must be str, not {type(sep)}")
    if not isinstance(header_lines, int):
        raise TypeError(f"header_lines must be int, not {type(header_lines)}")
    windowed = start is not None or stop is not None
    if windowed and ((start or 0) < 0 or (stop is not None and stop < 0)):
        raise ValueError(
            "CSV row windows do not support negative indices (the row count "
            f"is unknown without a full scan): start={start}, stop={stop}"
        )
    w0 = int(start or 0)
    w_max = None if stop is None else max(0, int(stop) - w0)
    dtype = types.canonical_heat_type(dtype)
    comm = sanitize_comm(comm)
    np_dtype = _np_type(dtype)
    rangeable = len(sep) == 1 and encoding in _RANGE_ENCODINGS
    if comm.size > 1 and split == 0 and rangeable and not windowed:
        from .. import native
        from .factories import array

        per = -(-os.path.getsize(path) // comm.size)
        local = native.csv_parse_range(path, comm.rank * per, per, header_lines, sep, np_dtype)
        if local is None:
            record_route("csv", "python")
            local = _py_csv_range(path, comm.rank * per, per, header_lines, sep, encoding).astype(np_dtype)
        else:
            record_route("csv", "native")
        # an empty range parses to (0, 0): it takes the others' column count
        cols = int(comm.allreduce(torch.tensor([local.shape[1]], device=comm.device()), "max").item())
        if local.shape[0] == 0:
            local = local.reshape(0, cols)
        t = torch.from_numpy(np.ascontiguousarray(local)).to(devices.sanitize_device(device).torch_device)
        return array(t, dtype=dtype, is_split=0, device=device, comm=comm, copy=False)
    data = None
    if not windowed and rangeable:
        from .. import native

        data = native.csv_parse(path, header_lines, sep, np_dtype)
        if data is not None:
            record_route("csv", "native")
    if data is None:
        data = _csv_python(path, header_lines, sep, encoding, np_dtype, start=w0, max_rows=w_max)
    split = sanitize_axis(data.shape, split) if split is not None else None
    gshape = data.shape
    if split is not None and comm.size > 1:
        data = data[comm.chunk(gshape, split)[2]]
    return _wrap(data, gshape, dtype, split, device, comm)


def save_csv(data: DNDarray, path: str, header_lines=None, sep: str = ",", decimals: int = -1,
             encoding: str = "utf-8", comm=None, truncate: bool = True, **kwargs) -> None:
    """Save to CSV with ``np.savetxt``'s formatting (``%d`` for integer
    types, ``%.{decimals}f`` or ``%f`` for floats), atomically; across
    ranks each rank appends its own rows in rank order. ``truncate=False``
    overwrites an existing file from offset 0 without shortening it (stale
    trailing rows survive, as in Heat). ``comm`` is taken for the
    signature's sake: the array's own communicator writes."""
    if not isinstance(data, DNDarray):
        raise TypeError(f"data must be a DNDarray, not {type(data)}")
    if types.heat_type_is_exact(data.dtype):
        fmt = "%d"
    elif decimals >= 0:
        fmt = f"%.{decimals}f"
    else:
        fmt = "%f"
    header = None
    if header_lines is not None:
        header = "\n".join(header_lines) if not isinstance(header_lines, str) else header_lines
    rows, _ = _rows_to_write(data)
    comm = data.comm
    mine = b""
    if rows is not None:
        buf = _io_module.StringIO()
        np.savetxt(buf, rows[:, None] if rows.ndim == 1 else rows, fmt=fmt, delimiter=sep,
                   header=(header or "") if comm.rank == 0 else "", comments="")
        mine = buf.getvalue().encode(encoding)
    # each rank's bytes start where the lower ranks' end
    at = 0
    if comm.size > 1:
        sizes = comm.allgather(torch.tensor([len(mine)], dtype=torch.int64, device=comm.device()), 0, [1] * comm.size)
        at = int(sizes.cpu().numpy()[: comm.rank].sum())

    def first(tmp):
        if not truncate and os.path.exists(path):
            shutil.copy2(path, tmp)  # overwritten from offset 0, never shortened (stale trailing rows survive)
            with open(tmp, "r+b") as fh:
                fh.write(mine)
            return
        payload = bytearray(mine)
        payload = _hooks.fault_point("io.write", path=path, payload=payload).get("payload", payload)
        with open(tmp, "wb") as fh:
            fh.write(bytes(payload))
            fh.flush()
            os.fsync(fh.fileno())

    def append(tmp):
        with open(tmp, "r+b") as fh:
            fh.seek(at)
            fh.write(mine)

    _rank_ordered_save(path, comm, first, append if mine else None)


def save(data: DNDarray, path: str, *args, retry: Optional[RetryPolicy] = None, **kwargs) -> None:
    """Save by file extension. Every backend writes atomically, so
    ``retry`` may rerun the whole save on a transient
    ``OSError``/``TimeoutError``."""
    if not isinstance(path, str):
        raise TypeError(f"Expected path to be str, but was {type(path)}")
    extension = os.path.splitext(path)[-1].strip().lower()
    if extension in _HDF5_EXTENSIONS:
        backend = save_hdf5
    elif extension in _NETCDF_EXTENSIONS:
        backend = save_netcdf
    elif extension == _CSV_EXTENSION:
        backend = save_csv
    else:
        raise ValueError(f"Unsupported file extension {extension}")
    return (retry or NO_RETRY).call(backend, data, path, *args, label=f"save({path!r})", **kwargs)
