"""Classic netCDF (CDF-1/CDF-2) reader and writer in numpy (counterpart of
``heat_tpu/core/_netcdf3.py``; the port keeps its own copy).

The classic format
(https://docs.unidata.ucar.edu/netcdf-c/current/file_format_specifications.html)
is a few hundred bytes of big-endian header plus flat row-major data, so a
reader needs no library: :meth:`NetCDF3File.read` reads the byte range of
a row window of one variable, never the whole file, which is how a split
load reads only its rank's rows and ``stream.ChunkIterator`` one chunk.

Scope: CDF-1 (32-bit offsets) and CDF-2 (64-bit offsets), all six classic
types, fixed and record variables; attributes are parsed and skipped (no
scale or offset is applied). The writer emits a minimal file: the
dimension list and one data variable without attributes. A variable holds
at most 2 GiB - 1 bytes (the header's vsize is a signed 32-bit integer);
CDF-2's 64-bit offsets let the data start past 2 GiB.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["NetCDF3File", "is_classic_netcdf", "netcdf3_header", "write_netcdf3"]

_NC_DIMENSION = 0x0A
_NC_VARIABLE = 0x0B
_NC_ATTRIBUTE = 0x0C

_TYPES = {
    1: np.dtype(">i1"),  # NC_BYTE
    2: np.dtype("S1"),   # NC_CHAR
    3: np.dtype(">i2"),  # NC_SHORT
    4: np.dtype(">i4"),  # NC_INT
    5: np.dtype(">f4"),  # NC_FLOAT
    6: np.dtype(">f8"),  # NC_DOUBLE
}
_TYPE_CODES = {
    np.dtype(np.int8): 1,
    np.dtype("S1"): 2,
    np.dtype(np.int16): 3,
    np.dtype(np.int32): 4,
    np.dtype(np.float32): 5,
    np.dtype(np.float64): 6,
}


# the largest variable each version holds (the format's limits: CDF-1's offsets are signed 32-bit, and
# the header's vsize is an unsigned 32-bit field in both; a variable past these is refused)
_MAX_BYTES = {1: 2**31 - 4, 2: 2**32 - 4}


def is_classic_netcdf(path: str) -> bool:
    with open(path, "rb") as f:
        head = f.read(4)
    return head[:3] == b"CDF" and head[3:4] in (b"\x01", b"\x02")


class _Var:
    __slots__ = ("name", "dimids", "dtype", "vsize", "begin", "is_record", "shape")

    def __init__(self, name, dimids, dtype, vsize, begin):
        self.name = name
        self.dimids = dimids
        self.dtype = dtype
        self.vsize = vsize
        self.begin = begin
        self.is_record = False
        self.shape: Tuple[int, ...] = ()


class NetCDF3File:
    """Parsed classic-format header with byte-range reads."""

    def __init__(self, path: str):
        self.path = path
        # the header is streamed from the open handle — never the whole
        # file (a 50 GB classic file has a few-KB header)
        with open(path, "rb") as f:
            self._f = f
            magic = f.read(4)
            if magic[:3] != b"CDF" or magic[3] not in (1, 2):
                raise ValueError(f"{path} is not a classic netCDF file")
            self.version = magic[3]
            self._off_t = ">q" if self.version == 2 else ">i"
            self.numrecs = self._i4()
            self.dims: List[Tuple[str, int]] = []
            self.attrs: Dict[str, object] = {}
            self.vars: Dict[str, _Var] = {}
            self._dim_list()
            self.attrs = self._att_list()
            self._var_list()
        del self._f
        self._finalize()

    # -- primitive readers ---------------------------------------------------
    def _take(self, n: int) -> bytes:
        b = self._f.read(n)
        if len(b) != n:
            raise ValueError(f"{self.path}: truncated classic netCDF header")
        return b

    def _i4(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def _name(self) -> str:
        n = self._i4()
        s = self._take(n).decode("utf-8")
        self._take((-n) % 4)  # padded to 4
        return s

    # -- header sections -----------------------------------------------------
    def _tagged_count(self, expect: int) -> int:
        tag = self._i4()
        count = self._i4()
        if tag == 0 and count == 0:
            return 0
        if tag != expect:
            raise ValueError(f"corrupt header: tag {tag:#x}, expected {expect:#x}")
        return count

    def _dim_list(self) -> None:
        for _ in range(self._tagged_count(_NC_DIMENSION)):
            name = self._name()
            size = self._i4()
            self.dims.append((name, size))

    def _att_list(self) -> Dict[str, object]:
        out: Dict[str, object] = {}
        for _ in range(self._tagged_count(_NC_ATTRIBUTE)):
            name = self._name()
            nc_type = self._i4()
            nelems = self._i4()
            dt = _TYPES[nc_type]
            nbytes = dt.itemsize * nelems
            raw = self._take(nbytes)
            self._take((-nbytes) % 4)
            if nc_type == 2:
                out[name] = raw.decode("utf-8", "replace")
            else:
                out[name] = np.frombuffer(raw, dtype=dt)
        return out

    def _var_list(self) -> None:
        for _ in range(self._tagged_count(_NC_VARIABLE)):
            name = self._name()
            ndims = self._i4()
            dimids = [self._i4() for _ in range(ndims)]
            self._att_list()  # variable attributes: parsed, not applied
            nc_type = self._i4()
            vsize = struct.unpack(">I", self._take(4))[0]  # unsigned, as netCDF writes it
            begin = struct.unpack(self._off_t, self._take(struct.calcsize(self._off_t)))[0]
            self.vars[name] = _Var(name, dimids, _TYPES[nc_type], vsize, begin)

    def _finalize(self) -> None:
        rec_vars = []
        for v in self.vars.values():
            shape = []
            for i, d in enumerate(v.dimids):
                dname, dsize = self.dims[d]
                if dsize == 0 and i == 0:
                    v.is_record = True
                    shape.append(self.numrecs)
                else:
                    shape.append(dsize)
            v.shape = tuple(shape)
            if v.is_record:
                rec_vars.append(v)
        # each record var's `begin` already points at its slot inside
        # record 0; the per-record stride is the sum of all record vsizes.
        # Spec special case: a SINGLE record variable of byte/char/short
        # stores its record slabs UNPADDED (vsize is still rounded up),
        # so the stride is the raw one-record size.
        if len(rec_vars) == 1 and rec_vars[0].dtype.itemsize < 4:
            v = rec_vars[0]
            rest = [self.dims[d][1] for d in v.dimids[1:]]
            self.recsize = int(np.prod(rest, dtype=np.int64)) * v.dtype.itemsize
        else:
            self.recsize = sum(v.vsize for v in rec_vars)
        if self.numrecs == -1 and rec_vars:  # STREAMING sentinel
            import os

            first = min(v.begin for v in rec_vars)
            self.numrecs = (os.path.getsize(self.path) - first) // max(self.recsize, 1)
            for v in rec_vars:
                v.shape = (self.numrecs,) + v.shape[1:]

    # -- data ----------------------------------------------------------------
    def shape(self, variable: str) -> Tuple[int, ...]:
        return self.vars[variable].shape

    def read(self, variable: str, start: int = 0, stop: Optional[int] = None) -> np.ndarray:
        """Rows ``[start, stop)`` of the first dimension (the whole
        variable when it is 0-d), reading only the covered byte range."""
        v = self.vars[variable]
        if not v.shape:
            with open(self.path, "rb") as f:
                f.seek(v.begin)
                return np.frombuffer(f.read(v.dtype.itemsize), dtype=v.dtype)[0]
        n = v.shape[0]
        stop = n if stop is None else min(stop, n)
        start = max(0, start)
        rows = max(0, stop - start)
        rest = v.shape[1:]
        row_elems = int(np.prod(rest, dtype=np.int64)) if rest else 1
        row_bytes = row_elems * v.dtype.itemsize
        out = np.empty((rows, row_elems), dtype=v.dtype)
        with open(self.path, "rb") as f:
            if v.is_record:
                for i in range(rows):
                    f.seek(v.begin + (start + i) * self.recsize)
                    out[i] = np.frombuffer(f.read(row_bytes), dtype=v.dtype)
            else:
                f.seek(v.begin + start * row_bytes)
                if f.readinto(out.reshape(-1).view(np.uint8)) != rows * row_bytes:
                    raise ValueError(f"{self.path}: truncated data of variable {variable!r}")
        return out.reshape((rows,) + rest)


def netcdf3_header(variable: str, shape, dtype, version: int = 1, dim_names: Optional[List[str]] = None):
    """``(header bytes, big-endian data type, data bytes)`` of a file that
    holds one fixed variable of ``shape`` and ``dtype``; the data starts
    right after the header and is zero-padded to 4 bytes. Types the
    classic format lacks widen as the netCDF4 library's default does
    (integers and bool to int32, other floats to float64)."""
    shape = tuple(int(s) for s in shape)
    dtype = np.dtype(dtype)
    code = _TYPE_CODES.get(np.dtype("S1") if dtype.kind == "S" else dtype)
    if code is None:
        code = 4 if dtype.kind in "iub" else 6
    be_dtype = _TYPES[code]
    nbytes = int(np.prod(shape, dtype=np.int64)) * be_dtype.itemsize
    if nbytes > _MAX_BYTES[version]:
        # fail clearly instead of a cryptic struct.error after a partial header write
        raise ValueError(
            f"variable too large for classic netCDF CDF-{version} ({nbytes} bytes > {_MAX_BYTES[version]}); "
            "use format='NETCDF3_64BIT' (CDF-2) up to 2^32 - 4 bytes, or the netCDF-4 path (format='NETCDF4')"
        )
    if dim_names is None:
        dim_names = [f"{variable}_dim_{i}" for i in range(len(shape))]

    def name_bytes(s: str) -> bytes:
        b = s.encode("utf-8")
        return struct.pack(">i", len(b)) + b + b"\x00" * ((-len(b)) % 4)

    off_t = ">q" if version == 2 else ">i"
    head = [b"CDF", bytes([version]), struct.pack(">i", 0)]  # numrecs=0
    if shape:
        head.append(struct.pack(">ii", _NC_DIMENSION, len(shape)))
        for nm, sz in zip(dim_names, shape):
            head.append(name_bytes(nm) + struct.pack(">i", sz))
    else:
        head.append(struct.pack(">ii", 0, 0))
    head.append(struct.pack(">ii", 0, 0))  # no global attributes
    head.append(struct.pack(">ii", _NC_VARIABLE, 1))
    vsize = (nbytes + 3) & ~3
    var_head = (
        name_bytes(variable)
        + struct.pack(">i", len(shape))
        + b"".join(struct.pack(">i", i) for i in range(len(shape)))
        + struct.pack(">ii", 0, 0)  # no variable attributes
        + struct.pack(">iI", code, vsize)
    )
    begin = sum(len(b) for b in head) + len(var_head) + struct.calcsize(off_t)
    head.append(var_head + struct.pack(off_t, begin))
    return b"".join(head), be_dtype, nbytes


def write_netcdf3(
    path: str,
    variable: str,
    data: np.ndarray,
    dim_names: Optional[List[str]] = None,
    version: int = 1,
) -> None:
    """Write ``data`` as a single fixed variable in CDF-1/2 format."""
    data = np.asarray(data)
    if data.ndim:  # ascontiguousarray would promote 0-d to 1-d
        data = np.ascontiguousarray(data)
    head, be_dtype, nbytes = netcdf3_header(variable, data.shape, data.dtype, version, dim_names)
    with open(path, "wb") as f:
        f.write(head)
        data.astype(be_dtype, copy=False).tofile(f)
        f.write(b"\x00" * ((-nbytes) % 4))
