"""Native (C++) runtime parts of heat_tpu_torch: the CSV parser and the
prefetching file stream (counterpart of ``heat_tpu/native``, over the
port's own copies of its sources in ``src/``).

- :func:`csv_parse` / :func:`csv_parse_range` (``src/csv.cpp``): mmap and
  multithreaded ``std::from_chars``, the whole file or the rows a byte
  range owns (a row belongs to the range holding its first byte);
- :class:`FileStream` (``src/stream.cpp``): a native thread ``pread``\\ s
  slabs of a byte range into a ring ahead of the reader.

The sources build with ``g++`` at first use, all into one shared library
in ``_build/<hash>/`` beside this file (git-ignored), where ``<hash>``
covers the sources and the flags, so an edited source builds anew. A
failed build raises with the compiler's log: nothing parses quietly in
Python instead. A parse the native code refuses (a field ``from_chars``
rejects, a ragged row) returns None, and :mod:`..core.io` then takes
``heat_tpu``'s Python route, as ``heat_tpu`` does.

Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = ["FileStream", "build", "csv_dims", "csv_parse", "csv_parse_range"]

SRC = Path(__file__).resolve().parent / "src"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for p in sorted(SRC.glob("*.cpp")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """The shared library built from ``src/*.cpp`` (built now if it is
    not yet); raises ``RuntimeError`` with the compiler's log on failure."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / "libheat_native.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".libheat_native.{os.getpid()}.so"  # renamed when whole: another process never loads half
    cmd = ["g++", *CXX_FLAGS, *map(str, sorted(SRC.glob("*.cpp"))), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"native library build failed: cannot run {cmd[0]!r}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native library build failed ({' '.join(cmd)}, exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(str(build()))
                _bind(lib)
                _lib = lib
    return _lib


def _bind(lib: ctypes.CDLL) -> None:
    p, i64, i32, c = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_char
    pi64 = ctypes.POINTER(ctypes.c_int64)
    lib.ht_csv_dims.restype = i64
    lib.ht_csv_dims.argtypes = [ctypes.c_char_p, i64, c, pi64, pi64]
    lib.ht_csv_open.restype = p
    lib.ht_csv_open.argtypes = [ctypes.c_char_p, i64, c, pi64, pi64]
    lib.ht_csv_open_range.restype = p
    lib.ht_csv_open_range.argtypes = [ctypes.c_char_p, i64, c, i64, i64, pi64, pi64]
    lib.ht_csv_parse_h.restype = i64
    lib.ht_csv_parse_h.argtypes = [p, c, i32, p, i64, i64, i32]
    lib.ht_csv_close.restype = None
    lib.ht_csv_close.argtypes = [p]
    lib.ht_stream_open.restype = p
    lib.ht_stream_open.argtypes = [ctypes.c_char_p, i64, i64, i64, i32]
    lib.ht_stream_next.restype = i64
    lib.ht_stream_next.argtypes = [p, p, i64]
    lib.ht_stream_close.restype = None
    lib.ht_stream_close.argtypes = [p]


def csv_dims(path: str, header_lines: int = 0, sep: str = ",") -> Optional[Tuple[int, int]]:
    """(rows, cols) of the CSV data region; None for a separator of more
    than one character or a file that cannot be opened."""
    if len(sep) != 1:
        return None
    lib = _load()
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    if lib.ht_csv_dims(path.encode(), header_lines, sep.encode(), ctypes.byref(rows), ctypes.byref(cols)) != 0:
        return None
    return rows.value, cols.value


def _csv_dtype_code(dtype):
    np_dtype = np.dtype(dtype)
    if np_dtype == np.float32:
        return 0, np_dtype, None
    if np_dtype == np.float64:
        return 1, np_dtype, None
    # other types parse as float64, then cast: every field goes through float() first in Heat too
    return 1, np.dtype(np.float64), np_dtype


def _parse_handle(lib, handle, sep, rows, cols, dtype, nthreads):
    code, np_dtype, cast_to = _csv_dtype_code(dtype)
    try:
        if rows == 0 or cols == 0:
            return np.empty((rows, cols), dtype=cast_to or np_dtype)
        out = np.empty((rows, cols), dtype=np_dtype)
        if nthreads <= 0:
            nthreads = min(16, os.cpu_count() or 1)
        rc = lib.ht_csv_parse_h(handle, sep.encode(), code, out.ctypes.data_as(ctypes.c_void_p), rows, cols, nthreads)
    finally:
        lib.ht_csv_close(handle)
    if rc != 0:
        return None
    return out if cast_to is None else out.astype(cast_to)


def csv_parse(path: str, header_lines: int = 0, sep: str = ",", dtype=np.float32,
              nthreads: int = 0) -> Optional[np.ndarray]:
    """A numeric CSV as a 2-D numpy array of ``dtype``; None where the
    native parser refuses the file (the caller then takes the Python
    route)."""
    if len(sep) != 1:
        return None
    lib = _load()
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    handle = lib.ht_csv_open(path.encode(), header_lines, sep.encode(), ctypes.byref(rows), ctypes.byref(cols))
    if not handle:
        return None
    return _parse_handle(lib, handle, sep, rows.value, cols.value, dtype, nthreads)


def csv_parse_range(path: str, offset: int, length: int, header_lines: int = 0, sep: str = ",", dtype=np.float32,
                    nthreads: int = 0) -> Optional[np.ndarray]:
    """The rows owned by the byte range ``[offset, offset + length)`` (a
    row belongs to the range holding its first byte and is parsed to its
    end; ``length < 0`` means to the end of the file), so ranges that
    partition the file give disjoint rows that cover it. None where the
    native parser refuses them."""
    if len(sep) != 1:
        return None
    lib = _load()
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    handle = lib.ht_csv_open_range(path.encode(), header_lines, sep.encode(), offset, length, ctypes.byref(rows),
                                   ctypes.byref(cols))
    if not handle:
        return None
    return _parse_handle(lib, handle, sep, rows.value, cols.value, dtype, nthreads)


class FileStream:
    """A byte range of a file read ahead by a native thread in slabs of
    ``chunk_bytes``, ``depth`` slabs deep. Iterating yields uint8 arrays
    of at most ``chunk_bytes``; usable as a context manager."""

    def __init__(self, path: str, offset: int = 0, length: Optional[int] = None, chunk_bytes: int = 1 << 20,
                 depth: int = 4):
        lib = _load()
        if length is None:
            length = max(0, os.path.getsize(path) - offset)
        self._lib = lib
        self._chunk = chunk_bytes
        self._handle = lib.ht_stream_open(path.encode(), offset, length, chunk_bytes, depth)
        if not self._handle:
            raise OSError(f"cannot open stream on {path!r}")

    def read_next(self) -> Optional[np.ndarray]:
        """The next slab, or None at the end of the range."""
        if self._handle is None:
            return None
        buf = np.empty(self._chunk, dtype=np.uint8)
        n = self._lib.ht_stream_next(self._handle, buf.ctypes.data_as(ctypes.c_void_p), self._chunk)
        if n < 0:
            raise OSError(f"native stream read failed (code {n})")
        return None if n == 0 else buf[:n]

    def __iter__(self):
        while True:
            slab = self.read_next()
            if slab is None:
                return
            yield slab

    def close(self) -> None:
        if self._handle is not None:
            self._lib.ht_stream_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except (OSError, AttributeError):
            pass
