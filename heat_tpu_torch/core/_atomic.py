"""Atomic file writes (counterpart of ``heat_tpu/core/_atomic.py``).

Every save of :mod:`.io` goes through here: write to
``<path>.tmp-<suffix>`` in the same directory, then ``os.replace`` onto the
destination. A crash, an injected fault or a torn write leaves at most a
stale temp file; a file saved before is never corrupted.

Fault-injection sites (:mod:`._hooks`):

- ``io.open``   — before the temp file is created;
- ``io.write``  — after the payload is staged, before the commit; the
  injector may truncate or corrupt the mutable payload (a torn write);
- ``io.commit`` — just before the ``os.replace``.
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional, Union

from . import _hooks

__all__ = ["atomic_write", "atomic_write_bytes", "tmp_path_for"]


def tmp_path_for(path: Union[str, os.PathLike], suffix: Optional[str] = None) -> str:
    """Temp-file name next to ``path``: ``<path>.tmp-<pid>`` by default.

    ``suffix`` overrides the pid — rank-serialized multi-host writers must
    pass a deterministic suffix so all processes stage into the SAME file.
    """
    path = os.fspath(path)
    return f"{path}.tmp-{os.getpid() if suffix is None else suffix}"


@contextlib.contextmanager
def atomic_write(path: Union[str, os.PathLike], suffix: Optional[str] = None) -> Iterator[str]:
    """Context manager yielding a temp path that is renamed onto ``path``
    only if the block completes; on any failure the temp file is removed
    and ``path`` is untouched.

    >>> with atomic_write("out.h5") as tmp:
    ...     write_everything_to(tmp)
    # out.h5 now exists (old contents replaced atomically), or the
    # exception propagated and out.h5 still holds its old contents.
    """
    path = os.fspath(path)
    _hooks.fault_point("io.open", path=path)
    tmp = tmp_path_for(path, suffix)
    try:
        yield tmp
        _hooks.fault_point("io.commit", path=path, tmp_path=tmp)
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise


def atomic_write_bytes(path: Union[str, os.PathLike], payload: bytes, suffix: Optional[str] = None) -> None:
    """Atomically write ``payload`` to ``path``.

    The payload passes through the ``io.write`` fault point as a mutable
    ``bytearray`` — an injected torn write truncates or flips bytes there,
    producing exactly the partial/corrupt file a real crash would, while
    the rename discipline still protects any previously-committed file.
    """
    with atomic_write(path, suffix=suffix) as tmp:
        buf = bytearray(payload)
        ctx = _hooks.fault_point("io.write", path=path, payload=buf)
        buf = ctx.get("payload", buf)
        with open(tmp, "wb") as f:
            f.write(buf)
            f.flush()
            os.fsync(f.fileno())
