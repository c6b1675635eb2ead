"""Opt-in deferred execution (counterpart of ``heat_tpu/core/lazy``):
DNDarray op chains recorded and run as one plan.

- :func:`~.capture.lazy` — context manager: supported ops inside the scope
  are recorded, and the graph runs at scope exit, its elementwise runs
  fused into ``lazy_fused`` kernel launches;
- :func:`~.capture.fuse` — the decorator form;
- ``FUSE_STATS`` / :func:`reset_fuse_stats` — capture and dispatch counts.

Importing this package hands the dispatchers of :mod:`.._operations` their
capture entry points; with no open scope each dispatch pays one check.
"""
from . import capture, evaluate, graph
from .capture import LazyDNDarray, LazyScope, fuse, lazy
from .evaluate import META_CACHE, PROGRAM_CACHE
from .graph import FUSE_STATS, reset_fuse_stats

from .. import _operations

_operations._capture = capture

__all__ = ["lazy", "fuse", "LazyScope", "LazyDNDarray", "FUSE_STATS", "reset_fuse_stats", "META_CACHE",
           "PROGRAM_CACHE"]
