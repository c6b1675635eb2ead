"""Runtime compile-and-transfer sanitizer (counterpart of
``heat_tpu/analysis/sanitizer.py``).

The static analyzers catch host syncs and unbounded caches they can see in
the source; this module counts what happens at run time and attributes it
to a region:

- **backend compiles** — programs the port compiles in this process: the
  ``nvcc`` builds of the CUDA kernels (:mod:`..core.kernels._build`) and the
  ``g++`` build of the native CSV parser (:mod:`..native`);
- **traces** — lazy plans built (a warm ``ht.lazy()`` chain builds none);
- **cache inserts** — new keys in any
  :class:`~heat_tpu_torch.core._cache.ExecutableCache`;
- **host syncs** — ``DNDarray.numpy()``/``item()``/``__bool__``-style
  fetches and the scans' fetches (the ``host.*`` events);
- **collectives** — every collective the communicator starts
  (``collective.*``).

Running totals live in :data:`COMPILE_STATS`. Per region::

    with sanitizer() as region:
        y = x.resplit(0) + 1
    region.assert_compiles(0)
    region.assert_no_host_sync()

torch has no transfer guard; ``sanitizer(block_host_sync=True)`` makes the
observer itself raise :class:`SanitizerError` at an unwaived ``host.*``
fetch (before any data moves), and ``COMPILE_STATS["transfer_guard_armed"]``
is 1 while it does. :func:`waive_host_sync` lets a block fetch anyway.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, List, Optional

from ..core import _hooks

__all__ = ["COMPILE_STATS", "SanitizerError", "sanitizer", "Region", "reset_compile_stats",
           "transfer_guard_active", "waive_host_sync"]

COMPILE_STATS: Dict[str, int] = {
    "backend_compiles": 0,  # nvcc/g++ builds in this process
    "traces": 0,            # lazy plans built
    "cache_inserts": 0,     # new keys entering any ExecutableCache
    "host_syncs": 0,        # DNDarray host fetches (numpy/item/scalar/fetch_found)
    "collectives": 0,       # collectives started
}
_STATS_KEYS = tuple(COMPILE_STATS)
# a gauge, not a counter: 1 while a block_host_sync region raises at fetches
COMPILE_STATS["transfer_guard_armed"] = 0


class SanitizerError(AssertionError):
    """A region broke a declared compile/transfer budget, or fetched to the
    host where that was blocked."""


# per thread: the open block_host_sync regions, and the depth of waivers
_TLS = threading.local()


def _blocking() -> List[str]:
    s = getattr(_TLS, "blocking", None)
    if s is None:
        s = _TLS.blocking = []
    return s


def _on_observe(event: str, ctx: dict) -> None:
    if event.startswith("host."):
        COMPILE_STATS["host_syncs"] += 1
        if _blocking() and not getattr(_TLS, "waived", 0):
            raise SanitizerError(f"{_blocking()[-1]}: host sync {event!r} inside a block_host_sync region")
    elif event == "cache.insert":
        COMPILE_STATS["cache_inserts"] += 1
    elif event.startswith("collective."):
        COMPILE_STATS["collectives"] += 1
    elif event == "build.compile":
        COMPILE_STATS["backend_compiles"] += 1
    elif event == "lazy.plan":
        COMPILE_STATS["traces"] += 1


_installed = False
_install_lock = threading.Lock()


def _install() -> None:
    """Register the observer once per process."""
    global _installed
    with _install_lock:
        if not _installed:
            _hooks.add_observer(_on_observe)
            _installed = True


# counting is always on, as LAYOUT_STATS/MOVE_STATS are
_install()


def reset_compile_stats() -> None:
    """Zero the running totals (regions are deltas and do not need this)."""
    for k in _STATS_KEYS:
        COMPILE_STATS[k] = 0


def transfer_guard_active() -> bool:
    """Whether a blocked host fetch really raises here: always, as the
    block is the observer's own (``heat_tpu`` probes jax's guard)."""
    return True


@contextmanager
def waive_host_sync():
    """Let the host fetches of this block through a ``block_host_sync``
    region (the runtime twin of the ``# graftlint: G004`` waiver)."""
    _TLS.waived = getattr(_TLS, "waived", 0) + 1
    try:
        yield
    finally:
        _TLS.waived -= 1


class Region:
    """Delta view of COMPILE_STATS between the region's entry and now."""

    def __init__(self, label: Optional[str] = None):
        self.label = label or "region"
        self.transfer_guard_armed = False
        self._entry = dict(COMPILE_STATS)

    def _delta(self, key: str) -> int:
        return COMPILE_STATS[key] - self._entry[key]

    @property
    def compiles(self) -> int:
        return self._delta("backend_compiles")

    @property
    def traces(self) -> int:
        return self._delta("traces")

    @property
    def cache_inserts(self) -> int:
        return self._delta("cache_inserts")

    @property
    def host_syncs(self) -> int:
        return self._delta("host_syncs")

    @property
    def collectives(self) -> int:
        return self._delta("collectives")

    def stats(self) -> Dict[str, int]:
        return {k: self._delta(k) for k in _STATS_KEYS}

    def assert_compiles(self, n: int) -> None:
        """The region compiled exactly ``n`` programs."""
        got = self.compiles
        if got != n:
            raise SanitizerError(f"{self.label}: expected exactly {n} backend compile(s), got {got} "
                                 f"(full deltas: {self.stats()})")

    def assert_max_compiles(self, n: int) -> None:
        got = self.compiles
        if got > n:
            raise SanitizerError(f"{self.label}: expected at most {n} backend compile(s), got {got} "
                                 f"(full deltas: {self.stats()})")

    def assert_no_host_sync(self) -> None:
        """No host fetch was observed in the region."""
        got = self.host_syncs
        if got:
            raise SanitizerError(f"{self.label}: expected no host sync, observed {got} "
                                 f"(full deltas: {self.stats()})")

    def __repr__(self) -> str:
        return f"Region({self.label!r}, {self.stats()})"


@contextmanager
def sanitizer(label: Optional[str] = None, block_host_sync: bool = False):
    """Open an accounting region over COMPILE_STATS. With
    ``block_host_sync=True`` an unwaived ``host.*`` fetch on this thread
    raises :class:`SanitizerError` at the call, before the fetch."""
    _install()
    region = Region(label)
    if not block_host_sync:
        yield region
        return
    region.transfer_guard_armed = True
    _blocking().append(region.label)
    COMPILE_STATS["transfer_guard_armed"] += 1
    try:
        yield region
    finally:
        COMPILE_STATS["transfer_guard_armed"] -= 1
        _blocking().pop()
