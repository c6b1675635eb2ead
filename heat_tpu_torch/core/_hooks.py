"""Fault-injection points and passive event observers (counterpart of
``heat_tpu/core/_hooks.py``: its injector and observer slots).

Code calls :func:`fault_point` where real deployments fail — file opens
and commits in :mod:`.io` (``"io.open"``, ``"io.write"``,
``"io.commit"``), state merges in :mod:`.communication`
(``"collective.tree_merge"``) — and the call does nothing unless an
injector is installed. A test installs one with :func:`set_injector` to
make a site raise or corrupt a payload, which exercises the retry and
atomic-rename paths on the CPU.

Observers only record: :func:`observe` reports an event (the
``"stream.*"`` family of the chunked pipeline: ``stream.chunk`` with
``rows`` and ``nbytes``, ``stream.prefetch_hit``, ``stream.stall``,
``stream.overlap`` with ``seconds``) to every observer, which is how
:mod:`heat_tpu_torch.stream` keeps ``STREAM_STATS``. Fault points are
reported to the observers too, before any injected fault fires. Both
slots cost one falsy check when empty.

This module imports nothing of the package, so any layer may call it.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

__all__ = ["add_observer", "fault_point", "get_injector", "observe", "remove_observer", "set_injector"]

# the active injector: fn(name, ctx) -> None; it may raise to simulate a fault at
# the site, or change mutable ctx values (a bytearray payload) in place. None: off.
_INJECTOR: Optional[Callable[[str, Dict], None]] = None
_OBSERVERS = []


def set_injector(injector: Optional[Callable[[str, Dict], None]]):
    """Install (or with None remove) the process-wide fault injector;
    returns the previous one, so a caller can restore it."""
    global _INJECTOR
    prev = _INJECTOR
    _INJECTOR = injector
    return prev


def get_injector() -> Optional[Callable[[str, Dict], None]]:
    return _INJECTOR


def fault_point(name: str, **ctx) -> Dict:
    """A fault-injection site named ``name`` (``"io.open"``, ...). The
    observers see it first; then the injector, if any, may raise or
    change ``ctx``, which is returned so the caller reads changed values
    back."""
    if _OBSERVERS:
        for fn in tuple(_OBSERVERS):
            fn(name, ctx)
    if _INJECTOR is not None:
        _INJECTOR(name, ctx)
    return ctx


def add_observer(fn):
    """Register a process-wide event observer ``fn(event, ctx)``; returns it."""
    _OBSERVERS.append(fn)
    return fn


def remove_observer(fn):
    """Remove an observer (no error if it is not registered)."""
    try:
        _OBSERVERS.remove(fn)
    except ValueError:
        pass


def observe(event: str, **ctx) -> None:
    """Report an instrumentation event to every observer."""
    if _OBSERVERS:
        for fn in tuple(_OBSERVERS):
            fn(event, ctx)
