"""Fault-injection points and passive event observers (counterpart of
``heat_tpu/core/_hooks.py``: its injector and observer slots).

Code calls :func:`fault_point` where real deployments fail — file opens
and commits in :mod:`.io` (``"io.open"``, ``"io.write"``,
``"io.commit"``), state merges in :mod:`.communication`
(``"collective.tree_merge"``) — and the call does nothing unless an
injector is installed. A test installs one with :func:`set_injector` to
make a site raise or corrupt a payload, which exercises the retry and
atomic-rename paths on the CPU.

A deadline runner bounds the blocking calls that may wedge on the
interconnect: :func:`guarded_call` runs such a call (``"flatmove.ragged"``,
...) through the runner :func:`set_deadline_runner` installed, or directly
when none is.

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

__all__ = [
    "add_observer", "fault_point", "get_deadline_runner", "get_injector", "guarded_call", "observe",
    "remove_observer", "set_deadline_runner", "set_injector",
]

# the active injector: fn(name, ctx) -> None; it may raise to simulate a fault at
# the site, or change mutable ctx values (a bytearray payload) in place. None: off.
_INJECTOR: Optional[Callable[[str, Dict], None]] = None
_OBSERVERS = []
# the active deadline runner: fn(label, callable, args, kwargs) -> result. None: calls run inline.
_DEADLINE_RUNNER = None


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


def set_deadline_runner(runner):
    """Install (or with None remove) the process-wide deadline runner;
    returns the previous one, so contexts nest."""
    global _DEADLINE_RUNNER
    prev = _DEADLINE_RUNNER
    _DEADLINE_RUNNER = runner
    return prev


def get_deadline_runner():
    return _DEADLINE_RUNNER


def guarded_call(label: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under the deadline runner, which names the
    call ``label`` in any timeout it raises; a direct call when no runner
    is installed."""
    if _DEADLINE_RUNNER is None:
        return fn(*args, **kwargs)
    return _DEADLINE_RUNNER(label, fn, args, kwargs)


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
