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
``"host.*"`` family of device-to-host fetches, ``"collective.*"`` for
every collective the communicator starts, ``"cache.insert"``, and
``"stream.*"`` family of the chunked pipeline: ``stream.chunk`` with
``rows`` and ``nbytes``, ``stream.prefetch_hit``, ``stream.stall``,
``stream.overlap`` with ``seconds``) to every observer, which is how
:mod:`heat_tpu_torch.stream` keeps ``STREAM_STATS``. Fault points are
reported to the observers too, before any injected fault fires. Both
slots cost one falsy check when empty.

Trace-safe mode (:func:`enter_trace_safe`) is a per-thread depth the lazy
layer holds while it infers a captured op's layout on ``meta`` tensors:
:func:`trace_barrier` sites (``balance_``, ``ragged_move``), which would
move rows between ranks, raise :class:`TraceBarrierError` there, and the
capture declines the op.

This module imports nothing of the package, so any layer may call it.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

__all__ = [
    "TraceBarrierError", "add_observer", "enter_trace_safe", "exit_trace_safe", "fault_point",
    "get_deadline_runner", "get_injector", "guarded_call", "in_trace_safe", "observe", "remove_observer",
    "set_deadline_runner", "set_injector", "trace_barrier",
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


# the per-thread depth of trace-safe mode: a serving thread inferring a layout
# must not turn another thread's eager calls into declines
_TRACE_SAFE = threading.local()


class TraceBarrierError(RuntimeError):
    """Raised by a row-moving site entered in trace-safe mode: the op cannot
    be captured and runs eagerly instead."""


def enter_trace_safe() -> None:
    _TRACE_SAFE.depth = getattr(_TRACE_SAFE, "depth", 0) + 1


def exit_trace_safe() -> None:
    _TRACE_SAFE.depth = getattr(_TRACE_SAFE, "depth", 0) - 1


def in_trace_safe() -> bool:
    """True while the calling thread infers a layout on meta tensors."""
    return getattr(_TRACE_SAFE, "depth", 0) > 0


def trace_barrier(label: str) -> None:
    """A site that moves rows between ranks (``"balance_"``,
    ``"ragged_move"``): nothing in eager execution, a
    :class:`TraceBarrierError` in trace-safe mode."""
    if getattr(_TRACE_SAFE, "depth", 0) > 0:
        raise TraceBarrierError(f"{label} moves rows between ranks and cannot run on meta tensors")
