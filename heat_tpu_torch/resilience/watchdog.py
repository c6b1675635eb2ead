"""The collective watchdog: deadlines on blocking calls (counterpart of
``heat_tpu/resilience/watchdog.py``).

An SPMD job's worst failure is the hang: a straggling rank in a gather, a
wedged exchange in ``flatmove``, and every rank waits forever with no error.
This module turns such waits into structured failures:

- :func:`with_deadline` wraps one callable: it runs on a worker thread, and
  if it has not finished after ``timeout`` seconds the caller gets
  :class:`~heat_tpu_torch.resilience.errors.CollectiveTimeout` with the
  call's label and the time spent;
- :func:`deadlines` is the job-wide switch: a context that installs a
  deadline runner into :mod:`heat_tpu_torch.core._hooks`, so that every
  labelled blocking call (``flatmove.ragged``/``flatmove.bucket``/
  ``flatmove.strided``/``flatmove.reshape``, ``collective.allgather``,
  ``tree_merge``) runs bounded inside the block. Outside it those calls run
  directly, at no cost.

A ``TimeoutError`` raised inside a bounded call (``chaos(timeout=...)``)
becomes the same :class:`CollectiveTimeout`, and an injected ``straggler``
delay meets the real wall-clock deadline, so the watchdog is testable on
the CPU without real hangs.

A Python thread cannot be killed, nor can it cancel a collective that NCCL
or gloo has started: after a timeout the worker thread is abandoned (a
daemon) and its late result discarded, and the job gets a structured error
instead of wedging with it. The communicator may then be unusable: a
collective the abandoned thread is still inside holds the group's order, so
the job should stop or restart its group (checkpoint, then start again)
rather than issue more collectives on it.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from functools import wraps
from typing import Callable, Optional

import torch

from ..core import _hooks
from .errors import CollectiveTimeout

__all__ = ["with_deadline", "deadlines", "current_deadline", "CollectiveTimeout"]

# poll granularity while waiting on the worker: fine enough that a fired
# deadline is reported promptly, coarse enough to cost nothing
_TICK = 0.005

# the active default deadline (seconds) while inside a deadlines() block;
# None means the watchdog is off
_ACTIVE: Optional[float] = None


def current_deadline() -> Optional[float]:
    """The deadline (seconds) installed by the innermost :func:`deadlines`
    block, or None when the watchdog is off."""
    return _ACTIVE


def _run_bounded(label: str, fn: Callable, args, kwargs, timeout: float):
    """Execute ``fn(*args, **kwargs)`` in a worker thread, bounded by
    ``timeout`` seconds. Returns the result, re-raises the callable's own
    exception (chaos/real TimeoutErrors upgraded to CollectiveTimeout),
    or raises CollectiveTimeout when the wait expires."""
    result: list = []
    error: list = []
    done = threading.Event()
    # the worker issues the call on the caller's card (a new thread starts on card 0)
    card = torch.cuda.current_device() if torch.cuda.is_available() and torch.cuda.is_initialized() else None

    def worker():
        try:
            if card is not None:
                torch.cuda.set_device(card)
            result.append(fn(*args, **kwargs))
        except BaseException as e:  # noqa: BLE001 - transported to caller
            error.append(e)
        finally:
            done.set()

    t0 = time.monotonic()
    thread = threading.Thread(target=worker, name=f"heat-tpu-torch-watchdog:{label}", daemon=True)
    thread.start()
    deadline = t0 + timeout
    while not done.is_set():
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise CollectiveTimeout(label, time.monotonic() - t0, timeout)
        done.wait(min(_TICK, remaining))
    if error:
        exc = error[0]
        if isinstance(exc, TimeoutError) and not isinstance(exc, CollectiveTimeout):
            # a timeout raised INSIDE the operation (chaos-injected, or a
            # lower transport layer's): surface it with the same structure
            raise CollectiveTimeout(
                label, time.monotonic() - t0, timeout, detail=str(exc)
            ) from exc
        raise exc
    return result[0]


def with_deadline(fn: Callable, timeout: float, label: Optional[str] = None) -> Callable:
    """Wrap ``fn`` so each call must finish within ``timeout`` seconds.

    The wrapped callable raises :class:`CollectiveTimeout` (carrying
    ``label`` and the elapsed time) instead of blocking forever; a
    ``TimeoutError`` raised by ``fn`` itself is upgraded to the same
    type. ``label`` defaults to the callable's qualified name.

    >>> safe_gather = with_deadline(ragged_process_allgather, 30.0,
    ...                             "collective.allgather")  # heat_tpu_torch.core.communication
    >>> blocks = safe_gather(local, axis=0)
    """
    if timeout <= 0:
        raise ValueError(f"timeout must be positive, got {timeout}")
    name = label or getattr(fn, "__qualname__", repr(fn))

    @wraps(fn)
    def bounded(*args, **kwargs):
        return _run_bounded(name, fn, args, kwargs, timeout)

    return bounded


@contextmanager
def deadlines(timeout: float):
    """Bound every labeled blocking path for the duration of the block.

    Installs a deadline runner into ``core._hooks``: while active, the
    labelled blocking calls (``flatmove.ragged``/``.bucket``/``.strided``/
    ``.reshape``, every move of ``redistribute_``, the frame's shuffles and
    ``resplit`` through them, and ``collective.allgather``) each get
    ``timeout`` seconds before a :class:`CollectiveTimeout` names the one
    that wedged::

        with resilience.deadlines(30.0):
            g = frame.groupby("k").sum()   # a straggling peer -> CollectiveTimeout, not a wedge

    Nests: the innermost deadline wins; exiting restores the previous one.
    """
    if timeout <= 0:
        raise ValueError(f"timeout must be positive, got {timeout}")

    def runner(label, fn, args, kwargs):
        return _run_bounded(label, fn, args, kwargs, timeout)

    global _ACTIVE
    prev_runner = _hooks.set_deadline_runner(runner)
    prev_active, _ACTIVE = _ACTIVE, float(timeout)
    try:
        yield
    finally:
        _ACTIVE = prev_active
        _hooks.set_deadline_runner(prev_runner)
