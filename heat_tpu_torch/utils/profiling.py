"""Profiling hooks (counterpart of ``heat_tpu/utils/profiling.py``).

``trace`` captures a ``torch.profiler`` trace of the CPU and, where there
is one, the card into ``log_dir`` (TensorBoard / Chrome trace format),
``annotate`` names a region inside it (``record_function``), and ``Timer``
reads wall time after synchronizing the card, so that it measures the
work and not its enqueueing.
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch

__all__ = ["trace", "annotate", "force_sync", "Timer"]


def _tensors(x):
    """The tensors inside ``x`` (a tensor, a DNDarray, or nested lists,
    tuples and dicts of them)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif hasattr(x, "larray"):
        yield x.larray
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def force_sync(*arrays) -> None:
    """Block until the work producing ``arrays`` has run: the cards they
    live on are synchronized (every card in use when none is given)."""
    cards = {t.device for a in arrays for t in _tensors(a) if t.is_cuda}
    if not arrays and torch.cuda.is_available() and torch.cuda.is_initialized():
        cards = {torch.device("cuda", i) for i in range(torch.cuda.device_count())}
    for d in cards:
        torch.cuda.synchronize(d)


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """Capture a ``torch.profiler`` trace (CPU, and CUDA where a card is
    in use) into ``log_dir``; ``create_perfetto_link`` is accepted for
    ``heat_tpu``'s signature."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir))
    prof.start()
    try:
        yield prof
    finally:
        force_sync()
        prof.stop()


def annotate(name: str):
    """A named region that shows up inside a :func:`trace` capture."""
    return torch.profiler.record_function(name)


class Timer:
    """Wall-clock timer that synchronizes the card before it reads the
    clock: ``stop(x)`` waits for the work producing ``x`` (or for every
    card in use when given nothing)."""

    def __init__(self):
        self._t0: Optional[float] = None
        self.elapsed: Optional[float] = None

    def start(self) -> "Timer":
        force_sync()
        self._t0 = time.perf_counter()
        return self

    def stop(self, *block_on) -> float:
        force_sync(*block_on)
        self.elapsed = time.perf_counter() - self._t0
        return self.elapsed

    def __enter__(self) -> "Timer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
