"""Prefetch: read the next chunk while the consumer works on this one
(counterpart of ``heat_tpu/stream/prefetch.py``).

:class:`Prefetcher` runs the host half of a chunk source on a producer
thread: while the consumer computes on chunk k, the producer reads chunk
k + 1's raw window. For a :class:`~.chunked.ChunkIterator` the producer
runs only the raw reads (numpy and file I/O: no CUDA call, no
collective) and the device half — the host-to-card copy and the split —
runs on the consumer's thread inside ``__next__``. Every CUDA call and
every collective of the program then comes from one thread in program
order, which keeps the ranks' NCCL (or gloo) calls in the same order on
every rank. A generic iterable of already-staged chunks would make its
producer thread do device work: that stays allowed on one rank and falls
back to synchronous iteration on several.

Backpressure is a bounded queue: with ``depth >= 2`` at most ``depth``
raw windows are read ahead of the consumer; ``depth <= 0`` starts no
thread and reads each chunk when asked (the synchronous comparator).
A reader's exception is re-raised from ``__next__``; ``close()`` (also
``__exit__``/``__del__``) stops and joins the producer. Counters
(``STREAM_STATS``): a fetch that finds the next chunk ready is a
``prefetch_hit``, a wait on an empty queue a ``stall``, and at the end
``overlap_seconds`` is the producer's read time not spent keeping the
consumer waiting.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Iterable

from ..core import _hooks
from ..core.communication import get_comm
from .chunked import ChunkIterator

__all__ = ["Prefetcher"]

_ITEM, _ERR, _DONE = "item", "err", "done"


class Prefetcher:
    """Single-use iterator over ``chunks``, read ``depth`` ahead.

    Parameters
    ----------
    chunks : iterable
        The chunk source; iterated once, on the producer thread.
    depth : int
        Prefetch depth (default 2: double buffering); ``<= 0`` reads
        synchronously, without a thread.
    """

    def __init__(self, chunks: Iterable, depth: int = 2):
        self.depth = int(depth)
        self._closed = False
        self._reported = False
        self._exhausted = False
        self._producer_busy = 0.0
        self._consumer_wait = 0.0
        self._stager = None
        source = chunks
        if isinstance(chunks, ChunkIterator):
            # the producer thread runs the raw reads; staging happens in __next__
            self._stager = chunks._stage
            source = chunks._windows()
        elif self.depth > 0 and get_comm().size > 1:
            # staged chunks iterated on another thread would issue CUDA calls and collectives beside the
            # consumer's: read them inline instead
            self.depth = 0
        if self.depth <= 0:
            self._thread = None
            self._it = iter(source)
            return
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, self.depth - 1))
        self._stop = threading.Event()
        self._source = source
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ producer
    def _put(self, msg) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(msg, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _producer(self) -> None:
        try:
            it = iter(self._source)
            while not self._stop.is_set():
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    break
                self._producer_busy += time.perf_counter() - t0
                if not self._put((_ITEM, item)):
                    return
        except BaseException as exc:  # noqa: BLE001 - re-raised on the consumer's thread
            self._put((_ERR, exc))
        finally:
            self._put((_DONE, None))

    # ------------------------------------------------------------ consumer
    def __iter__(self):
        return self

    def __next__(self):
        if self._exhausted or self._closed:
            raise StopIteration
        if self._thread is None:  # synchronous: read inline
            try:
                item = next(self._it)
            except StopIteration:
                self._exhausted = True
                self._report()
                raise
            return self._stager(item) if self._stager is not None else item
        try:
            tag, item = self._q.get_nowait()
            hit = True
        except queue.Empty:
            _hooks.observe("stream.stall")
            hit = False
            t0 = time.perf_counter()
            while True:
                try:
                    tag, item = self._q.get(timeout=0.1)
                    break
                except queue.Empty:
                    if not self._thread.is_alive():  # a producer gone without its sentinel
                        self._exhausted = True
                        self._report()
                        raise StopIteration from None
            self._consumer_wait += time.perf_counter() - t0
        if tag is _DONE:
            self._exhausted = True
            self._report()
            raise StopIteration
        if tag is _ERR:
            self._exhausted = True
            self._report()
            raise item
        if hit:
            _hooks.observe("stream.prefetch_hit")
        return self._stager(item) if self._stager is not None else item

    # ------------------------------------------------------------ teardown
    def _report(self) -> None:
        if not self._reported:
            self._reported = True
            _hooks.observe("stream.overlap", seconds=max(0.0, self._producer_busy - self._consumer_wait))

    def close(self) -> None:
        """Stop the producer and join its thread (idempotent; the iterator
        then ends)."""
        if self._closed:
            return
        self._closed = True
        if self._thread is not None:
            self._stop.set()
            while self._thread.is_alive():  # drain, so a producer blocked in put() sees the stop flag
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    pass
                self._thread.join(timeout=0.05)
        self._report()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        # graftlint: G006 - interpreter teardown: modules may already be gone
        except BaseException:  # noqa: BLE001 - interpreter teardown: modules may already be gone
            pass
