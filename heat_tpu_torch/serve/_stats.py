"""Serving-layer counters riding the :mod:`heat_tpu_torch.core._hooks`
observer slot, beside LAYOUT/MOVE/STREAM/KERNEL_STATS (counterpart of
``heat_tpu/serve/_stats.py``, event for event).

The service emits passive ``serve.*`` events (see
:func:`heat_tpu_torch.core._hooks.observe`):

- ``serve.request`` (``depth``) — a request was enqueued; ``depth`` is
  the queue depth right after the append (gauge + high-water mark);
- ``serve.batch`` (``requests``, ``rows``, ``bucket``, ``hit``) — one
  shape-bucketed batch was dispatched: ``rows`` real rows padded up to
  ``bucket``; ``hit`` says this (endpoint, bucket) was dispatched
  before, i.e. every program it runs is warm;
- ``serve.latency`` (``ms``) — one request completed, measured from
  enqueue to result-ready (the client-visible number);
- ``serve.error`` — a dispatch raised; the fault ladder takes over and
  the service lives on;
- ``serve.retry`` (``attempt``) — a transiently-failed batch is being
  re-run under the RetryPolicy backoff schedule;
- ``serve.bisect`` (``requests``) — retry exhausted (or a poison-class
  failure): the batch is being bisected to isolate the poison request(s);
- ``serve.restore`` (``cause``) — resident models were rolled back to
  the last registry snapshot;
- ``serve.shrink`` (``old``, ``new``) — the mesh was shrunk to its
  healthy devices and the registry elastically restored onto it;
- ``serve.grow`` (``old``, ``new``) — the mesh was grown back over
  healed devices and the registry elastically restored onto it;
- ``serve.scale`` (``direction``, ``old``, ``new``) — one
  autoscaler-initiated scale event (proactive shrink or grow), as
  opposed to the reactive fault-ladder shrink;
- ``serve.depth`` (``depth``) — the dispatcher finished a unit of work;
  ``depth`` is the request queue depth it left behind (keeps the
  ``queue_depth`` gauge fresh across drains — enqueue-only updates left
  it stale at the pre-drain value);
- ``serve.redispatch`` (``requests``) — in-flight requests were
  re-dispatched after a restore/shrink recovery;
- ``serve.shed`` (``endpoint``, ``waited_ms``) — a request's deadline
  expired in the queue; it was answered with ``ServeDeadlineError``
  before padding a batch;
- ``serve.rejected`` (``depth``) — admission control fast-rejected a
  submit past the high-water queue depth (``ServeOverloadError``);
- ``serve.tick`` (``batches``, ``shed``, ``call``, ``monitor``) — one
  AGREED replicated dispatch tick was applied (every rank counts the
  same ticks — the rank-local due checks and declined rendezvous are
  not events): ``batches``/``shed`` say what the tick's plan dispatched
  and expired, ``call``/``monitor`` whether it released a control call
  or carried a piggybacked health-monitor tick.

One module-level observer folds them into :data:`SERVE_STATS`; the
percentile gauges are recomputed from a bounded latency ring on
:func:`refresh_latency_stats` (called by ``ServeService.stats()``), not
per event. All writers take the module lock — events arrive from client
threads and the dispatcher thread concurrently.
"""
from __future__ import annotations

import threading
from collections import deque

from ..core import _hooks

__all__ = ["SERVE_STATS", "reset_serve_stats", "refresh_latency_stats"]

SERVE_STATS = {
    "requests": 0,
    "batches": 0,
    "batched_rows": 0,      # real rows dispatched inside batches
    "padded_rows": 0,       # bucket padding overhead (dead rows)
    "bucket_hits": 0,       # batches whose (endpoint, bucket) was warm
    "bucket_misses": 0,
    "errors": 0,
    "retries": 0,           # fault ladder: transient batch re-runs
    "bisections": 0,        # fault ladder: poison-isolation episodes
    "restores": 0,          # fault ladder: registry snapshot rollbacks
    "shrinks": 0,           # fault ladder / autoscaler: elastic mesh shrinks
    "grows": 0,             # autoscaler: elastic re-grows onto healed devices
    "scale_events": 0,      # autoscaler-initiated scale actions (both ways)
    "redispatched": 0,      # requests re-dispatched after a recovery
    "shed": 0,              # requests shed on an expired deadline
    "rejected": 0,          # submits fast-rejected by admission control
    "ticks": 0,             # agreed replicated dispatch ticks applied
    "tick_batches": 0,      # batches dispatched by tick plans
    "tick_sheds": 0,        # deadline sheds decided by tick plans
    "queue_depth": 0,       # gauge: depth at the last enqueue OR dispatch
    "max_queue_depth": 0,
    "p50_latency_ms": 0.0,  # gauges: refreshed from the latency ring
    "p99_latency_ms": 0.0,
}

_LOCK = threading.Lock()
_LATENCIES: "deque" = deque(maxlen=4096)


def reset_serve_stats() -> None:
    """Zero :data:`SERVE_STATS` and the latency ring (test/bench
    isolation)."""
    with _LOCK:
        for k in SERVE_STATS:
            SERVE_STATS[k] = 0.0 if k.endswith("_ms") else 0
        _LATENCIES.clear()


def refresh_latency_stats() -> None:
    """Recompute the p50/p99 gauges from the latency ring."""
    with _LOCK:
        if not _LATENCIES:
            return
        xs = sorted(_LATENCIES)
        n = len(xs)
        SERVE_STATS["p50_latency_ms"] = xs[min(n - 1, int(0.50 * n))]
        SERVE_STATS["p99_latency_ms"] = xs[min(n - 1, int(0.99 * n))]


def _observer(event: str, ctx: dict) -> None:
    if not event.startswith("serve."):
        return
    with _LOCK:
        if event == "serve.request":
            SERVE_STATS["requests"] += 1
            depth = int(ctx.get("depth", 0))
            SERVE_STATS["queue_depth"] = depth
            if depth > SERVE_STATS["max_queue_depth"]:
                SERVE_STATS["max_queue_depth"] = depth
        elif event == "serve.batch":
            SERVE_STATS["batches"] += 1
            rows = int(ctx.get("rows", 0))
            bucket = int(ctx.get("bucket", rows))
            SERVE_STATS["batched_rows"] += rows
            SERVE_STATS["padded_rows"] += max(0, bucket - rows)
            if ctx.get("hit"):
                SERVE_STATS["bucket_hits"] += 1
            else:
                SERVE_STATS["bucket_misses"] += 1
        elif event == "serve.latency":
            _LATENCIES.append(float(ctx.get("ms", 0.0)))
        elif event == "serve.error":
            SERVE_STATS["errors"] += 1
        elif event == "serve.retry":
            SERVE_STATS["retries"] += 1
        elif event == "serve.bisect":
            SERVE_STATS["bisections"] += 1
        elif event == "serve.restore":
            SERVE_STATS["restores"] += 1
        elif event == "serve.shrink":
            SERVE_STATS["shrinks"] += 1
        elif event == "serve.grow":
            SERVE_STATS["grows"] += 1
        elif event == "serve.scale":
            SERVE_STATS["scale_events"] += 1
        elif event == "serve.depth":
            # dispatch/drain-side gauge refresh: without it the gauge
            # stays at the depth of the LAST ENQUEUE after a drain
            SERVE_STATS["queue_depth"] = int(ctx.get("depth", 0))
        elif event == "serve.redispatch":
            SERVE_STATS["redispatched"] += int(ctx.get("requests", 1))
        elif event == "serve.shed":
            SERVE_STATS["shed"] += 1
        elif event == "serve.rejected":
            SERVE_STATS["rejected"] += 1
        elif event == "serve.tick":
            SERVE_STATS["ticks"] += 1
            SERVE_STATS["tick_batches"] += int(ctx.get("batches", 0))
            SERVE_STATS["tick_sheds"] += int(ctx.get("shed", 0))


_hooks.add_observer(_observer)
