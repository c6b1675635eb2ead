"""Streaming-pipeline counters (counterpart of ``heat_tpu/stream/_stats.py``).

The pipeline reports passive ``stream.*`` events through
:func:`heat_tpu_torch.core._hooks.observe`:

- ``stream.chunk`` (``rows``, ``nbytes``) — a chunk was read and staged;
- ``stream.prefetch_hit`` — the consumer found the next chunk already read;
- ``stream.stall`` — the consumer had to wait for the producer;
- ``stream.overlap`` (``seconds``) — producer read time hidden behind the
  consumer's work, reported once per pipeline.

One observer folds them into :data:`STREAM_STATS`.
"""
from __future__ import annotations

from ..core import _hooks

__all__ = ["STREAM_STATS", "reset_stream_stats"]

STREAM_STATS = {"chunks": 0, "bytes_read": 0, "prefetch_hits": 0, "stalls": 0, "overlap_seconds": 0.0}


def reset_stream_stats() -> None:
    """Zero :data:`STREAM_STATS`."""
    STREAM_STATS.update(chunks=0, bytes_read=0, prefetch_hits=0, stalls=0, overlap_seconds=0.0)


def _observer(event: str, ctx: dict) -> None:
    if event == "stream.chunk":
        STREAM_STATS["chunks"] += 1
        STREAM_STATS["bytes_read"] += int(ctx.get("nbytes", 0))
    elif event == "stream.prefetch_hit":
        STREAM_STATS["prefetch_hits"] += 1
    elif event == "stream.stall":
        STREAM_STATS["stalls"] += 1
    elif event == "stream.overlap":
        STREAM_STATS["overlap_seconds"] += float(ctx.get("seconds", 0.0))


_hooks.add_observer(_observer)
