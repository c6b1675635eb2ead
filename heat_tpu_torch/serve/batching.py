"""Shape-bucketed batching policy for the resident service (counterpart of
``heat_tpu/serve/batching.py``, rule for rule).

Every batch is rounded up to a small fixed menu of row counts (powers of
two by default), so a service sees a handful of batch shapes: each
(endpoint, bucket) is cold once (its first launch at that shape), then
warm. The kernels of this package take any row count, but a fixed menu
keeps the set of launch shapes, and the padding waste, bounded and known.

The padding contract: endpoints must be ROW-WISE maps (output row ``i``
depends only on input row ``i`` plus resident model state: predict,
transform, kNN queries). Dead padded rows then produce dead output rows,
which the service slices away when scattering results back to requests.
Padding is host numpy; the service stages the stacked, padded batch to the
card in one copy. Row-coupled programs (a global ``fit``, a reduction
over the batch) go through ``submit_call``, which runs them unbatched.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["BucketPolicy", "PendingBatch", "form_plan_batches"]

# power-of-two menu: small enough that a handful of cold dispatches
# covers all of it, dense enough that padding waste stays under 2x
DEFAULT_EDGES: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


class BucketPolicy:
    """Pad-to-bucket policy with max-batch and max-latency triggers.

    Parameters
    ----------
    edges : sequence of int
        Sorted menu of batch row counts; a batch of ``n`` real rows pads
        up to the smallest edge >= ``n`` (beyond the last edge: the next
        power of two, so oversized batches stay shape-stable too).
    max_batch : int
        Flush a pending group as soon as it holds this many real rows.
    max_latency_ms : float
        Flush a non-full group once its oldest request has waited this
        long. Both the timer and the count trigger consult rank-local
        state (a wall clock; this rank's queue view), so with multiple
        controllers they are never evaluated directly — the replicated
        dispatch tick (:mod:`heat_tpu_torch.serve.tick`) exchanges the
        underlying numbers in a fixed-width frame and re-derives both
        triggers from the gathered, rank-identical view (max-over-ranks
        age, min-over-ranks rows). ``max_latency_ms`` also sets the
        default tick cadence.
    """

    def __init__(
        self,
        edges: Sequence[int] = DEFAULT_EDGES,
        max_batch: int = 32,
        max_latency_ms: float = 2.0,
    ):
        if not edges:
            raise ValueError("edges must be non-empty")
        self.edges = tuple(sorted(int(e) for e in edges))
        if self.edges[0] < 1:
            raise ValueError("edges must be >= 1")
        self.max_batch = int(max_batch)
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_latency_ms = float(max_latency_ms)

    def bucket_rows(self, rows: int) -> int:
        """Padded row count for a batch of ``rows`` real rows."""
        if rows < 1:
            raise ValueError("a batch needs at least one row")
        for e in self.edges:
            if rows <= e:
                return e
        bucket = self.edges[-1]
        while bucket < rows:
            bucket *= 2
        return bucket

    def pad(self, stacked: np.ndarray) -> np.ndarray:
        """Zero-pad ``stacked`` along axis 0 up to its bucket."""
        bucket = self.bucket_rows(stacked.shape[0])
        if bucket == stacked.shape[0]:
            return stacked
        pad = [(0, bucket - stacked.shape[0])] + [(0, 0)] * (stacked.ndim - 1)
        return np.pad(stacked, pad)


class PendingBatch:
    """Requests for one (endpoint, row signature) awaiting dispatch.

    ``key`` is ``(endpoint, per-row shape, dtype)`` — only requests whose
    rows stack into one array share a batch. ``born`` is the enqueue time
    of the OLDEST member (the latency trigger watches it)."""

    __slots__ = ("key", "requests", "rows", "born")

    def __init__(self, key):
        self.key = key
        self.requests: List = []
        self.rows = 0
        self.born: Optional[float] = None

    def add(self, request) -> None:
        if self.born is None:
            self.born = request.enqueue_t
        self.requests.append(request)
        self.rows += request.rows

    def age_ms(self, now: Optional[float] = None) -> float:
        if self.born is None:
            return 0.0
        return ((now if now is not None else time.monotonic()) - self.born) * 1e3

    def stack(self, policy: BucketPolicy) -> np.ndarray:
        """One bucket-padded array holding every member's rows in
        request order."""
        stacked = np.concatenate([r.payload for r in self.requests], axis=0)
        return policy.pad(stacked)


def form_plan_batches(key, requests, max_batch: int) -> List[PendingBatch]:
    """Split a tick plan's request prefix for one bucket key into
    dispatchable batches, capped at ``max_batch`` real rows each — a
    burst becomes several batches in the SAME warm bucket rather than
    one batch in a novel (cold) oversized bucket; a single over-large
    request still dispatches alone. Pure request-order arithmetic over
    plan-selected inputs, so every rank forms the identical batch
    sequence."""
    batches: List[PendingBatch] = []
    current: Optional[PendingBatch] = None
    for request in requests:
        if (
            current is None
            or (current.rows and current.rows + request.rows > max_batch)
        ):
            current = PendingBatch(key)
            batches.append(current)
        current.add(request)
    return batches
