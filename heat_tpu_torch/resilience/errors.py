"""The error classes of the resilience layer (counterpart of
``heat_tpu/resilience/errors.py``, with its messages and fields).

Every failure the guards can raise derives from :class:`ResilienceError`,
so a caller catches the family with one ``except`` and still tells the
failures apart:

- :class:`DivergenceError`: replicated shards disagree
  (:func:`~heat_tpu_torch.resilience.guard.fingerprint` /
  :func:`~heat_tpu_torch.resilience.guard.guarded`);
- :class:`CollectiveTimeout`: a deadline-bound collective or movement
  outlasted its budget (:mod:`~heat_tpu_torch.resilience.watchdog`);
- :class:`LockstepError`: processes ran different collective sequences
  (``heat_tpu``'s lockstep sanitizer raises it; the port has no sanitizer
  yet and keeps the class for code that catches it);
- :class:`DegradeError` / :class:`NoHealthyDevicesError`: shrinking onto
  the healthy ranks cannot proceed, or a rank outside a shrunken group was
  asked to take part in it (:mod:`~heat_tpu_torch.resilience.degrade`);
- :class:`ServeError` and its kinds: the serving layer's request-survival
  errors (:mod:`heat_tpu_torch.serve`).

``CheckpointError`` and ``ValidationError`` join the family in their own
modules; ``RetryError`` lives in ``core`` and stays an ``OSError``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

__all__ = [
    "ResilienceError",
    "DivergenceError",
    "CollectiveTimeout",
    "LockstepError",
    "DegradeError",
    "NoHealthyDevicesError",
    "ServeError",
    "ServeOverloadError",
    "ServeDeadlineError",
    "PoisonRequestError",
]


class ResilienceError(RuntimeError):
    """Base class for every failure the resilience subsystem raises."""


class DivergenceError(ResilienceError):
    """Replicated shards of a DNDarray do not agree.

    Attributes
    ----------
    devices : tuple of int
        Ids of the devices whose shard digest differs from the majority
        of their replica group (ties name the whole group).
    groups : tuple
        One ``(split_start, ((device_id, digest), ...))`` entry per
        divergent replica group — the full evidence.
    label : str
        Where the check ran (op-boundary label or ``"guarded"``).
    """

    def __init__(
        self,
        message: str,
        *,
        devices: Sequence[int] = (),
        groups: Sequence[Tuple] = (),
        label: str = "guarded",
    ):
        super().__init__(message)
        self.devices = tuple(devices)
        self.groups = tuple(groups)
        self.label = label


class CollectiveTimeout(ResilienceError, TimeoutError):
    """A deadline-wrapped collective/resharding path exceeded its budget.

    Attributes
    ----------
    label : str
        Operation label (``"collective.assemble"``, ``"flatmove.ragged"``,
        ...).
    elapsed : float
        Seconds spent before the deadline fired.
    deadline : float
        The configured budget in seconds.
    """

    def __init__(self, label: str, elapsed: float, deadline: float, detail: str = ""):
        self.label = label
        self.elapsed = float(elapsed)
        self.deadline = float(deadline)
        msg = (
            f"collective watchdog: {label!r} exceeded its {deadline:.3g}s "
            f"deadline (elapsed {elapsed:.3g}s)"
        )
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


class LockstepError(ResilienceError):
    """Processes dispatched divergent collective sequences.

    Raised by the lockstep sanitizer (``heat_tpu``'s ``analysis.lockstep``)
    when the per-process order digests of the recorded ``collective.*``
    events disagree — the SPMD bug that would otherwise surface as a
    silent mesh-wide hang or a corrupted reduction.

    Attributes
    ----------
    seq : int
        Sequence number of the first divergent event (0-based, counted
        from sanitizer entry).
    site : str
        The fault-point site THIS process recorded at ``seq`` (e.g.
        ``"collective.allgather"``), or ``""`` when this process recorded
        fewer events than a peer (it *skipped* a collective).
    process_index : int
        This process's index.
    counts : tuple of int
        Per-process recorded event counts at check time — unequal counts
        are themselves proof of divergence.
    label : str
        Where the check ran (``"exit"``, ``"check"``, or a caller label).
    """

    def __init__(
        self,
        message: str,
        *,
        seq: int = -1,
        site: str = "",
        process_index: int = 0,
        counts: Sequence[int] = (),
        label: str = "check",
    ):
        super().__init__(message)
        self.seq = int(seq)
        self.site = site
        self.process_index = int(process_index)
        self.counts = tuple(int(c) for c in counts)
        self.label = label


class DegradeError(ResilienceError):
    """Graceful degradation (shrink-to-healthy) cannot proceed."""


class NoHealthyDevicesError(DegradeError):
    """Every device of the mesh has been marked unhealthy."""

    def __init__(self, total: int):
        self.total = int(total)
        super().__init__(
            f"all {total} mesh device(s) are marked unhealthy; nothing to shrink onto"
        )


class ServeError(ResilienceError):
    """Base class for the serving layer's request-survival contract
    errors (``heat_tpu.serve``): an accepted request is always
    answered — with rows or with one of these."""


class ServeOverloadError(ServeError):
    """Admission control fast-reject: the service queue is past its
    high-water depth. Raised in the SUBMITTING thread before the request
    is enqueued — a rejected request was never accepted, so the survival
    contract does not cover it (back off and resubmit).

    Attributes
    ----------
    depth : int
        Queue depth observed at rejection.
    high_water : int
        The configured admission limit.
    """

    def __init__(self, depth: int, high_water: int):
        self.depth = int(depth)
        self.high_water = int(high_water)
        super().__init__(
            f"serve queue overloaded: depth {depth} >= high water {high_water} "
            "— request rejected before enqueue (back off and resubmit)"
        )


class ServeDeadlineError(ServeError, TimeoutError):
    """A request's deadline expired while it waited in the queue; it was
    shed before padding a batch (dead rows never reach the device).

    Attributes
    ----------
    endpoint : str
        The endpoint the request was bound for.
    waited_ms : float
        How long the request sat in the queue before shedding.
    deadline_ms : float
        Its configured deadline.
    """

    def __init__(self, endpoint: str, waited_ms: float, deadline_ms: float):
        self.endpoint = endpoint
        self.waited_ms = float(waited_ms)
        self.deadline_ms = float(deadline_ms)
        super().__init__(
            f"request to {endpoint!r} shed: waited {waited_ms:.1f}ms past its "
            f"{deadline_ms:.1f}ms deadline"
        )


class PoisonRequestError(ServeError):
    """Batch bisection isolated THIS request as the one whose payload
    makes its endpoint fail; its batch neighbors were answered normally.
    The underlying endpoint failure is chained as ``__cause__`` and
    quoted in the message.

    Attributes
    ----------
    endpoint : str
        The endpoint that rejected the payload.
    """

    def __init__(self, endpoint: str, cause: BaseException):
        self.endpoint = endpoint
        super().__init__(
            f"poison request isolated by batch bisection on {endpoint!r}: "
            f"{type(cause).__name__}: {cause}"
        )
        self.__cause__ = cause
