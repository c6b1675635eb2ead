"""The resident service: event loop + one dispatch thread (counterpart of
``heat_tpu/serve/service.py``).

One :class:`ServeService` holds its models on the cards for its lifetime.
Client threads ``submit()`` requests (numpy rows + an endpoint name) and
block on :meth:`Request.result`; ONE dispatcher thread drains the queue,
forms shape-bucketed batches (:mod:`heat_tpu_torch.serve.batching`), runs
each batch through its endpoint, and scatters result rows back to the
waiting requests. All device work happens on the dispatcher thread: each
rank's collectives are then issued by one thread in one order. A batch is
staged to the card in one copy and its result read back to the host once;
each request receives only its own rows.

Dispatch triggers, and the multi-rank contract
----------------------------------------------
A pending batch dispatches when (a) it reaches ``policy.max_batch`` rows,
(b) its oldest request has waited ``policy.max_latency_ms``, or (c) a
barrier forces it: ``flush()``, ``drain()``, ``close()``, or any
``submit_call``. ``flush()`` enqueues a no-op control call, so the barrier
has a deterministic position in the queue.

Above world size 1, (a) and (b) as local checks would fire at different
moments on different ranks. The REPLICATED DISPATCH TICK
(:mod:`heat_tpu_torch.serve.tick`) re-arms both: the dispatcher takes
exactly one ``replicated_decision`` per iteration on whether any rank is
due, and on an agreed tick every rank exchanges one fixed-width frame of
queue metadata over the base group (``WORLD``) and runs the same pure
plan function, so which buckets dispatch, which requests shed, and when a
control call runs are decided identically on every rank. The same frame
carries the health monitor's probe exports and the autoscaler's grow
votes. With ``tick_ms=0`` the service falls back to barrier-driven
dispatch.

The request-survival contract
-----------------------------
Every ACCEPTED request is answered exactly once, with result rows or a
typed error. A failed batch climbs ``heat_tpu``'s fault ladder:

- transient ``OSError``/``TimeoutError``: re-run the batch under the
  :class:`~heat_tpu_torch.resilience.RetryPolicy` schedule; exhausted
  retries escalate to bisection;
- payload-class failures (``ValueError``/``TypeError``/...): BISECT the
  batch until the poison request(s) are answered with
  :class:`~heat_tpu_torch.resilience.PoisonRequestError` while their
  neighbours get their rows;
- ``CollectiveTimeout``/``DivergenceError``: restore the registry from its
  last snapshot and replay the batch once;
- ``RuntimeError`` (a CUDA error or NCCL's ``DistBackendError``: a lost
  card): ``probe`` + the unhealthy set made the same on every rank
  (:func:`~heat_tpu_torch.core.communication.replicated_ids`),
  ``shrink_to_healthy`` with the models' live arrays moved onto the
  survivors' group, bit for bit (``heat_tpu`` restores its snapshot
  there instead), and the batch re-dispatched;
- ``NoHealthyDevicesError``: the batch is answered with the error.

The port's own rule: a rank the shrink excluded keeps taking part in the
tick (its process is alive, and that is how its card heals), but holds no
model rows: it answers its pending and later batch requests with a typed
:class:`~heat_tpu_torch.resilience.DegradeError` naming the rank, while
the survivors answer with rows. The contract then holds on every rank.

Admission control: ``max_queue_depth`` fast-rejects submits past the
high-water mark (:class:`~heat_tpu_torch.resilience.ServeOverloadError`)
where the depth is the same on every rank (world size 1: the live depth;
barrier-driven: accepts since the last barrier; with the tick armed above
world size 1 it stands down, and tick-decided deadline shedding bounds the
queue), and per-request deadlines shed expired requests with
:class:`~heat_tpu_torch.resilience.ServeDeadlineError` before they pad a
batch. Recovery activity is counted in ``SERVE_STATS``.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import _hooks
from ..core import communication as _comm
from ..core import factories
from ..resilience.errors import (
    DegradeError,
    NoHealthyDevicesError,
    PoisonRequestError,
    ResilienceError,
    ServeDeadlineError,
    ServeOverloadError,
)
from ..resilience.retry import RetryPolicy
from ..core.communication import (
    collective_lockstep,
    replicated_decision,
    replicated_frame,
    replicated_ids,
    sanitize_comm,
)
from ..core.dndarray import DNDarray
from . import tick as _tick
from .batching import BucketPolicy, PendingBatch, form_plan_batches
from .session import ModelRegistry
from ._stats import SERVE_STATS, refresh_latency_stats

__all__ = ["Request", "ServeService", "DEFAULT_DISPATCH_POLICY"]

# backoff for transient dispatch errors: fast, deterministic (seeded,
# zero jitter — every rank must sleep the same schedule), bounded
DEFAULT_DISPATCH_POLICY = RetryPolicy(
    max_attempts=3, base_delay=0.02, max_delay=0.5, multiplier=2.0,
    jitter=0.0, seed=0, max_elapsed=10.0,
)


def _classify_dispatch(exc: BaseException) -> str:
    """Map a dispatch exception to a ladder rung. The Supervisor's
    policy table with one serving-specific refinement: an exception that
    is none of the known infrastructure classes (``ValueError``,
    ``TypeError``, ...) is a PAYLOAD problem — bisect, don't die."""
    if isinstance(exc, NoHealthyDevicesError):
        return "fatal"
    if isinstance(exc, ResilienceError):
        # checked BEFORE OSError/TimeoutError: CollectiveTimeout
        # subclasses TimeoutError and must not be retried in place
        return "restore"
    if isinstance(exc, (OSError, TimeoutError)):
        return "retry"
    if isinstance(exc, RuntimeError):
        return "probe"
    return "bisect"


class Request:
    """One client request: ``payload`` rows bound for ``endpoint``.

    ``payload`` is host data shaped ``(rows, *row_shape)``; the result
    (set by the dispatcher) is the matching slice of the batch output.
    ``deadline_ms`` bounds the time the request may wait in the queue
    before it is shed with :class:`ServeDeadlineError` (None: no bound).
    ``answers`` counts ``_finish`` calls — the survival contract says it
    ends at exactly 1, and the tests assert it.
    """

    __slots__ = ("endpoint", "payload", "rows", "enqueue_t", "seq",
                 "deadline_ms", "deadline_t", "answers",
                 "_done", "_result", "_error")

    def __init__(self, endpoint: str, payload: np.ndarray,
                 deadline_ms: Optional[float] = None):
        self.endpoint = endpoint
        self.payload = payload
        self.rows = int(payload.shape[0])
        self.enqueue_t = time.monotonic()
        # admission order within the service (set under the queue lock
        # at accept time): the trace-invariant identity the replicated
        # tick plans speak in — identical for the same request on every
        # rank, unlike id() or enqueue wall time
        self.seq = -1
        self.deadline_ms = None if deadline_ms is None else float(deadline_ms)
        self.deadline_t = (
            None if deadline_ms is None
            else self.enqueue_t + float(deadline_ms) / 1e3
        )
        self.answers = 0
        self._done = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None

    def _finish(self, result=None, error: Optional[BaseException] = None) -> None:
        self.answers += 1
        if self._done.is_set():
            # first answer wins; extra calls are only COUNTED so the
            # never-answered-twice contract stays provable
            return
        self._result = result
        self._error = error
        _hooks.observe(
            "serve.latency", ms=(time.monotonic() - self.enqueue_t) * 1e3
        )
        self._done.set()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block until the dispatcher answered; returns the result rows
        or re-raises the dispatch error."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request to {self.endpoint!r} still pending")
        if self._error is not None:
            raise self._error
        return self._result


class _Call:
    """A control item: a closure executed on the dispatcher thread (the
    only thread allowed to do device work). Acts as a flush barrier."""

    __slots__ = ("fn", "_done", "_result", "_error")

    def __init__(self, fn: Callable):
        self.fn = fn
        self._done = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None

    def result(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError("control call still pending")
        if self._error is not None:
            raise self._error
        return self._result


class ServeService:
    """Persistent multi-tenant serving loop over the resident mesh.

    Parameters
    ----------
    policy : BucketPolicy
        Batching policy (bucket menu, max-batch, max-latency).
    registry : ModelRegistry
        Resident model registry; a fresh one when omitted.
    snapshot_dir : str, optional
        When set, the registry is snapshotted here every
        ``snapshot_every`` successful batches (on the dispatcher thread,
        so snapshots are ordered against traffic), and a dispatch error
        triggers a best-effort restore from the last snapshot before the
        service carries on.
    snapshot_every : int
        Snapshot cadence in batches (0 disables periodic snapshots).
    max_queue_depth : int, optional
        Admission high-water mark: a ``submit`` that would push the
        queue past this depth is fast-rejected with
        :class:`ServeOverloadError` (None: unbounded).
    retry : RetryPolicy, optional
        Backoff schedule for transiently-failed batch dispatches
        (default :data:`DEFAULT_DISPATCH_POLICY`).
    autoscaler : Autoscaler, optional
        A :class:`~heat_tpu_torch.serve.autoscale.Autoscaler` the dispatcher
        consults BETWEEN work units — never mid-batch, so in-flight
        requests are never dropped. A ``"shrink"`` verdict (the
        autoscaler's HealthMonitor degraded a device) or ``"grow"``
        verdict (a device healed, or sustained queue pressure with
        healed capacity available) rebuilds the default communicator,
        moves the resident models onto it, and resets the warm-bucket
        set: the fault ladder's shrink rung, but proactive. With the tick armed, the monitor's
        probe exports and the grow votes ride the dispatch frame (one
        heartbeat, not three allgathers).
    tick_ms : float, optional
        Replicated dispatch tick cadence (module docstring). ``None``
        (default): armed above world size 1 with the
        ``policy.max_latency_ms`` cadence, while world size 1 keeps the
        direct async triggers. ``0``: ticks disabled — above world size 1
        dispatch is then barrier-driven.
        ``> 0``: explicit cadence; forces tick mode even at ws==1
        (the replicated primitives pass through), which is how the
        unit tests drive the tick machinery in one process.
    """

    def __init__(
        self,
        policy: Optional[BucketPolicy] = None,
        registry: Optional[ModelRegistry] = None,
        snapshot_dir: Optional[str] = None,
        snapshot_every: int = 0,
        max_queue_depth: Optional[int] = None,
        retry: Optional[RetryPolicy] = None,
        autoscaler=None,
        tick_ms: Optional[float] = None,
    ):
        if max_queue_depth is not None and max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got {max_queue_depth}"
            )
        if tick_ms is not None and tick_ms < 0:
            raise ValueError(f"tick_ms must be >= 0, got {tick_ms}")
        self.policy = policy or BucketPolicy()
        self.registry = registry or ModelRegistry()
        self.snapshot_dir = snapshot_dir
        self.snapshot_every = int(snapshot_every)
        self.max_queue_depth = max_queue_depth
        self.retry = retry or DEFAULT_DISPATCH_POLICY
        self.autoscaler = autoscaler
        self._endpoints: Dict[str, Callable] = {}
        self._cond = threading.Condition()
        self._queue: List = []
        self._closed = False
        self._seen_buckets = set()
        self._have_snapshot = False
        self._batches_since_snapshot = 0
        # requests accepted since the last barrier: the rank-invariant
        # depth admission control uses under multiple controllers (the
        # instantaneous queue length races the dispatcher's pops at
        # rank-divergent moments)
        self._since_barrier = 0
        self._single = _comm.WORLD.size == 1
        if tick_ms is None:
            self._tick_armed = not self._single
            self._tick_s = self.policy.max_latency_ms / 1e3
        else:
            self._tick_armed = tick_ms > 0
            self._tick_s = float(tick_ms) / 1e3
        # the DIRECT latency timer and max-batch count trigger consult
        # rank-local state and fire at rank-divergent moments (see the
        # module docstring); arm them only when there is no other rank
        # to diverge from AND the replicated tick is not driving
        self._async_triggers = self._single and not self._tick_armed
        # trace-invariant admission order; plans identify requests by it
        self._next_seq = 0
        self._last_tick = -1.0
        # the health monitor's local probe export, parked between the
        # rank-local probe and the agreed tick that applies the gathered
        # union: (fail_ids, ewma_export, probes, autoscale votes)
        self._mon_stash = None
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="serve-dispatch"
        )
        self._thread.start()

    # ------------------------------------------------------------ endpoints
    def register_endpoint(self, name: str, fn: Callable) -> None:
        """Install a row-wise endpoint: ``fn(x: DNDarray) -> DNDarray``
        where output row ``i`` depends only on input row ``i`` (plus
        resident state) — the contract that makes bucket padding and
        result scattering safe."""
        if self._closed:
            raise RuntimeError("service is closed")
        self._endpoints[name] = fn

    def register_model(self, name: str, model, methods: Sequence[str] = ("predict",)):
        """Register ``model`` in the resident registry and expose one
        endpoint per method as ``"<name>.<method>"``. Endpoints resolve
        the model through the registry AT DISPATCH TIME, so a later
        ``registry.register(name, refreshed)`` swaps the model without
        touching endpoints."""
        self.registry.register(name, model)
        for method in methods:
            if not callable(getattr(model, method, None)):
                raise TypeError(f"{name!r} model has no callable {method!r}")
            self._endpoints[f"{name}.{method}"] = _model_endpoint(
                self.registry, name, method
            )

    def endpoints(self) -> List[str]:
        return sorted(self._endpoints)

    # ------------------------------------------------------------- clients
    def submit(self, endpoint: str, payload,
               deadline_ms: Optional[float] = None) -> Request:
        """Enqueue ``payload`` rows for ``endpoint``; returns a
        :class:`Request` future. ``payload`` is host data shaped
        ``(rows, *row_shape)`` (one sample: shape ``(1, ...)``).
        ``deadline_ms`` bounds queue wait: a request still undispatched
        past it is answered with :class:`ServeDeadlineError` instead of
        padding a batch (above world size 1 the replicated tick decides
        it, so every rank sheds the same requests). A submit past
        ``max_queue_depth`` raises :class:`ServeOverloadError` without
        enqueueing — a rejected request was never accepted."""
        if endpoint not in self._endpoints:
            raise KeyError(
                f"unknown endpoint {endpoint!r}; known: {self.endpoints()}"
            )
        payload = np.asarray(payload)
        if payload.ndim < 1 or payload.shape[0] < 1:
            raise ValueError("payload must be (rows, ...) with rows >= 1")
        request = Request(endpoint, payload, deadline_ms=deadline_ms)
        reject = None
        with self._cond:
            if self._closed:
                raise RuntimeError("service is closed")
            if self.max_queue_depth is not None:
                # the admission verdict must be trace-invariant (every
                # rank accepts/rejects the same submits). ws==1: the
                # live queue depth. Barrier-driven ws>1: accepts since
                # the last barrier (every rank submits the same trace,
                # so the count is identical everywhere). Tick-armed
                # ws>1: neither works — no barrier to anchor a count
                # to, and the live depth races the tick's pops at
                # rank-divergent moments — so depth admission stands
                # down and tick-decided deadline shedding bounds the
                # queue instead (module docstring). Control calls
                # (flush/drain sentinels, submit_call work) never
                # consume admission budget — only requests do.
                if self._single:
                    depth_now = sum(
                        1 for x in self._queue if not isinstance(x, _Call)
                    )
                elif not self._tick_armed:
                    depth_now = self._since_barrier
                else:
                    depth_now = None
                if depth_now is not None and depth_now >= self.max_queue_depth:
                    reject = depth_now
            if reject is None:
                request.seq = self._next_seq
                self._next_seq += 1
                self._queue.append(request)
                self._since_barrier += 1
                depth = len(self._queue)
                self._cond.notify()
        if reject is not None:
            _hooks.observe("serve.rejected", depth=reject)
            raise ServeOverloadError(reject, self.max_queue_depth)
        _hooks.observe("serve.request", depth=depth)
        return request

    def predict(self, name: str, payload, timeout: Optional[float] = None):
        """Synchronous convenience: submit to ``"<name>.predict"`` and
        wait for the rows."""
        return self.submit(f"{name}.predict", payload).result(timeout)

    def submit_call(self, fn: Callable) -> _Call:
        """Run ``fn()`` on the dispatcher thread, ordered after every
        currently pending request (a barrier). This is the door for
        anything that is NOT a row-wise map: ``fit``, ``partial_fit``,
        registry snapshots, model refreshes."""
        call = _Call(fn)
        with self._cond:
            if self._closed:
                raise RuntimeError("service is closed")
            self._queue.append(call)
            self._since_barrier = 0
            self._cond.notify()
        return call

    def feed(
        self,
        name: str,
        chunks,
        method: str = "partial_fit",
        depth: int = 2,
        timeout: Optional[float] = None,
    ) -> int:
        """Stream chunks into a resident model's incremental update
        (``partial_fit`` / ``update``), overlapping chunk production with
        device compute: :class:`heat_tpu_torch.stream.Prefetcher` runs the chunk source
        ``depth`` ahead on its producer thread while each update executes
        on the DISPATCHER thread (via :meth:`submit_call`, so updates are
        ordered against concurrent predict traffic). Tuple chunks splat
        into positional args — ``(x, y)`` feeds ``partial_fit(x, y)``.
        Returns the number of chunks applied."""
        from ..stream import Prefetcher

        registry = self.registry
        applied = 0
        pending: List[_Call] = []
        for chunk in Prefetcher(chunks, depth=depth):
            pending.append(self.submit_call(_feed_step(registry, name, method, chunk)))
            applied += 1
            # stay at most ``depth`` updates ahead of the dispatcher so
            # the chunk source is throttled by compute, not read whole
            while len(pending) > max(1, depth):
                pending.pop(0).result(timeout)
        for call in pending:
            call.result(timeout)
        return applied

    def flush(self) -> None:
        """Force-dispatch everything submitted before this call
        (non-blocking). Implemented as a no-op control call so the
        barrier sits at a deterministic queue position — requests
        submitted AFTER the flush stay pending, on every rank."""
        call = _Call(lambda: None)
        with self._cond:
            if self._closed:
                return
            self._queue.append(call)
            self._since_barrier = 0
            self._cond.notify()

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every request submitted before this call has been
        dispatched and answered. Safe to call mid-recovery: the fault
        ladder always terminates with every in-flight request answered,
        so the barrier behind it is reached regardless of which rung the
        dispatcher is currently climbing."""
        self.submit_call(lambda: None).result(timeout)

    def stats(self) -> dict:
        """Snapshot of SERVE_STATS with the latency percentiles
        refreshed."""
        refresh_latency_stats()
        snap = dict(SERVE_STATS)
        with self._cond:
            snap["queue_depth"] = len(self._queue)
        return snap

    def close(self, timeout: Optional[float] = None) -> None:
        """Flush outstanding work and stop the dispatcher thread."""
        with self._cond:
            if self._closed and not self._thread.is_alive():
                return
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout)

    def __enter__(self) -> "ServeService":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False

    # ----------------------------------------------------------- dispatcher
    def _loop(self) -> None:
        _bind_card()
        if self._tick_armed:
            self._tick_loop()
            return
        while True:
            with self._cond:
                work = self._pick_work()
                if work is None:
                    if self._closed and not self._queue:
                        return
                    self._cond.wait(self._wait_timeout())
                    continue
            kind, item = work
            if kind == "batch":
                self._dispatch_batch(item)
            elif kind == "shed":
                self._shed(item)
            else:
                self._run_call(item)
            # between work units — never mid-batch: refresh the depth
            # gauge (enqueue-only updates go stale across drains) and
            # give the autoscaler its consultation point
            with self._cond:
                depth = sum(
                    1 for x in self._queue if not isinstance(x, _Call)
                )
            _hooks.observe("serve.depth", depth=depth)
            if self.autoscaler is not None:
                self._autoscale(depth)

    # ------------------------------------------------- replicated tick mode
    def _tick_loop(self) -> None:
        """The tick-armed dispatcher (module docstring). Collective
        iteration makes exactly ONE ``replicated_decision`` (am I — or
        anyone — due?), and an agreed True is followed by exactly one
        ``replicated_frame`` exchange; the plan derived from it is a
        pure function of the gathered array, so the batch/shed/call
        programs it triggers run in one total order on every rank. The
        rank-local due check and the bounded waits never touch a
        collective, so clock drift only costs latency (a rank blocks in
        the rendezvous until the slowest peer's wait expires — at most
        one cadence), never divergence."""
        multi = not self._single
        while True:
            with self._cond:
                if not self._tick_due_locked():
                    self._cond.wait(self._tick_wait_locked())
                due = self._tick_due_locked()
            if not replicated_decision(due, _comm.WORLD, active=multi):
                continue
            plan = self._tick_exchange()
            if self._tick_apply(plan):
                return

    def _tick_due_locked(self) -> bool:
        """Rank-local: is there a reason to ask for a tick? Caller holds
        the lock. True on close (the drain/quit path needs frames), when
        the heartbeat interval elapsed (keeps the piggybacked health
        monitor ticking through idle traffic), or when locally
        actionable work should hurry the rendezvous: a pending control
        call, a full group, an over-age group, an expired deadline."""
        if self._closed:
            return True
        now = time.monotonic()
        if self._last_tick < 0 or (now - self._last_tick) >= self._tick_s:
            return True
        rows: Dict[tuple, int] = {}
        oldest = None
        for item in self._queue:
            if isinstance(item, _Call):
                return True
            key = (item.endpoint, item.payload.shape[1:], item.payload.dtype.str)
            rows[key] = rows.get(key, 0) + item.rows
            if rows[key] >= self.policy.max_batch:
                return True
            if oldest is None:
                oldest = item.enqueue_t
            if item.deadline_t is not None and now >= item.deadline_t:
                return True
        if oldest is not None:
            return (now - oldest) * 1e3 >= self.policy.max_latency_ms
        return False

    def _tick_wait_locked(self) -> float:
        """Seconds until this rank next turns due (interval remainder,
        oldest group's latency trigger, or nearest deadline — whichever
        lands first). Always finite: every rank re-enters the due
        rendezvous at least once per cadence, which bounds how long a
        peer can block in it."""
        now = time.monotonic()
        if self._last_tick < 0:
            return 1e-4
        remaining = self._tick_s - (now - self._last_tick)
        for item in self._queue:
            if isinstance(item, _Call):
                break
            remaining = min(
                remaining,
                self.policy.max_latency_ms / 1e3 - (now - item.enqueue_t),
            )
            if item.deadline_t is not None:
                remaining = min(remaining, item.deadline_t - now)
        return max(1e-4, remaining)

    def _tick_exchange(self) -> "_tick.TickPlan":
        """One agreed tick: snapshot the local queue view under the
        lock, bolt on the health monitor's probe export and the
        autoscaler's grow votes, exchange ONE replicated frame, and
        derive the pure plan every rank will apply identically."""
        with self._cond:
            self._last_tick = time.monotonic()
            now = self._last_tick
            call_at = len(self._queue)
            for i, item in enumerate(self._queue):
                if isinstance(item, _Call):
                    call_at = i
                    break
            buckets: Dict[tuple, list] = {}
            expired = []
            for item in self._queue[:call_at]:
                key = (
                    item.endpoint, item.payload.shape[1:], item.payload.dtype.str
                )
                record = buckets.get(key)
                if record is None:
                    buckets[key] = record = [0, 0, int(item.seq)]
                record[0] += 1
                record[1] += item.rows
                if item.deadline_t is not None and now >= item.deadline_t:
                    expired.append(int(item.seq))
            view = dict(
                seq=self._next_seq,
                closed=self._closed,
                qlen=len(self._queue),
                npending=call_at,
                have_call=call_at < len(self._queue),
                depth=sum(
                    1 for x in self._queue if not isinstance(x, _Call)
                ),
            )
            first_age_us: Dict[tuple, int] = {}
            for item in self._queue[:call_at]:
                key = (
                    item.endpoint, item.payload.shape[1:], item.payload.dtype.str
                )
                if key not in first_age_us:
                    first_age_us[key] = int((now - item.enqueue_t) * 1e6)
            frame_buckets = [
                (_tick.bucket_token(key), count, rows, first_age_us[key], first_seq)
                for key, (count, rows, first_seq) in buckets.items()
            ]
        mon = getattr(self.autoscaler, "monitor", None)
        mon_due = None
        mon_failed: list = []
        mon_ewmas_us: list = []
        votes = None
        if mon is not None:
            mon_due = False
            # advisory path (same contract as _autoscale): a failed
            # probe must never take down the dispatcher — this rank
            # just reports not-due and the piggybacked monitor tick
            # waits for a cleaner heartbeat
            try:
                if self._mon_stash is None and mon.local_due():
                    fail_ids, export, probes = mon.probe_local()
                    self._mon_stash = (
                        list(fail_ids), dict(export), int(probes),
                        self.autoscaler.pre_vote(view["depth"]),
                    )
            # absorbed; the reactive fault ladder owns hard faults
            # graftlint: G006 - reported as serve.error; the reactive ladder owns hard faults
            except Exception:  # noqa: BLE001
                _hooks.observe("serve.error", endpoint="<autoscale>")
            if self._mon_stash is not None:
                fail_ids, export, _, votes = self._mon_stash
                mon_due = True
                mon_failed = [int(d) for d in fail_ids]
                # µs·1000-free: quantization matches the monitor's own
                # health frame, int(round(ms * 1000.0)) microseconds
                mon_ewmas_us = [
                    (int(d), int(round(ms * 1000.0)))
                    for d, ms in export.items()
                ]
        frame = _tick.encode_frame(
            seq=view["seq"],
            closed=view["closed"],
            qlen=view["qlen"],
            npending=view["npending"],
            have_call=view["have_call"],
            buckets=frame_buckets,
            shed=expired,
            mon_due=mon_due,
            mon_failed=mon_failed,
            mon_ewmas_us=mon_ewmas_us,
            votes=votes,
        )
        gathered = replicated_frame(
            frame, label="collective.serve_tick", active=not self._single
        )
        return _tick.plan_dispatch(
            gathered,
            max_batch_rows=self.policy.max_batch,
            max_latency_us=int(self.policy.max_latency_ms * 1000),
        )

    def _tick_apply(self, plan: "_tick.TickPlan") -> bool:
        """Apply one replicated plan: pull the plan-selected requests
        and call out of the queue under the lock, then shed / dispatch /
        run them outside it, in the plan's (hence every rank's) order.
        Returns True when the plan says quit (all ranks closed and
        drained)."""
        with self._cond:
            call_at = len(self._queue)
            for i, item in enumerate(self._queue):
                if isinstance(item, _Call):
                    call_at = i
                    break
            by_token: Dict[int, list] = {}
            for item in self._queue[:call_at]:
                key = (
                    item.endpoint, item.payload.shape[1:], item.payload.dtype.str
                )
                by_token.setdefault(
                    _tick.bucket_token(key), (key, [])
                )[1].append(item)
            taken = set()
            shed_items: List[Request] = []
            batches: List[PendingBatch] = []
            for token, n in plan.dispatch:
                entry = by_token.get(token)
                if entry is None:
                    continue
                key, members = entry
                prefix = members[:n]
                taken.update(id(r) for r in prefix)
                live = [r for r in prefix if r.seq not in plan.shed]
                batches.extend(
                    form_plan_batches(key, live, self.policy.max_batch)
                )
            for item in self._queue[:call_at]:
                if item.seq in plan.shed:
                    shed_items.append(item)
                    taken.add(id(item))
            if taken:
                self._queue = [
                    x for x in self._queue if id(x) not in taken
                ]
            call = None
            if plan.run_call and self._queue and isinstance(
                self._queue[0], _Call
            ):
                call = self._queue.pop(0)
        # count the tick BEFORE its effects land: a client that has seen
        # a result (or a stats reader racing the dispatcher) then always
        # sees the tick that produced it already counted — the ordering
        # tests and the bench rely on when comparing tick_batches to
        # batches at quiescence points
        _hooks.observe(
            "serve.tick",
            batches=len(batches),
            shed=len(shed_items),
            call=int(call is not None),
            monitor=int(plan.monitor_tick),
        )
        if shed_items:
            self._shed(shed_items)
        for group in batches:
            self._dispatch_batch(group)
        if call is not None:
            self._run_call(call)
        if plan.monitor_tick and self._mon_stash is not None:
            fail_ids, _, probes, _ = self._mon_stash
            self._mon_stash = None
            mon = self.autoscaler.monitor
            # advisory, like _autoscale: a failed scale is absorbed
            try:
                report = mon.apply_gathered(
                    plan.mon_failed,
                    {int(d): us / 1000.0 for d, us in plan.mon_ewmas_us},
                    probes=probes,
                    failures=len(fail_ids),
                )
                want_grow = plan.grow_pressure or (
                    bool(report.healed) and plan.grow_ready
                )
                action = self.autoscaler.resolve(bool(want_grow), report)
                if action is not None:
                    self._scale(action)
            # take down the dispatcher; the ladder owns hard faults
            # graftlint: G006 - reported as serve.error; the reactive ladder owns hard faults
            except Exception:  # noqa: BLE001
                _hooks.observe("serve.error", endpoint="<autoscale>")
        with self._cond:
            depth = sum(1 for x in self._queue if not isinstance(x, _Call))
        _hooks.observe("serve.depth", depth=depth)
        return plan.quit

    def _pick_work(self):
        """Choose the next unit of work, FIFO by oldest member. Caller
        holds the lock; device work happens outside it."""
        if not self._queue:
            return None
        # the segment before the first control call; the call is a
        # barrier, so requests behind it stay out of this round's groups
        call_at = len(self._queue)
        for i, item in enumerate(self._queue):
            if isinstance(item, _Call):
                call_at = i
                break
        if self._async_triggers:
            # deadline shedding: expired requests are answered with the
            # typed error BEFORE they can pad a batch. Wall-clock driven,
            # hence single-controller only (same arming as the triggers)
            now = time.monotonic()
            expired = [
                item for item in self._queue[:call_at]
                if item.deadline_t is not None and now >= item.deadline_t
            ]
            if expired:
                doomed = set(map(id, expired))
                self._queue = [x for x in self._queue if id(x) not in doomed]
                return ("shed", expired)
        groups: Dict[tuple, PendingBatch] = {}
        for item in self._queue[:call_at]:
            key = (item.endpoint, item.payload.shape[1:], item.payload.dtype.str)
            if key not in groups:
                groups[key] = PendingBatch(key)
            groups[key].add(item)
        force = self._closed or call_at < len(self._queue)
        now = time.monotonic()
        for group in groups.values():  # insertion order = oldest first
            if (
                force
                or (
                    self._async_triggers
                    and (
                        group.rows >= self.policy.max_batch
                        or group.age_ms(now) >= self.policy.max_latency_ms
                    )
                )
            ):
                # cap each dispatch at max_batch rows: a burst then
                # becomes several batches in the SAME warm bucket rather
                # than one batch in a novel (cold) oversized bucket; a
                # single over-large request still dispatches alone
                chosen = PendingBatch(group.key)
                for request in group.requests:
                    if chosen.rows and chosen.rows + request.rows > self.policy.max_batch:
                        break
                    chosen.add(request)
                members = set(map(id, chosen.requests))
                self._queue = [x for x in self._queue if id(x) not in members]
                return ("batch", chosen)
        if call_at == 0:
            return ("call", self._queue.pop(0))
        return None

    def _wait_timeout(self) -> Optional[float]:
        """Seconds until the oldest pending group hits the latency
        trigger or the nearest request deadline expires (None: sleep
        until notified)."""
        if not self._async_triggers or not self._queue:
            return None
        oldest = None
        deadline = None
        for item in self._queue:
            if isinstance(item, _Call):
                break
            if oldest is None or item.enqueue_t < oldest:
                oldest = item.enqueue_t
            if item.deadline_t is not None and (
                deadline is None or item.deadline_t < deadline
            ):
                deadline = item.deadline_t
        if oldest is None:
            return None
        now = time.monotonic()
        remaining = self.policy.max_latency_ms / 1e3 - (now - oldest)
        if deadline is not None:
            remaining = min(remaining, deadline - now)
        return max(1e-4, remaining)

    def _shed(self, expired: List[Request]) -> None:
        """Answer deadline-expired requests with the typed error (off
        the lock — finishing wakes client threads and fires observers)."""
        now = time.monotonic()
        for request in expired:
            waited = (now - request.enqueue_t) * 1e3
            _hooks.observe(
                "serve.shed", endpoint=request.endpoint, waited_ms=waited
            )
            request._finish(error=ServeDeadlineError(
                request.endpoint, waited, request.deadline_ms
            ))

    def _dispatch_batch(self, group: PendingBatch) -> None:
        """Run one batch through the fault ladder (module docstring):
        retry -> bisect for payload faults, snapshot-restore + replay for
        suspect state, probe + shrink + redispatch for device loss.
        Terminates with EVERY request in ``group`` answered — result rows
        or a typed error — no matter which rungs fire. A rank outside the
        current group answers with :class:`DegradeError` naming itself."""
        endpoint = group.key[0]
        attempt = 0
        delays = None
        restored = False
        shrunk = False
        while True:
            comm = sanitize_comm(None)
            if not comm.is_member:
                self._fail_group(group, DegradeError(
                    f"rank {_comm.WORLD.rank} was excluded from the serving group {list(comm.ranks)}: "
                    f"its card is marked unhealthy, the request to {endpoint!r} is answered by the survivors"
                ))
                return
            try:
                self._execute(group)
                self._maybe_snapshot()
                return
            except Exception as exc:  # noqa: BLE001 - classified, never ignored
                _hooks.observe("serve.error", endpoint=endpoint)
                action = _classify_dispatch(exc)
                if action == "retry":
                    if delays is None:
                        delays = self.retry.delays()
                    if attempt < len(delays):
                        _hooks.observe(
                            "serve.retry", attempt=attempt + 1, endpoint=endpoint
                        )
                        self.retry.sleep(delays[attempt])
                        attempt += 1
                        continue
                    action = "bisect"  # retries exhausted: suspect a payload
                if action == "restore":
                    # resident state is suspect (divergence / deserted
                    # collective): roll back to the snapshot, replay once
                    if not restored and self._restore_registry(exc):
                        restored = True
                        _hooks.observe(
                            "serve.redispatch", requests=len(group.requests)
                        )
                        continue
                    self._fail_group(group, exc)
                    return
                if action == "probe":
                    # a lost card surfaces as a CUDA error or NCCL's DistBackendError
                    try:
                        handled = not shrunk and self._shrink_and_restore(exc)
                    except Exception as shrink_exc:  # noqa: BLE001 - e.g. nothing survives
                        self._fail_group(group, shrink_exc)
                        return
                    if handled:
                        shrunk = True
                        _hooks.observe(
                            "serve.redispatch", requests=len(group.requests)
                        )
                        continue
                    # probe found a healthy mesh: not a device problem
                    action = "bisect"
                if action == "bisect":
                    self._bisect(group, exc)
                    return
                # fatal (NoHealthyDevicesError, ...): answer and live on
                self._fail_group(group, exc)
                return

    def _execute(self, group: PendingBatch) -> None:
        """One batch attempt: stack, dispatch, scatter. Raises on any
        failure WITHOUT finishing requests — that is the ladder's call."""
        endpoint, row_shape, dtype_str = group.key
        stacked = group.stack(self.policy)
        bucket = int(stacked.shape[0])
        bucket_key = (endpoint, bucket, row_shape, dtype_str)
        hit = bucket_key in self._seen_buckets
        _hooks.fault_point(
            "serve.dispatch", endpoint=endpoint, bucket=bucket, rows=group.rows
        )
        x = factories.array(stacked, split=0)  # this rank's rows, staged to the card in one copy
        out = self._endpoints[endpoint](x)
        collective_lockstep(out)
        # the batch's one read back to the host
        host = out.numpy() if isinstance(out, DNDarray) else np.asarray(out.cpu() if hasattr(out, "cpu") else out)
        self._seen_buckets.add(bucket_key)
        _hooks.observe(
            "serve.batch",
            requests=len(group.requests),
            rows=group.rows,
            bucket=bucket,
            hit=hit,
        )
        offset = 0
        for request in group.requests:
            request._finish(result=host[offset:offset + request.rows])
            offset += request.rows

    def _fail_group(self, group: PendingBatch, exc: BaseException) -> None:
        for request in group.requests:
            request._finish(error=exc)

    def _bisect(self, group: PendingBatch, cause: BaseException) -> None:
        """Isolate the poison request(s): re-run halves of the failed
        batch until every still-failing singleton is answered with
        :class:`PoisonRequestError` — its former batch neighbors get
        their rows from the succeeding halves."""
        endpoint = group.key[0]
        requests = list(group.requests)
        found: List[Request] = []

        def fail_one(request: Request, exc: BaseException) -> None:
            found.append(request)
            request._finish(error=PoisonRequestError(endpoint, exc))

        def run(part: List[Request], exc: BaseException) -> None:
            if len(part) == 1:
                fail_one(part[0], exc)
                return
            mid = len(part) // 2
            for half in (part[:mid], part[mid:]):
                sub = PendingBatch(group.key)
                for request in half:
                    sub.add(request)
                try:
                    self._execute(sub)
                except Exception as sub_exc:  # noqa: BLE001 - recurse to isolate
                    _hooks.observe("serve.error", endpoint=endpoint)
                    run(half, sub_exc)

        if len(requests) == 1:
            fail_one(requests[0], cause)
        else:
            _hooks.observe("serve.bisect", requests=len(requests))
            run(requests, cause)
        if found:
            # a poison payload may have corrupted resident state before
            # raising: the old supervised-service rollback still applies
            self._maybe_restore(cause)

    def _shrink_and_restore(self, exc: BaseException) -> bool:
        """Device-loss recovery: probe, reach cross-rank consensus on the
        unhealthy set (over the base group, in which every rank takes
        part), shrink the default communicator onto the survivors with the
        models' live arrays moved along (the excluded rank sends its rows),
        and land the resident registry there. Returns False when the probe
        found every card healthy — the failure was not a device problem.
        Raises :class:`NoHealthyDevicesError` through when nothing
        survives."""
        from ..resilience import degrade

        comm = sanitize_comm(None)
        multi = not self._single
        try:
            degrade.probe(comm)
        except ResilienceError:
            raise
        except Exception:  # noqa: BLE001 - a dead probe proves nothing new
            pass
        bad = replicated_ids(degrade.unhealthy_devices(), active=multi)
        for dev in bad:
            degrade.mark_unhealthy(dev)
        if not replicated_decision(bool(bad & set(comm.ranks)), _comm.WORLD, active=multi):
            return False
        old = comm.size
        new_comm = self._resize(degrade.shrink_to_healthy, comm)
        _hooks.observe("serve.shrink", old=old, new=new_comm.size, cause=type(exc).__name__)
        return True

    def _resize(self, how, comm, **kwargs):
        """Move the resident models' live arrays onto the communicator
        ``how`` builds from ``comm`` (``shrink_to_healthy`` or
        ``grow_to_healthy``), make it the default, and reset the
        warm-bucket set. Every rank of ``comm`` takes part in the move, the
        one leaving too (it sends its rows). The move is how the port lands
        the registry on the new group, bit for bit; ``heat_tpu`` restores
        its ``state_dict`` models from the last snapshot instead, and
        counts that as a restore."""
        arrays = self._live_arrays()
        new_comm, moved = how(comm, [a for _, _, a in arrays], set_default=True, **kwargs)
        if new_comm is comm:
            return comm
        for (model, attr, _), x in zip(arrays, moved):
            setattr(model, attr, x)
        self._seen_buckets.clear()
        return new_comm

    def _live_arrays(self):
        """``(model, attribute, DNDarray)`` of every resident model's live
        arrays (fitted centres, training sets, coefficients), in registry
        order: what a resize moves."""
        out = []
        for name in self.registry.names():
            model = self.registry.get(name)
            for attr, value in sorted(vars(model).items()):
                if isinstance(value, DNDarray):
                    out.append((model, attr, value))
        return out

    # ---------------------------------------------------------- autoscaling
    def _autoscale(self, depth: int) -> None:
        """Consult the autoscaler between work units and apply its
        verdict. Advisory by contract: a scaling failure is absorbed
        (counted as a serve error) and the service lives on — hard
        device failures still ride the reactive fault ladder."""
        try:
            action = self.autoscaler.consult(depth)
            if action is not None:
                self._scale(action)
        # take down the dispatcher; the reactive ladder owns hard faults
        # graftlint: G006 - reported as serve.error; the reactive ladder owns hard faults
        except Exception:  # noqa: BLE001
            _hooks.observe("serve.error", endpoint="<autoscale>")

    def _scale(self, direction: str) -> None:
        """Apply one scale verdict on the dispatcher thread (the only
        thread allowed to do device work): rebuild the default
        communicator, move the resident models onto it, and reset the
        warm-bucket set — the shrink rung's contract, both ways. The
        verdict is the same on every rank, so every rank takes part."""
        from ..resilience import degrade

        comm = sanitize_comm(None)
        old = comm.size
        if direction == "shrink":
            new_comm = self._resize(degrade.shrink_to_healthy, comm)
        else:
            new_comm = self._resize(degrade.grow_to_healthy, comm, base=self.autoscaler.monitor.base)
        if new_comm is comm:
            return  # nothing to do (verdict already satisfied)
        _hooks.observe("serve.scale", direction=direction, old=old, new=new_comm.size)
        _hooks.observe(
            "serve.shrink" if direction == "shrink" else "serve.grow",
            old=old, new=new_comm.size, cause="autoscale",
        )

    def _run_call(self, call: _Call) -> None:
        try:
            call._result = call.fn()
        except Exception as exc:  # noqa: BLE001 - delivered to the caller
            call._error = exc
            _hooks.observe("serve.error", endpoint="<call>")
        call._done.set()

    # ------------------------------------------------- supervised snapshots
    def _maybe_snapshot(self) -> None:
        if not self.snapshot_dir or self.snapshot_every <= 0:
            return
        self._batches_since_snapshot += 1
        if self._batches_since_snapshot < self.snapshot_every:
            return
        self._batches_since_snapshot = 0
        try:
            _hooks.fault_point("serve.snapshot", directory=self.snapshot_dir)
            self.registry.snapshot(self.snapshot_dir)
            self._have_snapshot = True
        # layer's _replicated_raise discipline makes any multi-process
        # failure (ResilienceError included) symmetric, so every rank
        # absorbs it together and the NEXT cadence hit retries (the
        # previous good snapshot, if any, still stands)
        # graftlint: G006 - reported as serve.error; symmetric on every rank, retried next cadence
        except Exception:  # noqa: BLE001
            _hooks.observe("serve.error", endpoint="<snapshot>")

    def _restore_registry(self, exc: BaseException) -> bool:
        """Roll resident models back to the last snapshot ahead of a
        batch replay; False when there is nothing to restore from (or
        the restore itself failed, symmetrically on every rank)."""
        if not self.snapshot_dir or not self._have_snapshot:
            return False
        try:
            self.registry.restore(self.snapshot_dir)
        # False return escalates the ladder, nothing is lost silently
        # graftlint: G006 - reported as serve.error; the False return escalates the ladder
        except Exception:  # noqa: BLE001
            _hooks.observe("serve.error", endpoint="<restore>")
            return False
        _hooks.observe("serve.restore", cause=type(exc).__name__)
        return True

    def _maybe_restore(self, exc: BaseException) -> None:
        """After a batch ultimately failed, roll the resident models back
        to the last good snapshot (best-effort — the supervised-service
        loop; the failing requests already carry their error)."""
        if not self.snapshot_dir or not self._have_snapshot:
            return
        try:
            self.registry.restore(self.snapshot_dir)
            _hooks.observe("serve.restore", cause=type(exc).__name__)
        # failing requests already carry their typed error
        # graftlint: G006 - reported as serve.error; failing requests carry their typed error
        except Exception:  # noqa: BLE001
            _hooks.observe("serve.error", endpoint="<restore>")


def _bind_card() -> None:
    """Make the default card this thread's current CUDA device: a new thread
    starts on card 0, and the collectives take their tensors on the current
    card."""
    from ..core import devices

    dev = devices.get_device().torch_device
    if dev.type == "cuda":
        torch.cuda.set_device(dev)


def _model_endpoint(registry: ModelRegistry, name: str, method: str) -> Callable:
    def endpoint(x: DNDarray):
        return getattr(registry.get(name), method)(x)

    endpoint._cache_stable = True  # module-level factory, one per registration
    return endpoint


def _feed_step(registry: ModelRegistry, name: str, method: str, chunk) -> Callable:
    def step():
        bound = getattr(registry.get(name), method)
        return bound(*chunk) if isinstance(chunk, tuple) else bound(chunk)

    return step
