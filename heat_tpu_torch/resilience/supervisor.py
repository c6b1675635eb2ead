"""Self-healing supervised execution: detect -> recover -> resume
(counterpart of ``heat_tpu/resilience/supervisor.py``).

:class:`Supervisor` drives any iterative workload as a checkpointed step
loop with a fault-classification policy, so the job finishes by itself on
whatever group of ranks survives.

Fault classification (``heat_tpu``'s table, with torch's failures mapped
onto it):

======================================  =====================================
fault class                             action
======================================  =====================================
transient I/O (``OSError`` /            re-run the step under the
``TimeoutError`` outside the            :class:`RetryPolicy` backoff
ResilienceError tree)                   schedule
``DivergenceError`` /                   restore the last good checkpoint,
``CollectiveTimeout`` (and other        resume at its recorded step
``ResilienceError``)
repeated restores at the same step      escalate to probe + shrink
``RuntimeError``: a CUDA error, or      ``probe`` -> the unhealthy set made
NCCL's ``DistBackendError``             the same on every rank
                                        (``replicated_ids``) ->
                                        ``shrink_to_healthy`` -> elastic
                                        ``load_checkpoint`` onto the
                                        surviving ranks -> resume at the
                                        recorded step
``NoHealthyDevicesError`` / anything    fatal: re-raised (wrapped in
else / recovery budget exhausted        :class:`SupervisorError` where the
                                        supervisor itself gives up)
======================================  =====================================

``torch.OutOfMemoryError`` is a ``RuntimeError`` too: its probe passes,
so it is re-raised, as ``heat_tpu`` re-raises its own out-of-memory error.
The shrink needs every rank of the group it leaves alive and able to
communicate: the verdicts are unioned over that group, and the excluded
rank sends its rows over it. So it recovers from a card fault that a
probe sees while the process's collectives still work (a simulated
``device_loss``, a flapping card). A sticky CUDA error leaves the
process's CUDA context dead: its probe fails, but NCCL collectives
through that card fail too, so the survivors cannot finish the verdict
exchange or the move. Surviving that needs a new process group and store
(``ROADMAP.md`` item 10b's remaining hazard).

A *device* is a rank's card. A rank the shrink excludes **detaches**:
``run`` returns ``SupervisorResult(detached=True, state=None)`` there
(``heat_tpu``'s outcome for a process left with no device), while the
survivors go on over their own ``torch.distributed`` group, checkpoints
included (the group's rank 0 writes ``state.json``).

The step contract is ``step_fn(state, data, step) -> (state, done)`` where
``state`` is a dict of checkpointable entries (DNDarrays, numpy arrays,
JSON scalars) and ``data`` is a tuple of live input DNDarrays, which are
*moved* on a shrink but never checkpointed. The step directories
(``step-%08d``, each with ``state.json`` and ``arrays/<name>`` written by
:func:`~heat_tpu_torch.resilience.save_checkpoint`) are ``heat_tpu``'s
format, so a run checkpointed by one package resumes in the other.
:class:`CheckpointSchedule` decides cadence (every N steps and/or every T
seconds) and retention (keep-last-k with atomic removal of stale
directories). Recovery activity is counted in :data:`RECOVERY_STATS`, fed
through the :mod:`heat_tpu_torch.core._hooks` observer slot.

With no directory the loop is a bare Python loop around ``step_fn``: no
extra collective and no host read per step.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import _hooks
from ..core._atomic import atomic_write_bytes
from ..core.communication import replicated_decision, replicated_ids, sanitize_comm
from ..core.dndarray import DNDarray
from .checkpoint import load_checkpoint, save_checkpoint
from .degrade import grow_to_healthy, mark_unhealthy, probe, shrink_to_healthy, unhealthy_devices
from .errors import NoHealthyDevicesError, ResilienceError
from .guard import check as check_divergence
from .retry import DEFAULT_CHECKPOINT_POLICY, RetryPolicy

__all__ = [
    "CheckpointSchedule",
    "RECOVERY_STATS",
    "Supervisor",
    "SupervisorError",
    "SupervisorResult",
    "reset_recovery_stats",
    "supervise",
]

STATE_NAME = "state.json"
SUPERVISOR_FORMAT = "heat_tpu.supervisor.v1"
_STEP_DIR_RE = re.compile(r"^step-(\d{8})$")

# default backoff for transient step errors: fast, deterministic, bounded
DEFAULT_STEP_POLICY = RetryPolicy(
    max_attempts=3, base_delay=0.05, max_delay=1.0, multiplier=2.0, jitter=0.1,
    seed=0, max_elapsed=30.0,
)


class SupervisorError(ResilienceError):
    """The supervisor exhausted its recovery options (budget, no
    checkpoint to rewind to, or nothing left to shrink onto)."""


# process-lifetime recovery totals, sibling of LAYOUT/MOVE/COMPILE_STATS
RECOVERY_STATS: Dict[str, float] = {
    "detections": 0,             # faults the supervisor caught (any class)
    "retries": 0,                # transient step re-runs
    "restores": 0,               # checkpoint restores (state rewinds)
    "shrinks": 0,                # probe + shrink mesh recoveries
    "grows": 0,                  # elastic re-grows onto healed devices
    "checkpoints": 0,            # committed checkpoints
    "checkpoint_failures": 0,    # saves absorbed (previous good kept)
    "gc_removed": 0,             # stale checkpoint dirs GC'd
    "recovery_seconds_total": 0.0,  # sum of detect -> recovered durations
}

_STATS_KEYS = tuple(RECOVERY_STATS)


def reset_recovery_stats() -> None:
    """Zero the running totals (per-run numbers live on SupervisorResult)."""
    for k in _STATS_KEYS:
        RECOVERY_STATS[k] = 0 if k != "recovery_seconds_total" else 0.0


def _on_observe(event: str, ctx: dict) -> None:
    if not event.startswith("recovery."):
        return
    kind = event.split(".", 1)[1]
    if kind == "detect":
        RECOVERY_STATS["detections"] += 1
    elif kind == "retry":
        RECOVERY_STATS["retries"] += 1
    elif kind == "restore":
        RECOVERY_STATS["restores"] += 1
    elif kind == "shrink":
        RECOVERY_STATS["shrinks"] += 1
    elif kind == "grow":
        RECOVERY_STATS["grows"] += 1
    elif kind == "checkpoint":
        RECOVERY_STATS["checkpoints"] += 1
    elif kind == "checkpoint_failure":
        RECOVERY_STATS["checkpoint_failures"] += 1
    elif kind == "gc":
        RECOVERY_STATS["gc_removed"] += int(ctx.get("removed", 1))
    elif kind == "complete":
        RECOVERY_STATS["recovery_seconds_total"] += float(ctx.get("elapsed", 0.0))


_installed = False
_install_lock = threading.Lock()


def _install() -> None:
    """Register the recovery observer once per process (idempotent)."""
    global _installed
    with _install_lock:
        if _installed:
            return
        _hooks.add_observer(_on_observe)
        _installed = True


_install()


@dataclass(frozen=True)
class CheckpointSchedule:
    """When to checkpoint and how much history to keep.

    ``every_steps`` / ``every_seconds`` are OR'd: a checkpoint is due when
    either interval has elapsed since the last commit (a baseline is
    always written at step 0 before the first step runs, so a restore
    target exists from the start). ``keep_last`` bounds retention: after
    each commit, older checkpoint directories beyond the newest k are
    atomically renamed aside and deleted — keeping k > 1 lets a restore
    fall back to an older checkpoint when the newest is corrupt.
    """

    every_steps: Optional[int] = None
    every_seconds: Optional[float] = None
    keep_last: int = 3

    def __post_init__(self):
        if self.every_steps is None and self.every_seconds is None:
            raise ValueError("schedule needs every_steps and/or every_seconds")
        if self.every_steps is not None and self.every_steps < 1:
            raise ValueError(f"every_steps must be >= 1, got {self.every_steps}")
        if self.every_seconds is not None and self.every_seconds < 0:
            raise ValueError(f"every_seconds must be >= 0, got {self.every_seconds}")
        if self.keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {self.keep_last}")

    def due(self, step: int, last_step: int, now: float, last_time: float) -> bool:
        if self.every_steps is not None and step - last_step >= self.every_steps:
            return True
        if self.every_seconds is not None and now - last_time >= self.every_seconds:
            return True
        return False


@dataclass
class SupervisorResult:
    """What a supervised run produced, plus its per-run recovery counters."""

    state: Optional[dict]
    steps: int
    recoveries: int
    counters: Dict[str, float] = field(default_factory=dict)
    detached: bool = False  # this rank is not a member of the final group
    comm: object = None
    data: tuple = ()  # the live inputs, moved onto the final mesh on shrink


def _classify(exc: BaseException) -> str:
    """Map an exception to a recovery class (see the module policy table)."""
    if isinstance(exc, NoHealthyDevicesError):
        return "fatal"
    if isinstance(exc, ResilienceError):
        # DivergenceError / CollectiveTimeout / corrupt checkpoints: state
        # is suspect — rewind to the last good checkpoint. Checked BEFORE
        # OSError/TimeoutError because CollectiveTimeout subclasses
        # TimeoutError and must not be retried in place.
        return "restore"
    if isinstance(exc, (OSError, TimeoutError)):
        return "retry"
    if isinstance(exc, RuntimeError):
        # a died card surfaces as a CUDA error or NCCL's DistBackendError
        return "probe"
    return "fatal"


class Supervisor:
    """Drives ``step_fn`` as a checkpointed, self-healing step loop.

    Parameters
    ----------
    directory : str, optional
        Checkpoint root. ``None`` disables checkpointing (retry and
        shrink recovery still work; restore-class faults become fatal).
    schedule : CheckpointSchedule, optional
        Cadence/retention; defaults to every step when a directory is set.
    retry : RetryPolicy
        Backoff schedule for transient step errors
        (:data:`DEFAULT_STEP_POLICY`; sleeps come from ``retry.sleep`` so
        tests can run storm scenarios without wall-clock cost).
    checkpoint_retry : RetryPolicy, optional
        Passed through to checkpoint I/O (default
        :data:`DEFAULT_CHECKPOINT_POLICY`).
    max_recoveries : int
        Total recovery budget per ``run``; exhaustion raises
        :class:`SupervisorError`.
    max_restores_per_step : int
        Restores allowed at one step before escalating to probe+shrink.
    divergence_check : bool
        Verify replicated state arrays with
        :func:`~heat_tpu_torch.resilience.guard.check` before each checkpoint
        commit (the detection point for silent replica divergence). Only
        runs at checkpoint boundaries, so the no-checkpoint path stays
        zero-overhead.
    set_default_on_shrink : bool
        Install the shrunken communicator as the process default.
    monitor : HealthMonitor, optional
        A :class:`~heat_tpu_torch.resilience.monitor.HealthMonitor` consulted
        BETWEEN steps (``maybe_tick``, so the cadence decision is
        replicated at ws>1): a tick that degrades devices shrinks the
        mesh proactively — before a dispatch has to fail — and a tick
        that heals them grows it back
        (:func:`~heat_tpu_torch.resilience.degrade.grow_to_healthy`), moving
        the live data and state arrays both ways. Long fits reclaim
        capacity mid-run instead of finishing on the crippled mesh.
    """

    def __init__(
        self,
        directory: Optional[str] = None,
        schedule: Optional[CheckpointSchedule] = None,
        *,
        retry: RetryPolicy = DEFAULT_STEP_POLICY,
        checkpoint_retry: Optional[RetryPolicy] = None,
        max_recoveries: int = 8,
        max_restores_per_step: int = 2,
        divergence_check: bool = True,
        set_default_on_shrink: bool = True,
        monitor=None,
    ):
        if max_recoveries < 0:
            raise ValueError(f"max_recoveries must be >= 0, got {max_recoveries}")
        self.monitor = monitor
        self.directory = directory
        self.schedule = schedule or (
            CheckpointSchedule(every_steps=1) if directory else None
        )
        if directory is None and schedule is not None:
            raise ValueError("a schedule without a directory cannot checkpoint")
        self.retry = retry
        self.checkpoint_retry = checkpoint_retry or DEFAULT_CHECKPOINT_POLICY
        self.max_recoveries = max_recoveries
        self.max_restores_per_step = max_restores_per_step
        self.divergence_check = divergence_check
        self.set_default_on_shrink = set_default_on_shrink

    # ------------------------------------------------------------------ run
    def run(
        self,
        step_fn: Callable,
        state: dict,
        *,
        data: Sequence[DNDarray] = (),
        n_steps: Optional[int] = None,
        label: str = "supervised",
        resume: bool = False,
    ) -> SupervisorResult:
        """Run ``step_fn(state, data, step) -> (state, done)`` to completion.

        Steps until ``done`` is truthy (or ``n_steps`` is reached),
        surviving transient errors, divergence/timeouts, and device loss
        per the classification policy. Returns a :class:`SupervisorResult`
        whose ``state`` is the final state dict.

        ``resume=True`` adopts the newest committed checkpoint already in
        ``directory`` (a restarted job picks up where the dead one left
        off); the default treats the directory as owned by this run —
        stale ``step-*`` checkpoints from a previous run are removed and
        never restored into the new run's state.
        """
        if not isinstance(state, dict):
            raise TypeError(f"state must be a dict of named entries, got {type(state)}")
        data = tuple(data)
        before = dict(RECOVERY_STATS)
        self._comm = self._infer_comm(state, data)
        self._recoveries = 0
        self._retry_counts: Dict[int, int] = {}
        self._retry_first_failure: Dict[int, float] = {}
        self._restore_counts: Dict[int, int] = {}
        self._retry_delays = self.retry.delays()
        self._last_ckpt_step = -1
        self._last_ckpt_time = time.monotonic()
        self._checkpointing_on = self.directory is not None
        self._run_steps: set = set()  # checkpoint steps THIS run may restore
        detached = False

        step = 0
        if self._checkpointing_on:
            existing = self._valid_dirs()
            if resume and existing:
                self._run_steps.update(s for s, _ in existing)
                loaded = self._restore_latest()
                if loaded is not None:
                    state, step = loaded
                    self._last_ckpt_step = step
            else:
                if existing:
                    # a fresh run owns the directory: stale checkpoints
                    # from a previous run must never restore into it
                    self._gc_replicated(keep=0, just_wrote="")
                # baseline: a restore target exists before the first step
                self._maybe_checkpoint(state, 0, force=True)
        while n_steps is None or step < n_steps:
            try:
                _hooks.fault_point("supervisor.step", step=step, label=label)
                state, done = step_fn(state, data, step)
                step += 1
                self._retry_counts.pop(step - 1, None)
                self._retry_first_failure.pop(step - 1, None)
                if self._checkpointing_on:
                    self._maybe_checkpoint(state, step, force=bool(done))
                if self.monitor is not None:
                    state, data = self._monitor_step(state, data, step)
            except Exception as exc:  # noqa: BLE001 - classified, never ignored
                state, data, step, detached = self._recover(
                    exc, state, data, step, label
                )
                if detached:
                    break
                continue
            if done:
                break

        counters = {
            k: RECOVERY_STATS[k] - before[k] for k in _STATS_KEYS
        }
        return SupervisorResult(
            state=None if detached else state,
            steps=step,
            recoveries=self._recoveries,
            counters=counters,
            detached=detached,
            comm=self._comm,
            data=data,
        )

    # ------------------------------------------------------ health monitor
    def _monitor_step(self, state, data, step):
        """Between-steps health hook (``monitor=``): a tick that heals
        ranks grows the group back, moving the data tuple AND the live
        state DNDarrays; there is no checkpoint rewind: the run continues
        at the current step on the grown group. A tick that degrades a
        rank moves nothing: every rank is a process with one card, so a
        proactive shrink would strand a whole process mid-run, and, as
        ``heat_tpu`` does for a process losing every device, that loss is
        left to the reactive rung, whose detach logic owns it. The tick
        cadence and every verdict are replicated (HealthMonitor's
        contract), so all ranks grow together or not at all."""
        report = self.monitor.maybe_tick()
        if report is None or report.degraded or not report.healed:
            return state, data
        arrays = list(data)
        dnd_keys = [k for k, v in state.items() if isinstance(v, DNDarray)]
        arrays += [state[k] for k in dnd_keys]
        old = self._comm.size
        new_comm, moved = grow_to_healthy(
            self._comm, arrays, base=self.monitor.base,
            set_default=self.set_default_on_shrink,
        )
        if new_comm is self._comm:
            return state, data
        _hooks.observe("recovery.grow", step=step, old=old, new=new_comm.size)
        self._comm = new_comm
        for k, v in zip(dnd_keys, moved[len(data):]):
            state[k] = v
        return state, tuple(moved[: len(data)])

    # ------------------------------------------------------------- recovery
    def _recover(self, exc, state, data, step, label):
        t0 = time.monotonic()
        klass = _classify(exc)
        _hooks.observe(
            "recovery.detect", kind=type(exc).__name__, klass=klass, step=step
        )
        if klass == "fatal":
            raise exc
        self._recoveries += 1
        if self._recoveries > self.max_recoveries:
            raise SupervisorError(
                f"{label}: recovery budget exhausted after {self.max_recoveries} "
                f"recoveries (last failure at step {step}: {type(exc).__name__}: {exc})"
            ) from exc

        if klass == "retry":
            handled = self._recover_retry(exc, step)
            if handled:
                self._complete(t0, "retry", step)
                return state, data, step, False
            klass = "restore"  # retry budget exhausted: escalate

        if klass == "restore":
            if self._restore_counts.get(step, 0) >= self.max_restores_per_step:
                klass = "probe"  # same step keeps failing: suspect a device
            else:
                loaded = self._restore_latest()
                if loaded is not None:
                    self._restore_counts[step] = self._restore_counts.get(step, 0) + 1
                    state, step = loaded
                    _hooks.observe("recovery.restore", step=step)
                    self._complete(t0, "restore", step)
                    return state, data, step, False
                raise SupervisorError(
                    f"{label}: {type(exc).__name__} at step {step} needs a checkpoint "
                    "restore but no checkpoint directory is configured (or none was "
                    "ever committed)"
                ) from exc

        # probe + shrink: the device-loss path
        state, data, step, detached = self._recover_shrink(exc, state, data, step)
        self._complete(t0, "shrink", step)
        return state, data, step, detached

    def _complete(self, t0: float, action: str, step: int) -> None:
        _hooks.observe(
            "recovery.complete", elapsed=time.monotonic() - t0, action=action, step=step
        )

    def _recover_retry(self, exc, step: int) -> bool:
        """Transient error: sleep per the policy schedule and re-run the
        step. Returns False when the attempt or wall-clock budget is out."""
        n = self._retry_counts.get(step, 0)
        if n >= len(self._retry_delays):
            return False
        delay = self._retry_delays[n]
        now = time.monotonic()
        first = self._retry_first_failure.setdefault(step, now)
        if self.retry.max_elapsed is not None and (now - first) + delay > self.retry.max_elapsed:
            return False
        self._retry_counts[step] = n + 1
        _hooks.observe("recovery.retry", step=step, attempt=n + 1, delay=delay)
        self.retry.sleep(delay)
        return True

    def _recover_shrink(self, exc, state, data, step):
        probe(self._comm)  # mark this rank when its card fails a round trip
        # every rank must build the same survivor group: union the marks
        # over the current group, whose ranks all recover together
        for dev in replicated_ids(unhealthy_devices() & set(self._comm.ranks), comm=self._comm):
            mark_unhealthy(dev)
        if not unhealthy_devices() & set(self._comm.ranks):
            # probe says the group is fine: the RuntimeError (or repeated
            # restore failure) is not a device problem — surface it
            raise exc
        arrays = list(data)
        dnd_keys = [k for k, v in state.items() if isinstance(v, DNDarray)]
        have_ckpt = any(s in self._run_steps for s, _ in self._valid_dirs())
        if not have_ckpt:
            # no durable state: the live state arrays must move too
            arrays += [state[k] for k in dnd_keys]
        new_comm, moved = shrink_to_healthy(
            self._comm, arrays, set_default=self.set_default_on_shrink
        )
        _hooks.observe(
            "recovery.shrink", step=step, old=self._comm.size, new=new_comm.size
        )
        data = tuple(moved[: len(data)])
        self._comm = new_comm

        # a rank outside the survivors' group DETACHES: it leaves the
        # collectives, and the survivors' checkpoints run over their group
        if not new_comm.is_member:
            return state, data, step, True

        if have_ckpt:
            loaded = self._restore_latest()
            if loaded is not None:
                state, step = loaded
                return state, data, step, False
        # fall back to the live-moved state at the current step
        for k, v in zip(dnd_keys, moved[len(data):]):
            state[k] = v
        return state, data, step, False

    # ---------------------------------------------------------- checkpoints
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step-{step:08d}")

    def _valid_dirs(self) -> List[Tuple[int, str]]:
        """(step, path) of committed checkpoints, newest first."""
        if self.directory is None or not os.path.isdir(self.directory):
            return []
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_DIR_RE.match(name)
            if not m:
                continue
            path = os.path.join(self.directory, name)
            if os.path.exists(os.path.join(path, STATE_NAME)):
                out.append((int(m.group(1)), path))
        out.sort(reverse=True)
        return out

    def _maybe_checkpoint(self, state: dict, step: int, force: bool = False) -> None:
        now = time.monotonic()
        due = self.schedule.due(step, self._last_ckpt_step, now, self._last_ckpt_time)
        # Wall clocks drift across hosts: an every_seconds cadence can be
        # due on one process and not yet on its peers, and _save_state
        # dispatches collectives (sync_global_devices, shard allgathers) —
        # the early-returning ranks would strand the rest at the barrier
        # identical everywhere; a pure step cadence is already lockstep
        # and pays nothing.
        due = replicated_decision(due, self._comm, active=self.schedule.every_seconds is not None)
        if not force and not due:
            return
        if step == self._last_ckpt_step:
            return  # a forced final checkpoint may coincide with a due one
        # detection point: never persist silently-diverged replicated state
        if self.divergence_check:
            for name, val in sorted(state.items()):
                if isinstance(val, DNDarray):
                    check_divergence(val, label=f"supervisor.{name}")
        target = self._step_dir(step)
        try:
            self._save_state(state, step, target)
        except OSError:
            # an absorbed save: the previous good checkpoint still stands
            _hooks.observe("recovery.checkpoint_failure", step=step)
            shutil.rmtree(target, ignore_errors=True)
            return
        self._last_ckpt_step = step
        self._last_ckpt_time = now
        self._run_steps.add(step)
        _hooks.observe("recovery.checkpoint", step=step)
        self._gc_replicated(keep=self.schedule.keep_last, just_wrote=target)

    def _save_state(self, state: dict, step: int, target: str) -> None:
        os.makedirs(target, exist_ok=True)
        arrays: Dict[str, str] = {}
        scalars: Dict[str, object] = {}
        for name, val in sorted(state.items()):
            if isinstance(val, DNDarray):
                save_checkpoint(
                    val, os.path.join(target, "arrays", name), retry=self.checkpoint_retry
                )
                arrays[name] = "dndarray"
            elif isinstance(val, np.ndarray):
                wrapped = DNDarray(val, split=None, comm=self._comm)
                save_checkpoint(
                    wrapped, os.path.join(target, "arrays", name), retry=self.checkpoint_retry
                )
                arrays[name] = "ndarray"
            else:
                scalars[name] = val  # must be JSON-serializable
        payload = json.dumps(
            {
                "format": SUPERVISOR_FORMAT,
                "step": step,
                "arrays": arrays,
                "scalars": scalars,
            },
            indent=1,
        ).encode()
        # state.json is the commit point, written LAST: a crash mid-save
        # leaves a directory without it, which discovery ignores
        if self._comm.rank == 0:
            self.checkpoint_retry.call(
                atomic_write_bytes,
                os.path.join(target, STATE_NAME),
                payload,
                label=f"supervisor state step {step}",
            )
        if self._comm.size > 1:
            self._comm.barrier()

    def _restore_latest(self) -> Optional[Tuple[dict, int]]:
        """Load the newest committed checkpoint, falling back to older ones
        when a load fails verification; None when nothing is loadable."""
        multi = self._comm.size > 1
        for ckpt_step, path in self._valid_dirs():
            if ckpt_step not in self._run_steps:
                continue  # a stale dir from another run is not ours to restore
            # the STATE_NAME read is rank-LOCAL: if it failed on one rank
            # only and that rank silently fell back to an OLDER candidate
            # while its peers proceeded into the load_checkpoint
            # collectives below, the ranks would issue mismatched
            # collective sequences and hang. One replicated verdict per
            # candidate keeps every rank on the same directory.
            meta, err = None, None
            try:
                _hooks.fault_point(
                    "supervisor.restore_manifest", step=ckpt_step, path=path
                )
                with open(os.path.join(path, STATE_NAME), "rb") as f:
                    meta = json.loads(f.read().decode())
            except (OSError, ValueError) as exc:
                err = exc
            if replicated_decision(err is not None, self._comm, active=multi):
                continue  # unreadable somewhere: all ranks skip together
            try:
                state: dict = dict(meta.get("scalars", {}))
                # ``meta`` is read from this host's view of the checkpoint
                # directory, but the directory is shared storage by the
                # checkpoint layer's contract and STATE_NAME is committed
                # atomically (core._atomic), so every host parses the SAME
                # manifest and issues the same load_checkpoint sequence —
                # sorted() pins the order (G005).
                # graftflow: F003 - the manifest is committed atomically: every rank parses the same
                for name, kind in sorted(meta.get("arrays", {}).items()):
                    arr = load_checkpoint(
                        os.path.join(path, "arrays", name),
                        comm=self._comm,
                        retry=self.checkpoint_retry,
                    )
                    # per-entry gather is symmetric with the load sequence
                    # graftflow: F006 - per-entry gather, symmetric with the load sequence
                    state[name] = arr.numpy() if kind == "ndarray" else arr
                return state, int(meta.get("step", ckpt_step))
            except ResilienceError:
                # load_checkpoint failures re-raise on EVERY rank together
                # (the checkpoint layer's _replicated_raise), so this
                # fallback to an older candidate stays in lockstep too
                continue
        return None

    def _gc_replicated(self, keep: int, just_wrote: str) -> None:
        """Process 0 runs retention; every process observes the same
        removal count and none proceeds until the removal is done, so the
        directory view and RECOVERY_STATS stay rank-uniform (a rank racing
        ahead of the purge could list — or worse, write into — a directory
        mid-trash)."""
        removed = (
            self._gc(keep=keep, just_wrote=just_wrote)
            if self._comm.rank == 0
            else 0
        )
        if self._comm.size > 1:
            t = torch.tensor([removed], dtype=torch.int64, device=self._comm.device())
            removed = int(self._comm.allreduce(t).item())
        if removed:
            _hooks.observe("recovery.gc", removed=removed)

    def _gc(self, keep: int, just_wrote: str) -> int:
        """Retention: drop committed checkpoints beyond the newest ``keep``
        and any uncommitted (state-less) directory that is not the one just
        written. Removal is rename-then-delete so a crashed GC leaves a
        ``.trash-*`` directory that discovery already ignores."""
        valid = self._valid_dirs()
        keep_paths = {p for _, p in valid[:keep]} | {just_wrote}
        doomed = [p for _, p in valid[keep:]]
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            if _STEP_DIR_RE.match(name) and path not in keep_paths and path not in doomed:
                if not os.path.exists(os.path.join(path, STATE_NAME)):
                    doomed.append(path)  # a dead partial save
        removed = 0
        for path in doomed:
            trash = f"{path}.trash-{os.getpid()}"
            try:
                os.replace(path, trash)
                shutil.rmtree(trash, ignore_errors=True)
                removed += 1
            except OSError:
                continue
        return removed

    # -------------------------------------------------------------- helpers
    def _infer_comm(self, state: dict, data: Sequence[DNDarray]):
        for x in list(data) + list(state.values()):
            if isinstance(x, DNDarray):
                return x.comm
        return sanitize_comm(None)


def supervise(
    step_fn: Callable,
    state: dict,
    *,
    data: Sequence[DNDarray] = (),
    n_steps: Optional[int] = None,
    directory: Optional[str] = None,
    schedule: Optional[CheckpointSchedule] = None,
    label: str = "supervised",
    resume: bool = False,
    **kwargs,
) -> SupervisorResult:
    """One-shot convenience: build a :class:`Supervisor` and ``run`` it."""
    sup = Supervisor(directory=directory, schedule=schedule, **kwargs)
    return sup.run(
        step_fn, state, data=data, n_steps=n_steps, label=label, resume=resume
    )
