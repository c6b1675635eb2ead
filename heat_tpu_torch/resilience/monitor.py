"""Proactive health monitoring: probe ticks, a ledger, flap damping
(counterpart of ``heat_tpu/resilience/monitor.py``).

A :class:`HealthMonitor` round-trips a cheap probe on every rank's card on
a cadence and keeps a per-card **health ledger** (a card is a rank; its id
is the global rank), driving both directions of elastic capacity:

- **degrade**: a probe *failure* marks the rank unhealthy at once; a probe
  *straggler* (latency EWMA above ``straggler_factor`` times the median
  EWMA and above ``floor_ms``) must persist ``degrade_after`` ticks first
  (the ``suspect`` state);
- **heal**: an unhealthy rank that probes clean accrues a streak (the
  ``healing`` state) and is re-admitted after ``heal_after`` clean ticks
  (:func:`~heat_tpu_torch.resilience.degrade.grow_to_healthy` then builds
  the group over it); one bad tick resets the streak and counts a flap.

Ledger states: ``healthy`` -> ``suspect`` -> ``unhealthy`` -> ``healing``
-> ``healthy``. The transitions (:meth:`HealthMonitor.apply_gathered`) are
pure host code on replicated inputs, ``heat_tpu``'s rules line for line,
so the same failure and EWMA sequences give the same ledger,
:class:`TickReport` and :data:`HEALTH_STATS` in both packages.

Across ranks every verdict must be the same on every rank: probe failures
are unioned with :func:`~heat_tpu_torch.core.communication.replicated_ids`,
the EWMAs travel in one microsecond-quantized
:func:`~heat_tpu_torch.core.communication.replicated_frame`, and the
cadence itself is a
:func:`~heat_tpu_torch.core.communication.replicated_decision`
(:meth:`HealthMonitor.maybe_tick`), all over the base group, in which a
rank excluded from a shrunken group still takes part (that is how its
card heals). The background thread (:meth:`HealthMonitor.start`) is
wall-clock driven and runs only at world size 1, as in ``heat_tpu``.

A probe is the ``monitor.probe`` fault point (carrying ``device``, so
``chaos(device_flap=...)`` and ``straggler_probe`` target it) and one
scalar through this rank's card (``torch.ones((), device=card) + 1`` read
back), under the guarded call of the same name: no kernel, and no
collective at world size 1. Counters live in :data:`HEALTH_STATS`, fed
through the :mod:`heat_tpu_torch.core._hooks` observer slot.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import _hooks
from ..core import communication as _comm
from ..core.communication import (
    TorchCommunication,
    replicated_decision,
    replicated_frame,
    replicated_ids,
    sanitize_comm,
)
from . import degrade
from .errors import ResilienceError

__all__ = [
    "HEALTH_STATS",
    "DeviceHealth",
    "HealthMonitor",
    "TickReport",
    "reset_health_stats",
]


HEALTH_STATS: Dict[str, float] = {
    "ticks": 0,              # completed probe passes
    "probes": 0,             # per-device round-trips attempted
    "probe_failures": 0,     # round-trips that raised
    "stragglers": 0,         # straggler verdicts (EWMA vs median)
    "degraded": 0,           # devices marked unhealthy by the monitor
    "healed": 0,             # devices re-admitted after a full streak
    "flaps_damped": 0,       # healing streaks broken by a bad tick
    "probe_ms_total": 0.0,   # cumulative tick wall clock (overhead account)
}

_STATS_KEYS = tuple(HEALTH_STATS)


def reset_health_stats() -> None:
    """Zero :data:`HEALTH_STATS` (test/bench isolation)."""
    for k in _STATS_KEYS:
        HEALTH_STATS[k] = 0.0 if k.endswith("_total") else 0


def _observer(event: str, ctx: dict) -> None:
    if not event.startswith("health."):
        return
    if event == "health.tick":
        HEALTH_STATS["ticks"] += 1
        HEALTH_STATS["probes"] += int(ctx.get("probes", 0))
        HEALTH_STATS["probe_failures"] += int(ctx.get("failures", 0))
        HEALTH_STATS["probe_ms_total"] += float(ctx.get("ms", 0.0))
    elif event == "health.straggler":
        HEALTH_STATS["stragglers"] += 1
    elif event == "health.degrade":
        HEALTH_STATS["degraded"] += 1
    elif event == "health.heal":
        HEALTH_STATS["healed"] += 1
    elif event == "health.flap":
        HEALTH_STATS["flaps_damped"] += 1


_hooks.add_observer(_observer)


@dataclass
class DeviceHealth:
    """One ledger entry. ``state`` is one of ``healthy`` / ``suspect`` /
    ``unhealthy`` / ``healing`` (see module docs); counters are derived
    exclusively from replicated verdicts, so they are identical on every
    rank — the flap-damping equality the multihost tests assert."""

    device_id: int
    state: str = "healthy"
    ewma_ms: float = 0.0     # 0.0 = no sample yet
    streak: int = 0          # consecutive clean ticks while unhealthy/healing
    bad_streak: int = 0      # consecutive straggler verdicts while suspect
    flaps: int = 0           # healing streaks broken before heal_after


@dataclass
class TickReport:
    """What one :meth:`HealthMonitor.tick` decided (rank-identical)."""

    degraded: List[int] = field(default_factory=list)
    healed: List[int] = field(default_factory=list)
    flapped: List[int] = field(default_factory=list)
    failed: frozenset = frozenset()      # probe failures this tick (union)
    stragglers: frozenset = frozenset()  # straggler verdicts this tick
    median_ms: float = 0.0
    probe_ms: float = 0.0                # tick wall clock on this rank


class HealthMonitor:
    """Per-card health ledger driven by cheap probe ticks.

    Parameters
    ----------
    base : TorchCommunication, optional
        The communicator whose ranks are monitored: the *capacity* set,
        independent of the (possibly shrunken) default communicator, so
        degraded ranks keep being probed and can heal. Defaults to the
        default communicator at construction time (normally ``WORLD``).
    interval_s : float
        Minimum seconds between ticks for :meth:`maybe_tick` and the
        background thread. ``0`` ticks on every consult.
    heal_after : int
        Clean consecutive ticks a degraded device must accrue before
        re-admission (flap damping).
    degrade_after : int
        Consecutive straggler verdicts before a suspect device is
        degraded. Probe *failures* degrade immediately.
    straggler_factor : float
        A device is a straggler when its latency EWMA exceeds this
        multiple of the mesh-median EWMA...
    floor_ms : float
        ... and this absolute floor — timing noise on a fast mesh never
        degrades anyone.
    ewma_alpha : float
        EWMA smoothing weight for new probe samples.
    clock : callable
        Monotonic time source (injectable for tests).
    """

    def __init__(
        self,
        base: Optional[TorchCommunication] = None,
        *,
        interval_s: float = 1.0,
        heal_after: int = 3,
        degrade_after: int = 2,
        straggler_factor: float = 8.0,
        floor_ms: float = 5.0,
        ewma_alpha: float = 0.5,
        clock=time.monotonic,
    ):
        if heal_after < 1:
            raise ValueError(f"heal_after must be >= 1, got {heal_after}")
        if degrade_after < 1:
            raise ValueError(f"degrade_after must be >= 1, got {degrade_after}")
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1], got {ewma_alpha}")
        if straggler_factor < 1.0:
            raise ValueError(
                f"straggler_factor must be >= 1, got {straggler_factor}"
            )
        self.base = sanitize_comm(base)
        self.interval_s = float(interval_s)
        self.heal_after = int(heal_after)
        self.degrade_after = int(degrade_after)
        self.straggler_factor = float(straggler_factor)
        self.floor_ms = float(floor_ms)
        self.ewma_alpha = float(ewma_alpha)
        self._clock = clock
        self._multi = _comm.WORLD.size > 1
        self._last_tick: float = -1.0
        self._tick_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.ledger: Dict[int, DeviceHealth] = {int(r): DeviceHealth(int(r)) for r in self.base.ranks}

    # ------------------------------------------------------------- cadence
    def local_due(self, now: Optional[float] = None) -> bool:
        """Rank-local cadence check — NO collective. The piggyback half
        of :meth:`maybe_tick`: a caller that already exchanges its own
        replicated frame (the serve dispatch tick) carries this flag in
        it and runs :meth:`probe_local` / :meth:`apply_gathered` when the
        gathered flags agree, instead of paying a separate decision
        allgather per heartbeat."""
        now = self._clock() if now is None else now
        return self._last_tick < 0 or (now - self._last_tick) >= self.interval_s

    def maybe_tick(self) -> Optional[TickReport]:
        """Tick when the cadence is due; the due decision is replicated
        at ws>1 (wall clocks drift), so every rank ticks together or not
        at all. THE entry point for dispatch-boundary piggybacking."""
        if not replicated_decision(self.local_due(), self.base, active=self._multi):
            return None
        return self.tick()

    def start(self) -> "HealthMonitor":
        """Run ticks on a daemon thread every ``interval_s`` seconds.
        Single-controller only: a free-running clock is rank-divergent,
        and a deserted probe collective wedges the mesh — at ws>1 use
        :meth:`maybe_tick` from a replicated dispatch boundary."""
        if self._multi:
            raise RuntimeError(
                "HealthMonitor.start() is single-controller only; at "
                "world size > 1 piggyback maybe_tick() on a replicated "
                "dispatch boundary instead"
            )
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="health-monitor"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop and join the background thread (no-op when not started)."""
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None

    def _run(self) -> None:
        from ..core import devices

        dev = devices.get_device().torch_device
        if dev.type == "cuda":  # a new thread starts on card 0
            torch.cuda.set_device(dev)
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            # the background monitor outlives a bad tick: the failure is
            # reported (health.error); verdicts come from completed ticks only
            # graftlint: G006 - reported as health.error; verdicts come from completed ticks
            except Exception:  # noqa: BLE001
                _hooks.observe("health.error")

    def __enter__(self) -> "HealthMonitor":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.stop()
        return False

    # ---------------------------------------------------------------- tick
    # graftflow: DRIFT - a rank-uniform TickReport from gathered frames, by contract
    def tick(self) -> TickReport:
        """One probe of this rank's card (when it is a base rank), then
        replicated verdicts and ledger transitions (module docs)."""
        with self._tick_lock:
            return self._tick_locked()

    def _tick_locked(self) -> TickReport:
        t0 = time.perf_counter()
        self._last_tick = self._clock()
        local_fail, export, probes = self._probe_local_locked()

        # replicated verdict inputs: failure union + µs-quantized EWMA
        # frame — every rank transitions its ledger from identical data
        failed = replicated_ids(local_fail, active=self._multi, comm=self.base)
        ewmas = self._replicated_ewmas(export)
        return self._apply_locked(failed, ewmas, probes, len(local_fail), t0)

    # --------------------------------------------- piggyback (probe/apply)
    def probe_local(self):
        """The rank-local half of a tick: probe this rank's card (when it
        is a base rank) and fold the sample into the local ledger EWMA — NO
        collective dispatched. Returns ``(fail_ids, ewma_export, probes)``
        where ``ewma_export`` is the ``{device_id: ewma_ms}`` dict this
        rank would contribute to the health frame; a piggybacking caller
        ships both on its own replicated frame and finishes the tick with
        :meth:`apply_gathered`."""
        with self._tick_lock:
            return self._probe_local_locked()

    def _probe_local_locked(self):
        me = _comm.WORLD.rank
        local_fail: List[int] = []
        local_ms: Dict[int, float] = {}
        probes = 0
        for dev in self.base.ranks:
            if dev != me:
                continue  # a rank probes its own card only
            probes += 1
            try:
                local_ms[int(dev)] = _hooks.guarded_call(
                    "monitor.probe", self._probe_one, dev
                )
            except ResilienceError:
                # a deadline/divergence verdict names the collective
                # fabric, not this device (degrade.probe's contract);
                # the guarded per-device round-trip has no collectives,
                # so any such raise came from outside the probe
                raise
            except Exception:  # noqa: BLE001 - any probe failure means unhealthy
                local_fail.append(int(dev))
        for dev_id, ms in local_ms.items():
            entry = self.ledger[dev_id]
            entry.ewma_ms = (
                ms if entry.ewma_ms == 0.0
                else self.ewma_alpha * ms + (1.0 - self.ewma_alpha) * entry.ewma_ms
            )
        export = {d: self.ledger[d].ewma_ms for d in local_ms}
        return local_fail, export, probes

    # graftflow: DRIFT - a rank-uniform TickReport from gathered frames, by contract
    def apply_gathered(self, failed, ewmas, *, probes: int = 0,
                       failures: int = 0) -> TickReport:
        """The replicated half of a tick: adopt the gathered verdict
        inputs (``failed`` — the cross-rank failure union; ``ewmas`` —
        the unioned µs-quantized ``{device_id: ewma_ms}``) and run the
        ledger transitions. Every argument must already be identical on
        every rank — the caller's frame exchange is the rendezvous — so
        the transitions (and :data:`HEALTH_STATS`) stay rank-identical.
        Resets the cadence clock: a piggybacked tick counts."""
        t0 = time.perf_counter()
        with self._tick_lock:
            self._last_tick = self._clock()
            return self._apply_locked(
                frozenset(int(d) for d in failed), dict(ewmas),
                probes, failures, t0,
            )

    def _apply_locked(self, failed, ewmas, probes, failures, t0) -> TickReport:
        for dev_id, ewma in ewmas.items():
            self.ledger[dev_id].ewma_ms = ewma
        ok_ewmas = [e for d, e in ewmas.items() if d not in failed]
        median = float(np.median(ok_ewmas)) if ok_ewmas else 0.0
        cut = max(self.floor_ms, self.straggler_factor * median)
        stragglers = frozenset(
            d for d, e in ewmas.items() if d not in failed and e > cut
        )

        report = TickReport(
            failed=failed, stragglers=stragglers, median_ms=median
        )
        for dev_id in sorted(self.ledger):
            self._transition(self.ledger[dev_id], dev_id in failed,
                             dev_id in stragglers, report)
        report.probe_ms = (time.perf_counter() - t0) * 1e3
        _hooks.observe(
            "health.tick", probes=probes, failures=failures,
            ms=report.probe_ms,
        )
        return report

    def _probe_one(self, dev: int) -> float:
        """Round-trip one scalar through this rank's card; returns the
        latency in ms. Injectable (``monitor.probe``): one small launch
        and one read back, no kernel of this package and no collective."""
        t0 = time.perf_counter()
        degrade._round_trip("monitor.probe", dev)
        return (time.perf_counter() - t0) * 1e3

    def _replicated_ewmas(self, local: Dict[int, float]) -> Dict[int, float]:
        """Union per-device EWMAs across ranks through one fixed-width
        (cap, 2) int64 frame of (device_id, µs) pairs — rank-invariant
        shape, so the collective is lockstep-safe; µs quantization makes
        the adopted values (and every verdict derived from them)
        bit-identical everywhere. Pass-through at world size 1."""
        if not self._multi:
            return dict(local)
        cap = 64
        if len(local) > cap:
            raise ValueError(
                f"health frame: {len(local)} local devices exceed {cap} slots"
            )
        frame = np.full((cap, 2), -1, dtype=np.int64)
        for i, (dev_id, ms) in enumerate(sorted(local.items())):
            frame[i] = (dev_id, int(round(ms * 1000.0)))
        gathered = replicated_frame(
            frame, label="collective.health_frame", comm=self.base
        ).reshape(-1, 2)
        return {int(d): float(us) / 1000.0 for d, us in gathered if d >= 0}

    # --------------------------------------------------------- transitions
    def _transition(self, entry: DeviceHealth, failed: bool,
                    straggler: bool, report: TickReport) -> None:
        # adopt external degrades (the serve/supervisor ladders mark
        # through their own replicated consensus) so healing starts
        if (
            entry.state in ("healthy", "suspect")
            and entry.device_id in degrade.unhealthy_devices()
        ):
            entry.state = "unhealthy"
            entry.streak = entry.bad_streak = 0

        bad = failed or straggler
        if entry.state in ("healthy", "suspect"):
            if failed:
                self._degrade(entry, "probe_failure", report)
            elif straggler:
                _hooks.observe(
                    "health.straggler", device=entry.device_id,
                    ewma_ms=entry.ewma_ms, median_ms=report.median_ms,
                )
                entry.bad_streak += 1
                if entry.bad_streak >= self.degrade_after:
                    self._degrade(entry, "straggler", report)
                else:
                    entry.state = "suspect"
            else:
                entry.state = "healthy"
                entry.bad_streak = 0
        else:  # unhealthy / healing
            if bad:
                if entry.state == "healing":
                    entry.flaps += 1
                    report.flapped.append(entry.device_id)
                    _hooks.observe("health.flap", device=entry.device_id)
                entry.state = "unhealthy"
                entry.streak = 0
            else:
                entry.streak += 1
                entry.state = "healing"
                if entry.streak >= self.heal_after:
                    degrade.clear_unhealthy(entry.device_id)
                    entry.state = "healthy"
                    entry.streak = entry.bad_streak = 0
                    report.healed.append(entry.device_id)
                    _hooks.observe("health.heal", device=entry.device_id)

    def _degrade(self, entry: DeviceHealth, cause: str,
                 report: TickReport) -> None:
        degrade.mark_unhealthy(entry.device_id)
        entry.state = "unhealthy"
        entry.streak = entry.bad_streak = 0
        report.degraded.append(entry.device_id)
        _hooks.observe("health.degrade", device=entry.device_id, cause=cause)
