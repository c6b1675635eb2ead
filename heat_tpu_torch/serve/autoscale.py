"""Queue-driven elastic autoscaling policy for the resident service
(counterpart of ``heat_tpu/serve/autoscale.py``, verdict for verdict).

The policy lives here; the mechanism is
:func:`~heat_tpu_torch.resilience.degrade.shrink_to_healthy` /
:func:`~heat_tpu_torch.resilience.degrade.grow_to_healthy`, applied by the
``ServeService`` dispatcher strictly BETWEEN batches, never mid-batch.

Decision ladder, once per monitor tick (the
:class:`~heat_tpu_torch.resilience.monitor.HealthMonitor` owns the cadence,
replicated above world size 1, so every rank decides together):

1. the tick **degraded** a rank -> ``"shrink"``, at once (safety ignores
   hysteresis and cooldown);
2. the tick **healed** a rank -> ``"grow"`` when the current group is
   smaller than the healthy base set; cooldown applies, and a deferred
   grow fires at a later tick;
3. **queue pressure**: ``queue_depth`` above ``high_depth`` for
   ``hysteresis`` consecutive ticks (reset only at ``low_depth``) ->
   ``"grow"`` when healed capacity is available and cooldown has elapsed.

Above world size 1 the queue depth differs by rank, so the grow verdict
goes through one :func:`~heat_tpu_torch.core.communication.replicated_decision`
per tick over the monitor's base group; shrink needs none, the monitor's
degrade verdicts being replicated already. Scale activity is counted in
``SERVE_STATS`` (``grows``/``shrinks``/``scale_events``).
"""
from __future__ import annotations

import time
from typing import Optional

from ..core import communication as _comm
from ..core.communication import replicated_decision, sanitize_comm
from ..resilience import degrade
from ..resilience.monitor import HealthMonitor

__all__ = ["Autoscaler"]


class Autoscaler:
    """Target queue-depth band + hysteresis + cooldown scaling policy.

    Parameters
    ----------
    monitor : HealthMonitor
        Owns the probe cadence and the health verdicts; its ``base``
        communicator defines full capacity.
    high_depth : int
        Upper edge of the target queue-depth band: depth above this
        arms the pressure streak.
    low_depth : int
        Lower edge: depth at or below this resets the streak.
    hysteresis : int
        Consecutive over-pressure ticks required before a pressure grow
        (damping, so one burst never scales).
    cooldown_s : float
        Minimum seconds between grows (scale-up storms); shrinks are
        safety-driven and never wait.
    clock : callable
        Monotonic time source (injectable for tests).
    """

    def __init__(
        self,
        monitor: HealthMonitor,
        *,
        high_depth: int = 8,
        low_depth: int = 2,
        hysteresis: int = 2,
        cooldown_s: float = 0.0,
        clock=time.monotonic,
    ):
        if high_depth < 1:
            raise ValueError(f"high_depth must be >= 1, got {high_depth}")
        if not 0 <= low_depth <= high_depth:
            raise ValueError(
                f"need 0 <= low_depth <= high_depth, got "
                f"low={low_depth} high={high_depth}"
            )
        if hysteresis < 1:
            raise ValueError(f"hysteresis must be >= 1, got {hysteresis}")
        if cooldown_s < 0:
            raise ValueError(f"cooldown_s must be >= 0, got {cooldown_s}")
        self.monitor = monitor
        self.high_depth = int(high_depth)
        self.low_depth = int(low_depth)
        self.hysteresis = int(hysteresis)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._pressure = 0            # consecutive over-high-watermark ticks
        self._deferred_heal = False   # a heal grow blocked by cooldown
        self._last_grow: float = -1.0

    # ------------------------------------------------------------- policy
    def consult(self, queue_depth: int) -> Optional[str]:
        """One dispatcher consultation (between batches): runs the
        monitor's ``maybe_tick`` and returns ``"shrink"``, ``"grow"`` or
        ``None``. Off tick boundaries this is a single replicated bool
        above world size 1 and pure arithmetic at world size 1."""
        report = self.monitor.maybe_tick()
        if report is None:
            return None
        if report.degraded:
            # replicated fact: every rank shrinks with no extra rendezvous
            return self.resolve(False, report)
        want_grow = self.vote(queue_depth, report)
        # ONE symmetric rendezvous per tick: pressure streaks and
        # cooldown clocks are rank-local, the executed action must not be
        want_grow = replicated_decision(
            want_grow, self.monitor.base, active=_comm.WORLD.size > 1
        )
        return self.resolve(want_grow, report)

    def vote(self, queue_depth: int, report) -> bool:
        """The rank-local half of a tick consultation: fold this tick's
        queue depth into the pressure streak and return this rank's grow
        vote — NO collective. ``consult`` composes this with one
        ``replicated_decision`` and :meth:`resolve`."""
        if report.degraded:
            return False  # resolve() shrinks regardless of votes
        pressure, ready = self.pre_vote(queue_depth)
        return pressure or (bool(report.healed) and ready)

    def pre_vote(self, queue_depth: int) -> tuple:
        """The report-FREE rank-local half, for piggybacking on a frame
        exchanged before this tick's health report exists (the serve
        dispatch tick). Folds ``queue_depth`` into the pressure streak
        and returns ``(pressure_vote, capacity_ready)``:

        - ``pressure_vote`` — this rank wants a grow on its own merits
          (pressure streak armed, or a deferred heal pending), capacity
          and cooldown permitting;
        - ``capacity_ready`` — capacity is below base and cooldown has
          elapsed, so a *heal* reported by the gathered frames should
          grow.

        The gathered verdict ``OR(pressure_vote) or (healed and
        OR(capacity_ready))`` equals ``OR`` over ranks of :meth:`vote`
        because heal/degrade facts are rank-uniform."""
        if queue_depth > self.high_depth:
            self._pressure += 1
        elif queue_depth <= self.low_depth:
            self._pressure = 0
        cooled = (
            self._last_grow < 0
            or (self._clock() - self._last_grow) >= self.cooldown_s
        )
        ready = self._capacity_below_base() and cooled
        pressure = ready and (
            self._deferred_heal or self._pressure >= self.hysteresis
        )
        return (pressure, ready)

    def resolve(self, want_grow: bool, report) -> Optional[str]:
        """The replicated half: apply an already-rendezvoused grow
        verdict (identical on every rank by the caller's contract) plus
        the tick report's degrade/heal facts, and return the action."""
        if report.degraded:
            # safety first: reset pressure so the post-shrink queue
            # build-up must re-arm the band from scratch
            self._pressure = 0
            return "shrink"
        if want_grow:
            self._pressure = 0
            self._deferred_heal = False
            self._last_grow = self._clock()
            return "grow"
        if report.healed and self._capacity_below_base():
            self._deferred_heal = True  # cooldown blocked it; retry later
        return None

    def _capacity_below_base(self) -> bool:
        """Is the current default communicator smaller than the healthy
        subset of the monitored base set (is there anything to grow onto)?
        Derived from replicated state, hence rank-identical."""
        comm = sanitize_comm(None)
        return comm.size < len(degrade.healthy_devices(self.monitor.base))
