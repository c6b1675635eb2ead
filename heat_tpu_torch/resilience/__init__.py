"""heat_tpu_torch.resilience: durable sharded state, runtime guards and
fault injection (counterpart of ``heat_tpu/resilience``).

Storage:

- :mod:`~.checkpoint`: sharded, checksummed, atomic ``save_checkpoint``/
  ``load_checkpoint`` in ``heat_tpu``'s directory format, restored onto any
  world size;
- :mod:`~.retry`: :class:`RetryPolicy` (exponential backoff with seeded
  jitter) and :data:`DEFAULT_CHECKPOINT_POLICY`;
- :mod:`~.validate`: the invariant checks (``validate(x)``,
  ``DNDarray.health_check()``).

Runtime guards:

- :mod:`~.guard`: replica-divergence detection: ``fingerprint(x)``,
  ``check``, ``guarded(...)``, raising :class:`DivergenceError` naming the
  ranks;
- :mod:`~.watchdog`: ``with_deadline(fn, timeout, label)`` and the
  job-wide ``deadlines(timeout)`` bound the blocking movements and
  gathers, raising :class:`CollectiveTimeout` instead of hanging.

:mod:`~.chaos` injects the failures deterministically (I/O errors, torn
writes, silent corruption, timeouts, stragglers, replica divergence), by
probability (:class:`chaos`) or as a scripted :class:`FaultSchedule`, so
all of the above is testable on the CPU. Every guard failure derives from
:class:`ResilienceError` (:mod:`~.errors`).

Supervised execution and elastic capacity:

- :mod:`~.degrade`: ``mark_unhealthy``/``probe``/``shrink_to_healthy``/
  ``grow_to_healthy``: a lost card means a smaller ``torch.distributed``
  group (built by the survivors alone) and the live arrays moved onto it;
- :mod:`~.monitor`: :class:`HealthMonitor` probe ticks on a replicated
  cadence keep a per-card ledger (EWMA stragglers, flap damping); a healed
  card is re-admitted by ``grow_to_healthy``. Counters in
  :data:`HEALTH_STATS`;
- :mod:`~.supervisor`: :class:`Supervisor`/:func:`supervise` drive an
  iterative workload as a checkpointed step loop that retries transient
  faults, restores from checkpoints and shrinks onto the surviving ranks.
  Counters in :data:`RECOVERY_STATS`.
"""
from . import chaos as _chaos_mod  # noqa: F401
from .chaos import FaultSchedule, Injection, chaos
from .checkpoint import (
    CHECKPOINT_FORMAT,
    MANIFEST_NAME,
    CheckpointCorruptionError,
    CheckpointError,
    load_checkpoint,
    read_manifest,
    save_checkpoint,
)
from .errors import (
    CollectiveTimeout,
    DegradeError,
    DivergenceError,
    LockstepError,
    NoHealthyDevicesError,
    PoisonRequestError,
    ResilienceError,
    ServeDeadlineError,
    ServeError,
    ServeOverloadError,
)
from .degrade import (
    clear_unhealthy,
    grow_to_healthy,
    healthy_devices,
    mark_unhealthy,
    probe,
    shrink_to_healthy,
    unhealthy_devices,
)
from .guard import Fingerprint, Guard, fingerprint, guarded
from .guard import check as check_divergence
from .monitor import HEALTH_STATS, DeviceHealth, HealthMonitor, TickReport, reset_health_stats
from .retry import DEFAULT_CHECKPOINT_POLICY, NO_RETRY, RetryError, RetryPolicy
from .supervisor import (
    RECOVERY_STATS,
    CheckpointSchedule,
    Supervisor,
    SupervisorError,
    SupervisorResult,
    reset_recovery_stats,
    supervise,
)
from .validate import ValidationError, validate
from .watchdog import deadlines, with_deadline

__all__ = [
    "chaos",
    "Injection",
    "FaultSchedule",
    "save_checkpoint",
    "load_checkpoint",
    "read_manifest",
    "CheckpointError",
    "CheckpointCorruptionError",
    "CHECKPOINT_FORMAT",
    "MANIFEST_NAME",
    "RetryPolicy",
    "RetryError",
    "NO_RETRY",
    "DEFAULT_CHECKPOINT_POLICY",
    "validate",
    "ValidationError",
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
    "fingerprint",
    "Fingerprint",
    "Guard",
    "guarded",
    "check_divergence",
    "with_deadline",
    "deadlines",
    "mark_unhealthy",
    "clear_unhealthy",
    "unhealthy_devices",
    "healthy_devices",
    "probe",
    "shrink_to_healthy",
    "grow_to_healthy",
    "HealthMonitor",
    "DeviceHealth",
    "TickReport",
    "HEALTH_STATS",
    "reset_health_stats",
    "Supervisor",
    "SupervisorError",
    "SupervisorResult",
    "supervise",
    "CheckpointSchedule",
    "RECOVERY_STATS",
    "reset_recovery_stats",
]
