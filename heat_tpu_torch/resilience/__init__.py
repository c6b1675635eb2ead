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

Not ported yet (``ROADMAP.md``, Queue A, item 10b): ``degrade``
(``mark_unhealthy``/``probe``/``shrink_to_healthy``/``grow_to_healthy``),
``supervisor`` (``Supervisor``/``supervise``/``CheckpointSchedule``,
``RECOVERY_STATS``) and ``monitor`` (``HealthMonitor``, ``HEALTH_STATS``).
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
from .guard import Fingerprint, Guard, fingerprint, guarded
from .guard import check as check_divergence
from .retry import DEFAULT_CHECKPOINT_POLICY, NO_RETRY, RetryError, RetryPolicy
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
]
