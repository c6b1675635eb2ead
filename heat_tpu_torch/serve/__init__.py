"""heat_tpu_torch.serve: a resident multi-tenant service over the ranks'
cards (counterpart of ``heat_tpu/serve``).

One :class:`~heat_tpu_torch.serve.service.ServeService` holds named fitted
estimators on the cards (:class:`~heat_tpu_torch.serve.session.ModelRegistry`),
routes concurrent client requests through a queue, and batches them by
shape bucket (:mod:`~heat_tpu_torch.serve.batching`), so unrelated clients
share one launch per kernel. Above world size 1 the replicated dispatch
tick (:mod:`~heat_tpu_torch.serve.tick`) makes every rank dispatch the same
batches in the same order; a lost card is survived by shrinking onto the
other ranks (:mod:`heat_tpu_torch.resilience.degrade`), and the
:class:`~heat_tpu_torch.serve.autoscale.Autoscaler` grows the group back
when the :class:`~heat_tpu_torch.resilience.HealthMonitor` heals a card.

Counters live in :data:`SERVE_STATS` (also ``heat_tpu_torch.SERVE_STATS``),
fed through the :mod:`heat_tpu_torch.core._hooks` observer slot.
"""
from ..resilience.errors import (
    PoisonRequestError,
    ServeDeadlineError,
    ServeError,
    ServeOverloadError,
)
from ._stats import SERVE_STATS, refresh_latency_stats, reset_serve_stats
from .autoscale import Autoscaler
from .batching import BucketPolicy, PendingBatch
from .service import DEFAULT_DISPATCH_POLICY, Request, ServeService
from .session import ModelRegistry
from .tick import TickPlan, plan_dispatch

__all__ = [
    "SERVE_STATS",
    "refresh_latency_stats",
    "reset_serve_stats",
    "Autoscaler",
    "BucketPolicy",
    "PendingBatch",
    "TickPlan",
    "plan_dispatch",
    "Request",
    "ServeService",
    "ModelRegistry",
    "DEFAULT_DISPATCH_POLICY",
    "ServeError",
    "ServeOverloadError",
    "ServeDeadlineError",
    "PoisonRequestError",
]
