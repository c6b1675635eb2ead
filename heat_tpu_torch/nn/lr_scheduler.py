"""Learning-rate schedules (counterpart of ``heat_tpu/nn/lr_scheduler.py``):
every name forwards to ``torch.optim.lr_scheduler`` (``StepLR``,
``ExponentialLR``, ``CosineAnnealingLR``, ``MultiStepLR``, ``LinearLR``, ...),
as Heat's own module did. ``heat_tpu`` maps the same names onto optax
schedules; where the two mean the same thing their per-step rates agree."""
import torch.optim.lr_scheduler as _sched

__all__ = []


def __getattr__(name):
    try:
        return getattr(_sched, name)
    except AttributeError:
        raise AttributeError(f"module {__name__} has no attribute {name}") from None
