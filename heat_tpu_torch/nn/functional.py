"""Functional NN operations (counterpart of ``heat_tpu/nn/functional.py``):
every name forwards to ``torch.nn.functional``, as Heat's own module did."""
import torch.nn.functional as _F

__all__ = []


def __getattr__(name):
    try:
        return getattr(_F, name)
    except AttributeError:
        raise AttributeError(f"module {__name__} has no attribute {name}") from None
