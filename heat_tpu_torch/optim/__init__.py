"""Optimizers (counterpart of ``heat_tpu/optim/``).

Every other name forwards to ``torch.optim`` (``ht.optim.SGD``,
``ht.optim.Adam``, ...), as Heat's own module did; :class:`DASO` and
:class:`DataParallelOptimizer` are the distributed wrappers.
"""
import torch.optim as _torch_optim

from . import utils
from ..nn import lr_scheduler
from .dp_optimizer import DASO, DataParallelOptimizer
from .utils import DetectMetricPlateau

__all__ = ["DASO", "DataParallelOptimizer", "DetectMetricPlateau", "lr_scheduler", "utils"]


def __getattr__(name):
    try:
        return getattr(_torch_optim, name)
    except AttributeError:
        raise AttributeError(f"module {__name__} has no attribute {name}") from None
