"""Neural networks (counterpart of ``heat_tpu/nn/``).

The names of :mod:`.compat` win; every other name forwards to
``torch.nn`` (``ht.nn.Sequential``, ``ht.nn.Module``, ...), as Heat itself
did. :class:`DataParallel` trains a module over the ranks.
"""
import torch.nn as _torch_nn

from . import compat, functional, lr_scheduler, vision_transforms
from .data_parallel import DataParallel, DataParallelMultiGPU

__all__ = ["DataParallel", "DataParallelMultiGPU", "compat", "functional", "lr_scheduler", "vision_transforms"]


def __getattr__(name):
    if name in compat.__all__:
        return getattr(compat, name)
    try:
        return getattr(_torch_nn, name)
    except AttributeError:
        raise AttributeError(f"module {__name__} has no attribute {name}") from None
