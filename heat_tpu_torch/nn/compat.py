"""Torch-named layers (counterpart of ``heat_tpu/nn/compat.py``).

``heat_tpu`` provides these 21 names as flax modules with torch-flavoured
constructors. In this package they are ``torch.nn``'s own classes, in
torch's conventions (NCHW images), so that the guarantees the reference's
shims exist for hold by construction: ``LayerNorm(512)`` normalizes a
width of 512 (not an epsilon of 512), and ``BatchNorm*(momentum=0.1)`` is
torch's momentum (the weight of the new batch statistic).
"""
from torch.nn import (
    AvgPool2d,
    BatchNorm1d,
    BatchNorm2d,
    Conv1d,
    Conv2d,
    CrossEntropyLoss,
    Dropout,
    Embedding,
    Flatten,
    GELU,
    L1Loss,
    LayerNorm,
    Linear,
    LogSoftmax,
    MaxPool2d,
    MSELoss,
    NLLLoss,
    ReLU,
    Sigmoid,
    Softmax,
    Tanh,
)

__all__ = [
    "Linear",
    "Conv1d",
    "Conv2d",
    "ReLU",
    "GELU",
    "Sigmoid",
    "Tanh",
    "Softmax",
    "LogSoftmax",
    "Flatten",
    "Dropout",
    "MaxPool2d",
    "AvgPool2d",
    "BatchNorm1d",
    "BatchNorm2d",
    "LayerNorm",
    "Embedding",
    "MSELoss",
    "L1Loss",
    "CrossEntropyLoss",
    "NLLLoss",
]
