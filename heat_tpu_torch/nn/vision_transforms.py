"""Vision transforms (counterpart of ``heat_tpu/nn/vision_transforms.py``).

Heat passes ``torchvision.transforms`` through; torchvision is not a
dependency of this package, so the three transforms the examples use are
its own, over torch tensors: ``ToTensor`` (uint8 HWC image to float32 CHW
in [0, 1]), ``Normalize`` (per channel) and ``Compose``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Compose", "Normalize", "ToTensor"]


class Compose:
    """Chain transforms (torchvision-compatible)."""

    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class ToTensor:
    """uint8 HWC image -> float32 CHW in [0, 1] (a 2-D image stays 2-D)."""

    def __call__(self, x):
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        arr = t.to(torch.float32) / 255.0
        if arr.ndim == 3:
            arr = arr.permute(2, 0, 1)
        return arr


class Normalize:
    """Channel-wise standardization: (x - mean[c]) / std[c] along the first axis."""

    def __init__(self, mean, std):
        self.mean = torch.as_tensor(np.asarray(mean, dtype=np.float32))
        self.std = torch.as_tensor(np.asarray(std, dtype=np.float32))

    def __call__(self, x):
        shape = (-1,) + (1,) * (x.ndim - 1)
        mean = self.mean.to(x.device).reshape(shape)
        std = self.std.to(x.device).reshape(shape)
        return (x - mean) / std
