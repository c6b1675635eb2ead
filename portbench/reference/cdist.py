"""Plain euclidean distances: the reference of ``cdist``.

``sqrt(sum_f (x_if - y_jf)^2)`` by differences, in blocks of ``x``'s rows,
in the type of the precision asked for: float64, the reference itself, or
bfloat16, the control (the step below a float32 computation that uses no
matrix product).
"""
from __future__ import annotations

import torch

from . import precision as P

_ELEMS = 1 << 26  # elements of a block's (rows, m, f) differences


def distances(x: torch.Tensor, y: torch.Tensor, precision: str) -> torch.Tensor:
    """The (n, m) distances between the rows of ``x`` and of ``y``, both
    cast to ``precision``'s type, every operation in that type."""
    dt = P.dtype_of(precision)
    x, y = x.to(dt), y.to(dt)
    out = torch.empty((x.shape[0], y.shape[0]), dtype=dt, device=x.device)
    rows = max(1, _ELEMS // max(1, y.numel()))
    for lo in range(0, x.shape[0], rows):
        diff = x[lo : lo + rows, None, :] - y[None, :, :]
        out[lo : lo + rows] = torch.sqrt((diff * diff).sum(-1))
    return out
