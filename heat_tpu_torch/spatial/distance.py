"""Pairwise distances (counterpart of ``heat_tpu/spatial/distance.py:30-190``).

``cdist`` in its two forms: the exact form (differences, squared, summed,
square-rooted — chunked over ``y`` so the (n, chunk, f) temporary stays
bounded) and the quadratic expansion ``|x|² + |y|² − 2 x yᵀ``, one matrix
product. At world size 1 both run on the local tensors.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core import types
from ..core.dndarray import DNDarray

__all__ = ["cdist"]

# cap on the (n, chunk, f) broadcast temporary of the exact form, in elements
_EXACT_TEMP_ELEMS = 1 << 26


def _quadratic_expand(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """||x_i - y_j||² via the expansion, evaluated as
    ``(|x|² + |y|²) − 2 x·yᵀ`` and clamped at 0, in the order
    ``heat_tpu`` and the ``lloyd_fused`` kernel use."""
    x_norm = torch.sum(x * x, dim=1, keepdim=True)
    y_norm = torch.sum(y * y, dim=1)
    d2 = x_norm + y_norm.unsqueeze(0) - 2.0 * (x @ y.T)
    return torch.clamp(d2, min=0.0)


def _euclid_tile(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    diff = x.unsqueeze(1) - y.unsqueeze(0)
    return torch.sqrt(torch.sum(diff * diff, dim=-1))


def _euclidian(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Exact pairwise distances without materializing (n, m, f) at once."""
    n, f = x.shape
    m = y.shape[0]
    if n * m * f <= _EXACT_TEMP_ELEMS:
        return _euclid_tile(x, y)
    chunk = max(16, min(m, _EXACT_TEMP_ELEMS // max(1, n * f)))
    return torch.cat([_euclid_tile(x, y[i : i + chunk]) for i in range(0, m, chunk)], dim=1)


def _sqrt_quadratic_expand(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_quadratic_expand(x, y))


def _dist(x: DNDarray, y: Optional[DNDarray], metric: Callable) -> DNDarray:
    if x.ndim != 2:
        raise NotImplementedError(f"Input x must be a 2D DNDarray, got {x.ndim}-D")
    if y is None:
        y = x
    if y.ndim != 2:
        raise NotImplementedError(f"Input y must be a 2D DNDarray, got {y.ndim}-D")
    if x.shape[1] != y.shape[1]:
        raise ValueError(f"feature dimensions differ: {x.shape[1]} != {y.shape[1]}")
    if x.split == 1 or y.split == 1:
        raise NotImplementedError("cdist with split=1 operands: resplit to 0 or None first")
    promoted = types.promote_types(x.dtype, types.float32)
    tt = promoted.torch_type()
    result = metric(x.larray.to(tt), y.larray.to(tt))
    out_split = 0 if x.split is not None else (1 if y.split is not None else None)
    return DNDarray(result, dtype=promoted, split=out_split, device=x.device, comm=x.comm)


def cdist(X: DNDarray, Y: Optional[DNDarray] = None, quadratic_expansion: bool = False) -> DNDarray:
    """Euclidean distance matrix between the rows of ``X`` and ``Y``
    (``Y`` defaults to ``X``). ``quadratic_expansion=True`` uses the
    matrix-product form; the default is the exact form."""
    metric = _sqrt_quadratic_expand if quadratic_expansion else _euclidian
    return _dist(X, Y, metric)
