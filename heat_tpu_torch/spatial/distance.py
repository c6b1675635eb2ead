"""Pairwise distances (counterpart of ``heat_tpu/spatial/distance.py``).

``cdist`` in its two forms: the exact form (differences, squared, summed,
square-rooted — chunked over ``y`` so the (n, chunk, f) temporary stays
bounded) and the quadratic expansion ``|x|² + |y|² − 2 x yᵀ``, one matrix
product; ``manhattan``, the L1 distances, chunked as the exact form;
``rbf``, the Gaussian kernel over the expansion; and ``nearest_neighbors``,
the k nearest rows without the distance matrix, over the ``topk_distance``
kernel.

Across ranks a split-0 ``x`` against a replicated ``y`` (or a replicated
``x`` against a split-0 ``y``, whose result is split along 1) is local to
each rank. Two split-0 operands give a split-0 result by one of two
schedules: by default ``y``'s chunks are all-gathered and each rank
computes its row block against the whole ``y`` (``heat_tpu``'s GSPMD
path); with ``use_ring=True`` ``y``'s chunks rotate around the ring of
ranks and each step computes one tile of the row block, so a rank holds
one chunk of ``y`` at a time (``heat_tpu``'s ring path,
``heat_tpu/parallel/ring.py``). Ragged and empty chunks take part in both.
"""
from __future__ import annotations

import warnings
from typing import Callable, Optional

import torch

from ..core import types
from ..core.dndarray import DNDarray

__all__ = ["cdist", "manhattan", "nearest_neighbors", "rbf"]

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


def _chunked_pairwise(x: torch.Tensor, y: torch.Tensor, tile_fn) -> torch.Tensor:
    """A pairwise metric without materializing (n, m, f) at once: tiles of
    ``y``'s rows."""
    n, f = x.shape
    m = y.shape[0]
    if n * m * f <= _EXACT_TEMP_ELEMS:
        return tile_fn(x, y)
    chunk = max(16, min(m, _EXACT_TEMP_ELEMS // max(1, n * f)))
    return torch.cat([tile_fn(x, y[i : i + chunk]) for i in range(0, m, chunk)], dim=1)


def _euclid_tile(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    diff = x.unsqueeze(1) - y.unsqueeze(0)
    return torch.sqrt(torch.sum(diff * diff, dim=-1))


def _euclidian(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return _chunked_pairwise(x, y, _euclid_tile)


def _manhattan_tile(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.abs(x.unsqueeze(1) - y.unsqueeze(0)), dim=-1)


def _manhattan(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return _chunked_pairwise(x, y, _manhattan_tile)


def _sqrt_quadratic_expand(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_quadratic_expand(x, y))


def _gaussian(x: torch.Tensor, y: torch.Tensor, sigma: float) -> torch.Tensor:
    d2 = _quadratic_expand(x, y)
    return torch.exp(-d2 / (2.0 * sigma * sigma))


def _ring(metric: Callable, xa: torch.Tensor, y: DNDarray, tt: torch.dtype) -> torch.Tensor:
    """This rank's row block of ``metric(x, y)`` for a split-0 ``y``: ``y``'s
    chunks, padded to the longest, rotate to the previous rank ``p - 1``
    times; the chunk of rank ``q`` fills the columns of ``q``'s rows."""
    comm = y.comm
    yl = y.larray  # ceil-div chunks: a ragged y is rebalanced before its map is read
    counts = [int(c) for c in y.lshape_map[:, 0]]
    starts = [sum(counts[:q]) for q in range(comm.size)]
    out = torch.empty((xa.shape[0], y.gshape[0]), dtype=tt, device=xa.device)
    buf = torch.zeros((max(counts), y.gshape[1]), dtype=tt, device=xa.device)
    buf[: counts[comm.rank]] = yl
    for step in range(comm.size):
        q = (comm.rank + step) % comm.size  # whose chunk this rank holds
        if counts[q]:
            out[:, starts[q] : starts[q] + counts[q]] = metric(xa, buf[: counts[q]])
        if step < comm.size - 1:
            buf = comm.ring_shift(buf)
    return out


def _dist(x: DNDarray, y: Optional[DNDarray], metric: Callable, use_ring: bool = False) -> DNDarray:
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
    xa = x.larray.to(tt)
    if x.split is not None and y.split is not None and x.comm.is_distributed():
        result = _ring(metric, xa, y, tt) if use_ring else metric(xa, y._logical().to(tt))
    else:
        result = metric(xa, y.larray.to(tt))
    out_split = 0 if x.split is not None else (1 if y.split is not None else None)
    return DNDarray(result, gshape=(x.gshape[0], y.gshape[0]), dtype=promoted, split=out_split, device=x.device,
                    comm=x.comm)


def cdist(X: DNDarray, Y: Optional[DNDarray] = None, quadratic_expansion: bool = False,
          use_ring: bool = False) -> DNDarray:
    """Euclidean distance matrix between the rows of ``X`` and ``Y``
    (``Y`` defaults to ``X``). ``quadratic_expansion=True`` uses the
    matrix-product form; the default is the exact form. ``use_ring=True``
    takes the ring schedule where both operands are split across ranks."""
    metric = _sqrt_quadratic_expand if quadratic_expansion else _euclidian
    return _dist(X, Y, metric, use_ring)


def manhattan(X: DNDarray, Y: Optional[DNDarray] = None, expand: bool = False, use_ring: bool = False) -> DNDarray:
    """Manhattan (L1) distance matrix between the rows of ``X`` and ``Y``.
    ``expand`` is accepted for ``heat_tpu``'s signature and has no effect
    (it warns, as ``heat_tpu`` does); ``use_ring`` as in :func:`cdist`."""
    if expand:
        warnings.warn("manhattan: expand has no effect (one broadcast form either way)", UserWarning, stacklevel=2)
    return _dist(X, Y, _manhattan, use_ring)


def rbf(
    X: DNDarray, Y: Optional[DNDarray] = None, sigma: float = 1.0, quadratic_expansion: bool = False,
    use_ring: bool = False,
) -> DNDarray:
    """Gaussian RBF kernel matrix ``exp(−d² / (2σ²))`` between the rows of
    ``X`` and ``Y`` (``Y`` defaults to ``X``). d² always comes from the
    quadratic expansion, as in ``heat_tpu``; ``quadratic_expansion`` is
    accepted for the same signature; ``use_ring`` as in :func:`cdist`."""
    return _dist(X, Y, lambda a, b: _gaussian(a, b, sigma), use_ring)


def nearest_neighbors(x: DNDarray, y: DNDarray, k: int):
    """k nearest rows of ``y`` for every row of ``x``, without the (n, m)
    distance matrix.

    ``x.split`` must be 0 or None; ``y`` is replicated (a split ``y`` is
    gathered whole first, as ``heat_tpu`` resplits it). Each rank runs the
    kernel on its own query rows; a rank with none launches nothing. Returns ``(d2, idx)``: (n, k) squared distances
    (ascending, float32) and row indices into ``y`` (int32), both with
    ``x``'s split, for any ``1 <= k <= m`` as ``heat_tpu`` takes it. The
    ``topk_distance`` kernel runs for tensors on a card (every such k; its
    per-row lists move from shared memory to a scratch buffer above
    ``MAX_K`` = 64), its plain version for tensors on the CPU; the decision
    is recorded in ``KERNEL_STATS``."""
    from ..core.kernels import TOPK_KERNEL, dispatch_mode, knn_tiles, nearest_neighbors_local, record_dispatch

    if x.ndim != 2 or y.ndim != 2:
        raise NotImplementedError("nearest_neighbors expects 2-D operands")
    if x.split not in (None, 0):
        raise NotImplementedError("nearest_neighbors: x must be split=0 or replicated")
    xa = x.larray.to(torch.float32)
    ya = y._logical().to(torch.float32)
    mode = dispatch_mode(TOPK_KERNEL, xa)
    record_dispatch(TOPK_KERNEL, mode)
    if xa.shape[0] == 0:  # no query rows on this rank: nothing to launch
        if not 0 < k <= ya.shape[0]:
            raise ValueError(f"k={k} must be in [1, {ya.shape[0]}]")
        d = torch.empty((0, k), dtype=torch.float32, device=xa.device)
        idx = torch.empty((0, k), dtype=torch.int32, device=xa.device)
    elif mode == "cuda":
        d, idx = nearest_neighbors_local(xa, ya, k)
    else:
        d, idx = knn_tiles(xa, ya, k)
    meta = dict(gshape=(x.gshape[0], k), split=x.split, device=x.device, comm=x.comm)
    return DNDarray(d, dtype=types.float32, **meta), DNDarray(idx, dtype=types.int32, **meta)
