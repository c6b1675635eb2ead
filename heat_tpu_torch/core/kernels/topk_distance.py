"""Fused pairwise distance + running top-k: the k nearest rows of ``y`` for
every row of ``x``, without the (n, m) distance matrix.

Counterpart of ``heat_tpu/core/kernels/topk_distance.py``:

- :func:`nearest_neighbors_local` — the wrapper. On a CUDA tensor it
  launches the hand-written kernel ``csrc/topk_distance.cu`` (segments of
  ``y`` per block, a register-tiled float32 product behind a threshold
  filter, then a lexicographic merge — see the source's header), for any
  ``1 <= k <= m``; on a CPU tensor it runs the plain
  version. It never falls back: a CUDA tensor gets the kernel or an error.
- :func:`knn_tiles` — the plain PyTorch version: it streams over ``y`` in
  tiles of ``tile_m`` rows and keeps a running (n, k) carry.

Both return ``(d2, idx)``: (n, k) squared distances, ascending, as float32,
and the rows of ``y`` they belong to, as int32. d² is
``max((|x|² + |y|²) − 2 x·yᵀ, 0)``, in ``heat_tpu``'s order, and ties go to
the lower index.

Bound on the card: operations (2 n m f flops; the bytes are one read of
``x`` and ``y``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._dispatch import count_launch, register_kernel

__all__ = ["MAX_K", "TOPK_KERNEL", "default_tile_m", "knn_plan", "knn_tiles", "nearest_neighbors_local"]

TOPK_KERNEL = register_kernel(
    "topk_distance",
    comparator="knn_tiles (plain torch: y-tiles, x @ y.T, stable sort of carry + tile)",
    roofline="2 n m f flops on the CUDA cores; one read of x and y, O(n k) output — operation bound",
    replaces="heat_tpu/core/kernels/topk_distance.py:65 _knn_kernel",
)

# the largest k whose per-row lists the kernel keeps in shared memory
# (csrc/topk_distance.cu); above it they live in the (nseg, n, k) scratch
MAX_K = 64
_ROWS = 128  # query rows per block in csrc/topk_distance.cu
_YT = 64  # y rows per staged tile
_MAX_SEG = 64
_MAX_PARTIAL = 1 << 28  # (nseg, n, k) scratch entries, 8 bytes each: 2 GiB
_INT32_MAX = 2**31 - 1
_lib = None
_sms = {}  # device index -> SM count
_per_sm = {}  # (device index, f % 4 == 0, k > MAX_K) -> blocks of the kernel per SM


def _check(x: torch.Tensor, y: torch.Tensor, k: int) -> None:
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"bad operand shapes {tuple(x.shape)} x {tuple(y.shape)}")
    m = y.shape[0]
    if not 0 < k <= m:
        raise ValueError(f"k={k} must be in [1, {m}]")
    if x.device != y.device:
        raise ValueError(f"x on {x.device} but y on {y.device}")


def default_tile_m(m: int, f: int, tile_n: int = 256) -> int:
    """``heat_tpu``'s y-tile width for these shapes: a multiple of 128, at
    most 8192 (``topk_distance.py:169-176``)."""
    tile_m = min(8192, (1 << 21) // tile_n, (1 << 20) // max(f, 1))
    return max(128, min(tile_m, max(128, m)) // 128 * 128)


def knn_tiles(x: torch.Tensor, y: torch.Tensor, k: int, tile_m: Optional[int] = None):
    """The plain version: ``(d2, idx)`` of the k nearest rows of ``y``.

    Streams over ``y`` in tiles of ``tile_m`` rows, merging the running
    carry with each tile by a stable sort on distance. The carry holds only
    lower indices than the tile and is itself in (d, idx) order, so the
    stable sort gives the lexicographic order of ``heat_tpu``'s
    ``_merge_topk``."""
    _check(x, y, k)
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    m = y.shape[0]
    if tile_m is None:
        tile_m = default_tile_m(m, x.shape[1])
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    carry_d = torch.empty((x.shape[0], 0), dtype=torch.float32, device=x.device)
    carry_i = torch.empty((x.shape[0], 0), dtype=torch.int64, device=x.device)
    for j0 in range(0, m, tile_m):
        yt = y[j0 : j0 + tile_m]
        y2 = torch.sum(yt * yt, dim=1)
        tile = torch.clamp(x2 + y2.unsqueeze(0) - 2.0 * (x @ yt.T), min=0.0)
        cols = torch.arange(j0, j0 + yt.shape[0], device=x.device).expand(x.shape[0], -1)
        cat_d = torch.cat([carry_d, tile], dim=1)
        cat_i = torch.cat([carry_i, cols], dim=1)
        order = torch.sort(cat_d, dim=1, stable=True).indices[:, :k]
        carry_d = torch.gather(cat_d, 1, order)
        carry_i = torch.gather(cat_i, 1, order)
    return carry_d, carry_i.to(torch.int32)


def _library():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("topk_distance")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.topk_distance.argtypes = [p, p, i32, i64, i32, i32, i32, i64, p, p, p, p, p, i32, p]
        lib.topk_distance.restype = ctypes.c_int
        lib.topk_blocks_per_sm.argtypes = [i32, i32, i32]
        lib.topk_blocks_per_sm.restype = ctypes.c_int
        _lib = lib
    return _lib


def knn_plan(n: int, m: int, k: int, sms: int, blocks_per_sm: int):
    """``(nseg, seg_len)``: how the kernel cuts ``y`` for n queries on a card
    with ``sms`` SMs holding ``blocks_per_sm`` blocks each. The (query
    block, segment) grid fills one wave of the card, and no more segments
    than 64, than 64-row tiles, or than keep the (nseg, n, k) scratch
    within 2^28 entries; ``seg_len`` is a multiple of the 64-row tile and
    no segment is empty."""
    nqt = -(-n // _ROWS)
    nseg = max(1, min(_MAX_SEG, sms * max(blocks_per_sm, 1) // nqt, -(-m // _YT), _MAX_PARTIAL // (n * k)))
    per_seg = -(-m // nseg)
    seg_len = -(-per_seg // _YT) * _YT
    return -(-m // seg_len), seg_len


def _occupancy(index: int, f: int, k: int):
    """``(SM count, blocks per SM)`` for this kernel variant, queried once
    per card and variant."""
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    key = (index, f % 4 == 0, k > MAX_K)
    if key not in _per_sm:
        per_sm = _library().topk_blocks_per_sm(f, k, index)
        if per_sm < 1:
            raise RuntimeError(f"topk_distance occupancy query gave {per_sm} (a negative value is a CUDA error)")
        _per_sm[key] = per_sm
    return _sms[index], _per_sm[key]


def _topk_cuda(x: torch.Tensor, y: torch.Tensor, k: int):
    n, f = x.shape
    m = y.shape[0]
    dev = x.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    nseg, seg_len = knn_plan(n, m, k, *_occupancy(index, f, k))
    norms = torch.empty(n + m, dtype=torch.float32, device=dev)
    part_d = torch.empty((nseg, n, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((nseg, n, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((n, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().topk_distance(
        x.data_ptr(), y.data_ptr(), n, m, f, k, nseg, seg_len, norms.data_ptr(), part_d.data_ptr(),
        part_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), index, stream,
    )
    if err != 0:
        raise RuntimeError(f"topk_distance kernel launch failed with CUDA error {err}")
    count_launch(TOPK_KERNEL)
    return out_d, out_i


def nearest_neighbors_local(x: torch.Tensor, y: torch.Tensor, k: int):
    """``(d2, idx)`` of the k nearest rows of ``y`` for every row of a
    local (n, f) buffer ``x``, as :func:`knn_tiles` defines them.

    A CUDA tensor runs the hand-written kernel (float32; fewer than 2^31
    rows, else ValueError); a CPU tensor runs :func:`knn_tiles`. ``k``
    outside ``[1, m]`` raises ValueError."""
    _check(x, y, k)
    if x.shape[0] < 1:
        raise ValueError("nearest_neighbors_local needs at least one query row")
    if x.is_cuda:
        if x.shape[0] > _INT32_MAX or y.shape[0] > _INT32_MAX:
            raise ValueError("topk_distance takes fewer than 2^31 rows (int32 indices)")
        return _topk_cuda(x.to(torch.float32).contiguous(), y.to(torch.float32).contiguous(), k)
    if x.device.type != "cpu":
        raise ValueError(f"nearest_neighbors_local supports CUDA and CPU tensors, got {x.device}")
    return knn_tiles(x, y, k)
