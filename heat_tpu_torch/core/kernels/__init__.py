"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

Counterpart of ``heat_tpu/core/kernels/``. Each kernel registers on the
:mod:`._dispatch` registry; its wrapper launches the CUDA kernel for tensors
on a card and runs the plain version for tensors on the CPU:

- :func:`moments_local` — one-pass per-column (count, mean, M2)
  (``moments_onepass``, ``csrc/moments.cu``), behind ``mean``/``var``/``std``,
  with :func:`moments_sharded`, the Chan combine across ranks;
- :func:`lloyd_local` — fused distance + argmin + per-cluster statistics
  (``lloyd_fused``, ``csrc/lloyd.cu``; any f and k, by the resident or the
  general route of :func:`lloyd_route`), behind ``KMeans.fit``, with
  :func:`lloyd_sharded`, one step on every rank's chunk and one
  ``allreduce``;
- :func:`nearest_neighbors_local` — fused distance + running top-k
  (``topk_distance``, ``csrc/topk_distance.cu``), behind
  ``spatial.nearest_neighbors`` and ``KNeighborsClassifier.predict``;
- :func:`cholesky_local` — blocked Cholesky by panels
  (``chol_panel_fused``, ``csrc/panel_update.cu``), behind
  ``linalg.cholesky``;
- :func:`threefry_bits` — threefry-2x32 random bits at a chunk's global
  indices, and their conversion to uniform floats (``threefry_bits``,
  ``csrc/threefry.cu``; the port's own kernel, not a TPU kernel's port),
  behind ``random``;
- :func:`lazy_fused` — every fused elementwise segment of the lazy layer
  (``ht.lazy``/``ht.fuse``) in one pass, by interpreting the segment's
  program (``lazy_fused``, ``csrc/lazy_fused.cu``; the port's own kernel,
  standing in for XLA's fusion), with its plain version
  :func:`lazy_fused_plain`;
- :func:`scan_axis` — the inclusive add or mul scan along one axis
  (``scan_axis``, ``csrc/scan.cu``; the port's own kernel, standing in for
  XLA's scan), behind ``cumsum``/``cumprod``, with its two steps
  :func:`scan_begin`/:func:`scan_finish` (the totals step exposed for a
  split axis) and its plain version :func:`scan_axis_plain`.

Sources build with ``nvcc`` at first use (:mod:`._build`).
"""
from ._dispatch import (
    COLLECTIVES,
    KERNEL_STATS,
    KERNELS,
    LAUNCHES,
    RECEIVED,
    count_collective,
    count_launch,
    dispatch_mode,
    forced_mode,
    record_dispatch,
    record_route,
    register_kernel,
    reset_kernel_stats,
)
from .lloyd import (
    LLOYD_KERNEL,
    assign_stats,
    lloyd_general_plan,
    lloyd_local,
    lloyd_resident_plan,
    lloyd_route,
    lloyd_sharded,
    resident_smem,
)
from .lazy_fused import LAZY_KERNEL, SegmentProgram, lazy_fused, lazy_fused_plain
from .moments import MOMENTS_KERNEL, chunk_moments, merge_moments, moments_local, moments_sharded
from .scan import SCAN_KERNEL, scan_axis, scan_axis_plain, scan_begin, scan_finish
from .panel_update import CHOL_KERNEL, MAX_FUSED_N, chol_block_size, chol_grid, chol_panels, cholesky_local
from .threefry import THREEFRY_KERNEL, threefry_bits, threefry_plain
from .topk_distance import MAX_K, TOPK_KERNEL, knn_plan, knn_tiles, nearest_neighbors_local

__all__ = [
    "CHOL_KERNEL",
    "COLLECTIVES",
    "KERNELS",
    "KERNEL_STATS",
    "LAUNCHES",
    "LAZY_KERNEL",
    "LLOYD_KERNEL",
    "MAX_FUSED_N",
    "MAX_K",
    "MOMENTS_KERNEL",
    "RECEIVED",
    "SCAN_KERNEL",
    "SegmentProgram",
    "THREEFRY_KERNEL",
    "TOPK_KERNEL",
    "assign_stats",
    "chol_block_size",
    "chol_grid",
    "chol_panels",
    "cholesky_local",
    "chunk_moments",
    "count_collective",
    "count_launch",
    "dispatch_mode",
    "forced_mode",
    "knn_plan",
    "knn_tiles",
    "lazy_fused",
    "lazy_fused_plain",
    "lloyd_general_plan",
    "lloyd_local",
    "lloyd_resident_plan",
    "lloyd_route",
    "lloyd_sharded",
    "merge_moments",
    "moments_local",
    "moments_sharded",
    "nearest_neighbors_local",
    "record_dispatch",
    "record_route",
    "register_kernel",
    "reset_kernel_stats",
    "resident_smem",
    "scan_axis",
    "scan_axis_plain",
    "scan_begin",
    "scan_finish",
    "threefry_bits",
    "threefry_plain",
]
