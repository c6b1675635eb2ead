"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

Counterpart of ``heat_tpu/core/kernels/``. Each kernel registers on the
:mod:`._dispatch` registry; its wrapper launches the CUDA kernel for tensors
on a card and runs the plain version for tensors on the CPU:

- :func:`moments_local` — one-pass per-column (count, mean, M2)
  (``moments_onepass``, ``csrc/moments.cu``), behind ``mean``/``var``/``std``;
- :func:`lloyd_local` — fused distance + argmin + per-cluster statistics
  (``lloyd_fused``, ``csrc/lloyd.cu``; any f and k, by the resident or the
  general route of :func:`lloyd_route`), behind ``KMeans.fit``;
- :func:`nearest_neighbors_local` — fused distance + running top-k
  (``topk_distance``, ``csrc/topk_distance.cu``), behind
  ``spatial.nearest_neighbors`` and ``KNeighborsClassifier.predict``;
- :func:`cholesky_local` — blocked Cholesky by panels
  (``chol_panel_fused``, ``csrc/panel_update.cu``), behind
  ``linalg.cholesky``.

Sources build with ``nvcc`` at first use (:mod:`._build`).
"""
from ._dispatch import (
    KERNEL_STATS,
    KERNELS,
    LAUNCHES,
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
    resident_smem,
)
from .moments import MOMENTS_KERNEL, chunk_moments, merge_moments, moments_local
from .panel_update import CHOL_KERNEL, MAX_FUSED_N, chol_block_size, chol_grid, chol_panels, cholesky_local
from .topk_distance import MAX_K, TOPK_KERNEL, knn_plan, knn_tiles, nearest_neighbors_local

__all__ = [
    "CHOL_KERNEL",
    "KERNELS",
    "KERNEL_STATS",
    "LAUNCHES",
    "LLOYD_KERNEL",
    "MAX_FUSED_N",
    "MAX_K",
    "MOMENTS_KERNEL",
    "TOPK_KERNEL",
    "assign_stats",
    "chol_block_size",
    "chol_grid",
    "chol_panels",
    "cholesky_local",
    "chunk_moments",
    "count_launch",
    "dispatch_mode",
    "forced_mode",
    "knn_plan",
    "knn_tiles",
    "lloyd_general_plan",
    "lloyd_local",
    "lloyd_resident_plan",
    "lloyd_route",
    "merge_moments",
    "moments_local",
    "nearest_neighbors_local",
    "record_dispatch",
    "record_route",
    "register_kernel",
    "reset_kernel_stats",
    "resident_smem",
]
