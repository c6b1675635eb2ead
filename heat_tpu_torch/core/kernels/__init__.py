"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

Counterpart of ``heat_tpu/core/kernels/``. Each kernel registers on the
:mod:`._dispatch` registry; its wrapper launches the CUDA kernel for tensors
on a card and runs the plain version for tensors on the CPU:

- :func:`moments_local` — one-pass per-column (count, mean, M2)
  (``moments_onepass``, ``csrc/moments.cu``), behind ``mean``/``var``/``std``;
- :func:`lloyd_local` — fused distance + argmin + per-cluster statistics
  (``lloyd_fused``, ``csrc/lloyd.cu``), behind ``KMeans.fit``.

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
    register_kernel,
    reset_kernel_stats,
)
from .lloyd import LLOYD_KERNEL, MAX_F, MAX_KF, assign_stats, lloyd_local
from .moments import MOMENTS_KERNEL, chunk_moments, merge_moments, moments_local

__all__ = [
    "KERNELS",
    "KERNEL_STATS",
    "LAUNCHES",
    "LLOYD_KERNEL",
    "MAX_F",
    "MAX_KF",
    "MOMENTS_KERNEL",
    "assign_stats",
    "chunk_moments",
    "count_launch",
    "dispatch_mode",
    "forced_mode",
    "lloyd_local",
    "merge_moments",
    "moments_local",
    "record_dispatch",
    "register_kernel",
    "reset_kernel_stats",
]
