"""Fused Lloyd step: distances, argmin and per-cluster statistics in one read.

Counterpart of ``heat_tpu/core/kernels/lloyd.py``:

- :func:`lloyd_local` — the wrapper. On a CUDA tensor it launches the
  hand-written kernel ``csrc/lloyd.cu`` (per-block partials, then a
  fixed-order reduction — see the source's header); on a CPU tensor it runs
  the plain version. It never falls back: a CUDA tensor gets the kernel or
  an error.
- :func:`assign_stats` — the plain PyTorch version, with the contract of
  ``heat_tpu/cluster/kmeans.py::_assign_stats``.

Both return ``(sums, counts, labels, inertia)``: per-cluster sums (k, f),
counts (k,) and the summed minimum squared distance over rows below
``n_valid``, and int32 labels for every row. Distances use the quadratic
expansion of ``spatial.distance._quadratic_expand`` in the same order, and
ties go to the lower index.

Bound on the card: one read of x and one write of the labels — bytes.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._dispatch import count_launch, register_kernel

__all__ = ["LLOYD_KERNEL", "MAX_F", "MAX_KF", "assign_stats", "lloyd_local"]

LLOYD_KERNEL = register_kernel(
    "lloyd_fused",
    comparator="assign_stats (plain torch: quadratic expansion, argmin, one-hot matmul)",
    roofline="one read of x and one write of int32 labels per Lloyd step — bandwidth bound",
    replaces="heat_tpu/core/kernels/lloyd.py:52 _lloyd_kernel",
)

# the kernel's limits (csrc/lloyd.cu): they keep a block's centers, row tile
# and private sums within the card's 227 KB of shared memory
MAX_F = 128
MAX_KF = 8192
_TILE = 256  # rows per tile in csrc/lloyd.cu
_lib = None


def assign_stats(xa: torch.Tensor, centers: torch.Tensor, n_valid: Optional[int] = None):
    """Assignment statistics, the plain version of the kernel: labels by
    argmin of the quadratic-expansion distances; rows at index
    ``>= n_valid`` get a zero one-hot weight and zeroed values, so they
    touch none of sums, counts and inertia (their labels are dead values)."""
    from ...spatial.distance import _quadratic_expand

    n, k = xa.shape[0], centers.shape[0]
    d2 = _quadratic_expand(xa, centers)
    mval, labels = torch.min(d2, dim=1)  # first minimal index on ties
    valid = torch.arange(n, device=xa.device) < (n if n_valid is None else int(n_valid))
    onehot = torch.nn.functional.one_hot(labels, k).to(xa.dtype) * valid.unsqueeze(1).to(xa.dtype)
    xa_safe = torch.where(valid.unsqueeze(1), xa, torch.zeros((), dtype=xa.dtype, device=xa.device))
    counts = onehot.sum(dim=0)
    sums = onehot.T @ xa_safe
    inertia = torch.where(valid, mval, torch.zeros((), dtype=mval.dtype, device=xa.device)).sum()
    return sums, counts, labels.to(torch.int32), inertia


def _library():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("lloyd")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.lloyd_fused.argtypes = [p, p, i64, i32, i32, i64, i32, p, p, p, p, p, p, p, i32, p]
        lib.lloyd_fused.restype = ctypes.c_int
        _lib = lib
    return _lib


def lloyd_grid(n: int, device: torch.device) -> int:
    """Number of partial blocks: one per 256-row tile, at most four per SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(4 * sms, -(-n // _TILE)))


def _lloyd_cuda(xa: torch.Tensor, centers: torch.Tensor, n_valid: int):
    n, f = xa.shape
    k = centers.shape[0]
    dev = xa.device
    nblocks = lloyd_grid(n, dev)
    labels = torch.empty(n, dtype=torch.int32, device=dev)
    part_sums = torch.empty((nblocks, k, f), dtype=torch.float32, device=dev)
    part_counts = torch.empty((nblocks, k), dtype=torch.int32, device=dev)
    part_inertia = torch.empty(nblocks, dtype=torch.float64, device=dev)
    sums = torch.empty((k, f), dtype=torch.float32, device=dev)
    counts = torch.empty(k, dtype=torch.float32, device=dev)
    inertia = torch.empty(1, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().lloyd_fused(
        xa.data_ptr(), centers.data_ptr(), n, f, k, n_valid, nblocks,
        labels.data_ptr(), part_sums.data_ptr(), part_counts.data_ptr(), part_inertia.data_ptr(),
        sums.data_ptr(), counts.data_ptr(), inertia.data_ptr(), dev.index or 0, stream,
    )
    if err != 0:
        raise RuntimeError(f"lloyd_fused kernel launch failed with CUDA error {err}")
    count_launch(LLOYD_KERNEL)
    return sums, counts, labels, inertia[0]


def lloyd_local(xa: torch.Tensor, centers: torch.Tensor, n_valid: Optional[int] = None):
    """Fused Lloyd assignment statistics of a local (n, f) buffer:
    ``(sums, counts, labels, inertia)`` as :func:`assign_stats` defines them.

    A CUDA tensor runs the hand-written kernel (float32; ``f <= MAX_F`` and
    ``k * f <= MAX_KF``, else ValueError); a CPU tensor runs
    :func:`assign_stats`."""
    if xa.ndim != 2 or centers.ndim != 2 or xa.shape[1] != centers.shape[1]:
        raise ValueError(f"bad operand shapes {tuple(xa.shape)} x {tuple(centers.shape)}")
    if xa.shape[0] < 1 or centers.shape[0] < 1:
        raise ValueError("lloyd_local needs at least one row and one center")
    if xa.device != centers.device:
        raise ValueError(f"x on {xa.device} but centers on {centers.device}")
    n_valid = xa.shape[0] if n_valid is None else int(n_valid)
    if xa.is_cuda:
        n, f = xa.shape
        k = centers.shape[0]
        if f > MAX_F or k * f > MAX_KF:
            raise ValueError(
                f"lloyd_fused takes f <= {MAX_F} and k * f <= {MAX_KF}; got f={f}, k={k}"
            )
        return _lloyd_cuda(
            xa.to(torch.float32).contiguous(), centers.to(torch.float32).contiguous(), n_valid
        )
    if xa.device.type != "cpu":
        raise ValueError(f"lloyd_local supports CUDA and CPU tensors, got {xa.device}")
    return assign_stats(xa.to(torch.float32), centers.to(torch.float32), n_valid)
