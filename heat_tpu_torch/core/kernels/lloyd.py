"""Fused Lloyd step: distances, argmin and per-cluster statistics in one read.

Counterpart of ``heat_tpu/core/kernels/lloyd.py``:

- :func:`lloyd_local` — the wrapper. On a CUDA tensor it launches the
  hand-written kernels of ``csrc/lloyd.cu`` for any f >= 1 and k >= 1, as
  ``heat_tpu``'s kernel takes any shape, by the route :func:`lloyd_route`
  names: ``"resident"`` (one kernel with centers, a ``cp.async`` row ring
  and private sums in shared memory, on a one-wave grid; the fast route)
  where that fits one block's shared memory, else ``"general"`` (labels,
  then per-block sums in device memory; simple, not fast). Both end in a
  fixed-order reduction. On a CPU tensor it runs the plain version. It
  never falls back: a CUDA tensor gets the kernel or an error.
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

from ._dispatch import count_launch, record_route, register_kernel

__all__ = [
    "LLOYD_KERNEL",
    "assign_stats",
    "lloyd_general_plan",
    "lloyd_local",
    "lloyd_resident_plan",
    "lloyd_route",
    "resident_smem",
]

LLOYD_KERNEL = register_kernel(
    "lloyd_fused",
    comparator="assign_stats (plain torch: quadratic expansion, argmin, one-hot matmul)",
    roofline="one read of x and one write of int32 labels per Lloyd step — bandwidth bound",
    replaces="heat_tpu/core/kernels/lloyd.py:52 _lloyd_kernel",
)

# the resident route's geometry, as csrc/lloyd.cu is built (LLOYD_TILE, LLOYD_STAGES)
_TILE = 128  # rows per tile, one thread each
_STAGES = 3  # cp.async ring stages
_CHUNK = 8  # centers per register chunk
_MAX_PRIV = 8192  # floats of private sum copies per block
_MAX_SMEM = 232448  # the card's opt-in shared memory per block
# the general route: rows per lloyd_scatter block at least, and the cap on
# its (nblocks, k, f) float32 scratch (256 MiB) unless one block passes it
_GENERAL_ROWS = 256
_GENERAL_CAP = 1 << 26
_lib = None
_sms = {}  # device index -> SM count
_per_sm = {}  # (device index, f, k, 16-byte aligned) -> resident blocks per SM


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


def resident_smem(f: int, k: int) -> int:
    """Bytes of shared memory a block of the resident route needs for these
    f and k: an inertia slot per thread, the ring of ``_STAGES`` tiles of
    ``_TILE`` rows (stride f + 4 when f % 4 == 0, else f | 1), the centers
    transposed and padded to 8, their norms, G private (k, f) sums, the
    tile's labels and each warp's k counts (``geometry()`` in
    csrc/lloyd.cu)."""
    kp = -(-k // _CHUNK) * _CHUNK
    ld = f + 4 if f % 4 == 0 else f | 1
    g = max(1, min(_MAX_PRIV // (k * f), _TILE // f))
    return 8 * _TILE + 4 * (_STAGES * _TILE * ld + f * kp + kp + g * k * f) + 4 * (_TILE + _TILE // 32 * k)


def lloyd_route(f: int, k: int) -> str:
    """``"resident"`` where the resident route takes (f, k) — one thread per
    column in the accumulation (f <= the tile's threads) and
    :func:`resident_smem` within the card's 227 KB — else ``"general"``."""
    if f < 1 or k < 1:
        raise ValueError(f"lloyd_route needs f >= 1 and k >= 1, got f={f}, k={k}")
    return "resident" if f <= _TILE and resident_smem(f, k) <= _MAX_SMEM else "general"


def lloyd_resident_plan(n: int, sms: int, blocks_per_sm: int) -> int:
    """Blocks of the resident route: one wave of the card (``sms`` SMs
    holding ``blocks_per_sm`` each), and no more than the n rows' tiles."""
    if sms < 1 or blocks_per_sm < 1:
        raise RuntimeError(f"lloyd_fused does not fit the card: {blocks_per_sm} blocks per SM on {sms} SMs")
    return max(1, min(sms * blocks_per_sm, -(-n // _TILE)))


def lloyd_general_plan(n: int, k: int, f: int, sms: int) -> int:
    """Blocks of the general route's sums kernel: four per SM, at least
    ``_GENERAL_ROWS`` rows each, and ``nblocks * k * f`` within
    ``_GENERAL_CAP`` floats of scratch — but never fewer than one block."""
    return max(1, min(4 * sms, -(-n // _GENERAL_ROWS), _GENERAL_CAP // (k * f)))


def _library():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("lloyd")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.lloyd_fused.argtypes = [p, p, i64, i32, i32, i64, i32, p, p, p, p, p, p, p, i32, p]
        lib.lloyd_fused.restype = i32
        lib.lloyd_general.argtypes = [p, p, i64, i32, i32, i64, i32, p, p, p, p, p, p, p, p, i32, p]
        lib.lloyd_general.restype = i32
        lib.lloyd_blocks_per_sm.argtypes = [i32, i32, i32, i32]
        lib.lloyd_blocks_per_sm.restype = i32
        lib.lloyd_resident_smem.argtypes = [i32, i32]
        lib.lloyd_resident_smem.restype = i64
        _lib = lib
    return _lib


def _sm_count(index: int) -> int:
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sms[index]


def _blocks_per_sm(index: int, f: int, k: int, aligned: bool) -> int:
    """Resident blocks one SM holds for this shape, queried once per card,
    shape and alignment."""
    key = (index, f, k, aligned)
    if key not in _per_sm:
        per_sm = _library().lloyd_blocks_per_sm(f, k, int(aligned), index)
        if per_sm < 1:
            raise RuntimeError(f"lloyd_fused occupancy query gave {per_sm} (a negative value is a CUDA error)")
        _per_sm[key] = per_sm
    return _per_sm[key]


def _lloyd_cuda(xa: torch.Tensor, centers: torch.Tensor, n_valid: int):
    n, f = xa.shape
    k = centers.shape[0]
    dev = xa.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    route = lloyd_route(f, k)
    lib = _library()
    labels = torch.empty(n, dtype=torch.int32, device=dev)
    sums = torch.empty((k, f), dtype=torch.float32, device=dev)
    counts = torch.empty(k, dtype=torch.float32, device=dev)
    inertia = torch.empty(1, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == "resident":
        nblocks = lloyd_resident_plan(n, _sm_count(index), _blocks_per_sm(index, f, k, xa.data_ptr() % 16 == 0))
    else:
        nblocks = lloyd_general_plan(n, k, f, _sm_count(index))
    part_sums = torch.empty((nblocks, k, f), dtype=torch.float32, device=dev)
    part_counts = torch.empty((nblocks, k), dtype=torch.int32, device=dev)
    part_inertia = torch.empty(nblocks, dtype=torch.float64, device=dev)
    parts = (part_sums.data_ptr(), part_counts.data_ptr(), part_inertia.data_ptr())
    outs = (sums.data_ptr(), counts.data_ptr(), inertia.data_ptr(), index, stream)
    if route == "resident":
        err = lib.lloyd_fused(xa.data_ptr(), centers.data_ptr(), n, f, k, n_valid, nblocks, labels.data_ptr(),
                              *parts, *outs)
    else:
        mind = torch.empty(n, dtype=torch.float32, device=dev)
        err = lib.lloyd_general(xa.data_ptr(), centers.data_ptr(), n, f, k, n_valid, nblocks, labels.data_ptr(),
                                mind.data_ptr(), *parts, *outs)
    if err != 0:
        raise RuntimeError(f"lloyd_fused ({route} route) kernel launch failed with CUDA error {err}")
    count_launch(LLOYD_KERNEL)
    record_route(LLOYD_KERNEL, route)
    return sums, counts, labels, inertia[0]


def lloyd_local(xa: torch.Tensor, centers: torch.Tensor, n_valid: Optional[int] = None):
    """Fused Lloyd assignment statistics of a local (n, f) buffer:
    ``(sums, counts, labels, inertia)`` as :func:`assign_stats` defines them.

    A CUDA tensor runs the hand-written kernels (float32) of the route
    :func:`lloyd_route` names, for any f and k; a CPU tensor runs
    :func:`assign_stats`."""
    if xa.ndim != 2 or centers.ndim != 2 or xa.shape[1] != centers.shape[1]:
        raise ValueError(f"bad operand shapes {tuple(xa.shape)} x {tuple(centers.shape)}")
    if xa.shape[0] < 1 or centers.shape[0] < 1:
        raise ValueError("lloyd_local needs at least one row and one center")
    if xa.device != centers.device:
        raise ValueError(f"x on {xa.device} but centers on {centers.device}")
    n_valid = xa.shape[0] if n_valid is None else int(n_valid)
    if xa.is_cuda:
        return _lloyd_cuda(xa.to(torch.float32).contiguous(), centers.to(torch.float32).contiguous(), n_valid)
    if xa.device.type != "cpu":
        raise ValueError(f"lloyd_local supports CUDA and CPU tensors, got {xa.device}")
    return assign_stats(xa.to(torch.float32), centers.to(torch.float32), n_valid)
