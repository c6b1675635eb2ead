"""One-pass moments: per-column (count, mean, M2) in one read.

Counterpart of ``heat_tpu/core/kernels/moments.py``:

- :func:`moments_local` — the wrapper. On a CUDA tensor it launches the
  hand-written kernel ``csrc/moments.cu`` (two passes: per-block partial
  moments, then a fixed-order Chan merge — see the source's header); on a
  CPU tensor it runs the plain version. It never falls back: a CUDA tensor
  gets the kernel or an error.
- :func:`chunk_moments` — the plain PyTorch version of the same function
  (shifted one-pass sums, ``heat_tpu``'s raw-jnp twin), and
  :func:`merge_moments`, the Chan combine of two states;
- :func:`moments_sharded` — the Chan combine of every rank's state over a
  communicator (two ``allreduce`` calls), as ``heat_tpu``'s
  ``moments_sharded`` psums them.

Bound on the card: one read of the ``(n_valid, f)`` float32 buffer — bytes.
Numerics: the plain version sums in float32; the kernel sums in float64.
Both agree with a two-pass float64 reference to float32 reassociation.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ._dispatch import count_launch, register_kernel

__all__ = ["MOMENTS_KERNEL", "chunk_moments", "merge_moments", "moments_local", "moments_sharded"]

MOMENTS_KERNEL = register_kernel(
    "moments_onepass",
    comparator="chunk_moments (plain torch shifted one-pass sums)",
    roofline="one read of the (n_valid, f) float32 buffer; O(n f) flops — bandwidth bound",
    replaces="heat_tpu/core/kernels/moments.py:90 _moments_kernel",
)

_THREADS = 256  # threads per block in csrc/moments.cu
_lib = None


def chunk_moments(xa: torch.Tensor, n_valid=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(count, mean, M2) per column of an (n, f) buffer, rows at index
    ``>= n_valid`` masked: the plain version of the kernel.

    The shifted sums ``s1 = Σ(x − x₀)`` and ``s2 = Σ(x − x₀)²`` (``x₀`` the
    first row; the variance is shift-invariant) are taken in the buffer's
    float type, as ``heat_tpu``'s ``chunk_moments`` does."""
    n = xa.shape[0]
    nv = n if n_valid is None else int(n_valid)
    valid = (torch.arange(n, device=xa.device) < nv).unsqueeze(1)
    shift = xa[0:1, :] if n else xa.new_zeros((1, xa.shape[1]))  # no rows: the neutral state (0, 0, 0)
    xs = torch.where(valid, xa - shift, torch.zeros((), dtype=xa.dtype, device=xa.device))
    nb = valid.sum().to(xa.dtype)
    nb1 = torch.clamp(nb, min=1.0)
    s1 = xs.sum(dim=0)
    s2 = (xs * xs).sum(dim=0)
    mean = shift[0] + s1 / nb1
    m2 = torch.clamp(s2 - s1 * s1 / nb1, min=0.0)
    return nb, mean, m2


def merge_moments(na, mean_a, m2_a, nb, mean_b, m2_b):
    """Chan pairwise combine of two (count, mean, M2) states."""
    n = na + nb
    n1 = torch.clamp(torch.as_tensor(n, dtype=mean_a.dtype, device=mean_a.device), min=1.0)
    delta = mean_b - mean_a
    mean = mean_a + delta * (nb / n1)
    m2 = m2_a + m2_b + delta * delta * (na * nb / n1)
    return n, mean, m2


def moments_sharded(cnt, mean: torch.Tensor, m2: torch.Tensor, comm):
    """The global (count, mean, M2) from every rank's local state, by Chan's
    parallel formulas (``heat_tpu/core/kernels/moments.py:206-210``): one
    ``allreduce`` of the counts and count-weighted means gives the global
    mean, a second of ``M2 + count (mean - gmean)^2`` the global M2. A rank
    with count 0 contributes nothing (its mean may be NaN). The combine runs in float64; mean and
    M2 come back in their own type, the count as a float64 tensor."""
    dt = mean.dtype
    c = torch.as_tensor(cnt, dtype=torch.float64, device=mean.device).expand(mean.shape)
    has = c > 0
    mean64 = torch.where(has, mean.to(torch.float64), 0.0)
    m2_64 = torch.where(has, m2.to(torch.float64), 0.0)
    n, s = comm.allreduce(torch.stack([c, c * mean64])).unbind(0)
    gmean = s / n  # NaN where no rank counted anything, as a local mean of nothing
    gm2 = comm.allreduce(m2_64 + c * (mean64 - gmean) ** 2)
    return n, gmean.to(dt), gm2.to(m2.dtype)


def _library():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("moments")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.moments_onepass.argtypes = [p, i64, i32, i64, i32, p, p, p, p, p, p, i32, p]
        lib.moments_onepass.restype = ctypes.c_int
        _lib = lib
    return _lib


def moments_grid(n_eff: int, f: int, device: torch.device) -> int:
    """Number of partial blocks the kernel uses for ``n_eff`` valid rows:
    about 64 rows per thread, at most eight blocks per SM."""
    cw = min(f, _THREADS)
    rows_per_step = _THREADS // cw
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(8 * sms, -(-max(n_eff, 1) // (rows_per_step * 64))))


def _moments_cuda(xa: torch.Tensor, n_valid: int):
    n, f = xa.shape
    n_eff = max(0, min(n_valid, n))
    nblocks = moments_grid(n_eff, f, xa.device)
    dev = xa.device
    part_cnt = torch.empty(nblocks, dtype=torch.int64, device=dev)
    part_mean = torch.empty((nblocks, f), dtype=torch.float64, device=dev)
    part_m2 = torch.empty((nblocks, f), dtype=torch.float64, device=dev)
    cnt = torch.empty(1, dtype=torch.float32, device=dev)
    mean = torch.empty(f, dtype=torch.float32, device=dev)
    m2 = torch.empty(f, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().moments_onepass(
        xa.data_ptr(), n, f, n_valid, nblocks,
        part_cnt.data_ptr(), part_mean.data_ptr(), part_m2.data_ptr(),
        cnt.data_ptr(), mean.data_ptr(), m2.data_ptr(), dev.index or 0, stream,
    )
    if err != 0:
        raise RuntimeError(f"moments_onepass kernel launch failed with CUDA error {err}")
    count_launch(MOMENTS_KERNEL)
    return cnt[0], mean, m2


def moments_local(xa: torch.Tensor, n_valid: Optional[int] = None):
    """(count, mean, M2) per column of a local (n, f) buffer; rows at index
    ``>= n_valid`` (default: all rows) are excluded.

    A CUDA tensor runs the hand-written kernel; a CPU tensor runs
    :func:`chunk_moments`. Returns float32 tensors: count (0-d), mean (f,)
    and M2 (f,). A buffer of no rows (a ragged layout's empty rank) gives
    the merge's neutral state (0, 0, 0) and launches nothing."""
    if xa.ndim != 2:
        raise ValueError(f"moments_local expects a 2-D buffer, got {tuple(xa.shape)}")
    if xa.shape[1] < 1:
        raise ValueError(f"moments_local needs at least one column, got {tuple(xa.shape)}")
    n_valid = xa.shape[0] if n_valid is None else int(n_valid)
    xa = xa.to(torch.float32).contiguous()
    if xa.shape[0] == 0:
        z = xa.new_zeros(xa.shape[1])
        return xa.new_zeros(()), z, z.clone()
    if xa.is_cuda:
        return _moments_cuda(xa, n_valid)
    if xa.device.type != "cpu":
        raise ValueError(f"moments_local supports CUDA and CPU tensors, got {xa.device}")
    return chunk_moments(xa, n_valid)
