"""Blocked Cholesky factorization by panels: the lower factor of a local
(n, n) float32 matrix, n <= ``MAX_FUSED_N``.

Counterpart of ``heat_tpu/core/kernels/panel_update.py``:

- :func:`cholesky_local` — the wrapper. On a CUDA tensor it launches the
  hand-written kernels of ``csrc/panel_update.cu`` (per panel: diagonal
  block, panel solve, trailing update — see the source's header); on a
  CPU tensor it runs the plain version. It never falls back: a CUDA tensor
  gets the kernel or an error.
- :func:`chol_panels` — the plain PyTorch version of ``_chol_unblocked``,
  ``_panel_solve`` and the trailing update, with tensor operations; it
  never calls ``torch.linalg.cholesky``.

Only the lower triangle of the input is read. The factor's upper
triangle is exactly zero. A pivot that is not positive gives NaN from its
square root, which reaches every later column; neither version raises.

Bound on the card: operations (n³/3 flops), at these sizes a chain of
dependent steps.
"""
from __future__ import annotations

import ctypes

import torch

from ._dispatch import count_launch, register_kernel

__all__ = ["CHOL_KERNEL", "MAX_FUSED_N", "chol_block_size", "chol_panels", "cholesky_local"]

CHOL_KERNEL = register_kernel(
    "chol_panel_fused",
    comparator="chol_panels (plain torch: unblocked diagonal block, column-wise panel solve, trailing matmul)",
    roofline="n^3/3 flops; one read of A and one write of L — latency of dependent panel steps at n <= 1024",
    replaces="heat_tpu/core/kernels/panel_update.py:95 _chol_kernel",
)

# heat_tpu's limit: the whole matrix had to fit the TPU's VMEM
MAX_FUSED_N = 1024
_lib = None


def chol_block_size(n: int, bs: int = 128) -> int:
    """``heat_tpu``'s panel width for an n x n matrix: ``bs``, cut to n
    rounded up to a multiple of 8, and at least 8."""
    return max(8, min(bs, -(-n // 8) * 8))


def chol_panels(a: torch.Tensor, bs: int = 128) -> torch.Tensor:
    """The plain version: lower Cholesky factor of a square matrix, right-
    looking by panels of ``bs`` columns, in ``a``'s float type.

    Per panel: the diagonal block is factored column by column (square
    root, divide the column below, rank-1 update of the rest); the rows
    below solve ``X Lkkᵀ = P`` column by column; ``X Xᵀ`` is subtracted
    from the trailing matrix. A ragged last panel is sliced, not padded."""
    n = a.shape[0]
    L = torch.tril(a).clone()
    for off in range(0, n, bs):
        end = min(off + bs, n)
        blk = L[off:end, off:end]
        for j in range(end - off):
            d = torch.sqrt(blk[j, j])
            col = blk[j + 1 :, j] / d
            blk[j + 1 :, j] = col
            blk[j, j] = d
            blk[j + 1 :, j + 1 :] -= torch.outer(col, col)  # the upper part is never read
        if end == n:
            break
        p = L[end:, off:end]
        x = torch.zeros_like(p)
        for j in range(end - off):
            x[:, j] = (p[:, j] - x[:, :j] @ blk[j, :j]) / blk[j, j]
        L[end:, off:end] = x
        L[end:, end:] -= x @ x.T
    return torch.tril(L)


def _library():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("panel_update")
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.chol_panel_fused.argtypes = [p, p, i32, i32, i32, p]
        lib.chol_panel_fused.restype = ctypes.c_int
        _lib = lib
    return _lib


def _chol_cuda(a: torch.Tensor, bs: int) -> torch.Tensor:
    n = a.shape[0]
    dev = a.device
    L = torch.empty((n, n), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().chol_panel_fused(a.data_ptr(), L.data_ptr(), n, bs, dev.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"chol_panel_fused kernel launch failed with CUDA error {err}")
    count_launch(CHOL_KERNEL)
    return L


def cholesky_local(a: torch.Tensor, bs: int = 128) -> torch.Tensor:
    """Lower Cholesky factor of a local square buffer with n <=
    ``MAX_FUSED_N``, in float32, as :func:`chol_panels` defines it.

    A CUDA tensor runs the hand-written kernels; a CPU tensor runs
    :func:`chol_panels`. A non-square input or n > ``MAX_FUSED_N`` raises
    ValueError."""
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"cholesky_local expects a square 2-D buffer, got {tuple(a.shape)}")
    n = a.shape[0]
    if n > MAX_FUSED_N:
        raise ValueError(f"n={n} exceeds MAX_FUSED_N={MAX_FUSED_N}")
    if n < 1:
        raise ValueError("cholesky_local needs a non-empty matrix")
    bs = chol_block_size(n, bs)
    a = a.to(torch.float32)
    if a.is_cuda:
        return _chol_cuda(a.contiguous(), bs)
    if a.device.type != "cpu":
        raise ValueError(f"cholesky_local supports CUDA and CPU tensors, got {a.device}")
    return chol_panels(a, bs)
