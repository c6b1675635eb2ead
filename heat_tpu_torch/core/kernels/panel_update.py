"""Blocked Cholesky factorization by panels: the lower factor of a local
(n, n) float32 matrix, n <= ``MAX_FUSED_N``.

Counterpart of ``heat_tpu/core/kernels/panel_update.py``:

- :func:`cholesky_local` — the wrapper. On a CUDA tensor it makes one
  cooperative launch of the persistent kernel of ``csrc/panel_update.cu``
  (panels of 32 columns, one grid barrier each: a few blocks factor and
  solve the next panel in registers while the rest apply the current one
  to the trailing matrix — see the source's header); on a CPU tensor it
  runs the plain version. It never falls back: a CUDA tensor gets the
  kernel or an error, and a refused cooperative launch is an error.
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

__all__ = ["CHOL_KERNEL", "MAX_FUSED_N", "chol_block_size", "chol_grid", "chol_panels", "cholesky_local"]

CHOL_KERNEL = register_kernel(
    "chol_panel_fused",
    comparator="chol_panels (plain torch: unblocked diagonal block, column-wise panel solve, trailing matmul)",
    roofline="n^3/3 flops; one read of A and one write of L — latency of dependent panel steps at n <= 1024",
    replaces="heat_tpu/core/kernels/panel_update.py:95 _chol_kernel",
)

# heat_tpu's limit: the whole matrix had to fit the TPU's VMEM
MAX_FUSED_N = 1024
_PANEL = 32  # the kernel's panel width: one warp
_THREADS = 256  # threads per block of the kernel
_SOLVE_ROWS = 128  # panel rows per solver block
_TILE = 64  # trailing-update tile edge
_lib = None
_occupancy_cache = {}  # device index -> (SM count, blocks per SM)


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


def chol_grid(n: int, sms: int, blocks_per_sm: int) -> int:
    """Blocks of the kernel's cooperative grid for an n x n matrix on a card
    with ``sms`` SMs, of which each holds ``blocks_per_sm`` blocks at once:
    every block must be co-resident, and no more are launched than the
    first phase can use, its 128-row solver blocks beside the 64 x 64 tiles
    of its trailing update (each grid barrier waits for every block)."""
    if sms < 1 or blocks_per_sm < 1:
        raise RuntimeError(f"chol_panel_fused cannot be co-resident: {blocks_per_sm} blocks per SM on {sms} SMs")
    rest = max(n - 2 * _PANEL, 0)  # rows past panel 1
    nt = -(-rest // _TILE)
    work = max(1, nt * (nt + 1) // 2 + -(-rest // _SOLVE_ROWS))
    return min(sms * blocks_per_sm, work)


def _library():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("panel_update")
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.chol_panel_fused.argtypes = [p, p, i32, i32, i32, p]
        lib.chol_panel_fused.restype = ctypes.c_int
        lib.chol_blocks_per_sm.argtypes = [i32]
        lib.chol_blocks_per_sm.restype = ctypes.c_int
        _lib = lib
    return _lib


def _occupancy(index: int):
    """``(SM count, blocks per SM)`` of card ``index``, queried once."""
    got = _occupancy_cache.get(index)
    if got is None:
        per_sm = _library().chol_blocks_per_sm(index)
        if per_sm < 0:
            raise RuntimeError(f"chol_panel_fused occupancy query failed with CUDA error {-per_sm}")
        got = _occupancy_cache[index] = (torch.cuda.get_device_properties(index).multi_processor_count, per_sm)
    return got


def _chol_cuda(a: torch.Tensor) -> torch.Tensor:
    n = a.shape[0]
    dev = a.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    blocks = chol_grid(n, *_occupancy(index))
    L = torch.empty((n, n), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().chol_panel_fused(a.data_ptr(), L.data_ptr(), n, blocks, index, stream)
    if err != 0:
        raise RuntimeError(f"chol_panel_fused kernel launch failed with CUDA error {err}")
    count_launch(CHOL_KERNEL)
    return L


def cholesky_local(a: torch.Tensor, bs: int = 128) -> torch.Tensor:
    """Lower Cholesky factor of a local square buffer with n <=
    ``MAX_FUSED_N``, in float32, as :func:`chol_panels` defines it.

    A CUDA tensor runs the hand-written kernel (panels of 32 columns
    whatever ``bs``; the factor agrees with ``chol_panels(a, bs)`` to
    float32 reassociation); a CPU tensor runs :func:`chol_panels` with
    ``heat_tpu``'s panel width. A non-square input or n > ``MAX_FUSED_N``
    raises ValueError."""
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
        return _chol_cuda(a.contiguous())
    if a.device.type != "cpu":
        raise ValueError(f"cholesky_local supports CUDA and CPU tensors, got {a.device}")
    return chol_panels(a, bs)
