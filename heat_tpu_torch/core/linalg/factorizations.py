"""Cholesky factorization and triangular solves (counterpart of
``heat_tpu/core/linalg/factorizations.py``), at world size 1.

``cholesky`` runs the ``chol_panel_fused`` kernel for a float32 matrix
with n <= ``MAX_FUSED_N`` on a card, and its plain version on the CPU.
Anything else (float64, or n > ``MAX_FUSED_N``) takes ``heat_tpu``'s
non-kernel route, ``torch.linalg.cholesky_ex``, recorded as
``chol_panel_fused.fallback``. A matrix that is not positive definite
gives NaNs, never an error: on the kernel and plain routes from the
failing pivot on, on the non-kernel route on and below the whole diagonal
(zeros above), as ``jnp.linalg.cholesky`` returns it.
"""
from __future__ import annotations

import torch

from .. import types
from ..dndarray import DNDarray
from ..kernels import CHOL_KERNEL, MAX_FUSED_N, chol_block_size, chol_panels, cholesky_local, dispatch_mode, record_dispatch

__all__ = ["cholesky", "solve_triangular"]


def _square_2d_check(name: str, a) -> None:
    if not isinstance(a, DNDarray):
        raise TypeError(f"{name} expects a DNDarray, got {type(a)}")
    if a.ndim != 2:
        raise ValueError(f"{name} requires a 2-D array, got {a.ndim}-D")
    if a.gshape[0] != a.gshape[1]:
        raise RuntimeError(f"{name} requires a square matrix, got {a.gshape}")


def _float_type(*arrs):
    t = types.float32
    for x in arrs:
        t = types.promote_types(x.dtype, t)
    return t


def _cholesky_library(arr: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.cholesky_ex``; where it reports a failure, NaN on and
    below the diagonal and zeros above."""
    L, info = torch.linalg.cholesky_ex(arr)
    if int(info) != 0:
        lower = torch.ones_like(arr, dtype=torch.bool).tril()
        L = torch.where(lower, torch.full_like(arr, float("nan")), torch.zeros_like(arr))
    return L


def cholesky(a: DNDarray, tiles_per_proc: int = 1) -> DNDarray:
    """Lower Cholesky factor ``L`` of a symmetric positive-definite 2-D
    operand (only its lower triangle is read). The result keeps ``a``'s
    split. ``tiles_per_proc`` is accepted for ``heat_tpu``'s signature; it
    shapes the panels only above world size 1."""
    _square_2d_check("cholesky", a)
    ftype = _float_type(a)
    arr = a._logical().to(ftype.torch_type())
    mode = dispatch_mode(CHOL_KERNEL, arr)
    if not (arr.shape[0] <= MAX_FUSED_N and ftype is types.float32):
        mode = "fallback"
    record_dispatch(CHOL_KERNEL, mode)
    if mode == "fallback":
        L = _cholesky_library(arr)
    elif mode == "cuda":
        L = cholesky_local(arr)
    else:
        L = chol_panels(arr, chol_block_size(arr.shape[0]))
    return DNDarray(L, dtype=ftype, split=a.split, device=a.device, comm=a.comm)


def solve_triangular(a: DNDarray, b: DNDarray, lower: bool = False, unit_diagonal: bool = False) -> DNDarray:
    """Solution of the triangular system ``a @ x = b``; ``b`` is a vector
    or a column stack. Only ``a``'s lower (``lower=True``) or upper
    triangle is read; ``unit_diagonal`` takes its diagonal to be ones. The
    result is replicated, as ``heat_tpu``'s is at world size 1."""
    _square_2d_check("solve_triangular", a)
    if not isinstance(b, DNDarray):
        raise TypeError(f"solve_triangular expects a DNDarray rhs, got {type(b)}")
    if b.ndim not in (1, 2):
        raise ValueError(f"rhs must be 1-D or 2-D, got {b.ndim}-D")
    n = a.gshape[0]
    if b.gshape[0] != n:
        raise ValueError(f"dimension mismatch: a has {n} rows, b has {b.gshape[0]}")
    ftype = _float_type(a, b)
    tt = ftype.torch_type()
    rhs = b._logical().to(tt)
    x = torch.linalg.solve_triangular(
        a._logical().to(tt), rhs.unsqueeze(1) if b.ndim == 1 else rhs, upper=not lower, unitriangular=unit_diagonal
    )
    if b.ndim == 1:
        x = x.squeeze(1)
    return DNDarray(x, dtype=ftype, split=None, device=a.device, comm=a.comm)
