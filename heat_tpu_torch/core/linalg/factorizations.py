"""Cholesky factorization and triangular solves (counterpart of
``heat_tpu/core/linalg/factorizations.py``), on replicated operands; a
split operand across ranks raises ``NotImplementedError`` (the distributed
Cholesky is still to port).

``cholesky`` runs the ``chol_panel_fused`` kernel for a float32 matrix
with n <= ``MAX_FUSED_N`` on a card, and its plain version on the CPU.
Anything else (float64, or n > ``MAX_FUSED_N``) takes ``heat_tpu``'s
non-kernel route, ``torch.linalg.cholesky_ex``, recorded as
``chol_panel_fused.fallback``. A matrix that is not positive definite
gives NaNs, never an error, on every route as ``jnp.linalg.cholesky``
returns it: NaN on and below the whole diagonal, zeros above. (The kernel
and its plain version leave NaN from the failing pivot on; ``cholesky``
widens that to the whole lower triangle on the device, without a host
sync.)
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


def _replicated_only(name: str, *arrs) -> None:
    if any(x.split is not None and x.comm.is_distributed() for x in arrs):
        raise NotImplementedError(
            f"{name} of a split operand across ranks is still to port (ROADMAP.md Queue A item 1: the distributed "
            "cholesky/solve_triangular, chol_panel_fused per block); resplit it to None first"
        )


def _float_type(*arrs):
    t = types.float32
    for x in arrs:
        t = types.promote_types(x.dtype, t)
    return t


def _nan_lower(arr: torch.Tensor) -> torch.Tensor:
    """jnp's factor of a matrix that is not positive definite: NaN on and
    below the diagonal, zeros above."""
    lower = torch.ones_like(arr, dtype=torch.bool).tril()
    return torch.where(lower, torch.full_like(arr, float("nan")), torch.zeros_like(arr))


def _cholesky_library(arr: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.cholesky_ex``; where it reports a failure, jnp's NaN
    pattern."""
    L, info = torch.linalg.cholesky_ex(arr)
    if int(info) != 0:
        L = _nan_lower(arr)
    return L


def cholesky(a: DNDarray, tiles_per_proc: int = 1) -> DNDarray:
    """Lower Cholesky factor ``L`` of a symmetric positive-definite 2-D
    operand (only its lower triangle is read). The result keeps ``a``'s
    split. ``tiles_per_proc`` is accepted for ``heat_tpu``'s signature; it
    shapes the panels only above world size 1."""
    _square_2d_check("cholesky", a)
    _replicated_only("cholesky", a)
    ftype = _float_type(a)
    arr = a._logical().to(ftype.torch_type())
    mode = dispatch_mode(CHOL_KERNEL, arr)
    if not (arr.shape[0] <= MAX_FUSED_N and ftype is types.float32):
        mode = "fallback"
    record_dispatch(CHOL_KERNEL, mode)
    if mode == "fallback":
        L = _cholesky_library(arr)
    else:
        L = cholesky_local(arr) if mode == "cuda" else chol_panels(arr, chol_block_size(arr.shape[0]))
        # a failing pivot leaves NaN on the diagonal from there on: one select
        # on the device gives jnp's pattern
        L = torch.where(torch.isnan(L.diagonal()).any(), _nan_lower(arr), L)
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
    _replicated_only("solve_triangular", a, b)
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
