"""Cholesky factorization and triangular solves (counterpart of
``heat_tpu/core/linalg/factorizations.py``).

Replicated operands, and any operand at world size 1, factor locally:
``cholesky`` runs the ``chol_panel_fused`` kernel for a float32 matrix with
n <= ``MAX_FUSED_N`` on a card, and its plain version on the CPU. Anything
else (float64, or n > ``MAX_FUSED_N``) takes ``heat_tpu``'s non-kernel
route, ``torch.linalg.cholesky_ex``, recorded as
``chol_panel_fused.fallback``.

A split operand above world size 1 runs ``heat_tpu``'s blocked programs
over the ranks' ceil-div row chunks, never gathering the operand. The
panel width ``bs`` is :func:`..tiling.factor_block_edge`'s, a divisor of
the chunk length, so a panel never straddles two ranks:

- ``cholesky`` (right-looking): per panel, the owner broadcasts the
  ``bs x bs`` diagonal block; every rank factors it by the local route
  above (the kernel on a card, once per panel on every rank); each rank
  solves its rows below the panel, the ``(n, bs)`` panel below the
  diagonal is all-gathered and each rank updates its own trailing rows;
- ``solve_triangular`` (blocked forward or back substitution, ``bs`` the
  chunk length): per panel, the owner broadcasts the diagonal block and
  its right-hand-side rows, every rank solves them, and each rank removes
  the solved part from its own remaining rows with one product.

A rank with no rows takes part in every collective. Results are split 0,
as ``heat_tpu``'s are above world size 1 (a split-1 ``cholesky`` operand
factors its transpose; a split-1 ``solve_triangular`` operand is
resplit). A matrix that is not positive definite gives NaNs, never an
error, on every route as ``heat_tpu`` returns them: locally
``jnp.linalg.cholesky``'s pattern, NaN on and below the whole diagonal and
zeros above (the kernel and its plain version leave NaN from the failing
pivot on; ``cholesky`` widens that on the device, without a host sync);
across ranks the blocked program's, every lower entry from the first
failing panel's columns on and every lower entry of the rows below it.
"""
from __future__ import annotations

import torch

from .. import types
from ..dndarray import DNDarray
from ..kernels import CHOL_KERNEL, MAX_FUSED_N, chol_block_size, chol_panels, cholesky_local, dispatch_mode, record_dispatch
from ..tiling import factor_block_edge

__all__ = ["cholesky", "solve_triangular"]


def _square_2d_check(name: str, a) -> None:
    if not isinstance(a, DNDarray):
        raise TypeError(f"{name} expects a DNDarray, got {type(a)}")
    if a.ndim != 2:
        raise ValueError(f"{name} requires a 2-D array, got {a.ndim}-D")
    if a.gshape[0] != a.gshape[1]:
        raise RuntimeError(f"{name} requires a square matrix, got {a.gshape}")


def _split_across_ranks(a: DNDarray) -> bool:
    return a.split is not None and a.comm.is_distributed()


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
    pattern (one select on the device)."""
    L, info = torch.linalg.cholesky_ex(arr)
    return torch.where(info != 0, _nan_lower(arr), L)


def _local_cholesky(arr: torch.Tensor, ftype) -> torch.Tensor:
    """The lower factor of a local square ``arr`` by the route its type,
    size and device take, recorded in ``KERNEL_STATS``."""
    mode = dispatch_mode(CHOL_KERNEL, arr)
    if not (arr.shape[0] <= MAX_FUSED_N and ftype is types.float32):
        mode = "fallback"
    record_dispatch(CHOL_KERNEL, mode)
    if mode == "fallback":
        return _cholesky_library(arr)
    L = cholesky_local(arr) if mode == "cuda" else chol_panels(arr, chol_block_size(arr.shape[0]))
    # a failing pivot leaves NaN on the diagonal from there on: one select on the device gives jnp's pattern
    return torch.where(torch.isnan(L.diagonal()).any(), _nan_lower(arr), L)


def _geometry(a: DNDarray, tiles_per_proc: int):
    """``(mi, bs, start, rows)``: the ceil-div chunk length, the panel
    width, and this rank's first global row and row count."""
    n = a.gshape[0]
    mi = -(-n // a.comm.size)
    start, lshape, _ = a.comm.chunk(a.gshape, 0)
    return mi, factor_block_edge(a, tiles_per_proc, mi), start, lshape[0]


def _cholesky_split0(m: DNDarray, tiles_per_proc: int, ftype) -> torch.Tensor:
    """This rank's rows of the lower factor of the split-0 ``m``."""
    comm = m.comm
    n = m.gshape[0]
    mi, bs, s, rows = _geometry(m, tiles_per_proc)
    A = m.larray.to(ftype.torch_type()).clone()
    spans = [(min(q * mi, n), min(q * mi, n) + int(c)) for q, c in enumerate(m.lshape_map[:, 0])]  # ranks' rows
    failed = torch.full((), n, dtype=torch.int64, device=A.device)  # the first failing panel's start
    for off in range(0, n, bs):
        end = min(off + bs, n)
        owner = off // mi
        if comm.rank == owner:
            blk = A[off - s : end - s, off:end].contiguous()
        else:
            blk = torch.empty((end - off, end - off), dtype=A.dtype, device=A.device)
        Lkk = _local_cholesky(comm.bcast(blk, owner), ftype)
        failed = torch.where((failed == n) & torch.isnan(Lkk.diagonal()).any(), off, failed)
        if comm.rank == owner:
            A[off - s : end - s, off:end] = Lkk
        lo = min(max(end - s, 0), rows)  # this rank's first row below the panel
        if lo < rows:  # X Lkkᵀ = P for the rows below
            A[lo:, off:end] = torch.linalg.solve_triangular(Lkk.T, A[lo:, off:end], upper=True, left=False)
        if end == n:
            continue
        below = [max(0, e - max(st, end)) for st, e in spans]
        W = comm.allgather(A[lo:, off:end].contiguous(), 0, below)  # panel rows end..n-1
        if lo < rows:  # the trailing update of this rank's rows, up to its last row's diagonal
            A[lo:, end : s + rows] -= A[lo:, off:end] @ W[: s + rows - end].T
    g = torch.arange(s, s + rows, device=A.device).unsqueeze(1)
    c = torch.arange(n, device=A.device).unsqueeze(0)
    nan_at = (c <= g) & ((c >= failed) | (g >= torch.clamp(failed + bs, max=n)))
    return torch.where(nan_at, torch.full_like(A, float("nan")), torch.tril(A, diagonal=s))


def cholesky(a: DNDarray, tiles_per_proc: int = 1) -> DNDarray:
    """Lower Cholesky factor ``L`` of a symmetric positive-definite 2-D
    operand. Locally only its lower triangle is read and the result keeps
    ``a``'s split; across ranks a split operand factors by panels of
    ``factor_block_edge(a, tiles_per_proc, ...)`` rows, reads its lower
    triangle (split 0; the upper one for split 1, as the factor of the
    transpose) and gives a split-0 result."""
    _square_2d_check("cholesky", a)
    ftype = _float_type(a)
    if _split_across_ranks(a):
        m = a if a.split == 0 else a.T
        L = _cholesky_split0(m, tiles_per_proc, ftype)
        return DNDarray(L, gshape=a.gshape, dtype=ftype, split=0, device=a.device, comm=a.comm)
    L = _local_cholesky(a._logical().to(ftype.torch_type()), ftype)
    return DNDarray(L, dtype=ftype, split=a.split, device=a.device, comm=a.comm)


def _solve_triangular_split0(a: DNDarray, rhs: torch.Tensor, lower: bool, unit: bool) -> torch.Tensor:
    """This rank's rows of the solution of ``a @ x = b`` for the split-0
    ``a``; ``rhs`` holds this rank's rows of ``b`` as columns."""
    comm = a.comm
    n = a.gshape[0]
    mi, bs, s, rows = _geometry(a, 1)
    T = a.larray.to(rhs.dtype)
    X = rhs.clone()
    k = X.shape[1]
    offs = list(range(0, n, bs))
    for off in offs if lower else reversed(offs):
        end = min(off + bs, n)
        owner = off // mi
        if comm.rank == owner:
            slab = torch.cat([T[off - s : end - s, off:end], X[off - s : end - s]], dim=1)
        else:
            slab = torch.empty((end - off, end - off + k), dtype=X.dtype, device=X.device)
        slab = comm.bcast(slab.contiguous(), owner)
        xk = torch.linalg.solve_triangular(slab[:, : end - off], slab[:, end - off :], upper=not lower,
                                           unitriangular=unit)
        if comm.rank == owner:
            X[off - s : end - s] = xk
        # this rank's rows that the panel's unknowns still enter: below it (lower) or above it (upper)
        r0, r1 = (min(max(end - s, 0), rows), rows) if lower else (0, min(max(off - s, 0), rows))
        if r0 < r1:
            X[r0:r1] -= T[r0:r1, off:end] @ xk
    return X


def solve_triangular(a: DNDarray, b: DNDarray, lower: bool = False, unit_diagonal: bool = False) -> DNDarray:
    """Solution of the triangular system ``a @ x = b``; ``b`` is a vector
    or a column stack. Only ``a``'s lower (``lower=True``) or upper
    triangle is read; ``unit_diagonal`` takes its diagonal to be ones.

    A split ``a`` above world size 1 solves by blocked substitution over
    the ranks (``b`` split 0 or not) and gives a split-0 result; otherwise
    the solve is local and the result replicated, as ``heat_tpu``'s."""
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
    if _split_across_ranks(a):
        a0 = a if a.split == 0 else a.resplit(0)
        rhs = b.larray if b.split == 0 else b._logical()[a.comm.chunk(b.gshape, 0)[2]]
        rhs = rhs.to(tt)
        x = _solve_triangular_split0(a0, rhs.unsqueeze(1) if b.ndim == 1 else rhs, lower, unit_diagonal)
        return DNDarray(x.squeeze(1) if b.ndim == 1 else x, gshape=b.gshape, dtype=ftype, split=0, device=a.device,
                        comm=a.comm)
    rhs = b._logical().to(tt)
    x = torch.linalg.solve_triangular(
        a._logical().to(tt), rhs.unsqueeze(1) if b.ndim == 1 else rhs, upper=not lower, unitriangular=unit_diagonal
    )
    if b.ndim == 1:
        x = x.squeeze(1)
    return DNDarray(x, dtype=ftype, split=None, device=a.device, comm=a.comm)
