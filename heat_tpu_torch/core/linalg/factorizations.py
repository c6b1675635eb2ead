"""Cholesky factorization, triangular solves and LU with partial pivoting
(``solve`` and the backends of ``det`` and ``inv``; counterpart of
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

- the LU behind ``solve``, ``det`` and ``inv`` (right-looking, panels of
  the chunk length): see :func:`_lu_split0`. These three run their
  products in full float32, as ``heat_tpu`` runs them at
  ``default_matmul_precision("highest")``, whatever the caller's
  ``torch.set_float32_matmul_precision``.

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

import numpy as np
import torch

from .. import types
from ..dndarray import DNDarray
from ..kernels import CHOL_KERNEL, MAX_FUSED_N, chol_block_size, chol_panels, cholesky_local, dispatch_mode, record_dispatch
from ..tiling import factor_block_edge
from .qr import _full_float32_products

__all__ = ["cholesky", "solve", "solve_triangular"]


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
    """jnp.promote_types of the operands' types with float32: float64 if
    any operand is float64, else float32 (integers and bool included)."""
    return types.float64 if any(x.dtype is types.float64 for x in arrs) else types.float32


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


def _rows_at_or_after(counts, starts, g: int):
    """Each rank's number of rows with global index >= ``g``."""
    return [max(0, st + c - max(st, g)) for st, c in zip(starts, counts)]


def _lu_columns(p: torch.Tensor):
    """``heat_tpu``'s panel loop: ``(lu, piv)`` of ``p`` (m x b, m >= b) by
    partial pivoting one column at a time, the first maximum of |column|
    from the diagonal down as the pivot (on a tie the lowest row), and a
    zero pivot's multipliers left zero; ``piv`` 1-based, as
    ``torch.linalg.lu_factor``'s. Nothing is read on the host."""
    lu = p.clone()
    m, b = lu.shape
    piv = torch.empty(b, dtype=torch.int64, device=lu.device)
    for j in range(min(m, b)):
        k = torch.argmax(lu[j:, j].abs()) + j
        piv[j] = k + 1
        row_j, row_k = lu[j].clone(), lu[k].clone()
        lu[j] = row_k
        lu[k] = row_j
        pv = lu[j, j]
        below = lu[j + 1 :, j]
        mult = torch.where(pv == 0, torch.zeros_like(below), below / torch.where(pv == 0, torch.ones_like(pv), pv))
        lu[j + 1 :, j] = mult
        lu[j + 1 :, j + 1 :] -= mult[:, None] * lu[j, j + 1 :][None, :]
    return lu, piv


def _lu_library(p: torch.Tensor):
    """``torch.linalg.lu_factor_ex(p)`` (``(lu, piv, info)``, ``p`` one
    matrix or a stack): on a card through cuSOLVER's ``getrf``, which
    torch's default gives only square matrices: it sends a rectangular one
    to MAGMA, 263 ms for a (16384, 4096) float32 panel on an H100,
    ``chip_smoke.py`` ``[linalg]``."""
    if not p.is_cuda:
        return torch.linalg.lu_factor_ex(p)
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        return torch.linalg.lu_factor_ex(p)
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def _lu_factor(p: torch.Tensor):
    """``(lu, piv)``: the LU with partial pivoting of the (m, b) ``p``, m >=
    b, with ``piv`` 0-based on the host (one read). The library's blocked
    factorization (:func:`_lu_library`), unless it meets an exactly zero
    pivot (``info > 0``): a card's library may then divide 0 by 0 where
    ``heat_tpu`` zeroes the multipliers, so that matrix is factored again by
    :func:`_lu_columns`."""
    lu, piv, info = _lu_library(p)
    host = torch.cat([info.reshape(1).to(piv.dtype), piv]).cpu().numpy().astype(np.int64)
    if host[0] > 0:
        lu, piv = _lu_columns(p)
        host = np.concatenate([[0], piv.cpu().numpy()])
    return lu, host[1:] - 1


def _det_local(t: torch.Tensor) -> torch.Tensor:
    """The determinants of ``t`` (..., n, n): the product of U's diagonal
    times the sign of the row exchanges, as ``torch.linalg.det`` forms it,
    over :func:`_lu_library`'s factors (one host read of their ``info``); a
    matrix that meets an exactly zero pivot is factored again by
    :func:`_lu_factor`, whose zero-pivot rule gives it an exact zero
    determinant on a card too."""
    lu, piv, info = _lu_library(t)
    bad = torch.nonzero(info.reshape(-1) > 0).flatten().tolist()
    if bad:
        n = t.shape[-1]
        lu, piv = lu.reshape(-1, n, n).clone(), piv.reshape(-1, n).clone()
        for i in bad:
            lu[i], pv = _lu_factor(t.reshape(-1, n, n)[i])
            piv[i] = torch.as_tensor(pv + 1, dtype=piv.dtype, device=piv.device)
        lu, piv = lu.reshape(t.shape), piv.reshape(t.shape[:-1])
    swaps = (piv != torch.arange(1, t.shape[-1] + 1, device=t.device, dtype=piv.dtype)).sum(dim=-1)
    sign = 1 - 2 * (swaps % 2).to(t.dtype)
    return sign * torch.diagonal(lu, dim1=-2, dim2=-1).prod(dim=-1)


def _lu_split0(m: DNDarray, mode: str, rhs=None):
    """LU with partial pivoting of the square split-0 ``m`` across ranks,
    in ``heat_tpu``'s right-looking panels of the chunk length
    (``factor_block_edge(m, 1, ...)``, so a panel never straddles ranks).

    ``mode`` is ``"det"`` (returns the determinant, a 0-d tensor, the same
    on every rank), ``"solve"`` (``rhs``, this rank's rows of the right-hand
    side as columns, rides the elimination) or ``"inv"`` (this rank's rows
    of the identity ride it); the last two return this rank's rows of the
    solution. Per panel of columns ``[off, end)``:

    - one ``allgather`` of the panel's rows ``>= off``; every rank factors
      that (n - off, bs) panel with partial pivoting (:func:`_lu_factor`,
      the first maximum of |column| from the diagonal down, so on a tie the
      lowest global row), so every rank holds the same pivots and factor;
    - the pivots' row exchanges, applied to the columns right of the panel
      (the augmented ones included), move only the <= 2 bs rows they touch:
      one ``allgather`` of those rows, each rank then writes its own;
    - every rank solves the panel's U block row from the gathered rows
      (unit-lower ``L11``) and updates its own rows below the panel.

    A zero pivot (its whole remaining column is zero) leaves its
    multipliers zero, so a singular matrix has an exact zero determinant.
    ``det`` is the product of the panels' U diagonals, in panel order, times
    the sign of the exchanges. The back substitution walks the panels in
    reverse: the owner solves its diagonal block and broadcasts the
    solution rows (one ``bcast`` per panel); every rank removes them from
    its rows above. Ranks with no rows take part in every collective."""
    comm = m.comm
    n = m.gshape[0]
    tt = m.larray.dtype
    mi, bs, s, rows = _geometry(m, 1)
    dev = m.larray.device
    if mode == "solve":
        A = torch.cat([m.larray, rhs.to(tt)], dim=1)
    elif mode == "inv":
        A = torch.cat([m.larray, _eye_rows(rows, n, s, tt, dev)], dim=1)
    else:
        A = m.larray.clone()
    W = A.shape[1]
    counts = [int(c) for c in m.lshape_map[:, 0]]
    starts = [min(q * mi, n) for q in range(comm.size)]
    diag_blocks, exchanges = [], 0
    for off in range(0, n, bs):
        end = min(off + bs, n)
        b = end - off
        lo = min(max(off - s, 0), rows)  # this rank's first row at or below the panel's top
        panel = comm.allgather(A[lo:, off:end].contiguous(), 0, _rows_at_or_after(counts, starts, off))
        lu, piv = _lu_factor(panel)  # the panel's one host read: its exchanges
        del panel
        perm = list(range(n - off))
        for j, p in enumerate(piv.tolist()):
            if p != j:
                perm[j], perm[p] = perm[p], perm[j]
                exchanges += 1
        perm = np.asarray(perm)
        diag_blocks.append(torch.triu(lu[:b, :b]))
        if W > end:
            # the rows whose content moves, and the panel's own rows: their old content, columns end..W-1
            moved = np.union1d(np.arange(b), np.nonzero(perm != np.arange(n - off))[0]) + off
            mine = moved[(moved >= s) & (moved < s + rows)]
            owned = [int(((moved >= st) & (moved < st + c)).sum()) for st, c in zip(starts, counts)]
            idx = torch.as_tensor(mine - s, device=dev)
            old = comm.allgather(A[idx, end:].contiguous(), 0, owned)
            pos = {int(g): i for i, g in enumerate(moved)}
            src = lambda gs: torch.as_tensor([pos[off + int(perm[g - off])] for g in gs], device=dev, dtype=torch.int64)
            if len(mine):
                A[idx, end:] = old[src(mine)]
            u12 = torch.linalg.solve_triangular(lu[:b, :b], old[src(range(off, end))], upper=False,
                                                left=True, unitriangular=True)
            del old
            if s <= off < s + rows:  # the owner keeps the panel's U block row (U11 stays in diag_blocks)
                A[off - s : end - s, end:] = u12
            r0 = min(max(end - s, 0), rows)  # this rank's rows below the panel
            if r0 < rows:
                A[r0:, end:] -= lu[s + r0 - off : s + rows - off] @ u12
            del u12
        del lu
    if mode == "det":
        d = torch.prod(torch.cat([blk.diagonal() for blk in diag_blocks]))
        return -d if exchanges % 2 else d
    X = A[:, n:]
    offs = list(range(0, n, bs))
    for kb in reversed(range(len(offs))):
        off = offs[kb]
        end = min(off + bs, n)
        owner = off // mi
        if comm.rank == owner:
            xk = torch.linalg.solve_triangular(diag_blocks[kb], X[off - s : end - s], upper=True)
        else:
            xk = torch.empty((end - off, W - n), dtype=tt, device=dev)
        xk = comm.bcast(xk.contiguous(), owner)
        if comm.rank == owner:
            X[off - s : end - s] = xk
        r1 = min(max(off - s, 0), rows)  # this rank's rows above the panel
        if r1 > 0:
            X[:r1] -= A[:r1, off:end] @ xk
    return X.contiguous()


def _eye_rows(rows: int, n: int, start: int, tt, dev) -> torch.Tensor:
    """Rows ``start .. start + rows - 1`` of the (n, n) identity."""
    e = torch.zeros((rows, n), dtype=tt, device=dev)
    e[torch.arange(rows, device=dev), torch.arange(start, start + rows, device=dev)] = 1
    return e


def _local_rows(b: DNDarray, comm) -> torch.Tensor:
    """This rank's chunk of rows of ``b`` (split 0 or not)."""
    return b.larray if b.split == 0 else b._logical()[comm.chunk(b.gshape, 0)[2]]


@_full_float32_products()
def solve(a: DNDarray, b: DNDarray) -> DNDarray:
    """Solution of ``a @ x = b`` for a square 2-D ``a``; ``b`` is a vector
    or a column stack.

    A split ``a`` above world size 1 runs the blocked LU with partial
    pivoting across the ranks (:func:`_lu_split0`; a split-1 ``a`` is
    resplit first), ``b`` riding the elimination, and gives a split-0
    result. Otherwise the solve is local (``torch.linalg.solve``, where
    ``heat_tpu`` calls ``jnp.linalg.solve``) and the result replicated."""
    _square_2d_check("solve", a)
    if not isinstance(b, DNDarray):
        raise TypeError(f"solve expects a DNDarray rhs, got {type(b)}")
    if b.ndim not in (1, 2):
        raise ValueError(f"solve rhs must be 1-D or 2-D, got {b.ndim}-D")
    n = a.gshape[0]
    if b.gshape[0] != n:
        raise ValueError(f"dimension mismatch: a has {n} rows, b has {b.gshape[0]}")
    ftype = _float_type(a, b)
    tt = ftype.torch_type()
    if _split_across_ranks(a):
        a0 = a if a.split == 0 else a.resplit(0)
        a0 = a0 if a0.larray.dtype == tt else DNDarray(a0.larray.to(tt), gshape=a0.gshape, split=0, device=a.device,
                                                       comm=a.comm)
        rhs = _local_rows(b, a.comm).to(tt)
        x = _lu_split0(a0, "solve", rhs.unsqueeze(1) if b.ndim == 1 else rhs)
        return DNDarray(x.squeeze(1) if b.ndim == 1 else x, gshape=b.gshape, dtype=ftype, split=0, device=a.device,
                        comm=a.comm)
    x = torch.linalg.solve(a._logical().to(tt), b._logical().to(tt))
    return DNDarray(x, dtype=ftype, split=None, device=a.device, comm=a.comm)


def _batch_split(a: DNDarray) -> bool:
    return a.ndim > 2 and a.split is not None and a.split < a.ndim - 2


def _split0_operand(a: DNDarray, tt) -> DNDarray:
    """The split-0 operand whose LU gives ``a``'s determinant or inverse: ``a``
    itself, or for a split-1 ``a`` its transpose (no data moves), in ``tt``."""
    m = a if a.split == 0 else a.T
    return DNDarray(m.larray.to(tt).contiguous(), gshape=m.gshape, split=0, device=a.device, comm=a.comm)


@_full_float32_products()
def _det_impl(a: DNDarray) -> DNDarray:
    """Determinant: the blocked LU across ranks for a split 2-D operand
    (``det(a) == det(a.T)`` makes a split-1 operand split 0 with no data
    moved), each rank's own stack for a batch-split stack, else local
    (:func:`_det_local`, where ``heat_tpu`` calls ``jnp.linalg.det``)."""
    ftype = _float_type(a)
    tt = ftype.torch_type()
    comm = a.comm
    if a.ndim == 2 and _split_across_ranks(a):
        d = _lu_split0(_split0_operand(a, tt), "det")
        return DNDarray(d, dtype=ftype, split=None, device=a.device, comm=comm)
    if _batch_split(a):
        return DNDarray(_det_local(a.larray.to(tt)), gshape=a.gshape[:-2], dtype=ftype, split=a.split,
                        device=a.device, comm=comm)
    return DNDarray(_det_local(a._logical().to(tt)), dtype=ftype, split=None, device=a.device, comm=comm)


@_full_float32_products()
def _inv_impl(a: DNDarray) -> DNDarray:
    """Inverse: the blocked LU across ranks with the identity riding as
    augmented columns for a split 2-D operand (``inv(a) == inv(a.T).T``: a
    split-1 operand's result is the transpose of its transpose's, split 1,
    with no data moved), each rank's own stack for a batch-split stack, else
    local; the result keeps ``a``'s split."""
    ftype = _float_type(a)
    tt = ftype.torch_type()
    comm = a.comm
    if a.ndim == 2 and _split_across_ranks(a):
        x = DNDarray(_lu_split0(_split0_operand(a, tt), "inv"), gshape=a.gshape, dtype=ftype, split=0,
                     device=a.device, comm=comm)
        return x if a.split == 0 else x.T
    if _batch_split(a):
        return DNDarray(torch.linalg.inv(a.larray.to(tt)), gshape=a.gshape, dtype=ftype, split=a.split,
                        device=a.device, comm=comm)
    x = torch.linalg.inv(a._logical().to(tt))
    if a.split is not None and comm.is_distributed():
        x = x[comm.chunk(a.gshape, a.split)[2]]
    return DNDarray(x, gshape=a.gshape, dtype=ftype, split=a.split, device=a.device, comm=comm)
