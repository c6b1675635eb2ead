"""Iterative solvers (counterpart of ``heat_tpu/core/linalg/solver.py``):
conjugate gradients and Lanczos tridiagonalization.

``heat_tpu`` runs each as one device program (``lax.while_loop``,
``lax.fori_loop``). Here the iterations are a loop of torch calls that
never reads a value on the host inside an iteration: ``cg`` runs blocks of
``CG_BLOCK`` iterations in which a device-side flag freezes the state once
``heat_tpu``'s loop would have stopped (``r·r < 1e-20``, or n iterations),
and reads that flag once per block, so it stops after the same iteration
as ``heat_tpu``; ``lanczos`` runs its m steps with no host read at all.

Across ranks the square operand stays where it is and every vector is
replicated: each product ``A @ v`` is this rank's rows' product and one
``allgather`` of the n results (a row-split ``A``), or this rank's columns'
product and one ``allreduce`` (a column-split ``A``). Every rank then
computes the same scalars and vectors from the same values, so the
replicated results are bit-identical on every rank. Float32 products run
in full float32 inside both (no TF32), as ``heat_tpu`` runs them at
``default_matmul_precision("highest")``.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .._operations import _write_out
from ..dndarray import DNDarray
from .factorizations import _float_type
from .qr import _full_float32_products

__all__ = ["cg", "lanczos"]

# cg iterations between two host reads of the stop flag
CG_BLOCK = 32


def _matvec(A: DNDarray, ftype) -> Tuple[Callable[[torch.Tensor], torch.Tensor], int]:
    """``(v -> A @ v, n)`` for the square ``A`` and a replicated vector
    ``v``, the product replicated on every rank."""
    comm = A.comm
    a = A.larray.to(ftype.torch_type())
    n = A.gshape[0]
    if A.split is None or not comm.is_distributed():
        return (lambda v: a @ v), n
    counts = [int(c) for c in A.lshape_map[:, A.split]]
    off = comm.chunk(A.gshape, A.split)[0]
    if A.split == 0:
        return (lambda v: comm.allgather(a @ v, 0, counts)), n
    return (lambda v: comm.allreduce(a @ v[off : off + a.shape[1]])), n


def _vector(v: DNDarray, tt) -> torch.Tensor:
    return v._logical().to(tt)


def cg(A: DNDarray, b: DNDarray, x0: DNDarray, out: Optional[DNDarray] = None) -> DNDarray:
    """Conjugate gradients for a symmetric positive definite ``A`` from
    ``x0``: the solution of ``A @ x = b`` (split as ``b``), after
    ``heat_tpu``'s iterations (until ``r·r < 1e-20``, at most n)."""
    if not isinstance(A, DNDarray) or not isinstance(b, DNDarray) or not isinstance(x0, DNDarray):
        raise TypeError(f"A, b and x0 need to be DNDarrays, got {type(A)}, {type(b)}, {type(x0)}")
    if A.ndim != 2:
        raise RuntimeError("A needs to be a 2D matrix")
    if b.ndim != 1:
        raise RuntimeError("b needs to be a 1D vector")
    if x0.ndim != 1:
        raise RuntimeError("x0 needs to be a 1D vector")
    ftype = _float_type(A)
    tt = ftype.torch_type()
    with _full_float32_products():
        matvec, n = _matvec(A, ftype)
        x, _ = _cg(matvec, _vector(b, tt), _vector(x0, tt), n)
    if b.split is not None and b.comm.is_distributed():
        x = x[b.comm.chunk(b.gshape, b.split)[2]]
    res = DNDarray(x, gshape=b.gshape, dtype=ftype, split=b.split, device=b.device, comm=b.comm)
    return res if out is None else _write_out(out, res)


def _cg(matvec, b: torch.Tensor, x: torch.Tensor, n: int):
    """``(x, iterations)`` of ``heat_tpu``'s loop: an iteration runs while
    ``r·r >= 1e-20`` and fewer than ``n`` ran."""
    r = b - matvec(x)
    p = r
    rs = torch.dot(r, r)
    it = torch.zeros((), dtype=torch.int64, device=x.device)
    while True:
        for _ in range(CG_BLOCK):
            go = (rs >= 1e-20) & (it < n)
            ap = matvec(p)
            alpha = rs / torch.dot(p, ap)
            x_new = x + alpha * p
            r_new = r - alpha * ap
            rs_new = torch.dot(r_new, r_new)
            p_new = r_new + (rs_new / rs) * p
            x, r, p = torch.where(go, x_new, x), torch.where(go, r_new, r), torch.where(go, p_new, p)
            rs = torch.where(go, rs_new, rs)
            it = it + go.to(it.dtype)
        if not bool((rs >= 1e-20) & (it < n)):  # the block's one host read
            return x, int(it)


def lanczos(
    A: DNDarray,
    m: int,
    v0: Optional[DNDarray] = None,
    V_out: Optional[DNDarray] = None,
    T_out: Optional[DNDarray] = None,
) -> Tuple[DNDarray, DNDarray]:
    """Lanczos tridiagonalization of a symmetric ``A`` in ``m`` steps from
    ``v0`` (default ones / sqrt(n)), with full re-orthogonalization every
    step: ``(V, T)``, V (n, m) with orthonormal columns and T (m, m)
    tridiagonal, ``A ~= V T V^T``, both replicated."""
    if not isinstance(A, DNDarray):
        raise TypeError(f"A needs to be a DNDarray, got {type(A)}")
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise RuntimeError("A needs to be a square matrix")
    m = int(m)
    ftype = _float_type(A)
    tt = ftype.torch_type()
    with _full_float32_products():
        matvec, n = _matvec(A, ftype)
        dev = A.larray.device
        if v0 is None:
            v = torch.ones(n, dtype=tt, device=dev) / torch.sqrt(torch.tensor(float(n), dtype=tt, device=dev))
        else:
            v = _vector(v0, tt)
            v = v / torch.linalg.vector_norm(v)
        V, T = _lanczos(matvec, v, m)
    meta = dict(dtype=ftype, split=None, device=A.device, comm=A.comm)
    V_dnd, T_dnd = DNDarray(V.T.contiguous(), **meta), DNDarray(T, **meta)
    return (V_dnd if V_out is None else _write_out(V_out, V_dnd)), (T_dnd if T_out is None else _write_out(T_out, T_dnd))


def _lanczos(matvec, v: torch.Tensor, m: int):
    """``heat_tpu``'s recurrence: ``(V, T)`` with the Lanczos vectors as
    the rows of V (m, n). The 1e-12 guards keep a vanishing ``w`` (an
    invariant subspace reached) from dividing by zero."""
    n = v.shape[0]
    V = torch.zeros((m, n), dtype=v.dtype, device=v.device)
    alphas = torch.zeros(m, dtype=v.dtype, device=v.device)
    betas = torch.zeros(m, dtype=v.dtype, device=v.device)
    V[0] = v
    w = matvec(v)
    alphas[0] = torch.dot(w, v)
    w = w - alphas[0] * v
    one = torch.ones((), dtype=v.dtype, device=v.device)
    for i in range(1, m):
        beta = torch.linalg.vector_norm(w)
        v_next = torch.where(beta > 1e-12, w / torch.where(beta == 0, one, beta), torch.zeros_like(w))
        # full re-orthogonalization against the vectors so far (heat_tpu's V.T @ (V @ v) over zero rows beyond i)
        v_next = v_next - V[:i].T @ (V[:i] @ v_next)
        nrm = torch.linalg.vector_norm(v_next)
        v_next = torch.where(nrm > 1e-12, v_next / torch.where(nrm == 0, one, nrm), v_next)
        V[i] = v_next
        w = matvec(v_next)
        alphas[i] = torch.dot(w, v_next)
        w = w - alphas[i] * v_next - beta * V[i - 1]
        betas[i] = beta
    T = torch.diag(alphas) + torch.diag(betas[1:], 1) + torch.diag(betas[1:], -1)
    return V, T
