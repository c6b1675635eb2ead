"""Singular value decomposition and what stands on it (counterpart of
``heat_tpu/core/linalg/svd.py``): ``svd``, the randomized ``rsvd``,
``lstsq`` and ``pinv``.

A tall (m >= n) split-0 or replicated array takes :func:`.qr.qr` (TSQR
above world size 1: one ``allgather`` of the ranks' R factors) and the SVD
of the replicated R; U is Q times R's left singular vectors, each rank its
own rows. ``heat_tpu`` takes that route only above world size 1 and at
world size 1 the SVD of the whole array (``jnp.linalg.svd``); the port
takes it at world size 1 too, because the whole array's
``torch.linalg.svd`` (cuSOLVER's ``gesvdj``) raises
``CUSOLVER_STATUS_INVALID_VALUE`` for a (2^24, 64) float32 array on an
H100 (``chip_smoke.py`` ``[dist]``). A wide array, or one split along its
columns, takes the SVD of the whole array. ``rsvd`` draws its Gaussian test matrix from ``heat_tpu``'s
threefry stream (the ``threefry_bits`` kernel on a card), so a
``random_state`` gives ``heat_tpu``'s matrix. Float32 products run in full
float32 (no TF32) inside each call.
"""
from __future__ import annotations

import collections
from typing import Optional

import torch

from .. import random as ht_random
from ..dndarray import DNDarray
from .basics import matmul
from .factorizations import _float_type, solve_triangular
from .qr import _full_float32_products, qr

__all__ = ["lstsq", "pinv", "rsvd", "svd"]

SVD_out = collections.namedtuple("SVD", "U, S, Vh")


def _qr_route(a: DNDarray) -> bool:
    return a.split in (0, None) and a.gshape[0] >= a.gshape[1]


def svd(a: DNDarray, full_matrices: bool = False, compute_uv: bool = True):
    """``SVD(U, S, Vh)`` of a 2-D array (only ``S`` for
    ``compute_uv=False``), S descending.

    A tall (m >= n) split-0 or replicated array goes through ``qr`` (TSQR
    across ranks) and the SVD of R; otherwise the whole array's SVD. U is
    split 0 where ``a`` is, Vh split 1 where ``a`` is, S replicated.
    ``full_matrices=True`` is taken only for a replicated array, by the
    whole array's SVD."""
    if not isinstance(a, DNDarray):
        raise TypeError(f"expected a DNDarray, got {type(a)}")
    if a.ndim != 2:
        raise ValueError(f"svd requires a 2-D array, got {a.ndim}-D")
    if full_matrices and a.split is not None:
        raise NotImplementedError("full_matrices=True is not supported for split arrays")
    with _full_float32_products():
        return _svd_impl(a, full_matrices, compute_uv)


def _svd_impl(a: DNDarray, full_matrices: bool, compute_uv: bool):
    comm = a.comm
    meta = dict(device=a.device, comm=comm)
    if _qr_route(a) and not full_matrices:
        Q, R = qr(a, calc_q=compute_uv)
        if not compute_uv:
            return DNDarray(torch.linalg.svdvals(R.larray), split=None, **meta)
        u_r, s, vh = torch.linalg.svd(R.larray, full_matrices=False)
        U = matmul(Q, DNDarray(u_r, split=None, **meta))
        return SVD_out(U, DNDarray(s, split=None, **meta), DNDarray(vh, split=None, **meta))
    arr = a._logical().to(_float_type(a).torch_type())
    if not compute_uv:
        return DNDarray(torch.linalg.svdvals(arr), split=None, **meta)
    u, s, vh = torch.linalg.svd(arr, full_matrices=full_matrices)
    su, sv = (0 if a.split == 0 else None), (1 if a.split == 1 else None)
    U = DNDarray(u[comm.chunk(u.shape, su)[2]], gshape=tuple(u.shape), split=su, **meta)
    Vh = DNDarray(vh[comm.chunk(vh.shape, sv)[2]], gshape=tuple(vh.shape), split=sv, **meta)
    return SVD_out(U, DNDarray(s, split=None, **meta), Vh)


def rsvd(a: DNDarray, rank: int, n_oversamples: int = 10, n_iter: int = 2, random_state: Optional[int] = None):
    """Randomized truncated SVD (Halko, Martinsson and Tropp) of a 2-D
    array: ``SVD(U, S, Vh)`` of rank ``rank``, with ``n_oversamples`` extra
    columns in the range finder and ``n_iter`` power iterations.

    The test matrix is ``heat_tpu``'s draw: key
    ``fold_in(PRNGKey(random_state), k * n)``, or the global stream's next
    key (moving it on by k * n) when ``random_state`` is None, k = rank +
    n_oversamples (at most min(m, n)). A split-0 array above world size 1
    orthonormalizes its tall panels by TSQR and forms the (n, k) products
    by one ``allreduce``; U then carries the row split, S and Vh are
    replicated."""
    if not isinstance(a, DNDarray):
        raise TypeError(f"expected a DNDarray, got {type(a)}")
    if a.ndim != 2:
        raise ValueError(f"rsvd requires a 2-D array, got {a.ndim}-D")
    m, n = a.gshape
    if not 0 < rank <= min(m, n):
        raise ValueError(f"rank must be in [1, {min(m, n)}], got {rank}")
    k = min(rank + n_oversamples, min(m, n))
    if random_state is not None:
        key = ht_random._fold_in(ht_random._prng_key(random_state), k * n)
    else:
        key = ht_random._next_key(k * n)
    ftype = _float_type(a)
    comm = a.comm
    dist = a.split == 0 and comm.is_distributed()
    A = (a.larray if dist else a._logical()).to(ftype.torch_type())

    def ortho(Y):
        if dist:
            return qr(DNDarray(Y, gshape=(m, Y.shape[1]), dtype=ftype, split=0, device=a.device, comm=comm)).Q.larray
        return torch.linalg.qr(Y).Q

    def at(Q):  # A.T @ Q, replicated
        z = A.T @ Q
        return comm.allreduce(z) if dist else z

    with _full_float32_products():
        Q = ortho(A @ ht_random._normal_tensor(key, (n, k), ftype, A.device))  # jax's normal(key, (n, k))
        for _ in range(n_iter):
            Q = ortho(A @ torch.linalg.qr(at(Q)).Q)
        u_b, s, vh = torch.linalg.svd(at(Q).T, full_matrices=False)
        U = (Q @ u_b)[:, :rank]
    meta = dict(dtype=ftype, device=a.device, comm=comm)
    U_dnd = DNDarray(U, gshape=(m, rank), split=0 if a.split == 0 else None, **meta)
    return SVD_out(U_dnd, DNDarray(s[:rank], split=None, **meta), DNDarray(vh[:rank], split=None, **meta))


def lstsq(a: DNDarray, b: DNDarray, rcond: Optional[float] = None) -> DNDarray:
    """Least-squares solution of ``a @ x = b``.

    For m >= n and no ``rcond``: ``R x = Qᵀ b`` from :func:`.qr.qr` (TSQR
    across ranks), where R's diagonal passes ``heat_tpu``'s guard
    ``min|diag R| > eps * max(m, n) * max|diag R|`` (read on the host once
    per call). Otherwise, or where the guard fails (rank deficiency), the
    minimum-norm solution ``pinv(a, rcond) @ b``."""
    if not isinstance(a, DNDarray) or not isinstance(b, DNDarray):
        raise TypeError("lstsq expects DNDarray operands")
    if a.ndim != 2 or b.ndim not in (1, 2):
        raise ValueError(f"bad operand ranks {a.ndim}, {b.ndim}")
    m, n = a.gshape
    if b.gshape[0] != m:
        raise ValueError(f"dimension mismatch: a has {m} rows, b has {b.gshape[0]}")
    with _full_float32_products():
        if m >= n and rcond is None:
            eps_cut = torch.finfo(_float_type(a).torch_type()).eps * max(m, n)
            Q, R = qr(a)
            diag = torch.abs(torch.diagonal(R._logical()))
            lo, hi = torch.stack([diag.min(), diag.max()]).tolist()
            if lo > eps_cut * hi:
                return solve_triangular(R, matmul(Q.T, b), lower=False)
        return matmul(pinv(a, rcond=rcond), b)


def pinv(a: DNDarray, rcond: Optional[float] = None) -> DNDarray:
    """Moore-Penrose pseudoinverse by the SVD: singular values at most
    ``rcond`` times the largest count as zero (``rcond`` defaults to the
    type's eps times max(m, n), numpy's default). A split-0 ``a`` gives a
    split-1 result (the product with Uᵀ keeps U's rows split)."""
    if not isinstance(a, DNDarray):
        raise TypeError("pinv expects a DNDarray")
    if a.ndim != 2:
        raise ValueError(f"pinv requires a 2-D array, got {a.ndim}-D")
    with _full_float32_products():
        U, s, Vh = svd(a, full_matrices=False)
        if rcond is None:
            rcond = torch.finfo(_float_type(a).torch_type()).eps * max(a.gshape)
        sl = s.larray
        s_inv = torch.where(sl > rcond * torch.max(sl), 1.0 / sl, torch.zeros_like(sl))
        vs = Vh._logical().T * s_inv[None, :]
        return matmul(DNDarray(vs, split=None, device=a.device, comm=a.comm), U.T)
