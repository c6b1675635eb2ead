"""QR decomposition (counterpart of ``heat_tpu/core/linalg/qr.py``).

``method="auto"`` runs CholeskyQR2 for tall floating input (m >= 4n): two
passes of Gram product, Cholesky of the (n, n) Gram and triangular solve,
``R = r2 @ r1``. All its work but two tiny Cholesky factorizations is
(m, n) x (n, n) products. A guard then checks the result,
``max|QᵀQ − I| > 10·eps·n`` or a non-finite R (a non-finite Q shows on the
diagonal of QᵀQ), and where it trips the call falls back to Householder
(``torch.linalg.qr``), as ``heat_tpu`` does. Wide input (m < n) goes to
Householder directly.

``heat_tpu`` takes that decision on the device in a ``lax.cond``; here the
guard's one scalar is read on the host, once per call. Each call counts the
route it returned under ``KERNEL_STATS["qr.cholqr2"]`` or
``KERNEL_STATS["qr.householder"]``. Float32 products run in full float32
inside ``qr`` (no TF32), whatever the caller set.

Across ranks a split-0 array takes TSQR (``heat_tpu``'s ``qr.py:192-315``):
each rank factors its own rows as above (a block with fewer rows than
columns, or none, at its true row count by Householder), the ranks' R
factors are gathered (``allgather``) and factored again by Householder on
every rank, and each rank's Q is its block's Q times its rows of the
second Q. With ``tiles_per_proc`` > 1 each rank's rows first split into
row tiles of ``SquareDiagTiles``' edge (``heat_tpu``'s two-level tree):
each tile is factored, the tiles' stacked R factors are factored again
(Householder), and the block's Q is each tile's Q times its rows of that
Q. R comes out replicated and identical on every rank, Q split along 0. A
split-1 array is gathered and factored whole.
"""
from __future__ import annotations

import collections
import contextlib
import numbers
import warnings

import torch

from .. import types
from ..dndarray import DNDarray
from ..kernels import record_route

__all__ = ["QR_out", "qr"]

QR_out = collections.namedtuple("QR", "Q, R")


@contextlib.contextmanager
def _full_float32_products():
    """``torch.set_float32_matmul_precision("highest")`` inside the block;
    the caller's setting is restored on exit."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def qr(
    a: DNDarray,
    tiles_per_proc: int = 1,
    calc_q: bool = True,
    overwrite_a: bool = False,
    method: str = "auto",
) -> QR_out:
    """Reduced QR decomposition of a 2-D DNDarray: ``QR_out(Q, R)``.

    ``method`` is ``"auto"`` (CholeskyQR2 for floating input with m >= 4n,
    else Householder), ``"cholqr2"`` (CholeskyQR2 whenever m >= n, still
    guarded) or ``"householder"``. ``calc_q=False`` gives ``Q=None``.
    ``tiles_per_proc`` shapes the local level of the factorization tree
    above world size 1, as in ``heat_tpu``; ``overwrite_a`` only warns.
    Integer input computes in float32.

    Split 0 gives Q split 0 and R replicated (TSQR across ranks); split 1
    gives both split 1; None gives both None.
    """
    if not isinstance(a, DNDarray):
        raise TypeError(f"expected a DNDarray, got {type(a)}")
    if a.ndim != 2:
        raise ValueError(f"qr requires a 2-D array, got {a.ndim}-D")
    if method not in ("auto", "householder", "cholqr2"):
        raise ValueError(f"unknown qr method {method!r}")
    if not isinstance(tiles_per_proc, numbers.Integral) or isinstance(tiles_per_proc, bool):
        raise TypeError(f"tiles_per_proc must be an int, got {type(tiles_per_proc)}")
    if int(tiles_per_proc) < 1:
        raise ValueError(f"tiles_per_proc must be positive, got {tiles_per_proc}")
    if overwrite_a:
        warnings.warn("qr: overwrite_a is accepted for heat_tpu's signature but has no effect", UserWarning, stacklevel=2)
    ftype = types.float64 if a.dtype is types.float64 else types.float32
    comm = a.comm
    tsqr = a.split == 0 and comm.is_distributed()
    x = (a.larray if tsqr or a.split is None else a._logical()).to(ftype.torch_type())
    with _full_float32_products():
        if tsqr and int(tiles_per_proc) > 1:
            q, r, route = _factor_tiles(x, _tile_rows(a, int(tiles_per_proc)), method, calc_q)
        else:
            q, r, route = _factor(x, method, calc_q)
        if tsqr:
            # the ranks' R factors, stacked in rank order, factored again
            k = min(x.shape[0], x.shape[1])
            counts = [min(int(m_r), x.shape[1]) for m_r in a.lshape_map[:, 0]]
            q2, r = torch.linalg.qr(comm.allgather(r, 0, counts), mode="reduced")
            start = sum(counts[: comm.rank])
            q = q @ q2[start : start + k] if calc_q else None
    record_route("qr", route)
    meta = dict(dtype=ftype, device=a.device, comm=comm)
    m, n = a.gshape
    kk = r.shape[0]
    if a.split == 1 and comm.is_distributed():
        Q = DNDarray(q[comm.chunk((m, kk), 1)[2]], gshape=(m, kk), split=1, **meta) if calc_q else None
        return QR_out(Q, DNDarray(r[comm.chunk((kk, n), 1)[2]], gshape=(kk, n), split=1, **meta))
    Q = DNDarray(q, gshape=(m, kk), split=a.split, **meta) if calc_q else None
    R = DNDarray(r, split=None if a.split == 0 else a.split, **meta)
    return QR_out(Q, R)


def _tile_rows(a: DNDarray, tiles_per_proc: int) -> int:
    """The row edge of ``SquareDiagTiles(a, tiles_per_proc)``: the rows of
    one tile of the local level of the TSQR tree."""
    from ..tiling import SquareDiagTiles

    ri = SquareDiagTiles(a, tiles_per_proc).row_indices
    return ri[1] - ri[0] if len(ri) > 1 else max(1, a.lshape[0])


def _factor_tiles(x: torch.Tensor, tile_rows: int, method: str, calc_q: bool):
    """``(q, r, route)`` of a local block by tiles of ``tile_rows`` rows (the
    last may be shorter): each tile factored by :func:`_factor`, their
    stacked R factors factored again by Householder. ``route`` is
    ``cholqr2`` where every tile took it."""
    m = x.shape[0]
    if m <= tile_rows:
        return _factor(x, method, calc_q)
    parts = [_factor(x[r0 : r0 + tile_rows], method, calc_q) for r0 in range(0, m, tile_rows)]
    rs = torch.cat([r for _, r, _ in parts], dim=0)
    route = "cholqr2" if all(rt == "cholqr2" for _, _, rt in parts) else "householder"
    if not calc_q:
        return None, torch.linalg.qr(rs, mode="r").R, route
    qm, r = torch.linalg.qr(rs, mode="reduced")
    qs, at = [], 0
    for q, rt, _ in parts:
        qs.append(q @ qm[at : at + rt.shape[0]])
        at += rt.shape[0]
    return torch.cat(qs, dim=0), r, route


def _factor(x: torch.Tensor, method: str, calc_q: bool):
    """``(q, r, route)`` of a local (m, n) block: CholeskyQR2 where the
    method and shape ask for it and its guard passes, else Householder
    (``q`` None when not ``calc_q``). A block with no rows gives a (0, 0)
    ``q`` and a (0, n) ``r``."""
    m, n = x.shape
    if m >= n and (method == "cholqr2" or (method == "auto" and n >= 1 and m >= 4 * n)):
        q, r, bad = _cholqr2(x)
        if not bool(bad):  # the guard's one host read
            return q, r, "cholqr2"
    if calc_q:
        q, r = torch.linalg.qr(x, mode="reduced")
        return q, r, "householder"
    return None, torch.linalg.qr(x, mode="r").R, "householder"


def _chol_pass(v: torch.Tensor):
    """One CholeskyQR pass: ``L = chol(vᵀv)``, ``q = v L⁻ᵀ``, ``r = Lᵀ``.
    A failed Cholesky (``info != 0``) gives a NaN factor, which trips the
    guard; nothing here syncs with the host. ``q`` is solved as
    ``qᵀ = L⁻¹ vᵀ``: on an H100 (80GB HBM3, 700 W) that left solve on the
    column-major view ``vᵀ`` takes 38 ms at (2^24, 64), where the right
    solve ``q Lᵀ = v`` takes 62 ms and returns a strided ``q``
    (``tools/torch_qr_split.py``)."""
    lt, info = torch.linalg.cholesky_ex(v.mT @ v)
    lt = torch.where(info == 0, lt, torch.full_like(lt, float("nan")))
    q = torch.linalg.solve_triangular(lt, v.mT, upper=False).mT
    return q, lt.mT


def _cholqr2(x: torch.Tensor):
    """CholeskyQR2: ``(q, r, bad)`` with ``bad`` a 0-d bool tensor on the
    device. ``~(err <= tol)`` is also true for a NaN error, so a
    non-finite q, which puts inf or NaN on the diagonal of qᵀq, trips it."""
    q1, r1 = _chol_pass(x)
    q2, r2 = _chol_pass(q1)
    r = r2 @ r1
    n = x.shape[1]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    err = torch.amax(torch.abs(q2.mT @ q2 - eye))
    tol = 10 * torch.finfo(x.dtype).eps * n
    bad = ~(err <= tol) | ~torch.isfinite(r).all()
    return q2, r, bad
