"""Linear algebra basics (counterpart of ``heat_tpu/core/linalg/basics.py``):
``matmul``, ``dot``, ``vdot``/``vecdot``, ``outer``, ``cross``,
``projection``, ``transpose``, ``tril``/``triu``, ``trace``, the norms, and
``det``/``inv`` over the LU of :mod:`.factorizations`.

What this module keeps from ``heat_tpu`` is the shape checks, the result
types and the rule for the result's split axis (``_matmul_out_split``).
Across ranks a 2-D product runs on the chunks where the split axes allow:
a row-split ``a`` times a replicated ``b`` (or a replicated ``a`` times a
column-split ``b``) is local; a product over a split contracted axis
(``A.T @ A`` with A split along 0) is a local product plus an
``allreduce``, replicated; other split pairs gather the operand that is in
the way. Norms over a split axis gather the array, except the default
(Frobenius) norm, a sum of squares reduced across ranks.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import arithmetics, types
from .._operations import _local_operand, _reduced_shape, _reduced_split, _write_out
from ..dndarray import DNDarray
from ..stride_tricks import sanitize_axis

__all__ = [
    "cross",
    "det",
    "dot",
    "inv",
    "matmul",
    "matrix_norm",
    "norm",
    "outer",
    "projection",
    "trace",
    "transpose",
    "tril",
    "triu",
    "vdot",
    "vecdot",
    "vector_norm",
]


def _matmul_gshape(sa: Tuple[int, ...], sb: Tuple[int, ...]) -> Tuple[int, ...]:
    """numpy's matmul result shape (1-D promotion, batch broadcast)."""
    a1, b1 = len(sa) == 1, len(sb) == 1
    ea = (1,) + tuple(sa) if a1 else tuple(sa)
    eb = tuple(sb) + (1,) if b1 else tuple(sb)
    if ea[-1] != eb[-2]:
        raise ValueError(f"matmul: contraction mismatch {sa} x {sb}")
    batch = np.broadcast_shapes(ea[:-2], eb[:-2])
    core = () if a1 and b1 else (eb[-1],) if a1 else (ea[-2],) if b1 else (ea[-2], eb[-1])
    return tuple(batch) + core


def _matmul_out_split(a: DNDarray, b: DNDarray, out_ndim: int) -> Optional[int]:
    """Result split: a row-split ``a`` gives row-split rows, a column-split
    ``b`` column-split columns, a split batch dimension of ``a`` stays
    split; a split contracted dimension gives a replicated result."""
    if a.ndim >= 2 and a.split == a.ndim - 2:
        return out_ndim - 2
    if b.ndim >= 2 and b.split == b.ndim - 1:
        return out_ndim - 1
    if a.split is not None and a.ndim >= 2 and a.split < a.ndim - 2:
        return a.split
    return None


_HALF = (torch.float16, torch.bfloat16)


@contextlib.contextmanager
def _float32_accumulation(tt: torch.dtype):
    """For half-precision products: cuBLAS's reduced-precision reductions
    off for the block (restored after it), so every sum accumulates in
    float32, as ``heat_tpu``'s products of half types do."""
    if tt not in _HALF:
        yield
        return
    m = torch.backends.cuda.matmul
    before = (m.allow_fp16_reduced_precision_reduction, m.allow_bf16_reduced_precision_reduction)
    m.allow_fp16_reduced_precision_reduction = m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_fp16_reduced_precision_reduction, m.allow_bf16_reduced_precision_reduction = before


def _partial_product(x: torch.Tensor, y: torch.Tensor, comm) -> torch.Tensor:
    """The sum over the ranks of ``x @ y``: half-precision partial products
    are added in float32 and rounded once."""
    if x.dtype in _HALF:
        return comm.allreduce(torch.matmul(x.float(), y.float())).to(x.dtype)
    return comm.allreduce(torch.matmul(x, y))


def _matmul_2d(a: DNDarray, b: DNDarray, tt) -> torch.Tensor:
    """This rank's part of the product of two 2-D operands, at least one
    split, laid out by :func:`_matmul_out_split`."""
    comm = a.comm
    la, lb = a.larray.to(tt), b.larray.to(tt)
    sa, sb = a.split, b.split
    if (sa, sb) in ((0, None), (None, 1)):
        return torch.matmul(la, lb)
    if sa == 1 and sb in (0, None):
        # the contracted axis is split: a product of the chunks, summed across ranks
        rows = lb if sb == 0 else lb[comm.chunk(b.gshape, 0)[2]]
        return _partial_product(la, rows, comm)
    if sa is None and sb == 0:
        return _partial_product(la[comm.chunk(a.gshape, 1)[2]], lb, comm)
    if sa == 0:
        return torch.matmul(la, b._logical().to(tt))
    return torch.matmul(a._logical().to(tt), lb)  # (1, 1): the whole a against b's columns


def matmul(a: DNDarray, b: DNDarray, allow_resplit: bool = False) -> DNDarray:
    """Matrix product of two DNDarrays, with numpy's shape rules.
    ``allow_resplit`` is accepted for ``heat_tpu``'s signature."""
    if not isinstance(a, DNDarray) or not isinstance(b, DNDarray):
        raise TypeError("both operands must be DNDarrays")
    if a.ndim == 0 or b.ndim == 0:
        raise ValueError("matmul: operands must have ndim >= 1")
    promoted = types.promote_types(a.dtype, b.dtype)
    tt = promoted.torch_type()
    out_gshape = _matmul_gshape(a.gshape, b.gshape)
    comm = a.comm
    split = _matmul_out_split(a, b, len(out_gshape)) if out_gshape else None
    if split is not None:
        split %= len(out_gshape)
    with _float32_accumulation(tt):
        result = _matmul_local(a, b, tt, out_gshape, split)
    if result.ndim == 0:
        return DNDarray(result, dtype=promoted, split=None, device=a.device, comm=comm)
    return DNDarray(result, gshape=out_gshape, dtype=promoted, split=split, device=a.device, comm=comm)


def _matmul_local(a: DNDarray, b: DNDarray, tt, out_gshape, split) -> torch.Tensor:
    """This rank's part of ``a @ b`` in the torch type ``tt``."""
    comm = a.comm
    la, lb = a.larray.to(tt), b.larray.to(tt)
    if not comm.is_distributed() or (a.split is None and b.split is None):
        result = torch.matmul(la, lb)
    elif a.ndim <= 2 and b.ndim <= 2:
        # a vector takes part as a one-row (a) or one-column (b) matrix, so a split matrix is never gathered
        a2 = a if a.ndim == 2 else DNDarray(la.unsqueeze(0), gshape=(1,) + a.gshape, split=None if a.split is None else 1,
                                            device=a.device, comm=comm)
        b2 = b if b.ndim == 2 else DNDarray(lb.unsqueeze(1), gshape=b.gshape + (1,), split=b.split, device=b.device,
                                            comm=comm)
        result = _matmul_2d(a2, b2, tt)
        if b.ndim == 1:
            result = result.squeeze(-1)
        if a.ndim == 1:
            result = result.squeeze(0)
    else:
        result = torch.matmul(a._logical().to(tt), b._logical().to(tt))
        result = result[comm.chunk(out_gshape, split)[2]] if result.ndim else result
    return result


def transpose(a: DNDarray, axes: Optional[List[int]] = None) -> DNDarray:
    """Permute dimensions (a view; no data moves). The split axis moves
    with its dimension."""
    if not isinstance(a, DNDarray):
        raise TypeError(f"a must be a DNDarray, got {type(a)}")
    if axes is None:
        axes = tuple(reversed(range(a.ndim)))
    else:
        axes = tuple(int(ax) % a.ndim if a.ndim else int(ax) for ax in axes)
        if len(axes) != a.ndim or sorted(axes) != list(range(a.ndim)):
            raise ValueError("axes do not match tensor shape")
    result = a.larray.permute(*axes)
    split = axes.index(a.split) if a.split is not None else None
    gshape = tuple(a.gshape[ax] for ax in axes)
    return DNDarray(result, gshape=gshape, dtype=a.dtype, split=split, device=a.device, comm=a.comm)


def _out(res: DNDarray, out: Optional[DNDarray]) -> DNDarray:
    return res if out is None else _write_out(out, res)


def dot(a: DNDarray, b: DNDarray, out: Optional[DNDarray] = None) -> DNDarray:
    """Dot product of two vectors (a replicated scalar), else ``matmul`` of
    operands with at most 2 dimensions."""
    if not isinstance(a, DNDarray) or not isinstance(b, DNDarray):
        raise TypeError("both operands must be DNDarrays")
    if a.ndim == 1 and b.ndim == 1:
        if a.gshape != b.gshape:
            raise ValueError(f"dot: shapes {a.gshape} and {b.gshape} not aligned")
        dtype = types._weak_result_type(a, b)
        # this rank's chunks (a replicated operand sliced to the split one's layout); one allreduce across ranks
        split = 0 if a.split is not None or b.split is not None else None
        va, vb = (_local_operand(v, a.gshape, split) for v in (a, b))
        if dtype is types.bool:
            result = torch.any(va & vb)
        else:
            tt = dtype.torch_type()
            result = torch.sum(va.to(tt) * vb.to(tt), dtype=tt)
        if split is not None and a.comm.is_distributed():
            result = a.comm.allreduce(result.to(torch.int32), "max").to(torch.bool) if dtype is types.bool else \
                a.comm.allreduce(result)
        return _out(DNDarray(result, dtype=dtype, split=None, device=a.device, comm=a.comm), out)
    if a.ndim <= 2 and b.ndim <= 2:
        return _out(matmul(a, b), out)
    raise NotImplementedError("ht.dot not implemented for >2 dimensions")


def _chunk_of(result: torch.Tensor, split: Optional[int], comm) -> torch.Tensor:
    """This rank's chunk along ``split`` of a result computed whole."""
    if split is None or not comm.is_distributed():
        return result
    return result[comm.chunk(tuple(result.shape), split)[2]]


def vdot(x1: DNDarray, x2: DNDarray) -> DNDarray:
    """Dot product of the flattened inputs with ``x1`` conjugated, a
    replicated scalar. Two operands of one shape, split alike (or one of
    them replicated), multiply on each rank's chunk, and one ``allreduce``
    adds the ranks' sums; otherwise the operands are gathered."""
    if x1.size != x2.size:
        raise ValueError(f"vdot: sizes {x1.size} and {x2.size} differ")
    dtype = types.promote_types(x1.dtype, x2.dtype)
    comm = x1.comm
    split = x1.split if x1.split is not None else x2.split
    chunked = comm.is_distributed() and split is not None and x1.gshape == x2.gshape \
        and x2.split in (None, split)
    if chunked:
        va, vb = (_local_operand(v, x1.gshape, split).reshape(-1) for v in (x1, x2))
    else:
        va, vb = x1._logical().reshape(-1), x2._logical().reshape(-1)
    if dtype is types.bool:
        result = torch.any(va & vb)
        if chunked:
            result = comm.allreduce(result.to(torch.int32), "max").to(torch.bool)
    else:
        tt = dtype.torch_type()
        va = va.to(tt)
        result = torch.sum((va.conj() if va.is_complex() else va) * vb.to(tt), dtype=tt)
        if chunked:
            result = comm.allreduce(result)
    return DNDarray(result, dtype=dtype, split=None, device=x1.device, comm=comm)


def vecdot(x1: DNDarray, x2: DNDarray, axis: Optional[int] = None, keepdim=None, keepdims: bool = False) -> DNDarray:
    """Dot products of the broadcast inputs along ``axis`` (default -1).
    The result's split is the split of ``x1`` (of ``x2`` if ``x1`` is
    replicated) with the reduced axis removed; its type is that of the
    sum of the products (integers below int64 sum in int64); ``x1`` is
    conjugated."""
    keepdims = bool(keepdim or keepdims)
    ndim = max(x1.ndim, x2.ndim)
    axis = sanitize_axis(tuple(np.broadcast_shapes(x1.shape, x2.shape)), -1 if axis is None else axis)
    t1 = x1._logical()
    prod = torch.mul(t1.conj() if t1.is_complex() else t1, x2._logical())
    result = torch.sum(prod, dim=axis, keepdim=keepdims)
    anchor = x1 if x1.split is not None else x2
    split = _reduced_split(anchor.split, axis, ndim, keepdims)
    gshape = tuple(result.shape)
    return DNDarray(_chunk_of(result, split, x1.comm), gshape=gshape, split=split, device=x1.device, comm=x1.comm)


def projection(a: DNDarray, b: DNDarray) -> DNDarray:
    """The projection of the vector ``a`` onto the vector ``b``:
    ``(a . b) / (b . b) * b``."""
    if a.ndim != 1 or b.ndim != 1:
        raise RuntimeError(f"projection requires 1-D vectors, got {a.ndim}, {b.ndim}")
    return (dot(a, b) / dot(b, b)) * b


def cross(a: DNDarray, b: DNDarray, axisa: int = -1, axisb: int = -1, axisc: int = -1, axis: int = -1) -> DNDarray:
    """Cross product of 2- or 3-component vectors, with numpy's axis rules
    (``axis`` other than -1 overrides ``axisa``, ``axisb`` and ``axisc``;
    two 2-component vectors give the z component alone). The result's
    split is ``a``'s (else ``b``'s), None where the vector axis is gone."""
    if axis != -1:
        axisa = axisb = axisc = axis
    ta = torch.movedim(a._logical(), axisa, -1)
    tb = torch.movedim(b._logical(), axisb, -1)
    if ta.shape[-1] not in (2, 3) or tb.shape[-1] not in (2, 3):
        raise ValueError("incompatible dimensions for cross product (dimension must be 2 or 3)")
    tt = types.promote_types(a.dtype, b.dtype).torch_type()
    batch = torch.broadcast_shapes(ta.shape[:-1], tb.shape[:-1])
    ta, tb = ta.to(tt).expand(*batch, ta.shape[-1]), tb.to(tt).expand(*batch, tb.shape[-1])
    a0, a1 = ta[..., 0], ta[..., 1]
    b0, b1 = tb[..., 0], tb[..., 1]
    if ta.shape[-1] == 2 and tb.shape[-1] == 2:
        result = a0 * b1 - a1 * b0
    else:
        zero = torch.zeros_like(a0)
        a2 = ta[..., 2] if ta.shape[-1] == 3 else zero
        b2 = tb[..., 2] if tb.shape[-1] == 3 else zero
        result = torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)
        result = torch.movedim(result, -1, axisc)
    split = a.split if a.split is not None else b.split
    if split is not None and result.ndim != a.ndim:
        split = None
    gshape = tuple(result.shape)
    return DNDarray(_chunk_of(result, split, a.comm), gshape=gshape, split=split, device=a.device, comm=a.comm)


def _square_check(a: DNDarray) -> None:
    if a.ndim < 2:
        raise RuntimeError(f"DNDarray must be at least two-dimensional, got {a.ndim}")
    if a.shape[-1] != a.shape[-2]:
        raise RuntimeError("Last two dimensions of the DNDarray must be square")


def det(a: DNDarray) -> DNDarray:
    """Determinant of a square matrix or a stack of them: a split 2-D
    operand above world size 1 by the blocked LU across the ranks (no
    gather), a batch-split stack on each rank's own matrices, otherwise
    locally. A singular matrix gives an exact 0."""
    _square_check(a)
    from .factorizations import _det_impl

    return _det_impl(a)


def inv(a: DNDarray) -> DNDarray:
    """Inverse of a square matrix or a stack of them: a split 2-D operand
    above world size 1 by the blocked LU across the ranks with the identity
    riding the elimination (no gather), a batch-split stack on each rank's
    own matrices, otherwise locally. The result keeps ``a``'s split."""
    _square_check(a)
    from .factorizations import _inv_impl

    return _inv_impl(a)


def outer(a: DNDarray, b: DNDarray, out: Optional[DNDarray] = None, split: Optional[int] = None) -> DNDarray:
    """Outer product of the flattened operands; split 0 if either operand is
    split, unless ``split`` says otherwise."""
    if split is None:
        split = 0 if (a.split is not None or b.split is not None) else None
    tt = types._weak_result_type(a, b).torch_type()
    va, vb = a._logical().reshape(-1).to(tt), b._logical().reshape(-1).to(tt)
    gshape = (va.shape[0], vb.shape[0])
    _, _, (rows, cols) = a.comm.chunk(gshape, split)
    result = torch.outer(va[rows], vb[cols])
    return _out(DNDarray(result, gshape=gshape, split=split, device=a.device, comm=a.comm), out)


def trace(a: DNDarray, offset: int = 0, axis1: int = 0, axis2: int = 1, dtype=None, out=None) -> DNDarray:
    """Sum along a diagonal (bool and integers below int64 sum in int64).
    Where the split axis is one of the two, each rank sums the diagonal
    elements in its chunk and one ``allreduce`` adds them up."""
    axis1, axis2 = sanitize_axis(a.shape, axis1), sanitize_axis(a.shape, axis2)
    comm = a.comm
    if a.split in (axis1, axis2) and comm.is_distributed():
        off = comm.chunk(a.gshape, a.split)[0]
        shift = off if a.split == axis1 else -off
        result = comm.allreduce(torch.diagonal(a.larray, offset=offset + shift, dim1=axis1, dim2=axis2).sum(dim=-1))
    else:
        result = torch.diagonal(a._logical(), offset=offset, dim1=axis1, dim2=axis2).sum(dim=-1)
    if dtype is not None:
        result = result.to(types.canonical_heat_type(dtype).torch_type())
    return _out(DNDarray(result, split=None, device=a.device, comm=comm), out)


def _tri_op(m: DNDarray, k: int, op) -> DNDarray:
    if not isinstance(m, DNDarray):
        raise TypeError(f"expected m to be a DNDarray, got {type(m)}")
    comm = m.comm
    if m.ndim == 1:
        # a vector becomes the (n, n) triangle of its copies, as in heat_tpu
        n = m.gshape[0]
        split = 0 if m.split is not None else None
        off, (rows, _), _ = comm.chunk((n, n), split)
        result = op(m._logical().expand(n, -1), diagonal=k)[off : off + rows]
        return DNDarray(result, gshape=(n, n), dtype=m.dtype, split=split, device=m.device, comm=comm)
    # this rank's rows (columns) start at the chunk's offset: shift the diagonal by it
    off = comm.chunk(m.gshape, m.split)[0]
    shift = off if m.split == m.ndim - 2 else -off if m.split == m.ndim - 1 else 0
    return DNDarray(op(m.larray, diagonal=k + shift), gshape=m.gshape, dtype=m.dtype, split=m.split,
                    device=m.device, comm=comm)


def tril(m: DNDarray, k: int = 0) -> DNDarray:
    """The lower triangle (on and below diagonal ``k``), zeros elsewhere."""
    return _tri_op(m, k, torch.tril)


def triu(m: DNDarray, k: int = 0) -> DNDarray:
    """The upper triangle (on and above diagonal ``k``), zeros elsewhere."""
    return _tri_op(m, k, torch.triu)


def _inexact_tensor(x: DNDarray) -> torch.Tensor:
    """This rank's chunk as a norm reads it: jnp.promote_types(any integer
    or bool, float32) is float32."""
    t = x.larray
    return t if t.is_floating_point() else t.to(torch.float32)


def _across(x: DNDarray, axes, t: torch.Tensor, op: str) -> torch.Tensor:
    """``t``, a partial result of this rank's chunk, completed over the ranks
    by one ``allreduce`` of ``op`` where ``axes`` reduce the split axis."""
    if x.split is not None and x.split in axes and x.comm.is_distributed():
        return x.comm.allreduce(t, op)
    return t


def _norm_result(x: DNDarray, result: torch.Tensor, axis, keepdims: bool) -> DNDarray:
    split = _reduced_split(x.split, axis, x.ndim, keepdims)
    gshape = _reduced_shape(x.gshape, axis, keepdims) if split is not None else None
    return DNDarray(result, gshape=gshape, split=split, device=x.device, comm=x.comm)


def matrix_norm(x: DNDarray, axis: Optional[Tuple[int, int]] = None, keepdims: bool = False, ord=None) -> DNDarray:
    """Matrix norm over the two axes ``axis`` (default (0, 1) of a 2-D
    array): ``"fro"`` (default), 1, -1, inf, -inf, 2, -2 or ``"nuc"``.
    Across ranks the Frobenius, 1 and inf norms reduce each rank's chunk
    and complete the reduction over the split axis with one ``allreduce``;
    the 2-norms and the nuclear norm take the singular values of the
    gathered matrices."""
    if axis is None:
        if x.ndim != 2:
            raise ValueError("axis must be given for arrays that are not 2-D")
        axis = (0, 1)
    axis = sanitize_axis(x.shape, axis)
    row, col = axis
    arr = _inexact_tensor(x)
    # after the inner sum drops an axis, the outer reduction's index shifts
    col_adj = col - 1 if (col > row and not keepdims) else col
    row_adj = row - 1 if (row > col and not keepdims) else row
    if ord is None or ord == "fro":
        result = torch.sqrt(_across(x, axis, torch.sum(arr.abs() ** 2, dim=axis, keepdim=keepdims), "sum"))
    elif ord in (1, -1, np.inf, -np.inf):
        inner, outer = (row, col_adj) if ord in (1, -1) else (col, row_adj)
        top = ord in (1, np.inf)
        sums = _across(x, (inner,), torch.sum(arr.abs(), dim=inner, keepdim=keepdims), "sum")
        if sums.shape[outer] == 0:  # an empty chunk: the identity of the outer extremum (norms are >= 0)
            shape = _reduced_shape(sums.shape, outer, keepdims)
            ext = torch.zeros(shape, dtype=sums.dtype, device=sums.device) if top else \
                torch.full(shape, float("inf"), dtype=sums.dtype, device=sums.device)
        else:
            ext = (torch.amax if top else torch.amin)(sums, dim=outer, keepdim=keepdims)
        result = _across(x, axis, ext, "max" if top else "min") if x.split != inner else ext
    elif ord in (2, -2, "nuc"):
        whole = _inexact_tensor(DNDarray(x._logical(), dtype=x.dtype, split=None, device=x.device, comm=x.comm))
        s = torch.linalg.svdvals(torch.movedim(whole, (row, col), (-2, -1)))
        result = s.amax(dim=-1) if ord == 2 else s.amin(dim=-1) if ord == -2 else s.sum(dim=-1)
        if keepdims:
            result = result.unsqueeze(min(row, col)).unsqueeze(max(row, col))
        if x.split not in (None, row, col) and x.comm.is_distributed():
            rs = _reduced_split(x.split, axis, x.ndim, keepdims)
            result = result[x.comm.chunk(tuple(result.shape), rs)[2]]
    else:
        raise ValueError(f"Invalid norm order {ord} for matrices")
    return _norm_result(x, result, axis, keepdims)


def vector_norm(x: DNDarray, axis=None, keepdims: bool = False, ord=None) -> DNDarray:
    """Vector norm of order ``ord`` (default 2) along ``axis``, or over the
    flattened array. Across ranks each rank reduces its chunk (a sum of
    powers, a maximum or a minimum) and one ``allreduce`` completes it over
    the split axis."""
    axis_s = sanitize_axis(x.shape, axis)
    arr = _inexact_tensor(x)
    dims = tuple(range(x.ndim)) if axis_s is None else (axis_s,) if isinstance(axis_s, int) else tuple(axis_s)
    p = 2 if ord is None else ord
    if not (x.split is not None and x.split in dims and x.comm.is_distributed()):
        flat = arr.reshape(-1) if axis_s is None else arr
        result = torch.linalg.vector_norm(flat, ord=p, dim=0 if axis_s is None else axis_s, keepdim=keepdims)
        return _norm_result(x, result, axis_s, keepdims)
    a = arr.abs()
    if p == np.inf:
        result = _across(x, dims, torch.amax(a, dim=dims, keepdim=keepdims) if a.numel() else
                         torch.zeros(_reduced_shape(arr.shape, dims, keepdims), dtype=a.dtype, device=a.device), "max")
    elif p == -np.inf:
        fill = torch.full(_reduced_shape(arr.shape, dims, keepdims), float("inf"), dtype=a.dtype, device=a.device)
        result = _across(x, dims, torch.amin(a, dim=dims, keepdim=keepdims) if a.numel() else fill, "min")
    elif p == 0:
        result = _across(x, dims, (a != 0).to(a.dtype).sum(dim=dims, keepdim=keepdims), "sum")
    else:
        result = _across(x, dims, (a ** p).sum(dim=dims, keepdim=keepdims), "sum") ** (1.0 / p)
    if axis_s is None:  # the flattened array's norm: () or, kept, (1,)
        result = result.reshape((1,) if keepdims else ())
    return _norm_result(x, result, axis_s, keepdims)


def norm(x: DNDarray, axis=None, keepdims: bool = False, ord=None) -> DNDarray:
    """Frobenius/2-norm of the whole array by default; a vector norm for an
    int ``axis`` (or 1-D input), a matrix norm for a pair (or 2-D input)."""
    if axis is None and ord is None:
        t = x.larray if x.larray.is_floating_point() else x.larray.to(torch.float32)
        squares = DNDarray(t.abs() ** 2, gshape=x.gshape, split=x.split, device=x.device, comm=x.comm)
        return DNDarray(torch.sqrt(arithmetics.sum(squares).larray), split=None, device=x.device, comm=x.comm)
    if axis is None:
        if x.ndim == 1:
            return vector_norm(x, axis=0, keepdims=keepdims, ord=ord)
        if x.ndim == 2:
            return matrix_norm(x, axis=(0, 1), keepdims=keepdims, ord=ord)
        raise ValueError("improper number of dimensions to norm")
    if isinstance(axis, (int, np.integer)):
        return vector_norm(x, axis=axis, keepdims=keepdims, ord=ord)
    if isinstance(axis, tuple) and len(axis) == 2:
        return matrix_norm(x, axis=axis, keepdims=keepdims, ord=ord)
    raise TypeError(f"axis must be an int or 2-tuple, got {axis}")
