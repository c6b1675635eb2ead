"""Ulysses attention: sequence parallelism by one all-to-all there and one
back (counterpart of ``heat_tpu/parallel/ulysses.py``).

The (N, H, D) inputs are split along the sequence. One ``comm.alltoall``
(q, k and v stacked in one message) turns every rank's (N/P, H, D) blocks
into (N, H/P, D) blocks: the whole sequence for H/P heads. Each rank runs
plain attention for its heads (the online-softmax fold of
:mod:`.ring_attention` over the whole sequence, so that no (N, N) matrix is
held), and a second ``alltoall`` brings the outputs back to sequence
blocks. Any N and H: a rank's block is its ceil-div chunk padded with zero
rows to ``ceil(N/P)``, the heads are padded with zero heads to a multiple
of P, padded keys are masked and padded heads computed and dropped, as in
``heat_tpu``'s pad-and-trim.

Differentiable: each ``alltoall`` is a ``torch.autograd.Function`` whose
backward is the transposed ``alltoall``, and the local attention is
:class:`.ring_attention._RingAttention` on one rank, so a backward pass
costs the two transposed ``alltoall``s.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.communication import SPLIT_AXIS, TorchCommunication, sanitize_comm
from ..core.dndarray import DNDarray
from .ring_attention import _RingAttention, _check, _pad_rows

__all__ = ["ulysses_attention"]


class _AllToAll(torch.autograd.Function):
    """``x`` cut along ``split_dim`` into ``comm.size`` blocks of
    ``send_sizes``, block j sent to rank j by one ``comm.alltoall``, and the
    blocks received (of ``recv_shapes``) concatenated along ``cat_dim`` in
    rank order. The backward sends each received block's gradient back to
    its sender."""

    @staticmethod
    def forward(ctx, x, comm, split_dim: int, cat_dim: int, send_sizes, recv_shapes):
        blocks = [b.contiguous() for b in torch.split(x, list(send_sizes), dim=split_dim)]
        got = comm.alltoall(blocks, [tuple(r) for r in recv_shapes])
        ctx.args = (comm, split_dim, cat_dim, [tuple(b.shape) for b in blocks], [r[cat_dim] for r in recv_shapes])
        return torch.cat(got, dim=cat_dim)

    @staticmethod
    def backward(ctx, grad):
        comm, split_dim, cat_dim, send_shapes, recv_sizes = ctx.args
        blocks = [b.contiguous() for b in torch.split(grad, recv_sizes, dim=cat_dim)]
        return torch.cat(comm.alltoall(blocks, send_shapes), dim=split_dim), None, None, None, None, None


def ulysses_attention(q: DNDarray, k: DNDarray, v: DNDarray, comm: Optional[TorchCommunication] = None,
                      causal: bool = False, axis_name: str = SPLIT_AXIS) -> DNDarray:
    """Exact attention of (N, H, D) DNDarrays split along the sequence axis
    0 (replicated inputs are split first); the result has ``q``'s shape,
    split along 0."""
    _check(q, k, v, "ulysses_attention")
    if q.ndim != 3:
        raise ValueError(f"expected (N, H, D) inputs, got {q.gshape}")
    comm = sanitize_comm(comm if comm is not None else q.comm)
    q, k, v = (t if t.split == 0 else t.resplit(0) for t in (q, k, v))
    n, h, d = q.gshape
    p = comm.size
    block, hp = -(-n // p), -(-h // p)
    rows = q.lshape[0]
    # (3, block, hp * p, D): this rank's rows of q, k and v, padded
    x = torch.stack([_pad_rows(_pad_rows(t.larray, 0, block), 1, hp * p) for t in (q, k, v)])
    # (3, block, hp * p, D) -> (3, block * p, hp, D): the whole sequence for this rank's hp heads
    x = _AllToAll.apply(x, comm, 2, 1, [hp] * p, [(3, block, hp, d)] * p)
    qh, kh, vh = x.movedim(2, 1).unbind(0)  # (hp, block * p, D)
    o = _RingAttention.apply(qh.contiguous(), kh.contiguous(), vh.contiguous(), None, n, causal,
                             causal or block * p != n, 1.0 / math.sqrt(float(d)))
    # (block * p, hp, D) -> (block, hp * p, D): this rank's rows for every head
    out = _AllToAll.apply(o.movedim(0, 1), comm, 0, 1, [block] * p, [(block, hp, d)] * p)
    out = out[:rows, :h]
    return DNDarray(out.contiguous(), gshape=q.gshape, dtype=q.dtype, split=0, device=q.device, comm=comm)
