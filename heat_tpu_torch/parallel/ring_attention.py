"""Ring attention: exact attention with the sequence axis split over the
ranks (counterpart of ``heat_tpu/parallel/ring_attention.py``).

Each rank keeps its block of queries; the K and V blocks rotate around the
ring (``comm.ring_shift`` each, P - 1 times: 2(P - 1) rotations a call)
and every block that arrives is folded into the online-softmax state
(m, l, o) with ``heat_tpu``'s masking: masked scores are ``-inf``, a row
with nothing unmasked yet keeps a zero state (the fully-masked-row guard),
and key positions at or past ``kv_len`` (the padding of a sequence the
ranks do not divide) are masked. A rank's blocks are its ceil-div chunk
padded with zeros to ``ceil(N/P)`` rows, so the pad and the trim are local.
Within a step the keys are folded in slices, so that a score tile stays
under ``_TILE_ELEMS`` elements whatever N is.

The products run in full float32 (no TF32), as everywhere in the port.

The gradients (:class:`_RingAttention`, a ``torch.autograd.Function``)
follow the same schedule: the forward keeps each query row's
log-sum-exp, and the backward rotates K and V around the ring again (one
message of both a step), recomputes each block's probabilities from the
log-sum-exp, accumulates dQ locally, and sends each block's dK/dV
contribution straight to the block's owner (``ring_shift`` by −i at step
i): 2(P − 1) ``ring_shift``s a backward pass.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.communication import SPLIT_AXIS, TorchCommunication, sanitize_comm
from ..core.dndarray import DNDarray
from ..core.linalg.qr import _full_float32_products

__all__ = ["attention", "ring_attention"]

_TILE_ELEMS = 1 << 28  # scores of one fold step (1 GiB of float32)


def attention(q, k, v, causal: bool = False, kv_len: Optional[int] = None):
    """Dense scaled-dot-product attention over (..., N, D) inputs, the
    oracle of :func:`ring_attention`: the whole (N, M) score matrix, masked
    (``causal``; key positions >= ``kv_len``) with ``-inf`` before the
    softmax. Tensors give a tensor; DNDarrays are gathered and give a
    replicated DNDarray."""
    if isinstance(q, DNDarray):
        out = attention(q._logical(), k._logical(), v._logical(), causal=causal, kv_len=kv_len)
        return DNDarray(out, dtype=q.dtype, split=None, device=q.device, comm=q.comm)
    d = q.shape[-1]
    with _full_float32_products():
        s = torch.einsum("...nd,...md->...nm", q, k) / math.sqrt(float(d))
        n, m = s.shape[-2], s.shape[-1]
        mask = torch.ones((n, m), dtype=torch.bool, device=s.device)
        if causal:
            mask = torch.tril(mask)
        if kv_len is not None and kv_len < m:
            mask = mask & (torch.arange(m, device=s.device)[None, :] < kv_len)
        if causal or (kv_len is not None and kv_len < m):
            s = torch.where(mask, s, torch.tensor(float("-inf"), dtype=s.dtype, device=s.device))
        p = torch.softmax(s, dim=-1)
        return torch.einsum("...nm,...md->...nd", p, v)


def _fold(state, qb, kb, vb, q_pos, k_pos, valid_n: int, causal: bool, masked: bool, scale: float):
    """Fold the keys ``kb``/``vb`` (global positions ``k_pos``) into the
    online-softmax state ``(m, l, o)`` of the queries ``qb`` (``q_pos``),
    in slices of keys that keep a score tile under ``_TILE_ELEMS``."""
    m, l, o = state
    lead = math.prod(qb.shape[:-1])
    step = max(1, min(kb.shape[-2], _TILE_ELEMS // max(1, lead)))
    zero = torch.zeros((), dtype=qb.dtype, device=qb.device)
    for a in range(0, kb.shape[-2], step):
        kc, vc, pc = kb[..., a : a + step, :], vb[..., a : a + step, :], k_pos[a : a + step]
        s = torch.matmul(qb, kc.transpose(-1, -2)) * scale
        if masked:
            s = _mask(s, q_pos, pc, valid_n, causal)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, zero)  # rows with every key masked so far
        pexp = torch.where(torch.isfinite(s), torch.exp(s - m_safe[..., None]), zero)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), zero)
        l = l * alpha + pexp.sum(dim=-1)
        o = o * alpha[..., None] + torch.matmul(pexp, vc)
        m = m_new
    return m, l, o


def _init_state(qb: torch.Tensor, d_v: int):
    shape = tuple(qb.shape[:-1])
    return (torch.full(shape, float("-inf"), dtype=qb.dtype, device=qb.device),
            torch.zeros(shape, dtype=qb.dtype, device=qb.device),
            torch.zeros(shape + (d_v,), dtype=qb.dtype, device=qb.device))


def _finish(state) -> torch.Tensor:
    _, l, o = state
    return o / torch.clamp(l, min=1e-30)[..., None]


def _pad_rows(t: torch.Tensor, axis: int, rows: int) -> torch.Tensor:
    """``t`` with zero rows appended along ``axis`` up to ``rows``."""
    if t.shape[axis] >= rows:
        return t
    shape = list(t.shape)
    shape[axis] = rows - t.shape[axis]
    return torch.cat([t, t.new_zeros(shape)], dim=axis)


def _check(q, k, v, what: str):
    if not all(isinstance(t, DNDarray) for t in (q, k, v)):
        raise TypeError(f"{what} takes DNDarrays")
    if q.gshape != k.gshape or q.gshape != v.gshape:
        raise ValueError(f"q/k/v shapes differ: {q.gshape}, {k.gshape}, {v.gshape}")


def _mask(s, q_pos, pc, valid_n: int, causal: bool):
    keep = pc[None, :] < valid_n
    if causal:
        keep = keep & (q_pos[:, None] >= pc[None, :])
    return torch.where(keep, s, torch.tensor(float("-inf"), dtype=s.dtype, device=s.device))


def _ring_forward(qb, kb, vb, comm, n: int, causal: bool, masked: bool, scale: float):
    """(output, log-sum-exp) of this rank's query block against every
    rank's K/V block as they rotate (``comm`` None: the local blocks are
    the whole sequence)."""
    p, me = (comm.size, comm.rank) if comm is not None else (1, 0)
    block = qb.shape[-2]
    q_pos = me * block + torch.arange(block, device=qb.device)
    state = _init_state(qb, vb.shape[-1])
    for i in range(p):
        src = (me + i) % p  # the owner of the K/V block held now
        k_pos = src * block + torch.arange(block, device=qb.device)
        state = _fold(state, qb, kb, vb, q_pos, k_pos, n, causal, masked, scale)
        if i < p - 1:
            kb, vb = comm.ring_shift(kb), comm.ring_shift(vb)
    m, l, _ = state
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)), torch.full_like(m, float("-inf")))
    return _finish(state), lse


def _block_grads(qb, kc, vc, dout, lse, dsum, q_pos, pc, n: int, causal: bool, masked: bool, scale: float):
    """(dQ, dK, dV) of one slice of keys, recomputed from the log-sum-exp."""
    s = torch.matmul(qb, kc.transpose(-1, -2)) * scale
    if masked:
        s = _mask(s, q_pos, pc, n, causal)
    zero = torch.zeros((), dtype=qb.dtype, device=qb.device)
    pr = torch.where(torch.isfinite(s) & torch.isfinite(lse)[..., None], torch.exp(s - lse[..., None]), zero)
    dv = torch.matmul(pr.transpose(-1, -2), dout)
    ds = pr * (torch.matmul(dout, vc.transpose(-1, -2)) - dsum[..., None])
    return torch.matmul(ds, kc) * scale, torch.matmul(ds.transpose(-1, -2), qb) * scale, dv


class _RingAttention(torch.autograd.Function):
    """Ring attention of this rank's (..., block, D) query, key and value
    blocks, with its backward pass (see the module's docstring)."""

    @staticmethod
    def forward(ctx, qb, kb, vb, comm, n: int, causal: bool, masked: bool, scale: float):
        with _full_float32_products():
            out, lse = _ring_forward(qb, kb, vb, comm, n, causal, masked, scale)
        ctx.save_for_backward(qb, kb, vb, out, lse)
        ctx.args = (comm, n, causal, masked, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        qb, kb, vb, out, lse = ctx.saved_tensors
        comm, n, causal, masked, scale = ctx.args
        p, me = (comm.size, comm.rank) if comm is not None else (1, 0)
        block = qb.shape[-2]
        dout = dout.contiguous()
        q_pos = me * block + torch.arange(block, device=qb.device)
        lead = math.prod(qb.shape[:-1])
        step = max(1, min(block, _TILE_ELEMS // max(1, lead)))
        with _full_float32_products():
            dsum = (dout * out).sum(-1)
            dq, dk_own, dv_own = torch.zeros_like(qb), torch.zeros_like(kb), torch.zeros_like(vb)
            kv = torch.stack([kb, vb])
            kc_all, vc_all = kb, vb
            for i in range(p):
                src = (me + i) % p
                k_pos = src * block + torch.arange(block, device=qb.device)
                dk, dv = torch.zeros_like(kb), torch.zeros_like(vb)
                for a in range(0, block, step):
                    sl = slice(a, a + step)
                    gq, gk, gv = _block_grads(qb, kc_all[..., sl, :], vc_all[..., sl, :], dout, lse, dsum, q_pos,
                                              k_pos[sl], n, causal, masked, scale)
                    dq += gq
                    dk[..., sl, :] += gk
                    dv[..., sl, :] += gv
                if i == 0:
                    dk_own += dk
                    dv_own += dv
                else:  # block src's share goes home: rank r sends to r + i and gets its own block's from r - i
                    got = comm.ring_shift(torch.stack([dk, dv]), -i)
                    dk_own += got[0]
                    dv_own += got[1]
                if i < p - 1:
                    kv = comm.ring_shift(kv)
                    kc_all, vc_all = kv[0], kv[1]
        return dq, dk_own, dv_own, None, None, None, None, None


def ring_attention(q: DNDarray, k: DNDarray, v: DNDarray, comm: Optional[TorchCommunication] = None,
                   causal: bool = False, axis_name: str = SPLIT_AXIS) -> DNDarray:
    """Exact attention of (..., N, D) DNDarrays split along the sequence
    axis (the second to last; leading axes are heads or batches), any N:
    each rank's query block against every K/V block as they rotate; the
    result has ``q``'s shape and split. Replicated inputs compute locally.
    Differentiable: gradients flow to the inputs' local tensors."""
    _check(q, k, v, "ring_attention")
    if q.ndim < 2:
        raise ValueError(f"expected (..., N, D) inputs, got {q.gshape}")
    comm = sanitize_comm(comm if comm is not None else q.comm)
    seq = q.ndim - 2
    n, d = q.gshape[seq], q.gshape[-1]
    scale = 1.0 / math.sqrt(float(d))
    if q.split is None or not comm.is_distributed():
        out = _RingAttention.apply(q._logical(), k._logical(), v._logical(), None, n, causal, causal, scale)
        return DNDarray(out, gshape=q.gshape, dtype=q.dtype, split=q.split, device=q.device, comm=comm)
    if q.split != seq or k.split != seq or v.split != seq:
        raise ValueError(f"ring_attention shards the sequence axis {seq}; got splits {q.split}, {k.split}, {v.split}")
    p = comm.size
    block = -(-n // p)
    qb, kb, vb = (_pad_rows(t.larray, seq, block) for t in (q, k, v))
    out = _RingAttention.apply(qb, kb, vb, comm, n, causal, causal or block * p != n, scale)
    out = out.narrow(seq, 0, q.lshape[seq])
    return DNDarray(out, gshape=q.gshape, dtype=q.dtype, split=seq, device=q.device, comm=comm)
