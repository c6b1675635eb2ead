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
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.communication import SPLIT_AXIS, TorchCommunication, sanitize_comm
from ..core.dndarray import DNDarray
from ..core.linalg.qr import _full_float32_products
from .ring_attention import _check, _finish, _fold, _init_state, _pad_rows

__all__ = ["ulysses_attention"]


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
    heads = comm.alltoall([x[:, :, j * hp : (j + 1) * hp] for j in range(p)], [(3, block, hp, d)] * p)
    qh, kh, vh = torch.cat(heads, dim=1).movedim(2, 1).unbind(0)  # (hp, block * p, D): the whole sequence
    pos = torch.arange(block * p, device=qh.device)
    with _full_float32_products():
        state = _fold(_init_state(qh, d), qh, kh, vh, pos, pos, n, causal, causal or block * p != n,
                      1.0 / math.sqrt(float(d)))
        o = _finish(state).movedim(0, 1)  # (block * p, hp, D)
    back = comm.alltoall([o[j * block : (j + 1) * block] for j in range(p)], [(block, hp, d)] * p)
    out = torch.cat(back, dim=1)[:rows, :h]
    return DNDarray(out.contiguous(), gshape=q.gshape, dtype=q.dtype, split=0, device=q.device, comm=comm)
