"""Sort along the split axis without gathering (counterpart of
``heat_tpu/parallel/dsort.py``).

The order is ``heat_tpu``'s (``jnp.sort``'s): ascending puts NaN last,
descending puts NaN first and then decreasing values; integers descend by
their bitwise negation; ``-0.0`` equals ``+0.0``; and the element's global
index is the final key, so equal values keep their original order. The
indices returned are int64 global positions, and both results are in the
canonical ceil-div layout.

``heat_tpu`` runs block odd-even transposition, an XLA idiom for static
shapes. Over ``torch.distributed`` the reference Heat's sample sort fits
better (:func:`sample_sort`):

1. each rank sorts its chunk by (key, global index) — a stable sort of the
   keys of :func:`._keys.order_keys`;
2. each rank contributes P - 1 regular samples of its sorted (key, index)
   pairs; one ``allgather`` brings the P·(P - 1) samples to every rank,
   which pick the same P - 1 splitters;
3. one ``alltoall`` of the bucket sizes, then one of the values and one
   of the indices, send every pair to the rank of its bucket;
4. each rank merges the sorted runs it received (rank order keeps the
   index order of equal keys) with one stable sort;
5. one ``alltoall`` of values and one of indices move the sorted sequence
   into the ceil-div layout.

Each rank receives about its share of values and indices twice (steps 3
and 5): at most 2·(1 + P/n_r) times it with the splitters of regular
samples, never the whole array.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ._keys import order_keys

__all__ = ["distributed_sort", "local_sort", "sample_sort"]


def local_sort(t: torch.Tensor, axis: int, descending: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of ``t`` sorted along ``axis`` in
    ``heat_tpu``'s order (indices local, int64)."""
    _, idx = torch.sort(order_keys(t, descending), dim=axis, stable=True)
    return torch.take_along_dim(t, idx, dim=axis), idx


def _lex_gt(key: torch.Tensor, gidx: torch.Tensor, sk: torch.Tensor, sg: torch.Tensor) -> torch.Tensor:
    """``(len(sk), n)``: whether (key, gidx) comes after each splitter (sk, sg)."""
    k, g = key.unsqueeze(0), gidx.unsqueeze(0)
    sk, sg = sk.unsqueeze(1), sg.unsqueeze(1)
    return (k > sk) | ((k == sk) & (g > sg))


def sample_sort(local: torch.Tensor, n: int, comm, descending: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's ceil-div chunks of the sorted values and of their int64
    global indices, for a 1-D array of ``n`` elements whose ceil-div chunk
    on this rank is ``local``."""
    from ..core.dndarray import _redistribute

    p, me = comm.size, comm.rank
    dev = local.device
    off = comm.chunk((n,), 0)[0]
    key = order_keys(local, descending)
    skey, perm = torch.sort(key, stable=True)
    vals = local[perm]
    gidx = perm + off
    if p == 1:
        return vals, gidx
    # 2. regular samples -> splitters, the same on every rank
    n_loc = skey.numel()
    pos = (torch.arange(1, p, device=dev) * n_loc) // p
    valid = torch.full((p - 1,), 1 if n_loc else 0, dtype=torch.int64, device=dev)
    pos = pos.clamp(max=max(n_loc - 1, 0))
    samp = torch.stack([skey[pos] if n_loc else torch.zeros(p - 1, dtype=torch.int64, device=dev),
                        gidx[pos] if n_loc else torch.zeros(p - 1, dtype=torch.int64, device=dev), valid], dim=1)
    samples = comm.allgather(samp, 0, [p - 1] * p)
    samples = samples[samples[:, 2] == 1]
    order = torch.sort(samples[:, 1], stable=True)[1]
    samples = samples[order][torch.sort(samples[order][:, 0], stable=True)[1]]
    s_n = samples.shape[0]
    if s_n:
        at = torch.tensor([min(s_n - 1, (i * s_n) // p) for i in range(1, p)], device=dev)
        sk, sg = samples[at, 0], samples[at, 1]
        bucket = _lex_gt(skey, gidx, sk, sg).sum(dim=0)
    else:
        bucket = torch.zeros(n_loc, dtype=torch.int64, device=dev)
    # 3. bucket sizes, then the pairs
    send = torch.bincount(bucket, minlength=p)
    recv = torch.cat(comm.alltoall([send[q : q + 1] for q in range(p)], [(1,)] * p))
    send_l, recv_l = send.tolist(), recv.tolist()
    vparts = comm.alltoall(list(torch.split(vals, send_l)), [(c,) for c in recv_l])
    iparts = comm.alltoall(list(torch.split(gidx, send_l)), [(c,) for c in recv_l])
    # 4. merge the runs (received in rank order: equal keys stay in index order)
    mv, mi = torch.cat(vparts), torch.cat(iparts)
    order = torch.sort(order_keys(mv, descending), stable=True)[1]
    mv, mi = mv[order], mi[order]
    # 5. into the ceil-div layout
    counts = comm.allgather(torch.tensor([mv.numel()], dtype=torch.int64, device=dev), 0, [1] * p).tolist()
    starts = [sum(counts[:q]) for q in range(p)]
    return (_redistribute(mv, 0, starts, counts, (n,), comm), _redistribute(mi, 0, starts, counts, (n,), comm))


def distributed_sort(local: torch.Tensor, gshape, axis: int, comm, descending: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's ceil-div chunks of the values and int64 global indices
    of an array of ``gshape`` split along ``axis`` (``local`` its chunk),
    sorted along ``axis``. A 1-D array takes :func:`sample_sort`; along
    the split axis of a wider array every line sorts independently, so the
    array is resplit along another axis (one ``alltoall``), sorted
    locally, and resplit back (one ``alltoall`` each for values and
    indices): each rank receives about its share three times."""
    from ..core.dndarray import DNDarray

    if len(gshape) == 1:
        return sample_sort(local, int(gshape[0]), comm, descending)
    other = max((d for d in range(len(gshape)) if d != axis), key=lambda d: gshape[d])
    meta = dict(gshape=tuple(gshape), device=None, comm=comm)
    moved = DNDarray(local, split=axis, **meta).resplit_(other)
    vals, idx = local_sort(moved.larray, axis, descending)
    vals = DNDarray(vals, split=other, **meta).resplit_(axis).larray
    idx = DNDarray(idx, split=other, **meta).resplit_(axis).larray
    return vals, idx
