"""Per-rank scans whose results are merged from candidates: ``unique``
and ``nonzero`` (counterpart of ``heat_tpu/parallel/dscan.py``).

- :func:`unique_merge`: each rank deduplicates its chunk, one ``allgather``
  brings only the candidates (at most a chunk each) to every rank, and a
  second deduplication gives the sorted table; NaN counts once.
- :func:`nonzero_scan`: each rank finds its chunk's coordinates; one
  ``allgather`` of P counts and an exclusive scan of them give every
  coordinate its slot in the result, and one ``alltoall`` sends each
  coordinate to the rank whose ceil-div chunk holds that slot.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["local_unique", "nonzero_scan", "unique_merge"]


def local_unique(t: torch.Tensor) -> torch.Tensor:
    """The sorted distinct values of ``t`` (flattened), one NaN at the end
    where there is any, as ``np.unique``/``jnp.unique`` count them."""
    u = torch.unique(t.reshape(-1), sorted=True)
    if u.is_floating_point() and u.numel():
        nan = torch.isnan(u)
        u = torch.cat([u[~nan], u[nan][:1]])
    return u


def unique_merge(local: torch.Tensor, comm) -> torch.Tensor:
    """The sorted distinct values of an array whose chunk on this rank is
    ``local``: local candidates, one ``allgather`` of them, a final dedup."""
    cands = local_unique(local)
    if comm.is_distributed():
        cands = local_unique(comm.allgather(cands, 0))
    return cands


def nonzero_scan(local: torch.Tensor, gshape, split: int, comm, ragged=None) -> Tuple[torch.Tensor, int]:
    """This rank's ceil-div chunk of the (count, ndim) coordinates of the
    nonzero elements of an array of ``gshape`` split along ``split``, in
    row-major order, and their count. ``ragged=(counts, displs)`` scans a
    ragged array in place: this rank's rows start at ``displs[rank]``."""
    from ..core.dndarray import _redistribute

    off = comm.chunk(gshape, split)[0] if ragged is None else int(ragged[1][comm.rank])
    coords = torch.nonzero(local)
    coords[:, split] += off
    if not comm.is_distributed():
        return coords, coords.shape[0]
    counts = comm.allgather(torch.tensor([coords.shape[0]], dtype=torch.int64, device=coords.device), 0,
                            [1] * comm.size).tolist()
    total = sum(counts)
    if split == 0:
        starts = [sum(counts[:q]) for q in range(comm.size)]
        return _redistribute(coords, 0, starts, counts, (total, len(gshape)), comm), total
    # along another axis the ranks' coordinates interleave in row-major order
    return _interleaved(coords, gshape, split, total, comm), total


def _interleaved(coords: torch.Tensor, gshape, split: int, total: int, comm) -> torch.Tensor:
    """The ranks' coordinates in row-major order, in the ceil-div layout.
    Along split axis s, row-major order runs over the outer index (the
    dimensions before s) first, and within one outer index through the
    ranks in order: so each rank counts its coordinates per outer index,
    one ``allgather`` of those counts (P·prod(gshape[:s]) ints) and their
    exclusive scans give every coordinate its slot, and one ``alltoall``
    sends it to the slot's owner."""
    dev = coords.device
    n_outer = 1
    outer = torch.zeros(coords.shape[0], dtype=torch.int64, device=dev)
    for d in range(split):
        outer = outer * gshape[d] + coords[:, d]
        n_outer *= int(gshape[d])
    hist = torch.bincount(outer, minlength=n_outer)
    every = comm.allgather(hist.unsqueeze(0), 0, [1] * comm.size)  # (P, n_outer)
    before_outer = torch.cumsum(every.sum(0), 0) - every.sum(0)      # all ranks, outer indices below
    before_rank = every[: comm.rank].sum(0)                          # ranks below, same outer index
    first_local = torch.cumsum(hist, 0) - hist                       # this rank, same outer index
    pos = torch.arange(coords.shape[0], device=dev)
    slot = before_outer[outer] + before_rank[outer] + pos - first_local[outer]
    out_counts, out_starts = comm.counts_displs_shape((total,), 0)[:2]
    bounds = torch.tensor(list(out_starts[1:]) + [total], device=dev)
    owner = torch.searchsorted(bounds, slot, right=True)
    send = torch.bincount(owner, minlength=comm.size).tolist()
    recv = torch.cat(comm.alltoall([torch.tensor([c], device=dev) for c in send], [(1,)] * comm.size)).tolist()
    nd = coords.shape[1]
    order = torch.argsort(owner, stable=True)
    got = comm.alltoall(list(torch.split(torch.cat([coords, slot[:, None]], 1)[order], send)),
                        [(c, nd + 1) for c in recv])
    mine = torch.cat(got)
    return mine[torch.argsort(mine[:, nd])][:, :nd]
