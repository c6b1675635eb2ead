"""K-Medoids clustering (counterpart of ``heat_tpu/cluster/kmedoids.py``).

An iteration of :class:`KMedians`, after which each cluster's median
snaps to its member with the smallest L1 distance to it (the first such
row on ties); a cluster without members keeps its centre, and the fit
stops when no centre moves. Across ranks the snap is one ``allreduce`` of
each cluster's best distance and one of the lowest global index that
reaches it; the owner of each chosen row broadcasts it.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..core.dndarray import DNDarray
from ._kcluster import _take_rows
from .kmedians import _MedianCluster, _l1_distances, cluster_medians

__all__ = ["KMedoids"]

_NO_ROW = torch.iinfo(torch.int64).max


def medoid_step(x: torch.Tensor, centers: torch.Tensor, comm=None, offset: int = 0, xd: Optional[DNDarray] = None):
    """One K-Medoids iteration: ``(new centres, labels, shift)``. ``offset``
    is this rank's first global row; ``xd`` the array whose rows are
    broadcast by their owners across ranks."""
    k = centers.shape[0]
    labels = torch.argmin(_l1_distances(x, centers), dim=1)
    med = cluster_medians(x, labels, k, comm)
    med = torch.where(torch.isnan(med), centers, med)
    member = labels.unsqueeze(1) == torch.arange(k, device=x.device).unsqueeze(0)
    d = torch.where(member, _l1_distances(x, med), torch.full((), float("inf"), dtype=x.dtype, device=x.device))
    if x.shape[0]:
        best, at = torch.min(d, dim=0)
    else:
        best = torch.full((k,), float("inf"), dtype=x.dtype, device=x.device)
        at = torch.zeros(k, dtype=torch.int64, device=x.device)
    has = member.any(dim=0)
    if comm is not None:
        gbest = comm.allreduce(best, "min")
        cand = torch.where(has & (best == gbest), at + offset, torch.full_like(at, _NO_ROW))
        idx = comm.allreduce(cand, "min")
        has = idx != _NO_ROW
        rows = _take_rows(xd, torch.where(has, idx, torch.zeros_like(idx))).to(x.dtype)
    else:
        rows = x[at] if x.shape[0] else centers
    new = torch.where(has.unsqueeze(1), rows, centers)
    return new, labels, torch.sum((new - centers) ** 2)


class KMedoids(_MedianCluster):
    """K-Medoids: K-Medians whose centres snap to the nearest member row.

    Parameters
    ----------
    n_clusters, init, max_iter, random_state : as :class:`KMedians`; the
    fit runs until no centre moves or ``max_iter`` iterations ran.
    """

    def __init__(self, n_clusters: int = 8, init: Union[str, DNDarray] = "random", max_iter: int = 300,
                 random_state: Optional[int] = None):
        super().__init__(metric=_l1_distances, n_clusters=n_clusters, init=init, max_iter=max_iter, tol=0.0,
                         random_state=random_state)

    def _step(self, xa, centers, comm, x):
        off = x.comm.chunk(x.gshape, 0)[0] if comm is not None else 0
        return medoid_step(xa, centers, comm, off, x)
