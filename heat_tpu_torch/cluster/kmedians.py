"""K-Medians clustering (counterpart of ``heat_tpu/cluster/kmedians.py``).

One iteration assigns every row to its nearest centre by L1 distance and
moves each centre to the per-feature median of its members:
``jnp.nanmedian``'s midpoint of the two middle values, in the data's
dtype; a cluster without members keeps its centre. ``heat_tpu`` builds an
(n, k, f) buffer with the non-members masked to NaN; the port never does:
the k·f medians are exact order statistics of the segments (cluster,
feature), found by :mod:`heat_tpu_torch.parallel.dselect`: each rank
sorts its rows' keys by cluster, and across ranks one ``allreduce`` of
(2, k, f) counts per key bit bisects the key space, so only O(k·f)
counts travel, never the rows.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..core.dndarray import DNDarray
from ..parallel.dselect import select_values
from ._kcluster import _KCluster

__all__ = ["KMedians"]

def _l1_distances(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(n, k) L1 distances, added feature by feature in order: the same
    bits for a row whatever the number of rows (so on every rank as in one
    process), and no (n, k, f) temporary."""
    d = torch.zeros((x.shape[0], c.shape[0]), dtype=torch.promote_types(x.dtype, c.dtype), device=x.device)
    for j in range(x.shape[1]):
        d += torch.abs(x[:, j : j + 1] - c[:, j])
    return d


def _member_counts(x: torch.Tensor, labels: torch.Tensor, k: int, comm) -> torch.Tensor:
    """(k, f) int64: the members of each cluster that are not NaN in each
    feature, over every rank."""
    cnt = torch.zeros((k, x.shape[1]), dtype=torch.int64, device=x.device)
    cnt.index_add_(0, labels, (~torch.isnan(x)).to(torch.int64))
    return comm.allreduce(cnt) if comm is not None else cnt


def cluster_medians(x: torch.Tensor, labels: torch.Tensor, k: int, comm=None) -> torch.Tensor:
    """(k, f): each cluster's per-feature ``nanmedian`` of its member rows
    (``labels`` in ``[0, k)``), NaN where a cluster has no member that is a
    number. ``comm`` adds up the rows of every rank (None: this rank's)."""
    cnt = _member_counts(x, labels, k, comm)
    # jnp.nanquantile(q=0.5, 'midpoint'): positions q·(count - 1) in the data's float type
    pos = torch.tensor(0.5, dtype=x.dtype, device=x.device) * (cnt.to(x.dtype) - 1)
    top = torch.clamp(cnt - 1, min=0)
    lo = torch.minimum(torch.clamp(torch.floor(pos), min=0).to(torch.int64), top)
    hi = torch.minimum(torch.clamp(torch.ceil(pos), min=0).to(torch.int64), top)
    v = select_values(x, torch.stack([lo, hi]), seg=labels, comm=comm)
    med = (v[0] + v[1]) * 0.5
    return torch.where(cnt == 0, torch.full_like(med, float("nan")), med)


def median_step(x: torch.Tensor, centers: torch.Tensor, comm=None):
    """One K-Medians iteration: ``(new centres, labels, shift)``."""
    k = centers.shape[0]
    labels = torch.argmin(_l1_distances(x, centers), dim=1)
    med = cluster_medians(x, labels, k, comm)
    new = torch.where(torch.isnan(med), centers, med)
    return new, labels, torch.sum((new - centers) ** 2)


class _MedianCluster(_KCluster):
    """The fit loop the median-based estimators share: ``heat_tpu``'s
    ``_whole_fit`` (iterate while ``i < max_iter`` and the squared centre
    shift exceeds ``tol``; the labels of the last iteration)."""

    def _step(self, xa, centers, comm, x):
        raise NotImplementedError()

    def _iteration(self, xa, centers, comm, x, ctx):
        return self._step(xa, centers, comm, x)

    def fit(self, x: DNDarray, supervisor=None, block_iters: int = 16):
        """Iterate until the squared centre shift is ``<= tol`` or
        ``max_iter`` iterations ran. With ``supervisor`` the fit runs as a
        self-healing supervised step loop of up to ``block_iters``
        iterations a step (``_KCluster._fit``)."""
        if not isinstance(x, DNDarray):
            raise TypeError(f"input needs to be a DNDarray, but was {type(x)}")
        if self.max_iter < 1:
            raise ValueError(f"max_iter must be >= 1, got {self.max_iter}")
        return self._fit(x, supervisor, block_iters, f"{type(self).__name__.lower()}.fit")


class KMedians(_MedianCluster):
    """K-Medians: L1 assignment and per-feature median centres.

    Parameters
    ----------
    n_clusters : int
        Number of clusters k.
    init : 'random' | 'probability_based' | DNDarray
        Initial centroids, as :class:`KMeans` draws them.
    max_iter : int
        Upper bound on the iterations.
    tol : float or None
        Stop once the squared centre shift of an iteration is ``<= tol``;
        None runs ``max_iter`` iterations.
    random_state : int, optional
        Seed for the initialization draws.
    """

    def __init__(self, n_clusters: int = 8, init: Union[str, DNDarray] = "random", max_iter: int = 300,
                 tol: Optional[float] = 1e-4, random_state: Optional[int] = None):
        super().__init__(metric=_l1_distances, n_clusters=n_clusters, init=init, max_iter=max_iter, tol=tol,
                         random_state=random_state)

    def _step(self, xa, centers, comm, x):
        return median_step(xa, centers, comm)
