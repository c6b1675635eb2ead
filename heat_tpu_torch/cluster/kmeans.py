"""K-Means clustering (counterpart of ``heat_tpu/cluster/kmeans.py``).

One Lloyd iteration is one call of the assignment statistics on every
rank's chunk — the ``lloyd_fused`` kernel on a card
(:func:`kernels.lloyd_sharded` over :func:`kernels.lloyd_local`), its
plain version on the CPU — and one ``allreduce`` of the summed statistics,
followed by the centroid update, in which an empty cluster keeps its old
centre. Every rank updates the same centres from the same allreduced
values, so the stop test agrees on every rank. ``heat_tpu`` runs the whole
fit as one ``lax.while_loop`` program; here a Python loop drives the
launches.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..core.dndarray import DNDarray
from ..core.kernels import LLOYD_KERNEL, dispatch_mode, lloyd_sharded, record_dispatch
from ..spatial.distance import _quadratic_expand
from ._kcluster import _KCluster

__all__ = ["KMeans"]


def _lloyd_body(xa: torch.Tensor, centers: torch.Tensor, comm, mode: str):
    """One Lloyd iteration: assign, then move each non-empty cluster's
    centre to its members' mean. Returns ``(centers, labels, shift)``."""
    sums, counts, labels, _ = lloyd_sharded(xa, centers, comm, mode)
    new_centers = torch.where(
        counts.unsqueeze(1) > 0, sums / torch.clamp(counts, min=1.0).unsqueeze(1), centers
    ).to(centers.dtype)
    shift = torch.sum((new_centers - centers) ** 2)
    return new_centers, labels, shift


class KMeans(_KCluster):
    """K-Means with Lloyd's algorithm.

    Parameters
    ----------
    n_clusters : int
        Number of clusters k.
    init : 'random' | 'probability_based' | DNDarray
        Initial centroids: k distinct random rows, k-means++ D² sampling, or
        an explicit (k, f) array.
    max_iter : int
        Upper bound on the Lloyd iterations.
    tol : float or None
        Stop once the squared centroid shift of an iteration is ``<= tol``.
        ``None`` runs exactly ``max_iter`` iterations.
    random_state : int, optional
        Seed for the initialization draws.
    """

    def __init__(
        self,
        n_clusters: int = 8,
        init: Union[str, DNDarray] = "random",
        max_iter: int = 300,
        tol: Optional[float] = 1e-4,
        random_state: Optional[int] = None,
    ):
        super().__init__(
            metric=_quadratic_expand,
            n_clusters=n_clusters,
            init=init,
            max_iter=max_iter,
            tol=tol,
            random_state=random_state,
        )

    def _fit_view(self, x: DNDarray):
        x, xa, _ = super()._fit_view(x)
        # the statistics go through the group's allreduce at any group size, one rank's too: one allreduce a
        # Lloyd step on every group (lloyd_sharded sums nothing when no process group is started)
        return x, xa, x.comm if x.split == 0 else None

    def _begin_block(self, x: DNDarray, xa: torch.Tensor):
        mode = dispatch_mode(LLOYD_KERNEL, xa)
        record_dispatch(LLOYD_KERNEL, mode)  # once per run of iterations: the fit, or a supervised step
        return mode

    def _iteration(self, xa, centers, comm, x, mode):
        return _lloyd_body(xa, centers, comm, mode)

    def _finalize(self, x: DNDarray, xa: torch.Tensor, comm) -> None:
        centers = self._cluster_centers.larray.to(device=xa.device, dtype=xa.dtype)
        _, _, _, inertia = lloyd_sharded(xa, centers, comm, dispatch_mode(LLOYD_KERNEL, xa))
        self._inertia = float(inertia)

    def fit(self, x: DNDarray, supervisor=None, block_iters: int = 16) -> "KMeans":
        """Lloyd iterations until the centroid shift drops to ``tol`` or
        ``max_iter`` iterations ran.

        With ``supervisor`` (a :class:`~heat_tpu_torch.resilience.Supervisor`)
        the fit runs as a self-healing supervised step loop, one step being
        up to ``block_iters`` iterations (``lloyd_fused`` launches), with one
        host read of the shift per step (``_KCluster._fit``).

        With ``tol=None`` the loop never waits for the device: it enqueues
        ``max_iter`` iterations back to back. With a ``tol`` it reads the
        shift back once per iteration to decide whether to stop.
        ``inertia_`` comes from one more assignment pass with the final
        centers (one more kernel launch on a card), as ``heat_tpu``
        computes it in a separate pass; ``labels_`` are those of the last
        iteration, as in ``heat_tpu``."""
        if not isinstance(x, DNDarray):
            raise TypeError(f"input needs to be a DNDarray, but was {type(x)}")
        if x.ndim != 2:
            raise ValueError(f"input needs to be 2D, but was {x.ndim}D")
        if self.max_iter < 1:
            raise ValueError(f"max_iter must be >= 1, got {self.max_iter}")
        return self._fit(x, supervisor, block_iters, "kmeans.fit")
