"""K-Means clustering (counterpart of ``heat_tpu/cluster/kmeans.py``).

One Lloyd iteration is one call of the assignment statistics — the
``lloyd_fused`` kernel on a card (:func:`kernels.lloyd_local`), its plain
version on the CPU — followed by the centroid update, in which an empty
cluster keeps its old centre. ``heat_tpu`` runs the whole fit as one
``lax.while_loop`` program; here a Python loop drives the launches.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..core import types
from ..core.dndarray import DNDarray
from ..core.kernels import LLOYD_KERNEL, assign_stats, dispatch_mode, lloyd_local, record_dispatch
from ..spatial.distance import _quadratic_expand
from ._kcluster import _KCluster

__all__ = ["KMeans"]


def _assign_stats_dispatch(xa: torch.Tensor, centers: torch.Tensor, n_valid: int, mode: str):
    """``(sums, counts, labels, inertia)`` through the mode chosen at the
    call boundary: the kernel wrapper for ``"cuda"``, the plain version
    (in the data's own float type) for ``"torch"``."""
    if mode == "cuda":
        return lloyd_local(xa, centers, n_valid)
    return assign_stats(xa, centers, n_valid)


def _lloyd_body(xa: torch.Tensor, centers: torch.Tensor, n_valid: int, mode: str):
    """One Lloyd iteration: assign, then move each non-empty cluster's
    centre to its members' mean. Returns ``(centers, labels, shift)``."""
    sums, counts, labels, _ = _assign_stats_dispatch(xa, centers, n_valid, mode)
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

    def fit(self, x: DNDarray) -> "KMeans":
        """Lloyd iterations until the centroid shift drops to ``tol`` or
        ``max_iter`` iterations ran.

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
        xa = x.larray
        if xa.dtype not in (torch.float32, torch.float64):
            xa = xa.to(torch.float32)
        n = x.gshape[0]
        centers = self._initialize_cluster_centers(x).to(xa.dtype)
        mode = dispatch_mode(LLOYD_KERNEL, xa)
        record_dispatch(LLOYD_KERNEL, mode)  # call boundary: once per fit

        labels = None
        n_iter = 0
        while n_iter < self.max_iter:
            centers, labels, shift = _lloyd_body(xa, centers, n, mode)
            n_iter += 1
            # the one host sync per iteration, only when a tol is set
            if self.tol is not None and float(shift) <= float(self.tol):
                break

        _, _, _, inertia = _assign_stats_dispatch(xa, centers, n, mode)
        self._cluster_centers = DNDarray(centers, split=None, device=x.device, comm=x.comm)
        self._labels = DNDarray(labels.to(torch.int64), dtype=types.int64, split=x.split, device=x.device, comm=x.comm)
        self._inertia = float(inertia)
        self._n_iter = n_iter
        return self
