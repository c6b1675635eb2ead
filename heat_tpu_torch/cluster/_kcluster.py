"""Shared k-clustering machinery (counterpart of ``heat_tpu/cluster/_kcluster.py``).

Initial centroids come from the port's explicit ``torch.Generator``
(:func:`heat_tpu_torch.core.random.get_generator`): ``'random'`` samples k
distinct rows, ``'probability_based'`` (k-means++) draws each next centroid
with probability proportional to D². Neither reproduces ``heat_tpu``'s
threefry draws; an explicit ``DNDarray`` init gives both packages the same
start.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core import random as ht_random
from ..core import types
from ..core.base import BaseEstimator, ClusteringMixin
from ..core.dndarray import DNDarray

__all__ = ["_KCluster"]


class _KCluster(BaseEstimator, ClusteringMixin):
    """Base class of the k-clustering estimators.

    Parameters
    ----------
    metric : callable
        Tile metric used for assignment, (n, f) x (k, f) -> (n, k).
    n_clusters, init, max_iter, tol, random_state : see :class:`KMeans`.
    """

    def __init__(self, metric: Callable, n_clusters: int, init, max_iter: int, tol, random_state: Optional[int]):
        self.n_clusters = n_clusters
        self.init = init
        self.max_iter = max_iter
        self.tol = tol
        self.random_state = random_state

        self._metric = metric
        self._cluster_centers = None
        self._labels = None
        self._inertia = None
        self._n_iter = None

    @property
    def cluster_centers_(self) -> DNDarray:
        return self._cluster_centers

    @property
    def labels_(self) -> DNDarray:
        return self._labels

    @property
    def inertia_(self) -> float:
        return self._inertia

    @property
    def n_iter_(self) -> int:
        return self._n_iter

    def _initialize_cluster_centers(self, x: DNDarray) -> torch.Tensor:
        """Initial centroids as a (k, f) tensor on ``x``'s device."""
        k = self.n_clusters
        xa = x.larray
        n = x.gshape[0]
        if k > n:
            raise ValueError(f"n_clusters ({k}) cannot exceed the number of samples ({n})")
        if isinstance(self.init, DNDarray):
            if self.init.shape != (k, x.shape[1]):
                raise ValueError(f"passed centroids have wrong shape {self.init.shape}")
            return self.init._logical().to(device=xa.device, dtype=xa.dtype)
        if self.random_state is not None:
            ht_random.seed(self.random_state)
        gen = ht_random.get_generator(x.device)
        if self.init == "random":
            idx = torch.randperm(n, generator=gen, device=xa.device)[:k]
            return xa[idx]
        if self.init in ("probability_based", "kmeans++", "k-means++"):
            first = torch.randint(0, n, (1,), generator=gen, device=xa.device)
            centers = torch.empty((k, xa.shape[1]), dtype=xa.dtype, device=xa.device)
            centers[0] = xa[first[0]]
            d2 = self._metric(xa, centers[:1]).reshape(-1)
            for i in range(1, k):
                # inverse-CDF draw: torch.multinomial caps the category count at 2^24
                cdf = torch.cumsum(d2.to(torch.float64), dim=0)
                u = torch.rand(1, generator=gen, device=xa.device, dtype=torch.float64) * cdf[-1]
                nxt = torch.clamp(torch.searchsorted(cdf, u), max=n - 1)
                centers[i] = xa[nxt[0]]
                d2 = torch.minimum(d2, self._metric(xa, centers[i : i + 1]).reshape(-1))
            return centers
        raise ValueError(f"Initialization method {self.init!r} not supported")

    # --------------------------------------------------- state round-trip
    def state_dict(self) -> dict:
        """Fitted + hyper state as plain host values (numpy / scalars), in
        the layout of ``heat_tpu``'s ``state_dict``."""
        d = {
            "n_clusters": self.n_clusters,
            "max_iter": self.max_iter,
            "tol": self.tol,
            "random_state": self.random_state,
            "n_iter": self._n_iter,
            "inertia": self._inertia,
        }
        if self._cluster_centers is not None:
            d["cluster_centers"] = self._cluster_centers.numpy()
        if self._labels is not None:
            d["labels"] = self._labels.numpy()
            d["labels_split"] = self._labels.split
        return d

    def load_state_dict(self, d: dict, comm=None, device=None):
        """Restore :meth:`state_dict` output — this package's or
        ``heat_tpu``'s — onto ``device`` (default: the default device)."""
        self.n_clusters = int(d["n_clusters"])
        self.max_iter = int(d["max_iter"])
        self.tol = None if d["tol"] is None else float(d["tol"])
        self.random_state = None if d["random_state"] is None else int(d["random_state"])
        self._n_iter = None if d.get("n_iter") is None else int(d["n_iter"])
        self._inertia = None if d.get("inertia") is None else float(d["inertia"])
        cc = d.get("cluster_centers")
        self._cluster_centers = None if cc is None else DNDarray(np.asarray(cc), split=None, device=device, comm=comm)
        lab = d.get("labels")
        self._labels = (
            None
            if lab is None
            else DNDarray(np.asarray(lab), dtype=types.int64, split=d.get("labels_split"), device=device, comm=comm)
        )
        return self

    def _assign_to_cluster(self, x: DNDarray) -> DNDarray:
        """Cluster index of every sample."""
        if self._cluster_centers is None:
            raise RuntimeError("fit needs to be called before predict")
        xa = x.larray
        if not xa.is_floating_point():
            xa = xa.to(torch.float32)
        centers = self._cluster_centers.larray.to(device=xa.device, dtype=xa.dtype)
        labels = torch.argmin(self._metric(xa, centers), dim=1)
        return DNDarray(labels, dtype=types.int64, split=x.split, device=x.device, comm=x.comm)

    def predict(self, x: DNDarray) -> DNDarray:
        """Labels for new data."""
        if not isinstance(x, DNDarray):
            raise TypeError(f"input needs to be a DNDarray, but was {type(x)}")
        return self._assign_to_cluster(x)
