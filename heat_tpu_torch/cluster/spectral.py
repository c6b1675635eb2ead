"""Spectral clustering (counterpart of ``heat_tpu/cluster/spectral.py``).

The pipeline is ``heat_tpu``'s: the similarity graph's normalized
Laplacian (:class:`..graph.Laplacian`), ``lanczos`` (one product with the
row-split Laplacian and one ``allgather`` of n values per step across
ranks), the eigendecomposition of the small tridiagonal T
(``torch.linalg.eigh``, where ``heat_tpu`` calls ``jnp.linalg.eigh``; no
TPU kernel computes it), the spectral embedding ``V @ evecs[:, :k]`` (each
rank its own rows), and ``KMeans(init="probability_based")`` on it.

Eigenvectors are defined up to sign (and, for nearly equal eigenvalues, up
to a rotation within their span), and torch's and jnp's ``eigh`` may pick
differently; KMeans' distances, and so its labels from the same draws, do
not depend on that choice.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.base import BaseEstimator, ClusteringMixin
from ..core.dndarray import DNDarray
from ..core.linalg import lanczos
from ..graph.laplacian import Laplacian
from ..spatial import distance as ht_distance
from .kmeans import KMeans

__all__ = ["Spectral"]


class Spectral(BaseEstimator, ClusteringMixin):
    """Spectral clustering.

    Parameters
    ----------
    n_clusters : int, optional
        Number of clusters; None picks it by the eigengap of the 20
        smallest Ritz values.
    gamma : float
        The rbf kernel's ``exp(-gamma |x - y|^2)`` width.
    metric : 'rbf' | 'euclidean'
        The similarity: the rbf kernel, or the Euclidean distances.
    laplacian : 'fully_connected' | 'eNeighbour'
    threshold, boundary : the eNeighbour graph's bound and its side.
    n_lanczos : int
        Lanczos steps (at most n).
    assign_labels : 'kmeans'
    **params
        Passed to :class:`KMeans` (``max_iter``, ``tol``, ``random_state``).
    """

    def __init__(
        self,
        n_clusters: Optional[int] = None,
        gamma: float = 1.0,
        metric: str = "rbf",
        laplacian: str = "fully_connected",
        threshold: float = 1.0,
        boundary: str = "upper",
        n_lanczos: int = 300,
        assign_labels: str = "kmeans",
        **params,
    ):
        self.n_clusters = n_clusters
        self.gamma = gamma
        self.metric = metric
        self.laplacian = laplacian
        self.threshold = threshold
        self.boundary = boundary
        self.n_lanczos = n_lanczos
        self.assign_labels = assign_labels

        if metric == "rbf":
            sigma = (1.0 / (2.0 * gamma)) ** 0.5
            sim = lambda x: ht_distance.rbf(x, sigma=sigma)
        elif metric == "euclidean":
            sim = lambda x: ht_distance.cdist(x)
        else:
            raise NotImplementedError(f"Metric {metric} not supported")
        self._laplacian = Laplacian(
            similarity=sim,
            definition="norm_sym",
            mode=laplacian,
            threshold_key=boundary,
            threshold_value=threshold,
        )
        if assign_labels != "kmeans":
            raise NotImplementedError(f"assign_labels {assign_labels} not supported")
        self._cluster = KMeans(n_clusters=n_clusters or 8, init="probability_based", **params)
        self._labels = None

    @property
    def labels_(self) -> DNDarray:
        return self._labels

    def _spectral_embedding(self, x: DNDarray):
        """``(evals, V, evecs)``: the Ritz values (ascending, replicated),
        the Lanczos basis V (n, m) and T's eigenvectors (m, m), replicated."""
        L = self._laplacian.construct(x)
        m = min(self.n_lanczos, L.shape[0])
        V, T = lanczos(L, m)
        del L
        evals, evecs = torch.linalg.eigh(T.larray)
        return evals, V.larray, evecs

    def _embedding(self, x: DNDarray, V: torch.Tensor, evecs: torch.Tensor, k: int) -> DNDarray:
        """The first ``k`` columns of ``V @ evecs``, split as ``x``: each
        rank computes only its own rows."""
        comm = x.comm
        start, lshape, _ = comm.chunk((x.gshape[0],), 0 if x.split == 0 else None)
        emb = V[start : start + lshape[0]] @ evecs[:, :k]
        if x.split not in (None, 0) and comm.is_distributed():
            emb = emb[comm.chunk(tuple(emb.shape), x.split)[2]]
        return DNDarray(emb, gshape=(x.gshape[0], k), split=x.split, device=x.device, comm=comm)

    def fit(self, x: DNDarray) -> "Spectral":
        """Embed ``x`` and fit KMeans on the embedding; ``labels_`` are the
        fit's labels."""
        if not isinstance(x, DNDarray):
            raise TypeError(f"input needs to be a DNDarray, but was {type(x)}")
        evals, V, evecs = self._spectral_embedding(x)
        if self.n_clusters is None:
            # eigengap heuristic on the sorted Ritz values (one host read)
            self.n_clusters = int(torch.argmax(torch.diff(evals[: min(evals.shape[0], 20)]))) + 1
            self._cluster.n_clusters = max(self.n_clusters, 2)
        k = max(self.n_clusters, 2)
        self._cluster.fit(self._embedding(x, V, evecs, k))
        self._labels = self._cluster.labels_
        return self

    def predict(self, x: DNDarray) -> DNDarray:
        """Labels of ``x`` by the fitted KMeans, on ``x``'s own spectral
        embedding (recomputed)."""
        if self._labels is None:
            raise RuntimeError("fit needs to be called before predict")
        _, V, evecs = self._spectral_embedding(x)
        return self._cluster.predict(self._embedding(x, V, evecs, max(self.n_clusters, 2)))
