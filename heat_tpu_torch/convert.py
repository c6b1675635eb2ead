"""Carry state from ``heat_tpu`` into this package.

``heat_tpu``'s estimators export their state as plain host values
(``state_dict()``: numpy arrays and python scalars). These functions build
the port's objects from such values; they import nothing of ``heat_tpu``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .classification.kneighborsclassifier import KNeighborsClassifier
from .cluster.kmeans import KMeans
from .cluster.kmedians import KMedians
from .cluster.kmedoids import KMedoids
from .cluster.spectral import Spectral
from .core import factories
from .core.dndarray import DNDarray

__all__ = ["array_from_numpy", "from_heat_tpu_state", "knn_from_heat_tpu", "spectral_from_heat_tpu"]


def array_from_numpy(a, split: Optional[int] = None, device=None, comm=None) -> DNDarray:
    """A DNDarray holding the numpy array ``a`` (its dtype kept), with split
    axis ``split``, on ``device`` (default: the default device)."""
    return factories.array(np.asarray(a), split=split, device=device, comm=comm)


_ESTIMATORS = {"kmeans": KMeans, "kmedians": KMedians, "kmedoids": KMedoids}


def from_heat_tpu_state(d: dict, device=None, comm=None, estimator: str = "kmeans"):
    """A fitted port :class:`KMeans` (or :class:`KMedians`,
    :class:`KMedoids`, by ``estimator``) from the dictionary that the
    ``heat_tpu`` estimator's ``state_dict()`` returns."""
    missing = {"n_clusters", "max_iter", "tol", "random_state"} - set(d)
    if missing:
        raise KeyError(f"not a k-clustering state dictionary: missing {sorted(missing)}")
    if estimator not in _ESTIMATORS:
        raise ValueError(f"estimator must be one of {sorted(_ESTIMATORS)}, got {estimator!r}")
    return _ESTIMATORS[estimator]().load_state_dict(d, comm=comm, device=device)


def knn_from_heat_tpu(x, y, n_neighbors: int = 5, split: Optional[int] = None, device=None, comm=None) -> KNeighborsClassifier:
    """A fitted port :class:`KNeighborsClassifier` from the training set
    and labels of a ``heat_tpu`` classifier, as numpy arrays (``clf.x.numpy()``,
    ``clf.y.numpy()``): a kNN classifier's only state is its training set.
    ``split`` is the training set's split axis."""
    x, y = np.asarray(x), np.asarray(y)
    if x.ndim != 2 or y.ndim != 1 or x.shape[0] != y.shape[0]:
        raise ValueError(f"need an (n, f) training set and n labels, got {x.shape} and {y.shape}")
    clf = KNeighborsClassifier(n_neighbors=n_neighbors)
    return clf.fit(
        array_from_numpy(x, split=split, device=device, comm=comm),
        array_from_numpy(y, split=split, device=device, comm=comm),
    )


def spectral_from_heat_tpu(params: dict, kmeans_state: dict, device=None, comm=None) -> Spectral:
    """A fitted port :class:`Spectral` from a fitted ``heat_tpu`` one: its
    ``get_params()`` and its KMeans' ``state_dict()`` (``sp._cluster``).
    ``predict`` then embeds new data as ``heat_tpu`` does and labels it by
    the carried centroids; ``labels_`` are the carried labels."""
    names = set(Spectral._parameter_names())
    unknown = set(params) - names
    if unknown:
        raise KeyError(f"not Spectral parameters: {sorted(unknown)}")
    sp = Spectral(**params)
    sp._cluster = from_heat_tpu_state(kmeans_state, device=device, comm=comm)
    sp._cluster.init = "probability_based"
    if sp.n_clusters is None:
        sp.n_clusters = sp._cluster.n_clusters
    sp._labels = sp._cluster.labels_
    return sp
