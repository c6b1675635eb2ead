"""Carry state from ``heat_tpu`` into this package.

``heat_tpu``'s estimators export their state as plain host values
(``state_dict()``: numpy arrays and python scalars). These functions build
the port's objects from such values; they import nothing of ``heat_tpu``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .cluster.kmeans import KMeans
from .core import factories
from .core.dndarray import DNDarray

__all__ = ["array_from_numpy", "from_heat_tpu_state"]


def array_from_numpy(a, split: Optional[int] = None, device=None, comm=None) -> DNDarray:
    """A DNDarray holding the numpy array ``a`` (its dtype kept), with split
    axis ``split``, on ``device`` (default: the default device)."""
    return factories.array(np.asarray(a), split=split, device=device, comm=comm)


def from_heat_tpu_state(d: dict, device=None, comm=None) -> KMeans:
    """A fitted port :class:`KMeans` from the dictionary that
    ``heat_tpu.cluster.KMeans.state_dict()`` returns."""
    missing = {"n_clusters", "max_iter", "tol", "random_state"} - set(d)
    if missing:
        raise KeyError(f"not a KMeans state dictionary: missing {sorted(missing)}")
    return KMeans().load_state_dict(d, comm=comm, device=device)
