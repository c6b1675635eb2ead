"""k-nearest-neighbours classifier (counterpart of
``heat_tpu/classification/kneighborsclassifier.py``).

``fit`` stores the training set. ``predict`` finds each query's k nearest
training rows and takes a one-hot vote. It keeps ``heat_tpu``'s gate: the
fused route (``spatial.nearest_neighbors``, the ``topk_distance`` kernel)
when the queries lie on a card, there are more than 2^22 query-training
pairs, ``x.split`` is 0 or None and ``n_neighbors <= 64``; otherwise the
materializing route (the full distance matrix, then the k smallest),
recorded as ``topk_distance.fallback``. The route is chosen by shape and
place, never by a failure. Across ranks the training set and its labels
are gathered whole; each rank predicts its own query rows.
"""
from __future__ import annotations

import torch

from ..core.base import BaseEstimator, ClassificationMixin
from ..core.dndarray import DNDarray
from ..core.kernels import TOPK_KERNEL, record_dispatch
from ..spatial.distance import _quadratic_expand, nearest_neighbors

__all__ = ["KNeighborsClassifier"]


def _on_card(t: torch.Tensor) -> bool:
    """Whether the fused route's kernel can run for ``t`` (the port's
    counterpart of ``heat_tpu``'s ``pallas_supported()``)."""
    return t.is_cuda


class KNeighborsClassifier(BaseEstimator, ClassificationMixin):
    """k-nearest-neighbours vote.

    Parameters
    ----------
    n_neighbors : int
        Number of neighbours that vote.
    """

    def __init__(self, n_neighbors: int = 5):
        self.n_neighbors = n_neighbors
        self.x = None
        self.y = None
        self.classes_ = None

    def fit(self, x: DNDarray, y: DNDarray) -> "KNeighborsClassifier":
        """Store the training set and its sorted distinct labels."""
        if not isinstance(x, DNDarray) or not isinstance(y, DNDarray):
            raise TypeError(f"input needs to be DNDarrays, but were {type(x)}, {type(y)}")
        self.x = x
        self.y = y
        self.classes_ = torch.unique(y._logical().ravel())
        return self

    def predict(self, x: DNDarray) -> DNDarray:
        """The majority label of each query row's ``n_neighbors`` nearest
        training rows; a tie between labels goes to the smallest label."""
        if self.x is None:
            raise RuntimeError("fit needs to be called before predict")
        yt = self.y._logical().ravel()
        k = self.n_neighbors
        nq, nt = x.shape[0], self.x.shape[0]
        if x.split not in (None, 0):
            # one label per query row cannot carry the queries' column split, as in heat_tpu
            raise ValueError(f"predict takes queries split along 0 or replicated, got split={x.split}")
        if _on_card(x.larray) and nq * nt > 1 << 22 and k <= 64:
            _, idx_nd = nearest_neighbors(x, self.x, k)
            idx = idx_nd.larray.to(torch.int64)
        else:
            record_dispatch(TOPK_KERNEL, "fallback")
            d2 = _quadratic_expand(x.larray.to(torch.float32), self.x._logical().to(torch.float32))
            # a stable sort: ties go to the lower index, as jax.lax.top_k
            idx = torch.sort(d2, dim=1, stable=True).indices[:, :k]
        neigh = yt.to(idx.device)[idx]  # (nq, k)
        votes = (neigh.unsqueeze(2) == self.classes_.to(idx.device).view(1, 1, -1)).to(torch.float32).sum(dim=1)
        pred = self.classes_.to(idx.device)[torch.argmax(votes, dim=1)]  # first maximum, as jnp.argmax
        return DNDarray(pred, gshape=(nq,), split=x.split, device=x.device, comm=x.comm)
