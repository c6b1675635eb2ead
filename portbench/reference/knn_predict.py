"""Plain k-nearest-neighbour vote: the reference of ``KNeighborsClassifier.predict``.

Each query's k nearest training rows by squared euclidean distance over the
standardized features, and the label most of them carry (a tie goes to the
smallest label). Beside each label the reference gives the query's
*margin*: ``(d_{k+1} - d_k) / d_{k+1}`` over its sorted squared distances,
the least relative error in the distances that can change which k rows
vote. A program whose label differs from the reference's on a query of
margin m has got the distances wrong by at least m.
"""
from __future__ import annotations

import torch

from . import precision as P

_QUERIES = 256  # queries a block: a (256, m) distance block, 9 GB at m = 4.5e6 in float64


def vote(neigh: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """The majority label of each row of ``neigh`` (labels of the k nearest),
    ties to the smallest of ``classes`` (sorted)."""
    votes = (neigh.unsqueeze(2) == classes.view(1, 1, -1)).sum(1)
    return classes[torch.argmax(votes, dim=1)]


def predict(q: torch.Tensor, t: torch.Tensor, t_labels: torch.Tensor, k: int, precision: str):
    """``(labels, margins)`` of the standardized queries ``q`` against the
    standardized training rows ``t`` (both in ``precision``'s type)."""
    classes = torch.unique(t_labels)
    tn = (t * t).sum(1)
    labels, margins = [], []
    for lo in range(0, q.shape[0], _QUERIES):
        qb = q[lo : lo + _QUERIES]
        d2 = P.matmul(qb, t.T, precision)
        d2.mul_(-2.0).add_(tn).add_((qb * qb).sum(1, keepdim=True)).clamp_(min=0.0)
        near = torch.topk(d2, k + 1, dim=1, largest=False, sorted=True)
        del d2
        labels.append(vote(t_labels[near.indices[:, :k]], classes))
        dk, dk1 = near.values[:, k - 1], near.values[:, k]
        margins.append(((dk1 - dk) / torch.clamp(dk1, min=torch.finfo(dk1.dtype).tiny)).double())
    return torch.cat(labels), torch.cat(margins)
