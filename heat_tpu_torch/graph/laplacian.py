"""Graph Laplacians (counterpart of ``heat_tpu/graph/laplacian.py``).

The similarity matrix S of a dataset, thresholded into an adjacency
(``fully_connected``, or ``eNeighbour`` with an ``upper`` or ``lower``
bound, weighted or not), self-connections removed, and then the
``simple`` Laplacian ``D - A`` or the symmetrically normalized
``norm_sym`` one ``I - D^-1/2 A D^-1/2``.

Each step writes into S's own buffer where ``heat_tpu`` makes a new n x n
array: at n = 30000 one float32 matrix is 3.6 GB. So ``construct``
consumes what the similarity returns: a similarity that hands out a
cached or shared array must return a copy of it. Across ranks S is split
along its rows: each rank works on its own rows, a self-connection sits
at the rank's global row index, and the degree vector (row sums) is
gathered once (n values) for ``norm_sym``'s column scaling.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core.dndarray import DNDarray

__all__ = ["Laplacian"]


class Laplacian:
    """Laplacian of the graph that ``similarity`` makes of a dataset.

    Parameters
    ----------
    similarity : callable
        DNDarray -> DNDarray similarity matrix (e.g.
        ``lambda x: ht.spatial.rbf(x, sigma=1.0)``). :meth:`construct`
        may overwrite the array it returns with the Laplacian.
    weighted : bool
        ``eNeighbour`` only: keep the similarities of the kept edges (else 1).
    definition : 'simple' | 'norm_sym'
    mode : 'fully_connected' | 'eNeighbour'
    threshold_key : 'upper' | 'lower'
        ``eNeighbour`` keeps the edges with a similarity below (upper) or
        above (lower) ``threshold_value``.
    threshold_value : float
    neighbours : int
        Kept for ``heat_tpu``'s signature.
    """

    def __init__(
        self,
        similarity: Callable,
        weighted: bool = True,
        definition: str = "norm_sym",
        mode: str = "fully_connected",
        threshold_key: str = "upper",
        threshold_value: float = 1.0,
        neighbours: int = 10,
    ):
        self.similarity_metric = similarity
        self.weighted = weighted
        if definition not in ("simple", "norm_sym"):
            raise NotImplementedError("Only simple and norm_sym Laplacians are supported")
        if mode not in ("eNeighbour", "fully_connected"):
            raise NotImplementedError("Only eNeighbour and fully_connected modes are supported")
        self.definition = definition
        self.mode = mode
        self.epsilon = (threshold_key, threshold_value)
        self.neighbours = neighbours

    def construct(self, x: DNDarray) -> DNDarray:
        """The Laplacian of the dataset ``x``, split as its similarity
        matrix (rows across ranks). At world size 1, and for a row-split
        similarity matrix above it, it is written into that matrix's
        buffer, which holds the Laplacian afterwards."""
        S = self.similarity_metric(x)
        if not isinstance(S, DNDarray):
            raise TypeError("similarity metric must return a DNDarray")
        comm = S.comm
        rows_split = S.split == 0 and comm.is_distributed()
        A = S.larray if rows_split or not comm.is_distributed() else S._logical().clone()
        start = comm.chunk(S.gshape, 0)[0] if rows_split else 0
        if self.mode == "eNeighbour":
            key, val = self.epsilon
            drop = ~(A < val) if key == "upper" else ~(A > val)
            if not self.weighted:
                A.fill_(1.0)
            A.masked_fill_(drop, 0.0)
            del drop
        diag = torch.diagonal(A, offset=start)  # the self-connections of this rank's rows
        diag.zero_()
        d = A.sum(dim=1)
        if self.definition == "simple":
            A.neg_()
            diag.copy_(d)
        else:
            d_all = comm.allgather(d, 0, [int(c) for c in S.lshape_map[:, 0]]) if rows_split else d
            scale = lambda v: torch.where(v > 0, 1.0 / torch.sqrt(torch.clamp(v, min=1e-30)), torch.zeros_like(v))
            A.mul_(scale(d).unsqueeze(1)).mul_(scale(d_all).unsqueeze(0)).neg_()
            diag.add_(1.0)
        if not rows_split and S.split is not None and comm.is_distributed():
            A = A[comm.chunk(S.gshape, S.split)[2]]
        return DNDarray(A, gshape=S.gshape, dtype=S.dtype, split=S.split, device=x.device, comm=comm)
