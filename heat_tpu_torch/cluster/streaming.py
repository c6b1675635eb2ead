"""Streaming K-Means: Lloyd over chunks, in one pass or in epochs
(counterpart of ``heat_tpu/cluster/streaming.py``).

Each chunk goes through the same assignment step as
:class:`~.kmeans.KMeans`: ``kernels.lloyd_sharded`` — the ``lloyd_fused``
kernel on a card, its plain version on the CPU — with one ``allreduce`` of
the chunk's summed statistics across ranks.

- ``algorithm="global"`` (default): an epoch sums the chunks' statistics
  with the centres held fixed, then takes one exact Lloyd update. An epoch
  is one in-memory Lloyd iteration with the sums re-associated, so a fit
  from the same init and ``max_iter`` equals ``KMeans``'s to float32
  re-association. It needs a re-iterable source (a ``ChunkIterator``).
- ``algorithm="minibatch"``: each chunk moves its assigned centres toward
  the chunk means at the rate ``counts_chunk / counts_total`` (Sculley
  2010); :meth:`partial_fit` takes one chunk of an open-ended stream.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..core.dndarray import DNDarray
from ..core.kernels import LLOYD_KERNEL, dispatch_mode, lloyd_sharded, record_dispatch
from ..spatial.distance import _quadratic_expand
from ..stream.prefetch import Prefetcher
from ._kcluster import _KCluster

__all__ = ["StreamingKMeans"]


class StreamingKMeans(_KCluster):
    """K-Means over a chunked stream (see the module docstring).

    Parameters follow :class:`~.kmeans.KMeans` (``n_clusters``, ``init``,
    ``max_iter``, ``tol``, ``random_state``) plus ``algorithm``
    (``"global"`` or ``"minibatch"``). An ``init`` that is not a DNDarray
    samples the initial centres from the first chunk.

    ``labels_`` stays None (a single pass keeps no per-row labels: use
    :meth:`predict`); ``inertia_`` is the last epoch's summed inertia,
    against that epoch's starting centres (global) or the moving centres
    (minibatch).
    """

    def __init__(self, n_clusters: int = 8, init: Union[str, DNDarray] = "random", max_iter: int = 10,
                 tol: Optional[float] = 1e-4, random_state: Optional[int] = None, algorithm: str = "global"):
        if algorithm not in ("global", "minibatch"):
            raise ValueError(f"algorithm must be 'global' or 'minibatch', got {algorithm!r}")
        super().__init__(metric=_quadratic_expand, n_clusters=n_clusters, init=init, max_iter=max_iter, tol=tol,
                         random_state=random_state)
        self.algorithm = algorithm
        self._centers = None  # replicated (k, f) tensor between chunks
        self._totals = None  # minibatch: samples seen per centre
        self._placement = None  # (device, comm) of the first chunk

    def _step(self, chunk: DNDarray):
        """One chunk's assignment statistics ``(sums, counts, inertia)``,
        summed over the ranks of a split chunk."""
        if not isinstance(chunk, DNDarray):
            raise TypeError(f"chunks must be DNDarrays, got {type(chunk)}")
        if chunk.ndim != 2:
            raise ValueError(f"chunks must be 2D, got {chunk.ndim}D")
        if chunk.split not in (None, 0):
            chunk = chunk.resplit(0)
        xa = chunk.larray
        if xa.dtype not in (torch.float32, torch.float64):
            xa = xa.to(torch.float32)
        if self._centers is None:
            self._placement = (chunk.device, chunk.comm)
            self._centers = self._initialize_cluster_centers(chunk).to(xa.dtype)
        mode = dispatch_mode(LLOYD_KERNEL, xa)
        record_dispatch(LLOYD_KERNEL, mode)  # the call boundary: once per chunk
        comm = chunk.comm if chunk.split == 0 else None  # a replicated chunk: every rank has all of it
        sums, counts, _, inertia = lloyd_sharded(xa, self._centers, comm, mode)
        return sums.to(xa.dtype), counts.to(xa.dtype), inertia.to(xa.dtype)

    def _minibatch(self, chunk: DNDarray) -> torch.Tensor:
        sums, counts, inertia = self._step(chunk)
        if self._totals is None:
            self._totals = torch.zeros_like(counts)
        self._totals = self._totals + counts
        eta = (counts / torch.clamp(self._totals, min=1.0)).unsqueeze(1)
        target = sums / torch.clamp(counts, min=1.0).unsqueeze(1)
        self._centers = torch.where(counts.unsqueeze(1) > 0, self._centers * (1.0 - eta) + target * eta,
                                    self._centers)
        return inertia

    def _publish(self) -> None:
        device, comm = self._placement
        self._cluster_centers = DNDarray(self._centers, split=None, device=device, comm=comm)

    def partial_fit(self, chunk: DNDarray) -> "StreamingKMeans":
        """One minibatch step on ``chunk`` (whatever ``algorithm`` says)."""
        self._inertia = float(self._minibatch(chunk))
        self._n_iter = (self._n_iter or 0) + 1
        self._publish()
        return self

    def fit(self, chunks, prefetch_depth: Optional[int] = None) -> "StreamingKMeans":
        """Fit over a re-iterable chunk source for up to ``max_iter`` epochs,
        or until an epoch moves the centres by at most ``tol`` (squared
        shift; ``tol=None`` runs every epoch). With ``prefetch_depth`` each
        epoch's pass goes through a fresh :class:`~heat_tpu_torch.stream.Prefetcher`
        (one is single-use: pass the source itself, not a Prefetcher)."""
        if self.max_iter < 1:
            raise ValueError(f"max_iter must be >= 1, got {self.max_iter}")
        tol = -1.0 if self.tol is None else float(self.tol)
        epoch = 0
        shift = float("inf")
        while epoch < self.max_iter and shift > tol:
            sums = counts = inertia = None
            old = self._centers
            src = chunks if prefetch_depth is None else Prefetcher(chunks, depth=prefetch_depth)
            seen = False
            for chunk in src:
                seen = True
                if self.algorithm == "minibatch":
                    inertia = self._minibatch(chunk)
                    continue
                s, c, i = self._step(chunk)
                sums, counts, inertia = (s, c, i) if sums is None else (sums + s, counts + c, inertia + i)
            if not seen:
                if epoch == 0:
                    raise ValueError("chunk source yielded no chunks")
                raise ValueError(
                    "chunk source exhausted after one epoch; multi-epoch fits need a re-iterable source "
                    "(e.g. a ChunkIterator, not a Prefetcher — use the prefetch_depth argument)"
                )
            old = self._centers if old is None else old
            if self.algorithm == "global":  # the exact Lloyd update from the epoch's global statistics
                self._centers = torch.where(counts.unsqueeze(1) > 0,
                                            sums / torch.clamp(counts, min=1.0).unsqueeze(1), self._centers)
            shift = float(torch.sum((self._centers - old) ** 2))
            self._inertia = float(inertia)
            epoch += 1
        self._n_iter = epoch
        self._publish()
        return self
