"""Shared k-clustering machinery (counterpart of ``heat_tpu/cluster/_kcluster.py``).

Initial centroids come from ``heat_tpu``'s threefry stream
(:mod:`heat_tpu_torch.core.random`), step by step as ``heat_tpu`` draws
them, so a ``random_state`` gives ``heat_tpu``'s starting rows: ``'random'``
takes the first k of the permutation of the rows (jax's ``choice`` without
replacement); ``'probability_based'`` (k-means++) draws the first centroid
with jax's 64-bit ``randint`` and each next one by the inverse float32 D²
CDF at one uniform draw (jax's ``choice`` with ``p``). Across ranks every
rank computes the same draws; the rank that owns a chosen row broadcasts
it, so every rank holds the same centres, and an explicit init is
gathered whole. The float32 sums behind the CDF add in another order than
XLA's, so at large n a k-means++ draw can land on a neighbouring row.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core import factories
from ..core import random as ht_random
from ..core import types
from ..core.base import BaseEstimator, ClusteringMixin
from ..core.dndarray import DNDarray
from ..core.kernels.threefry import chunk_layout
from ..spatial.distance import _quadratic_expand

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
        """Initial centroids as a (k, f) tensor on ``x``'s device, the same
        on every rank. ``x`` is split along 0 or replicated."""
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
        dev = xa.device
        if self.init == "random":
            key = ht_random._next_key(k)
            return _take_rows(x, ht_random._shuffle(key, n, dev)[:k])
        if self.init in ("probability_based", "kmeans++", "k-means++"):
            key = ht_random._next_key(k * n)
            one = chunk_layout((), None, 0, 0)
            first = ht_random._randint_offsets(ht_random._fold_in(key, 0), one, n, dev)
            centers = torch.empty((k, xa.shape[1]), dtype=xa.dtype, device=dev)
            centers[0] = _take_rows(x, first)[0]
            # D² by the squared euclidean distance whatever the estimator's metric, as heat_tpu draws it
            d2 = _quadratic_expand(xa, centers[:1]).reshape(-1)
            split = x.split is not None and x.comm.is_distributed()
            kind = "uniform32" if d2.dtype == torch.float32 else "uniform64"
            for i in range(1, k):
                # jax's choice(key_i, n, p=d2/sum(d2)): r = cdf[-1] * (1 - u), the first index whose cdf >= r
                total = x.comm.allreduce(d2.sum()) if split else d2.sum()
                cdf = torch.cumsum(d2 / total, dim=0)
                u = ht_random._fill(ht_random._fold_in(key, i), one, kind, dev)
                if not split:
                    nxt = torch.searchsorted(cdf, cdf[-1:] * (1 - u))
                    centers[i] = xa[nxt[0]]
                else:
                    centers[i] = _draw_row_across_ranks(x, cdf, u)
                d2 = torch.minimum(d2, _quadratic_expand(xa, centers[i : i + 1]).reshape(-1))
            return centers
        raise ValueError(f"Initialization method {self.init!r} not supported")

    # ---------------------------------------------------------------- fit
    def _fit_view(self, x: DNDarray):
        """``(x, xa, comm)`` of a fit: ``x`` split along 0 or replicated, its
        local rows as a float tensor, and the communicator the statistics
        are summed over (None: this rank's rows are the whole data)."""
        if x.split not in (None, 0):
            x = x.resplit(0)
        xa = x.larray
        if xa.dtype not in (torch.float32, torch.float64):
            xa = xa.to(torch.float32)
        comm = x.comm if x.split == 0 and x.comm.is_distributed() else None
        return x, xa, comm

    def _begin_block(self, x: DNDarray, xa: torch.Tensor):
        """Set-up of a run of iterations (KMeans picks its route)."""
        return None

    def _iteration(self, xa, centers, comm, x, ctx):
        """One iteration of the fit: ``(centers, labels, shift)``."""
        raise NotImplementedError()

    def _finalize(self, x: DNDarray, xa: torch.Tensor, comm) -> None:
        """Post-fit hook on the final group's data (KMeans computes the inertia)."""

    def _labels_of(self, labels: torch.Tensor, x: DNDarray) -> DNDarray:
        return DNDarray(labels.to(torch.int64), gshape=x.gshape[:1], dtype=types.int64, split=x.split,
                        device=x.device, comm=x.comm)

    def _iterate(self, xa, centers, comm, x, budget: int, shift):
        """Up to ``budget`` iterations from ``centers`` while the shift
        exceeds ``tol`` (all of them with ``tol=None``, which never waits
        for the device; with a ``tol`` the shift is read back once per
        iteration). Returns ``(centers, labels, shift, iterations)``."""
        ctx = self._begin_block(x, xa)
        labels, iters = None, 0
        while iters < budget and (self.tol is None or float(shift) > float(self.tol)):
            centers, labels, shift = self._iteration(xa, centers, comm, x, ctx)
            iters += 1
        return centers, labels, shift, iters

    def _fit(self, x: DNDarray, supervisor, block_iters: int, label: str):
        """The fit: ``max_iter`` iterations (fewer once the shift is at most
        ``tol``), the labels of the last one.

        With a ``supervisor`` it is a supervised step loop (``heat_tpu``'s
        ``_fit_supervised``): each step runs up to ``block_iters``
        iterations, carrying the centres and the shift, so chained steps
        run the unsupervised fit's iterations one for one; the step
        boundary is where the supervisor checkpoints and recovers, and a
        step reads the shift back to the host once. The data moves with a
        shrink, so a fit that loses a rank finishes on the survivors; on a
        rank the shrink excluded the estimator stays unfitted.
        ``supervisor_result_`` keeps the run's
        :class:`~heat_tpu_torch.resilience.SupervisorResult` (``detached``
        on such a rank)."""
        x0, xa0, comm0 = self._fit_view(x)
        centers0 = self._initialize_cluster_centers(x0).to(xa0.dtype)
        if supervisor is None:
            centers, labels, _, n_iter = self._iterate(xa0, centers0, comm0, x0, self.max_iter, float("inf"))
            self._set_fit(centers, labels, n_iter, x0)
            self._finalize(x0, xa0, comm0)
            return self
        if block_iters < 1:
            raise ValueError(f"block_iters must be >= 1, got {block_iters}")
        state = {
            "centers": DNDarray(centers0, split=None, device=x0.device, comm=x0.comm),
            "labels": self._labels_of(torch.zeros(xa0.shape[0], dtype=torch.int64, device=xa0.device), x0),
            "shift": float("inf"),
            "n_iter": 0,
        }

        def step_fn(st, data, step):
            xd, xa, comm = self._fit_view(data[0])
            centers = st["centers"].larray.to(device=xa.device, dtype=xa.dtype)
            budget = min(block_iters, self.max_iter - st["n_iter"])
            centers, labels, shift, iters = self._iterate(xa, centers, comm, xd, budget, st["shift"])
            if labels is None:
                labels = torch.zeros(xa.shape[0], dtype=torch.int64, device=xa.device)
            shift_val = float(shift)  # the step's host read: the convergence decision
            n_iter = st["n_iter"] + iters
            new = dict(st, centers=DNDarray(centers, split=None, device=xd.device, comm=xd.comm),
                       labels=self._labels_of(labels, xd), shift=shift_val, n_iter=n_iter)
            converged = self.tol is not None and not shift_val > float(self.tol)
            return new, converged or n_iter >= self.max_iter

        result = supervisor.run(step_fn, state, data=(x0,), label=label)
        self.supervisor_result_ = result
        if result.detached:
            return self
        final = result.state
        xd, xa, comm = self._fit_view(result.data[0])  # the final (possibly shrunken) group's
        self._cluster_centers = final["centers"]
        self._labels = final["labels"]
        self._n_iter = int(final["n_iter"])
        self._finalize(xd, xa, comm)
        return self

    def _set_fit(self, centers: torch.Tensor, labels: torch.Tensor, n_iter: int, x: DNDarray) -> None:
        self._cluster_centers = DNDarray(centers, split=None, device=x.device, comm=x.comm)
        self._labels = self._labels_of(labels, x)
        self._n_iter = n_iter

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
            else factories.array(np.asarray(lab), dtype=types.int64, split=d.get("labels_split"), device=device, comm=comm)
        )
        return self

    def _assign_to_cluster(self, x: DNDarray) -> DNDarray:
        """Cluster index of every sample."""
        if self._cluster_centers is None:
            raise RuntimeError("fit needs to be called before predict")
        if x.split not in (None, 0):
            x = x.resplit(0)
        xa = x.larray
        if not xa.is_floating_point():
            xa = xa.to(torch.float32)
        centers = self._cluster_centers.larray.to(device=xa.device, dtype=xa.dtype)
        labels = torch.argmin(self._metric(xa, centers), dim=1)
        return DNDarray(labels, gshape=x.gshape[:1], dtype=types.int64, split=x.split, device=x.device, comm=x.comm)

    def predict(self, x: DNDarray) -> DNDarray:
        """Labels for new data."""
        if not isinstance(x, DNDarray):
            raise TypeError(f"input needs to be a DNDarray, but was {type(x)}")
        return self._assign_to_cluster(x)


def _take_rows(x: DNDarray, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (global, the same on every rank) of ``x`` on every rank:
    each rank that owns some of them broadcasts those."""
    comm = x.comm
    if x.split is None or not comm.is_distributed():
        return x.larray[idx]
    block = -(-x.gshape[0] // comm.size)
    offset = comm.chunk(x.gshape, 0)[0]
    rows = idx.tolist()
    out = torch.empty((len(rows),) + tuple(x.gshape[1:]), dtype=x.larray.dtype, device=x.larray.device)
    for owner in sorted({r // block for r in rows}):
        pos = [j for j, r in enumerate(rows) if r // block == owner]
        if comm.rank == owner:
            buf = x.larray[torch.tensor([rows[j] - offset for j in pos], device=x.larray.device)]
        else:
            buf = torch.empty((len(pos),) + tuple(x.gshape[1:]), dtype=out.dtype, device=out.device)
        out[pos] = comm.bcast(buf, owner)
    return out


def _draw_row_across_ranks(x: DNDarray, cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The row of a split-0 ``x`` at which the global CDF first reaches
    ``r = total * (1 - u)``, from this rank's local CDF ``cdf`` of the
    globally normalized weights: the ranks' totals are gathered, each
    rank's CDF continues from the sum of the totals before it, and the
    owner of the row searches its own and broadcasts the row."""
    comm = x.comm
    total = cdf[-1:] if cdf.numel() else torch.zeros(1, dtype=cdf.dtype, device=cdf.device)
    totals = comm.allgather(total, 0, [1] * comm.size).cpu()
    incl = torch.cumsum(totals, 0)
    r = incl[-1:] * (1 - u.cpu())
    full = [q for q in range(comm.size) if int(x.lshape_map[q, 0]) > 0]
    owner = next((q for q in full if bool(incl[q] >= r)), full[-1])
    if comm.rank == owner:
        before = (incl[owner] - totals[owner]).to(cdf.device)
        pos = torch.clamp(torch.searchsorted(cdf + before, r.to(cdf.device)), max=cdf.numel() - 1)
        row = x.larray[pos[0]].contiguous()
    else:
        row = torch.empty(x.gshape[1:], dtype=x.larray.dtype, device=x.larray.device)
    return comm.bcast(row, owner)
