"""Gaussian Naive Bayes (counterpart of ``heat_tpu/naive_bayes/gaussianNB.py``).

The class statistics are one-hot products, as in ``heat_tpu``: with ``M``
the (n, k) membership matrix, counts are ``sum(M)``, the sums ``Mᵀ X`` and
the squares ``Mᵀ (X * X)``, and the variance is E[x²] − mean², so that the
values match ``heat_tpu``'s. Across ranks (x split along 0) every rank
forms these over its own rows, and one ``allreduce`` of k·(2f + 1) values
merges them. ``partial_fit`` merges new moments into the old ones with the
parallel-Welford rule. The variance smoothing ``eps = var_smoothing *
max(var(X, axis=0))`` goes through :func:`heat_tpu_torch.var` (the
``moments_onepass`` kernel on a card).

The joint log-likelihood is computed in blocks of rows, so that no
(n, k, f) buffer is held: each block's (rows, k, f) term stays under
``_BLOCK_ELEMS`` elements. Each row's value is the same expression as
``heat_tpu``'s.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import statistics
from ..core.base import BaseEstimator, ClassificationMixin
from ..core.dndarray import DNDarray

__all__ = ["GaussianNB"]

_BLOCK_ELEMS = 1 << 26  # elements of one block's (rows, k, f) term: 256 MiB of float32


def _float_tensor(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32, or float64 where it is float64 (jnp.promote_types(dtype, float32))."""
    return t if t.dtype == torch.float64 else t.to(torch.float32)


def _rows(x: DNDarray) -> DNDarray:
    """``x`` with its rows split along 0 or replicated."""
    return x if x.split in (None, 0) else x.resplit(0)


def _local_values(a, like: DNDarray) -> torch.Tensor:
    """This rank's rows of ``a`` (a DNDarray split like ``like``, a global
    DNDarray or tensor, or array-like) on ``like``'s device."""
    dev = like.larray.device
    if isinstance(a, DNDarray):
        if a.split == like.split:
            return a.larray.to(dev)
        t = a._logical()
    else:
        t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a)
    t = t.to(dev)
    if like.split == 0 and like.comm.is_distributed():
        off, lsh, _ = like.comm.chunk(like.gshape, 0)
        t = t[off : off + lsh[0]]
    return t


def _replicated(a, dev) -> torch.Tensor:
    if isinstance(a, DNDarray):
        return a._logical().to(dev)
    return torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a, device=dev)


class GaussianNB(BaseEstimator, ClassificationMixin):
    """Gaussian Naive Bayes.

    Parameters: ``priors`` (class priors, optional), ``var_smoothing``.
    Attributes after fit: ``classes_``, ``theta_`` (means), ``sigma_``
    (variances), ``class_prior_``, ``class_count_``, ``epsilon_``, all
    replicated.
    """

    def __init__(self, priors=None, var_smoothing: float = 1e-9):
        self.priors = priors
        self.var_smoothing = var_smoothing

    def fit(self, x: DNDarray, y: DNDarray, sample_weight=None) -> "GaussianNB":
        """Fit from scratch: the classes are the distinct values of ``y``."""
        self.classes_ = None
        self.theta_ = None
        self.sigma_ = None
        self.class_count_ = None
        self.class_prior_ = None
        return self.partial_fit(x, y, classes=None, sample_weight=sample_weight, _refit=True)

    def _distinct_labels(self, y: torch.Tensor, comm, split) -> torch.Tensor:
        """The sorted distinct labels of all ranks' ``y``."""
        u = torch.unique(y)
        if split == 0 and comm.is_distributed():
            u = torch.unique(comm.allgather(u, 0))
        return u

    def partial_fit(self, x: DNDarray, y: DNDarray, classes=None, sample_weight=None,
                    _refit: bool = False) -> "GaussianNB":
        """Incremental fit on a batch of rows: the new class moments are
        merged into the fitted ones."""
        if not isinstance(x, DNDarray) or not isinstance(y, DNDarray):
            raise TypeError(f"input needs to be DNDarrays, but were {type(x)}, {type(y)}")
        x = _rows(x)
        X = _float_tensor(x.larray)
        Y = _local_values(y, x).reshape(-1)
        dev = X.device
        comm = x.comm
        distributed = x.split == 0 and comm.is_distributed()
        seen = self._distinct_labels(Y, comm, x.split)
        if classes is not None:
            class_vals = _replicated(classes, dev)
        elif not _refit and getattr(self, "classes_", None) is not None:
            class_vals = self.classes_._logical()
        elif _refit:
            class_vals = seen
        else:
            raise ValueError("classes must be passed on the first call to partial_fit.")
        unseen = ~torch.isin(seen, class_vals)
        if bool(unseen.any()):
            bad = seen[unseen].cpu().numpy()
            raise ValueError(
                f"The target label(s) {bad} in y do not exist in the initial classes {class_vals.cpu().numpy()}"
            )
        k, f = class_vals.shape[0], X.shape[1]

        member = (Y[:, None] == class_vals[None, :]).to(X.dtype)  # (n, k)
        if sample_weight is not None:
            member = member * _local_values(sample_weight, x).to(X.dtype)[:, None]
        counts = torch.sum(member, dim=0)  # (k,)
        sums = member.T @ X  # (k, f)
        sq = member.T @ (X * X)
        if distributed:  # the ranks' statistics in one message of k (2f + 1) values
            packed = comm.allreduce(torch.cat([sums.reshape(-1), sq.reshape(-1), counts]))
            sums, sq, counts = packed[: k * f].reshape(k, f), packed[k * f : 2 * k * f].reshape(k, f), packed[2 * k * f :]
        means = sums / torch.clamp(counts, min=1.0)[:, None]
        varis = sq / torch.clamp(counts, min=1.0)[:, None] - means ** 2

        eps = self.var_smoothing * float(statistics.var(DNDarray(
            X, gshape=x.gshape, split=x.split, device=x.device, comm=comm), axis=0).larray.max())
        if _refit or getattr(self, "theta_", None) is None:
            new_counts, new_means, new_vars = counts, means, varis
        else:
            # merge with the previous moments (parallel Welford)
            old_counts = self.class_count_._logical().to(X.dtype)
            old_means = self.theta_._logical().to(X.dtype)
            old_vars = self.sigma_._logical().to(X.dtype) - self.epsilon_
            tot = old_counts + counts
            delta = means - old_means
            new_means = old_means + delta * (counts / torch.clamp(tot, min=1.0))[:, None]
            m_a = old_vars * old_counts[:, None]
            m_b = varis * counts[:, None]
            m2 = m_a + m_b + (delta ** 2) * ((old_counts * counts) / torch.clamp(tot, min=1.0))[:, None]
            new_vars = m2 / torch.clamp(tot, min=1.0)[:, None]
            new_counts = tot

        def rep(t):
            return DNDarray(t, split=None, device=x.device, comm=comm)

        self.epsilon_ = eps
        self.classes_ = rep(class_vals)
        self.class_count_ = rep(new_counts)
        self.theta_ = rep(new_means)
        self.sigma_ = rep(new_vars + eps)
        if self.priors is not None:
            self.class_prior_ = rep(_replicated(self.priors, dev))
        else:
            self.class_prior_ = rep(new_counts / torch.sum(new_counts))
        return self

    def _joint_log_likelihood(self, X: torch.Tensor) -> torch.Tensor:
        """(n, k): log prior − ½ Σ log(2π σ²) − ½ Σ (x − μ)² / σ², in blocks
        of rows that keep each (rows, k, f) term under ``_BLOCK_ELEMS``."""
        theta = self.theta_._logical().to(X.dtype)  # (k, f)
        sigma = self.sigma_._logical().to(X.dtype)
        prior = self.class_prior_._logical().to(X.dtype)
        log_prior = torch.log(torch.clamp(prior, min=1e-300))
        n_ij = -0.5 * torch.sum(torch.log(2.0 * math.pi * sigma), dim=1)  # (k,)
        k, f = theta.shape
        step = max(1, _BLOCK_ELEMS // max(1, k * f))
        out = torch.empty((X.shape[0], k), dtype=X.dtype, device=X.device)
        for r0 in range(0, X.shape[0], step):
            xb = X[r0 : r0 + step]
            quad = -0.5 * torch.sum(((xb[:, None, :] - theta[None, :, :]) ** 2) / sigma[None, :, :], dim=2)
            out[r0 : r0 + step] = log_prior[None, :] + n_ij[None, :] + quad
        return out

    def _local_jll(self, x: DNDarray):
        if getattr(self, "theta_", None) is None:
            raise RuntimeError("fit needs to be called before predict")
        x = _rows(x)
        return x, self._joint_log_likelihood(x.larray.to(self.theta_.larray.dtype))

    def logsumexp(self, a: DNDarray, axis=None) -> DNDarray:
        """log(sum(exp(a))) along ``axis`` (all elements for None), replicated."""
        t = a._logical()
        out = torch.logsumexp(t.reshape(-1) if axis is None else t, dim=0 if axis is None else axis)
        return DNDarray(out, split=None, device=a.device, comm=a.comm)

    def predict(self, x: DNDarray) -> DNDarray:
        """The most likely class of each row, split as ``x``'s rows."""
        x, jll = self._local_jll(x)
        pred = self.classes_._logical()[torch.argmax(jll, dim=1)]
        return DNDarray(pred, gshape=x.gshape[:1], split=x.split, device=x.device, comm=x.comm)

    def predict_log_proba(self, x: DNDarray) -> DNDarray:
        """Log posterior probabilities, (n, k), split as ``x``'s rows."""
        x, jll = self._local_jll(x)
        out = jll - torch.logsumexp(jll, dim=1, keepdim=True)
        return DNDarray(out, gshape=(x.gshape[0], out.shape[1]), split=x.split, device=x.device, comm=x.comm)

    def predict_proba(self, x: DNDarray) -> DNDarray:
        """Posterior probabilities, (n, k), split as ``x``'s rows."""
        lp = self.predict_log_proba(x)
        return DNDarray(torch.exp(lp.larray), gshape=lp.gshape, split=lp.split, device=lp.device, comm=lp.comm)
