"""Lasso regression (counterpart of ``heat_tpu/regression/lasso.py``).

``fit`` is coordinate descent in residual form, ``heat_tpu``'s
``_cd_sweep``: the residual r = y − Xθ is kept, coordinate j's ρ is
``X[:, j] · (r + X[:, j] θ_j)``, its soft threshold is ``lam * n``
(coordinate 0, the intercept column, is not regularized), and r is updated
with the change of θ_j. Sweeps stop once ``max|Δθ| < tol`` or after
``max_iter``; ``n_iter`` records how many ran.

The fit reads X through one contiguous column-major copy (a (f, n)
tensor), so that each column is a contiguous read rather than a strided
one that touches every row's cache line. Everything of a sweep stays on
the device: θ is a tensor, each coordinate's update a few tensor
operations, and the stop test one host read per sweep. Across ranks (x
split along 0) the residual is row-local, so each coordinate costs one
``allreduce`` of its scalar ρ: a sweep costs f + 1 one-value allreduces
(one per coordinate) and one host read, and the fit one more allreduce of
the f + 1 column norms.

``partial_fit`` is one proximal-SGD step, ``heat_tpu``'s: θ − lr ∇, then
the soft threshold ``lr * lam`` on every coordinate but the intercept.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.base import BaseEstimator, RegressionMixin
from ..core.dndarray import DNDarray

__all__ = ["Lasso"]


def _soft(v: torch.Tensor, t) -> torch.Tensor:
    return torch.sign(v) * torch.clamp(torch.abs(v) - t, min=0.0)


def _rows(x: DNDarray) -> DNDarray:
    return x if x.split in (None, 0) else x.resplit(0)


def _targets(y: DNDarray, x: DNDarray, dtype) -> torch.Tensor:
    """This rank's rows of ``y``, flat, for ``x``'s rows."""
    if y.split == x.split:
        t = y.larray
    else:
        t = y._logical().to(x.larray.device)
        if x.split == 0 and x.comm.is_distributed():
            off, lsh, _ = x.comm.chunk(x.gshape, 0)
            t = t[off : off + lsh[0]]
    return t.reshape(t.shape[0], -1)[:, 0].to(dtype) if t.ndim > 1 else t.to(dtype)


class Lasso(BaseEstimator, RegressionMixin):
    """L1-regularized linear regression by coordinate descent.

    Parameters: ``lam`` (L1 weight), ``max_iter``, ``tol``. An intercept
    column of ones is expected in x.
    """

    def __init__(self, lam: float = 0.1, max_iter: int = 100, tol: float = 1e-6):
        self.lam = lam
        self.max_iter = max_iter
        self.tol = tol
        self.__theta = None
        self.n_iter = None

    @property
    def coef_(self) -> Optional[DNDarray]:
        return None if self.__theta is None else self.__theta[1:]

    @property
    def intercept_(self) -> Optional[DNDarray]:
        return None if self.__theta is None else self.__theta[0]

    @property
    def theta(self) -> Optional[DNDarray]:
        return self.__theta

    def soft_threshold(self, rho):
        """sign(ρ) max(|ρ| − lam, 0) of a DNDarray or a tensor."""
        if isinstance(rho, DNDarray):
            out = _soft(rho.larray, self.lam)
            return DNDarray(out, gshape=rho.gshape, split=rho.split, device=rho.device, comm=rho.comm)
        return _soft(torch.as_tensor(rho), self.lam)

    def rmse(self, gt: DNDarray, yest: DNDarray) -> float:
        """Root mean squared error of ``yest`` against ``gt``."""
        diff = gt._logical().reshape(-1) - yest._logical().reshape(-1)
        return float(torch.sqrt(torch.mean(diff * diff)))

    def state_dict(self) -> dict:
        """Fitted and hyper state as plain host values (``heat_tpu``'s keys)."""
        d = {"lam": self.lam, "max_iter": self.max_iter, "tol": self.tol, "n_iter": self.n_iter}
        if self.__theta is not None:
            d["theta"] = self.__theta.numpy()
        return d

    def load_state_dict(self, d: dict, comm=None, device=None) -> "Lasso":
        """Restore :meth:`state_dict` output (of this class or of ``heat_tpu``'s)."""
        self.lam = float(d["lam"])
        self.max_iter = int(d["max_iter"])
        self.tol = d["tol"]
        self.n_iter = d.get("n_iter")
        th = d.get("theta")
        self.__theta = None if th is None else DNDarray(np.asarray(th).reshape(-1, 1), split=None, device=device,
                                                        comm=comm)
        return self

    def fit(self, x: DNDarray, y: DNDarray, supervisor=None, block_iters: int = 16) -> "Lasso":
        """Coordinate descent from θ = 0 until ``max|Δθ| < tol`` or
        ``max_iter`` sweeps. With ``supervisor`` (a
        :class:`~heat_tpu_torch.resilience.Supervisor`) the fit runs as a
        self-healing supervised step loop: one step is up to
        ``block_iters`` sweeps, carrying θ and the last ``max|Δθ|``, and
        the supervisor checkpoints θ at step boundaries."""
        if not isinstance(x, DNDarray) or not isinstance(y, DNDarray):
            raise TypeError(f"input needs to be DNDarrays, but were {type(x)}, {type(y)}")
        if x.ndim != 2:
            raise ValueError(f"x needs to be 2D, but was {x.ndim}D")
        if supervisor is not None:
            return self._fit_supervised(x, y, supervisor, block_iters)
        x = _rows(x)
        Xc, r, dtype = self._columns(x, y)
        theta = torch.zeros(Xc.shape[0], dtype=dtype, device=Xc.device)
        theta, n_iter, _ = self._cd_block(Xc, r, theta, x.gshape[0], x.comm if x.split == 0 else None,
                                          self.max_iter, float("inf"))
        self.n_iter = n_iter
        self.__theta = DNDarray(theta.reshape(-1, 1), split=None, device=x.device, comm=x.comm)
        return self

    @staticmethod
    def _columns(x: DNDarray, y: DNDarray):
        """``(Xc, y, dtype)``: this rank's rows of ``x`` as a contiguous
        (f, n_local) column-major copy and of ``y`` as a flat tensor."""
        xl = x.larray
        dtype = torch.float64 if xl.dtype == torch.float64 else torch.float32
        Xc = xl.to(dtype).T.contiguous()  # (m, n_local): column j is Xc[j], contiguous
        return Xc, _targets(y, x, dtype).clone(), dtype

    def _fit_supervised(self, x: DNDarray, y: DNDarray, supervisor, block_iters: int) -> "Lasso":
        """``heat_tpu``'s supervised fit: each step is :meth:`_cd_block` of
        up to ``block_iters`` sweeps from the checkpointed θ; the residual is
        rebuilt from θ at each step (``y - Xθ``, the step's one product)."""
        if block_iters < 1:
            raise ValueError(f"block_iters must be >= 1, got {block_iters}")
        max_iter = self.max_iter
        x = _rows(x)
        dtype = torch.float64 if x.larray.dtype == torch.float64 else torch.float32
        state = {
            "theta": DNDarray(torch.zeros((x.gshape[1], 1), dtype=dtype, device=x.larray.device), split=None,
                              device=x.device, comm=x.comm),
            "diff": float("inf"),
            "n_iter": 0,
        }

        def step_fn(st, data, step):
            xd, yd = data
            xd = _rows(xd)
            Xc, yv, _ = self._columns(xd, yd)
            theta = st["theta"].larray.to(device=Xc.device, dtype=Xc.dtype).reshape(-1).clone()
            r = yv - Xc.T @ theta
            budget = min(block_iters, max_iter - st["n_iter"])
            theta, sweeps, diff = self._cd_block(Xc, r, theta, xd.gshape[0], xd.comm if xd.split == 0 else None,
                                                 budget, st["diff"])
            new = dict(st)
            new["theta"] = DNDarray(theta.reshape(-1, 1), split=None, device=xd.device, comm=xd.comm)
            new["diff"] = diff
            new["n_iter"] = st["n_iter"] + sweeps
            return new, diff < float(self.tol) or new["n_iter"] >= max_iter

        result = supervisor.run(step_fn, state, data=(x, y), label="lasso.fit")
        self.supervisor_result_ = result
        if result.detached:
            return self
        self.n_iter = int(result.state["n_iter"])
        self.__theta = result.state["theta"]
        return self

    def _cd_block(self, Xc: torch.Tensor, r: torch.Tensor, theta: torch.Tensor, n: int, comm, budget: int,
                  diff0: float):
        """Up to ``budget`` sweeps of coordinate descent over the columns
        ``Xc`` from ``theta`` with the residual ``r`` (both updated in
        place), while the last ``max|Δθ|`` (``diff0`` before the first) is
        ``>= tol``. Returns (θ, sweeps run, last max|Δθ|)."""
        m = Xc.shape[0]
        dist = comm is not None and comm.is_distributed()
        col_sq = torch.sum(Xc * Xc, dim=1)
        if dist:
            col_sq = comm.allreduce(col_sq)
        thr = torch.tensor(float(self.lam), dtype=Xc.dtype, device=Xc.device) * n
        n_iter = 0
        tol = float(self.tol)
        diff = float(diff0)
        while n_iter < budget and diff >= tol:
            old = theta.clone()
            for j in range(m):
                xj, tj = Xc[j], theta[j]
                rho = torch.dot(xj, torch.addcmul(r, xj, tj))
                if dist:
                    rho = comm.allreduce(rho)
                numer = rho if j == 0 else _soft(rho, thr)
                new_tj = torch.where(col_sq[j] > 0, numer / torch.clamp(col_sq[j], min=1e-30), torch.zeros_like(rho))
                r.addcmul_(xj, tj - new_tj)
                theta[j] = new_tj
            n_iter += 1
            diff = float(torch.max(torch.abs(theta - old)))  # the sweep's one host read
        return theta, n_iter, diff

    def partial_fit(self, x: DNDarray, y: DNDarray, lr: float = 0.01) -> "Lasso":
        """One proximal-SGD step on a chunk of rows (streaming fit): θ moves
        by −lr times the gradient of (1/2n)||Xθ − y||², then every
        coordinate but the intercept is soft-thresholded by ``lr * lam``.
        θ persists across calls and across a prior :meth:`fit`."""
        if not isinstance(x, DNDarray) or not isinstance(y, DNDarray):
            raise TypeError(f"input needs to be DNDarrays, but were {type(x)}, {type(y)}")
        if x.ndim != 2:
            raise ValueError(f"x needs to be 2D, but was {x.ndim}D")
        x = _rows(x)
        xl = x.larray
        dtype = torch.float64 if xl.dtype == torch.float64 else torch.float32
        X = xl.to(dtype)
        m = X.shape[1]
        yv = _targets(y, x, dtype)
        if y.gshape[0] != x.gshape[0]:
            raise ValueError(f"y has {y.gshape[0]} rows, x has {x.gshape[0]}")
        if self.__theta is None:
            theta = torch.zeros(m, dtype=dtype, device=X.device)
        else:
            theta = self.__theta.larray.to(device=X.device, dtype=dtype).reshape(-1)
            if theta.shape[0] != m:
                raise ValueError(f"x has {m} features, fitted theta has {theta.shape[0]}")
        grad = X.T @ (X @ theta - yv)
        if x.split == 0 and x.comm.is_distributed():
            grad = x.comm.allreduce(grad)
        th = theta - (grad / max(x.gshape[0], 1)) * lr
        soft = _soft(th, lr * self.lam)
        th = torch.where(torch.arange(m, device=X.device) == 0, th, soft)
        self.n_iter = (self.n_iter or 0) + 1
        self.__theta = DNDarray(th.reshape(-1, 1), split=None, device=x.device, comm=x.comm)
        return self

    def predict(self, x: DNDarray) -> DNDarray:
        """X θ, (n, 1), split as ``x``'s rows."""
        if self.__theta is None:
            raise RuntimeError("fit needs to be called before predict")
        x = _rows(x)
        out = x.larray @ self.__theta.larray.to(device=x.larray.device, dtype=x.larray.dtype)
        return DNDarray(out, gshape=(x.gshape[0], 1), split=x.split, device=x.device, comm=x.comm)
