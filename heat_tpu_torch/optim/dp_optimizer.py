"""Data-parallel optimizers (counterpart of ``heat_tpu/optim/dp_optimizer.py``).

- :class:`DataParallelOptimizer`: a torch optimizer with the step
  bookkeeping Heat keeps, bound to a :class:`heat_tpu_torch.nn.DataParallel`.
- :class:`DASO`: hierarchical asynchronous data parallelism. The ranks
  form a (slow x fast) mesh (:func:`heat_tpu_torch.parallel.make_hierarchical_mesh`):
  one node group per slow index, the ranks of a group along the fast axis.
  Every rank holds its group's replica of the model. Each batch is cut
  into one slice per group, each group's slice into its ranks' shares;
  gradients are summed within the group every batch (one bucketed
  ``allreduce`` over the fast axis, each rank's loss weighted by its rows
  over the group's), so the replicas train apart. Every
  ``max(global_skip, 1)`` batches the replicas are averaged across the
  groups (one ``allreduce`` over the slow axis, in ``downcast_type``), and
  the average is applied ``batches_to_wait`` batches later as
  ``(p + g) / 2``: the replicas diverge between syncs and meet at them. The
  schedule (``epoch_loss_logic``, ``global_skip``, ``batches_to_wait``,
  ``epoch``, the pending average) is ``heat_tpu``'s, field for field.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.dndarray import DNDarray
from ..nn.data_parallel import (
    _host_copy,
    broadcast_module,
    group_allreduce,
    load_optimizer_state,
    optimizer_state,
    reduce_in_buckets,
)
from .utils import DetectMetricPlateau

__all__ = ["DataParallelOptimizer", "DASO"]


class DataParallelOptimizer:
    """A torch optimizer for use with :class:`heat_tpu_torch.nn.DataParallel`
    (Heat's ``DataParallelOptimizer(torch_optimizer, blocking)``)."""

    def __init__(self, torch_optimizer: torch.optim.Optimizer, blocking: bool = False):
        if not isinstance(torch_optimizer, torch.optim.Optimizer):
            raise TypeError(f"torch_optimizer must be a torch.optim.Optimizer, got {type(torch_optimizer)}")
        self.torch_optimizer = torch_optimizer
        self.blocking = blocking
        self._model = None
        self.batches_completed = 0

    def _bind(self, model) -> None:
        self._model = model

    def step(self, loss_fn: Callable, batch, labels) -> torch.Tensor:
        """One step of the bound model; the loss comes back as a device scalar."""
        if self._model is None:
            raise RuntimeError("optimizer is not bound to a DataParallel model")
        loss = self._model.train_step(loss_fn, batch, labels)
        self.batches_completed += 1
        return loss

    def state_dict(self) -> dict:
        """Bookkeeping state (the torch optimizer's state is in the bound model's ``state_dict``)."""
        return {"batches_completed": self.batches_completed}

    def load_state_dict(self, d: dict) -> "DataParallelOptimizer":
        self.batches_completed = int(d.get("batches_completed", 0))
        return self

    def zero_grad(self) -> None:
        self.torch_optimizer.zero_grad()


def _global_rows(b):
    """The whole batch ``b`` as a tensor (a DNDarray is gathered)."""
    return b._logical() if isinstance(b, DNDarray) else torch.as_tensor(b)


class DASO:
    """Distributed Asynchronous and Selective Optimization over a (slow x
    fast) mesh of ranks.

    Usage::

        mesh = heat_tpu_torch.parallel.make_hierarchical_mesh(n_slow=2)
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        daso = DASO(opt, total_epochs=10)
        model = daso.init(model, mesh)          # every replica starts as rank 0's
        model, loss = daso.step(loss_fn, model, batch, labels)
        ...
        final = daso.consolidated_params(model)  # the replicas' average

    ``loss_fn(model, *group_rows) -> loss`` is the mean loss of the rows it
    is given; ``batch`` and ``labels`` are the whole batch on every rank,
    whose leading dimension the number of groups divides.
    """

    def __init__(
        self,
        local_optimizer: torch.optim.Optimizer,
        total_epochs: int,
        warmup_epochs: int = 4,
        cooldown_epochs: int = 4,
        scheduler=None,
        stability_level: float = 0.05,
        max_global_skips: int = 8,
        sending_chunk_size: int = 10_000_000,
        downcast_type=torch.bfloat16,
        verbose: bool = False,
    ):
        # scheduler and sending_chunk_size are accepted for Heat's signature and unused, as in heat_tpu
        self.local_optimizer = local_optimizer
        self.total_epochs = total_epochs
        self.warmup_epochs = warmup_epochs
        self.cooldown_epochs = cooldown_epochs
        self.stability = DetectMetricPlateau(patience=2, threshold=stability_level)
        self.max_global_skips = max_global_skips
        self.downcast_type = downcast_type
        self.verbose = verbose

        self._reset_schedule()
        self._mesh = None
        self._slow_axis = "nodes"
        self._n_groups = 1
        self._group = 0
        self._fast = None  # process groups of this rank's row and column of the mesh
        self._slow = None
        self._fast_rank, self._fast_size = 0, 1

    def _reset_schedule(self) -> None:
        """Schedule defaults, shared by construction and re-``init``."""
        self.global_skip = 4
        self.batches_to_wait = 1
        self.epoch = 0
        self._batch = 0
        self._pending = None  # (averaged parameters, apply_at_batch)

    # -- setup ----------------------------------------------------------------
    def init(self, module: torch.nn.Module, mesh, slow_axis: str = "nodes") -> torch.nn.Module:
        """Bind to ``mesh`` and make every replica rank 0's ``module``; the
        schedule starts over."""
        self._mesh = mesh
        self._slow_axis = slow_axis
        self._reset_schedule()
        self.stability.reset()
        names = tuple(mesh.mesh_dim_names)
        ranks = np.asarray(mesh.mesh.tolist())
        if slow_axis in names and ranks.ndim == 2:
            self._n_groups = ranks.shape[names.index(slow_axis)]
            fast_dim = 1 - names.index(slow_axis)
            me = dist.get_rank() if dist.is_initialized() else 0
            where = np.argwhere(ranks == me)[0]
            self._group = int(where[names.index(slow_axis)])
            self._fast_rank, self._fast_size = int(where[fast_dim]), int(ranks.shape[fast_dim])
            if hasattr(mesh, "get_group"):  # a DeviceMesh: its per-dimension process groups
                self._fast = mesh.get_group(names[fast_dim])
                self._slow = mesh.get_group(slow_axis)
        else:
            self._n_groups, self._group, self._fast_rank, self._fast_size = 1, 0, 0, ranks.size
        broadcast_module(module)
        return module

    # -- phase logic ----------------------------------------------------------
    def epoch_loss_logic(self, loss: float) -> None:
        """Adapt global_skip from the loss plateau: warmup syncs every batch
        at once, cooldown every batch with skip 1; in between a plateau
        halves the skip, and a plateau at skip 1 resets it to
        ``max_global_skips``."""
        if self.epoch < self.warmup_epochs:
            self.global_skip = 0
            self.batches_to_wait = 0
        elif self.epoch >= self.total_epochs - self.cooldown_epochs:
            self.global_skip = 1
            self.batches_to_wait = 0
        else:
            self.batches_to_wait = 1
            if self.global_skip == 0:
                self.global_skip = 4
            if self.stability.test_if_improving(loss):
                if self.global_skip <= 1:
                    self.global_skip = self.max_global_skips
                else:
                    self.global_skip //= 2
        self.epoch += 1

    # -- stepping -------------------------------------------------------------
    def _my_rows(self, b: torch.Tensor, dev) -> torch.Tensor:
        """This rank's share of its group's slice of the batch ``b``."""
        n = b.shape[0]
        if n % self._n_groups:
            raise ValueError(f"the batch's {n} rows do not divide into {self._n_groups} groups")
        per = n // self._n_groups
        block = -(-per // self._fast_size)
        lo = self._group * per + min(self._fast_rank * block, per)
        hi = self._group * per + min((self._fast_rank + 1) * block, per)
        return b[lo:hi].to(dev), (hi - lo) / max(per, 1)

    def _average(self, module: torch.nn.Module, down) -> Dict[str, torch.Tensor]:
        """Every parameter averaged across the groups in the type ``down``."""
        out = {}
        for name, p in module.named_parameters():
            s = group_allreduce(p.detach().to(down), self._slow)
            out[name] = (s / self._n_groups).to(p.dtype)
        return out

    def step(self, loss_fn: Callable, params: torch.nn.Module, *batch):
        """One DASO step of this rank's replica ``params`` (the module) on
        its share of ``batch``; returns ``(module, loss)``, the loss the mean
        of the groups' losses as a device scalar."""
        if self._mesh is None:
            raise RuntimeError("DASO.init must be called before step")
        module = params
        dev = next(module.parameters()).device
        rows = [self._my_rows(_global_rows(b), dev) for b in batch]
        weight = rows[0][1]
        trainable = [p for p in module.parameters() if p.requires_grad]
        for p in trainable:
            p.grad = None
        if rows[0][0].shape[0]:
            loss = loss_fn(module, *(r for r, _ in rows)) * weight
            loss.backward()
        else:
            loss = torch.zeros((), device=dev)
        for p in trainable:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        loss = loss.detach().reshape(1).to(trainable[0].dtype)
        if self._fast_size > 1:  # node-local: the group's gradients, every batch
            reduce_in_buckets([loss] + [p.grad for p in trainable], self._fast)
        self.local_optimizer.step()
        if self._n_groups > 1:
            loss = group_allreduce(loss, self._slow) / self._n_groups

        with torch.no_grad():
            # a pending delayed global average: the received parameters are
            # averaged with the local ones that kept training meanwhile
            if self._pending is not None and self._batch >= self._pending[1]:
                for name, p in module.named_parameters():
                    p.copy_((p + self._pending[0][name].to(p.dtype)) / 2.0)
                self._pending = None
            if self._n_groups > 1:
                skip = max(self.global_skip, 1)
                if self._batch % skip == 0:
                    averaged = self._average(module, self.downcast_type)
                    if self.batches_to_wait > 0:
                        self._pending = (averaged, self._batch + self.batches_to_wait)
                    else:
                        for name, p in module.named_parameters():
                            p.copy_(averaged[name])
        self._batch += 1
        return module, loss[0]

    def state_dict(self, params: Optional[torch.nn.Module] = None) -> dict:
        """Schedule counters and the local optimizer's state (and the
        replica's parameters when ``params`` is given) as a flat host dict.
        An average in flight is not kept: after a restore the replicas train
        until the next sync."""
        d = {"global_skip": self.global_skip, "batches_to_wait": self.batches_to_wait, "epoch": self.epoch,
             "batch": self._batch}
        d.update(optimizer_state(self.local_optimizer))
        if params is not None:
            d.update({f"params.{k}": _host_copy(v) for k, v in params.state_dict().items()})
        return d

    def load_state_dict(self, d: dict, params: Optional[torch.nn.Module] = None):
        """Restore :meth:`state_dict` output; returns the module ``params``
        with its restored values when given, else None."""
        self.global_skip = int(d["global_skip"])
        self.batches_to_wait = int(d["batches_to_wait"])
        self.epoch = int(d["epoch"])
        self._batch = int(d["batch"])
        self._pending = None
        load_optimizer_state(self.local_optimizer, d)
        if params is None:
            return None
        live = params.state_dict()
        params.load_state_dict({k: torch.as_tensor(np.asarray(d[f"params.{k}"])).to(device=v.device, dtype=v.dtype)
                                for k, v in live.items() if f"params.{k}" in d}, strict=False)
        return params

    def consolidated_params(self, params: torch.nn.Module) -> Dict[str, torch.Tensor]:
        """The replicas' parameters averaged (in their own type), the same on every rank."""
        if self._n_groups == 1:
            return {k: v.detach().clone() for k, v in params.named_parameters()}
        return {name: group_allreduce(p.detach(), self._slow) / self._n_groups for name, p in params.named_parameters()}

    def zero_grad(self) -> None:
        self.local_optimizer.zero_grad()

    def print0(self, *args, **kwargs) -> None:
        """Print on global rank 0 only."""
        if not dist.is_initialized() or dist.get_rank() == 0:
            print(*args, **kwargs)
