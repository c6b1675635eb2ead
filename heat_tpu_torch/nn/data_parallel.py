"""Data-parallel training of a ``torch.nn.Module`` (counterpart of
``heat_tpu/nn/data_parallel.py``).

One process per card, as in Heat: every rank holds the whole model, a batch
is a DNDarray split along 0, and a step is the forward and backward on this
rank's rows, one bucketed ``allreduce`` of the gradients, and the
optimizer's step on every rank, which keeps the parameters identical.

``heat_tpu``'s loss is one function of the global batch (XLA inserts the
sum across devices). So that the port trains the same model when the ranks
hold unequal numbers of rows, each rank's loss (a mean over its rows) is
weighted by its rows over the global rows before the backward, and the
summed gradients are the gradients of the global mean. The same bucket
carries the weighted loss, so the step returns the global loss as a device
scalar with no host read.

BatchNorm layers normalize over the global batch in ``heat_tpu``. Here they
are replaced by :class:`GlobalBatchNorm`, which sums each channel's count,
sum and sum of squares over the ranks (one ``allreduce`` with autograd, in
the forward) before it normalizes; with one rank or a replicated batch it
is torch's own BatchNorm.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core import devices
from ..core.communication import TorchCommunication, sanitize_comm
from ..core.dndarray import DNDarray
from ..core.kernels import count_collective

__all__ = ["DataParallel", "DataParallelMultiGPU", "GlobalBatchNorm"]

BUCKET_BYTES = 25 << 20  # gradient bytes per allreduce (torch DDP's default bucket)


def _wire(t: torch.Tensor, group_backend: Optional[str]):
    """``t`` as gloo and NCCL both sum it (bfloat16 widened to float32 on gloo)."""
    if t.dtype == torch.bfloat16 and group_backend == "gloo":
        return t.to(torch.float32)
    return t


def group_allreduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group`` (default: all), as a new
    tensor in ``t``'s type; counted in ``COLLECTIVES``."""
    if not (dist.is_available() and dist.is_initialized()):
        return t
    w = _wire(t.contiguous(), dist.get_backend(group)).clone()
    count_collective("allreduce", w.numel() * w.element_size())
    dist.all_reduce(w, group=group)
    return w.to(t.dtype)


def reduce_in_buckets(tensors: List[torch.Tensor], group=None, bucket_bytes: int = BUCKET_BYTES) -> None:
    """Sum every tensor of ``tensors`` over the ranks of ``group``, in place:
    same-typed tensors are packed into flat buckets of at most
    ``bucket_bytes`` (a bigger tensor travels alone), one ``allreduce`` per
    bucket."""
    buckets: List[List[torch.Tensor]] = []
    size = 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if not buckets or size + nbytes > bucket_bytes or buckets[-1][0].dtype != t.dtype:
            buckets.append([])
            size = 0
        buckets[-1].append(t)
        size += nbytes
    for bucket in buckets:
        flat = group_allreduce(torch.cat([t.reshape(-1) for t in bucket]), group)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset : offset + t.numel()].view_as(t))
            offset += t.numel()


class _SumOverRanks(torch.autograd.Function):
    """``allreduce`` (sum) over ``group`` whose backward is the ``allreduce``
    of the gradient."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return group_allreduce(t, group)

    @staticmethod
    def backward(ctx, grad):
        return group_allreduce(grad, ctx.group), None


class GlobalBatchNorm:
    """BatchNorm over the rows of every rank, mixed into a BatchNorm layer's
    own class (:func:`_global_batchnorm`): in training, with ``group_stats``
    set (by :class:`DataParallel` for a split batch), each channel's count,
    sum and sum of squares are summed over the ranks before the batch is
    normalized, and the running statistics take the global mean and
    unbiased variance. Otherwise the layer's own forward. ``group`` is the
    ``torch.distributed`` group of the batch's communicator (None: the
    default group)."""

    group_stats = False
    group = None

    def forward(self, x):
        if not (self.training and self.group_stats and dist.is_available() and dist.is_initialized()):
            return super().forward(x)
        self._check_input_dim(x)
        dims = [0] + list(range(2, x.dim()))
        c = x.shape[1]
        local_n = torch.full((1,), float(x.numel() // max(c, 1)), dtype=x.dtype, device=x.device)
        stats = _SumOverRanks.apply(torch.cat([x.sum(dims), (x * x).sum(dims), local_n]), self.group)
        n = stats[-1]
        mean = stats[:c] / n
        var = stats[c : 2 * c] / n - mean * mean
        shape = (1, c) + (1,) * (x.dim() - 2)
        y = (x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + self.eps)
        if self.affine:
            y = y * self.weight.reshape(shape) + self.bias.reshape(shape)
        if self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked += 1
                m = (1.0 / float(self.num_batches_tracked)) if self.momentum is None else self.momentum
                unbiased = var * n / torch.clamp(n - 1, min=1.0)
                self.running_mean.mul_(1 - m).add_(mean.detach() * m)
                self.running_var.mul_(1 - m).add_(unbiased.detach() * m)
        return y


_GLOBAL_CLASSES: Dict[type, type] = {}


def _global_batchnorm(module: torch.nn.Module) -> torch.nn.Module:
    """``module`` with :class:`GlobalBatchNorm` mixed into every BatchNorm
    layer's class, in place: the layers keep their parameters and buffers
    (an optimizer built on them stays valid) and their own classes."""
    for m in module.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm) and not isinstance(m, GlobalBatchNorm):
            cls = type(m)
            if cls not in _GLOBAL_CLASSES:
                _GLOBAL_CLASSES[cls] = type(f"Global{cls.__name__}", (GlobalBatchNorm, cls), {})
            m.__class__ = _GLOBAL_CLASSES[cls]
    return module


def _state_tensors(module: torch.nn.Module) -> List[torch.Tensor]:
    return [t for t in module.state_dict(keep_vars=True).values()]


def broadcast_module(module: torch.nn.Module, root: int = 0, group=None) -> None:
    """Make every rank's parameters and buffers ``root``'s: one broadcast
    per type of the packed state."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size(group) == 1:
        return
    with torch.no_grad():
        tensors = [t.data for t in _state_tensors(module)]
        by_type: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            by_type.setdefault(t.dtype, []).append(t)
        for ts in by_type.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            w = _wire(flat, dist.get_backend(group)).contiguous()
            count_collective("bcast", w.numel() * w.element_size())
            dist.broadcast(w, src=root, group=group)
            flat = w.to(flat.dtype)
            offset = 0
            for t in ts:
                t.copy_(flat[offset : offset + t.numel()].view_as(t))
                offset += t.numel()


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t`` (on the CPU ``numpy()`` would share the live tensor's memory)."""
    return t.detach().cpu().numpy().copy()


def optimizer_state(opt: torch.optim.Optimizer, prefix: str = "opt") -> dict:
    """A torch optimizer's per-parameter state as ``{prefix.i.field: numpy}``
    (i: the parameter's position in the optimizer's groups)."""
    out = {}
    sd = opt.state_dict()
    for i, st in sd["state"].items():
        for field, v in st.items():
            out[f"{prefix}.{i}.{field}"] = _host_copy(v) if torch.is_tensor(v) else np.array(v)
    return out


def load_optimizer_state(opt: torch.optim.Optimizer, d: dict, prefix: str = "opt") -> None:
    """Restore what :func:`optimizer_state` wrote (missing entries keep the live state)."""
    sd = opt.state_dict()
    params = [p for g in opt.param_groups for p in g["params"]]
    state = {}
    for key, v in d.items():
        if not key.startswith(prefix + "."):
            continue
        _, i, field = key.split(".", 2)
        p = params[int(i)]
        t = torch.as_tensor(np.asarray(v))
        state.setdefault(int(i), {})[field] = t if field == "step" else t.to(device=p.device, dtype=p.dtype)
    if state:
        merged = {i: dict(sd["state"].get(i, {}), **st) for i, st in state.items()}
        for i, st in sd["state"].items():
            merged.setdefault(i, st)
        opt.load_state_dict({"state": merged, "param_groups": sd["param_groups"]})


class DataParallel:
    """Distributed data-parallel model wrapper.

    Parameters
    ----------
    module : torch.nn.Module
        The model; it moves to the default device (the card unless the
        caller asked for the CPU). Every rank's parameters and buffers are
        made rank 0's at construction.
    comm : TorchCommunication, optional
        The group the batches are split over (default: all ranks).
    optimizer : torch.optim.Optimizer or DataParallelOptimizer, optional
        An optimizer over ``module``'s parameters; ``train_step`` needs one.
    blocking_parameter_updates : bool
        Accepted for Heat's signature; the gradient allreduce completes
        before the optimizer's step either way.
    seed : int
        The seed of :meth:`init`'s parameter initialization.
    """

    def __init__(self, module: torch.nn.Module, comm: Optional[TorchCommunication] = None, optimizer=None,
                 blocking_parameter_updates: bool = False, seed: int = 0):
        from ..optim.dp_optimizer import DataParallelOptimizer

        if isinstance(comm, (torch.optim.Optimizer, DataParallelOptimizer)):  # the (module, optimizer, comm) order
            comm, optimizer = (optimizer if isinstance(optimizer, TorchCommunication) else None), comm
        if not isinstance(module, torch.nn.Module):
            raise TypeError(f"module must be a torch.nn.Module, got {type(module)}")
        self.comm = sanitize_comm(comm)
        self.device = devices.get_device()
        self.module = _global_batchnorm(module.to(self.device.torch_device))
        self.blocking_parameter_updates = blocking_parameter_updates
        self._seed = seed
        self._optimizer = None
        if optimizer is not None:
            if isinstance(optimizer, DataParallelOptimizer):
                self._optimizer = optimizer.torch_optimizer
                optimizer._bind(self)
            elif isinstance(optimizer, torch.optim.Optimizer):
                self._optimizer = optimizer
            else:
                raise TypeError(f"optimizer must be a torch.optim.Optimizer or DataParallelOptimizer, got {type(optimizer)}")
        broadcast_module(self.module, self.comm.global_rank(0), self.comm.group)

    # -- initialization -------------------------------------------------------
    def init(self, sample_input=None) -> Dict[str, torch.Tensor]:
        """Re-initialize every layer's parameters from ``seed`` (the same on
        every rank) and return them; the optimizer's state is cleared."""
        dev = self.device.torch_device
        with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
            torch.manual_seed(self._seed)
            for m in self.module.modules():
                if hasattr(m, "reset_parameters"):
                    m.reset_parameters()
        if self._optimizer is not None:
            self._optimizer.state.clear()
        return dict(self.module.named_parameters())

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.module.named_parameters())

    # -- forward --------------------------------------------------------------
    def _local(self, a):
        """(this rank's rows of ``a`` as a tensor on the device, the rows'
        weight in the global batch, whether the batch is split)."""
        if isinstance(a, DNDarray):
            a = a if a.split in (None, 0) else a.resplit(0)
            split = a.split == 0 and a.comm.is_distributed()
            t = a.larray.to(self.device.torch_device)
            return t, (t.shape[0] / max(a.gshape[0], 1) if split else 1.0), split
        return torch.as_tensor(a, device=self.device.torch_device), 1.0, False

    def _group(self, batch):
        """The ``torch.distributed`` group a batch's rows are summed over:
        its communicator's (after a shrink, the survivors')."""
        return (batch.comm if isinstance(batch, DNDarray) else self.comm).group

    @contextlib.contextmanager
    def _group_stats(self, on: bool, group=None):
        bns = [m for m in self.module.modules() if isinstance(m, GlobalBatchNorm)]
        for m in bns:
            m.group_stats, m.group = on, group
        try:
            yield
        finally:
            for m in bns:
                m.group_stats, m.group = False, None

    def __call__(self, inputs):
        """The forward pass; a DNDarray gives a DNDarray split as its rows."""
        x, _, split = self._local(inputs)
        with self._group_stats(split, self._group(inputs)):
            out = self.module(x)
        if isinstance(inputs, DNDarray):
            rows = 0 if inputs.split is not None else None
            return DNDarray(out, gshape=(inputs.gshape[0],) + tuple(out.shape[1:]), split=rows, device=inputs.device,
                            comm=inputs.comm)
        return out

    forward = __call__

    # -- training -------------------------------------------------------------
    def _backward(self, loss_fn: Callable, batch, labels) -> torch.Tensor:
        """Forward, weighted loss, backward and the bucketed allreduce of the
        gradients and the loss; returns the global loss (device scalar)."""
        xb, w, split = self._local(batch)
        yb, _, _ = self._local(labels)
        params = [p for p in self.module.parameters() if p.requires_grad]
        for p in params:
            p.grad = None
        if xb.shape[0] == 0:  # a rank without rows adds nothing
            loss = torch.zeros((), device=xb.device)
        else:
            with self._group_stats(split, self._group(batch)):
                loss = loss_fn(self.module(xb), yb) * w
            loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        loss = loss.detach()
        if split:
            loss = loss.reshape(1)
            reduce_in_buckets([loss] + [p.grad for p in params], self._group(batch))
            loss = loss[0]
        return loss

    def loss_and_grad(self, loss_fn: Callable, batch, labels) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The global batch's loss ``loss_fn(output, labels)`` (a mean over
        rows) and its gradients, summed over the ranks; the module's
        ``.grad`` fields hold them too."""
        loss = self._backward(loss_fn, batch, labels)
        return loss, {n: p.grad for n, p in self.module.named_parameters() if p.requires_grad}

    def train_step(self, loss_fn: Callable, batch, labels) -> torch.Tensor:
        """One optimization step on the global batch; returns the global
        loss as a device scalar (no host read)."""
        if self._optimizer is None:
            raise RuntimeError("DataParallel was constructed without an optimizer")
        loss = self._backward(loss_fn, batch, labels)
        self._optimizer.step()
        return loss

    # -- resumable training ---------------------------------------------------
    def state_dict(self) -> dict:
        """Model and optimizer state as a flat dict of host numpy arrays
        (``params.<name>`` for the module's parameters and buffers,
        ``opt.<i>.<field>`` for the optimizer's state) plus the seed."""
        d = {f"params.{k}": _host_copy(v) for k, v in self.module.state_dict().items()}
        if self._optimizer is not None:
            d.update(optimizer_state(self._optimizer))
        d["seed"] = self._seed
        return d

    def load_state_dict(self, d: dict) -> "DataParallel":
        """Restore :meth:`state_dict` output (missing keys keep the live values)."""
        live = self.module.state_dict()
        new = {k: torch.as_tensor(np.asarray(d[f"params.{k}"])).to(device=v.device, dtype=v.dtype)
               for k, v in live.items() if f"params.{k}" in d}
        self.module.load_state_dict(new, strict=False)
        if self._optimizer is not None:
            load_optimizer_state(self._optimizer, d)
        return self

    def fit(self, loss_fn: Callable, batch, labels, n_steps: int, supervisor=None,
            steps_per_block: int = 8) -> "DataParallel":
        """``n_steps`` of :meth:`train_step` on one batch.

        With ``supervisor`` the loop runs as a self-healing supervised step
        loop (``heat_tpu``'s): one supervised step is ``steps_per_block``
        train steps, the block boundary is where the model and optimizer
        state is checkpointed and restored, and a ``version`` token in the
        state detects a restore, after which the checkpointed state is
        loaded back into the model. The batch moves with a shrink, and the
        gradients are then summed over the survivors' group."""
        if supervisor is None:
            for _ in range(n_steps):
                self.train_step(loss_fn, batch, labels)
            return self
        if steps_per_block < 1:
            raise ValueError(f"steps_per_block must be >= 1, got {steps_per_block}")

        self._fit_version = 0
        state = dict(self.state_dict())
        state["step"] = 0
        state["version"] = 0

        def step_fn(st, data, blk):
            if st["version"] != self._fit_version:
                # this state came from a checkpoint, not the live model
                self.load_state_dict(st)
                self._fit_version = st["version"]
            n_do = min(steps_per_block, n_steps - st["step"])
            for _ in range(n_do):
                self.train_step(loss_fn, *data)
            new = dict(self.state_dict())
            new["step"] = st["step"] + n_do
            new["version"] = st["version"] + 1
            self._fit_version = new["version"]
            return new, new["step"] >= n_steps

        arrays = tuple(a for a in (batch, labels) if isinstance(a, DNDarray))
        if len(arrays) != 2:
            raise TypeError("a supervised fit needs the batch and the labels as DNDarrays")
        result = supervisor.run(step_fn, state, data=arrays, label="nn.fit")
        self.supervisor_result_ = result
        if result.state is not None and result.state["version"] != self._fit_version:
            self.load_state_dict(result.state)
        return self

    def eval(self) -> "DataParallel":
        self.module.eval()
        return self

    def train(self) -> "DataParallel":
        self.module.train()
        return self


class DataParallelMultiGPU(DataParallel):
    """Heat's node-local DDP with DASO's global sync: here, as in
    ``heat_tpu``, :class:`DataParallel` under Heat's name; DASO
    (:class:`heat_tpu_torch.optim.DASO`) owns the hierarchy."""
