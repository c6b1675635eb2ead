"""Communication over ``torch.distributed`` (counterpart of
``heat_tpu/core/communication.py``).

The port follows Heat's own SPMD model: one process per card, each holding
its rank's chunk of every split array. :func:`init_distributed` starts the
process group (NCCL when the arrays live on cards, gloo when the caller
asks for the CPU) and fixes each process's card first. Without it, and
without a group started by other code, the world has size 1 and every
collective returns its input without running anything.

:class:`TorchCommunication` keeps ``heat_tpu``'s partition arithmetic —
the ceil-div ``chunk``, ``counts_displs_shape`` and ``lshape_map``, so
that the last ranks may hold nothing — and adds the few collectives the
port needs, on tensors: ``allreduce``, ``allgather`` of ragged shards
along an axis, ``alltoall`` of ragged blocks, ``bcast`` (a slab from its
owner), ``ring_shift`` (a send to the previous rank with a receive from
the next) and ``exchange`` (a few sends and receives between neighbours,
as the split-axis halos need). Each one counts itself in
:data:`.kernels.COLLECTIVES` where it starts.

Every collective takes every heat type. What a backend lacks is moved in
a type it has (:func:`_to_wire`): complex as its real view (NCCL has no
complex type), int16 as int32 (neither gloo nor NCCL has int16), bool as
uint8. Only ``allreduce`` computes on the values; for complex it takes
``"sum"`` alone (a complex max or min is lexicographic, which no backend
reduces: gather the candidates instead).

A ``meta`` tensor (the lazy layer infers layouts on them) goes through
every collective without communicating: the result is a ``meta`` tensor of
the shape the collective would give, and an ``allgather`` whose extents
are not given raises, as no rank can tell the others' extents without
asking.

``SELF`` is a communicator of one rank inside any group: its collectives
return their input. ``MPI_WORLD``/``MPI_SELF``/``MPICommunication``/
``MeshCommunication`` are ``heat_tpu``'s names for the same objects; there
is no MPI underneath.
"""
from __future__ import annotations

import contextlib
import datetime
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import _hooks
from .kernels._dispatch import count_collective

__all__ = [
    "CUDA_AWARE_MPI",
    "Communication",
    "MPICommunication",
    "MPI_SELF",
    "MPI_WORLD",
    "MeshCommunication",
    "SELF",
    "SPLIT_AXIS",
    "TorchCommunication",
    "WORLD",
    "collective_lockstep",
    "comm_context",
    "get_comm",
    "init_distributed",
    "replicated_decision",
    "replicated_frame",
    "replicated_ids",
    "tree_merge",
    "tree_merge_rounds",
    "use_comm",
    "sanitize_comm",
]

_REDUCE_OPS = {
    "sum": dist.ReduceOp.SUM,
    "prod": dist.ReduceOp.PRODUCT,
    "min": dist.ReduceOp.MIN,
    "max": dist.ReduceOp.MAX,
}


# heat_tpu's name of the mesh axis that carries the split dimension
SPLIT_AXIS = "split"
# no MPI underneath: NCCL moves device memory itself
CUDA_AWARE_MPI = False


def _to_wire(t: torch.Tensor) -> Tuple[torch.Tensor, Callable[[torch.Tensor], torch.Tensor]]:
    """``t`` in a type that gloo and NCCL both move, and the function that
    turns a received tensor of that type back: complex as its real view
    (one more trailing dimension of 2), int16 as int32, bool as uint8."""
    if t.is_complex():
        return torch.view_as_real(t.contiguous()), lambda u: torch.view_as_complex(u.contiguous())
    if t.dtype == torch.int16:
        return t.to(torch.int32), lambda u: u.to(torch.int16)
    if t.dtype == torch.bool:
        return t.to(torch.uint8), lambda u: u.to(torch.bool)
    return t, lambda u: u


class Communication:
    """Base class for communication backends."""

    @staticmethod
    def is_distributed() -> bool:
        raise NotImplementedError()

    def chunk(self, shape, split, rank=None) -> Tuple[int, Tuple[int, ...], Tuple[slice, ...]]:
        raise NotImplementedError()


class TorchCommunication(Communication):
    """A communicator over ``torch.distributed``: by default the default
    process group (every rank of the program once a group is started, a
    world of size 1 before); with ``ranks``, the group of those global
    ranks, in that order, over the ``torch.distributed`` group ``group``.

    ``size`` and ``rank`` are read within the group, every collective runs
    on ``group``, and point-to-point peers are group ranks, mapped to their
    global ranks. A rank that is not a member of the group (``is_member``
    False: :func:`~heat_tpu_torch.resilience.degrade.shrink_to_healthy`
    excluded its card) holds no rows of an array split over the group
    (``chunk`` gives it none) and raises
    :class:`~heat_tpu_torch.resilience.DegradeError` naming itself at any
    collective, where torch would return silently. :func:`group_of` builds
    such communicators."""

    def __init__(self, ranks: Optional[Sequence[int]] = None, group=None):
        if group is not None and not isinstance(group, dist.ProcessGroup):
            raise TypeError(f"group must be a torch.distributed ProcessGroup or None, got {type(group)}")
        if ranks is None and group is not None:
            raise TypeError("a group needs its ranks")
        self._ranks = None if ranks is None else tuple(int(r) for r in ranks)
        self._group = group

    def _started(self) -> bool:
        return dist.is_available() and dist.is_initialized()

    @property
    def group(self):
        """The ``torch.distributed`` group of the collectives (None: the
        default group, or no group on a rank outside it)."""
        return self._group

    @property
    def ranks(self) -> Tuple[int, ...]:
        """The global ranks of the group, in group order."""
        if self._ranks is not None:
            return self._ranks
        return tuple(range(dist.get_world_size() if self._started() else 1))

    def _global_rank(self) -> int:
        return dist.get_rank() if self._started() else 0

    @property
    def is_member(self) -> bool:
        """Whether this process is a rank of the group."""
        return self._ranks is None or self._global_rank() in self._ranks

    def global_rank(self, rank: int) -> int:
        """The global rank of group rank ``rank``."""
        return self._ranks[rank] if self._ranks is not None else int(rank)

    def _check_member(self) -> None:
        """Raise :class:`DegradeError` on a rank outside the group."""
        if not self.is_member:
            from ..resilience.errors import DegradeError

            raise DegradeError(
                f"rank {self._global_rank()} is not a member of the group of ranks {list(self._ranks)}: its card "
                "was excluded (resilience.degrade), so it takes part in no collective of this group"
            )

    def _alone(self) -> bool:
        """No collective is needed: no group is started, or the group is
        this rank alone."""
        if not self._started():
            return True
        self._check_member()
        return self._ranks is not None and len(self._ranks) == 1

    @property
    def size(self) -> int:
        """Number of processes (MPI world-size analogue)."""
        if self._ranks is not None:
            return len(self._ranks)
        return dist.get_world_size() if self._started() else 1

    @property
    def rank(self) -> int:
        """This process's rank in the group (-1 outside it)."""
        if self._ranks is None:
            return dist.get_rank() if self._started() else 0
        g = self._global_rank()
        return self._ranks.index(g) if g in self._ranks else -1

    def is_distributed(self) -> bool:
        return self.size > 1

    @property
    def backend(self) -> Optional[str]:
        """``"nccl"``, ``"gloo"``, or None when no group is started."""
        return str(dist.get_backend()) if self._started() else None

    def device(self) -> torch.device:
        """Where this group's collectives take their tensors: the current
        card for NCCL, else the CPU."""
        if self.backend == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    # ------------------------------------------------------- partition
    def chunk(
        self, shape, split: Optional[int], rank: Optional[int] = None
    ) -> Tuple[int, Tuple[int, ...], Tuple[slice, ...]]:
        """The shard of ``shape`` owned by ``rank`` along ``split``:
        ``(offset, local_shape, slices)`` in the ceil-div layout."""
        shape = tuple(int(s) for s in shape)
        if split is None:
            return 0, shape, tuple(slice(0, s) for s in shape)
        rank = self.rank if rank is None else rank
        n = shape[split]
        block = -(-n // self.size) if n else 0
        start = min(rank * block, n) if rank >= 0 else n  # a rank outside the group holds nothing
        end = min(start + block, n)
        lshape = list(shape)
        lshape[split] = end - start
        slices = tuple(slice(start, end) if i == split else slice(0, s) for i, s in enumerate(shape))
        return start, tuple(lshape), slices

    def counts_displs_shape(self, shape, split: int):
        """Per-rank counts/displacements along ``split``."""
        shape = tuple(int(s) for s in shape)
        n = shape[split]
        block = -(-n // self.size) if n else 0
        counts, displs = [], []
        for r in range(self.size):
            start = min(r * block, n)
            counts.append(min(start + block, n) - start)
            displs.append(start)
        output_shape = list(shape)
        output_shape[split] = block
        return tuple(counts), tuple(displs), tuple(output_shape)

    def lshape_map(self, shape, split: Optional[int]) -> np.ndarray:
        """(size, ndim) array of every shard's local shape — computed, not
        communicated."""
        shape = tuple(int(s) for s in shape)
        out = np.empty((self.size, len(shape)), dtype=np.int64)
        for r in range(self.size):
            out[r] = self.chunk(shape, split, rank=r)[1] if len(shape) else ()
        return out

    # ----------------------------------------------------- collectives
    def allreduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The elementwise ``op`` (``"sum"``, ``"prod"``, ``"min"``,
        ``"max"``) of ``t`` over all ranks, as a new tensor; ``t`` itself
        when no group is started."""
        if self._alone():
            return t
        if t.is_meta:
            return torch.empty_like(t)
        if t.is_complex() and op != "sum":
            raise TypeError(f"allreduce {op!r} of a complex tensor: complex values have no order a backend reduces by")
        out, back = _to_wire(t.contiguous())
        out = out.clone()
        count_collective("allreduce", out.numel() * out.element_size())
        dist.all_reduce(out, op=_REDUCE_OPS[op], group=self._group)
        return back(out)

    def allgather(self, t: torch.Tensor, axis: int = 0, counts: Optional[Sequence[int]] = None) -> torch.Tensor:
        """The concatenation along ``axis`` of every rank's ``t``, in rank
        order. The ranks' extents along ``axis`` may differ: ``counts``
        gives them where the caller knows them (else one more gather
        exchanges them); every other dimension must agree."""
        if self._alone():
            return t
        if t.is_meta:
            if counts is None:
                raise _hooks.TraceBarrierError("allgather of unknown extents cannot run on meta tensors")
            shape = list(t.shape)
            shape[axis % t.ndim] = sum(int(c) for c in counts)
            return t.new_empty(shape)
        if counts is None:
            ext = torch.tensor([t.shape[axis]], dtype=torch.int64, device=self.device())
            parts = [torch.empty_like(ext) for _ in range(self.size)]
            count_collective("allgather", ext.numel() * ext.element_size(), ext.numel() * ext.element_size() * self.size)
            dist.all_gather(parts, ext, group=self._group)
            counts = [int(p.item()) for p in parts]
        counts = [int(c) for c in counts]
        cap = max(counts)
        axis = axis % t.ndim
        w, back = _to_wire(t)
        moved = w.movedim(axis, 0)
        buf = torch.zeros((cap,) + tuple(moved.shape[1:]), dtype=w.dtype, device=w.device)
        buf[: moved.shape[0]] = moved
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        count_collective("allgather", buf.numel() * buf.element_size(), buf.numel() * buf.element_size() * self.size)
        dist.all_gather(parts, buf, group=self._group)
        return back(torch.cat([p[:c] for p, c in zip(parts, counts)], dim=0).movedim(0, axis))

    def alltoall(self, blocks: Sequence[torch.Tensor], recv_shapes: Sequence[Tuple[int, ...]]) -> List[torch.Tensor]:
        """Send ``blocks[q]`` to rank q and receive one block from every
        rank p, of shape ``recv_shapes[p]``, known to the caller. All
        blocks have one dtype and device; any of them may be empty."""
        if self._alone():
            return [blocks[0].reshape(recv_shapes[0])]
        if blocks[0].is_meta:
            return [blocks[0].new_empty(tuple(s)) for s in recv_shapes]
        wired = [_to_wire(b) for b in blocks]
        back = wired[0][1]
        extra = (2,) if blocks[0].is_complex() else ()
        ref = wired[self.rank][0]
        send = torch.cat([w.reshape(-1) for w, _ in wired])
        sizes_in = [w.numel() for w, _ in wired]
        sizes_out = [int(np.prod(tuple(s) + extra, dtype=np.int64)) for s in recv_shapes]
        recv = torch.empty(sum(sizes_out), dtype=ref.dtype, device=ref.device)
        count_collective("alltoall", send.numel() * send.element_size(), recv.numel() * recv.element_size())
        dist.all_to_all_single(recv, send, output_split_sizes=sizes_out, input_split_sizes=sizes_in,
                               group=self._group)
        return [back(p.reshape(tuple(s) + extra)) for p, s in zip(torch.split(recv, sizes_out), recv_shapes)]

    def bcast(self, t: torch.Tensor, root: int) -> torch.Tensor:
        """Rank ``root``'s ``t`` on every rank; the other ranks pass a
        tensor of the same shape and dtype to receive into."""
        if self._alone() or t.is_meta:
            return t
        out, back = _to_wire(t.contiguous())
        out = out.contiguous()
        count_collective("bcast", out.numel() * out.element_size())
        dist.broadcast(out, src=self.global_rank(root), group=self._group)
        return back(out)

    def ring_shift(self, t: torch.Tensor, shift: int = 1) -> torch.Tensor:
        """Rank ``rank + shift``'s ``t`` (wrapping around; by default the
        next rank's): every rank sends its ``t`` to rank ``rank - shift`` and
        receives one tensor of the same shape and dtype, as one batch of
        point-to-point operations. With one rank, ``t`` itself."""
        if self._alone() or self.size == 1:
            return t
        if t.is_meta:
            return torch.empty_like(t)
        w, back = _to_wire(t.contiguous())
        w = w.contiguous()
        out = torch.empty_like(w)
        count_collective("ring_shift", w.numel() * w.element_size())
        ops = [dist.P2POp(dist.isend, w, self.global_rank((self.rank - shift) % self.size), self._group),
               dist.P2POp(dist.irecv, out, self.global_rank((self.rank + shift) % self.size), self._group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return back(out)

    def exchange(self, op: str, sends: Dict[int, torch.Tensor], recvs: Dict[int, Tuple[int, ...]],
                 like: torch.Tensor) -> Dict[int, torch.Tensor]:
        """Point-to-point messages as one batch: ``sends[q]`` goes to rank q,
        and a tensor of shape ``recvs[p]`` (of ``like``'s dtype and device)
        comes from rank p. Every rank must post the sends matching the
        others' receives. Counted once as ``op``, with the bytes sent and
        received."""
        if not (sends or recvs) or self._alone():
            return {}
        if like.is_meta:
            return {p: like.new_empty(tuple(shape)) for p, shape in recvs.items()}
        wire, back = _to_wire(like[:0])
        wired = {q: _to_wire(t.contiguous())[0].contiguous() for q, t in sends.items()}
        extra = (2,) if like.is_complex() else ()
        got = {p: torch.empty(tuple(shape) + extra, dtype=wire.dtype, device=like.device) for p, shape in recvs.items()}
        count_collective(op, sum(t.numel() * t.element_size() for t in wired.values()),
                         sum(t.numel() * t.element_size() for t in got.values()), p2p=True)
        ops = [dist.P2POp(dist.isend, t, self.global_rank(q), self._group) for q, t in sorted(wired.items())]
        ops += [dist.P2POp(dist.irecv, t, self.global_rank(p), self._group) for p, t in sorted(got.items())]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return {p: back(t) for p, t in got.items()}

    def barrier(self) -> None:
        """Wait until every rank has come here."""
        if not self._alone():
            count_collective("barrier", 0)
            if self.backend == "nccl":
                dist.barrier(group=self._group, device_ids=[torch.cuda.current_device()])
            else:
                dist.barrier(group=self._group)

    def __repr__(self) -> str:
        if self._ranks is not None:
            return f"TorchCommunication(ranks={list(self._ranks)}, backend={self.backend})"
        return f"TorchCommunication(size={self.size}, backend={self.backend})"

    def __eq__(self, other) -> bool:
        return type(other) is type(self) and other.ranks == self.ranks

    def __hash__(self):
        return hash(type(self))


class _SelfCommunication(TorchCommunication):
    """A communicator of this rank alone, inside any group (``MPI_SELF``):
    size 1, rank 0, and every collective returns its input."""

    def _started(self) -> bool:
        return False

    @property
    def ranks(self) -> Tuple[int, ...]:
        return (0,)

    def __repr__(self) -> str:
        return "TorchCommunication(SELF)"


WORLD = TorchCommunication()
SELF = _SelfCommunication()
MPI_WORLD = WORLD
MPI_SELF = SELF
MPICommunication = TorchCommunication
MeshCommunication = TorchCommunication

_default_comm = WORLD


def get_comm() -> TorchCommunication:
    """The current default communicator."""
    return _default_comm


def use_comm(comm: Optional[TorchCommunication] = None) -> None:
    """Set the default communicator."""
    global _default_comm
    if comm is None:
        comm = WORLD
    if not isinstance(comm, Communication):
        raise TypeError(f"expected a Communication object, got {type(comm)}")
    _default_comm = comm


@contextlib.contextmanager
def comm_context(comm: TorchCommunication):
    """Make ``comm`` the default communicator for the ``with`` block."""
    global _default_comm
    before = _default_comm
    use_comm(comm)
    try:
        yield comm
    finally:
        _default_comm = before


def sanitize_comm(comm) -> TorchCommunication:
    """Default-or-validate a communicator."""
    if comm is None:
        return get_comm()
    if not isinstance(comm, Communication):
        raise TypeError(f"expected a Communication object, got {type(comm)}")
    return comm


def _env_int(name: str, value: Optional[int]) -> Optional[int]:
    if value is not None:
        return int(value)
    return int(os.environ[name]) if name in os.environ else None


def init_distributed(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    local_rank: Optional[int] = None,
    timeout: float = 600.0,
) -> TorchCommunication:
    """Start the process group of this SPMD program and return ``WORLD``.

    Arguments left out come from ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``; ``MASTER_ADDR``/``MASTER_PORT`` through
    ``init_method="env://"``). ``backend`` defaults to NCCL when the
    default device is a card and to gloo when it is the CPU. For NCCL the
    process's card, ``cuda:{local_rank}``, is fixed with
    ``torch.cuda.set_device`` before the group starts, and becomes the
    default device. ``timeout`` (seconds) bounds the group's start and
    every collective. Call it before creating any array::

        import heat_tpu_torch as ht
        ht.init_distributed()            # under torchrun --nproc-per-node N
        x = ht.random.randn(n, f, split=0)
    """
    from . import devices

    rank = _env_int("RANK", rank)
    world_size = _env_int("WORLD_SIZE", world_size)
    local_rank = _env_int("LOCAL_RANK", local_rank)
    if rank is None or world_size is None:
        raise ValueError("init_distributed needs rank and world_size, as arguments or RANK/WORLD_SIZE")
    if local_rank is None:
        local_rank = rank
    if backend is None:
        backend = "gloo" if devices.get_device().device_type == "cpu" else "nccl"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: NCCL needs a CUDA card, and torch sees none")
        torch.cuda.set_device(local_rank)
        devices._set_default_gpu(local_rank)
    elif backend != "gloo":
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if init_method is None:
        if "MASTER_ADDR" not in os.environ:
            raise ValueError("init_distributed needs init_method, or MASTER_ADDR/MASTER_PORT in the environment")
        init_method = "env://"
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method, world_size=world_size, rank=rank,
            timeout=datetime.timedelta(seconds=timeout),
        )
    use_comm(WORLD)
    return WORLD


def ragged_process_allgather(arr: np.ndarray, axis: int = 0, comm: Optional[TorchCommunication] = None) -> list:
    """Every rank's host array, in rank order, where their extents along
    ``axis`` may differ (every other dimension and the dtype agree): the
    extents are gathered first (one ``allgather`` of one integer), then the
    payloads padded to the largest (one ``allgather``), each trimmed on
    receipt. Without a group, ``[arr]``.

    It runs as the guarded call ``"collective.allgather"`` of
    :mod:`._hooks`, so that a watchdog (``resilience.deadlines``) bounds the
    wait for a straggling or dead peer, and passes the fault point of the
    same name, which carries only what every rank shares (trailing shape,
    axis, dtype)."""
    from . import _hooks

    return _hooks.guarded_call("collective.allgather", _ragged_process_allgather_impl, arr, axis, comm)


def _ragged_process_allgather_impl(arr: np.ndarray, axis: int = 0, comm: Optional[TorchCommunication] = None) -> list:
    from . import _hooks

    comm = sanitize_comm(comm)
    moved = np.moveaxis(np.asarray(arr), axis, 0)
    _hooks.fault_point("collective.allgather", shape=tuple(moved.shape[1:]), axis=int(axis), dtype=str(moved.dtype))
    if not comm._started() or comm.size == 1:
        return [np.moveaxis(moved, 0, axis)]
    dev = comm.device()
    ext = torch.tensor([[moved.shape[0]]], dtype=torch.int64, device=dev)
    counts = [int(c) for c in comm.allgather(ext, 0, [1] * comm.size).reshape(-1).tolist()]
    if max(counts) == 0:
        return [np.moveaxis(moved, 0, axis) for _ in counts]
    got = comm.allgather(torch.from_numpy(np.ascontiguousarray(moved)).to(dev), 0, counts).cpu().numpy()
    bounds = np.concatenate([[0], np.cumsum(counts)])
    return [np.moveaxis(got[bounds[r] : bounds[r + 1]], 0, axis) for r in range(comm.size)]


def replicated_decision(flag, comm: Optional[TorchCommunication] = None, *, active: bool = True) -> bool:
    """``flag`` made the same on every rank: the OR of all ranks' flags
    (one ``allreduce`` of MAX), so a branch guarded by it is taken
    everywhere or nowhere. ``active=False``, or a world of one rank,
    returns ``bool(flag)`` without a collective."""
    comm = sanitize_comm(comm)
    if not active or not comm._started() or comm.size == 1:
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=comm.device())
    return bool(comm.allreduce(t, "max").item())


def replicated_ids(ids, *, cap: int = 64, active: bool = True, comm: Optional[TorchCommunication] = None) -> frozenset:
    """A small set of integer ids made the same on every rank: the union of
    every rank's set (``heat_tpu``'s ``replicated_ids``). One fixed-width
    ``allgather`` of a ``cap``-slot, -1-padded int32 frame, whose shape is
    the same on every rank. ``comm`` defaults to ``WORLD``, the base group:
    a rank excluded from a shrunken group still takes part here, which is
    how every rank agrees on the unhealthy set. ``active=False``, or a
    world of one rank, returns the local set without a collective. Runs as
    the guarded call ``"collective.replicated_ids"``, with the fault point
    of that name."""
    local = frozenset(int(i) for i in ids)
    comm = WORLD if comm is None else comm
    if not active or not comm._started() or comm.size == 1:
        return local
    if len(local) > cap:
        raise ValueError(f"replicated_ids: {len(local)} ids exceed the {cap}-slot frame")
    from . import _hooks

    def impl() -> frozenset:
        _hooks.fault_point("collective.replicated_ids", shape=(cap,), dtype="int32")
        frame = torch.full((1, cap), -1, dtype=torch.int32)
        frame[0, : len(local)] = torch.tensor(sorted(local), dtype=torch.int32)
        got = comm.allgather(frame.to(comm.device()), 0, [1] * comm.size).cpu().numpy().ravel()
        return frozenset(int(i) for i in got if i >= 0)

    return _hooks.guarded_call("collective.replicated_ids", impl)


def replicated_frame(frame, *, label: str = "collective.replicated_frame", active: bool = True,
                     comm: Optional[TorchCommunication] = None) -> np.ndarray:
    """Every rank's small int64 metadata ``frame`` (of the same shape on
    every rank), stacked in rank order: a ``(size, *frame.shape)`` array,
    the same on every rank (``heat_tpu``'s ``replicated_frame``), in one
    ``allgather``. Any pure function of it computes the same value
    everywhere. ``comm`` defaults to ``WORLD``, the base group, as for
    :func:`replicated_ids`. ``label`` names the guarded call and its fault
    point. ``active=False``, or a world of one rank, returns
    ``frame[None]`` without a collective."""
    frame = np.ascontiguousarray(frame, dtype=np.int64)
    comm = WORLD if comm is None else comm
    if not active or not comm._started() or comm.size == 1:
        return frame[None]
    from . import _hooks

    def impl() -> np.ndarray:
        _hooks.fault_point(label, shape=frame.shape, dtype="int64")
        t = torch.from_numpy(frame.reshape(1, -1)).to(comm.device())
        got = comm.allgather(t, 0, [1] * comm.size).cpu().numpy()
        return got.reshape((comm.size,) + frame.shape)

    return _hooks.guarded_call(label, impl)


# the torch.distributed groups group_of built, by their sorted global ranks
# (None on a rank outside them), and the default group they were built under
_GROUPS: Dict[Tuple[int, ...], Optional[dist.ProcessGroup]] = {}
_GROUPS_BASE: List[object] = [None]


def group_of(ranks: Sequence[int], *, member_only: bool) -> TorchCommunication:
    """A communicator over the global ``ranks`` (sorted). Every rank of the
    world makes ``WORLD`` when ``ranks`` are all of them. Otherwise the
    ``torch.distributed`` group of those ranks is built the first time it
    is asked for: with ``member_only`` the members build it alone
    (``use_local_synchronization``); without it every rank of the world
    calls ``new_group``. Either way every live rank of the world must call
    this function in the same program order. A rank outside ``ranks``
    gets a communicator it is not a member of.

    A group is built once for each set of ranks and kept for the life of
    the default group, and a later shrink or grow to the same ranks
    reuses it: a service whose card flaps comes back to the same group
    each time, so it holds at most one group for each set of ranks it has
    visited, not one for each resize. No group is destroyed. torch names a
    member-only group after its ranks and the number of groups the calling
    rank holds, so every rank must hold equally many when one is built
    (each rank outside ``ranks`` builds a group of itself alone to keep
    the count), and a destroyed group's name would come round again and
    meet the old group's keys in the store (in 4-rank gloo rehearsals
    that hung the next group's store barrier); ``group_desc`` does not
    enter the name. A rank that stops calling (a supervised run's
    detached rank) must not take part in a new member-only group again."""
    ranks = tuple(sorted({int(r) for r in ranks}))
    world = WORLD.size
    if not ranks or min(ranks) < 0 or max(ranks) >= world:
        raise ValueError(f"ranks {list(ranks)} are not ranks of a world of {world}")
    if ranks == tuple(range(world)):
        return WORLD
    if _GROUPS_BASE[0] is not dist.group.WORLD:  # a new default group: the old groups went with the old one
        _GROUPS.clear()
        _GROUPS_BASE[0] = dist.group.WORLD
    me = WORLD.rank
    if ranks not in _GROUPS:
        group = None
        if member_only:
            if me in ranks:
                group = dist.new_group(list(ranks), use_local_synchronization=True)
        else:
            group = dist.new_group(list(ranks))
        if me not in ranks:
            dist.new_group([me], use_local_synchronization=True)  # keeps this rank's count of groups the members'
            group = None
        _GROUPS[ranks] = group
    return TorchCommunication(ranks, _GROUPS[ranks])


def collective_lockstep(tree):
    """``tree`` unchanged: the port's collectives are already in lockstep.

    ``heat_tpu`` blocks here under several controllers, because XLA may run
    two independent collective-bearing programs at once and interleave their
    collectives differently on each process. In the port one Python thread
    per rank issues every collective, in program order, onto one CUDA stream
    (NCCL) or the gloo queue, so every rank starts the same collectives in
    the same order without waiting here; blocking would only stall the
    stream. It is kept so that code written against ``heat_tpu`` reads the
    same."""
    return tree


def tree_merge_rounds(nproc: int) -> int:
    """The exchange rounds :func:`tree_merge` takes for ``nproc`` ranks:
    ``log2 nproc`` on a power of two, else 0 (it gathers instead)."""
    nproc = int(nproc)
    if nproc <= 1 or nproc & (nproc - 1):
        return 0
    return nproc.bit_length() - 1


def _flatten(state):
    """The tensors of a nested tuple/list ``state``, and a function that
    rebuilds the structure from such a list."""
    if isinstance(state, (tuple, list)):
        parts = [_flatten(s) for s in state]
        leaves = [leaf for p in parts for leaf in p[0]]
        counts = [len(p[0]) for p in parts]

        def build(ls):
            out, i = [], 0
            for (_, b), c in zip(parts, counts):
                out.append(b(ls[i : i + c]))
                i += c
            return type(state)(out)

        return leaves, build
    return [state], lambda ls: ls[0]


def _pack(leaves) -> torch.Tensor:
    """The leaves' bytes, concatenated (one message, bit-exact)."""
    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in leaves])


def _unpack(buf: torch.Tensor, like) -> list:
    out, i = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(buf[i : i + n].clone().view(t.dtype).reshape(t.shape))  # a copy: aligned for the view
        i += n
    return out


# graftflow: DRIFT - its collectives are comm.allgather/comm.exchange, passed by attribute
def tree_merge(state, combine, *, label: str = "collective.tree_merge", active: bool = True,
               comm: Optional[TorchCommunication] = None):
    """One state per rank merged into the same global state on every rank
    in ``log2 P`` rounds: an XOR butterfly in which round ``d`` pairs rank
    ``r`` with ``r ^ d`` (one send and one receive each, counted as
    ``COLLECTIVES["tree_merge"]``).

    ``state`` is a nested tuple/list of tensors on the group's device, of
    the same structure, shapes and types on every rank; ``combine(a, b)``
    is an associative function of two such states, ``a`` the lower rank's,
    that keeps shapes and types. Both ranks of a pair apply ``combine``
    with the lower rank's state first, so every rank builds the same
    balanced bracketing ``s_0 + s_1 + ... + s_{P-1}`` and holds a
    bit-identical result (``heat_tpu``'s rank-ordered butterfly). A world
    size that is not a power of two gathers every state instead (one
    ``allgather``) and folds them in rank order. ``active=False`` or a
    world of one rank returns ``state``. Each merge counts one in
    ``MOVE_STATS["tree_merges"]`` and its rounds in
    ``MOVE_STATS["tree_merge_rounds"]`` (0 for the gather). Each exchange
    runs as the guarded call ``"tree_merge"`` of :mod:`._hooks`, which a
    watchdog bounds."""
    from . import _hooks

    comm = sanitize_comm(comm)
    nproc = comm.size
    if not active or nproc == 1:
        return state
    leaves, build = _flatten(state)
    _hooks.fault_point(label, leaves=len(leaves), shapes=tuple(tuple(t.shape) for t in leaves),
                       dtypes=tuple(str(t.dtype) for t in leaves))
    from ..parallel.flatmove import MOVE_STATS

    MOVE_STATS["tree_merges"] += 1
    MOVE_STATS["tree_merge_rounds"] += tree_merge_rounds(nproc)
    buf = _pack(leaves)
    if nproc & (nproc - 1):  # no butterfly off powers of two
        allb = _hooks.guarded_call("tree_merge", comm.allgather, buf.unsqueeze(0), 0, [1] * nproc)
        acc = build(_unpack(allb[0], leaves))
        for r in range(1, nproc):
            acc = combine(acc, build(_unpack(allb[r], leaves)))
        return acc
    acc = state
    d = 1
    while d < nproc:
        partner = comm.rank ^ d
        got = _hooks.guarded_call("tree_merge", comm.exchange, "tree_merge", {partner: buf},
                                  {partner: tuple(buf.shape)}, buf)[partner]
        other = build(_unpack(got, leaves))
        acc = combine(acc, other) if comm.rank & d == 0 else combine(other, acc)
        leaves, _ = _flatten(acc)
        buf = _pack(leaves)
        d <<= 1
    return acc
