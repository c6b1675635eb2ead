"""Graceful degradation: shrink the group to its healthy cards, and grow it
back (counterpart of ``heat_tpu/resilience/degrade.py``).

The port runs one process per card, as Heat does, so a *device* here is a
rank's card and its id is the global rank:

- :func:`mark_unhealthy` / :func:`clear_unhealthy` keep the process-wide
  set of ranks excluded from future groups (fed by :func:`probe`, the
  :class:`~heat_tpu_torch.resilience.monitor.HealthMonitor`, the
  supervisor's and the server's fault ladders, or an outside health
  system);
- :func:`probe` round-trips one scalar on this rank's own card (a rank can
  reach no other card) and marks this rank when that fails; the callers
  then union every rank's verdict with
  :func:`~heat_tpu_torch.core.communication.replicated_ids`;
- :func:`shrink_to_healthy` builds the communicator of the surviving ranks
  (a ``torch.distributed`` group that only its members build) and moves
  live arrays onto it; the excluded rank sends its rows, so it must still
  be alive and able to communicate;
- :func:`grow_to_healthy` is the inverse, once a mark is cleared: a plain
  group over the healthy ranks of the base, which every live rank builds
  in program order, and the arrays moved back.

The move is the port's own: each rank of the new group receives exactly
its new rows from their old owners in one batch of point-to-point
messages (``COLLECTIVES["degrade_move"]``), over whichever of the two
groups holds every rank involved; ``heat_tpu`` gathers the logical values
on the host and reassembles each device's chunk. Values, dtype, ``gshape``
and ``split`` are kept; the layout is the ceil-div map over the new group.
``heat_tpu`` counts no ``MOVE_STATS`` for this move, and neither does the
port. A rank outside the new group keeps a replicated array's values and
holds no rows of a split one.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..core import _hooks
from ..core import communication as _comm
from ..core.communication import TorchCommunication, group_of, sanitize_comm
from ..core.dndarray import DNDarray
from .errors import DegradeError, NoHealthyDevicesError, ResilienceError

__all__ = [
    "mark_unhealthy",
    "clear_unhealthy",
    "unhealthy_devices",
    "healthy_devices",
    "probe",
    "shrink_to_healthy",
    "grow_to_healthy",
]

# process-wide registry of global ranks excluded from future groups
_UNHEALTHY: Set[int] = set()


def _device_id(device) -> int:
    """Accepts a global rank (an int) or an object with an integer ``id``."""
    if isinstance(device, (int, np.integer)):
        return int(device)
    dev_id = getattr(device, "id", None)
    if dev_id is None:
        raise TypeError(f"expected a rank or an object with an id, got {type(device)}")
    return int(dev_id)


def mark_unhealthy(device) -> None:
    """Exclude rank ``device`` (its card) from future groups."""
    _UNHEALTHY.add(_device_id(device))


def clear_unhealthy(device=None) -> None:
    """Forget one rank's unhealthy mark, or (default) all of them."""
    if device is None:
        _UNHEALTHY.clear()
    else:
        _UNHEALTHY.discard(_device_id(device))


def unhealthy_devices() -> frozenset:
    """The current set of unhealthy global ranks."""
    return frozenset(_UNHEALTHY)


def healthy_devices(comm: Optional[TorchCommunication] = None) -> List[int]:
    """The communicator's global ranks minus the unhealthy set, in group
    order."""
    comm = sanitize_comm(comm)
    return [r for r in comm.ranks if r not in _UNHEALTHY]


def _card() -> torch.device:
    from ..core import devices

    return devices.get_device().torch_device


def probe(comm: Optional[TorchCommunication] = None, *, mark: bool = True) -> List[int]:
    """Round-trip one scalar on this rank's card; return the ranks that
    failed (this one, or none) and with ``mark=True`` mark them unhealthy.

    The round trip is ``torch.ones((), device=card) + 1`` read back to the
    host, under the ``degrade.probe`` fault point (which carries
    ``device``, so ``chaos(device_flap=...)`` can fail it) and the guarded
    call of the same name. A rank probes its own card only, as ``heat_tpu``
    probes only the devices its process addresses. A CUDA error that left
    the process's context dead fails every later probe and marks the rank,
    but the shrink that follows cannot finish: the verdict exchange and the
    move of the rank's rows both need collectives through that card (see
    :mod:`~heat_tpu_torch.resilience.supervisor`). A rank outside ``comm`` probes
    nothing."""
    comm = sanitize_comm(comm)
    me = _comm.WORLD.rank
    if me not in comm.ranks:
        return []
    try:
        _hooks.guarded_call("degrade.probe", _round_trip, "degrade.probe", me)
    except ResilienceError:
        # divergence/timeout verdicts are about the collectives, not this card
        raise
    except Exception:  # noqa: BLE001 - any probe failure means unhealthy
        if mark:
            mark_unhealthy(me)
        return [me]
    return []


def _round_trip(site: str, rank: int) -> None:
    """One scalar through this rank's card, under the fault point ``site``."""
    _hooks.fault_point(site, device=int(rank))
    got = float((torch.ones((), device=_card()) + 1).item())
    if got != 2.0:
        raise RuntimeError(f"probe computed {got}, expected 2.0")


def shrink_to_healthy(
    comm: Optional[TorchCommunication] = None,
    arrays: Sequence[DNDarray] = (),
    *,
    set_default: bool = False,
) -> Tuple[TorchCommunication, List[DNDarray]]:
    """Build the communicator of ``comm``'s healthy ranks and move live
    arrays onto it.

    Returns ``(new_comm, new_arrays)``: the group of the surviving ranks
    (built by its members alone; every rank must hold the same unhealthy
    set, as the callers make it with
    :func:`~heat_tpu_torch.core.communication.replicated_ids`), plus one
    moved DNDarray per input (same ``gshape``/``dtype``/``split``, values
    bit for bit, the ceil-div layout over the survivors). With no unhealthy
    rank the inputs are returned unchanged. ``set_default=True`` installs
    the new communicator as the default (``use_comm``). ``comm`` stays
    usable, and its group is kept (``group_of`` says why). Every rank of
    ``comm`` takes part, the excluded ones too: they send their rows.

    A rank outside the new group gets a communicator it is not a member
    of: its moved arrays hold no rows, and their collectives raise
    :class:`DegradeError`. Raises :class:`NoHealthyDevicesError` when
    nothing survives."""
    comm = sanitize_comm(comm)
    survivors = healthy_devices(comm)
    if not survivors:
        raise NoHealthyDevicesError(comm.size)
    if len(survivors) == comm.size:
        return comm, list(arrays)
    new_comm = group_of(survivors, member_only=True)
    return _finish(new_comm, arrays, set_default, "shrink_to_healthy")


def grow_to_healthy(
    comm: Optional[TorchCommunication] = None,
    arrays: Sequence[DNDarray] = (),
    *,
    base: Optional[TorchCommunication] = None,
    set_default: bool = False,
) -> Tuple[TorchCommunication, List[DNDarray]]:
    """The inverse of :func:`shrink_to_healthy`: build the communicator of
    every healthy rank of ``base`` (default ``WORLD``) and move live arrays
    from ``comm`` onto it.

    The group is a plain ``new_group``, which every rank of the world
    builds in the same program order: the rank that rejoins is alive (it
    kept taking part in the base group's health exchange), and the
    decision to grow must already be the same on every rank (the monitor's
    verdicts and the serve and supervisor hooks make it so). Clearing a
    mark is the caller's decision (normally the monitor's, after its
    ``heal_after`` clean ticks). When the healthy base set already is
    ``comm``'s the inputs are returned unchanged. Raises
    :class:`NoHealthyDevicesError` when nothing in ``base`` is healthy."""
    comm = sanitize_comm(comm)
    base = _comm.WORLD if base is None else base
    target = healthy_devices(base)
    if not target:
        raise NoHealthyDevicesError(base.size)
    if tuple(target) == tuple(comm.ranks):
        return comm, list(arrays)
    new_comm = group_of(target, member_only=False)
    return _finish(new_comm, arrays, set_default, "grow_to_healthy")


def _finish(new_comm, arrays, set_default, what):
    moved: List[DNDarray] = []
    for x in arrays:
        if not isinstance(x, DNDarray):
            raise DegradeError(f"{what} can only move DNDarrays, got {type(x)}")
        moved.append(_move_to_comm(x, new_comm))
    if set_default:
        _comm.use_comm(new_comm)
    return new_comm, moved


def _span(old: TorchCommunication, new: TorchCommunication) -> TorchCommunication:
    """A communicator holding every rank of ``old`` and ``new``: the larger
    of the two where one holds the other, else ``WORLD``."""
    a, b = set(old.ranks), set(new.ranks)
    if b <= a:
        return old
    if a <= b:
        return new
    return _comm.WORLD


def _move_to_comm(x: DNDarray, new_comm: TorchCommunication) -> DNDarray:
    """``x`` on ``new_comm``: a replicated array keeps its tensor; a split
    one is moved row block by row block, each rank of ``new_comm``
    receiving exactly its ceil-div rows from the ranks that hold them (the
    old layout may be ragged), in one batch of messages over the group that
    spans both (:func:`_span`). Runs as the guarded call
    ``"collective.assemble"`` (``heat_tpu``'s name for its reassembly), with
    the fault point of that name."""
    if x.split is None:
        return DNDarray(x._raw, gshape=x.gshape, dtype=x.dtype, split=None, device=x.device, comm=new_comm)
    return _hooks.guarded_call("collective.assemble", _move_split, x, new_comm)


def _move_split(x: DNDarray, new_comm: TorchCommunication) -> DNDarray:
    old = x.comm
    split = x.split
    _hooks.fault_point("collective.assemble", gshape=tuple(x.gshape), split=split, dtype=str(x.dtype.__name__))
    span = _span(old, new_comm)
    me = _comm.WORLD.rank
    old_counts = [int(c) for c in x.lshape_map[:, split]]
    old_starts = np.concatenate([[0], np.cumsum(old_counts)[:-1]]).astype(int).tolist()
    new_counts = [int(c) for c in new_comm.counts_displs_shape(x.gshape, split)[0]]
    new_starts = np.concatenate([[0], np.cumsum(new_counts)[:-1]]).astype(int).tolist()
    span_of = {g: i for i, g in enumerate(span.ranks)}
    local = x._raw
    # (old owner, new owner) global ranks -> global row interval
    pieces: Dict[Tuple[int, int], Tuple[int, int]] = {}
    for q, (os_, oc) in enumerate(zip(old_starts, old_counts)):
        for j, (ns, nc) in enumerate(zip(new_starts, new_counts)):
            lo, hi = max(os_, ns), min(os_ + oc, ns + nc)
            if hi > lo:
                pieces[(old.global_rank(q), new_comm.global_rank(j))] = (lo, hi)
    shape = list(x.gshape)
    sends: Dict[int, torch.Tensor] = {}
    recvs: Dict[int, Tuple[int, ...]] = {}
    kept: Dict[int, torch.Tensor] = {}
    my_old_start = old_starts[old.rank] if old.is_member and old.rank >= 0 else 0
    for (src, dst), (lo, hi) in pieces.items():
        if src == me:
            block = local.narrow(split, lo - my_old_start, hi - lo)
            if dst == me:
                kept[lo] = block
            else:
                sends[span_of[dst]] = block
        elif dst == me:
            recv_shape = list(shape)
            recv_shape[split] = hi - lo
            recvs[span_of[src]] = tuple(recv_shape)
    got = span.exchange("degrade_move", sends, recvs, local) if (sends or recvs) else {}
    parts = dict(kept)
    for (src, dst), (lo, hi) in pieces.items():
        if dst == me and src != me:
            parts[lo] = got[span_of[src]]
    if parts:
        mine = torch.cat([parts[lo] for lo in sorted(parts)], dim=split)
    else:
        empty = list(shape)
        empty[split] = 0
        mine = local.new_empty(tuple(empty))
    return DNDarray(mine, gshape=x.gshape, dtype=x.dtype, split=split, device=x.device, comm=new_comm)
