"""Replica-divergence detection for distributed arrays (counterpart of
``heat_tpu/resilience/guard.py``).

Under the SPMD model a replicated array is an assumption, not a checked
invariant: every rank that holds a copy of the same data is trusted to hold
the same bytes. One diverged copy (bad memory, a kernel that misbehaved on
one card, a silent corruption) poisons every later collective without an
error. This module makes the assumption checkable:

- :func:`fingerprint`: a crc32 digest of every rank's shard (its host
  bytes), grouped by the shard's global offset along the split axis. Ranks
  in one group are replicas and MUST agree. In the port a split array has
  one owner per row, so every group of a split array has one member;
  replicas exist only for ``split=None``, where every rank holds a copy
  (group 0). ``heat_tpu`` reads every device's shard in one process; here
  each rank digests its own and one ``allgather`` of the P (offset, digest)
  pairs gives every rank the same table, so :func:`check` raises the same
  error, naming the same ranks, everywhere.
- :func:`check`: the agreement check (optionally after
  :func:`~heat_tpu_torch.resilience.validate.validate`), raising
  :class:`~heat_tpu_torch.resilience.errors.DivergenceError` naming the
  offending ranks (majority vote in each group; a tie names the group).
- :func:`guarded`: the operation-boundary form, a context manager that
  checks its arrays on entry and on exit, with :meth:`Guard.check` for the
  boundaries in between.

Each shard digest passes the ``guard.shard`` fault point (with the shard's
writable host copy as ``array`` and its replica index), so that
``chaos(divergence=...)`` can change one replica's bytes deterministically
and the detection is testable on the CPU.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import _hooks
from ..core.dndarray import DNDarray
from ..core.sanitation import sanitize_in
from .errors import DivergenceError

__all__ = ["Fingerprint", "fingerprint", "check", "guarded", "Guard"]


@dataclass(frozen=True)
class Fingerprint:
    """The digest table of one DNDarray.

    ``groups`` maps each shard's global offset along the split axis to the
    ``(rank, digest)`` pairs of every rank holding (a copy of) that shard;
    a ``split=None`` array has the one group ``0`` of every rank. Two
    fingerprints of the same values and layout are equal.
    """

    gshape: Tuple[int, ...]
    dtype: str
    split: Optional[int]
    groups: Tuple[Tuple[int, Tuple[Tuple[int, str], ...]], ...]

    def divergent_groups(self) -> List[Tuple[int, Tuple[Tuple[int, str], ...]]]:
        """The replica groups whose digests do not all agree."""
        return [(start, members) for start, members in self.groups if len({d for _, d in members}) > 1]

    def offending_devices(self) -> List[int]:
        """The ranks voted out by their group's majority digest (a tie names
        the whole group: no digest is more trustworthy)."""
        bad: List[int] = []
        for _, members in self.divergent_groups():
            counts: Dict[str, int] = {}
            for _, digest in members:
                counts[digest] = counts.get(digest, 0) + 1
            top = max(counts.values())
            majority = [d for d, c in counts.items() if c == top]
            if len(majority) == 1:
                bad.extend(dev for dev, digest in members if digest != majority[0])
            else:
                bad.extend(dev for dev, _ in members)
        return sorted(set(bad))


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """A writable host copy of a tensor's bytes, in numpy's layout of its
    type (bfloat16 as its 16-bit patterns): the device-to-host copy, or a
    clone of a CPU tensor."""
    h = t.detach().cpu()
    h = h.clone() if h.data_ptr() == t.data_ptr() else h.contiguous()
    return (h.view(torch.int16) if h.dtype == torch.bfloat16 else h).numpy()


def _shard_digest(host: np.ndarray, device_id: int, start: int, replica: int) -> str:
    """crc32 of one shard's host bytes, as ``heat_tpu`` formats it; the
    fault point lets chaos change a non-primary replica's bytes first."""
    _hooks.fault_point("guard.shard", array=host, device=device_id, start=start, replica=replica)
    return f"{zlib.crc32(memoryview(np.ascontiguousarray(host).reshape(-1)).cast('B')) & 0xFFFFFFFF:08x}"


def fingerprint(x: DNDarray) -> Fingerprint:
    """Every rank's shard digest and the replica-group table of ``x``, the
    same on every rank.

    A split array digests each rank's rows under the offset of its ceil-div
    block (a ragged array is rebalanced first, so that offsets key the
    ceil-div map; an empty block digests no bytes); a ``split=None`` array
    digests every rank's copy under group 0.
    One ``allgather`` above one rank.
    """
    sanitize_in(x)
    comm = x.comm
    split = x.split
    if split is not None and x.lcounts is not None:
        x.balance_()
    rank = comm.rank
    if split is None:
        start, replica = 0, rank
    else:  # heat_tpu's key: the offset of the rank's ceil-div block, empty ones too
        start, replica = rank * int(comm.counts_displs_shape(x.gshape, split)[2][split]), 0
    digest = _shard_digest(_host_bytes(x._raw), rank, start, replica)
    rows = [(rank, start, int(digest, 16))]
    if comm.is_distributed():
        local = torch.tensor([rows[0]], dtype=torch.int64, device=comm.device())
        rows = [tuple(int(v) for v in r) for r in comm.allgather(local, 0, [1] * comm.size).tolist()]
    groups: Dict[int, List[Tuple[int, str]]] = {}
    for r, s, d in rows:
        groups.setdefault(s, []).append((r, f"{d:08x}"))
    return Fingerprint(
        gshape=tuple(x.gshape),
        dtype=x.dtype.__name__,
        split=split,
        groups=tuple((s, tuple(members)) for s, members in sorted(groups.items())),
    )


def check(x: DNDarray, *, check_layout: bool = False, check_values: bool = False, label: str = "guarded") -> Fingerprint:
    """Verify that ``x``'s replicas agree; returns the fingerprint.

    Raises :class:`DivergenceError` naming the offending ranks when a group
    disagrees (on every rank alike). ``check_layout=True`` first checks the
    structural invariants (:func:`~heat_tpu_torch.resilience.validate.validate`);
    ``check_values=True`` adds its NaN/Inf scan.
    """
    if check_layout or check_values:
        from .validate import validate

        validate(x, check_values=check_values)
    fp = fingerprint(x)
    divergent = fp.divergent_groups()
    if divergent:
        devices = fp.offending_devices()
        evidence = "; ".join(
            f"shard@{start}: " + ", ".join(f"dev{d}={g}" for d, g in members) for start, members in divergent
        )
        raise DivergenceError(
            f"replica divergence detected at {label!r}: device(s) {devices} "
            f"disagree with their replica group ({evidence}) — a silently "
            f"diverged replica would corrupt every downstream collective",
            devices=devices,
            groups=divergent,
            label=label,
        )
    return fp


class Guard:
    """The active :func:`guarded` context: re-checks arrays at operation
    boundaries. ``check(x)`` verifies one array now (and watches it from
    then on); ``watch(x)`` adds an array to the exit check."""

    def __init__(self, arrays, check_layout: bool, check_values: bool, label: str):
        self._arrays: List[DNDarray] = list(arrays)
        self._check_layout = check_layout
        self._check_values = check_values
        self._label = label

    def watch(self, x: DNDarray) -> DNDarray:
        self._arrays.append(x)
        return x

    def check(self, x: Optional[DNDarray] = None) -> None:
        """Verify one array (or every watched array) at a boundary."""
        targets = self._arrays if x is None else [x]
        for arr in targets:
            check(arr, check_layout=self._check_layout, check_values=self._check_values, label=self._label)
        if x is not None and all(x is not a for a in self._arrays):
            self._arrays.append(x)


class guarded:
    """Context manager verifying replica agreement at operation boundaries::

        with rz.guarded(x, w, check_layout=True) as g:
            y = some_op(x, w)
            g.check(y)          # a boundary inside
        # the exit re-checks x, w, y

    Every watched array is checked on entry and on exit; a disagreement
    raises :class:`DivergenceError` naming the ranks. ``check_layout`` and
    ``check_values`` add :func:`validate`'s checks at each boundary. Each
    check copies every shard to the host: a tool for boundaries one
    chooses, not an always-on monitor.
    """

    def __init__(self, *arrays: DNDarray, check_layout: bool = False, check_values: bool = False,
                 label: str = "guarded"):
        self._guard = Guard(arrays, check_layout, check_values, label)

    def __enter__(self) -> Guard:
        self._guard.check()
        return self._guard

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self._guard.check()
        return False
