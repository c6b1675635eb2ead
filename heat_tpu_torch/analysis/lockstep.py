"""Runtime cross-process collective-lockstep sanitizer (counterpart of
``heat_tpu/analysis/lockstep.py``).

graftflow proves at review time that no visible control flow makes ranks
start different collective sequences; this module is the runtime backstop
for what static analysis cannot see. Every process records a digest of
the collectives it starts, and a cross-check turns "rank 1 skipped an
allgather" from a hang into a :class:`LockstepError` naming the first
divergent site.

Recording rides the observer slot of :mod:`heat_tpu_torch.core._hooks`:
each ``collective.*`` event (every collective the communicator starts, and
the ``collective.*`` fault points) appends one ``(seq, site, fingerprint)``
entry to a bounded ring. The fingerprint is a crc32 of the site and the
scalar context it declares. ``collective.exchange`` is not recorded: a
batch of point-to-point messages has partners that differ from rank to
rank, and a rank with no neighbour to talk to posts none, so its count is
process-local by construction (``heat_tpu`` leaves out
``collective.shard`` for the same reason).

Recording never talks to the network. The check is the one cross-process
step: each process contributes its ``(seq, site_crc, fingerprint)`` rows
through ``ragged_process_allgather`` (the guarded call
``"collective.allgather"``, so under ``resilience.deadlines`` the check
cannot hang), and the first row where any process disagrees names the
divergence::

    with lockstep(deadline=30.0) as ls:
        step(x)
        ls.check()        # the same program point on every rank

``check()`` must be reached by every process. ``check_every=N`` checks
from inside the observer every N events, which is safe only in one
process. Running totals live in :data:`LOCKSTEP_STATS`. The chaos fault
kind ``lockstep_divergence`` drops the newest recorded event on the
injecting process, which is what makes the detector testable on the CPU.
"""
from __future__ import annotations

import zlib
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from ..core import _hooks
from ..resilience.errors import LockstepError

__all__ = ["LOCKSTEP_STATS", "LockstepError", "lockstep", "reset_lockstep_stats"]


# process-lifetime running totals (the lockstep sibling of COMPILE_STATS)
LOCKSTEP_STATS: Dict[str, int] = {
    "events": 0,       # collective events recorded by active sanitizers
    "checks": 0,       # cross-process digest checks performed
    "divergences": 0,  # checks that found ranks out of lockstep
    "dropped": 0,      # events removed by chaos lockstep_divergence faults
}

_STATS_KEYS = tuple(LOCKSTEP_STATS)


def reset_lockstep_stats() -> None:
    """Zero the running totals."""
    for k in _STATS_KEYS:
        LOCKSTEP_STATS[k] = 0


# sites whose hit count is process-local by construction (see module docs)
_EXCLUDED_SITES = frozenset({"collective.exchange"})

# ctx keys that are injection payloads, not collective operands
_PAYLOAD_KEYS = frozenset({"array", "payload"})


def _fingerprint(site: str, ctx: dict) -> int:
    """crc32 over the site id and its scalar context, identical across
    ranks iff the ranks dispatched the same collective on the same
    global operand (shape/split/dtype)."""
    parts = [site]
    for key in sorted(ctx):
        if key in _PAYLOAD_KEYS:
            continue
        value = ctx[key]
        if isinstance(value, np.ndarray):
            parts.append(f"{key}={value.shape}:{value.dtype}")
        elif isinstance(value, (str, bytes, int, float, bool, tuple, type(None))):
            parts.append(f"{key}={value!r}")
        # anything else (callables, file handles) carries no operand info
    return zlib.crc32("|".join(parts).encode()) & 0xFFFFFFFF


def _site_crc(site: str) -> int:
    return zlib.crc32(site.encode()) & 0xFFFFFFFF


# the stack of active sanitizers (innermost last); module-level so the
# chaos ``lockstep_divergence`` fault kind can reach the recorder
_ACTIVE: List["lockstep"] = []


def _drop_last_event() -> bool:
    """Remove the newest recorded event from the innermost active
    sanitizer — the chaos hook simulating "this rank skipped a
    collective". Returns False (fault stays pending) when no sanitizer
    is recording or nothing has been recorded yet."""
    for ls in reversed(_ACTIVE):
        if ls._ring:
            ls._ring.pop()
            ls._seq -= 1
            LOCKSTEP_STATS["dropped"] += 1
            return True
    return False


class lockstep:
    """Context manager recording and cross-checking collective lockstep.

    Parameters
    ----------
    check_every : int, optional
        Auto-check after every N recorded events. Single-process-safe
        only — see the module docs for why multi-process jobs should call
        :meth:`check` explicitly instead.
    check_at_exit : bool
        Run one check when the ``with`` block exits cleanly (default
        True; skipped when the body raised — peers may never reach the
        matching gather).
    deadline : float, optional
        Bound each check with its own :func:`~heat_tpu_torch.resilience.watchdog.
        with_deadline` budget (seconds), independent of any fleet-wide
        ``deadlines`` context.
    capacity : int
        Ring-buffer size; only the newest ``capacity`` events are kept
        (and cross-checked — older history ages out on long jobs).
    """

    def __init__(
        self,
        check_every: Optional[int] = None,
        check_at_exit: bool = True,
        deadline: Optional[float] = None,
        capacity: int = 1024,
    ):
        if check_every is not None and check_every < 1:
            raise ValueError(f"check_every must be >= 1, got {check_every}")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.check_every = check_every
        self.check_at_exit = check_at_exit
        self.deadline = deadline
        self.capacity = capacity
        self._ring: Deque[Tuple[int, str, int]] = deque(maxlen=capacity)
        self._seq = 0
        self._in_check = False

    # -- recording ---------------------------------------------------------
    def _record(self, name: str, ctx: dict) -> None:
        if not name.startswith("collective.") or name in _EXCLUDED_SITES:
            return
        if self._in_check:
            return  # the check's own allgather must not shift the digest
        self._ring.append((self._seq, name, _fingerprint(name, ctx)))
        self._seq += 1
        LOCKSTEP_STATS["events"] += 1
        if self.check_every is not None and self._seq % self.check_every == 0:
            self.check(label=f"every-{self.check_every}")

    @property
    def events(self) -> int:
        """Collective events this sanitizer has recorded (monotonic; ring
        truncation does not rewind it)."""
        return self._seq

    def entries(self) -> List[Tuple[int, str, int]]:
        """Snapshot of the retained ``(seq, site, fingerprint)`` entries."""
        return list(self._ring)

    # -- context management ------------------------------------------------
    def __enter__(self) -> "lockstep":
        self._ring.clear()
        self._seq = 0
        _ACTIVE.append(self)
        _hooks.add_observer(self._record)
        return self

    def __exit__(self, exc_type, exc, tb):
        _hooks.remove_observer(self._record)
        try:
            if exc_type is None and self.check_at_exit:
                self.check(label="exit")
        finally:
            try:
                _ACTIVE.remove(self)
            except ValueError:  # pragma: no cover - defensive
                pass
        return False

    # -- the cross-process check -------------------------------------------
    def _rows(self) -> np.ndarray:
        """Header row ``(-1, total_events, process_index)`` followed by one
        ``(seq, site_crc, fingerprint)`` row per retained entry."""
        from ..core.communication import get_comm

        rows = [(-1, self._seq, get_comm().rank)]
        rows += [(seq, _site_crc(site), fp) for seq, site, fp in self._ring]
        return np.asarray(rows, dtype=np.int64)

    def check(self, label: str = "check") -> None:
        """Cross-check this process's digest against every peer.

        Must be called at the same SPMD program point on every process
        (it gathers). Raises :class:`LockstepError` naming the first
        divergent sequence number and the site THIS process recorded
        there; no-op (beyond counting) in a single-process world.
        """
        if self._in_check:
            return
        LOCKSTEP_STATS["checks"] += 1
        from ..core.communication import get_comm, ragged_process_allgather

        if get_comm().size == 1:
            return

        self._in_check = True
        try:
            gather = ragged_process_allgather
            if self.deadline is not None:
                from ..resilience.watchdog import with_deadline

                gather = with_deadline(gather, self.deadline, "lockstep.check")
            blocks = gather(self._rows(), 0)
        finally:
            self._in_check = False
        self._compare(blocks, label)

    def _compare(self, blocks: List[np.ndarray], label: str) -> None:
        totals = [int(b[0, 1]) for b in blocks]
        # per-process seq -> (site_crc, fingerprint) maps, header dropped
        maps = [
            {int(r[0]): (int(r[1]), int(r[2])) for r in b[1:]} for b in blocks
        ]
        # compare only the window every process still retains: rings may
        # have aged out different prefixes on long jobs
        starts = [min(m) for m in maps if m]
        ends = [max(m) for m in maps if m]
        first_bad = None
        if len(starts) == len(maps) and starts:
            for seq in range(max(starts), min(ends) + 1):
                cells = [m.get(seq) for m in maps]
                if len({c for c in cells if c is not None}) > 1 or None in cells:
                    first_bad = seq
                    break
        if first_bad is None and len(set(totals)) > 1:
            # every retained row matches but the counts differ: the short
            # rank(s) skipped a collective at the end of the window
            first_bad = min(totals)
        if first_bad is None:
            return
        LOCKSTEP_STATS["divergences"] += 1
        from ..core.communication import get_comm

        pid = get_comm().rank
        mine = next((site for seq, site, _ in self._ring if seq == first_bad), "")
        recorded = (
            f"this process recorded {mine!r}"
            if mine
            else "this process recorded no event (it skipped a collective)"
        )
        raise LockstepError(
            f"lockstep divergence at seq {first_bad}: {recorded} while a "
            f"peer disagrees; per-process event counts {totals} "
            f"(label {label!r})",
            seq=first_bad,
            site=mine,
            process_index=pid,
            counts=totals,
            label=label,
        )
