"""The replicated dispatch tick: frame codec + pure plan function
(counterpart of ``heat_tpu/serve/tick.py``, bit for bit).

Above world size 1 the timer and max-batch-count triggers would fire at
different moments on different ranks (wall clocks drift; each rank's
dispatcher sees another prefix of its queue), and the ranks' batches, each
a sequence of collectives, would interleave in different orders. So at an
agreed cadence every rank encodes its local queue view into one
fixed-width int64 frame (:func:`encode_frame`), exchanges it with
:func:`heat_tpu_torch.core.communication.replicated_frame` (one
``allgather`` over the base group; every rank receives the same
``(world, FRAME_WIDTH)`` array), and runs :func:`plan_dispatch` over the
gathered frames. ``plan_dispatch`` is a PURE function of the gathered
array and static policy numbers (no clocks, no queue access, no
randomness), so its :class:`TickPlan` is the same on every rank, and the
same frames give the same plan in this package and in ``heat_tpu``.

Why min-over-ranks prefix lengths are safe: every process submits the
same requests in the same order, and every resolution (dispatch, shed,
call) is tick-decided, so each rank's pending queue is a contiguous prefix
window of the same global submit sequence; for a bucket key ``k`` one
rank's pending ``k``-requests are a prefix of another's, and dispatching
the first ``min``-over-ranks ``count(k)`` requests of ``k`` selects the
same requests on every rank. The per-key ``first_seq`` values agree
wherever the key is reported, giving one global FIFO order; keys beyond
the ``BUCKET_CAP`` report window carry larger ``first_seq`` than every
reported key, so capped reporting stays consistent and progresses
oldest-first.

The same frame carries two more decisions, so one heartbeat replaces
three ``allgather`` calls: the health monitor's probe exports (failed ids
and EWMA samples, applied through ``HealthMonitor.apply_gathered`` when
every rank reports due) and the autoscaler's grow votes
(``Autoscaler.pre_vote`` pairs, resolved against the freshly applied
health report).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "FRAME_WIDTH",
    "BUCKET_CAP",
    "SHED_CAP",
    "TickPlan",
    "bucket_token",
    "encode_frame",
    "plan_dispatch",
]

# ---------------------------------------------------------------- layout
# header cells
H_SEQ = 0         # data requests accepted ever (the next seq to assign)
H_CLOSED = 1      # 1 once close() ran
H_QLEN = 2        # pending items, requests AND calls (0 = drained)
H_NPEND = 3       # pending requests BEFORE the first pending call
H_HAVE_CALL = 4   # 1 if a control call is pending
H_MON_DUE = 5     # 1 monitor locally due, 0 not due, -1 no monitor
H_VOTE_PRESSURE = 6  # autoscale pre_vote()[0]; -1 no autoscaler
H_VOTE_READY = 7     # autoscale pre_vote()[1]; -1 no autoscaler
_HDR = 8

# per-bucket records: (token, pending requests, pending rows,
# oldest-member age µs, first member's seq)
BUCKET_CAP = 16
_B_CELLS = 5
_B_OFF = _HDR

# deadline-expired pending seqs, -1 padded
SHED_CAP = 32
_S_OFF = _B_OFF + BUCKET_CAP * _B_CELLS

# piggybacked health-monitor probe export: locally-failed device ids
# (-1 padded) and (device id, EWMA µs) pairs — quantization matches
# HealthMonitor's health frame: int(round(ms * 1000.0))
MON_FAIL_CAP = 64
_F_OFF = _S_OFF + SHED_CAP
MON_EWMA_CAP = 64
_E_OFF = _F_OFF + MON_FAIL_CAP

FRAME_WIDTH = _E_OFF + MON_EWMA_CAP * 2


def bucket_token(key) -> int:
    """Deterministic cross-process token for a bucket key (endpoint,
    per-row shape, dtype str). Python's builtin ``hash`` is salted per
    process (PYTHONHASHSEED), so it would diverge across ranks; a
    truncated blake2b of the key's repr is stable everywhere."""
    digest = hashlib.blake2b(repr(key).encode("utf-8"), digest_size=8).digest()
    return int.from_bytes(digest, "big") >> 1  # non-negative, fits int64


def encode_frame(
    *,
    seq: int,
    closed: bool,
    qlen: int,
    npending: int,
    have_call: bool,
    buckets: Sequence[Tuple[int, int, int, int, int]],
    shed: Sequence[int] = (),
    mon_due: Optional[bool] = None,
    mon_failed: Sequence[int] = (),
    mon_ewmas_us: Sequence[Tuple[int, int]] = (),
    votes: Optional[Tuple[bool, bool]] = None,
) -> np.ndarray:
    """Pack one rank's queue view into the fixed-width int64 frame.

    ``buckets`` holds ``(token, count, rows, age_us, first_seq)``
    records; past :data:`BUCKET_CAP` the caller must keep the
    smallest-``first_seq`` records (oldest keys first — see the module
    docstring for why that stays rank-consistent). ``shed`` holds the
    seqs of deadline-expired pending requests (oldest first, capped at
    :data:`SHED_CAP`); ``mon_due``/``mon_failed``/``mon_ewmas_us`` carry
    the health monitor's local probe export when it is due, and
    ``votes`` the autoscaler's ``pre_vote`` pair."""
    frame = np.full(FRAME_WIDTH, -1, dtype=np.int64)
    frame[H_SEQ] = int(seq)
    frame[H_CLOSED] = int(bool(closed))
    frame[H_QLEN] = int(qlen)
    frame[H_NPEND] = int(npending)
    frame[H_HAVE_CALL] = int(bool(have_call))
    frame[H_MON_DUE] = -1 if mon_due is None else int(bool(mon_due))
    if votes is not None:
        frame[H_VOTE_PRESSURE] = int(bool(votes[0]))
        frame[H_VOTE_READY] = int(bool(votes[1]))
    records = sorted(buckets, key=lambda r: r[4])[:BUCKET_CAP]
    for i, (token, count, rows, age_us, first_seq) in enumerate(records):
        base = _B_OFF + i * _B_CELLS
        frame[base:base + _B_CELLS] = (
            int(token), int(count), int(rows), int(age_us), int(first_seq)
        )
    for i, s in enumerate(sorted(shed)[:SHED_CAP]):
        frame[_S_OFF + i] = int(s)
    for i, dev in enumerate(sorted(mon_failed)[:MON_FAIL_CAP]):
        frame[_F_OFF + i] = int(dev)
    for i, (dev, us) in enumerate(sorted(mon_ewmas_us)[:MON_EWMA_CAP]):
        base = _E_OFF + i * 2
        frame[base] = int(dev)
        frame[base + 1] = int(us)
    return frame


@dataclass(frozen=True)
class TickPlan:
    """One tick's replicated verdict — a pure function of the gathered
    frames, identical on every rank.

    ``dispatch`` lists ``(token, n_requests)`` in global FIFO order:
    each rank takes the first ``n_requests`` pending requests of that
    bucket key (counted BEFORE shed removal), drops the ``shed``
    members, and dispatches the rest in ``max_batch``-row chunks.
    ``shed`` seqs are answered with ``ServeDeadlineError`` everywhere —
    tick-decided deadline shedding, the promotion from ws1-only.
    ``run_call`` fires only when every rank's pre-call segment empties
    under this plan, so the call executes at the same queue position on
    every rank. ``quit`` means every rank is closed and drained.
    ``monitor_tick`` + ``mon_failed``/``mon_ewmas_us`` and the two grow
    flags carry the piggybacked health/autoscale decisions."""

    dispatch: Tuple[Tuple[int, int], ...]
    shed: frozenset
    run_call: bool
    quit: bool
    monitor_tick: bool
    mon_failed: Tuple[int, ...]
    mon_ewmas_us: Tuple[Tuple[int, int], ...]
    grow_pressure: bool
    grow_ready: bool


def plan_dispatch(
    gathered: np.ndarray,
    *,
    max_batch_rows: int,
    max_latency_us: int,
) -> TickPlan:
    """Derive the tick's plan from the gathered ``(nproc, FRAME_WIDTH)``
    frames. Pure: no clocks, no queue access — every rank computes the
    identical plan, which is the whole point.

    Trigger rules per bucket key (mirroring the ws1 async triggers, but
    over replicated numbers): dispatch ``min``-over-ranks pending count
    when that min is >= 1 AND (forced, or the ``max``-over-ranks oldest
    age reached the latency bound, or the ``min``-over-ranks pending
    rows reached ``max_batch_rows``). Forced means a control call is
    pending somewhere (hurry the segment out so the barrier can run) or
    every rank closed (drain)."""
    frames = np.asarray(gathered, dtype=np.int64)
    if frames.ndim != 2 or frames.shape[1] != FRAME_WIDTH:
        raise ValueError(f"expected (nproc, {FRAME_WIDTH}), got {frames.shape}")
    closed_all = bool((frames[:, H_CLOSED] == 1).all())
    have_call_any = bool((frames[:, H_HAVE_CALL] == 1).any())
    have_call_all = bool((frames[:, H_HAVE_CALL] == 1).all())
    min_seq = int(frames[:, H_SEQ].min())
    force = closed_all or have_call_any

    # shed: any rank's clock says expired, every rank has accepted it
    shed = frozenset(
        int(s) for s in frames[:, _S_OFF:_S_OFF + SHED_CAP].ravel()
        if 0 <= s < min_seq
    )

    # bucket records per rank, keyed by token
    per_rank: List[Dict[int, Tuple[int, int, int, int]]] = []
    for frame in frames:
        records: Dict[int, Tuple[int, int, int, int]] = {}
        for i in range(BUCKET_CAP):
            base = _B_OFF + i * _B_CELLS
            token = int(frame[base])
            if token < 0:
                continue
            records[token] = (
                int(frame[base + 1]), int(frame[base + 2]),
                int(frame[base + 3]), int(frame[base + 4]),
            )
        per_rank.append(records)
    tokens = set()
    for records in per_rank:
        tokens.update(records)
    chosen: List[Tuple[int, int, int]] = []  # (first_seq, token, n)
    planned_total = 0
    for token in tokens:
        hits = [records[token] for records in per_rank if token in records]
        n = min(
            (records[token][0] if token in records else 0)
            for records in per_rank
        )
        if n < 1:
            continue
        rows_min = min(h[1] for h in hits)
        age_max = max(h[2] for h in hits)
        first_seq = min(h[3] for h in hits)
        if force or age_max >= max_latency_us or rows_min >= max_batch_rows:
            chosen.append((first_seq, token, n))
            planned_total += n
    chosen.sort()  # global FIFO: oldest first_seq dispatches first

    # the call runs only when this plan empties EVERY rank's pre-call
    # segment (identical segments when all ranks hold the call; the
    # equality check catches BUCKET_CAP overflow, which defers the call
    # one tick while the oldest keys drain)
    run_call = have_call_all and bool(
        (frames[:, H_NPEND] == planned_total).all()
    )
    quit_ = closed_all and bool((frames[:, H_QLEN] == 0).all())

    monitor_tick = bool((frames[:, H_MON_DUE] == 1).all())
    mon_failed: Tuple[int, ...] = ()
    mon_ewmas: Tuple[Tuple[int, int], ...] = ()
    if monitor_tick:
        mon_failed = tuple(sorted({
            int(d) for d in frames[:, _F_OFF:_F_OFF + MON_FAIL_CAP].ravel()
            if d >= 0
        }))
        merged: Dict[int, int] = {}
        for frame in frames:  # rank order, matching the health frame's merge
            pairs = frame[_E_OFF:].reshape(MON_EWMA_CAP, 2)
            for dev, us in pairs:
                if dev >= 0:
                    merged[int(dev)] = int(us)
        mon_ewmas = tuple(sorted(merged.items()))
    grow_pressure = monitor_tick and bool(
        (frames[:, H_VOTE_PRESSURE] == 1).any()
    )
    grow_ready = monitor_tick and bool((frames[:, H_VOTE_READY] == 1).any())

    return TickPlan(
        dispatch=tuple((token, n) for _, token, n in chosen),
        shed=shed,
        run_call=run_call,
        quit=quit_,
        monitor_tick=monitor_tick,
        mon_failed=mon_failed,
        mon_ewmas_us=mon_ewmas,
        grow_pressure=grow_pressure,
        grow_ready=grow_ready,
    )
