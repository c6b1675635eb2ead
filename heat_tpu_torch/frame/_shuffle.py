"""The sort-based shuffle under the frame layer (counterpart of
``heat_tpu/frame/_shuffle.py``).

A shuffle moves every row to the rank that owns its key, so that a per-key
computation (groupby aggregation, join, value counts) becomes local to
each rank afterwards. Each verb is three steps on this rank's rows:

1. **plan**: a stable local sort by key, a reduction of each run of equal
   keys into one *partial* row per distinct local key (the combiner: at low
   cardinality almost nothing moves), the destination rank of each partial
   (range splitters elected from samples of every rank's keys, or a
   multiplicative hash), a stable sort by destination, and one
   ``allgather`` of each rank's P destination counts into the P x P bucket
   matrix (row = source, column = destination), read on the host;
2. **exchange**: one :func:`heat_tpu_torch.parallel.flatmove.bucket_move`
   per operand (the keys and each carried column), counted in
   ``MOVE_STATS``; no per-key traffic;
3. **merge**: a stable sort of the received partials by key and a
   reduction of each run with each statistic's associative combiner (sums
   and counts add, minima take the minimum, maxima the maximum), then one
   ``allgather`` of every rank's group count (the result's ``lcounts``).

``heat_tpu`` runs each step as one program over padded buffers with a
``counts`` mask; here a rank holds exactly its rows, so masks are lengths
and nothing is padded. Every partition decision derives from gathered,
hence replicated, values, so every rank takes the same branches.

Runs of equal keys are reduced deterministically, the statistics that
share a combiner and a type stacked into one (n, S) tensor and reduced by
one call: float sums, minima and maxima with ``torch.segment_reduce`` over
the run lengths (on the card one thread walks a run and column in order;
where runs are long, more than ``_SHORT_RUN`` rows on average, a column
at a time, one block a run, in a fixed order), integer sums as
differences of one wrapping ``cumsum`` (the ``scan_axis`` kernel on the
card; exact modulo 2^bits, as ``jnp``'s integer sums wrap), integer minima and maxima with ``scatter_reduce``
(whose result does not depend on the order). No float sum uses atomics.

Keys order as ``torch.sort(stable=True)`` orders them: NaN last, ``-0.0``
and ``0.0`` equal. Runs compare with ``!=``, so ``-0.0`` and ``0.0`` form
one group and every NaN is a group of its own (pass integer keys for
pandas-like grouping). A group's key is its last row's, in the order the
stable sort leaves equal keys (``heat_tpu``'s scatter of every row onto its
group leaves the last). ``-0.0`` and ``0.0`` hash alike. Bool keys sort
as int8.

Range splitters are elected from 32 *evenly spaced* samples of each rank's
sorted keys, ``(i * n) // 32`` for ``i < 32``, as ``heat_tpu``'s docstring
promises; ``heat_tpu``'s index reduces to ``i``, so its samples are each
rank's 32 smallest keys (``ROADMAP.md``, Queue C, C6). Keys, values and the
global key order are the same; only the ranks' shares differ above one
rank.

Collectives and host reads per verb (P ranks, S carried statistics):

- groupby: (range mode) one ``allgather`` of P x 32 samples; one
  ``allgather`` of the P x P matrix and its host read; 1 + S bucket moves;
  one ``allgather`` of the group counts and its host read;
- join: (range mode) one ``allgather`` of P x 64 samples of both sides;
  per side one ``allgather`` of its matrix, its host read and one bucket
  move per column (key included); one ``allreduce`` of the duplicate-key
  flag and one ``allgather`` of the row counts, each read on the host;
- filter: no exchange; one ``allgather`` of the kept counts, read on the
  host.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.dndarray import DNDarray
from ..core.kernels.scan import scan_axis
from ..parallel.flatmove import bucket_move

__all__ = [
    "SHUFFLE_STATS",
    "STAT_COMBINE",
    "compact_rows",
    "groupby_reduce",
    "hash_join",
    "shard_counts",
    "shuffle_rows",
]

# running counters: tests read these beside MOVE_STATS to hold the engine to
# its exchange budget
SHUFFLE_STATS = {"groupbys": 0, "joins": 0, "compactions": 0}

# how each statistic folds in the merge (all associative)
STAT_COMBINE = {"sum": "sum", "sumsq": "sum", "count": "sum", "min": "min", "max": "max"}

# rows a run holds on average up to which float runs are reduced as (n, S) stacks, one thread a run and column;
# longer runs take one block a run (1-D segment_reduce), a call a column
_SHORT_RUN = 64

# samples per rank in the splitter election (a sample sort with s samples per
# rank bounds the heaviest partition by about n/P * (1 + 1/s))
_OVERSAMPLE = 32


def shard_counts(col: DNDarray) -> Tuple[int, ...]:
    """Every rank's rows of a split-0 column: ``lcounts`` for a ragged
    layout, the ceil-div map otherwise. Metadata only."""
    if col.lcounts is not None:
        return tuple(int(c) for c in col.lcounts)
    return tuple(int(c) for c in col.comm.counts_displs_shape(col.gshape, 0)[0])


# --------------------------------------------------------------- local pieces
def _sortable(keys: torch.Tensor) -> torch.Tensor:
    return keys.to(torch.int8) if keys.dtype == torch.bool else keys


def _max_key(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf")
    if dtype == torch.bool:
        return 1  # as int8
    return torch.iinfo(dtype).max


def _sorted(keys: torch.Tensor) -> torch.Tensor:
    return keys[torch.sort(_sortable(keys), stable=True).indices]


def _sort_by_key(keys: torch.Tensor, payloads: Sequence[torch.Tensor]):
    """Stable local sort by key: (sorted keys, sorted payloads)."""
    perm = torch.sort(_sortable(keys), stable=True).indices
    return keys[perm], [v[perm] for v in payloads]


def _runs(sorted_keys: torch.Tensor):
    """(starts, lengths) of the runs of equal keys in a sorted block (``!=``:
    every NaN starts a run of its own)."""
    n = sorted_keys.shape[0]
    dev = sorted_keys.device
    if n == 0:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return empty, empty
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    is_start[1:] = sorted_keys[1:] != sorted_keys[:-1]
    starts = torch.nonzero(is_start).reshape(-1)
    ends = torch.cat([starts[1:], torch.tensor([n], dtype=torch.int64, device=dev)])
    return starts, ends - starts


def _reduce_runs(combine: str, data: torch.Tensor, starts: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """One row per run of ``data`` ((n,) or (n, S), sorted with its keys):
    each column's sum, minimum or maximum over the run, deterministically
    (see the module's docstring)."""
    if lengths.numel() == 0:
        return data[:0]
    if data.dtype.is_floating_point:
        # on the card, 2-D data takes one thread a run and column, 1-D data one block a run
        return torch.segment_reduce(data, combine, lengths=lengths, axis=0, unsafe=True)
    if combine == "sum":
        c = torch.zeros((data.shape[0] + 1,) + data.shape[1:], dtype=data.dtype, device=data.device)
        c[1:] = scan_axis(data, 0, "add")  # wraps, so the differences are exact
        return c[starts + lengths] - c[starts]
    seg = torch.repeat_interleave(torch.arange(lengths.shape[0], device=data.device), lengths)
    wide = data.to(torch.int8) if data.dtype == torch.bool else data
    out = torch.empty((lengths.shape[0],) + data.shape[1:], dtype=wide.dtype, device=data.device)
    seg = seg.view((-1,) + (1,) * (wide.dim() - 1)).expand_as(wide)
    out = out.scatter_reduce(0, seg, wide, "amin" if combine == "min" else "amax", include_self=False)
    return out.to(data.dtype)


def _reduce_stats(combines: Sequence[str], cols: Sequence[torch.Tensor], starts: torch.Tensor,
                  lengths: torch.Tensor) -> List[torch.Tensor]:
    """Each column of ``cols`` reduced over the runs with its combiner: the
    columns that share a combiner and a type are stacked into one (n, S)
    tensor and reduced by one call, but for float runs longer than
    ``_SHORT_RUN`` rows on average, reduced a column at a time."""
    stacks = {}
    for i, (combine, col) in enumerate(zip(combines, cols)):
        stacks.setdefault((combine, col.dtype), []).append(i)
    out: List[Optional[torch.Tensor]] = [None] * len(cols)
    long_runs = lengths.numel() * _SHORT_RUN < (cols[0].shape[0] if cols else 0)
    for (combine, dtype), idx in stacks.items():
        if long_runs and dtype.is_floating_point:
            for i in idx:
                out[i] = _reduce_runs(combine, cols[i], starts, lengths)
            continue
        # stacked as rows, then transposed: a copy into (n, S) columns is far slower
        red = _reduce_runs(combine, torch.stack([cols[i] for i in idx]).T.contiguous(), starts, lengths)
        for i, col in zip(idx, red.T.contiguous()):
            out[i] = col
    return out


def _hash_pid(keys: torch.Tensor, p: int) -> torch.Tensor:
    """Destination rank of each key under multiplicative hashing, in uint32
    arithmetic with wraparound (int64 masked to 32 bits): ``(b * 2654435761)
    ^ (b >> 13) mod P`` of the key's bits ``b`` (float64: the low 32 bits of
    its pattern; the other floats widened to float32 first; ``-0.0`` as
    ``0.0``; integers and bools as uint32)."""
    mask = 0xFFFFFFFF
    if keys.dtype.is_floating_point:
        z = torch.where(keys == 0, torch.zeros_like(keys), keys)
        if keys.dtype == torch.float64:
            bits = z.view(torch.int64) & mask
        else:
            bits = z.to(torch.float32).view(torch.int32).to(torch.int64) & mask
    else:
        bits = keys.to(torch.int64) & mask
    h = ((bits * 2654435761) & mask) ^ (bits >> 13)
    return h % p


def _range_pid(keys: torch.Tensor, splitters: torch.Tensor) -> torch.Tensor:
    """Destination rank under elected range splitters (sorted, P - 1 of
    them): equal keys go to one rank, the ranks cover contiguous key ranges
    in rank order, NaN goes last."""
    return torch.searchsorted(splitters, _sortable(keys).contiguous(), right=True)


def _samples(sorted_keys: torch.Tensor) -> torch.Tensor:
    """32 evenly spaced samples of a sorted key block, ``(i * n) // 32``;
    the largest key of the type where the block is empty."""
    n = sorted_keys.shape[0]
    k = _sortable(sorted_keys)
    if n == 0:
        return torch.full((_OVERSAMPLE,), _max_key(sorted_keys.dtype), dtype=k.dtype, device=k.device)
    idx = (torch.arange(_OVERSAMPLE, device=k.device) * n) // _OVERSAMPLE
    return k[idx]


def _elect(sorted_blocks: Sequence[torch.Tensor], comm) -> torch.Tensor:
    """The P - 1 range splitters from every rank's samples of its sorted key
    blocks: one ``allgather``, a sort, the P - 1 quantiles. Every rank
    computes the same splitters."""
    p = comm.size
    local = torch.cat([_samples(b) for b in sorted_blocks])
    g = comm.allgather(local.unsqueeze(0), 0, [1] * p).reshape(-1)
    gs = torch.sort(g).values
    pos = (torch.arange(1, p, device=gs.device) * gs.shape[0]) // p
    return gs[pos]


def _destinations(sorted_keys: torch.Tensor, mode: str, splitters: Optional[torch.Tensor], comm):
    """(destination-major order of the rows, the host P x P bucket matrix):
    one ``allgather`` of this rank's P destination counts and its host read."""
    p = comm.size
    dev = sorted_keys.device
    if p == 1:
        order = torch.arange(sorted_keys.shape[0], device=dev)
        return order, np.asarray([[sorted_keys.shape[0]]], dtype=np.int64)
    pid = _range_pid(sorted_keys, splitters) if mode == "range" else _hash_pid(sorted_keys, p)
    order = torch.sort(pid, stable=True).indices
    row = torch.bincount(pid, minlength=p).to(torch.int64)
    mat = comm.allgather(row.unsqueeze(0), 0, [1] * p)
    return order, mat.cpu().numpy()


def _exchange_operands(bufs: List[torch.Tensor], mat: np.ndarray, comm) -> List[torch.Tensor]:
    """One bucket move per operand over the shared matrix."""
    return [bucket_move(b, 0, mat.tolist(), comm) for b in bufs]


def _gather_counts(n: int, comm, dev) -> Tuple[int, ...]:
    """Every rank's ``n`` on every rank: one ``allgather`` and its host read."""
    t = torch.tensor([[int(n)]], dtype=torch.int64, device=dev)
    return tuple(int(c) for c in comm.allgather(t, 0, [1] * comm.size).reshape(-1).tolist())


def _stat_data(kind: str, ci: int, odt: torch.dtype, values: Sequence[torch.Tensor]) -> torch.Tensor:
    v = values[ci].to(odt)
    return v * v if kind == "sumsq" else v


# ------------------------------------------------------------------ the verbs
def groupby_reduce(
    key_col: DNDarray,
    value_bufs: List[torch.Tensor],
    stats: Tuple[Tuple[str, int, torch.dtype], ...],
    mode: str = "range",
) -> Tuple[DNDarray, List[DNDarray], int]:
    """Distributed groupby: this rank's runs reduced into partials, one
    bucket move per operand, the received partials merged. Returns (the
    distinct keys, one reduced column per statistic, the number of groups),
    co-aligned in one ragged split-0 layout; in range mode the keys are in
    global sorted order.

    ``stats`` holds ``(kind, value_index, out_dtype)`` with ``kind`` in
    sum, sumsq, count, min, max (count ignores the index); ``value_bufs``
    are this rank's rows of the value columns, as ``key_col._raw``."""
    if mode not in ("range", "hash"):
        raise ValueError(f"mode must be 'range' or 'hash', got {mode!r}")
    comm = key_col.comm
    keys = key_col._raw
    dev = keys.device
    # ---- plan
    sk, svals = _sort_by_key(keys, value_bufs)
    starts, lengths = _runs(sk)
    ukeys = sk[starts + lengths - 1]
    reduced = [i for i, (kind, _, _) in enumerate(stats) if kind != "count"]
    parts = [lengths.to(odt) if kind == "count" else None for kind, _, odt in stats]
    for i, t in zip(reduced, _reduce_stats([STAT_COMBINE[stats[i][0]] for i in reduced],
                                           [_stat_data(*stats[i], svals) for i in reduced], starts, lengths)):
        parts[i] = t
    splitters = _elect([ukeys], comm) if mode == "range" and comm.size > 1 else None
    order, mat = _destinations(ukeys, mode, splitters, comm)
    # ---- exchange
    moved = _exchange_operands([ukeys[order]] + [s[order] for s in parts], mat, comm)
    # ---- merge
    mk, mparts = _sort_by_key(moved[0], moved[1:])
    starts, lengths = _runs(mk)
    gkeys = mk[starts + lengths - 1]
    outs = _reduce_stats([STAT_COMBINE[kind] for kind, _, _ in stats], mparts, starts, lengths)
    gvec = _gather_counts(gkeys.shape[0], comm, dev)
    n_groups = sum(gvec)

    def wrap(t):
        return DNDarray._from_ragged(t, (n_groups,), None, 0, gvec, device=key_col.device, comm=comm)

    SHUFFLE_STATS["groupbys"] += 1
    return wrap(gkeys), [wrap(t) for t in outs], n_groups


def shuffle_rows(
    key_col: DNDarray,
    payload_bufs: List[torch.Tensor],
    mode: str = "range",
    splitters: Optional[torch.Tensor] = None,
) -> List[torch.Tensor]:
    """Every row moved to the rank of its key, without combining: the
    received ``[key, *payload]`` rows. Pass ``splitters`` to reuse an
    election (both sides of a join agree)."""
    comm = key_col.comm
    sk, svals = _sort_by_key(key_col._raw, payload_bufs)
    if mode == "range" and splitters is None and comm.size > 1:
        splitters = _elect([sk], comm)
    order, mat = _destinations(sk, mode, splitters, comm)
    return _exchange_operands([sk[order]] + [v[order] for v in svals], mat, comm)


def _jnp_float_dtype(dtype: torch.dtype) -> torch.dtype:
    """``jnp.promote_types(dtype, float32)``: float64 stays, the rest float32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def hash_join(
    l_key: DNDarray,
    l_bufs: List[torch.Tensor],
    r_key: DNDarray,
    r_bufs: List[torch.Tensor],
    how: str = "inner",
    mode: str = "range",
) -> Tuple[List[torch.Tensor], Tuple[int, ...], bool]:
    """Distributed join: both sides partitioned by one shared election, one
    bucket move per column of each side, then a local merge join. Right keys
    must be unique (m:1). Returns (this rank's ``[key, *left, *right]`` rows
    in key order, every rank's row count, whether any right key repeats).
    A left join's right columns become float and take NaN where no right
    row matches."""
    if how not in ("inner", "left"):
        raise ValueError(f"how must be 'inner' or 'left', got {how!r}")
    comm = l_key.comm
    splitters = None
    if mode == "range" and comm.size > 1:
        splitters = _elect([_sorted(l_key._raw), _sorted(r_key._raw)], comm)
    l_moved = shuffle_rows(l_key, l_bufs, mode, splitters)
    r_moved = shuffle_rows(r_key, r_bufs, mode, splitters)
    lk, lv = _sort_by_key(l_moved[0], l_moved[1:])
    rk, rv = _sort_by_key(r_moved[0], r_moved[1:])
    nr = rk.shape[0]
    dup_local = bool(nr > 1 and bool((rk[1:] == rk[:-1]).any()))
    dup = comm.allreduce(torch.tensor([int(dup_local)], dtype=torch.int32, device=lk.device), "max")
    if nr:
        idx = torch.searchsorted(_sortable(rk).contiguous(), _sortable(lk).contiguous(), right=False)
        idxc = torch.clamp(idx, 0, nr - 1)
        hit = (idx < nr) & (rk[idxc] == lk)
        gathered = [v[idxc] for v in rv]
    else:
        hit = torch.zeros(lk.shape[0], dtype=torch.bool, device=lk.device)
        gathered = [v.new_zeros((lk.shape[0],) + tuple(v.shape[1:])) for v in rv]
    if how == "inner":
        outs = [lk[hit]] + [v[hit] for v in lv] + [v[hit] for v in gathered]
    else:
        filled = []
        for v in gathered:
            fv = v.to(_jnp_float_dtype(v.dtype))
            filled.append(torch.where(hit, fv, torch.full_like(fv, float("nan"))))
        outs = [lk] + list(lv) + filled
    gvec = _gather_counts(outs[0].shape[0], comm, lk.device)
    SHUFFLE_STATS["joins"] += 1
    return outs, gvec, bool(int(dup.reshape(-1)[0]))


def compact_rows(mask: torch.Tensor, col_bufs: List[torch.Tensor], comm) -> Tuple[List[torch.Tensor], Tuple[int, ...]]:
    """A filter on this rank's rows (no exchange): the kept rows of every
    column in order, and every rank's kept count."""
    outs = [c[mask] for c in col_bufs]
    gvec = _gather_counts(int(mask.sum()), comm, mask.device)
    SHUFFLE_STATS["compactions"] += 1
    return outs, gvec
