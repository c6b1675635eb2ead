"""Expression graph of the lazy layer (counterpart of
``heat_tpu/core/lazy/graph.py``).

A captured op becomes a :class:`Node`; its operands are other nodes
(pending results), :class:`Leaf` snapshots of concrete tensors, or Python
scalars. Every node carries its full layout (:class:`NodeMeta`), inferred
at capture by running the port's own dispatcher on ``meta`` tensors
(:mod:`.evaluate`), so ``.shape``/``.dtype``/``.lshape_map`` of a pending
result never force it.

A plan is cached by a *signature*: the graph serialized in topological
order (op identities, tokenized statics, operand wiring), the leaves'
layouts and the communicator. The layout token holds global metadata only
(global shape, heat type, split, ragged counts), so every rank keys, and
plans, the same graph the same way. Scalars are tokenized by type and
value (floats by ``float.hex``, so a NaN keys one way); ops key by
identity, and per-call closures are declined at capture.
"""
from __future__ import annotations

import itertools
import threading
from typing import Any, Optional, Tuple

__all__ = ["FUSE_STATS", "reset_fuse_stats", "stats_inc", "NodeMeta", "Leaf", "Node", "scalar_token"]

# Counters of the lazy layer (``heat_tpu``'s names and meanings):
# - ``graphs_captured``   graphs planned anew (plan-cache misses);
# - ``fused_dispatches``  plan executions (a warm chain is exactly one);
# - ``cache_hits``        executions served by a cached plan;
# - ``eager_fallbacks``   ops in a scope that were declined, plus pending
#                         results forced mid-scope (``.numpy()``, indexing, ...);
# - ``cse_hits``          plan-cache misses that reused the cached plan of a
#                         prefix shared with an earlier chain.
FUSE_STATS = {
    "graphs_captured": 0,
    "fused_dispatches": 0,
    "eager_fallbacks": 0,
    "cache_hits": 0,
    "cse_hits": 0,
}

# FUSE_STATS is written from every capturing thread; += is a read-modify-write
_STATS_LOCK = threading.Lock()


def stats_inc(key: str, n: int = 1) -> None:
    """Thread-safe FUSE_STATS increment (the only writer)."""
    with _STATS_LOCK:
        FUSE_STATS[key] += n


def reset_fuse_stats() -> None:
    """Zero every FUSE_STATS counter."""
    with _STATS_LOCK:
        for k in FUSE_STATS:
            FUSE_STATS[k] = 0


# next() on itertools.count is atomic in CPython: unique sequence numbers across threads
_seq = itertools.count()


class NodeMeta:
    """Layout of a pending or concrete DNDarray. ``lshape`` is this rank's
    tensor shape; :attr:`token` leaves it out (it follows from the rest and
    the rank), so signatures agree across ranks."""

    __slots__ = ("gshape", "dtype", "split", "lcounts", "lshape", "device", "comm")

    def __init__(self, gshape, dtype, split, lcounts, lshape, device, comm):
        self.gshape = tuple(gshape)
        self.dtype = dtype
        self.split = split
        self.lcounts = None if lcounts is None else tuple(lcounts)
        self.lshape = tuple(lshape)
        self.device = device
        self.comm = comm

    @property
    def token(self) -> Tuple:
        return (self.gshape, self.dtype, self.split, self.lcounts)

    @property
    def layout(self) -> Tuple:
        """What fixes this rank's chunk: two values of one layout have the
        same local shape on every rank."""
        return (self.gshape, self.split, self.lcounts)

    @classmethod
    def of(cls, x) -> "NodeMeta":
        """Snapshot a DNDarray's layout (a pending one answers from its
        node's metadata without forcing)."""
        # graftflow: F002 - lcounts is replicated layout metadata, the same tuple on every rank
        return cls(x.gshape, x.dtype, x.split, x.lcounts, x.lshape, x.device, x.comm)


class Leaf:
    """A concrete operand: its tensor at capture time, the tensor's version
    counter then, and its layout. Evaluation refuses a tensor changed in
    place since (its version moved on)."""

    __slots__ = ("buffer", "version", "meta")

    def __init__(self, buffer, meta: NodeMeta):
        self.buffer = buffer
        self.version = None if buffer.is_inference() else buffer._version
        self.meta = meta


class Node:
    """One captured dispatcher call: ``kind`` (``"binary"``, ``"local"``,
    ``"reduce"``, ``"cum"``, ``"matmul"``, ``"argreduce"``, ``"moment"``),
    the op, the operand wiring as ``("node", Node) | ("leaf", Leaf) |
    ("scalar", value)`` pairs, the statics as the dispatcher took them and
    their hashable tokens, and the inferred layout. ``buffer`` is set by
    evaluation; ``ref`` weakly tracks the LazyDNDarray of this node."""

    __slots__ = ("seq", "kind", "op", "inputs", "statics", "sig_statics", "meta", "buffer", "ref",
                 "__weakref__")

    def __init__(self, kind, op, inputs, statics, sig_statics, meta):
        self.seq = next(_seq)
        self.kind = kind
        self.op = op
        self.inputs = tuple(inputs)
        self.statics = statics
        self.sig_statics = sig_statics
        self.meta = meta
        self.buffer = None
        self.ref = None

    def release_inputs(self) -> None:
        """Drop the operand wiring once ``buffer`` is set: an evaluated node
        is a leaf to any later graph."""
        self.inputs = ()


def scalar_token(v) -> Optional[Tuple[str, Any]]:
    """Hashable, value-faithful token of a scalar operand, or None. The type
    enters it, as promotion depends on it; floats key by ``hex()``."""
    if isinstance(v, bool):
        return ("bool", v)
    if isinstance(v, int):
        return ("int", v)
    if isinstance(v, float):
        return ("float", v.hex())
    if isinstance(v, complex):
        return ("complex", v.real.hex(), v.imag.hex())
    import numpy as np

    if isinstance(v, np.bool_):
        return ("np.bool_", bool(v))
    if isinstance(v, np.integer):
        return (type(v).__name__, int(v))
    if isinstance(v, np.floating):
        return (type(v).__name__, float(v).hex())
    if isinstance(v, np.complexfloating):
        c = complex(v)
        return (type(v).__name__, c.real.hex(), c.imag.hex())
    return None
