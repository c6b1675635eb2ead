"""heat_tpu_torch.frame: columnar groupby, join and filter on the shuffle
(counterpart of ``heat_tpu/frame``).

A :class:`Frame` is a dict of named, equal-length split-0 DNDarray columns
in one layout. Its verbs (``groupby(key).agg(...)``, ``value_counts``,
``join``, ``filter``) all take one shape: a local reduction on each rank,
ONE bounded bucket exchange per operand, a local merge (see
:mod:`._shuffle`, and :mod:`heat_tpu_torch.parallel.flatmove` for the
exchange). There is no per-key traffic at any cardinality, and every
partition decision is replicated.

:class:`heat_tpu_torch.stream.StreamingGroupBy` folds chunks with the same
associative statistics, so a bounded-memory groupby over a
``ChunkIterator`` shares this module's aggregation contract.
"""
from ._shuffle import SHUFFLE_STATS
from .frame import Frame
from .groupby import AGGS, FrameGroupBy

__all__ = ["Frame", "FrameGroupBy", "AGGS", "SHUFFLE_STATS"]
