"""Out-of-core streaming: chunked pipelines over datasets larger than a
card's memory (counterpart of ``heat_tpu.stream``).

- :class:`~.chunked.ChunkIterator` — split row blocks of a file (HDF5,
  netCDF or CSV row windows) or an in-memory array;
- :class:`~.prefetch.Prefetcher` — a producer thread reads the next raw
  window while the consumer works on this chunk; staging stays on the
  consumer's thread;
- :class:`~.estimators.StreamingMoments` (the ``moments_onepass`` kernel
  per chunk), :class:`~.estimators.StreamingCov`,
  :class:`~.estimators.StreamingHistogram` — single-pass estimators by
  pairwise merges, equal to the in-memory results up to re-association;
- :class:`~.sketch.KLLSketch`, :class:`~.sketch.HyperLogLog`,
  :class:`~.sketch.CountMinTopK` — mergeable sketches for quantiles,
  distinct counts and heavy hitters;
- ``STREAM_STATS`` / :func:`reset_stream_stats` — chunk, prefetch and
  overlap counters.

``heat_tpu_torch.cluster.StreamingKMeans`` fits over the same chunks (the
``lloyd_fused`` kernel per chunk). :class:`~.groupby.StreamingGroupBy`
aggregates per key over chunks with the frame groupby's statistics.

Memory: at most ``depth`` raw windows are read ahead on the host, and
one staged chunk is on the card, whatever the size of the data.
"""
from . import chunked, estimators, groupby, prefetch, sketch
from ._stats import STREAM_STATS, reset_stream_stats
from .chunked import ChunkIterator
from .estimators import StreamingCov, StreamingHistogram, StreamingMoments
from .groupby import StreamingGroupBy
from .prefetch import Prefetcher
from .sketch import CountMinTopK, HyperLogLog, KLLSketch

__all__ = [
    "ChunkIterator",
    "CountMinTopK",
    "HyperLogLog",
    "KLLSketch",
    "Prefetcher",
    "STREAM_STATS",
    "StreamingCov",
    "StreamingGroupBy",
    "StreamingHistogram",
    "StreamingMoments",
    "reset_stream_stats",
]
