"""heat_tpu_torch — heat_tpu ported to PyTorch and CUDA.

The distributed ``DNDarray`` and its analytics, written over torch tensors,
with hand-written CUDA kernels for Hopper where ``heat_tpu`` has Pallas TPU
kernels. Arrays live on the first CUDA card unless the caller asks for the
CPU (``use_device("cpu")`` or ``device="cpu"``). This package imports
nothing of JAX or of ``heat_tpu``.

The port goes slice by slice:

1. the main path: factories and arithmetic, ``mean``/``var``/``std`` over
   the ``moments_onepass`` kernel, ``cdist`` and ``KMeans`` over the
   ``lloyd_fused`` kernel;
2. kNN predict: ``spatial.nearest_neighbors`` and
   ``classification.KNeighborsClassifier`` over the ``topk_distance``
   kernel; and the Cholesky path: ``eye``, ``spatial.rbf``, ``matmul``/
   ``transpose``, ``linalg.cholesky`` over the ``chol_panel_fused`` kernel
   and ``linalg.solve_triangular``;
3. tall-skinny ``linalg.qr`` (CholeskyQR2 with ``heat_tpu``'s
   orthogonality guard and its Householder fallback) with ``matmul``, and
   the elementwise array surface: ``exponential``, ``trigonometrics``,
   ``rounding``, ``logical``, ``relational``, the remaining arithmetic
   names, ``min``/``max``/``argmin``/``argmax`` and their kin,
   ``where``/``nonzero``, ``copy``, the DNDarray dunders and methods, and
   ``linalg``'s ``tril``/``triu``/``norm``/``dot``/``outer``/``trace``;
4. across cards: ``init_distributed`` starts a ``torch.distributed``
   group (NCCL on cards, gloo on the CPU), one process per card, and every
   split array is sharded: each rank holds its ceil-div chunk, and the
   operations above run on the chunks with the collectives they need
   (``resplit``, reductions, moments, the Lloyd step, kNN with split
   queries, ``matmul``, TSQR ``qr``);
5. ``heat_tpu``'s random stream (threefry-2x32, the ``threefry_bits``
   kernel; each rank draws only its chunk) behind ``random`` and KMeans'
   ``'random'``/``'kmeans++'`` inits, and the kernel-ridge path across
   ranks: ``cdist``/``rbf``/``manhattan`` of two split operands (gathered,
   or on a ring with ``use_ring``), the blocked ``cholesky`` with
   ``chol_panel_fused`` on each diagonal block, ``solve_triangular``, and
   the tile geometry (``tiling``) they read;
6. the rest of ``linalg`` and spectral clustering; then ``manipulations``
   (the rows a movement needs fetched in one ``alltoall``), ``sort``/
   ``topk``/``unique`` along the split axis (``parallel``), exact
   ``percentile``/``median`` and the other statistics, ``__setitem__`` and
   advanced indexing, and ``KMedians``/``KMedoids``, whose centres are exact
   order statistics found without moving rows;
7. the rest of ``heat_tpu``'s types (uint8, int8, int16, float16,
   bfloat16, complex64, complex128) through every module and collective,
   ``complex_math``, the DNDarray's own members with the split-axis halos,
   ``signal.convolve`` over them, ``pad``'s statistic modes, ``printing``
   and ``version``;
8. ``heat_tpu``'s float16/bfloat16 random stream, file I/O (``load``/
   ``save``: HDF5, classic netCDF through the port's own reader and
   writer, CSV through the native parser of ``native/``) and the
   out-of-core ``stream`` path: ``ChunkIterator`` and ``Prefetcher``, the
   streaming estimators (``moments_onepass`` per chunk) and sketches,
   ``percentile``/``median`` of a ``ChunkIterator``, ``tree_merge``, and
   ``cluster.StreamingKMeans`` (``lloyd_fused`` per chunk);
9. ragged layouts: ``redistribute_`` to any partition of the split axis
   (empty ranks included), elementwise operations, reductions, cumulative
   operations, ``nonzero``, ``copy`` and ``astype`` computed in place, one
   move to align two layouts, ``balance_`` (``LAYOUT_STATS``,
   ``MOVE_STATS``); ``SplitTiles`` and the tile views; and the rest of
   ``parallel``: ``flatmove``, ``halo_exchange``, ``ring_map``/
   ``ring_reduce``, ``make_mesh``/``make_hierarchical_mesh``, and
   ``ring_attention``/``ulysses_attention`` (forward);
10. the ML long tail and the training path: ``datasets``,
    ``naive_bayes.GaussianNB``, ``regression.Lasso``, the entry module
    (``entry.py``), ``nn`` (torch's layers under ``heat_tpu``'s names,
    ``DataParallel``), ``optim`` (``DataParallelOptimizer``, ``DASO``),
    ``utils`` (profiling, checkpoints, data tooling), and the gradients of
    ``ring_attention``/``ulysses_attention``;
11. ``frame`` (``Frame``: groupby/agg, ``value_counts``, join, filter and
    the grouped quantile over the sort-based shuffle, ``SHUFFLE_STATS``),
    ``stream.StreamingGroupBy``, and ``resilience``'s storage and guards:
    sharded checkpoints in ``heat_tpu``'s format, ``validate``/
    ``DNDarray.health_check``, ``guard``, the watchdog, ``chaos``, retries
    and the error classes;
12. ``resilience``'s supervision and health (``degrade``: a lost card means a
    smaller ``torch.distributed`` group and the live arrays moved onto it;
    ``HealthMonitor``, ``HEALTH_STATS``; ``Supervisor`` and the supervised
    fits of the k-clusterers, ``Lasso`` and ``DataParallel``,
    ``RECOVERY_STATS``), ``replicated_ids``/``replicated_frame``, and
    ``serve`` (``ServeService`` with its batching, replicated dispatch tick
    and fault ladder, ``ModelRegistry``, ``Autoscaler``, ``SERVE_STATS``).
"""
from .core import *
from .core import complex_math, io, kernels, linalg, printing, random, signal, version
from .core.version import __version__
from . import (classification, cluster, convert, datasets, frame, graph, naive_bayes, nn, optim, parallel,
               regression, resilience, serve, spatial, stream, utils)
from .core.dndarray import LAYOUT_STATS
from .core.kernels import KERNEL_STATS, LAUNCHES
from .frame import Frame, SHUFFLE_STATS
from .parallel.flatmove import MOVE_STATS
from .resilience import HEALTH_STATS, RECOVERY_STATS
from .serve import SERVE_STATS
from .stream import STREAM_STATS
