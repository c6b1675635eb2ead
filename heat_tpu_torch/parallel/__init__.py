"""Distributed algorithms and primitives over ``torch.distributed``
(counterpart of ``heat_tpu.parallel``).

- :mod:`.dsort`: sort along the split axis (sample sort), behind
  ``sort``;
- :mod:`.dtopk`: top-k along the split axis from P·k candidates, behind
  ``topk``;
- :mod:`.dscan`: ``unique`` from per-rank candidates and ``nonzero``
  by a scan of per-rank counts;
- :mod:`.dselect`: exact order statistics from each rank's sorted keys
  and a bisection of the key space (one small ``allreduce`` per key bit),
  behind ``percentile``/``median`` along the split axis and the
  ``KMedians``/``KMedoids`` centre update;
- :mod:`.flatmove`: interval and bucket exchanges (``ragged_move`` behind
  ``redistribute_``/``balance_`` and ragged alignment, ``bucket_move``,
  ``strided_take``, ``reshape_via_flatmove``) and ``MOVE_STATS``;
- :mod:`.halo`, :mod:`.ring`: split-axis halos and the rotate-a-block
  pipeline (``ring_map``, ``ring_reduce``);
- :mod:`.mesh`: meshes of the group's ranks, flat or (slow x fast);
- :mod:`.ring_attention`, :mod:`.ulysses`: exact attention with the
  sequence split over the ranks, by rotating K/V or by two all-to-alls.

Each works on this rank's part and sends O(its part) or less; none
gathers the array.
"""
from . import dscan, dselect, dsort, dtopk, flatmove, halo, mesh, ring
from .dsort import distributed_sort
from .dtopk import distributed_topk
from .flatmove import reshape_via_flatmove
from .halo import halo_exchange
from .mesh import make_hierarchical_mesh, make_mesh
from .ring import ring_map, ring_reduce
# as in heat_tpu, the public name `attention` is the dense oracle and shadows the submodule
from .ring_attention import attention, ring_attention
from .ulysses import ulysses_attention

__all__ = [
    "attention", "distributed_sort", "distributed_topk", "halo_exchange", "make_hierarchical_mesh", "make_mesh",
    "reshape_via_flatmove", "ring_attention", "ring_map", "ring_reduce", "ulysses_attention",
]
