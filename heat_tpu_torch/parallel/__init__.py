"""Distributed algorithms over ``torch.distributed`` (counterpart of
``heat_tpu.parallel``).

- :mod:`.dsort`: sort along the split axis (sample sort), behind
  ``sort``;
- :mod:`.dtopk`: top-k along the split axis from P·k candidates, behind
  ``topk``;
- :mod:`.dscan`: ``unique`` from per-rank candidates and ``nonzero``
  by a scan of per-rank counts;
- :mod:`.dselect`: exact order statistics from each rank's sorted keys
  and a bisection of the key space (one small ``allreduce`` per key bit),
  behind ``percentile``/``median`` along the split axis and the
  ``KMedians``/``KMedoids`` centre update.

Each works on this rank's ceil-div chunk and sends O(its chunk) or less;
none gathers the array.
"""
from . import dscan, dselect, dsort, dtopk
from .dsort import distributed_sort
from .dtopk import distributed_topk

__all__ = ["distributed_sort", "distributed_topk"]
