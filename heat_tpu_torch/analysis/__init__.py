"""Static and runtime checks of the port's SPMD invariants (counterpart of
``heat_tpu.analysis``).

- :mod:`.graftlint` — pure-stdlib AST checker, rules G001–G007 recast for
  torch (program-cache keys, unbounded caches, collectives under rank- or
  tensor-dependent branches, hot-path host syncs, unordered iteration,
  swallowed ResilienceError, non-atomic durable writes);
- :mod:`.graftflow` over :mod:`.summaries` — flow-sensitive SPMD taint
  analysis, F001–F009 and DRIFT, over the port's collective vocabulary;
- :mod:`.graftcheck` — both as one gate:
  ``python -m heat_tpu_torch.analysis.graftcheck heat_tpu_torch/`` or
  ``python tools/torch_graftcheck.py heat_tpu_torch/``;
- :mod:`.sanitizer` — runtime accounting of builds, lazy plans, cache
  inserts, host fetches and collectives (:data:`COMPILE_STATS`,
  :func:`sanitizer`, ``block_host_sync``);
- :mod:`.lockstep` — runtime cross-rank collective-lockstep check
  (:data:`LOCKSTEP_STATS`, :func:`lockstep`, ``LockstepError``).
"""
from . import graftflow, graftlint
from .lockstep import LOCKSTEP_STATS, lockstep, reset_lockstep_stats
from .sanitizer import COMPILE_STATS, Region, SanitizerError, reset_compile_stats, sanitizer

__all__ = ["graftflow", "graftlint", "COMPILE_STATS", "LOCKSTEP_STATS", "Region", "SanitizerError", "lockstep",
           "reset_compile_stats", "reset_lockstep_stats", "sanitizer"]
