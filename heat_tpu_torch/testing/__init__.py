"""Fault-tolerant multi-process suite execution (counterpart of
``heat_tpu.testing``): the library half of ``tools/torch_mpirun.py``.

A coordinator (:mod:`.runner`) drives pools of long-lived pytest workers
(:mod:`.worker`) joined into ``torch.distributed`` groups, speaking the
line-JSON protocol of :mod:`.protocol`, with known-bad tests kept visible
by :mod:`.quarantine`. The coordinator-side modules (protocol, quarantine,
runner) are pure stdlib and never import torch: ``tools/torch_mpirun.py``
loads this package by file path without running
``heat_tpu_torch/__init__``. Only :mod:`.worker` imports torch, inside
``main()``.
"""
from __future__ import annotations

from . import protocol, quarantine
from .protocol import decode, encode, merge_rank_results, result_record
from .quarantine import load_quarantine, match_quarantine, parse_quarantine_text
from .runner import (
    GroupCrash,
    RunnerConfig,
    RunnerError,
    SuiteResult,
    SuiteRunner,
    WorkerGroup,
    sample_ids,
)

__all__ = [
    "protocol",
    "quarantine",
    "decode",
    "encode",
    "merge_rank_results",
    "result_record",
    "load_quarantine",
    "match_quarantine",
    "parse_quarantine_text",
    "GroupCrash",
    "RunnerConfig",
    "RunnerError",
    "SuiteResult",
    "SuiteRunner",
    "WorkerGroup",
    "sample_ids",
]
