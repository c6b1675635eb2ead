"""Retry and backoff policies (counterpart of
``heat_tpu/resilience/retry.py``): the public face of
:mod:`heat_tpu_torch.core._retry`, and the resilience layer's defaults.

- :data:`NO_RETRY`: one attempt, the default of plain ``load``/``save``;
- :data:`DEFAULT_CHECKPOINT_POLICY`: 3 attempts with exponential backoff,
  the default of checkpoint I/O, where a transient file-system fault is the
  common failure and a retry is always safe because every write is atomic
  (a temp file, then a rename). Its ``max_elapsed`` budget bounds a retry
  storm over many shard writes.
"""
from __future__ import annotations

from ..core._retry import NO_RETRY, RetryError, RetryPolicy

__all__ = ["RetryPolicy", "RetryError", "NO_RETRY", "DEFAULT_CHECKPOINT_POLICY"]

DEFAULT_CHECKPOINT_POLICY = RetryPolicy(
    max_attempts=3, base_delay=0.05, max_delay=2.0, multiplier=2.0, jitter=0.1, seed=0, max_elapsed=10.0,
)
