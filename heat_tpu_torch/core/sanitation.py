"""Sanitation helpers (counterpart of ``heat_tpu/core/sanitation.py``).

The shape and axis helpers the slice calls (``sanitize_axis``,
``sanitize_shape``, ``broadcast_shape``) live in :mod:`.stride_tricks`, as
in ``heat_tpu``; they are re-exported here so either import path works.
"""
from .stride_tricks import broadcast_shape, sanitize_axis, sanitize_shape

__all__ = ["broadcast_shape", "sanitize_axis", "sanitize_shape"]
