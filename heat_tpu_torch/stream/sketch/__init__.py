"""Mergeable sketches: small fixed-size states for the order and identity
questions exact streaming cannot answer in bounded memory (counterpart of
``heat_tpu/stream/sketch``).

=================  ======================  =========================
sketch             state                   promised error
=================  ======================  =========================
``KLLSketch``      2 x levels x k values   rank error <= ``eps``
``HyperLogLog``    2^p int32 registers     std err ``1.04/sqrt(2^p)``
``CountMinTopK``   depth x width + k keys  overcount <= ``e*N/width``
=================  ======================  =========================

Each has an associative ``merge_states`` combine behind ``merge()`` and
``merge_processes()``.
"""
from .countmin import CountMinTopK
from .hll import HyperLogLog
from .kll import KLLSketch

__all__ = ["CountMinTopK", "HyperLogLog", "KLLSketch"]
