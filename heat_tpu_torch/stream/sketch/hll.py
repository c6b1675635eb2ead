"""HyperLogLog distinct-count sketch: ``2^p`` registers, merged by max
(counterpart of ``heat_tpu/stream/sketch/hll.py``).

Each fold hashes every element of the chunk (its float32 bits, ``-0.0``
as ``0.0`` and subnormals flushed as XLA flushes them, through the
murmur3 finalizer), takes the top ``p`` bits as a
register index and the leading-zero count of the rest plus one as the
rank, and keeps each register's largest rank. The hash is exact uint32
arithmetic, done in int64 and masked to 32 bits (a wrapped int64 product
keeps its low 32 bits), so the registers equal ``heat_tpu``'s. The
estimate is the bias-corrected harmonic mean with the small-range
(linear counting) and 32-bit large-range corrections (Flajolet et al.
2007); its relative standard error is ``1.04 / sqrt(2^p)``
(:attr:`HyperLogLog.rel_error`). Across ranks the registers of a split
chunk are merged by one ``allreduce`` of MAX.
"""
from __future__ import annotations

import math

import torch

from ...core.dndarray import DNDarray
from ..estimators import _StreamingBase

__all__ = ["HyperLogLog", "merge_states"]

_M32 = 0xFFFFFFFF


def _hash_u32(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """The murmur3 finalizer of ``x``'s float32 bit patterns (``-0.0`` as
    ``0.0``): uint32 values held in an int64 tensor. Float32 subnormals
    hash as XLA flushes them: to ``+0.0`` where the input is float32 (its
    compare with 0 takes them for zero), to a zero of their sign where a
    float64 input rounds to one."""
    f = torch.where(x == 0, torch.zeros_like(x), x).to(torch.float32)
    sub = (f != 0) & (f.abs() < torch.finfo(torch.float32).tiny)
    zero = torch.zeros_like(f) if x.dtype == torch.float32 else torch.copysign(torch.zeros_like(f), f)
    f = torch.where(sub, zero, f)
    h = f.view(torch.int32).to(torch.int64) & _M32
    h = h ^ seed
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def _clz32(w: torch.Tensor) -> torch.Tensor:
    """Leading zeros of uint32 values (held in int64): 32 for 0."""
    _, e = torch.frexp(w.to(torch.float64))  # w = m 2^e, m in [0.5, 1): e is the bit length (exact below 2^53)
    return 32 - torch.where(w == 0, torch.zeros_like(e), e).to(torch.int64)


def merge_states(a, b):
    """The associative combine of two HLL states ``(n, registers)``."""
    return a[0] + b[0], torch.maximum(a[1], b[1])


class HyperLogLog(_StreamingBase):
    """Streaming approximate count of distinct elements.

    Parameters
    ----------
    p : int
        Register-count exponent in [4, 16] (default 12: 4096 registers,
        about 1.6 % relative standard error).
    """

    _COMBINE = staticmethod(merge_states)

    def __init__(self, p: int = 12):
        super().__init__()
        if not 4 <= p <= 16:
            raise ValueError(f"p must be in [4, 16], got {p}")
        self.p = int(p)
        self.m = 1 << self.p
        self._regs = None

    def update(self, chunk: DNDarray) -> "HyperLogLog":
        xa, across, comm = self._capture(chunk)
        if self._regs is None:
            self._regs = torch.zeros(self.m, dtype=torch.int32, device=xa.device)
        h = _hash_u32(xa.reshape(-1))
        idx = h >> (32 - self.p)
        w = (h << self.p) & _M32  # the low p bits leave: a hash of zeros past them gets the largest rank
        rho = torch.clamp(_clz32(w) + 1, max=32 - self.p + 1).to(torch.int32)
        regs = self._regs.scatter_reduce(0, idx, rho, reduce="amax")
        if across:
            regs = comm.allreduce(regs, "max")
        self._regs = regs
        self._n += int(chunk.gshape[0])
        return self

    def merge(self, other: "HyperLogLog") -> "HyperLogLog":
        """Fold ``other``'s registers into this one (elementwise max)."""
        if self.p != other.p:
            raise ValueError("cannot merge HyperLogLogs with different p")
        self._require_data()
        other._require_data()
        self._set_state(merge_states(self._state(), other._state()))
        return self

    def _state(self):
        return torch.tensor(self._n, dtype=torch.int64, device=self._regs.device), self._regs

    def _set_state(self, state):
        n, self._regs = state
        self._n = int(n)

    @property
    def rel_error(self) -> float:
        """Relative standard error of the estimate: ``1.04 / sqrt(2^p)``."""
        return 1.04 / math.sqrt(self.m)

    def distinct(self) -> float:
        """The bias-corrected cardinality estimate."""
        self._require_data()
        m = float(self.m)
        if m <= 16:
            alpha = 0.673
        elif m <= 32:
            alpha = 0.697
        elif m <= 64:
            alpha = 0.709
        else:
            alpha = 0.7213 / (1.0 + 1.079 / m)
        regs = self._regs.to(torch.float32)
        est = float(alpha * m * m / float(torch.sum(torch.exp2(-regs))))
        zeros = float(torch.sum(self._regs == 0))
        if est <= 2.5 * m and zeros > 0:
            return m * math.log(m / zeros)
        two32 = float(1 << 32)
        if est > two32 / 30.0:
            return -two32 * math.log(1.0 - est / two32)
        return est
