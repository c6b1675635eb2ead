"""Single-pass streaming estimators: moments, covariance, histogram
(counterpart of ``heat_tpu/stream/estimators.py``).

Each estimator folds chunks into a small replicated state by the stable
pairwise merge (Chan et al.): a chunk of ``n_b`` rows joins ``n_a`` rows by

    delta = mean_b - mean_a,  mean = mean_a + delta n_b / n,
    M2 = M2_a + M2_b + delta^2 n_a n_b / n

(and its matrix form with ``outer(delta, delta)`` for the co-moment), so
the results equal the in-memory ``mean``/``var``/``cov``/``histogram`` up
to float re-association.

Per chunk, :class:`StreamingMoments` takes the chunk's (count, mean, M2)
from the ``moments_onepass`` kernel on a card (``kernels.moments_local``)
and from its plain version (``kernels.chunk_moments``) on the CPU — the
route gate of ``heat_tpu``'s ``_moments_choice``: float32 chunks take the
kernel's route, other types the plain one, and ``KERNEL_STATS`` counts
each chunk's route. Across ranks a split chunk's states combine by
``kernels.moments_sharded`` (two ``allreduce`` calls); the covariance
takes one for the chunk's sums and one for its co-moment; the histogram
one for its counts. Every rank then holds the same state.

The histogram counts in int64, so it stays exact past 2^24 values a bin
(``heat_tpu`` counts in float32). :meth:`merge` combines two estimators;
:meth:`merge_processes` merges one estimator per rank (each fed its own
data) with :func:`~heat_tpu_torch.core.communication.tree_merge`.
"""
from __future__ import annotations

import torch

from ..core.communication import tree_merge
from ..core.dndarray import DNDarray
from ..core.kernels import (
    MOMENTS_KERNEL,
    chunk_moments,
    dispatch_mode,
    merge_moments,
    moments_local,
    moments_sharded,
    record_dispatch,
)
from ..core.statistics import _linspace32

__all__ = ["StreamingCov", "StreamingHistogram", "StreamingMoments"]


# -- the tree_merge operands: combines of two states, the lower rank's first; counts are int64 tensors
def _combine_moments(a, b):
    na, mean_a, m2a = a
    nb, mean_b, m2b = b
    naf, nbf = na.to(mean_a.dtype), nb.to(mean_a.dtype)
    nf = torch.clamp(naf + nbf, min=1.0)
    delta = mean_b - mean_a
    m2 = m2a + m2b + delta * delta * (naf * nbf / nf)
    mean = mean_a + delta * (nbf / nf)
    return na + nb, mean, m2


def _combine_cov(a, b):
    na, mean_a, ca = a
    nb, mean_b, cb = b
    naf, nbf = na.to(mean_a.dtype), nb.to(mean_a.dtype)
    nf = torch.clamp(naf + nbf, min=1.0)
    delta = mean_b - mean_a
    c = ca + cb + torch.outer(delta, delta) * (naf * nbf / nf)
    mean = mean_a + delta * (nbf / nf)
    return na + nb, mean, c


def _combine_hist(a, b):
    return a[0] + b[0], a[1] + b[1]


def _moments_choice(xa: torch.Tensor) -> str:
    """The route of one chunk's moments: the kernel's for float32 (CUDA on
    a card, its plain version on the CPU), the plain one for other types."""
    mode = dispatch_mode(MOMENTS_KERNEL, xa)
    return mode if xa.dtype == torch.float32 else "torch"


class _StreamingBase:
    """What the estimators share: the first chunk fixes where results live;
    each chunk gives its local rows (floats of at least 32 bits, 2-D) and
    whether its statistics must be summed over the ranks."""

    _COMBINE = None  # subclass: the tree_merge combine of _state()

    def __init__(self):
        self._n = 0
        self._device = None
        self._comm = None

    @property
    def n(self) -> int:
        """Rows folded in so far."""
        return self._n

    def _capture(self, chunk: DNDarray):
        """``(local rows, across, comm)`` of a chunk: a chunk split along
        another axis than 0 is resplit to 0 first."""
        if not isinstance(chunk, DNDarray):
            raise TypeError(f"chunks must be DNDarrays, got {type(chunk)}")
        if self._comm is None:
            self._device = chunk.device
            self._comm = chunk.comm
        across = chunk.split is not None and chunk.comm.size > 1
        if across and chunk.split != 0 and chunk.ndim > 1:
            chunk = chunk.resplit(0)
        xa = chunk.larray
        if xa.dtype != torch.float64:
            xa = xa.to(torch.float32)
        if xa.ndim == 1:
            xa = xa[:, None]
        return xa, across, chunk.comm

    def _require_data(self):
        if self._n == 0:
            raise RuntimeError("no chunks folded in yet (call update first)")

    def _wrap(self, t: torch.Tensor) -> DNDarray:
        return DNDarray(t, split=None, device=self._device, comm=self._comm)

    def _state(self):
        raise NotImplementedError

    def _set_state(self, state):
        raise NotImplementedError

    def merge_processes(self):
        """Merge every rank's state into the same global state on every
        rank by :func:`~heat_tpu_torch.core.communication.tree_merge`
        (``log2 P`` rounds of one send and one receive). Every rank must
        call it, each having folded at least one chunk of its own data; at
        world size 1 it does nothing."""
        self._require_data()
        self._set_state(tree_merge(self._state(), type(self)._COMBINE))
        return self


class StreamingMoments(_StreamingBase):
    """Single-pass per-column mean/var/std (axis 0, as
    ``mean(x, axis=0)`` / ``var(x, axis=0, ddof=ddof)``)."""

    _COMBINE = staticmethod(_combine_moments)

    def __init__(self, ddof: int = 0):
        super().__init__()
        self.ddof = int(ddof)
        self._mean = None
        self._m2 = None

    def update(self, chunk: DNDarray) -> "StreamingMoments":
        xa, across, comm = self._capture(chunk)
        if self._mean is None:
            self._mean = torch.zeros(xa.shape[1], dtype=xa.dtype, device=xa.device)
            self._m2 = torch.zeros_like(self._mean)
        mode = _moments_choice(xa)
        record_dispatch(MOMENTS_KERNEL, mode)  # once per chunk fold
        if xa.shape[0] == 0:  # a rank without rows of this chunk: nothing to read
            mean_b, m2_b = torch.zeros_like(self._mean), torch.zeros_like(self._m2)
        else:
            _, mean_b, m2_b = moments_local(xa, xa.shape[0]) if mode == "cuda" else chunk_moments(xa)
        nb = torch.tensor(float(xa.shape[0]), dtype=xa.dtype, device=xa.device)  # exact on the host
        if across:
            nb, mean_b, m2_b = moments_sharded(nb, mean_b, m2_b, comm)
        na = torch.tensor(float(self._n), dtype=xa.dtype, device=xa.device)
        _, self._mean, self._m2 = merge_moments(na, self._mean, self._m2, nb.to(xa.dtype), mean_b.to(xa.dtype),
                                                m2_b.to(xa.dtype))
        self._n += int(chunk.gshape[0])
        return self

    def merge(self, other: "StreamingMoments") -> "StreamingMoments":
        """Fold ``other``'s state into this one."""
        self._require_data()
        other._require_data()
        na, nb = float(self._n), float(other._n)
        n = na + nb
        delta = other._mean - self._mean
        self._m2 = self._m2 + other._m2 + delta * delta * (na * nb / n)
        self._mean = self._mean + delta * (nb / n)
        self._n += other._n
        return self

    def _state(self):
        return torch.tensor(self._n, dtype=torch.int64, device=self._mean.device), self._mean, self._m2

    def _set_state(self, state):
        n, self._mean, self._m2 = state
        self._n = int(n)

    @property
    def mean(self) -> DNDarray:
        self._require_data()
        return self._wrap(self._mean)

    @property
    def var(self) -> DNDarray:
        self._require_data()
        return self._wrap(self._m2 / max(self._n - self.ddof, 1))

    @property
    def std(self) -> DNDarray:
        self._require_data()
        return self._wrap(torch.sqrt(self._m2 / max(self._n - self.ddof, 1)))


class StreamingCov(_StreamingBase):
    """Single-pass covariance of samples in rows: the streaming
    ``cov(x, rowvar=False, bias=bias, ddof=ddof)`` (``ddof=None`` is
    ``0 if bias else 1``)."""

    _COMBINE = staticmethod(_combine_cov)

    def __init__(self, bias: bool = False, ddof=None):
        super().__init__()
        if ddof is not None and ddof != int(ddof):
            raise ValueError("ddof must be integer")
        self.ddof = int(ddof) if ddof is not None else (0 if bias else 1)
        self._mean = None
        self._c = None

    def update(self, chunk: DNDarray) -> "StreamingCov":
        xa, across, comm = self._capture(chunk)
        f = xa.shape[1]
        if self._mean is None:
            self._mean = torch.zeros(f, dtype=xa.dtype, device=xa.device)
            self._c = torch.zeros((f, f), dtype=xa.dtype, device=xa.device)
        sums = torch.cat([xa.sum(dim=0), torch.tensor([float(xa.shape[0])], dtype=xa.dtype, device=xa.device)])
        if across:
            sums = comm.allreduce(sums)
        nb = sums[-1]
        mean_b = sums[:-1] / torch.clamp(nb, min=1.0)
        d = xa - mean_b
        c_b = d.T @ d  # the chunk's co-moment
        if across:
            c_b = comm.allreduce(c_b)
        count = torch.tensor(float(self._n), dtype=xa.dtype, device=xa.device)
        n = torch.clamp(count + nb, min=1.0)
        delta = mean_b - self._mean
        self._mean = self._mean + delta * (nb / n)
        self._c = self._c + c_b + torch.outer(delta, delta) * (count * nb / n)
        self._n += int(chunk.gshape[0])
        return self

    def merge(self, other: "StreamingCov") -> "StreamingCov":
        """Fold ``other``'s state into this one."""
        self._require_data()
        other._require_data()
        na, nb = float(self._n), float(other._n)
        n = na + nb
        delta = other._mean - self._mean
        self._c = self._c + other._c + torch.outer(delta, delta) * (na * nb / n)
        self._mean = self._mean + delta * (nb / n)
        self._n += other._n
        return self

    def _state(self):
        return torch.tensor(self._n, dtype=torch.int64, device=self._mean.device), self._mean, self._c

    def _set_state(self, state):
        n, self._mean, self._c = state
        self._n = int(n)

    @property
    def mean(self) -> DNDarray:
        self._require_data()
        return self._wrap(self._mean)

    @property
    def cov(self) -> DNDarray:
        self._require_data()
        return self._wrap(self._c / max(self._n - self.ddof, 1))


class StreamingHistogram(_StreamingBase):
    """Single-pass histogram over a fixed finite range (a single pass
    cannot find the data's range first): ``bins`` uniform bins over
    ``[lo, hi]``, the last closed on the right, values outside dropped, as
    numpy bins them; the edges are ``jnp.linspace``'s float32 ones."""

    _COMBINE = staticmethod(_combine_hist)

    def __init__(self, bins: int = 10, range=None):
        super().__init__()
        if range is None:
            raise ValueError(
                "StreamingHistogram needs an explicit finite range=(lo, hi): "
                "a single-pass estimator cannot derive it from the data"
            )
        lo, hi = float(range[0]), float(range[1])
        if not (lo < hi):
            raise ValueError(f"range must satisfy lo < hi, got {(lo, hi)}")
        self.bins = int(bins)
        self.range = (lo, hi)
        self._counts = None
        self._edges = None

    def _edges_on(self, device) -> torch.Tensor:
        lo, hi = (torch.tensor(v, dtype=torch.float32, device=device) for v in self.range)
        return _linspace32(lo, hi, self.bins + 1, torch.float32)

    def update(self, chunk: DNDarray) -> "StreamingHistogram":
        xa, across, comm = self._capture(chunk)
        if self._counts is None:
            self._counts = torch.zeros(self.bins, dtype=torch.int64, device=xa.device)
            self._edges = self._edges_on(xa.device)
        v = xa.reshape(-1)
        edges = self._edges.to(v.dtype)  # float32 edges, compared in the chunk's type
        idx = torch.searchsorted(edges, v, right=True) - 1
        idx = torch.where(v == edges[-1], torch.full_like(idx, self.bins - 1), idx)
        keep = (idx >= 0) & (idx < self.bins)  # NaN sorts past the last edge: dropped
        counts = torch.bincount(idx[keep], minlength=self.bins)
        if across:
            counts = comm.allreduce(counts)
        self._counts = self._counts + counts
        self._n += int(chunk.gshape[0])
        return self

    def merge(self, other: "StreamingHistogram") -> "StreamingHistogram":
        """Fold ``other``'s counts into this one (same bins and range)."""
        if (self.bins, self.range) != (other.bins, other.range):
            raise ValueError("cannot merge histograms with different binning")
        self._require_data()
        other._require_data()
        self._counts = self._counts + other._counts
        self._n += other._n
        return self

    def _state(self):
        return torch.tensor(self._n, dtype=torch.int64, device=self._counts.device), self._counts

    def _set_state(self, state):
        n, self._counts = state
        self._n = int(n)

    @property
    def hist(self) -> DNDarray:
        """Bin counts, int32 as ``histogram``'s first output in ``heat_tpu``."""
        self._require_data()
        return self._wrap(self._counts.to(torch.int32))

    @property
    def bin_edges(self) -> DNDarray:
        """The float32 edges the folds bin by (``jnp.linspace``'s formula;
        XLA's own rounding of it may differ by one ulp)."""
        device = self._device.torch_device if self._device is not None else None
        edges = self._edges if self._edges is not None else self._edges_on(device)
        return DNDarray(edges, split=None, device=self._device, comm=self._comm)
