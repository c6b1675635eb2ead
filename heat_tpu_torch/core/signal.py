"""Signal processing (counterpart of ``heat_tpu/core/signal.py``).

``convolve`` keeps ``heat_tpu``'s rules: ``a`` and ``v`` swap when ``v`` is
the longer, ``"same"`` refuses an even kernel, the operands are promoted
(integers and bool to float, as jnp's ``convolve`` takes them: int64 to
float64, the others to float32; a split ``a`` on more than one rank keeps
its integer type, as ``heat_tpu``'s sharded program does), and the result
is split as ``a`` is.
The local step is ``torch.nn.functional.conv1d`` with the kernel flipped,
with cuDNN's TF32 mode turned off for the call and restored after it, so
float32 keeps float32 accuracy whatever the caller set.

A split ``a`` is the halo stencil of Heat itself: ``get_halo(len(v) // 2)``
brings each rank the rows next to its chunk (one batch of at most two sends
and two receives), each rank convolves its halo-extended chunk, the first
rank with zeros before it and the last rank with zeros after it, and
the pieces are trimmed to the mode. In ``"same"`` mode every rank then
holds its ceil-div chunk of the result; in ``"full"`` and ``"valid"`` mode
the result is longer or shorter than ``a``, so its ceil-div chunks shift,
and one ``alltoall`` moves the rows across the boundaries. Where a
non-empty chunk is shorter than the halo, the ranks gather ``a`` instead.
"""
from __future__ import annotations

import contextlib

import torch

from . import types
from .dndarray import DNDarray, _redistribute

__all__ = ["convolve"]


@contextlib.contextmanager
def _full_float32():
    """cuDNN's TF32 mode off for the block, restored after it."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def _conv_valid(ext: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The valid part of the convolution of ``ext`` with ``v``: entry k is
    ``sum_j ext[k + j] * v[M - 1 - j]``, of length ``len(ext) - M + 1``."""
    m = v.shape[0]
    if ext.shape[0] < m:
        return ext.new_zeros(0)
    if not (ext.is_floating_point() or ext.is_complex()):
        # integers (the split route keeps their type, as heat_tpu's sharded program does) multiply and add
        # windows, wrapping as integer arithmetic does
        return (ext.unfold(0, m, 1) * v.flip(0)).sum(dim=1, dtype=ext.dtype)
    with _full_float32():
        return torch.nn.functional.conv1d(ext.reshape(1, 1, -1), v.flip(0).reshape(1, 1, -1)).reshape(-1)


def _mode_span(mode: str, n: int, m: int):
    """``(off, length)``: the mode's result is the full convolution's
    entries ``[off, off + length)``."""
    if mode == "full":
        return 0, n + m - 1
    if mode == "same":
        return (m - 1) // 2, n
    return m - 1, n - m + 1


def convolve(a: DNDarray, v: DNDarray, mode: str = "full") -> DNDarray:
    """The discrete linear convolution of the 1-D arrays ``a`` and ``v``
    (numpy's ``convolve``): ``"full"``, ``"same"`` or ``"valid"``."""
    from . import factories

    anchor = a if isinstance(a, DNDarray) else v if isinstance(v, DNDarray) else None
    meta = {} if anchor is None else dict(device=anchor.device, comm=anchor.comm)
    if not isinstance(a, DNDarray):
        a = factories.array(a, **meta)
    if not isinstance(v, DNDarray):
        v = factories.array(v, **meta)
    if a.ndim != 1 or v.ndim != 1:
        raise ValueError(f"convolve requires 1-D inputs, got {a.ndim}-D and {v.ndim}-D")
    if mode not in ("full", "same", "valid"):
        raise ValueError(f"unsupported mode {mode!r}")
    if v.shape[0] > a.shape[0]:
        a, v = v, a
    if mode == "same" and v.shape[0] % 2 == 0:
        raise ValueError("mode 'same' cannot be used with even-sized kernel")
    comm, n, m = a.comm, a.shape[0], v.shape[0]
    promoted = types.promote_types(a.dtype, v.dtype)
    if types.heat_type_is_exact(promoted) and (a.split is None or not comm.is_distributed()):
        # jnp.convolve takes integers in float; heat_tpu's sharded program keeps their type
        promoted = types.promote_types(promoted, types.float32)
    tt = promoted.torch_type()
    kernel = v._logical().to(device=a.larray.device, dtype=tt)
    off, length = _mode_span(mode, n, m)
    if a.split is None or not comm.is_distributed():
        t = a.larray.to(tt)
        full = _conv_valid(torch.cat([t.new_zeros(m - 1), t, t.new_zeros(m - 1)]), kernel)
        return DNDarray(full[off:off + length], gshape=(length,), dtype=promoted, split=a.split, device=a.device,
                        comm=comm)
    counts = a.lshape_map[:, 0]
    halo = m // 2
    if any(0 < c < halo for c in counts):
        # a chunk too short to lend a halo: every rank convolves the whole signal
        t = a._logical().to(tt)
        full = _conv_valid(torch.cat([t.new_zeros(m - 1), t, t.new_zeros(m - 1)]), kernel)[off:off + length]
        return DNDarray(full[comm.chunk((length,), 0)[2]], gshape=(length,), dtype=promoted, split=0,
                        device=a.device, comm=comm)
    x = DNDarray(a.larray.to(tt), gshape=a.gshape, dtype=promoted, split=0, device=a.device, comm=comm)
    x.get_halo(halo)
    last = max(r for r, c in enumerate(counts) if c > 0)
    before, after = (m - 1) - halo, halo  # rows of a each entry reaches back and forward past the chunk

    def span(r: int):
        """Where rank r's entries start among the full convolution's, and how many it computes."""
        if counts[r] == 0:
            return 0, 0
        start = 0 if r == 0 else int(sum(counts[:r])) + after
        c = int(counts[r]) + (after if r == 0 else 0) + (before if r == last else 0)
        return start, c

    me = comm.rank
    t = x.larray
    if counts[me] > 0:
        left = t.new_zeros(m - 1) if me == 0 else x.halo_prev[halo - before:] if before else t.new_zeros(0)
        right = t.new_zeros(m - 1) if me == last else x.halo_next[:after] if after else t.new_zeros(0)
        mine = _conv_valid(torch.cat([left, t, right]), kernel)
    else:
        mine = t.new_zeros(0)
    starts, kept = [], []
    for r in range(comm.size):
        g, c = span(r)
        lo, hi = max(g, off), min(g + c, off + length)
        starts.append(min(max(lo - off, 0), length))
        kept.append(max(0, hi - lo))
    g, _ = span(me)
    lo = max(g, off) - g
    mine = mine[lo:lo + kept[me]]
    out = _redistribute(mine, 0, starts, kept, (length,), comm)
    return DNDarray(out, gshape=(length,), dtype=promoted, split=0, device=a.device, comm=comm)
