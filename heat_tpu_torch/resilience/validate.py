"""Invariant checks of distributed arrays (counterpart of
``heat_tpu/resilience/validate.py``).

``resilience.validate(x)`` and its method form ``x.health_check()`` check
what a DNDarray must keep consistent, and optionally scan its values for
NaN and Inf, so that a silently corrupted shard is caught before it
spreads through an SPMD computation.

``heat_tpu``'s invariant is a padded buffer of ``comm.padded_shape``. The
port pads nothing, so its invariant is: ``split`` names an axis (or is
None); ``lshape_map`` has one row per rank, agrees with ``gshape`` beside
the split axis and sums to the split extent along it; this rank's tensor
has exactly its row of ``lshape_map`` as shape (for a ragged layout too);
and the tensor's type is the annotation's.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..core import types
from ..core.dndarray import DNDarray
from ..core.sanitation import sanitize_in
from .errors import ResilienceError

__all__ = ["validate", "ValidationError"]


class ValidationError(ResilienceError, ValueError):
    """A DNDarray invariant does not hold; ``problems`` lists every one that
    fails (the checks go on past the first, so one report names them all)."""

    def __init__(self, problems: List[str]):
        self.problems = list(problems)
        super().__init__("DNDarray failed health check:\n" + "\n".join(f"  - {p}" for p in self.problems))


def validate(x: DNDarray, check_values: bool = False) -> DNDarray:
    """Check ``x``'s distributed invariants (see the module's docstring);
    returns ``x`` when they hold.

    ``check_values=True`` also scans every element of a float or complex
    array for NaN/Inf (this rank's rows; one ``allreduce`` of the count
    above one rank, so every rank reports the same).

    Raises :class:`ValidationError` listing every invariant that fails.
    """
    sanitize_in(x)
    problems: List[str] = []
    gshape, split, comm = tuple(x.gshape), x.split, x.comm
    if split is not None and not 0 <= split < len(gshape):
        problems.append(f"split {split} is out of range for {len(gshape)}-D gshape {gshape}")
    lmap = np.asarray(x.lshape_map)
    if lmap.shape != (comm.size, len(gshape)):
        problems.append(f"lshape_map has shape {lmap.shape}, expected {(comm.size, len(gshape))}")
    else:
        for d, n in enumerate(gshape):
            if d == split:
                if int(lmap[:, d].sum()) != n or (lmap[:, d] < 0).any():
                    problems.append(f"lshape_map column {d} {lmap[:, d].tolist()} does not partition the split "
                                    f"extent {n}")
            elif not (lmap[:, d] == n).all():
                problems.append(f"lshape_map column {d} {lmap[:, d].tolist()} != gshape[{d}] = {n}")
        want = tuple(int(s) for s in lmap[comm.rank])
        buf = x._raw
        if tuple(buf.shape) != want:
            problems.append(f"rank {comm.rank}'s tensor shape {tuple(buf.shape)} != its lshape_map row {want} for "
                            f"gshape {gshape}, split {split}")
    promised = x.dtype.torch_type()
    if x._raw.dtype != promised:
        problems.append(f"tensor dtype {x._raw.dtype} does not match annotation {x.dtype.__name__} ({promised})")
    if check_values and not types.heat_type_is_exact(x.dtype):
        t = x._raw
        bad = (~torch.isfinite(t)).sum().reshape(1).to(torch.int64)
        if split is not None and comm.is_distributed():
            bad = comm.allreduce(bad.to(comm.device()))
        n_bad = int(bad.item())
        if n_bad:
            problems.append(f"{n_bad} non-finite value(s) (NaN/Inf) in the logical array")
    if problems:
        raise ValidationError(problems)
    return x
