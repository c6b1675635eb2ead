"""Random number generation (counterpart of ``heat_tpu/core/random.py``).

Draws come from an explicit ``torch.Generator`` per device, seeded by
:func:`seed`. They do not reproduce ``heat_tpu``'s threefry bits: the two
packages agree in distribution, not in values, so tests feed both the same
numpy data instead.

A split draw gives the same global array at every world size: every rank
draws the whole global array from the shared seeded generator on its own
device and keeps its chunk. That costs O(global) transient memory and draw
time on every rank; a counter-based generator (threefry, as ``heat_tpu``
draws) that computes only the chunk's numbers would not.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from . import devices, types
from .communication import sanitize_comm
from .dndarray import DNDarray
from .stride_tricks import sanitize_axis, sanitize_shape

__all__ = ["get_generator", "rand", "randint", "randn", "seed"]

__seed: int = 0
# one generator per torch device, created at first use from the current seed
__generators: Dict[str, torch.Generator] = {}


def seed(seed: Optional[int] = None) -> None:
    """Reset every generator to ``seed`` (a fresh random seed when None)."""
    global __seed
    if seed is None:
        seed = int(np.random.SeedSequence().entropy % (2**63))
    __seed = int(seed)
    __generators.clear()


def get_generator(device=None) -> torch.Generator:
    """The generator that draws for ``device`` (default: the default device)."""
    tdev = devices.sanitize_device(device).torch_device
    key = str(tdev)
    gen = __generators.get(key)
    if gen is None:
        gen = torch.Generator(device=tdev)
        gen.manual_seed(__seed)
        __generators[key] = gen
    return gen


def _float_type(dtype):
    dtype = types.canonical_heat_type(dtype)
    if dtype not in (types.float32, types.float64):
        raise ValueError(f"Unsupported dtype {dtype} for random floats")
    return dtype


def _draw(fill, shape, dtype, split, device, comm) -> DNDarray:
    device = devices.sanitize_device(device)
    comm = sanitize_comm(comm)
    split = sanitize_axis(shape, split) if shape else None
    gen = get_generator(device)
    t = fill(shape, dtype.torch_type(), device.torch_device, gen)
    if split is not None and comm.is_distributed():
        t = t[comm.chunk(shape, split)[2]].clone()  # the global draw is freed here
    return DNDarray(t, gshape=shape, dtype=dtype, split=split, device=device, comm=comm)


def rand(*d, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Uniform [0, 1) samples."""
    shape = sanitize_shape(d) if d else ()
    return _draw(
        lambda s, tt, dev, g: torch.rand(s, dtype=tt, device=dev, generator=g),
        shape, _float_type(dtype), split, device, comm,
    )


def randn(*d, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Standard-normal samples."""
    shape = sanitize_shape(d) if d else ()
    return _draw(
        lambda s, tt, dev, g: torch.randn(s, dtype=tt, device=dev, generator=g),
        shape, _float_type(dtype), split, device, comm,
    )


def randint(low: int, high: Optional[int] = None, size=None, dtype=types.int32, split=None, device=None, comm=None) -> DNDarray:
    """Uniform integers in [low, high)."""
    if high is None:
        low, high = 0, low
    if high <= low:
        raise ValueError("low >= high")
    shape = () if size is None else sanitize_shape(size)
    return _draw(
        lambda s, tt, dev, g: torch.randint(int(low), int(high), s, dtype=tt, device=dev, generator=g),
        shape, types.canonical_heat_type(dtype), split, device, comm,
    )
