"""Test-matrix gallery (counterpart of ``heat_tpu/utils/data/matrixgallery.py``)."""
from __future__ import annotations

from typing import Optional

import torch

from ...core import devices, factories, types
from ...core import random as ht_random
from ...core.dndarray import DNDarray

__all__ = ["parter", "hermitian"]


def parter(n: int, split: Optional[int] = None, device=None, comm=None, dtype=types.float32) -> DNDarray:
    """The Parter matrix A[i, j] = 1 / (j - i + 0.5)."""
    dtype = types.canonical_heat_type(dtype)
    i = torch.arange(n, dtype=dtype.torch_type(), device=devices.sanitize_device(device).torch_device)
    a = 1.0 / (i[None, :] - i[:, None] + 0.5)
    return factories.array(a, dtype=dtype, split=split, device=device, comm=comm)


def hermitian(n: int, split: Optional[int] = None, device=None, comm=None, dtype=types.complex64) -> DNDarray:
    """A random Hermitian matrix (A + Aᴴ) / 2 of uniform draws from the
    random stream (real and imaginary parts, in that order, for a complex
    type; one real draw otherwise)."""
    dtype = types.canonical_heat_type(dtype)
    if types.heat_type_is_complexfloating(dtype):
        re = ht_random.rand(n, n, device=device).larray
        im = ht_random.rand(n, n, device=device).larray
        a = torch.complex(re, im)
        h = (a + a.conj().T) / 2
    else:
        a = ht_random.rand(n, n, device=device).larray
        h = (a + a.T) / 2
    return factories.array(h.to(dtype.torch_type()), dtype=dtype, split=split, device=device, comm=comm)
