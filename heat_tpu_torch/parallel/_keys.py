"""Order-preserving integer keys of array values, shared by the sort,
top-k, unique and selection algorithms of :mod:`heat_tpu_torch.parallel`.

:func:`order_keys` maps every value to an int64 whose order is the value
order of ``jnp.sort``: NaN after everything (one key for every NaN),
``-0.0`` equal to ``+0.0``, and ``~key`` reverses the order (descending
sorts put NaN first, as ``jnp.sort`` does). :func:`radix_keys` shifts them
to non-negative digit strings of 32 or 64 bits for the radix selection,
and :func:`from_radix_keys` maps a selected string back to its value.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["from_radix_keys", "order_keys", "radix_keys"]

_I64_MAX = torch.iinfo(torch.int64).max
_I64_MIN = torch.iinfo(torch.int64).min


def _float_bits(t: torch.Tensor, signed_zeros: bool = False) -> torch.Tensor:
    """The IEEE bits of a float tensor as a monotone signed int64 (zeros
    made equal, unless ``signed_zeros`` orders -0.0 before +0.0)."""
    x = t if signed_zeros else torch.where(t == 0, torch.zeros_like(t), t)
    if t.dtype == torch.float64:
        b = x.view(torch.int64)
        return torch.where(b < 0, b ^ _I64_MAX, b)
    b = x.to(torch.float32).view(torch.int32).to(torch.int64)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


def order_keys(t: torch.Tensor, descending: bool = False, signed_zeros: bool = False) -> torch.Tensor:
    """int64 keys whose ascending order is ``t``'s value order (NaN last),
    or its descending order (NaN first) with ``descending``;
    ``signed_zeros`` orders -0.0 before +0.0 (``lax.top_k``'s total
    order) instead of equal."""
    if t.is_floating_point():
        nan = torch.isnan(t)
        key = torch.where(nan, torch.full_like(nan, _I64_MAX, dtype=torch.int64), _float_bits(t, signed_zeros))
    else:
        key = t.to(torch.int64)
    return ~key if descending else key


def radix_keys(t: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """``(keys, bits)``: the ascending order keys of ``t`` as digit strings
    of ``bits`` bits held in int64 (32 for 32-bit and smaller types, whose
    keys are non-negative; 64 for 64-bit types, whose bit patterns order as
    unsigned integers)."""
    key = order_keys(t)
    if t.element_size() <= 4:
        nan_key = torch.full_like(key, (1 << 32) - 1)
        return torch.where(key == _I64_MAX, nan_key, key + (1 << 31)), 32
    return key ^ _I64_MIN, 64


def from_radix_keys(u: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The values of ``dtype`` whose :func:`radix_keys` are ``u`` (NaN for
    the NaN key, ``+0.0`` for a zero)."""
    if dtype.is_floating_point:
        if dtype == torch.float64:
            key = u ^ _I64_MIN
            return torch.where(key < 0, key ^ _I64_MAX, key).view(torch.float64)
        key = u - (1 << 31)
        bits = torch.where(key < 0, key ^ 0x7FFFFFFF, key)
        return bits.to(torch.int32).view(torch.float32).to(dtype)
    if dtype == torch.int64:
        return u ^ _I64_MIN
    return (u - (1 << 31)).to(dtype)
