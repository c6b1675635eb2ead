"""The precisions the reference computes in.

``float64`` is the reference itself. The controls are the steps below
float32 that would tempt a later change: ``tf32`` where the work is matrix
products, the operands of every product rounded to TF32's 10-bit mantissa
(round to nearest even) and the product summed in float32, as the tensor
cores compute a TF32 matrix product (emulated, so that it reads the same on
the CPU and on the card); ``bfloat16`` where it is not.
"""
from __future__ import annotations

import torch

PRECISIONS = ("float64", "tf32", "bfloat16")


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32: 13 mantissa bits dropped, to nearest even."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


def dtype_of(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    return {"float64": torch.float64, "tf32": torch.float32, "bfloat16": torch.bfloat16}[precision]


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in ``precision``: float64 as it is, tf32 on rounded operands."""
    if precision == "tf32":
        return to_tf32(a) @ to_tf32(b)
    return a @ b


def standardize(x: torch.Tensor, precision: str = "float64"):
    """``(x - mean) / std`` over the rows, std with ddof 0, the moments in
    float64 by two passes. Returns the standardized rows in ``precision``'s
    type, the mean and the std."""
    mean = x.sum(0, dtype=torch.float64) / x.shape[0]
    m2 = torch.zeros_like(mean)
    for lo in range(0, x.shape[0], 1 << 22):
        m2 += ((x[lo : lo + (1 << 22)].double() - mean) ** 2).sum(0)
    std = torch.sqrt(m2 / x.shape[0])
    out = torch.empty(x.shape, dtype=dtype_of(precision), device=x.device)
    for lo in range(0, x.shape[0], 1 << 22):
        out[lo : lo + (1 << 22)] = ((x[lo : lo + (1 << 22)].double() - mean) / std).to(out.dtype)
    return out, mean, std
