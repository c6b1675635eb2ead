"""Per-kernel dispatch registry, ``KERNEL_STATS`` and launch counts.

Counterpart of ``heat_tpu/core/kernels/_dispatch.py``. Each hand-written
kernel registers here; public APIs ask :func:`dispatch_mode` which
implementation to run for a tensor and report the decision through
:func:`record_dispatch`:

- ``"cuda"``  — the hand-written CUDA kernel, for tensors on a CUDA card;
- ``"torch"`` — the kernel's plain PyTorch version, for tensors on the CPU.

The mode follows from where the tensor lies; :func:`forced_mode` overrides
it inside a block, which is how a check runs the plain version on a card
beside the kernel. :data:`KERNEL_STATS` counts decisions under
``"{kernel}.{mode}"`` (a memo hit counts as a decision), and the route of
each launch of a kernel that has more than one under ``"{kernel}.{route}"``
(and the route of each ``linalg.qr`` call, ``qr.cholqr2`` or
``qr.householder``, which launches none of the kernels);
:data:`LAUNCHES` counts actual kernel launches, one per wrapper call that
starts the kernel. :data:`COLLECTIVES` counts the collectives the
communicator ran (``{op: {"calls": n, "bytes": b}}``, the bytes this rank
contributed), so a check can show which collectives a path ran beside
which kernels it launched; :data:`RECEIVED` the bytes each collective
brought to this rank (``{op: bytes}``). Each counted collective is also
reported to the observers of :mod:`.._hooks` as ``"collective.<op>"``, or
as ``"collective.exchange"`` (with ``op``) for a batch of point-to-point
messages, whose partners differ from rank to rank.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import torch

from .. import _hooks

__all__ = [
    "COLLECTIVES",
    "KERNEL_STATS",
    "KERNELS",
    "LAUNCHES",
    "RECEIVED",
    "count_collective",
    "count_launch",
    "dispatch_mode",
    "forced_mode",
    "record_dispatch",
    "record_route",
    "register_kernel",
    "reset_kernel_stats",
]

MODES = ("cuda", "torch")

# name -> spec dict: {"comparator", "roofline", "replaces"}
KERNELS: Dict[str, Dict] = {}


def register_kernel(name: str, *, comparator: str = "", roofline: str = "", replaces: str = "") -> str:
    """Register a hand-written kernel. ``comparator`` names the plain
    version, ``roofline`` what bounds the kernel, ``replaces`` the TPU
    kernel it ports."""
    KERNELS[name] = {"comparator": comparator, "roofline": roofline, "replaces": replaces}
    LAUNCHES.setdefault(name, 0)
    return name


# test/check-only overrides: kernel name -> forced mode (see forced_mode())
_FORCED: Dict[str, str] = {}


def dispatch_mode(kernel: str, tensor: torch.Tensor) -> str:
    """The mode the public API dispatches for ``kernel`` on ``tensor``."""
    if kernel not in KERNELS:
        raise KeyError(f"unknown kernel {kernel!r}")
    forced = _FORCED.get(kernel)
    if forced == "cuda" and not tensor.is_cuda:
        raise ValueError(f"{kernel}: mode 'cuda' forced for a tensor on {tensor.device}")
    if forced is not None:
        return forced
    return "cuda" if tensor.is_cuda else "torch"


@contextlib.contextmanager
def forced_mode(kernel: str, mode: str) -> Iterator[None]:
    """Force :func:`dispatch_mode` for one kernel inside the block."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    prev = _FORCED.get(kernel)
    _FORCED[kernel] = mode
    try:
        yield
    finally:
        if prev is None:
            _FORCED.pop(kernel, None)
        else:
            _FORCED[kernel] = prev


KERNEL_STATS: Dict[str, int] = {"dispatches": 0}
LAUNCHES: Dict[str, int] = {}
COLLECTIVES: Dict[str, Dict[str, int]] = {}
RECEIVED: Dict[str, int] = {}


def record_dispatch(kernel: str, mode: str) -> None:
    """Report one public-API dispatch decision (call boundary only)."""
    KERNEL_STATS["dispatches"] += 1
    key = f"{kernel}.{mode}"
    KERNEL_STATS[key] = KERNEL_STATS.get(key, 0) + 1


def record_route(kernel: str, route: str) -> None:
    """Report the route of one launch of ``kernel`` (its wrapper calls this
    beside :func:`count_launch`), or of one call of an op with routes."""
    key = f"{kernel}.{route}"
    KERNEL_STATS[key] = KERNEL_STATS.get(key, 0) + 1


def count_launch(kernel: str) -> None:
    """Add one launch of ``kernel``; called by its wrapper where it starts
    the CUDA kernel, and nowhere else."""
    LAUNCHES[kernel] += 1


def count_collective(op: str, nbytes: int, received: int = None, p2p: bool = False) -> None:
    """Add one call of the collective ``op`` that sent ``nbytes`` from this
    rank and brought it ``received`` bytes (``nbytes`` where omitted);
    called by the communicator where it starts the collective. ``p2p``
    marks a batch of point-to-point messages."""
    _hooks.observe("collective.exchange" if p2p else f"collective.{op}", op=op)
    entry = COLLECTIVES.setdefault(op, {"calls": 0, "bytes": 0})
    entry["calls"] += 1
    entry["bytes"] += int(nbytes)
    RECEIVED[op] = RECEIVED.get(op, 0) + int(nbytes if received is None else received)


def reset_kernel_stats() -> None:
    """Zero :data:`KERNEL_STATS`, :data:`LAUNCHES`, :data:`COLLECTIVES` and
    :data:`RECEIVED`."""
    KERNEL_STATS.clear()
    KERNEL_STATS["dispatches"] = 0
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    COLLECTIVES.clear()
    RECEIVED.clear()
