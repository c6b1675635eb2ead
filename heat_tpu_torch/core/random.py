"""Random number generation (counterpart of ``heat_tpu/core/random.py``).

The generator is ``heat_tpu``'s: counter-based threefry-2x32 with jax's
partitionable bit layout, so the same ``seed`` and call sequence give
``heat_tpu``'s values. The state is ``(seed, counter)``; each draw takes
the key ``fold_in(PRNGKey(seed), counter & 0x7FFFFFFF)`` and moves the
counter on by its number of elements (at least 1). An element's bits
depend only on the key and its global flat index, so every rank computes
just its own chunk of a split draw, and a draw gives the same global array
at every split and world size.

The bits come from the ``threefry_bits`` kernel on a card and from its
plain version on the CPU (:mod:`.kernels.threefry`), which also converts
them to floats in the same pass as ``jax.random`` does: uniform as jax's
``_uniform``, normal as ``sqrt(2) * erfinv(u)`` with ``u`` uniform in
(-1, 1) and XLA's erfinv (it differs from XLA's result in the last bits
where the two ``log1p`` round differently). float16 and bfloat16 draws
are jax's narrower ones (16-bit words for float16, 8-bit words for
bfloat16), rounded to the 16-bit type after every operation. ``randint``
is jax's 64-bit ``_randint`` (two 64-bit draws and a modular combination), and
``randperm``/``permutation`` are jax's ``_shuffle``: rounds of a stable
sort by fresh 32-bit keys.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import devices, types
from .communication import sanitize_comm
from .dndarray import DNDarray
from .kernels import THREEFRY_KERNEL, dispatch_mode, record_dispatch, threefry_bits, threefry_plain
from .kernels.threefry import chunk_layout, threefry2x32
from .stride_tricks import sanitize_axis, sanitize_shape

__all__ = [
    "get_state",
    "normal",
    "permutation",
    "rand",
    "randint",
    "randn",
    "random_integer",
    "random_sample",
    "randperm",
    "ranf",
    "sample",
    "seed",
    "set_state",
    "standard_normal",
    "uniform",
]

_M32 = 0xFFFFFFFF
Key = Tuple[int, int]

# global (seed, counter) state, as heat_tpu keeps it
__seed: int = 0
__counter: int = 0


def seed(seed: Optional[int] = None) -> None:
    """Reset the generator to ``seed`` (a fresh random seed when None)."""
    global __seed, __counter
    if seed is None:
        seed = int(np.random.SeedSequence().entropy % (2**63))
    __seed = int(seed)
    __counter = 0


def get_state() -> Tuple[str, int, int, int, float]:
    """The generator's state, ``("Threefry", seed, counter, 0, 0.0)``."""
    return ("Threefry", __seed, __counter, 0, 0.0)


def set_state(state: Tuple) -> None:
    """Restore a state from :func:`get_state` (a 3- or 5-tuple)."""
    global __seed, __counter
    if not isinstance(state, tuple) or len(state) not in (3, 5):
        raise TypeError("state needs to be a 3- or 5-tuple")
    if state[0] != "Threefry":
        raise ValueError("algorithm must be 'Threefry'")
    __seed = int(state[1])
    __counter = int(state[2])


# ------------------------------------------------------------- keys (host)
def _prng_key(seed: int) -> Key:
    """jax's ``PRNGKey(seed)``: the high and low words of the 64-bit seed."""
    s = int(seed) & (2**64 - 1)
    return s >> 32, s & _M32


def _fold_in(key: Key, data: int) -> Key:
    """jax's ``fold_in``: the hash of the counter ``(0, data)``."""
    return threefry2x32(key[0], key[1], 0, int(data) & _M32)


def _split(key: Key, num: int = 2):
    """jax's partitionable ``split``: key j is the hash of ``(j >> 32, j)``."""
    return [threefry2x32(key[0], key[1], j >> 32, j & _M32) for j in range(num)]


def _next_key(nelem: int) -> Key:
    """The key of the next draw; moves the counter on by ``nelem``."""
    global __counter
    key = _fold_in(_prng_key(__seed), __counter & 0x7FFFFFFF)
    __counter += max(int(nelem), 1)
    return key


# ------------------------------------------------------------------ draws
def _fill(key: Key, layout, kind: str, tdev: torch.device, lo: float = 0.0, scale: float = 1.0) -> torch.Tensor:
    """A chunk's bits or uniform floats, flat: the kernel on a card, the
    plain version on the CPU (or where ``forced_mode`` says so)."""
    mode = dispatch_mode(THREEFRY_KERNEL, torch.empty(0, device=tdev))
    record_dispatch(THREEFRY_KERNEL, mode)
    if mode == "cuda":
        return threefry_bits(key, layout, kind, tdev, lo, scale)
    return threefry_plain(key, layout, kind, tdev, lo, scale)


def _chunk(shape, split, comm):
    """``(split, lshape, layout)`` of this rank's chunk of a draw of
    ``shape``."""
    split = sanitize_axis(shape, split) if shape else None
    offset, lshape, _ = comm.chunk(shape, split)
    length = lshape[split] if split is not None else 0
    return split, lshape, chunk_layout(shape, split, offset, length)


def _float_type(dtype):
    dtype = types.canonical_heat_type(dtype) if dtype is not None else types.float32
    if dtype not in (types.float16, types.bfloat16, types.float32, types.float64):
        raise ValueError(f"Unsupported dtype {dtype} for random floats")
    return dtype


# the kind suffix of each float type's draw (threefry_bits' kinds)
_KIND_SUFFIX = {"float16": "16", "bfloat16": "bf16", "float32": "32", "float64": "64"}


def _rounded(value: float, dtype) -> float:
    """``value`` rounded to ``dtype`` (a heat float type), as a python float."""
    return float(torch.tensor(float(value), dtype=torch.float64).to(dtype.torch_type()).item())


def _float_draw(kind: str, shape, dtype, split, device, comm, lo: float = 0.0, hi: float = 1.0) -> DNDarray:
    """A draw of ``kind`` (``"uniform"`` or ``"normal"``) over jax's uniform
    ``max(lo, u * (hi - lo) + lo)``, u in [0, 1), in ``dtype``: ``lo``,
    ``hi`` and their difference rounded to ``dtype``."""
    device = devices.sanitize_device(device)
    comm = sanitize_comm(comm)
    key = _next_key(int(np.prod(shape, dtype=np.int64)) if shape else 1)
    split, lshape, layout = _chunk(shape, split, comm)
    lo = _rounded(lo, dtype)
    scale = _rounded(_rounded(hi, dtype) - lo, dtype)
    kind += _KIND_SUFFIX[dtype.__name__]
    t = _fill(key, layout, kind, device.torch_device, lo, scale).reshape(lshape)
    return DNDarray(t, gshape=shape, dtype=dtype, split=split, device=device, comm=comm)


def _normal_tensor(key: Key, shape, dtype, tdev: torch.device) -> torch.Tensor:
    """jax's ``random.normal(key, shape, dtype)`` whole, as a tensor on
    ``tdev``: the draw ``randn`` makes, from a key the caller holds."""
    npt = np.float32 if dtype is types.float32 else np.float64
    lo = npt(np.nextafter(npt(-1.0), npt(0.0)))
    kind = "normal32" if dtype is types.float32 else "normal64"
    return _fill(key, chunk_layout(shape, None, 0, 0), kind, tdev, float(lo), float(npt(1.0) - lo)).reshape(shape)


def rand(*d, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Uniform [0, 1) samples of shape ``d``."""
    shape = sanitize_shape(d) if d else ()
    return _float_draw("uniform", shape, _float_type(dtype), split, device, comm)


def randn(*d, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Standard-normal samples of shape ``d``: ``sqrt(2) * erfinv(u)``, u
    uniform in (-1, 1) (jax's ``_normal_real``)."""
    shape = sanitize_shape(d) if d else ()
    dtype = _float_type(dtype)
    minus_one = torch.tensor(-1.0, dtype=dtype.torch_type())
    lo = float(torch.nextafter(minus_one, torch.zeros_like(minus_one)).item())
    return _float_draw("normal", shape, dtype, split, device, comm, lo=lo)


def _urem(v: torch.Tensor, s: int) -> torch.Tensor:
    """``v mod s`` for int64 ``v`` read as unsigned 64-bit, ``1 <= s < 2^64``."""
    if s >= 2**63:  # v < 2^64 < 2 s: at most one subtraction
        sb = s - 2**64  # s's bits as an int64
        ge = (v ^ -(2**63)) >= (sb ^ -(2**63))  # unsigned v >= s, by flipping the sign bits
        return torch.where(ge, v - sb, v)
    r = (v & (2**63 - 1)) % s
    top = 2**63 % s  # what a set sign bit adds
    r_top = torch.where(r >= s - top, r - (s - top), r + top)
    return torch.where(v < 0, r_top, r)


def _randint_offsets(key: Key, layout, span: int, tdev: torch.device) -> torch.Tensor:
    """jax's 64-bit ``_randint`` without ``minval``: ``((hi mod span) * m +
    lo mod span) mod span`` over two 64-bit draws ``hi``, ``lo`` of the two
    halves of ``split(key)``, with jax's multiplier ``m = (2^32 mod span)^2
    mod 2^64 mod span``, for ``span`` in [1, 2^64)."""
    k1, k2 = _split(key)
    a = _urem(_fill(k1, layout, "bits64", tdev), span)
    b = _urem(_fill(k2, layout, "bits64", tdev), span)
    m = (2**32 % span) ** 2 % 2**64 % span  # the square wraps in uint64 as jax computes it: 0 from span 2^32 on
    if m == 0:
        return b
    # span <= 2^32 here: a * m + b < 2^64 never wraps, so take it mod span in 16-bit halves of m
    t = (a * (m >> 16)) % span
    return (t * 65536 + a * (m & 0xFFFF) + b) % span


def randint(
    low: int,
    high: Optional[int] = None,
    size=None,
    dtype=types.int32,
    split=None,
    device=None,
    comm=None,
) -> DNDarray:
    """Uniform integers in [low, high) (jax's ``randint`` at 64 bits, cast
    to ``dtype``)."""
    if high is None:
        low, high = 0, low
    if size is None:
        size = ()
    shape = sanitize_shape(size) if size != () else ()
    if high <= low:
        raise ValueError("low >= high")
    dtype = types.canonical_heat_type(dtype)
    device = devices.sanitize_device(device)
    comm = sanitize_comm(comm)
    key = _next_key(int(np.prod(shape, dtype=np.int64)) if shape else 1)
    split, lshape, layout = _chunk(shape, split, comm)
    off = _randint_offsets(key, layout, (int(high) - int(low)) % 2**64, device.torch_device)
    t = (off + int(low)).to(dtype.torch_type()).reshape(lshape)
    return DNDarray(t, gshape=shape, dtype=dtype, split=split, device=device, comm=comm)


random_integer = randint


def random_sample(shape=None, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Uniform [0, 1) samples with a shape tuple argument."""
    if shape is None:
        shape = ()
    shape = sanitize_shape(shape) if shape != () else ()
    return rand(*shape, dtype=dtype, split=split, device=device, comm=comm) if shape else rand(dtype=dtype)


random = random_sample
ranf = random_sample
sample = random_sample


def normal(mean=0.0, std=1.0, shape=None, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Normal samples with the given mean and standard deviation."""
    if shape is None:
        shape = ()
    shape = sanitize_shape(shape) if shape != () else ()
    base = randn(*shape, dtype=dtype, split=split, device=device, comm=comm)
    return (base * std + mean).astype(base.dtype)


def standard_normal(shape=None, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Standard-normal samples with a shape tuple argument."""
    if shape is None:
        shape = ()
    shape = sanitize_shape(shape) if shape != () else ()
    return randn(*shape, dtype=dtype, split=split, device=device, comm=comm)


def uniform(low=0.0, high=1.0, size=None, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Uniform [low, high) samples."""
    if size is None:
        size = ()
    shape = sanitize_shape(size) if size != () else ()
    base = rand(*shape, dtype=dtype, split=split, device=device, comm=comm)
    return (base * (high - low) + low).astype(base.dtype)


def _shuffle(key: Key, n: int, tdev: torch.device) -> torch.Tensor:
    """jax's ``_shuffle`` of ``arange(n)`` (int64): ⌈3 ln n / ln(2^32 - 1)⌉
    rounds, each a stable sort by 32-bit keys drawn from the second half
    of ``split(key)``, the first half carrying on."""
    x = torch.arange(n, dtype=torch.int64, device=tdev)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = _split(key)
        sort_keys = _fill(sub, chunk_layout((n,), None, 0, 0), "bits32", tdev).to(torch.int64) & _M32
        x = x[torch.sort(sort_keys, stable=True).indices]
    return x


def randperm(n: int, dtype=types.int64, split=None, device=None, comm=None) -> DNDarray:
    """A random permutation of ``arange(n)``; a split result keeps each
    rank's chunk of the permutation, which every rank computes whole."""
    dtype = types.canonical_heat_type(dtype)
    device = devices.sanitize_device(device)
    comm = sanitize_comm(comm)
    key = _next_key(int(n))
    perm = _shuffle(key, int(n), device.torch_device).to(dtype.torch_type())
    split = sanitize_axis((int(n),), split)
    return DNDarray(perm[comm.chunk((int(n),), split)[2]], gshape=(int(n),), dtype=dtype, split=split, device=device,
                    comm=comm)


def permutation(x, split=None, device=None, comm=None) -> DNDarray:
    """A random permutation of ``arange(x)`` for an int ``x``, else ``x``
    shuffled along its first axis (split as ``x``)."""
    if isinstance(x, (int, np.integer)):
        return randperm(int(x), split=split, device=device, comm=comm)
    if not isinstance(x, DNDarray):
        raise TypeError(f"x must be int or DNDarray, got {type(x)}")
    key = _next_key(x.shape[0])
    perm = _shuffle(key, x.shape[0], x.larray.device)
    if x.split == 0:
        off, lshape, _ = x.comm.chunk(x.gshape, 0)
        perm = perm[off : off + lshape[0]]
    result = x._logical()[perm]
    if x.split not in (None, 0):
        result = result[x.comm.chunk(x.gshape, x.split)[2]]
    return DNDarray(result.contiguous(), gshape=x.gshape, dtype=x.dtype, split=x.split, device=x.device, comm=x.comm)
