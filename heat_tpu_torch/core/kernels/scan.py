"""The scan along one axis: cumsum and cumprod.

- :func:`scan_axis` — the wrapper: the inclusive ``"add"`` or ``"mul"``
  scan of a tensor along ``axis``. On a CUDA tensor of a type the kernel
  takes (float32, float64, int32, int64, bool) it launches the hand-written
  kernel ``csrc/scan.cu`` (reduce-then-scan over tiles of the axis, see the
  source's header); a tensor on the CPU, or of another type (float16,
  bfloat16, complex, 8- and 16-bit integers: decided by type before any
  launch), runs the plain version, and ``KERNEL_STATS["scan_axis.torch"]``
  counts it. A kernel that fails to build or launch raises.
- :func:`scan_begin` / :func:`scan_finish` — the same scan in two steps,
  the totals step exposed: ``scan_begin`` reads the input once for the
  tiles' totals and gives the fold of the whole axis
  (:attr:`ScanState.total`); ``scan_finish(state, carry)`` scans with
  ``carry`` folded in front of every element. A split-axis cumsum gathers
  the ranks' totals between the two and passes the rank's exclusive prefix
  as the carry (``core/_operations.py:_cum_op``).
- :func:`scan_axis_plain` — the plain PyTorch version, with the kernel's
  dataflow: the tiles' totals, their exclusive scan from the carry, then
  each tile's scan from its prefix, with the tile's rows ``rows_per_tile``
  a parameter (None: one tile, a single ``torch.cumsum``). It is the CPU
  route (one tile) and the card's oracle, and covers every type the port's
  cumsum takes.

Types: the scan keeps its input's type, bool accumulates in int64 (as
``torch.cumsum`` and ``jnp.cumsum`` do); integers wrap.

Replaces no Pallas kernel: ``heat_tpu`` runs ``jnp.cumsum``/``jnp.cumprod``
through XLA (``heat_tpu/core/_operations.py:644``). Bound on the card: the
bytes of one read of the input and one write of the output.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ._dispatch import count_launch, dispatch_mode, record_dispatch, register_kernel

__all__ = ["SCAN_KERNEL", "ScanPlan", "ScanState", "scan_axis", "scan_axis_plain", "scan_begin", "scan_dtype",
           "scan_finish", "scan_plan"]

SCAN_KERNEL = register_kernel(
    "scan_axis",
    comparator="scan_axis_plain (the tiles' totals, their scan, each tile's torch.cumsum from its prefix)",
    roofline="one read of the input and one write of the output (reduce-then-scan reads the input twice) — "
             "bandwidth bound",
    replaces="none: XLA's scan of jnp.cumsum/cumprod, heat_tpu/core/_operations.py:644",
)

# csrc/scan.cu's threads a block and rows a thread holds a step
_THREADS, _K = 256, 4
# rows of the innermost axis shorter than this run a thread a row (sc_rows)
_ROWS_MAX = 1024
# the tiles route aims at this many blocks an SM: one wave with enough loads in flight
_BLOCKS_PER_SM = 4
_KERNEL_DTYPES = {torch.float32: 0, torch.float64: 1, torch.int32: 2, torch.int64: 3, torch.bool: 4}
_OPS = {"add": 0, "mul": 1}
_COL1, _COLV, _ROWPACK = 0, 1, 2
_TOTALS, _SCAN, _EXCL, _ROW_TOTALS, _ROW_SCAN = 0, 1, 2, 3, 4


def scan_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type a scan of ``dtype`` accumulates in and returns: its own,
    int64 for bool."""
    return torch.int64 if dtype == torch.bool else dtype


def _identity(op: str, dtype: torch.dtype, shape, device) -> torch.Tensor:
    return (torch.zeros if op == "add" else torch.ones)(shape, dtype=dtype, device=device)


def _view3(shape, axis: int):
    """(outer, n, inner) of a contiguous tensor of ``shape`` along ``axis``."""
    outer = inner = 1
    for d in shape[:axis]:
        outer *= int(d)
    for d in shape[axis + 1:]:
        inner *= int(d)
    return outer, int(shape[axis]), inner


class ScanPlan(NamedTuple):
    """A launch plan of ``csrc/scan.cu``: the route (``"tiles"``, or
    ``"rows"``: a thread a row), the load mode and columns a load, the lane
    groups a block (``lx``), lane groups a row and chunks of them, the rows
    of a tile, the tiles and the blocks."""

    route: str
    mode: int
    vec: int
    lx: int
    groups: int
    chunks: int
    rows: int
    tiles: int
    blocks: int

    def fold_depth(self) -> int:
        """The most roundings on any element's path through the kernel's
        folds, a carry included: a tile's total folds at most ``rows``
        values in a thread, then up to 5 shuffles and 8 warps; the totals'
        scan adds at most ``tiles`` and the last tile's scan ``rows``, each
        with its own shuffles, warps and three folds of the prefix (the
        rows route: ``rows`` in a thread). So a float scan is within
        gamma_d sum_{j<=i} |x_j| of the exact one, d this depth."""
        return self.rows + self.tiles + 64


def _pow2_at_least(v: int) -> int:
    p = 1
    while p < v:
        p *= 2
    return p


def scan_plan(outer: int, n: int, inner: int, dtype: torch.dtype, sms: int, aligned: bool = True,
              single_tile: bool = False) -> ScanPlan:
    """The plan of a scan of an (outer, n, inner) view of ``dtype`` on a
    card of ``sms`` SMs. ``aligned``: the input and output lie on 16-byte
    boundaries (packed loads allowed); ``single_tile``: one tile a lane
    (the scan of the tiles' totals)."""
    if inner == 1 and n < _ROWS_MAX and not single_tile:  # staged through shared memory: any alignment
        return ScanPlan("rows", _COL1, 1, 1, 1, 1, n, 1, max(1, -(-outer // _THREADS)))
    width = 2 if torch.empty((), dtype=dtype).element_size() == 8 else 4
    if inner == 1:
        mode, vec = (_ROWPACK if aligned and (n % _K == 0 or outer == 1) else _COL1), 1
    elif aligned and inner % width == 0 and not single_tile:
        mode, vec = _COLV, width
    else:
        mode, vec = _COL1, 1
    groups = inner // vec
    lx = min(32, _pow2_at_least(groups))
    chunks = -(-groups // lx)
    step = (_THREADS // lx) * _K
    other = outer * chunks
    t_max = max(1, -(-n // step))
    tiles = 1 if single_tile else max(1, min(-(-(_BLOCKS_PER_SM * sms) // other), t_max))
    rows = -(-max(1, -(-n // tiles)) // step) * step
    tiles = max(1, -(-n // rows))
    return ScanPlan("tiles", mode, vec, lx, groups, chunks, rows, tiles, other * tiles)


class _Geom(ctypes.Structure):
    _fields_ = [("outer", ctypes.c_longlong), ("n", ctypes.c_longlong), ("inner", ctypes.c_longlong),
                ("rows", ctypes.c_longlong), ("tiles", ctypes.c_longlong), ("lx", ctypes.c_int),
                ("groups", ctypes.c_int), ("chunks", ctypes.c_int), ("pad", ctypes.c_int)]


_lib = None


def _library():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("scan")
        p = ctypes.c_void_p
        lib.scan_axis_stage.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, p, p, p, p,
                                        ctypes.c_longlong, ctypes.c_int, p]
        lib.scan_axis_stage.restype = ctypes.c_int
        lib.scan_axis_geom_bytes.restype = ctypes.c_longlong
        if lib.scan_axis_geom_bytes() != ctypes.sizeof(_Geom):
            raise RuntimeError(f"scan_axis: the binding's geometry is {ctypes.sizeof(_Geom)} bytes, the kernel's "
                               f"{lib.scan_axis_geom_bytes()}")
        _lib = lib
    return _lib


def _stage(stage: int, dtype: torch.dtype, op: str, plan: ScanPlan, dims, src: torch.Tensor, dst: torch.Tensor,
           prefix: Optional[torch.Tensor]) -> None:
    outer, n, inner = dims
    g = _Geom(outer, n, inner, plan.rows, plan.tiles, plan.lx, plan.groups, plan.chunks, 0)
    dev = src.device
    err = _library().scan_axis_stage(stage, _KERNEL_DTYPES[dtype], _OPS[op], plan.mode, src.data_ptr(),
                                     dst.data_ptr(), None if prefix is None else prefix.data_ptr(),
                                     ctypes.byref(g), plan.blocks, dev.index or 0,
                                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"scan_axis kernel launch (stage {stage}) failed with CUDA error {err}")
    count_launch(SCAN_KERNEL)  # a stage starts one kernel


class ScanState:
    """A scan between its two steps: the input as (outer, n, inner), the
    tiles' totals, and :attr:`total`, the fold of the whole axis in the
    input's shape with the axis of extent 1 (None unless asked for)."""

    __slots__ = ("x", "axis", "op", "dims", "acc", "route", "plan", "tile_totals", "local", "total")

    def __init__(self, x, axis, op, dims, acc, route):
        self.x, self.axis, self.op, self.dims, self.acc, self.route = x, axis, op, dims, acc, route
        self.plan = self.tile_totals = self.local = self.total = None

    @property
    def keep_shape(self):
        return tuple(1 if d == self.axis else s for d, s in enumerate(self.x.shape))


def _cum(v: torch.Tensor, dim: int, op: str, dtype: torch.dtype) -> torch.Tensor:
    return (torch.cumsum if op == "add" else torch.cumprod)(v, dim, dtype=dtype)


def _combine(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.add(a, b) if op == "add" else torch.mul(a, b)


def _plain_begin(st: ScanState, rows_per_tile: Optional[int]) -> None:
    outer, n, inner = st.dims
    v = st.x.reshape(outer, n, inner)
    if rows_per_tile is None or rows_per_tile >= n:
        st.local = _cum(v, 1, st.op, st.acc)
        st.tile_totals = st.local[:, n - 1:, :] if n else _identity(st.op, st.acc, (outer, 1, inner), v.device)
        st.total = st.tile_totals
        return
    r = int(rows_per_tile)
    if r < 1:
        raise ValueError(f"scan_axis_plain: rows_per_tile must be >= 1, got {r}")
    tiles = -(-n // r)
    if tiles * r > n:  # the last tile padded with the identity, after every valid row
        v = torch.cat([v.to(st.acc), _identity(st.op, st.acc, (outer, tiles * r - n, inner), v.device)], dim=1)
    st.local = _cum(v.reshape(outer, tiles, r, inner), 2, st.op, st.acc)
    st.tile_totals = st.local[:, :, -1, :]
    st.total = _cum(st.tile_totals, 1, st.op, st.acc)[:, -1:, :]


def _plain_finish(st: ScanState, carry: Optional[torch.Tensor]) -> torch.Tensor:
    outer, n, inner = st.dims
    if st.local.dim() == 3:  # one tile
        out = st.local if carry is None else _combine(st.op, st.local, carry)
        return out.reshape(st.x.shape)
    tiles = st.local.shape[1]
    inc = _cum(st.tile_totals, 1, st.op, st.acc)
    excl = torch.cat([_identity(st.op, st.acc, (outer, 1, inner), inc.device), inc[:, :-1, :]], dim=1)
    pre = excl if carry is None else _combine(st.op, carry, excl)
    out = _combine(st.op, pre.unsqueeze(2), st.local)
    if carry is None:
        out[:, 0] = st.local[:, 0]  # the first tile's prefix is the identity: its rows as they are
    return out.reshape(outer, tiles * st.local.shape[2], inner)[:, :n, :].reshape(st.x.shape)


def _check(x: torch.Tensor, axis: int, op: str) -> int:
    if op not in _OPS:
        raise ValueError(f"scan_axis: op must be 'add' or 'mul', got {op!r}")
    if x.dim() == 0:
        raise ValueError("scan_axis needs at least one dimension")
    if not -x.dim() <= axis < x.dim():
        raise IndexError(f"scan_axis: axis {axis} out of range for {x.dim()} dimensions")
    return axis % x.dim()


def scan_begin(x: torch.Tensor, axis: int, op: str = "add", need_total: bool = True) -> ScanState:
    """The first step of a scan of ``x`` along ``axis``: on a card the
    tiles' totals (pass 1) and, with ``need_total``, :attr:`ScanState.total`;
    the plain version (one tile) elsewhere."""
    axis = _check(x, axis, op)
    x = x.contiguous()
    acc = scan_dtype(x.dtype)
    dims = _view3(x.shape, axis)
    if x.device.type == "meta":  # a layout probe: no dispatch to report
        st = ScanState(x, axis, op, dims, acc, "torch")
        _plain_begin(st, None)
        st.total = st.total.reshape(st.keep_shape)
        return st
    mode = dispatch_mode(SCAN_KERNEL, x)
    if mode == "cuda" and x.dtype not in _KERNEL_DTYPES:
        mode = "torch"  # the declared route of the types the kernel does not take
    record_dispatch(SCAN_KERNEL, mode)
    st = ScanState(x, axis, op, dims, acc, mode)
    if mode == "torch":
        if x.device.type not in ("cpu", "cuda"):
            raise ValueError(f"scan_axis supports CUDA and CPU tensors, got {x.device}")
        _plain_begin(st, None)
        st.total = st.total.reshape(st.keep_shape) if need_total else None
        return st
    outer, n, inner = dims
    if outer * n * inner == 0:
        st.total = _identity(op, acc, st.keep_shape, x.device) if need_total else None
        return st
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    # 16-byte packs: the input's pointer (bool: 4-byte packs); the output is a fresh allocation
    aligned = x.data_ptr() % (4 if x.dtype == torch.bool else 16) == 0
    st.plan = plan = scan_plan(outer, n, inner, x.dtype, sms, aligned)
    if plan.route == "rows":
        if need_total:
            st.total = torch.empty(st.keep_shape, dtype=acc, device=x.device)
            _stage(_ROW_TOTALS, x.dtype, op, plan, dims, x, st.total, None)
        return st
    if plan.tiles > 1:
        st.tile_totals = torch.empty((outer, plan.tiles, inner), dtype=acc, device=x.device)
        _stage(_TOTALS, x.dtype, op, plan, dims, x, st.tile_totals, None)
    if need_total:
        st.total = torch.empty(st.keep_shape, dtype=acc, device=x.device)
        if plan.tiles > 1:  # the fold of the tiles' totals: pass 1 over them, one tile
            tdims = (outer, plan.tiles, inner)
            tplan = scan_plan(*tdims, acc, sms, single_tile=True)
            _stage(_TOTALS, acc, op, tplan, tdims, st.tile_totals, st.total, None)
        else:
            _stage(_TOTALS, x.dtype, op, plan, dims, x, st.total, None)
    return st


def scan_finish(st: ScanState, carry: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The scan of ``scan_begin``'s input, ``carry`` (in the shape of
    :attr:`ScanState.total`, the scan's type) folded in front of every
    element: ``carry op x_0 op ... op x_i``."""
    outer, n, inner = st.dims
    if carry is not None:
        carry = carry.to(st.acc).reshape(outer, 1, inner).contiguous()
    if st.route == "torch":
        return _plain_finish(st, carry)
    x, plan = st.x, st.plan
    out = torch.empty(x.shape, dtype=st.acc, device=x.device)
    if plan is None:  # no elements
        return out
    if carry is not None and carry.device != x.device:
        raise ValueError(f"scan_axis: carry on {carry.device}, input on {x.device}")
    if plan.route == "rows":
        _stage(_ROW_SCAN, x.dtype, st.op, plan, st.dims, x, out, carry)
    elif plan.tiles > 1:
        tdims = (outer, plan.tiles, inner)
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        prefix = torch.empty(tdims, dtype=st.acc, device=x.device)
        _stage(_EXCL, st.acc, st.op, scan_plan(*tdims, st.acc, sms, single_tile=True), tdims, st.tile_totals,
               prefix, carry)
        _stage(_SCAN, x.dtype, st.op, plan, st.dims, x, out, prefix)
    else:
        _stage(_SCAN, x.dtype, st.op, plan, st.dims, x, out, carry)
    return out


def scan_axis(x: torch.Tensor, axis: int, op: str = "add") -> torch.Tensor:
    """The inclusive ``op`` scan of ``x`` along ``axis`` (``"add"``: cumsum,
    ``"mul"``: cumprod), in ``x``'s type (bool: int64). See the module's
    docstring for the routes."""
    return scan_finish(scan_begin(x, axis, op, need_total=False))


def scan_axis_plain(x: torch.Tensor, axis: int, op: str = "add", carry: Optional[torch.Tensor] = None,
                    rows_per_tile: Optional[int] = None) -> torch.Tensor:
    """The plain version of :func:`scan_axis`, on any device: the tiles'
    totals, their exclusive scan from ``carry``, each tile's scan from its
    prefix, tiles of ``rows_per_tile`` rows (None: one tile)."""
    axis = _check(x, axis, op)
    x = x.contiguous()
    st = ScanState(x, axis, op, _view3(x.shape, axis), scan_dtype(x.dtype), "torch")
    _plain_begin(st, rows_per_tile)
    if carry is not None:
        carry = carry.to(st.acc).reshape(st.dims[0], 1, st.dims[2])
    return _plain_finish(st, carry)
