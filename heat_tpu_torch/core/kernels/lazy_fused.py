"""Fused elementwise segments of the lazy layer: one kernel for every chain.

- :func:`lazy_fused` — the wrapper. On CUDA tensors it launches the
  hand-written kernel ``csrc/lazy_fused.cu``, which interprets a segment's
  :class:`SegmentProgram` in one pass over tiles of the segment (see the
  source's header); on CPU tensors it runs the plain version. It never
  falls back: a CUDA tensor gets the kernel or an error. The kernel's plan
  of a segment (routes, shared-memory layout, the sum's route) is built
  once per program structure, shape and input layouts and cached; a call
  patches its pointers and immediates (:func:`describe` shows the plan).
- :func:`lazy_fused_plain` — the plain PyTorch version: the same program,
  one torch op per instruction, each on its operands at their own shapes,
  as eager execution runs them. It is the CPU route and the card's oracle.

A program is a short instruction list over slots: the inputs fill slots
``0..n_in-1``; instruction ``(op, dst, a, b, imm, f64)`` writes slot
``dst`` from slot ``a`` and slot ``b`` (``-1``: the immediate ``imm``),
rounding in float64 where ``f64`` else float32; outputs read slots. The
ops are ``OPS``' names; each input broadcasts to the segment's shape.

A segment whose one output only a sum or a mean reads is run with
``reduce=axis`` (an int, or None for every axis): the output is summed in
the same pass and never stored, and the call returns this rank's sum with
the summed axes kept (extent 1). The kernel adds each value, rounded to the
output's type, in double, with a fixed-order fold of per-block partials
(two launches: the segment, then the fold); the plain version sums the
program's output with ``torch.sum``, as the eager ``sum`` does.

Replaces no Pallas kernel: ``heat_tpu`` runs a captured chain as one XLA
program, whose fusion this kernel stands in for. Bound on the card: the
bytes of every input read once and every output written once (a summed
output: its few partials).
"""
from __future__ import annotations

import ctypes
from collections import OrderedDict
from typing import List, NamedTuple, Sequence, Tuple

import torch

from ._dispatch import count_launch, dispatch_mode, record_dispatch, register_kernel

__all__ = ["LAZY_KERNEL", "MAX_DIMS", "MAX_IN", "MAX_INSTR", "MAX_OUT", "MAX_SLOTS_F64", "OPS", "SegmentProgram",
           "describe", "divider", "input_route", "lazy_fused", "lazy_fused_plain", "max_slots", "reduce_plan",
           "segment_bytes", "sum_route", "tile_elems"]

LAZY_KERNEL = register_kernel(
    "lazy_fused",
    comparator="lazy_fused_plain (the same program, one torch op per instruction)",
    roofline="each input read once, each output written once; a few flops per element — bandwidth bound",
    replaces="none: heat_tpu/core/lazy/evaluate.py:_build_program (XLA's fusion of a captured chain)",
)

# limits of csrc/lazy_fused.cu (LF_MAX_*); a segment on double registers holds at most MAX_SLOTS_F64 slots
# (inputs and instructions), as its register file lives in shared memory
MAX_DIMS, MAX_IN, MAX_OUT, MAX_INSTR, MAX_SLOTS_F64 = 4, 8, 8, 32, 28

# opcode names in csrc/lazy_fused.cu's order, and the torch function the plain version runs
OPS = ("add", "sub", "mul", "div", "pow", "neg", "abs", "exp", "log", "sqrt", "gt", "ge", "lt", "le", "eq", "ne")
_OPCODE = {name: i for i, name in enumerate(OPS)}
UNARY = frozenset({"neg", "abs", "exp", "log", "sqrt"})
_TORCH = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.true_divide, "pow": torch.pow,
    "neg": torch.neg, "abs": torch.abs, "exp": torch.exp, "log": torch.log, "sqrt": torch.sqrt,
    "gt": torch.gt, "ge": torch.ge, "lt": torch.lt, "le": torch.le, "eq": torch.eq, "ne": torch.ne,
}
_DTYPES = {torch.float32: 0, torch.float64: 1, torch.bool: 2}


class SegmentProgram(NamedTuple):
    """A segment's plan: ``n_in`` inputs, the instructions
    ``(op, dst, a, b, imm, f64)``, and the outputs ``(slot, torch dtype)``."""

    n_in: int
    instrs: Tuple[Tuple[str, int, int, int, float, bool], ...]
    outputs: Tuple[Tuple[int, torch.dtype], ...]


def max_slots(prog: SegmentProgram, input_dtypes: Sequence[torch.dtype]) -> int:
    """The most slots (inputs and instructions) the kernel takes for this
    segment: fewer where it runs on double registers, which it does where
    an op, an input or an output is float64."""
    f64 = (any(f64 for *_, f64 in prog.instrs) or torch.float64 in input_dtypes
           or any(dt == torch.float64 for _, dt in prog.outputs))
    return MAX_SLOTS_F64 if f64 else MAX_IN + MAX_INSTR


def _sum_kept(t: torch.Tensor, axis) -> torch.Tensor:
    """``t`` summed over ``axis`` (None: every axis), the summed axes kept,
    as the eager ``sum`` reduces it."""
    if axis is None:
        return torch.sum(t).reshape((1,) * t.dim())
    return torch.sum(t, dim=axis, keepdim=True)


def lazy_fused_plain(prog: SegmentProgram, inputs: Sequence[torch.Tensor], shape, reduce=False) -> List[torch.Tensor]:
    """The program run one torch op per instruction: each operand is cast to
    the op's precision and meets the other at its own shape, as eager
    execution computes it. With ``reduce`` (an axis, or None for every
    axis; False: no sum) its one output summed with the axes kept."""
    dev = inputs[0].device
    slots: list = list(inputs) + [None] * len(prog.instrs)
    for op, dst, a, b, imm, f64 in prog.instrs:
        tt = torch.float64 if f64 else torch.float32
        x = slots[a].to(tt) if a >= 0 else torch.tensor(imm, dtype=tt, device=dev)
        if op in UNARY:
            slots[dst] = _TORCH[op](x)
        else:
            y = slots[b].to(tt) if b >= 0 else torch.tensor(imm, dtype=tt, device=dev)
            slots[dst] = _TORCH[op](x, y)
    shape = tuple(shape)
    out = []
    for slot, dt in prog.outputs:
        t = slots[slot].to(dt)
        out.append(t if tuple(t.shape) == shape else t.expand(shape).contiguous())
    if reduce is not False:
        return [_sum_kept(out[0], reduce)]
    return out


def segment_bytes(prog: SegmentProgram, inputs: Sequence[torch.Tensor], shape) -> int:
    """Bytes a segment must move at least: each input's own elements read
    once, each output written once."""
    n = 1
    for s in shape:
        n *= int(s)
    read = sum(t.numel() * t.element_size() for t in inputs)
    return read + sum(n * torch.empty((), dtype=dt).element_size() for _, dt in prog.outputs)


_A_ACC, _B_ACC, _KEEP = 1, 2, 4  # an operand is the previous result; the result is kept in shared memory


def _flags(prog: SegmentProgram, k: int) -> int:
    """Instruction k's register flags: which operand is the previous result
    (the kernel reads it from registers), and whether its own result is kept
    in a slot of shared memory: read later than by the next instruction, or
    an output that a later instruction's result displaces from the
    registers (the last result reaches its outputs from registers)."""
    op, dst, a, b, _, _ = prog.instrs[k]
    prev = prog.instrs[k - 1][1] if k else None
    flags = (_A_ACC if a >= 0 and a == prev else 0) | (_B_ACC if b >= 0 and b == prev else 0)
    late = any(j != k + 1 and dst in (ja, jb) for j, (_, _, ja, jb, _, _) in enumerate(prog.instrs))
    if late or (k != len(prog.instrs) - 1 and any(slot == dst for slot, _ in prog.outputs)):
        flags |= _KEEP
    return flags


# csrc/lazy_fused.cu's LfRoute, LfKind and LfMode; its threads a block, elements a thread a step (float or
# double register file), shared memory a block may take, bytes of its mbarriers, most stages of an input's ring
ROUTES = ("bulk", "tile", "flat", "strided")
_K_IMM, _K_ACC, _K_F32, _K_F64, _K_U8 = range(5)
_STORE, _SUM_TILES, _SUM_LANES = range(3)
MODES = ("store", "sum tiles", "sum lanes")
_THREADS = {False: 64, True: 128}
_PER_THREAD = {False: 16, True: 4}
_MAX_SMEM, _BARRIER_BYTES, _MAX_STAGES = 232448, 64, 4
# a plan takes its deepest ring (stages, output staging tiles) that lets an SM hold _WARPS_PER_SM warps of its
# blocks (its 228 KiB of shared memory, 1 KiB reserved a block), else the deepest that fits a block
_SM_SMEM, _WARPS_PER_SM = 233472, 16
_DEPTHS = ((4, 2), (3, 2), (3, 1), (2, 2), (2, 1))
_SIZE = {torch.float32: 4, torch.float64: 8, torch.bool: 1}
_KIND = {torch.float32: _K_F32, torch.float64: _K_F64, torch.bool: _K_U8}
# a terminal sum on the lanes route: rows of the innermost axis shorter than this are summed a thread a row;
# otherwise blocks of lanes x a chunk of the summed axis, about this many blocks an SM
_SHORT_ROWS, _SUM_BLOCKS_PER_SM = 256, 8
_CACHE_SIZE = 256  # cached plans (structure, shape, layouts), least recently used dropped


def tile_elems(reg64: bool) -> int:
    """Elements of a tile: a block's threads times the elements a thread
    holds a step (on a double register file, half as many)."""
    return _THREADS[bool(reg64)] * _PER_THREAD[bool(reg64)]


def _smem_share(reg64: bool) -> int:
    """The most shared memory a block may take for its SM to hold
    _WARPS_PER_SM warps of such blocks."""
    blocks = max(1, _WARPS_PER_SM * 32 // _THREADS[bool(reg64)])
    return _SM_SMEM // blocks - 1024


def divider(d: int, bits: int = 32) -> Tuple[int, int]:
    """``(magic, shift)`` of a divisor ``d >= 1``: for ``0 <= i < 2^(bits-1)``,
    ``q = ((i * magic >> bits) + i) >> shift`` is ``i // d`` (and ``i - q d``
    is ``i % d``), as the kernel computes it with one multiply-high
    (Granlund and Montgomery; torch's ``IntDivider``)."""
    shift = (d - 1).bit_length()
    return ((1 << bits) * ((1 << shift) - d)) // d + 1, shift


class _Src(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int), ("off", ctypes.c_int), ("stage", ctypes.c_int)]


class _Div(ctypes.Structure):
    _fields_ = [("magic", ctypes.c_ulonglong), ("shift", ctypes.c_int), ("pad", ctypes.c_int)]


class _Input(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("stride", ctypes.c_longlong * MAX_DIMS), ("dtype", ctypes.c_int),
                ("route", ctypes.c_int), ("off", ctypes.c_int), ("stage", ctypes.c_int)]


class _Output(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("src", _Src), ("dtype", ctypes.c_int), ("off", ctypes.c_int),
                ("stage", ctypes.c_int), ("pad", ctypes.c_int)]


class _Instr(ctypes.Structure):
    _fields_ = [("imm", ctypes.c_double), ("op", ctypes.c_int), ("f64", ctypes.c_int), ("a", _Src), ("b", _Src),
                ("keep", ctypes.c_int), ("inplace", ctypes.c_int)]


# ops the kernel runs in place on the previous result and the immediate, on a float register file
# (csrc/lazy_fused.cu's lf_inplace)
INPLACE_OPS = frozenset({"add", "sub", "mul", "div", "neg", "abs", "exp"})


class _Reduce(ctypes.Structure):
    _fields_ = [("outer", ctypes.c_longlong), ("r", ctypes.c_longlong), ("inner", ctypes.c_longlong),
                ("rows", ctypes.c_longlong), ("chunks", ctypes.c_longlong), ("lane_tiles", ctypes.c_longlong),
                ("tx", ctypes.c_int), ("ty", ctypes.c_int), ("rows_mode", ctypes.c_int), ("pad", ctypes.c_int)]


class _Plan(ctypes.Structure):
    _fields_ = [("shape", ctypes.c_longlong * MAX_DIMS), ("div", _Div * MAX_DIMS), ("n", ctypes.c_longlong),
                ("tiles", ctypes.c_longlong), ("n_in", ctypes.c_int), ("n_out", ctypes.c_int),
                ("n_instr", ctypes.c_int), ("mode", ctypes.c_int), ("stages", ctypes.c_int),
                ("out_bufs", ctypes.c_int), ("bulk_bytes", ctypes.c_int), ("idx64", ctypes.c_int),
                ("inner", ctypes.c_int), ("red_off", ctypes.c_int), ("inp", _Input * MAX_IN),
                ("out", _Output * MAX_OUT), ("ins", _Instr * MAX_INSTR)]


def _axes(shape, axis) -> Tuple[int, int, int]:
    """``shape`` viewed as (outer, r, inner) around the summed ``axis`` (None: every axis)."""
    n = 1
    for d in shape:
        n *= d
    if axis is None:
        return 1, n, 1
    outer = inner = 1
    for d in shape[:axis]:
        outer *= d
    for d in shape[axis + 1:]:
        inner *= d
    return outer, shape[axis], inner


def sum_route(shape, axis, reg64: bool = False) -> str:
    """The terminal sum's route: ``"tiles"`` where every position of the kept
    axes lies in the innermost ``inner`` elements and ``inner`` divides a
    block's threads (thread t's lane is t % inner: every axis, or a leading
    axis over rows of 1-64 columns, powers of two, on a float register file),
    else ``"lanes"``."""
    outer, _, inner = _axes(tuple(int(d) for d in shape), axis)
    return "tiles" if outer == 1 and _THREADS[bool(reg64)] % inner == 0 else "lanes"


def reduce_plan(shape, axis, sms: int, reg64: bool = False) -> Tuple[Tuple[int, ...], int]:
    """The lanes route's launch plan of a terminal sum over ``axis`` (None:
    every axis) of a segment of ``shape`` on a card of ``sms`` SMs, on a
    float (or double) register file: ``((outer, r, inner, rows, chunks,
    lane_tiles, tx, ty, rows_mode), blocks)``."""
    shape = tuple(int(d) for d in shape)
    threads, per_thread = _THREADS[bool(reg64)], _PER_THREAD[bool(reg64)]
    outer, r, inner = _axes(shape, axis)
    if inner == 1 and outer > 1 and r < _SHORT_ROWS:
        return (outer, r, inner, r, 1, 1, 1, 1, 1), -(-outer // threads)
    tx = min(inner, 32)
    ty = threads // tx
    lane_tiles = -(-inner // tx)
    step = ty * per_thread
    other = lane_tiles * outer
    chunks = max(1, min(-(-(_SUM_BLOCKS_PER_SM * sms) // other), -(-r // step)))
    rows = -(-max(1, -(-r // chunks)) // step) * step
    chunks = max(1, -(-r // rows))
    return (outer, r, inner, rows, chunks, lane_tiles, tx, ty, 0), other * chunks


def _period(strides, full) -> int:
    """The period of an input's offsets along the flat index of ``full``: the
    elements from its first axis that moves it on (1: one element)."""
    for d in range(MAX_DIMS):
        if full[d] > 1 and strides[d]:
            period = 1
            for s in full[d:]:
                period *= s
            return period
    return 1


def input_route(t: torch.Tensor, strides, full, reg64: bool, lanes: bool) -> str:
    """The kernel's route of an input with ``strides`` at the segment's
    padded shape ``full``: ``bulk`` (flat, 16-byte aligned), ``tile`` (a
    period dividing the tile), ``flat`` (flat, unaligned) or ``strided``.
    The lanes route of a sum reads every input by per-thread loads."""
    contiguous, acc = [0] * MAX_DIMS, 1
    for d in range(MAX_DIMS - 1, -1, -1):
        contiguous[d] = acc
        acc *= full[d]
    flat = all(st == c for st, c, s in zip(strides, contiguous, full) if s > 1)
    if lanes:
        return "flat" if flat else "strided"
    if flat:
        return "bulk" if t.data_ptr() % 16 == 0 else "flat"
    return "tile" if tile_elems(reg64) % _period(strides, full) == 0 else "strided"


class _Entry:
    """A segment's cached launch: the kernel's plan (pointers and immediates
    patched at each call), its routes and shared memory, the grid (found on
    the first launch) and a sum's partials."""

    __slots__ = ("plan", "red", "reg64", "mode", "routes", "stages", "out_bufs", "smem", "kept", "grid",
                 "blocks_per_sm", "partials", "lanes", "chunks", "imms", "imm_array")

    def describe(self) -> dict:
        return {"file": "double" if self.reg64 else "float", "mode": MODES[self.mode], "threads": _THREADS[self.reg64],
                "per_thread": _PER_THREAD[self.reg64], "tile": tile_elems(self.reg64), "routes": list(self.routes),
                "stages": self.stages, "out_bufs": self.out_bufs, "kept_slots": self.kept, "smem": self.smem,
                "blocks_per_sm": self.blocks_per_sm, "grid": self.grid}


_ENTRIES: "OrderedDict[tuple, _Entry]" = OrderedDict()
_SMS: dict = {}
_lib = None


def _check_slots(prog: SegmentProgram, inputs: Sequence[torch.Tensor]) -> bool:
    """Raise where the segment holds more slots than its register file (28
    double, 40 float); return whether it runs on double registers."""
    limit = max_slots(prog, [t.dtype for t in inputs])
    if prog.n_in + len(prog.instrs) > limit:
        raise ValueError(f"lazy_fused: {prog.n_in} inputs and {len(prog.instrs)} instructions exceed the "
                         f"kernel's {limit} slots")
    return limit == MAX_SLOTS_F64


def _entry(prog: SegmentProgram, inputs: Sequence[torch.Tensor], shape, reduce, sms: int) -> _Entry:
    """The cached launch of ``prog`` at ``shape`` on inputs of these layouts
    (types, shapes, strides, 16-byte alignment): built once, then only its
    pointers and immediates change."""
    key = (prog.n_in, tuple(q[:4] + q[5:] for q in prog.instrs), prog.outputs, shape,
           None if reduce is False else ("sum", reduce), sms,
           tuple((t.dtype, t.shape, t.stride(), t.data_ptr() % 16 == 0) for t in inputs))
    e = _ENTRIES.get(key)
    if e is not None:
        _ENTRIES.move_to_end(key)
        return e
    e = _build_entry(prog, inputs, shape, reduce, sms)
    _ENTRIES[key] = e
    if len(_ENTRIES) > _CACHE_SIZE:
        _ENTRIES.popitem(last=False)
    return e


def _build_entry(prog: SegmentProgram, inputs: Sequence[torch.Tensor], shape, reduce, sms: int) -> _Entry:
    e = _Entry()
    full = (1,) * (MAX_DIMS - len(shape)) + tuple(int(s) for s in shape)
    n = 1
    for s in full:
        n *= s
    reg64 = _check_slots(prog, inputs)
    tile = tile_elems(reg64)
    if reduce is False:
        mode = _STORE
    else:
        mode = _SUM_TILES if sum_route(shape, reduce, reg64) == "tiles" else _SUM_LANES
    strides = [(0,) * (MAX_DIMS - len(shape)) + tuple(t.expand(tuple(shape)).stride()) for t in inputs]
    routes = tuple(input_route(t, st, full, reg64, mode == _SUM_LANES) for t, st in zip(inputs, strides))
    max_off = max([n] + [1 + sum((s - 1) * st for s, st in zip(full, sts)) for sts in strides])
    idx64 = max_off >= 2 ** 31
    kept = [k for k in range(len(prog.instrs)) if _flags(prog, k) & _KEEP]
    reg_size = 8 if reg64 else 4
    if mode == _SUM_LANES:
        depths = ((1, 1),)
    elif mode == _SUM_TILES:
        depths = tuple(dict.fromkeys((s, 1) for s, _ in _DEPTHS))
    else:
        depths = _DEPTHS

    def layout(stages, out_bufs):
        off, ins = _BARRIER_BYTES, []
        for t, route in zip(inputs, routes):
            size = _SIZE[t.dtype] * tile
            bufs = 1 if route == "tile" else stages
            ins.append((off, size if bufs > 1 else 0))
            off += bufs * size
        keeps = {}
        for k in kept:
            keeps[k] = off
            off += reg_size * tile
        outs, red = [], 0
        if mode == _STORE:
            for _, dt in prog.outputs:
                size = _SIZE[dt] * tile
                outs.append((off, size if out_bufs > 1 else 0))
                off += out_bufs * size
        else:
            red = off
            off += 8 * _THREADS[reg64]
        return off, ins, keeps, outs, red

    for limit in (_smem_share(reg64), _MAX_SMEM):
        fits = [(d, layout(*d)) for d in depths if layout(*d)[0] <= limit]
        if fits:
            (stages, out_bufs), (smem, ins, keeps, outs, red) = fits[0]
            break
    else:
        raise ValueError(f"lazy_fused: the plan needs {layout(*depths[-1])[0]} bytes of shared memory, more than "
                         f"{_MAX_SMEM}")
    p = _Plan()
    bits = 64 if idx64 else 32
    for d, s in enumerate(full):
        p.shape[d] = s
        p.div[d].magic, p.div[d].shift = divider(s, bits)
    p.n, p.tiles = n, -(-n // tile)
    p.n_in, p.n_out, p.n_instr = len(inputs), len(prog.outputs), len(prog.instrs)
    p.mode, p.stages, p.out_bufs, p.idx64, p.red_off = mode, stages, out_bufs, int(idx64), red
    p.bulk_bytes = sum(_SIZE[t.dtype] * tile for t, r in zip(inputs, routes) if r == "bulk")
    for k, (t, sts, route, (off, stage)) in enumerate(zip(inputs, strides, routes, ins)):
        q = p.inp[k]
        for d, st in enumerate(sts):
            q.stride[d] = st
        q.dtype, q.route, q.off, q.stage = _DTYPES[t.dtype], ROUTES.index(route), off, stage
    last = prog.instrs[-1][1] if prog.instrs else None
    slot_of = {prog.instrs[k][1]: keeps[k] for k in kept}
    file_kind = _K_F64 if reg64 else _K_F32

    def src(q: _Src, slot: int, acc: bool):
        if slot < 0:
            q.kind = _K_IMM
        elif acc:
            q.kind = _K_ACC
        elif slot < len(inputs):
            q.kind, q.off, q.stage = _KIND[inputs[slot].dtype], ins[slot][0], ins[slot][1]
        else:
            q.kind, q.off = file_kind, slot_of[slot]

    for k, (op, dst, a, b, imm, f64) in enumerate(prog.instrs):
        q, flags = p.ins[k], _flags(prog, k)
        q.imm, q.op, q.f64, q.keep = float(imm), _OPCODE[op], int(f64), keeps.get(k, -1)
        src(q.a, a, bool(flags & _A_ACC))
        src(q.b, -1 if op in UNARY else b, bool(flags & _B_ACC))
        q.inplace = int(not reg64 and not f64 and q.a.kind == _K_ACC and q.b.kind == _K_IMM and op in INPLACE_OPS)
    for k, ((slot, dt), (off, stage)) in enumerate(zip(prog.outputs, outs or [(0, 0)] * len(prog.outputs))):
        o = p.out[k]
        src(o.src, slot, slot == last)
        o.dtype, o.off, o.stage = _DTYPES[dt], off, stage
    e.red = _Reduce()
    e.partials = e.lanes = e.chunks = 0
    e.grid = e.blocks_per_sm = None
    if mode == _SUM_TILES:
        outer, r, inner = _axes(tuple(int(s) for s in shape), reduce)
        p.inner = inner
        e.lanes = inner
    elif mode == _SUM_LANES:
        fields, e.grid = reduce_plan(shape, reduce, sms, reg64)
        e.red = _Reduce(*fields, 0)
        outer, _, inner, _, chunks, _, _, _, rows_mode = fields
        e.lanes, e.chunks = outer * inner, 1 if rows_mode else chunks
        e.partials = outer * (1 if rows_mode else chunks * inner)
    e.plan, e.reg64, e.mode, e.routes, e.stages, e.out_bufs = p, reg64, mode, routes, stages, out_bufs
    e.smem, e.kept, e.imms = smem, len(kept), None
    return e


def _library():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("lazy_fused")
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.lazy_fused.argtypes = [p, p, p, p, i32, i32, i32, p, p, i64, i64, i32, p]
        lib.lazy_fused.restype = i32
        lib.lazy_fused_occupancy.argtypes = [i32, i32, i32]
        lib.lazy_fused_occupancy.restype = i32
        got = (ctypes.c_longlong * 10)()
        lib.lazy_fused_layout(got)
        want = (ctypes.sizeof(_Plan), ctypes.sizeof(_Reduce), _THREADS[False], _PER_THREAD[False], _THREADS[True],
                _PER_THREAD[True], MAX_SLOTS_F64, _MAX_SMEM, _BARRIER_BYTES, _MAX_STAGES)
        if tuple(got) != want:
            raise RuntimeError(f"lazy_fused: the binding's layout {want} differs from the kernel's {tuple(got)} "
                               f"(plan and reduce bytes, threads, elements a thread, double slots, shared memory, "
                               f"barrier bytes, stages)")
        _lib = lib
    return _lib


def _device(dev: torch.device) -> Tuple[int, int]:
    """The card's index and SM count (read once a card)."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    sms = _SMS.get(index)
    if sms is None:
        sms = _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return index, sms


def _launch_grid(e: _Entry, index: int, sms: int) -> int:
    """The entry's grid, found at its first launch: persistent (blocks per SM
    at its shared memory, times the SMs, at most a block a tile), or the
    lanes route's own."""
    if e.grid is None:
        per_sm = _library().lazy_fused_occupancy(int(e.reg64), e.smem, index)
        if per_sm <= 0:
            raise RuntimeError(f"lazy_fused: no block fits an SM at {e.smem} bytes of shared memory "
                               f"(occupancy query {per_sm})")
        e.blocks_per_sm = per_sm
        e.grid = max(1, min(per_sm * sms, e.plan.tiles))
        if e.mode == _SUM_TILES:
            e.chunks, e.partials = e.grid, e.grid * e.lanes
    return e.grid


def _lazy_cuda(prog: SegmentProgram, inputs: Sequence[torch.Tensor], shape, reduce=False) -> List[torch.Tensor]:
    dev = inputs[0].device
    for t in inputs:
        if t.device != dev:
            raise ValueError(f"lazy_fused: inputs on {dev} and {t.device}")
    n = 1
    for d in shape:
        n *= int(d)
    if reduce is not False:
        dt = prog.outputs[0][1]
        kept = tuple(1 if reduce is None or d == reduce else s for d, s in enumerate(shape))
        if n == 0:  # nothing to sum: zeros, no launch
            return [torch.zeros(kept, dtype=dt, device=dev)]
        outs = [torch.empty(kept, dtype=dt, device=dev)]
    else:
        outs = [torch.empty(shape, dtype=dt, device=dev) for _, dt in prog.outputs]
        if n == 0:
            return outs
    index, sms = _device(dev)
    e = _entry(prog, inputs, shape, reduce, sms)
    lib = _library()
    grid = _launch_grid(e, index, sms)
    imms = tuple(q[4] for q in prog.instrs)
    if imms != e.imms:
        e.imm_array, e.imms = (ctypes.c_double * max(1, len(imms)))(*imms), imms
    ptrs = (ctypes.c_void_p * (len(inputs) + len(prog.outputs)))(*[t.data_ptr() for t in inputs],
                                                                    *([0] if reduce is not False else
                                                                      [o.data_ptr() for o in outs]))
    if reduce is not False:
        partial = torch.empty(e.partials, dtype=torch.float64, device=dev)
        ppart, presult = partial.data_ptr(), outs[0].data_ptr()
    else:
        ppart = presult = None
    err = lib.lazy_fused(ctypes.byref(e.plan), ptrs, e.imm_array, ctypes.byref(e.red), int(e.reg64), grid, e.smem,
                         ppart, presult, e.lanes, e.chunks, index, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"lazy_fused kernel launch failed with CUDA error {err}")
    count_launch(LAZY_KERNEL)  # the segment
    if reduce is not False:
        count_launch(LAZY_KERNEL)  # the partials' fold
    return outs


def describe(prog: SegmentProgram, inputs: Sequence[torch.Tensor], shape, reduce=False) -> dict:
    """The kernel's launch plan of a segment (``chip_smoke.py``'s ``[design]
    lazy_fused`` lines): register file, mode, threads and elements a thread
    a step, tile, each input's route, ring stages, output staging tiles,
    kept slots, shared-memory bytes, and on a card blocks per SM and grid."""
    shape = tuple(int(s) for s in shape)
    if inputs[0].device.type == "cuda":
        index, sms = _device(inputs[0].device)
        e = _entry(prog, inputs, shape, reduce, sms)
        _launch_grid(e, index, sms)
    else:
        e = _entry(prog, inputs, shape, reduce, 132)
    return e.describe()


def lazy_fused(prog: SegmentProgram, inputs: Sequence[torch.Tensor], shape, reduce=False) -> List[torch.Tensor]:
    """The segment's outputs at ``shape`` (this rank's chunk), contiguous;
    with ``reduce`` (an axis of ``shape``, or None for every axis) its one
    float output's sum over it instead, the summed axes kept. Inputs on a
    card run the hand-written kernel; inputs on the CPU run
    :func:`lazy_fused_plain`."""
    if not inputs:
        raise ValueError("lazy_fused: a segment needs at least one input")
    if len(inputs) > MAX_IN or len(prog.outputs) > MAX_OUT or len(prog.instrs) > MAX_INSTR or len(shape) > MAX_DIMS:
        raise ValueError(f"lazy_fused: {len(inputs)} inputs, {len(prog.outputs)} outputs, {len(prog.instrs)} "
                         f"instructions at {len(shape)} dims exceed the kernel's limits")
    for t in inputs:
        if t.dtype not in _DTYPES:
            raise TypeError(f"lazy_fused: inputs are float32, float64 or bool, got {t.dtype}")
    if reduce is not False:
        if len(prog.outputs) != 1 or prog.outputs[0][1] not in (torch.float32, torch.float64):
            raise ValueError("lazy_fused: a summed segment has one float32 or float64 output")
        if reduce is not None and not 0 <= reduce < len(shape):
            raise ValueError(f"lazy_fused: axis {reduce} out of range for {len(shape)} dimensions")
    mode = dispatch_mode(LAZY_KERNEL, inputs[0])
    if mode == "cuda":  # the slots are checked where the segment's plan is built (once per layout)
        record_dispatch(LAZY_KERNEL, mode)
        return _lazy_cuda(prog, inputs, tuple(shape), reduce)
    _check_slots(prog, inputs)
    record_dispatch(LAZY_KERNEL, mode)
    if inputs[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"lazy_fused supports CUDA and CPU tensors, got {inputs[0].device}")
    return lazy_fused_plain(prog, inputs, shape, reduce)
