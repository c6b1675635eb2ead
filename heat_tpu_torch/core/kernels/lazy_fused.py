"""Fused elementwise segments of the lazy layer: one kernel for every chain.

- :func:`lazy_fused` — the wrapper. On CUDA tensors it launches the
  hand-written kernel ``csrc/lazy_fused.cu``, which interprets a segment's
  :class:`SegmentProgram` per element in one pass (see the source's
  header); on CPU tensors it runs the plain version. It never falls back:
  a CUDA tensor gets the kernel or an error.
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
(two launches: the segment, then the fold); the plain version sums the program's output with ``torch.sum``, as the
eager ``sum`` does.

Replaces no Pallas kernel: ``heat_tpu`` runs a captured chain as one XLA
program, whose fusion this kernel stands in for. Bound on the card: the
bytes of every input read once and every output written once (a summed
output: its few partials).
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence, Tuple

import torch

from ._dispatch import count_launch, dispatch_mode, record_dispatch, register_kernel

__all__ = ["LAZY_KERNEL", "MAX_DIMS", "MAX_IN", "MAX_INSTR", "MAX_OUT", "MAX_SLOTS_F64", "OPS", "SegmentProgram",
           "lazy_fused", "lazy_fused_plain", "max_slots", "reduce_plan", "segment_bytes"]

LAZY_KERNEL = register_kernel(
    "lazy_fused",
    comparator="lazy_fused_plain (the same program, one torch op per instruction)",
    roofline="each input read once, each output written once; a few flops per element — bandwidth bound",
    replaces="none: heat_tpu/core/lazy/evaluate.py:_build_program (XLA's fusion of a captured chain)",
)

# limits of csrc/lazy_fused.cu (LF_MAX_*), its threads a block and elements a thread a step; a segment
# on double registers holds at most MAX_SLOTS_F64 slots (inputs and instructions), as its register file
# lives in shared memory
MAX_DIMS, MAX_IN, MAX_OUT, MAX_INSTR, MAX_SLOTS_F64 = 4, 8, 8, 32, 28
_THREADS, _PER_THREAD = 256, 4
# a terminal sum: rows of the innermost axis shorter than this are summed a thread a row; otherwise blocks of
# lanes x a chunk of the summed axis, about this many blocks an SM
_SHORT_ROWS, _SUM_BLOCKS_PER_SM = 256, 8

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


class _Input(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("stride", ctypes.c_longlong * MAX_DIMS), ("dtype", ctypes.c_int),
                ("flat", ctypes.c_int)]


class _Output(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("slot", ctypes.c_int), ("dtype", ctypes.c_int)]


class _Instr(ctypes.Structure):
    _fields_ = [("imm", ctypes.c_double), ("op", ctypes.c_int), ("dst", ctypes.c_int), ("a", ctypes.c_int),
                ("b", ctypes.c_int), ("f64", ctypes.c_int), ("flags", ctypes.c_int)]


class _Reduce(ctypes.Structure):
    _fields_ = [("outer", ctypes.c_longlong), ("r", ctypes.c_longlong), ("inner", ctypes.c_longlong),
                ("rows", ctypes.c_longlong), ("chunks", ctypes.c_longlong), ("lane_tiles", ctypes.c_longlong),
                ("tx", ctypes.c_int), ("ty", ctypes.c_int), ("rows_mode", ctypes.c_int), ("pad", ctypes.c_int)]


def reduce_plan(shape, axis, sms: int) -> Tuple[Tuple[int, ...], int]:
    """The terminal sum's launch plan for a segment of ``shape`` summed over
    ``axis`` (None: every axis) on a card of ``sms`` SMs: ``((outer, r,
    inner, rows, chunks, lane_tiles, tx, ty, rows_mode), blocks)``."""
    shape = tuple(int(d) for d in shape)
    n = 1
    for d in shape:
        n *= d
    if axis is None:
        outer, r, inner = 1, n, 1
    else:
        outer = inner = 1
        for d in shape[:axis]:
            outer *= d
        for d in shape[axis + 1:]:
            inner *= d
        r = shape[axis]
    if inner == 1 and outer > 1 and r < _SHORT_ROWS:
        return (outer, r, inner, r, 1, 1, 1, 1, 1), -(-outer // _THREADS)
    tx = min(inner, 32)
    ty = _THREADS // tx
    lane_tiles = -(-inner // tx)
    step = ty * _PER_THREAD
    other = lane_tiles * outer
    chunks = max(1, min(-(-(_SUM_BLOCKS_PER_SM * sms) // other), -(-r // step)))
    rows = -(-max(1, -(-r // chunks)) // step) * step
    chunks = max(1, -(-r // rows))
    return (outer, r, inner, rows, chunks, lane_tiles, tx, ty, 0), other * chunks


class _Plan(ctypes.Structure):
    _fields_ = [("shape", ctypes.c_longlong * MAX_DIMS), ("n", ctypes.c_longlong), ("n_in", ctypes.c_int),
                ("n_out", ctypes.c_int), ("n_instr", ctypes.c_int), ("pad", ctypes.c_int),
                ("inp", _Input * MAX_IN), ("out", _Output * MAX_OUT), ("ins", _Instr * MAX_INSTR)]


_lib = None
_A_ACC, _B_ACC, _KEEP = 1, 2, 4  # csrc/lazy_fused.cu's LfFlags


def _flags(prog: SegmentProgram, k: int) -> int:
    """Instruction k's register flags: which operand is the previous result,
    and whether its own result must be stored (read later than by the next
    instruction's register operand, or an output)."""
    op, dst, a, b, _, _ = prog.instrs[k]
    prev = prog.instrs[k - 1][1] if k else None
    flags = (_A_ACC if a >= 0 and a == prev else 0) | (_B_ACC if b >= 0 and b == prev else 0)
    readers = [j for j, (_, _, ja, jb, _, _) in enumerate(prog.instrs) if dst in (ja, jb)]
    if any(j != k + 1 for j in readers) or any(slot == dst for slot, _ in prog.outputs):
        flags |= _KEEP
    return flags


def _quad_ok(inp: "_Input", t: torch.Tensor) -> bool:
    """Whether the kernel's float4 path can read this input a quad at a time."""
    if inp.flat == 2:
        return True
    if t.dtype != torch.float32 or t.data_ptr() % 16:
        return False
    inner = inp.stride[MAX_DIMS - 1]
    return bool(inp.flat) or inner == 0 or (inner == 1 and all(inp.stride[d] % 4 == 0 for d in range(MAX_DIMS - 1)))


def _library():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("lazy_fused")
        lib.lazy_fused.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_void_p]
        lib.lazy_fused.restype = ctypes.c_int
        lib.lazy_fused_reduce.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_void_p]
        lib.lazy_fused_reduce.restype = ctypes.c_int
        lib.lazy_fused_reduce_bytes.restype = ctypes.c_longlong
        if lib.lazy_fused_reduce_bytes() != ctypes.sizeof(_Reduce):
            raise RuntimeError(f"lazy_fused: the binding's reduce plan is {ctypes.sizeof(_Reduce)} bytes, "
                               f"the kernel's {lib.lazy_fused_reduce_bytes()}")
        lib.lazy_fused_plan_bytes.restype = ctypes.c_longlong
        lib.lazy_fused_max_slots64.restype = ctypes.c_int
        if lib.lazy_fused_plan_bytes() != ctypes.sizeof(_Plan):
            raise RuntimeError(f"lazy_fused: the binding's plan is {ctypes.sizeof(_Plan)} bytes, "
                               f"the kernel's {lib.lazy_fused_plan_bytes()}")
        if lib.lazy_fused_max_slots64() != MAX_SLOTS_F64:
            raise RuntimeError(f"lazy_fused: the binding takes {MAX_SLOTS_F64} double slots, "
                               f"the kernel {lib.lazy_fused_max_slots64()}")
        _lib = lib
    return _lib


def _lazy_cuda(prog: SegmentProgram, inputs: Sequence[torch.Tensor], shape, reduce=False) -> List[torch.Tensor]:
    dev = inputs[0].device
    n = 1
    for d in shape:
        n *= int(d)
    if reduce is not False:
        dt = prog.outputs[0][1]
        kept = tuple(1 if reduce is None or d == reduce else s for d, s in enumerate(shape))
        if n == 0:  # nothing to sum: zeros, no launch
            return [torch.zeros(kept, dtype=dt, device=dev)]
        result = torch.empty(kept, dtype=dt, device=dev)
        plan, reg64, idx64, _ = _plan_struct(prog, inputs, shape, [0], n)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        fields, blocks = reduce_plan(shape, reduce, sms)
        red = _Reduce(*fields, 0)
        partial = torch.empty(fields[0] * (1 if fields[8] else fields[4] * fields[2]), dtype=torch.float64,
                              device=dev)
        err = _library().lazy_fused_reduce(ctypes.byref(plan), ctypes.byref(red), int(reg64), int(idx64), blocks,
                                           partial.data_ptr(), result.data_ptr(), dev.index or 0,
                                           torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"lazy_fused (terminal sum) kernel launch failed with CUDA error {err}")
        count_launch(LAZY_KERNEL)  # the segment with its sums into the partials
        count_launch(LAZY_KERNEL)  # the partials' fold
        return [result]
    outs = [torch.empty(shape, dtype=dt, device=dev) for _, dt in prog.outputs]
    if n == 0:
        return outs
    plan, reg64, idx64, vec = _plan_struct(prog, inputs, shape, [o.data_ptr() for o in outs], n)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = max(1, min(8 * sms, -(-n // (_THREADS * _PER_THREAD))))
    stream = torch.cuda.current_stream(dev).cuda_stream
    vec = vec and all(o.data_ptr() % 16 == 0 for o in outs)
    err = _library().lazy_fused(ctypes.byref(plan), int(reg64), int(idx64), int(vec), blocks, dev.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"lazy_fused kernel launch failed with CUDA error {err}")
    count_launch(LAZY_KERNEL)
    return outs


def _plan_struct(prog: SegmentProgram, inputs: Sequence[torch.Tensor], shape, out_ptrs, n: int):
    """The kernel's plan of a segment at ``shape`` (``n`` elements), with its
    outputs at ``out_ptrs``: ``(plan, reg64, idx64, vec)``, vec before the
    outputs' alignment is known."""
    dev = inputs[0].device
    plan = _Plan()
    full = (1,) * (MAX_DIMS - len(shape)) + tuple(int(s) for s in shape)
    for d, s in enumerate(full):
        plan.shape[d] = s
    plan.n = n
    plan.n_in, plan.n_out, plan.n_instr = len(inputs), len(prog.outputs), len(prog.instrs)
    contiguous = torch.empty(full, device="meta").stride()
    reg64 = max_slots(prog, [t.dtype for t in inputs]) == MAX_SLOTS_F64
    max_off = n
    for k, t in enumerate(inputs):
        if t.device != dev:
            raise ValueError(f"lazy_fused: inputs on {dev} and {t.device}")
        e = t.expand(tuple(shape))
        strides = (0,) * (MAX_DIMS - len(shape)) + tuple(e.stride())
        plan.inp[k].ptr = t.data_ptr()
        for d, st in enumerate(strides):
            plan.inp[k].stride[d] = st
        plan.inp[k].dtype = _DTYPES[t.dtype]
        if not any(st for st, s in zip(strides, full) if s > 1):
            plan.inp[k].flat = 2  # one element
        else:
            plan.inp[k].flat = int(all(st == c for st, c, s in zip(strides, contiguous, full) if s > 1))
        plan.pad |= int(plan.inp[k].flat == 0)
        max_off = max(max_off, 1 + sum((s - 1) * st for s, st in zip(full, strides)))
    for k, ((slot, dt), ptr) in enumerate(zip(prog.outputs, out_ptrs)):
        plan.out[k].ptr, plan.out[k].slot, plan.out[k].dtype = ptr, slot, _DTYPES[dt]
    for k, (op, dst, a, b, imm, f64) in enumerate(prog.instrs):
        q = plan.ins[k]
        q.imm, q.op, q.dst, q.a, q.b, q.f64 = float(imm), _OPCODE[op], dst, a, b, int(f64)
        q.flags = _flags(prog, k)
    vec = (not reg64 and n % 4 == 0 and full[-1] % 4 == 0
           and all(_quad_ok(plan.inp[k], t) for k, t in enumerate(inputs))
           and all(dt == torch.float32 for _, dt in prog.outputs))
    return plan, reg64, max_off >= 2**31, vec


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
    limit = max_slots(prog, [t.dtype for t in inputs])
    if prog.n_in + len(prog.instrs) > limit:
        raise ValueError(f"lazy_fused: {prog.n_in} inputs and {len(prog.instrs)} instructions exceed the "
                         f"kernel's {limit} slots")
    mode = dispatch_mode(LAZY_KERNEL, inputs[0])
    record_dispatch(LAZY_KERNEL, mode)
    if mode == "cuda":
        return _lazy_cuda(prog, inputs, tuple(shape), reduce)
    if inputs[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"lazy_fused supports CUDA and CPU tensors, got {inputs[0].device}")
    return lazy_fused_plain(prog, inputs, shape, reduce)
