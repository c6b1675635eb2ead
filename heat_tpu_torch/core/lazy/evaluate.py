"""Planning and running captured graphs (counterpart of
``heat_tpu/core/lazy/evaluate.py``).

Two caches keep a warm chain at one plan lookup and no planning:

- :func:`infer_meta` answers "what layout does this op give?" at capture
  by running the port's own dispatcher on ``meta`` tensors in trace-safe
  mode, so a pending result's ``gshape``/``dtype``/``split``/``lcounts``
  follow the eager rules exactly (collectives pass ``meta`` tensors through
  without communicating; a site that would move rows between ranks raises,
  and the capture declines). Results are cached in ``META_CACHE``.
- :func:`evaluate` runs a pending graph through a *plan*, cached in
  ``PROGRAM_CACHE`` by the graph's signature (:mod:`.graph`).

A plan splits the graph into fused elementwise segments and ordinary
nodes. Elementwise ops the ``lazy_fused`` kernel runs (``add``, ``sub``,
``mul``, ``div``, ``pow``, ``neg``, ``abs``, ``exp``, ``log``, ``sqrt`` and
the comparisons, on float32/float64/bool, in up to 4 dimensions) are
grouped into segments: a node that is not a result of the graph and only
feeds fused nodes is computed inline in each segment that needs it (it
broadcasts into the segment's shape); every other fused node is stored,
and the stored nodes of one layout and one *level* form one segment, one
launch, within the kernel's limits (fewer slots where a segment runs on
double registers): an expression that outgrows them is cut in two by
storing the inlined node nearest its middle, until every part fits.
Everything else (reductions, cumulative ops, ``matmul``,
``argmax``/``argmin``, the moments, and elementwise ops outside the
kernel's set, counted in ``KERNEL_STATS["lazy_fused.boundary"]``) is an
ordinary node, run by the port's own op with its collectives, but for a
*terminal sum*: a stored float node that is no result and that only a
``sum`` or a ``mean`` (over every axis or one) reads is its own segment,
launched with the sum as its epilogue (``lazy_fused(..., reduce=axis)``),
so its values are never written; the partial sum then takes the
``allgather`` ``_reduce_op`` runs across ranks, and a mean divides by the
count, as XLA fuses a producer into its reduction in ``heat_tpu``. A node's
level counts the ordinary nodes, and the stored results of another layout,
on its longest path from the leaves; level by level, the segments run
first, then the ordinary nodes in capture order. Levels and layouts are
global metadata, so every rank runs the same plan and dispatches the same
collectives in the same order.

Cross-chain prefix reuse (``FUSE_STATS["cse_hits"]``) works as in
``heat_tpu``: on a miss, a chain that shares at least
:data:`_CSE_MIN_PREFIX` serialized nodes with a registered chain runs as
the shared prefix's cached plan followed by its own remainder.
"""
from __future__ import annotations

import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from .. import _hooks, types
from .._cache import ExecutableCache
from ..dndarray import DNDarray
from ..kernels._dispatch import record_route
from ..kernels.lazy_fused import (LAZY_KERNEL, MAX_DIMS, MAX_IN, MAX_INSTR, MAX_OUT, SegmentProgram, lazy_fused,
                                  max_slots)
from .graph import Node, NodeMeta, scalar_token, stats_inc

__all__ = ["infer_meta", "evaluate", "META_CACHE", "PROGRAM_CACHE"]

# op-layout probes: one meta run per distinct (op, layouts)
META_CACHE = ExecutableCache(maxsize=1024)
# plans: one per distinct (graph, leaf layouts, comm); shared-prefix plans live here too
PROGRAM_CACHE = ExecutableCache(maxsize=256)

_CSE_MIN_PREFIX = 2
_CSE_MAX_CHAINS = 32
_CSE_CHAINS: List[Tuple] = []
_CSE_LOCK = threading.Lock()

_FLOATS = (types.float32, types.float64)


def _reconstruct(meta: NodeMeta, buf: torch.Tensor) -> DNDarray:
    """A plain DNDarray over this rank's tensor ``buf`` in ``meta``'s layout."""
    if meta.lcounts is not None:
        return DNDarray._from_ragged(buf, meta.gshape, meta.dtype, meta.split, meta.lcounts, meta.device,
                                     meta.comm)
    return DNDarray(buf, gshape=meta.gshape, dtype=meta.dtype, split=meta.split, device=meta.device,
                    comm=meta.comm)


def _meta_array(meta: NodeMeta) -> DNDarray:
    return _reconstruct(meta, torch.empty(meta.lshape, dtype=meta.dtype.torch_type(), device="meta"))


def _replay_one(kind: str, op, statics, args) -> DNDarray:
    """Run one captured call through the port's own op."""
    from .. import _operations as ops

    if kind == "binary":
        (fn_kwargs,) = statics
        return ops._binary_op(op, args[0], args[1], fn_kwargs=fn_kwargs or None)
    if kind == "local":
        no_cast, out_dtype, kwargs = statics
        return ops._local_op(op, args[0], no_cast=no_cast, out_dtype=out_dtype, **kwargs)
    if kind == "reduce":
        axis, keepdims, out_dtype, kwargs = statics
        return ops._reduce_op(op, args[0], axis=axis, keepdims=keepdims, out_dtype=out_dtype, **kwargs)
    if kind == "matmul":
        return op(args[0], args[1])
    if kind == "argreduce":
        from .. import statistics

        (axis,) = statics
        return statistics._arg_reduce(op, args[0], axis, None)
    if kind == "moment":
        (kwargs,) = statics
        return op(args[0], **kwargs)
    axis, dtype = statics  # kind == "cum"
    return ops._cum_op(op, args[0], axis, dtype=dtype)


def infer_meta(kind: str, op, sig_statics, statics, operands, comm) -> NodeMeta:
    """Layout of one captured call's result, from a run of the port's own
    dispatcher on ``meta`` tensors. ``operands`` are ``("meta", NodeMeta)`` /
    ``("scalar", value)`` pairs. Raises what the dispatcher raises (a
    :class:`~.._hooks.TraceBarrierError` for an op that moves rows)."""
    tokens = tuple(("m",) + v.token if tag == "meta" else ("s",) + tuple(scalar_token(v)) for tag, v in operands)
    key = (kind, op, sig_statics, tokens, comm)
    hit = META_CACHE.get(key)
    if hit is not None:
        return hit
    _hooks.enter_trace_safe()
    try:
        args = [_meta_array(v) if tag == "meta" else v for tag, v in operands]
        res = _replay_one(kind, op, statics, args)
        meta = NodeMeta(res.gshape, res.dtype, res.split, res.lcounts, res.lshape, res.device, res.comm)
    finally:
        _hooks.exit_trace_safe()
    META_CACHE[key] = meta
    return meta


def _collect(targets: Sequence[Node]) -> List[Node]:
    """Unevaluated ancestor closure of ``targets`` in capture order (capture
    order is topological: operands precede their consumers)."""
    found = {}
    stack = list(targets)
    while stack:
        n = stack.pop()
        if id(n) in found or n.buffer is not None:
            continue
        found[id(n)] = n
        for tag, v in n.inputs:
            if tag == "node" and v.buffer is None:
                stack.append(v)
    return sorted(found.values(), key=lambda n: n.seq)


# ---------------------------------------------------------------- planning
def _fused_ops() -> Dict[object, str]:
    """The port's op functions the kernel runs, by kernel op name."""
    from .. import arithmetics, relational, rounding

    return {
        torch.add: "add", torch.sub: "sub", torch.mul: "mul", arithmetics._true_divide: "div", torch.pow: "pow",
        torch.neg: "neg", rounding._abs: "abs", torch.exp: "exp", torch.log: "log", torch.sqrt: "sqrt",
        relational._GT: "gt", relational._GE: "ge", relational._LT: "lt", relational._LE: "le", torch.eq: "eq",
        torch.ne: "ne",
    }


def _broadcasts(om: NodeMeta, cm: NodeMeta) -> bool:
    """Whether operand ``om`` is whole along the split axis of result ``cm``."""
    ax = cm.split - (len(cm.gshape) - len(om.gshape))
    return ax < 0 or om.gshape[ax] == 1


def _identity(om: NodeMeta, cm: NodeMeta) -> bool:
    """Whether the eager op meets operand ``om`` as the tensor it holds (no
    slice, gather or move) in a result of layout ``cm``."""
    if not cm.comm.is_distributed():
        return True
    if cm.split is None or _broadcasts(om, cm):
        return om.split is None
    return om.split == cm.split - (len(cm.gshape) - len(om.gshape)) and om.lcounts == cm.lcounts


class _Typed(NamedTuple):
    """An operand's heat type and global shape, all ``types.result_type`` reads."""

    dtype: object
    shape: Tuple[int, ...]


class _Elementwise:
    """A node the kernel can run: op name, precision, and per operand either
    ``("ref", index, identity)`` of a node/leaf value or ``("imm", value)``."""

    __slots__ = ("name", "f64", "operands")

    def __init__(self, name, f64, operands):
        self.name, self.f64, self.operands = name, f64, operands


def _elementwise(kind, op, statics, wiring, meta, metas_of, table) -> Optional[_Elementwise]:
    """The kernel's view of one node, or None where it is an ordinary node."""
    name = table.get(op) if kind in ("binary", "local") else None
    if name is None or len(meta.gshape) > MAX_DIMS:
        return None
    if kind == "local":
        no_cast, out_dtype, kwargs = statics
        (tag, v), = wiring
        om = metas_of(tag, v)
        if kwargs or out_dtype is not None or om.dtype not in _FLOATS or meta.dtype is not om.dtype:
            return None
        return _Elementwise(name, om.dtype is types.float64, (("ref", (tag, v), True),))
    (fn_kwargs,) = statics
    if fn_kwargs:
        return None
    args, operands = [], []
    for tag, v in wiring:
        if tag == "s":
            if scalar_token(v)[0].startswith("complex"):
                return None
            args.append(v)
            continue
        om = metas_of(tag, v)
        if om.dtype not in _FLOATS + (types.bool,):
            return None
        args.append(_Typed(om.dtype, om.gshape))
    promoted = types.result_type(*args)
    if promoted not in _FLOATS:
        return None
    want = types.bool if name in ("gt", "ge", "lt", "le", "eq", "ne") else promoted
    if meta.dtype is not want:
        return None
    comm = meta.comm
    if comm.is_distributed() and meta.split is not None and all(
            tag == "s" or _broadcasts(metas_of(tag, v), meta) for tag, v in wiring):
        return None  # both operands whole along a split axis of extent 1: eager slices the result
    tt = promoted.torch_type()
    for tag, v in wiring:
        if tag == "s":
            from .. import factories

            # graftlint: G004 - a CPU scalar, converted once when the plan is built
            imm = factories.array(v, device="cpu", comm=comm)._raw.to(tt).item()
            operands.append(("imm", float(imm)))
        else:
            operands.append(("ref", (tag, v), _identity(metas_of(tag, v), meta)))
    if sum(1 for o in operands if o[0] == "imm") > 1:
        return None
    return _Elementwise(name, promoted is types.float64, tuple(operands))


def _terminal_sum(kind, op, statics, meta: NodeMeta):
    """``(axis, mean)`` where the node is a ``sum`` or ``mean`` over every
    axis (axis None) or one of an operand of layout ``meta`` that the
    kernel's epilogue can take, else None."""
    from .. import arithmetics, statistics
    from ..stride_tricks import sanitize_axis

    if kind == "reduce" and op is arithmetics._sum:
        axis, _, out_dtype, kwargs = statics
        if out_dtype is not None or kwargs:
            return None
        mean = False
    elif kind == "moment" and op is statistics.mean:
        (kwargs,) = statics
        if set(kwargs) != {"axis"}:
            return None
        axis, mean = kwargs["axis"], True
    else:
        return None
    if meta.dtype not in _FLOATS or not meta.gshape:
        return None
    axis = sanitize_axis(meta.gshape, axis)  # valid: the node's layout was inferred by running the op
    if isinstance(axis, tuple):
        if len(axis) != 1:
            return None
        (axis,) = axis
    return axis, mean


class _Segment:
    """One launch: its roots (stored nodes), its inputs ``(source, layout
    or None)``, its program and the roots' layout; ``reduce``: the terminal
    sum ``(node, axis, mean)`` its one root feeds, or None."""

    __slots__ = ("roots", "inputs", "program", "meta", "reduce")

    def __init__(self, roots, inputs, program, meta):
        self.roots, self.inputs, self.program, self.meta, self.reduce = roots, inputs, program, meta, None


class _Plan:
    """A graph's plan: steps ``("node", i)`` (an ordinary node) or
    ``("seg", _Segment)``, in run order."""

    def __init__(self, spec, leaf_metas, node_metas, out_ids, steps, boundary):
        self.spec, self.leaf_metas, self.node_metas = spec, leaf_metas, node_metas
        self.out_ids, self.steps, self.boundary = out_ids, steps, boundary

    def __call__(self, *bufs):
        leaves = [_reconstruct(m, b) for m, b in zip(self.leaf_metas, bufs)]
        env: List[Optional[DNDarray]] = [None] * len(self.spec)

        def value(src):
            tag, v = src
            return env[v] if tag == "n" else leaves[v]

        for kind, item in self.steps:
            if kind == "node":
                k, op, statics, wiring = self.spec[item]
                args = [value((tag, v)) if tag in ("n", "l") else v for tag, v in wiring]
                if item in self.boundary:
                    record_route(LAZY_KERNEL, "boundary")
                env[item] = _replay_one(k, op, statics, args)
                continue
            seg = item
            inputs = []
            for src, layout in seg.inputs:
                d = value(src)
                if layout is None:
                    inputs.append(d._raw)
                else:
                    inputs.append(_prepare(d, layout))
            if seg.reduce is not None:
                node, axis, mean = seg.reduce
                (part,) = lazy_fused(seg.program, inputs, seg.meta.lshape, reduce=axis)
                env[node] = _terminal_result(seg.meta, self.node_metas[node], part, axis, mean)
                continue
            outs = lazy_fused(seg.program, inputs, seg.meta.lshape)
            for root, t in zip(seg.roots, outs):
                env[root] = _reconstruct(self.node_metas[root], t)
        return tuple(env[i]._raw for i in self.out_ids)


def _terminal_result(xm: NodeMeta, rm: NodeMeta, part: torch.Tensor, axis, mean: bool) -> DNDarray:
    """A terminal sum's (or mean's) result in layout ``rm`` from this rank's
    partial sum ``part`` (the summed axes kept) of an operand of layout
    ``xm``: across ranks where the split axis is summed, as ``_reduce_op``
    gathers partials; a mean divided by the count."""
    from .. import arithmetics
    from .._operations import _gather_partials

    axes = range(len(xm.gshape)) if axis is None else (axis,)
    if xm.split is not None and xm.split in axes and xm.comm.is_distributed():
        part = _gather_partials(arithmetics._sum, _meta_array(xm), part, lambda: part)
    if mean:
        count = 1
        for a in axes:
            count *= int(xm.gshape[a])
        part = part / count
    return _reconstruct(rm, part.reshape(rm.lshape))


def _prepare(d: DNDarray, cm: NodeMeta) -> torch.Tensor:
    """Operand ``d`` as the eager op meets it in a result of layout ``cm``:
    this rank's slice of a replicated operand, or a gathered one."""
    from .._operations import _local_operand, _ragged_operand

    if cm.lcounts is not None:
        return _ragged_operand(d, cm.gshape, cm.split, cm.lcounts, cm.comm)
    return _local_operand(d, cm.gshape, cm.split)


def _build_program(spec, leaf_metas, node_metas, out_ids) -> _Plan:
    """The plan of ``spec`` (``(kind, op, statics, wiring)`` per node, wiring
    ``("n", i) | ("l", j) | ("s", value)``)."""
    _hooks.observe("lazy.plan", nodes=len(spec))
    table = _fused_ops()

    def metas_of(tag, v):
        return node_metas[v] if tag == "n" else leaf_metas[v]

    n = len(spec)
    ew = [_elementwise(k, op, st, w, node_metas[i], metas_of, table) for i, (k, op, st, w) in enumerate(spec)]
    boundary = frozenset(i for i, (k, _, _, _) in enumerate(spec) if ew[i] is None and k in ("binary", "local"))
    consumers: List[List[Tuple[int, bool]]] = [[] for _ in range(n)]
    for i, e in enumerate(ew):
        if e is None:
            for tag, v in spec[i][3]:
                if tag == "n":
                    consumers[v].append((i, False))
        else:
            for o in e.operands:
                if o[0] == "ref" and o[1][0] == "n":
                    consumers[o[1][1]].append((i, o[2]))
    outs = set(out_ids)
    # terminal sums: a stored fused node that is no result, read only by a sum or mean the epilogue takes
    terminal = {}
    for i, (k, op, st, w) in enumerate(spec):
        refs = [v for tag, v in w if tag == "n"]
        if len(refs) != 1 or ew[refs[0]] is None or refs[0] in outs or consumers[refs[0]] != [(i, False)]:
            continue
        spec_sum = _terminal_sum(k, op, st, node_metas[refs[0]])
        if spec_sum is not None:
            terminal[refs[0]] = (i,) + spec_sum
    stored_only = set()  # fused nodes kept out of inlining: they cut expressions that outgrew the kernel
    while True:
        # a fused node is inlined where it is no result and only feeds fused nodes as their own tensor
        inlined = [ew[i] is not None and i not in outs and i not in stored_only and bool(consumers[i])
                   and all(ew[c] is not None and ident for c, ident in consumers[i]) for i in range(n)]
        steps, too_big = _schedule(spec, ew, inlined, node_metas, metas_of, terminal)
        if not too_big:
            return _Plan(spec, leaf_metas, node_metas, tuple(out_ids), steps, boundary)
        stored_only |= too_big


def _schedule(spec, ew, inlined, node_metas, metas_of, terminal):
    """Levels and run order: ``(steps, set())``, or ``(None, {node})`` with
    the inlined node to store that cuts an expression too large for one
    launch in two. A root in ``terminal`` is a segment of its own with its
    sum as the epilogue, and the sum's node runs in it."""
    n = len(spec)
    avail = [0] * n  # the level from which node i's value can be read
    run = [0] * n
    memo: Dict[Tuple, int] = {}

    def expr_need(root, key) -> int:
        """The lowest level at which node root's expression runs in a segment of layout ``key``
        (its nodes in index order: operands before their consumers)."""
        for i in sorted(_expr_nodes(root, ew, inlined)):
            if (i, key) in memo:
                continue
            lvl = 0
            for o in ew[i].operands:
                if o[0] != "ref" or o[1][0] != "n":
                    continue
                p = o[1][1]
                if inlined[p]:
                    lvl = max(lvl, memo[(p, key)])
                elif ew[p] is not None:  # a stored fused node: one segment where it has the layout, met as is
                    lvl = max(lvl, avail[p] if o[2] and node_metas[p].layout == key else avail[p] + 1)
                else:
                    lvl = max(lvl, avail[p])
            memo[(i, key)] = lvl
        return memo[(root, key)]

    groups: Dict[Tuple, List[int]] = {}
    for i in range(n):
        if ew[i] is None:
            run[i] = max([avail[v] for tag, v in spec[i][3] if tag == "n"] + [0])
            avail[i] = run[i] + 1
        elif not inlined[i]:
            avail[i] = expr_need(i, node_metas[i].layout)
            groups.setdefault((avail[i], node_metas[i].layout), []).append(i)
    steps = []
    for level in range(max(avail + [0]) + 1):
        for (lvl, _), roots in sorted(groups.items(), key=lambda kv: kv[1][0]):
            if lvl != level:
                continue
            pending = [r for r in roots if r not in terminal]
            while pending:  # as many roots per launch as the kernel's limits take
                take = min(len(pending), MAX_OUT)
                seg = _program(pending[:take], ew, inlined, node_metas, metas_of)
                while seg is None and take > 1:
                    take -= 1
                    seg = _program(pending[:take], ew, inlined, node_metas, metas_of)
                if seg is None:
                    return None, {_cut_point(pending[0], ew, inlined)}
                steps.append(("seg", seg))
                pending = pending[take:]
            # after the level's other segments: a terminal root may read one of their roots as a stored input
            for root in (r for r in roots if r in terminal):
                seg = _program([root], ew, inlined, node_metas, metas_of)
                if seg is None:
                    return None, {_cut_point(root, ew, inlined)}
                seg.reduce = terminal[root]
                steps.append(("seg", seg))
        fused_sums = {t[0] for t in terminal.values()}
        steps += [("node", i) for i in range(n) if ew[i] is None and run[i] == level and i not in fused_sums]
    return steps, set()


def _cut_point(root, ew, inlined) -> int:
    """The inlined node of ``root``'s expression whose own expression is
    nearest half of it (the first such node; sizes counted as in a tree):
    stored, it cuts the expression in two."""
    size: Dict[int, int] = {}
    for i in sorted(_expr_nodes(root, ew, inlined)):  # operands before their consumers
        size[i] = 1 + sum(size[o[1][1]] for o in ew[i].operands
                          if o[0] == "ref" and o[1][0] == "n" and inlined[o[1][1]])
    half = size[root] / 2
    return min((i for i in size if inlined[i]), key=lambda i: (abs(size[i] - half), i))


def _expr_nodes(root, ew, inlined) -> List[int]:
    """Node ``root`` and the inlined nodes of its expression."""
    out, seen, stack = [], set(), [root]
    while stack:
        i = stack.pop()
        if i in seen:
            continue
        seen.add(i)
        out.append(i)
        for o in ew[i].operands:
            if o[0] == "ref" and o[1][0] == "n" and inlined[o[1][1]]:
                stack.append(o[1][1])
    return out


def _program(roots, ew, inlined, node_metas, metas_of) -> Optional[_Segment]:
    """The segment computing ``roots`` (stored nodes of one layout and
    level), or None where it exceeds the kernel's limits (``max_slots``:
    fewer slots where the segment runs on double registers)."""
    root_set = set(roots)
    key = node_metas[roots[0]].layout
    members = set()
    stack = list(roots)
    while stack:
        i = stack.pop()
        if i in members:
            continue
        members.add(i)
        for o in ew[i].operands:
            if o[0] == "ref" and o[1][0] == "n":
                p = o[1][1]
                if inlined[p] or (p in root_set and o[2] and node_metas[p].layout == key):
                    stack.append(p)
    order = sorted(members)
    inputs: List[Tuple] = []
    in_slot: Dict[Tuple, int] = {}
    rows = []
    for i in order:
        operands = []
        for o in ew[i].operands:
            if o[0] == "imm":
                operands.append(("imm", o[1]))
                continue
            src, ident = o[1], o[2]
            if src[0] == "n" and src[1] in members and (inlined[src[1]] or ident):
                operands.append(("node", src[1]))
                continue
            k = (src, None if ident else i)
            if k not in in_slot:
                in_slot[k] = len(inputs)
                inputs.append((src, None if ident else node_metas[i]))
            operands.append(("in", in_slot[k]))
        rows.append((i, operands))
    if len(inputs) > MAX_IN or len(rows) > MAX_INSTR or len(roots) > MAX_OUT:
        return None
    n_in = len(inputs)
    node_slot = {i: n_in + pos for pos, (i, _) in enumerate(rows)}
    instrs = []
    for pos, (i, operands) in enumerate(rows):
        slots, imm = [], 0.0
        for kind, v in operands:
            if kind == "imm":
                slots.append(-1)
                imm = v
            else:
                slots.append(node_slot[v] if kind == "node" else v)
        instrs.append((ew[i].name, n_in + pos, slots[0], slots[1] if len(slots) > 1 else -1, imm, ew[i].f64))
    outputs = tuple((node_slot[r], node_metas[r].dtype.torch_type()) for r in roots)
    prog = SegmentProgram(n_in, tuple(instrs), outputs)
    if n_in + len(instrs) > max_slots(prog, [metas_of(*src).dtype.torch_type() for src, _ in inputs]):
        return None
    return _Segment(tuple(roots), tuple(inputs), prog, node_metas[roots[0]])


# ---------------------------------------------------------------- CSE
def _cse_prefix_len(sig_nodes, leaf_tokens, entry_nodes, entry_leaves) -> int:
    """Length of the longest common serialized prefix of two chains (node
    signatures equal, and every leaf a prefix node touches of one layout)."""
    k = 0
    for a, b in zip(sig_nodes, entry_nodes):
        if a != b:
            break
        ok = True
        for ent in a[3]:
            if ent[0] != "l":
                continue
            v = ent[1]
            if v >= len(leaf_tokens) or v >= len(entry_leaves) or leaf_tokens[v] != entry_leaves[v]:
                ok = False
                break
        if not ok:
            break
        k += 1
    return k


def _cse_register(comm, sig_nodes, leaf_tokens) -> None:
    if len(sig_nodes) < _CSE_MIN_PREFIX:
        return
    entry = (comm, sig_nodes, leaf_tokens)
    with _CSE_LOCK:
        if entry in _CSE_CHAINS:
            return
        _CSE_CHAINS.append(entry)
        del _CSE_CHAINS[:-_CSE_MAX_CHAINS]


def _cse_compile(comm, nodes, spec, sig_nodes, leaf_metas, out_ids):
    """A composite plan (the shared prefix's cached plan, then this chain's
    remainder) where a registered chain shares at least ``_CSE_MIN_PREFIX``
    serialized nodes, else None."""
    leaf_tokens = tuple(m.token for m in leaf_metas)
    with _CSE_LOCK:
        chains = list(_CSE_CHAINS)
    k = 0
    for e_comm, e_nodes, e_leaves in chains:
        if e_comm == comm:
            k = max(k, _cse_prefix_len(sig_nodes, leaf_tokens, e_nodes, e_leaves))
    k = min(k, len(nodes) - 1)
    if k < _CSE_MIN_PREFIX:
        return None
    need = {i for i in out_ids if i < k}
    for _, _, _, wiring in spec[k:]:
        for tag, v in wiring:
            if tag == "n" and v < k:
                need.add(v)
    boundary = tuple(sorted(need))
    if not boundary:
        return None
    used = [v for _, _, _, wiring in spec[:k] for tag, v in wiring if tag == "l"]
    nlp = 1 + max(used) if used else 0
    node_metas = [n.meta for n in nodes]
    boundary_metas = [node_metas[i] for i in boundary]
    psig = ("cse", comm, leaf_tokens[:nlp], tuple(sig_nodes[:k]), boundary)
    pprog = PROGRAM_CACHE.get(psig)
    if pprog is None:
        pprog = _build_program(spec[:k], leaf_metas[:nlp], node_metas[:k], boundary)
        PROGRAM_CACHE[psig] = pprog
    else:
        stats_inc("cse_hits")
    slot = {i: len(leaf_metas) + j for j, i in enumerate(boundary)}
    rspec = []
    for kind, op, statics, wiring in spec[k:]:
        rw = tuple((("n", v - k) if v >= k else ("l", slot[v])) if tag == "n" else (tag, v) for tag, v in wiring)
        rspec.append((kind, op, statics, rw))
    r_out = tuple(i - k for i in out_ids if i >= k)
    rprog = _build_program(rspec, list(leaf_metas) + boundary_metas, node_metas[k:], r_out)
    route, ri = [], 0
    for i in out_ids:
        if i < k:
            route.append(("p", boundary.index(i)))
        else:
            route.append(("r", ri))
            ri += 1
    return _Composite(pprog, rprog, nlp, tuple(route))


class _Composite:
    """A prefix plan and a remainder plan run as one."""

    def __init__(self, pprog, rprog, nlp, route):
        self.pprog, self.rprog, self.nlp, self.route = pprog, rprog, nlp, route

    def __call__(self, *bufs):
        pouts = self.pprog(*bufs[: self.nlp])
        routs = self.rprog(*bufs, *pouts)
        return tuple(pouts[j] if tag == "p" else routs[j] for tag, j in self.route)


# ---------------------------------------------------------------- evaluation
def _evaluate_group(comm, targets: Sequence[Node]) -> None:
    from .capture import suspended

    nodes = _collect(targets)
    if not nodes:
        return
    index = {id(n): i for i, n in enumerate(nodes)}
    target_ids = {id(n) for n in targets}
    leaf_bufs, leaf_metas, leaf_versions = [], [], []
    leaf_ix = {}
    spec, sig_nodes = [], []
    for n in nodes:
        wiring, sig_args = [], []
        for tag, v in n.inputs:
            if tag == "node" and v.buffer is None:
                wiring.append(("n", index[id(v)]))
                sig_args.append(("n", index[id(v)]))
            elif tag == "scalar":
                wiring.append(("s", v))
                sig_args.append(("s",) + tuple(scalar_token(v)))
            else:
                buf = v.buffer  # a Leaf, or an evaluated Node
                j = leaf_ix.get(id(buf))
                if j is None:
                    j = len(leaf_bufs)
                    leaf_ix[id(buf)] = j
                    leaf_bufs.append(buf)
                    leaf_metas.append(v.meta)
                    leaf_versions.append(getattr(v, "version", None))
                wiring.append(("l", j))
                sig_args.append(("l", j))
        spec.append((n.kind, n.op, n.statics, tuple(wiring)))
        sig_nodes.append((n.kind, n.op, n.sig_statics, tuple(sig_args)))
    for buf, version in zip(leaf_bufs, leaf_versions):
        if version is not None and buf._version != version:
            raise RuntimeError("a tensor captured into a lazy graph was changed in place before evaluation; "
                               "materialize the consumers before mutating their inputs")
    # a node stays a result while its LazyDNDarray is reachable or it was forced
    out_ids = tuple(i for i, n in enumerate(nodes)
                    if id(n) in target_ids or (n.ref is not None and n.ref() is not None))
    sig = (comm, tuple(m.token for m in leaf_metas), tuple(sig_nodes), out_ids)
    prog = PROGRAM_CACHE.get(sig)
    if prog is None:
        prog = _cse_compile(comm, nodes, spec, tuple(sig_nodes), leaf_metas, out_ids)
        if prog is None:
            prog = _build_program(spec, leaf_metas, [n.meta for n in nodes], out_ids)
        PROGRAM_CACHE[sig] = prog
        stats_inc("graphs_captured")
        _cse_register(comm, tuple(sig_nodes), tuple(m.token for m in leaf_metas))
    else:
        stats_inc("cache_hits")
    stats_inc("fused_dispatches")
    with suspended():
        outs = prog(*leaf_bufs)
    for i, buf in zip(out_ids, outs):
        n = nodes[i]
        n.buffer = buf
        arr = n.ref() if n.ref is not None else None
        if arr is not None:
            arr._lazy_fill(buf)
    for n in nodes:
        if n.buffer is not None:
            n.release_inputs()


def evaluate(targets: Sequence[Node]) -> None:
    """Materialize ``targets`` and their unevaluated ancestors: one plan per
    communicator."""
    pending, seen = [], set()
    for n in targets:
        if n.buffer is None and id(n) not in seen:
            seen.add(id(n))
            pending.append(n)
    if not pending:
        return
    groups: List[Tuple[object, List[Node]]] = []
    for n in pending:
        for c, lst in groups:
            if c == n.meta.comm:
                lst.append(n)
                break
        else:
            groups.append((n.meta.comm, [n]))
    for c, lst in groups:
        _evaluate_group(c, lst)
