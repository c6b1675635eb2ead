"""Computed interprocedural summaries for graftflow (counterpart of
``heat_tpu/analysis/summaries.py``, with the port's vocabulary).

Over the set of files being analyzed this module

1. builds a **call-graph index**: every module-level function and method
   keyed by bare name, with nested closures inlined into their defining
   scope (``_hooks.guarded_call(label, impl, ...)`` resolves because
   function-valued arguments count as calls);
2. derives a **Summary** per function by fixpoint iteration: the
   flattened ordered collective *schedule* it dispatches (transitively,
   capped), whether its return value is process-dependent (*taint-out*),
   whether it spawns processes or imports inside a function (*fork
   effects*, for F007) and whether it starts ``torch.distributed``;
3. keeps a hand table only as a **seed** for names defined outside the
   analyzed set (``torch.distributed`` externals; cross-module helpers in
   single-file mode);
4. emits a **drift diagnostic** (``DRIFT``) when a computed summary
   contradicts a hand entry.

The port's vocabulary: the collectives are the communicator's
(``allreduce``, ``allgather``, ``alltoall``, ``bcast``, ``ring_shift``,
``exchange``, ``barrier``), ``flatmove``'s moves and ``torch.distributed``'s
own calls; the taint sources are rank identity (``.rank``,
``dist.get_rank()``), this rank's chunk (``comm.chunk()``, ``.larray``,
``._raw``, ``.lshape``), host clocks, file I/O, un-seeded RNG and queue
state. Pure stdlib (``ast`` only), so the CLI runs without torch.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, replace
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "COLLECTIVE_NAMES",
    "COLLECTIVE_WRAPPERS",
    "EXTERNAL_LAUNDER",
    "INTERNAL_LAUNDER",
    "LAUNDER_CALLS",
    "Summary",
    "SummaryTable",
    "Taint",
    "compute_summaries",
    "drift_records",
]

# Transitive schedules are capped: past this many events the exact tail
# stops mattering for symmetry comparison and we mark the summary
# truncated instead of growing it without bound (recursion-safe).
SCHEDULE_CAP = 24
FIXPOINT_MAX_ITERS = 40


# ------------------------------------------------------------------ taint kind
@dataclass(frozen=True)
class Taint:
    """A taint fact: human-readable reason + source kind.

    ``kind`` steers rule selection (clock/queue-kind taint gating an
    asymmetric schedule is F009 — the fix is ``replicated_decision`` —
    while rank/shard/fs/rng-kind taint stays F001)."""

    reason: str
    kind: str = "rank"

    def __str__(self) -> str:  # messages embed taints as [{taint}]
        return self.reason


# --------------------------------------------------------------- shared vocab
# Base collective vocabulary — kept in sync with graftlint's copy
# (tests/test_graftflow.py::test_collective_vocabulary_matches_graftlint).
COLLECTIVE_NAMES = {
    # the communicator's collectives (core/communication.py)
    "allreduce", "allgather", "alltoall", "bcast", "ring_shift", "exchange", "barrier",
    "ragged_process_allgather",
    # flatmove's moves and the row fetch built on alltoall
    "ragged_move", "bucket_move", "flat_move", "reshape_via_flatmove", "strided_take", "fetch",
    # torch.distributed's own
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_to_all", "all_to_all_single",
    "broadcast", "reduce_scatter", "reduce_scatter_tensor", "batch_isend_irecv",
    "all_gather_object", "broadcast_object_list", "gather_object", "scatter_object_list",
    # scans that gather candidates
    "nonzero_scan", "unique_merge",
}

# Attribute access that is process-dependent regardless of the base:
# rank identity and local-shard views.  (process_count / device counts
# are replicated-uniform and deliberately absent — same policy as G003.)
TAINT_ATTRS = {
    "rank": Taint("rank identity (.rank)", "rank"),
    "local_rank": Taint("rank identity (.local_rank)", "rank"),
    "lshape": Taint("local shard shape (.lshape)", "shard"),
    "local_shards": Taint("local shard view (.local_shards)", "shard"),
    # this rank's tensor: its chunk, not the global array
    "larray": Taint("this rank's chunk (.larray)", "shard"),
    "_raw": Taint("this rank's chunk (._raw)", "shard"),
}

# Replicated metadata of a distributed container: reading these off a
# tainted base yields the same value on every process, laundering the
# base's taint.
REPLICATED_ATTRS = {
    "shape", "dtype", "ndim", "size", "sharding", "is_fully_addressable",
    "gshape", "split", "device", "comm", "mesh",
    # the FULL per-shard counts tuple: partitions the global extent and is
    # validated against gshape at construction — identical on every rank.
    # The v1 hand table tainted this as "per-shard layout"; the computed
    # drift diagnostic (lshape_map laundering vs tainted return) caught it.
    "lcounts",
}

# Calls whose *result* is process-dependent no matter the arguments.
TAINT_CALLS = {
    "get_rank": Taint("rank identity (get_rank())", "rank"),
    "get_node_local_rank": Taint("rank identity (get_node_local_rank())", "rank"),
    "current_device": Taint("this process's card (current_device())", "rank"),
    "getpid": Taint("per-process pid (getpid())", "rank"),
    "gethostname": Taint("per-host name (gethostname())", "rank"),
    "open": Taint("per-host file I/O (open())", "fs"),
}

# Host clocks: wall time differs across processes, so a time-based
# decision is a divergence hazard exactly like a rank-based one.
CLOCK_CALLS = {"time", "time_ns", "monotonic", "monotonic_ns",
               "perf_counter", "perf_counter_ns"}

# Per-host filesystem probes: each host sees its own disk.
FS_CALLS = {"listdir", "scandir", "glob", "iglob", "exists", "isfile",
            "isdir", "stat", "getmtime", "getsize", "walk"}

# Un-seeded RNG and module-level draws from the per-process stream.
RNG_FACTORIES = {"default_rng", "Random", "RandomState"}
RNG_DRAWS = {"random", "randint", "randrange", "uniform", "normal",
             "standard_normal", "rand", "randn", "choice", "shuffle",
             "permutation", "sample", "getrandbits"}
RNG_MODULES = {"random"}

# Rank-local queue state: depth/emptiness of a thread's work queue is a
# per-process view (one rank's dispatcher may be ahead of another's), so
# a branch steering collective dispatch off it is the PR 13 disarmed-
# trigger deadlock shape.  ``qsize``/``empty``/``full`` are flagged only
# as no-argument method calls, so ``np.empty((3,))`` never matches.
QUEUE_CALLS = {"qsize", "empty", "full"}

# ------------------------------------------------------------ hand-table seeds
# External launderers (torch.distributed): replicating collectives and
# replicated-uniform metadata with no definition in-tree. Hand-maintained:
# the fixpoint cannot see into torch.
EXTERNAL_LAUNDER = {
    "all_gather", "all_reduce", "broadcast", "all_gather_object", "broadcast_object_list",
    "get_world_size", "device_count",
}

# port-internal launderers.  When the defining file is inside the
# analyzed set, the computed summary is the source of truth for the
# SCHEDULE and the taint-out derivation is drift-checked against this
# contract; the entry itself only seeds single-file analyses (fixtures,
# per-module gates) where the definition is out of scope.
# PR 19 audit: ``replicated_ids`` (PR 16) added — it was missing, so a
# branch gated on its (replicated by contract) result false-positived.
INTERNAL_LAUNDER = {
    "ragged_process_allgather", "allgather", "allreduce", "bcast",
    "replicated_decision", "replicated_ids", "replicated_frame",
    "lshape_map", "counts_displs_shape",
    # PR 19 audit: the HealthMonitor / Autoscaler consultation chain is
    # replicated by documented contract — ``maybe_tick`` wraps the due
    # decision in ``replicated_decision``, ``tick``/``apply_gathered``
    # build rank-uniform TickReports from gathered frames, and
    # ``consult``/``resolve`` return an already-rendezvoused verdict.
    # The flow-insensitive derivation sees their internal clock reads
    # and cannot prove this; the contract is asserted here and policed
    # by the DRIFT diagnostic.
    "maybe_tick", "tick", "apply_gathered", "consult", "resolve",
}

LAUNDER_CALLS = EXTERNAL_LAUNDER | INTERNAL_LAUNDER

# port internals that dispatch collectives *inside*: schedule seeds
# for out-of-scope definitions, drift-checked when in scope.
# PR 19 audit against the tree at head: ``replicated_ids`` (PR 16,
# fixed-width id-union allgather), ``_replicated_raise`` (PR 12, the
# symmetric-failure status allgather) and ``bucket_move`` (PR 14, the
# edge-colored ppermute exchange engine) were missing — all three
# post-date the PR 7 hand table.  Every pre-existing entry re-verified
# collective-bearing at head by test_graftflow.py::test_hand_table_is_live.
COLLECTIVE_WRAPPERS = {
    "save_checkpoint", "load_checkpoint", "check_divergence",
    "replicated_decision", "replicated_ids", "replicated_frame",
    "_replicated_raise", "bucket_move", "tree_merge",
}

# Process-spawning calls (F007): anything that forks after
# torch.distributed init inherits gRPC's threads into a wedged child.
SPAWN_CALLS = {"Popen", "run", "check_output", "check_call", "call",
               "fork", "forkpty", "system", "popen", "spawnl", "spawnv"}
SPAWN_BASES = {"subprocess", "os", "multiprocessing", "mp"}

# Distributed-init entry points: torch.distributed.initialize and the
# project's own wrapper.
INIT_CALLS = {"init_distributed", "init_process_group"}

# Method names that also live on builtin / numpy / stdlib types.  A
# bare-name call graph cannot see the receiver, and the builtin
# implementations are invisible to the candidate-conflict check (they
# are not in the index), so a single in-tree definition would falsely
# win every ``np_array.reshape(...)`` / ``dict.get(...)`` call site in
# the tree.  These names are never indexed; in-tree calls to the true
# definitions are simply opaque (their defining files are still
# analyzed directly, and the base collectives inside them are not).
UNIVERSAL_NAMES = {
    # numpy / torch tensor API that DNDarray re-implements with collectives
    "reshape", "ravel", "flatten", "tolist", "item", "astype", "transpose",
    "squeeze", "copy", "sum", "mean", "min", "max", "std", "var", "prod",
    "cumsum", "sort", "argsort", "take", "repeat", "clip", "round", "dot",
    "all", "any", "nonzero", "fill", "resize", "swapaxes", "view", "split",
    # container / string / IO / threading names shared with builtins
    "get", "put", "keys", "values", "items", "update", "append", "extend",
    "pop", "insert", "index", "count", "join", "strip", "read", "write",
    "close", "open", "format", "encode", "decode", "result", "start",
    "stop", "run", "send", "recv", "acquire", "release", "wait", "notify",
    "set", "clear", "add", "remove", "discard", "submit", "shutdown",
}

# Type-shape probes: in SPMD every process runs the same program over
# values of the same type, so the *type* of even a process-dependent
# value is replicated — branching on it cannot diverge.
TYPE_PROBES = {"isinstance", "issubclass", "hasattr", "callable", "type"}

# Attribute bases that name external modules: a call spelled
# ``np.tile(...)`` / ``torch.zeros(...)`` can never be the in-tree
# distributed function of the same bare name, so call sites with these
# bases bypass the summary index entirely.  (Collective detection stays
# name-keyed — ``dist.all_gather`` is still seen.)
EXTERNAL_BASES = {
    "np", "numpy", "torch", "dist", "F", "nn", "ctypes", "scipy",
    "os", "path", "sys", "time", "math", "shutil", "glob", "json",
    "pickle", "struct", "socket", "re", "logging", "warnings",
    "itertools", "functools", "collections", "subprocess", "threading",
    "pytest", "unittest", "argparse", "gc", "inspect", "traceback",
}


# --------------------------------------------------------------------- helpers
def _call_name(func: ast.expr) -> Optional[str]:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _attr_base_name(func: ast.expr) -> Optional[str]:
    if isinstance(func, ast.Attribute):
        v = func.value
        if isinstance(v, ast.Name):
            return v.id
        if isinstance(v, ast.Attribute):
            return v.attr
    return None


def _is_init_call(node: ast.Call) -> bool:
    name = _call_name(node.func)
    if name in INIT_CALLS:
        return True
    return name == "initialize" and _attr_base_name(node.func) == "distributed"


def _is_spawn_call(node: ast.Call) -> Optional[str]:
    name = _call_name(node.func)
    base = _attr_base_name(node.func)
    if name in SPAWN_CALLS and base in SPAWN_BASES:
        return f"{base}.{name}()"
    return None


_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)


def _own_scope_walk(node: ast.AST) -> Iterable[ast.AST]:
    """Source-ordered walk that does not descend into nested scopes."""
    for child in ast.iter_child_nodes(node):
        yield child
        if not isinstance(child, _SCOPE_NODES):
            yield from _own_scope_walk(child)


# ------------------------------------------------------------------- summaries
@dataclass(frozen=True)
class Summary:
    """Facts graftflow needs about a call through a function boundary."""

    name: str
    path: str = ""
    line: int = 0
    schedule: Tuple[str, ...] = ()   # flattened base-collective schedule
    taint_out: Optional[Taint] = None
    launders: bool = False           # replicated result: clears arg taint
    forks: Optional[str] = None      # reason, e.g. "function-local import"
    does_init: bool = False
    computed: bool = False           # derived from source vs hand seed
    truncated: bool = False          # schedule hit SCHEDULE_CAP


@dataclass
class _FnFacts:
    """Pre-extracted per-function structure the fixpoint re-evaluates.

    ``events`` is the source-ordered list of ``("coll", name, line)`` /
    ``("call", name, line)`` entries of the function's own scope, with
    referenced nested closures inlined at their reference point (so the
    ``guarded_call(label, impl)`` pattern sees through ``impl``)."""

    name: str
    path: str
    line: int
    events: List[Tuple[str, str, int]]
    assigns: List[Tuple[str, ast.expr]]   # source-ordered Name bindings
    returns: List[ast.expr]
    direct_fork: Optional[str]
    direct_init: bool


def _function_events(fn: ast.AST, nested: Dict[str, "_FnFacts"],
                     inlining: Set[str]) -> Tuple[List[Tuple[str, str, int]],
                                                  Optional[str], bool]:
    """(events, direct_fork_reason, direct_init) for one function body,
    with referenced nested defs inlined."""
    events: List[Tuple[str, str, int]] = []
    fork: Optional[str] = None
    init = False

    def _inline(name: str, line: int) -> bool:
        nonlocal fork, init
        sub = nested.get(name)
        if sub is None or name in inlining:
            return False
        inlining.add(name)
        events.extend(sub.events)
        fork = fork or sub.direct_fork
        init = init or sub.direct_init
        inlining.discard(name)
        return True

    # NOTE: function-local imports are deliberately NOT a summary-level
    # fork effect — the lazy-import idiom is pervasive in this tree
    # (every deferred ``from ..parallel import flatmove`` inside a
    # function would otherwise mark its whole call chain), so graftflow
    # flags direct post-init imports intraprocedurally instead; only
    # real process spawns propagate through summaries.
    for node in _own_scope_walk(fn):
        if not isinstance(node, ast.Call):
            continue
        line = getattr(node, "lineno", 0)
        name = _call_name(node.func)
        spawn = _is_spawn_call(node)
        if spawn:
            fork = fork or f"direct {spawn} spawn"
        if _is_init_call(node):
            init = True
        if name in COLLECTIVE_NAMES:
            events.append(("coll", name, line))
        elif name is not None and _attr_base_name(node.func) not in EXTERNAL_BASES:
            if not _inline(name, line):
                events.append(("call", name, line))
        # function-valued arguments count as calls: the guarded_call /
        # higher-order pattern every collective wrapper uses
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            if isinstance(arg, ast.Name):
                if arg.id in nested:
                    _inline(arg.id, line)
                else:
                    events.append(("ref", arg.id, line))
    return events, fork, init


def _collect_facts(fn: ast.AST, path: str) -> _FnFacts:
    # nested closures: extracted first (depth-first) so the parent can
    # inline them at their reference sites; they do NOT enter the global
    # index (their bare names — ``impl`` — would collide tree-wide)
    nested: Dict[str, _FnFacts] = {}
    for child in ast.walk(fn):
        if child is fn:
            continue
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            nested.setdefault(child.name, _collect_facts(child, path))
    events, fork, init = _function_events(fn, nested, set())
    assigns: List[Tuple[str, ast.expr]] = []
    returns: List[ast.expr] = []
    for node in _own_scope_walk(fn):
        if isinstance(node, ast.Assign) and node.value is not None:
            for t in node.targets:
                if isinstance(t, ast.Name):
                    assigns.append((t.id, node.value))
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            if isinstance(node.target, ast.Name):
                assigns.append((node.target.id, node.value))
        elif isinstance(node, ast.Return) and node.value is not None:
            returns.append(node.value)
    return _FnFacts(
        name=getattr(fn, "name", "<fn>"), path=path,
        line=getattr(fn, "lineno", 0), events=events, assigns=assigns,
        returns=returns, direct_fork=fork, direct_init=init,
    )


# ---------------------------------------------------- summary-time taint probe
def _seed_resolve(name: str) -> Optional[Summary]:
    """Hand-table seed for a name with no in-scope definition."""
    launder = name in LAUNDER_CALLS
    if name in COLLECTIVE_WRAPPERS:
        # opaque one-event schedule: the wrapper name IS the event, so
        # two arms calling the same wrapper still compare symmetric
        return Summary(name, schedule=(name,), launders=launder)
    if launder:
        return Summary(name, launders=True)
    return None


class SummaryTable:
    """Resolved summaries for one analysis run.

    ``resolve`` prefers the computed summary (source of truth for
    in-scope definitions) and falls back to the hand seed; hand launder
    contracts are *kept* on top of computed facts — laundering is a
    semantic contract (replicated result) the fixpoint cannot derive,
    and the drift check polices the contradiction case."""

    def __init__(self) -> None:
        self.computed: Dict[str, Summary] = {}
        self.candidates: Dict[str, List[Summary]] = {}
        self.ambiguous: Set[str] = set()

    def resolve(self, name: Optional[str]) -> Optional[Summary]:
        if name is None:
            return None
        s = self.computed.get(name)
        if s is not None:
            if name in LAUNDER_CALLS:
                return replace(s, launders=True, taint_out=None)
            return s
        return _seed_resolve(name)

    def schedule_of(self, name: Optional[str]) -> Tuple[str, ...]:
        s = self.resolve(name)
        return s.schedule if s is not None else ()


def _expr_taint(node: Optional[ast.expr], env: Dict[str, Taint],
                resolve) -> Optional[Taint]:
    """Flow-insensitive taint of an expression for summary derivation.

    A deliberately simpler cousin of graftflow's flow-sensitive engine:
    no branch merging, no kills — good enough to answer "is this
    function's return value process-dependent?"."""
    if node is None:
        return None
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if isinstance(node, ast.Constant):
        return None
    if isinstance(node, ast.Attribute):
        if node.attr in TAINT_ATTRS:
            return TAINT_ATTRS[node.attr]
        if node.attr in REPLICATED_ATTRS:
            return None
        return _expr_taint(node.value, env, resolve)
    if isinstance(node, ast.Call):
        fname = _call_name(node.func)
        base = _attr_base_name(node.func)
        if fname in TYPE_PROBES:
            return None
        summary = None if base in EXTERNAL_BASES else resolve(fname)
        if summary is not None and summary.launders:
            return None
        if fname in COLLECTIVE_NAMES and fname in LAUNDER_CALLS:
            return None
        if fname in TAINT_CALLS:
            return TAINT_CALLS[fname]
        if summary is not None and summary.taint_out is not None:
            return summary.taint_out
        if fname in CLOCK_CALLS and base in ("time",):
            return Taint(f"host clock (time.{fname}())", "clock")
        if fname in FS_CALLS and base in ("os", "path", "glob", "shutil"):
            return Taint(f"per-host filesystem ({base}.{fname}())", "fs")
        if fname in QUEUE_CALLS and not node.args and base not in (
                "np", "numpy", "torch"):
            return Taint(f"rank-local queue state (.{fname}())", "queue")
        if fname in RNG_DRAWS and base in RNG_MODULES:
            return Taint(f"per-process RNG stream ({base}.{fname}())", "rng")
        taints = [_expr_taint(a, env, resolve) for a in node.args]
        taints += [_expr_taint(kw.value, env, resolve) for kw in node.keywords]
        if isinstance(node.func, ast.Attribute):
            taints.append(_expr_taint(node.func.value, env, resolve))
        return next((t for t in taints if t is not None), None)
    # generic: tainted if any child expression is
    for child in ast.iter_child_nodes(node):
        if isinstance(child, ast.expr):
            t = _expr_taint(child, env, resolve)
            if t is not None:
                return t
    return None


def _derive_taint_out(facts: _FnFacts, resolve) -> Optional[Taint]:
    env: Dict[str, Taint] = {}
    for name, value in facts.assigns:
        t = _expr_taint(value, env, resolve)
        if t is None:
            env.pop(name, None)
        else:
            env[name] = t
    for r in facts.returns:
        t = _expr_taint(r, env, resolve)
        if t is not None:
            return t
    return None


# ------------------------------------------------------------------- fixpoint
def _compress(seq: List[str]) -> List[str]:
    """Collapse consecutive duplicate events.  Flattened schedules
    over-approximate (every branch of every callee contributes), so the
    exact multiplicity of a repeated event deep in a chain is noise —
    what symmetry comparison needs is the event *pattern*.  Call-site
    multiplicity at the analyzed function is preserved: each call site
    contributes one (compressed) copy of the callee's schedule."""
    out: List[str] = []
    for s in seq:
        if not out or out[-1] != s:
            out.append(s)
    return out


def _merge_candidates(cands: List[Summary]) -> Tuple[Summary, bool]:
    """Merge same-bare-name candidates; second value = schedules conflict."""
    first = cands[0]
    if len(cands) == 1:
        return first, False
    schedules = {c.schedule for c in cands}
    taints = {c.taint_out for c in cands}
    conflict = len(schedules) > 1
    return Summary(
        name=first.name, path=first.path, line=first.line,
        # conflicting schedules: conservative empty (the call is opaque)
        schedule=first.schedule if not conflict else (),
        taint_out=first.taint_out if len(taints) == 1 else None,
        # a fork effect only survives the merge if EVERY candidate has
        # one — otherwise one spawning ``start`` somewhere would smear
        # fork effects over every ``.start()`` call in the tree
        forks=first.forks if all(c.forks for c in cands) else None,
        does_init=any(c.does_init for c in cands),
        computed=True,
        truncated=any(c.truncated for c in cands),
    ), conflict


def compute_summaries(trees: Dict[str, ast.Module]) -> SummaryTable:
    """Fixpoint interprocedural summaries over ``{path: parsed module}``."""
    facts: List[_FnFacts] = []
    for path in sorted(trees):
        tree = trees[path]
        stack: List[ast.AST] = list(tree.body)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                facts.append(_collect_facts(node, path))
                # methods of inner classes still index by bare name, but
                # nested function defs are closures handled by inlining
                stack.extend(n for n in node.body if isinstance(n, ast.ClassDef))
            elif isinstance(node, ast.ClassDef):
                stack.extend(node.body)
            elif hasattr(node, "body") and not isinstance(node, _SCOPE_NODES):
                for child in ast.iter_child_nodes(node):
                    stack.append(child)

    by_name: Dict[str, List[_FnFacts]] = {}
    for f in facts:
        # dunder methods never resolve at call sites (``x[i]`` does not
        # spell ``__getitem__``) but their bare names collide across
        # every container class in the tree — keep them out of the index
        if f.name.startswith("__") and f.name.endswith("__"):
            continue
        # universal array/container-API names: the builtin owners are
        # invisible to the candidate-conflict check, so an in-tree def
        # would falsely claim every np/dict/str call site in the tree
        if f.name in UNIVERSAL_NAMES:
            continue
        by_name.setdefault(f.name, []).append(f)

    # Import aliases: ``from .guard import check as check_divergence``
    # publishes an in-tree definition under a second bare name.  Point the
    # alias at the source name's facts so call sites (and hand-table
    # entries) spelled with the alias resolve to computed summaries
    # instead of dead-ending as out-of-scope.
    for path in sorted(trees):
        for node in ast.walk(trees[path]):
            if not isinstance(node, ast.ImportFrom):
                continue
            for a in node.names:
                alias = a.asname
                if (alias and alias != a.name and a.name in by_name
                        and alias not in UNIVERSAL_NAMES
                        and not (alias.startswith("__")
                                 and alias.endswith("__"))):
                    by_name.setdefault(alias, []).extend(by_name[a.name])

    table = SummaryTable()
    # iteration 0: direct facts only
    per_fn: Dict[int, Summary] = {}
    for f in facts:
        direct = tuple(_compress(
            [n for k, n, _ in f.events if k == "coll"])[:SCHEDULE_CAP])
        per_fn[id(f)] = Summary(
            name=f.name, path=f.path, line=f.line, schedule=direct,
            forks=f.direct_fork, does_init=f.direct_init, computed=True,
        )

    def _publish() -> None:
        table.computed.clear()
        table.candidates.clear()
        table.ambiguous.clear()
        for name, fns in by_name.items():
            cands = [per_fn[id(f)] for f in fns]
            table.candidates[name] = cands
            merged, conflict = _merge_candidates(cands)
            table.computed[name] = merged
            if conflict:
                table.ambiguous.add(name)

    _publish()
    for _ in range(FIXPOINT_MAX_ITERS):
        changed = False
        for f in facts:
            prev = per_fn[id(f)]
            sched: List[str] = []
            truncated = False
            forks = f.direct_fork
            init = f.direct_init
            for kind, name, _line in f.events:
                if kind == "coll":
                    sched.append(name)
                else:
                    s = table.resolve(name)
                    if s is not None:
                        sched.extend(s.schedule)
                        truncated = truncated or s.truncated
                        if s.forks and not forks:
                            # keep the chain one level deep: re-use an
                            # already-wrapped reason instead of nesting
                            forks = (s.forks if s.forks.startswith("calls ")
                                     else f"calls {name}(), which spawns "
                                          f"processes ({s.forks})")
                        init = init or s.does_init
                if len(sched) > SCHEDULE_CAP:
                    truncated = True
                    del sched[SCHEDULE_CAP:]
                    break
            sched = _compress(sched)
            taint_out = _derive_taint_out(f, table.resolve)
            new = Summary(
                name=f.name, path=f.path, line=f.line,
                schedule=tuple(sched), taint_out=taint_out, forks=forks,
                does_init=init, computed=True, truncated=truncated,
            )
            if new != prev:
                per_fn[id(f)] = new
                changed = True
        if not changed:
            break
        _publish()
    return table


# ------------------------------------------------------------------ drift diag
def drift_records(table: SummaryTable) -> List[Tuple[str, int, str]]:
    """(path, line, message) for every computed summary that contradicts
    a hand-table entry.  Only *positive* contradictions are reported —
    an entry whose definition is outside the analyzed set is normal
    (that is exactly what the seed exists for)."""
    out: List[Tuple[str, int, str]] = []
    for name in sorted(COLLECTIVE_WRAPPERS):
        cands = table.candidates.get(name)
        if not cands:
            continue
        if not any(c.schedule or c.truncated for c in cands):
            c = cands[0]
            out.append((
                c.path, c.line,
                f"hand summary table marks {name!r} collective-bearing, but the "
                "computed interprocedural summary finds no collective dispatch in "
                "its body — stale entry, or the wrapper lost its rendezvous; fix "
                "the table (heat_tpu_torch/analysis/summaries.py) or the function",
            ))
    for name in sorted(INTERNAL_LAUNDER):
        for c in table.candidates.get(name, ()):
            if c.taint_out is not None:
                out.append((
                    c.path, c.line,
                    f"hand summary table marks {name!r} as laundering "
                    "(replicated result), but the computed summary derives a "
                    f"process-dependent return [{c.taint_out}] — the contract and "
                    "the implementation disagree; one of them is wrong",
                ))
    return out
