"""graftflow — flow-sensitive SPMD taint analysis (counterpart of
``heat_tpu/analysis/graftflow.py``, over the port's vocabulary in
:mod:`.summaries`).

It taint-tracks *process-dependent* values — rank identity
(``comm.rank``, ``dist.get_rank()``), this rank's chunk (``comm.chunk()``,
``.larray``, ``._raw``, ``.lshape``), per-host I/O and filesystem probes,
host clocks, un-seeded RNG, rank-local queue state — through assignments,
calls and containers, flow-sensitively through ``if``/``while``/``for``/
``try``. Values laundered through a replicating collective (``allgather``,
``allreduce``, ``ragged_process_allgather``, ``replicated_decision``, ...)
are clean. Calls resolve through computed interprocedural summaries.
On top of the taint facts it extracts per-function collective schedules
and flags the shapes that hang a group of ranks:

- **F001** ``divergent-collective`` — a process-dependent branch whose two
  arms dispatch different collective schedules;
- **F002** ``tainted-key`` — a process-dependent value in a cache key;
- **F003** ``divergent-loop`` — a loop whose trip count is
  process-dependent and whose body dispatches collectives;
- **F004** ``divergent-exit`` — an early ``return`` under a
  process-dependent condition that skips later collectives;
- **F005** ``object-collective`` — a ``torch.distributed`` object
  collective (``all_gather_object``, ``broadcast_object_list``, ...): a
  pickled host value of rank-dependent size moved through a blocking
  CPU round, which under NCCL also needs the current card set; gather
  tensors instead;
- **F006** ``eager-loop-gather`` — ``.numpy()``/``.item()``/``.tolist()``/
  ``.cpu()`` inside a loop body that also dispatches collectives;
- **F007** ``fork-after-init`` — a function-local import or a process
  spawn reachable after ``torch.distributed`` init in the same scope;
- **F008** ``thread-discipline`` — in threaded modules (``serve/``,
  ``stream/``, ``resilience/monitor.py``, or files carrying
  ``# graftflow: threaded``): a raw collective outside
  ``collective_lockstep``, or a blocking queue call while holding a lock;
- **F009** ``unreplicated-decision`` — clock or queue state steering a
  branch whose arms dispatch different collective schedules.

Waivers
-------
``# graftflow: <token>`` (the ``# graftlint:`` spelling is honored too,
so a mixed line can carry one comment) on the same line or in the
contiguous comment block directly above, where ``<token>`` is a rule id
(``F001``), a tag (``divergent-collective``), ``DRIFT``, or ``all``.
File-level pragma ``# graftflow: skip-file`` disables the file;
``# graftflow: threaded`` opts a file into the F008 threaded-module
discipline.  The ``# graftflow-fixture:`` header spelling used by the
test corpus is deliberately not matched by the waiver grammar.
"""
from __future__ import annotations

import ast
import json
import os
import re
import sys
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "RULES",
    "DRIFT_RULE",
    "Finding",
    "analyze_source",
    "analyze_file",
    "analyze_paths",
    "collective_schedules",
    "build_report",
    "exit_code_for",
    "iter_python_files",
]

SCHEMA_VERSION = 2


def _load_summaries():
    """Load the summaries module both as a package sibling and when this
    file is exec'd standalone by path from tools/graftcheck.py."""
    if __package__:
        try:
            from . import summaries  # type: ignore[no-redef]
            return summaries
        except ImportError:
            pass
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "summaries.py")
    spec = importlib.util.spec_from_file_location("_graftflow_summaries", path)
    assert spec is not None and spec.loader is not None
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


_S = _load_summaries()

# Shared vocabulary lives in summaries.py (single source of truth for
# the analyzer and the fixpoint); re-exported here because tests and
# docs address it as graftflow's.
Taint = _S.Taint
COLLECTIVE_NAMES = _S.COLLECTIVE_NAMES
TAINT_ATTRS = _S.TAINT_ATTRS
REPLICATED_ATTRS = _S.REPLICATED_ATTRS
TAINT_CALLS = _S.TAINT_CALLS
CLOCK_CALLS = _S.CLOCK_CALLS
FS_CALLS = _S.FS_CALLS
RNG_FACTORIES = _S.RNG_FACTORIES
RNG_DRAWS = _S.RNG_DRAWS
RNG_MODULES = _S.RNG_MODULES
QUEUE_CALLS = _S.QUEUE_CALLS
LAUNDER_CALLS = _S.LAUNDER_CALLS
COLLECTIVE_WRAPPERS = _S.COLLECTIVE_WRAPPERS


@dataclass(frozen=True)
class Rule:
    id: str
    tag: str
    bit: int
    summary: str


# F001-F004 keep their historical bits; the PR 19 rule pack shares bit
# 16 (exit codes are 8-bit and 128 is the syntax/internal bit — the
# JSON report's per-rule counts carry the exact split).
RULES: Dict[str, Rule] = {
    r.id: r
    for r in (
        Rule("F001", "divergent-collective", 1,
             "branch on a process-dependent value dispatches different collective schedules per arm"),
        Rule("F002", "tainted-key", 2,
             "process-dependent value used as an executable-cache key (per-process program drift)"),
        Rule("F003", "divergent-loop", 4,
             "loop with a process-dependent trip count dispatches collectives in its body"),
        Rule("F004", "divergent-exit", 8,
             "early return under a process-dependent condition skips later collectives"),
        Rule("F005", "object-collective", 16,
             "torch.distributed object collective: a pickled host value of rank-dependent size in a blocking CPU round"),
        Rule("F006", "eager-loop-gather", 16,
             "per-iteration eager gather (.numpy()/.item()/device_get) inside a loop that also dispatches collectives"),
        Rule("F007", "fork-after-init", 16,
             "function-local import or process spawn reachable after torch.distributed init"),
        Rule("F008", "thread-discipline", 16,
             "collective outside collective_lockstep in a threaded module, or blocking queue op while holding a lock"),
        Rule("F009", "unreplicated-decision", 16,
             "wall-clock/queue-local state steers a schedule-changing branch without replicated_decision"),
    )
}

# Drift is a diagnostic about the analyzer's own model, not a program
# bug class, so it lives outside RULES but rides the same report.
DRIFT_RULE = Rule("DRIFT", "summary-drift", 32,
                  "computed interprocedural summary contradicts a hand-table entry")

TAG_TO_ID = {r.tag: r.id for r in RULES.values()}
TAG_TO_ID[DRIFT_RULE.tag] = DRIFT_RULE.id

CACHE_NAME_RE = re.compile(r"(?i)(^|_)caches?$")
WAIVER_RE = re.compile(r"#\s*graft(?:flow|lint):\s*([A-Za-z0-9_,\s=-]+)")

# F008 applies where collective dispatch crosses thread boundaries.
_THREADED_PARTS = ("heat_tpu_torch/serve/", "heat_tpu_torch/stream/")
_THREADED_FILES = ("heat_tpu_torch/resilience/monitor.py",)

# F006: eager host reads that force a device->host transfer (a hidden
# sync point whose ordering interleaves with collectives under skew).
EAGER_READS = {"numpy", "item", "tolist", "cpu"}
OBJECT_COLLECTIVES = {"all_gather_object", "broadcast_object_list", "gather_object", "scatter_object_list"}


@dataclass
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str

    def as_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
        }


# --------------------------------------------------------------------- waivers
def _parse_waivers(source: str) -> Tuple[Dict[int, Set[str]], Set[str]]:
    """(line -> waived rule ids, file-level pragma tokens)."""
    per_line: Dict[int, Set[str]] = {}
    pragmas: Set[str] = set()
    for i, text in enumerate(source.splitlines(), start=1):
        m = WAIVER_RE.search(text)
        if not m:
            continue
        ids: Set[str] = set()
        for token in re.split(r"[,\s]+", m.group(1).strip()):
            if not token or token == "-":
                continue
            token = token.split("=", 1)[-1]
            low = token.lower()
            if low in ("skip-file", "threaded"):
                pragmas.add(low)
            elif low == "all":
                ids.add("all")
            elif token.upper() in RULES or token.upper() == DRIFT_RULE.id:
                ids.add(token.upper())
            elif low in TAG_TO_ID:
                ids.add(TAG_TO_ID[low])
            # graftlint ids/tags and free prose after the token land here
            # and are ignored — the two tools share one comment namespace
        if ids:
            per_line[i] = ids
    return per_line, pragmas


def _is_threaded(path: str) -> bool:
    p = path.replace(os.sep, "/")
    if any(part in p for part in _THREADED_PARTS):
        return True
    return any(p.endswith(f) for f in _THREADED_FILES)


# --------------------------------------------------------------------- helpers
_call_name = _S._call_name
_attr_base_name = _S._attr_base_name
_SCOPE_NODES = _S._SCOPE_NODES
_ordered_walk = _S._own_scope_walk


def _call_schedule_events(n: ast.Call, table) -> List[Tuple[str, int]]:
    """Schedule events one call site contributes: a base collective is
    itself an event; any other name resolves through the summary table
    to its flattened schedule.  Function-valued arguments count too
    (the ``guarded_call(label, impl, ...)`` higher-order idiom)."""
    out: List[Tuple[str, int]] = []
    name = _call_name(n.func)
    if name in COLLECTIVE_NAMES:
        out.append((name, n.lineno))
    elif _attr_base_name(n.func) not in _S.EXTERNAL_BASES:
        out.extend((s, n.lineno) for s in table.schedule_of(name))
    for arg in [*n.args, *[kw.value for kw in n.keywords]]:
        if isinstance(arg, ast.Name):
            if arg.id in COLLECTIVE_NAMES:
                out.append((arg.id, n.lineno))
            else:
                out.extend((s, n.lineno) for s in table.schedule_of(arg.id))
    return out


def _schedule(stmts: Sequence[ast.stmt], table) -> List[Tuple[str, int]]:
    """Ordered collective call sites reachable in a statement list,
    resolved through the interprocedural summary table."""
    out: List[Tuple[str, int]] = []
    for stmt in stmts:
        for n in [stmt, *_ordered_walk(stmt)]:
            if isinstance(n, ast.Call):
                out.extend(_call_schedule_events(n, table))
    return out


def _fmt_sched(names: List[str]) -> str:
    if not names:
        return "none"
    if len(names) > 5:
        return repr(names[:5])[:-1] + f", … +{len(names) - 5} more]"
    return repr(names)


def _first_difference(a: List[str], b: List[str]) -> str:
    for x, y in zip(a, b):
        if x != y:
            return x
    longer = a if len(a) > len(b) else b
    return longer[min(len(a), len(b))]


def _ctx_name(expr: ast.expr) -> Optional[str]:
    if isinstance(expr, ast.Call):
        return _call_name(expr.func)
    if isinstance(expr, ast.Attribute):
        return expr.attr
    if isinstance(expr, ast.Name):
        return expr.id
    return None


def _is_lock_ctx(expr: ast.expr) -> bool:
    n = _ctx_name(expr)
    return bool(n) and "lock" in n.lower() and "lockstep" not in n.lower()


def _is_lockstep_ctx(expr: ast.expr) -> bool:
    n = _ctx_name(expr)
    return n == "collective_lockstep"


def _is_sharding_expr(expr: ast.expr) -> bool:
    """Placement argument that names a sharding (vs a single device).
    SingleDeviceSharding is fully addressable by construction."""
    name = None
    if isinstance(expr, ast.Call):
        name = _call_name(expr.func)
    elif isinstance(expr, ast.Attribute):
        name = expr.attr
    elif isinstance(expr, ast.Name):
        name = expr.id
    if name is None or name == "SingleDeviceSharding":
        return False
    return "sharding" in name.lower()


def _queueish(expr: ast.expr) -> bool:
    name = None
    if isinstance(expr, ast.Attribute):
        name = expr.attr
    elif isinstance(expr, ast.Name):
        name = expr.id
    if not name:
        return False
    low = name.lower().lstrip("_")
    return "queue" in low or low == "q" or low.endswith("_q") or low.startswith("q_")


def _eager_reads(stmts: Sequence[ast.stmt]) -> List[Tuple[str, ast.Call]]:
    """(display name, call node) for F006 eager host reads in a loop
    body.  Reads nested inside collective_lockstep(...) are pinned to
    the dispatcher's schedule and exempt."""
    out: List[Tuple[str, ast.Call]] = []

    def visit(node: ast.AST, pinned: bool) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _SCOPE_NODES):
                continue
            p = pinned
            if isinstance(child, ast.Call):
                n = _call_name(child.func)
                if n == "collective_lockstep":
                    p = True
                elif not pinned:
                    if (n in EAGER_READS and isinstance(child.func, ast.Attribute)
                            and not child.args):
                        out.append((f".{n}()", child))
                    elif n == "device_get":
                        out.append(("device_get()", child))
            visit(child, p)

    for s in stmts:
        visit(s, False)
    return out


# ------------------------------------------------------------------ the engine
class _FlowAnalyzer:
    """Flow-sensitive intraprocedural taint propagation for one scope.

    State maps variable name -> Taint (reason + source kind).  A name
    absent from the state is clean; assignment of a clean value kills
    taint; branch merge is the union of arm states (conservative)."""

    def __init__(self, checker: "_FileChecker"):
        self.checker = checker
        self.table = checker.table
        self._lockstep = 0       # depth inside collective_lockstep(...)
        self._locks = 0          # depth inside `with <lock>:` blocks
        self._post_init = False  # a distributed-init call has executed
        self._module_scope = False
        self._hostvals: Set[str] = set()  # names bound to host values (F005)

    def sched(self, stmts: Sequence[ast.stmt]) -> List[Tuple[str, int]]:
        cache = self.checker._stmt_sched
        out: List[Tuple[str, int]] = []
        for stmt in stmts:
            if id(stmt) not in cache:
                cache[id(stmt)] = _schedule([stmt], self.table)
            out.extend(cache[id(stmt)])
        return out

    def sched_names(self, stmts: Sequence[ast.stmt]) -> List[str]:
        return [name for name, _ in self.sched(stmts)]

    # -- driver ---------------------------------------------------------------
    def run(self, body: Sequence[ast.stmt], init_state: Dict[str, Taint],
            module_scope: bool = False) -> None:
        self._module_scope = module_scope
        self.block(list(body), dict(init_state), rest=[])

    def block(self, stmts: List[ast.stmt], state: Dict[str, Taint],
              rest: List[str]) -> Dict[str, Taint]:
        rests = [rest]  # the schedule after each statement, built from the end
        for stmt in reversed(stmts[1:]):
            rests.append(self.sched_names([stmt]) + rests[-1])
        for stmt, rest_here in zip(stmts, reversed(rests)):
            self.stmt(stmt, state, rest_here)
        return state

    # -- statements -----------------------------------------------------------
    def stmt(self, node: ast.stmt, state: Dict[str, Taint], rest: List[str]) -> None:
        if self._post_init and isinstance(node, (ast.Import, ast.ImportFrom)) \
                and not self._module_scope:
            mod = (node.names[0].name if isinstance(node, ast.Import)
                   else (node.module or "."))
            self.checker.emit(
                "F007", node,
                f"function-local import of {mod!r} after distributed init — "
                "importing here can spawn threads or subprocesses into a "
                "process that already holds gRPC state (the PR 18 lazy-import "
                "wedge); hoist the import to module scope",
            )
        if isinstance(node, ast.Assign):
            t = self.expr(node.value, state)
            host = self._is_host_value(node.value)
            for target in node.targets:
                self.bind(target, t, state)
                if isinstance(target, ast.Name):
                    (self._hostvals.add if host else
                     self._hostvals.discard)(target.id)
        elif isinstance(node, ast.AnnAssign):
            if node.value is not None:
                self.bind(node.target, self.expr(node.value, state), state)
                if isinstance(node.target, ast.Name):
                    (self._hostvals.add if self._is_host_value(node.value) else
                     self._hostvals.discard)(node.target.id)
        elif isinstance(node, ast.AugAssign):
            t = self.expr(node.value, state)
            if isinstance(node.target, ast.Name):
                prior = state.get(node.target.id)
                self.bind(node.target, t or prior, state)
            else:
                self.bind(node.target, t, state)
        elif isinstance(node, ast.Expr):
            self.expr(node.value, state)
            self._container_mutation(node.value, state)
        elif isinstance(node, ast.If):
            self._if(node, state, rest)
        elif isinstance(node, ast.While):
            self._loop(node, node.test, state, rest, kind="while")
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            t_iter = self.expr(node.iter, state)
            body_state = dict(state)
            self.bind(node.target, t_iter, body_state)
            body_sched = self.sched(node.body)
            if t_iter is not None and body_sched:
                first = body_sched[0][0]
                self.checker.emit(
                    "F003", node,
                    f"for-loop over a process-dependent iterable [{t_iter}] "
                    f"dispatches collective {first!r} in its body — ranks run "
                    "different numbers of rendezvous rounds; iterate a "
                    "replicated quantity instead",
                )
            if body_sched:
                self._check_eager_reads(node.body, body_sched)
            self._fixpoint_body(node.body, body_state, rest)
            for h in node.orelse:
                self.stmt(h, body_state, rest)
            self._merge(state, body_state)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            locks = steps = 0
            for item in node.items:
                t = self.expr(item.context_expr, state)
                if item.optional_vars is not None:
                    self.bind(item.optional_vars, t, state)
                if _is_lock_ctx(item.context_expr):
                    locks += 1
                if _is_lockstep_ctx(item.context_expr):
                    steps += 1
            self._locks += locks
            self._lockstep += steps
            try:
                self.block(list(node.body), state, rest)
            finally:
                self._locks -= locks
                self._lockstep -= steps
        elif isinstance(node, ast.Try):
            pre = dict(state)
            self.block(list(node.body), state, rest)
            for handler in node.handlers:
                h_state = dict(pre)
                self.block(list(handler.body), h_state, rest)
                self._merge(state, h_state)
            self.block(list(node.orelse), state, rest)
            self.block(list(node.finalbody), state, rest)
        elif isinstance(node, ast.Return):
            if node.value is not None:
                self.expr(node.value, state)
        elif isinstance(node, (ast.Raise, ast.Assert, ast.Delete)):
            for n in ast.iter_child_nodes(node):
                if isinstance(n, ast.expr):
                    self.expr(n, state)
            if isinstance(node, ast.Delete):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        state.pop(t.id, None)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # closure capture: the nested function sees the taint facts
            # live at its definition point
            self.checker.analyze_scope(node.body, dict(state))
        elif isinstance(node, ast.ClassDef):
            self.checker.analyze_scope(node.body, dict(state))
        elif isinstance(node, ast.Match) if hasattr(ast, "Match") else False:
            self.expr(node.subject, state)
            for case in node.cases:
                c_state = dict(state)
                self.block(list(case.body), c_state, rest)
                self._merge(state, c_state)
        else:
            for n in ast.iter_child_nodes(node):
                if isinstance(n, ast.expr):
                    self.expr(n, state)
        if not self._post_init and self._stmt_does_init(node):
            self._post_init = True

    def _stmt_does_init(self, node: ast.stmt) -> bool:
        for n in [node, *_ordered_walk(node)]:
            if isinstance(n, ast.Call):
                if _S._is_init_call(n):
                    return True
                s = self.table.resolve(_call_name(n.func))
                if s is not None and s.does_init:
                    return True
        return False

    def _check_eager_reads(self, body: Sequence[ast.stmt],
                           body_sched: List[Tuple[str, int]]) -> None:
        reads = _eager_reads(body)
        if not reads:
            return
        # a loop whose ONLY collective events are the eager gathers
        # themselves is a symmetric per-item read (every rank gathers the
        # same items together) — the interleaving hazard needs another
        # collective in the body for the transfer to skew against
        read_lines = {call.lineno for _, call in reads}
        if all(line in read_lines for _, line in body_sched):
            return
        for display, call in reads:
            self.checker.emit(
                "F006", call,
                f"eager host gather {display} inside a loop that also "
                "dispatches collectives — the device->host transfer is a "
                "hidden sync point that interleaves with the loop's "
                "rendezvous schedule under rank skew and deadlocks; hoist "
                "the read out of the loop or pin it with "
                "collective_lockstep(...)",
            )

    def _if(self, node: ast.If, state: Dict[str, Taint], rest: List[str]) -> None:
        t_test = self.expr(node.test, state)
        if t_test is not None:
            body_sched = self.sched_names(node.body)
            else_sched = self.sched_names(node.orelse)
            if body_sched != else_sched:
                diff = _first_difference(body_sched, else_sched)
                if t_test.kind in ("clock", "queue"):
                    self.checker.emit(
                        "F009", node,
                        f"branch steered by rank-local state [{t_test}] "
                        f"dispatches different collective schedules per arm "
                        f"({_fmt_sched(body_sched)} vs {_fmt_sched(else_sched)}; "
                        f"first divergent: {diff!r}) — clocks and queue depth "
                        "differ across ranks, so the schedule diverges; wrap "
                        "the decision in replicated_decision(...)",
                    )
                else:
                    self.checker.emit(
                        "F001", node,
                        f"branch on a process-dependent value [{t_test}] dispatches "
                        f"different collective schedules per arm "
                        f"({_fmt_sched(body_sched)} vs {_fmt_sched(else_sched)}; first "
                        f"divergent: {diff!r}) — ranks disagreeing on the test hang "
                        "at the unmatched rendezvous; make the schedule symmetric "
                        "or the predicate replicated",
                    )
            if rest:
                for arm in (node.body, node.orelse):
                    for n in arm:
                        for sub in [n, *_ordered_walk(n)]:
                            if isinstance(sub, ast.Return):
                                self.checker.emit(
                                    "F004", sub,
                                    f"early return under a process-dependent "
                                    f"condition [{t_test}] skips {len(rest)} later "
                                    f"collective(s) (first: {rest[0]!r}) — the "
                                    "returning rank truncates its collective "
                                    "schedule while the others wait",
                                )
                                break
        body_state = dict(state)
        else_state = dict(state)
        self.block(list(node.body), body_state, rest)
        self.block(list(node.orelse), else_state, rest)
        merged = dict(else_state)
        self._merge(merged, body_state)
        state.clear()
        state.update(merged)

    def _loop(self, node: ast.While, test: ast.expr, state: Dict[str, Taint],
              rest: List[str], kind: str) -> None:
        t_test = self.expr(test, state)
        body_sched = self.sched(node.body)
        if t_test is not None and body_sched:
            first = body_sched[0][0]
            self.checker.emit(
                "F003", node,
                f"{kind}-loop with a process-dependent trip count [{t_test}] "
                f"dispatches collective {first!r} in its body — ranks run "
                "different numbers of rendezvous rounds and the shorter ones "
                "hang the rest; derive the bound from a replicated value",
            )
        if body_sched:
            self._check_eager_reads(node.body, body_sched)
        body_state = dict(state)
        self._fixpoint_body(node.body, body_state, rest)
        for h in node.orelse:
            self.stmt(h, body_state, rest)
        # re-evaluate the test after one body pass: loop-carried taint in
        # the condition still counts
        if t_test is None and self.expr(test, body_state) is not None \
                and body_sched:
            first = body_sched[0][0]
            self.checker.emit(
                "F003", node,
                f"{kind}-loop condition becomes process-dependent after the "
                f"first iteration [{self.expr(test, body_state)}] and the body "
                f"dispatches collective {first!r} — divergent trip counts",
            )
        self._merge(state, body_state)

    def _fixpoint_body(self, body: Sequence[ast.stmt], state: Dict[str, Taint],
                       rest: List[str]) -> None:
        # two passes reach a fixpoint for loop-carried taint because the
        # state lattice only grows and chains are short
        before = None
        for _ in range(2):
            self.block(list(body), state, rest)
            snapshot = dict(state)
            if snapshot == before:
                break
            before = snapshot

    @staticmethod
    def _merge(into: Dict[str, Taint], other: Dict[str, Taint]) -> None:
        for k, v in other.items():
            into.setdefault(k, v)

    # -- binding --------------------------------------------------------------
    def bind(self, target: ast.expr, taint: Optional[Taint],
             state: Dict[str, Taint]) -> None:
        if isinstance(target, ast.Name):
            if taint is None:
                state.pop(target.id, None)
            else:
                state[target.id] = taint
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                inner = elt.value if isinstance(elt, ast.Starred) else elt
                self.bind(inner, taint, state)
        elif isinstance(target, ast.Subscript):
            self._check_cache_key(target, state)
            base = target.value
            if taint is not None and isinstance(base, ast.Name):
                state[base.id] = taint  # container absorbs the taint
            self.expr(target.slice, state)
        elif isinstance(target, ast.Attribute):
            self.expr(target.value, state)

    def _container_mutation(self, node: ast.expr, state: Dict[str, Taint]) -> None:
        """``xs.append(tainted)`` / ``.add`` / ``.extend`` / ``.update``
        taints the container name."""
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
            return
        if node.func.attr not in ("append", "add", "extend", "update", "insert"):
            return
        base = node.func.value
        if not isinstance(base, ast.Name):
            return
        for arg in node.args:
            t = self.expr(arg, state)
            if t is not None:
                state[base.id] = t
                return

    # -- F005 helpers ---------------------------------------------------------
    def _is_host_value(self, expr: ast.expr) -> bool:
        """Is this expression a host (numpy/python) value, as opposed to
        an already-committed device array?"""
        if isinstance(expr, (ast.Constant, ast.List, ast.Tuple, ast.Dict,
                             ast.ListComp, ast.DictComp)):
            return True
        if isinstance(expr, ast.Name):
            return expr.id in self._hostvals
        if isinstance(expr, ast.BinOp):
            return (self._is_host_value(expr.left)
                    or self._is_host_value(expr.right))
        if isinstance(expr, ast.Call):
            fname = _call_name(expr.func)
            base = _attr_base_name(expr.func)
            if base in ("np", "numpy"):
                return True
            if fname in ("list", "tuple", "dict", "float", "int", "range"):
                return True
            if fname in EAGER_READS and isinstance(expr.func, ast.Attribute):
                return True
            if fname == "device_get":
                return True
        return False

    # -- expressions ----------------------------------------------------------
    def expr(self, node: Optional[ast.expr],
             state: Dict[str, Taint]) -> Optional[Taint]:
        """Taint of an expression (None = clean).  Also emits F002/F005/
        F008 findings for hazards encountered along the way."""
        if node is None:
            return None
        if isinstance(node, ast.Name):
            return state.get(node.id)
        if isinstance(node, ast.Constant):
            return None
        if isinstance(node, ast.Attribute):
            base_t = self.expr(node.value, state)
            if node.attr in TAINT_ATTRS:
                return TAINT_ATTRS[node.attr]
            if node.attr in REPLICATED_ATTRS:
                return None
            return base_t
        if isinstance(node, ast.Call):
            return self._call(node, state)
        if isinstance(node, ast.Subscript):
            self._check_cache_key(node, state)
            t = self.expr(node.value, state)
            ts = self.expr(node.slice, state)
            return t or ts
        if isinstance(node, ast.BinOp):
            return self.expr(node.left, state) or self.expr(node.right, state)
        if isinstance(node, ast.BoolOp):
            for v in node.values:
                t = self.expr(v, state)
                if t is not None:
                    return t
            return None
        if isinstance(node, ast.UnaryOp):
            return self.expr(node.operand, state)
        if isinstance(node, ast.Compare):
            t = self.expr(node.left, state)
            for c in node.comparators:
                t = t or self.expr(c, state)
            return t
        if isinstance(node, ast.IfExp):
            return (self.expr(node.test, state)
                    or self.expr(node.body, state)
                    or self.expr(node.orelse, state))
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            for elt in node.elts:
                inner = elt.value if isinstance(elt, ast.Starred) else elt
                t = self.expr(inner, state)
                if t is not None:
                    return t
            return None
        if isinstance(node, ast.Dict):
            for k in node.keys:
                t = self.expr(k, state)
                if t is not None:
                    return t
            for v in node.values:
                t = self.expr(v, state)
                if t is not None:
                    return t
            return None
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)):
            comp_state = dict(state)
            t_any = None
            for gen in node.generators:
                t_iter = self.expr(gen.iter, comp_state)
                self.bind(gen.target, t_iter, comp_state)
                t_any = t_any or t_iter
                for cond in gen.ifs:
                    self.expr(cond, comp_state)
            if isinstance(node, ast.DictComp):
                t_any = (t_any or self.expr(node.key, comp_state)
                         or self.expr(node.value, comp_state))
            else:
                t_any = t_any or self.expr(node.elt, comp_state)
            return t_any
        if isinstance(node, ast.JoinedStr):
            for v in node.values:
                if isinstance(v, ast.FormattedValue):
                    t = self.expr(v.value, state)
                    if t is not None:
                        return t
            return None
        if isinstance(node, ast.Starred):
            return self.expr(node.value, state)
        if isinstance(node, ast.NamedExpr):
            t = self.expr(node.value, state)
            self.bind(node.target, t, state)
            return t
        if isinstance(node, ast.Lambda):
            return None
        if isinstance(node, ast.Await):
            return self.expr(node.value, state)
        # conservative default for rare nodes: taint if any child is
        t_any = None
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                t_any = t_any or self.expr(child, state)
        return t_any

    def _call(self, node: ast.Call, state: Dict[str, Taint]) -> Optional[Taint]:
        fname = _call_name(node.func)
        base = _attr_base_name(node.func)
        summary = (None if base in _S.EXTERNAL_BASES
                   else self.table.resolve(fname))

        # F008a: raw collective dispatched outside collective_lockstep
        # in a threaded module — the dispatcher thread owns the schedule
        if (self.checker.threaded and self._lockstep == 0
                and fname in COLLECTIVE_NAMES):
            self.checker.emit(
                "F008", node,
                f"collective {fname!r} dispatched outside collective_lockstep "
                "in a threaded module — a worker thread's dispatch interleaves "
                "with the dispatcher's schedule and the rendezvous order "
                "diverges across ranks; pin it with collective_lockstep(...)",
            )
        # F008b: blocking queue op while holding a lock — the consumer
        # may need the same lock to drain the queue
        if (self.checker.threaded and self._locks > 0
                and isinstance(node.func, ast.Attribute)
                and fname in ("get", "put", "join")
                and _queueish(node.func.value)):
            has_escape = any(kw.arg in ("timeout", "block")
                             for kw in node.keywords)
            positional_escape = len(node.args) >= (2 if fname == "put" else 1)
            if not has_escape and not positional_escape:
                self.checker.emit(
                    "F008", node,
                    f"blocking .{fname}() on a queue while holding a lock — "
                    "the thread that would unblock it may need the same lock, "
                    "deadlocking the pair; pass timeout=/block=False or "
                    "release the lock first",
                )
        # F005: an object collective pickles host values of rank-dependent size
        if fname in OBJECT_COLLECTIVES:
            self.checker.emit(
                "F005", node,
                f"{fname}() pickles host objects and moves them through a blocking "
                "CPU round whose payload size differs by rank (under NCCL it also "
                "needs the current card set); gather tensors of an agreed shape instead",
            )
        # F007: spawn (direct or through a callee's computed summary)
        # reachable after distributed init in this scope
        if self._post_init:
            spawn = _S._is_spawn_call(node)
            if spawn:
                self.checker.emit(
                    "F007", node,
                    f"{spawn} after distributed init — the child process "
                    "inherits wedged gRPC threads from the initialized "
                    "runtime; spawn before init_distributed() or from a "
                    "dedicated launcher process",
                )
            elif summary is not None and summary.forks and not summary.does_init:
                self.checker.emit(
                    "F007", node,
                    f"call to {fname}() after distributed init — its computed "
                    f"summary has fork effects ({summary.forks}); spawn before "
                    "init or from a dedicated launcher process",
                )

        bump = 1 if fname == "collective_lockstep" else 0
        self._lockstep += bump
        try:
            arg_taints = [self.expr(a, state) for a in node.args]
            kw_taints = [self.expr(kw.value, state) for kw in node.keywords]
            base_taint = (self.expr(node.func.value, state)
                          if isinstance(node.func, ast.Attribute) else None)
        finally:
            self._lockstep -= bump
        any_arg = next((t for t in [*arg_taints, *kw_taints] if t), None)

        # replicating collectives / laundering helpers (hand contract or
        # computed summary) return the same value on every process
        if summary is not None and summary.launders:
            return None
        if fname in LAUNDER_CALLS:
            return None
        # type-shape probes: every process runs the same program over
        # values of the same type, so isinstance(tainted, T) is replicated
        if fname in _S.TYPE_PROBES:
            return None
        # unconditional process-dependent sources
        if fname in TAINT_CALLS:
            return TAINT_CALLS[fname]
        # getattr with a literal name behaves like the attribute access
        if fname == "getattr" and len(node.args) >= 2 and isinstance(
                node.args[1], ast.Constant) and isinstance(node.args[1].value, str):
            attr = node.args[1].value
            if attr in TAINT_ATTRS:
                return TAINT_ATTRS[attr]
            if attr in REPLICATED_ATTRS:
                return None
            return arg_taints[0]
        if fname in CLOCK_CALLS and base in ("time",):
            return Taint(f"host clock (time.{fname}())", "clock")
        if fname in FS_CALLS and base in ("os", "path", "glob", "shutil"):
            return Taint(f"per-host filesystem ({base}.{fname}())", "fs")
        # rank-local queue state: no-argument .qsize()/.empty()/.full()
        # (np.empty((3,)) has arguments and a numpy base — never matches)
        if fname in QUEUE_CALLS and not node.args and not node.keywords \
                and isinstance(node.func, ast.Attribute) \
                and base not in ("np", "numpy", "torch"):
            return Taint(f"rank-local queue state (.{fname}())", "queue")
        if fname in RNG_FACTORIES and not node.args and not any(
                kw.arg in ("seed", "x") for kw in node.keywords):
            return Taint(f"un-seeded RNG ({fname}())", "rng")
        if fname in RNG_DRAWS and base in RNG_MODULES:
            return Taint(f"per-process RNG stream ({base}.{fname}())", "rng")
        # comm.chunk() defaults rank to *this* process; an explicit
        # untainted rank argument makes the result deterministic
        if fname == "chunk":
            rank_arg = node.args[2] if len(node.args) > 2 else None
            for kw in node.keywords:
                if kw.arg == "rank":
                    rank_arg = kw.value
            if rank_arg is None or (
                    isinstance(rank_arg, ast.Constant) and rank_arg.value is None):
                return Taint("this process's chunk (chunk() with default rank)",
                             "shard")
            return self.expr(rank_arg, state)
        # computed interprocedural summary: the callee's derived
        # taint-out beats the conservative any-arg default
        if summary is not None and summary.computed:
            if summary.taint_out is not None:
                return summary.taint_out
        # method on a tainted object (rng.random(), fh.read(), …)
        if base_taint is not None:
            return base_taint
        return any_arg

    # -- F002 -----------------------------------------------------------------
    def _check_cache_key(self, node: ast.Subscript, state: Dict[str, Taint]) -> None:
        name = (node.value.id if isinstance(node.value, ast.Name)
                else _call_name(node.value))
        if not (name and CACHE_NAME_RE.search(name)):
            return
        t = self.expr(node.slice, state)
        if t is not None:
            self.checker.emit(
                "F002", node,
                f"cache key for {name!r} contains a process-dependent value "
                f"[{t}] — each process compiles and caches its own program, "
                "so executables drift apart across ranks; key by replicated "
                "statics only",
            )


class _FileChecker:
    """Drives the flow analyzer over every scope of one file."""

    def __init__(self, path: str, table=None, threaded: bool = False):
        self.path = path
        self.table = table if table is not None else _S.SummaryTable()
        self.threaded = threaded
        self.findings: List[Finding] = []
        self._seen: Set[Tuple[str, int, int]] = set()
        self._stmt_sched: Dict[int, List[Tuple[str, int]]] = {}  # id(stmt) -> its schedule, walked once a file

    def emit(self, rule: str, node: ast.AST, message: str) -> None:
        key = (rule, getattr(node, "lineno", 0), getattr(node, "col_offset", 0))
        if key in self._seen:
            return
        self._seen.add(key)
        self.findings.append(Finding(rule, self.path, key[1], key[2], message))

    def analyze_scope(self, body: Sequence[ast.stmt],
                      init_state: Dict[str, Taint],
                      module_scope: bool = False) -> None:
        _FlowAnalyzer(self).run(body, init_state, module_scope=module_scope)

    def check(self, tree: ast.Module) -> List[Finding]:
        self.analyze_scope(tree.body, {}, module_scope=True)
        return self.findings


# -------------------------------------------------------- schedule extraction
def collective_schedules(source: str) -> Dict[str, List[Tuple[str, int]]]:
    """Per-function collective schedules: qualified function name ->
    ordered ``(collective, line)`` call sites, resolved through the
    file's own computed summaries (calls into in-file helpers flatten
    to the helpers' schedules).  The module's own top-level schedule is
    keyed ``"<module>"``."""
    tree = ast.parse(source)
    table = _S.compute_summaries({"<schedules>": tree})
    out: Dict[str, List[Tuple[str, int]]] = {"<module>": _schedule(tree.body, table)}

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                out[qual] = _schedule(child.body, table)
                visit(child, qual + ".")
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}{child.name}.")
            else:
                visit(child, prefix)

    visit(tree, "")
    return out


# ------------------------------------------------------------------ public API
def _drift_findings(table) -> List[Finding]:
    return [Finding(DRIFT_RULE.id, p, line, 0, msg)
            for p, line, msg in _S.drift_records(table)]


def _apply_waivers(findings: Iterable[Finding], source: str,
                   waivers: Dict[int, Set[str]],
                   select: Optional[Set[str]]) -> List[Finding]:
    lines = source.splitlines()

    def _waived(lineno: int) -> Set[str]:
        ids = set(waivers.get(lineno, ()))
        i = lineno - 1
        while 1 <= i <= len(lines) and lines[i - 1].lstrip().startswith("#"):
            ids |= waivers.get(i, set())
            i -= 1
        return ids

    out = []
    for f in findings:
        if select is not None and f.rule not in select and f.rule != "SYNTAX":
            continue
        waived = _waived(f.line)
        if f.rule in waived or "all" in waived:
            continue
        out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return out


def analyze_source(
    source: str, path: str = "<string>", select: Optional[Set[str]] = None,
    table=None,
) -> List[Finding]:
    """Analyze one source string; returns unwaived findings.

    With ``table=None`` the file's own computed summaries (plus the
    hand seeds for externals) drive call resolution and the drift
    diagnostic runs over in-file definitions; ``analyze_paths`` passes
    a shared tree-wide table instead and handles drift itself."""
    waivers, pragmas = _parse_waivers(source)
    if "skip-file" in pragmas:
        return []
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding("SYNTAX", path, e.lineno or 0, e.offset or 0, str(e.msg))]
    own_table = table is None
    if own_table:
        table = _S.compute_summaries({path: tree})
    threaded = _is_threaded(path) or "threaded" in pragmas
    findings = _FileChecker(path, table=table, threaded=threaded).check(tree)
    if own_table:
        findings = findings + _drift_findings(table)
    return _apply_waivers(findings, source, waivers, select)


def analyze_file(path: str, select: Optional[Set[str]] = None,
                 table=None) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as fh:
        return analyze_source(fh.read(), path=path, select=select, table=table)


def iter_python_files(paths: Sequence[str]) -> List[str]:
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = sorted(d for d in dirs if d != "__pycache__")
                files.extend(
                    os.path.join(root, n) for n in sorted(names) if n.endswith(".py")
                )
        else:
            files.append(p)
    return files


def analyze_paths(
    paths: Sequence[str], select: Optional[Set[str]] = None
) -> Tuple[List[Finding], int]:
    """(findings, files_checked) over files and/or directory trees.

    Summaries are computed once over the whole file set, so calls
    resolve across module boundaries; the drift diagnostic runs against
    every in-scope definition of a hand-table name."""
    files = iter_python_files(paths)
    sources: Dict[str, str] = {}
    trees: Dict[str, ast.Module] = {}
    for f in files:
        with open(f, "r", encoding="utf-8") as fh:
            sources[f] = fh.read()
    for f, src in sources.items():
        _, pragmas = _parse_waivers(src)
        if "skip-file" in pragmas:
            continue
        try:
            trees[f] = ast.parse(src, filename=f)
        except SyntaxError:
            pass  # surfaced as a SYNTAX finding by the per-file pass
    table = _S.compute_summaries(trees)
    findings: List[Finding] = []
    for f in files:
        findings.extend(analyze_source(sources[f], path=f, select=select,
                                       table=table))
    for fd in _drift_findings(table):
        src = sources.get(fd.path)
        if src is None:
            continue
        waivers, _ = _parse_waivers(src)
        findings.extend(_apply_waivers([fd], src, waivers, select))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings, len(files)


def exit_code_for(findings: Iterable[Finding]) -> int:
    """Per-rule exit bitmask: F001=1, F002=2, F003=4, F004=8, the
    F005-F009 rule pack=16, DRIFT=32; syntax errors / internal failures
    = 128 (same bit as graftlint)."""
    code = 0
    for f in findings:
        if f.rule in RULES:
            code |= RULES[f.rule].bit
        elif f.rule == DRIFT_RULE.id:
            code |= DRIFT_RULE.bit
        else:
            code |= 128
    return code


def build_report(paths: Sequence[str], findings: List[Finding], files_checked: int) -> dict:
    """Machine-readable output; same key contract as graftlint's report
    (pinned by tests/test_flow_clean.py::test_cli_json_contract)."""
    all_rules = list(RULES.values()) + [DRIFT_RULE]
    counts = {r.id: 0 for r in all_rules}
    for f in findings:
        if f.rule in counts:
            counts[f.rule] += 1
    return {
        "tool": "graftflow",
        "schema_version": SCHEMA_VERSION,
        "paths": list(paths),
        "files_checked": files_checked,
        "rules": [
            {"id": r.id, "tag": r.tag, "bit": r.bit, "summary": r.summary}
            for r in all_rules
        ],
        "findings": [f.as_dict() for f in findings],
        "counts": counts,
        "total": len(findings),
        "exit_code": exit_code_for(findings),
    }


def render_text(report: dict) -> str:
    lines = []
    for f in report["findings"]:
        lines.append(f"{f['path']}:{f['line']}:{f['col']}: {f['rule']} {f['message']}")
    lines.append(
        f"graftflow: {report['total']} finding(s) in {report['files_checked']} file(s)"
        + (" — clean" if report["total"] == 0 else "")
    )
    return "\n".join(lines)


def render_github(report: dict) -> str:
    """GitHub workflow-annotation lines (::error file=...,line=...)."""
    lines = []
    for f in report["findings"]:
        msg = f["message"].replace("%", "%25").replace("\n", "%0A")
        lines.append(
            f"::error file={f['path']},line={f['line']},col={f['col']},"
            f"title=graftflow {f['rule']}::{msg}"
        )
    return "\n".join(lines)


_EXIT_EPILOG = (
    "exit code is a bitmask: 1=F001, 2=F002, 4=F003, 8=F004, "
    "16=F005-F009 (rule pack), 32=DRIFT, 128=syntax/internal error; "
    "0 means clean (table: docs/ANALYSIS.md)"
)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="graftflow",
        description="flow-sensitive SPMD taint analysis for the heat_tpu_torch tree "
        "(finding reference: docs/ANALYSIS.md)",
        epilog=_EXIT_EPILOG,
    )
    parser.add_argument("paths", nargs="*", default=["heat_tpu_torch"], help="files or directories")
    parser.add_argument("--format", choices=("text", "json", "github"), default="text")
    parser.add_argument(
        "--select", default=None,
        help="comma-separated finding ids to run (default: all)",
    )
    parser.add_argument("--list-rules", action="store_true")
    args = parser.parse_args(argv)

    if args.list_rules:
        for r in list(RULES.values()) + [DRIFT_RULE]:
            print(f"{r.id}  [{r.tag}]  exit-bit {r.bit}: {r.summary}")
        return 0

    select = None
    if args.select:
        select = {s.strip().upper() for s in args.select.split(",") if s.strip()}
        unknown = select - set(RULES) - {DRIFT_RULE.id}
        if unknown:
            print(f"graftflow: unknown finding id(s): {sorted(unknown)}", file=sys.stderr)
            return 128
    try:
        findings, files_checked = analyze_paths(args.paths, select=select)
    except OSError as e:
        print(f"graftflow: {e}", file=sys.stderr)
        return 128
    report = build_report(args.paths, findings, files_checked)
    if args.format == "json":
        print(json.dumps(report, separators=(",", ":"), sort_keys=True))
    elif args.format == "github":
        out = render_github(report)
        if out:
            print(out)
        print(f"graftflow: {report['total']} finding(s) in {report['files_checked']} file(s)")
    else:
        print(render_text(report))
    return report["exit_code"]


if __name__ == "__main__":
    sys.exit(main())
