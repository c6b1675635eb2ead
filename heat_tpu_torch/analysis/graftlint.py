"""graftlint — AST checker of the port's SPMD invariants (counterpart of
``heat_tpu/analysis/graftlint.py``, its rules recast for torch).

Every rank runs the same Python program and starts collectives from it, so
a family of bugs never shows up in a unit test and only as a hang, a cache
that grows, or a stall on a host round trip at scale:

- **G001** ``retrace`` — a per-call closure, lambda or partial used as a
  key of a program cache (an ``ExecutableCache`` or a ``*_CACHE``), or
  handed to ``torch.compile``/``torch.jit``: every call is a miss that
  builds anew and parks a dead entry;
- **G002** ``unbounded-cache`` — an unbounded ``functools`` cache, or a
  module-level dict used as a cache;
- **G003** ``divergence`` — a collective under rank- or
  tensor-value-dependent control flow;
- **G004** ``host-sync`` — a host round trip in a hot path: ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``float``/``int``/``bool`` of a
  tensor reduction, ``torch.cuda.synchronize``; a name bound to a numpy
  array (a parameter annotated ``np.ndarray``, or assigned from ``np.*``
  or from a method or arithmetic of such a name) is host data already;
- **G005** ``nondeterminism`` — iterating a ``set`` to order collectives or
  build cache keys;
- **G006** ``swallow`` — a broad ``except`` that ignores the caught error
  (it swallows the ``ResilienceError`` family);
- **G007** ``durable-write`` — a write-mode ``open()`` on a durable path
  (``resilience/``, ``core/io.py``) that bypasses ``core._atomic``.

Pure stdlib (``ast`` only), so the CLI runs without torch.

Waivers
-------
A finding is waived by a ``# graftlint: <token>`` comment on the same
line or in the contiguous comment block directly above, where
``<token>`` is the rule id
(``G004``), the rule tag (``host-sync``), or ``all``.  File-level
pragmas: ``# graftlint: skip-file`` disables the file entirely;
``# graftlint: hot-path`` opts a file into the G004 hot-path set;
``# graftlint: durable-path`` opts a file into the G007 durable-write
set (the resilience package and ``core/io.py`` are in it by location).
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
    "Finding",
    "lint_source",
    "lint_file",
    "lint_paths",
    "build_report",
    "exit_code_for",
    "iter_python_files",
]

SCHEMA_VERSION = 1


@dataclass(frozen=True)
class Rule:
    id: str
    tag: str
    bit: int
    summary: str


RULES: Dict[str, Rule] = {
    r.id: r
    for r in (
        Rule("G001", "retrace", 1,
             "per-call closure/lambda/partial as a program-cache key or handed to torch.compile/torch.jit"),
        Rule("G002", "unbounded-cache", 2,
             "unbounded functools cache or module-level dict used as an executable cache"),
        Rule("G003", "divergence", 4,
             "collective dispatched under rank- or tensor-value-dependent control flow"),
        Rule("G004", "host-sync", 8,
             "implicit host synchronization in a hot path without a waiver"),
        Rule("G005", "nondeterminism", 16,
             "iteration over an unordered set feeds collective ordering or cache keys"),
        Rule("G006", "swallow", 32,
             "broad except ignores the caught error (swallows the ResilienceError hierarchy)"),
        Rule("G007", "durable-write", 64,
             "direct write-mode open() on a durable path bypasses core._atomic's crash-safe commit"),
    )
}

TAG_TO_ID = {r.tag: r.id for r in RULES.values()}

# G004 hot-path set: every parallel/ module plus the core modules on the
# per-op dispatch path.  Cold modules (io, printing, manipulations' host
# merges) do explicit, documented host work and are exempt; a new module
# opts in with a file-level ``# graftlint: hot-path`` pragma.
HOT_CORE_MODULES = {
    "_operations.py", "_movement.py", "_dispatch.py", "arithmetics.py",
    "statistics.py", "relational.py", "logical.py", "rounding.py",
    "exponential.py", "trigonometrics.py", "evaluate.py", "capture.py",
}

COLLECTIVE_NAMES = {
    "allreduce", "allgather", "alltoall", "bcast", "ring_shift", "exchange", "barrier",
    "ragged_process_allgather",
    "ragged_move", "bucket_move", "flat_move", "reshape_via_flatmove", "strided_take", "fetch",
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_to_all", "all_to_all_single",
    "broadcast", "reduce_scatter", "reduce_scatter_tensor", "batch_isend_irecv",
    "all_gather_object", "broadcast_object_list", "gather_object", "scatter_object_list",
    "nonzero_scan", "unique_merge",
}

# NOTE: process_count()/device counts are replicated-uniform across hosts
# and therefore NOT divergence hazards; only per-rank identities are.
RANK_ATTRS = {"rank", "local_rank"}
RANK_CALLS = {"get_rank", "get_node_local_rank", "current_device"}
SYNC_CALLS = {"item", "tolist", "synchronize"}
# tensor methods whose float()/int()/bool() is a host round trip (G004)
REDUCING_METHODS = {"sum", "max", "min", "mean", "amax", "amin", "prod", "norm", "any", "all", "count_nonzero",
                    "argmax", "argmin"}
JIT_CALLS = {("torch", "compile"), ("jit", "script"), ("jit", "trace")}

RESILIENCE_NAMES = {
    "ResilienceError", "DivergenceError", "CollectiveTimeout", "DegradeError",
    "NoHealthyDevicesError", "CheckpointError", "ValidationError", "LockstepError", "ServeError",
}

CACHE_NAME_RE = re.compile(r"(?i)(^|_)caches?$")
WAIVER_RE = re.compile(r"#\s*graftlint:\s*([A-Za-z0-9_,\s=-]+)")


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
            token = token.split("=", 1)[-1]  # tolerate disable=G001 spelling
            low = token.lower()
            if low in ("skip-file", "hot-path", "durable-path"):
                pragmas.add(low)
            elif low == "all":
                ids.add("all")
            elif token.upper() in RULES:
                ids.add(token.upper())
            elif low in TAG_TO_ID:
                ids.add(TAG_TO_ID[low])
            # a comment like "# graftlint: host-sync - q is tiny" puts
            # free text after the token; unknown words are simply ignored
        if ids:
            per_line[i] = ids
    return per_line, pragmas


def _is_hot(path: str, pragmas: Set[str]) -> bool:
    if "hot-path" in pragmas:
        return True
    p = "/" + path.replace(os.sep, "/").lstrip("/")
    if "/heat_tpu_torch/parallel/" in p:
        return True
    if "/heat_tpu_torch/core/" in p and os.path.basename(p) in HOT_CORE_MODULES:
        return True
    return False


# G007 durable-write set: files whose writes MUST go through the
# temp-file + fsync + rename commit in core._atomic (which is itself the
# one legitimate direct writer and therefore not in the set).
def _is_durable(path: str, pragmas: Set[str]) -> bool:
    if "durable-path" in pragmas:
        return True
    p = "/" + path.replace(os.sep, "/").lstrip("/")
    if "/heat_tpu_torch/resilience/" in p:
        return True
    return p.endswith("/heat_tpu_torch/core/io.py")


# --------------------------------------------------------------------- helpers
def _call_name(func: ast.expr) -> Optional[str]:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _is_jit(func: ast.expr) -> bool:
    """``torch.compile`` / ``torch.jit.script`` / ``torch.jit.trace``."""
    if not isinstance(func, ast.Attribute):
        return False
    v = func.value
    base = v.id if isinstance(v, ast.Name) else (v.attr if isinstance(v, ast.Attribute) else None)
    return (base, func.attr) in JIT_CALLS


def _is_literal(node: ast.expr) -> bool:
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, (ast.List, ast.Tuple)):
        return all(_is_literal(e) for e in node.elts)
    if isinstance(node, ast.UnaryOp):
        return _is_literal(node.operand)
    return False


def _walk_no_functions(node: ast.AST) -> Iterable[ast.AST]:
    """Walk statements/expressions without descending into nested
    function/class bodies (their code does not run at this point)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(n))


def _exception_names(type_node: Optional[ast.expr]) -> List[str]:
    if type_node is None:
        return []
    nodes = type_node.elts if isinstance(type_node, ast.Tuple) else [type_node]
    out = []
    for n in nodes:
        name = _call_name(n) if not isinstance(n, ast.Name) else n.id
        if isinstance(n, ast.Attribute):
            name = n.attr
        if name:
            out.append(name)
    return out


def _is_numpy_annotation(node: ast.expr) -> bool:
    """Whether an annotation names ``np.ndarray`` (or ``numpy.ndarray``)."""
    return isinstance(node, ast.Attribute) and node.attr == "ndarray" and _call_name(node.value) in ("np", "numpy")


def _is_numpy_expr(node: ast.expr, names: Set[str]) -> bool:
    """Whether ``node`` evaluates to a numpy value: a name in ``names``, a
    call into ``np``/``numpy``, or a method call (other than ``tolist``/
    ``item``) or arithmetic on such a value."""
    if isinstance(node, ast.Name):
        return node.id in names
    if isinstance(node, ast.BinOp):  # numpy on one side, numpy or a literal on the other
        sides = (node.left, node.right)
        return (any(_is_numpy_expr(n, names) for n in sides)
                and all(isinstance(n, ast.Constant) or _is_numpy_expr(n, names) for n in sides))
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        base = node.func
        while isinstance(base, ast.Attribute):
            base = base.value
        if isinstance(base, ast.Name) and base.id in ("np", "numpy"):
            return True
        return node.func.attr not in ("tolist", "item") and _is_numpy_expr(node.func.value, names)
    return False


# --------------------------------------------------------------------- checker
class _Checker(ast.NodeVisitor):
    def __init__(self, path: str, hot: bool, durable: bool = False):
        self.path = path
        self.hot = hot
        self.durable = durable
        self._atomic_names: Set[str] = set()
        self.findings: List[Finding] = []
        self._func_stack: List[ast.AST] = []
        self._local_defs: List[Set[str]] = []
        self._cache_decorated: List[bool] = []
        self._local_sets: List[Set[str]] = []
        self._local_numpy: List[Set[str]] = []
        self._handled_jit_ids: Set[int] = set()
        self._seen: Set[Tuple[str, int, int]] = set()
        self._parents: Dict[int, ast.AST] = {}

    # -- plumbing -------------------------------------------------------------
    def check(self, tree: ast.Module) -> List[Finding]:
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self._parents[id(child)] = node
            # names bound by ``with atomic_write(...) as tmp`` are staged
            # temp paths: opening THEM for write is the sanctioned pattern
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    ce = item.context_expr
                    if (
                        isinstance(ce, ast.Call)
                        and _call_name(ce.func) == "atomic_write"
                        and isinstance(item.optional_vars, ast.Name)
                    ):
                        self._atomic_names.add(item.optional_vars.id)
        self._check_module_caches(tree)
        self.visit(tree)
        return self.findings

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        key = (rule, getattr(node, "lineno", 0), getattr(node, "col_offset", 0))
        if key in self._seen:
            return
        self._seen.add(key)
        self.findings.append(
            Finding(rule, self.path, key[1], key[2], message)
        )

    def _enclosing_stmt(self, node: ast.AST) -> Optional[ast.stmt]:
        cur: Optional[ast.AST] = node
        while cur is not None and not isinstance(cur, ast.stmt):
            cur = self._parents.get(id(cur))
        return cur  # type: ignore[return-value]

    # -- scopes ---------------------------------------------------------------
    def _visit_function(self, node):
        local_defs = {
            n.name
            for n in ast.walk(node)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and n is not node
        }
        cache_dec = False
        for dec in node.decorator_list:
            base = dec.func if isinstance(dec, ast.Call) else dec
            if _call_name(base) in ("lru_cache", "cache"):
                cache_dec = True
        self._check_unbounded_decorators(node)
        self._func_stack.append(node)
        self._local_defs.append(local_defs)
        self._cache_decorated.append(cache_dec)
        self._local_sets.append(set())
        a = node.args
        self._local_numpy.append({arg.arg for arg in a.posonlyargs + a.args + a.kwonlyargs
                                  if arg.annotation is not None and _is_numpy_annotation(arg.annotation)})
        self.generic_visit(node)
        self._func_stack.pop()
        self._local_defs.pop()
        self._cache_decorated.pop()
        self._local_sets.pop()
        self._local_numpy.pop()

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    # -- G001: retrace leaks --------------------------------------------------
    def _fresh_callable(self, node: ast.expr) -> Optional[str]:
        """A callable object with per-call identity: its object is new on
        every execution of the enclosing function, so it keys every
        jit/executable cache as a miss."""
        if isinstance(node, ast.Lambda):
            return "lambda"
        if isinstance(node, ast.Call) and _call_name(node.func) == "partial":
            return "functools.partial object"
        if (
            isinstance(node, ast.Name)
            and self._local_defs
            and node.id in self._local_defs[-1]
        ):
            return f"locally-defined closure {node.id!r}"
        return None

    def visit_Call(self, node: ast.Call) -> None:
        # jit(<fresh>)(args) — jit-then-call in one expression: retraces
        # on every execution of the enclosing function
        if (
            isinstance(node.func, ast.Call)
            and _is_jit(node.func.func)
            and self._func_stack
        ):
            jit_call = node.func
            kind = self._fresh_callable(jit_call.args[0]) if jit_call.args else None
            self._handled_jit_ids.add(id(jit_call))
            if kind is not None:
                self._emit(
                    "G001", jit_call,
                    f"{_call_name(jit_call.func)} of a {kind} built and invoked per call — every call "
                    "retraces; hoist the callable to module scope or key a bounded "
                    "ExecutableCache by hashable statics",
                )
        elif _is_jit(node.func) and self._func_stack and id(node) not in self._handled_jit_ids:
            kind = self._fresh_callable(node.args[0]) if node.args else None
            if kind is not None and not self._cache_decorated[-1]:
                stmt = self._enclosing_stmt(node)
                memoized = isinstance(stmt, ast.Return)
                if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                    targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
                    memoized = any(
                        isinstance(t, (ast.Subscript, ast.Attribute)) for t in targets
                    )
                if not memoized:
                    self._emit(
                        "G001", node,
                        f"{_call_name(node.func)} of a {kind} inside a function without memoization "
                        "(not returned, cached, or stored on self) — each call builds "
                        "a fresh traced program",
                    )
        fname = _call_name(node.func)
        # a fresh callable stored in or looked up from a program cache: keys by identity, never hits
        if (fname in ("get", "setdefault", "__setitem__") and isinstance(node.func, ast.Attribute)
                and CACHE_NAME_RE.search(_call_name(node.func.value) or getattr(node.func.value, "id", "") or "")):
            for arg in node.args[:1]:
                for sub in ast.walk(arg):
                    kind = self._fresh_callable(sub)
                    if kind is not None:
                        self._emit(
                            "G001", node,
                            f"{kind} inside a key of {_call_name(node.func.value) or node.func.value.id!r} "
                            "— per-call identity makes every lookup a miss and grows the cache",
                        )
                        break
        # lambda smuggled into an executable-cache key
        self._check_sync_call(node)
        self._check_durable_open(node)
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        name = _call_name(node.value) if not isinstance(node.value, ast.Name) else node.value.id
        if name and CACHE_NAME_RE.search(name):
            for sub in ast.walk(node.slice):
                if isinstance(sub, ast.Lambda):
                    self._emit(
                        "G001", sub,
                        f"lambda inside the cache key of {name!r} — per-call identity "
                        "makes every lookup a miss and grows the cache monotonically",
                    )
        self.generic_visit(node)

    # -- G002: unbounded caches -----------------------------------------------
    def _check_unbounded_decorators(self, node) -> None:
        for dec in node.decorator_list:
            call = dec if isinstance(dec, ast.Call) else None
            base = dec.func if isinstance(dec, ast.Call) else dec
            name = _call_name(base)
            if name == "cache" and isinstance(base, ast.Attribute):
                # functools.cache == lru_cache(maxsize=None)
                self._emit(
                    "G002", dec,
                    "functools.cache is unbounded — compiled executables and their "
                    "Mesh objects are pinned forever; use lru_cache(maxsize=N) or "
                    "core._cache.ExecutableCache",
                )
            if name != "lru_cache":
                continue
            unbounded = False
            if call is not None:
                if call.args and isinstance(call.args[0], ast.Constant) and call.args[0].value is None:
                    unbounded = True
                for kw in call.keywords:
                    if kw.arg == "maxsize" and isinstance(kw.value, ast.Constant) and kw.value.value is None:
                        unbounded = True
            if unbounded:
                self._emit(
                    "G002", dec,
                    "lru_cache(maxsize=None) never evicts — shape-polymorphic "
                    "workloads grow it without bound; give it a maxsize",
                )

    def _check_module_caches(self, tree: ast.Module) -> None:
        bodies = [tree.body]
        bodies.extend(n.body for n in tree.body if isinstance(n, ast.ClassDef))
        for body in bodies:
            for stmt in body:
                if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                    continue
                targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
                value = stmt.value
                if value is None:
                    continue
                is_plain_dict = isinstance(value, ast.Dict) or (
                    isinstance(value, ast.Call)
                    and _call_name(value.func) in ("dict", "OrderedDict", "defaultdict")
                )
                if not is_plain_dict:
                    continue
                for t in targets:
                    if isinstance(t, ast.Name) and CACHE_NAME_RE.search(t.id):
                        self._emit(
                            "G002", stmt,
                            f"module-level dict {t.id!r} used as a cache never evicts "
                            "— executables pinned for the process lifetime; use "
                            "core._cache.ExecutableCache (bounded LRU)",
                        )

    # -- G003: collectives under divergent control flow -----------------------
    def _divergence_kind(self, test: ast.expr) -> Optional[str]:
        for n in ast.walk(test):
            if isinstance(n, ast.Attribute) and n.attr in RANK_ATTRS:
                return f"rank-dependent ({n.attr})"
            if isinstance(n, ast.Call):
                name = _call_name(n.func)
                if name in RANK_CALLS:
                    return f"rank-dependent ({name}())"
                if name in SYNC_CALLS:
                    return f"device-value-dependent ({name}())"
        return None

    def _check_branch(self, node) -> None:
        kind = self._divergence_kind(node.test)
        if kind is None:
            return
        for n in _walk_no_functions(node):
            if isinstance(n, ast.Call) and _call_name(n.func) in COLLECTIVE_NAMES:
                self._emit(
                    "G003", n,
                    f"collective {_call_name(n.func)!r} under {kind} control flow "
                    f"(test at line {node.test.lineno}) — ranks taking different "
                    "branches dispatch different collective sequences and hang; "
                    "hoist the collective out of the branch",
                )

    def visit_If(self, node: ast.If) -> None:
        self._check_branch(node)
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self._check_branch(node)
        self.generic_visit(node)

    # -- G004: implicit host syncs in hot paths -------------------------------
    def _check_sync_call(self, node: ast.Call) -> None:
        if not self.hot:
            return
        f = node.func
        if isinstance(f, ast.Attribute) and self._local_numpy and _is_numpy_expr(f.value, self._local_numpy[-1]):
            return  # a numpy array's data is on the host already
        what = None
        if isinstance(f, ast.Attribute):
            if f.attr in ("item", "tolist", "numpy") and not node.args:
                what = f".{f.attr}()"
            elif f.attr == "cpu" and not node.args:
                what = ".cpu()"
            elif f.attr == "synchronize" and _call_name(f.value) == "cuda":
                what = "torch.cuda.synchronize()"
        elif isinstance(f, ast.Name) and f.id in ("float", "int", "bool") and len(node.args) == 1:
            arg = node.args[0]
            if isinstance(arg, ast.Call) and isinstance(arg.func, ast.Attribute) \
                    and arg.func.attr in REDUCING_METHODS and _call_name(arg.func.value) not in ("np", "numpy"):
                what = f"{f.id}() of a tensor reduction (.{arg.func.attr}())"
        if what is not None:
            self._emit(
                "G004", node,
                f"{what} in a hot path blocks dispatch on a device->host round "
                "trip; keep the value on the device, or waive an intentional sync "
                "with '# graftlint: host-sync'",
            )

    # -- G007: direct write-mode open() on a durable path ---------------------
    def _check_durable_open(self, node: ast.Call) -> None:
        if not self.durable:
            return
        if not (isinstance(node.func, ast.Name) and node.func.id == "open"):
            return
        mode = node.args[1] if len(node.args) > 1 else None
        for kw in node.keywords:
            if kw.arg == "mode":
                mode = kw.value
        # no/dynamic mode: default "r", or unprovable — only a literal
        # write-capable mode is a definite bypass of the atomic layer
        if not (isinstance(mode, ast.Constant) and isinstance(mode.value, str)):
            return
        if not any(c in mode.value for c in "wax+"):
            return
        target = node.args[0] if node.args else None
        if isinstance(target, ast.Name) and target.id in self._atomic_names:
            return  # staged temp path from ``with atomic_write(...) as <name>``
        self._emit(
            "G007", node,
            f"open(..., {mode.value!r}) on a durable path writes in place — a "
            "crash mid-write leaves a torn file; stage through core._atomic "
            "(atomic_write/atomic_write_bytes: temp file + fsync + rename), or "
            "waive an intentional in-place write with '# graftlint: durable-write'",
        )

    # -- G005: unordered iteration feeding collectives / cache keys -----------
    def _is_set_expr(self, node: ast.expr) -> bool:
        if isinstance(node, ast.Set) or isinstance(node, ast.SetComp):
            return True
        if isinstance(node, ast.Call) and _call_name(node.func) in ("set", "frozenset"):
            return True
        if (
            isinstance(node, ast.Name)
            and self._local_sets
            and node.id in self._local_sets[-1]
        ):
            return True
        return False

    def _check_unordered_iter(self, iter_node: ast.expr, body_scope: ast.AST) -> None:
        if not self._is_set_expr(iter_node):
            return
        for n in _walk_no_functions(body_scope):
            hazard = None
            if isinstance(n, ast.Call) and _call_name(n.func) in COLLECTIVE_NAMES:
                hazard = f"collective {_call_name(n.func)!r}"
            elif isinstance(n, ast.Subscript):
                name = n.value.id if isinstance(n.value, ast.Name) else _call_name(n.value)
                if name and CACHE_NAME_RE.search(name):
                    hazard = f"cache key for {name!r}"
            if hazard:
                self._emit(
                    "G005", iter_node,
                    f"iteration over an unordered set feeds {hazard} — set order "
                    "differs across hosts (hash randomization), so ranks disagree "
                    "on schedule/keys; iterate sorted(...) instead",
                )
                return

    def visit_Assign(self, node: ast.Assign) -> None:
        if self._local_sets and self._is_set_expr(node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self._local_sets[-1].add(t.id)
        self.generic_visit(node)
        if self._local_numpy:  # after the value's own calls were checked against the old bindings
            names = self._local_numpy[-1]
            numpy_value = _is_numpy_expr(node.value, names)
            for t in node.targets:
                if isinstance(t, ast.Name):
                    (names.add if numpy_value else names.discard)(t.id)
                else:  # unpacked or stored elsewhere: no longer known to be numpy
                    names.difference_update(n.id for n in ast.walk(t) if isinstance(n, ast.Name))

    def visit_For(self, node: ast.For) -> None:
        self._check_unordered_iter(node.iter, node)
        self.generic_visit(node)

    def _visit_comp(self, node) -> None:
        for gen in node.generators:
            self._check_unordered_iter(gen.iter, node)
        self.generic_visit(node)

    visit_ListComp = _visit_comp
    visit_SetComp = _visit_comp
    visit_GeneratorExp = _visit_comp
    visit_DictComp = _visit_comp

    # -- G006: broad except swallowing ResilienceError ------------------------
    def visit_Try(self, node: ast.Try) -> None:
        resilience_handled = False
        for handler in node.handlers:
            names = _exception_names(handler.type)
            if any(n in RESILIENCE_NAMES for n in names):
                resilience_handled = True
                continue
            broad = handler.type is None or any(
                n in ("Exception", "BaseException") for n in names
            )
            if not broad or resilience_handled:
                continue
            reraises = any(isinstance(n, ast.Raise) for n in ast.walk(handler))
            uses_exc = handler.name is not None and any(
                isinstance(n, ast.Name) and n.id == handler.name
                for stmt in handler.body
                for n in ast.walk(stmt)
            )
            if not reraises and not uses_exc:
                caught = names[0] if names else "everything (bare except)"
                self._emit(
                    "G006", handler,
                    f"broad handler catches {caught} and ignores the error — "
                    "DivergenceError/CollectiveTimeout would be swallowed into "
                    "silent corruption; narrow the type or put "
                    "'except ResilienceError: raise' first",
                )
        self.generic_visit(node)


# ------------------------------------------------------------------ public API
def lint_source(
    source: str, path: str = "<string>", select: Optional[Set[str]] = None
) -> List[Finding]:
    """Lint one source string; returns unwaived findings."""
    waivers, pragmas = _parse_waivers(source)
    if "skip-file" in pragmas:
        return []
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding("SYNTAX", path, e.lineno or 0, e.offset or 0, str(e.msg))]
    checker = _Checker(
        path, hot=_is_hot(path, pragmas), durable=_is_durable(path, pragmas)
    )
    findings = checker.check(tree)
    lines = source.splitlines()

    def _waived(lineno: int) -> Set[str]:
        ids = set(waivers.get(lineno, ()))
        # the contiguous comment block directly above also covers the line
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


def lint_file(path: str, select: Optional[Set[str]] = None) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as fh:
        return lint_source(fh.read(), path=path, select=select)


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


def lint_paths(
    paths: Sequence[str], select: Optional[Set[str]] = None
) -> Tuple[List[Finding], int]:
    """(findings, files_checked) over files and/or directory trees."""
    files = iter_python_files(paths)
    findings: List[Finding] = []
    for f in files:
        findings.extend(lint_file(f, select=select))
    return findings, len(files)


def exit_code_for(findings: Iterable[Finding]) -> int:
    """Per-rule exit bitmask: G001=1, G002=2, ... G007=64; syntax errors=128."""
    code = 0
    for f in findings:
        code |= RULES[f.rule].bit if f.rule in RULES else 128
    return code


def build_report(paths: Sequence[str], findings: List[Finding], files_checked: int) -> dict:
    """The machine-readable output contract (validated in tier-1)."""
    counts = {rid: 0 for rid in RULES}
    for f in findings:
        if f.rule in counts:
            counts[f.rule] += 1
    return {
        "tool": "graftlint",
        "schema_version": SCHEMA_VERSION,
        "paths": list(paths),
        "files_checked": files_checked,
        "rules": [
            {"id": r.id, "tag": r.tag, "bit": r.bit, "summary": r.summary}
            for r in RULES.values()
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
        f"graftlint: {report['total']} finding(s) in {report['files_checked']} file(s)"
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
            f"title=graftlint {f['rule']}::{msg}"
        )
    return "\n".join(lines)


_EXIT_EPILOG = (
    "exit code is a bitmask: "
    + ", ".join(f"{r.bit}={r.id}" for r in RULES.values())
    + ", 128=syntax/internal error; 0 means clean "
    "(table: docs/ANALYSIS.md)"
)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="graftlint",
        description="SPMD invariant checker for the heat_tpu_torch tree "
        "(rule reference: docs/ANALYSIS.md)",
        epilog=_EXIT_EPILOG,
    )
    parser.add_argument("paths", nargs="*", default=["heat_tpu_torch"], help="files or directories")
    parser.add_argument("--format", choices=("text", "json", "github"), default="text")
    parser.add_argument(
        "--select", default=None,
        help="comma-separated rule ids to run (default: all)",
    )
    parser.add_argument("--list-rules", action="store_true")
    args = parser.parse_args(argv)

    if args.list_rules:
        for r in RULES.values():
            print(f"{r.id}  [{r.tag}]  exit-bit {r.bit}: {r.summary}")
        return 0

    select = None
    if args.select:
        select = {s.strip().upper() for s in args.select.split(",") if s.strip()}
        unknown = select - set(RULES)
        if unknown:
            print(f"graftlint: unknown rule id(s): {sorted(unknown)}", file=sys.stderr)
            return 128
    try:
        findings, files_checked = lint_paths(args.paths, select=select)
    except OSError as e:
        print(f"graftlint: {e}", file=sys.stderr)
        return 128
    report = build_report(args.paths, findings, files_checked)
    if args.format == "json":
        print(json.dumps(report, separators=(",", ":"), sort_keys=True))
    elif args.format == "github":
        out = render_github(report)
        if out:
            print(out)
        print(f"graftlint: {report['total']} finding(s) in {report['files_checked']} file(s)")
    else:
        print(render_text(report))
    return report["exit_code"]


if __name__ == "__main__":
    sys.exit(main())
