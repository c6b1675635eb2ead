"""Capture side of the lazy layer (counterpart of
``heat_tpu/core/lazy/capture.py``).

:class:`LazyScope` (``ht.lazy()``) pushes a scope onto a per-thread stack;
while one is open on the calling thread, the port's dispatchers
(``_binary_op``, ``_local_op``, ``_reduce_op``, ``_cum_op``), ``argmax``/
``argmin``, ``matmul`` and ``mean``/``var``/``std`` offer each call here
first. A supported call becomes a :class:`~.graph.Node` and is answered by
a :class:`LazyDNDarray`, a DNDarray whose tensor does not exist yet. An
unsupported call (``out=``, a non-default ``where=``, unhashable statics, a
per-call closure, an operand that would need rows moved between ranks) is
*declined*: it runs eagerly, and ``FUSE_STATS["eager_fallbacks"]`` counts
it. Capture is a performance path, never a semantics path.

The escape hatch is the tensor itself: every ``self.__array`` of
:class:`~heat_tpu_torch.core.dndarray.DNDarray` reads the attribute
``_DNDarray__array``, which :class:`LazyDNDarray` turns into a data
descriptor. Whatever base-class code touches data (``.numpy()``,
``print``, ``.item()``, indexing, I/O, an op outside the captured set)
therefore evaluates the pending graph first. Layout reads (``shape``,
``dtype``, ``split``, ``lcounts``, ``lshape``, ``lshape_map``) answer from
the node's inferred layout.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import weakref
from typing import List, Optional

from .. import _hooks
from ..dndarray import DNDarray
from . import evaluate
from .graph import Leaf, Node, NodeMeta, scalar_token, stats_inc

__all__ = ["LazyDNDarray", "LazyScope", "lazy", "fuse", "active", "binary", "local", "reduce", "cum", "matmul",
           "argreduce", "moment"]

# innermost-last stack of open scopes, and the depth of evaluation under way, per thread:
# a serving thread evaluating requests never sees a client thread's open scope
_TLS = threading.local()


def _scopes() -> List["_Scope"]:
    s = getattr(_TLS, "scopes", None)
    if s is None:
        s = _TLS.scopes = []
    return s


@contextlib.contextmanager
def suspended():
    """Run this thread's dispatchers eagerly even inside a scope: evaluation
    replays captured calls through them."""
    _TLS.replay = getattr(_TLS, "replay", 0) + 1
    try:
        yield
    finally:
        _TLS.replay -= 1


# why the latest capture was declined (a debugging aid)
_LAST_DECLINE: Optional[str] = None


def active() -> bool:
    """Whether dispatcher calls on this thread are offered for capture: a
    scope is open, and neither a layout probe nor an evaluation is under way."""
    return bool(_scopes()) and not _hooks.in_trace_safe() and not getattr(_TLS, "replay", 0)


class _Scope:
    __slots__ = ("created",)

    def __init__(self):
        self.created: List[Node] = []


class LazyDNDarray(DNDarray):
    """A DNDarray whose tensor is a pending node of a captured graph. The
    tensor materializes at scope exit, or when base-class code reads
    ``_DNDarray__array`` (the descriptor below, which takes precedence over
    the instance dict)."""

    @classmethod
    def _from_node(cls, node: Node) -> "LazyDNDarray":
        out = cls.__new__(cls)
        m = node.meta
        out._DNDarray__comm = m.comm
        out._DNDarray__device = m.device
        out._DNDarray__dtype = m.dtype
        out._DNDarray__split = m.split
        out._DNDarray__gshape = m.gshape
        out._DNDarray__lcounts = m.lcounts
        out._lazy_node = node
        node.ref = weakref.ref(out)
        return out

    # the tensor trap: reading forces; writing (an in-place rebind) detaches the array from its node
    @property
    def _DNDarray__array(self):
        buf = self.__dict__.get("_lazy_buf")
        if buf is None:
            buf = _force(self)
        return buf

    @_DNDarray__array.setter
    def _DNDarray__array(self, value):
        self.__dict__["_lazy_buf"] = value

    def _lazy_fill(self, buf) -> None:
        """Install the evaluated tensor (called by the evaluator)."""
        self.__dict__["_lazy_buf"] = buf

    @property
    def lshape(self):
        """This rank's tensor shape: from the inferred layout while pending."""
        buf = self.__dict__.get("_lazy_buf")
        if buf is not None:
            return tuple(buf.shape)
        return self._lazy_node.meta.lshape

    @property
    def is_materialized(self) -> bool:
        """True once this result's tensor exists."""
        return self.__dict__.get("_lazy_buf") is not None


def _force(arr: LazyDNDarray):
    """Evaluate ``arr``'s pending graph now; counted as an eager fallback
    inside an open scope (something needed data mid-capture)."""
    node = arr._lazy_node
    if node.buffer is None:
        if active():
            stats_inc("eager_fallbacks")
        evaluate.evaluate([node])
    arr.__dict__["_lazy_buf"] = node.buffer
    return node.buffer


# ------------------------------------------------------------------ public API
class LazyScope:
    """Context manager recording supported DNDarray ops into a graph. A
    clean exit evaluates every still-reachable pending result of the scope
    as one plan (per communicator); an exception pops the scope without
    evaluating, and escaped pending arrays materialize on first access."""

    def __init__(self):
        self._scope: Optional[_Scope] = None

    def __enter__(self) -> "LazyScope":
        self._scope = _Scope()
        _scopes().append(self._scope)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        scope, self._scope = self._scope, None
        try:
            _scopes().remove(scope)
        except ValueError:  # a misnested exit
            pass
        if exc_type is None and scope is not None:
            targets = [n for n in scope.created if n.buffer is None and n.ref is not None and n.ref() is not None]
            if targets:
                evaluate.evaluate(targets)
        return False


def lazy() -> LazyScope:
    """Open a lazy-evaluation scope::

        with ht.lazy():
            z = (x - mu) / sigma      # recorded, not run
            s = ht.sum(z * z, axis=0)
        # scope exit: one plan computes z and s

    The elementwise runs of the graph go through the ``lazy_fused`` kernel
    (one launch per run on a card), everything else through the port's own
    ops in one order on every rank. Order-specified chains equal eager
    execution bit for bit."""
    return LazyScope()


def fuse(fn):
    """Decorator form of :func:`lazy`: the body records into one scope,
    evaluated on return::

        @ht.fuse
        def standardize(x, mu, sigma):
            return (x - mu) / sigma
    """

    @functools.wraps(fn)
    def fused(*args, **kwargs):
        with LazyScope():
            return fn(*args, **kwargs)

    return fused


# ------------------------------------------------------------- capture points
def _decline(reason: str):
    global _LAST_DECLINE
    _LAST_DECLINE = reason
    stats_inc("eager_fallbacks")
    return NotImplemented


def _op_token_ok(op) -> bool:
    """Ops key plans by identity: module-level functions and closures marked
    ``_cache_stable`` are stable; per-call closures and partials would make
    every signature new and are declined."""
    if isinstance(op, functools.partial):
        return False
    if "<locals>" in getattr(op, "__qualname__", "") and not getattr(op, "_cache_stable", False):
        return False
    try:
        hash(op)
    except TypeError:
        return False
    return True


def _axis_key(axis):
    """Hashable form of an axis (int, None or a sequence)."""
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


def _kwargs_key(kwargs: dict):
    """Hashable form of keyword arguments, or None when unhashable."""
    try:
        key = tuple(sorted(kwargs.items()))
        hash(key)
        return key
    except TypeError:
        return None


def _operand(t: DNDarray):
    """Wiring of a DNDarray operand: a pending result links by node; a
    concrete array (or an evaluated lazy one) is a leaf of its tensor."""
    if isinstance(t, LazyDNDarray):
        node = getattr(t, "_lazy_node", None)
        if node is not None and node.buffer is None and t.__dict__.get("_lazy_buf") is None:
            return ("node", node)
    return ("leaf", Leaf(t._raw, NodeMeta.of(t)))


def _capture(kind: str, op, raw_operands, statics, sig_statics):
    """Common tail of the capture points: check, wire the operands, infer the
    layout through the port's own dispatcher, and return a LazyDNDarray.
    Any failure (unhashable statics, an op that moves rows between ranks,
    a user error the eager path raises again) declines."""
    if not _op_token_ok(op):
        return _decline("per-call closure or unhashable op")
    operands = []
    comm = None
    for t in raw_operands:
        if isinstance(t, DNDarray):
            if comm is None:
                comm = t.comm
            elif t.comm != comm:
                return _decline("operands on different communicators")
            operands.append(_operand(t))
        else:
            if scalar_token(t) is None:
                return _decline("untokenizable scalar operand")
            operands.append(("scalar", t))
    if comm is None:
        return _decline("no DNDarray operand")
    try:
        hash(sig_statics)
    except TypeError:
        return _decline("unhashable statics")
    infer_specs = [(("meta", v.meta) if tag in ("node", "leaf") else (tag, v)) for tag, v in operands]
    try:
        meta = evaluate.infer_meta(kind, op, sig_statics, statics, infer_specs, comm)
    except Exception as e:  # graftlint: G006 - any failure declines; the eager call raises it again
        return _decline(f"{type(e).__name__}: {e}")
    node = Node(kind, op, operands, statics, sig_statics, meta)
    _scopes()[-1].created.append(node)
    return LazyDNDarray._from_node(node)


def binary(operation, t1, t2, out, where, fn_kwargs):
    if out is not None or where is not True:
        return _decline("out=/where= not captured")
    kwargs = dict(fn_kwargs) if fn_kwargs else {}
    kwargs_key = _kwargs_key(kwargs)
    if kwargs_key is None:
        return _decline("unhashable fn_kwargs")
    if not (isinstance(t1, DNDarray) or isinstance(t2, DNDarray)):
        return _decline("no DNDarray operand")
    for t in (t1, t2):
        if not isinstance(t, DNDarray) and scalar_token(t) is None:
            return _decline("non-scalar, non-DNDarray operand")
    return _capture("binary", operation, (t1, t2), (kwargs,), ("b", kwargs_key))


def local(operation, x, out, no_cast, out_dtype, kwargs):
    if out is not None or not isinstance(x, DNDarray):
        return _decline("out= / non-DNDarray input")
    kwargs = dict(kwargs)
    kwargs_key = _kwargs_key(kwargs)
    if kwargs_key is None:
        return _decline("unhashable kwargs")
    return _capture("local", operation, (x,), (bool(no_cast), out_dtype, kwargs),
                    ("l", bool(no_cast), out_dtype, kwargs_key))


def reduce(operation, x, axis, out, keepdims, out_dtype, kwargs):
    if out is not None or not isinstance(x, DNDarray):
        return _decline("out= / non-DNDarray input")
    kwargs = dict(kwargs)
    kwargs_key = _kwargs_key(kwargs)
    if kwargs_key is None:
        return _decline("unhashable kwargs")
    return _capture("reduce", operation, (x,), (axis, bool(keepdims), out_dtype, kwargs),
                    ("r", _axis_key(axis), bool(keepdims), out_dtype, kwargs_key))


def cum(operation, x, axis, out, dtype, combine):
    if out is not None or not isinstance(x, DNDarray):
        return _decline("out= / non-DNDarray input")
    return _capture("cum", operation, (x,), (axis, dtype, combine), ("c", _axis_key(axis), dtype, combine))


def argreduce(operation, x, axis, out):
    """Capture point of ``argmax``/``argmin``: the tail of the standardize ->
    matmul -> argmax predict pipeline."""
    if out is not None or not isinstance(x, DNDarray):
        return _decline("out= / non-DNDarray input")
    return _capture("argreduce", operation, (x,), (axis,), ("a", _axis_key(axis)))


def matmul(a, b, allow_resplit):
    """Capture point of ``linalg.matmul``."""
    if allow_resplit:
        return _decline("matmul allow_resplit= not captured")
    if not (isinstance(a, DNDarray) and isinstance(b, DNDarray)):
        return _decline("matmul needs two DNDarray operands")
    from ..linalg import basics  # deferred: linalg loads after core

    return _capture("matmul", basics.matmul, (a, b), (), ("m",))


def moment(fn, x, axis, ddof, where):
    """Capture point of ``mean``/``var``/``std`` (``ddof`` None for the mean):
    in ``heat_tpu`` a scope's moments are captured reductions too."""
    if where is not None or not isinstance(x, DNDarray):
        return _decline("where= / non-DNDarray input")
    kwargs = {"axis": axis} if ddof is None else {"axis": axis, "ddof": ddof}
    return _capture("moment", fn, (x,), (kwargs,), ("mo", _axis_key(axis), ddof))
