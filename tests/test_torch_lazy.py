"""heat_tpu_torch's lazy layer (``ht.lazy``/``ht.fuse``) against its own
eager execution and against heat_tpu's lazy layer, on the CPU.

- heat_tpu's chains (``tests/test_lazy.py``'s ``CHAINS``/``NAN_CHAINS``)
  over split None/0/1 and float32/float64: the port's lazy result equals
  the port's eager result bit for bit (its plans replay the eager ops, and
  the plain version of ``lazy_fused`` runs the fused runs one torch op at a
  time), and agrees with heat_tpu's lazy result within heat_tpu's own
  tolerances (rtol 1e-5/atol 1e-6 in float32, 1e-12/1e-14 in float64; the
  elementwise chain within 4 ulp, where XLA's fusion and torch's kernels
  may round exp differently; the cumulative chains to rtol 1e-5/atol 1e-5
  and 1e-12/1e-13, as XLA's scan adds in another order);
- ``FUSE_STATS`` deltas equal heat_tpu's on the same sequences: a warm
  chain, the shared prefix, ``out=``, forces mid-scope, nested scopes, an
  exception during capture, the decorator, metadata without forcing;
- each segment of a plan run through ``lazy_fused_plain`` equals eager.

heat_tpu runs under ``comm_context(SELF)``, at world size 1 as the port
does here. The chains across 4 ranks are ``tests/test_torch_dist.py``'s
``lazy_lockstep`` case.
"""
import numpy as np
import pytest
import torch

import heat_tpu as htj
from heat_tpu.core.communication import SELF, comm_context

import heat_tpu_torch as htt
from heat_tpu_torch.core.kernels import KERNEL_STATS, LAUNCHES, lazy_fused_plain
from heat_tpu_torch.core.kernels.lazy_fused import MAX_IN, MAX_INSTR, MAX_SLOTS_F64, lazy_fused, max_slots
from heat_tpu_torch.core.lazy import capture as tcapture
from heat_tpu_torch.core.lazy import evaluate as tevaluate


@pytest.fixture(autouse=True)
def cpu_self():
    htt.use_device("cpu")
    try:
        with comm_context(SELF):
            yield
    finally:
        htt.use_device(None)
    assert not tcapture._scopes(), "a test left an open ht.lazy() scope"


def _data(shape, dtype, seed=0, with_nan=False):
    x = np.random.default_rng(seed).standard_normal(shape).astype(dtype)
    if with_nan:
        x.flat[:: max(1, x.size // 7)] = np.nan
    return x


def chains(ht):
    return {
        "standardize": lambda x: (x - ht.mean(x, axis=0)) / (ht.std(x, axis=0) + 1.0),
        "score": lambda x: ht.sum((x * x - 1.0) * 0.5, axis=0),
        "elementwise": lambda x: ht.exp(-ht.abs(x)) * 2.0 + 1.0,
        "mean_all": lambda x: x - ht.mean(x),
        "var_norm": lambda x: x / (ht.var(x, axis=0) + 1.0),
        "cumsum": lambda x: ht.cumsum(x * 3.0, axis=0),
        "cumsum_inner": lambda x: ht.cumsum(x, axis=1) - 1.0,
    }


def nan_chains(ht):
    return {
        "nansum": lambda x: ht.nansum(x * 2.0, axis=0),
        "nanmean": lambda x: ht.nanmean(x, axis=0) * 4.0,
        "nanmax": lambda x: ht.nanmax(x + 1.0, axis=0),
    }


EXACT = {"elementwise", "cumsum", "cumsum_inner"}
TOL = {np.float32: dict(rtol=1e-5, atol=1e-6), np.float64: dict(rtol=1e-12, atol=1e-14)}
SCAN_TOL = {np.float32: dict(rtol=1e-5, atol=1e-5), np.float64: dict(rtol=1e-12, atol=1e-13)}


def _ulps(a, b):
    """Largest distance in units in the last place between two float arrays."""
    a, b = np.asarray(a), np.asarray(b)
    it = np.int32 if a.dtype == np.float32 else np.int64
    ia, ib = a.view(it).astype(np.int64), b.view(it).astype(np.int64)
    ia = np.where(ia < 0, np.iinfo(it).min - ia, ia)
    ib = np.where(ib < 0, np.iinfo(it).min - ib, ib)
    return int(np.max(np.abs(ia - ib))) if a.size else 0


def _lazy(ht, fn, *args):
    with ht.lazy():
        return fn(*args)


# ------------------------------------------------------------------- oracle
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("name", sorted(chains(htt)))
def test_chain_equals_eager_and_heat_tpu(name, split, dtype):
    xn = _data((24, 8), dtype, seed=3)
    chain_t = chains(htt)[name]
    eager = chain_t(htt.array(xn, split=split)).numpy()
    htt.reset_fuse_stats()
    got = _lazy(htt, chain_t, htt.array(xn, split=split))
    assert isinstance(got, htt.LazyDNDarray) and htt.FUSE_STATS["fused_dispatches"] == 1
    np.testing.assert_array_equal(got.numpy(), eager)
    ref = _lazy(htj, chains(htj)[name], htj.array(xn, split=split)).numpy()
    assert got.dtype.__name__ == str(ref.dtype)
    if name == "elementwise":
        assert _ulps(got.numpy(), ref) <= 4
    elif name in EXACT:  # XLA scans in another order than torch's cumsum
        np.testing.assert_allclose(got.numpy(), ref, **SCAN_TOL[dtype])
    else:
        np.testing.assert_allclose(got.numpy(), ref, **TOL[dtype])


@pytest.mark.parametrize("name", sorted(nan_chains(htt)))
def test_nan_chain_equals_eager_and_heat_tpu(name):
    xn = _data((24, 8), np.float64, seed=5, with_nan=True)
    eager = nan_chains(htt)[name](htt.array(xn, split=0)).numpy()
    got = _lazy(htt, nan_chains(htt)[name], htt.array(xn, split=0)).numpy()
    np.testing.assert_array_equal(got, eager)
    ref = _lazy(htj, nan_chains(htj)[name], htj.array(xn, split=0)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14, equal_nan=True)


def test_ragged_layout_flows_through():
    """A ragged operand computes in its layout: no rebalance, lcounts kept."""
    xn = _data((15, 6), np.float64, seed=11)
    x = htt.array(xn, split=0)
    reb = htt.LAYOUT_STATS["rebalances"]
    got = _lazy(htt, lambda a: a * 2.0 + 1.0, x)
    assert htt.LAYOUT_STATS["rebalances"] == reb
    np.testing.assert_array_equal(got.numpy(), xn * 2.0 + 1.0)


# ----------------------------------------------------------- segments
def test_segments_run_through_the_plain_version_as_eager():
    """The plan of the standardize chain runs its two reductions as ordinary
    nodes and the elementwise rest as one segment: (x - mu) / (sd + 1) with
    ``sd + 1`` inlined. Its program through ``lazy_fused_plain`` on the
    same inputs equals eager."""
    xn = _data((16, 5), np.float32, seed=7)
    x = htt.array(xn, split=0)
    KERNEL_STATS.clear()
    KERNEL_STATS["dispatches"] = 0
    z = _lazy(htt, chains(htt)["standardize"], x)
    assert KERNEL_STATS.get("lazy_fused.torch") == 1 and LAUNCHES["lazy_fused"] == 0
    plan = next(p for p in reversed(list(tevaluate.PROGRAM_CACHE.values())) if hasattr(p, "steps"))
    segs = [item for kind, item in plan.steps if kind == "seg"]
    assert [kind for kind, _ in plan.steps] == ["node", "node", "seg"] and len(segs) == 1
    seg = segs[0]
    assert [op for op, *_ in seg.program.instrs] == ["sub", "add", "div"]
    mu, sd = htt.mean(x, axis=0), htt.std(x, axis=0)
    inputs = [x._raw, mu._raw, sd._raw]
    (out,) = lazy_fused_plain(seg.program, inputs, x.lshape)
    eager = ((x - mu) / (sd + 1.0))._raw
    assert torch.equal(out, eager) and torch.equal(z._raw, eager)


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "pow", "neg", "abs", "exp", "log", "sqrt", "gt", "ge",
                                "lt", "le", "eq", "ne"])
def test_plain_program_matches_torch_per_op(op):
    """One instruction per op, an immediate on the right, float32 and float64
    registers: the plain version is the torch op on the cast operands."""
    from heat_tpu_torch.core.kernels.lazy_fused import UNARY, SegmentProgram

    a = torch.from_numpy(np.abs(_data((6, 3), np.float32, seed=9)) + 0.5)
    for f64, dt in ((False, torch.float32), (True, torch.float64)):
        out_dt = torch.bool if op in ("gt", "ge", "lt", "le", "eq", "ne") else dt
        prog = SegmentProgram(1, ((op, 1, 0, -1, 0.75, f64),), ((1, out_dt),))
        (got,) = lazy_fused_plain(prog, [a], a.shape)
        fn = getattr(torch, "true_divide" if op == "div" else op)
        want = fn(a.to(dt)) if op in UNARY else fn(a.to(dt), torch.tensor(0.75, dtype=dt))
        assert torch.equal(got, want.to(out_dt))


# ----------------------------------------------------------- FUSE_STATS
def _warm(ht):
    x = ht.array(_data((32, 8), np.float64, seed=4), split=0)
    mu, sig = ht.mean(x, axis=0), ht.std(x, axis=0)

    def chain():
        with ht.lazy():
            z = (x - mu) / (sig + 1.0)
            return ht.sum(z * z, axis=0)

    chain()
    ht.reset_fuse_stats()
    chain()


def _prefix(ht):
    x = ht.array(_data((24, 6), np.float64, seed=21), split=0)
    for head in (lambda t: t - 3.0, lambda t: t * 0.25, lambda t: t + 7.0, lambda t: 0.5 * t):
        with ht.lazy():
            head(ht.exp(-ht.abs(x)) * 4.0625 + 1.8125)


def _out(ht):
    x = ht.array(_data((8, 3), np.float64, seed=7), split=0)
    o = ht.zeros_like(x)
    with ht.lazy():
        ht.add(x, x, out=o)


def _forces(ht):
    x = ht.array(_data((8, 3), np.float64, seed=1), split=0)
    with ht.lazy():
        w = x * 2.0
        w.numpy()
        v = w + 1.0
        v[2]


def _nested(ht):
    x = ht.array(_data((8, 3), np.float64, seed=12), split=0)
    with ht.lazy():
        x + 1.0
        a = x + 1.0
        with ht.lazy():
            b = a * 2.0
        c = x * 3.0
    return a, b, c


def _exception(ht):
    x = ht.array(_data((8, 3), np.float64, seed=14), split=0)
    escaped = {}
    try:
        with ht.lazy():
            escaped["w"] = x * 5.0
            raise RuntimeError("boom")
    except RuntimeError:
        pass
    x + 1.0
    escaped["w"].numpy()


def _decorator(ht):
    @ht.fuse
    def standardize(a):
        return (a - ht.mean(a, axis=0)) / (ht.std(a, axis=0) + 1.0)

    standardize(ht.array(_data((16, 4), np.float64, seed=15), split=0))


def _metadata(ht):
    x = ht.array(_data((12, 4), np.float64, seed=16), split=0)
    with ht.lazy():
        z = ht.mean(x * x, axis=0)
        assert z.shape == (4,) and z.split is None and z.dtype == ht.float64
        assert z.lshape_map.shape == (z.comm.size, 1) and not z.is_materialized


SEQUENCES = {"warm": _warm, "prefix": _prefix, "out": _out, "forces": _forces, "nested": _nested,
             "exception": _exception, "decorator": _decorator, "metadata": _metadata}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_fuse_stats_deltas_equal_heat_tpu(name):
    counts = []
    for ht in (htj, htt):
        ht.reset_fuse_stats()
        SEQUENCES[name](ht)
        counts.append(dict(ht.FUSE_STATS))
    assert counts[1] == counts[0]


def test_warm_chain_is_one_dispatch_and_no_plan():
    """A warm chain: one fused dispatch, one cache hit, no graph captured,
    no plan built and nothing compiled in a Region."""
    from heat_tpu_torch.analysis import Region

    _warm(htt)  # leaves the warm call's counts
    htt.reset_fuse_stats()
    x = htt.array(_data((32, 8), np.float64, seed=4), split=0)
    mu, sig = htt.mean(x, axis=0), htt.std(x, axis=0)

    def chain():
        with htt.lazy():
            return htt.sum(((x - mu) / (sig + 1.0)) ** 2.0, axis=0)

    want = chain().numpy()
    htt.reset_fuse_stats()
    r = Region("warm fused chain")
    got = chain()
    assert htt.FUSE_STATS == {"graphs_captured": 0, "fused_dispatches": 1, "eager_fallbacks": 0, "cache_hits": 1,
                              "cse_hits": 0}
    r.assert_compiles(0)
    assert r.traces == 0 and r.cache_inserts == 0
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("steps", [20, 40], ids=["30ops", "60ops"])
def test_long_chain_is_cut_into_launches_the_kernel_takes(steps, dtype, monkeypatch):
    """Chains of 30 and 60 elementwise ops. 60 outgrow one launch (32
    instructions); 30 fit one in float32 (31 slots) but not on the kernel's
    double registers (28 slots). Where a chain outgrows a launch the plan
    stores intermediate results; every segment fits the kernel, and the
    result equals eager bit for bit."""
    xn = _data((10, 3), dtype, seed=17)

    def chain(a):
        for i in range(steps):
            a = a * 1.0078125 + 0.5 if i % 2 else a - 0.25
        return a

    slots = []

    def recording(prog, inputs, shape):
        slots.append((prog.n_in + len(prog.instrs), max_slots(prog, [t.dtype for t in inputs])))
        return lazy_fused(prog, inputs, shape)

    monkeypatch.setattr(tevaluate, "lazy_fused", recording)
    eager = chain(htt.array(xn, split=0)).numpy()
    KERNEL_STATS["lazy_fused.torch"] = 0
    got = _lazy(htt, chain, htt.array(xn, split=0))
    np.testing.assert_array_equal(got.numpy(), eager)
    launches = KERNEL_STATS["lazy_fused.torch"]
    assert launches == len(slots) and (launches == 1 if (steps, dtype) == (20, np.float32) else launches >= 2)
    assert all(used <= limit for used, limit in slots), slots
    assert {limit for _, limit in slots} == {MAX_SLOTS_F64 if dtype == np.float64 else MAX_IN + MAX_INSTR}


def test_chain_deeper_than_the_recursion_limit_equals_eager():
    """1200 elementwise ops in one scope (heat_tpu runs such a chain as one
    program): planning walks the expression without recursion, cuts it
    into launches the kernel takes, and the result equals eager bit for bit."""
    xn = _data((6, 3), np.float64, seed=18)

    def chain(a):
        for i in range(800):
            a = a * 1.0078125 + 0.5 if i % 2 else a - 0.25
        return a

    eager = chain(htt.array(xn, split=0)).numpy()
    KERNEL_STATS["lazy_fused.torch"] = 0
    got = _lazy(htt, chain, htt.array(xn, split=0))
    np.testing.assert_array_equal(got.numpy(), eager)
    assert KERNEL_STATS["lazy_fused.torch"] >= 1200 // MAX_SLOTS_F64


def test_nested_scope_results_and_escaped_arrays():
    a, b, c = _nested(htt)
    xn = _data((8, 3), np.float64, seed=12)
    np.testing.assert_array_equal(a.numpy(), xn + 1.0)
    np.testing.assert_array_equal(b.numpy(), (xn + 1.0) * 2.0)
    np.testing.assert_array_equal(c.numpy(), xn * 3.0)


def test_tensor_changed_in_place_before_evaluation_raises():
    x = htt.array(_data((4, 3), np.float64, seed=2), split=0)
    with pytest.raises(RuntimeError, match="changed in place"):
        with htt.lazy():
            y = x * 2.0
            x._raw.add_(1.0)
    assert isinstance(y, htt.LazyDNDarray)


def test_matmul_and_argmax_are_captured():
    """The predict pipeline: standardize -> matmul -> argmax as one plan."""
    xn = _data((20, 6), np.float32, seed=8)
    wn = _data((6, 3), np.float32, seed=9)
    x, w = htt.array(xn, split=0), htt.array(wn)

    def predict(ht, a, b):
        return ht.argmax(((a - ht.mean(a, axis=0)) / ht.std(a, axis=0)) @ b, axis=1)

    eager = predict(htt, x, w).numpy()
    htt.reset_fuse_stats()
    got = _lazy(htt, predict, htt, x, w)
    assert htt.FUSE_STATS["eager_fallbacks"] == 0 and htt.FUSE_STATS["fused_dispatches"] == 1
    np.testing.assert_array_equal(got.numpy(), eager)
    ref = _lazy(htj, predict, htj, htj.array(xn, split=0), htj.array(wn)).numpy()
    np.testing.assert_array_equal(got.numpy(), ref)


# ----------------------------------------------------------- the kernel
def test_register_flags_follow_the_chain():
    """The binding keeps the previous result in registers: an operand that is
    it reads the register, and a result only the next instruction reads is
    not stored (``csrc/lazy_fused.cu``'s LfFlags)."""
    from heat_tpu_torch.core.kernels.lazy_fused import _A_ACC, _B_ACC, _KEEP, SegmentProgram, _flags

    # x * x - 1 then * 0.5, with t = x * x also an output; then u = t + t
    prog = SegmentProgram(1, (("mul", 1, 0, 0, 0.0, False), ("sub", 2, 1, -1, 1.0, False),
                              ("mul", 3, 2, -1, 0.5, False), ("add", 4, 1, 1, 0.0, False)),
                          ((1, torch.float32), (3, torch.float32), (4, torch.float32)))
    assert [_flags(prog, k) for k in range(4)] == [_KEEP, _A_ACC, _A_ACC | _KEEP, _KEEP]
    chain = SegmentProgram(1, (("neg", 1, 0, -1, 0.0, False), ("exp", 2, 1, -1, 0.0, False)), ((2, torch.float32),))
    assert [_flags(chain, k) for k in range(2)] == [0, _A_ACC | _KEEP]
    assert _B_ACC == 2
